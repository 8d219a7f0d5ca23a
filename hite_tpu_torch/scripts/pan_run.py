"""Pan-genome workflow run: three related genomes (8 Mbp each by default).

The pan subsystem end to end (per-genome runs -> pan library ->
cross-genome low-copy rescue -> occupancy/PAV classification) on genomes
that SHARE a family set with presence/absence variation, plus one family
that is LOW-COPY in genome g1 (2 copies) but well-supported in g2/g3, so
that the cross-genome rescue fires.  Prints one summary JSON line with the
keys of the JAX package's `PAN_RUN.json` (no compile time; the card's name
and power limit added).  Reference analog: `panHiTE.nf:94-216`.

    python -m hite_tpu_torch.scripts.pan_run [--mbp 8] [--out DIR]
        [--device cpu]

Also the source of the small pan genomes the tests and `chip_smoke.py`
hold the port against the JAX package and the CPU with, and of the bench
substrate (`build_bench_genome`) that `scale_run` and `chip_smoke.py`
run.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from hite_tpu_torch.io.fasta import encode_seq


def pan_genome_codes(length: int):
    """Three genomes sharing one family set with PAV structure (the JAX
    package's `scripts/pan_run.py:build_pan_genomes`, seed 17).

    Returns ({genome: codes}, {genome: truth}, expectations); a truth holds
    the planted "intervals", their "classes" and "names", and the planted
    "families" {name: unmutated codes}."""
    rng = np.random.default_rng(17)

    # shared family set (consensi drawn once; genomes differ in counts)
    fams = {}
    for f in range(3):
        t = rng.integers(0, 4, 20).astype(np.uint8)
        while t[0] == 3 and t[1] == 2:
            t = rng.integers(0, 4, 20).astype(np.uint8)
        interior = (460, 900, 1400)[f]
        fams[f"TIR_{f}"] = ("TIR", np.concatenate(
            [t, rng.integers(0, 4, interior).astype(np.uint8),
             (3 - t)[::-1]]))
    fams["HEL_0"] = ("Helitron", np.concatenate(
        [encode_seq("TCTCTACTA"),
         rng.integers(0, 4, 900).astype(np.uint8),
         encode_seq("CAATGAACG" + "ACGTACGTA" + "CTAGT")]))
    for f in range(2):
        fams[f"SINE_{f}"] = ("SINE", np.concatenate(
            [rng.integers(0, 4, (280, 420)[f]).astype(np.uint8),
             np.zeros(14, np.uint8)]))
    for f in range(2):
        t = rng.integers(0, 4, (250, 400)[f]).astype(np.uint8)
        t[0], t[1], t[-2], t[-1] = 3, 2, 1, 0
        fams[f"LTR_{f}"] = ("LTR", np.concatenate(
            [t, rng.integers(0, 4, 2200).astype(np.uint8), t]))
    # the rescue family: low-copy in g1, well-supported in g2/g3.
    # SINE-like ON PURPOSE: a low-copy TIR candidate is structurally
    # rescued IN-GENOME (it carries TIR termini), so the cross-genome
    # path never fires for it; a SINE's only in-genome rescue channel is
    # the protein scan against the upstream-missing LINEPeps.lib, so it
    # reaches the pan rescue with its low-copy status intact
    # (pan_recover_low_copy_TEs.py's central case).
    fams["SINE_rescue"] = ("SINE", np.concatenate(
        [rng.integers(0, 4, 360).astype(np.uint8),
         np.zeros(14, np.uint8)]))

    base = {"TIR_0": 20, "TIR_1": 15, "TIR_2": 10, "HEL_0": 8,
            "SINE_0": 20, "SINE_1": 20, "LTR_0": 4, "LTR_1": 4}
    counts = {
        "g1": dict(base, SINE_rescue=2),                # rescue source
        "g2": dict(base, SINE_rescue=6, SINE_1=0),      # SINE_1 absent
        "g3": dict(base, SINE_rescue=6, LTR_1=0),       # LTR_1 absent
    }
    codes, truths = _plant_genomes(length, fams, counts, seed0=100)
    expect = {"absent": {"g2": "SINE_1", "g3": "LTR_1"},
              "rescue_family": "SINE_rescue"}
    return codes, truths, expect


def _plant_genomes(length, fams, counts, seed0):
    """Each genome: a seed0+i random background with `counts[g][family]`
    mutated copies of each family at random spots (no two within 200 bp),
    TSDs of 5 (TIR, LTR) or 12 (SINE) bp, an A|T host site for Helitrons."""
    codes, truths = {}, {}
    for gi, (gname, cnt) in enumerate(counts.items()):
        grng = np.random.default_rng(seed0 + gi)
        bg = grng.integers(0, 4, length).astype(np.uint8)
        bins: dict = {}
        placed = []

        def overlaps(pos, end):
            for b in range(pos // 65536 - 1, end // 65536 + 2):
                for s, e in bins.get(b, ()):
                    if pos < e + 200 and end + 200 > s:
                        return True
            return False

        for fname, n in cnt.items():
            klass, te = fams[fname]
            tsd = {"TIR": 5, "SINE": 12, "LTR": 5}.get(klass, 0)
            host_at = klass == "Helitron"
            mut = 0.01 if klass == "LTR" else 0.02
            done = 0
            while done < n:
                pos = int(grng.integers(1000, length - len(te) - 1000))
                if overlaps(pos, pos + len(te)):
                    continue
                copy = te.copy()
                muts = grng.random(len(copy)) < mut
                copy[muts] = (copy[muts]
                              + grng.integers(1, 4, muts.sum())) % 4
                if tsd:
                    td = grng.integers(0, 4, tsd).astype(np.uint8)
                    bg[pos - tsd: pos] = td
                    bg[pos + len(copy): pos + len(copy) + tsd] = td
                if host_at:
                    bg[pos - 1] = 0
                    bg[pos + len(copy)] = 3
                bg[pos: pos + len(copy)] = copy
                placed.append((pos, pos + len(copy), klass, fname))
                for b in range(pos // 65536,
                               (pos + len(copy)) // 65536 + 1):
                    bins.setdefault(b, []).append((pos, pos + len(copy)))
                done += 1
        codes[gname] = bg
        truths[gname] = {
            "intervals": np.array([p[:2] for p in placed],
                                  np.int64).reshape(-1, 2),
            "classes": [p[2] for p in placed],
            "names": [p[3] for p in placed],
            "families": {n: s for n, (_k, s) in fams.items()
                         if cnt.get(n, 0) > 0},
        }
    return codes, truths


def small_pan_codes(length: int = 48_000, spacing: int = 2_700):
    """Three small genomes with a core (all three), a dispensable (g1, g2)
    and a private (g1) TIR family, 5 copies each where present, and a SINE
    family low-copy in g1 (2 copies) and 6 copies in g2/g3, which the
    cross-genome rescue takes up.  Copies (1% mutations, TSDs) sit in
    shuffled slots `spacing` bp apart, so that no two chain into one
    candidate.  Returns ({genome: codes}, truths) as `pan_genome_codes`."""
    rng = np.random.default_rng(31)
    fams = {}
    for name, interior in (("TIR_core", 460), ("TIR_disp", 520),
                           ("TIR_priv", 400)):
        t = rng.integers(0, 4, 20).astype(np.uint8)
        while t[0] == 3 and t[1] == 2:
            t = rng.integers(0, 4, 20).astype(np.uint8)
        fams[name] = ("TIR", np.concatenate(
            [t, rng.integers(0, 4, interior).astype(np.uint8),
             (3 - t)[::-1]]))
    fams["SINE_rescue"] = ("SINE", np.concatenate(
        [rng.integers(0, 4, 360).astype(np.uint8), np.zeros(14, np.uint8)]))
    counts = {
        "g1": {"TIR_core": 5, "TIR_disp": 5, "TIR_priv": 5, "SINE_rescue": 2},
        "g2": {"TIR_core": 5, "TIR_disp": 5, "SINE_rescue": 6},
        "g3": {"TIR_core": 5, "SINE_rescue": 6},
    }
    codes, truths = {}, {}
    slots = np.arange(1_500, length - 1_500 - 600, spacing)
    for gi, (gname, cnt) in enumerate(counts.items()):
        grng = np.random.default_rng(300 + gi)
        bg = grng.integers(0, 4, length).astype(np.uint8)
        names = [f for f, n in cnt.items() for _ in range(n)]
        assert len(names) <= len(slots), (gname, len(names), len(slots))
        at = grng.permutation(len(slots))[: len(names)]
        placed = []
        for fname, k in zip(names, at):
            klass, te = fams[fname]
            pos = int(slots[k] + grng.integers(0, 200))
            tsd = 5 if klass == "TIR" else 12
            copy = te.copy()
            muts = grng.random(len(copy)) < 0.01
            copy[muts] = (copy[muts] + grng.integers(1, 4, muts.sum())) % 4
            td = grng.integers(0, 4, tsd).astype(np.uint8)
            bg[pos - tsd: pos] = td
            bg[pos + len(copy): pos + len(copy) + tsd] = td
            bg[pos: pos + len(copy)] = copy
            placed.append((pos, pos + len(copy), klass, fname))
        codes[gname] = bg
        truths[gname] = {
            "intervals": np.array([p[:2] for p in placed],
                                  np.int64).reshape(-1, 2),
            "classes": [p[2] for p in placed],
            "names": [p[3] for p in placed],
            "families": {n: s for n, (_k, s) in fams.items()
                         if cnt.get(n, 0) > 0},
        }
    return codes, truths


def downstream_inputs(codes, truths, out_dir: str) -> List[Dict]:
    """Genome-list records for `pan_downstream_analysis` on the small pan
    genomes, with the files they name written under `out_dir`: gene GFFs
    for g1 and g2 and RNA reads (10 and 6 of 120 bp) from geneA in both.
    geneA starts 50 bp after a planted TE in g1 (an Upstream insertion
    within a 300 bp window) and sits in TE-free sequence in g2
    (No_Insertion), so that the DE stage has both groups; g3 has
    neither file."""
    import os

    from hite_tpu_torch.io.fasta import decode_seq

    os.makedirs(out_dir, exist_ok=True)
    metas = []
    for gname in codes:
        meta = {"genome_name": gname}
        if gname != "g3":
            iv = truths[gname]["intervals"]
            iv = iv[np.argsort(iv[:, 0])]
            if gname == "g1":
                gs = int(iv[3, 1]) + 50
            else:
                gaps = iv[1:, 0] - iv[:-1, 1]
                k = int(np.argmax(gaps))
                gs = int(iv[k, 1] + gaps[k] // 2 - 400)
            ge = gs + 800
            gff = os.path.join(out_dir, f"{gname}.gff")
            with open(gff, "w") as fh:
                fh.write(f"chr1\tsrc\tgene\t{gs + 1}\t{ge}\t.\t+\t.\t"
                         'gene_id "geneA"\n'
                         f"chr1\tsrc\tgene\t{ge + 101}\t{ge + 400}\t.\t-\t"
                         '.\tgene_id "geneB"\n')
            meta["gene_gff"] = gff
            body = decode_seq(codes[gname][gs:ge])
            fq = os.path.join(out_dir, f"{gname}.fq")
            with open(fq, "w") as fh:
                for r in range(10 if gname == "g1" else 6):
                    s = body[60 * r: 60 * r + 120]
                    fh.write(f"@r{r}\n{s}\n+\n{'I' * len(s)}\n")
            meta["RNA"] = [fq]
            meta["is_PE"] = False
        metas.append(meta)
    return metas


def small_pan_config():
    """The small pan genomes' config: the default with a 2000 bp fixed
    extension threshold, and CoarseParams(seg_len=16384, pair_batch=16)."""
    from hite_tpu_torch.config import AlignConfig, PipelineConfig
    from hite_tpu_torch.pipeline.coarse import CoarseParams

    return (PipelineConfig(
        align=AlignConfig(fixed_extend_base_threshold=2000)),
        CoarseParams(seg_len=16_384, pair_batch=16))


def pan_config():
    """The run's config: `PipelineConfig(annotate=True)` with a 2000 bp
    fixed extension threshold, and `bench.py`'s coarse parameters."""
    from hite_tpu_torch.config import AlignConfig, PipelineConfig
    from hite_tpu_torch.pipeline.coarse import CoarseParams

    cfg = PipelineConfig(annotate=True,
                         align=AlignConfig(fixed_extend_base_threshold=2000))
    params = CoarseParams(seg_len=262_144, pair_batch=64, stride=4,
                          max_hits=4)
    return cfg, params


def build_bench_genome(length: int = 8_000_000, scale: int = 1,
                       hard: bool = False, device=None):
    """The bench substrate: planted TIR (TSD + ITR), Helitron (LCV head +
    CTAGT tail, A|T host site), SINE (polyA tail + TSD) and intact LTR
    families on a seed-7 random background (the port's copy of
    `bench.py:build_bench_genome`, the same numpy draws).  `scale`
    multiplies the family counts (the scale run keeps the TE density of
    8 Mbp at 100 Mbp); `hard=True` adds the reference's hard cases:
    5'/3'-truncated TIR copies, solo LTRs, a TIR nested in an LTR
    interior, and head-to-tail tandem TIR arrays.

    Returns (Genome on `device`, truth): truth holds the planted
    "intervals" int64 [N, 2], their "classes" and family "names", and the
    "families" {name: unmutated codes}."""
    from hite_tpu_torch.genome import Genome

    rng = np.random.default_rng(7)
    bg = rng.integers(0, 4, length).astype(np.uint8)
    bins: dict = {}           # 64 kbp placement bins: O(n) overlap checks
    placed = []               # (start, end, class, family)
    families = {}

    def overlaps(pos, end):
        for b in range(pos // 65536 - 1, end // 65536 + 2):
            for s, e in bins.get(b, ()):
                if pos < e + 200 and end + 200 > s:
                    return True
        return False

    def plant(te, n, klass, name, tsd=0, host_at=False, mut=0.02,
              spans=None):
        """n mutated copies of `te`; `spans` lists (offset, length,
        class, family) sub-spans of a composite (nested) element."""
        while n:
            pos = int(rng.integers(1000, length - len(te) - 1000))
            if overlaps(pos, pos + len(te)):
                continue
            copy = te.copy()
            muts = rng.random(len(copy)) < mut
            copy[muts] = (copy[muts] + rng.integers(1, 4, muts.sum())) % 4
            if tsd:
                t = rng.integers(0, 4, tsd).astype(np.uint8)
                bg[pos - tsd: pos] = t
                bg[pos + len(copy): pos + len(copy) + tsd] = t
            if host_at:
                bg[pos - 1] = 0
                bg[pos + len(copy)] = 3
            bg[pos: pos + len(copy)] = copy
            for off, ln, kl, nm in (spans or ((0, len(te), klass, name),)):
                placed.append((pos + off, pos + off + ln, kl, nm))
            for b in range(pos // 65536, (pos + len(copy)) // 65536 + 1):
                bins.setdefault(b, []).append((pos, pos + len(copy)))
            n -= 1

    tir_tes = []
    for f in range(3 * scale):
        n, interior = ((20, 460), (15, 900), (10, 1400))[f % 3]
        t = rng.integers(0, 4, 20).astype(np.uint8)
        while t[0] == 3 and t[1] == 2:
            t = rng.integers(0, 4, 20).astype(np.uint8)
        te = np.concatenate([t, rng.integers(0, 4, interior).astype(np.uint8),
                             (3 - t)[::-1]])
        tir_tes.append(te)
        families[f"TIR_{f}"] = te
        plant(te, n, "TIR", f"TIR_{f}", tsd=5)
    for f in range(2 * scale):
        n, interior = ((8, 700), (8, 1200))[f % 2]
        te = np.concatenate([
            encode_seq("TCTCTACTA"),
            rng.integers(0, 4, interior).astype(np.uint8),
            encode_seq("CAATGAACG" + "ACGTACGTA" + "CTAGT")])
        families[f"HEL_{f}"] = te
        plant(te, n, "Helitron", f"HEL_{f}", host_at=True)
    for f in range(2 * scale):
        n, interior = ((20, 280), (20, 420))[f % 2]
        te = np.concatenate([rng.integers(0, 4, interior).astype(np.uint8),
                             np.zeros(14, np.uint8)])
        families[f"SINE_{f}"] = te
        plant(te, n, "SINE", f"SINE_{f}", tsd=12)
    ltr_tes = []
    for f in range(4 * scale):
        n, ltr_len = ((4, 250), (4, 350), (4, 450), (4, 600))[f % 4]
        t = rng.integers(0, 4, ltr_len).astype(np.uint8)
        t[0], t[1], t[-2], t[-1] = 3, 2, 1, 0
        te = np.concatenate([t, rng.integers(0, 4, 2200).astype(np.uint8), t])
        ltr_tes.append((te, t))
        families[f"LTR_{f}"] = te
        plant(te, n, "LTR", f"LTR_{f}", tsd=5, mut=0.01)

    if hard:
        for f, te in enumerate(tir_tes):       # 5' and 3' truncated copies
            cut = int(len(te) * (0.4 + 0.1 * (f % 4)))
            plant(te[cut:], 3, "TIR", f"TIR_{f}")
            plant(te[:-cut], 3, "TIR", f"TIR_{f}")
        for f, (_te, t) in enumerate(ltr_tes):  # solo LTRs with their TSD
            plant(t, 3, "LTR", f"LTR_{f}", tsd=5, mut=0.01)
        for f, (te, t) in enumerate(ltr_tes):   # a TIR in an LTR interior
            fi = f % len(tir_tes)
            inner = tir_tes[fi]
            mid = len(t) + 1100
            composite = np.concatenate([te[:mid], inner, te[mid:]])
            spans = ((0, mid, "LTR", f"LTR_{f}"),
                     (mid, len(inner), "TIR", f"TIR_{fi}"),
                     (mid + len(inner), len(te) - mid, "LTR", f"LTR_{f}"))
            plant(composite, 2, "LTR", f"LTR_{f}", tsd=5, mut=0.01,
                  spans=spans)
        for f, te in enumerate(tir_tes):       # head-to-tail tandem arrays
            plant(np.concatenate([te] * (2 + f % 2)), 2, "TIR", f"TIR_{f}",
                  tsd=5)

    truth = {"intervals": np.array([(s, e) for s, e, _k, _n in placed],
                                   np.int64).reshape(-1, 2),
             "classes": [k for _s, _e, k, _n in placed],
             "names": [n for _s, _e, _k, n in placed],
             "families": families}
    return Genome.from_dict({"chr1": bg}, device=device), truth


def parity_genome_codes() -> np.ndarray:
    """The 160 kbp parity genome of the tests (`__graft_entry__.
    pipeline_parity`, seed 23): TIR, SINE and LTR families on a random
    background."""
    rng = np.random.default_rng(23)
    bg = rng.integers(0, 4, 160_000).astype(np.uint8)

    def plant(te, starts, tsd=0):
        for pos in starts:
            copy = te.copy()
            muts = rng.random(len(copy)) < 0.01
            copy[muts] = (copy[muts] + rng.integers(1, 4, muts.sum())) % 4
            if tsd:
                t = rng.integers(0, 4, tsd).astype(np.uint8)
                bg[pos - tsd : pos] = t
                bg[pos + len(copy) : pos + len(copy) + tsd] = t
            bg[pos : pos + len(copy)] = copy

    t = rng.integers(0, 4, 20).astype(np.uint8)
    while t[0] == 3 and t[1] == 2:
        t = rng.integers(0, 4, 20).astype(np.uint8)
    tir_te = np.concatenate([t, rng.integers(0, 4, 360).astype(np.uint8),
                             (3 - t)[::-1]])
    plant(tir_te, [10_000, 30_000, 50_000, 70_000, 90_000, 110_000], tsd=5)
    sine_te = np.concatenate([rng.integers(0, 4, 280).astype(np.uint8),
                              np.zeros(14, np.uint8)])
    plant(sine_te, [20_000, 40_000, 60_000, 80_000, 100_000, 120_000],
          tsd=12)
    lt = rng.integers(0, 4, 250).astype(np.uint8)
    lt[0], lt[1], lt[-2], lt[-1] = 3, 2, 1, 0
    ltr_te = np.concatenate([lt, rng.integers(0, 4, 1500).astype(np.uint8),
                             lt])
    plant(ltr_te, [130_000, 140_000, 150_000], tsd=5)
    return bg


# the small genomes' CoarseParams (the 160 kbp parity genome's): a 32 kbp
# segment, and a 128 kbp cap that chunks the self-join
SMALL_COARSE = dict(seg_len=32_768, pair_batch=16, stride=4, max_hits=4,
                    max_selfjoin_bp=1 << 17)

# (class, per-copy mutation rate, copies) of the diverged genome's
# families: each class takes each rate once, and the copy counts fall in
# the boundary engine's three homology tiers (0.95 up to 5 rows, 0.9 up
# to 10, 0.7 beyond; `config.MSAConfig.homo_thresholds`)
DIVERGED_FAMILIES = (
    ("TIR", 0.05, 5), ("TIR", 0.10, 9), ("TIR", 0.20, 13),
    ("SINE", 0.05, 9), ("SINE", 0.10, 13), ("SINE", 0.20, 5),
    ("Helitron", 0.05, 13), ("Helitron", 0.10, 4), ("Helitron", 0.20, 9),
    ("LTR", 0.05, 5), ("LTR", 0.10, 9), ("LTR", 0.20, 12),
)


def diverged_genome_codes(length: int = 260_000, seed: int = 31):
    """One contig of `length` bp with DIVERGED_FAMILIES planted: TIRs with
    a 5 bp TSD, SINEs with a polyA tail and a 12 bp TSD, Helitrons with
    the bench's head and tail on an A|T host site, intact LTRs (TG..CA)
    with a 5 bp TSD; each copy mutated at its family's rate, no two
    copies within 200 bp.

    Returns (codes uint8 [length], truth): truth holds the planted
    "intervals" int64 [N, 2], their "classes" and family "names", and
    "families" {name: (class, rate, copies)}."""
    rng = np.random.default_rng(seed)
    bg = rng.integers(0, 4, length).astype(np.uint8)
    placed, families = [], {}

    def free(pos, end):
        return all(pos >= e + 200 or end + 200 <= s
                   for s, e, _k, _n in placed)

    for f, (klass, rate, n) in enumerate(DIVERGED_FAMILIES):
        if klass == "TIR":
            t = rng.integers(0, 4, 20).astype(np.uint8)
            while t[0] == 3 and t[1] == 2:
                t = rng.integers(0, 4, 20).astype(np.uint8)
            te = np.concatenate([t, rng.integers(0, 4, 500).astype(np.uint8),
                                 (3 - t)[::-1]])
        elif klass == "SINE":
            te = np.concatenate([rng.integers(0, 4, 300).astype(np.uint8),
                                 np.zeros(14, np.uint8)])
        elif klass == "Helitron":
            te = np.concatenate([
                encode_seq("TCTCTACTA"),
                rng.integers(0, 4, 800).astype(np.uint8),
                encode_seq("CAATGAACG" + "ACGTACGTA" + "CTAGT")])
        else:
            t = rng.integers(0, 4, 250).astype(np.uint8)
            t[0], t[1], t[-2], t[-1] = 3, 2, 1, 0
            te = np.concatenate([t, rng.integers(0, 4, 1100).astype(np.uint8),
                                 t])
        name = f"{klass}_{f}"
        families[name] = (klass, rate, n)
        tsd = {"TIR": 5, "SINE": 12, "LTR": 5}.get(klass, 0)
        done = 0
        while done < n:
            pos = int(rng.integers(1000, length - len(te) - 1000))
            if not free(pos - tsd, pos + len(te) + tsd):
                continue
            copy = te.copy()
            muts = rng.random(len(copy)) < rate
            copy[muts] = (copy[muts] + rng.integers(1, 4, muts.sum())) % 4
            if tsd:
                td = rng.integers(0, 4, tsd).astype(np.uint8)
                bg[pos - tsd: pos] = td
                bg[pos + len(copy): pos + len(copy) + tsd] = td
            if klass == "Helitron":
                bg[pos - 1], bg[pos + len(copy)] = 0, 3
            bg[pos: pos + len(copy)] = copy
            placed.append((pos, pos + len(copy), klass, name))
            done += 1
    truth = {"intervals": np.array([p[:2] for p in placed],
                                   np.int64).reshape(-1, 2),
             "classes": [p[2] for p in placed],
             "names": [p[3] for p in placed],
             "families": families}
    return bg, truth


def diverged_calls(result, truth) -> Dict[str, Optional[int]]:
    """{planted family: None when no accepted interval of its class (the
    TIR, Helitron and non-LTR modules' families, the intact LTR records)
    overlaps one of its copies, else the smallest end offset max(|start -
    planted start|, |end - planted end|) over the overlapping pairs} of a
    run_pipeline result on `diverged_genome_codes`' genome."""
    accepted = {"TIR": result.tir.accepted.intervals.tolist(),
                "Helitron": result.helitron.accepted.intervals.tolist(),
                "SINE": result.non_ltr.accepted.intervals.tolist(),
                "LTR": [(r.start, r.end) for r in result.ltr.records]}
    calls = {}
    for name, (klass, _rate, _n) in truth["families"].items():
        copies = [iv for iv, nm in zip(truth["intervals"].tolist(),
                                       truth["names"]) if nm == name]
        off = [max(abs(a - s), abs(b - e)) for a, b in accepted[klass]
               for s, e in copies if min(b, e) > max(a, s)]
        calls[name] = min(off) if off else None
    return calls


def accuracy_metrics(genome, result, truth, cfg) -> dict:
    """Base-level sens/prec/F1 of the annotation against the planted
    truth, per-class sensitivity, library-entries-per-family ratio, and
    the BM_RM2 family-level perfect/good/present counts of the produced
    library against the planted family consensi (the port's own copy of
    `bench.py:accuracy_metrics`)."""
    from hite_tpu_torch.pipeline.benchmark import family_level_metrics
    from hite_tpu_torch.utils import intervals as iv

    name_to_start = {n: int(s) for n, s in
                     zip(genome.names, genome.starts)}
    test = np.array([(name_to_start[h.contig] + h.start - 1,
                      name_to_start[h.contig] + h.end)
                     for h in result.annotation], np.int64).reshape(-1, 2)
    test_iv = iv.merge(test)
    gold_iv = iv.merge(truth["intervals"])
    gold_bp = iv.total_length(gold_iv)
    test_bp = iv.total_length(test_iv)
    if len(gold_iv) and len(test_iv):
        cov = iv.coverage_fraction(gold_iv, test_iv)
        tp = int(np.sum(cov * (gold_iv[:, 1] - gold_iv[:, 0])))
    else:
        tp = 0
    fp, fn = test_bp - tp, gold_bp - tp
    out = {
        "TP": tp, "FP": fp, "FN": fn,
        "sensitivity": round(tp / gold_bp, 4) if gold_bp else 0.0,
        "precision": round(tp / test_bp, 4) if test_bp else 0.0,
        "F1": round(2 * tp / (2 * tp + fp + fn), 4)
              if (2 * tp + fp + fn) else 0.0,
    }
    # per-class sensitivity: planted bases of each class covered by test
    by_class: dict = {}
    for (s, e), k in zip(truth["intervals"], truth["classes"]):
        by_class.setdefault(k, []).append((s, e))
    for k, spans in sorted(by_class.items()):
        giv = iv.merge(np.array(spans, np.int64))
        gbp = iv.total_length(giv)
        c = iv.coverage_fraction(giv, test_iv) if len(test_iv) else \
            np.zeros(len(giv))
        out[f"sens_{k}"] = round(
            float(np.sum(c * (giv[:, 1] - giv[:, 0])) / gbp), 4) if gbp \
            else 0.0
    merged = result.libs.get("merged", {})
    n_fam = max(len(truth["families"]), 1)
    out["library_entries_per_family"] = round(len(merged) / n_fam, 2)
    out["BM_RM2"] = family_level_metrics(merged, truth["families"], cfg,
                                         device=genome.device)
    return out


def family_entries(pan_lib: Dict[str, np.ndarray],
                   families: Dict[str, np.ndarray], cfg, device,
                   min_cov: float = 0.8) -> Dict[str, List[str]]:
    """{planted family: pan library entries whose chains cover >= min_cov
    of the family's sequence}, from the all-pairs copy join."""
    from hite_tpu_torch.pipeline.libcluster import _all_pairs_hits

    fnames, enames = list(families), list(pan_lib)
    pool = [families[f] for f in fnames] + [pan_lib[e] for e in enames]
    hits = _all_pairs_hits(pool, cfg.align, device=device)
    out: Dict[str, List[str]] = {f: [] for f in fnames}
    for ti in range(len(fnames), len(pool)):
        cover: Dict[int, List[Tuple[int, int]]] = {}
        for (j, _qs, _qe, os_, oe, _ns) in hits[ti]:
            if j < len(fnames):
                cover.setdefault(j, []).append((os_, oe))
        for j, spans in cover.items():
            lo = min(s for s, _ in spans)
            hi = max(e for _, e in spans)
            if hi - lo >= min_cov * len(pool[j]):
                out[fnames[j]].append(enames[ti - len(fnames)])
    return out


def card_line() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0]


def run(mbp: int, out_dir: str, device=None) -> dict:
    """Build the genomes on `device` (None = the card), run the pan
    pipeline and return the summary record."""
    from hite_tpu_torch.genome import Genome
    from hite_tpu_torch.pipeline.pan import run_pan_pipeline
    from hite_tpu_torch.utils.log import STAGE_TIMES

    t_build = time.perf_counter()
    codes, truths, expect = pan_genome_codes(mbp * 1_000_000)
    genomes = {n: Genome.from_dict({"chr1": c}, device=device)
               for n, c in codes.items()}
    print(f"built 3x{mbp} Mbp pan genomes "
          f"({time.perf_counter() - t_build:.1f}s)", flush=True)
    cfg, params = pan_config()
    STAGE_TIMES.clear()
    t0 = time.perf_counter()
    result = run_pan_pipeline(genomes, cfg, out_dir=out_dir,
                              coarse_params=params)
    dt = time.perf_counter() - t0
    stages = dict(STAGE_TIMES)

    per_genome_acc = {}
    for gname, res in result.per_genome.items():
        a = accuracy_metrics(genomes[gname], res, truths[gname], cfg)
        a.pop("BM_RM2", None)
        per_genome_acc[gname] = a
    cls_counts: dict = {}
    for c in result.classification.values():
        cls_counts[c] = cls_counts.get(c, 0) + 1
    top = sorted(stages.items(), key=lambda kv: -kv[1])[:20]
    return {
        "metric": "pan_run",
        "genomes": {n: g.size for n, g in genomes.items()},
        "wall_s": dt,
        "pan_library_entries": len(result.pan_lib),
        "rescued_low_copy_families": result.rescued,
        "classification_counts": cls_counts,
        "per_genome_accuracy": per_genome_acc,
        "expectations": expect,
        "stages": dict(top),
        "card": card_line(),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mbp", type=int, default=8)
    ap.add_argument("--out", default="pan_out")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    from hite_tpu_torch.parallel.multihost import init_from_env

    init_from_env(args.device)
    print(json.dumps(run(args.mbp, args.out, args.device)), flush=True)


if __name__ == "__main__":
    main()
