"""Protein-domain engine (blastx replacement; counterpart of the JAX
`pipeline/domain.py`).

Re-implements the reference's blastx-based domain machinery
(`get_domain_info` `Util.py:4571-4612`, `multiple_alignment_blastx_v1`
`Util.py:1006`): map candidate TEs against protein libraries
(TIRPeps/HelitronPeps/LINEPeps) to emit the TE<->domain table and to
rescue low-copy candidates carrying a >=95%-intact domain
(`Util.py:8215-8281`).

Candidates are 6-frame translated on the device (`ops.protein`),
amino-acid 4-mers seed against one sorted index of the concatenated
protein library (`ops.seedext.pair_hsps`, all (candidate, frame) rows as
one batch), chains (`ops.chain.chain_hsps`) are confirmed with a BLOSUM62
Smith-Waterman: the protein mode of the hand-written kernel on the card
(`ops.terminal.batched_local_align_auto(submatrix=...)`).

Reverse frames translate the reverse complement of the whole PADDED row
but map back with the candidate's own length, as the JAX package does:
for a candidate shorter than its width bucket, the q_start / q_end of a
reverse-frame hit are shifted (`ROADMAP.md` queue 3).  Rescue decisions
read only `entry_cov` and are unaffected.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from hite_tpu_torch.device import resolve_device
from hite_tpu_torch.ops.chain import chain_hsps
from hite_tpu_torch.ops.kmer import build_index_from_kmers
from hite_tpu_torch.ops.protein import (
    AA_TO_CODE, AA_X, BLOSUM62, aa_kmer_codes, encode_protein,
    translate_frames,
)
from hite_tpu_torch.ops.seedext import pair_hsps
from hite_tpu_torch.ops.terminal import batched_local_align_auto
from hite_tpu_torch.pipeline.candidates import bucket_iter, pad_rows, pad_seqs

SPACER_AA = 8

Device = Optional[Union[str, torch.device]]


@dataclass
class DomainHit:
    entry: str               # library protein name
    q_start: int             # nucleotide coords within the candidate
    q_end: int
    frame: int               # 0-5 (3-5 = reverse strand)
    identity: float
    score: int
    entry_cov: float         # fraction of the library protein covered
    s_start: int             # aa coords within the library protein
    s_end: int


def read_protein_fasta(path: str) -> Dict[str, np.ndarray]:
    seqs: Dict[str, np.ndarray] = {}
    name = None
    parts: List[str] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    seqs[name] = encode_protein("".join(parts))
                name = line[1:].split()[0]
                parts = []
            else:
                parts.append(line)
    if name is not None:
        seqs[name] = encode_protein("".join(parts))
    return seqs


_SCANNER_CACHE: Dict[Tuple, "DomainScanner"] = {}


class DomainScanner:
    """Sorted aa-k-mer index over one concatenated protein library, on
    `device` (None = the card)."""

    def __init__(self, lib: Dict[str, np.ndarray], k: int = 4,
                 device: Device = None):
        self.device = resolve_device(device)
        self.k = k
        self.names = list(lib.keys())
        self.lens = np.array([len(lib[n]) for n in self.names], np.int64)
        cat: List[np.ndarray] = []
        starts = []
        pos = 0
        spacer = np.full(SPACER_AA, AA_X, np.uint8)
        for n in self.names:
            starts.append(pos)
            cat.append(lib[n])
            cat.append(spacer)
            pos += len(lib[n]) + SPACER_AA
        self.starts = np.array(starts, np.int64)
        flat = np.concatenate(cat) if cat else np.zeros(1, np.uint8)
        pad = (-len(flat)) % 128
        self.flat = np.concatenate([flat, np.full(pad, AA_X, np.uint8)])
        km = aa_kmer_codes(torch.from_numpy(self.flat).to(self.device), k)
        self.index = build_index_from_kmers(km)
        self._starts_d = torch.from_numpy(self.starts).to(self.device)

    @classmethod
    def from_fasta(cls, path: str, k: int = 4,
                   device: Device = None) -> "DomainScanner":
        """Process-cached: rescue call sites each want the same vendored
        libraries."""
        dev = resolve_device(device)
        key = (os.path.abspath(path), k, os.path.getmtime(path), str(dev))
        hit = _SCANNER_CACHE.get(key)
        if hit is None:
            hit = cls(read_protein_fasta(path), k=k, device=dev)
            _SCANNER_CACHE[key] = hit
        return hit

    @classmethod
    def from_fastas(cls, paths: Sequence[str], k: int = 4,
                    device: Device = None) -> "DomainScanner":
        """One scanner over several protein libraries: entry names are
        prefixed ``{source_index}|`` so callers can keep per-library
        priority."""
        dev = resolve_device(device)
        key = tuple((os.path.abspath(p), os.path.getmtime(p))
                    for p in paths) + (k, str(dev))
        hit = _SCANNER_CACHE.get(key)
        if hit is None:
            lib: Dict[str, np.ndarray] = {}
            for si, p in enumerate(paths):
                for name, seq in read_protein_fasta(p).items():
                    lib[f"{si}|{name}"] = seq
            hit = cls(lib, k=k, device=dev)
            _SCANNER_CACHE[key] = hit
        return hit

    def scan(
        self,
        cand_seqs: Sequence[np.ndarray],
        *,
        min_identity: float = 0.5,
        min_aa_len: int = 30,
        max_hits_per_cand: int = 16,
    ) -> List[List[DomainHit]]:
        """Domain hits per candidate (nucleotide code arrays), in
        width-bucketed batches with a row cap (the JAX package's shapes)."""
        out: List[List[DomainHit]] = [[] for _ in cand_seqs]
        if not cand_seqs:
            return out
        widths = np.array([max(96, len(c)) for c in cand_seqs])
        for width, idxs in bucket_iter(range(len(cand_seqs)), widths):
            cap = max(8, (1 << 22) // max(6 * (width // 3), 1))
            cap = 1 << (cap.bit_length() - 1)
            for b0 in range(0, len(idxs), cap):
                sel = idxs[b0 : b0 + cap]
                sub = self._scan_batch(
                    [cand_seqs[i] for i in sel], width,
                    min_identity=min_identity, min_aa_len=min_aa_len,
                    max_hits_per_cand=max_hits_per_cand)
                for i, hits in zip(sel, sub):
                    out[i] = hits
        return out

    def _chains(self, frames: torch.Tensor, min_aa_len: int):
        """Seed + chain every (candidate, frame) row of [R, Laa] as one
        batch; HSPs are grouped by the library entry they land in so a
        chain never bridges two concatenated proteins."""
        k = self.k
        h = pair_hsps(aa_kmer_codes(frames, k), self.index, k=k, stride=1,
                      max_hits=8, diag_band=16, run_gap=24, min_seeds=2,
                      min_hsp_len=8, max_hsps=128)
        grp = torch.searchsorted(self._starts_d, h.ss.to(torch.int64),
                                 right=True).to(torch.int32)
        return chain_hsps(h, extend_threshold=60, max_chains=32,
                          min_len=min_aa_len, group=grp)

    def _scan_batch(
        self,
        cand_seqs: Sequence[np.ndarray],
        width: int,
        *,
        min_identity: float,
        min_aa_len: int,
        max_hits_per_cand: int,
    ) -> List[List[DomainHit]]:
        out: List[List[DomainHit]] = [[] for _ in cand_seqs]
        mat, lens = pad_seqs(list(cand_seqs), width,
                             n_rows=pad_rows(len(cand_seqs)))
        frames = translate_frames(torch.from_numpy(mat).to(self.device))
        B, _, Laa = frames.shape
        ch = self._chains(frames.reshape(B * 6, Laa), min_aa_len)
        fr_np = frames.cpu().numpy()
        qs_all, qe_all, ss_all, se_all, valid_all = (
            t.cpu().numpy() for t in (ch.qs, ch.qe, ch.ss, ch.se, ch.valid))

        confirm_a: List[np.ndarray] = []
        confirm_b: List[np.ndarray] = []
        confirm_meta: List[Tuple] = []
        for b in range(len(cand_seqs)):
            for f in range(6):
                row = b * 6 + f
                qs, qe = qs_all[row], qe_all[row]
                ss, se = ss_all[row], se_all[row]
                for i in np.nonzero(valid_all[row])[0][:max_hits_per_cand]:
                    e_idx = int(np.searchsorted(self.starts, ss[i],
                                                side="right") - 1)
                    e_idx = max(0, min(e_idx, len(self.names) - 1))
                    pad_q = 10
                    a0 = max(0, int(qs[i]) - pad_q)
                    a1 = min(Laa, int(qe[i]) + pad_q)
                    s0 = max(self.starts[e_idx], int(ss[i]) - pad_q)
                    s1 = min(self.starts[e_idx] + self.lens[e_idx],
                             int(se[i]) + pad_q)
                    confirm_a.append(fr_np[b, f, a0:a1])
                    confirm_b.append(self.flat[s0:s1])
                    confirm_meta.append((b, f, a0, e_idx, int(s0)))
        if not confirm_a:
            return out

        wa = max(len(x) for x in confirm_a + confirm_b)
        wa = 1 << (wa - 1).bit_length()
        n_rows = pad_rows(len(confirm_a))
        # pad_seqs fills with nucleotide code 4, which is Cysteine in aa
        # space: remap only the padding (past each row's length) to X
        amat, alens_ = pad_seqs(confirm_a, wa, n_rows=n_rows)
        bmat, blens_ = pad_seqs(confirm_b, wa, n_rows=n_rows)
        col = np.arange(wa)
        amat = np.where(col[None, :] < alens_[:, None], amat, AA_X)
        bmat = np.where(col[None, :] < blens_[:, None], bmat, AA_X)
        al = batched_local_align_auto(
            torch.from_numpy(amat.astype(np.uint8)).to(self.device),
            torch.from_numpy(bmat.astype(np.uint8)).to(self.device),
            mismatch=-4, gap=8, submatrix=BLOSUM62, invalid_code=AA_X)
        score, aqs, aqe, ass_, ase, matches, alen = (
            t.cpu().numpy() for t in al)

        for m, (b, f, a0, e_idx, s0) in enumerate(confirm_meta):
            if alen[m] < min_aa_len:
                continue
            ident = matches[m] / max(alen[m], 1)
            if ident < min_identity:
                continue
            aa_s = a0 + int(aqs[m])
            aa_e = a0 + int(aqe[m])
            L_nt = int(lens[b])
            if f < 3:
                nt_s = f + 3 * aa_s
                nt_e = f + 3 * aa_e
            else:
                fr = f - 3
                nt_e = L_nt - (fr + 3 * aa_s)
                nt_s = L_nt - (fr + 3 * aa_e)
            sp_s = s0 + int(ass_[m]) - int(self.starts[e_idx])
            sp_e = s0 + int(ase[m]) - int(self.starts[e_idx])
            out[b].append(DomainHit(
                entry=self.names[e_idx],
                q_start=max(0, nt_s), q_end=min(L_nt, nt_e), frame=f,
                identity=float(ident), score=int(score[m]),
                entry_cov=(sp_e - sp_s) / max(int(self.lens[e_idx]), 1),
                s_start=sp_s, s_end=sp_e,
            ))
        for hits in out:
            hits.sort(key=lambda h: -h.score)
        return out


def write_domain_table(path: str, names: Sequence[str],
                       hit_sets: Sequence[Sequence[DomainHit]]) -> None:
    """TE<->domain table (parity with the reference's domain output)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        fh.write("TE_name\tdomain_name\tTE_start\tTE_end\t"
                 "domain_start\tdomain_end\tidentity\n")
        for name, hits in zip(names, hit_sets):
            for h in hits:
                fh.write(f"{name}\t{h.entry}\t{h.q_start}\t{h.q_end}\t"
                         f"{h.s_start}\t{h.s_end}\t{h.identity:.3f}\n")


def rescue_by_domain(
    cand_seqs: Sequence[np.ndarray],
    scanner: DomainScanner,
    min_entry_cov: float = 0.95,
    min_identity: float = 0.6,
) -> np.ndarray:
    """Bool mask of candidates carrying a >=min_entry_cov-intact domain
    (the low-copy / LINE rescue criterion, `Util.py:8215-8281`)."""
    hit_sets = scanner.scan(cand_seqs, min_identity=min_identity)
    return np.array([
        any(h.entry_cov >= min_entry_cov for h in hits) for hits in hit_sets
    ])


# ---- reverse-transcriptase motif grammar (LTRPeps.lib replacement) ------

# RT core motif grammar (Xiong & Eickbush 1990 domain blocks 4 and 5):
# every LTR retrotransposon pol carries, in one reading frame,
# [LIVM]PQG followed 5-200 aa later by the catalytic [YF]xDD triad.
# LTRPeps.lib is a missing blob in the reference checkout, so the
# single-copy gate's protein half runs on this data-free grammar.
_RT_M1_FIRST = tuple("LIVM")
_RT_M2_FIRST = tuple("YF")


def _frames_by_bucket(cand_seqs: Sequence[np.ndarray], device: Device):
    """(candidate indices, uint8 [B, 6, W//3 - 1] host frames) per width
    bucket, translated on `device` (None = the card)."""
    dev = resolve_device(device)
    widths = [max(96, len(s)) for s in cand_seqs]
    for width, idxs in bucket_iter(range(len(cand_seqs)), np.array(widths)):
        sub = [cand_seqs[i] for i in idxs]
        mat, _ = pad_seqs(sub, width, n_rows=pad_rows(len(sub)))
        yield idxs, translate_frames(torch.from_numpy(mat).to(dev)).cpu().numpy()


def rt_motif_present(cand_seqs: Sequence[np.ndarray], gap_min: int = 5,
                     gap_max: int = 200, device: Device = None) -> np.ndarray:
    """Bool [N]: a reading frame contains the ordered RT motif grammar."""
    n = len(cand_seqs)
    out = np.zeros(n, bool)
    if n == 0:
        return out
    m1_first = np.array([AA_TO_CODE[c] for c in _RT_M1_FIRST])
    pqg = np.array([AA_TO_CODE[c] for c in "PQG"])
    m2_first = np.array([AA_TO_CODE[c] for c in _RT_M2_FIRST])
    dd = np.array([AA_TO_CODE[c] for c in "DD"])

    for idxs, aa in _frames_by_bucket(cand_seqs, device):
        for bi, i in enumerate(idxs):
            fr = aa[bi]
            # motif start masks per frame
            m1 = (np.isin(fr[:, :-3], m1_first)
                  & (fr[:, 1:-2] == pqg[0])
                  & (fr[:, 2:-1] == pqg[1])
                  & (fr[:, 3:] == pqg[2]))
            m2 = (np.isin(fr[:, :-3], m2_first)
                  & (fr[:, 2:-1] == dd[0]) & (fr[:, 3:] == dd[1]))
            for f in range(6):
                p1 = np.nonzero(m1[f])[0]
                if not len(p1):
                    continue
                p2 = np.nonzero(m2[f])[0]
                if not len(p2):
                    continue
                d = p2[None, :] - p1[:, None] - 4   # aa gap after LPQG
                if ((d >= gap_min) & (d <= gap_max)).any():
                    out[i] = True
                    break
    return out


def _motif_nt_positions(aa_frames: np.ndarray, hit_mask_fn) -> int:
    """First nucleotide position of a motif over the 3 FORWARD frames of
    one element's [6, W//3] aa matrix; -1 if absent.  (Intact LTR records
    are already oriented by TG...CA, so forward frames suffice.)"""
    best = -1
    for f in range(3):
        pos = hit_mask_fn(aa_frames[f])
        if len(pos):
            nt = 3 * int(pos[0]) + f
            if best < 0 or nt < best:
                best = nt
    return best


def ltr_domain_order(cand_seqs: Sequence[np.ndarray],
                     device: Device = None) -> np.ndarray:
    """int8 [N]: 1 = Copia domain order (INT upstream of RT), 2 = Gypsy
    order (RT upstream of INT), 0 = no call.

    The Copia/Gypsy discriminator is pol domain ORDER (Wicker 2007):
    Copia pol is PR-INT-RT-RH, Gypsy is PR-RT-RH-INT.  Both anchors are
    data-free grammars: RT by [LIVM]PQG..[YF]xDD (rt_motif_present) and
    integrase by its N-terminal zinc-binding signature
    H-X(3-7)-H-X(23-32)-C-X(2)-C.
    """
    n = len(cand_seqs)
    out = np.zeros(n, np.int8)
    if n == 0:
        return out
    m1_first = np.array([AA_TO_CODE[c] for c in _RT_M1_FIRST])
    pqg = np.array([AA_TO_CODE[c] for c in "PQG"])
    m2_first = np.array([AA_TO_CODE[c] for c in _RT_M2_FIRST])
    dd = np.array([AA_TO_CODE[c] for c in "DD"])
    code_h = AA_TO_CODE["H"]
    code_c = AA_TO_CODE["C"]

    def rt_hits(fr: np.ndarray) -> np.ndarray:
        m1 = (np.isin(fr[:-3], m1_first) & (fr[1:-2] == pqg[0])
              & (fr[2:-1] == pqg[1]) & (fr[3:] == pqg[2]))
        p1 = np.nonzero(m1)[0]
        if not len(p1):
            return p1
        m2 = (np.isin(fr[:-3], m2_first)
              & (fr[2:-1] == dd[0]) & (fr[3:] == dd[1]))
        p2 = np.nonzero(m2)[0]
        if not len(p2):
            return p2[:0]
        d = p2[None, :] - p1[:, None] - 4
        ok = ((d >= 5) & (d <= 200)).any(axis=1)
        return p1[ok]

    def int_hits(fr: np.ndarray) -> np.ndarray:
        hp = np.nonzero(fr == code_h)[0]
        if len(hp) < 2:
            return hp[:0]
        cp = np.nonzero(fr == code_c)[0]
        if len(cp) < 2:
            return hp[:0]
        # C-X(2)-C pairs
        c1 = cp[np.isin(cp + 3, cp)]
        if not len(c1):
            return c1
        # H..H with 3-7 aa between: starts 4-8 apart
        gh = hp[None, :] - hp[:, None]
        i1, i2 = np.nonzero((gh >= 4) & (gh <= 8))
        if not len(i1):
            return hp[:0]
        h2 = hp[i2]
        d = c1[None, :] - h2[:, None]
        ok = ((d >= 24) & (d <= 33)).any(axis=1)
        return np.sort(hp[i1[ok]])

    for idxs, aa in _frames_by_bucket(cand_seqs, device):
        for bi, i in enumerate(idxs):
            rt_nt = _motif_nt_positions(aa[bi], rt_hits)
            if rt_nt < 0:
                continue
            int_nt = _motif_nt_positions(aa[bi], int_hits)
            if int_nt < 0:
                continue
            out[i] = 1 if int_nt < rt_nt else 2
    return out
