"""Pan-genome TE analysis (panHiTE equivalent; counterpart of the JAX
package's `pipeline/pan.py`).

Re-implements `panHiTE.py` / `panHiTE.nf` (SURVEY.md §3.5): per-genome
HiTE runs (independent -> per-rank data parallelism in a real
deployment), merged pan-TE library with redundancy removal
(`pan_remove_redundancy.py`), cross-genome low-copy rescue
(`pan_recover_low_copy_TEs.py`: a candidate too rare in one genome is
re-validated with copies accumulated across ALL genomes), per-genome
annotation, and population analytics: core / softcore / dispensable /
private partitioning by genome occupancy
(`get_core_softcore_dispensable_private_uknown_TEs` `Util.py:13465`) and
presence/absence (PAV) matrices (`generate_fl_panTE_PAV` `Util.py:14461`).

Each genome carries its torch device and its stages run there.  Under a
`torch.distributed` process group (`parallel.multihost`) each rank takes
every world-size-th genome and the per-genome results are exchanged with
one all-gather; without one, a single process does every genome.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from hite_tpu_torch.config import PipelineConfig
from hite_tpu_torch.genome import Genome
from hite_tpu_torch.io.fasta import write_fasta
from hite_tpu_torch.parallel import multihost as mh
from hite_tpu_torch.pipeline.boundary_adjust import adjust_candidate
from hite_tpu_torch.pipeline.coarse import CoarseParams
from hite_tpu_torch.pipeline.copies import CopyFinder, CopyHit, GenomeIndex
from hite_tpu_torch.pipeline.libcluster import cluster_seqs
from hite_tpu_torch.pipeline.run import RunResult, run_pipeline
from hite_tpu_torch.utils.log import logger, stage_timer


@dataclass
class PanResult:
    pan_lib: Dict[str, np.ndarray]
    per_genome: Dict[str, RunResult]
    occupancy: Dict[str, int] = field(default_factory=dict)
    classification: Dict[str, str] = field(default_factory=dict)
    pav: Optional[np.ndarray] = None          # [families, genomes] copy counts
    pav_families: List[str] = field(default_factory=list)
    pav_genomes: List[str] = field(default_factory=list)
    rescued: int = 0


def sweep_genome_copies(
    gnames: List[str],
    find,
    cand_seqs: List[np.ndarray],
    max_copies: int,
) -> Dict[str, List[List[CopyHit]]]:
    """Sequential per-genome copy sweep with EARLY DROP.

    Mirrors the reference's cross-genome rescue loop
    (`pan_recover_low_copy_TEs.py:326`): a candidate that has accumulated
    >= max_copies hits across the genomes swept so far is excluded from
    the joins against the remaining genomes — at hundreds of genomes most
    candidates either satisfy the cap early or never will, so the join
    width shrinks as the sweep proceeds.  `find(gname, seqs)` maps the
    given candidate sequences against one genome.
    """
    out: Dict[str, List[List[CopyHit]]] = {}
    acc = np.zeros(len(cand_seqs), np.int64)
    active = list(range(len(cand_seqs)))
    for gname in gnames:
        full: List[List[CopyHit]] = [[] for _ in cand_seqs]
        if active:
            found = find(gname, [cand_seqs[i] for i in active])
            for i, hits_i in zip(active, found):
                full[i] = hits_i
                acc[i] += len(hits_i)
            active = [i for i in active if acc[i] < max_copies]
        out[gname] = full
    return out


def run_pan_pipeline(
    genomes: Dict[str, Genome],
    cfg: PipelineConfig,
    out_dir: Optional[str] = None,
    coarse_params: Optional[CoarseParams] = None,
    softcore_frac: float = 0.9,
    min_pan_copies: int = 5,
) -> PanResult:
    params = coarse_params or CoarseParams()

    # stage 1: independent per-genome runs (the reference fans these out as
    # Nextflow processes over a shared filesystem, `panHiTE.nf:94-129`).
    # Under a process group each rank takes every world-size-th genome and
    # the RunResults are exchanged with one all-gather — no files.
    my_names = mh.partition(list(genomes.keys()))
    local_results: Dict[str, RunResult] = {}
    for name in my_names:
        # per-genome out_dir gives each run the checkpoint/recover
        # machinery (reference per-process storeDir, panHiTE.nf:94-129)
        g_out = (os.path.join(out_dir, "genomes", name)
                 if out_dir else None)
        with stage_timer(f"pan.run.{name}"):
            local_results[name] = run_pipeline(genomes[name], cfg,
                                               out_dir=g_out,
                                               coarse_params=params)
    per_genome = mh.merge_dicts(mh.allgather_obj(local_results))
    # deterministic genome order on every rank
    per_genome = {n: per_genome[n] for n in genomes if n in per_genome}

    # stage 2: merged non-redundant pan library
    with stage_timer("pan.merge_lib"):
        entries: List[Tuple[str, np.ndarray]] = []
        for gname, res in per_genome.items():
            for ename, seq in res.libs.get("merged", {}).items():
                entries.append((f"{gname}:{ename}", seq))
        pan_lib: Dict[str, np.ndarray] = {}
        if entries:
            seqs = [s for _, s in entries]
            # the JAX package also passes identity=cluster_identity, which
            # its cluster_seqs never reads (clusters form by coverage alone,
            # ROADMAP queue 3, quirk 2); the port's does not take it
            _, reps = cluster_seqs(
                seqs, cfg.align, coverage=cfg.library.cluster_cov_short,
                device=next(iter(genomes.values())).device)
            for r in reps:
                pan_lib[entries[r][0]] = seqs[r]

    # per-genome indexes reused for rescue + occupancy
    gindexes = {n: GenomeIndex(g, cfg.align, seg_len=params.seg_len)
                for n, g in genomes.items()}
    finders = {n: CopyFinder(gindexes[n]) for n in genomes}

    # stage 3: cross-genome low-copy rescue (pan_recover_low_copy_TEs) —
    # all low-copy candidates mapped against each genome in ONE batched
    # call, then re-judged with accumulated pan support
    rescued = 0
    with stage_timer("pan.low_copy_rescue"):
        low_items: List[Tuple[str, int, int, np.ndarray]] = []
        for gname, res in per_genome.items():
            home = genomes[gname]
            for mod, mtype in ((res.tir, "tir"), (res.helitron, "helitron"),
                               (res.non_ltr, "non_ltr")):
                if mod is None:
                    continue
                for (s, e) in mod.low_copy.intervals:
                    cand = home.extract(int(s), int(e))
                    if len(cand) >= cfg.library.min_te_len:
                        low_items.append((gname, int(s), int(e), cand, mtype))

        if low_items:
            # per-genome batched mapping of every low-copy candidate; each
            # rank maps against its genome partition, then hit lists are
            # all-gathered (cross-genome copy retrieval is the natural
            # all-gather point, SURVEY.md §7 "hard parts").
            # EARLY-DROP (pan_recover_low_copy_TEs.py:326): a candidate
            # that has accumulated >= max_copies across the genomes mapped
            # so far stops being mapped against this rank's remaining
            # genomes — at hundreds of genomes most candidates either
            # satisfy the cap early or never will, so the per-genome join
            # width shrinks as the sweep proceeds.
            my_hits = sweep_genome_copies(
                mh.partition(list(genomes.keys())),
                lambda oname, seqs: finders[oname].find_copies(
                    seqs, min_coverage=0.9, max_copies=cfg.msa.max_copies),
                [it[3] for it in low_items], cfg.msa.max_copies)
            per_genome_hits = mh.merge_dicts(mh.allgather_obj(my_hits))
            # type-specific re-judging (the reference re-enters the full
            # per-class MSA boundary judge, pan_recover_low_copy_TEs.py:
            # 297-457 -> filter_true_TEs -> run_find_members_v8, instead
            # of a generic both-sides-homology check)
            from hite_tpu_torch.pipeline.helitron import make_helitron_judge
            from hite_tpu_torch.pipeline.non_ltr import make_nonltr_judge
            from hite_tpu_torch.pipeline.tir import make_tir_judge

            judges = {"tir": make_tir_judge(cfg.plant),
                      "helitron": make_helitron_judge(),
                      "non_ltr": make_nonltr_judge(cfg)}
            class_label = {"tir": "DNA", "helitron": "RC/Helitron",
                           "non_ltr": "Unknown"}
            for li, (gname, s, e, cand, mtype) in enumerate(low_items):
                total = sum(len(per_genome_hits[o][li]) for o in genomes)
                if total < min_pan_copies:
                    continue
                # re-judge with copies accumulated from ALL genomes —
                # the point of cross-genome support.  The reference
                # likewise accumulates extend-copy sequences per genome
                # (pan_recover_low_copy_TEs.py:384-396); a previous
                # home-copies-only shortcut left the judge a 2-row
                # matrix for exactly the candidates the rescue exists
                # for, and the pan rescue never fired.  Hits live in
                # other genomes' coordinate spaces, so each is extracted
                # by its owner, strand-corrected, and passed
                # pre-extracted (trunc to head/tail handled generically
                # by the engine's long_copy_trunc).
                from hite_tpu_torch.io.fasta import revcomp as np_revcomp

                copies_arg = []
                for o in genomes:
                    g_o = genomes[o]
                    for h in per_genome_hits[o][li]:
                        cs = g_o.extract(h.start, h.end,
                                         cfg.msa.frame_flank)
                        copies_arg.append(
                            np_revcomp(cs) if h.strand == 1 else cs)
                # truncated in genome-dict order, so the home genome's own
                # copies can be cut: the JAX package's order, kept bit for
                # bit (ROADMAP queue 3, quirk 6)
                copies_arg = copies_arg[: cfg.msa.max_copies]
                result = adjust_candidate(
                    genomes[gname], (s, e), copies_arg, cfg.msa,
                    judges[mtype], min_copies=2)
                if result.accepted:
                    key = f"{gname}:rescued_{rescued}#{class_label[mtype]}"
                    pan_lib[key] = genomes[gname].extract(result.start,
                                                          result.end)
                    rescued += 1
    logger.info("pan: rescued %d low-copy families across genomes", rescued)

    # stage 4: occupancy + PAV via full-length copies per genome (coverage
    # slightly below the strict full-length bound so small boundary
    # differences between per-genome consensi don't hide true presence)
    fam_names = list(pan_lib.keys())
    pav = np.zeros((len(fam_names), len(genomes)), np.int32)
    occ_cov = max(0.8, cfg.library.full_length_cov - 0.1)
    with stage_timer("pan.occupancy"):
        # each rank maps the pan library onto its partition of genomes;
        # columns are exchanged with the same all-gather as stage 1
        gnames = list(genomes.keys())
        my_cols: Dict[str, np.ndarray] = {}
        for gname in mh.partition(gnames):
            counts = finders[gname].find_copies(
                [pan_lib[f] for f in fam_names],
                min_coverage=occ_cov,
                max_copies=cfg.msa.max_copies)
            my_cols[gname] = np.array([len(h) for h in counts], np.int32)
        all_cols = mh.merge_dicts(mh.allgather_obj(my_cols))
        for gj, gname in enumerate(gnames):
            pav[:, gj] = all_cols[gname]

    occupancy = {f: int((pav[i] > 0).sum()) for i, f in enumerate(fam_names)}
    n = len(genomes)
    classification = {}
    for f, occ in occupancy.items():
        if occ == n:
            classification[f] = "core"
        elif occ >= max(2, int(np.ceil(softcore_frac * n))):
            classification[f] = "softcore"
        elif occ > 1:
            classification[f] = "dispensable"
        elif occ == 1:
            classification[f] = "private"
        else:
            classification[f] = "unknown"

    result = PanResult(pan_lib=pan_lib, per_genome=per_genome,
                       occupancy=occupancy, classification=classification,
                       pav=pav, pav_families=fam_names,
                       pav_genomes=list(genomes.keys()), rescued=rescued)

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        write_fasta(os.path.join(out_dir, "panTE.fa"), pan_lib)
        with open(os.path.join(out_dir, "pan_classification.json"), "w") as fh:
            json.dump({"occupancy": occupancy,
                       "classification": classification}, fh, indent=2)
        with open(os.path.join(out_dir, "pan_PAV.tsv"), "w") as fh:
            fh.write("family\t" + "\t".join(result.pav_genomes) + "\n")
            for i, f in enumerate(fam_names):
                fh.write(f + "\t" + "\t".join(map(str, pav[i])) + "\n")
        ltr_insert_time_outputs(per_genome, out_dir)
        pan_summary_plots(result, out_dir)
    return result


def pan_summary_plots(result: "PanResult", out_dir: str) -> None:
    """PAV heatmap + core/softcore/dispensable/private bars
    (`summary_TEs` figure outputs, `Util.py:12851`).  Best-effort."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        if result.pav is None or not len(result.pav_families):
            return
        fig, (ax1, ax2) = plt.subplots(
            1, 2, figsize=(10, max(4, 0.25 * len(result.pav_families))),
            gridspec_kw={"width_ratios": [3, 1]})
        pav = (result.pav > 0).astype(int)
        ax1.imshow(pav, aspect="auto", cmap="Greys", vmin=0, vmax=1)
        ax1.set_xticks(range(len(result.pav_genomes)))
        ax1.set_xticklabels(result.pav_genomes, rotation=45, ha="right",
                            fontsize=7)
        ax1.set_yticks(range(len(result.pav_families)))
        ax1.set_yticklabels(result.pav_families, fontsize=6)
        ax1.set_title("panTE presence/absence")
        order = ("core", "softcore", "dispensable", "private", "unknown")
        counts = {c: 0 for c in order}
        for c in result.classification.values():
            counts[c] = counts.get(c, 0) + 1
        ax2.bar(range(len(order)), [counts[c] for c in order],
                color="#4c72b0")
        ax2.set_xticks(range(len(order)))
        ax2.set_xticklabels(order, rotation=45, ha="right", fontsize=7)
        ax2.set_title("TE classes")
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, "pan_summary.pdf"))
        plt.close(fig)
    except Exception as e:
        logger.warning("pan: summary plot skipped (%s)", e)


def ltr_insert_time_outputs(
    per_genome: Dict[str, RunResult],
    out_dir: str,
    classes: Tuple[str, ...] = ("LTR/Copia", "LTR/Gypsy"),
) -> str:
    """Pan-level intact-LTR insertion-time table + boxplot.

    `draw_intact_LTR_insert_time` parity (`Util.py:13379-13409`): a CSV of
    (Genome, Insertion_Time [Myr], Classification) over the Copia/Gypsy
    intact elements of every genome, plus a per-genome boxplot PDF.
    """
    rows: List[Tuple[str, float, str]] = []
    for gname, res in per_genome.items():
        if res.ltr is None:
            continue
        for r in res.ltr.records:
            if r.superfamily in classes:
                rows.append((gname, r.insert_time / 1e6, r.superfamily))
    os.makedirs(out_dir, exist_ok=True)
    csv_path = os.path.join(out_dir, "ltr_insert_time.csv")
    with open(csv_path, "w") as fh:
        fh.write("Genome,Insertion_Time,Classification\n")
        for g, t, c in rows:
            fh.write(f"{g},{t:.6f},{c}\n")
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        gnames = list(per_genome.keys())
        fig, ax = plt.subplots(figsize=(max(6, 1.2 * len(gnames)), 6))
        width = 0.35
        for ci, cls in enumerate(classes):
            data = [[t for g2, t, c in rows if g2 == g and c == cls]
                    for g in gnames]
            pos = [i + (ci - (len(classes) - 1) / 2) * width
                   for i in range(len(gnames))]
            bp = ax.boxplot(data, positions=pos, widths=width * 0.9,
                            showfliers=False, patch_artist=True)
            color = ["#4c72b0", "#dd8452"][ci % 2]
            for box in bp["boxes"]:
                box.set_facecolor(color)
        ax.set_xticks(range(len(gnames)))
        ax.set_xticklabels(gnames, rotation=45, ha="right")
        ax.set_ylabel("Insertion time (Mya)")
        ax.legend(handles=[plt.Rectangle((0, 0), 1, 1, fc=c)
                           for c in ("#4c72b0", "#dd8452")[: len(classes)]],
                  labels=list(classes))
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, "ltr_insert_time.pdf"))
        plt.close(fig)
    except Exception as e:               # plotting is best-effort
        logger.warning("pan: insertion-time plot skipped (%s)", e)
    return csv_path


def preprocess_genome_list(
    genome_list_path: str,
    pan_genomes_dir: str,
    genes_dir: Optional[str] = None,
    rna_dir: Optional[str] = None,
    out_dir: Optional[str] = None,
) -> List[Dict]:
    """Parse the panHiTE genome list into metadata records.

    Reference `pan_preprocess_genomes.py`: each line is
    ``genome_name[\\tgene_gff[\\tis_PE\\tRNA1[\\tRNA2|more...]]]``; validates
    referenced files and writes `genome_metadata.json`.
    """
    metas: List[Dict] = []
    with open(genome_list_path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split("\t")
            meta: Dict = {
                "genome_name": parts[0],
                "genome_path": os.path.join(pan_genomes_dir, parts[0]),
            }
            if not os.path.exists(meta["genome_path"]):
                raise FileNotFoundError(meta["genome_path"])
            if len(parts) >= 2 and parts[1]:
                if not parts[1].endswith((".gff", ".gff3")):
                    raise ValueError(
                        f"gene annotation must be .gff/.gff3: {parts[1]}")
                gpath = (os.path.join(genes_dir, parts[1])
                         if genes_dir else parts[1])
                if not os.path.exists(gpath):
                    raise FileNotFoundError(gpath)
                meta["gene_gff"] = gpath
            if len(parts) > 3:
                is_pe = bool(int(parts[2]))
                rna = [os.path.join(rna_dir, p) if rna_dir else p
                       for p in parts[3:]]
                for p in rna:
                    if not os.path.exists(p):
                        raise FileNotFoundError(p)
                meta["RNA"] = rna
                meta["is_PE"] = is_pe
            metas.append(meta)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "genome_metadata.json"), "w") as fh:
            json.dump(metas, fh, indent=2)
    return metas


def pan_downstream_analysis(
    genomes: Dict[str, Genome],
    pan_result: PanResult,
    metas: List[Dict],
    cfg: PipelineConfig,
    out_dir: str,
    window: int = 10_000,
) -> Dict[str, int]:
    """panHiTE stages 4-7 (SURVEY.md §3.5): per-genome annotation with the
    pan library, gene<->TE associations, RNA-seq quantification, and
    TE-insertion DE-gene detection.

    metas: records from `preprocess_genome_list` (gene_gff / RNA optional
    per genome).  Per-genome annotation fans out over torch.distributed
    ranks like the per-genome HiTE runs.  Returns summary counts.
    """
    from hite_tpu_torch.pipeline import rnaseq as rs
    from hite_tpu_torch.pipeline.annotate import (
        annotate_genome, write_annotation,
    )

    os.makedirs(out_dir, exist_ok=True)
    meta_by = {m["genome_name"]: m for m in metas}
    pan_lib = pan_result.pan_lib

    # stage 4: per-genome annotation with panTE.fa (pan_annotate_genome)
    my_hits: Dict[str, list] = {}
    for gname in mh.partition(list(genomes.keys())):
        with stage_timer(f"pan.annotate.{gname}"):
            my_hits[gname] = annotate_genome(genomes[gname], pan_lib, cfg)
            write_annotation(os.path.join(out_dir, f"{gname}"),
                             my_hits[gname], genomes[gname])
    all_hits = mh.merge_dicts(mh.allgather_obj(my_hits))

    # stage 5: gene<->TE associations (pan_gene_te_relation)
    associations: list = []
    genes_by: Dict[str, list] = {}
    for gname, m in meta_by.items():
        if "gene_gff" not in m or gname not in all_hits:
            continue
        genes = rs.read_gtf_features(m["gene_gff"], feature_type="gene")
        if not genes:  # GFFs without explicit gene rows
            genes = rs.read_gtf_features(m["gene_gff"])
        genes_by[gname] = genes
        tes = rs.features_from_hits(all_hits[gname])
        associations += rs.associate_genes_tes(gname, genes, tes, window)
    if associations:
        rs.write_associations(
            os.path.join(out_dir, "gene_te_associations.tsv"), associations)

    # stage 6: RNA-seq quantification per genome (pan_detect_de_genes's
    # trim -> map -> featureCounts -> normalise front half)
    per_sample: Dict[str, Dict[str, Dict[str, float]]] = {}
    for gname in mh.partition(list(genomes.keys())):
        m = meta_by.get(gname)
        if not m or "RNA" not in m or gname not in genes_by:
            continue
        with stage_timer(f"pan.rnaseq.{gname}"):
            reads: list = []
            quals: list = []
            for path in m["RNA"]:
                s, q = rs.read_fastq(path)
                reads += s
                quals += q
            trimmed = rs.trim_reads(reads, quals)
            feats = genes_by[gname] + rs.features_from_hits(all_hits[gname])
            per_sample[gname] = rs.quantify_sample(
                genomes[gname], trimmed, feats, cfg.align)
    per_sample = mh.merge_dicts(mh.allgather_obj(per_sample))
    n_de = 0
    if per_sample:
        rs.merge_expression_tables(
            per_sample, os.path.join(out_dir, "gene_express.table"))
        # stage 7: DE detection against TE-insertion positions
        gene_ids = {g.feature_id for gs in genes_by.values() for g in gs}
        expression: Dict[str, Dict[str, float]] = {}
        for sname, table in per_sample.items():
            for feat, row in table.items():
                if feat in gene_ids:
                    expression.setdefault(feat, {})[sname] = row["tpm"]
        results = rs.detect_de_genes(expression, associations)
        rs.write_de_genes(out_dir, results)
        n_de = sum(r.significant for r in results)
    logger.info("pan analysis: %d genomes annotated, %d associations, "
                "%d samples quantified, %d DE genes",
                len(all_hits), len(associations), len(per_sample), n_de)
    return {"annotated": len(all_hits), "associations": len(associations),
            "samples": len(per_sample), "de_genes": n_de}


def pan_benchmark(
    genomes: Dict[str, Genome],
    te_lib: Dict[str, np.ndarray],
    gold_lib: Dict[str, np.ndarray],
    cfg: PipelineConfig,
    out_dir: Optional[str] = None,
) -> Dict[str, Dict[str, float]]:
    """Per-genome BM_HiTE + BM_EDTA evaluation of one TE library.

    The reference fans `run_benchmarking_single` out per genome with both
    metrics on (`panTE_benchmarking.nf:28-43`, `--BM_EDTA 1 --BM_HiTE 1`);
    here each torch.distributed rank evaluates its genome partition and
    results are exchanged with one all-gather.
    """
    from hite_tpu_torch.pipeline.benchmark import (
        evaluate_edta, evaluate_library,
    )

    my_metrics: Dict[str, Dict[str, float]] = {}
    for gname in mh.partition(list(genomes.keys())):
        with stage_timer(f"pan.benchmark.{gname}"):
            m = evaluate_library(genomes[gname], te_lib, gold_lib, cfg)
            m["BM_EDTA"] = evaluate_edta(genomes[gname], te_lib, gold_lib,
                                         cfg)
            my_metrics[gname] = m
    metrics = mh.merge_dicts(mh.allgather_obj(my_metrics))
    metrics = {n: metrics[n] for n in genomes if n in metrics}
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "pan_benchmark.json"), "w") as fh:
            json.dump(metrics, fh, indent=2)
    return metrics


def main(argv=None, device: Optional[Union[str, torch.device]] = None
         ) -> None:
    """Pan-genome CLI (reference panHiTE.py surface).

    Genomes come from --pan_genomes_dir plus an optional --genome_list
    file (one `genome_name[\\tgene_name]` per line, like the reference),
    read onto `device` (None = the card; raises without a GPU).  Started
    by torchrun (WORLD_SIZE > 1 in the environment), each process first
    joins the process group (`multihost.init_from_env`) and then takes its
    share of the genomes.
    """
    import argparse

    from hite_tpu_torch.device import resolve_device

    p = argparse.ArgumentParser(
        description="hite_tpu_torch pan-genome TE analysis")
    p.add_argument("--pan_genomes_dir", required=True)
    p.add_argument("--genome_list", default=None)
    p.add_argument("--genes_dir", default=None)
    p.add_argument("--RNA_dir", default=None)
    p.add_argument("--out_dir", default="./pan_out")
    p.add_argument("--miu", type=float, default=1.3e-8)
    p.add_argument("--plant", type=int, default=1)
    p.add_argument("--chrom_seg_length", type=int, default=131_072)
    p.add_argument("--skip_analyze", type=int, default=0,
                   help="only build panTE.fa; skip annotation/gene-TE/"
                        "RNA-seq analytics (panHiTE --skip_analyze)")
    # panTE_benchmarking.nf mode: evaluate an existing library per genome
    p.add_argument("--TE_lib", default=None,
                   help="existing panTE library: run per-genome BM_HiTE "
                        "only (panTE_benchmarking.nf)")
    p.add_argument("--species", default=None,
                   help="curated benchmark library FASTA path")
    args = p.parse_args(argv)

    mh.init_from_env(device)
    dev = resolve_device(device)
    names: List[str] = []
    metas: List[Dict] = []
    if args.genome_list:
        metas = preprocess_genome_list(
            args.genome_list, args.pan_genomes_dir,
            genes_dir=args.genes_dir, rna_dir=args.RNA_dir,
            out_dir=args.out_dir)
        names = [m["genome_name"] for m in metas]
    else:
        names = sorted(f for f in os.listdir(args.pan_genomes_dir)
                       if f.endswith((".fa", ".fasta", ".fna")))
        metas = [{"genome_name": n} for n in names]

    genomes = {n: Genome.from_fasta(os.path.join(args.pan_genomes_dir, n),
                                    device=dev)
               for n in names}
    import dataclasses

    cfg = PipelineConfig(plant=bool(args.plant))
    cfg = cfg.replace(ltr=dataclasses.replace(cfg.ltr, miu=args.miu))
    if args.TE_lib:
        from hite_tpu_torch.io.fasta import read_fasta
        from hite_tpu_torch.pipeline.benchmark import species_library_path

        gold_path = species_library_path(args.species) if args.species else None
        if gold_path is None:
            raise SystemExit("--TE_lib mode needs --species (path or name)")
        pan_benchmark(genomes, read_fasta(args.TE_lib),
                      read_fasta(gold_path), cfg, out_dir=args.out_dir)
        return
    result = run_pan_pipeline(
        genomes, cfg, out_dir=args.out_dir,
        coarse_params=CoarseParams(seg_len=args.chrom_seg_length))
    if not args.skip_analyze:
        pan_downstream_analysis(genomes, result, metas, cfg, args.out_dir)


def gene_te_associations(
    genome: Genome,
    te_hits,
    gene_intervals: Dict[str, Tuple[str, int, int]],
    window: int = 10_000,
) -> List[Tuple[str, str, int]]:
    """TE<->gene associations within +-window bp
    (`find_gene_relation_tes` `Util.py:11568`, window `:11747`).

    gene_intervals: {gene_id: (contig, start, end)} 1-based.
    Returns (gene_id, te_family, distance) tuples (0 = overlapping).
    """
    out: List[Tuple[str, str, int]] = []
    by_contig: Dict[str, List] = {}
    for h in te_hits:
        by_contig.setdefault(h.contig, []).append(h)
    for gid, (contig, gs, ge) in gene_intervals.items():
        for h in by_contig.get(contig, []):
            if h.start > ge + window or h.end < gs - window:
                continue
            dist = max(0, max(gs - h.end, h.start - ge))
            out.append((gid, h.family, dist))
    return out


if __name__ == "__main__":
    main()
