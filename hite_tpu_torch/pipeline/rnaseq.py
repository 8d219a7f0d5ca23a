"""RNA-seq TE/gene expression quantification + TE-insertion DE-gene stage.

Counterpart of the JAX package's `pipeline/rnaseq.py`, function for
function; only `map_reads` touches the device (the copy join on the
genome's device).  Replacement for the reference's RNA-seq subsystem
(`module/pan_detect_de_genes.py` + `RNA_seq/`): the reference shells out to
trimmomatic (read trimming, `Util.py:12628-12672`), hisat2 (read alignment,
`generate_bam` `Util.py:12588-12626`), Rsubread featureCounts + edgeR
CPM/FPKM/TPM (`RNA_seq/run-featurecounts.R`), and a final R script that
t-tests gene expression across genomes grouped by TE-insertion position
(`RNA_seq/detect_DE_genes_from_TEs.R`).

Here the whole stage is in-process: reads are trimmed with the same
sliding-window rule trimmomatic applies (SLIDINGWINDOW:4:15 LEADING:3
TRAILING:3 MINLEN:36), mapped with the framework's own k-mer seed->chain
kernels (`pipeline/copies.CopyFinder` — the hisat2 replacement; unique
mappers only, matching featureCounts' countMultiMappingReads=FALSE),
counted per feature with featureCounts' unambiguous-overlap semantics, and
normalised to CPM/FPKM/TPM exactly as `run-featurecounts.R` does.  The DE
stage reproduces `detect_DE_genes_from_TEs.R`: per gene, Welch t-tests of
expression in genomes with an Upstream/Inside/Downstream TE insertion vs
genomes with no insertion, BH-FDR per position, log2(mean+1) fold changes,
significant = |lfc| > 1 and FDR < 0.05.
"""

from __future__ import annotations

import gzip
import math
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from hite_tpu_torch.io.fasta import encode_seq
from hite_tpu_torch.utils.log import logger, stage_timer

# ---------------------------------------------------------------------------
# FASTQ ingest + trimming (trimmomatic replacement)
# ---------------------------------------------------------------------------


def read_fastq(path: str, max_reads: Optional[int] = None
               ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Read (optionally gzipped) FASTQ into (codes uint8, phred int8) lists."""
    opener = gzip.open if path.endswith(".gz") else open
    seqs: List[np.ndarray] = []
    quals: List[np.ndarray] = []
    with opener(path, "rt") as fh:
        while True:
            header = fh.readline()
            if not header:
                break
            seq = fh.readline().strip()
            fh.readline()  # '+'
            qual = fh.readline().strip()
            if not header.startswith("@") or not seq:
                continue
            seqs.append(encode_seq(seq))
            quals.append(np.frombuffer(qual.encode(), np.uint8).astype(np.int16)
                         - 33)
            if max_reads is not None and len(seqs) >= max_reads:
                break
    return seqs, quals


@dataclass(frozen=True)
class TrimParams:
    """Trimmomatic-equivalent settings (reference `PE_RNA_trim`/`SE_RNA_trim`
    command line: LEADING:3 TRAILING:3 SLIDINGWINDOW:4:15 MINLEN:36)."""

    leading: int = 3
    trailing: int = 3
    window: int = 4
    window_qual: int = 15
    min_len: int = 36


def trim_read(codes: np.ndarray, qual: np.ndarray,
              p: TrimParams = TrimParams()) -> Optional[np.ndarray]:
    """Quality-trim one read; returns trimmed codes or None if below MINLEN."""
    n = min(len(codes), len(qual))
    codes, qual = codes[:n], qual[:n]
    lo, hi = 0, n
    while lo < hi and qual[lo] < p.leading:
        lo += 1
    while hi > lo and qual[hi - 1] < p.trailing:
        hi -= 1
    # SLIDINGWINDOW: scan 5'->3'; clip at the start of the first window whose
    # mean quality drops below the threshold (trimmomatic semantics).
    q = qual[lo:hi].astype(np.float64)
    if len(q) >= p.window:
        means = np.convolve(q, np.ones(p.window) / p.window, mode="valid")
        bad = np.nonzero(means < p.window_qual)[0]
        if len(bad):
            hi = lo + int(bad[0])
    out = codes[lo:hi]
    return out if len(out) >= p.min_len else None


def trim_reads(seqs: Sequence[np.ndarray], quals: Sequence[np.ndarray],
               p: TrimParams = TrimParams()) -> List[np.ndarray]:
    out = []
    for s, q in zip(seqs, quals):
        t = trim_read(s, q, p)
        if t is not None:
            out.append(t)
    return out


# ---------------------------------------------------------------------------
# Read mapping (hisat2 replacement) + feature counting (featureCounts)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Feature:
    """One annotation feature (GTF exon/TE line)."""

    feature_id: str
    contig: str
    start: int   # 1-based inclusive
    end: int     # inclusive
    strand: str = "+"


def features_from_hits(hits) -> List[Feature]:
    """AnnotationHit list (pipeline/annotate.py) -> countable TE features.

    Equivalent to `RNA_seq/makeTEGTF.pl`: one feature per TE insertion, with
    `_dupN` suffixes keeping instance ids unique per family.
    """
    seen: Dict[str, int] = {}
    out: List[Feature] = []
    for h in hits:
        n = seen.get(h.family, 0)
        seen[h.family] = n + 1
        fid = h.family if n == 0 else f"{h.family}_dup{n}"
        out.append(Feature(fid, h.contig, h.start, h.end, h.strand))
    return out


def read_gtf_features(path: str, feature_type: Optional[str] = None,
                      attr: str = "gene_id") -> List[Feature]:
    """Minimal GTF/GFF feature reader (reference `read_gff` `Util.py:11723`)."""
    import re

    out: List[Feature] = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 9:
                continue
            if feature_type and parts[2] != feature_type:
                continue
            m = re.search(attr + r'[ =]+"?([^";]+)"?', parts[8])
            fid = m.group(1) if m else parts[8]
            out.append(Feature(fid, parts[0], int(parts[3]), int(parts[4]),
                               parts[6]))
    return out


@dataclass
class ReadMapping:
    contig: str
    start: int   # 1-based
    end: int


def map_reads(genome, reads: Sequence[np.ndarray], cfg,
              gindex=None, min_coverage: float = 0.8,
              batch: int = 2048) -> List[Optional[ReadMapping]]:
    """Map reads to the genome with the seed->chain kernel (unique mappers).

    Returns one ReadMapping (or None for unmapped/multi-mapped) per read —
    the BAM-equivalent the counting stage consumes.  Multi-mappers are
    dropped like featureCounts' countMultiMappingReads=FALSE.
    """
    from hite_tpu_torch.pipeline.copies import CopyFinder, GenomeIndex

    gindex = gindex or GenomeIndex(genome, cfg)
    # fill_w=8: reads tile features densely, so many reads share each
    # genome k-mer (see CopyFinder fill_w note); max_chains is read only
    # by the segments mapper, as in the JAX package
    finder = CopyFinder(gindex, min_seeds=3, max_chains=16, fill_w=8)
    out: List[Optional[ReadMapping]] = []
    for b0 in range(0, len(reads), batch):
        chunk = list(reads[b0:b0 + batch])
        hit_sets = finder.find_copies(chunk, min_coverage=min_coverage,
                                      max_copies=3, max_len_ratio=1.5)
        for hits in hit_sets:
            if len(hits) != 1:          # unmapped or multi-mapped
                out.append(None)
                continue
            h = hits[0]
            ci, local = genome.contig_of(np.array([h.start]))
            span = h.end - h.start
            out.append(ReadMapping(contig=genome.names[int(ci[0])],
                                   start=int(local[0]) + 1,
                                   end=int(local[0]) + span))
    return out


def feature_counts(mappings: Sequence[Optional[ReadMapping]],
                   features: Sequence[Feature]) -> Dict[str, int]:
    """featureCounts-equivalent: a read counts for a feature when it overlaps
    it and no other feature (ambiguous reads dropped, the Rsubread default).
    """
    by_contig: Dict[str, List[Tuple[int, int, str]]] = {}
    for f in features:
        by_contig.setdefault(f.contig, []).append((f.start, f.end, f.feature_id))
    for v in by_contig.values():
        v.sort()
    counts = {f.feature_id: 0 for f in features}
    import bisect

    for m in mappings:
        if m is None:
            continue
        rows = by_contig.get(m.contig)
        if not rows:
            continue
        starts = [r[0] for r in rows]
        i = bisect.bisect_right(starts, m.end)
        touched = {fid for s, e, fid in rows[:i] if e >= m.start}
        if len(touched) == 1:
            counts[touched.pop()] += 1
    return counts


def expression_table(counts: Dict[str, int],
                     lengths: Dict[str, int]) -> Dict[str, Dict[str, float]]:
    """counts -> {feature: {counts,fpkm,tpm,cpm}} (edgeR formulas used by
    `run-featurecounts.R`: cpm = 1e6*c/N, fpkm = 1e9*c/(N*L),
    tpm = fpkm / sum(fpkm) * 1e6)."""
    total = max(1, sum(counts.values()))
    fpkm = {f: 1e9 * c / (total * max(1, lengths.get(f, 1)))
            for f, c in counts.items()}
    fpkm_sum = sum(fpkm.values()) or 1.0
    return {
        f: {
            "counts": float(c),
            "fpkm": fpkm[f],
            "tpm": 1e6 * fpkm[f] / fpkm_sum,
            "cpm": 1e6 * c / total,
        }
        for f, c in counts.items()
    }


def write_count_file(path: str, table: Dict[str, Dict[str, float]]) -> None:
    """Per-sample `.count` file (columns of `run-featurecounts.R`)."""
    with open(path, "w") as fh:
        fh.write("gene_id\tcounts\tfpkm\ttpm\tcpm\n")
        for f, row in table.items():
            fh.write(f"{f}\t{int(row['counts'])}\t{row['fpkm']:.6g}\t"
                     f"{row['tpm']:.6g}\t{row['cpm']:.6g}\n")


def merge_expression_tables(per_sample: Dict[str, Dict[str, Dict[str, float]]],
                            path: str) -> None:
    """Merged `gene_express.table`: one row per feature, one column per
    sample, cell = "counts,fpkm,tpm" (TPM last — the DE reader takes the
    last comma value, `detect_DE_genes_from_TEs.R`; format from
    `merge_gene_express_table` `Util.py:12760-12800`)."""
    samples = list(per_sample.keys())
    feats: List[str] = []
    for t in per_sample.values():
        for f in t:
            if f not in feats:
                feats.append(f)
    with open(path, "w") as fh:
        fh.write("gene_id\t" + "\t".join(samples) + "\n")
        for f in feats:
            cells = []
            for s in samples:
                row = per_sample[s].get(f)
                cells.append("NA" if row is None else
                             f"{int(row['counts'])},{row['fpkm']:.2f},"
                             f"{row['tpm']:.2f}")
            fh.write(f + "\t" + "\t".join(cells) + "\n")


def quantify_sample(genome, reads: Sequence[np.ndarray],
                    features: Sequence[Feature], cfg,
                    gindex=None) -> Dict[str, Dict[str, float]]:
    """One sample end-to-end: map -> count -> normalise."""
    with stage_timer("rnaseq.map"):
        mappings = map_reads(genome, reads, cfg, gindex=gindex)
    counts = feature_counts(mappings, features)
    lengths = {f.feature_id: f.end - f.start + 1 for f in features}
    n_mapped = sum(m is not None for m in mappings)
    logger.info("rnaseq: %d/%d reads uniquely mapped, %d counted",
                n_mapped, len(mappings), sum(counts.values()))
    return expression_table(counts, lengths)


# ---------------------------------------------------------------------------
# TE-insertion position calls + DE-gene detection
# ---------------------------------------------------------------------------


def te_position(te_start: int, te_end: int, gene_start: int, gene_end: int,
                gene_strand: str, window: int = 10_000) -> str:
    """Position of a TE relative to a gene (`check_te_in_gene`
    `Util.py:11746-11764`): Inside / Upstream / Downstream / None."""
    if te_end < gene_start - window or te_start > gene_end + window:
        return "None"
    if te_start >= gene_start and te_end <= gene_end:
        return "Inside"
    if te_start < gene_start and te_end >= gene_start - window:
        return "Upstream" if gene_strand == "+" else "Downstream"
    if te_start <= gene_end + window and te_end > gene_end:
        return "Downstream" if gene_strand == "+" else "Upstream"
    return "None"


@dataclass
class GeneTEAssociation:
    gene_name: str
    genome_name: str
    te_name: str
    contig: str
    te_start: int
    te_end: int
    gene_start: int
    gene_end: int
    position: str


def associate_genes_tes(genome_name: str, genes: Sequence[Feature],
                        tes: Sequence[Feature], window: int = 10_000
                        ) -> List[GeneTEAssociation]:
    """Gene<->TE association with Position labels (`analyze_te_insertions`
    `Util.py:11660-11711`, +-10kb window `:11747`)."""
    out: List[GeneTEAssociation] = []
    tes_by_contig: Dict[str, List[Feature]] = {}
    for t in tes:
        tes_by_contig.setdefault(t.contig, []).append(t)
    for g in genes:
        for t in tes_by_contig.get(g.contig, []):
            pos = te_position(t.start, t.end, g.start, g.end, g.strand, window)
            if pos != "None":
                out.append(GeneTEAssociation(
                    g.feature_id, genome_name, t.feature_id, t.contig,
                    t.start, t.end, g.start, g.end, pos))
    return out


def write_associations(path: str, rows: Sequence[GeneTEAssociation]) -> None:
    """`gene_te_associations.tsv` (columns of
    `save_gene_te_associations_to_file` `Util.py:11770-11792`)."""
    with open(path, "w") as fh:
        fh.write("Gene_name\tGenome_name\tTE_name\tChromosome\tTE_start\t"
                 "TE_end\tGene_start\tGene_end\tPosition\n")
        for r in rows:
            fh.write(f"{r.gene_name}\t{r.genome_name}\t{r.te_name}\t"
                     f"{r.contig}\t{r.te_start}\t{r.te_end}\t{r.gene_start}\t"
                     f"{r.gene_end}\t{r.position}\n")


def _welch_t_pvalue(x: np.ndarray, y: np.ndarray) -> float:
    """Two-sided Welch t-test p-value (R t.test default)."""
    if len(x) < 2 or len(y) < 2:
        return float("nan")
    from scipy import stats

    res = stats.ttest_ind(x, y, equal_var=False)
    return float(res.pvalue)


def bh_fdr(p: np.ndarray) -> np.ndarray:
    """Benjamini-Hochberg adjusted p-values (R p.adjust method='fdr');
    NaNs pass through and don't count toward m."""
    p = np.asarray(p, dtype=np.float64)
    out = np.full_like(p, np.nan)
    ok = ~np.isnan(p)
    pv = p[ok]
    m = len(pv)
    if m == 0:
        return out
    order = np.argsort(pv)
    ranked = pv[order] * m / (np.arange(m) + 1)
    adj = np.minimum.accumulate(ranked[::-1])[::-1]
    res = np.empty(m)
    res[order] = np.minimum(adj, 1.0)
    out[ok] = res
    return out


POSITIONS = ("Upstream", "Inside", "Downstream")


@dataclass
class DEGene:
    gene_name: str
    insert_type: str
    fold_change: float
    p_adjust: float
    significant: bool
    direction: str   # up / down / ns


def detect_de_genes(
    expression: Dict[str, Dict[str, float]],
    associations: Sequence[GeneTEAssociation],
    lfc_threshold: float = 1.0,
    fdr_threshold: float = 0.05,
) -> List[DEGene]:
    """`detect_DE_genes_from_TEs.R` equivalent.

    expression: {gene_id: {genome_name: expression}} (TPM per genome).
    Per gene, expression values across genomes are grouped by the gene's TE
    Position in each genome (No_Insertion when unlisted); Welch t-tests vs
    No_Insertion per position, BH-FDR across genes per position, fold change
    = log2(mean+1) difference; per gene the significant row wins, ties to
    the first position (R `arrange + distinct` semantics).
    """
    pos_of: Dict[Tuple[str, str], str] = {}
    for a in associations:
        key = (a.gene_name, a.genome_name)
        # dedup per (gene, genome, position): first association wins
        if key not in pos_of:
            pos_of[key] = a.position

    genes = sorted(expression.keys())
    groups: Dict[str, Dict[str, List[float]]] = {}
    for g in genes:
        by_pos: Dict[str, List[float]] = {}
        for genome_name, val in expression[g].items():
            if val is None or (isinstance(val, float) and math.isnan(val)):
                continue
            pos = pos_of.get((g, genome_name), "No_Insertion")
            by_pos.setdefault(pos, []).append(float(val))
        groups[g] = by_pos

    pvals = {pos: np.array([
        _welch_t_pvalue(np.array(groups[g].get(pos, [])),
                        np.array(groups[g].get("No_Insertion", [])))
        for g in genes]) for pos in POSITIONS}
    fdrs = {pos: bh_fdr(pvals[pos]) for pos in POSITIONS}

    out: List[DEGene] = []
    for gi, g in enumerate(genes):
        rows: List[DEGene] = []
        base = groups[g].get("No_Insertion", [])
        for pos in POSITIONS:
            vals = groups[g].get(pos, [])
            if not vals or not base:
                continue
            lfc = math.log2(float(np.mean(vals)) + 1) - \
                math.log2(float(np.mean(base)) + 1)
            fdr = float(fdrs[pos][gi])
            sig = (not math.isnan(fdr)) and abs(lfc) > lfc_threshold \
                and fdr < fdr_threshold
            rows.append(DEGene(g, pos, lfc, fdr, sig,
                               "up" if sig and lfc > 0 else
                               "down" if sig else "ns"))
        if rows:
            rows.sort(key=lambda r: not r.significant)
            out.append(rows[0])
    return out


def write_de_genes(out_dir: str, results: Sequence[DEGene],
                   plot: bool = True) -> None:
    """`DE_genes_from_TEs.tsv` + `all_gene_TEs_details.tsv` (+ volcano PDF,
    matching the reference stage's output set)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "all_gene_TEs_details.tsv"), "w") as fh:
        fh.write("Gene_name\tInsert_type\tfold_change\tP_adjust_value\t"
                 "significant\tdirect\n")
        for r in results:
            fh.write(f"{r.gene_name}\t{r.insert_type}\t{r.fold_change:.4f}\t"
                     f"{r.p_adjust:.6g}\t"
                     f"{'Significant' if r.significant else 'Not Significant'}"
                     f"\t{r.direction}\n")
    with open(os.path.join(out_dir, "DE_genes_from_TEs.tsv"), "w") as fh:
        fh.write("Gene_name\tInsert_type\tfold_change\tP_adjust_value\tdirect\n")
        for r in results:
            if r.significant:
                fh.write(f"{r.gene_name}\t{r.insert_type}\t"
                         f"{r.fold_change:.4f}\t{r.p_adjust:.6g}\t"
                         f"{r.direction}\n")
    if plot:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            xs = [r.fold_change for r in results if not math.isnan(r.p_adjust)
                  and r.p_adjust > 0]
            ys = [-math.log10(r.p_adjust) for r in results
                  if not math.isnan(r.p_adjust) and r.p_adjust > 0]
            cs = ["red" if r.significant and r.fold_change > 0 else
                  "blue" if r.significant else "grey"
                  for r in results if not math.isnan(r.p_adjust)
                  and r.p_adjust > 0]
            fig, ax = plt.subplots(figsize=(8, 6))
            ax.scatter(xs, ys, c=cs, s=12)
            ax.set_xlabel("log2 fold change")
            ax.set_ylabel("-log10 FDR")
            fig.savefig(os.path.join(out_dir, "DE_genes_from_TEs.pdf"))
            plt.close(fig)
        except Exception as e:  # plotting is best-effort, like the reference
            logger.warning("rnaseq: volcano plot skipped (%s)", e)


def expression_from_table(path: str) -> Dict[str, Dict[str, float]]:
    """Read a merged gene_express.table back as {gene: {sample: tpm}} —
    the last comma value per cell, like the R reader."""
    out: Dict[str, Dict[str, float]] = {}
    with open(path) as fh:
        header = fh.readline().rstrip("\n").split("\t")[1:]
        for line in fh:
            parts = line.rstrip("\n").split("\t")
            gene, cells = parts[0], parts[1:]
            row: Dict[str, float] = {}
            for s, c in zip(header, cells):
                last = c.split(",")[-1]
                if last != "NA":
                    row[s] = float(last)
            out[gene] = row
    return out
