"""Unified typed configuration (identical defaults to the JAX package's config).

The reference has three uncoordinated flag systems (argparse defaults in
`main.py:20-51`, Nextflow `params{}` in `nextflow.config:11-72`, and mutable
module-global config objects in NeuralTE/FiLTR) with diverging defaults
(SURVEY.md §5).  hite_tpu unifies everything into one frozen dataclass tree;
every pipeline stage and kernel takes (a slice of) this config explicitly.

Flag parity with reference `main.py:66-102` is kept where the concept
survives the redesign; process-management flags (thread counts, work dirs,
recovery toggles) are replaced by device-mesh and checkpoint settings.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

MB = 1_000_000


@dataclass(frozen=True)
class AlignConfig:
    """Seed-chain-extend alignment engine (replaces blastn/minimap2).

    `fixed_extend_base_threshold` mirrors the genome-size-adaptive gap
    tolerance of reference `main.py:328-329` -> `Util.py:14641-14654`.
    """

    kmer_size: int = 12                  # seed k-mer length (blastn -word_size 11-ish)
    seed_stride: int = 1                 # query seed sampling stride
    max_hits_per_kmer: int = 64          # cap on index occurrences per seed kmer
    band_width: int = 16                 # banded extension half-width
    x_drop: int = 40                     # extension termination score drop
    match_score: int = 1
    mismatch_score: int = -2
    min_hsp_len: int = 30                # minimum reported HSP length
    min_identity: float = 0.8            # minimum HSP identity
    # FMEA chaining (reference get_longest_repeats_v4, Util.py:4122-4400)
    skip_gap: int = 500                  # subject-gap HSP pre-clustering threshold
    fixed_extend_base_threshold: int = 4000  # chain gap tolerance (adaptive; see adapt_extend_threshold)
    max_chain_preds: int = 32            # chain DP predecessor window
    round_coord_bp: int = 10             # candidate dedup coordinate rounding (Util.py:4566)
    merge_overlap: float = 0.95          # merge candidates overlapping >= this (Util.py:4551)


def adapt_extend_threshold(genome_bp: int) -> int:
    """Genome-size-adaptive chain gap tolerance.

    Mirrors reference `Util.py:14641-14654`: 2000/2500/3000/4000 bp for
    <200MB / <400MB / <2GB / >=2GB genomes.
    """
    if genome_bp < 200 * MB:
        return 2000
    if genome_bp < 400 * MB:
        return 2500
    if genome_bp < 2000 * MB:
        return 3000
    return 4000


@dataclass(frozen=True)
class ChunkConfig:
    """Genome sharding geometry (reference split_genome_chunks.py:38-81)."""

    chunk_size_mb: int = 400             # data-parallel chunk size (MB)
    seg_length: int = 1 * MB             # chromosome segment length ("chr$offset")
    halo: int = 30_000                   # halo = max_repeat_len so boundary TEs aren't cut


@dataclass(frozen=True)
class TandemConfig:
    """Tandem-repeat detection (replaces TRF, reference Util.py:2876)."""

    max_period: int = 32                 # k-mer periodicity scan range
    min_copies: float = 2.0
    min_score: int = 50
    tandem_region_cutoff: float = 0.5    # candidate rejected if tandem fraction >= this


@dataclass(frozen=True)
class TerminalConfig:
    """Terminal repeat scanners (replaces itrsearch/ltrsearch, Util.py:216-231)."""

    itr_identity: float = 0.7            # itrsearch -i 0.7
    itr_min_len: int = 7                 # itrsearch -l 7
    ltr_identity: float = 0.85           # ltrsearch -i 0.85
    end_window: int = 40                 # bp scanned at each end for TIR candidates
    max_terminal_len: int = 100


@dataclass(frozen=True)
class TSDConfig:
    """Target-site-duplication search (reference TSDsearch_v1-v5, Util.py:2264-2533)."""

    sizes: Tuple[int, ...] = (2, 3, 4, 5, 6, 8, 9, 10, 11)
    search_radius: int = 50              # TSD searched within +-radius of raw boundary
    mismatch_min_len: int = 8            # >=8bp TSDs tolerate 1 mismatch (allow_mismatch:2281)
    top_k: int = 100                     # keep top candidates by boundary distance


@dataclass(frozen=True)
class MSAConfig:
    """Batched MSA + boundary adjudication (reference flank_region_align_v5, Util.py:8032)."""

    max_copies: int = 100                # MSA row cap (ready_for_MSA.sh 100 100)
    flanking_len: int = 50               # gate-stage context around candidates
    frame_flank: int = 100               # FiLTR both-ends frame width (.matrix files)
    # frames longer than 2x this are analyzed as head+tail concatenations
    # (the reference truncates >1kb copies to first/last 500bp before MSA,
    # Util.py:8116-8124; see boundary_adjust._prep).  The sparse-
    # column removal the reference applies before judging
    # (remove_sparse_col_in_align_file, Util.py:10344) has no equivalent
    # knob here: anchor-projection MSA never creates insertion columns.
    long_copy_trunc: int = 500
    # adaptive homology thresholds by row count (judge_boundary_v5 :9240-9245)
    homo_thresholds: Tuple[Tuple[int, float], ...] = ((5, 0.95), (10, 0.9), (0, 0.7))
    int_window: int = 20                 # internal homology window (cols)
    ext_window: int = 10                 # external homology window (cols)
    min_copy_tir: int = 5                # <=5 copies -> low-copy pool (TIR/non-LTR)
    min_copy_helitron: int = 2
    boundary_rounds: int = 3             # fixed-point iterations of boundary adjustment


@dataclass(frozen=True)
class LTRConfig:
    """LTR subsystem (replaces FiLTR/LtrDetector, SURVEY.md §3.4)."""

    min_ltr_len: int = 100
    max_ltr_len: int = 7000
    min_interior: int = 1000             # min distance between LTR pair
    max_interior: int = 15000            # max element interior span
    kmer_size: int = 13                  # distance-profile k
    min_pair_identity: float = 0.85
    chunk_mb: int = 10                   # FiLTR 10Mb chromosome split
    miu: float = 1.3e-8                  # neutral mutation rate (insertion time)
    deep_threshold: float = 0.5          # CNN accept prob (LTR_filter.py:155)
    # use_filtr=False selects the reference's legacy LTR path semantics
    # (--use_FiLTR 0, main.py:91: LTR_harvest/finder + LTR_retriever):
    # structural validation only (pair identity, TSD, TG...CA), skipping the
    # FiLTR both-ends frame judgement and CNN
    use_filtr: bool = True
    use_deep_cnn: bool = True            # CNN branch (rule always runs)
    deep_model_path: Optional[str] = None  # LTRFilterCNN params; None = bundled
    dedup_terminal_cov: float = 0.95     # deredundant_for_LTR_v5 thresholds
    dedup_internal_cov: float = 0.8


@dataclass(frozen=True)
class HelitronConfig:
    """Helitron scanner (replaces HelitronScanner LCV jar, SURVEY.md §2.C)."""

    head_tail_max_gap: int = 30_000      # pairends max span
    # thresholds on distinct-LCV-pattern hit counts (our per-site score is a
    # pattern-count, not HelitronScanner's weighted sum; one genuine terminus
    # typically matches 2-8 head / 1-4 tail patterns)
    min_score_head: int = 2
    min_score_tail: int = 1
    terminal_motifs_tail: Tuple[str, ...] = ("CTAGT", "CTAAT", "CTGGT", "CTGAT")
    head_motif: str = "ATC"
    # optional EAHelitron-style structure gate, unioned with the LCV gate
    # (reference judge_Helitron_transposons.py:39-54, default-disabled there;
    # invocation `EAHelitron -u 20000 -T "ATC" -r 3`, Util.py:143)
    use_eahelitron: bool = False
    ea_upstream: int = 20_000
    ea_fuzzy_level: int = 3


@dataclass(frozen=True)
class NonLTRConfig:
    """De-novo non-LTR gates (reference Util.py:11018-11025, 10915-11006)."""

    sine_min: int = 100
    sine_max: int = 700
    line_min: int = 700
    line_max: int = 8000
    tail_min_a: int = 6                  # min polyA tail length
    tsd_min: int = 8
    tsd_max: int = 20
    min_tsd_votes: int = 5


@dataclass(frozen=True)
class LibraryConfig:
    """Library assembly / clustering (reference get_nonRedundant_lib.py)."""

    cluster_identity: float = 0.8        # cd-hit-est -c 0.8
    cluster_cov_short: float = 0.95      # -aS 0.95
    cluster_cov_long: float = 0.95       # -aL 0.95
    nested_identity: float = 0.95        # remove_nested_lib thresholds
    nested_coverage: float = 0.95
    full_length_cov: float = 0.95        # full-length copy definition
    min_te_len: int = 80
    max_te_len: int = 30_000


@dataclass(frozen=True)
class ClassifyConfig:
    """TE classification (NeuralTE-equivalent, SURVEY.md §2.D)."""

    use_neural: bool = True
    use_tsd_feature: bool = True
    is_wicker: bool = False              # Wicker vs RepeatMasker label vocabulary
    model_path: Optional[str] = None     # trained SuperfamilyCNN params (pickle)
    internal_kmers: Tuple[int, ...] = (5,)
    terminal_kmers: Tuple[int, ...] = (3, 4)
    num_classes: int = 28                # Wicker superfamilies
    domain_evalue: float = 1e-20


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh geometry for scale-out (replaces Nextflow executors)."""

    data_axis: str = "dp"                # genome chunks
    seq_axis: str = "sp"                 # intra-chunk sequence blocks
    model_axis: str = "tp"               # classifier tensor parallel
    dp: int = 1
    sp: int = 1
    tp: int = 1


@dataclass(frozen=True)
class PipelineConfig:
    """Top-level run configuration (reference main.py flag surface)."""

    genome: str = ""
    out_dir: str = "."
    te_type: str = "all"                 # ltr|tir|helitron|non-ltr|all
    plant: bool = True
    is_denovo_nonltr: bool = True
    remove_nested: bool = True
    annotate: bool = False
    domain: bool = False
    curated_lib: Optional[str] = None
    is_output_ltr_lib: bool = True
    coverage_threshold: float = 0.95     # benchmark coverage
    bm_hite: bool = False                # run BM_HiTE base-level evaluation
    bm_rm2: bool = False                 # run BM_RM2 family-level evaluation
    bm_edta: bool = False                # run BM_EDTA confusion-matrix eval
    species_lib: Optional[str] = None    # curated benchmark library path
    debug: bool = False
    recover: bool = False                # resume from stage checkpoints
    seed: int = 0
    # stage 0: drop contigs >=95% covered by a longer contig before any
    # discovery (reference genome_clean.py, invoked at main.py:435-441)
    clean_genome: bool = True

    align: AlignConfig = field(default_factory=AlignConfig)
    chunk: ChunkConfig = field(default_factory=ChunkConfig)
    tandem: TandemConfig = field(default_factory=TandemConfig)
    terminal: TerminalConfig = field(default_factory=TerminalConfig)
    tsd: TSDConfig = field(default_factory=TSDConfig)
    msa: MSAConfig = field(default_factory=MSAConfig)
    ltr: LTRConfig = field(default_factory=LTRConfig)
    helitron: HelitronConfig = field(default_factory=HelitronConfig)
    non_ltr: NonLTRConfig = field(default_factory=NonLTRConfig)
    library: LibraryConfig = field(default_factory=LibraryConfig)
    classify: ClassifyConfig = field(default_factory=ClassifyConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def with_genome_size(self, genome_bp: int) -> "PipelineConfig":
        """Return a config with the genome-size-adaptive chain gap threshold set."""
        align = dataclasses.replace(
            self.align, fixed_extend_base_threshold=adapt_extend_threshold(genome_bp)
        )
        return dataclasses.replace(self, align=align)

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


DEFAULT = PipelineConfig()
