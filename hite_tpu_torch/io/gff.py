"""GFF / RepeatMasker-style .out / .tbl writers (a copy of the JAX
package's `io/gff.py`, so both write byte-equal files).

Output-format parity with the reference's annotation stage
(`pan_annotate_genome.py:27-80`): `{name}.gff` (RepeatMasker gff3-ish),
`{name}.out` (RM .out columns), `{name}.tbl` (summary table) and
`*.full_length.gff` (copies >= 95% of consensus length,
`get_full_length_copies_from_gff_v1` `Util.py:13679-13753`).  The default
`source` column stays "hite_tpu", the JAX package's.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterable, List


@dataclass
class AnnotationHit:
    """One library-vs-genome hit in contig-local 1-based coordinates."""

    contig: str
    start: int               # 1-based inclusive
    end: int                 # inclusive
    strand: str              # '+'/'-'
    family: str              # library entry name
    te_class: str            # e.g. DNA/hAT
    identity: float
    full_length: bool = False


def write_gff(path: str, hits: Iterable[AnnotationHit],
              source: str = "hite_tpu") -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        fh.write("##gff-version 3\n")
        for i, h in enumerate(hits):
            attrs = (f"ID=TE_{i};Name={h.family};Classification={h.te_class};"
                     f"Identity={h.identity:.3f}")
            fh.write("\t".join([
                h.contig, source, "dispersed_repeat",
                str(h.start), str(h.end), f"{h.identity:.3f}",
                h.strand, ".", attrs,
            ]) + "\n")


def write_rm_out(path: str, hits: Iterable[AnnotationHit]) -> None:
    """RepeatMasker .out-style table (the columns downstream tools parse)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        fh.write("   SW  perc perc perc  query      position in query"
                 "     matching       repeat              position in  repeat\n")
        fh.write("score  div. del. ins.  sequence    begin     end    (left)"
                 "    repeat         class/family         begin  end (left)   ID\n\n")
        for i, h in enumerate(hits):
            div = (1.0 - h.identity) * 100
            fh.write(f"{1000:>5} {div:5.1f}  0.0  0.0  {h.contig:<10} "
                     f"{h.start:>8} {h.end:>8} (0) "
                     f"{'+' if h.strand == '+' else 'C'} {h.family:<14} "
                     f"{h.te_class:<20} 1 {h.end - h.start + 1} (0) {i}\n")


def write_tbl(path: str, hits: List[AnnotationHit], genome_bp: int) -> None:
    """Summary table: bp + % of genome masked per class."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    by_class = {}
    for h in hits:
        top = h.te_class.split("/")[0]
        by_class.setdefault(top, 0)
        by_class[top] += h.end - h.start + 1
    total = sum(by_class.values())
    with open(path, "w") as fh:
        fh.write(f"total length: {genome_bp} bp\n")
        fh.write(f"bases masked: {total} bp "
                 f"({100*total/max(genome_bp,1):.2f} %)\n\n")
        fh.write(f"{'class':<12}{'bp':>12}{'%genome':>10}\n")
        for cls, bp in sorted(by_class.items()):
            fh.write(f"{cls:<12}{bp:>12}{100*bp/max(genome_bp,1):>10.2f}\n")


def write_full_length_gff(path: str, hits: Iterable[AnnotationHit]) -> None:
    write_gff(path, [h for h in hits if h.full_length])
