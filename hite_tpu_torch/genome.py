"""Genome container: flat host code array + contig maps + device buffers.

Same layout as the JAX package's `genome.py`: ONE flat uint8 code array
(contigs joined by an N spacer so no alignment bridges contigs, N-padded
to a multiple of `pad_to`), explicit contig tables, and a masked copy.
The genome carries its torch device; device buffers (the N-padded flat
upload, the sorted join stream) are cached under the JAX package's keys
and dropped by `mask_intervals` when they derive from the masked copy.
Genomes over 512 Mbp (the JAX package's 2-bit `PackedFlat` tier) are not
handled by this port yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from hite_tpu_torch.device import resolve_device
from hite_tpu_torch.io.fasta import CODE_N, decode_seq, encode_seq, read_fasta

# Spacer between contigs: longer than any seed/extension reach so
# alignments can never bridge two contigs (N never matches).
CONTIG_SPACER = 64


@dataclass
class Genome:
    """Flat-coded genome with contig maps (see module doc)."""

    flat: np.ndarray
    names: List[str]
    starts: np.ndarray          # int64 [n_contigs]
    lengths: np.ndarray         # int64 [n_contigs]
    masked: Optional[np.ndarray] = None  # flat copy, masked spans set to N
    device: torch.device = field(default_factory=lambda: torch.device("cpu"),
                                 compare=False)
    _device_cache: Dict = field(default_factory=dict, repr=False, compare=False)

    # ------------------------------------------------------------------ build
    @classmethod
    def from_dict(cls, seqs: Dict[str, np.ndarray], pad_to: int = 1024,
                  device: Optional[Union[str, torch.device]] = None
                  ) -> "Genome":
        dev = resolve_device(device)
        names = list(seqs.keys())
        lengths = np.array([len(seqs[n]) for n in names], dtype=np.int64)
        starts = np.zeros(len(names), dtype=np.int64)
        pos = 0
        for i, n in enumerate(names):
            starts[i] = pos
            pos += lengths[i] + CONTIG_SPACER
        total = ((pos + pad_to - 1) // pad_to) * pad_to if pos else pad_to
        flat = np.full(total, CODE_N, dtype=np.uint8)
        for i, n in enumerate(names):
            flat[starts[i] : starts[i] + lengths[i]] = seqs[n]
        return cls(flat=flat, names=names, starts=starts, lengths=lengths,
                   device=dev)

    @classmethod
    def from_fasta(cls, path: str, pad_to: int = 1024,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> "Genome":
        return cls.from_dict(read_fasta(path), pad_to=pad_to, device=device)

    # ------------------------------------------------------------ coordinates
    @property
    def size(self) -> int:
        """Total genomic bp (excluding spacers/padding)."""
        return int(self.lengths.sum())

    def contig_of(self, flat_pos: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """flat position(s) -> (contig index, contig-local position)."""
        flat_pos = np.asarray(flat_pos)
        idx = np.searchsorted(self.starts, flat_pos, side="right") - 1
        idx = np.clip(idx, 0, len(self.names) - 1)
        return idx, flat_pos - self.starts[idx]

    def to_flat(self, name: str, pos: int) -> int:
        return int(self.starts[self.names.index(name)]) + pos

    def in_contig(self, start: np.ndarray, end: np.ndarray) -> np.ndarray:
        """True where [start, end) lies inside a single contig (no spacer)."""
        start = np.asarray(start)
        end = np.asarray(end)
        ci, local = self.contig_of(start)
        return ((local >= 0) & (end - start >= 0)
                & (local + (end - start) <= self.lengths[ci]))

    # --------------------------------------------------------------- segments
    def n_segments(self, seg_length: int) -> int:
        return (len(self.flat) + seg_length - 1) // seg_length

    def segment_batches(self, seg_length: int, batch: int,
                        use_masked: bool = False):
        """Yield (seg0, [batch, seg_length]) host chunks; the final batch
        is N-padded to full size."""
        src = (self.masked if (use_masked and self.masked is not None)
               else self.flat)
        n_segs = self.n_segments(seg_length)
        for b0 in range(0, n_segs, batch):
            nb = min(batch, n_segs - b0)
            s = b0 * seg_length
            e = min((b0 + nb) * seg_length, len(src))
            chunk = np.asarray(src[s:e])
            want = batch * seg_length
            if len(chunk) < want:
                chunk = np.concatenate(
                    [chunk, np.full(want - len(chunk), CODE_N, np.uint8)])
            yield b0, chunk.reshape(batch, seg_length)

    # ---------------------------------------------------------------- masking
    def init_mask(self) -> None:
        if self.masked is None:
            self.masked = self.flat.copy()

    def mask_intervals(self, intervals: Iterable[Tuple[int, int]]) -> int:
        """N-out flat-coordinate [start, end) spans in the masked copy;
        returns bp masked and drops every device buffer derived from the
        masked stream (unmasked variants stay)."""
        self.init_mask()
        total = 0
        for s, e in intervals:
            s = max(0, int(s))
            e = min(len(self.masked), int(e))
            if e > s:
                self.masked[s:e] = CODE_N
                total += e - s
        if total:
            for key in [k for k in self._device_cache
                        if len(k) > 1 and k[1] is True]:
                self._device_cache.pop(key, None)
        return total

    def device_flat_padded(self, use_masked: bool = False
                           ) -> Tuple[torch.Tensor, int]:
        """Device-resident flat codes, N-padded to a power of two (at least
        65,536), cached per source.  Returns (uint8 [Lp] tensor, true L)."""
        src = (self.masked if (use_masked and self.masked is not None)
               else self.flat)
        key = ("flat_pow2", src is self.masked)
        L = len(src)
        ent = self._device_cache.get(key)
        if ent is None:
            Lp = max(65_536, 1 << (L - 1).bit_length())
            buf = np.full(Lp, CODE_N, dtype=np.uint8)
            buf[:L] = src
            ent = torch.from_numpy(buf).to(self.device)
            self._device_cache[key] = ent
        return ent, L

    def to_dict(self) -> Dict[str, np.ndarray]:
        """Per-contig code arrays (views into flat), keyed by contig name."""
        return {n: self.flat[self.starts[i] : self.starts[i] + self.lengths[i]]
                for i, n in enumerate(self.names)}

    # ------------------------------------------------------------- extraction
    def extract(self, start: int, end: int, flank: int = 0) -> np.ndarray:
        """Codes for flat [start-flank, end+flank), clipped to the contig."""
        ci, local = self.contig_of(np.array([start]))
        ci = int(ci[0])
        c_start = int(self.starts[ci])
        c_end = c_start + int(self.lengths[ci])
        s = max(c_start, int(start) - flank)
        e = min(c_end, int(end) + flank)
        return self.flat[s:e]

    def extract_str(self, start: int, end: int, flank: int = 0) -> str:
        return decode_seq(self.extract(start, end, flank))

    def location_str(self, start: int, end: int, strand: str = "+") -> str:
        """Reference-style copy name ``chr:start-end(strand)``."""
        ci, local = self.contig_of(np.array([start]))
        ci = int(ci[0])
        return (f"{self.names[ci]}:{int(local[0])}-"
                f"{int(local[0]) + (end - start)}({strand})")


def synthetic_genome(
    length: int,
    te_seqs: Sequence[str],
    n_copies: Sequence[int],
    seed: int = 0,
    mutation_rate: float = 0.02,
    tsd_lens: Optional[Sequence[int]] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[Genome, List[Tuple[int, int, int]]]:
    """Random genome with planted, lightly mutated TE copies (test
    substrate; the same numpy draws as the JAX package's version).
    Returns (genome, [(te_index, start, end)] of every planted copy)."""
    rng = np.random.default_rng(seed)
    bg = rng.integers(0, 4, size=length).astype(np.uint8)
    insertions: List[Tuple[int, int, int]] = []
    placed: List[Tuple[int, int]] = []
    for ti, te in enumerate(te_seqs):
        te_codes = encode_seq(te)
        for _ in range(n_copies[ti]):
            for _attempt in range(100):
                pos = int(rng.integers(500, length - len(te_codes) - 500))
                if all(pos + len(te_codes) < s or pos > e for s, e in placed):
                    break
            copy = te_codes.copy()
            muts = rng.random(len(copy)) < mutation_rate
            copy[muts] = (copy[muts] + rng.integers(1, 4, size=muts.sum())) % 4
            if tsd_lens:
                tlen = int(tsd_lens[ti % len(tsd_lens)])
                tsd = rng.integers(0, 4, size=tlen).astype(np.uint8)
                bg[pos - tlen : pos] = tsd
                bg[pos + len(copy) : pos + len(copy) + tlen] = tsd
            bg[pos : pos + len(copy)] = copy
            placed.append((pos, pos + len(copy)))
            insertions.append((ti, pos, pos + len(copy)))
    genome = Genome.from_dict({"chr1": bg}, device=device)
    return genome, insertions
