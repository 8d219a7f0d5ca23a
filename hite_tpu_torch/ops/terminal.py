"""Terminal repeat scanners: batched Smith-Waterman local alignment.

Counterpart of the JAX package's `ops/terminal.py` (replacing the
reference's `itrsearch` / `ltrsearch`): a local alignment between the two
end windows of each candidate (one reverse-complemented for TIRs), batched
over [B] candidates, carrying each cell's alignment start, match count and
length so identity and length gates need no traceback.

`batched_local_align_auto` is the kernel wrapper: a CPU tensor goes to the
plain version `batched_local_align` (an anti-diagonal loop over whole
tensors, the oracle), a CUDA tensor to the hand-written kernel
`csrc/sw.cu`, or the call raises.  With `submatrix` (protein mode: the
domain engine's BLOSUM62) the kernel scores from a table in shared memory
and counts its launches as "sw_protein".
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from hite_tpu_torch import kernels
from hite_tpu_torch.ops.encode import revcomp

NEG = -(10**9)


class LocalAlign(NamedTuple):
    """Best local alignment per batch element (0-based, half-open)."""

    score: torch.Tensor    # int32 [B]
    qs: torch.Tensor       # start in a
    qe: torch.Tensor       # end in a
    ss: torch.Tensor       # start in b
    se: torch.Tensor       # end in b
    matches: torch.Tensor  # matched bases
    alen: torch.Tensor     # alignment length (cells)


def batched_local_align(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    match: int = 2,
    mismatch: int = -3,
    gap: int = 4,
    submatrix: Optional[torch.Tensor] = None,
    invalid_code: int = 4,
) -> LocalAlign:
    """Plain Smith-Waterman between a[B, La] and b[B, Lb] code arrays.

    Nucleotide scoring (match/mismatch; code >= `invalid_code` never
    matches), or scores from `submatrix` (int32 [A, A]) in protein mode.
    """
    return _local_align_core(a, b, match=match, mismatch=mismatch, gap=gap,
                             submatrix=submatrix, invalid_code=invalid_code)


def _shift_right(p: torch.Tensor) -> torch.Tensor:
    """plane[i] -> plane[i-1] (row i reads predecessor row i-1); row 0 <- 0."""
    return torch.nn.functional.pad(p[:, :-1], (1, 0))


def _local_align_core(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    match: int = 2,
    mismatch: int = -3,
    gap: int = 4,
    submatrix: Optional[torch.Tensor] = None,
    invalid_code: int = 4,
) -> LocalAlign:
    """Anti-diagonal wavefront on [B, La+1] planes indexed by DP row i.

    Cell recurrence h = max(0, diag + sub, up - gap, left - gap); the
    choice is the FIRST argmax of [fresh, diag, up, left].  Each row keeps
    a running best (strict `>` as j rises); the answer is the first row
    with the largest best."""
    B, La = a.shape
    Lb = b.shape[1]
    dev = a.device
    i32 = torch.int32
    a32 = a.to(i32)
    b32 = b.to(i32)
    inv = invalid_code

    i_arr = torch.arange(La + 1, dtype=i32, device=dev).expand(B, La + 1)
    a_sym = torch.cat([torch.full((B, 1), inv, dtype=i32, device=dev), a32], 1)
    b_padded = torch.cat(
        [b32, torch.full((B, La + 2), inv, dtype=i32, device=dev)], 1)

    def plane(fill=0):
        return torch.full((B, La + 1), fill, dtype=i32, device=dev)

    # planes of diagonals k-1 (k=1) and k-2 (k=0); zero-score cells store
    # their own (i, j) as the start a successor alignment begins from
    h1, si1, sj1, m1, l1 = (plane(), i_arr.clone(), (1 - i_arr).clamp(min=0),
                            plane(), plane())
    h2, si2, sj2, m2, l2 = (plane(), i_arr.clone(), (0 - i_arr).clamp(min=0),
                            plane(), plane())
    # rolling b-symbol buffer: at diagonal k, br[i] == b[k-1-i]
    br = torch.cat([b_padded[:, :1],
                    torch.full((B, La), inv, dtype=i32, device=dev)], 1)
    bh = plane(NEG)
    bsi, bsj, bm, bl, bej = plane(), plane(), plane(), plane(), plane()
    zero = plane()
    W = b_padded.shape[1]

    for k in range(2, La + Lb + 1):
        j_arr = k - i_arr
        valid = (i_arr >= 1) & (j_arr >= 1) & (j_arr <= Lb)
        new_b = b_padded[:, min(max(k - 1, 0), W - 1)].unsqueeze(1)
        br = torch.cat([new_b, br[:, :-1]], 1)

        ok = (a_sym < inv) & (br < inv)
        is_match = (a_sym == br) & ok
        if submatrix is not None:
            A0, A1 = submatrix.shape
            sub = submatrix[a_sym.clamp(0, A0 - 1).long(),
                            br.clamp(0, A1 - 1).long()].to(i32)
            sub = torch.where(ok, sub, mismatch)
        else:
            sub = torch.where(is_match, match, mismatch).to(i32)

        c_diag = _shift_right(h2) + sub
        c_up = _shift_right(h1) - gap
        c_left = h1 - gap
        hmax = torch.maximum(torch.maximum(c_diag.clamp(min=0), c_up), c_left)
        # first argmax of [fresh(0), diag, up, left]
        take_fresh = hmax == 0
        take_diag = ~take_fresh & (c_diag == hmax)
        take_up = ~take_fresh & ~take_diag & (c_up == hmax)

        def pick(fresh, diag, up, left):
            return torch.where(take_fresh, fresh,
                   torch.where(take_diag, diag,
                   torch.where(take_up, up, left)))

        si = pick(i_arr, _shift_right(si2), _shift_right(si1), si1)
        sj = pick(j_arr, _shift_right(sj2), _shift_right(sj1), sj1)
        m = pick(zero, _shift_right(m2) + is_match.to(i32),
                 _shift_right(m1), m1)
        ln = pick(zero, _shift_right(l2) + 1, _shift_right(l1) + 1, l1 + 1)
        h = torch.where(valid, hmax, 0)

        masked_h = torch.where(valid, h, NEG)
        upd = masked_h > bh
        bh = torch.where(upd, masked_h, bh)
        bsi = torch.where(upd, si, bsi)
        bsj = torch.where(upd, sj, bsj)
        bm = torch.where(upd, m, bm)
        bl = torch.where(upd, ln, bl)
        bej = torch.where(upd, j_arr, bej)

        h2, si2, sj2, m2, l2 = h1, si1, sj1, m1, l1
        h1, si1, sj1, m1, l1 = h, si, sj, m, ln

    row_best = torch.argmax(bh, dim=1, keepdim=True)

    def g(p):
        return torch.gather(p, 1, row_best)[:, 0]

    return LocalAlign(
        score=g(bh).clamp(min=0), qs=g(bsi), qe=row_best[:, 0].to(i32),
        ss=g(bsj), se=g(bej), matches=g(bm), alen=g(bl))


def _check_inputs(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"expected a[B, La], b[B, Lb]; got {tuple(a.shape)}"
                         f" and {tuple(b.shape)}")
    if a.dtype != torch.uint8 or b.dtype != torch.uint8:
        raise TypeError(f"expected uint8 codes; got {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")


class SwPlan(NamedTuple):
    """How `csrc/sw.cu` covers a [B, La] x [B, Lb] launch."""

    R: int        # DP rows a lane
    G: int        # lanes a group (one band of one alignment)
    nb: int       # bands an alignment (nb > 1: G == 32, one warp a band)
    packed: bool  # (si, sj) and (m, d) as 16-bit halves of one word


SW_ROWS = (4, 8)   # the R the kernel is instantiated for


def sw_packs(La: int, Lb: int) -> bool:
    """The 16-bit packed fields hold every start, row, column and count:
    si, i and the matches and diagonal moves are at most La, sj and j at
    most Lb (the kernel carries diagonal moves, not the length)."""
    return La < 65536 and Lb < 65536


def sw_groups(R: int, La: int) -> Tuple[int, int]:
    """(G, nb): lanes a group and bands an alignment at R rows a lane."""
    lanes = -(-max(La, 1) // R)
    if lanes <= 32:
        return lanes, 1
    return 32, -(-La // (32 * R))


def sw_rows(La: int) -> int:
    """R = 4 while an alignment fits one warp at 4 rows a lane (lane
    groups: fewer rows a lane step sooner; the TIR gate's 40 x 40 at
    batches of 16 to 4096), else R = 8, the cheaper cell (the banded
    widths of LTR, to 8192, and annotation, to 4096).  Each is the faster
    R at those shapes on the H100 (PERF.md)."""
    return 4 if La <= 32 * 4 else 8


@functools.lru_cache(maxsize=1024)
def sw_plan(La: int, Lb: int, *, R: Optional[int] = None,
            packed: Optional[bool] = None) -> SwPlan:
    """The launch plan of an [*, La] x [*, Lb] batch: R by `sw_rows` unless given, and the packed
    variant unless a width overflows its 16-bit fields (then the unpacked
    one, never the plain version)."""
    fits = sw_packs(La, Lb)
    if packed is None:
        packed = fits
    elif packed and not fits:
        raise ValueError(f"La={La}, Lb={Lb} overflow the packed fields")
    if R is None:
        R = sw_rows(La)
    elif R not in SW_ROWS:
        raise ValueError(f"R must be one of {SW_ROWS}, got {R}")
    return SwPlan(R, *sw_groups(R, La), packed)


@functools.lru_cache(maxsize=None)
def _sw_lib() -> ctypes.CDLL:
    """The loaded `csrc/sw.cu` library with its argtypes, resolved once."""
    lib = kernels.load("sw")
    lib.sw_launch.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 11
                              + [ctypes.c_void_p] * 5)
    lib.sw_launch.restype = ctypes.c_int
    lib.sw_scratch_bytes.argtypes = [ctypes.c_int] * 4
    lib.sw_scratch_bytes.restype = ctypes.c_longlong
    lib.sw_sync_ints.argtypes = [ctypes.c_int] * 2
    lib.sw_sync_ints.restype = ctypes.c_longlong
    lib.sw_error_string.argtypes = [ctypes.c_int]
    lib.sw_error_string.restype = ctypes.c_char_p
    return lib


SW_TABLE_WIDTH = 32   # codes of the kernel's protein table (csrc/sw.cu)
SW_TABLE_INV = 30     # the largest invalid code a table launch takes


def _table_array(submatrix) -> np.ndarray:
    return np.asarray(submatrix.cpu() if isinstance(submatrix, torch.Tensor)
                      else submatrix).astype(np.int64)


def sw_table(submatrix, mismatch: int, invalid_code: int) -> np.ndarray:
    """The kernel's 32 x 32 int32 protein table: `submatrix[x, y]` (codes
    clamped to its shape, as the plain version indexes it) for codes x, y
    below `invalid_code`, `mismatch` everywhere else, so the kernel's
    recoded invalid codes (30 for a, 31 for b) score a mismatch.  Raises
    for a table wider than 32 codes."""
    sub = _table_array(submatrix)
    if sub.ndim != 2 or max(sub.shape) > SW_TABLE_WIDTH:
        raise ValueError(f"the SW kernel takes a table of at most "
                         f"{SW_TABLE_WIDTH} x {SW_TABLE_WIDTH} codes, got "
                         f"{sub.shape}")
    if not 0 <= invalid_code <= SW_TABLE_INV:
        raise ValueError(f"invalid_code {invalid_code} out of the table's "
                         f"range 0..{SW_TABLE_INV}")
    tab = np.full((SW_TABLE_WIDTH, SW_TABLE_WIDTH), mismatch, np.int32)
    codes = np.arange(invalid_code)
    tab[:invalid_code, :invalid_code] = sub[
        np.minimum(codes, sub.shape[0] - 1)[:, None],
        np.minimum(codes, sub.shape[1] - 1)[None, :]]
    return tab


_TABLES: Dict[tuple, torch.Tensor] = {}


def _device_table(submatrix, mismatch: int, invalid_code: int,
                  device: torch.device) -> torch.Tensor:
    """`sw_table` on `device`, uploaded once per table."""
    sub = _table_array(submatrix)
    key = (sub.shape, sub.tobytes(), mismatch, invalid_code, str(device))
    tab = _TABLES.get(key)
    if tab is None:
        tab = torch.from_numpy(sw_table(sub, mismatch, invalid_code))
        tab = _TABLES[key] = tab.to(device)
    return tab


def _sw_cuda(a: torch.Tensor, b: torch.Tensor, *, match: int,
             mismatch: int, gap: int, invalid_code: int,
             R: Optional[int] = None, packed: Optional[bool] = None,
             submatrix=None) -> LocalAlign:
    """Launch `csrc/sw.cu` on the current stream (no synchronise).  `R`
    and `packed` force a variant (chip_smoke.py holds each against the
    plain version); by default `sw_plan` chooses.  `submatrix` selects
    protein mode, which has packed fields only."""
    B, La = a.shape
    Lb = b.shape[1]
    dev = a.device
    table = None
    if submatrix is not None:
        if packed is False or not sw_packs(La, Lb):
            raise ValueError("protein mode has packed fields only (widths "
                             f"below 65536), got La={La}, Lb={Lb}, "
                             f"packed={packed}")
        table = _device_table(submatrix, mismatch, invalid_code, dev)
    out = torch.empty((7, B), dtype=torch.int32, device=dev)
    if B == 0:
        return LocalAlign(*out.unbind(0))
    lib = _sw_lib()
    plan = sw_plan(La, Lb, R=R, packed=packed)
    sync = scratch = None
    if plan.nb > 1:
        sync = torch.zeros(lib.sw_sync_ints(B, plan.nb), dtype=torch.int32,
                           device=dev)
        scratch = torch.empty(
            lib.sw_scratch_bytes(B, Lb, plan.nb, plan.packed),
            dtype=torch.uint8, device=dev)
    args = (a.data_ptr(), b.data_ptr(), B, La, Lb, match, mismatch, gap,
            invalid_code, plan.R, plan.G, plan.nb, int(plan.packed),
            out.data_ptr(), None if sync is None else sync.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            None if table is None else table.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        rc = lib.sw_launch(*args)
    if rc != 0:
        raise RuntimeError(f"sw kernel launch failed ({plan}): "
                           + lib.sw_error_string(rc).decode())
    kernels.count_launch("sw" if table is None else "sw_protein",
                         (B, La, Lb))
    return LocalAlign(*out.unbind(0))


def batched_local_align_auto(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    match: int = 2,
    mismatch: int = -3,
    gap: int = 4,
    invalid_code: int = 4,
    submatrix: Optional[Union[torch.Tensor, np.ndarray]] = None,
) -> LocalAlign:
    """SW: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors; anything else raises.  Any La, Lb and B (the JAX package fell
    back to XLA past La = 16000; the kernel has no limit), below 65536 in
    protein mode (`submatrix`, a table of at most 32 x 32 codes: wider
    raises on every device)."""
    _check_inputs(a, b)
    kw = dict(match=match, mismatch=mismatch, gap=gap,
              invalid_code=invalid_code)
    if submatrix is not None:
        sw_table(submatrix, mismatch, invalid_code)   # raises if too wide
    if a.device.type == "cpu":
        if submatrix is not None:
            submatrix = torch.from_numpy(_table_array(submatrix))
        return batched_local_align(a, b, submatrix=submatrix, **kw)
    if a.device.type != "cuda":
        raise ValueError(f"no SW kernel for device {a.device}")
    return _sw_cuda(a, b, submatrix=submatrix, **kw)


class TerminalRepeat(NamedTuple):
    """Per-candidate terminal repeat call (candidate-local coordinates)."""

    found: torch.Tensor
    left_start: torch.Tensor
    left_end: torch.Tensor
    right_start: torch.Tensor
    right_end: torch.Tensor
    identity: torch.Tensor
    length: torch.Tensor


def _end_windows(seqs: torch.Tensor, lens: torch.Tensor, window: int):
    """Extract 5' and 3' windows from padded [B, L] candidates."""
    B, L = seqs.shape
    left = seqs[:, :window]
    offs = torch.arange(window, dtype=torch.int32, device=seqs.device)
    ridx = lens.to(torch.int32)[:, None] - window + offs[None, :]
    right = torch.where(
        ridx >= 0,
        torch.gather(seqs, 1, ridx.clamp(0, L - 1).long()),
        torch.tensor(4, dtype=seqs.dtype, device=seqs.device),
    ).to(seqs.dtype)
    return left, right, ridx[:, 0].clamp(min=0)


def find_terminal_repeat(
    seqs: torch.Tensor,
    lens: torch.Tensor,
    *,
    inverted: bool,
    window: int = 40,
    min_identity: float = 0.7,
    min_len: int = 7,
) -> TerminalRepeat:
    """Best terminal (inverted or direct) repeat of each candidate.

    inverted=True  -> TIR scan (itrsearch -i 0.7 -l 7 semantics)
    inverted=False -> LTR pair scan (ltrsearch semantics)
    """
    left, right, right_off = _end_windows(seqs, lens, window)
    b = revcomp(right) if inverted else right
    al = batched_local_align_auto(left.contiguous(), b.contiguous())

    identity = al.matches / al.alen.clamp(min=1)
    length = torch.minimum(al.qe - al.qs, al.se - al.ss)
    found = (identity >= min_identity) & (length >= min_len) & (al.score > 0)
    if inverted:
        # b is revcomp(right window): position p in b covers right-window
        # position window - p (half-open flip)
        r_start = right_off + (window - al.se)
        r_end = right_off + (window - al.ss)
    else:
        r_start = right_off + al.ss
        r_end = right_off + al.se
    return TerminalRepeat(found=found, left_start=al.qs, left_end=al.qe,
                          right_start=r_start, right_end=r_end,
                          identity=identity, length=length)
