"""Library-vs-genome k-mer sort-merge join (JAX `ops/libjoin.py`).

Copy retrieval as ONE global join per call:
1. genome k-mers (forward + reverse complement at virtual offset L) and
   candidate k-mers (candidates concatenated, one N separator) share one
   code-sorted stream, candidate entries first within each run;
2. every genome entry pairs with its run's last `fill_w` candidate entries
   (`libjoin_pairs`: forward fills within each slice, `csrc/libjoin.cu`'s
   kernel on the card and chained cummax fills in the plain version
   `libjoin_fill_plain`; `libjoin_pairs_indexed`:
   a `searchsorted` into the separately sorted candidate k-mers against a
   genome stream sorted once per genome by `libjoin_genome_sorted`); runs
   past `max_occ` genome occurrences stop pairing;
3. pairs sorted by (cand, diag band, qpos, spos) become HSPs in a
   candidate-grouped run scan (`libjoin_scan_packed`).

The fills and compactions run over [K, S] slices of the stream with the
JAX package's per-slice quotas, so the emitted pairs and the counts that
drive the caller's quota retries are identical.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from hite_tpu_torch import kernels
from hite_tpu_torch.ops.encode import kmer_codes
from hite_tpu_torch.ops.selfjoin import (
    INT32_MAX, compact, pack2, shift1, slices, stable_order, two_strand_codes,
)
from hite_tpu_torch.utils.log import count

FILL_MAX_W = 8       # fills the libjoin_fill kernel takes (csrc/libjoin.cu)


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, (int(n) - 1)).bit_length() if n > 1 else 1


def _quotas(slice_quota: int, fill_w: int, S: int):
    q = min(slice_quota, fill_w * S)
    if fill_w == 1:
        return [q]
    q0 = q // 2
    qw = max(1, (q - q0) // (fill_w - 1))
    return [q0] + [qw] * (fill_w - 1)


def _emit(ok, q, cand_j, qpos_j, spos):
    """One fill's compacted (cand, qpos, spos) columns [K, q] + counts."""
    cw = ok.sum(1, dtype=torch.int32)
    sel = compact(ok, q, 0)
    keep = torch.arange(q, device=ok.device)[None] < cw[:, None]
    out = (torch.where(keep, torch.gather(cand_j, 1, sel), INT32_MAX),
           torch.where(keep, torch.gather(qpos_j, 1, sel), INT32_MAX),
           torch.where(keep, torch.gather(spos, 1, sel), 0))
    return out, cw, torch.clamp(cw, max=q)


def _finish(parts, counts, emits, diag_band):
    """Concatenate fills per slice, flatten slices, 4-key sort."""
    p_cand = torch.cat([p[0] for p in parts], 1).reshape(-1)
    p_qpos = torch.cat([p[1] for p in parts], 1).reshape(-1)
    p_spos = torch.cat([p[2] for p in parts], 1).reshape(-1)
    n_total = torch.stack(counts).sum(dtype=torch.int32)
    n_emit = torch.stack(emits).sum(dtype=torch.int32)
    valid = p_cand != INT32_MAX
    dbin = torch.where(valid, torch.div(p_spos - p_qpos, diag_band,
                                        rounding_mode="floor"), INT32_MAX)
    order = stable_order(pack2(p_cand, dbin), pack2(p_qpos, p_spos))
    return (p_cand[order], dbin[order], p_qpos[order], p_spos[order],
            torch.stack([n_total, n_emit]))


def _joint_sort(flat: torch.Tensor, cand_flat: torch.Tensor,
                cand_id: torch.Tensor, *, k: int, slice_size: int):
    """The genome chunk's two-strand k-mers and the candidates' k-mers in
    one sorted stream: (sorted int64 keys (code << 32) | (tag << 31) |
    pos, the candidate k-mers' ids int32, K, S)."""
    L = flat.shape[-1]
    dev = flat.device
    g_codes = two_strand_codes(flat, k)                          # [2L]
    ck = kmer_codes(cand_flat, k)
    Pk = ck.shape[0]
    cid = cand_id[:Pk].to(torch.int32)
    n = 2 * L + Pk
    code = torch.cat([g_codes, torch.where(ck < 0, INT32_MAX, ck)])
    tag = torch.cat([torch.ones(2 * L, dtype=torch.int32, device=dev),
                     torch.zeros(Pk, dtype=torch.int32, device=dev)])
    pos = torch.cat([torch.arange(2 * L, dtype=torch.int32, device=dev),
                     torch.arange(Pk, dtype=torch.int32, device=dev)])
    # (code, tag, pos) is unique: one int64 key, candidates first in a run
    key = (code.to(torch.int64) << 32) | (tag.to(torch.int64) << 31) | pos
    skey = torch.sort(key, stable=True).values
    S = min(slice_size, _pow2_ceil(n))
    return skey, cid.contiguous(), -(-n // S), S


def libjoin_fill_plain(skey: torch.Tensor, cid: torch.Tensor, *, K: int,
                       S: int, fill_w: int, max_occ: int, quotas):
    """Pair every genome entry of the sorted stream, cut into [K, S]
    slices, with its run's last `fill_w` candidate entries within the
    slice (chained cummax forward fills), runs past `max_occ` genome
    entries stopping; each fill compacted under its per-slice quota.
    Returns (parts [(cand, qpos, spos) int32 [K, q_w] a fill], counts
    [int32 [K] a fill], emitted [int32 [K] a fill])."""
    dev = skey.device
    code = (skey >> 32).to(torch.int32)
    tag = ((skey >> 31) & 1).to(torch.int32)
    pos = (skey & 0x7FFFFFFF).to(torch.int32)
    gid = torch.where(tag == 0, cid[torch.where(tag == 0, pos, 0).long()],
                      -1)
    code = slices(code, K, S, INT32_MAX)
    tag = slices(tag, K, S, 1)
    pos = slices(pos, K, S, 0)
    gid = slices(gid, K, S, -1)

    idx = torch.arange(S, dtype=torch.int32, device=dev).expand(K, S)
    is_cand = (tag == 0) & (code != INT32_MAX)
    fills = [torch.cummax(torch.where(is_cand, idx, -1), dim=1).values]
    for _ in range(1, fill_w):
        fills.append(torch.cummax(torch.where(is_cand, shift1(fills[-1]), -1),
                                  dim=1).values)
    ord1 = idx - fills[0]
    base_ok = (~is_cand) & (code != INT32_MAX) & (ord1 <= max_occ)
    parts, counts, emits = [], [], []
    for jw, qw in zip(fills, quotas):
        jc = jw.clamp(0, S - 1).long()
        ok = base_ok & (jw >= 0) & (torch.gather(code, 1, jc) == code)
        out, cw, ew = _emit(ok, qw, torch.gather(gid, 1, jc),
                            torch.gather(pos, 1, jc), pos)
        parts.append(out)
        counts.append(cw)
        emits.append(ew)
    return parts, counts, emits


@functools.lru_cache(maxsize=None)
def _fill_lib() -> ctypes.CDLL:
    """The loaded `csrc/libjoin.cu` library with its argtypes, resolved
    once."""
    lib = kernels.load("libjoin")
    lib.libjoin_fill_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
        + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_void_p] * 7)
    lib.libjoin_fill_launch.restype = ctypes.c_int
    lib.libjoin_fill_tiles.argtypes = [ctypes.c_int]
    lib.libjoin_fill_tiles.restype = ctypes.c_int
    lib.libjoin_fill_error_string.argtypes = [ctypes.c_int]
    lib.libjoin_fill_error_string.restype = ctypes.c_char_p
    return lib


def _fill_cuda(skey: torch.Tensor, cid: torch.Tensor, *, K: int, S: int,
               fill_w: int, max_occ: int, quotas):
    """`libjoin_fill_plain` as `csrc/libjoin.cu`'s two passes on the
    current stream (no synchronise); the fills' columns are views of one
    [3, K, sum(quotas)] output."""
    if not 1 <= fill_w <= FILL_MAX_W:
        raise ValueError(f"the libjoin_fill kernel takes fill_w 1 to "
                         f"{FILL_MAX_W}, got {fill_w}")
    if (skey.dtype != torch.int64 or cid.dtype != torch.int32
            or not skey.is_contiguous() or not cid.is_contiguous()
            or cid.device != skey.device or skey.dim() != 1):
        raise ValueError("libjoin_fill takes contiguous int64 keys [n] and "
                         "int32 candidate ids on one device")
    dev = skey.device
    quotas = [int(q) for q in quotas]
    lib = _fill_lib()
    tiles = lib.libjoin_fill_tiles(S)
    scratch = torch.empty(K * tiles * FILL_MAX_W, dtype=torch.int32,
                          device=dev)
    out = torch.empty((3, K, sum(quotas)), dtype=torch.int32, device=dev)
    cnt = torch.empty((2, fill_w, K), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.libjoin_fill_launch(
            skey.data_ptr(), cid.data_ptr(), skey.shape[0], K, S, fill_w,
            max_occ, (ctypes.c_int * fill_w)(*quotas), scratch.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            cnt[0].data_ptr(), cnt[1].data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("libjoin_fill kernel launch failed: "
                           + lib.libjoin_fill_error_string(rc).decode())
    kernels.count_launch("libjoin_fill", (K, S, fill_w))
    count("libjoin.fill_chunks")
    parts, o = [], 0
    for q in quotas:
        parts.append(tuple(out[i, :, o : o + q] for i in range(3)))
        o += q
    return parts, list(cnt[0].unbind(0)), list(cnt[1].unbind(0))


def libjoin_fill(skey: torch.Tensor, cid: torch.Tensor, *, K: int, S: int,
                 fill_w: int, max_occ: int, quotas):
    """The fills and compactions of `libjoin_pairs`: the CUDA kernel for
    CUDA tensors (fill_w 1 to 8), the plain version for CPU tensors;
    anything else raises."""
    kw = dict(K=K, S=S, fill_w=fill_w, max_occ=max_occ, quotas=quotas)
    if skey.device.type == "cpu":
        return libjoin_fill_plain(skey, cid, **kw)
    if skey.is_cuda:
        return _fill_cuda(skey, cid, **kw)
    raise ValueError(f"libjoin_fill: no path for device {skey.device}")


def libjoin_pairs(flat: torch.Tensor, cand_flat: torch.Tensor,
                  cand_id: torch.Tensor, *, k: int, diag_band: int = 32,
                  fill_w: int = 2, max_occ: int = 1024,
                  slice_size: int = 1 << 20, slice_quota: int = 1 << 19):
    """Stage 1 on a genome chunk: joint sort + forward-fill pairing.

    Returns (s_cand, s_dbin, s_qpos, s_spos, counts int32 [2] = (total
    real pairs, pairs emitted under the per-slice quotas))."""
    skey, cid, K, S = _joint_sort(flat, cand_flat, cand_id, k=k,
                                  slice_size=slice_size)
    parts, counts, emits = libjoin_fill(
        skey, cid, K=K, S=S, fill_w=fill_w, max_occ=max_occ,
        quotas=_quotas(slice_quota, fill_w, S))
    return _finish(parts, counts, emits, diag_band)


def libjoin_genome_sorted(flat: torch.Tensor, *, k: int):
    """One-time genome side of INDEXED joins: the two-strand k-mer stream
    sorted by (code, pos) plus each entry's 0-based ordinal in its run.
    Returns (g_code, g_pos, g_ord) int32."""
    codes = two_strand_codes(flat, k)
    n = codes.shape[0]
    code, perm = torch.sort(codes, stable=True)
    idx = torch.arange(n, dtype=torch.int32, device=flat.device)
    prev = torch.nn.functional.pad(code[:-1], (1, 0), value=-1)
    run_start = torch.cummax(torch.where(code != prev, idx, -1), dim=0).values
    return code, perm.to(torch.int32), idx - run_start


def libjoin_pairs_indexed(g_code: torch.Tensor, g_pos: torch.Tensor,
                          g_ord: torch.Tensor, cand_flat: torch.Tensor,
                          cand_id: torch.Tensor, *, k: int,
                          diag_band: int = 32, fill_w: int = 2,
                          max_occ: int = 1024, slice_size: int = 1 << 20,
                          slice_quota: int = 1 << 19):
    """`libjoin_pairs` against a pre-sorted genome stream (same contract)."""
    dev = g_code.device
    ck = kmer_codes(cand_flat, k)
    Pk = ck.shape[0]
    cid = cand_id[:Pk].to(torch.int32)
    ccode, cperm = torch.sort(torch.where(ck < 0, INT32_MAX, ck), stable=True)
    cpos = cperm.to(torch.int32)
    ccid = cid[cperm]

    n = g_code.shape[0]
    hi = torch.searchsorted(ccode, g_code, right=True).to(torch.int32)
    base_ok = (g_code != INT32_MAX) & (g_ord < max_occ)

    S = min(slice_size, _pow2_ceil(n))
    K = -(-n // S)
    code_s = slices(g_code, K, S, INT32_MAX)
    pos_s = slices(g_pos, K, S, 0)
    hi_s = slices(hi, K, S, 0)
    ok_s = slices(base_ok, K, S, False)
    quotas = _quotas(slice_quota, fill_w, S)

    parts, counts, emits = [], [], []
    for w, qw in enumerate(quotas):
        j = hi_s - 1 - w
        jc = j.clamp(0, Pk - 1).long()
        okw = ok_s & (j >= 0) & (ccode[jc] == code_s)
        out, cw, ew = _emit(okw, qw, ccid[jc], cpos[jc], pos_s)
        parts.append(out)
        counts.append(cw)
        emits.append(ew)
    return _finish(parts, counts, emits, diag_band)


def libjoin_scan_packed(s_cand, s_dbin, s_qpos, s_spos, *, k: int,
                        run_gap: int = 96, min_seeds: int = 4,
                        min_hsp_len: int = 30, max_hsps: int = 1 << 15,
                        max_seed_pairs: int = 1 << 20,
                        budget_slices: int = 1) -> torch.Tensor:
    """Stage 2: candidate-grouped co-diagonal run detection, packed into
    ONE int32 [8, M] tensor: rows cand, qs, qe, ss, se, nseeds, valid,
    total good-HSP count (broadcast)."""
    K = budget_slices
    S = min(max_seed_pairs, s_qpos.shape[0])
    quota = max(1, max_hsps // K)
    c = slices(s_cand, K, S, INT32_MAX)
    d = slices(s_dbin, K, S, INT32_MAX)
    q = slices(s_qpos, K, S, INT32_MAX)
    sp = slices(s_spos, K, S, 0)

    valid = c != INT32_MAX
    brk = ((c != shift1(c)) | (d != shift1(d)) | (q - shift1(q) > run_gap))
    idx = torch.arange(S, dtype=torch.int32, device=c.device).expand(K, S)
    run_start = torch.cummax(torch.where(brk, idx, -1), dim=1).values
    rs = run_start.long()
    start_q = torch.gather(q, 1, rs)
    start_s = torch.gather(sp, 1, rs)
    nseeds = idx - run_start + 1
    qs, qe = start_q, q + k
    ss = torch.minimum(start_s, sp)
    se = torch.maximum(start_s, sp) + k

    nxt_brk = torch.nn.functional.pad(brk[:, 1:], (0, 1), value=True)
    good = valid & nxt_brk & (nseeds >= min_seeds) & (qe - qs >= min_hsp_len)
    sel = compact(good, quota, S - 1)
    count = good.sum(1, dtype=torch.int32)
    out_valid = torch.arange(quota, device=c.device)[None] < count[:, None]

    def take(a):
        return torch.where(out_valid, torch.gather(a, 1, sel), 0).reshape(-1)

    cand = take(c)
    return torch.stack([cand, take(qs), take(qe), take(ss), take(se),
                        take(nseeds), out_valid.reshape(-1).to(torch.int32),
                        torch.full_like(cand, int(count.sum()))])
