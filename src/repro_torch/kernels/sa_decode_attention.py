"""Paged decode attention: plain version and the hand-written Hopper kernel.

Replaces the TPU kernel `repro/kernels/sa_decode_attention.py`
`_decode_kernel` (flash-decoding over the paged pool: walk the block
table, mask unmapped (-1) and trash (0) pages without reading them,
per-head fp32 q·k on cast-in operands, approx truncation, host-folded
softcap, window and position masks, deferred softmax with the all-masked
guard, P·V in fp32, approx truncation).

The plain version is `gather_pages` + `decode_attention` of the port's
`models/layers.py`, exactly as the JAX kernel is pinned to the JAX pair.

Dense per-slot rows (a ring, or the gathered view of the pool) go through
the same kernel as a pool with an identity block table (`dense_pool_view`,
no copy; `min_page=0`, since a dense view has no trash page). A slot whose
rows are its pool pages in sequence order then gets the pool's split and
order of sums, so on the card the `gather` path and the ring layout decode
a slot to the fused path's bits (ROADMAP F5).

The kernel (`csrc/sa_decode_attention.cu`) splits each (slot, KV head)'s
keys across a thread-block cluster: grid (B, KVH, n_split), n_split
blocks a cluster, each a contiguous stretch of whole runs of RUN = 64 keys
(`split_plan`: one block per run up to 8 a cluster, 16 where shared memory
needs it; from the slot's own shape alone, so a slot's order of sums does
not depend on how many other slots share the batch: ROADMAP F2). The g
query heads of a KV head share every K and V row a block reads; each warp
keeps 8 keys' loads in flight and reduces their g dots in one butterfly.
A block keeps its own scores in shared memory. The row max is exact; the
denominator and P·V are summed a run at a time in an order fixed by the
run, and the runs' partials are folded in run order (the sums over a
run's keys in shared memory, its P·V partial through a global workspace),
so the output is the same for every cluster size (ROADMAP F9): n_split
decides only which block computes which run. P is normalized by the
whole row before it is rounded, as in the reference. At the serving
shape a call is bound by latency (one cold read and three cluster
barriers against 0.75 µs of bytes); at long slots by the two dependent
passes over the pool (K, then V), each warp holding 8 rows in flight,
short of the bytes' bound (PERF.md). A slot's length is limited by the
cluster's shared memory (164,864 tokens at g = 5, hd = 128, page 16,
over 16 blocks), not by one block's.

The pools may be fp32, bf16 or fp16 (`ServeEngine(cache_dtype=)`, as the
reference takes): the pool type is a template parameter of the kernel's
row loads, and each value is widened exactly and cast in as before, so the
order of the sums does not depend on it. Under the bf16 policy a bf16 pool
gives the fp32 pool's output bit for bit (its values are the fp32 ones
rounded once, as cast_in rounds them), and halves the bytes.

A meta tensor takes the kernel's meta route: the same checks and plan as
a CUDA tensor (`launch_plan`; the tuner's cache is the card's, so the
meta route takes the plan's own split, as a card with no tuned entry
does), then a meta output and a record for the cost counters
(`core/tally.py`) in place of the launch; the launch counters do not
move.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core import tally

from . import autotune

LAUNCHES = 0       # kernel launches through `paged_decode_cuda`
MODE_LAUNCHES = {"exact": 0, "approx": 0}   # the launches by policy mode
PLAIN_CALLS = 0    # calls of the plain version `paged_decode_ref`
# of those, the launches and plain calls that also gave the log-sum-exp
# (`lse=True`: the rings split over `data`)
LSE_LAUNCHES = 0
LSE_PLAIN_CALLS = 0

_SUPPORTED_INPUT_FORMATS = ("fp32", "bf16", "fp16")
_FMT_CODE = {"fp32": 0, "bf16": 1, "fp16": 2}
# the pools' element types the kernel reads (both pools one type), and the
# library built for each (`build.LIBRARIES`)
POOL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_POOL_LIBRARY = {torch.float32: "sa_decode_attention_f32",
                 torch.bfloat16: "sa_decode_attention_bf16",
                 torch.float16: "sa_decode_attention_f16"}


def fused_decode_supported(policy) -> bool:
    """True when the fused kernel reproduces the gather path for `policy`
    (FP8 inputs and non-fp32 output rounding stay on the gather path)."""
    return (policy.input_format in _SUPPORTED_INPUT_FORMATS
            and policy.output_format == "fp32")


def paged_decode_ref(q, k_pool, v_pool, page_positions, block_table, pos, *,
                     window: int = 0, cap: float = 0.0, scale=None,
                     policy=None, min_page: int = 1, lse: bool = False):
    """Plain version: gather the slot's pages (those with an id of at least
    `min_page`), then `decode_attention`. `lse`: (out, lse (B, H) fp32),
    each query row's log-sum-exp of its scaled scores, -inf where every
    key is masked (`decode_attention(return_lse=True)`)."""
    global PLAIN_CALLS, LSE_PLAIN_CALLS
    from repro_torch.core.precision import current_policy, use_policy
    from repro_torch.models.layers import (PagedKVCache, decode_attention,
                                           gather_pages)

    PLAIN_CALLS += 1
    LSE_PLAIN_CALLS += int(lse)
    policy = policy or current_policy()
    k, v, kvp = gather_pages(PagedKVCache(k_pool, v_pool, page_positions,
                                          block_table), min_page=min_page)
    with use_policy(policy):
        return decode_attention(q, k, v, kvp, pos, window=window, cap=cap,
                                scale=scale, return_lse=lse)


WARPS = 8              # warps a block (csrc/sa_decode_attention.cu kWarps)
KEY_ALIGN = 8          # keys a warp has in flight
RUN = WARPS * KEY_ALIGN  # keys a run (kRun): a block holds whole runs
PORTABLE_CLUSTER = 8   # blocks a cluster every sm_90 part schedules
MAX_CLUSTER = 16       # with the non-portable cluster size (H100)
SMEM_LIMIT = 227 * 1024


class SplitPlan(NamedTuple):
    n_split: int        # blocks a (slot, KV head) cluster
    keys_per_cta: int   # keys a block: block r takes [r·kpc, (r + 1)·kpc)
    smem: int           # dynamic shared memory a block, bytes


def decode_smem(g: int, hd: int, psz: int, kpc: int) -> int:
    """A block's shared memory (the kernel's layout): g·kpc scores, the 8
    warps' P·V partials, 4g reduction slots, g sums a run, and the block
    table entries kpc keys can touch."""
    return (4 * (g * kpc + WARPS * g * hd + 4 * g + (kpc // RUN) * g)
            + 4 * (kpc // psz + 2))


def _keys_per_cta(S: int, n: int) -> int:
    """ceil(S / n) rounded up to whole runs."""
    return -(-(-(-S // n)) // RUN) * RUN


def workspace_floats(B: int, KVH: int, g: int, hd: int,
                     plan: SplitPlan) -> int:
    """The runs' P·V partials the kernel writes before the fold: g·hd
    fp32 a run, n_split·kpc/RUN runs a (slot, KV head)."""
    return B * KVH * plan.n_split * (plan.keys_per_cta // RUN) * g * hd


def split_plan(g: int, hd: int, psz: int, P: int, *,
               n_split: int | None = None) -> SplitPlan:
    """How a slot's S = P·psz keys are split across a cluster.

    n_split starts at PORTABLE_CLUSTER blocks (at most one per RUN
    keys), doubles up to MAX_CLUSTER while a block's scores do not fit
    SMEM_LIMIT, and shrinks to the blocks the length rounded to whole
    runs needs, so no block is empty. Nothing else enters: not the batch,
    not the card's SM count (ROADMAP F2). The kernel's output does not
    depend on the plan at all (F9): its sums go run by run. `n_split`
    given (tests, the autotuner) fixes the start. Raises where no cluster
    holds the slot."""
    S = P * psz
    if n_split is None:
        n = max(1, min(PORTABLE_CLUSTER, -(-S // RUN)))
        while (n < MAX_CLUSTER
               and decode_smem(g, hd, psz, _keys_per_cta(S, n)) > SMEM_LIMIT):
            n = min(MAX_CLUSTER, 2 * n)
    else:
        n = n_split
    if not 1 <= n <= MAX_CLUSTER:
        raise ValueError(f"paged decode: n_split {n} outside 1..{MAX_CLUSTER}")
    kpc = _keys_per_cta(S, n)
    n = -(-S // kpc)
    smem = decode_smem(g, hd, psz, kpc)
    if smem > SMEM_LIMIT:
        raise ValueError(f"paged decode: a {S}-token slot needs {smem} bytes "
                         f"of shared memory a block at {n} blocks a cluster "
                         f"(at most {SMEM_LIMIT})")
    return SplitPlan(n, kpc, smem)


def dense_pool_view(k, v, positions, page_size: int, block_table=None):
    """Dense per-slot rows as a pool the kernel walks, without a copy.

    k, v (B, S, KVH, hd) and positions (B, S), S a multiple of
    `page_size`, become pools (B·S/psz, psz, KVH, hd) and (B·S/psz, psz)
    with the identity block table `table[b, j] = b·S/psz + j` (B, S/psz)
    int32: slot b's row i is key i of its view, as key i of a pool slot is
    row i of its pages in sequence order. Launch it with `min_page=0`.
    `block_table` (B, S/psz), given for the gathered view of a pool, marks
    -1 every entry whose source entry is <= 0 (unmapped or the trash
    page): those zero rows are then skipped, as the pool's are, not read
    and masked. Returns (k_pool, v_pool, page_positions, table)."""
    B, S = positions.shape
    if S % page_size:
        raise ValueError(f"dense decode view: {S} rows a slot are not a "
                         f"multiple of the page size {page_size}")
    P = S // page_size
    table = torch.arange(B * P, dtype=torch.int32,
                         device=k.device).reshape(B, P)
    if block_table is not None:
        table = torch.where(block_table > 0, table, -1)
    return (k.view(B * P, page_size, *k.shape[2:]),
            v.view(B * P, page_size, *v.shape[2:]),
            positions.view(B * P, page_size), table)


def _group(q, k_pool, v_pool) -> int:
    """g = H / KVH, after checking what the kernel takes: g up to 8, hd
    64, 128 or 256, both pools of one type in POOL_DTYPES."""
    H, hd = q.shape[2], q.shape[3]
    KVH = k_pool.shape[2]
    g = H // KVH
    if (H % KVH or not 1 <= g <= 8 or hd not in (64, 128, 256)
            or k_pool.dtype not in POOL_DTYPES
            or v_pool.dtype != k_pool.dtype):
        raise ValueError(f"unsupported paged decode operands q "
                         f"{tuple(q.shape)} pool {tuple(k_pool.shape)} "
                         f"{k_pool.dtype}")
    return g


def launch_plan(q, k_pool, v_pool, block_table,
                n_split: int | None = None) -> SplitPlan:
    """The kernel's split for these operands' shapes (`split_plan`), after
    checking what the kernel takes (`_group`)."""
    g = _group(q, k_pool, v_pool)
    return split_plan(g, q.shape[3], k_pool.shape[1], block_table.shape[1],
                      n_split=n_split)


def paged_decode_cuda(q, k_pool, v_pool, page_positions, block_table, pos,
                      *, window: int = 0, cap: float = 0.0, scale=None,
                      policy=None, n_split: int | None = None,
                      min_page: int = 1, lse: bool = False):
    """Launch the paged decode kernel. q (B, 1, H, hd) fp32; pools
    (n_pages, psz, KVH, hd) fp32, bf16 or fp16 (both one type; a 16-bit
    pool is widened exactly, then cast in as an fp32 one); page_positions (n_pages, psz) int32;
    block_table (B, P) int32; pos (B,) int32 → (B, 1, H, hd) fp32. g = H /
    KVH up to 8, hd 64, 128 or 256. `n_split` fixes the cluster size of
    `split_plan` (tests and sweeps of the split; default: the autotuner's,
    `autotune.lookup_decode_attn`, keyed by the slot's shape and the
    pool's type, else the plan's own). `min_page` is
    the lowest page id read: 1 for the pool (page 0 is the trash page), 0
    for a `dense_pool_view`. `lse`: the kernel also writes each query
    row's log-sum-exp (the row max plus the log of the exp-sum, -inf with
    an output of zeros where every key is masked) and (out, lse (B, H)
    fp32) is returned: the fold of a ring split over `data`
    (`layers.fold_partials`)."""
    global LAUNCHES, LSE_LAUNCHES
    from repro_torch.core.precision import current_policy
    from .build import check, function

    policy = policy or current_policy()
    if min_page not in (0, 1):
        raise ValueError(f"paged decode: min_page {min_page}, want 0 or 1")
    if not fused_decode_supported(policy):
        raise ValueError(
            f"fused paged decode does not support input_format="
            f"{policy.input_format!r} / output_format="
            f"{policy.output_format!r}; use the gather path")
    for t in (q, k_pool, v_pool, page_positions, block_table, pos):
        if not (t.is_cuda or t.is_meta) or t.device != q.device:
            raise ValueError("paged_decode_cuda needs every operand on one "
                             "CUDA device (or the meta device)")
    B, _, H, hd = q.shape
    psz, KVH = k_pool.shape[1], k_pool.shape[2]
    P = block_table.shape[1]
    if q.is_meta:
        plan = launch_plan(q, k_pool, v_pool, block_table, n_split)
    else:
        g = _group(q, k_pool, v_pool)
        if n_split is None:
            n_split = autotune.lookup_decode_attn(g, hd, psz, P,
                                                  dtype=k_pool.dtype,
                                                  batch=B, kvh=KVH)
        plan = split_plan(g, hd, psz, P, n_split=n_split)
    g = H // KVH
    scale = scale or hd ** -0.5
    cap = float(cap or 0.0)
    q = q.to(torch.float32).contiguous()
    k_pool, v_pool = k_pool.contiguous(), v_pool.contiguous()
    pp = page_positions.to(torch.int32).contiguous()
    bt = block_table.to(torch.int32).contiguous()
    ps = pos.to(torch.int32).reshape(B).contiguous()
    out = torch.empty((B, 1, H, hd), dtype=torch.float32, device=q.device)
    ws = torch.empty(workspace_floats(B, KVH, g, hd, plan),
                     dtype=torch.float32, device=q.device)
    lse_out = (torch.empty((B, H), dtype=torch.float32, device=q.device)
               if lse else None)
    if q.is_meta:
        # the work depends on each row's live keys, which a meta tensor
        # does not hold: the counter takes them from the cell
        tally.kernel("paged_decode", lse=lse,
                     decode=dict(B=B, H=H, KVH=KVH, hd=hd, psz=psz, P=P,
                                 window=int(window),
                                 pool_bytes=k_pool.element_size()))
        return (out, lse_out) if lse else out
    fn = function(_POOL_LIBRARY[k_pool.dtype], "paged_decode_launch",
                  [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
                  + [ctypes.c_float] * 3 + [ctypes.c_int] * 4
                  + [ctypes.c_void_p])
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             pp.data_ptr(), bt.data_ptr(), ps.data_ptr(), out.data_ptr(),
             ws.data_ptr(), lse_out.data_ptr() if lse else None,
             B, KVH, g, hd, psz, P, *plan, int(min_page), float(scale),
             float(scale / cap) if cap else 0.0, cap, int(window),
             _FMT_CODE[policy.input_format], int(policy.mode == "approx"),
             POOL_DTYPES[k_pool.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "paged_decode")
    LAUNCHES += 1
    LSE_LAUNCHES += int(lse)
    MODE_LAUNCHES[policy.mode] += 1
    return (out, lse_out) if lse else out


def error_bound(q, k_pool, v_pool, page_positions, block_table, pos, *,
                window: int = 0, cap: float = 0.0, scale=None, policy=None,
                folded: bool = False, min_page: int = 1):
    """Per-output bound on |kernel − plain| (B, 1, H, hd), from the plain
    version's own terms (the pages of an id of at least `min_page`, as
    `paged_decode_ref` reads them).

    Both normalize with the full row max before P is rounded to the input
    format, so with p the exact softmax weights each side's weight lies in
    p·(1 ± eps) (`sa_attention.softmax_error_terms`) and its rounding P
    between rnd(p·(1 − eps)) and rnd(p·(1 + eps)): the weights differ by at
    most D_j, the width of that interval — zero for most keys, one ulp of
    the format where a rounding boundary falls inside. Then
    |Δo_d| ≤ Σ_j D_j·|v_jd| + (2·S·2⁻²⁴ + approx 2⁻²⁰)·Σ_j p_j·|v_jd| (the
    fp32 P·V sums in two orders, the output's truncation quantum). The
    leading 2 of the returned bound covers the second-order terms.

    `folded`: the bound on a fold of partial attentions over disjoint key
    rows (`layers.fold_partials`, two parts) against the kernel over all
    of them. A part normalizes its weights by its own exp-sum before they
    are rounded to the input format, so a weight may differ from the
    whole's by the two roundings, 2u·p_j (u the format's unit roundoff:
    2⁻⁸ bf16, 2⁻¹¹ fp16, 0 fp32), where that exceeds D_j; and the fold's
    fp32 steps (the weights exp(lse_r − lse) from log-sum-exps of size
    |lse|, then two parts added) add (8·(1 + |lse|) + 4)·2⁻²⁴·Σ_j
    p_j·|v_jd|."""
    from repro_torch.core.precision import current_policy
    from repro_torch.models.layers import PagedKVCache, gather_pages

    from .sa_attention import softmax_error_terms

    policy = policy or current_policy()
    approx = policy.mode == "approx"
    B, _, H, hd = q.shape
    KVH = k_pool.shape[2]
    g = H // KVH
    scale = scale or hd ** -0.5
    k, v, kvp = gather_pages(PagedKVCache(k_pool, v_pool, page_positions,
                                          block_table), min_page=min_page)
    S = k.shape[1]
    f64 = torch.float64
    qc = policy.cast_in(q).to(f64).reshape(B, KVH, g, hd)
    kc, vc = (policy.cast_in(x).to(f64) for x in (k, v))
    s_raw = torch.einsum("bhgd,bshd->bhgs", qc, kc)
    a_abs = torch.einsum("bhgd,bshd->bhgs", qc.abs(), kc.abs())
    pos = pos.reshape(B, 1)
    ok = (kvp >= 0) & (kvp <= pos)
    if window:
        ok &= kvp > pos - window
    p, eps = softmax_error_terms(s_raw, a_abs, ok[:, None, None, :], hd=hd,
                                 scale=scale, cap=cap, approx=approx)

    def rnd(x):
        return policy.cast_in(x.to(torch.float32)).to(f64)

    d_p = rnd(p * (1 + eps)) - rnd(p * (1 - eps))
    va = vc.abs()
    rel = 2 * S * 2.0 ** -24 + (2.0 ** -20 if approx else 0.0)
    if folded:
        u = {"bf16": 2.0 ** -8, "fp16": 2.0 ** -11}.get(
            policy.input_format, 0.0)
        d_p = torch.maximum(d_p, 2 * u * p * (1 + eps))
        lse = _exact_lse(qc, kc, ok, scale, cap)              # (B, KVH, g)
        rel = rel + (8 * (1 + lse.abs()[..., None]) + 4) * 2.0 ** -24
    bound = (torch.einsum("bhgs,bshd->bhgd", d_p, va)
             + rel * torch.einsum("bhgs,bshd->bhgd", p, va))
    return (2 * bound).reshape(B, 1, H, hd).to(torch.float32) + 1e-30


def _exact_lse(qc, kc, ok, scale, cap):
    """The exact (fp64) log-sum-exp of each query row's scaled scores over
    its unmasked keys, 0 where every key is masked: qc (B, KVH, g, hd), kc
    (B, S, KVH, hd) cast in, ok (B, S)."""
    s = torch.einsum("bhgd,bshd->bhgs", qc, kc)
    s = cap * torch.tanh(s * (scale / cap)) if cap else s * scale
    s = torch.where(ok[:, None, None, :], s, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    return torch.where(torch.isfinite(lse), lse, 0.0)


def lse_error_bound(q, k_pool, v_pool, page_positions, block_table, pos, *,
                    window: int = 0, cap: float = 0.0, scale=None,
                    policy=None, min_page: int = 1):
    """Bound on |kernel − plain| of the log-sum-exp output, (B, H). Each
    side's lse is m + log Σ_j exp(s_j − m) from its own fp32 scores: the
    scores' and the exp-sum's errors move it by at most the relative
    error `eps` of the weights (`sa_attention.softmax_error_terms`), the
    log and the add by a few ulp of |lse|, so the sides differ by at most
    2·(eps + 2⁻²¹·(1 + |lse|)). A row whose keys are all masked gives -inf
    on both sides (bound 0)."""
    from repro_torch.core.precision import current_policy
    from repro_torch.models.layers import PagedKVCache, gather_pages

    from .sa_attention import softmax_error_terms

    policy = policy or current_policy()
    B, _, H, hd = q.shape
    KVH = k_pool.shape[2]
    g = H // KVH
    scale = scale or hd ** -0.5
    k, _, kvp = gather_pages(PagedKVCache(k_pool, v_pool, page_positions,
                                          block_table), min_page=min_page)
    f64 = torch.float64
    qc = policy.cast_in(q).to(f64).reshape(B, KVH, g, hd)
    kc = policy.cast_in(k).to(f64)
    pos = pos.reshape(B, 1)
    ok = (kvp >= 0) & (kvp <= pos)
    if window:
        ok &= kvp > pos - window
    s_raw = torch.einsum("bhgd,bshd->bhgs", qc, kc)
    a_abs = torch.einsum("bhgd,bshd->bhgs", qc.abs(), kc.abs())
    _, eps = softmax_error_terms(s_raw, a_abs, ok[:, None, None, :], hd=hd,
                                 scale=scale, cap=cap,
                                 approx=policy.mode == "approx")
    lse = _exact_lse(qc, kc, ok, scale, cap)
    bound = 2 * (eps[..., 0] + 2.0 ** -21 * (1 + lse.abs()))
    bound = torch.where(ok.any(-1)[:, None, None], bound, 0.0)
    return bound.reshape(B, H).to(torch.float32)
