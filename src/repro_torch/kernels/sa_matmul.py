"""SA GEMM: the paper's column contract as a hand-written Hopper kernel,
forward and backward.

Replaces the TPU kernel `repro/kernels/sa_matmul.py` `_matmul_kernel`
(its `pallas_call` in `_pallas_fused`) and its custom VJP
(`_sa_matmul_fwd` / `_sa_matmul_bwd`): an (M, K) @ (K, N) product whose
fp32 accumulator is never rounded mid-chain, followed by one epilogue in
this order — `truncate_mantissa` (approx only) → × scale → + bias → act —
and one fp32 write, optionally beside the raw fp32 accumulator (taken
after the truncation, before the scale) that the backward needs.

The kernel library (`csrc/sa_matmul.cu`) has four routes, chosen by
`gemm_route` from the rows and the operand types (not as fallbacks: a
failed build or launch of any route raises) and counted apart in
`ROUTE_LAUNCHES`:

* `partial` — fp32 decode (M < TILED_MIN_M, row-major operands, at least
  one of them fp32: the fp32 policy). Bound by bytes: every weight is
  read once for 2·M flops. SIMT fp32 FMA, a thread per column and up to 8
  rows, a block per 128 columns and one K slice (`fp32_k_plan`), so narrow
  N fills the SMs; the epilogue kernel folds the slices.
* `mma` — bf16 × bf16 at every M: the forward under the bf16 and FP8
  policies (`cast_in` gives bf16 on the card), decode included, fp32
  accumulate on the tensor cores. Bound by the tensor cores and the step
  sums' adds at training shapes (M = 1024), by W's bytes at prefill's and
  decode's M. The tile is the autotuner's where its cache has one
  (`autotune.lookup`, per (M, N, K, epilogue)), else `mma_plan`'s
  (`MMA_TILES`): the large one
  (128 × 128 blocks, warp-specialized: TMA copies of both operands into a
  six-stage ring of 128-byte-swizzled tiles, two consumer warpgroups on
  `wgmma` m64n128k16) where it pays (`large_pays`); 64 × 64 blocks
  below that, and for M ≤ DECODE_MAX_M the decode tile (one m16 row, 64
  columns, W streamed by TMA bulk copies into a six-stage ring), both on
  `mma.sync` m16n8k16 with tiles read by ldmatrix. Either operand is read
  in place through its strides on every tile; one launch a GEMM and no
  workspace. K is never split: every output's sum runs in one thread,
  k16 steps in order, whatever M or the tile, so a row's result does not
  depend on the other rows, and a bf16 GEMM's rows carry the same bits
  at every M (ROADMAP F2).
* `split3` — one fp32 and one bf16 operand: both backward GEMMs (dA =
  dus·Wᵀ, dW = Aᵀ·dus, fp32 × bf16 products in exact mode). The fp32
  operand is split once (`split3_cuda`, shared by dA and dW) into three
  bf16 pieces with hi + mid + lo = x exactly; each piece × bf16 is exact
  in fp32, so the tensor cores form exactly the reference's products and
  only the order of the sums differs. Three `mma` run on each fragment of
  the bf16 operand, loaded once. With the fp32 operand on the weight side
  the problem is transposed (Cᵀ = Wᵀ·Aᵀ) and written through strides.
  Three times `mma`'s products.
* `simt` — fp32 × fp32 (the fp32 policy): the 128 × 128 SIMT FMA kernel
  of the earlier design (fp32 has no exact tensor-core type), a block per
  tile and part of K (`fp32_k_plan`).

`partial` and `simt` sum each output in one order that depends on N and K
only (`fp32_k_plan`, ROADMAP F2b): slices of FP32_SLICE along K, each an
in-order FMA chain from zero; parts of consecutive slices, each the
slices folded left from zero; the output the parts folded left from zero.
So an fp32 × fp32 row carries the same bits at every M, on either route.

`SAMatmulFn` is the gradient, as the JAX package's VJP: the raw
accumulator is kept only when the activation or a real scale needs it,
`du` is the activation's VJP at `u = raw·scale + bias`, and dA = du·s·Wᵀ
and dW = Aᵀ·du·s run through the same kernel with fp32 dus in exact mode
(the approx tier is forward only). On a CPU tensor every GEMM runs the
plain version.

The sum's order differs from XLA's and from the plain version's; the
contract holds it to a per-route bound (`error_bound`), and the tensor-core
routes to the sharper `split_check` as well.

A meta tensor takes the kernel's meta route: the same planning as a CUDA
tensor (`_operand`, `gemm_route`, `mma_plan`, the operand copies, the
split's planes), then a meta output and a record for the cost counters
(`core/tally.py`: route, tile, 2·M·N·K flops, each operand read once and
each output written once) in place of the launch; the launch counters
do not move. Where the launch reads the card (its SM count) or the
tuner's cache, the meta route takes the H100's SM count and the
heuristic's tile (`mma_plan`), as a card with no tuned entry does.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import tally

from . import autotune
from .sa_attention import TC_GROUP

EPILOGUES = ("none", "relu", "gelu", "silu")
MODES = ("exact", "approx")

# the approximate-normalization ("bulk" tier) model: drop the low
# APPROX_DROP_BITS mantissa bits of the fp32 chain (RTZ) before the epilogue
APPROX_DROP_BITS = 3

LAUNCHES = 0          # forward kernel launches (`sa_matmul_cuda`)
MODE_LAUNCHES = {m: 0 for m in MODES}   # the forward launches by mode
PLAIN_CALLS = 0       # calls of the plain version `sa_matmul_ref`
BWD_LAUNCHES = 0      # backward GEMM launches (dA and dW: two a backward)
BWD_PLAIN_CALLS = 0   # backward GEMMs through the plain version
# operands a launch copied to a layout the kernel reads (`_operand`,
# `_aligned`): 0 on a path whose weights are stored as the kernel reads
# them (a ragged matrix as `model.matrix_storage` keeps it)
OPERAND_COPIES = 0
# every GEMM launch, forward and backward, by route (`gemm_route`)
ROUTES = ("partial", "mma", "split3", "simt")
ROUTE_LAUNCHES = {r: 0 for r in ROUTES}

_ACT_CODE = {a: i for i, a in enumerate(EPILOGUES)}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 128           # the simt kernel's output tile (rows and columns)
FP32_SLICE = 256      # K depth of a slice of the fp32 routes (one FMA chain)
TILED_MIN_M = 8       # rows from which a non-bf16 GEMM takes a tiled route
DECODE_MAX_M = 16     # rows up to which a bf16 GEMM takes the decode tile


class MmaTile(NamedTuple):
    """A tile of the tensor-core kernels (csrc/sa_matmul.cu): block rows
    and columns, warps, K stage depth, stages, the code that selects it in
    `sa_mma_launch`, the operands (`a`, `w`) whose stages arrive by TMA
    bulk copies (a full mbarrier a stage, the ring aligned to 1024 bytes),
    and whether its products run on `wgmma` (TileLarge: warp-specialized,
    `warps` // 4 warpgroups, the last one the producer, and an empty
    mbarrier a stage as well) or on `mma.sync` (TcTile)."""
    bm: int
    bn: int
    warps: int
    bk: int
    stages: int
    code: int
    tma: tuple = ()
    wgmma: bool = False

    def smem(self, npiece: int = 1) -> int:
        """Dynamic shared memory a block: the ring, and with TMA its
        barriers and 1024 bytes to align it."""
        ring = self.stages * (npiece * self.bm + self.bn) * self.bk * 2
        bars = 8 * self.stages * (2 if self.wgmma else 1)
        return ring + (1024 + bars if self.tma else 0)


# TileLarge (wgmma: two consumer warpgroups and a producer), TileSmall,
# TileDecode, TileSplit
MMA_TILES = {"large": MmaTile(128, 128, 12, 64, 6, code=0, tma=("a", "w"),
                              wgmma=True),
             "small": MmaTile(64, 64, 4, 64, 3, code=1),
             "decode": MmaTile(16, 64, 4, 128, 6, code=2, tma=("w",)),
             "split3": MmaTile(128, 128, 8, 32, 3, code=3)}
# the tensor-core launches by tile (`mma_plan`), beside ROUTE_LAUNCHES
TILE_LAUNCHES = {t: 0 for t in MMA_TILES}


def truncate_mantissa(y: torch.Tensor, bits: int = APPROX_DROP_BITS
                      ) -> torch.Tensor:
    """Zero the low `bits` mantissa bits of an fp32 tensor (RTZ)."""
    b = y.to(torch.float32).contiguous().view(torch.int32)
    return (b & ~((1 << bits) - 1)).view(torch.float32)


def apply_act(y: torch.Tensor, act: str) -> torch.Tensor:
    """Pointwise epilogue activation. `gelu` is the tanh approximation,
    as `jax.nn.gelu` defaults to."""
    if act == "relu":
        return torch.clamp_min(y, 0.0)
    if act == "gelu":
        return F.gelu(y, approximate="tanh")
    if act == "silu":
        return F.silu(y)
    return y


def _check_args(a, w, bias, act, mode):
    if act not in EPILOGUES:
        raise ValueError(f"unknown epilogue act {act!r}; have {EPILOGUES}")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; have {MODES}")
    if bias is not None and bias.ndim != 1:
        raise ValueError(f"bias must be a (N,) vector, got {tuple(bias.shape)}")
    if a.shape[-1] != w.shape[0]:
        raise ValueError(f"shape mismatch {tuple(a.shape)} @ {tuple(w.shape)}")


def sa_matmul_ref(a: torch.Tensor, w: torch.Tensor,
                  bias: torch.Tensor | None = None, scale=None, *,
                  act: str = "none", mode: str = "exact",
                  save_raw: bool = False):
    """Plain version: fp32 `torch.matmul` of the upcast operands, then the
    epilogue in the kernel's order. `a` may carry batch dimensions. With
    `save_raw`, returns `(y, raw)`: raw is the chain after the approx
    truncation and before the scale."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    _check_args(a, w, bias, act, mode)
    y = torch.matmul(a.to(torch.float32), w.to(torch.float32))
    if mode == "approx":
        y = truncate_mantissa(y)
    raw = y
    if isinstance(scale, torch.Tensor):
        y = y * scale.to(device=y.device, dtype=torch.float32).reshape(())
    elif scale is not None:
        y = y * float(scale)
    if bias is not None:
        y = y + bias.to(torch.float32)
    y = apply_act(y, act)
    return (y, raw) if save_raw else y


def fp32_k_plan(n: int, k: int) -> dict:
    """The fp32 routes' order of sums for an output of K-deep sums in a
    GEMM of N columns, whatever M (ROADMAP F2b): `slices` of `slice` along
    K (the last one ragged), `per_part` consecutive slices a part, `parts`
    parts. `simt` runs a block per (tile, part): up to 16 parts, two
    waves of two blocks an SM from one row of its 128-column tiles, which
    fills the card at any M; `partial` runs a block per slice."""
    slices = max(1, -(-k // FP32_SLICE))
    want = -(-4 * 132 // -(-n // _TILE))
    per_part = -(-slices // max(1, min(want, slices, 16)))
    return {"slice": FP32_SLICE, "slices": slices, "per_part": per_part,
            "parts": -(-slices // per_part)}


def fp32_launch(m: int, n: int, k: int, route: str) -> dict:
    """How `partial` or `simt` covers an (m, n) output of K-deep sums: the
    order of sums (`fp32_k_plan`, which does not see m), the grid, and the
    workspace's partial sums (0: they go straight to the output)."""
    plan = fp32_k_plan(n, k)
    if route == "partial":
        grid, nws = (-(-m // 8), -(-n // 128), plan["slices"]), plan["slices"]
    elif route == "simt":
        grid, nws = (-(-n // _TILE), -(-m // _TILE), plan["parts"]), \
            plan["parts"]
    else:
        raise ValueError(f"{route!r} is not an fp32 route")
    return {**plan, "grid": grid, "workspace": nws if nws > 1 else 0}


def gemm_route(m: int, a_dtype, w_dtype, a_kcont: bool = True,
               w_ncont: bool = True) -> str:
    """The kernel a GEMM of m rows runs: `mma` (bf16 x bf16, tensor cores)
    at every m; otherwise `partial` (split-K SIMT, row-major operands, m <
    TILED_MIN_M: fp32 decode), else by the operand types: `split3` (one
    fp32 and one bf16 operand, the fp32 one split into three bf16 pieces,
    tensor cores) or `simt` (fp32 x fp32)."""
    bf = (a_dtype == torch.bfloat16, w_dtype == torch.bfloat16)
    if all(bf):
        return "mma"
    if m < TILED_MIN_M and a_kcont and w_ncont:
        return "partial"
    return "split3" if any(bf) else "simt"


def large_pays(m: int, n: int, sms: int = 132) -> bool:
    """Whether a bf16 GEMM of (m, n) outputs takes the large tile (wgmma)
    rather than the small one: a large block's products and step adds run
    all its 128 rows whatever m, so it pays where m passes half a block and
    its blocks fill the card, or m passes a whole block and they fill half
    of it. The H100 sweep (chip_smoke's crossover readings, PERF.md §6)
    put the small tile ahead at m = 20-64 even for the lm_head's 1200
    blocks, and the large one ahead at m = 256 from 80 blocks (wq, wd)."""
    bm, bn = MMA_TILES["large"][:2]
    blocks = -(-m // bm) * -(-n // bn)
    return (2 * m > bm and blocks >= sms) or (m > bm and 2 * blocks >= sms)


def mma_plan(m: int, n: int, route: str, sms: int = 132,
             tile: str | None = None) -> dict:
    """How the tensor-core kernel covers an (m, n) output: `npiece` bf16
    pieces of A (1 for `mma`, 3 for `split3`), the tile (`MMA_TILES`:
    `mma` takes the decode one up to DECODE_MAX_M rows, the large one
    where `large_pays` and the small one between; `split3` its own; `tile`
    forces one of `mma`'s, for sweeps and tests), the grid (n tiles, m
    tiles) and each block's shared memory. K is never split: each output's
    sum runs k = 0..K-1 in one thread whatever m or the tile, so a row's
    result does not depend on the other rows (ROADMAP F2), and the choice
    of tile changes no bit."""
    npiece = 3 if route == "split3" else 1
    if npiece == 3:
        tile = "split3"
    elif tile is None:
        tile = ("decode" if m <= DECODE_MAX_M else "large"
                if large_pays(m, n, sms) else "small")
    elif tile == "split3" or tile not in MMA_TILES:
        raise ValueError(f"unknown mma tile {tile!r}; have "
                         f"{[t for t in MMA_TILES if t != 'split3']}")
    t = MMA_TILES[tile]
    return {"npiece": npiece, "tile": tile, "block": (t.bm, t.bn),
            "warps": t.warps, "grid": (-(-n // t.bn), -(-m // t.bm)),
            "smem": t.smem(npiece)}


_SMS: dict = {}
H100_SMS = 132        # the H100 SXM's SMs: the meta route's card


def _sm_count(device) -> int:
    if device.type == "meta":
        return H100_SMS
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def _operand(t: torch.Tensor):
    """(tensor, contiguous along its last dimension, leading dimension):
    a row-major operand or a transposed (column-major) view is read in
    place; any other layout is copied."""
    r, c = t.shape
    if t.stride(1) == 1 and (r <= 1 or t.stride(0) >= c):
        return t, True, t.stride(0) if r > 1 else c
    if t.stride(0) == 1 and (c <= 1 or t.stride(1) >= r):
        return t, False, t.stride(1) if c > 1 else r
    t = t.contiguous()
    return t, True, c


def _aligned(st: torch.Tensor, ld: int):
    """A bf16 operand's storage matrix `st` (last dimension contiguous,
    leading dimension ld) and ld, copied to a leading dimension that is a
    multiple of 8 elements where the tensor-core kernel's 16-byte copies
    need one: a ragged shape whose storage is not rounded up
    (`model.matrix_storage` rounds every ragged weight's rows up, so the
    served paths copy none)."""
    global OPERAND_COPIES
    r, c = st.shape
    if ld % 8 == 0 and st.data_ptr() % 16 == 0:
        return st, ld
    _copied(st)
    buf = torch.empty((r, -(-c // 8) * 8), dtype=st.dtype, device=st.device)
    buf[:, :c] = st
    return buf[:, :c], buf.shape[1]


def split3_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the split: (3, ...) bf16, hi = bf16_rn(x), mid =
    bf16_rn(x − hi), lo = bf16_rn(x − hi − mid), so hi + mid + lo = x
    exactly for |x| ≥ 2⁻¹¹⁰ (`split3_cuda`). A finite x beyond bf16's
    largest value takes hi toward zero; a non-finite x gives (x, 0, 0)."""
    x = x.to(torch.float32)
    hi = x.to(torch.bfloat16)
    over = torch.isinf(hi) & torch.isfinite(x)
    if bool(over.any()):
        rz = (x.view(torch.int32) & -65536).view(torch.float32)
        hi = torch.where(over, rz.to(torch.bfloat16), hi)
    fin = torch.isfinite(x)
    r1 = torch.where(fin, x - hi.float(), 0.0)
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return torch.stack([hi, mid, lo])


def _split3_planes(st: torch.Tensor, ld: int) -> tuple[torch.Tensor, int]:
    """The three bf16 planes (3, rows, ldp) of an fp32 matrix stored as
    `st` (last dimension contiguous, leading dimension ld), and ldp."""
    from .build import check, function

    r, c = st.shape
    ldp = -(-c // 8) * 8
    planes = torch.empty((3, r, ldp), dtype=torch.bfloat16, device=st.device)
    if st.is_meta:
        tally.kernel("sa_split3", nbytes=r * c * (4 + 3 * 2))
        return planes, ldp
    fn = function("sa_matmul", "sa_split3_launch",
                  [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_void_p])
    err = fn(st.data_ptr(), r, c, ld, planes.data_ptr(), ldp, r * ldp,
             torch.cuda.current_stream(st.device).cuda_stream)
    check(err, "sa_split3")
    return planes, ldp


def split3_cuda(x: torch.Tensor) -> torch.Tensor:
    """The kernel's split of a 2-D fp32 tensor on the card (the pre-pass of
    the `split3` route): (3, rows, cols) bf16, hi, mid, lo."""
    if not x.is_cuda or x.dtype != torch.float32 or x.ndim != 2:
        raise ValueError("split3_cuda takes a 2-D fp32 CUDA tensor")
    t, lastcontig, ld = _operand(x)
    st = t if lastcontig else t.t()
    planes, _ = _split3_planes(st, ld)
    planes = planes[:, :, :st.shape[1]]
    return planes if lastcontig else planes.transpose(1, 2)


# `sa_mma_launch`'s arguments: A (pointer, pieces, K-contiguous, lda,
# plane), B (pointer, K-contiguous, ldb), bias and bias_on_m, out, raw,
# the output's strides, scale and its device copy, M, N, K, act, approx,
# the tile's code, the stream
MMA_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int] * 3
                + [ctypes.c_longlong, ctypes.c_void_p] + [ctypes.c_int] * 2
                + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2
                + [ctypes.c_longlong] * 2
                + [ctypes.c_float, ctypes.c_void_p] + [ctypes.c_int] * 6
                + [ctypes.c_void_p])


def k16_probe_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of the probe: each step's 16 products summed in fp64
    and rounded once to fp32, (S, 64, 128)."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(
        torch.float32)


def k16_probe(a: torch.Tensor, b: torch.Tensor):
    """Each step s's 16 products of a[s] (64 × 16) and b[s] (16 × 128),
    bf16, summed from zero on the tensor cores two ways: `mma.sync`
    m16n8k16 with C = 0, as the mma.sync tiles sum a k16 step, and `wgmma`
    m64n128k16 with scale-d = 0, as the large tile does. Returns (mma,
    wgmma), each (S, 64, 128) fp32. ROADMAP F2 needs their bits equal
    (up to the sign of a zero step sum, which no accumulator started at
    +0 can see): then the large tile gives a row the other tiles' bits.
    On CPU tensors both are the plain version."""
    from .build import check, function

    s = a.shape[0]
    if (a.shape != (s, 64, 16) or b.shape != (s, 16, 128) or s < 1
            or a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16):
        raise ValueError(f"k16_probe takes bf16 (S, 64, 16) and (S, 16, "
                         f"128), got {a.dtype} {tuple(a.shape)} and "
                         f"{b.dtype} {tuple(b.shape)}")
    if a.device.type == "cpu":
        ref = k16_probe_ref(a, b)
        return ref, ref.clone()
    a, b = a.contiguous(), b.contiguous()
    out_mma = torch.empty((s, 64, 128), dtype=torch.float32, device=a.device)
    out_wg = torch.empty_like(out_mma)
    fn = function("sa_matmul", "sa_k16_probe_launch",
                  [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p])
    err = fn(a.data_ptr(), b.data_ptr(), out_mma.data_ptr(),
             out_wg.data_ptr(), s,
             torch.cuda.current_stream(a.device).cuda_stream)
    check(err, "sa_k16_probe")
    return out_mma, out_wg


def _launch_tc(route, a, a_kcont, lda, w, w_ncont, ldw, bias, scale,
               scale_dev, act, mode, out, raw, planes, tile=None):
    """One launch of the tensor-core kernel (`mma` or `split3`) → (its
    tile, the bytes of the operands it reads). The kernel's A carries the
    pieces: under `split3` with the fp32 operand on the weight side the
    problem is transposed (C^T = W^T A^T) and written back through the
    output's strides. An `mma` launch with no `tile` takes the
    autotuner's (`autotune.lookup`: the cached winner for (M, N, K,
    epilogue), else `mma_plan`'s heuristic; on the meta route the
    heuristic's)."""
    from .build import check, function

    m, k = a.shape
    n = w.shape[1]
    trans = route == "split3" and a.dtype == torch.bfloat16
    if trans:   # A' = W^T (fp32), B' = A^T; C' (n, m) into out (m, n)
        A, A_kc, A_ld, B, B_kc, B_ld = w.t(), not w_ncont, ldw, a.t(), \
            a_kcont, lda
        M, N, ldo = n, m, (1, n)
    else:
        A, A_kc, A_ld, B, B_kc, B_ld = a, a_kcont, lda, w, not w_ncont, ldw
        M, N, ldo = m, n, (n, 1)
    # storage views: A (M, K) stored K-contiguous or as (K, M); B (K, N)
    # stored K-contiguous as (N, K) or as (K, N)
    a_st = A if A_kc else A.t()
    b_st = B.t() if B_kc else B
    b_st, ldb = _aligned(b_st, B_ld)
    if route == "split3":
        if planes is None:
            planes, lda_k = _split3_planes(a_st, A_ld)
        else:
            lda_k = planes.shape[2]
        a_ptr, a_plane = planes.data_ptr(), planes.shape[1] * lda_k
    else:
        a_st, lda_k = _aligned(a_st, A_ld)
        a_ptr, a_plane = a_st.data_ptr(), 0
    sms = _sm_count(out.device)
    if tile is None and route == "mma" and not out.is_meta:
        # the tuned tile, or mma_plan's own where the cache has none
        tile = autotune.lookup(M, N, k, epilogue=act, sms=sms)
    plan = mma_plan(M, N, route, sms, tile)
    read = (M * k * 2 * plan["npiece"] + b_st.shape[0] * b_st.shape[1]
            * b_st.element_size() + (0 if bias is None else 4 * n))
    if out.is_meta:
        return plan["tile"], read
    fn = function("sa_matmul", "sa_mma_launch", MMA_ARGTYPES)
    err = fn(a_ptr, plan["npiece"], int(A_kc), lda_k, a_plane,
             b_st.data_ptr(), int(B_kc), ldb,
             None if bias is None else bias.data_ptr(), int(trans),
             out.data_ptr(), None if raw is None else raw.data_ptr(), *ldo,
             1.0 if scale is None or scale_dev is not None else float(scale),
             None if scale_dev is None else scale_dev.data_ptr(),
             M, N, k, _ACT_CODE[act], int(mode == "approx"),
             MMA_TILES[plan["tile"]].code,
             torch.cuda.current_stream(out.device).cuda_stream)
    check(err, f"sa_matmul ({route})")
    TILE_LAUNCHES[plan["tile"]] += 1
    return plan["tile"], read


def _copied(t):
    """An operand a launch copied first: counted in OPERAND_COPIES, or on
    the meta route for the cost counters."""
    global OPERAND_COPIES
    if t.is_meta:
        tally.kernel("operand_copy")
    else:
        OPERAND_COPIES += 1


def _launch(a, w, bias, scale, act, mode, save_raw, planes=None,
            tile=None, kind="sa_matmul"):
    """One kernel launch: (out, raw or None), both (M, N) fp32. `planes`:
    the fp32 operand's three bf16 pieces, already split (`split3` only);
    `tile` forces the `mma` route's tile (`mma_plan`; sweeps and tests).
    `kind` names the launch for the cost counters on the meta route
    (`sa_matmul`, or `sa_matmul_bwd` for the backward's GEMMs)."""
    from .build import check, function

    _check_args(a, w, bias, act, mode)
    if a.ndim != 2 or w.ndim != 2:
        raise ValueError("sa_matmul_cuda takes 2-D operands")
    for t in (a, w) + (() if bias is None else (bias,)):
        if not (t.is_cuda or t.is_meta) or t.device != a.device:
            raise ValueError("sa_matmul_cuda needs every operand on one "
                             "CUDA device (or the meta device)")
    if a.dtype not in _DTYPE_CODE or w.dtype not in _DTYPE_CODE:
        raise ValueError(f"sa_matmul_cuda takes bf16 or fp32 operands, got "
                         f"{a.dtype} @ {w.dtype}")
    bias = None if bias is None else bias.to(torch.float32).contiguous()
    scale_dev = None
    if isinstance(scale, torch.Tensor):
        if scale.numel() != 1 or scale.device != a.device:
            raise ValueError("a tensor scale must hold one value on the "
                             "operands' device")
        scale_dev = scale.detach().to(torch.float32).reshape(1).contiguous()
    m, k = a.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    raw = (torch.empty((m, n), dtype=torch.float32, device=a.device)
           if save_raw else None)
    if m == 0 or n == 0:
        return out, raw
    a0, w0 = a, w
    a, a_kcont, lda = _operand(a)
    w, w_ncont, ldw = _operand(w)
    for t, t0 in ((a, a0), (w, w0)):
        if t is not t0:
            _copied(t)
    route = gemm_route(m, a.dtype, w.dtype, a_kcont, w_ncont)
    written = m * n * 4 * (2 if save_raw else 1)
    if route in ("mma", "split3"):
        tile, read = _launch_tc(route, a, a_kcont, lda, w, w_ncont, ldw,
                                bias, scale, scale_dev, act, mode, out, raw,
                                planes, tile)
        if out.is_meta:
            tally.kernel(kind, route=route, tile=tile,
                         flops=2 * m * n * k, nbytes=read + written)
        else:
            ROUTE_LAUNCHES[route] += 1
        return out, raw
    tiled = route == "simt"
    if not tiled:
        a, w = a.contiguous(), w.contiguous()
        lda, ldw = k, n
    plan = fp32_launch(m, n, k, route)
    # the workspace holds the slices' sums (partial) or the parts' (simt)
    ws = (torch.empty((plan["workspace"], m, n), dtype=torch.float32,
                      device=a.device) if plan["workspace"] else out)
    if out.is_meta:
        tally.kernel(kind, route=route, flops=2 * m * n * k,
                     nbytes=(m * k * a.element_size()
                             + k * n * w.element_size()
                             + (0 if bias is None else 4 * n) + written))
        return out, raw
    fn = function("sa_matmul", "sa_matmul_launch",
                  ([ctypes.c_void_p] + [ctypes.c_int] * 3) * 2
                  + [ctypes.c_void_p] * 4 + [ctypes.c_float, ctypes.c_void_p]
                  + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    err = fn(a.data_ptr(), _DTYPE_CODE[a.dtype], int(a_kcont), lda,
             w.data_ptr(), _DTYPE_CODE[w.dtype], int(w_ncont), ldw,
             None if bias is None else bias.data_ptr(), ws.data_ptr(),
             out.data_ptr(), None if raw is None else raw.data_ptr(),
             1.0 if scale is None or scale_dev is not None else float(scale),
             None if scale_dev is None else scale_dev.data_ptr(),
             m, n, k, plan["slices"], plan["per_part"], _ACT_CODE[act],
             int(mode == "approx"), int(tiled),
             torch.cuda.current_stream(a.device).cuda_stream)
    check(err, f"sa_matmul ({route})")
    ROUTE_LAUNCHES[route] += 1
    return out, raw


def sa_matmul_cuda(a: torch.Tensor, w: torch.Tensor,
                   bias: torch.Tensor | None = None, scale=None, *,
                   act: str = "none", mode: str = "exact",
                   save_raw: bool = False):
    """Launch the SA GEMM kernel: a (M, K) and w (K, N), each bf16 or fp32
    (row-major or a transposed view), on one CUDA device, bias (N,) or
    None → (M, N) fp32 (and the raw accumulator with `save_raw`).
    `scale` is a float or a 1-element tensor on the device, which the
    epilogue reads there (no host sync)."""
    global LAUNCHES
    out, raw = _launch(a, w, bias, scale, act, mode, save_raw)
    if not out.is_meta:
        LAUNCHES += 1
        MODE_LAUNCHES[mode] += 1
    return (out, raw) if save_raw else out


def backward_gemms_ref(a: torch.Tensor, w: torch.Tensor, dus: torch.Tensor):
    """Plain version of the two backward GEMMs: (dus·Wᵀ, Aᵀ·dus) in fp32."""
    global BWD_PLAIN_CALLS
    BWD_PLAIN_CALLS += 2
    w32, a32 = w.to(torch.float32), a.to(torch.float32)
    return torch.matmul(dus, w32.t()), torch.matmul(a32.t(), dus)


def backward_gemms(a: torch.Tensor, w: torch.Tensor, dus: torch.Tensor,
                   planes: torch.Tensor | None = None):
    """dA = dus·Wᵀ (M, K) and dW = Aᵀ·dus (K, N), fp32, exact mode, no
    epilogue: on a CUDA tensor two kernel launches, reading Wᵀ and Aᵀ
    through their strides; on the CPU the plain version. With a bf16 A or
    W the fp32 dus is split once into three bf16 pieces (`split3`), shared
    by both GEMMs; `planes` passes that split in (tests plant faults
    there)."""
    global BWD_LAUNCHES
    if dus.device.type == "cpu":
        return backward_gemms_ref(a, w, dus)
    dus = dus.to(torch.float32).contiguous()
    if planes is None and torch.bfloat16 in (a.dtype, w.dtype):
        planes, _ = _split3_planes(dus, dus.shape[1])
    da, _ = _launch(dus, w.t(), None, None, "none", "exact", False, planes,
                    kind="sa_matmul_bwd")
    dw, _ = _launch(a.t(), dus, None, None, "none", "exact", False, planes,
                    kind="sa_matmul_bwd")
    if not dus.is_meta:
        BWD_LAUNCHES += 2
    return da, dw


class SAMatmulFn(torch.autograd.Function):
    """The SA GEMM with its gradient (the JAX package's `_sa_matmul_vjp`).

    forward(a, w, bias, scale, act, mode) → (M, N) fp32. `scale` is None,
    a float (a constant) or a 1-element tensor (differentiable)."""

    @staticmethod
    def forward(ctx, a, w, bias, scale, act, mode):
        has_scale = scale is not None
        # the raw accumulator only for the activation jacobian or a real
        # dscale (`_GemmCfg.needs_raw`); plain projections skip it
        needs_raw = act != "none" or has_scale
        if a.device.type == "cpu":
            out = sa_matmul_ref(a, w, bias, scale, act=act, mode=mode,
                                save_raw=needs_raw)
        else:
            out = sa_matmul_cuda(a, w, bias, scale, act=act, mode=mode,
                                 save_raw=needs_raw)
        y, raw = out if needs_raw else (out, None)
        scale_t = scale if isinstance(scale, torch.Tensor) else None
        ctx.save_for_backward(a, w, bias, scale_t, raw)
        ctx.act = act
        ctx.scale_f = None if scale_t is not None or scale is None else \
            float(scale)
        return y

    @staticmethod
    def backward(ctx, dy):
        a, w, bias, scale_t, raw = ctx.saved_tensors
        dy = dy.to(torch.float32)
        if scale_t is not None:
            scale32 = scale_t.to(torch.float32).reshape(())
        else:
            scale32 = 1.0 if ctx.scale_f is None else ctx.scale_f
        dscale = None
        if raw is None:        # act == "none", no scale: a linear VJP
            du = dy
        else:
            u = raw * scale32
            if bias is not None:
                u = u + bias.to(torch.float32)
            if ctx.act == "none":
                du = dy
            else:
                with torch.enable_grad():
                    ut = u.detach().requires_grad_(True)
                    (du,) = torch.autograd.grad(apply_act(ut, ctx.act), ut,
                                                dy)
            if scale_t is not None:
                dscale = torch.sum(du * raw).to(scale_t.dtype).reshape(
                    scale_t.shape)
        dbias = (torch.sum(du, dim=0).to(bias.dtype) if bias is not None
                 else None)
        dus = du if scale_t is None and ctx.scale_f is None else du * scale32
        da, dw = backward_gemms(a, w, dus)
        return da.to(a.dtype), dw.to(w.dtype), dbias, dscale, None, None


def needs_grad(*tensors) -> bool:
    """Whether autograd records a call on these tensors."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def _route_of(a, w) -> str:
    """The route `sa_matmul_cuda` takes for these operands."""
    a2 = a.reshape(-1, a.shape[-1]) if a.ndim != 2 else a
    _, a_kc, _ = _operand(a2)
    _, w_nc, _ = _operand(w)
    return gemm_route(a2.shape[0], a.dtype, w.dtype, a_kc, w_nc)


def chain_terms(k: int, route: str) -> float:
    """Units of 2⁻²⁴·Σ|a||w| by which kernel and plain version may differ
    on a K-deep sum, per route (see `error_bound`)."""
    steps = -(-k // 16)               # fp32 adds of the k16 steps' sums
    if route == "mma":                # 16 exact products a step; plain K
        return 2 * (16 + 16 // TC_GROUP) + steps + k
    if route == "split3":             # 48 a step, pieces ≤ (1 + 2⁻⁶)|x|;
        return (2 * (48 + 48 // TC_GROUP) * (1 + 2.0 ** -6) + steps
                + 2 * k)              # plain: K sums, K rounded products
    return 2 * k                      # simt, partial: fp32 chains both


def error_bound(a: torch.Tensor, w: torch.Tensor, scale=None,
                mode: str = "exact", y: torch.Tensor | None = None,
                route: str | None = None) -> torch.Tensor:
    """Per-output bound on |kernel − plain|, for the route the kernel takes
    on these operands (`gemm_route`; `route` overrides it).

    The plain version is fp32 `torch.matmul` of the upcast operands: its
    K − 1 fp32 additions each err by at most 2⁻²⁴ of a partial sum, and a
    product with an fp32 operand is rounded once (or fused), so it is
    within 2·K·2⁻²⁴·Σ|a||w| of the exact sum whatever its order (R1);
    counted closer, the products' roundings (each under 2⁻²⁴ of its own
    product) add up to one unit, so within K units.

    * `simt`, `partial` (fp32 FMA chains over the slices of `fp32_k_plan`,
      folded in order): a slice's n ≤ FP32_SLICE FMAs each err by at most
      2⁻²⁴ of a partial sum of the slice, and the folds' first additions
      (to zero) are exact, so the kernel is within min(K, FP32_SLICE) +
      slices − 1 ≤ K units, and the plain version within K: together at
      most 2·K units (2⁻²⁴·Σ|a||w|) for bf16 and fp32 operands alike.
    * `mma` (bf16 × bf16 on tensor cores): the products are exact. Each
      k16 step's 16 products are summed by the tensor cores from zero,
      and they do not round each addition: a group of n_g ≥ TC_GROUP
      products and the running sum are aligned to the largest exponent
      and truncated, then added, and the sum is truncated once more (Fasi
      et al., 2021). That is n_g + 1 errors a group, each under 2⁻²³ of
      the step's Σ|a||w| (S_s): ≤ (16 + 4)·2⁻²³·S_s a step, 40 units of
      S_s, and 40 units of Σ|a||w| over all steps. Each step's sum is
      then added to the fp32 accumulator, rounded to nearest: ⌈K/16⌉
      additions, each within 2⁻²⁴ of a partial sum ≤ Σ|a||w|. The plain
      version (exact bf16 products) is within K units: together
      40 + ⌈K/16⌉ + K.
    * `split3` (fp32 x against bf16 w): x = hi + mid + lo exactly
      (`split3_ref`), each piece × w is exact, so a step sums 48 exact
      products with |hi| + |mid| + |lo| ≤ (1 + 2⁻⁶)·|x|: 2·(48 + 12)·
      (1 + 2⁻⁶) units, plus the ⌈K/16⌉ additions, plus the plain
      version's 2K.

    Approx mode adds one truncation quantum (8 ulp of the chain, ≤
    2⁻¹⁹·Σ|a||w|); the epilogue's activation (slope ≤ 1.13) and its own
    roundings add a few ulp of |y|. Nothing else widens it.

    This bound holds for any order of the sums, and so it is far wider
    than what a kernel that drops the split would err by: at K = 5120,
    2·K·2⁻²⁴·Σ|a||w| is ~3·t for t a typical |a·w| sum with random signs,
    while rounding dus once to bf16 errs by ~√K·2⁻⁹·t/√3 ≈ 0.08·t.
    `split_check` is the sharper test that catches that fault (and a
    kernel that left the truncation on the running sum)."""
    k = a.shape[-1]
    route = route or _route_of(a, w)
    s = abs(1.0 if scale is None else float(scale))
    mag = torch.matmul(a.to(torch.float32).abs(), w.to(torch.float32).abs())
    bound = chain_terms(k, route) * 2.0 ** -24 * mag
    if mode == "approx":
        bound = bound + 2.0 ** -19 * mag
    bound = 1.13 * s * bound
    if y is not None:
        bound = bound + 2.0 ** -20 * y.abs()
    return bound + 1e-30


# the split check's constant: its allowance over the typical size of the
# tensor-core kernel's own error (see `split_check`)
SPLIT_CHECK_C = 4


def split_check(a: torch.Tensor, w: torch.Tensor, y: torch.Tensor,
                route: str | None = None) -> float:
    """The sharper check of a tensor-core GEMM y ≈ a @ w (no epilogue):
    R = max_ij |y − e|_ij / (E_lib + T_ij), with e the fp64 product, E_lib
    = max_ij |fp32 torch.matmul(a, w) − e| (TF32 off: the library's own
    fp32 error) and T_ij the typical size of the kernel's error, times
    SPLIT_CHECK_C:

        T_ij = C·2⁻²³·(√⌈K/16⌉·(|e_ij| + σ_ij) + 64·n·σ_ij),
        σ_ij = √(Σ_k a_ik² w_kj²)   (the random walk of the partial sums),

    n the pieces a step (3 for `split3`, 1 for `mma`). The first term is
    the ⌈K/16⌉ round-to-nearest additions of the steps' sums into the
    accumulator (each within 2⁻²⁴ of a partial sum of size |e| + σ, signs
    at random); the second the tensor cores' truncation inside the steps
    (≤ (16n + 4n)·2⁻²³ of a step's magnitude, at random across steps:
    ~10·n·2⁻²³·σ, with room). A right kernel gives R well under 1. One
    that rounds the fp32 operand once to bf16 errs by ~2⁻⁹·σ/√3 an output
    (~1.1e-3·σ, against T ≈ 1e-4·σ at K = 5120 and ≈ 2e-4·σ at K =
    153600): R > 1. One that leaves the truncation on the running sum errs
    by ~(3K/16)/4 units of 2⁻²³·σ, growing with K. Dropping only the lo
    piece errs by ~2⁻¹⁷·σ and is not caught. Returns R."""
    k = a.shape[-1]
    route = route or _route_of(a, w)
    pieces = 3 if route == "split3" else 1
    a64, w64 = a.to(torch.float64), w.to(torch.float64)
    e = torch.matmul(a64, w64)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        lib = torch.matmul(a.to(torch.float32), w.to(torch.float32))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    e_lib = float((lib.to(torch.float64) - e).abs().max())
    del lib
    sigma = torch.matmul(a64 * a64, w64 * w64).sqrt_()
    t = (SPLIT_CHECK_C * 2.0 ** -23) * (
        math.sqrt(-(-k // 16)) * (e.abs() + sigma) + 64 * pieces * sigma)
    del sigma, a64, w64
    return float(((y.to(torch.float64) - e).abs() / (e_lib + t + 1e-300))
                 .max())
