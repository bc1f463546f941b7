"""SA GEMM: the paper's column contract as a hand-written Hopper kernel,
forward and backward.

Replaces the TPU kernel `repro/kernels/sa_matmul.py` `_matmul_kernel`
(its `pallas_call` in `_pallas_fused`) and its custom VJP
(`_sa_matmul_fwd` / `_sa_matmul_bwd`): an (M, K) @ (K, N) product whose
fp32 accumulator is never rounded mid-chain, followed by one epilogue in
this order — `truncate_mantissa` (approx only) → × scale → + bias → act —
and one fp32 write, optionally beside the raw fp32 accumulator (taken
after the truncation, before the scale) that the backward needs.

The kernel (`csrc/sa_matmul.cu`) is SIMT fp32 FMA in two shapes. At the
serving shapes (M < 256) it is bound by bytes: decode runs at M = batch
(4), so every weight element is read once for 2·M flops, far below the
card's ~295 flops per byte; a block owns 64 output columns and up to 8
rows of A and K is split across blocks (deterministic split-K, partials
reduced in a fixed order by a second kernel that also runs the epilogue)
so that narrow N (1024 for wk/wv) still fills the 132 SMs. At training
shapes (1024 tokens a microbatch) and in every backward GEMM it is bound
by fp32 FMAs: a 128 × 128 output tile per block, 8 × 8 per thread, K
tiles staged in shared memory, each operand read in place through its
strides (Wᵀ and Aᵀ are views, never copies, and W is never upcast in
memory). Neither uses tensor cores (`wgmma` is later work).

`SAMatmulFn` is the gradient, as the JAX package's VJP: the raw
accumulator is kept only when the activation or a real scale needs it,
`du` is the activation's VJP at `u = raw·scale + bias`, and dA = du·s·Wᵀ
and dW = Aᵀ·du·s run through the same kernel with fp32 operands in exact
mode (the approx tier is forward only). On a CPU tensor every GEMM runs
the plain version.

The sum's order differs from XLA's and from the plain version's; the
contract holds it to a reassociation bound (`error_bound`).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

EPILOGUES = ("none", "relu", "gelu", "silu")
MODES = ("exact", "approx")

# the approximate-normalization ("bulk" tier) model: drop the low
# APPROX_DROP_BITS mantissa bits of the fp32 chain (RTZ) before the epilogue
APPROX_DROP_BITS = 3

LAUNCHES = 0          # forward kernel launches (`sa_matmul_cuda`)
PLAIN_CALLS = 0       # calls of the plain version `sa_matmul_ref`
BWD_LAUNCHES = 0      # backward GEMM launches (dA and dW: two a backward)
BWD_PLAIN_CALLS = 0   # backward GEMMs through the plain version

_ACT_CODE = {a: i for i, a in enumerate(EPILOGUES)}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_COLS_PER_BLOCK = 64
_ROWS_PER_BLOCK = 8
_TILE = 128           # the tiled kernel's output tile (rows and columns)
_TILE_K = 16          # ... and its K stage depth
TILED_MIN_M = 256     # rows from which the forward takes the tiled kernel


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


def split_k(m: int, n: int, k: int, sms: int = 132) -> int:
    """K slices of the small-M kernel: about two blocks per SM, each slice
    at least 256 deep."""
    base = -(-n // _COLS_PER_BLOCK) * -(-m // _ROWS_PER_BLOCK)
    want = -(-2 * sms // base)
    return max(1, min(want, k // 256, 64))


def tiled_split_k(m: int, n: int, k: int, sms: int = 132) -> int:
    """K slices of the tiled kernel: two waves of two blocks per SM where
    the output tiles alone give fewer, each slice at least 1024 deep."""
    base = -(-m // _TILE) * -(-n // _TILE)
    want = -(-4 * sms // base)
    return max(1, min(want, k // 1024, 16))


_SMS: dict = {}


def _sm_count(device) -> int:
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


def _launch(a, w, bias, scale, act, mode, save_raw):
    """One kernel launch: (out, raw or None), both (M, N) fp32."""
    from .build import check, function

    _check_args(a, w, bias, act, mode)
    if a.ndim != 2 or w.ndim != 2:
        raise ValueError("sa_matmul_cuda takes 2-D operands")
    for t in (a, w) + (() if bias is None else (bias,)):
        if not t.is_cuda or t.device != a.device:
            raise ValueError("sa_matmul_cuda needs every operand on one "
                             "CUDA device")
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
    a, a_kcont, lda = _operand(a)
    w, w_ncont, ldw = _operand(w)
    tiled = m >= TILED_MIN_M or not (a_kcont and w_ncont)
    sms = _sm_count(a.device)
    if tiled:
        ks = tiled_split_k(m, n, k, sms)
        kslice = -(-(-(-k // ks)) // _TILE_K) * _TILE_K
    else:
        a, w = a.contiguous(), w.contiguous()
        lda, ldw = k, n
        ks = split_k(m, n, k, sms)
        kslice = -(-k // ks)
    # with one K slice the partial sums go straight to the output
    ws = out if ks == 1 else torch.empty((ks, m, n), dtype=torch.float32,
                                         device=a.device)
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
             m, n, k, ks, kslice, _ACT_CODE[act], int(mode == "approx"),
             int(tiled), torch.cuda.current_stream(a.device).cuda_stream)
    check(err, "sa_matmul")
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
    LAUNCHES += 1
    return (out, raw) if save_raw else out


def backward_gemms_ref(a: torch.Tensor, w: torch.Tensor, dus: torch.Tensor):
    """Plain version of the two backward GEMMs: (dus·Wᵀ, Aᵀ·dus) in fp32."""
    global BWD_PLAIN_CALLS
    BWD_PLAIN_CALLS += 2
    w32, a32 = w.to(torch.float32), a.to(torch.float32)
    return torch.matmul(dus, w32.t()), torch.matmul(a32.t(), dus)


def backward_gemms(a: torch.Tensor, w: torch.Tensor, dus: torch.Tensor):
    """dA = dus·Wᵀ (M, K) and dW = Aᵀ·dus (K, N), fp32, exact mode, no
    epilogue: on a CUDA tensor two kernel launches, reading Wᵀ and Aᵀ
    through their strides; on the CPU the plain version."""
    global BWD_LAUNCHES
    if dus.device.type == "cpu":
        return backward_gemms_ref(a, w, dus)
    dus = dus.to(torch.float32).contiguous()
    da, _ = _launch(dus, w.t(), None, None, "none", "exact", False)
    dw, _ = _launch(a.t(), dus, None, None, "none", "exact", False)
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


def error_bound(a: torch.Tensor, w: torch.Tensor, scale=None,
                mode: str = "exact", y: torch.Tensor | None = None
                ) -> torch.Tensor:
    """Per-output bound on |kernel − plain| (R1). Each fp32 sum of the K
    products is within (K−1)·2⁻²⁴·Σ|a||w| of the exact sum, whatever its
    order; a product of two bf16 values is exact in fp32, and a product
    with an fp32 operand (the backward GEMMs) is either fused into the
    FMA or rounded once, which adds at most one more 2⁻²⁴·|a||w| per term.
    So two implementations differ by at most 2·K·2⁻²⁴·Σ|a||w| for bf16 and
    fp32 operands alike. Approx mode adds one truncation quantum (8 ulp of
    the chain, ≤ 2⁻¹⁹·Σ|a||w|); the epilogue's activation (slope ≤ 1.13)
    and its own roundings add a few ulp of |y|."""
    k = a.shape[-1]
    s = abs(1.0 if scale is None else float(scale))
    mag = torch.matmul(a.to(torch.float32).abs(), w.to(torch.float32).abs())
    bound = 2.0 * k * 2.0 ** -24 * mag
    if mode == "approx":
        bound = bound + 2.0 ** -19 * mag
    bound = 1.13 * s * bound
    if y is not None:
        bound = bound + 2.0 ** -20 * y.abs()
    return bound + 1e-30
