"""SA GEMM: the paper's column contract as a hand-written Hopper kernel.

Replaces the TPU kernel `repro/kernels/sa_matmul.py` `_matmul_kernel`
(its `pallas_call` in `_pallas_fused`): an (M, K) @ (K, N) product whose
fp32 accumulator is never rounded mid-chain, followed by one epilogue in
this order — `truncate_mantissa` (approx only) → × scale → + bias → act —
and one fp32 write.

The kernel (`csrc/sa_matmul.cu`) is a SIMT FMA kernel. At the serving
shapes it is bound by bytes: decode runs at M = batch (4), so every weight
element is read once for 2·M flops, far below the card's ~295 flops per
byte. Its design therefore spends its effort on reading the bf16 weights
once and coalesced: a block owns 64 output columns and up to 8 rows of A,
warps stride over K, and K is split across blocks (deterministic split-K,
partials reduced in a fixed order by a second kernel that also runs the
epilogue) so that narrow N (1024 for wk/wv) still fills the 132 SMs. At
prefill M the same kernel re-reads each weight tile once per 8 rows of A
from L2; it is not a tensor-core kernel (`wgmma` is later work).

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

LAUNCHES = 0       # kernel launches through `sa_matmul_cuda`
PLAIN_CALLS = 0    # calls of the plain version `sa_matmul_ref`

_ACT_CODE = {a: i for i, a in enumerate(EPILOGUES)}
_COLS_PER_BLOCK = 64
_ROWS_PER_BLOCK = 8


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
                  act: str = "none", mode: str = "exact") -> torch.Tensor:
    """Plain version: fp32 `torch.matmul` of the upcast operands, then the
    epilogue in the kernel's order. `a` may carry batch dimensions."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    _check_args(a, w, bias, act, mode)
    y = torch.matmul(a.to(torch.float32), w.to(torch.float32))
    if mode == "approx":
        y = truncate_mantissa(y)
    if isinstance(scale, torch.Tensor):
        y = y * scale.to(device=y.device, dtype=torch.float32).reshape(())
    elif scale is not None:
        y = y * float(scale)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return apply_act(y, act)


def split_k(m: int, n: int, k: int, sms: int = 132) -> int:
    """K slices so that the grid holds about two blocks per SM, each slice
    at least 256 deep."""
    base = -(-n // _COLS_PER_BLOCK) * -(-m // _ROWS_PER_BLOCK)
    want = -(-2 * sms // base)
    return max(1, min(want, k // 256, 64))


_SMS: dict = {}


def _sm_count(device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def sa_matmul_cuda(a: torch.Tensor, w: torch.Tensor,
                   bias: torch.Tensor | None = None, scale=None, *,
                   act: str = "none", mode: str = "exact") -> torch.Tensor:
    """Launch the SA GEMM kernel: a (M, K) and w (K, N) bf16 on one CUDA
    device, bias (N,) fp32 or None → (M, N) fp32. `scale` is a float or a
    1-element tensor on the device, which the epilogue reads there (no
    host sync)."""
    global LAUNCHES
    from .build import check, function

    _check_args(a, w, bias, act, mode)
    if a.ndim != 2 or w.ndim != 2:
        raise ValueError("sa_matmul_cuda takes 2-D operands")
    for t in (a, w) + (() if bias is None else (bias,)):
        if not t.is_cuda or t.device != a.device:
            raise ValueError("sa_matmul_cuda needs every operand on one "
                             "CUDA device")
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"sa_matmul_cuda takes bf16 operands, got "
                         f"{a.dtype} @ {w.dtype}")
    a, w = a.contiguous(), w.contiguous()
    bias = None if bias is None else bias.to(torch.float32).contiguous()
    scale_dev = None
    if isinstance(scale, torch.Tensor):
        if scale.numel() != 1 or scale.device != a.device:
            raise ValueError("a tensor scale must hold one value on the "
                             "operands' device")
        scale_dev = scale.to(torch.float32).reshape(1).contiguous()
    m, k = a.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    ks = split_k(m, n, k, _sm_count(a.device))
    kslice = -(-k // ks)
    ws = torch.empty((ks, m, n), dtype=torch.float32, device=a.device)
    fn = function("sa_matmul", "sa_matmul_launch",
                  [ctypes.c_void_p] * 5 + [ctypes.c_float, ctypes.c_void_p]
                  + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    err = fn(a.data_ptr(), w.data_ptr(),
             None if bias is None else bias.data_ptr(),
             ws.data_ptr(), out.data_ptr(),
             1.0 if scale is None or scale_dev is not None else float(scale),
             None if scale_dev is None else scale_dev.data_ptr(),
             m, n, k, ks, kslice, _ACT_CODE[act], int(mode == "approx"),
             torch.cuda.current_stream(a.device).cuda_stream)
    check(err, "sa_matmul")
    LAUNCHES += 1
    return out


def error_bound(a: torch.Tensor, w: torch.Tensor, scale=None,
                mode: str = "exact", y: torch.Tensor | None = None
                ) -> torch.Tensor:
    """Per-output bound on |kernel − plain| (R1): two fp32 sums of the same
    K exact products in different orders differ by at most
    2·K·2⁻²⁴·Σ|a||w|; approx mode adds one truncation quantum (8 ulp of
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
