"""Dispatch for the port's kernels.

A CPU tensor goes to the kernel's plain PyTorch version; a CUDA tensor goes
to the hand-written kernel, which launches or raises. There is no fallback
from the kernel to the plain version. A meta tensor (the dry run,
`launch/dryrun.py`) goes to the kernel's wrapper too and takes its meta
route: the launch's checks and plan, a meta output, and a record for the
cost counters (`core/tally.py`) in place of the launch.

Each kernel module keeps two plain integers: `LAUNCHES` (kernel launches)
and `PLAIN_CALLS` (calls of its plain version). `counts()` reads them and
`reset_counts()` sets them to 0, so a run can show which path it took
(a meta route moves none of them);
`route_counts()` splits the SA GEMM's launches (forward and backward) and
the prefill kernel's by route, `tile_counts()` the SA GEMM's tensor-core
launches by tile, `operand_copies()` counts the operands its launches
copied to a layout the kernel reads, and `mode_counts()` splits the launches of
the kernels that run the bulk tier's arithmetic by the policy's mode
(`exact` or `approx`), so a run can show that an approximate decode chunk
really ran the approximate datapath.
"""
from __future__ import annotations

import torch

from . import fp_emu as _emu
from . import quantize as _quant
from . import sa_attention as _attn
from . import sa_decode_attention as _decode
from . import sa_matmul as _mm
from .quantize import amax_scale
from .sa_decode_attention import fused_decode_supported

_MODULES = {"sa_matmul": _mm, "paged_decode": _decode,
            "prefill_attention": _attn, "quantize": _quant, "fp_emu": _emu}


def sa_matmul(a, w, *, bias=None, act: str = "none", scale=None,
              mode: str = "exact"):
    """(M, K) @ (K, N) under the SA contract with the fused epilogue
    `act(truncate?(acc) · scale + bias)`, fp32 out. Differentiable: where
    autograd records the call it goes through `SAMatmulFn`, whose backward
    GEMMs run the same kernel (the plain version on the CPU)."""
    if _mm.needs_grad(a, w, bias, scale):
        return _mm.SAMatmulFn.apply(a, w, bias, scale, act, mode)
    if a.device.type == "cpu":
        return _mm.sa_matmul_ref(a, w, bias, scale, act=act, mode=mode)
    return _mm.sa_matmul_cuda(a, w, bias, scale, act=act, mode=mode)


def paged_decode_attention(q, k_pool, v_pool, page_positions, block_table,
                           pos, **kw):
    """Paged decode attention over the block table (see
    sa_decode_attention.py)."""
    if q.device.type == "cpu":
        return _decode.paged_decode_ref(q, k_pool, v_pool, page_positions,
                                        block_table, pos, **kw)
    return _decode.paged_decode_cuda(q, k_pool, v_pool, page_positions,
                                     block_table, pos, **kw)


def sa_attention(q, k, v, **kw):
    """Prefill flash attention, q (B, T, H, hd), k/v (B, S, KVH, hd)."""
    if q.device.type == "cpu":
        return _attn.flash_attention_ref(q, k, v, **kw)
    return _attn.sa_attention_cuda(q, k, v, **kw)


def quantize_fp8(x, scale, fmt_name: str = "fp8_e4m3"):
    """`x · (1/scale)` rounded onto the FP8 grid, fp32 out (see
    quantize.py); `scale` a float or a 1-element tensor."""
    if x.device.type == "cpu":
        return _quant.quantize_fp8_ref(x, scale, fmt_name)
    return _quant.quantize_fp8_cuda(x, scale, fmt_name)


def sa_matmul_fp8(a, w, fmt_name: str = "fp8_e4m3", **kw):
    """FP8 GEMM: per-tensor scaled quantization of both operands (carried
    in bf16, which holds every FP8 value), then the SA GEMM with the
    descale sa·sw in its epilogue, before the single output rounding. The
    scales stay on the device."""
    sa_, sw = amax_scale(a, fmt_name), amax_scale(w, fmt_name)
    aq = quantize_fp8(a, sa_, fmt_name).to(torch.bfloat16)
    wq = quantize_fp8(w, sw, fmt_name).to(torch.bfloat16)
    return sa_matmul(aq, wq, scale=sa_ * sw, **kw)


def skewed_datapath_matmul(a, w, fmt_name: str = "bf16",
                           mode: str = "exact"):
    """(M, K) @ (K, N) through the bit-exact skewed PE chain (see
    fp_emu.py); ``mode="approx"`` is the coarse-LZA datapath."""
    if a.device.type == "cpu":
        return _emu.fma_emu_matmul_ref(a, w, fmt_name, mode)
    return _emu.fma_emu_matmul_cuda(a, w, fmt_name, mode)


def counts() -> dict[str, dict[str, int]]:
    """Launches and plain calls per kernel; `sa_matmul_bwd` counts the SA
    GEMM's backward GEMMs (dA and dW) apart from its forward, and
    `paged_decode_lse` those of paged decode's launches and plain calls
    that also gave the log-sum-exp (counted in `paged_decode` too)."""
    out = {name: {"launches": m.LAUNCHES, "plain_calls": m.PLAIN_CALLS}
           for name, m in _MODULES.items()}
    out["sa_matmul_bwd"] = {"launches": _mm.BWD_LAUNCHES,
                            "plain_calls": _mm.BWD_PLAIN_CALLS}
    out["paged_decode_lse"] = {"launches": _decode.LSE_LAUNCHES,
                               "plain_calls": _decode.LSE_PLAIN_CALLS}
    return out


def route_counts() -> dict[str, dict[str, int]]:
    """Launches by route: the SA GEMM's, forward and backward together
    (`sa_matmul.gemm_route`: `partial`, `mma`, `split3`, `simt`), and the
    prefill kernel's (`mma` for bf16 and fp16 inputs, `simt` for fp32)."""
    return {"sa_matmul": dict(_mm.ROUTE_LAUNCHES),
            "prefill_attention": dict(_attn.ROUTE_LAUNCHES)}


def tile_counts() -> dict[str, int]:
    """The SA GEMM's tensor-core launches (`mma` and `split3`, forward and
    backward) by tile (`sa_matmul.mma_plan`: `large`, on wgmma; `small`,
    `decode`; `split3`)."""
    return dict(_mm.TILE_LAUNCHES)


def operand_copies() -> int:
    """Operands the SA GEMM's launches copied first (a layout it cannot
    read in place, or a ragged leading dimension; sa_matmul._operand and
    _aligned)."""
    return _mm.OPERAND_COPIES


_MODE_MODULES = {"sa_matmul": _mm, "paged_decode": _decode,
                 "prefill_attention": _attn, "fp_emu": _emu}


def mode_counts() -> dict[str, dict[str, int]]:
    """Launches by mode: the SA GEMM's forward, paged decode, prefill
    attention (exact only: serving prefill is exact) and fp_emu."""
    return {name: dict(m.MODE_LAUNCHES) for name, m in _MODE_MODULES.items()}


def reset_counts():
    for m in _MODULES.values():
        m.LAUNCHES = 0
        m.PLAIN_CALLS = 0
    for counters in ([_attn.ROUTE_LAUNCHES, _mm.ROUTE_LAUNCHES,
                      _mm.TILE_LAUNCHES]
                     + [m.MODE_LAUNCHES for m in _MODE_MODULES.values()]):
        for key in counters:
            counters[key] = 0
    _mm.BWD_LAUNCHES = 0
    _mm.BWD_PLAIN_CALLS = 0
    _mm.OPERAND_COPIES = 0
    _decode.LSE_LAUNCHES = 0
    _decode.LSE_PLAIN_CALLS = 0


__all__ = ["sa_matmul", "sa_matmul_fp8", "skewed_datapath_matmul",
           "paged_decode_attention", "sa_attention", "quantize_fp8",
           "amax_scale", "fused_decode_supported", "counts", "route_counts",
           "tile_counts", "mode_counts", "operand_copies",
           "reset_counts"]
