"""Scaled FP8 quantization: plain version and the hand-written Hopper kernel.

Replaces the TPU kernel `repro/kernels/quantize.py` `_quantize_kernel`:
elementwise `x · (1/scale)` rounded onto the E4M3 / E5M2 grid (RNE on the
fp32 bit pattern, flush to +0 below the normal range after rounding,
saturate for E4M3, ±Inf for E5M2, NaN passes), fp32 values out, any shape
flattened. The reciprocal is taken once and multiplied, as the TPU kernel
does; its oracle `quantize_ref` divides, and the two can part on an FP8
rounding tie (ROADMAP R6). The port follows the kernel.

The kernel (`csrc/quantize.cu`) is bound by bytes: 8 per fp32 element
(4 read, 4 written; 6 for a bf16 input) against one multiply and a dozen
integer operations. It reads 16 bytes a thread (four fp32 or eight bf16
values) and reads `scale` from device memory, so a caller whose scale is
computed on the card (`amax_scale`) never waits on the host.

A meta tensor takes the kernel's meta route: the same checks and plan as
a CUDA tensor, then a meta output and a record for the cost counters
(`core/tally.py`) in place of the launch; the launch counters do not
move.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import tally

from repro_torch.core.fpformats import get_format, round_fp8

LAUNCHES = 0       # kernel launches through `quantize_fp8_cuda`
PLAIN_CALLS = 0    # calls of the plain version `quantize_fp8_ref`

FORMATS = ("fp8_e4m3", "fp8_e5m2")
_IN_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _fp8(fmt_name: str):
    fmt = get_format(fmt_name)
    if fmt.name not in FORMATS:
        raise ValueError(f"quantize_fp8 takes {FORMATS}, got {fmt.name!r}")
    return fmt


def _scale_tensor(scale, device) -> torch.Tensor:
    """`scale` as a 1-element fp32 tensor on `device` (a float becomes a
    fill on the device, not a copy from the host)."""
    if isinstance(scale, torch.Tensor):
        if scale.numel() != 1:
            raise ValueError(f"scale must hold one value, got "
                             f"{tuple(scale.shape)}")
        return scale.to(device=device, dtype=torch.float32).reshape(1)
    return torch.full((1,), float(scale), dtype=torch.float32, device=device)


def quantize_fp8_ref(x: torch.Tensor, scale, fmt_name: str = "fp8_e4m3"
                     ) -> torch.Tensor:
    """Plain version: `round_fp8(x · (1/scale))` in fp32, shape kept."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    fmt = _fp8(fmt_name)
    inv = torch.reciprocal(_scale_tensor(scale, x.device))
    return round_fp8(x.to(torch.float32) * inv, fmt)


def quantize_fp8_cuda(x: torch.Tensor, scale, fmt_name: str = "fp8_e4m3"
                      ) -> torch.Tensor:
    """Launch the quantize kernel on a CUDA tensor (fp32 or bf16; other
    float types are converted to fp32 first) → fp32 of the same shape."""
    global LAUNCHES
    from .build import check, function

    fmt = _fp8(fmt_name)
    if not (x.is_cuda or x.is_meta):
        raise ValueError("quantize_fp8_cuda needs a CUDA (or meta) tensor")
    if x.dtype not in _IN_CODE:
        x = x.to(torch.float32)
    x = x.contiguous()
    s = _scale_tensor(scale, x.device).contiguous()
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    n = x.numel()
    if n == 0:
        return out
    if x.is_meta:
        tally.kernel("quantize", nbytes=n * (x.element_size() + 4) + 4)
        return out
    fn = function("quantize", "quantize_fp8_launch",
                  [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                  + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    err = fn(x.data_ptr(), s.data_ptr(), out.data_ptr(), n, _IN_CODE[x.dtype],
             int(fmt.name == "fp8_e4m3"),
             torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "quantize_fp8")
    LAUNCHES += 1
    return out


def amax_scale(x: torch.Tensor, fmt_name: str = "fp8_e4m3") -> torch.Tensor:
    """Per-tensor scale mapping amax onto the format's max finite value,
    a 0-d fp32 tensor on `x`'s device: `max(amax / max_finite, 1e-12)`.
    The divisor is a tensor on the same device, so the card divides too
    (a host scalar would be multiplied by its reciprocal there)."""
    fmt = get_format(fmt_name)
    amax = x.detach().to(torch.float32).abs().amax()
    d = torch.full((), fmt.max_finite, dtype=torch.float32, device=x.device)
    return torch.clamp_min(amax / d, 1e-12)
