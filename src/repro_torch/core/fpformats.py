"""Reduced-precision floating-point formats (paper Fig. 1), in PyTorch.

Each format has a descriptor plus torch helpers used by
``core.precision`` (the GEMM precision policy). `quantize` is bit-exact
with the JAX package's `fpformats.quantize`:

  * subnormals are flushed to zero (FTZ) on encode,
  * FP8 E4M3 saturates to its max finite value; E5M2 overflows to Inf,
  * rounding is round-to-nearest-even, done once.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FPFormat:
    """A sign/exponent/mantissa floating-point format descriptor."""

    name: str
    exp_bits: int
    man_bits: int          # stored (fraction) bits, excluding hidden bit
    saturate: bool = False  # True => clamp to max finite instead of Inf

    @property
    def bits(self) -> int:
        return 1 + self.exp_bits + self.man_bits

    @property
    def bias(self) -> int:
        return (1 << (self.exp_bits - 1)) - 1

    @property
    def emax(self) -> int:
        # E4M3 (OCP FP8) reclaims the top exponent for finite values.
        if self.name == "fp8_e4m3":
            return (1 << self.exp_bits) - 1 - self.bias
        return (1 << self.exp_bits) - 2 - self.bias

    @property
    def emin(self) -> int:
        return 1 - self.bias

    @property
    def max_finite(self) -> float:
        if self.name == "fp8_e4m3":
            # 1.110 x 2^8 = 448 (mantissa 0b111 with the NaN row excluded)
            return float((2.0 - 2.0 ** (-self.man_bits) * 2) * 2.0 ** self.emax)
        return float((2.0 - 2.0 ** (-self.man_bits)) * 2.0 ** self.emax)

    @property
    def min_normal(self) -> float:
        return float(2.0 ** self.emin)


FP32 = FPFormat("fp32", exp_bits=8, man_bits=23)
BF16 = FPFormat("bf16", exp_bits=8, man_bits=7)
FP16 = FPFormat("fp16", exp_bits=5, man_bits=10)
FP8_E4M3 = FPFormat("fp8_e4m3", exp_bits=4, man_bits=3, saturate=True)
FP8_E5M2 = FPFormat("fp8_e5m2", exp_bits=5, man_bits=2)

FORMATS: dict[str, FPFormat] = {
    f.name: f for f in (FP32, BF16, FP16, FP8_E4M3, FP8_E5M2)
}


def get_format(name: str | FPFormat) -> FPFormat:
    if isinstance(name, FPFormat):
        return name
    try:
        return FORMATS[name]
    except KeyError as e:
        raise ValueError(f"unknown FP format {name!r}; have {sorted(FORMATS)}") from e


def decompose(x, fmt: FPFormat):
    """Split values into integer (sign, exponent, mantissa-with-hidden-bit).

    Returns (s, e, m) where the represented value is
    ``(-1)^s * m * 2^(e - bias - man_bits)`` and m includes the hidden bit
    (m == 0 encodes zero; FTZ applied). Takes a numpy array or a tensor and
    returns numpy arrays (the bit-exact datapath models are numpy).
    """
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float32).numpy()
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.int64)
    s = (bits >> 31) & 0x1
    e32 = (bits >> 23) & 0xFF
    m32 = bits & 0x7FFFFF
    # re-bias into the target format and truncate the mantissa (no rounding:
    # decompose() is used on values already representable in `fmt`)
    shift = 23 - fmt.man_bits
    m = (m32 >> shift) | (np.where(e32 > 0, 1, 0) << fmt.man_bits)
    e = e32 - 127 + fmt.bias
    zero = e32 == 0  # FTZ: subnormal f32 treated as zero
    m = np.where(zero, 0, m)
    e = np.where(zero, 0, e)
    return s.astype(np.int32), e.astype(np.int32), m.astype(np.int64)


def _f32_bits(x: torch.Tensor) -> torch.Tensor:
    """fp32 bit pattern as a non-negative int64 (torch lacks uint32 ops)."""
    return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _bits_f32(b: torch.Tensor) -> torch.Tensor:
    b = b & 0xFFFFFFFF
    b = torch.where(b >= 2 ** 31, b - 2 ** 32, b)
    return b.to(torch.int32).view(torch.float32)


def quantize(x: torch.Tensor, fmt: str | FPFormat) -> torch.Tensor:
    """Quantize to the target reduced-precision format, returned as fp32."""
    fmt = get_format(fmt)
    f32 = x.to(torch.float32)
    if fmt.name == "fp32":
        return f32
    if fmt.name in ("bf16", "fp16"):
        dt = torch.bfloat16 if fmt.name == "bf16" else torch.float16
        y = f32.to(dt).to(torch.float32)
        # FTZ: the IEEE cast keeps subnormals, the SA datapath does not
        return torch.where(y.abs() < fmt.min_normal, torch.zeros_like(y), y)
    return round_fp8(f32, fmt)


def round_fp8(x: torch.Tensor, fmt: str | FPFormat) -> torch.Tensor:
    """An fp32 tensor onto an FP8 grid, returned as fp32: round the fp32
    mantissa to `man_bits` (RNE) in the integer domain, flush what falls
    below the normal range to +0 after rounding, then saturate (E4M3) or
    overflow to ±Inf (E5M2); NaN passes. The body of the quantize kernel
    (`kernels/quantize.py`) and of `quantize`'s FP8 branch."""
    fmt = get_format(fmt)
    bits = _f32_bits(x.contiguous())
    shift = 23 - fmt.man_bits
    half = 1 << (shift - 1)
    lsb = (bits >> shift) & 1
    rounded = (bits + half - 1 + lsb) & ~((1 << shift) - 1)
    y = _bits_f32(rounded)
    ay = y.abs()
    y = torch.where(ay < fmt.min_normal, torch.zeros_like(y), y)
    if fmt.saturate:
        y = torch.clamp(y, -fmt.max_finite, fmt.max_finite)
    else:
        y = torch.where(ay > fmt.max_finite, torch.sign(y) * float("inf"), y)
    return torch.where(torch.isnan(x), x, y)
