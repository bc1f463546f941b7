"""The paper's evaluation workloads: MobileNet [18] and ResNet50 [19].

The port's copy of the JAX package's `repro/core/workloads.py` (plain Python and
`math`); tests/test_torch_study.py holds it equal to the original.

Each conv layer is lowered to the GEMM the WS systolic array executes
(SCALE-Sim-style im2col, the methodology of the paper's reference [8]):

    M = out_h · out_w          (streaming input rows, west edge)
    K = k_h · k_w · C_in       (reduction, mapped onto SA rows)
    N = C_out                  (SA columns)

Depthwise convolutions do not form a dense GEMM; the model supports three
mappings (`dw_mode`):

  * ``packed``  (default) — block-diagonal weight packing: groups of
    ``g = floor(rows / k_h·k_w)`` channels occupy disjoint 9-row bands of the
    array, each SA row streaming its own channel's im2col column (WS rows
    have independent west input ports, so this is legal). One pass handles
    g channels ⇒ GEMM (M, 9·g, g) per pass.
  * ``per_channel`` — C independent (M, 9, 1) GEMMs (naive lowering).
  * ``offload`` — depthwise runs on a vector unit, not the SA (how e.g.
    TPUs treat depthwise); contributes zero SA cycles.

The paper does not pin down its depthwise mapping; EXPERIMENTS.md reports the
headline numbers under ``packed`` and the sensitivity under the other two.
"""
from __future__ import annotations

import dataclasses
import math

from .systolic import SAConfig, gemm_latency, gemm_macs


@dataclasses.dataclass(frozen=True)
class ConvLayer:
    name: str
    out_hw: int        # output spatial size (square)
    k: int             # kernel size (square)
    c_in: int
    c_out: int
    depthwise: bool = False

    def gemms(self, sa_rows: int, dw_mode: str = "packed"):
        """Yield (M, K, N, repeats) GEMMs this layer lowers to."""
        M = self.out_hw * self.out_hw
        if not self.depthwise:
            yield M, self.k * self.k * self.c_in, self.c_out, 1
            return
        kk = self.k * self.k
        if dw_mode == "offload":
            return
        if dw_mode == "per_channel":
            yield M, kk, 1, self.c_in
            return
        g = max(1, sa_rows // kk)            # channels per block-diagonal pass
        passes = math.ceil(self.c_in / kk if False else self.c_in / g)
        full, rem = divmod(self.c_in, g)
        if full:
            yield M, kk * g, g, full
        if rem:
            yield M, kk * rem, rem, 1
        del passes


@dataclasses.dataclass(frozen=True)
class FCLayer:
    name: str
    c_in: int
    c_out: int

    def gemms(self, sa_rows: int, dw_mode: str = "packed"):
        yield 1, self.c_in, self.c_out, 1


def _dw_sep(idx, hw, c_in, c_out):
    return [
        ConvLayer(f"dw{idx}", hw, 3, c_in, c_in, depthwise=True),
        ConvLayer(f"pw{idx}", hw, 1, c_in, c_out),
    ]


def mobilenet_v1():
    """MobileNetV1 (224×224), Howard et al. 2017 — the paper's [18]."""
    layers = [ConvLayer("conv1", 112, 3, 3, 32)]
    cfg = [  # (hw_out, c_in, c_out)
        (112, 32, 64), (56, 64, 128), (56, 128, 128), (28, 128, 256),
        (28, 256, 256), (14, 256, 512),
        (14, 512, 512), (14, 512, 512), (14, 512, 512), (14, 512, 512),
        (14, 512, 512),
        (7, 512, 1024), (7, 1024, 1024),
    ]
    for i, (hw, ci, co) in enumerate(cfg, start=1):
        layers += _dw_sep(i, hw, ci, co)
    layers.append(FCLayer("fc", 1024, 1000))
    return layers


def _bottleneck(tag, hw, c_in, c_mid, c_out, downsample):
    ls = [
        ConvLayer(f"{tag}.a", hw, 1, c_in, c_mid),
        ConvLayer(f"{tag}.b", hw, 3, c_mid, c_mid),
        ConvLayer(f"{tag}.c", hw, 1, c_mid, c_out),
    ]
    if downsample:
        ls.append(ConvLayer(f"{tag}.ds", hw, 1, c_in, c_out))
    return ls


def resnet50():
    """ResNet50 (224×224), He et al. 2016 — the paper's [19]."""
    layers = [ConvLayer("conv1", 112, 7, 3, 64)]
    spec = [  # (blocks, hw, c_mid, c_out)
        (3, 56, 64, 256), (4, 28, 128, 512), (6, 14, 256, 1024), (3, 7, 512, 2048),
    ]
    c_in = 64
    for si, (blocks, hw, c_mid, c_out) in enumerate(spec, start=1):
        for b in range(blocks):
            layers += _bottleneck(f"s{si}b{b}", hw, c_in, c_mid, c_out,
                                  downsample=(b == 0))
            c_in = c_out
    layers.append(FCLayer("fc", 2048, 1000))
    return layers


WORKLOADS = {"mobilenet": mobilenet_v1, "resnet50": resnet50}


def layer_latency(layer, sa: SAConfig, dw_mode: str = "packed") -> int:
    return sum(gemm_latency(M, K, N, sa) * rep
               for M, K, N, rep in layer.gemms(sa.rows, dw_mode))


def layer_macs(layer, sa_rows: int = 128, dw_mode: str = "packed") -> int:
    """True MAC count (block-diagonal zero tiles don't toggle the datapath,
    so depthwise MACs are counted from the per-channel lowering)."""
    mode = "per_channel" if getattr(layer, "depthwise", False) else dw_mode
    if dw_mode == "offload" and getattr(layer, "depthwise", False):
        mode = "offload"
    return sum(gemm_macs(M, K, N) * rep
               for M, K, N, rep in layer.gemms(sa_rows, mode))


def network_latency(name: str, sa: SAConfig, dw_mode: str = "packed") -> int:
    return sum(layer_latency(l, sa, dw_mode) for l in WORKLOADS[name]())
