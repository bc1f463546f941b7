"""The GEMMs of the served model's path, and the operands the skewed
datapath is checked and timed on.

The shapes are qwen2.5-14b's at full width: a decoder layer's seven
projections and the lm_head (its vocabulary padded to 153600). The same
cases feed chip_smoke.py, tools/chip_ab.py and the GPU tests.
"""
from __future__ import annotations

import torch

D_MODEL, D_FF, VOCAB = 5120, 13824, 153600
# (name, K, N, bias, activation) of one decoder layer's seven GEMMs
LAYER_GEMMS = [("wq", D_MODEL, 40 * 128, True, "none"),
               ("wk", D_MODEL, 8 * 128, True, "none"),
               ("wv", D_MODEL, 8 * 128, True, "none"),
               ("wo", 40 * 128, D_MODEL, False, "none"),
               ("wg", D_MODEL, D_FF, False, "silu"),
               ("wu", D_MODEL, D_FF, False, "none"),
               ("wd", D_FF, D_MODEL, False, "none")]
LM_HEAD = ("lm_head", D_MODEL, VOCAB, False, "none")


def emu_operands(g: torch.Generator, m: int, k: int, n: int, fmt: str):
    """(m, k) and (k, n) operands on `fmt`'s grid in the card's containers
    (fp16 for fp16, bf16 otherwise), on `g`'s device: odd rows of A and
    every other block of 8 columns of W scaled x25, ~10 % zeros, column 1
    all zero, and columns 2-4 cancellation-heavy (A's two halves of K
    equal, W's second half the negated first: exact, near and
    one-term-residual cancellation)."""
    from repro_torch.core.fpformats import quantize

    dev = g.device
    a = torch.randn((m, k), generator=g, device=dev)
    w = torch.randn((k, n), generator=g, device=dev)
    a[1::2] *= 25.0
    w[:, (torch.arange(n, device=dev) // 8) % 2 == 1] *= 25.0
    a[torch.rand((m, k), generator=g, device=dev) < 0.1] = 0.0
    w[torch.rand((k, n), generator=g, device=dev) < 0.1] = 0.0
    h = k // 2
    a[:, h:2 * h] = a[:, :h]
    w[:, 1] = 0.0
    w[h:2 * h, 2] = -w[:h, 2]
    w[h:2 * h, 3] = -w[:h, 3] * (1 + 2.0 ** -6)
    w[h:2 * h, 4] = -w[:h, 4]
    w[0, 4] = 1.0
    box = torch.float16 if fmt == "fp16" else torch.bfloat16
    return quantize(a, fmt).to(box), quantize(w, fmt).to(box)
