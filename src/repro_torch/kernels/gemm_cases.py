"""The GEMMs of the served model's path, the operands the skewed datapath
is checked and timed on, and the k16 probe's steps.

The shapes are qwen2.5-14b's at full width: a decoder layer's seven
projections and the lm_head (its vocabulary padded to 153600); the
MoE family's routers and experts; and the SSM family's projections. The
same
cases feed chip_smoke.py, tools/chip_ab.py and the GPU tests.
"""
from __future__ import annotations

import numpy as np
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

# the MoE family's GEMMs at full width: (name, K, N) of the routers
# (granite-moe-3b's 40 experts, llama4-maverick's 128, and a narrow N = 8,
# each narrower than any other served N), and (name, K, N, activation) of
# one expert's three GEMMs
ROUTER_GEMMS = [("granite router", 1536, 40), ("llama4 router", 5120, 128),
                ("router N=8", 1536, 8)]
EXPERT_GEMMS = {
    "granite": [("wg", 1536, 512, "silu"), ("wu", 1536, 512, "none"),
                ("wd", 512, 1536, "none")],
    "llama4": [("wg", 5120, 8192, "silu"), ("wu", 5120, 8192, "none"),
               ("wd", 8192, 5120, "none")]}
# llama4's dense layers' FFN (d_ff_dense 16384; its shared expert has the
# experts' shapes)
DENSE_FFN_GEMMS = {
    "llama4": [("wg", 5120, 16384, "silu"), ("wu", 5120, 16384, "none"),
               ("wd", 16384, 5120, "none")]}
# (name, K, N) of the Mamba2 mixers' projections: in_proj d → 2·d_inner +
# 2·state + heads, out_proj d_inner → d. hymba's in_proj has N = 6482, not
# a multiple of 8: its weight is stored with rows of 6488
# (`model.matrix_storage`)
SSM_GEMMS = [("mamba2 in_proj", 2560, 10576), ("mamba2 out_proj", 5120, 2560),
             ("hymba in_proj", 1600, 6482), ("hymba out_proj", 3200, 1600)]
# (name, K, N) of whisper-tiny's SA GEMMs (d 384, 6 heads of 64, d_ff
# 1536, vocabulary padded to 53248): the attention projections (the
# encoder's, the cross-attention's wq and wo and its K and V over the
# encoder's output, the decoder's self-attention), the MLP and the lm_head.
# The encoder's run at M = batch · WHISPER_FRAMES rows, the decoder's at
# M = batch
WHISPER_GEMMS = [("attn 384x384", 384, 384), ("mlp w1", 384, 1536),
                 ("mlp w2", 1536, 384), ("lm_head", 384, 53248)]
WHISPER_FRAMES = 1500


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


PROBE_STEPS = 64   # the k16 probe's steps a category
PROBE_CASES = ("random", "spread", "cancel", "tiny", "zeros")


def k16_probe_operands(seed: int = 0, steps: int = PROBE_STEPS) -> dict:
    """The k16 probe's steps (`sa_matmul.k16_probe`), by category: {name:
    (a (S, 64, 16), b (S, 16, 128))}, bf16 on the CPU, drawn by numpy's
    generator from `seed`. Each output of a step sums 16 products:

    * random: N(0, 1) operands;
    * spread: the operands' exponents drawn within ±E/2 (E = 20, 30, 40,
      50, 60 by step), random signs and mantissas, so a step's products
      spread over 2^±20 to 2^±60 and the tensor cores' alignment
      truncates the small ones;
    * cancel: the second 8 products the first 8 negated, exactly in the
      even columns (a zero sum) and with b's last bit flipped in the odd
      ones (a residual ~2^-8 of the terms): near-total cancellation;
    * tiny: exponents in [-70, -56], so the products (2^-140 to 2^-110)
      straddle fp32's smallest normal 2^-126;
    * zeros: rows of a at +0 and at -0, columns of b at +0 and at -0, the
      rest random: steps whose products are all zeros of either sign, or
      zeros beside nonzero ones."""
    rng = np.random.default_rng(seed)
    sa, sb = (steps, 64, 16), (steps, 16, 128)

    def signed(shape, lo, hi):
        e = rng.integers(lo, hi + 1, size=shape)
        return (rng.choice([-1.0, 1.0], size=shape)
                * (1.0 + rng.random(shape)) * np.exp2(e))

    half = (np.array([20, 30, 40, 50, 60])[np.arange(steps) % 5]
            // 2)[:, None, None]
    cases = {"random": (rng.standard_normal(sa), rng.standard_normal(sb)),
             "spread": (signed(sa, -half, half), signed(sb, -half, half)),
             "tiny": (signed(sa, -70, -56), signed(sb, -70, -56))}
    a, b = rng.standard_normal(sa), rng.standard_normal(sb)
    a[:, :, 8:] = a[:, :, :8]
    b[:, 8:, :] = -b[:, :8, :]
    cases["cancel"] = (a, b)
    a, b = rng.standard_normal(sa), rng.standard_normal(sb)
    a[:, 0:8], a[:, 8:16], a[:, 16:24, ::2] = 0.0, -0.0, -0.0
    b[:, :, 0:8], b[:, :, 8:16], b[:, ::3, 16:24] = 0.0, -0.0, 0.0
    cases["zeros"] = (a, b)
    out = {}
    for name in PROBE_CASES:
        a, b = cases[name]
        ta = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        tb = torch.from_numpy(b.astype(np.float32)).to(torch.bfloat16)
        if name == "cancel":   # flip the last bit of b's negated half
            bits = tb.view(torch.int16)
            bits[:, 8:, 1::2] ^= 1
        out[name] = (ta, tb)
    return out


def k16_mismatches(x: torch.Tensor, y: torch.Tensor) -> dict:
    """Where two fp32 tensors of step sums differ: `bits` (any bit),
    `values` (+0 and -0 equal, NaN equal to NaN), and the worst value
    mismatch as (|x - y|, x, y), or None."""
    bits = int((x.view(torch.int32) != y.view(torch.int32)).sum())
    ne = (x != y) & ~(torch.isnan(x) & torch.isnan(y))
    worst = None
    if bool(ne.any()):
        d = torch.where(ne, (x - y).abs(), torch.zeros_like(x)).flatten()
        i = int(torch.argmax(d))
        worst = (float(d[i]), float(x.flatten()[i]), float(y.flatten()[i]))
    return {"bits": bits, "values": int(ne.sum()), "worst": worst}
