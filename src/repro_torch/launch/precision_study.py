"""The paper's core demonstration on the port, end to end (the counterpart
of the JAX package's `examples/sa_precision_study.py`, same three
sections):

1. bit-exactness — the skewed pipeline's speculative exponent algebra gives
   results identical to the baseline pipeline (§III.B), per format
   (`core.chained_fma`, numpy);
2. latency/energy — the cycle model reproduces the §IV headline numbers
   (`core.systolic`, `core.energy`);
3. precision ladder — the SA contract (`sa_dot`) inside a real model's
   forward pass: fp32 vs bf16 vs fp8 logits drift. On the card the model
   runs at full width and depth (random weights from `--seed`), under the
   default `torch` GEMM backend, and the FP8 policies round every operand
   through the hand-written quantize kernel.

    PYTHONPATH=src python -m repro_torch.launch.precision_study
    PYTHONPATH=src python -m repro_torch.launch.precision_study \\
        --reduced --device cpu

Runs on CUDA unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core import chained_fma as cf
from repro_torch.core import energy as E
from repro_torch.core.device import resolve_device
from repro_torch.core.fpformats import BF16, FP8_E4M3, FP8_E5M2, quantize
from repro_torch.core.precision import PrecisionPolicy, use_policy
from repro_torch.core.systolic import BASELINE, SKEWED, SAConfig, gemm_latency
from repro_torch.models import model as M

GEMMS = ((49, 1024, 1024, "late CNN layer"),
         (12544, 27, 32, "early CNN layer"),
         (4096, 5120, 5120, "LLM GEMM"))
PAPER = {"mobilenet": (16, 8), "resnet50": (21, 11)}
LADDER = ("fp32", "bf16", "fp8_e5m2", "fp8_e4m3")


def _on_grid(x: np.ndarray, fmt) -> np.ndarray:
    return quantize(torch.from_numpy(np.asarray(x, np.float32)), fmt).numpy()


def bit_exactness() -> dict[str, bool]:
    print("== 1. skew ≡ baseline (bit-exact), per format ==")
    rng = np.random.default_rng(0)
    out = {}
    for fmt in (BF16, FP8_E4M3, FP8_E5M2):
        a = _on_grid(rng.standard_normal((32, 64)), fmt)
        w = _on_grid(rng.standard_normal((64, 24)), fmt)
        b = cf.matmul_emulated(a, w, fmt, "baseline")
        s = cf.matmul_emulated(a, w, fmt, "skewed")
        out[fmt.name] = bool(np.array_equal(b.view(np.uint32),
                                            s.view(np.uint32)))
        print(f"  {fmt.name:10s} bit-exact: {out[fmt.name]}")
    return out


def latency_energy() -> dict:
    print("\n== 2. latency & energy (128×128 SA @ 1 GHz) ==")
    gemms = []
    for M_, K, N, tag in GEMMS:
        cb = gemm_latency(M_, K, N, SAConfig(pipeline=BASELINE))
        cs = gemm_latency(M_, K, N, SAConfig(pipeline=SKEWED))
        gemms.append((M_, K, N, cb, cs))
        print(f"  {tag:16s} {M_}x{K}x{N}: {cb} → {cs} cycles "
              f"({100*(1-cs/cb):.1f}% faster)")
    nets = {}
    for net, paper in PAPER.items():
        t = nets[net] = E.network_totals(net)
        print(f"  {net:10s} latency −{t['latency_saving']:.1%} "
              f"(paper −{paper[0]}%), energy −{t['energy_saving']:.1%} "
              f"(paper −{paper[1]}%)")
    return {"gemms": gemms, "networks": nets}


def ladder(cfg, device, seed: int, *, params=None, tokens=None,
           title: str | None = None) -> dict[str, dict[str, float]]:
    """Section 3: the logits of each policy of the ladder against fp32's.
    The weights are drawn from `seed` unless `params` (a numpy tree with
    the JAX package's key names, carried over by `params_from_numpy`)
    gives them; the prompt is 32 tokens drawn from `seed + 1` unless
    `tokens` ((1, T) integers) gives it. `title` replaces the heading."""
    print("\n" + (title or f"== 3. the SA contract inside a real model "
                   f"({cfg.name}, {cfg.num_layers} layers, d {cfg.d_model}, "
                   f"on {device}) =="))
    if params is None:
        params = M.init_params(cfg, seed=seed, device=device)
    else:
        from repro_torch.models.convert import params_from_numpy
        params = params_from_numpy(params, device)
    if tokens is None:
        g = torch.Generator().manual_seed(seed + 1)
        tokens = torch.randint(0, cfg.vocab_size, (1, 32), generator=g,
                               dtype=torch.int32)
    toks = torch.as_tensor(np.array(tokens), dtype=torch.int32).to(device)
    ref = None
    out = {}
    for fmt in LADDER:
        with use_policy(PrecisionPolicy(input_format=fmt)):
            logits, _, _ = M.forward(params, cfg, toks)
        x = logits[..., :cfg.vocab_size].float()
        if ref is None:
            ref = x
            print(f"  {fmt:10s} (reference)")
            continue
        rel = float((x - ref).abs().max() / ref.abs().max())
        agree = float((x.argmax(-1) == ref.argmax(-1)).float().mean())
        out[fmt] = {"max_rel_dev": rel, "top1_agreement": agree}
        print(f"  {fmt:10s} max rel dev {rel:.2e}, "
              f"top-1 agreement {agree:.1%}")
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's smoke-size variant (section 3)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; no card and no --device "
                         "cpu is an error")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Print the three sections; return their numbers."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    return {"bit_exact": bit_exactness(), **latency_energy(),
            "ladder": ladder(cfg, device, args.seed)}


if __name__ == "__main__":
    main()
