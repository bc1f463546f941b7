"""The paper's core demonstration on the PyTorch port, end to end (the
counterpart of `examples/sa_precision_study.py`: the same sections, sizes
and lines):

1. bit-exactness — the skewed pipeline's speculative exponent algebra gives
   results identical to the baseline pipeline (§III.B), per format;
2. latency/energy — the cycle model reproduces the §IV headline numbers;
3. precision ladder — the SA arithmetic contract (sa_dot) applied to a real
   model forward pass (reduced qwen2.5): fp32 vs bf16 vs fp8 logits drift.
   On the card the FP8 policies round every operand through the
   hand-written quantize kernel.

    PYTHONPATH=src python examples/sa_precision_study_torch.py        # card
    PYTHONPATH=src python examples/sa_precision_study_torch.py --device cpu

Runs on CUDA unless `--device cpu` is given. The full-width ladder is
`python -m repro_torch.launch.precision_study`.
"""
import argparse

from repro_torch.configs import reduced_config
from repro_torch.core.device import resolve_device
from repro_torch.launch import precision_study as PS


def main(argv=None, params=None, tokens=None) -> dict:
    """Print the three sections; return their numbers. `params` (a numpy
    tree with the JAX package's key names, e.g. its example's weights) and
    `tokens` ((1, T) integers) replace section 3's weights and prompt,
    which are otherwise drawn from `--seed`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = {"bit_exact": PS.bit_exactness(), **PS.latency_energy()}
    out["ladder"] = PS.ladder(
        reduced_config("qwen2.5-14b"), device, args.seed, params=params,
        tokens=tokens, title="== 3. the SA contract inside a real model ==")
    return out


if __name__ == "__main__":
    main()
