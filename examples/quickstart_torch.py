"""Quickstart on the PyTorch port: train a tiny LM end to end (the
counterpart of `examples/quickstart.py`: the same model, data, schedule
and lines).

    PYTHONPATH=src python examples/quickstart_torch.py               # card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Runs on CUDA unless `--device cpu` is given; the GEMM backend is
REPRO_GEMM_BACKEND (`cuda` runs every GEMM, forward and backward, through
the hand-written SA GEMM kernel).
"""
import argparse

import torch

from repro_torch.configs import reduced_config
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.train.optimizer import AdamW, warmup_cosine
from repro_torch.train.step import make_train_step
from repro_torch.train.train_state import init_state


def main(argv=None) -> dict:
    """Train and print the loss every 10 steps; returns the losses."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = reduced_config("gemma2-9b")       # tiny structural twin
    print(f"arch={cfg.name} layers={cfg.num_layers} d={cfg.d_model} "
          f"params={cfg.param_count()/1e6:.2f}M")
    steps = args.steps
    opt = AdamW(schedule=warmup_cosine(3e-3, 4, steps), weight_decay=0.0)
    step = make_train_step(cfg, opt, accum_steps=2)
    state = init_state(cfg, opt, seed=0, device=device)
    data = SyntheticLM(cfg.vocab_size, seq_len=64, batch_per_host=8,
                       structured=True)   # learnable arithmetic sequences
    losses = []
    for i, batch in zip(range(steps), data):
        state, m = step(state, {k: torch.from_numpy(v).to(device)
                                for k, v in batch.items()})
        losses.append(float(m["loss"]))
        if (i + 1) % 10 == 0:
            print(f"step {i+1:3d}  loss {losses[-1]:.4f}  "
                  f"lr {float(m['lr']):.2e}")
    first, last = losses[0], losses[-1]
    print(f"loss: {first:.4f} → {last:.4f} "
          f"({'improved' if last < first else 'check config'})")
    return {"first": first, "last": last, "losses": losses}


if __name__ == "__main__":
    main()
