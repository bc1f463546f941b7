"""Continuous batching on the PyTorch port: a request stream through the
slot scheduler and the chunked-decode engine (the counterpart of
`examples/serve_batch.py`: the same model, stream and lines).

Requests with mixed prompt lengths and token budgets share a fixed pool of
decode slots; a finished slot is refilled from the queue while the other
slots keep decoding at their own positions, with no wave barriers.

    PYTHONPATH=src python examples/serve_batch_torch.py               # card
    PYTHONPATH=src python examples/serve_batch_torch.py --device cpu

Runs on CUDA unless `--device cpu` is given. The reduced gemma3 has heads
16 wide and an 8-token local window; the card's attention kernels take
heads 64, 128 or 256 wide and walk a local ring in whole pages, so there
the heads are 64 wide and the pages 8 tokens (16 on the CPU, as in the JAX
example).
"""
import argparse
import dataclasses

import numpy as np

from repro_torch.configs import reduced_config
from repro_torch.core.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import SlotScheduler


def main(argv=None):
    """Serve 12 requests and print one line each and the summary; returns
    (summary, scheduler)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    cfg = reduced_config("gemma3-12b", layers_per_period=1)
    if on_card:
        cfg = dataclasses.replace(cfg, head_dim=64)
    params = M.init_params(cfg, seed=0, device=device)
    batch, cache_len = 4, 48
    engine = ServeEngine(cfg, params, batch=batch, cache_len=cache_len,
                         eos_id=-1, sync_every=4,   # no eos in synthetic vocab
                         page_size=8 if on_card else 16,
                         device=device)

    # 12 synthetic requests, mixed prompt lengths and budgets
    rng = np.random.default_rng(0)
    sched = SlotScheduler(batch, eos_id=-1)
    for i in range(12):
        plen = (8, 16)[i % 2]
        sched.submit(rng.integers(0, cfg.vocab_size, plen),
                     max_new_tokens=(12, 24)[i % 2])
    summary = engine.serve(sched)

    for r in sorted(sched.finished, key=lambda r: r.rid):
        print(f"req {r.rid:2d} slot {r.slot} prompt {r.prompt_len:3d} "
              f"gen {r.n_generated:3d} ttft {r.ttft:.2f}s "
              f"sample {r.tokens[:6]}")
    print(" ".join(f"{k}={v}" for k, v in summary.items()))
    return summary, sched


if __name__ == "__main__":
    main()
