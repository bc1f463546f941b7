"""Training driver for the PyTorch port: data, fault tolerance,
checkpointing, the JAX package's `repro/launch/train.py` on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-14b \\
        --reduced --device cpu --steps 20

Runs on CUDA unless `--device cpu` is given. The GEMM backend is
REPRO_GEMM_BACKEND (`torch`, the plain version, or `cuda`, the
hand-written SA GEMM kernel with its backward; `emulate` has no gradient,
as in the JAX package). The flags are the JAX driver's, plus `--device`;
`--model-parallel` above 1 raises: the mesh is not ported yet. `main`
parses the flags and calls `run(cfg, args)`, which callers with a config
of their own (a full-width model cut in depth) call directly.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.train import checkpoint as CKPT
from repro_torch.train.fault import PreemptionGuard, StragglerWatchdog
from repro_torch.train.optimizer import AdamW, warmup_cosine
from repro_torch.train.step import make_train_step
from repro_torch.train.train_state import init_state


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-scale smoke)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log", default=None, help="metrics JSONL path")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; no card and no --device "
                         "cpu raises")
    return ap.parse_args(argv)


def run(cfg, args):
    """Train `cfg` as `args` says. Returns (state, history): the final
    TrainState and one metrics dict per step taken."""
    if args.model_parallel != 1:
        raise ValueError("--model-parallel > 1 is not ported yet (the mesh "
                         "and sharding modules)")
    device = resolve_device(args.device)
    opt = AdamW(schedule=warmup_cosine(args.lr, max(2, args.steps // 10),
                                       args.steps))
    step_fn = make_train_step(cfg, opt, accum_steps=args.accum)
    state = init_state(cfg, opt, seed=args.seed, device=device)

    start = 0
    if (args.resume and args.ckpt_dir
            and CKPT.latest_step(args.ckpt_dir) is not None):
        state, _, start = CKPT.restore(args.ckpt_dir, state)
        print(f"resumed from step {start}")

    data = Prefetcher(iter(SyntheticLM(cfg.vocab_size, args.seq, args.batch,
                                       seed=args.seed)))
    guard = PreemptionGuard()
    watchdog = StragglerWatchdog(
        on_straggler=lambda s, dt, med: print(
            f"[straggler] step {s}: {dt:.2f}s vs median {med:.2f}s"))
    saver = CKPT.AsyncSaver()
    logf = open(args.log, "a") if args.log else None
    history = []
    t_start = time.time()
    try:
        for step in range(start, args.steps):
            watchdog.step_start()
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in next(data).items()}
            state, metrics = step_fn(state, batch)
            # float() waits for the card, so the step's wall is the work's
            m = {k: float(v) for k, v in metrics.items()}
            dt = watchdog.step_end(step)
            m |= {"step": step + 1, "wall_s": round(dt, 4)}
            history.append(m)
            print(f"step {step+1:5d} loss={m['loss']:.4f} "
                  f"gnorm={m['grad_norm']:.3f} {dt*1e3:.0f}ms", flush=True)
            if logf:
                logf.write(json.dumps(m) + "\n")
                logf.flush()
            want_ckpt = args.ckpt_dir and ((step + 1) % args.ckpt_every == 0
                                           or step + 1 == args.steps)
            if guard.should_stop:   # graceful preemption: checkpoint + exit
                if args.ckpt_dir:
                    saver.wait()
                    CKPT.save(args.ckpt_dir, step + 1, state)
                print(f"preempted at step {step+1}; checkpoint written")
                break
            if want_ckpt:
                saver.save_async(args.ckpt_dir, step + 1, state)
        saver.wait()
    finally:
        data.close()
        guard.restore()
        if logf:
            logf.close()
    n = args.steps - start
    print(f"done: {n} steps in {time.time()-t_start:.1f}s; "
          f"{len(watchdog.events)} straggler events")
    return state, history


def main(argv=None):
    args = parse_args(argv)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    return run(cfg, args)[0]


if __name__ == "__main__":
    main()
