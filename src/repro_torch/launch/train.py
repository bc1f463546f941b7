"""Training driver for the PyTorch port: mesh, data, fault tolerance,
checkpointing, the JAX package's `repro/launch/train.py`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-14b \\
        --reduced --device cpu --steps 20
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch qwen2.5-14b --reduced --device cpu --model-parallel 2
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch granite-moe-3b-a800m --reduced --device cpu --model-parallel 2
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch llama4-maverick-400b-a17b --reduced --fsdp --device cpu \\
        --model-parallel 2

Runs on CUDA unless `--device cpu` is given. The GEMM backend is
REPRO_GEMM_BACKEND (`torch`, the plain version, or `cuda`, the
hand-written SA GEMM kernel with its backward; `emulate` has no gradient,
as in the JAX package). The flags are the JAX driver's, plus `--device`.
Under torchrun (or any launcher that sets the torch.distributed
environment) the world becomes a ("data", "model") mesh with
`--model-parallel` ranks innermost (`parallel.mesh.make_host_mesh`; the
backend, nccl where every rank has a card of its own and gloo where ranks
share one or run on the CPU, is printed first): every rank draws the same
full state from `--seed` and keeps its shard, each data rank takes its
rows of the same global batch (`parallel.sharding.data_specs`; a MoE
model's load-balance loss is taken over the global batch; with
`--frontend` the stub frames or patches with their rows), and rank
0 prints a JSON line a step; at the end each rank prints its peak memory,
step times, the bytes of its parameters, μ and ν, and each step's clip
norm. A config flagged `fsdp` (llama4; `--fsdp` puts the flag back on a
reduced config, which drops it) keeps its leaves cut over `data` as well
(FSDP, `models.model.check_parallel`). `main` parses the flags and
calls `run(cfg, args)`, which callers with a config of their own (a
full-width model cut in depth) call directly.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

from repro_torch.configs import cut_depth, get_config, reduced_config
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.models.model import tree_leaves
from repro_torch.train import checkpoint as CKPT
from repro_torch.train.fault import PreemptionGuard, StragglerWatchdog
from repro_torch.train.optimizer import AdamW, warmup_cosine
from repro_torch.train.step import make_train_step
from repro_torch.train.train_state import init_state, state_specs


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
    ap.add_argument("--fsdp", action="store_true",
                    help="cut the parameters over data as well (the "
                         "config's fsdp flag, which llama4 has and the "
                         "reduced configs drop)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config's depth to this many layers (a "
                         "full-width model cut in depth)")
    ap.add_argument("--frontend", action="store_true",
                    help="feed a frontend arch stub frame or patch "
                         "embeddings, (batch, frontend_tokens, d_model) "
                         "drawn a step from a host generator seeded "
                         "--seed + 1 + step (the JAX driver feeds none)")
    ap.add_argument("--grads-out", default=None,
                    help="write the first step's loss and gradients "
                         "(before the clip) to this directory, .npy "
                         "files by leaf path and a piece's index along "
                         "each axis that cuts it (read_grads joins "
                         "them)")
    return ap.parse_args(argv)


def say(line: str):
    """One line to stdout in one write: the ranks of a launch share it,
    and print's separate write of the newline lets another rank's line
    in between."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def _mesh_line(mesh, device) -> str:
    import torch.distributed as dist

    dp, mp = mesh.shape
    return (f"[mesh] backend={dist.get_backend()} world="
            f"{dist.get_world_size()} data={dp} model={mp} device={device}")


def _grads_writer(out_dir: str, then, mesh, specs, lead: bool):
    """An `on_grads` that writes the first step's loss (loss.json) and
    gradients to `out_dir`, no collective: each distinct piece of a leaf
    once, by the rank that counts it (`sharding.counts_once`), named by
    its index along each entry of the leaf's spec that names an axis
    (`<path>.<i>[.<j>].npy`, the path's "/" as "."; a leaf cut over
    `model` and `data` has two), and a leaf no axis cuts once
    (`<path>.npy`); `read_grads` joins the pieces."""
    import numpy as np

    from repro_torch.parallel import sharding as S

    if mesh is not None:
        coords, sizes = S.mesh_coords(mesh), S.axis_sizes(mesh)
    done = []

    def write(loss, nll, grads):
        if not done:
            os.makedirs(out_dir, exist_ok=True)
            paths = []
            S.tree_map_with_path(lambda p, _: paths.append(
                ".".join(map(str, p))), grads)
            pspecs = (S.spec_leaves(specs.params, grads) if mesh is not None
                      else [S.P()] * len(paths))
            for path, g, sp in zip(paths, tree_leaves(grads), pspecs):
                if mesh is not None and not S.counts_once(sp, mesh, coords):
                    continue
                idx = ([] if mesh is None or not S.is_sharded(sp, mesh) else
                       [str(S._entry_index(e, coords, sizes)[1])
                        for e in sp if e is not None])
                np.save(os.path.join(out_dir, ".".join([path, *idx, "npy"])),
                        g.detach().cpu().numpy())
            if lead:
                with open(os.path.join(out_dir, "loss.json"), "w") as f:
                    json.dump({"loss": float(loss), "nll": float(nll)}, f)
        done.append(True)
        if then is not None:
            then(loss, nll, grads)

    return write


def read_grads(out_dir: str, path: str, spec):
    """A leaf `--grads-out` wrote, whole: the one file, or its pieces
    joined along each dim its spec (its `param_specs` entry at the run's
    mesh) names an axis for, in order."""
    import numpy as np

    whole = os.path.join(out_dir, f"{path}.npy")
    if os.path.exists(whole):
        return np.load(whole)
    dims = [d for d, e in enumerate(spec) if e is not None]
    names = set(os.listdir(out_dir))

    def join(prefix, k):
        if k == len(dims):
            return np.load(os.path.join(out_dir, prefix + ".npy"))
        parts = []
        while any(n.startswith(f"{prefix}.{len(parts)}.") for n in names):
            parts.append(join(f"{prefix}.{len(parts)}", k + 1))
        return np.concatenate(parts, axis=dims[k])

    return join(path, 0)


def state_bytes(state) -> int:
    """The bytes a rank keeps from step to step: its parameters, μ and ν
    (under a mesh its pieces)."""
    return sum(x.numel() * x.element_size() for t in (
        state.params, state.opt_state.mu, state.opt_state.nu)
        for x in tree_leaves(t))


def run(cfg, args, on_grads=None):
    """Train `cfg` as `args` says. Returns (state, history): the final
    TrainState (under a mesh, this rank's shards) and one metrics dict per
    step taken. `on_grads` is passed to `make_train_step`."""
    from repro_torch.models.model import check_parallel
    from repro_torch.parallel import mesh as PM
    from repro_torch.parallel import sharding as S

    device = resolve_device(args.device)
    mesh = PM.make_host_mesh(args.model_parallel, device)
    lead = True
    specs = coords = None
    if mesh is not None:
        import torch.distributed as dist

        check_parallel(cfg, mesh.shape[1], mesh.shape[0])
        device = PM.rank_device(device)
        lead = dist.get_rank() == 0
        specs, coords = state_specs(cfg, mesh), S.mesh_coords(mesh)
        if lead:
            say(_mesh_line(mesh, device))
    opt = AdamW(schedule=warmup_cosine(args.lr, max(2, args.steps // 10),
                                       args.steps))
    if args.grads_out:
        on_grads = _grads_writer(args.grads_out, on_grads, mesh, specs, lead)
    step_fn = make_train_step(cfg, opt, accum_steps=args.accum, mesh=mesh,
                              on_grads=on_grads)
    state = init_state(cfg, opt, seed=args.seed, device=device, mesh=mesh)

    start = 0
    if (args.resume and args.ckpt_dir
            and CKPT.latest_step(args.ckpt_dir) is not None):
        state, _, start = CKPT.restore(args.ckpt_dir, state, mesh=mesh,
                                       specs=specs)
        if lead:
            say(f"resumed from step {start}")

    def rows(v):
        """This data rank's rows of the global batch."""
        t = torch.from_numpy(v)
        if mesh is not None:
            t = S.shard_leaf(t, S.data_specs(mesh, v.shape), mesh, coords)
        return t.to(device)

    data = Prefetcher(iter(SyntheticLM(cfg.vocab_size, args.seq, args.batch,
                                       seed=args.seed)))
    guard = PreemptionGuard()
    watchdog = StragglerWatchdog(
        on_straggler=lambda s, dt, med: say(
            f"[straggler] step {s}: {dt:.2f}s vs median {med:.2f}s"))
    saver = CKPT.AsyncSaver()
    logf = open(args.log, "a") if args.log else None
    history = []
    t_start = time.time()
    try:
        for step in range(start, args.steps):
            watchdog.step_start()
            batch = {k: rows(v) for k, v in next(data).items()}
            if args.frontend and cfg.frontend_tokens:
                g = torch.Generator().manual_seed(args.seed + 1 + step)
                batch["frontend"] = rows(torch.randn(
                    (args.batch, cfg.frontend_tokens, cfg.d_model),
                    generator=g).numpy())
            state, metrics = step_fn(state, batch)
            # float() waits for the card, so the step's wall is the work's
            m = {k: float(v) for k, v in metrics.items()}
            dt = watchdog.step_end(step)
            m |= {"step": step + 1, "wall_s": round(dt, 4)}
            history.append(m)
            if lead:
                say(f"step {step+1:5d} loss={m['loss']:.4f} "
                    f"gnorm={m['grad_norm']:.3f} {dt*1e3:.0f}ms")
                if mesh is not None:
                    say(json.dumps(m))
            if logf and lead:
                logf.write(json.dumps(m) + "\n")
                logf.flush()
            want_ckpt = args.ckpt_dir and ((step + 1) % args.ckpt_every == 0
                                           or step + 1 == args.steps)
            if guard.should_stop:   # graceful preemption: checkpoint + exit
                if args.ckpt_dir:
                    saver.wait()
                    CKPT.save(args.ckpt_dir, step + 1, state, mesh=mesh,
                              specs=specs)
                say(f"preempted at step {step+1}; checkpoint written")
                break
            if want_ckpt:
                saver.save_async(args.ckpt_dir, step + 1, state, mesh=mesh,
                                 specs=specs)
        saver.wait()
    finally:
        data.close()
        guard.restore()
        if logf:
            logf.close()
    n = args.steps - start
    if lead:
        say(f"done: {n} steps in {time.time()-t_start:.1f}s; "
            f"{len(watchdog.events)} straggler events")
    if mesh is not None:
        import torch.distributed as dist

        from repro_torch.kernels import ops

        peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
                if device.type == "cuda" else None)
        c = ops.counts()
        say(f"[rank {dist.get_rank()}] peak_mem_gib="
            f"{'n/a' if peak is None else f'{peak:.3f}'} step_s="
            f"{','.join(str(m['wall_s']) for m in history)} "
            f"sa_matmul_launches={c['sa_matmul']['launches']}+"
            f"{c['sa_matmul_bwd']['launches']} plain_calls="
            f"{sum(v['plain_calls'] for v in c.values())} state_bytes="
            f"{state_bytes(state)} grad_norm="
            f"{','.join(repr(m['grad_norm']) for m in history)}")
    return state, history


def main(argv=None):
    args = parse_args(argv)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if args.layers:
        cfg = cut_depth(cfg, args.layers)
    if args.fsdp:
        cfg = dataclasses.replace(cfg, fsdp=True)
    return run(cfg, args)[0]


if __name__ == "__main__":
    main()
