"""Rank programs for tests/test_torch_fsdp.py: spawned gloo worlds on the
CPU, on the shared harness of tests/_torch_parallel_ranks.py. Each rank
writes what it computed with `torch.save` under the world's directory;
the test process compares."""
from __future__ import annotations

import contextlib
import io
import os

import torch
import torch.distributed as dist

from _torch_parallel_ranks import _bits, _mesh, run_world

# the steps: (job name, formats, accums) a mesh; each FSDP name beside its
# data-parallel twin (the same config with `fsdp` off, name + "_dp")
PAIR_RUNS = {(0, 1): (("llama4", ("bf16", "fp32"), (1, 2)),),
             (2, 3): (("qwen", ("bf16",), (1,)), ("mamba2", ("bf16",), (1,)),
                      ("whisper", ("bf16",), (1,)),
                      ("gemma2", ("bf16",), (1,)))}
QUAD_RUNS = (("llama4", ("bf16", "fp32"), (1, 2)),)


def _step(job, name, fmt, accum, mesh):
    """One sharded train step of `name`'s config from the job's whole
    numpy parameters and global batch. Returns (readings, state): the
    loss, the gradients `on_grads` sees (this rank's pieces, and gathered
    whole), the parameters after the update gathered whole, the clip
    norm, and the shapes of this rank's parameter, gradient, μ and ν
    pieces."""
    from repro_torch.core import precision as TP
    from repro_torch.models import model as M
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.parallel import sharding as S
    from repro_torch.train import optimizer as TO
    from repro_torch.train.step import make_train_step
    from repro_torch.train.train_state import TrainState, param_specs

    cfg = job["cfgs"][name]
    specs = param_specs(cfg, mesh)
    coords = S.mesh_coords(mesh)
    full = params_from_numpy(job["params"][job["arch"][name]], "cpu",
                             dtype=torch.float32)
    params = S.shard_tree(full, specs, mesh, coords)
    for p in M.tree_leaves(params):
        p.requires_grad_(True)
    opt = TO.AdamW(schedule=TO.warmup_cosine(**job["sched"]))
    state = TrainState(step=torch.zeros((), dtype=torch.int32),
                       params=params, opt_state=opt.init(params))
    batch = {k: S.shard_leaf(torch.from_numpy(v), S.data_specs(mesh, v.shape),
                             mesh, coords)
             for k, v in job["batch"][job["arch"][name]].items()}
    got = {}

    def on_grads(loss, nll, grads):
        got["loss"] = float(loss)
        got["pieces"] = [g.detach().clone() for g in M.tree_leaves(grads)]
        got["grads"] = [g.clone() for g in M.tree_leaves(
            S.gather_tree(grads, specs, mesh))]

    with TP.use_policy(TP.PrecisionPolicy(input_format=fmt,
                                          backend="cuda")):
        state, m = make_train_step(cfg, opt, accum, mesh=mesh,
                                   on_grads=on_grads)(state, batch)

    def shapes(tree):
        return [tuple(x.shape) for x in M.tree_leaves(tree)]
    got |= {"after": [p.detach().clone() for p in M.tree_leaves(
                S.gather_tree(state.params, specs, mesh))],
            "grad_norm": float(m["grad_norm"]),
            "shapes": {"params": shapes(state.params),
                       "grads": [tuple(g.shape) for g in got["pieces"]],
                       "mu": shapes(state.opt_state.mu),
                       "nu": shapes(state.opt_state.nu)}}
    return got, state


def _steps(job, runs, mesh):
    """Each run's steps, FSDP and its data-parallel twin, on `mesh`: by
    (name, fmt, accum) the FSDP readings, with `same_as_dp` (whether each
    gradient piece has the bits of the twin's gradient cut to this rank's
    piece by the FSDP specs) where the twin ran."""
    from repro_torch.parallel import sharding as S
    from repro_torch.train.train_state import param_specs

    out, states = {}, {}
    coords = S.mesh_coords(mesh)
    for name, fmts, accums in runs:
        for fmt in fmts:
            for accum in accums:
                got, state = _step(job, name, fmt, accum, mesh)
                if fmt == "bf16" and accum == 1:
                    specs = S.spec_leaves(param_specs(job["cfgs"][name],
                                                      mesh), state.params)
                    dp, _ = _step(job, name + "_dp", fmt, accum, mesh)
                    got["same_as_dp"] = [
                        torch.equal(_bits(p), _bits(S.shard_leaf(
                            w, sp, mesh, coords)))
                        for p, w, sp in zip(got["pieces"], dp["grads"],
                                            specs)]
                    got["dp_loss"] = dp["loss"]
                    states[name] = state
                del got["pieces"]
                out[(name, fmt, accum)] = got
    return out, states


def train_body(rank, world, job):
    """The steps at (2, 1) on ranks 0-1 and 2-3 side by side, then at
    (2, 2); llama4's (2, 2) state saved (FSDP) and restored at (1, 2) on
    ranks 0-1 and on ranks 2-3."""
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding as S
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train.train_state import state_specs

    out = {}
    for ranks, runs in PAIR_RUNS.items():
        mesh = _mesh((2, 1), ranks)
        if rank in ranks:
            out[(2, 1)], _ = _steps(job, runs, mesh)
    quad = _mesh((2, 2), range(4))
    out[(2, 2)], states = _steps(job, QUAD_RUNS, quad)
    cfg = job["cfgs"]["llama4"]
    ckpt = os.path.join(job["root"], "ckpt")
    CKPT.save(ckpt, 1, states["llama4"], mesh=quad,
              specs=state_specs(cfg, quad))
    dist.barrier()
    for ranks in ((0, 1), (2, 3)):
        mesh = _mesh((1, 2), ranks)
        if rank in ranks:
            sspecs = state_specs(cfg, mesh)
            restored, _, step = CKPT.restore(
                ckpt, _zero_state(job, cfg, mesh), mesh=mesh, specs=sspecs)
            out["restored_1x2"] = (step, [x.detach().clone() for x in
                                          M.tree_leaves(S.gather_tree(
                                              restored, sspecs, mesh))])
    return out


def _zero_state(job, cfg, mesh):
    """A TrainState of llama4's job parameters cut to this rank's pieces
    on `mesh`, with a zero AdamW state: what a restore fills."""
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.parallel import sharding as S
    from repro_torch.train import optimizer as TO
    from repro_torch.train.train_state import TrainState, param_specs

    params = params_from_numpy(job["params"]["llama4"], "cpu",
                               dtype=torch.float32)
    if mesh is not None:
        params = S.shard_tree(params, param_specs(cfg, mesh), mesh)
    opt = TO.AdamW(schedule=TO.constant_lr(1e-3))
    return TrainState(step=torch.zeros((), dtype=torch.int32),
                      params=params, opt_state=opt.init(params))


def launcher_body(rank, world, job):
    """`launch.train.main(job["argv"])` on this world under the fp32
    policy: what it printed."""
    from repro_torch.core import precision as TP
    from repro_torch.launch import train

    buf = io.StringIO()
    with TP.use_policy(TP.PrecisionPolicy(input_format="fp32")), \
            contextlib.redirect_stdout(buf):
        train.main(job["argv"])
    return buf.getvalue()


def train_world(rank: int, world: int, root: str):
    run_world(rank, world, root, train_body)


def launcher_world(rank: int, world: int, root: str):
    run_world(rank, world, root, launcher_body)
