"""Rank programs for tests/test_torch_dryrun.py: a spawned gloo world of 4
on the CPU (the shared harness of tests/_torch_parallel_ranks.py) that
runs the same train steps and the same paged serve on the (data 2,
model 2) mesh and on the (pod 2, data 1, model 2) mesh, and a spawned
process that counts the same steps on the meta device as each rank of
those meshes under the `fake` backend. Each writes what it computed with
`torch.save` under its directory; the test process compares."""
from __future__ import annotations

import os

import torch

from _torch_parallel_ranks import _bits, _mesh, engine_streams, run_world

MESHES = {"2x2": (("data", "model"), (2, 2)),
          "2x1x2": (("pod", "data", "model"), (2, 1, 2))}


def _device_mesh(key):
    from torch.distributed.device_mesh import DeviceMesh

    names, shape = MESHES[key]
    if len(shape) == 2:
        return _mesh(shape, range(4))
    return DeviceMesh("cpu", torch.arange(4).reshape(shape),
                      mesh_dim_names=names)


def _step(job, name, mesh):
    """One train step of `name` (bf16 policy, the `cuda` backend, accum 1)
    from the job's whole parameters and batch, its collectives counted
    (`launch.cost.CostCounter` around the step alone): the loss, the
    gradients (gathered whole after the step), the parameters after the
    update (whole), the clip norm, the collectives."""
    from repro_torch.core import precision as TP
    from repro_torch.launch.cost import CostCounter
    from repro_torch.models import model as M
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.parallel import sharding as S
    from repro_torch.train import optimizer as TO
    from repro_torch.train.step import make_train_step
    from repro_torch.train.train_state import TrainState, param_specs

    cfg = job["cfgs"][name]
    specs = param_specs(cfg, mesh)
    coords = S.mesh_coords(mesh)
    full = params_from_numpy(job["params"][name], "cpu", dtype=torch.float32)
    params = S.shard_tree(full, specs, mesh, coords)
    for p in M.tree_leaves(params):
        p.requires_grad_(True)
    opt = TO.AdamW(schedule=TO.warmup_cosine(**job["sched"]))
    state = TrainState(step=torch.zeros((), dtype=torch.int32),
                       params=params, opt_state=opt.init(params))
    batch = {k: S.shard_leaf(torch.from_numpy(v), S.data_specs(mesh, v.shape),
                             mesh, coords)
             for k, v in job["batch"][name].items()}
    got = {}

    def on_grads(loss, nll, grads):
        got["loss"] = loss.clone()
        got["grads"] = M.tree_map(lambda g: g.detach().clone(), grads)

    step = make_train_step(cfg, opt, 1, mesh=mesh, on_grads=on_grads)
    with TP.use_policy(TP.PrecisionPolicy(backend="cuda")), \
            CostCounter() as counter:
        state, m = step(state, batch)
    return {"loss": _bits(got["loss"]),
            "grads": [_bits(g) for g in M.tree_leaves(
                S.gather_tree(got["grads"], specs, mesh))],
            "after": [_bits(p) for p in M.tree_leaves(
                S.gather_tree(state.params, specs, mesh))],
            "grad_norm": _bits(m["grad_norm"]),
            "collectives": counter.summary()["collectives"]}


def pod_body(rank, world, job):
    """Every step of the job and the paged serve on both meshes."""
    from repro_torch.models.convert import params_from_numpy

    out = {}
    for key in MESHES:
        mesh = _device_mesh(key)
        for name in job["cfgs"]:
            out[(key, name)] = _step(job, name, mesh)
        cfg = job["cfgs"]["qwen"]
        params = params_from_numpy(job["params"]["qwen"], "cpu",
                                   dtype=torch.float32)
        out[(key, "serve")] = engine_streams(
            cfg, params, mesh, layouts=("paged",), stream=job["stream"],
            cache_len=24, batch=2)["paged"][3]
    return out


def pod_world(rank: int, world: int, root: str):
    run_world(rank, world, root, pod_body)


def meta_world(rank: int, world: int, root: str):
    """One process: each job step's collectives on the meta device as each
    rank of each mesh under the `fake` backend (`launch.dryrun`)."""
    import pickle

    import torch.distributed as dist

    from repro_torch.launch import dryrun as D
    from repro_torch.models.config import ShapeCfg
    from repro_torch.parallel.mesh import MeshSpec

    with open(os.path.join(root, "job.pkl"), "rb") as f:
        job = pickle.load(f)
    shape = ShapeCfg("train", job["seq"], job["batch_rows"], "train")
    out = {}
    for key, (names, sizes) in MESHES.items():
        for name, cfg in job["cfgs"].items():
            for r in range(4):
                rec = D.count_rank(cfg, shape, MeshSpec(names, sizes), r,
                                   accum=1)
                out[(key, name, r)] = rec["collectives"]
    dist.destroy_process_group()
    torch.save(out, os.path.join(root, "meta.pt"))
