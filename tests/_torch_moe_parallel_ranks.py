"""Rank programs for tests/test_torch_moe_parallel.py: spawned gloo worlds
on the CPU, on the shared harness of tests/_torch_parallel_ranks.py. Each
rank writes what it computed with `torch.save` under the world's
directory; the test process compares."""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from _torch_parallel_ranks import (_bits, _init, _job, _mesh, _same_on,
                                   _step, driver_runs, engine_streams,
                                   run_world)

# the MoE layer alone: (case, mesh shape, ranks)
LAYER_MESHES = (("granite", (1, 2), (0, 1)), ("granite", (1, 4), range(4)),
                ("granite", (1, 3), (0, 1, 2)),
                ("llama4", (1, 2), (0, 1)), ("llama4", (1, 4), range(4)),
                ("llama4", (1, 3), (0, 1, 2)),
                ("granite_e6", (1, 4), range(4)))
# the sharded train steps: the two 2-rank meshes side by side, then the
# two 4-rank meshes
PAIRS = (((1, 2), (0, 1)), ((2, 1), (2, 3)))
QUADS = ((2, 2), (1, 4))


def _layer_shards(cfg, p, mesh):
    """This rank's pieces of one MoE layer's leaves, by the stacked
    layer's `param_specs`."""
    from repro_torch.parallel import sharding as S

    tree = {"layers": ({"moe": {k: v[None] for k, v in p.items()}},)}
    mine = S.shard_tree(tree, S.param_specs(cfg, tree, mesh), mesh)
    return {k: v[0] for k, v in mine["layers"][0]["moe"].items()}


def _layer(job, case, mesh):
    """The MoE layer on `case`'s weights and x, both dispatches, exact
    and approx, under the fp32 policy: each run's output and combine, and
    whether every rank of the mesh holds the same bits."""
    from repro_torch.core import precision as TP
    from repro_torch.models import moe
    from repro_torch.parallel import sharding as S

    cfg, p, x = job["layer"][case]
    p = _layer_shards(cfg, {k: torch.from_numpy(v) for k, v in p.items()},
                      mesh)
    x = torch.from_numpy(x)
    group = mesh.get_group("model")
    out = {}
    for dropless in (True, False):
        for mode in ("exact", "approx"):
            with S.using_mesh(mesh), TP.use_policy(TP.PrecisionPolicy(
                    input_format="fp32", mode=mode)):
                y, _ = moe.moe_ffn(x, p, cfg, cfg.act, dropless=dropless,
                                   with_aux=False)
                combine, _ = moe.router(x, p["router"],
                                        cfg.experts_per_token, False)
            out[(dropless, mode)] = {
                "out": y.detach().clone(), "combine": combine.detach().clone(),
                "same": _same_on(y, group) and _same_on(combine, group)}
    return out


def _load_balance(job, mesh):
    """The forward's `load_balance` (summed over the layers) on this data
    rank's half of the job's two-half batch, under the fp32 policy."""
    from repro_torch.core import precision as TP
    from repro_torch.models import model as M
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.parallel import sharding as S
    from repro_torch.train.train_state import param_specs

    arch = "granite-moe-3b-a800m"
    cfg = job["cfgs"][arch]
    full = params_from_numpy(job["params"][arch], "cpu",
                             dtype=torch.float32)
    params = S.shard_tree(full, param_specs(cfg, mesh), mesh)
    toks = torch.from_numpy(job["lb_tokens"])
    rows = S.shard_leaf(toks, S.data_specs(mesh, toks.shape), mesh,
                        S.mesh_coords(mesh))
    with S.using_mesh(mesh), TP.use_policy(TP.PrecisionPolicy(
            input_format="fp32")):
        _, _, aux = M.forward(params, cfg, rows)
    return float(aux["load_balance"]), rows.shape[0]


def _state_of(job, arch, mesh=None):
    """A TrainState of `arch`'s job parameters (under a mesh this rank's
    shards): the tree the checkpoint test restores into."""
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.parallel import sharding as S
    from repro_torch.train import optimizer as TO
    from repro_torch.train.train_state import TrainState, param_specs

    params = params_from_numpy(job["params"][arch], "cpu",
                               dtype=torch.float32)
    if mesh is not None:
        params = S.shard_tree(params, param_specs(job["cfgs"][arch], mesh),
                              mesh)
    opt = TO.AdamW(schedule=TO.constant_lr(1e-3))
    return TrainState(step=torch.zeros((), dtype=torch.int32),
                      params=params, opt_state=opt.init(params))


def train_world(rank: int, world: int, root: str):
    """The MoE layer alone on every layer mesh, the sharded train steps on
    every mesh, the global load-balance loss at (2, 1), and a checkpoint
    saved at (1, 2) and restored at (2, 2)."""
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding as S
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train.train_state import TrainState, state_specs

    _init(rank, world, root)
    job = _job(root)
    layer_meshes = [(case, _mesh(shape, ranks), ranks)
                    for case, shape, ranks in LAYER_MESHES]
    for case, mesh, ranks in layer_meshes:
        if rank in ranks:
            got = _layer(job, case, mesh)
            if rank == ranks[0]:
                shape = tuple(mesh.shape)
                torch.save(got, os.path.join(
                    root, f"layer_{case}_{shape[0]}x{shape[1]}.pt"))
    pairs = [(_mesh(shape, ranks), ranks) for shape, ranks in PAIRS]
    quads = [_mesh(shape, range(4)) for shape in QUADS]
    ckpt = os.path.join(root, "ckpt")
    runs = [(m, r) for m, r in pairs if rank in r] + [(m, range(4))
                                                      for m in quads]
    for mesh, ranks in runs:
        shape = tuple(mesh.shape)
        out = {}
        for arch in job["cfgs"]:
            for accum in (1, 2):
                for fmt in ("bf16", "fp32"):
                    loss, grads, after, same, gnorm, state = _step(
                        job, arch, accum, fmt, mesh)
                    out[(arch, accum, fmt)] = {
                        "loss": loss, "grads": grads, "after": after,
                        "same": same, "grad_norm": gnorm}
                    if (shape == (1, 2) and arch == job["ckpt_arch"]
                            and accum == 1 and fmt == "bf16"):
                        cfg = job["cfgs"][arch]
                        CKPT.save(ckpt, 1, TrainState(
                            step=state.step, params=state.params,
                            opt_state=state.opt_state), mesh=mesh,
                            specs=state_specs(cfg, mesh))
        if shape == (2, 1):
            out["load_balance"] = _load_balance(job, mesh)
        if rank == ranks[0]:
            torch.save(out, os.path.join(root, f"steps_{shape[0]}x"
                                               f"{shape[1]}.pt"))
    dist.barrier()
    # the checkpoint written at (1, 2) restored at (2, 2)
    mesh = quads[0]
    arch = job["ckpt_arch"]
    sspecs = state_specs(job["cfgs"][arch], mesh)
    restored, _, step = CKPT.restore(ckpt, _state_of(job, arch, mesh),
                                     mesh=mesh, specs=sspecs)
    whole = [x.detach().clone() for x in M.tree_leaves(
        S.gather_tree(restored, sspecs, mesh))]
    if rank == 0:
        torch.save({"step": step, "leaves": whole},
                   os.path.join(root, "restored_2x2.pt"))
    dist.barrier()
    dist.destroy_process_group()


def serve_world(rank: int, world: int, root: str):
    """`launch.serve.main` once a run of the job's, on this world's (1, 2)
    mesh (each arch's shards of the job's weights), under the fp32
    policy: each run's digest, streams and summary, or the ValueError it
    raised; then the engine on a (1, 1) mesh of rank 0."""
    run_world(rank, world, root, _serve_body)


def _serve_body(rank, world, job):
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.parallel import sharding as S

    mesh = _mesh((1, world), range(world))
    out = {}
    for arch, (cfg, np_params) in job["weights"].items():
        params = params_from_numpy(np_params, "cpu")
        shards = S.shard_tree(params, S.param_specs(cfg, params, mesh), mesh)
        for name, r in driver_runs(job["runs"][arch], shards).items():
            out[(arch, name)] = r
    one = _mesh((1, 1), (0,))
    if rank == 0:
        out["one_rank"] = {arch: engine_digest(cfg, np_params,
                                               job["stream"], one)
                           for arch, (cfg, np_params)
                           in job["weights"].items()}
    return out


def engine_digest(cfg, np_params, stream, mesh=None):
    """The paged engine on `stream` (build_requests' arguments) under the
    fp32 policy, on `mesh` where given: the stream digest."""
    from repro_torch.models.convert import params_from_numpy

    return engine_streams(cfg, params_from_numpy(np_params, "cpu"), mesh,
                          stream=stream)["paged"][3]
