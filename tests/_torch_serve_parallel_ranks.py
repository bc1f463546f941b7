"""Rank programs for tests/test_torch_serve_parallel.py: spawned gloo
worlds on the CPU, on the shared harness of tests/_torch_parallel_ranks.py.
Each rank writes what it served with `torch.save` under the world's
directory; the test process compares."""
from __future__ import annotations

import torch

from _torch_parallel_ranks import (_mesh, _shards, _streams, driver_runs,
                                   engine_streams, run_world)


def _clocked_serve(job, cfg, params, mesh, rank):
    """The engine on a stream arriving at a rate, each rank reading a
    clock of its own speed (rank r's advances (r + 1) · 3 ms a reading):
    every request's slot and times, and the streams."""
    from repro_torch.core import precision as TP
    from repro_torch.launch import serve as drv
    from repro_torch.parallel import sharding as S
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import SlotScheduler

    ticks = [0.0]

    def clock():
        ticks[0] += (rank + 1) * 0.003
        return ticks[0]

    with S.using_mesh(mesh), TP.use_policy(
            TP.PrecisionPolicy(input_format="fp32")):
        eng = ServeEngine(cfg, _shards(cfg, params, mesh), batch=2,
                          cache_len=24, eos_id=-1, sync_every=2,
                          page_size=8, device="cpu")
        sched = SlotScheduler(2, eos_id=-1)
        drv.build_requests(sched, cfg, 6, 40.0, [6, 10], 4, seed=1)
        eng.serve(sched, clock=clock)
    return {"streams": _streams(sched),
            "times": {r.rid: (r.slot, r.t_admitted, r.t_first_token,
                              r.t_done) for r in sched.finished}}


def _handoff(job, cfg, mesh):
    """(g): the whole fragment through `reshard_handoff` (this rank's
    piece), scattered and bound into this rank's piece of the pool
    (`cache_specs`), then the pool gathered whole."""
    from repro_torch.models.convert import cache_from_numpy
    from repro_torch.parallel import sharding as S
    from repro_torch.serve.engine import ServeEngine

    h = job["handoff"][tuple(mesh.shape)]
    pool = cache_from_numpy(h["pool"], "cpu")
    specs = S.cache_specs(cfg, pool, mesh, pool[0]["kv"].block_table.shape[1])
    mine = S.shard_tree(pool, specs, mesh)
    frag = S.reshard_handoff(cache_from_numpy(h["frag"], "cpu"), mesh, cfg)
    heads = [c["kv"].k.shape[3] for c in frag]
    mine = ServeEngine._insert_impl(mine, frag, h["slot"],
                                    torch.from_numpy(h["row"]), 0)
    return {"frag_heads": heads,
            "pool": [x.clone() for x in _leaves(S.gather_tree(mine, specs,
                                                              mesh))]}


def _leaves(tree):
    from repro_torch.models.model import tree_leaves
    return tree_leaves(tree)


def serve_world(rank: int, world: int, root: str):
    """The world's driver runs, then (where the job asks) the clocked
    engine and the handoff, on the (1, world) mesh."""
    run_world(rank, world, root, _serve_body)


def _serve_body(rank, world, job):
    from repro_torch.models.convert import params_from_numpy

    cfg = job["cfg"]
    params = params_from_numpy(job["params"], "cpu")
    mesh = _mesh((1, world), range(world))
    # a run at another mesh than (1, world) takes its own weights: the
    # whole tree at (world, 1), or those `--seed` draws
    by_run = {name: params for name in job.get("whole_weights", ())}
    by_run |= {name: None for name in job.get("own_weights", ())}
    out = {"runs": driver_runs(job["runs"], _shards(cfg, params, mesh),
                               by_run)}
    if job.get("clocked"):
        out["clocked"] = _clocked_serve(job, cfg, params, mesh, rank)
    if job.get("handoff"):
        out["handoff"] = _handoff(job, cfg, mesh)
    if job.get("engine"):
        out["engine"] = _engine_stream(job["engine"], mesh)
    if job.get("generate"):
        out["generate"] = _generate(job, cfg, params, mesh)
    return out


def _engine_stream(e, mesh):
    """The engine on another arch's weights (`e`: its cfg, numpy params,
    prompts and budgets) on the mesh, paged and ring, under the fp32
    policy: the streams and summaries."""
    from repro_torch.models.convert import params_from_numpy

    got = engine_streams(e["cfg"], params_from_numpy(e["params"], "cpu"),
                         mesh, ("paged", "ring"),
                         prompts=list(zip(e["prompts"], e["budgets"])),
                         cache_len=32)
    return {layout: r[:3] for layout, r in got.items()}


def _generate(job, cfg, params, mesh):
    """`ServeEngine.generate` (the static batch on rings) on the mesh."""
    from repro_torch.core import precision as TP
    from repro_torch.launch import serve as drv
    from repro_torch.parallel import sharding as S
    from repro_torch.serve.engine import ServeEngine

    prompts, n = job["generate"]
    with S.using_mesh(mesh), TP.use_policy(
            TP.PrecisionPolicy(input_format="fp32")):
        eng = ServeEngine(cfg, _shards(cfg, params, mesh),
                          batch=len(prompts), cache_len=24, eos_id=-1,
                          sync_every=2, device="cpu")
        return eng.generate(torch.tensor(prompts), n)
