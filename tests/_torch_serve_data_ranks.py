"""Rank programs for tests/test_torch_serve_data.py: spawned gloo worlds on
the CPU, on the shared harness of tests/_torch_parallel_ranks.py, serving
over a `data` axis. Each rank writes what it served with `torch.save`
under the world's directory; the test process compares."""
from __future__ import annotations

import torch

from _torch_parallel_ranks import (_mesh, _shards, driver_runs,
                                   engine_streams, run_world)


def data_world(rank: int, world: int, root: str):
    """The world's driver runs on the (world / model, model) mesh the
    launcher builds, then (where the job asks) the engine's streams of
    other archs, `generate()` and the page handoff on that mesh."""
    run_world(rank, world, root, _body)


def _body(rank, world, job):
    from repro_torch.models.convert import params_from_numpy

    cfg = job["cfg"]
    params = params_from_numpy(job["params"], "cpu")
    mesh = _mesh((world // job["model"], job["model"]), range(world))
    out = {"runs": driver_runs(job["runs"], _shards(cfg, params, mesh))}
    for key, e in job.get("engines", {}).items():
        out[key] = engine_streams(e["cfg"],
                                  params_from_numpy(e["params"], "cpu"),
                                  mesh, e["layouts"],
                                  prompts=list(zip(e["prompts"],
                                                   e["budgets"])),
                                  cache_len=e.get("cache_len", 32),
                                  batch=e.get("batch", 2),
                                  sample_seed=e.get("sample_seed"),
                                  disagg=e.get("disagg"))
    for key, g in job.get("generate", {}).items():
        out[key] = _generate(g, mesh)
    if job.get("handoff"):
        out["handoff"] = _handoff(job["handoff"], cfg, mesh)
    return out


def _generate(g, mesh):
    """`ServeEngine.generate` of `g`'s prompts (and frontend) on the mesh
    under the fp32 policy, greedy or sampled from a generator seeded
    `g["sample_seed"]`: the tokens and the non-finite logits."""
    from repro_torch.core import precision as TP
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.parallel import sharding as S
    from repro_torch.serve.engine import ServeEngine

    cfg = g["cfg"]
    with S.using_mesh(mesh), TP.use_policy(
            TP.PrecisionPolicy(input_format="fp32")):
        eng = ServeEngine(cfg, _shards(cfg, params_from_numpy(
            g["params"], "cpu"), mesh), batch=len(g["prompts"]),
            cache_len=g["cache_len"], eos_id=-1, sync_every=2,
            kv_layout="ring", device="cpu")
        frontend = (None if g["frontend"] is None
                    else torch.from_numpy(g["frontend"]))
        seed = g.get("sample_seed")
        out = eng.generate(torch.tensor(g["prompts"]), g["n"],
                           frontend=frontend, greedy=seed is None,
                           rng=None if seed is None
                           else torch.Generator().manual_seed(seed))
    return {"tokens": out, "nonfinite": eng.last_stats["nonfinite_logits"]}


def _handoff(h, cfg, mesh):
    """The two-pool handoff on the data-sharded pool (the JAX package's
    handoff test on this port's layout): the pool's and the fragment's
    specs, and each rank's piece of a recycled pool after the engine's
    splice of a whole prefill fragment (`reshard_handoff` to the rank's
    heads, scattered on the data rank that holds the slot's pages, the
    block-table row bound on every rank), gathered whole by
    `cache_specs`."""
    from repro_torch.models.convert import cache_from_numpy
    from repro_torch.parallel import sharding as S
    from repro_torch.serve.engine import ServeEngine

    pool = cache_from_numpy(h["pool"], "cpu")
    B = pool[0]["kv"].block_table.shape[1]
    specs = S.cache_specs(cfg, pool, mesh, B)
    frag = cache_from_numpy(h["frag"], "cpu")
    with S.using_mesh(mesh):
        eng = ServeEngine(cfg, {"embed": torch.zeros(1)}, batch=B,
                          cache_len=h["seq"], page_size=h["psz"],
                          pool_pages=h["pool_pages"], kv_layout="paged",
                          device="cpu")
        mine = S.shard_tree(pool, specs, mesh)
        fresh = eng.new_pool()
        same_shapes = [tuple(a.shape) for a in _leaves(fresh)] == [
            tuple(a.shape) for a in _leaves(mine)]
        piece = S.reshard_handoff(frag, mesh, cfg)
        owner = eng._local_row(h["slot"]) is not None
        mine = eng._insert_impl(mine, piece if owner else None, h["slot"],
                                torch.from_numpy(h["row"]), 0,
                                eng.page_base, eng._local_row(h["slot"]),
                                eng.dp_rank)
        whole = S.gather_tree(mine, specs, mesh)
    pspec = S.cache_specs(cfg, pool, mesh, B)[0]["kv"]
    fspec = S.handoff_frag_specs(cfg, frag, mesh)[0]["kv"]
    return {"pool_k_spec": tuple(pspec.k), "pool_bt_spec":
            tuple(pspec.block_table), "frag_k_spec": tuple(fspec.k),
            "same_shapes": same_shapes, "owner": owner,
            "pool": [x.clone() for x in _leaves(whole)]}


def _leaves(tree):
    from repro_torch.models.model import tree_leaves
    return tree_leaves(tree)
