"""Rank programs for tests/test_torch_family_parallel.py: a spawned gloo
world of 4 on the CPU, on the shared harness of
tests/_torch_parallel_ranks.py. The rank writes what it computed with
`torch.save` under the world's directory; the test process compares."""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from _torch_parallel_ranks import (_bits, _mesh, _same_on, _shards, _step,
                                   driver_runs, engine_streams, run_world)

# the training steps: each 2-rank mesh a half of the archs, the two side
# by side; then every arch at (1, 4) and one SSM arch at (2, 2)
PAIR_ARCHS = {(0, 1): ("mamba2", "hymba"), (2, 3): ("whisper", "pixtral")}
QUAD_ARCHS = {(1, 4): ("mamba2", "hymba", "hymba_h5", "whisper", "pixtral"),
              (2, 2): ("mamba2",)}
# the serve runs: each 2-rank mesh its half of the archs, then every arch
# at (1, 4), where the serve launcher's runs (`launch.serve.main`
# builds the mesh of the whole world) come too
SERVE_ARCHS = {**PAIR_ARCHS, (0, 1, 2, 3): QUAD_ARCHS[(1, 4)]}


def train_world(rank: int, world: int, root: str):
    run_world(rank, world, root, _train_body)


def _train_body(rank, world, job):
    """The sharded steps (accum 1 and 2, bf16 and fp32 policies) of each
    mesh's archs, a checkpoint of mamba2's (1, 2) step, then the serve
    runs, the mixer alone and whisper's logit columns."""
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train.train_state import TrainState, state_specs

    out = {"steps": {}, "serve": {}, "mixer": {}, "columns": {}}
    # every rank builds every mesh, in one order (each a collective)
    pairs = {ranks: _mesh((1, 2), ranks) for ranks in PAIR_ARCHS}
    quads = {shape: _mesh(shape, range(4)) for shape in QUAD_ARCHS}
    one = _mesh((1, 1), (0,))
    meshes = [(pairs[ranks], archs) for ranks, archs in PAIR_ARCHS.items()
              if rank in ranks]
    meshes += [(quads[shape], archs) for shape, archs in QUAD_ARCHS.items()]
    for mesh, archs in meshes:
        shape = tuple(mesh.shape)
        for arch in archs:
            for accum in (1, 2):
                for fmt in ("bf16", "fp32"):
                    loss, grads, after, same, _, state = _step(
                        job, arch, accum, fmt, mesh)
                    out["steps"][(arch, shape, accum, fmt)] = {
                        "loss": loss, "grads": grads, "after": after,
                        "same": same}
                    if (shape == (1, 2) and arch == "mamba2" and accum == 1
                            and fmt == "bf16"):
                        CKPT.save(os.path.join(job["root"], "ckpt"), 1,
                                  TrainState(step=state.step,
                                             params=state.params,
                                             opt_state=state.opt_state),
                                  mesh=mesh,
                                  specs=state_specs(job["cfgs"][arch], mesh))
    for ranks, archs in SERVE_ARCHS.items():
        if rank not in ranks:
            continue
        mesh = pairs[ranks] if len(ranks) == 2 else quads[(1, 4)]
        shape = tuple(mesh.shape)
        for arch in archs:
            out["serve"][(arch, shape)] = _serve(job, arch, mesh)
            if arch in job["mixer"]:
                out["mixer"][(arch, shape)] = _mixer(job, arch, mesh)
        if shape == (1, 4):
            out["columns"] = _columns(job, "whisper", mesh)
    if rank == 0:
        out["one_rank"] = {arch: _serve(job, arch, one)
                           for arch in ("mamba2", "hymba")}
    return out


def _params(job, arch):
    from repro_torch.models.convert import params_from_numpy

    return params_from_numpy(job["params"][arch], "cpu")


def _serve(job, arch, mesh):
    """An SSM or hybrid arch: the engine on the job's prompts, paged and
    ring, and the serve launcher's runs; a frontend arch: `generate(frontend=)`
    on the job's rows and the serve launcher's static waves. Under the fp32
    policy, on this rank's shards of the job's weights."""
    from repro_torch.core import precision as TP
    from repro_torch.parallel import sharding as S
    from repro_torch.serve.engine import ServeEngine

    cfg, params = job["cfgs"][arch], _params(job, arch)
    out = {}
    if cfg.frontend_tokens:
        toks, fe, n = job["generate"][arch]
        with S.using_mesh(mesh), TP.use_policy(
                TP.PrecisionPolicy(input_format="fp32")):
            eng = ServeEngine(cfg, _shards(cfg, params, mesh),
                              batch=len(toks), cache_len=32, eos_id=-1,
                              sync_every=3, device="cpu")
            out["generate"] = eng.generate(torch.from_numpy(toks), n,
                                           frontend=torch.from_numpy(fe))
            out["nonfinite"] = eng.last_stats["nonfinite_logits"]
    else:
        got = engine_streams(cfg, params, mesh, ("paged", "ring"),
                             prompts=job["prompts"][arch], cache_len=32)
        out["engine"] = {k: v[:3] for k, v in got.items()}
        out["cache"] = _cache_shapes(cfg, mesh)
    if arch in job["runs"] and tuple(mesh.shape) == (1, 4):
        out["driver"] = driver_runs(
            {name: argv + ["--model-parallel", str(mesh.shape[1])]
             for name, argv in job["runs"][arch].items()},
            _shards(cfg, params, mesh))
    return out


def _cache_shapes(cfg, mesh):
    """The engine's pool on the mesh: each leaf's path and shape."""
    from repro_torch.core import precision as TP
    from repro_torch.parallel import sharding as S
    from repro_torch.serve.engine import ServeEngine

    with S.using_mesh(mesh), TP.use_policy(TP.PrecisionPolicy(
            input_format="fp32")):
        eng = ServeEngine(cfg, {"embed": torch.zeros(1)}, batch=2,
                          cache_len=32, page_size=8, device="cpu")
        pool = eng.new_pool()
    out = {}
    S.tree_map_with_path(lambda p, x: out.__setitem__(
        "/".join(map(str, p)), tuple(x.shape)), pool)
    return out


def _mixer(job, arch, mesh):
    """The Mamba2 mixer alone (the first layer's leaves, this rank's
    pieces) on the job's x, from a zero state and from the job's state
    (one decode token), under the fp32 policy: in_proj's gathered output,
    the mixer's output, the new state, and whether every rank holds the
    same bits of each."""
    from repro_torch.core import precision as TP
    from repro_torch.models import ssm
    from repro_torch.parallel import sharding as S

    cfg, p, x, state, tail = job["mixer"][arch]
    tree = {"layers": ({"ssm": {k: torch.from_numpy(v)[None]
                                for k, v in p.items()}},)}
    mine = _shards(cfg, tree, mesh)["layers"][0]["ssm"]
    mine = {k: v[0] for k, v in mine.items()}
    group = mesh.get_group("model")
    out = {}
    with S.using_mesh(mesh), TP.use_policy(TP.PrecisionPolicy(
            input_format="fp32")):
        for name, xs, st, tl in (
                ("chunked", torch.from_numpy(x), None, None),
                ("decode", torch.from_numpy(x[:, :1]),
                 torch.from_numpy(state), torch.from_numpy(tail))):
            proj, _ = ssm._tp_mixer_params(xs, mine, cfg)
            y, (new_state, _) = ssm.mamba2_block(xs, mine, cfg, state=st,
                                                 conv_cache=tl)
            out[name] = {"in_proj": proj.detach().clone(),
                         "out": y.detach().clone(),
                         "state": new_state.detach().clone(),
                         "same": all(_same_on(t, group)
                                     for t in (proj, y, new_state))}
    out["cut"] = {k: tuple(v.shape) for k, v in mine.items()}
    return out


def _columns(job, arch, mesh):
    """The training forward's logits on this rank (its vocabulary
    columns, not gathered): which columns are -inf."""
    from repro_torch.core import precision as TP
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding as S

    cfg, params = job["cfgs"][arch], _params(job, arch)
    toks, fe, _ = job["generate"][arch]
    with S.using_mesh(mesh), TP.use_policy(TP.PrecisionPolicy(
            input_format="fp32")), torch.no_grad():
        logits, _, _ = M.forward(_shards(cfg, params, mesh), cfg,
                                 torch.from_numpy(toks),
                                 frontend_embeds=torch.from_numpy(fe))
    inf = torch.isneginf(logits).all(dim=(0, 1))
    return {"n": logits.shape[-1], "masked": inf.nonzero()[:, 0].tolist(),
            "finite_elsewhere": bool(torch.isfinite(logits[..., ~inf]).all()),
            "rank": dist.get_rank(mesh.get_group("model"))}

