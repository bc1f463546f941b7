"""Rank programs for tests/test_torch_parallel.py, and the harness every
spawned world of the port's mesh tests shares (tests/_torch_*_ranks.py):
gloo worlds on the CPU (a `FileStore` under the world's own directory, no
port), importing torch and the port only. A world reads its job from
`job.pkl` (`_job`) and writes what it computed with `torch.save` under
its directory (`run_world`); the test process compares."""
from __future__ import annotations

import contextlib
import io
import os
import pickle

import torch
import torch.distributed as dist

NAMES = ("data", "model")
# the meshes the sharded steps run on: the two 2-rank meshes side by side
# (ranks 0-1 and 2-3 of a world of 4), then the two 4-rank meshes
PAIRS = (((1, 2), (0, 1)), ((2, 1), (2, 3)))
QUADS = ((2, 2), (1, 4))


def _init(rank: int, world: int, root: str):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(root, f"store{world}"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)


def _mesh(shape, ranks):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.tensor(list(ranks)).reshape(shape),
                      mesh_dim_names=NAMES)


def _job(root):
    with open(os.path.join(root, "job.pkl"), "rb") as f:
        return pickle.load(f)


def run_world(rank: int, world: int, root: str, body):
    """A world's rank: `body(rank, world, job)` between the group's start
    and end (`job["root"]` the world's directory), its result saved to
    `<root>/rank<rank>.pt`."""
    _init(rank, world, root)
    out = body(rank, world, _job(root) | {"root": root})
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _bits(x):
    return x.detach().contiguous().view(torch.int32)


def _same_on(x, group) -> bool:
    """Whether `x` has the same bits on every rank of `group`."""
    from repro_torch.parallel.collectives import all_gather

    b = _bits(x).reshape(1, -1)
    every = all_gather(b, 0, group)
    return bool((every == every[0]).all())


def _streams(sched):
    return {r.rid: list(r.tokens) for r in sched.finished}


def _shards(cfg, params, mesh):
    """This rank's shards of the whole tree (`param_specs`)."""
    from repro_torch.parallel import sharding as S

    return S.shard_tree(params, S.param_specs(cfg, params, mesh), mesh)


SUMMARY_KEYS = ("requests", "generated_tokens", "pages_leaked", "disagg",
                "prefix_hits", "kv_layout", "nonfinite_logits",
                "decode_itl_p50_ms")


def driver_runs(runs, params, by_run=None):
    """`launch.serve.main` once a run of `runs` ({name: argv}) on this
    world under the fp32 policy (the launcher builds the mesh of the whole
    world its `--model-parallel` names; `params` are this rank's shards on
    it, or `by_run[name]` where given: None draws them from `--seed`):
    each run's digest, streams, what it printed and its summary's
    SUMMARY_KEYS; or the ValueError it raised."""
    from repro_torch.core import precision as TP
    from repro_torch.launch import serve as drv

    out = {}
    for name, argv in runs.items():
        buf = io.StringIO()
        try:
            with TP.use_policy(TP.PrecisionPolicy(input_format="fp32")), \
                    contextlib.redirect_stdout(buf):
                summary, sched, _ = drv.main(
                    argv, return_state=True,
                    params=(by_run or {}).get(name, params))
        except ValueError as e:
            out[name] = {"error": str(e)}
            continue
        # a frontend arch's static waves return their token arrays
        streams = _streams(sched) if hasattr(sched, "finished") else None
        out[name] = {"digest": summary["stream_digest"],
                     "streams": streams, "stdout": buf.getvalue(),
                     "summary": {k: summary.get(k) for k in SUMMARY_KEYS}}
    return out


def engine_streams(cfg, params, mesh=None, layouts=("paged",), stream=None,
                   prompts=None, cache_len: int = 24, batch: int = 2,
                   sample_seed: int | None = None,
                   disagg: bool | None = None):
    """The engine on `params` (whole; cut to this rank's shards under
    `mesh`) under the fp32 policy, `batch` slots on 8-token pages, a run a
    KV layout: the requests `build_requests(**stream)` draws, or `prompts`
    [(tokens, max_new), ...]; greedy, or sampled from a generator seeded
    `sample_seed`; `disagg` the engine's two-pool switch. Returns
    {layout: (streams, pages_leaked, nonfinite_logits, digest)}."""
    from repro_torch.core import precision as TP
    from repro_torch.launch import serve as drv
    from repro_torch.parallel import sharding as S
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import SlotScheduler

    ctx = S.using_mesh(mesh) if mesh is not None else contextlib.nullcontext()
    out = {}
    with ctx, TP.use_policy(TP.PrecisionPolicy(input_format="fp32")):
        if mesh is not None:
            params = _shards(cfg, params, mesh)
        for layout in layouts:
            eng = ServeEngine(cfg, params, batch=batch, cache_len=cache_len,
                              eos_id=-1, sync_every=2, kv_layout=layout,
                              page_size=8, disagg=disagg, device="cpu")
            sched = SlotScheduler(batch, eos_id=-1)
            if stream is not None:
                drv.build_requests(sched, cfg, **stream)
            for p, n in prompts or ():
                sched.submit(p, max_new_tokens=n)
            summary = (eng.serve(sched) if sample_seed is None else
                       eng.serve(sched, greedy=False,
                                 rng=torch.Generator().manual_seed(
                                     sample_seed)))
            out[layout] = (_streams(sched), summary.get("pages_leaked"),
                           summary["nonfinite_logits"],
                           drv.stream_digest(sched.finished))
    return out


def _step(job, arch, accum, fmt, mesh):
    """One sharded train step from the job's full numpy parameters and
    global batch: (loss, the gradients gathered whole, the parameters
    after the update gathered whole, whether every replicated leaf's
    bits equal across the model axis, the state)."""
    from repro_torch.core import precision as TP
    from repro_torch.models import model as M
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.parallel import sharding as S
    from repro_torch.parallel.collectives import all_gather
    from repro_torch.train import optimizer as TO
    from repro_torch.train.step import make_train_step
    from repro_torch.train.train_state import TrainState, param_specs

    cfg = job["cfgs"][arch]
    specs = param_specs(cfg, mesh)
    coords = S.mesh_coords(mesh)
    full = params_from_numpy(job["params"][arch], "cpu",
                             dtype=torch.float32)
    params = S.shard_tree(full, specs, mesh, coords)
    for p in M.tree_leaves(params):
        p.requires_grad_(True)
    opt = TO.AdamW(schedule=TO.warmup_cosine(**job["sched"]))
    state = TrainState(step=torch.zeros((), dtype=torch.int32),
                       params=params, opt_state=opt.init(params))
    batch = {k: S.shard_leaf(torch.from_numpy(v), S.data_specs(mesh, v.shape),
                             mesh, coords)
             for k, v in job["batch"][arch].items()}
    got = {}

    def on_grads(loss, nll, grads):
        got["loss"] = float(loss)
        got["grads"] = [g.clone() for g in M.tree_leaves(
            S.gather_tree(grads, specs, mesh))]

    pol = TP.PrecisionPolicy(input_format=fmt, backend="cuda")
    with TP.use_policy(pol):
        state, m = make_train_step(cfg, opt, accum, mesh=mesh,
                                   on_grads=on_grads)(state, batch)
    # replicated leaves: the same bits on every rank of the model axis
    same = True
    group = mesh.get_group("model")
    for p, sp in zip(M.tree_leaves(state.params),
                     S.spec_leaves(specs, state.params)):
        if not S.is_sharded(sp, mesh) and mesh.shape[1] > 1:
            bits = p.detach().reshape(1, -1).contiguous().view(torch.int32)
            every = all_gather(bits, 0, group)
            same &= bool((every == every[0]).all())
    params_after = [p.detach().clone() for p in M.tree_leaves(
        S.gather_tree(state.params, specs, mesh))]
    return (got["loss"], got["grads"], params_after, same,
            float(m["grad_norm"]), state)


def target_state(job, mesh=None):
    """A TrainState of qwen's job parameters (the tree the checkpoint
    test restores into; under a mesh this rank's shards)."""
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.parallel import sharding as S
    from repro_torch.train import optimizer as TO
    from repro_torch.train.train_state import TrainState, param_specs

    arch = "qwen2.5-14b"
    params = params_from_numpy(job["params"][arch], "cpu",
                               dtype=torch.float32)
    if mesh is not None:
        params = S.shard_tree(params, param_specs(job["cfgs"][arch], mesh),
                              mesh)
    opt = TO.AdamW(schedule=TO.constant_lr(1e-3))
    return TrainState(step=torch.zeros((), dtype=torch.int32),
                      params=params, opt_state=opt.init(params))


def sharded_world(rank: int, world: int, root: str):
    """The sharded steps on every mesh, the checkpoint saved at (1, 2)
    and restored at (2, 2), and compressed_psum over the world."""
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding as S
    from repro_torch.parallel.compression import compressed_psum
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train.train_state import TrainState, state_specs

    _init(rank, world, root)
    with open(os.path.join(root, "job.pkl"), "rb") as f:
        job = pickle.load(f)
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
                    if (shape == (1, 2) and arch == "qwen2.5-14b"
                            and accum == 1 and fmt == "bf16"):
                        cfg = job["cfgs"][arch]
                        st = TrainState(step=state.step,
                                        params=state.params,
                                        opt_state=state.opt_state)
                        CKPT.save(ckpt, 1, st, mesh=mesh,
                                  specs=state_specs(cfg, mesh))
        if rank == ranks[0]:
            torch.save(out, os.path.join(root, f"steps_{shape[0]}x"
                                               f"{shape[1]}.pt"))
    dist.barrier()
    # the checkpoint written at (1, 2) restored at (2, 2)
    mesh = quads[0]
    cfg = job["cfgs"]["qwen2.5-14b"]
    sspecs = state_specs(cfg, mesh)
    restored, _, step = CKPT.restore(ckpt, target_state(job, mesh),
                                     mesh=mesh, specs=sspecs)
    whole = [x.detach().clone() for x in M.tree_leaves(
        S.gather_tree(restored, sspecs, mesh))]
    if rank == 0:
        torch.save({"step": step, "leaves": whole},
                   os.path.join(root, "restored_2x2.pt"))
    # compressed_psum over the world, each rank its own gradient tree
    comp = {}
    for codec in ("int8", "bf16", "none"):
        g = {"a": torch.from_numpy(job["comp"]["grads"][rank]),
             "b": {"c": torch.from_numpy(job["comp"]["grads2"][rank])}}
        r = {"a": torch.from_numpy(job["comp"]["resid"][rank]),
             "b": {"c": torch.from_numpy(job["comp"]["resid2"][rank])}}
        summed, resid = compressed_psum(g, None, codec, r)
        comp[codec] = (M.tree_leaves(summed), M.tree_leaves(resid))
    torch.save(comp, os.path.join(root, f"comp_{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def launcher_world(rank: int, world: int, root: str, argv: list):
    """The training driver in a world of `world` ranks."""
    import contextlib
    import io

    from repro_torch.launch import train

    _init(rank, world, root)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(argv)
    with open(os.path.join(root, f"launcher_{rank}.txt"), "w") as f:
        f.write(buf.getvalue())
    dist.destroy_process_group()
