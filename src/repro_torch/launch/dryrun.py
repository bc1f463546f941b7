"""The dry run: every (arch x shape x mesh) cell built on the meta device as
one rank of its mesh, and counted. The counterpart of the JAX package's
`repro/launch/dryrun.py`, with no compiler to ask: each cell's own step
(train, prefill, decode, or the two-pool handoff) runs on meta tensors of
the rank's shapes (`launch/specs.py`) under a process group that moves
nothing (`parallel.mesh.make_dry_mesh`), inside a `launch.cost.CostCounter`,
under the card's program (the `cuda` GEMM backend, bf16 containers, the
kernels' routes: what a meta tensor takes).

For each cell it writes artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json
(`REPRO_DRYRUN_DIR` overrides the directory; the JAX file names and
suffixes) with the JAX record's keys, counted here:

  * status (`ok`, `skipped` by the JAX long_500k rule, `refused` for a
    layout `model.check_parallel` refuses, `error`), n_devices;
  * memory: argument, output, temp peak and their sum a rank
    (`peak_estimate_bytes`);
  * flops (the kernels' and the attention functions' work, and matmul
    flops of the other aten ops, `flops_by`); bytes_accessed, the
    kernels' compulsory bytes (`kernel_bytes`), beside `eager_bytes`, what
    the other aten ops move as the port runs them (never merged);
  * collectives: payload bytes by class and their total, and counts;
  * launches by kernel, route and tile (`ops.counts()`'s keys), and
    `host_ops`, the aten ops that would launch on the card;
  * seconds, the cell's wall time on this host.

Each cell runs as rank 0 and as the mesh's last rank (padded heads and
vocabulary columns sit there); rank 0's counts are the record's, and
`last_rank` holds the fields where the last rank's differ. A decode
cell's rows are each at position T - 1 over a full cache of T
(`decode_keys`: the JAX cell's cache length), which the record says.

Usage:
    python -m repro_torch.launch.dryrun --all [--resume] [--jobs N]
    python -m repro_torch.launch.dryrun --arch qwen2.5-14b \\
        --shape decode_32k --mesh pod --kv paged
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs import REGISTRY, get_config
from repro_torch.models.config import SHAPES, SHAPES_BY_NAME
from repro_torch.parallel.mesh import MeshSpec, make_production_mesh

ART_DIR = os.environ.get(
    "REPRO_DRYRUN_DIR",
    os.path.join(os.path.dirname(__file__), "..", "..", "..",
                 "artifacts", "dryrun_torch"))

def _world(spec: MeshSpec) -> int:
    n = 1
    for s in spec.shape:
        n *= s
    return n


def count_step(step, args, mesh, decode_keys=None) -> dict:
    """Run `step(*args)` (meta arguments) as this rank of `mesh` under the
    card's program inside a `CostCounter` → the counter's summary."""
    from repro_torch.core import precision as P
    from repro_torch.launch.cost import CostCounter
    from repro_torch.parallel import sharding as S

    with S.using_mesh(mesh), P.use_policy(P.PrecisionPolicy(
            backend="cuda")), CostCounter(decode_keys) as counter:
        out = step(*args)
    return counter.summary(args, out)


def _fields(summary: dict) -> dict:
    return {"memory": summary["memory"], "flops": summary["flops"],
            "flops_by": summary["flops_by"],
            "bytes_accessed": summary["kernel_bytes"],
            "kernel_bytes": summary["kernel_bytes"],
            "eager_bytes": summary["eager_bytes"],
            "launches": summary["launches"],
            "host_ops": summary["host_ops"],
            "collectives": summary["collectives"]}


def count_rank(cfg, shape, spec: MeshSpec, rank: int, accum=None,
               kv: str = "ring", page_size: int | None = None,
               disagg: bool = False) -> dict:
    """One rank's counts of a cell (`_fields`, and `handoff` with
    `disagg` for a paged decode cell with KV)."""
    from repro_torch.launch import specs as SP
    from repro_torch.parallel.mesh import make_dry_mesh

    page_size = page_size or SP.DEFAULT_PAGE_SIZE
    mesh = make_dry_mesh(spec, rank)
    step, args = SP.input_specs(cfg, shape, mesh, accum=accum,
                                kv_layout=kv, page_size=page_size)
    keys = shape.seq_len if shape.kind == "decode" else None
    rec = _fields(count_step(step, args, mesh, keys))
    del step, args
    if (disagg and shape.kind == "decode" and kv == "paged"
            and cfg.family != "ssm"):
        h_fn, h_args = SP.handoff_specs(cfg, shape, mesh, page_size)
        rec["handoff"] = {k: v for k, v in _fields(
            count_step(h_fn, h_args, mesh)).items()
            if k in ("memory", "flops", "bytes_accessed", "kernel_bytes",
                     "eager_bytes", "host_ops", "collectives")}
    return rec


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             accum: int | None = None, kv: str = "ring",
             disagg: bool = False, cfg=None, shape=None,
             spec: MeshSpec | None = None,
             page_size: int | None = None) -> dict:
    """The record of one cell (see the module's docstring). `cfg`,
    `shape` and `spec` override the registry's config, the shape and the
    production mesh (a cell cut to size)."""
    from repro_torch.launch import specs as SP
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding as S

    cfg = cfg or get_config(arch)
    shape = shape or SHAPES_BY_NAME[shape_name]
    spec = spec or make_production_mesh(multi_pod=(mesh_kind == "multipod"))
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "family": cfg.family, "params": cfg.param_count()}
    if kv != "ring":
        rec["kv_layout"] = kv
    ok, why = SP.cell_is_applicable(cfg, shape)
    if not ok:
        return rec | {"status": "skipped", "reason": why}
    n = _world(spec)
    rec["n_devices"] = n
    sizes = dict(zip(spec.axis_names, spec.shape))
    paged = kv == "paged" and shape.kind == "decode"
    try:
        M.check_parallel(cfg, sizes["model"], S.batch_count(spec),
                         serving=shape.kind != "train",
                         batch=shape.global_batch,
                         kv_layout="paged" if paged else "ring")
    except ValueError as e:
        return rec | {"status": "refused", "reason": str(e)}
    t0 = time.time()
    try:
        first = count_rank(cfg, shape, spec, 0, accum, kv, page_size, disagg)
        rec |= {"status": "ok", **first}
        if shape.kind == "decode":
            rec["decode_keys"] = (f"every row at position {shape.seq_len - 1}"
                                  f" over a full cache of {shape.seq_len}")
        if n > 1:
            last = count_rank(cfg, shape, spec, n - 1, accum, kv, page_size,
                              disagg)
            diff = {k: v for k, v in last.items() if first.get(k) != v}
            if diff:
                rec["last_rank"] = {"rank": n - 1, **diff}
    except Exception as e:  # a failing cell is a fault: record it loudly
        rec |= {"status": "error", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-4000:]}
    rec["seconds"] = round(time.time() - t0, 2)
    return rec


def cell_path(arch: str, shape: str, mesh: str, kv: str = "ring",
              disagg: bool = False) -> str:
    """The JAX dry run's artifact names: a paged sweep and a disagg sweep
    each in their own namespace."""
    os.makedirs(ART_DIR, exist_ok=True)
    suffix = "" if kv == "ring" else f"__kv-{kv}"
    if disagg:
        suffix += "__disagg"
    return os.path.join(ART_DIR, f"{arch}__{shape}__{mesh}{suffix}.json")


def summary_line(rec: dict) -> str:
    """The one line a cell prints: its status, peak a rank, collectives."""
    status = rec["status"]
    extra = ""
    if status == "ok":
        peak = max(rec["memory"]["peak_estimate_bytes"],
                   rec.get("last_rank", {}).get("memory", {}).get(
                       "peak_estimate_bytes", 0)) / 2 ** 30
        extra = (f"seconds={rec['seconds']:.1f} peak/rank={peak:.2f}GiB "
                 f"coll={rec['collectives']['total'] / 2 ** 20:.1f}MiB "
                 f"flops={rec['flops']:.4g} "
                 f"launches={sum(rec['launches']['counts'].values())} "
                 f"host_ops={rec['host_ops']}")
    elif status == "error":
        extra = rec["error"][:120]
    return (f"[{status:7s}] {rec['arch']:28s} {rec['shape']:12s} "
            f"{rec['mesh']:9s} {extra}")


def _sweep_cell(job) -> dict:
    """A worker's cell of a sweep: run, write the artifact, return it."""
    path, arch, shape, mesh_kind, kw = job
    rec = run_cell(arch, shape, mesh_kind, **kw)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def _end_group():
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _worker(job) -> dict:
    try:
        return _sweep_cell(job)
    finally:
        _end_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None, choices=(None, "pod", "multipod"))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells whose artifact already exists")
    ap.add_argument("--accum", type=int, default=None,
                    help="override gradient-accumulation microsteps")
    ap.add_argument("--kv", default="ring", choices=("ring", "paged"),
                    help="KV layout for decode cells: per-slot dense rings "
                         "or the paged pool + block table")
    ap.add_argument("--disagg", action="store_true",
                    help="also count the two-pool KV-page handoff of paged "
                         "decode cells (a 'handoff' section)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells counted side by side, a process each (each "
                         "its own one-rank world)")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(REGISTRY)
    shapes = [args.shape] if args.shape else [s.name for s in SHAPES]
    meshes = [args.mesh] if args.mesh else ["pod", "multipod"]
    kw = {"accum": args.accum, "kv": args.kv, "disagg": args.disagg}
    jobs = []
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                path = cell_path(arch, shape, mesh_kind, kv=args.kv,
                                 disagg=args.disagg)
                if args.resume and os.path.exists(path):
                    with open(path) as f:
                        old = json.load(f)
                    if old.get("status") in ("ok", "skipped", "refused"):
                        continue
                jobs.append((path, arch, shape, mesh_kind, kw))
    n_bad = 0
    if args.jobs > 1:
        import concurrent.futures as cf
        import multiprocessing as mp

        # the training cells first: they take the longest
        jobs.sort(key=lambda j: SHAPES_BY_NAME[j[2]].kind != "train")
        with cf.ProcessPoolExecutor(
                args.jobs, mp_context=mp.get_context("spawn")) as pool:
            for fut in cf.as_completed([pool.submit(_worker, j)
                                        for j in jobs]):
                rec = fut.result()
                n_bad += rec["status"] == "error"
                print(summary_line(rec), flush=True)
    else:
        try:
            for job in jobs:
                rec = _sweep_cell(job)
                n_bad += rec["status"] == "error"
                print(summary_line(rec), flush=True)
        finally:
            _end_group()
    raise SystemExit(1 if n_bad else 0)


if __name__ == "__main__":
    main()
