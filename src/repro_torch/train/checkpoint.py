"""Checkpointing: atomic, content-hashed, with a `latest` pointer and an
async writer, as the JAX package's `repro/train/checkpoint.py`.

Layout (one directory per step):

    <dir>/step_000000123/
        manifest.json       leaf order and paths, shapes, dtypes, sha256
                            per leaf
        arr_00000.npy ...   one file per leaf
    <dir>/latest            text file → step directory name (atomic rename)

  * **atomicity** — written to `<name>.tmp`, fsync'd, then renamed;
    `latest` is updated last, so a preempted writer never corrupts the
    previous checkpoint.
  * **async** — `AsyncSaver.save_async` copies the tree to host memory and
    writes on a background thread; the train loop waits only for the copy.
  * **integrity** — sha256 per leaf, verified on restore.

Leaves are numpy `.npy` files; bf16 tensors are stored as their raw 16-bit
patterns (numpy has no bf16) with the dtype in the manifest. `restore`
puts each leaf on the device of the matching leaf of `target_tree`.

Under a mesh (`mesh=` and the tree's `specs=`, `parallel.sharding`) a
checkpoint still holds full leaves: `save` gathers each leaf across the
ranks (every rank takes part; rank 0 writes), and `restore` cuts the
current mesh's shard of each full leaf (the JAX package's reshard on
load), so a checkpoint saved at one mesh restores at another, or in one
process.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.models.model import tree_leaves

_RAW = {torch.bfloat16: np.uint16}   # torch dtypes numpy cannot hold


def _unflatten(tree, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if hasattr(t, "_fields"):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(tree)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype in _RAW:
        return t.view(torch.int16).numpy().view(_RAW[t.dtype])
    return t.numpy()


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    dtype = getattr(torch, dtype_name.split(".")[-1])
    if dtype in _RAW:
        return torch.from_numpy(arr.view(np.int16).copy()).view(dtype)
    return torch.from_numpy(arr.copy())


def _paths(tree) -> list:
    """Each leaf's path ("layers/0/attn/wq"), in `tree_leaves`' order."""
    from repro_torch.parallel.sharding import tree_map_with_path

    out = []
    tree_map_with_path(lambda p, _: out.append("/".join(map(str, p))), tree)
    return out


def _writer(mesh) -> bool:
    import torch.distributed as dist

    return mesh is None or dist.get_rank() == 0


def _snapshot(tree, mesh=None, specs=None):
    """(numpy array, torch dtype name) of every leaf, on the host; under a
    mesh each leaf gathered whole first (on rank 0; the other ranks take
    part in the gathers and keep nothing)."""
    if mesh is None:
        return [(_to_numpy(x), str(x.dtype)) for x in tree_leaves(tree)]
    from repro_torch.parallel import sharding as S

    host = []
    for x, sp in zip(tree_leaves(tree), S.spec_leaves(specs, tree)):
        full = S.gather_leaf(x, sp, mesh)
        if _writer(mesh):
            host.append((_to_numpy(full), str(x.dtype)))
        del full
    return host


def save(path: str, step: int, tree, extra: dict | None = None, *,
         mesh=None, specs=None) -> str:
    """Synchronous atomic save of a tree of tensors (under a mesh, full
    leaves, written by rank 0). Returns the checkpoint directory."""
    host = _snapshot(tree, mesh, specs)
    final = os.path.join(path, f"step_{step:09d}")
    if not _writer(mesh):
        return final
    return _write(path, step, host, extra, _paths(tree))


def _write(path: str, step: int, host, extra, paths) -> str:
    os.makedirs(path, exist_ok=True)
    name = f"step_{step:09d}"
    tmp = os.path.join(path, name + ".tmp")
    final = os.path.join(path, name)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for i, ((arr, dtype), leaf_path) in enumerate(zip(host, paths)):
        fn = f"arr_{i:05d}.npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"].append({
            "file": fn, "path": leaf_path, "shape": list(arr.shape),
            "dtype": dtype,
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest()})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    # pointer file last — readers never see a partial checkpoint
    ptr_tmp = os.path.join(path, "latest.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(name)
        f.flush()
        os.fsync(f.fileno())
    os.replace(ptr_tmp, os.path.join(path, "latest"))
    return final


class AsyncSaver:
    """Snapshot-now, write-later checkpointing."""

    def __init__(self):
        self._thread: threading.Thread | None = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save_async(self, path: str, step: int, tree, extra=None, *,
                   mesh=None, specs=None):
        self.wait()
        host = _snapshot(tree, mesh, specs)
        if not _writer(mesh):
            return
        self._thread = threading.Thread(
            target=_write, args=(path, step, host, extra, _paths(tree)),
            daemon=False)
        self._thread.start()


def latest_step(path: str) -> int | None:
    ptr = os.path.join(path, "latest")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        return int(f.read().strip().split("_")[-1])


def restore(path: str, target_tree, step: int | None = None,
            verify: bool = True, *, mesh=None, specs=None):
    """Load into the structure of `target_tree`: each leaf by its path
    (its dicts may order their keys otherwise than the saved tree's),
    taking the device of the target's leaf (and its `requires_grad`);
    under a mesh each full leaf is cut to this rank's shard by `specs`
    first. Returns (tree, extra, step)."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    cdir = os.path.join(path, f"step_{step:09d}")
    with open(os.path.join(cdir, "manifest.json")) as f:
        manifest = json.load(f)
    targets = tree_leaves(target_tree)
    if mesh is not None:
        from repro_torch.parallel import sharding as S

        spec_list = S.spec_leaves(specs, target_tree)
        coords = S.mesh_coords(mesh)
    if len(targets) != len(manifest["leaves"]):
        raise ValueError(f"tree structure changed: {len(targets)} leaves, "
                         f"checkpoint has {len(manifest['leaves'])}")
    saved = {m.get("path"): m for m in manifest["leaves"]}
    paths = _paths(target_tree)
    metas = ([saved[p] for p in paths] if set(paths) == set(saved)
             else manifest["leaves"])
    out = []
    for meta, ref in zip(metas, targets):
        arr = np.load(os.path.join(cdir, meta["file"]))
        if verify:
            h = hashlib.sha256(arr.tobytes()).hexdigest()
            if h != meta["sha256"]:
                raise IOError(f"checkpoint corruption in {meta['file']}")
        t = _from_numpy(arr, meta["dtype"])
        if mesh is not None:
            t = S.shard_leaf(t, spec_list[len(out)], mesh, coords)
        out.append(t.to(ref.device).requires_grad_(ref.requires_grad))
    return _unflatten(target_tree, out), manifest["extra"], step
