"""Print the JAX dry run's per-device argument shapes for every cell.

Run in a process of its own (it sets 512 host devices before JAX starts):
for every (arch, shape, mesh, kv layout) cell that `repro.launch.specs`
builds, each argument leaf's shard shape on one device
(`NamedSharding.shard_shape`) and dtype, keyed by its path, as one JSON
line. No lowering and no compile. tests/test_torch_dryrun.py holds the
port's rank-0 arguments (`repro_torch.launch.specs`) to these.

    python tests/_torch_dryrun_jax_specs.py OUT.json
"""
import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import json  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402


def _key(k) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _leaves(args, shardings) -> dict:
    out = {}
    flat, _ = jax.tree_util.tree_flatten_with_path(args)
    sh = jax.tree_util.tree_leaves(
        shardings, is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))
    for (path, leaf), s in zip(flat, sh):
        out["/".join(_key(k) for k in path)] = (
            list(s.shard_shape(tuple(leaf.shape))), str(leaf.dtype))
    return out


def main(path):
    from repro.configs import REGISTRY, get_config
    from repro.launch import specs as SP
    from repro.launch.mesh import make_production_mesh
    from repro.models.config import SHAPES
    from repro.parallel.sharding import set_active_mesh

    meshes = {"pod": make_production_mesh(),
              "multipod": make_production_mesh(multi_pod=True)}
    cells = {}
    for arch in REGISTRY:
        cfg = get_config(arch)
        for shape in SHAPES:
            if not SP.cell_is_applicable(cfg, shape)[0]:
                continue
            for mname, mesh in meshes.items():
                set_active_mesh(mesh)
                for kv in ("ring", "paged"):
                    if kv == "paged" and shape.kind != "decode":
                        continue
                    _, args, in_sh, _ = SP.input_specs(cfg, shape, mesh,
                                                       kv_layout=kv)
                    cells[f"{arch}|{shape.name}|{mname}|{kv}"] = _leaves(
                        args, in_sh)
    with open(path, "w") as f:
        json.dump(cells, f)


if __name__ == "__main__":
    main(sys.argv[1])
