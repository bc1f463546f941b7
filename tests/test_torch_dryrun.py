"""PyTorch port, the dry run (`repro_torch.launch.specs`, `.cost`,
`.dryrun`) and the `pod` axis at run time, on the CPU.

* Specs against JAX: for every cell of both production meshes, ring and
  paged, the port's rank-0 arguments (`launch.specs.input_specs` on the
  meta device) equal the JAX dry run's per-device shard shapes and dtypes
  leaf by leaf (printed by tests/_torch_dryrun_jax_specs.py in a process
  of 512 host devices), apart from the named differences, each asserted
  as itself: the serving parameters' vectors (norms, biases, the SSM's
  per-head vectors) kept in fp32 (ROADMAP F11), the SSM state and conv
  tail whole over `model`, paged `long_500k` refused, and a VLM's decode
  cell without a frontend (ROADMAP F8).
* The counter: tests/test_hlo_cost.py's five programs written on
  `ops.sa_matmul`, on meta tensors, give `HLOCost`'s flops (the single
  matmul its bytes too); a qwen layer's 7 decode GEMMs at M = 4 give
  PERF.md's 0.1647 ms byte bound within 1 %.
* Dry run against a real run: reduced configs of every family (head dim
  64, which the attention kernels take) give, on meta, the calls per
  kernel that the same steps make on the CPU (`ops.counts()` plain calls;
  the SA GEMM's backward included), the prefill and decode steps' SA GEMM
  calls equal to `model.gemm_calls`. The card's program differs from the
  CPU's in two named places: prefill with a cache runs the prefill kernel
  (the CPU the blockwise path) and a ring decodes through the paged-decode
  kernel (the CPU through `decode_attention`); there the meta count is
  one launch an attention layer.
* Collectives: reduced qwen and reduced llama4 (FSDP) train steps at
  (data 2, model 2) and (pod 2, data 1, model 2) give, on meta under the
  `fake` backend as each rank, the collective counts and payloads by class
  that a real gloo world records on that rank.
* The pod axis: in a world of 4 the (2, 1, 2) mesh gives the (2, 2)
  mesh's bits: qwen's train step, reduced llama4's FSDP step, granite's
  load-balance step, and the engine's paged serve's stream digest.
* The CLI writes a cell's JSON and prints its line.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config as j_reduced  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSynthetic  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import REGISTRY, get_config, reduced_config  # noqa: E402
from repro_torch.core import precision as TP  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.launch.cost import CostCounter  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.config import SHAPES_BY_NAME, ShapeCfg  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402
from repro_torch.parallel.mesh import (MeshSpec, make_dry_mesh,  # noqa: E402
                                       make_production_mesh)

import _torch_dryrun_ranks as R  # noqa: E402
from test_torch_moe_parallel import _join, _spawn  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LLAMA4 = "llama4-maverick-400b-a17b"


@pytest.fixture(scope="module")
def dry():
    """make_dry_mesh in this process; the `fake` group ended after the
    module's tests."""
    import torch.distributed as dist

    yield make_dry_mesh
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# specs against the JAX dry run
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_specs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("specs") / "jax_specs.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests",
                                      "_torch_dryrun_jax_specs.py"), out],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(out) as f:
        return json.load(f)


def _port_leaves(args) -> dict:
    out = {}

    def leaf(path, t):
        out["/".join(map(str, path))] = (list(t.shape),
                                         str(t.dtype).replace("torch.", ""))
    S.tree_map_with_path(leaf, args)
    return out


def _vector(path: str, shape) -> bool:
    """A parameter that is a vector a superblock (a norm, a bias, an SSM
    per-head vector), not a matrix."""
    return len(shape) - ("/layers/" in path) <= 1


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_rank0_arguments_are_the_jax_shards(jax_specs, dry, arch):
    cfg = get_config(arch)
    cells = {k: v for k, v in jax_specs.items() if k.startswith(arch + "|")}
    assert cells
    named = {"f32_vectors": 0, "ssm_whole": 0, "refused": 0,
             "vlm_frontend": 0}
    for key, jax_leaves in cells.items():
        _, shape_name, mesh_kind, kv = key.split("|")
        shape = SHAPES_BY_NAME[shape_name]
        spec = make_production_mesh(multi_pod=mesh_kind == "multipod")
        tp, dp = dict(zip(spec.axis_names, spec.shape))["model"], \
            S.batch_count(spec)
        mesh = dry(spec, 0)
        try:
            _, args = SP.input_specs(cfg, shape, mesh, kv_layout=kv)
        except ValueError as e:
            # paged at a batch the data axes do not divide
            assert (kv == "paged" and shape.global_batch % dp
                    and cfg.family != "ssm"), (key, e)
            named["refused"] += 1
            continue
        port = _port_leaves(args)
        serving = shape.kind != "train"
        for path in sorted(set(jax_leaves) | set(port)):
            j, p = jax_leaves.get(path), port.get(path)
            if j is not None and p is not None and j == list(p):
                continue
            if (p is None and cfg.family == "vlm" and shape.kind == "decode"
                    and path == "4"):
                named["vlm_frontend"] += 1
                continue
            assert j is not None and p is not None, (key, path, j, p)
            if (serving and path.startswith("0/") and j[0] == p[0]
                    and _vector(path, j[0])
                    and (j[1], p[1]) == ("bfloat16", "float32")):
                named["f32_vectors"] += 1
                continue
            if path.startswith("2/") and "/ssm/" in path:
                # the state (.., H, P, N) cut on P, the tail (.., 3, C) on C
                cut = 3
                want = list(j[0])
                want[cut] *= tp
                assert (p[0], p[1]) == (want, j[1]), (key, path, j, p)
                named["ssm_whole"] += 1
                continue
            raise AssertionError(f"{key} {path}: JAX {j}, port {p}")
    assert named["f32_vectors"] > 0
    assert (named["ssm_whole"] > 0) == M.has_ssm(cfg)
    assert (named["vlm_frontend"] > 0) == (cfg.family == "vlm")
    long_paged = (cfg.sub_quadratic and cfg.family != "ssm")
    assert named["refused"] == (2 if long_paged else 0)


def test_pool_pages_agree_with_jax_where_the_batch_splits():
    from repro.launch import specs as JSP

    for multi in (False, True):
        spec = make_production_mesh(multi_pod=multi)
        jmesh = type("Mesh", (), {
            "axis_names": spec.axis_names,
            "devices": np.empty(spec.shape, dtype=np.int8)})()
        dp = S.batch_count(spec)
        for batch, T in ((128, 32768), (32, 4096), (dp, 64)):
            assert SP.pool_pages_for(spec, batch, T, 64) == \
                JSP.pool_pages_for(jmesh, batch, T, 64)
        # one trash page a shard against one for the pool
        assert SP.pool_pages_for(spec, dp, 8, 64) == 2 * dp
        assert JSP.pool_pages_for(jmesh, dp, 8, 64) == dp


def test_accum_and_applicability_are_the_jax_rules():
    from repro.configs import get_config as j_get
    from repro.launch import specs as JSP

    for multi in (False, True):
        spec = make_production_mesh(multi_pod=multi)
        jmesh = type("Mesh", (), {
            "axis_names": spec.axis_names,
            "devices": np.empty(spec.shape, dtype=np.int8)})()
        for arch in REGISTRY:
            for shape in SHAPES_BY_NAME.values():
                assert SP.accum_steps_for(get_config(arch), shape, spec) == \
                    JSP.accum_steps_for(j_get(arch), shape, jmesh)
                assert SP.cell_is_applicable(get_config(arch), shape) == \
                    JSP.cell_is_applicable(j_get(arch), shape)


# ---------------------------------------------------------------------------
# the counter against hand-counted programs (tests/test_hlo_cost.py)
# ---------------------------------------------------------------------------

def _meta(*shape, grad=False):
    return torch.empty(shape, dtype=torch.float32, device="meta",
                       requires_grad=grad)


def _count(fn, *args):
    with TP.use_policy(TP.PrecisionPolicy(backend="cuda")), \
            CostCounter() as c:
        out = fn(*args)
    return c.summary(args, out)


def _hlo(fn, *args):
    from repro.launch.hlo_cost import HLOCost
    return HLOCost(jax.jit(fn).lower(*args).compile().as_text()).summary()


def test_single_matmul_exact():
    s = _count(ops.sa_matmul, _meta(128, 256), _meta(256, 64))
    assert s["flops"] == 2 * 128 * 256 * 64
    assert s["kernel_bytes"] == (128 * 256 + 256 * 64 + 128 * 64) * 4
    h = _hlo(lambda a, b: a @ b, jnp.zeros((128, 256)), jnp.zeros((256, 64)))
    assert (s["flops"], s["kernel_bytes"]) == (h["flops"], h["bytes"])
    assert s["launches"]["counts"]["sa_matmul"] == 1


def test_scan_multiplies_by_trip_count():
    def scanned(a, bs):
        for i in range(bs.shape[0]):
            a = ops.sa_matmul(a, bs[i])
        return a
    s = _count(scanned, _meta(128, 256), _meta(7, 256, 256))
    assert s["flops"] == 7 * 2 * 128 * 256 * 256
    assert s["launches"]["counts"]["sa_matmul"] == 7


def test_nested_scans_multiply():
    def outer(a, bss):
        for i in range(bss.shape[0]):
            for j in range(bss.shape[1]):
                a = ops.sa_matmul(a, bss[i, j])
        return a
    s = _count(outer, _meta(32, 64), _meta(3, 5, 64, 64))
    assert s["flops"] == 3 * 5 * 2 * 32 * 64 * 64


def test_grad_counts_backward_dots():
    def mlp(w1, w2, x):
        return torch.sum(ops.sa_matmul(torch.tanh(ops.sa_matmul(x, w1)), w2))

    def both(w1, w2, x):
        mlp(w1, w2, x).backward()
        return w1.grad, w2.grad

    w1, w2, x = _meta(64, 128, grad=True), _meta(128, 32, grad=True), \
        _meta(16, 64)
    fwd = _count(mlp, w1, w2, x)["flops"]
    s = _count(both, w1, w2, x)
    assert s["flops"] >= fwd + 2 * 128 * 16 * 32 + 2 * 64 * 16 * 128
    h = _hlo(jax.grad(lambda w1, w2, x: jnp.sum(jnp.tanh(x @ w1) @ w2),
                      argnums=(0, 1)),
             jnp.zeros((64, 128)), jnp.zeros((128, 32)), jnp.zeros((16, 64)))
    # HLOCost's, and two GEMMs XLA does not run: the first layer's dA
    # (dus·W1ᵀ; the SA GEMM's backward runs both of its GEMMs whether or
    # not x takes a gradient) and dW2 = hᵀ·1 (XLA reduces the sum's
    # cotangent of ones instead of multiplying by it)
    assert s["flops"] == h["flops"] + 2 * 16 * 64 * 128 + 2 * 16 * 128 * 32
    assert s["launches"]["counts"]["sa_matmul_bwd"] == 4


def test_collectives_ignored_in_bytes_but_tracked():
    s = _count(lambda a: ops.sa_matmul(a, a), _meta(8, 8))
    assert s["collectives"]["total"] == 0
    assert s["collectives"]["counts"] == {c: 0 for c in (
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all")}


def test_a_qwen_layers_decode_gemms_give_the_byte_bound():
    """PERF.md's bound of a layer's 7 decode GEMMs at M = 4 (0.1647 ms:
    bf16 A and W read once, the fp32 output written once, q/k/v biases)
    from the counter's kernel bytes over the H100's 3.35 TB/s."""
    cfg = get_config("qwen2.5-14b")
    d, hd = cfg.d_model, cfg.hd
    shapes = [(d, cfg.num_heads * hd, True), (d, cfg.num_kv_heads * hd, True),
              (d, cfg.num_kv_heads * hd, True), (cfg.num_heads * hd, d, False),
              (d, cfg.d_ff, False), (d, cfg.d_ff, False),
              (cfg.d_ff, d, False)]

    def layer(a):
        for k, n, bias in shapes:
            ops.sa_matmul(a[:, :k], torch.empty(
                (k, n), dtype=torch.bfloat16, device="meta"),
                bias=_meta(n) if bias else None)
    a = torch.empty((4, cfg.d_ff), dtype=torch.bfloat16, device="meta")
    s = _count(layer, a)
    assert s["launches"]["tiles"]["decode"] == 7
    ms = s["kernel_bytes"] / 3.35e12 * 1e3
    assert abs(ms / 0.1647 - 1) < 0.01, ms


# ---------------------------------------------------------------------------
# the dry run against a real run, every family
# ---------------------------------------------------------------------------

FAMILIES = {"dense": "qwen2.5-14b", "local": "gemma2-9b",
            "moe": "granite-moe-3b-a800m", "ssm": "mamba2-2.7b",
            "hybrid": "hymba-1.5b", "audio": "whisper-tiny",
            "vlm": "pixtral-12b"}
CASES = [("prefill", "ring"), ("decode", "ring"), ("decode", "paged"),
         ("train", "ring")]
ONE = MeshSpec(("data", "model"), (1, 1))


def _hd64(arch):
    return dataclasses.replace(reduced_config(arch), head_dim=64)


def _real(t):
    """A CPU tensor of `t`'s shape and type, zeros (a block table of
    zeros maps every page to the trash page)."""
    if not isinstance(t, torch.Tensor) or t.device.type != "meta":
        return t
    return torch.zeros(t.shape, dtype=t.dtype).requires_grad_(
        t.requires_grad)


def _attention_layers(cfg) -> int:
    return 0 if cfg.family == "ssm" else cfg.num_layers


@pytest.mark.parametrize("kind,kv", CASES)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_meta_calls_per_kernel_equal_a_real_run(dry, family, kind, kv):
    cfg = _hd64(FAMILIES[family])
    T = 16
    shape = ShapeCfg(kind, T, 2, kind)
    mesh = dry(ONE, 0)
    step, args = SP.input_specs(cfg, shape, mesh, kv_layout=kv, page_size=8,
                                accum=1)
    meta = D.count_step(step, args, mesh)["launches"]["counts"]
    step, args = SP.input_specs(cfg, shape, mesh, kv_layout=kv, page_size=8,
                                accum=1)
    real_args = S.tree_map_with_path(lambda _, t: _real(t), args)
    ops.reset_counts()
    with S.using_mesh(mesh), TP.use_policy(TP.PrecisionPolicy(
            backend="cuda")):
        step(*real_args)
    real = {k: v["plain_calls"] for k, v in ops.counts().items()}
    assert meta["sa_matmul"] == real["sa_matmul"] > 0
    assert meta["sa_matmul_bwd"] == real["sa_matmul_bwd"]
    assert (meta["sa_matmul_bwd"] > 0) == (kind == "train")
    attn = _attention_layers(cfg)
    if kind == "prefill":
        # the card's prefill kernel where the CPU runs the blockwise path
        assert real["prefill_attention"] == 0
        assert meta["prefill_attention"] == attn
    if kind == "decode" and kv == "paged":
        # the pools' layers through the kernel on both; a local window's
        # ring (window < T) through it on the card only
        rings = sum(cfg.layer_kind(j)["attn"] == "local" for j in range(
            cfg.num_layers)) if attn and cfg.window and cfg.window < T else 0
        assert real["paged_decode"] == attn - rings
        assert meta["paged_decode"] == attn
    if kind == "decode" and kv == "ring":
        # every ring through the paged-decode kernel where the CPU runs
        # decode_attention
        assert real["paged_decode"] == 0
        assert meta["paged_decode"] == attn
    if kind != "train":
        tokens = T if kind == "prefill" else 1
        assert meta["sa_matmul"] == M.gemm_calls(cfg, tokens)


# ---------------------------------------------------------------------------
# the pod axis and the collectives: a gloo world of 4 and the meta counts
# ---------------------------------------------------------------------------

POD_ARCHS = {"qwen": ("qwen2.5-14b", False), "llama4": (LLAMA4, True),
             "granite": ("granite-moe-3b-a800m", False)}
STREAM = {"n": 4, "rate": 0.0, "prompt_lens": [6, 10], "max_new": 4,
          "seed": 1}


def _pod_job():
    job = {"cfgs": {}, "params": {}, "batch": {}, "stream": STREAM,
           "sched": dict(peak_lr=1e-3, warmup_steps=2, total_steps=10),
           "seq": 16, "batch_rows": 4}
    for name, (arch, fsdp) in POD_ARCHS.items():
        job["cfgs"][name] = dataclasses.replace(reduced_config(arch),
                                                fsdp=fsdp)
        jcfg = j_reduced(arch)
        job["params"][name] = jax.tree.map(
            np.asarray, JM.init_params(jax.random.key(3), jcfg))
        job["batch"][name] = JSynthetic(jcfg.vocab_size, 16, 4,
                                        seed=1).batch_at(0)
    return job


@pytest.fixture(scope="module")
def pod_worlds(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("dryrun_pod"))
    job = _pod_job()
    ctx = [_spawn(R.pod_world, os.path.join(base, "pod"), 4, job),
           _spawn(R.meta_world, os.path.join(base, "meta"), 1,
                  {k: job[k] for k in ("cfgs", "seq", "batch_rows")})]
    for c in ctx:
        _join(c)
    ranks = [torch.load(os.path.join(base, "pod", f"rank{r}.pt"))
             for r in range(4)]
    meta = torch.load(os.path.join(base, "meta", "meta.pt"))
    return ranks, meta


def _same_bits(a, b) -> bool:
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same_bits, a, b))
    return torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(POD_ARCHS))
def test_pod_axis_train_step_is_the_data_axis_bit_for_bit(pod_worlds, name):
    ranks, _ = pod_worlds
    for got in ranks:
        a, b = got[("2x2", name)], got[("2x1x2", name)]
        for k in ("loss", "grads", "after", "grad_norm"):
            assert _same_bits(a[k], b[k]), (name, k)


def test_pod_axis_paged_serve_gives_the_same_digest(pod_worlds):
    ranks, _ = pod_worlds
    digests = {got[(key, "serve")] for got in ranks for key in R.MESHES}
    assert len(digests) == 1


@pytest.mark.parametrize("mesh", sorted(R.MESHES))
@pytest.mark.parametrize("name", ["qwen", "llama4"])
def test_fake_backend_collectives_equal_a_gloo_worlds(pod_worlds, name,
                                                      mesh):
    ranks, meta = pod_worlds
    for r, got in enumerate(ranks):
        real = got[(mesh, name)]["collectives"]
        assert real["total"] > 0
        assert meta[(mesh, name, r)] == real, (name, mesh, r)


def test_fsdp_gathers_run_over_the_pod_and_data_axes(pod_worlds):
    _, meta = pod_worlds
    for mesh in R.MESHES:
        c = meta[(mesh, "llama4", 0)]
        assert c["counts"]["all-gather"] > 0
        assert c["counts"]["reduce-scatter"] > 0


def test_batch_helpers_on_a_data_mesh_are_the_data_axis(dry):
    mesh = dry(MeshSpec(("data", "model"), (4, 2)), 5)
    assert S.batch_count(mesh) == 4 and S.batch_index(mesh) == 2
    assert S.batch_group(mesh) is mesh.get_group("data")
    mesh = dry(MeshSpec(("pod", "data", "model"), (2, 4, 2)), 13)
    assert S.batch_count(mesh) == 8
    assert S.batch_index(mesh) == 1 * 4 + 2          # pod-major
    import torch.distributed as dist
    assert dist.get_rank(S.batch_group(mesh)) == S.batch_index(mesh)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_writes_a_cells_record(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               REPRO_DRYRUN_DIR=str(tmp_path))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-tiny", "--shape", "decode_32k", "--mesh", "pod", "--kv",
         "paged", "--disagg"], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    path = tmp_path / "whisper-tiny__decode_32k__pod__kv-paged__disagg.json"
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    for key in ("memory", "flops", "bytes_accessed", "collectives",
                "kernel_bytes", "eager_bytes", "launches", "host_ops",
                "seconds", "handoff"):
        assert key in rec, key
    assert rec["launches"]["counts"]["sa_matmul"] == M.gemm_calls(
        get_config("whisper-tiny"))
    assert rec["memory"]["peak_estimate_bytes"] > rec["memory"][
        "argument_bytes"] > 0
    assert "[ok     ] whisper-tiny" in res.stdout
    assert "peak/rank=" in res.stdout and "coll=" in res.stdout


def test_cli_skips_and_refuses_by_the_rules(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               REPRO_DRYRUN_DIR=str(tmp_path))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gemma2-9b", "--shape", "long_500k", "--mesh", "pod", "--kv",
         "paged"], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    rec = json.loads((tmp_path / "gemma2-9b__long_500k__pod__kv-paged.json"
                      ).read_text())
    assert rec["status"] == "refused" and "--kv ring" in rec["reason"]
    rec = D.run_cell("qwen2.5-14b", "long_500k", "pod")
    assert rec["status"] == "skipped"
