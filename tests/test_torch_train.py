"""PyTorch port, training path: the SA GEMM's gradient (`SAMatmulFn`),
the flash attention backward, a whole train step, remat, AdamW and the
training infrastructure, against the JAX package on the CPU on the same
numpy inputs.

Tolerances, each with its reason:

* SA GEMM backward: dA and dW per element within `error_bound` of the
  backward GEMMs (2·K·2⁻²⁴·Σ|du·s||w|: two fp32 sums of the same products
  in different orders); dbias and dscale within the drift the raw
  accumulator's own bound allows through the activation (|act''| ≤ 1)
  plus their fp32 sums' reassociation.
* Attention backward under an fp32 policy: 2⁻¹⁶ of each gradient's
  largest magnitude (fp32 sums in other orders over ≤ 32 keys). Under the
  bf16 policy the probabilities and dS are rounded to bf16 before their
  einsums, so a last-bit difference upstream flips a bf16 rounding
  (2⁻⁸ relative of one term): 2⁻⁶ of the largest magnitude.
* Whole train step: loss within 2⁻¹⁰ relative; each gradient leaf within
  2⁻⁵ of the leaf's norm (‖Δ‖/‖g‖). The residual stream and every
  cotangent reaching a master are bf16 in both frameworks, so a last-bit
  fp32 difference (reassociation, rmsnorm/rope/softmax rounding) flips a
  bf16 rounding (2⁻⁸) that the backward carries through both layers; the
  same 2⁻⁵ holds the forward logits in test_torch_model.py. A backward
  that drops the activation jacobian or dbias lands outside it.
* Remat: bit-identical (the recompute runs the same ops on the same
  inputs in the same order).
* AdamW on identical gradients: rel 1e-6 (the same fp32 operations; the
  two frameworks' division and pow may round the last bit differently).
  Parameters after a whole step: atol 2·lr, because the first Adam step
  is ≈ lr·sign(g) and a near-zero gradient may take either sign.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config  # noqa: E402
from repro.core import precision as JP  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSynthetic  # noqa: E402
from repro.kernels.sa_matmul import sa_matmul_pallas  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train.step import make_train_step as j_make_train_step  # noqa
from repro_torch.core import precision as TP  # noqa: E402
from repro_torch.data.pipeline import (MemmapTokens, Prefetcher,  # noqa: E402
                                       SyntheticLM)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import sa_matmul as MM  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        state_from_numpy)
from repro_torch.train import checkpoint as CKPT  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train.fault import StragglerWatchdog  # noqa: E402
from repro_torch.train.step import make_grad_fn, make_train_step  # noqa
from repro_torch.train.train_state import TrainState  # noqa: E402

torch.set_num_threads(2)
REL_GRAD = 2.0 ** -5
REL_LOSS = 2.0 ** -10


def _bf16_grid(x):
    """fp32 values on the bf16 grid (what cast_in hands the GEMM)."""
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(
        jnp.float32))


# ---------------------------------------------------------------------------
# SA GEMM: SAMatmulFn against jax.grad of the Pallas kernel (interpret)
# ---------------------------------------------------------------------------

def _gemm_grads(act, m=24, k=160, n=40):
    rng = np.random.default_rng(11)
    a = _bf16_grid(rng.standard_normal((m, k)))
    w = _bf16_grid(rng.standard_normal((k, n)) / np.sqrt(k))
    b = (rng.standard_normal(n) * 0.3).astype(np.float32)
    dy = rng.standard_normal((m, n)).astype(np.float32)
    s = np.float32(0.75)

    def jloss(a_, w_, b_, s_):
        y = sa_matmul_pallas(a_, w_, b_, s_, act=act, interpret=True)
        return jnp.sum(y * dy)

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (a, w, b, s)))
    ta, tw, tb = (torch.from_numpy(x).requires_grad_(True) for x in (a, w, b))
    ts = torch.tensor(s, requires_grad=True)
    y = ops.sa_matmul(ta, tw, bias=tb, scale=ts, act=act)
    (y * torch.from_numpy(dy)).sum().backward()
    tg = (ta.grad, tw.grad, tb.grad, ts.grad)
    return (a, w, b, s, dy), [np.asarray(x) for x in jg], \
        [x.numpy() for x in tg]


def _gemm_bounds(act, a, w, b, s, dy):
    """Per-element bounds on |port − JAX| for (dA, dW, dbias, dscale)."""
    ta, tw, tdy = map(torch.from_numpy, (a, w, dy))
    raw = ta @ tw
    u = raw * float(s) + torch.from_numpy(b)
    du = torch.autograd.functional.vjp(lambda t: MM.apply_act(t, act), u,
                                       tdy)[1]
    dus = du * float(s)
    raw_b = MM.error_bound(ta, tw)
    d_du = float(s) * raw_b * tdy.abs()      # |act''| <= 1
    m, n = dy.shape
    b_da = MM.error_bound(dus, tw.t()) + 1.13 * float(s) * (
        d_du.abs() @ tw.t().abs())
    b_dw = MM.error_bound(ta.t(), dus) + 1.13 * float(s) * (
        ta.t().abs() @ d_du.abs())
    b_db = d_du.sum(0) + 2 * m * 2.0 ** -24 * du.abs().sum(0) + 1e-7
    b_ds = float((d_du * raw.abs() + du.abs() * raw_b).sum()
                 + 2 * m * n * 2.0 ** -24 * (du * raw).abs().sum()) + 1e-6
    return b_da.numpy(), b_dw.numpy(), b_db.numpy(), b_ds


@pytest.mark.parametrize("act", ["none", "silu", "gelu"])
def test_sa_matmul_backward_matches_jax_pallas(act):
    """dA, dW, dbias and dscale of the port's Function (plain version on
    the CPU, the kernel's arithmetic) against jax.grad of the Pallas
    kernel in interpret mode, with a bias and a real scale."""
    ops.reset_counts()
    (a, w, b, s, dy), jg, tg = _gemm_grads(act)
    c = ops.counts()
    assert c["sa_matmul"]["plain_calls"] == 1, c
    assert c["sa_matmul_bwd"] == {"launches": 0, "plain_calls": 2}, c
    bounds = _gemm_bounds(act, a, w, b, s, dy)
    for name, j, t, bnd in zip(("dA", "dW", "dbias"), jg, tg, bounds):
        assert t.shape == j.shape, name
        assert (np.abs(t - j) <= bnd).all(), (name, np.abs(t - j).max())
    assert abs(float(tg[3]) - float(jg[3])) <= bounds[3]


def test_sa_matmul_backward_bound_rejects_dropped_jacobian(monkeypatch):
    """The same bounds reject a backward that drops the activation's
    jacobian (du = dy) and one that drops dbias."""
    (a, w, b, s, dy), jg, _ = _gemm_grads("silu")
    bounds = _gemm_bounds("silu", a, w, b, s, dy)
    backward = MM.SAMatmulFn.backward

    class NoJacobian(MM.SAMatmulFn):
        @staticmethod
        def backward(ctx, dy):
            ctx.act = "none"
            return backward(ctx, dy)

    class NoBias(MM.SAMatmulFn):
        @staticmethod
        def backward(ctx, dy):
            da, dw, db, ds, *rest = backward(ctx, dy)
            return (da, dw, torch.zeros_like(db), ds, *rest)

    monkeypatch.setattr(MM, "SAMatmulFn", NoJacobian)
    _, _, tg = _gemm_grads("silu")
    assert (np.abs(tg[0] - jg[0]) > bounds[0]).any()
    monkeypatch.setattr(MM, "SAMatmulFn", NoBias)
    _, _, tg = _gemm_grads("silu")
    assert (np.abs(tg[2] - jg[2]) > bounds[2]).any()


def test_cast_in_gradient_rounds_to_bf16_as_jax():
    """The transpose of cast_in's bf16 cast rounds every cotangent to bf16
    before it reaches the fp32 master, in JAX (fp32 containers on the CPU)
    and in the port (`.to()`'s backward) alike."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal(257).astype(np.float32)
    g = rng.standard_normal(257).astype(np.float32)
    jpol, tpol = JP.PrecisionPolicy(), TP.PrecisionPolicy()
    _, vjp = jax.vjp(jpol.cast_in, jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    tpol.cast_in(tx).backward(torch.from_numpy(g))
    rounded = torch.from_numpy(g).to(torch.bfloat16).float().numpy()
    assert not np.array_equal(rounded, g)
    np.testing.assert_array_equal(np.asarray(jg), rounded)
    np.testing.assert_array_equal(tx.grad.numpy(), rounded)


def test_emulate_has_no_gradient():
    a = torch.ones((2, 8), requires_grad=True)
    w = torch.ones((8, 3))
    pol = TP.PrecisionPolicy(backend="emulate")
    with pytest.raises(ValueError, match="no gradient"):
        TP.sa_dot(a, w, pol)
    with torch.no_grad():
        assert TP.sa_dot(a, w, pol).shape == (2, 3)


# ---------------------------------------------------------------------------
# attention: blockwise_attention's backward against the JAX `_flash` VJP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["fp32", "bf16"])
@pytest.mark.parametrize("kw", [{}, {"window": 6}, {"window": 5, "cap": 3.0}])
def test_blockwise_attention_grads_match_jax(fmt, kw):
    rng = np.random.default_rng(5)
    B, T, H, KVH, hd = 2, 16, 4, 2, 16
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, KVH, hd)).astype(np.float32)
    do = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    blocks = dict(block_q=8, block_kv=4)

    def jloss(q_, k_, v_):
        o = JL.blockwise_attention(q_, k_, v_, causal=True, **kw, **blocks)
        return jnp.sum(o * do)

    with JP.use_policy(JP.PrecisionPolicy(input_format=fmt)):
        jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    with TP.use_policy(TP.PrecisionPolicy(input_format=fmt)):
        o = TL.blockwise_attention(tq, tk, tv, causal=True, **kw, **blocks)
    # the backward runs under the policy captured at the forward
    (o * torch.from_numpy(do)).sum().backward()
    rel = 2.0 ** -16 if fmt == "fp32" else 2.0 ** -6
    for name, j, t in zip("qkv", jg, (tq.grad, tk.grad, tv.grad)):
        j, t = np.asarray(j), t.numpy()
        assert np.abs(t - j).max() <= rel * np.abs(j).max(), name


# ---------------------------------------------------------------------------
# the whole train step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    cfg = reduced_config("qwen2.5-14b", layers_per_period=2)
    jp = JM.init_params(jax.random.key(3), cfg)
    # nonzero QKV biases exercise the fused epilogue's bias path
    jp["layers"] = tuple(
        {**lay, "attn": {**lay["attn"], **{
            b: jax.random.normal(jax.random.key(i), lay["attn"][b].shape)
            * 0.1 for i, b in enumerate(("bq", "bk", "bv"))}}}
        for lay in jp["layers"])
    np_params = jax.tree.map(np.asarray, jp)
    batch = JSynthetic(cfg.vocab_size, 16, 4, seed=1).batch_at(0)
    return cfg, jp, np_params, batch


def _masters(np_params):
    params = params_from_numpy(np_params, "cpu", dtype=torch.float32)
    for p in TM.tree_leaves(params):
        p.requires_grad_(True)
    return params


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: x for k, v in tree.items()
                for p, x in _paths(v, prefix + (k,)).items()}
    if isinstance(tree, (tuple, list)):
        return {p: x for i, v in enumerate(tree)
                for p, x in _paths(v, prefix + (i,)).items()}
    x = tree.detach().numpy() if isinstance(tree, torch.Tensor) else tree
    return {prefix: np.asarray(x)}


_JAX_GRADS: dict = {}


def _jax_grads(cfg, jp, batch, accum, backend):
    """The JAX step's gradient: value_and_grad of lm_loss per strided
    microbatch, summed in fp32 and divided by A (a fresh jit per backend:
    the policy is read at trace time). Cached per (accum, backend): the
    setup fixture's inputs never change."""
    key = (accum, backend)
    if key in _JAX_GRADS:
        return _JAX_GRADS[key]
    toks, labs = (jnp.asarray(batch[k]) for k in ("tokens", "labels"))
    mb = toks.shape[0] // accum
    with JP.use_policy(JP.PrecisionPolicy(backend=backend)):
        vg = jax.jit(jax.value_and_grad(
            lambda p, t, l: JM.lm_loss(p, cfg, t, l), has_aux=True))
        g_acc, l_acc = None, 0.0
        for i in range(accum):
            (loss, _), g = vg(jp, toks.reshape(mb, accum, -1)[:, i],
                              labs.reshape(mb, accum, -1)[:, i])
            g_acc = g if g_acc is None else jax.tree.map(jnp.add, g_acc, g)
            l_acc = l_acc + loss
    g = jax.tree.map(lambda x: x / accum, g_acc) if accum > 1 else g_acc
    _JAX_GRADS[key] = (float(l_acc / accum),
                       _paths(jax.tree.map(np.asarray, g)))
    return _JAX_GRADS[key]


def _port_grads(cfg, np_params, batch, accum, backend):
    params = _masters(np_params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with TP.use_policy(TP.PrecisionPolicy(backend=backend)):
        loss, nll, grads = make_grad_fn(cfg, accum)(params, tb)
    assert float(loss) == float(nll)
    return float(loss), _paths(grads)


def _rel_errors(jg, tg):
    assert set(jg) == set(tg)
    return {p: float(np.linalg.norm(tg[p] - jg[p])
                     / (np.linalg.norm(jg[p]) + 1e-30)) for p in jg}


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("port_backend,jax_backend",
                         [("torch", "xla"), ("cuda", "pallas")])
def test_train_step_grads_match_jax(setup, accum, port_backend, jax_backend):
    """Loss and every gradient leaf of one step (remat on, as the config
    has it) against jax.value_and_grad(lm_loss); the port's `cuda` backend
    runs SAMatmulFn's plain version on the CPU, JAX's `pallas` the kernel
    in interpret mode."""
    cfg, jp, np_params, batch = setup
    assert cfg.remat
    ops.reset_counts()
    t_loss, tg = _port_grads(cfg, np_params, batch, accum, port_backend)
    c = ops.counts()
    if port_backend == "cuda":
        assert c["sa_matmul_bwd"]["plain_calls"] > 0, c
    else:
        assert c["sa_matmul_bwd"]["plain_calls"] == 0, c
    j_loss, jg = _jax_grads(cfg, jp, batch, accum, jax_backend)
    assert abs(t_loss - j_loss) <= REL_LOSS * abs(j_loss)
    rel = _rel_errors(jg, tg)
    assert max(rel.values()) <= REL_GRAD, sorted(rel.items(),
                                                key=lambda kv: -kv[1])[:3]


@pytest.mark.parametrize("port_backend,jax_backend",
                         [("torch", "xla"), ("cuda", "pallas")])
def test_tied_model_grads_match_jax(port_backend, jax_backend):
    """Reduced gemma2 (tied embeddings, GeGLU, softcaps, a local window of
    8 over 16 tokens): loss and every gradient leaf against
    jax.value_and_grad(lm_loss). The tied table's gradient is the
    lookup's scatter plus the head's dWᵀ, through the transposed view."""
    cfg = reduced_config("gemma2-9b")
    assert cfg.tie_embeddings and cfg.remat
    np_params = jax.tree.map(np.asarray,
                             JM.init_params(jax.random.key(3), cfg))
    assert "lm_head" not in np_params
    batch = JSynthetic(cfg.vocab_size, 16, 4, seed=1).batch_at(0)
    t_loss, tg = _port_grads(cfg, np_params, batch, 1, port_backend)
    toks, labs = (jnp.asarray(batch[k]) for k in ("tokens", "labels"))
    with JP.use_policy(JP.PrecisionPolicy(backend=jax_backend)):
        (j_loss, _), g = jax.jit(jax.value_and_grad(
            lambda p, t, l: JM.lm_loss(p, cfg, t, l), has_aux=True))(
            jax.tree.map(jnp.asarray, np_params), toks, labs)
    jg = _paths(jax.tree.map(np.asarray, g))
    assert abs(t_loss - float(j_loss)) <= REL_LOSS * abs(float(j_loss))
    rel = _rel_errors(jg, tg)
    assert max(rel.values()) <= REL_GRAD, sorted(rel.items(),
                                                key=lambda kv: -kv[1])[:3]


def test_train_step_grad_tolerance_rejects_dropped_jacobian(setup,
                                                            monkeypatch):
    """A backward that drops the FFN gate's activation jacobian lands
    outside the per-leaf tolerance on that leaf."""
    cfg, jp, np_params, batch = setup
    backward = MM.SAMatmulFn.backward

    class NoJacobian(MM.SAMatmulFn):
        @staticmethod
        def backward(ctx, dy):
            ctx.act = "none"
            return backward(ctx, dy)

    monkeypatch.setattr(MM, "SAMatmulFn", NoJacobian)
    _, tg = _port_grads(cfg, np_params, batch, 1, "cuda")
    _, jg = _jax_grads(cfg, jp, batch, 1, "pallas")
    rel = _rel_errors(jg, tg)
    assert rel[("layers", 0, "ffn", "wg")] > REL_GRAD


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_remat_grads_bit_identical(setup, backend):
    cfg, _, np_params, batch = setup
    outs = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        outs.append(_port_grads(c, np_params, batch, 2, backend))
    (l1, g1), (l2, g2) = outs
    assert l1 == l2
    for p in g1:
        np.testing.assert_array_equal(g1[p].view(np.uint32),
                                      g2[p].view(np.uint32), err_msg=str(p))


def test_train_step_matches_jax_step(setup):
    """One whole step (accum 2, warmup-cosine AdamW) from the same state:
    metrics close, parameters within 2·lr, the step counter advanced."""
    cfg, jp, np_params, batch = setup
    sched = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    jopt = JO.AdamW(schedule=JO.warmup_cosine(**sched))
    topt = TO.AdamW(schedule=TO.warmup_cosine(**sched))
    jstate = JO.AdamWState(count=jnp.zeros((), jnp.int32),
                           mu=jax.tree.map(jnp.zeros_like, jp),
                           nu=jax.tree.map(jnp.zeros_like, jp))
    from repro.train.train_state import TrainState as JTrainState
    js = JTrainState(step=jnp.zeros((), jnp.int32), params=jp,
                     opt_state=jstate)
    with JP.use_policy(JP.PrecisionPolicy(backend="xla")):
        js, jm = jax.jit(j_make_train_step(cfg, jopt, accum_steps=2))(
            js, {k: jnp.asarray(v) for k, v in batch.items()})
    ts = state_from_numpy(jax.tree.map(np.asarray, JTrainState(
        step=jnp.zeros((), jnp.int32), params=jp, opt_state=jstate)), "cpu")
    assert isinstance(ts, TrainState)
    with TP.use_policy(TP.PrecisionPolicy(backend="torch")):
        ts, tm = make_train_step(cfg, topt, accum_steps=2)(
            ts, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert int(ts.step) == int(js.step) == 1
    assert int(ts.opt_state.count) == 1
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                              rel=REL_LOSS)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=REL_GRAD)
    lr = float(jm["lr"])
    jp1, tp1 = _paths(jax.tree.map(np.asarray, js.params)), _paths(ts.params)
    for p in jp1:
        np.testing.assert_allclose(tp1[p], jp1[p], rtol=0, atol=2 * lr,
                                   err_msg=str(p))
    assert all(p.grad is None for p in TM.tree_leaves(ts.params))


# ---------------------------------------------------------------------------
# AdamW and its schedules
# ---------------------------------------------------------------------------

def test_adamw_matches_jax_on_identical_grads():
    rng = np.random.default_rng(0)
    p = {"a": rng.standard_normal((4, 3)).astype(np.float32),
         "b": {"c": rng.standard_normal((7,)).astype(np.float32)}}
    sched = dict(peak_lr=1e-2, warmup_steps=2, total_steps=6)
    jopt = JO.AdamW(schedule=JO.warmup_cosine(**sched))
    topt = TO.AdamW(schedule=TO.warmup_cosine(**sched))
    jp = jax.tree.map(jnp.asarray, p)
    js = jopt.init(jp)
    tp = jax.tree.map(lambda x: torch.from_numpy(x.copy()), p)
    tstate = topt.init(tp)
    for t in range(1, 6):
        # step 3 is clipped (norm far above clip_norm 1), the others not
        g = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * (
            3.0 if t == 3 else 0.05)).astype(np.float32), p)
        jp, js, jm = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, tstate, tm = topt.update(
            jax.tree.map(lambda x: torch.from_numpy(x.copy()), g), tstate,
            tp)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                       rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        for tree_t, tree_j in ((tp, jp), (tstate.mu, js.mu),
                               (tstate.nu, js.nu)):
            for path, x in _paths(tree_j).items():
                np.testing.assert_allclose(_paths(tree_t)[path], x,
                                           rtol=1e-6, atol=1e-12)
    assert int(tstate.count) == int(js.count) == 5


def test_schedules_match_jax():
    j = JO.warmup_cosine(3e-4, 10, 100, final_frac=0.1)
    t = TO.warmup_cosine(3e-4, 10, 100, final_frac=0.1)
    for step in (0, 1, 5, 10, 11, 55, 99, 100, 150):
        assert float(t(step)) == pytest.approx(float(j(step)), rel=1e-6)
    assert float(t(0)) == 0.0
    assert float(TO.constant_lr(0.5)(7)) == float(JO.constant_lr(0.5)(7))


# ---------------------------------------------------------------------------
# data, checkpoints, fault handling, the driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("structured", [False, True])
def test_synthetic_batches_equal_jax(structured):
    j = JSynthetic(503, 16, 4, seed=3, structured=structured)
    t = SyntheticLM(503, 16, 4, seed=3, structured=structured)
    for step in (0, 7):
        for host in (0, 1):
            jb, tb = j.batch_at(step, host), t.batch_at(step, host)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(jb[k], tb[k])
    it = iter(t)
    np.testing.assert_array_equal(next(it)["tokens"],
                                  t.batch_at(0)["tokens"])


def test_memmap_pipeline(tmp_path):
    path = str(tmp_path / "toks.bin")
    np.arange(10_000, dtype=np.int32).tofile(path)
    d = MemmapTokens(path, seq_len=32, batch_per_host=2, n_hosts=2, host=1)
    b = d.batch_at(0)
    assert b["tokens"].shape == (2, 32)
    np.testing.assert_array_equal(b["labels"], b["tokens"] + 1)
    one = MemmapTokens(path, seq_len=32, batch_per_host=2)
    assert one.n_hosts == 1 and one.host == 0
    assert not np.array_equal(one.batch_at(0)["tokens"], b["tokens"])


def test_prefetcher_yields_in_order():
    it = Prefetcher(iter([{"x": np.full(2, i)} for i in range(5)]), depth=2)
    assert [int(b["x"][0]) for b in it] == list(range(5))


def _tree():
    return {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nested": {"b": torch.full((5,), 1.5, dtype=torch.bfloat16)},
            "opt": TO.AdamWState(count=torch.tensor(7, dtype=torch.int32),
                                 mu={"m": torch.ones(2)}, nu={"m": torch.ones(2)})}


def test_checkpoint_roundtrip_and_latest(tmp_path):
    t = _tree()
    CKPT.save(str(tmp_path), 1, t, extra={"note": "x"})
    CKPT.save(str(tmp_path), 5, t)
    assert CKPT.latest_step(str(tmp_path)) == 5
    restored, extra, step = CKPT.restore(str(tmp_path), t, step=1)
    assert step == 1 and extra == {"note": "x"}
    assert isinstance(restored["opt"], TO.AdamWState)
    for a, b in zip(TM.tree_leaves(t), TM.tree_leaves(restored)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    assert CKPT.restore(str(tmp_path), t)[2] == 5


def test_checkpoint_detects_corruption(tmp_path):
    d = CKPT.save(str(tmp_path), 2, _tree())
    victim = os.path.join(d, "arr_00000.npy")
    raw = bytearray(open(victim, "rb").read())
    raw[-1] ^= 0xFF
    open(victim, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="corruption"):
        CKPT.restore(str(tmp_path), _tree())


def test_async_saver(tmp_path):
    t = _tree()
    saver = CKPT.AsyncSaver()
    saver.save_async(str(tmp_path), 9, t)
    saver.wait()
    assert CKPT.latest_step(str(tmp_path)) == 9
    restored, _, _ = CKPT.restore(str(tmp_path), t)
    assert torch.equal(restored["nested"]["b"], t["nested"]["b"])


def test_straggler_watchdog_flags_slow_steps(monkeypatch):
    """A step slower than threshold × the running median is flagged, and
    only that one. The watchdog reads a fake clock here: with real sleeps
    a loaded host's hiccup is a straggler too."""
    import types

    from repro_torch.train import fault

    now = [0.0]
    monkeypatch.setattr(fault, "time",
                        types.SimpleNamespace(perf_counter=lambda: now[0]))
    events = []
    w = StragglerWatchdog(threshold=2.0,
                          on_straggler=lambda *a: events.append(a))
    for i, dt in enumerate([1.0, 1.1, 0.9, 1.0, 1.05, 1.0, 3.0, 1.0]):
        w.step_start()
        now[0] += dt
        assert w.step_end(i) == pytest.approx(dt)
    assert [e[0] for e in w.events] == [6]
    assert w.events[0][1] == pytest.approx(3.0)
    assert events == w.events


def test_state_from_jax_train_state(setup):
    from repro.train.train_state import TrainState as JTrainState

    _, jp, _, _ = setup
    jopt = JO.AdamW(schedule=JO.constant_lr(1e-3))
    js = JTrainState(step=jnp.zeros((), jnp.int32), params=jp,
                     opt_state=jopt.init(jp))
    ts = state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    assert isinstance(ts.opt_state, TO.AdamWState)
    jpaths, tpaths = _paths(jax.tree.map(np.asarray, js.params)), \
        _paths(ts.params)
    assert set(jpaths) == set(tpaths)
    for p, x in jpaths.items():
        assert tpaths[p].dtype == np.float32       # masters, not bf16
        np.testing.assert_array_equal(tpaths[p], x)
    assert all(t.requires_grad for t in TM.tree_leaves(ts.params))
    assert int(ts.opt_state.count) == 0


def test_train_driver_checkpoints_and_resumes(tmp_path, capsys):
    from repro_torch.launch import train as drv

    ck = str(tmp_path / "ck")
    args = ["--arch", "qwen2.5-14b", "--reduced", "--device", "cpu",
            "--steps", "3", "--batch", "4", "--seq", "16", "--accum", "2",
            "--ckpt-dir", ck, "--ckpt-every", "2"]
    state = drv.main(args)
    out = capsys.readouterr().out
    assert "step     3 loss=" in out and "done: 3 steps" in out
    assert CKPT.latest_step(ck) == 3 and int(state.step) == 3
    state2, hist = drv.run(reduced_config("qwen2.5-14b"),
                           drv.parse_args(args[:6] + ["4"] + args[7:]
                                          + ["--resume"]))
    assert "resumed from step 3" in capsys.readouterr().out
    assert [h["step"] for h in hist] == [4] and int(state2.step) == 4
    assert all(np.isfinite([h["loss"], h["grad_norm"]]).all() for h in hist)
    # one process that no launcher started has no world to shard over
    with pytest.raises(ValueError, match="world of ranks"):
        drv.main(args + ["--model-parallel", "2"])
