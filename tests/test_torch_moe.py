"""PyTorch port: the MoE family (granite-moe-3b, llama4-maverick) against
the JAX package on the same numpy inputs (reduced configs, weights drawn
by the JAX package and carried over by `params_from_numpy`).

What MoE adds to the decoder: a router (fp32 logits through `sa_dot`,
softmax, top-k with ties to the lower index, renormalized combine
weights, the `load_balance` and `router_z` aux losses), the dropless
dispatch every served forward takes, the capacity dispatch training
takes, llama4's shared expert and its dense layers at `d_ff_dense`, and
the aux losses in `lm_loss`.

Tolerances, each with its reason:

* MoE FFN under the fp32 policy: 2⁻¹⁶ of the output's largest magnitude
  (fp32 sums of ≤ 128 terms in another order, and a combine weight that
  differs in its last bit); the combine weights and aux losses 2⁻²⁰
  relative (softmax, renormalization and means in fp32).
* Logits: 2⁻⁵·max|logit|, the greedy token equal where the top-2 gap
  exceeds twice that (tests/test_torch_families.py: the residual stream
  is bf16 in both frameworks, so a last-bit fp32 difference can flip a
  bf16 rounding). Serve streams under the fp32 policy at prompt seed 2
  (R1: away from near-tie argmaxes and routing near-ties).
* Gradients: tests/test_torch_train.py's, loss within 2⁻¹⁰ relative and
  each leaf within 2⁻⁵ of its norm.

Routing is a discontinuous function of the router logits, so the bf16
residual's last-bit differences (R1) reach further here: a token whose
top-k gap (or, under capacity, whose gate at an expert's C-th place) is
within them routes differently. The JAX package's compiled forward and
its op-by-op (`jax.disable_jit()`) forward already differ by that much on
these reduced configs (router logits ~1e-2 apart; llama4's 6-token
prompt of seed 1 routes one token to another expert compiled, its logits
1.48 apart; compiled loss gradients 10-18 % of a leaf's norm away from
the op-by-op ones: ROADMAP R8). The port runs op by op, so forwards and
gradients are held to the JAX package's op-by-op run, where the same
tolerances hold at every seed tried; the serve streams are held to the
compiled JAX engine at a prompt seed away from a routing near-tie.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the parity tests need the JAX package; the card's machine has no JAX and
# runs tests/test_torch_gpu.py instead
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config  # noqa: E402
from repro.core import PrecisionPolicy, use_policy  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSynthetic  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro.serve.scheduler import SlotScheduler as JSched  # noqa: E402
from repro_torch.core import precision as TP  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models.config import ArchConfig  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.scheduler import SlotScheduler  # noqa: E402
from repro_torch.train.step import make_grad_fn  # noqa: E402

torch.set_num_threads(2)
REL = 2.0 ** -5
REL_FFN = 2.0 ** -16
REL_ROUTER = 2.0 ** -20
REL_GRAD, REL_LOSS = 2.0 ** -5, 2.0 ** -10
GRANITE, LLAMA4 = "granite-moe-3b-a800m", "llama4-maverick-400b-a17b"
ARCHS = (GRANITE, LLAMA4)
FP32_J = PrecisionPolicy(input_format="fp32")
FP32_T = TP.PrecisionPolicy(input_format="fp32")


def _cfg(arch, **kw):
    return dataclasses.replace(reduced_config(arch, layers_per_period=2),
                               remat=False, **kw)


@pytest.fixture(scope="module")
def models():
    """Each reduced MoE config with the JAX package's weights (key 1) and
    the port's copy of them."""
    out = {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        jp = JM.init_params(jax.random.key(1), cfg)
        out[arch] = (cfg, jp, params_from_numpy(
            jax.tree.map(np.asarray, jp), "cpu"))
    return out


def _moe_params(arch):
    """The first MoE layer's parameters in both frameworks."""
    cfg = _cfg(arch)
    jp = JM.init_params(jax.random.key(1), cfg)
    jm = jax.tree.map(lambda x: x[0],
                      jp["layers"][cfg.moe_every - 1]["moe"])
    tm = params_from_numpy(jax.tree.map(np.asarray, jm), "cpu")
    return cfg, jm, tm


def _close(ref, got, rel):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert ref.shape == got.shape
    assert np.abs(ref - got).max() <= rel * max(np.abs(ref).max(), 1e-30)


def _check_logits(ref, got, vocab):
    ref, got = np.asarray(ref), got.numpy()
    r, g = ref[..., :vocab], got[..., :vocab]
    bound = REL * np.abs(r).max()
    assert np.abs(r - g).max() <= bound
    top2 = np.sort(r, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * bound
    assert (r.argmax(-1) == g.argmax(-1))[decided].all()


def _eager():
    """The JAX package's op-by-op forward (see the module docstring)."""
    return jax.disable_jit()


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 8])
def test_router_matches_jax(k):
    E, D = 40, 32
    x = _x((2, 6, D), k)
    w = _x((D, E), k + 1) * 0.3
    with use_policy(FP32_J):
        jc, jaux = JMOE.router(jnp.asarray(x), jnp.asarray(w), k)
    with TP.use_policy(FP32_T):
        tc, taux = TMOE.router(torch.from_numpy(x), torch.from_numpy(w), k)
    jc = np.asarray(jc)
    assert np.array_equal(jc > 0, tc.numpy() > 0)
    _close(jc, tc, REL_ROUTER)
    for key in ("load_balance", "router_z"):
        _close(jaux[key], taux[key], REL_ROUTER)


def test_router_tie_at_the_kth_place_picks_the_jax_expert():
    """Experts 2 and 6 carry the same router column, below expert 0's and
    above every other: for k = 2 they tie at the second place on every
    token, and both frameworks take expert 2 (the lower index)."""
    E, D, k = 8, 16, 2
    x = np.abs(_x((2, 5, D), 3)) + 0.1
    v = np.abs(_x((D,), 4)) + 0.1
    w = _x((D, E), 5) * 0.01
    w[:, 0], w[:, 2], w[:, 6] = 3 * v, 2 * v, 2 * v
    with use_policy(FP32_J):
        jc, _ = JMOE.router(jnp.asarray(x), jnp.asarray(w), k)
    with TP.use_policy(FP32_T):
        tc, _ = TMOE.router(torch.from_numpy(x), torch.from_numpy(w), k)
    picked = tc.numpy() > 0
    assert picked[..., 0].all() and picked[..., 2].all()
    assert not picked[..., 6].any()
    assert np.array_equal(np.asarray(jc) > 0, picked)
    _close(jc, tc, REL_ROUTER)


def test_capacity_matches_jax():
    for T, E, k in [(1, 40, 8), (16, 8, 2), (512, 40, 8), (2048, 128, 1)]:
        for f in (1.0, 1.25, float(E)):
            assert TMOE.capacity(T, E, k, f) == JMOE.capacity(T, E, k, f)


# ---------------------------------------------------------------------------
# the dispatches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("T", [1, 8, 130])
def test_dropless_matches_jax(arch, T):
    """T = 130 crosses a DROPLESS_CHUNK_T boundary (two chunks, the second
    zero-padded); llama4 adds its shared expert."""
    cfg, jm, tm = _moe_params(arch)
    x = _x((2, T, cfg.d_model), T)
    with use_policy(FP32_J):
        jy, jaux = JMOE.moe_ffn(jnp.asarray(x), jm, cfg, cfg.act,
                                dropless=True)
    with TP.use_policy(FP32_T):
        ty, taux = TMOE.moe_ffn(torch.from_numpy(x), tm, cfg, cfg.act,
                                dropless=True)
    _close(jy, ty, REL_FFN)
    for key in jaux:
        _close(jaux[key], taux[key], REL_ROUTER)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("factor", [1.25, None])
def test_capacity_dispatch_matches_jax(arch, factor):
    """`factor` 1.25 drops tokens (shown against the dropless result);
    None is a capacity of E, where nothing drops."""
    cfg, jm, tm = _moe_params(arch)
    factor = factor or float(cfg.num_experts)
    x = _x((2, 16, cfg.d_model), 7)
    with use_policy(FP32_J):
        jy, _ = JMOE.moe_ffn(jnp.asarray(x), jm, cfg, cfg.act,
                             capacity_factor=factor)
    with TP.use_policy(FP32_T):
        ty, _ = TMOE.moe_ffn(torch.from_numpy(x), tm, cfg, cfg.act,
                             capacity_factor=factor)
        full, _ = TMOE.moe_ffn(torch.from_numpy(x), tm, cfg, cfg.act,
                               dropless=True)
    _close(jy, ty, REL_FFN)
    dropped = not torch.allclose(ty, full, rtol=1e-4, atol=1e-5)
    assert dropped == (factor == 1.25)


def test_dropless_equals_capacity_when_nothing_drops():
    """With capacity ≥ T no token drops, so both dispatches compute the
    same function (the JAX package's tests/test_serve.py:217)."""
    cfg, _, tm = _moe_params(GRANITE)
    x = torch.from_numpy(_x((2, 4, cfg.d_model), 0))
    with TP.use_policy(FP32_T):
        cap, aux_c = TMOE.moe_ffn(x, tm, cfg,
                                  capacity_factor=float(cfg.num_experts))
        drop, aux_d = TMOE.moe_ffn(x, tm, cfg, dropless=True)
    torch.testing.assert_close(cap, drop, rtol=1e-5, atol=1e-5)
    for key in aux_c:
        torch.testing.assert_close(aux_c[key], aux_d[key], rtol=1e-6,
                                   atol=0)


@pytest.mark.parametrize("dropless", [False, True])
def test_single_expert_top1_equals_swiglu(dropless):
    """E = 1, top-1: the MoE FFN is the plain SwiGLU FFN (the JAX
    package's tests/test_layers.py:112)."""
    cfg = ArchConfig(name="t", family="moe", num_layers=1, d_model=16,
                     num_heads=2, num_kv_heads=1, d_ff=32, vocab_size=64,
                     num_experts=1, experts_per_token=1)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 8, 16), generator=g)
    p = {"router": torch.zeros((16, 1)),
         "wg": torch.randn((1, 16, 32), generator=g) * 0.1,
         "wu": torch.randn((1, 16, 32), generator=g) * 0.1,
         "wd": torch.randn((1, 32, 16), generator=g) * 0.1}
    with TP.use_policy(FP32_T):
        y, _ = TMOE.moe_ffn(x, p, cfg, capacity_factor=1.0,
                            dropless=dropless)
        want = TL.ffn_swiglu(x, {"wg": p["wg"][0], "wu": p["wu"][0],
                                 "wd": p["wd"][0]})
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-6)


def test_expert_products_are_2d_sa_dot_calls(monkeypatch):
    """The dispatches run each expert's products as 2-D `sa_dot` calls on
    the expert's slice of the stack, read in place (no copy of the
    stack): granite's reduced MoE layer makes 1 router + 3·E GEMMs a
    dropless chunk and 3·E a capacity pass, every weight 2-D."""
    cfg, _, tm = _moe_params(GRANITE)
    seen = []
    orig = TMOE.sa_dot

    def spy(a, w, *args, **kw):
        seen.append((a.ndim, w.ndim, w.data_ptr()))
        return orig(a, w, *args, **kw)

    monkeypatch.setattr(TMOE, "sa_dot", spy)
    monkeypatch.setattr(TL, "sa_dot", spy)
    x = torch.from_numpy(_x((2, 3, cfg.d_model), 1))
    E = cfg.num_experts
    stack = {tm[k].data_ptr() + e * tm[k][0].numel() * 4
             for k in ("wg", "wu", "wd") for e in range(E)}
    for dropless in (True, False):
        seen.clear()
        TMOE.moe_ffn(x, tm, cfg, dropless=dropless)
        assert len(seen) == 1 + 3 * E
        assert all(w_nd == 2 for _, w_nd, _ in seen)
        assert {ptr for _, _, ptr in seen[1:]} == stack


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_jax(arch):
    """The port's tree has the JAX tree's keys and shapes: llama4's MoE
    layer its router, expert stacks and shared expert, its dense layer an
    FFN at d_ff_dense; the experts are d_ff wide."""
    cfg = _cfg(arch)
    tp = TM.init_params(cfg, seed=0, device="cpu")
    jshape = jax.eval_shape(lambda k: JM.init_params(k, cfg),
                            jax.random.key(0))
    flat = jax.tree_util.tree_flatten_with_path
    jflat = {jax.tree_util.keystr(p): x.shape for p, x in flat(jshape)[0]}
    tflat = {jax.tree_util.keystr(p): tuple(x.shape) for p, x in
             flat(tp)[0]}
    assert jflat == tflat
    moe = tp["layers"][cfg.moe_every - 1]["moe"]
    assert tuple(moe["wg"].shape[-2:]) == (cfg.d_model, cfg.d_ff)
    assert ("shared_wg" in moe) == cfg.shared_expert
    wd = moe["wd"]
    assert abs(float(wd.std()) * cfg.d_ff ** 0.5 - 1.0) < 0.05
    if cfg.moe_every > 1:
        assert tp["layers"][0]["ffn"]["wg"].shape[-1] == cfg.d_ff_dense


def test_convert_carries_moe_trees_key_for_key(models):
    """4-D expert stacks, the router and the shared expert carry over key
    for key and bit for bit (fp32 on the CPU; bf16 matrices is the CUDA
    default, fp32 masters on request)."""
    for arch in ARCHS:
        cfg, jp, tp = models[arch]
        flat = jax.tree_util.tree_flatten_with_path
        jflat = {jax.tree_util.keystr(p): np.asarray(x)
                 for p, x in flat(jp)[0]}
        tflat = {jax.tree_util.keystr(p): x for p, x in flat(tp)[0]}
        assert jflat.keys() == tflat.keys()
        assert any(v.ndim == 4 for v in jflat.values())
        for key, v in jflat.items():
            assert tflat[key].dtype == torch.float32
            assert np.array_equal(v, tflat[key].numpy()), key


@pytest.mark.parametrize("fmt", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux_match_jax(models, arch, fmt):
    """The full forward (no cache: capacity dispatch, aux summed over the
    layers) and a prefill into a cache (dropless, aux zero as in JAX)."""
    cfg, jp, tp = models[arch]
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 13)).astype(np.int32)
    with use_policy(PrecisionPolicy(input_format=fmt)), _eager():
        jl, _, jaux = JM.forward(jp, cfg, jnp.asarray(toks))
        jpl, _, _ = JM.forward(jp, cfg, jnp.asarray(toks), last_only=True,
                               cache=JM.init_cache(cfg, 2, 16,
                                                   dtype=jnp.float32))
    with TP.use_policy(TP.PrecisionPolicy(input_format=fmt)):
        tl, _, taux = TM.forward(tp, cfg, torch.from_numpy(toks))
        tpl, _, taux_c = TM.forward(tp, cfg, torch.from_numpy(toks),
                                    last_only=True,
                                    cache=TM.init_cache(
                                        cfg, 2, 16, dtype=torch.float32,
                                        device="cpu"))
    _check_logits(jl, tl, cfg.vocab_size)
    _check_logits(jpl, tpl, cfg.vocab_size)
    for key in ("load_balance", "router_z"):
        assert float(jaux[key]) > 0
        assert abs(float(taux[key]) - float(jaux[key])) <= REL * float(
            jaux[key])
        assert float(taux_c[key]) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_full_forward(models, arch):
    """The dropless dispatch is exact top-k routing at any T: a prefill of
    10 tokens then 3 decode steps gives each position's logits as the
    full dropless forward over all 13 does."""
    cfg, _, tp = models[arch]
    cfg = dataclasses.replace(cfg, moe_dropless=True)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 13)).astype(np.int32))
    with TP.use_policy(FP32_T):
        full, _, _ = TM.forward(tp, cfg, toks)
        cache = TM.init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
        pre, cache, _ = TM.forward(tp, cfg, toks[:, :10], cache=cache)
        steps = [pre]
        for t in range(10, 13):
            lg, cache, _ = TM.forward(tp, cfg, toks[:, t:t + 1],
                                      cache=cache, pos=t)
            steps.append(lg)
    got = torch.cat(steps, dim=1)[..., :cfg.vocab_size]
    want = full[..., :cfg.vocab_size]
    assert float((got - want).abs().max()) <= 2.0 ** -16 * float(
        want.abs().max())


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _prompts(cfg, lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]


def _serve(engine_cls, sched_cls, cfg, params, prompts, budgets, layout,
           **kw):
    eng = engine_cls(cfg, params, batch=2, cache_len=32, eos_id=-1,
                     sync_every=2, kv_layout=layout, page_size=8, **kw)
    sched = sched_cls(2, eos_id=-1)
    for p, n in zip(prompts, budgets):
        sched.submit(p, max_new_tokens=n)
    summary = eng.serve(sched)
    return {r.rid: r.tokens for r in sched.finished}, summary


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_jax_engine_paged_equals_ring(models, arch):
    """Three requests over two slots (a refill) through the JAX engine and
    the port's paged and ring engines, under the fp32 policy: one token
    stream, every budget met, no page leaked. Prompt seed 2: seed 1's
    6-token prompt meets a routing near-tie in llama4's second MoE layer
    (test_routing_near_tie_follows_the_op_by_op_reference)."""
    cfg, jp, tp = models[arch]
    prompts = _prompts(cfg, (12, 6, 14), seed=2)
    budgets = (8, 3, 5)
    with use_policy(FP32_J):
        ref, _ = _serve(JEngine, JSched, cfg, jp, prompts, budgets, "paged")
    with TP.use_policy(FP32_T):
        paged, s = _serve(ServeEngine, SlotScheduler, cfg, tp, prompts,
                          budgets, "paged")
        ring, _ = _serve(ServeEngine, SlotScheduler, cfg, tp, prompts,
                         budgets, "ring")
    assert paged == ref == ring
    assert [len(paged[i]) for i in sorted(paged)] == list(budgets)
    assert s["pages_leaked"] == 0 and s["nonfinite_logits"] == 0


def test_routing_near_tie_follows_the_op_by_op_reference(models):
    """llama4's 6-token prompt of seed 1: in its second MoE layer one
    token's top-1 gap (8.4e-3 of its probability) is within the router
    logits' spread between the JAX package's compiled and op-by-op
    forwards (~2e-2), and the compiled one routes it elsewhere (its
    prefill logits 1.48 from the op-by-op ones; ROADMAP R8). The port's
    prefill holds the op-by-op reference's logits and token."""
    cfg, jp, tp = models[LLAMA4]
    toks = np.asarray(_prompts(cfg, (12, 6, 14), seed=1)[1], np.int32)[None]
    with use_policy(FP32_J), _eager():
        jl, _, _ = JM.forward(jp, cfg, jnp.asarray(toks), last_only=True,
                              cache=JM.init_cache(cfg, 1, 16,
                                                  dtype=jnp.float32))
    with TP.use_policy(FP32_T):
        tl, _, _ = TM.forward(tp, cfg, torch.from_numpy(toks),
                              last_only=True,
                              cache=TM.init_cache(cfg, 1, 16,
                                                  dtype=torch.float32,
                                                  device="cpu"))
    _check_logits(jl, tl, cfg.vocab_size)
    v = cfg.vocab_size
    assert int(np.asarray(jl)[..., :v].argmax()) == int(tl[..., :v].argmax())


@pytest.mark.parametrize("layout", ["paged", "ring"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_gates_equal_the_jax_engine(models, arch, layout):
    """Prefix caching, disagg, bucketing and spec: each gate's boolean is
    the JAX engine's (neither gates on MoE)."""
    cfg, jp, tp = models[arch]
    kw = dict(batch=2, cache_len=32, eos_id=-1, kv_layout=layout,
              page_size=8, spec_k=2, disagg=True, bucket_prompts=True)
    jeng, teng = JEngine(cfg, jp, **kw), ServeEngine(cfg, tp, **kw)
    for gate in ("prefix_caching_on", "disagg_on", "bucketing_on",
                 "spec_decoding_on"):
        assert bool(getattr(teng, gate)()) == bool(getattr(jeng, gate)()), \
            gate
    assert teng.spec_decoding_on() and teng.bucketing_on()


def test_no_served_path_reaches_the_capacity_dispatch(models, monkeypatch):
    """Every served forward threads a cache, so it routes dropless: with
    the capacity dispatch made to raise, reduced granite serves paged and
    ring, bucketed, speculative (draft and folded verify), two-pool,
    through `generate()` and the divergence probe. A training forward (no
    cache) reaches it, so the refusal is live."""
    cfg, _, tp = models[GRANITE]

    def refuse(*a, **kw):
        raise AssertionError("a served forward reached the capacity "
                             "dispatch")

    monkeypatch.setattr(TMOE, "capacity", refuse)
    prompts = _prompts(cfg, (12, 6, 14))
    runs = [dict(layout="paged"), dict(layout="ring"),
            dict(layout="paged", bucket_prompts=True),
            dict(layout="paged", spec_k=2),
            dict(layout="paged", disagg=True)]
    with TP.use_policy(FP32_T):
        streams = []
        for kw in runs:
            out, s = _serve(ServeEngine, SlotScheduler, cfg, tp, prompts,
                            (6, 3, 5), **kw)
            assert s["nonfinite_logits"] == 0
            streams.append(out)
        assert all(s == streams[0] for s in streams)
        eng = ServeEngine(cfg, tp, batch=2, cache_len=32, eos_id=-1,
                          kv_layout="ring")
        gen = eng.generate(torch.tensor([prompts[0], prompts[0]]), 4)
        assert tuple(gen.shape) == (2, 4)
        assert eng.divergence_probe(prompts[1], steps=4)["steps"] == 4
        with pytest.raises(AssertionError, match="capacity"):
            TM.forward(tp, cfg, torch.tensor([prompts[0]]))


def test_decode_step_gemm_count_is_the_dispatch_s(models):
    """A decode step runs (4 + 1 + 3E)·L_moe + 7·L_dense + 1 SA GEMMs
    (attention, router, each expert's three, a dense layer's seven, the
    lm_head; llama4's shared expert adds 3 a MoE layer): on the CPU each
    is a plain call, on the card each a kernel launch (the same count,
    tests/test_torch_gpu.py)."""
    for arch in ARCHS:
        cfg, _, tp = models[arch]
        eng = ServeEngine(cfg, tp, batch=2, cache_len=32, page_size=8)
        cache = eng.new_cache()
        ops.reset_counts()
        with TP.use_policy(FP32_T):
            eng._serve_step(tp, torch.zeros((2, 1), dtype=torch.int32),
                            cache, torch.zeros((2,), dtype=torch.int32))
        assert ops.counts()["sa_matmul"]["plain_calls"] == \
            TMOE.gemm_calls(cfg)


# ---------------------------------------------------------------------------
# training: the loss with aux, and its gradients
# ---------------------------------------------------------------------------

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


def _jax_grads(arch):
    """(cfg, numpy params, batch, (loss, nll, gradient leaves)) of the JAX
    package's op-by-op value_and_grad(lm_loss), once an arch."""
    if arch not in _JAX_GRADS:
        cfg = dataclasses.replace(_cfg(arch), remat=True)
        jp = JM.init_params(jax.random.key(3), cfg)
        batch = JSynthetic(cfg.vocab_size, 16, 4, seed=1).batch_at(0)
        toks, labs = (jnp.asarray(batch[k]) for k in ("tokens", "labels"))
        with use_policy(PrecisionPolicy(backend="xla")), _eager():
            (loss, nll), g = jax.value_and_grad(
                lambda p, t, l: JM.lm_loss(p, cfg, t, l), has_aux=True)(
                jp, toks, labs)
        _JAX_GRADS[arch] = (cfg, jax.tree.map(np.asarray, jp), batch, (
            float(loss), float(nll), _paths(jax.tree.map(np.asarray, g))))
    return _JAX_GRADS[arch]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("port_backend", ["torch", "cuda"])
def test_lm_loss_with_aux_and_grads_match_jax(arch, port_backend):
    """Loss (nll + 0.01·(load_balance + router_z)), nll and every gradient
    leaf of the capacity-dispatch forward, remat on, against
    jax.value_and_grad(lm_loss) op by op; the port's `cuda` backend runs
    SAMatmulFn's plain version on the CPU. The JAX side runs its `xla`
    backend (its Pallas kernel in interpret mode takes minutes op by op;
    tests/test_torch_train.py holds SAMatmulFn to it)."""
    cfg, np_params, batch, (j_loss, j_nll, jg) = _jax_grads(arch)
    params = params_from_numpy(np_params, "cpu", dtype=torch.float32)
    for p in TM.tree_leaves(params):
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ops.reset_counts()
    with TP.use_policy(TP.PrecisionPolicy(backend=port_backend)):
        t_loss, t_nll, grads = make_grad_fn(cfg)(params, tb)
    bwd = ops.counts()["sa_matmul_bwd"]["plain_calls"]
    assert (bwd > 0) == (port_backend == "cuda")
    assert j_loss - j_nll > 0      # the aux term is on
    for want, got in ((j_loss, t_loss), (j_nll, t_nll)):
        assert abs(float(got) - want) <= REL_LOSS * abs(want)
    tg = _paths(grads)
    assert set(jg) == set(tg)
    rel = {p: float(np.linalg.norm(tg[p] - jg[p])
                    / (np.linalg.norm(jg[p]) + 1e-30)) for p in jg}
    assert max(rel.values()) <= REL_GRAD, sorted(
        rel.items(), key=lambda kv: -kv[1])[:3]
    router = [p for p in jg if "router" in p]
    assert router and all(np.abs(jg[p]).max() > 0 for p in router)
