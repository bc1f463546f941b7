"""PyTorch port: the frontend families, whisper-tiny (encoder-decoder) and
pixtral-12b (VLM), against the JAX package on the same numpy inputs
(reduced configs: d_model 64, hd 16, one decoder layer, whisper's two
encoder layers over 16 stub frames, pixtral's 16 stub patch rows; weights
drawn by the JAX package and carried over by `params_from_numpy`).

What they add to the decoder: layernorm, the GELU MLP, attention without
rope or mask and over another sequence's K and V (`kv_input`), the
sinusoidal positions and the encoder stack, the cross-attention sublayer
(whisper), the patch rows prepended to the text (pixtral), the frontend
through the steps, `generate(frontend=)` and the driver's static waves,
and `serve()`'s refusal.

Tolerances, each with its reason:

* layernorm, the MLP, attention, `encoder_kv` and `_sinusoid` under the
  fp32 policy: 2⁻¹⁶ of the output's largest magnitude (the same fp32
  operations on the same operands, associated another way: XLA fuses and
  reorders sums, and its sin and cos may differ from torch's in the last
  bit).
* `encode`: its residual stream is bf16 in both frameworks (the forward
  casts the frames to bf16), so a last-bit fp32 difference flips a bf16
  rounding (2⁻⁸ of one element) that the next layer carries: 2⁻⁵ of the
  largest magnitude, the bound the logits are held to.
* Logits: 2⁻⁵·max|logit|, the greedy token equal where the top-2 gap
  exceeds twice that (tests/test_torch_model.py's).
* Prefill then decode against a full forward, in the port alone under the
  fp32 policy: tests/test_decode.py's 1e-4 of max(1, max|logit|).
* Token streams under the fp32 policy (R1: away from near-tie argmaxes).
* Gradients: tests/test_torch_train.py's, the loss within 2⁻¹⁰ relative,
  each leaf within 2⁻⁵ of its norm.

ROADMAP F8: the JAX engine's `generate()` for a VLM hands the patches to
every decode step, where its forward prepends them to the one token, and
starts decoding at the text length; its stream is not greedy decoding of
its own forward. The port is held to the JAX package's full forward, and
the test shows that its stream is not the JAX engine's.
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
from repro.core import optflags as JO  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSynthetic  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro.serve.scheduler import SlotScheduler as JSched  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import precision as TP  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import (cache_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.models.layers import KVCache  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.scheduler import SlotScheduler  # noqa: E402
from repro_torch.train.step import make_grad_fn  # noqa: E402

torch.set_num_threads(2)
REL = 2.0 ** -5
REL_OP = 2.0 ** -16
REL_GRAD, REL_LOSS = 2.0 ** -5, 2.0 ** -10
WHISPER, PIXTRAL = "whisper-tiny", "pixtral-12b"
ARCHS = (WHISPER, PIXTRAL)
FP32_J = PrecisionPolicy(input_format="fp32")
FP32_T = TP.PrecisionPolicy(input_format="fp32")


def _cfg(arch, **kw):
    return dataclasses.replace(reduced_config(arch), remat=False, **kw)


@pytest.fixture(scope="module")
def models():
    """Each reduced config with the JAX package's weights (key 1) and the
    port's copy of them."""
    out = {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        jp = JM.init_params(jax.random.key(1), cfg)
        out[arch] = (cfg, jp, params_from_numpy(
            jax.tree.map(np.asarray, jp), "cpu"))
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, dtype=np.float32)


def _close(ref, got, rel=REL_OP):
    ref, got = _np(ref), _np(got)
    assert ref.shape == got.shape
    assert np.abs(ref - got).max() <= rel * max(np.abs(ref).max(), 1e-30)


def _check_logits(ref, got, vocab):
    ref, got = _np(ref), _np(got)
    assert np.isneginf(got[..., vocab:]).all()
    r, g = ref[..., :vocab], got[..., :vocab]
    bound = REL * np.abs(r).max()
    assert np.abs(r - g).max() <= bound
    top2 = np.sort(r, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * bound
    assert (r.argmax(-1) == g.argmax(-1))[decided].all()


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _frontend(cfg, B=2, seed=7):
    return _x((B, cfg.frontend_tokens, cfg.d_model), seed)


def _tokens(cfg, B, T, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)


def _layer0(tree):
    """Superblock / encoder layer 0 of a stacked tree (JAX or port)."""
    if isinstance(tree, dict):
        return {k: _layer0(v) for k, v in tree.items()}
    return tree[0]


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_layernorm_matches_jax(dtype):
    """The population variance (jnp.var), weight and bias in fp32, the
    result in the input's type; through `norm_apply`'s layernorm branch."""
    x = _x((3, 5, 64), 0) * 3.0 + 1.5
    w, b = _x((64,), 1), _x((64,), 2)
    jt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tt = torch.bfloat16 if dtype == "bf16" else torch.float32
    want = JL.norm_apply(jnp.asarray(x, jt), {"w": jnp.asarray(w),
                                              "b": jnp.asarray(b)},
                         "layernorm", 1e-5)
    got = TL.norm_apply(torch.from_numpy(x).to(tt),
                        {"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                        "layernorm", 1e-5)
    assert got.dtype == tt
    _close(want, got, REL_OP if dtype == "fp32" else 2.0 ** -8)


@pytest.mark.parametrize("fused", [True, False])
def test_ffn_mlp_matches_jax(fused, monkeypatch):
    """The GELU MLP with gelu in w1's epilogue (fused) and applied to its
    fp32 output (unfused), under the fp32 policy."""
    monkeypatch.setitem(JO.FLAGS, "fused_epilogue", fused)
    monkeypatch.setenv("REPRO_OPT", "1" if fused else "0")
    x = _x((2, 5, 64), 3)
    p = {"w1": _x((64, 128), 4) * 0.125, "w2": _x((128, 64), 5) * 0.09}
    with use_policy(FP32_J):
        want = JL.ffn_mlp(jnp.asarray(x), {k: jnp.asarray(v)
                                           for k, v in p.items()}, "gelu")
    with TP.use_policy(FP32_T):
        got = TL.ffn_mlp(torch.from_numpy(x), {k: torch.from_numpy(v)
                                               for k, v in p.items()}, "gelu")
    _close(want, got)


@pytest.mark.parametrize("form", ["encoder", "cross"])
def test_attention_block_without_rope_or_mask_matches_jax(models, form):
    """The encoder's self-attention (`rope=False`, `causal=False`) and the
    cross-attention (`kv_input`, K and V by `encoder_kv`: K unrotated,
    wq, wk and wv still run) of whisper's layer 0, under the fp32
    policy."""
    cfg, jp, tp = models[WHISPER]
    x = _x((2, 5, cfg.d_model), 6)
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5))
    if form == "encoder":
        jpar = _layer0(jp["encoder"]["layers"])["attn"]
        tpar = _layer0(tp["encoder"]["layers"])["attn"]
    else:
        jpar, tpar = _layer0(jp["layers"][0]["cross"]), _layer0(
            tp["layers"][0]["cross"])
    enc = _x((2, cfg.frontend_tokens, cfg.d_model), 8)
    with use_policy(FP32_J):
        kv = (JM._encoder_kv(jpar, cfg, jnp.asarray(enc))
              if form == "cross" else None)
        want, _ = JL.attention_block(jnp.asarray(x), jpar, cfg,
                                     {"attn": "global"}, jnp.asarray(pos),
                                     rope=False, causal=False,
                                     kv_override=kv)
    with TP.use_policy(FP32_T):
        tenc = torch.from_numpy(enc) if form == "cross" else None
        tkv = TL.encoder_kv(tpar, cfg, tenc) if form == "cross" else None
        ops.reset_counts()
        got, _ = TL.attention_block(torch.from_numpy(x), tpar, cfg,
                                    {"attn": "global"},
                                    torch.from_numpy(pos.copy()),
                                    rope=False, causal=False,
                                    kv_input=tenc)
    _close(want, got)
    if form == "cross":
        for a, b in zip(kv, tkv):
            _close(a, b)
    # wq, wk, wv, wo, and the encoder's K and V for the cross form
    assert ops.counts()["sa_matmul"]["plain_calls"] == (
        6 if form == "cross" else 4)


def test_rope_is_skipped_only_where_asked(models):
    """The same block with and without rope at positions past 0 differs
    (the switch is live), and at positions all 0 rope is the identity."""
    cfg, _, tp = models[WHISPER]
    x = torch.from_numpy(_x((1, 4, cfg.d_model), 9))
    p = _layer0(tp["layers"][0]["attn"])
    pos = torch.arange(4, dtype=torch.int32)[None] + 3
    with TP.use_policy(FP32_T):
        a, _ = TL.attention_block(x, p, cfg, {"attn": "global"}, pos)
        b, _ = TL.attention_block(x, p, cfg, {"attn": "global"}, pos,
                                  rope=False)
        c, _ = TL.attention_block(x, p, cfg, {"attn": "global"},
                                  torch.zeros_like(pos))
        d, _ = TL.attention_block(x, p, cfg, {"attn": "global"},
                                  torch.zeros_like(pos), rope=False)
    assert float((a - b).abs().max()) > 1e-3
    assert torch.equal(c, d)


def test_sinusoid_matches_jax():
    """sin then cos, concatenated (not interleaved), (1, T, d) fp32."""
    want = JM._sinusoid(37, 64)
    got = TM._sinusoid(37, 64)
    assert got.shape == (1, 37, 64) and got.dtype == torch.float32
    _close(want, got)
    assert np.array_equal(_np(got)[0, 0], np.r_[np.zeros(32), np.ones(32)])


@pytest.mark.parametrize("fmt", ["fp32", "bf16"])
def test_encode_matches_jax(models, fmt):
    """The encoder stack over bf16 frames (as the forward casts them)."""
    cfg, jp, tp = models[WHISPER]
    fe = _frontend(cfg)
    with use_policy(PrecisionPolicy(input_format=fmt)):
        want = JM.encode(jp, cfg, jnp.asarray(fe, jnp.bfloat16))
    with TP.use_policy(TP.PrecisionPolicy(input_format=fmt)):
        got = TM.encode(tp, cfg, torch.from_numpy(fe).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(want, got, REL)


# ---------------------------------------------------------------------------
# parameters, caches and their conversion
# ---------------------------------------------------------------------------

def _flat(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): x for p, x in flat}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_jax(arch):
    """Keys and shapes: whisper's `w1`/`w2` MLP, layernorm biases,
    `cross`/`norm_cross` in each decoder layer and the `encoder` tree
    stacked over its layers; pixtral is the dense tree."""
    cfg = _cfg(arch)
    tp = TM.init_params(cfg, seed=0, device="cpu")
    jshape = jax.eval_shape(lambda k: JM.init_params(k, cfg),
                            jax.random.key(0))
    assert ({k: tuple(v.shape) for k, v in _flat(tp).items()}
            == {k: v.shape for k, v in _flat(jshape).items()})
    assert ("encoder" in tp) == (arch == WHISPER)
    if arch == WHISPER:
        assert set(tp["layers"][0]) == {"norm1", "norm2", "attn", "cross",
                                        "norm_cross", "ffn"}
        assert tp["encoder"]["layers"]["ffn"]["w1"].shape[0] == 2
        assert float(tp["final_norm"]["b"].abs().max()) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_and_convert_give_the_same_types(arch):
    """Leaf for leaf, `init_params` and `params_from_numpy` store the same
    types, with the matrix type bf16 (the card's) and fp32: the vectors
    stacked under `encoder.layers` (norms and their biases) stay fp32."""
    cfg = _cfg(arch)
    jp = jax.tree.map(np.asarray, JM.init_params(jax.random.key(1), cfg))
    for dt in (torch.bfloat16, torch.float32):
        made = {k: v.dtype for k, v in _flat(TM.init_params(
            cfg, device="cpu", dtype=dt)).items()}
        conv = {k: v.dtype for k, v in _flat(params_from_numpy(
            jp, "cpu", dtype=dt)).items()}
        assert made == conv, dt
    conv = params_from_numpy(jp, "cpu", dtype=torch.bfloat16)
    if arch == WHISPER:
        enc = conv["encoder"]["layers"]
        assert enc["norm1"]["b"].dtype == torch.float32
        assert enc["attn"]["wq"].dtype == torch.bfloat16
        assert conv["encoder"]["final_norm"]["w"].dtype == torch.float32


def test_init_cache_cross_leaves_match_jax():
    """whisper's `"cross"` KVCache of frontend_tokens rows beside `"kv"`,
    the JAX package's shapes, types and fill; `cache_from_numpy` maps it to
    the port's KVCache."""
    cfg = _cfg(WHISPER)
    jc = JM.init_cache(cfg, 2, 24, dtype=jnp.float32)
    tc = TM.init_cache(cfg, 2, 24, dtype=torch.float32, device="cpu")
    assert set(tc[0]) == set(jc[0]) == {"kv", "cross"}
    for a, b in zip(jc[0]["cross"], tc[0]["cross"]):
        assert tuple(b.shape) == a.shape
        assert np.array_equal(np.asarray(a), b.numpy())
    assert tc[0]["cross"].k.shape[2] == cfg.frontend_tokens
    conv = cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    assert isinstance(conv[0]["cross"], KVCache)
    assert "cross" not in TM.init_cache(_cfg(PIXTRAL), 1, 8,
                                        device="cpu")[0]


# ---------------------------------------------------------------------------
# the forwards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_with_frontend_matches_jax(models, arch, fmt):
    """Every row's logits with a frontend: whisper's decoder over 7 tokens
    cross-attending to the encoded frames, pixtral's over 16 patch rows +
    7 tokens (23 rows)."""
    cfg, jp, tp = models[arch]
    toks, fe = _tokens(cfg, 2, 7, 0), _frontend(cfg)
    with use_policy(PrecisionPolicy(input_format=fmt)):
        jl, _, _ = JM.forward(jp, cfg, jnp.asarray(toks),
                              frontend_embeds=jnp.asarray(fe))
    with TP.use_policy(TP.PrecisionPolicy(input_format=fmt)):
        tl, _, _ = TM.forward(tp, cfg, torch.from_numpy(toks),
                              frontend_embeds=torch.from_numpy(fe))
    rows = 7 + (cfg.frontend_tokens if arch == PIXTRAL else 0)
    assert tl.shape == (2, rows, cfg.padded_vocab)
    _check_logits(jl, tl, cfg.vocab_size)


def test_frontend_is_live(models):
    """A changed frame moves whisper's logits (the cross path is live);
    without a frontend the decoder skips cross-attention, as in the JAX
    package."""
    cfg, jp, tp = models[WHISPER]
    toks, fe = torch.from_numpy(_tokens(cfg, 2, 5, 1)), _frontend(cfg)
    fe2 = fe.copy()
    fe2[:, 3] += 1.0
    with TP.use_policy(FP32_T):
        a, _, _ = TM.forward(tp, cfg, toks,
                             frontend_embeds=torch.from_numpy(fe))
        b, _, _ = TM.forward(tp, cfg, toks,
                             frontend_embeds=torch.from_numpy(fe2))
        c, _, _ = TM.forward(tp, cfg, toks)
    with use_policy(FP32_J):
        jc, _, _ = JM.forward(jp, cfg, jnp.asarray(toks.numpy()))
    v = cfg.vocab_size
    assert float((a - b)[..., :v].abs().max()) > 1e-3
    _check_logits(jc, c, v)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_full_forward(models, arch):
    """tests/test_decode.py's contract with a frontend: a prefill of 10
    tokens then 3 decode steps give each position's logits as the full
    forward over all 13 does. whisper passes its frames to every step
    (re-encoded); pixtral prefills [patches ‖ 10 tokens] and decodes from
    position 16 + 10 with no frontend (F8's repair)."""
    cfg, _, tp = models[arch]
    toks = torch.from_numpy(_tokens(cfg, 2, 13, 4))
    fe = torch.from_numpy(_frontend(cfg))
    vlm = arch == PIXTRAL
    off = cfg.frontend_tokens if vlm else 0
    with TP.use_policy(FP32_T):
        full, _, _ = TM.forward(tp, cfg, toks, frontend_embeds=fe)
        cache = TM.init_cache(cfg, 2, 32 + off, dtype=torch.float32,
                              device="cpu")
        pre, cache, _ = TM.forward(tp, cfg, toks[:, :10], cache=cache,
                                   frontend_embeds=fe, last_only=True)
        steps = [pre]
        for t in range(10, 13):
            lg, cache, _ = TM.forward(tp, cfg, toks[:, t:t + 1],
                                      cache=cache, pos=off + t,
                                      frontend_embeds=None if vlm else fe)
            steps.append(lg)
    got = torch.cat(steps, dim=1)[..., :cfg.vocab_size]
    want = full[:, off + 9:, :cfg.vocab_size]
    assert float((got - want).abs().max()) <= 1e-4 * max(
        1.0, float(want.abs().max()))


def test_gemm_calls():
    """A forward with a frontend: whisper-tiny 73 SA GEMMs (a decoder layer
    12, an encoder layer 6, the lm_head), pixtral-12b 281 (40 × 7 + 1);
    on the CPU a decode step's plain calls are that count."""
    assert TM.gemm_calls(get_config(WHISPER)) == 73
    assert TM.gemm_calls(get_config(PIXTRAL)) == 281
    for arch in ARCHS:
        cfg = _cfg(arch)
        tp = TM.init_params(cfg, seed=0, device="cpu")
        eng = ServeEngine(cfg, tp, batch=2, cache_len=48, page_size=8)
        fe = torch.from_numpy(_frontend(cfg))
        ops.reset_counts()
        with TP.use_policy(FP32_T):
            eng._serve_step(tp, torch.zeros((2, 1), dtype=torch.int32),
                            eng.new_cache(),
                            torch.zeros((2,), dtype=torch.int32), fe)
        assert ops.counts()["sa_matmul"]["plain_calls"] == TM.gemm_calls(cfg)


# ---------------------------------------------------------------------------
# the engine and the driver
# ---------------------------------------------------------------------------

def test_whisper_generate_matches_jax_engine(models):
    """The encoder-decoder's `generate()` (frames re-encoded at every
    step) equals the JAX engine's."""
    cfg, jp, tp = models[WHISPER]
    toks, fe = _tokens(cfg, 2, 12, 1), _frontend(cfg, seed=2)
    with use_policy(FP32_J):
        jeng = JEngine(cfg, jp, batch=2, cache_len=32, eos_id=-1,
                       sync_every=3)
        want = np.asarray(jeng.generate(jnp.asarray(toks), 7,
                                        frontend=jnp.asarray(fe)))
    with TP.use_policy(FP32_T):
        eng = ServeEngine(cfg, tp, batch=2, cache_len=32, eos_id=-1,
                          sync_every=3)
        got = eng.generate(torch.from_numpy(toks), 7,
                           frontend=torch.from_numpy(fe))
    assert got.numpy().tolist() == want.tolist()
    assert eng.last_stats["nonfinite_logits"] == 0


def _jax_greedy(cfg, jp, toks, fe, n):
    """Greedy decoding by full JAX forwards over [patches ‖ prompt ‖
    generated]."""
    seq = jnp.asarray(toks)
    out = []
    for _ in range(n):
        logits, _, _ = JM.forward(jp, cfg, seq,
                                  frontend_embeds=jnp.asarray(fe))
        nxt = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
        out.append(np.asarray(nxt))
        seq = jnp.concatenate([seq, nxt[:, None]], axis=1)
    return np.stack(out, axis=1)


@pytest.mark.parametrize("seed", [1, 3])
def test_pixtral_generate_is_greedy_decoding_of_the_forward(models, seed):
    """F8: the port's VLM `generate()` (B = 2, T = 12, 6 new tokens, the
    fp32 policy) equals greedy decoding by the JAX package's full forward,
    and not the JAX engine's own `generate()` stream, which re-prefills
    the patches with each token and never sees the prompt."""
    cfg, jp, tp = models[PIXTRAL]
    toks, fe = _tokens(cfg, 2, 12, seed), _frontend(cfg, seed=seed + 10)
    with use_policy(FP32_J):
        want = _jax_greedy(cfg, jp, toks, fe, 6)
        jeng = JEngine(cfg, jp, batch=2, cache_len=64, eos_id=-1,
                       sync_every=4)
        jgen = np.asarray(jeng.generate(jnp.asarray(toks), 6,
                                        frontend=jnp.asarray(fe)))
    with TP.use_policy(FP32_T):
        eng = ServeEngine(cfg, tp, batch=2, cache_len=16, eos_id=-1,
                          sync_every=4)
        got = eng.generate(torch.from_numpy(toks), 6,
                           frontend=torch.from_numpy(fe))
    assert got.numpy().tolist() == want.tolist()
    assert jgen.tolist() != want.tolist()
    assert eng.last_stats["nonfinite_logits"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_refuses_frontend_archs(models, arch):
    """Continuous serving is text-only in both engines: `serve()` raises
    for a frontend arch instead of skipping its frontend."""
    cfg, jp, tp = models[arch]
    for eng_cls, sched_cls, params in ((JEngine, JSched, jp),
                                       (ServeEngine, SlotScheduler, tp)):
        eng = eng_cls(cfg, params, batch=2, cache_len=32)
        sched = sched_cls(2)
        sched.submit([1, 2, 3], max_new_tokens=2)
        with pytest.raises(ValueError, match="text-only"):
            eng.serve(sched)


@pytest.mark.parametrize("arch", ARCHS)
def test_driver_serves_static_waves_on_the_cpu(arch, capsys):
    """The driver takes the static waves for a frontend arch: 5 requests
    in waves of 2 (the last wave ragged), every request's tokens counted,
    finite logits, every kernel call on the CPU a plain one; the same
    seed gives the same waves."""
    from repro_torch.launch import serve as drv

    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--requests", "5", "--max-new", "4", "--prompt-lens", "6,9",
            "--rate", "0"]
    ops.reset_counts()
    summary, outs, engine = drv.main(argv, return_state=True)
    assert {k: summary[k] for k in ("requests", "generated_tokens", "waves",
                                    "nonfinite_logits")} == {
        "requests": 5, "generated_tokens": 20, "waves": 3,
        "nonfinite_logits": 0}
    assert summary["decode_s"] > 0 and summary["decode_tok_s"] > 0
    assert [o.shape for o in outs] == [(2, 4)] * 3
    assert all(c["launches"] == 0 for c in ops.counts().values())
    assert "[static] requests=5" in capsys.readouterr().out
    again = drv.main(argv, return_state=True)[1]
    assert all(np.array_equal(a, b) for a, b in zip(outs, again))


# ---------------------------------------------------------------------------
# training: the loss and its gradients
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


@pytest.fixture(scope="module")
def frontend_grads():
    """Per arch: (cfg, numpy params, batch with a frontend, (loss, nll,
    gradient leaves)) of the JAX package's value_and_grad(lm_loss) (remat
    on, two decoder layers, T = 12)."""
    out = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(_cfg(arch), remat=True, num_layers=2)
        jp = JM.init_params(jax.random.key(3), cfg)
        batch = JSynthetic(cfg.vocab_size, 12, 4, seed=1).batch_at(0)
        batch["frontend"] = _frontend(cfg, B=4, seed=5)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        with use_policy(PrecisionPolicy(backend="xla")):
            (loss, nll), g = jax.jit(jax.value_and_grad(
                lambda p, b: JM.lm_loss(p, cfg, b["tokens"], b["labels"],
                                        frontend_embeds=b["frontend"]),
                has_aux=True))(jp, jb)
        out[arch] = (cfg, jax.tree.map(np.asarray, jp), batch, (
            float(loss), float(nll), _paths(jax.tree.map(np.asarray, g))))
    return out


@pytest.mark.parametrize("port_backend", ["torch", "cuda"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_jax(frontend_grads, arch, port_backend):
    """Loss, nll and every gradient leaf (whisper's encoder and cross
    weights and layernorm biases included; pixtral's loss over the text
    rows only) against jax.value_and_grad(lm_loss) with a frontend; the
    port's `cuda` backend runs SAMatmulFn's plain version on the CPU."""
    cfg, np_params, batch, (j_loss, j_nll, jg) = frontend_grads[arch]
    params = params_from_numpy(np_params, "cpu", dtype=torch.float32)
    for p in TM.tree_leaves(params):
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ops.reset_counts()
    with TP.use_policy(TP.PrecisionPolicy(backend=port_backend)):
        t_loss, t_nll, grads = make_grad_fn(cfg)(params, tb)
    bwd = ops.counts()["sa_matmul_bwd"]["plain_calls"]
    assert (bwd > 0) == (port_backend == "cuda")
    for want, got in ((j_loss, t_loss), (j_nll, t_nll)):
        assert abs(float(got) - want) <= REL_LOSS * abs(want)
    tg = _paths(grads)
    assert set(jg) == set(tg)
    rel = {p: float(np.linalg.norm(tg[p] - jg[p])
                    / (np.linalg.norm(jg[p]) + 1e-30)) for p in jg}
    assert max(rel.values()) <= REL_GRAD, sorted(
        rel.items(), key=lambda kv: -kv[1])[:3]
    if arch == WHISPER:
        assert np.abs(tg[("encoder", "layers", "attn", "wq")]).max() > 0
        assert np.abs(tg[("layers", 0, "cross", "wk")]).max() > 0


def test_accumulated_grads_split_the_frontend(frontend_grads):
    """With accum_steps = 2 the frontend rows go with their tokens'
    microbatch: the averaged loss of the two halves equals the full
    batch's (each half's mean nll over the same number of rows)."""
    cfg, np_params, batch, (j_loss, _, _) = frontend_grads[PIXTRAL]
    params = params_from_numpy(np_params, "cpu", dtype=torch.float32)
    for p in TM.tree_leaves(params):
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _, _ = make_grad_fn(cfg, accum_steps=2)(params, tb)
    assert abs(float(loss) - j_loss) <= REL_LOSS * abs(j_loss)
