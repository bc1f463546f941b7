"""PyTorch port: prompt-length bucketing against the JAX package.

Bucketed serving pads each prefill suffix to `_bucket_len(suffix)` and
must give the unbucketed streams with fewer prefill shapes
(`prefill_compiles`); the port's bucketed streams must equal the JAX
engine's. Reduced qwen2.5-14b under `PrecisionPolicy(input_format="fp32")`,
the JAX weights carried over by `params_from_numpy`.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduced_config  # noqa: E402
from repro.core import PrecisionPolicy, use_policy  # noqa: E402
from repro.launch import serve as jdrv  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro.serve.scheduler import SlotScheduler as JSched  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro_torch.core import optflags  # noqa: E402
from repro_torch.core import precision as TP  # noqa: E402
from repro_torch.launch import serve as drv  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.serve.scheduler import SlotScheduler  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402

torch.set_num_threads(2)
FP32_J = PrecisionPolicy(input_format="fp32")
FP32_T = TP.PrecisionPolicy(input_format="fp32")
PAGE = 8


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(reduced_config("qwen2.5-14b"), remat=False)
    with use_policy(FP32_J):
        jp = JM.init_params(jax.random.key(0), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jp, tp


def _serve(engine_cls, sched_cls, pol_ctx, cfg, params, prompts, budgets,
           **kw):
    with pol_ctx:
        eng = engine_cls(cfg, params, batch=2, cache_len=64, eos_id=-1,
                         sync_every=2, page_size=PAGE, **kw)
        sched = sched_cls(2, eos_id=-1)
        for p, n in zip(prompts, budgets):
            sched.submit(p, max_new_tokens=n)
        summary = eng.serve(sched)
    return {r.rid: r.tokens for r in sched.finished}, summary


def _port(cfg, tp, prompts, budgets, **kw):
    return _serve(TE.ServeEngine, SlotScheduler, TP.use_policy(FP32_T), cfg,
                  tp, prompts, budgets, **kw)


def _jax(cfg, jp, prompts, budgets, **kw):
    return _serve(JE.ServeEngine, JSched, use_policy(FP32_J), cfg, jp,
                  prompts, budgets, **kw)


def test_bucket_len_sequence():
    """8, 12, 16, 24, 32, 48, 64, ...: the smallest bucket >= n, the JAX
    engine's function at every length."""
    seq, b = [], 0
    for n in range(1, 200):
        if TE._bucket_len(n) != b:
            b = TE._bucket_len(n)
            seq.append(b)
    assert seq == [8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256]
    assert all(TE._bucket_len(n) == JE._bucket_len(n)
               for n in range(1, 1100))
    assert [TE._bucket_len(n) for n in (17, 20, 23, 40, 47)] == \
        [24, 24, 24, 48, 48]


def _mixed(cfg, seed=3, lens=(5, 9, 7, 13)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]


@pytest.mark.parametrize("kv_layout", ["paged", "ring"])
def test_bucketed_streams_equal_plain_with_fewer_prefill_shapes(
        setup, kv_layout):
    """Lengths 5, 9, 7, 13 prefill as 4 shapes plain and 3 bucketed (8,
    12, 16); the bucketed streams equal the plain ones and the JAX
    engine's bucketed streams, whose shape count is the same."""
    cfg, jp, tp = setup
    prompts, budgets = _mixed(cfg), (4, 3, 5, 2)
    plain, ps = _port(cfg, tp, prompts, budgets, kv_layout=kv_layout)
    got, gs = _port(cfg, tp, prompts, budgets, kv_layout=kv_layout,
                    bucket_prompts=True)
    want, ws = _jax(cfg, jp, prompts, budgets, kv_layout=kv_layout,
                    bucket_prompts=True)
    assert got == plain == want
    assert ps["prefill_compiles"] == 4
    assert gs["prefill_compiles"] == ws["prefill_compiles"] == 3
    if kv_layout == "paged":
        assert gs["pages_leaked"] == 0


def test_bucketed_prefix_cache_hit(setup):
    """A shared 16-token system prompt: later admissions load the cached
    pages and prefill only their bucketed suffix (continued prefill at
    prefix 16); tokens equal the unbucketed run and the JAX engine's."""
    cfg, jp, tp = setup
    rng = np.random.default_rng(7)
    system = rng.integers(0, cfg.vocab_size, 16).tolist()
    prompts = [system + rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (3, 5, 4)]
    plain, _ = _port(cfg, tp, prompts, (4, 4, 4))
    got, gs = _port(cfg, tp, prompts, (4, 4, 4), bucket_prompts=True)
    want, ws = _jax(cfg, jp, prompts, (4, 4, 4), bucket_prompts=True)
    assert got == plain == want
    assert gs["prefix_hits"] >= 1 and gs["pages_leaked"] == 0
    assert gs["prefill_compiles"] == ws["prefill_compiles"]


def test_bucketed_fragment_rounds_past_its_pages(setup):
    """A 33-token prompt with a 2-token budget holds ceil(35 / 8) = 5
    pages, but its bucket (48) fills a 6-page fragment: the sixth page
    holds only padding and scatters to the trash page. Tokens equal the
    unbucketed run's and the JAX engine's, and no page leaks."""
    cfg, jp, tp = setup
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (33, 6)]
    assert TE._bucket_len(33) // PAGE > -(-(33 + 2) // PAGE)
    plain, _ = _port(cfg, tp, prompts, (2, 3))
    got, gs = _port(cfg, tp, prompts, (2, 3), bucket_prompts=True)
    want, _ = _jax(cfg, jp, prompts, (2, 3), bucket_prompts=True)
    assert got == plain == want
    assert gs["pages_leaked"] == 0


def test_padding_pages_go_to_the_trash_page(setup):
    """`_scatter_impl` with a fragment one page longer than the block
    row's run: the real pages get the fragment's rows, the padding page's
    rows land on page 0, and no other page changes."""
    cfg, _, tp = setup
    eng = TE.ServeEngine(cfg, tp, batch=2, cache_len=32, page_size=PAGE)
    pool = eng.new_pool()
    frag = eng.new_frag(3 * PAGE)
    for c in frag:
        kv = c["kv"]
        kv.k.copy_(torch.randn(kv.k.shape))
        kv.positions.copy_(torch.arange(3 * PAGE, dtype=torch.int32))
        kv.positions[..., 2 * PAGE:] = -1          # the padding page
    row = torch.tensor([3, 5, -1, -1], dtype=torch.int32)
    before = TM.tree_map(torch.clone, pool)
    TE.ServeEngine._scatter_impl(pool, frag, row)
    for c, old, one in zip(pool, before, frag):
        kv, okv, fkv = c["kv"], old["kv"], one["kv"]
        assert torch.equal(kv.k[:, 3], fkv.k[:, 0, :PAGE])
        assert torch.equal(kv.k[:, 5], fkv.k[:, 0, PAGE:2 * PAGE])
        assert torch.equal(kv.k[:, 0], fkv.k[:, 0, 2 * PAGE:])
        assert (kv.positions[:, 0] == -1).all()
        untouched = [p for p in range(kv.k.shape[1]) if p not in (0, 3, 5)]
        assert torch.equal(kv.k[:, untouched], okv.k[:, untouched])


def test_bucketed_prefill_step_matches_jax(setup):
    """`make_bucketed_prefill_step` against the reference's on a 7-token
    prompt padded to 12: the real last row's logits within the forward
    bound, and the fragment's positions equal (the padded rows -1)."""
    cfg, jp, tp = setup
    rng = np.random.default_rng(5)
    toks = np.zeros((1, 12), np.int32)
    toks[0, :7] = rng.integers(0, cfg.vocab_size, 7)
    with use_policy(FP32_J):
        jl, jc = JS.make_bucketed_prefill_step(cfg)(
            jp, jnp.asarray(toks), JM.init_cache(cfg, 1, 16,
                                                 dtype=jnp.float32),
            jnp.asarray(6, jnp.int32), jnp.asarray(7, jnp.int32))
        jx, _, _ = JM.forward(jp, cfg, jnp.asarray(toks[:, :7]),
                              last_only=True,
                              cache=JM.init_cache(cfg, 1, 16,
                                                  dtype=jnp.float32))
    with TP.use_policy(FP32_T):
        tl, tc = TS.make_bucketed_prefill_step(cfg)(
            tp, torch.from_numpy(toks),
            TM.init_cache(cfg, 1, 16, dtype=torch.float32, device="cpu"),
            6, 7)
        tx, _, _ = TM.forward(tp, cfg, torch.from_numpy(toks[:, :7]),
                              last_only=True,
                              cache=TM.init_cache(cfg, 1, 16,
                                                  dtype=torch.float32,
                                                  device="cpu"))
    V = cfg.vocab_size
    r, g = np.asarray(jl)[..., :V], tl[..., :V].numpy()
    assert np.abs(r - g).max() <= 2.0 ** -5 * np.abs(r).max()
    # the real rows come out of the exact-length prefill's arithmetic
    assert torch.equal(tl, tx)
    assert np.array_equal(np.asarray(jl), np.asarray(jx))
    for j in range(cfg.stack_period):
        want = np.asarray(jc[j]["kv"].positions)
        assert np.array_equal(want, tc[j]["kv"].positions.numpy())
        assert (want[..., 7:] == -1).all() and (want[..., :7] >= 0).all()


def test_bucketing_from_env(setup, monkeypatch):
    cfg, _, tp = setup
    eng = TE.ServeEngine(cfg, tp, batch=2, cache_len=32)
    assert not eng.bucketing_on()
    monkeypatch.setenv("REPRO_PREFILL_BUCKET", "1")
    assert optflags.prefill_bucket_enabled() and eng.bucketing_on()
    assert not TE.ServeEngine(cfg, tp, batch=2, cache_len=32,
                              bucket_prompts=False).bucketing_on()


def test_bucket_capped_at_the_request_limit(setup):
    """A 33-token prompt whose bucket (48) would pass the 40-token
    request cap (`max_seq_len`) prefills at its own length, still through
    the bucketed step, as in the JAX engine."""
    cfg, jp, tp = setup
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, cfg.vocab_size, 33).tolist()]
    got, gs = _serve(TE.ServeEngine, SlotScheduler, TP.use_policy(FP32_T),
                     cfg, tp, prompts, (3,), max_seq_len=40,
                     bucket_prompts=True)
    plain, _ = _serve(TE.ServeEngine, SlotScheduler, TP.use_policy(FP32_T),
                      cfg, tp, prompts, (3,), max_seq_len=40)
    want, _ = _serve(JE.ServeEngine, JSched, use_policy(FP32_J), cfg, jp,
                     prompts, (3,), max_seq_len=40, bucket_prompts=True)
    assert got == plain == want
    assert gs["prefill_compiles"] == 1 and gs["pages_leaked"] == 0


DRV = ["--arch", "qwen2.5-14b", "--reduced", "--batch", "2", "--requests",
       "5", "--max-new", "4", "--prompt-lens", "5,9,7,13,17", "--rate", "0",
       "--seed", "1"]


def test_driver_bucket_prompts_matches_plain_and_jax_driver():
    """`--bucket-prompts`: the plain run's digest and the JAX driver's,
    with 4 prefill shapes (8, 12, 16, 24) against 5."""
    with use_policy(FP32_J):
        want = jdrv.main(DRV + ["--bucket-prompts"])
        jp = JM.init_params(jax.random.key(1), reduced_config("qwen2.5-14b"))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    with TP.use_policy(FP32_T):
        got = drv.main(DRV + ["--device", "cpu", "--bucket-prompts"],
                       params=tp)
        plain = drv.main(DRV + ["--device", "cpu"], params=tp)
    assert got["stream_digest"] == plain["stream_digest"]
    assert got["stream_digest"] == want["stream_digest"]
    assert got["prefill_compiles"] == want["prefill_compiles"] == 4
    assert plain["prefill_compiles"] == 5
