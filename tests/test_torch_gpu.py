"""PyTorch port on the card: each hand-written kernel against its plain
version at the main path's shapes (the SA GEMM's backward, `SAMatmulFn`,
against plain autograd too), the wrappers' refusals, and short
full-width serves under the `cuda` and `emulate` GEMM backends. Marked `gpu`; each test skips inside itself where no
CUDA device is present. Needs no JAX, so it runs on the card's machine:

    python -m pytest -m gpu tests/test_torch_*.py

Tolerances are the kernel modules' `error_bound` (see their docstrings):
fp32 reassociation (R1), one truncation quantum in approx mode, and for
attention the rounding of the probabilities to the input format, per
output from the plain version's own terms; a planted off-by-one mask lands
outside it. The fp_emu and quantize kernels are held to their plain
versions bit for bit (NaN payloads aside).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.precision import PrecisionPolicy  # noqa: E402
from repro_torch.kernels import fp_emu as FE  # noqa: E402
from repro_torch.kernels import gemm_cases as GC  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quantize as QZ  # noqa: E402
from repro_torch.kernels import sa_attention as FA  # noqa: E402
from repro_torch.kernels import sa_decode_attention as DA  # noqa: E402
from repro_torch.kernels import sa_matmul as MM  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """The test needs a card; decided here, never at import time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("m", [4, 128])
@pytest.mark.parametrize("k,n,act,mode", [
    (5120, 1024, "none", "exact"), (5120, 13824, "silu", "approx"),
    (13824, 5120, "none", "exact"), (1000, 999, "gelu", "approx")])
def test_sa_matmul_matches_plain(cuda, m, k, n, act, mode):
    g = torch.Generator(device=cuda).manual_seed(m + n)
    a = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn((k, n), generator=g, device=cuda) * k ** -0.5).to(
        torch.bfloat16)
    bias = torch.randn((n,), generator=g, device=cuda)
    got = ops.sa_matmul(a, w, bias=bias, act=act, mode=mode)
    ref = MM.sa_matmul_ref(a, w, bias, act=act, mode=mode)
    bound = MM.error_bound(a, w, mode=mode, y=ref)
    assert bool(((got - ref).abs() <= bound).all())


def _pool(dev, B=4, KVH=8, grp=5, hd=128, psz=16, P=9, lens=(144, 100, 40,
                                                                0)):
    """Slot b owns ceil(lens[b] / psz) pages; the trash page is poisoned
    with NaN and slot 0 carries an explicit page-0 entry."""
    g = torch.Generator(device=dev).manual_seed(7)
    n_pages = B * P + 1
    q = torch.randn((B, 1, KVH * grp, hd), generator=g, device=dev)
    k = torch.randn((n_pages, psz, KVH, hd), generator=g, device=dev)
    v = torch.randn((n_pages, psz, KVH, hd), generator=g, device=dev)
    k[0] = v[0] = float("nan")
    pp = torch.full((n_pages, psz), -1, dtype=torch.int32, device=dev)
    bt = torch.full((B, P), -1, dtype=torch.int32, device=dev)
    nxt = 1
    for b, n in enumerate(lens):
        for j in range(-(-n // psz)):
            bt[b, j] = nxt
            pp[nxt] = torch.arange(j * psz, (j + 1) * psz, device=dev)
            nxt += 1
    bt[0, 1] = 0
    pos = torch.tensor([max(n - 1, 0) for n in lens], dtype=torch.int32,
                       device=dev)
    return q, k, v, pp, bt, pos


SERVE_LENS = (144, 100, 40, 0)


F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16


@pytest.mark.parametrize("fmt,mode,window,cap,lens,n_split,pool", [
    ("bf16", "exact", 0, 0.0, SERVE_LENS, None, F32),
    ("bf16", "approx", 64, 50.0, SERVE_LENS, None, F32),
    ("fp32", "exact", 0, 0.0, SERVE_LENS, None, F32),
    ("fp16", "exact", 0, 0.0, SERVE_LENS, None, F32),
    # forced cluster sizes: 3 blocks of 64 keys at 144 tokens, and 16
    # blocks of 128 at 2048 (the non-portable cluster size)
    ("bf16", "exact", 0, 0.0, SERVE_LENS, 6, F32),
    ("fp32", "approx", 0, 0.0, SERVE_LENS, 3, F32),
    ("bf16", "exact", 0, 0.0, (2048, 1000, 17, 0), 16, F32),
    ("bf16", "exact", 0, 0.0, (2048, 1000, 17, 0), None, F32),
    # a slot whose scores exceed one block's shared memory
    ("bf16", "exact", 100, 0.0, (12288, 2049, 0, 5), None, F32),
    # 16-bit pools (`ServeEngine(cache_dtype=)`), each policy
    ("bf16", "exact", 0, 0.0, SERVE_LENS, None, BF16),
    ("bf16", "approx", 64, 50.0, SERVE_LENS, 6, BF16),
    ("bf16", "exact", 0, 0.0, SERVE_LENS, None, F16),
    ("fp16", "exact", 0, 0.0, SERVE_LENS, None, F16),
    ("fp16", "exact", 0, 0.0, SERVE_LENS, 16, BF16),
    ("fp32", "exact", 0, 0.0, SERVE_LENS, None, BF16),
    ("bf16", "exact", 0, 0.0, (2048, 1000, 17, 0), None, BF16),
])
def test_paged_decode_matches_plain(cuda, fmt, mode, window, cap, lens,
                                    n_split, pool):
    """Within the bound of the plain version (the trash page is NaN and
    never read, the empty slot gives zeros), bit-identical across calls,
    and the bound rejects a decode that masks out the token just
    written. A 16-bit pool holds the fp32 pool's values rounded once; where
    the policy casts in to that same type, the output is the fp32 pool's
    bit for bit."""
    q, k, v, pp, bt, pos = _pool(cuda, P=-(-max(lens) // 16), lens=lens)
    pol = PrecisionPolicy(input_format=fmt, mode=mode)
    k32, v32 = k, v
    k, v = k.to(pool), v.to(pool)
    if n_split is None:
        def run():
            return ops.paged_decode_attention(q, k, v, pp, bt, pos,
                                              window=window, cap=cap,
                                              policy=pol)
    else:
        def run():
            return DA.paged_decode_cuda(q, k, v, pp, bt, pos, window=window,
                                        cap=cap, policy=pol, n_split=n_split)
    got = run()
    assert torch.equal(got.view(torch.int32), run().view(torch.int32))
    ref = DA.paged_decode_ref(q, k, v, pp, bt, pos, window=window, cap=cap,
                              policy=pol)
    bound = DA.error_bound(q, k, v, pp, bt, pos, window=window, cap=cap,
                           policy=pol)
    assert bool(torch.isfinite(got).all())
    assert bool((got[lens.index(0)] == 0).all())   # the all-masked slot
    assert bool(((got - ref).abs() <= bound).all())
    # the same bound rejects a decode that masks out the token just written
    bad = DA.paged_decode_ref(q, k, v, pp, bt, pos - 1, window=window,
                              cap=cap, policy=pol)
    assert float(((got - bad).abs() / bound).max()) > 1.0
    if pool != F32 and fmt == {BF16: "bf16", F16: "fp16"}[pool]:
        if n_split is None:
            y32 = ops.paged_decode_attention(q, k32, v32, pp, bt, pos,
                                             window=window, cap=cap,
                                             policy=pol)
        else:
            y32 = DA.paged_decode_cuda(q, k32, v32, pp, bt, pos,
                                       window=window, cap=cap, policy=pol,
                                       n_split=n_split)
        assert torch.equal(got.view(torch.int32), y32.view(torch.int32))


@pytest.mark.parametrize("T,S,kw,fmt,kv", [
    (32, 32, {}, "bf16", F32), (64, 64, {}, "bf16", F32),
    (128, 128, {}, "bf16", F32),
    (100, 100, {"window": 33}, "bf16", F32),
    (64, 128, {"q_offset": 64, "window": 48, "cap": 50.0}, "bf16", F32),
    (1, 1, {}, "bf16", F32), (17, 17, {}, "bf16", F32),
    (200, 200, {}, "bf16", F32),
    (128, 128, {}, "fp16", F32), (17, 17, {"cap": 30.0}, "fp16", F32),
    (128, 128, {}, "fp32", F32), (200, 200, {"window": 33}, "fp32", F32),
    (32, 96, {"q_offset": 64}, "bf16", F32),
    (32, 96, {"q_offset": 64}, "fp32", F32),
    # 16-bit K/V: read without an fp32 copy on the mma route
    (128, 128, {}, "bf16", BF16), (200, 200, {"window": 33}, "bf16", BF16),
    (64, 128, {"q_offset": 64, "window": 48, "cap": 50.0}, "bf16", BF16),
    (17, 17, {}, "fp16", F16), (128, 128, {}, "fp16", BF16),
    (128, 128, {}, "bf16", F16), (100, 100, {}, "fp32", BF16)])
@pytest.mark.parametrize("q_view", [False, True])
def test_prefill_matches_plain(cuda, T, S, kw, fmt, kv, q_view):
    """Within the bound of the plain version, through the route the policy
    picks (`mma` for bf16 and fp16, `simt` for fp32), q either contiguous
    or the (B, H, T, hd) → (B, T, H, hd) view `attention_block` hands over;
    out is written contiguous, and the bound rejects a causal mask one key
    too wide."""
    g = torch.Generator(device=cuda).manual_seed(T + S)
    if q_view:
        q = torch.randn((1, 40, T, 128), generator=g,
                        device=cuda).transpose(1, 2)
    else:
        q = torch.randn((1, T, 40, 128), generator=g, device=cuda)
    k32 = torch.randn((1, S, 8, 128), generator=g, device=cuda)
    v32 = torch.randn((1, S, 8, 128), generator=g, device=cuda)
    k, v = k32.to(kv), v32.to(kv)
    pol = PrecisionPolicy(input_format=fmt)
    ops.reset_counts()
    got = ops.sa_attention(q, k, v, policy=pol, **kw)
    route = "simt" if fmt == "fp32" else "mma"
    assert ops.route_counts()["prefill_attention"] == {
        "mma": 0, "simt": 0, route: 1}
    assert got.is_contiguous() and got.shape == q.shape
    ref = FA.flash_attention_ref(q, k, v, policy=pol, **kw)
    bound = FA.error_bound(q, k, v, policy=pol, **kw)
    assert bool(((got - ref).abs() <= bound).all())
    wider = kw.get("q_offset", 0) + 1
    if wider < S:       # a key exists that the wider mask lets in
        bad = FA.flash_attention_ref(q, k, v, policy=pol,
                                     **{**kw, "q_offset": wider})
        assert float(((got - bad).abs() / bound).max()) > 1.0
    if kv != F32 and fmt == {BF16: "bf16", F16: "fp16"}[kv]:
        # the 16-bit values are the fp32 ones cast in: the same bits out
        y32 = ops.sa_attention(q, k32, v32, policy=pol, **kw)
        assert torch.equal(got.view(torch.int32), y32.view(torch.int32))


def test_wrappers_raise_instead_of_falling_back(cuda):
    a = torch.zeros((4, 64), dtype=torch.float16, device=cuda)
    w = torch.zeros((64, 32), dtype=torch.float16, device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        ops.sa_matmul(a, w)                     # fp16 operands
    q, k, v, pp, bt, pos = _pool(cuda)
    with pytest.raises(ValueError, match="unsupported"):   # mixed pools
        ops.paged_decode_attention(q, k.to(torch.bfloat16), v, pp, bt, pos)
    x = torch.zeros((1, 8, 4, 16), device=cuda)
    with pytest.raises(ValueError, match="unsupported"):
        ops.sa_attention(x, x, x)               # hd 16 < one warp


def test_decode_layer_raises_for_a_policy_the_kernel_lacks(cuda):
    """On the card the layer's default fused decode launches the kernel or
    raises: an FP8 policy does not quietly take the gather path."""
    from repro_torch.configs import reduced_config
    from repro_torch.core.precision import use_policy
    from repro_torch.models import model as M

    cfg = reduced_config("qwen2.5-14b")
    params = M.init_params(cfg, seed=0, device=cuda)
    cache = M.init_cache(cfg, 2, 8, dtype=torch.float32, device=cuda,
                         paged=(5, 4))
    for c in cache:
        c["kv"].block_table[:, :, 0] = torch.tensor([1, 2], device=cuda)
    tok = torch.zeros((2, 1), dtype=torch.int32, device=cuda)
    with use_policy(PrecisionPolicy(input_format="fp8_e4m3")):
        with pytest.raises(ValueError, match="does not support"):
            M.forward(params, cfg, tok, cache=cache, pos=0)


def test_sa_dot_cuda_backend_folds_batched_a(cuda):
    """Under the cuda backend a batched `a` runs the kernel on its rows."""
    from repro_torch.core.precision import sa_dot

    g = torch.Generator(device=cuda).manual_seed(3)
    a = torch.randn((2, 3, 256), generator=g, device=cuda)
    w = (torch.randn((256, 96), generator=g, device=cuda) / 16).to(
        torch.bfloat16)
    ops.reset_counts()
    got = sa_dot(a, w, PrecisionPolicy(backend="cuda"))
    assert ops.counts()["sa_matmul"] == {"launches": 1, "plain_calls": 0}
    ref = sa_dot(a, w, PrecisionPolicy(backend="torch"))
    assert got.shape == (2, 3, 96)
    bound = MM.error_bound(a.reshape(6, 256).to(torch.bfloat16), w,
                           y=ref.reshape(6, 96)).reshape(2, 3, 96)
    assert bool(((got - ref).abs() <= bound).all())


def _two_layer_engine(cuda, **kw):
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine

    cfg = dataclasses.replace(get_config("qwen2.5-14b"), num_layers=2)
    params = M.init_params(cfg, seed=0, device=cuda)
    return ServeEngine(cfg, params, batch=2, cache_len=48, eos_id=-1,
                       sync_every=4, **kw)


def _submit(sched, cfg, lens, tiers, max_new=6):
    g = torch.Generator().manual_seed(0)
    for n, tier in zip(lens, tiers):
        sched.submit(torch.randint(0, cfg.vocab_size, (n,),
                                   generator=g).tolist(),
                     max_new_tokens=max_new, tier=tier)


def test_serve_full_width_two_layers(cuda, monkeypatch):
    """qwen2.5-14b at full width, cut to two layers: a short stream through
    the engine on the cuda GEMM backend completes, leaks no page, and runs
    every kernel of the path and no plain version."""
    from repro_torch.serve.scheduler import SlotScheduler

    monkeypatch.setenv("REPRO_GEMM_BACKEND", "cuda")
    eng = _two_layer_engine(cuda)
    sched = SlotScheduler(2, eos_id=-1)
    _submit(sched, eng.cfg, (17, 40, 9), ("premium",) * 3)
    ops.reset_counts()
    summary = eng.serve(sched)
    assert [r.n_generated for r in sched.finished] == [6, 6, 6]
    assert summary["pages_leaked"] == 0
    assert summary["nonfinite_logits"] == 0
    c = ops.counts()
    for name in ("sa_matmul", "paged_decode", "prefill_attention"):
        assert c[name]["launches"] > 0, c
    assert all(v["plain_calls"] == 0 for v in c.values()), c


def test_serve_mixed_tiers_full_width_two_layers(cuda, monkeypatch):
    """A mixed premium/bulk stream at full width (two layers) on the cuda
    GEMM backend: all-bulk chunks run the SA GEMM's and paged decode's
    approx mode, prefill stays exact, no plain version runs, and every
    premium request's tokens are the all-premium stream's bit for bit
    (rows independent of the batch, ROADMAP F2)."""
    from repro_torch.serve.scheduler import SlotScheduler

    monkeypatch.setenv("REPRO_GEMM_BACKEND", "cuda")
    eng = _two_layer_engine(cuda)
    lens = (17, 40, 9, 23)
    tiers = ("premium", "bulk", "premium", "bulk")
    out = {}
    for name, ts in (("mixed", tiers), ("premium", ("premium",) * 4)):
        sched = SlotScheduler(2, eos_id=-1)
        _submit(sched, eng.cfg, lens, ts)
        ops.reset_counts()
        summary = eng.serve(sched)
        out[name] = ({r.rid: r.tokens for r in sched.finished}, summary,
                     ops.mode_counts(), ops.counts())
    toks, summary, modes, c = out["mixed"]
    assert summary["chunks_approx"] > 0 and summary["pages_leaked"] == 0
    assert summary["nonfinite_logits"] == 0
    assert "premium/approx" not in summary["tier_mode_tokens"]
    assert modes["sa_matmul"]["approx"] > 0, modes
    assert modes["paged_decode"]["approx"] > 0, modes
    assert modes["prefill_attention"]["approx"] == 0, modes
    assert all(v["plain_calls"] == 0 for v in c.values()), c
    assert out["premium"][2]["sa_matmul"]["approx"] == 0
    for rid, tier in enumerate(tiers):
        if tier == "premium":
            assert toks[rid] == out["premium"][0][rid], rid


def test_generate_matches_ring_serve_full_width_two_layers(cuda,
                                                           monkeypatch):
    """`generate()` (one batched prefill at B = 2 through the prefill
    kernel, decode on a ring) gives the ring serve's tokens for the same
    equal-length requests, and the ring serve gives the paged serve's
    under REPRO_DECODE_ATTN=gather (the same dense rows in the same
    order)."""
    from repro_torch.serve.scheduler import SlotScheduler

    monkeypatch.setenv("REPRO_GEMM_BACKEND", "cuda")
    monkeypatch.setenv("REPRO_DECODE_ATTN", "gather")
    ring = _two_layer_engine(cuda, kv_layout="ring")
    g = torch.Generator().manual_seed(3)
    prompts = torch.randint(0, ring.cfg.vocab_size, (2, 24), generator=g)
    ops.reset_counts()
    got = ring.generate(prompts, 9)
    # one batched prefill: a launch a layer
    assert ops.counts()["prefill_attention"]["launches"] == \
        ring.cfg.num_layers
    assert ring.last_stats["nonfinite_logits"] == 0
    streams = {}
    for layout in ("ring", "paged"):
        eng = ring if layout == "ring" else _two_layer_engine(
            cuda, kv_layout="paged")
        sched = SlotScheduler(2, eos_id=-1)
        for p in prompts.tolist():
            sched.submit(p, max_new_tokens=9)
        eng.serve(sched)
        streams[layout] = {r.rid: r.tokens for r in sched.finished}
        del eng
    assert streams["ring"] == streams["paged"]
    for rid in (0, 1):
        assert got[rid].tolist() == streams["ring"][rid]


def _on_grid(t, fmt):
    from repro_torch.core.fpformats import quantize
    box = torch.float16 if fmt == "fp16" else torch.bfloat16
    return quantize(t, fmt).to(box)


# every launch geometry (the producer/consumer kernel; the interleaved one
# at each rows a thread), forced on one ragged shape; the plan's own choice
# at decode's and prefill's M
FP_EMU_PLANS = ([(1, 1000, 96, None), (2, 1000, 96, None),
                 (3, 1000, 96, None), (16, 640, 80, None),
                 (33, 165, 200, None), (33, 165, 200, ("pc", 1))]
                + [(33, 165, 200, ("ilp", r)) for r in FE.ROWS])


@pytest.mark.parametrize("fmt", ["bf16", "fp16", "fp8_e4m3", "fp8_e5m2"])
@pytest.mark.parametrize("mode", ["exact", "approx"])
@pytest.mark.parametrize("m,k,n,plan", FP_EMU_PLANS)
def test_fp_emu_matches_plain_bit_exact(cuda, fmt, mode, m, k, n, plan):
    """The kernel against its plain version bit for bit: M = 1 to 33, K
    not a multiple of the 32-deep chunk, ragged N, every launch geometry,
    on planted zeros and cancellation (this test's and `emu_operands`, the
    operands chip_smoke.py checks and times)."""
    g = torch.Generator(device=cuda).manual_seed(m * k + n)
    a = torch.randn((m, k), generator=g, device=cuda)
    w = torch.randn((k, n), generator=g, device=cuda)
    a[1::2] *= 25.0
    w[:, 1] = 0.0
    a[0, : k // 3] = 0.0
    h = k // 2
    a[:, h:2 * h] = a[:, :h]
    w[h:2 * h, 2] = -w[:h, 2]                  # exact cancellation
    a, w = _on_grid(a, fmt), _on_grid(w, fmt)
    cases = [(a, w), GC.emu_operands(g, m, k, n, fmt)]
    for a, w in cases:
        ops.reset_counts()
        if plan is None:
            got = ops.skewed_datapath_matmul(a, w, fmt, mode)
            assert ops.counts()["fp_emu"] == {"launches": 1,
                                              "plain_calls": 0}
        else:
            got = FE._launch(a, w, fmt, mode, dict(
                zip(("kernel", "rows"), plan)))
        ref = FE.fma_emu_matmul_ref(a, w, fmt, mode)
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def test_fp_emu_chain_probe_runs(cuda):
    """The chain probe (the chain-latency bound's unit) launches and gives
    a plausible count of cycles a PE step."""
    assert 4.0 < FE.chain_cycles(2048) < 1000.0


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "fp8_e5m2"])
@pytest.mark.parametrize("dtype,offset", [(torch.float32, 0),
                                          (torch.float32, 1),
                                          (torch.bfloat16, 0)])
def test_quantize_matches_plain_bit_exact(cuda, fmt, dtype, offset):
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn((2 ** 20 + 3,), generator=g, device=cuda) * 300.0
    x[:6] = torch.tensor([float("nan"), float("inf"), -float("inf"), 1e-40,
                          -0.0, 1e38])
    x = x.to(dtype)[offset:]                    # offset 1: unaligned loads
    for scale in (QZ.amax_scale(x[8:], fmt), 1.0, 0.37):
        got = ops.quantize_fp8(x, scale, fmt)
        ref = QZ.quantize_fp8_ref(x, scale, fmt)
        nan = torch.isnan(ref)
        assert torch.equal(torch.isnan(got), nan)
        assert torch.equal(got[~nan].view(torch.int32),
                           ref[~nan].view(torch.int32))


def test_datapath_wrappers_refuse_bad_operands(cuda):
    a = torch.zeros((2, 64), dtype=torch.bfloat16, device=cuda)
    w = torch.zeros((64, 32), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="CUDA"):
        FE.fma_emu_matmul_cuda(a, w.cpu())
    with pytest.raises(ValueError, match="accumulator"):
        ops.skewed_datapath_matmul(a, w, "fp32")
    with pytest.raises(ValueError, match="containers"):
        ops.skewed_datapath_matmul(a.to(torch.int32), w)
    with pytest.raises(ValueError, match="CUDA"):
        QZ.quantize_fp8_cuda(a.cpu(), 1.0)
    with pytest.raises(ValueError, match="fp8"):
        ops.quantize_fp8(a, 1.0, "bf16")


def test_emulate_sa_dot_runs_the_kernel(cuda):
    """`sa_dot` under `emulate` on the card launches fp_emu once, runs no
    plain version, and equals the plain version on the CPU bit for bit
    (bias add and relu are exact in fp32 on both)."""
    from repro_torch.core.precision import sa_dot

    g = torch.Generator(device=cuda).manual_seed(5)
    a = torch.randn((4, 512), generator=g, device=cuda)
    w = (torch.randn((512, 96), generator=g, device=cuda) / 16).to(
        torch.bfloat16)
    bias = torch.randn((96,), generator=g, device=cuda)
    for mode in ("exact", "approx"):
        pol = PrecisionPolicy(backend="emulate", mode=mode)
        ops.reset_counts()
        got = sa_dot(a, w, pol, bias=bias, act="relu")
        c = ops.counts()
        assert c["fp_emu"] == {"launches": 1, "plain_calls": 0}, c
        assert c["sa_matmul"] == {"launches": 0, "plain_calls": 0}, c
        ref = sa_dot(a.cpu(), w.cpu(), pol, bias=bias.cpu(), act="relu")
        assert torch.equal(got.cpu().view(torch.int32),
                           ref.view(torch.int32))


def test_sa_matmul_fp8_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(6)
    a = torch.randn((64, 1024), generator=g, device=cuda)
    w = (torch.randn((1024, 384), generator=g, device=cuda) / 32).to(
        torch.bfloat16)
    for fmt in QZ.FORMATS:
        ops.reset_counts()
        got = ops.sa_matmul_fp8(a, w, fmt, act="silu")
        c = ops.counts()
        assert c["quantize"] == {"launches": 2, "plain_calls": 0}, c
        assert c["sa_matmul"] == {"launches": 1, "plain_calls": 0}, c
        sa_, sw = QZ.amax_scale(a, fmt), QZ.amax_scale(w, fmt)
        aq = QZ.quantize_fp8_ref(a, sa_, fmt).to(torch.bfloat16)
        wq = QZ.quantize_fp8_ref(w, sw, fmt).to(torch.bfloat16)
        ref = MM.sa_matmul_ref(aq, wq, scale=sa_ * sw, act="silu")
        bound = MM.error_bound(aq, wq, sa_ * sw, y=ref)
        assert bool(((got - ref).abs() <= bound).all())


def test_serve_emulate_full_width_two_layers(cuda, monkeypatch):
    """qwen2.5-14b at full width, cut to two layers, under the emulate
    backend: every GEMM launches fp_emu, the SA GEMM never runs, attention
    goes through its two kernels, and no plain version runs."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import SlotScheduler

    monkeypatch.setenv("REPRO_GEMM_BACKEND", "emulate")
    cfg = dataclasses.replace(get_config("qwen2.5-14b"), num_layers=2)
    params = M.init_params(cfg, seed=0, device=cuda)
    eng = ServeEngine(cfg, params, batch=2, cache_len=24, eos_id=-1,
                      sync_every=2)
    sched = SlotScheduler(2, eos_id=-1)
    g = torch.Generator().manual_seed(0)
    for n in (9, 17):
        sched.submit(torch.randint(0, cfg.vocab_size, (n,),
                                   generator=g).tolist(), max_new_tokens=3)
    ops.reset_counts()
    summary = eng.serve(sched)
    assert [r.n_generated for r in sched.finished] == [3, 3]
    assert summary["pages_leaked"] == 0
    assert summary["nonfinite_logits"] == 0
    c = ops.counts()
    for name in ("fp_emu", "paged_decode", "prefill_attention"):
        assert c[name]["launches"] > 0, c
    assert c["sa_matmul"]["launches"] == 0, c
    assert all(v["plain_calls"] == 0 for v in c.values()), c


# ---------------------------------------------------------------------------
# the SA GEMM at training shapes and its backward (SAMatmulFn)
# ---------------------------------------------------------------------------

def _operand(g, shape, dtype, transposed, dev):
    """A (rows, cols) operand in `dtype`; `transposed` gives the same
    values as the transposed view of a row-major (cols, rows) tensor."""
    x = torch.randn(shape, generator=g, device=dev) * shape[0] ** -0.5
    x = x.to(dtype)
    return x.t().contiguous().t() if transposed else x


@pytest.mark.parametrize("m,k,n", [
    (1024, 640, 384), (300, 1000, 999), (4, 1024, 96),
    # at and around the route threshold; K not a multiple of the 32-deep
    # stage (nor of 8: the operands' 16-byte rows are padded copies)
    (MM.TILED_MIN_M - 1, 1000, 384), (MM.TILED_MIN_M, 1000, 384),
    (MM.TILED_MIN_M + 1, 1003, 96), (128, 5120, 1024)])
@pytest.mark.parametrize("a_dt,w_dt", [(torch.bfloat16, torch.bfloat16),
                                       (torch.float32, torch.bfloat16),
                                       (torch.bfloat16, torch.float32),
                                       (torch.float32, torch.float32)])
@pytest.mark.parametrize("a_t,w_t", [(False, False), (True, False),
                                     (False, True), (True, True)])
def test_sa_matmul_types_and_layouts_match_plain(cuda, m, k, n, a_dt, w_dt,
                                                 a_t, w_t):
    """Every operand type and layout, through the route `gemm_route`
    names (`mma` for bf16 x bf16 at every M, the decode tile below 17
    rows; for the other pairs split-K below TILED_MIN_M for row-major
    operands, else `split3` or `simt` by the operand types), the raw
    output and the
    epilogue within the route's bound; on the tensor-core routes the raw
    output also passes `split_check`."""
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    a = _operand(g, (m, k), a_dt, a_t, cuda)
    w = _operand(g, (k, n), w_dt, w_t, cuda)
    bias = torch.randn((n,), generator=g, device=cuda)
    ops.reset_counts()
    got, raw = MM.sa_matmul_cuda(a, w, bias, 0.75, act="silu",
                                 save_raw=True)
    route = MM.gemm_route(m, a_dt, w_dt, not a_t, not w_t)
    assert ops.route_counts()["sa_matmul"] == {
        r: int(r == route) for r in MM.ROUTES}
    ref, raw_ref = MM.sa_matmul_ref(a, w, bias, 0.75, act="silu",
                                    save_raw=True)
    bound = MM.error_bound(a, w, 0.75, y=ref)
    assert bool(((got - ref).abs() <= bound).all())
    assert bool(((raw - raw_ref).abs() <= MM.error_bound(a, w)).all())
    if route in ("mma", "split3"):
        assert MM.split_check(a, w, raw) <= 1.0


def test_sa_matmul_is_deterministic(cuda):
    """The split K is summed in a fixed order: two runs are bit-identical
    (remat's recompute depends on it)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    assert MM.fp32_k_plan(1024, 5120)["parts"] > 1
    for dt in (torch.bfloat16, torch.float32):
        a = torch.randn((1024, 5120), generator=g, device=cuda).to(dt)
        w = (torch.randn((5120, 1024), generator=g, device=cuda) / 72).to(dt)
        y1 = ops.sa_matmul(a, w)
        y2 = ops.sa_matmul(a, w)
        assert torch.equal(y1.view(torch.int32), y2.view(torch.int32)), dt


@pytest.mark.parametrize("act", ["none", "silu", "gelu"])
@pytest.mark.parametrize("m", [1024, 8])
def test_sa_matmul_backward_matches_plain(cuda, act, m):
    """SAMatmulFn on the card against plain autograd through the plain
    version on the same inputs: dA and dW (bf16, as the operands) within
    the backward GEMMs' bound plus one bf16 rounding, dbias and dscale
    within the bound the raw accumulator's drift allows; the backward
    launched the kernel twice and no plain version ran."""
    k, n = 640, 384
    g = torch.Generator(device=cuda).manual_seed(17 + m)
    a0 = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
    w0 = (torch.randn((k, n), generator=g, device=cuda) / 25).to(
        torch.bfloat16)
    b0 = torch.randn((n,), generator=g, device=cuda) * 0.1
    dy = torch.randn((m, n), generator=g, device=cuda)

    def grads(fn):
        a, w, b = (t.clone().requires_grad_(True) for t in (a0, w0, b0))
        s = torch.tensor(0.5, device=cuda, requires_grad=True)
        y = fn(a, w, b, s)
        (y * dy).sum().backward()
        return y.detach(), a.grad, w.grad, b.grad, s.grad

    ops.reset_counts()
    y, da, dw, db, ds = grads(lambda a, w, b, s: ops.sa_matmul(
        a, w, bias=b, scale=s, act=act))
    c = ops.counts()
    assert c["sa_matmul"] == {"launches": 1, "plain_calls": 0}, c
    assert c["sa_matmul_bwd"] == {"launches": 2, "plain_calls": 0}, c
    fwd = MM.gemm_route(m, a0.dtype, w0.dtype)
    assert ops.route_counts()["sa_matmul"] == {
        "partial": int(fwd == "partial"), "mma": int(fwd == "mma"),
        "split3": 2, "simt": 0}
    y_r, da_r, dw_r, db_r, ds_r = grads(lambda a, w, b, s: MM.sa_matmul_ref(
        a, w, b, s, act=act))
    # the backward GEMMs' operands: du·s (fp32) against the bf16 W and A;
    # each result is then rounded to bf16 (one ulp ≤ 2⁻⁷ of the value)
    raw = a0.float() @ w0.float()
    du = torch.autograd.functional.vjp(lambda t: MM.apply_act(t, act),
                                       raw * 0.5 + b0, dy)[1]
    dus = du * 0.5
    # the backward GEMMs run the split3 route (fp32 dus against bf16 W, A):
    # its bound (3K truncated tensor-core products), then one bf16 rounding
    b_da = MM.error_bound(dus, w0.t()) + 2.0 ** -7 * da_r.float().abs()
    b_dw = MM.error_bound(a0.t(), dus) + 2.0 ** -7 * dw_r.float().abs()
    assert bool(((da.float() - da_r.float()).abs() <= b_da).all())
    assert bool(((dw.float() - dw_r.float()).abs() <= b_dw).all())
    # the sharper check on the two fp32 GEMMs themselves: the split passes,
    # and the same GEMMs with dus rounded once to bf16 (no split) fail
    da32, dw32 = MM.backward_gemms(a0, w0, dus)
    assert MM.split_check(dus, w0.t(), da32) <= 1.0
    assert MM.split_check(a0.t(), dus, dw32) <= 1.0
    fa, fw = MM.backward_gemms(a0, w0, dus.to(torch.bfloat16).float())
    assert MM.split_check(dus, w0.t(), fa) > 1.0
    assert MM.split_check(a0.t(), dus, fw) > 1.0
    # dbias = Σ_rows du and dscale = Σ du·raw: raw moves by the forward
    # bound, u by 0.5x that, du by at most |act''| ≤ 1 times that times
    # |dy|; then the fp32 sums' own reassociation
    raw_b = MM.error_bound(a0, w0)
    d_du = 0.5 * raw_b * dy.abs()
    b_db = d_du.sum(0) + 2 * m * 2.0 ** -24 * du.abs().sum(0) + 1e-6
    assert bool(((db - db_r).abs() <= b_db).all())
    b_ds = float((d_du * raw.abs() + du.abs() * raw_b).sum()
                 + 2 * m * n * 2.0 ** -24 * (du * raw).abs().sum()) + 1e-6
    assert abs(float(ds) - float(ds_r)) <= b_ds


def test_split3_is_the_plain_split_bit_for_bit(cuda):
    """The kernel's split (the split3 route's pre-pass) equals `split3_ref`
    bit for bit, and hi + mid + lo == x exactly, on a backward's dus and on
    planted values: ties of each piece, powers of two, the smallest normal,
    the largest floats, ±Inf and NaN (which give (x, 0, 0)); a transposed
    view is split in place."""
    g = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn((1024, 1000), generator=g, device=cuda) * 1e-3
    planted = torch.tensor(
        [0.0, -0.0, 1.0, -2.0, 2.0 ** -126, 2.0 ** -110, 2.0 ** 127,
         3.4028234663852886e38, -3.4028234663852886e38, 1.0 + 2 ** -8,
         1.0 + 3 * 2 ** -8, 1.0 + 2 ** -8 + 2 ** -16, 1.0 + 2 ** -23,
         float("inf"), -float("inf"), float("nan")], device=cuda)
    x[0, :len(planted)] = planted
    for t in (x, x[:, :999].t()):
        got = MM.split3_cuda(t)
        assert torch.equal(got.view(torch.int16),
                           MM.split3_ref(t).view(torch.int16))
        fin = torch.isfinite(t)
        assert bool(((got.double().sum(0) == t.double()) | ~fin).all())
        assert bool((got[1:][:, ~fin] == 0).all())


def test_sa_matmul_route_counters(cuda):
    """Under the bf16 policy a training-shape GEMM's forward launches the
    `mma` route and its backward two `split3` launches; under the fp32
    policy the forward and backward launch `simt`. A decode-sized
    row-major GEMM launches `mma` under the bf16 policy (the decode tile)
    and `partial` under the fp32 policy."""
    from repro_torch.core.precision import sa_dot

    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((256, 512), generator=g, device=cuda)
    w = (torch.randn((512, 384), generator=g, device=cuda) / 23
         ).requires_grad_(True)
    for fmt, fwd, bwd in (("bf16", "mma", "split3"), ("fp32", "simt",
                                                      "simt")):
        ops.reset_counts()
        y = sa_dot(x, w, PrecisionPolicy(backend="cuda", input_format=fmt))
        y.sum().backward()
        want = {r: 0 for r in MM.ROUTES}
        want[fwd] += 1
        want[bwd] += 2
        assert ops.route_counts()["sa_matmul"] == want, fmt
        assert all(v["plain_calls"] == 0 for v in ops.counts().values())
    for fmt, route in (("bf16", "mma"), ("fp32", "partial")):
        ops.reset_counts()
        sa_dot(x[:4], w.detach(), PrecisionPolicy(backend="cuda",
                                                 input_format=fmt))
        want = {r: int(r == route) for r in MM.ROUTES}
        assert ops.route_counts()["sa_matmul"] == want, fmt


# the path's GEMMs at reduced K (full N), one at full K (several slices a
# part on the fp32 routes), and a ragged one: (K, N, bias, act, mode,
# scale); "dev" is a scale held on the card (the FP8 GEMM's descale)
FOLD_SHAPES = {
    "wq": (640, 5120, True, "none", "exact", None),
    "wk": (640, 1024, True, "none", "approx", None),
    "wv": (640, 1024, True, "gelu", "exact", "dev"),
    "wo": (640, 5120, False, "none", "exact", None),
    "gate": (640, 13824, False, "silu", "exact", None),
    "up": (640, 13824, False, "none", "approx", "dev"),
    "down": (1728, 5120, False, "none", "exact", None),
    "gate_full_k": (5120, 13824, False, "silu", "exact", None),
    "ragged": (1000, 999, True, "silu", "approx", 0.75)}


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("name", list(FOLD_SHAPES))
def test_sa_matmul_rows_fold_bit_identically(cuda, name, dtype):
    """ROADMAP F2 and F2b: each row of a GEMM at M = 1, 4, 7 is
    bit-identical to the same row inside the products of M = 8, 20 and
    1024 — the epilogue (bias, activation, approx truncation, a scale on
    the card) and the raw accumulator included — so a speculative verify
    fold of B·(k+1) rows gives each row what the decode step gave it.
    bf16 x bf16 runs the decode tile at M ≤ 16 and the small and large
    tiles above; fp32 x fp32 runs `partial` below TILED_MIN_M and `simt`
    from it, in one order of sums (`fp32_k_plan`)."""
    k, n, has_bias, act, mode, scale = FOLD_SHAPES[name]
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    g = torch.Generator(device=cuda).manual_seed(k + n)
    a = torch.randn((1024, k), generator=g, device=cuda).to(dt)
    w = (torch.randn((k, n), generator=g, device=cuda) * k ** -0.5).to(dt)
    bias = (torch.randn((n,), generator=g, device=cuda) * 0.1
            if has_bias else None)
    if scale == "dev":
        scale = torch.tensor(0.5, device=cuda)

    def run(m):
        ops.reset_counts()
        y, raw = MM.sa_matmul_cuda(a[:m], w, bias, scale, act=act,
                                   mode=mode, save_raw=True)
        route = [r for r, c in ops.route_counts()["sa_matmul"].items() if c]
        assert route == [MM.gemm_route(m, dt, dt)], (m, route)
        return y.view(torch.int32), raw.view(torch.int32)

    big = {m: run(m) for m in (8, 20, 1024)}
    if dtype == "bf16":
        assert MM.mma_plan(8, n, "mma")["tile"] == "decode"
        assert MM.mma_plan(20, n, "mma")["tile"] != "decode"
        # M = 1024 ran on the tile the plan names: the large one (wgmma)
        # wherever its blocks fill the card
        tile = MM.mma_plan(1024, n, "mma")["tile"]
        assert tile == ("large" if n >= 5120 else "small")
        ops.reset_counts()
        run(1024)
        assert ops.tile_counts()[tile] == 1
    else:
        assert MM.gemm_route(7, dt, dt) == "partial"
        assert MM.gemm_route(8, dt, dt) == "simt"
    for m in (1, 4, 7):
        y, raw = run(m)
        for mb, (yb, rawb) in big.items():
            assert torch.equal(y, yb[:m]), (m, mb)
            assert torch.equal(raw, rawb[:m]), (m, mb)


@pytest.mark.parametrize("tile", ["large", "small", "decode"])
def test_sa_matmul_tiles_give_the_same_bits(cuda, tile):
    """Every `mma` tile gives every output the same bits (one summation
    order: k16 steps in order, K never split), at decode's M, at M = 128
    and at M = 1024 (the large tile on wgmma against the plan's mma.sync
    tile), for each operand layout."""
    g = torch.Generator(device=cuda).manual_seed(23)
    for m in (4, 128, 1024):
        for a_t, w_t in ((False, False), (True, False), (False, True),
                         (True, True)):
            a = _operand(g, (m, 1000), torch.bfloat16, a_t, cuda)
            w = _operand(g, (1000, 520), torch.bfloat16, w_t, cuda)
            want = MM.sa_matmul_cuda(a, w, act="silu")
            got, _ = MM._launch(a, w, None, None, "silu", "exact", False,
                                tile=tile)
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32)), (m, a_t, w_t)


@pytest.mark.parametrize("case", GC.PROBE_CASES)
def test_k16_probe_wgmma_step_sums_carry_mma_sync_bits(cuda, case):
    """The large tile's premise (ROADMAP F2): wgmma m64n128k16 with
    scale-d = 0 sums a k16 step's 16 products from zero to mma.sync
    m16n8k16's bits (C = 0), on random steps and on planted ones whose
    products spread over 2^±60, cancel, straddle fp32's smallest normal or
    are signed zeros. A zero step sum's sign may differ: no accumulator
    started at +0 can see it (+0 + ±0 = +0, x + ±0 = x)."""
    a, b = GC.k16_probe_operands(0)[case]
    got_mma, got_wg = MM.k16_probe(a.to(cuda), b.to(cuda))
    diff = GC.k16_mismatches(got_mma, got_wg)
    assert diff["values"] == 0, diff
    assert bool(torch.isfinite(got_wg).all())


def _large_case(g, m, k, n, a_t, w_t, dev):
    a = _operand(g, (m, k), torch.bfloat16, a_t, dev)
    w = _operand(g, (k, n), torch.bfloat16, w_t, dev)
    return a, w, torch.randn((n,), generator=g, device=dev)


# (M, K, N, act, mode, scale): ragged M, N and K (N not a multiple of 128)
LARGE_CASES = [(20, 1000, 999, "none", "exact", None),
               (129, 640, 1000, "silu", "approx", "dev"),
               (1000, 1003, 384, "gelu", "exact", 0.75),
               (1024, 5120, 640, "silu", "approx", 0.5)]


@pytest.mark.parametrize("m,k,n,act,mode,scale", LARGE_CASES)
@pytest.mark.parametrize("a_t,w_t", [(False, False), (True, False),
                                     (False, True), (True, True)])
def test_sa_matmul_large_tile_matches_plain(cuda, m, k, n, act, mode, scale,
                                            a_t, w_t):
    """The large tile (wgmma, TMA for both operands) on each of the four
    layouts (A as (M, K) or (K, M), W as stored or as Wᵀ), forced at ragged
    shapes: the epilogue (bias, silu or gelu, approx, a host or device
    scale) within `error_bound` of the plain version, the raw accumulator
    (`save_raw`) within the bound and `split_check`; one launch, counted
    on the large tile."""
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    a, w, bias = _large_case(g, m, k, n, a_t, w_t, cuda)
    if scale == "dev":
        scale = torch.tensor(0.5, device=cuda)
    ops.reset_counts()
    got, raw = MM._launch(a, w, bias, scale, act, mode, True, tile="large")
    assert ops.tile_counts() == {"large": 1, "small": 0, "decode": 0,
                                 "split3": 0}
    ref, raw_ref = MM.sa_matmul_ref(a, w, bias, scale, act=act, mode=mode,
                                    save_raw=True)
    assert bool(((got - ref).abs()
                 <= MM.error_bound(a, w, scale, mode, y=ref)).all())
    assert bool(((raw - raw_ref).abs()
                 <= MM.error_bound(a, w, mode=mode)).all())
    if mode == "exact":
        assert MM.split_check(a, w, raw) <= 1.0


def test_sa_matmul_large_tile_refuses_what_it_cannot_take(cuda):
    """The large tile's launch returns an error, which the wrapper raises,
    for what it cannot take: split pieces of an fp32 operand (it is bf16 x
    bf16 only), a leading dimension off the 16-byte grid that TMA needs,
    or an operand off its 16-byte alignment; the launch does not reroute
    them."""
    from repro_torch.kernels import build

    a = torch.zeros((256, 1024), dtype=torch.bfloat16, device=cuda)
    out = torch.empty((256, 256), device=cuda)
    fn = build.function("sa_matmul", "sa_mma_launch", MM.MMA_ARGTYPES)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    code = MM.MMA_TILES["large"].code

    def launch(ptr, npiece, lda, plane=0):
        return fn(ptr, npiece, 1, lda, plane, a.data_ptr(), 0, 256, None, 0,
                  out.data_ptr(), None, 256, 1, 1.0, None, 256, 256, 1000,
                  0, 0, code, stream)

    assert launch(a.data_ptr(), 1, 1024) == 0
    torch.cuda.synchronize()
    for bad in (launch(a.data_ptr(), 3, 1024, 256 * 1024),
                launch(a.data_ptr(), 1, 1001),
                launch(a.data_ptr() + 2, 1, 1024)):
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            build.check(bad, "sa_matmul (mma)")


@pytest.mark.parametrize("lens,pool", [
    ((144, 100, 40, 0), F32), ((144, 100, 40, 0), BF16),
    ((2048, 1000, 17, 0), F32)])
def test_paged_decode_slots_fold_bit_identically(cuda, lens, pool):
    """ROADMAP F2: a slot's decode output at B = 4 is bit-identical to the
    same slot inside a batch of B = 20 with the same block-table width
    (the cluster is planned from the slot alone)."""
    P = -(-max(lens) // 16)
    lens20 = lens + tuple((37 * i) % (16 * P) + 1 for i in range(16))
    q, k, v, pp, bt, pos = _pool(cuda, B=20, P=P, lens=lens20)
    k, v = k.to(pool), v.to(pool)
    y20 = DA.paged_decode_cuda(q, k, v, pp, bt, pos)
    y4 = DA.paged_decode_cuda(q[:4], k, v, pp, bt[:4], pos[:4])
    assert torch.equal(y4.view(torch.int32), y20[:4].view(torch.int32))
    assert DA.launch_plan(q[:4], k, v, bt[:4]) == DA.launch_plan(q, k, v, bt)


def test_sa_matmul_backward_bound_rejects_a_dropped_jacobian(cuda):
    """A backward that skips the activation jacobian lands outside the dA
    bound the test above holds the kernel to."""
    m, k, n = 1024, 640, 384
    g = torch.Generator(device=cuda).manual_seed(3)
    a = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn((k, n), generator=g, device=cuda) / 25).to(
        torch.bfloat16)
    dy = torch.randn((m, n), generator=g, device=cuda)
    u = a.float() @ w.float()
    du = torch.autograd.functional.vjp(lambda t: MM.apply_act(t, "silu"), u,
                                       dy)[1]
    da, _ = MM.backward_gemms(a, w, du)
    bad, _ = MM.backward_gemms_ref(a, w, dy)
    bound = MM.error_bound(du, w.t()) + 2.0 ** -7 * da.abs()
    assert float(((da - bad).abs() / bound).max()) > 1.0


@pytest.mark.parametrize("m", [1, 2, 4, 5, 15, 16, 17, 20, 23, 24, 64, 1024])
def test_rmsnorm_rows_fold_bit_identically(cuda, m):
    """A row's rmsnorm (a PyTorch reduction between the kernels) on the
    card does not depend on how many rows the call holds: decode's B
    against the verify's B·(k+1), a prompt against its bucket. The
    speculative verify's exactness rests on it as on ROADMAP F2."""
    from repro_torch.models.layers import rmsnorm

    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((1024, 5120), generator=g, device=cuda).to(
        torch.bfloat16)
    w = torch.rand((5120,), generator=g, device=cuda) + 0.5
    ref = rmsnorm(x[:20], w)
    got = rmsnorm(x[:m], w)
    n = min(m, 20)
    assert torch.equal(got[:n].view(torch.int16), ref[:n].view(torch.int16))


def _spec_stream(eng, lens=(17, 40, 9), max_new=9):
    from repro_torch.launch.serve import stream_digest
    from repro_torch.serve.scheduler import SlotScheduler

    sched = SlotScheduler(eng.batch, eos_id=-1)
    _submit(sched, eng.cfg, lens, ("premium",) * len(lens), max_new)
    ops.reset_counts()
    summary = eng.serve(sched)
    assert summary["pages_leaked"] == 0 and summary["nonfinite_logits"] == 0
    assert all(v["plain_calls"] == 0 for v in ops.counts().values())
    return stream_digest(sched.finished), summary


def test_spec_full_width_two_layers(cuda, monkeypatch):
    """Self-speculative decoding at full width, two layers, on the cuda
    backend with the fused decode kernel: a draft of the whole stack is
    the plain decode step at M = B, the verify the same rows folded at M =
    B·(k+1), so every draft is accepted; a one-layer draft gives the plain
    stream's digest."""
    monkeypatch.setenv("REPRO_GEMM_BACKEND", "cuda")
    plain, _ = _spec_stream(_two_layer_engine(cuda))
    full, s_full = _spec_stream(_two_layer_engine(cuda, spec_k=4,
                                                  spec_draft_layers=2))
    half, s_half = _spec_stream(_two_layer_engine(cuda, spec_k=4,
                                                  spec_draft_layers=1))
    assert s_full["spec_accept_rate"] == 1.0
    assert full == half == plain
    assert s_half["spec_drafted"] > 0 and s_half["spec_draft_layers"] == 1
    assert ops.route_counts()["sa_matmul"]["partial"] == 0


@pytest.mark.parametrize("pool", [torch.float32, torch.bfloat16])
def test_verify_logits_fold_bit_identically(cuda, monkeypatch, pool):
    """The exactness argument at full width under the bf16 policy: the
    verify's folded logits (B = 4, k = 4: M = 20, the SA GEMM's small tile
    and 20 paged decode rows) equal four sequential decode steps' (M = 4,
    the decode tile) bit for bit, and both leave the same pool."""
    from repro_torch.models import model as M
    from repro_torch.train.step import make_serve_step, make_verify_step

    monkeypatch.setenv("REPRO_GEMM_BACKEND", "cuda")
    eng = _two_layer_engine(cuda, cache_dtype=pool)
    eng = type(eng)(eng.cfg, eng.params, batch=4, cache_len=48,
                    cache_dtype=pool, page_size=16)
    cache = eng.new_pool()
    for c in cache:
        for b in range(4):
            c["kv"].block_table[:, b, :3] = torch.arange(1 + 3 * b,
                                                        4 + 3 * b)
    g = torch.Generator().manual_seed(1)
    pre = torch.randint(0, eng.cfg.vocab_size, (4, 11), generator=g,
                        dtype=torch.int32).to(cuda)
    block = torch.randint(0, eng.cfg.vocab_size, (4, 5), generator=g,
                          dtype=torch.int32).to(cuda)
    step = make_serve_step(eng.cfg)
    pos = torch.tensor([0, 3, 5, 6], dtype=torch.int32, device=cuda)
    for t in range(11):
        _, cache = step(eng.params, pre[:, t:t + 1], cache, pos + t)
    pos = pos + 11
    folded = M.tree_map(torch.clone, cache)
    ops.reset_counts()
    vl, folded = make_verify_step(eng.cfg)(eng.params, block, folded, pos)
    assert ops.counts()["paged_decode"]["launches"] == eng.cfg.num_layers
    rows = []
    for t in range(5):
        lg, cache = step(eng.params, block[:, t:t + 1], cache, pos + t)
        rows.append(lg[:, 0])
    seq = torch.stack(rows, 1)
    assert torch.equal(vl.view(torch.int32), seq.view(torch.int32))
    for a, b in zip(M.tree_leaves(folded), M.tree_leaves(cache)):
        assert torch.equal(a, b)


def test_bucketed_prefill_full_width_two_layers(cuda, monkeypatch):
    """Prompt lengths 17, 20 and 23 bucket to one prefill shape (24): the
    stream digest equals the unbucketed serve's (three shapes), and
    prefill attention runs the `mma` route at the padded length."""
    monkeypatch.setenv("REPRO_GEMM_BACKEND", "cuda")
    plain, s_plain = _spec_stream(_two_layer_engine(cuda), lens=(17, 20, 23))
    got, s_got = _spec_stream(_two_layer_engine(cuda, bucket_prompts=True),
                              lens=(17, 20, 23))
    routes = ops.route_counts()["prefill_attention"]
    assert got == plain
    assert s_plain["prefill_compiles"] == 3 and s_got["prefill_compiles"] == 1
    assert routes["simt"] == 0 and routes["mma"] > 0


@pytest.mark.parametrize("B", [4, 20])
@pytest.mark.parametrize("pool", [F32, BF16])
@pytest.mark.parametrize("table", ["masked", "identity"])
def test_paged_decode_dense_view_equals_pool(cuda, B, pool, table):
    """ROADMAP F5: the kernel over dense rows presented as a pool
    (`dense_pool_view`, `min_page=0`) gives the kernel over the pool the
    same bits, at B = 4 and B = 20. The rows are the pool slots' gathered
    view; with the source table's unmapped and trash entries marked -1
    they are skipped as the pool's are, and with the bare identity table
    (a ring's) they are read as zeros at position -1 and masked."""
    from repro_torch.models.layers import PagedKVCache, gather_pages

    lens = (144, 100, 40, 0) + tuple((37 * i) % 144 + 1
                                     for i in range(B - 4))
    q, k, v, pp, bt, pos = _pool(cuda, B=B, lens=lens)
    k, v = k.to(pool), v.to(pool)
    want = DA.paged_decode_cuda(q, k, v, pp, bt, pos)
    kg, vg, pg = gather_pages(PagedKVCache(k, v, pp, bt))
    view = DA.dense_pool_view(kg, vg, pg, k.shape[1],
                              bt if table == "masked" else None)
    assert DA.launch_plan(q, *view[:2], view[3]) == \
        DA.launch_plan(q, k, v, bt)
    before = DA.LAUNCHES
    got = ops.paged_decode_attention(q, *view, pos, min_page=0)
    assert DA.LAUNCHES == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_serve_fused_gather_ring_equal_tokens_full_width_two_layers(
        cuda, monkeypatch):
    """ROADMAP F5 on a served path: the fused serve, the paged serve under
    REPRO_DECODE_ATTN=gather and the ring serve of one stream give the
    same tokens (on the card all three decode through the paged-decode
    kernel in one order of sums), each launching the kernel and no plain
    version."""
    from repro_torch.serve.scheduler import SlotScheduler

    monkeypatch.setenv("REPRO_GEMM_BACKEND", "cuda")
    streams = {}
    for name, impl, layout in (("fused", "fused", "paged"),
                               ("gather", "gather", "paged"),
                               ("ring", "gather", "ring")):
        monkeypatch.setenv("REPRO_DECODE_ATTN", impl)
        eng = _two_layer_engine(cuda, kv_layout=layout)
        sched = SlotScheduler(2, eos_id=-1)
        _submit(sched, eng.cfg, (17, 30, 9), ("premium",) * 3, max_new=9)
        ops.reset_counts()
        summary = eng.serve(sched)
        c = ops.counts()
        assert c["paged_decode"]["launches"] > 0, (name, c)
        assert all(v["plain_calls"] == 0 for v in c.values()), (name, c)
        assert summary["nonfinite_logits"] == 0
        streams[name] = {r.rid: r.tokens for r in sched.finished}
        del eng
    assert streams["fused"] == streams["gather"] == streams["ring"]
    assert all(len(t) == 9 for t in streams["fused"].values())


# ---------------------------------------------------------------------------
# the families' shapes: prefill and decode at head dim 256, the tied head
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,S,kw,fmt,kv", [
    (128, 128, {}, "bf16", F32), (200, 200, {"window": 64}, "bf16", F32),
    (100, 100, {"window": 33, "cap": 50.0}, "bf16", BF16),
    (64, 128, {"q_offset": 64, "window": 48, "cap": 50.0}, "bf16", F32),
    (17, 17, {}, "fp16", F16), (33, 33, {"cap": 50.0}, "fp16", F32),
    (100, 100, {"window": 33}, "fp32", F32), (40, 40, {}, "fp32", BF16)])
def test_prefill_hd256_matches_plain(cuda, T, S, kw, fmt, kv):
    """gemma2's and gemma3's prefill (16 heads over 8 KV heads, hd 256) on
    both routes, q as `attention_block` hands it over: within the bound of
    the plain version, the planted mask outside it, and 16-bit K/V the
    fp32 K/V's bits."""
    g = torch.Generator(device=cuda).manual_seed(T + S + 256)
    q = torch.randn((1, 16, T, 256), generator=g, device=cuda).transpose(
        1, 2)
    k32 = torch.randn((1, S, 8, 256), generator=g, device=cuda)
    v32 = torch.randn((1, S, 8, 256), generator=g, device=cuda)
    k, v = k32.to(kv), v32.to(kv)
    pol = PrecisionPolicy(input_format=fmt)
    ops.reset_counts()
    got = ops.sa_attention(q, k, v, policy=pol, **kw)
    route = "simt" if fmt == "fp32" else "mma"
    assert ops.route_counts()["prefill_attention"] == {
        "mma": 0, "simt": 0, route: 1}
    assert ops.counts()["prefill_attention"]["plain_calls"] == 0
    ref = FA.flash_attention_ref(q, k, v, policy=pol, **kw)
    bound = FA.error_bound(q, k, v, policy=pol, **kw)
    assert bool(((got - ref).abs() <= bound).all())
    bad = FA.flash_attention_ref(q, k, v, policy=pol,
                                 **{**kw, "q_offset": kw.get("q_offset", 0)
                                    + 1})
    assert float(((got - bad).abs() / bound).max()) > 1.0
    if kv != F32 and fmt == {BF16: "bf16", F16: "fp16"}[kv]:
        y32 = ops.sa_attention(q, k32, v32, policy=pol, **kw)
        assert torch.equal(got.view(torch.int32), y32.view(torch.int32))


def _split_sizes(g, hd, psz, P):
    """Every cluster size `split_plan` accepts for the slot, once each."""
    sizes = []
    for n in range(1, DA.MAX_CLUSTER + 1):
        try:
            got = DA.split_plan(g, hd, psz, P, n_split=n).n_split
        except ValueError:
            continue
        if got not in sizes:
            sizes.append(got)
    return sizes


@pytest.mark.parametrize("shape", ["serve", "2048", "ring_hd64", "hd256"])
@pytest.mark.parametrize("pool", [F32, BF16])
@pytest.mark.parametrize("mode", ["exact", "approx"])
def test_paged_decode_bits_do_not_depend_on_n_split(cuda, shape, pool,
                                                    mode):
    """ROADMAP F9: the kernel sums the denominator and P·V over fixed runs
    of 64 keys and folds the runs in run order, so every cluster size
    `split_plan` accepts gives the same bits: the serve shape (B 4, g 5,
    hd 128, page 16, 9 pages), 2048-token slots, g 5 / hd 64 dense rings
    of 2048 rows (`dense_pool_view`, hymba's) and g 2 / hd 256 rings of
    1024 (gemma's, cap 50), fp32 and bf16 pools, exact and approx. The
    kernel before the repair summed a block's keys and then the blocks in
    rank order: at the serve shape its tuned cluster sizes 3 and 4 against
    the heuristic's 6 parted the served stream (digests 09891ddc41ede9bf
    and 2b00d17fea67feb8 against d436a40e4fd3dd59, chip_smoke's autotune
    phase on the H100)."""
    pol = PrecisionPolicy(input_format="bf16", mode=mode)
    kw, min_page = {}, 1
    if shape in ("serve", "2048"):
        lens = SERVE_LENS if shape == "serve" else (2048, 1000, 17, 0)
        P = -(-max(lens) // 16)
        q, k, v, pp, bt, pos = _pool(cuda, P=P, lens=lens)
        g_, hd = 5, 128
    else:
        B, KVH, g_, hd, rows = ((4, 5, 5, 64, 2048) if shape == "ring_hd64"
                                else (4, 8, 2, 256, 1024))
        gen = torch.Generator(device=cuda).manual_seed(rows + hd)
        q = torch.randn((B, 1, KVH * g_, hd), generator=gen, device=cuda)
        kd = torch.randn((B, rows, KVH, hd), generator=gen, device=cuda)
        vd = torch.randn((B, rows, KVH, hd), generator=gen, device=cuda)
        pos = torch.tensor([rows + 37, rows - 1, 3 * rows + 5, 10],
                           dtype=torch.int32, device=cuda)
        i = torch.arange(rows, device=cuda)
        p = pos[:, None] - ((pos[:, None] - i[None]) % rows)
        kp = torch.where(p >= 0, p, -1).to(torch.int32)
        k, v, pp, bt = DA.dense_pool_view(kd, vd, kp, 16)
        P, min_page = rows // 16, 0
        kw = {"window": rows, "cap": 50.0} if hd == 256 else {
            "window": rows}
    k, v = k.to(pool), v.to(pool)
    sizes = _split_sizes(g_, hd, 16, P)
    assert len(sizes) >= 3, sizes
    outs = {n: DA.paged_decode_cuda(q, k, v, pp, bt, pos, policy=pol,
                                    n_split=n, min_page=min_page, **kw)
            for n in sizes}
    want = outs[sizes[0]].view(torch.int32)
    for n, got in outs.items():
        assert torch.equal(got.view(torch.int32), want), (n, sizes)
    assert bool(torch.isfinite(outs[sizes[0]]).all())
    if min_page:   # the pool: within the plain version's bound too
        ref = DA.paged_decode_ref(q, k, v, pp, bt, pos, policy=pol, **kw)
        bound = DA.error_bound(q, k, v, pp, bt, pos, policy=pol, **kw)
        assert bool(((outs[sizes[0]] - ref).abs() <= bound).all())


@pytest.mark.parametrize("rows,window,pool", [
    (1024, 1024, F32), (256, 256, BF16), (4096, 4096, F32)])
def test_paged_decode_hd256_over_a_dense_ring(cuda, rows, window, pool):
    """gemma's decode (g = 2, hd 256, softcap 50) over local rings of
    `window` rows presented by `dense_pool_view` (`min_page=0`): within
    the bound of the plain version, and the same bits as the kernel over
    the ring's rows copied into a pool."""
    B, KVH, grp, hd, psz = 4, 8, 2, 256, 16
    g = torch.Generator(device=cuda).manual_seed(rows)
    q = torch.randn((B, 1, KVH * grp, hd), generator=g, device=cuda)
    k = torch.randn((B, rows, KVH, hd), generator=g, device=cuda).to(pool)
    v = torch.randn((B, rows, KVH, hd), generator=g, device=cuda).to(pool)
    # ring rows: slot b is at position pos[b], its row i holds the latest
    # position p <= pos[b] with p % rows == i (-1 where none was written)
    pos = torch.tensor([rows + 37, rows - 1, 3 * rows + 5, 10],
                       dtype=torch.int32, device=cuda)
    i = torch.arange(rows, device=cuda)
    p = pos[:, None] - ((pos[:, None] - i[None]) % rows)
    pp = torch.where(p >= 0, p, -1).to(torch.int32)
    kp, vp, ppv, table = DA.dense_pool_view(k, v, pp, psz)
    before = DA.LAUNCHES
    got = ops.paged_decode_attention(q, kp, vp, ppv, table, pos,
                                     window=window, cap=50.0, min_page=0)
    assert DA.LAUNCHES == before + 1
    # the same rows as pool pages 1.. (page 0 the trash page)
    pool = (torch.cat([torch.zeros_like(kp[:1]), kp]),
            torch.cat([torch.zeros_like(vp[:1]), vp]),
            torch.cat([torch.full_like(ppv[:1], -1), ppv]), table + 1)
    want = DA.paged_decode_cuda(q, *pool, pos, window=window, cap=50.0)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    ref = DA.paged_decode_ref(q, *pool, pos, window=window, cap=50.0)
    bound = DA.error_bound(q, *pool, pos, window=window, cap=50.0)
    assert bool(((got - ref).abs() <= bound).all())


@pytest.mark.parametrize("m", [1, 4, 16, 20, 1024])
def test_tied_lm_head_layouts_give_the_same_bits(cuda, m):
    """The tied lm_head reads W = embedᵀ through its strides (K
    contiguous); the same matrix made contiguous gives the same bits on
    every tile (decode, small, large: F2, the k16 steps are the same),
    within the bound of the plain version."""
    g = torch.Generator(device=cuda).manual_seed(m)
    vocab, d = 16384, 3584
    embed = (torch.randn((vocab, d), generator=g, device=cuda) * 0.02).to(
        torch.bfloat16)
    a = torch.randn((m, d), generator=g, device=cuda).to(torch.bfloat16)
    view = embed.t()
    assert view.stride() == (1, d)
    got = ops.sa_matmul(a, view)
    want = ops.sa_matmul(a, view.contiguous())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    ref = MM.sa_matmul_ref(a, view)
    assert bool(((got - ref).abs() <= MM.error_bound(a, view, y=ref)).all())


def test_engine_refuses_a_ring_that_does_not_split_into_pages(cuda):
    """On the card a local ring is walked as pages: a window of 8 rows
    over pages of 16 is refused at construction with the page size named;
    pages of 8 serve."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine

    cfg = reduced_config("gemma3-12b")
    params = M.init_params(cfg, seed=0, device=cuda)
    with pytest.raises(ValueError, match="page size"):
        ServeEngine(cfg, params, batch=2, cache_len=32, page_size=16)
    ServeEngine(cfg, params, batch=2, cache_len=32, page_size=8)


@pytest.mark.parametrize("arch", ["gemma3-12b", "gemma2-9b"])
def test_serve_local_window_family_paged_equals_ring(cuda, arch,
                                                     monkeypatch):
    """gemma at full width, cut to one superblock and a window of 32
    (two pages) so that prompts of 40-50 tokens wrap the rings: the paged
    and ring streams launch every kernel of the path (prefill at hd 256),
    no plain version, and give one token stream (both decode through the
    paged-decode kernel)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import SlotScheduler

    monkeypatch.setenv("REPRO_GEMM_BACKEND", "cuda")
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=full.stack_period, window=32)
    params = M.init_params(cfg, seed=1, device=cuda)
    streams = {}
    for layout in ("paged", "ring"):
        eng = ServeEngine(cfg, params, batch=2, cache_len=64, eos_id=-1,
                          sync_every=4, kv_layout=layout)
        assert not eng.prefix_caching_on() and not eng.bucketing_on()
        sched = SlotScheduler(2, eos_id=-1)
        _submit(sched, cfg, (45, 20, 50), ("premium",) * 3, max_new=6)
        ops.reset_counts()
        summary = eng.serve(sched)
        c = ops.counts()
        for name in ("sa_matmul", "paged_decode", "prefill_attention"):
            assert c[name]["launches"] > 0, (layout, c)
        assert all(v["plain_calls"] == 0 for v in c.values()), (layout, c)
        assert ops.route_counts()["prefill_attention"]["simt"] == 0
        assert summary["nonfinite_logits"] == 0
        streams[layout] = {r.rid: r.tokens for r in sched.finished}
        del eng
    assert streams["paged"] == streams["ring"]
    assert all(len(t) == 6 for t in streams["paged"].values())


# ---------------------------------------------------------------------------
# the MoE family: the routers' narrow GEMMs, the expert dispatch, serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [4, 20, 128])
@pytest.mark.parametrize("name,k,n", GC.ROUTER_GEMMS)
def test_router_gemm_matches_plain(cuda, name, k, n, m):
    """The routers' N = 40 and 128 (and a narrow 8), narrower than any
    other served GEMM, so a 64-column tile is partial: on `mma`, within
    the bound, and a row's bits the same alone as inside the batch (F2)."""
    g = torch.Generator(device=cuda).manual_seed(m + n)
    a = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn((k, n), generator=g, device=cuda) * k ** -0.5).to(
        torch.bfloat16)
    ops.reset_counts()
    got = ops.sa_matmul(a, w)
    assert ops.route_counts()["sa_matmul"]["mma"] == 1
    ref = MM.sa_matmul_ref(a, w)
    assert bool(((got - ref).abs() <= MM.error_bound(a, w, y=ref)).all())
    one = ops.sa_matmul(a[m - 1:], w)
    assert torch.equal(one.view(torch.int32), got[m - 1:].view(torch.int32))


def _moe_layer(cuda, experts=8, k=2):
    """granite's expert shapes (D 1536, F 512) with `experts` experts of
    top-`k`, bf16 weights drawn from a seed."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"),
                              num_experts=experts, experts_per_token=k)
    g = torch.Generator(device=cuda).manual_seed(3)
    d, f = cfg.d_model, cfg.d_ff

    def w(*shape):
        return (torch.randn(shape, generator=g, device=cuda)
                * shape[-2] ** -0.5).to(torch.bfloat16)

    p = {"router": w(d, experts), "wg": w(experts, d, f),
         "wu": w(experts, d, f), "wd": w(experts, f, d)}
    x = torch.randn((2, 24, d), generator=g, device=cuda).to(torch.bfloat16)
    return cfg, p, x


@pytest.mark.parametrize("dropless", [True, False])
def test_moe_ffn_cuda_matches_torch_and_repeats_its_bits(cuda, dropless):
    """The MoE FFN (8 experts, top-2; capacity 8 of 24 tokens drops some)
    under `cuda`: every GEMM an SA GEMM launch (router, 3 an expert), the
    same bits on a second run (the capacity combine adds each expert's
    rows once), and within 2⁻⁶·max of the `torch` backend (bf16 output:
    a last-bit fp32 difference may flip one bf16 rounding of h or y)."""
    from repro_torch.core.precision import PrecisionPolicy as P
    from repro_torch.core.precision import use_policy
    from repro_torch.models import moe as MOE

    cfg, p, x = _moe_layer(cuda)
    runs = []
    for _ in range(2):
        ops.reset_counts()
        with use_policy(P(backend="cuda")):
            runs.append(MOE.moe_ffn(x, p, cfg, dropless=dropless)[0])
        c = ops.counts()["sa_matmul"]
        assert c["launches"] == 1 + 3 * cfg.num_experts, c
        assert c["plain_calls"] == 0
    assert torch.equal(runs[0].view(torch.int16), runs[1].view(torch.int16))
    with use_policy(P(backend="torch")):
        ref = MOE.moe_ffn(x, p, cfg, dropless=dropless)[0].float()
    got = runs[0].float()
    assert float((got - ref).abs().max()) <= 2.0 ** -6 * float(
        ref.abs().max())


def _moe_steps(eng, sched) -> int:
    """The decode steps a plain serve ran: the warm-up chunk and one chunk
    a scheduler observation, each `sync_every` steps."""
    return eng.sync_every * (1 + len(sched.depth_samples))


def test_serve_moe_full_width_two_layers_paged_equals_ring(cuda,
                                                           monkeypatch):
    """granite at full width cut to two layers (40 experts, top-8): the
    paged and ring serves give one token stream, each launching the SA
    GEMM exactly as the dropless dispatch implies (`moe.gemm_calls` a
    prefill and a decode step), paged decode L a step, prefill L a
    request, on `mma`, and no plain version."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import SlotScheduler

    monkeypatch.setenv("REPRO_GEMM_BACKEND", "cuda")
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"),
                              num_layers=2)
    params = M.init_params(cfg, seed=1, device=cuda)
    streams = {}
    for layout in ("paged", "ring"):
        eng = ServeEngine(cfg, params, batch=2, cache_len=64, eos_id=-1,
                          sync_every=4, kv_layout=layout)
        sched = SlotScheduler(2, eos_id=-1)
        _submit(sched, cfg, (45, 20, 50), ("premium",) * 3, max_new=6)
        ops.reset_counts()
        summary = eng.serve(sched)
        c = ops.counts()
        steps = _moe_steps(eng, sched)
        assert c["sa_matmul"]["launches"] == sum(
            moe.gemm_calls(cfg, len(r.prompt)) for r in sched.finished
        ) + steps * moe.gemm_calls(cfg), (layout, c)
        assert c["paged_decode"]["launches"] == 2 * steps
        assert c["prefill_attention"]["launches"] == 2 * 3
        assert all(v["plain_calls"] == 0 for v in c.values()), (layout, c)
        routes = ops.route_counts()
        assert routes["sa_matmul"]["mma"] == c["sa_matmul"]["launches"]
        assert routes["prefill_attention"]["simt"] == 0
        assert summary["nonfinite_logits"] == 0
        if layout == "paged":
            assert summary["pages_leaked"] == 0
        else:
            assert "pages_leaked" not in summary
        streams[layout] = {r.rid: r.tokens for r in sched.finished}
        del eng
    assert streams["paged"] == streams["ring"]
    assert all(len(t) == 6 for t in streams["paged"].values())


@pytest.mark.parametrize("arch,experts", [("granite-moe-3b-a800m", None),
                                          ("llama4-maverick-400b-a17b", 4)])
def test_moe_decode_step_launches_the_dispatch_s_gemms(cuda, monkeypatch,
                                                       arch, experts):
    """One decode step of a full-width stack cut to two layers (llama4:
    its dense layer at d_ff 16384 and a MoE layer cut to 4 experts, with
    the shared expert) launches exactly `moe.gemm_calls(cfg)` SA GEMMs:
    4 + 1 + 3E (+ 3 shared) a MoE layer, 7 a dense one, and the lm_head;
    all on `mma`'s decode tile."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.serve.engine import ServeEngine

    monkeypatch.setenv("REPRO_GEMM_BACKEND", "cuda")
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=2,
                              num_experts=experts or full.num_experts)
    params = M.init_params(cfg, seed=0, device=cuda)
    eng = ServeEngine(cfg, params, batch=4, cache_len=32, eos_id=-1)
    cache = eng.new_cache()
    ops.reset_counts()
    logits, _ = eng._serve_step(
        params, torch.zeros((4, 1), dtype=torch.int32, device=cuda), cache,
        torch.zeros((4,), dtype=torch.int32, device=cuda))
    torch.cuda.synchronize()
    want = moe.gemm_calls(cfg)
    assert ops.counts()["sa_matmul"]["launches"] == want
    assert ops.tile_counts()["decode"] == want
    assert bool(torch.isfinite(logits[..., :cfg.vocab_size]).all())


@pytest.mark.parametrize("m,tile", [(4, "decode"), (128, "small"),
                                    (1024, "large")])
def test_ragged_ssm_weight_is_read_in_place(cuda, m, tile):
    """hymba's in_proj (1600 × 6482, N not a multiple of 8) as the model
    stores it (`matrix_storage`: rows of 6488): each tile reads it in
    place (no operand copied), writes the ragged output's rows right
    (within the plain version's bound) and gives the bits of the same
    matrix stored contiguous, which the launch has to copy."""
    from repro_torch.models.model import matrix_storage

    k, n = 1600, 6482
    g = torch.Generator(device=cuda).manual_seed(m)
    w = matrix_storage((k, n), torch.bfloat16, cuda)
    w.copy_(torch.randn((k, n), generator=g, device=cuda) * k ** -0.5)
    assert w.stride() == (6488, 1)
    a = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
    ops.reset_counts()
    got, _ = MM._launch(a, w, None, None, "none", "exact", False, tile=tile)
    assert ops.operand_copies() == 0
    cont, _ = MM._launch(a, w.contiguous(), None, None, "none", "exact",
                         False, tile=tile)
    assert ops.operand_copies() == 1
    ref = MM.sa_matmul_ref(a, w)
    assert bool(((got - ref).abs() <= MM.error_bound(a, w, y=ref)).all())
    assert torch.equal(got.view(torch.int32), cont.view(torch.int32))


def _ssm_cut(arch):
    """mamba2 at full width cut to two layers; hymba at full width cut to
    a global and a local layer with a 64-token window (so prompts of
    45-80 tokens wrap its ring)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if cfg.hybrid:
        return dataclasses.replace(cfg, num_layers=2, window=64,
                                   attn_pattern=("global", "local"))
    return dataclasses.replace(cfg, num_layers=2)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "hymba-1.5b"])
def test_serve_ssm_full_width_two_layers_paged_equals_ring(cuda, monkeypatch,
                                                           arch):
    """The SSM and hybrid families at full width cut to two layers: the
    engine asked for paged and for ring gives one token stream (mamba2
    serves on rows either way), each kernel launched exactly as the
    forwards imply (`model.gemm_calls` SA GEMMs a forward; paged decode
    and prefill attention once a layer with attention), every GEMM on
    `mma`, no plain version, no operand copied; and prefill then decode
    equals a full forward (tests/test_decode.py's contract)."""
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import SlotScheduler

    monkeypatch.setenv("REPRO_GEMM_BACKEND", "cuda")
    cfg = _ssm_cut(arch)
    params = M.init_params(cfg, seed=1, device=cuda)
    attn = 0 if cfg.family == "ssm" else cfg.num_layers
    streams = {}
    for layout in ("paged", "ring"):
        eng = ServeEngine(cfg, params, batch=2, cache_len=96, eos_id=-1,
                          sync_every=4, kv_layout=layout)
        assert eng.kv_layout == ("ring" if cfg.family == "ssm" else layout)
        sched = SlotScheduler(2, eos_id=-1)
        _submit(sched, cfg, (45, 20, 80), ("premium",) * 3, max_new=6)
        ops.reset_counts()
        summary = eng.serve(sched)
        c = ops.counts()
        steps = _moe_steps(eng, sched)
        assert c["sa_matmul"]["launches"] == (3 + steps) * M.gemm_calls(cfg)
        assert c["paged_decode"]["launches"] == attn * steps
        assert c["prefill_attention"]["launches"] == attn * 3
        assert all(v["plain_calls"] == 0 for v in c.values()), (layout, c)
        assert ops.operand_copies() == 0
        assert ops.route_counts()["sa_matmul"]["mma"] == \
            c["sa_matmul"]["launches"]
        assert summary["nonfinite_logits"] == 0
        assert summary.get("pages_leaked", 0) == 0
        streams[layout] = {r.rid: r.tokens for r in sched.finished}
    assert streams["paged"] == streams["ring"]
    assert all(len(t) == 6 for t in streams["paged"].values())
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (1, 300), generator=g).to(cuda)
    # a cache that holds all 300 tokens (the engine's rings hold 96)
    full, _, _ = M.forward(params, cfg, toks, cache=M.init_cache(
        cfg, 1, 304, dtype=torch.float32, device=cuda))
    cache = M.init_cache(cfg, 1, 304, dtype=torch.float32, device=cuda)
    steps = [M.forward(params, cfg, toks[:, :297], cache=cache)[0][:, -1:]]
    for t in range(297, 300):
        steps.append(M.forward(params, cfg, toks[:, t:t + 1], cache=cache,
                               pos=t)[0])
    got = torch.cat(steps, dim=1)[..., :cfg.vocab_size]
    want = full[:, 296:, :cfg.vocab_size]
    assert float((got - want).abs().max()) <= 2.0 ** -5 * float(
        want.abs().max())


# ---------------------------------------------------------------------------
# the autotuner (kernels/autotune.py): tiles and cluster sizes on the card
# ---------------------------------------------------------------------------

# qwen2.5-14b's decode GEMMs as (N, K): wq and wo, wk and wv, wg and wu,
# wd, the lm_head
QWEN_NK = [(5120, 5120), (1024, 5120), (13824, 5120), (5120, 13824),
           (152064, 5120)]


@pytest.fixture
def tune_cache(tmp_path, monkeypatch):
    from repro_torch.kernels import autotune as AT
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    AT.reset()
    yield AT
    AT.reset()


@pytest.mark.parametrize("m", [4, 20])
@pytest.mark.parametrize("w_layout", ["n_contiguous", "k_contiguous"])
def test_every_tuned_tile_gives_the_heuristic_tiles_bits(cuda, tune_cache,
                                                         m, w_layout):
    """Every GEMM candidate the tuner sweeps gives the heuristic tile's
    output bit for bit (ROADMAP F2: K is never split), at qwen's decode
    (M = 4) and verify (M = 20) shapes, on W as the layers store it (N
    contiguous) and as the tied lm_head reads it (`embed.t()`, K
    contiguous)."""
    AT = tune_cache
    g = torch.Generator(device=cuda).manual_seed(m)
    for n, k in QWEN_NK:
        a = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
        if w_layout == "n_contiguous":
            w = (torch.randn((k, n), generator=g, device=cuda)
                 * k ** -0.5).to(torch.bfloat16)
        else:
            w = (torch.randn((n, k), generator=g, device=cuda)
                 * k ** -0.5).to(torch.bfloat16).t()
        bias = torch.randn((n,), generator=g, device=cuda)
        want, _ = MM._launch(a, w, bias, None, "none", "exact", False,
                             tile=AT.default_tile(m, n))
        for tile in AT.candidates_for(m, n, k):
            got, _ = MM._launch(a, w, bias, None, "none", "exact", False,
                                tile=tile)
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32)), (n, k, tile)
        del a, w


def test_tuned_tile_reaches_ops_sa_matmul(cuda, tune_cache):
    """A cached tile is the one `ops.sa_matmul` launches (tile_counts),
    with the heuristic tile's bits; a real sweep on the card times every
    candidate and writes the file."""
    AT = tune_cache
    g = torch.Generator(device=cuda).manual_seed(5)
    a = torch.randn((4, 5120), generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn((5120, 1024), generator=g, device=cuda)
         * 5120 ** -0.5).to(torch.bfloat16)
    ops.reset_counts()
    want = ops.sa_matmul(a, w, act="silu")
    assert ops.tile_counts()["decode"] == 1 and AT.MISSES == 1
    AT.tune(4, 1024, 5120, timer=lambda t: 1.0 if t == "small" else 9.0)
    ops.reset_counts()
    got = ops.sa_matmul(a, w, act="silu")    # the epilogue key falls back
    assert ops.tile_counts() == {"large": 0, "small": 1, "decode": 0,
                                 "split3": 0}
    assert ops.counts()["sa_matmul"]["launches"] == 1 and AT.MISSES == 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    ops.reset_counts()
    tile, table = AT.tune(4, 5120, 5120)
    assert {r["tile"] for r in table} == {"decode", "small", "large"}
    assert all(r["us"] > 0 for r in table) and tile == table[0]["tile"]
    # the sweep's launches are not counted
    assert ops.tile_counts() == {"large": 0, "small": 0, "decode": 0,
                                 "split3": 0}
    AT.reset()
    assert AT.lookup(4, 5120, 5120) == tile        # from the file


def test_every_tuned_n_split_within_the_bound_and_slots_fold(cuda,
                                                             tune_cache):
    """Every cluster size the tuner sweeps is within `error_bound` of the
    plain version at the serve shape (144-token slots); with the tuned
    plan (looked up, no n_split given) a slot's bits are the same at B = 4
    and inside B = 20."""
    AT = tune_cache
    lens = SERVE_LENS
    q, k, v, pp, bt, pos = _pool(cuda, P=9, lens=lens)
    pol = PrecisionPolicy(input_format="bf16")
    ref = DA.paged_decode_ref(q, k, v, pp, bt, pos, policy=pol)
    bound = DA.error_bound(q, k, v, pp, bt, pos, policy=pol)
    cands = AT.decode_attn_candidates(5, 128, 16, 9)
    assert len(cands) > 1
    for n in cands:
        got = DA.paged_decode_cuda(q, k, v, pp, bt, pos, policy=pol,
                                   n_split=n)
        assert bool(((got - ref).abs() <= bound).all()), n
        assert bool((got[lens.index(0)] == 0).all())
    n, table = AT.tune_decode_attn(4, 8, 5, 128, 16, 9)
    assert sorted(r["n_split"] for r in table) == sorted(cands)
    lens20 = lens + tuple((37 * i) % 144 + 1 for i in range(16))
    q, k, v, pp, bt, pos = _pool(cuda, B=20, P=9, lens=lens20)
    y20 = ops.paged_decode_attention(q, k, v, pp, bt, pos, policy=pol)
    y4 = ops.paged_decode_attention(q[:4], k, v, pp, bt[:4], pos[:4],
                                    policy=pol)
    assert torch.equal(y4.view(torch.int32), y20[:4].view(torch.int32))
    forced = DA.paged_decode_cuda(q[:4], k, v, pp, bt[:4], pos[:4],
                                  policy=pol, n_split=n)
    assert torch.equal(forced.view(torch.int32), y4.view(torch.int32))
    assert AT.MISSES == 0


def test_no_sweep_during_a_cuda_graph_capture(cuda, tune_cache):
    """A lookup asked to sweep while a CUDA graph is being captured falls
    back to the heuristic (the timing would be captured, not run)."""
    AT = tune_cache
    x = torch.zeros(1, device=cuda)
    graph = torch.cuda.CUDAGraph()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        x.add_(1)
    torch.cuda.current_stream().wait_stream(s)
    with torch.cuda.graph(graph):
        tile = AT.lookup(4, 5120, 5120, sweep=True)
        n = AT.lookup_decode_attn(5, 128, 16, 9, sweep=True, batch=4, kvh=8)
        x.add_(1)
    graph.replay()
    torch.cuda.synchronize()
    assert tile == "decode" and n == DA.split_plan(5, 128, 16, 9).n_split
    assert AT.SWEPT == [] and AT.MISSES == 2
    assert AT.lookup(4, 5120, 5120, sweep=True) in AT.MMA_CANDIDATES
    assert len(AT.SWEPT) == 1


# ---------------------------------------------------------------------------
# serving under the model axis: a rank's heads, padded heads, the row
# shards' fp32 chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["paged", "ring"])
def test_padded_pool_serves_the_unpadded_stream_phi3_two_layers(
        cuda, monkeypatch, layout):
    """phi3-medium-14b at full width cut to two layers in one process: a
    cache whose 10 KV heads are padded to 12 (`kv_pad_to=4`, what a
    (1, 4) mesh holds across its ranks) serves the unpadded stream, every
    kernel launched, no plain version."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import stream_digest
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import SlotScheduler

    monkeypatch.setenv("REPRO_GEMM_BACKEND", "cuda")
    cfg = dataclasses.replace(get_config("phi3-medium-14b"), num_layers=2)
    params = M.init_params(cfg, seed=0, device=cuda)
    digests = []
    for pad in (1, 4):
        eng = ServeEngine(cfg, params, batch=2, cache_len=48, eos_id=-1,
                          sync_every=4, kv_layout=layout)
        # the caches a (1, 4) mesh's engine builds, whole in one process
        eng._heads = lambda pad=pad: {"kv_pad_to": pad, "kv_shards": 1}
        sched = SlotScheduler(2, eos_id=-1)
        _submit(sched, cfg, (17, 40, 9), ("premium",) * 3)
        ops.reset_counts()
        summary = eng.serve(sched)
        c = ops.counts()
        for name in ("sa_matmul", "paged_decode", "prefill_attention"):
            assert c[name]["launches"] > 0, c
        assert all(v["plain_calls"] == 0 for v in c.values()), c
        assert summary["nonfinite_logits"] == 0
        cache = eng.new_pool() if layout == "paged" else eng.new_cache()
        assert cache[0]["kv"].k.shape[-2] == (12 if pad == 4 else 10)
        digests.append(stream_digest(sched.finished))
        del eng, cache
    assert digests[0] == digests[1]


@pytest.mark.parametrize("kvh,grp,lo,hi", [
    (8, 5, 4, 8),     # qwen at (1, 2): rank 1's 4 KV heads, g = 5
    (8, 5, 2, 4),     # qwen at (1, 4): rank 1's 2
    (12, 4, 9, 12)])  # phi3 at (1, 4): 10 heads padded to 12, rank 3's 3
def test_paged_decode_on_a_rank_s_heads(cuda, kvh, grp, lo, hi):
    """The paged decode over a rank's slice of KV heads (and their Q
    heads) at the serve shape: within the plain version's bound, and the
    same bits as those heads of the whole pool's decode (the cluster is
    planned from (g, hd, page, pages) alone, never the head count). Under
    phi3's padding the padded heads are zeros, their outputs zeros."""
    q, k, v, pp, bt, pos = _pool(cuda, KVH=kvh, grp=grp)
    if kvh == 12:
        k[:, :, 10:] = v[:, :, 10:] = 0.0
        k[0] = v[0] = float("nan")
        q[:, :, 10 * grp:] = 0.0
    pol = PrecisionPolicy(input_format="bf16")
    whole = ops.paged_decode_attention(q, k, v, pp, bt, pos, policy=pol)
    qs = q[:, :, lo * grp:hi * grp].contiguous()
    ks, vs = k[:, :, lo:hi].contiguous(), v[:, :, lo:hi].contiguous()
    got = ops.paged_decode_attention(qs, ks, vs, pp, bt, pos, policy=pol)
    ref = DA.paged_decode_ref(qs, ks, vs, pp, bt, pos, policy=pol)
    bound = DA.error_bound(qs, ks, vs, pp, bt, pos, policy=pol)
    assert bool(((got - ref).abs() <= bound).all())
    assert torch.equal(got.view(torch.int32),
                       whole[:, :, lo * grp:hi * grp].contiguous().view(
                           torch.int32))
    if kvh == 12:
        assert not whole[:, :, 10 * grp:].any()


@pytest.mark.parametrize("fmt", ["bf16", "fp32"])
def test_prefill_over_padded_heads(cuda, fmt):
    """phi3's prefill on a (1, 4) mesh: 40 Q heads over 10 KV heads
    padded to 48 over 12 (zero K, V and Q), a rank's 12 over 3. Within
    the plain version's bound; the real heads carry the unpadded call's
    bits, a padded head's output is zeros."""
    g = torch.Generator(device=cuda).manual_seed(12)
    T, hd = 128, 128
    q = torch.randn((1, T, 40, hd), generator=g, device=cuda)
    k = torch.randn((1, T, 10, hd), generator=g, device=cuda)
    v = torch.randn((1, T, 10, hd), generator=g, device=cuda)
    pol = PrecisionPolicy(input_format=fmt)
    pad = torch.nn.functional.pad
    qp, kp, vp = pad(q, (0, 0, 0, 8)), pad(k, (0, 0, 0, 2)), pad(
        v, (0, 0, 0, 2))
    whole = ops.sa_attention(q, k, v, policy=pol)
    for r in range(4):
        qs = qp[:, :, 12 * r:12 * (r + 1)].contiguous()
        ks = kp[:, :, 3 * r:3 * (r + 1)].contiguous()
        vs = vp[:, :, 3 * r:3 * (r + 1)].contiguous()
        got = ops.sa_attention(qs, ks, vs, policy=pol)
        ref = FA.flash_attention_ref(qs, ks, vs, policy=pol)
        bound = FA.error_bound(qs, ks, vs, policy=pol)
        assert bool(((got - ref).abs() <= bound).all())
        real = min(12, 40 - 12 * r)
        assert torch.equal(
            got[:, :, :real].contiguous().view(torch.int32),
            whole[:, :, 12 * r:12 * r + real].contiguous().view(torch.int32))
        assert not got[:, :, real:].any()


@pytest.mark.parametrize("k,n", [(5120, 5120), (13824, 5120)])
def test_row_shard_chain_on_the_decode_tile(cuda, k, n):
    """The row-parallel partial (`sa_dot_chain`, the exact chain in fp32)
    at M = 4 over a rank's K / 2 rows, on the decode tile: within the
    plain chain's bound; and a column shard of a bf16 GEMM carries the
    whole GEMM's bits per column (F2)."""
    from repro_torch.core.precision import sa_dot, sa_dot_chain

    g = torch.Generator(device=cuda).manual_seed(k + n)
    a = torch.randn((4, k // 2), generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn((k // 2, n), generator=g, device=cuda)
         * k ** -0.5).to(torch.bfloat16)
    ops.reset_counts()
    got = sa_dot_chain(a, w, PrecisionPolicy(backend="cuda"))
    assert ops.counts()["sa_matmul"]["launches"] == 1
    assert got.dtype == torch.float32
    ref = sa_dot_chain(a, w, PrecisionPolicy(backend="torch"))
    assert bool(((got - ref).abs() <= MM.error_bound(a, w, y=ref)).all())
    pol = PrecisionPolicy(backend="cuda")
    whole = sa_dot(a, w, pol)
    for r in range(2):
        part = sa_dot(a, w[:, r * n // 2:(r + 1) * n // 2].contiguous(), pol)
        assert torch.equal(part, whole[:, r * n // 2:(r + 1) * n // 2])


@pytest.mark.parametrize("m", [4, 20, 512])
def test_expert_shard_pieces_at_model_16(cuda, m):
    """granite's experts on the JAX production mesh's `model` axis of 16,
    which its 40 experts do not divide (tensor parallelism inside each
    expert): wg and wu as (1536, 32) column pieces, each within its plain
    version's bound and carrying the whole (1536, 512) call's bits per
    column (F2); wd as a row chain over K = 32 (two k16 steps) within
    the plain chain's bound."""
    from repro_torch.core.precision import sa_dot_chain

    d, f, tp = 1536, 512, 16
    g = torch.Generator(device=cuda).manual_seed(1600 + m)
    a = torch.randn((m, d), generator=g, device=cuda).to(torch.bfloat16)
    for act in ("silu", "none"):          # wg (its activation), wu
        w = (torch.randn((d, f), generator=g, device=cuda)
             * d ** -0.5).to(torch.bfloat16)
        whole = ops.sa_matmul(a, w, act=act)
        for r in range(tp):
            ws = w[:, r * f // tp:(r + 1) * f // tp].contiguous()
            got = ops.sa_matmul(a, ws, act=act)
            ref = MM.sa_matmul_ref(a, ws, act=act)
            assert bool(((got - ref).abs()
                         <= MM.error_bound(a, ws, y=ref)).all())
            assert torch.equal(got.view(torch.int32), whole[
                :, r * f // tp:(r + 1) * f // tp].contiguous().view(
                    torch.int32))
    h = torch.randn((m, f // tp), generator=g, device=cuda).to(
        torch.bfloat16)
    wd = (torch.randn((f // tp, d), generator=g, device=cuda)
          * f ** -0.5).to(torch.bfloat16)
    ops.reset_counts()
    got = sa_dot_chain(h, wd, PrecisionPolicy(backend="cuda"))
    assert ops.counts()["sa_matmul"]["launches"] == 1
    ref = sa_dot_chain(h, wd, PrecisionPolicy(backend="torch"))
    assert got.dtype == torch.float32
    assert bool(((got - ref).abs() <= MM.error_bound(h, wd, y=ref)).all())


def _lse_case(cuda, grp, hd, pool):
    """`_pool`'s four slots (144, 100, 40 and 0 tokens: the last fully
    masked) at g = grp, hd, the pools in `pool`'s type."""
    q, k, v, pp, bt, pos = _pool(cuda, grp=grp, hd=hd)
    return q, k.to(pool), v.to(pool), pp, bt, pos


@pytest.mark.parametrize("pool", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grp,hd", [(5, 128), (2, 256)])
def test_decode_lse_matches_plain(cuda, grp, hd, pool):
    """The decode kernel's log-sum-exp output (the fold of a ring split
    over `data`) against its plain twin's within `lse_error_bound`, the
    attention itself within `error_bound` and the same bits as without
    the output; a slot whose keys are all masked gives lse -inf and zeros,
    no NaN."""
    q, k, v, pp, bt, pos = _lse_case(cuda, grp, hd, pool)
    pol = PrecisionPolicy(input_format="bf16")
    o, lse = DA.paged_decode_cuda(q, k, v, pp, bt, pos, policy=pol,
                                  lse=True)
    plain = DA.paged_decode_cuda(q, k, v, pp, bt, pos, policy=pol)
    assert torch.equal(o.view(torch.int32), plain.view(torch.int32))
    o_ref, lse_ref = DA.paged_decode_ref(q, k, v, pp, bt, pos, policy=pol,
                                         lse=True)
    bound = DA.error_bound(q, k, v, pp, bt, pos, policy=pol)
    assert bool(((o - o_ref).abs() <= bound).all())
    live = torch.isfinite(lse_ref)
    assert live[:3].all() and not live[3].any()
    assert torch.equal(torch.isfinite(lse), live)
    lb = DA.lse_error_bound(q, k, v, pp, bt, pos, policy=pol)
    assert bool(((lse - lse_ref).abs()[live] <= lb[live]).all())
    assert not torch.isnan(o).any() and not o[3].any()


def _halves(bt, pos, psz=16):
    """Each slot's pages split into its first and second half of keys
    (the pages not in a half unmapped): two block tables."""
    first, second = bt.clone(), bt.clone()
    for b in range(bt.shape[0]):
        n = int(pos[b]) // psz + 1
        first[b, n // 2:] = -1
        second[b, :n // 2] = -1
    return first, second


@pytest.mark.parametrize("mode", ["exact", "approx"])
@pytest.mark.parametrize("grp,hd", [(5, 128), (2, 256)])
def test_fold_of_two_halves_matches_the_whole(cuda, grp, hd, mode):
    """Each slot's keys split into two halves, each half's attention with
    its log-sum-exp from the kernel, folded (`layers.fold_partials`): the
    whole slot's kernel output within `error_bound(folded=True)`. The
    fully masked slot folds to zeros."""
    from repro_torch.models.layers import fold_partials

    q, k, v, pp, bt, pos = _lse_case(cuda, grp, hd, torch.bfloat16)
    pol = PrecisionPolicy(input_format="bf16", mode=mode)
    whole = DA.paged_decode_cuda(q, k, v, pp, bt, pos, policy=pol)
    parts = [DA.paged_decode_cuda(q, k, v, pp, t, pos, policy=pol, lse=True)
             for t in _halves(bt, pos)]
    got = fold_partials(torch.stack([o for o, _ in parts]),
                        torch.stack([s for _, s in parts]))
    bound = DA.error_bound(q, k, v, pp, bt, pos, policy=pol, folded=True)
    assert bool(((got - whole).abs() <= bound).all())
    assert not got[3].any() and not torch.isnan(got).any()


def test_fold_with_a_fully_masked_half_is_the_other_half(cuda):
    """A half whose keys are all masked (as every rank's but the first
    early in a batch-1 decode) gives lse -inf and zeros; the fold then
    returns the other half's output bit for bit."""
    from repro_torch.models.layers import fold_partials

    q, k, v, pp, bt, pos = _lse_case(cuda, 5, 128, torch.float32)
    pol = PrecisionPolicy(input_format="bf16")
    empty = torch.full_like(bt, -1)
    o0, s0 = DA.paged_decode_cuda(q, k, v, pp, empty, pos, policy=pol,
                                  lse=True)
    o1, s1 = DA.paged_decode_cuda(q, k, v, pp, bt, pos, policy=pol, lse=True)
    assert not torch.isfinite(s0).any() and not o0.any()
    got = fold_partials(torch.stack([o0, o1]), torch.stack([s0, s1]))
    assert torch.equal(got[:3].view(torch.int32), o1[:3].view(torch.int32))
    assert not got[3].any() and not torch.isnan(got).any()


# ---------------------------------------------------------------------------
# the dry run's meta routes (launch/cost.py): each meta route's choice is
# the launch's for the same shapes and types
# ---------------------------------------------------------------------------

def _dryrun_launches(fn, dev, *shapes):
    """(launches by kernel, route and tile) of `fn` on fresh tensors of
    `shapes` ((shape, dtype, requires_grad) each): on `dev` the ops
    counters' deltas, on meta the cost counter's record."""
    from repro_torch.launch.cost import CostCounter

    ts = [torch.randn(s, device=dev).to(dt).requires_grad_(g)
          if dev != "meta" else
          torch.empty(s, dtype=dt, device=dev, requires_grad=g)
          for s, dt, g in shapes]
    pol = PrecisionPolicy(backend="cuda")
    from repro_torch.core.precision import use_policy
    if dev == "meta":
        with use_policy(pol), CostCounter() as c:
            fn(*ts)
        s = c.summary()["launches"]
        return s["counts"], s["routes"], s["tiles"]
    ops.reset_counts()
    with use_policy(pol):
        fn(*ts)
    torch.cuda.synchronize()
    return ({k: v["launches"] for k, v in ops.counts().items()},
            ops.route_counts(), ops.tile_counts())


@pytest.mark.parametrize("m", [1, 4, 16, 17, 64, 256, 1024])
@pytest.mark.parametrize("k,n", [(5120, 1024), (5120, 13824), (13824, 5120),
                                 (1600, 6482)])
@pytest.mark.parametrize("dts", [("bf16", "bf16"), ("fp32", "bf16"),
                                 ("fp32", "fp32")])
def test_dryrun_sa_matmul_meta_route_is_the_launch(cuda, tune_cache, m, k, n,
                                                   dts):
    dt = {"bf16": torch.bfloat16, "fp32": torch.float32}
    shapes = [((m, k), dt[dts[0]], True), ((k, n), dt[dts[1]], True)]

    def fwd_bwd(a, w):
        ops.sa_matmul(a, w).sum().backward()
    assert (_dryrun_launches(fwd_bwd, "meta", *shapes)
            == _dryrun_launches(fwd_bwd, cuda, *shapes))


@pytest.mark.parametrize("fmt", ["bf16", "fp32"])
@pytest.mark.parametrize("T,S,hd,window", [(32, 32, 128, 0),
                                           (1024, 1024, 128, 0),
                                           (64, 96, 256, 32)])
def test_dryrun_prefill_meta_route_is_the_launch(cuda, fmt, T, S, hd,
                                                 window):
    from repro_torch.core.precision import use_policy

    shapes = [((2, T, 8, hd), torch.float32, False),
              ((2, S, 2, hd), torch.bfloat16, False),
              ((2, S, 2, hd), torch.bfloat16, False)]
    with use_policy(PrecisionPolicy(input_format=fmt)):
        def attend(q, k_, v):
            ops.sa_attention(q, k_, v, window=window, q_offset=S - T)
        assert (_dryrun_launches(attend, "meta", *shapes)
                == _dryrun_launches(attend, cuda, *shapes))


@pytest.mark.parametrize("grp,hd,psz,P", [(5, 128, 16, 9), (8, 128, 64, 512),
                                          (2, 256, 16, 128), (1, 64, 8, 4)])
def test_dryrun_decode_meta_plan_is_the_launch(cuda, tune_cache, grp, hd,
                                               psz, P):
    B, KVH = 4, 2
    q = torch.zeros((B, 1, KVH * grp, hd), device=cuda)
    pool = torch.zeros((B * P + 1, psz, KVH, hd), dtype=torch.bfloat16,
                       device=cuda)
    bt = torch.zeros((B, P), dtype=torch.int32, device=cuda)
    n = tune_cache.lookup_decode_attn(grp, hd, psz, P, dtype=pool.dtype,
                                      batch=B, kvh=KVH)
    on_card = DA.split_plan(grp, hd, psz, P, n_split=n)
    meta = DA.launch_plan(q.to("meta"), pool.to("meta"), pool.to("meta"),
                          bt.to("meta"))
    assert meta == on_card

    def decode(q_, kp, vp, pp, bt_, pos):
        ops.paged_decode_attention(q_, kp, vp, pp, bt_, pos, lse=True)
    shapes = [((B, 1, KVH * grp, hd), torch.float32, False),
              ((B * P + 1, psz, KVH, hd), torch.bfloat16, False),
              ((B * P + 1, psz, KVH, hd), torch.bfloat16, False),
              ((B * P + 1, psz), torch.int32, False),
              ((B, P), torch.int32, False), ((B,), torch.int32, False)]
    assert (_dryrun_launches(decode, "meta", *shapes)
            == _dryrun_launches(decode, cuda, *shapes))
