"""PyTorch port: each kernel's plain version against its JAX counterpart
(the Pallas kernels in interpret mode, as the JAX tests run them). The
hand-written kernels against their plain versions, on the card, are in
tests/test_torch_gpu.py.

Tolerances (R1: the fp32 summation order is not fixed across
implementations, so nothing here is asserted bit-equal):
  * SA GEMM — `sa_matmul.error_bound`: 2·K·2⁻²⁴·Σ|a||w| reassociation,
    one truncation quantum (2⁻¹⁹·Σ|a||w|) in approx mode, a few ulp of
    |y| for the epilogue, plus 2⁻²⁰·|x| for gelu/silu's last bits;
  * attention — the module's `error_bound`, per output from the plain
    version's own terms: the softmax weights' drift from the fp32 q·k
    reassociation (Σ|q||k| per key), the rounding of P to the input format
    (a flip of one ulp where a rounding boundary lies within that drift for
    paged decode; one rounding per side for prefill, whose tiles round P
    against different running maxima) and the fp32 P·V sums, each weighted
    by Σ_j p_j|v_jd|. `test_*_bound_rejects_planted_fault` shows the bound
    is tight enough to catch an off-by-one mask or a dropped page.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the parity tests need the JAX package; the card's machine has no JAX and
# runs tests/test_torch_gpu.py instead
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import precision as JP  # noqa: E402
from repro.kernels.sa_attention import sa_attention as j_sa_attention  # noqa: E402,E501
from repro.kernels.sa_decode_attention import (  # noqa: E402
    sa_paged_decode_attention as j_paged)
from repro.kernels.sa_matmul import sa_matmul_pallas  # noqa: E402
from repro.models.layers import blockwise_attention as j_blockwise  # noqa: E402,E501
from repro_torch.core import precision as TP  # noqa: E402
from repro_torch.kernels import fp_emu as FE  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import sa_attention as FA  # noqa: E402
from repro_torch.kernels import sa_decode_attention as DA  # noqa: E402
from repro_torch.kernels import sa_matmul as MM  # noqa: E402

torch.set_num_threads(2)


def _bf16_values(x):
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


# ---------------------------------------------------------------------------
# SA GEMM: plain version vs the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n,act,with_bias,scale,mode", [
    (5, 37, 23, "none", True, None, "exact"),
    (3, 130, 17, "silu", True, 0.5, "approx"),
    (17, 64, 140, "gelu", False, 2.0, "exact"),
    (4, 96, 33, "relu", True, None, "approx"),
    (1, 200, 9, "silu", False, None, "exact"),
])
def test_sa_matmul_plain_matches_pallas(m, k, n, act, with_bias, scale,
                                        mode):
    rng = np.random.default_rng(m * 1000 + k)
    a = _bf16_values(rng.standard_normal((m, k)).astype(np.float32))
    w = _bf16_values((rng.standard_normal((k, n)) / np.sqrt(k)).astype(
        np.float32))
    bias = (rng.standard_normal(n) * 0.2).astype(np.float32) \
        if with_bias else None
    ref = np.array(sa_matmul_pallas(
        jnp.asarray(a), jnp.asarray(w),
        None if bias is None else jnp.asarray(bias), scale, act=act,
        interpret=True, mode=mode))
    ta, tw = torch.from_numpy(a), torch.from_numpy(w)
    tb = None if bias is None else torch.from_numpy(bias)
    got = ops.sa_matmul(ta, tw, bias=tb, act=act, scale=scale, mode=mode)
    pre = MM.sa_matmul_ref(ta, tw, tb, scale, mode=mode).numpy()
    bound = (MM.error_bound(ta, tw, scale, mode, y=torch.from_numpy(ref))
             .numpy() + 2.0 ** -20 * np.abs(pre))
    err = np.abs(got.numpy() - ref)
    assert (err <= bound).all(), float((err / bound).max())


def test_sa_matmul_rejects_bad_args():
    a, w = torch.zeros(2, 3), torch.zeros(3, 4)
    with pytest.raises(ValueError, match="act"):
        ops.sa_matmul(a, w, act="tanh")
    with pytest.raises(ValueError, match="mode"):
        ops.sa_matmul(a, w, mode="fast")
    with pytest.raises(ValueError, match="bias"):
        ops.sa_matmul(a, w, bias=torch.zeros(1, 4))


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper that launches a kernel never runs on the CPU: given CPU
    tensors it raises instead of falling back to the plain version."""
    a = torch.zeros(2, 64, dtype=torch.bfloat16)
    w = torch.zeros(64, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        MM.sa_matmul_cuda(a, w)
    q, k, v, pp, bt, pos = _paged_workload(0, 2, 1, 2, 32, 4, 3, [2, 1])
    with pytest.raises(ValueError, match="CUDA"):
        DA.paged_decode_cuda(*map(torch.from_numpy, (q, k, v, pp, bt, pos)))
    x = torch.zeros(1, 4, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        FA.sa_attention_cuda(x, x, x)
    with pytest.raises(ValueError, match="exact"):
        FA.sa_attention_cuda(x, x, x, policy=TP.PrecisionPolicy(
            mode="approx"))


def test_launch_counters_count_only_plain_calls_on_cpu():
    ops.reset_counts()
    a, w = torch.ones(2, 3), torch.ones(3, 4)
    ops.sa_matmul(a, w)
    c = ops.counts()
    assert c["sa_matmul"] == {"launches": 0, "plain_calls": 1}
    assert c["paged_decode"] == {"launches": 0, "plain_calls": 0}
    assert c["quantize"] == c["fp_emu"] == {"launches": 0, "plain_calls": 0}
    ops.quantize_fp8(a, 1.0, "fp8_e4m3")
    ops.skewed_datapath_matmul(a, w)
    ops.skewed_datapath_matmul(a, w, "fp8_e5m2", "approx")
    c = ops.counts()
    assert c["quantize"] == {"launches": 0, "plain_calls": 1}
    assert c["fp_emu"] == {"launches": 0, "plain_calls": 2}
    assert c["sa_matmul"] == {"launches": 0, "plain_calls": 1}
    ops.reset_counts()
    assert all(v == {"launches": 0, "plain_calls": 0}
               for v in ops.counts().values())


# ---------------------------------------------------------------------------
# paged decode: plain version vs the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

def _paged_workload(seed, batch, kvh, g, hd, psz, max_pages, mapped,
                    trash_entry=True):
    """Pool + block tables: slot b maps `mapped[b]` pages (0 = an empty,
    all-masked slot); the trash page 0 is NaN-poisoned and slot 0 carries
    an explicit page-0 entry, so a masking bug turns into a NaN."""
    rng = np.random.default_rng(seed)
    n_pages = batch * max_pages + 1
    q = rng.standard_normal((batch, 1, kvh * g, hd)).astype(np.float32)
    k = rng.standard_normal((n_pages, psz, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((n_pages, psz, kvh, hd)).astype(np.float32)
    k[0] = v[0] = np.nan
    pp = np.full((n_pages, psz), -1, np.int32)
    bt = np.full((batch, max_pages), -1, np.int32)
    for b in range(batch):
        pids = 1 + b * max_pages + np.arange(mapped[b])
        bt[b, :mapped[b]] = pids
        pp[pids] = np.arange(mapped[b] * psz, dtype=np.int32).reshape(
            mapped[b], psz)
    if trash_entry and mapped[0] > 1:
        bt[0, 1] = 0
    pos = np.array([max(m * psz - 2, 0) for m in mapped], np.int32)
    return q, k, v, pp, bt, pos


@pytest.mark.parametrize("fmt,mode,window,cap", [
    ("fp32", "exact", 0, 0.0),
    ("bf16", "exact", 5, 0.0),
    ("bf16", "exact", 0, 3.0),
    ("bf16", "approx", 7, 2.0),
    ("fp16", "exact", 0, 0.0),
])
def test_paged_decode_plain_matches_pallas(fmt, mode, window, cap):
    q, k, v, pp, bt, pos = _paged_workload(1, 3, 2, 2, 16, 4, 4, [3, 1, 0])
    jpol = JP.PrecisionPolicy(input_format=fmt, mode=mode)
    ref = np.array(j_paged(*map(jnp.asarray, (q, k, v, pp, bt, pos)),
                           window=window, cap=cap, policy=jpol,
                           interpret=True))
    tpol = TP.PrecisionPolicy(input_format=fmt, mode=mode)
    t = [torch.from_numpy(x) for x in (q, k, v, pp, bt, pos)]
    got = ops.paged_decode_attention(*t, window=window, cap=cap,
                                     policy=tpol).numpy()
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    assert (got[2] == 0).all()                 # all-masked slot
    bound = DA.error_bound(*t, window=window, cap=cap, policy=tpol).numpy()
    err = np.abs(got - ref)
    assert (err <= bound).all(), float((err / bound).max())


def test_paged_decode_gather_plain_is_decode_attention():
    """The plain version is exactly `gather_pages` + `decode_attention`."""
    from repro_torch.models.layers import (PagedKVCache, decode_attention,
                                           gather_pages)
    q, k, v, pp, bt, pos = map(torch.from_numpy, _paged_workload(
        2, 2, 2, 3, 16, 4, 3, [2, 3]))
    with TP.use_policy(TP.PrecisionPolicy()):
        a = DA.paged_decode_ref(q, k, v, pp, bt, pos, window=6)
        b = decode_attention(q, *gather_pages(PagedKVCache(k, v, pp, bt)),
                             pos, window=6)
    assert torch.equal(a, b)


def _drop_last_page(bt):
    bt = bt.clone()
    for b in range(bt.shape[0]):
        live = (bt[b] > 0).nonzero()
        if len(live):
            bt[b, live[-1]] = -1
    return bt


@pytest.mark.parametrize("fault", ["mask_off_by_one", "last_page_dropped"])
@pytest.mark.parametrize("fmt", ["bf16", "fp32"])
def test_paged_decode_bound_rejects_planted_fault(fault, fmt):
    """The stated bound is tight enough to tell a faulty decode from a
    correct one: the plain version with the token just written masked out
    (kv_pos < pos), or with each slot's last, partial page skipped, lands
    outside the bound of the correct one."""
    q, k, v, pp, bt, pos = map(torch.from_numpy, _paged_workload(
        3, 3, 2, 2, 32, 4, 4, [4, 3, 2], trash_entry=False))
    pol = TP.PrecisionPolicy(input_format=fmt)
    ref = DA.paged_decode_ref(q, k, v, pp, bt, pos, policy=pol)
    if fault == "mask_off_by_one":
        bad = DA.paged_decode_ref(q, k, v, pp, bt, pos - 1, policy=pol)
    else:
        bad = DA.paged_decode_ref(q, k, v, pp, _drop_last_page(bt), pos,
                                  policy=pol)
    bound = DA.error_bound(q, k, v, pp, bt, pos, policy=pol)
    assert float(((bad - ref).abs() / bound).max()) > 1.0


# ---------------------------------------------------------------------------
# prefill attention: plain version vs blockwise_attention / the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,S,kw", [
    (12, 12, {}),
    (12, 12, {"window": 5}),
    (12, 12, {"cap": 3.0}),
    (8, 16, {"q_offset": 8, "window": 6, "cap": 2.0}),
    (10, 10, {"causal": False}),
])
def test_prefill_plain_matches_blockwise_bf16(T, S, kw):
    rng = np.random.default_rng(T * 31 + S)
    q = rng.standard_normal((2, T, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, S, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, S, 2, 16)).astype(np.float32)
    with JP.use_policy(JP.PrecisionPolicy()):
        ref = np.array(j_blockwise(*map(jnp.asarray, (q, k, v)),
                                   block_q=4, block_kv=4, **kw))
    t = [torch.from_numpy(x) for x in (q, k, v)]
    pol = TP.PrecisionPolicy()
    got = FA.flash_attention_ref(*t, block_q=4, block_kv=4, policy=pol,
                                 **kw).numpy()
    bound = FA.error_bound(*t, policy=pol, **kw).numpy()
    assert (np.abs(got - ref) <= bound).all()


@pytest.mark.parametrize("fmt", ["bf16", "fp32"])
@pytest.mark.parametrize("T,kw", [
    (24, {"window": 9, "cap": 50.0}),      # gemma2's cap, a window that bites
    (20, {"window": 8}),                   # gemma3's local layers
    (16, {"q_offset": 8, "window": 6, "cap": 30.0})])
def test_prefill_plain_matches_blockwise_hd256(T, kw, fmt):
    """At head dim 256 (gemma2, gemma3: 16 heads over 8 KV heads, g = 2)
    the plain version stays within its bound of the JAX package's
    blockwise_attention, window and softcap included."""
    rng = np.random.default_rng(T + 256)
    S = T + kw.get("q_offset", 0)
    q = rng.standard_normal((1, T, 4, 256)).astype(np.float32)
    k = rng.standard_normal((1, S, 2, 256)).astype(np.float32)
    v = rng.standard_normal((1, S, 2, 256)).astype(np.float32)
    with JP.use_policy(JP.PrecisionPolicy(input_format=fmt)):
        ref = np.array(j_blockwise(*map(jnp.asarray, (q, k, v)),
                                   block_q=8, block_kv=8, **kw))
    t = [torch.from_numpy(x) for x in (q, k, v)]
    pol = TP.PrecisionPolicy(input_format=fmt)
    got = FA.flash_attention_ref(*t, block_q=8, block_kv=8, policy=pol,
                                 **kw).numpy()
    bound = FA.error_bound(*t, policy=pol, **kw).numpy()
    assert (np.abs(got - ref) <= bound).all()


@pytest.mark.parametrize("kw", [{}, {"window": 7}, {"cap": 4.0},
                                {"window": 5, "cap": 2.0}])
def test_prefill_plain_matches_pallas_fp32(kw):
    """Under fp32 inputs the contract and the TPU kernel agree (the TPU
    kernel skips cast_in, which is the identity there)."""
    rng = np.random.default_rng(9)
    T = 24
    q = rng.standard_normal((1, 6, T, 8)).astype(np.float32)
    k = rng.standard_normal((1, 3, T, 8)).astype(np.float32)
    v = rng.standard_normal((1, 3, T, 8)).astype(np.float32)
    ref = np.array(j_sa_attention(*map(jnp.asarray, (q, k, v)), bq=8,
                                  bkv=8, interpret=True, **kw))
    t = [torch.from_numpy(x).transpose(1, 2) for x in (q, k, v)]
    pol = TP.PrecisionPolicy(input_format="fp32")
    got = ops.sa_attention(*t, policy=pol, **kw).transpose(1, 2).numpy()
    bound = FA.error_bound(*t, policy=pol, **kw).transpose(1, 2).numpy()
    assert (np.abs(got - ref) <= bound).all()


@pytest.mark.parametrize("fault", [{"q_offset": 1}, {"window": 11}])
@pytest.mark.parametrize("fmt", ["bf16", "fp32"])
def test_prefill_bound_rejects_planted_fault(fault, fmt):
    """The plain prefill with a causal mask one key too wide (q_offset + 1)
    or a window one key too narrow lands outside the bound of the correct
    one."""
    rng = np.random.default_rng(17)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 24, 4, 32)).astype(
        np.float32)) for _ in range(3))
    k, v = k[:, :, :2], v[:, :, :2]
    pol = TP.PrecisionPolicy(input_format=fmt)
    good = {"window": 12} if "window" in fault else {}
    ref = FA.flash_attention_ref(q, k, v, policy=pol, **good)
    bad = FA.flash_attention_ref(q, k, v, policy=pol, **fault)
    bound = FA.error_bound(q, k, v, policy=pol, **good)
    assert float(((bad - ref).abs() / bound).max()) > 1.0


# ---------------------------------------------------------------------------
# launch plans of the attention kernels (pure Python: checked here, used on
# the card)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,psz,S", [
    (4, 16, 144), (4, 16, 2048), (4, 16, 12288), (4, 16, 131072),
    (1, 16, 131072), (64, 16, 4096), (1, 12, 36), (3, 7, 700), (2, 16, 16)])
@pytest.mark.parametrize("n_split", [None, 1, 5, 16])
def test_decode_split_plan_covers_every_key_once(B, psz, S, n_split):
    """Block r of a (slot, KV head) cluster takes keys [r·kpc, (r+1)·kpc):
    the runs cover the slot's S keys once each, so every row of every
    mapped page lies in exactly one block's run; no block is empty, the
    cluster stays within 16 blocks (8 unless shared memory needs more),
    and a block's shared memory fits 227 KB, up to 131,072-token slots; a
    forced cluster size too small for the slot is refused."""
    KVH, g, hd = 8, 5, 128
    P = -(-S // psz)
    if n_split and DA.decode_smem(g, hd, psz, DA._keys_per_cta(
            P * psz, n_split)) > DA.SMEM_LIMIT:
        with pytest.raises(ValueError, match="shared memory"):
            DA.split_plan(g, hd, psz, P, n_split=n_split)
        return
    plan = DA.split_plan(g, hd, psz, P, n_split=n_split)
    # the wrapper's plan for B slots of these shapes is the same
    assert _decode_launch_plan(B, KVH, g, hd, psz, P, n_split) == plan
    runs = [(r * plan.keys_per_cta,
             min(P * psz, (r + 1) * plan.keys_per_cta))
            for r in range(plan.n_split)]
    owner = np.zeros(P * psz, np.int64)
    for lo, hi in runs:
        assert lo < hi                        # no empty block
        owner[lo:hi] += 1
    assert (owner == 1).all()
    for page in range(P):                     # each page row in one run
        rows = owner[page * psz:(page + 1) * psz]
        assert rows.sum() == psz
    assert 1 <= plan.n_split <= DA.MAX_CLUSTER
    if n_split is None and plan.n_split > DA.PORTABLE_CLUSTER:
        portable = DA._keys_per_cta(P * psz, DA.PORTABLE_CLUSTER)
        assert DA.decode_smem(g, hd, psz, portable) > DA.SMEM_LIMIT
    assert plan.smem == DA.decode_smem(g, hd, psz, plan.keys_per_cta)
    assert plan.smem <= 227 * 1024
    assert plan.keys_per_cta % DA.KEY_ALIGN == 0
    # whole runs a block (ROADMAP F9: the kernel sums run by run)
    assert plan.keys_per_cta % DA.RUN == 0


def test_decode_split_plan_refuses_what_no_cluster_holds():
    with pytest.raises(ValueError, match="shared memory"):
        DA.split_plan(5, 128, 16, 2 ** 18 // 16)
    with pytest.raises(ValueError, match="n_split"):
        DA.split_plan(5, 128, 16, 9, n_split=17)


def _decode_launch_plan(B, KVH, g, hd, psz, P, n_split=None,
                        dtype=torch.float32):
    """The paged decode wrapper's plan for B slots (shapes only: meta
    tensors)."""
    q = torch.empty((B, 1, KVH * g, hd), device="meta")
    pool = torch.empty((B * P + 1, psz, KVH, hd), dtype=dtype, device="meta")
    bt = torch.empty((B, P), dtype=torch.int32, device="meta")
    return DA.launch_plan(q, pool, pool, bt, n_split)


@pytest.mark.parametrize("S,psz,g,hd", [
    (144, 16, 5, 128), (2048, 16, 5, 128), (12288, 16, 5, 128),
    (131072, 16, 5, 128), (40, 16, 5, 128), (700, 7, 8, 64),
    (36, 12, 1, 256), (4096, 32, 4, 128)])
@pytest.mark.parametrize("B", [1, 4, 20, 64])
def test_decode_split_plan_does_not_depend_on_the_batch(S, psz, g, hd, B):
    """ROADMAP F2: a slot's cluster (its blocks, their runs of keys, hence
    its order of sums) is the same whatever the batch around it — B = 1,
    4, 20, 64 at 8 KV heads, for either pool type — so a slot gives the
    same bits decoded alone or folded into a larger batch. At the serve
    shape (144-token slots) and at 2048-token slots it is the plan a start
    of 8 blocks gives (3 runs of 64 keys at 144 tokens, the last of 16)."""
    P = -(-S // psz)
    want = _decode_launch_plan(4, 8, g, hd, psz, P)
    for dtype in (torch.float32, torch.bfloat16):
        assert _decode_launch_plan(B, 8, g, hd, psz, P, dtype=dtype) == want
    if (S, psz, g, hd) in ((144, 16, 5, 128), (2048, 16, 5, 128)):
        assert want == DA.split_plan(g, hd, psz, P, n_split=8)


@pytest.mark.parametrize("T", [1, 15, 16, 17, 32, 64, 100, 128, 200, 1024])
@pytest.mark.parametrize("fmt", ["bf16", "fp16", "fp32"])
def test_prefill_launch_plan_tiles_cover_t(T, fmt):
    """The q tiles of the launch grid cover 0..T-1 exactly once, ragged T
    included; bf16 and fp16 take the tensor-core route, fp32 the SIMT
    one."""
    H, hd = 40, 128
    plan = FA.launch_plan(1, T, H, hd, fmt)
    assert plan["route"] == ("simt" if fmt == "fp32" else "mma")
    nq, h, b = plan["grid"]
    assert (h, b) == (H, 1)
    rows = plan["rows"]
    covered = np.zeros(T, np.int64)
    for i in range(nq):
        lo, hi = i * rows, min(T, (i + 1) * rows)
        assert lo < hi                        # no tile past T
        covered[lo:hi] += 1
    assert (covered == 1).all()
    if plan["route"] == "mma":
        assert rows == 16 * plan["warps"]
    assert plan["smem"] <= 227 * 1024


@pytest.mark.parametrize("hd,kv16,smem", [
    (128, False, 98304), (128, True, 65536),
    # hd 256: 32-key tiles, and the 8 warps' 16 q rows in 16 bits
    (256, False, 32 * 256 * 12 + 8 * 16 * 256 * 2),
    (256, True, 32 * 256 * 8 + 8 * 16 * 256 * 2)])
def test_prefill_launch_plan_shared_memory_by_head_dim(hd, kv16, smem):
    """The mma route's shared memory (the kernel's layout, checked again by
    its launcher) fits one SM at every head dim it takes, hd 256's q rows
    included; the simt route's at hd 256 too."""
    plan = FA.launch_plan(1, 1500, 16, hd, "bf16", kv16)
    assert plan["smem"] == smem <= 227 * 1024
    assert plan["key_tile"] == (32 if hd == 256 else 64)
    simt = FA.launch_plan(1, 1500, 16, hd, "fp32")
    assert simt["smem"] == 4 * (16 * hd + 32 * (hd + 1) + 32 * hd)
    assert simt["smem"] <= 227 * 1024
    assert hd in FA.MMA_HEAD_DIMS and hd <= FA.SIMT_MAX_HD


def test_prefill_route_counts_stay_zero_on_cpu():
    """On the CPU the prefill runs its plain version: no route counts a
    launch, and `reset_counts` clears the route counters with the rest."""
    q = torch.zeros(1, 4, 2, 32)
    FA.ROUTE_LAUNCHES["mma"] = 3
    ops.reset_counts()
    ops.sa_attention(q, q, q)
    assert ops.route_counts()["prefill_attention"] == {"mma": 0,
                                                       "simt": 0}
    assert ops.counts()["prefill_attention"] == {"launches": 0,
                                                 "plain_calls": 1}


# ---------------------------------------------------------------------------
# SA GEMM: routes, the tensor-core plan and the fp32 split (host logic)
# ---------------------------------------------------------------------------

def test_sa_matmul_route_counts_stay_zero_on_cpu():
    """On the CPU every SA GEMM, forward and backward, runs the plain
    version: no route counts a launch, and `reset_counts` clears them."""
    MM.ROUTE_LAUNCHES["mma"] = 2
    ops.reset_counts()
    a = torch.randn(8, 16).to(torch.bfloat16).requires_grad_(True)
    w = torch.randn(16, 4).to(torch.bfloat16).requires_grad_(True)
    ops.sa_matmul(a, w, act="silu").sum().backward()
    assert ops.route_counts()["sa_matmul"] == {
        "partial": 0, "mma": 0, "split3": 0, "simt": 0}
    c = ops.counts()
    assert c["sa_matmul"] == {"launches": 0, "plain_calls": 1}
    assert c["sa_matmul_bwd"] == {"launches": 0, "plain_calls": 2}


@pytest.mark.parametrize("a_dt,w_dt,route", [
    (torch.bfloat16, torch.bfloat16, "mma"),
    (torch.float32, torch.bfloat16, "split3"),
    (torch.bfloat16, torch.float32, "split3"),
    (torch.float32, torch.float32, "simt")])
def test_gemm_route_follows_the_operand_types(a_dt, w_dt, route):
    """bf16 x bf16 takes the tensor cores (`mma`) at every M and layout,
    decode included (ROADMAP F2: no route flips with the rows). Any other
    pair: below TILED_MIN_M a row-major GEMM takes the split-K kernel;
    from it, or with any transposed operand (the backward's), the route is
    the operand types' whatever M is."""
    m = MM.TILED_MIN_M
    small = "mma" if route == "mma" else "partial"
    for rows in (1, 4, m - 1):
        assert MM.gemm_route(rows, a_dt, w_dt) == small
    for rows in (1, m - 1, m, 1024):
        assert MM.gemm_route(rows, a_dt, w_dt, False, True) == route
        assert MM.gemm_route(rows, a_dt, w_dt, True, False) == route
        assert MM.gemm_route(rows, a_dt, w_dt, False, False) == route
    for rows in (m, m + 1, 1024):
        assert MM.gemm_route(rows, a_dt, w_dt) == route


@pytest.mark.parametrize("n", [1, 31, 32, 33, 80, 200, 999, 1024, 5120,
                               13824, 153600])
def test_fp_emu_launch_plan_covers_each_output_once(n):
    """fp_emu's launch plan at M = 1 to 64: each output (m, n) belongs to
    exactly one thread (`ilp`: block x, warp, lane -> column, block y, row
    r -> row; `pc`: block x, lane -> column, block y -> row), every warp
    that holds a column is launched, an `ilp` thread walks 1, 2 or 4 rows
    in blocks of ILP_WARPS warps, a `pc` block is one consumer warp and two
    producers; the plan is a function of (M, N) alone."""
    for m in range(1, 65):
        p = FE.launch_plan(m, n)
        assert p == FE.launch_plan(m, n)
        rows, warps, (gx, gy) = p["rows"], p["warps"], p["grid"]
        assert p["strips"] == -(-n // 32) and p["kernel"] in FE.KERNELS
        if p["kernel"] == "pc":
            assert (rows, warps, gx, gy) == (1, FE.PC_WARPS, p["strips"], m)
            continue
        assert rows in FE.ROWS and rows <= max(m, 1)
        assert warps == FE.ILP_WARPS
        if n <= 1024:
            cols = np.zeros(n, np.int64)
            for bx in range(gx):
                for wy in range(warps):
                    base = (bx * warps + wy) * 32
                    if base >= n:       # a spare warp returns at once
                        continue
                    c = np.arange(base, base + 32)
                    cols[c[c < n]] += 1
            assert (cols == 1).all(), (m, n)
        else:
            assert (gx - 1) * warps * 32 < n <= gx * warps * 32
        rws = np.zeros(m, np.int64)
        for by in range(gy):
            r = np.arange(by * rows, by * rows + rows)
            rws[r[r < m]] += 1
        assert (rws == 1).all(), (m, n)


def test_fp_emu_launch_plan_spreads_decode_and_shares_prefill():
    """At decode's M the plan takes the producer/consumer kernel, a block a
    row of 32 outputs, so wk's (M = 2, N = 1024) 64 blocks land on 64 SMs;
    at prefill's M = 32 the wide GEMMs interleave 4 rows a thread, sharing
    each W field."""
    p = FE.launch_plan(2, 1024)
    assert p["kernel"] == "pc" and p["grid"][0] * p["grid"][1] == 64
    for n in (5120, 13824, 153600):
        p = FE.launch_plan(32, n)
        assert (p["kernel"], p["rows"]) == ("ilp", 4)


@pytest.mark.parametrize("n,k", [(5120, 5120), (1024, 5120), (13824, 5120),
                                 (5120, 13824), (153600, 5120), (999, 1000),
                                 (96, 1024), (384, 256), (8, 16)])
def test_fp32_k_plan_does_not_depend_on_the_rows(n, k):
    """ROADMAP F2b: an fp32 x fp32 output's order of sums — its K slices,
    each an FMA chain from zero, and the parts they are folded in — is the
    same at every M (1, 4, 7 on `partial`, 8, 20, 1024 on `simt`), on the
    path's (N, K) and ragged ones; the slices cover K once, the parts the
    slices once, and each route's grid the (m, n) output once."""
    want = MM.fp32_k_plan(n, k)
    S, D, per, P = want["slices"], want["slice"], want["per_part"], \
        want["parts"]
    assert D % 16 == 0 and (S - 1) * D < k <= S * D
    assert (P - 1) * per < S <= P * per and P <= 16
    for m in (1, 4, 7, 8, 20, 1024):
        route = MM.gemm_route(m, torch.float32, torch.float32)
        assert route == ("partial" if m < MM.TILED_MIN_M else "simt")
        plan = MM.fp32_launch(m, n, k, route)
        assert {key: plan[key] for key in want} == want, m
        gx, gy, gz = plan["grid"]
        rows, cols, bm = ((gx * 8, gy * 128, 8) if route == "partial"
                          else (gy * 128, gx * 128, 128))
        assert rows - bm < m <= rows and cols - 128 < n <= cols
        assert gz == (S if route == "partial" else P)
        assert plan["workspace"] == (gz if gz > 1 else 0)


@pytest.mark.parametrize("m", [1, 4, 7, 8, 16, 63, 64, 65, 128, 256, 1000,
                               1024])
@pytest.mark.parametrize("n", [1, 96, 999, 1024, 5120, 13824, 153600])
@pytest.mark.parametrize("route", ["mma", "split3"])
def test_mma_plan_covers_the_output_once(m, n, route):
    """The block tiles of the tensor-core grid cover the (m, n) output
    exactly once, ragged edges included; the shared memory fits a block;
    and nothing in the plan splits K, so each output's order of sums does
    not depend on M (ROADMAP F2)."""
    plan = MM.mma_plan(m, n, route)
    bm, bn = plan["block"]
    gx, gy = plan["grid"]
    assert plan["npiece"] == (3 if route == "split3" else 1)
    assert (bm, bn, plan["warps"]) == MM.MMA_TILES[plan["tile"]][:3]
    assert (gx - 1) * bn < n <= gx * bn and (gy - 1) * bm < m <= gy * bm
    assert plan["smem"] <= 227 * 1024
    assert set(plan) == {"npiece", "tile", "block", "warps", "grid", "smem"}
    assert (plan["tile"] == "split3") == (route == "split3")
    if route == "mma":
        assert (plan["tile"] == "decode") == (m <= MM.DECODE_MAX_M)
    t = MM.MMA_TILES[plan["tile"]]
    # with TMA: the ring's 1024-byte alignment and a full mbarrier a stage,
    # on wgmma an empty one as well
    tma = 1024 + 8 * t.stages * (1 + t.wgmma) if t.tma else 0
    assert plan["smem"] == t.stages * (plan["npiece"] * bm + bn) * t.bk * 2 \
        + tma


@pytest.mark.parametrize("n,blocks", [(1024, 16), (5120, 80),
                                      (13824, 216), (153600, 2400)])
def test_mma_plan_streams_decode_weights_in_column_strips(n, blocks):
    """Decode (M ≤ 16) takes one m16 row of blocks 64 columns wide, one
    column strip of W streamed a block without a K split (wk and wv 16,
    wq, wo and wd 80, gate and up 216, the lm_head 2400), each block's
    ring within an SM's shared memory; a forced tile is honoured and an
    unknown one refused."""
    for m in (1, 4, 7, MM.DECODE_MAX_M):
        plan = MM.mma_plan(m, n, "mma")
        assert plan["tile"] == "decode" and plan["grid"] == (blocks, 1)
        assert plan["smem"] <= 227 * 1024
    assert MM.mma_plan(MM.DECODE_MAX_M + 1, n, "mma")["tile"] != "decode"
    assert MM.mma_plan(4, n, "mma", tile="large")["tile"] == "large"
    assert MM.mma_plan(1024, n, "mma", tile="decode")["grid"] == (blocks, 64)
    assert MM.mma_plan(4, n, "split3", tile="decode")["tile"] == "split3"
    for bad in ("split3", "huge"):
        with pytest.raises(ValueError, match="tile"):
            MM.mma_plan(4, n, "mma", tile=bad)


def test_mma_plan_keeps_the_grid_full_at_prefill_m():
    """At prefill's M the 128-row tiles give only N/128 blocks; the plan
    takes 64 x 64 tiles there, and the large ones once they fill the
    card."""
    for n in (5120, 13824):
        assert MM.mma_plan(128, n, "mma")["tile"] == "small"
        gx, gy = MM.mma_plan(128, n, "mma")["grid"]
        assert gx * gy >= 132
    assert MM.mma_plan(1024, 5120, "mma")["tile"] == "large"


@pytest.mark.parametrize("m,n", [(1024, 5120), (1024, 13824), (1024, 153600),
                                 (128, 153600), (256, 5120), (300, 7000)])
def test_mma_plan_large_tile_is_warp_specialized_wgmma(m, n):
    """Where the plan takes the large tile it is the wgmma design: 128 x
    128 blocks of three warpgroups (two consumers of 64 x 128 and a TMA
    producer), both operands by TMA, six 64-deep stages; one block an SM,
    its ring and full and empty mbarriers under the 232,448 bytes a block
    may hold; the grid covers the output once and fills at least half the
    card."""
    plan = MM.mma_plan(m, n, "mma")
    t = MM.MMA_TILES["large"]
    assert plan["tile"] == "large"
    assert t.wgmma and t.tma == ("a", "w") and t.warps == 3 * 4
    assert (t.bm, t.bn, t.bk, t.stages) == (128, 128, 64, 6)
    ring = t.stages * (t.bm + t.bn) * t.bk * 2
    assert plan["smem"] == ring + 1024 + 2 * 8 * t.stages == 197728
    assert plan["smem"] <= 232448 < 2 * plan["smem"]
    gx, gy = plan["grid"]
    assert 2 * gx * gy >= 132
    assert (gx - 1) * 128 < n <= gx * 128 and (gy - 1) * 128 < m <= gy * 128
    assert all(not x.wgmma for k_, x in MM.MMA_TILES.items() if k_ != "large")


@pytest.mark.parametrize("m,n,tile", [
    (20, 153600, "small"), (64, 153600, "small"), (128, 153600, "large"),
    (128, 5120, "small"), (128, 13824, "small"), (256, 5120, "large"),
    (256, 1024, "small"), (256, 13824, "large"), (512, 1024, "small"),
    (1024, 1024, "small"), (1024, 5120, "large"), (17, 153600, "small"),
    (16, 153600, "decode")])
def test_mma_plan_crossover_follows_the_sweep(m, n, tile):
    """The small-to-large crossover where the H100 sweep put it (PERF.md
    §6): the verify's lm_head at M = 20 and any GEMM up to 64 rows
    on the small tile; the lm_head from M = 128, wq and wd from M = 256,
    gate and up from M = 256 on the large one; wk and wv (N = 1024) small
    through M = 1024."""
    assert MM.mma_plan(m, n, "mma")["tile"] == tile
    assert MM.large_pays(m, n) == (tile == "large")


def test_tile_launches_stay_zero_on_cpu():
    """On the CPU no tensor-core tile counts a launch (the plain version
    runs), `reset_counts` clears the per-tile counter, and `tile_counts`
    names every tile of the plan."""
    MM.TILE_LAUNCHES["large"] = 3
    ops.reset_counts()
    assert ops.tile_counts() == {t: 0 for t in MM.MMA_TILES}
    a = torch.randn(300, 64).to(torch.bfloat16).requires_grad_(True)
    w = torch.randn(64, 200).to(torch.bfloat16).requires_grad_(True)
    ops.sa_matmul(a, w, act="silu").sum().backward()
    assert ops.tile_counts() == {"large": 0, "small": 0, "decode": 0,
                                 "split3": 0}
    assert ops.counts()["sa_matmul"] == {"launches": 0, "plain_calls": 1}


def test_k16_probe_plants_what_it_names():
    """The k16 probe's operands (gemm_cases.k16_probe_operands) are bf16
    steps of the promised kinds: products spread over up to 2^±60 within
    a step, exact and near-total cancellation, products straddling fp32's
    smallest normal, zeros of both signs; on CPU tensors `k16_probe`
    returns the plain version (the fp64 sum rounded once) twice, and it
    refuses other shapes."""
    from repro_torch.kernels import gemm_cases as GC

    cases = GC.k16_probe_operands(0)
    assert tuple(cases) == GC.PROBE_CASES
    for a, b in cases.values():
        assert a.dtype == b.dtype == torch.bfloat16
        assert a.shape == (GC.PROBE_STEPS, 64, 16)
        assert b.shape == (GC.PROBE_STEPS, 16, 128)
    a, b = cases["spread"]
    prods = (a.double()[:, :, :, None] * b.double()[:, None, :, :]).abs()
    lg = torch.log2(prods)                      # (S, 64, 16, 128)
    span = lg.amax(2) - lg.amin(2)              # a step's exponent spread
    per_step = span.flatten(1).amax(1)
    assert float(per_step.max()) >= 55 and float(per_step.min()) >= 10
    a, b = cases["cancel"]
    s = torch.matmul(a.double(), b.double())
    terms = torch.matmul(a.double().abs(), b.double().abs())
    assert bool((s[:, :, 0::2] == 0).all())
    rel = (s[:, :, 1::2].abs() / terms[:, :, 1::2])
    assert 0 < float(rel.max()) < 2.0 ** -6
    a, b = cases["tiny"]
    p = (a.double()[:, :, :, None] * b.double()[:, None, :, :]).abs()
    assert float(p.min()) < 2.0 ** -126 < float(p.max()) < 2.0 ** -100
    a, b = cases["zeros"]
    za = a.float() == 0
    assert bool(torch.signbit(a.float()[za]).any())
    assert bool((~torch.signbit(a.float()[za])).any())
    assert bool((b.float() == 0).any())
    got_mma, got_wg = MM.k16_probe(a, b)
    want = MM.k16_probe_ref(a, b)
    assert torch.equal(got_mma, want) and torch.equal(got_wg, want)
    assert GC.k16_mismatches(got_mma, got_wg) == {"bits": 0, "values": 0,
                                                 "worst": None}
    with pytest.raises(ValueError, match="k16_probe"):
        MM.k16_probe(a[:, :32], b)
    with pytest.raises(ValueError, match="k16_probe"):
        MM.k16_probe(a.float(), b)


def test_k16_mismatches_counts_bits_and_values():
    """Bits that differ, values that differ with +0 and -0 equal and NaN
    equal to NaN, and the worst value mismatch."""
    from repro_torch.kernels import gemm_cases as GC

    x = torch.tensor([1.0, 0.0, float("nan"), 2.0, -3.0])
    y = torch.tensor([1.0, -0.0, float("nan"), 2.0 + 2 ** -22, -3.5])
    got = GC.k16_mismatches(x, y)
    assert got["bits"] == 3 and got["values"] == 2
    assert got["worst"] == (0.5, -3.0, -3.5)


def _planted_split_values():
    """Ties at each piece's rounding, powers of two, the smallest normals,
    values whose lo piece is at bf16's subnormal edge, the largest floats,
    and non-finite values."""
    one = np.float32(1.0)
    vals = [0.0, -0.0, 1.0, -1.0, 2.0 ** -126, -(2.0 ** -126), 2.0 ** -110,
            2.0 ** 127, np.finfo(np.float32).max, -np.finfo(np.float32).max,
            np.nextafter(one, np.float32(2)),          # 1 + 2^-23
            1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8,      # ties of hi
            1.0 + 2.0 ** -8 + 2.0 ** -16,              # a tie of mid
            1.0 + 2.0 ** -8 + 2.0 ** -16 + 2.0 ** -23,
            3.0 * 2.0 ** 100, 1.5 * 2.0 ** -100]
    return np.array(vals, np.float32)


def test_split3_ref_reconstructs_exactly():
    """hi + mid + lo == x bit for bit (summed in fp64, which holds the
    three pieces exactly) for |x| ≥ 2⁻¹¹⁰ across the exponent range and at
    the planted values; each piece is bf16 and |mid| ≤ 2⁻⁷|x|, |lo| ≤
    2⁻¹⁵|x| (half that but for the largest floats, whose hi is taken
    toward zero); a non-finite x gives (x, 0, 0)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(20000) * np.exp2(rng.integers(-109, 126, 20000))
         ).astype(np.float32)
    x = x[np.abs(x) >= 2.0 ** -110]
    x = np.concatenate([x, _planted_split_values()])
    t = torch.from_numpy(x)
    p = MM.split3_ref(t)
    assert p.dtype == torch.bfloat16 and p.shape == (3, len(x))
    back = p[0].double() + p[1].double() + p[2].double()
    assert torch.equal(back, t.double())
    # below 2^-110 lo's last bit falls under bf16's subnormals: within it
    tiny = torch.tensor([1.2345678e-34, -3.3e-38, 1e-40])
    pt = MM.split3_ref(tiny)
    assert bool(((pt.double().sum(0) - tiny.double()).abs()
                 <= 2.0 ** -134).all())
    assert bool((p[1].double().abs() <= 2.0 ** -7 * t.double().abs()).all())
    assert bool((p[2].double().abs() <= 2.0 ** -15 * t.double().abs()).all())
    bad = torch.tensor([float("inf"), -float("inf"), float("nan")])
    pb = MM.split3_ref(bad)
    assert torch.equal(pb[0][:2].float(), bad[:2]) and pb[0][2].isnan()
    assert bool((pb[1:] == 0).all())


def test_error_bound_terms_follow_the_route():
    """The bound's units (2⁻²⁴·Σ|a||w|) per route: the fp32 chains' 2K;
    for `mma` the tensor cores' truncation inside a k16 step (16 + 4 units
    of 2⁻²³ of the step), the ⌈K/16⌉ additions of the steps' sums and the
    plain version's K; for `split3` 48 + 12 truncations a step over the
    pieces (≤ (1 + 2⁻⁶)·|x|), the additions, and the plain version's 2K."""
    k = 5120
    assert MM.chain_terms(k, "simt") == MM.chain_terms(k, "partial") == 2 * k
    assert MM.chain_terms(k, "mma") == 40 + k // 16 + k
    assert MM.chain_terms(k, "split3") == pytest.approx(
        120 * (1 + 2.0 ** -6) + k // 16 + 2 * k)
    a = torch.randn(MM.TILED_MIN_M, k)
    w = torch.randn(k, 8).to(torch.bfloat16)
    assert torch.equal(MM.error_bound(a, w), MM.error_bound(
        a, w, route="split3"))
    assert torch.equal(MM.error_bound(a[:4], w), MM.error_bound(
        a[:4], w, route="partial"))
    assert torch.equal(MM.error_bound(a, w.float()),
                       MM.error_bound(a, w.float(), route="simt"))


@pytest.mark.parametrize("m,k,n", [(128, 5120, 256), (64, 13824, 128),
                                   (16, 153600, 32)])
def test_split_check_rejects_an_unsplit_operand(m, k, n):
    """`split_check` on the plain arithmetic of three candidate GEMMs of an
    fp32 operand against a bf16 one: fp32 `torch.matmul` passes, the fp32
    operand rounded once to bf16 (no split) fails, and the lo piece dropped
    passes (its error is below the tensor cores' truncation) — at the
    layer's K and at the lm_head backward's K = 153600."""
    g = torch.Generator().manual_seed(k)
    x = torch.randn((m, k), generator=g) * 0.01
    w = (torch.randn((k, n), generator=g) / k ** 0.5).to(torch.bfloat16)
    p = MM.split3_ref(x)
    whole = MM.split_check(x, w, x @ w.float(), route="split3")
    unsplit = MM.split_check(x, w, p[0].float() @ w.float(), route="split3")
    no_lo = MM.split_check(x, w, (p[0].float() + p[1].float()) @ w.float(),
                           route="split3")
    assert whole < 0.1 and no_lo < 0.1
    assert unsplit > 2.0
