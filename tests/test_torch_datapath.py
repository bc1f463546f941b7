"""PyTorch port: the paper's datapath — the fp_emu and quantize kernels'
plain versions, the FP8 GEMM, the `emulate` GEMM backend and the
`chained_fma` copy — against the JAX package on identical inputs (numpy
arrays made from a seed; the Pallas kernels in interpret mode, as the JAX
tests run them). The hand-written kernels against these plain versions,
on the card, are in tests/test_torch_gpu.py.

Tolerances:
  * bit-exact — quantize (NaN positions equal, payloads aside), amax_scale,
    fp_emu against `fma_emu_matmul` and `chained_fma.matmul_emulated`, the
    `chained_fma` copy, and `sa_dot` under `emulate` with act none/relu:
    each side is defined bit by bit;
  * `sa_dot` under `emulate` with silu/gelu — 2 ulp of the output plus
    2⁻²⁰·|x|: the fp32 epilogues of XLA and torch differ in the last bits
    (as tests/test_torch_precision.py states for `apply_act`);
  * the FP8 GEMM — the SA GEMM's reassociation bound
    (`kernels.sa_matmul.error_bound`, R1) with its scale, plus 2⁻²⁰·|y|:
    the quantized operands are bit-identical, only the fp32 sum order
    differs.
"""
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the parity tests need the JAX package; the card's machine has no JAX and
# runs tests/test_torch_gpu.py instead
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import chained_fma as JCF  # noqa: E402
from repro.core import precision as JP  # noqa: E402
from repro.kernels import ops as JOPS  # noqa: E402
from repro.kernels import ref as JREF  # noqa: E402
from repro.kernels.fp_emu import fma_emu_matmul as j_fma_emu  # noqa: E402
from repro.kernels.quantize import amax_scale as j_amax_scale  # noqa: E402
from repro.kernels.quantize import quantize_fp8 as j_quantize_fp8  # noqa: E402,E501
from repro_torch.core import chained_fma as TCF  # noqa: E402
from repro_torch.core import precision as TP  # noqa: E402
from repro_torch.core.fpformats import get_format as t_get_format  # noqa: E402,E501
from repro_torch.core.fpformats import quantize as t_quantize  # noqa: E402
from repro_torch.kernels import fp_emu as FE  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quantize as QZ  # noqa: E402
from repro_torch.kernels import sa_matmul as MM  # noqa: E402

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FP8 = ("fp8_e4m3", "fp8_e5m2")
EMU_FORMATS = ("bf16", "fp16", "fp8_e4m3", "fp8_e5m2")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_bits(ref, got, msg=""):
    ref, got = np.asarray(ref, np.float32), np.asarray(got, np.float32)
    nan = np.isnan(ref)
    assert np.array_equal(nan, np.isnan(got)), msg
    bad = ref[~nan].view(np.uint32) != got[~nan].view(np.uint32)
    assert not bad.any(), (f"{msg}: {int(bad.sum())} differ, e.g. "
                           f"{ref[~nan][bad][:4]} vs {got[~nan][bad][:4]}")


def _quant_inputs(seed=0):
    rng = np.random.default_rng(seed)
    specials = np.array(
        [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40, 1e-45,
         2.0 ** -6, 2.0 ** -7, 2.0 ** -14, 2.0 ** -15, 2.0 ** -17, 448.0,
         449.0, 464.0, 480.0, 57344.0, 61440.0, 65504.0, 1e38, -3.4e38],
        np.float32)
    return np.concatenate([
        (rng.standard_normal(3000) * 300).astype(np.float32),
        (rng.standard_normal(1000) * 1e-3).astype(np.float32),
        rng.integers(0, 2 ** 32, 2000, dtype=np.uint64).astype(
            np.uint32).view(np.float32),
        specials, -specials])


# ---------------------------------------------------------------------------
# quantize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", FP8)
@pytest.mark.parametrize("scale", ["amax", 1.0, 0.37, 3.0])
def test_quantize_plain_matches_pallas(fmt, scale):
    x = _quant_inputs()
    if scale == "amax":
        scale = float(np.asarray(j_amax_scale(jnp.asarray(x[:3000]), fmt)))
    ref = np.asarray(j_quantize_fp8(jnp.asarray(x), scale, fmt,
                                    interpret=True))
    got = ops.quantize_fp8(torch.from_numpy(x), scale, fmt)
    assert got.dtype == torch.float32 and got.shape == x.shape
    _assert_bits(ref, got.numpy(), f"{fmt} scale {scale}")


@pytest.mark.parametrize("fmt", FP8)
def test_quantize_follows_the_kernel_at_planted_ties(fmt):
    """Where x/s lands on an FP8 rounding tie but x·fl(1/s) does not round
    the same way, the JAX oracle (`ref.quantize_ref`, a division) and the
    TPU kernel (a multiply by the reciprocal) disagree; the port follows
    the kernel (ROADMAP R6)."""
    scales = np.random.default_rng(0).uniform(0.01, 100.0, 64).astype(
        np.float32)
    ties = _chip_smoke().planted_ties(np, fmt, scales)
    planted = 0
    for s, (x, _) in ties.items():
        if not len(x):
            continue
        kern = np.asarray(j_quantize_fp8(jnp.asarray(x), s, fmt,
                                         interpret=True))
        oracle = np.asarray(JREF.quantize_ref(jnp.asarray(x), fmt, s))
        assert (kern.view(np.uint32) != oracle.view(np.uint32)).all(), s
        got = QZ.quantize_fp8_ref(torch.from_numpy(x), s, fmt).numpy()
        _assert_bits(kern, got, f"{fmt} scale {s}")
        planted += len(x)
    assert planted >= 100


@pytest.mark.parametrize("fmt", FP8)
def test_amax_scale_matches_jax(fmt):
    x = _quant_inputs(1)[:4000] * 7.0
    for arr in (x, x * 1e-20, np.zeros(16, np.float32)):
        ref = np.asarray(j_amax_scale(jnp.asarray(arr), fmt))
        got = QZ.amax_scale(torch.from_numpy(arr), fmt)
        assert got.dtype == torch.float32 and got.ndim == 0
        _assert_bits(ref, got.numpy())


@pytest.mark.parametrize("fmt", FP8)
@pytest.mark.parametrize("act", ["none", "silu"])
def test_sa_matmul_fp8_matches_jax(fmt, act):
    rng = np.random.default_rng(3)
    a = (rng.standard_normal((6, 96)) * 3).astype(np.float32)
    w = (rng.standard_normal((96, 40)) / 10).astype(np.float32)
    bias = (rng.standard_normal(40) * 0.1).astype(np.float32)
    ref = np.array(JOPS.sa_matmul_fp8(jnp.asarray(a), jnp.asarray(w), fmt,
                                      bias=jnp.asarray(bias), act=act))
    ta, tw, tb = map(torch.from_numpy, (a, w, bias))
    ops.reset_counts()
    got = ops.sa_matmul_fp8(ta, tw, fmt, bias=tb, act=act)
    assert ops.counts()["quantize"] == {"launches": 0, "plain_calls": 2}
    sa_, sw = QZ.amax_scale(ta, fmt), QZ.amax_scale(tw, fmt)
    aq = QZ.quantize_fp8_ref(ta, sa_, fmt)
    wq = QZ.quantize_fp8_ref(tw, sw, fmt)
    bound = MM.error_bound(aq, wq, sa_ * sw, y=torch.from_numpy(ref)).numpy()
    err = np.abs(got.numpy() - ref)
    assert (err <= bound + 2.0 ** -20 * np.abs(ref)).all(), float(
        (err / bound).max())


def test_quantize_refuses_other_formats_and_cpu_launch():
    x = torch.ones(8)
    with pytest.raises(ValueError, match="fp8"):
        ops.quantize_fp8(x, 1.0, "bf16")
    with pytest.raises(ValueError, match="one value"):
        ops.quantize_fp8(x, torch.ones(2), "fp8_e4m3")
    with pytest.raises(ValueError, match="CUDA"):
        QZ.quantize_fp8_cuda(x, 1.0)


# ---------------------------------------------------------------------------
# fp_emu: the skewed datapath
# ---------------------------------------------------------------------------

def _emu_inputs(fmt, scale, seed, m=8, k=48, n=12):
    """Values on the format's grid, scaled, with zeros, signed zeros and a
    cancellation-heavy column (W's second half the negated first, A's two
    halves equal)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)) * scale
    w = rng.standard_normal((k, n)) * scale
    a[rng.random((m, k)) < 0.15] = 0.0
    a[0] = 0.0
    w[:, 1] = 0.0
    h = k // 2
    a[:, h:2 * h] = a[:, :h]
    w[h:2 * h, 2] = -w[:h, 2]
    w[h:2 * h, 3] = -w[:h, 3] * (1 + 2.0 ** -5)
    a = t_quantize(torch.from_numpy(a.astype(np.float32)), fmt).numpy()
    w = t_quantize(torch.from_numpy(w.astype(np.float32)), fmt).numpy()
    a[1, :3] = -0.0
    w[:, 4] = -0.0
    return a, w


@pytest.mark.parametrize("fmt", EMU_FORMATS)
@pytest.mark.parametrize("mode", ["exact", "approx"])
@pytest.mark.parametrize("scale", [1.0, 25.0])
def test_fp_emu_plain_matches_pallas_and_chained_fma(fmt, mode, scale):
    a, w = _emu_inputs(fmt, scale, seed=int(scale) + len(fmt))
    ja, jw = jnp.asarray(a), jnp.asarray(w)
    kern = np.asarray(j_fma_emu(ja, jw, fmt, interpret=True, mode=mode))
    pipe = "approx" if mode == "approx" else "skewed"
    oracle = JCF.matmul_emulated(a, w, fmt, pipe)
    _assert_bits(kern, oracle, "JAX kernel vs chained_fma")
    ops.reset_counts()
    got = ops.skewed_datapath_matmul(torch.from_numpy(a),
                                     torch.from_numpy(w), fmt, mode)
    assert ops.counts()["fp_emu"] == {"launches": 0, "plain_calls": 1}
    _assert_bits(kern, got.numpy(), f"{fmt} {mode} x{scale}")
    # the port's own oracle, the chained_fma copy, agrees as well
    _assert_bits(oracle, TCF.matmul_emulated(a, w, fmt, pipe))


_U32 = 0xFFFFFFFF


def _i32(u):
    """A uint32 (held in int64) read as int32."""
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u)


def _lza(x):
    """bfind.shiftamt.u32: 31 - msb(x), 0xffffffff for 0."""
    msb = torch.frexp(x.clamp_min(1).to(torch.float64))[1].to(torch.int64) - 1
    return torch.where(x == 0, _U32, 31 - msb)


def _shr_u(x, n):       # shr.u32: amounts of 32 or more give 0
    return torch.where(n >= 32, 0, x >> n.clamp(0, 31))


def _shr_s(x, n):       # shr.s32: amounts of 32 or more give the sign
    return x >> n.clamp(0, 31)


def _shl(x, n):         # shl.b32: amounts of 32 or more give 0
    return torch.where(n >= 32, 0, (x << n.clamp(0, 31)) & _U32)


def _chain_model(a, w, fmt, mode, saturate=False):
    """csrc/fp_emu.cu's algebra step for step (`pe_step`, `column_end`): the
    sum carried normalized, T = S << (L + 4), with H = e_max + 5 and q = L +
    4 (0xffffffff for a zero sum, capped at 2^22 in the exponent), the
    shift amounts max(g + q, 5) and max(p − q, hi) from g = e_m + 5 − H and
    p = H − e0 taken before the LZA, the product's significand in one's
    complement when negative. `saturate`: the producer/consumer kernel's
    ring, which carries the product's exponents in 16 bits, a zero
    product's at -2^14. int64 torch ops with the kernel's 32-bit semantics
    (PTX's clamped shifts, bfind)."""
    mb = t_get_format(fmt).man_bits

    def fields(x):
        bits = torch.from_numpy(np.ascontiguousarray(x, np.float32)).view(
            torch.int32).to(torch.int64) & _U32
        e32 = (bits >> 23) & 0xFF
        frac = (bits >> (23 - mb)) & ((1 << mb) - 1)
        m = torch.where(e32 > 0, frac | (1 << mb), 0)
        e = torch.where(e32 > 0, e32 - 127, TCF.E_ZERO)
        return m, e, -(bits >> 31)

    am, ae, asg = fields(a)
    wm, we, wsg = fields(w)
    am = am << (TCF.ACC_MSB - 2 * mb)
    M, K = a.shape
    N = w.shape[1]
    T = torch.zeros((M, N), dtype=torch.int64)
    sp = torch.zeros_like(T)
    H = torch.zeros_like(T)
    q = torch.full_like(T, _U32)
    for k in range(K):
        mm = am[:, k:k + 1] * wm[k:k + 1]
        hi = mm >> 27
        e0 = ae[:, k:k + 1] + we[k:k + 1]
        e_m = e0 + hi
        if saturate:
            e_m, e0 = e_m.clamp_min(-(1 << 14)), e0.clamp_min(-(1 << 14))
            hi = e_m - e0
        sm = asg[:, k:k + 1] ^ wsg[k:k + 1]
        mmc = mm ^ sm
        g = e_m + 5 - H
        p = H - e0
        nss = -(sm + sp)
        qc = torch.clamp_max(q, 1 << 22)
        sh_s = torch.clamp_min(g + _i32(q), 5)
        sh_m = torch.maximum(p - qc, hi)
        e_max = torch.maximum(e_m, H - qc)
        sa = _shr_u(T, sh_s)
        v = _shr_s(mmc, sh_m) + _i32(sa ^ (sp & _U32)) + nss
        so = v.abs()
        qn = _lza(so)
        if mode == "approx":
            qn = qn & (_U32 & ~3)
        T = _shl(so, qn)
        sp = torch.where(v < 0, -1, 0)
        H = e_max + 5
        q = qn
    sgn = (sp & 1) << 31
    c0 = torch.where(T == 0, 0, _lza(T))
    e = H - _i32(q) - c0
    mn = ((T << c0) & _U32) >> 5
    low = mn & 7
    keep = mn >> 3
    keep = keep + ((low > 4) | ((low == 4) & ((keep & 1) == 1))).long()
    ovf = (keep >> 24) != 0
    keep = torch.where(ovf, keep >> 1, keep)
    e = e + ovf.long()
    e32 = e + 127
    bits = sgn | (e32.clamp(0, 255) << 23) | (keep & 0x7FFFFF)
    bits = torch.where(e32 >= 255, sgn | 0x7F800000, bits)
    bits = torch.where((T == 0) | (e32 <= 0), sgn, bits)
    return _i32(bits).to(torch.int32).view(torch.float32)


def _spread_inputs(fmt, seed, m=6, k=200, n=10):
    """Exponents far apart (products that align past the accumulator and
    sums that overflow into bit 27), long cancellation runs and zeros."""
    rng = np.random.default_rng(seed)
    span = {"bf16": 40, "fp16": 6, "fp8_e4m3": 3, "fp8_e5m2": 6}[fmt]
    a = rng.standard_normal((m, k)) * 2.0 ** rng.integers(-span, span + 1,
                                                          (m, k))
    w = rng.standard_normal((k, n)) * 2.0 ** rng.integers(-span, span + 1,
                                                          (k, n))
    a[rng.random((m, k)) < 0.1] = 0.0
    w[:, 0] = 2.0 ** rng.integers(-2, 3, k) * np.sign(rng.standard_normal(k))
    w[1::2, 1] = -w[0::2, 1]
    a[:, 1::2] = a[:, 0::2]
    a = t_quantize(torch.from_numpy(a.astype(np.float32)), fmt).numpy()
    w = t_quantize(torch.from_numpy(w.astype(np.float32)), fmt).numpy()
    return a, w


@pytest.mark.parametrize("fmt", EMU_FORMATS)
@pytest.mark.parametrize("mode", ["exact", "approx"])
@pytest.mark.parametrize("inputs", ["planted x1", "planted x25", "spread"])
@pytest.mark.parametrize("kernel", ["ilp", "pc"])
def test_fp_emu_kernel_algebra_matches_plain(fmt, mode, inputs, kernel):
    """The hand-written kernel's per-step algebra (carried e_t = ê − L, the
    sum normalized ahead, one's-complement products, the zero sum through
    a capped LZA count; in the producer/consumer kernel a zero product's
    exponent saturated), modelled step for step on the CPU, is bit for bit
    `fma_emu_matmul_ref` (the TPU kernel's algebra): planted zeros, signed
    zeros, exact and near cancellation, exponents far apart, both modes."""
    if inputs == "spread":
        a, w = _spread_inputs(fmt, seed=len(fmt) + len(mode))
    else:
        scale = 25.0 if inputs.endswith("x25") else 1.0
        a, w = _emu_inputs(fmt, scale, seed=int(scale) + len(fmt))
    ref = FE.fma_emu_matmul_ref(torch.from_numpy(a), torch.from_numpy(w),
                                fmt, mode)
    got = _chain_model(a, w, fmt, mode, saturate=kernel == "pc")
    _assert_bits(ref.numpy(), got.numpy(), f"{fmt} {mode} {inputs}")


def test_fp_emu_takes_reduced_containers():
    """bf16 and fp16 containers give the same bits as fp32 containers of
    the same values (the card's operands stay in their storage type)."""
    for fmt, dt in (("bf16", torch.bfloat16), ("fp8_e4m3", torch.bfloat16),
                    ("fp16", torch.float16)):
        a, w = _emu_inputs(fmt, 1.0, seed=9)
        ta, tw = torch.from_numpy(a), torch.from_numpy(w)
        ref = FE.fma_emu_matmul_ref(ta, tw, fmt)
        got = FE.fma_emu_matmul_ref(ta.to(dt), tw.to(dt), fmt)
        assert torch.equal(ref.view(torch.int32), got.view(torch.int32))


def test_fp_emu_refuses_fp32_and_unknown_mode():
    a, w = torch.ones(2, 3), torch.ones(3, 4)
    with pytest.raises(ValueError, match="accumulator"):
        ops.skewed_datapath_matmul(a, w, "fp32")
    with pytest.raises(ValueError, match="mode"):
        ops.skewed_datapath_matmul(a, w, "bf16", "fast")
    with pytest.raises(ValueError, match="2"):
        ops.skewed_datapath_matmul(a[None], w)
    with pytest.raises(ValueError, match="CUDA"):
        FE.fma_emu_matmul_cuda(a, w)


@pytest.mark.parametrize("pipeline", ["baseline", "skewed", "approx"])
@pytest.mark.parametrize("fmt", ["bf16", "fp8_e4m3", "fp8_e5m2"])
def test_chained_fma_copy_matches_jax(pipeline, fmt):
    a, w = _emu_inputs(fmt, 3.0, seed=7, m=5, k=40, n=9)
    _assert_bits(JCF.matmul_emulated(a, w, fmt, pipeline),
                 TCF.matmul_emulated(a, w, fmt, pipeline), pipeline)
    assert (TCF.GUARD, TCF.ACC_MSB, TCF.E_ZERO, TCF.APPROX_COARSE) == (
        JCF.GUARD, JCF.ACC_MSB, JCF.E_ZERO, JCF.APPROX_COARSE)


# ---------------------------------------------------------------------------
# sa_dot under the emulate backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["none", "relu", "silu", "gelu"])
@pytest.mark.parametrize("mode", ["exact", "approx"])
@pytest.mark.parametrize("fmt", ["bf16", "fp8_e4m3"])
def test_sa_dot_emulate_matches_jax(act, mode, fmt):
    rng = np.random.default_rng(4)
    a = rng.standard_normal((5, 40)).astype(np.float32)
    w = (rng.standard_normal((40, 11)) / 6).astype(np.float32)
    bias = (rng.standard_normal(11) * 0.3).astype(np.float32)
    jpol = JP.PrecisionPolicy(input_format=fmt, backend="emulate", mode=mode)
    ref = np.asarray(JP.sa_dot(jnp.asarray(a), jnp.asarray(w), jpol,
                               bias=jnp.asarray(bias), act=act))
    tpol = TP.PrecisionPolicy(input_format=fmt, backend="emulate", mode=mode)
    ops.reset_counts()
    got = TP.sa_dot(torch.from_numpy(a), torch.from_numpy(w), tpol,
                    bias=torch.from_numpy(bias), act=act).numpy()
    c = ops.counts()
    assert c["fp_emu"]["plain_calls"] == 1 and c["sa_matmul"] == {
        "launches": 0, "plain_calls": 0}, c
    if act in ("none", "relu"):
        _assert_bits(ref, got, act)
    else:
        pre = ops.skewed_datapath_matmul(
            tpol.cast_in(torch.from_numpy(a)),
            tpol.cast_in(torch.from_numpy(w)), fmt, mode).numpy() + bias
        ulp = np.spacing(np.abs(ref).astype(np.float32))
        assert (np.abs(ref - got) <= 2 * ulp + 2.0 ** -20 * np.abs(pre)
                ).all(), act


def test_sa_dot_emulate_refuses_batched_a_and_fp32():
    a, w = torch.ones(2, 3, 4), torch.ones(4, 5)
    with pytest.raises(ValueError, match="2-D"):
        TP.sa_dot(a, w, TP.PrecisionPolicy(backend="emulate"))
    with pytest.raises(ValueError, match="2-D"):
        JP.sa_dot(jnp.ones((2, 3, 4)), jnp.ones((4, 5)),
                  JP.PrecisionPolicy(backend="emulate"))
    with pytest.raises(ValueError, match="accumulator"):
        TP.PrecisionPolicy(backend="emulate", input_format="fp32")
