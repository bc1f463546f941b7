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
