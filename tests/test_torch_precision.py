"""PyTorch port: precision policy, formats and `sa_dot` against the JAX
package on identical inputs (numpy arrays made from a seed).

Tolerances:
  * bit-exact — `quantize`, `cast_in`/`cast_out`, `truncate_mantissa` and
    the `none`/`relu` epilogues: both sides are defined bit by bit;
  * gelu/silu epilogues — |Δ| ≤ 2⁻²⁰·(|y| + |x|): XLA's CPU tanh/logistic
    and torch's differ in the last bits, and `1 + tanh` cancels for
    large negative x (an absolute error of ulp(1)·|x|/2);
  * `sa_dot` — the reassociation bound of `kernels.sa_matmul.error_bound`
    (two fp32 sums of the same exact products in different orders differ
    by ≤ 2·K·2⁻²⁴·Σ|a||w|, plus one truncation quantum in approx mode,
    R1), plus the epilogue term above.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the parity tests need the JAX package; the card's machine has no JAX and
# runs tests/test_torch_gpu.py instead
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import precision as JP  # noqa: E402
from repro.core.fpformats import quantize as j_quantize  # noqa: E402
from repro.kernels.sa_matmul import apply_act as j_apply_act  # noqa: E402
from repro.kernels.sa_matmul import (  # noqa: E402
    truncate_mantissa as j_truncate)
from repro_torch.core import optflags  # noqa: E402
from repro_torch.core import precision as TP  # noqa: E402
from repro_torch.core.fpformats import FORMATS  # noqa: E402
from repro_torch.core.fpformats import quantize as t_quantize  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import sa_matmul as MM  # noqa: E402

torch.set_num_threads(2)

FORMAT_NAMES = sorted(FORMATS)
ACTS = ("none", "relu", "gelu", "silu")


def _specials():
    return np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40,
                     1e-45, 448.0, 449.0, 464.0, 57344.0, 61440.0, 65504.0,
                     65520.0, 1e38, -3.4e38, 2.0 ** -6, 2.0 ** -7,
                     2.0 ** -14, 2.0 ** -15, 1.0 + 2.0 ** -8,
                     1.0 + 3 * 2.0 ** -8], np.float32)


def _inputs(seed=0, n=4096):
    rng = np.random.default_rng(seed)
    x = np.concatenate([
        rng.standard_normal(n).astype(np.float32),
        (rng.standard_normal(n) * 1e3).astype(np.float32),
        (rng.standard_normal(n) * 1e-5).astype(np.float32),
        rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(
            np.uint32).view(np.float32),
        _specials()])
    return x


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _assert_bits(a, b, msg=""):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    nan_a, nan_b = np.isnan(a), np.isnan(b)
    assert np.array_equal(nan_a, nan_b), msg
    ok = nan_a | (_bits(a) == _bits(b))
    assert ok.all(), f"{msg}: {int((~ok).sum())} mismatches, e.g. " \
        f"{a[~ok][:4]} vs {b[~ok][:4]}"


@pytest.mark.parametrize("fmt", FORMAT_NAMES)
def test_quantize_bit_exact(fmt):
    x = _inputs()
    ref = np.asarray(j_quantize(jnp.asarray(x), fmt))
    got = t_quantize(torch.from_numpy(x), fmt).numpy()
    _assert_bits(ref, got, fmt)


@pytest.mark.parametrize("fmt", FORMAT_NAMES)
def test_cast_in_out_bit_exact(fmt):
    x = _inputs(1, 512)
    jp = JP.PrecisionPolicy(input_format=fmt, output_format=fmt)
    tp = TP.PrecisionPolicy(input_format=fmt, output_format=fmt)
    xt = torch.from_numpy(x)
    got_in = tp.cast_in(xt)
    assert got_in.dtype == torch.float32      # fp32 containers on the CPU
    _assert_bits(np.asarray(jp.cast_in(jnp.asarray(x))), got_in.numpy(),
                 f"cast_in {fmt}")
    _assert_bits(np.asarray(jp.cast_out(jnp.asarray(x))),
                 tp.cast_out(xt).numpy(), f"cast_out {fmt}")


def test_truncate_mantissa_bit_exact():
    x = _inputs(2)
    _assert_bits(np.asarray(j_truncate(jnp.asarray(x))),
                 MM.truncate_mantissa(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("act", ACTS)
def test_apply_act_matches_jax(act):
    x = np.random.default_rng(3).standard_normal(20000).astype(
        np.float32) * 6
    ref = np.asarray(j_apply_act(jnp.asarray(x), act))
    got = MM.apply_act(torch.from_numpy(x), act).numpy()
    if act in ("none", "relu"):
        _assert_bits(ref, got, act)
    else:
        bound = 2.0 ** -20 * (np.abs(ref) + np.abs(x))
        assert (np.abs(ref - got) <= bound).all(), act


def _gemm_inputs(seed, m=6, k=48, n=20):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    bias = (rng.standard_normal(n) * 0.3).astype(np.float32)
    return a, w, bias


@pytest.mark.parametrize("fmt", ["bf16", "fp32"])
@pytest.mark.parametrize("mode", ["exact", "approx"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("with_bias", [False, True])
def test_sa_dot_matches_jax(fmt, mode, act, with_bias):
    a, w, bias = _gemm_inputs(4)
    b = bias if with_bias else None
    jpol = JP.PrecisionPolicy(input_format=fmt, backend="xla", mode=mode)
    ref = np.array(JP.sa_dot(jnp.asarray(a), jnp.asarray(w), jpol,
                             bias=None if b is None else jnp.asarray(b),
                             act=act))
    ta, tw = torch.from_numpy(a), torch.from_numpy(w)
    tb = None if b is None else torch.from_numpy(b)
    outs = {}
    for backend in ("torch", "cuda"):
        tpol = TP.PrecisionPolicy(input_format=fmt, backend=backend,
                                  mode=mode)
        outs[backend] = TP.sa_dot(ta, tw, tpol, bias=tb, act=act)
    # on CPU tensors the cuda backend dispatches to the same plain version
    assert torch.equal(outs["torch"], outs["cuda"])
    got = outs["torch"].numpy()
    tpol = TP.PrecisionPolicy(input_format=fmt, mode=mode)
    aq, wq = tpol.cast_in(ta), tpol.cast_in(tw)
    pre = MM.sa_matmul_ref(aq, wq, tb, mode=mode).numpy()
    bound = (MM.error_bound(aq, wq, mode=mode, y=torch.from_numpy(ref))
             .numpy() + 2.0 ** -20 * np.abs(pre))
    err = np.abs(ref - got)
    assert (err <= bound).all(), float((err / bound).max())


def test_sa_einsum_matches_jax():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    for mode in ("exact", "approx"):
        ref = np.asarray(JP.sa_einsum(
            "bhgd,bkhd->bhgk", jnp.asarray(q), jnp.asarray(k),
            JP.PrecisionPolicy(mode=mode)))
        got = TP.sa_einsum("bhgd,bkhd->bhgk", torch.from_numpy(q),
                           torch.from_numpy(k),
                           TP.PrecisionPolicy(mode=mode)).numpy()
        mag = np.einsum("bhgd,bkhd->bhgk", np.abs(q), np.abs(k))
        bound = (2 * 16 * 2.0 ** -24 + (2.0 ** -19 if mode == "approx"
                                         else 0.0)) * mag + 1e-30
        assert (np.abs(ref - got) <= bound).all(), mode


def test_policy_knobs(monkeypatch):
    # emulate is served (the skewed datapath); its 27-bit accumulator
    # refuses fp32 significand products
    assert TP.PrecisionPolicy(backend="emulate").backend == "emulate"
    with pytest.raises(ValueError, match="accumulator"):
        TP.PrecisionPolicy(backend="emulate", input_format="fp32")
    with pytest.raises(ValueError):
        TP.PrecisionPolicy(backend="xla")
    monkeypatch.setenv("REPRO_GEMM_BACKEND", "bogus")
    with pytest.raises(ValueError, match="REPRO_GEMM_BACKEND"):
        optflags.gemm_backend()
    monkeypatch.setenv("REPRO_GEMM_BACKEND", "emulate")
    assert TP.current_policy().backend == "emulate"
    monkeypatch.setenv("REPRO_GEMM_BACKEND", "cuda")
    monkeypatch.setenv("REPRO_SA_MODE", "approx")
    pol = TP.current_policy()
    assert pol.backend == "cuda" and pol.mode == "approx"
    with TP.use_policy(TP.PrecisionPolicy(input_format="fp32")) as p:
        assert TP.current_policy() is p
    monkeypatch.delenv("REPRO_GEMM_BACKEND")
    monkeypatch.delenv("REPRO_SA_MODE")
    assert TP.current_policy().backend == "torch"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_matmul_upcasts_bf16_operands():
    """The plain GEMM rounds once: bf16 operands are upcast before the
    fp32 matmul, so the result differs from a bf16 `torch.matmul`, whose
    output is rounded to bf16."""
    a, w, _ = _gemm_inputs(6, 4, 64, 8)
    ab = torch.from_numpy(a).to(torch.bfloat16)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    y = MM.sa_matmul_ref(ab, wb)
    assert y.dtype == torch.float32
    exact = ab.double() @ wb.double()
    assert float((y.double() - exact).abs().max()) < 1e-5


def test_sa_dot_cuda_backend_batched_a_and_2d_weight():
    """The cuda backend folds a batched `a` into the kernel's rows (on CPU
    tensors the kernel's plain version) and refuses a weight that is not
    2-D instead of routing around the kernel."""
    rng = np.random.default_rng(8)
    a = torch.from_numpy(rng.standard_normal((2, 3, 40)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((40, 7)).astype(np.float32))
    pol = TP.PrecisionPolicy(backend="cuda")
    ops.reset_counts()
    got = TP.sa_dot(a, w, pol, act="silu")
    assert got.shape == (2, 3, 7)
    assert ops.counts()["sa_matmul"]["plain_calls"] == 1
    flat = TP.sa_dot(a.reshape(6, 40), w, pol, act="silu")
    assert torch.equal(got.reshape(6, 7), flat)
    with pytest.raises(ValueError, match="2-D weight"):
        TP.sa_dot(a, torch.stack([w, w]), pol)
