"""PyTorch port: the precision study (`repro_torch.launch.precision_study`)
and the cycle and energy models it reads (`core.systolic`,
`core.workloads`, `core.energy`, copies of the JAX package's modules),
against the JAX package.

Tolerance: none. The models are plain Python integer and float
arithmetic in the same order on both sides, so every number is equal.
Section 3 of the study (a model forward under the precision ladder) draws
its own random weights and is held to its order, not to JAX's numbers.
"""
import importlib.util
import pathlib

import pytest

pytest.importorskip("torch")
# the parity tests need the JAX package; the card's machine has no JAX and
# runs tests/test_torch_gpu.py instead
pytest.importorskip("jax")

from repro.core import energy as JE  # noqa: E402
from repro.core import systolic as JS  # noqa: E402
from repro.core import workloads as JW  # noqa: E402
from repro_torch.core import energy as TE  # noqa: E402
from repro_torch.core import systolic as TS  # noqa: E402
from repro_torch.core import workloads as TW  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import precision_study as PS  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = [(1, 1, 1), (16, 128, 128), (16, 256, 256), (49, 1024, 1024),
          (12544, 27, 32), (4096, 5120, 5120), (7, 130, 300), (2, 5120, 1024),
          (0, 5, 5)]


@pytest.mark.parametrize("rows,cols", [(128, 128), (64, 32), (256, 256)])
def test_systolic_copy_matches_jax(rows, cols):
    for pipe in (TS.BASELINE, TS.SKEWED):
        tsa = TS.SAConfig(rows, cols, pipeline=pipe)
        jsa = JS.SAConfig(rows, cols, pipeline=pipe)
        for m, k, n in SHAPES:
            assert TS.gemm_latency(m, k, n, tsa) == JS.gemm_latency(m, k, n,
                                                                     jsa)
            assert TS.utilization(m, k, n, tsa) == JS.utilization(m, k, n,
                                                                   jsa)
            assert TS.latency_s(m, k, n, tsa) == JS.latency_s(m, k, n, jsa)
    for m, k, n in SHAPES:
        assert TS.speedup(m, k, n, rows, cols) == JS.speedup(m, k, n, rows,
                                                             cols)
    with pytest.raises(ValueError):
        TS.SAConfig(pipeline="bogus")


@pytest.mark.parametrize("net", ["mobilenet", "resnet50"])
@pytest.mark.parametrize("dw_mode", ["packed", "per_channel", "offload"])
def test_energy_and_workloads_copies_match_jax(net, dw_mode):
    assert TE.network_totals(net, dw_mode=dw_mode) == JE.network_totals(
        net, dw_mode=dw_mode)
    t_rep = TE.network_report(net, 64, 64, dw_mode)
    j_rep = JE.network_report(net, 64, 64, dw_mode)
    assert [vars(r) for r in t_rep] == [vars(r) for r in j_rep]
    sa = TS.SAConfig()
    for tl, jl in zip(TW.WORKLOADS[net](), JW.WORKLOADS[net]()):
        assert (TW.layer_latency(tl, sa, dw_mode)
                == JW.layer_latency(jl, JS.SAConfig(), dw_mode))
        assert TW.layer_macs(tl, 128, dw_mode) == JW.layer_macs(jl, 128,
                                                                dw_mode)


def test_energy_design_constants_and_tiers_match_jax():
    for d in (TE.BASELINE, TE.SKEWED, TE.SKEWED_APPROX):
        assert TE.REL_AREA[d] == JE.REL_AREA[d]
        assert TE.REL_POWER[d] == JE.REL_POWER[d]
        for util in (1.0, 0.25):
            assert (TE.decode_token_energy_uj(10 ** 9, d, 1.0, util)
                    == JE.decode_token_energy_uj(10 ** 9, d, 1.0, util))
    tokens = {"premium/exact": 40, "bulk/approx": 25, "bulk/exact": 3}
    assert (TE.tier_energy_summary(tokens, 7 * 10 ** 9, utilization=0.5)
            == JE.tier_energy_summary(tokens, 7 * 10 ** 9, utilization=0.5))


def test_precision_study_runs_reduced_on_cpu(capsys):
    ops.reset_counts()
    res = PS.main(["--reduced", "--device", "cpu"])
    out = capsys.readouterr().out
    for title in ("== 1.", "== 2.", "== 3."):
        assert title in out
    assert res["bit_exact"] == {"bf16": True, "fp8_e4m3": True,
                                "fp8_e5m2": True}
    sa = (JS.SAConfig(pipeline=JS.BASELINE), JS.SAConfig(pipeline=JS.SKEWED))
    assert res["gemms"] == [(m, k, n, JS.gemm_latency(m, k, n, sa[0]),
                             JS.gemm_latency(m, k, n, sa[1]))
                            for m, k, n, _ in PS.GEMMS]
    for net in PS.PAPER:
        assert res["networks"][net] == JE.network_totals(net)
    lad = res["ladder"]
    assert set(lad) == {"bf16", "fp8_e5m2", "fp8_e4m3"}
    assert 0 < lad["bf16"]["max_rel_dev"] < lad["fp8_e4m3"]["max_rel_dev"]
    assert lad["bf16"]["top1_agreement"] >= lad["fp8_e4m3"]["top1_agreement"]
    # the FP8 rows went through the quantize kernel's entry point (its
    # plain version, on CPU tensors)
    assert ops.counts()["quantize"]["plain_calls"] > 0


def test_precision_study_needs_a_device_choice_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        PS.main(["--reduced"])


def test_chip_smoke_study_constants_match_jax():
    """chip_smoke checks section 2 on the card against numbers it carries;
    they are the JAX package's."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sa = (JS.SAConfig(pipeline=JS.BASELINE), JS.SAConfig(pipeline=JS.SKEWED))
    assert cs.STUDY_GEMMS == [(m, k, n, JS.gemm_latency(m, k, n, sa[0]),
                               JS.gemm_latency(m, k, n, sa[1]))
                              for m, k, n, _ in PS.GEMMS]
    for net, (lat, en) in cs.STUDY_NETWORKS.items():
        t = JE.network_totals(net)
        assert (t["latency_saving"], t["energy_saving"]) == (lat, en)
