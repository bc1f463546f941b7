"""PyTorch port: the tile and cluster autotuner (`kernels/autotune.py`) and
the serve driver's `--autotune-decode` (`preseed_decode_blocks`), on the
CPU with a fake timer (the card's timing is `tests/test_torch_gpu.py`).

Tolerance: none. The cache, the lookups and the candidate lists are exact;
the preseed requests the JAX driver's shapes exactly.
"""
import json

import pytest

pytest.importorskip("torch")

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.kernels import autotune as AT  # noqa: E402
from repro_torch.kernels import sa_decode_attention as DA  # noqa: E402
from repro_torch.kernels import sa_matmul as MM  # noqa: E402

# qwen2.5-14b's decode GEMMs as (N, K): wq and wo, wk and wv, wg and wu,
# wd, the lm_head
QWEN_NK = [(5120, 5120), (1024, 5120), (13824, 5120), (5120, 13824),
           (152064, 5120)]


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """A fresh cache file and a fresh in-process state."""
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    AT.reset()
    yield path
    AT.reset()


def _timer(fast):
    """A fake timer: `fast` takes 1 µs, anything else 5."""
    return lambda c: 1.0 if c == fast else 5.0


def test_cache_round_trip_and_memo_after_reset(cache):
    tile, table = AT.tune(4, 5120, 5120, timer=_timer("small"))
    assert tile == "small"
    assert [r["tile"] for r in table][0] == "small"
    data = json.loads(cache.read_text())
    assert data["version"] == 1
    assert data["entries"][f"{AT.device_name()}|4x5120x5120|bfloat16|none"] \
        == {"tile": "small", "us": 1.0}
    assert AT.lookup(4, 5120, 5120) == "small"
    assert AT.SWEPT[0]["heuristic"] == "decode"
    AT.reset()                       # a fresh process reads the file
    assert AT._MEM == {}
    assert AT.lookup(4, 5120, 5120) == "small"
    assert AT.MISSES == 0 and AT.SWEPT == []


def test_corrupt_file_is_ignored_then_replaced_by_tune(cache):
    cache.write_text("{not json")
    assert AT.lookup(4, 5120, 5120) == "decode"      # the heuristic
    assert AT.MISSES == 1
    AT.tune(4, 5120, 5120, timer=_timer("large"))
    data = json.loads(cache.read_text())
    assert list(data["entries"].values()) == [{"tile": "large", "us": 1.0}]
    AT.reset()
    assert AT.lookup(4, 5120, 5120) == "large"


@pytest.mark.parametrize("m", [1, 4, 16, 17, 20, 64, 256, 1024])
@pytest.mark.parametrize("n,k", QWEN_NK)
def test_a_miss_is_mma_plans_tile_sweeps_nothing_writes_nothing(cache, m, n,
                                                                k):
    assert AT.lookup(m, n, k, epilogue="silu") == MM.mma_plan(
        m, n, "mma")["tile"]
    assert AT.MISSES == 1 and AT.SWEPT == []
    assert not cache.exists()
    assert AT._MEM == {}             # a miss is not remembered


def test_epilogue_key_falls_back_to_the_bare_gemm(cache):
    AT.tune(4, 13824, 5120, timer=_timer("small"))
    assert AT.lookup(4, 13824, 5120, epilogue="silu") == "small"
    AT.tune(4, 13824, 5120, epilogue="silu", timer=_timer("large"))
    assert AT.lookup(4, 13824, 5120, epilogue="silu") == "large"
    assert AT.lookup(4, 13824, 5120) == "small"
    assert AT.MISSES == 0


def test_entries_are_namespaced_by_device_and_foreign_ones_kept(cache):
    me = AT.device_name()
    foreign = {
        "NVIDIA A100-SXM4-80GB|4x5120x5120|bfloat16|none": {"tile": "large",
                                                             "us": 3.0},
        # the JAX package's format, under this device's name and its own
        f"{me}|4x1024x5120|bfloat16|none": {"blocks": [16, 256, 1024],
                                            "us": 2.0},
        "cpu-interpret|4x1024x5120|bfloat16|none": {"blocks": [16, 128, 512],
                                                    "us": 9.0},
        f"{me}|dattn|5x128|16x9|float32": {"n_split": 99, "us": 1.0},
        f"{me}|4x5120x13824|bfloat16|none": {"tile": "huge", "us": 1.0},
    }
    cache.write_text(json.dumps({"version": 1, "entries": foreign}))
    assert AT.lookup(4, 5120, 5120) == "decode"
    assert AT.lookup(4, 1024, 5120) == "decode"
    assert AT.lookup(4, 5120, 13824) == "decode"
    assert AT.lookup_decode_attn(5, 128, 16, 9) == \
        DA.split_plan(5, 128, 16, 9).n_split
    assert AT.MISSES == 4
    AT.tune(4, 5120, 5120, timer=_timer("small"))
    entries = json.loads(cache.read_text())["entries"]
    for key, ent in foreign.items():
        assert entries[key] == ent
    assert entries[f"{me}|4x5120x5120|bfloat16|none"]["tile"] == "small"


def test_another_device_sees_none_of_these_entries(cache, monkeypatch):
    AT.tune(4, 5120, 5120, timer=_timer("large"))
    AT.tune_decode_attn(4, 8, 5, 128, 16, 9, timer=lambda n: float(n))
    AT.reset()
    monkeypatch.setattr(AT, "device_name", lambda: "NVIDIA H100 80GB HBM3")
    assert AT.lookup(4, 5120, 5120) == "decode"
    assert AT.lookup_decode_attn(5, 128, 16, 9) == \
        DA.split_plan(5, 128, 16, 9).n_split
    assert AT.MISSES == 2


@pytest.mark.parametrize("m", [1, 4, 20, 64, 1024])
@pytest.mark.parametrize("n,k", QWEN_NK)
def test_candidates_are_tiles_mma_plan_takes(m, n, k):
    cands = AT.candidates_for(m, n, k)
    heur = MM.mma_plan(m, n, "mma")["tile"]
    assert cands[0] == heur and len(set(cands)) == len(cands)
    assert set(cands) <= {"decode", "small", "large"}
    assert ("decode" in cands) == (m <= AT.DECODE_SWEEP_MAX_M
                                   or heur == "decode")
    assert {"small", "large"} <= set(cands)
    for tile in cands:
        plan = MM.mma_plan(m, n, "mma", tile=tile)
        assert plan["tile"] == tile and plan["npiece"] == 1


@pytest.mark.parametrize("batch,spec_k", [(4, 4), (2, 3), (8, 1)])
def test_tune_spec_verify_covers_batch_and_the_verify_rows(cache, batch,
                                                           spec_k):
    got = AT.tune_spec_verify(5120, 5120, batch, spec_k,
                              timer=_timer("small"))
    assert set(got) == {batch, batch * (spec_k + 1)}
    assert {r["key"][0] for r in AT.SWEPT} == {batch, batch * (spec_k + 1)}
    for m in got:
        assert AT.lookup(m, 5120, 5120) == "small"
    # a second preseed finds both shapes cached and sweeps nothing
    n = len(AT.SWEPT)
    AT.tune_spec_verify(5120, 5120, batch, spec_k, timer=_timer("large"))
    assert len(AT.SWEPT) == n


def test_lookup_sweeps_only_when_asked(cache, monkeypatch):
    monkeypatch.setattr(AT, "_gemm_timer",
                        lambda *a: _timer("large"))
    assert AT.lookup(20, 5120, 5120) == "small" and AT.SWEPT == []
    assert AT.lookup(20, 5120, 5120, sweep=True) == "large"
    assert len(AT.SWEPT) == 1
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    assert AT.lookup(64, 5120, 5120) == "large"
    assert len(AT.SWEPT) == 2 and AT.MISSES == 1


@pytest.mark.parametrize("g,hd,psz,P", [(5, 128, 16, 9), (5, 128, 16, 128),
                                        (2, 256, 16, 64), (5, 64, 16, 164),
                                        (1, 64, 8, 1), (5, 128, 16, 1024)])
def test_decode_candidates_are_plans_split_plan_admits(g, hd, psz, P):
    cands = AT.decode_attn_candidates(g, hd, psz, P)
    assert cands[0] == DA.split_plan(g, hd, psz, P).n_split
    assert len(set(cands)) == len(cands)
    for n in cands:
        assert DA.split_plan(g, hd, psz, P, n_split=n).n_split == n
    # every admitted request is one of them
    for n in range(1, DA.MAX_CLUSTER + 1):
        try:
            got = DA.split_plan(g, hd, psz, P, n_split=n).n_split
        except ValueError:
            continue
        assert got in cands


def test_decode_key_has_no_batch(cache):
    n, table = AT.tune_decode_attn(4, 8, 5, 128, 16, 9,
                                   timer=lambda n: 10.0 - n)
    assert n == max(r["n_split"] for r in table)
    for batch in (1, 4, 20, 64):
        assert AT.lookup_decode_attn(5, 128, 16, 9, batch=batch,
                                     kvh=8) == n
    assert AT.MISSES == 0
    key = json.loads(cache.read_text())["entries"]
    assert list(key) == [f"{AT.device_name()}|dattn|5x128|16x9|float32"]
    # another pool type or slot length is another key
    assert AT.lookup_decode_attn(5, 128, 16, 9, dtype="bfloat16") == \
        DA.split_plan(5, 128, 16, 9).n_split
    assert AT.lookup_decode_attn(5, 128, 16, 10) == \
        DA.split_plan(5, 128, 16, 10).n_split
    assert AT.MISSES == 2


def test_tune_without_a_card_or_a_timer_raises(cache):
    import torch
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA device"):
        AT.tune(4, 5120, 5120)
    with pytest.raises(RuntimeError, match="CUDA device"):
        AT.tune_decode_attn(4, 8, 5, 128, 16, 9)
    assert not cache.exists() and AT.SWEPT == []


def test_cpu_wrappers_never_look_the_cache_up(cache):
    import torch

    from repro_torch.kernels import ops
    a = torch.randn(4, 64)
    w = torch.randn(64, 32)
    ops.sa_matmul(a, w, act="silu")
    assert AT.MISSES == 0 and not cache.exists()


def test_autotune_decode_refused_on_the_cpu(cache):
    from repro_torch.launch import serve as drv
    with pytest.raises(ValueError, match="autotune-decode"):
        drv.main(["--arch", "qwen2.5-14b", "--reduced", "--device", "cpu",
                  "--batch", "2", "--requests", "2", "--max-new", "2",
                  "--prompt-lens", "6", "--autotune-decode"])


def test_engine_counts_no_decode_miss_on_the_cpu(cache):
    from repro_torch.launch import serve as drv
    summary, _, engine = drv.main(
        ["--arch", "qwen2.5-14b", "--reduced", "--device", "cpu", "--batch",
         "2", "--requests", "2", "--max-new", "3", "--prompt-lens", "6"],
        return_state=True)
    assert summary["requests"] == 2
    assert engine.decode_misses == 0 and AT.MISSES == 0
    assert "autotune_sweeps" not in summary


# ---------------------------------------------------------------------------
# preseed parity with the JAX driver
# ---------------------------------------------------------------------------

def _recorders(mod, calls, gemm_result):
    def tune_decode(n, k, ms=(1, 4, 8), **kw):
        calls.append(("decode", n, k, tuple(ms)))
        return {m: gemm_result for m in ms}

    def tune_spec_verify(n, k, batch, spec_k, **kw):
        calls.append(("spec", n, k, batch, spec_k))
        return {m: gemm_result for m in (batch, batch * (spec_k + 1))}

    def tune_decode_attn(batch, kvh, g, hd, psz, max_pages, **kw):
        calls.append(("attn", batch, kvh, g, hd, psz, max_pages))
        return (1, 1) if gemm_result is None else 1, []

    return {"tune_decode": tune_decode, "tune_spec_verify": tune_spec_verify,
            "tune_decode_attn": tune_decode_attn}


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "gemma3-12b",
                                  "granite-moe-3b-a800m"])
@pytest.mark.parametrize("spec_k", [0, 4])
@pytest.mark.parametrize("paged", [True, False])
def test_preseed_requests_the_jax_drivers_shapes(monkeypatch, arch, spec_k,
                                                 paged):
    pytest.importorskip("jax")
    from repro.configs import reduced_config as jax_reduced
    from repro.kernels import autotune as JAT
    from repro.launch import serve as jdrv

    from repro_torch.launch import serve as drv

    want, got = [], []
    for name, fn in _recorders(JAT, want, None).items():
        monkeypatch.setattr(JAT, name, fn)
    for name, fn in _recorders(AT, got, "small").items():
        monkeypatch.setattr(AT, name, fn)
    page, pages = (16, 3) if paged else (None, None)
    jdrv.preseed_decode_blocks(jax_reduced(arch), 4, page_size=page,
                               max_pages=pages, spec_k=spec_k)
    choices = drv.preseed_decode_blocks(reduced_config(arch), 4,
                                        page_size=page, max_pages=pages,
                                        spec_k=spec_k)
    assert sorted(got) == sorted(want) and want
    assert len(choices["gemm"]) == sum(
        len(c[3]) if c[0] == "decode" else 2 for c in got if c[0] != "attn")
    assert len(choices["decode_attn"]) == (1 if paged else 0)
