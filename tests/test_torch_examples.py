"""PyTorch port: the four examples (`examples/*_torch.py`) run on the CPU
at a few steps, and the precision study held to the JAX package's
`examples/sa_precision_study.py`.

Tolerances: sections 1 and 2 of the study are exact (integer and numpy
arithmetic in the same order): their text equals the JAX script's. Section
3, fed the JAX script's weights and prompt: each policy's max relative
deviation within 25 % of the JAX script's, and its top-1 agreement within
2 of the 32 tokens. The two frameworks sum the fp32 chains in different
orders (ROADMAP R1), which moves some bf16 roundings inside the forward
(the bf16 deviation reads 8.14e-03 against 7.61e-03) and can flip an
argmax that lies near a tie (bf16: 32 of 32 against 31).
"""
import contextlib
import importlib.util
import io
import pathlib

import numpy as np
import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def test_quickstart_loss_falls():
    out, text = _run(_example("quickstart_torch").main,
                     ["--steps", "10", "--device", "cpu"])
    assert len(out["losses"]) == 10
    assert all(np.isfinite(out["losses"]))
    assert out["last"] < out["first"]
    assert "step  10  loss" in text and "(improved)" in text


def test_serve_batch_finishes_every_request():
    (summary, sched), text = _run(_example("serve_batch_torch").main,
                                  ["--device", "cpu"])
    assert summary["requests"] == 12 and summary["pages_leaked"] == 0
    assert sorted(r.n_generated for r in sched.finished) == [12] * 6 + [24] * 6
    assert summary["nonfinite_logits"] == 0
    assert text.count("\nreq ") + text.startswith("req ") == 12


def test_train_100m_trains_then_resumes(tmp_path):
    ex = _example("train_100m_torch")
    ckpt = tmp_path / "ckpt"
    (_, hist, d), text = _run(ex.main, ["--device", "cpu", "--steps", "1",
                                        "--ckpt-dir", str(ckpt)])
    assert d == str(ckpt) and [m["step"] for m in hist] == [1]
    assert "resumed" not in text and np.isfinite(hist[0]["loss"])
    (_, hist2, _), text2 = _run(ex.main, ["--device", "cpu", "--steps", "2",
                                          "--ckpt-dir", str(ckpt)])
    assert "resumed from step 1" in text2
    assert [m["step"] for m in hist2] == [2]
    lines = (ckpt / "train_100m.jsonl").read_text().splitlines()
    assert len(lines) == 2


def test_train_100m_default_dir_is_fresh(monkeypatch, tmp_path):
    """Without --ckpt-dir a run gets a new directory: it never resumes."""
    ex = _example("train_100m_torch")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    seen = []

    def fake_run(cfg, args):
        seen.append(args.ckpt_dir)
        assert args.resume and args.log.startswith(args.ckpt_dir)
        return None, []
    monkeypatch.setattr(ex.train, "run", fake_run)
    _run(ex.main, ["--device", "cpu"])
    _run(ex.main, ["--device", "cpu"])
    assert len(set(seen)) == 2
    assert all(pathlib.Path(d).parent == tmp_path for d in seen)


def _sections(text):
    out, cur = {}, None
    for line in text.splitlines():
        if line.startswith("== "):
            cur = line[3]
            out[cur] = [line]
        elif cur and line.strip():
            out[cur].append(line)
    return out


def _ladder_rows(lines):
    rows = {}
    for line in lines[2:]:
        f = line.split()
        rows[f[0]] = (float(f[4].rstrip(",")), float(f[7].rstrip("%")))
    return rows


def test_precision_study_matches_the_jax_script():
    jax = pytest.importorskip("jax")
    from repro.configs import reduced_config
    from repro.models import model as JM

    _, jtext = _run(_example("sa_precision_study").main)
    # the JAX script's own weights and prompt, as it draws them
    cfg = reduced_config("qwen2.5-14b")
    params = jax.tree.map(np.asarray, JM.init_params(jax.random.key(0), cfg))
    toks = np.asarray(jax.random.randint(jax.random.key(1), (1, 32), 0,
                                         cfg.vocab_size))
    out, ttext = _run(_example("sa_precision_study_torch").main,
                      ["--device", "cpu"], params=params, tokens=toks)
    js, ts = _sections(jtext), _sections(ttext)
    assert ts["1"] == js["1"] and ts["2"] == js["2"]
    assert all(out["bit_exact"].values())
    assert ts["3"][:2] == js["3"][:2]
    jrows, trows = _ladder_rows(js["3"]), _ladder_rows(ts["3"])
    assert set(trows) == set(jrows) == {"bf16", "fp8_e5m2", "fp8_e4m3"}
    for fmt, (jdev, jagree) in jrows.items():
        tdev, tagree = trows[fmt]
        assert 0.8 <= tdev / jdev <= 1.25, (fmt, tdev, jdev)
        assert abs(tagree - jagree) <= 100 * 2 / 32 + 1e-9, (fmt, tagree,
                                                            jagree)
