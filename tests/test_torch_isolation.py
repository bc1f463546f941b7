"""The PyTorch port stands alone: no module of `repro_torch`, no port
example (`examples/*_torch.py`) and not `chip_smoke.py` imports JAX or the
JAX package `repro`."""
import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    out = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_importing_every_module_loads_neither_jax_nor_repro():
    code = (
        "import importlib, json, sys\n"
        f"mods = {_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
        "print(json.dumps({'n': len(mods), 'bad': bad}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["n"] >= 20
    assert out["bad"] == []


@pytest.mark.parametrize("path", [str(p.relative_to(ROOT)) for p in
                                  sorted(PKG.rglob("*.py"))
                                  + sorted((ROOT / "examples").glob(
                                      "*_torch.py"))]
                         + ["chip_smoke.py"])
def test_source_has_no_jax_or_repro_import(path):
    tree = ast.parse((ROOT / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    roots = {n.split(".")[0] for n in names}
    assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without a CUDA device chip_smoke exits nonzero and prints no result
    line; alone in a directory it cannot import the port either."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", lone):
        res = subprocess.run([sys.executable, str(script)],
                             capture_output=True, text=True,
                             cwd=script.parent, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
