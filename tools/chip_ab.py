#!/usr/bin/env python3
"""A/B of two checkouts of this repository on one card, in one run.

    python3 tools/chip_ab.py OTHER_ROOT [--what fp32,fp_emu,fwd,decode]

Runs chip_smoke.py's timing phases against the port in OTHER_ROOT (e.g.
the parent commit, unpacked with `git archive`) and in this checkout, each
in its own process (each builds its own kernels), in the order other,
this, this, other, and prints every reading of the four runs side by side
with the card's name and power limit. The phases, their shapes and their
operands are this checkout's (chip_smoke.py, `repro_torch.kernels.
gemm_cases`) in all four runs; only the port they call differs. They call
what both trees have: `sa_matmul_cuda`, `skewed_datapath_matmul` and
`paged_decode_cuda`.

* fp32 — `chip_smoke.fp32_gemm_times`: the SA GEMM's fp32 routes, a
  layer's 7 GEMMs fp32 x fp32 at M = 4 (`partial`) and M = 1024 (`simt`),
  wk with fp32 A and bf16 W at M = 4; ms wall and device.
* fp_emu — `chip_smoke.fp_emu_times`: the skewed datapath's wk GEMM at M
  = 1-33 (wall and device), a layer's 7 GEMMs and the lm_head at M = 2
  and 32 (wall).
* fwd — `chip_smoke.forward_times`: the SA GEMM's bf16 forward at the
  training M (1024), a layer's 7 GEMMs (summed) and the lm_head, wall and
  device, beside bf16 torch.matmul: the `mma` route's large tile wherever
  its blocks fill the card, in whichever design each tree has.
* decode — `chip_smoke.decode_times`: the paged decode on each tree's own
  plan (`paged_decode_cuda`), B = 4 and 64 at 144-token slots and B = 4
  at 2048-token slots (fp32 and bf16 pools); ms wall and device.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = "repro_torch.kernels.gemm_cases"


def _flat(prefix: str, d: dict) -> dict:
    out = {}
    for key, v in d.items():
        name = f"{prefix} {key}".strip()
        out.update(_flat(name, v) if isinstance(v, dict) else {name: v})
    return out


def measure(root: str, what: list[str]) -> dict:
    """This checkout's timing phases against the port in `root`."""
    sys.path[:0] = [os.path.join(root, "src"), HERE]
    import torch

    import repro_torch.kernels as kernels

    # the cases module of this checkout, whichever tree's port runs
    spec = importlib.util.spec_from_file_location(
        CASES, os.path.join(HERE, "src", *CASES.split(".")) + ".py")
    cases = importlib.util.module_from_spec(spec)
    sys.modules[CASES] = cases
    spec.loader.exec_module(cases)
    kernels.gemm_cases = cases
    import chip_smoke as cs

    timer = cs.Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    if "fp32" in what:
        out.update(_flat("fp32", cs.fp32_gemm_times(torch, timer, g)))
    if "fp_emu" in what:
        out.update(_flat("emu", cs.fp_emu_times(torch, timer, g)))
    if "fwd" in what:
        out.update(_flat("fwd", cs.forward_times(torch, timer, g)))
    if "decode" in what:
        out.update(_flat("decode", cs.decode_times(torch, timer, g)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--what", default="fp32,fp_emu")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    what = args.what.split(",")
    if args.measure:
        print("AB " + json.dumps(measure(args.measure, what)), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    other = os.path.abspath(args.other)
    runs = []
    for label, root in (("other", other), ("this", HERE), ("this", HERE),
                        ("other", other)):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              other, "--what", args.what, "--measure", root],
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        line = [ln for ln in res.stdout.splitlines() if ln.startswith("AB ")]
        runs.append((label, json.loads(line[-1][3:])))
    print(f"A/B on {card}: runs other, this, this, other")
    for key in runs[0][1]:
        vals = " ".join(f"{r[key]:.4f}" if isinstance(r.get(key), float)
                        else str(r.get(key)) for _, r in runs)
        print(f"{key:32s} {vals}")
    print("AB_JSON " + json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
