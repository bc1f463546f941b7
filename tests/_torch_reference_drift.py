"""How far the JAX reference's compiled training step lies from its own
op-by-op run, and the port's one-process step from each, on the reduced
configs of tests/test_torch_family_parallel.py (and, for comparison, a
dense arch), on the CPU (ROADMAP R12).

For each arch and policy it prints the loss of the three runs and, over
every gradient leaf, the largest ‖a − b‖ / ‖b‖ of compiled against op by
op, and of the port against op by op and against compiled (the leaf's
index and shape beside it; `--leaf NAME` also prints the leaves whose
path ends in NAME, as dt_bias).

    JAX_PLATFORMS=cpu PYTHONPATH=src:tests \
        python tests/_torch_reference_drift.py \
        --policy fp32 --policy bf16 hymba_h5 mamba2 qwen2.5-14b

Keys are those of the family test's CASES, or an arch name (its reduced
config at 2 layers a period). Takes 15-40 s a step with attention on two
threads."""
from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import torch

import test_torch_family_parallel as T
import test_torch_parallel as TT
from repro.configs import reduced_config as j_reduced
from repro.core import PrecisionPolicy, use_policy
from repro.data.pipeline import SyntheticLM as JSynthetic
from repro.models import model as JM
from repro_torch.configs import reduced_config
from repro_torch.models.convert import params_from_numpy


def _case(key):
    """(JAX config, port config, numpy params, batch) of a key."""
    if key in T.CASES:
        jcfg, tcfg = T._cfgs(key)
    else:
        jcfg = j_reduced(key, layers_per_period=2)
        tcfg = reduced_config(key, layers_per_period=2)
    batch = JSynthetic(jcfg.vocab_size, 16, 4, seed=1).batch_at(0)
    if jcfg.frontend_tokens:
        rng = np.random.default_rng(5)
        batch["frontend"] = rng.standard_normal(
            (4, jcfg.frontend_tokens, jcfg.d_model)).astype(np.float32)
    params = jax.tree.map(np.asarray,
                          JM.init_params(jax.random.key(3), jcfg))
    return jcfg, tcfg, params, batch


def _jax_grads(cfg, params, batch, fmt, jit):
    toks, labs = (jnp.asarray(batch[k]) for k in ("tokens", "labels"))
    fe = batch.get("frontend")
    fe = None if fe is None else jnp.asarray(fe)
    vg = jax.value_and_grad(
        lambda p: JM.lm_loss(p, cfg, toks, labs, frontend_embeds=fe),
        has_aux=True)
    jp = jax.tree.map(jnp.asarray, params)
    with use_policy(PrecisionPolicy(backend="xla", input_format=fmt)):
        if jit:
            (loss, _), g = jax.jit(vg)(jp)
        else:
            with jax.disable_jit():
                (loss, _), g = vg(jp)
    return float(loss), jax.tree.map(np.asarray, g)


def _port_grads(cfg, params, batch, fmt):
    got = TT._one_process(cfg, params, batch, 1, fmt)
    return got["loss"], got["grads"]


def _paths(tree, prefix=""):
    """Leaf paths in `model.tree_leaves`' order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v,
                                                           f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, t in enumerate(tree)
                for p in _paths(t, f"{prefix}/{i}")]
    return [prefix]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("keys", nargs="+")
    ap.add_argument("--policy", action="append", choices=("fp32", "bf16"))
    ap.add_argument("--leaf", default="dt_bias")
    args = ap.parse_args(argv)
    torch.set_num_threads(2)
    for key in args.keys:
        jcfg, tcfg, params, batch = _case(key)
        order = T._order(tcfg, params)
        names = _paths(params_from_numpy(params, "cpu"))
        for fmt in args.policy or ["fp32"]:
            lc, gc = _jax_grads(jcfg, params, batch, fmt, jit=True)
            lo, go = _jax_grads(jcfg, params, batch, fmt, jit=False)
            gc, go = order(gc), order(go)
            lp, gp = _port_grads(tcfg, params, batch, fmt)
            print(f"{key} {fmt}: loss compiled {lc} op-by-op {lo} "
                  f"port {lp}")
            for tag, a, b in (("compiled vs op-by-op", gc, go),
                              ("port vs op-by-op", gp, go),
                              ("port vs compiled", gp, gc)):
                rel = T._rel(a, b)
                i = int(np.argmax(rel))
                picked = {n: f"{r:.3g}" for n, r in zip(names, rel)
                          if n.endswith(args.leaf)}
                print(f"  {tag}: max {rel[i]:.3g} (leaf {i} "
                      f"{b[i].shape}); {args.leaf} {picked}")


if __name__ == "__main__":
    main()
