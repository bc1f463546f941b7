"""Train a ~100M-parameter LM (a qwen2.5 structural twin) on the PyTorch
port with checkpointing, preemption handling and the straggler watchdog
(the counterpart of `examples/train_100m.py`: the same model and recipe).

The default run is small (30 steps of 4 x 128 tokens); `--full` is the
real recipe (300 steps of 16 x 1024):

    PYTHONPATH=src python examples/train_100m_torch.py [--full] [--steps N]
    PYTHONPATH=src python examples/train_100m_torch.py --device cpu \\
        --steps 2 --ckpt-dir /path/to/ckpt

Checkpoints go to `--ckpt-dir` (default: a new temporary directory, so a
run never resumes a stale one) every 100 steps and at the last; a run
given the directory of an earlier one resumes from its last checkpoint.
The per-step metrics go to `--log` (default `train_100m.jsonl` in the
checkpoint directory). Runs on CUDA unless `--device cpu` is given.
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.launch import train


def make_100m():
    base = get_config("qwen2.5-14b")
    return dataclasses.replace(
        base, name="qwen2.5-100m", num_layers=8, d_model=768, num_heads=12,
        num_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32768, fsdp=False)


def main(argv=None):
    """Train; returns (final TrainState, per-step metrics, checkpoint
    directory)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a new temporary "
                         "one)")
    ap.add_argument("--log", default=None,
                    help="metrics JSONL (default: train_100m.jsonl in the "
                         "checkpoint directory)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = make_100m()
    print(f"{cfg.name}: {cfg.param_count()/1e6:.1f}M params")
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="ckpt_100m_")
    os.makedirs(ckpt, exist_ok=True)
    log = args.log or os.path.join(ckpt, "train_100m.jsonl")
    print(f"checkpoints in {ckpt}, metrics in {log}")
    steps = args.steps or (300 if args.full else 30)
    batch = 16 if args.full else 4
    seq = 1024 if args.full else 128
    targs = train.parse_args([
        "--arch", cfg.name, "--steps", str(steps), "--batch", str(batch),
        "--seq", str(seq), "--ckpt-dir", ckpt, "--ckpt-every", "100",
        "--accum", "2", "--resume", "--log", log]
        + (["--device", args.device] if args.device else []))
    state, history = train.run(cfg, targs)
    return state, history, ckpt


if __name__ == "__main__":
    main()
