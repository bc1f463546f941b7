"""Runtime knobs of the PyTorch port, read from the same `REPRO_*`
environment variables as the JAX package, at call time.

  fused_epilogue    — fuse bias add / activation into the GEMM epilogue
                      (models/layers.py passes bias=/act= to sa_dot). On
                      the `cuda` backend this runs inside the kernel after
                      the K loop, before the single output write; on
                      `torch` it is the same fp32 math before cast_out.
  pallas_attention  — serving prefill through the hand-written flash
                      kernel (kernels/sa_attention.py). The name is the
                      JAX package's; here it is on when the tensors lie on
                      a CUDA device and off on the CPU, where the plain
                      `blockwise_attention` runs (`prefill_kernel_on`).
  bf16_params_in_layers — cast fp32 matrices to bf16 at superblock entry
                      (the CPU's fp32 storage; CUDA stores bf16 already).
                      Numerically identical under the bf16 policy.
  pad_kv_heads      — under tensor parallelism, pad KV heads (and the
                      kv-major grouped Q heads) up to a multiple of the
                      `model` axis where the arch asks for it in training
                      (`cfg.pad_attn_train`; models/layers.py
                      `_tp_attention`), so the heads split across ranks.

`REPRO_OPT=0` disables all four.

String knobs: `gemm_backend()` (REPRO_GEMM_BACKEND: `torch` — the plain
PyTorch GEMM and the default —, `cuda`, the hand-written SA GEMM kernel,
or `emulate`, the paper's bit-exact skewed datapath through the
hand-written fp_emu kernel), `sa_mode()` (REPRO_SA_MODE),
`decode_attn_impl()` (REPRO_DECODE_ATTN: `fused` page walk, the default,
or `gather`), `kv_layout()` (REPRO_KV), `prefix_cache_enabled()`
(REPRO_PREFIX_CACHE), `disagg_enabled()` (REPRO_DISAGG),
`prefill_bucket_enabled()` (REPRO_PREFILL_BUCKET),
`spec_decode_enabled()` (REPRO_SPEC_DECODE) and `spec_k()` (REPRO_SPEC_K).
"""
from __future__ import annotations

import os


def _opt_enabled() -> bool:
    return os.environ.get("REPRO_OPT", "1") not in ("0", "false", "off")


_PERF_FLAGS = ("fused_epilogue", "pallas_attention", "bf16_params_in_layers",
               "pad_kv_heads")


def enabled(name: str) -> bool:
    return name in _PERF_FLAGS and _opt_enabled()


def prefill_kernel_on(device) -> bool:
    """Serving prefill runs the hand-written flash kernel: on for CUDA
    tensors (and meta ones, the dry run's card), off for CPU ones (there
    it is the plain blockwise path)."""
    from .device import card_program
    return enabled("pallas_attention") and card_program(device)


_GEMM_BACKENDS = ("torch", "cuda", "emulate")


def gemm_backend() -> str:
    backend = os.environ.get("REPRO_GEMM_BACKEND", "torch")
    if backend not in _GEMM_BACKENDS:
        raise ValueError(
            f"REPRO_GEMM_BACKEND={backend!r}; want one of {_GEMM_BACKENDS}")
    return backend


_DECODE_ATTN_IMPLS = ("fused", "gather")


def decode_attn_impl() -> str:
    impl = os.environ.get("REPRO_DECODE_ATTN", "fused")
    if impl not in _DECODE_ATTN_IMPLS:
        raise ValueError(
            f"REPRO_DECODE_ATTN={impl!r}; want one of {_DECODE_ATTN_IMPLS}")
    return impl


def kv_layout() -> str:
    layout = os.environ.get("REPRO_KV", "paged")
    if layout not in ("ring", "paged"):
        raise ValueError(
            f"REPRO_KV/kv_layout={layout!r}; want 'ring' or 'paged'")
    return layout


def prefix_cache_enabled() -> bool:
    return os.environ.get("REPRO_PREFIX_CACHE", "1") not in (
        "0", "false", "off")


def disagg_enabled() -> bool:
    """Disaggregated prefill/decode serving (default off): paged engines
    split into a prefill pool that stages finished prompts' pages in the
    shared pool and a decode pool that binds them from a ready queue
    between chunks (DESIGN.md §10). "1" and "0" give the same greedy
    stream digest: the knob changes scheduling, never tokens. Engines
    serve unified where pages are not a pure function of the prompt (the
    ring layout)."""
    return os.environ.get("REPRO_DISAGG", "0") not in ("0", "false", "off")


def prefill_bucket_enabled() -> bool:
    """Prompt-length bucketing in the serve prefill (default off): each
    prefill's token block is right-padded to a bucket length, so a mixed
    stream runs a few prefill shapes; the padded rows' cache positions are
    set to -1 and the logits are read at the real last token."""
    return os.environ.get("REPRO_PREFILL_BUCKET", "0") not in (
        "0", "false", "off")


def spec_decode_enabled() -> bool:
    """Self-speculative decoding kill switch (default on). It only arms the
    path: an engine drafts when its `spec_k >= 1`. "0" is the A/B: greedy
    spec streams equal the plain chunked decode's."""
    return os.environ.get("REPRO_SPEC_DECODE", "1") not in (
        "0", "false", "off")


def spec_k(default: int = 0) -> int:
    """Default draft length of self-speculative decoding (0 = off)."""
    k = int(os.environ.get("REPRO_SPEC_K", default))
    if k < 0:
        raise ValueError(f"REPRO_SPEC_K={k}; want >= 0")
    return k


_SA_MODES = ("exact", "approx")


def sa_mode() -> str:
    mode = os.environ.get("REPRO_SA_MODE", "exact")
    if mode not in _SA_MODES:
        raise ValueError(f"REPRO_SA_MODE={mode!r}; want one of {_SA_MODES}")
    return mode
