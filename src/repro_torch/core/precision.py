"""The paper's arithmetic contract as the port-wide GEMM entry point.

Every matrix multiplication of the port goes through :func:`sa_dot` (or
:func:`sa_einsum` for attention), which enforces the systolic-array
datapath semantics of the paper (§II):

  * inputs quantized to a reduced-precision format (Bfloat16 / FP8),
  * products accumulated in FP32 with no intermediate rounding,
  * one rounding at the end of the reduction.

Backends (``REPRO_GEMM_BACKEND``):
  * ``torch`` — the plain version (default): operands upcast to fp32 and
                `torch.matmul` in fp32 with TF32 off. The upcast matters:
                `torch.matmul` on bf16 tensors rounds its result to bf16,
                which breaks the round-once contract.
  * ``cuda``  — the hand-written SA GEMM kernel
                (`repro_torch.kernels.ops.sa_matmul`) with the fused
                epilogue; on a CPU tensor that call runs the plain version.
  * ``emulate`` — the paper's bit-exact skewed integer datapath
                (`repro_torch.kernels.ops.skewed_datapath_matmul`: the
                hand-written fp_emu kernel on the card, its plain version on
                the CPU; `approx` mode is the coarse-LZA chain), 2-D GEMMs
                of a format whose significand product fits the 27-bit
                accumulator (not fp32), epilogue in fp32 after it.

FP8 input and output formats round through the quantize kernel
(`ops.quantize_fp8` at scale 1, bit-identical to `fpformats.quantize`).
"""
from __future__ import annotations

import dataclasses

import torch

from . import optflags
from .fpformats import get_format, quantize

# TF32 keeps 10 mantissa bits: a float32 product on the card must stay a
# float32 product for the contract to hold.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_TORCH_INPUT_DTYPE = {"bf16": torch.bfloat16, "fp16": torch.float16}


def exact_cpu_containers(device) -> bool:
    """fp32 containers on the CPU, reduced-format containers on CUDA.

    Every reduced-format value is exact in fp32 and products of <= 12-bit
    significands are exact in fp32, so carrying quantized values in fp32
    containers on the CPU is bit-identical to the bf16 contract; on the
    card the operands stay bf16 (half the bytes) and the kernels upcast.
    The meta device (the dry run) takes the card's containers."""
    from .device import card_program
    return not card_program(device)


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """What the SA does to a GEMM: formats + backend."""

    input_format: str = "bf16"       # paper's evaluated configuration
    accum_format: str = "fp32"       # "double-width reduction"
    output_format: str = "fp32"      # rounding target at the column end
    backend: str = "torch"           # torch | cuda | emulate
    mode: str = "exact"              # exact | approx (bulk-tier coarse LZA)

    def __post_init__(self):
        get_format(self.input_format)
        if self.accum_format != "fp32":
            raise ValueError("the SA reduces in FP32 (paper §II)")
        if self.backend not in ("torch", "cuda", "emulate"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.mode not in ("exact", "approx"):
            raise ValueError(f"unknown SA mode {self.mode!r}")
        if self.backend == "emulate":
            from repro_torch.kernels.fp_emu import check_format
            check_format(self.input_format)

    def cast_in(self, x: torch.Tensor) -> torch.Tensor:
        fmt = get_format(self.input_format)
        if fmt.name == "fp32":
            return x.to(torch.float32)
        if fmt.name in ("bf16", "fp16"):
            q = x.to(_TORCH_INPUT_DTYPE[fmt.name])
            return q.to(torch.float32) if exact_cpu_containers(x.device) else q
        # fp8: values snapped to the format's grid by the quantize kernel,
        # carried in bf16 on the card (bf16 holds every FP8 value exactly)
        q = _quantize(x, fmt)
        return q if exact_cpu_containers(x.device) else q.to(torch.bfloat16)

    def cast_out(self, y: torch.Tensor) -> torch.Tensor:
        fmt = get_format(self.output_format)
        if fmt.name == "fp32":
            return y.to(torch.float32)
        return _quantize(y, fmt)


def _quantize(x: torch.Tensor, fmt) -> torch.Tensor:
    """`fpformats.quantize`, with FP8 formats through `ops.quantize_fp8`
    at scale 1 (x · (1/1) = x exactly, so the two are bit-identical)."""
    if fmt.name in ("fp8_e4m3", "fp8_e5m2"):
        from repro_torch.kernels import ops  # lazy: kernels import this module
        return ops.quantize_fp8(x, 1.0, fmt.name)
    return quantize(x, fmt)


_POLICY_STACK: list[PrecisionPolicy] = [
    PrecisionPolicy(backend=optflags.gemm_backend(), mode=optflags.sa_mode())]


def input_dtype(policy: PrecisionPolicy | None = None):
    """The 16-bit type `cast_in` rounds an operand to under `policy`
    (default the current one): bf16 or fp16, None for fp32 and the FP8
    formats."""
    policy = policy or current_policy()
    return _TORCH_INPUT_DTYPE.get(get_format(policy.input_format).name)


def current_policy() -> PrecisionPolicy:
    """Innermost `use_policy` scope, else the default policy that tracks
    REPRO_GEMM_BACKEND / REPRO_SA_MODE at call time."""
    if len(_POLICY_STACK) == 1:
        backend, mode = optflags.gemm_backend(), optflags.sa_mode()
        if (backend != _POLICY_STACK[0].backend
                or mode != _POLICY_STACK[0].mode):
            _POLICY_STACK[0] = PrecisionPolicy(backend=backend, mode=mode)
    return _POLICY_STACK[-1]


class use_policy:
    """Context manager scoping the active precision policy."""

    def __init__(self, policy: PrecisionPolicy):
        self.policy = policy

    def __enter__(self):
        _POLICY_STACK.append(self.policy)
        return self.policy

    def __exit__(self, *exc):
        _POLICY_STACK.pop()


def sa_dot(a: torch.Tensor, w: torch.Tensor,
           policy: PrecisionPolicy | None = None, *,
           bias: torch.Tensor | None = None, act: str = "none"
           ) -> torch.Tensor:
    """`a @ w` under the SA arithmetic contract. Batched `a` supported
    (not under `emulate`, which takes 2-D GEMMs only).

    `bias`/`act` are the fused epilogue, applied to the fp32 chain before
    the single output rounding on every backend. ``policy.mode ==
    "approx"`` truncates the chain's low mantissa bits first
    (`kernels.sa_matmul.truncate_mantissa`) on `torch` and `cuda`, and
    runs the coarse-LZA chain under `emulate`.

    Gradients: `torch` differentiates through plain autograd (the JAX
    `xla` backend's way), `cuda` through `SAMatmulFn` (the kernel's VJP),
    and `emulate` raises where autograd would record the call. `cast_in`
    is differentiable: its cast's backward rounds each cotangent to the
    input format, as JAX's transpose of `astype` does."""
    from repro_torch.kernels import ops  # lazy: kernels import this module
    from repro_torch.kernels.sa_matmul import EPILOGUES, apply_act

    policy = policy or current_policy()
    if policy.backend == "emulate":
        from repro_torch.kernels.sa_matmul import needs_grad
        if needs_grad(a, w, bias):
            raise ValueError("the emulate backend has no gradient, as in "
                             "the JAX package (its datapath is a host "
                             "callback there)")
        if a.ndim != 2 or w.ndim != 2:
            raise ValueError("emulate backend supports 2-D GEMMs only")
        if act not in EPILOGUES:
            raise ValueError(f"unknown epilogue act {act!r}; have "
                             f"{EPILOGUES}")
        y = ops.skewed_datapath_matmul(policy.cast_in(a), policy.cast_in(w),
                                       policy.input_format, policy.mode)
        if bias is not None:
            y = y + bias.to(torch.float32)
        return policy.cast_out(apply_act(y, act))
    a_q, w_q = policy.cast_in(a), policy.cast_in(w)
    if policy.backend == "cuda":
        if w_q.ndim != 2:
            raise ValueError(f"the cuda GEMM backend takes a 2-D weight, got "
                             f"{tuple(w_q.shape)}")
        # batched `a` folds into the kernel's M rows
        y = ops.sa_matmul(a_q.reshape(-1, a_q.shape[-1]), w_q, bias=bias,
                          act=act, mode=policy.mode)
        return policy.cast_out(y.reshape(*a_q.shape[:-1], w_q.shape[1]))
    from repro_torch.kernels.sa_matmul import sa_matmul_ref

    return policy.cast_out(sa_matmul_ref(a_q, w_q, bias=bias, act=act,
                                         mode=policy.mode))


def sa_dot_chain(a: torch.Tensor, w: torch.Tensor,
                 policy: PrecisionPolicy | None = None) -> torch.Tensor:
    """The unrounded fp32 chain of `a @ w` under the SA contract: the
    inputs cast in, the exact chain, no epilogue, no truncation, no output
    rounding: a row-parallel GEMM's partial over its K slice, which the
    ranks all-reduce in fp32 before `sa_finish`. On `cuda` it is the
    hand-written SA GEMM's raw fp32 output (an exact-mode call without an
    epilogue returns the chain as accumulated); `emulate` has no gradient
    and is refused."""
    policy = policy or current_policy()
    if policy.backend == "emulate":
        raise ValueError("the emulate backend has no row-parallel partial "
                         "(no gradient, no training path)")
    return sa_dot(a, w, dataclasses.replace(policy, mode="exact",
                                            output_format="fp32"))


def sa_finish(y: torch.Tensor,
              policy: PrecisionPolicy | None = None) -> torch.Tensor:
    """What `sa_dot` does after the chain, without an epilogue: the approx
    truncation, then the single rounding to the output format."""
    from repro_torch.kernels.sa_matmul import truncate_mantissa

    policy = policy or current_policy()
    if policy.mode == "approx":
        y = truncate_mantissa(y)
    return policy.cast_out(y)


def sa_einsum(spec: str, a: torch.Tensor, w: torch.Tensor,
              policy: PrecisionPolicy | None = None) -> torch.Tensor:
    """Einsum under the SA contract (attention paths)."""
    from repro_torch.kernels.sa_matmul import truncate_mantissa

    policy = policy or current_policy()
    a_q = policy.cast_in(a).to(torch.float32)
    w_q = policy.cast_in(w).to(torch.float32)
    y = torch.einsum(spec, a_q, w_q)
    if policy.mode == "approx":
        y = truncate_mantissa(y)
    return policy.cast_out(y)
