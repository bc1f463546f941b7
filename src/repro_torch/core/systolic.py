"""Cycle-accurate timing model of the weight-stationary SA (paper §II–III).

The port's copy of the JAX package's `repro/core/systolic.py` (plain Python and
`math`); tests/test_torch_study.py holds it equal to the original.

Reproduces the latency behaviour of the two pipeline organizations:

* **baseline** (Fig. 3(b)) — 2-stage FMA per PE; PE *i+1* in a column may only
  start once PE *i* finished both stages (Fig. 4), so the partial sum advances
  one row every **2 cycles**.
* **skewed** (Fig. 6) — speculative exponent forwarding + retimed
  normalization overlap the stages of consecutive PEs, so the partial sum
  advances one row every **1 cycle**, at the cost of one extra trailing add
  stage per column (§III.B, last paragraph).

Both need the single rounding stage at the column south end.

Latency of one (R_used × C_used) weight tile streaming M input rows
(west-to-east input skew of C_used − 1 cycles; one result per cycle once the
pipeline is full):

    baseline: 2·R_used + (C_used − 1) + M + 1(round)
    skewed  :   R_used + (C_used − 1) + M + 1(extra add) + 1(round)

A full GEMM (M×K)·(K×N) tiles K over rows and N over columns of the array;
per-tile weight (re)loads are double-buffered (loading the next tile's
weights overlaps the current tile's compute — standard WS practice, same for
both designs) except the initial fill. Cross-tile K-partials accumulate in
the south-edge FP32 collectors (§II: round-once-per-column applies to the
on-array chain; the collectors add already-rounded FP32 values).
"""
from __future__ import annotations

import dataclasses
import math

BASELINE = "baseline"
SKEWED = "skewed"
PIPELINES = (BASELINE, SKEWED)

# Per-PE reduction latency in cycles (the paper's central quantity).
CYCLES_PER_ROW = {BASELINE: 2, SKEWED: 1}
# Extra trailing stages at the column end: skewed needs one extra add stage
# (§III.B); both need the rounding stage.
EXTRA_STAGES = {BASELINE: 1, SKEWED: 2}


@dataclasses.dataclass(frozen=True)
class SAConfig:
    """A systolic array instance (the paper evaluates 128×128 @ 1 GHz)."""

    rows: int = 128
    cols: int = 128
    freq_ghz: float = 1.0
    pipeline: str = SKEWED

    def __post_init__(self):
        if self.pipeline not in PIPELINES:
            raise ValueError(f"pipeline must be one of {PIPELINES}")


def tile_latency(M: int, r_used: int, c_used: int, pipeline: str) -> int:
    """Cycles for one resident weight tile to process M streaming rows."""
    fill = CYCLES_PER_ROW[pipeline] * r_used
    return fill + (c_used - 1) + M + EXTRA_STAGES[pipeline]


def gemm_latency(M: int, K: int, N: int, sa: SAConfig) -> int:
    """Total cycles for an (M×K)·(K×N) GEMM on the array.

    K maps to rows (reduction down the column), N to columns; tiles are
    processed back-to-back with double-buffered weight loads. The initial
    weight load of the first tile (r_used cycles, one row per cycle through
    the north ports) is exposed.
    """
    if min(M, K, N) <= 0:
        return 0
    kt, nt = math.ceil(K / sa.rows), math.ceil(N / sa.cols)
    total = min(K, sa.rows)  # exposed initial weight load
    for ki in range(kt):
        r_used = min(sa.rows, K - ki * sa.rows)
        for ni in range(nt):
            c_used = min(sa.cols, N - ni * sa.cols)
            total += tile_latency(M, r_used, c_used, sa.pipeline)
    return total


def gemm_macs(M: int, K: int, N: int) -> int:
    return M * K * N


def utilization(M: int, K: int, N: int, sa: SAConfig) -> float:
    """Fraction of PE-cycles doing useful MACs (PE array occupancy)."""
    cyc = gemm_latency(M, K, N, sa)
    return gemm_macs(M, K, N) / (cyc * sa.rows * sa.cols) if cyc else 0.0


def latency_s(M: int, K: int, N: int, sa: SAConfig) -> float:
    return gemm_latency(M, K, N, sa) / (sa.freq_ghz * 1e9)


def speedup(M: int, K: int, N: int, rows: int = 128, cols: int = 128) -> float:
    """Latency(baseline) / latency(skewed) for one GEMM — the paper's gain."""
    b = gemm_latency(M, K, N, SAConfig(rows, cols, pipeline=BASELINE))
    s = gemm_latency(M, K, N, SAConfig(rows, cols, pipeline=SKEWED))
    return b / s if s else 1.0
