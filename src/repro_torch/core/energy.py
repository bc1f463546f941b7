"""Area / power / energy model for the two SA pipeline designs (paper §IV).

The port's copy of the JAX package's `repro/core/energy.py` (plain Python and
`math`); tests/test_torch_study.py holds it equal to the original.

The paper's synthesis results (Catapult HLS → Oasys, 45 nm, 1 GHz, 128×128
PEs, Bfloat16 inputs / FP32 reduction, power via PowerPro):

  * skewed design area  = 1.09 × baseline  (extra pipeline registers for the
    intermediate ê / LZA forwards + the exponent-fix logic)
  * skewed design power = 1.07 × baseline  (average, across CNN layers)

Energy per layer is `power × latency`; the paper's headline result is that the
skew's latency savings amortize its power overhead: per-layer energy *rises*
for early CNN layers (M ≫ array fill time ⇒ tiny latency gain < 7 % power
cost) and *falls* sharply for late layers (small spatial M, many K/N tiles ⇒
the 2R→R fill saving dominates) — Figs. 7 & 8 — netting −8 % (MobileNet) /
−11 % (ResNet50) total energy.
"""
from __future__ import annotations

import dataclasses

from .systolic import BASELINE, SKEWED, SAConfig
from . import workloads as wl

# A third design point beyond the paper: the skewed pipeline with
# *approximate normalization* (arxiv 2408.11997 — the serve engine's "bulk"
# tier, core/chained_fma.approx_*). The coarse LZA drops the low bits of the
# count tree and the fine stages of every per-PE normalize∥align shifter —
# the barrel shifter is the dominant mux structure in the FMA add path — so
# the design gives back more area/power than the skew's forwarding registers
# cost. Timing is identical to SKEWED (1 cycle/row; the shift still happens,
# just quantized), so only the energy constants change.
SKEWED_APPROX = "skewed_approx"

# Paper §IV synthesis constants (relative to baseline); SKEWED_APPROX values
# are modeled from the 2408.11997 shifter/LZA reductions, not synthesized.
REL_AREA = {BASELINE: 1.00, SKEWED: 1.09, SKEWED_APPROX: 0.99}
REL_POWER = {BASELINE: 1.00, SKEWED: 1.07, SKEWED_APPROX: 0.97}

# Absolute anchors for reporting (per-PE, representative of a 45nm bf16 FMA
# at 1 GHz; only *ratios* matter for the paper's claims).
BASE_PE_POWER_MW = 1.9
BASE_PE_AREA_UM2 = 3600.0

# Two-component power split: a per-cycle component (clock tree, pipeline
# registers, leakage — scales with *area*, burns for every cycle the array is
# busy) and a per-MAC component (datapath switching — scales with useful work,
# which is identical for both designs, but each skewed MAC costs the fix-logic
# overhead). Register/clock power dominates dense SAs; 0.85/0.15 reproduces
# the paper's measured energy within ~1 % (see EXPERIMENTS.md §Paper-claims).
CYCLE_POWER_SHARE = 0.85
MAC_POWER_SHARE = 1.0 - CYCLE_POWER_SHARE
REL_MAC_ENERGY = {BASELINE: 1.00, SKEWED: 1.07, SKEWED_APPROX: 0.93}


@dataclasses.dataclass(frozen=True)
class EnergyReport:
    layer: str
    cycles_base: int
    cycles_skew: int
    energy_base: float  # µJ
    energy_skew: float  # µJ

    @property
    def latency_saving(self) -> float:
        return 1.0 - self.cycles_skew / self.cycles_base if self.cycles_base else 0.0

    @property
    def energy_saving(self) -> float:
        return 1.0 - self.energy_skew / self.energy_base if self.energy_base else 0.0


def array_power_w(sa: SAConfig) -> float:
    return REL_POWER[sa.pipeline] * BASE_PE_POWER_MW * 1e-3 * sa.rows * sa.cols


def array_area_mm2(sa: SAConfig) -> float:
    return REL_AREA[sa.pipeline] * BASE_PE_AREA_UM2 * 1e-6 * sa.rows * sa.cols


def layer_energy_uj(layer, sa: SAConfig, dw_mode: str = "packed") -> float:
    """E = per-cycle power × latency + per-MAC energy × MAC count."""
    cycles = wl.layer_latency(layer, sa, dw_mode)
    macs = wl.layer_macs(layer, sa.rows, dw_mode)
    p0 = BASE_PE_POWER_MW * 1e-3 * sa.rows * sa.cols        # W at full tilt
    e_cycle = (CYCLE_POWER_SHARE * p0 * REL_AREA[sa.pipeline]
               * cycles / (sa.freq_ghz * 1e9))
    # per-MAC energy anchored so that a fully-utilized baseline array splits
    # power 85/15 between the two components
    e_per_mac = MAC_POWER_SHARE * BASE_PE_POWER_MW * 1e-3 / (sa.freq_ghz * 1e9)
    e_mac = REL_MAC_ENERGY[sa.pipeline] * e_per_mac * macs
    return (e_cycle + e_mac) * 1e6


def network_report(name: str, rows: int = 128, cols: int = 128,
                   dw_mode: str = "packed") -> list[EnergyReport]:
    """Per-layer baseline-vs-skewed energy (the data behind Figs. 7/8)."""
    base = SAConfig(rows, cols, pipeline=BASELINE)
    skew = SAConfig(rows, cols, pipeline=SKEWED)
    out = []
    for layer in wl.WORKLOADS[name]():
        cb = wl.layer_latency(layer, base, dw_mode)
        cs = wl.layer_latency(layer, skew, dw_mode)
        out.append(EnergyReport(
            layer=layer.name, cycles_base=cb, cycles_skew=cs,
            energy_base=layer_energy_uj(layer, base, dw_mode),
            energy_skew=layer_energy_uj(layer, skew, dw_mode)))
    return out


def network_totals(name: str, rows: int = 128, cols: int = 128,
                   dw_mode: str = "packed") -> dict:
    reps = network_report(name, rows, cols, dw_mode)
    cb = sum(r.cycles_base for r in reps)
    cs = sum(r.cycles_skew for r in reps)
    eb = sum(r.energy_base for r in reps)
    es = sum(r.energy_skew for r in reps)
    return {
        "network": name, "dw_mode": dw_mode,
        "cycles_base": cb, "cycles_skew": cs,
        # a workload whose layers all degenerate to zero cycles/energy (e.g.
        # every dim rounds to 0 under an aggressive dw_mode) reports 0.0
        # saving, not ZeroDivisionError
        "latency_saving": 1 - cs / cb if cb else 0.0,
        "energy_base_uj": eb, "energy_skew_uj": es,
        "energy_saving": 1 - es / eb if eb else 0.0,
    }


# ---------------------------------------------------------------------------
# Serving-tier energy: per-token decode energy by datapath design
# ---------------------------------------------------------------------------

# Which SA design each serve datapath mode runs on (serve/engine.py chunks).
MODE_DESIGN = {"exact": SKEWED, "approx": SKEWED_APPROX}


def decode_token_energy_uj(macs_per_token: int, design: str = SKEWED,
                           freq_ghz: float = 1.0,
                           utilization: float = 1.0) -> float:
    """Modeled energy (µJ) to decode one token on an SA of `design`.

    Same two-component split as `layer_energy_uj`, expressed per token:
    busy cycles = macs / (rows · cols · utilization), so the array size
    cancels and only `utilization` (PE occupancy of the decode GEMMs —
    low at small batch, where fill time dominates) scales the per-cycle
    component. Ratios between designs are the meaningful output."""
    if macs_per_token <= 0:
        return 0.0
    base_w = BASE_PE_POWER_MW * 1e-3
    hz = freq_ghz * 1e9
    e_cycle = (CYCLE_POWER_SHARE * base_w * REL_AREA[design]
               * macs_per_token / (max(utilization, 1e-9) * hz))
    e_mac = (MAC_POWER_SHARE * base_w * REL_MAC_ENERGY[design]
             * macs_per_token / hz)
    return (e_cycle + e_mac) * 1e6


def tier_energy_summary(tier_mode_tokens: dict, macs_per_token: int,
                        freq_ghz: float = 1.0,
                        utilization: float = 1.0) -> dict:
    """Per-tier modeled decode energy for a served request stream.

    `tier_mode_tokens` is the scheduler's real-token accounting
    ({(tier, mode): tokens} or the summary's {"tier/mode": tokens}):
    tokens decoded on the approximate datapath are charged SKEWED_APPROX
    energy, everything else (premium, and bulk tokens that shared a chunk
    with premium) honest exact-datapath energy. Reports the saving vs
    running the identical stream all-exact."""
    counts: dict[tuple[str, str], int] = {}
    for key, n in tier_mode_tokens.items():
        tier, mode = key.split("/") if isinstance(key, str) else key
        counts[(tier, mode)] = counts.get((tier, mode), 0) + int(n)
    e_tok = {m: decode_token_energy_uj(macs_per_token, d, freq_ghz,
                                       utilization)
             for m, d in MODE_DESIGN.items()}
    per_tier: dict[str, float] = {}
    total = exact_total = 0.0
    tokens = 0
    for (tier, mode), n in sorted(counts.items()):
        e = n * e_tok[mode]
        per_tier[tier] = per_tier.get(tier, 0.0) + e
        total += e
        exact_total += n * e_tok["exact"]
        tokens += n
    return {
        "tokens": tokens,
        "energy_uj": round(total, 3),
        "energy_uj_all_exact": round(exact_total, 3),
        "energy_saving": round(1 - total / exact_total, 4)
        if exact_total else 0.0,
        "tier_energy_uj": {t: round(e, 3)
                           for t, e in sorted(per_tier.items())},
        "token_energy_uj": {m: round(e, 6) for m, e in sorted(e_tok.items())},
    }
