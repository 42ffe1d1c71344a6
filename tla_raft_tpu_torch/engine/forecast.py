"""Predictive frontier-growth forecasting for capacity sizing.

A copy of the JAX package's ``tla_raft_tpu/engine/forecast.py`` (which
imports no JAX), cut to what the port's fused level, supersteps, presize, prewarm and mesh
use: ``forecast_new_states`` (the per-level new-state forecast from the
measured growth-ratio decay), ``forecast_peak_new`` (its largest level:
the sweep service's bucket capacities), ``forecast_final_distinct``,
``horizon_forecast`` (the presize signal, with ``PRESIZE_HORIZON`` and the
``TLA_RAFT_PRESIZE_BYTES`` budget), ``shape_plan`` and ``pow2_ladder`` (the
prewarm's rows and capacity steps), ``cap_margin`` (the 1.25 capacity
margin, ``TLA_RAFT_CAP_MARGIN`` overrides) and ``pow2ceil``.  The reference's
``cap_margin`` also consults an autotuner plan; the port has no tuner yet,
so the environment and the default are all it reads.

The model: on BFS level n the new-state count grows by a ratio r_n that
decays roughly linearly with depth.  Extrapolation marches the last
observed ratio down by the observed decay; the capacity layer rounds the
forecast up to its ladder of shapes, so one captured program serves a
whole range of level sizes.
"""

from __future__ import annotations

import os

# measured ratio decay per level on the reference sweep (BASELINE.md);
# used when fewer than 4 level ratios have been observed
DEFAULT_DECAY = 0.017
# forecasts from fewer observed levels than this are noise (early BFS
# ratios on the reference family swing 1.0-3.0)
MIN_LEVELS = 6

# capacity decisions trust the model at most this many levels ahead (the
# reference's presize horizon: a short noisy prefix extrapolates to nonsense
# at long range)
PRESIZE_HORIZON = 8

# capacity inflation over the raw forecast: the margin the fused level's
# output capacity, the superstep's frontier seat and its ring share.
# Hand-set at 1.25; TLA_RAFT_CAP_MARGIN overrides.
DEFAULT_CAP_MARGIN = 1.25


def cap_margin(default: float = DEFAULT_CAP_MARGIN) -> float:
    env = os.environ.get("TLA_RAFT_CAP_MARGIN")
    if env:
        return max(1.0, float(env))
    return max(1.0, float(default))


def pow2ceil(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    return 1 << max(0, int(n) - 1).bit_length()


def _ratio_model(level_sizes) -> tuple[float, float]:
    """(last growth ratio, per-level ratio decay) from observed levels."""
    f = [int(x) for x in level_sizes if x > 0]
    if len(f) < 2:
        return 3.0, DEFAULT_DECAY  # early fan-out: conservative
    ratios = [f[i] / f[i - 1] for i in range(1, len(f))]
    r = ratios[-1]
    # the decay itself shrinks with depth, so estimate from the LAST
    # three ratio steps only (median: one skewed level can't bend it);
    # measured on the golden record this tracks the forward decay
    # within ~7% over an 8-level horizon
    diffs = [
        ratios[i - 1] - ratios[i]
        for i in range(max(1, len(ratios) - 3), len(ratios))
    ]
    if diffs:
        diffs.sort()
        d = diffs[len(diffs) // 2]
    else:
        d = DEFAULT_DECAY
    # clamp: negative observed decay (noise) would forecast super-
    # exponential growth; huge decay would truncate the run to nothing.
    # Both clamps are conservative for CAPACITY use (they over-predict).
    return r, min(0.08, max(0.005, d))


def forecast_new_states(
    level_sizes,
    target_depth: int | None,
    max_levels: int = 128,
) -> list[int]:
    """Extrapolated per-level new-state counts beyond the observed prefix.

    ``level_sizes``: observed new states for levels 0..L (level 0 is the
    single init state).  Returns forecasts for levels L+1..target_depth;
    with ``target_depth=None`` (fixpoint run) the projection runs until
    the modeled frontier decays below 1 state or ``max_levels`` is hit.
    Empty when the target is already reached or there is no signal yet.
    """
    obs = [int(x) for x in level_sizes]
    depth_now = len(obs) - 1
    if depth_now < 1 or (target_depth is not None and target_depth <= depth_now):
        return []
    r, d = _ratio_model(obs)
    if target_depth is None:
        # open horizon: a noise-floored decay would extrapolate early
        # ratios into astronomically large "fixpoints" (observed: 10^29
        # on a 50-state config).  Force at least the measured reference
        # decay, and below: trust the projection only if it CONVERGES.
        d = max(d, DEFAULT_DECAY)
    out: list[int] = []
    f = float(obs[-1])
    level = depth_now
    while len(out) < max_levels:
        level += 1
        if target_depth is not None and level > target_depth:
            break
        r = max(0.05, r - d)
        f = f * r
        if f < 1.0:
            break
        out.append(int(f) + 1)
    if target_depth is None and len(out) >= max_levels:
        return []  # projection never reached a fixpoint: no usable signal
    return out


def forecast_peak_new(level_sizes, target_depth: int | None) -> int:
    """Forecast the largest per-level new-state count over the run."""
    return max(forecast_new_states(level_sizes, target_depth), default=0)


def forecast_final_distinct(level_sizes, distinct: int, target_depth: int | None) -> int:
    """Forecast total distinct states at the end of the run."""
    return distinct + sum(forecast_new_states(level_sizes, target_depth))


def presize_budget() -> int:
    """``TLA_RAFT_PRESIZE_BYTES`` (default 4e9): the device bytes a presize
    or a prewarm may commit ahead of the levels that need them."""
    return int(float(os.environ.get("TLA_RAFT_PRESIZE_BYTES", "4e9")))


def shape_plan(level_sizes, target_depth: int | None, margin: float | None = None) -> list:
    """Margin-inflated per-level row forecast over the presize horizon,
    the prewarm's input (reference forecast.py:150): one entry a forecast
    level, the rows it is expected to need inflated by the capacity
    margin; empty without a usable signal."""
    if margin is None:
        margin = cap_margin()
    fut = forecast_new_states(level_sizes, target_depth)[:PRESIZE_HORIZON]
    return [int(f * margin) + 1 for f in fut]


def pow2_ladder(lo: int, hi: int) -> list:
    """Powers of two strictly above ``lo`` up to pow2ceil(``hi``): the
    capacity steps a growing structure visits on its way from ``lo`` to a
    forecast peak (reference forecast.py:169)."""
    out = []
    c = pow2ceil(max(1, lo))
    if c <= lo:
        c <<= 1
    top = pow2ceil(max(1, hi))
    while c <= top:
        out.append(c)
        c <<= 1
    return out


def horizon_forecast(level_sizes, distinct: int, target_depth: int | None):
    """The mesh's presize signal: (peak_new, final_distinct, budget) over
    the next ``PRESIZE_HORIZON`` forecast levels, the budget from
    ``TLA_RAFT_PRESIZE_BYTES`` (default 4e9); None without a usable
    signal (reference forecast.py:132)."""
    fut = forecast_new_states(level_sizes, target_depth)[:PRESIZE_HORIZON]
    if not fut:
        return None
    return max(fut), distinct + sum(fut), presize_budget()


def per_device_forecast(level_sizes, distinct: int, target_depth: int | None,
                        n_devices: int):
    """Per-device capacity signal of the sharded deep sweep (the
    reference's forecast.py:209-239): each device owns ~1/D of a level
    (fp % D), with a 1.35x margin for the skew and a +32 floor.  None
    without a usable signal, else {peak_rows: the largest per-level share
    one device owns, final_rows: its final distinct share (the deep sieve's
    entry forecast), budget: TLA_RAFT_PRESIZE_BYTES}."""
    sig = horizon_forecast(level_sizes, distinct, target_depth)
    if sig is None:
        return None
    peak_new, final_distinct, budget = sig
    share = peak_new / n_devices
    peak_rows = int(share * 1.35) + 32
    final_rows = int(final_distinct / n_devices * 1.35) + 32
    return dict(peak_rows=peak_rows, final_rows=final_rows, budget=budget)
