"""Predictive frontier-growth forecasting for capacity sizing.

A copy of the JAX package's ``tla_raft_tpu/engine/forecast.py`` (which
imports no JAX), cut to what the port's fused level and supersteps use:
``forecast_new_states`` (the per-level new-state forecast from the
measured growth-ratio decay), ``cap_margin`` (the 1.25 capacity margin,
``TLA_RAFT_CAP_MARGIN`` overrides) and ``pow2ceil``.  The reference's
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
