"""Online approximation-quality monitors for spectral-shift serving (the
port's own copy of ``repro/telemetry/monitors.py``).

The method's pitch over plain Nystrom attention is a tighter error bound
when the softmax spectrum decays *slowly* — which makes approximation
quality a property of the traffic, not the code. ``benchmarks/bench_drift``
measures it offline; these monitors track the same two signals online, per
request, from state the engine already computes:

* **Rebase drift residual** (``DriftMonitor``): a frozen-mode segment
  boundary rebase recomputes the active-row stats *exactly* — so the
  difference between the streamed (stale) row and the exact recompute is a
  free online measurement of the B-side staleness bench_drift calls
  ``bv_drift``. ``bv_row_residual`` is the shared formula (max relative
  per-row BV error, identical to the offline bench), evaluated on the
  O(c*d) stats leaves only — never the horizon.

* **Landmark-mass concentration** (``SpectrumMonitor``): how evenly the
  landmark-to-key softmax mass spreads across landmark rows. Per row the
  true softmax mass is ``Z_r = l_r * exp(m_r)`` (the online-softmax
  partials the cache already carries); normalizing over reached rows gives
  a distribution whose top-1 share and participation ratio proxy the
  softmax spectrum decay: mass spread thin across many landmarks is the
  paper's slow-decay regime, where the spectral-shift correction is doing
  the most work and frozen-mode drift deserves attention. Tracked as an
  EMA so one odd request doesn't whipsaw the gauge.

Both are pure-numpy host probes over (c,)-sized state: cheap enough to run
on every boundary rebase / retirement, and only instantiated when
``ServeConfig.telemetry`` is on.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

_EPS = 1e-30


def bv_from_stats(l, acc):
    """BV rows from online-softmax partials: ``acc / max(l, eps)``."""
    l = np.asarray(l, np.float64)
    acc = np.asarray(acc, np.float64)
    return acc / np.maximum(l, _EPS)


def bv_row_residual(pre, post, rows: Sequence[int]) -> float:
    """Max relative BV-row residual between two stats snapshots, over the
    given landmark rows — the same per-row formula as bench_drift:

        max_r  || bv_pre[..., r, :] - bv_post[..., r, :] ||
               / max(|| bv_post[..., r, :] ||, eps)

    ``pre``/``post`` are ``(l, acc)`` pairs with the landmark axis at -2;
    arbitrary leading (layer/batch/head) axes reduce through the max."""
    bv_pre = bv_from_stats(*pre)[..., list(rows), :]
    bv_post = bv_from_stats(*post)[..., list(rows), :]
    num = np.linalg.norm(bv_pre - bv_post, axis=-1)
    den = np.maximum(np.linalg.norm(bv_post, axis=-1), _EPS)
    return float(np.max(num / den))


def spectrum_mass(m, l, reached: int) -> tuple[float, float]:
    """(top1_share, effective_landmark_fraction) of the landmark softmax
    mass over the first ``reached`` rows.

    Row mass in log space is ``m_r + log(l_r)`` (anchor-corrected, so rows
    with different online-softmax anchors compare correctly); softmaxing
    over rows gives the mass distribution ``p``. Returns its max share and
    the participation ratio ``1 / sum(p^2)`` as a fraction of ``reached``
    (1.0 = perfectly even mass = the slow-decay regime; -> 1/reached = all
    mass on one landmark). Leading (layer/head) axes are averaged."""
    reached = max(int(reached), 1)
    m = np.asarray(m, np.float64)[..., :reached, :]
    l = np.asarray(l, np.float64)[..., :reached, :]
    logz = m + np.log(np.maximum(l, _EPS))
    logz = logz - np.max(logz, axis=-2, keepdims=True)
    p = np.exp(logz)
    p = p / np.maximum(np.sum(p, axis=-2, keepdims=True), _EPS)
    top1 = float(np.mean(np.max(p, axis=-2)))
    pr = 1.0 / np.maximum(np.sum(p * p, axis=-2), _EPS)
    eff = float(np.mean(pr)) / reached
    return top1, eff


class DriftMonitor:
    """Registry-backed accumulator of per-rebase drift residuals."""

    def __init__(self, registry):
        from repro_torch.telemetry.metrics import RATIO_BUCKETS

        self.hist = registry.histogram(
            "drift_rebase_residual",
            help="relative BV-row staleness cleared by each boundary rebase",
            buckets=RATIO_BUCKETS,
        )
        self.last = registry.gauge(
            "drift_rebase_residual_last",
            help="most recent rebase residual",
        )

    def observe(self, residual: float) -> None:
        self.hist.observe(residual)
        self.last.set(residual)


class SpectrumMonitor:
    """EMA of landmark-softmax mass concentration (spectrum-decay proxy)."""

    def __init__(self, registry, alpha: float = 0.1):
        self.alpha = alpha
        self._top1 = None
        self._eff = None
        self.top1 = registry.gauge(
            "spectrum_mass_top1_ema",
            help="EMA of the largest landmark's softmax-mass share",
        )
        self.eff = registry.gauge(
            "spectrum_eff_landmark_frac_ema",
            help="EMA participation-ratio fraction of reached landmarks "
                 "(near 1 = evenly spread mass = slow spectrum decay)",
        )
        self.observations = registry.counter(
            "spectrum_observations_total",
            help="spectrum-mass probe evaluations",
        )

    def observe(self, m, l, reached: int) -> None:
        top1, eff = spectrum_mass(m, l, reached)
        a = self.alpha
        self._top1 = top1 if self._top1 is None else a * top1 + (1 - a) * self._top1
        self._eff = eff if self._eff is None else a * eff + (1 - a) * self._eff
        self.top1.set(self._top1)
        self.eff.set(self._eff)
        self.observations.inc()
