"""Seeded open-loop arrival times, offered on the wall clock.

Frozen copy of the generators of ``src/repro_torch/workload/__init__.py`` at
commit f4e3f2d (``poisson``, ``diurnal``, ``bursty``, ``heavy-tailed``,
one ``numpy`` ``default_rng`` seeded from ``(seed, process name)``), without
its registry and SLO classes.  There the times are virtual seconds that
``Deployment.schedule`` feeds to the engine's clock; here they are offsets
from the start of the measured window, and the harness submits each request
when the wall clock reaches it.

Added here: ``poisson-stratified``, a Poisson process whose gaps are the
exponential distribution's quantiles, shuffled by the seed.  Every seed
then offers the same number of requests with the same gaps over the same
span, in another order, so that a seed changes when the work comes and not
how much of it there is.
"""

from __future__ import annotations

import zlib

import numpy as np


def _poisson(rate: float, duration_s: float, rng: np.random.Generator):
    """Constant-rate Poisson process: exponential inter-arrival gaps."""
    times = []
    t = float(rng.exponential(1.0 / rate))
    while t < duration_s:
        times.append(t)
        t += float(rng.exponential(1.0 / rate))
    return times


def _diurnal(rate: float, duration_s: float, rng: np.random.Generator,
             amplitude: float = 0.75):
    """Day-shaped inhomogeneous Poisson process, sampled by thinning."""
    lam_max = rate * (1.0 + amplitude)
    times = []
    t = float(rng.exponential(1.0 / lam_max))
    while t < duration_s:
        lam = rate * (1.0 + amplitude * np.sin(
            2.0 * np.pi * t / duration_s - np.pi / 2.0))
        if rng.random() < lam / lam_max:
            times.append(t)
        t += float(rng.exponential(1.0 / lam_max))
    return times


def _bursty(rate: float, duration_s: float, rng: np.random.Generator,
            burst_factor: float = 6.0, burst_frac: float = 0.15,
            cycles: float = 6.0):
    """Two-state MMPP: quiet baseline punctuated by high-rate bursts."""
    if burst_frac * burst_factor >= 1.0:
        raise ValueError("burst_frac * burst_factor must be < 1 "
                         "(mean rate could not equal the requested rate)")
    lam_on = burst_factor * rate
    lam_off = rate * (1.0 - burst_frac * burst_factor) / (1.0 - burst_frac)
    cycle_s = duration_s / cycles
    mean_on, mean_off = burst_frac * cycle_s, (1.0 - burst_frac) * cycle_s
    times = []
    t, burst = 0.0, False  # start quiet: bursts arrive mid-trace
    phase_end = float(rng.exponential(mean_off))
    while t < duration_s:
        lam = lam_on if burst else lam_off
        t += float(rng.exponential(1.0 / lam))
        while t >= phase_end:  # phase flips carry no arrival of their own
            burst = not burst
            t = phase_end + float(rng.exponential(
                1.0 / (lam_on if burst else lam_off)))
            phase_end += float(rng.exponential(mean_on if burst else mean_off))
        if t < duration_s:
            times.append(t)
    return times


def _heavy_tailed(rate: float, duration_s: float, rng: np.random.Generator,
                  alpha: float = 1.8):
    """Pareto inter-arrival gaps: long silences, then clumps."""
    if alpha <= 1.0:
        raise ValueError("alpha must be > 1 (gaps need a finite mean)")
    x_m = (alpha - 1.0) / (alpha * rate)
    times = []
    t = x_m * (1.0 + float(rng.pareto(alpha)))
    while t < duration_s:
        times.append(t)
        t += x_m * (1.0 + float(rng.pareto(alpha)))
    return times


def _poisson_stratified(rate: float, duration_s: float, rng: np.random.Generator):
    """floor(rate * duration) arrivals whose gaps are the exponential
    quantiles at (k + 1/2) / n, in the order of a seeded permutation."""
    n = int(rate * duration_s)
    if n < 1:
        return []
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps *= duration_s / gaps.sum() * (n - 0.5) / n  # the last arrival inside the span
    return list(np.cumsum(rng.permutation(gaps)))


PROCESSES = {
    "poisson": _poisson,
    "diurnal": _diurnal,
    "bursty": _bursty,
    "heavy-tailed": _heavy_tailed,
    "poisson-stratified": _poisson_stratified,
}


def arrival_times(process: str, *, rate: float, duration_s: float, seed: int,
                  **kwargs) -> list[float]:
    """Sorted arrival offsets in [0, duration_s) of ``process`` at ``rate``."""
    if process not in PROCESSES:
        raise ValueError(f"unknown arrival process {process!r}; known: {sorted(PROCESSES)}")
    if rate <= 0 or duration_s <= 0:
        raise ValueError("rate and duration_s must be > 0")
    rng = np.random.default_rng([int(seed) % 2**64, zlib.crc32(process.encode())])
    return sorted(float(t) for t in PROCESSES[process](rate, duration_s, rng, **kwargs)
                  if 0.0 <= t < duration_s)
