"""Trace-driven open-loop workload generation.

The paper's throughput claim is measured closed-loop: the benchmark submits a
fixed batch of requests and drains it, so offered load always equals served
load.  Serving millions of users (the ROADMAP north star) is the opposite
regime -- requests arrive on *their* schedule, not the engine's -- so this
package generates seeded arrival traces that the serving loops admit by
timestamp on the virtual clock:

  * ``poisson``      -- memoryless arrivals at a constant mean rate (M/·/·);
  * ``diurnal``      -- an inhomogeneous Poisson process whose intensity
    follows a day-shaped sinusoid (trough at the trace edges, peak in the
    middle), sampled by thinning;
  * ``bursty``       -- a two-state Markov-modulated Poisson process (on/off
    bursts): short high-rate bursts over a quiet baseline, the classic
    flash-crowd shape autoscalers must absorb;
  * ``heavy-tailed`` -- Pareto inter-arrival gaps (finite mean, infinite
    variance for ``alpha <= 2``): long silences punctuated by clumps.

Every generator draws from one ``numpy`` ``default_rng`` seeded from
``(seed, trace-name)``, so a ``(name, rate, duration_s, seed)`` tuple is a
complete, reproducible description of the offered load -- the determinism
regression tests and the chaos-seed matrix depend on that.

Traces are registered like strategies and codecs (``@register_trace``), so an
unknown name fails fast with suggestions and the CLI/spec can enumerate them.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Mapping, Sequence

import numpy as np

from repro_torch.core.registry import (
    Registry,
    UnknownNameError,
    suggest,
    unknown_message,
)


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One request arrival: a virtual-clock timestamp + its SLO class."""

    t_s: float
    slo_class: str | None = None


@dataclasses.dataclass(frozen=True)
class Trace:
    """A generated arrival schedule (sorted by time, all within duration)."""

    name: str
    arrivals: tuple[Arrival, ...]
    duration_s: float
    rate: float  # requested mean rate (arrivals/s)
    seed: int

    @property
    def n(self) -> int:
        return len(self.arrivals)

    @property
    def offered_rate(self) -> float:
        """Realized arrivals/s (the requested ``rate`` up to sampling noise)."""
        return self.n / self.duration_s if self.duration_s > 0 else 0.0

    def summary(self) -> dict:
        return {
            "trace": self.name,
            "n": self.n,
            "duration_s": self.duration_s,
            "rate": self.rate,
            "offered_rate": self.offered_rate,
            "seed": self.seed,
        }


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

class UnknownTraceError(UnknownNameError):
    """Trace name not registered; message lists near-misses + all names."""

    def __init__(self, name: str):
        known = list_traces()
        suggestions = suggest(name, known)
        super().__init__(
            unknown_message("trace", name, known, suggestions, style="inline"),
            name=name, known=known, suggestions=suggestions,
        )


# Generators live in this module, so no lazy-import hook is needed; the
# registry historically allows re-registration (overwrite) for traces.
_TRACES = Registry(
    "trace",
    error=lambda name, known: UnknownTraceError(name),
    allow_overwrite=True,
)


def register_trace(name: str):
    """Register ``fn(rate, duration_s, rng) -> iterable of arrival times``."""

    def deco(fn):
        _TRACES.register(name, fn)
        return fn

    return deco


def list_traces() -> tuple[str, ...]:
    return _TRACES.names()


def get_trace_generator(name: str) -> Callable:
    return _TRACES.get(name)


# ---------------------------------------------------------------------------
# Generators
# ---------------------------------------------------------------------------

@register_trace("poisson")
def _poisson(rate: float, duration_s: float, rng: np.random.Generator):
    """Constant-rate Poisson process: exponential inter-arrival gaps."""
    times = []
    t = float(rng.exponential(1.0 / rate))
    while t < duration_s:
        times.append(t)
        t += float(rng.exponential(1.0 / rate))
    return times


@register_trace("diurnal")
def _diurnal(rate: float, duration_s: float, rng: np.random.Generator,
             amplitude: float = 0.75):
    """Day-shaped inhomogeneous Poisson process, sampled by thinning.

    Intensity ``lambda(t) = rate * (1 + amplitude * sin(2*pi*t/T - pi/2))``:
    trough at the trace edges, peak (``(1+amplitude) * rate``) at mid-trace,
    mean exactly ``rate``.  Thinning: draw candidates at the peak intensity
    and keep each with probability ``lambda(t) / lambda_max``.
    """
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


@register_trace("bursty")
def _bursty(rate: float, duration_s: float, rng: np.random.Generator,
            burst_factor: float = 6.0, burst_frac: float = 0.15,
            cycles: float = 6.0):
    """Two-state MMPP: quiet baseline punctuated by high-rate bursts.

    A fraction ``burst_frac`` of the time is spent in the burst state at
    ``burst_factor * rate``; the off-state rate is solved so the long-run
    mean stays ``rate`` (requires ``burst_frac * burst_factor < 1``).  State
    holding times are exponential with means sized for ``cycles`` on/off
    cycles per trace.
    """
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


@register_trace("heavy-tailed")
def _heavy_tailed(rate: float, duration_s: float, rng: np.random.Generator,
                  alpha: float = 1.8):
    """Pareto inter-arrival gaps: long silences, then clumps.

    Gap = ``x_m * (1 + Pareto(alpha))`` with scale ``x_m`` chosen so the
    mean gap is ``1/rate``; ``alpha <= 2`` gives infinite gap variance --
    the tail the latency percentiles must survive.
    """
    if alpha <= 1.0:
        raise ValueError("alpha must be > 1 (gaps need a finite mean)")
    x_m = (alpha - 1.0) / (alpha * rate)
    times = []
    t = x_m * (1.0 + float(rng.pareto(alpha)))
    while t < duration_s:
        times.append(t)
        t += x_m * (1.0 + float(rng.pareto(alpha)))
    return times


# ---------------------------------------------------------------------------
# Front door
# ---------------------------------------------------------------------------

def _normalize_classes(classes) -> list[tuple[str, float]]:
    """Accept ``{name: weight}``, ``[(name, weight)]``, or objects with
    ``.name``/``.weight`` (e.g. ``api.spec.SLOClass``)."""
    if classes is None:
        return []
    if isinstance(classes, Mapping):
        pairs = [(str(k), float(v)) for k, v in classes.items()]
    else:
        pairs = []
        for c in classes:
            if isinstance(c, (tuple, list)):
                pairs.append((str(c[0]), float(c[1])))
            else:
                pairs.append((str(c.name), float(getattr(c, "weight", 1.0))))
    if not pairs:
        return []
    if any(w <= 0 for _, w in pairs):
        raise ValueError("SLO-class weights must be > 0")
    return pairs


def make_trace(
    name: str,
    *,
    rate: float,
    duration_s: float,
    seed: int = 0,
    classes=None,
    **kwargs,
) -> Trace:
    """Generate a seeded arrival trace.

    ``classes`` optionally assigns each arrival an SLO class, drawn i.i.d.
    with probability proportional to the class weights (same RNG stream, so
    the class labels are as reproducible as the timestamps).
    """
    if rate <= 0:
        raise ValueError("rate must be > 0 arrivals/s")
    if duration_s <= 0:
        raise ValueError("duration_s must be > 0")
    fn = get_trace_generator(name)
    # per-(seed, name) stream: two traces from one seed don't share draws
    rng = np.random.default_rng([int(seed), zlib.crc32(name.encode())])
    times = sorted(float(t) for t in fn(rate, duration_s, rng, **kwargs)
                   if 0.0 <= t < duration_s)
    pairs = _normalize_classes(classes)
    if pairs:
        names = [n for n, _ in pairs]
        total = sum(w for _, w in pairs)
        p = [w / total for _, w in pairs]
        labels = rng.choice(len(names), size=len(times), p=p)
        arrivals = tuple(Arrival(t, names[int(c)]) for t, c in zip(times, labels))
    else:
        arrivals = tuple(Arrival(t) for t in times)
    return Trace(name=name, arrivals=arrivals, duration_s=float(duration_s),
                 rate=float(rate), seed=int(seed))


def schedule_trace(target, trace: Trace, make_input: Callable[[int, Arrival], object]):
    """Feed every arrival into ``target.schedule`` (a serving loop or a
    ``Deployment``); returns the created requests in arrival order."""
    return [
        target.schedule(make_input(i, a), a.t_s, slo_class=a.slo_class)
        for i, a in enumerate(trace.arrivals)
    ]


__all__ = [
    "Arrival",
    "Trace",
    "UnknownTraceError",
    "get_trace_generator",
    "list_traces",
    "make_trace",
    "register_trace",
    "schedule_trace",
]
