"""Process metrics: counters, gauges and log-bucketed histograms (a copy
of ``repro.obs.metrics``, which the port does not import).

The paper evaluates the soft GPGPU entirely through measured activity
counters (cycles, instruction mix, energy); the serving layers grew
their own scattered telemetry — ``TRANSFERS`` ints, ``DrainStats``
tuples, ad-hoc CLI prints.  :class:`MetricsRegistry` is the one place
that telemetry now lands:

* :class:`Counter` — monotone int/float (``transfers.gmem_uploads``,
  ``module_cache.hits``);
* :class:`Gauge` — last-value sample (``drain.occupancy``,
  ``pool.entries``);
* :class:`Histogram` — log2-bucketed distribution **with exact
  quantiles**: every recorded sample is retained (up to
  ``max_samples``), so ``percentile(q)`` is numerically identical to
  ``numpy.percentile`` over the same samples — the p50/p90/p99 latency
  readout the BENCH JSON rows carry must be exact, not
  bucket-interpolated.

A registry constructed with ``enabled=False`` hands out shared no-op
instruments: recording into it costs one attribute check and touches
nothing — in particular it can never add a host↔device sync (pinned by
``tests/test_torch_obs.py``).  Everything here is host-side stdlib + numpy;
no instrument ever touches a device array.

``METRICS`` is the process-wide default registry, the metrics sibling
of :data:`repro_torch.obs.trace.TRACER`.  Consumers that need isolation (the
benchmark harness, tests) construct their own registry and pass it to
``RuntimeServer(metrics=...)``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Union

import numpy as np

Number = Union[int, float]


def safe_div(num: Number, den: Number) -> float:
    """``num / den`` with a hard 0.0 on empty/degenerate denominators.

    Telemetry ratios (occupancy, duration balance, launches/s) feed
    BENCH JSON rows and CLI prints; an empty window or a zero-makespan
    drain must read as 0.0, never ZeroDivisionError / NaN / inf.
    """
    den = float(den)
    if den == 0.0 or not math.isfinite(den):
        return 0.0
    out = float(num) / den
    return out if math.isfinite(out) else 0.0


class Counter:
    """Monotone counter.  ``inc`` only; use a :class:`Gauge` to sample."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: Number = 0

    def inc(self, n: Number = 1) -> None:
        self.value += n


class Gauge:
    """Last-value instrument (per-drain occupancy, pool entries, ...)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: Number = 0

    def set(self, v: Number) -> None:
        self.value = v


class Histogram:
    """Log2-bucketed histogram with exact retained-sample quantiles.

    ``record`` updates count/sum plus a power-of-two bucket table
    (upper edges ``BASE * 2**k``, BASE = 1 µs — sized for second-unit
    latencies and millisecond-unit compile times alike) and appends the
    raw sample.  ``percentile(q)`` is computed over the retained
    samples with ``numpy.percentile`` — bit-identical to what a caller
    holding the same samples would compute.  Beyond ``max_samples``
    retained samples the bucket table keeps counting but quantiles
    reflect the first ``max_samples`` values (bounded memory for a
    long-lived server); the overflow is *visible*, not silent:
    ``dropped_samples`` counts every sample the quantiles no longer
    see, and ``stats()`` / ``render_snapshot`` surface it so a reader
    of a long-lived server's p99 knows when the tail estimate went
    stale.  The default cap is far above any drain batch.
    """

    BASE = 1e-6
    __slots__ = ("max_samples", "count", "total", "dropped_samples",
                 "_samples", "_buckets")

    def __init__(self, max_samples: int = 200_000) -> None:
        self.max_samples = max_samples
        self.count = 0
        self.total = 0.0
        #: samples recorded past the retention cap — counted by the
        #: bucket table but invisible to the exact quantiles
        self.dropped_samples = 0
        self._samples: List[float] = []
        self._buckets: Dict[int, int] = {}

    def record(self, v: Number) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if len(self._samples) < self.max_samples:
            self._samples.append(v)
        else:
            self.dropped_samples += 1
        k = 0 if v <= self.BASE else math.ceil(math.log2(v / self.BASE))
        self._buckets[k] = self._buckets.get(k, 0) + 1

    def percentile(self, q: Number) -> float:
        """Exact q-th percentile of the retained samples (numpy linear
        interpolation); NaN when nothing was recorded — snapshots omit
        quantiles for empty histograms instead of emitting NaN."""
        if not self._samples:
            return float("nan")
        return float(np.percentile(
            np.asarray(self._samples, np.float64), q))

    def stats(self) -> dict:
        """JSON-safe summary: count/sum/min/max + exact p50/p90/p99 +
        the log2 bucket table as ``[upper_edge, count]`` pairs."""
        out: dict = {"count": self.count, "sum": self.total,
                     "dropped_samples": self.dropped_samples}
        if self._samples:
            arr = np.asarray(self._samples, np.float64)
            out.update(min=float(arr.min()), max=float(arr.max()),
                       p50=self.percentile(50), p90=self.percentile(90),
                       p99=self.percentile(99))
        out["buckets"] = [[self.BASE * (1 << k), n]
                          for k, n in sorted(self._buckets.items())]
        return out


class _NullCounter:
    __slots__ = ()
    value = 0

    def inc(self, n: Number = 1) -> None:
        pass


class _NullGauge:
    __slots__ = ()
    value = 0

    def set(self, v: Number) -> None:
        pass


class _NullHistogram:
    __slots__ = ()
    count = 0
    total = 0.0
    dropped_samples = 0

    def record(self, v: Number) -> None:
        pass

    def percentile(self, q: Number) -> float:
        return float("nan")

    def stats(self) -> dict:
        return {"count": 0, "sum": 0.0, "dropped_samples": 0,
                "buckets": []}


_NULL_COUNTER = _NullCounter()
_NULL_GAUGE = _NullGauge()
_NULL_HISTOGRAM = _NullHistogram()


class MetricsRegistry:
    """Name-addressed instrument registry (create-on-first-use).

    Names are dotted paths; per-bucket / per-tenant instruments suffix
    the label onto the family name (``jit.trace_ms.c96g8192w2sm2``,
    ``drain.tenant.t0.launches``) — :meth:`family` re-groups them.
    A disabled registry hands out shared no-op instruments: the
    recording call sites stay unconditional (the tentpole's "emit
    unconditionally, cheap no-op when disabled").
    """

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        if not self.enabled:
            return _NULL_COUNTER
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        if not self.enabled:
            return _NULL_GAUGE
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str) -> Histogram:
        if not self.enabled:
            return _NULL_HISTOGRAM
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram()
        return h

    def family(self, prefix: str) -> Dict[str, Number]:
        """{label: value} for every counter named ``<prefix>.<label>``."""
        plen = len(prefix) + 1
        return {k[plen:]: c.value for k, c in self._counters.items()
                if k.startswith(prefix + ".")}

    def snapshot(self) -> dict:
        """JSON-safe dump of every instrument (sorted, stable order)."""
        return {
            "counters": {k: self._counters[k].value
                         for k in sorted(self._counters)},
            "gauges": {k: self._gauges[k].value
                       for k in sorted(self._gauges)},
            "histograms": {k: self._hists[k].stats()
                           for k in sorted(self._hists)},
        }

    def reset(self) -> "MetricsRegistry":
        """Drop every instrument.  Prefer fresh registries for scoped
        measurement (resetting the process-global registry re-bases any
        live :class:`~repro_torch.runtime.executor.TransferLog` views)."""
        self._counters.clear()
        self._gauges.clear()
        self._hists.clear()
        return self


def render_snapshot(snap: dict, prefix: str = "") -> str:
    """One formatted text block for a registry snapshot — the single
    source of truth the serving CLI prints (same dict the BENCH JSON
    and ``--metrics-out`` carry)."""
    lines: List[str] = []

    def fmt(v: Number) -> str:
        if isinstance(v, float) and not v.is_integer():
            return f"{v:.4g}"
        return str(int(v))

    if snap.get("counters"):
        lines.append(f"{prefix}counters:")
        for k, v in snap["counters"].items():
            lines.append(f"{prefix}  {k} = {fmt(v)}")
    if snap.get("gauges"):
        lines.append(f"{prefix}gauges:")
        for k, v in snap["gauges"].items():
            lines.append(f"{prefix}  {k} = {fmt(v)}")
    if snap.get("histograms"):
        lines.append(f"{prefix}histograms:")
        for k, h in snap["histograms"].items():
            if h.get("count"):
                line = (f"{prefix}  {k}: n={h['count']} p50={h['p50']:.4g} "
                        f"p90={h['p90']:.4g} p99={h['p99']:.4g} "
                        f"max={h['max']:.4g}")
                if h.get("dropped_samples"):
                    line += (f" (quantiles exclude "
                             f"{h['dropped_samples']} dropped samples)")
                lines.append(line)
            else:
                lines.append(f"{prefix}  {k}: n=0")
    return "\n".join(lines)


#: Process-wide default registry (the metrics analogue of TRACER).
METRICS = MetricsRegistry()
