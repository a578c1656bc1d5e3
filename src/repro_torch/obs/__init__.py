"""Runtime observability: tracing and metrics (port of ``repro.obs``).

Zero-dependency (stdlib + numpy) and import-cycle free: this package
imports nothing from the rest of :mod:`repro_torch`, while the runtime
and the serving CLI emit into it.  Two pillars:

* :mod:`repro_torch.obs.trace` — span tree over the launch lifecycle
  (``submit → admit → queue-wait → pack → dep-resolve → dispatch →
  device-execute → counter-sync → complete``) with Chrome-trace /
  Perfetto export.  Process global: :data:`TRACER`.
* :mod:`repro_torch.obs.metrics` — counters / gauges / exact-quantile
  histograms.  Process global: :data:`METRICS`.

The JAX package's third pillar, ``jitprof``, probes the jax jit cache
and has no counterpart here yet: the port's kernels are built once by
``kernels/_build.py``.  :mod:`repro_torch.obs.profile` (the
architectural profiler) bridges to ``core`` and is imported directly.
"""
from .metrics import (METRICS, Counter, Gauge, Histogram, MetricsRegistry,
                      render_snapshot, safe_div)
from .trace import NULL_SPAN, TRACER, Span, Tracer

__all__ = [
    "METRICS", "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "render_snapshot", "safe_div",
    "TRACER", "Tracer", "Span", "NULL_SPAN",
]
