"""Runtime observability: tracing and metrics (port of ``repro.obs``).

Zero-dependency (stdlib + numpy) and import-cycle free: this package
imports nothing from the rest of :mod:`repro_torch`, while the runtime
and the serving CLI emit into it.  Three pillars:

* :mod:`repro_torch.obs.trace` — span tree over the launch lifecycle
  (``loop.lock-wait → submit → admit → queue-wait → pack → dep-resolve
  → dispatch-wait → dispatch → device-execute → merge → counter-sync →
  complete``, with ``launch-run`` over a launch's run and ``loop.idle``
  on the serving loop's thread) with Chrome-trace / Perfetto export, a
  span stack and a ``tid`` a thread, and the wall clock of its zero to
  lay it over a ``torch.profiler`` trace; while such a profiler records
  a thread, that thread's spans are also events in its trace (the hook is
  installed by :mod:`repro_torch.runtime`, so this package imports no
  torch).  Process global: :data:`TRACER`.
* :mod:`repro_torch.obs.metrics` — counters / gauges / exact-quantile
  histograms.  Process global: :data:`METRICS`.

* :mod:`repro_torch.obs.jitprof` — cache-miss detection and wall-ms
  attribution around the runtime's cached seams: the fused kernel's
  predecode cache and the kernel library's build
  (:func:`jit_call`, :func:`jit_summary`, :func:`jit_delta`).

:mod:`repro_torch.obs.profile` (the architectural profiler) bridges to
``core`` and is imported directly.
"""
from .metrics import (METRICS, Counter, Gauge, Histogram, MetricsRegistry,
                      render_snapshot, safe_div)
from .jitprof import delta as jit_delta
from .jitprof import jit_call
from .jitprof import summary as jit_summary
from .trace import NULL_SPAN, TRACER, Span, Tracer

__all__ = [
    "METRICS", "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "render_snapshot", "safe_div",
    "TRACER", "Tracer", "Span", "NULL_SPAN",
    "jit_call", "jit_summary", "jit_delta",
]
