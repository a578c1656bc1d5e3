"""Build attribution around the runtime's cached seams (the port's
counterpart of ``repro.obs.jitprof``, which probes the jax jit cache).

The port compiles nothing per shape: its CUDA kernels are built once per
process by ``kernels/_build.py``, and what it caches per shape bucket is
the host work before a launch, the fused kernel's predecoded instruction
records (``runtime/executor._records``).  Every call into a seam
(:func:`repro_torch.runtime.executor.execute`'s group loop,
:func:`repro_torch.core.pipeline.run_block`) runs under :func:`jit_call`,
which counts the call a **miss** when it grew the seam's cache (its
``functools.lru_cache``) or when the kernel library was built or loaded
during it (:data:`LIBRARY_LOADS`), and attributes the call's
wall-milliseconds to the caller-supplied footprint-bucket label, under
the JAX package's metric names:

* ``jit.cache_misses`` / ``jit.cache_misses.<bucket>`` — counters;
* ``jit.cache_hits`` — counter (calls that built nothing);
* ``jit.trace_ms`` / ``jit.trace_ms.<bucket>`` — histograms of
  miss-call wall-ms (predecode or library build plus the call itself —
  what a tenant's first launch into a new bucket pays);
* ``jit.calls.<site>`` — calls per instrumented seam.

On the CPU the plain path caches and builds nothing, so every call is a
hit.  Attribution only *times* the call — results are untouched, so the
instrumented path stays bit-exact with the uninstrumented one.

:func:`summary` / :func:`delta` aggregate the per-bucket numbers for
BENCH JSON rows (``jit_trace_ms`` / ``jit_cache_misses`` per bucket).
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, Optional

from .metrics import METRICS, Counter, MetricsRegistry

#: kernel-library builds and loads in this process; ``kernels/_build.py``
#: adds one each time it loads the library
LIBRARY_LOADS = Counter()


def _cache_size(cached_fn) -> int:
    return cached_fn.cache_info().currsize if cached_fn is not None else 0


@contextmanager
def jit_call(site: str, cached_fn=None, bucket: str = "default",
             metrics: Optional[MetricsRegistry] = None):
    """Time one call into a seam and attribute a cache miss.

    ``site`` names the seam (metric ``jit.calls.<site>``); ``cached_fn``
    is the ``functools.lru_cache`` the call may grow (or ``None``);
    ``bucket`` is the footprint-bucket label misses are attributed to.
    Wrap exactly the call::

        with jit_call("executor.run_positions", _records, bucket=label):
            ...
    """
    m = metrics if metrics is not None else METRICS
    before = (_cache_size(cached_fn), LIBRARY_LOADS.value)
    t0 = time.perf_counter()
    yield
    dt_ms = (time.perf_counter() - t0) * 1e3
    miss = (_cache_size(cached_fn), LIBRARY_LOADS.value) != before
    m.counter(f"jit.calls.{site}").inc()
    if miss:
        m.counter("jit.cache_misses").inc()
        m.counter(f"jit.cache_misses.{bucket}").inc()
        m.histogram("jit.trace_ms").record(dt_ms)
        m.histogram(f"jit.trace_ms.{bucket}").record(dt_ms)
    else:
        m.counter("jit.cache_hits").inc()


def summary(metrics: Optional[MetricsRegistry] = None) -> dict:
    """Per-bucket build attribution so far:
    ``{bucket: {"jit_cache_misses": n, "jit_trace_ms": total_ms}}``
    plus a ``"_total"`` row with hits/misses/trace_ms overall."""
    m = metrics if metrics is not None else METRICS
    out: Dict[str, dict] = {}
    for bucket, misses in m.family("jit.cache_misses").items():
        h = m.histogram(f"jit.trace_ms.{bucket}")
        out[bucket] = {"jit_cache_misses": int(misses),
                       "jit_trace_ms": round(h.total, 3)}
    out["_total"] = {
        "jit_cache_misses": int(m.counter("jit.cache_misses").value),
        "jit_cache_hits": int(m.counter("jit.cache_hits").value),
        "jit_trace_ms": round(m.histogram("jit.trace_ms").total, 3)}
    return out


def delta(before: dict, after: dict) -> dict:
    """Per-bucket difference of two :func:`summary` snapshots, dropping
    buckets that saw no new misses — the per-drain attribution a BENCH
    row carries."""
    out: Dict[str, dict] = {}
    for bucket, vals in after.items():
        prev = before.get(bucket, {})
        d = {k: round(v - prev.get(k, 0), 3) for k, v in vals.items()}
        if bucket == "_total" or d.get("jit_cache_misses"):
            out[bucket] = d
    return out
