"""Launch-lifecycle tracing: a process span tree + Chrome-trace export (a
copy of ``repro.obs.trace``, which the port does not import).

:class:`Tracer` records two kinds of events:

* **Spans** — nested context-managed intervals on the runtime's host
  thread (``drain`` → ``window`` → ``pack`` / ``dep-resolve`` /
  ``dispatch`` / ``device-execute`` → ``counter-sync`` →
  ``complete``).  Spans carry attributes (tenant, ticket, bucket,
  n_blocks, predicted vs observed cycles) settable after entry via
  :meth:`Span.set`, and the finished tree is inspectable as
  ``tracer.roots`` for tests.
* **Async events** — begin/end pairs keyed by ``(category, id)`` that
  may overlap arbitrarily: one per launch lifecycle, opened at
  ``submit`` and closed at completion (or drop), so a drain's trace
  shows every launch's submit→complete extent alongside the host
  phases that served it.
* **Counter samples** — time-series points on named Perfetto counter
  tracks (:meth:`Tracer.counter`): queue depth, device utilization,
  energy rate, shed rate.  Each sample carries one or more numeric
  series and renders as a stacked area chart above the spans.

``export`` writes Chrome-trace / Perfetto JSON (load ``trace.json`` in
``chrome://tracing`` or https://ui.perfetto.dev): spans become complete
(``"ph": "X"``) events on the runtime track, async events become
``"b"``/``"e"`` pairs on the launch track, counter samples become
``"C"`` events on their own named tracks.

A disabled tracer (the default) returns one shared null span whose
``__enter__``/``set`` are no-ops — the runtime instruments its hot
paths unconditionally and pays one boolean check when tracing is off.
Nothing here touches a device array: enabling tracing can never add a
host↔device transfer (pinned in ``tests/test_torch_obs.py``).

The tracer is single-threaded by design, matching the runtime's
host-side drain loop; spans opened from other threads would interleave
on the one stack.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Tuple


def _json_safe(v):
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    try:
        return int(v)          # numpy ints land here
    except (TypeError, ValueError):
        return str(v)


class Span:
    """One interval in the span tree; a context manager.

    ``t0``/``t1`` are seconds on the tracer's clock (perf_counter
    relative to the tracer's start).  ``set(**attrs)`` merges
    attributes at any point before or after exit.
    """

    __slots__ = ("tracer", "name", "attrs", "children", "t0", "t1")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict) -> None:
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.children: List["Span"] = []
        self.t0: Optional[float] = None
        self.t1: Optional[float] = None

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        tr = self.tracer
        self.t0 = tr._now()
        (tr._stack[-1].children if tr._stack else tr.roots).append(self)
        tr._stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = self.tracer._now()
        self.tracer._stack.pop()


class _NullSpan:
    """Shared no-op span handed out by a disabled tracer."""

    __slots__ = ()
    name = ""
    attrs: dict = {}
    children: list = []
    t0 = t1 = 0.0

    def set(self, **attrs) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NULL_SPAN = _NullSpan()


class Tracer:
    """Process-wide span recorder.  Disabled by default; ``start()``
    clears and enables, ``stop()`` disables (events retained for
    export/inspection)."""

    def __init__(self, enabled: bool = False) -> None:
        self.enabled = enabled
        self.clear()

    # ------------------------------------------------------------ control

    def clear(self) -> "Tracer":
        self.roots: List[Span] = []
        self._stack: List[Span] = []
        #: finished async records: (ph, cat, id, name, ts, attrs)
        self._async: List[Tuple[str, str, str, str, float, dict]] = []
        self._open_async: Dict[Tuple[str, str], str] = {}
        #: counter-track samples: (track name, ts, {series: value})
        self._counters: List[Tuple[str, float, dict]] = []
        self._t0 = time.perf_counter()
        return self

    def start(self) -> "Tracer":
        self.clear()
        self.enabled = True
        return self

    def stop(self) -> "Tracer":
        self.enabled = False
        return self

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    # ------------------------------------------------------------- events

    def span(self, name: str, **attrs):
        """Open a child span of whatever span is currently entered.
        Use as ``with tracer.span("pack", window=i) as sp: ...``."""
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, attrs)

    def timed_span(self, name: str, t0_s: float, t1_s: float,
                   root: bool = False, **attrs) -> None:
        """Attach an already-measured interval (wall perf_counter
        seconds) as a closed child of the current span — used for
        retroactive phases like per-launch queue-wait, whose start
        predates the drain's own spans.  ``root=True`` attaches at the
        top level instead: the caller knows the interval overlaps
        *sibling* scopes (e.g. a queue wait spanning an earlier partial
        drain), so nesting it under the current span would mis-parent
        it."""
        if not self.enabled:
            return
        sp = Span(self, name, attrs)
        sp.t0 = t0_s - self._t0
        sp.t1 = t1_s - self._t0
        (self._stack[-1].children if self._stack and not root else
         self.roots).append(sp)

    def begin_async(self, cat: str, id_, name: str, **attrs) -> None:
        """Open an overlapping lifecycle event, e.g. one per launch."""
        if not self.enabled:
            return
        key = (cat, str(id_))
        self._open_async[key] = name
        self._async.append(("b", cat, str(id_), name, self._now(), attrs))

    def end_async(self, cat: str, id_, **attrs) -> None:
        if not self.enabled:
            return
        key = (cat, str(id_))
        name = self._open_async.pop(key, None)
        if name is None:
            return                       # begin predates start(): drop
        self._async.append(("e", cat, str(id_), name, self._now(), attrs))

    def counter(self, name: str, **values) -> None:
        """Record one sample on the Perfetto counter track ``name``.

        Each keyword is one numeric series on that track (Perfetto
        stacks multiple series of one counter event); samples export as
        ``"ph": "C"`` events.  Like every other emission this is a
        cheap no-op while the tracer is disabled."""
        if not self.enabled:
            return
        self._counters.append((name, self._now(), values))

    # ------------------------------------------------------------- export

    def _walk(self, span: Span, out: List[dict]) -> None:
        t0 = span.t0 or 0.0
        t1 = span.t1 if span.t1 is not None else t0
        out.append({"name": span.name, "ph": "X", "cat": "runtime",
                    "pid": 1, "tid": 1, "ts": t0 * 1e6,
                    "dur": max(t1 - t0, 0.0) * 1e6,
                    "args": _json_safe(span.attrs)})
        for c in span.children:
            self._walk(c, out)

    def to_chrome(self) -> dict:
        """The Chrome-trace/Perfetto JSON object (not yet serialized)."""
        events: List[dict] = []
        for root in self.roots:
            self._walk(root, events)
        for ph, cat, id_, name, ts, attrs in self._async:
            events.append({"name": name, "ph": ph, "cat": cat,
                           "id": id_, "pid": 1, "tid": 2, "ts": ts * 1e6,
                           "args": _json_safe(attrs)})
        for name, ts, values in self._counters:
            events.append({"name": name, "ph": "C", "cat": "counter",
                           "pid": 1, "tid": 3, "ts": ts * 1e6,
                           "args": _json_safe(values)})
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"producer": "repro_torch.obs"}}

    def export(self, path: str) -> dict:
        """Write ``to_chrome()`` to ``path``; returns the dict."""
        doc = self.to_chrome()
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        return doc

    # --------------------------------------------------------- inspection

    def find(self, name: str, root: Optional[Span] = None) -> List[Span]:
        """Every finished span called ``name``, depth-first."""
        out: List[Span] = []
        roots = [root] if root is not None else self.roots
        stack = list(roots)
        while stack:
            sp = stack.pop()
            if sp.name == name:
                out.append(sp)
            stack.extend(sp.children)
        return out

    def async_pairs(self, cat: str) -> Dict[str, List[str]]:
        """{id: [phases...]} of async events in ``cat`` (test hook)."""
        out: Dict[str, List[str]] = {}
        for ph, c, id_, _name, _ts, _attrs in self._async:
            if c == cat:
                out.setdefault(id_, []).append(ph)
        return out

    def counter_samples(self, name: str) -> List[dict]:
        """The recorded {series: value} samples of one counter track,
        in record order (test hook)."""
        return [vals for n, _ts, vals in self._counters if n == name]


#: Process-wide tracer the runtime stack emits into.  Disabled by
#: default: every span call is a cheap no-op until ``TRACER.start()``
#: (or ``gpgpu_serve --trace-out``) enables it.
TRACER = Tracer()
