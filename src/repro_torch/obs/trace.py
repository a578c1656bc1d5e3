"""Launch-lifecycle tracing: a process span tree + Chrome-trace export (a
copy of ``repro.obs.trace``, which the port does not import, extended to
the serving loop's two threads and to the host profiler's trace).

:class:`Tracer` records three kinds of events:

* **Spans** — nested context-managed intervals (``drain`` → ``window`` →
  ``pack`` / ``dep-resolve`` / ``dispatch`` / ``device-execute`` →
  ``merge`` / ``counter-sync`` → ``complete``).  Each thread nests its
  spans on a stack of its own, and each span records its thread: the
  serving loop's thread drains and waits for work (``loop.idle``) while
  a client's thread waits for the loop's lock (``loop.lock-wait``).
  Spans carry attributes (tenant, ticket, bucket, n_blocks, predicted
  vs observed cycles) settable after entry via :meth:`Span.set`, and the
  finished tree is inspectable as ``tracer.roots`` for tests.
  Retroactive spans (:meth:`Tracer.timed_span`) attach an interval
  measured from stamps: a launch's ``queue-wait``, ``dispatch-wait`` and
  ``launch-run``.
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
(``"ph": "X"``) events, one ``tid`` a thread (the thread that called
``start()`` is tid 1, others count up from 4, each named by a
``thread_name`` metadata event when more than one thread recorded),
async events become ``"b"``/``"e"`` pairs on the launch track (tid 2),
counter samples become ``"C"`` events on their own named tracks (tid
3).  ``otherData["t0_unix_ns"]`` is the wall clock of the tracer's zero:
an event at ``ts`` µs happened at ``t0_unix_ns / 1e3 + ts`` µs of the
Unix epoch, the clock a ``torch.profiler`` trace stamps as
``baseTimeNanoseconds / 1e3 + ts``, so the two lay over each other.

A disabled tracer (the default) returns one shared null span whose
``__enter__``/``set`` are no-ops — the runtime instruments its hot
paths unconditionally and pays one boolean check when tracing is off,
and one flag check more for the host profiler.  Once the runtime has
installed the profiler's hook (:func:`annotate_with`), a span opened on
a thread that a ``torch.profiler`` records is also a host event of its
name in that profiler's trace, the tracer on or off.
Nothing here touches a device array: enabling tracing can never add a
host↔device transfer (pinned in ``tests/test_torch_obs.py``).

Threads share the tree's roots, the async and counter records (each an
append, atomic under the interpreter's lock) and nothing else.
``clear()``/``start()`` from one thread while another holds a span open
gives every thread a fresh stack: the open span closes into the old
tree, and the thread's next span is a root of the new one.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple


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


# ---------------------------------------------------- the host profiler

class _NoProfiler:
    """The profiler's flag until the runtime installs the real one."""

    _is_profiler_enabled = False


#: an object whose ``_is_profiler_enabled`` is true while a host profiler
#: records anywhere in the process (``torch.autograd.profiler`` once the
#: runtime has called :func:`annotate_with`): the one flag a span checks
_PROFILER = _NoProfiler
#: ``name -> context manager or None``: the profiler's annotation of a
#: span, or None where the profiler does not record the calling thread
_ANNOTATION: Optional[Callable[[str], object]] = None


def annotate_with(flag, annotation: Callable[[str], object]) -> None:
    """Install the host profiler's hook: ``flag._is_profiler_enabled``
    says whether a profiler may be recording, ``annotation(name)`` gives
    the context manager that marks ``name`` in its trace (None where it
    does not record the calling thread).  The runtime installs
    ``torch.autograd.profiler``'s, so this module imports no torch."""
    global _PROFILER, _ANNOTATION
    _PROFILER, _ANNOTATION = flag, annotation


class Span:
    """One interval in the span tree; a context manager.

    ``t0``/``t1`` are seconds on the tracer's clock (perf_counter
    relative to the tracer's start); ``thread`` is the tid of the thread
    that recorded it (1 for the thread that started the tracer).
    ``set(**attrs)`` merges attributes at any point before or after
    exit.  ``note``, where a host profiler records the thread, is the
    profiler's annotation of the span, entered and exited with it; a
    span with a note and no ``tracer`` (a disabled tracer's) records
    nothing in the tree.
    """

    __slots__ = ("tracer", "name", "attrs", "children", "t0", "t1",
                 "thread", "_stack", "_note")

    def __init__(self, tracer: Optional["Tracer"], name: str, attrs: dict,
                 note=None) -> None:
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.children: List["Span"] = []
        self.t0: Optional[float] = None
        self.t1: Optional[float] = None
        self.thread: Optional[int] = None
        self._stack: Optional[List["Span"]] = None
        self._note = note

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        tr = self.tracer
        if tr is not None:
            th = tr._thread()
            self.t0 = tr._now()
            self.thread = th.tid
            stack = self._stack = th.stack
            (stack[-1].children if stack else tr.roots).append(self)
            stack.append(self)
        if self._note is not None:
            self._note.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._note is not None:
            self._note.__exit__(*exc)
        if self.tracer is not None:
            self.t1 = self.tracer._now()
            self._stack.pop()


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
        #: tid -> thread name: 1 for the thread that cleared (started)
        #: the tracer, the others from 4 (2 and 3 are the launch and
        #: counter tracks) in the order they first recorded
        home = threading.current_thread()
        self._home = home.ident
        self._names: Dict[int, str] = {1: home.name}
        self._tids = itertools.count(4)
        #: each thread's ``tid`` and span ``stack``, fresh for every
        #: thread from here on (set after the names, which it joins)
        self._local = threading.local()
        #: finished async records: (ph, cat, id, name, ts, attrs)
        self._async: List[Tuple[str, str, str, str, float, dict]] = []
        self._open_async: Dict[Tuple[str, str], str] = {}
        #: counter-track samples: (track name, ts, {series: value})
        self._counters: List[Tuple[str, float, dict]] = []
        self._t0 = time.perf_counter()
        #: the wall clock at ``_t0`` (ns of the Unix epoch)
        self._t0_unix_ns = time.time_ns()
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

    def _thread(self) -> threading.local:
        """The calling thread's ``tid`` and span ``stack`` in this epoch
        (a tid of its own: an ident may pass to a new thread once its
        owner has ended)."""
        loc = self._local
        if not hasattr(loc, "stack"):
            th = threading.current_thread()
            loc.tid = 1 if th.ident == self._home else next(self._tids)
            self._names[loc.tid] = th.name
            loc.stack = []
        return loc

    # ------------------------------------------------------------- events

    def span(self, name: str, **attrs):
        """Open a child span of whatever span the calling thread has
        entered.  Use as ``with tracer.span("pack", window=i) as sp:
        ...``.  Disabled, it hands out :data:`NULL_SPAN`, or, on a
        thread a host profiler records, a span that only annotates the
        profiler's trace."""
        note = _ANNOTATION(name) if _PROFILER._is_profiler_enabled else None
        if not self.enabled:
            return NULL_SPAN if note is None else Span(None, name, attrs, note)
        return Span(self, name, attrs, note)

    def timed_span(self, name: str, t0_s: float, t1_s: float,
                   root: bool = False, **attrs) -> None:
        """Attach an already-measured interval (wall perf_counter
        seconds) as a closed child of the calling thread's current
        span — used for retroactive phases like per-launch queue-wait,
        whose start predates the drain's own spans.  ``root=True``
        attaches at the top level instead: the caller knows the interval
        overlaps *sibling* scopes (e.g. a queue wait spanning an earlier
        partial drain), so nesting it under the current span would
        mis-parent it."""
        if not self.enabled:
            return
        th = self._thread()
        sp = Span(self, name, attrs)
        sp.t0 = t0_s - self._t0
        sp.t1 = t1_s - self._t0
        sp.thread = th.tid
        (th.stack[-1].children if th.stack and not root else
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
                    "pid": 1, "tid": span.thread or 1, "ts": t0 * 1e6,
                    "dur": max(t1 - t0, 0.0) * 1e6,
                    "args": _json_safe(span.attrs)})
        for c in span.children:
            self._walk(c, out)

    def to_chrome(self) -> dict:
        """The Chrome-trace/Perfetto JSON object (not yet serialized)."""
        events: List[dict] = []
        if len(self._names) > 1:
            events += [{"name": "thread_name", "ph": "M", "pid": 1,
                        "tid": tid, "args": {"name": name}}
                       for tid, name in sorted(self._names.items())]
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
                "otherData": {"producer": "repro_torch.obs",
                              "t0_unix_ns": self._t0_unix_ns}}

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
