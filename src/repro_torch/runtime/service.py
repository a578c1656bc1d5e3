"""Always-on serving: a background continuous drain loop over the server
(port of ``repro.runtime.service``).

``RuntimeServer`` only drains when a caller asks — fine for one-shot
benchmarks, useless as a serving story: nobody calls ``drain`` on a
production queue.  :class:`ServingLoop` closes that gap with a
background thread that drains whenever work is pending, bounded per
iteration (``max_windows_per_drain`` windows, each under the server's
``max_window_cycles`` latency budget) so no single drain holds the
serving lock — and the tenants behind it — longer than one budgeted
window.

Design notes:

* **One lock serializes submit and drain.**  The server's queue
  bookkeeping is single-threaded by design; the loop keeps that
  contract by taking the same lock for each bounded ``drain`` call that
  ``submit`` takes to enqueue.  Producers block for at most one drain
  iteration — that *is* the backpressure, and why each iteration is
  window-bounded.
* **Both threads are traced.**  The tracer keeps a span stack a thread
  (``repro_torch.obs.trace``), so the two waits outside the lock have
  spans: ``loop.lock-wait`` on the client's thread, from the call to
  ``submit`` until the lock is held (``ticket``, ``tenant``, and
  ``drains``: the loop's drains that ended meanwhile, i.e. the drain
  running at the call, if any, and each that the loop began ahead of
  the submitter), and
  ``loop.idle`` on the loop's thread, each wait for work (``wait=
  "wake"``) and each linger (``wait="linger"``).  With the server's
  ``queue-wait``, ``dispatch-wait`` and ``launch-run`` a launch's legs
  cover its submit call through its future's resolution, less the
  server's own ``submit`` span.
* **Crash isolation per window.**  A poisoned launch makes ``drain``
  raise (after requeueing the failing group and completing its
  window-mates); the loop counts the error (``loop.window_errors``) and
  keeps serving — retries drain in singleton sub-batches and the
  poisoned request is dropped after ``MAX_ATTEMPTS`` with its future
  failed.  The loop itself can only stop via :meth:`stop`.
* **Futures wait, never drain.**  While a loop owns a server
  (``server._serving_loop``), ``QueuedLaunch.result()`` waits for the
  loop to resolve it instead of calling ``drain`` from a foreign
  thread (see ``repro_torch.runtime.stream``).
* **Quiesce is exact.**  The loop's idle event is set only under the
  lock, at an instant the queue and the redeem stash were *observed*
  empty; ``quiesce`` re-checks under the lock after the event fires,
  so "quiesced" means every submitted launch resolved, failed, shed or
  dropped — never "the loop happened to be sleeping".

* **The loop's thread works on the server's card.**  The current CUDA
  device is per thread, so the thread enters ``torch.cuda.device`` of
  the server's device before it drains; every launch goes on that
  thread's current stream, and a drain ends in the counter fetch that
  syncs it, so a future the loop resolves holds finished memory.

Deadline shedding (``submit(deadline_s=...)`` →
:class:`~repro_torch.runtime.policy.DeadlineExceeded`), SLA-weighted
arrangement (:class:`~repro_torch.runtime.policy.SlaDrain`) and the open-loop
load generator (:mod:`repro_torch.runtime.loadgen`) ride on top of this loop
— see ``docs/serving.md``.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

import torch

from .server import _INHERIT, RuntimeServer
from .stream import QueuedLaunch


class ServingLoop:
    """Background continuous drain loop wrapping one
    :class:`RuntimeServer`.

    >>> loop = ServingLoop(RuntimeServer(n_sm=2)).start()
    >>> fut = loop.submit(code, (1, 1), (32, 1), gmem, client="t0")
    >>> out = fut.result()          # waits for the loop, never drains
    >>> loop.stop()                 # quiesces, then joins the thread

    Also usable as a context manager (``with ServingLoop(srv) as loop``
    — the exit quiesces and stops).

    Traced (the server's tracer started), each ``submit`` records a
    ``loop.lock-wait`` span on the caller's thread and the loop's thread
    a ``loop.idle`` span for each wait for work; each thread's spans
    export on a ``tid`` of their own.
    """

    def __init__(self, server: RuntimeServer,
                 poll_interval_s: float = 0.05,
                 max_windows_per_drain: int = 1,
                 max_window_cycles=_INHERIT,
                 linger_s: float = 0.0,
                 name: str = "serving-loop"):
        self.server = server
        #: idle sleep between queue checks when no submit wakes the loop
        self.poll_interval_s = float(poll_interval_s)
        #: windows drained per lock hold — the loop's latency/fairness
        #: knob: small values release the lock (and serve fresh
        #: arrivals) sooner
        self.max_windows_per_drain = int(max_windows_per_drain)
        #: per-window duration budget for loop drains (default: inherit
        #: the server's ``max_window_cycles``)
        self.max_window_cycles = max_window_cycles
        #: optional batching delay: on waking with work, wait this long
        #: for more arrivals before draining (throughput over latency)
        self.linger_s = float(linger_s)
        self.name = name
        self._lock = threading.RLock()
        self._wake = threading.Event()
        self._idle = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: loop health counters (mirrored into the server's metrics
        #: registry as ``loop.*``)
        self.iterations = 0
        self.window_errors = 0
        self.last_error: Optional[BaseException] = None
        self.served = 0
        self.shed = 0

    # ------------------------------------------------------------ lifecycle

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive() \
            and not self._stop.is_set()

    def start(self) -> "ServingLoop":
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError(f"{self.name} already running")
        if self.server._serving_loop is not None and \
                self.server._serving_loop.running:
            raise RuntimeError("server already owned by a serving loop")
        self._stop.clear()
        self._wake.clear()
        self._idle.clear()
        self.server._serving_loop = self
        self.server.metrics.gauge("loop.running").set(1)
        self._thread = threading.Thread(target=self._run, name=self.name,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True,
             timeout_s: Optional[float] = 60.0) -> "ServingLoop":
        """Stop the loop; with ``drain=True`` (default) quiesce first so
        every submitted launch resolves before the thread exits.  With
        ``drain=False`` pending launches stay queued (their futures
        unresolved) — the server can be drained manually or by a new
        loop."""
        if self._thread is None:
            return self
        if drain and self._thread.is_alive():
            self.quiesce(timeout_s=timeout_s)
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=timeout_s)
        if self._thread.is_alive():        # never abandon silently
            raise RuntimeError(f"{self.name} did not stop in "
                               f"{timeout_s}s")
        self._thread = None
        self.server._serving_loop = None
        self.server.metrics.gauge("loop.running").set(0)
        return self

    def __enter__(self) -> "ServingLoop":
        if not self.running:
            self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop(drain=True)

    # ------------------------------------------------------------- serving

    def submit(self, code, grid, block_dim, gmem, client: str = "anon",
               deadline_s: Optional[float] = None,
               priority: int = 0) -> QueuedLaunch:
        """Thread-safe submit through the loop's lock; wakes the drain
        thread.  Raises :class:`~repro_torch.runtime.policy.AdmissionError`
        exactly like ``RuntimeServer.submit`` (backpressure is part of
        the serving contract, not an internal error)."""
        before = self.iterations
        with self.server.tracer.span("loop.lock-wait",
                                     tenant=client) as wait_sp:
            self._lock.acquire()
        try:
            drains = self.iterations - before
            fut = self.server.submit_future(
                code, grid, block_dim, gmem, client=client,
                deadline_s=deadline_s, priority=priority)
            self._idle.clear()
        finally:
            self._lock.release()
        wait_sp.set(ticket=fut.ticket, drains=drains)
        self._wake.set()
        return fut

    def quiesce(self, timeout_s: Optional[float] = 60.0) -> "ServingLoop":
        """Block until the queue and the redeem stash are empty — every
        submitted launch resolved, failed, shed or dropped.  Raises
        ``TimeoutError`` if that does not happen within ``timeout_s``
        (a live loop always converges: retries are bounded by
        ``MAX_ATTEMPTS`` and deadlines only remove work)."""
        deadline = None if timeout_s is None else \
            time.monotonic() + timeout_s
        if not self.running:
            # no thread to wait for: drain synchronously to empty
            with self._lock:
                while self.server.pending() or self.server._completed:
                    try:
                        self.server.drain()
                    except Exception as e:       # retries converge
                        self.last_error = e
                        self.window_errors += 1
            return self
        while True:
            self._wake.set()
            if self._idle.wait(timeout=0.05):
                with self._lock:
                    if not self.server.pending() and \
                            not self.server._completed:
                        return self
            if not self.running:
                raise RuntimeError(
                    f"{self.name} stopped while quiescing")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"{self.name} did not quiesce in {timeout_s}s "
                    f"({self.server.pending()} launches still pending)")

    def wait_for(self, fut: QueuedLaunch,
                 timeout_s: Optional[float] = 60.0) -> QueuedLaunch:
        """Wait until the loop resolves ``fut`` (either way).  The
        loop-mode replacement for the future's own drain-on-result."""
        deadline = None if timeout_s is None else \
            time.monotonic() + timeout_s
        while not fut.done():
            if not self.running:
                raise RuntimeError(
                    f"{self.name} stopped with ticket {fut.ticket} "
                    "unresolved")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"ticket {fut.ticket} unresolved after {timeout_s}s")
            self._wake.set()
            time.sleep(0.001)
        return fut

    # ---------------------------------------------------------- loop thread

    def _run(self) -> None:
        dev = self.server.device
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                self._serve()
        else:
            self._serve()

    def _serve(self) -> None:
        m, tr = self.server.metrics, self.server.tracer
        while not self._stop.is_set():
            with self._lock:
                has_work = bool(self.server.pending()
                                or self.server._completed)
            if not has_work:
                # idle: nothing to drain until a submit wakes us (or
                # the poll interval re-checks, belt and braces)
                with tr.span("loop.idle", wait="wake"):
                    self._wake.wait(timeout=self.poll_interval_s)
                self._wake.clear()
            elif self.linger_s > 0.0:
                # batching delay: let the window fill before draining
                with tr.span("loop.idle", wait="linger"):
                    self._stop.wait(timeout=self.linger_s)
            with self._lock:
                if self._stop.is_set():
                    break
                if self.server.pending() or self.server._completed:
                    # queue-depth counter track: one pre-drain sample
                    # per iteration, so the trace's time-series shows
                    # the backlog each drain faced (drain itself
                    # samples the post-drain residue)
                    self.server.tracer.counter(
                        "queue_depth", pending=self.server.pending())
                    try:
                        _res, stats = self.server.drain(
                            max_windows=self.max_windows_per_drain,
                            max_window_cycles=self.max_window_cycles)
                        self.served += stats.n_launches
                        self.shed += stats.n_shed
                    except Exception as e:
                        # crash isolation: the drain already requeued
                        # the failing group (or dropped it after
                        # MAX_ATTEMPTS) and completed its window-mates;
                        # the loop records the error and keeps serving
                        self.window_errors += 1
                        self.last_error = e
                        m.counter("loop.window_errors").inc()
                    # counted once the drain is over, so a submit that
                    # waited for the lock counts each drain it met
                    self.iterations += 1
                    m.counter("loop.iterations").inc()
                if not self.server.pending() and \
                        not self.server._completed:
                    # observed empty under the lock — the only place
                    # the idle event is allowed to be set (submit
                    # clears it under the same lock)
                    self._idle.set()
