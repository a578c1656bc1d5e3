"""Streams and events — CUDA-style async launch ordering (port of
``repro.runtime.stream``).

A :class:`Stream` owns a device-resident global memory and a FIFO of
launches against it, exactly like a CUDA stream ordering kernels that
mutate device memory.  ``Stream.launch`` dispatches **eagerly** through
the multi-SM executor and returns a :class:`Launch` future immediately:
the fused path queues its work without a host sync, in-stream ordering
is real dataflow (each launch consumes the memory produced by its
predecessor), and nothing touches the host until ``Launch.result`` or
an explicit synchronize.

Cross-stream dependencies use :class:`Event`: ``record_event`` snapshots
the recording stream's tail, ``wait_event`` orders subsequent launches
of the waiting stream after it, and ``Event.gmem()`` exposes the
recorded memory so a consumer stream can *read* the producer's output.

Design on the card: every launch is issued on the **current CUDA stream
of the issuing thread**; a runtime :class:`Stream` is an ordering of
launches and a memory, not a ``torch.cuda.Stream`` of its own.  So no
tensor is ever made on one CUDA stream and read on another, and the
caching allocator cannot hand a buffer out early (no ``wait_stream`` /
``record_stream`` pairs to keep).  Completion is a ``torch.cuda.Event``
recorded right after a launch's work: ``Launch.done()`` queries it and
``Launch.wait()`` waits on it from the host, which is correct from any
thread (an event is waited on, never compared against the caller's
stream).  ``wait_event`` makes the waiting thread's current stream wait
on the event before its next launch, which is what orders work issued
from two threads.  The JAX package's ``_order_token`` (a ``gmem + 0``
data edge) is not carried over.  On ``device="cpu"`` work runs
synchronously and every event is trivially complete.
"""
from __future__ import annotations

import weakref
from typing import List, Optional

import numpy as np
import torch

from ..core.pipeline import MachineConfig
from ..core.pipeline.state import as_int32, host_numpy, resolve_device
from ..obs import TRACER
from . import executor as ex
from .registry import Module, ModuleRegistry


def _record(device: torch.device) -> Optional[torch.cuda.Event]:
    """A CUDA event recorded now on the current stream of ``device``;
    None on the CPU, where work has already completed."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


class Launch:
    """Device-resident future for one kernel launch."""

    def __init__(self, devgrid: ex.DeviceGrid, module: Module, grid,
                 block_dim, event: Optional[torch.cuda.Event] = None):
        self._dg = devgrid
        self.module = module
        self.grid = grid
        self.block_dim = block_dim
        self._event = event
        self._result: Optional[ex.GridResult] = None

    def gmem(self) -> torch.Tensor:
        """Final global memory — device tensor, no host sync."""
        return self._dg.launch_gmem(0)

    def report(self) -> ex.MultiSMReport:
        return self._dg.report()

    def done(self) -> bool:
        """Non-blocking: has the launch's work completed on the device?"""
        return self._event is None or self._event.query()

    def wait(self) -> "Launch":
        if self._event is not None:
            self._event.synchronize()
        return self

    def result(self) -> ex.GridResult:
        """Materialize the launch's :class:`GridResult` (host sync)."""
        if self._result is None:
            self._result = self._dg.to_results()[0]
        return self._result


class Event:
    """Snapshot of a stream's tail, for cross-stream ordering and sync.

    ``gmem`` may be None when the recording stream's tail is a queued
    (server-routed) launch whose memory does not exist until its drain
    sub-batch completes: ``query`` stays False until then, and reading
    the event (``gmem()`` / ``synchronize()``) forces the producer to
    resolve first — the event fires only after its producer's sub-batch.
    ``cuda_event`` is the device event recorded with the snapshot (None
    on the CPU or for a queued tail).
    """

    def __init__(self, gmem: Optional[torch.Tensor], launches: List,
                 cuda_event: Optional[torch.cuda.Event] = None):
        self._gmem = gmem
        self._launches = list(launches)
        self.cuda_event = cuda_event

    def gmem(self) -> torch.Tensor:
        """The recorded stream memory (device tensor, no sync)."""
        if self._gmem is None:
            self._gmem = self._launches[-1].gmem()
        return self._gmem

    def query(self) -> bool:
        """True when every recorded launch has completed (non-blocking)."""
        if not all(l.done() for l in self._launches):
            return False
        return self.cuda_event is None or self.cuda_event.query()

    def synchronize(self) -> "Event":
        for l in self._launches:
            l.wait()
        if self.cuda_event is not None:
            self.cuda_event.synchronize()
        self.gmem()
        return self


class Stream:
    """In-order launch queue over a stream-owned device global memory."""

    def __init__(self, runtime: "Runtime", gmem=None):
        self._rt = runtime
        self._gmem = None if gmem is None else as_int32(gmem,
                                                        runtime.device)
        # only the tail launch is retained (chaining and record_event
        # never look further back) so a long-lived stream does not
        # accumulate one DeviceGrid per launch served
        self._tail: Optional[Launch] = None
        self._waits: List[torch.cuda.Event] = []

    @property
    def gmem(self) -> Optional[torch.Tensor]:
        """Current stream memory: the last launch's output (device)."""
        return self._gmem

    def set_gmem(self, gmem) -> "Stream":
        self._gmem = as_int32(gmem, self._rt.device)
        return self

    def launch(self, module, grid, block_dim, gmem=None) -> Launch:
        """Enqueue one kernel.  ``gmem=None`` chains on the stream memory
        (CUDA semantics: kernels in a stream see each other's writes);
        an explicit array / :class:`Launch` / :class:`Event` reads that
        memory instead.  Returns immediately with a device future.
        """
        dev = self._rt.device
        mod = self._rt.registry.as_module(module)
        if gmem is None:
            if self._gmem is None:
                raise ValueError("stream has no memory: pass gmem= or "
                                 "set_gmem() first")
            g = self._gmem
        elif isinstance(gmem, (Launch, Event)):
            g = gmem.gmem()
        else:
            g = as_int32(gmem, dev)
        if self._waits:
            # ordering edges from wait_event: this thread's stream waits
            # on each recorded event before the launch's work
            cur = torch.cuda.current_stream(dev)
            for ev in self._waits:
                cur.wait_event(ev)
            self._waits = []
        with TRACER.span("stream-launch", module=mod.name,
                         n_blocks=grid[0] * grid[1]):
            dg = ex.execute([ex.LaunchSpec(mod, grid, block_dim, g)],
                            n_sm=self._rt.n_sm, cfg=self._rt.cfg,
                            chunk=self._rt.chunk,
                            registry=self._rt.registry, device=dev)
        launch = Launch(dg, mod, grid, block_dim, _record(dev))
        self._tail = launch
        self._gmem = launch.gmem()
        return launch

    def record_event(self) -> Event:
        if self._gmem is None:
            raise ValueError("cannot record an event on an empty stream")
        return Event(self._gmem,
                     [self._tail] if self._tail is not None else [],
                     _record(self._rt.device))

    def wait_event(self, event: Event) -> "Stream":
        """Order subsequent launches of this stream after ``event``."""
        if event.cuda_event is not None:
            self._waits.append(event.cuda_event)
        else:
            event.synchronize()   # a queued tail resolves from the host
        return self

    def synchronize(self) -> "Stream":
        if self._tail is not None:
            self._tail.wait()
        return self


class QueuedLaunch:
    """Future for a launch queued on a :class:`RuntimeServer`.

    Unlike the eager :class:`Launch` (whose work is already dispatched),
    a queued launch has no result until the server drains the sub-batch
    its drain policy assigned it to.  The server resolves the future the
    moment that sub-batch completes — **exactly once**, whatever order
    the policy ran the window's sub-batches in, and even when a later
    sub-batch of the same drain fails.  ``result``/``gmem``/``wait``
    flush the server when called early; ``done`` never blocks.  A
    resolved result's counters (and, off the resident mode, its memory)
    came back through the executor's counter fetch, which synchronized
    the drain's work, so its memory is final whichever thread reads it.
    """

    def __init__(self, server, ticket: int, client: str, module: Module,
                 grid, block_dim):
        self._server = server
        self.ticket = ticket
        self.client = client
        self.module = module
        self.grid = grid
        self.block_dim = block_dim
        self._result: Optional[ex.GridResult] = None
        self._error: Optional[BaseException] = None
        self._resolved = False

    def _resolve(self, result: ex.GridResult) -> None:
        if self._resolved:
            raise RuntimeError(
                f"ticket {self.ticket} future resolved twice")
        self._resolved = True
        self._result = result

    def _fail(self, error: BaseException) -> None:
        if self._resolved:
            raise RuntimeError(
                f"ticket {self.ticket} future resolved twice")
        self._resolved = True
        self._error = error

    def done(self) -> bool:
        """Non-blocking: has this launch's sub-batch completed?"""
        return self._resolved

    def result(self) -> ex.GridResult:
        """The launch's :class:`GridResult`; drains the server if needed.

        When a :class:`~repro_torch.runtime.service.ServingLoop` owns the
        server, the future must not drain from this (foreign) thread —
        it waits for the loop to resolve it instead."""
        if not self._resolved:
            loop = getattr(self._server, "_serving_loop", None)
            if loop is not None and loop.running:
                loop.wait_for(self)
            else:
                with TRACER.span("future-wait", ticket=self.ticket,
                                 tenant=self.client):
                    try:
                        self._server.drain()
                    except Exception:
                        # another sub-batch of the drain failed — only
                        # propagate if *our* sub-batch did not complete
                        if not self._resolved:
                            raise
        if self._error is not None:
            raise self._error
        if self._result is None:
            raise RuntimeError(
                f"ticket {self.ticket} did not resolve in drain (queued "
                "behind a failing window? drain again)")
        return self._result

    def gmem(self) -> torch.Tensor:
        """Final global memory on the server's device (resolves the
        future first).

        On a ``resident_gmem`` server the result's memory is already a
        device tensor and passes through with no host round-trip — so
        chaining a new launch on a resolved future stays device-side
        end to end."""
        return as_int32(self.result().gmem, self._server.device)

    def wait(self) -> "QueuedLaunch":
        self.result()
        return self


class QueuedStream:
    """In-order launch queue routed through a :class:`RuntimeServer`.

    The server-side sibling of :class:`Stream`: launches enqueue instead
    of dispatching eagerly, and the drain policy may land a stream's
    launches in *different sub-batches* (different gmem buckets).
    Dataflow order survives that: a launch chaining on a still-queued
    predecessor enqueues with a **dependency edge** on it, and the drain
    topologically orders the two sub-batches — producer first, its
    output materialized as the dependent's input just before the
    dependent's group executes.  Nothing flushes at enqueue time: the
    whole chain (plus any other tenants' pending launches) drains in
    one ``drain`` call, in dependency order.  ``record_event`` snapshots
    the tail — before resolution if the tail is still queued, so
    cross-stream consumers observe the event firing only after the
    producer's sub-batch completes.
    """

    def __init__(self, server, gmem=None, client: str = "stream"):
        self._srv = server
        self.client = client
        self._gmem = None if gmem is None else \
            host_numpy(gmem).astype(np.int32)
        self._tail: Optional[QueuedLaunch] = None

    @property
    def gmem(self):
        """Current stream memory (resolves a queued tail first)."""
        if self._tail is not None:
            return self._tail.gmem()
        return self._gmem

    def launch(self, module, grid, block_dim, gmem=None) -> QueuedLaunch:
        """Enqueue one kernel on the server; returns a queued future.

        ``gmem=None`` chains on the stream memory: a still-queued
        predecessor becomes a dependency edge (the server's drain runs
        the producer's sub-batch first and feeds its output in — no
        flush), a resolved one passes its concrete memory.  An explicit
        array / future / :class:`Event` reads that memory instead; a
        still-queued :class:`QueuedLaunch` of the same server is also
        taken as a dependency edge.
        """
        if gmem is None:
            if self._tail is not None:
                g = self._tail          # dependency edge or concrete
            elif self._gmem is not None:
                g = self._gmem
            else:
                raise ValueError("stream has no memory: pass gmem= first")
        elif isinstance(gmem, (Launch, Event)):
            g = host_numpy(gmem.gmem())
        elif isinstance(gmem, QueuedLaunch):
            g = gmem                    # server decides: edge or concrete
        else:
            g = host_numpy(gmem).astype(np.int32)
        fut = self._srv.submit_future(module, grid, block_dim, g,
                                      client=self.client)
        self._tail = fut
        return fut

    def record_event(self) -> Event:
        if self._tail is None and self._gmem is None:
            raise ValueError("cannot record an event on an empty stream")
        if self._tail is None:
            return Event(as_int32(self._gmem, self._srv.device), [])
        # queued tail: the event's memory materializes with the tail's
        # sub-batch; query() stays False until then
        return Event(None, [self._tail])

    def wait_event(self, event: Event) -> "QueuedStream":
        """Order subsequent launches of this stream after ``event``.

        Server submission is host-ordered, so the edge is enforced by
        resolving the event's producers before anything later enqueues.
        """
        event.synchronize()
        return self

    def synchronize(self) -> "QueuedStream":
        if self._tail is not None:
            self._tail.wait()
        return self


class Runtime:
    """The device runtime: one binary cache + config shared by streams.
    Runs on the card unless ``device="cpu"``; without a card it raises.

    >>> rt = Runtime(n_sm=2)
    >>> mod = rt.load(code)
    >>> s = rt.stream(gmem0)
    >>> fut = s.launch(mod, (4, 1), (32, 1))
    >>> out = fut.result().gmem
    """

    def __init__(self, cfg: MachineConfig = MachineConfig(),
                 n_sm: int = 1, chunk: int = 8,
                 registry: Optional[ModuleRegistry] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.n_sm = n_sm
        self.chunk = chunk
        self.registry = registry if registry is not None else \
            ModuleRegistry(max_modules=1024)
        # weak registry: a stream (and the device memory it pins) is
        # freed as soon as its creator drops it, so a resident runtime
        # serving one stream per request does not leak
        self._streams: "weakref.WeakSet[Stream]" = weakref.WeakSet()

    def load(self, code: np.ndarray, name: Optional[str] = None) -> Module:
        """Load a kernel binary through the content-addressed cache."""
        return self.registry.load(code, name)

    def stream(self, gmem=None) -> Stream:
        s = Stream(self, gmem)
        self._streams.add(s)
        return s

    def synchronize(self) -> "Runtime":
        for s in list(self._streams):
            s.synchronize()
        return self
