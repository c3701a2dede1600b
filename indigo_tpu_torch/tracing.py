"""Spans at the port's layer boundaries, on the profiler's own clock.

``span(name, **attrs)`` marks one layer's work::

    with tracing.span("indigo.rhs"):
        ...

Off, that is while no ``torch.profiler`` runs, a span checks the
profiler's state and does nothing else: no clock read, no record, no CUDA
call. On, it

* enters a non-user ``RecordFunction`` scope, so the span is a host event
  in the profiler's own trace, on the device trace's clock (the Chrome
  trace of ``profiling.trace`` shows it); it never adds a
  ``gpu_user_annotation`` device event;
* appends a record (name, parent span, request id, host start and end in
  ``time.time_ns()``, the attrs) to a bounded buffer;
* where the process uses CUDA, records a timing-event pair on the stream
  current at enter (the exit's event goes on the same stream), without a
  synchronise: the span's device ms are resolved when the records are
  read (``spans()``).

``request(rid)`` gives the spans opened inside it, at the top of the
stack, that request id; nested spans take their parent's. Set-up phases
(``span(name, setup=True)``) are recorded with or without a profiler, host
stamps only, in a buffer of their own that request spans never evict.

The spans of the port, by layer:

* boundary in: ``indigo.ingress`` (``SenseRecon._samples``), and inside
  it, or in ``utils.as_tensor``, ``indigo.narrow`` (the host-side cast of
  64-bit host data to 32-bit; 32-bit data records none);
* rhs: ``indigo.rhs`` (``SenseRecon.rhs``);
* solve: ``indigo.solve`` (``SenseRecon.solve``; the whole of
  ``solvers.cg``), ``indigo.cg_iter`` (each step of
  ``parallel.recon.batched_cg`` and ``solvers.cg``);
* normal op: ``indigo.normal_op`` (``parallel.recon.sense_normal_batched``;
  in ``solvers.cg`` each apply of the operator, the zero start's residual
  included, without the ``lamda * v`` add);
* Toeplitz leaf: ``indigo.toeplitz`` (``toeplitz.ToeplitzNormal.apply``:
  K2 or the plain round trip with the batch-leading copies in and out;
  attrs ``K``, the batch, and ``method``);
* boundary out: ``indigo.egress`` (the image to host memory);
* backward (a ``SenseRecon`` call whose k-space requires grad, hooks on
  its graph; every span with the forward's request id, on whichever
  thread autograd runs it): ``indigo.backward`` (from the image's
  cotangent entering the graph to the k-space gradient; attr
  ``saved_bytes``, the storages autograd saved for the graph, the
  pipeline's buffers left out) > ``indigo.solve_bwd`` (CG's reverse, from
  the image's cotangent to the rhs's; each K1 launch on a cotangent inside
  it is an ``indigo.normal_op`` with attr ``backward=True``, a K2 one an
  ``indigo.toeplitz``) and ``indigo.rhs_bwd`` (the rhs's reverse: the
  adjoint pad-DFT's gradient, the gridding's gather, the weight and the
  permutation);
* set-up: ``indigo.init`` > ``indigo.init.dcf`` / ``.plan`` /
  ``.toeplitz`` / ``.setup`` (``SenseRecon.__init__``; ``from_arrays``
  records ``indigo.init`` and ``.setup``).

A tree solve thus records ``indigo.solve`` > (``indigo.normal_op``,
``indigo.cg_iter`` > ``indigo.normal_op``) > ``indigo.toeplitz``, and the
backward of a ``SenseRecon`` call on the card ``indigo.backward`` >
(``indigo.solve_bwd`` > ``indigo.normal_op``, ``indigo.rhs_bwd``).

This module imports torch only, so that any module of the port can import
it.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque

import torch

__all__ = ["Span", "Recorder", "span", "request", "spans", "clear",
           "self_ms", "RECORDER"]

_profiling = torch._C._autograd._profiler_enabled
_Scope = torch._C._profiler._RecordFunctionFast

# request spans kept: a traced stretch of 20 SenseRecon requests holds
# about 500
REQUEST_SPANS = 1 << 14
SETUP_SPANS = 1 << 10


class Span:
    """One span's record. ``device_ms`` is None until the record is read
    through ``spans()``, and stays None where no CUDA events were taken
    (a set-up span, a process without CUDA)."""

    __slots__ = ("id", "name", "parent", "request", "start_ns", "end_ns",
                 "attrs", "device_ms", "events")

    def __init__(self, sid, name, parent, request, attrs):
        self.id, self.name, self.parent = sid, name, parent
        self.request, self.attrs = request, attrs
        self.start_ns = self.end_ns = self.device_ms = self.events = None

    @property
    def host_ms(self):
        if self.end_ns is None:
            return None
        return (self.end_ns - self.start_ns) / 1e6

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"request={self.request}, host_ms={self.host_ms}, "
                f"device_ms={self.device_ms})")


# what a span is while no profiler runs
_OFF = contextlib.nullcontext()


class _Open:
    __slots__ = ("rec", "span", "setup", "scope", "stream")

    def __init__(self, rec, name, attrs, setup):
        self.rec, self.setup = rec, setup
        self.span = Span(None, name, None, None, attrs)

    def __enter__(self):
        rec, sp = self.rec, self.span
        stack = rec._stack()
        sp.id = next(rec._ids)
        if stack:
            sp.parent, sp.request = stack[-1].id, stack[-1].request
        else:
            sp.request = getattr(rec._local, "request", None)
        self.scope = None
        if _profiling():
            self.scope = _Scope(sp.name)
            self.scope.__enter__()
            if not self.setup and torch.cuda.is_initialized():
                self.stream = rec._stream()
                sp.events = (torch.cuda.Event(enable_timing=True),
                             torch.cuda.Event(enable_timing=True))
                sp.events[0].record(self.stream)
        (rec.setup if self.setup else rec.requests).append(sp)
        stack.append(sp)
        sp.start_ns = time.time_ns()
        return sp

    def __exit__(self, *exc):
        sp = self.span
        sp.end_ns = time.time_ns()
        if sp.events is not None:
            sp.events[1].record(self.stream)
        self.rec._stack().pop()
        if self.scope is not None:
            self.scope.__exit__(*exc)
        return False


class _Request:
    __slots__ = ("rec", "rid", "prev")

    def __init__(self, rec, rid):
        self.rec, self.rid = rec, rid

    def __enter__(self):
        local = self.rec._local
        self.prev = getattr(local, "request", None)
        local.request = self.rid

    def __exit__(self, *exc):
        self.rec._local.request = self.prev
        return False


class Recorder:
    """The two bounded buffers of span records (requests, set-up), and each
    thread's stack of open spans."""

    def __init__(self):
        self.requests = deque(maxlen=REQUEST_SPANS)
        self.setup = deque(maxlen=SETUP_SPANS)
        self._ids = itertools.count()
        self._local = threading.local()

    def _stack(self):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _stream(self):
        """The thread's current CUDA stream. ``torch.cuda.current_stream``
        builds a new Stream object on each call, which costs a span more
        than its two event records; the object is kept while the stream
        stays current."""
        key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
        local = self._local
        if getattr(local, "stream_key", None) != key:
            local.stream = torch.cuda.Stream(
                stream_id=key[0], device_index=key[1], device_type=key[2])
            local.stream_key = key
        return local.stream

    def span(self, name, setup=False, **attrs):
        """A context over one layer's work (see the module docstring)."""
        if setup or _profiling():
            return _Open(self, name, attrs, setup)
        return _OFF

    def request(self, rid):
        """A context whose top-level spans carry request id ``rid``."""
        if _profiling():
            return _Request(self, rid)
        return _OFF

    def spans(self):
        """Every record held, set-up first, each buffer in start order,
        with the device ms of each closed span resolved (this waits for
        the span's end event, which is done once the caller has
        synchronised)."""
        out = list(self.setup) + list(self.requests)
        for sp in out:
            if sp.events is not None and sp.end_ns is not None:
                start, end = sp.events
                end.synchronize()
                sp.device_ms = start.elapsed_time(end)
                sp.events = None
        return out

    def clear(self):
        self.requests.clear()
        self.setup.clear()


def self_ms(sp, records, names=None):
    """``sp``'s device ms less those of its nearest descendants named in
    ``names`` (its direct children where ``names`` is None): a layer's
    own time. None where ``sp`` or one of those has no device ms."""
    if sp.device_ms is None:
        return None
    children = {}
    for r in records:
        children.setdefault(r.parent, []).append(r)
    total, todo = sp.device_ms, list(children.get(sp.id, ()))
    while todo:
        c = todo.pop()
        if names is None or c.name in names:
            if c.device_ms is None:
                return None
            total -= c.device_ms
        else:
            todo.extend(children.get(c.id, ()))
    return total


RECORDER = Recorder()
span = RECORDER.span
request = RECORDER.request
spans = RECORDER.spans
clear = RECORDER.clear
