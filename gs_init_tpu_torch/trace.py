"""Spans and counters inside the port, off by default.

``span(name)`` times a region of the program, ``count(name, n)`` adds a host
integer, ``count_device(name, t)`` adds a 0-d device tensor into an
accumulator that stays on the device. Off (the default), ``span`` returns
one shared no-op context manager after a flag check and the counters return
at once: no CUDA event, no ``record_function``, no device tensor and no host
sync is made.

``enable(device)`` turns them on. Each span then
- enters ``torch.profiler.record_function(name)`` while a ``torch.profiler``
  is recording (the Runner's ``profile_start`` window, a benchmark's
  profiled steps), whose trace then holds it as a ``user_annotation`` on the
  kernels' clock (outside a profiler it would cost ~9 us and record nothing);
- reads the host clock (``time.perf_counter_ns``) at its start and end;
- on a CUDA device, unless opened with ``device=False``, records a pair of
  timing events on the device's current stream, read once the device has
  passed them (``Event.query()``) or at ``report()``: never waited for on
  the hot path. An event record costs 4-30 us of host time on an H100, so
  spans that open many times a step (the step's phases, the loop's own
  spans, the data path) take the host clock only;
- notes its parent (the span open below it on the same thread) and the
  current step or image (``set_step`` / ``set_item``), so that the spans of
  one step share an identifier.

Memory is bounded over any run: each name keeps its count, its sums (host,
device and self time: the span less what its children cover) and its last
``SAMPLE`` durations for medians; ``records()`` keeps the last ``SAMPLE``
spans (the Runner writes them beside its report). ``report()`` synchronises once and returns
``{"spans": {name: {n, host_ms, device_ms, self_host_ms, median_host_ms,
median_device_ms}}, "counters": {name: value}, "launches": {kernel: n}}``
(the hand-written kernels' launches since ``enable`` or ``reset``);
``reset()`` clears what was recorded. Spans may run on several threads
(the batch prefetcher's loads): aggregation takes a lock.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import statistics
import threading
import time
from typing import Optional

import torch

SAMPLE = 4096  # durations kept per span name for its medians; spans kept by records()
PENDING_MAX = 8192  # event pairs waiting for the device; past it the oldest is waited for
FOLD = 256  # device counts kept per counter before they are summed into its total

_on = False
_tracer: Optional["_Tracer"] = None
_NOOP = contextlib.nullcontext()


def _no_mark(name: str) -> None:
    return None


class _Stat:
    __slots__ = ("n", "host_ns", "self_ns", "n_device", "device_ms", "host_sample", "device_sample")

    def __init__(self):
        self.n = self.host_ns = self.self_ns = self.n_device = 0
        self.device_ms = 0.0
        self.host_sample = collections.deque(maxlen=SAMPLE)
        self.device_sample = collections.deque(maxlen=SAMPLE)

    def as_dict(self) -> dict:
        return dict(
            n=self.n,
            host_ms=self.host_ns / 1e6,
            device_ms=self.device_ms if self.n_device else None,
            self_host_ms=self.self_ns / 1e6,
            median_host_ms=statistics.median(self.host_sample) / 1e6,
            median_device_ms=statistics.median(self.device_sample) if self.device_sample else None,
        )


class _Tracer:
    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.current_stream(device) if self.cuda else None
        self.lock = threading.Lock()
        self.local = threading.local()
        self.item = None
        self.pool = []  # timing events whose reading is done, for reuse
        self.clear()

    def clear(self) -> None:
        from . import kernels

        with self.lock:
            self.stats = {}
            self.counts = collections.Counter()
            self.acc = {}  # counter -> (device total, the counts not yet summed into it)
            self.pending = collections.deque()
            self.recent = collections.deque(maxlen=SAMPLE)
            self.launches0 = dict(kernels.LAUNCHES)

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def event(self) -> torch.cuda.Event:
        try:
            ev = self.pool.pop()
        except IndexError:
            ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        return ev

    def finish(self, sp: "_Span", dur_ns: int, ev1) -> None:
        with self.lock:
            st = self.stats.get(sp.name)
            if st is None:
                st = self.stats[sp.name] = _Stat()
            st.n += 1
            st.host_ns += dur_ns
            st.self_ns += dur_ns - sp.child_ns
            st.host_sample.append(dur_ns)
            self.recent.append(dict(name=sp.name, parent=sp.parent, item=sp.item, host_ms=dur_ns / 1e6,
                                    self_host_ms=(dur_ns - sp.child_ns) / 1e6))
            if ev1 is not None:
                self.pending.append((st, sp.ev0, ev1))
                self.drain()

    def drain(self, wait: bool = False) -> None:
        """Read the event pairs the device has passed, oldest first (under
        the lock); ``wait`` reads them all (after a synchronise)."""
        while self.pending:
            st, e0, e1 = self.pending[0]
            if not wait and not e1.query():
                if len(self.pending) <= PENDING_MAX:
                    return
                e1.synchronize()
            self.pending.popleft()
            ms = e0.elapsed_time(e1)
            st.n_device += 1
            st.device_ms += ms
            st.device_sample.append(ms)
            self.pool += (e0, e1)


class _Span:
    __slots__ = ("t", "name", "timed", "parent", "item", "child_ns", "rf", "ev0", "t0")

    def __init__(self, tracer: _Tracer, name: str, device: bool = True):
        self.t, self.name, self.timed = tracer, name, device and tracer.cuda

    def __enter__(self):
        t = self.t
        stack = t.stack()
        self.parent = stack[-1].name if stack else None
        self.item = t.item
        self.child_ns = 0
        stack.append(self)
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.ev0 = t.event() if self.timed else None
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        t = self.t
        ev1 = t.event() if self.ev0 is not None else None
        stack = t.stack()
        while stack and stack[-1] is not self:  # children an exception left open
            stack[-1].__exit__(None, None, None)
        if stack:
            stack.pop()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        dur = t1 - self.t0
        if stack:
            stack[-1].child_ns += dur
        t.finish(self, dur, ev1)
        return False


def enabled() -> bool:
    """Whether spans and counters record (for a count whose argument costs
    device work to compute)."""
    return _on


def enable(device=None) -> None:
    """Turn spans and counters on for ``device`` (CPU when None). What was
    recorded for the same device is kept."""
    global _on, _tracer
    device = torch.device("cpu") if device is None else torch.device(device)
    if _tracer is None or _tracer.device != device:
        _tracer = _Tracer(device)
    _on = True


def disable() -> None:
    """Turn spans and counters off; ``report()`` still reads what was recorded."""
    global _on
    _on = False


def reset() -> None:
    """Forget every span, counter and launch recorded so far."""
    if _tracer is not None:
        _tracer.clear()


def span(name: str, device: bool = True):
    """A context manager that records the region as span ``name``, with
    its device time unless ``device`` is False."""
    if not _on:
        return _NOOP
    return _Span(_tracer, name, device)


def spanned(name: str, device: bool = True):
    """Decorate a function so that each call is span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Span(_tracer, name, device):
                return fn(*args, **kwargs)
        return inner
    return wrap


class _Phases:
    def __init__(self, names: dict, mark):
        self.order = list(names.items())
        self.i = 0
        self.mark = mark
        self.open = _Span(_tracer, self.order[0][1], device=False).__enter__()

    def __call__(self, name: str) -> None:
        want = self.order[self.i][0] if self.i < len(self.order) else None
        if name != want:
            raise ValueError(f"phase {name!r} ended where {want!r} runs")
        self.open.__exit__(None, None, None)
        if self.mark is not None:
            self.mark(name)
        self.i += 1
        self.open = (_Span(_tracer, self.order[self.i][1], device=False).__enter__()
                     if self.i < len(self.order) else None)


def phases(names: dict, mark=None):
    """Phases that follow each other, ``names`` mapping each phase's
    boundary (the name it ends with) to its span, in order. Returns
    ``boundary(name)``: it ends the running phase's span, calls
    ``mark(name)`` when given, and opens the next phase's span; the first
    opens at once. The phases take the host clock only. Off, ``boundary``
    only calls ``mark``."""
    if not _on:
        return mark or _no_mark
    return _Phases(names, mark)


def set_step(step) -> None:
    """The identifier the spans opened from now on carry: a train step."""
    if _on:
        _tracer.item = step


def set_item(name) -> None:
    """The identifier the spans opened from now on carry: an image."""
    if _on:
        _tracer.item = name


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the host counter ``name``."""
    if not _on:
        return
    with _tracer.lock:
        _tracer.counts[name] += n


def count_device(name: str, t: torch.Tensor) -> None:
    """Add the 0-d tensor ``t`` to the counter ``name``, on ``t``'s device
    and without a sync; read at ``report()``. ``t`` is kept, not copied,
    until ``FOLD`` counts are summed at once (two launches), so it must not
    be written afterwards."""
    if not _on:
        return
    with _tracer.lock:
        total, held = _tracer.acc.setdefault(name, (None, []))
        held.append(t.detach().reshape(()))
        if len(held) >= FOLD:
            _tracer.acc[name] = (_fold(total, held), [])


def _fold(total, held):
    """``total`` (None for none yet) plus the sum of ``held``, in int64 or
    float64."""
    s = torch.stack(held)
    s = s.sum(dtype=torch.float64 if s.is_floating_point() else torch.int64)
    return s if total is None else total + s


def records() -> list:
    """The last ``SAMPLE`` spans to end: name, parent, item (step or image),
    host_ms, self_host_ms."""
    if _tracer is None:
        return []
    with _tracer.lock:
        return list(_tracer.recent)


def report() -> dict:
    """Every span's and counter's aggregate so far (one synchronise)."""
    from . import kernels

    t = _tracer
    if t is None:
        return dict(spans={}, counters={}, launches={})
    if t.cuda:
        torch.cuda.synchronize(t.device)
    with t.lock:
        t.drain(wait=True)
        spans = {name: st.as_dict() for name, st in t.stats.items()}
        counters = dict(t.counts)
        for name, (total, held) in t.acc.items():
            total = _fold(total, held) if held else total
            counters[name] = counters.get(name, 0) + total.item()
        launches = {k: v - t.launches0.get(k, 0) for k, v in kernels.LAUNCHES.items()}
    return dict(spans=spans, counters=counters, launches=launches)
