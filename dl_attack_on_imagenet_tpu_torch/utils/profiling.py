"""Tracing and step timing.

Port of ``dl_attack_on_imagenet_tpu/utils/profiling.py``: ``trace(log_dir)``
records a torch.profiler trace of the host and the card into ``log_dir``,
``annotate(name)`` names a span of the program, and ``StepTimer`` keeps
wall-clock step statistics with the first ``warmup`` steps left out. A
timed step must end in ``torch.cuda.synchronize()`` (or a host read of its
result), or the timer measures only the enqueue.

Spans. ``annotate`` records while a torch profiler session is on: torch's
process-wide ``torch.autograd.profiler._is_profiler_enabled``, which every
thread reads, and which ``trace`` sets too. It then records from every
thread, also from those whose ``record_function`` ranges the profiler does
not see (a thread other than the one that started it). A span keeps its
name, its thread, its start and end in Unix nanoseconds (``time.time_ns``,
the clock of the profiler's own events), its parent (the span open below it
in its thread) and its unit of work: the ``unit`` a span is given (such as
``ADIL.forward``'s call, or a job's epoch), else its parent's. In a thread
the profiler sees it also opens a profiler range of the same name: torch's
``_RecordFunctionFast``, a ``cpu_op`` in the trace, at a seventh of
``record_function``'s cost, since a span that closes after a blocking read
spends that cost while the card waits. Without a profiler it reads that one
flag and does nothing else.

Device clock. ``annotate(name, device=True)`` also records, while
recording, a CUDA event pair on the current stream around the span's
forward; the span's ``backward(inp, out)`` adds a pair around its share of
an input gradient, from the moment ``out``'s gradient is ready to the
moment ``inp``'s is (hooks on the two tensors, where both take part in
one). ``device_totals()`` synchronises and gives the device seconds by
name, forward and backward apart. A pair measures the card's time from one
event to the other, gaps included.

``spans()`` gives the recorded spans, each with its self time (its duration
less what its children cover), ``totals()`` their count, total seconds and
self seconds by name; ``reset()`` clears them and the event pairs. Spans
named ``sync/<site>`` are the program's blocking host reads of device data.
``trace`` writes the spans of the threads the profiler did not see into its
``trace.json``, on the trace's own time base.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _torch_profiler


class Span(NamedTuple):
    """One recorded span; ``parent`` is the ``id`` of the span open below it
    in its thread (None at the bottom), ``thread`` the thread's native id,
    ``self_ns`` its duration less its children's, ``seen`` whether the
    profiler recorded its twin range."""

    id: int
    parent: Optional[int]
    name: str
    unit: Any
    thread: int
    thread_name: str
    start_ns: int
    end_ns: int
    self_ns: int
    seen: bool


class Total(NamedTuple):
    """The recorded spans of one name: how many, and their summed total and
    self seconds."""

    count: int
    total_s: float
    self_s: float


class DeviceTotal(NamedTuple):
    """The device-timed spans of one name: how many forwards were timed,
    and the card's seconds in their forwards and in their backwards."""

    count: int
    forward_s: float
    backward_s: float


def _event() -> torch.cuda.Event:
    """A timing event recorded on the current stream."""
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def _mark(pair: list, at: int, grad) -> None:
    """A gradient hook: record ``pair[at]`` as the gradient is ready."""
    pair[at] = _event()


class _NoSpan:
    """What ``with annotate(...) as span`` gives without a profiler."""

    @staticmethod
    def backward(inp: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        return out


class _Open:
    """A span while it is open: the context manager ``annotate`` returns
    while recording."""

    __slots__ = ("rec", "name", "unit", "id", "parent", "twin", "start", "child_ns", "device",
                 "begin")

    def __init__(self, rec: "Recorder", name: str, unit, device: bool = False):
        self.rec, self.name, self.unit, self.device = rec, name, unit, device

    def __enter__(self):
        stack = self.rec._local_state().stack
        below = stack[-1] if stack else None
        if self.unit is None and below is not None:
            self.unit = below.unit
        self.id, self.parent = next(self.rec._ids), below.id if below is not None else None
        self.twin = None
        if torch._C._autograd._profiler_enabled():  # this thread's ranges reach the trace
            self.twin = torch._C._profiler._RecordFunctionFast(self.name)
            self.twin.__enter__()
        self.child_ns = 0
        stack.append(self)
        self.begin = _event() if self.device else None
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.begin is not None:
            self.rec._pairs.append((self.name, "forward", [self.begin, _event()]))
        if self.twin is not None:
            self.twin.__exit__(*exc)
        state = self.rec._local_state()
        state.stack.pop()
        if state.stack:
            state.stack[-1].child_ns += end - self.start
        self.rec._spans.append(Span(self.id, self.parent, self.name, self.unit, *state.thread,
                                    self.start, end, end - self.start - self.child_ns,
                                    self.twin is not None))
        return False

    def backward(self, inp: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        """With ``device``, time the span's share of an input gradient on the
        card, from ``out``'s gradient to ``inp``'s, where both take part in
        one. Returns ``out``."""
        if self.device and torch.is_grad_enabled() and inp.requires_grad and out.requires_grad:
            pair = [None, None]
            self.rec._pairs.append((self.name, "backward", pair))
            out.register_hook(functools.partial(_mark, pair, 0))
            inp.register_hook(functools.partial(_mark, pair, 1))
        return out


class Recorder:
    """The spans of a process, from every thread. A span is appended as it
    closes, which the interpreter lock keeps whole."""

    def __init__(self):
        self._local = threading.local()
        self._ids = itertools.count()
        self._spans: List[Span] = []
        self._pairs: List[tuple] = []  # (name, "forward" | "backward", [start, end])

    def _local_state(self):
        """The calling thread's open spans (``stack``, innermost last) and
        its (native id, name) (``thread``)."""
        state = self._local
        if not hasattr(state, "stack"):
            thread = threading.current_thread()
            state.stack, state.thread = [], (thread.native_id, thread.name)
        return state

    def spans(self) -> List[Span]:
        return list(self._spans)

    def totals(self) -> Dict[str, Total]:
        sums: Dict[str, List[float]] = {}
        for s in self.spans():
            t = sums.setdefault(s.name, [0, 0, 0])
            t[0] += 1
            t[1] += s.end_ns - s.start_ns
            t[2] += s.self_ns
        return {name: Total(n, total / 1e9, own / 1e9) for name, (n, total, own) in sums.items()}

    def device_totals(self) -> Dict[str, DeviceTotal]:
        pairs = list(self._pairs)
        if pairs:
            torch.cuda.synchronize()
        sums: Dict[str, List[float]] = {}
        for name, phase, (start, end) in pairs:
            t = sums.setdefault(name, [0, 0.0, 0.0])
            if phase == "forward":
                t[0] += 1
            if start is not None and end is not None:  # a backward that ran
                t[1 if phase == "forward" else 2] += start.elapsed_time(end) / 1e3
        return {name: DeviceTotal(*t) for name, t in sums.items()}

    def reset(self) -> None:
        self._spans.clear()
        self._pairs.clear()


_RECORDER = Recorder()
_OFF = contextlib.nullcontext(_NoSpan())


def annotate(name: str, unit=None, device: bool = False):
    """A named span of the program (see the module): recorded while a
    profiler session is on, a no-op otherwise. ``unit``, a tuple of parts,
    starts a unit of work that the spans inside it belong to. ``device``
    (for work on the card only) also times it on the card; ``with ... as
    span`` gives ``span.backward(inp, out)`` in either case."""
    if not _torch_profiler._is_profiler_enabled:
        return _OFF
    return _Open(_RECORDER, name, unit, device)


def spans() -> List[Span]:
    """The spans recorded so far, in the order they closed."""
    return _RECORDER.spans()


def totals() -> Dict[str, Total]:
    """Count, total and self seconds of the recorded spans, by name."""
    return _RECORDER.totals()


def device_totals() -> Dict[str, DeviceTotal]:
    """The card's seconds in the device-timed spans, by name, forward and
    backward apart, after a synchronisation."""
    return _RECORDER.device_totals()


def reset() -> None:
    """Forget the recorded spans, their totals and the event pairs."""
    _RECORDER.reset()


def _unit_label(unit) -> str:
    return " ".join(map(str, unit)) if isinstance(unit, tuple) else str(unit)


def _add_unseen(path: str, unseen: List[Span]) -> None:
    """Append ``unseen`` to the Chrome trace at ``path`` as complete events
    on its time base (``ts`` in microseconds from ``baseTimeNanoseconds``),
    each thread named."""
    if not unseen:
        return
    with open(path) as f:
        doc = json.load(f)
    base, pid = doc.get("baseTimeNanoseconds", 0), os.getpid()
    events = doc["traceEvents"]
    for tid, tname in sorted({(s.thread, s.thread_name) for s in unseen}):
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": tname}})
    for s in unseen:
        events.append({"ph": "X", "cat": "user_annotation", "name": s.name, "pid": pid,
                       "tid": s.thread, "ts": (s.start_ns - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"span": s.id, "parent": s.parent, "unit": _unit_label(s.unit)}})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Record a torch.profiler trace of CPU and, where there is one, CUDA
    activity into ``log_dir`` as a Chrome trace (``trace.json``, which
    Perfetto and TensorBoard open); a no-op for None. ``annotate`` spans
    inside show in it from every thread."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    start = time.time_ns()
    with torch.profiler.profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _add_unseen(path, [s for s in spans() if not s.seen and s.start_ns >= start])


class StepTimer:
    """Wall-clock step statistics with warm-up exclusion.

    Usage::

        timer = StepTimer(warmup=1)
        for batch in data:
            with timer.step():
                loss = train_step(...)
                float(loss)
        print(timer.summary())
    """

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times: List[float] = []
        self._count = 0

    @contextlib.contextmanager
    def step(self):
        start = time.perf_counter()
        yield
        self.record(time.perf_counter() - start)

    def record(self, elapsed: float) -> None:
        """Record an externally measured step duration (same warm-up rule)."""
        self._count += 1
        if self._count > self.warmup:
            self.times.append(elapsed)

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else float("nan")

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {"steps": 0, "mean_s": float("nan"),
                    "steps_per_sec": float("nan")}
        return {
            "steps": len(self.times),
            "mean_s": self.mean,
            "min_s": min(self.times),
            "max_s": max(self.times),
            "steps_per_sec": 1.0 / self.mean,
        }
