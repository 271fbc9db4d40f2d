"""Spans and counters of the port: where the host's time goes, and counts
taken where the work happens.

A span is a named interval of one thread's host work::

    with tracing.span("train.step"):
        ...

While tracing is live, a span records its name; its start and end in
nanoseconds since the epoch (``time.time_ns``, the clock of torch.profiler's
events: a session's ``prof.profiler.kineto_results.trace_start_ns()`` plus an
event's ``time_range`` in microseconds); its parent, the span open on its
thread when it began; and its root, the outermost span of that nest, whose
id every span of one frame or one step shares. A span must close on the
thread that opened it and not stay open across a ``yield``.

Tracing is live while ``enable()`` or a ``session()`` is on, or while a
torch.profiler session is active (on any thread). Otherwise ``span`` reads
two flags and returns one shared object that does nothing. A span adds no
event to a profiler session: it calls no ``record_function``, NVTX or other
profiler API, so a profiled window's device timeline and kernel counts are
the same with the port's spans as without them.

A span's record (``Record``) goes to every open ``session()`` or, while
none is open, to the process's recorder (``snapshot``, ``drain``). A
recorder keeps the last ``MAX_SPANS`` records and, by name, aggregates of
all: the count, the total, the self time (the duration less the part that
its children, on its thread, cover) and the longest. Nothing is written
until a caller asks.

Counters are always on: ``count(name, n)`` is a dict add under a lock, made
at layer boundaries only; ``counters(prefix)`` reads them and
``reset_counters(prefix)`` clears them. ``reset()`` clears the process's
recorder and every counter. The training loops write each epoch's
increments into its JSONL line (``train/loop.py::epoch_timing``).

The names, by layer:

- Graph (``graphs.py::CapturedCall``): spans ``graph.call`` (a call on new
  inputs) over ``graph.copy_in`` and ``graph.replay``, and ``graph.capture``
  (the build).
- Train step (``train/steps.py``, ``train/selfsup.py``): span ``train.step``
  over ``train.forward`` (the loss of each microbatch), ``train.backward``,
  ``train.allreduce`` (in a process group) and ``train.optimizer`` (clip and
  update) in an eager step, counter ``train.eager_steps``; in a step
  replayed from its CUDA graph (``graphs.py::CapturedTrainStep``),
  ``train.step`` over ``train.copy_in`` (the batch, the crop offsets and
  the optimizer's scalars into the graph's buffers) and ``train.replay``,
  counter ``train.graph.replays``; the capture, span ``train.capture``
  (inside its step's ``train.step``, its recorded ``train.forward``,
  ``train.backward`` and ``train.optimizer`` inside it), counter
  ``train.graph.captures``.
- Parallel (``parallel/mesh.py``): counters ``parallel.all_reduce`` and
  ``parallel.all_reduce_bytes``, inside ``train.allreduce`` or the forward.
- Data (``data/pipeline.py::DataLoader``): spans ``data.wait`` (the
  consumer blocked on the queue) and ``data.produce`` (the producer thread's
  decode, collate and pin of one batch).
- Loop (``train/loop.py``, ``train/selfsup.py``): spans ``loop.train`` (an
  epoch's steps) over ``loop.step`` (over ``data.wait``, ``loop.preprocess``
  and ``train.step``) and ``loop.log``; ``loop.validate``,
  ``loop.checkpoint``.
- Model (``models/depth_anything.py``): spans ``dav2.encoder`` (the input
  resize, tokens, blocks and taps) and ``dav2.head`` (the DPT head and the
  resize to the frame) of an eager Depth Anything V2 forward; a graph's
  replay records neither.
- Kernels (``kernels/*.py``): counters ``kernel.<name>.launches.<dtype>``,
  graph replays included (``CapturedCall`` adds at each replay the launches
  its capture recorded); ``kernel.softmax_attention.launches.<dtype>`` counts
  the fused attention of ``ops/dispatch.py::softmax_attention`` on the card
  (24 a Depth Anything V2 forward).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, NamedTuple, Optional

from torch.autograd import profiler as _profiler

MAX_SPANS = 1 << 17  # records a recorder keeps; its aggregates cover every span

_clock = time.time_ns


class Record(NamedTuple):
    """One span, ended."""
    name: str
    id: int
    parent: Optional[int]  # None for a root
    root: int
    start_ns: int
    end_ns: int
    self_ns: int

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


class Snapshot(NamedTuple):
    """A recorder's records, oldest first, and its aggregates by name:
    ``{"n", "total_ms", "self_ms", "max_ms"}``."""
    spans: List[Record]
    aggregates: Dict[str, Dict[str, float]]


class Recorder:
    """The records of the spans that ended while it listened: the last
    ``MAX_SPANS``, and the aggregates of all of them by name."""

    def __init__(self):
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=MAX_SPANS)
        self._stats: Dict[str, List[int]] = {}  # name -> [n, total, self, max] (ns)

    def add(self, rec: Record) -> None:
        ns = rec.end_ns - rec.start_ns
        with self._lock:
            self._spans.append(rec)
            s = self._stats.get(rec.name)
            if s is None:
                self._stats[rec.name] = [1, ns, rec.self_ns, ns]
            else:
                s[0] += 1
                s[1] += ns
                s[2] += rec.self_ns
                s[3] = max(s[3], ns)

    def snapshot(self, clear: bool = False) -> Snapshot:
        with self._lock:
            spans, stats = list(self._spans), {k: tuple(v) for k, v in self._stats.items()}
            if clear:
                self._spans.clear()
                self._stats = {}
        return Snapshot(spans, {name: dict(n=n, total_ms=t * 1e-6, self_ms=s * 1e-6,
                                           max_ms=m * 1e-6)
                                for name, (n, t, s, m) in stats.items()})

    def drain(self) -> Snapshot:
        """The snapshot, and the recorder emptied."""
        return self.snapshot(clear=True)


class _Span:
    __slots__ = ("name", "id", "parent", "root", "start_ns", "child_ns")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        top = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent, self.root = (top.id, top.root) if top is not None else (None, self.id)
        self.child_ns = 0
        stack.append(self)
        self.start_ns = _clock()
        return self

    def __exit__(self, *exc):
        end = _clock()
        stack = _local.stack
        stack.pop()
        ns = end - self.start_ns
        if stack:
            stack[-1].child_ns += ns
        rec = Record(self.name, self.id, self.parent, self.root, self.start_ns, end,
                     ns - self.child_ns)
        for sink in _sinks:
            sink.add(rec)
        return False


class _NoSpan:
    """What ``span`` returns while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _NoSpan()

_ids = itertools.count(1)
_local = threading.local()
_RECORDER = Recorder()
_sessions: tuple = ()  # the open sessions' recorders
_sinks = (_RECORDER,)  # where spans go: replaced whole under _lock, read without it
_live = 0  # the depth of enable()
_lock = threading.Lock()
_counts: Dict[str, int] = {}
_counts_lock = threading.Lock()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def span(name: str):
    """A context manager: a span named ``name`` while tracing is live, else
    ``NOOP``."""
    if _live or _profiler._is_profiler_enabled:
        return _Span(name)
    return NOOP


def enable() -> None:
    """Tracing on until the matching ``disable()``; calls nest."""
    global _live
    with _lock:
        _live += 1


def disable() -> None:
    global _live
    with _lock:
        _live = max(0, _live - 1)


@contextlib.contextmanager
def session() -> Iterator[Recorder]:
    """Tracing on in the body, and a ``Recorder`` of its own that gets every
    span that ends while the body runs, on any thread; the process's
    recorder gets none of them."""
    global _sessions, _sinks
    rec = Recorder()
    with _lock:
        _sessions = _sinks = _sessions + (rec,)
    enable()
    try:
        yield rec
    finally:
        disable()
        with _lock:
            _sessions = tuple(s for s in _sessions if s is not rec)
            _sinks = _sessions or (_RECORDER,)


def snapshot() -> Snapshot:
    """The process's recorder: the records and aggregates of the spans that
    ended while no session was open."""
    return _RECORDER.snapshot()


def drain() -> Snapshot:
    """``snapshot()``, and the process's recorder emptied."""
    return _RECORDER.drain()


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name``."""
    with _counts_lock:
        _counts[name] = _counts.get(name, 0) + n


def counters(prefix: str = "") -> Dict[str, int]:
    """The counters whose names start with ``prefix``."""
    with _counts_lock:
        return {k: v for k, v in _counts.items() if k.startswith(prefix)}


def reset_counters(prefix: str = "") -> None:
    """Removes the counters whose names start with ``prefix``."""
    with _counts_lock:
        for k in [k for k in _counts if k.startswith(prefix)]:
            del _counts[k]


def reset() -> None:
    """Empties the process's recorder and removes every counter."""
    _RECORDER.drain()
    reset_counters()
