"""The port's span recorder and its counters, for reading a profiler trace
stage by stage.

A span is a named range of host time around one stage of the port: the
entry points and the operators' matvecs, the plan builders, each named
stage that :func:`ops.binned.run_stages` runs (``slot_values``,
``spread kernel``, ``fold``, ``rfftn``, ...), the position cotangent and
each autograd backward (the port's own, and the nodes PyTorch runs for
a stage's backward), and the first load of the kernel libraries.
Device work launched inside a span belongs to that stage; a device idle
gap inside a span is that stage's host time.

The recorder is off unless :func:`enable` turns it on. Off,
:func:`span` returns one shared object that does nothing: no clock is
read and nothing is allocated. On, each span records its name, its start
and end in ns of ``time.time_ns()`` (the Unix clock, which is the clock
``torch.profiler`` gives its host and device events), its thread's
``threading.get_ident()`` (the pthread id, which the profiler's CUDA
runtime events carry, cut to a signed 32-bit ``device_resource_id``),
its own id, its parent's id and the id of its root: the
outermost span open on its thread when it began, an entry-point call or
an autograd backward. Each thread keeps its own stack, so the CUDA
backward that autograd runs on its device thread records spans rooted in
its ``backward``. The spans stay in memory until :func:`drain`.

:func:`counters` reads every kernel wrapper's launch counter
(``ops/contract.py``, ``ops/ragged.py``, ``ops/benes.py``,
``ops/bitonic.py``, ``ops/tilefold.py``) and ``kernel_builds``, the
compiles this process ran (``_build.build``, ``_native.build_native``), in
one snapshot.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from typing import NamedTuple

__all__ = ["Span", "Deferred", "enable", "disable", "enabled", "span", "spanned", "deferred",
           "drain", "counters", "count_build"]


class Span(NamedTuple):
    """One recorded span; times in ns of ``time.time_ns()``."""

    name: str
    start_ns: int
    end_ns: int
    thread: int  # threading.get_ident() of the recording thread
    id: int
    parent: int | None  # the enclosing span on the same thread
    root: int  # the outermost enclosing span on the same thread (itself if none)


class _Recorder:
    def __init__(self):
        self.on = False
        self.lock = threading.Lock()
        self.spans = []
        self.ids = itertools.count(1)
        self.local = threading.local()
        self.builds = 0


_REC = _Recorder()


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Open:
    __slots__ = ("name", "id", "parent", "root", "start", "stack", "thread")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        local = _REC.local
        stack = getattr(local, "stack", None)
        if stack is None:
            stack = local.stack = []
            local.thread = threading.get_ident()
        with _REC.lock:
            self.id = next(_REC.ids)
        top = stack[-1] if stack else None
        self.parent = None if top is None else top.id
        self.root = self.id if top is None else top.root
        self.stack, self.thread = stack, local.thread
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self.stack.pop()
        rec = Span(self.name, self.start, end, self.thread, self.id, self.parent, self.root)
        with _REC.lock:
            _REC.spans.append(rec)
        return False


def enable() -> None:
    """Record spans from now on, in every thread."""
    _REC.on = True


def disable() -> None:
    """Stop recording; spans open now still record when they close."""
    _REC.on = False


def enabled() -> bool:
    return _REC.on


def span(name: str):
    """A context manager that records ``name`` around its block while the
    recorder is on, and does nothing (one shared object) while it is off."""
    return _Open(name) if _REC.on else _NOOP


def spanned(name: str):
    """Decorator: run the function inside :func:`span` ``(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _REC.on:
                return fn(*args, **kwargs)
            with _Open(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


class Deferred:
    """Spans opened and closed by two callbacks rather than a block, off
    the thread's stack: the autograd nodes that PyTorch runs for a stage's
    backward (``ops/binned.py:run_stages``) call :meth:`open` before the
    first and :meth:`close` after the last. ``names`` nest, outermost
    first, each span from open to close, on the thread that opened them;
    nothing is recorded unless both ran."""

    __slots__ = ("names", "ids", "start", "thread")

    def __init__(self, names: tuple):
        self.names = names
        self.start = None

    def open(self) -> None:
        with _REC.lock:
            self.ids = [next(_REC.ids) for _ in self.names]
        self.thread = threading.get_ident()
        self.start = time.time_ns()

    def close(self) -> None:
        if self.start is None:
            return
        end = time.time_ns()
        root, parent = self.ids[0], None
        recs = []
        for name, sid in zip(self.names, self.ids):
            recs.append(Span(name, self.start, end, self.thread, sid, parent, root))
            parent = sid
        with _REC.lock:
            _REC.spans.extend(recs)
        self.start = None


def deferred(names: tuple) -> Deferred | None:
    """A :class:`Deferred` of ``names`` while the recorder is on, else None."""
    return Deferred(names) if _REC.on else None


def drain() -> list:
    """The spans recorded since the last drain, in the order they closed,
    and forget them."""
    with _REC.lock:
        out, _REC.spans = _REC.spans, []
    return out


def count_build() -> None:
    """Count one compile of a kernel library (the builders call this)."""
    with _REC.lock:
        _REC.builds += 1


def counters() -> dict:
    """One snapshot of the program's counters: each kernel wrapper's
    ``launches`` under its name, a spread's ``launches_by_design`` as
    ``<name>.<design>``, and ``kernel_builds``."""
    from .ops import benes, bitonic, contract, ragged, tilefold

    out = {}
    for mod, names in ((contract, ("spread_tiles_dense", "spread_tiles", "gather_points",
                                   "pos_grad")),
                       (ragged, ("expand_rows", "compact_rows")),
                       (benes, ("benes_outer", "benes_local")),
                       (bitonic, ("bitonic_local_sort", "bitonic_cross_round",
                                  "bitonic_local_merge")),
                       (tilefold, ("fold_tiles_to_grid", "unfold_grid_to_tiles"))):
        for name in names:
            fn = getattr(mod, name)
            out[name] = getattr(fn, "launches", 0)
            for design, n in getattr(fn, "launches_by_design", {}).items():
                out[f"{name}.{design}"] = n
    out["kernel_builds"] = _REC.builds
    return out
