"""Spans: named, nested intervals of one solve call on the host's clock.

`span(name, **attrs)` is a context manager that reads time.perf_counter()
when it opens and when it closes, and yields its record (`Span`).  A span
opened inside another span of the same thread is its child; every span of
one call carries the id of the call's root.  The solve paths read their
time fields off these records (Results.setup_time, scaling_time,
autotune_time, power_time, time; BatchedResults.setup_time, power_time,
solve_time; solve_problem.capture_time, solve_batched.capture_time), so a
span adds no clock read of its own.  No span synchronizes the device: a
span that ends where the code already waits for the card measures device
work, any other measures host time.

The tree of a thread's last finished call is kept (`last()`), as
solve_batched.probe keeps the last call's probe record; nothing older is.
`collect()` gathers every span that closes in its block, in this thread.
Inside a collect() block, while torch.profiler runs, each span also opens
`torch.profiler.record_function("hprlp::<name>")`, so that it lands in the
profiler's trace as a user annotation on the clock of the kernels and
copies.  Without a collector the spans never touch the profiler.

`root(name)` opens a span only where none is open: the public entries
(model.py::solve, solve_mps, Model.solve, solve_problem, solve_batched)
open their call's root with it, so a direct call to any of them has one
and a nested call adds none.  A mesh rank records its own spans.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch

PREFIX = "hprlp::"

_ids = itertools.count(1)


class _Thread(threading.local):
    def __init__(self):
        self.stack = []  # the open spans, innermost last
        self.calls = []  # per open root, the finished spans of its call
        self.last = []  # the finished spans of the last call
        self.collected = None  # the collect() block's list, if any


_state = _Thread()


class Span:
    """One span's record; `seconds` once it has closed."""

    __slots__ = ("name", "start", "end", "id", "parent", "call", "attrs",
                 "_mark")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.start = self.end = None
        self._mark = None

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def __enter__(self) -> "Span":
        st = _state
        parent = st.stack[-1] if st.stack else None
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.call = parent.call if parent is not None else self.id
        if parent is None:
            st.calls.append([])
        st.stack.append(self)
        if st.collected is not None and torch.autograd._profiler_enabled():
            self._mark = torch.profiler.record_function(PREFIX + self.name)
            self._mark.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.end = time.perf_counter()
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        if self._mark is not None:
            self._mark.__exit__(exc_type, exc, tb)
            self._mark = None
        st = _state
        # A child left open by an exception closes with its parent.
        while st.stack and st.stack.pop() is not self:
            pass
        if st.calls:
            st.calls[-1].append(self)
        if self.parent is None and st.calls:
            st.last = st.calls.pop()
        if st.collected is not None:
            st.collected.append(self)
        return False


def span(name: str, **attrs) -> Span:
    """A span named `name` with `attrs`: use it in a `with` statement."""
    return Span(name, attrs)


def root(name: str, **attrs):
    """span(name) where no span is open in this thread, else nothing."""
    return contextlib.nullcontext() if _state.stack else Span(name, attrs)


@contextlib.contextmanager
def collect():
    """Yields the list to which every span of this thread that closes in
    the block is appended, children before their parents."""
    st = _state
    outer, st.collected = st.collected, []
    try:
        yield st.collected
    finally:
        st.collected = outer


def last() -> list:
    """The spans of this thread's last finished call, its root last."""
    return list(_state.last)
