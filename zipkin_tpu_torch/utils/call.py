"""Lazy, retryable unit of (possibly remote) work.

The port's own copy of ``zipkin_tpu/utils/call.py``: imports point at
``zipkin_tpu_torch``; the semantics are the reference's.

Reference semantics: ``zipkin2/Call.java`` (SURVEY.md §2.1) — every storage
operation returns a lazy call that can run synchronously (``execute()``),
asynchronously (``enqueue(callback)`` / ``await call``), be cloned for retry,
and composed with ``map``/``flat_map``. In this rebuild most in-process work
is cheap, but the seam is kept so the TPU store can hide async device
dispatch, the throttle wrapper can bound concurrency, and callers are
oblivious to which backend they hit.

Idiomatic-Python adjustments vs the Java original:

- a :class:`Call` is awaitable (``await call`` == async execute),
- ``enqueue`` takes plain ``on_success``/``on_error`` callables instead of a
  Callback interface,
- one-shot semantics are enforced exactly as upstream: executing a call twice
  raises; ``clone()`` gives a fresh one.
"""

from __future__ import annotations

import asyncio
import threading
from typing import Any, Callable, Generic, Optional, TypeVar

V = TypeVar("V")
R = TypeVar("R")


class Call(Generic[V]):
    """A lazy computation yielding ``V``. Subclasses implement ``_do_execute``."""

    def __init__(self) -> None:
        self._executed = False
        self._canceled = False
        self._lock = threading.Lock()

    # -- core ------------------------------------------------------------

    def _do_execute(self) -> V:
        raise NotImplementedError

    def _clone_impl(self) -> "Call[V]":
        raise NotImplementedError

    def execute(self) -> V:
        with self._lock:
            if self._executed:
                raise RuntimeError("Call already executed; use clone()")
            self._executed = True
        if self._canceled:
            raise RuntimeError("Call canceled")
        return self._do_execute()

    def enqueue(
        self,
        on_success: Callable[[V], None],
        on_error: Optional[Callable[[BaseException], None]] = None,
    ) -> None:
        """Run and deliver the result to callbacks (synchronously by default;
        wrappers like the throttle or server hand this to an executor)."""
        try:
            result = self.execute()
        except BaseException as e:  # noqa: BLE001 - delivered, not swallowed
            if on_error is not None:
                on_error(e)
            else:
                raise
            return
        on_success(result)

    def __await__(self):
        return asyncio.to_thread(self.execute).__await__()

    def cancel(self) -> None:
        self._canceled = True

    @property
    def canceled(self) -> bool:
        return self._canceled

    def clone(self) -> "Call[V]":
        return self._clone_impl()

    # -- composition -----------------------------------------------------

    def map(self, fn: Callable[[V], R]) -> "Call[R]":
        return _MapCall(self, fn)

    def flat_map(self, fn: Callable[[V], "Call[R]"]) -> "Call[R]":
        return _FlatMapCall(self, fn)

    # -- constructors ----------------------------------------------------

    @staticmethod
    def constant(value: V) -> "Call[V]":
        return _ConstantCall(value)

    @staticmethod
    def emptyList() -> "Call[list]":
        return _ConstantCall([])

    @staticmethod
    def of(fn: Callable[[], V]) -> "Call[V]":
        return _FnCall(fn)


class _ConstantCall(Call[V]):
    def __init__(self, value: V) -> None:
        super().__init__()
        self._value = value

    def _do_execute(self) -> V:
        return self._value

    def _clone_impl(self) -> "Call[V]":
        return _ConstantCall(self._value)


class _FnCall(Call[V]):
    def __init__(self, fn: Callable[[], V]) -> None:
        super().__init__()
        self._fn = fn

    def _do_execute(self) -> V:
        return self._fn()

    def _clone_impl(self) -> "Call[V]":
        return _FnCall(self._fn)


class _MapCall(Call[R]):
    def __init__(self, delegate: Call[V], fn: Callable[[V], R]) -> None:
        super().__init__()
        self._delegate = delegate
        self._fn = fn

    def _do_execute(self) -> R:
        return self._fn(self._delegate.execute())

    def _clone_impl(self) -> "Call[R]":
        return _MapCall(self._delegate.clone(), self._fn)


class _FlatMapCall(Call[R]):
    def __init__(self, delegate: Call[V], fn: Callable[[V], Call[R]]) -> None:
        super().__init__()
        self._delegate = delegate
        self._fn = fn

    def _do_execute(self) -> R:
        return self._fn(self._delegate.execute()).execute()

    def _clone_impl(self) -> "Call[R]":
        return _FlatMapCall(self._delegate.clone(), self._fn)


def aggregate_calls(calls: "list[Call[Any]]") -> Call[None]:
    """Run several calls, surfacing the first error after attempting all.

    Reference: ``zipkin2/internal/AggregateCall.java``.
    """

    class _Aggregate(Call[None]):
        def __init__(self, inner: "list[Call[Any]]") -> None:
            super().__init__()
            self._inner = inner

        def _do_execute(self) -> None:
            first_error: Optional[BaseException] = None
            for c in self._inner:
                try:
                    c.execute()
                except BaseException as e:  # noqa: BLE001
                    if first_error is None:
                        first_error = e
            if first_error is not None:
                raise first_error

        def _clone_impl(self) -> "Call[None]":
            return _Aggregate([c.clone() for c in self._inner])

    return _Aggregate(calls)
