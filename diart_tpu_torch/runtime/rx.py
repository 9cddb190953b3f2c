"""Minimal push-based reactive streams (port of ``diart_tpu/runtime/rx.py``).

diart builds its runtime on RxPY (its ``operators.py`` and
``sources.py:29-32``). That dependency is replaced by this
small, self-contained implementation of the exact operator surface the
framework needs: ``Subject``, ``pipe`` with ``map``/``filter``/``scan``/
``do_action``/``do``/``flat_map``/``buffer_with_count``, and observer
subscription with ``on_next/on_error/on_completed`` semantics.

Single-threaded by design: sources push from their reader thread, and the
chain executes synchronously downstream (same execution model as the
default Rx scheduler diart uses).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional

__all__ = ["Observer", "Observable", "Subject", "ops"]


class Observer:
    """Receiver of stream events (mirrors ``rx.core.Observer``)."""

    def on_next(self, value: Any) -> None:  # pragma: no cover - interface
        pass

    def on_error(self, error: Exception) -> None:  # pragma: no cover
        pass

    def on_completed(self) -> None:  # pragma: no cover
        pass


class _CallbackObserver(Observer):
    def __init__(self, on_next=None, on_error=None, on_completed=None):
        self._next = on_next
        self._error = on_error
        self._completed = on_completed

    def on_next(self, value):
        if self._next:
            self._next(value)

    def on_error(self, error):
        if self._error:
            self._error(error)

    def on_completed(self):
        if self._completed:
            self._completed()


class Observable:
    """A push stream you can ``pipe`` operators onto and ``subscribe`` to."""

    def __init__(self, subscribe_fn: Callable[[Observer], None]):
        self._subscribe_fn = subscribe_fn

    def subscribe(
        self,
        on_next: Optional[Callable] = None,
        on_error: Optional[Callable] = None,
        on_completed: Optional[Callable] = None,
        observer: Optional[Observer] = None,
    ) -> None:
        obs = observer or _CallbackObserver(on_next, on_error, on_completed)
        self._subscribe_fn(obs)

    def pipe(self, *operators: Callable[["Observable"], "Observable"]) -> "Observable":
        stream = self
        for op in operators:
            stream = op(stream)
        return stream


class Subject(Observable):
    """An observable you push values into (mirrors ``rx.subject.Subject``)."""

    def __init__(self):
        super().__init__(self._subscribe)
        self._observers: List[Observer] = []
        self._done = False

    def _subscribe(self, observer: Observer) -> None:
        self._observers.append(observer)

    def on_next(self, value: Any) -> None:
        if self._done:
            return
        for obs in list(self._observers):
            obs.on_next(value)

    def on_error(self, error: Exception) -> None:
        if self._done:
            return
        self._done = True
        for obs in list(self._observers):
            obs.on_error(error)

    def on_completed(self) -> None:
        if self._done:
            return
        self._done = True
        for obs in list(self._observers):
            obs.on_completed()


class _Op:
    """Factory namespace for stream operators (mirrors ``rx.operators``)."""

    @staticmethod
    def map(fn: Callable) -> Callable[[Observable], Observable]:
        def op(source: Observable) -> Observable:
            def subscribe(observer: Observer):
                source.subscribe(
                    on_next=lambda v: observer.on_next(fn(v)),
                    on_error=observer.on_error,
                    on_completed=observer.on_completed,
                )

            return Observable(subscribe)

        return op

    @staticmethod
    def filter(pred: Callable) -> Callable[[Observable], Observable]:
        def op(source: Observable) -> Observable:
            def subscribe(observer: Observer):
                source.subscribe(
                    on_next=lambda v: observer.on_next(v) if pred(v) else None,
                    on_error=observer.on_error,
                    on_completed=observer.on_completed,
                )

            return Observable(subscribe)

        return op

    @staticmethod
    def scan(fn: Callable, seed: Any) -> Callable[[Observable], Observable]:
        def op(source: Observable) -> Observable:
            def subscribe(observer: Observer):
                state = {"acc": seed}

                def on_next(v):
                    state["acc"] = fn(state["acc"], v)
                    observer.on_next(state["acc"])

                source.subscribe(
                    on_next=on_next,
                    on_error=observer.on_error,
                    on_completed=observer.on_completed,
                )

            return Observable(subscribe)

        return op

    @staticmethod
    def do_action(on_next: Callable) -> Callable[[Observable], Observable]:
        def op(source: Observable) -> Observable:
            def subscribe(observer: Observer):
                def handler(v):
                    on_next(v)
                    observer.on_next(v)

                source.subscribe(
                    on_next=handler,
                    on_error=observer.on_error,
                    on_completed=observer.on_completed,
                )

            return Observable(subscribe)

        return op

    @staticmethod
    def do(sink: Observer) -> Callable[[Observable], Observable]:
        """Tee all three event kinds into ``sink`` while passing through."""

        def op(source: Observable) -> Observable:
            def subscribe(observer: Observer):
                def on_next(v):
                    sink.on_next(v)
                    observer.on_next(v)

                def on_error(e):
                    sink.on_error(e)
                    observer.on_error(e)

                def on_completed():
                    sink.on_completed()
                    observer.on_completed()

                source.subscribe(
                    on_next=on_next, on_error=on_error, on_completed=on_completed
                )

            return Observable(subscribe)

        return op

    @staticmethod
    def flat_map(fn: Callable[[Any], Iterable]) -> Callable[[Observable], Observable]:
        def op(source: Observable) -> Observable:
            def subscribe(observer: Observer):
                def on_next(v):
                    for item in fn(v):
                        observer.on_next(item)

                source.subscribe(
                    on_next=on_next,
                    on_error=observer.on_error,
                    on_completed=observer.on_completed,
                )

            return Observable(subscribe)

        return op

    @staticmethod
    def buffer_with_count(count: int) -> Callable[[Observable], Observable]:
        """Group values into lists of ``count`` (emits the remainder on
        completion, matching rx semantics)."""

        def op(source: Observable) -> Observable:
            def subscribe(observer: Observer):
                buffer: List[Any] = []

                def on_next(v):
                    buffer.append(v)
                    if len(buffer) == count:
                        observer.on_next(list(buffer))
                        buffer.clear()

                def on_completed():
                    if buffer:
                        observer.on_next(list(buffer))
                        buffer.clear()
                    observer.on_completed()

                source.subscribe(
                    on_next=on_next,
                    on_error=observer.on_error,
                    on_completed=on_completed,
                )

            return Observable(subscribe)

        return op


ops = _Op
