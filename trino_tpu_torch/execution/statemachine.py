"""Generic listener-based state machine.

Reference: execution/StateMachine.java:43 — thread-safe state holder with
terminal-state sets and state-change listeners, used for query/stage/task
lifecycles throughout the coordinator.
"""

from __future__ import annotations

import threading
from typing import Callable, Generic, Iterable, Optional, TypeVar

T = TypeVar("T")

__all__ = ["StateMachine"]


class StateMachine(Generic[T]):
    def __init__(self, name: str, initial: T, terminal_states: Iterable[T] = ()):
        self.name = name
        self._state = initial
        self._terminal = frozenset(terminal_states)
        self._lock = threading.Lock()
        self._listeners: list[Callable[[T], None]] = []

    def get(self) -> T:
        return self._state

    @property
    def is_terminal(self) -> bool:
        return self._state in self._terminal

    def add_state_change_listener(self, fn: Callable[[T], None]) -> None:
        with self._lock:
            self._listeners.append(fn)
            current = self._state
        fn(current)  # reference semantics: listener fires immediately with current state

    def set(self, new_state: T) -> bool:
        """Unconditional transition (no-op when already terminal or unchanged)."""
        with self._lock:
            if self._state in self._terminal or self._state == new_state:
                return False
            self._state = new_state
            listeners = list(self._listeners)
        for fn in listeners:
            fn(new_state)
        return True

    def compare_and_set(self, expected: T, new_state: T) -> bool:
        with self._lock:
            if self._state != expected or self._state in self._terminal:
                return False
            self._state = new_state
            listeners = list(self._listeners)
        for fn in listeners:
            fn(new_state)
        return True

    def transition(self, allowed_from: Iterable[T], new_state: T) -> bool:
        with self._lock:
            if self._state not in allowed_from or self._state in self._terminal:
                return False
            self._state = new_state
            listeners = list(self._listeners)
        for fn in listeners:
            fn(new_state)
        return True
