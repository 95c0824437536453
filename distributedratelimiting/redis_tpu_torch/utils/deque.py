"""Ring-buffer double-ended queue backing the waiter queue.

Functional mirror of the reference's internal ``Deque<T>``
(``System.Collections.Generic/Deque.cs:19-135``): amortized-doubling growth
with a minimum grow of 4, head/tail enqueue/dequeue/peek. Python's
``collections.deque`` would do, but it cannot pop efficiently from arbitrary
positions nor expose the exact eviction order we need; keeping the same
structure as the reference also keeps the queueing semantics auditable
against it line-by-line.

Bounds discipline matches the reference: callers check ``count`` first
(``Deque.cs:49`` — "no bounds checks, caller's responsibility"); here we
raise ``IndexError`` instead of corrupting state, which costs one branch.
"""

from __future__ import annotations

from typing import Generic, Iterator, TypeVar

T = TypeVar("T")

_MIN_GROW = 4


class Deque(Generic[T]):
    __slots__ = ("_buf", "_head", "_size")

    def __init__(self, initial_capacity: int = 0) -> None:
        self._buf: list[T | None] = [None] * initial_capacity
        self._head = 0  # index of the head element
        self._size = 0

    def __len__(self) -> int:
        return self._size

    @property
    def count(self) -> int:
        return self._size

    def enqueue_tail(self, item: T) -> None:
        """``EnqueueTail`` (``Deque.cs:19-32``)."""
        if self._size == len(self._buf):
            self._grow()
        idx = (self._head + self._size) % len(self._buf)
        self._buf[idx] = item
        self._size += 1

    def enqueue_head(self, item: T) -> None:
        if self._size == len(self._buf):
            self._grow()
        self._head = (self._head - 1) % len(self._buf)
        self._buf[self._head] = item
        self._size += 1

    def dequeue_head(self) -> T:
        """``DequeueHead`` (``Deque.cs:47-61``)."""
        if self._size == 0:
            raise IndexError("deque is empty")
        item = self._buf[self._head]
        self._buf[self._head] = None
        self._head = (self._head + 1) % len(self._buf)
        self._size -= 1
        return item  # type: ignore[return-value]

    def dequeue_tail(self) -> T:
        """``DequeueTail`` (``Deque.cs:80-94``)."""
        if self._size == 0:
            raise IndexError("deque is empty")
        idx = (self._head + self._size - 1) % len(self._buf)
        item = self._buf[idx]
        self._buf[idx] = None
        self._size -= 1
        return item  # type: ignore[return-value]

    def peek_head(self) -> T:
        """``PeekHead`` (``Deque.cs:63-70``)."""
        if self._size == 0:
            raise IndexError("deque is empty")
        return self._buf[self._head]  # type: ignore[return-value]

    def peek_tail(self) -> T:
        """``PeekTail`` (``Deque.cs:71-78``)."""
        if self._size == 0:
            raise IndexError("deque is empty")
        return self._buf[(self._head + self._size - 1) % len(self._buf)]  # type: ignore[return-value]

    def remove(self, item: T) -> bool:
        """Remove the first occurrence (identity) — used by cancellation to
        unlink a parked waiter without disturbing order. O(n)."""
        for i in range(self._size):
            idx = (self._head + i) % len(self._buf)
            if self._buf[idx] is item:
                # shift the shorter side
                for j in range(i, self._size - 1):
                    a = (self._head + j) % len(self._buf)
                    b = (self._head + j + 1) % len(self._buf)
                    self._buf[a] = self._buf[b]
                self._buf[(self._head + self._size - 1) % len(self._buf)] = None
                self._size -= 1
                return True
        return False

    def __iter__(self) -> Iterator[T]:
        for i in range(self._size):
            yield self._buf[(self._head + i) % len(self._buf)]  # type: ignore[misc]

    def _grow(self) -> None:
        """Amortized doubling, min grow 4 (``Deque.cs:107-135``)."""
        new_cap = max(len(self._buf) * 2, len(self._buf) + _MIN_GROW)
        new_buf: list[T | None] = [None] * new_cap
        for i in range(self._size):
            new_buf[i] = self._buf[(self._head + i) % len(self._buf)]
        self._buf = new_buf
        self._head = 0
