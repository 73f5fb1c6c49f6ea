"""BA503 fixture: lock-order cycles between a graph cache and its
ledger (parsed, never run)."""

import threading


class CacheAndLedger:
    def __init__(self):
        self._cache = threading.Lock()
        self._ledger = threading.Lock()

    def warm(self):
        with self._cache:
            with self._ledger:  # expect: BA503
                pass

    def note(self):
        with self._ledger:
            with self._cache:  # expect: BA503
                pass


class OneHop:
    """The second edge is indirect: `evict` calls `_drop` holding `_a`,
    and `_drop` takes `_b` at its top."""

    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def evict(self):
        with self._a:
            self._drop()  # expect: BA503

    def _drop(self):
        with self._b:
            pass

    def reverse(self):
        with self._b:
            with self._a:  # expect: BA503
                pass


class Reacquire:
    def __init__(self):
        self._m = threading.Lock()

    def outer(self):
        with self._m:
            with self._m:  # expect: BA503
                pass


class Reentrant:
    """Negative: a Condition wraps an RLock, re-entry is allowed."""

    def __init__(self):
        self._cv = threading.Condition()

    def outer(self):
        with self._cv:
            with self._cv:
                pass


class Ordered:
    """Negative: one order everywhere."""

    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def one(self):
        with self._a:
            with self._b:
                pass

    def two(self):
        with self._a, self._b:
            pass
