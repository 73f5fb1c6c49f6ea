"""BA501 fixture: shared mutation across thread contexts, in the shape
of the port's retire watchdog and serving dispatcher (parsed, never run).

Covers Thread-target discovery through an import alias, the
``# ba-lint: thread-entry`` annotation, guarded and unguarded writes,
the common-lock negative and the suppression demo.
"""

import threading
import threading as th

import torch


class RetireWatchdog:
    """A watchdog thread beside the dispatch loop: `_run` on its own
    thread, `disarm` from the loop's."""

    def __init__(self):
        self._cv = threading.Condition(threading.Lock())
        self.armed = None
        self.fired = 0

    def start(self):
        th.Thread(target=self._run, daemon=True).start()

    def _run(self):
        while True:
            self.fired = self.fired + 1  # expect: BA501
            with self._cv:
                self.armed = None

    def disarm(self):
        self.fired = 0
        self.armed = None  # expect: BA501


class GraphReplayer:
    """No Thread() call names `on_capture`: a callback table fires it,
    so the annotation supplies the entry."""

    def __init__(self):
        self.graphs = 0

    def on_capture(self, graph):  # ba-lint: thread-entry
        self.graphs = self.graphs + 1  # expect: BA501
        return graph

    def reset(self):
        self.graphs = 0


class Dispatcher:
    """Negative: every cross-context write holds the same lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self.cohorts = 0
        self.event = torch.zeros(1)

    def start(self):
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        with self._lock:
            self.cohorts = self.cohorts + 1

    def stop(self):
        with self._lock:
            self.cohorts = 0


class Heartbeat:
    """Suppression demo: one GIL-atomic store, waived by name."""

    def __init__(self):
        self.beat = 0.0

    def arm(self):
        th.Thread(target=self._tick, daemon=True).start()

    def _tick(self):
        self.beat = 1.0  # ba-lint: disable=BA501 (one store, read once a wake)

    def poke(self):
        self.beat = 2.0
