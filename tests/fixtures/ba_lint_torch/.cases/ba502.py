"""BA502 fixture: the lock-free read discipline of a health sampler
(parsed, never run).  The own-line declaration below puts the module
under it."""

# ba-lint: lockfree

import threading

_LOCK = threading.Lock()
INSTRUMENTS = {"pipeline_dispatches_total": 0}


class Sampler:
    def __init__(self):
        self.samples = 0
        self.last = {}

    def sample(self, registry):
        self.samples += 1  # expect: BA502
        with _LOCK:  # expect: BA502
            pass
        _LOCK.acquire()  # expect: BA502
        for name in self.last:  # expect: BA502
            _ = name
        for _k, _v in INSTRUMENTS.items():  # expect: BA502
            pass
        snapshot = dict(INSTRUMENTS)
        for name in snapshot:  # negative: a local copy
            _ = name
        for i in (1, 2, 3):  # negative: a literal
            _ = i
        return registry.get("pipeline_dispatches_total"), self.samples  # negative: loads

    def waived(self):
        self.samples += 1  # ba-lint: disable=BA502 (only the sampler's thread writes it)
