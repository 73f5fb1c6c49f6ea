"""BA504 fixture: leaked timers and unjoined threads around a dispatch
(parsed, never run)."""

import threading


def dispatch_with_orphan_watchdog(run):
    watchdog = threading.Timer(1.0, print)  # expect: BA504
    watchdog.start()
    return run()


def chained_start():
    threading.Timer(0.5, print).start()  # expect: BA504


def dispatch_with_watchdog(run):
    watchdog = threading.Timer(1.0, print)
    watchdog.daemon = True
    watchdog.start()
    try:
        return run()
    finally:
        watchdog.cancel()


def unarmed_timer():
    return threading.Timer(1.0, print)  # negative: never started here


class KeepsTimer:
    def arm(self):
        self._t = threading.Timer(1.0, print)  # expect: BA504
        self._t.start()


class CancelsTimer:
    def arm(self):
        self._t = threading.Timer(1.0, print)
        self._t.start()

    def close(self):
        self._t.cancel()


def unjoined_hasher():
    t = threading.Thread(target=print)  # expect: BA504
    t.start()


def joined_hasher():
    t = threading.Thread(target=print)
    t.start()
    t.join()


def daemon_thread():
    threading.Thread(target=print, daemon=True).start()


class KeepsThread:
    def start(self):
        self._thr = threading.Thread(target=self._idle)  # expect: BA504
        self._thr.start()

    def _idle(self):
        pass


class JoinsThread:
    def start(self):
        self._thr = threading.Thread(target=self._idle)
        self._thr.start()

    def _idle(self):
        pass

    def stop(self):
        self._thr.join()
