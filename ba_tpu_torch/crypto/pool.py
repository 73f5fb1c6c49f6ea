"""Host-crypto pool and signature-table cache (``ba_tpu/crypto/pool.py``).

- :class:`SignPool` — N worker processes (``python -m
  ba_tpu_torch.crypto.pool``, length-prefixed pickles over their stdin /
  stdout) that shard the sign-ahead lane's table signing and host
  verifying.  Work splits into contiguous index ranges and results
  reassemble by index; Ed25519 is deterministic, so no worker count,
  shard order or completion order changes an output byte.  A dead or
  hung worker (broken pipe, EOF, a reply past ``timeout_s``, an error
  reply) is killed and retired, :attr:`SignPool.degraded` counts it,
  and its shard runs in-process instead.
- **cross-process spans**: ``sign_rounds`` and ``verify_rows`` take
  ``traceparent=``, which rides each task as a trailing element; after
  each reply a worker emits one ``pool_task`` record parented under it,
  into its own ``<pid>.<token>.jsonl`` shard of the parent's sink
  directory.  The parent hands that directory to its workers (in the
  start check, and again whenever the live sink's directory changes); a
  sink that is not a directory is not handed over, and the workers then
  emit nothing.  A worker never writes into the parent's shard.
- :class:`SigTableCache` — a bounded LRU over per-round signature
  tables and their host verdicts, keyed by a hash of the key-set's
  public keys and the round's message table: identical claims re-sign
  to identical bytes, so a hit is bit-identical to a recompute.

A worker imports this module and ``crypto/tables.py`` (numpy, the
stdlib and the native signer), never torch, so it starts in a fraction
of a second.  The reference's ``BA_TPU_SIGN_POOL``,
``BA_TPU_SIGN_POOL_TIMEOUT_S``, ``BA_TPU_SIGN_CACHE`` and
``BA_TPU_SIGN_CACHE_BYTES`` are the keywords ``SignPool(workers=,
timeout_s=)`` and ``SigTableCache(max_entries=, max_bytes=)``; the
process defaults are what the reference derives with those unset, or
what :func:`configure_defaults` sets.
"""

from __future__ import annotations

import atexit
import hashlib
import io
import os
import pickle
import selectors
import struct
import subprocess
import sys
import threading
import time
from collections import OrderedDict

import numpy as np

from ba_tpu_torch.utils import metrics as _metrics

_LEN = struct.Struct("<Q")

# Generous by design: the timeout keeps a hung worker from wedging a
# dispatch forever; a worker that trips it is killed and its shard re-runs
# in-process.
DEFAULT_TIMEOUT_S = 120.0
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def default_workers() -> int:
    """The default worker count: the cores less the one the lane itself
    occupies, capped at 8 (more workers than cores only adds scheduler
    churn); 0, the in-process path, on one core."""
    return max(0, min(8, (os.cpu_count() or 1) - 1))


def _sink_dir() -> str | None:
    """The live sink's target when it is a directory, else None."""
    target = _metrics.default_sink().target
    return target if _metrics.is_dir_target(target) else None


def _send(fh, obj) -> None:
    blob = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    fh.write(_LEN.pack(len(blob)))
    fh.write(blob)
    fh.flush()


def _read_exact(fh, size: int) -> bytes:
    """Read exactly ``size`` bytes (a raw pipe may return short reads)."""
    buf = io.BytesIO()
    remaining = size
    while remaining:
        chunk = fh.read(min(remaining, 1 << 20))
        if not chunk:
            raise EOFError("pool worker closed its pipe mid-frame")
        buf.write(chunk)
        remaining -= len(chunk)
    return buf.getvalue()


def _recv(fh):
    (size,) = _LEN.unpack(_read_exact(fh, _LEN.size))
    return pickle.loads(_read_exact(fh, size))


def _worker_main() -> None:  # pragma: no cover - runs in the workers
    """A worker's task loop over stdin / stdout, one task at a time (a
    reply is written before the next task is read).  Keys derive in the
    worker from the (seed, batch, values) identity, deterministic
    ``commander_keys``, so no key material crosses the pipe; each
    key-set's key rows are kept for the worker's life.  A ``sink`` task
    (no reply) points the worker's own sink at the parent's directory, or
    turns it off; after each ``ok`` reply to a sign or verify task, with
    the sink on, the worker emits one ``pool_task`` record."""
    from ba_tpu_torch.crypto import tables

    stdin, stdout = sys.stdin.buffer, sys.stdout.buffer
    keysets: dict = {}

    def keys_for(seed: int, batch: int, n_values: int):
        ident = (seed, batch, n_values)
        if ident not in keysets:
            sks, pks = tables.commander_keys(batch, seed)
            keysets[ident] = tables.key_table_arrays(sks, pks, n_values)
        return keysets[ident]

    while True:
        try:
            task = _recv(stdin)
        except EOFError:
            return
        kind = task[0]
        if kind == "exit":
            return
        if kind == "sink":
            _metrics.configure(task[1])
            continue
        t0 = time.perf_counter()
        rows = 0
        traceparent = None
        try:
            if kind == "ping":  # the start check: the signer loads here
                _metrics.configure(task[1] if len(task) > 1 else None)
                tables.native.publickey_batch(np.zeros((1, 32), np.uint8))
                reply = ("ok", os.getpid())
            elif kind == "sign":
                seed, batch, n_values, base, rounds = task[1:6]
                # the staging window's position, a trailing element
                traceparent = task[6] if len(task) > 6 else None
                sk_rep, pk_rep = keys_for(seed, batch, n_values)
                sigs = np.empty((len(rounds), batch, n_values, 64), np.uint8)
                for i, r in enumerate(rounds):
                    msgs = tables._round_table_msgs(batch, r, n_values, base)
                    sigs[i] = tables.sign_table_msgs_arrays(sk_rep, pk_rep, msgs)
                rows = len(rounds)
                reply = ("ok", sigs)
            elif kind == "verify":
                traceparent = task[4] if len(task) > 4 else None
                rows = int(task[2].shape[0])
                reply = ("ok", tables.verify_host_exact(*task[1:4]))
            else:
                reply = ("err", f"unknown task kind {kind!r}")
        except Exception as exc:  # noqa: BLE001 - a worker must answer
            reply = ("err", f"{type(exc).__name__}: {exc}")
        wall_s = time.perf_counter() - t0
        _send(stdout, reply)
        if reply[0] == "ok" and kind != "ping" and _metrics.default_sink().enabled:
            # after the reply, so the record never sits on the parent's read
            rec = {"event": "pool_task", "v": _metrics.SCHEMA_VERSION, "kind": kind,
                   "rows": rows, "wall_s": round(wall_s, 6), "t_perf": round(t0, 6)}
            parsed = _metrics.parse_traceparent(traceparent)
            if parsed is not None:
                rec["trace_id"] = parsed[0]
                rec["span_id"] = _metrics.new_span_id()
                rec["parent_id"] = parsed[1]
            _metrics.emit(rec)


class _Worker:
    __slots__ = ("proc", "alive")

    def __init__(self, proc: subprocess.Popen):
        self.proc = proc
        self.alive = True


class SignPool:
    """``workers`` signing / verifying processes with deterministic
    sharding (``workers=None``: :func:`default_workers`).

    The degradation ladder never wedges and never changes a byte: a
    healthy worker runs its shard; a dead or hung one (broken pipe, EOF,
    no reply within ``timeout_s``, an error reply) is killed and retired,
    :attr:`degraded` counts it, and its shard re-runs in-process through
    the same bodies the worker calls; with every worker dead the pool is
    the in-process path for the rest of its life.  Starting is not a
    rung: each worker must answer a first task that loads the native
    signer within ``timeout_s``, or the pool is closed and raises."""

    def __init__(self, workers: int | None = None, *, timeout_s: float | None = None):
        if workers is None:
            workers = default_workers()
        if workers < 0:
            raise ValueError(f"workers={workers} must be >= 0")
        self.requested = workers
        self.degraded = 0
        self.pool_s = 0.0
        self.shards = 0
        self._lock = threading.Lock()
        self._timeout_s = DEFAULT_TIMEOUT_S if timeout_s is None else float(timeout_s)
        self._workers: list[_Worker] = []
        if workers:
            from ba_tpu_torch import native

            native.build()  # once here, not raced by the workers
        for _ in range(workers):
            self._workers.append(_Worker(self._spawn()))
        self._sink = _sink_dir()  # the directory the workers were handed
        started = self._round_trip([(w, ("ping", self._sink), None) for w in self._workers],
                                   lambda _: None)
        if self.degraded or None in started:
            self.close()
            raise RuntimeError(f"{self.degraded} of {workers} sign pool worker(s) did not "
                               f"start (python -m ba_tpu_torch.crypto.pool)")
        self.pool_s = 0.0
        self.shards = 0

    # -- lifecycle ----------------------------------------------------------

    @staticmethod
    def _spawn() -> subprocess.Popen:
        """One worker: ``python -m ba_tpu_torch.crypto.pool`` from the
        package's root, so an uninstalled checkout resolves; it inherits
        this process's environment.  Unbuffered pipes on this side: the
        reply wait polls the raw fd, and a buffered reader's read-ahead
        would hold a frame the poll cannot see."""
        return subprocess.Popen(
            [sys.executable, "-m", "ba_tpu_torch.crypto.pool"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, bufsize=0, cwd=PACKAGE_ROOT,
        )

    @property
    def workers(self) -> int:
        """Live workers (a dead one retires for good)."""
        return sum(1 for w in self._workers if w.alive)

    def close(self) -> None:
        """Ask every live worker to exit, then reap them (killed after 5 s)
        and close their pipes.  Idempotent; the pool is the in-process
        path afterwards."""
        for w in self._workers:
            if not w.alive:
                continue
            try:
                _send(w.proc.stdin, ("exit",))
            except (BrokenPipeError, OSError, ValueError):
                pass
            w.alive = False
        for w in self._workers:
            try:
                w.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                w.proc.kill()
                w.proc.wait()
            for pipe in (w.proc.stdin, w.proc.stdout):
                try:
                    pipe.close()
                except OSError:  # a broken pipe's buffered bytes
                    pass

    def __del__(self):  # pragma: no cover - depends on collection order
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass

    # -- the deterministic shard round trip ---------------------------------

    def _kill(self, w: _Worker) -> None:
        w.alive = False
        self.degraded += 1
        try:
            w.proc.kill()
        except OSError:
            pass

    def _round_trip(self, assignments, fallback):
        """One task a live worker, all written and then all read (a worker
        holds at most one task, so neither side blocks on a full pipe).
        ``assignments`` is ``[(worker, task, shard_args)]``; a failed
        shard runs ``fallback(shard_args)``.  Results in assignment
        order."""
        t0 = time.perf_counter()
        sent = []
        for w, task, shard_args in assignments:
            ok = False
            if w.alive:
                try:
                    _send(w.proc.stdin, task)
                    ok = True
                except (BrokenPipeError, OSError, ValueError):
                    self._kill(w)
            sent.append((w, ok, shard_args))
        results = []
        deadline = time.perf_counter() + self._timeout_s
        for w, ok, shard_args in sent:
            reply = None
            if ok:
                try:
                    with selectors.DefaultSelector() as sel:
                        sel.register(w.proc.stdout, selectors.EVENT_READ)
                        if not sel.select(timeout=max(0.0, deadline - time.perf_counter())):
                            raise TimeoutError("pool worker reply timeout")
                    reply = _recv(w.proc.stdout)
                except (EOFError, OSError, TimeoutError, ValueError):
                    self._kill(w)
                    reply = None
            if reply is not None and reply[0] == "ok":
                results.append(reply[1])
            else:
                if reply is not None:  # the worker's own error
                    self._kill(w)
                results.append(fallback(shard_args))
        with self._lock:
            self.pool_s += time.perf_counter() - t0
            self.shards += len(assignments)
        return results

    def _live(self) -> list[_Worker]:
        """The live workers, each pointed at the live sink's directory (a
        ``sink`` task to every live worker when it changed)."""
        target = _sink_dir()
        if target != self._sink:
            for w in self._workers:
                if w.alive:
                    try:
                        _send(w.proc.stdin, ("sink", target))
                    except (BrokenPipeError, OSError, ValueError):
                        self._kill(w)
            self._sink = target
        return [w for w in self._workers if w.alive]

    @staticmethod
    def _split(n: int, parts: int) -> list[tuple[int, int]]:
        """Contiguous ranges covering [0, n): the boundaries depend on
        (n, parts) only, never on scheduling."""
        parts = max(1, min(parts, n))
        step, extra = divmod(n, parts)
        spans, lo = [], 0
        for i in range(parts):
            hi = lo + step + (1 if i < extra else 0)
            spans.append((lo, hi))
            lo = hi
        return spans

    def sign_rounds(self, seed: int, batch: int, n_values: int, base: int, rounds: list[int],
                    fallback, traceparent: str | None = None) -> np.ndarray:
        """The round tables of ``rounds`` across the workers -> sigs uint8
        [len(rounds), batch, n_values, 64], reassembled by round.
        ``fallback(rounds_slice)`` is the in-process body; ``traceparent``
        rides each task, the parent of the workers' ``pool_task`` spans."""
        live = self._live()
        if not rounds:
            return np.empty((0, batch, n_values, 64), np.uint8)
        if not live:
            return fallback(rounds)
        assignments = [
            (live[i], ("sign", seed, batch, n_values, base, rounds[lo:hi], traceparent),
             rounds[lo:hi])
            for i, (lo, hi) in enumerate(self._split(len(rounds), len(live)))
        ]
        parts = self._round_trip(assignments, lambda rs: np.asarray(fallback(rs), np.uint8))
        return np.concatenate([np.asarray(p, np.uint8) for p in parts])

    def verify_rows(self, pks: np.ndarray, msgs: np.ndarray, sigs: np.ndarray,
                    traceparent: str | None = None) -> np.ndarray:
        """A flattened [N, ...] exact verify across the workers -> bool
        [N, n], reassembled by row; a failed shard verifies in-process.
        ``traceparent`` as in :meth:`sign_rounds`."""
        from ba_tpu_torch.crypto.tables import verify_host_exact

        pks = np.ascontiguousarray(pks, np.uint8)
        msgs = np.ascontiguousarray(msgs, np.uint8)
        sigs = np.ascontiguousarray(sigs, np.uint8)
        live = self._live()
        if not live:
            return verify_host_exact(pks, msgs, sigs)
        assignments = [
            (live[i], ("verify", pks[lo:hi], msgs[lo:hi], sigs[lo:hi], traceparent), (lo, hi))
            for i, (lo, hi) in enumerate(self._split(msgs.shape[0], len(live)))
        ]
        parts = self._round_trip(
            assignments,
            lambda span: verify_host_exact(pks[span[0]:span[1]], msgs[span[0]:span[1]],
                                           sigs[span[0]:span[1]]),
        )
        return np.concatenate([np.asarray(p, np.bool_) for p in parts])


class SigTableCache:
    """A bounded LRU over per-round signature tables.

    An entry is one round's ``(sigs [B, V, 64], host verdicts [B, V] or
    None)`` under :meth:`round_key`, a hash of the public inputs that
    determine them: the key-set's public keys and the round's message
    table (which binds instance base, round and values).  Verdicts are
    kept only where they were computed on the host (the native verifier
    or the pool); the device route keeps signatures alone, and
    ``None`` tells the lane to verify again.  Bounded by ``max_entries``
    entries and ``max_bytes`` of tables, evicting least-recently-used
    first when either trips.  Thread-safe."""

    def __init__(self, max_entries: int = 256, max_bytes: int = 128 << 20):
        if max_entries < 1:
            raise ValueError(f"max_entries={max_entries} must be >= 1")
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.nbytes = 0
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()

    @staticmethod
    def round_key(pks: np.ndarray, msgs: np.ndarray) -> bytes:
        """sha256 over the public keys' and the messages' shapes and
        bytes: everything that determines the entry, and nothing else."""
        h = hashlib.sha256()
        h.update(repr(pks.shape).encode())
        h.update(np.ascontiguousarray(pks).tobytes())
        h.update(repr(msgs.shape).encode())
        h.update(np.ascontiguousarray(msgs).tobytes())
        return h.digest()

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: bytes):
        """-> (sigs, ok or None), or None; a hit refreshes the entry."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return entry

    @staticmethod
    def _nbytes(sigs, ok) -> int:
        return sigs.nbytes + (ok.nbytes if ok is not None else 0)

    def put(self, key: bytes, sigs: np.ndarray, ok: np.ndarray | None) -> None:
        with self._lock:
            if key in self._entries:
                self.nbytes -= self._nbytes(*self._entries.pop(key))
            self._entries[key] = (sigs, ok)
            self.nbytes += self._nbytes(sigs, ok)
            while self._entries and (len(self._entries) > self.max_entries
                                     or self.nbytes > self.max_bytes):
                _, old = self._entries.popitem(last=False)
                self.nbytes -= self._nbytes(*old)
                self.evictions += 1


# -- process defaults ----------------------------------------------------------

_default_pool: SignPool | None = None
_default_pool_made = False
_default_cache: SigTableCache | None = None
_default_cache_made = False
_defaults_lock = threading.Lock()
_workers_setting: int | None = None  # None: default_workers()
_cache_setting = True


def configure_defaults(*, workers: int | None = None, cache: bool = True) -> None:
    """What the process defaults are made of from here on: ``workers``
    for the default pool (None: :func:`default_workers`; 0: none, the
    in-process path), ``cache=False`` for no default cache
    (:func:`default_cache` returns None).  The reference's
    ``BA_TPU_SIGN_POOL`` and ``BA_TPU_SIGN_CACHE=0``.  Drops the current
    defaults (:func:`shutdown_defaults`), so the next use makes them
    anew."""
    global _workers_setting, _cache_setting
    if workers is not None and workers < 0:
        raise ValueError(f"workers={workers} must be >= 0")
    shutdown_defaults()
    with _defaults_lock:
        _workers_setting = workers
        _cache_setting = bool(cache)


def default_pool() -> SignPool | None:
    """The process-wide pool of :func:`default_workers` workers (or as
    :func:`configure_defaults` set; None when that is 0: the in-process
    path), made at first use and closed at the interpreter's exit."""
    global _default_pool, _default_pool_made
    with _defaults_lock:
        if not _default_pool_made:
            n = default_workers() if _workers_setting is None else _workers_setting
            _default_pool = SignPool(n) if n else None
            _default_pool_made = True
        return _default_pool


def default_cache() -> SigTableCache | None:
    """The process-wide signature-table cache (256 entries, 128 MiB);
    None after ``configure_defaults(cache=False)``."""
    global _default_cache, _default_cache_made
    with _defaults_lock:
        if not _default_cache_made:
            _default_cache = SigTableCache() if _cache_setting else None
            _default_cache_made = True
        return _default_cache


def close_default_pool() -> None:
    """Drain the default pool; the cache keeps its entries.  A later
    :func:`default_pool` starts a new one."""
    global _default_pool, _default_pool_made
    with _defaults_lock:
        if _default_pool is not None:
            _default_pool.close()
        _default_pool = None
        _default_pool_made = False


def shutdown_defaults() -> None:
    """Drain the default pool and drop both defaults; the next use makes
    them again."""
    global _default_cache, _default_cache_made
    close_default_pool()
    with _defaults_lock:
        _default_cache = None
        _default_cache_made = False


atexit.register(close_default_pool)


if __name__ == "__main__":  # pragma: no cover - the worker process
    _worker_main()
