"""Device meshes, sharded values and the per-shard runner
(``ba_tpu/parallel/mesh.py``, with what ``jax.sharding`` and
``shard_map`` give the reference).

- :class:`Mesh`: an array of ``torch.device`` entries shaped by the axis
  sizes, with the axis names (default ``("data", "node")``).  An entry may
  name a device more than once (``make_mesh(devices=[cpu] * 8)``, or
  ``[cuda:0] * d``): the counterpart of the reference's forced virtual
  CPU devices.  A mesh that spans processes (``multihost``) also holds
  the process group, every entry's owning rank, and so this rank's block.
- :class:`Sharded`: a global tensor held as one piece per mesh entry this
  process owns, each piece the slice its :class:`P` spec gives that entry
  (a dimension named by an axis splits evenly over it; any other is
  whole, so replicated along the axes the spec does not name).  The
  engine passes it where the reference passes a global ``jax.Array``;
  :meth:`Sharded.gather` (and ``np.asarray``) assembles the global value,
  across processes through the group.
- :func:`shard_map`: runs a per-shard function once for every entry this
  process owns, each call given its entry's pieces and its
  :func:`axis_index` for every axis.  Inside it :func:`psum` and
  :func:`all_gather` combine the calls' tensors over an axis: within a
  process by summing or concatenating on the first entry's device; across
  processes (the "data" axis of a mesh with a group) by
  ``torch.distributed.all_reduce`` / ``all_gather`` on that group, on the
  current stream, so neither adds a host sync.  A body that uses them
  runs one thread an entry, meeting at a barrier for each collective;
  the threads take turns between collectives (one holds a token while it
  runs), so the entries' working sets are never live together: a mesh
  of d entries of one card runs a batch d times wider than one call
  could hold.

The reference's ``cached_jit`` has no counterpart: nothing is traced or
compiled here, so there is no program to memoize.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np
import torch

from ba_tpu_torch.core.state import SimState, resolve_device

DEFAULT_AXES = ("data", "node")


class P(tuple):
    """A partition spec: one mesh axis name (or None) per dimension;
    dimensions past the spec's length are whole."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


class Mesh:
    """Devices shaped by the axis sizes.  ``shape`` maps each axis name to
    its size, as ``jax.sharding.Mesh.shape`` does.  ``owners`` (the rank
    of each entry), ``rank`` and ``group`` describe a mesh across
    processes; a mesh of one process owns every entry and has no group."""

    def __init__(self, devices, axis_names=DEFAULT_AXES, *, owners=None, rank: int = 0,
                 group=None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes {self.axis_names}")
        self.shape = dict(zip(self.axis_names, (int(s) for s in devices.shape)))
        self.owners = np.zeros(devices.shape, np.int64) if owners is None else owners
        self.rank = rank
        self.group = group
        self.local_positions = [pos for pos in np.ndindex(devices.shape)
                                if self.owners[pos] == rank]

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis(self, name: str) -> int:
        if name not in self.shape:
            raise ValueError(f"mesh axes {self.axis_names} carry no {name!r} axis")
        return self.axis_names.index(name)

    def device(self, pos) -> torch.device:
        return self.devices[tuple(pos)]

    def crosses_processes(self, axis_name: str) -> bool:
        """True when collectives over ``axis_name`` go through the group:
        the first axis ("data") of a mesh built over a process group."""
        return self.group is not None and self.axis(axis_name) == 0


def make_mesh(shape: tuple | None = None, axis_names: tuple = DEFAULT_AXES,
              devices=None) -> Mesh:
    """A mesh over ``devices`` (default: the visible CUDA devices; with no
    card it raises, as every entry point does).

    Default shape: every device on the first axis ("data") and the rest
    of size 1.  ``devices`` may repeat a device: ``[torch.device("cpu")] *
    8`` is the CPU tests' 8-entry mesh, ``[cuda:0] * d`` a d-entry mesh of
    one card.  A request for more entries than ``devices`` holds raises
    ``ValueError`` naming both counts.
    """
    if devices is None:
        resolve_device(None)  # raises without a card
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} names {len(shape)} axis(es) but "
                         f"axis_names {tuple(axis_names)} has {len(axis_names)}")
    n_dev = int(np.prod(shape))
    if min(shape) < 1:
        raise ValueError(f"mesh shape {shape} must be all-positive")
    if n_dev > len(devices):
        raise ValueError(f"mesh shape {shape} needs {n_dev} device(s) but only "
                         f"{len(devices)} are available — shrink the shape or pass "
                         f"devices= with more entries (an entry may repeat a device)")
    arr = np.empty(shape, dtype=object)
    for i, pos in enumerate(np.ndindex(shape)):
        arr[pos] = devices[i]
    return Mesh(arr, axis_names)


def _spec_axes(mesh: Mesh, spec, ndim: int) -> list:
    axes = list(spec) + [None] * (ndim - len(spec))
    if len(axes) != ndim:
        raise ValueError(f"spec {tuple(spec)} is longer than the value's {ndim} dimension(s)")
    for a in axes:
        if a is not None:
            mesh.axis(a)
    return axes


def _block(mesh: Mesh, axes: list, shape, pos) -> tuple:
    """The global slices held by the entry at ``pos``."""
    out = []
    for dim, a in zip(shape, axes):
        if a is None:
            out.append(slice(0, dim))
        else:
            size = dim // mesh.shape[a]
            start = pos[mesh.axis(a)] * size
            out.append(slice(start, start + size))
    return tuple(out)


class Sharded:
    """A global value held as per-entry pieces (see the module docstring).
    ``pieces`` maps each mesh position this process owns to its tensor,
    on that position's device."""

    def __init__(self, mesh: Mesh, spec, shape, pieces: dict):
        self.mesh = mesh
        self.shape = tuple(int(s) for s in shape)
        self.spec = P(*_spec_axes(mesh, spec, len(self.shape)))
        self.pieces = pieces

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.pieces.values())).dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def device(self) -> torch.device:
        return next(iter(self.pieces.values())).device

    @property
    def is_cuda(self) -> bool:
        return self.device.type == "cuda"

    def block(self, pos) -> tuple:
        return _block(self.mesh, list(self.spec), self.shape, pos)

    def map(self, fn) -> "Sharded":
        """``fn`` applied to every piece (it must keep the piece's shape)."""
        return Sharded(self.mesh, self.spec, self.shape,
                       {pos: fn(t) for pos, t in self.pieces.items()})

    def __getitem__(self, index: int) -> "Sharded":
        """An integer index into a leading dimension no axis splits."""
        if not isinstance(index, int) or self.spec[0] is not None:
            raise TypeError("a Sharded value takes an int index on an unsplit leading axis")
        return Sharded(self.mesh, self.spec[1:], self.shape[1:],
                       {pos: t[index] for pos, t in self.pieces.items()})

    def _process_box(self, rank: int) -> tuple:
        """The global slices of every entry ``rank`` owns (a box: ranks own
        contiguous runs of the first axis)."""
        blocks = [self.block(pos) for pos in np.ndindex(self.mesh.devices.shape)
                  if self.mesh.owners[pos] == rank]
        return tuple(slice(min(b[d].start for b in blocks), max(b[d].stop for b in blocks))
                     for d in range(self.ndim))

    def gather(self, device=None) -> torch.Tensor:
        """The global value as one tensor on ``device`` (default: the first
        piece's device).  A mesh across processes all-gathers each rank's
        block through the group, so every rank must call it, in the same
        order."""
        device = self.device if device is None else torch.device(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for pos, t in self.pieces.items():
            out[self.block(pos)] = t.to(device)
        group = self.mesh.group
        if group is None:
            return out
        import torch.distributed as dist

        world = dist.get_world_size(group)
        boxes = [self._process_box(r) for r in range(world)]
        via = (self.mesh.device(self.mesh.local_positions[0])
               if dist.get_backend(group) == "nccl" else torch.device("cpu"))
        mine = out[boxes[self.mesh.rank]].to(via).contiguous()
        parts = [torch.empty_like(mine) for _ in range(world)]
        dist.all_gather(parts, mine, group=group)
        for box, part in zip(boxes, parts):
            out[box] = part.to(device)
        return out

    def __array__(self, dtype=None, copy=None):
        a = self.gather(torch.device("cpu")).numpy()
        return a if dtype is None else a.astype(dtype)

    def __repr__(self) -> str:
        return f"Sharded(shape={self.shape}, spec={tuple(self.spec)}, dtype={self.dtype})"


def put_global(mesh: Mesh, x, spec) -> Sharded:
    """``x`` (a tensor or array: every process passes the same full
    value) as a :class:`Sharded` value under ``spec``: each entry this
    process owns keeps a contiguous copy of its slice, on its device (a
    copy, so the engines may update pieces in place).  A Sharded value of
    the same layout comes back as it is; one of another layout is
    gathered first."""
    if isinstance(x, Sharded):
        if x.mesh is mesh and tuple(x.spec) == tuple(_spec_axes(mesh, spec, x.ndim)):
            return x
        x = x.gather()
    t = torch.as_tensor(x)
    axes = _spec_axes(mesh, spec, t.dim())
    for dim, a in zip(t.shape, axes):
        if a is not None and dim % mesh.shape[a]:
            raise ValueError(f"dimension {dim} does not split over the {mesh.shape[a]} "
                             f"entries of mesh axis {a!r}")
    pieces = {}
    for pos in mesh.local_positions:
        piece = t[_block(mesh, axes, t.shape, pos)]
        pieces[pos] = piece.to(mesh.device(pos)).clone(memory_format=torch.contiguous_format)
    return Sharded(mesh, axes, t.shape, pieces)


def tree_map(fn, tree):
    """``tree`` with ``fn`` applied to each tensor and Sharded value:
    dataclasses (SimState, KeySchedule), dicts, tuples and lists are
    walked; anything else (None, numbers) is kept."""
    if isinstance(tree, (torch.Tensor, Sharded)):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(*(tree_map(fn, getattr(tree, f.name))
                            for f in dataclasses.fields(tree)))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def gather_tree(tree, device=None):
    """``tree`` with every Sharded value gathered (on ``device``, where
    given, as every tensor moves there)."""
    return tree_map(lambda x: x.gather(device) if isinstance(x, Sharded)
                    else x if device is None else x.to(device), tree)


def shard_state(mesh: Mesh, state: SimState) -> SimState:
    """A SimState with every plane split on the mesh's "data" axis."""
    return SimState(*(put_global(mesh, t, P("data")) for t in state.tensors()))


# -- the per-shard runner ------------------------------------------------------

_ctx = threading.local()


@dataclasses.dataclass
class _Shard:
    mesh: Mesh
    pos: tuple
    index: int
    meet: "_Rendezvous"


def _current() -> _Shard:
    cur = getattr(_ctx, "shard", None)
    if cur is None:
        raise RuntimeError("axis_index / psum / all_gather run inside a shard_map body")
    return cur


def axis_index(axis_name: str) -> int:
    """This shard's coordinate on ``axis_name``."""
    cur = _current()
    return int(cur.pos[cur.mesh.axis(axis_name)])


class _Rendezvous:
    """The shards of one shard_map call meeting for a collective: each
    posts its operands, the last to arrive combines them (the barrier's
    action), and each reads its own result.  ``token`` lets one shard's
    thread run at a time: it is held between collectives and let go
    while a thread waits at the barrier."""

    def __init__(self, mesh: Mesh, positions: list, threaded: bool):
        self.mesh, self.positions = mesh, positions
        self.posts = [None] * len(positions)
        self.results = [None] * len(positions)
        self.error = None
        self.barrier = threading.Barrier(len(positions), action=self._combine) \
            if threaded else None
        self.token = threading.Lock() if threaded else contextlib.nullcontext()

    def call(self, index: int, op: str, axis_name: str, operands: tuple, dim: int):
        self.posts[index] = (op, axis_name, dim, operands)
        if self.barrier is not None:
            self.token.release()
            try:
                self.barrier.wait()
            finally:
                self.token.acquire()
        elif len(self.positions) > 1:
            raise RuntimeError(f"{op} in a shard_map body declared collectives=False")
        else:
            self._combine()
        return self.results[index]

    def _combine(self):
        try:
            kinds = {post[:3] for post in self.posts}
            if len(kinds) != 1:
                raise RuntimeError(f"shards disagree on the collective: {sorted(kinds)}")
            op, axis_name, dim = kinds.pop()
            a = self.mesh.axis(axis_name)
            groups: dict = {}
            for i, pos in enumerate(self.positions):
                groups.setdefault(pos[:a] + pos[a + 1:], []).append((pos[a], i))
            for key in sorted(groups):
                members = [i for _, i in sorted(groups[key])]
                first = self.posts[members[0]][3]
                dev0 = first[0].device
                combined = []
                for k in range(len(first)):
                    parts = [self.posts[i][3][k].to(dev0) for i in members]
                    if op == "psum":
                        value = parts[0].clone()
                        for p in parts[1:]:
                            value += p
                    else:
                        value = torch.cat(parts, dim=dim)
                    if self.mesh.crosses_processes(axis_name):
                        value = _across_processes(self.mesh, op, value, dim)
                    combined.append(value)
                for i in members:
                    dev = self.mesh.device(self.positions[i])
                    self.results[i] = tuple(c.to(dev) for c in combined)
        except BaseException as e:
            self.error = e
            raise


def _across_processes(mesh: Mesh, op: str, value: torch.Tensor, dim: int) -> torch.Tensor:
    """``value`` reduced (psum) or concatenated in rank order (all_gather)
    over the mesh's group, on the tensor's device and current stream."""
    import torch.distributed as dist

    if op == "psum":
        dist.all_reduce(value, group=mesh.group)
        return value
    parts = [torch.empty_like(value) for _ in range(dist.get_world_size(mesh.group))]
    dist.all_gather(parts, value.contiguous(), group=mesh.group)
    return torch.cat(parts, dim=dim)


def _collective(op: str, x, axis_name: str, dim: int = 0):
    cur = _current()
    single = isinstance(x, torch.Tensor)
    operands = (x,) if single else tuple(x)
    out = cur.meet.call(cur.index, op, axis_name, operands, dim)
    return out[0] if single else type(x)(out)


def psum(x, axis_name: str):
    """The sum of ``x`` (a tensor, or a tuple of tensors) over the shards
    along ``axis_name``, on each shard's device."""
    return _collective("psum", x, axis_name)


def all_gather(x, axis_name: str, *, axis: int = 0):
    """The shards' ``x`` along ``axis_name`` concatenated in axis order on
    dimension ``axis`` (the reference's ``tiled=True`` form)."""
    return _collective("all_gather", x, axis_name, axis)


def _assemble(mesh: Mesh, spec, outs: list):
    """The shards' outputs (one per owned position, the same structure)
    as Sharded values under ``spec`` (a P, or a structure of them)."""
    first = outs[0]
    if first is None:
        return None
    if isinstance(spec, P):
        axes = _spec_axes(mesh, spec, first.dim())
        shape = [s * (mesh.shape[a] if a is not None else 1)
                 for s, a in zip(first.shape, axes)]
        return Sharded(mesh, axes, shape, dict(zip(mesh.local_positions, outs)))
    if dataclasses.is_dataclass(first):
        return type(first)(*(_assemble(mesh, getattr(spec, f.name),
                                        [getattr(o, f.name) for o in outs])
                             for f in dataclasses.fields(first)))
    if isinstance(first, dict):
        return {k: _assemble(mesh, spec[k], [o[k] for o in outs]) for k in first}
    return type(first)(_assemble(mesh, s, [o[i] for o in outs]) for i, s in enumerate(spec))


@contextlib.contextmanager
def _on(dev: torch.device, streams: dict):
    if dev.type != "cuda":
        yield
        return
    with torch.cuda.device(dev), torch.cuda.stream(streams[dev]):
        yield


def shard_map(fn, mesh: Mesh, out_specs, *, collectives: bool = True):
    """``fn`` run once for every mesh entry this process owns.

    The returned callable takes ``fn``'s arguments: a Sharded value passes
    each call its entry's piece, a tensor is passed (on the entry's
    device) to every call, anything else as is; SimState / KeySchedule
    dataclasses, tuples, lists and dicts are walked.  The calls' outputs
    become Sharded values under ``out_specs`` (a P, or the same structure
    as the output), their global shapes grown by the axes each spec
    names.  With ``collectives`` (the default) each call runs on a thread
    of its own, so :func:`psum` / :func:`all_gather` can meet; with
    ``collectives=False`` the calls run in order on the caller's thread.
    """

    def run(*args):
        positions = mesh.local_positions
        threaded = collectives and len(positions) > 1
        meet = _Rendezvous(mesh, positions, threaded)
        streams = {dev: torch.cuda.current_stream(dev)
                   for dev in {mesh.device(p) for p in positions} if dev.type == "cuda"}
        outs = [None] * len(positions)
        errors = [None] * len(positions)

        def body(i):
            pos = positions[i]
            dev = mesh.device(pos)
            prev = getattr(_ctx, "shard", None)
            _ctx.shard = _Shard(mesh, pos, i, meet)
            try:
                with meet.token, _on(dev, streams):
                    outs[i] = fn(*tree_map(lambda x: x.pieces[pos] if isinstance(x, Sharded)
                                           else x.to(dev), args))
            except BaseException as e:
                errors[i] = e
                if meet.barrier is not None:
                    meet.barrier.abort()
                if not threaded:
                    raise
            finally:
                _ctx.shard = prev

        if threaded:
            threads = [threading.Thread(target=body, args=(i,), daemon=True)
                       for i in range(len(positions))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            raised = [e for e in errors if e is not None]
            if meet.error is not None or raised:
                # the first cause, not the broken barrier it left the others at
                raise meet.error or next((e for e in raised if not isinstance(
                    e, threading.BrokenBarrierError)), raised[0])
        else:
            for i in range(len(positions)):
                body(i)
        return _assemble(mesh, out_specs, outs)

    return run


__all__ = [
    "DEFAULT_AXES", "Mesh", "P", "Sharded", "all_gather", "axis_index", "gather_tree",
    "make_mesh", "psum", "put_global", "shard_map", "shard_state", "tree_map",
]
