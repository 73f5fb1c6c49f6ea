"""Run identity (``ba_tpu/obs/flight.py``): the id that joins a campaign's
records, checkpoints and resumes.

Every campaign run gets one ``run_id``: the caller's, the one a resume
checkpoint's header carries, or one derived from the campaign's identity
(the round count, the key data's bytes, the scenario's content), so a
killed run's successor derives the same id without any handshake.  The
JAX package's ``BA_TPU_RUN_ID`` variable is the ``run_id=`` keyword
here, and there is no active run scope yet.  Stdlib only.
"""

from __future__ import annotations

import hashlib
import re

# Leading alnum, then alnum / ._:- up to 64 characters: ids survive file
# names, metric labels and shell quoting.
RUN_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._:-]{0,63}$")


def valid_run_id(run_id) -> bool:
    return isinstance(run_id, str) and bool(RUN_ID_RE.match(run_id))


def derive_run_id(*material) -> str:
    """``run-<sha256[:16]>`` over the campaign identity material: ``bytes``
    (or a ``memoryview`` of them) hash raw, anything else its ``str()``,
    each followed by a NUL."""
    h = hashlib.sha256()
    for m in material:
        h.update(m if isinstance(m, (bytes, memoryview)) else str(m).encode())
        h.update(b"\x00")
    return "run-" + h.hexdigest()[:16]


def resolve_run_id(*material, run_id: str | None = None, inherited: str | None = None,
                   material_fn=None) -> str:
    """The run id a campaign uses, by precedence:

    1. ``run_id``, the caller's (validated: a malformed id raises);
    2. ``inherited``, the id a resume checkpoint's header carries, when
       it is well formed;
    3. :func:`derive_run_id` over ``material`` and then ``material_fn()``
       (a zero-argument callable, so the key fetch and the scenario's
       hashing are paid only when this step runs).
    """
    if run_id is not None:
        if not valid_run_id(run_id):
            raise ValueError(f"run_id={run_id!r} is not a valid run id "
                             f"(want {RUN_ID_RE.pattern})")
        return run_id
    if inherited is not None and valid_run_id(inherited):
        return inherited
    if material_fn is not None:
        material = material + tuple(material_fn())
    return derive_run_id(*material)
