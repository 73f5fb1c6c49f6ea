"""Serve-drain live migration (the port's copy of ``ba_tpu/fleet/migrate.py``):
move in-flight campaigns between replicas through the one carry-checkpoint
format both packages read.

A drain is a move, not an outcome: the draining replica's campaign lanes
stop at their next checkpoint (the supervisor's ``on_checkpoint`` hook,
which fires after the carry checkpoint and its rows sidecar are durable,
raises :class:`DrainStop`), each lane writes a **handoff header** beside
its checkpoint family, and the adopting replica resumes through the
engine's ``resume="auto"``: the ``{round}``-templated family and the
rows-sidecar chain reassemble the whole campaign history, so the migrated
result is bit-identical to the uninterrupted run.  Carry checkpoints hold
no device count, so the source and target may differ in mesh and device.

``DrainStop`` subclasses :class:`BaseException` on purpose: the
supervisor recovers from ``Exception`` (that is its job), and a drain
must pass through it, never spend the recovery budget as a fault.

The handoff header is the migration's trust boundary.  It names the
campaign doc, the checkpoint family, the round cursor, the campaign
fingerprint (``campaign_sha256``) and the ``signed`` flag;
:func:`verify_handoff` re-reads the checkpoint's own header
(``utils/snapshot.validate_carry_checkpoint``) and refuses, with
:class:`HandoffRefused`, a header whose fingerprint or signed flag
contradicts the checkpoint it points at, before any engine work.  A
header written by a ``ba_tpu`` replica verifies and resumes here.

A killed replica writes no handoff.  Its campaigns are recovered by
:func:`adopt_orphans` from its append-only ledger (``replica.py`` writes
it fsync'd): an admitted, unfinished campaign whose newest on-disk
checkpoint validates and matches the ledgered fingerprint is re-run from
its doc, and ``resume="auto"`` checks the fingerprint again.

Importing this module loads no torch (numpy and the stdlib): only the
adopting replica's campaign lane reaches the engine.
"""

from __future__ import annotations

import json
import os

from ba_tpu_torch import obs
from ba_tpu_torch.utils import metrics as _metrics
from ba_tpu_torch.utils import snapshot as _snapshot

HANDOFF_FORMAT = "ba-fleet-handoff"
HANDOFF_VERSION = 1

# The handoff header's required keys (checked by read_handoff).
HANDOFF_KEYS = (
    "format", "v", "campaign", "doc", "template", "round", "rounds",
    "checkpoint", "fingerprint", "signed", "from_replica",
)


class DrainStop(BaseException):
    """Out-of-band drain signal raised from a campaign's checkpoint
    hook (a BaseException on purpose: module docstring)."""

    def __init__(self, round_cursor: int, path: str):
        super().__init__(f"drain at round {round_cursor}: {path}")
        self.round_cursor = round_cursor
        self.path = path


class HandoffRefused(ValueError):
    """The handoff header contradicts the checkpoint it points at (or
    is malformed): the adoption is refused before any engine work."""


def _emit_migration(phase: str, campaign: str, from_replica: str,
                    **fields) -> None:
    _metrics.emit({
        "event": "migration",
        "v": _metrics.SCHEMA_VERSION,
        "phase": phase,
        "campaign": campaign,
        "from_replica": from_replica,
        **fields,
    })


def write_handoff(
    path: str,
    *,
    campaign: str,
    doc: dict,
    template: str,
    round_cursor: int,
    rounds: int,
    checkpoint: str,
    fingerprint: str,
    signed: bool,
    from_replica: str,
    run_id: str | None = None,
    traceparent: str | None = None,
) -> dict:
    """Write the handoff header atomically (temp + ``os.replace`` +
    fsync — the snapshot module's crash discipline) and return it."""
    header = {
        "format": HANDOFF_FORMAT,
        "v": HANDOFF_VERSION,
        "campaign": campaign,
        "doc": dict(doc),
        "template": template,
        "round": int(round_cursor),
        "rounds": int(rounds),
        "checkpoint": checkpoint,
        "fingerprint": fingerprint,
        "signed": bool(signed),
        "from_replica": from_replica,
    }
    if run_id is not None:
        header["run_id"] = run_id
    if traceparent is not None:
        header["traceparent"] = traceparent
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(header, f, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return header


def read_handoff(path: str) -> dict:
    """Load and shape-check a handoff header (format/version/keys);
    raises :class:`HandoffRefused` on anything malformed."""
    try:
        with open(path, encoding="utf-8") as f:
            header = json.load(f)
    except (OSError, ValueError) as e:
        raise HandoffRefused(f"unreadable handoff {path}: {e}") from e
    if not isinstance(header, dict):
        raise HandoffRefused(f"handoff {path} is not an object")
    if header.get("format") != HANDOFF_FORMAT:
        raise HandoffRefused(
            f"handoff {path}: format {header.get('format')!r} != "
            f"{HANDOFF_FORMAT!r}"
        )
    if header.get("v") != HANDOFF_VERSION:
        raise HandoffRefused(
            f"handoff {path}: version {header.get('v')!r} != "
            f"{HANDOFF_VERSION}"
        )
    missing = [k for k in HANDOFF_KEYS if k not in header]
    if missing:
        raise HandoffRefused(f"handoff {path}: missing keys {missing}")
    return header


def verify_handoff(header: dict) -> dict:
    """The adoption-side trust check: validate the checkpoint the
    header points at and refuse any contradiction.  Returns the
    checkpoint's meta.

    - the checkpoint must pass full schema and digest validation
      (``validate_carry_checkpoint``, numpy and the stdlib);
    - the header's ``fingerprint`` must equal the checkpoint meta's
      ``campaign_sha256`` (a handoff cannot point a resume at a
      FOREIGN campaign family);
    - the header's ``signed`` flag must equal the checkpoint meta's
      ``signed`` flag — the cross-protocol refusal: a forged header
      cannot splice an unsigned carry into a signed campaign's resume
      (protocol semantics travel WITH the carry, never the header).
    """
    path = header["checkpoint"]
    try:
        meta = _snapshot.validate_carry_checkpoint(path)
    except (OSError, ValueError) as e:
        raise HandoffRefused(
            f"handoff checkpoint {path} failed validation: {e}"
        ) from e
    fp = meta.get("campaign_sha256")
    if fp != header["fingerprint"]:
        raise HandoffRefused(
            f"handoff fingerprint {header['fingerprint']!r} != "
            f"checkpoint campaign_sha256 {fp!r} ({path})"
        )
    if bool(meta.get("signed")) != bool(header["signed"]):
        raise HandoffRefused(
            f"cross-protocol handoff refused: header signed="
            f"{bool(header['signed'])} but checkpoint {path} carries "
            f"signed={bool(meta.get('signed'))}"
        )
    return meta


def drain(replica, *, timeout_s: float | None = None) -> list:
    """Serve-drain one live replica: stop every campaign lane at its
    next checkpoint, close serving admission (queued requests re-home
    through the router's :class:`ServeError` reroute path), and write one
    handoff header per in-flight campaign.

    Returns the handoff header paths.  A replica with ZERO in-flight
    campaigns drains to the empty list as a strict no-op: no handoff
    files, no checkpoint files, nothing to adopt (the edge the tests
    pin — an empty drain must not litter the fleet root with empty
    state someone later mistakes for a campaign).
    """
    replica.set_state("draining")
    _emit_migration(
        "drain_start", "", replica.name,
        campaigns=len(replica.campaigns()),
    )
    # The lanes are told first, so that they stop at their next checkpoint
    # while the dispatcher retires its cohort in flight (a long cohort
    # would otherwise let a short campaign run to its end).
    replica.stop_lanes()
    rehomed = replica.service.handoff(timeout=timeout_s)
    obs.instant(
        "fleet_drain", replica=replica.name, rehomed=len(rehomed)
    )
    paths = replica.drain_campaigns(timeout_s=timeout_s)
    replica.set_state("stopped")
    replica.service.stop(drain=False, timeout=timeout_s)
    return paths


def resume_handoff(path: str, replica, *, verify: bool = True):
    """Adopt one handed-off campaign on ``replica``: read + verify the
    header, rebuild the campaign from its doc and resume through the
    supervisor's ``resume="auto"`` (which re-verifies the fingerprint
    against the family a second time).  Returns the campaign handle."""
    header = read_handoff(path)
    if verify:
        verify_handoff(header)
    from ba_tpu_torch.fleet.replica import CampaignSpec

    spec = CampaignSpec.from_doc(header["doc"])
    _emit_migration(
        "resume", spec.campaign, header["from_replica"],
        to_replica=replica.name, round=header["round"],
        run_id=header.get("run_id"),
    )
    return replica.run_campaign(spec)


def adopt_orphans(fleet_root: str, dead_replica: str, replica) -> list:
    """Recover a SIGKILLed replica's campaigns from its ledger: every
    admitted-but-unfinished campaign whose newest on-disk checkpoint
    validates and matches the ledgered ``campaign_sha256`` is resumed
    on ``replica`` (adoption BY FINGERPRINT — a stray family squatting
    on the template path is skipped, never spliced).  A campaign that
    died before its first checkpoint restarts from round 0 (nothing to
    verify; ``resume="auto"`` finds no family and starts fresh).

    Returns the adopted campaign handles.
    """
    from ba_tpu_torch.fleet.replica import CampaignSpec, read_ledger

    handles = []
    for entry in read_ledger(fleet_root, dead_replica):
        if entry["status"] != "orphaned":
            continue
        spec = CampaignSpec.from_doc(entry["doc"])
        fp = entry.get("fingerprint")
        if fp is not None:
            found = _snapshot.newest_valid_checkpoint(
                entry["template"],
                quarantine=False,
                below=spec.rounds,
                accept=lambda meta, _fp=fp: (
                    meta.get("campaign_sha256") == _fp
                ),
            )
            if found is None:
                # Checkpoints ledgered but none survive validation +
                # fingerprint match: refuse the adoption rather than
                # resume an unverifiable family.
                _emit_migration(
                    "adopt_refused", spec.campaign, dead_replica,
                    to_replica=replica.name,
                )
                continue
        _emit_migration(
            "adopt", spec.campaign, dead_replica,
            to_replica=replica.name,
            verified=fp is not None,
        )
        handles.append(replica.run_campaign(spec))
    return handles
