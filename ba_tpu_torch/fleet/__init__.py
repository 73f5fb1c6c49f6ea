"""The elastic fleet tier (counterpart of ``ba_tpu.fleet``): replicated
serving, consistent-hash routing, serve-drain live migration.

- :mod:`ba_tpu_torch.fleet.replica`: ``FleetConfig`` / ``Replica`` /
  ``ReplicaManager``: N in-process ``AgreementService`` replicas with
  their own registries, ring entry behind the warm barrier, campaign
  lanes and the crash-consistent campaign ledger.
- :mod:`ba_tpu_torch.fleet.router`: ``HashRing`` / ``FleetRouter`` /
  ``RoutedTicket``: cohort-keyed consistent-hash routing, bounded
  overload hops that carry the origin's ``retry_after_s``, rerouting off
  a dead replica, ``autoscale_signal`` consumption.
- :mod:`ba_tpu_torch.fleet.migrate`: ``drain`` / handoff headers /
  ``adopt_orphans``: fingerprint-checked live migration over the one
  carry-checkpoint format.

Quickstart::

    from ba_tpu_torch.fleet import FleetConfig, FleetRouter, ReplicaManager
    from ba_tpu_torch.runtime.serve import AgreementRequest, ServeConfig

    mgr = ReplicaManager(FleetConfig(replicas=2, root="fleet/"),
                         serve_config=ServeConfig(warm=True))
    mgr.start()                      # boot + warm barrier a replica
    router = FleetRouter(mgr)
    t = router.submit(AgreementRequest(kind="run-rounds", rounds=8))
    out = t.result(timeout=60)       # survives a replica's death or drain
    mgr.drain("replica-0")           # live-migrates its campaigns
    mgr.stop()

Importing this package loads no torch: the engine is reached only inside
a replica's campaign lane and its service's dispatcher.
"""

from ba_tpu_torch.fleet.migrate import (
    DrainStop,
    HandoffRefused,
    adopt_orphans,
    drain,
    read_handoff,
    resume_handoff,
    verify_handoff,
    write_handoff,
)
from ba_tpu_torch.fleet.replica import (
    REPLICA_STATES,
    CampaignHandle,
    CampaignSpec,
    FleetConfig,
    Replica,
    ReplicaManager,
    read_ledger,
)
from ba_tpu_torch.fleet.router import FleetRouter, HashRing, RoutedTicket

__all__ = [
    "REPLICA_STATES",
    "CampaignHandle",
    "CampaignSpec",
    "DrainStop",
    "FleetConfig",
    "FleetRouter",
    "HandoffRefused",
    "HashRing",
    "Replica",
    "ReplicaManager",
    "RoutedTicket",
    "adopt_orphans",
    "drain",
    "read_handoff",
    "read_ledger",
    "resume_handoff",
    "verify_handoff",
    "write_handoff",
]
