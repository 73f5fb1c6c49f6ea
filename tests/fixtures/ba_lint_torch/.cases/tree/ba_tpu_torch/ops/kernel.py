"""BA301 fixture: contamination through the device tree.  This module
never names obs, but it imports ``core.impure``, a device-tree module
whose closure reaches it."""

from ba_tpu_torch.core.impure import positive_emit_through_alias  # expect: BA301

from ba_tpu_torch.core.pure import quorum_threshold


def launch(x):
    return positive_emit_through_alias(x) + quorum_threshold(x)
