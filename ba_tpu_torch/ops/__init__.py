"""Hand-written Hopper kernels and their wrappers (counterpart of ``ba_tpu.ops``).

Exported as the reference exports them (``ba_tpu/ops/__init__.py:53-63``):
``ladder_scalar_mult`` (K3'', ``ladder.scalar_mult``),
``masked_majority_rows`` (K9) and ``fused_signed_sweep_step`` (K2).  The
reference's fourth export, ``fused_sharded_sweep_step`` (K2 over a device
mesh), waits for the port's multi-GPU slice (ROADMAP Queue 1 item 5).
"""

from ba_tpu_torch.ops.ladder import scalar_mult as ladder_scalar_mult
from ba_tpu_torch.ops.majority import masked_majority_rows
from ba_tpu_torch.ops.sweep_step import fused_signed_sweep_step

__all__ = [
    "ladder_scalar_mult",
    "masked_majority_rows",
    "fused_signed_sweep_step",
]
