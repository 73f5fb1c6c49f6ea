"""BA301 fixture: the graph cache captures K1 itself (the rule's
OBS_DEVICE_SEAMS table): function-local engine imports are its seam,
module-level ones are still findings."""

from ba_tpu_torch.core import pure  # expect: BA301


def build_entry():
    from ba_tpu_torch.ops import kernel
    return kernel, pure
