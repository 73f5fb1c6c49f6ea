"""BA301 fixture: a device-tree module that reaches obs."""

from ba_tpu_torch import obs as quietly_renamed  # expect: BA301 BA401
from ba_tpu_torch.obs.trace import span as sp  # expect: BA301 BA401
from ba_tpu_torch.utils import metrics as m

from ba_tpu_torch.core.pure import quorum_threshold


def positive_emit_through_alias(decision):
    m.emit({"event": "agreement_round", "decision": decision})  # expect: BA301 BA601
    return quorum_threshold(decision)
