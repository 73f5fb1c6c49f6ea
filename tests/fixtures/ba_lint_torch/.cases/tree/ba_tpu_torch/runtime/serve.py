"""BA301 fixture: a host-tier module at module level (the serving
front end): function-local engine imports are the lazy seam."""

from ba_tpu_torch.parallel import driver  # expect: BA301


def dispatch(state):
    from ba_tpu_torch.parallel.pipeline import megastep
    return megastep(state, None), driver
