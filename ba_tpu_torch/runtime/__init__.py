"""The interactive host shell (``ba_tpu/runtime``): backends, ``Cluster``,
the REPL and its launcher, ``python -m ba_tpu_torch.runtime.main N``."""
