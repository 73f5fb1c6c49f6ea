"""BA603 fixture, the negative half: this module is neither in the
port's package nor ``chip_smoke.py`` (a test or a script may set the
reference's knobs and pass an environment on), so nothing here is a
finding (parsed, never run)."""

import os


def subprocess_env():
    return dict(os.environ, JAX_PLATFORMS="cpu")


def reference_knob():
    return os.environ.get("BA_TPU_SIGN_POOL", "")
