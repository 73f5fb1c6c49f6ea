"""BA603 fixture: the port reads no environment; every access in the
package is a finding, whatever the variable (parsed, never run)."""

import os
import os as operating_system
from os import environ as env
from os import getenv

RUN_ID_ENV = "BA_TPU_RUN_ID"


def reads():
    a = os.environ.get("BA_TPU_RUN_ID")  # expect: BA603
    b = operating_system.getenv("HOME")  # expect: BA603
    c = env["PATH"]  # expect: BA603
    d = RUN_ID_ENV in os.environ  # expect: BA603
    e = getenv("BA_TPU_SLO")  # expect: BA603
    return a, b, c, d, e


def passes_it_on():
    return dict(os.environ)  # expect: BA603


def keyword_instead(run_id=None):
    return run_id
