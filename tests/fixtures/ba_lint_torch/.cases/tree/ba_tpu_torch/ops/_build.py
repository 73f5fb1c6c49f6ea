"""BA301 fixture: the build-and-load helper is host tier although it
sits in ops/ (the rule's HOST_IN_DEVICE_TREE table): obs may call it,
and it imports no device module."""

import ctypes
import subprocess


def ensure(source):
    subprocess.run(["nvcc", source], check=False)
    return ctypes.CDLL

