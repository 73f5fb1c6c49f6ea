"""BA301 fixture: the strict obs direction.  Reading the kernels'
ptxas records through ops/_build is allowed (host tier); importing the
device trees is not, not even inside a function."""

from ba_tpu_torch.utils import metrics as _metrics


def library_record(source):
    from ba_tpu_torch.ops import _build
    _metrics.emit({"event": "compiled_artifact", "v": 1, "fn": source, "axes": {},
                   "flops": 0, "bytes_accessed": 0})
    return _build.ensure(source)


def positive_lazy_device_import():
    from ba_tpu_torch.ops.kernel import launch  # expect: BA301
    return launch
