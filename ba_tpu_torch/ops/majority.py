"""K9, the masked strict majority with a fallback (``csrc/majority.cu``),
and its plain torch version.

K9 replaces ``ba_tpu/ops/majority.py::_majority_kernel`` (the Pallas TPU
kernel, through ``masked_majority_rows``): per row, ATTACK / RETREAT
counted over the valid responders, the strict majority (a tie gives
UNDEFINED), and the row's fallback where no responder is valid.  Every
EIG resolve level (``core/eig.py::_resolve_from``) is one call.  Two
forms:

- dense, the reference's contract: answers int8 ``[R, K]``, valid bool
  ``[R, K]``, fallback int8 ``[R]`` -> int8 ``[R]``;
- shared mask: answers ``[G, S, P, K]``, valid ``[G, 1, P, K]`` (one
  mask row for the S receivers of a path, as the resolve's is),
  fallback ``[G, S, P]`` -> ``[G, S, P]``; the kernel reads the mask's
  G P K bytes instead of a broadcast copy's G S P K.

:func:`masked_majority_rows` runs the plain version on a CPU tensor and
launches K9 on a CUDA one, or raises; it keeps a plain integer
``launches`` count.  Rows of K <= 32 go by tiles of 512 consecutive rows
staged in shared memory, longer rows a warp each (``csrc/majority.cu``).
The kernel finds a row's position by 32-bit division, so it takes S and
P below 2^30 and fewer than 2^31 rows (every resolve level of the paths
is far below); ``maj_args`` in the source sets that limit, and the
wrapper raises ValueError for a shape beyond it.
"""

from __future__ import annotations

import ctypes

import torch

from ba_tpu_torch.core.quorum import strict_majority
from ba_tpu_torch.core.types import ATTACK, COMMAND_DTYPE, RETREAT
from ba_tpu_torch.ops import _build

SOURCE = "majority.cu"
UNSUPPORTED = -1  # ba_majority's code for a shape its maj_args refuses


def plain_masked_majority_rows(answers: torch.Tensor, valid: torch.Tensor,
                               fallback: torch.Tensor) -> torch.Tensor:
    """The plain version of K9, the reference's jnp formulation: two masked
    counts, the strict majority, the eligible count, the fallback select
    (either form; the shared mask broadcasts)."""
    n_attack = ((answers == ATTACK) & valid).sum(-1)
    n_retreat = ((answers == RETREAT) & valid).sum(-1)
    resolved = strict_majority(n_attack, n_retreat)
    return torch.where(valid.sum(-1) > 0, resolved, fallback)


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.ba_majority
    if fn.argtypes is None:  # pointers as c_void_p, or ctypes cuts them to 32 bits
        fn.argtypes = ([ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]
                       + [ctypes.c_void_p] * 5)
        fn.restype = ctypes.c_int
    return lib


def _layout(answers, valid, fallback):
    """(G, S, P, K) of either form, or raise."""
    if answers.dim() == 2:
        R, K = answers.shape
        want = ((R, K), (R,))
        G, S, P = 1, 1, R
    elif answers.dim() == 4:
        G, S, P, K = answers.shape
        want = ((G, 1, P, K), (G, S, P))
    else:
        raise ValueError(f"answers must be [R, K] or [G, S, P, K], got {tuple(answers.shape)}")
    if tuple(valid.shape) != want[0] or tuple(fallback.shape) != want[1]:
        raise ValueError(
            f"answers {tuple(answers.shape)} needs valid {want[0]} and fallback {want[1]}, "
            f"got {tuple(valid.shape)} and {tuple(fallback.shape)}")
    if K < 1:
        raise ValueError("a row needs at least one responder slot (K >= 1)")
    return G, S, P, K


def masked_majority_rows(answers: torch.Tensor, valid: torch.Tensor,
                         fallback: torch.Tensor) -> torch.Tensor:
    """Strict majority a row over the valid responders; tie -> UNDEFINED,
    no valid responder -> the fallback.  Dense ``[R, K]`` or shared-mask
    ``[G, S, P, K]`` form (module docstring)."""
    G, S, P, K = _layout(answers, valid, fallback)
    dev = answers.device
    if dev.type == "cpu":
        return plain_masked_majority_rows(answers, valid, fallback)
    if dev.type != "cuda":
        raise ValueError(f"the majority kernel runs on a CUDA device, not {dev}")
    _build.check_tensor(answers, "answers", COMMAND_DTYPE, answers.shape, dev)
    _build.check_tensor(valid, "valid", torch.bool, valid.shape, dev)
    _build.check_tensor(fallback, "fallback", COMMAND_DTYPE, fallback.shape, dev)
    R = G * S * P
    out = torch.empty(fallback.shape, dtype=COMMAND_DTYPE, device=dev)
    err = _lib().ba_majority(R, K, S, P, answers.data_ptr(), valid.data_ptr(),
                             fallback.data_ptr(), out.data_ptr(),
                             torch.cuda.current_stream(dev).cuda_stream)
    if err == UNSUPPORTED:
        raise ValueError(f"the majority kernel does not take S {S}, P {P}, {R} rows "
                         "(csrc/majority.cu maj_args)")
    if err != 0:
        raise RuntimeError(f"majority launch failed: CUDA error {err}")
    if R:
        masked_majority_rows.launches += 1
    return out


masked_majority_rows.launches = 0


def reset_launches() -> None:
    masked_majority_rows.launches = 0
