"""BA101 / BA102 fixture, scoped as ba_tpu_torch.parallel.pipeline
(parsed, never run)."""

import numpy as np
import torch
import torch.cuda as tc
from torch.cuda import synchronize as wait_all

from ba_tpu_torch.core import rng
from ba_tpu_torch.core.rng import split as sp


def megastep(state, sched, *, rounds=1):  # ba-lint: donates(state, sched)
    return state, sched, torch.zeros(rounds)


def positive_host_sync(x, event, stream):
    tc.synchronize()  # expect: BA101
    wait_all()  # expect: BA101
    event.synchronize()  # expect: BA101
    stream.synchronize()  # expect: BA101
    v = x.item()  # expect: BA101
    t = x.tolist()  # expect: BA101
    h = x.cpu()  # expect: BA101
    a = h.numpy()  # expect: BA101
    b = x.to("cpu")  # expect: BA101
    c = x.to(device=torch.device("cpu"))  # expect: BA101
    n = int(torch.sum(x))  # expect: BA101
    f = bool(torch.any(x))  # expect: BA101
    return v, t, a, b, c, n, f


def positive_host_keys(key, xs):
    k1, k2 = rng.split(key)  # expect: BA102
    k3 = sp(k2, 3)  # expect: BA102
    out = []
    for i, _x in enumerate(xs):
        out.append(rng.fold_in(key, i))  # expect: BA102
    return k1, k3, out


def negative_staging(x, plane, dev, counter, key):
    # Departure from the reference: numpy conversions stage host data (a
    # CUDA tensor raises in numpy, it cannot drain the queue silently).
    host = np.asarray(plane)
    pinned = torch.empty(3, pin_memory=True).copy_(x, non_blocking=True)
    up = torch.as_tensor(host).to(dev)
    down = x.to("cpu", non_blocking=True)
    n = int(host.sum())
    kr = rng.fold_in(key, counter)
    return pinned, up, down, n, kr


def suppressed_sanctioned_retire(event):
    event.synchronize()  # ba-lint: disable=BA101 (the depth-delayed retire)
