"""BA201 fixture: a carry read after a megastep updated it in place
(parsed by ba-lint, never run)."""

import torch


def megastep(state, sched, *, rounds=1):  # ba-lint: donates(state, sched)
    state.alive.mul_(1)
    sched.counter.add_(rounds)
    return state, sched, torch.zeros(rounds, 3)


def named_step(x, buf):  # ba-lint: donates(buf)
    buf.add_(x)
    return buf


def fresh_copy(tree):
    return tree


def positive_read_after_update(state, sched):
    out = megastep(state, sched, rounds=4)
    return state.alive.sum(), out  # expect: BA201


def positive_second_arg(state, sched):
    out = megastep(state, sched)
    counter = sched.counter  # expect: BA201
    return out, counter


def positive_kwarg_by_name(x, buf):
    y = named_step(x, buf=buf)
    return y, buf  # expect: BA201


def positive_loop_carried(state, sched):
    hists = []
    for _ in range(4):
        out = megastep(state, sched)  # expect: BA201
        hists.append(out[2])
        # `state` is updated above and never rebound: the next
        # iteration starts from a carry it did not thread through.
    return hists


def annotated_with_typo(state, sched):  # ba-lint: donates(stat)  # expect: BA201
    return state


def negative_rethread(state, sched):
    state, sched, hist = megastep(state, sched)
    return state.alive.sum(), sched.counter, hist


def negative_copy_before(state, sched):
    kept = fresh_copy(state)
    state, sched, hist = megastep(state, sched)
    return kept, state, hist


def negative_branch_isolated(state, sched, flag):
    if flag:
        state, sched, _ = megastep(state, sched)
    return state.alive.sum()


def negative_boolop_short_circuit(state, sched, flag):
    _ = flag and megastep(state, sched)
    return state.alive.sum()


def negative_read_before(state, sched):
    shape = state.alive.shape
    out = megastep(state, sched)
    return shape, out


def suppressed_contract(state, sched):
    out = megastep(state, sched)
    return out[0] is state, out  # ba-lint: disable=BA201 (pins the in-place contract)
