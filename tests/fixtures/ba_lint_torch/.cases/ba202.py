"""BA202 fixture: a threefry key drawn from twice (parsed, never run)."""

import torch

import ba_tpu_torch.core.rng as keys_mod
from ba_tpu_torch.core import rng
from ba_tpu_torch.core.rng import coin_bits as cb


def positive_plain_reuse(key):
    a = rng.coin_bits(key, (2,))
    b = rng.bits(key, (2,))  # expect: BA202
    return a, b


def positive_through_aliases(key):
    a = keys_mod.uniform_u8(key, (4,))
    b = cb(key, (4,))  # expect: BA202
    return a, b


def positive_loop_invariant(key):
    acc = []
    for _ in range(8):
        acc.append(rng.coin_words(key, 16))  # expect: BA202
    return acc


def positive_after_derive_then_double(key):
    k = rng.fold_in(key, 7)
    a = rng.randint(k, (3,), 0, 10)
    b = rng.uniform(k, (16,))  # expect: BA202
    return a, b


def positive_derive_does_not_decorrelate(key):
    a = rng.coin_bits(key, (4,))
    k1, k2 = rng.split(key)
    b = rng.coin_bits(key, (4,))  # expect: BA202
    return a, b, k1, k2


def positive_keyword_key(key, gate):
    a = rng.or_coin_threshold8(k_cnt=key, gate=gate)
    b = rng.or_coin_threshold8(key, gate)  # expect: BA202
    return a, b


def negative_split_between(key):
    a = rng.coin_bits(key, (2,))
    k1, k2 = rng.split(key)
    return a, rng.bits(k1, (2,)), rng.bits(k2, (2,))


def negative_inline_derivation(key):
    a = rng.coin_bits(rng.fold_in(key, 0), (2,))
    b = rng.coin_bits(rng.fold_in(key, 1), (2,))
    return a, b


def negative_rebound(key):
    a = rng.coin_bits(key, (2,))
    key = rng.fold_in(key, 1)
    b = rng.coin_bits(key, (2,))
    return a, b


def negative_branches(key, flag):
    if flag:
        return rng.coin_bits(key, (2,))
    return rng.uniform(key, (2,))


def negative_generator_is_stateful(seed):
    # A torch.Generator advances on every draw: the rule leaves it alone.
    gen = torch.Generator().manual_seed(seed)
    a = torch.randint(0, 2, (4,), generator=gen)
    b = torch.randint(0, 2, (4,), generator=gen)
    return a, b


def negative_lambda_is_opaque(key):
    fns = [lambda k=key: rng.bits(k, (1,))]
    return fns, rng.bits(key, (2,))


def suppressed_same_coins_twice(key):
    a = rng.coin_bits(key, (4,))
    b = rng.coin_bits(key, (4,))  # ba-lint: disable=BA202 (two engines, one stream)
    return a, b
