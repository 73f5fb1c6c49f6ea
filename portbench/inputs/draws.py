"""Everything a run draws, in separate streams of a seed.

The base key holds all of the seed's bits (``threefry.seed_key``).  Stream
0 of a configuration's ``instances_seed`` draws its cluster states, the
same in every run.  Of ``--seed``: stream 1 a key for each campaign,
stream 2 the kill planes, stream 3 the signed key-set's seed, stream 4 the
fused steps' seeds, stream 5 the samples the comparison checks and stream
6 the value whose signature a traitorous commander spoils.  The same seed
gives the same inputs on any run.
"""

from __future__ import annotations

import torch

from portbench.reference import threefry as tf

STATES, CAMPAIGNS, KILLS, KEYSET, STEP_SEEDS, SAMPLES, SPOILED = range(7)


def stream_key(seed: int, stream: int) -> tuple:
    return tf.threefry_py(tf.seed_key(seed), stream)


def stream_int(seed: int, stream: int, index: int = 0) -> int:
    """A 32-bit whole number of ``stream``, e.g. a generator's seed."""
    return tf.threefry_py(stream_key(seed, stream), index)[1]


def key_tensor(key: tuple, device) -> torch.Tensor:
    return torch.tensor(key, dtype=torch.int64, device=device)


def instances_key(config: dict, device) -> torch.Tensor:
    """The key a configuration's cluster states are drawn from."""
    return key_tensor(stream_key(config["instances_seed"], STATES), device)


def campaign_keys(seed: int, count: int, device) -> torch.Tensor:
    """int64 ``[count, 2]`` on ``device``: campaign c's key, the program's
    key data (two uint32 words)."""
    base = key_tensor(stream_key(seed, CAMPAIGNS), device)
    return tf.fold_in(base[None, :], torch.arange(count, device=device)).contiguous()


def step_seeds(mix: torch.Tensor, campaign_key_row: torch.Tensor, steps: int,
               buckets: int) -> torch.Tensor:
    """int32 ``[steps, buckets]`` on the key's device: the low word of
    ``threefry(campaign key ^ mix, (0, step * buckets + bucket))``, as
    int32, where ``mix`` is :func:`step_seed_mix`.  One derivation a
    campaign, on the device, with no copy from the host."""
    k = campaign_key_row ^ mix
    words = tf.fold_in(k[None, :], torch.arange(steps * buckets, device=k.device))[:, 1]
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32).reshape(steps, buckets)


def step_seed_mix(seed: int, device) -> torch.Tensor:
    """The key the fused steps' seeds are mixed with: made once, on the
    device, since a copy from pageable host memory waits for the stream."""
    return key_tensor(stream_key(seed, STEP_SEEDS), device)


def step_seed_py(seed: int, campaign_key: tuple, step: int, bucket: int, buckets: int) -> int:
    """:func:`step_seeds`' entry on Python ints, for the reference."""
    mix = stream_key(seed, STEP_SEEDS)
    k = (campaign_key[0] ^ mix[0], campaign_key[1] ^ mix[1])
    return tf.threefry_py(k, step * buckets + bucket)[1]


def kill_planes(seed: int, count: int, rounds: int, batch: int, n: int, p_kill: float,
                leader_dies_before: int, device) -> list[torch.Tensor]:
    """``count`` kill schedules ``[rounds, batch, n]`` bool on ``device``:
    each general dies with probability ``p_kill`` a round, and every
    instance's leader (slot 0) before round ``leader_dies_before``.  Drawn
    by a generator on the device, one call a plane."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_int(seed, KILLS))
    planes = []
    for _ in range(count):
        plane = torch.rand((rounds, batch, n), generator=gen, device=device) < p_kill
        plane[leader_dies_before, :, 0] = True
        planes.append(plane)
    return planes


def spoiled_value(seed: int, instance: int) -> int:
    """The value (0 RETREAT, 1 ATTACK) whose signature instance
    ``instance``'s traitorous commander spoils."""
    return stream_int(seed, SPOILED, instance) & 1


def sample_generator(seed: int) -> torch.Generator:
    """A CPU generator for the samples the comparison draws."""
    gen = torch.Generator()
    gen.manual_seed(stream_int(seed, SAMPLES))
    return gen


def retained(seed: int, campaign: int, every: int) -> bool:
    """Whether the run keeps campaign ``campaign``'s outputs for the
    comparison: campaign 0, and about one in ``every`` after it, by the
    seed."""
    return campaign == 0 or stream_int(seed, SAMPLES, campaign + 1) % every == 0
