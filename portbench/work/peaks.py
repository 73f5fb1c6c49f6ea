"""The card's peaks, fixed from NVIDIA's H100 SXM data sheet.

Integer pipe: 132 SMs x 64 int32 results a clock x 1 980 MHz (the boost
clock), 1.67e13 instructions/s.  HBM3: 3.35e12 bytes/s.  Both assume the
full 700 W power limit; a run prints the card's own limit beside its
shares.
"""

SMS = 132
INT32_LANES_PER_SM = 64
BOOST_CLOCK_HZ = 1.98e9
INT_OPS_PER_S = SMS * INT32_LANES_PER_SM * BOOST_CLOCK_HZ
HBM_BYTES_PER_S = 3.35e12


def bound_s(int_ops: float, nbytes: float) -> tuple[float, str]:
    """(the least seconds the card could take, "operations" or "bytes")."""
    ops_s, bytes_s = int_ops / INT_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"
