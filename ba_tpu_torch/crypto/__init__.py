"""Signed orders and the Ed25519 oracle (``ba_tpu/crypto``: the table part)."""
