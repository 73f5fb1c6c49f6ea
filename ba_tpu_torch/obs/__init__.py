"""Observability (counterpart of ``ba_tpu.obs``): run identity."""
