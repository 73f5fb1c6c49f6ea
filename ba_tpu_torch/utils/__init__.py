"""Host utilities (counterpart of ``ba_tpu.utils``): durable checkpoints."""
