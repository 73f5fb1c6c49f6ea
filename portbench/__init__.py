"""The benchmark of the PyTorch and CUDA port (``ba_tpu_torch``): see README.md."""
