"""PyTorch / CUDA port of ``ba_tpu``: the oral OM(1) pipelined engine, the
signed SM(m) pipelined engine with its sign-ahead lane, and the fused
signed SM(m) sweep.

The package mirrors ``ba_tpu``'s folder layout so each module has an
obvious counterpart.  It imports torch and numpy only — never jax and
nothing from ``ba_tpu`` — and keeps its own copies of the jax-free
pieces it needs (``scenario/spec.py``, ``scenario/compile.py``,
``crypto/oracle.py``, ``native/ed25519.cpp``).

Device rule: entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with the default device and no GPU they raise.
Engines: ``engine="cuda"`` (the hand-written Hopper megastep kernel,
``ops/csrc/megastep.cu``) is the default on a CUDA device;
``engine="torch"`` (the plain scan core) is the default on the CPU and
runs on the card only when asked for.  Kernel wrappers
(``ops/scenario_step.py``, ``ops/sweep_step.py``) run their plain
version on a CPU tensor and launch their kernel, or raise, on a CUDA
tensor.
"""
