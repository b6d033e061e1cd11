"""teku-tpu's device half on PyTorch and CUDA (NVIDIA Hopper, sm_90a).

A port of ``teku_tpu``'s BLS12-381 batch verification: the plain
PyTorch fp381 engine under ``ops/`` mirrors the JAX package's limb
arithmetic, and hand-written CUDA kernels under ``ops/kernels/`` run
the staged verify pipeline on the card.  The package imports torch,
numpy and the standard library only; entry points take an explicit
``device`` (default ``"cuda"``).
"""
