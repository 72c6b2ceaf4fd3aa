"""PyTorch/CUDA port of the serving engine.

A second package beside ``production_stack_tpu`` (the JAX reference):
the same module tree and names, PyTorch in place of JAX, and the
Pallas TPU kernels rewritten by hand in CUDA C++ for Hopper
(``csrc/``). It imports nothing of the JAX package.
"""
