"""PyTorch port of the Legion reproduction, for one NVIDIA Hopper GPU.

Mirrors the reference package ``repro`` (JAX) module by module; every TPU
kernel on a ported path is a hand-written Hopper kernel under
``kernels/csrc``.  Importing this package imports neither ``jax`` nor
anything of ``repro``.
"""
