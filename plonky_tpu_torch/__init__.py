"""plonky_tpu_torch: the PLONK + Halo prover and verifier on PyTorch, with
hand-written CUDA kernels for the H100 (csrc/).

The layout mirrors the JAX package plonky_tpu module for module (fields/,
curves/, poly/, hashing/, circuit/, protocol/).  Entry points run on the
card unless the caller passes device="cpu"; kernels are built with nvcc at
their first use on a CUDA tensor (see _cuda.py).
"""
