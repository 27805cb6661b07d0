"""PyTorch/CUDA port of the boundless-tpu segment STARK prover.

Mirrors the layout of `boundless_tpu/` (core, air, prover, zkvm) and adds
`kernels/` (Python wrappers) plus `csrc/` (hand-written CUDA for Hopper).
Field elements are `torch.int32` tensors in [0, P), Montgomery form with
R = 2^32 — the same words as the JAX package's uint32 arrays. This
package imports `torch` and never `jax`.
"""
