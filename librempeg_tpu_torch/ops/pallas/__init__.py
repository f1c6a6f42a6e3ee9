"""Ports of the JAX package's ops/pallas kernels (CUDA on the card)."""
