"""Ops of the port: norms, rope, attention and int8 matmul (with kernels)."""
