"""Port-side parameter trees for the JAX references of the port's tests.

Random trees are built with the port's own init (milliseconds) and carried
over to the JAX package by `to_jax`, the inverse of
`wan2gp_tpu_torch.convert.params_from_numpy`: the JAX inits, jitted or
not, take seconds (the Wan VAE's about 12 s on one CPU core)."""
import jax.numpy as jnp
import numpy as np
import torch


def to_jax(tree, key=None):
    """Port tree -> JAX tree: conv kernels back to channels-last
    ([Cout, Cin, k...] -> [k..., Cin, Cout]), every other leaf as it is."""
    if isinstance(tree, dict):
        return {k: to_jax(v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_jax(v) for v in tree)
    if tree is None:
        return None
    t = tree.detach().cpu()
    if key == "w" and t.ndim == 5:
        t = t.permute(2, 3, 4, 1, 0)
    elif key == "w" and t.ndim == 4:
        t = t.permute(2, 3, 1, 0)
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(np.ascontiguousarray(t.numpy()))
