"""Shared set-up of the parity tests between the JAX package and the port:
JAX-initialised fp32 weights as numpy, with every norm scale perturbed (they
are initialised to zeros, which would leave the ``1 + scale`` untested)."""
import jax
import jax.numpy as jnp
import numpy as np

from repro.models import transformer as jtf


def _perturb(tree, rng, noise):
    if isinstance(tree, dict):
        return {k: (v + noise * rng.standard_normal(v.shape).astype(v.dtype)
                    if k.endswith("norm") else _perturb(v, rng, noise))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_perturb(v, rng, noise) for v in tree]
    return tree


def numpy_params(cfg, seed, noise=0.1, out_scale=1.0):
    """JAX init_params as numpy, norms perturbed; ``out_scale`` multiplies the
    output projections of every layer (attention ``wo`` and MLP ``w_out``,
    or rwkv time-mix ``Wo`` and channel-mix ``cm_Wv``), so that layers, not
    the embedding, decide greedy tokens."""
    params = jax.tree.map(np.asarray, jtf.init_params(cfg, jax.random.PRNGKey(seed),
                                                      jnp.float32))
    params = _perturb(params, np.random.default_rng(seed), noise)
    outputs = (("tm", "Wo"), ("tm", "cm_Wv")) if cfg.family == "ssm" else (
        ("attn", "wo"), ("mlp", "w_out"))
    for blk in params["blocks"]:
        for part, name in outputs:
            blk[part][name] = blk[part][name] * np.float32(out_scale)
    return params


def jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)
