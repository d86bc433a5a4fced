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
    output projections of every layer (attention ``wo``, MLP and MoE
    ``w_out``, rwkv time-mix ``Wo`` and channel-mix ``cm_Wv``, mamba
    ``w_out``, and the shared blocks' ``wo`` and ``w_out``), so that layers,
    not the embedding, decide greedy tokens."""
    params = jax.tree.map(np.asarray, jtf.init_params(cfg, jax.random.PRNGKey(seed),
                                                      jnp.float32))
    params = _perturb(params, np.random.default_rng(seed), noise)
    outputs = {"tm": ("Wo", "cm_Wv"), "attn": ("wo",), "mlp": ("w_out",),
               "moe": ("w_out",), "mamba": ("w_out",)}
    # the hybrid stack's shared_attn blocks are {} in "blocks"; their layers
    # are the "shared" list
    for layer in params["blocks"] + params.get("shared", []):
        for part in outputs.keys() & layer.keys():
            for name in outputs[part]:
                layer[part][name] = layer[part][name] * np.float32(out_scale)
    return params


def jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)
