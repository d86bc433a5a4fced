"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package's
``repro.models.moe`` on the same numpy inputs and fp32 weights (reduced
configs, CPU): y and the aux loss at rtol = atol = 2e-3
(tests/test_models.py:111), the keep mask exactly; the grouping with its
ragged tail, capacity drops and the capacity formula."""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the machine with the card has no JAX

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402

TOL = dict(rtol=2e-3, atol=2e-3)


def _jax_keep(p, cfg, x):
    """JAX's keep mask: the routing steps of repro/models/moe.py:41-61, which
    ``moe_mlp`` computes but does not return."""
    b, s, d = x.shape
    tokens = x.reshape(b * s, d)
    n = tokens.shape[0]
    gl = min(cfg.moe_group, n)
    n_groups = max(1, n // gl)
    gl = n // n_groups
    xt = tokens[: n_groups * gl].reshape(n_groups, gl, d)
    probs = jax.nn.softmax(jnp.einsum("gtd,de->gte", xt.astype(jnp.float32), p["router"]), -1)
    _, gate_idx = jax.lax.top_k(probs, cfg.top_k)
    onehot = jax.nn.one_hot(gate_idx, cfg.n_experts, dtype=jnp.float32)
    flatoh = onehot.reshape(n_groups, gl * cfg.top_k, cfg.n_experts)
    pos_in_e = (jnp.cumsum(flatoh, axis=1) - flatoh).reshape(onehot.shape)
    return np.asarray(jnp.sum(pos_in_e * onehot, axis=-1) < jmoe._capacity(cfg, gl))


def _inputs(arch, b, s, shared, seed=1, moe_group=None):
    """Reduced configs of both packages, JAX-initialised fp32 MoE params as
    numpy, and x = 0.5 N(0, 1) + ``shared`` x one vector common to every
    token: the shared part makes tokens pick the same experts, so that
    queues overflow and pairs drop."""
    jcfg, cfg = jget(arch).reduced(), get_config(arch).reduced()
    if moe_group:
        jcfg, cfg = replace(jcfg, moe_group=moe_group), replace(cfg, moe_group=moe_group)
    p = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32))
    r = np.random.default_rng(seed)
    x = 0.5 * r.standard_normal((b, s, cfg.d_model)) + shared * r.standard_normal(cfg.d_model)
    return jcfg, cfg, p, x.astype(np.float32)


# (arch, b, s, shared, dtype of x, what the case shows)
CASES = [
    ("dbrx-132b", 2, 64, 0.0, "float32", "swiglu, two groups of 64"),
    ("grok-1-314b", 2, 64, 0.0, "float32", "geglu with gelu"),
    ("dbrx-132b", 1, 131, 0.0, "float32", "ragged tail: 2 groups of 65 + 1 token"),
    ("dbrx-132b", 2, 64, 1.0, "float32", "capacity drops"),
    ("grok-1-314b", 1, 131, 1.0, "float32", "drops and a ragged tail"),
    ("dbrx-132b", 2, 64, 0.0, "bfloat16", "bf16 input, fp32 weights"),
]


@pytest.mark.parametrize("arch,b,s,shared,dtype,what", CASES, ids=[c[-1] for c in CASES])
def test_moe_mlp_matches_jax(arch, b, s, shared, dtype, what):
    jcfg, cfg, p, x = _inputs(arch, b, s, shared)
    jx = jnp.asarray(x).astype(dtype)
    want_y, want_aux = jmoe.moe_mlp(jax.tree.map(jnp.asarray, p), jcfg, jx)
    tx = bridge.params_from_numpy(np.asarray(jx), device="cpu")
    y, aux, keep = moe.moe_mlp(bridge.params_from_numpy(p, device="cpu"), cfg, tx)
    assert y.shape == x.shape and str(y.dtype) == f"torch.{want_y.dtype}"
    np.testing.assert_allclose(y.float().numpy(), np.asarray(want_y, np.float32), **TOL)
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    want_keep = _jax_keep(jax.tree.map(jnp.asarray, p), jcfg, jx)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    n = b * s
    gl = n // max(1, n // min(cfg.moe_group, n))
    assert keep.shape == (n // gl, gl, cfg.top_k)
    if shared:
        assert (~keep).sum() > 0, "the case should drop pairs"
    tail = n - keep.shape[0] * gl
    if tail:  # the tail is not routed: its tokens come out as they went in
        assert torch.equal(y.reshape(n, -1)[-tail:], tx.reshape(n, -1)[-tail:].to(y.dtype))


def test_dropped_pairs_lose_their_gate():
    """A token whose every pair is dropped gets y = 0; one that keeps a pair
    does not."""
    _, cfg, p, x = _inputs("dbrx-132b", 1, 64, shared=1.0)
    y, _, keep = moe.moe_mlp(bridge.params_from_numpy(p, device="cpu"), cfg,
                             torch.from_numpy(x))
    none_kept = ~keep[0].any(-1)
    assert none_kept.any()
    assert torch.equal(y[0][none_kept], torch.zeros_like(y[0][none_kept]))
    assert bool((y[0][~none_kept].abs().amax(-1) > 0).all())


@pytest.mark.parametrize("arch", ["dbrx-132b", "grok-1-314b"])
def test_capacity_matches_jax(arch):
    for jcfg, cfg in ((jget(arch), get_config(arch)),
                      (jget(arch).reduced(), get_config(arch).reduced())):
        for gl in (1, 2, 3, 4, 5, 8, 13, 32, 64, 65, 320, 1000, 1024):
            assert moe._capacity(cfg, gl) == jmoe._capacity(jcfg, gl)
    cfg = get_config(arch)
    assert moe._capacity(cfg, 1) == 4  # at least 4, even past the group's length


def test_moe_capacity_drops_are_bounded():
    """The twin of tests/test_models.py:148 on the port's own init: with
    capacity factor 1.25, most tokens route (few drops on random data) and
    the aux loss is near 1 for a balanced router."""
    cfg = get_config("dbrx-132b").reduced()
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(gen, (), cfg, torch.float32, "cpu")
    assert p["router"].shape == (cfg.d_model, cfg.n_experts)
    assert p["w_in"].shape == p["w_gate"].shape == (cfg.n_experts, cfg.d_model, cfg.d_ff)
    x = 0.1 * torch.randn((2, 64, cfg.d_model), generator=gen)
    y, aux, keep = moe.moe_mlp(p, cfg, x)
    assert y.shape == x.shape
    assert bool(torch.isfinite(y).all())
    assert 0.5 < float(aux) < 4.0
    assert float(keep.float().mean()) > 0.9


def test_router_stays_fp32():
    cfg = get_config("grok-1-314b").reduced()
    p = moe.init_moe(torch.Generator().manual_seed(0), (3,), cfg, torch.bfloat16, "cpu")
    assert p["router"].dtype == torch.float32 and p["router"].shape == (3, cfg.d_model, 4)
    assert p["w_out"].dtype == torch.bfloat16
    assert p["w_out"].shape == (3, cfg.n_experts, cfg.d_ff, cfg.d_model)
