"""The port's optimizers (``repro_torch.runtime.optimizer``) against the JAX
package's on the same numpy trees and gradients: AdamW with fp32 and bf16
moments and Adafactor, one update and several, the learning-rate schedule,
the global norm; and the twins of ``TestOptimizer``
(tests/test_runtime.py:29-85)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the machine with the card has no JAX

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.runtime import optimizer as jopt  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.runtime import optimizer as opt  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


def _tree(seed):
    """A nested tree of dicts and a list, leaves of 0 to 3 dimensions."""
    r = np.random.default_rng(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"w": f(4, 3), "b": f(3), "blocks": [{"x": f(2, 5, 3)}, {"x": f(2, 5, 3)}],
            "s": f()}


def _to_torch(tree):
    return bridge.params_from_numpy(tree, device="cpu")


def _np(tree):
    """A tree's leaves, from either package, as fp32 numpy in JAX's order."""
    if isinstance(tree_leaves(tree)[0], torch.Tensor):
        tree = bridge.params_to_numpy(tree)
    return [np.asarray(a).astype(np.float32) for a in jax.tree.leaves(tree)]


def _close(got, want, rtol, atol):
    ga, wa = _np(got), _np(want)
    assert len(ga) == len(wa)
    for a, b in zip(ga, wa):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


# fp32 elementwise math in the same order on the same inputs: a few ulps
TIGHT = dict(rtol=2e-6, atol=1e-7)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("steps", [1, 5])
def test_adamw_matches_jax(moment_dtype, steps):
    """AdamW over ``steps`` updates on the same gradients (scaled so the
    global norm passes ``grad_clip`` on some steps): params, moments, step,
    lr and grad norm. fp32 moments at a few ulps; bf16 moments within one
    bf16 ulp (2^-8 relative: an fp32 moment an ulp apart can round to the
    neighbouring bf16 value) and params, which read those moments back, at
    lr x 1e-2."""
    jc = jopt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                          moment_dtype=getattr(jnp, moment_dtype))
    tc = opt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                         moment_dtype=getattr(torch, moment_dtype))
    params = _tree(0)
    jp, tp = jax.tree.map(jnp.asarray, params), _to_torch(params)
    js, ts = jopt.adamw_init(jc, jp), opt.adamw_init(tc, tp)
    for i in range(steps):
        g = jax.tree.map(lambda a, i=i: a * np.float32(0.3 * (i + 1)), _tree(100 + i))
        jp, js, jm = jopt.adamw_update(jc, jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts, tm = opt.adamw_update(tc, _to_torch(g), ts, tp)
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == int(js["step"]) == steps
    assert all(x.dtype == getattr(torch, moment_dtype) for x in tree_leaves(ts["m"]))
    if moment_dtype == "float32":
        for got, want in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
            _close(got, want, **TIGHT)
    else:
        for got, want in ((ts["m"], js["m"]), (ts["v"], js["v"])):
            _close(got, want, rtol=2 ** -8, atol=1e-30)
        _close(tp, jp, rtol=0, atol=1e-4)


@pytest.mark.parametrize("steps", [1, 5])
def test_adafactor_matches_jax(steps):
    """Adafactor: factored ``vr`` / ``vc`` for the 2-d and 3-d leaves, the
    full ``v`` for the others, RMS clipping; the same state tree as JAX's."""
    jc, tc = jopt.AdafactorConfig(lr=0.05, weight_decay=0.01), \
        opt.AdafactorConfig(lr=0.05, weight_decay=0.01)
    params = _tree(1)
    jp, tp = jax.tree.map(jnp.asarray, params), _to_torch(params)
    js, ts = jopt.adafactor_init(jc, jp), opt.adafactor_init(tc, tp)
    assert jax.tree.structure(jax.tree.map(np.asarray, js)) == \
        jax.tree.structure(bridge.params_to_numpy(ts))
    for i in range(steps):
        g = _tree(200 + i)
        jp, js, _ = jopt.adafactor_update(jc, jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts, stats = opt.adafactor_update(tc, _to_torch(g), ts, tp)
        assert stats == {}
    assert int(ts["step"]) == steps
    _close(tp, jp, **TIGHT)
    _close(ts["v"], js["v"], **TIGHT)


def test_lr_schedule_matches_jax():
    c = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    jc, tc = jopt.AdamWConfig(**c), opt.AdamWConfig(**c)
    steps = np.arange(0, 130, 7, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: jopt.lr_schedule(jc, s))(jnp.asarray(steps)))
    got = opt.lr_schedule(tc, torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_global_norm_matches_jax():
    t = _tree(3)
    want = float(jopt.global_norm(jax.tree.map(jnp.asarray, t)))
    assert float(opt.global_norm(_to_torch(t))) == pytest.approx(want, rel=1e-6)


def test_bf16_moments_cross_the_bridge_bit_equal():
    """A bf16-moment state crosses to numpy and back with its bits (the
    bridge's optimizer-state loaders)."""
    c = opt.AdamWConfig(moment_dtype=torch.bfloat16, warmup_steps=0)
    tp = _to_torch(_tree(4))
    _, state, _ = opt.adamw_update(c, _to_torch(_tree(5)), opt.adamw_init(c, tp), tp)
    as_np = bridge.opt_state_to_numpy(state)
    assert as_np["m"]["w"].dtype == ml_dtypes.bfloat16 and as_np["step"].dtype == np.int32
    back = bridge.opt_state_from_numpy(as_np, device="cpu")
    for a, b in zip(tree_leaves(state), tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ------------------------------------------ twins of TestOptimizer --
class TestOptimizer:
    def _quad_problem(self):
        params = {"w": torch.tensor([3.0, -2.0, 1.5]), "b": torch.tensor(0.5)}

        def loss(p):
            return p["w"].square().sum() + p["b"].square()

        return params, loss

    @staticmethod
    def _grad(loss, params):
        live = {k: v.detach().requires_grad_() for k, v in params.items()}
        grads = torch.autograd.grad(loss(live), list(live.values()))
        return dict(zip(live, grads))

    def test_adamw_converges_on_quadratic(self):
        params, loss = self._quad_problem()
        c = opt.AdamWConfig(lr=0.2, weight_decay=0.0, warmup_steps=0, total_steps=200)
        state = opt.adamw_init(c, params)
        l0 = float(loss(params))
        for _ in range(150):
            params, state, _ = opt.adamw_update(c, self._grad(loss, params), state, params)
        assert float(loss(params)) < 1e-2 * l0

    def test_moment_dtype_bf16(self):
        params, loss = self._quad_problem()
        c = opt.AdamWConfig(moment_dtype=torch.bfloat16, lr=0.1, warmup_steps=0)
        state = opt.adamw_init(c, params)
        assert state["m"]["w"].dtype == torch.bfloat16
        params2, state2, _ = opt.adamw_update(c, self._grad(loss, params), state, params)
        assert state2["v"]["w"].dtype == torch.bfloat16
        assert not torch.allclose(params2["w"], params["w"])

    def test_grad_clipping(self):
        params, _ = self._quad_problem()
        c = opt.AdamWConfig(lr=1e-3, grad_clip=1.0, warmup_steps=0)
        state = opt.adamw_init(c, params)
        huge = {k: 1e6 * torch.ones_like(v) for k, v in params.items()}
        _, _, stats = opt.adamw_update(c, huge, state, params)
        assert float(stats["grad_norm"]) > 1e5  # measured pre-clip

    def test_lr_schedule_warmup_cosine(self):
        c = opt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
        step = lambda n: torch.tensor(n, dtype=torch.int32)  # noqa: E731
        assert float(opt.lr_schedule(c, step(0))) == 0.0
        assert float(opt.lr_schedule(c, step(10))) == pytest.approx(1.0)
        assert float(opt.lr_schedule(c, step(100))) == pytest.approx(0.1, abs=1e-6)

    def test_adafactor_converges(self):
        params = {"w": torch.ones((4, 3)) * 2.0}

        def loss(p):
            return p["w"].square().sum()

        c = opt.AdafactorConfig(lr=0.3)
        state = opt.adafactor_init(c, params)
        for _ in range(100):
            params, state, _ = opt.adafactor_update(c, self._grad(loss, params), state, params)
        assert float(loss(params)) < 0.1

    def test_adafactor_memory_is_factored(self):
        state = opt.adafactor_init(opt.AdafactorConfig(), {"w": torch.ones((128, 64))})
        assert sum(x.numel() for x in tree_leaves(state["v"])) == 128 + 64

    def test_update_leaves_inputs_as_they_were(self):
        """The update is a function: the params, grads and state it is
        given keep their values (JAX arrays are immutable; tensors are not)."""
        params, loss = self._quad_problem()
        c = opt.AdamWConfig(lr=0.1, warmup_steps=0)
        state = opt.adamw_init(c, params)
        grads = self._grad(loss, params)
        before = [x.clone() for x in tree_leaves((params, state, grads))]
        opt.adamw_update(c, grads, state, params)
        after = tree_leaves((params, state, grads))
        assert all(torch.equal(a, b) for a, b in zip(before, after))
