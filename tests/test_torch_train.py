"""The port's training step (``repro_torch.runtime.train``) against
``repro.runtime.train`` on bridged fp32 weights (reduced configs, CPU): one
step's loss, metrics, grad norm, moments and params for a dense, a
local/global (banded attention), an MoE, an rwkv and a hybrid config, with
and without remat and with two microbatches; the twins of
``TestArchSmoke::test_train_step_no_nans`` (tests/test_models.py:40-58)
over all ten configs and of ``TestFaultTolerance`` (tests/test_runtime.py:
180-228); the rwkv clamp's gradient against JAX's."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the machine with the card has no JAX

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _parity import numpy_params  # noqa: E402
from repro.configs import all_configs, get_config as jget  # noqa: E402
from repro.runtime import optimizer as jopt  # noqa: E402
from repro.runtime import train as jtrain  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.runtime import checkpoint as ckpt  # noqa: E402
from repro_torch.runtime import optimizer as opt  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from repro_torch.runtime import train  # noqa: E402
from repro_torch.runtime.data import DataConfig, DataState, TokenStream  # noqa: E402

LR, B = 1e-3, 4
# (arch, sequence length): gemma3 at 128 = 2 x its reduced window, so its
# local layers take the banded version; qwen3's batch carries a loss mask
STEP_CASES = [("qwen3-0.6b", 64), ("gemma3-4b", 128), ("dbrx-132b", 64), ("rwkv6-7b", 64),
              ("zamba2-7b", 64)]


def _batch(cfg, S, seed):
    r = np.random.default_rng(seed)
    toks = r.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.name.startswith("qwen3"):
        batch["loss_mask"] = (r.random((B, S)) < 0.8).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _jax_step(arch, S, microbatch):
    """JAX's first AdamW step from the shared weights, as numpy."""
    jcfg = jget(arch).reduced()
    params = jax.tree.map(jnp.asarray, numpy_params(jcfg, seed=0))
    c = jopt.AdamWConfig(lr=LR, warmup_steps=0)
    step = jax.jit(jtrain.make_train_step(jcfg, None, c, remat=False, microbatch=microbatch))
    batch = jax.tree.map(jnp.asarray, _batch(jcfg, S, seed=1))
    p, s, m = step(params, jopt.adamw_init(c, params), batch)
    return jax.tree.map(np.asarray, (p, s, m))


def _port_step(arch, S, remat, microbatch):
    cfg = get_config(arch).reduced()
    params = bridge.params_from_numpy(numpy_params(jget(arch).reduced(), seed=0), device="cpu")
    c = opt.AdamWConfig(lr=LR, warmup_steps=0)
    step = train.make_train_step(cfg, c, remat=remat, microbatch=microbatch, device="cpu")
    p, s, m = step(params, opt.adamw_init(c, params), _batch(cfg, S, seed=1))
    return bridge.params_to_numpy(p), bridge.opt_state_to_numpy(s), m


def _check_step(got, want):
    """Metrics and grad norm at 1e-5 relative. The moments carry the
    gradient (m = 0.1 x clip x g at step 1): each leaf at 1e-4 of its
    largest |m| (fp32 gradients summed in another order; random rwkv layers
    amplify that noise to ~2e-5). Params: Adam's first step moves an element
    by lr x g / (|g| + eps), nearly a sign, whose slope at g = 0 is 1 / eps;
    where |g| >= 1e-6 (10^2 x eps) it is held to lr x 1e-2, elsewhere to the
    2 x lr the step can move it at most."""
    (gp, gs, gm), (wp, ws, wm) = got, want
    for k in ("nll", "z_loss", "moe_aux", "lr", "grad_norm"):
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert int(gs["step"]) == int(ws["step"]) == 1
    for name in ("m", "v"):
        for a, b in zip(jax.tree.leaves(gs[name]), jax.tree.leaves(ws[name])):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max() + 1e-30)
    for a, b, m in zip(jax.tree.leaves(gp), jax.tree.leaves(wp), jax.tree.leaves(ws["m"])):
        sure = np.abs(m) >= 1e-7  # the clipped |g| >= 1e-6
        np.testing.assert_allclose(a[sure], b[sure], rtol=0, atol=LR * 1e-2)
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * LR)


@pytest.mark.parametrize("arch,S", STEP_CASES)
@pytest.mark.parametrize("remat", [False, True])
def test_train_step_matches_jax(arch, S, remat):
    _check_step(_port_step(arch, S, remat, 1), _jax_step(arch, S, 1))


@pytest.mark.parametrize("arch,S", [("qwen3-0.6b", 64), ("dbrx-132b", 64)])
def test_microbatch_matches_jax(arch, S):
    """Two microbatches: gradients summed in fp32 and halved, the last
    chunk's metrics (dbrx: each chunk routes its own dispatch groups)."""
    _check_step(_port_step(arch, S, True, 2), _jax_step(arch, S, 2))


def test_microbatch_that_does_not_divide_raises():
    """A batch of 3 at ``microbatch=2``: JAX's reshape raises, and the port
    raises ``ValueError`` before any work rather than drop the third row."""
    cfg = get_config("qwen3-0.6b").reduced()
    params = tf.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    c = opt.AdamWConfig(lr=LR, warmup_steps=0)
    batch = _batch(cfg, 16, seed=5)
    batch = {k: v[:3] for k, v in batch.items()}
    step = train.make_train_step(cfg, c, microbatch=2, device="cpu")
    with pytest.raises(ValueError, match="microbatch=2 does not divide"):
        step(params, opt.adamw_init(c, params), batch)
    jcfg = jget("qwen3-0.6b").reduced()
    jparams = jax.tree.map(jnp.asarray, numpy_params(jcfg, seed=0))
    jc = jopt.AdamWConfig(lr=LR, warmup_steps=0)
    jstep = jtrain.make_train_step(jcfg, None, jc, remat=False, microbatch=2)
    with pytest.raises(TypeError):
        jstep(jparams, jopt.adamw_init(jc, jparams), jax.tree.map(jnp.asarray, batch))


def test_remat_is_the_same_step():
    """remat reruns each layer's forward in the backward: the same step, bit
    for bit, on the CPU."""
    a = _port_step("gemma3-4b", 128, False, 1)
    b = _port_step("gemma3-4b", 128, True, 1)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_gemma3_local_layers_take_banded(monkeypatch):
    """The gemma3 step above runs its windowed layers through the banded
    version and its global layers through the dense one."""
    paths = []
    plain = flash_ops.plain_path
    monkeypatch.setattr(flash_ops, "plain_path", lambda *a: paths.append(plain(*a)) or paths[-1])
    _port_step("gemma3-4b", 128, False, 1)
    assert paths == ["banded", "dense"] * 2  # the reduced plan: local and global in turn


# --------------------------------------- the twin of test_train_step_no_nans --
@pytest.mark.parametrize("arch", sorted(all_configs()))
def test_train_step_no_nans(arch):
    """One remat'd backward per config: finite loss, finite grads, some
    non-zero (tests/test_models.py:40-58, the port's own weights)."""
    cfg = get_config(arch).reduced()
    params = tf.init_params(cfg, seed=1, dtype=torch.float32, device="cpu")
    r = np.random.default_rng(2)
    Bs, S = 2, 32
    if cfg.frontend == "frame_embed":
        batch = {"frame_embeds": torch.from_numpy(
            0.02 * r.standard_normal((Bs, S, cfg.d_model)).astype(np.float32))}
    else:
        batch = {"tokens": torch.from_numpy(r.integers(0, cfg.vocab_size, (Bs, S)))}
        if cfg.frontend == "patch_embed":
            batch["patch_embeds"] = torch.from_numpy(
                0.02 * r.standard_normal((Bs, cfg.n_prefix_embeds, cfg.d_model))
                .astype(np.float32))
    batch["labels"] = torch.from_numpy(r.integers(0, cfg.vocab_size, (Bs, S)))
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    total, met = train.loss_fn(cfg, params, batch, remat=True)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    assert bool(torch.isfinite(total)) and all(bool(torch.isfinite(v)) for v in met.values())
    got = [g for g in grads if g is not None]
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert any(float(g.abs().max()) > 0 for g in got)


# ---------------------------------------------- the twin of TestFaultTolerance --
def test_crash_resume_bitexact(tmp_path):
    """6 steps straight against 3 steps, a checkpoint, a 'crash' and 3 steps
    from the restored params, optimizer state and data state: the same
    losses and params, bit for bit."""
    cfg = get_config("qwen3-0.6b").reduced()
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    c = opt.AdamWConfig(lr=1e-3, warmup_steps=0)
    step = train.make_train_step(cfg, c, remat=False, device="cpu")

    def fresh():
        params, state = train.init_train_state(cfg, c, seed=0, dtype=torch.float32,
                                               device="cpu")
        return params, state, TokenStream(dcfg)

    params, state, stream = fresh()
    losses = []
    for _ in range(6):
        params, state, m = step(params, state, stream.next())
        losses.append(float(m["nll"]))
    straight = params

    params, state, stream = fresh()
    for _ in range(3):
        params, state, m = step(params, state, stream.next())
    ckpt.save_checkpoint(str(tmp_path), 3, {"params": params, "opt": state},
                         extra={"data": stream.state.as_dict()})
    del params, state, stream  # crash

    template = dict(zip(("params", "opt"), train.init_train_state(
        cfg, c, seed=1, dtype=torch.float32, device="cpu")))
    restored, at, extra = ckpt.restore_checkpoint(str(tmp_path), template)
    params, state = restored["params"], restored["opt"]
    stream = TokenStream(dcfg, DataState.from_dict(extra["data"]))
    assert at == 3 and int(state["step"]) == 3
    resumed = []
    for _ in range(3):
        params, state, m = step(params, state, stream.next())
        resumed.append(float(m["nll"]))
    assert resumed == losses[3:]
    for a, b in zip(tree_leaves(params), tree_leaves(straight)):
        assert torch.equal(a, b)


# ------------------------------------------------------------- rwkv's clamp --
def test_wkv6_chunked_gradient_past_the_clamp_matches_jax():
    """Decays of 0.01 a step put each chunk's cumulative log-decay past
    CLAMP = 60 (the chunked form leaves its exact regime): off exact ties
    the gradients of the port's ``wkv6_chunked`` equal JAX's at 1e-4
    relative. At an exact tie they differ, because ``jnp.clip`` splits the
    gradient there (0.5) and ``torch.clamp`` passes it whole (1.0); no
    random fp32 input lands on one."""
    from repro.kernels.rwkv6.ref import wkv6_chunked as jwkv
    from repro_torch.kernels.rwkv6.ref import wkv6_chunked

    r = np.random.default_rng(3)
    b, s, h, p = 1, 40, 2, 8
    rr, kk, vv = (r.standard_normal((b, s, h, p)).astype(np.float32) for _ in range(3))
    ww = np.full((b, s, h, p), 0.01, np.float32) * np.exp(
        0.1 * r.standard_normal((b, s, h, p))).astype(np.float32)
    uu = r.standard_normal((h, p)).astype(np.float32)
    st = r.standard_normal((b, h, p, p)).astype(np.float32)
    gy = r.standard_normal((b, s, h, p)).astype(np.float32)
    want = jax.jit(jax.grad(lambda *a: (jwkv(*a)[0] * gy).sum(), argnums=tuple(range(6))))(
        *map(jnp.asarray, (rr, kk, vv, ww, uu, st)))
    args = [torch.from_numpy(a).requires_grad_() for a in (rr, kk, vv, ww, uu, st)]
    got = torch.autograd.grad((wkv6_chunked(*args)[0] * torch.from_numpy(gy)).sum(), args)
    for a, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(a.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max())
    x, j = torch.tensor(60.0, requires_grad=True), jnp.float32(60.0)
    (tie,) = torch.autograd.grad(torch.clamp(x, -60.0, 60.0), x)
    assert float(tie) == 1.0 and float(jax.grad(lambda y: jnp.clip(y, -60.0, 60.0))(j)) == 0.5
