"""The port's sharding (``repro_torch.runtime.sharding``, ``pspec``) against
``repro.runtime.sharding``: every parameter's, cache leaf's and input's
spec of all ten configs on both production meshes, the activation specs,
``attn_mode``, ``fsdp`` and ``batch_axes``, equal to JAX's (JAX's side on
``make_abstract_mesh``, as ``TestPolicyRules`` builds it); the big models'
per-device bf16 parameter bytes; then one spawn of 4 gloo CPU ranks on a
(2, 2) mesh that runs the sharded prefill, decode and train step of reduced
configs through the entry points with ``policy=``, held to JAX's unsharded
``forward`` / ``decode_step`` / train step and to the unsharded port, and
the loss's vocab-parallel logsumexp and label pick against ``logsumexp`` and
``gather``.

JAX 0.9 cannot compile the reference's sharded programs
(``tests/test_sharding.py::test_reduced_configs_compile_on_small_mesh``
fails at ``runtime/pspec.py:52``), so the port is held to JAX's spec values
and to JAX's unsharded values: sharding does not change values."""
import functools
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the machine with the card has no JAX

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _sharding_ranks as ranks  # noqa: E402
from _parity import _perturb, jax_tree  # noqa: E402
from test_torch_train import LR, _batch, _check_step  # noqa: E402
from repro.configs import all_configs, get_config as jget  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.runtime import optimizer as jopt  # noqa: E402
from repro.runtime import train as jtrain  # noqa: E402
from repro.runtime.sharding import make_abstract_mesh, make_policy as jmake_policy  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import LM_SHAPES  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import make_abstract_production_mesh  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.runtime import sharding as sh  # noqa: E402
from repro_torch.runtime import optimizer as opt  # noqa: E402
from repro_torch.runtime.pipeline_ranks import spawn_stages  # noqa: E402
from repro_torch.runtime.serve import make_prefill, make_serve_step  # noqa: E402
from repro_torch.runtime.train import make_train_step  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map_with_path  # noqa: E402

ARCHS = sorted(all_configs())
DECODE_SHAPE = next(s for s in LM_SHAPES if s.name == "decode_32k")
TRAIN_SHAPE = next(s for s in LM_SHAPES if s.name == "train_4k")
# JAX's test for the big models' per-device bytes (tests/test_sharding.py:62-80)
BIG = ["grok-1-314b", "internvl2-76b", "dbrx-132b"]
# sharded against unsharded: ||a - b|| / ||b|| (Frobenius); the sums of the
# row-parallel products and of the decode softmax run in another order
PORT_TOL = 1e-5
JAX_TOL = dict(rtol=2e-3, atol=2e-3)  # tests/test_models.py:111
B, S = 4, 16  # the spawn's prefill and train batch and length (max_len of its cache)
TRAIN_ARCH = "qwen3-0.6b"


def _jax_paths(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in flat}


def _port_paths(tree) -> dict:
    out = {}
    tree_map_with_path(lambda path, leaf: out.__setitem__(path, leaf), tree)
    return out


@functools.lru_cache(maxsize=None)
def _jax_trees(arch):
    cfg = jget(arch)
    return (jspecs.params_specs(cfg),
            jspecs.cache_specs(cfg, DECODE_SHAPE.global_batch, DECODE_SHAPE.seq_len),
            jspecs.input_specs(cfg, TRAIN_SHAPE))


@functools.lru_cache(maxsize=None)
def _port_trees(arch):
    cfg = get_config(arch)
    return (specs.params_specs(cfg),
            specs.cache_specs(cfg, DECODE_SHAPE.global_batch, DECODE_SHAPE.seq_len),
            specs.input_specs(cfg, TRAIN_SHAPE))


def _policies(arch, multi_pod):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return (jmake_policy(jget(arch), make_abstract_mesh(shape, axes)),
            sh.make_policy(get_config(arch), make_abstract_production_mesh(multi_pod=multi_pod)))


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_jax(arch, multi_pod):
    """Leaf for leaf, the port's specs are JAX's ``NamedSharding.spec``s."""
    jp, tp = _policies(arch, multi_pod)
    assert (tp.attn_mode, tp.fsdp, tp.batch_axes, tp.model_size) == \
        (jp.attn_mode, jp.fsdp, jp.batch_axes, jp.model_size)
    want = {k: tuple(v) for k, v in jp.activation_specs().items()}
    assert {k: tuple(v) for k, v in tp.activation_specs().items()} == want
    (jparams, jcache, jbatch), (tparams, tcache, tbatch) = _jax_trees(arch), _port_trees(arch)
    for jtree, ttree, jfn, tfn in ((jparams, tparams, jp.params_sharding, tp.param_specs),
                                   (jcache, tcache, jp.cache_sharding, tp.cache_specs),
                                   (jbatch, tbatch, jp.inputs_sharding, tp.input_specs)):
        jspec = {k: tuple(s.spec) for k, s in _jax_paths(jfn(jtree)).items()}
        tspec = {k: tuple(s) for k, s in _port_paths(tfn(ttree)).items()}
        assert tspec == jspec


@pytest.mark.parametrize("arch", BIG)
def test_big_models_bytes_per_device_equal_jax(arch):
    """bf16 params over the 256-card pod: the JAX test's figure, below 10 GiB."""
    jp, tp = _policies(arch, False)
    jparams, tparams = _jax_trees(arch)[0], _port_trees(arch)[0]

    def per_device(leaves, spec_leaves, sizes):
        total = 0
        for leaf, spec in zip(leaves, spec_leaves):
            n = 1
            for ax in spec:
                for a in (() if ax is None else ax if isinstance(ax, tuple) else (ax,)):
                    n *= sizes[a]
            total += int(np.prod(leaf.shape)) * 2 / n
        return total

    want = per_device(jax.tree.leaves(jparams),
                      [s.spec for s in jax.tree.leaves(jp.params_sharding(jparams))],
                      dict(jp.mesh.shape))
    got = per_device(tree_leaves(tparams), tree_leaves(tp.param_specs(tparams)),
                     sh.mesh_shape(tp.mesh))
    assert got == want
    assert got < 10 * 2**30, f"{arch}: {got / 2**30:.1f} GiB a device"


def test_placements_follow_specs():
    """A tuple entry shards one tensor dimension over several mesh
    dimensions (major to minor, as JAX); an absent name replicates."""
    from torch.distributed.tensor import Replicate, Shard

    m = make_abstract_production_mesh(multi_pod=True)
    assert sh.placements(m, sh.P(("pod", "data"), None, "model")) == \
        (Shard(0), Shard(0), Shard(2))
    assert sh.placements(m, sh.P(None, "data")) == (Replicate(), Shard(1), Replicate())
    assert sh.P(("data",), None) == sh.P("data", None)


# ------------------------------------------------------- the sharded runs --
def _weights(arch, seed):
    """The port's init from ``seed`` as numpy, every norm scale perturbed (as
    ``_parity.numpy_params`` does to JAX's init): the weights both packages
    run."""
    cfg = get_config(arch).reduced()
    tree = bridge.params_to_numpy(tf.init_params(cfg, seed, torch.float32, device="cpu"))
    return _perturb(tree, np.random.default_rng(seed), 0.1)


def _serve_inputs():
    return {arch: (_weights(arch, 20 + i),
                   ranks.numpy_tokens(get_config(arch).reduced().vocab_size, B, S, seed=40 + i))
            for i, arch in enumerate(ranks.SERVE_CASES)}


def _train_inputs():
    return {arch: (_weights(arch, i), _batch(get_config(arch).reduced(), S, seed=1 + i), LR)
            for i, arch in enumerate(ranks.TRAIN_CASES)}


def _pick_inputs():
    """Logits (B, S, V) with V = 64 over "model" 2, labels in both vocab
    halves, and the two outputs' cotangents."""
    r = np.random.default_rng(7)
    logits = r.standard_normal((B, S, 64)).astype(np.float32) * 3
    labels = r.integers(0, 64, (B, S)).astype(np.int64)
    return (logits, labels, r.standard_normal((B, S)).astype(np.float32),
            r.standard_normal((B, S)).astype(np.float32))


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """(inputs, references, what rank 0 returned): one spawn of 4 gloo ranks
    (every serve case, then the train step), started here, while the
    unsharded port's and JAX's results are computed."""
    serve, train, pick = _serve_inputs(), _train_inputs(), _pick_inputs()
    path = tmp_path_factory.mktemp("sharded") / "inputs.pkl"
    path.write_bytes(pickle.dumps((serve, train, pick)))
    with ThreadPoolExecutor(max_workers=1) as pool:
        future = pool.submit(spawn_stages, 4, ranks.run, str(path), device="cpu",
                             timeout_s=240)
        refs = {arch: (_unsharded_port(arch, *serve[arch]), _unsharded_jax(arch, *serve[arch]))
                for arch in serve}
        refs["train"] = {arch: (_jax_train_step(arch, *t), _unsharded_port_step(arch, *t))
                         for arch, t in train.items()}
        refs["pick"] = pick
        return serve, refs, future.result()[0]


def _unsharded_port(arch, tree, toks):
    cfg = get_config(arch).reduced()
    params = bridge.params_from_numpy(tree, device="cpu")
    want = make_prefill(cfg, device="cpu")(params, {"tokens": toks}).numpy()
    cache = tf.init_cache(cfg, B, S, torch.float32, device="cpu")
    step = make_serve_step(cfg, device="cpu")
    dec = [step(params, cache, {"tokens": toks[:, t:t + 1]}, t)[0][:, 0].clone()
           for t in range(ranks.DECODE_STEPS)]
    return want, torch.stack(dec, 1).numpy()


def _unsharded_jax(arch, tree, toks):
    jcfg = jget(arch).reduced()
    jp = jax_tree(tree)
    want, _ = jtf.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    cache = jtf.init_cache(jcfg, B, S, jnp.float32)
    step = jax.jit(lambda p, c, b, pos: jtf.decode_step(jcfg, p, c, b, pos))
    dec = []
    for t in range(ranks.DECODE_STEPS):
        lg, cache = step(jp, cache, {"tokens": jnp.asarray(toks[:, t:t + 1])}, jnp.int32(t))
        dec.append(np.asarray(lg[:, 0]))
    return np.asarray(want), np.stack(dec, 1)


def _jax_train_step(arch, tree, batch, lr):
    jcfg = jget(arch).reduced()
    params = jax_tree(tree)
    c = jopt.AdamWConfig(lr=lr, warmup_steps=0)
    step = jax.jit(jtrain.make_train_step(jcfg, None, c, remat=False, microbatch=1))
    p, s, m = step(params, jopt.adamw_init(c, params), jax.tree.map(jnp.asarray, batch))
    return jax.tree.map(np.asarray, (p, s, m))


def _unsharded_port_step(arch, tree, batch, lr):
    cfg = get_config(arch).reduced()
    params = bridge.params_from_numpy(tree, device="cpu")
    c = opt.AdamWConfig(lr=lr, warmup_steps=0)
    p, s, m = make_train_step(cfg, c, remat=False, device="cpu")(params, opt.adamw_init(c, params),
                                                                 batch)
    return bridge.params_to_numpy(p), bridge.opt_state_to_numpy(s), {k: float(v)
                                                                      for k, v in m.items()}


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("arch", list(ranks.SERVE_CASES))
def test_sharded_serving_matches_unsharded(sharded, arch):
    """Prefill (4 x 16) and 4 decode steps on the (2, 2) mesh: within 1e-5
    (Frobenius-relative) of the unsharded port, and within JAX's 2e-3 of
    JAX's unsharded ``forward`` and ``decode_step``; the logits come back
    sharded on vocab over "model" (the ``logits`` spec)."""
    serve, refs, got = sharded
    g = got[arch]
    (want_p, want_d), (jax_p, jax_d) = refs[arch]
    assert _rel(g["prefill"], want_p) <= PORT_TOL
    assert _rel(g["decode"], want_d) <= PORT_TOL
    np.testing.assert_allclose(g["prefill"], jax_p, **JAX_TOL)
    if arch == "rwkv6-7b":
        # JAX's rwkv decode-vs-forward criterion (tests/test_models.py:97-108):
        # the chunked and sequential forms part by O(0.1) through the group
        # norms, so decode is held to JAX's decode on probabilities and tokens
        np.testing.assert_allclose(jax.nn.softmax(g["decode"], -1),
                                   jax.nn.softmax(jax_d, -1), atol=2e-2)
        np.testing.assert_array_equal(g["decode"].argmax(-1), jax_d.argmax(-1))
    else:
        np.testing.assert_allclose(g["decode"], jax_d, **JAX_TOL)
    assert "Shard(dim=2)" in g["placements"]


def test_sharded_train_step_matches_unsharded(sharded):
    """qwen3's AdamW step (4 x 16 tokens, a loss mask) on the (2, 2) mesh:
    metrics, moments and params
    held to JAX's unsharded step and to the unsharded port by the train
    tests' criteria (metrics at 1e-5 relative)."""
    _, refs, got = sharded
    jax_step, port_step = refs["train"][TRAIN_ARCH]
    _check_step(got["train"][TRAIN_ARCH], jax_step)
    _check_step(got["train"][TRAIN_ARCH], port_step)


@pytest.mark.parametrize("arch", ["dbrx-132b", "zamba2-7b"])
def test_sharded_train_step_moe_and_ssd(sharded, arch):
    """The AdamW step of reduced dbrx-132b (MoE, forced FSDP: gradients
    reduce-scattered onto the shards a layer at a time; 4 heads in one k/v
    group, which each "model" rank narrows to its group, so k/v's gradients
    are each rank's share) and of reduced zamba2-7b (the SSD scan on each
    rank's heads, B and C read whole), held like qwen3's to JAX's unsharded
    step and to the unsharded port."""
    _, refs, got = sharded
    jax_step, port_step = refs["train"][arch]
    _check_step(got["train"][arch], jax_step)
    _check_step(got["train"][arch], port_step)


def test_vocab_parallel_pick_matches_gather(sharded):
    """``lse_and_label_logits`` on logits split over "data" and "model"
    (each rank picks from its vocab half): the label's logit and its
    gradient equal to ``gather``'s exactly, the logsumexp and its gradient
    (the softmax) within 1e-6 of ``torch.logsumexp``'s; on plain tensors the
    function is ``logsumexp`` and ``gather`` themselves."""
    from repro_torch.runtime.train import lse_and_label_logits

    _, refs, got = sharded
    logits, labels, d_lse, d_picked = refs["pick"]
    x = torch.from_numpy(logits).requires_grad_()
    lab = torch.from_numpy(labels)
    lse, picked = torch.logsumexp(x, -1), x.gather(-1, lab[..., None])[..., 0]
    plain = lse_and_label_logits(x, lab)
    assert torch.equal(plain[0], lse) and torch.equal(plain[1], picked)
    (g_lse,) = torch.autograd.grad(lse, x, torch.from_numpy(d_lse))
    (g_pick,) = torch.autograd.grad(picked, x, torch.from_numpy(d_picked))
    (p_pick,) = torch.autograd.grad(plain[1], x, torch.from_numpy(d_picked))
    assert torch.equal(p_pick, g_pick)
    p = got["pick"]
    np.testing.assert_array_equal(p["picked"], picked.detach().numpy())
    np.testing.assert_array_equal(p["grad_picked"], g_pick.numpy())
    np.testing.assert_allclose(p["lse"], lse.detach().numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(p["grad_lse"], g_lse.numpy(), rtol=1e-6, atol=1e-6)


def test_policy_device_is_the_mesh(sharded):
    """Under a policy an entry point runs on the mesh's device: a CPU mesh
    with ``device="cuda"`` raises ``ValueError``."""
    assert sharded[2]["device_refused"] is True


def test_unsharded_calls_do_not_change():
    """Outside a policy ``constrain`` returns its input itself, and the
    entry points take no mesh: a plain prefill is bit-equal run twice."""
    from repro_torch.runtime.pspec import constrain

    x = torch.ones(2, 3)
    assert constrain(x, "residual") is x
    cfg = get_config("qwen3-0.6b").reduced()
    params = tf.init_params(cfg, 0, torch.float32, device="cpu")
    toks = ranks.numpy_tokens(cfg.vocab_size, 2, 8, seed=1)
    a = make_prefill(cfg, device="cpu")(params, {"tokens": toks})
    b = make_prefill(cfg, device="cpu", policy=None)(params, {"tokens": toks})
    assert torch.equal(a, b)
