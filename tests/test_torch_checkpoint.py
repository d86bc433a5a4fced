"""The port's checkpoints (``repro_torch.runtime.checkpoint``): the twins of
``TestCheckpoint`` (tests/test_runtime.py:129-176), the JAX package's keys
and manifest, and checkpoints crossing packages both ways (params and AdamW
state; bf16 moments from JAX to the port)."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the machine with the card has no JAX

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from _parity import numpy_params  # noqa: E402
from repro.configs import all_configs, get_config as jget  # noqa: E402
from repro.runtime import checkpoint as jckpt  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.runtime import checkpoint as ckpt  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((8, 4), generator=g),
            "nested": {"b": torch.arange(6, dtype=torch.int32), "c": torch.tensor(3.5)},
            "list": [torch.randn((2,), generator=g), torch.ones((3, 1), dtype=torch.bfloat16)]}


def _assert_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ------------------------------------------ twins of TestCheckpoint --
class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        tree = _tree()
        ckpt.save_checkpoint(str(tmp_path), 7, tree)
        restored, step, _ = ckpt.restore_checkpoint(str(tmp_path), _tree(seed=1))
        assert step == 7
        _assert_equal(restored, tree)

    def test_latest_step_and_gc(self, tmp_path):
        tree = _tree()
        for s in (1, 5, 9, 12):
            ckpt.save_checkpoint(str(tmp_path), s, tree, keep=2)
        assert ckpt.latest_step(str(tmp_path)) == 12
        remaining = sorted(d for d in os.listdir(tmp_path) if d.startswith("ckpt_"))
        assert remaining == ["ckpt_0000000009", "ckpt_0000000012"]  # gc keeps the latest 2

    def test_default_keeps_three(self, tmp_path):
        for s in range(1, 6):
            ckpt.save_checkpoint(str(tmp_path), s, _tree())
        assert sorted(os.listdir(tmp_path)) == [f"ckpt_{s:010d}" for s in (3, 4, 5)]

    def test_incomplete_checkpoint_ignored(self, tmp_path):
        tree = _tree()
        ckpt.save_checkpoint(str(tmp_path), 3, tree)
        os.makedirs(tmp_path / "ckpt_0000000009")  # a crash mid-write: no manifest
        assert ckpt.latest_step(str(tmp_path)) == 3
        _, step, _ = ckpt.restore_checkpoint(str(tmp_path), tree)
        assert step == 3

    def test_shape_mismatch_rejected(self, tmp_path):
        ckpt.save_checkpoint(str(tmp_path), 1, {"a": torch.zeros((4,))})
        with pytest.raises(ValueError, match="shape mismatch"):
            ckpt.restore_checkpoint(str(tmp_path), {"a": torch.zeros((5,))})

    def test_missing_array_rejected(self, tmp_path):
        ckpt.save_checkpoint(str(tmp_path), 1, {"a": torch.zeros((4,))})
        with pytest.raises(ValueError, match="missing"):
            ckpt.restore_checkpoint(str(tmp_path), {"a": torch.zeros((4,)), "b": torch.zeros(1)})

    def test_extra_metadata(self, tmp_path):
        ckpt.save_checkpoint(str(tmp_path), 2, _tree(), extra={"data_step": 42})
        _, _, extra = ckpt.restore_checkpoint(str(tmp_path), _tree())
        assert extra["data_step"] == 42

    def test_no_checkpoint(self, tmp_path):
        assert ckpt.latest_step(str(tmp_path / "none")) is None
        with pytest.raises(FileNotFoundError):
            ckpt.restore_checkpoint(str(tmp_path), _tree())


# ---------------------------------------------------------- across packages --
def _state(arch, moment_dtype=np.float32):
    """A reduced config's params and an AdamW-shaped state (int32 step,
    random moments) as JAX arrays."""
    params = numpy_params(jget(arch).reduced(), seed=0)
    r = np.random.default_rng(1)
    moments = lambda: jax.tree.map(  # noqa: E731
        lambda a: r.standard_normal(a.shape).astype(moment_dtype), params)
    state = {"step": np.int32(1), "m": moments(), "v": moments()}
    return jax.tree.map(jnp.asarray, {"params": params, "opt": state})


def _torch_template(tree, device="cpu"):
    return jax.tree.map(lambda a: torch.zeros(a.shape, dtype=getattr(torch, str(a.dtype))),
                        tree)


def test_keys_and_manifest_match_jax(tmp_path):
    """The same tree saved by each package: the same keys, files, dtypes and
    shapes in the manifest, and the same bytes in every file."""
    tree = _state("zamba2-7b")  # the "shared" list and empty blocks of the hybrid stack
    jckpt.save_checkpoint(str(tmp_path / "jax"), 4, tree, extra={"data": {"step": 4}})
    ours = {"params": bridge.params_from_numpy(jax.tree.map(np.asarray, tree["params"]), "cpu"),
            "opt": bridge.opt_state_from_numpy(jax.tree.map(np.asarray, tree["opt"]), "cpu")}
    ckpt.save_checkpoint(str(tmp_path / "torch"), 4, ours, extra={"data": {"step": 4}})
    assert sorted(ckpt._flatten(ours)) == sorted(jckpt._flatten(tree))
    assert "params/blocks/0/mamba/w_in" in ckpt._flatten(ours)
    manifests = [json.load(open(tmp_path / side / "ckpt_0000000004" / "manifest.json"))
                 for side in ("jax", "torch")]
    assert manifests[0] == manifests[1]
    for info in manifests[0]["arrays"].values():
        a, b = (np.load(tmp_path / side / "ckpt_0000000004" / info["file"])
                for side in ("jax", "torch"))
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "dbrx-132b", "rwkv6-7b"])
def test_jax_checkpoint_restores_in_port(tmp_path, arch):
    tree = _state(arch)
    jckpt.save_checkpoint(str(tmp_path), 1, tree, extra={"data": {"step": 1}})
    restored, step, extra = ckpt.restore_checkpoint(str(tmp_path), _torch_template(tree))
    assert step == 1 and extra == {"data": {"step": 1}}
    want = jax.tree.leaves(jax.tree.map(np.asarray, tree))
    got = jax.tree.leaves(bridge.params_to_numpy(restored))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert restored["opt"]["step"].dtype == torch.int32 and int(restored["opt"]["step"]) == 1


def test_jax_bf16_moments_restore_in_port(tmp_path):
    """JAX writes bf16 leaves as raw 2-byte records (``np.save`` of an
    ml_dtypes array); the port reads them back bit for bit."""
    tree = _state("qwen3-0.6b", ml_dtypes.bfloat16)
    jckpt.save_checkpoint(str(tmp_path), 1, tree)
    restored, _, _ = ckpt.restore_checkpoint(str(tmp_path), _torch_template(tree))
    assert restored["opt"]["m"]["embed"].dtype == torch.bfloat16
    want = jax.tree.leaves(jax.tree.map(np.asarray, tree["opt"]))
    got = jax.tree.leaves(bridge.opt_state_to_numpy(restored["opt"]))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "zamba2-7b"])
def test_port_checkpoint_restores_in_jax(tmp_path, arch):
    tree = _state(arch)
    ours = {"params": bridge.params_from_numpy(jax.tree.map(np.asarray, tree["params"]), "cpu"),
            "opt": bridge.opt_state_from_numpy(jax.tree.map(np.asarray, tree["opt"]), "cpu")}
    ckpt.save_checkpoint(str(tmp_path), 3, ours, extra={"data": {"step": 3}})
    template = jax.tree.map(jnp.zeros_like, tree)
    restored, step, extra = jckpt.restore_checkpoint(str(tmp_path), template)
    assert step == 3 and extra == {"data": {"step": 3}}
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_config_fingerprint_matches_jax():
    for name in all_configs():
        cfg = get_config(name)
        assert ckpt.config_fingerprint(cfg) == jckpt.config_fingerprint(jget(name))
        assert ckpt.config_fingerprint(cfg) != ckpt.config_fingerprint(cfg.reduced())
