"""The port's dry run (``repro_torch.launch``) against ``repro.launch``: the
meta stand-ins' shapes and dtypes against JAX's ``ShapeDtypeStruct``s for
all ten configs, ``model_flops_per_chip`` against JAX's; then, in one
subprocess (the fake process group of 256 ranks is process-wide), a dry-run
cell of reduced qwen3-0.6b on the fake 16 x 16 mesh with the local-shard
FLOP count checked against ``FlopCounterMode`` on plain tensors of the
local shapes, the kernels' shape-only work, the collectives against
``CommDebugMode``, a DTensor refused by the CUDA wrappers, and the output
bytes of a decode cell (the slots written in place) and a train cell; and
``tools/sharded_cards.py --cpu`` (its 4 ranks spawned on the CPU)."""
import json
import math
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the machine with the card has no JAX

import jax  # noqa: E402

from test_torch_sharding import _jax_paths, _jax_trees, _port_paths, _port_trees  # noqa: E402
from repro.configs import all_configs, get_config as jget  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.runtime import optimizer as jopt  # noqa: E402
from repro_torch.configs import LM_SHAPES, get_config  # noqa: E402
from repro_torch.launch import dryrun, report, specs  # noqa: E402
from repro_torch.benchmarks import roofline_report  # noqa: E402
from repro_torch.runtime import optimizer as opt  # noqa: E402

ARCHS = sorted(all_configs())
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "int32": torch.int32}


def _same(jtree, ttree):
    """Path for path (JAX's leaves come in sorted key order)."""
    want = {k: (tuple(x.shape), DTYPES[str(x.dtype)]) for k, x in _jax_paths(jtree).items()}
    got = _port_paths(ttree)
    assert {k: (tuple(x.shape), x.dtype) for k, x in got.items()} == want
    assert all(x.device.type == "meta" for x in got.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_stand_ins_equal_jax(arch):
    """Params, the decode_32k cache, AdamW state and every shape's inputs:
    JAX's shapes and dtypes, leaf for leaf, on the meta device."""
    jcfg, cfg = jget(arch), get_config(arch)
    (jparams, jcache, _), (tparams, tcache, _) = _jax_trees(arch), _port_trees(arch)
    _same(jparams, tparams)
    _same(jcache, tcache)
    jo = jax.eval_shape(lambda p: jopt.adamw_init(jopt.AdamWConfig(), p), jparams)
    _same(jo, opt.adamw_init(opt.AdamWConfig(), tparams))
    for shape in LM_SHAPES:
        _same(jspecs.input_specs(jcfg, shape), specs.input_specs(cfg, shape))
        _same(jspecs.decode_input_specs(jcfg, shape), specs.decode_input_specs(cfg, shape))


def test_model_flops_per_chip_equal_jax():
    env = os.environ.get("XLA_FLAGS")
    try:  # the JAX dry run sets XLA_FLAGS when imported; keep the tests' own
        from repro.launch import dryrun as jdryrun
    finally:
        if env is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = env
    for arch in ARCHS:
        for shape in LM_SHAPES:
            for n in (256, 512):
                assert dryrun.model_flops_per_chip(get_config(arch), shape, n) == \
                    jdryrun.model_flops_per_chip(jget(arch), shape, n)


CELL_SCRIPT = r"""
import json, sys
import torch
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import get_config
from repro_torch.kernels import _sharded
from repro_torch.kernels.flash_attention import kernel as fa, ops as fa_ops
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import dryrun, flop_analysis
from repro_torch.launch.mesh import fake_world, make_production_mesh
from dataclasses import asdict

out = {}
cfg = get_config("qwen3-0.6b").reduced()
cell = dryrun.run_cell("qwen3-0.6b", "prefill_32k", cfg=cfg, verbose=False)
out["cell"] = asdict(cell)

# in-place outputs: every output leaf's local bytes (the count before
# aliasing was taken into account) beside the cell's output_bytes
from dataclasses import replace
from repro_torch.tree import tree_leaves
seen = {}
count_out = flop_analysis.output_bytes
def spy(step_out, args, writes):
    seen["whole"] = flop_analysis.local_bytes(step_out)
    local = [getattr(x, "to_local", lambda: x)() for x in tree_leaves(step_out)]
    seen["leaves"] = [[list(x.shape), x.element_size()] for x in local]
    return count_out(step_out, args, writes)
flop_analysis.output_bytes = spy
two = replace(cfg, num_layers=2)
for shape in ("decode_32k", "train_4k"):
    c = dryrun.run_cell("qwen3-0.6b", shape, cfg=two, verbose=False)
    out[shape] = {"status": c.status, "reason": c.reason, "output_bytes": c.output_bytes,
                  "hbm_bytes": c.hbm_bytes, "arg_bytes": c.arg_bytes, **seen}
flop_analysis.output_bytes = count_out

# a column-parallel product on the 16 x 16 mesh: the local count and the
# global one FlopCounterMode gives above DTensor
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
with fake_world(256):
    mesh = make_production_mesh()
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = distribute_tensor(torch.empty(64, 1024), mesh, [Shard(0), Replicate()],
                              src_data_rank=None)
        w = distribute_tensor(torch.empty(1024, 4096), mesh, [Replicate(), Shard(1)],
                              src_data_rank=None)
    with flop_analysis.analyze() as counts:
        y = x @ w
    with FlopCounterMode(display=False) as above:
        x @ w
    with FlopCounterMode(display=False) as local:
        torch.empty(4, 1024) @ torch.empty(1024, 256)
    out["probe"] = {"local": counts.flops, "above": above.get_total_flops(),
                    "plain_local": local.get_total_flops()}
    try:
        fa.flash_attention_cuda(y, y, y)
        out["refused"] = False
    except TypeError as e:
        out["refused"] = "DTensor" in str(e)

# shape-only tensors through the dispatch: the right shapes, the work recorded
with FakeTensorMode():
    q, k = torch.empty(2, 128, 4, 32), torch.empty(2, 128, 2, 32)
    r, u, st = torch.empty(2, 128, 4, 16), torch.empty(4, 16), torch.empty(2, 4, 16, 16)
    xh, dt = torch.empty(2, 128, 4, 16), torch.empty(2, 128, 4)
    A, B = torch.empty(4), torch.empty(2, 128, 8)
    with _sharded.counting() as got:
        o = fa_ops.flash_attention(q, k, k)
        y6, s6 = wkv_ops.wkv6(r, r, r, r, u, st)
        ys = ssd_ops.ssd_scan(xh, dt, A, B, B)
out["shape_only"] = {"shapes": [list(o.shape), list(y6.shape), list(s6.shape), list(ys.shape)],
                     "work": got}
print("RESULT " + json.dumps(out))
"""


ROOT = os.path.join(os.path.dirname(__file__), "..")


def _start(args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    err = tempfile.TemporaryFile(mode="w+")
    return subprocess.Popen([sys.executable, *args], stdout=subprocess.PIPE, stderr=err,
                            text=True, env=env, cwd=ROOT), err


def _finish(started):
    proc, err = started
    out, _ = proc.communicate(timeout=300)
    err.seek(0)
    return proc.returncode, out, err.read()


@pytest.fixture(scope="module")
def cell():
    _, out, err = _finish(_start(["-c", CELL_SCRIPT]))
    line = next((ln for ln in out.splitlines() if ln.startswith("RESULT ")), None)
    assert line is not None, err[-3000:]
    return json.loads(line[len("RESULT "):])


def test_dryrun_cell_counts_local_shards(cell):
    """The reduced qwen3 prefill on the fake 16 x 16 mesh (4 heads do not
    divide "model" 16: "dmodel" mode, heads whole): each attention call is
    the kernel's work at the local batch of 32 / 16 = 2, every head; the
    product probe counts the local shard, 1/256 of what FlopCounterMode
    counts above DTensor."""
    from repro_torch.kernels.flash_attention import kernel as fa

    c = cell["cell"]
    assert c["status"] == "ok", c["reason"]
    cfg = get_config("qwen3-0.6b").reduced()
    flops, n_bytes = fa.work((2, 32768, cfg.num_heads, cfg.resolved_head_dim),
                             (2, 32768, cfg.num_kv_heads, cfg.resolved_head_dim), True, None, 2)
    assert c["kernels"]["flash_attention"] == {"calls": cfg.num_layers,
                                                "flops": cfg.num_layers * flops,
                                                "bytes": cfg.num_layers * n_bytes}
    assert c["flops"] > c["kernels"]["flash_attention"]["flops"]
    p = cell["probe"]
    assert p["local"] == p["plain_local"] == 2 * 4 * 1024 * 256
    assert p["above"] == 256 * p["local"]
    # terms on the H100 constants
    assert c["t_compute"] == pytest.approx(c["flops"] / 989e12)
    assert c["t_memory"] == pytest.approx(c["hbm_bytes"] / 3.35e12)
    assert c["t_collective"] == pytest.approx(c["collective_wire_bytes"] / 450e9)
    assert "two 8-card NVLink domains" in c["link"]


def test_dryrun_cell_collectives(cell):
    """The sequence-parallel residual and the vocab-sharded head need
    collectives: all-gathers and all-reduces, as many as CommDebugMode
    counts, each sized by its output with the ring factors."""
    c = cell["cell"]
    assert c["n_collectives"] == c["n_collectives_comm_debug"] > 0
    assert c["collective_by_type"].get("all-gather", 0) > 0
    assert c["collective_by_type"].get("all-reduce", 0) > 0
    assert c["collective_wire_bytes"] > 0


def test_decode_cell_counts_the_written_slots(cell):
    """A decode step writes one k/v slot a layer into the cache it was given
    (in place), so the cell counts the logits plus those slots, not the
    whole local cache: every rank writes one slot a layer (the owner its new
    k/v, the others one of their own, as XLA's SPMD partitioner lowers the
    update)."""
    c = cell["decode_32k"]
    assert c["status"] == "ok", c["reason"]
    (logits, lsize), *caches = c["leaves"]
    assert len(caches) == 2  # k and v, two layers each: (2, b, t, g, q)
    slots = 0
    for shape, size in caches:
        n_layers, b, t, g, q = shape
        assert n_layers == 2 and t == 32768 // 16  # sequence split over "model"
        slots += n_layers * b * g * q * size
    assert c["output_bytes"] == math.prod(logits) * lsize + slots
    assert c["whole"] > 100 * c["output_bytes"]  # the old count: the whole cache
    assert c["hbm_bytes"] == c["arg_bytes"] + c["output_bytes"]


def test_train_cell_output_bytes_unchanged(cell):
    """A train step returns new params and optimizer state (none written in
    place): every output counts whole, as before the in-place accounting."""
    c = cell["train_4k"]
    assert c["status"] == "ok", c["reason"]
    assert c["output_bytes"] == c["whole"] > 0


def test_in_place_writes_counted_by_storage():
    """``LocalCounter`` records what each in-place op writes, by storage: a
    copy into a view its view, an indexed write its update's elements; an
    output aliasing an argument counts those bytes once, at most its size,
    a new output whole, an untouched argument returned as is nothing."""
    from repro_torch.launch import flop_analysis as fa

    cache, state, keep = torch.zeros(2, 16, 4), torch.zeros(3, 8), torch.zeros(5)
    with fa.analyze() as counts:
        cache[:, 3] = torch.ones(2, 4)                            # copy_ into a view: 8 floats
        cache.index_put_((torch.tensor([0, 1]), torch.tensor([5, 6])), torch.ones(2, 4))  # 8
        state.copy_(torch.ones(3, 8))                             # whole: 24 floats
        state.mul_(2.0)                                           # whole again: 24
        new = cache.sum(1)
    assert counts.writes[fa.storage_key(cache[:, 0])] == 4 * 16
    assert counts.writes[fa.storage_key(state)] == 4 * 48
    args = (cache, state, keep)
    assert fa.output_bytes((new, cache, cache[0], state, keep), args, counts.writes) == \
        new.numel() * 4 + 4 * 16 + state.numel() * 4 + 0
    assert fa.output_bytes((new,), args, counts.writes) == fa.local_bytes(new)


def test_dtensor_refused_by_wrapper(cell):
    assert cell["refused"] is True


def test_shape_only_kernels_record_work(cell):
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.rwkv6 import kernel as wkv6
    from repro_torch.kernels.ssd_scan import kernel as ssd

    s = cell["shape_only"]
    assert s["shapes"] == [[2, 128, 4, 32], [2, 128, 4, 16], [2, 4, 16, 16], [2, 128, 4, 16]]
    want = {"flash_attention": fa.work((2, 128, 4, 32), (2, 128, 2, 32), True, None, 4),
            "wkv6": wkv6.work(2, 128, 4, 16), "ssd_scan": ssd.work(2, 128, 4, 16, 8)}
    for name, (flops, n_bytes) in want.items():
        assert s["work"][name] == {"calls": 1, "flops": flops, "bytes": n_bytes}


def test_report_and_roofline_rows(cell, tmp_path):
    path = tmp_path / "dryrun.json"
    path.write_text(json.dumps([cell["cell"]]))
    table = report.render([cell["cell"]], "16x16")
    assert "| qwen3-0.6b | prefill_32k | ok |" in table
    rows = roofline_report.run(str(path))
    assert rows[0].startswith("roofline.16x16.qwen3-0.6b.prefill_32k,")
    assert "bottleneck=" in rows[0] and rows[-1].startswith("roofline.summary")
    assert roofline_report.run(str(tmp_path / "none.json"))[0].startswith("roofline.missing")
    assert np.isfinite(cell["cell"]["useful_ratio"])


def test_sharded_cards_tool_on_cpu(monkeypatch):
    """``tools/sharded_cards.py --cpu``: reduced starcoder2-15b ("heads"
    mode) and dbrx-132b (2 layers each) on a (1, 4) mesh of 4 gloo ranks,
    within its TOL (1e-5, max |diff| over max |logit|) of the unsharded port,
    no case failed. Run in this process: the ranks are spawned, and no
    process group is made here."""
    monkeypatch.syspath_prepend(os.path.join(ROOT, "tools"))
    import sharded_cards

    assert sharded_cards.TOL == 1e-5
    rows, bad = sharded_cards.run(cpu=True)
    assert bad == 0
    for name in ("starcoder2-15b", "dbrx-132b"):
        r = rows[name][0]
        assert r["finite"] and r["prefill_err"] <= 1e-5 and r["decode_err"] <= 1e-5
    assert rows["starcoder2-15b"][0]["attn_mode"] == "heads"
