"""The port's dry run (``repro_torch.launch``) against ``repro.launch``: the
meta stand-ins' shapes and dtypes against JAX's ``ShapeDtypeStruct``s for
all ten configs, ``model_flops_per_chip`` against JAX's; then, in one
subprocess (the fake process group of 256 ranks is process-wide), a dry-run
cell of reduced qwen3-0.6b on the fake 16 x 16 mesh with the local-shard
FLOP count checked against ``FlopCounterMode`` on plain tensors of the
local shapes, the kernels' shape-only work, the collectives against
``CommDebugMode``, a DTensor refused by the CUDA wrappers, and the output
bytes of a decode cell (the slots written in place) and a train cell, the
memory term, temp bytes, an all-to-all, the collective tiers and the
cells the full grid failed on; ``flop_analysis`` against
``hlo_analysis`` on tiny functions; and ``tools/sharded_cards.py --cpu``
(its 4 ranks spawned on the CPU)."""
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
                  "hbm_bytes": c.hbm_bytes, "arg_bytes": c.arg_bytes,
                  "op_output_bytes": c.op_output_bytes, "temp_bytes": c.temp_bytes,
                  "flops": c.flops, "flops_by_op": c.flops_by_op,
                  "flops_by_phase": c.flops_by_phase, **seen}
flop_analysis.output_bytes = count_out

# the cells the full grid failed on, at full width and 2 layers, under the
# policy of their full depth (fsdp): the MoE combine over a capacity of 40
# on "model" 16 (dbrx's 16 experts, grok's 8), and danube's decode heads
# split unevenly at batch 1
from repro_torch.launch import dryrun as dr
make_policy = dr.make_policy
for arch, shape in (("dbrx-132b", "decode_32k"), ("grok-1-314b", "decode_32k"),
                    ("h2o-danube-3-4b", "long_500k")):
    full = get_config(arch)
    dr.make_policy = lambda c, mesh: replace(make_policy(c, mesh),
                                             fsdp=make_policy(full, mesh).fsdp)
    c = dr.run_cell(arch, shape, cfg=replace(full, num_layers=2), verbose=False)
    out[f"repaired {arch} {shape}"] = {"status": c.status, "reason": c.reason}
# reduced dbrx-132b on FSDP at decode_32k: an expert product's view of a
# shard a redistribution laid out otherwise than its global strides
dr.make_policy = lambda c, mesh: replace(make_policy(c, mesh), fsdp=True)
c = dr.run_cell("dbrx-132b", "decode_32k", cfg=get_config("dbrx-132b").reduced(), verbose=False)
out["fsdp reduced dbrx-132b decode_32k"] = {"status": c.status, "reason": c.reason}
dr.make_policy = make_policy

# train_4k at full width and 2 layers: what is live and written per card
for arch in ("qwen3-0.6b", "dbrx-132b"):
    c = dr.run_cell(arch, "train_4k", cfg=replace(get_config(arch), num_layers=2), verbose=False)
    out[f"train {arch}"] = {"status": c.status, "reason": c.reason, "temp_bytes": c.temp_bytes,
                            "top_hbm_ops": c.top_hbm_ops, "top_live_ops": c.top_live_ops}

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

    # a Shard(0) -> Shard(1) move on "model": one all-to-all of the local
    # input (16, 256) fp32, however the CPU mesh carries it out
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol
    with FakeTensorMode(allow_non_fake_inputs=True):
        a = distribute_tensor(torch.empty(256, 256), mesh, [Replicate(), Shard(0)],
                              src_data_rank=None)
    with flop_analysis.analyze() as counts:
        b = a.redistribute(mesh, [Replicate(), Shard(1)])
    out["alltoall"] = {k: getattr(counts, k) for k in (
        "collective_wire_bytes", "collective_bytes_by_type", "collective_ops",
        "comm_debug_ops", "op_output_bytes", "temp_bytes")}
    out["alltoall"]["local"] = list(b.to_local().shape)

    # the tiers: "model" (ranks 0-15, two boards) and ranks 0-7 (one board)
    board = dist.new_group(list(range(8)))
    with FakeTensorMode():
        t = torch.empty(1024)
    with flop_analysis.analyze() as counts:
        funcol.all_reduce(t, "sum", mesh.get_group("model"))
        funcol.all_reduce(t, "sum", board)
    out["tiers"] = {k: getattr(counts, k) for k in (
        "collective_wire_bytes", "collective_wire_bytes_nvlink",
        "collective_wire_bytes_network", "top_collectives")}

    # live bytes of a step whose peak is known: two local (4, 1024) fp32
    # shards (16 KiB each) at most at once
    def step(x):
        y = x * 2
        z = y * 3
        del y
        return z + 1
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = distribute_tensor(torch.empty(64, 1024), mesh, [Shard(0), Replicate()],
                              src_data_rank=None)
    with flop_analysis.analyze() as counts:
        step(x)
    out["temp"] = {"temp_bytes": counts.temp_bytes, "op_output_bytes": counts.op_output_bytes}

# shape-only tensors through the dispatch: the right shapes, the work recorded
with FakeTensorMode():
    q, k = torch.empty(2, 128, 4, 32), torch.empty(2, 128, 2, 32)
    r, u, st = torch.empty(2, 128, 4, 16), torch.empty(4, 16), torch.empty(2, 4, 16, 16)
    xh, dt = torch.empty(2, 128, 4, 16), torch.empty(2, 128, 4)
    A, B = torch.empty(4), torch.empty(2, 128, 8)
with flop_analysis.analyze() as got:
    o = fa_ops.flash_attention(q, k, k)
    y6, s6 = wkv_ops.wkv6(r, r, r, r, u, st)
    ys = ssd_ops.ssd_scan(xh, dt, A, B, B)
out["shape_only"] = {"shapes": [list(o.shape), list(y6.shape), list(s6.shape), list(ys.shape)],
                     "work": got.kernels}
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
    # terms on the H100 constants: each collective at its group's tier
    assert c["t_compute"] == pytest.approx(c["flops"] / 989e12)
    assert c["t_memory"] == pytest.approx(c["hbm_bytes"] / 3.35e12)
    assert c["collective_wire_bytes_nvlink"] + c["collective_wire_bytes_network"] == \
        pytest.approx(c["collective_wire_bytes"])
    assert c["t_collective"] == pytest.approx(c["collective_wire_bytes_nvlink"] / 450e9
                                              + c["collective_wire_bytes_network"] / 50e9)
    assert "slowest hop" in c["link"] and "8-card board" in c["link"]


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
    assert c["hbm_bytes"] == c["arg_bytes"] + c["op_output_bytes"]


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


@pytest.mark.parametrize("which", ["prefill_32k", "decode_32k", "train_4k"])
def test_cell_memory_terms(cell, which):
    """Producer-side bytes: the arguments once plus every op's output
    (``op_output_bytes``), at or above what the step writes into its
    outputs; a peak of live bytes; the FLOPs split by op and by phase, each
    split summing to the total (a train step: forward, backward and the
    remat recompute; a serving step: forward only)."""
    c = cell["cell"] if which == "prefill_32k" else cell[which]
    assert c["status"] == "ok", c["reason"]
    assert c["hbm_bytes"] == c["arg_bytes"] + c["op_output_bytes"]
    assert c["op_output_bytes"] >= c["output_bytes"] > 0
    assert c["temp_bytes"] > 0
    assert sum(c["flops_by_op"].values()) == pytest.approx(c["flops"], rel=1e-12)
    assert sum(c["flops_by_phase"].values()) == pytest.approx(c["flops"], rel=1e-12)
    phases = {"forward", "backward", "recompute"} if which == "train_4k" else {"forward"}
    assert set(c["flops_by_phase"]) == phases
    if which == "train_4k":
        assert c["flops_by_op"]["flash_attention.backward"] > 0
        assert c["flops_by_phase"]["backward"] > c["flops_by_phase"]["forward"]


def test_alltoall_counted_as_one(cell):
    """A Shard(0) -> Shard(1) move on "model" (16 ranks) is one all-to-all
    of the local (16, 256) fp32 input: (n-1)/n of its 16 KiB on the wire,
    its output once in the HBM bytes and the live bytes, however the CPU
    mesh carries it out (an all-gather and a chunk); CommDebugMode counts
    one collective too."""
    a = cell["alltoall"]
    assert a["local"] == [256, 16]
    local = 16 * 256 * 4
    assert a["collective_bytes_by_type"] == {"all-to-all": local}
    assert a["collective_wire_bytes"] == 15 / 16 * local
    assert a["collective_ops"] == a["comm_debug_ops"] == 1
    assert a["op_output_bytes"] == a["temp_bytes"] == local


def test_collective_tiers(cell):
    """An all-reduce of 4 KiB over "model" (ranks 0-15, two 8-card boards)
    is on the network tier, one over ranks 0-7 (one board) on NVLink."""
    t = cell["tiers"]
    assert t["collective_wire_bytes_network"] == 2 * 15 / 16 * 4096
    assert t["collective_wire_bytes_nvlink"] == 2 * 7 / 8 * 4096
    assert t["collective_wire_bytes"] == \
        t["collective_wire_bytes_network"] + t["collective_wire_bytes_nvlink"]
    assert [r["op"] for r in t["top_collectives"]] == [
        "all-reduce float32[1024] n=16 network", "all-reduce float32[1024] n=8 nvlink"]


def test_temp_bytes_known_peak(cell):
    """y = x * 2, z = y * 3, y freed, z + 1 on a (4, 1024) fp32 local
    shard: three outputs of 16 KiB written, at most two alive at once."""
    assert cell["temp"] == {"temp_bytes": 2 * 16384, "op_output_bytes": 3 * 16384.0}


@pytest.mark.parametrize("which", ["dbrx-132b decode_32k", "grok-1-314b decode_32k",
                                   "h2o-danube-3-4b long_500k"])
def test_repaired_grid_cells(cell, which):
    """Cells the full grid failed on under torch 2.13 (full width, 2
    layers, the policy of their full depth): the MoE combine over a
    capacity of 40 on "model" 16 (``pspec.fit_sum``), and danube's decode
    probabilities, its 32 heads split over "data" 16, viewed as 8 groups
    (``pspec.fit_split``)."""
    c = cell[f"repaired {which}"]
    assert c == {"status": "ok", "reason": ""}


# temp_bytes of the same cells (full width, 2 layers, train_4k on 16 x 16)
# before the loss's vocab-parallel pick, the skipped MoE token slice and the
# layers unbound once: the parent tree traced under torch 2.13, in GiB
PARENT_TRAIN_TEMP_GIB = {"qwen3-0.6b": 670.18, "dbrx-132b": 443.56}


@pytest.mark.parametrize("arch", sorted(PARENT_TRAIN_TEMP_GIB))
def test_train_cell_holds_no_global_tensor(cell, arch):
    """A sharded train step (full width, 2 layers, 16 x 16) writes nothing
    of the global logits' shape (the label pick's gradient stays on each
    rank's vocab shard), no ``slice_backward`` over all tokens (the MoE
    slice is skipped where it takes every token), no ``select_backward``
    (each stacked leaf is unbound once); its peak of live bytes is below
    the parent's and within one card's memory."""
    from repro_torch import hw

    c = cell[f"train {arch}"]
    assert c["status"] == "ok", c["reason"]
    cfg = get_config(arch)
    tokens = 256 * 4096
    ops = [r["op"] for r in c["top_hbm_ops"] + c["top_live_ops"]]
    assert ops
    for op in ops:
        assert not op.endswith(f"[256, 4096, {cfg.vocab_size}]"), op
        assert not op.endswith(f"[128, 4096, {cfg.vocab_size}]"), op
        assert not op.startswith("select_backward"), op
        assert not (op.startswith("slice_backward") and f"[{tokens}, " in op), op
    assert c["temp_bytes"] < PARENT_TRAIN_TEMP_GIB[arch] * 2**30 / 10
    assert c["temp_bytes"] < hw.HBM_CAPACITY_BYTES


def test_fsdp_moe_decode_traces(cell):
    """Reduced dbrx-132b forced to FSDP at decode_32k on the 16 x 16 mesh:
    the expert product's view of ``h`` raised under torch 2.13 (``Cannot
    view a tensor with shape [4, 2, 40, 16, 1]``) before ``pspec.laid_out``."""
    assert cell["fsdp reduced dbrx-132b decode_32k"] == {"status": "ok", "reason": ""}


def _hlo_counts(fn, *xs, donate=()):
    from repro.launch import hlo_analysis

    return hlo_analysis.analyze(jax.jit(fn, donate_argnums=donate).lower(*xs).compile().as_text())


@pytest.mark.parametrize("case", ["matmul", "update", "chain"])
def test_producer_bytes_match_hlo_analysis(case):
    """``flop_analysis.analyze`` against ``hlo_analysis.analyze`` of the
    compiled HLO on the same numpy inputs: a matmul's FLOPs and output
    bytes equal; a donated cache's dynamic-update-slice counted by its
    update on both sides; an elementwise chain at or above JAX's (XLA fuses
    tanh(a * b + c) into one output, eager PyTorch writes three: equal
    where XLA makes one op of one op)."""
    import jax.numpy as jnp
    from repro_torch.launch import flop_analysis as fa

    rng = np.random.default_rng(0)
    if case == "matmul":
        a, b = (rng.standard_normal(s, dtype=np.float32) for s in ((64, 128), (128, 32)))
        want = _hlo_counts(lambda x, y: x @ y, a, b)
        with fa.analyze() as got:
            torch.from_numpy(a) @ torch.from_numpy(b)
        assert got.flops == want.flops == 2 * 64 * 128 * 32
        assert got.op_output_bytes == want.hbm_bytes == 64 * 32 * 4
    elif case == "update":
        cache = np.zeros((2, 1024, 64), np.float32)
        x = rng.standard_normal((2, 1, 64), dtype=np.float32)
        want = _hlo_counts(lambda c, u: jax.lax.dynamic_update_slice(c, u, (0, 5, 0)),
                           cache, x, donate=(0,))
        tc, tx = torch.from_numpy(cache.copy()), torch.from_numpy(x)
        with fa.analyze() as got:
            tc[:, 5] = tx[:, 0]
        assert got.op_output_bytes == want.hbm_bytes == x.nbytes
    else:
        a, b, c = (rng.standard_normal((256, 256), dtype=np.float32) for _ in range(3))
        want = _hlo_counts(lambda x, y, z: jnp.tanh(x * y + z), a, b, c)
        with fa.analyze() as got:
            torch.tanh(torch.from_numpy(a) * torch.from_numpy(b) + torch.from_numpy(c))
        assert want.hbm_bytes == a.nbytes
        assert got.op_output_bytes == 3 * want.hbm_bytes >= want.hbm_bytes
        assert got.temp_bytes == 2 * a.nbytes  # a * b, then a * b + c, then tanh


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
    assert f"temp_gib={cell['cell']['temp_bytes'] / 2**30:.2f};" in rows[0]
    assert f"| {report.fmt_bytes(cell['cell']['temp_bytes'])} |" in table
    skipped = dict(cell["cell"], shape="long_500k", status="skipped", reason="no long context")
    assert "| qwen3-0.6b | long_500k | skipped: no long context |" in report.render(
        [cell["cell"], skipped], "16x16")
    assert roofline_report.run(str(tmp_path / "none.json"))[0].startswith("roofline.missing")
    assert np.isfinite(cell["cell"]["useful_ratio"])


def test_sharded_cards_recurrent_criterion(monkeypatch):
    """Beyond TOL a recurrent model's sharded logits are held as
    ``chip_smoke.py`` holds rwkv6-7b: softmax within 2e-2 and every argmax
    equal, or no farther than the re-batched one-card run with no fewer
    equal argmaxes."""
    monkeypatch.syspath_prepend(os.path.join(ROOT, "tools"))
    import sharded_cards

    noise = {"prefill": (2e-4, 1e-3, 4090)}
    ok = sharded_cards.recurrent_ok

    def row(err, prob, top1):
        return {"prefill_err": err, "prefill_prob": prob, "prefill_top1": top1}

    assert ok(row(3e-4, 1e-3, 4096), noise, "prefill", 4096)
    assert ok(row(2e-4, 1e-3, 4090), noise, "prefill", 4096)
    assert not ok(row(3e-4, 1e-3, 4095), noise, "prefill", 4096)
    assert not ok(row(1e-4, 1e-3, 4089), noise, "prefill", 4096)
    assert not ok(row(1e-4, 3e-2, 4096), noise, "prefill", 4096)


def test_sharded_cards_tool_on_cpu(monkeypatch):
    """``tools/sharded_cards.py --cpu``: reduced starcoder2-15b ("heads"
    mode), dbrx-132b, rwkv6-7b and zamba2-7b (2 layers each) on a (1, 4)
    mesh of 4 gloo ranks, within its TOL (1e-5, max |diff| over max |logit|)
    of the unsharded port; the AdamW step of reduced qwen3-0.6b (its 2 k/v
    groups narrowed by the 4 "model" ranks) within ``_check_step``'s
    tolerances of the same step unsharded, shard by shard; no case failed.
    Run in this process: the ranks are spawned, and no process group is
    made here."""
    monkeypatch.syspath_prepend(os.path.join(ROOT, "tools"))
    import sharded_cards

    assert sharded_cards.TOL == 1e-5
    assert (sharded_cards.STEP_RTOL, sharded_cards.MOMENT_TOL) == (1e-5, 1e-4)
    rows, bad = sharded_cards.run(cpu=True)
    assert bad == 0
    for name in ("starcoder2-15b", "dbrx-132b", "rwkv6-7b", "zamba2-7b"):
        r = rows[name][0]
        assert r["finite"] and r["prefill_err"] <= 1e-5 and r["decode_err"] <= 1e-5
    assert rows["starcoder2-15b"][0]["attn_mode"] == "heads"
    for r in rows["qwen3-0.6b train step"]:
        assert r["finite"] and all(v <= 1.0 for v in r["worst"].values()), r["worst"]
