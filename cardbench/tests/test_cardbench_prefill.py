"""The prefill driver (``drivers/prefill.py``) on tiny cells on the CPU, its
hybrid yardstick (sizes, weights, counts, the span reduction) and what its
run imports.

A sound program comes out correct on a tiny dense cell and a tiny hybrid
one (Zamba2's published layout at tiny sizes), and each fault the cells can
have, planted under the timed path, comes out not correct. The CPU has no
kernel, so the plain versions the CPU dispatch takes are counted as the
kernels' launches, as the card counts the kernels'.
"""
import json
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from cardbench import (calibrate, harness, hybrid, hybrid_roofline, hybrid_weights, roofline,
                       span_trace)
from cardbench.tests.test_cardbench_imports import imported
from cardbench.tests.tiny import ROOT, copy_with_tiny

TINY_HYBRID = {
    "name": "tiny-zamba2", "source": "a test configuration", "hidden_size": 32,
    "num_hidden_layers": 7, "vocab_size": 61, "hybrid_layer_ids": [1, 3, 6],
    "layers_block_type": ["mamba", "hybrid", "mamba", "hybrid", "mamba", "mamba", "hybrid"],
    "num_mem_blocks": 2, "num_attention_heads": 2, "num_key_value_heads": 2,
    "attention_head_dim": 24, "attention_hidden_size": 64, "ffn_hidden_size": 48,
    "intermediate_size": 48, "adapter_rank": 4, "n_mamba_heads": 4, "mamba_headdim": 16,
    "mamba_d_state": 8, "mamba_ngroups": 2, "mamba_d_conv": 4, "mamba_expand": 2,
    "rope_theta": 10000, "rms_norm_eps": 1e-05, "use_shared_mlp_adapter": True,
    "use_shared_attention_adapter": False, "use_mem_rope": True, "add_bias_linear": False,
    "use_conv_bias": True, "time_step_limit": None,
    "port": {"family": "hybrid", "mlp": "geglu", "act": "gelu_erf",
             "norm": "rms_one_plus_scale"}}
TRAFFIC = {"driver": "prefill", "batch": 4, "seq_len": 40, "trace_calls": 1}
CELLS = {  # tiny-dense's window of 16 lies inside the 40 positions, as h2o's 4096 in 4608
    "tiny.prefill": {"config": "tiny-dense", "traffic": "tiny-prefill", "chips": 1,
                     "why": "a test cell", "limits": {"logit_err": 1e-3}},
    "tiny.zamba2": {"config": "tiny-zamba2", "traffic": "tiny-prefill", "chips": 1,
                    "why": "a test cell", "limits": {"logit_err": 1e-3}},
}
REAL = {"tiny.prefill": "h2o.prefill", "tiny.zamba2": "zamba2.prefill"}


def copy_with_prefill(dst):
    """``copy_with_tiny``'s copy, with the tiny hybrid configuration and the
    tiny prefill cells added as files and entries, beside the real ones."""
    root = copy_with_tiny(dst)
    (root / "cardbench" / "configs" / "tiny-zamba2.json").write_text(json.dumps(TINY_HYBRID))
    (root / "cardbench" / "traffic" / "tiny-prefill.json").write_text(json.dumps(TRAFFIC))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name, cell in CELLS.items():
        (root / "cardbench" / "workloads" / f"{name}.json").write_text(json.dumps(cell))
        bench["workloads"].append({"name": name, **{k: cell[k] for k in
                                                    ("config", "traffic", "chips", "why")}})
    for m in bench["end_to_end"] + bench["per_layer"]:
        for tiny, real in REAL.items():
            if real in m.get("workloads", []):
                m["workloads"].append(tiny)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return harness.Bench(copy_with_prefill(tmp_path_factory.mktemp("bench")))


def _counted(kernel, fn):
    def launch(*args, **kw):
        kernel.launches += 1
        return fn(*args, **kw)
    return launch


@pytest.fixture
def kernels(monkeypatch):
    """The CPU's attention and scan counted as the kernels' launches."""
    from repro_torch.kernels.flash_attention import kernel as fk, ops as fo
    from repro_torch.kernels.ssd_scan import kernel as sk, ops as so

    plain = SimpleNamespace(flash=fo.flash_attention, ssd=so.ssd_scan)
    monkeypatch.setattr(fo, "flash_attention", _counted(fk, fo.flash_attention))
    monkeypatch.setattr(so, "ssd_scan", _counted(sk, so.ssd_scan))
    return plain


def run(bench, cell, seconds=0.3, seed=2**31 + 23):
    record = harness.run_cell(bench, cell, seed, seconds, False, time.monotonic(), device="cpu")
    return harness.result(bench, cell, record, False), record


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_prefill_sound(bench, kernels, cell):
    out, record = run(bench, cell)
    assert out["correct"], out["checks"]
    assert record["calls"] > 0 and out["attempted"] == record["calls"] * TRAFFIC["batch"]
    assert set(out["metrics"]) == {"prefill_tokens_per_s", "setup_s"}
    want = {"logit_err", "flash_launches_off"} | ({"ssd_launches_off"} if cell == "tiny.zamba2"
                                                 else set())
    assert set(out["checks"]) == want
    assert list(out)[-1] == "checks" and harness.forbidden_loaded() == []


def _plant(monkeypatch, kernels, fault: str) -> None:
    """Break the program under the timed path in this process."""
    from repro_torch.kernels.flash_attention import ops as fo
    from repro_torch.kernels.ssd_scan import kernel as sk, ops as so
    from repro_torch.models import transformer as tf

    forward = tf.forward
    if fault == "scan_left_out":  # the first mamba layer's scan of every call gives 0
        seen = [0]

        def scan(*args):
            seen[0] += 1
            y = kernels.ssd(*args)
            sk.launches += 1
            return torch.zeros_like(y) if seen[0] % 7 == 1 else y

        monkeypatch.setattr(so, "ssd_scan", scan)
    elif fault == "embedding_zeroed":  # the concat's second half, x0, left at 0
        call = tf._shared_call
        monkeypatch.setattr(tf, "_shared_call", lambda cfg, p, c, x, x0, *a: call(
            cfg, p, c, x, torch.zeros_like(x0), *a))
    elif fault == "half_batch":  # the second half of the prompts answered as the first
        def half(cfg, params, batch, **kw):
            toks = batch["tokens"]
            h = toks.shape[0] // 2
            logits, aux = forward(cfg, params, {"tokens": toks[:h]}, **kw)
            return torch.cat([logits, logits[:toks.shape[0] - h]]), aux

        monkeypatch.setattr(tf, "forward", half)
    elif fault == "answer_altered":  # one position of every sequence
        def altered(cfg, params, batch, **kw):
            logits, aux = forward(cfg, params, batch, **kw)
            logits[:, 0] += 1.0
            return logits, aux

        monkeypatch.setattr(tf, "forward", altered)
    elif fault == "kernel_bypassed":  # attention on the plain path: no launch
        monkeypatch.setattr(fo, "flash_attention", kernels.flash)
    else:
        raise ValueError(fault)


@pytest.mark.parametrize("cell,fault", [
    ("tiny.zamba2", "scan_left_out"), ("tiny.zamba2", "embedding_zeroed"),
    ("tiny.zamba2", "half_batch"), ("tiny.zamba2", "answer_altered"),
    ("tiny.zamba2", "kernel_bypassed"), ("tiny.prefill", "half_batch"),
    ("tiny.prefill", "answer_altered"), ("tiny.prefill", "kernel_bypassed")])
def test_prefill_fault_fails(bench, kernels, monkeypatch, cell, fault):
    _plant(monkeypatch, kernels, fault)
    out, _ = run(bench, cell)
    assert not out["correct"], out["checks"]


def test_parent_port_fails_before_weights(bench, monkeypatch):
    """A port without ``HybridConfig`` refuses the hybrid cell at once."""
    from cardbench.drivers import prefill
    from repro_torch.configs import base

    monkeypatch.delattr(base, "HybridConfig")
    made = []
    monkeypatch.setattr(hybrid_weights, "model", lambda *a: made.append(a))
    with pytest.raises(ImportError):
        prefill.run(harness.run_spec(bench.cell("tiny.zamba2"), [1], 0.1, False,
                                     time.monotonic(), "cpu"))
    assert made == []


def test_hybrid_sizes_and_counts_by_hand():
    """The tiny hybrid's sizes, and its counts written out at 2 x 40."""
    h = hybrid.hybrid_dims(TINY_HYBRID)
    assert (h.d_inner, h.conv_dim, h.calls, h.d_attn) == (64, 96, 3, 64)
    # in: 32 x (64 + 96 + 4); out: 64 x 32
    assert hybrid_roofline.mamba_matmul_params(h) == 32 * 164 + 64 * 32
    # q, k, v: 64 x 24 x 6; o: 2 x 24 x 32; MLP 32 x 96 + 48 x 32; LoRA 4 x (32 + 96); linear
    assert hybrid_roofline.call_matmul_params(h) == (9216 + 1536 + 3072 + 1536 + 512 + 1024)
    assert hybrid_roofline.scan_flops(h, 2, 40) == 4 * 8 * 16 * 4 * 80
    assert hybrid_roofline.scan_bytes(h, 2, 40) == 4 * 80 * (2 * 64 + 4 + 2 * 16)
    assert hybrid_roofline.attention_flops(h, 2, 40) == 4 * 24 * 2 * 2 * (40 * 41 // 2)
    want = (2 * 80 * (7 * 7296 + 3 * 16896 + 32 * 61) + 3 * 4 * 24 * 2 * 2 * 820
            + 7 * 4 * 8 * 16 * 4 * 80)
    assert hybrid_roofline.prefill_flops(h, 2, 40) == want
    assert hybrid_roofline.ssd_least_s(h, 2, 40) == roofline.least_s(
        4 * 8 * 16 * 4 * 80, 4 * 80 * 164)
    assert hybrid_roofline.flash_least_s(h, 2, 40) == roofline.least_s(
        4 * 24 * 2 * 2 * 820, 4 * 2 * 80 * 24 * 4)


def test_published_counts():
    """Zamba2-7B as the file states it: 22.05 GFLOP of products a token, the
    scan bound by its bytes (0.29 ms at 4 x 4096), flash by its operations."""
    h = hybrid.hybrid_dims(json.loads(
        (ROOT / "cardbench/configs/zamba2-7b-instruct.json").read_text()))
    products = (81 * hybrid_roofline.mamba_matmul_params(h)
                + 13 * hybrid_roofline.call_matmul_params(h) + 3584 * 32000)
    assert 2 * products == pytest.approx(22.05e9, rel=1e-3)
    assert hybrid_roofline.ssd_least_s(h, 4, 4096) == pytest.approx(
        4 * 16384 * (2 * 112 * 64 + 112 + 256) / 3.35e12)
    assert hybrid_roofline.flash_least_s(h, 4, 4096) == pytest.approx(962.3e9 / 495e12,
                                                                      rel=1e-4)


def test_weights_are_the_references():
    """The program's tree and the reference's leaves hold the same values."""
    h = hybrid.hybrid_dims(TINY_HYBRID)
    tree = hybrid_weights.model(h, 7, "cpu")
    assert [len(b) for b in tree["blocks"]] == [2, 3, 2, 3, 2, 3, 2]
    torch.testing.assert_close(tree["blocks"][2]["mamba"]["w_in"][1],
                               hybrid_weights.mamba_layer(h, 7, 2, "cpu")["w_in"], rtol=0, atol=0)
    torch.testing.assert_close(tree["blocks"][5]["linear"][0],
                               hybrid_weights.call(h, 7, 2, "cpu")["linear"], rtol=0, atol=0)
    torch.testing.assert_close(tree["shared"][1]["mlp"]["w_out"],
                               hybrid_weights.shared_block(h, 7, 1, "cpu")["w_out"], rtol=0,
                               atol=0)
    dt = torch.nn.functional.softplus(hybrid_weights.mamba_layer(h, 7, 0, "cpu")["dt_bias"])
    assert dt.min() >= 1e-3 * (1 - 1e-5) and dt.max() <= 0.1 * (1 + 1e-5)


def _ev(name, start, end, dev=False, annotation=False):
    from torch.autograd import DeviceType

    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=DeviceType.CUDA if dev else DeviceType.CPU,
                           is_user_annotation=annotation)


def test_span_seconds():
    """Busy device time under each span's annotations, inside the window."""
    events = [_ev("ProfilerStep#1", 100, 200), _ev("hybrid.mamba", 101, 140),
              _ev("hybrid.mamba", 100, 130, dev=True, annotation=True),
              _ev("ssd_scan_kernel", 102, 110, dev=True), _ev("gemm", 108, 125, dev=True),
              _ev("hybrid.shared", 140, 210, dev=True, annotation=True),
              _ev("flash_fwd_kernel", 150, 205, dev=True),
              _ev("ncclDevKernel_AllReduce", 120, 160, dev=True)]
    # mamba: 102..125 = 23; shared: 150..200 (the window ends at 200) = 50
    assert span_trace.span_seconds(events, ("hybrid.mamba", "hybrid.shared", "x")) == {
        "hybrid.mamba": pytest.approx(23e-6), "hybrid.shared": pytest.approx(50e-6)}


@pytest.mark.parametrize("metric", ["mamba_ms.zamba2", "shared_ms.zamba2"])
def test_span_readers(metric):
    read = harness.Bench(ROOT).reader(metric)
    assert read({"trace": {"spans": {}, "calls": 1}}) is None  # a program without the spans
    spans = {"hybrid.mamba": 3.0, "hybrid.shared": 1.5}
    assert read({"trace": {"spans": spans, "calls": 2}}) == 1e3 * spans[
        "hybrid." + metric.split("_")[0]] / 2


def test_hybrid_yardstick_imports_nothing_of_the_program():
    for name in ("hybrid.py", "hybrid_weights.py", "hybrid_roofline.py", "span_trace.py",
                 "reference/zamba2.py"):
        assert "repro_torch" not in imported(ROOT / "cardbench" / name), name
    code = ("import sys; sys.path[:0] = [sys.argv[1]]; import cardbench.reference.zamba2, "
            "cardbench.hybrid_weights, cardbench.hybrid_roofline; print(sorted({m.split('.')[0] "
            "for m in sys.modules} & {'repro_torch', 'jax', 'repro'}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, check=True, timeout=120).stdout.strip()
    assert out == "[]"


def test_prefill_run_path_loads_no_jax():
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/src']; "
            "from cardbench import harness; from cardbench.drivers import prefill; "
            "import repro_torch.runtime.serve, repro_torch.kernels.ssd_scan.kernel, "
            "repro_torch.kernels.flash_attention.kernel; "
            "print(harness.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, check=True, timeout=300).stdout.strip()
    assert out == "[]"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["h2o.prefill", "zamba2.prefill"])
def test_control_fails_where_the_program_passes(cell):
    """On the card, at the cell's own size and a short window: the program
    passes every limit of the cell, and the plain reference with TF32 on,
    put in the program's place, fails at least one."""
    if not torch.cuda.is_available():
        pytest.skip(f"{cell} needs a CUDA card")
    limits = harness.Bench(ROOT).cell(cell)["limits"]
    (reading,) = calibrate.readings(ROOT, cell, [2**31 + 77], 5.0, time.monotonic())
    assert all(reading["program"][k] <= limits[k] for k in limits), reading
    assert any(reading["control"][k] > limits[k] for k in limits), reading
