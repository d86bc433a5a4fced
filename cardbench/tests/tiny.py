"""Tiny cells for the CPU tests: the real cells' traffic and drivers on a
configuration a CPU runs in a second, written into a copy of the benchmark."""
import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TINY = {"name": "tiny-dense", "source": "a test configuration",
        "hidden_size": 64, "intermediate_size": 96, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 16, "num_hidden_layers": 4, "vocab_size": 97,
        "rms_norm_eps": 1e-05, "rope_theta": 10000.0, "sliding_window": 16,
        "port": {"family": "dense", "mlp": "swiglu", "act": "silu",
                 "norm": "rms_one_plus_scale"}}
TINY_GELU = {**TINY, "name": "tiny-gelu", "sliding_window": None,
             "port": {**TINY["port"], "mlp": "dense", "act": "gelu"}}
TRAFFIC = {
    "tiny-decode": {"driver": "decode", "lanes": 8, "prompt_len": 8, "cache_len": 4000,
                    "sample_lanes": 4, "trace_steps": 2},
    "tiny-pipe": {"driver": "pipeline_ranks", "microbatches": 4, "microbatch_size": 1,
                  "seq_len": 40, "trace_calls": 1},
}
CELLS = {
    "tiny.decode": {"config": "tiny-gelu", "traffic": "tiny-decode", "chips": 1,
                    "why": "a test cell", "limits": {"logit_err": 1e-3}},
    "tiny.pipe4": {"config": "tiny-dense", "traffic": "tiny-pipe", "chips": 4,
                   "why": "a test cell", "limits": {"logit_err": 1e-3}},
}


def copy_with_tiny(dst: Path) -> Path:
    """A copy of the benchmark under ``dst`` with the tiny configurations,
    traffic and cells added as files and entries, as a later change would."""
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "cardbench", dst / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name, cfg in (("tiny-dense", TINY), ("tiny-gelu", TINY_GELU)):
        (dst / "cardbench" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for name, tr in TRAFFIC.items():
        (dst / "cardbench" / "traffic" / f"{name}.json").write_text(json.dumps(tr))
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    for name, cell in CELLS.items():
        (dst / "cardbench" / "workloads" / f"{name}.json").write_text(json.dumps(cell))
        bench["workloads"].append({"name": name, **{k: cell[k] for k in
                                                    ("config", "traffic", "chips", "why")}})
    for m in bench["end_to_end"] + bench["per_layer"]:
        for real, tiny in (("starcoder2.decode", "tiny.decode"), ("h2o.pipe4", "tiny.pipe4")):
            if real in m.get("workloads", []):
                m["workloads"].append(tiny)
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst
