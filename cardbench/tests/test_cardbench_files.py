"""Every file of BENCHMARK.json loads and names pieces that exist, within
the limits the benchmark's contract sets on names, units and keys."""
import ast
import json
import re

import pytest

from cardbench import harness, model_config
from cardbench.tests.tiny import ROOT, copy_with_tiny

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|head|expert|latent|state|proj")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cardbench"] and BENCH["command"][1] == "cardbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


def test_names_units_and_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert not any(WIDTHS.search(k) for k in c["reduced"]), c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in METRICS:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    assert len(set(CELLS)) == len(CELLS)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_file_matches_benchmark(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    c = harness.Bench(ROOT).cell(cell)
    assert {k: c[k] for k in ("config", "traffic", "chips", "why")} == \
        {k: entry[k] for k in ("config", "traffic", "chips", "why")}
    assert (ROOT / "cardbench" / "drivers" / f"{c['traffic_spec']['driver']}.py").exists()
    assert c["limits"] and all(v >= 0 for v in c["limits"].values())
    e2e = [m["name"] for m in harness.Bench(ROOT).metrics(cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = harness.Bench(ROOT).metrics(cell, True)
    assert layer and all(m["moves"] in e2e for m in layer)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(entry):
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert set(entry["reduced"]) == set(cfg["changed_from_source"])
    assert all(k in cfg for k in entry["reduced"])
    d = model_config.dims(cfg)
    assert d.heads % d.kv_heads == 0 and d.layers > 0


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_exists(metric):
    reader = harness.Bench(ROOT).reader(metric)
    assert reader({}) is None  # a record with nothing to read gives nothing


def test_dropped_in_pieces_are_found(tmp_path):
    """A cell, a configuration, a traffic mix and a metric added to a copy as
    files and entries are found by name, with no code edited."""
    root = copy_with_tiny(tmp_path)
    (root / "cardbench" / "metrics" / "steps.decode.py").write_text(
        "def read(record):\n    return len(record['token_gaps_s']) if 'token_gaps_s' in record "
        "else None\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "steps.decode", "unit": "steps", "better": "higher",
                              "source": "host_clock", "layer": "entry points",
                              "moves": "decode_tokens_per_s", "workloads": ["tiny.decode"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = harness.Bench(root)
    cell = bench.cell("tiny.decode")
    assert cell["config_spec"]["name"] == "tiny-gelu" and cell["traffic_spec"]["lanes"] == 8
    assert "steps.decode" in [m["name"] for m in bench.metrics("tiny.decode", True)]
    assert bench.reader("steps.decode")({"token_gaps_s": [0.1, 0.2]}) == 2


def test_readers_are_small_and_plain():
    """A reader imports nothing of the program."""
    for path in (ROOT / "cardbench" / "metrics").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] if isinstance(node, ast.Import) \
                    else [node.module or ""]
                assert not any(n.split(".")[0] == "repro_torch" for n in names), path
