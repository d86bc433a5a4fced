"""The port's paper-benchmark twins (``repro_torch.benchmarks.paper_repro``,
``dse_bench`` and ``run``) against the JAX package's root ``benchmarks/``:
the cheap figures (Fig. 2(c), Fig. 3, Fig. 6(a), Fig. 6(b), Table III) row
for row on their derived fields (not the wall-clock column); the ``--ci``
conformance points field for field (not their wall seconds), written under
the working directory's ``build/``; one ``dse_bench --ci`` case's call
counts and gates; and the harness's ``ERROR`` rows and exit code. The
simulated design points, decode, serving, transformer and multi-tenant rows
take seconds to tens of seconds each and run on the card machine's host
(``chip_smoke.py``'s ``serve`` phase)."""
import importlib.util
import json
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")  # the machine with the card has no JAX

from repro.compiler import zoo as jzoo  # noqa: E402
from repro.dse import explore as jexplore  # noqa: E402
from repro_torch.benchmarks import dse_bench, paper_repro, run  # noqa: E402
from repro_torch.compiler import zoo  # noqa: E402
from repro_torch.dse import explore  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CHEAP = ["fig2c_isu_latency", "fig3_two_pu_pipeline", "fig6a_single_batch",
         "fig6b_multi_batch", "table3_comparison"]


def _reference(name):
    """The JAX package's ``benchmarks/<name>.py``, loaded from its file."""
    spec = importlib.util.spec_from_file_location(f"_jax_bench_{name}",
                                                  ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_paper():
    return _reference("paper_repro")


@pytest.fixture(scope="module")
def resnet_dse():
    """``explore(resnet50(256), tolerance=0.01)`` in each package, as
    ``run()`` shares it between Fig. 6(a), 6(b) and Table III."""
    return {"jax": jexplore(jzoo.resnet50(256), tolerance=0.01),
            "torch": explore(zoo.resnet50(256), tolerance=0.01)}


def _derived(rows):
    """``name,us_per_call,derived`` rows without the wall-clock column."""
    out = []
    for row in rows:
        name, _, derived = row.split(",", 2)
        out.append((name, derived))
    return out


@pytest.mark.parametrize("fig", CHEAP)
def test_cheap_figures_equal_jax(fig, ref_paper, resnet_dse):
    args = {"jax": (), "torch": ()}
    if fig not in ("fig2c_isu_latency", "fig3_two_pu_pipeline"):
        args = {k: (v,) for k, v in resnet_dse.items()}
    got = _derived(getattr(paper_repro, fig)(*args["torch"]))
    want = _derived(getattr(ref_paper, fig)(*args["jax"]))
    assert got == want and got


def test_ci_points_equal_jax(ref_paper, tmp_path, monkeypatch, capsys):
    """``python -m repro_torch.benchmarks.paper_repro --ci`` in a fresh
    working directory: exit 0, its artifact at ``build/BENCH_ci.json``
    there, every point within its tolerance and equal to the reference's
    ``ci_points()`` but for the wall seconds."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["paper_repro", "--ci"])
    assert paper_repro.main() == 0
    got = json.loads((tmp_path / "build" / "BENCH_ci.json").read_text())
    want = ref_paper.ci_points()
    strip = [{k: v for k, v in p.items() if k != "sim_wall_s"} for p in want]
    assert [{k: v for k, v in p.items() if k != "sim_wall_s"} for p in got["points"]] == strip
    assert got["ok"] and all(p["ok"] for p in got["points"]) and len(strip) == 8
    assert "-> build/BENCH_ci.json" in capsys.readouterr().out


def test_dse_bench_case_counts_equal_jax():
    """One ``--ci`` case through all three engines: the port's STATS call
    counts and gates equal the reference's (zero codegen while exploring,
    one analysis per graph)."""
    ref = _reference("dse_bench")
    keys = ("counts_batched", "counts_scalar", "counts_ref", "gate_zero_codegen",
            "gate_one_analysis_per_graph", "n_single", "n_multi_batched", "n_multi_ref")
    got = dse_bench._single_case("explore.tiny_cnn",
                                 lambda: zoo.tiny_cnn(channels=(16, 32, 32), hw=16))
    want = ref._single_case("explore.tiny_cnn",
                            lambda: jzoo.tiny_cnn(channels=(16, 32, 32), hw=16))
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["gate_zero_codegen"] and got["gate_one_analysis_per_graph"]
    assert got["counts_batched"]["codegen_calls"] == 0 < got["counts_ref"]["codegen_calls"]


def test_harness_reports_failed_modules(tmp_path, monkeypatch, capsys):
    """A module that fails to import or to run prints its ``ERROR`` row as
    the reference does, the others still print theirs, and the harness
    exits 1; with every module working it exits 0."""
    monkeypatch.chdir(tmp_path)  # no dryrun.json here: the roofline hint row
    bad = tmp_path / "_bench_that_fails.py"
    bad.write_text("def run():\n    raise RuntimeError('broken bench')\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    rr = "repro_torch.benchmarks.roofline_report"
    assert run.main([], modules=(rr, "_bench_that_fails", "_no_such_bench")) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert out[1].startswith("roofline.missing,,") and out[2].startswith(f"{rr}.total,")
    assert out[3:] == ["_bench_that_fails,ERROR,run_failed", "_no_such_bench,ERROR,import_failed"]
    assert run.main(["--only", "nothing matches"], modules=(rr,)) == 0
    assert capsys.readouterr().out.splitlines()[1].startswith(f"{rr}.total,")
    assert run.MODULES == tuple(f"repro_torch.benchmarks.{m}" for m in
                                ("paper_repro", "kernel_bench", "roofline_report", "gpu_dse"))
