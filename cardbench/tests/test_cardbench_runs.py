"""Whole runs of the harness on the CPU at tiny sizes (the chip check
skipped): a sound program comes out correct, and each fault the cell can
have, planted under the timed path, comes out not correct."""
import time

import pytest

from cardbench import harness
from cardbench.tests import faults
from cardbench.tests.tiny import copy_with_tiny

DECODE_FAULTS = ("state_unchanged", "half_batch", "answer_altered")
PIPE_FAULTS = ("state_unchanged", "half_batch", "exchange_left_out", "answer_altered")


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return harness.Bench(copy_with_tiny(tmp_path_factory.mktemp("bench")))


def run(bench, cell, seconds=0.3, seed=2**31 + 11):
    record = harness.run_cell(bench, cell, seed, seconds, False, time.monotonic(), device="cpu")
    return harness.result(bench, cell, record, False), record


def test_decode_sound(bench):
    out, record = run(bench, "tiny.decode")
    assert out["correct"], out["checks"]
    assert out["attempted"] == record["decode_tokens"] > 0
    assert set(out["metrics"]) == {"decode_tokens_per_s", "token_gap_p95_ms", "setup_s"}
    assert list(out)[-1] == "checks"
    assert harness.forbidden_loaded() == []


@pytest.mark.parametrize("fault", DECODE_FAULTS)
def test_decode_fault_fails(bench, monkeypatch, fault):
    faults.plant_decode(monkeypatch, fault)
    out, _ = run(bench, "tiny.decode")
    assert not out["correct"], out["checks"]


def test_pipeline_sound(bench):
    out, record = run(bench, "tiny.pipe4", seconds=0.5)
    assert out["correct"], out["checks"]
    assert record["calls"] > 0 and out["attempted"] == record["calls"] * 4
    assert set(out["metrics"]) == {"prefill_tokens_per_s", "setup_s"}
    assert record["forbidden_modules"] == []


@pytest.mark.parametrize("fault", PIPE_FAULTS)
def test_pipeline_fault_fails(bench, monkeypatch, fault):
    from cardbench.drivers import pipeline_ranks

    monkeypatch.setenv(faults.FAULT_ENV, fault)
    monkeypatch.setattr(pipeline_ranks, "rank_body", faults.faulty_rank_body)
    out, _ = run(bench, "tiny.pipe4", seconds=0.5)
    assert not out["correct"], out["checks"]
