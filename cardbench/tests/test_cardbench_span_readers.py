"""The readers of the executor's WAIT spans, on records made by hand: none
with no trace, none with a trace whose idle gaps name no ``pipeline.`` span
(a program without the spans), and the span's gaps over the cards' window
where they are."""
import pytest

from cardbench import harness
from cardbench.tests.tiny import ROOT

GAPS = {"cudaStreamSynchronize": 6.0, "host code between operations": 0.2}


def _record(gaps: dict) -> dict:
    return {"chips": 4, "trace": {"busy_s": 1.6, "window_s": 2.5, "gaps": gaps}}


@pytest.mark.parametrize("metric,span", [("req_wait_idle.pipe4", "pipeline.WAIT_REQ"),
                                         ("ack_wait_idle.pipe4", "pipeline.WAIT_ACK")])
def test_wait_span_reader(metric, span):
    read = harness.Bench(ROOT).reader(metric)
    assert read({}) is None
    assert read(_record(GAPS)) is None
    got = read(_record({**GAPS, "pipeline.WAIT_REQ": 1.2, "pipeline.WAIT_ACK": 0.1}))
    assert got == pytest.approx(100.0 * {"pipeline.WAIT_REQ": 1.2,
                                         "pipeline.WAIT_ACK": 0.1}[span] / (2.5 * 4))
    assert read(_record({**GAPS, "pipeline.finish": 0.3})) == 0.0  # spans, but no such gap
