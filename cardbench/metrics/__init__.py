"""Metric readers, one file a metric of ``BENCHMARK.json``, named after it:
``read(record) -> float | None``, None where the record of a run holds
nothing for the metric (``harness.py``)."""
