"""The benchmark of ``repro_torch``, the PyTorch and CUDA port, on NVIDIA H100 cards.

One command runs one cell of ``BENCHMARK.json`` for a fixed number of seconds::

    python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: a cell in ``workloads/<cell>.json`` names its
configuration (``configs/<config>.json``) and its traffic
(``traffic/<traffic>.json``), the traffic names its driver
(``drivers/<driver>.py``), and each metric of ``BENCHMARK.json`` is read by
``metrics/<metric>.py``. The yardstick (weights and inputs from the seed,
operation and byte counts, peaks, the plain reference, the comparison that
decides ``correct``) lives here and imports nothing of the JAX package.
"""
