"""CPU tests of the benchmark (and its card-only cases, which skip without
CUDA cards): ``python -m pytest -q cardbench/tests`` from the checkout's root."""
