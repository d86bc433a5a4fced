"""setup_s: seconds from the process's first line to the window's start
(loading, weights, warm-up and, in a checkout's first run, the kernel build)."""


def read(record: dict):
    return record.get("setup_s")
