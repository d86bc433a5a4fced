"""The plain references that decide ``correct``: plain PyTorch, no kernel,
no cache, no batching, nothing of the program (a test scans the imports)."""
