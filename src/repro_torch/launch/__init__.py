"""The dry run of the port: every (architecture x input shape) cell traced on
a fake 256- or 512-rank mesh with no card and no allocation, and its
per-device roofline terms on H100 constants."""
