"""Model layers of the port (dense transformer path)."""
