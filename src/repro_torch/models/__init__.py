"""Model layers of the port (dense transformer and rwkv paths)."""
