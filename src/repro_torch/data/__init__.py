"""Data pipelines of the port (NumPy only)."""
