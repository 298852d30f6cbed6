"""MPS input: the pure-Python reader (mps.py) and the native one
(native_mps.py)."""
