"""The benchmark of hprlp_tpu_torch: LPs solved per second through its
front doors, at published instance shapes, on one H100 (see README.md)."""
