"""The benchmark of `hite_tpu_torch` (see README.md)."""
