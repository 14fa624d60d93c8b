"""Part of myscaledb_tpu_torch (see the package docstring)."""
