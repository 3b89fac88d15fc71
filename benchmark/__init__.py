"""The benchmark of emsar_tpu_torch (see README.md)."""
