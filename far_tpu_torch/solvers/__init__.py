"""Part of far_tpu_torch (see the package docstring)."""
