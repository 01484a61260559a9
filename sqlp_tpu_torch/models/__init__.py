"""See the package docstring of sqlp_tpu_torch."""
