"""Port of the matching karanta_tpu sub-package (see the package docstring)."""
