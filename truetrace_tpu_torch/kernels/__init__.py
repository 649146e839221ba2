"""See the package docstring (truetrace_tpu_torch/__init__.py)."""
