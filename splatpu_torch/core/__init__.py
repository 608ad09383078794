"""See the package docstring of ``splatpu_torch``."""
