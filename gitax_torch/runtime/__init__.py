"""See the package docstring of gitax_torch."""
