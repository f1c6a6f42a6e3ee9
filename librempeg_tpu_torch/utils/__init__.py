"""utils layer of the port (see the package docstring)."""
