"""codecs/mpeg4 layer of the port (see the package docstring)."""
