"""codecs/h264 layer of the port (see the package docstring)."""
