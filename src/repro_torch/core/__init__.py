"""Integer numerics contract of the port (``core.inumerics``)."""
