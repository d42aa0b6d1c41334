"""Models of the port (NCHW modules)."""
