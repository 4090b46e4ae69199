"""Object-detection demos of the port: the hermetic accuracy checks."""
