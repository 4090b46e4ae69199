"""Face-recognition demos of the port: the hermetic accuracy check."""
