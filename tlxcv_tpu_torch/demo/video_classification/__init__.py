"""Video-classification demos of the port: the hermetic accuracy check."""
