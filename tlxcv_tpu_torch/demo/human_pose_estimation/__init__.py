"""Human-pose demos of the port: the hermetic accuracy check."""
