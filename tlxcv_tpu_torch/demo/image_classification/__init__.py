"""Image-classification demos of the port."""
