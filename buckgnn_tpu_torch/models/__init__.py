"""Model family of the port."""
