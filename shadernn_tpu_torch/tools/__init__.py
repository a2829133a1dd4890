"""Tools of the port (data generators for evaluation so far)."""
