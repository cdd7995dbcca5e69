"""The plain float64 reference that decides ``correct`` (imports nothing of
the program)."""
