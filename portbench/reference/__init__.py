"""The plain reference of the port's benchmark: NumPy only."""
