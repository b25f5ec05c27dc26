"""Fault tolerance of the training loop and the elastic restore over a
mesh."""
