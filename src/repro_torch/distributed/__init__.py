"""Fault tolerance of the training loop (single card)."""
