"""Synthetic corpora and the tiling used to reach resident-scale archives."""
