"""Launchers: the trainer and its process hygiene."""
