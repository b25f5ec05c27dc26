"""Launchers (the trainer and the server), their process hygiene, and
device meshes with the data-parallel process group."""
