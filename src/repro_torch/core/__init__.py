"""Codec, archive format, decoder and the compressed-resident store."""
