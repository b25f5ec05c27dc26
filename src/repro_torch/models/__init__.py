"""Model definitions: the dense GQA transformer and its substrate."""
