"""Entropy coding and the file codec of the port (Ballé-17 kind)."""
