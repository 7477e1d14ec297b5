"""Document sets and synthetic corpora (the port's own copies)."""
