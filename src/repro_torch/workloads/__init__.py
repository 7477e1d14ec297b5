"""Corpus workloads of the port: document clustering (k-centers, k-medoids)."""
