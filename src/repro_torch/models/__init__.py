"""Models of the port: the transformer's serving path (dense GQA, MLA,
MoE) and NequIP's (energies and forces)."""
