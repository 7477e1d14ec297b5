"""Graph networks of the port: NequIP's serving path (energies and forces).

Counterpart of ``repro.models.gnn``: ``nequip.py`` (the model, its
aggregation on kernel B9 under autograd), ``so3.py`` (spherical harmonics
and Clebsch-Gordan tensors) and ``sampler.py`` (host-side graphs and the
fanout sampler, numpy).
"""
