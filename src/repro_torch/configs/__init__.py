"""Config registry of the port: the public LM architectures.

Importing this package registers every architecture of ``lm_archs``.
"""

from repro_torch.configs import lm_archs  # noqa: F401  (registers the archs)
from repro_torch.configs.base import ArchSpec, ShapeCell, get_spec

__all__ = ["ArchSpec", "ShapeCell", "get_spec"]
