"""Config registry of the port: the public LM architectures and the paper's
own (``lcrwmd``).

Importing this package registers every architecture of ``lm_archs`` and
``lcrwmd``.
"""

from repro_torch.configs import lcrwmd, lm_archs  # noqa: F401  (registers)
from repro_torch.configs.base import ArchSpec, ShapeCell, get_spec

__all__ = ["ArchSpec", "ShapeCell", "get_spec"]
