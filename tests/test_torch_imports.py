"""Import guard: the port stands alone, with no JAX and nothing of ``repro``."""

import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
MODULES = [
    "repro_torch", "repro_torch.convert", "repro_torch.data.docs",
    "repro_torch.data.synth", "repro_torch.core", "repro_torch.kernels.ops",
    "repro_torch.kernels.ref",
]
_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|from\s+repro(\.|\s))",
    re.M)


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import sys, importlib\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_sources_name_no_jax_and_no_reference():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f.relative_to(REPO)) for f in files
                 if _FORBIDDEN.search(f.read_text())]
    assert offenders == []


def test_forbidden_pattern_catches_the_usual_forms():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                 "from repro.core import topk", "import repro.kernels.ops",
                 "  import repro"):
        assert _FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import topk",
                 "# jax-free", "import jaxlib_free_helper"):
        assert not _FORBIDDEN.search(line), line
