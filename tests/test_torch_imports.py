"""Import guard: the port stands alone, with no JAX and nothing of ``repro``."""

import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
MODULES = [
    "repro_torch", "repro_torch.convert", "repro_torch.data.docs",
    "repro_torch.data.synth", "repro_torch.core", "repro_torch.core.rwmd",
    "repro_torch.core.wmd", "repro_torch.kernels.ops", "repro_torch.kernels.ref",
    "repro_torch.kernels.spmm_ell", "repro_torch.kernels.fused_stream",
    "repro_torch.kernels.rwmd_pairwise", "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.segment_spmm", "repro_torch.models.transformer.model",
    "repro_torch.configs", "repro_torch.distributed.lcrwmd_dist",
    "repro_torch.index", "repro_torch.index.cluster_index",
    "repro_torch.workloads.clustering", "repro_torch.workloads.neighbors",
    "repro_torch.data.vectorizer", "repro_torch.obs", "repro_torch.obs.sentinel",
    "repro_torch.serving", "repro_torch.serving.errors",
    "repro_torch.serving.staging", "repro_torch.serving.faults",
    "repro_torch.serving.ingest_pool", "repro_torch.serving.corpus_manager",
    "repro_torch.serving.query_server", "repro_torch.workloads",
    "repro_torch.workloads.corpus_distance", "repro_torch.examples",
    "repro_torch.examples.quickstart", "repro_torch.examples.knn_classify",
    "repro_torch.examples.cluster_corpus", "repro_torch.examples.serve_queries",
    "repro_torch.launch", "repro_torch.launch.serve",
    "repro_torch.launch.mesh", "repro_torch.launch.cells",
    "repro_torch.configs.lcrwmd", "repro_torch.models.transformer.moe",
    "repro_torch.models.transformer.mla",
    "repro_torch.models.transformer.kv_quant",
    "repro_torch.models.transformer.common",
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


def _port_modules():
    out = []
    for f in sorted(PORT.rglob("*.py")):
        parts = f.relative_to(PORT.parent).with_suffix("").parts
        out.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return out


def test_import_guard_covers_every_module():
    """Importing MODULES loads every module of the port, so the guard above
    sees all of them."""
    code = (
        "import sys, importlib\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        f"missing = [m for m in {_port_modules()!r} if m not in sys.modules]\n"
        "assert not missing, missing\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stdout + r.stderr


def test_every_module_imports_first():
    """Each module of the port imports when it is the first of the port to be
    imported (no import cycle breaks it)."""
    code = (
        "import sys, importlib\n"
        f"for m in {_port_modules()!r}:\n"
        "    for k in [k for k in sys.modules if k.split('.')[0] == 'repro_torch']:\n"
        "        del sys.modules[k]\n"
        "    importlib.import_module(m)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stdout + r.stderr


def test_every_device_parameter_defaults_to_the_card():
    """A ``device`` parameter with a default defaults to None (the card)."""
    import importlib
    import inspect

    checked = 0
    for name in _port_modules():
        mod = importlib.import_module(name)
        for obj in vars(mod).values():
            if getattr(obj, "__module__", None) != name:
                continue
            fns = [obj] if inspect.isfunction(obj) else [
                f for f in vars(obj).values() if inspect.isfunction(f)
            ] if inspect.isclass(obj) else []
            for fn in fns:
                p = inspect.signature(fn).parameters.get("device")
                if p is not None and p.default is not inspect.Parameter.empty:
                    assert p.default is None, f"{name}.{fn.__qualname__}"
                    checked += 1
    assert checked >= 8


def _module_path(m):
    p = PORT.parent / m.replace(".", "/")
    return p / "__init__.py" if p.is_dir() else p.with_suffix(".py")


_PORT_IMPORT = re.compile(
    r"^(?:from\s+(repro_torch(?:\.\w+)*)\s+import\s+([\w, ()]+)|"
    r"import\s+(repro_torch(?:\.\w+)*))", re.M)


def _top_level_port_imports(m):
    """Port modules that ``m`` imports at its top level (a module and each
    name it takes from a package, when that name is a module)."""
    known = set(_port_modules())
    out = set()
    for frm, names, imp in _PORT_IMPORT.findall(_module_path(m).read_text()):
        if imp:
            out.add(imp)
            continue
        out.add(frm)
        for n in re.split(r"[\s,()]+", names):
            if f"{frm}.{n}" in known:
                out.add(f"{frm}.{n}")
    parts = m.split(".")
    out.update(".".join(parts[:i]) for i in range(1, len(parts)))  # parents
    return out & known


def test_each_torch_module_alone_turns_tf32_off():
    """Whichever torch-backed module of the port is imported first, the
    float32 backend flags are set before any of its GEMMs can run: each
    such module reaches ``repro_torch.device`` through its top-level
    imports, and importing that module sets the flags (no TF32 in matmuls
    or cuDNN, bf16 products summed in float32)."""
    torch_modules = [m for m in _port_modules() if re.search(
        r"^(import torch|from torch)\b", _module_path(m).read_text(), re.M)]
    assert len(torch_modules) > 20
    for m in torch_modules:
        seen, todo = set(), [m]
        while todo:
            x = todo.pop()
            if x not in seen:
                seen.add(x)
                todo.extend(_top_level_port_imports(x))
        assert "repro_torch.device" in seen, m
    code = (
        "import importlib, sys\n"
        "importlib.import_module('repro_torch.core.distances')\n"
        "import torch\n"
        "b = torch.backends\n"
        "flags = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,\n"
        "         b.cuda.matmul.allow_bf16_reduced_precision_reduction)\n"
        "assert flags == (False, False, False), flags\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stdout + r.stderr
