"""The port stands alone: it imports neither jax nor anything of
faststyle_tpu, and no entry point runs on the CPU unless asked to."""

import ast
import inspect
import json
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "faststyle_tpu_torch"


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py")
    )


def test_port_and_chip_smoke_import_no_jax():
    """In a fresh interpreter: import every module of the port and
    chip_smoke.py (which imports the port at its top); jax and faststyle_tpu
    must stay out of sys.modules."""
    code = (
        "import importlib, importlib.util, json, sys\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        f"spec = importlib.util.spec_from_file_location('chip_smoke', {str(ROOT / 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'faststyle_tpu' or m.startswith('faststyle_tpu.')]\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imported_names(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


SOURCES = [str(p.relative_to(ROOT)) for p in sorted(PKG.rglob("*.py"))] + ["chip_smoke.py"]


@pytest.mark.parametrize("path", SOURCES)
def test_no_jax_or_reference_import_in_source(path):
    for name in _imported_names(ROOT / path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "faststyle_tpu", "optax"), f"{path}: imports {name}"


def test_entry_points_default_to_cuda():
    """Every public function of the port with a `device` parameter defaults
    to cuda, the CLI's --device defaults to cuda, and asking for cuda
    without a GPU raises instead of falling back."""
    import importlib

    from faststyle_tpu_torch import resolve_device
    from faststyle_tpu_torch.cli import train as cli

    seen = 0
    for mod_name in _modules():
        mod = importlib.import_module(mod_name)
        for name, fn in inspect.getmembers(mod, inspect.isfunction):
            if fn.__module__ != mod_name or name.startswith("_"):
                continue
            param = inspect.signature(fn).parameters.get("device")
            if param is not None:
                seen += 1
                assert param.default == "cuda", f"{mod_name}.{name}: device={param.default!r}"
    assert seen >= 6
    assert cli.setup_parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["--image_dir", str(ROOT), "--vgg_path", str(ROOT / "README.md")])
