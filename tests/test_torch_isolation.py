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
        assert top not in ("jax", "jaxlib", "faststyle_tpu", "optax", "ml_dtypes"), f"{path}: imports {name}"


CLIS = ["train", "stylize_image", "stylize_webcam", "slow_style"]


def test_entry_points_default_to_cuda():
    """Every public function and class constructor of the port with a
    `device` parameter defaults to cuda, every CLI's --device defaults to
    cuda, and asking for cuda without a GPU raises instead of falling back."""
    import importlib

    from faststyle_tpu_torch import resolve_device
    from faststyle_tpu_torch.inference import Stylizer

    seen = []
    for mod_name in _modules():
        mod = importlib.import_module(mod_name)
        members = inspect.getmembers(mod, inspect.isfunction) + inspect.getmembers(mod, inspect.isclass)
        for name, obj in members:
            if obj.__module__ != mod_name or name.startswith("_"):
                continue
            try:
                param = inspect.signature(obj).parameters.get("device")
            except ValueError:  # exception types have no signature
                continue
            if param is not None:
                seen.append(f"{mod_name}.{name}")
                assert param.default == "cuda", f"{mod_name}.{name}: device={param.default!r}"
    assert len(seen) >= 7 and "faststyle_tpu_torch.inference.Stylizer" in seen
    clis = {name: importlib.import_module(f"faststyle_tpu_torch.cli.{name}") for name in CLIS}
    for name, cli in clis.items():
        assert cli.setup_parser().parse_args([]).device == "cuda", name
    if not torch.cuda.is_available():
        starry = str(ROOT / "weights" / "starry_final.npz")
        img = str(ROOT / "tests" / "assets" / "chicago_crop256.png")
        calls = [
            resolve_device,
            lambda: Stylizer(starry),
            lambda: clis["train"].main(["--image_dir", str(ROOT), "--vgg_path", str(ROOT / "README.md")]),
            lambda: clis["stylize_image"].main(["--input_img_path", img, "--model_path", starry]),
            lambda: clis["stylize_webcam"].main(["--model_path", starry, "--num_synthetic_frames", "1"]),
            lambda: clis["slow_style"].main(["--style_img_path", img, "--cont_img_path", img,
                                              "--vgg_path", str(ROOT / "README.md")]),
        ]
        for call in calls:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()


def _tiny_cli_args(name, tmp_path):
    """Arguments that run each CLI's main on the CPU at a tiny size."""
    import numpy as np

    from faststyle_tpu_torch.utils import image_io

    starry = str(ROOT / "weights" / "starry_final.npz")
    img = tmp_path / "img.png"
    image_io.imwrite(img, np.random.default_rng(0).integers(0, 256, (48, 44, 3), dtype=np.uint8))
    if name in ("train", "slow_style"):
        rng = np.random.default_rng(1)
        flat, cin = {}, 3
        for layer, cout in (("conv1_1", 4), ("conv1_2", 4), ("conv2_1", 4), ("conv2_2", 4), ("conv3_1", 4),
                            ("conv3_2", 4), ("conv3_3", 4), ("conv4_1", 4), ("conv4_2", 4), ("conv4_3", 4),
                            ("conv5_1", 4), ("conv5_2", 4), ("conv5_3", 4)):
            flat[f"{layer}_W"] = rng.standard_normal((3, 3, cin, cout)).astype(np.float32)
            flat[f"{layer}_b"] = np.zeros(cout, np.float32)
            cin = cout
        np.savez(tmp_path / "vgg.npz", **flat)
    if name == "train":
        (tmp_path / "imgs").mkdir()
        image_io.imwrite(tmp_path / "imgs" / "a.png", image_io.imread(img))
        return ["--image_dir", str(tmp_path / "imgs"), "--vgg_path", str(tmp_path / "vgg.npz"),
                "--style_img_path", str(img), "--batch_size", "1", "--preprocess_size", "16", "16",
                "--num_steps_break", "1", "--num_pipe_buffer", "1", "--loss_style_layers", "conv1_2",
                "--style_weights", "1", "--loss_content_layers", "conv1_2", "--device", "cpu"]
    if name == "stylize_image":
        return ["--input_img_path", str(img), "--output_img_path", str(tmp_path / "o.png"),
                "--model_path", starry, "--device", "cpu"]
    if name == "stylize_webcam":
        return ["--model_path", starry, "--num_synthetic_frames", "1", "--resolution", "44", "48",
                "--no_display", "--device", "cpu"]
    return ["--style_img_path", str(img), "--cont_img_path", str(img), "--vgg_path", str(tmp_path / "vgg.npz"),
            "--num_steps_break", "1", "--loss_style_layers", "conv1_2", "--style_weights", "1",
            "--loss_content_layers", "conv1_2", "--output_img_path", str(tmp_path / "o.png"), "--device", "cpu"]


@pytest.mark.parametrize("name", CLIS)
def test_cli_turns_tf32_off(name, tmp_path, monkeypatch):
    """float32 means float32: each CLI's main, run on the CPU, leaves TF32
    off for cuDNN and cuBLAS even when the process had it on."""
    import importlib

    cli = importlib.import_module(f"faststyle_tpu_torch.cli.{name}")
    args = _tiny_cli_args(name, tmp_path)
    monkeypatch.chdir(tmp_path)  # the train CLI writes its run directories here
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        cli.main(args)
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is False
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
