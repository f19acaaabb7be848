"""Build a C/C++ source of the package into a shared library and load it.

Two routes, by the source's suffix under `faststyle_tpu_torch/csrc/`:
  * `<name>.cu`, a CUDA kernel: `nvcc` for sm_90a;
  * `<name>.cc`, host code (the packed-u8 pack/unpack): the host C++
    compiler (`$CXX`, else `c++`), `-O3 -fPIC -shared`.
Either compiles into `build/faststyle_tpu_torch/<name>-<hash>.so` at the
repo root on first use, keyed on a hash of the source and the flags, so a
fresh checkout builds itself and an edited source never loads a stale
library. The libraries have a plain C interface and are loaded with
`ctypes`: no torch headers, so a build takes seconds, not minutes. A
failed build raises; nothing falls back.

Nothing here runs at import; a machine without `nvcc` imports the package
and runs every CPU path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "faststyle_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
CXX_FLAGS = ("-std=c++17", "-O3", "-fPIC", "-shared")


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else /usr/local/cuda, else PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def cxx_path() -> str:
    """The host C++ compiler: $CXX, else `c++` on PATH."""
    found = shutil.which(os.environ.get("CXX") or "c++")
    if found is None:
        raise RuntimeError("no host C++ compiler found (set CXX); the host library cannot be built")
    return found


def source(name: str) -> Path:
    """csrc/<name>.cu or csrc/<name>.cc, whichever exists."""
    for suffix in (".cu", ".cc"):
        path = CSRC / f"{name}{suffix}"
        if path.is_file():
            return path
    raise FileNotFoundError(f"no csrc/{name}.cu or csrc/{name}.cc")


def _command(src: Path, out: str) -> list[str]:
    if src.suffix == ".cu":
        return [nvcc_path(), *NVCC_FLAGS, "-o", out, str(src)]
    return [cxx_path(), *CXX_FLAGS, "-o", out, str(src)]


def library_path(name: str) -> Path:
    """Where the library built from csrc/<name>.{cu,cc} lives for this source."""
    src = source(name)
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS if src.suffix == ".cu" else CXX_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> tuple[Path, float]:
    """Compile csrc/<name>.{cu,cc} unless this source's library exists;
    returns (path, seconds spent compiling). The library is written under a
    temp name and renamed, so concurrent processes never load a partial file."""
    out = library_path(name)
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        src = source(name)
        proc = subprocess.run(_command(src, tmp), capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {src.name} failed:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, time.perf_counter() - t0


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>'s library, once per process."""
    path, _ = build(name)
    return ctypes.CDLL(str(path))
