"""The benchmark's own tests: `python -m pytest benchmark/tests` on the CPU.
Tests marked `card` need a CUDA card; they skip elsewhere, decided inside
the `card` fixture, never at import. On the card: `python -m pytest
benchmark/tests -m card`."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (runs on the chip)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    return torch.device("cuda")


@pytest.fixture
def one_thread():
    """One intra-op thread: tiny runs of many small ops beside other work."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# the cells at a size the CPU holds in seconds
SMALL = {
    "stylize_4k_d4": {"traffic": {"height": 64, "width": 96, "pool_frames": 4, "check_frames": 2,
                                  "trace_seconds": 0.5}},
    "train_b16_256": {
        "config": {"preprocess_size": [48, 48], "train_images": 64, "num_pipe_buffer": 8},
        "traffic": {"batch_size": 4, "decode_threads": 2, "trace_seconds": 0.5, "signature_every": 1,
                    "corpus": {"height": 96, "width": 128, "quality": 90, "shards": 2, "seed": 3,
                               "content": {"coarse_px": 32, "mid_px": 8, "texture": 24.0}}},
    },
}


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of BENCHMARK.json, the benchmark's files and the repo files
    that its configurations name (weights, style image) in a temporary
    checkout: what a run writes (the corpus) stays there."""
    import json
    import shutil

    from benchmark.spec import Bench

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for entry in json.loads((ROOT / "BENCHMARK.json").read_text())["configs"]:
        config = json.loads((ROOT / entry["file"]).read_text())
        for key in ("weights", "style_image"):
            if isinstance(config.get(key), str) and (ROOT / config[key]).is_file():
                (tmp_path / config[key]).parent.mkdir(parents=True, exist_ok=True)
                shutil.copy(ROOT / config[key], tmp_path / config[key])
    return Bench(tmp_path)
