"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload stylize_4k_d4 --seed 7 --seconds 20 --trace 0

Exits 2, printing no result, without as many CUDA cards as the cell asks
for, and 3 when a module of JAX or of the JAX package (`faststyle_tpu`) was
loaded. The last line on standard output is one JSON object (`correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` `breakdown`,
and `checks` last); the last lines on standard error are the compared
numbers beside their limits.
"""

import time

_AT_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _fix_cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout, so
    that only a checkout's first run builds."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.harness import forbidden_modules, process_age_s, run_cell, unnamed_kernels
    from benchmark.spec import Bench

    started = _AT_START - process_age_s()
    _fix_cache_dirs(ROOT)
    import torch

    imported = time.perf_counter() - started

    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    run, line = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", started)
    run.record.setup_phases = {"python": _AT_START - started, "torch": imported, **run.record.setup_phases}
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: JAX or the JAX package was loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps({"setup_phases_s": run.record.setup_phases}))
    unnamed = unnamed_kernels(run)
    if unnamed:
        print(json.dumps({"kernels_no_table_names": unnamed}))
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
