#!/usr/bin/env python3
"""Train ms/step at b4@256 bf16 with `fused_content_tower` off, then on
(the port's copy of tools/measure_fused_tower.py).

    python -m faststyle_tpu_torch.tools.measure_fused_tower [--device cuda|cpu]

Each reading is one 100-step window of `bench.bench_train_step` (a
device-resident batch, the window ending in a synchronize), two a
setting, so the measurement recipe lives in one place. TF32 is off.
"""

from __future__ import annotations

import argparse

from faststyle_tpu_torch import full_float32
from faststyle_tpu_torch.bench import bench_train_step

STEPS, REPS, PRECISION = 100, 2, "bfloat16"
SHAPE = (4, 256)  # batch, size


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Train ms/step, fused content tower off, then on.")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    full_float32()
    rates = {}
    for fused in (False, True):
        rates[fused] = []
        for rep in range(REPS):
            rec = bench_train_step(STEPS, PRECISION, fused_content_tower=fused, repeats=1, batch=SHAPE[0],
                                   size=SHAPE[1], device=args.device)
            rate = rec["steps_per_sec"][0]
            rates[fused].append(rate)
            print(f"fused={fused} rep{rep}: {1e3 / rate:.2f} ms/step  ({rate:.1f} steps/s) on {rec['device']}",
                  flush=True)
    print("=== MEASURE DONE ===")
    return rates


if __name__ == "__main__":
    main()
