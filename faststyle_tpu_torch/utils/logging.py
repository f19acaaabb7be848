"""Metrics logging (the port's own copy of faststyle_tpu/utils/logging.py):
a CSV metrics stream (columns from the first metric dict), stdout
mirroring, steps/sec, optional TensorBoard events through tensorboardX, and
the reference's auto-unique run naming (`<model_name>N`)."""

from __future__ import annotations

import csv
import time
from pathlib import Path
from typing import Dict, Optional


def unique_run_name(base_dir: str | Path, model_name: str) -> str:
    """`<model_name>N` for the first free N. The name is claimed by creating
    its directory with exist_ok=False, so concurrent trainers get distinct
    runs."""
    base = Path(base_dir)
    base.mkdir(parents=True, exist_ok=True)
    count = 0
    while True:
        name = f"{model_name}{count}"
        try:
            (base / name).mkdir(exist_ok=False)
            return name
        except FileExistsError:
            count += 1


class MetricsLogger:
    def __init__(
        self,
        log_dir: str | Path,
        run_name: str,
        *,
        echo: bool = True,
        tensorboard: bool = True,
    ):
        self._dir = Path(log_dir) / run_name
        self._dir.mkdir(parents=True, exist_ok=True)
        self._path = self._dir / "metrics.csv"
        # Resuming into an existing CSV conforms to ITS header: new keys are
        # dropped, absent ones left empty, so columns never misalign.
        self._resume_fields: Optional[list] = None
        if self._path.exists() and self._path.stat().st_size > 0:
            with open(self._path, newline="") as f:
                header = f.readline().strip()
            if header:
                self._resume_fields = header.split(",")
        self._file = open(self._path, "a", newline="")
        self._writer: Optional[csv.DictWriter] = None
        self._echo = echo
        self._last_step: Optional[int] = None
        self._last_time: Optional[float] = None
        self._tb = None
        if tensorboard:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(log_dir=str(self._dir))

    @property
    def directory(self) -> Path:
        return self._dir

    def log(self, step: int, metrics: Dict[str, float], *, at_time: Optional[float] = None) -> None:
        """`at_time` (a time.perf_counter() value) backdates the row to when
        the step was dispatched, so steps_per_sec measures tick-to-tick
        intervals, not the deferred fetch."""
        now = time.perf_counter() if at_time is None else at_time
        row = {"step": step, "wall_time": time.time()}
        row.update({k: float(v) for k, v in metrics.items()})
        if self._last_step is not None and step > self._last_step:
            row["steps_per_sec"] = (step - self._last_step) / (now - self._last_time)
        self._last_step, self._last_time = step, now
        if self._writer is None:
            if self._resume_fields is not None:
                fields = self._resume_fields
            else:
                fields = list(row.keys())
                if "steps_per_sec" not in fields:
                    fields.append("steps_per_sec")
            self._writer = csv.DictWriter(self._file, fieldnames=fields, extrasaction="ignore", restval="")
            if self._file.tell() == 0:
                self._writer.writeheader()
        self._writer.writerow(row)
        self._file.flush()
        if self._tb is not None:
            for key, val in row.items():
                if key not in ("step", "wall_time"):
                    self._tb.add_scalar(key, val, step)
        if self._echo:
            parts = " ".join(f"{k}={v:.5g}" for k, v in row.items() if k != "wall_time")
            print(f"[train] {parts}")

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        self._file.close()
