"""The control, the plain reference put in the program's place at the
nearest precision below the configuration's (float8 e4m3 for the bf16
stream, TF32 for the float32 training), comes out not correct, and so do
the planted faults (the stream's bf16-statistics control is read, not
asserted: at these sizes its gap says nothing of the card's): `benchmark.control`'s readings at a small size on the
CPU (on the card it runs at the cells' sizes)."""

import time

import torch

from benchmark import control
from benchmark.harness import Context
from benchmark.tests.conftest import SMALL


def _readings(bench, workload, kind):
    cell = bench.cell(workload)
    config, traffic = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    config.update(SMALL[workload].get("config", {}))
    traffic.update(SMALL[workload]["traffic"])

    def ctx_for(seed):
        return Context(bench, cell, config, traffic, seed, 0.5, False, torch.device("cpu"), time.perf_counter())

    readings = control.stream_readings if kind == "stream" else control.train_readings
    return traffic["limits"], {what: numbers for _seed, what, numbers, _n in readings(ctx_for, [7], [7], 0.5)}


def _fails(numbers, limits):
    return any(value > limits[name] for name, value in numbers.items())


def test_stream_control_is_not_correct(bench_copy, one_thread):
    limits, got = _readings(bench_copy, "stylize_4k_d4", "stream")
    assert _fails(got["control_float8"], limits)
    assert _fails(got["fault_frame_altered"], limits)
    assert set(got["control_bf16_stats"]) == set(limits)


def test_train_control_is_not_correct(bench_copy, one_thread):
    limits, got = _readings(bench_copy, "train_b16_256", "train")
    for what in ("control_tf32", "fault_half_batch", "fault_state_unchanged", "fault_rows_altered", "fault_unshuffled",
                 "fault_wgrad_zeroed"):
        assert _fails(got[what], limits), what
