"""Adding a configuration, a traffic mix, a per-layer metric or a kernel
table takes new files and BENCHMARK.json entries, and no edit of a file
the benchmark has."""

import json

from benchmark.harness import Context, Record, Run
from benchmark.spec import family_of
from benchmark.trace import Spans


def _add_entries(bench, **entries):
    path = bench.root / "BENCHMARK.json"
    spec = json.loads(path.read_text())
    for key, items in entries.items():
        spec[key] += items
    path.write_text(json.dumps(spec))
    return type(bench)(bench.root)


def test_new_config_and_traffic_are_found(bench_copy):
    cfg = json.loads((bench_copy.dir / "configs" / "johnson_in_resize_starry.json").read_text())
    cfg["name"] = "johnson_in_resize_candy"
    (bench_copy.dir / "configs" / "johnson_in_resize_candy.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench_copy.dir / "workloads" / "stylize_4k_d4.json").read_text())
    traffic.update(height=600, width=800, pipeline_depth=1, in_flight=1)
    (bench_copy.dir / "workloads" / "webcam_800x600_d1.json").write_text(json.dumps(traffic))
    bench = _add_entries(
        bench_copy,
        configs=[{"name": "johnson_in_resize_candy", "source": "https://github.com/ghwatson/faststyle",
                  "file": "benchmark/configs/johnson_in_resize_candy.json", "reduced": [], "why": "x"}],
        workloads=[{"name": "webcam_800x600_d1", "config": "johnson_in_resize_candy",
                    "traffic": "webcam_800x600_d1", "chips": 1, "why": "x"}],
    )
    cell = bench.cell("webcam_800x600_d1")
    assert bench.config(cell["config"])["name"] == "johnson_in_resize_candy"
    assert bench.traffic(cell["traffic"])["width"] == 800
    assert bench.driver(bench.config(cell["config"])["driver"]).run is not None
    # a cell that no metric lists by name reports the metrics without a list
    assert [m["name"] for m in bench.end_to_end(cell)] == ["setup_s"]


def test_new_metric_is_found_and_read(bench_copy):
    (bench_copy.dir / "metrics" / "fetch_ms.stylize.py").write_text(
        'UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"\n'
        'LAYER, MOVES = "stream pipeline", "frame_latency_p95_ms"\n\n\n'
        'def read(run):\n    return 1e3 * run.spans.mean("bench.fetch")\n')
    bench = _add_entries(bench_copy, per_layer=[
        {"name": "fetch_ms.stylize", "unit": "ms", "better": "lower", "source": "host_clock",
         "layer": "stream pipeline", "moves": "frame_latency_p95_ms"}])
    cell = bench.cell("stylize_4k_d4")
    assert "fetch_ms.stylize" in [m["name"] for m in bench.per_layer(cell)]
    assert "fetch_ms.stylize" not in [m["name"] for m in bench.per_layer(bench.cell("train_b16_256"))]
    spans = Spans()
    spans.seconds["bench.fetch"] = [0.002, 0.004]
    ctx = Context(bench, cell, {}, {}, 0, 1.0, True, None, 0.0)
    run = Run(ctx, Record(1.0, 1.0, 2, 0, {}, {}, 0, spans), "cpu")
    assert abs(bench.reader("fetch_ms.stylize").read(run) - 3.0) < 1e-12


def test_new_kernel_table_is_found_in_its_order(bench_copy):
    name = "void fused_instance_norm_relu_kernel<bf16>"
    assert family_of(name, bench_copy.kernel_tables()) == "reduce"
    (bench_copy.dir / "kernels" / "fused_norm.json").write_text(
        json.dumps({"order": 35, "fragments": ["fused_instance_norm"], "why": "x"}))
    tables = type(bench_copy)(bench_copy.root).kernel_tables()
    assert family_of(name, tables) == "fused_norm"
    assert family_of("void at::native::vectorized_elementwise_kernel<4>", tables) == "elementwise"
    assert family_of("some_kernel_no_table_names", tables) is None
