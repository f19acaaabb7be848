"""BENCHMARK.json keeps to the contract's shape, and a run's last line
carries the keys the contract names, `checks` last."""

import re
import time

import pytest

from benchmark.harness import run_cell
from benchmark.spec import Bench
from benchmark.tests.conftest import ROOT, SMALL

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_shape():
    spec = Bench().spec
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"] and 1 <= spec["run_seconds"] <= 51
    configs = {c["name"]: c for c in spec["configs"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "benchmark" / "workloads" / f"{w['traffic']}.json").is_file()
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        for cell in m.get("workloads", []):
            w = next(w for w in spec["workloads"] if w["name"] == cell)
            assert m["moves"] in [x["name"] for x in Bench().end_to_end(w)]
    for w in spec["workloads"]:
        bench = Bench()
        assert len(bench.end_to_end(w)) >= 2 and bench.per_layer(w)


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_result_line(bench_copy, one_thread, workload):
    _, line = run_cell(bench_copy, workload, 2**31 + 11, 0.5, False, "cpu", time.perf_counter(), SMALL[workload])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in bench_copy.end_to_end(bench_copy.cell(workload))}
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for check in line["checks"].values():
        assert set(check) == {"value", "limit"}


@pytest.mark.parametrize("key,value", [("precision", "float16"), ("norm_stats_precision", "bfloat16"), ("io", "f32")])
def test_stream_driver_refuses_what_it_cannot_serve(key, value):
    driver = Bench().driver("stylize_stream")
    config = Bench().config("johnson_in_resize_starry")
    assert driver.serving(config)["packed_input"] is True
    with pytest.raises(ValueError, match=key):
        driver.serving({**config, key: value})
