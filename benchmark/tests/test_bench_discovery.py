"""The benchmark finds its cells, configurations, traffic mixes and metrics
by name, and a new one is a new file and entry, with no edit."""

import json
import re

import pytest

from benchmark.harness import session, spec
from benchmark.harness.traffic import Reservoir, Schedule
from benchmark.tests._util import ROOT, copy_benchmark

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads(name):
    cell = spec.load_cell(name)
    assert cell.chips in (1, 4)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "call_s"}
    assert cell.per_layer, "every cell reports a per-layer metric"
    assert spec.call_module(cell).work(cell.config)["tc_flops"] > 0
    assert hasattr(spec.reference_module(cell), "solve")
    Schedule(cell.traffic)


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert all(NAME.match(n) for n in names), names
    assert len(set(CELLS)) == len(CELLS)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == \
            c["name"]
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize(
    "name", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader_that_reads_nothing_from_nothing(name):
    cell = spec.load_cell(CELLS[0])
    reader = spec.metric_reader(cell, name)
    empty = session.Run(calls=0, window_s=0.0, latencies_s=[],
                        enqueue_s=[], setup_s=1.0, peak_bytes=0, world=1,
                        work={"bytes": 1.0, "tc_flops": 1.0,
                              "f32_flops": 0.0}, least_s=1.0)
    value = reader.read(empty)
    assert value is None or name == "setup_s"


def test_a_dummy_config_traffic_and_metric_are_found_in_a_copy(tmp_path):
    root = copy_benchmark(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "benchmark/configs/gram_d1000.json").read_text())
    cfg.update(name="dummy_cfg", rows=1024)
    (root / "benchmark/configs/dummy_cfg.json").write_text(json.dumps(cfg))
    (root / "benchmark/traffic/dummy.mix.json").write_text(json.dumps(
        {"input_sets": 3, "checked": 2}))
    (root / "benchmark/metrics/dummy.calls.py").write_text(
        "def read(run):\n    return float(run.calls)\n")
    bench["configs"].append({"name": "dummy_cfg", "source": "a test",
                             "file": "benchmark/configs/dummy_cfg.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy_cfg",
                               "traffic": "dummy.mix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "dummy.calls", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "Entry", "moves": "call_s",
                               "workloads": ["dummy.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("dummy.cell", root)
    assert cell.config["rows"] == 1024
    assert Schedule(cell.traffic).input_for(4) == 1
    assert [m["name"] for m in cell.per_layer] == ["dummy.calls"]
    run = session.Run(calls=7, window_s=1.0, latencies_s=[], enqueue_s=[],
                      setup_s=1.0, peak_bytes=0, world=1, work={},
                      least_s=1.0)
    assert spec.metric_reader(cell, "dummy.calls").read(run) == 7.0
    assert spec.call_module(cell).work(cell.config)["bytes"] == \
        4.0 * 1024 * 1000 + 4.0 * 1000 * 1000
    # The cells already there are found as before.
    assert spec.load_cell(CELLS[0], root).config == \
        spec.load_cell(CELLS[0]).config


def test_schedule_cycles_through_the_sets():
    mix = {"input_sets": 5, "checked": 1}
    assert [Schedule(mix).input_for(i) for i in range(7)] == \
        [0, 1, 2, 3, 4, 0, 1]
    with pytest.raises(ValueError):
        Schedule(dict(mix, input_sets=0))


def test_reservoir_keeps_a_uniform_sample_drawn_from_the_seed():
    def sample(seed, n, k=3):
        r = Reservoir(k, seed)
        for i in range(n):
            if r.wants():
                r.keep(i, i * 10)
        return r.items()

    assert sample(5, 2) == [(0, 0), (1, 10)]
    big = sample(2**33 + 1, 1000)
    assert len(big) == 3 and big == sample(2**33 + 1, 1000)
    assert all(item == 10 * i for i, item in big)
    hits = [0] * 10
    for seed in range(3000):
        for i, _ in sample(seed, 10):
            hits[i] += 1
    assert min(hits) > 700 and max(hits) < 1100   # 900 each expected
