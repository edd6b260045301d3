"""Cells, mixes, configurations and metrics are found by name: a file
dropped into a checkout, with its entry in BENCHMARK.json, is all a new
one takes."""
import json

import pytest

from bench.lib import spec as spec_lib


def test_files_are_found_by_name(tiny_root):
    spec = spec_lib.Spec(tiny_root)
    wl = spec.workload("tiny.chat")
    cfg = spec.config(wl["config"])
    assert cfg["hidden_size"] == 128 and cfg["_name"] == "tiny"
    assert spec.traffic("tiny_chat")["arrivals"]["rate"] == 20.0
    assert spec.cell("tiny.chat")["max_logit_gap"] == 0.02
    assert hasattr(spec.reference(cfg), "forward")
    with pytest.raises(KeyError):
        spec.workload("nope")


def test_a_new_metric_and_mix_take_only_files(tiny_root):
    bench = tiny_root / "bench"
    (bench / "metrics" / "probe.count.py").write_text(
        "def read(rec):\n    return rec.get('probe')\n")
    (bench / "traffic" / "tiny_other.json").write_text(json.dumps(
        {"extends": "tiny_chat", "arrivals": {"kind": "poisson",
                                              "rate": 9.0}}))
    doc = json.loads((tiny_root / "BENCHMARK.json").read_text())
    doc["per_layer"].append({"name": "probe.count", "unit": "1",
                             "better": "higher", "source": "program_counter",
                             "layer": "device", "moves": "output_tps",
                             "workloads": ["tiny.other"]})
    doc["workloads"].append({"name": "tiny.other", "config": "tiny",
                             "traffic": "tiny_other", "chips": 1,
                             "why": "a test"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(doc))
    spec = spec_lib.Spec(tiny_root)
    other = spec.traffic(spec.workload("tiny.other")["traffic"])
    base = spec.traffic("tiny_chat")
    assert other["arrivals"]["rate"] == 9.0 and "extends" not in other
    assert other["_name"] == "tiny_other"
    assert {k: v for k, v in other.items() if k not in ("arrivals", "_name")} \
        == {k: v for k, v in base.items() if k not in ("arrivals", "_name")}
    got = spec_lib.read_metrics(spec, "tiny.other", "per_layer",
                                {"probe": 7})
    assert got["probe.count"] == {"value": 7.0, "unit": "1"}
    # a reader that finds nothing leaves its metric out of the line
    assert "probe.count" not in spec_lib.read_metrics(
        spec, "tiny.other", "per_layer", {})
    # a metric that lists its cells is not reported in others
    names = [m["name"] for m in spec.metrics_of("tiny.chat", "per_layer")]
    assert "probe.count" not in names


def test_the_benchmark_names_a_file_for_everything():
    from conftest import ROOT
    spec = spec_lib.Spec(ROOT)
    for wl in spec.workloads.values():
        cfg = spec.config(wl["config"])
        spec.reference(cfg)
        spec.traffic(wl["traffic"])
        assert all(v > 0 for k, v in spec.cell(wl["name"]).items()
                   if k != "set_from")
    for name in spec.metrics:
        assert callable(spec.reader(name))
