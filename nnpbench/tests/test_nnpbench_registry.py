"""A configuration, a traffic mix, a cell and a per-layer metric added as
files, and entries added to BENCHMARK.json, are found by name without an
edit to any file the benchmark already has."""

import json
import os
import shutil

from nnpbench.tests import tiny
from nnpbench import harness


def _copy(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(tiny.ROOT, "nnpbench"), os.path.join(root, "nnpbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), root)
    return root


def _snapshot(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "nnpbench")):
        for f in files:
            p = os.path.join(d, f)
            out[p] = open(p, "rb").read()
    return out


def test_new_files_are_found_by_name(tmp_path):
    root = _copy(tmp_path)
    before = _snapshot(root)
    nb = os.path.join(root, "nnpbench")
    config = json.load(open(os.path.join(nb, "configs", "et-md.json")))
    json.dump(dict(config, name="et-md-wide"), open(os.path.join(nb, "configs", "et-md-wide.json"), "w"))
    traffic = json.load(open(os.path.join(nb, "traffic", "stmv-lattice.json")))
    json.dump(dict(traffic, name="dhfr-lattice", n_atoms=2489), open(os.path.join(nb, "traffic", "dhfr-lattice.json"), "w"))
    json.dump({"name": "et-md-dhfr", "driver": "calls", "limits": {"force_gap": 1, "force_rms": 1}},
              open(os.path.join(nb, "workloads", "et-md-dhfr.json"), "w"))
    with open(os.path.join(nb, "layer_metrics", "steps_seen.dhfr.py"), "w") as f:
        f.write("def read(ctx):\n    return float(ctx.steps)\n")
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["configs"].append({"name": "et-md-wide", "source": "x", "file": "nnpbench/configs/et-md-wide.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "et-md-dhfr", "config": "et-md-wide", "traffic": "dhfr-lattice",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "steps_seen.dhfr", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "the device", "moves": "md_ms_per_step",
                               "workloads": ["et-md-dhfr"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "et-md-calls" in m["workloads"]:
            m["workloads"].append("et-md-dhfr")
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))

    entry = bench["workloads"][-1]
    workload, traffic2, config2 = harness.load_cell_files(root, entry)
    assert traffic2["n_atoms"] == 2489 and config2["name"] == "et-md-wide" and workload["driver"] == "calls"
    e2e, layer = harness.cell_metrics(bench, "et-md-dhfr")
    assert {m["name"] for m in e2e} == {"md_ms_per_step", "step_ms_p90", "peak_device_gib", "setup_s"}
    assert [m["name"] for m in layer] == ["steps_seen.dhfr"]
    read = harness.reader(root, "layer_metrics", "steps_seen.dhfr")
    assert read(type("Ctx", (), {"steps": 7})()) == 7.0
    after = _snapshot(root)
    assert all(after[p] == before[p] for p in before), "an existing file changed"


def test_every_metric_and_cell_of_benchmark_json_has_its_files():
    bench = tiny.bench()
    for w in bench["workloads"]:
        harness.load_cell_files(tiny.ROOT, w)
        e2e, layer = harness.cell_metrics(bench, w["name"])
        assert e2e and layer
        for m in e2e:
            harness.reader(tiny.ROOT, "end_to_end", m["name"])
        for m in layer:
            harness.reader(tiny.ROOT, "layer_metrics", m["name"])
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(tiny.ROOT, c["file"]))
