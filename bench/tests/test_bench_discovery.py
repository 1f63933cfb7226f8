"""A configuration, a traffic mix, a per-layer metric and a kernel's
roofline are added as new files and entries alone: a copy of the harness
with one of each dropped in finds them by name."""
import json
import pathlib
import shutil
import subprocess
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]

PROBE = r"""
import json, sys
sys.path[:0] = ["bench"]
import harness
bench = harness.load_json("BENCHMARK.json")
cell, model, mix = harness.load_cell(bench, "new-model.new-mix")
names = [m["name"] for m in harness.metrics_of(bench, cell, True)]
run = harness.Run(model=model, mix=mix, reduced=None)
ops, nbytes, rate = harness.work("new_kernel").work(run)
print(json.dumps({"model": model["name"], "slots": mix["slots"],
                  "trace_metrics": names,
                  "value": harness.reader("layer.new_metric").read(run),
                  "work": [ops, nbytes, rate]}))
"""


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "dit-s2.json").read_text())
    cfg["name"] = "new-model"
    (tmp_path / "bench" / "configs" / "new-model.json").write_text(
        json.dumps(cfg))
    (tmp_path / "bench" / "traffic" / "new-mix.json").write_text(json.dumps(
        {"arrivals": "bursty", "slots": 16, "tiers": ["config"],
         "burst": 5, "gap_s": 0.75, "ramp_bursts": 4}))
    (tmp_path / "bench" / "metrics" / "layer.new_metric.py").write_text(
        "def read(run):\n    return 41.5 + (run.reduced is None)\n")
    (tmp_path / "bench" / "work" / "new_kernel.py").write_text(
        "def work(run):\n    return 1.0, 2.0, 3.0\n")
    bench["configs"].append({"name": "new-model", "source": "x",
                             "file": "bench/configs/new-model.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "new-model.new-mix",
                               "config": "new-model", "traffic": "new-mix",
                               "chips": 1, "why": "x"})
    bench["end_to_end"][0]["workloads"].append("new-model.new-mix")
    bench["per_layer"].append({"name": "layer.new_metric", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "new", "moves": "images_per_s",
                               "workloads": ["new-model.new-mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=tmp_path,
                         capture_output=True, text=True, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["model"] == "new-model" and got["slots"] == 16
    assert got["trace_metrics"] == ["layer.new_metric"]
    assert got["value"] == 42.5
    assert got["work"] == [1.0, 2.0, 3.0]


def test_new_mix_plans_without_code():
    import traffic
    model = json.loads((BENCH / "configs" / "dit-s2.json").read_text())
    mix = {"arrivals": "bursty", "slots": 16, "tiers": ["config"],
           "burst": 5, "gap_s": 0.75, "ramp_bursts": 4}
    a = traffic.plan(model, mix, 10.0, 0.05)
    b = traffic.plan(model, mix, 10.0, 0.05)
    assert a == b and a["window"] == (3.0, 13.0)
    assert len(a["arrivals"]) == 18 * 5       # bursts at 0, 0.75 ... 12.75
    assert all(x < 13.0 for x in a["arrivals"])
