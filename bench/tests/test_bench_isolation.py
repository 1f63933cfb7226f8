"""Nothing the harness loads has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``repro``, compared whole: ``repro_torch``, the program under
test, begins with ``repro`` and is not one of them."""
import json
import pathlib
import subprocess
import sys

import harness

BENCH = pathlib.Path(__file__).resolve().parents[1]

PROBE = r"""
import json, sys
sys.path[:0] = ["bench", "src", "bench/tests"]
import torch
torch.set_num_threads(2)
import harness, smoke, control
out = harness.run("dit-s2.backlog32", 5, 3.0, True, device="cpu",
                  model=smoke.model("dit-s2"), mix=smoke.mix("backlog32", 1))
control.readings("dit-s2.backlog32", 5, "cpu", smoke.model("dit-s2"),
                 smoke.mix("backlog32", 1))
print(json.dumps({"tops": sorted({m.split(".")[0] for m in sys.modules}),
                  "forbidden": harness.forbidden_modules(),
                  "finished": out["attempted"]}))
"""


def test_whole_top_level_names():
    mods = dict(sys.modules)
    try:
        sys.modules["repro_torch_like"] = sys
        sys.modules["reproducible.sub"] = sys
        assert harness.forbidden_modules() == sorted(
            {m.split(".")[0] for m in mods} & set(harness.FORBIDDEN))
        sys.modules["repro.core"] = sys
        assert "repro" in harness.forbidden_modules()
    finally:
        for k in ("repro_torch_like", "reproducible.sub", "repro.core"):
            sys.modules.pop(k, None)


def test_a_run_loads_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", PROBE],
                         cwd=BENCH.parent, capture_output=True, text=True,
                         check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == []
    assert "repro_torch" in got["tops"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(got["tops"])
    assert got["finished"] > 0
