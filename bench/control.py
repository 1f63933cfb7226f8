"""The lower-precision control of ``correct``: the plain reference put in
the program's place and computed in TF32 (the configurations state
float32 with TF32 off), compared with the float32 reference by the same
numbers and limits as a run.  It has to come out as not correct.

  python3 bench/control.py --workload bksdm-small.backlog8 --seeds 11 12 13

For each seed: the run's weights, and the cell's sample size of requests
drawn from the seed out of the first ones a run would serve, as a run
draws them, each run alone by both references.  Prints one JSON
line a seed.  The benchmark's own runs do not run it.
"""
import argparse
import json
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH)]


def readings(workload: str, seed: int, device: str = "cuda",
             model=None, mix=None) -> dict:
    import torch

    import check
    import harness
    import traffic
    import weights
    bench = harness.load_json(BENCH.parent / "BENCHMARK.json")
    _, file_model, file_mix = harness.load_cell(bench, workload)
    model, mix = model or file_model, mix or file_mix
    dev = torch.device(device)
    params = weights.make(model, seed, dev)
    k = model["check"]["requests"]
    pool = [{"rid": i, "tier": mix["tiers"][i % len(mix["tiers"])],
             "slot": i % mix["slots"]}
            for i in range(max(4 * k, mix["slots"]))]
    inputs = {r["rid"]: traffic.request_inputs(model, seed, r["rid"])
              for r in pool}
    worst = dict.fromkeys(check.NAMES, 0.0)
    for r in check.sample(pool, k, seed, model, mix["slots"]):
        ref = check.reference_run(model, params, inputs, r, dev, False)
        low = check.reference_run(model, params, inputs, r, dev, True)
        for name, v in check.gaps(low[0], low[1], *ref).items():
            worst[name] = max(worst[name], v)
    limits = model["check"]["limits"]
    return {"workload": workload, "seed": seed,
            "checks": {n: {"value": worst[n], "limit": limits[n]}
                       for n in check.NAMES},
            "fails": any(worst[n] > limits[n] for n in check.NAMES)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
