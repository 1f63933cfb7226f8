"""The benchmark of ``repro_torch``: one run of one cell of BENCHMARK.json.

  python3 bench/run.py --workload bksdm-small.backlog8 --seed 7 \\
      --seconds 20 --trace 0

Prints one JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its
limit; the same numbers end standard error.  Exits 2 without a result
when the card is missing, or when the process holds ``jax``, ``jaxlib``,
``flax`` or ``repro`` once the window has closed.
"""
import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import harness
    bench = harness.load_json(BENCH.parent / "BENCHMARK.json")
    cell = harness.cell_of(bench, args.workload)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    # one host thread for CPU operators: the window is paced by the
    # host's dispatch, and idle intra-op workers only compete with it
    torch.set_num_threads(1)
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_process=T_PROCESS, bench=bench)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"the process holds {', '.join(loaded)}", file=sys.stderr)
        return 2
    if out.get("why"):
        print(f"not correct: {out['why']}", file=sys.stderr)
    for name, c in out.get("checks", {}).items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
