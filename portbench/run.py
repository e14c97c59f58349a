"""Run one cell of BENCHMARK.json once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>
    python3 -m portbench.run ...            (the same, from the checkout root)

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics.  ``--control 1`` (not used by the benchmark's own runs)
prints, in place of the program's readings, those of the control that the
limits in ``limits/<workload>.json`` were set against.

Exits 2 without a CUDA card, and 1 (after naming them on stderr) when the
process holds a module of JAX or of the JAX package once the window has
closed; neither prints a result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):
    # Run as a script: the checkout root, not portbench/, leads sys.path.
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))

from portbench import harness  # noqa: E402


def _cache_dirs(root):
    """Fixed build and kernel cache directories inside the checkout, so that
    only a cell's first run there builds."""
    base = os.path.join(root, ".portbench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(base, sub)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(args, device="cuda", bench=None, t_start=None):
    """Set up, warm up, measure and check one cell; returns (result,
    checks).  ``device`` other than "cuda" skips the card check (the
    tests drive the rest of a run on the CPU)."""
    bench = bench or harness.load_benchmark()
    cell = harness.find_cell(bench, args.workload)
    if device == "cuda":
        harness.require_cards(cell["chips"])
    traffic = harness.load_traffic(cell["traffic"])
    ctx = dict(args=args, bench=bench, cell=cell, traffic=traffic,
               config=harness.find_config(bench, cell["config"]),
               limits=harness.load_limits(args.workload), device=device,
               t_start=T_START if t_start is None else t_start)
    kind = harness.load_kind(traffic["kind"])
    return kind.run(ctx)


def main(argv=None):
    args = parse_args(argv)
    _cache_dirs(harness.ROOT)
    try:
        result, checks = run_cell(args)
    except harness.CellError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print("portbench: the process holds modules of JAX or of the JAX "
              f"package: {', '.join(found)}", file=sys.stderr)
        return 1
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
