"""What every cell shares: finding a cell's files by name, the card check,
the guard against JAX, the per-layer readers and the result line.

Nothing here imports the port: the kind drivers in ``kinds/`` do, once the
card check has passed.
"""

import importlib
import importlib.util
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")

# Whole top-level module names that no process of the benchmark may hold:
# the port's own name begins with the JAX package's, so names are compared
# whole, never by prefix.
FORBIDDEN = ("jax", "jaxlib", "flax", "orb_slam3_study_kr_tpu")


class CellError(RuntimeError):
    """A run that cannot give a result (no card, a missing file)."""


def load_benchmark(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find_cell(bench, workload):
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise CellError(f"no workload {workload!r} in BENCHMARK.json")


def find_config(bench, name):
    for cfg in bench["configs"]:
        if cfg["name"] == name:
            return cfg
    raise CellError(f"no configuration {name!r} in BENCHMARK.json")


def data_path(*parts):
    path = os.path.join(HERE, *parts)
    if not os.path.exists(path):
        raise CellError("missing benchmark file "
                        f"{os.path.relpath(path, ROOT)}")
    return path


def load_json(*parts):
    with open(data_path(*parts)) as f:
        return json.load(f)


def load_traffic(name):
    return load_json("traffic", f"{name}.json")


def load_limits(workload):
    """{number: limit} of one cell, from ``limits/<workload>.json``."""
    return {k: v["limit"] for k, v in load_json(
        "limits", f"{workload}.json")["numbers"].items()}


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_kind(kind):
    data_path("kinds", f"{kind}.py")
    return importlib.import_module(f"portbench.kinds.{kind}")


def forbidden_modules(modules=None):
    """Names in ``modules`` (default ``sys.modules``) whose whole top-level
    name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def require_cards(n):
    """Raise CellError unless torch sees at least n CUDA cards."""
    import torch
    if not torch.cuda.is_available():
        raise CellError("no CUDA card: the benchmark runs only on the card")
    if torch.cuda.device_count() < n:
        raise CellError(f"the cell needs {n} cards, torch sees "
                        f"{torch.cuda.device_count()}")


def device_info(n_cards):
    import torch
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(n_cards))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": n_cards, "memory_peak_bytes": int(peak)}


def metrics_for(bench, workload, table):
    """The entries of ``table`` ("end_to_end" or "per_layer") a cell reports:
    those whose ``workloads`` list names it, and those without one whose
    ``moves`` (per-layer) or name (end-to-end) the cell reports."""
    e2e = [m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    out = []
    for m in bench[table]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif (m["moves"] if table == "per_layer" else m["name"]) in e2e:
            out.append(m)
    return out


def read_per_layer(bench, workload, ctx):
    """{name: {"value", "unit"}} of the cell's per-layer metrics; a reader
    that finds nothing to read returns None and its metric is left out."""
    out = {}
    for m in metrics_for(bench, workload, "per_layer"):
        mod = load_module(data_path("metrics", f"{m['name']}.py"),
                          "portbench_metric_" + m["name"].replace(".", "_"))
        value = mod.read(ctx)
        if value is None:
            continue
        value = float(value)
        if not math.isfinite(value):
            continue
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def checks_lines(checks):
    """One line per number compared: name, value, limit, and whether it
    holds (value <= limit)."""
    return [f"check {k}: {v[0]!r} limit {v[1]!r} "
            f"{'ok' if v[0] <= v[1] else 'FAILED'}" for k, v in checks.items()]


def emit(result, checks):
    """The numbers compared as the last lines of stderr, then the result
    line as the last line of stdout, with the checks under its last key."""
    for line in checks_lines(checks):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    line = dict(result)
    line["checks"] = {k: {"value": v[0], "limit": v[1]}
                      for k, v in checks.items()}
    print(json.dumps(line), flush=True)
