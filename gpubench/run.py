"""The benchmark of the PyTorch and CUDA port, `licensee_tpu_torch`.

    python3 gpubench/run.py --workload CELL --seed N --seconds S --trace 0|1

Runs one cell of `BENCHMARK.json` on the card this machine holds and
prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` a ``breakdown``, and
last ``checks``: each number the correctness comparison made, beside
its limit, also the last lines of standard error.  Exits non-zero and
prints no result where there is no card (or fewer than the cell asks
for), or where the process ends up holding a module of JAX or of the
JAX package.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402 — the clock starts before the imports
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv: list[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def measure(cell, seed: int, seconds: float, trace: bool,
            device: str = "cuda") -> dict:
    """Drive one run of ``cell`` and assemble its result line (without
    the device's identity)."""
    from gpubench import spec

    res = cell.driver().run(cell, seed, seconds, trace, T_START,
                            device=device)
    if trace:
        layer = res["layer"]
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(layer)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**res["e2e"], "setup_s": res["setup_s"]}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    checks = {name: {"value": value, "limit": limit}
              for name, value, limit in res["checks"]}
    out = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": res["attempted"],
        "failed": res["failed"],
        "metrics": metrics,
        "device": {"memory_peak_bytes": res["memory_peak_bytes"],
                   "kind": res.get("kind")},
    }
    if trace and "trace" in res["layer"]:
        tr = res["layer"]["trace"]
        out["device"]["busy_s"] = tr.busy_s()
        out["device"]["window_s"] = res["layer"]["trace_s"]
        out["breakdown"] = tr.breakdown()
    out["checks"] = checks
    out["examples"] = res.get("examples")
    out["setup_phases"] = res["setup_phases"]
    return out


def main(argv: list[str] | None = None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    sys.path.insert(0, ROOT)
    from gpubench import spec
    from gpubench.device import forbidden_modules

    cell = spec.Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"error: {cell.name} needs {cell.chips} CUDA device(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = measure(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"error: the run loaded {bad}", file=sys.stderr)
        return 3
    print("setup: " + "; ".join(f"{name} {secs:.2f} s"
                                for name, secs in out.pop("setup_phases")),
          file=sys.stderr)
    examples = out.pop("examples")
    if examples:
        print(f"differing (got, want): {examples}", file=sys.stderr)
    checks = out.pop("checks")
    out["device"] = {
        "platform": "gpu",
        "kind": out["device"]["kind"] or torch.cuda.get_device_name(0),
        "count": cell.chips,
        **{k: v for k, v in out["device"].items() if k != "kind"},
    }
    out["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
