"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place and finished one precision below
the configuration's (float32 for its float64), judged by the same
comparison, over what a run of the cell compares: its traffic at the
cell's size, the same seeded sample.

    python3 gpubench/control.py --workload CELL --seeds N,N,N [--seconds S]

Prints one JSON line a seed: the numbers compared and, beside them, the
control's.  The control has to come out as not correct (a number over
its limit) on every seed.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sample_inputs(cell, seed: int, seconds: float) -> tuple[list, list]:
    """(raw bytes, file names) of the rows a run of ``cell`` would
    compare: the seeded sample of a manifest of the run's size."""
    from gpubench import check, spec
    from gpubench.drivers.batch import manifest_rows

    config, mix = cell.config, cell.mix
    generator = cell.generator()
    bases = generator.bases(spec.reference_templates(config), mix)
    n_rows = manifest_rows(cell, seconds)
    rows = generator.manifest(mix, bases, seed, n_rows, os.path.join(
        spec.CACHE, "pools", cell.name))
    picked = check.sample(seed, n_rows, mix.get("unreadable_rows", ()))
    raws = []
    for i in picked:
        try:
            with open(rows[i], "rb") as fh:
                raws.append(fh.read())
        except OSError:
            raws.append(None)
    return raws, [os.path.basename(rows[i]) for i in picked]


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np

    from gpubench import check, spec
    from gpubench.ref.classify import Reference

    bench = spec.load_json(ROOT, "BENCHMARK.json")
    seconds = args.seconds or float(bench["run_seconds"])
    cell = spec.Cell(args.workload, bench)
    templates = spec.reference_templates(cell.config)
    threshold = float(cell.config["confidence_threshold"])
    ref = Reference(templates, threshold)
    control = Reference(templates, threshold, precision=np.float32)
    failed_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        raws, names = sample_inputs(cell, seed, seconds)
        want = ref.verdicts(raws, names)
        got = control.verdicts(raws, names)
        rows = [{"key": g[0], "matcher": g[1], "confidence": g[2],
                 "error": g[3]} for g in got]
        differ, examples = check.compare(rows, want)
        failed_all &= differ > 0
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "compared": len(raws),
                          "control_rows_differing": differ, "limit": 0,
                          "control_correct": differ <= 0,
                          "examples": examples[:1]}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
