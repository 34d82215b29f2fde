"""The generator ``pool``: a batch mix's manifest drawn by the run's
seed from a pool of seeded mutations of the configuration's templates,
made once a checkout (`traffic.ensure_pool`).  The mix's parameters:
``distinct_share`` (rows that are a blob's first sighting),
``mutated_share`` (of those, a pool file rather than a verbatim
template), ``mutation_rates`` (`chip_smoke.write_rows`' rates, one drawn
a file) and ``unreadable_rows`` (rows that name no file)."""

from __future__ import annotations

import math
import os

import numpy as np

from gpubench.traffic import ensure_pool, rng_for, template_bases


def bases(templates: list, mix: dict) -> list:
    """The (file name, text) bases the mix draws from: the templates,
    their fields filled in."""
    return template_bases(templates)


def manifest(mix: dict, bases: list, seed: int, n_rows: int,
             root: str) -> list:
    """The mix's rows, drawn by ``seed`` from its pool under ``root``.

    Of the rows, a ``distinct_share`` are first sightings of a blob; of
    those a ``mutated_share`` are a pool file not used before in the run
    (the pool in a seeded order) and the rest a verbatim base; the other
    rows repeat an earlier row's path, drawn uniformly.  The paths at
    ``unreadable_rows`` name no file.  Every seed draws the same
    shares from the same files, in another order."""
    rng = rng_for(seed, 1, 0)
    fresh = rng.random(n_rows) < float(mix["distinct_share"])
    mutated = rng.random(n_rows) < float(mix["mutated_share"])
    base_ix = rng.integers(len(bases), size=n_rows)
    pick = rng.random(n_rows)
    unreadable = sorted(int(i) for i in mix.get("unreadable_rows", ())
                        if int(i) < n_rows)
    fresh[0] = True
    fresh[unreadable] = False
    share = float(mix["distinct_share"]) * float(mix["mutated_share"])
    # the pool holds what any seed's draw needs, four deviations over
    n_pool = math.ceil(n_rows * share
                       + 4 * math.sqrt(n_rows * share * (1 - share))) + 1
    pool = ensure_pool(mix, bases, root, n_pool)
    order = rng.permutation(n_pool)
    firsts = np.flatnonzero(fresh)
    # a repeat names the path of a first sighting on an earlier row
    seen_before = np.searchsorted(firsts, np.arange(n_rows))
    source = firsts[(pick * seen_before).astype(np.int64)]
    rows = [""] * n_rows
    used = 0
    for i in firsts.tolist():
        if mutated[i]:
            rows[i] = pool[int(order[used])]
            used += 1
        else:
            b = int(base_ix[i])
            rows[i] = os.path.join(root, "bases", f"{b:04d}.{bases[b][0]}")
    for i in np.flatnonzero(~fresh).tolist():
        rows[i] = rows[int(source[i])]
    for i in unreadable:
        rows[i] = os.path.join(root, "missing", f"{i}", "LICENSE")
    return rows


