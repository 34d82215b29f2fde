"""Traffic from a seed: what the generators in ``generators/`` share.

The word-level mutation, the vendored bases and the threaded file
writer are copied from `chip_smoke.py` (`mutate`, `vendored_bases`,
`write_files`), the mutation vectorised over a base's words so that a
pool's hundreds of thousands of distinct files are made in a minute or
two.  A pool of files is made once in a directory of the checkout
(`ensure_pool`) and every run's manifest is drawn from it by the run's
seed.

Every random draw comes from a generator keyed by (seed, stream, block),
so the same seed gives the same files whatever the order they are made
in.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np

# the field values the bases are rendered with (chip_smoke.py)
FIELD_VALUES = {
    "fullname": "Ben Balter",
    "year": "2018",
    "email": "ben@github.invalid",
    "projecturl": "http://github.invalid/benbalter/licensee",
    "login": "benbalter",
    "project": "Licensee",
    "description": "Detects licenses",
}

# rows a block of the generator draws together
BLOCK = 1024
_LETTERS = np.array(list("abcdefgh"))


def rng_for(seed: int, stream: int, block: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2**63 - 1), stream, block])


def template_bases(templates) -> list[tuple[str, str]]:
    """(file name, text) of each template, its fields filled in."""
    from gpubench.ref.fields import field_regex

    regex = field_regex()
    return [(f"{t.key}.LICENSE",
             regex.sub(lambda m: FIELD_VALUES[m.group(1)], t.content or ""))
            for t in templates]


class Mutator:
    """`chip_smoke.mutate` over one base, vectorised: each word is kept,
    dropped, doubled or replaced by a made-up word with total
    probability ``rate``; with ``unique``, one more word (never the
    first) is replaced by a made-up word unique to the row, so no two
    rows and no row and its base are the same text."""

    def __init__(self, text: str):
        parts = re.split(r"(\s+)", text)
        # parts alternate word, space, word, ...: an empty first word
        # when the text starts with space
        self.words = parts[0::2]
        self.spaces = parts[1::2] + [""]
        self.tokens = [w + s for w, s in zip(self.words, self.spaces)]
        self.live = np.flatnonzero([bool(w) for w in self.words])

    def __call__(self, rng: np.random.Generator, rate: float,
                 unique: str | None = None) -> str:
        out = self.tokens.copy()
        r = rng.random(len(self.live))
        hits = np.flatnonzero(r < rate)
        made = rng.integers(0, len(_LETTERS), (len(hits), 5))
        for j, letters in zip(hits.tolist(), _LETTERS[made].tolist()):
            k = int(self.live[j])
            w, space = self.words[k], self.spaces[k]
            if r[j] < rate / 3:
                out[k] = space
            elif r[j] < 2 * rate / 3:
                out[k] = w + " " + w + space
            else:
                out[k] = "zq" + "".join(letters) + space
        if unique is not None and len(self.live) > 1:
            k = int(self.live[1 + int(rng.integers(len(self.live) - 1))])
            out[k] = unique + self.spaces[k]
        return "".join(out)


def unique_word(seed: int, i: int) -> str:
    """A made-up word for row ``i`` of ``seed``'s traffic: letters only,
    so the tokenizer keeps it whole."""
    n = (int(seed) % 1_000_003) * 10_000_000 + i
    letters = []
    while True:
        n, d = divmod(n, 26)
        letters.append(chr(ord("a") + d))
        if not n:
            break
    return "zq" + "".join(letters)


# the seed of the pools' files: the same in every run, whose own seed
# draws its rows from them
POOL_SEED = 0
_WORKER: dict = {}


def _worker_init(bases: list, mix: dict) -> None:
    _WORKER.update(bases=bases, mix=mix, mutators={})


def _write_pool_files(items: list) -> None:
    """A writer process's share of a pool: each (path, k, base) the k-th
    file, a mutation of that base drawn from its own generator."""
    bases, rates = _WORKER["bases"], _WORKER["mix"]["mutation_rates"]
    for path, k, b in items:
        m = _WORKER["mutators"].get(b)
        if m is None:
            m = _WORKER["mutators"][b] = Mutator(bases[b][1])
        rng = rng_for(POOL_SEED, 4, k)
        text = m(rng, float(rates[int(rng.integers(len(rates)))]),
                 unique_word(POOL_SEED, k))
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(text)


def pool_bases(n_bases: int, n_files: int) -> np.ndarray:
    """The base of each of a pool's first ``n_files`` files (file k's the
    same whatever the pool's size)."""
    blocks = [rng_for(POOL_SEED, 5, b).integers(n_bases, size=BLOCK)
              for b in range(-(-n_files // BLOCK))]
    return np.concatenate(blocks)[:n_files] if blocks else np.zeros(0, int)


def ensure_pool(mix: dict, bases: list, root: str, n_files: int,
                procs: int = 8) -> list:
    """The paths of a mix's pool of files under ``root``: its bases
    verbatim, then ``n_files`` seeded mutations, each made unique.  The
    files are made once, in a directory that later runs find again, and
    only those missing are written: a run's rows are drawn from them."""
    done_path = os.path.join(root, "pool.json")
    made = 0
    if os.path.exists(done_path):
        with open(done_path, encoding="utf-8") as fh:
            made = int(json.load(fh)["files"])
    names = [name for name, _text in bases]
    of = pool_bases(len(bases), n_files).tolist()
    paths = [f"{root}/m/{k // 1000:04d}/{k:07d}.{names[of[k]]}"
             for k in range(n_files)]
    if made >= n_files:
        return paths
    if not made:
        os.makedirs(os.path.join(root, "bases"), exist_ok=True)
        for b, (name, text) in enumerate(bases):
            with open(os.path.join(root, "bases", f"{b:04d}.{name}"), "w",
                      encoding="utf-8") as fh:
                fh.write(text)
    todo = [(paths[k], k, of[k]) for k in range(made, n_files)]
    for d in {os.path.dirname(p) for p, _k, _b in todo}:
        os.makedirs(d, exist_ok=True)
    import multiprocessing

    n = max(1, min(procs, len(todo) // 256))
    with multiprocessing.get_context("spawn").Pool(
            n, _worker_init, (bases, mix)) as pool:
        pool.map(_write_pool_files, [todo[j::n] for j in range(n)])
    # the windows read these files: their pages are written back now
    os.sync()
    with open(done_path, "w", encoding="utf-8") as fh:
        json.dump({"files": n_files}, fh)
    return paths
