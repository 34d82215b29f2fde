"""What a cell is made of, found by the names `BENCHMARK.json` gives.

A cell names a configuration (``configs/<config>.json``) and a traffic
mix (``mixes/<traffic>.json``, parameters only); a batch cell also has a
file of its own (``cells/<cell>.json``: the seconds its pipeline runs
before the window opens, the rows a second its manifest is sized for,
and the batches it holds beyond them).  Code is found by name as well,
each piece a module of its own that a later cell adds as a new file:
the mix's ``driver`` (``drivers/<name>.py``, ``run``) and ``generator``
(``generators/<name>.py``, ``bases`` and ``manifest``), the
configuration's corpus kind (``corpora/<kind>.py``, ``port_source`` and
``reference_templates``), and each per-layer metric
(``metrics/<metric>.py``, whose ``read(window)`` returns a number or
None).  The port's compiled corpus is built once into an artifact under
``.cache/`` (a fixed directory of the checkout) and loaded from there by
every later run.
"""

from __future__ import annotations

import importlib.util
import json
import os
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts), encoding="utf-8") as fh:
        return json.load(fh)


def plugin(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the harness, loaded by path (a
    metric's name may hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.exists(path):
        raise KeyError(f"no {kind} module {name!r} ({path})")
    mod_name = f"gpubench_{kind}_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One entry of `BENCHMARK.json`'s ``workloads`` with its files."""

    def __init__(self, name: str, bench: dict | None = None):
        bench = bench or load_json(ROOT, "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        self.config = load_json(HERE, "configs", self.entry["config"] + ".json")
        self.mix = load_json(HERE, "mixes", self.entry["traffic"] + ".json")
        own = os.path.join(HERE, "cells", name + ".json")
        self.own = load_json(own) if os.path.exists(own) else {}
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [
            m for m in bench["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in reported
                             else [])
        ]

    def driver(self):
        return plugin("drivers", self.mix["driver"])

    def generator(self):
        return plugin("generators", self.mix["generator"])


class Phases:
    """The parts of a run's set-up, in seconds, as they end."""

    def __init__(self, t_start: float, first: str):
        self.t = t_start
        self.done: list = []
        self.mark(first)

    def mark(self, name: str, at: float | None = None) -> None:
        at = time.perf_counter() if at is None else at
        self.done.append((name, at - self.t))
        self.t = at


def metric_reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    return plugin("metrics", name).read


def corpus(config: dict):
    """The module of the configuration's corpus kind."""
    return plugin("corpora", config["corpus"]["kind"])


def reference_templates(config: dict) -> list:
    """The configuration's templates through the frozen copies in
    ``ref/``, never through the port."""
    return corpus(config).reference_templates(config)


def port_artifact(config: dict) -> str:
    """The path of the port's compiled corpus for ``config``: built by
    the port's own `corpus-build` path (`corpus/artifact.py`) on the
    first run in a checkout, then only loaded."""
    path = os.path.join(CACHE, config["name"], "corpus.npz")
    if not os.path.exists(path):
        from licensee_tpu_torch.corpus.artifact import (
            resolve_corpus,
            write_artifact,
        )

        source = corpus(config).port_source(config)
        compiled, _fp, _manifest = resolve_corpus(source)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # write_artifact replaces the file atomically
        write_artifact(path, compiled, source=source)
    return path


def port_corpus(config: dict):
    """The port's compiled corpus, loaded from its artifact."""
    from licensee_tpu_torch.corpus.artifact import load_artifact

    compiled, _manifest = load_artifact(port_artifact(config))
    return compiled
