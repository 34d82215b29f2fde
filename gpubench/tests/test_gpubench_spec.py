"""`BENCHMARK.json` against the contract's rules of form, and every name
it gives found as a file of the harness."""

import json
import os
import re

import pytest

from gpubench import spec

BENCH = spec.load_json(spec.ROOT, "BENCHMARK.json")
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"]
    assert BENCH["command"] == ["python3", "gpubench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_by_name(name):
    cell = spec.Cell(name, BENCH)
    assert callable(cell.driver().run)
    generator = cell.generator()
    assert callable(generator.bases) and callable(generator.manifest)
    corpus = spec.corpus(cell.config)
    assert callable(corpus.port_source)
    assert callable(corpus.reference_templates)
    assert cell.chips == 1
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    reported = {m["name"] for m in cell.end_to_end}
    for m in cell.per_layer:
        assert m["moves"] in reported
    if cell.mix["driver"] == "batch":
        assert {"rows_per_s_ceiling", "headroom_batches", "warm_s"} <= set(
            cell.own)


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_every_config_file_matches_its_entry(config):
    path = os.path.join(spec.ROOT, config["file"])
    assert config["file"].startswith("gpubench/configs/")
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    assert data["name"] == config["name"]
    assert data["source"] == config["source"]
    assert config["reduced"] == []


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=[m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    read = spec.metric_reader(metric["name"])
    assert read({}) is None, "a reader with nothing to read returns None"


@pytest.mark.parametrize("metric", METRICS, ids=[m["name"] for m in METRICS])
def test_names_units_and_keys(metric):
    assert NAME.match(metric["name"])
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    allowed = ({"name", "unit", "better", "bound", "source", "workloads"}
               if metric in BENCH["end_to_end"] else
               {"name", "unit", "better", "source", "layer", "moves",
                "workloads"})
    assert set(metric) <= allowed
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
    names = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", [])) <= names


def test_names_are_unique_and_well_formed():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    metric_names = [m["name"] for m in METRICS]
    assert len(metric_names) == len(set(metric_names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
