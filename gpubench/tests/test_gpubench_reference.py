"""Each cell's run, driven here on the CPU at a tiny size (the port at
``device="cpu"``, the harness's look for a card skipped): the plain
reference agrees with what the port wrote, the
lower-precision control does not, and a run whose timed path is broken
underneath comes out not correct."""

import numpy as np
import pytest

from gpubench import control, run, spec
from gpubench.ref.classify import Reference

BENCH = spec.load_json(spec.ROOT, "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
SECONDS = 2.0
SEED = 2**31 + 12345


def tiny(name: str):
    """The cell at a CPU's size: a manifest for a short window."""
    cell = spec.Cell(name, BENCH)
    cell.own = {**cell.own, "rows_per_s_ceiling": 8000, "warm_s": 1}
    return cell


@pytest.mark.parametrize("name", CELLS)
def test_the_reference_agrees_with_the_port_on_the_cpu(name):
    out = run.measure(tiny(name), SEED, SECONDS, False, device="cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert all(c["value"] == 0 for n, c in out["checks"].items())


@pytest.mark.parametrize("name", CELLS)
def test_the_float32_control_fails_the_comparison(name):
    cell = tiny(name)
    raws, names = control.sample_inputs(cell, SEED, SECONDS)
    templates = spec.reference_templates(cell.config)
    want = Reference(templates).verdicts(raws, names)
    got = Reference(templates, precision=np.float32).verdicts(raws, names)
    differ = sum(g != w for g, w in zip(got, want))
    assert differ > 0
    # only the confidence's digits differ: the verdicts are the same
    assert all(g[:2] == w[:2] for g, w in zip(got, want))


def alter_answers(monkeypatch):
    """Every Dice score one point off where the finish produces it."""
    from licensee_tpu_torch.kernels.batch import BatchClassifier

    finish = BatchClassifier.finish_chunks

    def altered(self, prepared, outs, threshold):
        finish(self, prepared, outs, threshold)
        for r in prepared.results:
            if r is not None and r.matcher == "dice":
                r.confidence += 1.0

    monkeypatch.setattr(BatchClassifier, "finish_chunks", altered)


def leave_half_out(monkeypatch):
    """Each batch's second half of rows never written."""
    from licensee_tpu_torch.projects.batch_project import BatchProject

    write = BatchProject._write_batch

    class Half:
        def __init__(self, out):
            self.out = out

        def write(self, text):
            lines = text.split("\n")
            self.out.write("\n".join(lines[: len(lines) // 2]) + "\n")

        def flush(self):
            self.out.flush()

    monkeypatch.setattr(BatchProject, "_write_batch",
                        lambda self, batch, out: write(self, batch, Half(out)))


def stale_state(monkeypatch):
    """The device step hands back its first chunk's outputs forever."""
    from licensee_tpu_torch.kernels.batch import BatchClassifier

    finish = BatchClassifier.finish_chunks
    first: list = []

    def stale(self, prepared, outs, threshold):
        outs = outs.result() if hasattr(outs, "result") else outs
        if not first:
            first.append(outs[0][1])
        outs = [(chunk, tuple(np.resize(np.asarray(a), len(chunk))
                              for a in first[0]))
                for chunk, _out in outs]
        finish(self, prepared, outs, threshold)

    monkeypatch.setattr(BatchClassifier, "finish_chunks", stale)


@pytest.mark.parametrize("fault", [alter_answers, leave_half_out,
                                   stale_state],
                         ids=["answer_altered", "half_left_out",
                              "state_unchanged"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    out = run.measure(tiny(name), SEED, SECONDS, False, device="cpu")
    assert not out["correct"], out["checks"]
