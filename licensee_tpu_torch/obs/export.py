"""Exporters: Prometheus text exposition over a registry snapshot, a
text-format grammar checker (the CI gate for the exposition), the
fleet-level exposition merger (per-worker scrapes -> one
``worker``-labeled exposition, the router's aggregate), and the delta
collector that folds the native ``profile_dump()`` counters into a
registry without double-counting across scrapes.

Prometheus exposition format (text format 0.0.4):

    # HELP metric_name Help text.
    # TYPE metric_name counter|gauge|histogram
    metric_name{label="value",...} 1027

Histograms expand to cumulative ``_bucket{le="..."}`` series plus
``_sum`` and ``_count`` — exactly the shape a Prometheus server scrapes
and the shape PromQL ``histogram_quantile`` expects.

House rule (script/lint): no print in obs/ — every exporter writes to
an explicit stream or returns a string.
"""

from __future__ import annotations

import math
import re

from licensee_tpu_torch.obs.registry import MetricsRegistry

# one exposition line: a comment (# HELP / # TYPE), or a sample —
# name, optional {labels} with escaped string values, a float value
# (inf/nan included), optional timestamp, optional OpenMetrics
# exemplar (`# {trace_id="..."} value [ts]`).  The selftest holds
# every rendered line to this grammar.
_LABEL = r'[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\["\\n])*"'
_VALUE = r"(?:[+-]?(?:[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?|Inf|inf)|NaN|nan)"
_LABELSET = rf"\{{(?:(?:{_LABEL})(?:,(?:{_LABEL}))*)?\}}"
PROM_LINE_RE = re.compile(
    r"^(?:"
    r"# (?:HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]*(?: [^\n]*)?"
    r"|"
    r"[a-zA-Z_:][a-zA-Z0-9_:]*"
    rf"(?:\{{(?:{_LABEL})(?:,(?:{_LABEL}))*\}})?"
    rf" {_VALUE}"
    r"(?: [+-]?[0-9]+)?"
    rf"(?: # {_LABELSET} {_VALUE}(?: {_VALUE})?)?"
    r")$"
)


def _escape_label(value) -> str:
    return (
        str(value)
        .replace("\\", r"\\")
        .replace("\n", r"\n")
        .replace('"', r'\"')
    )


def _escape_help(text: str) -> str:
    return text.replace("\\", r"\\").replace("\n", r"\n")


def _fmt(value) -> str:
    value = float(value)
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    if math.isnan(value):
        return "NaN"
    if value == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(value)


def _labelset(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(v)}"' for k, v in labels.items()
    )
    return "{" + inner + "}"


def render_prometheus(registry: MetricsRegistry) -> str:
    """The full text exposition for one scrape (runs the registry's
    pull collectors first, via snapshot)."""
    lines: list[str] = []
    registry.collect()
    for fam in registry.families():
        samples = fam.samples()
        if not samples:
            continue
        if fam.help:
            lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for labels, value in samples:
            if fam.kind == "histogram":
                exemplars = value.get("exemplars") or {}
                for le, count in value["buckets"].items():
                    line = (
                        f"{fam.name}_bucket"
                        f"{_labelset({**labels, 'le': le})} {count}"
                    )
                    ex = exemplars.get(le)
                    if ex is not None:
                        # OpenMetrics exemplar: the trace behind the
                        # slowest observation this bucket retained
                        line += (
                            f' # {{trace_id='
                            f'"{_escape_label(ex["trace_id"])}"}} '
                            f"{_fmt(ex['value'])}"
                        )
                    lines.append(line)
                lines.append(
                    f"{fam.name}_sum{_labelset(labels)} "
                    f"{_fmt(value['sum'])}"
                )
                lines.append(
                    f"{fam.name}_count{_labelset(labels)} "
                    f"{_fmt(float(value['count']))}"
                )
            else:
                lines.append(
                    f"{fam.name}{_labelset(labels)} {_fmt(value)}"
                )
    return "\n".join(lines) + "\n" if lines else ""


def check_exposition(text: str) -> list[str]:
    """Every non-empty line must match the text-format grammar; returns
    the violations (empty list == parses clean).  The serve selftest
    and `licensee-tpu stats --selftest` gate on this."""
    problems = []
    for i, line in enumerate(text.splitlines(), 1):
        if line and not PROM_LINE_RE.match(line):
            problems.append(f"line {i}: does not match exposition grammar: "
                            f"{line!r}")
    return problems


# one sample line, split into (name, optional {labels}, value+rest) —
# the merge rewriter injects a source label between name and labels.
# The labels group is non-greedy ([^}]*, NOT .*): an OpenMetrics
# exemplar suffix carries its own {...} later in the line, and a
# greedy match would swallow up to the exemplar's closing brace and
# corrupt the rewrite.  Exemplars ride through untouched in ``rest``.
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?( .+)$"
)
_COMMENT_RE = re.compile(r"^# (HELP|TYPE) ([a-zA-Z_:][a-zA-Z0-9_:]*)(.*)$")


def merge_expositions(
    per_source: dict[str, str], label: str = "worker"
) -> str:
    """Merge several text expositions into ONE fleet-level exposition,
    tagging every sample with ``label="<source>"`` — the router's
    aggregate scrape over its per-worker registries.

    Same-named families merge into one block (HELP/TYPE emitted once,
    first source wins) because Prometheus rejects a scrape that repeats
    a TYPE comment; the injected label keeps every worker's series
    distinct under the shared family name.  Histogram child lines
    (``_bucket``/``_sum``/``_count``) follow their family via the
    source exposition's comment structure, so they land in the right
    block without name surgery."""
    families: dict[str, dict] = {}  # name -> {help, kind, samples: []}
    order: list[str] = []

    def family(name: str) -> dict:
        fam = families.get(name)
        if fam is None:
            fam = {"help": None, "kind": None, "samples": []}
            families[name] = fam
            order.append(name)
        return fam

    for source, text in per_source.items():
        current: dict | None = None
        escaped = _escape_label(source)
        for line in (text or "").splitlines():
            if not line:
                continue
            comment = _COMMENT_RE.match(line)
            if comment:
                verb, name, rest = comment.groups()
                current = family(name)
                if verb == "HELP" and current["help"] is None:
                    current["help"] = rest
                elif verb == "TYPE" and current["kind"] is None:
                    current["kind"] = rest
                continue
            sample = _SAMPLE_RE.match(line)
            if sample is None:
                continue  # not exposition grammar: drop, never corrupt
            name, labels, rest = sample.groups()
            tag = f'{label}="{escaped}"'
            if labels and re.search(
                rf'(?:\{{|,){re.escape(label)}="', labels
            ):
                # the sample already carries the merge label (a source
                # exporting per-worker series of its own): injecting a
                # second copy would emit a duplicate label name, which
                # a real Prometheus server rejects scrape-wide
                rewritten = f"{name}{labels}{rest}"
            elif labels:
                rewritten = f"{name}{{{tag},{labels[1:-1]}}}{rest}"
            else:
                rewritten = f"{name}{{{tag}}}{rest}"
            # a bare sample before any comment (hand-rolled exporters)
            # anchors its own family block
            target = current if current is not None else family(name)
            target["samples"].append(rewritten)
    lines: list[str] = []
    for name in order:
        fam = families[name]
        if not fam["samples"]:
            continue
        if fam["help"] is not None:
            lines.append(f"# HELP {name}{fam['help']}")
        if fam["kind"] is not None:
            lines.append(f"# TYPE {name}{fam['kind']}")
        lines.extend(fam["samples"])
    return "\n".join(lines) + "\n" if lines else ""


class NativeProfileSource:
    """Folds the native pipeline's cumulative ``profile_dump()`` rows
    into registry counters as PER-SCRAPE DELTAS.

    ``profile_dump()`` is a process-lifetime cumulative surface shared
    by every consumer (tests, benches, other registries), so this
    source never resets it; instead it remembers the last observed
    totals and adds only the increase — two scrapes without new work
    add zero (the double-count regression test), and an explicit
    ``profile_reset()`` elsewhere just clamps the delta at zero.
    """

    def __init__(self, registry: MetricsRegistry, dump_fn=None):
        if dump_fn is None:
            from licensee_tpu_torch.native.pipeline import profile_dump as dump_fn
        self._dump = dump_fn
        self._last: dict[str, float] = {}
        self._seconds = registry.counter(
            "native_featurize_stage_seconds_total",
            "Seconds in the native featurizer by stage "
            "(profile_dump stage.* rows)",
            labels=("stage",),
        )
        self._counts = registry.counter(
            "native_featurize_events_total",
            "Native featurizer event counts (profile_dump count.* rows)",
            labels=("kind",),
        )
        # one COLLECTOR per registry: the profile surface is
        # process-wide, so a second attachment (e.g. several
        # MicroBatchers sharing obs.get_registry()) would scrape the
        # same cumulative rows through two independent _last baselines
        # and double-count every delta into the shared counter families
        if not getattr(registry, "_native_profile_attached", False):
            registry._native_profile_attached = True
            registry.add_collector(self.collect)

    def collect(self, _registry=None) -> None:
        try:
            rows = self._dump()
        except Exception:  # noqa: BLE001 — a sick native lib must not kill a scrape
            return
        for name, total in rows.items():
            delta = total - self._last.get(name, 0.0)
            self._last[name] = total
            if delta <= 0:
                continue  # no new work (or an external profile_reset)
            if name.startswith("stage.") and name.endswith("_s"):
                self._seconds.labels(stage=name[6:-2]).inc(delta)
            elif name.startswith("count."):
                self._counts.labels(kind=name[6:]).inc(delta)
            # fine-grained per-pass rows (s1.*/s2.*) stay out of the
            # registry: unbounded name set, profiling-only
