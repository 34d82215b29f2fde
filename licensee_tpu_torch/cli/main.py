"""Command-line interface of the PyTorch/CUDA port.

    python -m licensee_tpu_torch.cli.main [detect] [PATH] [--json] \\
        [--confidence N] [--license KEY] [--diff] [--no-packages] \\
        [--no-readme] [--remote] [--ref REF]
    python -m licensee_tpu_torch.cli.main diff [PATH] --license KEY
    python -m licensee_tpu_torch.cli.main license-path [PATH]
    python -m licensee_tpu_torch.cli.main version | help [COMMAND]
    python -m licensee_tpu_torch.cli.main batch-detect MANIFEST \\
        [--output OUT.jsonl] [--corpus vendored|spdx|DIR|ARTIFACT] \\
        [--mode license|readme|package|auto] [--closest K] \\
        [--attribution] [--method M] [--batch-size N] [--confidence N] \\
        [--no-dedupe] [--device cuda|cpu] [--workers N] \\
        [--featurize-procs N] [--coalesce-batches N] [--pipeline-depth N] \\
        [--no-resume] [--stats] [--stats-file PATH] [--prom-file PATH] \\
        [--progress SECS] [--profile DIR] [--mesh DATA[,MODEL]|auto|none] \\
        [--device-lanes K|auto] [--stripes N|auto|elastic] \\
        [--chips-per-stripe K] [--autoscale-min N] [--autoscale-max N] \\
        [--autoscale-cooldown SECS]
    python -m licensee_tpu_torch.cli.main batch-detect \\
        --selftest | --selftest-remote | --selftest-autoscale
    python -m licensee_tpu_torch.cli.main corpus-build \\
        [--corpus SRC] --output ART.npz | --inspect ART.npz
    python -m licensee_tpu_torch.cli.main serve [--socket PATH|HOST:PORT] \\
        [--mode M] [--corpus SRC] [--method M] [--max-batch N] \\
        [--max-delay-ms MS] [--queue-depth N] [--pipeline-depth N] \\
        [--cache-entries N] [--cache-bytes N] [--deadline-ms MS] \\
        [--buckets N,N,...] [--confidence N] [--stats] [--no-tracing] \\
        [--trace-sample RATE] [--trace-slow-ms MS] [--trace-log PATH] \\
        [--mesh DATA[,MODEL]|auto] [--device cuda|cpu] \\
        [--selftest | --selftest-reload]
    python -m licensee_tpu_torch.cli.main fleet --workers N \\
        --socket FRONT [--http HOST:PORT] [--socket-dir DIR] \\
        [--federate TARGET,...] [--hedge-ms MS|auto|off] \\
        [--pool-per-worker N] [--edge-token NAME=TOKEN] [--edge-rate RPS] \\
        [--edge-burst N] [--restart-backoff-ms MS] [--boot-timeout SECS] \\
        [--device cuda|cpu] [serve's flags] \\
        | --selftest | --selftest-reload | --selftest-tcp [--stub]
    python -m licensee_tpu_torch.cli.main stats --socket PATH [...] \\
        [--format json|prometheus] [--watch SECS] [--trace N] | --selftest
    python -m licensee_tpu_torch.cli.main traces|slo|top|alerts \\
        --socket FRONT [...]

`detect` (the default command: a bare path runs it), `diff`,
`license-path`, `version` and `help` are the reference's verbs
(`bin/licensee`), with the JAX package's output byte for byte but for
the package in `detect`'s ``Matcher:`` line and the program name in
`help`.  They run the per-file matcher chain Copyright -> Exact -> Dice
on the host over a directory, a file, a git repository or a GitHub
URL; `diff --socket` sends the diff to a `serve` worker instead
(`fleet/wire.py`), which renders it with difflib, not git.

`batch-detect` classifies a manifest of loose files and tar, zip and git
containers, local or (archives) over http(s) (one entry per line:
``path``, ``archive.tar::member``, ``archive.zip::*``, ``repo.git::HEAD``,
``https://host/release.tar.gz::*``) and writes JSONL rows, and for
containers ``OUTPUT.containers.jsonl``, byte-identical to the JAX package's
`licensee-tpu batch-detect`, through the same pipeline: featurize worker
threads (or processes), coalesced device chunks, an overlap pipeline of
device groups in flight, a writer thread, and resume of a partial
``--output`` from its ``.meta.json`` sidecar.  Without ``--output`` it
prints the rows (and the container verdicts after them) on stdout from
one unpipelined pass.  It runs on the CUDA device unless ``--device
cpu`` asks for the plain PyTorch scorers on the CPU.  `corpus-build`
writes a corpus artifact in the JAX package's format
(`corpus/artifact.py`).  `serve` is the online worker: the JAX
package's micro-batcher (`serve/scheduler.py`) and JSONL protocol
(`serve/server.py`) over stdio or a Unix or TCP socket, scoring each
flush with K1 on the card unless ``--device cpu`` is given.
``--stripes N`` scales `batch-detect` out over N worker processes, each
one stripe of the manifest, and merges their shards
(`parallel/stripes.py`); ``--mesh`` and ``--device-lanes`` spread one
process's scoring over several devices (`parallel/mesh.py`).  `fleet`
supervises N `serve` workers (each on the card unless ``--device cpu``)
behind one routed front socket and an optional HTTP edge
(`fleet/supervisor.py`, `fleet/router.py`, `fleet/http_edge.py`);
`stats`, `traces`, `slo`, `top` and `alerts` read a worker or a fleet's
front door (the metrics store, the trace collector and the anomaly
watchdog live in the router: `obs/tsdb.py`, `obs/collect.py`,
`obs/anomaly.py`).  `fleet --tenants` serves several tenants, one
worker pool each on its own corpus, with self-serve corpus onboarding
on the edge's ``POST /corpus`` (`tenancy/`); `fleet --jobs-dir` adds the
durable jobs tier behind ``POST /jobs`` (`jobs/executor.py`), whose jobs
run as `batch-detect` stripes on the fleet's ``--device``, and the
`jobs` verb submits and tracks them over the edge (`jobs/client.py`).
"""

from __future__ import annotations

import argparse
import io
import json
import os
import re
import subprocess
import sys
import tempfile

import licensee_tpu_torch
from licensee_tpu_torch.kernels.batch import METHODS
from licensee_tpu_torch.normalize.pipeline import format_percent


def _print_table(rows, indent: int = 0) -> None:
    if not rows:
        return
    width = max(len(str(row[0])) for row in rows)
    for label, value in rows:
        print(" " * indent + f"{str(label):<{width}}  {value}")


def _resolve_path(args) -> str:
    path = args.path or os.getcwd()
    if args.remote and not re.match(r"^https://", path):
        return f"https://github.com/{path}"
    return path


def _build_project(args, path: str):
    return licensee_tpu_torch.project(
        path,
        detect_packages=args.packages,
        detect_readme=args.readme,
        ref=getattr(args, "ref", None),
    )


def _licenses_by_similarity(matched_file):
    """Every candidate ranked by similarity, for the closest-licenses
    view.  commands/detect.rb:97-102 means to widen the pool to hidden
    licenses, but sets @potential_licenses where the memoized reader
    checks @potential_matches, so the pool is Dice's own (hidden
    included, pseudo excluded); so is this one."""
    from licensee_tpu_torch.matchers import Dice

    return Dice(matched_file).matches_by_similarity


def cmd_detect(args) -> int:
    from licensee_tpu_torch.project_files.license_file import LicenseFile

    licensee_tpu_torch.set_confidence_threshold(args.confidence)
    path = _resolve_path(args)
    project = _build_project(args, path)

    if args.json:
        print(json.dumps(project.to_h()))
        return 0 if project.licenses else 1

    rows = []
    if project.license:
        rows.append(["License:", project.license.spdx_id])
    elif project.licenses:
        rows.append(["Licenses:", [lic.spdx_id for lic in project.licenses]])
    else:
        rows.append(["License:", "None"])
    if project.matched_files:
        rows.append(
            ["Matched files:", ", ".join(f.filename for f in project.matched_files)]
        )
    _print_table(rows)

    for matched_file in project.matched_files:
        print(f"{matched_file.filename}:")
        rows = []
        if matched_file.content_hash:
            rows.append(["Content hash:", matched_file.content_hash])
        if matched_file.attribution:
            rows.append(["Attribution:", matched_file.attribution])
        if matched_file.confidence is not None:
            rows.append(["Confidence:", format_percent(matched_file.confidence)])
        if matched_file.matcher:
            matcher_cls = type(matched_file.matcher)
            rows.append(
                ["Matcher:", f"{matcher_cls.__module__}.{matcher_cls.__name__}"]
            )
        if matched_file.license:
            rows.append(["License:", matched_file.license.spdx_id])
        _print_table(rows, indent=2)

        if not isinstance(matched_file, LicenseFile):
            continue
        if matched_file.confidence == 100:
            continue
        ranked = _licenses_by_similarity(matched_file)
        if not ranked:
            continue
        print("  Closest non-matching licenses:")
        _print_table(
            [
                [f"{lic.meta['spdx-id']} similarity:", format_percent(sim)]
                for lic, sim in ranked[:3]
            ],
            indent=4,
        )

    if project.license_file and (args.license or args.diff):
        license_key = args.license
        if not license_key:
            ranked = _licenses_by_similarity(project.license_file)
            license_key = ranked[0][0].key if ranked else None
        if license_key:
            return _diff(license_key, project.license_file)

    return 0 if project.licenses else 1


def _diff(license_key: str, license_to_diff) -> int:
    from licensee_tpu_torch.corpus.license import License

    expected = License.find(license_key)
    if expected is None:
        print(f"{license_key} is not a valid license", file=sys.stderr)
        keys = ", ".join(lic.key for lic in License.all(hidden=True))
        print(f"Valid licenses: {keys}", file=sys.stderr)
        return 1

    print(f"Comparing to {expected.name}:")
    left = expected.content_normalized(wrap_at=80)
    right = license_to_diff.content_normalized(wrap_at=80)
    similarity = expected.similarity(license_to_diff)
    _print_table(
        [
            ["Input Length:", license_to_diff.length],
            ["License length:", expected.length],
            ["Similarity:", format_percent(similarity)],
        ]
    )
    if left == right:
        print("Exact match!")
        return 0

    # the word diff of the normalized, wrapped texts: commands/diff.rb:27-37
    # commits the template in a temporary repository and lets git diff
    # the input against it, and so does this
    with tempfile.TemporaryDirectory() as tmpdir:
        path = os.path.join(tmpdir, "LICENSE")
        env = {**os.environ, "GIT_CONFIG_GLOBAL": "/dev/null", "GIT_CONFIG_SYSTEM": "/dev/null"}
        subprocess.run(["git", "init", "-q"], cwd=tmpdir, check=True, env=env)
        with open(path, "w", encoding="utf-8") as f:
            f.write(left or "")
        subprocess.run(["git", "add", "LICENSE"], cwd=tmpdir, check=True, env=env)
        subprocess.run(
            ["git", "-c", "user.email=licensee@tpu.invalid", "-c", "user.name=licensee-tpu",
             "commit", "-q", "-m", "left"],
            cwd=tmpdir,
            check=True,
            env=env,
        )
        with open(path, "w", encoding="utf-8") as f:
            f.write(right or "")
        result = subprocess.run(
            ["git", "diff", "--word-diff"],
            cwd=tmpdir,
            capture_output=True,
            text=True,
            env=env,
        )
        print(result.stdout)
    return 0


def cmd_diff(args) -> int:
    from licensee_tpu_torch.project_files.license_file import LicenseFile

    if not args.license and not args.socket:
        print(
            "Usage: provide a license to diff against with --license (spdx name)",
            file=sys.stderr,
        )
        return 1

    path = _resolve_path(args)
    file = None
    # diff.rb:43-47: the text on stdin where there is one, else the
    # project's license file
    if not sys.stdin.isatty():
        try:
            content = sys.stdin.read()
        except OSError:
            content = ""
        if content:
            file = LicenseFile(content, "LICENSE")
    if file is None:
        project = _build_project(args, path)
        file = project.license_file
        if file is None:
            print("No license file found", file=sys.stderr)
            return 1
    if args.socket:
        return _diff_via_worker(args, file)
    return _diff(args.license, file)


def _diff_via_worker(args, file) -> int:
    """The wire form of the diff command: one ``{"op": "diff"}`` round
    trip to a serving worker (`fleet/wire.py:oneshot`), which normalizes
    the blob through the featurizer's own pipeline and word-diffs it
    against the closest (or ``--license``-named) template: no local
    corpus build and no git."""
    from licensee_tpu_torch.fleet.wire import oneshot

    request = {"op": "diff", "content": file.content or ""}
    if file.filename:
        request["filename"] = file.filename
    if args.license:
        request["license"] = args.license
    try:
        row = oneshot(args.socket, request, args.timeout)
    except OSError as exc:
        print(f"error: cannot reach worker: {exc}", file=sys.stderr)
        return 1
    if row.get("error"):
        print(f"error: {row['error']}", file=sys.stderr)
        return 1
    diff = row.get("diff") or {}
    if diff.get("key") is None:
        print("No comparable license template", file=sys.stderr)
        return 1
    print(f"Comparing to {diff.get('spdx_id') or diff.get('key')}:")
    _print_table(
        [
            ["Input Length:", diff.get("input_length")],
            ["License length:", diff.get("license_length")],
            ["Similarity:", format_percent(diff.get("similarity") or 0.0)],
        ]
    )
    if diff.get("identical"):
        print("Exact match!")
        return 0
    print(diff.get("diff") or "")
    return 0


def cmd_license_path(args) -> int:
    path = _resolve_path(args)
    project = licensee_tpu_torch.project(path)
    if not project.license_file:
        return 1
    if path.startswith("https://"):
        print(project.license_file.path)
    else:
        print(os.path.abspath(os.path.join(path, project.license_file.path)))
    return 0


def cmd_version(_args) -> int:
    print(licensee_tpu_torch.__version__)
    return 0


def cmd_help(args) -> int:
    """The Thor-style command listing (`licensee help`; bin_spec.rb:21
    expects a "commands:" header naming every subcommand), or with a
    topic that command's own --help."""
    if args.topic:
        # argparse raises SystemExit(0) after printing the help
        try:
            args.parser.parse_args([args.topic, "--help"])
        except SystemExit as exc:
            return int(exc.code or 0)
        return 0
    print("Licensee commands:")
    for choice, help_text in COMMANDS:
        print(f"  {PROG} {choice:<24} # {help_text}")
    return 0


def load_corpus(source: str):
    """The compiled corpus a ``--corpus`` value names, None for the
    default (vendored) pool: ``spdx`` is the vendored SPDX
    license-list-XML mirror, a directory an SPDX ``src/`` checkout, a
    file a corpus artifact (`corpus/artifact.py:resolve_corpus`, which
    checks the artifact against its fingerprint).  Raises ValueError
    (`ArtifactError`) for a source it cannot load."""
    if source == "vendored":
        return None
    from licensee_tpu_torch.corpus.artifact import (
        ArtifactError,
        resolve_corpus,
    )

    try:
        corpus, _fp, _manifest = resolve_corpus(source)
    except (ArtifactError, OSError) as exc:
        raise ArtifactError(f"cannot load corpus {source!r}: {exc}") from exc
    return corpus


def _atomic_write(path: str, text: str) -> None:
    """Write-then-replace, so a supervisor polling ``path`` never reads a
    torn file (the --stats-file/--prom-file contract)."""
    tmp = f"{path}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(text)
    os.replace(tmp, path)


class _PromHeartbeat:
    """Periodic atomic ``--prom-file`` dumps while a batch run is in
    flight, each stamped with a rising ``stripe_scrape_epoch`` gauge.
    The elastic stripe runner scrapes them for the live lane gauges; the
    epoch is its proof of freshness (a killed stripe's last dump stops
    advancing and reads as stale).  The run's final dump
    (`_dump_run_artifacts`) then overwrites it with the full exposition
    the merge reads."""

    def __init__(self, path: str, interval_s: float = 1.0):
        import threading

        from licensee_tpu_torch.obs import get_registry, render_prometheus

        self.path = path
        self.interval_s = float(interval_s)
        self._epoch = 0
        self._render = render_prometheus
        self._registry = get_registry()
        self._registry.gauge(
            "stripe_scrape_epoch",
            "Monotonic heartbeat counter stamped into every periodic "
            "--prom-file dump; an autoscaler accepts the exposition "
            "only while this advances",
        ).set_fn(lambda: self._epoch)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="prom-heartbeat", daemon=True
        )

    def _beat(self) -> None:
        self._epoch += 1
        try:
            _atomic_write(self.path, self._render(self._registry))
        except OSError:
            pass  # a full disk must not kill the run; the merge retries

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._beat()

    def start(self) -> "_PromHeartbeat":
        self._beat()  # the first exposition lands before the first batch
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)


def _check_output_dir(output: str) -> str | None:
    """The one --output misconfiguration named precisely (shared by the
    single-process and striped paths), or None."""
    out_dir = os.path.dirname(os.path.abspath(output))
    if os.path.isdir(out_dir):
        return None
    problem = (
        "is not a directory" if os.path.exists(out_dir) else "does not exist"
    )
    return f"output directory {problem}: {out_dir}"


def _parse_mesh(value: str | None, default):
    """A --mesh value: None (flag absent: ``default``), ``none``,
    ``auto`` or ``DATA[,MODEL]``; raises ValueError on a bad value."""
    if not value:
        return default
    if value == "none":
        return None
    if value == "auto":
        return "auto"
    try:
        parts = [int(p) for p in value.split(",")]
        return (parts[0], parts[1] if len(parts) > 1 else 1)
    except ValueError:
        raise ValueError(
            f"bad --mesh {value!r} (want DATA[,MODEL])"
        ) from None


def _run_striped(args) -> int:
    """`batch-detect --stripes N|auto|elastic`: supervise N child
    batch-detect workers, each one stripe of the manifest writing its own
    resumable shard, and merge their shards, stats and expositions
    (`parallel/stripes.py`).  This process scores nothing and never
    opens a CUDA context; each child inherits ``--device``."""
    from licensee_tpu_torch.parallel.stripes import (
        StripeError,
        StripeRunner,
        parse_stripes_arg,
    )

    if os.environ.get("LICENSEE_TPU_COORDINATOR") or os.environ.get(
        "LICENSEE_TPU_DISTRIBUTED"
    ):
        print(
            "error: --stripes is the single-host co-located launcher; "
            "it cannot run under the multi-host env contract "
            "(LICENSEE_TPU_COORDINATOR / LICENSEE_TPU_DISTRIBUTED) — "
            "launch one striped runner per host instead",
            file=sys.stderr,
        )
        return 1
    if args.stripe_index is not None or args.stripe_count is not None:
        print(
            "error: --stripes cannot be combined with the internal "
            "--stripe-index/--stripe-count worker flags",
            file=sys.stderr,
        )
        return 1
    if not args.output:
        print(
            "error: --stripes needs --output (per-stripe JSONL shards "
            "merge there)",
            file=sys.stderr,
        )
        return 1
    if args.profile:
        print(
            "error: --profile traces one process; run the worker "
            "directly (--stripe-index/--stripe-count) to profile a "
            "single stripe",
            file=sys.stderr,
        )
        return 1
    try:
        n_stripes = parse_stripes_arg(args.stripes)
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    # --stripes elastic: start at the lower bound and let the runner's
    # autoscaler move the stripe count against each stripe's measured
    # featurize-lane occupancy (its --prom-file heartbeat); every scale
    # event is a drain and a resume-safe respawn
    elastic = None
    if n_stripes == "elastic":
        from licensee_tpu_torch.parallel.autoscale import AutoscaleConfig

        try:
            elastic = AutoscaleConfig(
                min_units=args.autoscale_min,
                max_units=args.autoscale_max,
                cooldown_s=args.autoscale_cooldown,
            )
        except ValueError as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 1
        n_stripes = elastic.min_units
    dir_err = _check_output_dir(args.output)
    if dir_err:
        print(f"error: {dir_err}", file=sys.stderr)
        return 1
    if args.corpus not in ("vendored", "spdx") and not os.path.isdir(
        args.corpus
    ) and not os.path.isfile(args.corpus):
        print(
            f"error: cannot load corpus {args.corpus!r}: not a "
            "directory or artifact file",
            file=sys.stderr,
        )
        return 1
    # the resume preflight over the merged output's sidecar: a complete
    # merged output would otherwise answer before any worker runs, with
    # rows of another configuration.  The probe compiles the corpus in
    # this process, only where a resume target exists, on a host-only
    # classifier (device=None: no CUDA context; the stripes own the card)
    probe_layout = None
    if not args.no_resume and os.path.exists(args.output) and (
        os.path.exists(f"{args.output}.meta.json")
    ):
        from licensee_tpu_torch.ingest.sources import is_container_entry
        from licensee_tpu_torch.kernels.batch import BatchClassifier
        from licensee_tpu_torch.projects.batch_project import (
            BatchProject,
            ResumeConfigError,
        )

        # a container manifest's expansion fingerprint is part of the
        # compared configuration, so the probe expands the same manifest
        probe_paths: list[str] = []
        with open(args.manifest, encoding="utf-8") as f:
            if any(is_container_entry(line.strip()) for line in f):
                with open(args.manifest, encoding="utf-8") as f2:
                    probe_paths = [
                        line.strip() for line in f2 if line.strip()
                    ]
        probe = None
        try:
            classifier = BatchClassifier(
                corpus=load_corpus(args.corpus),
                method=args.method,
                pad_batch_to=args.batch_size,
                mode=args.mode,
                closest=args.closest,
                device=None,
            )
            probe = BatchProject(
                probe_paths,
                classifier=classifier,
                batch_size=args.batch_size,
                threshold=args.confidence,
                attribution=args.attribution,
                process_index=0,
                process_count=1,
                corpus_source=args.corpus,
            )
            probe._check_resume_config(args.output, resume=True)
            if probe.ingest is not None:
                # the runner reuses the probe's layout, not a second scan
                probe_layout = probe.ingest.layout()
        except (ResumeConfigError, ValueError) as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 1
        finally:
            if probe is not None:
                probe.close()

    # everything row-shaping or speed-relevant forwards to the workers;
    # --workers splits the host's cores over the stripes unless given
    forward: list[str] = ["--batch-size", str(args.batch_size)]
    workers = args.workers or max(1, (os.cpu_count() or 1) // n_stripes)
    forward += ["--workers", str(workers)]
    for flag, value, default in (
        ("--corpus", args.corpus, "vendored"),
        ("--method", args.method, "auto"),
        ("--mode", args.mode, "license"),
        ("--mesh", args.mesh, None),
        ("--confidence", args.confidence, None),
        ("--coalesce-batches", args.coalesce_batches, 32),
        ("--pipeline-depth", args.pipeline_depth, 2),
        ("--device", args.device, "cuda"),
    ):
        if value is not None and value != default:
            forward += [flag, str(value)]
    if args.device_lanes is not None:
        forward += ["--device-lanes", str(args.device_lanes)]
    elif (
        args.chips_per_stripe is not None
        and args.chips_per_stripe > 1
        and args.mesh in (None, "auto", "none")
    ):
        # a --chips-per-stripe K worker sees K devices; its chunks
        # round-robin over them unless an explicit --mesh shards them
        forward += ["--device-lanes", "auto"]
    if args.closest:
        forward += ["--closest", str(args.closest)]
    if args.attribution:
        forward += ["--attribution"]
    if args.no_dedupe:
        forward += ["--no-dedupe"]
    if args.featurize_procs:
        forward += ["--featurize-procs", str(args.featurize_procs)]

    def event(message: str) -> None:
        print(f"stripes: {message}", file=sys.stderr, flush=True)

    try:
        runner = StripeRunner(
            args.manifest,
            args.output,
            n_stripes,
            forward_args=tuple(forward),
            resume=not args.no_resume,
            auto_clamp=args.stripes == "auto",
            chips_per_stripe=args.chips_per_stripe,
            progress_every=args.progress,
            on_event=event,
            container_layout=probe_layout,
            elastic=elastic,
        )
    except (OSError, ValueError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1

    import signal as signallib

    previous = {}

    def _stop(signum, _frame):
        event(f"signal {signum}: draining stripes (resume-safe)")
        runner.request_stop()

    for sig in (signallib.SIGTERM, signallib.SIGINT):
        try:
            previous[sig] = signallib.signal(sig, _stop)
        except ValueError:
            pass  # not the main thread (tests drive this in-process)
    try:
        summary = runner.run()
    except StripeError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    finally:
        for sig, handler in previous.items():
            try:
                signallib.signal(sig, handler)
            except ValueError:
                pass
    # --stats-file / --prom-file name the merged files here (each
    # worker's per-shard dumps are the merge's inputs)
    if args.stats_file:
        if summary.get("stats") is not None:
            _atomic_write(
                args.stats_file, json.dumps(summary["stats"]) + "\n"
            )
        else:
            event(
                f"warning: no merged stats available; {args.stats_file} "
                "not written"
            )
    if args.prom_file:
        if summary.get("prom"):
            if os.path.abspath(args.prom_file) != os.path.abspath(
                summary["prom"]
            ):
                import shutil

                tmp = f"{args.prom_file}.tmp"
                shutil.copyfile(summary["prom"], tmp)
                os.replace(tmp, args.prom_file)
        else:
            event(
                f"warning: no merged exposition available; "
                f"{args.prom_file} not written"
            )
    if args.stats and summary.get("stats") is not None:
        print(json.dumps(summary["stats"]), file=sys.stderr)
    if summary.get("autoscale"):
        auto = summary["autoscale"]
        event(
            f"autoscale: {auto['initial_stripes']} -> "
            f"{auto['final_stripes']} stripes over "
            f"{auto['scale_events']} rescale(s)"
        )
    event(
        f"done: {summary['rows_written']} rows in "
        f"{summary.get('elapsed_s', 0.0)}s"
        + (
            f" ({summary['files_per_sec']} files/sec)"
            if summary.get("files_per_sec")
            else ""
        )
    )
    return 0


def _dump_run_artifacts(args, stats) -> None:
    """--stats-file / --prom-file: the run's stats JSON and a Prometheus
    exposition of the process registry (the pipeline's lanes, the stage
    seconds and result counters of the run, the native featurizer's
    profile), each replaced atomically; the stripe runner merges them."""
    if args.stats_file:
        _atomic_write(args.stats_file, json.dumps(stats.as_dict()) + "\n")
    if args.prom_file:
        from licensee_tpu_torch.obs import (
            NativeProfileSource,
            get_registry,
            render_prometheus,
        )

        registry = get_registry()
        NativeProfileSource(registry)
        stage_g = registry.gauge(
            "batch_stage_seconds",
            "Per-stage seconds of the last batch run (thread-seconds "
            "for read/featurize, wall for elapsed)",
            labels=("stage",),
        )
        for stage, seconds in stats.stage_seconds.items():
            stage_g.labels(stage=stage).set(seconds)
        rows_g = registry.gauge(
            "batch_rows",
            "Result counters of the last batch run",
            labels=("kind",),
        )
        for kind in (
            "total", "dice_matched", "reference_matched",
            "package_matched", "prefiltered_copyright",
            "prefiltered_exact", "unmatched", "read_errors",
            "featurize_errors", "dedupe_hits", "skipped_oversized",
        ):
            rows_g.labels(kind=kind).set(getattr(stats, kind))
        # the port's own: the card kernels this process launched, so a
        # striped run's merged exposition shows each stripe's kernels
        launch_gauge(registry)()
        _atomic_write(args.prom_file, render_prometheus(registry))


def launch_gauge(registry):
    """The port's ``device_kernel_launches{kernel=...}`` gauge on
    ``registry``, and the function that sets it to the card kernels
    this process has launched (`dice_cuda.LAUNCHES`): `batch-detect
    --prom-file` calls it once, each `serve` worker at every scrape, so
    a striped run's or a fleet's merged exposition shows the kernels of
    each process."""
    from licensee_tpu_torch.kernels import dice_cuda

    launch_g = registry.gauge(
        "device_kernel_launches",
        "Kernel launches on the card by this process, by kernel",
        labels=("kernel",),
    )

    def collect(_registry=None) -> None:
        for kernel, n in dice_cuda.LAUNCHES.items():
            launch_g.labels(kernel=kernel).set(n)

    return collect


class _Profile:
    """``--profile DIR``: a `torch.profiler` trace of the run (the host
    and, on a card, its kernels), written as ``DIR/trace.json``, the
    Chrome trace format."""

    def __init__(self, out_dir: str, device: str):
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if device == "cuda" and torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.out_dir = out_dir
        self._prof = torch.profiler.profile(activities=activities)
        self._prof.start()

    def stop(self) -> None:
        self._prof.stop()
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, "trace.json")
        self._prof.export_chrome_trace(path)
        print(f"profile trace written to {path}", file=sys.stderr)


def cmd_batch_detect(args) -> int:
    """Classify a manifest: with --output through the pipelined, resumable
    `BatchProject.run`; without it, the rows on stdout from one pass.
    --stripes N|auto|elastic scales out over N co-located worker
    processes (`parallel/stripes.py`)."""
    if args.selftest:
        from licensee_tpu_torch.parallel.stripes import selftest

        return selftest(device=args.device)
    if args.selftest_autoscale:
        from licensee_tpu_torch.parallel.stripes import selftest_autoscale

        return selftest_autoscale()
    if args.selftest_remote:
        from licensee_tpu_torch.parallel.stripes import selftest_remote

        return selftest_remote(device=args.device)
    if not args.manifest:
        print(
            "error: need a manifest (one path per line), or --selftest",
            file=sys.stderr,
        )
        return 1
    if not os.path.exists(args.manifest):
        print(
            f"error: cannot read manifest: {args.manifest!r} not found",
            file=sys.stderr,
        )
        return 1
    if args.stripes is not None:
        # container manifests stripe too, by their expanded rows
        return _run_striped(args)
    try:
        mesh = _parse_mesh(args.mesh, "auto")
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    # a multi-process world from the environment (LICENSEE_TPU_COORDINATOR,
    # _NUM_PROCESSES, _PROCESS_ID): this process classifies its stripe
    # of the manifest and writes its own shard
    from licensee_tpu_torch.parallel.distributed import maybe_initialize

    process_index, process_count = maybe_initialize()
    if process_count > 1 and not args.output:
        print(
            "error: multi-host runs need --output (per-host JSONL shards)",
            file=sys.stderr,
        )
        return 1
    if process_count > 1:
        from licensee_tpu_torch.ingest.sources import is_container_entry

        with open(args.manifest, encoding="utf-8") as f:
            if any(is_container_entry(line.strip()) for line in f):
                # no merge step, so no merged output to derive the
                # container verdicts from
                print(
                    "warning: container entries in a multi-host run "
                    "write per-host blob shards only; the "
                    ".containers.jsonl sidecar is derived from a MERGED "
                    "output (the single-host --stripes runner does this "
                    "automatically)",
                    file=sys.stderr,
                )
    # the stripe worker's rank (the --stripes runner spawns workers with
    # these): the multi-process striping without the bootstrap, since
    # co-located stripes share no collective
    if (args.stripe_index is None) != (args.stripe_count is None):
        print(
            "error: --stripe-index and --stripe-count must be given "
            "together",
            file=sys.stderr,
        )
        return 1
    if args.stripe_index is not None:
        if process_count > 1:
            print(
                "error: stripe-worker flags cannot be combined with the "
                "multi-host env contract",
                file=sys.stderr,
            )
            return 1
        if not args.output:
            print(
                "error: stripe workers need --output (the shard path "
                "derives from it)",
                file=sys.stderr,
            )
            return 1
        if not 0 <= args.stripe_index < args.stripe_count:
            print(
                f"error: --stripe-index {args.stripe_index} out of range "
                f"for --stripe-count {args.stripe_count}",
                file=sys.stderr,
            )
            return 1
        process_index, process_count = args.stripe_index, args.stripe_count
    from licensee_tpu_torch.projects.batch_project import BatchProject

    try:
        project = BatchProject.from_manifest_file(
            args.manifest,
            corpus=load_corpus(args.corpus),
            method=args.method,
            batch_size=args.batch_size,
            threshold=args.confidence,
            workers=args.workers,
            mode=args.mode,
            dedupe=not args.no_dedupe,
            featurize_procs=args.featurize_procs,
            coalesce_batches=args.coalesce_batches,
            corpus_source=args.corpus,
            pipeline_depth=args.pipeline_depth,
            closest=args.closest,
            attribution=args.attribution,
            device=args.device,
            mesh=mesh,
            process_index=process_index,
            process_count=process_count,
            progress_every=args.progress,
            device_lanes=args.device_lanes,
        )
    except OSError as exc:
        print(f"error: cannot read manifest: {exc}", file=sys.stderr)
        return 1
    except (ValueError, RuntimeError) as exc:
        # a bad option, corpus or mesh, a torn container or a remote git
        # repository, or no CUDA device without --device cpu
        print(f"error: {exc}", file=sys.stderr)
        return 1
    from licensee_tpu_torch.projects.batch_project import ResumeConfigError

    profiler = _Profile(args.profile, args.device) if args.profile else None
    # the live --prom-file heartbeat, which the elastic stripe runner
    # scrapes for the lanes; the final dump overwrites it
    heartbeat = None
    if args.prom_file and args.output:
        heartbeat = _PromHeartbeat(args.prom_file).start()
    try:
        if args.output is None:
            stats = _print_rows(project)
        else:
            dir_err = _check_output_dir(args.output)
            if dir_err:
                print(f"error: {dir_err}", file=sys.stderr)
                return 1
            stats = project.run(args.output, resume=not args.no_resume)
    except OSError as exc:
        print(f"error: batch run I/O failure: {exc}", file=sys.stderr)
        return 1
    except ResumeConfigError as exc:
        # a resume whose mode/corpus/threshold/containers differ from the
        # run that wrote the output (the .meta.json sidecar)
        print(f"error: {exc}", file=sys.stderr)
        return 1
    finally:
        if heartbeat is not None:
            heartbeat.stop()
        project.close()
        if profiler is not None:
            profiler.stop()
    _dump_run_artifacts(args, stats)
    if args.stats:
        print(json.dumps(stats.as_dict()), file=sys.stderr)
    return 0


def _print_rows(project):
    """`batch-detect` without --output: every row on stdout, in the
    --output file's bytes, counted as the pipeline counts them (a read
    failure and the 64 KiB skip are no classification), then the
    container verdicts, grouped as the verdict file groups them."""
    from licensee_tpu_torch.ingest import SkippedBlob
    from licensee_tpu_torch.serve.featurize import jsonl_row

    stats = project.stats
    paths = project.paths
    contents, results = project.classify_paths(paths)
    rows = []
    for path, content, result in zip(paths, contents, results):
        error = None
        if content is None:
            error = "read_error"
            stats.read_errors += 1
        elif isinstance(content, SkippedBlob):
            error = content.error
            stats.skipped_oversized += 1
        elif result.error:
            error = result.error
            stats.featurize_errors += 1
        else:
            project._count(result)
        stats.total += 1
        line = jsonl_row(path, result, error)
        rows.append(line)
        print(line)
    ingest = project.ingest
    if ingest is not None and (ingest.spans or ingest.subsets):
        from licensee_tpu_torch.ingest.verdict import (
            container_groups,
            container_verdict,
        )

        for label, members in container_groups(ingest.spans, ingest.subsets):
            group = [
                (member if member is not None else paths[i],
                 json.loads(rows[i]))
                for i, member in members
            ]
            print(json.dumps(container_verdict(label, group)))
    return stats


def cmd_corpus_build(args) -> int:
    """Compile a corpus source into a fingerprinted artifact (the JAX
    package's format, `corpus/artifact.py`) and print its manifest, or
    verify and print an artifact's manifest (``--inspect``)."""
    from licensee_tpu_torch.corpus.artifact import (
        ArtifactError,
        load_artifact,
        resolve_corpus,
        write_artifact,
    )

    if args.inspect:
        try:
            _corpus, manifest = load_artifact(args.inspect)
        except ArtifactError as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 1
        print(json.dumps(manifest))
        return 0
    if not args.output:
        print(
            "error: need --output PATH (or --inspect ARTIFACT)",
            file=sys.stderr,
        )
        return 1
    out_dir = os.path.dirname(os.path.abspath(args.output))
    if not os.path.isdir(out_dir):
        problem = (
            "is not a directory" if os.path.exists(out_dir)
            else "does not exist"
        )
        print(f"error: output directory {problem}: {out_dir}",
              file=sys.stderr)
        return 1
    try:
        corpus, _fp, _manifest = resolve_corpus(args.corpus)
    except (ArtifactError, OSError) as exc:
        print(f"error: cannot load corpus {args.corpus!r}: {exc}",
              file=sys.stderr)
        return 1
    manifest = write_artifact(args.output, corpus, source=args.corpus)
    print(json.dumps(manifest))
    return 0


def cmd_serve(args) -> int:
    """The online serving worker: a persistent micro-batching front end
    over the device scorer (`serve/scheduler.py`).  Speaks
    newline-delimited JSON on stdin/stdout, or on a Unix domain (or
    TCP) socket with --socket, one session per connection, one shared
    cache and batcher.  Runs on the card unless --device cpu."""
    from licensee_tpu_torch.serve.server import (
        selftest,
        selftest_reload,
        serve_stdio,
        serve_unix,
    )

    if args.selftest:
        return selftest(device=args.device)
    if args.selftest_reload:
        return selftest_reload(device=args.device)
    try:
        corpus = load_corpus(args.corpus)
        mesh = _parse_mesh(args.mesh, None)
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    buckets = None
    if args.buckets:
        try:
            buckets = tuple(int(b) for b in args.buckets.split(","))
        except ValueError:
            print(f"error: bad --buckets {args.buckets!r} (want N,N,...)",
                  file=sys.stderr)
            return 1

    from licensee_tpu_torch.serve.scheduler import MicroBatcher

    # a socket worker gets a name (its socket's basename) and a flight
    # recorder at the path convention of `obs/flight.py`; a stdio
    # session keeps the in-process defaults
    flight = None
    proc_name = "serve"
    if args.socket:
        from licensee_tpu_torch.obs.flight import (
            FlightRecorder,
            flight_path_for_socket,
        )

        proc_name = os.path.basename(args.socket)
        if proc_name.endswith(".sock"):
            proc_name = proc_name[: -len(".sock")]
        flight = FlightRecorder(
            flight_path_for_socket(args.socket), proc=proc_name
        )
    try:
        batcher = MicroBatcher(
            corpus=corpus,
            method=args.method,
            mode=args.mode,
            max_batch=args.max_batch,
            max_delay_ms=args.max_delay_ms,
            queue_depth=args.queue_depth,
            cache_entries=args.cache_entries,
            cache_bytes=args.cache_bytes,
            deadline_ms=args.deadline_ms,
            threshold=args.confidence,
            buckets=buckets,
            pipeline_depth=args.pipeline_depth,
            # the worker always sets up its bucket shapes before the
            # first request
            warm_start=True,
            tracing=not args.no_tracing,
            trace_sample=args.trace_sample,
            trace_slow_ms=args.trace_slow_ms,
            trace_log=args.trace_log,
            trace_proc=proc_name,
            flight=flight,
            corpus_source=args.corpus,
            device=args.device,
            mesh=mesh,
        )
    except (ValueError, RuntimeError) as exc:
        # a bad option or mesh, or no CUDA device without --device cpu
        print(f"error: {exc}", file=sys.stderr)
        return 1
    batcher.obs.registry.add_collector(launch_gauge(batcher.obs.registry))
    if flight is not None:
        flight.register_metrics(batcher.obs.registry)
        flight.start()
        flight.record("boot", socket=args.socket)
    try:
        if args.socket:
            print(f"serving on {args.socket}", file=sys.stderr)
            serve_unix(batcher, args.socket)
        else:
            serve_stdio(batcher)
    except KeyboardInterrupt:
        pass
    finally:
        batcher.close()
        if flight is not None:
            flight.record("shutdown")
            flight.stop()
        if args.stats:
            print(json.dumps(batcher.stats()), file=sys.stderr)
    return 0


def _scrape_row(socket_path: str, request: dict, timeout: float) -> dict:
    """One control-verb round trip to a worker socket; raises OSError
    (WireError) on any transport or parse failure.  The wire protocol
    lives in ONE place — fleet/wire.py — shared with the router and
    supervisor probes (the module is stdlib-only, no device imports)."""
    from licensee_tpu_torch.fleet.wire import oneshot

    return oneshot(socket_path, request, timeout)


def socket_labels(sockets: list[str]) -> dict[str, str]:
    """Display label per scraped socket: the basename — unless two
    sockets share one (two fleets, each with a w0.sock), in which case
    the colliding entries keep their full paths so no worker silently
    vanishes from the merged view."""
    from collections import Counter

    counts = Counter(os.path.basename(s) for s in sockets)
    return {
        s: (
            os.path.basename(s)
            if counts[os.path.basename(s)] == 1
            else s
        )
        for s in sockets
    }


def stats_table_rows(
    snaps: dict, prev: dict | None = None, dt: float | None = None,
    rates: dict | None = None,
) -> list[list[str]]:
    """The merged fleet table: one row per scraped worker socket.
    ``snaps`` maps label -> stats dict (or None for an unreachable
    worker); ``prev``/``dt`` from the previous --watch round turn
    completed-counter deltas into a live req/s column.  ``rates``
    overrides REQ_S per label with a store-backed ``rate()`` (a target
    that serves ``{"op": "query"}`` has retained history, so the rate
    is honest from the FIRST frame); a None value there means the
    store is reachable but has no window yet — render "-", never a
    fabricated 0.0."""
    header = ["WORKER", "UP_S", "DONE", "Q", "INFL", "CACHE%", "CORPUS",
              "P50_MS", "P99_MS", "REQ_S"]
    rows = [header]
    for label, snap in snaps.items():
        if not snap:
            rows.append([label, "-", "-", "-", "-", "-", "-", "-", "-",
                         "down"])
            continue
        sched = snap.get("scheduler") or {}
        cache = snap.get("cache") or {}
        total = (snap.get("latency_ms") or {}).get("total") or {}
        hit_rate = cache.get("hit_rate")
        done = sched.get("completed")
        rate = "-"
        if rates is not None and label in rates:
            value = rates[label]
            rate = "-" if value is None else f"{value:.1f}"
        elif prev and dt and label in prev and prev[label]:
            before = (prev[label].get("scheduler") or {}).get("completed")
            if isinstance(done, (int, float)) and isinstance(
                before, (int, float)
            ) and dt >= 0.2 and done >= before:
                # done < before means the counter reset (the supervisor
                # restarted the worker): no honest rate this frame.
                # dt < 0.2s means two frames landed near-instantly
                # (--watch 0 drills): a delta over ~no time is noise —
                # keep "-" rather than print a made-up 0.0
                rate = f"{(done - before) / dt:.1f}"

        def cell(value, fmt="{}"):
            return "-" if value is None else fmt.format(value)

        # the serving fingerprint, short form — in a multi-tenant
        # fleet this is the column that shows which corpus each pool's
        # workers are actually on (and a roll sweeping through them)
        corpus_fp = (snap.get("corpus") or {}).get("fingerprint")
        rows.append([
            label,
            cell(snap.get("uptime_s"), "{:.0f}"),
            cell(done),
            cell(sched.get("queue_depth")),
            cell(sched.get("in_flight")),
            "-" if hit_rate is None else f"{hit_rate * 100:.1f}",
            corpus_fp[:12] if isinstance(corpus_fp, str) else "-",
            cell(total.get("p50_ms")),
            cell(total.get("p99_ms")),
            rate,
        ])
    return rows


def _render_table(rows: list[list[str]], stream) -> None:
    widths = [
        max(len(str(row[i])) for row in rows)
        for i in range(len(rows[0]))
    ]
    for row in rows:
        stream.write(
            "  ".join(str(c).ljust(w) for c, w in zip(row, widths)).rstrip()
            + "\n"
        )


def _store_req_rate(
    sock: str, timeout: float, window: float
) -> tuple[bool, float | None]:
    """REQ_S from the target's telemetry store: ``rate()`` over the
    stored completion counter via ``{"op": "query"}``.  Returns
    ``(capable, rate)``: capable False means the target is a bare
    worker with no store verb — the caller falls back to the
    completed-counter delta path; rate None means the store answered
    but has no two-sample window yet (render "-", never 0.0)."""
    try:
        row = _scrape_row(
            sock,
            {
                "op": "query", "series": "fleet_requests_total",
                "fn": "rate", "window": window,
                "labels": {"event": "ok"},
            },
            timeout,
        )
    except (OSError, ValueError):
        return False, None
    if "query" in row:
        value = (row["query"] or {}).get("value")
        return True, (None if value is None else float(value))
    if str(row.get("error", "")).startswith("unknown_series"):
        # a store-capable front whose scrape rounds have not minted
        # the series yet (cold start): keep querying, show "-" so far
        return True, None
    return False, None


def _stats_watch(
    sockets: list[str], interval: float, timeout: float,
    iterations: int | None = None,
) -> int:
    """The operator view of a fleet: scrape every socket, print ONE
    merged table, redraw every ``interval`` seconds (Ctrl-C stops).
    ``iterations`` bounds the loop (None = forever) — tests use it.

    REQ_S prefers the target's retained telemetry store (the fleet
    front's ``{"op": "query"}`` verb) — honest from the first frame;
    a bare worker without the verb keeps the two-frame
    completed-counter delta."""
    import itertools
    import time as timelib

    labels = socket_labels(sockets)
    prev: dict = {}
    prev_t: float | None = None
    # None = unprobed; the probe result is remembered so a bare worker
    # is asked exactly once, not re-probed into an error every frame
    capable: dict[str, bool | None] = {s: None for s in sockets}
    window = max(10.0, 2.0 * interval)
    for i in itertools.count():
        if iterations is not None and i >= iterations:
            return 0
        snaps = {}
        rates: dict = {}
        for sock in sockets:
            try:
                row = _scrape_row(sock, {"op": "stats"}, timeout)
                snaps[labels[sock]] = row.get("stats")
            except (OSError, ValueError):
                snaps[labels[sock]] = None
                continue
            if capable[sock] is not False:
                ok, value = _store_req_rate(sock, timeout, window)
                capable[sock] = ok
                if ok:
                    rates[labels[sock]] = value
        now = timelib.perf_counter()
        dt = None if prev_t is None else now - prev_t
        table = stats_table_rows(snaps, prev, dt, rates=rates)
        if interval > 0 and sys.stdout.isatty():
            sys.stdout.write("\x1b[2J\x1b[H")  # clear + home, like watch(1)
        _render_table(table, sys.stdout)
        sys.stdout.flush()
        prev, prev_t = snaps, now
        if interval <= 0:
            return 0
        try:
            timelib.sleep(interval)
        except KeyboardInterrupt:
            return 0


def cmd_stats(args) -> int:
    """Observability exporter client: scrape running serve workers'
    metrics (JSON, Prometheus exposition, or — for several --socket
    flags or --watch — one merged fleet table) or a trace tail over the
    Unix-socket control verbs, or run the obs-layer selftest."""
    if args.selftest:
        from licensee_tpu_torch.obs.selftest import selftest as obs_selftest

        return obs_selftest()
    sockets = args.socket or []
    if not sockets:
        print(
            "error: need --socket PATH (a running `licensee-tpu-torch serve "
            "--socket` worker; repeat for a fleet) or --selftest",
            file=sys.stderr,
        )
        return 1
    if args.trace is not None:
        if len(sockets) > 1:
            print(
                "error: --trace reads one worker at a time (one --socket)",
                file=sys.stderr,
            )
            return 1
        try:
            row = _scrape_row(
                sockets[0], {"op": "trace", "n": args.trace}, args.timeout
            )
        except (OSError, ValueError) as exc:
            print(
                f"error: cannot scrape {sockets[0]!r}: {exc}",
                file=sys.stderr,
            )
            return 1
        if "traces" not in row:
            print(f"error: unexpected response: {row}", file=sys.stderr)
            return 1
        for trace in row["traces"]:
            print(json.dumps(trace))
        return 0
    if args.format == "prometheus":
        labels = socket_labels(sockets)
        expositions = {}
        for sock in sockets:
            try:
                row = _scrape_row(
                    sock, {"op": "stats", "format": "prometheus"},
                    args.timeout,
                )
            except (OSError, ValueError) as exc:
                print(
                    f"error: cannot scrape {sock!r}: {exc}",
                    file=sys.stderr,
                )
                return 1
            if "prometheus" not in row:
                # a version-mismatched worker answering an error row
                # must fail the scrape loudly, never record an empty
                # exposition with exit 0
                print(
                    f"error: unexpected response from {sock!r}: {row}",
                    file=sys.stderr,
                )
                return 1
            expositions[labels[sock]] = row["prometheus"]
        if len(expositions) == 1:
            sys.stdout.write(next(iter(expositions.values())))
        else:
            from licensee_tpu_torch.obs import merge_expositions

            sys.stdout.write(merge_expositions(expositions))
        return 0
    if args.watch is not None or len(sockets) > 1:
        # the fleet operator view: merged table, optionally redrawn
        return _stats_watch(
            sockets, args.watch or 0.0, args.timeout,
            iterations=args.watch_iterations,
        )
    try:
        row = _scrape_row(sockets[0], {"op": "stats"}, args.timeout)
    except (OSError, ValueError) as exc:
        print(
            f"error: cannot scrape {sockets[0]!r}: {exc}", file=sys.stderr
        )
        return 1
    if "stats" in row:
        print(json.dumps(row["stats"]))
        return 0
    print(f"error: unexpected response: {row}", file=sys.stderr)
    return 1


def cmd_traces(args) -> int:
    """The telemetry-plane viewer: ask a fleet front socket for
    ASSEMBLED cross-process trace trees (`{"op": "traces"}` — router
    spans + every worker's serving spans joined by 16-hex trace ID,
    with critical-path self-times) and render them.  "Where did the
    p99 go" is one command: `licensee-tpu-torch traces --socket front.sock
    --slowest 1`."""
    from licensee_tpu_torch.obs.collect import render_tree

    payload: dict = {"op": "traces", "n": args.slowest or args.n}
    if args.id:
        payload["trace_id"] = args.id
    try:
        row = _scrape_row(args.socket, payload, args.timeout)
    except (OSError, ValueError) as exc:
        print(
            f"error: cannot scrape {args.socket!r}: {exc}",
            file=sys.stderr,
        )
        return 1
    trees = row.get("traces")
    if not isinstance(trees, list):
        print(
            f"error: unexpected response: {row} (is {args.socket!r} a "
            "fleet front socket? workers answer {'op': 'trace'} only)",
            file=sys.stderr,
        )
        return 1
    if args.slowest:
        trees = trees[: args.slowest]
    if not trees:
        print("no assembled traces retained", file=sys.stderr)
        return 1
    for i, tree in enumerate(trees):
        if args.json:
            print(json.dumps(tree))
        else:
            if i:
                print()
            print(render_tree(tree))
    return 0


def cmd_slo(args) -> int:
    """The SLO verdict: scrape a worker (or fleet front) socket's
    stats and render the multi-window burn-rate table (obs/slo.py).
    Exit 0 when every objective is inside its burn thresholds, 1 when
    any fast/slow burn alert fires."""
    try:
        row = _scrape_row(args.socket, {"op": "stats"}, args.timeout)
    except (OSError, ValueError) as exc:
        print(
            f"error: cannot scrape {args.socket!r}: {exc}",
            file=sys.stderr,
        )
        return 1
    slo = (row.get("stats") or {}).get("slo")
    if not isinstance(slo, dict):
        print(
            f"error: no slo block in stats from {args.socket!r}",
            file=sys.stderr,
        )
        return 1
    if args.json:
        print(json.dumps(slo))
        return 0 if slo.get("ok") else 1
    from licensee_tpu_torch.obs.slo import WINDOWS

    window_names = [w for w, _secs in WINDOWS]
    rows = [["OBJECTIVE", "TARGET", *[f"BURN_{w}" for w in window_names],
             "VERDICT"]]
    for name, obj in sorted((slo.get("objectives") or {}).items()):
        windows = obj.get("windows") or {}
        verdict = "ok"
        if obj.get("fast_burn_alert"):
            verdict = "PAGE (fast burn)"
        elif obj.get("slow_burn_alert"):
            verdict = "TICKET (slow burn)"
        rows.append([
            name,
            f"{obj.get('target', 0) * 100:g}%",
            *[str(windows.get(w, "-")) for w in window_names],
            verdict,
        ])
    _render_table(rows, sys.stdout)
    print(f"slo: {'ok' if slo.get('ok') else 'BURNING'}")
    return 0 if slo.get("ok") else 1


def cmd_alerts(args) -> int:
    """The anomaly watchdog's ledger: ask a fleet front socket for
    ``{"op": "alerts"}`` (the watchdog snapshot — active alerts,
    fire/clear history, declared rules) and render it.  Exit 0 when
    nothing is firing, 1 when any alert is active."""
    try:
        row = _scrape_row(args.socket, {"op": "alerts"}, args.timeout)
    except (OSError, ValueError) as exc:
        print(
            f"error: cannot scrape {args.socket!r}: {exc}",
            file=sys.stderr,
        )
        return 1
    snap = row.get("alerts")
    if not isinstance(snap, dict):
        # a bare worker answers bad_request: the watchdog lives on the
        # fleet front (the router owns the telemetry store)
        print(
            f"error: no alerts verb at {args.socket!r} (need a fleet "
            f"front socket): {row.get('error', row)}",
            file=sys.stderr,
        )
        return 1
    if args.json:
        print(json.dumps(snap))
        return 0 if not snap.get("active") else 1
    active = snap.get("active") or []
    rows = [["RULE", "KIND", "SERIES", "SINCE_S", "DETAIL"]]
    for alert in active:
        rows.append([
            alert.get("rule", "-"),
            alert.get("kind", "-"),
            alert.get("series", "-"),
            f"{alert.get('since_s', 0):.0f}",
            json.dumps(alert.get("detail") or {}),
        ])
    if active:
        _render_table(rows, sys.stdout)
    else:
        print("no active alerts")
    if args.history:
        history = (snap.get("history") or [])[-args.history:]
        for event in history:
            print(
                f"  {event.get('state', '?'):7s} {event.get('rule', '?')} "
                f"({event.get('series', '?')}) "
                f"{json.dumps(event.get('detail') or {})}"
            )
    print(
        f"alerts: {len(active)} active, "
        f"{snap.get('fired_total', 0)} fired total, "
        f"{len(snap.get('rules') or [])} rules"
    )
    return 0 if not active else 1


_SPARK_CHARS = "▁▂▃▄▅▆▇█"


def _spark(values: list) -> str:
    """A fixed-height unicode sparkline; None gaps render as spaces."""
    numeric = [v for v in values if v is not None]
    if not numeric:
        return ""
    lo, hi = min(numeric), max(numeric)
    span = hi - lo
    out = []
    for v in values:
        if v is None:
            out.append(" ")
        elif span <= 0:
            out.append(_SPARK_CHARS[0])
        else:
            idx = int((v - lo) / span * (len(_SPARK_CHARS) - 1) + 0.5)
            out.append(_SPARK_CHARS[min(idx, len(_SPARK_CHARS) - 1)])
    return "".join(out)


def _counter_rate_points(points: list) -> list:
    """Adjacent-pair rates over stored counter samples ([ts, value]
    rows from a ``fn=raw`` query); a negative step (counter reset)
    yields a None gap instead of a bogus negative rate."""
    out = []
    for (t0, v0), (t1, v1) in zip(points, points[1:]):
        if t1 <= t0:
            continue
        step = v1 - v0
        out.append(step / (t1 - t0) if step >= 0 else None)
    return out


def _top_query(sock: str, params: dict, timeout: float) -> dict | None:
    """One ``{"op": "query"}`` round trip; None on any miss (the
    dashboard renders what it can and dashes the rest)."""
    try:
        row = _scrape_row(sock, {"op": "query", **params}, timeout)
    except (OSError, ValueError):
        return None
    result = row.get("query")
    return result if isinstance(result, dict) else None


def _top_frame(sock: str, timeout: float, window: float) -> list[str]:
    """Render one ``top`` frame from the front socket's stats verb,
    alerts verb, and telemetry-store queries."""
    lines: list[str] = []
    try:
        stats = _scrape_row(
            sock, {"op": "stats"}, timeout
        ).get("stats") or {}
    except (OSError, ValueError) as exc:
        return [f"{PROG} top — {sock}: unreachable ({exc})"]
    tsdb = stats.get("tsdb") or {}
    scrape = tsdb.get("scrape") or {}
    alerts_block = stats.get("alerts") or {}
    lines.append(
        f"{PROG} top — {sock}   up {stats.get('uptime_s', 0):.0f}s   "
        f"store {tsdb.get('series', 0)} series / "
        f"{tsdb.get('bytes_est', 0)} B   "
        f"scrape rounds {scrape.get('rounds', 0)} "
        f"(lag {scrape.get('last_lag_s', 0):.2f}s)   "
        f"alerts {alerts_block.get('active', 0)} active"
    )
    lines.append("")
    # -- per-worker throughput + p99 from the stored series --
    # worker schedulers count finished work as event="completed"
    # ("ok" is the fleet-level counter, which has no worker label)
    rps = _top_query(
        sock,
        {"series": "serve_requests_total", "fn": "rate",
         "window": window, "labels": {"event": "completed"},
         "by": "worker"},
        timeout,
    )
    p99 = _top_query(
        sock,
        {"series": "serve_stage_seconds", "fn": "quantile", "q": 0.99,
         "window": window, "labels": {"stage": "total"}, "by": "worker"},
        timeout,
    )
    workers = sorted(
        set((rps or {}).get("groups") or {})
        | set((p99 or {}).get("groups") or {})
    )
    rows = [["WORKER", "REQ_S", "P99_MS", f"TREND({window:.0f}s)"]]
    for name in workers:
        rate_row = ((rps or {}).get("groups") or {}).get(name) or {}
        p99_row = ((p99 or {}).get("groups") or {}).get(name) or {}
        raw = _top_query(
            sock,
            {"series": "serve_requests_total", "fn": "raw",
             "window": window, "limit": 24,
             "labels": {"event": "completed", "worker": name}},
            timeout,
        )
        trend = _spark(_counter_rate_points((raw or {}).get("points") or []))
        rate = rate_row.get("value")
        q_value = p99_row.get("value")
        rows.append([
            name or "(unlabeled)",
            "-" if rate is None else f"{rate:.1f}",
            "-" if q_value is None else f"{q_value * 1000:.1f}",
            trend or "-",
        ])
    if workers:
        out = io.StringIO()
        _render_table(rows, out)
        lines.extend(out.getvalue().splitlines())
    else:
        lines.append("(no stored per-worker series yet)")
    # -- per-pool rollup, when a multi-tenant router publishes the
    # pool-labeled series (a single-pool fleet never registers them,
    # so this section simply does not render there) --
    pool_rps = _top_query(
        sock,
        {"series": "fleet_tenant_requests_total", "fn": "rate",
         "window": window, "labels": {"event": "ok"}, "by": "pool"},
        timeout,
    )
    pool_p99 = _top_query(
        sock,
        {"series": "fleet_tenant_request_seconds", "fn": "quantile",
         "q": 0.99, "window": window, "by": "pool"},
        timeout,
    )
    pool_names = sorted(
        set((pool_rps or {}).get("groups") or {})
        | set((pool_p99 or {}).get("groups") or {})
    )
    if pool_names:
        pool_rows = [["POOL", "REQ_S", "P99_MS"]]
        for name in pool_names:
            rate_row = ((pool_rps or {}).get("groups") or {}).get(name) or {}
            p99_row = ((pool_p99 or {}).get("groups") or {}).get(name) or {}
            rate = rate_row.get("value")
            q_value = p99_row.get("value")
            pool_rows.append([
                name or "(unlabeled)",
                "-" if rate is None else f"{rate:.1f}",
                "-" if q_value is None else f"{q_value * 1000:.1f}",
            ])
        lines.append("")
        out = io.StringIO()
        _render_table(pool_rows, out)
        lines.extend(out.getvalue().splitlines())
    # -- SLO burn --
    objectives = (stats.get("slo") or {}).get("objectives") or {}
    if objectives:
        lines.append("")
        for name, obj in sorted(objectives.items()):
            verdict = "ok"
            if obj.get("fast_burn_alert"):
                verdict = "PAGE"
            elif obj.get("slow_burn_alert"):
                verdict = "TICKET"
            sources = obj.get("window_sources") or {}
            stored = sum(1 for s in sources.values() if s == "store")
            lines.append(
                f"slo {name}: max burn {obj.get('max_burn', 0):g} "
                f"[{verdict}] ({stored}/{len(sources) or 0} windows "
                f"store-backed)"
            )
    # -- autoscale state, when a fleet autoscaler publishes it --
    units = _top_query(
        sock, {"series": "autoscale_capacity_units", "fn": "latest"},
        timeout,
    )
    if units is not None and units.get("value") is not None:
        pressure = _top_query(
            sock, {"series": "autoscale_pressure", "fn": "latest"},
            timeout,
        )
        p_value = (pressure or {}).get("value")
        lines.append(
            f"autoscale: {units['value']:.0f} units, pressure "
            + ("-" if p_value is None else f"{p_value:.2f}")
        )
    # -- active alerts --
    try:
        snap = _scrape_row(
            sock, {"op": "alerts"}, timeout
        ).get("alerts") or {}
    except (OSError, ValueError):
        snap = {}
    active = snap.get("active") or []
    if active:
        lines.append("")
        for alert in active:
            lines.append(
                f"ALERT {alert.get('rule', '?')} "
                f"({alert.get('series', '?')}, "
                f"{alert.get('since_s', 0):.0f}s): "
                f"{json.dumps(alert.get('detail') or {})}"
            )
    return lines


def cmd_top(args) -> int:
    """The live fleet dashboard: per-worker req/s + p99 with stored-
    sample sparklines, SLO burn, autoscale state, and active watchdog
    alerts — all read from a fleet front socket's telemetry store
    (``{"op": "stats"}`` / ``{"op": "query"}`` / ``{"op": "alerts"}``),
    redrawn every ``--interval`` seconds."""
    import itertools
    import time as timelib

    # a bare worker serves none of the store verbs: fail loudly once
    # instead of rendering an empty dashboard forever
    try:
        probe = _scrape_row(
            args.socket, {"op": "query", "list": True}, args.timeout
        )
    except (OSError, ValueError) as exc:
        print(
            f"error: cannot scrape {args.socket!r}: {exc}",
            file=sys.stderr,
        )
        return 1
    if "query" not in probe:
        print(
            f"error: no query verb at {args.socket!r} (need a fleet "
            f"front socket): {probe.get('error', probe)}",
            file=sys.stderr,
        )
        return 1
    window = max(30.0, 4.0 * args.interval)
    for i in itertools.count():
        if args.iterations is not None and i >= args.iterations:
            return 0
        lines = _top_frame(args.socket, args.timeout, window)
        if args.interval > 0 and sys.stdout.isatty():
            sys.stdout.write("\x1b[2J\x1b[H")
        sys.stdout.write("\n".join(lines) + "\n")
        sys.stdout.flush()
        if args.interval <= 0:
            return 0
        try:
            timelib.sleep(args.interval)
        except KeyboardInterrupt:
            return 0


def _jobs_option_value(value: str):
    # the jobs spec carries typed option values; the CLI gets strings.
    # Numbers coerce, everything else rides as-is — the edge's
    # validate_spec is the authority and answers 400 with a reason
    for kind in (int, float):
        try:
            return kind(value)
        except ValueError:
            continue
    return value


def cmd_jobs(args) -> int:
    """Client for the durable jobs tier: submit a manifest (or a local
    archive) as an async striped batch-detect job over a fleet's HTTP
    edge (jobs/executor.py behind POST /jobs), then poll its lifecycle,
    fetch the merged results, or cancel it."""
    from licensee_tpu_torch.jobs.client import JobsClient, JobsClientError

    if args.action != "submit" and not args.job_id:
        print(f"error: jobs {args.action} needs a JOB_ID", file=sys.stderr)
        return 1
    try:
        client = JobsClient(
            args.edge, token=args.token, timeout_s=args.timeout
        )
    except OSError as exc:
        print(f"error: cannot reach {args.edge!r}: {exc}", file=sys.stderr)
        return 1
    try:
        if args.action == "submit":
            spec: dict = {}
            if args.manifest:
                try:
                    with open(args.manifest, encoding="utf-8") as fh:
                        entries = [
                            line.strip() for line in fh if line.strip()
                        ]
                except OSError as exc:
                    print(
                        f"error: cannot read manifest: {exc}",
                        file=sys.stderr,
                    )
                    return 1
                spec["manifest"] = entries
            if args.archive:
                import base64

                try:
                    with open(args.archive, "rb") as fh:
                        blob = fh.read()
                except OSError as exc:
                    print(
                        f"error: cannot read archive: {exc}",
                        file=sys.stderr,
                    )
                    return 1
                spec["archive_b64"] = base64.b64encode(blob).decode("ascii")
                spec["archive_name"] = os.path.basename(args.archive)
            if not spec:
                print(
                    "error: jobs submit needs --manifest FILE and/or "
                    "--archive PATH",
                    file=sys.stderr,
                )
                return 1
            if args.stripes is not None:
                spec["stripes"] = args.stripes
            options: dict = {}
            for kv in args.option or ():
                key, sep, value = kv.partition("=")
                if not sep or not key:
                    print(
                        f"error: bad --option {kv!r} (want KEY=VALUE)",
                        file=sys.stderr,
                    )
                    return 1
                options[key] = _jobs_option_value(value)
            if options:
                spec["options"] = options
            if args.idempotency_key:
                spec["idempotency_key"] = args.idempotency_key
            code, row = client.submit(spec)
            if code not in (200, 202):
                print(
                    f"error: submit answered {code}: {row}",
                    file=sys.stderr,
                )
                return 1
            if args.wait:
                row = client.wait(
                    row["job_id"], timeout_s=args.wait_timeout
                )
            print(json.dumps(row))
            return 0 if row.get("state") != "failed" else 1
        if args.action == "status":
            code, row = client.status(args.job_id)
            if code != 200:
                print(
                    f"error: status answered {code}: {row}",
                    file=sys.stderr,
                )
                return 1
            print(json.dumps(row))
            return 0
        if args.action == "wait":
            row = client.wait(args.job_id, timeout_s=args.wait_timeout)
            print(json.dumps(row))
            return 0 if row.get("state") == "completed" else 1
        if args.action in ("results", "containers"):
            fetch = (
                client.results
                if args.action == "results"
                else client.containers
            )
            code, payload = fetch(args.job_id)
            if code != 200:
                print(
                    f"error: {args.action} answered {code}: "
                    f"{payload[:200]!r}",
                    file=sys.stderr,
                )
                return 1
            if args.output:
                with open(args.output, "wb") as fh:
                    fh.write(payload)
            else:
                sys.stdout.buffer.write(payload)
                sys.stdout.buffer.flush()
            return 0
        # cancel
        code, row = client.cancel(args.job_id)
        if code not in (200, 202):
            print(
                f"error: cancel answered {code}: {row}", file=sys.stderr
            )
            return 1
        print(json.dumps(row))
        return 0
    except JobsClientError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    except OSError as exc:
        print(f"error: edge connection failed: {exc}", file=sys.stderr)
        return 1
    finally:
        client.close()


def cmd_fleet(args) -> int:
    """The fleet tier: supervise N of the port's serve worker processes
    (restart on crash/wedge with backoff, drain on rolling restart)
    behind one health-checked, load-balanced, hedging front socket
    (fleet/supervisor.py + fleet/router.py) — optionally fronted by
    the HTTP/1.1 keep-alive edge (--http) and federated across hosts
    over TCP (--federate), with one worker pool per tenant (--tenants)
    and the durable jobs tier (--jobs-dir).  Every worker and every
    job's stripe runs on the card unless --device cpu."""
    if args.selftest:
        from licensee_tpu_torch.fleet.selftest import selftest

        return selftest(stub=args.stub, device=args.device)
    if args.selftest_reload:
        from licensee_tpu_torch.fleet.selftest import selftest_reload

        return selftest_reload(stub=args.stub, device=args.device)
    if args.selftest_tcp:
        from licensee_tpu_torch.fleet.selftest import selftest_tcp

        return selftest_tcp(stub=args.stub, device=args.device)
    if args.selftest_jobs:
        from licensee_tpu_torch.jobs.selftest import selftest_jobs

        return selftest_jobs(stub=args.stub, device=args.device)
    if args.selftest_tenant:
        from licensee_tpu_torch.fleet.selftest import selftest_tenant

        return selftest_tenant(stub=args.stub, device=args.device)
    if args.jobs_dir and not args.http:
        print(
            "error: --jobs-dir needs --http (jobs are submitted over "
            "the HTTP edge)",
            file=sys.stderr,
        )
        return 1
    if not args.socket and not args.http:
        print("error: need --socket PATH|HOST:PORT (the client-facing "
              "front door) and/or --http HOST:PORT, or --selftest",
              file=sys.stderr)
        return 1
    hedge_ms = args.hedge_ms
    if hedge_ms not in (None, "off", "auto"):
        try:
            hedge_ms = float(hedge_ms)
            if not (hedge_ms >= 0):
                raise ValueError
        except ValueError:
            print(
                f"error: bad --hedge-ms {args.hedge_ms!r} "
                "(want a number, 'auto', or 'off')",
                file=sys.stderr,
            )
            return 1
    if args.tenants and args.federate:
        print(
            "error: --tenants supervises local worker pools and cannot "
            "combine with --federate (put the registry on each member "
            "fleet instead)",
            file=sys.stderr,
        )
        return 1
    from licensee_tpu_torch.fleet.router import FrontServer, Router
    from licensee_tpu_torch.fleet.supervisor import Supervisor

    supervisor = None
    registry = None
    onboarder = None
    if args.federate:
        # the cross-host FRONT tier: every backend is another fleet's
        # front door (usually host:port); no local workers to spawn
        hosts = {
            f"host{i}": target.strip()
            for i, target in enumerate(args.federate.split(","))
            if target.strip()
        }
        if not hosts:
            print("error: --federate needs at least one target",
                  file=sys.stderr)
            return 1
        router = Router(
            hosts,
            hedge_ms=None if hedge_ms == "off" else hedge_ms,
            probe_interval_s=args.probe_interval_ms / 1000.0,
            pool_per_worker=args.pool_per_worker,
            merge_label="host",
        )
        print(
            f"fleet: federating {len(hosts)} host(s): "
            f"{', '.join(hosts.values())}",
            file=sys.stderr,
        )
    else:
        socket_dir = args.socket_dir or tempfile.mkdtemp(
            prefix="licensee-fleet-"
        )
        os.makedirs(socket_dir, exist_ok=True)
        serve_args: list[str] = []
        for flag, value in (
            ("--mode", args.mode),
            ("--method", args.method),
            ("--max-batch", args.max_batch),
            ("--max-delay-ms", args.max_delay_ms),
            ("--queue-depth", args.queue_depth),
            ("--cache-entries", args.cache_entries),
            ("--cache-bytes", args.cache_bytes),
            ("--trace-sample", args.trace_sample),
            # every worker of every pool, respawned and rolled ones too,
            # keeps the fleet's device in its argv
            ("--device", args.device),
        ):
            if value is not None:
                serve_args += [flag, str(value)]
        if args.tenants:
            # the multi-tenant topology: one supervisor per pool (each
            # with its own probe thread, restart backoff, and reload
            # lock), corpus per pool from the registry, the whole set
            # behind one router that routes by resolved corpus tag
            from licensee_tpu_torch.tenancy import (
                CorpusOnboarder, RegistryError, TenantPools, TenantRegistry,
            )

            try:
                registry = TenantRegistry(args.tenants)
            except RegistryError as exc:
                print(f"error: {exc}", file=sys.stderr)
                return 1
            pool_tenants = registry.pools()
            if not pool_tenants:
                print(
                    f"error: {args.tenants!r} defines no tenants",
                    file=sys.stderr,
                )
                registry.close()
                return 1
            tenants = registry.tenants()
            pool_sups = {}
            for pool, names in pool_tenants.items():
                pool_workers = {
                    f"{pool}{i}": os.path.join(
                        socket_dir, f"{pool}{i}.sock"
                    )
                    for i in range(args.workers)
                }
                # co-tenants of one pool share its corpus by
                # definition; the first (sorted) tenant's binding is it
                corpus = tenants[names[0]].corpus
                pool_sups[pool] = Supervisor(
                    pool_workers,
                    chips_per_worker=args.chips_per_worker,
                    serve_args=tuple(serve_args + ["--corpus", corpus]),
                    backoff_base_s=args.restart_backoff_ms / 1000.0,
                    probe_interval_s=args.probe_interval_ms / 1000.0,
                )
            supervisor = pools = TenantPools(
                pool_sups, default_pool=registry.default_pool
            )
            router = Router(
                pools.workers,
                supervisor=pools,
                hedge_ms=None if hedge_ms == "off" else hedge_ms,
                probe_interval_s=args.probe_interval_ms / 1000.0,
                pool_per_worker=args.pool_per_worker,
                pools=pools.worker_pools(),
                default_pool=pools.default_pool,
            )
            onboarder = CorpusOnboarder(
                registry, pools, router,
                staging_dir=os.path.join(socket_dir, "staging"),
                reload_kwargs={
                    "timeout_s": 120.0,
                    "health_timeout_s": args.boot_timeout,
                },
            )
            onboarder.sync_routes()
            print(
                f"fleet: {len(pool_sups)} tenant pool(s) "
                f"({', '.join(sorted(pool_sups))}) x {args.workers} "
                f"worker(s) under {socket_dir}, front door "
                f"{args.socket or args.http}",
                file=sys.stderr,
            )
        else:
            workers = {
                f"w{i}": os.path.join(socket_dir, f"w{i}.sock")
                for i in range(args.workers)
            }
            if args.corpus is not None:
                serve_args += ["--corpus", str(args.corpus)]
            supervisor = Supervisor(
                workers,
                chips_per_worker=args.chips_per_worker,
                serve_args=tuple(serve_args),
                backoff_base_s=args.restart_backoff_ms / 1000.0,
                probe_interval_s=args.probe_interval_ms / 1000.0,
            )
            router = Router(
                workers,
                supervisor=supervisor,
                hedge_ms=None if hedge_ms == "off" else hedge_ms,
                probe_interval_s=args.probe_interval_ms / 1000.0,
                pool_per_worker=args.pool_per_worker,
            )
            print(
                f"fleet: {args.workers} workers under {socket_dir}, "
                f"front door {args.socket or args.http}",
                file=sys.stderr,
            )
    from licensee_tpu_torch.serve.server import SocketInUseError

    if supervisor is not None:
        supervisor.start()
        if not supervisor.wait_healthy(args.boot_timeout):
            print(
                f"error: workers failed to boot: {supervisor.status()}",
                file=sys.stderr,
            )
            supervisor.stop()
            if registry is not None:
                registry.close()
            return 1
    router.start()
    if onboarder is not None:
        # replay rolls a crash interrupted: a journaled roll_start with
        # no terminal record re-validates and re-rolls at boot
        for row in onboarder.recover():
            print(f"fleet: recovered roll {json.dumps(row)}",
                  file=sys.stderr)
    executor = None
    if args.jobs_dir:
        # the durable jobs tier: journal-backed executor sharing the
        # router's metrics registry, its trace tail joined into the
        # collector so edge submit -> executor -> stripe spans
        # assemble under one trace ID; its stripes run on --device
        from licensee_tpu_torch.jobs.executor import JobExecutor

        executor = JobExecutor(
            args.jobs_dir,
            max_concurrent=args.jobs_concurrency,
            registry=router.obs.registry,
            device=args.device,
        )
        executor.start()
        router.collector.add_source("jobs", executor.trace_tail)
        resumed = executor.resumed_jobs
        print(
            f"fleet: jobs executor over {args.jobs_dir} "
            f"(concurrency {args.jobs_concurrency}"
            + (f", resumed {resumed} job(s)" if resumed else "")
            + ")",
            file=sys.stderr,
        )
    edge_tokens = None
    if registry is not None:
        # the registry's bearer tokens authenticate the edge, and the
        # edge's client label IS the tenant name — that identity is
        # what POST /corpus and per-tenant routing key off
        edge_tokens = dict(registry.tokens())
    if args.edge_token:
        edge_tokens = edge_tokens if edge_tokens is not None else {}
        for spec in args.edge_token:
            name, sep, tok = spec.partition("=")
            if sep and name and tok:
                edge_tokens[tok] = name
            else:
                edge_tokens[spec] = spec
    server = edge = None
    try:
        if args.socket:
            server = FrontServer(args.socket, router)
        if args.http:
            from licensee_tpu_torch.fleet.http_edge import HttpEdgeServer

            edge = HttpEdgeServer(
                args.http, router,
                tokens=edge_tokens,
                rate_per_client=args.edge_rate,
                burst=args.edge_burst,
                jobs=executor,
                tenancy=onboarder,
            )
            print(
                f"fleet: HTTP edge on {args.http}"
                f"{' (port ' + str(edge.bound_port) + ')' if edge.bound_port else ''}",
                file=sys.stderr,
            )
    except (SocketInUseError, OSError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        for srv in (server, edge):
            if srv is not None:
                srv.server_close()
        if executor is not None:
            executor.close()
        router.close()
        if supervisor is not None:
            supervisor.stop()
        if registry is not None:
            registry.close()
        return 1
    # long-lived serving process: the boot-time heap (imports, corpus,
    # supervisor state) never becomes garbage, but untuned gen2 GC
    # re-scans it forever — on the router's event loop that is a
    # ~100 ms stall per pass at saturation, pure tail latency.  Freeze
    # the boot heap out of collection.
    import gc

    gc.collect()
    gc.freeze()
    import signal as signallib
    import threading

    primary = server if server is not None else edge
    secondary = edge if server is not None else None

    def _term(*_):
        for srv in (primary, secondary):
            if srv is not None:
                threading.Thread(target=srv.shutdown, daemon=True).start()

    try:
        signallib.signal(signallib.SIGTERM, _term)
    except ValueError:
        pass
    secondary_thread = None
    if secondary is not None:
        # both doors share the router's ONE event loop; each facade
        # just parks a waiter thread until shutdown
        secondary_thread = threading.Thread(
            target=secondary.serve_forever,
            kwargs={"poll_interval": 0.2}, daemon=True,
        )
        secondary_thread.start()
    try:
        primary.serve_forever(poll_interval=0.2)
    except KeyboardInterrupt:
        pass
    finally:
        if secondary is not None:
            secondary.shutdown()
            secondary.server_close()
        if secondary_thread is not None:
            secondary_thread.join(timeout=5.0)
        primary.server_close()
        if args.socket and server is not None and server.kind == "unix":
            try:
                os.unlink(args.socket)
            except OSError:
                pass
        if executor is not None:
            # running jobs re-journal as queued and resume on the next
            # --jobs-dir boot; the journal keeps the durable state
            executor.close()
        router.close()
        if supervisor is not None:
            supervisor.stop()
        if registry is not None:
            registry.close()
        if args.stats:
            print(json.dumps(router.stats()), file=sys.stderr)
    return 0


def bounded(kind, lo):
    """An argparse type: ``kind`` no smaller than ``lo`` (NaN refused),
    so a typo fails before a large manifest loads."""

    def parse(value):
        v = kind(value)
        if not (v >= lo):
            raise argparse.ArgumentTypeError(f"must be >= {lo}, got {value!r}")
        return v

    # argparse embeds the callable's name in "invalid ... value"
    parse.__name__ = f">={lo} {kind.__name__}"
    return parse


def nonneg(kind):
    return bounded(kind, 0)


PROG = "licensee-tpu-torch"

# the one command table: build_parser() wires each entry into argparse
# and cmd_help() prints it (bin/licensee:10-43's Thor listing); the
# reference's verbs keep the JAX package's texts
COMMANDS = (
    ("detect", "Detect the license of the given project"),
    ("diff", "Compare license text to a known license"),
    ("license-path", "Path to the project's license file"),
    ("version", "Print the version"),
    ("help", "Describe available commands"),
    ("batch-detect", "Classify a manifest of files on the GPU batch path"),
    ("corpus-build", "Compile a corpus into a fingerprinted artifact"),
    ("serve", "Run the online micro-batching classification worker"),
    ("stats", "Scrape serve workers' metrics/traces (obs exporters)"),
    ("traces", "Render assembled cross-process trace trees (fleet)"),
    ("slo", "Evaluate SLO burn rates from a worker/fleet scrape"),
    ("top", "Live fleet dashboard from the retained telemetry store"),
    ("alerts", "Show the anomaly watchdog's active alerts and history"),
    ("fleet", "Supervise N serve workers behind one routed socket"),
    ("jobs", "Submit and track durable striped jobs over the HTTP edge"),
)
_COMMAND_HELP = dict(COMMANDS)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog=PROG, description="Detect the license of a project"
    )
    parser.add_argument(
        "--remote",
        action="store_true",
        help="Assume PATH is a GitHub owner/repo path",
    )
    sub = parser.add_subparsers(dest="command")

    def add_common(p):
        p.add_argument("path", nargs="?", default=None)
        p.add_argument("--packages", action=argparse.BooleanOptionalAction, default=True)
        p.add_argument("--readme", action=argparse.BooleanOptionalAction, default=True)
        p.add_argument("--remote", action="store_true")
        p.add_argument("--ref", default=None)

    detect = sub.add_parser("detect", help=_COMMAND_HELP["detect"])
    add_common(detect)
    detect.add_argument("--json", action="store_true")
    detect.add_argument(
        "--confidence", type=float, default=licensee_tpu_torch.CONFIDENCE_THRESHOLD
    )
    detect.add_argument("--license", default=None)
    detect.add_argument("--diff", action="store_true")
    detect.set_defaults(func=cmd_detect)

    diff = sub.add_parser("diff", help=_COMMAND_HELP["diff"])
    add_common(diff)
    diff.add_argument("--license", default=None)
    diff.add_argument(
        "--socket", default=None, metavar="PATH|HOST:PORT",
        help=(
            "Diff over the wire instead of locally: one {\"op\": "
            "\"diff\"} round trip to a live serve worker (closest "
            "template when --license is omitted)"
        ),
    )
    diff.add_argument(
        "--timeout", type=float, default=30.0,
        help="Wire diff round-trip timeout in seconds (default 30)",
    )
    diff.set_defaults(func=cmd_diff)

    lp = sub.add_parser("license-path", help=_COMMAND_HELP["license-path"])
    add_common(lp)
    lp.set_defaults(func=cmd_license_path)

    version = sub.add_parser("version", help=_COMMAND_HELP["version"])
    version.set_defaults(func=cmd_version)

    help_cmd = sub.add_parser("help", help=_COMMAND_HELP["help"])
    help_cmd.add_argument("topic", nargs="?", default=None)
    help_cmd.set_defaults(func=cmd_help, parser=parser)

    batch = sub.add_parser(
        "batch-detect", help=_COMMAND_HELP["batch-detect"]
    )
    batch.add_argument(
        "manifest", nargs="?", default=None,
        help=(
            "File with one entry per line: a path, or a local container "
            "member (archive.tar::LICENSE, archive.zip::*, repo.git::HEAD)"
        ),
    )
    batch.add_argument(
        "--output", default=None,
        help=(
            "Write the JSONL rows here through the pipelined, resumable "
            "run (without it, the rows go to stdout)"
        ),
    )
    batch.add_argument(
        "--no-resume", action="store_true",
        help="Restart from scratch instead of resuming a partial --output",
    )
    batch.add_argument(
        "--corpus", default="vendored",
        help=(
            "Template pool: 'vendored' (choosealicense, default), 'spdx' "
            "(the vendored SPDX license-list XMLs), a path to an SPDX "
            "license-list-XML src/ directory (e.g. the full ~600-license "
            "set), or a corpus artifact written by corpus-build"
        ),
    )
    batch.add_argument(
        "--method", default="auto", choices=list(METHODS),
        help=(
            "Device scoring path: popcount and pallas run the fused "
            "popcount kernel (K1); matmul and pallas-mxu the int8 "
            "tensor-core kernel (K2); auto picks one by template count.  "
            "On the CPU each runs its plain PyTorch version."
        ),
    )
    batch.add_argument(
        "--mode", default="license",
        choices=["license", "readme", "package", "auto"],
        help=(
            "Which project-file chain to run per blob: 'license' "
            "(Copyright/Exact/Dice), 'readme' (extract the License "
            "section, then the license chain + Reference fallback), "
            "'package' (filename-dispatched package-manifest matchers), "
            "or 'auto' (route EACH file by its filename through the "
            "reference's score tables — LICENSE-likes to the license "
            "chain, READMEs to the readme chain, package manifests to "
            "their matchers, everything else skipped unread — for "
            "mixed manifests)"
        ),
    )
    batch.add_argument(
        "--closest", type=int, default=0, metavar="K",
        help=(
            "Attach the top-K closest candidate licenses (key + "
            "confidence) to rows that reach the Dice scorer, like "
            "detect's closest-licenses view (prefiltered exact/"
            "copyright rows skip it)"
        ),
    )
    batch.add_argument(
        "--attribution", action="store_true",
        help=(
            "Extract the copyright/attribution line per matched blob "
            "(detect's Attribution row, license_file.rb:71-77): a "
            "post-match host regex, paid only for matched rows — and "
            "with dedupe, once per unique content"
        ),
    )
    batch.add_argument("--batch-size", type=int, default=4096)
    batch.add_argument(
        "--confidence", type=float, default=None, metavar="N",
        help="Match threshold in percent (default 98)",
    )
    batch.add_argument(
        "--no-dedupe", action="store_true",
        help="Score every row, even verbatim repeats of earlier rows",
    )
    batch.add_argument("--workers", type=int, default=None,
                       help="Featurization worker threads (default: cpu count)")
    batch.add_argument(
        "--featurize-procs", type=bounded(int, 0), default=0, metavar="N",
        help=(
            "Featurize in N worker PROCESSES instead of threads (for "
            "hosts where the native pipeline is absent and thread "
            "scaling disappoints; identical output, resume unchanged).  "
            "Threads win when the native pipeline is up"
        ),
    )
    batch.add_argument(
        "--coalesce-batches", type=bounded(int, 1), default=32, metavar="N",
        help=(
            "How many produced batches may wait while their sparse "
            "device rows (dedupe-heavy manifests) accumulate into full "
            "device chunks; 1 disables coalescing (default 32)"
        ),
    )
    batch.add_argument(
        "--pipeline-depth", type=bounded(int, 1), default=2, metavar="N",
        help=(
            "How many dispatched device groups may be in flight at "
            "once: 1 = the synchronous dispatch/await/write loop, >= 2 "
            "= the overlap pipeline (featurize chunk N+1 while the "
            "device scores N and the writer drains N-1; identical "
            "output at every depth; default 2)"
        ),
    )
    batch.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="Where the scorers run (default cuda; errors if no GPU)",
    )
    batch.add_argument(
        "--stats", action="store_true",
        help="Print the run's counters as one JSON line on stderr",
    )
    batch.add_argument(
        "--mesh", default=None, metavar="DATA[,MODEL]",
        help=(
            "Device mesh for the scorer (K5): DATA devices split the blob "
            "batch, MODEL devices split the corpus's packed lanes "
            "(default: every visible card data-parallel; 'none' forces "
            "one device; on the CPU a mesh repeats the CPU device)"
        ),
    )

    def lanes_arg(value):
        if value == "auto":
            return value
        return bounded(int, 1)(value)

    lanes_arg.__name__ = "K|auto"
    batch.add_argument(
        "--device-lanes", type=lanes_arg, default=None, metavar="K|auto",
        help=(
            "Round-robin whole dispatch chunks over the first K visible "
            "devices ('auto' = all), each lane with its own stream and "
            "staging, so one featurize stage feeds K devices.  Excludes "
            "an explicit --mesh (which splits ONE chunk over devices)"
        ),
    )
    batch.add_argument(
        "--stripes", default=None, metavar="N|auto|elastic",
        help=(
            "Scale out over N co-located worker processes, each "
            "classifying a contiguous stripe of the manifest into its own "
            "resumable shard under a supervisor (crash restart with "
            "backoff resumes the stripe; SIGTERM drains), then merge the "
            "shards, stats and metrics: the merged output is "
            "byte-identical to a one-process run.  'auto' sizes from the "
            "host's cores; 'elastic' starts at --autoscale-min and grows "
            "or shrinks the count against each worker's measured "
            "featurize-lane occupancy.  Needs --output"
        ),
    )
    batch.add_argument(
        "--autoscale-min", type=bounded(int, 1), default=1, metavar="N",
        help="With --stripes elastic: lower capacity bound (default 1)",
    )
    batch.add_argument(
        "--autoscale-max", type=bounded(int, 1), default=8, metavar="N",
        help=(
            "With --stripes elastic: upper capacity bound (default 8); "
            "units beyond the host's useful stripe count become "
            "per-stripe --featurize-procs"
        ),
    )
    batch.add_argument(
        "--autoscale-cooldown", type=bounded(float, 0), default=30.0,
        metavar="SECS",
        help=(
            "With --stripes elastic: minimum seconds between scale "
            "events (default 30)"
        ),
    )
    batch.add_argument(
        "--chips-per-stripe", type=bounded(int, 1), default=None,
        metavar="K",
        help=(
            "With --stripes: give stripe i devices [i*K, (i+1)*K) through "
            "LICENSEE_TPU_VISIBLE_CHIPS (CUDA_VISIBLE_DEVICES in the "
            "child); default: the stripes share every device"
        ),
    )
    # internal: the rank flags the stripe runner spawns workers with
    batch.add_argument(
        "--stripe-index", type=bounded(int, 0), default=None,
        help=argparse.SUPPRESS,
    )
    batch.add_argument(
        "--stripe-count", type=bounded(int, 1), default=None,
        help=argparse.SUPPRESS,
    )
    batch.add_argument(
        "--stats-file", default=None, metavar="PATH",
        help=(
            "Write the run's stats JSON to PATH (atomic replace), the "
            "file twin of --stats; the stripe runner merges these"
        ),
    )
    batch.add_argument(
        "--prom-file", default=None, metavar="PATH",
        help=(
            "Write a Prometheus text exposition of the run (pipeline "
            "lanes, stage seconds, result counters, native featurizer "
            "profile) to PATH, refreshed every second during a run; the "
            "stripe runner merges these stripe-labelled"
        ),
    )
    batch.add_argument(
        "--progress", type=bounded(float, 0), default=0, metavar="SECS",
        help=(
            "With --output: a JSON progress line (rows done, files/sec, "
            "dedupe hits) on stderr at most every SECS seconds"
        ),
    )
    batch.add_argument(
        "--profile", default=None, metavar="DIR",
        help="Write a torch.profiler trace of the run to DIR/trace.json",
    )
    batch.add_argument(
        "--selftest", action="store_true",
        help=(
            "Run the 2-stripe smoke (real worker processes over a "
            "synthetic corpus; the merged output must equal a 1-stripe "
            "run byte for byte) on --device and exit 0/1"
        ),
    )
    batch.add_argument(
        "--selftest-autoscale", action="store_true",
        help=(
            "Run the elastic-stripes drill (stub workers under the real "
            "drain/respawn/resume machinery: a saturated featurize lane "
            "must scale up, an idle one back down, and the merged output "
            "must stay byte-identical) and exit 0/1"
        ),
    )
    batch.add_argument(
        "--selftest-remote", action="store_true",
        help=(
            "Run the remote-ingest drill (a loopback HTTP host serves a "
            "tar and a zip with one scripted 503-then-recover and one "
            "mid-stream truncation; the remote scans and a 2-stripe "
            "merge must equal the local disk's bytes) on --device and "
            "exit 0/1"
        ),
    )
    batch.set_defaults(func=cmd_batch_detect)

    corpus_build = sub.add_parser(
        "corpus-build", help=_COMMAND_HELP["corpus-build"]
    )
    corpus_build.add_argument(
        "--corpus", default="vendored",
        help=(
            "Source to compile: 'vendored', 'spdx', an SPDX license-"
            "list-XML src/ directory, or an existing artifact "
            "(re-fingerprint/repack)"
        ),
    )
    corpus_build.add_argument(
        "--output", default=None, metavar="PATH",
        help=(
            "Write the artifact bundle here (atomic replace; prints "
            "the fingerprint manifest on success); batch-detect loads "
            "it with --corpus PATH"
        ),
    )
    corpus_build.add_argument(
        "--inspect", default=None, metavar="PATH",
        help=(
            "Load an artifact, verify its payload against the "
            "fingerprint manifest, and print the manifest"
        ),
    )
    corpus_build.set_defaults(func=cmd_corpus_build)

    serve = sub.add_parser("serve", help=_COMMAND_HELP["serve"])
    serve.add_argument(
        "--socket", default=None, metavar="PATH|HOST:PORT",
        help=(
            "Serve on a Unix domain socket — or, as host:port, on TCP "
            "(the cross-host federation tier's worker transport; "
            "TCP_NODELAY on every connection) — one JSONL session per "
            "connection, shared cache; default is one session on "
            "stdin/stdout"
        ),
    )
    serve.add_argument(
        "--mode", default="license",
        choices=["license", "readme", "package", "auto"],
        help=(
            "Which matcher chain requests run (same semantics as "
            "batch-detect; 'auto' routes each request by its filename)"
        ),
    )
    serve.add_argument(
        "--corpus", default="vendored",
        help=(
            "Template pool: 'vendored' (default), 'spdx', a path to "
            "an SPDX license-list-XML src/ directory, or a corpus "
            "artifact written by corpus-build"
        ),
    )
    serve.add_argument(
        "--method", default="auto",
        choices=list(METHODS),
        help="Device scoring path (same as batch-detect)",
    )
    serve.add_argument(
        "--max-batch", type=bounded(int, 1), default=256, metavar="N",
        help=(
            "Flush a micro-batch as soon as N Dice-bound requests are "
            "waiting (default 256)"
        ),
    )
    serve.add_argument(
        "--max-delay-ms", type=bounded(float, 0), default=5.0, metavar="MS",
        help=(
            "Flush a PARTIAL micro-batch once its oldest request has "
            "waited MS milliseconds — the latency bound (default 5)"
        ),
    )
    serve.add_argument(
        "--queue-depth", type=bounded(int, 1), default=1024, metavar="N",
        help=(
            "Bounded admission queue: a request arriving with N "
            "Dice-bound rows already waiting is rejected with "
            "retry_after instead of buffered (default 1024)"
        ),
    )
    serve.add_argument(
        "--pipeline-depth", type=bounded(int, 1), default=2, metavar="N",
        help=(
            "How many submitted device flushes may be in flight before "
            "the scheduler thread blocks on the handoff queue: 1 = "
            "synchronous flush, >= 2 = the overlap pipeline (the "
            "scheduler gathers flush N+1 while the device scores N "
            "and the completion thread answers N-1; default 2)"
        ),
    )
    serve.add_argument(
        "--cache-entries", type=bounded(int, 0), default=65536, metavar="N",
        help=(
            "Content-hash LRU result cache capacity; 0 disables "
            "(default 65536)"
        ),
    )
    serve.add_argument(
        "--cache-bytes", type=bounded(int, 0), default=None, metavar="N",
        help=(
            "Bound the result cache by estimated resident BYTES "
            "(LRU eviction, on top of --cache-entries) — the memory "
            "ceiling for week-long fleet workers (default: unbounded)"
        ),
    )
    serve.add_argument(
        "--deadline-ms", type=bounded(float, 0), default=0.0, metavar="MS",
        help=(
            "Default per-request deadline: a request still queued after "
            "MS milliseconds answers deadline_exceeded instead of "
            "occupying a device slot; 0 = none (per-request "
            "deadline_ms overrides)"
        ),
    )
    serve.add_argument(
        "--buckets", default=None, metavar="N,N,...",
        help=(
            "Device batch shapes (ascending); each is set up once "
            "(its pinned staging) and a partial flush takes the "
            "smallest fitting bucket (default: a x4 ladder up to "
            "--max-batch)"
        ),
    )
    serve.add_argument(
        "--confidence", type=float, default=None, metavar="N",
        help=(
            "Minimum Dice confidence for a match (default: the global "
            f"threshold, {licensee_tpu_torch.CONFIDENCE_THRESHOLD})"
        ),
    )
    serve.add_argument(
        "--stats", action="store_true",
        help="Dump the final stats JSON to stderr at shutdown",
    )
    serve.add_argument(
        "--no-tracing", action="store_true",
        help="Disable request tracing entirely (metrics stay on)",
    )
    serve.add_argument(
        "--trace-sample", type=bounded(float, 0), default=0.01, metavar="RATE",
        help=(
            "Head-sampling rate in [0,1]: retain every ~1/RATE-th "
            "request's trace (default 0.01; slow requests are always "
            "retained regardless)"
        ),
    )
    serve.add_argument(
        "--trace-slow-ms", type=bounded(float, 0), default=250.0, metavar="MS",
        help=(
            "Slow-request exemplar threshold: a request slower than MS "
            "is retained (and logged with --trace-log) even when head "
            "sampling skipped it (default 250)"
        ),
    )
    serve.add_argument(
        "--trace-log", default=None, metavar="PATH",
        help=(
            "Append slow-request exemplar traces to this JSONL file "
            "(bounded: one rotation to PATH.1 at ~4 MiB)"
        ),
    )
    serve.add_argument(
        "--selftest", action="store_true",
        help=(
            "Run an in-process end-to-end session (exact prefilter, "
            "Dice micro-batch, cache hit, stats verb, Prometheus "
            "exposition, five-span exemplar trace) and exit 0/1 — "
            "the CI smoke"
        ),
    )
    serve.add_argument(
        "--selftest-reload", action="store_true",
        help=(
            "Run the corpus hot-swap smoke (build an artifact, serve "
            "live traffic, blue/green reload under it, verify the "
            "fingerprint flipped, the cache fenced, and corrupt/"
            "unloadable sources refused) and exit 0/1 — the CI smoke"
        ),
    )
    serve.add_argument(
        "--mesh", default=None, metavar="DATA[,MODEL]",
        help=(
            "Device mesh for the scorer ('auto' = all visible devices "
            "data-parallel; default: single device; bucket shapes are "
            "rounded up to the data axis)"
        ),
    )
    serve.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="Where the scorers run (default cuda; errors if no GPU)",
    )
    serve.set_defaults(func=cmd_serve)

    stats = sub.add_parser("stats", help=_COMMAND_HELP["stats"])
    stats.add_argument(
        "--socket", action="append", default=None,
        metavar="PATH|HOST:PORT",
        help=(
            "A serve worker's Unix socket — or host:port for a TCP "
            "worker/front — to scrape; repeat the flag for a fleet — "
            "several targets print ONE merged table (json) or one "
            "worker-labeled merged exposition (prometheus)"
        ),
    )
    stats.add_argument(
        "--format", default="json", choices=["json", "prometheus"],
        help=(
            "Output: 'json' (the stats verb snapshot) or 'prometheus' "
            "(text exposition — pipe into a node_exporter textfile or "
            "curl-style scrape job)"
        ),
    )
    stats.add_argument(
        "--watch", type=nonneg(float), default=None, metavar="SECS",
        help=(
            "Re-scrape and redraw the merged table every SECS seconds "
            "(Ctrl-C stops) — the live operator view of a fleet; REQ_S "
            "reads the target's telemetry store when it serves the "
            "query verb (honest from the first frame), else the "
            "completed-counter delta per second"
        ),
    )
    stats.add_argument(
        "--watch-iterations", type=nonneg(int), default=None,
        help=argparse.SUPPRESS,  # bound the --watch loop (tests/CI)
    )
    stats.add_argument(
        "--trace", type=nonneg(int), default=None, metavar="N",
        help="Print the last N retained traces (JSONL) instead of metrics",
    )
    stats.add_argument(
        "--timeout", type=nonneg(float), default=10.0, metavar="SECS",
        help="Socket connect/read timeout (default 10)",
    )
    stats.add_argument(
        "--selftest", action="store_true",
        help=(
            "Exercise the obs layer in-process (registry, histogram "
            "math, exposition grammar, tracer sampling + slow "
            "exemplars, native-profile delta scrape) and exit 0/1 — "
            "the CI smoke"
        ),
    )
    stats.set_defaults(func=cmd_stats)

    traces = sub.add_parser("traces", help=_COMMAND_HELP["traces"])
    traces.add_argument(
        "--socket", required=True, metavar="PATH|HOST:PORT",
        help=(
            "A fleet FRONT door (licensee-tpu-torch fleet --socket TARGET; "
            "host:port for a TCP front): the router's collector pulls "
            "every worker tail and answers {'op': 'traces'} with "
            "assembled trees"
        ),
    )
    traces.add_argument(
        "--id", default=None, metavar="HEX",
        help="Only traces whose 16-hex ID starts with this prefix",
    )
    traces.add_argument(
        "--slowest", type=bounded(int, 1), default=None, metavar="N",
        help="The N slowest assembled traces (default: 20 slowest)",
    )
    traces.add_argument(
        "--n", type=bounded(int, 1), default=20, metavar="N",
        help="How many trees to fetch without --slowest (default 20)",
    )
    traces.add_argument(
        "--json", action="store_true",
        help="One JSON tree per line instead of the rendered view",
    )
    traces.add_argument(
        "--timeout", type=nonneg(float), default=10.0, metavar="SECS",
        help="Socket connect/read timeout (default 10)",
    )
    traces.set_defaults(func=cmd_traces)

    slo = sub.add_parser("slo", help=_COMMAND_HELP["slo"])
    slo.add_argument(
        "--socket", required=True, metavar="PATH|HOST:PORT",
        help=(
            "A serve worker's socket (its own objectives) or a fleet "
            "front door — host:port for TCP — (the router's "
            "fleet-level objectives)"
        ),
    )
    slo.add_argument(
        "--json", action="store_true",
        help="Print the raw slo stats block instead of the table",
    )
    slo.add_argument(
        "--timeout", type=nonneg(float), default=10.0, metavar="SECS",
        help="Socket connect/read timeout (default 10)",
    )
    slo.set_defaults(func=cmd_slo)

    top = sub.add_parser("top", help=_COMMAND_HELP["top"])
    top.add_argument(
        "--socket", required=True, metavar="PATH|HOST:PORT",
        help=(
            "A fleet FRONT door (its router owns the telemetry store "
            "the dashboard reads); host:port for a TCP front"
        ),
    )
    top.add_argument(
        "--interval", type=nonneg(float), default=2.0, metavar="SECS",
        help=(
            "Redraw cadence (default 2; 0 prints one frame and exits)"
        ),
    )
    top.add_argument(
        "--iterations", type=nonneg(int), default=None,
        help=argparse.SUPPRESS,  # bound the redraw loop (tests/CI)
    )
    top.add_argument(
        "--timeout", type=nonneg(float), default=10.0, metavar="SECS",
        help="Socket connect/read timeout (default 10)",
    )
    top.set_defaults(func=cmd_top)

    alerts = sub.add_parser("alerts", help=_COMMAND_HELP["alerts"])
    alerts.add_argument(
        "--socket", required=True, metavar="PATH|HOST:PORT",
        help=(
            "A fleet FRONT door (the router's watchdog owns the alert "
            "ledger); host:port for a TCP front"
        ),
    )
    alerts.add_argument(
        "--history", type=nonneg(int), default=0, metavar="N",
        help="Also print the last N fire/clear transitions",
    )
    alerts.add_argument(
        "--json", action="store_true",
        help="Print the raw watchdog snapshot instead of the table",
    )
    alerts.add_argument(
        "--timeout", type=nonneg(float), default=10.0, metavar="SECS",
        help="Socket connect/read timeout (default 10)",
    )
    alerts.set_defaults(func=cmd_alerts)

    fleet = sub.add_parser("fleet", help=_COMMAND_HELP["fleet"])
    fleet.add_argument(
        "--socket", default=None, metavar="PATH|HOST:PORT",
        help="The client-facing front socket (JSONL, same protocol "
             "as one worker — clients cannot tell the difference).  "
             "host:port binds the front door on TCP",
    )
    fleet.add_argument(
        "--http", default=None, metavar="HOST:PORT",
        help=(
            "Also serve the HTTP/1.1 keep-alive edge on this TCP "
            "address (POST /classify with a JSON content-row body, "
            "GET /healthz, GET /metrics), on the router's own event "
            "loop — queue_full maps to 429 + Retry-After, router "
            "shutdown to 503"
        ),
    )
    fleet.add_argument(
        "--edge-token", action="append", default=None,
        metavar="NAME=TOKEN",
        help=(
            "HTTP edge bearer token (repeatable): requests must carry "
            "'Authorization: Bearer TOKEN' and are rate-limited and "
            "fair-queued per NAME.  A bare TOKEN names itself.  "
            "Default: auth off (clients keyed by peer address)"
        ),
    )
    fleet.add_argument(
        "--edge-rate", type=bounded(float, 0.001), default=1000.0,
        metavar="RPS",
        help="HTTP edge per-client token-bucket rate (default 1000/s)",
    )
    fleet.add_argument(
        "--edge-burst", type=bounded(float, 1), default=None,
        metavar="N",
        help="HTTP edge per-client burst depth (default: the rate)",
    )
    fleet.add_argument(
        "--federate", default=None, metavar="TARGET,TARGET,...",
        help=(
            "Run as the cross-host FRONT tier: no local workers — "
            "each comma-separated target (host:port or socket path) "
            "is another fleet's front door, dispatched least-loaded "
            "with failover/hedging across hosts and scraped into a "
            "host-labeled merged exposition"
        ),
    )
    fleet.add_argument(
        "--workers", type=bounded(int, 1), default=2, metavar="N",
        help="Worker processes to supervise (default 2)",
    )
    fleet.add_argument(
        "--chips-per-worker", type=bounded(int, 1), default=None,
        metavar="K",
        help=(
            "Give worker i chips [i*K, (i+1)*K) via the "
            "LICENSEE_TPU_VISIBLE_CHIPS env contract "
            "(parallel/distributed.py apply_visible_chips); default: "
            "workers share default device visibility"
        ),
    )
    fleet.add_argument(
        "--socket-dir", default=None, metavar="DIR",
        help="Directory for per-worker sockets (default: a tmpdir)",
    )
    fleet.add_argument(
        "--hedge-ms", default="off", metavar="MS|auto|off",
        help=(
            "Hedged requests: after MS milliseconds without an answer, "
            "duplicate the request to a second worker and take the "
            "first answer ('auto' derives the delay from the live p95; "
            "default off).  A duplicate the twin has cached or in "
            "flight coalesces by content hash; otherwise the extra "
            "device load is bounded by the hedge rate (~5% at auto)"
        ),
    )
    fleet.add_argument(
        "--pool-per-worker", type=bounded(int, 1), default=4,
        metavar="N",
        help=(
            "Pipelined backend connections the router may open per "
            "worker (default 4).  Many requests ride each connection "
            "at once; more connections spread head-of-line blocking, "
            "at the cost of more worker session threads"
        ),
    )
    fleet.add_argument(
        "--probe-interval-ms", type=bounded(float, 1), default=250.0,
        metavar="MS",
        help="Health-probe cadence for supervisor and router "
             "(default 250)",
    )
    fleet.add_argument(
        "--restart-backoff-ms", type=bounded(float, 1), default=250.0,
        metavar="MS",
        help=(
            "Base restart backoff: a crashed worker respawns after "
            "MS * 2^restarts ms, capped at 10s; the counter resets "
            "after 10s of stable health (default 250)"
        ),
    )
    fleet.add_argument(
        "--boot-timeout", type=bounded(float, 1), default=300.0,
        metavar="SECS",
        help="How long to wait for every worker's first health probe "
             "(default 300)",
    )
    # per-worker serve knobs, forwarded verbatim to each worker argv
    fleet.add_argument("--mode", default=None,
                       choices=["license", "readme", "package", "auto"],
                       help="Forwarded to each worker (serve --mode)")
    fleet.add_argument("--corpus", default=None,
                       help="Forwarded to each worker (serve --corpus)")
    fleet.add_argument(
        "--method", default=None,
        choices=list(METHODS),
        help="Forwarded to each worker (serve --method)",
    )
    fleet.add_argument("--max-batch", type=bounded(int, 1), default=None,
                       help="Forwarded to each worker (serve --max-batch)")
    fleet.add_argument(
        "--max-delay-ms", type=nonneg(float), default=None,
        help="Forwarded to each worker (serve --max-delay-ms)",
    )
    fleet.add_argument(
        "--queue-depth", type=bounded(int, 1), default=None,
        help="Forwarded to each worker (serve --queue-depth)",
    )
    fleet.add_argument(
        "--cache-entries", type=nonneg(int), default=None,
        help="Forwarded to each worker (serve --cache-entries)",
    )
    fleet.add_argument(
        "--cache-bytes", type=nonneg(int), default=None,
        help="Forwarded to each worker (serve --cache-bytes)",
    )
    fleet.add_argument(
        "--trace-sample", type=nonneg(float), default=None,
        help="Forwarded to each worker (serve --trace-sample)",
    )
    fleet.add_argument(
        "--stats", action="store_true",
        help="Dump the router's fleet stats JSON to stderr at shutdown",
    )
    fleet.add_argument(
        "--selftest", action="store_true",
        help=(
            "Boot a 2-worker fleet on --device, SIGKILL one worker under live "
            "client traffic, and assert zero client-visible errors, "
            "restart-within-backoff, trace propagation, merged "
            "exposition, and clean drain; exit 0/1 — the CI smoke"
        ),
    )
    fleet.add_argument(
        "--selftest-reload", action="store_true",
        help=(
            "Run the fault-drilled zero-downtime upgrade selftest: a "
            "live 2-worker fleet under continuous traffic completes "
            ">=3 rolling corpus reloads interleaved with corrupt-"
            "artifact, refused-validation (rollback), and SIGKILL-"
            "mid-swap faults, with zero client-visible errors; "
            "exit 0/1"
        ),
    )
    fleet.add_argument(
        "--selftest-tcp", action="store_true",
        help=(
            "Run the cross-host federation selftest: 2 supervisor "
            "domains over loopback TCP behind one federated front "
            "router + the HTTP edge — an open-loop HTTP burst, then "
            "SIGKILL of one host's worker mid-stream with zero "
            "client-visible errors (cross-host failover), auth/"
            "slowloris drills, and a host+worker-labeled merged "
            "exposition; exit 0/1"
        ),
    )
    fleet.add_argument(
        "--selftest-jobs", action="store_true",
        help=(
            "Run the durable-jobs selftest: a fleet with --jobs-dir "
            "takes a tar-manifest job over POST /jobs, the whole "
            "process tree is SIGKILLed mid-drain, a second boot on "
            "the same jobs dir replays the journal and resumes from "
            "the stripe shards, and the merged results must be "
            "byte-identical to a direct batch-detect --stripes run "
            "with zero client-visible errors and an assembled "
            "edge+executor+stripe trace; exit 0/1"
        ),
    )
    fleet.add_argument(
        "--selftest-tenant", action="store_true",
        help=(
            "Run the multi-tenant serving selftest: two tenants with "
            "disjoint corpora on separate worker pools behind one "
            "router and HTTP edge — tagged corpus routing, an "
            "authenticated POST /corpus upload+roll of tenant A under "
            "tenant B's live traffic (B's latency SLO must hold), "
            "SIGKILL failover confined to one pool, 401/403/400 auth "
            "probes, and journal crash recovery, with ZERO cross-"
            "tenant rows; exit 0/1"
        ),
    )
    fleet.add_argument(
        "--tenants", default=None, metavar="FILE",
        help=(
            "Serve multi-tenant: FILE is the tenant registry JSON "
            "(token -> corpus -> pool); the fleet boots one worker "
            "pool per registry pool (--workers workers EACH, on that "
            "pool's corpus), routes requests by corpus tag / bearer "
            "token, and serves self-serve corpus onboarding on "
            "POST /corpus (needs --http for the authenticated edge)"
        ),
    )
    fleet.add_argument(
        "--jobs-dir", default=None, metavar="DIR",
        help=(
            "Serve the durable jobs tier (POST /jobs on the HTTP "
            "edge): an append-only journal plus per-job stripe shards "
            "under DIR — a SIGKILLed fleet rebooted on the same DIR "
            "replays the journal and resumes interrupted jobs from "
            "their shards.  Needs --http"
        ),
    )
    fleet.add_argument(
        "--jobs-concurrency", type=bounded(int, 1), default=1,
        metavar="N",
        help=(
            "How many jobs may run their stripe trees at once "
            "(default 1; each job already fans out --stripes worker "
            "processes)"
        ),
    )
    fleet.add_argument(
        "--stub", action="store_true",
        help=(
            "With --selftest/--selftest-reload/--selftest-tcp/"
            "--selftest-jobs/--selftest-tenant: use protocol-faithful "
            "stub workers (no device path) — seconds instead of a torch "
            "boot per worker"
        ),
    )
    fleet.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help=(
            "Forwarded to each worker (serve --device) and to the real-"
            "worker selftests (default cuda; a worker without a GPU "
            "exits 1 and counts as a crash)"
        ),
    )
    fleet.set_defaults(func=cmd_fleet)

    jobs = sub.add_parser("jobs", help=_COMMAND_HELP["jobs"])
    jobs.add_argument(
        "action",
        choices=["submit", "status", "results", "containers", "cancel",
                 "wait"],
        help=(
            "submit a job spec, poll one job's lifecycle status, "
            "fetch its merged results JSONL / container-verdict "
            "sidecar, cancel it, or block until it reaches a "
            "terminal state"
        ),
    )
    jobs.add_argument(
        "job_id", nargs="?", default=None,
        help="The job id every action but submit operates on",
    )
    jobs.add_argument(
        "--edge", required=True, metavar="HOST:PORT",
        help="The fleet's HTTP edge (a `fleet --http --jobs-dir` door)",
    )
    jobs.add_argument(
        "--token", default=None,
        help="Bearer token for an --edge-token protected edge",
    )
    jobs.add_argument(
        "--manifest", default=None, metavar="FILE",
        help=(
            "Submit this manifest (one entry per line; plain paths or "
            "the ingest grammar — tar::MEMBER, zip::MEMBER, "
            "repo.git::REV, * globs)"
        ),
    )
    jobs.add_argument(
        "--archive", default=None, metavar="PATH",
        help=(
            "Upload this local tar/zip with the submit (base64 in the "
            "spec body); without --manifest the job classifies every "
            "member (ARCHIVE::*)"
        ),
    )
    jobs.add_argument(
        "--stripes", type=bounded(int, 1), default=None, metavar="N",
        help="Worker processes the job's batch-detect fans out to",
    )
    jobs.add_argument(
        "--option", action="append", default=None, metavar="KEY=VALUE",
        help=(
            "Forwarded batch-detect knob (repeatable): batch_size, "
            "workers, mesh, mode, corpus, method, confidence"
        ),
    )
    jobs.add_argument(
        "--idempotency-key", default=None, metavar="KEY",
        help=(
            "Duplicate-submit fence: a resubmit carrying the same key "
            "answers the original job id instead of minting a new job"
        ),
    )
    jobs.add_argument(
        "--wait", action="store_true",
        help="With submit: block until the job is terminal",
    )
    jobs.add_argument(
        "--wait-timeout", type=bounded(float, 0.001), default=600.0,
        metavar="SECS",
        help="How long wait/--wait polls before giving up (default 600)",
    )
    jobs.add_argument(
        "--timeout", type=bounded(float, 0.001), default=30.0,
        metavar="SECS",
        help="Per-round-trip edge timeout in seconds (default 30)",
    )
    jobs.add_argument(
        "--output", default=None, metavar="PATH",
        help="Write results/containers bytes here instead of stdout",
    )
    jobs.set_defaults(func=cmd_jobs)

    if set(sub.choices) != {name for name, _ in COMMANDS}:
        raise AssertionError(
            f"COMMANDS out of sync with parser: {sorted(sub.choices)} "
            f"vs {[name for name, _ in COMMANDS]}"
        )
    return parser


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = build_parser()
    # detect is the default command (bin/licensee:12): anything that
    # does not name a command is detect's path and flags
    known_commands = {name for name, _ in COMMANDS} | {"-h", "--help"}
    if not argv or argv[0] not in known_commands:
        argv = ["detect", *argv]
    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
