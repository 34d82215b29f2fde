"""Command-line interface of the PyTorch/CUDA port.

    python -m licensee_tpu_torch.cli.main batch-detect MANIFEST \\
        --output OUT.jsonl [--corpus vendored|spdx|DIR] [--method M] \\
        [--batch-size N] [--confidence N] [--no-dedupe] [--device cuda|cpu] \\
        [--workers N] [--featurize-procs N] [--coalesce-batches N] \\
        [--pipeline-depth N] [--no-resume] [--stats]

`batch-detect --mode license` classifies a manifest of loose files (one
path per line) and writes JSONL rows byte-identical to the JAX package's
`licensee-tpu batch-detect`, through the same pipeline: featurize worker
threads (or processes), coalesced device chunks, an overlap pipeline of
device groups in flight, a writer thread, and resume of a partial
``--output`` from its ``.meta.json`` sidecar.  It runs on the CUDA
device unless ``--device cpu`` asks for the plain PyTorch scorers on the
CPU.  Printing rows without ``--output``, ``--stripes``, ``--mesh``,
``--device-lanes``, ``--progress``, containers and the other verbs of
`licensee_tpu/cli/main.py` wait for later slices (ROADMAP A).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from licensee_tpu_torch.kernels.batch import METHODS


def load_corpus(source: str):
    """The compiled corpus a ``--corpus`` value names, None for the
    default (vendored) pool: ``spdx`` is the vendored SPDX
    license-list-XML mirror, a directory an SPDX ``src/`` checkout (as
    `licensee_tpu.corpus.artifact.resolve_corpus` reads them).  Raises
    ValueError for a source it cannot load, NotImplementedError for a
    corpus artifact file."""
    if source == "vendored":
        return None
    if source == "spdx" or os.path.isdir(source):
        from licensee_tpu_torch.corpus.spdx import spdx_corpus

        corpus = spdx_corpus(None if source == "spdx" else source)
        if not corpus.n_templates:
            raise ValueError(
                f"cannot load corpus {source!r}: no license templates found"
            )
        return corpus
    if os.path.isfile(source):
        raise NotImplementedError(
            f"corpus artifact {source!r}: artifacts wait for a later slice "
            "of the port (ROADMAP A, corpus artifacts)"
        )
    raise ValueError(
        f"cannot load corpus {source!r}: not 'vendored', 'spdx' or an "
        "SPDX license-list-XML src/ directory"
    )


def cmd_batch_detect(args) -> int:
    if not os.path.exists(args.manifest):
        print(
            f"error: cannot read manifest: {args.manifest!r} not found",
            file=sys.stderr,
        )
        return 1
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
            device=args.device,
        )
    except OSError as exc:
        print(f"error: cannot read manifest: {exc}", file=sys.stderr)
        return 1
    except (ValueError, RuntimeError) as exc:
        # a bad option, no CUDA device without --device cpu, or a
        # feature that waits for a later slice (NotImplementedError)
        print(f"error: {exc}", file=sys.stderr)
        return 1
    from licensee_tpu_torch.projects.batch_project import ResumeConfigError

    try:
        stats = project.run(args.output, resume=not args.no_resume)
    except OSError as exc:
        print(f"error: batch run I/O failure: {exc}", file=sys.stderr)
        return 1
    except ResumeConfigError as exc:
        # a resume whose mode/corpus/threshold differs from the run that
        # wrote the output (the .meta.json sidecar)
        print(f"error: {exc}", file=sys.stderr)
        return 1
    if args.stats:
        print(json.dumps(stats.as_dict()), file=sys.stderr)
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


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="licensee-tpu-torch",
        description="License detection on the PyTorch/CUDA port",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    batch = sub.add_parser(
        "batch-detect", help="Classify a manifest of files on the GPU"
    )
    batch.add_argument("manifest", help="File with one path per line")
    batch.add_argument(
        "--output", required=True,
        help="Write the JSONL rows here (resumable)",
    )
    batch.add_argument(
        "--no-resume", action="store_true",
        help="Restart from scratch instead of resuming a partial --output",
    )
    batch.add_argument(
        "--corpus", default="vendored",
        help=(
            "Template pool: 'vendored' (choosealicense, default), 'spdx' "
            "(the vendored SPDX license-list XMLs), or a path to an SPDX "
            "license-list-XML src/ directory (e.g. the full ~600-license set)"
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
        "--mode", default="license", choices=["license"],
        help="Project-file chain (only 'license' in this slice of the port)",
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
    batch.set_defaults(func=cmd_batch_detect)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
