"""Command-line interface of the PyTorch/CUDA port.

    python -m licensee_tpu_torch.cli.main batch-detect MANIFEST \\
        --output OUT.jsonl [--corpus vendored|spdx|DIR] [--method M] \\
        [--batch-size N] [--confidence N] [--no-dedupe] [--device cuda|cpu] \\
        [--stats]

`batch-detect --mode license` classifies a manifest of loose files (one
path per line) and writes JSONL rows byte-identical to the JAX package's
`licensee-tpu batch-detect`.  It runs on the CUDA device unless
``--device cpu`` asks for the plain PyTorch scorers on the CPU.  The
other verbs and options of `licensee_tpu/cli/main.py` wait for later
slices (ROADMAP A).
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
            mode=args.mode,
            dedupe=not args.no_dedupe,
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
    try:
        stats = project.run(args.output)
    except OSError as exc:
        print(f"error: batch run I/O failure: {exc}", file=sys.stderr)
        return 1
    if args.stats:
        print(json.dumps(stats.as_dict()), file=sys.stderr)
    return 0


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
        "--output", required=True, help="Write the JSONL rows here"
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
