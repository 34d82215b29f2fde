"""Command-line interface of the PyTorch/CUDA port.

    python -m licensee_tpu_torch.cli.main batch-detect MANIFEST \\
        --output OUT.jsonl [--corpus vendored|spdx|DIR|ARTIFACT] \\
        [--mode license|readme|package|auto] [--closest K] \\
        [--attribution] [--method M] [--batch-size N] [--confidence N] \\
        [--no-dedupe] [--device cuda|cpu] [--workers N] \\
        [--featurize-procs N] [--coalesce-batches N] [--pipeline-depth N] \\
        [--no-resume] [--stats]
    python -m licensee_tpu_torch.cli.main corpus-build \\
        [--corpus SRC] --output ART.npz | --inspect ART.npz

`batch-detect` classifies a manifest of loose files and local tar, zip
and git containers (one entry per line: ``path``, ``archive.tar::member``,
``archive.zip::*``, ``repo.git::HEAD``) and writes JSONL rows, and for
containers ``OUTPUT.containers.jsonl``, byte-identical to the JAX package's
`licensee-tpu batch-detect`, through the same pipeline: featurize worker
threads (or processes), coalesced device chunks, an overlap pipeline of
device groups in flight, a writer thread, and resume of a partial
``--output`` from its ``.meta.json`` sidecar.  It runs on the CUDA
device unless ``--device cpu`` asks for the plain PyTorch scorers on the
CPU.  `corpus-build` writes a corpus artifact in the JAX package's
format (`corpus/artifact.py`).  Printing rows without ``--output``,
``--stripes``, ``--mesh``, ``--device-lanes``, ``--progress``, remote
(http(s)) containers, which a manifest may not name, and the other verbs
of `licensee_tpu/cli/main.py` wait for later slices (ROADMAP A).
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
            closest=args.closest,
            attribution=args.attribution,
            device=args.device,
        )
    except OSError as exc:
        print(f"error: cannot read manifest: {exc}", file=sys.stderr)
        return 1
    except (ValueError, RuntimeError) as exc:
        # a bad option or corpus, a torn or remote container, or no CUDA
        # device without --device cpu
        print(f"error: {exc}", file=sys.stderr)
        return 1
    from licensee_tpu_torch.projects.batch_project import ResumeConfigError

    try:
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
        project.close()
    if args.stats:
        print(json.dumps(stats.as_dict()), file=sys.stderr)
    return 0


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
    batch.add_argument(
        "manifest",
        help=(
            "File with one entry per line: a path, or a local container "
            "member (archive.tar::LICENSE, archive.zip::*, repo.git::HEAD)"
        ),
    )
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
    batch.set_defaults(func=cmd_batch_detect)

    corpus_build = sub.add_parser(
        "corpus-build",
        help="Compile a corpus into a fingerprinted artifact",
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
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
