"""Native featurizer parity selftest + microbench.

The port's copy of `licensee_tpu/native/selftest.py`, over the port's
own native build (`licensee_tpu_torch/native/`).  Asserts, over the full vendored corpus plus adversarial blobs, that the
fused single-pass native featurizer is BIT-IDENTICAL to the pure-Python
pipeline on every surface a score can depend on: normalized text,
content hash, packed wordset bits, |wordset|, normalized length, and the
prefilter outcomes.  Then reports the featurize crossing in us/blob.

Run as ``python -m licensee_tpu_torch.native.selftest``: exit 0 on
parity (or when the native library is unavailable — there is nothing to
diverge from then, and it prints ``SKIP``), exit 1 on any mismatch.  The
classifier is host-only (``device=None``): nothing here opens a device.
"""

from __future__ import annotations

import hashlib
import sys
import time

import numpy as np


def adversarial_blobs() -> list[bytes]:
    """Edge-case blobs: the shapes that historically diverge pipelines."""
    mit = (
        b"MIT License\n\nCopyright (c) 2026 Example\n\nPermission is "
        b"hereby granted, free of charge, to any person obtaining a copy "
        b"of this software and associated documentation files (the "
        b'"Software"), to deal in the Software without restriction.\n'
    )
    return [
        b"",
        b" \t\r\n ",
        mit,
        mit.replace(b"\n", b"\r\n"),  # CRLF universal-newline preamble
        mit.replace(b"\n", b"\r"),  # bare-CR
        b"\xef\xbb\xbf" + mit,  # BOM (non-ASCII: two-crossing path)
        # unicode dashes/quotes (non-ASCII fallback + folds)
        "em—dash – en, ‘curly’ “quotes”".encode(),
        "MITライセンス".encode(),  # MITライセンス
        b"<html><body><p>Licensed under the MIT license.</p></body></html>",
        b"Copyright (c) 2001 Someone\nAll rights reserved.",
        b"- bullet one\n\n- bullet two\n\n  3. numbered\n\n(a) lettered\n",
        b"a" * 70000,  # one huge line (beyond the 64 KiB read cap)
        (b"word " * 2000) + b"\n\n" + (b"term " * 2000),
        b"it's the boss' licence, sub-license per cent non-commercial",
        b"s's' 'quote' can't won't\n",
        b"=== \n*** bordered ***\n> quoted\n## heading\n[link](http://x)\n",
        b"http://example.com & http://other.example\n\nEND OF TERMS AND "
        b"CONDITIONS\n\ntrailing text",
        b"// comment line one\n// comment line two\n// comment line three",
        b"version 2.0\nhttps://spdx.org/licenses/MIT\nreal content here",
        b"\x00embedded\x00nuls\x00",
    ]


def corpus_blobs() -> list[bytes]:
    """Every vendored template's raw text — the full-corpus parity set."""
    from licensee_tpu_torch.corpus.license import License

    return [
        lic.content.encode("utf-8")
        for lic in License.all(hidden=True, pseudo=False)
        if lic.content
    ]


def run_parity(classifier=None) -> dict:
    """Raises AssertionError on any native/Python divergence."""
    from licensee_tpu_torch.kernels.batch import BatchClassifier, NormalizedBlob
    from licensee_tpu_torch.project_files.project_file import sanitize_content
    from licensee_tpu_torch.rubytext import ruby_strip

    clf = classifier or BatchClassifier(mesh=None, device=None)
    if clf._nat is None:
        return {"skipped": "native pipeline unavailable"}
    blobs = adversarial_blobs() + corpus_blobs()
    B = len(blobs)
    W = clf.corpus.n_lanes

    prepared = clf.prepare_batch(list(blobs))

    bits2 = np.zeros((B, W), dtype=np.uint32)
    n_words2 = np.zeros(B, dtype=np.int32)
    lengths2 = np.zeros(B, dtype=np.int32)
    cc2 = np.zeros(B, dtype=bool)
    results2: list = [None] * B
    for i, raw in enumerate(blobs):
        clf._prepare_one_python(
            raw, results2, bits2, n_words2, lengths2, cc2, i
        )

    mismatches = []
    for i in range(B):
        r1, r2 = prepared.results[i], results2[i]
        if (r1 is None) != (r2 is None) or (
            r1 is not None
            and (r1.key, r1.matcher, r1.confidence)
            != (r2.key, r2.matcher, r2.confidence)
        ):
            mismatches.append((i, "result", r1, r2))
            continue
        if r1 is None:
            if not np.array_equal(prepared.bits[i], bits2[i]):
                mismatches.append((i, "bits", None, None))
            if prepared.n_words[i] != n_words2[i]:
                mismatches.append(
                    (i, "n_words", prepared.n_words[i], n_words2[i])
                )
            if prepared.lengths[i] != lengths2[i]:
                mismatches.append(
                    (i, "length", prepared.lengths[i], lengths2[i])
                )
            if prepared.cc_fp[i] != cc2[i]:
                mismatches.append((i, "cc_fp", prepared.cc_fp[i], cc2[i]))

    # normalized text + content hash, via the two-crossing surface
    text_checked = 0
    for raw in blobs:
        content = sanitize_content(raw)
        stripped = ruby_strip(content)
        s1, _flags = clf._nat.stage1(stripped)
        s2 = clf._nat.stage2(s1.lower())
        blob = NormalizedBlob(raw)
        want = blob.content_normalized()
        if s2 != want:
            mismatches.append((raw[:40], "normalized_text", s2[:80], want[:80]))
        elif (
            hashlib.sha1(s2.encode("utf-8")).hexdigest() != blob.content_hash
        ):
            mismatches.append((raw[:40], "content_hash", None, None))
        text_checked += 1

    assert not mismatches, (
        f"native/python featurizer divergence ({len(mismatches)} rows): "
        f"{mismatches[:3]}"
    )
    return {"blobs": B, "text_checked": text_checked}


def bench_crossing(classifier=None, n: int = 256, reps: int = 3) -> float:
    """min us/blob for the whole-batch native crossing on ~10KB blobs."""
    from licensee_tpu_torch.kernels.batch import BatchClassifier

    clf = classifier or BatchClassifier(mesh=None, device=None)
    if clf._nat is None:
        return float("nan")
    # ASCII-only seeds: a non-ASCII blob exits the crossing after the
    # all_ascii scan (status 2, near-free) and would understate us/blob
    seeds = [
        b
        for b in corpus_blobs()
        if len(b) > 512 and all(x < 0x80 for x in b)
    ][:16] or [b"some license words " * 64]
    blobs = [
        (seeds[i % len(seeds)] * (1 + 10000 // max(1, len(seeds[i % len(seeds)]))))[
            :10000
        ]
        for i in range(n)
    ]
    W = clf.corpus.n_lanes
    bits = np.zeros((n, W), dtype=np.uint32)
    meta = np.zeros((n, 3), dtype=np.int32)
    hashes = np.zeros((n, 16), dtype=np.uint8)
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        status = clf._nat.featurize_batch(
            clf._nat_vocab, blobs, bits, meta, hashes
        )
        dt = (time.perf_counter() - t0) / n * 1e6
        assert (status == 0).all(), "bench blobs must take the fast path"
        best = dt if best is None or dt < best else best
    return round(best, 1)


def _profile_main(n: int) -> int:
    """The ``--profile-json`` child: one featurize_batch over the bench
    blobs with the native pass profiler live, stage split as JSON on
    stdout.  Must run in its OWN process — PassProf caches the
    ``LICENSEE_TPU_PIPE_PROFILE`` env at its first call, so the parent
    cannot flip profiling on after the fact."""
    import json

    from licensee_tpu_torch.kernels.batch import BatchClassifier

    clf = BatchClassifier(mesh=None, device=None)
    if clf._nat is None:
        print(json.dumps({"skipped": "native pipeline unavailable"}))
        return 0
    seeds = [
        b
        for b in corpus_blobs()
        if len(b) > 512 and all(x < 0x80 for x in b)
    ][:16] or [b"some license words " * 64]
    blobs = [
        (
            seeds[i % len(seeds)]
            * (1 + 10000 // max(1, len(seeds[i % len(seeds)])))
        )[:10000]
        for i in range(n)
    ]
    W = clf.corpus.n_lanes
    bits = np.zeros((n, W), dtype=np.uint32)
    meta = np.zeros((n, 3), dtype=np.int32)
    hashes = np.zeros((n, 16), dtype=np.uint8)
    clf._nat.profile_reset()
    clf._nat.featurize_batch(clf._nat_vocab, blobs, bits, meta, hashes)
    dump = clf._nat.profile_dump()
    us = {
        key: round(seconds / n * 1e6, 2)
        for key, seconds in dump.items()
        if not key.startswith("count.")
    }
    print(json.dumps({"n": n, "us_per_blob": us}))
    return 0


def profile_split(n: int = 256) -> dict | None:
    """Per-stage us/blob from a profile-enabled CHILD process (the env
    gate must be set at process start), or None when the child cannot
    produce one.  Keys of interest: ``stage.tokenize_only`` (the
    tokenize-vs-normalize split), ``s2.title_strips`` and
    ``s2.fold_spell`` (the round-2 fused passes)."""
    import json
    import os
    import subprocess

    env = {**os.environ, "LICENSEE_TPU_PIPE_PROFILE": "1"}
    try:
        proc = subprocess.run(
            [
                sys.executable, "-m", "licensee_tpu_torch.native.selftest",
                "--profile-json", str(n),
            ],
            env=env, capture_output=True, text=True, timeout=300,
        )
        if proc.returncode != 0:
            return None
        row = json.loads(proc.stdout.strip().splitlines()[-1])
    except (OSError, subprocess.TimeoutExpired, ValueError, IndexError):
        return None
    if not isinstance(row, dict) or "us_per_blob" not in row:
        return None
    return row


def main() -> int:
    from licensee_tpu_torch.kernels.batch import BatchClassifier

    clf = BatchClassifier(mesh=None, device=None)
    if clf._nat is None:
        print("native selftest: SKIP (native pipeline unavailable)")
        return 0
    try:
        stats = run_parity(clf)
    except AssertionError as exc:
        print(f"native selftest: FAIL — {exc}", file=sys.stderr)
        return 1
    us = bench_crossing(clf)
    print(
        f"native selftest: parity OK over {stats['blobs']} blobs; "
        f"featurize crossing {us} us/blob"
    )
    split = profile_split()
    if split is not None and split.get("us_per_blob"):
        stages = split["us_per_blob"]
        shown = ", ".join(
            f"{key.split('.', 1)[-1]} {stages[key]}"
            for key in (
                "stage.tokenize_only", "s2.title_strips", "s2.fold_spell"
            )
            if key in stages
        )
        if shown:
            print(f"native selftest: stage split (us/blob): {shown}")
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--profile-json":
        n_arg = int(sys.argv[2]) if len(sys.argv) > 2 else 256
        sys.exit(_profile_main(n_arg))
    sys.exit(main())
