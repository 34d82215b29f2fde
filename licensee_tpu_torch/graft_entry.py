"""Entry points of the port: one scoring step, and the mesh dry run.

The twin of the JAX package's ``__graft_entry__.py``:

* `entry` returns ``(fn, example_args)``: ``fn`` is one scoring step of
  Dice over the compiled vendored corpus (T=47, W=112), and
  ``example_args`` the features of 64 rendered templates on the device.
  On a card ``fn`` is K1's fused first-max (`dice_cuda.best_match_fused`,
  one launch); on the CPU the plain `dice_ref.best_match`.  No graph is
  captured and nothing is compiled ahead: the kernels build at first use.
* `dryrun_multichip` runs the product path, `BatchClassifier` over a
  (data, model) mesh of ``n_devices`` devices (K5,
  `parallel/mesh.py`), on noisy rendered templates that all take the
  device path, and checks every verdict.  The mesh cycles over the
  visible devices, so one card (or the CPU) stands in for as many as the
  mesh asks.

    python -m licensee_tpu_torch.graft_entry [dryrun [N]] [--device cpu]

Both run on the card unless the caller asks for the CPU; without a card
they raise.
"""

from __future__ import annotations

import argparse
import re
import sys

import numpy as np
import torch


def _rendered(lic) -> str:
    """A template's text with every ``[field]`` filled in."""
    return re.sub(r"\[(\w+)\]", "x", lic.content or "")


def _example_features(batch: int, corpus):
    """Featurize rendered templates into a fixed-size batch: (uint32
    bits[batch, W], int32 n_words, int32 lengths, bool cc_fp) as numpy."""
    from licensee_tpu_torch.corpus.license import License
    from licensee_tpu_torch.kernels.batch import NormalizedBlob

    licenses = License.all(hidden=True, pseudo=False)
    W = corpus.n_lanes
    bits = np.zeros((batch, W), dtype=np.uint32)
    n_words = np.zeros(batch, dtype=np.int32)
    lengths = np.zeros(batch, dtype=np.int32)
    cc_fp = np.zeros(batch, dtype=bool)
    for i in range(batch):
        blob = NormalizedBlob(_rendered(licenses[i % len(licenses)]))
        bits[i], n_words[i], lengths[i] = corpus.file_features(blob)
    return bits, n_words, lengths, cc_fp


def entry(device="cuda"):
    """(fn, example_args): one scoring step over the compiled vendored
    corpus.  ``fn(file_bits, n_words, lengths, cc_fp)`` takes tensors on
    the device (int32 view of the uint32 bits[B, W], int32[B], int32[B],
    bool[B]) and returns the exact top-1 (idx, num, den) int32[B]."""
    from licensee_tpu_torch.convert import corpus_tensors
    from licensee_tpu_torch.corpus.compiler import default_corpus
    from licensee_tpu_torch.kernels import dice_cuda, dice_ref
    from licensee_tpu_torch.kernels.batch import resolve_device

    dev = resolve_device(device)
    corpus = default_corpus()
    ct = corpus_tensors(corpus, dev)
    bits, n_words, lengths, cc_fp = _example_features(64, corpus)
    example_args = (
        torch.from_numpy(bits.view(np.int32)).to(dev),
        torch.from_numpy(n_words).to(dev),
        torch.from_numpy(lengths).to(dev),
        torch.from_numpy(cc_fp).to(dev),
    )
    if dev.type == "cuda":
        meta = dice_cuda.pack_meta(ct)

        def fn(file_bits, n_words, lengths, cc_fp):
            return dice_cuda.best_match_fused(
                meta, ct.bits, file_bits, n_words, lengths, cc_fp
            )
    else:
        def fn(file_bits, n_words, lengths, cc_fp):
            return dice_ref.best_match(ct, file_bits, n_words, lengths, cc_fp)

    return fn, example_args


def dryrun_blobs(batch: int) -> tuple[list[str], list[str]]:
    """(contents, expected keys): rendered templates with a noise line
    mid-body, so no blob is an exact rendering and every one takes the
    Dice device path.  Noise at the end would be cut by the end-of-terms
    truncation of the GPL-family and Apache templates."""
    from licensee_tpu_torch.corpus.license import License

    licenses = License.all(hidden=True, pseudo=False)
    contents, expected = [], []
    for i in range(batch):
        lic = licenses[i % len(licenses)]
        lines = _rendered(lic).splitlines()
        lines.insert(len(lines) // 2, f"noise row {i} injected for dryrun")
        contents.append("\n".join(lines))
        expected.append(lic.key)
    return contents, expected


def dryrun_multichip(n_devices: int, device="cuda") -> list:
    """Run the batch path over an ``n_devices`` mesh (blob batch over the
    'data' axis, the template bit matrix split over 'model' with the
    partial overlaps summed) on one padded batch; raises unless every
    blob took the device path and got its template's key.  Returns the
    `BlobResult` rows."""
    from licensee_tpu_torch.kernels.batch import (
        BatchClassifier,
        resolve_device,
    )
    from licensee_tpu_torch.parallel.mesh import build_mesh, visible_devices

    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    dev = resolve_device(device)
    n_model = 2 if n_devices % 2 == 0 else 1
    n_data = n_devices // n_model
    local = visible_devices(dev.type)
    mesh = build_mesh(n_data, n_model, devices=[
        local[i % len(local)] for i in range(n_devices)
    ])
    batch = max(n_data * 8, 16)
    classifier = BatchClassifier(pad_batch_to=batch, mesh=mesh, device=dev)
    contents, expected = dryrun_blobs(batch)
    results = classifier.classify_blobs(contents, threshold=25.0)

    n_dice = sum(1 for r in results if r.matcher == "dice")
    n_agree = sum(1 for e, r in zip(expected, results) if e == r.key)
    if n_agree != batch:
        raise AssertionError(
            f"multichip dryrun disagreement: {n_agree}/{batch}")
    if n_dice != batch:
        raise AssertionError(
            f"expected all blobs on the device path: {n_dice}/{batch}")
    print(
        f"dryrun_multichip OK: mesh={dict(classifier.mesh.shape)}, "
        f"batch={batch}, agreement={n_agree}/{batch} (product "
        "BatchClassifier path)"
    )
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m licensee_tpu_torch.graft_entry",
        description="One scoring step over the vendored corpus, or the "
                    "batch path's dry run over a device mesh.",
    )
    parser.add_argument("command", nargs="?", choices=("dryrun",))
    parser.add_argument("n_devices", nargs="?", type=int, default=8)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    try:
        if args.command == "dryrun":
            dryrun_multichip(args.n_devices, device=args.device)
        else:
            fn, example_args = entry(args.device)
            out = fn(*example_args)
            print("entry OK:", [o.cpu().numpy()[:4] for o in out])
    except RuntimeError as exc:
        print(f"graft_entry: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
