"""The port on the card: both CUDA kernels against their plain versions,
and `batch-detect` through each kernel against the `--device cpu` run.

These need a CUDA device and skip elsewhere.  They import neither JAX nor
the JAX package, so they run on the machine with the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import os

import numpy as np
import pytest
import torch

from licensee_tpu_torch import convert
from licensee_tpu_torch.cli.main import main as port_main
from licensee_tpu_torch.corpus.compiler import default_corpus
from licensee_tpu_torch.kernels import dice_cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the machine with the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("B", [1, 1000, 4096])
def test_kernels_match_plain_versions(card, B):
    ct = convert.corpus_tensors(default_corpus(), card)
    rng = np.random.default_rng(B)
    W = ct.bits.shape[1]
    feats = (
        torch.from_numpy(
            rng.integers(0, 2**32, (B, W), dtype=np.uint32).view(np.int32)
        ).to(card),
        torch.from_numpy(rng.integers(0, 3000, B).astype(np.int32)).to(card),
        torch.from_numpy(rng.integers(0, 60000, B).astype(np.int32)).to(card),
        torch.from_numpy(rng.random(B) < 0.2).to(card),
    )
    meta = dice_cuda.pack_meta(ct)
    got = dice_cuda.score_pairs_fused(meta, ct.bits, *feats)
    want = dice_cuda.score_pairs_fused_plain(meta, ct.bits, *feats)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    tpl = dice_cuda.pack_templates_mma(ct)
    assert torch.equal(
        dice_cuda.overlap_pairs_mma(tpl, feats[0], ct.n_templates),
        dice_cuda.overlap_pairs_mma_plain(tpl, feats[0], ct.n_templates),
    )


def test_wrappers_refuse_what_the_kernels_cannot_take(card):
    ct = convert.corpus_tensors(default_corpus(), card)
    meta = dice_cuda.pack_meta(ct)
    fb = ct.bits[:, :-1].contiguous()  # W not a multiple of 4
    ones = torch.ones(fb.shape[0], dtype=torch.int32, device=card)
    flags = torch.zeros(fb.shape[0], dtype=torch.bool, device=card)
    with pytest.raises(ValueError):
        dice_cuda.score_pairs_fused(meta, ct.bits, fb, ones, ones, flags)
    with pytest.raises(TypeError):
        dice_cuda.score_pairs_fused(
            meta, ct.bits, ct.bits, ones.float(), ones, flags)


def test_batch_detect_on_the_card_matches_cpu(card, tmp_path):
    paths = sorted(
        os.path.join(d, f)
        for d, _dirs, files in os.walk(FIXTURES)
        if os.path.relpath(d, FIXTURES).split(os.sep)[0] != "analysis"
        for f in files
        if not f.endswith((".json", ".yml"))
    )
    manifest = tmp_path / "manifest.txt"
    manifest.write_text("\n".join(paths) + "\n", encoding="utf-8")
    for method, kernel in (("pallas", "score_pairs_fused"),
                           ("pallas-mxu", "overlap_pairs_mma")):
        outs = []
        for device in ("cpu", "cuda"):
            dice_cuda.reset_launches()
            out = tmp_path / f"{method}.{device}.jsonl"
            assert port_main(["batch-detect", str(manifest), "--output",
                              str(out), "--method", method,
                              "--device", device]) == 0
            outs.append(out.read_bytes())
        assert dice_cuda.LAUNCHES[kernel] > 0
        assert outs[0] == outs[1]
