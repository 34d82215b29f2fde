"""The port's corpus against the JAX package's: the YAML-free metadata
reader against PyYAML, the compiled corpus array for array, the
normalized content hash of every vendored license, and the numpy
carry-over of `licensee_tpu_torch.convert`."""

import glob
import os
import re

import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import numpy as np
import pytest
import torch
import yaml

from licensee_tpu import vendor_paths
from licensee_tpu.corpus.compiler import default_corpus as jax_default_corpus
from licensee_tpu.corpus.license import License as JaxLicense
from licensee_tpu_torch import convert
from licensee_tpu_torch.corpus import yamlite
from licensee_tpu_torch.corpus.compiler import default_corpus
from licensee_tpu_torch.corpus.fields import LicenseField
from licensee_tpu_torch.corpus.license import License

# one intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core would crowd them
torch.set_num_threads(1)

LICENSE_FILES = sorted(glob.glob(os.path.join(vendor_paths.LICENSE_DIR, "*.txt")))
LICENSE_KEYS = [os.path.basename(f)[: -len(".txt")] for f in LICENSE_FILES]
ARRAYS = ("bits", "n_wf", "n_fieldset", "field_count", "alt_count",
          "length", "cc_flag")

# every scalar and list key detection could read; nested maps (`using`)
# are skipped by the reader by design
COMPARED_KEYS = ("title", "spdx-id", "nickname", "featured", "hidden",
                 "description", "how", "note", "permissions", "conditions",
                 "limitations")


def test_vendored_corpus_has_47_licenses():
    assert len(LICENSE_FILES) == 47


@pytest.mark.parametrize("key", LICENSE_KEYS)
def test_front_matter_matches_pyyaml(key):
    with open(os.path.join(vendor_paths.LICENSE_DIR, f"{key}.txt"),
              encoding="utf-8") as f:
        raw = f.read()
    front = re.match(r"\A(---\n.*\n---\n+)?(.*)", raw, re.S).group(1)
    want = next(d for d in yaml.safe_load_all(front) if d is not None)
    got = yamlite.front_matter(front)
    for k in COMPARED_KEYS:
        assert got.get(k) == want.get(k), k
    # nothing the reader returns disagrees, and only nested maps are left out
    assert {k: v for k, v in want.items() if k in got} == got
    assert all(isinstance(want[k], dict) for k in want if k not in got)


def test_fields_yml_matches_pyyaml():
    with open(vendor_paths.FIELDS_YML, encoding="utf-8") as f:
        text = f.read()
    assert yamlite.load_sequence_of_mappings(text) == yaml.safe_load(text)
    assert [f.name for f in LicenseField.all()] == [
        e["name"] for e in yaml.safe_load(text)
    ]


@pytest.mark.parametrize("text", [
    "title: \"unterminated\n",
    "title: [a, b]\n",
    "  indented: x\n",
    "key:\n  - a\n  b: c\n",
    "date: 2020-01-02\n",
    "hex: 0x1F\n",
    "escape: \"a\\nb\"\n",
])
def test_reader_refuses_what_it_does_not_know(text):
    with pytest.raises(ValueError):
        yamlite.load_mapping(text)


def test_reader_scalars_match_pyyaml():
    text = (
        "a: 'it''s'\nb: \"q \\\" q\"\nc: ~\nd: 12\ne: plain \"x\" y\n"
        "f: []\ng: a plain scalar\n  folded over lines\nh: true # comment\n"
        "i:\n  - one\n  - 'two'\nj: 1.5\nk: 0BSD\nl: off\n"
    )
    assert yamlite.load_mapping(text) == yaml.safe_load(text)


def test_compiled_corpus_equals_jax():
    ours, ref = default_corpus(), jax_default_corpus()
    assert ours.keys == ref.keys
    assert list(ours.vocab.items()) == list(ref.vocab.items())
    assert (ours.n_templates, ours.vocab_size, ours.n_lanes) == (47, 3552, 112)
    for name in ARRAYS:
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert ours.content_hashes == ref.content_hashes
    assert ours.exact_sets == ref.exact_sets


@pytest.mark.parametrize("key", LICENSE_KEYS)
def test_content_hash_matches_jax(key):
    ours, ref = License.find(key), JaxLicense.find(key)
    assert ours.content_hash == ref.content_hash
    assert (ours.title, ours.spdx_id, ours.nickname, ours.featured_q,
            ours.hidden_q) == (ref.title, ref.spdx_id, ref.nickname,
                               ref.featured_q, ref.hidden_q)


def test_license_rules_wait_for_a_later_slice():
    """The rules came with the `detect` slice: `License.rules` reads
    rules.yml through the port's reader and gives the JAX package's
    table (tests/test_torch_detect.py holds every license's)."""
    from licensee_tpu.corpus.license import License as JaxLicense

    rules = License.find("mit").rules
    assert rules.to_h() == JaxLicense.find("mit").rules.to_h()
    assert [r.tag for r in rules["conditions"]] == ["include-copyright"]


def test_corpus_from_numpy_round_trips():
    ref = jax_default_corpus()
    carried = convert.corpus_from_numpy(
        ref.keys, ref.vocab, {n: np.asarray(getattr(ref, n)) for n in ARRAYS},
        ref.content_hashes, ref.exact_sets,
    )
    ours = default_corpus()
    assert carried.keys == ours.keys and carried.vocab == ours.vocab
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(carried, name), getattr(ours, name))
    assert carried.exact_sets == ours.exact_sets
    assert carried.content_hashes == ours.content_hashes
    ct = convert.corpus_tensors(carried, "cpu")
    assert ct.bits.dtype == torch.int32 and ct.bits.device.type == "cpu"
    np.testing.assert_array_equal(
        ct.bits.numpy().view(np.uint32), np.asarray(ref.bits))
    assert bool(ct.valid.all())


def test_corpus_from_numpy_checks_shapes():
    ref = jax_default_corpus()
    arrays = {n: np.asarray(getattr(ref, n)) for n in ARRAYS}
    arrays["length"] = arrays["length"][:-1]
    with pytest.raises(ValueError, match="length"):
        convert.corpus_from_numpy(ref.keys, ref.vocab, arrays)
