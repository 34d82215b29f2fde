"""Batch classification: host pre-filters + the Dice kernels on the device.

The port's counterpart of `licensee_tpu/kernels/batch.py`.  It mirrors
the first-match-wins matcher chain of the reference
(`project_files/license_file.rb:67-69`: Copyright -> Exact -> Dice): the
host sanitizes each blob, short-circuits it through the Copyright and
Exact pre-filters, and featurizes the rest into packed bitsets; the
device scores every (blob, template) pair with K1 or K2
(`kernels/dice_cuda.py`) and picks the exact int64 first-max, or with
``closest`` the exact top-k (`dice_cuda.topk_fused` in K1's epilogue,
`dice_cuda.topk_exact` after K2); the host finishes
the score in float64 and applies the threshold.

The modes are the JAX package's: ``license``; ``readme`` (each blob cut
to its License section first, then the license chain, then the
Reference matcher as the fallback, its scan in PCRE2 where the native
library is up); ``package`` (the filename-dispatched package-manifest
matchers, host only); and ``auto`` (each row routed by its filename
through the reference's score tables, `route_for`).  `attribution_for`
gives a matched row's copyright line.

The host featurizes a whole batch in one crossing into the native
pipeline (`native/pipeline.py`, the GIL dropped), and redoes on the
pure-Python pipeline each blob the native side cannot take (non-ASCII
text, a PCRE2 resource limit, HTML).  The device half is asynchronous:
`dispatch_chunks_async` stages each chunk in pinned host rows, enqueues
it on the device's dispatch stream and returns a `DeviceFuture` that a
CUDA event resolves.

Several devices serve one classifier in either of two ways, as in the
JAX package: ``mesh`` splits every chunk over a (data, model) grid of
devices (K5, `parallel/mesh.py`), and ``lanes`` round-robins whole
chunks over K device lanes, each with its own stream and pinned
staging, so one featurize stage feeds K devices.
"""

from __future__ import annotations

import functools
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

import licensee_tpu_torch
from licensee_tpu_torch.convert import corpus_tensors
from licensee_tpu_torch.corpus.compiler import (
    CompiledCorpus,
    default_corpus,
    pack_ids,
)
from licensee_tpu_torch.native import pipeline as native_pipeline
from licensee_tpu_torch.kernels import dice_cuda
from licensee_tpu_torch.normalize.pipeline import (
    COPYRIGHT_FULL_REGEX,
    COPYRIGHT_REGEX,
    NormalizedContent,
)
from licensee_tpu_torch.project_files.license_file import (
    CC_FALSE_POSITIVE_REGEX,
    COPYRIGHT_NAME_REGEX,
    LicenseFile,
)
from licensee_tpu_torch.project_files.package_manager_file import (
    PackageManagerFile,
)
from licensee_tpu_torch.project_files.project_file import sanitize_content
from licensee_tpu_torch.project_files.readme_file import ReadmeFile
from licensee_tpu_torch.rubytext import rb, ruby_strip

METHODS = ("auto",) + dice_cuda.K1_METHODS + dice_cuda.K2_METHODS
MODES = ("license", "readme", "package", "auto")

# staging slots kept per chunk shape: the pipeline's depth of groups in
# flight plus the one being filled (`_StagingRing`)
STAGING_DEPTH = 3

# The kernel crossover on the card, as in the JAX package's table of the
# same name (`licensee_tpu/kernels/batch.py`), but from the port's own
# times: ascending (max_templates, method) rungs, None for everything
# above.  It compares the whole score step of a 4096-row batch as the
# batch path runs it, the argmax included (chip_smoke.py phase 3's
# "scorer" lines, PERF.md §6): K1 is one launch that fuses the score
# algebra and the exact first-max, while K2 leaves both to some hundred
# PyTorch launches, which cost more than K2 saves, eager and on device
# time, at T=47 and at T=608 alike.  So K1 takes every width until the
# algebra and the argmax are fused into K2's epilogue (ROADMAP, K4).
METHOD_CROSSOVER: tuple = ((None, "popcount"),)


def resolve_method(n_templates: int) -> str:
    """The measured-best scoring method for a corpus of this width."""
    for bound, method in METHOD_CROSSOVER:
        if bound is None or n_templates <= bound:
            return method
    raise AssertionError("METHOD_CROSSOVER must end with a None rung")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asked for
    the CPU.  A CUDA request without a usable card raises; nothing
    carries on on the CPU in its place."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default; "
            "pass device='cpu' (--device cpu) to run the plain PyTorch "
            "scorers on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (want cuda or cpu)")
    return dev


@functools.lru_cache(maxsize=1)
def _reference_union():
    """The corpus-wide Reference alternation: every license's
    title|source pattern as a named group ``g<pool-index>``, compiled
    once per process (the license pool is process-global and frozen).
    The patterns hold unnamed inner groups (the optional version
    minors), so ``m.lastgroup`` is unreliable; a caller finds the
    matched alternative as the one non-None named group."""
    from licensee_tpu_torch.corpus.license import License

    lics = tuple(License.all(hidden=True, pseudo=False))
    parts = []
    for i, lic in enumerate(lics):
        inner = [lic.title_regex_pattern]
        source = lic.source_regex_pattern
        if source:
            inner.append(source)
        parts.append(f"(?P<g{i}>" + "|".join(inner) + ")")
    return lics, rb(r"\b(?:" + "|".join(parts) + r")\b")


@functools.lru_cache(maxsize=1)
def _refscan_native():
    """(pipeline, handle) for the PCRE2-compiled Reference union, or None
    when the native library is unavailable or rejects the pattern."""
    nat = native_pipeline.load()
    if nat is None:
        return None
    lics, union = _reference_union()
    # byte-mode PCRE2 (no UTF/UCP) is the faithful translation of rb()'s
    # re.A (ASCII-only \b and \w over UTF-8, where every non-ASCII byte
    # is a non-word byte)
    handle = nat.refscan_new(union)
    if handle is None:
        return None
    # the per-license patterns let the shadow resolution run in one
    # crossing; if PCRE2 refuses them the Python loop stays in charge
    nat.refscan_set_singles(handle, [lic.reference_regex for lic in lics])
    return nat, handle


@functools.lru_cache(maxsize=None)
def _has_fullname(key: str) -> bool:
    """Does the vendored license's template carry a [fullname] field?
    Memoized: keys come from a small fixed pool."""
    from licensee_tpu_torch.corpus.license import License

    lic = License.find(key)
    return (
        lic is not None and bool(lic.content) and "[fullname]" in lic.content
    )


def _readme_section(raw, html: bool) -> str | None:
    """A README's License section as the reference reads it, for
    `prepare_batch` and `attribution_for` alike: the sanitized blob, an
    HTML README made markdown BEFORE the header-shaped CONTENT_REGEX
    scan, then `ReadmeFile.license_content` (None: no such section)."""
    content = sanitize_content(raw) if raw is not None else ""
    if html:
        from licensee_tpu_torch.normalize.html2md import html_to_markdown

        content = html_to_markdown(content)
    return ReadmeFile.license_content(content)


class DeviceFuture:
    """A handle to in-flight device scoring.

    Submission already happened (the copies to the card, the launches and
    the copy back are enqueued on the dispatch stream, each chunk behind
    a CUDA event), so holding a DeviceFuture costs nothing on the host;
    :meth:`result` blocks only until the events complete and returns the
    ``[(chunk, (idx, num, den)), ...]`` outs list that ``finish_chunks``
    consumes, copied out of the staging slots (with ``closest``, the
    top-1 then the top-k columns: ``(idx, num, den, k_idx, k_num,
    k_den)``, as the JAX package's top-k scorer).  ``ready()`` polls
    without blocking.  Resolution releases the staging slots the
    dispatch borrowed, so a slot is never refilled while its copies may
    still be in flight; a future must be awaited (or dropped) for its
    slots to recycle.  On the CPU every event is None: the plain scorers
    ran at submit."""

    __slots__ = ("_parts", "_resolved", "_release")

    def __init__(self, parts, release):
        self._parts = parts  # [(chunk, HostRows slot, event or None)]
        self._resolved = None
        self._release = release

    def __len__(self) -> int:
        return len(self._parts)

    def ready(self) -> bool:
        """True when every chunk's (idx, num, den) has landed on the host."""
        return self._resolved is not None or all(
            done is None or done.query() for _c, _s, done in self._parts
        )

    def result(self):
        """Await: every chunk's outputs as host numpy (idempotent)."""
        if self._resolved is None:
            resolved = []
            for chunk, slot, done in self._parts:
                if done is not None:
                    done.synchronize()
                resolved.append(
                    (chunk, tuple(a.copy() for a in slot.result(len(chunk))))
                )
            self._resolved = resolved
            for _chunk, slot, _done in self._parts:
                self._release(slot)
        return self._resolved


class _StagingRing:
    """Host staging slots (`dice_cuda.HostRows`) for dispatch chunks,
    pinned where the scorer runs on a card.

    One free-list per chunk capacity.  ``acquire`` never blocks: when the
    ring is dry it allocates a fresh slot (the pipeline depth, not the
    ring, bounds the chunks in flight; a blocking acquire could deadlock
    the one thread that both submits and awaits), and ``release`` keeps
    at most ``depth`` slots per capacity, so a burst allocates and the
    steady state recycles, with no page-locked allocation in it."""

    def __init__(self, alloc, depth: int):
        self._alloc = alloc  # capacity -> HostRows
        self.depth = depth
        self._free: dict[int, list] = {}
        self._lock = threading.Lock()

    def acquire(self, capacity: int):
        with self._lock:
            free = self._free.setdefault(capacity, [])
            if free:
                return free.pop()
        return self._alloc(capacity)

    def release(self, slot) -> None:
        with self._lock:
            free = self._free.setdefault(slot.capacity, [])
            if len(free) < self.depth:
                free.append(slot)


class NormalizedBlob(NormalizedContent):
    """A bare content blob run through the normalization engine."""

    def __init__(self, content: str | bytes | None, filename: str | None = None):
        self.content = (
            sanitize_content(content) if content is not None else None
        )
        self.filename = filename


@dataclass
class BlobResult:
    key: str | None
    matcher: str | None
    confidence: float
    score_num: int = 0
    score_den: int = 0
    error: str | None = None
    # the top-k candidates [(key, confidence), ...] when the classifier
    # runs with closest=K
    closest: list | None = None
    # the copyright line, when requested (--attribution) and applicable
    # (license_file.rb:71-77)
    attribution: str | None = None

    def as_dict(self) -> dict:
        """The verdict fields of a serve response row."""
        d = {
            "key": self.key,
            "matcher": self.matcher,
            "confidence": self.confidence,
        }
        if self.closest is not None:
            d["closest"] = [[k, c] for k, c in self.closest]
        if self.attribution is not None:
            d["attribution"] = self.attribution
        return d


@dataclass
class PreparedBatch:
    """One featurized batch between the host produce stage and the device.

    ``results`` carries a BlobResult for every blob short-circuited on the
    host (prefilters, package matchers, featurize errors) and None for
    the ``todo`` rows, whose feature arrays are device-ready.
    ``sections`` (readme rows only) keeps each blob's extracted license
    section for the Reference fallback (readme_file.rb:32-34)."""

    results: list
    bits: np.ndarray
    n_words: np.ndarray
    lengths: np.ndarray
    cc_fp: np.ndarray
    todo: list
    sections: list | None = None
    # feature arrays hold ONLY the todo rows (row j <-> todo[j]) after
    # compact_features(); results/todo/sections keep full-batch indexing
    compact: bool = False

    def compact_features(self) -> None:
        """Slice the feature arrays down to the todo rows.  Idempotent."""
        if self.compact:
            return
        if len(self.todo) < len(self.results):
            idx = np.asarray(self.todo, dtype=np.int64)
            self.bits = self.bits[idx]
            self.n_words = self.n_words[idx]
            self.lengths = self.lengths[idx]
            self.cc_fp = self.cc_fp[idx]
        self.compact = True


class BatchClassifier:
    """Classify many blobs against a compiled corpus.

    Host side: sanitization, Copyright / Exact pre-filters, normalization +
    tokenization into packed bitsets.  Device side: K1 (``popcount``,
    ``pallas``) or K2 (``matmul``, ``pallas-mxu``; ``auto`` picks one by
    template count, `resolve_method`), then the exact argmax, or with
    ``closest`` the exact top-k.  Scores come back to the host as exact
    (overlap, denominator) pairs and are finished in float64 —
    bit-identical to the scalar Ruby-semantics path.

    ``mode="package"`` is host only: no corpus is compiled (``corpus``
    is kept as given, None for the default) and nothing is dispatched.

    ``device=None`` builds a host-only classifier, the featurize worker
    processes' (``--featurize-procs``): `prepare_batch` works in full,
    but it holds no device tensors, never touches CUDA, and
    `dispatch_chunks_async` raises.

    ``mesh`` is a `parallel.mesh.DeviceMesh`, an ``(n_data, n_model)``
    tuple, ``"auto"`` (every visible card on the data axis; one device
    stays unsharded) or None; on the CPU a mesh repeats the CPU device.
    ``lanes`` (int, ``"auto"`` or a list of devices) round-robins whole
    chunks over that many devices instead; the two exclude each other.
    """

    def __init__(
        self,
        corpus: CompiledCorpus | None = None,
        method: str = "auto",
        pad_batch_to: int = 1024,
        mode: str = "license",
        closest: int = 0,
        device="cuda",
        mesh="auto",
        lanes=None,
    ):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}")
        self.closest = int(closest)
        if self.closest < 0:
            raise ValueError("closest must be >= 0")
        if method not in METHODS:
            raise ValueError(f"unknown scoring method: {method!r}")
        if pad_batch_to < 1:
            raise ValueError(f"pad_batch_to must be >= 1, got {pad_batch_to}")
        self.mode = mode
        self.device = None if device is None else resolve_device(device)
        self.pad_batch_to = pad_batch_to
        # device dispatch accounting (`dispatch_stats`): the first
        # dispatch of a chunk shape is set-up (the kernel library's load,
        # the first launch, the pinned staging allocation), every later
        # one steady-state enqueue
        self._dispatch_lock = threading.Lock()
        self._dispatch_prof = {
            "compiles": 0, "compile_s": 0.0,
            "dispatches": 0, "dispatch_s": 0.0,
        }
        self._dispatched_shapes: set = set()
        self._shape_prof: dict[int, dict] = {}
        self.tensors = self._scorer = self._staging = None
        self.mesh = None
        self.devices = None  # the device lanes, where more than one
        self._lanes: list = []  # [(scorer, staging ring)], one per lane
        self._rr = 0  # the lanes' round-robin cursor
        if mode == "package":
            # package manifests are matched by the filename-dispatched
            # lenient regexes alone (package_manager_file.rb): no corpus
            # is compiled and no scorer built; an explicit mesh is a
            # caller's error, not an option silently ignored
            if mesh is not None and mesh != "auto":
                raise ValueError(
                    "package mode runs host-only; pass mesh=None"
                )
            if self.closest:
                raise ValueError(
                    "closest needs the Dice scorer; package mode never "
                    "runs it"
                )
            self.corpus = corpus
            self.method = method
            self._exact_map = {}
            self._nat = None
            self._exact_hashes = {}
            self._exact_feats = {}
            return
        self.corpus = corpus or default_corpus()
        if method == "auto":
            method = resolve_method(self.corpus.n_templates)
        self.method = method
        if self.closest and method.startswith("pallas"):
            # as the JAX package refuses it (its Pallas kernels have no
            # k output columns), whatever the port's kernels could do
            raise ValueError(
                "closest is not supported with the pallas methods"
            )
        if self.device is not None:
            self._init_device(mesh, lanes)
        # Exact matcher pre-filter (matchers/exact.rb:6-13) against the
        # corpus's own template renderings, not the vendored pool
        self._exact_map = self.corpus.exact_sets
        self._init_native()

    def _init_device(self, mesh, lanes) -> None:
        """The device scorers: one lane on ``self.device``, K lanes, or a
        mesh; each lane with its own dispatch stream and staging ring."""
        # top-1 stays exact with or without closest: the top-k's
        # column 0 is the first-max
        k = (
            min(self.closest + 1, self.corpus.n_templates)
            if self.closest
            else 0
        )
        if lanes is not None:
            if mesh not in (None, "auto"):
                raise ValueError(
                    "lanes round-robins whole chunks per chip; pass "
                    "mesh=None (or leave mesh='auto' to be overridden)"
                )
            if self.method.startswith("pallas"):
                raise ValueError(
                    "the pallas methods are single-device; lanes cannot "
                    "round-robin them"
                )
            mesh = None  # a lanes classifier never shards one chunk
            devices = self._resolve_lanes(lanes)
            if len(devices) > 1:
                self.devices = devices
        else:
            devices = [self.device]
        self.mesh = self._resolve_mesh(
            mesh, self.method, self.pad_batch_to, self.device
        )
        self.tensors = corpus_tensors(self.corpus, self.device)
        if self.mesh is not None:
            from licensee_tpu_torch.parallel.mesh import MeshScorer

            scorers = [MeshScorer(self.tensors, self.mesh, self.method, k)]
        else:
            scorers = [
                dice_cuda.BestMatchScorer(
                    self.tensors if dev == self.device
                    else corpus_tensors(self.corpus, dev),
                    self.method, k, lane=lane,
                )
                for lane, dev in enumerate(devices)
            ]
        self._lanes = [
            (sc, _StagingRing(functools.partial(sc.host_rows, lane=lane),
                              STAGING_DEPTH))
            for lane, sc in enumerate(scorers)
        ]
        self._scorer, self._staging = self._lanes[0]

    def _resolve_lanes(self, lanes) -> list:
        """The devices of ``lanes``: the first K visible devices of this
        classifier's kind (``"auto"``: all), or an explicit device list,
        which may repeat a device (two lanes, two streams, one card).
        On the CPU K lanes repeat the CPU device."""
        if isinstance(lanes, (list, tuple)):
            devices = [torch.device(d) for d in lanes]
            if not devices:
                raise ValueError("lanes needs at least one device")
            return devices
        from licensee_tpu_torch.parallel.mesh import visible_devices

        local = visible_devices(self.device.type)
        if self.device.type == "cpu":
            k = 1 if lanes == "auto" else int(lanes)
            local = local * max(k, 1)
        else:
            k = len(local) if lanes == "auto" else int(lanes)
        if k < 1:
            raise ValueError(f"lanes must be >= 1, got {lanes!r}")
        if k > len(local):
            raise ValueError(
                f"lanes={k} but only {len(local)} visible devices "
                "(the chip-partition contract: set "
                "LICENSEE_TPU_VISIBLE_CHIPS / --chips-per-stripe)"
            )
        return local[:k]

    @staticmethod
    def _resolve_mesh(mesh, method: str, pad_batch_to: int, device):
        """Resolve ``mesh`` to a `DeviceMesh`, or None (one device).

        The dispatch chunk of ``pad_batch_to`` rows is split over the
        data axis, which must divide it (as in the JAX package, whose
        chunks are padded); ``"auto"`` shrinks the data axis to the
        largest visible device count that does."""
        if mesh is None:
            return None
        from licensee_tpu_torch.parallel.mesh import (
            DeviceMesh,
            build_mesh,
            visible_devices,
        )

        if isinstance(mesh, DeviceMesh):
            resolved = mesh
        elif mesh == "auto":
            if method.startswith("pallas") or device.type == "cpu":
                # the pallas methods stay on one device, as the JAX
                # package's hand-scheduled kernels do; the CPU is one
                return None
            local = visible_devices("cuda")
            n = len(local)
            while n > 1 and pad_batch_to % n:
                n -= 1
            if n <= 1:
                return None
            resolved = build_mesh(n_data=n, n_model=1, devices=local)
        else:
            n_data, n_model = mesh
            if n_data < 1 or n_model < 1:
                raise ValueError(
                    f"mesh axes must be positive, got ({n_data}, {n_model})"
                )
            # on the CPU a mesh repeats the one CPU device
            devices = (
                [device] * (n_data * n_model)
                if device.type == "cpu" else None
            )
            resolved = build_mesh(n_data=n_data, n_model=n_model,
                                  devices=devices)
        if method.startswith("pallas"):
            raise ValueError(
                "the pallas methods are single-device; pass mesh=None"
            )
        n_data = resolved.shape["data"]
        if pad_batch_to % n_data:
            raise ValueError(
                f"pad_batch_to={pad_batch_to} is not divisible by the "
                f"data axis ({n_data})"
            )
        return resolved

    def _init_native(self) -> None:
        """Load the whole-pipeline native featurizer: sanitize ->
        featurize in one ctypes crossing per batch (native/pipeline.cpp);
        the Python pipeline stays where the toolchain or libpcre2 is
        missing or LICENSEE_TPU_NO_NATIVE is set."""
        self._nat = native_pipeline.load()
        self._nat_vocab = None
        self._exact_hashes: dict[bytes, str] = {}
        # per-hash equality-proof constants: the template's FULL-wordset
        # in-vocab bit projection + |wordset| (see _confirm_exact)
        self._exact_feats: dict[bytes, tuple[np.ndarray, int, str]] = {}
        if self._nat is None:
            return
        self._nat_vocab = self._nat.vocab(
            list(self.corpus.vocab.keys()), self.corpus.n_lanes
        )
        for wordset, key in self.corpus.exact_sets.items():
            h = self._nat.exact_hash(wordset)
            if h in self._exact_hashes:
                continue
            self._exact_hashes[h] = key
            ids = [
                self.corpus.vocab[w] for w in wordset if w in self.corpus.vocab
            ]
            self._exact_feats[h] = (
                pack_ids(ids, self.corpus.n_lanes), len(wordset), key
            )

    # -- batch preparation (prefilters + featurization in one pass) --

    def prepare_batch(
        self,
        contents: list[str | bytes],
        prefilter: bool = True,
        filenames: list[str | None] | None = None,
        preset: list | None = None,
        routes: list | None = None,
    ) -> PreparedBatch:
        """Sanitize, prefilter and featurize a batch of raw blobs.

        ``results`` holds a BlobResult for prefiltered blobs and None for
        the ``todo`` indexes, whose feature rows are filled and ready for
        the device.  ``filenames`` (parallel to ``contents``) enables
        the HTML->markdown conversion for ``*.html`` files
        (content_helper.rb:293-299) and, in package and auto mode, the
        filename dispatch.  ``preset`` pre-assigns result rows (the
        dedupe cache's hits) so those blobs skip featurization and the
        device.  A blob whose featurization raises gets an ``error`` row
        and the rest of the batch proceeds.  ``prefilter=False`` skips the
        Copyright and Exact short-circuits, so that every blob reaches
        the scorer (the DiceXLA matcher, whose chain has run them).

        In readme mode each blob is first cut to its License section
        (`ReadmeFile.license_content`, after the HTML->markdown step for
        an HTML README); a blob with no such section matches nothing,
        and the sections are kept for the Reference fallback.  In auto
        mode each row runs the chain its filename routes to
        (`route_for`; ``routes`` passes them precomputed): license rows
        the license chain, readme rows the readme chain, package rows
        the matcher table, and names no table scores match nothing."""
        if self.mode == "package":
            return self._prepare_package_batch(contents, filenames, preset)
        B = len(contents)
        W = self.corpus.n_lanes
        bits = np.zeros((B, W), dtype=np.uint32)
        n_words = np.zeros(B, dtype=np.int32)
        lengths = np.zeros(B, dtype=np.int32)
        cc_fp = np.zeros(B, dtype=bool)
        results: list[BlobResult | None] = (
            list(preset) if preset is not None else [None] * B
        )
        # per-row HTML gate: cleared for readme rows once the conversion
        # before the extraction has happened, so no blob converts twice
        html = [
            self._is_html(filenames[i] if filenames else None)
            for i in range(B)
        ]
        readme_sel: list[bool] | None = None
        if self.mode == "readme":
            readme_sel = [True] * B
        elif self.mode == "auto":
            if routes is None:
                routes = [
                    self.route_for(filenames[i] if filenames else None)
                    for i in range(B)
                ]
            readme_sel = [r == "readme" for r in routes]
            for i, route in enumerate(routes):
                if results[i] is not None:
                    continue
                if route == "package":
                    results[i] = self._package_match_one(
                        contents[i], filenames[i] if filenames else None
                    )
                elif route is None:
                    # no table scores this filename: the reference never
                    # builds a project file for it (project.rb:111-117)
                    results[i] = BlobResult(None, None, 0.0)
        sections: list | None = None
        if readme_sel is not None and any(readme_sel):
            sections = [None] * B
            for i, raw in enumerate(contents):
                if results[i] is not None or not readme_sel[i]:
                    continue  # preset (dedupe) rows and other routes
                try:
                    section = _readme_section(raw, html[i])
                    html[i] = False  # the section is markdown from here on
                except Exception as exc:  # noqa: BLE001 — per-blob containment
                    results[i] = BlobResult(
                        None, None, 0.0, error=f"featurize_error: {exc}"
                    )
                    continue
                if section is None:
                    # no license section: the project never builds a
                    # ReadmeFile at all (project.rb:76-78)
                    results[i] = BlobResult(None, None, 0.0)
                else:
                    sections[i] = section
            # readme rows go on with their section (or nothing); license
            # rows keep their raw content
            contents = [
                (sections[i] if sections[i] is not None else "")
                if readme_sel[i]
                else contents[i]
                for i in range(B)
            ]
        # Whole-batch native fast path: every non-HTML blob goes through
        # ONE ctypes crossing (newline fix + strip + featurize in C++,
        # GIL dropped for the whole batch).  Rows the native side cannot
        # take (non-ASCII, PCRE2 resource limits) come back with a
        # non-zero status and fall through to the per-blob paths below.
        done = bytearray(B)
        if self._nat is not None:
            fast: list[int] = []
            fast_bytes: list[bytes] = []
            for i in range(B):
                if results[i] is not None or html[i]:
                    continue
                raw = contents[i]
                if isinstance(raw, str):
                    # errors="ignore" drops lone surrogates exactly like
                    # sanitize_content's round-trip
                    raw = raw.encode("utf-8", errors="ignore")
                elif not isinstance(raw, bytes):
                    continue
                fast.append(i)
                fast_bytes.append(raw)
            if fast:
                # token bits land zero-copy in the final batch rows: a
                # full batch writes row i directly, a sparse subset
                # (preset/dedupe rows interleaved) goes through the
                # native row map
                rows = None if len(fast) == B else np.asarray(fast, np.int64)
                meta = np.zeros((len(fast), 3), dtype=np.int32)
                hashes = np.zeros((len(fast), 16), dtype=np.uint8)
                try:
                    status = self._nat.featurize_batch(
                        self._nat_vocab, fast_bytes, bits, meta, hashes,
                        rows=rows,
                    )
                except Exception:  # noqa: BLE001 — whole-batch containment
                    # the per-blob loop below redoes every row with its
                    # own per-blob error containment
                    status = np.full(len(fast), 3, dtype=np.int8)
                    bits[fast] = 0
                for j, i in enumerate(fast):
                    if status[j] != 0:
                        bits[i] = 0  # failed-over row: wiped for Python
                        continue
                    done[i] = 1
                    flags = int(meta[j, 2])
                    if prefilter and flags & 1:
                        results[i] = BlobResult("no-license", "copyright", 100.0)
                        continue
                    h = hashes[j].tobytes()
                    if prefilter and h in self._exact_hashes:
                        key = self._confirm_exact(h, bits[i], int(meta[j, 0]))
                        if key is not None:
                            results[i] = BlobResult(key, "exact", 100.0)
                            continue
                    n_words[i] = meta[j, 0]
                    lengths[i] = meta[j, 1]
                    cc_fp[i] = bool(flags & 2)

        for i, raw in enumerate(contents):
            if results[i] is not None or done[i]:
                continue
            try:
                if self._nat is not None:
                    try:
                        self._prepare_one_native(
                            raw, results, bits, n_words, lengths, cc_fp, i,
                            prefilter=prefilter, html=html[i],
                        )
                    except native_pipeline.NativeResourceError:
                        # PCRE2 hit a match/depth limit on this blob;
                        # Python re has none, so redo just this blob on
                        # the pure-Python pipeline (same answer, slower)
                        self._prepare_one_python(
                            raw, results, bits, n_words, lengths, cc_fp, i,
                            prefilter=prefilter, html=html[i],
                        )
                else:
                    self._prepare_one_python(
                        raw, results, bits, n_words, lengths, cc_fp, i,
                        prefilter=prefilter, html=html[i],
                    )
            except Exception as exc:  # noqa: BLE001 — per-blob containment
                results[i] = BlobResult(
                    None, None, 0.0, error=f"featurize_error: {exc}"
                )
                bits[i] = 0
                n_words[i] = 0
                lengths[i] = 0
                cc_fp[i] = False
        todo = [i for i, r in enumerate(results) if r is None]
        return PreparedBatch(
            results, bits, n_words, lengths, cc_fp, todo, sections
        )

    def _prepare_package_batch(
        self, contents, filenames, preset=None
    ) -> PreparedBatch:
        """Package-manifest mode: the whole chain is host regexes.  Each
        blob runs the filename-dispatched matcher table of
        package_manager_file.rb and reports the declared license
        (``other`` for a declared but unknown value, no match when no
        matcher claims the filename)."""
        B = len(contents)
        results: list[BlobResult | None] = (
            list(preset) if preset is not None else [None] * B
        )
        for i, raw in enumerate(contents):
            if results[i] is None:
                results[i] = self._package_match_one(
                    raw, filenames[i] if filenames else None
                )
        zeros = np.zeros(B, dtype=np.int32)
        return PreparedBatch(
            results, np.zeros((B, 0), dtype=np.uint32), zeros, zeros,
            np.zeros(B, dtype=bool), [],
        )

    @staticmethod
    def _package_match_one(raw, filename: str | None) -> BlobResult:
        """One blob through the filename-dispatched package matcher
        table, with per-blob error containment."""
        try:
            matcher = PackageManagerFile(raw, filename).matcher
            lic = matcher.match if matcher is not None else None
            if matcher is not None and lic is not None:
                return BlobResult(
                    lic.key, matcher.name, float(matcher.confidence)
                )
            return BlobResult(None, None, 0.0)
        except Exception as exc:  # noqa: BLE001 — per-blob containment
            return BlobResult(
                None, None, 0.0, error=f"featurize_error: {exc}"
            )

    def attribution_for(
        self,
        raw,
        filename: str | None,
        result: BlobResult,
        route: str | None = None,
    ) -> str | None:
        """The copyright line of one matched blob, the batch twin of
        LicenseFile#attribution (license_file.rb:71-77): applicable when
        the Copyright matcher fired on a copyright(.ext) file or the
        matched license's template carries a [fullname] field; the line
        is the COPYRIGHT_REGEX hit on the stage-1 normalized content.
        Readme rows scan their License section; package rows have none;
        a custom corpus's key the vendored pool does not know has no
        template to prove a [fullname] field with, so None."""
        if result.key is None or result.error:
            return None
        route = route or self.mode
        if route not in ("license", "readme"):
            return None
        applicable = False
        if result.matcher == "copyright" and filename is not None:
            applicable = bool(COPYRIGHT_NAME_REGEX.search(filename))
        if not applicable and not _has_fullname(result.key):
            return None
        if route == "readme":
            html = self._is_html(filename)
            content = _readme_section(raw, html)
            if content is None:
                return None
            if html:
                filename = None  # the gate is consumed, as in prepare_batch
        else:
            content = sanitize_content(raw) if raw is not None else ""
        blob = NormalizedBlob(content, filename=filename)
        m = COPYRIGHT_REGEX.search(blob.content_without_title_and_version)
        return m.group(0) if m else None

    @staticmethod
    def route_for(filename: str | None) -> str | None:
        """The chain ``--mode auto`` runs a file through, by the
        reference's filename score tables (project.rb:111-117 over
        LicenseFile.name_score, PackageManagerFile.name_score and
        ReadmeFile.name_score): the top score wins, ties prefer license >
        package > readme, and a name no table scores is never read."""
        if not filename:
            return None
        score, route = max(
            (LicenseFile.name_score(filename), "license"),
            (PackageManagerFile.name_score(filename), "package"),
            (ReadmeFile.name_score(filename), "readme"),
            key=lambda t: t[0],
        )
        return route if score > 0 else None

    def _prepare_one_python(
        self, raw, results, bits, n_words, lengths, cc_fp, i, prefilter=True,
        html=False,
    ) -> None:
        """The pure-Python twin of `_prepare_one_native`: the path where
        the native library is absent or failed this blob over.  ``html``
        is the per-row gate prepare_batch resolved; the sentinel name
        only re-arms NormalizedContent's own stage-ordered _strip_html."""
        t0 = time.perf_counter()
        try:
            blob = NormalizedBlob(raw, filename="x.html" if html else None)
            content = blob.content or ""
            if prefilter and COPYRIGHT_FULL_REGEX.search(ruby_strip(content)):
                results[i] = BlobResult("no-license", "copyright", 100.0)
                return
            if (prefilter and blob.wordset is not None
                    and blob.wordset in self._exact_map):
                results[i] = BlobResult(
                    self._exact_map[blob.wordset], "exact", 100.0
                )
                return
            bits[i], n_words[i], lengths[i] = self.corpus.file_features(blob)
            cc_fp[i] = bool(
                CC_FALSE_POSITIVE_REGEX.search(ruby_strip(content))
            )
        finally:
            # the native profile surface's rows, for the blobs this path
            # featurizes (`native_pipeline.profile_dump` merges them)
            native_pipeline.py_profile_add(**{
                "count.blobs": 1,
                "count.bytes_in": len(raw) if raw is not None else 0,
                "stage.normalize_s": time.perf_counter() - t0,
            })

    def _prepare_one_native(
        self, raw, results, bits, n_words, lengths, cc_fp, i, prefilter=True,
        html=False,
    ) -> None:
        """One blob the batch crossing could not take, on the per-blob
        native calls (raises NativeResourceError for the Python path)."""
        content = sanitize_content(raw) if raw is not None else ""
        if html:
            # the native PCRE2 pipeline has no HTML parser; convert here
            # so the stages see markdown, exactly like the scalar path
            from licensee_tpu_torch.normalize.html2md import html_to_markdown

            content = html_to_markdown(content)
        stripped = ruby_strip(content)
        feat = self._nat.featurize_raw(self._nat_vocab, stripped, bits[i])
        if feat is None:
            # non-ASCII: the downcase between the stages must be
            # full-Unicode, so it happens in Python (two crossings)
            s1, flags = self._nat.stage1(stripped)
            _, nw, ln, h = self._nat.featurize(
                self._nat_vocab, s1.lower(), bits[i]
            )
        else:
            _, nw, ln, flags, h = feat
        if prefilter and flags & 1:
            results[i] = BlobResult("no-license", "copyright", 100.0)
            return
        if prefilter and h in self._exact_hashes:
            # the 128-bit additive multiset hash only TRIGGERS the check;
            # the answer rests on a complete equality proof
            key = self._confirm_exact(h, bits[i], nw)
            if key is not None:
                results[i] = BlobResult(key, "exact", 100.0)
                return
        n_words[i] = nw
        lengths[i] = ln
        cc_fp[i] = bool(flags & 2)

    def _confirm_exact(self, h, blob_bits, nw) -> str | None:
        """Set-equality proof for an exact-hash hit, O(n_lanes) per blob.

        The compiler's vocab covers every template's FULL wordset
        (corpus/compiler.py), so for template T with word count c and
        in-vocab bit projection P: a blob with |wordset| == c and bit
        projection == P has exactly c in-vocab words forming T's set and
        c - c = 0 out-of-vocab words — i.e. wordset equality
        (matchers/exact.rb:6-13), whatever the hash.  The additive hash
        (collidable in principle) only picks the candidate template."""
        tpl_bits, tpl_count, key = self._exact_feats[h]
        if nw != tpl_count or not np.array_equal(blob_bits, tpl_bits):
            return None
        return key

    @staticmethod
    def _is_html(filename: str | None) -> bool:
        return bool(filename) and filename.lower().endswith((".html", ".htm"))

    # -- classification --

    def classify_blobs(
        self,
        contents: list[str | bytes],
        threshold: float | None = None,
        prefilter: bool = True,
        filenames: list[str | None] | None = None,
        routes: list | None = None,
    ) -> list[BlobResult]:
        # the default, never the facade's global: a caller that wants
        # that (the DiceXLA matcher) passes it
        threshold = (
            licensee_tpu_torch.CONFIDENCE_THRESHOLD
            if threshold is None
            else threshold
        )
        prepared = self.prepare_batch(
            contents, prefilter=prefilter, filenames=filenames, routes=routes
        )
        outs = self.dispatch_chunks(prepared)
        self.finish_chunks(prepared, outs, threshold)
        return prepared.results  # type: ignore[return-value]

    def dispatch_chunks_async(
        self, prepared: PreparedBatch, pad_to: int | None = None
    ) -> DeviceFuture:
        """Submit device scoring for the ``todo`` rows in chunks of
        ``pad_batch_to`` (or ``pad_to``), without blocking.

        Each chunk is copied into a staging slot (pinned host rows on a
        card, recycled through `_StagingRing`) and enqueued on the
        device's one dispatch stream: the copies to the card, the
        scorer, the copy of (idx, num, den) back into the slot and a
        CUDA event.  The returned :class:`DeviceFuture` resolves to the
        ``[(chunk, (idx, num, den)), ...]`` list ``finish_chunks``
        consumes; until then the card computes while the host featurizes
        the next chunks.  A shape's first dispatch blocks: it loads the
        kernel library (building it if stale) and allocates pinned
        memory.  On the CPU the plain scorers run at submit.

        ``pad_to`` sets the chunk capacity of this dispatch: the serve
        micro-batcher (`serve/scheduler.py`) gives each flush the smallest
        fitting bucket, so the staging slot and the dispatch stats'
        shapes are the bucket's.  The kernels still launch at the chunk's
        real row count (`dice_cuda.BestMatchScorer.submit`), never at the
        padded capacity."""
        if prepared.todo and self._scorer is None:
            raise RuntimeError(
                "a host-only classifier (device=None) cannot dispatch: "
                "featurize workers only prepare batches"
            )
        if pad_to is not None and pad_to < 1:
            raise ValueError(f"pad_to must be >= 1, got {pad_to!r}")
        todo = prepared.todo
        B = int(pad_to) if pad_to is not None else self.pad_batch_to
        if self.mesh is not None and B % self.mesh.shape["data"]:
            raise ValueError(
                f"pad_to={B} is not divisible by the mesh's data axis "
                f"({self.mesh.shape['data']})"
            )
        parts = []
        for start in range(0, len(todo), B):
            chunk = todo[start : start + B]
            # compacted batches store only the todo rows: row j <-> todo[j]
            rows = (
                slice(start, start + len(chunk)) if prepared.compact else chunk
            )
            t0 = time.perf_counter()
            # device lanes: whole chunks round-robin, each lane on its
            # own stream with its own staging
            scorer, ring = self._lanes[self._rr % len(self._lanes)]
            self._rr += 1
            slot = ring.acquire(B)
            n = slot.fill(
                prepared.bits[rows],
                prepared.n_words[rows],
                prepared.lengths[rows],
                prepared.cc_fp[rows],
            )
            done = scorer.submit(slot, n)
            self._note_dispatch(B, time.perf_counter() - t0)
            parts.append((chunk, slot, done))
        return DeviceFuture(parts, self._release_slot if parts else None)

    def _release_slot(self, slot) -> None:
        """Return a staging slot to its own lane's ring."""
        self._lanes[slot.lane][1].release(slot)

    def dispatch_chunks(self, prepared: PreparedBatch):
        """Submit and await in one call: the resolved host-numpy outs.
        For the one-shot path (`classify_blobs`); the pipeline keeps the
        future."""
        return self.dispatch_chunks_async(prepared).result()

    def _note_dispatch(self, B: int, dt: float) -> None:
        """Account one submit: set-up (the first dispatch of this chunk
        shape) against steady-state enqueue, in total and per shape."""
        with self._dispatch_lock:
            shape = self._shape_prof.setdefault(
                B,
                {
                    "compiles": 0, "compile_s": 0.0,
                    "dispatches": 0, "dispatch_s": 0.0,
                },
            )
            count, secs = (
                ("dispatches", "dispatch_s")
                if B in self._dispatched_shapes
                else ("compiles", "compile_s")
            )
            self._dispatched_shapes.add(B)
            for prof in (self._dispatch_prof, shape):
                prof[count] += 1
                prof[secs] += dt

    def dispatch_stats(self) -> dict:
        """The set-up against steady-state split of the device dispatches,
        under the JAX package's names: ``compiles``/``compile_s`` count
        each chunk shape's first dispatch (here: the kernel library's
        load, the first launch, the pinned staging allocation),
        ``dispatches``/``dispatch_s`` every later one; ``shapes`` the
        shapes dispatched and ``per_shape`` the same split per shape."""
        with self._dispatch_lock:
            out = dict(self._dispatch_prof)
            if self._scorer is not None:
                # the scorer's chain of kernels (top-1, or the top-k route
                # chosen by k; a mesh names its grid)
                out["scorer"] = self._scorer.route
                if len(self._lanes) > 1:
                    out["lanes"] = len(self._lanes)
            out["shapes"] = sorted(self._dispatched_shapes)
            out["per_shape"] = {
                b: {
                    k: (round(v, 6) if isinstance(v, float) else v)
                    for k, v in prof.items()
                }
                for b, prof in sorted(self._shape_prof.items())
            }
        return out

    def merge_prepared(self, group: list[PreparedBatch]) -> PreparedBatch:
        """Coalesce the ``todo`` rows of several prepared batches into ONE
        device batch (compact, row j <-> merged todo j); `scatter_merged`
        writes the finished results back.  Readme sections travel with
        their rows, so `finish_chunks` applies the Reference fallback and
        the closest trim to the merged batch as it would per batch."""
        if len(group) == 1 and not group[0].compact:
            return group[0]
        parts = [p for p in group if p.todo]
        bits_parts, nw_parts, ln_parts, cc_parts = [], [], [], []
        sections: list | None = (
            [] if any(p.sections is not None for p in parts) else None
        )
        for p in parts:
            n = len(p.todo)
            idx = slice(0, n) if p.compact else np.asarray(p.todo, np.int64)
            bits_parts.append(p.bits[idx])
            nw_parts.append(p.n_words[idx])
            ln_parts.append(p.lengths[idx])
            cc_parts.append(p.cc_fp[idx])
            if sections is not None:
                sections.extend(
                    p.sections[i] if p.sections is not None else None
                    for i in p.todo
                )
        total = sum(len(p.todo) for p in parts)
        W = self.corpus.n_lanes

        def cat(arrays, empty):
            return np.concatenate(arrays) if arrays else empty

        return PreparedBatch(
            results=[None] * total,
            bits=cat(bits_parts, np.zeros((0, W), np.uint32)),
            n_words=cat(nw_parts, np.zeros(0, np.int32)),
            lengths=cat(ln_parts, np.zeros(0, np.int32)),
            cc_fp=cat(cc_parts, np.zeros(0, bool)),
            todo=list(range(total)),
            sections=sections,
            compact=True,
        )

    @staticmethod
    def scatter_merged(group: list[PreparedBatch], merged: PreparedBatch):
        """Copy a merged batch's finished results back into the source
        batches' ``todo`` rows (inverse of merge_prepared's row order)."""
        if len(group) == 1 and merged is group[0]:
            return
        off = 0
        for p in group:
            for j, i in enumerate(p.todo):
                p.results[i] = merged.results[off + j]
            off += len(p.todo)

    def finish_chunks(self, prepared: PreparedBatch, outs, threshold) -> None:
        """Finish scores in float64 on the host — identical to Ruby's
        Float score (dice.rb:57-59) — and apply the threshold.  ``outs``
        may be the resolved list or a :class:`DeviceFuture`, whose await
        is then the synchronize.

        With ``closest`` each scored row gets its candidate list.  In the
        readme and auto modes a readme row the Dice pass left unmatched
        falls through to the Reference matcher (readme_file.rb:32-34): a
        license named by title or source URL in the section matches at
        confidence 90, and leaves the candidate list."""
        if isinstance(outs, DeviceFuture):
            outs = outs.result()
        results = prepared.results
        for chunk, out in outs:
            best_idx, best_num, best_den = (
                np.asarray(a)[: len(chunk)] for a in out[:3]
            )
            k_rows = None
            if len(out) == 6:  # closest=K: the top-k candidate columns
                k_idx, k_num, k_den = (
                    np.asarray(a)[: len(chunk)] for a in out[3:]
                )
                k_scores = np.where(
                    (k_num >= 0) & (k_den > 0), (k_num * 200.0) / k_den, -1.0
                )
                k_rows = (k_idx, k_scores)
            scores = np.where(best_den > 0, (best_num * 200.0) / best_den, 0.0)
            for j, i in enumerate(chunk):
                if best_num[j] >= 0 and scores[j] >= threshold:
                    results[i] = BlobResult(
                        self.corpus.keys[int(best_idx[j])],
                        "dice",
                        float(scores[j]),
                        int(best_num[j]),
                        int(best_den[j]),
                    )
                else:
                    results[i] = BlobResult(None, None, 0.0)
                if k_rows is not None:
                    results[i].closest = self._closest_list(
                        k_rows[0][j], k_rows[1][j], results[i].key
                    )
        if self.mode in ("readme", "auto") and prepared.sections is not None:
            for i, section in enumerate(prepared.sections):
                r = results[i]
                if section is None or r is None or r.key or r.error:
                    continue
                lic = self._reference_match(section)
                if lic is not None:
                    # the candidate list was built with no matched key;
                    # now that Reference names one, closest excludes it
                    # (the list is still untrimmed, so the row keeps K
                    # entries after the cut below)
                    kept = r.closest
                    if kept is not None:
                        kept = [(kk, c) for kk, c in kept if kk != lic.key]
                    results[i] = BlobResult(
                        lic.key, "reference", 90.0, closest=kept
                    )
        if self.closest:
            # trim only the rows this call scored (the fallback rows above
            # are among them): a preset row from the dedupe cache was
            # trimmed by the batch that made it, and a finished result is
            # never mutated again (cached objects alias many rows)
            for chunk, _ in outs:
                for i in chunk:
                    r = results[i]
                    if r is not None and r.closest is not None:
                        r.closest = r.closest[: self.closest]

    def _closest_list(self, idx_row, score_row, matched_key):
        """The top-k candidates as [(key, confidence), ...], sorted by
        float64 score (Python's stable sort: equal scores keep their
        exact rank order), without the matched key and the excluded
        (score < 0) entries.  Untrimmed (up to k entries):
        `finish_chunks` cuts it to ``closest`` after the readme fallback
        has had its chance to drop a late-matched key."""
        rows = [
            (self.corpus.keys[int(t)], float(s))
            for t, s in zip(idx_row, score_row)
            if s >= 0 and self.corpus.keys[int(t)] != matched_key
        ]
        rows.sort(key=lambda r: -r[1])
        return rows

    @staticmethod
    def _reference_match(section: str):
        """The Reference matcher over one extracted section
        (matchers/reference.rb:7-11): the first license IN POOL ORDER
        whose title/source regex hits anywhere in the section.

        One corpus-wide alternation scans the section (the reference's
        union trick, content_helper.rb:199-215).  The scan finds hits by
        position, while the chain is by pool order, and an early license
        whose only hit lies inside another alternative's span is shadowed
        in the scan; so the union gives a floor, the least pool index
        over its hits, and only the licenses below the floor re-run
        their own regex: the first hit wins, else the floor does.  The
        scan runs in PCRE2 (`refscan_resolve`, byte mode) where the
        native library is up; its answer is confirmed with the license's
        own Python regex, a divergence falls back to the sequential
        chain, and a PCRE2 resource failure (-2) to the Python scan."""
        lics, union = _reference_union()

        def exact_chain():
            for lic in lics:
                if lic.reference_regex.search(section):
                    return lic
            return None

        nat = _refscan_native()
        if nat is not None:
            f = nat[0].refscan_resolve(nat[1], section)
            if f == -1:
                return None
            if f >= 0:
                if lics[f].reference_regex.search(section):
                    return lics[f]
                return exact_chain()
        floor = None
        for m in union.finditer(section):
            # one alternative (named group) matches per hit; groupdict
            # keeps pattern (= pool) order
            i = next(
                int(name[1:])
                for name, val in m.groupdict().items()
                if val is not None
            )
            if floor is None or i < floor:
                floor = i
            if floor == 0:
                break
        if floor is None:
            return None
        if not lics[floor].reference_regex.search(section):
            return exact_chain()
        for i in range(floor):
            if lics[i].reference_regex.search(section):
                return lics[i]
        return lics[floor]
