"""K5: the batch scorer sharded over a (data, model) grid of devices.

The port's counterpart of `licensee_tpu/parallel/mesh.py`
(`make_sharded_scorer`, a `shard_map` with a `psum` over the model
axis).  Like the JAX mesh, the port's is one process over its local
devices: a ``(data, model)`` grid of ``torch.device`` s, which may
repeat a device (a mesh on the CPU, or several shards on one card).

* **data axis**: the blob batch is split over the grid's rows, in
  contiguous shards (the last one may be shorter), and each row scores
  its shard against the whole corpus with the single-device scorer the
  batch path runs (`dice_cuda.BestMatchScorer`: K1 `best_match_fused`,
  or `topk_fused` for ``--closest``; K2 and the exact algebra for
  ``matmul``).  The data axis has no collective.
* **model axis**: the packed lanes of the corpus and of the blob bits
  are split over a row's columns.  K1 fuses the score algebra and
  returns no raw overlaps, so each model shard counts its partial
  overlaps with K2 `overlap_pairs_mma` over its lane slice; the
  partials of a row are summed on the row's first device (a copy and an
  add: what ``lax.psum`` does on one host), and the exact algebra and
  the first-max (or `topk_exact`) finish the sum as they do after K2.
  K1 and K2 take W only as a multiple of 4, so each lane slice is
  padded with zero lanes, which add nothing to a popcount: the triples
  stay exact.  The JAX mesh splits the lanes with ``shard_map``, which
  refuses a lane count the model axis does not divide; so does this
  one.

Each shard's kernel launches on its device's current stream; a failed
launch raises, and no shard is scored on the host in its place.
"""

from __future__ import annotations

import dataclasses

import torch

from licensee_tpu_torch.kernels import dice_cuda, dice_ref
from licensee_tpu_torch.kernels.dice_ref import CorpusTensors

__all__ = [
    "DeviceMesh",
    "MeshScorer",
    "build_mesh",
    "make_sharded_scorer",
    "shard_batch",
    "visible_devices",
]

METHODS = ("popcount", "matmul")


class DeviceMesh:
    """A ``(data, model)`` grid of devices; ``shape`` maps each axis to
    its size, as a JAX mesh's does."""

    def __init__(self, grid):
        grid = [[torch.device(d) for d in row] for row in grid]
        if not grid or not grid[0] or any(len(r) != len(grid[0]) for r in grid):
            raise ValueError("a mesh needs a non-empty rectangular grid")
        self.grid = grid
        self.shape = {"data": len(grid), "model": len(grid[0])}

    @property
    def devices(self) -> list:
        return [d for row in self.grid for d in row]


def visible_devices(kind: str = "cuda") -> list:
    """The devices a mesh or device lanes take by default: every visible
    card, or the one CPU device."""
    if kind == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def build_mesh(n_data: int | None = None, n_model: int = 1,
               devices=None) -> DeviceMesh:
    """A ``(data, model)`` mesh over ``devices`` (default: the visible
    cards), row-major as the JAX package lays it out."""
    devices = list(devices) if devices is not None else visible_devices()
    if n_data is None:
        n_data = len(devices) // n_model
    if n_data < 1 or n_model < 1:
        raise ValueError(
            f"mesh axes must be positive, got ({n_data}, {n_model})"
        )
    need = n_data * n_model
    if need > len(devices):
        raise ValueError(
            f"a ({n_data}, {n_model}) mesh needs {need} devices but only "
            f"{len(devices)} are visible"
        )
    return DeviceMesh([devices[r * n_model:(r + 1) * n_model]
                       for r in range(n_data)])


def shard_batch(mesh: DeviceMesh, *arrays):
    """Split per-blob tensors over the data axis: one tuple per row of
    the mesh, in contiguous shards on the row's first device (the last
    shard is the short one where the rows do not divide the batch)."""
    n = mesh.shape["data"]
    pieces = [torch.tensor_split(torch.as_tensor(a), n) for a in arrays]
    return [
        tuple(p[r].to(mesh.grid[r][0]) for p in pieces) for r in range(n)
    ]


def _pad_lanes(bits: torch.Tensor, width: int) -> torch.Tensor:
    """``bits`` with zero lanes appended up to ``width`` (contiguous)."""
    if bits.shape[1] == width:
        return bits.contiguous()
    out = bits.new_zeros((bits.shape[0], width))
    out[:, : bits.shape[1]] = bits
    return out


class _DataRow:
    """One row of the mesh: its first device's corpus constants and
    either the single-device scorer (one model shard) or the unpacked
    template slice of each model shard."""

    def __init__(self, ct: CorpusTensors, row, method: str, k: int):
        self.device = row[0]
        self.ct = _to(ct, self.device)
        self.k = k
        n_model = len(row)
        if n_model == 1:
            # the scorer the unsharded batch path runs, on this device
            self.best = dice_cuda.BestMatchScorer(self.ct, method, k)._best
            self.slices = None
            return
        W = ct.bits.shape[1]
        self.lanes = W // n_model
        # each slice padded to whole 4-word stages, which K1 and K2 take
        self.width = dice_cuda._round_up(self.lanes, dice_cuda.MMA_STAGE_WORDS)
        self.slices = []
        for m, dev in enumerate(row):
            part = ct.bits[:, m * self.lanes:(m + 1) * self.lanes]
            tpl = dataclasses.replace(
                ct, bits=_pad_lanes(part, self.width).to(dev)
            )
            self.slices.append((dev, dice_cuda.pack_templates_mma(tpl)))

    def __call__(self, fb, nw, ln, cf):
        if self.slices is None:
            return self.best(fb, nw, ln, cf)
        T = self.ct.n_templates
        overlap = None
        for m, (dev, tpl) in enumerate(self.slices):
            part = fb[:, m * self.lanes:(m + 1) * self.lanes]
            partial = dice_cuda.overlap_pairs_mma(
                tpl, _pad_lanes(part, self.width).to(dev), T
            )
            # the model axis's sum, on the row's first device
            partial = partial.to(self.device)
            overlap = partial if overlap is None else overlap + partial
        num, den = dice_ref.finish_scores(self.ct, overlap, nw, ln, cf)
        if not self.k:
            return dice_ref.argmax_exact(num, den)
        return dice_cuda.topk_exact(num, den, self.k)


def _to(ct: CorpusTensors, device) -> CorpusTensors:
    return CorpusTensors(
        **{f.name: getattr(ct, f.name).to(device)
           for f in dataclasses.fields(CorpusTensors)}
    )


def make_sharded_scorer(corpus: CorpusTensors, mesh: DeviceMesh,
                        method: str = "popcount", topk: int = 0):
    """A scorer over ``mesh``: ``fn(file_bits, n_words, lengths, cc_fp)``
    on tensors (int32 bits[B, W], int32[B], int32[B], bool[B]) gives the
    exact top-1 (idx, num, den) int32[B], and with ``topk`` > 0 then the
    top-k (idx, num, den) int32[B, topk] columns, as the JAX package's
    sharded scorer does, on the mesh's first device.

    With one model shard each data row runs the unsharded batch path's
    scorer (`BestMatchScorer`); with several, each shard's partial
    overlaps come from K2 over its lane slice and are summed on the
    row's first device before the exact algebra and the first-max (or
    `topk_exact`)."""
    if method not in METHODS:
        raise ValueError(f"unknown scoring method: {method!r}")
    n_model = mesh.shape["model"]
    W = corpus.bits.shape[1]
    if W % n_model:
        raise ValueError(
            f"the model axis ({n_model}) must divide the corpus's {W} "
            "packed lanes"
        )
    k = int(topk)
    rows = [_DataRow(corpus, row, method, k) for row in mesh.grid]
    first = mesh.grid[0][0]

    def run(file_bits, n_words, lengths, cc_fp):
        outs = [
            rows[r](*shard)
            for r, shard in enumerate(
                shard_batch(mesh, file_bits, n_words, lengths, cc_fp)
            )
        ]
        if first.type == "cuda":
            dice_cuda._count("make_sharded_scorer")
        cols = [
            torch.cat([o[c].to(first) for o in outs])
            for c in range(len(outs[0]))
        ]
        if not k:
            return tuple(cols)
        # the top-k's column 0 is the first-max
        return (*(c[:, 0] for c in cols), *cols)

    run.route = (
        f"K5 mesh {mesh.shape['data']}x{n_model} over "
        + ("K2 lane slices" if n_model > 1 else
           ("K1" if method == "popcount" else "K2"))
        + (f", top-k (k={k})" if k else "")
    )
    return run


class MeshScorer:
    """`dice_cuda.BestMatchScorer`'s interface over a mesh, for the batch
    path's dispatch (`BatchClassifier.dispatch_chunks_async`): staged
    rows go to the mesh's first device on its dispatch stream, the
    sharded scorer runs, and the top-1 (or the top-k columns) come back
    into the slot behind a CUDA event."""

    def __init__(self, corpus: CorpusTensors, mesh: DeviceMesh,
                 method: str, k: int = 0):
        self.mesh = mesh
        self.k = int(k)
        self.device = mesh.grid[0][0]
        self.n_lanes = corpus.bits.shape[1]
        self._fn = make_sharded_scorer(corpus, mesh, method, self.k)
        self.route = self._fn.route
        self.stream = (
            dice_cuda.dispatch_stream(self.device.index)
            if self.device.type == "cuda" else None
        )
        if self.stream is not None:
            for dev in {d for d in mesh.devices if d.type == "cuda"}:
                self.stream.wait_stream(torch.cuda.current_stream(dev))

    def host_rows(self, capacity: int, lane: int = 0):
        return dice_cuda.HostRows(capacity, self.n_lanes,
                                  pin=self.device.type == "cuda", k=self.k,
                                  lane=lane)

    def _candidates(self, fb, nw, ln, cf):
        out = self._fn(fb, nw, ln, cf)
        return torch.stack(out[3:] if self.k else out)

    def submit(self, rows, n: int):
        fb, nw, ln, cf = (t[:n] for t in rows.tensors[:4])
        out = rows.tensors[4][: 3 * n * max(self.k, 1)]
        if self.stream is None:
            out.copy_(self._candidates(fb, nw, ln, cf).view(-1))
            return None
        with torch.cuda.stream(self.stream):
            dev = self.device
            best = self._candidates(
                *(t.to(dev, non_blocking=True) for t in (fb, nw, ln, cf)))
            out.copy_(best.view(-1), non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        return done
