"""The multi-process bootstrap of batch classification.

The port's counterpart of `licensee_tpu/parallel/distributed.py`, with
the same environment contract.  The scoring has no cross-blob
communication: the mesh's data axis has no collective and the model
axis sums its partial overlaps inside one process (`parallel/mesh.py`).
So several processes, on one host or several, split the manifest:
each classifies a contiguous stripe and writes its own JSONL shard,
which resumes on its own.  Between processes only the bootstrap
handshake runs, through ``torch.distributed`` over gloo (no tensor
moves over it, so gloo serves beside a card too).

Environment contract (all three opt in):

* ``LICENSEE_TPU_COORDINATOR``   — ``host:port`` of process 0
* ``LICENSEE_TPU_NUM_PROCESSES`` — world size
* ``LICENSEE_TPU_PROCESS_ID``    — this process's rank

``LICENSEE_TPU_DISTRIBUTED=auto`` takes the rank and world size from
the ``torchrun`` variables (``MASTER_ADDR``/``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``) instead.

Co-located processes (one host, devices split per process) also set

* ``LICENSEE_TPU_VISIBLE_CHIPS`` — comma list of this process's devices

which ``apply_visible_chips`` translates, before CUDA initializes, into
``CUDA_VISIBLE_DEVICES``.
"""

from __future__ import annotations

import os

_initialized = False
_world: tuple[int, int] | None = None
_chips_applied: list[str] | None = None


def apply_visible_chips(env=None) -> list[str] | None:
    """Restrict this process to its device subset (idempotent).

    Reads ``LICENSEE_TPU_VISIBLE_CHIPS`` (e.g. ``"4,5"``) and exports
    ``CUDA_VISIBLE_DEVICES``, the visibility the CUDA runtime honours.
    It must run before CUDA initializes in this process (visibility
    cannot change after), and raises RuntimeError if it already has.
    A dict ``env`` is a child's environment or a dry run: it is read
    and written alone, never ``os.environ``.  Returns the device list,
    or None when the variable is unset."""
    global _chips_applied
    env = os.environ if env is None else env
    is_process_env = env is os.environ
    spec = env.get("LICENSEE_TPU_VISIBLE_CHIPS")
    if spec is None:
        return None
    chips = [c.strip() for c in spec.split(",") if c.strip()]
    if not chips:
        raise ValueError(
            f"LICENSEE_TPU_VISIBLE_CHIPS={spec!r}: no chip ids"
        )
    # the applied-state latch tracks the process environment only: a
    # dict-env dry run neither consumes it nor is blocked by it
    if is_process_env and _chips_applied is not None:
        if chips != _chips_applied:
            raise RuntimeError(
                f"LICENSEE_TPU_VISIBLE_CHIPS changed after apply: "
                f"{_chips_applied} -> {chips}"
            )
        return chips
    import sys

    if is_process_env and "torch" in sys.modules:
        torch = sys.modules["torch"]
        if torch.cuda.is_initialized():
            raise RuntimeError(
                "LICENSEE_TPU_VISIBLE_CHIPS set but CUDA is already "
                "initialized; set it before the first device use"
            )
    want = ",".join(chips)
    have = env.get("CUDA_VISIBLE_DEVICES")
    if have is not None and have != want:
        # a stale or wrapper-set value silently winning over the subset
        # asked for would leave co-located ranks on the same devices
        raise RuntimeError(
            f"CUDA_VISIBLE_DEVICES={have!r} conflicts with "
            f"LICENSEE_TPU_VISIBLE_CHIPS={spec!r}; unset one"
        )
    env["CUDA_VISIBLE_DEVICES"] = want
    if is_process_env:
        _chips_applied = chips
    return chips


def maybe_initialize(env=None) -> tuple[int, int]:
    """Join the ``torch.distributed`` world the environment names
    (idempotent): a blocking handshake with every process through the
    coordinator, over gloo.

    Returns ``(process_index, process_count)``, ``(0, 1)`` when no
    multi-process environment is set."""
    global _initialized, _world
    env = os.environ if env is None else env

    if not _initialized:
        apply_visible_chips(env)

    coord = env.get("LICENSEE_TPU_COORDINATOR")
    auto = env.get("LICENSEE_TPU_DISTRIBUTED") == "auto"
    if not coord and not auto:
        return 0, 1

    if not _initialized:
        import datetime

        import torch.distributed as dist

        if coord:
            rank = int(env["LICENSEE_TPU_PROCESS_ID"])
            world = int(env["LICENSEE_TPU_NUM_PROCESSES"])
            init_method = f"tcp://{coord}"
        else:
            rank = int(env["RANK"])
            world = int(env["WORLD_SIZE"])
            init_method = (
                f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
            )
        dist.init_process_group(
            "gloo",
            init_method=init_method,
            world_size=world,
            rank=rank,
            timeout=datetime.timedelta(seconds=300),
        )
        _world = (dist.get_rank(), dist.get_world_size())
        _initialized = True
    return _world


def chips_for_worker(
    worker_index: int, chips_per_worker: int
) -> list[str]:
    """The device-id subset of co-located worker ``worker_index`` when
    each worker owns ``chips_per_worker`` devices: the contiguous range
    ``[i*K, (i+1)*K)``, as the string ids ``LICENSEE_TPU_VISIBLE_CHIPS``
    takes."""
    if worker_index < 0:
        raise ValueError(f"worker_index must be >= 0, got {worker_index!r}")
    if chips_per_worker < 1:
        raise ValueError(
            f"chips_per_worker must be >= 1, got {chips_per_worker!r}"
        )
    lo = worker_index * chips_per_worker
    return [str(c) for c in range(lo, lo + chips_per_worker)]


def count_manifest_entries(manifest: str) -> int:
    """Non-blank line count: the stripes' denominator for a loose
    manifest, which the stripe runner and
    ``BatchProject.from_manifest_file`` both count with, so what an
    entry is never differs between them.  A container manifest stripes
    by its expanded count instead (`ingest/sources.py` ``expanded_layout``
    and ``ManifestExpansion.restrict``)."""
    n = 0
    with open(manifest, encoding="utf-8") as f:
        for line in f:
            if line.strip():
                n += 1
    return n


def manifest_stripe(n: int, process_index: int, process_count: int) -> tuple[int, int]:
    """[lo, hi) bounds of this process's contiguous manifest stripe.

    Contiguous, so each shard's resume invariant (line count ==
    completed prefix of the stripe) holds on its own; the remainder
    spreads one extra item over the first shards."""
    if not 0 <= process_index < process_count:
        raise ValueError(
            f"process_index {process_index} out of range for "
            f"process_count {process_count}"
        )
    base, rem = divmod(n, process_count)
    lo = process_index * base + min(process_index, rem)
    hi = lo + base + (1 if process_index < rem else 0)
    return lo, hi


def shard_output_path(output: str, process_index: int, process_count: int) -> str:
    """Per-process JSONL shard path (process 0 of 1 keeps the plain path)."""
    if process_count <= 1:
        return output
    return f"{output}.shard-{process_index:05d}-of-{process_count:05d}"
