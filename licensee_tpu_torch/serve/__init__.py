"""Online serving subsystem: dynamic micro-batching over the device
scorer, with a content-hash result cache and explicit backpressure.

The port's copy of `licensee_tpu/serve/__init__.py`; the device scorer
is K1 on the card (`kernels/dice_cuda.py`).

The offline path (projects/batch_project.py) consumes a pre-built
manifest in strict order; this package is the long-running front end
that accepts requests AS THEY ARRIVE, runs the host prefilter chain at
admission, coalesces Dice-bound blobs into bucket-sized device
batches (each bucket's staging is set up once and reused), and answers
with bounded latency:

  serve.featurize   — the shared featurize/prefilter core (also used by
                      the offline pipeline, so the chains cannot drift)
  serve.cache       — content-hash LRU result cache (hits/misses/
                      evictions)
  serve.stats       — bounded-reservoir latency percentiles per stage
  serve.scheduler   — request queue + micro-batcher: max_batch /
                      max_delay_ms flush, bucket padding, per-request
                      deadlines, queue-full rejection with retry_after,
                      host scalar Dice fallback on device failure
  serve.server      — newline-delimited-JSON transport over stdio and a
                      Unix domain socket, plus the `stats`/`trace`/
                      `reload` control verbs (the `licensee-tpu serve`
                      CLI command)
  serve.reload      — the corpus hot-swap machinery: build a
                      replacement classifier off-thread, validate it
                      (shape sanity + golden parity probe against the
                      device path), and only then let the scheduler
                      swap epochs

Imports are lazy (PEP 562): ``import licensee_tpu_torch.serve`` stays
cheap; the heavy classifier machinery loads only when a symbol is
touched.
"""

from __future__ import annotations

_EXPORTS = {
    "MicroBatcher": "licensee_tpu_torch.serve.scheduler",
    "QueueFullError": "licensee_tpu_torch.serve.scheduler",
    "ServeRequest": "licensee_tpu_torch.serve.scheduler",
    "ResultCache": "licensee_tpu_torch.serve.cache",
    "LatencyStats": "licensee_tpu_torch.serve.stats",
    "serve_stdio": "licensee_tpu_torch.serve.server",
    "serve_unix": "licensee_tpu_torch.serve.server",
    "selftest": "licensee_tpu_torch.serve.server",
    "selftest_reload": "licensee_tpu_torch.serve.server",
    "ReloadError": "licensee_tpu_torch.serve.reload",
    "ReloadInProgressError": "licensee_tpu_torch.serve.reload",
    "ReloadRejectedError": "licensee_tpu_torch.serve.reload",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        )
    import importlib

    return getattr(importlib.import_module(target), name)
