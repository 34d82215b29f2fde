"""The async jobs tier: durable batch jobs through the HTTP edge.

The port's copy of `licensee_tpu/jobs/`.  The resume-safe striped batch
engine (parallel/stripes.py) meets the authenticated HTTP/1.1 edge
(fleet/http_edge.py) here: ``POST /jobs`` accepts a manifest (or an
uploaded archive routed through the ``ingest`` container grammar), a
durable append-only journal makes the submission crash-proof, and a
:class:`JobExecutor` drains accepted jobs through the StripeRunner the
CLI uses, resuming in-flight jobs from their stripe shards after a
SIGKILL.  Each stripe child is a `batch-detect` process on the
executor's ``device`` (the card unless ``"cpu"`` is asked for).

House rules: monotonic clocks only, no prints — job ordering is journal
order, progress surfaces through callbacks and the HTTP status verb.
"""

from __future__ import annotations

from licensee_tpu_torch.jobs.executor import (
    JOB_STATES,
    TERMINAL_STATES,
    Job,
    JobExecutor,
    validate_spec,
)
from licensee_tpu_torch.jobs.journal import JobJournal, JournalError

__all__ = [
    "JOB_STATES",
    "Job",
    "JobExecutor",
    "JobJournal",
    "JournalError",
    "TERMINAL_STATES",
    "validate_spec",
]
