"""Host milliseconds of the ingest read (the produce lane's reads,
`serve/featurize.py:read_capped`) per thousand rows of the window,
summed over the worker threads: `BatchStats.stage_seconds["read"]`."""


def read(w: dict):
    from gpubench.metrics_common import stage_ms_per_krow

    return stage_ms_per_krow(w, ("read",))
