"""Host milliseconds of featurize (`kernels/batch.py:prepare_batch`: the
prefilters and the native featurizer) per thousand rows of the window,
summed over the worker threads: `BatchStats.stage_seconds["featurize"]`."""


def read(w: dict):
    from gpubench.metrics_common import stage_ms_per_krow

    return stage_ms_per_krow(w, ("featurize",))
