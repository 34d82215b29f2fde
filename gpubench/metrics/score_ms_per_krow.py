"""Host milliseconds of device dispatch and finish
(`dispatch_chunks_async`, the await, `finish_chunks`) per thousand rows
of the window: `BatchStats.stage_seconds["dispatch"]` plus
`["score"]`."""


def read(w: dict):
    from gpubench.metrics_common import stage_ms_per_krow

    return stage_ms_per_krow(w, ("dispatch", "score"))
