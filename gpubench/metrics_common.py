"""Arithmetic the per-layer readers in ``metrics/`` share."""

from __future__ import annotations


def counter(snap: dict, name: str) -> float:
    """A counter of a window-end snapshot."""
    return float(snap.get(name, 0))


def stage_ms_per_krow(w: dict, stages: tuple):
    """Host milliseconds of ``stages`` (`BatchStats.stage_seconds`) per
    thousand rows of the window."""
    if "stage_seconds" not in w.get("open", {}) or not w.get("rows"):
        return None
    s0, s1 = w["open"]["stage_seconds"], w["close"]["stage_seconds"]
    secs = sum(s1.get(s, 0.0) - s0.get(s, 0.0) for s in stages)
    return secs * 1e3 / (w["rows"] / 1e3)


def roofline_pct(w: dict, rows_key: str, launches_key: str):
    """100 x the least time of the traced scoring launches over their
    kernel time; None where the window launched none."""
    from gpubench.device import score_least_s

    tr = w.get("trace")
    if tr is None:
        return None
    launches, kernel_s = tr.score_kernels()
    d_rows = counter(w["close"], rows_key) - counter(w["open"], rows_key)
    d_launch = (counter(w["close"], launches_key)
                - counter(w["open"], launches_key))
    if not launches or kernel_s <= 0 or d_launch <= 0:
        return None
    rows = launches * d_rows / d_launch
    least = score_least_s(rows, launches, w["templates"], w["lanes"],
                          w["sm_clocks"])
    return 100.0 * least / kernel_s


def idle_pct(w: dict):
    tr = w.get("trace")
    if tr is None or not w.get("trace_s"):
        return None
    return 100.0 * (1.0 - tr.busy_s() / w["trace_s"])
