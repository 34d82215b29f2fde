"""The score step's share of its roofline in the batch cells: the summed
least time of the traced window's scoring launches over their summed
kernel time (`gpubench/device.py`)."""


def read(w: dict):
    from gpubench.metrics_common import roofline_pct

    return roofline_pct(w, "device_rows", "chunks")
