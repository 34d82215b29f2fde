"""The share of the traced window in which no operation ran on the card
(kernels, copies, fills), in the process that runs `BatchProject`."""


def read(w: dict):
    from gpubench.metrics_common import idle_pct

    return idle_pct(w)
