"""Scale-out for the batch path: several devices in one process
(`mesh.py`, K5, and the device lanes of `kernels/batch.py`), several
processes on one host (`stripes.py`, sized by `autoscale.py`) and the
multi-process bootstrap (`distributed.py`).

The port's counterpart of `licensee_tpu/parallel/`.  This ``__init__``
imports nothing, so the stripe runner, which supervises and never
scores, loads no device code.
"""
