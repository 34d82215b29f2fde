"""licensee-tpu's PyTorch/CUDA port.

A second package beside `licensee_tpu`, held against it as the
reference: the same verdicts from the same inputs, with the device
half in PyTorch and the Dice scoring kernels hand-written in CUDA C++
for Hopper (`kernels/dice_cuda.py`, `csrc/`).  It imports neither JAX,
PyYAML nor anything of `licensee_tpu`.  Entry points run on the CUDA
device unless the caller asks for the CPU.
"""

from __future__ import annotations

__version__ = "1.0.0"

# Over which percent a match is considered a match by default
# (reference: lib/licensee.rb:21)
CONFIDENCE_THRESHOLD = 98


def confidence_threshold() -> float:
    return CONFIDENCE_THRESHOLD
