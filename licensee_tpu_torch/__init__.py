"""licensee-tpu's PyTorch/CUDA port.

A second package beside `licensee_tpu`, held against it as the
reference: the same verdicts from the same inputs, with the device
half in PyTorch and the Dice scoring kernels hand-written in CUDA C++
for Hopper (`kernels/dice_cuda.py`, `csrc/`).  It imports neither JAX,
PyYAML nor anything of `licensee_tpu`.  Entry points run on the CUDA
device unless the caller asks for the CPU.

The facade of the reference's `lib/licensee.rb`: the global confidence
threshold (which `detect` and the per-file matchers read; `batch-detect`
passes its own threshold explicitly), `licenses`, `project` and
`license`.
"""

from __future__ import annotations

__version__ = "1.0.0"

# Over which percent a match is considered a match by default
# (reference: lib/licensee.rb:21)
CONFIDENCE_THRESHOLD = 98

DOMAIN = "http://choosealicense.com"

_confidence_threshold: float | None = None


def confidence_threshold() -> float:
    return CONFIDENCE_THRESHOLD if _confidence_threshold is None else _confidence_threshold


def set_confidence_threshold(value: float) -> None:
    global _confidence_threshold
    _confidence_threshold = value


def inverse_confidence_threshold() -> float:
    # reference: lib/licensee.rb:58-61
    return round(1 - (confidence_threshold() / 100.0), 2)


def licenses(**options):
    from licensee_tpu_torch.corpus.license import License

    return License.all(**options)


def project(path: str, **args):
    """Build the right project backend for a path/URL
    (reference: lib/licensee.rb:37-45)."""
    import re as _re

    from licensee_tpu_torch.projects import FSProject, GitHubProject, GitProject
    from licensee_tpu_torch.projects.git_project import InvalidRepository

    if _re.match(r"\Ahttps://github.com", path):
        return GitHubProject(path, **args)
    try:
        return GitProject(path, **args)
    except InvalidRepository:
        return FSProject(path, **args)


def license(path: str):
    return project(path).license
