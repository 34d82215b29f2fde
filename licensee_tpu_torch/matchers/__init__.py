"""The matchers the batch path's readme and package chains run.

The port's copy of `licensee_tpu/matchers/` for `batch-detect`: the
package-manifest matchers and the Reference matcher.  Copyright, Exact
and Dice run inside `BatchClassifier` as batched pre-filters and the
device scorer; the per-file matcher classes of `detect` wait for that
slice (ROADMAP A).
"""

from licensee_tpu_torch.matchers.base import Matcher
from licensee_tpu_torch.matchers.package import (
    Cabal,
    Cargo,
    Cran,
    DistZilla,
    Gemspec,
    NpmBower,
    NuGet,
    Package,
    Spdx,
)
from licensee_tpu_torch.matchers.reference_matcher import Reference

__all__ = [
    "Matcher",
    "Reference",
    "Package",
    "Gemspec",
    "NpmBower",
    "Cabal",
    "Cargo",
    "Cran",
    "DistZilla",
    "NuGet",
    "Spdx",
]
