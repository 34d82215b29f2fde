"""Detection-strategy plugin registry.

Parity target: `lib/licensee/matchers.rb`, as `licensee_tpu/matchers/`
carries it: each matcher wraps a candidate file and reports (license,
confidence).  `detect` runs Copyright -> Exact -> Dice per file; the
batch path runs the same chain as batched pre-filters and the device
scorer inside `BatchClassifier`, and plugs into this registry as
``DiceXLA``.
"""

from licensee_tpu_torch.matchers.base import Matcher
from licensee_tpu_torch.matchers.copyright_matcher import Copyright
from licensee_tpu_torch.matchers.exact import Exact
from licensee_tpu_torch.matchers.dice import Dice
from licensee_tpu_torch.matchers.dice_xla_matcher import DiceXLA
from licensee_tpu_torch.matchers.reference_matcher import Reference
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

__all__ = [
    "Matcher",
    "Copyright",
    "Exact",
    "Dice",
    "DiceXLA",
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
