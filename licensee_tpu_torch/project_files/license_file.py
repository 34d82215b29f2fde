"""LICENSE-style file regexes the batch chain needs.

Parity target: `lib/licensee/project_files/license_file.rb`, as
`licensee_tpu/project_files/license_file.py` carries it.  This slice
takes the CC false-positive guard and the copyright? filename gate; the
filename score table and the `LicenseFile` matcher chain wait for the
`detect` slice and `--mode auto` (ROADMAP A).
"""

from __future__ import annotations

from licensee_tpu_torch.rubytext import rb

# license_file.rb:8-30 filename building block
OTHER_EXT_REGEX = r"\.(?!xml|go|gemspec)(?:[^./]|\.\d)+\Z"

# the copyright? filename test (project_file.rb:94): a COPYRIGHT(.ext)
# file — the batch attribution gate and the dedupe key use it
COPYRIGHT_NAME_REGEX = rb(
    r"\Acopyright(?:" + OTHER_EXT_REGEX + r")?\Z", i=True
)

# license_file.rb:61-65: CC-NC / CC-ND must not be detected as CC-BY(-SA)
CC_FALSE_POSITIVE_REGEX = rb(
    r"^(creative\ commons\ )?Attribution-(NonCommercial|NoDerivatives)", i=True, x=True
)
