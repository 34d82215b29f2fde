"""Package-manager manifests (package.json, *.gemspec, Cargo.toml, ...).

Parity target: `lib/licensee/project_files/package_manager_file.rb`, as
`licensee_tpu/project_files/package_manager_file.py` carries it: the
filename-dispatched matcher table and the filename scores.
"""

from __future__ import annotations

import os

from licensee_tpu_torch.project_files.project_file import ProjectFile


class PackageManagerFile(ProjectFile):
    @property
    def possible_matchers(self) -> list:
        from licensee_tpu_torch import matchers

        ext_map = {
            ".gemspec": [matchers.Gemspec],
            ".json": [matchers.NpmBower],
            ".cabal": [matchers.Cabal],
            ".nuspec": [matchers.NuGet],
        }
        name_map = {
            "DESCRIPTION": [matchers.Cran],
            "dist.ini": [matchers.DistZilla],
            "LICENSE.spdx": [matchers.Spdx],
            "Cargo.toml": [matchers.Cargo],
        }
        ext = os.path.splitext(self.filename or "")[1]
        return ext_map.get(ext) or name_map.get(self.filename) or []

    FILENAMES_SCORES = {
        "package.json": 1.0,
        "LICENSE.spdx": 1.0,
        "Cargo.toml": 1.0,
        "DESCRIPTION": 0.9,
        "dist.ini": 0.8,
        "bower.json": 0.75,
        "elm-package.json": 0.7,
    }

    @staticmethod
    def name_score(filename: str) -> float:
        if os.path.splitext(filename)[1] in (".gemspec", ".cabal", ".nuspec"):
            return 1.0
        return PackageManagerFile.FILENAMES_SCORES.get(filename, 0.0)
