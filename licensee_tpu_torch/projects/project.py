"""Abstract project: orchestrates candidate-file collection and detection.

Parity target: `lib/licensee/projects/project.rb` — single-license
resolution with the LGPL dual-file exception, filename scoring/sorting,
LGPL prioritization, and the license/readme/package file set.
"""

from __future__ import annotations

_UNSET = object()


class Project:
    def __init__(self, detect_packages: bool = False, detect_readme: bool = False, **_ignored):
        self.detect_packages = detect_packages
        self.detect_readme = detect_readme

    # -- detection results (project.rb:24-52) --

    @property
    def license(self):
        """The single detected license; `other` when multiple conflicting
        licenses match (with the LGPL dual-file exception)."""
        cached = self.__dict__.get("_license", _UNSET)
        if cached is _UNSET:
            from licensee_tpu_torch.corpus.license import License

            without = self.licenses_without_copyright
            if len(without) == 1 or self.is_lgpl:
                cached = without[0]
            elif len(without) > 1:
                cached = License.find("other")
            else:
                cached = None
            self.__dict__["_license"] = cached
        return cached

    @property
    def licenses(self) -> list:
        cached = self.__dict__.get("_licenses")
        if cached is None:
            cached = _uniq(f.license for f in self.matched_files)
            self.__dict__["_licenses"] = cached
        return cached

    @property
    def matched_file(self):
        if len(self.matched_files) == 1 or self.is_lgpl:
            return self.matched_files[0] if self.matched_files else None
        return None

    @property
    def matched_files(self) -> list:
        cached = self.__dict__.get("_matched_files")
        if cached is None:
            cached = [f for f in self.project_files if f.license]
            self.__dict__["_matched_files"] = cached
        return cached

    @property
    def license_file(self):
        if len(self.license_files) == 1 or self.is_lgpl:
            return self.license_files[0] if self.license_files else None
        return None

    @property
    def license_files(self) -> list:
        cached = self.__dict__.get("_license_files")
        if cached is None:
            from licensee_tpu_torch.project_files.license_file import LicenseFile

            files = self.files()
            if not files:
                cached = []
            else:
                found = self._find_files(LicenseFile.name_score)
                loaded = []
                for f in found:
                    content = self.load_file(f)
                    if content is None:
                        # a backend refusing a blob (the 64 KiB
                        # MAX_LICENSE_SIZE cap, git_project.py): the
                        # file is skipped outright, never scored on a
                        # truncated head
                        continue
                    loaded.append(LicenseFile(content, f))
                cached = self._prioritize_lgpl(loaded)
            self.__dict__["_license_files"] = cached
        return cached

    @property
    def readme_file(self):
        if not self.detect_readme:
            return None
        cached = self.__dict__.get("_readme", _UNSET)
        if cached is _UNSET:
            from licensee_tpu_torch.project_files.project_file import sanitize_content
            from licensee_tpu_torch.project_files.readme_file import ReadmeFile

            cached = None
            result = self._find_file(ReadmeFile.name_score)
            if result is not None:
                content, file = result
                if content is not None:
                    content = sanitize_content(content)
                content = ReadmeFile.license_content(content)
                if content and file:
                    cached = ReadmeFile(content, file)
            self.__dict__["_readme"] = cached
        return cached

    readme = readme_file

    @property
    def package_file(self):
        if not self.detect_packages:
            return None
        cached = self.__dict__.get("_package_file", _UNSET)
        if cached is _UNSET:
            from licensee_tpu_torch.project_files.package_manager_file import (
                PackageManagerFile,
            )

            cached = None
            result = self._find_file(PackageManagerFile.name_score)
            if result is not None:
                content, file = result
                if content is not None and file:
                    cached = PackageManagerFile(content, file)
            self.__dict__["_package_file"] = cached
        return cached

    # -- internals --

    @property
    def is_lgpl(self) -> bool:
        """LGPL lives in COPYING.lesser alongside a GPL COPYING
        (project.rb:102-106)."""
        if not (len(self.licenses) == 2 and len(self.license_files) == 2):
            return False
        return self.license_files[0].is_lgpl and self.license_files[1].is_gpl

    def _find_files(self, score_fn) -> list[dict]:
        files = self.files()
        if not files:
            return []
        found = []
        for file in files:
            score = score_fn(file["name"])
            if score > 0:
                found.append({**file, "score": score})
        # project.rb:111-117: sort by score descending (stable on input order)
        found.sort(key=lambda f: -f["score"])
        return found

    def _find_file(self, score_fn):
        found = self._find_files(score_fn)
        if not found:
            return None
        file = found[0]
        return (self.load_file(file), file)

    def _prioritize_lgpl(self, files: list) -> list:
        # project.rb:137-145
        if not files:
            return files
        first_license = files[0].license
        if not (first_license and first_license.gpl_q):
            return files
        lesser = next((i for i, f in enumerate(files) if f.is_lgpl), None)
        if lesser is not None:
            files.insert(0, files.pop(lesser))
        return files

    @property
    def project_files(self) -> list:
        cached = self.__dict__.get("_project_files")
        if cached is None:
            cached = list(self.license_files)
            if self.readme_file:
                cached.append(self.readme_file)
            if self.package_file:
                cached.append(self.package_file)
            self.__dict__["_project_files"] = cached
        return cached

    @property
    def licenses_without_copyright(self) -> list:
        """Matched licenses excluding COPYRIGHT-only files
        (project.rb:153-155)."""
        cached = self.__dict__.get("_licenses_without_copyright")
        if cached is None:
            cached = _uniq(
                f.license for f in self.matched_files if not f.is_copyright
            )
            self.__dict__["_licenses_without_copyright"] = cached
        return cached

    def files(self) -> list[dict]:
        raise NotImplementedError

    def load_file(self, file: dict):
        raise NotImplementedError

    def to_h(self) -> dict:
        # project.rb:16 HASH_METHODS
        return {
            "licenses": [lic.to_h() for lic in self.licenses],
            "matched_files": [f.to_h() for f in self.matched_files],
        }


def _uniq(iterable) -> list:
    out = []
    for item in iterable:
        if item not in out:
            out.append(item)
    return out
