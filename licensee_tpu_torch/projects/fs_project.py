"""Filesystem project backend.

Parity target: `lib/licensee/projects/fs_project.rb` — a directory (glob
`*`) or single file, with an optional ``search_root`` that widens the
search to every directory between the project dir and the root.
"""

from __future__ import annotations

import glob
import os

from licensee_tpu_torch.projects.project import Project


class FSProject(Project):
    def __init__(self, path: str, search_root: str | None = None, **args):
        if os.path.isfile(path):
            self.pattern = os.path.basename(path)
            self.dir = os.path.abspath(os.path.dirname(path))
        else:
            self.pattern = "*"
            self.dir = os.path.abspath(path)

        self.root = os.path.abspath(search_root or self.dir)
        if not self._valid_search_root():
            raise ValueError(
                "Search root must be the project path directory or its ancestor"
            )
        super().__init__(**args)

    def files(self) -> list[dict]:
        cached = self.__dict__.get("_files")
        if cached is None:
            cached = []
            for directory in self._search_directories():
                relative_dir = os.path.relpath(directory, self.dir)
                pattern = os.path.join(glob.escape(directory), self.pattern)
                for file in sorted(glob.glob(pattern)):
                    if os.path.isfile(file):
                        cached.append(
                            {"name": os.path.basename(file), "dir": relative_dir}
                        )
            self.__dict__["_files"] = cached
        return cached

    def load_file(self, file: dict) -> str:
        path = os.path.join(self.dir, file["dir"], file["name"])
        with open(path, "rb") as f:
            raw = f.read()
        return raw.decode("utf-8", errors="ignore")

    def _valid_search_root(self) -> bool:
        # fs_project.rb:60-63: root is dir itself or an ancestor
        return self.dir == self.root or self.dir.startswith(self.root + os.sep)

    def _search_directories(self) -> list[str]:
        """All directories from self.dir up to self.root, inclusive
        (fs_project.rb:66-81)."""
        dirs = []
        current = self.dir
        while True:
            dirs.append(current)
            if current == self.root:
                break
            parent = os.path.dirname(current)
            if parent == current:
                break
            current = parent
        if self.root not in dirs:
            dirs.append(self.root)
        return dirs
