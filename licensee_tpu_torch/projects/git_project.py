"""Git backends: read a revision's root tree without a checkout.

The port's counterpart of the backends of
`licensee_tpu/projects/git_project.py` (parity target: the reference's
`git_project.rb`, over rugged/libgit2): the native object-database
reader (`native/gitodb.py`) where it builds, git's plumbing commands
otherwise.  Blob loads are capped at ``MAX_LICENSE_SIZE`` bytes like the
reference's (git_project.rb:53): a blob past the cap is skipped, never
truncated and scored.  `GitProject` is `detect`'s project over a
repository's root tree; the batch path's git containers
(`ingest/sources.py`) read through the same backends.
"""

from __future__ import annotations

import os
import subprocess

from licensee_tpu_torch.projects.project import Project

MAX_LICENSE_SIZE = 64 * 1024


class InvalidRepository(ValueError):
    pass


def _run_git(repo: str, *args: str) -> bytes:
    result = subprocess.run(
        ["git", "-C", repo, *args],
        capture_output=True,
        check=False,
    )
    if result.returncode != 0:
        raise InvalidRepository(result.stderr.decode("utf-8", errors="ignore"))
    return result.stdout


class _NativeBackend:
    """git_project.rb's rugged calls, over the native ODB reader."""

    def __init__(self, repo: str, revision: str | None):
        from licensee_tpu_torch.native.gitodb import GitODB, GitODBError

        self._files: list[dict] | None = None
        self._odb = None
        try:
            self._odb = GitODB(repo)
            self._commit = self._odb.resolve(revision or "HEAD")
        except GitODBError as exc:
            self.close()  # do not leave the native handle to the GC
            raise InvalidRepository(str(exc)) from exc

    def close(self) -> None:
        if self._odb is not None:
            self._odb.close()
            self._odb = None

    def files(self) -> list[dict]:
        if self._files is None:
            from licensee_tpu_torch.native.gitodb import GitODBError

            try:
                entries = self._odb.root_entries(self._commit)
            except (GitODBError, ValueError) as exc:
                raise InvalidRepository(str(exc)) from exc
            # symlinks (mode 120000) are blob-backed and count as blobs,
            # as rugged's entry types and `git ls-tree` have them
            self._files = [
                {"name": e["name"], "oid": e["oid"], "dir": "."}
                for e in entries
                if e["type"] in ("blob", "link")
            ]
        return self._files

    def load_file(self, file: dict) -> bytes | None:
        from licensee_tpu_torch.native.gitodb import GitODBError

        try:
            # one byte past the cap tells an oversized blob without a
            # size probe; it is skipped (None), never truncated
            data = self._odb.read_blob(file["oid"], MAX_LICENSE_SIZE + 1)
        except GitODBError as exc:
            raise InvalidRepository(str(exc)) from exc
        return None if len(data) > MAX_LICENSE_SIZE else data


class _SubprocessBackend:
    """The plumbing fallback: `git rev-parse`, `ls-tree`, `cat-file`."""

    def __init__(self, repo: str, revision: str | None):
        self.repo = repo
        self.revision = revision
        try:
            # resolves only inside a repository; an unborn HEAD raises
            git_dir = _run_git(repo, "rev-parse", "--git-dir").strip()
            if not git_dir:
                raise InvalidRepository(repo)
            # refuse a repository found by upward discovery from a plain
            # directory: the reference opens the path itself.  A .git
            # FILE (a gitlink: linked worktrees, submodules) is a
            # repository at this path, and libgit2 follows it
            absolute_git_dir = os.path.abspath(
                os.path.join(repo, git_dir.decode("utf-8", errors="ignore"))
            )
            repo_abs = os.path.abspath(repo)
            if not (
                absolute_git_dir == repo_abs
                or os.path.dirname(absolute_git_dir) == repo_abs
                or os.path.isfile(os.path.join(repo, ".git"))
            ):
                raise InvalidRepository(repo)
            _run_git(repo, "rev-parse", "--verify", revision or "HEAD")
        except FileNotFoundError as exc:  # no git on this host
            raise InvalidRepository(str(exc)) from exc

    def close(self) -> None:
        pass

    def files(self) -> list[dict]:
        out = _run_git(self.repo, "ls-tree", self.revision or "HEAD")
        files = []
        for line in out.decode("utf-8", errors="ignore").splitlines():
            if not line:
                continue
            meta, name = line.split("\t", 1)
            _mode, otype, oid = meta.split()
            if otype == "blob":
                files.append({"name": name, "oid": oid, "dir": "."})
        return files

    def load_file(self, file: dict) -> bytes | None:
        data = _run_git(self.repo, "cat-file", "blob", file["oid"])
        # the native backend's skip-not-truncate cap
        return None if len(data) > MAX_LICENSE_SIZE else data


class GitProject(Project):
    def __init__(self, repo: str, revision: str | None = None, **args):
        self.repo_path = repo
        self.revision = revision

        if not os.path.isdir(repo):
            raise InvalidRepository(repo)

        self._backend = self._open_backend(repo, revision)
        super().__init__(**args)

    @staticmethod
    def _open_backend(repo: str, revision: str | None):
        """The native backend, probed by listing the root tree; git's
        plumbing where the library is unavailable or cannot serve this
        repository's layout (it then raises InvalidRepository itself if
        the path is no repository)."""
        from licensee_tpu_torch.native.gitodb import NativeUnavailable

        backend = None
        try:
            backend = _NativeBackend(repo, revision)
            backend.files()
            return backend
        except (NativeUnavailable, InvalidRepository):
            if backend is not None:
                backend.close()
            return _SubprocessBackend(repo, revision)

    def close(self) -> None:
        self._backend.close()

    def files(self) -> list[dict]:
        """Root-tree blob entries of the target commit
        (git_project.rb:64-76: only type == :blob, root level)."""
        cached = self.__dict__.get("_files")
        if cached is None:
            cached = self._backend.files()
            self.__dict__["_files"] = cached
        return cached

    def load_file(self, file: dict) -> bytes | None:
        """Blob bytes, or None for a blob past the MAX_LICENSE_SIZE
        cap (skipped, never truncated and scored: the Project layer
        drops skipped candidates)."""
        return self._backend.load_file(file)
