"""Remote GitHub project backend via the contents API.

Parity target: `lib/licensee/projects/github_project.rb` (octokit).  Only
the repository root is scanned, because every file load is a separate API
request.  Tests stub the HTTP layer (the reference does the same with
WebMock) — no live network access is required for the suite.
"""

from __future__ import annotations

import json
import os
import re
import urllib.error
import urllib.parse
import urllib.request

from licensee_tpu_torch.projects.project import Project

# github_project.rb:19-20 — trailing data (e.g. `.git`) is ignored
GITHUB_REPO_PATTERN = re.compile(
    r"https://github.com/([^/]+/(?:[^/]+(?=\.git)|[^/]+)).*"
)

API_ROOT = "https://api.github.com"


class RepoNotFound(Exception):
    pass


class GitHubProject(Project):
    def __init__(self, github_url: str, ref: str | None = None, **args):
        m = GITHUB_REPO_PATTERN.match(github_url)
        if not m:
            raise ValueError(f"Not a github URL: {github_url}")
        self.repo = m.group(1)
        self.ref = ref
        super().__init__(**args)

    # -- HTTP layer (overridable in tests) --

    def _request(self, path: str, raw: bool = False):
        query = f"?ref={urllib.parse.quote(self.ref)}" if self.ref else ""
        url = f"{API_ROOT}/repos/{self.repo}/contents/{path or ''}{query}"
        headers = {"Accept": "application/vnd.github.v3.raw" if raw else "application/vnd.github.v3+json"}
        token = os.environ.get("OCTOKIT_ACCESS_TOKEN")
        if token:
            headers["Authorization"] = f"token {token}"
        req = urllib.request.Request(url, headers=headers)
        try:
            with urllib.request.urlopen(req) as resp:
                body = resp.read()
        except urllib.error.HTTPError as exc:
            if exc.code == 404:
                return None
            raise
        return body if raw else json.loads(body)

    # -- Project interface --

    def files(self) -> list[dict]:
        cached = self.__dict__.get("_files")
        if cached is None:
            cached = self._dir_files()
            if not cached:
                raise RepoNotFound(
                    f"Could not load GitHub repo {self.repo}, "
                    "it may be private or deleted"
                )
            self.__dict__["_files"] = cached
        return cached

    def load_file(self, file: dict):
        body = self._request(file["path"], raw=True)
        if body is None:
            # a listed file vanishing mid-detection is an API error, not an
            # empty license (github_project.rb:48-53 lets octokit raise)
            raise RepoNotFound(
                f"Could not load {file['path']} from GitHub repo {self.repo}"
            )
        return body

    def _dir_files(self, path: str | None = None) -> list[dict]:
        if path:
            path = path.replace("./", "")
        listing = self._request(path)
        if listing is None:
            return []
        files = [entry for entry in listing if entry.get("type") == "file"]
        for entry in files:
            entry["dir"] = os.path.dirname(entry["path"]) or "."
        return files
