"""A minimal HTTP/1.1 client for the jobs API: one keep-alive TCP
connection, sequential round trips, real status-line/Content-Length
parsing — stdlib only, shared by the port's ``jobs`` CLI verb and the
jobs selftest so both drive the edge exactly the way an external
submitter would.  The port's copy of `licensee_tpu/jobs/client.py`.
"""

from __future__ import annotations

import json
import time

__all__ = ["JobsClient", "JobsClientError"]


class JobsClientError(RuntimeError):
    """The edge answered something the verb cannot use (a non-2xx
    status, an unparsable body) or the connection failed."""


class JobsClient:
    """Sequential jobs-API client against one edge target.

    ``submit``/``status``/``cancel`` return the decoded JSON row;
    ``results``/``containers`` return raw bytes (the merged JSONL is
    a byte-identity contract — decoding it would be a lie)."""

    def __init__(self, target: str, token: str | None = None,
                 timeout_s: float = 30.0):
        from licensee_tpu_torch.fleet.faults import _dial_stream

        self.sock = _dial_stream(target, timeout_s=timeout_s)
        self.reader = self.sock.makefile("rb")
        self.token = token

    def close(self) -> None:
        try:
            self.reader.close()
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass

    # -- one HTTP round trip --

    def request(self, method: str, path: str,
                body: bytes | None = None) -> tuple[int, dict, bytes]:
        auth = (
            f"Authorization: Bearer {self.token}\r\n" if self.token else ""
        )
        body = body if body is not None else b""
        head = (
            f"{method} {path} HTTP/1.1\r\n"
            f"Host: edge\r\n{auth}"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n\r\n"
        ).encode("utf-8")
        self.sock.sendall(head + body)
        status_line = self.reader.readline()
        parts = status_line.decode("utf-8", "replace").split(" ", 2)
        if len(parts) < 2 or not parts[1].isdigit():
            raise JobsClientError(f"bad status line {status_line!r}")
        code = int(parts[1])
        headers: dict = {}
        while True:
            line = self.reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            name, _, value = line.decode("utf-8", "replace").partition(":")
            headers[name.strip().lower()] = value.strip()
        length = int(headers.get("content-length", "0"))
        payload = self.reader.read(length) if length else b""
        return code, headers, payload

    def _json(self, method: str, path: str,
              body: bytes | None = None) -> tuple[int, dict]:
        code, _headers, payload = self.request(method, path, body)
        try:
            row = json.loads(payload) if payload else {}
        except json.JSONDecodeError:
            raise JobsClientError(
                f"{method} {path}: unparsable body {payload[:200]!r}"
            ) from None
        if not isinstance(row, dict):
            raise JobsClientError(f"{method} {path}: non-object body")
        return code, row

    # -- the jobs verbs --

    def submit(self, spec: dict) -> tuple[int, dict]:
        body = json.dumps(spec).encode("utf-8")
        return self._json("POST", "/jobs", body)

    def status(self, job_id: str) -> tuple[int, dict]:
        return self._json("GET", f"/jobs/{job_id}")

    def results(self, job_id: str) -> tuple[int, bytes]:
        code, _headers, payload = self.request(
            "GET", f"/jobs/{job_id}/results"
        )
        return code, payload

    def containers(self, job_id: str) -> tuple[int, bytes]:
        code, _headers, payload = self.request(
            "GET", f"/jobs/{job_id}/containers"
        )
        return code, payload

    def cancel(self, job_id: str) -> tuple[int, dict]:
        return self._json("DELETE", f"/jobs/{job_id}")

    def wait(self, job_id: str, timeout_s: float = 600.0,
             poll_s: float = 0.25, on_poll=None) -> dict:
        """Poll until the job reaches a terminal state; returns the
        final status row.  Raises on timeout or a non-200 poll."""
        from licensee_tpu_torch.jobs.executor import TERMINAL_STATES

        deadline = time.perf_counter() + timeout_s
        while True:
            code, row = self.status(job_id)
            if code != 200:
                raise JobsClientError(
                    f"status poll answered {code}: {row}"
                )
            if on_poll is not None:
                on_poll(row)
            if row.get("state") in TERMINAL_STATES:
                return row
            if time.perf_counter() >= deadline:
                raise JobsClientError(
                    f"job {job_id} not terminal after {timeout_s}s "
                    f"(state {row.get('state')!r})"
                )
            time.sleep(poll_s)
