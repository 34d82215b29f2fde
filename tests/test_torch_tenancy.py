"""The port's tenancy tier against the JAX package's, on the CPU.

`TenantRegistry` writes the same file and journal bytes, each package
loads the other's registry, and bad configurations are refused with
equal messages; `TenantPools` and `CorpusOnboarder` make equal calls and
give equal answers over the same fake supervisors and a recording router
(an upload, each refusal, a failed roll, the crash recovery's replay);
the default validator gives the JAX package's fingerprint for an
artifact either package wrote; and the HTTP edge answers `POST /corpus`
and tagged classifies with equal bytes over each package's router, a
stub worker per pool.  Beside them, `fleet --selftest-jobs --stub
--device cpu` and `fleet --selftest-tenant --stub --device cpu` run
through the port's CLI as two child processes of one module fixture,
started with the first test: each must exit 0 and print ``"problems":
[]``."""

from __future__ import annotations

import base64
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time
import types

import jax  # noqa: F401 — both packages in one process, JAX on the CPU
import pytest

import licensee_tpu.fleet.http_edge as jax_edge
import licensee_tpu.fleet.router as jax_router
import licensee_tpu.fleet.wire as jax_wire
import licensee_tpu.tenancy as jax_tenancy
import licensee_tpu.tenancy.onboard as jax_onboard
import licensee_tpu.tenancy.registry as jax_registry
import licensee_tpu_torch.fleet.http_edge as port_edge
import licensee_tpu_torch.fleet.router as port_router
import licensee_tpu_torch.fleet.wire as port_wire
import licensee_tpu_torch.tenancy as port_tenancy
import licensee_tpu_torch.tenancy.onboard as port_onboard
import licensee_tpu_torch.tenancy.registry as port_registry

pytestmark = pytest.mark.usefixtures("lock_order_sanitizer")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUB_ENV = {**os.environ, "PYTHONPATH": REPO}

JAX = types.SimpleNamespace(
    name="jax", tenancy=jax_tenancy, registry=jax_registry,
    onboard=jax_onboard, Router=jax_router.Router, edge=jax_edge,
    oneshot=jax_wire.oneshot, WireError=jax_wire.WireError,
    stub="licensee_tpu.fleet.faults")
PORT = types.SimpleNamespace(
    name="port", tenancy=port_tenancy, registry=port_registry,
    onboard=port_onboard, Router=port_router.Router, edge=port_edge,
    oneshot=port_wire.oneshot, WireError=port_wire.WireError,
    stub="licensee_tpu_torch.fleet.faults")
SIDES = (JAX, PORT)
SELFTESTS = ("--selftest-jobs", "--selftest-tenant")
TRACE_RE = re.compile(r"\b[0-9a-f]{16}\b")


@pytest.fixture(scope="module", autouse=True)
def selftests():
    """The two stub selftests of the port's CLI, started together with
    the module's first test and waited for by the last ones."""
    procs = {
        flag: subprocess.Popen(
            [sys.executable, "-m", "licensee_tpu_torch.cli.main", "fleet",
             flag, "--stub", "--device", "cpu"], cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for flag in SELFTESTS
    }
    done = {}

    def finish():
        for flag, proc in procs.items():
            if flag not in done:
                out, err = proc.communicate(timeout=240)
                done[flag] = (proc.returncode, out, err)
        return done

    try:
        yield finish
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


# -- the registry ------------------------------------------------------------------


def write_registry(side, path: str) -> None:
    reg = side.registry.TenantRegistry(path, create=True)
    reg.set_tenant(side.registry.Tenant("acme", "tok-acme", "vendored"),
                   save=False)
    reg.set_tenant(side.registry.Tenant("beta", "tok-beta", "spdx",
                                        pool="shared"))
    reg.record_roll("roll_start", "acme", corpus="c1", fingerprint="f1")
    reg.record_roll("roll_done", "acme", fingerprint="f1")
    reg.record_roll("roll_start", "beta", corpus="c2", fingerprint="f2",
                    staged=None)
    reg.update_corpus("acme", "c1", "f1")
    reg.close()


def registry_view(side, path: str) -> dict:
    reg = side.registry.TenantRegistry(path)
    try:
        return {
            "tokens": reg.tokens(), "pools": reg.pools(),
            "tenants": {n: (t.token, t.corpus, t.pool, t.as_dict())
                        for n, t in reg.tenants().items()},
            "by_token": [getattr(reg.by_token(t), "name", None)
                         for t in ("tok-beta", "tok-nobody")],
            "default_pool": reg.default_pool,
            "pending": reg.pending_rolls(),
        }
    finally:
        reg.close()


def test_registry_bytes_and_cross_loading_match_jax(tmp_path):
    paths = {}
    for side in SIDES:
        paths[side.name] = str(tmp_path / f"{side.name}.json")
        write_registry(side, paths[side.name])
    files = []
    for path in paths.values():
        with open(path, "rb") as f, open(f"{path}.journal", "rb") as g:
            files.append((f.read(), g.read()))
    assert files[0] == files[1]
    views = [registry_view(side, path) for side in SIDES
             for path in paths.values()]
    assert all(v == views[0] for v in views)
    assert views[0]["pools"] == {"acme": ["acme"], "shared": ["beta"]}
    assert [r["tenant"] for r in views[0]["pending"]] == ["beta"]


BAD_REGISTRIES = {
    "not_json": "{nope",
    "not_object": "[1]",
    "version": {"version": 2, "tenants": {}},
    "no_tenants": {"version": 1},
    "tenant_not_object": {"version": 1, "tenants": {"a": 3}},
    "no_token": {"version": 1, "tenants": {"a": {"corpus": "vendored"}}},
    "no_corpus": {"version": 1, "tenants": {"a": {"token": "t"}}},
    "pool_not_string": {"version": 1, "tenants": {
        "a": {"token": "t", "corpus": "vendored", "pool": 3}}},
    "token_collision": {"version": 1, "tenants": {
        "a": {"token": "tok", "corpus": "vendored"},
        "b": {"token": "tok", "corpus": "spdx"}}},
    "default_pool_type": {"version": 1, "default_pool": 1, "tenants": {}},
    "default_pool_unknown": {"version": 1, "default_pool": "nope",
                             "tenants": {"a": {"token": "t",
                                               "corpus": "vendored"}}},
    "missing_file": None,
}


@pytest.mark.parametrize("case", sorted(BAD_REGISTRIES))
def test_registry_refusals_match_jax(tmp_path, case):
    path = str(tmp_path / "reg.json")
    doc = BAD_REGISTRIES[case]
    if doc is not None:
        with open(path, "w", encoding="utf-8") as f:
            f.write(doc if isinstance(doc, str) else json.dumps(doc))
    messages = []
    for side in SIDES:
        with pytest.raises(side.registry.RegistryError) as exc:
            side.registry.TenantRegistry(path)
        messages.append(str(exc.value))
    assert messages[0] == messages[1]


def test_registry_corrupt_journal_leaves_nothing_pending(tmp_path):
    for side in SIDES:
        path = str(tmp_path / f"{side.name}.json")
        write_registry(side, path)
        with open(f"{path}.journal", "ab") as f:
            f.write(b"not json\n{}\n")
        assert registry_view(side, path)["pending"] == []


# -- pools and the onboarder over fakes -------------------------------------------


class FakeHandle:
    def __init__(self, sock):
        self.socket_path = sock


class FakeSupervisor:
    """The supervisor surface `TenantPools` forwards to, recording calls;
    ``answer`` is what its `reload_fleet` returns (or raises)."""

    def __init__(self, workers, log, answer=None):
        self.workers = {n: FakeHandle(s) for n, s in workers.items()}
        self.router = None
        self.log = log
        self.answer = answer

    def reload_fleet(self, corpus, **kwargs):
        self.log.append(("reload", corpus, sorted(kwargs)))
        if isinstance(self.answer, Exception):
            raise self.answer
        return dict(self.answer or {"ok": True, "corpus": corpus,
                                    "workers": {n: {} for n in
                                                self.workers}})

    def dispatchable(self, name):
        return name.endswith("0")

    def probe(self, name):
        return {"name": name}

    def status(self):
        return {n: {"state": "healthy"} for n in self.workers}

    def host_health(self):
        n = len(self.workers)
        return {"workers": n, "healthy": n, "dispatchable": n,
                "restarts": 1, "serving": True}

    def drain(self, name, **kwargs):
        self.log.append(("drain", name))
        return {"drained": name}

    def start(self):
        self.log.append(("start",))

    def stop(self):
        self.log.append(("stop",))

    def wait_healthy(self, timeout):
        return True


class RecordingRouter:
    def __init__(self, log):
        self.log = log

    def __getattr__(self, name):
        if name in ("set_corpus_route", "drop_corpus_route",
                    "set_pool_fingerprint"):
            return lambda *args: self.log.append((name, *args))
        raise AttributeError(name)


def pools_answers(side) -> list:
    log = []
    a = FakeSupervisor({"a0": "/s/a0", "a1": "/s/a1"}, log)
    b = FakeSupervisor({"b0": "/s/b0"}, log)
    TenantPools = side.tenancy.TenantPools
    pools = TenantPools({"A": a, "B": b}, default_pool="A")
    pools.router = "the-router"
    out = [pools.workers, pools.worker_pools(), pools.pool_of("b0"),
           pools.pool_of("zz"), sorted(pools.handles()), a.router,
           pools.dispatchable("a0"), pools.dispatchable("a1"),
           pools.dispatchable("zz"), pools.probe("b0"), pools.probe("zz"),
           pools.status(), pools.host_health(), pools.drain("b0"),
           pools.reload_fleet("new", pool="B", timeout_s=1.0),
           pools.reload_fleet("other"), pools.reload_fleet("x", pool="nope"),
           pools.wait_healthy(1.0), TenantPools({"Z": b}).default_pool]
    with pools:
        pass
    try:
        pools.drain("zz")
    except KeyError as exc:
        out.append(("KeyError", str(exc)))
    for bad in ({}, {"A": a, "B": FakeSupervisor({"a0": "/x"}, log)}):
        try:
            TenantPools(bad)
        except ValueError as exc:
            out.append(str(exc))
    try:
        TenantPools({"A": a}, default_pool="Q")
    except ValueError as exc:
        out.append(str(exc))
    return out + log


def test_tenant_pools_match_jax():
    want, got = (pools_answers(side) for side in SIDES)
    assert got == want


def onboard_answers(side, root: str) -> list:
    os.makedirs(root)
    log = []
    Tenant, Registry = side.registry.Tenant, side.registry.TenantRegistry
    OnboardError = side.onboard.OnboardError
    registry = Registry(os.path.join(root, "tenants.json"), create=True)
    registry.set_tenant(Tenant("acme", "tok-acme", "fp-a-1"), save=False)
    registry.set_tenant(Tenant("beta", "tok-beta", "fp-b-1", pool="B"))
    sup_a = FakeSupervisor({"acme0": "/s/acme0"}, log)
    sup_b = FakeSupervisor({"b0": "/s/b0"}, log)
    pools = side.tenancy.TenantPools({"acme": sup_a, "B": sup_b},
                                     default_pool="acme")

    def validator(path):
        with open(path, encoding="utf-8") as f:
            text = f.read()
        if not text.startswith("fp-"):
            raise ValueError(f"not an artifact: {text[:10]!r}")
        return text

    onboarder = side.onboard.CorpusOnboarder(
        registry, pools, RecordingRouter(log),
        staging_dir=os.path.join(root, "staging"), validator=validator,
        source_for=lambda path, fp: fp,
        reload_kwargs={"timeout_s": 5.0})
    out = []

    def attempt(fn, *args):
        try:
            out.append(fn(*args))
        except OnboardError as exc:
            out.append(("OnboardError", exc.code, exc.detail))
        except RuntimeError as exc:
            out.append(("RuntimeError", str(exc)))

    onboarder.sync_routes(fingerprints={"acme": "fp-a-1" * 3})
    out += [onboarder.tenant_for("acme").name, onboarder.tenant_for(None),
            onboarder.pool_for_client("beta"),
            onboarder.pool_for_client("anon")]
    attempt(onboarder.upload, "acme", b"fp-a-2", "up.npz")
    attempt(onboarder.upload, "ghost", b"fp-x")
    attempt(onboarder.upload, "acme", b"garbage")
    sup_b.answer = {"ok": False, "error": "fleet_reload_in_progress: busy"}
    attempt(onboarder.upload, "beta", b"fp-b-2")
    sup_b.answer = {"ok": False, "error": "validation refused"}
    attempt(onboarder.upload, "beta", b"fp-b-3")
    sup_b.answer = RuntimeError("reload exploded")
    attempt(onboarder.upload, "beta", b"fp-b-4")
    sup_b.answer = None
    registry.record_roll("roll_start", "beta", corpus="fp-b-5",
                         fingerprint="fp-b-5")
    registry.record_roll("roll_start", "ghost", corpus="c", fingerprint="f")
    out.append(onboarder.recover())
    out.append(registry.pending_rolls())
    out.append({n: (t.corpus, t.fingerprint)
                for n, t in registry.tenants().items()})
    registry.close()
    with open(os.path.join(root, "tenants.json.journal"), "rb") as f:
        out.append(f.read().decode())
    with open(os.path.join(root, "tenants.json"), "rb") as f:
        out.append(f.read().decode())
    out.append(sorted(os.listdir(os.path.join(root, "staging"))))
    return out + log


def test_onboarder_matches_jax(tmp_path):
    want, got = (json.dumps(onboard_answers(side, str(tmp_path / side.name)),
                            default=repr).replace(str(tmp_path / side.name),
                                                  "TMP")
                 for side in SIDES)
    assert got == want
    rows = json.loads(want)
    assert rows[4]["fingerprint"] == "fp-a-2"
    assert rows[5][1] == "unknown_tenant" and rows[6][1] == "corpus_invalid"
    assert rows[7][1] == "fleet_reload_in_progress"
    assert rows[8][1] == "reload_failed"


def test_default_validator_matches_jax(tmp_path):
    """Each package's default validator reads an artifact either package
    wrote and names the same fingerprint; a garbage file is refused by
    both with the same kind of error."""
    from licensee_tpu.corpus.artifact import write_artifact as jax_write
    from licensee_tpu.corpus.compiler import default_corpus as jax_default
    from licensee_tpu_torch.corpus.artifact import (
        write_artifact as port_write,
    )
    from licensee_tpu_torch.corpus.compiler import (
        default_corpus as port_default,
    )

    paths = [str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")]
    jax_write(paths[0], jax_default(), source="vendored")
    port_write(paths[1], port_default(), source="vendored")
    fps = {(side.name, i): side.onboard._default_validator(path)
           for side in SIDES for i, path in enumerate(paths)}
    assert len(set(fps.values())) == 1
    garbage = tmp_path / "garbage.npz"
    garbage.write_bytes(b"not an artifact")
    errors = []
    for side in SIDES:
        with pytest.raises(ValueError) as exc:
            side.onboard._default_validator(str(garbage))
        errors.append(type(exc.value).__name__)
    assert errors[0] == errors[1]


# -- the HTTP edge over two pools of stub workers ---------------------------------


def request(port: int, method: str, path: str, token: str | None,
            body: bytes = b"") -> tuple:
    head = [f"{method} {path} HTTP/1.1", "Host: edge"]
    if token:
        head.append(f"Authorization: Bearer {token}")
    head.append(f"Content-Length: {len(body)}")
    raw = ("\r\n".join(head) + "\r\n\r\n").encode() + body
    with socket.create_connection(("127.0.0.1", port), timeout=10.0) as s:
        s.sendall(raw)
        f = s.makefile("rb")
        status = f.readline().decode()
        headers, length = [], 0
        while (line := f.readline()) not in (b"\r\n", b""):
            name, _, value = line.decode().partition(":")
            headers.append((name, value.strip()))
            if name.lower() == "content-length":
                length = int(value)
        body = f.read(length).decode()
    return status, headers, body


def edge_answers(side, root: str) -> list:
    os.makedirs(root)
    procs, sockets = [], {}
    for name, fp in (("acme0", "fp-acme-1"), ("beta0", "fp-beta-1")):
        sock = os.path.join(root, f"{name}.sock")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", side.stub, "--socket", sock, "--name",
             name, "--fingerprint", fp], env=STUB_ENV,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
        sockets[name] = sock
    out = []
    try:
        for sock in sockets.values():
            deadline = time.perf_counter() + 15.0
            while True:
                try:
                    side.oneshot(sock, {"op": "stats"}, 1.0)
                    break
                except side.WireError:
                    if time.perf_counter() > deadline:
                        raise
                    time.sleep(0.02)
        router = side.Router(sockets, probe_interval_s=0.05,
                             request_timeout_s=10.0, dispatch_wait_s=5.0,
                             trace_sample=0.0,
                             pools={"acme0": "acme", "beta0": "beta"},
                             default_pool="acme")
        registry = side.registry.TenantRegistry(
            os.path.join(root, "tenants.json"), create=True)
        for name in ("acme", "beta"):
            registry.set_tenant(side.registry.Tenant(
                name, f"tok-{name}", f"fp-{name}-1"))
        log = []
        pools = side.tenancy.TenantPools({
            "acme": FakeSupervisor({"acme0": sockets["acme0"]}, log),
            "beta": FakeSupervisor({"beta0": sockets["beta0"]}, log)},
            default_pool="acme")

        def validator(path):
            with open(path, encoding="utf-8", errors="replace") as f:
                text = f.read()
            if not text.startswith("fp-"):
                raise ValueError("not a corpus artifact")
            return text

        onboarder = side.onboard.CorpusOnboarder(
            registry, pools, router, staging_dir=os.path.join(root, "st"),
            validator=validator, source_for=lambda path, fp: fp)
        tokens = dict(registry.tokens())
        tokens["tok-anon"] = "anon"
        with router:
            onboarder.sync_routes(fingerprints={"acme": "fp-acme-1",
                                                "beta": "fp-beta-1"})
            edge = side.edge.HttpEdgeServer(
                "127.0.0.1:0", router, tokens=tokens, tenancy=onboarder,
                rate_per_client=10000.0, stall_timeout_s=1.0)
            thread = threading.Thread(target=edge.serve_forever,
                                      kwargs={"poll_interval": 0.05},
                                      daemon=True)
            thread.start()
            port = edge.bound_port

            def upload(token, payload):
                body = payload if isinstance(payload, bytes) else \
                    json.dumps(payload).encode()
                out.append(request(port, "POST", "/corpus", token, body))

            try:
                # tagged classifies first: after the upload's roll (its
                # supervisor a fake) pool acme's fence wants fp-acme-2
                for token, tag in (("tok-acme", None), ("tok-beta", "beta"),
                                   ("tok-beta", "fp-beta-1"),
                                   ("tok-acme", "ghost")):
                    msg = {"id": 1, "content": "x"}
                    if tag:
                        msg["corpus"] = tag
                    out.append(request(port, "POST", "/classify", token,
                                       json.dumps(msg).encode()))
                blob = base64.b64encode(b"fp-acme-2").decode()
                upload("tok-wrong", {"artifact_b64": blob})
                upload("tok-anon", {"artifact_b64": blob})
                upload(None, {"artifact_b64": blob})
                upload("tok-acme", {"artifact_b64": base64.b64encode(
                    b"garbage").decode()})
                upload("tok-acme", b"{nope")
                upload("tok-acme", b"[1]")
                upload("tok-acme", {"artifact_b64": ""})
                upload("tok-acme", {"artifact_b64": "!!"})
                upload("tok-acme", {"artifact_b64": blob, "name": 3})
                upload("tok-acme", {"artifact_b64": blob,
                                    "name": "up.npz"})
                out.append(request(port, "GET", "/corpus", "tok-acme"))
                out.append(router.pool_fingerprints())
            finally:
                edge.shutdown()
                edge.server_close()
                thread.join(timeout=5.0)
        registry.close()
        out.append(log)
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    return out


def test_edge_corpus_and_tagged_classify_match_jax(tmp_path):
    want, got = (TRACE_RE.sub("T", json.dumps(
        edge_answers(side, str(tmp_path / side.name)))
        .replace(str(tmp_path / side.name), "TMP")) for side in SIDES)
    assert got == want
    codes = [row[0].split()[1] for row in json.loads(want)[:15]]
    assert codes == ["200", "200", "200", "200", "401", "403", "401", "400",
                     "400", "400", "400", "400", "400", "200", "405"]


# -- the stub selftests ---------------------------------------------------------------


@pytest.mark.parametrize("flag", SELFTESTS)
def test_stub_selftest_passes(selftests, flag):
    rc, out, err = selftests()[flag]
    summary = json.loads(err.strip().splitlines()[-1])
    assert rc == 0 and summary["problems"] == [], (out, err[-3000:])
    assert summary["stub_workers"] is True and summary["device"] == "cpu"
