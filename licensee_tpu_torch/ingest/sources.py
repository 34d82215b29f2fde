"""Container-aware blob sources: blobs streamed out of tarballs, zip
archives and git repositories into the batch produce stage, with no
extraction to disk and bounded memory (only member metadata is held;
blob bytes are read per batch by the produce workers).

The port's counterpart of `licensee_tpu/ingest/sources.py`.

Manifest addressing (the ``::`` forms)
--------------------------------------
``path``                     a loose file
``archive.tar::member``      one member blob of a tar archive
``archive.tar::*``           every regular-file member, in archive order
``archive.tar.gz::*``        the same for a compressed tar (.tgz, .tar.bz2,
                             .tar.xz, ...), read in one forward pass
``archive.zip::member``      one member blob of a zip archive
``archive.zip::*``           every regular-file member, in archive order
``repo.git::HEAD``           every root-tree blob of that revision (a
                             branch, tag or sha; the root-level view of
                             git_project.rb:64-76)

A whole-container form (``*``, a git revision) expands to one row per
member, displayed by the member's stored name; an explicit member entry
echoes back as written.  Every reader enforces the reference's 64 KiB
``MAX_LICENSE_SIZE`` cap (git_project.rb:53) by skipping the blob (a
:class:`SkippedBlob`, an ``"error": "oversized"`` row), never by
truncating it.

Torn containers fail closed: a truncated tar, a zip without a readable
central directory or a git repository whose revision does not resolve
raise :class:`IngestError` while the manifest expands, before any row
is written.

Remote containers (``http(s)://...tar::*``, ``.tar.gz``, ``.zip``) are
read over HTTP(S) by ``ingest/remote.py`` (ranged reads for tar and zip,
one streaming pass for a compressed tar); a remote git repository
(``.git``) is refused.  An unrecognised URL shape stays a loose path,
whose read fails in its row.

Stripes are denominated in expanded blob counts, not raw manifest
entries: every stripe expands the full manifest (metadata only) and
:meth:`ManifestExpansion.restrict` s itself to its span of the expanded
rows, closing the containers its span never touches, so one large
tarball splits across stripes.  :func:`expanded_layout` is the stripe
runner's twin: one counting pass that returns the total, the container
groups and the fingerprint, with every handle closed.

Thread safety: tar members are read with ``os.pread`` (no shared file
offset); the compressed-tar, zip and git readers take a lock per
container around their one shared handle.
"""

from __future__ import annotations

import hashlib
import os
import threading

from licensee_tpu_torch.ingest import OVERSIZED, SkippedBlob
from licensee_tpu_torch.projects.git_project import MAX_LICENSE_SIZE

SEP = "::"

# compressed tars: random access into a compressed stream costs the
# archive per member, so they go to the sequential-window reader
_COMPRESSED_TAR_SUFFIXES = (".tar.gz", ".tgz", ".tar.bz2", ".tar.xz", ".tbz2", ".txz")

# the container kinds of http(s) URLs (`ingest/remote.py`)
REMOTE_KINDS = ("rtar", "rctar", "rzip", "rgit")


class IngestError(ValueError):
    """A container that cannot be opened or safely enumerated (a torn
    archive, a corrupt central directory, an unresolvable git revision,
    a remote git repository)."""


def split_entry(entry: str):
    """``(container, selector)`` for a ``::`` manifest entry, else None.

    Splits on the first ``::``, so member names may hold colons; a path
    with ``::`` whose prefix is no recognised container stays a loose
    path (whose read then fails in its row)."""
    if SEP not in entry:
        return None
    container, selector = entry.split(SEP, 1)
    if not container or _container_kind(container) is None:
        return None
    return container, selector


def is_container_entry(entry: str) -> bool:
    return split_entry(entry) is not None


def remote_entry_kind(container: str) -> str | None:
    """The remote kind of an http(s) container path, or None: ``rtar``,
    ``rctar`` (compressed), ``rzip`` or ``rgit``, by the URL's suffix
    with its query and fragment stripped."""
    low = container.lower()
    if not low.startswith(("http://", "https://")):
        return None
    base = low.split("?", 1)[0].split("#", 1)[0]
    if base.endswith(_COMPRESSED_TAR_SUFFIXES):
        return "rctar"
    if base.endswith(".tar"):
        return "rtar"
    if base.endswith(".zip"):
        return "rzip"
    if base.endswith(".git"):
        return "rgit"
    return None


def _container_kind(container: str) -> str | None:
    low = container.lower()
    if low.startswith(("http://", "https://")):
        return remote_entry_kind(container)
    if low.endswith(_COMPRESSED_TAR_SUFFIXES):
        return "ctar"
    if low.endswith(".tar"):
        return "tar"
    if low.endswith(".zip"):
        return "zip"
    if low.endswith(".git"):
        return "git"
    # a bare directory is a git container only where it looks like a
    # repository (a .git entry, or the bare HEAD + objects layout): an
    # ordinary directory whose path holds '::' stays a loose path
    if os.path.isdir(container) and (
        os.path.exists(os.path.join(container, ".git"))
        or (
            os.path.isfile(os.path.join(container, "HEAD"))
            and os.path.isdir(os.path.join(container, "objects"))
        )
    ):
        return "git"
    return None


class _TarContainer:
    """Random access into an uncompressed tar: one metadata scan up
    front (name -> (offset, size)), then an ``os.pread`` per member."""

    def __init__(self, path: str):
        import tarfile

        self.path = path
        self._members: dict[str, tuple[int, int]] = {}
        self._order: list[str] = []
        self._evidence: list[str] = []
        try:
            size = os.path.getsize(path)
            self._evidence.append(f"tar:{size}")
            with tarfile.open(path, mode="r:") as tf:
                for info in tf:
                    if not info.isreg():
                        continue  # directories, links, devices: no blob
                    if info.offset_data + info.size > size:
                        raise IngestError(
                            f"torn archive {path!r}: member {info.name!r} "
                            f"claims {info.size} bytes past end of file"
                        )
                    if info.name not in self._members:
                        self._order.append(info.name)
                    self._members[info.name] = (info.offset_data, info.size)
                    self._evidence.append(
                        f"{info.name}@{info.offset_data}+{info.size}"
                        f":{info.mtime}:{info.chksum}"
                    )
        except tarfile.TarError as exc:
            raise IngestError(f"cannot read tar {path!r}: {exc}") from exc
        except OSError as exc:
            raise IngestError(f"cannot open tar {path!r}: {exc}") from exc
        self._fd = os.open(path, os.O_RDONLY)

    def members(self) -> list[str]:
        return list(self._order)

    def evidence(self) -> list[str]:
        """Resume-fingerprint evidence: the archive's size and every
        member's (offset, size, mtime, header checksum), so a repack
        under the same member names still refuses a resume."""
        return list(self._evidence)

    def read(self, member: str):
        span = self._members.get(member)
        if span is None:
            return None  # a read_error row, as for an unreadable path
        offset, size = span
        if size > MAX_LICENSE_SIZE:
            return SkippedBlob(OVERSIZED)
        try:
            data = os.pread(self._fd, size, offset)
        except OSError:
            return None
        return data if len(data) == size else None

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None


class _SeqTarContainer:
    """A compressed tar read in one forward decompression pass.

    The metadata scan (a full pass up front, where a torn stream fails
    closed) gives every regular member a stream ordinal.  ``read()``
    advances a forward-only ``r|*`` stream to the ordinal it is asked
    for, caching each *wanted* member it passes (``want()``: the
    expansion registers exactly the members it will read, narrowed on
    resume by `ManifestExpansion.mark_done_prefix`), so the pipeline's
    bounded reordering of reads pops the cache instead of rescanning.
    Cache entries are popped on read, and the cache is bounded at
    ``cache_bytes_max`` (oldest first out): a read order that strands
    entries (a worker process sees only some of the chunks) costs a
    counted rescan (``rescans``), never an archive's worth of memory."""

    # the pipeline's reorder window is inflight x batch_size blobs of at
    # most 64 KiB; 32 MiB covers it many times over
    cache_bytes_max = 32 << 20

    def __init__(self, path: str):
        import tarfile
        import zlib

        self.path = path
        self._lock = threading.Lock()
        self._members: dict[str, tuple[int, int]] = {}
        self._order: list[str] = []
        self._evidence: list[str] = []
        self._wanted: set[int] = set()
        self._cache: dict[int, bytes] = {}
        self._cache_bytes = 0
        self._tf = None
        self._iter = None
        self._pos = 0
        self.rescans = 0
        try:
            self._evidence.append(self._head_evidence())
            ordinal = 0
            with self._open_meta_tar() as tf:
                for info in tf:
                    if not info.isreg():
                        continue
                    if info.name not in self._order:
                        self._order.append(info.name)
                    # a repeated name resolves to its last occurrence,
                    # as extraction (and _TarContainer) has it
                    self._members[info.name] = (ordinal, info.size)
                    self._evidence.append(
                        f"{info.name}@{ordinal}+{info.size}"
                        f":{info.mtime}:{info.chksum}"
                    )
                    ordinal += 1
        except (tarfile.TarError, EOFError, OSError, zlib.error) as exc:
            raise IngestError(
                f"cannot read compressed tar {path!r}: {exc}"
            ) from exc
        self._closed = False

    # the seams the remote reader overrides (`ingest/remote.py`): its
    # head evidence carries the republish validators instead of the
    # size, and both passes ride streaming GETs instead of local opens
    def _head_evidence(self) -> str:
        return f"ctar:{os.path.getsize(self.path)}"

    def _open_meta_tar(self):
        import tarfile

        return tarfile.open(self.path, mode="r:*")

    def _open_stream_tar(self):
        import tarfile

        # r|* decompresses strictly forward: members are consumed in
        # stream order, the window discipline this reader keeps
        return tarfile.open(self.path, mode="r|*")

    def members(self) -> list[str]:
        return list(self._order)

    def evidence(self) -> list[str]:
        """The archive's size and every member's (stream ordinal, size,
        mtime, header checksum)."""
        return list(self._evidence)

    def want(self, member: str) -> None:
        """Mark a member this expansion will read: only wanted members
        are cached when the forward walk passes them."""
        got = self._members.get(member)
        if got is not None and got[1] <= MAX_LICENSE_SIZE:
            self._wanted.add(got[0])

    def reset_wants(self) -> None:
        self._wanted.clear()
        self._cache.clear()
        self._cache_bytes = 0

    def _close_stream(self) -> None:
        if self._tf is not None:
            try:
                self._tf.close()
            except OSError:
                pass
            self._tf = None
            self._iter = None
        self._pos = 0

    def _next_reg(self):
        if self._tf is None:
            self._tf = self._open_stream_tar()
            self._iter = iter(self._tf)
            self._pos = 0
        while True:
            info = next(self._iter)
            if info.isreg():
                return info

    def read(self, member: str):
        import tarfile
        import zlib

        got = self._members.get(member)
        if got is None:
            return None
        ordinal, size = got
        if size > MAX_LICENSE_SIZE:
            return SkippedBlob(OVERSIZED)
        with self._lock:
            data = self._cache.pop(ordinal, None)
            if data is not None:
                self._cache_bytes -= len(data)
                return data
            try:
                if ordinal < self._pos:
                    # behind the window and not cached: the one rescan
                    # (counted; reads in the pipeline's order never
                    # come here)
                    self._close_stream()
                    self.rescans += 1
                while True:
                    info = self._next_reg()
                    o = self._pos
                    self._pos += 1
                    if o == ordinal:
                        f = self._tf.extractfile(info)
                        data = f.read() if f is not None else None
                        if data is None or len(data) != size:
                            return None
                        return data
                    if o in self._wanted:
                        f = self._tf.extractfile(info)
                        blob = f.read() if f is not None else None
                        if blob is not None:
                            self._cache[o] = blob
                            self._cache_bytes += len(blob)
                            while (
                                self._cache_bytes > self.cache_bytes_max
                                and self._cache
                            ):
                                first = next(iter(self._cache))
                                self._cache_bytes -= len(
                                    self._cache.pop(first)
                                )
            except (
                tarfile.TarError, EOFError, OSError, StopIteration,
                zlib.error,
            ):
                # in its row: the next read reopens a fresh stream
                self._close_stream()
                return None

    def close(self) -> None:
        if not self._closed:
            self._close_stream()
            self._cache.clear()
            self._cache_bytes = 0
            self._closed = True


class _ZipContainer:
    """Reads off the zip's central directory through one shared handle
    under a lock."""

    def __init__(self, path: str):
        import zipfile

        self.path = path
        self._lock = threading.Lock()
        try:
            # a truncated or garbage zip fails here, on its central
            # directory, before any row is written; a member's CRC
            # failure later is a read_error in its row
            self._zf = zipfile.ZipFile(path)
        except (zipfile.BadZipFile, OSError) as exc:
            raise IngestError(f"cannot read zip {path!r}: {exc}") from exc
        self._infos = {
            i.filename: i for i in self._zf.infolist() if not i.is_dir()
        }
        # repeated member names (an appended archive) give one row, of
        # the last occurrence, which is what ZipFile's name table reads
        self._order = list(dict.fromkeys(
            i.filename for i in self._zf.infolist() if not i.is_dir()
        ))

    def members(self) -> list[str]:
        return list(self._order)

    def evidence(self) -> list[str]:
        """Every member's CRC and size."""
        return [
            f"{n}:{self._infos[n].CRC}:{self._infos[n].file_size}"
            for n in self._order
        ]

    def read(self, member: str):
        info = self._infos.get(member)
        if info is None:
            return None
        if info.file_size > MAX_LICENSE_SIZE:
            return SkippedBlob(OVERSIZED)
        try:
            with self._lock:
                return self._zf.read(member)
        except Exception:  # noqa: BLE001 — CRC and zlib errors stay in the row
            return None

    def close(self) -> None:
        if self._zf is not None:
            self._zf.close()
            self._zf = None


class _GitContainer:
    """A revision's root tree read from the object database, through the
    backends of `projects/git_project.py` (the native reader, or git's
    plumbing), under a lock."""

    def __init__(self, path: str, revision: str):
        from licensee_tpu_torch.projects.git_project import (
            GitProject,
            InvalidRepository,
        )

        self.path = path
        self._lock = threading.Lock()
        try:
            self._backend = GitProject._open_backend(path, revision)
            files = self._backend.files()
        except InvalidRepository as exc:
            raise IngestError(
                f"cannot open git container {path!r} at {revision!r}: {exc}"
            ) from exc
        self._files = {f["name"]: f for f in files}
        self._order = [f["name"] for f in files]

    def members(self) -> list[str]:
        return list(self._order)

    def evidence(self) -> list[str]:
        """Every root entry's object id."""
        return [f"{n}:{self._files[n]['oid']}" for n in self._order]

    def read(self, member: str):
        from licensee_tpu_torch.projects.git_project import InvalidRepository

        file = self._files.get(member)
        if file is None:
            return None
        try:
            with self._lock:
                data = self._backend.load_file(file)
        except InvalidRepository:
            return None
        # the backends answer None only for a blob past the cap
        return SkippedBlob(OVERSIZED) if data is None else data

    def close(self) -> None:
        if self._backend is not None:
            self._backend.close()
            self._backend = None


def open_container(container: str, selector: str):
    """Open one container; the selector picks a git container's
    revision.  A remote git repository raises IngestError."""
    kind = _container_kind(container)
    if kind in REMOTE_KINDS:
        from licensee_tpu_torch.ingest import remote as _remote

        return _remote.open_remote_container(kind, container)
    if kind == "tar":
        return _TarContainer(container)
    if kind == "ctar":
        return _SeqTarContainer(container)
    if kind == "zip":
        return _ZipContainer(container)
    if kind == "git":
        return _GitContainer(container, selector or "HEAD")
    raise IngestError(f"unrecognized container {container!r}")


def _loose_read(path: str):
    # bound at first use: serve/featurize.py imports this package
    from licensee_tpu_torch.serve.featurize import read_capped

    return read_capped(path)


class ManifestExpansion:
    """The expanded manifest: each blob's display path, the container
    groups behind them, and the positional reader the produce stage
    reads through.

    ``paths[i]`` is what row i prints; ``read_at(i)`` loads its bytes
    (None: a read_error row; a :class:`SkippedBlob`: a skip row).  Reads
    go by index, not by display path, so two containers holding the
    same member name never cross.

    ``total`` is the full expanded count, the stripes' denominator, even
    after :meth:`restrict` narrows the expansion to one stripe's span;
    :meth:`fingerprint` too is the full expansion's, so every stripe's
    sidecar, the merged output's and an unstriped run's agree."""

    def __init__(self, entries: list[str]):
        # the raw entries: with the span and the fingerprint, what a
        # worker process needs to reopen the containers itself
        # (descriptor)
        self.entries = list(entries)
        self.span: tuple[int, int] | None = None
        self.total = 0
        self.paths: list[str] = []
        # parallel to paths: the name the routing and dispatch tables
        # read, the member's basename for a container blob, so that an
        # explicit `a.tar::LICENSE` routes like the loose LICENSE
        self.filenames: list[str] = []
        # parallel to paths: None for a loose file, else (container,
        # member)
        self._refs: list = []
        # whole-container groups: (entry, start, count), manifest order
        self.spans: list[tuple[str, int, int]] = []
        # listed-member groups: (container path, [(index, member), ...]);
        # `a.tar::LICENSE` and `a.tar::COPYING` in one manifest give one
        # container row over exactly those members (verdict.py)
        self.subsets: list[tuple[str, list[tuple[int, str]]]] = []
        self._containers: list = []
        self._fingerprint: str | None = None
        self._any_containers = False
        # resume: rows [0, _done_prefix) are written and never read
        self._done_prefix = 0

    @property
    def has_containers(self) -> bool:
        return self._any_containers

    def read_at(self, index: int):
        ref = self._refs[index]
        if ref is None:
            return _loose_read(self.paths[index])
        container, member = ref
        return container.read(member)

    def fingerprint(self) -> str | None:
        """sha1 over the expanded path list and each container's content
        evidence (tar offsets, sizes, mtimes and header checksums, zip
        CRCs, git object ids): the resume sidecar's proof that a resumed
        run expands to the same rows of the same bytes, so an archive
        rewritten between runs refuses the resume."""
        return self._fingerprint if self._any_containers else None

    def restrict(self, lo: int, hi: int) -> "ManifestExpansion":
        """Narrow to the expanded span ``[lo, hi)``, one stripe's view.
        Rows outside it drop, container groups clip to span-local
        indices, and containers none of whose members fall inside are
        closed (a stripe holds no handle for blobs another stripe owns).
        ``total`` and ``fingerprint()`` keep the full expansion's."""
        if not 0 <= lo <= hi <= self.total:
            raise ValueError(
                f"span [{lo}, {hi}) out of range for {self.total} "
                "expanded entries"
            )
        self.paths = self.paths[lo:hi]
        self.filenames = self.filenames[lo:hi]
        self._refs = self._refs[lo:hi]
        clipped = []
        for entry, start, count in self.spans:
            s, e = max(start, lo), min(start + count, hi)
            if e > s:
                clipped.append((entry, s - lo, e - s))
        self.spans = clipped
        self.subsets = [
            (label, kept)
            for label, members in self.subsets
            if (kept := [(i - lo, m) for i, m in members if lo <= i < hi])
        ]
        live = {id(ref[0]) for ref in self._refs if ref is not None}
        keep = []
        for c in self._containers:
            if id(c) in live:
                keep.append(c)
            else:
                try:
                    c.close()
                except OSError:
                    pass
        self._containers = keep
        self.span = (lo, hi)
        self._register_wants()
        return self

    def _register_wants(self) -> None:
        """Tell the sequential-window containers which members this
        expansion will still read (all but a resumed run's written
        prefix), so their forward walk caches nothing else."""
        for c in self._containers:
            if hasattr(c, "reset_wants"):
                c.reset_wants()
        for ref in self._refs[self._done_prefix:]:
            if ref is not None and hasattr(ref[0], "want"):
                ref[0].want(ref[1])

    def mark_done_prefix(self, done: int) -> None:
        """Resume: rows [0, done) are on disk and will never be read;
        the sequential-window wants narrow to the rest, so the resumed
        forward walk skips the prefix without caching it."""
        done = max(0, min(int(done), len(self._refs)))
        if done > self._done_prefix:
            self._done_prefix = done
            self._register_wants()

    def layout(self) -> dict:
        """The stripe runner's summary (`expanded_layout`): the total, the
        container groups and the fingerprint.  Call it on an unrestricted
        expansion: after `restrict` the groups are span-local."""
        return {
            "total": self.total,
            "spans": list(self.spans),
            "subsets": [(label, list(m)) for label, m in self.subsets],
            "fingerprint": self.fingerprint(),
        }

    def descriptor(self) -> dict:
        """A picklable recipe for a worker process (``featurize_procs``)
        to reopen the containers itself (`from_descriptor`): the raw
        entries, the span, the fingerprint (the worker refuses if the
        containers changed since the parent's expansion) and the written
        prefix."""
        return {
            "entries": list(self.entries),
            "span": list(self.span) if self.span is not None else None,
            "fingerprint": self.fingerprint(),
            "done_prefix": self._done_prefix,
        }

    @classmethod
    def from_descriptor(cls, desc: dict) -> "ManifestExpansion":
        out = expand_manifest(desc["entries"])
        try:
            if desc.get("fingerprint") and (
                out.fingerprint() != desc["fingerprint"]
            ):
                raise IngestError(
                    "container contents changed under a running job: "
                    "the worker's expansion fingerprint does not match "
                    "the parent's"
                )
            span = desc.get("span")
            if span is not None:
                out.restrict(span[0], span[1])
            if desc.get("done_prefix"):
                out.mark_done_prefix(desc["done_prefix"])
        except BaseException:
            out.close()
            raise
        return out

    def __getstate__(self):
        # file descriptors and ODB handles never cross a process
        # boundary: a worker reopens from descriptor()
        raise TypeError(
            "ManifestExpansion holds live container handles and never "
            "pickles; ship descriptor() and reopen with "
            "from_descriptor() in the worker process"
        )

    def close(self) -> None:
        for c in self._containers:
            try:
                c.close()
            except OSError:
                pass
        self._containers = []


def expand_manifest(
    entries: list[str], span: tuple[int, int] | None = None
) -> ManifestExpansion:
    """Expand raw manifest entries into one work item per blob, restricted
    to the expanded ``span`` where one is given (a stripe's view, see
    :meth:`ManifestExpansion.restrict`).

    Deterministic given the manifest and the containers' contents: the
    property the resume invariant (line count == completed prefix)
    rests on.  Reads metadata only (member tables, central directories,
    root trees), no blob bytes."""
    out = ManifestExpansion(entries)
    try:
        _expand_into(out, entries)
        out.total = len(out.paths)
        out._fingerprint = _full_fingerprint(out)
        if span is not None:
            out.restrict(span[0], span[1])
        else:
            out._register_wants()
    except BaseException:
        # a torn container midway must not leak the handles opened
        # before it
        out.close()
        raise
    return out


def _full_fingerprint(out: ManifestExpansion) -> str:
    h = hashlib.sha1(usedforsecurity=False)
    for p in out.paths:
        h.update(p.encode("utf-8", "surrogatepass"))
        h.update(b"\0")
    for container in out._containers:
        for line in container.evidence():
            h.update(line.encode("utf-8", "surrogatepass"))
            h.update(b"\0")
    return h.hexdigest()


def expanded_layout(entries: list[str]) -> dict:
    """The stripe runner's counting pass: ``total`` (the stripes'
    denominator), the whole-container ``spans`` and listed-member
    ``subsets`` in full expanded coordinates (the merge's container
    groups) and the ``fingerprint``, with every container handle closed
    before it returns.  Metadata only: no blob bytes are read."""
    ex = expand_manifest(entries)
    try:
        return ex.layout()
    finally:
        ex.close()


def _expand_into(out: ManifestExpansion, entries: list[str]) -> None:
    # one handle per (container path, git revision), shared by every
    # entry that names it
    opened: dict[tuple[str, str], object] = {}
    # listed-member groups, per container handle (entries naming one
    # container may interleave with others)
    subset_of: dict[int, list[tuple[int, str]]] = {}

    def get_container(container: str, selector: str):
        kind = _container_kind(container)
        key = (container, selector if kind == "git" else "")
        handle = opened.get(key)
        if handle is None:
            handle = open_container(container, selector)
            opened[key] = handle
            out._containers.append(handle)
        return handle

    for entry in entries:
        parsed = split_entry(entry)
        if parsed is None:
            out.paths.append(entry)
            out.filenames.append(os.path.basename(entry))
            out._refs.append(None)
            continue
        out._any_containers = True
        container_path, selector = parsed
        if not selector:
            raise IngestError(
                f"manifest entry {entry!r}: empty selector after "
                f"'{SEP}' (want a member path, '*', or a git revision)"
            )
        kind = _container_kind(container_path)
        handle = get_container(container_path, selector)
        if kind == "git" or selector == "*":
            start = len(out.paths)
            for member in handle.members():
                out.paths.append(member)
                out.filenames.append(os.path.basename(member))
                out._refs.append((handle, member))
            out.spans.append((entry, start, len(out.paths) - start))
        else:
            # one listed member: displayed as written, routed by the
            # member's own name, grouped with the container's other
            # listed members
            subset_of.setdefault(id(handle), []).append(
                (len(out.paths), selector)
            )
            if len(subset_of[id(handle)]) == 1:
                out.subsets.append((container_path, subset_of[id(handle)]))
            out.paths.append(entry)
            out.filenames.append(os.path.basename(selector))
            out._refs.append((handle, selector))
