"""Container-level verdicts over the batch path's per-blob rows.

The port's counterpart of `licensee_tpu/ingest/verdict.py`: the
reference's project-level verdict (``Project#license`` / ``#licenses``,
projects/project.rb:24-52) over a container's finished rows.  A single
unique non-copyright match names the license, more than one collapses
to ``other`` (with the LGPL dual-file exception, project.rb:102-106),
and a scored license file that fails every matcher still counts as
``other`` (license_file.rb:92-98).  A container holding exactly two
confidently matched real licenses (``LICENSE-MIT`` + ``LICENSE-APACHE``)
keeps ``other`` and also carries ``"spdx_expression": "MIT OR
Apache-2.0"``.

Groups come in two shapes (``container_groups``): whole-container spans
(``archive.tar::*``) and listed member subsets (``archive.tar::LICENSE``
and ``archive.tar::COPYING`` in one manifest give one container row over
exactly those members).
"""

from __future__ import annotations

import json
import os


def _root_names(members: list[str]) -> list[tuple[str, str]]:
    """(root_name, member) pairs for the container's ROOT-level files.

    The reference scans only the project root (git_project.rb:64-76:
    root tree, type blob).  Forge tarballs wrap the tree in one shared
    top-level directory (``repo-1.2.3/``), and archive members may be
    stored under arbitrarily deep shared prefixes; the longest
    directory run EVERY member shares is the logical root, stripped
    before the root-level test."""
    comps = [m.split("/") for m in members]
    while comps and all(len(c) > 1 for c in comps):
        heads = {c[0] for c in comps}
        if len(heads) != 1:
            break
        comps = [c[1:] for c in comps]
    return [
        ("/".join(c), m)
        for c, m in zip(comps, members)
        if len(c) == 1 and c[0]
    ]


def container_verdict(entry: str, files: list[tuple[str, dict]]) -> dict:
    """The reference Project algebra over finished per-blob rows.

    ``files`` is the container's (member_name, row) list in container
    order; rows are the per-blob JSONL dicts (``key`` / ``matcher`` /
    ``confidence`` / optional ``error``).  Returns the container row.
    """
    from licensee_tpu_torch.corpus.license import License
    from licensee_tpu_torch.project_files.license_file import (
        COPYRIGHT_NAME_REGEX,
        LicenseFile,
    )

    roots = _root_names([name for name, _ in files])
    by_member = {name: row for name, row in files}
    candidates = []  # (name, score, effective license key, row)
    for root_name, member in roots:
        row = by_member[member]
        if row.get("error"):
            continue  # unreadable/oversized: never a candidate
        score = LicenseFile.name_score(root_name)
        if score <= 0:
            continue
        # license_file.rb:92-98: a scored license file that fails all
        # matchers is still 'other' — it looked like a license
        key = row.get("key") or "other"
        candidates.append((root_name, score, key, row))
    # project.rb:111-117: sort by score descending, stable on input order
    candidates.sort(key=lambda c: -c[1])

    def lic(key):
        return License.find(key)

    def is_lgpl_file(name, key):
        found = lic(key)
        return name.lower() == "copying.lesser" and bool(
            found and found.lgpl_q
        )

    # project.rb:137-145: LGPL gets priority when the top file is GPL'd
    if candidates:
        first = lic(candidates[0][2])
        if first is not None and first.gpl_q:
            lesser = next(
                (
                    i
                    for i, c in enumerate(candidates)
                    if is_lgpl_file(c[0], c[2])
                ),
                None,
            )
            if lesser is not None:
                candidates.insert(0, candidates.pop(lesser))

    def uniq(keys):
        out = []
        for k in keys:
            if k not in out:
                out.append(k)
        return out

    licenses = uniq(c[2] for c in candidates)

    def is_copyright(c):
        # project_file.rb:90-95: COPYRIGHT-named file whose content is
        # only a copyright statement (the Copyright matcher fired)
        name, _score, _key, row = c
        return row.get("matcher") == "copyright" and bool(
            COPYRIGHT_NAME_REGEX.search(name)
        )

    without_copyright = uniq(c[2] for c in candidates if not is_copyright(c))

    # project.rb:102-106: LGPL in COPYING.lesser beside a GPL COPYING
    is_lgpl = (
        len(licenses) == 2
        and len(candidates) == 2
        and is_lgpl_file(candidates[0][0], candidates[0][2])
        and bool(
            lic(candidates[1][2]) and lic(candidates[1][2]).gpl_q
        )
    )

    if len(without_copyright) == 1 or (is_lgpl and without_copyright):
        license_key = without_copyright[0]
    elif len(without_copyright) > 1:
        license_key = "other"
    else:
        license_key = None

    row = {
        "container": entry,
        "files": len(files),
        "license": license_key,
        "licenses": licenses,
        "matched_files": [c[0] for c in candidates],
    }

    # SPDX expression composition: exactly two distinct REAL licenses
    # (pseudo keys like other/no-license have no SPDX id to compose),
    # each a confident matcher verdict, and not the LGPL pair — the
    # dual-license shape
    if license_key == "other" and len(without_copyright) == 2:
        spdx = [
            found.spdx_id
            for k in without_copyright
            if (found := lic(k)) is not None
            and found.spdx_id not in (None, "NOASSERTION", "NONE")
        ]
        confident = all(
            c[3].get("key") and c[3].get("matcher") != "copyright"
            for c in candidates
            if not is_copyright(c)
        )
        if len(spdx) == 2 and confident:
            row["spdx_expression"] = " OR ".join(spdx)
    return row


def container_groups(
    spans: list[tuple[str, int, int]],
    subsets: list[tuple[str, list[tuple[int, str]]]] = (),
) -> list[tuple[str, list[tuple[int, str | None]]]]:
    """Normalize whole-container spans and explicitly-listed member
    subsets into verdict groups ``(label, [(row_index, member), ...])``
    ordered by first row index.

    ``member`` is ``None`` for span rows (the per-blob row's own
    ``path`` IS the member's stored name there); subset rows carry the
    member selector explicitly, because their display path echoes the
    manifest entry (``a.tar::LICENSE``) while the verdict algebra's
    name scoring needs the MEMBER name."""
    groups: list[tuple[str, list[tuple[int, str | None]]]] = []
    for entry, start, count in spans:
        groups.append((entry, [(start + j, None) for j in range(count)]))
    for label, members in subsets:
        groups.append((label, [(i, m) for i, m in members]))
    groups.sort(key=lambda g: g[1][0][0] if g[1] else -1)
    return groups


def write_container_verdicts(
    output: str,
    spans: list[tuple[str, int, int]],
    subsets: list[tuple[str, list[tuple[int, str]]]] = (),
) -> str:
    """Derive one container row per group — whole-container spans AND
    explicitly-listed member subsets — from the finished per-blob
    JSONL and write ``<output>.containers.jsonl`` atomically.

    Purely a function of the (deterministic, resume-safe) per-blob
    output, so a rerun after any crash — even one that tore a
    container in half — regenerates identical container rows once the
    blob rows are complete: container-granularity resume safety rides
    on blob-granularity resume for free.  Streams the output file
    once; a group's rows are freed the moment its last row passes
    (only interleaved groups overlap in memory)."""
    path = f"{output}.containers.jsonl"
    groups = container_groups(spans, subsets)
    need: dict[int, list[tuple[int, int]]] = {}
    for gi, (_label, members) in enumerate(groups):
        for slot, (idx, _member) in enumerate(members):
            need.setdefault(idx, []).append((gi, slot))
    filled: list = [[None] * len(m) for _label, m in groups]
    remaining = [len(m) for _label, m in groups]
    rendered: list = [None] * len(groups)
    for gi, (label, members) in enumerate(groups):
        if not members:
            # a container with zero regular members (directories only)
            # still gets its row — a {"files": 0, "license": null}
            # verdict, never a does-not-cover refusal
            rendered[gi] = json.dumps(container_verdict(label, []))
            filled[gi] = None
    max_idx = max(need) if need else -1
    with open(output, encoding="utf-8") as f:
        for i, line in enumerate(f):
            if i > max_idx:
                break
            targets = need.get(i)
            if not targets:
                continue
            row = json.loads(line)
            for gi, slot in targets:
                label, members = groups[gi]
                member = members[slot][1]
                filled[gi][slot] = (
                    member if member is not None else row["path"], row
                )
                remaining[gi] -= 1
                if remaining[gi] == 0:
                    rendered[gi] = json.dumps(
                        container_verdict(label, filled[gi])
                    )
                    filled[gi] = None  # free the row dicts
    short = [groups[gi][0] for gi, r in enumerate(rendered) if r is None]
    if short:
        raise ValueError(
            f"{output!r} does not cover the expansion: container "
            f"group(s) {short[:3]!r} need rows past its end"
        )
    tmp = f"{path}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        for r in rendered:
            f.write(r + "\n")
    os.replace(tmp, path)
    return path
