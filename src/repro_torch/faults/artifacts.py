"""Crash-safe artifacts: atomic writes plus content checksums (stdlib only).

The port's copy of ``repro/faults/artifacts.py``, the part its reports
need.  Two defenses, used together:

* **atomic replace** — the payload lands in a same-directory temp file,
  fsynced, then :func:`os.replace`'d over the destination, so a crash
  mid-write leaves either the old file or the new one, never a torn one;
* **content checksum** — a sha256 over the canonical serialization travels
  with the payload, and a loader validates it before trusting the content,
  so a torn, truncated or hand-edited ``BENCH_<suite>.json`` is detected
  instead of consumed.  The digests equal the JAX package's for the same
  payload.

``fault`` threads the chaos schedule (:class:`repro_torch.faults.FaultPlan`)
through the write path: a ``torn_write`` fault leaves a truncated payload
at the final path and raises :class:`TornWriteError`.  The checksummed
job pickles of the subprocess backend (``dump_job``/``load_job``) are not
ported yet (ROADMAP.md queue 5).
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Any, Dict

#: checksum field/prefix conventions shared by every artifact schema.
CHECKSUM_KEY = "checksum"
_PREFIX = "sha256:"


class TornWriteError(OSError):
    """An injected torn artifact write (crash mid-write simulation)."""


def canonical_json(payload) -> str:
    """The canonical serialization checksums are computed over (key-sorted,
    separator-minimal, strict floats) — independent of on-disk indenting."""
    return json.dumps(payload, sort_keys=True, separators=(",", ":"),
                      allow_nan=False)


def payload_checksum(payload: Dict[str, Any]) -> str:
    """Checksum of a JSON payload, excluding its own checksum field."""
    body = {k: v for k, v in payload.items() if k != CHECKSUM_KEY}
    digest = hashlib.sha256(canonical_json(body).encode()).hexdigest()
    return _PREFIX + digest


def stamp_checksum(payload: Dict[str, Any]) -> Dict[str, Any]:
    """Return ``payload`` with its checksum field (re)computed in place."""
    payload[CHECKSUM_KEY] = payload_checksum(payload)
    return payload


def checksum_ok(payload: Dict[str, Any]) -> bool:
    claimed = payload.get(CHECKSUM_KEY)
    return claimed is not None and claimed == payload_checksum(payload)


def atomic_write_bytes(path: str, data: bytes, fault=None) -> None:
    """Write ``data`` to ``path`` via same-directory temp + ``os.replace``.

    With a matching ``torn_write`` fault in ``fault``, simulates a crash
    mid-write instead: truncated bytes land at the final path and
    :class:`TornWriteError` is raised (callers treat it as any other
    persistence failure; the next *loader* must reject the torn file)."""
    path = os.fspath(path)
    name = os.path.basename(path)
    if fault is not None and fault.tears_write(name):
        with open(path, "wb") as f:
            f.write(data[: max(1, len(data) // 2)])
        raise TornWriteError(f"injected torn write of {name!r}")
    fd, tmp = tempfile.mkstemp(prefix=name + ".", suffix=".tmp",
                               dir=os.path.dirname(path) or ".")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_json(path: str, payload: Dict[str, Any], indent: int = 1,
                      fault=None) -> Dict[str, Any]:
    """Checksum-stamp ``payload`` and atomically write it as strict JSON.

    Returns the stamped payload (mutated in place)."""
    stamp_checksum(payload)
    text = json.dumps(payload, indent=indent, sort_keys=True,
                      allow_nan=False)
    atomic_write_bytes(path, text.encode(), fault=fault)
    return payload


def load_checked_json(path: str) -> Dict[str, Any]:
    """Load a checksummed JSON artifact, raising ``ValueError`` if the file
    does not parse, carries no checksum, or fails validation."""
    with open(path) as f:
        payload = json.load(f)
    if not isinstance(payload, dict) or CHECKSUM_KEY not in payload:
        raise ValueError(f"{path}: no {CHECKSUM_KEY!r} field")
    if not checksum_ok(payload):
        raise ValueError(f"{path}: checksum mismatch (corrupt or torn file)")
    return payload
