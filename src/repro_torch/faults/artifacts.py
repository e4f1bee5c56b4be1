"""Content checksums for persisted JSON artifacts (stdlib only).

The port's copy of the checksum part of ``repro/faults/artifacts.py``: a
sha256 over the canonical serialization travels with the payload, and a
loader validates it before trusting the content, so a torn, truncated or
hand-edited ``BENCH_<suite>.json`` is detected instead of consumed.  The
digests equal the JAX package's for the same payload.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict

#: checksum field/prefix conventions shared by every artifact schema.
CHECKSUM_KEY = "checksum"
_PREFIX = "sha256:"


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
