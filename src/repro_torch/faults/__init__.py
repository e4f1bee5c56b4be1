"""Crash-safety helpers of the port (part of ``repro.faults``): the content
checksums every ``BENCH_<suite>.json`` carries."""

from .artifacts import (CHECKSUM_KEY, canonical_json, checksum_ok,
                        payload_checksum, stamp_checksum)

__all__ = ["CHECKSUM_KEY", "canonical_json", "checksum_ok",
           "payload_checksum", "stamp_checksum"]
