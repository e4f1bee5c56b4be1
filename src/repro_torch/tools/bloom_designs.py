"""The Bloom probe's other designs, timed against the shipped one on the card.

    PYTHONPATH=src python -m repro_torch.tools.bloom_designs

Builds the plane of ``chip_smoke.py``'s bloom phase (10 M keys at 10 bits
a key in 512-bit blocks, k = 7: 195,313 x 512 floats, 400 MB; seed 6) and
its 1 M probe keys, half inserted.  Then it compiles
``tools/bloom_designs.cu`` once for each design (one ``nvcc`` each, all
started together): 1, 2 or 4 keys a thread; one float a round, 1 then
the rest, 2 then the rest, or 8 at once (no stop at k <= 8); with or
without an evict-first L2 policy on the plane's loads.  Each design must
equal the plain version (``ref.probe_ref``) bit for bit and read the
floats :func:`round_loads` says it reads.  It times each design and the
shipped kernel (``ops.bloom_probe_kernel``, before the designs and after
them) by CUDA events over back-to-back calls, and runs
:func:`sector_probe`, which tells whether an L2 miss on the plane fetches
32 or 64 bytes from HBM.  One JSON line, then the card's name and power
limit.

It builds with ``nvcc`` (``_build.NVCC_FLAGS``) into
``src/repro_torch/_build/probe/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

from ..kernels import _build

PROBE_DIR = _build.BUILD_DIR / "probe"
SOURCE = Path(__file__).resolve().parent / "bloom_designs.cu"
KEYS, BITS_PER_KEY, BLOCK_BITS, HASHES, PROBES = (10_000_000, 10, 512, 7,
                                                  1_000_000)
#: (keys a thread, floats of a key's first round, of each later round,
#: evict-first L2 policy); (1, 1, 1, False) is the shipped design's order
DESIGNS = [(kpt, first, step, hint)
           for kpt in (1, 2, 4)
           for first, step in ((1, 1), (1, 8), (2, 8), (8, 8))
           for hint in (True, False)]
_ARGS = (_build.P, _build.I64, _build.P, _build.I64, _build.I64, _build.I32,
         _build.P, _build.P, _build.P)


def round_loads(torch, reads, member, k: int, first: int, step: int):
    """The plane floats a design reads a key, from ``reads`` (the floats
    read one at a time, ``ref.probe_loads_ref``) and ``member``: all k for
    a member, else the end of the round that holds its first 0, at most
    k."""
    zero = torch.where(member == 0, reads.long() - 1, k)
    later = torch.clamp(zero - first, min=0)
    end = torch.where(zero < first, first,
                      first + (later // step + 1) * step)
    return torch.clamp(end, max=k).to(torch.int32)


def build(designs) -> dict:
    """One library per design, all ``nvcc`` started together."""
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for d in designs:
        lib = PROBE_DIR / ("bloom_design_%d_%d_%d_%d.so" % d)
        flags = ["-D%s=%d" % kv for kv in
                 zip(("KPT", "FIRST", "STEP", "EVICT_FIRST"), d)]
        procs[d] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o", str(lib),
             str(SOURCE)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    fns = {}
    for d, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for design {d}:\n{log}")
        fn = ctypes.CDLL(str(lib)).bloom_design_launch
        fn.argtypes = list(_ARGS)
        fn.restype = ctypes.c_int
        fns[d] = fn
    return fns


def event_ms(torch, fn, iters: int = 20) -> float:
    """CUDA-event ms per call over ``iters`` back-to-back calls, after two
    of warm-up."""
    for _ in range(2):
        fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(iters):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / iters


def sector_probe(torch, plane, n=2 ** 22, chunk=2048) -> dict:
    """What one random 4-byte read of the plane costs in HBM traffic,
    from three gathers (``index_select``) of ``n`` random 64-byte segments
    of the plane: ``one``, a float of each segment's first 32-byte sector
    (n reads); ``pair``, that float and one of the segment's second sector,
    read ``chunk`` outputs apart (2n reads in separate requests, the
    second soon after the first, while the segment is still in the L2);
    ``apart``, that float and one of another random segment (2n).  If an
    L2 miss fetches 64 bytes from HBM, ``pair`` costs about what ``one``
    does; if it fetches 32, about what ``apart`` does.  ms each."""
    flat = plane.view(-1)
    dev = plane.device
    g = torch.Generator(device=dev).manual_seed(8)
    segs = flat.numel() // 16
    a = torch.randint(0, segs, (n,), generator=g, device=dev) * 16
    b = torch.randint(0, segs, (n,), generator=g, device=dev) * 16

    def split(x, y):
        """x and y in alternating runs of ``chunk``."""
        return torch.stack([x.view(-1, chunk), y.view(-1, chunk)],
                           1).reshape(-1)

    idx = {"one": a, "pair": split(a, a + 8), "apart": split(a, b)}
    out = {f"{name}_ms": event_ms(torch,
                                  lambda i=i: flat.index_select(0, i), 10)
           for name, i in idx.items()}
    out["segments"] = n
    out["pair_over_one"] = out["pair_ms"] / out["one_ms"]
    out["apart_over_one"] = out["apart_ms"] / out["one_ms"]
    return out


def deployment(torch, np, dev):
    """The bloom phase's plane, probe keys and which of them are
    inserted."""
    from ..kernels.bloom_probe import ref
    n_in = PROBES // 2
    rng = np.random.default_rng(6)
    keys = rng.choice(2 ** 32, KEYS + PROBES - n_in,
                      replace=False).astype(np.int64)
    order = rng.permutation(PROBES)
    inserted = np.zeros(PROBES, bool)
    inserted[:n_in] = True
    q = torch.from_numpy(np.concatenate(
        [keys[:n_in], keys[KEYS:]])[order]).to(dev)
    plane = ref.build_plane(torch.from_numpy(keys[:KEYS]),
                            -(-BITS_PER_KEY * KEYS // BLOCK_BITS), BLOCK_BITS,
                            HASHES, device=dev)
    return plane, q, torch.from_numpy(inserted[order]).to(dev)


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("bloom_designs: CUDA is not available", file=sys.stderr)
        return 3
    from ..kernels.bloom_probe import ops, ref
    dev = torch.device("cuda")
    fns = build(DESIGNS)
    _build.build(["bloom_probe"])
    plane, q, inserted = deployment(torch, np, dev)
    k, N = HASHES, q.numel()
    want = ref.probe_ref(q, plane, k)
    reads = ref.probe_loads_ref(q, plane, k)
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty(N, dtype=torch.float32, device=dev)
    loads = torch.empty(N, dtype=torch.int32, device=dev)

    def run(fn):
        rc = fn(q.data_ptr(), N, plane.data_ptr(), plane.shape[0],
                plane.shape[1], k, out.data_ptr(), loads.data_ptr(), stream)
        if rc:
            raise RuntimeError(f"bloom_design_launch: {rc}")

    shipped = lambda: ops.bloom_probe_kernel(q, plane, k)  # noqa: E731
    result = {"probe": "bloom_designs", "keys": N, "plane": list(plane.shape),
              "shipped_ms_before": event_ms(torch, shipped)}
    rows = []
    for d, fn in fns.items():
        run(fn)
        if not torch.equal(out, want):
            raise RuntimeError(f"bloom design {d}: kernel != plain")
        if not torch.equal(loads, round_loads(torch, reads, want, k, d[1],
                                              d[2])):
            raise RuntimeError(f"bloom design {d}: loads != round_loads")
        rows.append({"keys_per_thread": d[0], "first": d[1], "step": d[2],
                     "evict_first": d[3],
                     "ms": event_ms(torch, lambda fn=fn: run(fn)),
                     "loads_per_key": loads.float().mean().item(),
                     "loads_per_absent_key":
                     loads[~inserted].float().mean().item()})
    result["shipped_ms_after"] = event_ms(torch, shipped)
    result["designs"] = rows
    result["sector_probe"] = sector_probe(torch, plane)
    print(json.dumps(result), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
