"""Where the point-read kernel spends its cycles, on the card.

    PYTHONPATH=src python -m repro_torch.tools.point_read_probe [--parent FILE]

Builds the tree of ``chip_smoke.py``'s engine phase (quickstart's nominal
tuning deployed at 10 M entries of 64 bytes, ``populate`` seed 1) and
draws the kernels phase's batch against its deepest level: 1 M keys, half
of them inserted keys, half absent (seed 1).  Then it compiles a copy of
``csrc/point_read.cu`` (the source itself is untouched) in which every
thread stamps ``clock64()`` between the kernel's phases and adds the
cycles of each phase into counters of its own, launches the copy three
times on the batch, and prints one JSON line: per phase, the mean and
quantiles of the cycles over the keys that passed a filter into a search
("positive") and the mean over all keys, with the CUDA-event time of the
instrumented launch.  With ``--parent FILE`` (the ``point_read.cu`` of
another tree, e.g. a ``git archive`` of the parent commit), that design is
instrumented and run on the same batch too, each on the layout it reads.
Last, the card's name and power limit.

The phases of the one-thread-a-key design with a plain binary search
(``design: "bisect"``): hashes and Bloom test, fence, the search's top
stretch (its first 12 halvings, down to a 4,096th of the run), its bottom
stretch, the key check and value read.  Of the sampled design
(``design: "sampled"``): hashes and Bloom test, fence, the bisection of
the run's top level in shared memory, the descent through its sample
levels in the L2, the read of the last window, the value; and per block
the load of the table and the tops into shared memory.  A phase's count runs from the stamp before it, so a load's wait
falls in the phase that uses the value.  The stamps cost some time of
their own.  The kernel's own times are ``chip_smoke.py``'s (its
``point_read`` row, or ``--point-read``).

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
N_ENTRIES, READ_BATCH = 10_000_000, 1_000_000

_HEADER = r"""
__device__ unsigned* g_probe_buf;
__device__ int g_probe_sink;
#define PR_T0 long long t_ = clock64(); const long long t0_ = t_; \
  unsigned c_[PR_NPH] = {};
#define PR_STAMP(i) { const long long n_ = clock64(); \
  c_[i] += (unsigned)(n_ - t_); t_ = n_; }
#define PR_FLUSH(b, B) { _Pragma("unroll") \
  for (int i_ = 0; i_ < PR_NPH; ++i_) \
    g_probe_buf[(long long)i_ * (B) + (b)] = c_[i_]; \
  g_probe_buf[(long long)PR_NPH * (B) + (b)] = \
    (unsigned)(clock64() - t0_); }
"""
_FOOTER = r"""
extern "C" int point_read_probe_set(void* p) {
  return (int)cudaMemcpyToSymbol(g_probe_buf, &p, sizeof(p));
}
"""
# a use of a loaded value that the compiler cannot drop, so that the
# stamp after it waits for the load
_WAIT = "if ({} == 0x7ffffffffffffff1LL) g_probe_sink = 1;"

# per design: a marker in its source, its phases, and the stamps, each
# (anchor, code, before the anchor: True, after: False, in its place: None)
DESIGNS = {
    "bisect": {
        "marker": "kFenceLo, kFenceHi, kWordOff, kRows };",
        "phases": ("hash_bloom", "fence", "search_top", "search_bottom",
                   "value"),
        "points": [
            ("  const long long key = q[b];", "  PR_T0\n", True),
            ("    if (!pos) continue;\n", "    PR_STAMP(0)\n", True),
            ("    if (e > s && key >= fence_lo[r] && key <= fence_hi[r]) {\n",
             "      PR_STAMP(1)\n      const long long span_ = (e - s) >> 12;"
             "\n      bool split_ = false;\n", False),
            ("      while (lo < hi) {\n",
             "        if (!split_ && hi - lo <= span_) { PR_STAMP(2) "
             "split_ = true; }\n", False),
            ("      if (lo < e && ak[lo] == key) {\n", "      PR_STAMP(3)\n",
             True),
            ("        enc = av[lo];\n", "        " + _WAIT.format("enc")
             + "\n        PR_STAMP(4)\n", False),
            ("  hit_out[b] = hit ? 1 : 0;\n", "  PR_FLUSH(b, B)\n", True),
        ]},
    "sampled": {
        "marker": "kSampleOff, kTopOff, kTopLevel, kRows",
        "phases": ("hash_bloom", "fence", "top_smem", "sample_l2", "window",
                   "value"),
        "points": [
            ("  extern __shared__ long long smem[];\n",
             "  const long long tb_ = clock64();\n", False),
            ("  __syncthreads();\n",
             "  if (threadIdx.x == 0) g_probe_buf[(long long)(PR_NPH + 1) * B"
             " + blockIdx.x] = (unsigned)(clock64() - tb_);\n", False),
            ("    const long long key = next;", "    PR_T0\n", True),
            ("      reads += 1;\n", "      PR_STAMP(0)\n", True),
            # the search's stamps: its function takes the counters
            ("                                           long long& lo) {",
             "                                           long long& lo, "
             "long long& t_, unsigned* c_) {", None),
            ("search_run(key, lv, r, ak, sample, keep, once, lo)",
             "search_run(key, lv, r, ak, sample, keep, once, lo, t_, c_)",
             None),
            ("  const int f = (int)lv.top_level[r];\n", "  PR_STAMP(1)\n",
             False),
            ("  long long c = t, off = 0;", "  PR_STAMP(2)\n", True),
            ("  // the lower bound lies in the kStride keys after level-1",
             "  PR_STAMP(3)\n", True),
            ("  lo = s + base + below;\n", "  PR_STAMP(4)\n", True),
            ("        enc = load(av + lo, once);\n",
             "        " + _WAIT.format("enc") + "\n        PR_STAMP(5)\n",
             False),
            ("    out.hit[b] = hit ? 1 : 0;\n", "    PR_FLUSH(b, B)\n", True),
        ]},
}
#: room for the per-block stamps of the sampled design
MAX_BLOCKS = 8192


def design_of(src: str) -> str:
    names = [n for n, d in DESIGNS.items() if d["marker"] in src]
    if len(names) != 1:
        raise ValueError(f"point_read_probe: the source matches designs "
                         f"{names}, not one")
    return names[0]


def instrument(src: str) -> str:
    """``src`` (a ``point_read.cu``) with the stamps, and an entry
    ``point_read_probe_set`` that points them at a buffer."""
    design = DESIGNS[design_of(src)]
    phases = design["phases"]
    for anchor, code, before in design["points"]:
        if src.count(anchor) != 1:
            raise ValueError(f"point_read_probe: anchor not once in the "
                             f"source: {anchor!r}")
        src = src.replace(anchor, code if before is None else
                          code + anchor if before else anchor + code)
    head = "#define PR_NPH %d\n%s" % (len(phases), _HEADER)
    src = src.replace("namespace {", head + "\nnamespace {", 1)
    return src + _FOOTER


def parent_args(q, ak, av, pack, outs, torch):
    """The C arguments of the bisect design's entry (its 6-row table)."""
    pad = [0]
    table = torch.tensor([pack.starts, pack.n_bits + pad, pack.ks + pad,
                          pack.fence_lo + pad, pack.fence_hi + pad,
                          pack.word_off], dtype=torch.int64).to(q.device)
    args = (q.data_ptr(), q.numel(), ak.data_ptr(), av.data_ptr(),
            table.data_ptr(), pack.num_runs, pack.words.data_ptr(),
            *(t.data_ptr() for t in outs))
    types = (_build.P, _build.I64, _build.P, _build.P, _build.P, _build.I32,
             _build.P) + (_build.P,) * 5
    return args, types, table


def entry_args(design, q, lv, outs, torch):
    """(arguments, argtypes, tensors to keep alive) of ``design``'s C
    entry, stream excluded."""
    if design == "bisect":
        return parent_args(q, lv.keys, lv.vals, lv.pack, outs, torch)
    from ..kernels.point_read import ops
    return (ops.launch_args(q, lv.keys, lv.vals, lv.pack, outs),
            ops._LAUNCH_ARGS[:-1], None)


def stats(c, np) -> dict:
    if not len(c):
        return {}
    return {"mean": float(c.mean()), "p10": float(np.percentile(c, 10)),
            "p50": float(np.percentile(c, 50)),
            "p90": float(np.percentile(c, 90)), "max": float(c.max())}


def clocks(torch, np, src_path: Path, tag: str, q, lv) -> dict:
    src = src_path.read_text()
    design = design_of(src)
    phases = DESIGNS[design]["phases"]
    cu = PROBE_DIR / f"point_read_{tag}.cu"
    lib_path = PROBE_DIR / f"point_read_{tag}.so"
    cu.write_text(instrument(src))
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                    str(lib_path), str(cu)], check=True, capture_output=True,
                   text=True)
    lib = ctypes.CDLL(str(lib_path))
    B = q.numel()
    dev = q.device
    outs = (torch.empty(B, dtype=torch.bool, device=dev),
            *(torch.empty(B, dtype=torch.int64, device=dev)
              for _ in range(4)))
    args, types, keep = entry_args(design, q, lv, outs, torch)
    fn = lib.point_read_launch
    fn.argtypes = list(types) + [_build.P]
    fn.restype = ctypes.c_int
    buf = torch.zeros((len(phases) + 1) * B + MAX_BLOCKS, dtype=torch.int32,
                      device=dev)
    lib.point_read_probe_set.argtypes = [_build.P]
    if lib.point_read_probe_set(buf.data_ptr()):
        raise RuntimeError("point_read_probe: setting the buffer failed")
    stream = torch.cuda.current_stream().cuda_stream
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    for _ in range(3):
        ev[0].record()
        rc = fn(*args, stream)
        ev[1].record()
        if rc:
            raise RuntimeError(f"instrumented point_read_launch: {rc}")
    torch.cuda.synchronize()
    del keep
    raw = buf.cpu().numpy().view(np.uint32).astype(np.int64)
    cyc = raw[:(len(phases) + 1) * B].reshape(len(phases) + 1, B)
    blocks = raw[(len(phases) + 1) * B:]
    blocks = blocks[blocks > 0]
    positive = (outs[3] > 0).cpu().numpy()
    per_phase = {}
    for i, name in enumerate(phases + ("total",)):
        per_phase[name] = {"positive": stats(cyc[i][positive], np),
                           "all_mean": float(cyc[i].mean())}
    return {"design": design, "source": str(src_path), "keys": B,
            "positives": int(positive.sum()),
            "hits": int(outs[0].sum()),
            "instrumented_ms": ev[0].elapsed_time(ev[1]),
            "phases_cycles": per_phase,
            **({"blocks": len(blocks), "block_top_load_cycles":
                stats(blocks, np)} if len(blocks) else {})}


def deepest_level(torch, np, dev):
    """The 10 M-entry tree's deepest level and the 1 M-key batch."""
    from .. import core, lsm, quickstart
    from ..utils import u64
    sys_t = core.LSMSystem()
    phi = core.tune_nominal(quickstart.EXPECTED, sys_t, n_starts=32,
                            steps=150, device=dev).phi
    tree = lsm.LSMTree.from_phi(phi, sys_t, expected_entries=N_ENTRIES,
                                entry_bytes=64, device=dev)
    keys = lsm.populate(tree, N_ENTRIES, seed=1)
    rng = np.random.default_rng(1)
    hits = rng.choice(keys, READ_BATCH // 2)
    misses = rng.integers(0, 2 ** 48, READ_BATCH // 2).astype(np.uint64) | \
        np.uint64(1 << 60)
    q = u64.to_device_keys(rng.permutation(np.concatenate([hits, misses])),
                           dev)
    lv = [lv for lv in tree.store.levels if lv.num_runs][-1]
    return q, lv


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another point_read.cu to instrument "
                    "and run on the same batch (e.g. the parent commit's)")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("point_read_probe: CUDA is not available", file=sys.stderr)
        return 3
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda")
    q, lv = deepest_level(torch, np, dev)
    lv.pack                                   # the layout, built once
    torch.cuda.synchronize()
    level = {"entries": lv.entries, "runs": lv.num_runs, "ks": lv.ks,
             "n_bits": lv.n_bits}
    sources = [("change", _build.CSRC_DIR / "point_read.cu")]
    if args.parent:
        sources.insert(0, ("parent", Path(args.parent)))
    for tag, path in sources:
        print(json.dumps({"probe": "point_read", "tree": tag,
                          "level": level,
                          **clocks(torch, np, path, tag, q, lv)}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
