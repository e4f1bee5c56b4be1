"""Where the compaction merge's tile kernel spends its cycles, on the card.

    PYTHONPATH=src python -m repro_torch.tools.merge_probe

``csrc/merge.cu`` compiled from a copy (the source itself is untouched)
in which thread 0 of each of the first ``CLOCK_TILES`` blocks of
``lsm_merge_tile`` stamps ``clock64()`` at five points: the block's
start, its windows loaded, its merge and scan done, its offset known (the
look-back and the staging done), its stores issued; and the
``%globaltimer`` of its start and its SM.  It runs the copy's C entry on
5 M + 5 M entries drawn as ``chip_smoke.py``'s kernels phase draws them
(seed 0, 1,562,960 keys in both runs), with the drop and without, and
prints one JSON line: per phase, the mean and quantiles over tiles of the
cycles thread 0 spent there, how many SMs ran tiles, and when tiles
started; then the card's name and power limit.  The stamps cost some
time of their own.  The fold step's and ``two_way_merge``'s times are
``chip_smoke.py``'s (its ``merge`` row, or ``--merge``).

It builds with ``nvcc`` (``_build.NVCC_FLAGS``) into
``src/repro_torch/_build/probe/``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

from ..kernels import _build

PROBE_DIR = _build.BUILD_DIR / "probe"
MERGE_N = 5_000_000
CLOCK_TILES = 16384
PHASES = ("load", "merge_scan", "lookback_stage", "store_issue")


def instrument(src: str) -> str:
    """``src`` (``csrc/merge.cu``) with the stamps, and an entry
    ``merge_probe_read`` that copies them out."""
    stamp = ("if (threadIdx.x == 0 && blockIdx.x < %d) "
             "g_stamps[blockIdx.x][%%d] = clock64();" % CLOCK_TILES)
    points = [  # (anchor, code, before the anchor)
        ("  // with the drop, tiles in the order blocks start",
         "  " + stamp % 0 + "\n  if (threadIdx.x == 0 && blockIdx.x < "
         "%d) {\n    unsigned long long g_;\n    unsigned s_;\n"
         "    asm volatile(\"mov.u64 %%0, %%%%globaltimer;\" : \"=l\"(g_));\n"
         "    asm volatile(\"mov.u32 %%0, %%%%smid;\" : \"=r\"(s_));\n"
         "    g_stamps[blockIdx.x][5] = g_;\n"
         "    g_stamps[blockIdx.x][6] = s_;\n  }\n" % CLOCK_TILES, True),
        ("  tile_body<DROP>(sk, sv, w,", "  " + stamp % 1 + "\n", True),
        ("  const int kept_in_tile = s_scan[WARPS - 1];\n",
         "  " + stamp % 2 + "\n", False),
        ("  const long long base = DROP ? *s_base : w.d0;\n",
         "  " + stamp % 3 + "\n", True),
        ("      ov[base + e] = sv[e];\n    }\n  }\n",
         "  " + stamp % 4 + "\n", False),
    ]
    for anchor, code, before in points:
        if src.count(anchor) != 1:
            raise ValueError(f"merge_probe: anchor not once in merge.cu: "
                             f"{anchor!r}")
        src = src.replace(anchor, code + anchor if before else anchor + code)
    src = src.replace("namespace {", "__device__ unsigned long long "
                      "g_stamps[%d][8];\n\nnamespace {" % CLOCK_TILES, 1)
    return src + ('\nextern "C" int merge_probe_read(unsigned long long* '
                  'out) {\n  return (int)cudaMemcpyFromSymbol(out, g_stamps,'
                  ' sizeof(g_stamps));\n}\n')


def clocks(torch, big) -> dict:
    """The instrumented copy on ``big`` (A keys, A values, B keys, B
    values), with and without the drop."""
    import numpy as np
    cu, lib_path = PROBE_DIR / "merge_clocks.cu", PROBE_DIR / "merge_clocks.so"
    cu.write_text(instrument((_build.CSRC_DIR / "merge.cu").read_text()))
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                    str(lib_path), str(cu)], check=True, capture_output=True,
                   text=True)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.merge_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    tile = ctypes.c_int.in_dll(lib, "merge_tile_entries").value
    ak, av, bk, bv = big
    na, nb = ak.numel(), bk.numel()
    ntiles = -(-(na + nb) // tile)
    ok = torch.empty(na + nb, dtype=torch.int64, device=ak.device)
    ov = torch.empty_like(ok)
    scratch = torch.empty(2 * ntiles + 3, dtype=torch.int64, device=ak.device)
    res = {}
    for drop in (True, False):
        for _ in range(3):
            rc = fn(ak.data_ptr(), av.data_ptr(), na, bk.data_ptr(),
                    bv.data_ptr(), nb, ok.data_ptr(), ov.data_ptr(),
                    scratch.data_ptr(), int(drop),
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"instrumented merge_launch: {rc}")
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (CLOCK_TILES * 8))()
        if lib.merge_probe_read(buf):
            raise RuntimeError("merge_probe: reading the stamps failed")
        st = np.frombuffer(buf, dtype=np.uint64).reshape(CLOCK_TILES, 8)
        st = st[:min(ntiles, CLOCK_TILES)].astype(np.int64)
        phases = {}
        for k, name in enumerate(PHASES):
            c = st[:, k + 1] - st[:, k]
            phases[name] = {"mean": float(c.mean()),
                            "p10": float(np.percentile(c, 10)),
                            "p50": float(np.percentile(c, 50)),
                            "p90": float(np.percentile(c, 90)),
                            "max": float(c.max())}
        start_ns = st[:, 5] - st[:, 5].min()
        res[f"drop_{int(drop)}"] = {
            "tiles": int(len(st)), "phases_cycles": phases,
            "lifetime_cycles_mean": float((st[:, 4] - st[:, 0]).mean()),
            "start_span_ns": int(start_ns.max()),
            "sms": int(len(np.unique(st[:, 6]))),
            "tile_start_ns_by_decile": [
                int(np.percentile(start_ns, q)) for q in range(0, 101, 10)]}
    return res


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("merge_probe: CUDA is not available", file=sys.stderr)
        return 3
    from ..utils import u64
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    na = nb = MERGE_N
    pool = np.unique(rng.integers(0, 2 ** 64 - 1, int(1.6 * (na + nb)) + 8,
                                  dtype=np.uint64, endpoint=True))
    a = np.sort(rng.choice(pool, na, replace=False))
    b = np.sort(rng.choice(pool, nb, replace=False))
    big = (u64.to_device_keys(a, dev), torch.arange(na, device=dev),
           u64.to_device_keys(b, dev), torch.arange(nb, device=dev) + 10 ** 9)
    print(json.dumps({"probe": "merge", "na": na, "nb": nb,
                      "clocks": clocks(torch, big)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
