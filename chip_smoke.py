#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's CUDA kernels from
``src/repro_torch/csrc/`` (one ``nvcc`` per source, all at once), then:

1. ``tuner``  — the robust and the nominal sweep over the Fig. 6 grid (15
   expected workloads x rho in (0.25, 0.5, 1, 2, 3), CLASSIC, 64 starts,
   250 Adam steps: 9,600 lanes), counting ``dual_solve`` launches; on 6
   cells, the kernel path against the plain path with the same starts;
   and one robust Adam step's kernels and device ms from two profiled
   runs of the grid (``kernels_per_step``).
2. ``engine`` — quickstart's nominal and robust tunings deployed at 10 M
   entries of 64 bytes: ``populate`` and a 1 M-query ``run_session`` of the
   write burst, counting ``merge`` and ``point_read`` launches and
   recording the size of every merge the path launches, the inputs of
   every point read it launches and the key samples it builds (their
   count and device ms, replayed); one more
   populate in a profiler trace (its busy share, its top kernels and its
   fold steps' device time, two ``merge`` kernels a step); and a
   200,000-entry, 20,000-query run on the CPU plain path and on the card,
   whose ``IOStats`` and answers must be bit-identical; and
   ``run_policy_fleet`` with both tunings x {klsm, lazy_leveling} x the
   expected mix and the burst at the same size, every ``IOStats``
   bit-identical on the CPU and the card (counting the card's ``merge``
   and ``point_read`` launches).
3. ``serve`` — the LM server, once per architecture of ``SERVE``: the
   dense ``qwen3-14b`` (40 layers, d_model 5120, 14.8 B parameters) and
   the attention-free ``rwkv6-3b`` (32 layers, d_model 2560, 3.1 B), each
   at its published width and depth in bfloat16 from the port's seeded
   init on the card, ``serve_batch`` with batch 4, prompt 2048 and 32
   greedy tokens, counting its prefill kernel's launches
   (``flash_attention`` or ``rwkv6``, one per layer of the prefill, each
   on the bf16 tensor-core kernel); a
   profiled prefill and four profiled decode steps (device busy share,
   kernels by device time, and the prefill kernel's share of the device
   time); and the first 2 layers of the same weights in
   float32 at prompt 256, whose last-position prefill logits through the
   kernel and through the plain path (materialised attention, or the
   chunked WKV in torch ops) must agree to 1e-3 of the largest logit
   (counting the float32 kernels' launches).
   Each architecture's weights are freed before the next one's.
4. ``bloom`` — the blocked-Bloom probe through its own entry points (no
   path of the system calls it), at RocksDB's cache-local Bloom filter
   over 10 M keys: 512-bit blocks at 10 bits per key (195,313 blocks, an
   f32 0/1 plane of 400 MB), k = 7.  ``build_plane`` inserts 10 M
   distinct seeded uint32 keys on the card; ``bloom_probe`` takes 1 M
   keys, half inserted, counting ``bloom_probe`` launches.  The kernel
   must equal the plain version bit for bit, miss no inserted key, and
   pass 0.5%-2% of the absent ones; its row records the plane floats it
   read a present and an absent key, by its own count.
5. ``kernels`` — each kernel against its plain version on the card at the
   main path's shapes (``merge``/``point_read``/``bloom_probe``
   bit-identical,
   ``dual_solve`` to rel 1e-5 in value and in the envelope gradient it
   writes, with the share of lanes bit-equal to the plain version,
   ``flash_attention`` to 2e-2 in
   bfloat16 and 2e-5 in float32, each case naming the kernel that served
   it, ``rwkv6`` to 5e-2 in bfloat16 at the model's, a slow and a fast
   decay and 5e-4 in float32 on y and the final state, each case naming
   its kernel, the float32 one timed as a row of its own), with the
   CUDA-event time per call
   (``ms``: what a caller waits, host launch included), the kernel's own
   device time from a profiler trace (``device_ms``; a trace without the
   kernel fails the phase), the plain version's
   time, a PyTorch library call's time where one exists, and the least
   time the card could take (bytes over 3.35 TB/s, or operations over 67
   TFLOP/s, the H100 SXM data sheet's float32 rate outside the tensor
   cores; for ``flash_attention``, over its 989 TFLOP/s bfloat16
   tensor-core rate, and also its rate and SDPA's time on one
   8192-token sequence); ``merge`` is timed as the fold step the path
   runs (the merge with the newest-wins drop fused in) and as
   ``two_way_merge``, and replays the engine path's fold steps at their
   recorded sizes, for their summed device time against their bound;
   ``point_read`` likewise replays the path's point reads and the samples
   they built; and ``launch_floor_ms``, a one-element add's device
   time.

6. ``suites`` — the paper suites ``fig4``, ``fig10`` and the three that
   run through the experiment API (``fig7_8``, ``fig9``, ``fig19``:
   ``repro_torch.api.run_experiment``) through ``repro_torch.bench.run``
   at their committed sizes, every tuning started from the starts the
   committed ``BENCH_<suite>.json`` were made from
   (``bench/jax_starts.npz``), so every held field must match the
   committed file within the runner's tolerance (none missed, and as many
   held as the file has: ``SUITE_HELD``); one JSON line per suite (wall
   time, each row's derived values, held fields matched and missed, the
   card's time fields, the start-dependent spreads, each kernel's
   launches, which for ``dual_solve`` must be one per robust Adam step
   plus one per tuning: 251 for each API suite's robust grid); and the
   ``dual_solve`` launches a profiler trace records over one fig10 robust
   call, which must be its steps + 1.  The ``tuner`` suite runs only under
   ``--suites`` (below): its seed-style row alone takes about 1,000 s on
   the H100.
7. ``api`` — ``run_experiment`` on the card for the spec of the JAX
   package's API smoke suite (``API_SPEC``: two workloads, nominal and
   rho 1, the K-LSM and lazy-leveling policy arms, 8 trees of 40,000 keys
   and two sessions), counting its kernels' launches; then its
   ``TrialPlan`` through ``execute_trial`` on the card and on the CPU:
   every tree's ``IOStats``, I/O per query and ``TreeProbe`` bit-identical,
   with the card trial's ``merge`` and ``point_read`` launches.

The build's ``ptxas`` report (registers and spills) for the bf16
``rwkv6`` kernel is printed on a line of its own.

    python3 chip_smoke.py --suites [--src DIR]

runs only the suites phase, over ``fig4``, ``fig10``, ``tuner``,
``fig7_8``, ``fig9`` and ``fig19``, on the ``repro_torch`` under
``DIR``: one JSON line per suite, then the card's name and power limit.

    python3 chip_smoke.py --merge [--src DIR] [--sizes FILE]

times only the compaction merge, as the kernels phase does (the fold
step and ``two_way_merge`` at 5 M + 5 M; with ``--sizes``, the engine
path's fold steps replayed at the sizes a whole run printed), on the
``repro_torch`` under ``DIR`` (default: this checkout's ``src``), so that
one call can time two trees in turn.  It prints one JSON line and the
card's name and power limit.

    python3 chip_smoke.py --point-read [--src DIR]

times only the point read, as the kernels phase does, on the same trees
(quickstart's tunings populated at 10 M entries, their sessions run):
the 1 M-key batch against the nominal tree's deepest level, the engine
path's launches replayed on their recorded inputs against their summed
bounds, and the samples the path built rebuilt; on the ``repro_torch``
under ``DIR``, one JSON line, then the card's name and power limit.

    python3 chip_smoke.py --dual-solve [--src DIR]
    python3 chip_smoke.py --bloom [--src DIR]

time only the dual solve (the tuner's 9,600 lanes, the share of lanes
bit-equal to the plain version, the launch floor, a robust Adam step's
kernels and device ms, the robust sweep's wall time) or only the Bloom
probe (the bloom phase's plane and 1 M keys; where the tree counts
them, the loads a key), on the ``repro_torch`` under ``DIR``: one JSON
line, then the card's name and power limit.  The probe's other designs
are timed by ``python -m repro_torch.tools.bloom_designs``.

Each phase prints one JSON line; then the kernel table as one JSON line,
the ``nvidia-smi`` name and power limit, and last the result line.  Any
failed check raises, so the script exits non-zero.  It exits non-zero
without a result when CUDA is not available or the package is missing.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
LEAD_KERNELS = 8                 # throwaway launches that open a trace
FP32_OPS_PER_S = 67e12           # H100 SXM, outside the tensor cores
BF16_OPS_PER_S = 989e12          # H100 SXM, tensor cores, dense
GRID_RHOS = (0.25, 0.5, 1.0, 2.0, 3.0)
N_STARTS, STEPS = 64, 250
N_ENTRIES, N_QUERIES = 10_000_000, 1_000_000
DEVICE = "cuda"
SMALL_ENTRIES, SMALL_QUERIES = 200_000, 20_000
# the fleet check: compaction policies, beside the 200K run
FLEET_POLICIES = ("klsm", "lazy_leveling")
# the paper suites of repro_torch.bench, at their committed sizes: the
# default run holds fig4, fig10 and the API suites; the tuner suite (1,110 s
# on the H100, most of it its seed-style row) runs under --suites, with the
# others
SUITES = ("fig4", "fig10", "fig7_8", "fig9", "fig19")
ALL_SUITES = ("fig4", "fig10", "tuner", "fig7_8", "fig9", "fig19")
# the held fields of each committed BENCH_<suite>.json
SUITE_HELD = {"fig4": 18, "fig10": 12, "tuner": 11, "fig7_8": 27, "fig9": 4,
              "fig19": 16}
# the suites that run through the experiment API, each with one robust grid
API_SUITES = ("fig7_8", "fig9", "fig19")
# the API trial check: the spec of the JAX package's API smoke suite
# (benchmarks/bench_api.py), as ExperimentSpec.from_dict takes it
API_SPEC = {
    "name": "api",
    "workload": {"indices": (4, 11), "rhos": (1.0,), "nominal": True},
    "design": {"n_starts": 16, "steps": 120, "seed": 0,
               "policies": ("klsm", "lazy_leveling"),
               "policy_params": (("lazy_leveling",
                                  (("read_trigger", 512),)),)},
    "trial": {"n_keys": 40_000, "n_queries": 2000,
              "sessions": ((0.05, 0.85, 0.05, 0.05),
                           (0.05, 0.05, 0.05, 0.85)),
              "key_space": 2 ** 24, "range_fraction": 1e-3,
              "per_workload_keys": True, "key_seed": 100},
    "system": (("N", 40_000.0), ("entry_bits", 64.0 * 8),
               ("page_bits", 4096.0 * 8), ("bits_per_entry", 6.0),
               ("min_buf_bits", 64.0 * 8 * 64), ("s_rq", 1e-3),
               ("max_T", 20.0)),
}
MERGE_N, READ_BATCH = 5_000_000, 1_000_000
# (arch, the kernel its prefill runs once per layer)
SERVE = (("qwen3-14b", "flash_attention"), ("rwkv6-3b", "rwkv6"))
# a part of each kernel's CUDA name, as a profiler trace records it; the
# bf16 flash_attention kernel is the one the bf16 serving path launches
CUDA_NAMES = {"dual_solve": "dual_solve_warm_kernel",
              "merge": "lsm_merge_", "point_read": "point_read_kernel",
              "flash_attention": "flash_attention_wgmma_kernel",
              "rwkv6": "rwkv6_mma_kernel",
              "rwkv6:f32_cuda_core": "rwkv6_kernel",
              "bloom_probe": "bloom_probe_kernel"}
SERVE_REDUCED = False
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 2048, 32
CHECK_LAYERS, CHECK_PROMPT = 2, 256
# the bloom phase: RocksDB's format_version=5 cache-local Bloom filter
# (512-bit blocks, its default 10 bits per key) over 10 M keys, k from
# lsm/bloom.py::bloom_params (round(10 ln 2) = 7); 1 M probes, one read
# batch, half of them inserted keys
BLOOM_KEYS, BLOOM_BITS_PER_KEY, BLOOM_BLOCK_BITS = 10_000_000, 10, 512
BLOOM_HASHES, BLOOM_PROBES = 7, 1_000_000
# float32 flash_attention cases: (B, S, H, KV, d), causal, window
FLASH_F32_CASES = [((2, 2048, 8, 2, 64), True, 512),
                   ((2, 1024, 8, 8, 96), False, None),
                   ((2, 1531, 40, 8, 128), True, None)]       # ragged S
# more bfloat16 flash_attention cases besides the serving prefill's:
# (B, S, H, KV, d), causal, window, or an arch whose heads to take
FLASH_BF16_CASES = [((2, 1531, 40, 8, 128), True, None),      # ragged S
                    ("phi3-mini-3.8b", True, None),           # d 96, H = KV
                    ("glm4-9b", True, None),                  # GQA group 16
                    ((2, 2048, 40, 8, 128), True, 512)]       # window
# rwkv6 decays, (mean, sd) of ww with logw = -exp(ww): the model's init,
# a slow one (exp(logw) ~ 0.993) and a fast one (logw ~ -7.4, where a
# one-level chunked split overflows); bf16 runs each at the prefill's shape
RWKV_DECAYS = {"model": (-0.6, 0.5), "slow": (-5.0, 0.1),
               "fast": (2.0, 0.1)}
# float32 rwkv6 cases: (B, S, H, n), decay; the first is timed
RWKV_F32_CASES = [((2, 2048, 8, 64), "slow"), ((2, 512, 8, 32), "model"),
                  ((2, 96, 4, 64), "slow")]                   # 3 chunks


T_START = time.time()


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def log(msg: str) -> None:
    """Progress on stderr, with seconds since start."""
    print(f"[{time.time() - T_START:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def time_ms(torch, fn, iters: int) -> float:
    """Mean CUDA-event time of ``fn`` over ``iters`` calls, after warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_events(torch, fn, calls: int = 0, tries: int = 3) -> tuple:
    """Host wall seconds of ``fn`` (up to a synchronise) and the CUDA
    activities a ``torch.profiler`` trace of it records, as (name, device
    µs) pairs.  Late in this script a trace does not record the first one
    or two kernels launched in it, so each trace opens with
    ``LEAD_KERNELS`` throwaway launches of ``torch.cuda._sleep`` (its
    ``spin_kernel`` events are left out) before ``fn``.  With ``calls``,
    ``fn`` makes that many calls, each launching the same activities: a
    trace in which an activity's count is not a multiple of ``calls``
    missed events and is taken again, and when every one of ``tries``
    traces misses some, the check fails.  Without it, only a trace that
    holds no CUDA event at all is taken again."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(LEAD_KERNELS):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            wall = time.time() - t0
        events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "spin_kernel" not in e.name]
        counts = {}
        for name, _ in events:
            counts[name] = counts.get(name, 0) + 1
        short = {n[:60]: c for n, c in counts.items() if calls and c % calls}
        if events and not short:
            return wall, events
        log(f"cuda_events: trace {attempt + 1} of {tries} holds "
            f"{len(events)} CUDA events" + (f"; for {calls} calls, counts "
                                             f"{short}" if short else ""))
    check(not calls, f"cuda_events: each of {tries} traces of {calls} calls "
          "missed device events")
    return wall, events


def per_call(torch, fn, iters: int, kernel: str) -> dict:
    """``iters`` calls of ``fn`` (after one more) in one trace that holds
    every event (``cuda_events``), per call: the device ms and the number
    of the CUDA kernels whose name contains ``kernel``, the device ms and
    number of all its device activities (kernels and copies), and the
    host's wall ms."""
    fn()
    wall, events = cuda_events(torch, lambda: [fn() for _ in range(iters)],
                               calls=iters)
    mine = [us for name, us in events if kernel in name]
    return {"device_ms": sum(mine) / 1e3 / iters,
            "kernels": len(mine) // iters,
            "all_device_ms": sum(us for _, us in events) / 1e3 / iters,
            "activities": len(events) // iters,
            "wall_ms": wall * 1e3 / iters}


def device_ms(torch, fn, iters: int, kernel: str) -> float:
    """Device time per call of ``fn`` in the CUDA kernels whose name
    contains ``kernel`` (``per_call``): the kernels alone, without the
    host's cost of launching them.  When the trace holds no such kernel
    (a renamed kernel, or another kernel served the call), the check
    fails."""
    tr = per_call(torch, fn, iters, kernel)
    check(tr["kernels"] > 0, f"device_ms: no CUDA kernel named *{kernel}* "
          "in the trace")
    return tr["device_ms"]


def launch_floor_ms(torch) -> float:
    """The device time of a one-element PyTorch op (an in-place add), read
    as ``device_ms`` reads a kernel's: the least a kernel launch costs on
    the card, set against ``dual_solve``'s time."""
    one = torch.zeros(1, device=DEVICE)
    return per_call(torch, lambda: one.add_(1), 50, "")["device_ms"]


def profile_device(torch, fn, kernel: str = "") -> dict:
    """Host wall time of ``fn`` (up to a synchronise) and the CUDA kernels
    a ``torch.profiler`` trace records in it: their summed device time,
    its share of the wall time, their count, and the six largest by name
    (device fields None when the profiler records no device time); with
    ``kernel``, also the device time of the kernels whose name contains it,
    their share of the device time and their count."""
    wall, events = cuda_events(torch, fn, tries=1)
    busy_s = sum(us for _, us in events) / 1e6
    top = {}
    for name, us in events:
        top[name[:70]] = top.get(name[:70], 0.0) + us / 1e3
    top = dict(sorted(top.items(), key=lambda kv: -kv[1])[:6])
    out = {"wall_s": wall, "device_s": busy_s if events else None,
           "busy_share": busy_s / wall if events else None,
           "kernels": len(events), "top_kernels_ms": top}
    if kernel:
        ms = sum(us for name, us in events if kernel in name) / 1e3
        out[f"{kernel}_ms"] = ms
        out[f"{kernel}_share"] = ms / 1e3 / busy_s if events else None
        out[f"{kernel}_count"] = sum(kernel in name for name, _ in events)
    return out


def bound(bytes_moved: float, ops: float,
          ops_per_s: float = FP32_OPS_PER_S) -> dict:
    tb, to = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return {"bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations"}


# -- phase 1: the tuner --------------------------------------------------------

def phase_tuner(torch, core, build, ref_dual):
    sys_t = core.LSMSystem()
    W = core.EXPECTED_WORKLOADS.astype("float32")
    # the first sweep pays the process's first use of every CUDA kernel it
    # launches (module loading); the second is the steady state
    times = []
    for _ in range(2):
        log("tuner: robust sweep")
        t0 = time.time()
        build.reset_launches()
        robust = core.tune_robust_many(W, GRID_RHOS, sys_t,
                                       n_starts=N_STARTS, steps=STEPS,
                                       device=DEVICE)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    launches = build.LAUNCHES["dual_solve"]
    check(launches >= STEPS + 1, f"dual_solve launched {launches} times, "
          f"expected >= {STEPS + 1}")
    log("tuner: nominal sweep")
    t0 = time.time()
    nominal = core.tune_nominal_many(W.repeat(len(GRID_RHOS), 0), sys_t,
                                     n_starts=N_STARTS, steps=STEPS,
                                     device=DEVICE)
    torch.cuda.synchronize()
    t_nom = time.time() - t0
    costs = [r.cost for row in robust for r in row] \
        + [r.cost for r in nominal]
    check(all(c == c and 0 < c < float("inf") for c in costs),
          "tuner costs must be finite and positive")
    # the kernel path against the plain path on 6 cells, same starts
    cells = [(0, 0), (3, 1), (4, 4), (7, 2), (11, 0), (14, 3)]
    Wc = W[[w for w, _ in cells]]
    Rc = [GRID_RHOS[r] for _, r in cells]
    common = dict(design=core.DesignSpace.CLASSIC, sys=sys_t,
                  n_starts=N_STARTS, steps=STEPS, lr=0.25, robust=True,
                  seed=0, device=DEVICE)
    log("tuner: 6 cells, kernel and plain")
    kern = core.solve_grid(Wc, Rc, **common)[0]
    plain = core.solve_grid(Wc, Rc, dual_warm=ref_dual, **common)[0]
    rel = ((kern - plain).abs() / plain.abs()).max().item()
    check(rel <= 1e-4, f"tuner kernel vs plain exact cost rel {rel} > 1e-4")
    return {"phase": "tuner", "steps": STEPS,
            "lanes": len(W) * len(GRID_RHOS) * 2 * N_STARTS,
            "robust_sweep_first_s": times[0], "robust_sweep_s": times[1],
            "nominal_sweep_s": t_nom,
            "dual_solve_launches": launches,
            "six_cell_kernel_vs_plain_max_rel": rel,
            "six_cell_costs": kern.tolist(),
            "adam_step": adam_step_profile(torch, core)}


def adam_step_profile(torch, core, steps=(2, 12)) -> dict:
    """One robust Adam step of the sweep's lane batch (the Fig. 6 grid x
    ``GRID_RHOS``, CLASSIC, ``N_STARTS`` starts: 9,600 lanes), through
    ``core.solve_grid`` at two step counts, each in a profiler trace
    (``cuda_events``): what the extra steps add, over their number, is a
    step's CUDA kernels (``kernels_per_step``; copies and fills counted
    apart), their device ms, the ``dual_solve`` kernels and their device
    ms, and the host's wall ms.  Any tree's ``solve_grid`` takes these
    arguments."""
    import numpy as np
    sys_t = core.LSMSystem()
    W = np.repeat(core.EXPECTED_WORKLOADS.astype("float32"), len(GRID_RHOS),
                  0)
    rhos = np.tile(np.asarray(GRID_RHOS, np.float32),
                   len(core.EXPECTED_WORKLOADS))
    common = dict(design=core.DesignSpace.CLASSIC, sys=sys_t,
                  n_starts=N_STARTS, lr=0.25, robust=True, seed=0,
                  device=DEVICE)
    core.solve_grid(W, rhos, steps=steps[0], **common)
    runs = [cuda_events(torch, lambda s=s: core.solve_grid(
        W, rhos, steps=s, **common)) for s in steps]
    name = CUDA_NAMES["dual_solve"]

    def count(events, keep):
        mine = [us for n, us in events if keep(n)]
        return len(mine), sum(mine) / 1e3

    def per_step(keep):
        (n0, ms0), (n1, ms1) = (count(ev, keep) for _, ev in runs)
        return (n1 - n0) / (steps[1] - steps[0]), \
            (ms1 - ms0) / (steps[1] - steps[0])

    def is_copy(n):
        return n.startswith(("Memcpy", "Memset"))

    kernels, kernel_ms = per_step(lambda n: not is_copy(n))
    copies, copy_ms = per_step(is_copy)
    dual, dual_ms = per_step(lambda n: name in n)
    return {"lanes": len(W) * 2 * N_STARTS, "steps_traced": list(steps),
            "kernels_per_step": kernels, "device_ms_per_step": kernel_ms,
            "copies_per_step": copies, "copy_ms_per_step": copy_ms,
            "dual_solve_kernels_per_step": dual,
            "dual_solve_device_ms_per_step": dual_ms,
            "wall_ms_per_step": (runs[1][0] - runs[0][0]) * 1e3
            / (steps[1] - steps[0])}


# -- phase 2: the engine -------------------------------------------------------

def quickstart_tunings(core, quickstart):
    """Quickstart's nominal and robust tunings, tuned on the card."""
    sys_t = core.LSMSystem()
    rho = core.rho_from_history(quickstart.HISTORY)
    return {"nominal": core.tune_nominal(quickstart.EXPECTED, sys_t,
                                         n_starts=32, steps=150,
                                         device=DEVICE).phi,
            "robust": core.tune_robust(quickstart.EXPECTED, rho, sys_t,
                                       n_starts=32, steps=150,
                                       device=DEVICE).phi}


def deploy(core, lsm, phi, device, n):
    return lsm.LSMTree.from_phi(phi, core.LSMSystem(), expected_entries=n,
                                entry_bytes=64, device=device)


def answers(tree, keys, np):
    """Point answers and range results for a fixed probe set."""
    rng = np.random.default_rng(5)
    q = np.concatenate([rng.choice(keys, 2000),
                        rng.integers(0, 2 ** 48, 500).astype(np.uint64)])
    los = np.sort(rng.choice(keys, 50))
    return (tree.point_query_batch(q),
            tree.range_query_batch(los, los + np.uint64(2 ** 30),
                                   return_results=True))


def device_busy(torch, lsm, quickstart, tree, keys, n_queries=100_000):
    """The device's busy share over one more session on ``tree``: the sum
    of CUDA kernel times in a ``torch.profiler`` trace over the host wall
    time (None when the profiler records no device time)."""
    log("engine: profiled session")
    return {"queries": n_queries, **profile_device(
        torch, lambda: lsm.run_session(tree, keys, quickstart.BURST,
                                       n_queries=n_queries, seed=9))}


def populate_profile(torch, core, lsm, build, phi):
    """One more populate of the nominal tuning at ``N_ENTRIES`` in a
    ``torch.profiler`` trace: the engine's own merge calls.  Its busy share
    and top kernels, and the summed device time of its fold steps' kernels
    (``CUDA_NAMES["merge"]``), two for each launch of the wrapper: the
    trace must hold them all."""
    tree = deploy(core, lsm, phi, DEVICE, N_ENTRIES)
    log("engine: profiled populate")
    before = build.LAUNCHES["merge"]
    name = CUDA_NAMES["merge"]
    prof = profile_device(torch, lambda: lsm.populate(tree, N_ENTRIES,
                                                      seed=1), name)
    steps = build.LAUNCHES["merge"] - before
    check(steps > 0, "merge never launched in the profiled populate")
    if prof["device_s"] is not None:     # else the trace holds no event
        check(prof[f"{name}_count"] == 2 * steps, f"the profiled populate's"
              f" {steps} merge launches show {prof[f'{name}_count']} "
              f"*{name}* kernels")
    del tree
    return {"merge_steps": steps, "merge_device_ms": prof.pop(f"{name}_ms"),
            "merge_share": prof.pop(f"{name}_share"),
            "merge_kernels": prof.pop(f"{name}_count"), **prof}


def record_merges(build, merge_ops):
    """Wrap ``merge_ops.merge_newest_wins`` (the module attribute through
    which every compaction's ``merge_runs`` calls its fold steps) to record
    (na, nb) of each call that launched the kernels.  Returns the list and
    a function that puts the module's own function back."""
    sizes, inner = [], merge_ops.merge_newest_wins

    def recorded(a_keys, a_vals, b_keys, b_vals):
        before = build.LAUNCHES["merge"]
        out = inner(a_keys, a_vals, b_keys, b_vals)
        if build.LAUNCHES["merge"] > before:
            sizes.append((a_keys.numel(), b_keys.numel()))
        return out

    merge_ops.merge_newest_wins = recorded
    return sizes, lambda: setattr(merge_ops, "merge_newest_wins", inner)


#: the point read's sample work that a level's layout does, by tree: the
#: per-run builds and the packs of a layout (this tree), or a whole
#: level's ``sample_runs`` on every layout (a tree before the repair)
SAMPLE_FNS = (("run_sample", "pack_samples"), ("sample_runs",))


def record_reads(build, read_path, read_ops):
    """Wrap ``read_path._point_read`` (through which every read batch's
    per-level ``point_read_level`` launches the kernel) to keep the inputs
    (keys, arena keys and values, layout) of each call that launched it,
    and the tree's sample functions (``SAMPLE_FNS``), where it has them,
    to keep (name, arguments) of each call the store makes.  Returns both
    lists and a function that puts the modules' own functions back."""
    reads, samples = [], []
    inner = read_path._point_read
    names = next((ns for ns in SAMPLE_FNS
                  if all(hasattr(read_ops, n) for n in ns)), ())
    inner_fns = {n: getattr(read_ops, n) for n in names}

    def recorded(q, keys, vals, layout):
        before = build.LAUNCHES["point_read"]
        out = inner(q, keys, vals, layout)
        if build.LAUNCHES["point_read"] > before:
            reads.append((q, keys, vals, layout))
        return out

    def recorder(name, fn):
        def recorded_sample(*args, **kw):
            samples.append((name, tuple(list(a) if isinstance(a, list)
                                        else a for a in args), kw))
            return fn(*args, **kw)
        return recorded_sample

    read_path._point_read = recorded
    for n, fn in inner_fns.items():
        setattr(read_ops, n, recorder(n, fn))

    def unwrap():
        read_path._point_read = inner
        for n, fn in inner_fns.items():
            setattr(read_ops, n, fn)

    return reads, samples, unwrap


def engine_trees(torch, core, lsm, quickstart, build, merge_ops, read_path,
                 read_ops):
    """Quickstart's nominal and robust tunings deployed at ``N_ENTRIES``,
    each populated and run through a ``N_QUERIES`` session of the write
    burst, counting the kernels' launches and recording the path's merges
    and point reads.  Returns the trees, their keys, their rows, the
    launches, the merges' sizes, the reads' inputs and the samples
    built."""
    phis = quickstart_tunings(core, quickstart)
    trees = {name: deploy(core, lsm, phi, DEVICE, N_ENTRIES)
             for name, phi in phis.items()}
    build.reset_launches()
    merges, unwrap_merges = record_merges(build, merge_ops)
    reads, builds, unwrap_reads = record_reads(build, read_path, read_ops)
    rows, keys_of = {}, {}
    try:
        for name, tree in trees.items():
            log(f"engine: populate {name}")
            t0 = time.time()
            keys = lsm.populate(tree, N_ENTRIES, seed=1)
            torch.cuda.synchronize()
            t1 = time.time()
            log(f"engine: session {name}")
            res = lsm.run_session(tree, keys, quickstart.BURST,
                                  n_queries=N_QUERIES, seed=2)
            torch.cuda.synchronize()
            t2 = time.time()
            check(res.avg_io_per_query > 0 and res.queries == N_QUERIES,
                  f"{name}: empty session")
            check(tree.num_entries >= N_ENTRIES, f"{name}: entries lost")
            rows[name] = {
                "T": tree.cfg.T, "K": list(tree.cfg.K[:4]),
                "buf_entries": tree.cfg.buf_entries, "shape": [
                    (lv, len(runs), sum(runs)) for lv, runs in tree.shape()],
                "populate_s": t1 - t0, "session_s": t2 - t1,
                "avg_io_per_query": res.avg_io_per_query,
                "io": res.io.as_dict(),
                "arena_mb": sum(lv.keys.numel() + lv.vals.numel()
                                for lv in tree.store.levels) * 8 / 1e6}
            keys_of[name] = keys
        launches = dict(build.LAUNCHES)
    finally:
        unwrap_merges()
        unwrap_reads()
    check(len(reads) == launches["point_read"], f"recorded {len(reads)} of "
          f"the path's {launches['point_read']} point_read launches")
    return phis, trees, keys_of, rows, launches, merges, reads, builds


def phase_engine(torch, np, core, lsm, quickstart, build, merge_ops,
                 read_path, read_ops):
    """Returns the nominal tree and its keys, the sizes (na, nb) of the
    path's merges, its point reads' inputs, the samples it built, and the
    phase's JSON."""
    phis, trees, keys_of, rows, launches, merges, reads, builds = \
        engine_trees(torch, core, lsm, quickstart, build, merge_ops,
                     read_path, read_ops)
    out = {"phase": "engine", "entries": N_ENTRIES, "queries": N_QUERIES,
           "mix": quickstart.BURST.tolist(), "trees": rows,
           "launches": launches}
    for k in ("merge", "point_read"):
        check(launches[k] > 0, f"{k} never launched on the engine path")
    check(len(merges) == launches["merge"], f"recorded {len(merges)} of "
          f"the path's {launches['merge']} merge launches")
    totals = [na + nb for na, nb in merges]
    out["merge_path"] = {"launches": len(merges), "entries": sum(totals),
                         "max_entries": max(totals, default=0),
                         "sizes": [list(m) for m in merges]}
    out["read_path"] = {
        "launches": len(reads),
        "entries_runs_batch": [(k.numel(), layout.num_runs, q.numel())
                               for q, k, _, layout in reads],
        **sample_replay(torch, read_ops, builds)}
    out["device_busy"] = device_busy(torch, lsm, quickstart,
                                     trees["nominal"], keys_of["nominal"])
    out["populate_profile"] = populate_profile(torch, core, lsm, build,
                                               phis["nominal"])
    # the CPU plain path and the card, bit for bit, at 200K entries
    small = {}
    for dev in ("cpu", DEVICE):
        log(f"engine: 200K run on {dev}")
        tree = deploy(core, lsm, phis["robust"], dev, SMALL_ENTRIES)
        keys = lsm.populate(tree, SMALL_ENTRIES, seed=3)
        res = lsm.run_session(tree, keys, quickstart.BURST,
                              n_queries=SMALL_QUERIES, seed=4)
        small[dev] = (res.io.as_dict(), answers(tree, keys, np),
                      [(lv.keys.cpu(), lv.vals.cpu())
                       for lv in tree.store.levels])
    check(small["cpu"][0] == small[DEVICE][0], "IOStats: cpu != cuda")
    check(small["cpu"][1] == small[DEVICE][1], "answers: cpu != cuda")
    check(all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
              for a, b in zip(small["cpu"][2], small[DEVICE][2])),
          "arenas: cpu != cuda")
    out["cpu_vs_cuda_200k"] = {"identical": True, "io": small[DEVICE][0]}
    out["fleet_200k"] = fleet_check(np, core, lsm, quickstart, build, phis)
    return (trees["nominal"], keys_of["nominal"], merges, reads, builds,
            out)


def fleet_check(np, core, lsm, quickstart, build, phis) -> dict:
    """``run_policy_fleet``: quickstart's nominal and robust tunings x
    ``FLEET_POLICIES`` x the expected mix and the burst, at
    ``SMALL_ENTRIES`` and ``SMALL_QUERIES``, on the CPU plain path and on
    the card (launch counts set to 0 just before it): every ``IOStats``
    must be bit-identical, and the card's run must launch ``merge`` and
    ``point_read``."""
    mixes = np.stack([quickstart.EXPECTED, quickstart.BURST])
    args = ([phis["nominal"], phis["robust"]], core.LSMSystem(),
            FLEET_POLICIES, mixes)
    io, wall = {}, {}
    for dev in ("cpu", DEVICE):
        log(f"engine: 200K fleet on {dev}")
        build.reset_launches()
        t0 = time.time()
        _, res = lsm.run_policy_fleet(*args, n_keys=SMALL_ENTRIES,
                                      n_queries=SMALL_QUERIES, device=dev)
        wall[dev] = time.time() - t0
        io[dev] = [[[r.io.as_dict() for r in sess] for sess in pol]
                   for pol in res]
        avg = [[[r.avg_io_per_query for r in sess] for sess in pol]
               for pol in res]
    launches = {k: build.LAUNCHES[k] for k in ("merge", "point_read")}
    check(io["cpu"] == io[DEVICE], "fleet IOStats: cpu != cuda")
    check(all(launches.values()), f"the card's fleet launched {launches}")
    return {"identical": True, "tunings": ["nominal", "robust"],
            "policies": list(FLEET_POLICIES), "sessions": len(mixes),
            "avg_io_per_query": avg, "cpu_s": wall["cpu"],
            "cuda_s": wall[DEVICE], "launches": launches}


# -- phase 3: LM serving -------------------------------------------------------

def _to_f32(tree):
    if isinstance(tree, list):
        return [_to_f32(t) for t in tree]
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    return tree.detach().float()


def phase_serve(torch, np, configs, models, serve, lm, build, arch, kernel):
    """``arch`` at full width: ``serve_batch`` on the port's seeded bf16
    weights, counting ``kernel``'s launches, then the kernel path against
    the plain path on 2 float32 layers of the same weights."""
    cfg = configs.get_config(arch)
    if SERVE_REDUCED:
        cfg = cfg.reduced()
    log(f"serve: init {cfg.name}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    model = models.build_model(cfg, DEVICE, seed=0)
    torch.cuda.synchronize()
    t_init = time.time() - t0
    params = model.params
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    args = (arch, SERVE_REDUCED, SERVE_BATCH)
    log("serve: warm-up (prompt 128, 2 tokens)")
    serve.serve_batch(*args, 128, 2, seed=1, device=DEVICE, params=params)
    log(f"serve: batch {SERVE_BATCH}, prompt {SERVE_PROMPT}, "
        f"gen {SERVE_GEN}")
    build.reset_launches()
    out = serve.serve_batch(*args, SERVE_PROMPT, SERVE_GEN, seed=0,
                            device=DEVICE, params=params)
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(launches[kernel] == cfg.num_layers,
          f"{kernel} launched {launches[kernel]} times in one prefill, "
          f"expected {cfg.num_layers}")
    tc = launches[f"{kernel}:bf16_tc"]
    check(tc == cfg.num_layers, f"the bf16 tensor-core kernel served {tc} "
          f"of the prefill's {cfg.num_layers} {kernel} launches")
    toks = out["tokens"]
    check(toks.shape == (SERVE_BATCH, SERVE_GEN), f"tokens {toks.shape}")
    check(bool((toks >= 0).all() and (toks < cfg.vocab_size).all()),
          "a generated token lies outside the vocabulary")
    check(out["logits_finite"], "a logit is not finite")

    log("serve: profiled prefill and decode steps")
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT)), device=DEVICE)
    prefill_prof = profile_device(torch, lambda: model.prefill(tokens),
                                  CUDA_NAMES[kernel])
    cache = model.init_cache(SERVE_BATCH, SERVE_PROMPT + SERVE_GEN)
    step_tok = tokens[:, :1]

    def decode_steps(n=4):
        for i in range(n):
            model.decode_step(cache, step_tok, SERVE_PROMPT + i)

    decode_steps(1)
    decode_prof = profile_device(torch, decode_steps)
    del cache, tokens

    log(f"serve: {CHECK_LAYERS} float32 layers, kernel vs plain path")
    small = _to_f32({"embed": params["embed"],
                     "final_norm": params["final_norm"],
                     "lm_head": params["lm_head"],
                     "layers": params["layers"][:CHECK_LAYERS]})
    cfg32 = cfg.replace(num_layers=CHECK_LAYERS, dtype="float32",
                        param_dtype="float32")
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (SERVE_BATCH, CHECK_PROMPT))
    tokens = torch.as_tensor(prompts, dtype=torch.int64, device=DEVICE)
    build.reset_launches()
    with torch.no_grad():
        kern, _ = lm.lm_prefill(small, {"tokens": tokens}, cfg32)
        plain, _ = lm.lm_prefill(small, {"tokens": tokens},
                                 cfg32.replace(attention_impl="plain"))
    f32_launches = build.LAUNCHES[f"{kernel}:f32_cuda_core"]
    check(f32_launches == CHECK_LAYERS, f"the float32 {kernel} kernel "
          f"launched {f32_launches} times in {CHECK_LAYERS} float32 layers")
    diff = (kern - plain).abs().max().item()
    top = plain.abs().max().item()
    check(diff <= 1e-3 * top, f"{arch} prefill logits, kernel vs plain "
          f"path: max |diff| {diff} > 1e-3 * max |logit| {top}")
    del model, params, small, kern, plain
    torch.cuda.empty_cache()
    return {"phase": "serve", "arch": cfg.name, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "params": n_params,
            "batch": SERVE_BATCH, "prompt_len": SERVE_PROMPT,
            "gen": SERVE_GEN, "weight_gb": weight_bytes / 1e9,
            "cache_mb": out["kv_cache_bytes"] / 1e6,
            "peak_allocated_gb": peak / 1e9, "init_s": t_init,
            "prefill_s": out["prefill_s"], "decode_s": out["decode_s"],
            "decode_tok_per_s": out["tok_per_s"],
            "kernel": kernel, "kernel_launches": launches[kernel],
            "tokens_in_vocab": True, "logits_finite": True,
            "first_tokens": toks[0, :8].tolist(),
            "prefill_profile": prefill_prof,
            "decode_profile_4_steps": decode_prof,
            "f32_check": {"layers": CHECK_LAYERS, "prompt": CHECK_PROMPT,
                          "f32_kernel_launches": f32_launches,
                          "max_abs_diff": diff, "max_abs_logit": top,
                          "rel": diff / top}}


# -- phase 4: the blocked-Bloom probe ------------------------------------------

def phase_bloom(torch, np, ops, ref, build):
    """Build the deployment-size plane on the card and probe one read batch
    through ``ops.bloom_probe``.  Returns the plane, the probe keys, which
    of them were inserted, and the phase's JSON."""
    k = BLOOM_HASHES
    n_in = BLOOM_PROBES // 2
    rng = np.random.default_rng(6)
    t0 = time.time()
    keys = rng.choice(2 ** 32, BLOOM_KEYS + BLOOM_PROBES - n_in,
                      replace=False).astype(np.int64)
    order = rng.permutation(BLOOM_PROBES)
    inserted = np.zeros(BLOOM_PROBES, bool)
    inserted[:n_in] = True
    q = torch.from_numpy(np.concatenate(
        [keys[:n_in], keys[BLOOM_KEYS:]])[order]).to(DEVICE)
    inserted = torch.from_numpy(inserted[order]).to(DEVICE)
    t_keys = time.time() - t0
    num_blocks = -(-BLOOM_BITS_PER_KEY * BLOOM_KEYS // BLOOM_BLOCK_BITS)
    log(f"bloom: build a {num_blocks} x {BLOOM_BLOCK_BITS} plane")
    t0 = time.time()
    plane = ref.build_plane(torch.from_numpy(keys[:BLOOM_KEYS]), num_blocks,
                            BLOOM_BLOCK_BITS, k, device=DEVICE)
    torch.cuda.synchronize()
    t_build = time.time() - t0
    log(f"bloom: probe {BLOOM_PROBES} keys")
    build.reset_launches()
    t0 = time.time()
    member = ops.bloom_probe(q, plane, num_hashes=k)
    torch.cuda.synchronize()
    t_probe = time.time() - t0
    launches = build.LAUNCHES["bloom_probe"]
    check(launches > 0, "bloom_probe never launched on the bloom phase")
    same = torch.equal(member, ref.probe_ref(q, plane, k) > 0.5)
    check(same, "bloom_probe: kernel != plain on the 1 M-key batch")
    false_neg = int((~member & inserted).sum())
    fp_rate = member[~inserted].float().mean().item()
    check(false_neg == 0, f"bloom_probe: {false_neg} false negatives")
    check(0.005 <= fp_rate <= 0.02,
          f"bloom_probe: false-positive rate {fp_rate} outside [0.5%, 2%]")
    plane_bytes = plane.numel() * plane.element_size()
    log(f"bloom: plane {plane_bytes / 1e6:.1f} MB, fp rate {fp_rate}")
    return plane, q, inserted, {
        "phase": "bloom", "keys": BLOOM_KEYS, "num_blocks": num_blocks,
        "block_bits": BLOOM_BLOCK_BITS, "num_hashes": k,
        "plane_mb": plane_bytes / 1e6,
        "packed_bits_mb": plane.numel() / 8 / 1e6,
        "fill": plane.mean().item(), "probes": BLOOM_PROBES,
        "inserted_probes": n_in, "false_negatives": false_neg,
        "false_positive_rate": fp_rate, "kernel_vs_plain_identical": same,
        "keys_s": t_keys, "build_s": t_build, "probe_s": t_probe,
        "launches": launches}


# -- phase 5: each kernel against its plain version ----------------------------

def dual_inputs(torch, core, dev) -> tuple:
    """The tuner's step-0 lane batch (C, W, rho, log lambda): the Fig. 6
    grid x ``GRID_RHOS``, CLASSIC, ``N_STARTS`` starts, 9,600 lanes, the
    cost vectors of seeded starts and a cold solve's log lambda."""
    sys_t = core.LSMSystem()
    W = torch.tensor(core.EXPECTED_WORKLOADS, dtype=torch.float32)
    P = len(W) * len(GRID_RHOS)
    gen = torch.Generator().manual_seed(0)
    theta = core.designs.random_inits(gen, N_STARTS, core.DesignSpace.CLASSIC,
                                      sys_t).repeat(2 * P, 1).to(dev)
    pol = torch.cat([torch.zeros(N_STARTS), torch.ones(N_STARTS)]
                    ).repeat(P).to(dev)
    W_l = W.repeat_interleave(len(GRID_RHOS), 0).repeat_interleave(
        2 * N_STARTS, 0).to(dev)
    rho = torch.tensor(GRID_RHOS, dtype=torch.float32).repeat(
        len(W)).repeat_interleave(2 * N_STARTS).to(dev)
    C = core.cost_vector(core.to_phi_policy(theta, pol, sys_t), sys_t,
                         smooth=True)
    _, llam = core.dual_solve_cold(C, W_l, rho)
    return C, W_l, rho, llam


def dual_times(torch, ops, ref, C, W, rho, llam) -> dict:
    """The no-grad solve's times on the card, through the call every
    version of the port's wrapper takes (so ``--dual-solve`` times another
    tree's): CUDA-event ms per call, the kernel's device ms (``device_ms``)
    and the plain version's ms; and the share of lanes whose value and
    log lambda equal the plain version's bit for bit."""
    call = lambda: ops.dual_solve_warm_batch(C, W, rho, llam)  # noqa: E731
    v1, l1 = call()
    v2, l2 = ref.dual_solve_warm_ref(C, W, rho, llam)
    same = (v1 == v2) & (l1 == l2)
    return {"L": C.shape[0], "n": C.shape[1],
            "ms": time_ms(torch, call, 200),
            "device_ms": device_ms(torch, call, 50, CUDA_NAMES["dual_solve"]),
            "plain_ms": time_ms(torch, lambda: ref.dual_solve_warm_ref(
                C, W, rho, llam), 20),
            "bit_equal_lane_share": same.float().mean().item()}


def kernel_dual_solve(torch, core, ops, ref, dev):
    """The tuner's step-0 lane batch (``dual_inputs``, 9,600 lanes), and a
    ragged batch with rho = 0 lanes: values to rel 1e-5, 99% of log lambda
    within 1e-5, and the envelope gradient ``dc`` the kernel writes to rel
    1e-5; the share of lanes bit-equal to the plain version; the no-grad
    call timed (``dual_times``) and the tuner's call, with ``dc``, by its
    device ms."""
    C, W_l, rho, llam = dual_inputs(torch, core, dev)
    rows = []
    m = min(1237, C.shape[0])                  # ragged: not a block multiple
    rho_m = torch.where(torch.arange(m, device=dev) % 7 == 0, 0.0, rho[:m])
    for C_, W_, r_, l_ in ((C, W_l, rho, llam),
                           (C[:m], W_l[:m], rho_m, llam[:m])):
        v1, l1, dc1 = ops.dual_solve_warm_batch(C_, W_, r_, l_, grad=True)
        v2, l2, dc2 = ref.dual_solve_warm_ref(C_, W_, r_, l_, grad=True)
        rel = ((v1 - v2).abs() / v2.abs()).max().item()
        dl = (l1 - l2).abs()
        frac = (dl <= 1e-5).float().mean().item()
        # dc is the envelope gradient at the kernel's own lambda: held
        # against the plain formula there (a lane whose golden compare
        # flipped has its gradient at another lambda than the plain
        # version's), and against the plain dc where the lambdas agree
        def rel_err(a, b):
            d = (a - b).abs()
            return torch.where(d == 0, 0.0, d / b.abs()).max().item()

        dc_at = ref.envelope_grad(C_, W_, r_, l1)
        dc_rel = rel_err(dc1, dc_at)
        same_l = l1 == l2
        dc_plain_rel = rel_err(dc1[same_l], dc2[same_l])
        check(rel <= 1e-5, f"dual_solve value rel {rel} > 1e-5")
        check(frac >= 0.99 and dl.max().item() <= 0.1,
              f"dual_solve log lambda: {frac} within 1e-5, max {dl.max()}")
        check(dc_rel <= 1e-5 and dc_plain_rel <= 1e-5,
              f"dual_solve dc rel {dc_rel} (at the kernel's lambda), "
              f"{dc_plain_rel} (the plain dc, lambdas equal) > 1e-5")
        rows.append({"L": C_.shape[0], "val_max_rel": rel,
                     "val_max_abs": (v1 - v2).abs().max().item(),
                     "llam_frac_within_1e-5": frac,
                     "llam_max_abs": dl.max().item(),
                     "bit_equal_lane_share": ((v1 == v2) & (l1 == l2))
                     .float().mean().item(),
                     "dc_max_rel": dc_rel, "dc_plain_max_rel": dc_plain_rel,
                     "dc_max_abs": (dc1 - dc_at).abs().max().item()})
    L, n = C.shape
    evals = 3 + 2 + 6 + 1                       # g-evaluations per lane
    ops_per_g = 6 * n + 6                       # exp, div, add, max, sub, ...
    return {"name": "dual_solve", "route": "cuda",
            "source": "src/repro_torch/csrc/dual_solve.cu",
            "replaces": "src/repro/kernels/dual_solve/kernel.py:93",
            "max_abs_err": max(r["val_max_abs"] for r in rows),
            **dual_times(torch, ops, ref, C, W_l, rho, llam),
            "grad_device_ms": device_ms(
                torch, lambda: ops.dual_solve_warm_batch(
                    C, W_l, rho, llam, grad=True), 50,
                CUDA_NAMES["dual_solve"]),
            "library_ms": None,
            **bound(L * (2 * n + 2 + 2) * 4, L * evals * ops_per_g),
            "checks": rows}


def merge_pair(rng, np, torch, u64, dev, na, nb) -> tuple:
    """Runs A (``na`` keys, newer) and B (``nb``) for the merge, sorted,
    drawn without repeats from one pool of distinct uint64 keys 1.6x their
    total (so they share keys, as a compaction's runs do), in the engine's
    ordered int64 form; values A's index and B's plus 10^9."""
    pool = np.unique(rng.integers(0, 2 ** 64 - 1, int(1.6 * (na + nb)) + 8,
                                  dtype=np.uint64, endpoint=True))
    a = np.sort(rng.choice(pool, na, replace=False))
    b = np.sort(rng.choice(pool, nb, replace=False))
    return (u64.to_device_keys(a, dev), torch.arange(na, device=dev),
            u64.to_device_keys(b, dev), torch.arange(nb, device=dev) + 10 ** 9)


def kernel_merge(torch, np, ops, ref, u64, dev, path_sizes):
    """The fold step, ``merge_newest_wins`` (the tiled merge with the
    newest-wins drop fused in: what every compaction runs), and
    ``two_way_merge`` (the same kernels without the drop: the Pallas
    kernel's function) at 5 M + 5 M with duplicates (a compaction's shape
    at this scale), at ragged sizes, and on the 5 M runs as views one
    element into a buffer (8-byte aligned, not 16): each bit-identical to
    its plain version.  Then ``merge_times``, with the engine path's fold
    steps replayed at their recorded sizes ``path_sizes`` (na, nb)."""
    rng = np.random.default_rng(0)
    rows = []

    def hold(args, what):
        """Both entries against their plain versions on ``args``."""
        k1, v1 = ops.merge_newest_wins(*args)
        k2, v2 = ops.drop_adjacent_duplicates(*ref.two_way_merge_ref(*args))
        same = torch.equal(k1, k2) and torch.equal(v1, v2)
        check(same, f"merge step {what}: kernel != plain")
        t1, u1 = ops.two_way_merge(*args)
        t2, u2 = ref.two_way_merge_ref(*args)
        same_two = torch.equal(t1, t2) and torch.equal(u1, u2)
        check(same_two, f"two_way_merge {what}: kernel != plain")
        err = max([0] + [(x - y).abs().max().item() for x, y in
                         ((k1, k2), (v1, v2), (t1, t2), (u1, u2))
                         if x.numel()])
        rows.append({"case": what, "na": args[0].numel(),
                     "nb": args[2].numel(), "n_out": k1.numel(),
                     "equal_keys": int((t1[1:] == t1[:-1]).sum()),
                     "bit_identical": same and same_two, "max_abs_err": err})

    for na, nb in ((MERGE_N, MERGE_N), (1, 0), (0, 3), (999_983, 4_099),
                   (37, 1_000_003)):
        args = merge_pair(rng, np, torch, u64, dev, na, nb)
        hold(args, f"{na}+{nb}")
        if na == MERGE_N:
            big = args
    shifted = [torch.cat([t[:1], t])[1:] for t in big]
    check(all(t.data_ptr() % 16 == 8 for t in shifted), "misaligned views")
    hold(shifted, f"{MERGE_N}+{MERGE_N} misaligned views")
    del shifted

    def library():
        """A stable sort of both runs: ``two_way_merge``'s function (A
        first on equal keys), as one PyTorch call plus the value gather."""
        keys = torch.cat([big[0], big[2]])
        order = torch.sort(keys, stable=True).indices
        return keys[order], torch.cat([big[1], big[3]])[order]

    lk, lv = library()
    tk, tv = ops.two_way_merge(*big)
    check(torch.equal(lk, tk) and torch.equal(lv, tv),
          "merge: the library yardstick computes another function")
    del lk, lv, tk, tv
    times = merge_times(torch, ops, big, path_sizes)
    for key in ("kernels_per_step", "two_way_kernels"):
        check(times[key] == 2, f"merge: {times[key]} *{CUDA_NAMES['merge']}* "
              f"kernels a call in {key}, not the partition and the tile")
    check(times["path_kernels"] == 2 * len(path_sizes),
          "merge replay: not two merge kernels a step")
    return {"name": "merge", "route": "cuda",
            "source": "src/repro_torch/csrc/merge.cu",
            "replaces": "src/repro/kernels/merge/kernel.py:70",
            "function": "merge_newest_wins (one fold step)",
            "max_abs_err": max(r["max_abs_err"] for r in rows), **times,
            "plain_ms": time_ms(torch, lambda: ops.drop_adjacent_duplicates(
                *ref.two_way_merge_ref(*big)), 3),
            # no one PyTorch call merges with the newest-wins drop
            "library_ms": None,
            "two_way_plain_ms": time_ms(
                torch, lambda: ref.two_way_merge_ref(*big), 3),
            "two_way_library_ms": time_ms(torch, library, 10),
            "checks": rows}


def merge_times(torch, ops, big, sizes) -> dict:
    """The compaction merge's times on the card, through the calls every
    version of the port's merge wrapper takes (so ``--merge`` times
    another tree's): the fold step, ``merge_runs`` of the two runs ``big``
    (A newer), and ``two_way_merge`` on them, each by CUDA events per call
    and in a trace that holds every event (``per_call``: the
    ``CUDA_NAMES["merge"]`` kernels' device ms and count per call, and
    every device activity's), with their bounds; then the path's fold
    steps replayed at ``sizes``.  Bytes bound: each input entry's key and
    value read once, each output entry's written once; operations (a
    compare and a few selects per output, counted as 8 at the float32
    rate) never bind."""
    step = lambda: ops.merge_runs([big[0], big[2]],         # noqa: E731
                                  [big[1], big[3]])
    two = lambda: ops.two_way_merge(*big)                   # noqa: E731
    n, n_out = big[0].numel() + big[2].numel(), step()[0].numel()
    step_tr = per_call(torch, step, 10, CUDA_NAMES["merge"])
    two_tr = per_call(torch, two, 10, CUDA_NAMES["merge"])
    return {"na": big[0].numel(), "nb": big[2].numel(), "n_out": n_out,
            "ms": time_ms(torch, step, 20),
            "device_ms": step_tr["device_ms"],
            "kernels_per_step": step_tr["kernels"],
            "step_all_device_ms": step_tr["all_device_ms"],
            "step_activities": step_tr["activities"],
            **bound(16 * (n + n_out), n * 8),
            "two_way_ms": time_ms(torch, two, 20),
            "two_way_device_ms": two_tr["device_ms"],
            "two_way_kernels": two_tr["kernels"],
            "two_way_all_device_ms": two_tr["all_device_ms"],
            "two_way_bound_ms": bound(32 * n, n * 8)["bound_ms"],
            **merge_path_replay(torch, ops, big[0].device, sizes)}


def merge_path_replay(torch, ops, dev, sizes) -> dict:
    """The engine path's fold steps at their sizes: each (na, nb) as
    ``merge_runs`` of two fresh sorted random runs, made before the trace
    (so every device activity in it is a step's), all in one trace that
    holds every event (``cuda_events``, a step a call): the merge kernels'
    summed device time and count, and every activity's, against their
    bound: 16 bytes read per input entry and 16 written per kept one, over
    3.35 TB/s.  Nothing without ``sizes``."""
    if not sizes:
        return {}
    gen = torch.Generator(device=dev).manual_seed(4)

    def run(n):
        return torch.sort(torch.randint(-2 ** 62, 2 ** 62, (n,),
                                        generator=gen, device=dev)).values

    runs = [(run(na), torch.arange(na, device=dev), run(nb),
             torch.arange(nb, device=dev)) for na, nb in sizes]
    kept = []

    def replay():
        kept.clear()
        for ak, av, bk, bv in runs:
            kept.append(ops.merge_runs([ak, bk], [av, bv])[0].numel())

    replay()
    wall, events = cuda_events(torch, replay, calls=len(sizes))
    del runs
    name = CUDA_NAMES["merge"]
    path_ms = sum(us for n, us in events if name in n) / 1e3
    entries = sum(na + nb for na, nb in sizes)
    bound_ms = 16 * (entries + sum(kept)) / HBM_BYTES_PER_S * 1e3
    return {"path_launches": len(sizes), "path_entries": entries,
            "path_n_out": sum(kept),
            "path_max_entries": max(na + nb for na, nb in sizes),
            "path_device_ms": path_ms,
            "path_kernels": sum(name in n for n, _ in events),
            "path_all_device_ms": sum(us for _, us in events) / 1e3,
            "path_activities": len(events),
            "path_wall_ms": wall * 1e3, "path_bound_ms": bound_ms,
            "path_loss_ms": path_ms - bound_ms}


def load_sizes(path: str) -> list:
    """The (na, nb) of each merge the engine path launched: ``path`` holds
    a JSON list of pairs, or the output of a whole run (its engine
    line)."""
    text = Path(path).read_text()
    if text.lstrip().startswith("["):
        return [tuple(p) for p in json.loads(text)]
    for line in text.splitlines():
        if line.startswith("{") and '"phase": "engine"' in line:
            return [tuple(p) for p in json.loads(line)["merge_path"]["sizes"]]
    raise ValueError(f"{path}: no sizes and no engine line")


def merge_main(torch, np, sizes_file) -> int:
    """``--merge``: ``merge_times`` on the 5 M + 5 M pair the kernels
    phase draws first, and on the path's sizes in ``sizes_file`` (none
    without it); one JSON line, then the card's name and power limit."""
    from repro_torch.kernels import _build as build
    from repro_torch.kernels.merge import ops
    from repro_torch.utils import u64
    log(f"merge only, {Path(ops.__file__).parents[3]}")
    build.build(["merge"])
    big = merge_pair(np.random.default_rng(0), np, torch, u64, DEVICE,
                     MERGE_N, MERGE_N)
    sizes = load_sizes(sizes_file) if sizes_file else []
    emit({"phase": "merge", "src": str(Path(ops.__file__).parents[3]),
          **merge_times(torch, ops, big, sizes)})
    print(gpu_line(), flush=True)
    return 0


def read_batch(np, u64, keys, dev):
    """The kernels phase's read batch: 1 M keys, half of them drawn from
    the tree's keys and half absent (seed 1)."""
    rng = np.random.default_rng(1)
    hits = rng.choice(keys, READ_BATCH // 2)
    misses = rng.integers(0, 2 ** 48, READ_BATCH // 2).astype(np.uint64) | \
        np.uint64(1 << 60)
    return u64.to_device_keys(rng.permutation(np.concatenate([hits, misses])),
                              dev)


def read_bound(np, B, entries, ks, probes, reads) -> dict:
    """A point-read launch's bound.  Least bytes: each key in, 33 bytes of
    results out, one Bloom word per probe, one key and one value per
    positive run.  Operations (priced at the float32 rate, never binding):
    12 a hash a probe, 4 a halving of a plain search."""
    moved = B * (8 + 33) + probes * 8 + reads * 16
    return bound(moved, probes * max(ks, default=1) * 12
                 + reads * 4 * int(np.log2(entries + 1)))


def kernel_point_read(torch, np, ops, ref, u64, tree, keys, reads, builds,
                      dev):
    """The read batch against every level of the populated 10 M-entry
    tree, bit for bit against the plain version; then ``read_times``."""
    q = read_batch(np, u64, keys, dev)
    rows = []
    for i, lv in enumerate(tree.store.levels):
        if not lv.num_runs:
            continue
        pack = lv.pack
        got = ops.point_read_level(q, lv.keys, lv.vals, pack)
        want = ref.point_read_level_ref(q, lv.keys, lv.vals, pack.starts,
                                        pack.n_bits, pack.ks, pack.fence_lo,
                                        pack.fence_hi, pack.words,
                                        pack.word_off)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        check(same, f"point_read level {i + 1}: kernel != plain")
        rows.append({"level": i + 1, "runs": lv.num_runs,
                     "entries": lv.entries, "bit_identical": same,
                     "hits": int(got[0].sum()), "probes": int(got[2].sum()),
                     "reads": int(got[3].sum()), "fps": int(got[4].sum())})
    lv = [lv for lv in tree.store.levels if lv.num_runs][-1]
    pack = lv.pack
    return {"name": "point_read", "route": "cuda",
            "source": "src/repro_torch/csrc/point_read.cu",
            "replaces": "src/repro/kernels/point_read/kernel.py:115",
            "max_abs_err": 0,
            **read_times(torch, np, ops, tree, q, reads, builds),
            "plain_ms": time_ms(torch, lambda: ref.point_read_level_ref(
                q, lv.keys, lv.vals, pack.starts, pack.n_bits, pack.ks,
                pack.fence_lo, pack.fence_hi, pack.words, pack.word_off), 3),
            "library_ms": None, "checks": rows}


def read_times(torch, np, ops, tree, q, reads, builds) -> dict:
    """The point read's times on the card, through the calls every version
    of the port's wrapper takes (so ``--point-read`` times another
    tree's): the batch ``q`` against the tree's deepest level, by CUDA
    events per call and in a trace that holds every event (``per_call``),
    with its bound (``read_bound``); the engine path's launches replayed on
    their recorded inputs (``read_path_replay``); the samples the path
    built, rebuilt (``sample_replay``); and the tree's arena and sample
    sizes."""
    lv = [lv for lv in tree.store.levels if lv.num_runs][-1]
    pack = lv.pack
    call = lambda: ops.point_read_level(q, lv.keys, lv.vals,  # noqa: E731
                                        pack)
    got = call()
    tr = per_call(torch, call, 10, CUDA_NAMES["point_read"])
    check(tr["kernels"] == 1, f"point_read: {tr['kernels']} "
          f"*{CUDA_NAMES['point_read']}* kernels a call")
    packs = [lv.pack for lv in tree.store.levels if lv.num_runs]
    sample_mb = sum(getattr(p, t).numel() for p in packs
                    for t in ("sample", "top") if hasattr(p, t)) * 8 / 1e6
    return {"B": q.numel(), "level_entries": lv.entries,
            "level_runs": lv.num_runs, "hits": int(got[0].sum()),
            "positives": int(got[3].sum()),
            "ms": time_ms(torch, call, 20), "device_ms": tr["device_ms"],
            "all_device_ms": tr["all_device_ms"],
            **read_bound(np, q.numel(), lv.entries, pack.ks,
                         int(got[2].sum()), int(got[3].sum())),
            "tree_key_mb": sum(lv.keys.numel() for lv in tree.store.levels)
            * 8 / 1e6,
            "tree_arena_mb": sum(lv.keys.numel() + lv.vals.numel()
                                 for lv in tree.store.levels) * 8 / 1e6,
            "tree_sample_mb": sample_mb,
            **read_path_replay(torch, np, ops, reads),
            **sample_replay(torch, ops, builds)}


def read_path_replay(torch, np, ops, reads) -> dict:
    """The engine path's point-read launches replayed on their recorded
    inputs, all in one trace that holds every event (``cuda_events``, a
    launch a call): the kernels' summed device time and count against the
    launches' summed bounds (``read_bound``, from each launch's own
    counters).  Nothing without ``reads``."""
    if not reads:
        return {}
    bound_ms = 0.0
    for q, keys, vals, layout in reads:
        out = ops.point_read_level(q, keys, vals, layout)
        bound_ms += read_bound(np, q.numel(), keys.numel(), layout.ks,
                               int(out[2].sum()), int(out[3].sum()))[
                                   "bound_ms"]

    def replay():
        for q, keys, vals, layout in reads:
            ops.point_read_level(q, keys, vals, layout)

    # the launches' kernels differ in name (their KMAX), so a trace is
    # whole when it holds one point_read kernel a launch
    name = CUDA_NAMES["point_read"]
    for _ in range(3):
        wall, events = cuda_events(torch, replay, tries=1)
        if sum(name in n for n, _ in events) == len(reads):
            break
    check(sum(name in n for n, _ in events) == len(reads),
          "point_read replay: traces miss launches")
    path_ms = sum(us for n, us in events if name in n) / 1e3
    return {"path_launches": len(reads),
            "path_keys": sum(q.numel() for q, *_ in reads),
            "path_device_ms": path_ms,
            "path_kernels": sum(name in n for n, _ in events),
            "path_wall_ms": wall * 1e3, "path_bound_ms": bound_ms,
            "path_loss_ms": path_ms - bound_ms}


def sample_replay(torch, ops, samples) -> dict:
    """The sample work the engine path did (``record_reads``), replayed
    on its recorded arguments in a trace each: the builds (``run_sample``
    of a new run, or an older tree's ``sample_runs`` of a whole level),
    their count, the arena keys they read, the entries they made and
    their summed device time (every device activity: strided copies, pads
    and concatenations); then the packs of a layout (``pack_samples``),
    their count and device time; and the two times' sum."""
    builds = [c for c in samples if c[0] != "pack_samples"]
    packs = [c for c in samples if c[0] == "pack_samples"]

    def run(calls):
        return [getattr(ops, n)(*args, **kw) for n, args, kw in calls]

    def traced(calls, tries=3):
        if not calls:
            return 0.0, 0.0, 0
        wall, events = cuda_events(torch, lambda: run(calls), tries=tries)
        return sum(us for _, us in events) / 1e3, wall * 1e3, len(events)

    made = run(builds)
    build_ms, build_wall, build_acts = traced(builds)
    # a layout of one run's sample is views of it, launching nothing:
    # one trace, not three
    pack_ms, pack_wall, pack_acts = traced(packs, tries=1)
    return {"sample_builds": len(builds),
            "sample_build_keys": sum(args[0].numel() for _, args, _ in
                                     builds),
            "sample_build_entries": sum(
                o.numel() if torch.is_tensor(o)
                else o["sample"].numel() + o["top"].numel() for o in made),
            "sample_build_device_ms": build_ms,
            "sample_build_activities": build_acts,
            "sample_build_wall_ms": build_wall,
            "sample_packs": len(packs), "sample_pack_device_ms": pack_ms,
            "sample_pack_activities": pack_acts,
            "sample_pack_wall_ms": pack_wall,
            "sample_device_ms": build_ms + pack_ms}


def point_read_main(torch, np) -> int:
    """``--point-read``: the engine phase's trees on the ``repro_torch``
    under ``--src``, their path's point reads recorded, then
    ``read_times`` on the nominal tree; one JSON line, then the card's
    name and power limit."""
    import repro_torch.core as core
    import repro_torch.lsm as lsm
    from repro_torch import quickstart
    from repro_torch.kernels import _build as build
    from repro_torch.kernels.merge import ops as merge_ops
    from repro_torch.kernels.point_read import ops
    from repro_torch.lsm import read_path
    from repro_torch.utils import u64
    src = str(Path(ops.__file__).parents[3])
    log(f"point_read only, {src}")
    build.build(["merge", "point_read", "dual_solve"])
    _, trees, keys_of, rows, launches, _, reads, builds = engine_trees(
        torch, core, lsm, quickstart, build, merge_ops, read_path, ops)
    tree = trees["nominal"]
    q = read_batch(np, u64, keys_of["nominal"], DEVICE)
    emit({"phase": "point_read", "src": src,
          "avg_io_per_query": {n: r["avg_io_per_query"]
                               for n, r in rows.items()},
          "session_s": {n: r["session_s"] for n, r in rows.items()},
          "launches": launches["point_read"],
          **read_times(torch, np, ops, tree, q, reads, builds)})
    print(gpu_line(), flush=True)
    return 0


def kernel_flash_attention(torch, configs, ops, ref, build, dev, arch):
    """The serving prefill's shape (B 4, S 2048, H 40, KV 8, d 128, bf16,
    causal) and the bf16 cases of ``FLASH_BF16_CASES`` (a ragged S, d 96
    with H = KV, a GQA group of 16, a 512 window) to 2e-2, and the float32
    cases of ``FLASH_F32_CASES`` (d 64 with a 512 window, d 96 non-causal,
    a ragged S) to 2e-5; each case names the kernel whose launch count
    moved (``bf16_tc`` or ``f32_cuda_core``)."""
    F = torch.nn.functional
    g = torch.Generator(device=dev).manual_seed(0)

    def draw(B, S, H, KV, d, dtype):
        return [torch.randn((B, S, n, d), generator=g, device=dev).to(dtype)
                for n in (H, KV, KV)]

    def heads(name):
        c = configs.get_config(name)
        return (SERVE_BATCH, SERVE_PROMPT, c.num_heads, c.num_kv_heads,
                c.head_dim)

    bf16 = [(heads(arch), True, None)] + [
        (heads(shape) if isinstance(shape, str) else shape, causal, window)
        for shape, causal, window in FLASH_BF16_CASES]
    cases = [(shape, torch.bfloat16, causal, window, 2e-2)
             for shape, causal, window in bf16] + [
        (shape, torch.float32, causal, window, 2e-5)
        for shape, causal, window in FLASH_F32_CASES]
    rows = []
    for shape, dtype, causal, window, tol in cases:
        q, k, v = draw(*shape, dtype)
        before = dict(build.LAUNCHES)
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        served = [name.split(":")[1] for name in build.VARIANTS
                  if build.LAUNCHES[name] > before[name]]
        want = ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window)
        err = (got.float() - want.float()).abs()
        ok = bool((err <= tol + tol * want.float().abs()).all())
        check(ok, f"flash_attention {shape} {dtype}: kernel != plain "
              f"(max abs {err.max().item()})")
        expect = "bf16_tc" if dtype == torch.bfloat16 else "f32_cuda_core"
        check(served == [expect], f"flash_attention {shape} {dtype}: "
              f"served by {served}, expected {expect}")
        rows.append({"B_S_H_KV_d": list(shape), "dtype": str(dtype),
                     "causal": causal, "window": window, "tol": tol,
                     "kernel": served[0], "max_abs_err": err.max().item()})
        if len(rows) == 1:
            main = (q, k, v, got)
        del q, k, v, got, want, err
    q, k, v, out = main
    B, S, H, d = q.shape
    KV = k.shape[2]

    def sdpa(q, k, v, causal):
        """PyTorch's fused attention on the same (B, S, n, d) inputs."""
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        try:
            F.scaled_dot_product_attention(qt[:, :, :1], kt[:, :, :1],
                                           vt[:, :, :1], enable_gqa=True)
            extra = {"enable_gqa": True}
        except TypeError:               # a PyTorch without enable_gqa
            kt, vt = (t.repeat_interleave(qt.shape[1] // kt.shape[1], dim=1)
                      for t in (kt, vt))
            extra = {}
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, **extra)

    library = sdpa(q, k, v, True)
    lib_err = (library().transpose(1, 2).float() - out.float()).abs().max()
    check(lib_err.item() <= 0.1, f"flash_attention: the library yardstick "
          f"computes another function (max abs {lib_err.item()})")
    pairs = B * H * S * (S + 1) // 2            # causal: unmasked (q, k)
    moved = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    call = lambda: ops.flash_attention(q, k, v, causal=True)  # noqa: E731
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_wgmma.cu",
            "f32_source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:96",
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": time_ms(torch, call, 10),
            "device_ms": device_ms(torch, call, 5,
                                   CUDA_NAMES["flash_attention"]),
            "plain_ms": time_ms(torch, lambda: ref.flash_attention_ref(
                q, k, v, causal=True), 3),
            "library_ms": time_ms(torch, library, 10),
            "library_max_abs_diff": lib_err.item(),
            # one 8192-token sequence, not causal: each q tile reads 64 kv
            # tiles, so the per-tile rate shows without the start-up cost
            # of the serving shape's short causal tiles
            **long_sequence(torch, ops, sdpa, draw, H, KV, d),
            **bound(moved, pairs * 4 * d, BF16_OPS_PER_S), "checks": rows}


def long_sequence(torch, ops, sdpa, draw, H, KV, d, S=8192) -> dict:
    """The kernel's and SDPA's time on one long bf16 sequence, not
    causal, and the kernel's rate in TFLOP/s."""
    q, k, v = draw(1, S, H, KV, d, torch.bfloat16)
    call, library = (lambda: ops.flash_attention(q, k, v, causal=False),
                     sdpa(q, k, v, False))
    diff = (call().float() - library().transpose(1, 2).float()).abs().max()
    check(diff.item() <= 0.1, f"flash_attention at S {S}: kernel and SDPA "
          f"differ by {diff.item()}")
    ms, lib = time_ms(torch, call, 5), time_ms(torch, library, 5)
    return {"long_B_S_H_KV_d": [1, S, H, KV, d], "long_ms": ms,
            "long_library_ms": lib,
            "long_tflops": 4 * d * H * S * S / ms / 1e9}


def kernel_rwkv6(torch, configs, ops, ref, build, dev, arch):
    """Two rows.  ``rwkv6``: the bf16 tensor-core kernel at the serving
    prefill's shape (B 4, S 2048, H 40, n 64, r/k/v bf16, logw float32)
    at the model's, a slow and a fast decay (``RWKV_DECAYS``), to 5e-2,
    timed at the model's.  ``rwkv6:f32_cuda_core``: the per-step float32
    kernel at the cases of ``RWKV_F32_CASES`` (slow decay, n 32, three
    chunks), to 5e-4, timed at the first.  Both on y and the final state;
    each case names the kernel whose launch count moved."""
    g = torch.Generator(device=dev).manual_seed(0)

    def draw(B, S, H, n, dtype, decay):
        """r/k/v ~ N(0, 1) as the projections of a normed input are;
        logw = -exp(ww), ww ~ mean + sd N(0, 1) (the model's w_base is
        -0.6 + 0.5 N); u ~ 0.1 N(0, 1) as its init."""
        rkv = [torch.randn((B, S, H, n), generator=g, device=dev).to(dtype)
               for _ in range(3)]
        mean, sd = RWKV_DECAYS[decay]
        ww = torch.randn((B, S, H, n), generator=g, device=dev) * sd + mean
        u = torch.randn((H, n), generator=g, device=dev) * 0.1
        return (*rkv, -torch.exp(ww), u)

    cfg = configs.get_config(arch)
    n = cfg.rwkv_head_dim
    prefill = (SERVE_BATCH, SERVE_PROMPT, cfg.d_model // n, n)
    cases = [(prefill, torch.bfloat16, decay, 5e-2)
             for decay in RWKV_DECAYS] + [
        (shape, torch.float32, decay, 5e-4)
        for shape, decay in RWKV_F32_CASES]
    rows = {torch.bfloat16: [], torch.float32: []}
    timed = {}
    for shape, dtype, decay, tol in cases:
        args = draw(*shape, dtype, decay)
        before = dict(build.LAUNCHES)
        got = ops.rwkv6(*args)
        served = [name.split(":")[1] for name in build.VARIANTS
                  if name.startswith("rwkv6:")
                  and build.LAUNCHES[name] > before[name]]
        expect = "bf16_tc" if dtype == torch.bfloat16 else "f32_cuda_core"
        check(served == [expect], f"rwkv6 {shape} {dtype}: served by "
              f"{served}, expected {expect}")
        want = ref.rwkv6_ref(*args)
        errs = []
        for a, b, what in zip(got, want, ("y", "state")):
            err = (a - b).abs()
            check(bool((err <= tol + tol * b.abs()).all()),
                  f"rwkv6 {shape} {dtype} {decay}: kernel != plain on "
                  f"{what} (max abs {err.max().item()})")
            errs.append(err.max().item())
        rows[dtype].append({
            "B_S_H_n": list(shape), "dtype": str(dtype), "decay": decay,
            "tol": tol, "kernel": expect, "y_max_abs_err": errs[0],
            "state_max_abs_err": errs[1],
            "y_max_abs": want[0].abs().max().item()})
        timed.setdefault(dtype, args)
        del args, got, want

    def max_err(dtype):
        return max(max(rw["y_max_abs_err"], rw["state_max_abs_err"])
                   for rw in rows[dtype])

    out = []
    for dtype in (torch.bfloat16, torch.float32):
        args = timed[dtype]
        r, k, v, logw, u = args
        B, S, H, n = r.shape
        # least bytes: r/k/v in their dtype, logw in, y out, the state
        # out; operations: per token and head, the bf16 kernel's chunked
        # products (2n^2 each for r S and the state update, C n each for
        # the intra-chunk matrix and its product with v at C = 32, on
        # average half a chunk) at the bf16 tensor-core rate, the float32
        # kernel's step (4n^2) at the float32 rate
        moved = (3 * r.numel() * r.element_size() + 4 * logw.numel()
                 + 4 * u.numel() + 4 * r.numel() + 4 * B * H * n * n)
        call = lambda: ops.rwkv6(*args)  # noqa: E731
        if dtype == torch.bfloat16:
            row = {"name": "rwkv6",
                   "source": "src/repro_torch/csrc/rwkv6_mma.cu",
                   **bound(moved, B * S * H * (4 * n * n + 2 * 32 * n),
                           BF16_OPS_PER_S)}
            # one (batch, head) alone: the card is nearly idle, so this is
            # the latency of the sequence's chunks in order
            one = [t[:1, :, :1] for t in args[:4]] + [u[:1]]
            row["one_head_ms"] = time_ms(torch, lambda: ops.rwkv6(*one), 20)
        else:
            row = {"name": "rwkv6:f32_cuda_core",
                   "source": "src/repro_torch/csrc/rwkv6.cu",
                   **bound(moved, B * S * H * 4 * n * n)}
        out.append({
            **row, "route": "cuda",
            "replaces": "src/repro/kernels/rwkv6/kernel.py:74",
            "B_S_H_n": [B, S, H, n], "max_abs_err": max_err(dtype),
            "ms": time_ms(torch, call, 20),
            "device_ms": device_ms(torch, call, 10, CUDA_NAMES[row["name"]]),
            "plain_ms": time_ms(torch, lambda: ref.rwkv6_ref(*args), 2),
            "library_ms": None, "checks": rows[dtype]})
    return out


def kernel_bloom_probe(torch, ops, ref, plane, q, inserted):
    """The bloom phase's 1 M-key batch against its 400 MB plane, and
    ragged batches of 1 and 1,001 keys, bit for bit; the plane floats the
    kernel read a key, present and absent (``bloom_loads``)."""
    k = BLOOM_HASHES
    rows = []
    for n in (1, 1001, q.numel()):
        got = ops.bloom_probe_kernel(q[:n], plane, num_hashes=k)
        want = ref.probe_ref(q[:n], plane, k)
        same = torch.equal(got, want)
        check(same, f"bloom_probe N={n}: kernel != plain")
        rows.append({"N": n, "bit_identical": same,
                     "max_abs_err": (got - want).abs().max().item(),
                     "members": int(got.sum().item())})
    N = q.numel()
    call = lambda: ops.bloom_probe_kernel(q, plane, num_hashes=k)  # noqa: E731
    # least bytes: a 4-byte key in (the function's uint32; the port's int64
    # reads 8), a 4-byte result out, and the 4-byte plane floats this run's
    # keys need: each key's floats up to its first zero (all k for a key
    # that passes), since the product is 0 from there on the 0/1 plane.  A
    # gather really pays a 32-byte sector (or more) per float from a plane
    # 8x the L2; PERF.md sets that against the measured time.  Operations:
    # a mix32 of 10 integer ops and a `%` counted as one for the block and
    # each float read, priced at the float32 rate: a loose lower figure (a
    # 32-bit `%` by a runtime divisor takes tens of instructions, and the
    # INT32 rate is about half the float32 one) which never binds here.
    needed = int(ref.probe_loads_ref(q, plane, k).sum())
    return {"name": "bloom_probe", "route": "cuda",
            "source": "src/repro_torch/csrc/bloom_probe.cu",
            "replaces": "src/repro/kernels/bloom_probe/kernel.py:63",
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": time_ms(torch, call, 50),
            "device_ms": device_ms(torch, call, 20, CUDA_NAMES["bloom_probe"]),
            "plain_ms": time_ms(torch, lambda: ref.probe_ref(q, plane, k),
                                10),
            "library_ms": None, "needed_floats": needed,
            **bound(N * (4 + 4) + 4 * needed, (N + needed) * 11),
            "all_k_bound_ms": bound(N * (4 + 4 + 4 * k),
                                    N * (k + 1) * 11)["bound_ms"],
            **bloom_loads(torch, ops, ref, plane, q, inserted, k),
            "checks": rows}


def bloom_loads(torch, ops, ref, plane, q, inserted, k) -> dict:
    """The plane floats the kernel reads a key, as it counts them (``ops.bloom_probe_loads``), for the inserted and the
    absent keys; the count must be ``ref.probe_loads_ref``'s and the
    membership the plain version's.  Nothing for a tree without it."""
    if not hasattr(ops, "bloom_probe_loads"):
        return {}
    member, loads = ops.bloom_probe_loads(q, plane, k)
    check(torch.equal(member, ref.probe_ref(q, plane, k)),
          "bloom_probe_loads: kernel != plain")
    check(torch.equal(loads, ref.probe_loads_ref(q, plane, k)),
          "bloom_probe_loads: the kernel's count != probe_loads_ref's")
    absent = loads[~inserted].float()
    return {"loads_per_present_key": loads[inserted].float().mean().item(),
            "loads_per_absent_key": absent.mean().item(),
            "loads_per_key": loads.float().mean().item(),
            "loads_total": int(loads.sum())}


def bloom_main(torch, np) -> int:
    """``--bloom``: the bloom phase's plane and 1 M probe keys on the
    ``repro_torch`` under ``--src``: the kernel's device ms and, where the
    tree counts them, its loads a key; one JSON line, then the card's name
    and power limit."""
    from repro_torch.kernels import _build as build
    from repro_torch.kernels.bloom_probe import ops, ref
    src = str(Path(ops.__file__).parents[3])
    log(f"bloom only, {src}")
    build.build(["bloom_probe"])
    plane, q, inserted, phase = phase_bloom(torch, np, ops, ref, build)
    k = BLOOM_HASHES
    name = CUDA_NAMES["bloom_probe"]
    call = lambda: ops.bloom_probe_kernel(q, plane, num_hashes=k)  # noqa: E731
    out = {"phase": "bloom_turn", "src": src,
           "false_positive_rate": phase["false_positive_rate"],
           "ms": time_ms(torch, call, 50),
           "device_ms": device_ms(torch, call, 20, name)}
    out.update(bloom_loads(torch, ops, ref, plane, q, inserted, k))
    emit(out)
    print(gpu_line(), flush=True)
    return 0


def dual_test_cases(torch, np, ops, ref) -> dict:
    """``tests/test_torch_cuda.py::test_dual_solve_groups_and_dc_match_plain``'s
    inputs (L in 1, 127, 1237, 9600; n in 1, 4, 5, 16; seed L * 31 + n), so
    that any tree's kernel can be read on them: per case the largest
    |log lambda - the plain version's| and the share of lanes within
    1e-5."""
    out = {}
    for L in (1, 127, 1237, 9600):
        for n in (1, 4, 5, 16):
            rng = np.random.default_rng(L * 31 + n)
            C = torch.tensor(rng.gamma(2.0, 2.0, (L, n)),
                             dtype=torch.float32, device=DEVICE)
            W = torch.tensor(rng.dirichlet(np.ones(n), L),
                             dtype=torch.float32, device=DEVICE)
            rho = torch.tensor(rng.uniform(0, 3, L), dtype=torch.float32,
                               device=DEVICE)
            rho[::5] = 0.0
            llam = torch.tensor(rng.normal(1.0, 1.5, L),
                                dtype=torch.float32, device=DEVICE)
            dl = (ops.dual_solve_warm_batch(C, W, rho, llam)[1]
                  - ref.dual_solve_warm_ref(C, W, rho, llam)[1]).abs()
            out[f"L{L}_n{n}"] = {
                "llam_max_abs": dl.max().item(),
                "llam_frac_within_1e-5": (dl <= 1e-5).float().mean().item()}
    return out


def dual_solve_main(torch, np) -> int:
    """``--dual-solve``: the dual solve on the ``repro_torch`` under
    ``--src``: ``dual_times`` on the tuner's 9,600 lanes, the card's
    launch floor, the card test's cases (``dual_test_cases``), a robust Adam step (``adam_step_profile``) and the
    robust sweep's steady wall time; one JSON line, then the card's name
    and power limit."""
    import repro_torch.core as core
    from repro_torch.kernels import _build as build
    from repro_torch.kernels.dual_solve import ops, ref
    src = str(Path(ops.__file__).parents[3])
    log(f"dual_solve only, {src}")
    build.build(["dual_solve"])
    W = core.EXPECTED_WORKLOADS.astype("float32")
    sweeps = []
    for _ in range(2):
        t0 = time.time()
        core.tune_robust_many(W, GRID_RHOS, core.LSMSystem(),
                              n_starts=N_STARTS, steps=STEPS, device=DEVICE)
        torch.cuda.synchronize()
        sweeps.append(time.time() - t0)
    args = dual_inputs(torch, core, DEVICE)
    name = CUDA_NAMES["dual_solve"]
    # device ms by chain length: n_golden dependent evaluations after the
    # scan and (a0, b0), with one scan point and with the three
    chain = {f"n_local_{nl}_n_golden_{ng}": device_ms(
        torch, lambda nl=nl, ng=ng: ops.dual_solve_warm_batch(
            *args, 0.8, nl, ng), 50, name)
        for nl in (1, 3) for ng in (0, 3, 6, 12)}
    emit({"phase": "dual_solve", "src": src,
          **dual_times(torch, ops, ref, *args), "chain_device_ms": chain,
          "launch_floor_ms": launch_floor_ms(torch),
          "test_cases": dual_test_cases(torch, np, ops, ref),
          "adam_step": adam_step_profile(torch, core),
          "robust_sweep_first_s": sweeps[0], "robust_sweep_s": sweeps[1]})
    print(gpu_line(), flush=True)
    return 0


# -- phase 6: the paper suites ----------------------------------------------

def expected_dual_launches(suite: str, fig10, tuner) -> int:
    """``dual_solve`` launches a suite makes: one per robust Adam step plus
    one for the final iterate, per robust tuning.  fig10: one tuning per
    entry size; tuner: the Fig. 6 grid's warm-up pair, its batched call
    and one call per cell (the seed style solves its dual in torch ops);
    the API suites: their one robust grid."""
    if suite == "fig10":
        return len(fig10.ENTRY_BITS) * (fig10.STEPS + 1)
    if suite == "tuner":
        return (len(tuner.GRID_WORKLOADS) * len(tuner.GRID_RHOS) + 3) \
            * (tuner.GRID_STEPS + 1)
    if suite in API_SUITES:
        import importlib
        return importlib.import_module(f"repro_torch.bench.{suite}").STEPS \
            + 1
    return 0


def fig10_profiled_launches(torch, core, build, fig10, starts) -> dict:
    """One fig10 robust call (both workloads at the smallest entry size)
    in a profiler trace: the ``dual_solve`` kernels the trace records and
    the wrapper's count, each of which must be its steps + 1.  A trace
    that records fewer than the wrapper counted (late in this script a
    trace can drop a launch) is taken again, up to three times."""
    sys_e = core.LSMSystem(entry_bits=float(fig10.ENTRY_BITS[0]))
    fig10.robust_tunings(sys_e, DEVICE, starts)          # warm
    name = CUDA_NAMES["dual_solve"]
    for attempt in range(3):
        build.reset_launches()
        _, events = cuda_events(torch, lambda: fig10.robust_tunings(
            sys_e, DEVICE, starts), tries=1)
        wrapper = build.LAUNCHES["dual_solve"]
        traced = sum(name in n for n, _ in events)
        if traced == wrapper:
            break
        log(f"suites: fig10 trace {attempt + 1} holds {traced} of "
            f"{wrapper} dual_solve launches")
    check(wrapper == traced == fig10.STEPS + 1, f"one fig10 robust call: "
          f"{wrapper} dual_solve launches counted, {traced} traced, "
          f"expected {fig10.STEPS + 1}")
    return {"steps": fig10.STEPS, "wrapper": wrapper, "profiled": traced}


def phase_suites(torch, core, build, suites=SUITES) -> list:
    """Each of ``suites`` through ``repro_torch.bench.run.run_suite`` on
    the card, from the committed files' starts, with the launch counts set
    to 0 just before it; returns one JSON line per suite.  A missed held
    field, a missing row or key, or a ``dual_solve`` count other than
    :func:`expected_dual_launches` fails the phase."""
    from repro_torch.bench import fig10, run, tuner
    from repro_torch.bench.common import committed_starts
    lines = []
    for suite in suites:
        log(f"suites: {suite}")
        build.reset_launches()
        res = run.run_suite(suite, device=DEVICE, baseline_dir=ROOT,
                            starts=committed_starts)
        launches = {k: v for k, v in build.LAUNCHES.items() if v}
        cmp = res["comparison"]
        line = {"phase": "suites", "suite": suite, "starts": "committed",
                "wall_s": res["wall_s"],
                "rows": {r.name: r.derived for r in res["rows"]},
                "held_matched": len(cmp["held"]),
                "held_missed": [list(m) for m in cmp["missed"]],
                "time_fields": {f: v for f, v, _ in cmp["time"]},
                "spreads": {f: [v, w] for f, v, w in cmp["spread"]},
                "launches": launches}
        if suite == "fig10":
            line["fig10_robust_call"] = fig10_profiled_launches(
                torch, core, build, fig10, committed_starts)
        lines.append(line)
        emit(line)
        check(not cmp["missed"], f"suite {suite}: held fields missed "
              f"{cmp['missed']}")
        check(len(cmp["held"]) == SUITE_HELD[suite], f"suite {suite}: "
              f"{len(cmp['held'])} held fields, expected {SUITE_HELD[suite]}")
        want = expected_dual_launches(suite, fig10, tuner)
        check(launches.get("dual_solve", 0) == want, f"suite {suite}: "
              f"{launches.get('dual_solve', 0)} dual_solve launches, "
              f"expected {want}")
    return lines


def phase_api(torch, build) -> dict:
    """The experiment API on the card: ``run_experiment`` for
    ``API_SPEC`` (its tunings and its trial on the card, the launch counts
    set to 0 just before it), then that spec's ``TrialPlan`` through
    ``execute_trial`` on the card and on the CPU plain path.  Every tree's
    ``IOStats``, I/O per query and ``TreeProbe`` must be bit-identical on
    both and equal the report's own trial; the card's trial must launch
    ``merge`` and ``point_read``, and the tunings one ``dual_solve`` per
    robust Adam step plus one, for each of the spec's two robust grids."""
    import dataclasses

    import repro_torch.api as api
    spec = api.ExperimentSpec.from_dict(API_SPEC)
    log("api: run_experiment on the card")
    build.reset_launches()
    t0 = time.time()
    report = api.run_experiment(spec, device=DEVICE)
    torch.cuda.synchronize()
    run_s = time.time() - t0
    run_launches = {k: v for k, v in build.LAUNCHES.items() if v}
    want = len(api.compile_spec(spec).tuning_plans()) \
        * (spec.design.steps + 1)
    check(run_launches.get("dual_solve", 0) == want, f"api run_experiment: "
          f"{run_launches.get('dual_solve', 0)} dual_solve launches, "
          f"expected {want}")
    plan = api.compile_spec(spec).build_trial(report)
    trial = {}
    for dev in (DEVICE, "cpu"):
        log(f"api: execute_trial on {dev}")
        build.reset_launches()
        t0 = time.time()
        results, probes, populate_s, fleet_s = api.execute_trial(
            plan, device=dev)
        if dev != "cpu":
            torch.cuda.synchronize()
        trial[dev] = {
            "wall_s": time.time() - t0, "populate_s": populate_s,
            "fleet_s": fleet_s,
            "launches": {k: build.LAUNCHES[k]
                         for k in ("merge", "point_read")},
            "io": [[r.io.as_dict() for r in row] for row in results],
            "avg_io_per_query": [[r.avg_io_per_query for r in row]
                                 for row in results],
            "probes": [dataclasses.asdict(p) for p in probes]}
    card, cpu = trial[DEVICE], trial["cpu"]
    for key in ("io", "avg_io_per_query", "probes"):
        check(card[key] == cpu[key], f"api trial {key}: cpu != cuda")
    check(card["io"] == [[r.io.as_dict()
                          for r in report.fleet[(b.cell, b.policy)]]
                         for b in plan.trees],
          "api trial IOStats: execute_trial != run_experiment's trial")
    check(all(card["launches"].values()), f"the card's api trial launched "
          f"{card['launches']}")
    check(not any(cpu["launches"].values()), f"the CPU plain path launched "
          f"{cpu['launches']}")
    return {"phase": "api", "spec": spec.name, "trees": len(plan.trees),
            "sessions": len(plan.sessions), "n_keys": plan.n_keys,
            "identical": True, "run_experiment_s": run_s,
            "walls": report.walls, "run_launches": run_launches,
            "chosen": {f"w{i}" + ("" if rho is None else f"_rho{rho:g}"):
                       pol for (i, rho), pol in report.chosen.items()},
            "trial": {dev: {k: v for k, v in t.items() if k != "io"}
                      for dev, t in trial.items()}}


def suites_main(torch) -> int:
    """``--suites``: the suites phase over ``ALL_SUITES`` on the
    ``repro_torch`` under ``--src``: one JSON line per suite, then the
    card's name and power limit."""
    import repro_torch.core as core
    from repro_torch.kernels import _build as build
    log(f"suites only, {Path(core.__file__).parents[1]}")
    build.build(["dual_solve", "merge", "point_read"])
    phase_suites(torch, core, build, ALL_SUITES)
    print(gpu_line(), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--merge", action="store_true",
                    help="time only the compaction merge, as the kernels "
                    "phase does, and exit")
    ap.add_argument("--point-read", action="store_true",
                    help="time only the point read, as the kernels phase "
                    "does, with the engine path's launches replayed, and "
                    "exit")
    ap.add_argument("--dual-solve", action="store_true",
                    help="time only the dual solve and a robust Adam step, "
                    "and exit")
    ap.add_argument("--bloom", action="store_true",
                    help="time only the Bloom probe on the bloom phase's "
                    "plane, and exit")
    ap.add_argument("--suites", action="store_true",
                    help="run only the paper suites, the tuner suite "
                    "included, and exit")
    ap.add_argument("--src", default=str(SRC),
                    help="with --merge, --point-read, --dual-solve, "
                    "--bloom or --suites: the src directory whose "
                    "repro_torch to run (another tree's, to compare two "
                    "in one run)")
    ap.add_argument("--sizes", help="with --merge: also replay the engine "
                    "path's merges at the sizes this file holds (a JSON "
                    "list of (na, nb), or a whole run's output)")
    args = ap.parse_args(argv)
    src = Path(args.src)
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke.py: no {src}/repro_torch (run it from the root "
              "of a checkout)", file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available; the port's main path "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 3
    sys.path.insert(0, str(src))
    if args.merge:
        return merge_main(torch, np, args.sizes)
    if args.point_read:
        return point_read_main(torch, np)
    if args.dual_solve:
        return dual_solve_main(torch, np)
    if args.bloom:
        return bloom_main(torch, np)
    if args.suites:
        return suites_main(torch)
    import repro_torch.core as core
    import repro_torch.lsm as lsm
    from repro_torch import quickstart
    from repro_torch.kernels import _build as build
    from repro_torch.kernels.bloom_probe import ops as bloom_ops
    from repro_torch.kernels.bloom_probe import ref as bloom_ref
    from repro_torch.kernels.dual_solve import ops as dual_ops
    from repro_torch import configs, models
    from repro_torch.kernels.dual_solve import ref as dual_ref
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.merge import ops as merge_ops
    from repro_torch.kernels.merge import ref as merge_ref
    from repro_torch.kernels.point_read import ops as read_ops
    from repro_torch.kernels.point_read import ref as read_ref
    from repro_torch.kernels.rwkv6 import ops as rwkv_ops
    from repro_torch.kernels.rwkv6 import ref as rwkv_ref
    from repro_torch.launch import serve
    from repro_torch.lsm import read_path
    from repro_torch.models import lm
    from repro_torch.utils import u64

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    log(f"build on {gpu}")
    t0 = time.time()
    report = build.build()
    regs = {name: [ln.strip() for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln]
            for name, log in report.items()}
    emit({"phase": "build", "seconds": time.time() - t0, "gpu": gpu,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "ptxas": regs})
    # the bf16 rwkv6 kernel's registers and spills, per head dim
    mma = regs.get("rwkv6_mma", [])
    check(any("registers" in ln for ln in mma),
          "no ptxas report for csrc/rwkv6_mma.cu")
    emit({"phase": "ptxas", "source": "src/repro_torch/csrc/rwkv6_mma.cu",
          "lines": mma})

    tuner = phase_tuner(torch, core, build, dual_ref.dual_solve_warm_ref)
    emit(tuner)
    tree, keys, merges, reads, builds, engine = phase_engine(
        torch, np, core, lsm, quickstart, build, merge_ops, read_path,
        read_ops)
    emit(engine)
    launches = {"dual_solve": tuner["dual_solve_launches"],
                **{k: engine["launches"][k] for k in ("merge",
                                                      "point_read")}}
    for arch, kernel in SERVE:
        served = phase_serve(torch, np, configs, models, serve, lm, build,
                             arch, kernel)
        emit(served)
        launches[kernel] = served["kernel_launches"]
        launches[f"{kernel}:f32_cuda_core"] = \
            served["f32_check"]["f32_kernel_launches"]
    arch_of = {kernel: arch for arch, kernel in SERVE}
    plane, bloom_q, bloom_in, bloom = phase_bloom(torch, np, bloom_ops,
                                                  bloom_ref, build)
    emit(bloom)
    launches["bloom_probe"] = bloom["launches"]

    dev = DEVICE
    log("kernels")
    kernels = [
        kernel_dual_solve(torch, core, dual_ops, dual_ref, dev),
        kernel_merge(torch, np, merge_ops, merge_ref, u64, dev, merges),
        kernel_point_read(torch, np, read_ops, read_ref, u64, tree, keys,
                          reads, builds, dev),
        kernel_flash_attention(torch, configs, flash_ops, flash_ref, build,
                               dev, arch_of["flash_attention"]),
        *kernel_rwkv6(torch, configs, rwkv_ops, rwkv_ref, build, dev,
                      arch_of["rwkv6"]),
        kernel_bloom_probe(torch, bloom_ops, bloom_ref, plane, bloom_q,
                           bloom_in),
    ]
    del plane, bloom_q, bloom_in, reads, builds
    for k in kernels:
        k["launches"] = launches[k["name"]]
    emit({"phase": "kernels", "launch_floor_ms": launch_floor_ms(torch),
          "kernels": kernels})
    phase_suites(torch, core, build)
    emit(phase_api(torch, build))
    keyset = ("name", "route", "source", "replaces", "launches",
              "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms")
    emit({"kernels": [{key: k[key] for key in keyset} for k in kernels]})
    log(f"done in {time.time() - T_START:.1f} s")
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
