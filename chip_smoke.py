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
   dense ``qwen3-14b`` (40 layers, d_model 5120, 14.8 B parameters), the
   attention-free ``rwkv6-3b`` (32 layers, d_model 2560, 3.1 B) and the
   mixture-of-experts ``deepseek-moe-16b`` (28 layers: a dense prelude
   layer, then 27 of 64 routed experts, top-6, and 2 shared ones; d_model
   2048, 16.4 B), each at its published width and depth; then, at their
   published widths, the hybrid ``jamba-1.5-large-398b`` cut to the first
   5 layers of its 8-layer period (4 Mamba layers and the attention
   layer; 2 MoE and 3 dense MLPs; d_model 8192, Mamba inner width 16384,
   24.1 B) and ``mixtral-8x7b`` cut to 16 of its 32 layers (8 experts
   top-2, a 4,096-token sliding window, 23.5 B) at batch 2 and prompt
   6144, so that its prefill runs the windowed kernel and its decode
   wraps the ring cache; then the encoder-decoder ``whisper-base`` at its
   full size (6 encoder and 6 decoder layers, d_model 512, ~72 M) at
   batch 4 over its 1,500-frame window (the reference's server prefills
   the decoder with as many tokens), the stub-embedding
   ``qwen2-vl-72b`` (M-RoPE, d_model 8192, 64 q / 8 kv heads, QKV bias)
   cut to 24 of its 80 layers (23.6 B) and ``qwen1.5-110b`` cut to 16 of
   80 (24.2 B) (``SERVE_CUT_WHY`` says why each is cut; a cut keeps a
   prefix of the layers).  Each in bfloat16 from the port's
   seeded init on the card, through ``serve_model`` with batch 4, prompt
   2048 and 32 greedy tokens unless ``SERVE_SHAPE`` says otherwise,
   counting its prefill kernel's launches (``flash_attention`` or
   ``rwkv6``, one per layer of its mixer, whisper's 6 non-causal encoder
   layers besides its 6 decoder layers, each on the bf16 tensor-core
   kernel) and checking the peak memory against 75 GB; a profiled
   prefill (device busy share, kernels by device time, the prefill
   kernel's share of the device time, and the device time split by the
   PyTorch call that launched it: the Mamba scan, the MoE layer, the
   rest, each into cuBLAS and other kernels; the port's own kernels,
   launched outside any PyTorch op, unattributed) and four profiled
   decode steps; and, with the bf16 model freed, 2 layers of the same
   weights in float32 (the first 2, deepseek's prelude and its first MoE
   layer; jamba's Mamba layer 0 and its attention layer 4; whisper's
   first 2 encoder and 2 decoder layers; ``CHECK``) at prompt 256
   (mixtral: batch 1, prompt 4608, past its window; whisper: its 1,500
   frames; qwen2-vl on distinct M-RoPE triples, a text prefix and then an
   image whose t stays fixed while h and w walk a patch grid), whose
   last-position prefill logits through the kernel and through the plain
   path (materialised attention, or the chunked WKV in torch ops) must
   agree to 1e-4 of the largest logit (``CHECK_REL``; counting the
   float32 kernels' launches).
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
   writes, with the share of lanes bit-equal to the plain version, on
   the tuner's lanes (4 costs) and on the ``kernels`` suite's 1,024 x 64
   (its wide lanes, timed beside their bound) and 1,000 x 33 and x 17,
   ``flash_attention`` to 2e-2 in
   bfloat16 (jamba's 64/8 heads at its prefill and mixtral's 32/8 at
   (2, 6144) with its 4,096 window among the cases; whisper's encoder
   (4, 1500, 8, 8, 64) non-causal, its decoder causal and qwen2-vl's
   (4, 2048, 64, 8, 128) each also timed beside SDPA with its bound,
   ``FLASH_BF16_TIMED``) and 2e-5 in float32,
   each case naming the kernel that served it, ``rwkv6`` to 5e-2 in
   bfloat16 at the model's, a slow and a fast decay and 5e-4 in float32
   on y and the final state, each case naming its kernel, the float32 one
   timed as a row of its own), with the
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
5a. ``bench_kernels`` — the ``kernels`` and ``roofline`` suites of
   ``repro_torch.bench.run`` on the card: each kernel of the data plane
   (point read, dual solve, merge) timed against its plain version at the
   committed shapes, every held count equal to ``BENCH_kernels.json``;
   three measured roofline cells against the card's copy bandwidth (the
   best of 10 copies of a 1 GiB tensor, read and write charged), and the
   committed skip rows; each suite's launches.
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
   call, which must be its steps + 1.  Then ``fig6``, ``tab5``, ``api``,
   ``online``, ``memory`` and ``scenarios`` (``CPU_HELD_SUITES``), whose
   committed files the JAX package itself no longer reproduces from those
   starts: each on the card, one JSON line with its held fields and its misses against the
   committed file by name (printed, not a failure), its launches
   (``dual_solve`` one per robust Adam step plus one per robust grid and
   per robust re-tune storm; ``merge`` and ``point_read`` for the engine
   suites), and the card held against the port's CPU run: fig6's rows
   within the runner's band of the CPU's; tab5's and api's ``TrialPlan``
   through the CPU trial, every ``IOStats`` and I/O per query
   bit-identical; online's three drifts replayed on the CPU from the
   card's tunings and re-tune storms, every segment record and
   ``LSMTree.retune`` call identical; ``memory``'s three runs (two
   scenarios and the disabled check) likewise, the division events too;
   ``scenarios``' five runs (``zipf_migrate``, ``burst_storm``,
   ``tombstone_churn``, ``scan_heavy`` and the live ``adversary``: 100,000
   keys, 8 segments of 600 baseline queries, 16-start 120-step storms)
   likewise, each adversary window replayed from the card's attacked mix
   while the CPU's own attack on the same defender state must give the
   card's regret record to rel 1e-5, both claim flags true on the card,
   and each window's dual-bound margin printed.  online, memory and
   scenarios set the launch counts to 0 before each run and check each
   run's own (``dual_solve``: 251 for each memory run's first tunings
   plus 201 for each robust storm; 251 for each scenario's plus 121 per
   robust storm; each scenario's ``merge`` and ``point_read`` launches
   equal to the calls its CPU replay counted).  ``compaction`` (one pinned tuning, no tuner: 0
   ``dual_solve`` launches, its ``merge`` and ``point_read`` ones
   printed) and ``robust_sharding`` (its three skip rows: the repository
   holds no dry-run records) are held against the committed file like
   fig4, and so are ``faults`` (11 held fields: its trials on the
   subprocess backend, whose workers run on the card, and the
   supervision's overhead against bare launches) and ``obs`` (18: five
   runs of a four-policy fleet of 50,000 keys, traced and not, and the
   calibration); each launches no ``dual_solve`` and some ``merge`` and
   ``point_read`` (for faults, its inline runs' and its workers', which
   the parent adds up).  The ``tuner`` suite runs only under
   ``--suites`` (below): its seed-style row alone takes about 1,000 s on
   the H100.
7. ``api`` — ``run_experiment`` on the card for the spec of the API
   smoke suite (``repro_torch.bench.api.SPEC``: two workloads, nominal
   and rho 1, the K-LSM and lazy-leveling policy arms, 8 trees of 40,000
   keys and two sessions), counting its kernels' launches; then its
   ``TrialPlan`` through ``execute_trial`` on the card and on the CPU:
   every tree's ``IOStats``, I/O per query and ``TreeProbe`` bit-identical,
   with the card trial's ``merge`` and ``point_read`` launches.  Then
   ``robust_serving``: ``python -m repro_torch.robust_serving``'s spec
   (the port of ``examples/robust_serving.py``: ZippyDB-like, rho 0.25 /
   1 / 2 and nominal, the klsm and lazy_leveling arms, 32 starts x 150
   steps, the sharded backend) on the card, its wall and its
   ``dual_solve`` launches (151 for each arm's robust grid), then on the
   CPU from the same starts: the same picks and designs, costs within
   the suites' band (0.01 + 0.01 x the CPU's), the largest gap printed.
8. ``drift`` — the online drift loop: the online suite's flip scenario
   (w4, 250,000 keys, 10 segments of 1,000 queries, the stale-nominal,
   static-robust, online and oracle arms) on the card from the committed
   starts, then the same plan on the CPU with every re-tune storm
   answered by the card's: the same segment records and the same
   ``LSMTree.retune`` calls; it prints each storm (requests, robust ones,
   the padded lane batches, wall, launches), the re-tunes and each arm's
   throughput.
9. ``memory`` — the fleet memory arbiter: the memory suite's skew_flip
   scenario (two tenants of 50,000 keys, 8 segments of 500 queries, the
   static and the arbitrated fleet) as the suites phase ran it on the
   card and replayed it on the CPU; it checks that run's own launches
   (every kernel of its path) and that the arbiter re-divided, and prints
   each storm (granted share, requests, lane batch, wall, launches), the
   divisions and each fleet's throughput.
10. ``robust_sharding`` — ``robust_layout_sweep`` over 64 seeded
   synthetic layout candidates x the rho grid on the card and the CPU:
   the same picks, the worst-case grids within rel 1e-5.
11. ``faults`` — the subprocess backend with its workers on the card,
   over the faults suite's spec (4 trees of 30,000 keys, 1,500 queries, 2
   workers): the suite's chaos schedule (a crash on shard 0, a corrupt
   result on shard 1) with 2 retries and no failed tree, and the same
   shards run in this process on the card, each trial the CPU's inline
   trial in every ``IOStats``, I/O per query and ``TreeProbe``; the
   workers' ``merge`` and ``point_read`` launches of the accepted attempts
   (added to the parent's counts) equal to the in-process ones; a hung
   worker killed at ``HANG_TIMEOUT_S`` (45 s) and retried, identical, each
   attempt's latency printed; and a resume from a temporary run directory
   whose shard-0 job file the first run tore: it loads only the valid
   job, re-runs one shard, and gives the identical result.
12. ``obs`` — the obs suite's traced leg on the card, exported with
   ``write_trace``: one thread lane per tree label, 16
   ``session.execute`` spans, the ``kernel.dispatch.merge.cuda`` and
   ``kernel.dispatch.point_read.cuda`` counters; its calibration artifact
   validates its checksum and reads ``all_fitted_ge_hand`` true; and the
   faults and obs suites' ``overhead_ratio``, printed as times.
12a. ``dryrun`` — the port's multi-pod dry run (``repro_torch.launch.
   dryrun``): ``DRYRUN_CELLS`` (``rwkv6-3b``'s four shapes under the tags
   ``baseline`` and ``opt`` = ``remat=dots``, and ``qwen3-14b`` at
   ``train_4k`` on the ``single`` and ``multipod`` meshes), each traced at
   full size from fake tensors over a fake process group of 256 or 512
   ranks, into a temporary records directory.  The cells run on the CPU
   in ``DRYRUN_WORKERS`` worker processes that start after
   ``bench_kernels`` (so that they share the host with no phase whose
   kernel times or decode rate are read: the tuner, engine, serve,
   kernels and ``bench_kernels`` phases before, ``train`` after) and
   trace while the phases from the suites to obs run; this phase waits
   for them and prints each cell's status, FLOPs, bytes, collective
   bytes by axis, memory per device and roofline terms, and the roofline
   suite's mesh rows over the records.  Every cell must be ``ok``, with
   the analytic FLOPs (6ND or 2ND) 0.1-1.5 times its traced ones.
12b. ``robust_sharding_records`` — the ``robust_sharding`` suite over
   those records on the card: its ``rwkv6-3b`` row, the nominal against
   the robust pick of the two layouts, must be computed, not skipped.
13. ``train`` — the trainer (``repro_torch.launch.train``, which runs
   ``attention_impl="plain"``: the prefill kernels have no backward, so
   it must launch none of them): ``whisper-base`` at its published
   width and depth through ``train_loop``, and through
   ``make_train_step`` ``rwkv6-3b`` at its published width with its
   first 4 of 32 layers (its full depth's 4 steps and profiled step took
   35-52 s of the time limit),
   ``qwen3-14b`` at its published width with its first 4 of 40 layers
   (full depth's training state is 177 GB), ``deepseek-moe-16b`` with
   its prelude and 3 MoE layers (2.27 B parameters; full depth's state is
   197 GB) and ``jamba-1.5-large-398b`` with its first layer (Mamba and a
   dense MLP, 2.08 B; a second layer brings a 9.66 B MoE MLP), each bf16
   with ``remat="full"``, batch 8 x 512 tokens, 4
   steps from the pipeline (each step's loss, MoE auxiliary loss and
   gradient norm finite, the walls after the first, tokens/s, peak
   memory under 75 GB, a
   snapshotted weight moved; one profiled step: busy share, top kernels);
   the reduced float32 models' (``rwkv6-3b``, ``qwen3-14b``,
   ``deepseek-moe-16b``, one 8-layer period of ``jamba-1.5-large-398b``,
   ``whisper-base`` and ``qwen2-vl-72b``) 3 train steps on the card and
   the CPU from
   the same weights and batches (losses and aux rel 1e-5, gradient norms
   rel 1e-4, parameters within 6 lr); and a checkpointed ``train_loop``
   (reduced ``qwen3-14b``, 24 steps, a save every 2) with a restore of
   the last save (bit for bit), whose manifest's ``dual_solve`` launches
   must be one storm's 251 and whose ``merge`` and ``point_read``
   launches, ``IOStats`` and shape must equal a CPU replay of its
   operations.

The build's ``ptxas`` report (registers and spills) for the bf16
``rwkv6`` kernel is printed on a line of its own.

    python3 chip_smoke.py --suites [--src DIR]

runs only the suites phase, over ``fig4``, ``fig10``, ``tuner``,
``fig7_8``, ``fig9``, ``fig19``, ``compaction``, ``robust_sharding``,
``faults``, ``obs`` and the six held against the CPU, on the ``repro_torch`` under ``DIR``: one
JSON line per suite, then the card's name and power limit.

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
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
# throwaway launches that open a trace, and the cycles each spins: late in
# the script a trace loses its first kernels (11 or more at the kernels
# phase in one run), so they are many and long
LEAD_KERNELS, LEAD_CYCLES = 32, 20_000
# the most throwaway launches a trace has lost so far (printed in the
# kernels phase)
LEAD_LOST = {"max": 0}
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
SUITES = ("fig4", "fig10", "fig7_8", "fig9", "fig19", "compaction",
          "robust_sharding", "faults", "obs")
ALL_SUITES = ("fig4", "fig10", "tuner", "fig7_8", "fig9", "fig19",
              "compaction", "robust_sharding", "faults", "obs")
# the held fields of each committed BENCH_<suite>.json
SUITE_HELD = {"fig4": 18, "fig10": 12, "tuner": 11, "fig7_8": 27, "fig9": 4,
              "fig19": 16, "compaction": 32, "robust_sharding": 3,
              "faults": 11, "obs": 18}
# the suites that run the engine (every compaction a merge, every read
# batch a point_read) and no tuner; the faults suite's trials run in the
# subprocess backend's workers too, whose launches the parent adds up
ENGINE_SUITES = ("compaction", "obs", "faults")
# the faults phase: the hung worker's per-attempt deadline (s), sized for a
# healthy attempt's start-up (import torch, a CUDA context) and its shard
HANG_TIMEOUT_S = 45.0
# the suites that run through the experiment API, each with one robust grid
API_SUITES = ("fig7_8", "fig9", "fig19")
# the suites whose committed file the JAX package itself no longer
# reproduces from the committed starts (ROADMAP.md section 3): the card is
# held against the port's CPU run, and its misses against the committed
# file are printed by name
CPU_HELD_SUITES = ("fig6", "tab5", "api", "online", "memory", "scenarios")
# the drift phase's experiment: the online suite's flip scenario
DRIFT_SCENARIO = "flip"
# the memory phase's experiment: the memory suite's skew_flip scenario
MEMORY_SCENARIO = "skew_flip"
# the memory suite's card runs and CPU replays by scenario, kept for the
# memory phase
_MEMORY_RUN: dict = {}
# the robust_sharding phase: seeded synthetic layout candidates x GRID_RHOS
LAYOUT_CANDIDATES = 64
# the bench_kernels phase: the held fields of BENCH_kernels.json and
# BENCH_roofline.json, and the kernels each suite must launch
BENCH_HELD = {"kernels": 16, "roofline": 8}
BENCH_KERNELS = ("dual_solve", "merge", "point_read")
# the dryrun phase's cells, (arch, shape, mesh, tag, config overrides), the
# longest first: rwkv6-3b's four shapes under two layouts (the tags that
# the robust_sharding suite reads) and qwen3-14b's training step on both
# production meshes; each traced in one of DRYRUN_WORKERS processes, which
# the phase waits for at most DRYRUN_WAIT_S
DRYRUN_CELLS = tuple(
    ("rwkv6-3b", shape, "single", tag, over)
    for shape in ("prefill_32k", "train_4k")
    for tag, over in (("baseline", {}), ("opt", {"remat": "dots"}))) + (
    ("qwen3-14b", "train_4k", "multipod", "baseline", {}),
    ("qwen3-14b", "train_4k", "single", "baseline", {})) + tuple(
    ("rwkv6-3b", shape, "single", tag, over)
    for shape in ("decode_32k", "long_500k")
    for tag, over in (("baseline", {}), ("opt", {"remat": "dots"})))
DRYRUN_WORKERS = 4
DRYRUN_WAIT_S = 900.0
MERGE_N, READ_BATCH = 5_000_000, 1_000_000
# (arch, the kernel its prefill runs once per layer of its mixer)
SERVE = (("qwen3-14b", "flash_attention"), ("rwkv6-3b", "rwkv6"),
         ("deepseek-moe-16b", "flash_attention"),
         ("jamba-1.5-large-398b", "flash_attention"),
         ("mixtral-8x7b", "flash_attention"),
         ("whisper-base", "flash_attention"),
         ("qwen2-vl-72b", "flash_attention"),
         ("qwen1.5-110b", "flash_attention"))
# the mixer whose layers launch each prefill kernel (an encoder's
# attention layers launch flash_attention too)
KERNEL_MIXER = {"flash_attention": "attn", "rwkv6": "rwkv"}
# the served archs cut in depth (the first n of their layers), and why
SERVE_CUT_LAYERS = {"jamba-1.5-large-398b": 5, "mixtral-8x7b": 16,
                    "qwen2-vl-72b": 24, "qwen1.5-110b": 16}
SERVE_CUT_WHY = {
    "jamba-1.5-large-398b": "full depth is 397.5 B params (795 GB of bf16 "
                            "weights) against the card's 80 GB; the "
                            "period's first 5 layers (4 Mamba, the "
                            "attention layer; 2 MoE and 3 dense MLPs) are "
                            "24.0 B (48 GB); 6 layers (34.0 B, 68 GB) leave "
                            "no room for the prefill and the float32 check",
    "mixtral-8x7b": "full depth is 46.70 B params (93.4 GB of bf16 weights) "
                    "against the card's 80 GB; 16 of 32 layers are 23.48 B "
                    "(47.0 GB)",
    "qwen2-vl-72b": "full depth is 72.77 B params (145.5 GB of bf16 "
                    "weights) against the card's 80 GB; 24 of 80 layers, "
                    "with the adapter, embed_out and lm_head, are 23.62 B "
                    "(47.2 GB)",
    "qwen1.5-110b": "full depth is 111.21 B params (222.4 GB of bf16 "
                    "weights) against the card's 80 GB; 16 of 80 layers "
                    "are 24.24 B (48.5 GB)"}
# (batch, prompt) of the archs served at another shape: mixtral's prompt
# is 1.5 x its 4,096-token window, so that the prefill runs the windowed
# kernel and decode wraps the ring cache; whisper's 1,500 encoder frames
# are its 30-second window (the reference's server prefills the decoder
# with as many tokens)
SERVE_SHAPE = {"mixtral-8x7b": (2, 6144), "whisper-base": (4, 1500)}
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
# the train phase: batch, sequence and steps of the full-width runs; the
# layers of the runs cut in depth (qwen3-14b's 4 of 40: its full depth's
# training state is 177 GB; deepseek-moe-16b's prelude and 3 MoE layers of
# 28: 197 GB; rwkv6-3b's 4 of 32, for the script's time limit: CUT_WHY);
# the card-against-CPU steps; the checkpointed run's steps and interval
TRAIN_REDUCED = False
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 4
# the archs trained at their published width and depth through train_loop
TRAIN_FULL = ("whisper-base",)
TRAIN_CUT_LAYERS = {"rwkv6-3b": 4, "qwen3-14b": 4, "deepseek-moe-16b": 4,
                    "jamba-1.5-large-398b": 1}
# the reduced models trained card against CPU, and the layers they keep
# (jamba: one 8-layer period)
TRAIN_CHECK_ARCHS = {"rwkv6-3b": None, "qwen3-14b": None,
                     "deepseek-moe-16b": None, "jamba-1.5-large-398b": 8,
                     "whisper-base": None, "qwen2-vl-72b": None}
TRAIN_CHECK_STEPS = 3
TRAIN_CKPT_STEPS, TRAIN_CKPT_INTERVAL = 24, 2
CHECK_LAYERS, CHECK_PROMPT = 2, 256
# the float32 check's (layers of the served weights, batch, prompt) where
# not (the first CHECK_LAYERS, SERVE_BATCH, CHECK_PROMPT): jamba's
# Mamba/dense layer 0 and its attention layer 4; mixtral's 2 layers past
# its window; whisper's first 2 encoder and 2 decoder layers over its
# 1,500 frames
CHECK = {"jamba-1.5-large-398b": ((0, 4), SERVE_BATCH, CHECK_PROMPT),
         "mixtral-8x7b": ((0, 1), 1, 4608),
         "whisper-base": ((0, 1), SERVE_BATCH, 1500)}
# the float32 check's bound on the kernel path's logits against the plain
# path's, relative to the largest logit
CHECK_REL = 1e-4
# M-RoPE position triples of the float32 check: a text prefix (t = h = w)
# then an image, t constant while h and w walk a patch grid this wide
CHECK_TEXT, CHECK_GRID = 16, 16
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
# the serving prefills of this slice's archs, each also timed beside SDPA:
# (name, (B, S, H, KV, d), causal)
FLASH_BF16_TIMED = [("whisper-base encoder", (4, 1500, 8, 8, 64), False),
                    ("whisper-base decoder", (4, 1500, 8, 8, 64), True),
                    ("qwen2-vl-72b", (4, 2048, 64, 8, 128), True)]
FLASH_BF16_CASES = [((2, 1531, 40, 8, 128), True, None),      # ragged S
                    ("phi3-mini-3.8b", True, None),           # d 96, H = KV
                    ("glm4-9b", True, None),                  # GQA group 16
                    ("deepseek-moe-16b", True, None),         # its prefill
                    ((2, 2048, 40, 8, 128), True, 512),       # window
                    ("jamba-1.5-large-398b", True, None),     # its prefill
                    ((2, 6144, 32, 8, 128), True, 4096)]      # mixtral's
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


def cuda_events(torch, fn, calls: int = 0, tries: int = 3,
                lead=None, traces=None) -> tuple:
    """Host wall seconds of ``fn`` (up to a synchronise) and the CUDA
    activities a ``torch.profiler`` trace of it records, as (name, device
    µs) pairs.  Late in this script a trace does not record the first
    kernels launched in it (11 or more at the kernels phase in one chip
    run), so each trace opens with ``LEAD_KERNELS``
    throwaway launches of ``torch.cuda._sleep`` (its ``spin_kernel``
    events are left out; how many of them a trace lost at most is kept in
    ``LEAD_LOST``) before ``fn``.  With ``calls``,
    ``fn`` makes that many calls, each launching the same activities: a
    trace in which an activity's count is not a multiple of ``calls``
    missed events and is taken again, and when every one of ``tries``
    traces misses some, the check fails.  Without it, only a trace that
    holds no CUDA event at all is taken again.  A trace may also miss the
    first launch of a kernel in it (one fold step of ten, its copy kept):
    ``lead``, when given, launches ``fn``'s kernels once after the
    throwaway launches, and only the events that start after one more
    ``spin_kernel``, launched once ``lead`` is done, are kept.  The
    profiler of the trace returned is appended to ``traces`` when given."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(LEAD_KERNELS):
                torch.cuda._sleep(LEAD_CYCLES)
            if lead is not None:
                lead()
                torch.cuda.synchronize()
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            wall = time.time() - t0
        device = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        spins = [e.time_range.start for e in device
                 if "spin_kernel" in e.name]
        launched = LEAD_KERNELS + (lead is not None)
        LEAD_LOST["max"] = max(LEAD_LOST["max"], launched - len(spins))
        after = max(spins) if lead is not None and spins else float("-inf")
        # a SCOPES label's range shows among the device events too
        events = [(e.name, e.time_range.elapsed_us()) for e in device
                  if "spin_kernel" not in e.name and e.name not in SCOPES
                  and e.time_range.start > after]
        counts = {}
        for name, _ in events:
            counts[name] = counts.get(name, 0) + 1
        short = {n[:60]: c for n, c in counts.items() if calls and c % calls}
        if events and not short:
            if traces is not None:
                traces.append(prof)
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
                               calls=iters, lead=fn)
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


# where a prefill's device time goes: kernels by the call that launched
# them (these functions, through a profiler scope) and by name
SCOPES = {"mamba_scan": ("repro_torch.models.mamba", "_ssm"),
          "moe": ("repro_torch.models.moe", "apply_moe")}
CUBLAS_NAMES = ("gemm", "gemv", "nvjet", "xmma", "cutlass", "splitK")


@contextlib.contextmanager
def _scoped(torch):
    """While open, each function of ``SCOPES`` runs inside a
    ``record_function`` range of its label."""
    import importlib
    saved = []
    for label, (mod, attr) in SCOPES.items():
        m = importlib.import_module(mod)
        real = getattr(m, attr)

        def scoped(*args, _real=real, _label=label, **kw):
            with torch.profiler.record_function(_label):
                return _real(*args, **kw)

        setattr(m, attr, scoped)
        saved.append((m, attr, real))
    try:
        yield
    finally:
        for m, attr, real in saved:
            setattr(m, attr, real)


def caller_split(prof) -> dict:
    """Device ms of a trace's kernels by the PyTorch op that launched them:
    under a ``SCOPES`` label or not (``rest``), each into cuBLAS and other
    kernels (``moe:cublas``, the experts' products; ``moe:other``, its
    routing and indexing; ``mamba_scan:other``, the scan's elementwise
    kernels).  A kernel launched outside any op (the port's own, through
    ``ctypes``) is in none of them."""
    split: dict = {}

    def walk(evt, scope):
        scope = evt.name if evt.name in SCOPES else scope
        for k in evt.kernels:
            if "spin_kernel" in k.name:
                continue
            kind = "cublas" if any(c in k.name for c in CUBLAS_NAMES) \
                else "other"
            key = f"{scope}:{kind}"
            split[key] = split.get(key, 0.0) + k.duration / 1e3
        for c in evt.cpu_children:
            walk(c, scope)

    for evt in prof.events():
        if evt.cpu_parent is None:
            walk(evt, "rest")
    return {k: split[k] for k in sorted(split)}


def profile_device(torch, fn, kernel: str = "",
                   by_caller: bool = False) -> dict:
    """Host wall time of ``fn`` (up to a synchronise) and the CUDA kernels
    a ``torch.profiler`` trace records in it: their summed device time,
    its share of the wall time, their count, and the six largest by name
    (device fields None when the profiler records no device time); with
    ``kernel``, also the device time of the kernels whose name contains it,
    their share of the device time and their count; with ``by_caller``,
    the trace is taken under ``_scoped`` and ``by_caller_ms`` splits the
    device time by the call that launched each kernel (``caller_split``)."""
    traces: list = []
    with _scoped(torch) if by_caller else contextlib.nullcontext():
        wall, events = cuda_events(torch, fn, tries=1, traces=traces)
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
    if by_caller and traces:
        split = caller_split(traces[0])
        split["unattributed"] = busy_s * 1e3 - sum(split.values())
        out["by_caller_ms"] = split
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


def cut_depth(cfg, n, lm):
    """``cfg`` with its first ``n`` layers: a prefix of
    ``lm.layer_kinds(cfg)`` (the prelude, then the pattern's entries)."""
    kinds = lm.layer_kinds(cfg)
    return cfg.replace(num_layers=n, pattern=kinds[len(cfg.prelude):n])


def kernel_layers(cfg, kernel, lm) -> int:
    """The layers whose mixer launches ``kernel`` once a prefill: the
    decoder's, and for ``flash_attention`` an encoder's too."""
    n = sum(m == KERNEL_MIXER[kernel] for m, _ in lm.layer_kinds(cfg))
    if cfg.encoder is not None and kernel == "flash_attention":
        n += cfg.encoder.num_layers
    return n


def patch_triples(np, batch, prompt):
    """(3, batch, prompt) M-RoPE positions: ``CHECK_TEXT`` text tokens
    (t = h = w = index), then image patches, t fixed at ``CHECK_TEXT``
    while h and w walk a ``CHECK_GRID``-wide patch grid from it."""
    i = np.arange(prompt)
    j = np.maximum(i - CHECK_TEXT, 0)
    img = i >= CHECK_TEXT
    t = np.where(img, CHECK_TEXT, i)
    h = np.where(img, CHECK_TEXT + j // CHECK_GRID, i)
    w = np.where(img, CHECK_TEXT + j % CHECK_GRID, i)
    return np.broadcast_to(np.stack([t, h, w])[:, None],
                           (3, batch, prompt)).astype(np.int64)


def check_model(cfg, params, layers, kinds):
    """The float32 check's config and the bf16 leaves it takes of the
    served ``params``: the layers ``layers`` (of the encoder's and the
    decoder's, for an encoder-decoder), and every other top-level entry
    but an untied stub model's ``embed_out``, which a prefill does not
    read."""
    stacks = ("enc_layers", "dec_layers") if cfg.encoder is not None \
        else ("layers",)
    keep = {k: v for k, v in params.items() if k not in stacks
            and (k != "embed_out" or cfg.tie_embeddings)}
    for k in stacks:
        keep[k] = [params[k][i] for i in layers]
    if cfg.encoder is not None:
        import dataclasses
        cfg32 = cfg.replace(num_layers=len(layers),
                            encoder=dataclasses.replace(
                                cfg.encoder, num_layers=len(layers)))
    else:
        cfg32 = cfg.replace(num_layers=len(layers), prelude=(),
                            pattern=tuple(kinds[i] for i in layers))
    return cfg32.replace(dtype="float32", param_dtype="float32"), keep


def phase_serve(torch, np, configs, models, serve, lm, build, arch, kernel):
    """``arch`` at full width (cut in depth where ``SERVE_CUT_LAYERS``
    says): ``serve_model`` on the port's seeded bf16 weights, counting
    ``kernel``'s launches (one per layer of its mixer, the encoder's
    included), then the kernel path against the plain path on 2 float32
    layers of the same weights (``CHECK``; M-RoPE on distinct position
    triples), after the bf16 model is freed."""
    cfg = configs.get_config(arch)
    if SERVE_REDUCED:
        cfg = cfg.reduced()
    published = cfg.num_layers
    if arch in SERVE_CUT_LAYERS:
        cfg = cut_depth(cfg, min(SERVE_CUT_LAYERS[arch], published), lm)
    kinds = lm.layer_kinds(cfg)
    n_kernel = kernel_layers(cfg, kernel, lm)
    batch, prompt = SERVE_SHAPE.get(arch, (SERVE_BATCH, SERVE_PROMPT))
    log(f"serve: init {cfg.name}, {cfg.num_layers} of {published} layers")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    model = models.build_model(cfg, DEVICE, seed=0)
    torch.cuda.synchronize()
    t_init = time.time() - t0
    params = model.params
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    log("serve: warm-up (prompt 128, 2 tokens)")
    serve.serve_model(model, batch, 128, 2, seed=1)
    log(f"serve: batch {batch}, prompt {prompt}, gen {SERVE_GEN}")
    build.reset_launches()
    out = serve.serve_model(model, batch, prompt, SERVE_GEN, seed=0)
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(launches[kernel] == n_kernel,
          f"{kernel} launched {launches[kernel]} times in one prefill, "
          f"expected {n_kernel}")
    tc = launches[f"{kernel}:bf16_tc"]
    check(tc == n_kernel, f"the bf16 tensor-core kernel served {tc} "
          f"of the prefill's {n_kernel} {kernel} launches")
    check(peak < 75e9, f"{cfg.name} serving peaks at {peak / 1e9:.1f} GB")
    toks = out["tokens"]
    check(toks.shape == (batch, SERVE_GEN), f"tokens {toks.shape}")
    check(bool((toks >= 0).all() and (toks < cfg.vocab_size).all()),
          "a generated token lies outside the vocabulary")
    check(out["logits_finite"], "a logit is not finite")

    log("serve: profiled prefill and decode steps")
    inputs = serve.serve_inputs(cfg, batch, prompt, 3, DEVICE)
    prefill_prof = profile_device(torch, lambda: model.prefill(inputs),
                                  CUDA_NAMES[kernel], by_caller=True)
    if cfg.encoder is not None:
        cache = model.init_cache(batch, prompt + SERVE_GEN, enc_seq=prompt)
    else:
        cache = model.init_cache(batch, prompt + SERVE_GEN)
    slots = {c[part]["k"].shape[1] for c in cache
             for part in ("mixer", "self") if "k" in c.get(part, {})}
    if "tokens" in inputs:
        step_in = inputs["tokens"][:, :1]
    else:                       # a stub model's token output embedding
        step_in = params["embed_out"][torch.as_tensor(
            np.random.default_rng(3).integers(0, cfg.vocab_size, batch),
            device=DEVICE)][:, None]

    def decode_steps(n=4):
        for i in range(n):
            model.decode_step(cache, step_in, prompt + i)

    decode_steps(1)
    decode_prof = profile_device(torch, decode_steps)
    del cache, inputs, step_in

    layers, cbatch, cprompt = CHECK.get(
        arch, (tuple(range(CHECK_LAYERS)), SERVE_BATCH, CHECK_PROMPT))
    log(f"serve: float32 layers {layers}, kernel vs plain path")
    cfg32, keep = check_model(cfg, params, layers, kinds)
    n_f32 = kernel_layers(cfg32, kernel, lm)
    del model, params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    small = _to_f32(keep)
    del keep
    inputs = serve.serve_inputs(cfg32, cbatch, cprompt, 2, DEVICE)
    if cfg.mrope_sections is not None:
        inputs["positions"] = torch.as_tensor(
            patch_triples(np, cbatch, cprompt), device=DEVICE)
    build.reset_launches()
    kern, _ = models.build_model(cfg32, DEVICE, params=small).prefill(
        inputs)
    plain, _ = models.build_model(cfg32.replace(attention_impl="plain"),
                                  DEVICE, params=small).prefill(inputs)
    f32_launches = build.LAUNCHES[f"{kernel}:f32_cuda_core"]
    check(f32_launches == n_f32, f"the float32 {kernel} kernel "
          f"launched {f32_launches} times in {len(layers)} float32 layers, "
          f"expected {n_f32}")
    diff = (kern - plain).abs().max().item()
    top = plain.abs().max().item()
    check(diff <= CHECK_REL * top, f"{arch} prefill logits, kernel vs "
          f"plain path: max |diff| {diff} > {CHECK_REL} * max |logit| {top}")
    check_peak = torch.cuda.max_memory_allocated()
    check(check_peak < 75e9, f"{cfg.name}'s float32 check peaks at "
          f"{check_peak / 1e9:.1f} GB")
    del small, kern, plain, inputs
    torch.cuda.empty_cache()
    return {"phase": "serve", "arch": cfg.name, "layers": cfg.num_layers,
            "published_layers": published,
            "encoder_layers": (cfg.encoder.num_layers
                               if cfg.encoder is not None else None),
            "cut": SERVE_CUT_WHY.get(arch),
            "kinds": [list(k) for k in kinds],
            "d_model": cfg.d_model, "params": n_params,
            "batch": batch, "prompt_len": prompt,
            "gen": SERVE_GEN, "weight_gb": weight_bytes / 1e9,
            "cache_mb": out["kv_cache_bytes"] / 1e6,
            "kv_slots": sorted(slots), "window": cfg.window,
            "peak_allocated_gb": peak / 1e9, "init_s": t_init,
            "prefill_s": out["prefill_s"], "decode_s": out["decode_s"],
            "decode_tok_per_s": out["tok_per_s"],
            "kernel": kernel, "kernel_launches": launches[kernel],
            "tokens_in_vocab": True, "logits_finite": True,
            "first_tokens": toks[0, :8].tolist(),
            "prefill_profile": prefill_prof,
            "decode_profile_4_steps": decode_prof,
            "f32_check": {"layers": list(layers), "batch": cbatch,
                          "prompt": cprompt,
                          "mrope_triples": cfg.mrope_sections is not None,
                          "f32_kernel_launches": f32_launches,
                          "max_abs_diff": diff, "max_abs_logit": top,
                          "rel": diff / top, "tol_rel": CHECK_REL,
                          "peak_allocated_gb": check_peak / 1e9}}


# -- phase 13: training (run last) ---------------------------------------------

def _train_fields(mets, step_s, peak, tokens) -> dict:
    """Per-step losses, MoE auxiliary losses and gradient norms, the walls
    after the first, the tokens a second over them, and the peak memory;
    checks each loss, aux and norm is finite."""
    import math
    losses = [m["loss"] for m in mets]
    auxes = [m["aux"] for m in mets]
    norms = [m["grad_norm"] for m in mets]
    check(all(math.isfinite(v) for v in losses + auxes + norms),
          f"a train loss, aux or gradient norm is not finite: {losses} "
          f"{auxes} {norms}")
    walls = step_s[1:]
    return {"losses": losses, "aux": auxes, "grad_norms": norms,
            "step_s": step_s,
            "tokens_per_s": tokens * len(walls) / sum(walls),
            "peak_allocated_gb": peak / 1e9}


def _leaf(params, name: str):
    """The leaf at a dotted path of a parameter tree ("layers.0.mlp.wo")."""
    node = params
    for part in name.split("."):
        node = node[int(part)] if isinstance(node, list) else node[part]
    return node


def _moved(before: dict, params) -> dict:
    """The share of each snapshotted leaf's entries that training changed
    (a bf16 weight moves only where the update passes half its ulp)."""
    out = {}
    for name, b in before.items():
        a = _leaf(params, name)
        out[name] = float((a.detach() != b).float().mean())
    check(all(v > 0 for v in out.values()), f"parameters did not move: "
          f"{out}")
    return out


SNAPSHOT = {"rwkv6-3b": ("layers.0.mixer.wr", "layers.0.mlp.wk"),
            "qwen3-14b": ("layers.0.mixer.wq", "layers.0.mlp.wi_up"),
            "deepseek-moe-16b": ("layers.0.mlp.wi_up", "layers.1.mlp.router",
                                 "layers.1.mlp.wi_gate"),
            "jamba-1.5-large-398b": ("layers.0.mixer.in_proj",
                                     "layers.0.mixer.out_proj",
                                     "layers.0.mlp.wi_up"),
            "whisper-base": ("frontend", "enc_layers.0.attn.wq",
                             "dec_layers.0.cross_attn.wk",
                             "dec_layers.0.mlp.wo")}
# why a run is cut in depth: its full depth's training state (bf16 weights
# and gradients, float32 AdamW moments: 12 bytes a parameter) on the card
CUT_WHY = {"rwkv6-3b": "full depth fits (3.07 B params x 12 bytes = 37 GB "
                       "of training state), but its 4 steps and one "
                       "profiled step took 35-52 s of the script's 1,200 s "
                       "(chip runs at full depth on an H100)",
           "qwen3-14b": "full depth needs 14.77 B params x 12 bytes (bf16 "
                        "weights and gradients, float32 AdamW moments) = "
                        "177 GB of training state against the card's 80 GB",
           "deepseek-moe-16b": "full depth needs 16.38 B params x 12 bytes "
                               "(bf16 weights and gradients, float32 AdamW "
                               "moments) = 197 GB of training state against "
                               "the card's 80 GB",
           "jamba-1.5-large-398b": "one layer (Mamba/dense) is 2.08 B params "
                                   "x 12 bytes (bf16 weights and gradients, "
                                   "float32 AdamW moments) = 25 GB of "
                                   "training state; a second brings a "
                                   "9.66 B MoE MLP: 146 GB against the "
                                   "card's 80 GB"}


def _snapshot(params, names) -> dict:
    return {name: _leaf(params, name).detach().clone() for name in names}


def train_full(torch, build, TT, adamw, DataConfig, shard_batch_at, arch):
    """``arch`` (``whisper-base``) at its published width and depth
    through ``train_loop`` (its init snapshotted for the moved check),
    then one profiled step."""
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    log(f"train: {arch}, batch {TRAIN_BATCH}, seq {TRAIN_SEQ}, "
        f"{TRAIN_STEPS} steps")
    before = {}
    real = TT.build_model

    def build_model(*args, **kw):
        model = real(*args, **kw)
        before.update(_snapshot(model.params, SNAPSHOT[arch]))
        return model

    TT.build_model = build_model
    try:
        out = TT.train_loop(arch, TRAIN_REDUCED, TRAIN_STEPS,
                            seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                            tc=TT.TrainConfig(log_interval=1),
                            device=DEVICE)
    finally:
        TT.build_model = real
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    kernels = {k: v for k, v in build.LAUNCHES.items() if v}
    check(not kernels, f"the trainer launched {kernels}: it runs 'plain'")
    check(peak < 75e9, f"{arch} training peaks at {peak / 1e9:.1f} GB")
    model, params, opt = out["api"], out["params"], out["opt_state"]
    cfg = model.cfg
    moved = _moved(before, params)
    fields = _train_fields(out["metrics"], out["step_s"], peak,
                           TRAIN_BATCH * TRAIN_SEQ)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    batch = TT._prep_batch(shard_batch_at(dcfg, TRAIN_STEPS, 0, 1), model,
                           DEVICE)
    step = TT.make_train_step(model, adamw.AdamWConfig(), cfg)
    log(f"train: {arch}, one profiled step")
    prof = profile_device(torch, lambda: step(params, opt, batch))
    n_params = sum(p.numel() for p in model.parameters())
    del out, model, params, opt, batch, step, before
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "layers": cfg.num_layers,
            "published_layers": cfg.num_layers, "d_model": cfg.d_model,
            "params": n_params, "remat": cfg.remat,
            "attention_impl": cfg.attention_impl, "batch": TRAIN_BATCH,
            "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "through": "train_loop",
            "moved_share": moved, **fields, "profiled_step": prof}


def train_cut(torch, build, TT, adamw, models, DataConfig, shard_batch_at,
              arch):
    """``arch`` at its published width with its first
    ``TRAIN_CUT_LAYERS[arch]`` layers (rwkv6-3b's and qwen3-14b's first 4,
    deepseek-moe-16b's prelude and 3 MoE layers; jamba's Mamba/dense
    layer), through ``make_train_step`` on the
    pipeline's batches, then one profiled step."""
    from repro_torch.models import lm
    cfg = TT.train_config(arch, TRAIN_REDUCED)
    published = cfg.num_layers
    cfg = cut_depth(cfg, min(TRAIN_CUT_LAYERS[arch], published), lm)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    log(f"train: {arch}, {cfg.num_layers} of {published} layers")
    model = models.build_model(cfg, DEVICE, seed=0)
    model.requires_grad_(True)
    params = model.params
    before = _snapshot(params, SNAPSHOT[arch])
    opt = adamw.init(params)
    step = TT.make_train_step(model, adamw.AdamWConfig(
        schedule=adamw.cosine_schedule(10, TRAIN_STEPS)), cfg)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    mets, step_s = [], []
    for s in range(TRAIN_STEPS):
        batch = TT._prep_batch(shard_batch_at(dcfg, s, 0, 1), model, DEVICE)
        t0 = time.time()
        params, opt, m = step(params, opt, batch)
        mets.append({k: float(v) for k, v in m.items()})
        step_s.append(time.time() - t0)
    peak = torch.cuda.max_memory_allocated()
    kernels = {k: v for k, v in build.LAUNCHES.items() if v}
    check(not kernels, f"the trainer launched {kernels}: it runs 'plain'")
    moved = _moved(before, params)
    check(peak < 75e9, f"{arch} at {cfg.num_layers} layers peaks at "
          f"{peak / 1e9:.1f} GB")
    fields = _train_fields(mets, step_s, peak,
                           TRAIN_BATCH * TRAIN_SEQ)
    batch = TT._prep_batch(shard_batch_at(dcfg, TRAIN_STEPS, 0, 1), model,
                           DEVICE)
    log(f"train: {arch}, one profiled step")
    prof = profile_device(torch, lambda: step(params, opt, batch))
    n_params = sum(p.numel() for p in model.parameters())
    del model, params, opt, batch, step, before
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "layers": cfg.num_layers,
            "published_layers": published, "cut": CUT_WHY[arch],
            "d_model": cfg.d_model, "params": n_params, "remat": cfg.remat,
            "attention_impl": cfg.attention_impl, "batch": TRAIN_BATCH,
            "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
            "through": "make_train_step", "moved_share": moved,
            **fields, "profiled_step": prof}


def train_card_vs_cpu(torch, TT, adamw, models, DataConfig, shard_batch_at,
                      tree):
    """The reduced float32 model's ``TRAIN_CHECK_STEPS`` steps on the card
    and on the CPU from the same weights and batches."""
    from repro_torch.models import lm
    out = {}
    for arch, layers in TRAIN_CHECK_ARCHS.items():
        cfg = TT.train_config(arch, reduced=True)
        if layers is not None:
            cfg = cut_depth(cfg, layers, lm)
        init = models.build_model(cfg, "cpu", seed=0).params
        runs = {}
        for dev in ("cpu", DEVICE):
            params = tree.tree_map(lambda t: t.detach().to(dev).clone(),
                                   init)
            model = models.build_model(cfg, torch.device(dev),
                                       params=params)
            model.requires_grad_(True)
            params = model.params
            opt = adamw.init(params)
            step = TT.make_train_step(model, adamw.AdamWConfig(
                schedule=adamw.cosine_schedule(10, 30)), cfg)
            dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                              global_batch=8)
            mets = []
            for s in range(TRAIN_CHECK_STEPS):
                batch = TT._prep_batch(shard_batch_at(dcfg, s, 0, 1), model,
                                       dev)
                params, opt, m = step(params, opt, batch)
                mets.append({k: float(v) for k, v in m.items()})
            runs[dev] = (mets, [p.detach().cpu()
                                for p in tree.leaves(params)])
        (cm, cp), (dm, dp) = runs["cpu"], runs[DEVICE]
        loss_rel = max(abs(b["loss"] - a["loss"]) / abs(a["loss"])
                       for a, b in zip(cm, dm))
        aux_rel = max((abs(b["aux"] - a["aux"]) / abs(a["aux"])
                       if a["aux"] else abs(b["aux"]))
                      for a, b in zip(cm, dm))
        norm_rel = max(abs(b["grad_norm"] - a["grad_norm"]) / a["grad_norm"]
                       for a, b in zip(cm, dm))
        param_abs = max(float((a - b).abs().max()) for a, b in zip(cp, dp))
        # the tolerances of tests/test_torch_train.py (losses rel 1e-5,
        # gradient norms rel 1e-4: sums in another order); AdamW normalises
        # each coordinate, so a gradient near 0 that rounds differently on
        # the two devices moves its weight by up to 2 lr a step: 3 steps,
        # 6 lr
        lr = adamw.AdamWConfig().lr
        check(loss_rel <= 1e-5 and aux_rel <= 1e-5 and norm_rel <= 1e-4
              and param_abs <= 2 * TRAIN_CHECK_STEPS * lr,
              f"{arch} reduced train steps, card vs CPU: loss rel "
              f"{loss_rel}, aux rel {aux_rel}, grad norm rel {norm_rel}, "
              f"params {param_abs}")
        out[arch] = {"layers": cfg.num_layers,
                     "steps": TRAIN_CHECK_STEPS, "loss_rel": loss_rel,
                     "aux_rel": aux_rel,
                     "grad_norm_rel": norm_rel, "param_max_abs": param_abs,
                     "param_tol": 2 * TRAIN_CHECK_STEPS * lr,
                     "losses": [m["loss"] for m in dm]}
    return out


@contextlib.contextmanager
def _manifest_ops():
    """While open, record every manifest operation of the
    ``CheckpointStore`` (each put's name and value, each get's name and
    answer, each save's closing flush), in order."""
    from repro_torch.checkpoint.store import CheckpointStore
    ops = []
    put, get, save = (CheckpointStore._mput, CheckpointStore._mget,
                      CheckpointStore.save)

    def mput(self, name, value):
        ops.append(("put", name, value))
        put(self, name, value)

    def mget(self, name):
        v = get(self, name)
        ops.append(("get", name, v))
        return v

    def msave(self, *args, **kw):
        save(self, *args, **kw)
        ops.append(("flush",))

    CheckpointStore._mput, CheckpointStore._mget, CheckpointStore.save = \
        mput, mget, msave
    try:
        yield ops
    finally:
        CheckpointStore._mput, CheckpointStore._mget, CheckpointStore.save = \
            put, get, save


def _replay_manifest(cfg, ops) -> tuple:
    """The recorded operations on a CPU manifest of the same tuning:
    (the tree, the engine calls it made, whether every get answered as
    the card's did)."""
    import json

    from repro_torch.checkpoint.store import _key_of
    from repro_torch.lsm import LSMTree
    tree = LSMTree(cfg, device="cpu")
    same = True
    with _engine_calls() as calls:
        for op in ops:
            if op[0] == "put":
                tree.put(_key_of(op[1]), json.dumps(op[2]))
            elif op[0] == "get":
                v = tree.get(_key_of(op[1]))
                same &= (None if v is None else json.loads(v)) == op[2]
            else:
                tree.flush()
    return tree, dict(calls), same


def train_checkpointed(torch, build, TT, convert, tree):
    """The reduced ``qwen3-14b`` through ``train_loop`` on the card with a
    checkpoint every ``TRAIN_CKPT_INTERVAL`` steps, then a restore of the
    last one; the manifest's launches and state against a CPU replay of
    its operations."""
    import tempfile
    arch = "qwen3-14b"
    with tempfile.TemporaryDirectory(prefix="train_ckpt_") as d, \
            _manifest_ops() as ops:
        build.reset_launches()
        t0 = time.time()
        out = TT.train_loop(arch, True, TRAIN_CKPT_STEPS, ckpt_dir=d,
                            tc=TT.TrainConfig(
                                ckpt_interval=TRAIN_CKPT_INTERVAL,
                                log_interval=100), device=DEVICE)
        cfg, store = out["api"].cfg, out["store"]
        saved = convert.lm_params_to_reference(cfg, out["params"])
        saved_opt = convert.adamw_state_to_reference(cfg, out["opt_state"])
        back, meta = store.restore(saved)
        back_opt = store.restore_opt_state(saved_opt)
        hb = store.heartbeats(1)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {k: build.LAUNCHES[k] for k in ("dual_solve", "merge",
                                                   "point_read")}
    same_back = all(torch.equal(a, b) for a, b in zip(
        tree.leaves(saved) + tree.leaves(saved_opt),
        tree.leaves(back) + tree.leaves(back_opt)))
    check(same_back, "restore / restore_opt_state differ from the last "
          "save")
    check(meta["step"] == TRAIN_CKPT_STEPS - 1 and hb[0]["step"]
          == TRAIN_CKPT_STEPS - 1, f"restore meta {meta}, heartbeats {hb}")
    man = store.manifest
    replay, calls, answers = _replay_manifest(man.cfg, ops)
    check(answers, "the CPU replay's gets answered otherwise than the "
          "card's")
    check(replay.stats.as_dict() == man.stats.as_dict()
          and replay.shape() == man.shape(),
          f"manifest IOStats/shape, card {man.stats.as_dict()} "
          f"{man.shape()} vs CPU {replay.stats.as_dict()} "
          f"{replay.shape()}")
    check(launches["dual_solve"] == STEPS + 1, f"dual_solve launched "
          f"{launches['dual_solve']} times, one storm is {STEPS + 1}")
    for k in ("merge", "point_read"):
        check(launches[k] == calls[k] and calls[k] > 0, f"{k} launched "
              f"{launches[k]} times, the CPU replay calls {calls[k]}")
    saves = sum(op[0] == "flush" for op in ops)
    return {"arch": cfg.name, "steps": TRAIN_CKPT_STEPS,
            "ckpt_interval": TRAIN_CKPT_INTERVAL, "saves": saves,
            "wall_s": wall, "launches": launches, "cpu_replay_calls": calls,
            "manifest_ops": len(ops),
            "puts": man.stats.queries["w"],
            "pages_written": man.stats.comp_pages_written,
            "shape": man.shape(), "io_stats_equal_cpu": True,
            "tuning": {"T": man.cfg.T, "K": list(man.cfg.K),
                       "buf_entries": man.cfg.buf_entries,
                       "filter_bits_per_entry":
                           man.cfg.mfilt_bits_per_entry},
            "restore_bit_identical": True,
            "final_loss": out["losses"][-1]}


def phase_train(torch, build, models) -> dict:
    """The trainer on the card: ``whisper-base`` at full size, 4-layer
    ``rwkv6-3b`` and ``qwen3-14b``, ``deepseek-moe-16b`` (its prelude and
    3 MoE layers) and a 1-layer ``jamba-1.5-large-398b`` at full width,
    the reduced models card against CPU, and a checkpointed run whose
    manifest runs the engine's kernels."""
    from repro_torch import convert
    from repro_torch.data.pipeline import DataConfig, shard_batch_at
    from repro_torch.launch import train as TT
    from repro_torch.optim import adamw
    from repro_torch.utils import tree
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    full = [train_full(torch, build, TT, adamw, DataConfig, shard_batch_at,
                       arch) for arch in TRAIN_FULL]
    cuts = [train_cut(torch, build, TT, adamw, models, DataConfig,
                      shard_batch_at, arch) for arch in TRAIN_CUT_LAYERS]
    log("train: reduced models, card vs CPU")
    parity = train_card_vs_cpu(torch, TT, adamw, models, DataConfig,
                               shard_batch_at, tree)
    log("train: checkpointed run")
    ckpt = train_checkpointed(torch, build, TT, convert, tree)
    return {"phase": "train", "wall_s": time.time() - t0,
            "runs": [*full, *cuts], "card_vs_cpu": parity,
            "checkpointed": ckpt}


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


def dual_check(torch, ops, ref, C, W, rho, llam, max_dl=0.1) -> dict:
    """One lane batch through the kernel and its plain version, with the
    envelope gradient: values to rel 1e-5, 99% of log lambda within 1e-5
    (none off by more than ``max_dl``), and ``dc`` to rel 1e-5."""
    v1, l1, dc1 = ops.dual_solve_warm_batch(C, W, rho, llam, grad=True)
    v2, l2, dc2 = ref.dual_solve_warm_ref(C, W, rho, llam, grad=True)
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

    dc_at = ref.envelope_grad(C, W, rho, l1)
    dc_rel = rel_err(dc1, dc_at)
    same_l = l1 == l2
    dc_plain_rel = rel_err(dc1[same_l], dc2[same_l])
    L, n = C.shape
    check(rel <= 1e-5, f"dual_solve ({L}, {n}): value rel {rel} > 1e-5")
    check(frac >= 0.99 and dl.max().item() <= max_dl,
          f"dual_solve ({L}, {n}): log lambda {frac} within 1e-5, max "
          f"{dl.max()}")
    check(dc_rel <= 1e-5 and dc_plain_rel <= 1e-5,
          f"dual_solve ({L}, {n}): dc rel {dc_rel} (at the kernel's "
          f"lambda), {dc_plain_rel} (the plain dc, lambdas equal) > 1e-5")
    return {"L": L, "n": n, "val_max_rel": rel,
            "val_max_abs": (v1 - v2).abs().max().item(),
            "llam_frac_within_1e-5": frac,
            "llam_max_abs": dl.max().item(),
            "bit_equal_lane_share": ((v1 == v2) & (l1 == l2))
            .float().mean().item(),
            "dc_max_rel": dc_rel, "dc_plain_max_rel": dc_plain_rel,
            "dc_max_abs": (dc1 - dc_at).abs().max().item()}


def dual_bound(L: int, n: int) -> dict:
    """``bound`` of one no-grad solve of L lanes of n costs: C, W, rho
    and log lambda read, value and log lambda written; 12 g-evaluations
    a lane (3 local, 2 bracket, 6 golden, 1 final) of ~6n + 6
    operations."""
    return bound(L * (2 * n + 2 + 2) * 4, L * (3 + 2 + 6 + 1) * (6 * n + 6))


def dual_wide_inputs(torch, np, L: int, n: int, dev,
                     rho_zero: bool = False) -> tuple:
    """The ``kernels`` suite's dual-solve inputs (``bench/kernels.py``:
    seed 3, gamma costs, Dirichlet weights, rho 0.25, log lambda of the
    cost range) at L lanes of n costs; with ``rho_zero``, rho 0 on every
    7th lane."""
    rng = np.random.default_rng(3)
    C = rng.gamma(2.0, 2.0, (L, n)).astype(np.float32)
    W = rng.dirichlet(np.ones(n), L).astype(np.float32)
    rho = np.full(L, 0.25, np.float32)
    if rho_zero:
        rho[::7] = 0.0
    llam = np.log(C.max(1) - C.min(1)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (C, W, rho, llam))


def kernel_dual_solve(torch, np, core, ops, ref, dev):
    """The tuner's step-0 lane batch (``dual_inputs``, 9,600 lanes), and a
    ragged batch with rho = 0 lanes, each held by ``dual_check``; the
    no-grad call timed (``dual_times``) and the tuner's call, with ``dc``,
    by its device ms.  Then the 17-64-component lanes (16 threads of 4
    components each) that the ``kernels`` suite runs: its 1,024 x 64
    batch as the suite makes it, timed beside its ``bound``, and 1,000 x
    33 and 1,000 x 17 (partly filled lanes, rho 0 on every 7th), each
    held by ``dual_check``."""
    C, W_l, rho, llam = dual_inputs(torch, core, dev)
    m = min(1237, C.shape[0])                  # ragged: not a block multiple
    rho_m = torch.where(torch.arange(m, device=dev) % 7 == 0, 0.0, rho[:m])
    rows = [dual_check(torch, ops, ref, *b)
            for b in ((C, W_l, rho, llam),
                      (C[:m], W_l[:m], rho_m, llam[:m]))]
    Cw, Ww, rw, lw = dual_wide_inputs(torch, np, 1024, 64, dev)
    # a sum of 64 terms rounds otherwise than torch's pairwise one, and a
    # flipped golden compare may move a lane anywhere in the scan's
    # bracket, log lambda +- 0.8 (as tests/test_torch_cuda.py holds it)
    wide = [dual_check(torch, ops, ref, Cw, Ww, rw, lw, max_dl=1.6)] + [
        dual_check(torch, ops, ref, *dual_wide_inputs(torch, np, 1000, n,
                                                      dev, rho_zero=True),
                   max_dl=1.6)
        for n in (33, 17)]
    L, n = C.shape
    return {"name": "dual_solve", "route": "cuda",
            "source": "src/repro_torch/csrc/dual_solve.cu",
            "replaces": "src/repro/kernels/dual_solve/kernel.py:93",
            "max_abs_err": max(r["val_max_abs"] for r in rows + wide),
            **dual_times(torch, ops, ref, C, W_l, rho, llam),
            "grad_device_ms": device_ms(
                torch, lambda: ops.dual_solve_warm_batch(
                    C, W_l, rho, llam, grad=True), 50,
                CUDA_NAMES["dual_solve"]),
            "library_ms": None,
            **dual_bound(L, n),
            "checks": rows,
            "wide": {**dual_times(torch, ops, ref, Cw, Ww, rw, lw),
                     **dual_bound(1024, 64), "checks": wide}}


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
    ak, av, bk, bv = runs[0]
    wall, events = cuda_events(
        torch, replay, calls=len(sizes),
        lead=lambda: ops.merge_runs([ak, bk], [av, bv]))
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
    # whole when it holds one point_read kernel a launch; a trace may miss
    # the first launch of a kernel in it, so each one is launched once
    # (``lead``) before the kept replay
    name = CUDA_NAMES["point_read"]
    tries = 5
    for attempt in range(tries):
        wall, events = cuda_events(torch, replay, tries=1, lead=replay)
        got = sum(name in n for n, _ in events)
        if got == len(reads):
            break
        log(f"point_read replay: trace {attempt + 1} of {tries} holds "
            f"{got} of {len(reads)} launches")
    check(got == len(reads), "point_read replay: traces miss launches")
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
    with H = KV, a GQA group of 16, a 512 window, jamba's 64/8 heads,
    mixtral's 4,096 window at (2, 6144)) to 2e-2, and the float32
    cases of ``FLASH_F32_CASES`` (d 64 with a 512 window, d 96 non-causal,
    a ragged S) to 2e-5; each case names the kernel whose launch count
    moved (``bf16_tc`` or ``f32_cuda_core``).  The prefills of
    ``FLASH_BF16_TIMED`` (whisper's encoder and decoder, qwen2-vl) are
    held to 2e-2 and each timed beside SDPA (``model_cases``)."""
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

    def timed(name, shape, causal):
        """One serving prefill's shape: held to the plain version at 2e-2,
        timed beside SDPA, with its bound."""
        q, k, v = draw(*shape, torch.bfloat16)
        before = dict(build.LAUNCHES)
        got = ops.flash_attention(q, k, v, causal=causal)
        served = [var.split(":")[1] for var in build.VARIANTS
                  if build.LAUNCHES[var] > before[var]]
        want = ref.flash_attention_ref(q, k, v, causal=causal)
        err = (got.float() - want.float()).abs()
        check(bool((err <= 2e-2 + 2e-2 * want.float().abs()).all()),
              f"flash_attention {name} {shape}: kernel != plain (max abs "
              f"{err.max().item()})")
        check(served == ["bf16_tc"], f"flash_attention {name}: served by "
              f"{served}, expected bf16_tc")
        lib = sdpa(q, k, v, causal)
        lib_diff = (lib().transpose(1, 2).float() - got.float()).abs().max()
        check(lib_diff.item() <= 0.1, f"flash_attention {name}: kernel and "
              f"SDPA differ by {lib_diff.item()}")
        B, S, H, KV, d = shape
        pairs = B * H * S * (S + 1) // 2 if causal else B * H * S * S
        moved = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        call = lambda: ops.flash_attention(q, k, v, causal=causal)  # noqa
        return {"case": name, "B_S_H_KV_d": list(shape), "causal": causal,
                "tol": 2e-2, "kernel": served[0],
                "max_abs_err": err.max().item(),
                "ms": time_ms(torch, call, 10),
                "library_ms": time_ms(torch, lib, 10),
                "library_max_abs_diff": lib_diff.item(),
                **bound(moved, pairs * 4 * d, BF16_OPS_PER_S)}

    model_cases = [timed(*case) for case in FLASH_BF16_TIMED]
    pairs = B * H * S * (S + 1) // 2            # causal: unmasked (q, k)
    moved = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    call = lambda: ops.flash_attention(q, k, v, causal=True)  # noqa: E731
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_wgmma.cu",
            "f32_source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:96",
            "max_abs_err": max(r["max_abs_err"]
                               for r in rows + model_cases),
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
            **bound(moved, pairs * 4 * d, BF16_OPS_PER_S), "checks": rows,
            "model_cases": model_cases}


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
    trace can drop a launch) is taken again, up to five times."""
    sys_e = core.LSMSystem(entry_bits=float(fig10.ENTRY_BITS[0]))
    fig10.robust_tunings(sys_e, DEVICE, starts)          # warm
    name = CUDA_NAMES["dual_solve"]
    tries = 5
    for attempt in range(tries):
        build.reset_launches()
        _, events = cuda_events(torch, lambda: fig10.robust_tunings(
            sys_e, DEVICE, starts), tries=1)
        wrapper = build.LAUNCHES["dual_solve"]
        traced = sum(name in n for n, _ in events)
        if traced == wrapper:
            break
        log(f"suites: fig10 trace {attempt + 1} of {tries} holds "
            f"{traced} of {wrapper} dual_solve launches")
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
        if suite in ENGINE_SUITES:
            check(all(launches.get(k, 0) for k in ("merge", "point_read")),
                  f"suite {suite}: the card's engine launched {launches}")
    return lines


def phase_robust_serving(torch, build) -> dict:
    """``python -m repro_torch.robust_serving`` on the card: the example's
    full spec (ZippyDB-like mix, rho 0.25 / 1 / 2 and nominal, the klsm
    and lazy_leveling arms, 32 starts, 150 Adam steps, 4,000 benchmark
    mixes, ``backend="sharded"``: one chunk on one card), the launch
    counts set to 0 just before it: one ``dual_solve`` per robust Adam
    step plus one, for each arm's robust grid.  Then the same spec on the
    CPU from the same starts (the tuners' own draw, made on the host): the
    same chosen arm and design in every cell, each arm's cost and
    objective within the suites' band on the card (0.01 + 0.01 x the
    CPU's: float32 Adam on the two devices ends 2.3e-4 apart in one
    robust cell's flat region), the largest relative gap printed."""
    import repro_torch.api as api
    from repro_torch import robust_serving as rs
    spec = rs.SPEC
    log("robust_serving: the example's spec on the card")
    build.reset_launches()
    t0 = time.time()
    report = rs.main(DEVICE, verbose=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k: v for k, v in build.LAUNCHES.items() if v}
    want = len(api.compile_spec(spec).tuning_plans()) \
        * (spec.design.steps + 1)
    check(launches.get("dual_solve", 0) == want, f"robust_serving: "
          f"{launches.get('dual_solve', 0)} dual_solve launches, expected "
          f"{want}")
    check(report.walls.get("tuning_devices") == 1, f"robust_serving: "
          f"{report.walls.get('tuning_devices')} tuning devices, one card")
    log("robust_serving: the same spec on the CPU")
    t0 = time.time()
    cpu = rs.main("cpu", verbose=False)
    cpu_s = time.time() - t0
    cells, max_rel = {}, 0.0

    def near(card, host):
        nonlocal max_rel
        max_rel = max(max_rel, abs(card - host) / abs(host))
        return abs(card - host) <= 0.01 + 0.01 * abs(host)

    for cell in report.cells:
        name = "nominal" if cell[1] is None else f"rho{cell[1]:g}"
        check(report.chosen[cell] == cpu.chosen[cell], f"robust_serving "
              f"{name}: card picks {report.chosen[cell]}, CPU "
              f"{cpu.chosen[cell]}")
        for pol in spec.design.policies:
            a, b = cpu.tuning(cell, pol), report.tuning(cell, pol)
            check(b.design.value == a.design.value and near(b.cost, a.cost)
                  and near(report.arm_costs[cell][pol],
                           cpu.arm_costs[cell][pol]),
                  f"robust_serving {name} {pol}: card "
                  f"{b.describe(report.sys)} cost {b.cost}, CPU "
                  f"{a.describe(cpu.sys)} cost {a.cost}")
        rr = report.tuning(cell)
        cells[name] = {"policy": report.chosen[cell],
                       "tuning": rr.describe(report.sys), "cost": rr.cost}
        if cell[1] is not None:
            cells[name]["mean_delta_tp_vs_nominal"] = float(
                report.delta_tp_vs_nominal(0, cell[1]).mean())
    return {"phase": "robust_serving", "spec": spec.name,
            "backend": spec.backend, "wall_s": wall, "cpu_wall_s": cpu_s,
            "walls": report.walls, "launches": launches, "cells": cells,
            "same_picks_as_cpu": True, "cost_max_rel_vs_cpu": max_rel}


def phase_api(torch, build) -> dict:
    """The experiment API on the card: ``run_experiment`` for the API
    smoke suite's spec (``repro_torch.bench.api.SPEC``: its tunings and its
    trial on the card, the launch counts
    set to 0 just before it), then that spec's ``TrialPlan`` through
    ``execute_trial`` on the card and on the CPU plain path.  Every tree's
    ``IOStats``, I/O per query and ``TreeProbe`` must be bit-identical on
    both and equal the report's own trial; the card's trial must launch
    ``merge`` and ``point_read``, and the tunings one ``dual_solve`` per
    robust Adam step plus one, for each of the spec's two robust grids."""
    import dataclasses

    import repro_torch.api as api
    from repro_torch.bench import api as api_suite
    spec = api_suite.SPEC
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


# -- the suites held against the port's CPU run, and the drift phase ---------

@contextlib.contextmanager
def _retune_calls():
    """Record every ``LSMTree.retune`` call while the context is open: a
    list of (tree label, T, K, buffer entries) after each call, noop or
    not."""
    from repro_torch.lsm import LSMTree
    calls = []
    real = LSMTree.retune

    def retune(tree, phi, sys):
        real(tree, phi, sys)
        calls.append((tree.obs_label, tree.cfg.T, list(tree.cfg.K),
                      tree.cfg.buf_entries))

    LSMTree.retune = retune
    try:
        yield calls
    finally:
        LSMTree.retune = real


@contextlib.contextmanager
def _storms(torch, build, replay=None):
    """While open, record every re-tune storm of the drift loop and of the
    memory arbiter (requests, results, the system's bits per entry: a
    memory storm's granted share, wall, each kernel's launches), or with
    ``replay`` (a recorded list) answer the loops' storms from it in order,
    holding each storm's requests and share to the recorded ones bit for
    bit."""
    import numpy as np

    from repro_torch.online import memory, session
    storms = []
    modules = (session, memory)
    real = session.retune_fleet

    def record(requests, sys, **kw):
        before = dict(build.LAUNCHES)
        t0 = time.time()
        out = real(requests, sys, **kw)
        torch.cuda.synchronize()
        storms.append({
            "requests": list(requests), "results": list(out),
            "share": float(sys.bits_per_entry),
            "wall_s": time.time() - t0,
            "launches": {k: v - before.get(k, 0)
                         for k, v in build.LAUNCHES.items()
                         if v - before.get(k, 0)}})
        return out

    def answer(requests, sys, **kw):
        want = replay[len(storms)]
        check(len(requests) == len(want["requests"])
              and float(sys.bits_per_entry) == want["share"] and all(
                  np.array_equal(np.asarray(a.w), np.asarray(b.w))
                  and float(a.rho) == float(b.rho) and a.reason == b.reason
                  for a, b in zip(requests, want["requests"])),
              f"replay: storm {len(storms)} asked for other re-tunes "
              "than the card's")
        storms.append({"requests": list(requests)})
        return want["results"]

    for mod in modules:
        mod.retune_fleet = record if replay is None else answer
    try:
        yield storms
    finally:
        for mod in modules:
            mod.retune_fleet = real
    if replay is not None:
        check(len(storms) == len(replay), f"replay: {len(storms)} "
              f"storms, the card ran {len(replay)}")


def _attack_inputs(phi, w_center, rho_live) -> tuple:
    import numpy as np
    return (phi.T.cpu().numpy().copy(), phi.mfilt_bits.cpu().numpy().copy(),
            phi.K.cpu().numpy().copy(), np.array(w_center, np.float64),
            float(rho_live))


@contextlib.contextmanager
def _attacks(replay=None):
    """While open, record every attack of the adversary scenario (the
    defender state it read, the mix and the regret record it returned), or
    with ``replay`` (a recorded list) answer each attack with the recorded
    mix and record, in order: the defender state must be the recorded one
    bit for bit, and this run's own attack on it (on the device the loop
    passes) must give the recorded record by the port's one rule
    (``record_mismatches``: rel 1e-5, ``le_dual_bound`` equal).  The list
    holds, per attack, the recorded entry and this run's own record."""
    import numpy as np

    from repro_torch.scenarios import AdversaryScenario
    from repro_torch.scenarios.adversary import record_mismatches
    attacks = []
    real = AdversaryScenario.attack

    def record(self, phi, w_center, rho_live, sys, device=None):
        mix, rec = real(self, phi, w_center, rho_live, sys, device=device)
        attacks.append({"inputs": _attack_inputs(phi, w_center, rho_live),
                        "mix": np.array(mix), "record": dict(rec)})
        return mix, rec

    def answer(self, phi, w_center, rho_live, sys, device=None):
        want = replay[len(attacks)]
        check(all(np.array_equal(a, b) for a, b in zip(
            _attack_inputs(phi, w_center, rho_live), want["inputs"])),
            f"replay: attack {len(attacks)} read another defender state "
            "than the card's")
        _, own = real(self, phi, w_center, rho_live, sys, device=device)
        ref = want["record"]
        bad = record_mismatches(own, ref)
        check(not bad, f"replay: attack {len(attacks)} on the CPU parts "
              f"from the card on {bad}: {own} != {ref}")
        attacks.append({"own": own})
        return np.array(want["mix"]), dict(ref)

    AdversaryScenario.attack = record if replay is None else answer
    try:
        yield attacks
    finally:
        AdversaryScenario.attack = real
    if replay is not None:
        check(len(attacks) == len(replay), f"replay: {len(attacks)} "
              f"attacks, the card made {len(replay)}")


@contextlib.contextmanager
def _engine_calls():
    """While open, count the calls of the engine's kernel wrappers that
    launch their kernel on the card (a fold step of ``merge_runs``; a
    per-level point read of a non-empty batch), on whatever device they
    run: on the CPU they run the plain versions, and the counts say how
    many launches the card's run must have made."""
    from repro_torch.kernels.merge import ops as merge_ops
    from repro_torch.lsm import read_path
    calls = {"merge": 0, "point_read": 0}
    merge, read = merge_ops.merge_newest_wins, read_path._point_read

    def counted_merge(*args):
        calls["merge"] += 1
        return merge(*args)

    def counted_read(q, *args):
        calls["point_read"] += int(q.shape[0] > 0)
        return read(q, *args)

    merge_ops.merge_newest_wins = counted_merge
    read_path._point_read = counted_read
    try:
        yield calls
    finally:
        merge_ops.merge_newest_wins = merge
        read_path._point_read = read


def _records(results) -> dict:
    """A drift run's segment records as plain values."""
    import dataclasses

    import numpy as np
    return {f"w{w}_{arm}": [
        {k: (np.asarray(v).tolist() if isinstance(v, np.ndarray) else v)
         for k, v in dataclasses.asdict(r).items()} for r in res.records]
        for (w, arm), res in results.items()}


def drift_on_cpu(torch, build, report, storms, attacks=()) -> dict:
    """Replay a card drift run on the CPU plain path: the same plan (the
    card's first tunings), every storm answered with the card's results
    and every adversary attack with the card's mix and record (the CPU's
    own attack on the same defender state held to it).  Returns the CPU
    run's records, regret, ``LSMTree.retune`` calls, own attack records
    and the engine's counted kernel-wrapper calls."""
    from repro_torch.api import compile_spec
    from repro_torch.online import execute_drift
    plan = compile_spec(report.spec).build_drift(report)
    with _storms(torch, build, replay=storms), _retune_calls() as calls, \
            _attacks(replay=list(attacks)) as own, _engine_calls() as n:
        results, regret = execute_drift(plan, device="cpu")
    return {"records": _records(results), "regret": regret,
            "retune_calls": calls, "attacks": own, "engine_calls": n}


def memory_on_cpu(torch, build, report, storms) -> dict:
    """Replay a card memory-arbitration run on the CPU plain path: the same
    plan (the card's first tunings), every storm answered with the card's
    results.  Returns the CPU run's records, division events and
    ``LSMTree.retune`` calls."""
    from repro_torch.api import compile_spec
    from repro_torch.online import execute_memory_fleet
    plan = compile_spec(report.spec).build_memory(report)
    with _storms(torch, build, replay=storms), _retune_calls() as calls:
        results, events = execute_memory_fleet(plan, device="cpu")
    return {"records": _records(results), "events": events,
            "retune_calls": calls}


def _storm_summary(storms) -> list:
    """Each storm's size (requests, robust ones, the lane batch after
    power-of-two padding), the system's bits per entry (a memory storm's
    granted share), wall and kernel launches."""
    def padded(k):
        return 1 << (k - 1).bit_length() if k > 1 else k

    out = []
    for st in storms:
        n = len(st["requests"])
        robust = sum(float(r.rho) > 0 for r in st["requests"])
        out.append({"requests": n, "robust": robust,
                    "padded": [padded(n - robust), padded(robust)],
                    "share": st["share"],
                    "reasons": sorted({r.reason for r in st["requests"]}),
                    "wall_s": st["wall_s"], "launches": st["launches"]})
    return out


def _robust_storms(storms) -> int:
    return sum(any(float(r.rho) > 0 for r in s["requests"]) for s in storms)


def suite_against_cpu(torch, build, suite) -> dict:
    """One of ``CPU_HELD_SUITES`` on the card from the committed starts:
    its rows, its held fields against the committed file (misses printed
    by name, not a failure: the JAX package misses some too), and the card
    held against the port's CPU run.  fig6: the CPU's own run, every held
    field within the runner's band.  tab5 and api: the card's ``TrialPlan``
    through the CPU trial, every tree's ``IOStats`` and I/O per query
    bit-identical.  online: each scenario's drift replayed on the CPU from
    the card's tunings and storms, every segment record and
    ``LSMTree.retune`` call identical; memory likewise, with its division
    events; scenarios likewise, every adversary attack answered with the
    card's mix and record (the CPU's own attack on the same defender state
    held to the card's record to rel 1e-5, ``le_dual_bound`` equal), the
    regret records equal and both claim flags true.  online, memory and
    scenarios set the launch counts to 0 before each scenario and check
    each scenario's own.  ``dual_solve`` launches must be one per robust
    Adam step plus one per robust grid and storm; each scenario's
    ``merge`` and ``point_read`` launches must be the calls the CPU replay
    counted (``_engine_calls``), and more than none."""
    import importlib

    import repro_torch.api as api
    from repro_torch.bench import run
    from repro_torch.bench.common import committed_starts
    mod = importlib.import_module(f"repro_torch.bench.{suite}")
    base = run.load_baseline(suite, ROOT)
    log(f"suites: {suite} on the card")
    build.reset_launches()
    t0 = time.time()
    reports, runs = [], []
    if suite in ("online", "memory", "scenarios"):
        specs = mod.specs() if suite != "online" else [
            (kind, mod.make_spec(kind, widx, target))
            for kind, widx, target in mod.SCENARIOS]
        launches = {}
        for kind, spec in specs:
            build.reset_launches()
            t1 = time.time()
            with _storms(torch, build) as st, _retune_calls() as calls, \
                    _attacks() as atk:
                report = api.run_experiment(spec, device=DEVICE,
                                            starts=committed_starts)
            torch.cuda.synchronize()
            own = {k: v for k, v in build.LAUNCHES.items() if v}
            for k, v in own.items():
                launches[k] = launches.get(k, 0) + v
            reports.append((kind, report))
            runs.append({"storms": st, "calls": calls, "launches": own,
                         "attacks": atk, "card_s": time.time() - t1})
        rows = mod.rows_of(reports)
    else:
        spec = mod.make_spec() if suite == "tab5" else mod.SPEC
        report = api.run_experiment(spec, device=DEVICE,
                                    starts=committed_starts)
        rows = mod.rows_of(report, 0.0) if suite == "fig6" \
            else mod.rows_of(report)
        torch.cuda.synchronize()
        launches = {k: v for k, v in build.LAUNCHES.items() if v}
    wall = time.time() - t0
    cmp = run.compare(rows, wall, base)
    line = {"phase": "suites", "suite": suite, "starts": "committed",
            "wall_s": wall, "rows": {r.name: r.derived for r in rows},
            "held_matched": len(cmp["held"]),
            "held_missed": [list(m) for m in cmp["missed"]],
            "launches": launches}

    log(f"suites: {suite} against the CPU")
    t0 = time.time()
    if suite == "fig6":
        cpu = api.run_experiment(spec, device="cpu", starts=committed_starts)
        cpu_rows = mod.rows_of(cpu, 0.0)
        against = run.compare(rows, 0.0, {"rows": [
            {"name": r.name, "derived": r.derived} for r in cpu_rows]})
        check(not against["missed"], f"fig6: the card's rows miss the "
              f"CPU's: {against['missed']}")
        line["card_vs_cpu"] = {"held_matched": len(against["held"]),
                               "missed": 0}
        want_dual = spec.design.steps + 1
    elif suite in ("tab5", "api"):
        plan = api.compile_spec(spec).build_trial(report)
        results, _, _, _ = api.execute_trial(plan, device="cpu")
        for b, res in zip(plan.trees, results):
            card = report.fleet[(b.cell, b.policy)]
            check([r.io.as_dict() for r in res]
                  == [r.io.as_dict() for r in card]
                  and [r.avg_io_per_query for r in res]
                  == [r.avg_io_per_query for r in card],
                  f"{suite}: tree {b.cell}/{b.policy} on the CPU != card")
        line["card_vs_cpu"] = {"trees": len(plan.trees), "identical": True}
        want_dual = len(api.compile_spec(spec).tuning_plans()) \
            * (spec.design.steps + 1)
    else:
        want_dual = 0
        detail = {}
        for (kind, report), card_run in zip(reports, runs):
            st, calls = card_run["storms"], card_run["calls"]
            t1 = time.time()
            if suite in ("online", "scenarios"):
                cpu = drift_on_cpu(torch, build, report, st,
                                   card_run["attacks"])
                card = _records(report.drift)
                check(cpu["regret"] == report.regret, f"{suite} {kind}: "
                      "regret records on the CPU != card")
            else:
                cpu = memory_on_cpu(torch, build, report, st)
                card = _records(report.memory)
                check(cpu["events"] == report.memory_events,
                      f"memory {kind}: division events on the CPU != card")
            check(cpu["records"] == card,
                  f"{suite} {kind}: segment records on the CPU != card")
            check(cpu["retune_calls"] == calls, f"{suite} {kind}: "
                  "LSMTree.retune calls on the CPU != card")
            robust = _robust_storms(st)
            want = report.spec.design.steps + 1 \
                + robust * (report.spec.drift.retune_steps + 1)
            own = card_run["launches"]
            check(own.get("dual_solve", 0) == want, f"{suite} {kind}: "
                  f"{own.get('dual_solve', 0)} dual_solve launches, "
                  f"expected {want}")
            want_dual += want
            detail[kind] = {"storms": len(st), "robust_storms": robust,
                            "retune_calls": len(calls), "launches": own}
            if suite == "scenarios":
                engine = cpu["engine_calls"]
                check(all(own.get(k, 0) == engine[k] > 0 for k in engine),
                      f"scenarios {kind}: the card launched {own}, the CPU "
                      f"replay counted {engine}")
                detail[kind].update(
                    cpu_calls=engine, attacks=len(card_run["attacks"]),
                    dual_solve_want=want,
                    queries=[r.queries for r in
                             report.drift[(0, "online")].records],
                    online_retunes=report.drift[(0, "online")].retunes)
                if report.regret:
                    detail[kind]["windows"] = [
                        {k: r[k] for k in ("segment", "rho", "kl_adv",
                                           "cost_nominal", "cost_adv",
                                           "dual_bound", "le_dual_bound",
                                           "measured_io")}
                        | {"margin": r["dual_bound"] - r["cost_adv"],
                           "cpu_margin": o["own"]["dual_bound"]
                           - o["own"]["cost_adv"]}
                        for r, o in zip(report.regret[0], cpu["attacks"])]
            if suite == "memory":
                _MEMORY_RUN[kind] = dict(card_run, report=report,
                                         cpu_s=time.time() - t1)
        line["card_vs_cpu"] = {"identical": True, "scenarios": detail}
    line["card_vs_cpu"]["cpu_s"] = time.time() - t0
    check(launches.get("dual_solve", 0) == want_dual, f"suite {suite}: "
          f"{launches.get('dual_solve', 0)} dual_solve launches, expected "
          f"{want_dual}")
    if suite == "scenarios":
        summary = rows[-1].derived
        check(summary["claim_robust_ge_stale"]
              and summary["claim_regret_le_dual_bound"],
              f"scenarios: a claim failed on the card: {summary}")
    engine = ("merge", "point_read")
    if suite == "fig6":
        check(not any(launches.get(k, 0) for k in engine),
              f"fig6 ran the engine: {launches}")
    else:
        check(all(launches.get(k, 0) for k in engine),
              f"suite {suite}: the card's engine launched {launches}")
    return line


def phase_drift(torch, build) -> dict:
    """The online drift loop on the card: the online suite's flip scenario
    (w4, 250,000 keys, 10 segments of 1,000 queries, four arms) from the
    committed starts, with the launch counts set to 0 just before it; then
    the same plan on the CPU plain path from the card's tunings, every
    storm answered with the card's results.  Both must give the same
    segment records and the same ``LSMTree.retune`` calls.  Prints the
    storms (sizes, walls, launches), the re-tunes and each arm's
    throughput."""
    import repro_torch.api as api
    from repro_torch.bench import online
    from repro_torch.bench.common import committed_starts
    kind, widx, target = next(sc for sc in online.SCENARIOS
                              if sc[0] == DRIFT_SCENARIO)
    spec = online.make_spec(kind, widx, target)
    log(f"drift: {kind} on the card")
    build.reset_launches()
    t0 = time.time()
    with _storms(torch, build) as storms, _retune_calls() as calls:
        report = api.run_experiment(spec, device=DEVICE,
                                    starts=committed_starts)
    torch.cuda.synchronize()
    card_s = time.time() - t0
    launches = {k: v for k, v in build.LAUNCHES.items() if v}
    log("drift: the same plan on the CPU")
    t0 = time.time()
    cpu = drift_on_cpu(torch, build, report, storms)
    cpu_s = time.time() - t0
    check(cpu["records"] == _records(report.drift),
          "drift: segment records on the CPU != card")
    check(cpu["retune_calls"] == calls,
          "drift: LSMTree.retune calls on the CPU != card")
    check(all(launches.get(k, 0) for k in ("dual_solve", "merge",
                                           "point_read")),
          f"drift: the card's run launched {launches}")
    check(report.drift[(0, "online")].retunes >= 1,
          "drift: the online arm never re-tuned")
    return {"phase": "drift", "scenario": kind, "widx": widx,
            "n_keys": spec.drift.n_keys, "segments": spec.drift.segments,
            "seg_queries": spec.drift.n_queries, "identical": True,
            "card_s": card_s, "cpu_s": cpu_s, "walls": report.walls,
            "launches": launches, "storms": _storm_summary(storms),
            "retune_calls": len(calls),
            "arms": {arm: {"throughput": res.throughput,
                           "retunes": res.retunes,
                           "segment_io": [r.avg_io_per_query
                                          for r in res.records]}
                     for (_, arm), res in report.drift.items()}}


def phase_memory() -> dict:
    """The fleet memory arbiter on the card: the memory suite's skew_flip
    scenario (two tenants of 50,000 keys, 8 segments of 500 queries, the
    static and the arbitrated fleet) as the suites phase ran it from the
    committed starts, with the launch counts set to 0 just before it, and
    replayed it on the CPU plain path (same segment records, division
    events and ``LSMTree.retune`` calls).  Checks that this run launched
    every kernel of its path and that the arbiter re-divided; prints each
    storm (share, requests, lane batch, wall, launches), the divisions and
    each fleet's throughput."""
    check(MEMORY_SCENARIO in _MEMORY_RUN,
          "memory: the suites phase did not run the memory suite")
    run = _MEMORY_RUN[MEMORY_SCENARIO]
    report, launches = run["report"], run["launches"]
    check(all(launches.get(k, 0) for k in ("dual_solve", "merge",
                                           "point_read")),
          f"memory: the card's run launched {launches}")
    check(any(e["segment"] >= 0 for e in report.memory_events),
          "memory: the arbiter never re-divided")
    d = report.spec.drift
    return {"phase": "memory", "scenario": MEMORY_SCENARIO,
            "tenants": len(report.spec.workload.workloads),
            "n_keys": d.n_keys, "segments": d.segments,
            "seg_queries": d.n_queries, "identical": True,
            "card_s": run["card_s"], "cpu_s": run["cpu_s"],
            "walls": report.walls, "launches": launches,
            "storms": _storm_summary(run["storms"]),
            "retune_calls": len(run["calls"]),
            "events": report.memory_events,
            "fleets": {f"w{w}_{fleet}": {
                "throughput": res.throughput, "retunes": res.retunes,
                "segment_io": [r.avg_io_per_query for r in res.records]}
                for (w, fleet), res in report.memory.items()},
            "tp": {fleet: report.memory_fleet_throughput(fleet)
                   for fleet in ("static", "arbitrated")}}


def phase_robust_sharding(torch) -> dict:
    """Robust layout selection on the card and on the CPU:
    ``robust_layout_sweep`` over ``LAYOUT_CANDIDATES`` seeded synthetic
    candidates (a base cost per layout, one slow class whose penalty grows
    as the base falls) x ``GRID_RHOS``, one broadcast lane batch of
    ``robust_cost`` each.  The picks must be equal and the grids agree to
    rel 1e-5."""
    import numpy as np

    from repro_torch.core import robust_sharding as rs
    rng = np.random.default_rng(0)
    n = LAYOUT_CANDIDATES
    base = rng.uniform(0.5, 2.0, n)
    costs = base[:, None] * rng.uniform(0.8, 1.2, (n, 4))
    costs[np.arange(n), rng.integers(0, 4, n)] *= 1.0 + 40.0 / base ** 3
    mix = rng.dirichlet(np.ones(4) * 2.0)
    out = {}
    for dev in (DEVICE, "cpu"):
        cands = [rs.LayoutCandidate(f"c{i}", c) for i, c in enumerate(costs)]
        rs.worst_case_grid(cands, mix, GRID_RHOS, device=dev)     # warm
        t0 = time.time()
        grid = rs.worst_case_grid(cands, mix, GRID_RHOS, device=dev)
        grid_s = time.time() - t0
        picks = [c.name for c in rs.robust_layout_sweep(
            cands, mix, GRID_RHOS, device=dev)]
        out[dev] = {"grid": grid, "grid_s": grid_s, "picks": picks}
    card, cpu = out[DEVICE], out["cpu"]
    rel = float(np.max(np.abs(card["grid"] - cpu["grid"])
                       / np.abs(cpu["grid"])))
    check(card["picks"] == cpu["picks"], f"robust_sharding: picks on the "
          f"card {card['picks']} != CPU {cpu['picks']}")
    check(rel <= 1e-5, f"robust_sharding: grid rel err {rel:.3g} > 1e-5")
    nominal = rs.nominal_layout(
        [rs.LayoutCandidate(f"c{i}", c) for i, c in enumerate(costs)],
        mix).name
    return {"phase": "robust_sharding", "candidates": n,
            "rhos": list(GRID_RHOS), "nominal": nominal,
            "picks": card["picks"], "grid_max_rel_err": rel,
            "card_grid_s": card["grid_s"], "cpu_grid_s": cpu["grid_s"]}


def phase_faults(torch, build) -> dict:
    """The hardened subprocess backend with its workers on the card, over
    the faults suite's spec (4 trees of 30,000 keys, 1,500 queries, 2
    workers): the chaos schedule (a crash on shard 0, a corrupt result on
    shard 1) through the subprocess backend, 2 retries, no failed tree;
    the same shards run in this process on the card, their trial (the
    inline card trial) and the chaos trial each the CPU's inline trial in
    every ``IOStats``, I/O per query and ``TreeProbe``, and the workers'
    ``merge`` and ``point_read`` launches of the accepted attempts, which
    the parent adds to its own counts, equal to the in-process ones; a
    hung worker (shard 1) killed at ``HANG_TIMEOUT_S`` and retried,
    identical, each attempt's latency printed; and a resume: a first run
    whose shard-0 job file is torn, then ``resume`` loads only the valid
    job, re-runs the torn shard and gives the identical result.  (The
    suites phase's faults suite has already held the whole inline card
    trial against the chaos one: ``identical_to_inline``.)"""
    import dataclasses
    import shutil
    import tempfile

    import repro_torch.api as api
    from repro_torch.api import backends
    from repro_torch.bench import faults
    from repro_torch.bench.faults import trial_signature as _trial_of
    spec = faults.make_spec()
    out = {"phase": "faults", "trees": len(spec.workload.indices),
           "n_keys": spec.trial.n_keys, "n_queries": spec.trial.n_queries,
           "hang_timeout_s": HANG_TIMEOUT_S}

    def timed(what, fn):
        log(f"faults: {what}")
        t0 = time.time()
        result = fn()
        torch.cuda.synchronize()
        out[f"{what}_s"] = time.time() - t0
        return result

    cpu = timed("cpu_inline", lambda: api.run_experiment(spec,
                                                         device="cpu"))
    want = _trial_of(cpu)
    build.reset_launches()
    chaos = timed("chaos", lambda: api.run_experiment(
        faults.chaos_spec(spec), device=DEVICE))
    workers = {k: build.LAUNCHES[k] for k in ("merge", "point_read",
                                               "dual_solve")}
    out.update(chaos_walls=chaos.walls, chaos_attempts=chaos.shard_attempts,
               worker_launches=workers)
    check(_trial_of(chaos) == want, "faults: the chaos trial on the card "
          "differs from the CPU's inline trial")
    check(chaos.walls["shard_retries"] == 2
          and chaos.walls["failed_trees"] == 0, f"faults: chaos walls "
          f"{chaos.walls}")
    check(workers["merge"] > 0 and workers["point_read"] > 0
          and workers["dual_solve"] == 0, f"faults: the workers launched "
          f"{workers}")

    cx = api.compile_spec(spec)
    inline = cx.select_arms({})
    plan = cx.build_trial(inline)
    shards = backends.SubprocessBackend(workers=2)._partition(plan)
    build.reset_launches()

    def in_process():
        for shard in shards:
            builds = [plan.trees[t] for t in shard]
            results, probes, _, _ = api.execute_trial(plan, builds,
                                                      device=DEVICE)
            backends._attach_trial(inline, builds, results, probes)

    timed("shards_in_process", in_process)
    own = {k: build.LAUNCHES[k] for k in workers}
    out["in_process_launches"] = own
    check(_trial_of(inline) == want, "faults: the inline card trial "
          "differs from the CPU's")
    check(own == workers, f"faults: the workers' launches {workers} != the "
          f"same shards in this process {own}")

    def sub(**params):
        base = dict(workers=2, max_retries=2, backoff_s=0.05,
                    timeout_s=HANG_TIMEOUT_S)
        base.update(params)
        return tuple(base.items())

    hang = timed("hang", lambda: api.run_experiment(dataclasses.replace(
        spec, backend="subprocess", backend_params=sub(),
        faults=(api.FaultSpec(kind="hang", shards=(1,), max_hits=1),)),
        device=DEVICE))
    out.update(hang_walls=hang.walls, hang_attempts=hang.shard_attempts)
    log(f"faults: hang attempts {hang.shard_attempts}")
    check(_trial_of(hang) == want and hang.walls["shard_retries"] == 1
          and hang.walls["failed_trees"] == 0, f"faults: the hung worker's "
          f"run: walls {hang.walls}")
    check([(a["shard"], a["attempt"]) for a in hang.shard_attempts
           if not a["ok"]] == [(1, 0)], f"faults: attempts "
          f"{hang.shard_attempts}")

    run_dir = tempfile.mkdtemp(prefix="chip_smoke_faults_")
    try:
        # shard 0's job file: its name ends with a tag of the shard's trees
        tag = backends._job_tag(shards[0])
        torn = timed("torn", lambda: api.run_experiment(dataclasses.replace(
            spec, backend="subprocess", backend_params=sub(run_dir=run_dir),
            faults=(api.FaultSpec(kind="torn_write", match=tag),)),
            device=DEVICE))
        resumed = timed("resume", lambda: api.run_experiment(
            dataclasses.replace(spec, backend="subprocess",
                                backend_params=sub(run_dir=run_dir,
                                                   resume=True)),
            device=DEVICE))
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    out.update(torn_walls=torn.walls, resume_walls=resumed.walls,
               resume_attempts=resumed.shard_attempts)
    check(torn.walls.get("persist_failures") == 1
          and _trial_of(torn) == want, f"faults: the torn run's walls "
          f"{torn.walls}")
    check(resumed.walls["resumed_trees"] == len(shards[1])
          and resumed.walls["shards_run"] == 1
          and _trial_of(resumed) == want, f"faults: the resumed run's walls "
          f"{resumed.walls}")
    out["identical"] = True
    return out


def phase_obs(build, suite_lines) -> dict:
    """Trace export and calibration on the card: the obs suite's traced leg
    (its four-policy fleet) captured with ``write_trace``: the document
    parses, holds one thread lane per tree label, 16 ``session.execute``
    spans and the ``kernel.dispatch.merge.cuda`` and
    ``kernel.dispatch.point_read.cuda`` counters; the calibration artifact
    written by ``write_calibration`` validates its checksum and reads
    ``all_fitted_ge_hand`` true.  The leg must launch ``merge`` and
    ``point_read`` and no ``dual_solve``.  Prints the faults and obs
    suites' ``overhead_ratio`` from the suites phase, as times."""
    import tempfile

    from repro_torch.bench import obs as obs_suite
    from repro_torch.faults import load_checked_json
    from repro_torch.obs.calibrate import write_calibration
    from repro_torch.obs.trace import write_trace
    log("obs: a traced leg on the card")
    build.reset_launches()
    t0 = time.time()
    report, engine_s, tel = obs_suite.run_leg(True, DEVICE)
    leg_s = time.time() - t0
    launches = {k: v for k, v in build.LAUNCHES.items() if v}
    check(launches.get("merge", 0) > 0 and launches.get("point_read", 0) > 0
          and not launches.get("dual_solve"), f"obs: the traced leg "
          f"launched {launches}")
    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / "trace_obs.json")
        n = write_trace(path, tel)
        doc = load_checked_json(path)
        cal = obs_suite.calibration(tel.events_snapshot(), report, DEVICE)
        cal_path = str(Path(d) / "calibration_obs.json")
        write_calibration(cal_path, cal)
        cal_doc = load_checked_json(cal_path)
    tev = doc["traceEvents"]
    lanes = {e["args"]["name"] for e in tev
             if e["ph"] == "M" and e["name"] == "thread_name"}
    labels = {f"w0.rhoNone/{p}" for p in obs_suite.POLICIES}
    spans = sum(e["ph"] == "X" and e["name"] == "session.execute"
                for e in tev)
    counters = {e["name"]: e["args"]["value"] for e in tev if e["ph"] == "C"}
    check(labels <= lanes, f"obs: lanes {sorted(lanes)}")
    check(spans == 16, f"obs: {spans} session.execute spans")
    check(all(counters.get(f"kernel.dispatch.{k}.cuda", 0) > 0
              for k in ("merge", "point_read")), f"obs: counters "
          f"{sorted(counters)}")
    check(cal_doc["all_fitted_ge_hand"] is True, "obs: calibration "
          f"{cal_doc}")
    overhead = {line["suite"]: {r: d["overhead_ratio"]
                                for r, d in line["rows"].items()
                                if "overhead_ratio" in d}
                for line in suite_lines if line["suite"] in ("faults", "obs")}
    return {"phase": "obs", "leg_s": leg_s, "engine_s": engine_s,
            "events": n, "lanes": sorted(lanes), "session_spans": spans,
            "dispatch_counters": {k: v for k, v in counters.items()
                                  if k.startswith("kernel.dispatch.")},
            "launches": launches, "calibration": cal_doc["policies"],
            "overhead_ratio": overhead}


def suites_main(torch) -> int:
    """``--suites``: the suites phase over ``ALL_SUITES`` and
    ``CPU_HELD_SUITES`` on the ``repro_torch`` under ``--src``: one JSON
    line per suite, then the card's name and power limit."""
    import repro_torch.core as core
    from repro_torch.kernels import _build as build
    log(f"suites only, {Path(core.__file__).parents[1]}")
    build.build(["dual_solve", "merge", "point_read"])
    phase_suites(torch, core, build, ALL_SUITES)
    for suite in CPU_HELD_SUITES:
        emit(suite_against_cpu(torch, build, suite))
    print(gpu_line(), flush=True)
    return 0


def phase_bench_kernels(build) -> None:
    """The ``kernels`` and ``roofline`` suites through
    ``repro_torch.bench.run.run_suite`` on the card, the launch counts set
    to 0 before each: every held field of the committed file matched
    (``BENCH_HELD``), each data-plane kernel launched, three roofline
    cells measured; one JSON line per suite, the copy bandwidth on the
    roofline's."""
    from repro_torch.bench import run
    for suite in ("kernels", "roofline"):
        log(f"bench: {suite}")
        build.reset_launches()
        res = run.run_suite(suite, device=DEVICE, baseline_dir=ROOT)
        launches = {k: v for k, v in build.LAUNCHES.items() if v}
        cmp = res["comparison"]
        rows = {r.name: r.derived for r in res["rows"]}
        line = {"phase": "bench_kernels", "suite": suite,
                "wall_s": res["wall_s"], "rows": rows,
                "held_matched": len(cmp["held"]),
                "held_missed": [list(m) for m in cmp["missed"]],
                "launches": launches}
        if suite == "roofline":
            line["copy_peak_gbps"] = rows["roofline_kernels"]["copy_peak_gbps"]
        emit(line)
        check(not cmp["missed"], f"suite {suite}: held fields missed "
              f"{cmp['missed']}")
        check(len(cmp["held"]) == BENCH_HELD[suite], f"suite {suite}: "
              f"{len(cmp['held'])} held fields, expected {BENCH_HELD[suite]}")
        check(all(launches.get(k, 0) for k in BENCH_KERNELS),
              f"suite {suite}: launched {launches}")
    check(rows["roofline_kernels"]["measured_cells"] == 3,
          f"roofline: {rows['roofline_kernels']['measured_cells']} cells")


def dryrun_worker(src: str, arch: str, shape: str, mesh: str, tag: str,
                  overrides: dict, out_dir: str) -> dict:
    """One dry-run cell, in a worker process: fake tensors over a fake
    process group, on the CPU.  Returns its record and wall time."""
    sys.path.insert(0, src)
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch import dryrun
    t0 = time.time()
    rec = dryrun.run_cell(arch, shape, mesh, overrides=overrides or None,
                          tag=tag, verbose=False, out_dir=out_dir)
    rec["wall_s"] = time.time() - t0
    return rec


def start_dryrun(src: Path):
    """Start ``DRYRUN_CELLS`` in ``DRYRUN_WORKERS`` worker processes into
    a temporary records directory; the workers and the directory go at
    exit.  Returns (the pool, [(cell, its async result)], the
    directory)."""
    import atexit
    import multiprocessing
    import shutil
    import tempfile
    records = tempfile.mkdtemp(prefix="dryrun_records_")
    pool = multiprocessing.get_context("spawn").Pool(DRYRUN_WORKERS)
    atexit.register(shutil.rmtree, records, True)
    atexit.register(pool.terminate)
    cells = [(cell, pool.apply_async(dryrun_worker,
                                     (str(src), *cell, records)))
             for cell in DRYRUN_CELLS]
    log(f"dryrun: {len(cells)} cells started in {DRYRUN_WORKERS} workers")
    return pool, cells, records


def phase_dryrun(pool, cells, records: str) -> None:
    """Wait for the dry-run cells, print each one's status, costs and
    roofline terms and the roofline suite's mesh rows over their records;
    every cell must be ``ok``."""
    from repro_torch.bench import roofline
    log("dryrun: waiting for the cells")
    t0 = time.time()
    out = []
    for (arch, shape, mesh, tag, over), res in cells:
        rec = res.get(timeout=max(1.0, DRYRUN_WAIT_S - (time.time() - t0)))
        trace = rec.get("trace", {})
        terms = rec.get("roofline", {})
        out.append({
            "arch": arch, "shape": shape, "mesh": mesh, "tag": tag,
            "overrides": over, "status": rec["status"],
            "error": rec.get("error", "")[:400], "wall_s": rec["wall_s"],
            "chips": rec.get("chips"),
            "flops_per_dev": trace.get("flops_per_dev"),
            "bytes_per_dev": trace.get("bytes_per_dev"),
            "collective_bytes_by_axis":
                trace.get("collective_bytes_by_axis"),
            "collective_count": trace.get("collective_count"),
            "memory_per_dev_gb":
                rec.get("memory_analysis", {}).get("total_live_gb"),
            **{k: terms.get(k) for k in (
                "compute_s", "memory_s", "collective_s",
                "collective_by_axis", "bottleneck", "step_time_s",
                "useful_ratio", "model_flops_total")}})
    waited = time.time() - t0
    pool.close()
    pool.join()
    emit({"phase": "dryrun", "waited_s": waited, "cells": out,
          "mesh_rows": {m: roofline.mesh_row(records, m).derived
                        for m in ("single", "multipod")}})
    bad = [(c["arch"], c["shape"], c["mesh"], c["tag"], c["status"],
            c["error"]) for c in out if c["status"] != "ok"]
    check(not bad, f"dryrun: cells not ok: {bad}")
    # the traced FLOPs against the analytic 6ND / 2ND count: a counter
    # that took the sharding propagation's global-shape calls for a
    # device's would read hundreds of times too many
    off = [(c["arch"], c["shape"], c["mesh"], c["tag"], c["useful_ratio"])
           for c in out if not 0.1 <= c["useful_ratio"] <= 1.5]
    check(not off, f"dryrun: analytic over traced FLOPs outside [0.1, "
          f"1.5]: {off}")


def phase_robust_sharding_records(build, records: str) -> None:
    """The ``robust_sharding`` suite over the dry-run records on the card:
    the ``rwkv6-3b`` row picks between its two layouts."""
    from repro_torch.bench import robust_sharding
    build.reset_launches()
    t0 = time.time()
    rows = {r.name: r.derived
            for r in robust_sharding.run(device=DEVICE, records=records)}
    emit({"phase": "robust_sharding_records", "wall_s": time.time() - t0,
          "rows": rows,
          "launches": {k: v for k, v in build.LAUNCHES.items() if v}})
    row = rows["robust_sharding_rwkv6-3b"]
    check("skipped" not in row and row["candidates"] == 2,
          f"robust_sharding: the rwkv6-3b row was not computed: {row}")


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
        # a kernel that serves two archs: the launches of both prefills
        for name, n in ((kernel, served["kernel_launches"]),
                        (f"{kernel}:f32_cuda_core",
                         served["f32_check"]["f32_kernel_launches"])):
            launches[name] = launches.get(name, 0) + n
    arch_of = {}                # a kernel's row takes its first arch's shape
    for arch, kernel in SERVE:
        arch_of.setdefault(kernel, arch)
    plane, bloom_q, bloom_in, bloom = phase_bloom(torch, np, bloom_ops,
                                                  bloom_ref, build)
    emit(bloom)
    launches["bloom_probe"] = bloom["launches"]

    dev = DEVICE
    log("kernels")
    kernels = [
        kernel_dual_solve(torch, np, core, dual_ops, dual_ref, dev),
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
          "lead_kernels_lost_max": LEAD_LOST["max"], "kernels": kernels})
    phase_bench_kernels(build)
    # the dry-run cells trace on the CPU from here to the obs phase
    pool, cells, records = start_dryrun(src)
    suite_lines = phase_suites(torch, core, build)
    for suite in CPU_HELD_SUITES:
        emit(suite_against_cpu(torch, build, suite))
    emit(phase_api(torch, build))
    emit(phase_robust_serving(torch, build))
    emit(phase_drift(torch, build))
    emit(phase_memory())
    emit(phase_robust_sharding(torch))
    emit(phase_faults(torch, build))
    emit(phase_obs(build, suite_lines))
    phase_dryrun(pool, cells, records)
    phase_robust_sharding_records(build, records)
    # last, so that its tens of thousands of launches precede no timed
    # trace of the phases above
    emit(phase_train(torch, build, models))
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
