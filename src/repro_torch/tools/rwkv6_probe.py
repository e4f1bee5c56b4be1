"""Where the bf16 ``rwkv6`` kernel's time goes, on the card.

    PYTHONPATH=src python -m repro_torch.tools.rwkv6_probe

Prints two JSON lines, then the card's name and power limit:

* ``mma_sync``: the cycles a warp spends per ``mma.sync.m16n8k16`` (bf16
  operands, float32 accumulators) when it issues ``chains`` independent
  chains of dependent products, with 1, 2 or 4 warps on each of an SM's
  four schedulers.  One chain gives the latency of a product that waits
  for the one before it; many chains and warps give the throughput.
* ``regions``: ``csrc/rwkv6_mma.cu`` compiled from a copy with a
  ``clock64()`` counter around each stretch of its chunk loop between
  barriers (the source itself is untouched), launched on one (batch,
  head) alone and at the ``rwkv6-3b`` prefill's shape (B 4, S 2048, H 40,
  n 64, the model's decay): the cycles per chunk that each warp of the
  first and of the last block spends in each stretch (a barrier's wait
  counts in the stretch after it), and the CUDA-event time per launch.
  The counters cost some time of their own.

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

MMA_BENCH = r"""
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>
template <int CHAINS>
__global__ void bench(float* out, long long* cyc, int iters) {
  float acc[CHAINS][4] = {};
  const uint32_t a0 = threadIdx.x, a1 = 2u, a2 = 3u, a3 = 4u, b0 = 5u,
                 b1 = 6u;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]),
            "+f"(acc[c][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  const long long t1 = clock64();
  float s = 0.f;
  for (int c = 0; c < CHAINS; ++c)
    s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[threadIdx.x] = s;
  if (threadIdx.x % 32 == 0) cyc[threadIdx.x / 32] = t1 - t0;
}
template <int CHAINS>
void run(float* out, long long* cyc, int warps) {
  const int iters = 2000;
  long long h[16];
  bench<CHAINS><<<1, 32 * warps>>>(out, cyc, iters);
  bench<CHAINS><<<1, 32 * warps>>>(out, cyc, iters);
  cudaMemcpy(h, cyc, sizeof(long long) * warps, cudaMemcpyDeviceToHost);
  double mean = 0;
  for (int w = 0; w < warps; ++w) mean += h[w];
  mean /= warps;
  printf("%d %d %.3f\n", CHAINS, warps, mean / ((double)iters * CHAINS));
}
int main() {
  float* out;
  long long* cyc;
  cudaMalloc(&out, 4096);
  cudaMalloc(&cyc, 4096);
  for (int warps : {4, 8, 16}) {
    run<1>(out, cyc, warps);
    run<4>(out, cyc, warps);
    run<8>(out, cyc, warps);
  }
  return cudaDeviceSynchronize() != cudaSuccess;
}
"""


def _nvcc(args) -> None:
    out = subprocess.run([_build.nvcc_path(), *args], capture_output=True,
                         text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed:\n{out.stdout}{out.stderr}")


def mma_sync() -> dict:
    src, exe = PROBE_DIR / "mma_bench.cu", PROBE_DIR / "mma_bench"
    src.write_text(MMA_BENCH)
    _nvcc(["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-o",
           str(exe), str(src)])
    rows = []
    for line in subprocess.run([str(exe)], capture_output=True, text=True,
                               check=True).stdout.split("\n"):
        if line.strip():
            chains, warps, cycles = line.split()
            rows.append({"chains": int(chains),
                         "warps_per_scheduler": int(warps) // 4,
                         "cycles_per_mma_per_warp": float(cycles)})
    return {"probe": "mma_sync", "m16n8k16_bf16_f32": rows}


def instrument(src: str) -> tuple:
    """``src`` with a clock64() counter around each stretch of the chunk
    loop between ``__syncthreads()``, per warp, for the first and the last
    block, read by ``rwkv6_probe_read``.  Returns (source, stretches)."""
    tick = ("{ const long long t_ = clock64(); prof[%d] += t_ - tick; "
            "tick = t_; }")
    marker = "namespace {\n\nconstexpr int C = 32;"
    assert src.count(marker) == 1, "kernel constants"
    src = src.replace(marker, "__device__ unsigned long long g_probe"
                      "[2][8][8];\n" + marker)
    head = "  for (int c = 0; c < nchunks; ++c) {\n"
    i = src.index(head) + len(head)
    depth, j = 1, i
    while depth:
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        j += 1
    parts = src[i:j - 1].split("    __syncthreads();")
    body = ""
    for q, part in enumerate(parts[:-1]):
        body += (part + "    " + tick % q + "\n    __syncthreads();\n")
    body += parts[-1] + "    " + tick % (len(parts) - 1) + "\n  "
    n = len(parts)
    setup = ("  const int probe = blockIdx.x == 0 ? 0 : blockIdx.x == "
             "gridDim.x - 1 ? 1 : -1;\n  unsigned long long prof[8] = {};\n"
             "  long long tick = clock64();\n")
    save = ("\n  if (probe >= 0 && (threadIdx.x & 31) == 0)\n"
            "    for (int q = 0; q < %d; ++q)\n"
            "      g_probe[probe][threadIdx.x / 32][q] = prof[q];" % n)
    src = src[:src.index(head)] + setup + head + body + "}" + save + src[j:]
    src += ('\nextern "C" int rwkv6_probe_read(unsigned long long* out) {\n'
            '  return (int)cudaMemcpyFromSymbol(out, g_probe, '
            'sizeof(g_probe));\n}\n')
    return src, n


def regions() -> dict:
    import torch

    from ..kernels.rwkv6.ops import _LAUNCH_ARGS
    src, n = instrument((_build.CSRC_DIR / "rwkv6_mma.cu").read_text())
    cu, so = PROBE_DIR / "rwkv6_probe.cu", PROBE_DIR / "librwkv6_probe.so"
    cu.write_text(src)
    _nvcc([*_build.NVCC_FLAGS, "-o", str(so), str(cu)])
    lib = ctypes.CDLL(str(so))
    fn = lib.rwkv6_mma_launch
    fn.argtypes, fn.restype = list(_LAUNCH_ARGS), ctypes.c_int
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"probe": "regions", "source": "src/repro_torch/csrc/rwkv6_mma.cu",
           "stretches_between_barriers": n, "runs": []}
    for B, S, H, N in ((1, 2048, 1, 64), (4, 2048, 40, 64)):
        r, k, v = (torch.randn((B, S, H, N), generator=g,
                               device="cuda").bfloat16() for _ in range(3))
        logw = -torch.exp(torch.randn((B, S, H, N), generator=g,
                                      device="cuda") * 0.5 - 0.6)
        u = torch.randn((H, N), generator=g, device="cuda") * 0.1
        y = torch.empty((B, S, H, N), device="cuda")
        state = torch.empty((B, H, N, N), device="cuda")
        args = [t.data_ptr() for t in (r, k, v, logw, u, y, state)]
        args += [s for t in (r, k, v, logw) for s in t.stride()[:3]]
        args += [B, S, H, N]

        def launch():
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"rwkv6 probe launch failed ({rc})")

        for _ in range(2):
            launch()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            launch()
        end.record()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (2 * 8 * 8))()
        if lib.rwkv6_probe_read(buf):
            raise RuntimeError("rwkv6 probe: reading the counters failed")
        chunks = -(-S // 32)
        blocks = {}
        for slot, name in ((0, "first"), (1, "last")):
            if slot == 1 and B * H == 1:
                continue
            blocks[name] = [[buf[(slot * 8 + w) * 8 + q] / chunks
                             for q in range(n)] for w in range(4)]
        out["runs"].append({"B_S_H_n": [B, S, H, N],
                            "ms": start.elapsed_time(end) / 5,
                            "cycles_per_chunk": blocks})
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("rwkv6_probe: CUDA is not available", file=sys.stderr)
        return 3
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    print(json.dumps(mma_sync()), flush=True)
    print(json.dumps(regions()), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
