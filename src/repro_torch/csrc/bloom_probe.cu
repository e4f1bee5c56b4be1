// Blocked-Bloom membership probe: each key stops at its first zero bit.
//
// Replaces: src/repro/kernels/bloom_probe/kernel.py:63 bloom_probe_kernel
// (the Pallas tile body _probe_kernel at :39, the hash _mix32 at :31).
//
// The filter is an f32 0/1 bit-plane (num_blocks, block_bits).  Per key:
//   block = mix32(key, 1) % num_blocks
//   bit_j = mix32(key, j + 2) % block_bits,       j = 0..k-1
//   out   = 1 * plane[block][bit_0] * ... * plane[block][bit_{k-1}]
// in uint32 arithmetic (mix32 wraps mod 2^32), as the Pallas kernel and the
// plain version (kernels/bloom_probe/ref.py) do.
//
// Translation: the Pallas kernel keeps the whole plane in VMEM and fetches
// a key's row as a one-hot matmul on the MXU, because the TPU has no
// scalar gather.  Here the plane stays in HBM and each thread gathers the
// floats it needs directly, at a 64-bit index (block * block_bits + bit),
// so a plane of 2^31 floats or more is read right.  Keys are the port's
// int64 form; the thread hashes their low 32 bits.  Any N: the last block
// masks the ragged edge.
//
// What bounds it on the H100: sector traffic and memory latency.  A key
// moves 4 bytes of key (8 as the port's int64), 4 bytes of result and up to
// k * 4 bytes of plane, but every plane load lands in its own 32-byte
// sector of a plane that, at the 10 M-key deployment size (400 MB), is 8x
// the 50 MB L2.
//
// The design cuts the sectors.  A key stops at its first zero bit: on the
// contract's 0/1 plane (what build_plane makes, and what the JAX kernel's
// docstring asks for), a key whose j-th float is 0 has the product +0.0
// whatever comes after, so the result is the plain version's bit for bit.
// (On a plane of other values it would not be: the product would skip the
// factors after a zero.)  At the deployment's fill of ~0.5 an absent key
// reads ~2 floats, not k = 7.  Stopping makes a key's loads wait on each
// other; one key a thread, one float at a time, is what the H100 ran
// fastest, since a 1 M-key batch holds enough threads to overlap the
// waits.  Several keys a thread, wider rounds of loads and an evict-first
// L2 policy on the plane each measured slower (tools/bloom_designs.py
// builds and times them; PERF.md).  Keys go through the read-only path
// and results are streaming stores.  With `loads`, each key's count of
// plane floats read is written too, so that a run can show the kernel
// stopped where ref.probe_loads_ref says it should.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t mix32(uint32_t x, uint32_t seed) {
  x += seed * 0x9E3779B9u;
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  return x ^ (x >> 16);
}

__global__ void __launch_bounds__(kThreads) bloom_probe_kernel(
    const long long* __restrict__ keys, long long n,
    const float* __restrict__ plane, uint32_t num_blocks,
    uint32_t block_bits, int k, float* __restrict__ out,
    int* __restrict__ loads) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t key = (uint32_t)__ldg(keys + i);
  const float* row =
      plane + (uint64_t)(mix32(key, 1u) % num_blocks) * block_bits;
  float m = 1.0f;
  int j = 0;
  for (; j < k && m != 0.0f; ++j)
    m *= __ldg(row + mix32(key, (uint32_t)(j + 2)) % block_bits);
  __stcs(out + i, m);
  if (loads != nullptr) loads[i] = j;
}

}  // namespace

// num_blocks and block_bits lie in [1, 2^32): the wrapper checks.  loads
// may be null.
extern "C" int bloom_probe_launch(const long long* keys, long long n,
                                  const float* plane, long long num_blocks,
                                  long long block_bits, int k, float* out,
                                  int* loads, cudaStream_t stream) {
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  bloom_probe_kernel<<<blocks, kThreads, 0, stream>>>(
      keys, n, plane, (uint32_t)num_blocks, (uint32_t)block_bits, k, out,
      loads);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
