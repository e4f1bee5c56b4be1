// Blocked-Bloom membership probe, one thread per key.
//
// Replaces: src/repro/kernels/bloom_probe/kernel.py:63 bloom_probe_kernel
// (the Pallas tile body _probe_kernel at :39, the hash _mix32 at :31).
//
// The filter is an f32 0/1 bit-plane (num_blocks, block_bits).  Per key:
//   block = mix32(key, 1) % num_blocks
//   bit_j = mix32(key, j + 2) % block_bits,       j = 0..k-1
//   out   = 1 * plane[block][bit_0] * ... * plane[block][bit_{k-1}]
// in uint32 arithmetic (mix32 wraps mod 2^32) and that product order, as
// the Pallas kernel and the plain version (kernels/bloom_probe/ref.py) do.
//
// Translation: the Pallas kernel keeps the whole plane in VMEM and fetches
// a key's row as a one-hot matmul on the MXU, because the TPU has no
// scalar gather.  Here the plane stays in HBM and each thread gathers its
// k floats directly, at a 64-bit index (block * block_bits + bit), so a
// plane of 2^31 floats or more is read right.  Keys are the port's int64
// form; the thread hashes their low 32 bits.  Any N: the last block masks
// the ragged edge, with no padding to 128.
//
// All k values are read, with no stop at the first zero bit: the k loads
// do not depend on each other, so a thread has them in flight at once,
// and the product is the plain version's for any plane, not only a 0/1
// one.  (Stopping at the first zero would give the same result on a 0/1
// plane and read fewer floats for keys that are absent, but would make
// the loads wait on each other.)
//
// What bounds it on the H100: memory latency and sector traffic.  A key
// moves 4 bytes of key (8 as the port's int64), 4 bytes of result and
// k * 4 bytes of plane, but every probe lands in its own 32-byte sector of
// a plane that, at the 10 M-key deployment size (400 MB), is 8x the 50 MB
// L2: the card moves k * 32 bytes of plane per key, about 6.5x the bytes
// bound at k = 7 (236 bytes of traffic per key against 36).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t mix32(uint32_t x, uint32_t seed) {
  x += seed * 0x9E3779B9u;
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  return x ^ (x >> 16);
}

__global__ void bloom_probe_kernel(const long long* __restrict__ keys,
                                   long long n,
                                   const float* __restrict__ plane,
                                   uint32_t num_blocks, uint32_t block_bits,
                                   int k, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t key = (uint32_t)keys[i];
  const float* row =
      plane + (uint64_t)(mix32(key, 1u) % num_blocks) * block_bits;
  float member = 1.0f;
#pragma unroll 8
  for (int j = 0; j < k; ++j) {
    member *= __ldg(row + mix32(key, (uint32_t)(j + 2)) % block_bits);
  }
  out[i] = member;
}

}  // namespace

// num_blocks and block_bits lie in [1, 2^32): the wrapper checks.
extern "C" int bloom_probe_launch(const long long* keys, long long n,
                                  const float* plane, long long num_blocks,
                                  long long block_bits, int k, float* out,
                                  cudaStream_t stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  bloom_probe_kernel<<<blocks, threads, 0, stream>>>(
      keys, n, plane, (uint32_t)num_blocks, (uint32_t)block_bits, k, out);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
