// Threefry-2x32 counter-based random bits for Hopper (sm_90a): one launch
// per draw, hashing each element's 64-bit flat index under its key.
//
// Replaces no Pallas kernel: the JAX package's draws run inside its XLA
// programs (jax.random with jax_threefry_partitionable on, jax's default),
// as jax/_src/prng.py::_threefry_random_bits_partitionable lowers them.
// Its plain version is magicsoup_tpu_torch/ops/prng.py::threefry2x32 and
// the eager ops around it, which take about 150 int64 passes per draw.
//
// Mapping.  One thread per element, 256 threads a CTA, grid
// (ceil(n / 256), keys): blockIdx.y is the key, blockIdx.x * 256 +
// threadIdx.x the element's counter within it.  The counter's high word is
// 0 (n < 2**32), the low word the index, as jax's iota_2x32_shape gives
// them.  The key words arrive as int64 holding uint32 values (the plain
// version's layout), are read once per thread and live in registers with
// the 20 rounds; every output word is written once, as int64, neighbouring
// threads on neighbouring addresses.
//
// Outputs.  mode 0: out[k, i] = bits1 ^ bits2, the partitionable
// random_bits at 32 bits; mode 1: out[k, i, 0..1] = (bits1, bits2), a key
// per counter as jax.random.split builds them.
//
// What bounds it.  Writing: 8 bytes per element (16 in mode 1) against
// about 110 integer operations per element (20 rounds of add, rotate, xor
// and the key injections).  At (16384, 1024) that is 134 MB, 0.040 ms at
// 3.35 TB/s, and 1.8 G integer operations; the card's integer rate on the
// CUDA cores is of the order of its f32 rate, so neither bound is far from
// the other, and a simple kernel that keeps everything in registers is the
// design: no shared memory, no reuse to stage.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr uint32_t PARITY = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Four rounds with the given rotations, then the key injection of
// injection number `inj` (1-5) from keys ka, kb.
__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1, int r0,
                                       int r1, int r2, int r3, uint32_t ka,
                                       uint32_t kb, uint32_t inj) {
  x0 += x1; x1 = rotl(x1, r0) ^ x0;
  x0 += x1; x1 = rotl(x1, r1) ^ x0;
  x0 += x1; x1 = rotl(x1, r2) ^ x0;
  x0 += x1; x1 = rotl(x1, r3) ^ x0;
  x0 += ka;
  x1 += kb + inj;
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ PARITY;
  x0 += k0;
  x1 += k1;
  rounds(x0, x1, 13, 15, 26, 6, k1, k2, 1u);
  rounds(x0, x1, 17, 29, 16, 24, k2, k0, 2u);
  rounds(x0, x1, 13, 15, 26, 6, k0, k1, 3u);
  rounds(x0, x1, 17, 29, 16, 24, k1, k2, 4u);
  rounds(x0, x1, 13, 15, 26, 6, k2, k0, 5u);
}

__global__ void __launch_bounds__(THREADS)
    threefry_kernel(const int64_t* keys, long long n, int64_t* out, int mode) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const long long k = blockIdx.y;
  const uint32_t k0 = (uint32_t)keys[2 * k];
  const uint32_t k1 = (uint32_t)keys[2 * k + 1];
  uint32_t x0 = 0u;
  uint32_t x1 = (uint32_t)i;
  threefry2x32(k0, k1, x0, x1);
  const long long at = k * n + i;
  if (mode == 0) {
    out[at] = (int64_t)(x0 ^ x1);
  } else {
    out[2 * at] = (int64_t)x0;
    out[2 * at + 1] = (int64_t)x1;
  }
}

}  // namespace

extern "C" {

int ms_threefry_threads() { return THREADS; }

// keys (n_keys, 2) int64 holding uint32 words; out (n_keys, n) int64 in
// mode 0, (n_keys, n, 2) in mode 1.  n < 2**32, n_keys <= 65535.
// Launches on `stream` without synchronizing; returns cudaGetLastError().
int ms_threefry(const int64_t* keys, int n_keys, long long n, int64_t* out,
                int mode, void* stream) {
  if (mode != 0 && mode != 1) return (int)cudaErrorInvalidValue;
  if (n_keys < 0 || n_keys > 65535 || n < 0 || n >= (1ll << 32))
    return (int)cudaErrorInvalidValue;
  if (n == 0 || n_keys == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((n + THREADS - 1) / THREADS), (unsigned)n_keys);
  threefry_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(keys, n, out,
                                                              mode);
  return (int)cudaGetLastError();
}

const char* ms_threefry_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
