// The integrator's lowering ladder as CUDA kernels for Hopper (sm_90a):
// each rung one sub-expression of the integrator's body as its own kernel.
//
// Replaces the TPU kernel performance/pallas_bisect.py::main, whose
// `call()` wraps pl.pallas_call around each rung body: rungs 1-8 are
// sub-expressions of the body (copy, i16 load and sum, exp/log, the
// log-space reduce, _prod_pow, float pow, the unrolled product, the
// product reduction); rungs 9-11 are the velocity body, one trim pass and
// three trim passes.  On the TPU the ladder isolated what Mosaic could not
// lower; here every rung builds, and the ladder's use is to check each
// piece against its plain PyTorch version
// (magicsoup_tpu_torch/ops/cuda_bisect.py) and to time it against its own
// byte bound.
//
// Skeletons.  Two, so that a difference in time between two rungs of one
// skeleton belongs to the sub-expression, not to the mapping:
//   - rungs 1-8 run the integrator kernel's first skeleton, kept as the
//     record of what each sub-expression cost on it: a CTA of 8 warps, one
//     cell per warp, lanes over the signals, X staged into shared memory,
//     and each sum over signals of rungs 4-6 and 8 a warp butterfly
//     (warp_sum below, one 5-step shuffle chain per protein);
//   - rungs 9-11 run the integrator kernel's own skeleton and device
//     functions (integrate_body.cuh: the tile's parameters staged into
//     shared memory by the launch plan's mask, lanes over proteins for the
//     sums over signals, lanes over signals for the sums over proteins) --
//     the production code, not a copy -- so rung 11 is the integrator
//     kernel's body and its output is bit-equal to it.
//
// What bounds it.  Rungs 1-8 read X and at most one i16 (c, p, s) tensor
// and write (c, s) or (c, p) floats: at the workload's shapes a few MB, a
// few microseconds at 3.35 TB/s, so their time is mostly launch latency.
// Rung 9 reads every parameter tensor but Ke (only the equilibrium
// correction reads it); rungs 10-11 read all nine, as the integrator does.
#include "integrate_body.cuh"

using namespace msbody;

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = WARP / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The first skeleton's shared memory: per warp x0 and lx among the
// first integrator kernel's 4 signal and 4 protein vectors (its size, so
// the occupancy of rungs 1-8 is that kernel's).
__host__ __device__ constexpr size_t first_smem_bytes(int p, int s) {
  return (size_t)TILE_C * (4 * (size_t)s + 4 * (size_t)p) * sizeof(float);
}

size_t rung_smem_bytes(int rung, int p, int s, int mask) {
  return rung <= 8 ? first_smem_bytes(p, s) : tile_layout(p, s, mask).bytes;
}

template <int R, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 2)
rung_kernel(const float* __restrict__ X, const float* __restrict__ Ke,
            const float* __restrict__ Kmf, const float* __restrict__ Kmb,
            const float* __restrict__ Kmr, const float* __restrict__ Vmax,
            const int16_t* __restrict__ N, const int16_t* __restrict__ Nf,
            const int16_t* __restrict__ Nb, const int16_t* __restrict__ A,
            float* __restrict__ out, int p, int s, int mask) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  const int64_t cell = (int64_t)blockIdx.x * TILE_C + warp;
  float* out_s = out + cell * s;  // a (c, s) output row
  float* out_p = out + cell * p;  // a (c, p) output row

  if constexpr (R <= 8) {  // the first skeleton
    const int64_t ps = (int64_t)p * s;
    float* x0 = (float*)smem + (size_t)warp * (4 * s + 4 * p);
    float* lx = x0 + 2 * s;
    for (int j = lane; j < s; j += WARP) x0[j] = X[cell * s + j];
    __syncwarp();
    if constexpr (R == 1) {  // k_copy
      for (int j = lane; j < s; j += WARP) out_s[j] = x0[j] * 1.000001f;
    } else if constexpr (R == 2) {  // k_i16_load: X + sum_p N
      const int16_t* n = N + cell * ps;
      for (int j = lane; j < s; j += WARP) {
        float acc = 0.f;
        for (int k = 0; k < p; ++k) acc += (float)n[(int64_t)k * s + j];
        out_s[j] = x0[j] + acc;
      }
    } else if constexpr (R == 3) {  // k_explog
      for (int j = lane; j < s; j += WARP)
        out_s[j] = expf(logf(x0[j] + 1.f)) - 1.f;
    } else if constexpr (R == 4 || R == 5) {  // k_reduce_sum, k_prod_pow
      const int16_t* n = N + cell * ps;
      for (int j = lane; j < s; j += WARP) lx[j] = safe_log(x0[j]);
      for (int k = 0; k < p; ++k) {
        float e = 0.f;
        for (int j = lane; j < s; j += WARP)
          e += (float)n[(int64_t)k * s + j] * lx[j];
        e = warp_sum(e);
        if (lane == 0) out_p[k] = R == 4 ? e : inf_to_max(expf(e));
      }
    } else if constexpr (R == 6) {  // k_float_pow: sum_s (X + 1)^A
      const int16_t* a = A + cell * ps;
      for (int k = 0; k < p; ++k) {
        float acc = 0.f;
        for (int j = lane; j < s; j += WARP)
          acc += powf(x0[j] + 1.f, (float)a[(int64_t)k * s + j]);
        acc = warp_sum(acc);
        if (lane == 0) out_p[k] = acc;
      }
    } else if constexpr (R == 7) {  // k_unrolled_prod: left to right
      float prod = x0[0];
      for (int j = 1; j < s; ++j) prod *= x0[j];
      for (int j = lane; j < s; j += WARP) out_s[j] = prod + 0.f * x0[j];
    } else {  // 8, k_reduce_prod: a warp reduction
      float prod = 1.f;
      for (int j = lane; j < s; j += WARP) prod *= x0[j];
      for (int o = WARP / 2; o > 0; o >>= 1)
        prod *= __shfl_xor_sync(FULL, prod, o);
      for (int j = lane; j < s; j += WARP) out_s[j] = prod + 0.f * x0[j];
    }
  } else {  // the integrator kernel's skeleton
    const Globals g{Ke, Kmf, Kmb, Kmr, Vmax, N, Nf, Nb, A};
    const CellPtrs cp = stage_tile<RESIDENT>(
        smem, tile_layout(p, s, RESIDENT ? RES_ALL : mask), mask, g,
        (int64_t)blockIdx.x * TILE_C, p, s, warp, lane);
    const Scratch w = cell_scratch(smem, warp, p, s);
    for (int j = lane; j < s; j += WARP) w.x0[j] = X[cell * s + j];
    __syncwarp();
    if constexpr (R == 9) {  // k_velocities: X + sum_p N * V
      velocities(cp, w, lane, p, s, [&](int k) { return cp.Vmax[k]; });
      for (int j = lane; j < s; j += WARP) {
        float acc = 0.f;
        for (int k = 0; k < p; ++k)
          acc += i2f(cp.N[(size_t)k * cp.ld_n + j]) * w.V[k];
        out_s[j] = w.x0[j] + acc;
      }
    } else {  // 10: k_full_part (one trim pass), 11: k_full_3trim
      for (int pass = 0; pass < (R == 10 ? 1 : 3); ++pass)
        trim_pass(cp, w, lane, p, s, trim_factor(pass));
      for (int j = lane; j < s; j += WARP) out_s[j] = w.x0[j];
    }
  }
}

template <int R, bool RESIDENT>
int launch_as(const float* X, const Globals& g, float* out, int c, int p,
              int s, int mask, cudaStream_t stream) {
  const size_t smem = rung_smem_bytes(R, p, s, mask);
  cudaError_t err = cudaFuncSetAttribute(
      rung_kernel<R, RESIDENT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (c == 0) return (int)cudaSuccess;
  rung_kernel<R, RESIDENT><<<c / TILE_C, THREADS, smem, stream>>>(
      X, g.Ke, g.Kmf, g.Kmb, g.Kmr, g.Vmax, g.N, g.Nf, g.Nb, g.A, out, p, s,
      mask);
  return (int)cudaGetLastError();
}

// Rungs 1-8 take no mask; rungs 9-11 run the resident instantiation
// where the integrator kernel does.
template <int R>
int launch(const float* X, const Globals& g, float* out, int c, int p, int s,
           int mask, cudaStream_t stream) {
  if constexpr (R <= 8) {
    return launch_as<R, false>(X, g, out, c, p, s, mask, stream);
  } else {
    return mask == RES_ALL
               ? launch_as<R, true>(X, g, out, c, p, s, mask, stream)
               : launch_as<R, false>(X, g, out, c, p, s, mask, stream);
  }
}

}  // namespace

extern "C" {

int ms_bisect_tile_c() { return TILE_C; }

// The dynamic shared memory of rung `rung` for (p, s): the first
// skeleton's for rungs 1-8, the integrator's layout with the groups of
// `mask` resident for rungs 9-11.
size_t ms_bisect_smem_bytes(int rung, int p, int s, int mask) {
  return rung_smem_bytes(rung, p, s, mask);
}

// Rung 1-11 over c cells (c % TILE_C == 0): X (c, s) f32, Ke/Kmf/Kmb/Vmax
// (c, p) f32, Kmr (c, p, s) f32, N/Nf/Nb/A (c, p, s) i16, all contiguous;
// a rung reads only its own inputs (the others may be null).  out is
// (c, s) f32, or (c, p) for rungs 4-6.  `mask` is the launch plan's
// resident groups for rungs 9-11 (ignored by 1-8).  Launches on `stream`
// without synchronizing; returns cudaGetLastError(), or
// cudaErrorInvalidValue for an unknown rung.
int ms_bisect_rung(int rung, const float* X, const float* Ke,
                   const float* Kmf, const float* Kmb, const float* Kmr,
                   const float* Vmax, const int16_t* N, const int16_t* Nf,
                   const int16_t* Nb, const int16_t* A, float* out, int c,
                   int p, int s, int mask, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const Globals g{Ke, Kmf, Kmb, Kmr, Vmax, N, Nf, Nb, A};
  if (mask < 0 || mask > RES_ALL) return (int)cudaErrorInvalidValue;
#define MS_RUNG(R) \
  case R:          \
    return launch<R>(X, g, out, c, p, s, mask, st)
  switch (rung) {
    MS_RUNG(1); MS_RUNG(2); MS_RUNG(3); MS_RUNG(4); MS_RUNG(5); MS_RUNG(6);
    MS_RUNG(7); MS_RUNG(8); MS_RUNG(9); MS_RUNG(10); MS_RUNG(11);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MS_RUNG
}

const char* ms_bisect_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
