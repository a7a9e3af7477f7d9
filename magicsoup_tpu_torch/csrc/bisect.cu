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
// Skeleton.  Every rung runs on the integrator kernel's skeleton
// (integrate_body.cuh): a CTA of 8 warps, one cell per warp, lanes over
// the signals, X staged into the same dynamic shared-memory scratch.  So a
// difference in time between two rungs belongs to the sub-expression, not
// to the mapping.  Rungs 9-11 call the device functions of
// integrate_body.cuh -- the production code, not a copy -- so rung 11 is
// the integrator kernel's body and its output is bit-equal to it.
//
// What bounds it.  Rungs 1-8 read X and at most one i16 (c, p, s) tensor
// and write (c, s) or (c, p) floats: at the workload's shapes a few MB, a
// few microseconds at 3.35 TB/s, so their time is mostly launch latency.
// Rung 9 reads every parameter tensor but Ke (only the equilibrium
// correction reads it); rungs 10-11 read all nine, as the integrator does.
#include "integrate_body.cuh"

using namespace msbody;

namespace {

template <int R>
__global__ void __launch_bounds__(TILE_C * WARP)
rung_kernel(const float* __restrict__ X, const float* __restrict__ Ke,
            const float* __restrict__ Kmf, const float* __restrict__ Kmb,
            const float* __restrict__ Kmr, const float* __restrict__ Vmax,
            const int16_t* __restrict__ N, const int16_t* __restrict__ Nf,
            const int16_t* __restrict__ Nb, const int16_t* __restrict__ A,
            float* __restrict__ out, int p, int s) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  const int64_t cell = (int64_t)blockIdx.x * TILE_C + warp;
  const int64_t ps = (int64_t)p * s;
  const Scratch w = warp_scratch(smem, warp, p, s);
  float* out_s = out + cell * s;  // a (c, s) output row
  float* out_p = out + cell * p;  // a (c, p) output row

  for (int j = lane; j < s; j += WARP) w.x0[j] = X[cell * s + j];
  __syncwarp();

  if constexpr (R == 1) {  // k_copy
    for (int j = lane; j < s; j += WARP) out_s[j] = w.x0[j] * 1.000001f;
  } else if constexpr (R == 2) {  // k_i16_load: X + sum_p N
    const int16_t* n = N + cell * ps;
    for (int j = lane; j < s; j += WARP) {
      float acc = 0.f;
      for (int k = 0; k < p; ++k) acc += (float)n[(int64_t)k * s + j];
      out_s[j] = w.x0[j] + acc;
    }
  } else if constexpr (R == 3) {  // k_explog
    for (int j = lane; j < s; j += WARP)
      out_s[j] = expf(logf(w.x0[j] + 1.f)) - 1.f;
  } else if constexpr (R == 4 || R == 5) {  // k_reduce_sum, k_prod_pow
    const int16_t* n = N + cell * ps;
    for (int j = lane; j < s; j += WARP) w.lx[j] = safe_log(w.x0[j]);
    for (int k = 0; k < p; ++k) {
      float e = 0.f;
      for (int j = lane; j < s; j += WARP)
        e += (float)n[(int64_t)k * s + j] * w.lx[j];
      e = warp_sum(e);
      if (lane == 0) out_p[k] = R == 4 ? e : inf_to_max(expf(e));
    }
  } else if constexpr (R == 6) {  // k_float_pow: sum_s (X + 1)^A
    const int16_t* a = A + cell * ps;
    for (int k = 0; k < p; ++k) {
      float acc = 0.f;
      for (int j = lane; j < s; j += WARP)
        acc += powf(w.x0[j] + 1.f, (float)a[(int64_t)k * s + j]);
      acc = warp_sum(acc);
      if (lane == 0) out_p[k] = acc;
    }
  } else if constexpr (R == 7) {  // k_unrolled_prod: left to right
    float prod = w.x0[0];
    for (int j = 1; j < s; ++j) prod *= w.x0[j];
    for (int j = lane; j < s; j += WARP) out_s[j] = prod + 0.f * w.x0[j];
  } else if constexpr (R == 8) {  // k_reduce_prod: a warp reduction
    float prod = 1.f;
    for (int j = lane; j < s; j += WARP) prod *= w.x0[j];
    for (int o = WARP / 2; o > 0; o >>= 1)
      prod *= __shfl_xor_sync(FULL, prod, o);
    for (int j = lane; j < s; j += WARP) out_s[j] = prod + 0.f * w.x0[j];
  } else if constexpr (R == 9) {  // k_velocities: X + sum_p N * V
    const CellPtrs cp = cell_ptrs(Ke, Kmf, Kmb, Kmr, Vmax, N, Nf, Nb, A, cell, p, s);
    velocities(cp, w, lane, p, s, [&](int k) { return cp.Vmax[k]; });
    for (int j = lane; j < s; j += WARP) {
      float acc = 0.f;
      for (int k = 0; k < p; ++k) acc += (float)cp.N[(int64_t)k * s + j] * w.V[k];
      out_s[j] = w.x0[j] + acc;
    }
  } else {  // 10: k_full_part (one trim pass), 11: k_full_3trim
    const CellPtrs cp = cell_ptrs(Ke, Kmf, Kmb, Kmr, Vmax, N, Nf, Nb, A, cell, p, s);
    for (int pass = 0; pass < (R == 10 ? 1 : 3); ++pass)
      trim_pass(cp, w, lane, p, s, trim_factor(pass));
    for (int j = lane; j < s; j += WARP) out_s[j] = w.x0[j];
  }
}

template <int R>
int launch(const float* X, const float* Ke, const float* Kmf,
           const float* Kmb, const float* Kmr, const float* Vmax,
           const int16_t* N, const int16_t* Nf, const int16_t* Nb,
           const int16_t* A, float* out, int c, int p, int s,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(p, s);
  cudaError_t err = cudaFuncSetAttribute(
      rung_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (c == 0) return (int)cudaSuccess;
  rung_kernel<R><<<c / TILE_C, TILE_C * WARP, smem, stream>>>(
      X, Ke, Kmf, Kmb, Kmr, Vmax, N, Nf, Nb, A, out, p, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ms_bisect_tile_c() { return TILE_C; }

size_t ms_bisect_smem_bytes(int p, int s) { return smem_bytes(p, s); }

// Rung 1-11 over c cells (c % TILE_C == 0): X (c, s) f32, Ke/Kmf/Kmb/Vmax
// (c, p) f32, Kmr (c, p, s) f32, N/Nf/Nb/A (c, p, s) i16, all contiguous;
// a rung reads only its own inputs (the others may be null).  out is
// (c, s) f32, or (c, p) for rungs 4-6.  Launches on `stream` without
// synchronizing; returns cudaGetLastError(), or cudaErrorInvalidValue for
// an unknown rung.
int ms_bisect_rung(int rung, const float* X, const float* Ke,
                   const float* Kmf, const float* Kmb, const float* Kmr,
                   const float* Vmax, const int16_t* N, const int16_t* Nf,
                   const int16_t* Nb, const int16_t* A, float* out, int c,
                   int p, int s, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
#define MS_RUNG(R)                                                        \
  case R:                                                                 \
    return launch<R>(X, Ke, Kmf, Kmb, Kmr, Vmax, N, Nf, Nb, A, out, c, p, \
                     s, st)
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
