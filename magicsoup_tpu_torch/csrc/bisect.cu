// The integrator's lowering ladder as CUDA kernels for Hopper (sm_90a):
// each rung one sub-expression of the integrator's body as its own kernel.
//
// Replaces the TPU kernel performance/pallas_bisect.py::main, whose
// `call()` (:96-111) wraps pl.pallas_call around each rung body: rungs 1-8
// are sub-expressions of the body (copy, i16 load and sum, exp/log, the
// log-space reduce, _prod_pow, float pow, the unrolled product, the
// product reduction); rungs 9-11 are the velocity body, one trim pass and
// three trim passes.  On the TPU the ladder isolated what Mosaic could not
// lower; here every rung builds, and the ladder's use is to check each
// piece against its plain PyTorch version
// (magicsoup_tpu_torch/ops/cuda_bisect.py) and to time it against its own
// byte bound, so that a rung's time says what its sub-expression costs
// inside the integrator kernel.
//
// One skeleton.  Every rung runs the integrator kernel's own skeleton and
// device functions (integrate_body.cuh), the production code, not a copy:
// a CTA is one tile of TILE_C = 8 cells, one warp per cell; X goes to the
// cell's scratch (cell_scratch) as the integrator's prologue puts it
// there; the parameter groups the rung reads are staged into dynamic
// shared memory by stage_tile under the integrator's launch plan
// restricted to those groups (ops/cuda_integrate.py::plan), so the rows
// are the padded ld16 rows with an odd word stride, copied 8 rows in
// flight per lane; each sum over signals, one per protein (rungs 4-6),
// puts the lanes over the proteins and runs tree_sum in the integrator's
// fixed order over the resident row, and each sum over proteins, one per
// signal (rung 2), puts the lanes over the signals and runs serially over
// the proteins, as the signal update does.  Rung 8's product over signals
// is one such tree.  So a difference in time between two rungs belongs to
// the sub-expression, not to the mapping, and rung 4 is exactly the
// log-space sum that the integrator's velocities take.  Rung 11 is the
// integrator kernel's body, and its output is bit-equal to it.
//
// What bounds it.  Bytes, for every rung: rungs 1-8 read X and at most
// one i16 (c, p, s) tensor and write (c, s) or (c, p) floats (2.3 MB or
// 20.8 MB at 10240 x 32 x 28: 0.7 or 6.2 us at 3.35 TB/s), and do a few
// operations per byte (rung 6 a powf per i16, about 20 operations per
// byte, still under the f32 rate's line).  Rung 9 reads every parameter
// tensor but Ke (only the equilibrium correction reads it); rungs 10-11
// read all nine, as the integrator does.  What kept the first design of
// rungs 1-8 (a warp per cell, lanes over signals) at 11-19% of that bound
// for rungs 4-6 was latency: a serial loop over the proteins, each an
// unstaged global i16 load per lane and a 5-step shuffle chain.  Here the
// proteins run in parallel, one lane each, every row is read from shared
// memory staged once per tile, and no sum is a shuffle chain.  What stays
// is the tile's fixed cost, which the elementwise rungs are made of: one
// CTA of 256 threads per 8 cells (1,280 CTAs at 10240 cells), the copy of
// X through shared memory, and 4 of 32 lanes idle at s = 28.  Left out on
// purpose, as for the integrator: TMA and cp.async.bulk (the padded
// destination is not contiguous; integrate_body.cuh), wgmma (a per-cell
// 32 x 28 mat-vec at about one operation per byte has no matrix product
// for the tensor cores) and persistent CTAs (they would change the
// integrator's grid, whose cost the ladder measures).
#include "integrate_body.cuh"

using namespace msbody;

namespace {

// The launch plan's groups a rung reads (RES_* of integrate_body.cuh): N
// for the signal sum and the log-space sums, A for the float pow, every
// group for the velocity body and the trim passes.
__host__ __device__ constexpr int rung_groups(int rung) {
  return rung == 2 || rung == 4 || rung == 5 ? RES_N
         : rung == 6                         ? RES_A
         : rung >= 9                         ? RES_ALL
                                             : 0;
}

// A product as tree_sum's accumulator: Prod{} is 1, + multiplies.
struct Prod {
  float v = 1.f;
  __device__ __forceinline__ Prod& operator+=(const Prod& o) {
    v *= o.v;
    return *this;
  }
  __device__ __forceinline__ Prod operator+(const Prod& o) const {
    return Prod{v * o.v};
  }
};

// RESIDENT: the rung's groups are all staged (mask == rung_groups(R)),
// with loads the compiler knows to be shared; else none is (mask 0).
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
  const Globals g{Ke, Kmf, Kmb, Kmr, Vmax, N, Nf, Nb, A};
  const CellPtrs cp = stage_tile<RESIDENT, rung_groups(R)>(
      smem, tile_layout(p, s, RESIDENT ? rung_groups(R) : mask), mask, g,
      (int64_t)blockIdx.x * TILE_C, p, s, warp, lane);
  const Scratch w = cell_scratch(smem, warp, p, s);
  for (int j = lane; j < s; j += WARP) w.x0[j] = X[cell * s + j];
  __syncwarp();
  float* out_s = out + cell * s;  // a (c, s) output row
  float* out_p = out + cell * p;  // a (c, p) output row

  if constexpr (R == 1) {  // k_copy
    for (int j = lane; j < s; j += WARP) out_s[j] = w.x0[j] * 1.000001f;
  } else if constexpr (R == 2) {  // k_i16_load: X + sum_p N
    for (int j = lane; j < s; j += WARP) {
      float acc = 0.f;
      for (int k = 0; k < p; ++k) acc += i2f(cp.N[(size_t)k * cp.ld_n + j]);
      out_s[j] = w.x0[j] + acc;
    }
  } else if constexpr (R == 3) {  // k_explog
    for (int j = lane; j < s; j += WARP)
      out_s[j] = expf(logf(w.x0[j] + 1.f)) - 1.f;
  } else if constexpr (R == 4 || R == 5) {  // k_reduce_sum, k_prod_pow
    for (int j = lane; j < s; j += WARP) w.lx[j] = safe_log(w.x0[j]);
    __syncwarp();
    for (int k = lane; k < p; k += WARP) {
      const int16_t* n = cp.N + (size_t)k * cp.ld_n;
      const float e =
          tree_sum<float>(s, [&](int j) { return i2f(n[j]) * w.lx[j]; });
      out_p[k] = R == 4 ? e : prod_from_log(e, true);
    }
  } else if constexpr (R == 6) {  // k_float_pow: sum_s (X + 1)^A
    for (int k = lane; k < p; k += WARP) {
      const int16_t* a = cp.A + (size_t)k * cp.ld_a;
      out_p[k] = tree_sum<float>(
          s, [&](int j) { return powf(w.x0[j] + 1.f, i2f(a[j])); });
    }
  } else if constexpr (R == 7) {  // k_unrolled_prod: left to right
    float prod = w.x0[0];
    for (int j = 1; j < s; ++j) prod *= w.x0[j];
    for (int j = lane; j < s; j += WARP) out_s[j] = prod + 0.f * w.x0[j];
  } else if constexpr (R == 8) {  // k_reduce_prod: one tree
    const float prod = tree_sum<Prod>(s, [&](int j) { return Prod{w.x0[j]}; }).v;
    for (int j = lane; j < s; j += WARP) out_s[j] = prod + 0.f * w.x0[j];
  } else if constexpr (R == 9) {  // k_velocities: X + sum_p N * V
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

// What one call does: launch the rung over c cells, or (ctas non-null)
// report the CTAs of it that one SM holds.
struct Call {
  const float* X;
  Globals g;
  float* out;
  int c, p, s, mask;
  cudaStream_t stream;
  int* ctas;
};

template <int R, bool RESIDENT>
int call_as(const Call& a) {
  const size_t smem = tile_layout(a.p, a.s, a.mask).bytes;
  cudaError_t err = allow_kernel_smem<rung_kernel<R, RESIDENT>>(smem);
  if (err != cudaSuccess) return (int)err;
  if (a.ctas != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        a.ctas, rung_kernel<R, RESIDENT>, THREADS, smem);
  if (a.c == 0) return (int)cudaSuccess;
  rung_kernel<R, RESIDENT><<<a.c / TILE_C, THREADS, smem, a.stream>>>(
      a.X, a.g.Ke, a.g.Kmf, a.g.Kmb, a.g.Kmr, a.g.Vmax, a.g.N, a.g.Nf,
      a.g.Nb, a.g.A, a.out, a.p, a.s, a.mask);
  return (int)cudaGetLastError();
}

// A rung stages the groups of `mask`, which the launch plan restricted to
// the rung's own: rungs 1-8 read at most one group, so all of them or
// none; rungs 9-11 take any of the plan's masks, as the integrator kernel
// does.  A mask with a group the rung does not read is refused.
template <int R>
int call(const Call& a) {
  constexpr int G = rung_groups(R);
  if (a.mask & ~G) return (int)cudaErrorInvalidValue;
  if constexpr (G == 0) {
    return call_as<R, true>(a);
  } else {
    return a.mask == G ? call_as<R, true>(a) : call_as<R, false>(a);
  }
}

int dispatch(int rung, const Call& a) {
  if (a.mask < 0 || a.mask > RES_ALL) return (int)cudaErrorInvalidValue;
#define MS_RUNG(R) \
  case R:          \
    return call<R>(a)
  switch (rung) {
    MS_RUNG(1); MS_RUNG(2); MS_RUNG(3); MS_RUNG(4); MS_RUNG(5); MS_RUNG(6);
    MS_RUNG(7); MS_RUNG(8); MS_RUNG(9); MS_RUNG(10); MS_RUNG(11);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MS_RUNG
}

}  // namespace

extern "C" {

int ms_bisect_tile_c() { return TILE_C; }

// The launch plan's groups rung `rung` reads (RES_* bits).
int ms_bisect_rung_groups(int rung) { return rung_groups(rung); }

// The dynamic shared memory of rung `rung` for (p, s) with the groups of
// `mask` resident: the integrator's layout, for every rung.
size_t ms_bisect_smem_bytes(int rung, int p, int s, int mask) {
  (void)rung;
  return tile_layout(p, s, mask).bytes;
}

// Rung 1-11 over c cells (c % TILE_C == 0): X (c, s) f32, Ke/Kmf/Kmb/Vmax
// (c, p) f32, Kmr (c, p, s) f32, N/Nf/Nb/A (c, p, s) i16, all contiguous;
// a rung reads only its own inputs (the others may be null).  out is
// (c, s) f32, or (c, p) for rungs 4-6.  `mask` is the launch plan's
// resident groups restricted to the rung's (ms_bisect_rung_groups): for
// rungs 1-8 all of them or none.  Launches on `stream` without
// synchronizing; returns cudaGetLastError(), or cudaErrorInvalidValue for
// an unknown rung or a mask it does not take.
int ms_bisect_rung(int rung, const float* X, const float* Ke,
                   const float* Kmf, const float* Kmb, const float* Kmr,
                   const float* Vmax, const int16_t* N, const int16_t* Nf,
                   const int16_t* Nb, const int16_t* A, float* out, int c,
                   int p, int s, int mask, void* stream) {
  const Call a{X, Globals{Ke, Kmf, Kmb, Kmr, Vmax, N, Nf, Nb, A}, out, c, p,
               s, mask, (cudaStream_t)stream, nullptr};
  return dispatch(rung, a);
}

// The CTAs of rung `rung` at (p, s, mask) that one SM holds, from the
// CUDA occupancy calculator (into *ctas).
int ms_bisect_ctas_per_sm(int rung, int p, int s, int mask, int* ctas) {
  const Call a{nullptr, Globals{}, nullptr, 0, p, s, mask, nullptr, ctas};
  return dispatch(rung, a);
}

const char* ms_bisect_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
