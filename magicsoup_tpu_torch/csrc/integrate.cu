// The reversible Michaelis-Menten signal integrator as a CUDA kernel for
// Hopper (sm_90a).
//
// Replaces the TPU kernel magicsoup_tpu/ops/pallas_integrate.py::
// integrate_signals_pallas, solo grid (the Pallas `_kernel`): three trim
// passes (Vmax x 0.7, 0.2, 0.1) of the fast-mode integrator body
// (magicsoup_tpu/ops/integrate.py::_integrate_part with det=False and the
// exp-sum-log allosteric factor `_a_reg_logspace`), with the equilibrium
// correction's early stop voted per tile of cells.  Its plain PyTorch
// version is magicsoup_tpu_torch/ops/cuda_integrate.py::
// integrate_signals_tiled; the two differ only in summation order.
//
// Mapping.  One warp per cell, its lanes over the signals (lane j owns
// signals j, j + 32, ...; any number of signals).  A loop over the
// proteins computes each sum over signals (the log-space products, the
// allosteric sum, the min of the negative-guard factors) as a warp
// butterfly reduction, which leaves the same bits in every lane, so every
// branch on a per-protein value is warp-uniform.  Sums over proteins (the
// removed amounts, the weighted signal change) are per-lane loops.  The
// per-cell vectors -- signals X0, X1, log X, guard factors (s floats
// each) and per-protein V, W, F and flags (p each) -- live in dynamic
// shared memory sized from (p, s).
//
// Tiles.  A CTA is one tile of TILE_C = 8 cells (8 warps, 256 threads).
// The early stop of the equilibrium correction is one __syncthreads_or
// over the CTA: in the TPU kernel, as here, its vote runs over exactly one
// tile.  The tile size is therefore observable numerics: cells stop with
// their tile-mates.  Every thread reaches every barrier (lanes without a
// signal and dead cells, whose all-zero parameter rows are inert, take
// part), and the stop is CTA-uniform, so no thread leaves early.
//
// Numerics.  expf/logf (not the __expf intrinsics), IEEE division, built
// without --use_fast_math and with --fmad=false, so no multiply is fused
// into the following add as PyTorch's eager ops never do.  i16 parameters
// are widened to f32 in registers.  jnp.min and jnp.clip propagate NaN,
// fminf/fmaxf drop it: the helpers below keep the JAX semantics.
//
// What bounds it.  Bytes: it must read X and the nine parameter tensors
// once and write X1, q * (16p + 12ps + 8s) bytes (about 233 MB at
// q = 10240, p = 64, s = 28; 70 us at 3.35 TB/s).  This first version
// re-reads each cell's parameter rows from L1/L2 on every reduction (a
// trim pass reads Nf, Nb, A and Kmr once, N three times, and Nb, Nf and N
// again in each correction step).  Keeping a tile's parameters resident
// in shared memory for the whole step -- the Pallas kernel's design on
// the TPU's VMEM -- is the next step for this kernel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_C = 8;
constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;

constexpr float EPS_F = 1e-36f;
constexpr float MAX_F = 1e36f;
constexpr float MIN_F = -1e36f;
constexpr float LOG0 = -1e12f;
constexpr float UPPER = 1.5f;
constexpr float LOWER = (float)(1.0 / 1.5);
constexpr float IMPACT = 0.1f;

__device__ __forceinline__ float safe_log(float x) {
  return x > 0.f ? logf(fminf(x, MAX_F)) : LOG0;
}

// jnp.clip / jnp.minimum / jnp.maximum keep NaN
__device__ __forceinline__ float clip_nan(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float max0_nan(float x) {
  return isnan(x) ? x : fmaxf(x, 0.f);
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

__device__ __forceinline__ float inf_to_max(float x) {
  return isinf(x) ? MAX_F : x;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = WARP / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_min_nan(float v) {
  for (int o = WARP / 2; o > 0; o >>= 1)
    v = min_nan(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// prod_s(X^N) from the warp's log-space sum, as _prod_pow + the
// protein mask and Inf scrub of _velocities/_quotient
__device__ __forceinline__ float prod_from_log(float e, int involved) {
  float xx = inf_to_max(expf(e));
  return involved ? xx : 0.f;
}

struct CellPtrs {
  const float *Ke, *Kmf, *Kmb, *Vmax;  // (p,) rows
  const float *Kmr;                    // (p, s)
  const int16_t *N, *Nf, *Nb, *A;      // (p, s)
};

__global__ void __launch_bounds__(TILE_C * WARP)
integrate_kernel(const float* __restrict__ X, const float* __restrict__ Ke,
                 const float* __restrict__ Kmf, const float* __restrict__ Kmb,
                 const float* __restrict__ Kmr, const float* __restrict__ Vmax,
                 const int16_t* __restrict__ N, const int16_t* __restrict__ Nf,
                 const int16_t* __restrict__ Nb, const int16_t* __restrict__ A,
                 float* __restrict__ out, int p, int s) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  const int64_t cell = (int64_t)blockIdx.x * TILE_C + warp;

  // this warp's scratch: 4 signal vectors, 3 protein vectors, 1 flag vector
  float* x0 = smem + (size_t)warp * (4 * s + 4 * p);
  float* x1 = x0 + s;
  float* lx = x1 + s;
  float* fneg = lx + s;
  float* V = fneg + s;
  float* W = V + p;
  float* Fe = W + p;
  int* flags = (int*)(Fe + p);

  CellPtrs c;
  c.Ke = Ke + cell * p;
  c.Kmf = Kmf + cell * p;
  c.Kmb = Kmb + cell * p;
  c.Vmax = Vmax + cell * p;
  c.Kmr = Kmr + cell * p * s;
  c.N = N + cell * p * s;
  c.Nf = Nf + cell * p * s;
  c.Nb = Nb + cell * p * s;
  c.A = A + cell * p * s;

  for (int j = lane; j < s; j += WARP) x0[j] = X[cell * s + j];

  const float trims[3] = {0.7f, 0.2f, 0.1f};
  const float incs[4] = {0.5f, 0.25f, 0.125f, 0.0625f};
  const float log_max = logf(MAX_F);

  for (int pass = 0; pass < 3; ++pass) {
    // ---- velocities (_velocities, mosaic-safe regulation) ----
    for (int j = lane; j < s; j += WARP) lx[j] = safe_log(x0[j]);
    for (int k = 0; k < p; ++k) {
      float sf = 0.f, sb = 0.f, sr = 0.f;
      int anyf = 0, anyb = 0;
      for (int j = lane; j < s; j += WARP) {
        const int64_t o = (int64_t)k * s + j;
        const float l = lx[j];
        const int nf = c.Nf[o], nb = c.Nb[o], a = c.A[o];
        sf += (float)nf * l;
        sb += (float)nb * l;
        anyf |= nf > 0;
        anyb |= nb > 0;
        float r = 1.f;
        if (a != 0) {
          const float xa = expf(fminf((float)a * l, log_max));
          r = xa / (xa + c.Kmr[o]);
          if (isnan(r)) r = 1.f;
        }
        sr += r > 0.f ? logf(r) : LOG0;
      }
      sf = warp_sum(sf);
      sb = warp_sum(sb);
      sr = warp_sum(sr);
      anyf = __any_sync(FULL, anyf);
      anyb = __any_sync(FULL, anyb);
      float kf = prod_from_log(sf, 1) / c.Kmf[k];
      kf = inf_to_max(anyf ? kf : 0.f);
      float kb = prod_from_log(sb, 1) / c.Kmb[k];
      kb = inf_to_max(anyb ? kb : 0.f);
      const float a_cat = (kf - kb) / (1.f + kf + kb);
      const float vmax = max0_nan(c.Vmax[k] * trims[pass]);
      const float a_reg = expf(sr);
      if (lane == 0) V[k] = clip_nan(a_cat * vmax * a_reg, MIN_F, MAX_F);
    }
    __syncwarp();

    // ---- negative guard (_negative_factors) ----
    for (int j = lane; j < s; j += WARP) {
      float removed = 0.f;
      for (int k = 0; k < p; ++k) {
        const float m = -((float)c.N[(int64_t)k * s + j] * V[k]);
        removed += max0_nan(m);
      }
      const float f = x0[j] / removed;
      fneg[j] = f > 1.f ? 1.f : f;
    }
    for (int k = 0; k < p; ++k) {
      const float v = V[k];
      float m = 1.f;
      for (int j = lane; j < s; j += WARP) {
        const float nv = (float)c.N[(int64_t)k * s + j] * v;
        m = min_nan(m, nv < 0.f ? fneg[j] : 1.f);
      }
      m = warp_min_nan(m);
      if (lane == 0) W[k] = v * m;
    }
    for (int k = lane; k < p; k += WARP) Fe[k] = 1.f;
    __syncwarp();

    // ---- X1 = X0 + sum_p N*W, clamped at 0 (_weighted_dx) ----
    for (int j = lane; j < s; j += WARP) {
      float acc = 0.f;
      for (int k = 0; k < p; ++k) acc += (float)c.N[(int64_t)k * s + j] * W[k];
      const float x = x0[j] + acc;
      x1[j] = x < 0.f ? 0.f : x;
    }

    // ---- equilibrium correction (_equilibrium_adjusted_x) ----
    for (int it = 0; it < 4; ++it) {
      for (int j = lane; j < s; j += WARP) lx[j] = safe_log(x1[j]);
      int any_adj = 0;
      for (int k = 0; k < p; ++k) {
        float sf = 0.f, sb = 0.f;
        int anyf = 0, anyb = 0;
        for (int j = lane; j < s; j += WARP) {
          const int64_t o = (int64_t)k * s + j;
          const float l = lx[j];
          const int nf = c.Nf[o], nb = c.Nb[o];
          sf += (float)nf * l;
          sb += (float)nb * l;
          anyf |= nf > 0;
          anyb |= nb > 0;
        }
        sf = warp_sum(sf);
        sb = warp_sum(sb);
        anyf = __any_sync(FULL, anyf);
        anyb = __any_sync(FULL, anyb);
        const float xx_prod = prod_from_log(sb, anyb);
        const float xx_subs = prod_from_log(sf, anyf);
        float q = clip_nan(xx_prod / xx_subs, EPS_F, MAX_F);
        if (isnan(q)) q = 1.f;
        const float qke = q / c.Ke[k];
        const float v = V[k];
        const float f = Fe[k];
        const bool fwd = v > 0.f;
        bool low = fwd ? qke < LOWER : qke > UPPER;
        if (fwd && f == 1.f) low = false;
        bool high = fwd ? qke > UPPER : qke < LOWER;
        if (!fwd && f == 0.f) high = false;
        any_adj |= (low || high) && fabsf(v) > IMPACT;
        if (lane == 0) flags[k] = (low ? 1 : 0) | (high ? 2 : 0);
      }
      // the tile's early-stop vote; a barrier for all 8 warps
      if (!__syncthreads_or(any_adj)) break;
      const float inc = incs[it];
      for (int k = lane; k < p; k += WARP) {
        float f = Fe[k];
        if (flags[k] & 2) f -= inc;
        if (flags[k] & 1) f += inc;
        Fe[k] = clip_nan(f, 0.f, 1.f);
      }
      __syncwarp();
      for (int j = lane; j < s; j += WARP) {
        float acc = 0.f;
        for (int k = 0; k < p; ++k)
          acc += (float)c.N[(int64_t)k * s + j] * (W[k] * Fe[k]);
        const float x = x0[j] + acc;
        x1[j] = x < 0.f ? 0.f : x;
      }
      __syncwarp();
    }

    for (int j = lane; j < s; j += WARP) x0[j] = x1[j];
    __syncwarp();
  }

  for (int j = lane; j < s; j += WARP) out[cell * s + j] = x0[j];
}

}  // namespace

extern "C" {

int ms_tile_c() { return TILE_C; }

size_t ms_integrate_smem_bytes(int p, int s) {
  return (size_t)TILE_C * (4 * (size_t)s + 4 * (size_t)p) * sizeof(float);
}

// X/out (c, s) f32; Ke/Kmf/Kmb/Vmax (c, p) f32; Kmr (c, p, s) f32;
// N/Nf/Nb/A (c, p, s) i16; all row-major and contiguous; c % TILE_C == 0.
// Launches on `stream` without synchronizing; returns cudaGetLastError().
int ms_integrate_signals(const float* X, const float* Ke, const float* Kmf,
                         const float* Kmb, const float* Kmr, const float* Vmax,
                         const int16_t* N, const int16_t* Nf, const int16_t* Nb,
                         const int16_t* A, float* out, int c, int p, int s,
                         void* stream) {
  const size_t smem = ms_integrate_smem_bytes(p, s);
  cudaError_t err = cudaFuncSetAttribute(
      integrate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (c == 0) return (int)cudaSuccess;
  integrate_kernel<<<c / TILE_C, TILE_C * WARP, smem, (cudaStream_t)stream>>>(
      X, Ke, Kmf, Kmb, Kmr, Vmax, N, Nf, Nb, A, out, p, s);
  return (int)cudaGetLastError();
}

const char* ms_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
