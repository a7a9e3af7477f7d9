// The body of the reversible Michaelis-Menten signal integrator as device
// functions, shared by the integrator kernel (integrate.cu, K1/K2) and the
// ladder of its sub-expressions (bisect.cu, K3), so that a ladder rung
// runs the production code and not a copy of it.
//
// Mapping (every kernel that includes this header).  A CTA is one tile of
// TILE_C = 8 cells, one warp per cell, its lanes over the signals (lane j
// owns signals j, j + 32, ...; any number of signals).  A loop over the
// proteins computes each sum over signals (the log-space products, the
// allosteric sum, the min of the negative-guard factors) as a warp
// butterfly reduction, which leaves the same bits in every lane, so every
// branch on a per-protein value is warp-uniform.  Sums over proteins (the
// removed amounts, the weighted signal change) are per-lane loops.  The
// per-cell vectors -- signals X0, X1, log X, guard factors (s floats each)
// and per-protein V, W, F and flags (p each) -- live in dynamic shared
// memory sized from (p, s) by smem_bytes().
//
// Numerics.  expf/logf (not the __expf intrinsics), IEEE division, built
// without --use_fast_math and with --fmad=false, so no multiply is fused
// into the following add as PyTorch's eager ops never do.  i16 parameters
// are widened to f32 in registers.  jnp.min and jnp.clip propagate NaN,
// fminf/fmaxf drop it: the helpers below keep the JAX semantics.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace msbody {

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

// One cell's parameter rows.
struct CellPtrs {
  const float *Ke, *Kmf, *Kmb, *Vmax;  // (p,) rows
  const float *Kmr;                    // (p, s)
  const int16_t *N, *Nf, *Nb, *A;      // (p, s)
};

__device__ __forceinline__ CellPtrs cell_ptrs(
    const float* Ke, const float* Kmf, const float* Kmb, const float* Kmr,
    const float* Vmax, const int16_t* N, const int16_t* Nf,
    const int16_t* Nb, const int16_t* A, int64_t prow, int p, int s) {
  CellPtrs cp;
  cp.Ke = Ke + prow * p;
  cp.Kmf = Kmf + prow * p;
  cp.Kmb = Kmb + prow * p;
  cp.Vmax = Vmax + prow * p;
  cp.Kmr = Kmr + prow * p * s;
  cp.N = N + prow * p * s;
  cp.Nf = Nf + prow * p * s;
  cp.Nb = Nb + prow * p * s;
  cp.A = A + prow * p * s;
  return cp;
}

// One warp's scratch: 4 signal vectors, 3 protein vectors, 1 flag vector.
struct Scratch {
  float *x0, *x1, *lx, *fneg;  // (s,)
  float *V, *W, *Fe;           // (p,)
  int* flags;                  // (p,)
};

__host__ __device__ constexpr size_t smem_bytes(int p, int s) {
  return (size_t)TILE_C * (4 * (size_t)s + 4 * (size_t)p) * sizeof(float);
}

__device__ __forceinline__ Scratch warp_scratch(float* smem, int warp, int p,
                                                int s) {
  Scratch w;
  w.x0 = smem + (size_t)warp * (4 * s + 4 * p);
  w.x1 = w.x0 + s;
  w.lx = w.x1 + s;
  w.fneg = w.lx + s;
  w.V = w.fneg + s;
  w.W = w.V + p;
  w.Fe = w.W + p;
  w.flags = (int*)(w.Fe + p);
  return w;
}

// ---- velocities (_velocities, mosaic-safe regulation) ----
// V[k] from the signals x0 and the per-protein Vmax that vmax_at(k)
// gives (a trim pass: max(Vmax * trim, 0)).
template <class VmaxAt>
__device__ __forceinline__ void velocities(const CellPtrs& cp,
                                           const Scratch& w, int lane, int p,
                                           int s, VmaxAt vmax_at) {
  const float log_max = logf(MAX_F);
  for (int j = lane; j < s; j += WARP) w.lx[j] = safe_log(w.x0[j]);
  for (int k = 0; k < p; ++k) {
    float sf = 0.f, sb = 0.f, sr = 0.f;
    int anyf = 0, anyb = 0;
    for (int j = lane; j < s; j += WARP) {
      const int64_t o = (int64_t)k * s + j;
      const float l = w.lx[j];
      const int nf = cp.Nf[o], nb = cp.Nb[o], a = cp.A[o];
      sf += (float)nf * l;
      sb += (float)nb * l;
      anyf |= nf > 0;
      anyb |= nb > 0;
      float r = 1.f;
      if (a != 0) {
        const float xa = expf(fminf((float)a * l, log_max));
        r = xa / (xa + cp.Kmr[o]);
        if (isnan(r)) r = 1.f;
      }
      sr += r > 0.f ? logf(r) : LOG0;
    }
    sf = warp_sum(sf);
    sb = warp_sum(sb);
    sr = warp_sum(sr);
    anyf = __any_sync(FULL, anyf);
    anyb = __any_sync(FULL, anyb);
    float kf = prod_from_log(sf, 1) / cp.Kmf[k];
    kf = inf_to_max(anyf ? kf : 0.f);
    float kb = prod_from_log(sb, 1) / cp.Kmb[k];
    kb = inf_to_max(anyb ? kb : 0.f);
    const float a_cat = (kf - kb) / (1.f + kf + kb);
    const float vmax = vmax_at(k);
    const float a_reg = expf(sr);
    if (lane == 0) w.V[k] = clip_nan(a_cat * vmax * a_reg, MIN_F, MAX_F);
  }
  __syncwarp();
}

// ---- negative guard (_negative_factors): W = V * F_min, Fe = 1 ----
__device__ __forceinline__ void negative_guard(const CellPtrs& cp,
                                               const Scratch& w, int lane,
                                               int p, int s) {
  for (int j = lane; j < s; j += WARP) {
    float removed = 0.f;
    for (int k = 0; k < p; ++k) {
      const float m = -((float)cp.N[(int64_t)k * s + j] * w.V[k]);
      removed += max0_nan(m);
    }
    const float f = w.x0[j] / removed;
    w.fneg[j] = f > 1.f ? 1.f : f;
  }
  for (int k = 0; k < p; ++k) {
    const float v = w.V[k];
    float m = 1.f;
    for (int j = lane; j < s; j += WARP) {
      const float nv = (float)cp.N[(int64_t)k * s + j] * v;
      m = min_nan(m, nv < 0.f ? w.fneg[j] : 1.f);
    }
    m = warp_min_nan(m);
    if (lane == 0) w.W[k] = v * m;
  }
  for (int k = lane; k < p; k += WARP) w.Fe[k] = 1.f;
  __syncwarp();
}

// ---- X1 = X0 + sum_p N*W, clamped at 0 (_weighted_dx) ----
__device__ __forceinline__ void signal_update(const CellPtrs& cp,
                                              const Scratch& w, int lane,
                                              int p, int s) {
  for (int j = lane; j < s; j += WARP) {
    float acc = 0.f;
    for (int k = 0; k < p; ++k) acc += (float)cp.N[(int64_t)k * s + j] * w.W[k];
    const float x = w.x0[j] + acc;
    w.x1[j] = x < 0.f ? 0.f : x;
  }
}

// ---- equilibrium correction (_equilibrium_adjusted_x) ----
// Its early stop is one __syncthreads_or over the CTA, the tile's vote:
// every thread of the CTA must call this function (lanes without a
// signal and dead cells, whose all-zero parameter rows are inert, take
// part), and the stop is CTA-uniform, so no thread leaves early.
__device__ __forceinline__ void equilibrium_correction(const CellPtrs& cp,
                                                       const Scratch& w,
                                                       int lane, int p,
                                                       int s) {
  const float incs[4] = {0.5f, 0.25f, 0.125f, 0.0625f};
  for (int it = 0; it < 4; ++it) {
    for (int j = lane; j < s; j += WARP) w.lx[j] = safe_log(w.x1[j]);
    int any_adj = 0;
    for (int k = 0; k < p; ++k) {
      float sf = 0.f, sb = 0.f;
      int anyf = 0, anyb = 0;
      for (int j = lane; j < s; j += WARP) {
        const int64_t o = (int64_t)k * s + j;
        const float l = w.lx[j];
        const int nf = cp.Nf[o], nb = cp.Nb[o];
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
      const float qke = q / cp.Ke[k];
      const float v = w.V[k];
      const float f = w.Fe[k];
      const bool fwd = v > 0.f;
      bool low = fwd ? qke < LOWER : qke > UPPER;
      if (fwd && f == 1.f) low = false;
      bool high = fwd ? qke > UPPER : qke < LOWER;
      if (!fwd && f == 0.f) high = false;
      any_adj |= (low || high) && fabsf(v) > IMPACT;
      if (lane == 0) w.flags[k] = (low ? 1 : 0) | (high ? 2 : 0);
    }
    // the tile's early-stop vote; a barrier for all 8 warps
    if (!__syncthreads_or(any_adj)) break;
    const float inc = incs[it];
    for (int k = lane; k < p; k += WARP) {
      float f = w.Fe[k];
      if (w.flags[k] & 2) f -= inc;
      if (w.flags[k] & 1) f += inc;
      w.Fe[k] = clip_nan(f, 0.f, 1.f);
    }
    __syncwarp();
    for (int j = lane; j < s; j += WARP) {
      float acc = 0.f;
      for (int k = 0; k < p; ++k)
        acc += (float)cp.N[(int64_t)k * s + j] * (w.W[k] * w.Fe[k]);
      const float x = w.x0[j] + acc;
      w.x1[j] = x < 0.f ? 0.f : x;
    }
    __syncwarp();
  }
}

// ---- one trim pass (_integrate_part at max(Vmax * trim, 0)) ----
// x0 in, x0 out; reaches the tile's vote, so every thread calls it.
__device__ __forceinline__ void trim_pass(const CellPtrs& cp,
                                          const Scratch& w, int lane, int p,
                                          int s, float trim) {
  velocities(cp, w, lane, p, s,
             [&](int k) { return max0_nan(cp.Vmax[k] * trim); });
  negative_guard(cp, w, lane, p, s);
  signal_update(cp, w, lane, p, s);
  equilibrium_correction(cp, w, lane, p, s);
  for (int j = lane; j < s; j += WARP) w.x0[j] = w.x1[j];
  __syncwarp();
}

// The trim factor of pass 0, 1 or 2 of one integrator step.
__device__ __forceinline__ float trim_factor(int pass) {
  return pass == 0 ? 0.7f : (pass == 1 ? 0.2f : 0.1f);
}

}  // namespace msbody
