// The body of the reversible Michaelis-Menten signal integrator as device
// functions, shared by the integrator kernel (integrate.cu, K1/K2) and the
// ladder of its sub-expressions (bisect.cu, K3's rungs 1-11), so that a
// ladder rung runs the production skeleton and code, not a copy of them.
//
// Mapping.  A CTA is one tile of TILE_C = 8 cells, one warp per cell.
// Within a cell, each sum takes the lanes over the axis it keeps:
//   - sums over signals, one per protein (the log-space products, the
//     allosteric sum, the negative guard's min, the quotient), put the
//     lanes over the proteins (lane k owns proteins k, k + 32, ...), each
//     lane running its protein's row alone, in a fixed tree order
//     (tree_sum);
//   - sums over proteins, one per signal (the removed amounts, the signal
//     update, the correction's update), put the lanes over the signals
//     and run serially over the proteins, reading the per-protein vector
//     from shared memory.
// So no sum is a shuffle chain, every lane of a warp does its own
// protein's tail (three expf, three divisions) at once, and a branch on a
// per-protein value is per lane.  Every sum keeps the first version's
// order (its butterflies, its serial loops over proteins), so the kernel
// computes that version's bits.  The equilibrium correction's early stop
// stays one CTA-wide __syncthreads_or, the tile's vote.  Phases that hand
// a per-cell vector from one lane mapping to the other meet at a
// __syncwarp.
//
// Residency.  stage_tile copies the tile's parameters into dynamic shared
// memory once per launch, so the three trim passes and every correction
// step read them there.  Which groups are resident is the launch plan's
// mask (RES_*; chosen by ops/cuda_integrate.py::plan, which greedily
// stages the groups in the order of how often the body reads them); a
// group that does not fit stays in device memory and is read through L1,
// as the first version of this kernel read everything.  tile_layout gives
// the byte layout for (p, s, mask); with no group resident it is exactly
// the first version's scratch, so every shape that version took still
// runs.  Resident (p, s) rows are padded to a stride whose word stride is
// odd (ld16, ld32): a lane-over-protein read of one column then hits 32
// distinct banks, and a lane-over-signal read of one row is contiguous.
// The copy is plain loads and stores, 8 rows in flight per lane: the
// padded destination is not contiguous, and an unpadded one (which one
// cp.async.bulk per tensor could fill) costs 2-way bank conflicts at
// s = 28 and up to 32-way at s a multiple of 64.
//
// Extent.  A cell's proteins sit at the front of its p slots, and the
// protein axis p follows the longest proteome of the world, so most slots
// of most cells are padding.  A slot k is inert when its N, Nf and Nb rows
// are zero, its Vmax is finite, and no entry with A != 0 meets a negative
// Kmr.  Then kf = kb = 0, so a_cat = (0 - 0) / 1 = +0; the allosteric
// factor is finite (each r = xa / (xa + Kmr) is NaN, which counts as 1,
// or lies in [0, 1], so the regulation sum is finite and <= 0); and
// max(Vmax * trim, 0) is finite: V = +-0, so W = WF = +-0.  Every term the
// slot adds to a serial sum over proteins (the guard's removed amounts,
// the update, each correction step) is +-0, and those sums start at +0,
// which adding +-0 never turns into -0: so adding the term changes no bit.
// Its |V| > IMPACT is false, so it casts no vote, and its flags and Fe
// are read by no one else.  An A-only slot (a protein with only regulatory
// domains) is inert; a non-finite Vmax (V = 0 * Inf = NaN) or a negative
// Kmr under A != 0 (r can be +Inf, 0 * Inf again) is not.  cell_extent
// gives one past a cell's last slot that is not inert, from the kernel's
// own inputs, and the body's protein loops stop there: the output is the
// walk over all p slots, bit for bit.  Dead rows (all zero) have extent 0.
//
// Numerics.  expf/logf (not the __expf intrinsics), IEEE division, built
// without --use_fast_math and with --fmad=false, so no multiply is fused
// into the following add as PyTorch's eager ops never do.  i16 parameters
// are widened to f32 exactly (i2f).  jnp.min and jnp.clip propagate NaN,
// fminf/fmaxf drop it: the helpers below keep the JAX semantics.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <mutex>

namespace msbody {

constexpr int TILE_C = 8;
constexpr int WARP = 32;
constexpr int THREADS = TILE_C * WARP;

constexpr float EPS_F = 1e-36f;
constexpr float MAX_F = 1e36f;
constexpr float MIN_F = -1e36f;
constexpr float LOG0 = -1e12f;
constexpr float UPPER = 1.5f;
constexpr float LOWER = (float)(1.0 / 1.5);
constexpr float IMPACT = 0.1f;

// The launch plan's groups, one bit each, in the order the plan stages
// them: N (the guard, the update and every correction step read it), Nf
// and Nb (the velocities and every quotient), A (the velocities), Kmr
// (the velocities, where A != 0), and the (p,) rows Ke, Kmf, Kmb, Vmax.
enum : int {
  RES_N = 1,
  RES_NF = 2,
  RES_NB = 4,
  RES_A = 8,
  RES_KMR = 16,
  RES_VEC = 32,
  RES_ALL = 63,
};

// Byte layout of one tile's dynamic shared memory.  Per cell the scratch
// holds 4 signal vectors (x0, x1, lx, fneg) and 4 protein vectors (V, W,
// Fe, flags/WF); after it come the resident groups.
struct Layout {
  int ld16, ld32;     // padded row strides of resident i16 / f32 rows
  size_t vec, kmr;    // byte offsets of the (p,) rows and of Kmr
  size_t i16[4];      // byte offsets of N, Nf, Nb, A
  size_t bytes;       // the total
};

__host__ __device__ inline Layout tile_layout(int p, int s, int mask) {
  Layout L;
  L.ld16 = s + ((2 - s % 4) + 4) % 4;  // ld16 % 4 == 2: odd word stride
  L.ld32 = s | 1;                      // odd word stride
  size_t off = (size_t)TILE_C * (4 * (size_t)s + 4 * (size_t)p) * 4;
  L.vec = off;
  if (mask & RES_VEC) off += (size_t)4 * TILE_C * p * 4;
  L.kmr = off;
  if (mask & RES_KMR) off += (size_t)TILE_C * p * L.ld32 * 4;
  for (int i = 0; i < 4; ++i) {
    L.i16[i] = off;
    if (mask & (1 << i)) off += (size_t)TILE_C * p * L.ld16 * 2;
  }
  L.bytes = off;
  return L;
}

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

// (float)v for |v| < 2^22, exactly, on the full-rate add pipes: the
// integer-to-float conversion unit runs at a quarter of their rate, and
// the body widens up to three i16 per element and pass
__device__ __forceinline__ float i2f(int v) {
  return __int_as_float(0x4B400000 + v) - 12582912.0f;
}

// prod_s(X^N) from its log-space sum, as _prod_pow + the protein mask and
// Inf scrub of _velocities/_quotient
__device__ __forceinline__ float prod_from_log(float e, bool involved) {
  const float xx = inf_to_max(expf(e));
  return involved ? xx : 0.f;
}

// The sum over signals of one protein's row, evaluated by one lane in the
// order of a warp butterfly: leaf l (l < 32) is the serial sum of terms
// l, l + 32, ...; the leaves combine at offsets 16, 8, 4, 2, 1 as
// __shfl_xor_sync did in the first version of this kernel.  The plain
// version's reductions on the card (ATen's warp reduce) take that order
// too, and a left-to-right order was measured further from them on real
// state.  Leaves past s are +0, as the idle lanes' were; a leaf starts at
// its first term, where each lane started at +0, which can change only
// the sign of a zero sum, and every sum here goes to expf.  The tree is
// walked as a loop over its 8 nodes at offset 8, (l + l+16) + (l+8 + l+24)
// for l = 0, 4, 2, 6, 1, 5, 3, 7 (bit-reversed), each pair of
// neighbours added as a binary counter carries: so 4 terms are in flight
// at a time, where unrolling all 32 spilled registers.  term(j) gives an
// Acc; Acc{} is zero, and Acc has += and +.
template <class Acc, class Term>
__device__ __forceinline__ Acc tree_sum(int s, Term term) {
  auto leaf = [&](int l) {
    if (l >= s) return Acc{};
    Acc a = term(l);
    for (int j = l + WARP; j < s; j += WARP) a += term(j);
    return a;
  };
  Acc st0{}, st1{}, st2{}, total{};
#pragma unroll 1
  for (int m = 0; m < 8; ++m) {
    const int l = ((m & 1) << 2) | (m & 2) | ((m >> 2) & 1);
    Acc x = (leaf(l) + leaf(l + 16)) + (leaf(l + 8) + leaf(l + 24));
    if (!(m & 1)) {
      st0 = x;
      continue;
    }
    x = st0 + x;  // offset 4
    if (!(m & 2)) {
      st1 = x;
      continue;
    }
    x = st1 + x;  // offset 2
    if (!(m & 4)) {
      st2 = x;
      continue;
    }
    total = st2 + x;  // offset 1
  }
  return total;
}

// The log-space sums of one protein's row: sum_s Nf log X, sum_s Nb log X,
// whether any Nf / Nb > 0, and (velocities) the regulation sum.
struct RowSums {
  float sf, sb, sr;
  bool anyf, anyb;
  __device__ __forceinline__ RowSums& operator+=(const RowSums& o) {
    sf += o.sf;
    sb += o.sb;
    sr += o.sr;
    anyf |= o.anyf;
    anyb |= o.anyb;
    return *this;
  }
  __device__ __forceinline__ RowSums operator+(const RowSums& o) const {
    RowSums r = *this;
    return r += o;
  }
};

// The integrator's operands in device memory: X/out (B, c, s); per world
// `pstride` rows of Ke/Kmf/Kmb/Vmax (p) f32, Kmr (p, s) f32 and
// N/Nf/Nb/A (p, s) i16.
struct Globals {
  const float *Ke, *Kmf, *Kmb, *Kmr, *Vmax;
  const int16_t *N, *Nf, *Nb, *A;
};

// One cell's parameter rows, in shared or device memory; a (p, s) tensor's
// row k starts at k * ld.
struct CellPtrs {
  const float *Ke, *Kmf, *Kmb, *Vmax;  // (p,)
  const float* Kmr;
  const int16_t *N, *Nf, *Nb, *A;
  int ld_kmr, ld_n, ld_nf, ld_nb, ld_a;
};

// One warp's scratch: 4 signal vectors and 4 protein vectors.  The flag
// vector holds each protein's low/high flags from its quotient to the
// tile's vote, then W * Fe for the update (WF; same slot, same lane).
struct Scratch {
  float *x0, *x1, *lx, *fneg;  // (s,)
  float *V, *W, *Fe;           // (p,)
  int* flags;                  // (p,)
  float* WF;                   // == flags
};

__device__ __forceinline__ Scratch cell_scratch(unsigned char* smem, int warp,
                                                int p, int s) {
  Scratch w;
  w.x0 = (float*)smem + (size_t)warp * (4 * s + 4 * p);
  w.x1 = w.x0 + s;
  w.lx = w.x1 + s;
  w.fneg = w.lx + s;
  w.V = w.fneg + s;
  w.W = w.V + p;
  w.Fe = w.W + p;
  w.flags = (int*)(w.Fe + p);
  w.WF = w.Fe + p;
  return w;
}

// `rows` rows of s elements, contiguous at src, to dst at row stride ld;
// warp w copies rows w, w + 8, ..., lanes over the row, 8 rows in flight.
template <class T>
__device__ __forceinline__ void stage_rows(T* dst, int ld,
                                           const T* __restrict__ src,
                                           int rows, int s, int warp,
                                           int lane) {
  constexpr int U = 8;
  for (int r0 = warp; r0 < rows; r0 += TILE_C * U) {
    for (int j = lane; j < s; j += WARP) {
      T v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = r0 + u * TILE_C;
        if (r < rows) v[u] = src[(int64_t)r * s + j];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = r0 + u * TILE_C;
        if (r < rows) dst[(size_t)r * ld + j] = v[u];
      }
    }
  }
}

// Stage the groups of `mask` (STAGED when RESIDENT, a constant, so that
// the compiler sees shared-memory pointers; the integrator stages every
// group, a ladder rung the groups it reads) for the tile whose first
// parameter row is prow0; this warp's cell's views.  A group outside the
// mask is not read here, and a null (p,) row tensor is not read (the
// ladder's velocity rung passes no Ke).  Ends in __syncthreads, so every
// thread of the CTA calls it.
template <bool RESIDENT, int STAGED = RES_ALL>
__device__ __forceinline__ CellPtrs stage_tile(unsigned char* smem,
                                               const Layout& L, int mask,
                                               const Globals& g,
                                               int64_t prow0, int p, int s,
                                               int warp, int lane) {
  const int m = RESIDENT ? STAGED : mask;
  const int rows = TILE_C * p;  // the tile's (p, s) rows, contiguous
  const int64_t ps = (int64_t)p * s;
  const int64_t prow = prow0 + warp;
  CellPtrs cp;

  const float* gvec[4] = {g.Ke, g.Kmf, g.Kmb, g.Vmax};
  const float* vec[4];
  for (int i = 0; i < 4; ++i) {
    if (m & RES_VEC) {
      float* dst = (float*)(smem + L.vec) + (size_t)i * rows;
      if (gvec[i] != nullptr) {
        const float* src = gvec[i] + prow0 * p;
        for (int e = threadIdx.x; e < rows; e += THREADS) dst[e] = src[e];
      }
      vec[i] = dst + (size_t)warp * p;
    } else {
      vec[i] = gvec[i] + prow * p;
    }
  }
  cp.Ke = vec[0];
  cp.Kmf = vec[1];
  cp.Kmb = vec[2];
  cp.Vmax = vec[3];

  if (m & RES_KMR) {
    float* dst = (float*)(smem + L.kmr);
    stage_rows(dst, L.ld32, g.Kmr + prow0 * ps, rows, s, warp, lane);
    cp.Kmr = dst + (size_t)warp * p * L.ld32;
    cp.ld_kmr = L.ld32;
  } else {
    cp.Kmr = g.Kmr + prow * ps;
    cp.ld_kmr = s;
  }

  const int16_t* gi16[4] = {g.N, g.Nf, g.Nb, g.A};
  const int16_t* i16[4];
  int ld[4];
  for (int i = 0; i < 4; ++i) {
    if (m & (1 << i)) {
      int16_t* dst = (int16_t*)(smem + L.i16[i]);
      stage_rows(dst, L.ld16, gi16[i] + prow0 * ps, rows, s, warp, lane);
      i16[i] = dst + (size_t)warp * p * L.ld16;
      ld[i] = L.ld16;
    } else {
      i16[i] = gi16[i] + prow * ps;
      ld[i] = s;
    }
  }
  cp.N = i16[0];
  cp.Nf = i16[1];
  cp.Nb = i16[2];
  cp.A = i16[3];
  cp.ld_n = ld[0];
  cp.ld_nf = ld[1];
  cp.ld_nb = ld[2];
  cp.ld_a = ld[3];
  __syncthreads();
  return cp;
}

// Words of the i16 parameter rows as the extent's scan reads them: two
// entries a word where the cell's rows allow it, else one.
template <class W>
struct Halves;
template <>
struct Halves<int16_t> {
  static constexpr int N = 1;
  static __device__ __forceinline__ int at(int16_t w, int) { return w; }
};
template <>
struct Halves<uint32_t> {
  static constexpr int N = 2;
  static __device__ __forceinline__ int at(uint32_t w, int h) {
    return (int16_t)(h ? w >> 16 : w & 0xFFFF);
  }
};

// One past the last slot of the cell whose parameter row is prow that its
// i16 rows and Kmr make not inert (see Extent above): its (p, s) rows
// scanned in words of W from the end down, first the last row, then 32 x
// 8 words at a time, and stopped at the first chunk that holds such a
// slot.  Kmr is read only for an entry with A != 0 above the last nonzero
// N, Nf or Nb entry, so no load waits on another where a row is live.
// Warp-uniform.
template <class W>
__device__ __forceinline__ int scan_rows(const Globals& g, int64_t prow,
                                         int p, int s, int lane) {
  constexpr int H = Halves<W>::N;
  constexpr int U = 8;
  const int64_t base = prow * p * s;
  const W* N = (const W*)(g.N + base);
  const W* Nf = (const W*)(g.Nf + base);
  const W* Nb = (const W*)(g.Nb + base);
  const W* A = (const W*)(g.A + base);
  const float* kmr = g.Kmr + base;
  int hi = p * s / H;           // words [lo, hi) next
  int chunk = (s + H - 1) / H;  // the last row first
  while (hi > 0) {
    const int lo = hi > chunk ? hi - chunk : 0;
    int xe = 0, ae = 0;  // one past the last entry with N|Nf|Nb, A != 0
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int w = hi - 1 - lane - u * WARP;
      if (w < lo) continue;
      const W x = N[w] | Nf[w] | Nb[w];
      const W a = A[w];
      for (int h = 0; h < H; ++h) {
        const int e = w * H + h + 1;
        if (Halves<W>::at(x, h) != 0 && e > xe) xe = e;
        if (Halves<W>::at(a, h) != 0 && e > ae) ae = e;
      }
    }
    int last = xe > 0 ? (xe - 1) / s + 1 : 0;
    last = __reduce_max_sync(0xFFFFFFFFu, last);
    const int above = last * s;  // entries from here on are past the slots'
    if (__any_sync(0xFFFFFFFFu, ae > above)) {
      int ke = 0;
      for (int e = lo * H + lane; e < hi * H; e += WARP)
        if (e >= above && Halves<W>::at(A[e / H], e % H) != 0 && kmr[e] < 0.f)
          ke = e + 1;
      ke = __reduce_max_sync(0xFFFFFFFFu, ke > 0 ? (ke - 1) / s + 1 : 0);
      last = ke > last ? ke : last;
    }
    if (last > 0) return last;
    hi = lo;
    chunk = U * WARP;
  }
  return 0;
}

// The extent of the cell whose parameter row is prow: one past its last
// slot that is not inert (see Extent above), the same on every lane of
// the warp; 0 for a dead row.  The rows first (two i16 entries a word
// where they align), then Vmax above their extent: a cell whose last slot
// is live reads one row.
__device__ __forceinline__ int cell_extent(const Globals& g, int64_t prow,
                                           int p, int s, int lane) {
  const int64_t base = prow * p * s;
  const uintptr_t addr = (uintptr_t)(g.N + base) | (uintptr_t)(g.Nf + base) |
                         (uintptr_t)(g.Nb + base) | (uintptr_t)(g.A + base);
  const int rows = (p * s) % 2 == 0 && addr % 4 == 0
                       ? scan_rows<uint32_t>(g, prow, p, s, lane)
                       : scan_rows<int16_t>(g, prow, p, s, lane);
  int last = 0;
  const float* vmax = g.Vmax + prow * p;
  for (int k = rows + lane; k < p; k += WARP)
    if (!isfinite(vmax[k])) last = k + 1;
  last = __reduce_max_sync(0xFFFFFFFFu, last);
  return rows > last ? rows : last;
}

// The phases below walk the cell's first `ext` protein slots: its extent
// (cell_extent) in the integrator, p in the ladder.  The slots past it are
// inert, so the walk computes what a walk over all p slots computes.

// ---- velocities (_velocities, mosaic-safe regulation) ----
// V[k] from the signals x0 and the per-protein Vmax that vmax_at(k)
// gives (a trim pass: max(Vmax * trim, 0)).  Lanes over proteins; an
// A == 0 entry adds log(1) = +0 to the regulation sum, so it adds
// nothing.
template <class VmaxAt>
__device__ __forceinline__ void velocities(const CellPtrs& cp,
                                           const Scratch& w, int lane, int ext,
                                           int s, VmaxAt vmax_at) {
  const float log_max = logf(MAX_F);
  for (int j = lane; j < s; j += WARP) w.lx[j] = safe_log(w.x0[j]);
  __syncwarp();
  for (int k = lane; k < ext; k += WARP) {
    const int16_t* nf = cp.Nf + (size_t)k * cp.ld_nf;
    const int16_t* nb = cp.Nb + (size_t)k * cp.ld_nb;
    const int16_t* ar = cp.A + (size_t)k * cp.ld_a;
    const float* kmr = cp.Kmr + (size_t)k * cp.ld_kmr;
    const RowSums t = tree_sum<RowSums>(s, [&](int j) {
      const float l = w.lx[j];
      const int f = nf[j], b = nb[j], a = ar[j];
      RowSums e{i2f(f) * l, i2f(b) * l, 0.f, f > 0, b > 0};
      if (a != 0) {
        const float xa = expf(fminf(i2f(a) * l, log_max));
        float r = xa / (xa + kmr[j]);
        if (isnan(r)) r = 1.f;
        e.sr = r > 0.f ? logf(r) : LOG0;
      }
      return e;
    });
    float kf = prod_from_log(t.sf, true) / cp.Kmf[k];
    kf = inf_to_max(t.anyf ? kf : 0.f);
    float kb = prod_from_log(t.sb, true) / cp.Kmb[k];
    kb = inf_to_max(t.anyb ? kb : 0.f);
    const float a_cat = (kf - kb) / (1.f + kf + kb);
    const float a_reg = expf(t.sr);
    w.V[k] = clip_nan(a_cat * vmax_at(k) * a_reg, MIN_F, MAX_F);
  }
  __syncwarp();
}

// ---- negative guard (_negative_factors): W = V * F_min, Fe = 1 ----
__device__ __forceinline__ void negative_guard(const CellPtrs& cp,
                                               const Scratch& w, int lane,
                                               int ext, int s) {
  for (int j = lane; j < s; j += WARP) {
    float removed = 0.f;
    for (int k = 0; k < ext; ++k)
      removed += max0_nan(-(i2f(cp.N[(size_t)k * cp.ld_n + j]) * w.V[k]));
    const float f = w.x0[j] / removed;
    w.fneg[j] = f > 1.f ? 1.f : f;
  }
  __syncwarp();
  for (int k = lane; k < ext; k += WARP) {
    const int16_t* n = cp.N + (size_t)k * cp.ld_n;
    const float v = w.V[k];
    float m = 1.f;
    for (int j = 0; j < s; ++j) {
      const float nv = i2f(n[j]) * v;
      m = min_nan(m, nv < 0.f ? w.fneg[j] : 1.f);
    }
    w.W[k] = v * m;
    w.Fe[k] = 1.f;
  }
  __syncwarp();
}

// ---- X1 = X0 + sum_p N*W, clamped at 0 (_weighted_dx) ----
__device__ __forceinline__ void signal_update(const CellPtrs& cp,
                                              const Scratch& w, int lane,
                                              int ext, int s) {
  for (int j = lane; j < s; j += WARP) {
    float acc = 0.f;
    for (int k = 0; k < ext; ++k)
      acc += i2f(cp.N[(size_t)k * cp.ld_n + j]) * w.W[k];
    const float x = w.x0[j] + acc;
    w.x1[j] = x < 0.f ? 0.f : x;
  }
}

// ---- equilibrium correction (_equilibrium_adjusted_x) ----
// Its early stop is one __syncthreads_or over the CTA, the tile's vote:
// every thread of the CTA must call this function (lanes without a
// protein and dead cells, whose all-zero parameter rows are inert, take
// part), and the stop is CTA-uniform, so no thread leaves early.
__device__ __forceinline__ void equilibrium_correction(const CellPtrs& cp,
                                                       const Scratch& w,
                                                       int lane, int ext,
                                                       int s) {
  const float incs[4] = {0.5f, 0.25f, 0.125f, 0.0625f};
  for (int it = 0; it < 4; ++it) {
    for (int j = lane; j < s; j += WARP) w.lx[j] = safe_log(w.x1[j]);
    __syncwarp();
    int any_adj = 0;
    for (int k = lane; k < ext; k += WARP) {
      const int16_t* nf = cp.Nf + (size_t)k * cp.ld_nf;
      const int16_t* nb = cp.Nb + (size_t)k * cp.ld_nb;
      const RowSums t = tree_sum<RowSums>(s, [&](int j) {
        const float l = w.lx[j];
        const int f = nf[j], b = nb[j];
        return RowSums{i2f(f) * l, i2f(b) * l, 0.f, f > 0, b > 0};
      });
      const float xx_prod = prod_from_log(t.sb, t.anyb);
      const float xx_subs = prod_from_log(t.sf, t.anyf);
      float q = clip_nan(xx_prod / xx_subs, EPS_F, MAX_F);
      if (isnan(q)) q = 1.f;
      const float qke = q / cp.Ke[k];
      const float v = w.V[k];
      const float fe = w.Fe[k];
      const bool fwd = v > 0.f;
      bool low = fwd ? qke < LOWER : qke > UPPER;
      if (fwd && fe == 1.f) low = false;
      bool high = fwd ? qke > UPPER : qke < LOWER;
      if (!fwd && fe == 0.f) high = false;
      any_adj |= (low || high) && fabsf(v) > IMPACT;
      w.flags[k] = (low ? 1 : 0) | (high ? 2 : 0);
    }
    // the tile's early-stop vote; a barrier for all 8 warps
    if (!__syncthreads_or(any_adj)) break;
    const float inc = incs[it];
    for (int k = lane; k < ext; k += WARP) {
      const int flags = w.flags[k];
      float fe = w.Fe[k];
      if (flags & 2) fe -= inc;
      if (flags & 1) fe += inc;
      fe = clip_nan(fe, 0.f, 1.f);
      w.Fe[k] = fe;
      w.WF[k] = w.W[k] * fe;  // the flags' slot, read by this lane above
    }
    __syncwarp();
    for (int j = lane; j < s; j += WARP) {
      float acc = 0.f;
      for (int k = 0; k < ext; ++k)
        acc += i2f(cp.N[(size_t)k * cp.ld_n + j]) * w.WF[k];
      const float x = w.x0[j] + acc;
      w.x1[j] = x < 0.f ? 0.f : x;
    }
    __syncwarp();
  }
}

// ---- one trim pass (_integrate_part at max(Vmax * trim, 0)) ----
// x0 in, x0 out; reaches the tile's vote, so every thread calls it.
__device__ __forceinline__ void trim_pass(const CellPtrs& cp,
                                          const Scratch& w, int lane, int ext,
                                          int s, float trim) {
  velocities(cp, w, lane, ext, s,
             [&](int k) { return max0_nan(cp.Vmax[k] * trim); });
  negative_guard(cp, w, lane, ext, s);
  signal_update(cp, w, lane, ext, s);
  equilibrium_correction(cp, w, lane, ext, s);
  for (int j = lane; j < s; j += WARP) w.x0[j] = w.x1[j];
  __syncwarp();
}

// cudaFuncSetAttribute once per kernel, device and larger size: the
// attribute is a ceiling, so a launch that needs no more than the last one
// set needs no call.  Host code, for the launchers of integrate.cu and
// bisect.cu.
template <auto Kernel>
cudaError_t allow_kernel_smem(size_t bytes) {
  constexpr int MAX_DEVICES = 64;
  static std::mutex mu;
  static size_t allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (allowed[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) allowed[dev] = bytes;
  return err;
}

// The trim factor of pass 0, 1 or 2 of one integrator step.
__device__ __forceinline__ float trim_factor(int pass) {
  return pass == 0 ? 0.7f : (pass == 1 ? 0.2f : 0.1f);
}

}  // namespace msbody
