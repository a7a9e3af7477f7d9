// Cell-parameter assembly as a CUDA kernel for Hopper (sm_90a): one launch
// computes the nine CellParams rows of a batch of cells from their dense
// domain tokens and writes them into the state tensors in place.
//
// Replaces no TPU kernel: the JAX package runs this as an XLA program
// (magicsoup_tpu/ops/params.py, compute_cell_params and the row scatter
// around it).  Its plain version is magicsoup_tpu_torch/ops/params.py::
// assemble_rows: compute_cell_params at the batch's own (p, d) rung, the
// zero-token fill values for the protein slots beyond it, then nine
// index_put_ scatters.  Eager PyTorch runs that as about 470 launches of
// small kernels per call, whatever the number of rows (the deterministic
// primitives of ops/detmath.py are each a chain of elementwise ops), and
// the host's time to launch them was half of a serial World step.
//
// Numerics.  The kernel is that plain version operation for operation, so
// its bits are the plain version's on the card:
//   - the table gathers, with the index of a domain of the wrong type
//     zeroed (the empty row 0: NaN or 0);
//   - nanmean over domains: a float64 halves tree over the domains padded
//     with zeros to a power of two (detmath.sum_axis), the count, and
//     det_div; an all-NaN slice gives 0;
//   - A, N, Nf, Nb as int32 products summed in int64, narrowed to int16
//     with saturation at the end;
//   - Kmr = ipow(nanmean of the effector-split regulatory Km, A): masked
//     square-and-multiply over 7 bits, saturating at |A| >= 128, and
//     det_div(1, r) for a negative A;
//   - E as a float64 halves tree over the signals padded to a power of
//     two; Ke = clamp(det_exp(det_div(det_div(-E, T), R)), EPS, MAX);
//   - the Kmf/Kmb split around Ke >= 1.
// det_div is the float64 Newton reciprocal (four steps of r * (2 - m*r))
// with the hardware division for a zero, subnormal or non-finite divisor;
// det_exp the float64 Horner polynomial of 2^f scaled by an assembled 2^k.
// Eager PyTorch rounds each of those products and sums on its own, so the
// library is built with --fmad=false and the float64 steps are written
// with the _rn intrinsics, which the compiler never contracts.  Clamps and
// selects keep torch.clamp's and torch.where's NaN semantics (fminf and
// fmaxf would drop a NaN); torch.round is rint (half to even).
//
// Mapping.  One warp per (row, protein slot), 8 warps a CTA.  Lanes run
// over signals, in chunks of 32 for s > 32; each lane walks the protein's
// domains for its signal, and every lane computes the per-protein scalars
// (Vmax, Kmn and the tail after E) itself, so no lane waits on another but
// for E.  A halves tree over n elements padded to 2^L is fed one element
// at a time in bit-reversed order and combined as a binary counter
// (TreeSum), which is the same tree.  E's tree over the signals is that
// within a lane's chunks, then __shfl_down_sync by 16, 8, 4, 2, 1: lane i
// gets x[i] + x[i + h], tree_reduce's halves.  Slots j >= p_r (the rung's
// width) take the zero-token fill: an all-zero protein of one domain, as
// the plain version's fill batch of shape (1, 1, 1, 5).
//
// What bounds it.  The bytes it writes: 16 + 12 s bytes per protein slot
// of every row (352 at s 28; 45 KB a row at P 128), against 10 d bytes of
// tokens read per slot of the rung.  The table gathers hit L1 and L2 (the
// tables are read by every warp), and the float64 arithmetic of the
// Newton divisions is a few hundred operations per slot, far below the
// card's float64 rate at these sizes.  The rows are independent: no
// atomics, no shared memory.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;
// tree levels a TreeSum holds: pow2-padded sizes up to 2^30
constexpr int MAX_LEVELS = 30;

struct Tables {
  const float* km;
  const float* vmax;
  const int32_t* signs;
  const int32_t* hills;
  const int32_t* reactions;
  const int32_t* transports;
  const int32_t* effectors;
  const float* energies;
  long long n_km, n_vmax, n_signs, n_hills, n_react, n_trnsp, n_eff;
};

struct Rows {
  float* Ke;
  float* Kmf;
  float* Kmb;
  float* Kmr;
  float* Vmax;
  int16_t* N;
  int16_t* Nf;
  int16_t* Nb;
  int16_t* A;
};

struct Dom {
  int t, i0, i1, i2, i3;
};

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// torch.clamp on a float: NaN stays NaN
__device__ __forceinline__ float clamp_f(float x, float lo, float hi) {
  if (isnan(x)) return x;
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

// torch.clamp(x, -32768, 32767).to(int16)
__device__ __forceinline__ int16_t narrow(long long x) {
  return (int16_t)(x < -32768 ? -32768 : (x > 32767 ? 32767 : x));
}

// A table row for token t: negative tokens count from the end as a
// PyTorch index does.  A token outside the table traps, as the plain
// version's index check stops it on the card.
__device__ __forceinline__ long long row_of(long long t, long long n) {
  if (t < 0) t += n;
  if (t < 0 || t >= n) __trap();
  return t;
}

// log2 of detmath._pad_pow2's size for n elements
__device__ __forceinline__ int pad_levels(int n) {
  return n > 1 ? 32 - __clz(n - 1) : 0;
}

// element m of the bit-reversed feed of a 2^L-element tree
__device__ __forceinline__ int feed_index(unsigned m, int L) {
  return L ? (int)(__brev(m) >> (32 - L)) : 0;
}

// detmath.det_div: a / b through the float64 Newton reciprocal
__device__ float det_div(float a, float b) {
  const float bn = fabsf(b);
  const int bits = __float_as_int(bn);
  const int e = (bits >> 23) - 127;
  const float m = __int_as_float((bits & 0x007FFFFF) | 0x3F800000);
  const float seed = __int_as_float(0x7EF311C3 - __float_as_int(m));
  const double m64 = (double)m;
  double r = (double)seed;
  for (int i = 0; i < 4; ++i) r = __dmul_rn(r, __dsub_rn(2.0, __dmul_rn(m64, r)));
  const double scale =
      __longlong_as_double((long long)((unsigned long long)(1023LL - e) << 52));
  float q = __double2float_rn(__dmul_rn((double)a, __dmul_rn(r, scale)));
  q = signbit(b) ? -q : q;
  const bool ok = bn >= 1.17549435e-38f && isfinite(bn);
  return ok ? q : __fdiv_rn(a, b);
}

// detmath.det_exp
__device__ float det_exp(float x) {
  const double y = __dmul_rn((double)x, 1.4426950408889634);
  const double k = rint(y);
  const double f = __dsub_rn(y, k);
  double p = 1.525273380405984e-5;
  p = __dadd_rn(__dmul_rn(p, f), 1.5403530393381606e-4);
  p = __dadd_rn(__dmul_rn(p, f), 1.3333558146428441e-3);
  p = __dadd_rn(__dmul_rn(p, f), 9.618129107628477e-3);
  p = __dadd_rn(__dmul_rn(p, f), 5.550410866482158e-2);
  p = __dadd_rn(__dmul_rn(p, f), 2.402265069591007e-1);
  p = __dadd_rn(__dmul_rn(p, f), 6.931471805599453e-1);
  p = __dadd_rn(__dmul_rn(p, f), 1.0);
  float k32 = __double2float_rn(k);
  if (isnan(k32)) k32 = 0.0f;
  k32 = clamp_f(k32, -1022.0f, 1023.0f);
  const long long ki = (long long)k32;
  const double scale = __longlong_as_double((ki + 1023) << 52);
  float out = __double2float_rn(__dmul_rn(p, scale));
  if (x == inf_f()) out = inf_f();
  if (x == -inf_f()) out = 0.0f;
  return out;
}

// detmath.ipow: x ** n by masked square-and-multiply over 7 bits
__device__ float ipow(float x, int n) {
  const int absn = n < 0 ? (int)(0u - (unsigned)n) : n;
  float r = 1.0f;
  float xp = x;
  for (int bit = 0; bit < 7; ++bit) {
    if ((absn >> bit) & 1) r = __fmul_rn(r, xp);
    if (bit < 6) xp = __fmul_rn(xp, xp);
  }
  if (absn >= 128) r = x > 1.0f ? inf_f() : (x == 1.0f ? 1.0f : 0.0f);
  return n < 0 ? det_div(1.0f, r) : r;
}

// params._nanmean0's tail: the tree's float64 total and the count
__device__ __forceinline__ float nanmean(double total, int count) {
  const float mean =
      det_div(__double2float_rn(total), (float)(count > 1 ? count : 1));
  return count > 0 ? mean : 0.0f;
}

// A float64 halves tree (detmath.tree_reduce with add) over 2^L elements,
// fed element m = 0, 1, ... of the bit-reversed order: adjacent pairs of
// the feed combine as a binary counter; after 2^L pushes the sum is st[L].
struct TreeSum {
  double st[MAX_LEVELS + 1];
  __device__ __forceinline__ void push(unsigned m, double v) {
    int lvl = 0;
    while (m & 1u) {
      v = __dadd_rn(st[lvl], v);
      m >>= 1;
      ++lvl;
    }
    st[lvl] = v;
  }
};

__device__ __forceinline__ Dom load_dom(const int16_t* tok, int k) {
  if (tok == nullptr) return Dom{0, 0, 0, 0, 0};
  const int16_t* q = tok + 5 * k;
  return Dom{q[0], q[1], q[2], q[3], q[4]};
}

__global__ void __launch_bounds__(THREADS)
assemble_kernel(const int16_t* __restrict__ dense, const int64_t* __restrict__ rows,
                long long b, int p_r, int d_r, long long C, int P, int s,
                Tables T, Rows out, const float* __restrict__ abs_temp,
                float gas, float eps, float maxv) {
  const long long warp = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= b * P) return;
  const long long r = warp / P;
  const int j = (int)(warp - r * P);
  const long long c = rows[r];
  if (c < 0 || c >= C) __trap();
  const bool in_rung = j < p_r;
  const int d = in_rung ? d_r : 1;
  const int16_t* tok = in_rung ? dense + (r * p_r + j) * (long long)d_r * 5 : nullptr;
  const int Ld = pad_levels(d);
  const unsigned nd = 1u << Ld;

  // per protein: Vmax over catalytic/transporter domains, Kmn over the
  // non-regulatory ones
  TreeSum tv, tk;
  int cv = 0, ck = 0;
  for (unsigned m = 0; m < nd; ++m) {
    const int k = feed_index(m, Ld);
    float xv = 0.0f, xk = 0.0f;
    if (k < d) {
      const Dom D = load_dom(tok, k);
      const bool reg = D.t == 3;
      const long long not_reg = (D.t == 1 || D.t == 2) ? 1 : 0;
      const float v = T.vmax[row_of(D.i0 * not_reg, T.n_vmax)];
      if (!isnan(v)) { xv = v; ++cv; }
      const float km = reg ? nan_f() : T.km[row_of(D.i1, T.n_km)];
      if (!isnan(km)) { xk = km; ++ck; }
    }
    tv.push(m, (double)xv);
    tk.push(m, (double)xk);
  }
  const float Vmax = nanmean(tv.st[Ld], cv);
  const float Kmn = nanmean(tk.st[Ld], ck);

  // per signal, lanes over signals in chunks of 32 taken in the
  // bit-reversed order of E's tree
  const int Ls = pad_levels(s);
  const int Lc = Ls > 5 ? Ls - 5 : 0;
  const long long slot = c * P + j;
  TreeSum te;
  for (unsigned mc = 0; mc < (1u << Lc); ++mc) {
    const int i = feed_index(mc, Lc) * 32 + lane;
    float e = 0.0f;
    if (i < s) {
      long long a_sum = 0, n_sum = 0, nf = 0, nb = 0;
      TreeSum tr;
      int cr = 0;
      for (unsigned m = 0; m < nd; ++m) {
        const int k = feed_index(m, Ld);
        float xr = 0.0f;
        if (k < d) {
          const Dom D = load_dom(tok, k);
          const long long catal = D.t == 1, trnsp = D.t == 2, reg = D.t == 3;
          const int32_t sign = T.signs[row_of(D.i2, T.n_signs)];
          const int32_t hill = T.hills[row_of(D.i0 * reg, T.n_hills)];
          const int32_t eff = T.effectors[row_of(D.i3 * reg, T.n_eff) * s + i];
          const int32_t react = T.reactions[row_of(D.i3 * catal, T.n_react) * s + i];
          const int32_t trn = T.transports[row_of(D.i3 * trnsp, T.n_trnsp) * s + i];
          // int32 products wrap as the plain version's do
          const int32_t sh = (int32_t)((uint32_t)sign * (uint32_t)hill);
          a_sum += (int32_t)((uint32_t)eff * (uint32_t)sh);
          const int32_t nd_i =
              (int32_t)(((uint32_t)react + (uint32_t)trn) * (uint32_t)sign);
          n_sum += nd_i;
          if (nd_i < 0) nf += (int32_t)(0u - (uint32_t)nd_i);
          if (nd_i > 0) nb += nd_i;
          const float kmr_d = reg ? T.km[row_of(D.i1, T.n_km)] : nan_f();
          float x = __fmul_rn((float)eff, kmr_d);
          if (!(x != 0.0f)) x = nan_f();
          if (!isnan(x)) { xr = x; ++cr; }
        }
        tr.push(m, (double)xr);
      }
      const float kmr = ipow(nanmean(tr.st[Ld], cr), (int32_t)a_sum);
      const long long at = slot * s + i;
      out.Kmr[at] = kmr;
      out.N[at] = narrow(n_sum);
      out.Nf[at] = narrow(nf);
      out.Nb[at] = narrow(nb);
      out.A[at] = narrow(a_sum);
      e = __fmul_rn((float)n_sum, T.energies[i]);
    }
    te.push(mc, (double)e);
  }
  double E64 = te.st[Lc];
  for (int h = Ls >= 5 ? 16 : (1 << Ls) >> 1; h >= 1; h >>= 1)
    E64 = __dadd_rn(E64, __shfl_down_sync(FULL, E64, h));
  const float E = __double2float_rn(__shfl_sync(FULL, E64, 0));

  const float Ke = clamp_f(det_exp(det_div(det_div(-E, *abs_temp), gas)), eps, maxv);
  const bool fwd = Ke >= 1.0f;
  const float Kmf = clamp_f(fwd ? Kmn : det_div(Kmn, Ke), eps, maxv);
  const float Kmb = clamp_f(fwd ? __fmul_rn(Kmn, Ke) : Kmn, eps, maxv);
  if (lane == 0) {
    out.Ke[slot] = Ke;
    out.Kmf[slot] = Kmf;
    out.Kmb[slot] = Kmb;
    out.Vmax[slot] = Vmax;
  }
}

}  // namespace

extern "C" {

int ms_assemble_threads() { return THREADS; }

// ptrs: dense (b, p_r, d_r, 5) i16, rows (b,) i64, abs_temp (1,) f32; the
// tables km, vmax (f32), signs, hills (i32), reactions, transports,
// effectors (n, s) i32, energies (s,) f32; the state Ke, Kmf, Kmb (C, P)
// f32, Kmr (C, P, s) f32, Vmax (C, P) f32, N, Nf, Nb, A (C, P, s) i16; all
// contiguous.  dims: b, p_r, d_r, C, P, s, then the rows of km, vmax,
// signs, hills, reactions, transports, effectors.  scalars: the gas
// constant, EPS and MAX as float32.  p_r <= P.  A row outside [0, C) or
// a token outside its table traps.  Launches on `stream` without
// synchronizing; returns cudaGetLastError().
int ms_assemble_rows(const void* const* ptrs, const long long* dims,
                     const float* scalars, void* stream) {
  const long long b = dims[0], C = dims[3];
  const int p_r = (int)dims[1], d_r = (int)dims[2], P = (int)dims[4], s = (int)dims[5];
  if (b < 0 || p_r < 0 || d_r < 0 || p_r > P || s < 1 || s > (1 << 20))
    return (int)cudaErrorInvalidValue;
  for (int k = 6; k < 13; ++k)
    if (dims[k] < 1) return (int)cudaErrorInvalidValue;
  if (b == 0 || P == 0) return (int)cudaSuccess;
  const Tables T{(const float*)ptrs[3],   (const float*)ptrs[4],
                 (const int32_t*)ptrs[5], (const int32_t*)ptrs[6],
                 (const int32_t*)ptrs[7], (const int32_t*)ptrs[8],
                 (const int32_t*)ptrs[9], (const float*)ptrs[10],
                 dims[6], dims[7], dims[8], dims[9], dims[10], dims[11], dims[12]};
  const Rows out{(float*)ptrs[11],   (float*)ptrs[12],   (float*)ptrs[13],
                 (float*)ptrs[14],   (float*)ptrs[15],   (int16_t*)ptrs[16],
                 (int16_t*)ptrs[17], (int16_t*)ptrs[18], (int16_t*)ptrs[19]};
  const long long blocks = (b * P + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  assemble_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int16_t*)ptrs[0], (const int64_t*)ptrs[1], b, p_r, d_r, C, P, s,
      T, out, (const float*)ptrs[2], scalars[0], scalars[1], scalars[2]);
  return (int)cudaGetLastError();
}

const char* ms_assemble_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
