// The reversible Michaelis-Menten signal integrator as a CUDA kernel for
// Hopper (sm_90a).
//
// Replaces the TPU kernel magicsoup_tpu/ops/pallas_integrate.py::
// integrate_signals_pallas, both its solo grid (the Pallas `_kernel`) and
// its batched grid over worlds (`_kernel_batched`): three trim passes
// (Vmax x 0.7, 0.2, 0.1) of the fast-mode integrator body
// (magicsoup_tpu/ops/integrate.py::_integrate_part with det=False and the
// exp-sum-log allosteric factor `_a_reg_logspace`), with the equilibrium
// correction's early stop voted per tile of cells.  Its plain PyTorch
// version is magicsoup_tpu_torch/ops/cuda_integrate.py::
// integrate_signals_tiled; the two differ only in summation order.  The
// kernel keeps its first version's summation orders, so its bits are that
// version's.
//
// The body -- mapping, residency, extent, numerics -- is the device
// functions of integrate_body.cuh, which the ladder of its sub-expressions
// (bisect.cu) runs too; this kernel composes them (run_tile).
//
// Extents.  The protein axis p is the world's longest proteome, rounded up
// to a power of two, and most cells hold a few proteins: at 28 signals and
// p 512 about 2% of the slots are live.  Each warp scans its cell's rows
// from the end for its extent (one past its last slot that is not inert;
// integrate_body.cuh) and walks only the slots below it, so a tile's
// passes cost its widest cell, not p.  The scan reads the padding once
// (the i16 rows as words where they align); a cell whose last slot is
// live reads one row.  The output is the walk over all p slots, bit for
// bit; the staging, the layout, the launch plan and the vote stay those
// of p.  Staging only each cell's slots below its extent was measured
// too: any second staging path, inline or out of line, slowed the full
// tiles of K1's microbenchmark by 4-6%, and staged the padded ones only
// 0-5% faster.
//
// Worlds.  The grid is (c / TILE_C, B): blockIdx.y is the world, and a
// tile never crosses a world, so world w of a batched launch computes
// exactly what a B = 1 launch on its slice computes.  X and the output are
// (B, c, s) and contiguous; each parameter tensor holds B blocks of
// `pstride` rows (pstride >= c), of which the kernel reads the first c, so
// the live-row prefix of every world of a (B, cap, ...) stack runs without
// a copy.  The solo grid is B = 1, pstride = c.
//
// Tiles.  A CTA is one tile of TILE_C = 8 cells (8 warps, 256 threads).
// The early stop of the equilibrium correction is one __syncthreads_or
// over the CTA: in the TPU kernel, as here, its vote runs over exactly one
// tile.  The tile size is therefore observable numerics: cells stop with
// their tile-mates.
//
// What bounds it.  Bytes, at least: it must read X and the nine parameter
// tensors once and write X1, q * (16p + 12ps + 8s) bytes (117.6 MB at the
// workload's q = 10240, p = 32, s = 28; 35 us at 3.35 TB/s).  Its f32
// operations (chip_smoke.py::_bound counts them) take less at 67 TFLOP/s.
// What held the first version of this kernel at 23x that bound was
// neither: the ladder (bisect.cu) put it in the serial per-protein warp
// reductions (a 5-step shuffle chain for every sum over signals, 3 per
// protein in the velocities and 2 in each correction step, each followed
// by a scalar tail on one lane) and in re-reading the parameters from
// L1/L2 on every reduction.  This design does two things about it:
//   1. a cell's proteins run in parallel (lanes over proteins, each lane
//      summing its own row in the butterfly's tree order;
//      integrate_body.cuh), so the tails run 32 at once and no sum is a
//      shuffle chain;
//   2. the tile's parameters are staged into shared memory once per launch
//      and stay resident for the three passes and every correction step.
// At p 32, s 28 a tile takes 102,912 bytes, and the launch bound keeps a
// thread within 128 registers, so 2 CTAs (16 warps) share an SM.  What
// bounds it now is latency: each lane's row is a chain of expf, division
// and logf that 4 warps per scheduler hide only in part.
// Shapes whose tile does not fit leave their least-read groups in device
// memory (the launch plan, ops/cuda_integrate.py::plan).  One CTA per tile
// keeps the vote a __syncthreads_or and one body for every shape; a
// cluster of 8 CTAs, one cell each, would give the largest shapes room
// for all their parameters at the cost of a vote through distributed
// shared memory -- a later step, once those shapes' times are known.
// Tensor cores do not apply: each cell's N is its own small (p, s) matrix
// times one vector, in f32 with exp/log between the products.
#include <vector>

#include "integrate_body.cuh"

using namespace msbody;

namespace {

// One tile, for both entries: this warp's cell's extent (cell_extent),
// the tile's staging (stage_tile), the slot counters, and three trim
// passes over the cell's extent, from its signals X to out.  `slots`,
// when not null, gets the sum of the tile's extents and TILE_C times the
// largest (the slots the tile walks), once per CTA.
template <bool RESIDENT>
__device__ __forceinline__ void run_tile(unsigned char* smem, const Globals& g,
                                         int mask, int64_t prow0, int p,
                                         int s, const float* X, float* out,
                                         unsigned long long* slots) {
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  const int ext = cell_extent(g, prow0 + warp, p, s, lane);
  // the tile's extents, in warp 0's scratch (stage_tile writes none of
  // the scratch), for thread 0 to read after stage_tile's barrier
  int* tile_ext = (int*)smem;
  if (lane == 0) tile_ext[warp] = ext;
  const Layout L = tile_layout(p, s, RESIDENT ? RES_ALL : mask);
  const CellPtrs cp =
      stage_tile<RESIDENT>(smem, L, mask, g, prow0, p, s, warp, lane);
  if (slots != nullptr && threadIdx.x == 0) {
    unsigned long long live = 0;
    int widest = 0;
    for (int i = 0; i < TILE_C; ++i) {
      live += tile_ext[i];
      widest = tile_ext[i] > widest ? tile_ext[i] : widest;
    }
    atomicAdd(slots, live);
    atomicAdd(slots + 1, (unsigned long long)TILE_C * widest);
  }
  __syncwarp();  // warp 0's lanes write over tile_ext next
  const Scratch w = cell_scratch(smem, warp, p, s);
  for (int j = lane; j < s; j += WARP) w.x0[j] = X[j];
  __syncwarp();
  for (int pass = 0; pass < 3; ++pass)
    trim_pass(cp, w, lane, ext, s, trim_factor(pass));
  for (int j = lane; j < s; j += WARP) out[j] = w.x0[j];
}

// RESIDENT: every group in shared memory (mask == RES_ALL), with loads the
// compiler knows to be shared; else the groups of `mask`.  Two CTAs of the
// resident route share an SM at the workload's shape, so it keeps within
// 128 registers; the other routes' tiles fill most of an SM's shared
// memory, and at 2 CTAs' budget their generic loads spilled.
template <bool RESIDENT>
__global__ void __launch_bounds__(THREADS, RESIDENT ? 2 : 1)
integrate_kernel(const float* __restrict__ X, const float* __restrict__ Ke,
                 const float* __restrict__ Kmf, const float* __restrict__ Kmb,
                 const float* __restrict__ Kmr, const float* __restrict__ Vmax,
                 const int16_t* __restrict__ N, const int16_t* __restrict__ Nf,
                 const int16_t* __restrict__ Nb, const int16_t* __restrict__ A,
                 float* __restrict__ out, int c, int p, int s,
                 int64_t pstride, int mask, unsigned long long* slots) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Globals g{Ke, Kmf, Kmb, Kmr, Vmax, N, Nf, Nb, A};
  const int64_t row0 = (int64_t)blockIdx.x * TILE_C;
  // offset once: with the row index live across the body, ptxas spilled
  // at the first version's register budget
  const int64_t cell =
      (int64_t)blockIdx.y * c + row0 + threadIdx.x / WARP;  // X row
  run_tile<RESIDENT>(smem, g, mask, (int64_t)blockIdx.y * pstride + row0, p,
                     s, X + cell * s, out + cell * s, slots);
}

template <bool RESIDENT>
cudaError_t allow_smem(size_t bytes) {
  return allow_kernel_smem<integrate_kernel<RESIDENT>>(bytes);
}

// ---- the grouped launch: the tiles of several groups of worlds ----
// A fused fleet step runs the integrator for several rung groups at once,
// each with its own worlds, rows, proteins, signals and world stride.  One
// launch takes up to MAX_GROUPS of them: the grid is flattened over every
// tile of every world of every group, and a CTA finds its group by the
// groups' first tiles (a prefix of their tile counts).  Past that lookup it
// runs integrate_kernel's tile (run_tile) on its group's pointers, so each world of a
// group computes exactly what the group's own launch computes: the same
// device functions, the same tile and vote, the same build flags.
constexpr int MAX_GROUPS = 16;

struct Group {
  const float* X;
  const float* Ke;
  const float* Kmf;
  const float* Kmb;
  const float* Kmr;
  const float* Vmax;
  const int16_t* N;
  const int16_t* Nf;
  const int16_t* Nb;
  const int16_t* A;
  float* out;
  int64_t pstride;     // parameter rows per world
  int64_t first_tile;  // the group's first CTA in the launch
  int c, p, s, mask;
};

// Travels as one __grid_constant__ kernel parameter: no copy to the
// device per launch, so the enqueue stays free of synchronization.
struct GroupTable {
  Group g[MAX_GROUPS];
  unsigned long long* slots;  // run_tile's counters, or null
  int n;
};

// One route per launch: RESIDENT as in integrate_kernel (every group's
// mask is RES_ALL), else each group's own mask.
template <bool RESIDENT>
__global__ void __launch_bounds__(THREADS, RESIDENT ? 2 : 1)
integrate_grouped_kernel(const __grid_constant__ GroupTable table) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t bid = blockIdx.x;
  int gi = 0;
  while (gi + 1 < table.n && table.g[gi + 1].first_tile <= bid) ++gi;
  const Group& G = table.g[gi];
  const int p = G.p, s = G.s;
  const int64_t tiles = G.c / TILE_C;  // per world
  const int64_t t = bid - G.first_tile;
  const int64_t world = t / tiles;
  const Globals g{G.Ke, G.Kmf, G.Kmb, G.Kmr, G.Vmax, G.N, G.Nf, G.Nb, G.A};
  const int64_t row0 = (t - world * tiles) * TILE_C;
  const int64_t cell = world * G.c + row0 + threadIdx.x / WARP;  // X row
  run_tile<RESIDENT>(smem, g, G.mask, world * G.pstride + row0, p, s,
                     G.X + cell * s, G.out + cell * s, table.slots);
}

template <bool RESIDENT>
cudaError_t allow_grouped_smem(size_t bytes) {
  return allow_kernel_smem<integrate_grouped_kernel<RESIDENT>>(bytes);
}

// Launch the groups `idx[0..n)` of one route, MAX_GROUPS at a time;
// adds the launches to *launched.  Dynamic shared memory is the largest
// group's layout: a smaller group's CTAs pay its occupancy.
template <bool RESIDENT>
cudaError_t launch_route(const Group* groups, const int* B, const int* idx,
                         int n, unsigned long long* slots, cudaStream_t st,
                         int* launched) {
  for (int lo = 0; lo < n; lo += MAX_GROUPS) {
    GroupTable table;
    table.slots = slots;
    table.n = n - lo < MAX_GROUPS ? n - lo : MAX_GROUPS;
    int64_t tiles = 0;
    size_t smem = 0;
    for (int i = 0; i < table.n; ++i) {
      const int k = idx[lo + i];
      table.g[i] = groups[k];
      table.g[i].first_tile = tiles;
      tiles += (int64_t)B[k] * (groups[k].c / TILE_C);
      const size_t b = tile_layout(groups[k].p, groups[k].s,
                                   RESIDENT ? RES_ALL : groups[k].mask).bytes;
      if (b > smem) smem = b;
    }
    if (tiles > 2147483647LL) return cudaErrorInvalidValue;  // grid x limit
    cudaError_t err = allow_grouped_smem<RESIDENT>(smem);
    if (err != cudaSuccess) return err;
    integrate_grouped_kernel<RESIDENT><<<(unsigned)tiles, THREADS, smem, st>>>(
        table);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

int ms_tile_c() { return TILE_C; }

// The dynamic shared memory of one CTA for (p, s) with the groups of
// `mask` resident (RES_* of integrate_body.cuh).
size_t ms_integrate_smem_bytes(int p, int s, int mask) {
  return tile_layout(p, s, mask).bytes;
}

// X/out (B, c, s) f32, contiguous.  Per world, pstride rows of
// Ke/Kmf/Kmb/Vmax (p) f32, Kmr (p, s) f32 and N/Nf/Nb/A (p, s) i16, rows
// row-major; the first c rows of each world are read.  c % TILE_C == 0,
// B <= 65535; `mask` the resident groups, whose layout must fit the
// card's shared memory.  `slots` (2 counters in device memory, or null)
// gets the launch's sum of the cells' protein extents and of the slots
// its tiles walk (TILE_C x each tile's largest extent).  Launches on
// `stream` without synchronizing; returns cudaGetLastError().
int ms_integrate_signals(const float* X, const float* Ke, const float* Kmf,
                         const float* Kmb, const float* Kmr, const float* Vmax,
                         const int16_t* N, const int16_t* Nf, const int16_t* Nb,
                         const int16_t* A, float* out, int B, int c, int p,
                         int s, long long pstride, int mask,
                         unsigned long long* slots, void* stream) {
  if (mask < 0 || mask > RES_ALL) return (int)cudaErrorInvalidValue;
  if (c == 0 || B == 0) return (int)cudaSuccess;
  const size_t smem = tile_layout(p, s, mask).bytes;
  const bool resident = mask == RES_ALL;
  cudaError_t err = resident ? allow_smem<true>(smem) : allow_smem<false>(smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(c / TILE_C, B);
  const cudaStream_t st = (cudaStream_t)stream;
  if (resident)
    integrate_kernel<true><<<grid, THREADS, smem, st>>>(
        X, Ke, Kmf, Kmb, Kmr, Vmax, N, Nf, Nb, A, out, c, p, s,
        (int64_t)pstride, mask, slots);
  else
    integrate_kernel<false><<<grid, THREADS, smem, st>>>(
        X, Ke, Kmf, Kmb, Kmr, Vmax, N, Nf, Nb, A, out, c, p, s,
        (int64_t)pstride, mask, slots);
  return (int)cudaGetLastError();
}

// The grouped launch: n groups, group k with ptrs[11k .. 11k+11) = X, Ke,
// Kmf, Kmb, Kmr, Vmax, N, Nf, Nb, A, out (as ms_integrate_signals takes
// them) and dims[5k .. 5k+5) = B, c, p, s, mask, pstrides[k] its world
// stride in parameter rows; `slots` as ms_integrate_signals takes it, for
// every group.  Each group runs exactly what its own
// ms_integrate_signals call runs.  The resident groups (mask RES_ALL) go
// into one launch and the others into another, MAX_GROUPS per launch;
// *launched gets the number of launches.  Groups with no rows or no
// worlds launch nothing.  Returns cudaGetLastError() of the last launch.
int ms_integrate_signals_grouped(int n, const void* const* ptrs,
                                 const int* dims, const long long* pstrides,
                                 unsigned long long* slots, int* launched,
                                 void* stream) {
  *launched = 0;
  if (n < 0) return (int)cudaErrorInvalidValue;
  std::vector<Group> groups(n > 0 ? n : 1);
  std::vector<int> B(n > 0 ? n : 1), resident, other;
  for (int k = 0; k < n; ++k) {
    const void* const* q = ptrs + 11 * (size_t)k;
    const int* d = dims + 5 * (size_t)k;
    Group& G = groups[k];
    G.X = (const float*)q[0];
    G.Ke = (const float*)q[1];
    G.Kmf = (const float*)q[2];
    G.Kmb = (const float*)q[3];
    G.Kmr = (const float*)q[4];
    G.Vmax = (const float*)q[5];
    G.N = (const int16_t*)q[6];
    G.Nf = (const int16_t*)q[7];
    G.Nb = (const int16_t*)q[8];
    G.A = (const int16_t*)q[9];
    G.out = (float*)q[10];
    B[k] = d[0];
    G.c = d[1];
    G.p = d[2];
    G.s = d[3];
    G.mask = d[4];
    G.pstride = (int64_t)pstrides[k];
    G.first_tile = 0;
    if (G.mask < 0 || G.mask > RES_ALL || B[k] < 0 || G.c < 0 ||
        G.c % TILE_C != 0)
      return (int)cudaErrorInvalidValue;
    if (B[k] == 0 || G.c == 0) continue;
    (G.mask == RES_ALL ? resident : other).push_back(k);
  }
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = launch_route<true>(groups.data(), B.data(),
                                       resident.data(), (int)resident.size(),
                                       slots, st, launched);
  if (err != cudaSuccess) return (int)err;
  err = launch_route<false>(groups.data(), B.data(), other.data(),
                            (int)other.size(), slots, st, launched);
  return (int)err;
}

int ms_max_groups() { return MAX_GROUPS; }

// CTAs of the grouped kernel that one SM holds with `smem` bytes of
// dynamic shared memory, on the resident route or the other.
int ms_grouped_ctas_per_sm(int resident, size_t smem, int* ctas) {
  cudaError_t err =
      resident ? allow_grouped_smem<true>(smem) : allow_grouped_smem<false>(smem);
  if (err != cudaSuccess) return (int)err;
  return resident ? (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        ctas, integrate_grouped_kernel<true>, THREADS, smem)
                  : (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        ctas, integrate_grouped_kernel<false>, THREADS, smem);
}

const char* ms_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
