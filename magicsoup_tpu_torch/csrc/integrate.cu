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
// integrate_signals_tiled; the two differ only in summation order.
//
// The body -- mapping, scratch layout, numerics -- is the device functions
// of integrate_body.cuh, which the ladder of its sub-expressions
// (bisect.cu) runs too; this kernel composes them.
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
// What bounds it.  Bytes: it must read X and the nine parameter tensors
// once and write X1, q * (16p + 12ps + 8s) bytes (about 233 MB at
// q = 10240, p = 64, s = 28; 70 us at 3.35 TB/s).  This first version
// re-reads each cell's parameter rows from L1/L2 on every reduction (a
// trim pass reads Nf, Nb, A and Kmr once, N three times, and Nb, Nf and N
// again in each correction step).  Keeping a tile's parameters resident
// in shared memory for the whole step -- the Pallas kernel's design on
// the TPU's VMEM -- is the next step for this kernel.
#include "integrate_body.cuh"

using namespace msbody;

namespace {

__global__ void __launch_bounds__(TILE_C * WARP)
integrate_kernel(const float* __restrict__ X, const float* __restrict__ Ke,
                 const float* __restrict__ Kmf, const float* __restrict__ Kmb,
                 const float* __restrict__ Kmr, const float* __restrict__ Vmax,
                 const int16_t* __restrict__ N, const int16_t* __restrict__ Nf,
                 const int16_t* __restrict__ Nb, const int16_t* __restrict__ A,
                 float* __restrict__ out, int c, int p, int s,
                 int64_t pstride) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  const int64_t row = (int64_t)blockIdx.x * TILE_C + warp;
  const int64_t cell = (int64_t)blockIdx.y * c + row;  // X / out row
  const int64_t prow = (int64_t)blockIdx.y * pstride + row;  // params row
  const Scratch w = warp_scratch(smem, warp, p, s);
  const CellPtrs cp = cell_ptrs(Ke, Kmf, Kmb, Kmr, Vmax, N, Nf, Nb, A, prow, p, s);

  // offset once: with the row index live across the body, ptxas spills
  // 24 bytes at the 64 registers it allots
  X += cell * s;
  out += cell * s;
  for (int j = lane; j < s; j += WARP) w.x0[j] = X[j];
  for (int pass = 0; pass < 3; ++pass) trim_pass(cp, w, lane, p, s, trim_factor(pass));
  for (int j = lane; j < s; j += WARP) out[j] = w.x0[j];
}

}  // namespace

extern "C" {

int ms_tile_c() { return TILE_C; }

size_t ms_integrate_smem_bytes(int p, int s) { return smem_bytes(p, s); }

// X/out (B, c, s) f32, contiguous.  Per world, pstride rows of
// Ke/Kmf/Kmb/Vmax (p) f32, Kmr (p, s) f32 and N/Nf/Nb/A (p, s) i16, rows
// row-major; the first c rows of each world are read.  c % TILE_C == 0,
// B <= 65535.  Launches on `stream` without synchronizing; returns
// cudaGetLastError().
int ms_integrate_signals(const float* X, const float* Ke, const float* Kmf,
                         const float* Kmb, const float* Kmr, const float* Vmax,
                         const int16_t* N, const int16_t* Nf, const int16_t* Nb,
                         const int16_t* A, float* out, int B, int c, int p,
                         int s, long long pstride, void* stream) {
  const size_t smem = smem_bytes(p, s);
  cudaError_t err = cudaFuncSetAttribute(
      integrate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (c == 0 || B == 0) return (int)cudaSuccess;
  const dim3 grid(c / TILE_C, B);
  integrate_kernel<<<grid, TILE_C * WARP, smem, (cudaStream_t)stream>>>(
      X, Ke, Kmf, Kmb, Kmr, Vmax, N, Nf, Nb, A, out, c, p, s,
      (int64_t)pstride);
  return (int)cudaGetLastError();
}

const char* ms_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
