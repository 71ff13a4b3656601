// Order-5 B-spline charge spread onto the PME grid (kernel 2 of the PME
// water-box path).
//
// Replaces: openmm_tpu/ops/pme_zslab.py:290 _spread_kernel (pallas_call at
// :427, launched from pme_recip_ef). The Pallas kernel keeps atoms
// z-sorted between neighbour rebuilds and builds each z plane as a matmul
// over that plane's window of atoms, because the TPU has no fast scatter;
// the windows need drift margins, an overflow count and a persisted
// z-order. On Hopper a scatter with atomics is the natural form, so none
// of that state exists here.
//
// Design: parallel over terms, not atoms. One warp spreads one atom:
// lanes 5a + j (a = 0, 1, 2; j < 5) compute axis a's base index and
// weights (bspline5.cuh) and keep weight j and its grid index; the 125
// terms q wx wy wz are then spread in 4 rounds of 32 lanes, term
// s = lane + 32 r taking its three weights and indices by shuffle. Terms
// run along y fastest, the grid's fastest axis in its (nz, nx, ny) layout,
// so neighbouring lanes add into neighbouring cells. 24,000 atoms make
// 24,000 warps: enough to fill the 132 SMs (the one-thread-per-atom
// kernel it replaces ran 6 warps an SM).
//
// Determinism: the terms are added in 64-bit fixed point
// (fixed_scatter.cuh), so the grid has the same bits on every call. The
// scale comes from B = n * max|q| (each atom's 125 weights sum to 1 up to
// float rounding, inside the accumulator's factor-2 margin): at 24,000
// TIP3P atoms B = 2.0e4 and the scale is 2^47. A first small kernel takes
// max|q| on the device, so the host never waits.
//
// Bound on this card: the function needs few bytes (positions, charges and
// the 0.7 MB grid: 0.3 us at 3.35 TB/s) and few operations; what this
// kernel waits on is its 125 64-bit atomics an atom resolving in L2.
#include <cuda_runtime.h>

#include <algorithm>

#include "bspline5.cuh"
#include "fixed_scatter.cuh"

namespace {

using fixed_scatter::kFull;

constexpr int kWarps = 8;  // atoms (warps) per block

// extra[0] = max |q| (as double bits); extra[1] flags a non-finite charge.
__global__ void max_abs_charge_kernel(const float* __restrict__ charge, int n,
                                      unsigned long long* extra) {
  double m = 0.0;
  bool bad = false;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const float q = charge[i];
    bad |= !isfinite(q);
    m = fmax(m, fabs(static_cast<double>(q)));
  }
  for (int o = 16; o > 0; o >>= 1) m = fmax(m, __shfl_xor_sync(kFull, m, o));
  bad = __any_sync(kFull, bad);
  if ((threadIdx.x & 31) == 0) {
    if (bad) {
      atomicOr(extra + 1, 1ull);
    } else {
      fixed_scatter::record_atom(extra, m);
    }
  }
}

__global__ void __launch_bounds__(32 * kWarps)
pme_spread_kernel(const float* __restrict__ pos,
                  const float* __restrict__ charge,
                  const float* __restrict__ binv, int n, int nx, int ny,
                  int nz, unsigned long long* __restrict__ acc) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + threadIdx.x / 32;
  if (i >= n) return;  // the whole warp leaves together
  unsigned long long* extra = acc + static_cast<long>(nx) * ny * nz;
  int e;
  fixed_scatter::scale_exponent(n, extra, &e);
  const double scale = ldexp(1.0, e);

  const float x = pos[3 * i], y = pos[3 * i + 1], z = pos[3 * i + 2];
  const int axis = min(lane / 5, 2);  // lanes 15-31 repeat axis 2, unused
  const int j = lane % 5;
  const int size = axis == 0 ? nx : (axis == 1 ? ny : nz);
  int base;
  float w[5], unused[5];
  grid_axis(x, y, z, binv, axis, size, &base, w, unused);
  float mine = 0.0f;
#pragma unroll
  for (int t = 0; t < 5; ++t) {
    if (t == j) mine = w[t];
  }
  int cell = (base + j - 4) % size;  // weight j's grid index
  if (cell < 0) cell += size;
  const double q = charge[i];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int s = lane + 32 * r;  // (jz, jx, jy), jy fastest
    const int jy = s % 5, line = s / 5;
    const int jx = line % 5, jz = line / 5;
    const float wx = __shfl_sync(kFull, mine, jx);
    const float wy = __shfl_sync(kFull, mine, 5 + jy);
    const float wz = __shfl_sync(kFull, mine, 10 + jz);
    const int gx = __shfl_sync(kFull, cell, jx);
    const int gy = __shfl_sync(kFull, cell, 5 + jy);
    const int gz = __shfl_sync(kFull, cell, 10 + jz);
    if (s < 125) {
      const double term = q * wx * wy * wz;
      fixed_scatter::flag_if_nonfinite(extra, term);
      fixed_scatter::add_term(
          acc, (static_cast<long>(gz) * nx + gx) * ny + gy, term, scale);
    }
  }
}

}  // namespace

// acc: (nx ny nz + 2) int64 scratch; grid: the (nz, nx, ny) float32 output.
extern "C" int omm_pme_spread(const void* pos, const void* charge,
                              const void* binv, int n, int nx, int ny, int nz,
                              void* acc, void* grid, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long count = static_cast<long>(nx) * ny * nz;
  auto* cells = static_cast<unsigned long long*>(acc);
  cudaError_t err = cudaMemsetAsync(
      cells, 0, (count + fixed_scatter::kExtraSlots) * sizeof(*cells), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const int threads = 256;
    const int blocks = std::min((n + threads - 1) / threads, 1024);
    max_abs_charge_kernel<<<blocks, threads, 0, s>>>(
        static_cast<const float*>(charge), n, cells + count);
    pme_spread_kernel<<<(n + kWarps - 1) / kWarps, 32 * kWarps, 0, s>>>(
        static_cast<const float*>(pos), static_cast<const float*>(charge),
        static_cast<const float*>(binv), n, nx, ny, nz, cells);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(fixed_scatter::launch_to_float(
      cells, count, n, static_cast<float*>(grid), s));
}
