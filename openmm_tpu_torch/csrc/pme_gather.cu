// PME force interpolation (kernel 3 of the PME water-box path): contracts
// the convolved potential 2*phi with each atom's B-spline weights and their
// derivatives, then applies the chain rule to Cartesian forces.
//
// Replaces: openmm_tpu/ops/pme_zslab.py _gather_kernel (launched from
// pme_recip_ef), which walks z-sorted atom chunks over windows of 4-plane
// potential blocks with MXU products and leaves the chain rule to XLA
// (pme_zslab.py:512-522).
//
// What bounds it on this card: not bytes (the 0.7 MB grid and 0.4 MB of
// atoms) nor operations, but latency: 24,000 atoms make 750 warps, each a
// chain of dependent steps (order, position, grid coordinates, 125 reads).
// Read in the user's atom order, the 32 atoms of a warp touch ~32
// different 128-byte lines per load, so each of the 125 loads waits on
// as many L1 tag lookups.
//
// Design: one thread per atom, blocks of kBlock consecutive entries of a
// visiting order (the direct space's spatial sort on the main path), so
// the atoms of a warp lie close together and their loads share lines.
// The grid indices of the five support points on each axis are wrapped
// once, outside the contraction, by compares rather than `%`. Each atom's
// sum runs over (jz, jx, jy) in one fixed order, written with explicit
// roundings (__fmaf_rn, __fmul_rn), and each thread writes its own atom's
// force row, so the forces have the same bits on every call and in any
// visiting order. A staged design (each block copying its atoms' patch of
// the grid into shared memory) was measured against this one and
// dropped: see PERF.md (kernel_lab.py --trees).
#include <climits>
#include <cuda_runtime.h>

#include "bspline5.cuh"

namespace {

constexpr int kBlock = 32;   // atoms (threads) a block

// grid indices base + j - 4 (j = 0..4) wrapped into [0, size); base is in
// [0, size] (u rounds up to size when f rounds up to 1)
__device__ __forceinline__ void support(int base, int size, int idx[5]) {
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    int v = base + j - 4;
    v += v < 0 ? size : 0;
    v -= v >= size ? size : 0;
    idx[j] = v;
  }
}

__global__ void __launch_bounds__(kBlock)
    pme_gather_kernel(const float* __restrict__ pos,
                      const float* __restrict__ charge,
                      const float* __restrict__ phi2,
                      const float* __restrict__ binv,
                      const long long* __restrict__ order, int n, int nx,
                      int ny, int nz, float* __restrict__ forces) {
  const int k = blockIdx.x * kBlock + threadIdx.x;
  if (k >= n) return;
  const long long o = order != nullptr ? order[k] : k;
  if (o < 0 || o >= n) return;
  const int i = static_cast<int>(o);
  const float x = pos[3 * i], y = pos[3 * i + 1], z = pos[3 * i + 2];
  const int size[3] = {nx, ny, nz};
  float w[3][5], dw[3][5];
  int idx[3][5];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    int base;
    grid_axis(x, y, z, binv, a, size[a], &base, w[a], dw[a]);
    support(base, size[a], idx[a]);
  }
  // per row (jz, jx) the sums over y of the weights and their
  // derivatives, then the three sums the forces need
  float g[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int jz = 0; jz < 5; ++jz) {
#pragma unroll
    for (int jx = 0; jx < 5; ++jx) {
      const float* row = phi2 + (idx[2][jz] * nx + idx[0][jx]) * ny;
      float s_w = 0.0f, s_dy = 0.0f;
#pragma unroll
      for (int jy = 0; jy < 5; ++jy) {
        const float v = __ldg(row + idx[1][jy]);
        s_w = __fmaf_rn(w[1][jy], v, s_w);
        s_dy = __fmaf_rn(dw[1][jy], v, s_dy);
      }
      g[0] = __fmaf_rn(__fmul_rn(dw[0][jx], w[2][jz]), s_w, g[0]);
      g[1] = __fmaf_rn(__fmul_rn(w[0][jx], w[2][jz]), s_dy, g[1]);
      g[2] = __fmaf_rn(__fmul_rn(w[0][jx], dw[2][jz]), s_w, g[2]);
    }
  }
  // u_a = n_a * frac_a and frac_a = sum_k pos_k * binv[k][a]
  const float q = charge[i];
  const float ga[3] = {g[0] * nx, g[1] * ny, g[2] * nz};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    forces[3 * i + c] =
        -q * (ga[0] * binv[3 * c] + ga[1] * binv[3 * c + 1] +
              ga[2] * binv[3 * c + 2]);
  }
}

}  // namespace

// order: int64 visiting order (a permutation of 0..n-1) or null for the
// identity; a row whose atom the order does not name is not written.
extern "C" int omm_pme_gather(const void* pos, const void* charge,
                              const void* phi2, const void* binv,
                              const void* order, int n, int nx, int ny,
                              int nz, void* forces, void* stream) {
  if (nx < 5 || ny < 5 || nz < 5 ||
      static_cast<long>(nx) * ny * nz > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  pme_gather_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<const float*>(charge),
      static_cast<const float*>(phi2), static_cast<const float*>(binv),
      static_cast<const long long*>(order), n, nx, ny, nz,
      static_cast<float*>(forces));
  return static_cast<int>(cudaGetLastError());
}
