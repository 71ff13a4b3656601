// PME force interpolation (kernel 3 of the PME water-box path): contracts
// the convolved potential 2*phi with each atom's B-spline weights and their
// derivatives, then applies the chain rule to Cartesian forces.
//
// Replaces: openmm_tpu/ops/pme_zslab.py _gather_kernel (launched from
// pme_recip_ef), which walks z-sorted atom chunks over windows of 4-plane
// potential blocks with MXU products and leaves the chain rule to XLA
// (pme_zslab.py:512-522). Here each atom reads its 125 grid values by index.
//
// Design: one thread per atom; weights and derivatives stay in registers,
// the 0.7 MB potential grid stays in L2, and the thread writes its own force
// row, so the result is deterministic.
//
// Bound on this card: the 125 dependent L2 reads per atom (latency), far
// from both the byte and the float-operation limits at 24,000 atoms.
#include <cuda_runtime.h>

#include "bspline5.cuh"

namespace {

__global__ void pme_gather_kernel(const float* __restrict__ pos,
                                  const float* __restrict__ charge,
                                  const float* __restrict__ phi2,
                                  const float* __restrict__ binv, int n,
                                  int nx, int ny, int nz,
                                  float* __restrict__ forces) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = pos[3 * i], y = pos[3 * i + 1], z = pos[3 * i + 2];
  int bx, by, bz;
  float wx[5], wy[5], wz[5], dwx[5], dwy[5], dwz[5];
  grid_axis(x, y, z, binv, 0, nx, &bx, wx, dwx);
  grid_axis(x, y, z, binv, 1, ny, &by, wy, dwy);
  grid_axis(x, y, z, binv, 2, nz, &bz, wz, dwz);
  float gx = 0.0f, gy = 0.0f, gz = 0.0f;
#pragma unroll
  for (int jz = 0; jz < 5; ++jz) {
    const int iz = (bz + jz - 4 + nz) % nz;
#pragma unroll
    for (int jx = 0; jx < 5; ++jx) {
      const int ix = (bx + jx - 4 + nx) % nx;
      const float* row = phi2 + (static_cast<long>(iz) * nx + ix) * ny;
      float s_w = 0.0f, s_dy = 0.0f;
#pragma unroll
      for (int jy = 0; jy < 5; ++jy) {
        const float v = row[(by + jy - 4 + ny) % ny];
        s_w += wy[jy] * v;
        s_dy += dwy[jy] * v;
      }
      gx += dwx[jx] * wz[jz] * s_w;
      gy += wx[jx] * wz[jz] * s_dy;
      gz += wx[jx] * dwz[jz] * s_w;
    }
  }
  // u_a = n_a * frac_a and frac_a = sum_k pos_k * binv[k][a]
  const float q = charge[i];
  const float ga[3] = {gx * nx, gy * ny, gz * nz};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    forces[3 * i + k] =
        -q * (ga[0] * binv[3 * k] + ga[1] * binv[3 * k + 1] +
              ga[2] * binv[3 * k + 2]);
  }
}

}  // namespace

extern "C" int omm_pme_gather(const void* pos, const void* charge,
                              const void* phi2, const void* binv, int n,
                              int nx, int ny, int nz, void* forces,
                              void* stream) {
  if (n > 0) {
    const int threads = 128;
    pme_gather_kernel<<<(n + threads - 1) / threads, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pos), static_cast<const float*>(charge),
        static_cast<const float*>(phi2), static_cast<const float*>(binv), n,
        nx, ny, nz, static_cast<float*>(forces));
  }
  return static_cast<int>(cudaGetLastError());
}
