// Dense B-spline charge spread as one triple contraction, forward and
// backward (kernels 4 and 5: the differentiable dense PME that the
// minimizer's objective runs).
//
//   forward   Q[x, (y,z)] = sum_i a[i,x] wy[i,y] wz[i,z]
//   backward  dA[i,x]  = sum_(y,z) wy[i,y] wz[i,z] dQ[x,(y,z)]
//             U[i,(y,z)] = sum_x a[i,x] dQ[x,(y,z)]   (never stored)
//             dWy[i,y] = sum_z U[i,(y,z)] wz[i,z]
//             dWz[i,z] = sum_y U[i,(y,z)] wy[i,y]
//
// Replaces: openmm_tpu/ops/pallas_pme.py _fwd_kernel (launched from
// _spread_fwd_impl) and _bwd_kernel (launched from _spread_bwd), the two
// halves of the jax.custom_vjp spread_triple. What carries over is what
// they keep out of device memory: the outer product C = wy (x) wz (N x
// ny*nz floats) and, in the backward, U (the same size; 301 MB at 24,000
// atoms on a 56^3 grid) live only in shared memory and registers. What does
// not carry over are the Mosaic workarounds: the hi/lo bf16 one-hot
// expansion matmuls and their selector inputs (a product wy*wz is exact
// here), the transposed inputs, and the padding of N to the chunk (the
// kernels mask the ragged edge themselves).
//
// Numerics: every product and sum is a float32 FMA on the CUDA cores, the
// counterpart of Precision.HIGHEST; no TF32 tensor-core path is used (it
// keeps ~3 decimal digits).
//
// Bound on this card: the function needs few bytes (~17 MB forward, ~33 MB
// backward at 24,000 atoms: 5 and 10 us at 3.35 TB/s) and, since each row
// of a, wy and wz holds only 5 nonzero weights, few operations. These
// kernels do the dense work instead (8.4e9 float operations forward,
// 1.75e10 backward at 24,000 atoms: 0.13 and 0.26 ms at the 67 TFLOP/s
// float32 peak), as the TPU kernels did on the matrix unit, so the float32
// pipe and shared-memory bandwidth bound them, far above the byte bound.
// Design against that: register tiles of 4x4 outputs per thread over 64x64
// block tiles staged in shared memory (each staged value feeds 16 FMAs).
// The forward splits the atom axis, because the 0.7 MB output alone gives
// only 49 block tiles for 132 SMs; each split writes a partial grid and a
// second pass adds the partials in split order, so Q is deterministic. The
// backward gives each block 64 atoms and walks the (y,z) axis in tiles: its
// output rows belong to it alone, so it needs no atomics either.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int kTile = 64;       // block tile edge
constexpr int kLd = kTile + 1;  // padded shared row: conflict-free columns
constexpr int kFwdK = 32;       // atoms staged per step of the forward
constexpr int kBwdAtoms = 64;   // atoms owned by one backward block
static_assert(kThreads / kBwdAtoms == 4, "reduction groups are y%4, z%4");

// One output tile (x0.., yz0..) of one atom split:
// out[split][x][yz] = sum over the split's atoms of a[i,x] wy[i,y] wz[i,z].
__global__ void __launch_bounds__(kThreads)
spread_triple_fwd_kernel(const float* __restrict__ a,
                         const float* __restrict__ wy,
                         const float* __restrict__ wz, int n, int nx, int ny,
                         int nz, int atoms_per_split,
                         float* __restrict__ out) {
  __shared__ float as[kFwdK][kTile];
  __shared__ float cs[kFwdK][kTile];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int yz_count = ny * nz;
  const int yz0 = blockIdx.x * kTile;
  const int x0 = blockIdx.y * kTile;
  const int i_begin = blockIdx.z * atoms_per_split;
  const int i_end = min(n, i_begin + atoms_per_split);
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

  for (int i0 = i_begin; i0 < i_end; i0 += kFwdK) {
    __syncthreads();
    for (int e = threadIdx.x; e < kFwdK * kTile; e += kThreads) {
      const int k = e / kTile, c = e % kTile;
      const int i = i0 + k;
      const bool live = i < i_end;
      const int x = x0 + c;
      as[k][c] = (live && x < nx) ? a[static_cast<long>(i) * nx + x] : 0.0f;
      const int yz = yz0 + c;
      float v = 0.0f;
      if (live && yz < yz_count) {
        const int y = yz / nz, z = yz - y * nz;
        v = wy[static_cast<long>(i) * ny + y] * wz[static_cast<long>(i) * nz + z];
      }
      cs[k][c] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kFwdK; ++k) {
      float ar[4], cr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) ar[r] = as[k][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) cr[c] = cs[k][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(ar[r], cr[c], acc[r][c]);
    }
  }
  float* dst = out + static_cast<long>(blockIdx.z) * nx * yz_count;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int x = x0 + ty + 16 * r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int yz = yz0 + tx + 16 * c;
      if (x < nx && yz < yz_count) {
        dst[static_cast<long>(x) * yz_count + yz] = acc[r][c];
      }
    }
  }
}

// out[e] = partial[0][e] + partial[1][e] + ... in split order.
__global__ void sum_splits_kernel(const float* __restrict__ partial,
                                  int splits, long count,
                                  float* __restrict__ out) {
  const long e = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float s = partial[e];
  for (int k = 1; k < splits; ++k) s += partial[k * count + e];
  out[e] = s;
}

// Shared memory of one backward block, in floats.
__host__ __device__ constexpr int odd(int v) { return v | 1; }

template <int NXP>
__host__ __device__ int bwd_smem_floats(int ny, int nz) {
  return 2 * NXP * kLd + kTile * kLd + 2 * kBwdAtoms * (odd(ny) + odd(nz));
}

// 64 atoms per block. Shared memory: a^T (x-major), the dQ tile, the C
// tile (reused for the U tile), the atoms' wy and wz rows and their dWy and
// dWz accumulators (rows padded to an odd length). dA stays in registers.
template <int NXP>
__global__ void __launch_bounds__(kThreads)
spread_triple_bwd_kernel(const float* __restrict__ dq,
                         const float* __restrict__ a,
                         const float* __restrict__ wy,
                         const float* __restrict__ wz, int n, int nx, int ny,
                         int nz, float* __restrict__ da,
                         float* __restrict__ dwy, float* __restrict__ dwz) {
  extern __shared__ float smem[];
  constexpr int kXs = NXP / 16;          // dA columns per thread
  const int ldy = odd(ny), ldz = odd(nz);
  float* as = smem;                      // [NXP][kLd]: as[x][atom]
  float* dqs = as + NXP * kLd;           // [NXP][kLd]: dqs[x][c]
  float* cs = dqs + NXP * kLd;           // [kTile][kLd]: cs[c][atom]
  float* us = cs;                        // [kBwdAtoms][kLd]: us[atom][c]
  float* wys = cs + kTile * kLd;         // [kBwdAtoms][ldy]
  float* wzs = wys + kBwdAtoms * ldy;    // [kBwdAtoms][ldz]
  float* dwys = wzs + kBwdAtoms * ldz;   // [kBwdAtoms][ldy]
  float* dwzs = dwys + kBwdAtoms * ldy;  // [kBwdAtoms][ldz]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int i0 = blockIdx.x * kBwdAtoms;
  const int yz_count = ny * nz;

  for (int e = tid; e < kBwdAtoms * NXP; e += kThreads) {
    const int k = e / NXP, x = e % NXP;
    const int i = i0 + k;
    as[x * kLd + k] = (i < n && x < nx) ? a[static_cast<long>(i) * nx + x]
                                        : 0.0f;
  }
  for (int e = tid; e < kBwdAtoms * ny; e += kThreads) {
    const int k = e / ny, y = e % ny;
    const int i = i0 + k;
    wys[k * ldy + y] = i < n ? wy[static_cast<long>(i) * ny + y] : 0.0f;
    dwys[k * ldy + y] = 0.0f;
  }
  for (int e = tid; e < kBwdAtoms * nz; e += kThreads) {
    const int k = e / nz, z = e % nz;
    const int i = i0 + k;
    wzs[k * ldz + z] = i < n ? wz[static_cast<long>(i) * nz + z] : 0.0f;
    dwzs[k * ldz + z] = 0.0f;
  }

  float dacc[4][kXs];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kXs; ++c) dacc[r][c] = 0.0f;
  // reduction role: this thread owns dWy[ra][y] for y % 4 == rg and
  // dWz[ra][z] for z % 4 == rg, so every sum has one owner and one order
  const int ra = tid % kBwdAtoms, rg = tid / kBwdAtoms;

  for (int yz0 = 0; yz0 < yz_count; yz0 += kTile) {
    __syncthreads();  // staging done; the previous U tile fully reduced
    for (int e = tid; e < NXP * kTile; e += kThreads) {
      const int x = e / kTile, c = e % kTile;
      const int yz = yz0 + c;
      dqs[x * kLd + c] = (x < nx && yz < yz_count)
                             ? dq[static_cast<long>(x) * yz_count + yz]
                             : 0.0f;
    }
    for (int e = tid; e < kBwdAtoms * kTile; e += kThreads) {
      const int k = e / kTile, c = e % kTile;
      const int yz = yz0 + c;
      float v = 0.0f;
      if (yz < yz_count) {
        const int y = yz / nz, z = yz - y * nz;
        v = wys[k * ldy + y] * wzs[k * ldz + z];
      }
      cs[c * kLd + k] = v;
    }
    __syncthreads();

    // U tile (atoms x columns) = a (atoms x x) . dQ tile (x x columns)
    float u[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) u[r][c] = 0.0f;
#pragma unroll 8
    for (int x = 0; x < NXP; ++x) {
      float ar[4], qr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) ar[r] = as[x * kLd + ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) qr[c] = dqs[x * kLd + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) u[r][c] = fmaf(ar[r], qr[c], u[r][c]);
    }
    // dA (atoms x x) += C tile (atoms x columns) . dQ tile^T
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float cr[4], qr[kXs];
#pragma unroll
      for (int r = 0; r < 4; ++r) cr[r] = cs[c * kLd + ty + 16 * r];
#pragma unroll
      for (int j = 0; j < kXs; ++j) qr[j] = dqs[(tx + 16 * j) * kLd + c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < kXs; ++j)
          dacc[r][j] = fmaf(cr[r], qr[j], dacc[r][j]);
    }
    __syncthreads();  // the C tile is read; its space takes the U tile
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        us[(ty + 16 * r) * kLd + tx + 16 * c] = u[r][c];
    __syncthreads();

    const int c_end = min(kTile, yz_count - yz0);
    int y = yz0 / nz, z = yz0 - y * nz;
    for (int c = 0; c < c_end; ++c) {
      const float v = us[ra * kLd + c];
      if ((y & 3) == rg) dwys[ra * ldy + y] += v * wzs[ra * ldz + z];
      if ((z & 3) == rg) dwzs[ra * ldz + z] += v * wys[ra * ldy + y];
      if (++z == nz) {
        z = 0;
        ++y;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
#pragma unroll
    for (int j = 0; j < kXs; ++j) {
      const int x = tx + 16 * j;
      if (i < n && x < nx) da[static_cast<long>(i) * nx + x] = dacc[r][j];
    }
  }
  for (int e = tid; e < kBwdAtoms * ny; e += kThreads) {
    const int k = e / ny, y = e % ny;
    const int i = i0 + k;
    if (i < n) dwy[static_cast<long>(i) * ny + y] = dwys[k * ldy + y];
  }
  for (int e = tid; e < kBwdAtoms * nz; e += kThreads) {
    const int k = e / nz, z = e % nz;
    const int i = i0 + k;
    if (i < n) dwz[static_cast<long>(i) * nz + z] = dwzs[k * ldz + z];
  }
}

template <int NXP>
cudaError_t launch_bwd(const float* dq, const float* a, const float* wy,
                       const float* wz, int n, int nx, int ny, int nz,
                       float* da, float* dwy, float* dwz,
                       cudaStream_t stream) {
  const int bytes = static_cast<int>(sizeof(float)) *
                    bwd_smem_floats<NXP>(ny, nz);
  cudaError_t err = cudaFuncSetAttribute(
      spread_triple_bwd_kernel<NXP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (n + kBwdAtoms - 1) / kBwdAtoms;
  spread_triple_bwd_kernel<NXP><<<blocks, kThreads, bytes, stream>>>(
      dq, a, wy, wz, n, nx, ny, nz, da, dwy, dwz);
  return cudaGetLastError();
}

}  // namespace

// Forward. `splits` partial grids of nx * ny * nz floats go to `scratch`
// (unused when splits == 1) and their ordered sum to `out`.
extern "C" int omm_spread_triple_fwd(const void* a, const void* wy,
                                     const void* wz, int n, int nx, int ny,
                                     int nz, int splits, void* scratch,
                                     void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long count = static_cast<long>(nx) * ny * nz;
  if (n <= 0 || splits < 1) {
    return static_cast<int>(
        cudaMemsetAsync(out, 0, count * sizeof(float), s));
  }
  // round the split length up to whole staging steps; the last split may
  // be short, and none is empty
  int per = (n + splits - 1) / splits;
  per = (per + kFwdK - 1) / kFwdK * kFwdK;
  splits = (n + per - 1) / per;
  float* partial = static_cast<float*>(splits > 1 ? scratch : out);
  const dim3 grid((ny * nz + kTile - 1) / kTile, (nx + kTile - 1) / kTile,
                  splits);
  spread_triple_fwd_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(wy),
      static_cast<const float*>(wz), n, nx, ny, nz, per, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int threads = 256;
  sum_splits_kernel<<<static_cast<int>((count + threads - 1) / threads),
                      threads, 0, s>>>(partial, splits, count,
                                       static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Backward: (dA, dWy, dWz) from dQ and the forward's inputs. nx <= 128.
extern "C" int omm_spread_triple_bwd(const void* dq, const void* a,
                                     const void* wy, const void* wz, int n,
                                     int nx, int ny, int nz, void* da,
                                     void* dwy, void* dwz, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* q = static_cast<const float*>(dq);
  const auto* pa = static_cast<const float*>(a);
  const auto* py = static_cast<const float*>(wy);
  const auto* pz = static_cast<const float*>(wz);
  auto* oa = static_cast<float*>(da);
  auto* oy = static_cast<float*>(dwy);
  auto* oz = static_cast<float*>(dwz);
  cudaError_t err;
  if (nx <= 64) {
    err = launch_bwd<64>(q, pa, py, pz, n, nx, ny, nz, oa, oy, oz, s);
  } else if (nx <= 128) {
    err = launch_bwd<128>(q, pa, py, pz, n, nx, ny, nz, oa, oy, oz, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
