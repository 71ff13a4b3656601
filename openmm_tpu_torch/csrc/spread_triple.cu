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
// Replaces: openmm_tpu/ops/pallas_pme.py:65 _fwd_kernel (pallas_call at
// :141, launched from _spread_fwd_impl) and :96 _bwd_kernel (pallas_call
// at :177, launched from _spread_bwd), the two halves of the
// jax.custom_vjp spread_triple.
//
// Forward (kernel 4): a sparse scatter. The planes are dense (N, n) rows,
// but a spline row holds 5 nonzero weights; the TPU kernel multiplied the
// zeros too (8.4e9 operations at 24,000 atoms on a 56^3 grid, where the
// data need 6.6e6) because XLA's scatter serializes on the TPU. Here the
// kernel finds each row's support instead of assuming it, so any dense
// float32 planes give the exact sum, spline planes in 125 terms an atom:
//   1. spread_compact_kernel, one warp per atom, reads the atom's three
//      rows once, coalesced (these 16.8 MB set the byte bound), and
//      compacts each row's nonzero (index, value) pairs by __ballot_sync
//      into scratch the size of the input, with per-row counts. It also
//      records the atom's sum of |terms|, ||a_i||_1 ||wy_i||_1 ||wz_i||_1,
//      for the fixed-point scale.
//   2. spread_scatter_kernel, one warp per atom, adds the
//      nnz_x nnz_y nnz_z products a wy wz (in double) into an int64 grid
//      in 64-bit fixed point (fixed_scatter.cuh): term s = lane + 32 r, z
//      fastest, so neighbouring lanes add into neighbouring cells of the
//      (nx, ny*nz) layout. A support that wraps round the grid's edge is
//      just a set of nonzeros.
//   3. fixed_scatter's conversion writes Q in float32.
// What bounds it now: the 64-bit atomics (3e6 at 24,000 atoms) resolving
// in L2, against a byte bound of 5 us. Q has the same bits on every call:
// the integer sums do not depend on the order of the atomics, and the
// scale is an order-free max, read from device memory (no host sync).
//
// Backward (kernel 5): still the dense work of the TPU kernel. What
// carries over is what it keeps out of device memory: the outer product
// C = wy (x) wz and U (each N x ny*nz floats; 301 MB at 24,000 atoms on a
// 56^3 grid) live only in shared memory and registers. What does not carry
// over are the Mosaic workarounds: the hi/lo bf16 one-hot expansion
// matmuls and their selector inputs (a product wy*wz is exact here), the
// transposed inputs, and the padding of N to the chunk (the kernel masks
// the ragged edge itself). Every product and sum is a float32 FMA on the
// CUDA cores, the counterpart of Precision.HIGHEST; no TF32 path is used.
// It needs ~33 MB at 24,000 atoms (10 us at 3.35 TB/s) and does 1.75e10
// float operations (0.26 ms at the 67 TFLOP/s float32 peak), so the
// float32 pipe and shared-memory bandwidth bound it. Design against that:
// register tiles of 4x4 outputs per thread over 64x64 block tiles staged
// in shared memory; each block owns 64 atoms and walks the (y,z) axis in
// tiles, so its output rows belong to it alone and it needs no atomics.
// One launch takes grid axes up to 128 (its shared-memory layout); the
// wrapper splits wider grids (ops/pallas_pme.py:split_vjp).
#include <cuda_runtime.h>

#include "fixed_scatter.cuh"

namespace {

using fixed_scatter::kFull;

constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int kTile = 64;       // block tile edge
constexpr int kLd = kTile + 1;  // padded shared row: conflict-free columns
constexpr int kBwdAtoms = 64;   // atoms owned by one backward block
constexpr int kMaxAxis = 128;   // widest grid axis of one backward launch
constexpr int kWarps = 8;       // atoms (warps) per forward block
constexpr int kChunks = 4;      // row chunks of 32 a lane loads ahead
static_assert(kThreads / kBwdAtoms == 4, "reduction groups are y%4, z%4");

// Row entries a lane loads ahead: c0 + 32 k + lane for k < kChunks.
__device__ __forceinline__ void load_chunks(const float* __restrict__ row,
                                            int len, int c0, int lane,
                                            float v[kChunks]) {
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int c = c0 + 32 * k + lane;
    v[k] = c < len ? row[c] : 0.0f;
  }
}

// Compact one row's nonzero entries, in index order, into out as
// (index, float bits): the first kChunks chunks from `first` (loaded
// ahead), the rest as they are loaded. Returns their count and sets *l1
// to sum |v| (every lane gets the same value).
__device__ __forceinline__ int compact_row(const float* __restrict__ row,
                                           int len, int lane,
                                           const float first[kChunks],
                                           int2* __restrict__ out,
                                           double* l1) {
  const unsigned below = (1u << lane) - 1u;
  int count = 0;
  double sum = 0.0;
  float v[kChunks];
#pragma unroll
  for (int k = 0; k < kChunks; ++k) v[k] = first[k];
  for (int c0 = 0; c0 < len; c0 += 32 * kChunks) {
    if (c0 > 0) load_chunks(row, len, c0, lane, v);
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const bool keep = v[k] != 0.0f;  // NaN is kept, and poisons the sum
      const unsigned mask = __ballot_sync(kFull, keep);
      if (keep) {
        out[count + __popc(mask & below)] =
            make_int2(c0 + 32 * k + lane, __float_as_int(v[k]));
        sum += fabs(static_cast<double>(v[k]));
      }
      count += __popc(mask);
    }
  }
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
  *l1 = sum;
  return count;
}

// Stage 1: per atom, the supports of its rows of a, wy and wz. The first
// 128 entries of all three rows are loaded before any is compacted, so a
// warp waits on device memory once for a row of up to 128. The atoms'
// sums of |terms| meet in shared memory first: one atomicMax a block on
// the one shared address, not one an atom, which serialize in L2.
__global__ void __launch_bounds__(32 * kWarps)
spread_compact_kernel(const float* __restrict__ a,
                      const float* __restrict__ wy,
                      const float* __restrict__ wz, int n, int nx, int ny,
                      int nz, int2* __restrict__ entries,
                      int* __restrict__ counts,
                      unsigned long long* __restrict__ extra) {
  __shared__ double block_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int i = blockIdx.x * kWarps + warp;
  double abs_sum = 0.0;
  if (i < n) {  // the same for every lane of a warp
    const float* ra = a + static_cast<long>(i) * nx;
    const float* ry = wy + static_cast<long>(i) * ny;
    const float* rz = wz + static_cast<long>(i) * nz;
    float va[kChunks], vy[kChunks], vz[kChunks];
    load_chunks(ra, nx, 0, lane, va);
    load_chunks(ry, ny, 0, lane, vy);
    load_chunks(rz, nz, 0, lane, vz);
    int2* out = entries + static_cast<long>(i) * (nx + ny + nz);
    double lx, ly, lz;
    const int cx = compact_row(ra, nx, lane, va, out, &lx);
    const int cy = compact_row(ry, ny, lane, vy, out + nx, &ly);
    const int cz = compact_row(rz, nz, lane, vz, out + nx + ny, &lz);
    if (lane == 0) {
      counts[3 * i] = cx;
      counts[3 * i + 1] = cy;
      counts[3 * i + 2] = cz;
    }
    abs_sum = lx * ly * lz;
  }
  if (lane == 0) block_sums[warp] = abs_sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    double m = 0.0;
    for (int w = 0; w < kWarps; ++w) {
      const double v = block_sums[w];
      if (!isfinite(v)) {  // record_atom raises the flag
        m = v;
        break;
      }
      m = fmax(m, v);
    }
    fixed_scatter::record_atom(extra, m);
  }
}

// Stage 2: per atom, its nnz_x nnz_y nnz_z terms into the int64 grid.
__global__ void __launch_bounds__(32 * kWarps)
spread_scatter_kernel(const int2* __restrict__ entries,
                      const int* __restrict__ counts, int n, int nx, int ny,
                      int nz, unsigned long long* __restrict__ acc) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + threadIdx.x / 32;
  if (i >= n) return;
  const long yz_count = static_cast<long>(ny) * nz;
  int e;
  if (!fixed_scatter::scale_exponent(n, acc + nx * yz_count, &e)) {
    return;  // a non-finite input: the conversion writes NaN
  }
  const double scale = ldexp(1.0, e);
  const int cx = counts[3 * i], cy = counts[3 * i + 1], cz = counts[3 * i + 2];
  const int2* xs = entries + static_cast<long>(i) * (nx + ny + nz);
  const int2* ys = xs + nx;
  const int2* zs = ys + ny;
  const int terms = cx * cy * cz;
  if (terms == 0) return;
  // term s = (kx, ky, kz), kz fastest; s steps by 32, so (kx, ky, kz)
  // advance by 32 = dl lines and dz terms, with carries
  const int dl = 32 / cz, dz = 32 - dl * cz;
  int line = lane / cz, kz = lane - line * cz;
  int kx = line / cy, ky = line - kx * cy;
  for (int s = lane; s < terms; s += 32) {
    const int2 px = xs[kx], py = ys[ky], pz = zs[kz];
    const double term = static_cast<double>(__int_as_float(px.y)) *
                        __int_as_float(py.y) * __int_as_float(pz.y);
    fixed_scatter::add_term(acc, px.x * yz_count + py.x * nz + pz.x, term,
                            scale);
    kz += dz;
    int step = dl;
    if (kz >= cz) {
      kz -= cz;
      ++step;
    }
    for (ky += step; ky >= cy; ky -= cy) ++kx;
  }
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

// Forward. Scratch: entries (n * (nx + ny + nz) int2), counts (3n int),
// acc (nx * ny * nz + 2 int64); out: Q (nx, ny * nz) float32.
extern "C" int omm_spread_triple_fwd(const void* a, const void* wy,
                                     const void* wz, int n, int nx, int ny,
                                     int nz, void* entries, void* counts,
                                     void* acc, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long count = static_cast<long>(nx) * ny * nz;
  auto* cells = static_cast<unsigned long long*>(acc);
  cudaError_t err = cudaMemsetAsync(
      cells, 0, (count + fixed_scatter::kExtraSlots) * sizeof(*cells), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    auto* pairs = static_cast<int2*>(entries);
    auto* rows = static_cast<int*>(counts);
    const int blocks = (n + kWarps - 1) / kWarps;
    spread_compact_kernel<<<blocks, 32 * kWarps, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(wy),
        static_cast<const float*>(wz), n, nx, ny, nz, pairs, rows,
        cells + count);
    spread_scatter_kernel<<<blocks, 32 * kWarps, 0, s>>>(
        pairs, rows, n, nx, ny, nz, cells);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(fixed_scatter::launch_to_float(
      cells, count, n, static_cast<float*>(out), s));
}

// Backward: (dA, dWy, dWz) from dQ and the forward's inputs; each grid
// axis at most kMaxAxis.
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
  if (ny > kMaxAxis || nz > kMaxAxis) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  if (nx <= 64) {
    err = launch_bwd<64>(q, pa, py, pz, n, nx, ny, nz, oa, oy, oz, s);
  } else if (nx <= kMaxAxis) {
    err = launch_bwd<kMaxAxis>(q, pa, py, pz, n, nx, ny, nz, oa, oy, oz, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
