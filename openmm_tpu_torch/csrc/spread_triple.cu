// Dense B-spline charge spread as one triple contraction, forward and
// backward (kernels 4 and 5: the differentiable dense PME that the
// minimizer's objective runs).
//
//   forward   Q[x, (y,z)] = sum_i a[i,x] wy[i,y] wz[i,z]
//   backward  dA[i,x]  = sum_y wy[i,y] sum_z wz[i,z] dQ[x,y,z]
//             dWy[i,y] = sum_x a[i,x] sum_z wz[i,z] dQ[x,y,z]
//             dWz[i,z] = sum_x a[i,x] sum_y wy[i,y] dQ[x,y,z]
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
// Backward (kernel 5): a sparse VJP. The TPU kernel did the dense work,
// 64x64 tiles over every (atom, x, (y,z)): 1.75e10 operations at 24,000
// atoms on 56^3, where the data need 2.2e8. Here the sums run over each
// atom's supports only: with Sx, Sy, Sz the nonzero columns of its rows,
// its dA row takes |Sy||Sz| nx FMAs, dWy |Sx||Sz| ny and dWz |Sx||Sy| nz
// (4,200 an atom on 56^3 with 5-entry splines). The outputs are dense, as
// the Function's contract and the JAX function's have them, and written in
// full.
//   1. transpose_dq_kernel writes dQ twice more, as (ny, nz, nx) and
//      (nx, nz, ny), so that each output row reads dQ along its own axis.
//   2. spread_vjp_kernel, one warp per atom, compacts the atom's three
//      rows by ballot as stage 1 of the forward does (into its own stretch
//      of scratch, so nothing is kept from the forward and
//      spread_triple_bwd stands alone), then writes each output row with
//      lanes over its entries: every load of dQ and every store is
//      coalesced, and each lane keeps kUnroll kOut loads in flight.
// A warp owns its atom's rows, so there are no atomics, and every sum is
// taken in one fixed order in float32: the outputs have the same bits on
// every call. A dense row is a support of its full width, so arbitrary
// planes get the exact dense VJP. Nothing is sized by a grid axis: one
// launch takes any grid below 2^31 cells.
// What bounds it: the bytes are 16.8 MB of rows read and 16.8 MB of
// outputs written (10 us at the H100's 3.35 TB/s), but each atom reads 75
// strips of dQ (16.8 KB; ~0.4 GB in all at 24,000 atoms), which L1 and L2
// serve: its time follows their hit rate and the loads in flight.
#include <cuda_runtime.h>

#include "fixed_scatter.cuh"

namespace {

using fixed_scatter::kFull;

constexpr int kWarps = 8;       // atoms (warps) per block
constexpr int kChunks = 4;      // row chunks of 32 a lane loads ahead
constexpr int kOut = 2;         // output entries of 32 a lane sums at once
constexpr int kUnroll = 16;     // support pairs a lane loads at once
constexpr int kTile = 32;       // transpose tile edge

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
// ahead), the rest as they are loaded. Returns their count and, unless l1
// is null, sets *l1 to sum |v| (every lane gets the same value).
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
  if (l1 != nullptr) {
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
    *l1 = sum;
  }
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

// Kernel 5, stage 1: two transposed copies of dQ (nx, ny, nz), so that
// every output row reads dQ along its own axis: ta (ny, nz, nx) for dA and
// ty (nx, nz, ny) for dWy (dWz reads dQ as it is). Blocks below tiles_a
// transpose dQ as one (nx, ny nz) matrix into ta, the others each (ny, nz)
// slab into ty; 32x32 tiles through shared memory, both sides coalesced.
__global__ void __launch_bounds__(32 * kWarps)
transpose_dq_kernel(const float* __restrict__ dq, int nx, int ny, int nz,
                    int tiles_a, float* __restrict__ ta,
                    float* __restrict__ ty) {
  __shared__ float tile[kTile][kTile + 1];
  int b = blockIdx.x;
  const float* in = dq;
  float* out = ta;
  int rows = nx, cols = ny * nz;
  if (b >= tiles_a) {
    b -= tiles_a;
    const int per_slab = ((ny + kTile - 1) / kTile) * ((nz + kTile - 1) / kTile);
    const long slab = static_cast<long>(b / per_slab) * ny * nz;
    b %= per_slab;
    in = dq + slab;
    out = ty + slab;
    rows = ny;
    cols = nz;
  }
  const int tiles_c = (cols + kTile - 1) / kTile;
  const int r0 = b / tiles_c * kTile, c0 = b % tiles_c * kTile;
  const int lane = threadIdx.x & 31;
  for (int k = threadIdx.x / 32; k < kTile; k += kWarps) {
    if (r0 + k < rows && c0 + lane < cols) {
      tile[k][lane] = in[static_cast<long>(r0 + k) * cols + c0 + lane];
    }
  }
  __syncthreads();
  for (int k = threadIdx.x / 32; k < kTile; k += kWarps) {
    if (c0 + k < cols && r0 + lane < rows) {
      out[static_cast<long>(c0 + k) * rows + r0 + lane] = tile[lane][k];
    }
  }
}

// Kernel 5, one output row of one atom, all `len` entries:
//   out[o] = sum_(k1, k2) v1[k1] v2[k2] t[s1[k1] st1 + s2[k2] st2 + o]
// over the supports (s1, v1) and (s2, v2) of the atom's two other rows,
// the pairs (k1, k2) taken in one fixed order. t holds the output's axis
// fastest, so lanes over o (32 kOut at a time) read and write coalesced.
// Each lane works out one pair's offset and weight, which are then
// broadcast by shuffle, kUnroll pairs at a time: a lane has kUnroll kOut
// loads in flight, which L2's latency needs.
__device__ __forceinline__ void vjp_row(const float* __restrict__ t,
                                        int st1, int st2, const int2* s1,
                                        int c1, const int2* s2, int c2,
                                        int len, int lane,
                                        float* __restrict__ out) {
  const int pairs = c1 * c2;
  for (int o0 = 0; o0 < len; o0 += 32 * kOut) {
    const float* col = t + o0 + lane;
    bool live[kOut];
    float acc[kOut];
#pragma unroll
    for (int u = 0; u < kOut; ++u) {
      live[u] = o0 + 32 * u + lane < len;
      acc[u] = 0.0f;
    }
    for (int p0 = 0; p0 < pairs; p0 += 32) {
      int off = 0;
      float w = 0.0f;
      if (p0 + lane < pairs) {
        const int k1 = (p0 + lane) / c2, k2 = p0 + lane - k1 * c2;
        const int2 e1 = s1[k1], e2 = s2[k2];
        off = e1.x * st1 + e2.x * st2;
        w = __int_as_float(e1.y) * __int_as_float(e2.y);
      }
      const int m = min(32, pairs - p0);
      for (int q0 = 0; q0 < m; q0 += kUnroll) {
        float wq[kUnroll], v[kUnroll][kOut];
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          const int o = __shfl_sync(kFull, off, (q0 + q) & 31);
          wq[q] = __shfl_sync(kFull, w, (q0 + q) & 31);
#pragma unroll
          for (int u = 0; u < kOut; ++u) {
            v[q][u] = live[u] && q0 + q < m ? col[o + 32 * u] : 0.0f;
          }
        }
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          if (q0 + q < m) {
#pragma unroll
            for (int u = 0; u < kOut; ++u) acc[u] = fmaf(wq[q], v[q][u], acc[u]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kOut; ++u) {
      if (live[u]) out[o0 + 32 * u + lane] = acc[u];
    }
  }
}

// Kernel 5, stage 2, one warp per atom: its three supports by ballot
// compaction into its own stretch of `entries` (read back by the same warp
// only), then its rows of dA, dWy and dWz in full over those supports.
// Each output row belongs to one warp: no atomics.
__global__ void __launch_bounds__(32 * kWarps)
spread_vjp_kernel(const float* __restrict__ dq, const float* __restrict__ ta,
                  const float* __restrict__ ty, const float* __restrict__ a,
                  const float* __restrict__ wy, const float* __restrict__ wz,
                  int n, int nx, int ny, int nz, int2* __restrict__ entries,
                  float* __restrict__ da, float* __restrict__ dwy,
                  float* __restrict__ dwz) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + threadIdx.x / 32;
  if (i >= n) return;  // the whole warp
  const float* ra = a + static_cast<long>(i) * nx;
  const float* ry = wy + static_cast<long>(i) * ny;
  const float* rz = wz + static_cast<long>(i) * nz;
  float va[kChunks], vy[kChunks], vz[kChunks];
  load_chunks(ra, nx, 0, lane, va);
  load_chunks(ry, ny, 0, lane, vy);
  load_chunks(rz, nz, 0, lane, vz);
  int2* xs = entries + static_cast<long>(i) * (nx + ny + nz);
  int2* ys = xs + nx;
  int2* zs = ys + ny;
  const int cx = compact_row(ra, nx, lane, va, xs, nullptr);
  const int cy = compact_row(ry, ny, lane, vy, ys, nullptr);
  const int cz = compact_row(rz, nz, lane, vz, zs, nullptr);
  __syncwarp();  // the entries written by each lane are visible to all
  vjp_row(ta, nz * nx, nx, ys, cy, zs, cz, nx, lane,
          da + static_cast<long>(i) * nx);
  vjp_row(ty, nz * ny, ny, xs, cx, zs, cz, ny, lane,
          dwy + static_cast<long>(i) * ny);
  vjp_row(dq, ny * nz, nz, xs, cx, ys, cy, nz, lane,
          dwz + static_cast<long>(i) * nz);
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

// Backward: (dA, dWy, dWz) from dQ and the forward's inputs, for any
// grid. Scratch: entries (n * (nx + ny + nz) int2), transposed (two grids,
// 2 nx ny nz float).
extern "C" int omm_spread_triple_bwd(const void* dq, const void* a,
                                     const void* wy, const void* wz, int n,
                                     int nx, int ny, int nz, void* entries,
                                     void* transposed, void* da, void* dwy,
                                     void* dwz, void* stream) {
  if (n > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* q = static_cast<const float*>(dq);
    auto* ta = static_cast<float*>(transposed);
    auto* ty = ta + static_cast<long>(nx) * ny * nz;
    const int tiles_a =
        ((nx + kTile - 1) / kTile) * ((ny * nz + kTile - 1) / kTile);
    const int tiles_y =
        nx * ((ny + kTile - 1) / kTile) * ((nz + kTile - 1) / kTile);
    transpose_dq_kernel<<<tiles_a + tiles_y, 32 * kWarps, 0, s>>>(
        q, nx, ny, nz, tiles_a, ta, ty);
    spread_vjp_kernel<<<(n + kWarps - 1) / kWarps, 32 * kWarps, 0, s>>>(
        q, ta, ty, static_cast<const float*>(a),
        static_cast<const float*>(wy), static_cast<const float*>(wz), n, nx,
        ny, nz, static_cast<int2*>(entries), static_cast<float*>(da),
        static_cast<float*>(dwy), static_cast<float*>(dwz));
  }
  return static_cast<int>(cudaGetLastError());
}
