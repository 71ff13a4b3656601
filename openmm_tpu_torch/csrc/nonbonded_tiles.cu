// Direct-space nonbonded energy and analytic forces over 16-atom row bricks
// and their candidate bricks (kernel 1 of the PME water-box path).
//
// Replaces: openmm_tpu/ops/pallas_pairs.py _kernel_body + _tile_compute
// (launched by eval_tiles). The Pallas kernel reads compacted candidate slabs
// that XLA gathers every step, expands 16-bit exclusion words with a float
// matmul and tests bits by float parity; none of that is needed here.
//
// Design: one block of 16 x 8 threads per 16-atom row brick. Thread (lane,
// slice) owns row atom `lane` and walks candidate bricks slice, slice + 8,
// ...; the candidate atoms are read BY INDEX from the sorted position array
// (all 16 lanes of a slice read the same atom, one broadcast transaction),
// so there is no per-step slab gather. The exclusion test is an integer
// bit test on the word of (row atom, candidate brick). Every row atom sums
// over all its candidates (full-matrix traversal, energy halved by the
// caller), and the 8 slice partials are added in a fixed order through
// shared memory: no atomics, so forces are bit-for-bit reproducible.
//
// Bound on this card: operations. About 1.1e8 pair slots a step at 24,000
// atoms, ~40 float32 operations each with one expf and one rsqrtf, against
// ~2 bytes of device traffic per slot (positions and parameters stay in L1
// and L2). Only ~7 % of the slots lie inside the cutoff, so the kernel pays
// mostly for the cull; a later pass can tighten it (warp-level pair lists).
#include <cuda_runtime.h>

namespace {

constexpr int kBrick = 16;
constexpr int kSlices = 8;

// Hastings rational erfc (max error 1.5e-7), the form the JAX package's
// float32 path and the Pallas kernel use; exp(-x^2) is shared with the force.
__device__ __forceinline__ float erfc_hastings(float x, float exp_x2) {
  const float t = 1.0f / (1.0f + 0.3275911f * x);
  return (0.254829592f +
          (-0.284496736f +
           (1.421413741f + (-1.453152027f + 1.061405429f * t) * t) * t) * t) *
         t * exp_x2;
}

// consts: alpha, rc^2, krf, crf, ax, bx, by, cx, cy, cz, 1/ax, 1/by, 1/cz,
//         switch distance, 1/(rc - switch distance), unused
__global__ void __launch_bounds__(kBrick * kSlices)
nonbonded_tiles_kernel(const float4* __restrict__ pos,
                       const float4* __restrict__ par,
                       const int* __restrict__ cand,
                       const int* __restrict__ count,
                       const int* __restrict__ words,
                       const float* __restrict__ consts, int max_cand,
                       int exc_cap, int mode, int use_switch,
                       float4* __restrict__ out) {
  const int r = blockIdx.x;
  const int lane = threadIdx.x % kBrick;
  const int slice = threadIdx.x / kBrick;
  const int i = r * kBrick + lane;

  const float alpha = consts[0], rc2 = consts[1], krf = consts[2],
              crf = consts[3];
  const float ax = consts[4], bx = consts[5], by = consts[6], cx = consts[7],
              cy = consts[8], cz = consts[9];
  const float inv_ax = consts[10], inv_by = consts[11], inv_cz = consts[12];
  const float rs = consts[13], inv_w = consts[14];
  const float two_over_sqrt_pi = 1.1283791670955126f;

  const float4 pi = pos[i];
  const float4 qi = par[i];
  float fx = 0.f, fy = 0.f, fz = 0.f, e = 0.f;
  const int n_cand = count[r];
  for (int k = slice; k < n_cand; k += kSlices) {
    const int cb = cand[r * max_cand + k];
    const unsigned int word =
        k < exc_cap ? static_cast<unsigned int>(words[i * exc_cap + k]) : 0u;
    for (int l = 0; l < kBrick; ++l) {
      const int j = cb * kBrick + l;
      const float4 pj = pos[j];
      float dx = pi.x - pj.x, dy = pi.y - pj.y, dz = pi.z - pj.z;
      const float sc = rintf(dz * inv_cz);
      dx -= sc * cx;
      dy -= sc * cy;
      dz -= sc * cz;
      const float sb = rintf(dy * inv_by);
      dx -= sb * bx;
      dy -= sb * by;
      dx -= rintf(dx * inv_ax) * ax;
      const float r2 = dx * dx + dy * dy + dz * dz;
      if (r2 >= rc2 || ((word >> l) & 1u)) continue;
      const float4 qj = par[j];
      const float r2s = fmaxf(r2, 2e-6f);
      const float inv_r = rsqrtf(r2s);
      const float inv_r2 = inv_r * inv_r;
      const float sig = qi.y + qj.y;
      const float eps4 = qi.z * qj.z;
      const float s2 = sig * sig * inv_r2;
      const float s6 = s2 * s2 * s2;
      const float es6 = eps4 * s6;
      float de_lj = -3.0f * es6 * (2.0f * s6 - 1.0f) * inv_r2;
      float e_lj = es6 * (s6 - 1.0f);
      if (use_switch) {
        const float rr = r2s * inv_r;
        const float t = fminf(fmaxf((rr - rs) * inv_w, 0.0f), 1.0f);
        const float t2 = t * t;
        const float sw = 1.0f - t2 * t * (10.0f - 15.0f * t + 6.0f * t2);
        const float om = 1.0f - t;
        const float dsw = (-30.0f * t2 * om * om * inv_w) * (0.5f * inv_r);
        de_lj = de_lj * sw + e_lj * dsw;
        e_lj = e_lj * sw;
      }
      const float qq = qi.x * qj.x;
      float de_c, e_c;
      if (mode == 0) {  // Ewald / PME direct space
        const float ar = alpha * (r2s * inv_r);
        const float ex = expf(-ar * ar);
        const float erfc_ar = erfc_hastings(ar, ex);
        de_c = -qq * (erfc_ar * inv_r2 + two_over_sqrt_pi * alpha * ex * inv_r) *
               (0.5f * inv_r);
        e_c = qq * inv_r * erfc_ar;
      } else {  // reaction field
        de_c = qq * (-0.5f * inv_r2 * inv_r + krf);
        e_c = qq * (inv_r + krf * r2s - crf);
      }
      const float dedr2 = de_lj + de_c;
      fx -= 2.0f * dedr2 * dx;
      fy -= 2.0f * dedr2 * dy;
      fz -= 2.0f * dedr2 * dz;
      e += e_lj + e_c;
    }
  }
  __shared__ float4 partial[kSlices][kBrick];
  partial[slice][lane] = make_float4(fx, fy, fz, e);
  __syncthreads();
  if (slice == 0) {
    float4 s = partial[0][lane];
    for (int m = 1; m < kSlices; ++m) {
      const float4 p = partial[m][lane];
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    out[i] = s;
  }
}

}  // namespace

extern "C" int omm_nonbonded_tiles(const void* pos, const void* par,
                                   const void* cand, const void* count,
                                   const void* words, const void* consts,
                                   int n_bricks, int max_cand, int exc_cap,
                                   int mode, int use_switch, void* out,
                                   void* stream) {
  if (n_bricks > 0) {
    nonbonded_tiles_kernel<<<n_bricks, kBrick * kSlices, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(pos), static_cast<const float4*>(par),
        static_cast<const int*>(cand), static_cast<const int*>(count),
        static_cast<const int*>(words), static_cast<const float*>(consts),
        max_cand, exc_cap, mode, use_switch, static_cast<float4*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
