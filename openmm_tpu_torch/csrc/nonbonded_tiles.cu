// Direct-space nonbonded energy and analytic forces over 16-atom row bricks
// and their candidate bricks (kernel 1 of the PME water-box path; its
// modes: Ewald/PME, the reaction field, and LJPME), and, in instantiations
// of their own, the derivative of the energy in a global parameter that
// parameter offsets move the charges, sigmas and epsilons by.
//
// Replaces: openmm_tpu/ops/pallas_pairs.py _kernel_body + _tile_compute
// (launched by eval_tiles). The Pallas kernel reads compacted candidate slabs
// that XLA gathers every step, expands 16-bit exclusion words with a float
// matmul and tests bits by float parity; none of that is needed here.
//
// What bounds it on this card. The candidate state lists, per row brick,
// the bricks whose bounding boxes came within cutoff + skin at the last
// rebuild: ~2,900 pair slots a row atom at 24,000 atoms, of which ~10 % lie
// inside the cutoff. A sweep that tests every slot pays for ~7e7 staged
// minimum images, and one that runs the pair terms (LJ, erfc, exp: ~70
// operations) where one lane of a warp hits runs them at a small fraction
// of its lanes. The bound is the operations of the pairs inside the cutoff,
// each counted once.
//
// Design: cull, then compact, then compute.
//   1. brick_bounds_kernel: the bounding box (centre, half extent) of every
//      brick at this step's positions, a half-warp a brick.
//   2. nonbonded_tiles_kernel: one warp per row atom. Its lanes test 32 of
//      the row brick's candidate bricks at a time against the atom: the
//      staged minimum image of atom - centre, less the half extent on each
//      axis, must come within the cutoff (plus 1e-3 nm of slack for
//      rounding). Every pair the sweep would count passes: the image shift
//      of a pair inside the cutoff equals that of its brick's centre once
//      the half extent is within box/2 - cutoff on each axis, and a brick
//      wider than that is always kept. The surviving bricks are compacted
//      by ballot into a list in shared memory and swept two at a time (16
//      lanes each, one coalesced float4 load a lane), in a loop with no
//      divergent branch. The pairs inside the cutoff and not excluded (an
//      integer bit test on the word of (row atom, candidate brick)) are
//      ballot-compacted into a 64-entry queue in shared memory, and the
//      pair terms run only on full warps of 32 queued pairs (and once on
//      the remainder at the end). At 24,000 atoms this tests ~900 slots an
//      atom instead of ~2,900, and runs the pair terms ~3.2x less often.
// What bounds it now: the sweep's chain of dependent steps a round (list
// entry, position, staged image, ballot, queue), at the 32 warps an SM its
// 64 registers allow; forcing fewer registers spills and is slower.
//
// A lane adds the pairs that land in its queue slot, in queue order, and the
// 32 lane sums are added by a fixed shuffle tree: every output is owned by
// one warp and summed in one order, so forces are bit-for-bit reproducible
// (no atomics). Every row atom sums over all its partners (full-matrix
// traversal, energy halved by the caller), so each pair is computed twice:
// the design can reach at most half the bound that counts each pair once.
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBrick = 16;
constexpr int kWarps = 8;            // row atoms (warps) per block
constexpr int kQueue = 64;           // queued pairs a warp
constexpr float kCullSlack = 1e-3f;  // nm

// Hastings rational erfc (max error 1.5e-7), the form the JAX package's
// float32 path and the Pallas kernel use; exp(-x^2) is shared with the force.
__device__ __forceinline__ float erfc_hastings(float x, float exp_x2) {
  const float t = 1.0f / (1.0f + 0.3275911f * x);
  return (0.254829592f +
          (-0.284496736f +
           (1.421413741f + (-1.453152027f + 1.061405429f * t) * t) * t) * t) *
         t * exp_x2;
}

// The reduced triclinic box a = (ax, 0, 0), b = (bx, by, 0),
// c = (cx, cy, cz) and the staged minimum image the sweep uses.
struct Box {
  float ax, bx, by, cx, cy, cz, inv_ax, inv_by, inv_cz;

  __device__ __forceinline__ float3 image(float dx, float dy,
                                          float dz) const {
    const float sc = rintf(dz * inv_cz);
    dx -= sc * cx;
    dy -= sc * cy;
    dz -= sc * cz;
    const float sb = rintf(dy * inv_by);
    dx -= sb * bx;
    dy -= sb * by;
    dx -= rintf(dx * inv_ax) * ax;
    return make_float3(dx, dy, dz);
  }
};

// bounds[2 b] = (centre, 0), bounds[2 b + 1] = (half extent, 0) of brick b.
__global__ void brick_bounds_kernel(const float4* __restrict__ pos,
                                    int n_bricks,
                                    float4* __restrict__ bounds) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = t / kBrick;
  const float4 p = pos[min(b, n_bricks - 1) * kBrick + t % kBrick];
  float lx = p.x, ly = p.y, lz = p.z, hx = p.x, hy = p.y, hz = p.z;
  for (int o = kBrick / 2; o > 0; o >>= 1) {
    lx = fminf(lx, __shfl_xor_sync(kFull, lx, o, kBrick));
    ly = fminf(ly, __shfl_xor_sync(kFull, ly, o, kBrick));
    lz = fminf(lz, __shfl_xor_sync(kFull, lz, o, kBrick));
    hx = fmaxf(hx, __shfl_xor_sync(kFull, hx, o, kBrick));
    hy = fmaxf(hy, __shfl_xor_sync(kFull, hy, o, kBrick));
    hz = fmaxf(hz, __shfl_xor_sync(kFull, hz, o, kBrick));
  }
  if (b < n_bricks && t % kBrick == 0) {
    bounds[2 * b] =
        make_float4(0.5f * (lx + hx), 0.5f * (ly + hy), 0.5f * (lz + hz), 0);
    bounds[2 * b + 1] =
        make_float4(0.5f * (hx - lx), 0.5f * (hy - ly), 0.5f * (hz - lz), 0);
  }
}

struct Params {
  float alpha, krf, crf, rs, inv_w, inv_cut6;
  int mode, use_switch;
};

// The modes (ops/tile_pairs.py MODE_*). LJPME's terms live in an
// instantiation of their own (Ljpme = true), so the main path's kernel
// carries none of their code; the Ewald and reaction-field modes share
// the other one and branch at run time: an instantiation of the Ewald
// mode alone, the reaction field compiled out, is scheduled otherwise
// and ran 15 % slower (0.1415 against 0.1232 ms at 24,000 atoms on an
// H100 80GB HBM3 at 700 W, kernel_lab.py variants).
constexpr int kModeEwald = 0, kModeRf = 1, kModeLjpme = 2;

// LJPME's share of c6/r^6 left to the direct space and the factor its
// derivative takes, at x = (alpha_LJ r)^2: g = 1 - e^-x (1 + x + x^2/2),
// h = g - e^-x x^3/6 (ops/pairs.py:dispersion_complement). Both cancel at
// small x, but their error stays that of float32 on 1, so c6/r^6 g errs
// by no more than the Lennard-Jones terms' own rounding.
__device__ __forceinline__ void dispersion_complement(float x, float* g,
                                                      float* h) {
  const float ex = expf(-x);
  const float p = 1.0f + x + 0.5f * x * x;
  *g = 1.0f - ex * p;
  *h = 1.0f - ex * (p + x * x * x * (1.0f / 6.0f));
}

// Adds the pair terms of row atom (pi, qi) and partner qj at displacement
// d (r2 = |d|^2) to the lane's sums.
template <bool Ljpme>
__device__ __forceinline__ void add_pair(const Params& pr, float4 qi,
                                         float4 qj, float4 d, float* fx,
                                         float* fy, float* fz, float* e) {
  const float two_over_sqrt_pi = 1.1283791670955126f;
  const float r2s = fmaxf(d.w, 2e-6f);
  const float inv_r = rsqrtf(r2s);
  const float inv_r2 = inv_r * inv_r;
  const float sig = qi.y + qj.y;
  const float eps4 = qi.z * qj.z;
  const float s2 = sig * sig * inv_r2;
  const float s6 = s2 * s2 * s2;
  const float es6 = eps4 * s6;
  float de_lj = -3.0f * es6 * (2.0f * s6 - 1.0f) * inv_r2;
  float e_lj = es6 * (s6 - 1.0f);
  if (pr.use_switch) {
    const float rr = r2s * inv_r;
    const float t = fminf(fmaxf((rr - pr.rs) * pr.inv_w, 0.0f), 1.0f);
    const float t2 = t * t;
    const float sw = 1.0f - t2 * t * (10.0f - 15.0f * t + 6.0f * t2);
    const float om = 1.0f - t;
    const float dsw = (-30.0f * t2 * om * om * pr.inv_w) * (0.5f * inv_r);
    de_lj = de_lj * sw + e_lj * dsw;
    e_lj = e_lj * sw;
  }
  if constexpr (Ljpme) {
    // the dispersion grid's complement c6g g / r^6 (krf holds alpha_LJ^2)
    // and the energy-only shifts at the cutoff (crf holds the grid
    // complement's; the Lennard-Jones one is 4 eps s6c (1 - s6c))
    const float c6g = qi.w * qj.w;
    float g, h;
    dispersion_complement(pr.krf * r2s, &g, &h);
    const float coef = c6g * inv_r2 * inv_r2 * inv_r2;
    e_lj += coef * g;
    de_lj -= 3.0f * coef * h * inv_r2;
    const float sig2 = sig * sig;
    const float s6c = sig2 * sig2 * sig2 * pr.inv_cut6;
    e_lj += eps4 * s6c * (1.0f - s6c) + pr.crf * c6g;
  }
  const float qq = qi.x * qj.x;
  float de_c, e_c;
  if (pr.mode != kModeRf) {  // Ewald direct space
    const float ar = pr.alpha * (r2s * inv_r);
    const float ex = expf(-ar * ar);
    const float erfc_ar = erfc_hastings(ar, ex);
    de_c = -qq * (erfc_ar * inv_r2 + two_over_sqrt_pi * pr.alpha * ex * inv_r) *
           (0.5f * inv_r);
    e_c = qq * inv_r * erfc_ar;
  } else {  // reaction field
    de_c = qq * (-0.5f * inv_r2 * inv_r + pr.krf);
    e_c = qq * (inv_r + pr.krf * r2s - pr.crf);
  }
  const float dedr2 = de_lj + de_c;
  *fx -= 2.0f * dedr2 * d.x;
  *fy -= 2.0f * dedr2 * d.y;
  *fz -= 2.0f * dedr2 * d.z;
  *e += e_lj + e_c;
}

// The derivative instantiations (Deriv = true) sweep the same pairs and
// add, in place of a pair's energy and force, the derivative of its energy
// in a global parameter lambda at fixed positions, from par and dpar, the
// parameters' derivatives in lambda in par's layout: dE/dqq dqq + dE/dsig
// dsig + dE/deps4 deps4 (+ dE/dc6g dc6g for LJPME), dqq = dq_i q_j + q_i
// dq_j and so on. They run between steps only; the energy-and-force
// instantiations carry none of their code.
template <bool Ljpme>
__device__ __forceinline__ void add_pair_deriv(const Params& pr, float4 qi,
                                               float4 dqi, float4 qj,
                                               float4 dqj, float4 d,
                                               float* acc) {
  const float r2s = fmaxf(d.w, 2e-6f);
  const float inv_r = rsqrtf(r2s);
  const float inv_r2 = inv_r * inv_r;
  const float sig = qi.y + qj.y;
  const float dsig = dqi.y + dqj.y;
  const float eps4 = qi.z * qj.z;
  const float deps4 = dqi.z * qj.z + qi.z * dqj.z;
  const float s2 = sig * sig * inv_r2;
  const float s6 = s2 * s2 * s2;
  // a pair whose sigma no offset moves takes no 0 / 0 at sigma 0
  const float dsig_sig = dsig != 0.0f ? dsig / sig : 0.0f;
  float d_lj = deps4 * s6 * (s6 - 1.0f) +
               eps4 * 6.0f * s6 * (2.0f * s6 - 1.0f) * dsig_sig;
  if (pr.use_switch) {
    const float rr = r2s * inv_r;
    const float t = fminf(fmaxf((rr - pr.rs) * pr.inv_w, 0.0f), 1.0f);
    const float t2 = t * t;
    d_lj *= 1.0f - t2 * t * (10.0f - 15.0f * t + 6.0f * t2);
  }
  if constexpr (Ljpme) {
    const float dc6g = dqi.w * qj.w + qi.w * dqj.w;
    float g, h;
    dispersion_complement(pr.krf * r2s, &g, &h);
    d_lj += dc6g * (inv_r2 * inv_r2 * inv_r2 * g + pr.crf);
    const float sig2 = sig * sig;
    const float s6c = sig2 * sig2 * sig2 * pr.inv_cut6;
    d_lj += deps4 * s6c * (1.0f - s6c) +
            eps4 * (6.0f * s6c - 12.0f * s6c * s6c) * dsig_sig;
  }
  const float dqq = dqi.x * qj.x + qi.x * dqj.x;
  float e_c;
  if (pr.mode != kModeRf) {
    const float ar = pr.alpha * (r2s * inv_r);
    e_c = inv_r * erfc_hastings(ar, expf(-ar * ar));
  } else {
    e_c = inv_r + pr.krf * r2s - pr.crf;
  }
  *acc += d_lj + dqq * e_c;
}

// consts: alpha, rc^2, krf, crf, ax, bx, by, cx, cy, cz, 1/ax, 1/by, 1/cz,
//         switch distance, 1/(rc - switch distance), 1/rc^6 (LJPME; else 0)
template <bool Ljpme, bool Deriv>
__global__ void __launch_bounds__(32 * kWarps)
nonbonded_tiles_kernel(const float4* __restrict__ pos,
                       const float4* __restrict__ par,
                       const float4* __restrict__ dpar,
                       const int* __restrict__ cand,
                       const int* __restrict__ count,
                       const int* __restrict__ words,
                       const float* __restrict__ consts,
                       const float4* __restrict__ bounds, int max_cand,
                       int exc_cap, int mode, int use_switch,
                       float4* __restrict__ out) {
  __shared__ float4 queue_d[kWarps][kQueue];  // (dx, dy, dz, r^2)
  __shared__ int queue_j[kWarps][kQueue];
  __shared__ int kept_b[kWarps][32];        // a chunk's surviving bricks
  __shared__ unsigned kept_w[kWarps][32];   // and their exclusion words
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int i = blockIdx.x * kWarps + warp;  // n_pad is a multiple of 16
  const int r = i / kBrick;
  float4* qd = queue_d[warp];
  int* qj = queue_j[warp];
  int* kb = kept_b[warp];
  unsigned* kw = kept_w[warp];
  const int l = lane % kBrick, half = lane / kBrick;
  const unsigned below = (1u << lane) - 1u;

  const float rc2 = consts[1];
  const Box box{consts[4], consts[5], consts[6], consts[7], consts[8],
                consts[9], consts[10], consts[11], consts[12]};
  const Params pr{consts[0], consts[2], consts[3], consts[13], consts[14],
                  consts[15], mode, use_switch};
  // a brick within these half extents takes its centre's image shift for
  // every pair inside the cutoff; a wider one is never culled
  const float rc = sqrtf(rc2);
  const float lim_x = 0.5f * box.ax - rc - kCullSlack;
  const float lim_y = 0.5f * box.by - rc - kCullSlack;
  const float lim_z = 0.5f * box.cz - rc - kCullSlack;
  const float reach2 = (rc + kCullSlack) * (rc + kCullSlack);

  const float4 pi = pos[i];
  const float4 qi = par[i];
  float4 dqi;
  if constexpr (Deriv) dqi = dpar[i];
  float fx = 0.f, fy = 0.f, fz = 0.f, e = 0.f;
  int queued = 0;
  const int n_cand = count[r];
  for (int k0 = 0; k0 < n_cand; k0 += 32) {
    const int k = k0 + lane;
    int cb = 0;
    unsigned word = 0u;
    bool keep = false;
    if (k < n_cand) {
      cb = cand[r * max_cand + k];
      const float4 c = bounds[2 * cb], h = bounds[2 * cb + 1];
      const float3 d = box.image(pi.x - c.x, pi.y - c.y, pi.z - c.z);
      const float gx = fmaxf(fabsf(d.x) - h.x, 0.0f);
      const float gy = fmaxf(fabsf(d.y) - h.y, 0.0f);
      const float gz = fmaxf(fabsf(d.z) - h.z, 0.0f);
      // NaN keeps the brick, so a non-finite position poisons the forces
      keep = !(gx * gx + gy * gy + gz * gz >= reach2) || h.x > lim_x ||
             h.y > lim_y || h.z > lim_z;
      if (k < exc_cap) word = static_cast<unsigned>(words[i * exc_cap + k]);
    }
    // the surviving bricks, compacted in order
    const unsigned live = __ballot_sync(kFull, keep);
    const int n_live = __popc(live);
    if (keep) {
      const int at = __popc(live & below);
      kb[at] = cb;
      kw[at] = word;
    }
    __syncwarp();
    // two surviving bricks a round, 16 lanes each
    for (int s0 = 0; s0 < n_live; s0 += 2) {
      const int s = min(s0 + half, n_live - 1);
      const int j = kb[s] * kBrick + l;
      const float4 pj = pos[j];
      const float3 d = box.image(pi.x - pj.x, pi.y - pj.y, pi.z - pj.z);
      // r^2 rounded product by product and sum by sum, as the plain
      // version and the JAX package take it: the cutoff test r^2 < rc^2
      // must decide each pair as they do. A contracted (FMA) r^2 moves
      // pairs across the cutoff, where the reaction field's force is not
      // zero (qq (1/rc^2 - 2 krf rc), ~0.9 kJ/mol/nm for an O-H pair at
      // 1.0 nm): a whole pair's force of difference
      const float4 dd = make_float4(
          d.x, d.y, d.z,
          __fadd_rn(__fadd_rn(__fmul_rn(d.x, d.x), __fmul_rn(d.y, d.y)),
                    __fmul_rn(d.z, d.z)));
      const bool hit = s0 + half < n_live && !(dd.w >= rc2) &&
                       !((kw[s] >> l) & 1u);
      const unsigned hits = __ballot_sync(kFull, hit);
      if (hit) {
        const int slot = queued + __popc(hits & below);
        qd[slot] = dd;
        qj[slot] = j;
      }
      queued += __popc(hits);
      if (queued >= 32) {
        __syncwarp();
        if constexpr (Deriv) {
          add_pair_deriv<Ljpme>(pr, qi, dqi, par[qj[lane]], dpar[qj[lane]],
                                qd[lane], &e);
        } else {
          add_pair<Ljpme>(pr, qi, par[qj[lane]], qd[lane], &fx, &fy, &fz,
                          &e);
        }
        __syncwarp();  // every lane has read its slot
        if (lane < queued - 32) {
          qd[lane] = qd[32 + lane];
          qj[lane] = qj[32 + lane];
        }
        queued -= 32;
        __syncwarp();
      }
    }
    __syncwarp();  // the compacted list is read before the next chunk's
  }
  __syncwarp();
  if (lane < queued) {
    if constexpr (Deriv) {
      add_pair_deriv<Ljpme>(pr, qi, dqi, par[qj[lane]], dpar[qj[lane]],
                            qd[lane], &e);
    } else {
      add_pair<Ljpme>(pr, qi, par[qj[lane]], qd[lane], &fx, &fy, &fz, &e);
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    fx += __shfl_xor_sync(kFull, fx, o);
    fy += __shfl_xor_sync(kFull, fy, o);
    fz += __shfl_xor_sync(kFull, fz, o);
    e += __shfl_xor_sync(kFull, e, o);
  }
  if (lane == 0) out[i] = make_float4(fx, fy, fz, e);
}

}  // namespace

namespace {

template <bool Deriv>
int launch_tiles(const void* pos, const void* par, const void* dpar,
                 const void* cand, const void* count, const void* words,
                 const void* consts, int n_bricks, int max_cand, int exc_cap,
                 int mode, int use_switch, void* bounds, void* out,
                 void* stream) {
  if (n_bricks > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* p = static_cast<const float4*>(pos);
    auto* bb = static_cast<float4*>(bounds);
    const int threads = 256;
    brick_bounds_kernel<<<(n_bricks * kBrick + threads - 1) / threads,
                          threads, 0, s>>>(p, n_bricks, bb);
    if (mode < kModeEwald || mode > kModeLjpme) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    auto* kernel = mode == kModeLjpme ? nonbonded_tiles_kernel<true, Deriv>
                                      : nonbonded_tiles_kernel<false, Deriv>;
    kernel<<<n_bricks * kBrick / kWarps, 32 * kWarps, 0, s>>>(
        p, static_cast<const float4*>(par), static_cast<const float4*>(dpar),
        static_cast<const int*>(cand), static_cast<const int*>(count),
        static_cast<const int*>(words), static_cast<const float*>(consts),
        bb, max_cand, exc_cap, mode, use_switch, static_cast<float4*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Scratch: bounds (2 n_bricks float4).
extern "C" int omm_nonbonded_tiles(const void* pos, const void* par,
                                   const void* cand, const void* count,
                                   const void* words, const void* consts,
                                   int n_bricks, int max_cand, int exc_cap,
                                   int mode, int use_switch, void* bounds,
                                   void* out, void* stream) {
  return launch_tiles<false>(pos, par, nullptr, cand, count, words, consts,
                             n_bricks, max_cand, exc_cap, mode, use_switch,
                             bounds, out, stream);
}

// out[i].w: row atom i's sum of dE/dlambda over its partners (x, y, z 0).
extern "C" int omm_nonbonded_tiles_deriv(
    const void* pos, const void* par, const void* dpar, const void* cand,
    const void* count, const void* words, const void* consts, int n_bricks,
    int max_cand, int exc_cap, int mode, int use_switch, void* bounds,
    void* out, void* stream) {
  return launch_tiles<true>(pos, par, dpar, cand, count, words, consts,
                            n_bricks, max_cand, exc_cap, mode, use_switch,
                            bounds, out, stream);
}
