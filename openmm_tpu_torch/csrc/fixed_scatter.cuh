// Deterministic scatter-add onto a grid in 64-bit fixed point, shared by
// the two spread kernels (pme_spread.cu, kernel 2; spread_triple.cu,
// kernel 4).
//
// Each term t is rounded to the integer llrint(t * 2^e) and added to an
// int64 cell with a 64-bit integer atomicAdd (its result unused, so it
// compiles to a red.global.add.u64 that resolves in L2). Integer addition
// is associative, so the sum, and the float32 grid converted from it, has
// the same bits whatever order the warps add in.
//
// The scale. The accumulator holds, after the grid's cells, two more
// 64-bit slots: the largest per-atom sum of |terms| (a non-negative double
// kept as its bits, so an unsigned atomicMax is an order-free max) and a
// flag set when a term or such a sum is not finite. With B = n * max,
// every partial and final cell sum is at most B in magnitude, and e is the
// largest integer with B * 2^e < 2^62. The rounding adds at most 1/2 a
// term, so a cell stays a factor 2 inside int64: no finite input
// overflows. Rounding costs each term at most 2^-e / 2 <= B * 2^-62
// (2.2e-19 B). At 24,000 TIP3P atoms (B = 2.0e4, e = 47) that is 4.3e-15 a
// term; a cell of the 56^3 grid receives ~17 terms on average, so ~1e-13,
// where float32 rounds the same cell at 6e-8 of its value.
//
// A non-finite term or bound makes every cell of the output NaN: the
// poison that a blown-up position carried through the float atomics.
#pragma once

#include <cuda_runtime.h>

namespace fixed_scatter {
namespace {

constexpr unsigned kFull = 0xffffffffu;

// Slots after the grid's cells in the accumulator: the max, then the flag.
constexpr int kExtraSlots = 2;

// The exponent e of the scale 2^e for the bound n * max (see above);
// false when the bound or a term was not finite.
__device__ __forceinline__ bool scale_exponent(
    int n, const unsigned long long* extra, int* e) {
  const double bound = static_cast<double>(n) * __longlong_as_double(
      static_cast<long long>(extra[0]));
  *e = 0;
  if (bound > 0.0) {
    int k;
    frexp(bound, &k);            // bound < 2^k
    *e = min(62 - k, 960);       // 2^e and 2^-e stay normal doubles
  }
  return isfinite(bound) && extra[1] == 0ull;
}

__device__ __forceinline__ void add_term(unsigned long long* acc, long cell,
                                         double term, double scale) {
  const long long v = __double2ll_rn(term * scale);
  atomicAdd(acc + cell, static_cast<unsigned long long>(v));
}

// Record a sum of |terms| (one atom's, or the largest of a block's), or
// that it is not finite.
__device__ __forceinline__ void record_atom(unsigned long long* extra,
                                            double abs_sum) {
  if (isfinite(abs_sum)) {
    atomicMax(extra, static_cast<unsigned long long>(
        __double_as_longlong(abs_sum)));
  } else {
    atomicOr(extra + 1, 1ull);
  }
}

__device__ __forceinline__ void flag_if_nonfinite(unsigned long long* extra,
                                                  double term) {
  if (!isfinite(term)) atomicOr(extra + 1, 1ull);
}

// out[c] = acc[c] * 2^-e over the grid's `count` cells (NaN if flagged).
__global__ void to_float_kernel(const unsigned long long* __restrict__ acc,
                                long count, int n, float* __restrict__ out) {
  const long c = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= count) return;
  int e;
  if (!scale_exponent(n, acc + count, &e)) {
    out[c] = __int_as_float(0x7fc00000);
    return;
  }
  out[c] = static_cast<float>(
      static_cast<double>(static_cast<long long>(acc[c])) * ldexp(1.0, -e));
}

cudaError_t launch_to_float(const unsigned long long* acc, long count, int n,
                            float* out, cudaStream_t stream) {
  const int threads = 256;
  to_float_kernel<<<static_cast<int>((count + threads - 1) / threads),
                    threads, 0, stream>>>(acc, count, n, out);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fixed_scatter
