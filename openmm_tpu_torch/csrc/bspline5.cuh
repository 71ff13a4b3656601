// Order-5 cardinal B-spline weights and their derivatives for one axis, by
// the recursion of openmm_tpu/ops/pme_zslab.py bspline_w_dw: weight j of an
// atom belongs to grid index floor(u) + j - 4, and dw = dM/du.
#pragma once

__device__ __forceinline__ void bspline5(float t, float w[5], float dw[5]) {
  float a[5] = {1.0f - t, t, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 3; k <= 4; ++k) {
    const float div = 1.0f / static_cast<float>(k - 1);
    float nw[5];
    nw[k - 1] = div * t * a[k - 2];
#pragma unroll
    for (int j = 1; j <= k - 2; ++j) {
      nw[k - 1 - j] = div * ((t + j) * a[k - 2 - j] + (k - j - t) * a[k - 1 - j]);
    }
    nw[0] = div * (1.0f - t) * a[0];
#pragma unroll
    for (int j = 0; j < k; ++j) a[j] = nw[j];
  }
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    dw[j] = (j >= 1 ? a[j - 1] : 0.0f) - (j <= 3 ? a[j] : 0.0f);
  }
  const float div = 0.25f;
  w[4] = div * t * a[3];
#pragma unroll
  for (int j = 1; j <= 3; ++j) {
    w[4 - j] = div * ((t + j) * a[3 - j] + (5 - j - t) * a[4 - j]);
  }
  w[0] = div * (1.0f - t) * a[0];
}

// Fractional grid coordinate of one atom on one axis: base index and the
// five weights (and derivatives). binv is the row-major inverse box. The
// fractional coordinate f and u = n f are rounded after each product and
// sum, never fused into an FMA, as the plain version
// (geometry.to_fractional) rounds them: in a triclinic box u = n f
// amplifies a last-bit difference of f to ~3e-6 of a cell at 56 cells,
// which moves the weights by as much.
__device__ __forceinline__ void grid_axis(float x, float y, float z,
                                          const float* binv, int axis,
                                          int size, int* base, float w[5],
                                          float dw[5]) {
  float f = __fadd_rn(__fadd_rn(__fmul_rn(x, binv[axis]),
                                __fmul_rn(y, binv[3 + axis])),
                      __fmul_rn(z, binv[6 + axis]));
  f -= floorf(f);
  const float u = __fmul_rn(f, static_cast<float>(size));
  const float b = floorf(u);
  *base = static_cast<int>(b);
  bspline5(u - b, w, dw);
}
