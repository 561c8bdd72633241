// Device code shared by the port's perspective-warp kernels (split_warp.cu,
// banded_warp.cu): the bilinear hat taps, the residual homography's inverse
// row and column maps, and the two-pass (Catmull-Smith) resample of one
// output pixel. It is the CUDA counterpart of the TPU kernels' shared body
// pose_tpu/ops/warp_pallas.py::_banded_core (:142) and of _warp_kernel
// (:50), which compute the same function over full scanlines.
//
// The float expressions keep the reference's operation order with the _rn
// intrinsics (no FMA contraction), so each kernel agrees with its plain
// PyTorch version to f32 rounding of the 2-term sums.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace warp_common {

__device__ __forceinline__ float tri(float d) {
  return fmaxf(0.f, __fsub_rn(1.f, fabsf(d)));
}

template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  if (BF16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

// The two taps of a hat kernel centred at t over integer positions
// [0, n) that also satisfy i <= lim. Returns the first tap index; w[k] is
// the weight of tap i0 + k (zero for a tap outside the range). A t outside
// (-1, n), infinite or NaN has no tap in range.
__device__ __forceinline__ int hat_taps(float t, int n, float lim,
                                        float w[2]) {
  w[0] = 0.f;
  w[1] = 0.f;
  if (!(t > -1.f && t < (float)n)) return 0;
  const float f0 = floorf(t);
  const int i0 = (int)f0;
  if (i0 >= 0 && f0 <= lim) w[0] = tri(__fsub_rn(t, f0));
  const float f1 = __fadd_rn(f0, 1.f);
  if (i0 + 1 < n && f1 <= lim) w[1] = tri(__fsub_rn(t, f1));
  return i0;
}

template <typename T>
__device__ __forceinline__ float load_px(const T* p) {
  return (float)(*p);
}

template <>
__device__ __forceinline__ float load_px<uint8_t>(const uint8_t* p) {
  return (float)__ldg(p);
}

template <>
__device__ __forceinline__ float load_px<float>(const float* p) {
  return __ldg(p);
}

// Inverse row map Y(v, xs) of the out->src homography h (row-major 3x3),
// warp_pallas.py:159-165, in the reference's operation order.
__device__ __forceinline__ float row_map(const float* h, float vf,
                                         float xf) {
  const float denom_u = __fsub_rn(h[0], __fmul_rn(h[6], xf));
  const float num = __fsub_rn(
      __fsub_rn(__fmul_rn(xf, __fadd_rn(__fmul_rn(h[7], vf), h[8])),
                __fmul_rn(h[1], vf)),
      h[2]);
  const float u_of = __fdiv_rn(num, denom_u);
  const float w_h = __fadd_rn(
      __fadd_rn(__fmul_rn(h[6], u_of), __fmul_rn(h[7], vf)), h[8]);
  return __fdiv_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(h[3], u_of), __fmul_rn(h[4], vf)), h[5]),
      w_h);
}

// Column map X(u, v) (warp_pallas.py:195-199).
__device__ __forceinline__ float col_map(const float* h, float uf,
                                         float vf) {
  const float w_x = __fadd_rn(
      __fadd_rn(__fmul_rn(h[6], uf), __fmul_rn(h[7], vf)), h[8]);
  return __fdiv_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(h[0], uf), __fmul_rn(h[1], vf)), h[2]),
      w_x);
}

// The two-pass warp at output pixel (u, v), all C channels:
//
//   pass 1   I[c, v, xs] = sum_sy tri(Y(v, xs) - sy) [sy <= lim_y] S[c, sy, xs]
//   pass 2   acc[c]      = sum_sx tri(X(u, v) - sx) [sx <= lim_x] I[c, v, sx]
//
// over the source grid [0, n_y) x [0, n_x), with zero weight for a
// non-finite Y or X (the -1e9 of the TPU kernels). Every hat row has two
// nonzero taps, so each sum is a 2-tap interpolation: pass 2 needs two
// pass-1 values, each of two source pixels. `two_pass_taps` computes the
// taps and weights (the maps' divisions), `two_pass_apply` the sums;
// `two_pass` is the two in turn. `src(sy, sx, val)` fills the C values of
// the source pixel (sy, sx): a canvas read for the banded and
// full-scanline kernels, the stage-A resample for the split kernel.
struct TwoPassTaps {
  int sx0;           // pass 2's first tap; wx[k] the weight of sx0 + k
  float wx[2];
  int sy0[2];        // pass 1's first tap at column sx0 + k
  float wy[2][2];    // (zero where wx[k] is zero)
};

__device__ __forceinline__ void two_pass_taps(const float* h, int n_y,
                                              int n_x, float lim_y,
                                              float lim_x, int u, int v,
                                              TwoPassTaps& tp) {
  const float vf = (float)v;
  tp.sx0 = hat_taps(col_map(h, (float)u, vf), n_x, lim_x, tp.wx);
#pragma unroll
  for (int kx = 0; kx < 2; ++kx) {
    tp.sy0[kx] = 0;
    tp.wy[kx][0] = 0.f;
    tp.wy[kx][1] = 0.f;
    if (tp.wx[kx] == 0.f) continue;
    tp.sy0[kx] = hat_taps(row_map(h, vf, (float)(tp.sx0 + kx)), n_y, lim_y,
                          tp.wy[kx]);
  }
}

template <int C, typename Src>
__device__ __forceinline__ void two_pass_apply(const TwoPassTaps& tp,
                                               const Src& src, float acc[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
#pragma unroll
  for (int kx = 0; kx < 2; ++kx) {
    if (tp.wx[kx] == 0.f) continue;
    const int xs = tp.sx0 + kx;
    float inter[C];
#pragma unroll
    for (int c = 0; c < C; ++c) inter[c] = 0.f;
#pragma unroll
    for (int ky = 0; ky < 2; ++ky) {
      if (tp.wy[kx][ky] == 0.f) continue;
      float a[C];
      src(tp.sy0[kx] + ky, xs, a);
#pragma unroll
      for (int c = 0; c < C; ++c)
        inter[c] = __fadd_rn(inter[c], __fmul_rn(tp.wy[kx][ky], a[c]));
    }
#pragma unroll
    for (int c = 0; c < C; ++c)
      acc[c] = __fadd_rn(acc[c], __fmul_rn(tp.wx[kx], inter[c]));
  }
}

template <int C, typename Src>
__device__ __forceinline__ void two_pass(const float* h, int n_y, int n_x,
                                         float lim_y, float lim_x, int u,
                                         int v, const Src& src,
                                         float acc[C]) {
  TwoPassTaps tp;
  two_pass_taps(h, n_y, n_x, lim_y, lim_x, u, v, tp);
  two_pass_apply<C>(tp, src, acc);
}

}  // namespace warp_common
