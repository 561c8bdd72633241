// Split perspective crop-warp for Hopper (sm_90a): the CUDA port of
// pose_tpu/ops/warp_pallas.py::_split_kernel (body :231, shared stage-B core
// _banded_core :142, entry warp_batch_split_pallas :423).
//
// What it computes (the TPU kernel's function, not its blocks). Per image b,
// with scal[b] = [R (9) | ystep ystart xstep xstart | eh ew]:
//
//   stage A  A[c, p, q] = post * sum_x  w2[q, x] * r(t1[c, p, x])
//            t1[c, p, x] =       sum_sy w1[p, sy] * r(src[sy, x, c])
//            w1[p, sy] = r(tri(ystart + p * ystep - sy) * (sy <= eh - 1))
//            w2[q, x]  = r(tri(xstart + q * xstep - x)  * (x  <= ew - 1))
//   pass 1   I[c, v, xs] = sum_sy tri(Y(v, xs) - sy) * A[c, sy, xs]
//   pass 2   out[c, v, u] = sum_sx tri(X(u, v) - sx) * I[c, v, sx]
//
// where tri(d) = max(0, 1 - |d|), r() rounds to bf16 when `bf16` is set
// (the JAX wdtype; identity for f32), Y and X are the residual
// homography's inverse row map and column map (warp_pallas.py:159-165,
// :195-199), taps of stage B span the full intermediate [0, m), and a
// non-finite Y or X gives zero weight (the -1e9 of the TPU kernel). The TPU
// kernel's band is a tiling device: where band_ok_v2 admits a batch its
// result equals this unbanded two-pass result, so callers gate as in JAX
// and the kernel needs no band.
//
// Every hat row has exactly two nonzero taps, so each sum above is a 2-tap
// interpolation: the TPU's dense MXU dots of stage A become a separable
// 2-tap resample here. The float expressions keep the reference's operation
// order with the _rn intrinsics (no FMA contraction), so the kernel agrees
// with its plain PyTorch version (warp_cuda.split_warp_plain) to f32
// rounding of the 2-term sums; with bf16 weights stage A is exact (products
// of two 8-bit mantissas are exact in f32, each sum rounds once).
//
// Bound on the card: memory. The function must read the canvas pixels under
// the stage-A taps of the intermediate pixels that stage B samples (the
// crop's footprint, clipped to the extent: part of the canvas, not all of
// it), read the scalars and write the f32 crops (64x3x257x257x4 B = 50.7 MB
// at the training shape). chip_smoke.py counts those bytes from its run's
// data. The TPU kernel keeps ~3.6 MB of f32 scratch per image in VMEM; an
// H100 block has at most 227 KB of shared memory, less than one image's
// (3, 256, 256) f32 intermediate. The first version therefore kept no
// intermediate: one thread per output pixel recomputed its 4 stage-A
// values from 16 canvas pixels (48 byte loads for RGB), each stage-A value
// about 4 times over across neighbouring pixels, and ran at 8-12 % of its
// bound. This kernel tiles the output instead: a block of 256 threads
// takes 32 x 16 output pixels of one image (2 per thread) in three phases.
//
//   1. Footprint: each thread computes its pixels' stage-B taps (col_map
//      and the two row_maps, the expressions of two_pass, kept in
//      registers for phase 3), and the block min/max-reduces the rows p and
//      columns q of the intermediate that those taps read with nonzero
//      weight.
//   2. Stage A once: if the footprint's canvas rectangle, its stage-A
//      values and its tap tables fit the budget (an argument of the entry;
//      the wrapper's fixed value), the block copies the canvas rectangle
//      into shared memory as aligned 32-bit words (coalesced; the bytes of
//      a uint8 row at any alignment), tabulates the hat taps of each row p
//      and column q once, and computes each stage-A value of the footprint
//      once, with stage_a's expression and order, into a planar f32 array.
//   3. Stage B: two_pass_apply (warp_common.cuh, the code of two_pass) on
//      the phase-1 taps, its source the shared-memory array.
//
// A tile whose footprint exceeds the budget (or is unbounded: non-finite
// scalars) computes from the canvas directly, stage_a per tap as the first
// version did: the same function in the same bits. It adds 1 to a device
// counter (`over`) that only checks read (warp_cuda.over_budget_tiles);
// warp_cuda.tile_footprints predicts it on the host. For the loader's crops
// a tile needs up to 14 KB of uint8 RGB or f32 depth canvas (30 KB of f32
// RGB), inside the wrapper's 40 KB.
//
// What bounds it now is instruction issue, not bytes (tools/kernel_ablation.py
// takes its parts out one by one, PERF.md has the numbers): the output
// writes with each block's setup come to about 1.3x the byte bound, phase
// 1's maps (five IEEE divisions a pixel) add about as much again, and
// stage A and B take the other half. A variant with fewer operations a
// pixel (pass 1's taps once per (v, xs) in a table, stage A separably)
// ran slower on the card: its extra phase and barrier cost more than the
// divisions it saved.
//
// Instantiations: RGB canvases (C = 3), uint8 or f32, with bf16 or f32
// weights; raw-depth canvases (C = 1), f32 with f32 weights only (the depth
// stream, pose_tpu/data/augment.py:193-196; stage A stays f32-exact there,
// as JAX's Precision.HIGHEST at warp_pallas.py:260-262). Stage B
// (two_pass_taps / two_pass_apply) is shared with banded_warp.cu through
// warp_common.cuh.

#include <limits.h>

#include "warp_common.cuh"

namespace {

using namespace warp_common;

constexpr int kScal = 15;
constexpr int kTW = 32, kTH = 16;            // output tile
constexpr int kBX = 32, kBY = 8;             // threads; kTH / kBY pixels each
constexpr int kPix = kTH / kBY;
constexpr int kLoads = 4;                    // canvas words in flight
// dynamic shared memory: with the static scalars and footprint, under the
// 48 KB a block takes without a function attribute
constexpr int kMaxBudget = 47 * 1024;

struct Scal {
  float h[9];
  float ystep, ystart, xstep, xstart, eh, ew;
};

__host__ __device__ inline int align16(int n) { return (n + 15) / 16 * 16; }

// Shared-memory bytes of a staged tile (warp_cuda.staged_bytes mirrors
// this): the canvas rectangle, ny rows of (nx C elem + 6) / 4 words (any
// alignment of the row's first byte) and each row's byte shift, the row
// and column tap tables (an int and two floats each), and the (C, np, nq)
// f32 stage-A array.
__host__ __device__ inline int staged_bytes(int ny, int nx, int np, int nq,
                                            int C, int elem) {
  return align16(ny * ((nx * C * elem + 6) / 4) * 4) + align16(4 * ny)
         + align16(12 * (np + nq)) + align16(4 * C * np * nq);
}

// A canvas value as stage A uses it, rounded to the weights' type: a
// uint8 value is exact in bf16, so it is only converted.
template <bool BF16>
__device__ __forceinline__ float load_rnd(uint8_t v) { return (float)v; }

template <bool BF16>
__device__ __forceinline__ float load_rnd(float v) { return rnd<BF16>(v); }

// The hat taps of stage A at intermediate row p (or column q): the first
// canvas index and the two weights, rounded as stage A uses them.
template <bool BF16>
__device__ __forceinline__ int stage_a_taps(float start, float step, int p,
                                            int n, float ext, float w[2]) {
  const float a = __fadd_rn(start, __fmul_rn((float)p, step));
  const int i0 = hat_taps(a, n, __fsub_rn(ext, 1.f), w);
  w[0] = rnd<BF16>(w[0]);
  w[1] = rnd<BF16>(w[1]);
  return i0;
}

// Stage A at intermediate pixel (p, q), all channels, given the taps:
// val[c] = A[c, p, q]. px(y, x) points at canvas pixel (y, x).
template <typename T, bool BF16, int C, typename Px>
__device__ __forceinline__ void stage_a_sum(int y0, const float wy[2],
                                            int x0, const float wx[2],
                                            float post, const Px& px,
                                            float val[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) val[c] = 0.f;
#pragma unroll
  for (int kx = 0; kx < 2; ++kx) {
    const float wxk = wx[kx];
    if (wxk == 0.f) continue;
    const int x = x0 + kx;
    float t1[C];
#pragma unroll
    for (int c = 0; c < C; ++c) t1[c] = 0.f;
#pragma unroll
    for (int ky = 0; ky < 2; ++ky) {
      const float wyk = wy[ky];
      if (wyk == 0.f) continue;
      const T* p = px(y0 + ky, x);
#pragma unroll
      for (int c = 0; c < C; ++c)
        t1[c] = __fadd_rn(t1[c], __fmul_rn(wyk, load_rnd<BF16>(p[c])));
    }
#pragma unroll
    for (int c = 0; c < C; ++c)
      val[c] = __fadd_rn(val[c], __fmul_rn(wxk, rnd<BF16>(t1[c])));
  }
#pragma unroll
  for (int c = 0; c < C; ++c) val[c] = __fmul_rn(val[c], post);
}

// Stage B's source on the direct path: stage A from the canvas in memory.
template <typename T, bool BF16, int C>
struct DirectA {
  const T* img;
  int H, W;
  const Scal& s;
  float post;
  __device__ __forceinline__ const T* operator()(int y, int x) const {
    return img + ((size_t)y * W + x) * C;
  }
  __device__ __forceinline__ void operator()(int p, int q,
                                             float val[C]) const {
    float wy[2], wx[2];
    const int y0 = stage_a_taps<BF16>(s.ystart, s.ystep, p, H, s.eh, wy);
    const int x0 = stage_a_taps<BF16>(s.xstart, s.xstep, q, W, s.ew, wx);
    stage_a_sum<T, BF16, C>(y0, wy, x0, wx, post, *this, val);
  }
};

// A canvas pixel in the staged rectangle, at row y and column x relative
// to its corner: row y's bytes start shift[y] bytes into its first word.
template <typename T, int C>
struct StagedPx {
  const unsigned char* rows;
  const int* shift;
  int pitch;
  __device__ __forceinline__ const T* operator()(int y, int x) const {
    return reinterpret_cast<const T*>(rows + y * pitch + shift[y]
                                      + x * C * (int)sizeof(T));
  }
};

// Stage B's source on the staged path: the stage-A array in shared memory.
template <int C>
struct StagedA {
  const float* a;
  int pmin, qmin, np, nq;
  __device__ __forceinline__ void operator()(int p, int q,
                                             float val[C]) const {
    const float* e = a + (p - pmin) * nq + (q - qmin);
#pragma unroll
    for (int c = 0; c < C; ++c) val[c] = e[c * np * nq];
  }
};

template <typename T, bool BF16, int C>
__global__ void __launch_bounds__(kBX * kBY, 5)
split_warp_kernel(const T* __restrict__ src, const float* __restrict__ scal,
                  float* __restrict__ out, int H, int W, int m, int out_h,
                  int out_w, float post, int budget,
                  unsigned int* __restrict__ over) {
  extern __shared__ float4 smem4[];
  __shared__ Scal s;
  __shared__ int fp[4];                      // pmin, pmax, qmin, qmax
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kBX + tx;
  const int b = blockIdx.z;
  if (tid < kScal)
    reinterpret_cast<float*>(&s)[tid] = __ldg(scal + (size_t)b * kScal + tid);
  if (tid == 0) {
    fp[0] = INT_MAX;
    fp[1] = INT_MIN;
    fp[2] = INT_MAX;
    fp[3] = INT_MIN;
  }
  __syncthreads();

  // 1. footprint: this thread's stage-B taps, then the block's range
  const float lim = (float)(m - 1);
  const int u = blockIdx.x * kTW + tx;
  TwoPassTaps tp[kPix];
  bool live[kPix];
  int pmin = INT_MAX, pmax = INT_MIN, qmin = INT_MAX, qmax = INT_MIN;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int v = blockIdx.y * kTH + ty + k * kBY;
    live[k] = u < out_w && v < out_h;
    if (!live[k]) continue;
    two_pass_taps(s.h, m, m, lim, lim, u, v, tp[k]);
#pragma unroll
    for (int kx = 0; kx < 2; ++kx) {
      if (tp[k].wx[kx] == 0.f) continue;
      qmin = min(qmin, tp[k].sx0 + kx);
      qmax = max(qmax, tp[k].sx0 + kx);
#pragma unroll
      for (int ky = 0; ky < 2; ++ky) {
        if (tp[k].wy[kx][ky] == 0.f) continue;
        pmin = min(pmin, tp[k].sy0[kx] + ky);
        pmax = max(pmax, tp[k].sy0[kx] + ky);
      }
    }
  }
  pmin = __reduce_min_sync(~0u, pmin);
  pmax = __reduce_max_sync(~0u, pmax);
  qmin = __reduce_min_sync(~0u, qmin);
  qmax = __reduce_max_sync(~0u, qmax);
  if (tx == 0) {
    atomicMin(&fp[0], pmin);
    atomicMax(&fp[1], pmax);
    atomicMin(&fp[2], qmin);
    atomicMax(&fp[3], qmax);
  }
  __syncthreads();
  pmin = fp[0];
  pmax = fp[1];
  qmin = fp[2];
  qmax = fp[3];

  const T* img = src + (size_t)b * H * W * C;
  // the canvas rectangle under the footprint's stage-A taps (ya and xa are
  // monotone in p and q), clipped to the extent and the canvas
  bool staged = true;
  int np = 0, nq = 0, ny = 0, nx = 0, ylo = 0, xlo = 0, pitch = 0;
  if (pmin <= pmax && qmin <= qmax) {
    np = pmax - pmin + 1;
    nq = qmax - qmin + 1;
    const float ya0 = __fadd_rn(s.ystart, __fmul_rn((float)pmin, s.ystep));
    const float ya1 = __fadd_rn(s.ystart, __fmul_rn((float)pmax, s.ystep));
    const float xa0 = __fadd_rn(s.xstart, __fmul_rn((float)qmin, s.xstep));
    const float xa1 = __fadd_rn(s.xstart, __fmul_rn((float)qmax, s.xstep));
    if (isfinite(ya0) && isfinite(ya1) && isfinite(xa0) && isfinite(xa1)) {
      const float ylo_f = fmaxf(floorf(fminf(ya0, ya1)), 0.f);
      const float yhi_f = fminf(fminf(floorf(fmaxf(ya0, ya1)) + 1.f,
                                      floorf(__fsub_rn(s.eh, 1.f))), H - 1.f);
      const float xlo_f = fmaxf(floorf(fminf(xa0, xa1)), 0.f);
      const float xhi_f = fminf(fminf(floorf(fmaxf(xa0, xa1)) + 1.f,
                                      floorf(__fsub_rn(s.ew, 1.f))), W - 1.f);
      ylo = (int)ylo_f;
      xlo = (int)xlo_f;
      ny = yhi_f >= ylo_f ? (int)yhi_f - ylo + 1 : 0;
      nx = xhi_f >= xlo_f ? (int)xhi_f - xlo + 1 : 0;
      if (ny == 0 || nx == 0) ny = nx = 0;
      pitch = (nx * C * (int)sizeof(T) + 6) / 4 * 4;
      staged = (long long)np * nq <= budget
               && staged_bytes(ny, nx, np, nq, C, (int)sizeof(T)) <= budget;
    } else {
      staged = false;
    }
  }

  const StagedA<C> sa{reinterpret_cast<const float*>(
                          reinterpret_cast<const unsigned char*>(smem4)
                          + align16(ny * pitch) + align16(4 * ny)
                          + align16(12 * (np + nq))),
                      pmin, qmin, np, nq};
  if (staged && np > 0) {
    // 2. the canvas rectangle as 32-bit words, the tap tables, stage A
    unsigned char* rows = reinterpret_cast<unsigned char*>(smem4);
    int* shift = reinterpret_cast<int*>(rows + align16(ny * pitch));
    int* ttab = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(shift)
                                       + align16(4 * ny));
    float* wtab = reinterpret_cast<float*>(ttab + (np + nq));
    const int words = pitch / 4, n = ny * words;
    const unsigned char* base = reinterpret_cast<const unsigned char*>(img);
    // kLoads independent loads in flight per thread, then their stores
    for (int i0 = 0; i0 < n; i0 += kLoads * kBX * kBY) {
      uint32_t val[kLoads];
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int i = i0 + k * kBX * kBY + tid;
        val[k] = 0u;
        if (i >= n) continue;
        const int r = i / words, wd = i - r * words;
        const unsigned char* row0 =
            base + ((size_t)(ylo + r) * W + xlo) * C * sizeof(T);
        const unsigned char* row1 = row0 + (size_t)nx * C * sizeof(T);
        const uint32_t* word = reinterpret_cast<const uint32_t*>(
            reinterpret_cast<uintptr_t>(row0) & ~(uintptr_t)3) + wd;
        if (reinterpret_cast<const unsigned char*>(word) < row1)
          val[k] = __ldg(word);
        if (wd == 0) shift[r] = (int)(reinterpret_cast<uintptr_t>(row0) & 3);
      }
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int i = i0 + k * kBX * kBY + tid;
        if (i < n) reinterpret_cast<uint32_t*>(rows)[i] = val[k];
      }
    }
    // the tap tables, indices relative to the rectangle's corner
    for (int i = tid; i < np + nq; i += kBX * kBY) {
      float w[2];
      ttab[i] = i < np
          ? stage_a_taps<BF16>(s.ystart, s.ystep, pmin + i, H, s.eh, w) - ylo
          : stage_a_taps<BF16>(s.xstart, s.xstep, qmin + i - np, W, s.ew, w)
                - xlo;
      wtab[2 * i] = w[0];
      wtab[2 * i + 1] = w[1];
    }
    __syncthreads();
    const StagedPx<T, C> px{rows, shift, pitch};
    float* a = const_cast<float*>(sa.a);
    for (int i = tid; i < np * nq; i += kBX * kBY) {
      const int pi = i / nq, qi = i - pi * nq;
      float val[C];
      stage_a_sum<T, BF16, C>(ttab[pi], wtab + 2 * pi, ttab[np + qi],
                              wtab + 2 * (np + qi), post, px, val);
#pragma unroll
      for (int c = 0; c < C; ++c) a[c * np * nq + i] = val[c];
    }
    __syncthreads();
  }
  if (!staged && tid == 0) atomicAdd(over, 1u);

  // 3. stage B on the phase-1 taps
  const size_t plane = (size_t)out_h * out_w;
  const DirectA<T, BF16, C> direct{img, H, W, s, post};
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    if (!live[k]) continue;
    const int v = blockIdx.y * kTH + ty + k * kBY;
    float acc[C];
    if (staged)
      two_pass_apply<C>(tp[k], sa, acc);
    else
      two_pass_apply<C>(tp[k], direct, acc);
    float* o = out + (size_t)b * C * plane + (size_t)v * out_w + u;
#pragma unroll
    for (int c = 0; c < C; ++c) o[c * plane] = acc[c];
  }
}

template <typename T, bool BF16, int C>
cudaError_t launch_typed(const void* src, const float* scal, float* out,
                         int B, int H, int W, int m, int out_h, int out_w,
                         float post, int budget, unsigned int* over,
                         cudaStream_t stream) {
  const dim3 block(kBX, kBY);
  const dim3 grid((out_w + kTW - 1) / kTW, (out_h + kTH - 1) / kTH, B);
  split_warp_kernel<T, BF16, C><<<grid, block, budget, stream>>>(
      static_cast<const T*>(src), scal, out, H, W, m, out_h, out_w, post,
      budget, over);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// src: (B, H, W, C) contiguous on device: RGB (C = 3) uint8 (src_u8 != 0)
// or float32 with bf16 or f32 weights, or raw depth (C = 1) float32 with
// f32 weights. scal: (B, 15) float32; out: (B, C, out_h, out_w) float32.
// budget: the shared-memory bytes a tile may stage, at most 47 KB (a
// launch then needs no function attribute; 0 computes every tile from the
// canvas directly); over: a device counter, plus 1 for each tile over
// the budget. Launches on `stream` and returns cudaGetLastError() of
// the launch.
int split_warp_launch(const void* src, int src_u8, const float* scal,
                      float* out, int B, int H, int W, int C, int m,
                      int out_h, int out_w, float post_scale, int bf16,
                      int budget, unsigned int* over, void* stream) {
  if (B < 1 || B > 65535 || m < 2 || out_h < 1 || out_w < 1 || budget < 0
      || budget > kMaxBudget || over == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == 1) {
    if (src_u8 || bf16) return (int)cudaErrorInvalidValue;
    return (int)launch_typed<float, false, 1>(src, scal, out, B, H, W, m,
                                              out_h, out_w, post_scale,
                                              budget, over, st);
  }
  if (C != 3) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (src_u8) {
    err = bf16 ? launch_typed<uint8_t, true, 3>(src, scal, out, B, H, W, m,
                                                out_h, out_w, post_scale,
                                                budget, over, st)
               : launch_typed<uint8_t, false, 3>(src, scal, out, B, H, W, m,
                                                 out_h, out_w, post_scale,
                                                 budget, over, st);
  } else {
    err = bf16 ? launch_typed<float, true, 3>(src, scal, out, B, H, W, m,
                                              out_h, out_w, post_scale,
                                              budget, over, st)
               : launch_typed<float, false, 3>(src, scal, out, B, H, W, m,
                                               out_h, out_w, post_scale,
                                               budget, over, st);
  }
  return (int)err;
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
