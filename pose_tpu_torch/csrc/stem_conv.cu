// The ResNet stem convolution (7x7, stride 2, padding 3, Cin -> 64) for
// Hopper (sm_90a): the CUDA port of the TPU kernel of
// pose_tpu/ops/stem_pallas.py:
//
//   stem_conv_kernel  <- _stem_kernel (:63, entry stem_conv_fwd :124)
//
//   out[b, oy, ox, co] = sum over (ci, kh, kw) of
//                        x[b, ci, 2 oy + kh - 3, 2 ox + kw - 3] * w[kh, kw, ci, co]
//
// with bf16 inputs and weights, each product exact in f32 and the sum
// accumulated in f32 (taps outside the image are zero), written NHWC as f32
// or as bf16 (the f32 sum rounded once, so the bf16 output equals the f32
// output cast to bf16 bit for bit). Cin is 1, 3 or 4: the depth, RGB and
// RGB + bbox-mask stems.
//
// The TPU kernel reads a zero-padded planar copy, deinterleaves row and
// column parity with 0/1 selection dots and copies 196 patch rows, all to
// avoid Mosaic's misaligned relayouts. None of that carries over. Here the
// conv is an implicit GEMM on the tensor cores: M = the output pixels,
// N = 64 output channels, K = the taps in the order (kh, kw, ci) with kw
// padded to 8 and ci to 4 (K = 7 * 8 * 4 = 224 for Cin 3 and 4) or, for
// Cin 1, (kh, kw) with kh and kw padded to 8 (K = 64). A k-step of 16 then
// reads 4 neighbouring pixels' 4 channels (or 8 neighbouring pixels of 2
// rows), and every padded term is zero in both operands: zero in the
// packed weight (ops/stem.pack_weight), and masked to zero in the A
// fragment (kw = 7, kh = 7) or staged as zero (ci = 3 of Cin 3), never a
// value read from outside the tensor.
//
// One block takes 1024 consecutive output pixels of one image (NHWC order,
// so its output is one contiguous run of memory). It stages the packed
// weight in shared memory as the B operand of
// wgmma.mma_async.m64n64k16.f32.bf16.bf16 (K-major 8 x 8 core matrices,
// read by the tensor cores through a descriptor), and the input rows
// under its pixels (2 * span + 8 rows for
// an output span of `span` rows, 8 when 1024 pixels of 129-wide rows) as
// bf16, channels padded to 4, with the 3-pixel zero border applied in the
// index math. The input is read through its four strides, so the model's
// channels_last tensor and the interior of `pad_planar`'s array both work
// without a copy. No column-parity split is needed: in the A-fragment
// layout the 32 lanes of a warp read 32 consecutive 32-bit words (pixel
// 2 ox + kw, channel pair) for every k-step, which no bank serves twice.
// The staging reads four pixels (or 16-byte weight vectors) per thread
// before it stores any, so their latencies overlap. Each warp computes 32
// pixels x 64 channels per round: two wgmma per k-step, each of its
// warpgroup's 4 x 16 pixels with A from registers (the m16n8k16 fragment
// layout), one k-step in flight while the next one's A is read. Then it
// writes a bf16 output through a padded per-warp
// tile in shared memory as 16-byte vectors (full 128-byte lines, one
// pixel each), and an f32 output straight from the fragments (4 lanes
// fill each 32-byte sector).
//
// Bound on the card, ResNet-50's Cin 4 stem at batch 64, 257^2: 33.8 MB of
// bf16 input and 136.3 MB of bf16 (272.6 MB of f32) output, 0.05 ms
// (0.09 ms) at 3.35 TB/s, against 26.7 GFLOP, 0.027 ms at the 989 TFLOP/s
// bf16 tensor rate (30.5 GFLOP with the K padding): the output writes
// bound it. The first version summed on the CUDA cores (f32 FMA, 0.40 ms at
// best for the arithmetic alone) and took 1.17 ms; an mma.sync form 0.12
// ms, its k-loop at ~2/3 of the tensor rate; this one about 0.11 ms
// (PERF.md). What holds it there (tools/kernel_ablation.py): its three
// parts run one after another, not overlapped: the output writes alone
// take about the byte bound (0.046 ms), the staging and the k-loop (now at
// the tensor rate) about 0.031 ms each. Overlapping them (asynchronous
// staging of the next rows, stores behind the next round's wgmma) is the
// next step. The tensor cores sum each k-group in
// their own order (aligning the products to the largest exponent), so the
// result is within K * 2^-23 of sum |terms| of the plain f32 conv, no
// longer equal to it bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCout = 64;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMT = 2;                       // m16 tiles per warp round
constexpr int kChunk = 16 * kMT;             // output pixels per warp round
constexpr int kRounds = 4;
constexpr int kBlockPx = kWarps * kChunk * kRounds;   // 1024
constexpr int kNT = kCout / 8;               // n8 tiles
constexpr int kMaxSmem = 232448;             // an H100 block's dynamic limit
constexpr int kLoads = 4;                    // input pixels in flight

// K order (kh, kw, ci): KH x 8 x CP, a multiple of 16
template <int CIN>
struct Layout {
  static constexpr int CP = CIN == 1 ? 1 : 4;
  static constexpr int KH = CIN == 1 ? 8 : 7;
  static constexpr int K = KH * 8 * CP;
  static constexpr int KSTEPS = K / 16;
};

// padded row of the per-warp output tile, in elements: 16-byte aligned,
// and no bank serves two lanes of one fragment store (bf16 or f32)
constexpr int kStageStride = kCout + 8;

__host__ __device__ inline int span_max(int ow) {
  return (kBlockPx + ow - 2) / ow;
}

// the staged input rows' bytes, rounded up to 1024 so that the weight
// after them is aligned for wgmma's descriptors
__host__ __device__ inline size_t x_region(int nrow, int ncol, int cp) {
  return ((size_t)nrow * ncol * cp * 2 + 1023) / 1024 * 1024;
}

// wgmma.mma_async m64n64k16, bf16 in, f32 sums: A (this warp's 16 rows x
// 16 k, the m16n8k16 A-fragment layout) from registers, B (16 k x 64 n)
// from shared memory through `desc`; d the warp's 16 x 64 accumulators in
// the m16n8 C-fragment layout of each n8 tile (d[4 j + e] = tile j's e).
__device__ __forceinline__ void wgmma64(float d[32], const uint32_t a[4],
                                        uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// keeps the compiler from moving accesses of r across the wgmma fences
__device__ __forceinline__ void pin(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

__device__ __forceinline__ void pin(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the shared-memory matrix descriptor of B at shared address `addr`:
// K-major, no swizzle, 8 x 8 core matrices of 128 contiguous bytes, the
// two of a k-step 128 bytes apart (leading offset), the eight n-groups 256
// bytes apart (stride offset)
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)(128 >> 4) << 16)
         | ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void put2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <int CIN, typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
stem_conv_kernel(const __nv_bfloat16* __restrict__ x, long long sb,
                 long long sc, long long sh, long long sw, int vec8,
                 const __nv_bfloat16* __restrict__ w, OutT* __restrict__ out,
                 int H, int W, int OH, int OW) {
  using L = Layout<CIN>;
  constexpr int CP = L::CP;
  constexpr int SS = kStageStride;
  extern __shared__ uint4 smem16[];
  const int ncol = 2 * OW + 6;                    // staged column c = ix + 3
  const int nrow = 2 * span_max(OW) + 8;
  const int row_words = ncol * CP / 2;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem16);
  const uint32_t* xw = reinterpret_cast<const uint32_t*>(smem16);
  const size_t x_bytes = x_region(nrow, ncol, CP);
  unsigned short* wsh = reinterpret_cast<unsigned short*>(
      reinterpret_cast<char*>(smem16) + x_bytes);
  OutT* stage = reinterpret_cast<OutT*>(wsh + L::K * kCout);

  const int b = blockIdx.y;
  const int npx = OH * OW;
  const int p0 = blockIdx.x * kBlockPx;
  const int p1 = min(p0 + kBlockPx, npx);
  const int oy_first = p0 / OW;
  const int tid = threadIdx.x;

  // the packed (K, 64) weight as wgmma's B operand: k-step s at 2048 s
  // bytes, its core matrix (k half h, n-group j) at + 256 j + 128 h, row n
  // % 8 of it at + 16 (n % 8), holding k % 8 = 0..7. Read as 16-byte
  // vectors (8 columns of one row), each scattered to 8 core-matrix rows.
  constexpr int kW4 = L::K * kCout / 8;
  for (int i0 = 0; i0 < kW4; i0 += kLoads * kThreads) {
    uint4 v[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int i = i0 + k * kThreads + tid;
      if (i < kW4) v[k] = __ldg(reinterpret_cast<const uint4*>(w) + i);
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int i = i0 + k * kThreads + tid;
      if (i >= kW4) continue;
      const int kk = i >> 3, j = i & 7;
      const int base = (kk >> 4) * 1024 + j * 128 + ((kk >> 3) & 1) * 64
                       + (kk & 7);
      const unsigned short* e = reinterpret_cast<const unsigned short*>(&v[k]);
#pragma unroll
      for (int g = 0; g < 8; ++g) wsh[base + 8 * g] = e[g];
    }
  }
  // input rows 2 oy_first - 3 + rr, columns c - 3, zero outside the image
  // and in the padded channel: one pixel (CP channels) per item, kLoads
  // items' loads in flight per thread before their stores
  const __nv_bfloat16* xb = x + (long long)b * sb;
  const int iy0 = 2 * oy_first - 3;
  const int npix = nrow * ncol;
  for (int i0 = 0; i0 < npix; i0 += kLoads * kThreads) {
    uint2 v[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int i = i0 + k * kThreads + tid;
      const int rr = i / ncol, c = i - rr * ncol;
      const int iy = iy0 + rr, ix = c - 3;
      v[k] = make_uint2(0u, 0u);
      if (i >= npix || iy < 0 || iy >= H || ix < 0 || ix >= W) continue;
      const __nv_bfloat16* px = xb + iy * sh + ix * sw;
      if (CIN == 4 && vec8) {           // channels_last, 8-byte pixels
        v[k] = __ldg(reinterpret_cast<const uint2*>(px));
      } else {
        uint32_t e[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int ci = 0; ci < CIN; ++ci)
          e[ci] = __ldg(reinterpret_cast<const unsigned short*>(px + ci * sc));
        v[k] = make_uint2(e[0] | (e[1] << 16), e[2] | (e[3] << 16));
      }
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int i = i0 + k * kThreads + tid;
      if (i >= npix) continue;
      if (CP == 4)
        reinterpret_cast<uint2*>(xs)[i] = v[k];
      else
        reinterpret_cast<unsigned short*>(xs)[i] = (unsigned short)v[k].x;
    }
  }
  // the weight is read by wgmma through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // padded K terms: kw = 7 is the upper half of lane t = 3's pair (Cin 1)
  // or lanes t >= 2's upper registers on odd k-steps (Cin 3, 4)
  const uint32_t kw7_mask = CIN == 1 ? (t == 3 ? 0x0000ffffu : ~0u)
                                     : (t >= 2 ? 0u : ~0u);
  OutT* st = stage + warp * 16 * SS;
  OutT* ob = out + (size_t)b * npx * kCout;

  const uint64_t desc0 = b_desc((uint32_t)__cvta_generic_to_shared(wsh));
  for (int round = 0; round < kRounds; ++round) {
    // the warpgroup (4 warps) runs its rounds together: wgmma is one
    // instruction of all four; a warp past the image's end computes on
    // its last pixel and writes nothing
    if (p0 + (round * kWarps + (warp & ~3)) * kChunk >= p1) break;
    const int q0 = p0 + (round * kWarps + warp) * kChunk;
    // word offsets of the pixels of rows g and g + 8 of each m-tile
    int aoff[kMT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = min(q0 + 16 * mt + 8 * h + g, p1 - 1);
        const int oy = q / OW, ox = q - oy * OW;
        aoff[mt][h] = 2 * (oy - oy_first) * row_words
                      + (CIN == 1 ? ox : 4 * ox) + t;
      }
    float acc[kMT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[mt][j][e] = 0.f;
          pin(acc[mt][j][e]);
        }

#pragma unroll
    for (int s = 0; s < L::KSTEPS; ++s) {
      // the k-step's offset and that of its upper 8 k
      const int koff = CIN == 1 ? 2 * s * row_words
                                : (s >> 1) * row_words + 8 * (s & 1);
      const int khi = CIN == 1 ? row_words : 4;
      uint32_t a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        a[mt][0] = xw[aoff[mt][0] + koff];
        a[mt][1] = xw[aoff[mt][1] + koff];
        a[mt][2] = xw[aoff[mt][0] + koff + khi];
        a[mt][3] = xw[aoff[mt][1] + koff + khi];
        if (CIN == 1) {
          a[mt][0] &= kw7_mask;
          a[mt][1] &= kw7_mask;
          if (s == L::KSTEPS - 1) {       // kh = 7
            a[mt][2] = 0u;
            a[mt][3] = 0u;
          } else {
            a[mt][2] &= kw7_mask;
            a[mt][3] &= kw7_mask;
          }
        } else if (s & 1) {
          a[mt][2] &= kw7_mask;
          a[mt][3] &= kw7_mask;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) pin(a[mt][r]);
      }
      wgmma_fence();
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        wgmma64(&acc[mt][0][0], a[mt], desc0 + (uint64_t)(s * (2048 >> 4)));
      wgmma_commit();
      // one k-step in flight while the next one's A is read
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pin(acc[mt][j][e]);

    // out, bf16: each m-tile through the warp's padded tile, as 16-byte
    // vectors (full 128-byte lines, one pixel each); f32: each lane's
    // pairs straight from the fragments (4 lanes fill a 32-byte sector)
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int qm = q0 + 16 * mt;
      if constexpr (sizeof(OutT) == 4) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = qm + 8 * h + g;
          if (q >= p1) continue;
#pragma unroll
          for (int j = 0; j < kNT; ++j)
            put2(ob + (size_t)q * kCout + 8 * j + 2 * t,
                 acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          put2(st + g * SS + 8 * j + 2 * t, acc[mt][j][0], acc[mt][j][1]);
          put2(st + (g + 8) * SS + 8 * j + 2 * t, acc[mt][j][2],
               acc[mt][j][3]);
        }
        __syncwarp();
        const int nv = min(16, p1 - qm);
        constexpr int kVecRow = kCout * (int)sizeof(OutT) / 16;
        if (nv > 0) {
          uint4* dst = reinterpret_cast<uint4*>(ob + (size_t)qm * kCout);
          for (int v = lane; v < nv * kVecRow; v += 32) {
            const int r = v / kVecRow, cv = v - r * kVecRow;
            dst[v] = *reinterpret_cast<const uint4*>(
                st + r * SS + cv * (16 / (int)sizeof(OutT)));
          }
        }
        __syncwarp();
      }
    }
  }
}

template <int CIN, typename OutT>
size_t smem_bytes(int ow) {
  using L = Layout<CIN>;
  const int nrow = 2 * span_max(ow) + 8, ncol = 2 * ow + 6;
  return x_region(nrow, ncol, L::CP) + (size_t)L::K * kCout * 2
         + (sizeof(OutT) == 2 ? (size_t)kWarps * 16 * kStageStride * 2 : 0);
}

template <int CIN, typename OutT>
int launch(const void* x, long long sb, long long sc, long long sh,
           long long sw, const void* w, void* out, int B, int H, int W,
           cudaStream_t st) {
  const int OH = (H - 1) / 2 + 1, OW = (W - 1) / 2 + 1;
  const size_t smem = smem_bytes<CIN, OutT>(OW);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaError_t attr = cudaFuncSetAttribute(
      stem_conv_kernel<CIN, OutT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  // channels_last Cin 4 with 8-byte aligned pixels: vector loads
  const int vec8 = CIN == 4 && sc == 1 && sw == 4 && sh % 4 == 0
                   && sb % 4 == 0
                   && reinterpret_cast<uintptr_t>(x) % 8 == 0;
  const dim3 grid((OH * OW + kBlockPx - 1) / kBlockPx, B);
  stem_conv_kernel<CIN, OutT><<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), sb, sc, sh, sw, vec8,
      static_cast<const __nv_bfloat16*>(w), static_cast<OutT*>(out), H, W,
      OH, OW);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch_cin(int cin, const void* x, long long sb, long long sc,
               long long sh, long long sw, const void* w, void* out, int B,
               int H, int W, cudaStream_t st) {
  switch (cin) {
    case 1: return launch<1, OutT>(x, sb, sc, sh, sw, w, out, B, H, W, st);
    case 3: return launch<3, OutT>(x, sb, sc, sh, sw, w, out, B, H, W, st);
    case 4: return launch<4, OutT>(x, sb, sc, sh, sw, w, out, B, H, W, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x: (B, cin, H, W) bf16 read through element strides (sb, sc, sh, sw);
// w: the (K, 64) bf16 weight of ops/stem.pack_weight, contiguous and
// 16-byte aligned (K = 224 for cin 3 and 4, 64 for cin 1); out: (B, OH,
// OW, 64) contiguous, f32 or (out_bf16 != 0) bf16, OH = (H - 1) / 2 + 1,
// OW = (W - 1) / 2 + 1.
int stem_conv_launch(const void* x, long long sb, long long sc, long long sh,
                     long long sw, const void* w, void* out, int out_bf16,
                     int B, int cin, int H, int W, void* stream) {
  if (B < 1 || H < 1 || W < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return launch_cin<__nv_bfloat16>(cin, x, sb, sc, sh, sw, w, out, B, H, W,
                                     st);
  return launch_cin<float>(cin, x, sb, sc, sh, sw, w, out, B, H, W, st);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
