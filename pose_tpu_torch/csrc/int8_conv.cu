// The int8 convolution of the quantized serving forward, for Hopper
// (sm_90a), with the quantize before it and the dequant after it. It
// replaces no Pallas kernel: JAX gets this conv from XLA, inside the body
// of its conv interceptor (pose_tpu/quant.py:212-235):
//
//   xq = clip(round(x.astype(f32) / sx), -127, 127).astype(int8)
//   y  = lax.conv_general_dilated(xq, wq, preferred_element_type=acc)
//   y  = y.astype(f32) * (sx * sw) [+ bias]  ->  x.dtype
//
// and PyTorch has no CUDA int8 convolution with int32 sums. So one C call
// (quantized_conv_launch) makes two launches:
//
// 1. int8_quantize_kernel: x (bf16 or f32, any strides) -> xq int8 NHWC,
//    each element once: an IEEE division by the 0-d device scale
//    (__fdiv_rn, never a reciprocal), round half to even, clamp to +-127.
//    16 outputs a thread, vector loads where x is NHWC-contiguous. Bound
//    by bytes: x read once, xq written once.
// 2. int8_conv_kernel: the implicit GEMM
//
//      acc[m, co] = sum over (kh, kw, ci) of xq[b, ih, iw, ci] w[co, kh, kw, ci]
//
//    M = B OH OW output pixels, N = Cout, K = KH KW Cin in the order of
//    the packed weight (ops/int8_conv.pack_weight: (Npad, Kpad), row co,
//    zero-padded to multiples of 64) and of an NHWC input under one tap.
//    int8 operands, taps outside the image zero, the sums exact in int32
//    (|sum| <= 127^2 K < 2^31 for K <= 133,143; the largest here is the
//    3x3x2048 head's 18,432), then the epilogue in the order the plain
//    chain rounds: int32 -> f32 (RN) [-> bf16 -> f32 when the accumulator
//    is bf16, as y.to(torch.bfloat16) does], __fmul_rn by scale[co],
//    __fadd_rn of bias[co], the RN cast to x's dtype. Written NHWC. The
//    products are separate roundings on purpose: nvcc's default -fmad=true
//    would contract y * scale + bias into one FMA and change bits.
//    int8_conv_launch runs the same kernel with int32 out and no epilogue
//    math: the exact-sum form the checks and the yardstick use.
//
// What bounds it on the card: the int8 tensor rate, 1,979 TOP/s dense (2
// ops a multiply-add), against the bytes of x read once, the int8 weight
// read once and the output written once at 3.35 TB/s. ResNet-50's layer4
// 3x3 convs and the heads are above the balance point, the 1x1 convs
// near it. The design for that:
// - wgmma.mma_async m64nNk32 s8 (Hopper's only path to the int8 rate):
//   a block of 128 pixels x BN channels (BN 64, 128 or 256, chosen per
//   conv by the wrapper's planner, ops/int8_conv.plan), two consumer
//   warpgroups of 64 rows each, K in stages of 128 bytes;
// - a ring in shared memory (4, 6 or 4 stages for BN 64, 128, 256: two
//   blocks an SM at BN 64, one above) with full/empty mbarriers. The
//   weight tile comes by TMA (a 2-D tensor map with 128-byte swizzle; the
//   encoder is taken from the driver with cudaGetDriverEntryPoint, so the
//   library links nothing); the input tile is gathered tap by tap by a
//   producer warpgroup with 16-byte cp.async, zero-filled for padded and
//   out-of-image taps and past K, in the same 128-byte swizzle, so both
//   operands are read by wgmma straight from shared memory. Where a
//   16-byte piece does not lie in one tap but Cin is a multiple of 4 and
//   the channel stride 1 (the rgb stem's Cin 4), 4-byte cp.async words;
//   any other input (Cin 1 or 3, NCHW) is gathered a byte at a time;
// - split-K where output tiles are fewer than the SMs (layers 3-4 and the
//   heads at batch 8): the `split` (at most 8) blocks of a tile form a
//   thread-block cluster, each sums an equal share of the K stages, and
//   the int32 partials meet through distributed shared memory: each block
//   adds the others' sums for its share of the tile's columns and runs
//   the epilogue on those full sums (no workspace, no second pass).
//   Integer sums are exact, so the split and its order change no bit;
// - the epilogue stores from registers with 16-byte stores (a shuffle
//   within each quad of lanes gathers 16 contiguous bytes of one row), in
//   x's dtype (half the bytes of int32 for bf16), the tile's scales and
//   biases read once into shared memory; the kernel is compiled per
//   output kind, so each holds only its own epilogue.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int BM = 128;                 // output pixels per block
constexpr int BK = 128;                 // bytes of K per stage
constexpr int THREADS = 384;            // producer + two consumer warpgroups
constexpr int A_STAGE = BM * BK;        // 16 KB

// ring stages by tile width: 192 KB of shared memory for BN 128 and 256
// (one block an SM: their accumulators take 142-168 registers a thread),
// 96 KB for BN 64 (two blocks an SM)
__host__ __device__ constexpr int blocks_per_sm(int bn) {
  return bn == 64 ? 2 : 1;
}
__host__ __device__ constexpr int stages_of(int bn) {
  return 196608 / blocks_per_sm(bn) / (A_STAGE + bn * BK);
}
constexpr int ROWS_PER_THREAD = BM / 16;

enum Mode { VEC16 = 0, WORD = 1, BYTE = 2 };
enum OutKind { OUT_I32 = 0, OUT_F32 = 1, OUT_BF16 = 2 };

struct Geom {
  long long sb, sc, sh, sw;             // input element strides
  int B, C, H, W, Cout, OH, OW;
  int KH, KW, strh, strw, padh, padw, dilh, dilw;
  int K, M;
  int steps;                            // K stages of each split
  int tiles_m, tiles_n, split;
};

struct Epilogue {
  void* out;                            // (M, Cout) NHWC
  int kind;                             // OutKind
  const float* scale;                   // (Cout,) f32, fused kinds only
  const void* bias;                     // (Cout,) or null
  int bias_bf16;                        // bias dtype: bf16, else f32
  int acc_bf16;                         // round the sums to bf16 first
};

constexpr int MAX_SPLIT = 8;            // a portable cluster's blocks

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n"
      ".reg .b64 st;\n"
      "mbarrier.arrive.shared.b64 st, [%0];\n"
      "}\n" ::"r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, int bytes) {
  asm volatile(
      "{\n"
      ".reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared.b64 st, [%0], %1;\n"
      "}\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// G (16 or 4) bytes from global to shared, zero-filled where src_bytes
// is 0 (16 bytes bypass L1)
template <int G>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int src_bytes) {
  if constexpr (G == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     dst),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// orders this thread's generic-proxy writes to shared memory (st.shared,
// cp.async) before the async proxy's reads of them (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// every thread of the cluster's blocks arrives (release) and waits
// (acquire)
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// 16 bytes at shared address `addr` of block `rank` of the cluster
__device__ __forceinline__ int4 ld_peer16(uint32_t addr, uint32_t rank) {
  uint32_t peer;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(peer)
               : "r"(addr), "r"(rank));
  int4 v;
  asm volatile("ld.shared::cluster.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(peer)
               : "memory");
  return v;
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

// keeps the compiler from moving accesses of r across the wgmma fences
__device__ __forceinline__ void pin(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// wgmma's shared-memory matrix descriptor of a K-major tile with 128-byte
// swizzle at `addr` (1024-byte aligned): rows of 128 bytes, 8-row groups
// 1024 bytes apart (stride offset); the leading offset is unused for this
// layout. A k32 step inside the row adds 32 bytes to the start address.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// the byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile
// (TMA's CU_TENSOR_MAP_SWIZZLE_128B and wgmma's layout type 1)
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

// wgmma.mma_async m64nNk32, s8 x s8 -> s32 added into d; A and B from
// shared memory through their descriptors
__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(int (&d)[128], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void mma(int (&acc)[BN / 2], uint64_t da,
                                    uint64_t db) {
  if constexpr (BN == 64) {
    wgmma_n64(acc, da, db);
  } else if constexpr (BN == 128) {
    wgmma_n128(acc, da, db);
  } else {
    wgmma_n256(acc, da, db);
  }
}

// the ring, its barriers, and the tile's (Cout,) scales and biases
constexpr size_t smem_bytes(int bn) {
  return 1024 + (size_t)stages_of(bn) * (A_STAGE + bn * BK + 16) + 8 * bn;
}

__device__ __forceinline__ void st_shared16(uint32_t addr, const uint32_t (&w)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
               : "memory");
}

// the plain chain's dequant of one sum, rounding where it rounds
__device__ __forceinline__ float dequant(int v, float scale, float bias,
                                         bool has_bias, bool acc_bf16) {
  float f = __int2float_rn(v);
  if (acc_bf16) f = __bfloat162float(__float2bfloat16_rn(f));
  f = __fmul_rn(f, scale);
  return has_bias ? __fadd_rn(f, bias) : f;
}

template <int BN, int MODE, int KIND>
__global__ void __launch_bounds__(THREADS, blocks_per_sm(BN))
int8_conv_kernel(const int8_t* __restrict__ x, const Geom g,
                 const __grid_constant__ CUtensorMap wmap,
                 const Epilogue e) {
  constexpr int STAGES = stages_of(BN);
  // the producer publishes a stage LAG stages after it issued its copies,
  // so LAG stages of copies stay in flight; LAG <= STAGES - 2 keeps a
  // stage it waits to refill published already
  constexpr int LAG = STAGES - 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t a_s = base;                          // STAGES x 16 KB
  const uint32_t b_s = base + STAGES * A_STAGE;       // STAGES x BN x 128
  const uint32_t bars = b_s + STAGES * BN * BK;       // full, then empty
  float* tile_scale =                                 // BN floats, then
      reinterpret_cast<float*>(smem + (bars - base) + 2 * STAGES * 8);
  float* tile_bias = tile_scale + BN;                 // BN bias floats
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // full: the producer warpgroup's 128 arrivals + the weight's
      // expect_tx; empty: lane 0 of each of the 8 consumer warps
      mbar_init(bars + 8 * s, 129);
      mbar_init(bars + 8 * (STAGES + s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, z = blockIdx.z;
  const int k_first = z * g.steps * BK;

  if (tid < 128) {
    // ---- producer: thread t gathers 16-byte chunk t % 8 of rows
    // t / 8 + 16 i; thread 0 also brings the weight tile by TMA
    const int c = tid & 7, r0 = tid >> 3;
    const int8_t* rbase[ROWS_PER_THREAD];
    int ih0[ROWS_PER_THREAD], iw0[ROWS_PER_THREAD];
#pragma unroll
    for (int i = 0; i < ROWS_PER_THREAD; ++i) {
      const int m = m0 + r0 + 16 * i;
      if (m < g.M) {
        const int ow = m % g.OW, t = m / g.OW;
        const int oh = t % g.OH, b = t / g.OH;
        rbase[i] = x + b * g.sb;
        ih0[i] = oh * g.strh - g.padh;
        iw0[i] = ow * g.strw - g.padw;
      } else {                      // past M: every tap outside the image
        rbase[i] = x;
        ih0[i] = -(1 << 29);
        iw0[i] = 0;
      }
    }
    const uint32_t row_off = swz(r0, c);    // row r0 + 16 i at + 2048 i
    for (int s = 0; s < g.steps; ++s) {
      const int st = s % STAGES;
      mbar_wait(bars + 8 * (STAGES + st), ((s / STAGES) & 1) ^ 1);
      const int k0 = k_first + s * BK;
      const uint32_t full = bars + 8 * st;
      if (tid == 0) {
        mbar_arrive_tx(full, BN * BK);
        tma_load_2d(b_s + st * BN * BK, &wmap, k0, n0, full);
      }
      const uint32_t dst = a_s + st * A_STAGE + row_off;
      if constexpr (MODE != BYTE) {
        // G-byte pieces by cp.async (16 bytes, or 4-byte words where Cin
        // is a multiple of 4 only), zero-filled where a piece is padding
        constexpr int G = MODE == VEC16 ? 16 : 4, NE = 16 / G;
        int dh[NE], dw[NE], ci[NE];
        bool kv[NE];
#pragma unroll
        for (int j = 0; j < NE; ++j) {
          const int k = k0 + 16 * c + G * j;
          kv[j] = k < g.K;
          const int tap = k / g.C, kh = tap / g.KW;
          ci[j] = k - tap * g.C;
          dh[j] = kh * g.dilh;
          dw[j] = (tap - kh * g.KW) * g.dilw;
        }
#pragma unroll
        for (int i = 0; i < ROWS_PER_THREAD; ++i) {
#pragma unroll
          for (int j = 0; j < NE; ++j) {
            const int ih = ih0[i] + dh[j], iw = iw0[i] + dw[j];
            const bool ok = kv[j] && (unsigned)ih < (unsigned)g.H &&
                            (unsigned)iw < (unsigned)g.W;
            const int8_t* src =
                ok ? rbase[i] + ih * g.sh + iw * g.sw + ci[j] : x;
            cp_async<G>(dst + 2048 * i + G * j, src, ok ? G : 0);
          }
        }
        cp_async_commit();
        // stage s - LAG's copies have landed: publish it
        if (s >= LAG) {
          cp_async_wait<LAG>();
          fence_proxy_async();
          mbar_arrive(bars + 8 * ((s - LAG) % STAGES));
        }
      } else {
        // bytes, through every stride, stored as 16-byte pieces
        int dh[16], dw[16];
        long long co[16];
        bool kv[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int k = k0 + 16 * c + j;
          kv[j] = k < g.K;
          const int tap = k / g.C, ci = k - tap * g.C;
          const int kh = tap / g.KW, kw = tap - kh * g.KW;
          dh[j] = kh * g.dilh;
          dw[j] = kw * g.dilw;
          co[j] = ci * g.sc;
        }
#pragma unroll 2
        for (int i = 0; i < ROWS_PER_THREAD; ++i) {
          uint32_t wd[4] = {0, 0, 0, 0};
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int ih = ih0[i] + dh[j], iw = iw0[i] + dw[j];
            if (kv[j] && (unsigned)ih < (unsigned)g.H &&
                (unsigned)iw < (unsigned)g.W)
              wd[j >> 2] |= (uint32_t)(uint8_t)
                                rbase[i][ih * g.sh + iw * g.sw + co[j]]
                            << (8 * (j & 3));
          }
          st_shared16(dst + 2048 * i, wd);
        }
        fence_proxy_async();
        mbar_arrive(full);
      }
    }
    if constexpr (MODE != BYTE) {
      cp_async_wait<0>();
      fence_proxy_async();
      for (int s = g.steps > LAG ? g.steps - LAG : 0; s < g.steps; ++s)
        mbar_arrive(bars + 8 * (s % STAGES));
    }
    if (g.split > 1) {                  // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // ---- consumers: warpgroup cw computes rows 64 cw .. 64 cw + 63
  const int cw = (tid >> 7) - 1;
  const int ct2 = tid - 128;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  if constexpr (KIND != OUT_I32) {
    // the dequant's scale and bias of the tile's columns (0 past Cout),
    // read once here, in the shadow of the first loads
    for (int i = ct2; i < BN; i += 256) {
      const int n = n0 + i;
      const bool in = n < g.Cout;
      tile_scale[i] = in ? e.scale[n] : 0.f;
      tile_bias[i] = !in || e.bias == nullptr ? 0.f
                     : e.bias_bf16
                         ? __bfloat162float(
                               static_cast<const __nv_bfloat16*>(e.bias)[n])
                         : static_cast<const float*>(e.bias)[n];
    }
    named_sync(1, 256);
  }
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  for (int s = 0; s < g.steps; ++s) {
    const int st = s % STAGES;
    mbar_wait(bars + 8 * st, (s / STAGES) & 1);
    const uint64_t da = sw128_desc(a_s + st * A_STAGE + cw * 64 * BK);
    const uint64_t db = sw128_desc(b_s + st * BN * BK);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) mma<BN>(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    // stage s - 1's products are done: hand its buffers back
    wgmma_wait<1>();
    if (s > 0 && lane == 0) mbar_arrive(bars + 8 * (STAGES + (s - 1) % STAGES));
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) pin(acc[i]);
  // split-K: the tile's `split` blocks are one cluster. Each writes its
  // partial sums to its own shared memory (the ring is idle now), in
  // fragment order; after a cluster barrier, block `rank` adds the other
  // blocks' sums of its share of the column groups (pairs of n8 groups,
  // pair p to block p % split) into its accumulators, and a second
  // barrier lets every block leave once no one reads its memory. Each
  // block then stores its share.
  const int rank = g.split > 1 ? (int)cluster_rank() : 0;
  if (g.split > 1) {
    named_sync(1, 256);               // both warpgroups are done with the ring
    const uint32_t part = a_s + 16 * ct2;         // int4 q at + 4096 q
#pragma unroll
    for (int q = 0; q < BN / 8; ++q) {
      const uint32_t w[4] = {(uint32_t)acc[4 * q], (uint32_t)acc[4 * q + 1],
                             (uint32_t)acc[4 * q + 2],
                             (uint32_t)acc[4 * q + 3]};
      st_shared16(part + 4096 * q, w);
    }
    cluster_sync();
    for (int oz = 0; oz < g.split; ++oz) {
      if (oz == rank) continue;
#pragma unroll
      for (int q = 0; q < BN / 8; ++q) {
        if ((q >> 1) % g.split != rank) continue;
        const int4 v = ld_peer16(part + 4096 * q, oz);
        acc[4 * q] += v.x;
        acc[4 * q + 1] += v.y;
        acc[4 * q + 2] += v.z;
        acc[4 * q + 3] += v.w;
      }
    }
    cluster_sync();
  }

  // epilogue: accumulator i of this thread is row 16 warp + lane / 4
  // (+ 8 for i % 4 >= 2), column 8 (i / 4) + 2 (lane % 4) (+ 1 for odd i)
  // of the warpgroup's 64 x BN tile. Each n8 group's values go out in
  // 16-byte pieces straight from registers: four lanes (a quad) hold a
  // row's 8 columns, so a shuffle within the quad gives each lane 16
  // contiguous bytes of one row (4-byte outputs: lanes pair up over two
  // rows; bf16: the quad's 4 x 4 words of two groups and two rows are
  // transposed)
  constexpr int ESZ = KIND == OUT_BF16 ? 2 : 4;
  const int ql = lane & 3;
  const int row0 = m0 + cw * 64 + warp * 16 + (lane >> 2);   // and + 8
  const bool has_bias = e.bias != nullptr;
  const long long pitch = (long long)g.Cout * ESZ;
  const bool vec = (pitch & 15) == 0;
  uint8_t* const out = static_cast<uint8_t*>(e.out);
  // 16 bytes of output row `row` from column n, or the part of them
  // inside the output
  auto put16 = [&](int row, int n, uint32_t w0, uint32_t w1, uint32_t w2,
                   uint32_t w3) {
    if (row >= g.M || n >= g.Cout) return;
    uint8_t* dst = out + row * pitch + (long long)n * ESZ;
    if (vec && n + 16 / ESZ <= g.Cout) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(w0, w1, w2, w3);
      return;
    }
    const uint32_t w[4] = {w0, w1, w2, w3};
#pragma unroll
    for (int t = 0; t < 16 / ESZ; ++t) {
      if (n + t >= g.Cout) break;
      if constexpr (ESZ == 4)
        reinterpret_cast<uint32_t*>(dst)[t] = w[t];
      else
        reinterpret_cast<uint16_t*>(dst)[t] =
            (uint16_t)(w[t >> 1] >> (16 * (t & 1)));
    }
  };
  if constexpr (KIND != OUT_BF16) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      if ((j >> 1) % g.split != rank) continue;      // another block's share
      const int n = n0 + 8 * j + 2 * ql;
      uint32_t v[4];                      // (row0, n), (row0, n+1), +8 rows
      if constexpr (KIND == OUT_I32) {
#pragma unroll
        for (int t = 0; t < 4; ++t) v[t] = (uint32_t)acc[4 * j + t];
      } else {
        const int c = 8 * j + 2 * ql;
#pragma unroll
        for (int t = 0; t < 4; ++t)
          v[t] = __float_as_uint(dequant(acc[4 * j + t],
                                         tile_scale[c + (t & 1)],
                                         tile_bias[c + (t & 1)], has_bias,
                                         e.acc_bf16));
      }
      // even lanes keep row0 and take the odd partner's row0 pair; odd
      // lanes keep row0 + 8 and take the even partner's
      const bool odd = ql & 1;
      const uint32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[2], 1);
      const uint32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? v[1] : v[3], 1);
      if (odd)
        put16(row0 + 8, n - 2, r0, r1, v[2], v[3]);
      else
        put16(row0, n, v[0], v[1], r0, r1);
    }
  } else {
#pragma unroll
    for (int jj = 0; jj < BN / 8; jj += 2) {
      if ((jj >> 1) % g.split != rank) continue;     // another block's share
      // word t of this lane: group jj + t / 2, row0 + 8 (t % 2), its two
      // columns 2 ql, 2 ql + 1 as bf16
      uint32_t word[4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = jj + u, c = 8 * j + 2 * ql;
        const float s0 = tile_scale[c], s1 = tile_scale[c + 1];
        const float b0 = tile_bias[c], b1 = tile_bias[c + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const __nv_bfloat162 p = __floats2bfloat162_rn(
              dequant(acc[4 * j + 2 * h], s0, b0, has_bias, e.acc_bf16),
              dequant(acc[4 * j + 2 * h + 1], s1, b1, has_bias, e.acc_bf16));
          word[2 * u + h] = *reinterpret_cast<const uint32_t*>(&p);
        }
      }
      // lane ql gathers piece ql (group jj + ql / 2, row0 + 8 (ql % 2)):
      // word ql of every lane s of the quad, at position s. A 4 x 4
      // transpose in two butterfly steps: over lane bit 0, then bit 1.
      const bool l0 = ql & 1, l1 = ql & 2;
      const uint32_t k0 = l0 ? word[1] : word[0], k1 = l0 ? word[3] : word[2];
      const uint32_t x0 = __shfl_xor_sync(0xffffffffu, l0 ? word[0] : word[1], 1);
      const uint32_t x1 = __shfl_xor_sync(0xffffffffu, l0 ? word[2] : word[3], 1);
      // now: k0, x0 = words ql0 of lanes ql, ql ^ 1; k1, x1 = words 2 + ql0
      const uint32_t y0 = __shfl_xor_sync(0xffffffffu, l1 ? k0 : k1, 2);
      const uint32_t y1 = __shfl_xor_sync(0xffffffffu, l1 ? x0 : x1, 2);
      // word ql of lanes ql, ql ^ 1, ql ^ 2, ql ^ 3
      const uint32_t by_xor[4] = {l1 ? k1 : k0, l1 ? x1 : x0, y0, y1};
      uint32_t w[4];
#pragma unroll
      for (int s2 = 0; s2 < 4; ++s2) {
        const int x = s2 ^ ql;
        w[s2] = x == 0 ? by_xor[0] : x == 1 ? by_xor[1]
                                   : x == 2 ? by_xor[2] : by_xor[3];
      }
      put16(row0 + 8 * (ql & 1), n0 + 8 * (jj + (ql >> 1)), w[0], w[1], w[2],
            w[3]);
    }
  }
}

// one element of the quantize: true division, round half to even, clamp
__device__ __forceinline__ uint32_t q8(float v, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  return (uint32_t)(uint8_t)(int8_t)__float2int_rn(q);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// x (B, C, H, W) through element strides -> xq (B, H, W, C) int8, 16
// outputs a thread; `dense`: x is NHWC-contiguous and 16-byte aligned
template <typename T>
__global__ void __launch_bounds__(256)
int8_quantize_kernel(const T* __restrict__ x, long long sb, long long sc,
                     long long sh, long long sw, int C, int H, int W,
                     long long n, int dense, const float* __restrict__ xs,
                     int8_t* __restrict__ xq) {
  const long long e0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 16;
  if (e0 >= n) return;
  const float s = __ldg(xs);
  uint32_t wd[4] = {0, 0, 0, 0};
  if (dense && e0 + 16 <= n) {
    float v[16];
    const uint4* p = reinterpret_cast<const uint4*>(x + e0);
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 u = __ldg(p + h);
        const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          v[8 * h + 2 * q] = __uint_as_float(words[q] << 16);
          v[8 * h + 2 * q + 1] = __uint_as_float(words[q] & 0xffff0000u);
        }
      }
    } else {
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const uint4 u = __ldg(p + h);
        v[4 * h] = __uint_as_float(u.x);
        v[4 * h + 1] = __uint_as_float(u.y);
        v[4 * h + 2] = __uint_as_float(u.z);
        v[4 * h + 3] = __uint_as_float(u.w);
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) wd[j >> 2] |= q8(v[j], s) << (8 * (j & 3));
  } else {
    for (int j = 0; j < 16 && e0 + j < n; ++j) {
      const long long e = e0 + j;
      const int ci = (int)(e % C);
      long long p = e / C;
      const int iw = (int)(p % W);
      p /= W;
      const int ih = (int)(p % H);
      const long long b = p / H;
      const float v = to_f32(x[b * sb + ci * sc + ih * sh + iw * sw]);
      wd[j >> 2] |= q8(v, s) << (8 * (j & 3));
    }
  }
  if (e0 + 16 <= n) {
    *reinterpret_cast<uint4*>(xq + e0) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
  } else {
    for (long long j = 0; e0 + j < n; ++j)
      xq[e0 + j] = (int8_t)(wd[j >> 2] >> (8 * (j & 3)));
  }
}

// ------------------------------------------------------------- host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// errors of this file's own, beside cudaError_t's
constexpr int ERR_NO_ENCODER = -1;    // the driver has no tensor-map encoder
constexpr int ERR_MAP = -2;           // the encoder refused the weight's map
constexpr int ERR_ARGS = -3;          // a geometry or plan the kernel cannot run
int last_cu_result = 0;

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the packed (Npad, Kpad) weight as TMA boxes of BK bytes x bn rows, with
// the 128-byte swizzle wgmma's descriptors expect; rows past Npad and
// bytes past Kpad come in as zeros
int weight_map(CUtensorMap* map, const void* w, int npad, int kpad, int bn) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return ERR_NO_ENCODER;
  cuuint64_t dims[2] = {(cuuint64_t)kpad, (cuuint64_t)npad};
  cuuint64_t strides[1] = {(cuuint64_t)kpad};
  cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)bn};
  cuuint32_t unit[2] = {1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w),
                   dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  last_cu_result = (int)r;
  return r == CUDA_SUCCESS ? 0 : ERR_MAP;
}

template <int BN, int MODE, int KIND>
int launch_variant(const int8_t* x, const Geom& g, const CUtensorMap& map,
                   const Epilogue& e, cudaStream_t st) {
  const size_t smem = smem_bytes(BN);
  static bool ready[64] = {};         // the attribute set, by device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (!ready[dev & 63]) {
    err = cudaFuncSetAttribute(int8_conv_kernel<BN, MODE, KIND>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    ready[dev & 63] = true;
  }
  // the blocks of one tile (its K splits) form a cluster
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = (unsigned)g.split;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)g.tiles_m, (unsigned)g.tiles_n,
                     (unsigned)g.split);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, int8_conv_kernel<BN, MODE, KIND>, x, g, map,
                           e);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int BN, int MODE>
int launch_mode(const int8_t* x, const Geom& g, const CUtensorMap& map,
                const Epilogue& e, cudaStream_t st) {
  if (e.kind == OUT_I32) return launch_variant<BN, MODE, OUT_I32>(x, g, map, e, st);
  if (e.kind == OUT_F32) return launch_variant<BN, MODE, OUT_F32>(x, g, map, e, st);
  return launch_variant<BN, MODE, OUT_BF16>(x, g, map, e, st);
}

template <int BN>
int launch_bn(int mode, const int8_t* x, const Geom& g, const CUtensorMap& map,
              const Epilogue& e, cudaStream_t st) {
  if (mode == VEC16) return launch_mode<BN, VEC16>(x, g, map, e, st);
  if (mode == WORD) return launch_mode<BN, WORD>(x, g, map, e, st);
  return launch_mode<BN, BYTE>(x, g, map, e, st);
}

// the conv of an int8 input read through its element strides; the plan
// (bn, split) is the wrapper's (ops/int8_conv.plan)
int conv(const void* x, long long sb, long long sc, long long sh, long long sw,
         const void* w, Epilogue e, int B, int C, int H, int W, int Cout,
         int OH, int OW, int KH, int KW, int strh, int strw, int padh,
         int padw, int dilh, int dilw, int Kpad, int bn, int split,
         cudaStream_t st) {
  const long long M = (long long)B * OH * OW;
  const long long K = (long long)KH * KW * C;
  const int total = (Kpad + BK - 1) / BK;
  if (M < 1 || M > 0x7fffffffLL || Cout < 1 || K < 1 || K > Kpad ||
      Kpad % 64 || (bn != 64 && bn != 128 && bn != 256) || split < 1 ||
      split > MAX_SPLIT || total % split)
    return ERR_ARGS;
  Geom g{sb, sc, sh, sw, B, C, H, W, Cout, OH, OW, KH, KW, strh, strw,
         padh, padw, dilh, dilw, (int)K, (int)M, total / split,
         (int)((M + BM - 1) / BM), (Cout + bn - 1) / bn, split};
  if (g.tiles_n > 65535) return ERR_ARGS;
  CUtensorMap map;
  int err = weight_map(&map, w, (Cout + 63) / 64 * 64, Kpad, bn);
  if (err) return err;
  const uintptr_t a = reinterpret_cast<uintptr_t>(x);
  int mode = BYTE;
  if (sc == 1 && C % 16 == 0 && sh % 16 == 0 && sw % 16 == 0 && sb % 16 == 0 &&
      a % 16 == 0)
    mode = VEC16;
  else if (sc == 1 && C % 4 == 0 && sh % 4 == 0 && sw % 4 == 0 &&
           sb % 4 == 0 && a % 4 == 0)
    mode = WORD;
  const int8_t* xp = static_cast<const int8_t*>(x);
  if (bn == 64) return launch_bn<64>(mode, xp, g, map, e, st);
  if (bn == 128) return launch_bn<128>(mode, xp, g, map, e, st);
  return launch_bn<256>(mode, xp, g, map, e, st);
}

}  // namespace

extern "C" {

// The launch entries take one array of 64-bit arguments (one ctypes
// argument a call): pointers as integers, 0 for none.
//
// int8_conv_launch, the exact form: a[0] xq, (B, C, H, W) int8 read
// through the element strides a[1..4] (sb, sc, sh, sw); a[5] w,
// ops/int8_conv.pack_weight's (Npad, Kpad) int8, contiguous, 16-byte
// aligned; a[6] out, (B, OH, OW, Cout) int32, contiguous, the exact sums;
// a[7..22] B, C, H, W, Cout, OH, OW, KH, KW, stride h, w, padding h, w,
// dilation h, w, Kpad; a[23], a[24] the plan's bn and split (at most 8;
// ops/int8_conv.plan); a[25] the stream. Returns 0, a CUDA error, or one
// of this file's (error_string).
int int8_conv_launch(const long long* a) {
  Epilogue e{reinterpret_cast<void*>(a[6]), OUT_I32, nullptr, nullptr, 0, 0};
  return conv(reinterpret_cast<const void*>(a[0]), a[1], a[2], a[3], a[4],
              reinterpret_cast<const void*>(a[5]), e, (int)a[7], (int)a[8],
              (int)a[9], (int)a[10], (int)a[11], (int)a[12], (int)a[13],
              (int)a[14], (int)a[15], (int)a[16], (int)a[17], (int)a[18],
              (int)a[19], (int)a[20], (int)a[21], (int)a[22], (int)a[23],
              (int)a[24], reinterpret_cast<cudaStream_t>(a[25]));
}

// quantized_conv_launch, one quantized conv in two launches: a[0] x,
// (B, C, H, W) bf16 (a[26] = 1) or f32 through the strides a[1..4],
// quantized by the 0-d f32 device scale a[27] into a[28], a (B, H, W, C)
// int8 scratch; then the conv with the fused epilogue into a[6], (B, OH,
// OW, Cout) in x's dtype: a[29] scale, (Cout,) f32; a[30] bias, (Cout,)
// bf16 (a[31] = 1) or f32, or 0; the sums rounded to bf16 first when
// a[32]. a[5], a[7..25] as int8_conv_launch's.
int quantized_conv_launch(const long long* a) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(a[25]);
  const long long sb = a[1], sc = a[2], sh = a[3], sw = a[4];
  const int B = (int)a[7], C = (int)a[8], H = (int)a[9], W = (int)a[10];
  const long long n = (long long)B * H * W * C;
  if (n < 1) return ERR_ARGS;
  const void* x = reinterpret_cast<const void*>(a[0]);
  const bool dense = sc == 1 && sw == C && sh == (long long)W * C &&
                     sb == (long long)H * W * C &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const unsigned blocks = (unsigned)((n + 16 * 256 - 1) / (16 * 256));
  const float* xs = reinterpret_cast<const float*>(a[27]);
  int8_t* q = reinterpret_cast<int8_t*>(a[28]);
  if (a[26])
    int8_quantize_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), sb, sc, sh, sw, C, H, W, n,
        dense, xs, q);
  else
    int8_quantize_kernel<float><<<blocks, 256, 0, st>>>(
        static_cast<const float*>(x), sb, sc, sh, sw, C, H, W, n, dense, xs,
        q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Epilogue e{reinterpret_cast<void*>(a[6]), a[26] ? OUT_BF16 : OUT_F32,
             reinterpret_cast<const float*>(a[29]),
             reinterpret_cast<const void*>(a[30]), (int)a[31], (int)a[32]};
  return conv(q, (long long)H * W * C, 1, (long long)W * C, C,
              reinterpret_cast<const void*>(a[5]), e, B, C, H, W, (int)a[11],
              (int)a[12], (int)a[13], (int)a[14], (int)a[15], (int)a[16],
              (int)a[17], (int)a[18], (int)a[19], (int)a[20], (int)a[21],
              (int)a[22], (int)a[23], (int)a[24], st);
}

const char* error_string(int err) {
  static char msg[160];
  if (err == ERR_NO_ENCODER)
    return "the CUDA driver has no cuTensorMapEncodeTiled";
  if (err == ERR_MAP) {
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled refused the weight's "
             "tensor map (CUresult %d)", last_cu_result);
    return msg;
  }
  if (err == ERR_ARGS) return "a geometry or plan the int8 kernel cannot run";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
