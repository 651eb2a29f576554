// The 3x3 stride-1 reflect-padded convolution in bf16 on Hopper, around one
// landed slab of whole image rows that feeds all nine taps: the forward with
// the following BatchNorm's batch moments, of the plain conv and of the
// BN-input chain's conv of xn = relu(a*x + b), and the backward, the input
// gradient dx and the weight gradient dW of both.
//
// Replaces the Pallas TPU kernels of videowalk_tpu/ops/rconv_kernel.py:
//   #5  _fwd_call_st      :319 -> _fwd_kernel_st      :291
//                                  (rconv_slab_px<BN, FWD_STATS> + reduce_rows)
//   #6  _fwd_call_bnin_st :440 -> _fwd_kernel_bnin_st :401
//                                  (rconv_slab_px<BN, FWD_BNIN_STATS> + reduce_rows)
//   #9  _dx_call          :633 -> _dx_kernel          :607
//                                  (rconv_slab_px<BN, DX>)
//   #7  _dx_call_bnin     :514 -> _dx_kernel_bnin     :474
//                                  (rconv_slab_px<BN, DX_BNIN> + reduce_rows)
//   #10 _dw_call          :682 -> _dw_kernel          :660
//                                  (rconv_slab_dw<false> + reduce_rows)
//   #8  _dw_call_bnin     :573 -> _dw_kernel_bnin     :553
//                                  (rconv_slab_dw<true> + reduce_rows)
// y = conv_valid(reflect_pad(x, 1), w) with torch 'reflect' semantics: pad
// row -1 mirrors row 1, row H mirrors H-2. H and W are powers of two in
// [8, 32] (rconv_supported); activations are channel-contiguous (N, H, W, C)
// storage, channels a multiple of 8. f32 operands, and the forward without
// moments (#4), stay on rconv.cu's engine.
//
// Bound at the flagship's routed shape (3136 images of 8x8, 512 -> 512):
// each pass is 2*200704*9*512*512 = 0.947 TFLOP, 0.96 ms at 989 TFLOP/s
// dense bf16, against ~0.41 GB of bytes (0.12 ms at 3.35 TB/s); at the
// superpixel step's (24, 32x32, 512 -> 512) 0.116 TFLOP, 0.117 ms. All six
// are bound by the tensor cores, so the design cuts what kept the previous
// engine (rconv.cu's rconv_gemm) far from them: a gather of the A operand
// once per tap (9x the distinct input through L2), synchronous loads of the
// reflected legs, wmma from unswizzled shared memory, and in its BN-input
// modes the affine applied to every gathered tap copy of x (36 times an
// element at 512 channels).
//
// All six: a tile's pixel range is a run of whole image rows (128 output
// pixels for the forward and dx, a 64-pixel K chunk for dW: two whole 8x8
// images, or a band of rows of a larger map). The slab of flat pixels
// [first - W, last + W), the tile's rows plus one row above and below,
// lands in shared memory by 16-byte cp.async ONCE per K chunk; every source
// pixel of every tap, reflected or not, lies inside it (a reflection stays
// within one row of its pixel, in its own image). The nine taps are then
// nine sets of ldmatrix row addresses into that slab: ldmatrix takes one
// shared address per lane, so each A row of each tap is one address,
// computed through the reflection. The products are wgmma (m64nNk16, bf16
// in, f32 accumulate) with A, the gathered taps, from those ldmatrix
// registers and B through a shared-memory descriptor. ptxas serializes
// every wgmma of a kernel that writes an A register while an earlier
// product that reads registers is in flight (C7513), so a register set is
// rewritten only after its product is done; and of a kernel where a
// definition of the accumulators (their zeroing, sunk by the compiler into
// the path that skips the K loop) lands inside the wgmma pipeline (C7515),
// so the pixel-tiled kernel pins its accumulators with register fences
// before and after the loop (fence_acc).
//
// The pixel-tiled kernel rconv_slab_px: the forward and dx are one main
// loop, templated on the mode. Block: 128 output pixels x 128 (or 64)
// output channels, two warpgroups of 64 pixel rows; a K chunk is 16
// channels: the slab (<= 192 rows) plus all nine 16 x BN weight tiles
// (128-byte swizzled, the layout the descriptor reads without bank
// conflicts; an unswizzled B measured slower than mma.sync) land together,
// two chunks in flight (~94-101 KB: two blocks an SM). A tap is one
// wgmma.m64nBNk16 a warpgroup; two A register sets let a tap's gather
// overlap the previous tap's product. Per block a table sends each tap's
// A row of each pixel to a slab row, a zero row (pixels past M) or, for
// dx only, a leg-sum row. Grid: output-channel tiles fastest, then pixel
// tiles.
// forward (#5): M = N*H*W output pixels, N = Cout, K = Cin with B = W[t]
//   (w9, K rows, N contiguous). Output pixel (h, w) of tap (dy, dx) reads x
//   at (refl(h+dy-1), refl(w+dx-1)): always one slab row, so the forward has
//   no leg rows, no leg pass and no barrier for one. Epilogue: the tile is
//   rounded once to bf16 and staged in the freed stage memory, as #9's; a
//   thread keeps one 8-channel vector and walks its rows: it writes y by
//   16-byte stores and sums the CAST y and y^2 in f32 (the TPU kernel's
//   moments are of yv = acc.astype(out_dtype)); the row groups are
//   summed through shared memory in a fixed order into per-block partials
//   (mtiles, 2, Cout) that reduce_rows sums in a fixed order: no float
//   atomics, so y, s1 and s2 repeat bit for bit. Rows past M read the zero
//   row: y = 0, and they add nothing.
// forward of the chain (#6): #5 with xn = bf16(relu(fmaf(x, a, b))) (f32
//   math, rounded once) rebuilt ONCE per landed slab element, not once per
//   gathered tap copy: after cp.async.wait_group of a chunk each thread
//   rewrites the x vectors it copied itself (its own copies are visible to
//   it without a barrier), and the chunk's one barrier publishes them. With
//   256 threads and 2 vectors a slab row, a thread's vectors share one
//   8-channel half, so one 8 + 8 float read of (a, b) a chunk serves them
//   all; it is issued before the wait. Zero-filled vectors (rows outside the
//   pixels, channel tails) stay zero, never relu(b). The gate is
//   fmaf(x, a, b) > 0, as #7's, so a pixel kept forward is kept backward.
//   Measured against this design and dropped (PERF.md): a third chunk in
//   flight (slower at every shape) and (a, b) from a shared copy loaded
//   once a block (no resolved difference).
// dx (#9): M = N*H*W input pixels, N = Cin, K = Cout with W[t]^T (w9t).
//   Input pixel (i, j) of tap (dy, dx) collects gy at the direct h =
//   i-dy+1 (when inside) and, folded back through the pad, h = 0 when dy =
//   0 and i = 1, h = H-1 when dy = 2 and i = H-2; the same for columns. A
//   pixel with one leg per axis reads one slab row, none reads a zero row; a
//   pixel with a folded leg reads a leg-sum row: per K chunk the block sums
//   the folds once from the landed slab into a small region behind it (f32,
//   rounded once to bf16, as the previous engine): per slab row the column
//   folds gy[h,0]+gy[h,2] and gy[h,W-1]+gy[h,W-3]; per image in the tile the
//   row folds gy[0,w]+gy[2,w] (and gy[H-1,w]+gy[H-3,w]) and the 4 corners.
//   The tap loop is then only ldmatrix + wgmma: no global load inside it.
// dx of the chain (#7): the same main loop on gy; only the epilogue
//   differs. The f32 tile dxn is staged in the freed stage memory; a thread
//   keeps one vector and walks its rows: it reads x at the output pixel
//   (16-byte loads, issued before the staging),
//   gates by g = fmaf(x, a, b) > 0, writes dx = bf16(dxn*g*a) rounded once
//   from f32, and sums da = sum dxn*g*x and db = sum dxn*g from the f32
//   dxn, through the same fixed-order row-group and per-block sums: no
//   float atomics, so dx, da and db repeat bit for bit.
// dW (#10): dW[t] = sum_p tap_t(x)[p]^T gy[p]: M = Cin, N = Cout, K = pixels.
//   A block owns a 64 Cin x 64 Cout tile for all nine taps and a K split;
//   three warpgroups, warpgroup dy the taps (dy, 0..2) (96 f32 accumulators
//   a thread). Per 64-pixel K chunk the x slab (64 + 2W rows x 64 Cin) and
//   the gy tile (64 pixels x 64 Cout) land once by cp.async, gy 128-byte
//   swizzled for its descriptor; per 16 pixels each warp gathers
//   its three taps' A^T from the slab by ldmatrix.trans with per-lane pixel
//   addresses shifted through the reflection, then issues three
//   wgmma.m64n64k16 (A from registers, B = gy through one descriptor). gy
//   is streamed once per Cin tile (8 times at 512 channels, 36 in the
//   previous engine), x once per Cout tile. A ring of 4 chunks in flight.
//   K splits write f32 partials (splits, 9, Cin, Cout) that reduce_rows sums
//   in a fixed order: no float atomics, so dW repeats bit for bit.
// dW of the chain (#8): the same, with xn rebuilt once per landed slab
//   element as in #6, but during the previous chunk's k steps (four chunks
//   in flight), one vector a step right after its products are issued: no
//   barrier is added and the rewrite overlaps the tensor cores. A thread's
//   vectors share their 8 channels (384 threads, 8 vectors a slab row), so
//   their (a, b) are loaded once a block into registers. By the code's count
//   the loop moves about as many shared-memory wavefronts (ldmatrix
//   gathers, wgmma's B reads) as it has tensor cycles, so the rewrite costs
//   its 16-byte read and write a vector; reading (a, b) from shared memory
//   per vector as well cost about twice as much on an H100.
// Not yet used: TMA, a producer warp, clusters.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (videowalk_tpu_torch/ops/_build.py); plain C interface, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;                 // threads per block (8 warps)
constexpr int SMS = 132;                // H100 SXM streaming multiprocessors

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy to shared memory; zeros where !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d (m64 x n64, f32) += a (m64 x k16 bf16 in registers, the mma.sync A
// fragment layout per warp) * B (k16 x n64 bf16 in shared memory, MN-major:
// transpose-b 1, described by desc); scales +1
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const unsigned (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// the accumulators pinned in place: no definition of them (their zeroing)
// is moved across the wgmma pipeline, or ptxas serializes every wgmma
// (C7515), as CUTLASS's warpgroup_fence_operand
template <int N> __device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
// cp.async's writes (generic proxy) made visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const unsigned (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// a wgmma descriptor of a 128-byte-swizzled MN-major operand: 64 MN values
// (128 bytes) a K row, 8 K rows a 1024-byte atom whose 16-byte chunks are
// XORed by the row; lbo bytes between 64-wide MN blocks, sbo between atoms
// along K
__device__ __forceinline__ uint64_t mn_desc_sw128(unsigned addr, unsigned lbo,
                                                  unsigned sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16)
         | ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

struct Geo {
  int H, W, lw;
  long long M;        // N*H*W pixels
};

// 8 bf16 of a 16-byte vector as f32, and back rounded once
__device__ __forceinline__ void unpack8(float (&f)[8], const uint4& v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 p = __bfloat1622float2(h[e]);
    f[2 * e] = p.x;
    f[2 * e + 1] = p.y;
  }
}
__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
  return v;
}

// torch 'reflect' padding of index i into [0, n): -1 mirrors 1, n mirrors n-2
__device__ __forceinline__ int refl(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// 8 consecutive f32 from a 16-byte aligned address
__device__ __forceinline__ void load8f(float (&f)[8], const float* src) {
  const float4 lo = reinterpret_cast<const float4*>(src)[0];
  const float4 hi = reinterpret_cast<const float4*>(src)[1];
  f[0] = lo.x, f[1] = lo.y, f[2] = lo.z, f[3] = lo.w;
  f[4] = hi.x, f[5] = hi.y, f[6] = hi.z, f[7] = hi.w;
}
// the same through the read-only data cache
__device__ __forceinline__ void ldg8f(float (&f)[8], const float* src) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(src));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(src) + 1);
  f[0] = lo.x, f[1] = lo.y, f[2] = lo.z, f[3] = lo.w;
  f[4] = hi.x, f[5] = hi.y, f[6] = hi.z, f[7] = hi.w;
}

// a 16-byte vector of x rewritten in place as xn = bf16(relu(fmaf(x, a, b)))
__device__ __forceinline__ void bnin_vec(uint4* vec, const float (&av)[8],
                                         const float (&bv)[8]) {
  float f[8];
  unpack8(f, *vec);
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = fmaxf(fmaf(f[e], av[e], bv[e]), 0.f);
  *vec = pack8(f);
}

// ---------------------------------------------- pixel tiles: forward and dx

namespace pxk {
enum Mode { DX, DX_BNIN, FWD_STATS, FWD_BNIN_STATS };
constexpr int BM = 128;                 // output pixels of a tile
constexpr int BK = 16;                  // K channels of a chunk
constexpr int SLAB_MAX = BM + 2 * 32;   // slab rows at W = 32
constexpr int LEG_MAX = 80;             // dx's leg-sum rows (largest at W = 32)
constexpr int A_STRIDE = BK * 2 + 16;   // bytes: 48, conflict-free ldmatrix
constexpr int SM_SMEM = 233472;         // shared memory of an SM (228 KB)
template <int BN, int MODE> struct Cfg {
  static constexpr bool FWD = MODE == FWD_STATS || MODE == FWD_BNIN_STATS;
  static constexpr int LEGS = FWD ? 0 : LEG_MAX;        // the forward has none
  static constexpr int ZERO_ROW = SLAB_MAX + LEGS;
  static constexpr int A_BYTES = ((ZERO_ROW + 1) * A_STRIDE + 1023) / 1024 * 1024;
  // a tap's B tile (16 K x BN), 128-byte swizzled MN-major: K row k of N
  // block b (64 wide) at b*2048 + (k/8)*1024 + (k%8)*128, its 16-byte chunk
  // c at (c ^ k%8)*16
  static constexpr int TAP_B = BK * BN * 2;
  static constexpr int B_BYTES = 9 * TAP_B;             // all nine B tiles
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int S = 2;                           // chunks in flight
  static constexpr int TABLES = 9 * BM * 2 + LEGS * 8;
  static constexpr int SMEM = S * STAGE + TABLES;
  // the epilogue: the tile staged in bf16 (#9, #5, #6) or f32 (#7), then
  // the (RG, 2, BN) row-group sums of #5, #6, #7 behind it; a thread keeps
  // one 8-channel vector of RG row groups
  static constexpr int C_STRIDE = BN + 8;               // bf16 tile
  static constexpr int F_STRIDE = BN + 8;               // f32 tile
  static constexpr int CV = BN / 8, RG = NT / CV;
  static_assert(S >= 2 && STAGE % 1024 == 0 && A_BYTES % 1024 == 0,
                "swizzle atoms");
  // two blocks an SM (1 KB of an SM's shared memory is reserved a block)
  static_assert(2 * (SMEM + 1024) <= SM_SMEM, "two blocks fit");
  static_assert(NT % CV == 0 && BM % RG == 0 && 2 * BN <= NT,
                "two sums: a thread per sum");
  static_assert(BM * C_STRIDE * 2 + RG * 2 * BN * 4 <= S * STAGE,
                "bf16 epilogue staging");
  static_assert((BM * F_STRIDE + RG * 2 * BN) * 4 <= S * STAGE,
                "f32 epilogue staging");
  static_assert(NT % 2 == 0, "a thread copies one 8-channel half of its rows");
};
}  // namespace pxk

// the operands besides the main loop's: #7's raw x at the output pixels
// (M, Cin); the BN-input modes' affine (2, Cin) f32 [a; b]; the per-block
// partials (mtiles, 2, Nout) of the two per-channel sums ([sum y; sum y^2]
// for #5 and #6, [da; db] for #7)
struct PxAux {
  const __nv_bfloat16* x;
  const float* ab;
  float* part;
};

// out (M, Nout) from src (M, K) and the nine B tiles wk (9, K, Nout):
//   FWD_STATS       y of x (K = Cin) with w9, and the moments' partials;
//   FWD_BNIN_STATS  the same of xn = bf16(relu(a*x + b)) rebuilt in the slab;
//   DX              dx of gy (K = Cout) with w9t;
//   DX_BNIN         the chain's dx = bf16(dxn*g*a) and the [da; db] partials.
// Grid: ntiles (Nout) fastest, then 128-pixel tiles.
template <int BN, int MODE>
__global__ void __launch_bounds__(NT, 2) rconv_slab_px(
    const __nv_bfloat16* __restrict__ src, const __nv_bfloat16* __restrict__ wk,
    __nv_bfloat16* __restrict__ out, PxAux aux, Geo g, int kdim, int ndim,
    int ntiles) {
  using namespace pxk;
  using C = Cfg<BN, MODE>;
  constexpr bool BNIN_A = MODE == FWD_BNIN_STATS;   // xn rebuilt in the slab
  extern __shared__ __align__(1024) unsigned char smem[];
  short* arow = reinterpret_cast<short*>(smem + C::S * C::STAGE);  // [9][BM]
  short4* legsrc = reinterpret_cast<short4*>(arow + 9 * BM);      // [LEGS]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockIdx.x % ntiles;
  const int mt = blockIdx.x / ntiles;
  const long long m0 = (long long)mt * BM;
  const int n0 = nt * BN;
  const int H = g.H, W = g.W;
  const int SLAB = BM + 2 * W;

  // ---- tables, once per block: each tap's A row of each pixel (and, for
  // dx, the slab rows that each leg-sum row adds up; -1: none)
  if constexpr (C::FWD) {
    for (int e = tid; e < 9 * BM; e += NT) {
      const int t = e / BM, r = e % BM, dy = t / 3, dxo = t % 3;
      const long long p = m0 + r;
      int row = C::ZERO_ROW;
      if (p < g.M) {
        const int i = (int)((p >> g.lw) & (H - 1)), j = (int)(p & (W - 1));
        row = r + W + (refl(i + dy - 1, H) - i) * W + (refl(j + dxo - 1, W) - j);
      }
      arow[e] = (short)row;
    }
  } else {
    const int HW = H * W;
    const int R = BM / W;                        // image rows of the tile
    const int CF = SLAB_MAX;                     // first column-fold row
    const int RF = CF + 2 * (R + 2);             // first row-fold block
    const int NB = 2 * (HW < BM ? BM / HW : 1);  // row-fold blocks
    // the image of the tile's first pixel starts this far before (or after) m0
    const int img0 = -(int)(m0 % HW);
    for (int e = tid; e < 9 * BM; e += NT) {
      const int t = e / BM, r = e % BM, dy = t / 3, dxo = t % 3;
      const long long p = m0 + r;
      int row = C::ZERO_ROW;
      if (p < g.M) {
        const int i = (int)((p >> g.lw) & (H - 1)), j = (int)(p & (W - 1));
        const int hd = i - dy + 1, wd = j - dxo + 1;
        const bool hf = (dy == 0 && i == 1) || (dy == 2 && i == H - 2);
        const bool wf = (dxo == 0 && j == 1) || (dxo == 2 && j == W - 2);
        const bool hok = hd >= 0 && hd < H, wok = wd >= 0 && wd < W;
        if (hok && wok) {
          if (!hf && !wf) {
            row = r + W + (hd - i) * W + (wd - j);
          } else if (!hf) {                      // column fold at row hd
            row = CF + 2 * (r / W + 1 + hd - i) + (dxo == 2);
          } else {                               // row fold (+ a corner)
            const int img = (int)((p - m0 - img0) / HW);
            const int blk = RF + (2 * img + (dy == 2)) * (W + 2);
            row = wf ? blk + W + (dxo == 2) : blk + wd;
          }
        }
      }
      arow[e] = (short)row;
    }
    for (int e = tid; e < C::LEGS; e += NT) {
      short4 s = make_short4(-1, -1, -1, -1);
      const int l = SLAB_MAX + e;
      if (l >= CF && l < RF) {                   // column folds of slab row sr
        const int sr = (l - CF) / 2, right = (l - CF) & 1;
        const int a = sr * W + (right ? W - 1 : 0), b = sr * W + (right ? W - 3 : 2);
        s = make_short4(a, b, -1, -1);
      } else if (l >= RF && l < RF + NB * (W + 2)) {
        const int blk = (l - RF) / (W + 2), k = (l - RF) % (W + 2);
        const int img = blk / 2, bot = blk & 1;
        // slab row of (h, w) in that image: img0 + img*HW + W + h*W + w
        const int base = img0 + img * HW + W;
        const int h0 = bot ? H - 1 : 0, h1 = bot ? H - 3 : 2;
        // used only if the tile holds row 1 (or H-2) of the image: then rows
        // h0 and h1 both lie in the slab
        const int rowpix = base + (bot ? H - 2 : 1) * W;
        if (rowpix >= W && rowpix < W + BM) {
          if (k < W) {
            s = make_short4(base + h0 * W + k, base + h1 * W + k, -1, -1);
          } else {
            const int c0 = k == W ? 0 : W - 1, c1 = k == W ? 2 : W - 3;
            s = make_short4(base + h0 * W + c0, base + h0 * W + c1,
                            base + h1 * W + c0, base + h1 * W + c1);
          }
        }
      }
      legsrc[e] = s;
    }
  }
  // the zero row of every stage
  if (tid < C::S * (A_STRIDE / 16))
    reinterpret_cast<uint4*>(smem + (tid / (A_STRIDE / 16)) * C::STAGE
                             + C::ZERO_ROW * A_STRIDE)[tid % (A_STRIDE / 16)] =
        make_uint4(0, 0, 0, 0);

  const int KC = (kdim + BK - 1) / BK;
  // a thread copies (and, for #6, rebuilds) the 8-channel half hv of its
  // slab rows: v % 2 with v = tid + i*NT
  const int hv = tid & 1;
  auto issue = [&](int c, int st) {
    unsigned char* As = smem + st * C::STAGE;
    unsigned char* Bs = As + C::A_BYTES;
    const int k0 = c * BK;
    for (int v = tid; v < SLAB * 2; v += NT) {   // the slab: 2 vectors a row
      const int s = v >> 1;
      const long long q = m0 - W + s;
      const bool ok = q >= 0 && q < g.M && k0 + hv * 8 < kdim;
      cp_async16(As + s * A_STRIDE + hv * 16,
                 ok ? src + q * kdim + k0 + hv * 8 : src, ok);
    }
    constexpr int BV = BN / 8;                  // vectors of a B row
    for (int v = tid; v < 9 * BK * BV; v += NT) {
      const int t = v / (BK * BV), kr = (v / BV) % BK, nv = v % BV;
      const int k = k0 + kr, n = n0 + nv * 8;
      const bool ok = k < kdim && n < ndim;
      cp_async16(Bs + t * C::TAP_B + (nv >> 3) * 2048 + (kr >> 3) * 1024
                     + (kr & 7) * 128 + (((nv & 7) ^ (kr & 7)) << 4),
                 ok ? wk + ((long long)t * kdim + k) * ndim + n : wk, ok);
    }
  };
  // #6: this thread's own landed x vectors of chunk c in stage st as xn;
  // zero-filled ones (rows outside the pixels, channel tails) stay zero
  auto rebuild = [&](int c, int st, const float (&av)[8], const float (&bv)[8]) {
    if (c * BK + hv * 8 >= kdim) return;
    unsigned char* As = smem + st * C::STAGE + hv * 16;
    for (int v = tid; v < SLAB * 2; v += NT) {
      const long long q = m0 - W + (v >> 1);
      if (q >= 0 && q < g.M)
        bnin_vec(reinterpret_cast<uint4*>(As + (v >> 1) * A_STRIDE), av, bv);
    }
  };
  // dx: the leg sums of stage st from its landed slab, f32, rounded once
  auto legs = [&](int st) {
    unsigned char* As = smem + st * C::STAGE;
    for (int v = tid; v < C::LEGS * 2; v += NT) {
      const short4 s = legsrc[v >> 1];
      if (s.x < 0) continue;
      const int h = v & 1;
      float acc[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = 0.f;
      const short srow[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (srow[k] < 0) continue;
        float f[8];
        unpack8(f, *reinterpret_cast<const uint4*>(As + srow[k] * A_STRIDE + h * 16));
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] += f[e];
      }
      *reinterpret_cast<uint4*>(As + (SLAB_MAX + (v >> 1)) * A_STRIDE + h * 16) =
          pack8(acc);
    }
  };

  // a warpgroup's m64 x BN tile, this warp's 16 rows: n8 block j in
  // acc[j] (rows lane/4 and lane/4 + 8)
  float acc[BN / 8][4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  fence_acc(reinterpret_cast<float(&)[BN / 2]>(acc));

  // lane roles in ldmatrix: A rows (l&7) + 8*((l>>3)&1), k half l>>4
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lhalf = lane >> 4;
  const short* ar = arow + warp * 16 + lrow;

#pragma unroll
  for (int s = 0; s < C::S - 1; ++s) {
    if (s < KC) issue(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < KC; ++c) {
    const int st = c % C::S;
    float av[8], bv[8];         // #6: this thread's (a, b), read before the wait
    if constexpr (BNIN_A) {
      const int k = c * BK + hv * 8;
      if (k < kdim) {
        ldg8f(av, aux.ab + k);
        ldg8f(bv, aux.ab + kdim + k);
      }
    }
    cp_async_wait<C::S - 2>();  // this thread's copies of chunk c landed
    if constexpr (BNIN_A) rebuild(c, st, av, bv);
    fence_proxy_async();        // the landed B tiles, for wgmma
    wgmma_wait<0>();            // chunk c-1's products have read their stage
    __syncthreads();            // chunk c landed (and rebuilt); chunk c-1's
                                // stage is free
    if (c + C::S - 1 < KC) issue(c + C::S - 1, (c + C::S - 1) % C::S);
    cp_async_commit();
    if constexpr (!C::FWD) {
      legs(st);
      __syncthreads();          // the leg sums are visible
    }
    const unsigned As = smem_u32(smem + st * C::STAGE);
    const unsigned Bs = As + C::A_BYTES;
    // one m64 x BN x k16 product a tap, A from the slab through this warp's
    // ldmatrix rows; two register sets, so a tap's gather overlaps the
    // previous tap's product (an A set is rewritten only after its product
    // is done, or ptxas serializes every wgmma)
    unsigned a[2][4];
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      if (t >= 2) wgmma_wait<1>();
      ldsm_x4(a[t & 1], As + ar[t * BM] * A_STRIDE + lhalf * 16);
      wgmma_fence();
      const uint64_t desc = mn_desc_sw128(Bs + t * C::TAP_B, 2048, 1024);
      if constexpr (BN == 128)
        wgmma_n128(reinterpret_cast<float(&)[64]>(acc), a[t & 1], desc);
      else
        wgmma_n64(reinterpret_cast<float(&)[32]>(acc), a[t & 1], desc);
      wgmma_commit();
    }
  }
  cp_async_wait<0>();
  wgmma_wait<0>();
  fence_acc(reinterpret_cast<float(&)[BN / 2]>(acc));
  __syncthreads();

  const int gr = lane >> 2, gc = (lane & 3) * 2;
  // #5, #6 and #7: a thread keeps one 8-channel vector (cv) of the staged
  // tile and walks the rows rg, rg + RG, ...; its two per-channel sums
  // (#5, #6: sum y and sum y^2 of the cast y; #7: da and db) then go
  // through the row groups in a fixed order
  constexpr int RPT = BM / C::RG;
  const int cv = tid % C::CV, rg = tid / C::CV;
  const int n = n0 + cv * 8;
  float sa[8], sb[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) sa[e] = sb[e] = 0.f;
  float* red;                   // (RG, 2, BN) behind the staged tile
  if constexpr (MODE == DX_BNIN) {
    // ---- #7: the f32 tile dxn; x at the thread's rows is loaded before
    // the staging
    uint4 xr[RPT];
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const long long p = m0 + rg + k * C::RG;
      xr[k] = n < ndim && p < g.M
          ? __ldg(reinterpret_cast<const uint4*>(aux.x + p * ndim + n))
          : make_uint4(0, 0, 0, 0);
    }
    float* Cf = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int r = warp * 16 + gr, col = j * 8 + gc;
      *reinterpret_cast<float2*>(Cf + r * C::F_STRIDE + col) =
          make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(Cf + (r + 8) * C::F_STRIDE + col) =
          make_float2(acc[j][2], acc[j][3]);
    }
    __syncthreads();
    if (n < ndim) {
      float av[8], bv[8];
      load8f(av, aux.ab + n);
      load8f(bv, aux.ab + ndim + n);
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const int r = rg + k * C::RG;
        const long long p = m0 + r;
        if (p >= g.M) break;
        float v[8], xv[8], d[8];
        load8f(v, Cf + r * C::F_STRIDE + cv * 8);
        unpack8(xv, xr[k]);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float gd = fmaf(xv[e], av[e], bv[e]) > 0.f ? v[e] : 0.f;
          d[e] = gd * av[e];
          sa[e] = fmaf(gd, xv[e], sa[e]);
          sb[e] += gd;
        }
        *reinterpret_cast<uint4*>(out + p * ndim + n) = pack8(d);
      }
    }
    red = Cf + BM * C::F_STRIDE;
  } else {
    // ---- #9, #5, #6: the tile rounded once to bf16 through shared memory
    __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(smem);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int r = warp * 16 + gr, col = j * 8 + gc;
      *reinterpret_cast<__nv_bfloat162*>(Cs + r * C::C_STRIDE + col) =
          __floats2bfloat162_rn(acc[j][0], acc[j][1]);
      *reinterpret_cast<__nv_bfloat162*>(Cs + (r + 8) * C::C_STRIDE + col) =
          __floats2bfloat162_rn(acc[j][2], acc[j][3]);
    }
    __syncthreads();
    if constexpr (MODE == DX) {
      // #9: 16-byte stores
      for (int v = tid; v < BM * BN / 8; v += NT) {
        const int r = v / (BN / 8), c8 = v % (BN / 8);
        const long long p = m0 + r;
        if (p < g.M && n0 + c8 * 8 < ndim)
          *reinterpret_cast<uint4*>(out + p * ndim + n0 + c8 * 8) =
              *reinterpret_cast<const uint4*>(Cs + r * C::C_STRIDE + c8 * 8);
      }
      return;
    }
    // #5, #6: y by 16-byte stores, and the sums of the cast y as f32
    if (n < ndim) {
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const int r = rg + k * C::RG;
        const long long p = m0 + r;
        if (p >= g.M) break;
        const uint4 y = *reinterpret_cast<const uint4*>(Cs + r * C::C_STRIDE + cv * 8);
        *reinterpret_cast<uint4*>(out + p * ndim + n) = y;
        float v[8];
        unpack8(v, y);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          sa[e] += v[e];
          sb[e] = fmaf(v[e], v[e], sb[e]);
        }
      }
    }
    red = reinterpret_cast<float*>(Cs + BM * C::C_STRIDE);
  }
  // the row groups' sums in a fixed order
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    red[(rg * 2) * BN + cv * 8 + e] = sa[e];
    red[(rg * 2 + 1) * BN + cv * 8 + e] = sb[e];
  }
  __syncthreads();
  if (tid < 2 * BN) {
    const int j = tid / BN, col = tid % BN;
    if (n0 + col < ndim) {
      float tot = 0.f;
      for (int k = 0; k < C::RG; ++k) tot += red[(k * 2 + j) * BN + col];
      aux.part[((long long)mt * 2 + j) * ndim + n0 + col] = tot;
    }
  }
}

// ------------------------------------------------------------------- dW

namespace dwk {
constexpr int NTW = 384;                // 3 warpgroups
constexpr int BM = 64;                  // Cin of a tile
constexpr int BN = 64;                  // Cout of a tile
constexpr int BKP = 64;                 // pixels of a K chunk (whole rows)
constexpr int X_ROWS = BKP + 2 * 32;    // slab rows at W = 32
constexpr int STRIDE = BM * 2 + 16;     // bytes: 144, conflict-free ldmatrix
constexpr int X_BYTES = X_ROWS * STRIDE;
constexpr int G_BYTES = BKP * BN * 2;
constexpr int STAGE = X_BYTES + G_BYTES;
constexpr int S = 4;                    // chunks in flight
constexpr int SMEM = S * STAGE;
static_assert(X_BYTES % 1024 == 0 && STAGE % 1024 == 0, "swizzle atoms");
// #8: a thread's x vectors v = tid + i*NTW share their channels v % (BM/8),
// and it rebuilds one of them a k step
static_assert(NTW % (BM / 8) == 0, "one (a, b) vector a thread");
constexpr int NV = (X_ROWS * (BM / 8) + NTW - 1) / NTW;
static_assert(NV <= BKP / 16, "a thread's vectors: one a k step");
}  // namespace dwk

// part (splits, 9, Cin, Cout) f32 from x (M, Cin) and gy (M, Cout), with
// BNIN of xn = bf16(relu(a*x + b)), ab (2, Cin) f32 [a; b]; block (Cin
// tile, Cout tile, split), Cout tiles fastest. Warpgroup dy owns the taps
// (dy, 0..2), its warp w the Cin rows 16w..16w+15 of the tile.
template <bool BNIN>
__global__ void __launch_bounds__(dwk::NTW, 1) rconv_slab_dw(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ ab,
    const __nv_bfloat16* __restrict__ gy, float* __restrict__ part, Geo g,
    int cin, int cout, int ntiles, int mtiles, int span) {
  using namespace dwk;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int dy = warp >> 2, w4 = warp & 3;
  int bid = blockIdx.x;
  const int nt = bid % ntiles;
  bid /= ntiles;
  const int mt = bid % mtiles, split = bid / mtiles;
  const int ci0 = mt * BM, co0 = nt * BN;
  const int H = g.H, W = g.W;
  const long long KC = g.M / BKP;
  const long long cb = (long long)split * span;
  const long long ce = cb + span < KC ? cb + span : KC;
  const int KT = cb < ce ? (int)(ce - cb) : 0;
  const int SLAB = BKP + 2 * W;

  // chunk kt into stage st: the x slab as padded rows (for the ldmatrix
  // gather); gy's pixel rows of 64 Cout (128 bytes) in 1024-byte atoms of 8
  // rows, 16-byte chunk c of row s at (c ^ s%8)*16 (for the descriptor)
  auto issue = [&](int kt, int st) {
    unsigned char* Xs = smem + st * STAGE;
    unsigned char* Gs = Xs + X_BYTES;
    const long long k0 = (cb + kt) * BKP;
    for (int v = tid; v < SLAB * (BM / 8); v += NTW) {
      const int s = v / (BM / 8), cv = v % (BM / 8);
      const long long q = k0 - W + s;
      const int c = ci0 + cv * 8;
      const bool ok = q >= 0 && q < g.M && c < cin;
      cp_async16(Xs + s * STRIDE + cv * 16, ok ? x + q * cin + c : x, ok);
    }
    for (int v = tid; v < BKP * (BN / 8); v += NTW) {
      const int s = v / (BN / 8), cv = v % (BN / 8);
      const int c = co0 + cv * 8;
      const bool ok = c < cout;
      cp_async16(Gs + (s >> 3) * 1024 + (s & 7) * 128 + ((cv ^ (s & 7)) << 4),
                 ok ? gy + (k0 + s) * cout + c : gy, ok);
    }
  };

  // #8: vector i of the x vectors this thread copied for chunk kt into
  // stage st (issue's v = tid + i*NTW), rewritten in place as
  // xn = bf16(relu(fmaf(x, a, b))) once its own copies have landed;
  // zero-filled vectors stay zero. Its 8 channels' (a, b) stay in registers.
  const int bcv = tid % (BM / 8);
  const bool bch = BNIN && ci0 + bcv * 8 < cin;
  float av[8], bv[8];
  if (bch) {
    load8f(av, ab + ci0 + bcv * 8);
    load8f(bv, ab + cin + ci0 + bcv * 8);
  }
  auto bnin = [&](int kt, int st, int i) {
    const int v = tid + i * NTW;
    if (!bch || v >= SLAB * (BM / 8)) return;
    const int s = v / (BM / 8);
    const long long q = (cb + kt) * BKP - W + s;
    if (q < 0 || q >= g.M) return;
    bnin_vec(reinterpret_cast<uint4*>(smem + st * STAGE + s * STRIDE + bcv * 16),
             av, bv);
  };

  float acc[3][BN / 8][4];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f;

  // lane roles in ldmatrix.trans of A^T from [pixel][cin]: matrix q =
  // lane>>3 (Cin half q&1, pixel half q>>1), row lane&7
  const int q = lane >> 3, r8 = lane & 7;
  const int a_col = (w4 * 16 + (q & 1) * 8) * 2;          // bytes

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < KT) issue(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<S - 2>();
    if (BNIN && kt == 0)        // chunk 0's own x vectors; later chunks are
      for (int i = 0; i < NV; ++i) bnin(0, 0, i);   // rebuilt in the k steps
    fence_proxy_async();        // the landed gy tile, for wgmma
    wgmma_wait<0>();            // chunk kt-1's products have read their stage
    __syncthreads();            // chunk kt landed (and rebuilt); chunk kt-1's
                                // stage is free
    if (kt + S - 1 < KT) issue(kt + S - 1, (kt + S - 1) % S);
    cp_async_commit();
    const bool next = BNIN && kt + 1 < KT;
    const int st = kt % S;
    const unsigned Xs = smem_u32(smem + st * STAGE);
    const unsigned Gs = Xs + X_BYTES;
    const long long k0 = (cb + kt) * BKP;
#pragma unroll
    for (int ks = 0; ks < BKP / 16; ++ks) {
      // the previous products are done with the A registers (no A register
      // is written while a product is in flight, or ptxas serializes every
      // wgmma)
      wgmma_wait<0>();
      unsigned a[3][4];
      const int kk = ks * 16 + (q >> 1) * 8 + r8;      // this lane's pixel
      const long long p = k0 + kk;
      const int i = (int)((p >> g.lw) & (H - 1)), j = kk & (W - 1);
      const int rowoff = dy == 0 ? (i == 0 ? W : -W)
                                 : dy == 2 ? (i == H - 1 ? -W : W) : 0;
      const int left = j == 0 ? 1 : -1, right = j == W - 1 ? -1 : 1;
      const unsigned base = Xs + (kk + W + rowoff) * STRIDE + a_col;
      ldsm_x4_t(a[0], base + left * STRIDE);
      ldsm_x4_t(a[1], base);
      ldsm_x4_t(a[2], base + right * STRIDE);
      wgmma_fence();
      const uint64_t desc = mn_desc_sw128(Gs + ks * 2048, G_BYTES, 1024);
#pragma unroll
      for (int t = 0; t < 3; ++t)
        wgmma_n64(reinterpret_cast<float(&)[32]>(acc[t]), a[t], desc);
      wgmma_commit();
      // #8: while these products run, one of this thread's x vectors of
      // chunk kt+1 (its copies landed: all but the newest S-2 groups)
      if (next && ks < NV) {
        if (ks == 0) cp_async_wait<S - 2>();
        bnin(kt + 1, (kt + 1) % S, ks);
      }
    }
  }
  cp_async_wait<0>();
  wgmma_wait<0>();

  const int gr = lane >> 2, gc = (lane & 3) * 2;
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int nj = 0; nj < BN / 8; ++nj) {
      const int ci = ci0 + w4 * 16 + gr;
      const int co = co0 + nj * 8 + gc;
      if (co >= cout) continue;
      float* dst = part + (((long long)split * 9 + dy * 3 + t) * cin + ci) * cout + co;
      if (ci < cin)
        *reinterpret_cast<float2*>(dst) = make_float2(acc[t][nj][0], acc[t][nj][1]);
      if (ci + 8 < cin)
        *reinterpret_cast<float2*>(dst + 8LL * cout) =
            make_float2(acc[t][nj][2], acc[t][nj][3]);
    }
}

// out[i] = sum over s < S of part[s*n + i], in a fixed order (G row groups
// of a block, then the groups in order): no atomics, so it repeats.
template <int G>
__global__ void __launch_bounds__(32 * G) reduce_rows(
    const float* __restrict__ part, float* __restrict__ out, int S, long long n) {
  __shared__ float sh[G][33];
  const long long i = (long long)blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (i < n)
    for (int k = threadIdx.y; k < S; k += G) s += part[(long long)k * n + i];
  sh[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && i < n) {
    float tot = sh[0][threadIdx.x];
#pragma unroll
    for (int j = 1; j < G; ++j) tot += sh[j][threadIdx.x];
    out[i] = tot;
  }
}

int log2i(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

Geo make_geo(int N, int H, int W) {
  Geo g;
  g.H = H;
  g.W = W;
  g.lw = log2i(W);
  g.M = (long long)N * H * W;
  return g;
}

template <int BN, int MODE>
cudaError_t launch_px(const void* src, const void* wk, void* out,
                      const PxAux& aux, const Geo& g, int kdim, int ndim,
                      cudaStream_t st) {
  using C = pxk::Cfg<BN, MODE>;
  auto kern = rconv_slab_px<BN, MODE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return e;
  const int ntiles = (ndim + BN - 1) / BN;
  const long long blocks = ntiles * ((g.M + pxk::BM - 1) / pxk::BM);
  kern<<<(unsigned)blocks, NT, C::SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(src), static_cast<const __nv_bfloat16*>(wk),
      static_cast<__nv_bfloat16*>(out), aux, g, kdim, ndim, ntiles);
  return cudaGetLastError();
}

// the pixel-tiled kernel of a mode, 64 output channels a tile where there
// are no more; then, for the modes with two per-channel sums, the per-block
// partials summed in a fixed order into sums (2, ndim)
template <int MODE>
cudaError_t run_px(const void* src, const void* wk, void* out, const PxAux& aux,
                   void* sums, const Geo& g, int kdim, int ndim, cudaStream_t st) {
  cudaError_t e = ndim <= 64
      ? launch_px<64, MODE>(src, wk, out, aux, g, kdim, ndim, st)
      : launch_px<128, MODE>(src, wk, out, aux, g, kdim, ndim, st);
  if (e != cudaSuccess || MODE == pxk::DX) return e;
  const int mtiles = (int)((g.M + pxk::BM - 1) / pxk::BM);
  const long long n = 2LL * ndim;
  reduce_rows<32><<<(unsigned)((n + 31) / 32), dim3(32, 32), 0, st>>>(
      aux.part, static_cast<float*>(sums), mtiles, n);
  return cudaGetLastError();
}

// dW (BNIN: of xn rebuilt from the raw x): the K-split partials, then their
// sum in a fixed order
template <bool BNIN>
cudaError_t run_dw(const void* x, const float* ab, const void* gy, void* part,
                   void* dw_out, const Geo& g, int cin, int cout, int splits,
                   cudaStream_t st) {
  auto kern = rconv_slab_dw<BNIN>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, dwk::SMEM);
  if (e != cudaSuccess) return e;
  const int ntiles = (cout + dwk::BN - 1) / dwk::BN;
  const int mtiles = (cin + dwk::BM - 1) / dwk::BM;
  const long long chunks = g.M / dwk::BKP;
  const int span = (int)((chunks + splits - 1) / splits);
  kern<<<(unsigned)((long long)ntiles * mtiles * splits), dwk::NTW, dwk::SMEM,
         st>>>(
      static_cast<const __nv_bfloat16*>(x), ab,
      static_cast<const __nv_bfloat16*>(gy), static_cast<float*>(part), g,
      cin, cout, ntiles, mtiles, span);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long n = 9LL * cin * cout;
  reduce_rows<8><<<(unsigned)((n + 31) / 32), dim3(32, 8), 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dw_out), splits, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// pixels of one forward or dx tile: the per-block partials of #5, #6 and #7
// are (ceil(N*H*W / bm), 2, C)
int rconv_slab_bm() { return pxk::BM; }

// y (N,H,W,Cout) bf16 = reflect conv of x (N,H,W,Cin) with w9 (9,Cin,Cout);
// s12 (2,Cout) f32 = [sum y; sum y^2] of the cast y; part (ceil(N*H*W /
// 128), 2, Cout) f32 scratch
int rconv_slab_fwd_stats_launch(const void* x, const void* w9, void* y,
                                void* part, void* s12, int N, int H, int W,
                                int cin, int cout, void* stream) {
  const PxAux aux{nullptr, nullptr, static_cast<float*>(part)};
  return (int)run_px<pxk::FWD_STATS>(x, w9, y, aux, s12, make_geo(N, H, W),
                                     cin, cout, static_cast<cudaStream_t>(stream));
}

// the same of xn = bf16(relu(a*x + b)) rebuilt from the raw x, ab (2,Cin)
// f32 = [a; b]; xn is never written
int rconv_slab_fwd_bnin_stats_launch(const void* x, const void* ab,
                                     const void* w9, void* y, void* part,
                                     void* s12, int N, int H, int W, int cin,
                                     int cout, void* stream) {
  const PxAux aux{nullptr, static_cast<const float*>(ab), static_cast<float*>(part)};
  return (int)run_px<pxk::FWD_BNIN_STATS>(x, w9, y, aux, s12, make_geo(N, H, W),
                                          cin, cout,
                                          static_cast<cudaStream_t>(stream));
}

// dx (N,H,W,Cin) bf16 from gy (N,H,W,Cout) and the transposed taps w9t
// (9,Cout,Cin)
int rconv_slab_dx_launch(const void* gy, const void* w9t, void* dxo, int N,
                         int H, int W, int cin, int cout, void* stream) {
  return (int)run_px<pxk::DX>(gy, w9t, dxo, PxAux{nullptr, nullptr, nullptr},
                              nullptr, make_geo(N, H, W), cout, cin,
                              static_cast<cudaStream_t>(stream));
}

// the chain's dx = bf16(dxn*g*a), dxn the plain dx of gy, g = (a*x + b > 0)
// at the raw x (N,H,W,Cin), ab (2,Cin) f32 = [a; b]; dab (2,Cin) f32 =
// [sum dxn*g*x; sum dxn*g] from the f32 dxn; part (ceil(N*H*W / 128), 2,
// Cin) f32 scratch
int rconv_slab_dx_bnin_launch(const void* gy, const void* w9t, const void* x,
                              const void* ab, void* dxo, void* part, void* dab,
                              int N, int H, int W, int cin, int cout,
                              void* stream) {
  const PxAux aux{static_cast<const __nv_bfloat16*>(x),
                  static_cast<const float*>(ab), static_cast<float*>(part)};
  return (int)run_px<pxk::DX_BNIN>(gy, w9t, dxo, aux, dab, make_geo(N, H, W),
                                   cout, cin, static_cast<cudaStream_t>(stream));
}

// dW's K splits: about two waves of one block an SM, >= 4 chunks each
int rconv_slab_dw_splits(int N, int H, int W, int cin, int cout) {
  const long long tiles = (long long)((cin + dwk::BM - 1) / dwk::BM)
      * ((cout + dwk::BN - 1) / dwk::BN);
  const long long chunks = (long long)N * H * W / dwk::BKP;
  long long s = (2 * SMS + tiles / 2) / tiles;
  if (s > chunks / 4) s = chunks / 4;
  if (s > 512) s = 512;
  return s < 1 ? 1 : (int)s;
}

// dw (9,Cin,Cout) f32 from x (N,H,W,Cin) and gy (N,H,W,Cout), both bf16;
// part is (splits, 9, Cin, Cout) f32 scratch, splits from rconv_slab_dw_splits
int rconv_slab_dw_launch(const void* x, const void* gy, void* part, void* dw_out,
                         int N, int H, int W, int cin, int cout, int splits,
                         void* stream) {
  return (int)run_dw<false>(x, nullptr, gy, part, dw_out, make_geo(N, H, W),
                            cin, cout, splits, static_cast<cudaStream_t>(stream));
}

// the same of xn = bf16(relu(a*x + b)) rebuilt from the raw x, ab (2,Cin)
// f32 = [a; b]
int rconv_slab_dw_bnin_launch(const void* x, const void* ab, const void* gy,
                              void* part, void* dw_out, int N, int H, int W,
                              int cin, int cout, int splits, void* stream) {
  return (int)run_dw<true>(x, static_cast<const float*>(ab), gy, part, dw_out,
                           make_geo(N, H, W), cin, cout, splits,
                           static_cast<cudaStream_t>(stream));
}

}  // extern "C"
