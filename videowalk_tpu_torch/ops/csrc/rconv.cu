// 3x3 stride-1 reflect-padded convolution: forward (with or without the
// following BatchNorm's batch moments), input gradient and weight gradient.
//
// Replaces the Pallas TPU kernels of videowalk_tpu/ops/rconv_kernel.py:
//   #4  _fwd_call    :240 -> _fwd_kernel     :224   (rconv_gemm<.., FWD>)
//   #5  _fwd_call_st :319 -> _fwd_kernel_st  :291   (rconv_gemm<.., FWD_STATS>
//                                                     + reduce_rows)
//   #9  _dx_call     :633 -> _dx_kernel      :607   (rconv_gemm<.., DX>)
//   #10 _dw_call     :682 -> _dw_kernel      :660   (rconv_gemm<.., DW>
//                                                     + reduce_rows)
// built from what they compute, not from the TPU's flat-roll/select chain
// (which exists for the sublane layout). y = conv_valid(reflect_pad(x, 1), w)
// with torch 'reflect' semantics: pad row -1 mirrors row 1, row H mirrors
// H-2, corners diagonally. H and W are powers of two in [8, 32]
// (rconv_supported). Activations are channel-contiguous (N, H, W, C) storage
// (a channels_last (N, C, H, W) tensor); weights come packed by the wrapper
// as (9, K, Nout) with tap t = 3*dy + dx.
//
// All four are one implicit GEMM engine (rconv_gemm): a block computes a
// BM x BN output tile, looping over K in BK-deep steps through a ring of 4
// shared-memory stages (3 steps in flight while one is multiplied, one
// barrier a step). Each step's A tile is gathered through the reflection:
// by cp.async for the forward and dW (one source row per tile row), through
// registers for dx (a boundary pixel sums several rows); B (weights, or gy
// for dW) by cp.async.
//   forward  M = N*H*W output pixels, N = Cout, K = 9*Cin (tap-major). Row p
//            of tap (dy, dx) reads x at (refl(h+dy-1), refl(w+dx-1)): the
//            reflection is resolved in the loader and no padded copy exists.
//   dx       the adjoint of reflect-pad-then-valid-conv: M = N*H*W input
//            pixels, N = Cin, K = 9*Cout with the transposed taps W[t]^T.
//            Input pixel (i, j) of tap (dy, dx) collects gy at every (h, w)
//            whose tap reads it: per axis the direct h = i-dy+1 (when inside)
//            plus, folded back through the pad, h = 0 when dy = 0 and i = 1
//            (pad row -1 mirrors row 1) and h = H-1 when dy = 2 and i = H-2
//            (pad row H mirrors row H-2); the same for columns, so a
//            boundary pixel sums up to 4 legs per tap, the legs of
//            _leg_masks/_leg_offsets. The legs share W[t], so the loader sums
//            their gy rows in f32 and rounds once to the operand type.
//   dW       dW[t] = sum_p tap_t(x)[p]^T gy[p]: M = Cin (per tap), N = Cout,
//            K = N*H*W pixels (200,704 at the flagship). The K range is split
//            over blocks into f32 partials (enough blocks to fill the 132 SMs
//            at layer1's 576 x 64 output as at layer4's 4608 x 512), reduced
//            by a second pass in a fixed order: no float atomics, so dW
//            repeats from run to run.
// bf16 operands run on the tensor cores (nvcuda::wmma 16x16x16, f32
// accumulation); f32 operands take a plain f32 FMA path, no TF32 (the JAX
// reference computes f32 in f32). The epilogue stages the f32 tile in shared
// memory and casts to the operand type; with FWD_STATS it also sums the CAST
// y and y^2 per channel in f32 over the tile's rows into per-block partials,
// which reduce_rows sums in a fixed order, so the moments repeat from run to
// run as the TPU's sequential grid made them.
//
// Bound at the flagship's routed shape (layer4 interior, N = 3136 images,
// 8x8, Cin = Cout = 512, bf16): each pass (forward, dx or dW) is
// 2*3136*64*9*512*512 = 0.947 TFLOP, 0.96 ms at 989 TFLOP/s dense bf16; its
// bytes (~205 MB in, ~205 MB out) take 0.12 ms at 3.35 TB/s. So the passes
// are bound by the tensor cores, and the design keeps the gathered operand
// tiles reused across a 128 x 128 output tile (64 multiply-adds per loaded
// element), and keeps 4 stages in flight at two blocks an SM to cover the
// gather's latency. It issues wmma (mma.sync); wgmma with TMA loads is
// later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (videowalk_tpu_torch/ops/_build.py); plain C interface, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int NT = 256;     // threads per block (8 warps)
enum Mode { FWD = 0, FWD_STATS = 1, DX = 2, DW = 3 };

// 16-byte vectors of the operand type, summed and rounded in f32
template <typename T> struct Pack;

template <> struct Pack<float> {
  static constexpr int E = 4;
  __device__ static void add(float* a, const uint4& v) {
    a[0] += __uint_as_float(v.x);
    a[1] += __uint_as_float(v.y);
    a[2] += __uint_as_float(v.z);
    a[3] += __uint_as_float(v.w);
  }
  __device__ static float round(float v) { return v; }
  __device__ static uint4 make(const float* a) {
    return make_uint4(__float_as_uint(a[0]), __float_as_uint(a[1]),
                      __float_as_uint(a[2]), __float_as_uint(a[3]));
  }
};

template <> struct Pack<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ static void add(float* a, const uint4& v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      a[2 * i] += f.x;
      a[2 * i + 1] += f.y;
    }
  }
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static uint4 make(const float* a) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(a[2 * i], a[2 * i + 1]);
    return v;
  }
};

struct Geo {
  int H, W, lh, lw;   // H = 1 << lh, W = 1 << lw
  int kc;             // channels of the gathered operand (conv: K per tap; dW: Cin)
  int nc;             // output channels (columns)
  long long M;        // N*H*W pixels
};

__device__ __forceinline__ int refl(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// 16-byte asynchronous copy to shared memory; zeros where !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(d), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N));
}

template <typename T, int BM_, int BN_, bool KMAJOR>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int E = Pack<T>::E;
  static constexpr int BK = 64 / (int)sizeof(T);   // 32 bf16, 16 f32
  static constexpr int PAD = 16 / (int)sizeof(T);
  static constexpr int LDA = (KMAJOR ? BM : BK) + PAD;
  static constexpr int A_ELEMS = (KMAJOR ? BK : BM) * LDA;
  static constexpr int LDB = BN + PAD;
  static constexpr int B_ELEMS = BK * LDB;
  static constexpr int LDC = BN + 4;
  static constexpr int STAGE = A_ELEMS + B_ELEMS;
  static constexpr int STAGES = 4;
  static constexpr int STAGE_BYTES = STAGES * STAGE * (int)sizeof(T);
  static constexpr int C_BYTES = BM * LDC * 4;
  static constexpr int SMEM = STAGE_BYTES > C_BYTES ? STAGE_BYTES : C_BYTES;
  static constexpr int A_VECS = BM * BK / E, B_VECS = BK * BN / E;
  static constexpr int A_PER = A_VECS / NT, B_PER = B_VECS / NT;
  static_assert(A_VECS % NT == 0 && B_VECS % NT == 0, "tile / thread mismatch");
};

// a: the gathered operand (forward and dW: x; dx: gy), b: the packed
// weights (9, kc, nc) for the convolutions, gy (M, nc) for dW.
// out: (M, nc) for the convolutions. part: FWD_STATS (mtiles, 2, nc)
// moments; DW (splits, 9*kc, nc) f32 partials.
template <typename T, int BM, int BN, int MODE>
__global__ void __launch_bounds__(NT, 2) rconv_gemm(
    const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
    float* __restrict__ part, Geo g, int ntiles, int mtiles,
    long long kspan) {
  constexpr bool KMAJOR = MODE == DW;
  using C = Cfg<T, BM, BN, KMAJOR>;
  constexpr int E = C::E, BK = C::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  T* stage = reinterpret_cast<T*>(smem);
  const int tid = threadIdx.x;
  const int cmask_w = g.W - 1, cmask_h = g.H - 1, lhw = g.lh + g.lw;

  // block -> tile
  long long bid = blockIdx.x;
  const int nt = (int)(bid % ntiles);
  bid /= ntiles;
  int mt, t_dw = 0, split = 0;
  long long m0, k_begin = 0, k_end = 0;
  if constexpr (MODE == DW) {
    mt = (int)(bid % mtiles);
    split = (int)(bid / mtiles);
    const int cit = mtiles / 9;                   // Cin tiles per tap
    t_dw = mt / cit;
    m0 = (long long)(mt % cit) * BM;              // first Cin of the tile
    k_begin = split * kspan;
    k_end = k_begin + kspan < g.M ? k_begin + kspan : g.M;
  } else {
    mt = (int)bid;
    m0 = (long long)mt * BM;                      // first pixel of the tile
  }
  const int n0 = nt * BN;
  const int kchunks = (g.kc + BK - 1) / BK;
  const int KT = MODE == DW
      ? (int)((k_end - k_begin + BK - 1) / BK) : 9 * kchunks;

  constexpr int S = C::STAGES;
  uint4 ra[MODE == DX ? C::A_PER : 1];

  // Where vector v of step kt's A tile comes from (every mode but DX:
  // one source row each, the reflection resolved here); false = zeros.
  auto a_src = [&](int kt, int v, const T*& src) -> bool {
    if constexpr (MODE == DW) {
      const long long p = k_begin + (long long)kt * BK + v / (BM / E);
      const long long c = m0 + (v % (BM / E)) * E;
      if (p >= k_end || c >= g.kc) return false;
      const int dy = t_dw / 3, dx = t_dw % 3;
      const int w = (int)(p & cmask_w), h = (int)((p >> g.lw) & cmask_h);
      const long long q = ((p >> lhw) << lhw)
          + ((long long)refl(h + dy - 1, g.H) << g.lw) + refl(w + dx - 1, g.W);
      src = a + q * g.kc + c;
      return true;
    } else {
      const int t = kt / kchunks;
      const int c = (kt - t * kchunks) * BK + (v % (BK / E)) * E;
      const long long p = m0 + v / (BK / E);
      if (p >= g.M || c >= g.kc) return false;
      const int dy = t / 3, dx = t % 3;
      const int w = (int)(p & cmask_w), h = (int)((p >> g.lw) & cmask_h);
      const long long q = ((p >> lhw) << lhw)
          + ((long long)refl(h + dy - 1, g.H) << g.lw) + refl(w + dx - 1, g.W);
      src = a + q * g.kc + c;
      return true;
    }
  };
  // vector v of step kt's B tile: the weights (conv) or gy rows (dW)
  auto b_src = [&](int kt, int v, const T*& src) -> bool {
    const int n = n0 + (v % (BN / E)) * E;
    const int r = v / (BN / E);
    if constexpr (MODE == DW) {
      const long long p = k_begin + (long long)kt * BK + r;
      if (p >= k_end || n >= g.nc) return false;
      src = b + p * g.nc + n;
    } else {
      const int t = kt / kchunks;
      const int k = (kt - t * kchunks) * BK + r;
      if (k >= g.kc || n >= g.nc) return false;
      src = b + ((long long)t * g.kc + k) * g.nc + n;
    }
    return true;
  };
  // step kt's tiles into stage s by cp.async (DX's A tile: dx_issue)
  auto issue = [&](int kt, int s) {
    T* As = stage + s * C::STAGE;
    T* Bs = As + C::A_ELEMS;
    if constexpr (MODE != DX) {
#pragma unroll
      for (int i = 0; i < C::A_PER; ++i) {
        const int v = tid + i * NT;
        constexpr int RV = KMAJOR ? BM / E : BK / E;
        const T* src = a;
        const bool ok = a_src(kt, v, src);
        cp_async16(As + (v / RV) * C::LDA + (v % RV) * E, src, ok);
      }
    }
#pragma unroll
    for (int i = 0; i < C::B_PER; ++i) {
      const int v = tid + i * NT;
      const T* src = b;
      const bool ok = b_src(kt, v, src);
      cp_async16(Bs + (v / (BN / E)) * C::LDB + (v % (BN / E)) * E, src, ok);
    }
  };
  // DX's A tile: per input pixel the sum of its legs' gy rows. A pixel with
  // one leg (or none) copies its row (or zeros) by cp.async into stage s; a
  // boundary pixel with several sums them in f32 here, rounds once, and
  // dx_store writes the sum after this step's products.
  bool held[MODE == DX ? C::A_PER : 1];
  auto dx_issue = [&](int kt, int s) {
    if constexpr (MODE == DX) {
      T* As = stage + s * C::STAGE;
      const int t = kt / kchunks;
      const int c0 = (kt - t * kchunks) * BK;
      const int dy = t / 3, dx = t % 3;
#pragma unroll
      for (int i = 0; i < C::A_PER; ++i) {
        const int v = tid + i * NT;
        const long long p = m0 + v / (BK / E);
        const int c = c0 + (v % (BK / E)) * E;
        T* dst = As + (v / (BK / E)) * C::LDA + (v % (BK / E)) * E;
        held[i] = false;
        if (p >= g.M || c >= g.kc) {
          cp_async16(dst, a, false);
          continue;
        }
        const int w = (int)(p & cmask_w), h = (int)((p >> g.lw) & cmask_h);
        const T* img = a + ((p >> lhw) << lhw) * g.kc + c;
        int h0 = h - dy + 1, w0 = w - dx + 1;        // the direct leg
        if (h0 < 0 || h0 >= g.H) h0 = -1;
        if (w0 < 0 || w0 >= g.W) w0 = -1;
        // folded back through the pad: row -1 mirrors 1, row H mirrors H-2
        const int h1 = (dy == 0 && h == 1) ? 0 : (dy == 2 && h == g.H - 2) ? g.H - 1 : -1;
        const int w1 = (dx == 0 && w == 1) ? 0 : (dx == 2 && w == g.W - 2) ? g.W - 1 : -1;
        auto row = [&](int hh, int ww) {
          return img + ((long long)((hh << g.lw) + ww)) * g.kc;
        };
        if (h1 < 0 && w1 < 0) {
          const bool ok = h0 >= 0 && w0 >= 0;
          cp_async16(dst, ok ? row(h0, w0) : a, ok);
          continue;
        }
        float acc[E];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = 0.f;
        auto add = [&](int hh, int ww) {
          if (hh >= 0 && ww >= 0)
            Pack<T>::add(acc, __ldg(reinterpret_cast<const uint4*>(row(hh, ww))));
        };
        add(h0, w0);
        add(h0, w1);
        add(h1, w0);
        add(h1, w1);
        ra[i] = Pack<T>::make(acc);
        held[i] = true;
      }
    }
  };
  auto dx_store = [&](int s) {
    if constexpr (MODE == DX) {
      T* As = stage + s * C::STAGE;
#pragma unroll
      for (int i = 0; i < C::A_PER; ++i) {
        const int v = tid + i * NT;
        if (held[i])
          *reinterpret_cast<uint4*>(As + (v / (BK / E)) * C::LDA
                                    + (v % (BK / E)) * E) = ra[i];
      }
    }
  };

  // ---- main loop: S stages in flight, one barrier per step
  constexpr bool TC = sizeof(T) == 2;
  constexpr int WM = BM / 2, WN = BN / 4, FM = WM / 16, FN = WN / 16;
  constexpr int RM = BM / 16, RN = BN / 16;
  using ALayout = typename std::conditional<KMAJOR, wmma::col_major,
                                            wmma::row_major>::type;
  const int warp = tid / 32, wm = warp / 4, wn = warp % 4;
  const int ty = tid / 16, tx = tid % 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> facc[TC ? FM : 1][TC ? FN : 1];
  float racc[TC ? 1 : RM][TC ? 1 : RN];
  if constexpr (TC) {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(facc[i][j], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) racc[i][j] = 0.f;
  }

  auto compute = [&](int s) {
    const T* As = stage + s * C::STAGE;
    const T* Bs = As + C::A_ELEMS;
    if constexpr (TC) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, ALayout> fa[FM];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[FN];
#pragma unroll
        for (int i = 0; i < FM; ++i) {
          const int row = wm * WM + i * 16;
          const T* p = KMAJOR ? As + kk * C::LDA + row : As + row * C::LDA + kk;
          wmma::load_matrix_sync(fa[i], reinterpret_cast<const __nv_bfloat16*>(p),
                                 C::LDA);
        }
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::load_matrix_sync(
              fb[j], reinterpret_cast<const __nv_bfloat16*>(
                         Bs + kk * C::LDB + wn * WN + j * 16), C::LDB);
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int j = 0; j < FN; ++j)
            wmma::mma_sync(facc[i][j], fa[i], fb[j], facc[i][j]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float av[RM], bv[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const int r = ty + 16 * i;
          av[i] = (float)(KMAJOR ? As[k * C::LDA + r] : As[r * C::LDA + k]);
        }
#pragma unroll
        for (int j = 0; j < RN; ++j) bv[j] = (float)Bs[k * C::LDB + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) racc[i][j] = fmaf(av[i], bv[j], racc[i][j]);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < KT) {
      issue(s, s);
      dx_issue(s, s);
      dx_store(s);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<S - 2>();
    __syncthreads();          // step kt has landed; step kt-1's stage is free
    const int nk = kt + S - 1;
    if (nk < KT) {
      issue(nk, nk % S);
      dx_issue(nk, nk % S);
    }
    cp_async_commit();
    compute(kt % S);
    if (nk < KT) dx_store(nk % S);
  }
  cp_async_wait<0>();
  __syncthreads();

  // ---- epilogue: the f32 tile through shared memory
  float* Cs = reinterpret_cast<float*>(smem);
  if constexpr (TC) {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::store_matrix_sync(Cs + (wm * WM + i * 16) * C::LDC + wn * WN + j * 16,
                                facc[i][j], C::LDC, wmma::mem_row_major);
  } else {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j)
        Cs[(ty + 16 * i) * C::LDC + tx + 16 * j] = racc[i][j];
  }
  __syncthreads();

  if constexpr (MODE == DW) {
    for (int v = tid; v < BM * BN / 4; v += NT) {
      const int r = v / (BN / 4), c4 = v % (BN / 4);
      const long long ci = m0 + r;
      const int n = n0 + c4 * 4;
      if (ci < g.kc && n < g.nc)
        *reinterpret_cast<float4*>(
            part + (((long long)split * 9 + t_dw) * g.kc + ci) * g.nc + n) =
            *reinterpret_cast<const float4*>(Cs + r * C::LDC + c4 * 4);
    }
  } else {
    for (int v = tid; v < BM * BN / E; v += NT) {
      const int r = v / (BN / E), cv = v % (BN / E);
      const long long p = m0 + r;
      const int n = n0 + cv * E;
      float* cp = Cs + r * C::LDC + cv * E;
      if (p < g.M && n < g.nc) {
        float vals[E];
#pragma unroll
        for (int e = 0; e < E; ++e) vals[e] = Pack<T>::round(cp[e]);
        *reinterpret_cast<uint4*>(out + p * g.nc + n) = Pack<T>::make(vals);
        if constexpr (MODE == FWD_STATS) {
#pragma unroll
          for (int e = 0; e < E; ++e) cp[e] = vals[e];   // the cast y
        }
      } else if constexpr (MODE == FWD_STATS) {
#pragma unroll
        for (int e = 0; e < E; ++e) cp[e] = 0.f;
      }
    }
    if constexpr (MODE == FWD_STATS) {
      __syncthreads();
      if (tid < BN && n0 + tid < g.nc) {
        float s1 = 0.f, s2 = 0.f;
        for (int r = 0; r < BM; ++r) {
          const float y = Cs[r * C::LDC + tid];
          s1 += y;
          s2 = fmaf(y, y, s2);
        }
        part[((long long)mt * 2) * g.nc + n0 + tid] = s1;
        part[((long long)mt * 2 + 1) * g.nc + n0 + tid] = s2;
      }
    }
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

Geo make_geo(int N, int H, int W, int kc, int nc) {
  Geo g;
  g.H = H;
  g.W = W;
  g.lh = log2i(H);
  g.lw = log2i(W);
  g.kc = kc;
  g.nc = nc;
  g.M = (long long)N * H * W;
  return g;
}

template <typename T, int BM, int BN, int MODE>
cudaError_t launch_gemm(const void* a, const void* b, void* out, float* part,
                        const Geo& g, int mtiles, int splits, long long kspan,
                        cudaStream_t st) {
  using C = Cfg<T, BM, BN, MODE == DW>;
  auto kern = rconv_gemm<T, BM, BN, MODE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return e;
  const int ntiles = (g.nc + BN - 1) / BN;
  const long long blocks = (long long)ntiles * mtiles * splits;
  kern<<<(unsigned)blocks, NT, C::SMEM, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out),
      part, g, ntiles, mtiles, kspan);
  return cudaGetLastError();
}

constexpr int conv_bm(int dtype) { return dtype == 1 ? 128 : 64; }
// dW's tile rows (Cin per tap): 128 where Cin > 64 in bf16, which halves
// the weight-gradient tiles' re-reads of x and gy from L2
int dw_bm(int dtype, int cin) { return dtype == 1 && cin > 64 ? 128 : 64; }

template <int MODE>
cudaError_t conv(int dtype, const void* a, const void* w, void* out, float* part,
                 const Geo& g, cudaStream_t st) {
  const int mtiles = (int)((g.M + conv_bm(dtype) - 1) / conv_bm(dtype));
  if (dtype == 1) {
    if (g.nc <= 64)
      return launch_gemm<__nv_bfloat16, 128, 64, MODE>(a, w, out, part, g, mtiles, 1, 0, st);
    return launch_gemm<__nv_bfloat16, 128, 128, MODE>(a, w, out, part, g, mtiles, 1, 0, st);
  }
  return launch_gemm<float, 64, 64, MODE>(a, w, out, part, g, mtiles, 1, 0, st);
}

int dw_bn(int dtype, int cout) { return dtype == 1 && cout > 64 ? 128 : 64; }

}  // namespace

extern "C" {

// rows of one forward tile: the moment partials are (ceil(N*H*W / bm), 2, Cout)
int rconv_conv_bm(int dtype) { return conv_bm(dtype); }

// dW's K splits: enough blocks for ~4 waves on 132 SMs, >= 8 K steps each
int rconv_dw_splits(int dtype, int N, int H, int W, int cin, int cout) {
  const int bm = dw_bm(dtype, cin);
  const long long tiles = 9LL * ((cin + bm - 1) / bm)
      * ((cout + dw_bn(dtype, cout) - 1) / dw_bn(dtype, cout));
  const long long steps = ((long long)N * H * W + 31) / 32;
  long long s = (4 * 132 + tiles - 1) / tiles;
  if (s > steps / 8) s = steps / 8;
  if (s > 256) s = 256;
  return s < 1 ? 1 : (int)s;
}

// y (N,H,W,Cout) = reflect conv of x (N,H,W,Cin) with w9 (9,Cin,Cout); with
// stats, part (mtiles,2,Cout) scratch and s12 (2,Cout) = [sum y; sum y^2].
// dtype 0 = f32, 1 = bf16.
int rconv_fwd_launch(const void* x, const void* w9, void* y, void* part,
                     void* s12, int dtype, int N, int H, int W, int cin,
                     int cout, int stats, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geo g = make_geo(N, H, W, cin, cout);
  if (!stats) return (int)conv<FWD>(dtype, x, w9, y, nullptr, g, st);
  cudaError_t e = conv<FWD_STATS>(dtype, x, w9, y, static_cast<float*>(part), g, st);
  if (e != cudaSuccess) return (int)e;
  const int mtiles = (int)((g.M + conv_bm(dtype) - 1) / conv_bm(dtype));
  const long long n = 2LL * cout;
  reduce_rows<32><<<(unsigned)((n + 31) / 32), dim3(32, 32), 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(s12), mtiles, n);
  return (int)cudaGetLastError();
}

// dx (N,H,W,Cin) from gy (N,H,W,Cout) and the transposed taps w9t (9,Cout,Cin)
int rconv_dx_launch(const void* gy, const void* w9t, void* dx, int dtype,
                    int N, int H, int W, int cin, int cout, void* stream) {
  const Geo g = make_geo(N, H, W, cout, cin);
  return (int)conv<DX>(dtype, gy, w9t, dx, nullptr, g,
                       static_cast<cudaStream_t>(stream));
}

// dw (9,Cin,Cout) f32 from x (N,H,W,Cin) and gy (N,H,W,Cout); part is
// (splits, 9, Cin, Cout) f32 scratch, splits from rconv_dw_splits
int rconv_dw_launch(const void* x, const void* gy, void* part, void* dw,
                    int dtype, int N, int H, int W, int cin, int cout,
                    int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geo g = make_geo(N, H, W, cin, cout);
  const int bm = dw_bm(dtype, cin);
  const int mtiles = 9 * ((cin + bm - 1) / bm);
  const long long steps = (g.M + 31) / 32;
  const long long kspan = ((steps + splits - 1) / splits) * 32;
  float* p = static_cast<float*>(part);
  cudaError_t e;
  if (dtype == 1) {
    if (bm == 128 && dw_bn(dtype, cout) == 128)
      e = launch_gemm<__nv_bfloat16, 128, 128, DW>(x, gy, nullptr, p, g, mtiles, splits, kspan, st);
    else if (bm == 128)
      e = launch_gemm<__nv_bfloat16, 128, 64, DW>(x, gy, nullptr, p, g, mtiles, splits, kspan, st);
    else if (dw_bn(dtype, cout) == 128)
      e = launch_gemm<__nv_bfloat16, 64, 128, DW>(x, gy, nullptr, p, g, mtiles, splits, kspan, st);
    else
      e = launch_gemm<__nv_bfloat16, 64, 64, DW>(x, gy, nullptr, p, g, mtiles, splits, kspan, st);
  } else {
    e = launch_gemm<float, 64, 64, DW>(x, gy, nullptr, p, g, mtiles, splits, kspan, st);
  }
  if (e != cudaSuccess) return (int)e;
  const long long n = 9LL * cin * cout;
  reduce_rows<8><<<(unsigned)((n + 31) / 32), dim3(32, 8), 0, st>>>(
      p, static_cast<float*>(dw), splits, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
