// Train-mode BatchNorm of the trunk with its residual add and ReLU, forward
// and backward: per-channel moments, the normalize + add + ReLU pass, the
// backward's reduce and apply passes, and the moment cotangents' fold.
//
// Replaces no TPU kernel: the JAX package leaves these passes to XLA, which
// fuses them. Here they are what the port's eager chain ran as some twenty
// f32 passes a BN (a cast, the moments, the normalize, the cast back, the
// add, the ReLU, and autograd's replay of each in f32).
//
// What the kernels compute, per channel c over the N·H·W elements of c, in
// f32 (ops/bn_act.py holds the per-channel arithmetic between them):
//   moments   s1 = Σ y, s2 = Σ y²                       bn_moments_reduce
//   forward   z  = T((y - mean)·mul + bias)   each op rounded, flax's order
//             r  = the identity shortcut, or T((yd - mean_d)·mul_d + bias_d)
//             out = relu(T(z + r))     (r and the ReLU where present)
//                                                 bn_act_elementwise_fwd
//   backward  g  = go where out > 0 (go where there is no ReLU)
//             A = Σ g, B = Σ g·(y - mean), Bd = Σ g·(yd - mean_d)
//             and dr = g for an identity shortcut        bn_act_reduce_bwd
//             dy  = T(g·mul + gs1 + 2·y·gs2), dyd likewise of yd
//                                                 bn_act_elementwise_bwd
//   fold      gy' = T(gy + gs1 + 2·y·gs2)            bn_fold_elementwise
// (T the tensors' type, bf16 or f32; gs1, gs2 the cotangents of s1 and s2.)
// The forward's f32 operations are __fsub_rn/__fmul_rn/__fadd_rn, never
// contracted, so that it rounds where the eager chain rounds; the fold
// likewise. The reductions write one partial sum a block and channel, and
// bn_partials_reduce sums them in a fixed order: every result is bitwise
// repeatable.
//
// Bound: bytes. Per element of a BN, bf16: the forward reads y (and the
// shortcut) and writes out, 4-6 bytes; the backward's reduce pass reads go,
// out and y (and yd), the apply pass the same and writes dy (and dyd); the
// moments read y once, the fold reads gy and y and writes gy'. At the
// flagship's layer4 (12,544 images of 8x8x512) a tensor is 822 MB: 0.25 ms
// a tensor read or written at 3.35 TB/s.
//
// Design. Elementwise passes are grid-stride loops of 16-byte vectors (8
// bf16 or 4 f32), in the primary tensor's layout (y's; gy's for the fold):
//   NHWC (channels_last)  a block is C/V threads across a pixel's channels
//          times TY pixel rows; each thread keeps its V channels' parameters
//          in registers for the whole loop;
//   NCHW                  a block takes one channel of a range of images
//          (grid: splits x C), so its parameters are scalars.
// A shortcut (r or yd) stored in the other layout is read, and dyd
// written, one element a lane at its own offsets (one block in a ResNet-18
// trunk sees this: the first block after an NCHW stem). Reductions keep
// f32 sums a lane, reduce them over the block in shared memory (NHWC) or by
// shuffles (NCHW), and write partials[split][k][c]. A channel count that is
// not a multiple of the vector, a map whose H·W is not (NCHW), or a tensor
// that is not 16-byte aligned takes one element a lane.
//
// Names: every kernel's name holds "elementwise" or "reduce" and none of the
// convolution classes' words, so a profiler's kernel classes count them as
// BN's own passes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (videowalk_tpu_torch/ops/_build.py); plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int MAX_THREADS = 512;         // an NHWC block: C/V threads a row
constexpr int EW_BLOCKS = 132 * 8;       // elementwise grid: 8 blocks an SM
constexpr int RED_BLOCKS = 132 * 4;      // reduce grid: one partial a block
constexpr int RED_FLOATS = 2048;         // NHWC block sums: TY x C floats
constexpr int MAX_C = 2048;              // NHWC: C <= RED_FLOATS
constexpr unsigned FULL = 0xffffffffu;

enum Mode { PLAIN = 0, IDENTITY = 1, PROJ = 2 };

struct Geo {
    long long N, HW;
    int C;
};

// A thread's V elements: their offset in the primary layout; the image and
// pixel (NCHW) or the pixel row n·HW + p (NHWC) they lie at.
struct Pos {
    size_t off, a, b;
};

__device__ __forceinline__ float tof(float v) { return v; }
__device__ __forceinline__ float tof(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T fromf(float v);
template <> __device__ __forceinline__ float fromf<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 fromf<bf16>(float v)
{
    return __float2bfloat16_rn(v);
}
// v after a round trip through T
template <typename T> __device__ __forceinline__ float rnd(float v)
{
    return tof(fromf<T>(v));
}

template <typename T, int V>
__device__ __forceinline__ void ld(const T* p, float (&v)[V])
{
    if constexpr (V * sizeof(T) == 16) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] = tof(e[k]);
    } else {
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] = tof(p[k]);
    }
}

template <typename T, int V>
__device__ __forceinline__ void st(T* p, const float (&v)[V])
{
    if constexpr (V * sizeof(T) == 16) {
        uint4 raw;
        T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
        for (int k = 0; k < V; ++k) e[k] = fromf<T>(v[k]);
        *reinterpret_cast<uint4*>(p) = raw;
    } else {
#pragma unroll
        for (int k = 0; k < V; ++k) p[k] = fromf<T>(v[k]);
    }
}

// The first channel of this thread's lanes (NHWC: lane k is c0 + k; NCHW:
// every lane is c0).
template <int V, bool NCHW>
__device__ __forceinline__ int chan0(const Geo& g)
{
    if constexpr (NCHW) return blockIdx.y;
    else return (threadIdx.x % (g.C / V)) * V;
}

// prm[c] of each lane's channel
template <int V, bool NCHW>
__device__ __forceinline__ void ldc(const float* prm, int c0, float (&v)[V])
{
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = __ldg(prm + (NCHW ? c0 : c0 + k));
}

// The offset of a lane-0 element in the other layout, and the stride
// between lanes there.
template <bool NCHW>
__device__ __forceinline__ size_t alt_off(const Geo& g, const Pos& q, int c0,
                                          size_t& stride)
{
    if constexpr (NCHW) {          // the other is NHWC
        stride = g.C;
        return (q.a * g.HW + q.b) * g.C + c0;
    } else {                       // the other is NCHW
        const size_t n = q.a / g.HW, p = q.a - n * g.HW;
        stride = g.HW;
        return (n * g.C + c0) * g.HW + p;
    }
}

template <typename T, int V, bool NCHW>
__device__ __forceinline__ void ld_sc(const T* p, const Geo& g, const Pos& q,
                                      int c0, bool alt, float (&v)[V])
{
    if (!alt) {
        ld<T, V>(p + q.off, v);
        return;
    }
    size_t stride;
    const T* s = p + alt_off<NCHW>(g, q, c0, stride);
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = tof(s[k * stride]);
}

template <typename T, int V, bool NCHW>
__device__ __forceinline__ void st_sc(T* p, const Geo& g, const Pos& q,
                                      int c0, bool alt, const float (&v)[V])
{
    if (!alt) {
        st<T, V>(p + q.off, v);
        return;
    }
    size_t stride;
    T* s = p + alt_off<NCHW>(g, q, c0, stride);
#pragma unroll
    for (int k = 0; k < V; ++k) s[k * stride] = fromf<T>(v[k]);
}

// body(Pos) for each of this thread's vectors (launch shapes: see shape()).
template <int V, bool NCHW, class F>
__device__ __forceinline__ void each(const Geo& g, F&& body)
{
    if constexpr (NCHW) {
        const size_t c = blockIdx.y, hwv = g.HW / V;
        const size_t n0 = blockIdx.x * (size_t)g.N / gridDim.x;
        const size_t n1 = (blockIdx.x + 1) * (size_t)g.N / gridDim.x;
        const size_t total = (n1 - n0) * hwv;
        for (size_t j = threadIdx.x; j < total; j += blockDim.x) {
            const size_t i = j / hwv, n = n0 + i, p0 = (j - i * hwv) * V;
            body(Pos{(n * g.C + c) * g.HW + p0, n, p0});
        }
    } else {
        const int cv = g.C / V, ty = threadIdx.x / cv, TY = blockDim.x / cv;
        const size_t c0 = (threadIdx.x - ty * cv) * V;
        const size_t rows = (size_t)g.N * g.HW;
        for (size_t row = (size_t)blockIdx.x * TY + ty; row < rows;
             row += (size_t)gridDim.x * TY)
            body(Pos{row * g.C + c0, row, 0});
    }
}

// Each of the K per-lane sums, summed over the block, written to
// part[(blockIdx.x * K + k) * C + c].
template <int K, int V, bool NCHW>
__device__ __forceinline__ void block_partials(const Geo& g,
                                               const float (&acc)[K][V],
                                               float* part)
{
    __shared__ float red[RED_FLOATS];
    if constexpr (NCHW) {
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        const int warps = blockDim.x >> 5;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            float s = 0.f;
#pragma unroll
            for (int v = 0; v < V; ++v) s += acc[k][v];
#pragma unroll
            for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
            if (lane == 0) red[k * 32 + warp] = s;
        }
        __syncthreads();
        if (threadIdx.x < K) {
            float s = 0.f;
            for (int w = 0; w < warps; ++w) s += red[threadIdx.x * 32 + w];
            part[((size_t)blockIdx.x * K + threadIdx.x) * g.C + blockIdx.y] = s;
        }
    } else {
        const int cv = g.C / V, ty = threadIdx.x / cv, TY = blockDim.x / cv;
        const int c0 = (threadIdx.x - ty * cv) * V;
#pragma unroll
        for (int k = 0; k < K; ++k) {
#pragma unroll
            for (int v = 0; v < V; ++v) red[ty * g.C + c0 + v] = acc[k][v];
            __syncthreads();
            for (int c = threadIdx.x; c < g.C; c += blockDim.x) {
                float s = 0.f;
                for (int t = 0; t < TY; ++t) s += red[t * g.C + c];
                part[((size_t)blockIdx.x * K + k) * g.C + c] = s;
            }
            __syncthreads();
        }
    }
}

// ------------------------------------------------------------------ kernels

template <typename T, int V, bool NCHW>
__global__ void __launch_bounds__(MAX_THREADS)
bn_moments_reduce(const T* __restrict__ y, float* __restrict__ part, Geo g)
{
    float acc[2][V] = {};
    each<V, NCHW>(g, [&](const Pos& q) {
        float v[V];
        ld<T, V>(y + q.off, v);
#pragma unroll
        for (int k = 0; k < V; ++k) {
            acc[0][k] += v[k];
            acc[1][k] = fmaf(v[k], v[k], acc[1][k]);
        }
    });
    block_partials<2, V, NCHW>(g, acc, part);
}

// out[i] = Σ_s part[s * kc + i], s in order: blocks of 32 columns x 32
// strided runs of splits, the runs then summed in order.
__global__ void __launch_bounds__(1024)
bn_partials_reduce(const float* __restrict__ part, int splits, int kc,
                   float* __restrict__ out)
{
    __shared__ float red[32][33];
    const int i = blockIdx.x * 32 + threadIdx.x;
    float s = 0.f;
    if (i < kc)
        for (int j = threadIdx.y; j < splits; j += 32)
            s += part[(size_t)j * kc + i];
    red[threadIdx.y][threadIdx.x] = s;
    __syncthreads();
    if (threadIdx.y == 0 && i < kc) {
        float t = 0.f;
        for (int r = 0; r < 32; ++r) t += red[r][threadIdx.x];
        out[i] = t;
    }
}

// prm: mean, mul, bias [, mean_d, mul_d, bias_d], C floats each
template <typename T, int V, bool NCHW, int MODE>
__global__ void __launch_bounds__(MAX_THREADS)
bn_act_elementwise_fwd(const T* __restrict__ y, const T* __restrict__ sc,
                       T* __restrict__ out, const float* __restrict__ prm,
                       Geo g, int relu, int sc_alt)
{
    const int c0 = chan0<V, NCHW>(g);
    float mean[V], mul[V], bias[V], meand[V], muld[V], biasd[V];
    ldc<V, NCHW>(prm, c0, mean);
    ldc<V, NCHW>(prm + g.C, c0, mul);
    ldc<V, NCHW>(prm + 2 * g.C, c0, bias);
    if constexpr (MODE == PROJ) {
        ldc<V, NCHW>(prm + 3 * g.C, c0, meand);
        ldc<V, NCHW>(prm + 4 * g.C, c0, muld);
        ldc<V, NCHW>(prm + 5 * g.C, c0, biasd);
    }
    each<V, NCHW>(g, [&](const Pos& q) {
        float v[V], r[V];
        ld<T, V>(y + q.off, v);
        if constexpr (MODE != PLAIN)
            ld_sc<T, V, NCHW>(sc, g, q, c0, sc_alt, r);
#pragma unroll
        for (int k = 0; k < V; ++k) {
            float z = rnd<T>(__fadd_rn(
                __fmul_rn(__fsub_rn(v[k], mean[k]), mul[k]), bias[k]));
            if constexpr (MODE == PROJ)
                r[k] = rnd<T>(__fadd_rn(
                    __fmul_rn(__fsub_rn(r[k], meand[k]), muld[k]), biasd[k]));
            if constexpr (MODE != PLAIN) z = rnd<T>(__fadd_rn(z, r[k]));
            if (relu && !(z > 0.f) && z == z) z = 0.f;
            v[k] = z;
        }
        st<T, V>(out + q.off, v);
    });
}

// prm: mean [, mean_d]; sums A, B [, Bd]; dr = g (IDENTITY)
template <typename T, int V, bool NCHW, int MODE>
__global__ void __launch_bounds__(MAX_THREADS)
bn_act_reduce_bwd(const T* __restrict__ go, const T* __restrict__ out,
                  const T* __restrict__ y, const T* __restrict__ yd,
                  T* __restrict__ dr, const float* __restrict__ prm,
                  float* __restrict__ part, Geo g, int relu, int sc_alt)
{
    constexpr int K = MODE == PROJ ? 3 : 2;
    const int c0 = chan0<V, NCHW>(g);
    float mean[V], meand[V];
    ldc<V, NCHW>(prm, c0, mean);
    if constexpr (MODE == PROJ) ldc<V, NCHW>(prm + g.C, c0, meand);
    float acc[K][V] = {};
    each<V, NCHW>(g, [&](const Pos& q) {
        float gv[V], v[V], d[V];
        ld<T, V>(go + q.off, gv);
        if (relu) {
            float o[V];
            ld<T, V>(out + q.off, o);
#pragma unroll
            for (int k = 0; k < V; ++k)
                if (o[k] <= 0.f) gv[k] = 0.f;
        }
        ld<T, V>(y + q.off, v);
        if constexpr (MODE == PROJ) ld_sc<T, V, NCHW>(yd, g, q, c0, sc_alt, d);
#pragma unroll
        for (int k = 0; k < V; ++k) {
            acc[0][k] += gv[k];
            acc[1][k] = fmaf(gv[k], __fsub_rn(v[k], mean[k]), acc[1][k]);
            if constexpr (MODE == PROJ)
                acc[K - 1][k] = fmaf(gv[k], __fsub_rn(d[k], meand[k]),
                                     acc[K - 1][k]);
        }
        if constexpr (MODE == IDENTITY) st<T, V>(dr + q.off, gv);
    });
    block_partials<K, V, NCHW>(g, acc, part);
}

// prm: mul, gs1, gs2 [, mul_d, gs1_d, gs2_d]; go is dr (already gated) for
// an identity shortcut, which the host launches as PLAIN without the ReLU
template <typename T, int V, bool NCHW, int MODE>
__global__ void __launch_bounds__(MAX_THREADS)
bn_act_elementwise_bwd(const T* __restrict__ go, const T* __restrict__ out,
                       const T* __restrict__ y, const T* __restrict__ yd,
                       T* __restrict__ dy, T* __restrict__ dyd,
                       const float* __restrict__ prm, Geo g, int relu,
                       int sc_alt)
{
    const int c0 = chan0<V, NCHW>(g);
    float mul[V], gs1[V], gs2[V], muld[V], gs1d[V], gs2d[V];
    ldc<V, NCHW>(prm, c0, mul);
    ldc<V, NCHW>(prm + g.C, c0, gs1);
    ldc<V, NCHW>(prm + 2 * g.C, c0, gs2);
    if constexpr (MODE == PROJ) {
        ldc<V, NCHW>(prm + 3 * g.C, c0, muld);
        ldc<V, NCHW>(prm + 4 * g.C, c0, gs1d);
        ldc<V, NCHW>(prm + 5 * g.C, c0, gs2d);
    }
    each<V, NCHW>(g, [&](const Pos& q) {
        float gv[V], v[V];
        ld<T, V>(go + q.off, gv);
        if (relu) {
            float o[V];
            ld<T, V>(out + q.off, o);
#pragma unroll
            for (int k = 0; k < V; ++k)
                if (o[k] <= 0.f) gv[k] = 0.f;
        }
        ld<T, V>(y + q.off, v);
#pragma unroll
        for (int k = 0; k < V; ++k)
            v[k] = fmaf(gv[k], mul[k], gs1[k]) + 2.f * v[k] * gs2[k];
        st<T, V>(dy + q.off, v);
        if constexpr (MODE == PROJ) {
            float d[V];
            ld_sc<T, V, NCHW>(yd, g, q, c0, sc_alt, d);
#pragma unroll
            for (int k = 0; k < V; ++k)
                d[k] = fmaf(gv[k], muld[k], gs1d[k]) + 2.f * d[k] * gs2d[k];
            st_sc<T, V, NCHW>(dyd, g, q, c0, sc_alt, d);
        }
    });
}

// prm: gs1, gs2; out = T((gy + gs1) + (2·y)·gs2), the eager fold's order
template <typename T, int V, bool NCHW>
__global__ void __launch_bounds__(MAX_THREADS)
bn_fold_elementwise(const T* __restrict__ gy, const T* __restrict__ y,
                    T* __restrict__ out, const float* __restrict__ prm, Geo g)
{
    const int c0 = chan0<V, NCHW>(g);
    float gs1[V], gs2[V];
    ldc<V, NCHW>(prm, c0, gs1);
    ldc<V, NCHW>(prm + g.C, c0, gs2);
    each<V, NCHW>(g, [&](const Pos& q) {
        float gv[V], v[V];
        ld<T, V>(gy + q.off, gv);
        ld<T, V>(y + q.off, v);
#pragma unroll
        for (int k = 0; k < V; ++k)
            gv[k] = __fadd_rn(__fadd_rn(gv[k], gs1[k]),
                              __fmul_rn(__fmul_rn(2.f, v[k]), gs2[k]));
        st<T, V>(out + q.off, gv);
    });
}


// ------------------------------------------------------------------- host

struct Launch {
    dim3 grid, block;
};

// NCHW: splits x C blocks of THREADS, each split a share of the images;
// NHWC: blocks of C/V threads x TY rows, TY = THREADS / (C/V) or 1.
template <int V>
Launch shape(const Geo& g, bool nchw, int max_blocks)
{
    if (nchw) {
        long long s = (max_blocks + g.C - 1) / g.C;
        if (s > g.N) s = g.N;
        if (s < 1) s = 1;
        return {dim3((unsigned)s, (unsigned)g.C), dim3(THREADS)};
    }
    const int cv = g.C / V, ty = cv >= THREADS ? 1 : THREADS / cv;
    long long b = (g.N * g.HW + ty - 1) / ty;
    if (b > max_blocks) b = max_blocks;
    if (b < 1) b = 1;
    return {dim3((unsigned)b), dim3((unsigned)(cv * ty))};
}

bool aligned(const void* p) { return p == nullptr || (uintptr_t)p % 16 == 0; }

// Whether the launch takes 16-byte vectors (the geometry and every pointer
// allow them), or -1 for a geometry the kernels do not take.
int vectors(const Geo& g, int nchw, int is_bf16, const void* const* ptrs,
            int n_ptrs)
{
    if (g.N < 0 || g.HW < 1 || g.C < 1 || g.C > 65535) return -1;
    const int vw = is_bf16 ? 8 : 4;
    bool vec = (nchw ? g.HW : g.C) % vw == 0;
    for (int i = 0; i < n_ptrs; ++i) vec = vec && aligned(ptrs[i]);
    if (!nchw && (g.C > MAX_C || g.C / (vec ? vw : 1) > MAX_THREADS))
        return -1;
    return vec ? 1 : 0;
}

// FN<T, V, NCHW>(args...) for the type, the vector width and the layout
#define BN_DISPATCH(is_bf16, vec, nchw, FN, ...)                            \
    ((is_bf16) ? ((vec) ? ((nchw) ? FN<bf16, 8, true>(__VA_ARGS__)          \
                                  : FN<bf16, 8, false>(__VA_ARGS__))        \
                        : ((nchw) ? FN<bf16, 1, true>(__VA_ARGS__)          \
                                  : FN<bf16, 1, false>(__VA_ARGS__)))       \
               : ((vec) ? ((nchw) ? FN<float, 4, true>(__VA_ARGS__)         \
                                  : FN<float, 4, false>(__VA_ARGS__))       \
                        : ((nchw) ? FN<float, 1, true>(__VA_ARGS__)         \
                                  : FN<float, 1, false>(__VA_ARGS__))))

int finalize(const float* part, int splits, int kc, float* sums,
             cudaStream_t stream)
{
    bn_partials_reduce<<<(kc + 31) / 32, dim3(32, 32), 0, stream>>>(
        part, splits, kc, sums);
    return (int)cudaGetLastError();
}

template <typename T, int V, bool NC>
int moments_go(const Geo& g, const void* y, void* part, int* splits,
               cudaStream_t stream)
{
    const Launch L = shape<V>(g, NC, RED_BLOCKS);
    *splits = (int)L.grid.x;
    bn_moments_reduce<T, V, NC><<<L.grid, L.block, 0, stream>>>(
        (const T*)y, (float*)part, g);
    return (int)cudaGetLastError();
}

template <typename T, int V, bool NC>
int fwd_go(const Geo& g, const void* y, const void* sc, void* out,
           const void* prm, int mode, int relu, int alt, cudaStream_t stream)
{
    const Launch L = shape<V>(g, NC, EW_BLOCKS);
    const T *a = (const T*)y, *s = (const T*)sc;
    const float* p = (const float*)prm;
    T* o = (T*)out;
    if (mode == PLAIN)
        bn_act_elementwise_fwd<T, V, NC, PLAIN>
            <<<L.grid, L.block, 0, stream>>>(a, s, o, p, g, relu, alt);
    else if (mode == IDENTITY)
        bn_act_elementwise_fwd<T, V, NC, IDENTITY>
            <<<L.grid, L.block, 0, stream>>>(a, s, o, p, g, relu, alt);
    else
        bn_act_elementwise_fwd<T, V, NC, PROJ>
            <<<L.grid, L.block, 0, stream>>>(a, s, o, p, g, relu, alt);
    return (int)cudaGetLastError();
}

template <typename T, int V, bool NC>
int reduce_bwd_go(const Geo& g, const void* go, const void* out,
                  const void* y, const void* yd, void* dr, const void* prm,
                  void* part, int* splits, int mode, int relu, int alt,
                  cudaStream_t stream)
{
    const Launch L = shape<V>(g, NC, RED_BLOCKS);
    *splits = (int)L.grid.x;
    const T *a = (const T*)go, *o = (const T*)out, *b = (const T*)y,
            *d = (const T*)yd;
    const float* p = (const float*)prm;
    float* q = (float*)part;
    if (mode == PLAIN)
        bn_act_reduce_bwd<T, V, NC, PLAIN><<<L.grid, L.block, 0, stream>>>(
            a, o, b, d, (T*)dr, p, q, g, relu, alt);
    else if (mode == IDENTITY)
        bn_act_reduce_bwd<T, V, NC, IDENTITY><<<L.grid, L.block, 0, stream>>>(
            a, o, b, d, (T*)dr, p, q, g, relu, alt);
    else
        bn_act_reduce_bwd<T, V, NC, PROJ><<<L.grid, L.block, 0, stream>>>(
            a, o, b, d, (T*)dr, p, q, g, relu, alt);
    return (int)cudaGetLastError();
}

template <typename T, int V, bool NC>
int apply_bwd_go(const Geo& g, const void* go, const void* out,
                 const void* y, const void* yd, void* dy, void* dyd,
                 const void* prm, int mode, int relu, int alt,
                 cudaStream_t stream)
{
    const Launch L = shape<V>(g, NC, EW_BLOCKS);
    const T *a = (const T*)go, *o = (const T*)out, *b = (const T*)y,
            *d = (const T*)yd;
    const float* p = (const float*)prm;
    if (mode == PLAIN)
        bn_act_elementwise_bwd<T, V, NC, PLAIN><<<L.grid, L.block, 0,
            stream>>>(a, o, b, d, (T*)dy, (T*)dyd, p, g, relu, alt);
    else
        bn_act_elementwise_bwd<T, V, NC, PROJ><<<L.grid, L.block, 0,
            stream>>>(a, o, b, d, (T*)dy, (T*)dyd, p, g, relu, alt);
    return (int)cudaGetLastError();
}

template <typename T, int V, bool NC>
int fold_go(const Geo& g, const void* gy, const void* y, void* out,
            const void* prm, cudaStream_t stream)
{
    const Launch L = shape<V>(g, NC, EW_BLOCKS);
    bn_fold_elementwise<T, V, NC><<<L.grid, L.block, 0, stream>>>(
        (const T*)gy, (const T*)y, (T*)out, (const float*)prm, g);
    return (int)cudaGetLastError();
}

}  // namespace

// partials a reduce launch writes at most, per sum and channel
extern "C" int bn_act_max_splits() { return RED_BLOCKS; }

// Whether the kernels take this geometry in this layout (the wrapper's
// check before it allocates): 1 or 0.
extern "C" int bn_act_takes(long long N, int C, long long HW, int nchw,
                            int is_bf16)
{
    return vectors(Geo{N, HW, C}, nchw, is_bf16, nullptr, 0) >= 0;
}

// sums (2, C) f32: Σ y, Σ y²; part: bn_act_max_splits() * 2 * C floats
extern "C" int bn_moments_launch(const void* y, void* part, void* sums,
                                 long long N, int C, long long HW, int nchw,
                                 int is_bf16, cudaStream_t stream)
{
    const Geo g{N, HW, C};
    const void* ptrs[] = {y};
    const int vec = vectors(g, nchw, is_bf16, ptrs, 1);
    if (vec < 0) return (int)cudaErrorInvalidValue;
    int splits = 0;
    const int err = BN_DISPATCH(is_bf16, vec, nchw, moments_go, g, y, part,
                                &splits, stream);
    if (err) return err;
    return finalize((const float*)part, splits, 2 * C, (float*)sums, stream);
}

// out = relu(T(T(BN(y)) + r)): mode 0 no shortcut, 1 identity (sc = r), 2
// projection (sc = yd, normalized in the pass); prm as the kernel's;
// sc_nchw the shortcut's layout, which may differ from y's
extern "C" int bn_act_fwd_launch(const void* y, const void* sc, void* out,
                                 const void* prm, long long N, int C,
                                 long long HW, int nchw, int sc_nchw,
                                 int mode, int relu, int is_bf16,
                                 cudaStream_t stream)
{
    if (mode < PLAIN || mode > PROJ) return (int)cudaErrorInvalidValue;
    const Geo g{N, HW, C};
    const int alt = mode != PLAIN && sc_nchw != nchw;
    const void* ptrs[] = {y, alt || mode == PLAIN ? nullptr : sc, out};
    const int vec = vectors(g, nchw, is_bf16, ptrs, 3);
    if (vec < 0) return (int)cudaErrorInvalidValue;
    return BN_DISPATCH(is_bf16, vec, nchw, fwd_go, g, y, sc, out, prm, mode,
                       relu, alt, stream);
}

// The backward's reduce pass: sums (K, C) f32, K = 3 with a projection (A,
// B, Bd) else 2 (A, B); dr = g written for an identity shortcut (mode 1);
// part: bn_act_max_splits() * K * C floats; prm: mean [, mean_d]
extern "C" int bn_act_reduce_bwd_launch(const void* go, const void* out,
                                        const void* y, const void* yd,
                                        void* dr, const void* prm, void* part,
                                        void* sums, long long N, int C,
                                        long long HW, int nchw, int sc_nchw,
                                        int mode, int relu, int is_bf16,
                                        cudaStream_t stream)
{
    if (mode < PLAIN || mode > PROJ) return (int)cudaErrorInvalidValue;
    const Geo g{N, HW, C};
    const int alt = mode == PROJ && sc_nchw != nchw;
    const void* ptrs[] = {go, out, y, mode == PROJ && !alt ? yd : nullptr,
                          mode == IDENTITY ? dr : nullptr};
    const int vec = vectors(g, nchw, is_bf16, ptrs, 5);
    if (vec < 0) return (int)cudaErrorInvalidValue;
    int splits = 0;
    const int err = BN_DISPATCH(is_bf16, vec, nchw, reduce_bwd_go, g, go, out,
                                y, yd, dr, prm, part, &splits, mode, relu,
                                alt, stream);
    if (err) return err;
    return finalize((const float*)part, splits, (mode == PROJ ? 3 : 2) * C,
                    (float*)sums, stream);
}

// The backward's apply pass: dy, and dyd with a projection (mode 2; else
// mode 0); go is the gated gradient dr for an identity shortcut, launched
// with relu 0; prm: mul, gs1, gs2 [, mul_d, gs1_d, gs2_d]
extern "C" int bn_act_apply_bwd_launch(const void* go, const void* out,
                                       const void* y, const void* yd,
                                       void* dy, void* dyd, const void* prm,
                                       long long N, int C, long long HW,
                                       int nchw, int sc_nchw, int mode,
                                       int relu, int is_bf16,
                                       cudaStream_t stream)
{
    if (mode != PLAIN && mode != PROJ) return (int)cudaErrorInvalidValue;
    const Geo g{N, HW, C};
    const int alt = mode == PROJ && sc_nchw != nchw;
    const bool same = mode == PROJ && !alt;
    const void* ptrs[] = {go, relu ? out : nullptr, y, same ? yd : nullptr,
                          dy, same ? dyd : nullptr};
    const int vec = vectors(g, nchw, is_bf16, ptrs, 6);
    if (vec < 0) return (int)cudaErrorInvalidValue;
    return BN_DISPATCH(is_bf16, vec, nchw, apply_bwd_go, g, go, out, y, yd,
                       dy, dyd, prm, mode, relu, alt, stream);
}

// gy' = T(gy + gs1 + 2·y·gs2), gy and y in one layout; prm: gs1, gs2
extern "C" int bn_fold_launch(const void* gy, const void* y, void* out,
                              const void* prm, long long N, int C,
                              long long HW, int nchw, int is_bf16,
                              cudaStream_t stream)
{
    const Geo g{N, HW, C};
    const void* ptrs[] = {gy, y, out};
    const int vec = vectors(g, nchw, is_bf16, ptrs, 3);
    if (vec < 0) return (int)cudaErrorInvalidValue;
    return BN_DISPATCH(is_bf16, vec, nchw, fold_go, g, gy, y, out, prm,
                       stream);
}
