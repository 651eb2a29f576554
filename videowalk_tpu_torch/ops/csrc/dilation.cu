// L1-ball (diamond) binary dilation of a stack of 0/1 masks, one block per
// (mask, band of whole rows), the band held as bits in shared memory.
//
// Replaces the Pallas TPU kernel videowalk_tpu/ops/dilation_kernel.py::
// _dilate_kernel (via dilate_l1_pallas), built from what it computes, not
// from its 17 shifted maxes over a VMEM-resident block:
//   out[n, y, x] = 1 iff some set pixel (y', x') of mask n inside the frame
//                  has |y - y'| + |x - x'| <= r          (zero outside)
//
// Bound: bytes. One read and one write of the stack (1152 masks of 256x256
// in bf16 at the superpixel step of record: 302 MB, 0.09 ms at 3.35 TB/s);
// the arithmetic is a few bit operations a pixel.
//
// Design. A block takes `band` whole rows of one mask and their window, the
// band with up to r rows above and below it, clipped at the frame (at the
// step of record a band is the whole frame: every pixel is read once; a band
// re-reads (band + 2r) / band of its rows otherwise).
//   load     a warp reads a row with 16-byte loads (8 bf16, 16 uint8 or 4
//            f32 a lane), LOADS of them in flight a lane before it uses any;
//            each lane turns its values into set bits, the lanes of one
//            32-pixel word OR them together by shuffles and the first
//            writes the word: a row is ceil(w / 32) words in shared memory.
//            Rows that are not a multiple of the vector, or a stack that is
//            not 16-byte aligned, take one pixel a lane and a ballot a word.
//            The block also finds the first and last row with a set bit: a
//            one-hot mask is empty in most rows, and in every row of a quarter
//            of the step's masks (absent node slots).
//   dilate   passes of the radius-KMAX diamond (the last one the rest of r),
//            each the composition of KMAX unit diamonds
//              new[y] = old[y] | old[y-1] | old[y+1] | old[y] << 1 | old[y] >> 1
//            in one step (r = 27: 7 passes); two buffers in turn, one barrier
//            a pass. Clipping to the window at every pass is exact: a
//            shortest L1 path between two pixels stays in their bounding box,
//            and a set pixel outside the window is farther than r from the
//            band. For the same reason the bits past the frame's width in a
//            row's last word may fill: they never reach a pixel of the frame
//            sooner than a path inside it, and are not stored. After a radius
//            d a pass computes only the rows within r - d of the band and
//            within d of the set rows, and reads the others as zeros: at the
//            step a segment spans ~1/6 of the frame's rows, so most of the
//            passes' work goes, and an empty window takes none. A thread
//            takes STRIP rows of one word column: it reads the column's words
//            of the rows within KMAX of its strip and their left and right
//            neighbours once, spreads each row along itself by funnel shifts
//            (the carries across words) and ORs the rows of each output
//            word; the row pitch is odd so that the strips of a warp fall on
//            other banks.
//   store    a lane expands its 8 (16, 4) bits to 16 bytes and writes them:
//            a warp writes a 256-pixel bf16 row in one instruction. Only the
//            band's rows are written, as zeros where no set row is within r.
// Shared memory, all of it dynamic: 2 * min(h, band + 2r) * pitch * 4 bytes,
// pitch = ceil(w / 32) | 1 words, and 64 bytes for the set rows' reduction:
// 18 KB for a 256x256 frame. The wrapper (ops/dilation.py::choose_band) picks
// the band and refuses a width whose window of one row does not fit the
// card's 227 KB; the launch checks the same against the device's opt-in.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (videowalk_tpu_torch/ops/_build.py); plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int LOADS = 8;     // 16-byte loads in flight a lane
constexpr int STRIP = 8;     // rows a thread takes in a pass
constexpr int KMAX = 4;      // the radius of a pass (the last takes the rest)
static_assert(KMAX >= 2 && KMAX <= 4, "diamond_pass is dispatched for 1..4");
// mirrors MAX_RADIUS of ops/dilation.py, which makes the check a caller sees
constexpr int MAX_RADIUS = 127;
// the set rows' reduction at the head of the dynamic buffer: a first and a
// last row a warp (16-byte multiple, so the bit buffers stay aligned)
constexpr int ROWS_BYTES = 2 * WARPS * 4;
static_assert(ROWS_BYTES % 16 == 0, "bit buffers start 16-byte aligned");
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline int row_words(int w) { return (w + 31) / 32; }
__host__ __device__ inline int pitch(int w) { return row_words(w) | 1; }

// bf16 travels as its 16 bits: any value but +-0 counts as set, 1.0 is 0x3f80
__device__ __forceinline__ bool is_set(uint8_t v) { return v != 0; }
__device__ __forceinline__ bool is_set(uint16_t v) { return (v & 0x7fffu) != 0; }
__device__ __forceinline__ bool is_set(float v) { return v != 0.0f; }

__device__ __forceinline__ void store1(uint8_t* p, bool s) { *p = s ? 1 : 0; }
__device__ __forceinline__ void store1(uint16_t* p, bool s) { *p = s ? 0x3f80 : 0; }
__device__ __forceinline__ void store1(float* p, bool s) { *p = s ? 1.0f : 0.0f; }

// the set bits of one 16-byte vector, pixel i at bit i
__device__ __forceinline__ uint32_t bits16(uint4 v, uint8_t) {
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
    uint32_t b = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const uint32_t t = __vcmpne4(u[k], 0u) & 0x08040201u;
        b |= ((t | t >> 8 | t >> 16 | t >> 24) & 0xfu) << (4 * k);
    }
    return b;
}
__device__ __forceinline__ uint32_t bits16(uint4 v, uint16_t) {
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
    uint32_t b = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
        b |= ((u[k] & 0x00007fffu) ? 1u : 0u) << (2 * k)
           | ((u[k] & 0x7fff0000u) ? 2u : 0u) << (2 * k);
    return b;
}
__device__ __forceinline__ uint32_t bits16(uint4 v, float) {
    return (__uint_as_float(v.x) != 0.0f ? 1u : 0u)
         | (__uint_as_float(v.y) != 0.0f ? 2u : 0u)
         | (__uint_as_float(v.z) != 0.0f ? 4u : 0u)
         | (__uint_as_float(v.w) != 0.0f ? 8u : 0u);
}

// one 16-byte vector of ones and zeros from its bits, pixel i at bit i
__device__ __forceinline__ uint4 expand16(uint32_t b, uint8_t) {
    uint32_t u[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)   // nibble bit j to byte j
        u[k] = (((b >> (4 * k)) & 0xfu) * 0x00204081u) & 0x01010101u;
    return make_uint4(u[0], u[1], u[2], u[3]);
}
__device__ __forceinline__ uint4 expand16(uint32_t b, uint16_t) {
    uint32_t u[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
        u[k] = ((b >> (2 * k)) & 1u ? 0x00003f80u : 0u)
             | ((b >> (2 * k + 1)) & 1u ? 0x3f800000u : 0u);
    return make_uint4(u[0], u[1], u[2], u[3]);
}
__device__ __forceinline__ uint4 expand16(uint32_t b, float) {
    return make_uint4(b & 1u ? 0x3f800000u : 0u, b & 2u ? 0x3f800000u : 0u,
                      b & 4u ? 0x3f800000u : 0u, b & 8u ? 0x3f800000u : 0u);
}

// the first and last window row that holds a set bit (top > bot: none)
struct Rows {
    int top = 0x7fffffff, bot = -1;
    __device__ void add(int row) { top = min(top, row); bot = max(bot, row); }
};

// rows [wy0, wy0 + R) of a mask into words; returns the rows with set bits
// this lane saw
template <typename T>
__device__ Rows load_vec(const T* __restrict__ xm, int w, int wy0, int R,
                         uint32_t* buf, int P)
{
    constexpr int V = 16 / sizeof(T), G = 32 / V;     // pixels a lane, lanes a word
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nv = w / V, chunks = (nv + 31) / 32, items = R * chunks;
    Rows set;
    for (int base = warp; base < items; base += WARPS * LOADS) {
        uint4 v[LOADS];
#pragma unroll
        for (int u = 0; u < LOADS; ++u) {
            const int item = base + u * WARPS;
            const int row = item / chunks, vi = (item - row * chunks) * 32 + lane;
            v[u] = make_uint4(0u, 0u, 0u, 0u);
            if (item < items && vi < nv)
                v[u] = __ldcs(reinterpret_cast<const uint4*>(
                    xm + (size_t)(wy0 + row) * w) + vi);
        }
#pragma unroll
        for (int u = 0; u < LOADS; ++u) {
            const int item = base + u * WARPS;
            const int row = item / chunks, vi = (item - row * chunks) * 32 + lane;
            uint32_t word = bits16(v[u], T()) << ((vi * V) & 31);
#pragma unroll
            for (int o = 1; o < G; o <<= 1) word |= __shfl_xor_sync(FULL, word, o);
            if (word) set.add(row);
            if (item < items && vi < nv && (lane & (G - 1)) == 0)
                buf[row * P + vi * V / 32] = word;
        }
    }
    return set;
}

template <typename T>
__device__ Rows load_scalar(const T* __restrict__ xm, int w, int wy0, int R,
                            uint32_t* buf, int P)
{
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int WW = row_words(w), items = R * WW;
    Rows set;
    for (int base = warp; base < items; base += WARPS * LOADS) {
        T v[LOADS];
#pragma unroll
        for (int u = 0; u < LOADS; ++u) {
            const int item = base + u * WARPS;
            const int row = item / WW, gx = (item - row * WW) * 32 + lane;
            v[u] = T(0);
            if (item < items && gx < w) v[u] = xm[(size_t)(wy0 + row) * w + gx];
        }
#pragma unroll
        for (int u = 0; u < LOADS; ++u) {
            const int item = base + u * WARPS;
            const uint32_t word = __ballot_sync(FULL, is_set(v[u]));
            if (word) set.add(item / WW);
            if (item < items && lane == 0) buf[item / WW * P + item % WW] = word;
        }
    }
    return set;
}

// one pass of the radius-K diamond over window rows [lo, hi), the rows of
// src outside [rlo, rhi) read as zeros:
//   new[y] = OR over |dy| <= K of old[y + dy] spread along the row by K - |dy|
// A thread takes STRIP rows of one word column: it loads the column's words
// of the rows within K of its strip and their left and right words once,
// spreads each row along itself by funnel shifts (the carries across words)
// and ORs the rows of each output word.
template <int K>
__device__ __forceinline__ void diamond_pass(const uint32_t* src, uint32_t* dst,
                                             int lo, int hi, int rlo, int rhi,
                                             int WW, int P)
{
    constexpr int NR = STRIP + 2 * K;    // rows read a strip
    const int strips = (hi - lo + STRIP - 1) / STRIP;
    for (int item = threadIdx.x; item < strips * WW; item += THREADS) {
        const int s = item / WW, j = item - s * WW;
        const int ya = lo + s * STRIP;
        uint32_t c[NR], l[NR], rt[NR];
#pragma unroll
        for (int i = 0; i < NR; ++i) {
            const int y = ya - K + i;
            const bool in = y >= rlo && y < rhi;
            // the strip's first and last rows are read at |dy| = K only
            const bool side = in && i > 0 && i < NR - 1;
            c[i] = in ? src[y * P + j] : 0u;
            l[i] = side && j > 0 ? src[y * P + j - 1] : 0u;
            rt[i] = side && j + 1 < WW ? src[y * P + j + 1] : 0u;
        }
#pragma unroll
        for (int o = 0; o < STRIP; ++o) {
            if (ya + o >= hi) break;
            uint32_t v = c[o] | c[o + 2 * K];
#pragma unroll
            for (int i = o + 1; i < o + 2 * K; ++i) {
                const int m = K - abs(i - o - K);
                uint32_t hrow = c[i];
#pragma unroll
                for (int t = 1; t <= m; ++t)
                    hrow |= __funnelshift_l(l[i], c[i], t)
                          | __funnelshift_r(c[i], rt[i], t);
                v |= hrow;
            }
            dst[(ya + o) * P + j] = v;
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dilate_l1_kernel(const T* __restrict__ x, T* __restrict__ out, int h, int w,
                 int r, int band, int bands, int vec)
{
    extern __shared__ __align__(16) uint32_t smem[];
    const int P = pitch(w), WW = row_words(w);
    const int n = blockIdx.x / bands;
    const int y0 = (blockIdx.x - n * bands) * band, y1 = min(h, y0 + band);
    const int wy0 = max(0, y0 - r), R = min(h, y1 + r) - wy0;
    int (*rows_of)[WARPS] = reinterpret_cast<int (*)[WARPS]>(smem);
    uint32_t* buf[2] = {smem + ROWS_BYTES / 4, smem + ROWS_BYTES / 4 + R * P};
    const T* xm = x + (size_t)n * h * w;
    T* om = out + (size_t)n * h * w;

    Rows set = vec ? load_vec(xm, w, wy0, R, buf[0], P)
                   : load_scalar(xm, w, wy0, R, buf[0], P);
    set.top = __reduce_min_sync(FULL, set.top);
    set.bot = __reduce_max_sync(FULL, set.bot);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) {
        rows_of[0][warp] = set.top;
        rows_of[1][warp] = set.bot;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < WARPS; ++i) {
        set.top = min(set.top, rows_of[0][i]);
        set.bot = max(set.bot, rows_of[1][i]);
    }

    // passes of radius KMAX, the last one of what is left. After a radius d
    // the set bits lie in rows [top - d, bot + d]: a pass computes those of
    // them within r - d of the band, and reads the rest as zeros
    const int passes = (r + KMAX - 1) / KMAX;
    if (set.top <= set.bot) {
        for (int p = 0, done = 0; p < passes; ++p) {
            const int k = min(KMAX, r - done);
            const int rlo = max(0, set.top - done);
            const int rhi = min(R, set.bot + done + 1);
            done += k;
            const int lo = max(max(0, y0 - (r - done) - wy0), set.top - done);
            const int hi = min(min(R, y1 + (r - done) - wy0), set.bot + done + 1);
            const uint32_t* src = buf[p & 1];
            uint32_t* dst = buf[(p + 1) & 1];
            switch (k) {
                case 1: diamond_pass<1>(src, dst, lo, hi, rlo, rhi, WW, P); break;
                case 2: diamond_pass<2>(src, dst, lo, hi, rlo, rhi, WW, P); break;
                case 3: diamond_pass<3>(src, dst, lo, hi, rlo, rhi, WW, P); break;
                default: diamond_pass<KMAX>(src, dst, lo, hi, rlo, rhi, WW, P);
            }
            __syncthreads();
        }
    }
    // the band's rows that may hold set bits, [ylo, yhi) of the band
    const int ylo = set.top - r - (y0 - wy0), yhi = set.bot + r + 1 - (y0 - wy0);
    const uint32_t* res = buf[passes & 1] + (y0 - wy0) * P;

    if (vec) {
        constexpr int V = 16 / sizeof(T);
        const int nv = w / V, chunks = (nv + 31) / 32;
        const int items = (y1 - y0) * chunks;
        for (int item = warp; item < items; item += WARPS) {
            const int row = item / chunks, vi = (item - row * chunks) * 32 + lane;
            if (vi >= nv) continue;
            const uint32_t word = row >= ylo && row < yhi
                                  ? res[row * P + vi * V / 32] : 0u;
            const uint32_t b = (word >> ((vi * V) & 31)) & ((1u << V) - 1u);
            __stcs(reinterpret_cast<uint4*>(om + (size_t)(y0 + row) * w) + vi,
                   expand16(b, T()));
        }
    } else {
        const int items = (y1 - y0) * WW;
        for (int item = warp; item < items; item += WARPS) {
            const int row = item / WW, j = item - row * WW, gx = j * 32 + lane;
            if (gx >= w) continue;
            const uint32_t word = row >= ylo && row < yhi ? res[row * P + j]
                                                          : 0u;
            store1(om + (size_t)(y0 + row) * w + gx, (word >> lane) & 1u);
        }
    }
}

template <typename T>
int launch(const void* x, void* out, int N, int h, int w, int r, int band,
           cudaStream_t stream)
{
    const int bands = (h + band - 1) / band;
    const long long blocks = (long long)N * bands;
    const long long smem = 2LL * min(h, band + 2 * r) * pitch(w) * 4
                           + ROWS_BYTES;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        // static and dynamic shared memory together within the opt-in
        int dev = 0, optin = 0;
        cudaFuncAttributes fa;
        cudaError_t e = cudaGetDevice(&dev);
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(
                &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, dilate_l1_kernel<T>);
        if (e != cudaSuccess) return (int)e;
        if (smem + (long long)fa.sharedSizeBytes > optin)
            return (int)cudaErrorInvalidValue;
        e = cudaFuncSetAttribute(
            dilate_l1_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    // 16-byte loads and stores: rows a multiple of the vector from 16-byte bases
    constexpr int V = 16 / sizeof(T);
    const int vec = (w % V == 0) && ((uintptr_t)x % 16 == 0)
                    && ((uintptr_t)out % 16 == 0);
    dilate_l1_kernel<T><<<(unsigned)blocks, THREADS, (size_t)smem, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), h, w, r, band, bands,
        vec);
    return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 uint8, 1 bfloat16, 2 float32; band: rows a block takes (1..h).
// Returns the cudaError of the launch.
extern "C" int dilate_l1_launch(const void* x, void* out, int N, int h, int w,
                                int r, int dtype, int band, cudaStream_t stream)
{
    if (r < 1 || r > MAX_RADIUS || N < 1 || h < 1 || w < 1 || band < 1
        || band > h)
        return (int)cudaErrorInvalidValue;
    switch (dtype) {
        case 0: return launch<uint8_t>(x, out, N, h, w, r, band, stream);
        case 1: return launch<uint16_t>(x, out, N, h, w, r, band, stream);
        case 2: return launch<float>(x, out, N, h, w, r, band, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}
