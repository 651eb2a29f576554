// L1-ball (diamond) binary dilation of a stack of 0/1 masks, one block per
// (mask, 64x64 tile).
//
// Replaces the Pallas TPU kernel videowalk_tpu/ops/dilation_kernel.py::
// _dilate_kernel (via dilate_l1_pallas), built from what it computes, not
// from its 17 shifted maxes over a VMEM-resident block:
//   out[n, y, x] = 1 iff some set pixel (y', x') of mask n inside the frame
//                  has |y - y'| + |x - x'| <= r          (zero outside)
//
// Bound: bytes. One read and one write of the stack (1152 masks of 256x256
// in bf16 at the superpixel step of record: 302 MB, 0.09 ms at 3.35 TB/s);
// the arithmetic is a few integer operations a pixel.
//
// Design: simple and exact. A block loads its tile with an r-wide halo as
// bytes into shared memory (neighbouring tiles re-read the halo, mostly from
// L2: 3.4x the tile at r = 27). If the halo holds no set pixel the tile is
// written as zeros at once (a one-hot superpixel mask is empty over most of
// the frame). Otherwise
//   row pass     one thread per halo row sweeps left-to-right and
//                right-to-left and leaves, for the tile's 64 columns, the
//                distance along the row to the nearest set pixel, clipped at
//                r + 1, as a byte;
//   column pass  out[y][x] = any over |dy| <= r of dh[y + dy][x] <= r - |dy|,
//                four pixels a thread: one 32-bit shared-memory word holds
//                four neighbouring distances and __vcmpleu4 compares them
//                with the threshold in one instruction.
// The result goes out as four pixels a store where the row length and the
// pointer allow it. Shared memory: (64 + 2r)^2 + (64 + 2r) * 64 bytes, 21 KB
// at r = 27 and 122 KB at the largest radius taken (127: distances are
// bytes).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (videowalk_tpu_torch/ops/_build.py); plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 64, TW = 64, THREADS = 256, WORDS = TW / 4;
// mirrors MAX_RADIUS of ops/dilation.py, which makes the check a caller sees
constexpr int MAX_RADIUS = 127;

// bf16 travels as its 16 bits: any value but +-0 counts as set, 1.0 is 0x3f80
__device__ __forceinline__ bool is_set(uint8_t v) { return v != 0; }
__device__ __forceinline__ bool is_set(uint16_t v) { return (v & 0x7fffu) != 0; }
__device__ __forceinline__ bool is_set(float v) { return v != 0.0f; }

__device__ __forceinline__ void store1(uint8_t* p, bool s) { *p = s ? 1 : 0; }
__device__ __forceinline__ void store1(uint16_t* p, bool s) { *p = s ? 0x3f80 : 0; }
__device__ __forceinline__ void store1(float* p, bool s) { *p = s ? 1.0f : 0.0f; }

// four pixels at once; acc holds 0xff or 0x00 in each byte
__device__ __forceinline__ void store4(uint8_t* p, uint32_t acc) {
    *reinterpret_cast<uint32_t*>(p) = acc & 0x01010101u;
}
__device__ __forceinline__ void store4(uint16_t* p, uint32_t acc) {
    uint2 v;
    v.x = ((acc & 0x000000ffu) ? 0x00003f80u : 0u)
        | ((acc & 0x0000ff00u) ? 0x3f800000u : 0u);
    v.y = ((acc & 0x00ff0000u) ? 0x00003f80u : 0u)
        | ((acc & 0xff000000u) ? 0x3f800000u : 0u);
    *reinterpret_cast<uint2*>(p) = v;
}
__device__ __forceinline__ void store4(float* p, uint32_t acc) {
    float4 v;
    v.x = (acc & 0x000000ffu) ? 1.0f : 0.0f;
    v.y = (acc & 0x0000ff00u) ? 1.0f : 0.0f;
    v.z = (acc & 0x00ff0000u) ? 1.0f : 0.0f;
    v.w = (acc & 0xff000000u) ? 1.0f : 0.0f;
    *reinterpret_cast<float4*>(p) = v;
}

__host__ __device__ inline int raw_bytes(int r) {
    return ((TH + 2 * r) * (TW + 2 * r) + 15) & ~15;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dilate_l1_kernel(const T* __restrict__ x, T* __restrict__ out, int h, int w,
                 int r, int tiles_x, int tiles_per_mask, int vec)
{
    extern __shared__ __align__(16) uint8_t smem[];
    const int RH = TH + 2 * r, RW = TW + 2 * r;
    uint8_t* raw = smem;                       // RH x RW set flags
    uint8_t* dh = smem + raw_bytes(r);         // RH x TW row distances
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int n = blockIdx.x / tiles_per_mask;
    const int tile = blockIdx.x - n * tiles_per_mask;
    const int y0 = (tile / tiles_x) * TH, x0 = (tile % tiles_x) * TW;
    const T* xm = x + (size_t)n * h * w;
    T* om = out + (size_t)n * h * w;

    int any = 0;
    for (int ry = warp; ry < RH; ry += THREADS / 32) {
        const int gy = y0 - r + ry;
        const bool row_in = gy >= 0 && gy < h;
        for (int rx = lane; rx < RW; rx += 32) {
            const int gx = x0 - r + rx;
            uint8_t v = 0;
            if (row_in && gx >= 0 && gx < w)
                v = is_set(xm[(size_t)gy * w + gx]) ? 1 : 0;
            raw[ry * RW + rx] = v;
            any |= v;
        }
    }
    const bool empty = !__syncthreads_or(any);   // uniform over the block

    if (!empty) {
        const int cap = r + 1;
        for (int row = tid; row < RH; row += THREADS) {
            const uint8_t* rr = raw + row * RW;
            uint8_t* dd = dh + row * TW;
            int d = cap;
            for (int c = 0; c < r; ++c) d = rr[c] ? 0 : min(d + 1, cap);
            for (int c = 0; c < TW; ++c) {
                d = rr[r + c] ? 0 : min(d + 1, cap);
                dd[c] = (uint8_t)d;
            }
            d = cap;
            for (int c = RW - 1; c >= r + TW; --c) d = rr[c] ? 0 : min(d + 1, cap);
            for (int c = TW - 1; c >= 0; --c) {
                d = rr[r + c] ? 0 : min(d + 1, cap);
                dd[c] = (uint8_t)min((int)dd[c], d);
            }
        }
        __syncthreads();
    }

    const uint32_t* dw = reinterpret_cast<const uint32_t*>(dh);
    for (int item = tid; item < TH * WORDS; item += THREADS) {
        const int ty = item / WORDS, wx = item % WORDS;
        const int gy = y0 + ty, gx = x0 + wx * 4;
        if (gy >= h || gx >= w) continue;
        uint32_t acc = 0;
        if (!empty) {
            const uint32_t* col = dw + (ty + r) * WORDS + wx;
            for (int dy = -r; dy <= r; ++dy) {
                const uint32_t thr = (uint32_t)(r - abs(dy)) * 0x01010101u;
                acc |= __vcmpleu4(col[dy * WORDS], thr);
            }
        }
        T* p = om + (size_t)gy * w + gx;
        if (vec) {
            store4(p, acc);
        } else {
            for (int j = 0; j < 4 && gx + j < w; ++j)
                store1(p + j, ((acc >> (8 * j)) & 0xffu) != 0);
        }
    }
}

template <typename T>
int launch(const void* x, void* out, int N, int h, int w, int r,
           cudaStream_t stream)
{
    const int tiles_x = (w + TW - 1) / TW, tiles_y = (h + TH - 1) / TH;
    const long long blocks = (long long)N * tiles_x * tiles_y;
    if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int smem = raw_bytes(r) + (TH + 2 * r) * TW;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            dilate_l1_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem);
        if (e != cudaSuccess) return (int)e;
    }
    // four-pixel stores: rows a multiple of 4 pixels from a 16-byte base
    const int vec = (w % 4 == 0) && ((uintptr_t)out % 16 == 0);
    dilate_l1_kernel<T><<<(unsigned)blocks, THREADS, smem, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), h, w, r, tiles_x,
        tiles_x * tiles_y, vec);
    return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 uint8, 1 bfloat16, 2 float32. Returns the cudaError of the launch.
extern "C" int dilate_l1_launch(const void* x, void* out, int N, int h, int w,
                                int r, int dtype, cudaStream_t stream)
{
    if (r < 1 || r > MAX_RADIUS || N < 1 || h < 1 || w < 1)
        return (int)cudaErrorInvalidValue;
    switch (dtype) {
        case 0: return launch<uint8_t>(x, out, N, h, w, r, stream);
        case 1: return launch<uint16_t>(x, out, N, h, w, r, stream);
        case 2: return launch<float>(x, out, N, h, w, r, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}
