// Fused SLIC superpixels: Lab features, the rounds of windowed
// nearest-center assignment and center means, and the final labels, without
// the (B, HW, K) distance tensor.
//
// Replaces the Pallas TPU kernel videowalk_tpu/ops/slic_kernel.py::
// _slic_frame_kernel (via slic_fused), built from what it computes, not from
// its one-program-per-frame VMEM loop. Per frame, with features
// f = [L, a, b, y * ratio, x * ratio] and centers c (K <= 128 slots):
//   assignment  d_k = sum_j (f_j - c_kj)^2 (the direct form: the expanded
//               |f|^2 - 2 f.c + |c|^2 of the plain version cancels terms of
//               ~1e5 to a few units, so the two can differ at near-ties);
//               a center is in the window iff |f_y - c_y| <= window and
//               |f_x - c_x| <= window; label = the nearest in-window center,
//               or, where none is in the window, the nearest of all; ties go
//               to the lowest slot; slots >= n_active never win;
//   update      c_k = mean of the features of the pixels labelled k; an empty
//               cluster keeps its center.
// n_iter rounds of (assignment, update); the labels are the last round's
// assignment (its update runs only where the caller wants the centers).
// That is the round count of the plain version (ops/slic_device.py, JAX
// slic_device.slic): n_iter assignments and n_iter - 1 updates. The Pallas
// body updates after each of its n_iter assignments and assigns once more, so
// it equals this code at n_iter + 1.
//
// Bound: f32 operations. A round compares every pixel with every active
// center, ~14 operations a pair: 24 frames of 256x256 with 36 centers and 10
// rounds are ~8 GFLOP, 0.12 ms at 67 TFLOP/s, against 25 MB of input and
// output (0.008 ms). What the design keeps out of device memory is the
// distance tensor (226 MB a round at that size in the plain version).
//
// Design: simple and deterministic. A frame's features (1.3 MB) do not fit a
// block's shared memory, so each round is two launches over all frames:
//   slic_assign_kernel  one thread per pixel; the frame's centers sit in
//                       shared memory (every thread reads the same slot at the
//                       same time: a broadcast); the pixel's color comes from
//                       the Lab buffer (L2-resident across rounds), its
//                       position from its index. Labels go to a byte buffer,
//                       in the last round to the int32 output.
//   slic_update_kernel  one block per (slot, frame) scans the frame's labels
//                       and sums its members' features: each thread in pixel
//                       order, then a shuffle tree, then the warps in order.
//                       No float atomics: labels repeat bit for bit from run
//                       to run. The count comes from the same pass.
// slic_features_kernel computes Lab (or 100 * rgb) once. A call makes
// 1 + n_iter + (n_iter - 1) launches (20 at n_iter = 10).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (videowalk_tpu_torch/ops/_build.py); plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

// MAX_K mirrors MAX_SEGMENTS of ops/slic.py, which makes the check a caller sees
constexpr int THREADS = 256, MAX_K = 128;

// sRGB in [0, 1] -> CIELAB (D65), as skimage.color.rgb2lab
__device__ __forceinline__ float srgb_to_linear(float v) {
    v = fminf(fmaxf(v, 0.0f), 1.0f);
    return v > 0.04045f ? powf((v + 0.055f) / 1.055f, 2.4f) : v / 12.92f;
}

__device__ __forceinline__ float lab_f(float t) {
    return t > 0.008856f ? cbrtf(t) : 7.787f * t + 16.0f / 116.0f;
}

__global__ void __launch_bounds__(THREADS)
slic_features_kernel(const float* __restrict__ rgb, float* __restrict__ color,
                     size_t n_pix, int convert_lab)
{
    const size_t p = (size_t)blockIdx.x * THREADS + threadIdx.x;
    if (p >= n_pix) return;
    const float r = rgb[3 * p], g = rgb[3 * p + 1], b = rgb[3 * p + 2];
    float o0, o1, o2;
    if (convert_lab) {
        const float lr = srgb_to_linear(r), lg = srgb_to_linear(g),
                    lb = srgb_to_linear(b);
        const float fx = lab_f((0.412453f * lr + 0.357580f * lg + 0.180423f * lb)
                               / 0.95047f);
        const float fy = lab_f(0.212671f * lr + 0.715160f * lg + 0.072169f * lb);
        const float fz = lab_f((0.019334f * lr + 0.119193f * lg + 0.950227f * lb)
                               / 1.08883f);
        o0 = 116.0f * fy - 16.0f;
        o1 = 500.0f * (fx - fy);
        o2 = 200.0f * (fy - fz);
    } else {
        o0 = r * 100.0f; o1 = g * 100.0f; o2 = b * 100.0f;
    }
    color[3 * p] = o0; color[3 * p + 1] = o1; color[3 * p + 2] = o2;
}

__device__ __forceinline__ int active_slots(const int* n_active, int b, int K) {
    return n_active ? min(max(n_active[b], 1), K) : K;
}

template <typename L>
__global__ void __launch_bounds__(THREADS)
slic_assign_kernel(const float* __restrict__ color,
                   const float* __restrict__ centers,
                   const int* __restrict__ n_active, L* __restrict__ labels,
                   int H, int W, int K, float ratio, float window)
{
    __shared__ float sc[5][MAX_K];
    const int b = blockIdx.y, HW = H * W;
    const int kact = active_slots(n_active, b, K);
    for (int i = threadIdx.x; i < kact * 5; i += THREADS)
        sc[i % 5][i / 5] = centers[((size_t)b * K) * 5 + i];
    __syncthreads();
    const int p = blockIdx.x * THREADS + threadIdx.x;
    if (p >= HW) return;
    const int y = p / W, x = p - y * W;
    const float* f = color + ((size_t)b * HW + p) * 3;
    const float f0 = f[0], f1 = f[1], f2 = f[2];
    const float fy = (float)y * ratio, fx = (float)x * ratio;
    float best_w = CUDART_INF_F, best_a = CUDART_INF_F;
    int k_w = -1, k_a = 0;
    for (int k = 0; k < kact; ++k) {
        const float d0 = f0 - sc[0][k], d1 = f1 - sc[1][k], d2 = f2 - sc[2][k];
        const float dy = fy - sc[3][k], dx = fx - sc[4][k];
        const float d = d0 * d0 + d1 * d1 + d2 * d2 + dy * dy + dx * dx;
        const bool in_window = !(fabsf(dy) > window || fabsf(dx) > window);
        if (d < best_a) { best_a = d; k_a = k; }            // strict: lowest slot
        if (in_window && d < best_w) { best_w = d; k_w = k; }
    }
    labels[(size_t)b * HW + p] = (L)(k_w >= 0 ? k_w : k_a);
}

template <typename L>
__global__ void __launch_bounds__(THREADS)
slic_update_kernel(const float* __restrict__ color,
                   const L* __restrict__ labels,
                   const int* __restrict__ n_active, float* __restrict__ centers,
                   int H, int W, int K, float ratio)
{
    const int k = blockIdx.x, b = blockIdx.y, HW = H * W;
    if (k >= active_slots(n_active, b, K)) return;       // parked: stays put
    const L* lab = labels + (size_t)b * HW;
    const float* col = color + (size_t)b * HW * 3;
    float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};        // 5 sums and the count
    for (int p = threadIdx.x; p < HW; p += THREADS) {
        if ((int)lab[p] != k) continue;
        const int y = p / W, x = p - y * W;
        s[0] += col[3 * p]; s[1] += col[3 * p + 1]; s[2] += col[3 * p + 2];
        s[3] += (float)y * ratio; s[4] += (float)x * ratio;
        s[5] += 1.0f;
    }
    // fixed order: each thread in pixel order, a shuffle tree, warps in order
    __shared__ float part[THREADS / 32][6];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    #pragma unroll
    for (int j = 0; j < 6; ++j) {
        float v = s[j];
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == 0) part[warp][j] = v;
    }
    __syncthreads();
    if (threadIdx.x < 5) {
        float sum = 0.f, cnt = 0.f;
        for (int wi = 0; wi < THREADS / 32; ++wi) {
            sum += part[wi][threadIdx.x];
            cnt += part[wi][5];
        }
        if (cnt > 0.f)                                   // empty: keeps its center
            centers[((size_t)b * K + k) * 5 + threadIdx.x] = sum / cnt;
    }
}

template <typename L>
int assign(const float* color, const float* centers, const int* n_active,
           void* labels, int B, int H, int W, int K, float ratio, float window,
           cudaStream_t stream)
{
    dim3 grid((H * W + THREADS - 1) / THREADS, B);
    slic_assign_kernel<L><<<grid, THREADS, 0, stream>>>(
        color, centers, n_active, static_cast<L*>(labels), H, W, K, ratio,
        window);
    return (int)cudaGetLastError();
}

template <typename L>
int update(const float* color, const void* labels, const int* n_active,
           float* centers, int B, int H, int W, int K, float ratio,
           cudaStream_t stream)
{
    slic_update_kernel<L><<<dim3(K, B), THREADS, 0, stream>>>(
        color, static_cast<const L*>(labels), n_active, centers, H, W, K,
        ratio);
    return (int)cudaGetLastError();
}

}  // namespace

// rgb (n_pix, 3) f32 -> color (n_pix, 3) f32: Lab, or 100 * rgb.
extern "C" int slic_features_launch(const float* rgb, float* color,
                                    long long n_pix, int convert_lab,
                                    cudaStream_t stream)
{
    if (n_pix < 1) return (int)cudaErrorInvalidValue;
    const long long blocks = (n_pix + THREADS - 1) / THREADS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    slic_features_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
        rgb, color, (size_t)n_pix, convert_lab);
    return (int)cudaGetLastError();
}

// n_iter rounds on color (B, HW, 3) from centers (B, K, 5), updated in place;
// n_active (B) int32 or null; scratch (B, HW) bytes; labels (B, HW) int32
// get the last round's assignment. final_update: also update the centers
// after the last assignment. Returns the first cudaError of its launches.
extern "C" int slic_rounds_launch(const float* color, float* centers,
                                  const int* n_active, uint8_t* scratch,
                                  int* labels, int B, int H, int W, int K,
                                  int n_iter, int final_update, float ratio,
                                  float window, cudaStream_t stream)
{
    if (B < 1 || B > 65535 || H < 1 || W < 1 || K < 1 || K > MAX_K
            || n_iter < 1 || (long long)H * W > 0x7fffffffLL / 4)
        return (int)cudaErrorInvalidValue;
    for (int i = 0; i < n_iter; ++i) {
        const bool last = i + 1 == n_iter;
        int e = last ? assign<int>(color, centers, n_active, labels, B, H, W, K,
                                   ratio, window, stream)
                     : assign<uint8_t>(color, centers, n_active, scratch, B, H,
                                       W, K, ratio, window, stream);
        if (e) return e;
        if (!last)
            e = update<uint8_t>(color, scratch, n_active, centers, B, H, W, K,
                                ratio, stream);
        else if (final_update)
            e = update<int>(color, labels, n_active, centers, B, H, W, K, ratio,
                            stream);
        if (e) return e;
    }
    return 0;
}
