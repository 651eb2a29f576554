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
// n_iter rounds: n_iter assignments and n_iter - 1 updates between them (one
// more update where the caller wants the centers). That is the round count
// of the plain version (ops/slic_device.py, JAX slic_device.slic). The
// Pallas body updates after each of its n_iter assignments and assigns once
// more, so it equals this code at n_iter + 1.
//
// Bound: f32 operations. SLIC compares each pixel with the centers in its
// 2S window only (all active centers where none is): ~11.3 of 36 at the
// superpixel step of record (24 frames of 256x256, S = 42.7 px), ~14
// operations a pair, and ~6 a pixel a center update: ~2.6 GFLOP for 10
// rounds, 0.039 ms at 67 TFLOP/s, against 25 MB of input and output (0.008
// ms). chip_smoke.py counts the pairs of each round from the centers the
// plain version holds there.
//
// Design: one launch a round over (32x64-pixel tiles, frames), 256 threads,
// each thread one column of 8 rows of a tile, each warp 8 rows:
//   slic_features_kernel  Lab (or 100 * rgb) once, planar (B, 3, HW), so a
//                       warp reads 32 neighbouring pixels of a row; it also
//                       zeroes the first sum buffer.
//   slic_round_kernel   The thread's pixels are loaded first, so their
//                       latency overlaps the centers'.
//                       (1) This round's centers, in every block by the same
//                       arithmetic (so every block holds the same bits):
//                       round 0 the given centers or the grid's, gathered
//                       here from the features (the grid's positions in f64,
//                       then f32, then x ratio in f32, as initial_centers);
//                       round i > 0 the means of round i - 1's sums, or the
//                       previous center where a cluster came up empty. Block
//                       0 of a frame writes them for the next round and
//                       zeroes the sum buffer the next round fills.
//                       (2) Window cull: the active slots whose window can
//                       reach some pixel of the tile, in ascending order, by
//                       a test on the tile's edges that is conservative by a
//                       margin far above f32 rounding (~16 of 36 a tile at
//                       the step of record); a warp skips, uniformly, those
//                       whose window misses its own 8 rows (~13 left). The
//                       per-pixel window test stays exact, so the nearest
//                       in-window center over what is left is the nearest
//                       in-window center over all slots; a pixel with none
//                       scans every active slot for the unwindowed nearest.
//                       Each center is read once a thread (two float4
//                       broadcasts from shared memory) and compared with the
//                       thread's 8 pixels, which share their x distance. f32
//                       on the CUDA cores: no TF32, as near-ties decide
//                       labels.
//                       (3) Sums without scans: a warp takes its labels in
//                       ascending order (__reduce_min_sync), each lane sums
//                       its pixels of that label, a fixed shuffle tree sums
//                       the lanes, lane 0 stores the warp's partial; the
//                       block adds its 8 warps in order, turns each touched
//                       slot's sums into int64 fixed point (2^-20) and adds
//                       them to the frame's sums with 64-bit integer
//                       atomics. Integer sums are exact, so the order of the
//                       blocks does not matter: labels and centers repeat bit
//                       for bit. Three sum buffers rotate, so no round zeroes
//                       one that the same launch reads. The last round writes
//                       the int32 labels (no earlier round needs a label
//                       plane) and sums only where the centers are wanted.
//   slic_finalize_kernel  the centers after the last round's update (with
//                       return_centers).
// A call makes 1 + n_iter device launches (+1 with return_centers), and no
// copy from the host: the wrapper (ops/slic.py) allocates every buffer.
// Fixed-point range: |feature| <= 4096 (the Lab or 100 * rgb of colors in
// [0, 1] with a wide margin) and positions up to max(H, W) * ratio; the
// wrapper refuses shapes whose frame sums could pass 2^62.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (videowalk_tpu_torch/ops/_build.py); plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

// MAX_K mirrors MAX_SEGMENTS of ops/slic.py, which makes the check a caller sees
constexpr int THREADS = 256, WARPS = THREADS / 32, MAX_K = 128;
constexpr int ROWS = 8;                         // a thread: 8 rows of a column
constexpr int TILE_W = 32, TILE_H = WARPS * ROWS;
constexpr int NS = 6;                           // 5 feature sums and the count
constexpr unsigned FULL = 0xffffffffu, NONE = 0xffffffffu;
constexpr float FIX = 1048576.0f;               // 2^20
constexpr double UNFIX = 1.0 / 1048576.0;

// sRGB in [0, 1] -> CIELAB (D65), as skimage.color.rgb2lab
__device__ __forceinline__ float srgb_to_linear(float v) {
    v = fminf(fmaxf(v, 0.0f), 1.0f);
    return v > 0.04045f ? powf((v + 0.055f) / 1.055f, 2.4f) : v / 12.92f;
}

__device__ __forceinline__ float lab_f(float t) {
    return t > 0.008856f ? cbrtf(t) : 7.787f * t + 16.0f / 116.0f;
}

// rgb (B, HW, 3) -> color (B, 3, HW); zeroes ring0[0, n_zero)
__global__ void __launch_bounds__(THREADS)
slic_features_kernel(const float* __restrict__ rgb, float* __restrict__ color,
                     long long* __restrict__ ring0, long long n_pix, int HW,
                     int n_zero, int convert_lab)
{
    const long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (p < n_zero) ring0[p] = 0;
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
    const long long f = p / HW, q = p - f * HW;
    float* c = color + f * 3 * HW + q;
    c[0] = o0; c[HW] = o1; c[2 * HW] = o2;
}

__device__ __forceinline__ int active_slots(const int* n_active, int b, int K) {
    return n_active ? min(max(n_active[b], 1), K) : K;
}

// c (5 floats, the previous center) <- the mean of s, where its count > 0
__device__ __forceinline__ void mean_of_sums(const long long* __restrict__ s,
                                             float* c) {
    const long long n = s[5];
    if (n > 0) {
        #pragma unroll
        for (int j = 0; j < 5; ++j)
            c[j] = (float)((double)s[j] * UNFIX / (double)n);
    }
}

// One round. cprev == nullptr: round 0, from init (B, K, 5) or, where init is
// null, the grid. Else from cprev (B, K, 5) and sums_prev (B, K, 6).
// cout: this round's centers, written by block 0 of each frame, which also
// zeroes sums_zero (the buffer the next round fills). sums_out: this round's
// sums, or null. labels: int32 (B, HW) of the last round, or null.
__global__ void __launch_bounds__(THREADS)
slic_round_kernel(const float* __restrict__ color,
                  const float* __restrict__ init,
                  const float* __restrict__ cprev,
                  const long long* __restrict__ sums_prev,
                  float* __restrict__ cout, long long* __restrict__ sums_out,
                  long long* __restrict__ sums_zero,
                  const int* __restrict__ n_active, int* __restrict__ labels,
                  int H, int W, int K, int tiles_x, float ratio, float window,
                  int gh, int gw)
{
    __shared__ float4 sc[MAX_K][2];            // (L, a, b, y), (x, 0, 0, 0)
    __shared__ float wsum[WARPS * MAX_K * NS];  // each warp's partial sums
    __shared__ int list[MAX_K];
    __shared__ unsigned wmask[MAX_K / 32];

    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int b = blockIdx.y, HW = H * W;
    const int kact = active_slots(n_active, b, K);
    const float* col = color + (size_t)b * 3 * HW;
    const bool writer = blockIdx.x == 0;
    const int ty = blockIdx.x / tiles_x, tx = blockIdx.x - ty * tiles_x;
    const int y0 = ty * TILE_H, x0 = tx * TILE_W, yw = y0 + warp * ROWS;

    // the thread's pixels first: their loads overlap the centers' below
    const int x = x0 + lane;
    const float fx = __fmul_rn((float)x, ratio);
    float f0[ROWS], f1[ROWS], f2[ROWS], fy[ROWS];
    unsigned valid = 0;
    #pragma unroll
    for (int j = 0; j < ROWS; ++j) {
        const int y = yw + j;
        const bool v = x < W && y < H;
        const int p = v ? y * W + x : 0;
        f0[j] = v ? col[p] : 0.f;
        f1[j] = v ? col[HW + p] : 0.f;
        f2[j] = v ? col[2 * HW + p] : 0.f;
        fy[j] = __fmul_rn((float)y, ratio);
        valid |= (unsigned)v << j;
    }

    // (1) this round's centers
    if (t < K) {
        const size_t row = (size_t)b * K + t;
        float c[5];
        if (cprev == nullptr) {
            if (init != nullptr) {
                #pragma unroll
                for (int j = 0; j < 5; ++j) c[j] = init[row * 5 + j];
            } else {               // _grid_centers: f64, then f32; x ratio in f32
                const int m = t % (gh * gw), iy = m / gw, ix = m - iy * gw;
                const float cy = (float)(((double)iy + 0.5) * (double)H / (double)gh);
                const float cx = (float)(((double)ix + 0.5) * (double)W / (double)gw);
                const int pi = min(max((int)cy, 0), H - 1) * W
                               + min(max((int)cx, 0), W - 1);
                c[0] = col[pi]; c[1] = col[HW + pi]; c[2] = col[2 * HW + pi];
                c[3] = __fmul_rn(cy, ratio); c[4] = __fmul_rn(cx, ratio);
            }
        } else {
            #pragma unroll
            for (int j = 0; j < 5; ++j) c[j] = cprev[row * 5 + j];
            if (t < kact) mean_of_sums(sums_prev + row * NS, c);
        }
        sc[t][0] = make_float4(c[0], c[1], c[2], c[3]);
        sc[t][1] = make_float4(c[4], 0.f, 0.f, 0.f);
        if (writer) {
            #pragma unroll
            for (int j = 0; j < 5; ++j) cout[row * 5 + j] = c[j];
        }
    }
    if (writer && sums_zero != nullptr)
        for (int i = t; i < K * NS; i += THREADS)
            sums_zero[(size_t)b * K * NS + i] = 0;
    if (sums_out != nullptr)
        for (int i = t; i < WARPS * K * NS; i += THREADS) wsum[i] = 0.f;
    __syncthreads();

    // (2) the slots whose window can reach the tile, ascending; a warp
    // skips those whose window misses its own rows
    const float reach = window + 1e-4f * (1.0f + window
        + __fmul_rn((float)(H - 1), ratio) + __fmul_rn((float)(W - 1), ratio));
    const float ylo = __fmul_rn((float)y0, ratio) - reach,
                yhi = __fmul_rn((float)(min(y0 + TILE_H, H) - 1), ratio) + reach,
                xlo = __fmul_rn((float)x0, ratio) - reach,
                xhi = __fmul_rn((float)(min(x0 + TILE_W, W) - 1), ratio) + reach;
    const float wlo = __fmul_rn((float)yw, ratio) - reach,
                whi = __fmul_rn((float)(yw + ROWS - 1), ratio) + reach;
    bool listed = false;
    if (warp < MAX_K / 32) {
        if (t < kact) {
            const float cy = sc[t][0].w, cx = sc[t][1].x;
            listed = cy >= ylo && cy <= yhi && cx >= xlo && cx <= xhi;
        }
        const unsigned m = __ballot_sync(FULL, listed);
        if (lane == 0) wmask[warp] = m;
    }
    __syncthreads();
    int n_list = 0, pos = 0;
    #pragma unroll
    for (int w = 0; w < MAX_K / 32; ++w) {
        const int n = __popc(wmask[w]);
        if (w < warp) pos += n;
        n_list += n;
    }
    if (listed) list[pos + __popc(wmask[warp] & ((1u << lane) - 1u))] = t;
    __syncthreads();

    // (3) assignment of the thread's pixels
    float best[ROWS];
    int lab[ROWS];
    #pragma unroll
    for (int j = 0; j < ROWS; ++j) { best[j] = CUDART_INF_F; lab[j] = -1; }
    for (int li = 0; li < n_list; ++li) {
        const int k = list[li];
        const float4 c = sc[k][0];
        if (c.w < wlo || c.w > whi) continue;   // misses the warp's rows
        const float dx = fx - sc[k][1].x;
        const bool x_in = !(fabsf(dx) > window);
        #pragma unroll
        for (int j = 0; j < ROWS; ++j) {
            const float d0 = f0[j] - c.x, d1 = f1[j] - c.y, d2 = f2[j] - c.z;
            const float dy = fy[j] - c.w;
            const float d = d0 * d0 + d1 * d1 + d2 * d2 + dy * dy + dx * dx;
            if (x_in && !(fabsf(dy) > window) && d < best[j]) {  // strict: lowest slot
                best[j] = d;
                lab[j] = k;
            }
        }
    }
    #pragma unroll
    for (int j = 0; j < ROWS; ++j) {
        if (!((valid >> j) & 1u) || lab[j] >= 0) continue;
        float bd = CUDART_INF_F;                 // none in the window: all slots
        int bk = 0;
        for (int k = 0; k < kact; ++k) {
            const float4 c = sc[k][0];
            const float d0 = f0[j] - c.x, d1 = f1[j] - c.y, d2 = f2[j] - c.z;
            const float dy = fy[j] - c.w, dx = fx - sc[k][1].x;
            const float d = d0 * d0 + d1 * d1 + d2 * d2 + dy * dy + dx * dx;
            if (d < bd) { bd = d; bk = k; }
        }
        lab[j] = bk;
    }
    if (labels != nullptr) {
        #pragma unroll
        for (int j = 0; j < ROWS; ++j)
            if ((valid >> j) & 1u)
                labels[(size_t)b * HW + (size_t)(yw + j) * W + x] = lab[j];
    }
    if (sums_out == nullptr) return;            // uniform over the block

    // (4) sums: a warp's labels in ascending order, a fixed shuffle tree each
    unsigned pend[ROWS];
    #pragma unroll
    for (int j = 0; j < ROWS; ++j)
        pend[j] = ((valid >> j) & 1u) ? (unsigned)lab[j] : NONE;
    while (true) {
        unsigned mine = pend[0];
        #pragma unroll
        for (int j = 1; j < ROWS; ++j) mine = min(mine, pend[j]);
        const unsigned k = __reduce_min_sync(FULL, mine);
        if (k == NONE) break;
        float s[NS] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        #pragma unroll
        for (int j = 0; j < ROWS; ++j) {
            if (pend[j] != k) continue;
            s[0] += f0[j]; s[1] += f1[j]; s[2] += f2[j];
            s[3] += fy[j]; s[4] += fx; s[5] += 1.0f;
            pend[j] = NONE;
        }
        #pragma unroll
        for (int i = 0; i < NS; ++i)
            #pragma unroll
            for (int o = 16; o > 0; o >>= 1)
                s[i] += __shfl_xor_sync(FULL, s[i], o);
        if (lane == 0) {
            #pragma unroll
            for (int i = 0; i < NS; ++i) wsum[(warp * K + k) * NS + i] = s[i];
        }
    }
    __syncthreads();
    // the block's warps in order, then int64 fixed point into the frame's sums
    for (int i = t; i < kact * NS; i += THREADS) {
        const int k = i / NS, j = i - k * NS;
        float sum = 0.f, n = 0.f;
        #pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            sum += wsum[(w * K + k) * NS + j];
            n += wsum[(w * K + k) * NS + 5];
        }
        if (n > 0.f) {
            const long long q = j == 5 ? (long long)n : __float2ll_rn(sum * FIX);
            atomicAdd(reinterpret_cast<unsigned long long*>(
                          sums_out + ((size_t)b * K + k) * NS + j),
                      (unsigned long long)q);
        }
    }
}

// centers (B, K, 5) after the last round's update; one block a frame
__global__ void __launch_bounds__(MAX_K)
slic_finalize_kernel(const float* __restrict__ cprev,
                     const long long* __restrict__ sums,
                     const int* __restrict__ n_active,
                     float* __restrict__ centers, int K)
{
    const int b = blockIdx.x, k = threadIdx.x;
    if (k >= K) return;
    const size_t row = (size_t)b * K + k;
    float c[5];
    #pragma unroll
    for (int j = 0; j < 5; ++j) c[j] = cprev[row * 5 + j];
    if (k < active_slots(n_active, b, K)) mean_of_sums(sums + row * NS, c);
    #pragma unroll
    for (int j = 0; j < 5; ++j) centers[row * 5 + j] = c[j];
}

}  // namespace

// The whole segmentation of rgb (B, HW, 3) f32 in [0, 1]. Buffers, all from
// the caller: color (B, 3, HW) f32; cbuf (2, B, K, 5) f32; ring (3, B, K, 6)
// int64; labels (B, HW) int32 (the last round's assignment); centers
// (B, K, 5) f32 or null (then no update after the last assignment). init
// (B, K, 5) f32 or null (the grid's centers, (gh, gw) cells); n_active (B)
// int32 or null. Returns the first cudaError of its launches.
extern "C" int slic_launch(const float* rgb, float* color, const float* init,
                           const int* n_active, float* cbuf, long long* ring,
                           int* labels, float* centers, int B, int H, int W,
                           int K, int n_iter, int convert_lab, float ratio,
                           float window, int gh, int gw, cudaStream_t stream)
{
    const long long HW = (long long)H * W;
    if (B < 1 || B > 65535 || H < 1 || W < 1 || K < 1 || K > MAX_K
            || n_iter < 1 || gh < 1 || gw < 1 || HW > 0x7fffffffLL / 4)
        return (int)cudaErrorInvalidValue;
    const long long n_pix = B * HW, per = (long long)B * K * NS;
    const long long blocks = ((n_pix > per ? n_pix : per) + THREADS - 1) / THREADS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    slic_features_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
        rgb, color, ring, n_pix, (int)HW, (int)per, convert_lab);
    int e = (int)cudaGetLastError();
    if (e) return e;
    const int tiles_x = (W + TILE_W - 1) / TILE_W,
              tiles_y = (H + TILE_H - 1) / TILE_H;
    const size_t cs = (size_t)B * K * 5;
    for (int i = 0; i < n_iter; ++i) {
        const bool last = i + 1 == n_iter;
        slic_round_kernel<<<dim3(tiles_x * tiles_y, B), THREADS, 0, stream>>>(
            color, init, i ? cbuf + ((i - 1) & 1) * cs : nullptr,
            i ? ring + ((i - 1) % 3) * per : nullptr, cbuf + (i & 1) * cs,
            (!last || centers) ? ring + (i % 3) * per : nullptr,
            last ? nullptr : ring + ((i + 1) % 3) * per, n_active,
            last ? labels : nullptr, H, W, K, tiles_x, ratio, window, gh, gw);
        if ((e = (int)cudaGetLastError())) return e;
    }
    if (centers) {
        slic_finalize_kernel<<<B, MAX_K, 0, stream>>>(
            cbuf + ((n_iter - 1) & 1) * cs, ring + ((n_iter - 1) % 3) * per,
            n_active, centers, K);
        e = (int)cudaGetLastError();
    }
    return e;
}
