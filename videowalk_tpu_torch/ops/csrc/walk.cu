// Fused palindrome-walk loss: forward and backward, each spread over the
// card in four phase kernels (walk_affinity, walk_zsm, walk_chain<fwd>,
// walk_cycle_fwd; walk_cycle_bwd, walk_chain<bwd>, walk_step_bwd, walk_dq).
//
// Replaces the Pallas TPU kernels videowalk_tpu/ops/walk_kernel.py::
// _walk_fwd_kernel (via _fwd_call) and ::_walk_bwd_kernel (via _bwd_call),
// built from what they compute, not from their (8, 128) layout. Per batch
// element, S = T - 1 steps:
//   forward   A_s = q_s q_{s+1}^T; D12_s = (m12_s ? -1e20 : A_s) / T,
//             D21_s = (m21_s ? -1e20 : A_s^T) / T; P = zsm(D12), Q = zsm(D21)
//             with zsm(x) = expm1(x)^2 / (row sum + 1e-5); F_0 = P_0,
//             F_i = F_{i-1} P_i; B_0 = Q_0, B_i = Q_i B_{i-1}; AA_i = F_i B_i;
//             per cycle i = 1..S-1: loss = mean_rows[log(rowsum + N 1e-20) -
//             log(diag + 1e-20)], acc = mean_rows[diag >= rowmax].
//   backward  dAA_i from AA_i; X_i = dAA_i B_i^T, Y_i = F_i^T dAA_i; the
//             reverse recursions dF <- (dF + X_i) P_i^T and
//             dB <- Q_i^T (dB + Y_i), storing dF_i = dF + X_i, dB_i (and
//             dF_0, dB_0); dP_i = F_{i-1}^T dF_i, dQ_i = dB_i B_{i-1}^T
//             (dP_0 = dF_0, dQ_0 = dB_0); the zsm VJP of each row over T;
//             dq_t = dA_t q_{t+1} + dA_{t-1}^T q_{t-1}, dA = dD12 + dD21^T.
// No padding of N; losses/accs come out as (B, S-1) f32; the masks are drawn
// outside (uint8, nonzero = dropped). The forward also writes P and Q, which
// the backward's recursions read (the residuals are D12, D21, F, B, P, Q).
//
// Bound. At the flagship shape (B=8, T=8, N=49, C=128) the function's
// forward reads q and the masks and writes the four (B,S,N,N) f32 residuals
// it needs (D12, D21, F, B), ~4.0 MB for 68 MFLOP of f32; the backward reads
// q and those residuals and writes dq, ~5.4 MB for 148 MFLOP. At 3.35 TB/s
// and 67 TFLOP/s that is 1.2-1.6 us (bytes) and 1.0-2.2 us (operations):
// far below a launch's latency. P and Q are this design's own extra bytes
// (two more residual sets, 1.08 MB a call each way at that shape). What
// decides the time is how much of the card works at once and how long the
// dependent chain is, not bytes or arithmetic.
//
// Design. Only the prefix recursions are serial, and they split: row r of
// F_i (and of dF) needs row r of F_{i-1} and all of P_i; column m of B_i (and
// of dB) needs column m of B_{i-1} and all of Q_i. Everything else is
// independent across steps and cycles. So each call runs four grids of many
// blocks per batch element, one launch each (no grid-wide barrier):
//   walk_affinity  (B, S, 32x32 tiles of A_s), 64 threads of 4x4 outputs;
//                  q read by rows in 64-channel chunks, the next chunk held
//                  in registers while this one is multiplied from shared
//                  memory; writes D12, D21.
//   walk_zsm       one warp per row of D12 or D21 -> P, Q (and F_0, B_0).
//   walk_chain     (B, F or B side, blocks of 8 rows or columns): each
//                  step's product split over the warps by k, the partial
//                  sums added in warp order; the next step's matrix in
//                  flight into registers while this one is multiplied from
//                  one of two shared slots.
//   walk_cycle_fwd (B, cycle): AA_i rows by warps from F_i, B_i in shared
//                  memory, the row losses, their means in row order.
//   walk_cycle_bwd (B, cycle): AA_i, dAA_i (kept in shared memory), X_i, Y_i.
//   walk_step_bwd  (B, step, P or Q side): dP_i or dQ_i a row at a time in
//                  registers, the zsm VJP; writes dD12_i or dD21_i and its
//                  transpose, so that walk_dq reads every term by rows.
//   walk_dq        (B, frame, 32 rows x 64 channels): both dA terms staged
//                  in shared memory, one FMA chain per element.
// Every product is f32 FMAs, one chain per output element in a fixed k
// order (in the recursions one chain per k-eighth, the eighths added in
// warp order) (no TF32: at T 0.05 the logits reach +-20, so a 1e-3 error in A
// moves a ZeroSoftmax weight by ~4%, and one flipped diag >= rowmax moves an
// accuracy by 1/N). No atomics: two runs are bitwise equal. The only
// padding is with zeros inside shared tiles of product operands (q's
// channels and rows in the affinity tile; dA's columns and q's rows in
// walk_dq up to a multiple of 4), which adds exact zeros to a sum, and of
// clamped lanes whose results are not stored; no logit is padded. Shared
// N x N tiles keep an odd row stride (N | 1), so a warp reads a row or a
// column of one without bank conflicts. The wrapper allocates every
// buffer; the kernels allocate nothing.
//
// Measured on an H100 (chip_smoke.py's walk phase, PERF.md §6): at the
// flagship shape ~34 us (forward) and ~52 us (backward) of device time a
// call, 2-17 us a phase; the recursions at most ~2 us a step.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (videowalk_tpu_torch/ops/_build.py); plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 256;              // threads per block (but walk_affinity)
constexpr int NW = NT / 32;          // warps per block
constexpr int MAXN = 128;            // widest node count (4 columns a lane)
constexpr int TILE = 32;             // affinity tile; dq rows per block
constexpr int AT = 64;               // walk_affinity threads (4 x 4 outputs)
constexpr int KC = 64;               // q channels per staged chunk
constexpr int GR = 4;                // rows a warp carries (cycles, steps, dq)
constexpr int DQ_TC = 64;            // dq channels per block (2 a lane)
constexpr int SMEM_OPTIN = 232448;   // shared memory one Hopper block may use
constexpr float EPS = 1e-20f;        // reference code/model.py:12
constexpr float ZSM_EPS = 1e-5f;     // ZeroSoftmax eps
constexpr float NEG = -1e20f;        // edge-dropout fill
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline int ld_of(int N) { return N | 1; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// rows x cols (cols <= 128) floats of src (row stride sld) into shared rows
// of stride dld: warps over rows, lanes over columns, two rows of a warp
// (8 loads a lane) in flight at once. The caller synchronizes.
__device__ __forceinline__ void copy_rows(float* dst, int dld, const float* src,
                                          int sld, int rows, int cols) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < rows; r += 2 * nw) {
    float v[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rr = r + h * nw, c = lane + 32 * j;
        v[h][j] = rr < rows && c < cols ? src[(size_t)rr * sld + c] : 0.f;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rr = r + h * nw, c = lane + 32 * j;
        if (rr < rows && c < cols) dst[rr * dld + c] = v[h][j];
      }
  }
}

// One warp's products: acc[g][j] += sum_k a[g][k * ak] * b[k * bk + bc[j]]
// for k = 0..K-1 in order (one FMA chain per output). a[g] points at the
// warp's g-th row operand (read by all lanes: a broadcast), bc[j] at lane
// column lane + 32 j of b.
template <int G, int J>
__device__ __forceinline__ void warp_mm(const float* const (&a)[G], int ak,
                                        const float* b, int bk,
                                        const int (&bc)[J], int K,
                                        float (&acc)[G][J]) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[G], bv[J];
#pragma unroll
    for (int g = 0; g < G; ++g) av[g] = a[g][k * ak];
#pragma unroll
    for (int j = 0; j < J; ++j) bv[j] = b[k * bk + bc[j]];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < J; ++j) acc[g][j] = fmaf(av[g], bv[j], acc[g][j]);
  }
}

// lane column offsets lane + 32 j (clamped to N - 1; not stored there),
// times the column stride cs of the operand
template <int J>
__device__ __forceinline__ void lane_cols(int N, int cs, int (&bc)[J]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < J; ++j) bc[j] = min(lane + 32 * j, N - 1) * cs;
}

template <int G, int J>
__device__ __forceinline__ void zero(float (&acc)[G][J]) {
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < J; ++j) acc[g][j] = 0.f;
}

// ---------------------------------------------------------------- forward

// D12, D21 of one 32 x 32 tile of A_s = q_s q_{s+1}^T; grid (tiles^2, S, B).
// Each chunk of 64 channels is read by rows (a warp instruction reads 64
// bytes of each of 8 rows; VEC: as float4, where C % 4 == 0 and q is
// 16-byte aligned), held in registers while the previous chunk is
// multiplied, then stored channel-major (rows padded to 36 floats: 2-way
// store conflicts, 16-byte reads).
template <bool VEC>
__global__ void __launch_bounds__(AT)
walk_affinity_kernel(const float* q, const uint8_t* m12, const uint8_t* m21,
                     float* d12, float* d21, int T, int N, int C, float temp) {
  constexpr int TP = TILE + 4;
  __shared__ __align__(16) float qa[KC][TP];   // q_s rows, channel-major
  __shared__ __align__(16) float qb[KC][TP];   // q_{s+1} rows
  constexpr int PER = TILE * KC / 4 / AT;      // float4 per thread per operand
  static_assert(TILE == 32 && KC == 64 && AT == 64, "the loader's mapping");
  const int tiles = (N + TILE - 1) / TILE;
  const int n0 = (blockIdx.x / tiles) * TILE, m0 = (blockIdx.x % tiles) * TILE;
  const int s = blockIdx.y, b = blockIdx.z, S = T - 1;
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const float* qs = q + ((size_t)b * T + s) * N * C;
  const float* qt = qs + (size_t)N * C;
  float4 ra[PER], rb[PER];
  // element k of this thread: warp instruction u = warp + 2 k covers rows
  // 8 (u % 4) .. + 7 and float4 columns 4 (u / 4) .. + 3 of the chunk
  auto row_of = [&](int k) { return 8 * (((tid >> 5) + 2 * k) % 4) + (tid & 31) / 4; };
  auto col_of = [&](int k) { return 4 * (4 * (((tid >> 5) + 2 * k) / 4) + (tid & 3)); };
  // channels and rows past the ends read as exact zeros
  auto get = [&](const float* src, int r0, int c0, int k) {
    const int r = r0 + row_of(k), c = c0 + col_of(k);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < N) {
      const float* x = src + (size_t)r * C + c;
      if (VEC) {
        if (c < C) v = *reinterpret_cast<const float4*>(x);
      } else {
        v.x = c < C ? x[0] : 0.f;
        v.y = c + 1 < C ? x[1] : 0.f;
        v.z = c + 2 < C ? x[2] : 0.f;
        v.w = c + 3 < C ? x[3] : 0.f;
      }
    }
    return v;
  };
  auto load = [&](int c0) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      ra[k] = get(qs, n0, c0, k);
      rb[k] = get(qt, m0, c0, k);
    }
  };
  auto put = [&](float (*dst)[TP], const float4& v, int k) {
    const int r = row_of(k), c = col_of(k);
    dst[c][r] = v.x;
    dst[c + 1][r] = v.y;
    dst[c + 2][r] = v.z;
    dst[c + 3][r] = v.w;
  };
  float acc[4][4];
  zero(acc);
  load(0);
  for (int c0 = 0; c0 < C; c0 += KC) {
    __syncthreads();                           // the previous chunk is consumed
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      put(qa, ra[k], k);
      put(qb, rb[k], k);
    }
    __syncthreads();
    if (c0 + KC < C) load(c0 + KC);            // the next chunk in flight
#pragma unroll 8
    for (int c = 0; c < KC; ++c) {
      const float4 a4 = *reinterpret_cast<const float4*>(&qa[c][4 * ty]);
      const float4 b4 = *reinterpret_cast<const float4*>(&qb[c][4 * tx]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  const size_t mo = ((size_t)b * S + s) * N * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + 4 * tx + j;
      if (n < N && m < N) {
        const size_t o12 = mo + (size_t)n * N + m, o21 = mo + (size_t)m * N + n;
        d12[o12] = (m12[o12] ? NEG : acc[i][j]) / temp;
        d21[o21] = (m21[o21] ? NEG : acc[i][j]) / temp;
      }
    }
  }
}

// P = zsm(D12), Q = zsm(D21), one warp per row; F_0 = P_0, B_0 = Q_0.
// grid (ceil(2 S N / NW), B)
template <int J>
__global__ void __launch_bounds__(NT)
walk_zsm_kernel(const float* d12, const float* d21, float* p, float* qz,
                float* f, float* bk, int S, int N) {
  const int lane = threadIdx.x & 31, b = blockIdx.y;
  // no early exit: the warp sums below need every lane of the warp
  const int row0 = blockIdx.x * NW + (threadIdx.x >> 5);
  const bool live = row0 < 2 * S * N;
  const int row = live ? row0 : 0;
  const int side = row / (S * N), sr = row - side * S * N;   // s N + r
  const size_t o = ((size_t)b * S * N + sr) * N;
  const float* x = (side ? d21 : d12) + o;
  float u[J];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int m = lane + 32 * j;
    u[j] = 0.f;
    if (m < N) {
      const float e = expm1f(x[m]);
      u[j] = e * e;
      s += u[j];
    }
  }
  s = warp_sum(s) + ZSM_EPS;
  float* y = (side ? qz : p) + o;
  float* y0 = sr < N ? (side ? bk : f) + o : nullptr;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int m = lane + 32 * j;
    if (live && m < N) {
      y[m] = u[j] / s;
      if (y0) y0[m] = u[j] / s;
    }
  }
}

// The recursions, split: side 0 carries rows of F (forward) or dF
// (backward), side 1 columns of B or dB; a block carries 8 of them.
// grid (ceil(N / 8), 2, B).
//   forward   v <- v P_i (side 0), v <- Q_i v (side 1), i = 1..S-1; stores
//             F_i, B_i (F_0, B_0 come from walk_zsm).
//   backward  v <- v + X_i (Y_i), stored as dF_i (dB_i), then v <- v P_i^T
//             (side 0), v <- Q_i^T v (side 1), i = S-1..1; stores dF_0, dB_0.
// A step's product is split over the warps by k: warp w multiplies the 8
// vectors' k-slice w (read from shared memory as 16-byte broadcasts) by
// those rows of the step matrix, so the matrix is read once a block; the 8
// partial sums of each output are then added in warp order by the thread
// that owns the output (warp v % 8, lane e % 32). Two shared slots take
// turns: while a step multiplies from one, the next step's matrix (and,
// backward, the owned X_i / Y_i entries) is in flight into registers, read
// by whole rows, then stored into the other.
template <int J, bool BWD>
__global__ void __launch_bounds__(NT)
walk_chain_kernel(const float* p, const float* qz, const float* add0,
                  const float* add1, float* out0, float* out1, int S, int N) {
  extern __shared__ __align__(16) float smem_chain[];
  constexpr int R = NW;                        // vectors a block
  constexpr int RH = 4 * J;                    // matrix rows a warp moves
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int side = blockIdx.y, b = blockIdx.z, ld = ld_of(N), NN = N * N;
  const int ns = S - 1;
  float* vt = smem_chain;                      // the vectors, k-major: N x R
  float* part = vt + N * R;                    // partial sums: NW x R x N
  float* slot[2] = {part + NW * R * N, part + NW * R * N + N * ld};
  const size_t mo = (size_t)b * S * NN;
  const float* mats = (side ? qz : p) + mo;
  const float* adds = BWD ? (side ? add1 : add0) + mo : nullptr;
  float* out = (side ? out1 : out0) + mo;
  // element e of vector v: v N + e (a row) or e N + v (a column); this
  // thread owns element lane + 32 j of vector blockIdx.x * R + warp
  const int vs = side ? 1 : N, es = side ? N : 1;
  const bool ok = blockIdx.x * R + warp < N;
  const int vid = min(blockIdx.x * R + warp, N - 1);
  // v M (forward side 0, backward side 1) reads M[k][e]; v M^T and M v read
  // M[e][k]
  const bool tr = side != (int)BWD;
  int bc[J];
  lane_cols(N, tr ? ld : 1, bc);
  const int bk = tr ? 1 : ld;
  const int k0 = warp * N / NW, k1 = (warp + 1) * N / NW;   // this warp's k

  auto mat_of = [&](int t) { return (size_t)(BWD ? S - 1 - t : t + 1); };
  auto at = [&](int j) { return (size_t)vid * vs + (size_t)(lane + 32 * j) * es; };
  float pre[RH][J], nxt[J];
  auto fetch = [&](int t) {                    // step t's operands in flight
    const float* src = mats + mat_of(t) * NN;
#pragma unroll
    for (int h = 0; h < RH; ++h)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int r = warp + NW * h, c = lane + 32 * j;
        pre[h][j] = r < N && c < N ? src[r * N + c] : 0.f;
      }
    if (BWD) {
#pragma unroll
      for (int j = 0; j < J; ++j)
        nxt[j] = lane + 32 * j < N ? adds[mat_of(t) * NN + at(j)] : 0.f;
    }
  };
  auto put = [&](float* dst) {
#pragma unroll
    for (int h = 0; h < RH; ++h)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int r = warp + NW * h, c = lane + 32 * j;
        if (r < N && c < N) dst[r * ld + c] = pre[h][j];
      }
  };

  float cur[J];
#pragma unroll
  for (int j = 0; j < J; ++j)
    cur[j] = !BWD && lane + 32 * j < N ? mats[at(j)] : 0.f;
  fetch(0);
  put(slot[0]);
  for (int t = 0; t < ns; ++t) {
    const size_t i = mat_of(t);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int e = lane + 32 * j;
      if (e < N) {
        if (BWD) {
          cur[j] += nxt[j];
          if (ok) out[i * NN + at(j)] = cur[j];
        }
        vt[e * R + warp] = cur[j];
      }
    }
    __syncthreads();                           // vt and this step's slot
    if (t + 1 < ns) fetch(t + 1);
    const float* M = slot[t & 1];
    float acc[R][J];
    zero(acc);
    for (int k = k0; k < k1; ++k) {
      const float4 va = *reinterpret_cast<const float4*>(vt + k * R);
      const float4 vb = *reinterpret_cast<const float4*>(vt + k * R + 4);
      const float v[R] = {va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w};
      float m[J];
#pragma unroll
      for (int j = 0; j < J; ++j) m[j] = M[k * bk + bc[j]];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < J; ++j) acc[r][j] = fmaf(v[r], m[j], acc[r][j]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int e = lane + 32 * j;
        if (e < N) part[(warp * R + r) * N + e] = acc[r][j];
      }
    __syncthreads();                           // every partial sum is in
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int e = lane + 32 * j;
      if (e < N) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) sum += part[(w * R + warp) * N + e];
        cur[j] = sum;
        if (!BWD && ok) out[i * NN + at(j)] = sum;
      }
    }
    if (t + 1 < ns) put(slot[(t + 1) & 1]);
  }
  if (BWD) {
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (ok && lane + 32 * j < N) out[at(j)] = cur[j];
  }
}

// One cycle's loss and accuracy: AA_i = F_i B_i by rows; grid (S - 1, B)
template <int J>
__global__ void __launch_bounds__(NT)
walk_cycle_fwd_kernel(const float* f, const float* bk, float* losses,
                      float* accs, int S, int N) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // every warp takes the same number of row groups (the warp sums need
  // whole warps); rows past N are computed clamped and not stored
  const int rows = (N + NW * GR - 1) / (NW * GR) * (NW * GR);
  const int i = blockIdx.x + 1, b = blockIdx.y, ld = ld_of(N), NN = N * N;
  float* Fs = smem;                            // F_i
  float* Bs = Fs + N * ld;                     // B_i
  float* rl = Bs + N * ld;                     // per-row loss
  float* rc = rl + N;                          // per-row correct
  const size_t o = ((size_t)b * S + i) * NN;
  copy_rows(Fs, ld, f + o, N, N, N);
  copy_rows(Bs, ld, bk + o, N, N, N);
  __syncthreads();
  int bc[J];
  lane_cols(N, 1, bc);
  for (int r0 = warp * GR; r0 < rows; r0 += NW * GR) {
    const float* a[GR];
#pragma unroll
    for (int g = 0; g < GR; ++g) a[g] = Fs + min(r0 + g, N - 1) * ld;
    float acc[GR][J];
    zero(acc);
    warp_mm<GR, J>(a, 1, Bs, ld, bc, N, acc);
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      const int r = r0 + g;
      float s = 0.f, mx = -CUDART_INF_F, mine = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (lane + 32 * j < N) {
          s += acc[g][j];
          mx = fmaxf(mx, acc[g][j]);
        }
        if (j == (r >> 5)) mine = acc[g][j];
      }
      s = warp_sum(s);
      mx = warp_max(mx);
      const float diag = __shfl_sync(FULL, mine, r & 31);
      if (lane == 0 && r < N) {
        rl[r] = logf(s + N * EPS) - logf(diag + EPS);
        rc[r] = diag >= mx ? 1.f : 0.f;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float L = 0.f, A = 0.f;
    for (int r = 0; r < N; ++r) {
      L += rl[r];
      A += rc[r];
    }
    losses[(size_t)b * (S - 1) + i - 1] = L / N;
    accs[(size_t)b * (S - 1) + i - 1] = A / N;
  }
}

// --------------------------------------------------------------- backward

// One cycle: dAA_i = ((AA + eps) / rowsum - I) dl / N / (AA + eps);
// X_i = dAA_i B_i^T, Y_i = F_i^T dAA_i (slot i of xs, ys); grid (S - 1, B)
template <int J>
__global__ void __launch_bounds__(NT)
walk_cycle_bwd_kernel(const float* f, const float* bk, const float* dl,
                      float* xs, float* ys, int S, int N) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // every warp takes the same number of row groups (the warp sums need
  // whole warps); rows past N are computed clamped and not stored
  const int rows = (N + NW * GR - 1) / (NW * GR) * (NW * GR);
  const int i = blockIdx.x + 1, b = blockIdx.y, ld = ld_of(N), NN = N * N;
  float* Fs = smem;
  float* Bs = Fs + N * ld;
  float* Ds = Bs + N * ld;                     // dAA_i
  const size_t o = ((size_t)b * S + i) * NN;
  copy_rows(Fs, ld, f + o, N, N, N);
  copy_rows(Bs, ld, bk + o, N, N, N);
  const float gs = dl[(size_t)b * (S - 1) + i - 1] / N;
  int bc[J], bt[J];
  lane_cols(N, 1, bc);
  lane_cols(N, ld, bt);
  __syncthreads();
  for (int r0 = warp * GR; r0 < rows; r0 += NW * GR) {
    const float* a[GR];
#pragma unroll
    for (int g = 0; g < GR; ++g) a[g] = Fs + min(r0 + g, N - 1) * ld;
    float acc[GR][J];
    zero(acc);
    warp_mm<GR, J>(a, 1, Bs, ld, bc, N, acc);  // AA rows
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      const int r = r0 + g;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j)
        if (lane + 32 * j < N) s += acc[g][j];
      s = warp_sum(s) + N * EPS;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int e = lane + 32 * j;
        if (r < N && e < N) {
          const float aa = acc[g][j];
          const float dlog = ((aa + EPS) / s - (e == r ? 1.f : 0.f)) * gs;
          Ds[r * ld + e] = dlog / (aa + EPS);
        }
      }
    }
  }
  __syncthreads();
  for (int r0 = warp * GR; r0 < rows; r0 += NW * GR) {
    const float* a[GR];
#pragma unroll
    for (int g = 0; g < GR; ++g) a[g] = Ds + min(r0 + g, N - 1) * ld;
    float acc[GR][J];
    zero(acc);
    warp_mm<GR, J>(a, 1, Bs, 1, bt, N, acc);   // X[r][k] = sum_m dAA[r][m] B[k][m]
#pragma unroll
    for (int g = 0; g < GR; ++g)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int r = r0 + g, e = lane + 32 * j;
        if (r < N && e < N) xs[o + (size_t)r * N + e] = acc[g][j];
      }
#pragma unroll
    for (int g = 0; g < GR; ++g) a[g] = Fs + min(r0 + g, N - 1);
    zero(acc);
    warp_mm<GR, J>(a, ld, Ds, ld, bc, N, acc); // Y[k][m] = sum_r F[r][k] dAA[r][m]
#pragma unroll
    for (int g = 0; g < GR; ++g)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int r = r0 + g, e = lane + 32 * j;
        if (r < N && e < N) ys[o + (size_t)r * N + e] = acc[g][j];
      }
  }
}

// One step, one side: dP_i = F_{i-1}^T dF_i (side 0) or dQ_i = dB_i
// B_{i-1}^T (side 1), dP_0 = dF_0, dQ_0 = dB_0; then dD = zsm VJP / temp
// into o12 or o21, and its transpose into t12 or t21 (so that walk_dq reads
// both terms of dA and dA^T by rows); grid (S, 2, B)
template <int J>
__global__ void __launch_bounds__(NT)
walk_step_bwd_kernel(const float* d12, const float* d21, const float* f,
                     const float* bk, const float* dfs, const float* dbs,
                     float* o12, float* o21, float* t12, float* t21, int S,
                     int N, float temp) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // every warp takes the same number of row groups (the warp sums need
  // whole warps); rows past N are computed clamped and not stored
  const int rows = (N + NW * GR - 1) / (NW * GR) * (NW * GR);
  const int i = blockIdx.x, side = blockIdx.y, b = blockIdx.z;
  const int ld = ld_of(N), NN = N * N;
  float* Ms = smem;                            // F_{i-1} or B_{i-1}
  float* Ds = Ms + N * ld;                     // dF_i or dB_i
  const size_t o = ((size_t)b * S + i) * NN;
  const float* dv = (side ? dbs : dfs) + o;
  if (i > 0) {
    copy_rows(Ms, ld, (side ? bk : f) + o - NN, N, N, N);
    copy_rows(Ds, ld, dv, N, N, N);
    __syncthreads();
  }
  const float* x = (side ? d21 : d12) + o;
  float* y = (side ? o21 : o12) + o;
  float* yt = (side ? t21 : t12) + o;
  int bc[J];
  lane_cols(N, side ? ld : 1, bc);
  for (int r0 = warp * GR; r0 < rows; r0 += NW * GR) {
    float acc[GR][J], xv[GR][J];
    zero(acc);
#pragma unroll
    for (int g = 0; g < GR; ++g)
#pragma unroll
      for (int j = 0; j < J; ++j) {            // the logits, in flight early
        const int r = r0 + g, e = lane + 32 * j;
        const bool in = r < N && e < N;
        xv[g][j] = in ? x[(size_t)r * N + e] : 0.f;
        if (i == 0 && in) acc[g][j] = dv[(size_t)r * N + e];
      }
    if (i > 0) {
      const float* a[GR];
#pragma unroll
      for (int g = 0; g < GR; ++g) {
        const int r = min(r0 + g, N - 1);
        a[g] = side ? Ds + r * ld : Ms + r;
      }
      // dP[n][m] = sum_k F[k][n] dF[k][m]; dQ[n][m] = sum_k dB[n][k] B[m][k]
      warp_mm<GR, J>(a, side ? 1 : ld, side ? Ms : Ds, side ? 1 : ld, bc, N, acc);
    }
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      const int r = r0 + g;
      float ex[J], u[J];
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        ex[j] = u[j] = 0.f;
        if (lane + 32 * j < N) {
          ex[j] = expm1f(xv[g][j]);
          u[j] = ex[j] * ex[j];
          s += u[j];
        }
      }
      s = warp_sum(s) + ZSM_EPS;
      float t = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j)
        if (lane + 32 * j < N) t += acc[g][j] * (u[j] / s);
      t = warp_sum(t);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int e = lane + 32 * j;
        if (r < N && e < N) {
          const float du = (acc[g][j] - t) / s;
          const float dd = du * 2.f * ex[j] * expf(xv[g][j]) / temp;
          y[(size_t)r * N + e] = dd;
          yt[(size_t)e * N + r] = dd;
        }
      }
    }
  }
}

// dq_t = dA_t q_{t+1} + dA_{t-1}^T q_{t-1} with dA = dD12 + dD21^T, for 32
// rows x 64 channels of one frame; grid (row tiles x channel tiles, T, B).
// The dA rows sit in shared memory at a stride of N rounded up to 4 and
// are read 4 m at a time (16-byte broadcasts); q's rows past N and dA's
// columns past N are zeros (exact zeros added to the sums); a lane owns
// channels 2 lane, 2 lane + 1 (8-byte reads).
__global__ void __launch_bounds__(NT)
walk_dq_kernel(const float* q, const float* o12, const float* o21,
               const float* t12, const float* t21, float* dq, int T, int N,
               int C) {
  extern __shared__ __align__(16) float smem_dq[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ctiles = (C + DQ_TC - 1) / DQ_TC;
  const int n0 = (blockIdx.x / ctiles) * TILE, c0 = (blockIdx.x % ctiles) * DQ_TC;
  const int t = blockIdx.y, b = blockIdx.z, S = T - 1, la = (N + 3) & ~3;
  const size_t NN = (size_t)N * N;
  float* A1 = smem_dq;                         // dA_t rows n0..n0+31
  float* A2 = A1 + TILE * la;                  // dA_{t-1}^T rows
  float* Q1 = A2 + TILE * la;                  // q_{t+1}, la x 64 channels
  float* Q2 = Q1 + la * DQ_TC;                 // q_{t-1}
  const bool fwd = t < S, back = t > 0;
  const int cols = min(DQ_TC, C - c0);         // channels past C: not stored
  if (fwd) copy_rows(Q1, DQ_TC, q + (((size_t)b * T + t + 1) * N) * C + c0, C, N, cols);
  if (back) copy_rows(Q2, DQ_TC, q + (((size_t)b * T + t - 1) * N) * C + c0, C, N, cols);
  for (int i = N * DQ_TC + threadIdx.x; i < la * DQ_TC; i += NT)
    Q1[i] = Q2[i] = 0.f;
  // rows n of dA_t = dD12_t + dD21_t^T and of dA_{t-1}^T = dD12_{t-1}^T +
  // dD21_{t-1}, all four read by rows
  const size_t now = ((size_t)b * S + (fwd ? t : 0)) * NN;
  const size_t was = ((size_t)b * S + (back ? t - 1 : 0)) * NN;
  const float* r1 = o12 + now;
  const float* r2 = t21 + now;
  const float* r3 = t12 + was;
  const float* r4 = o21 + was;
  // this warp's 4 rows of both terms, 16 loads in flight a lane
  for (int m = lane; m < la; m += 32) {
    float v[GR][4];
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      const int n = n0 + warp * GR + g;
      const size_t x = (size_t)n * N + m;
      const bool f_ = fwd && n < N && m < N, b_ = back && n < N && m < N;
      v[g][0] = f_ ? r1[x] : 0.f;
      v[g][1] = f_ ? r2[x] : 0.f;
      v[g][2] = b_ ? r3[x] : 0.f;
      v[g][3] = b_ ? r4[x] : 0.f;
    }
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      A1[(warp * GR + g) * la + m] = v[g][0] + v[g][1];
      A2[(warp * GR + g) * la + m] = v[g][2] + v[g][3];
    }
  }
  __syncthreads();
  float acc[GR][2];
  zero(acc);
  auto term = [&](const float* A, const float* Q) {
    const float* ar = A + warp * GR * la;
    const float* qc = Q + 2 * lane;
#pragma unroll 2
    for (int m = 0; m < la; m += 4) {
      float4 a4[GR];
#pragma unroll
      for (int g = 0; g < GR; ++g)
        a4[g] = *reinterpret_cast<const float4*>(ar + g * la + m);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 q2 = *reinterpret_cast<const float2*>(qc + (m + u) * DQ_TC);
#pragma unroll
        for (int g = 0; g < GR; ++g) {
          const float a = u == 0 ? a4[g].x : u == 1 ? a4[g].y : u == 2 ? a4[g].z : a4[g].w;
          acc[g][0] = fmaf(a, q2.x, acc[g][0]);
          acc[g][1] = fmaf(a, q2.y, acc[g][1]);
        }
      }
    }
  };
  if (fwd) term(A1, Q1);
  if (back) term(A2, Q2);
#pragma unroll
  for (int g = 0; g < GR; ++g)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + warp * GR + g, c = c0 + 2 * lane + j;
      if (n < N && c < C) dq[(((size_t)b * T + t) * N + n) * C + c] = acc[g][j];
    }
}

// ------------------------------------------------------------------ host

template <class Fn>
cudaError_t with_j(int N, Fn fn) {
  switch ((N + 31) / 32) {
    case 1: return fn(std::integral_constant<int, 1>());
    case 2: return fn(std::integral_constant<int, 2>());
    case 3: return fn(std::integral_constant<int, 3>());
    default: return fn(std::integral_constant<int, 4>());
  }
}

// a kernel launch with its error; above 48 KB of dynamic shared memory the
// kernel is first opted into the block's whole share
template <class K, class... Args>
cudaError_t launch(K kernel, dim3 grid, int threads, size_t smem,
                   cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_OPTIN);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// the recursions: 8 vectors a block; the vectors, the partial sums and two
// N x N slots in shared memory
template <bool BWD>
cudaError_t launch_chain(const float* p, const float* qz, const float* add0,
                         const float* add1, float* out0, float* out1, int B,
                         int S, int N, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)NW * N + (size_t)NW * NW * N + 2 * (size_t)N * ld_of(N));
  const dim3 grid((N + NW - 1) / NW, 2, B);
  return with_j(N, [&](auto jc) {
    constexpr int J = decltype(jc)::value;
    return launch(walk_chain_kernel<J, BWD>, grid, NT, smem, stream, p, qz,
                  add0, add1, out0, out1, S, N);
  });
}

bool bad_shape(int B, int T, int N, int C) {
  return B < 1 || T < 3 || N < 1 || N > MAXN || C < 1;
}

}  // namespace

extern "C" {

long walk_bwd_workspace_floats(int B, int T, int N) {
  return 6L * B * (T - 1) * N * N;
}

int walk_fwd_launch(const float* q, const uint8_t* m12, const uint8_t* m21,
                    float* losses, float* accs, float* d12, float* d21,
                    float* f, float* bk, float* p, float* qz, int B, int T,
                    int N, int C, float temp, cudaStream_t stream) {
  if (bad_shape(B, T, N, C)) return (int)cudaErrorInvalidValue;
  const int S = T - 1, ld = ld_of(N), tiles = (N + TILE - 1) / TILE;
  const bool vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  cudaError_t err = launch(
      vec ? walk_affinity_kernel<true> : walk_affinity_kernel<false>,
      dim3(tiles * tiles, S, B), AT, 0, stream, q, m12, m21, d12, d21, T, N,
      C, temp);
  if (err != cudaSuccess) return (int)err;
  err = with_j(N, [&](auto jc) {
    constexpr int J = decltype(jc)::value;
    return launch(walk_zsm_kernel<J>, dim3((2 * S * N + NW - 1) / NW, B), NT,
                  0, stream, (const float*)d12, (const float*)d21, p, qz, f,
                  bk, S, N);
  });
  if (err != cudaSuccess) return (int)err;
  err = launch_chain<false>(p, qz, nullptr, nullptr, f, bk, B, S, N, stream);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * (2 * (size_t)N * ld + 2 * N);
  err = with_j(N, [&](auto jc) {
    constexpr int J = decltype(jc)::value;
    return launch(walk_cycle_fwd_kernel<J>, dim3(S - 1, B), NT, smem, stream,
                  (const float*)f, (const float*)bk, losses, accs, S, N);
  });
  return (int)err;
}

// ws: walk_bwd_workspace_floats(B, T, N) floats: X_i (later dD12), Y_i
// (later dD21), dF_i, dB_i, dD12^T, dD21^T, each (B, S, N, N)
int walk_bwd_launch(const float* q, const float* d12, const float* d21,
                    const float* f, const float* bk, const float* p,
                    const float* qz, const float* dl, float* dq, float* ws,
                    int B, int T, int N, int C, float temp,
                    cudaStream_t stream) {
  if (bad_shape(B, T, N, C)) return (int)cudaErrorInvalidValue;
  const int S = T - 1, ld = ld_of(N);
  const size_t set = (size_t)B * S * N * N;
  float* xs = ws;
  float* ys = ws + set;
  float* dfs = ws + 2 * set;
  float* dbs = ws + 3 * set;
  float* t12 = ws + 4 * set;
  float* t21 = ws + 5 * set;
  cudaError_t err = with_j(N, [&](auto jc) {
    constexpr int J = decltype(jc)::value;
    return launch(walk_cycle_bwd_kernel<J>, dim3(S - 1, B), NT,
                  sizeof(float) * 3 * (size_t)N * ld, stream, f, bk, dl, xs,
                  ys, S, N);
  });
  if (err != cudaSuccess) return (int)err;
  err = launch_chain<true>(p, qz, xs, ys, dfs, dbs, B, S, N, stream);
  if (err != cudaSuccess) return (int)err;
  err = with_j(N, [&](auto jc) {
    constexpr int J = decltype(jc)::value;
    return launch(walk_step_bwd_kernel<J>, dim3(S, 2, B), NT,
                  sizeof(float) * 2 * (size_t)N * ld, stream, d12, d21, f, bk,
                  (const float*)dfs, (const float*)dbs, xs, ys, t12, t21, S,
                  N, temp);
  });
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((N + TILE - 1) / TILE) * ((C + DQ_TC - 1) / DQ_TC);
  const size_t la = (N + 3) & ~3;
  err = launch(walk_dq_kernel, dim3(tiles, T, B), NT,
               sizeof(float) * 2 * (TILE + DQ_TC) * la, stream, q,
               (const float*)xs, (const float*)ys, (const float*)t12,
               (const float*)t21, dq, T, N, C);
  return (int)err;
}

}  // extern "C"
