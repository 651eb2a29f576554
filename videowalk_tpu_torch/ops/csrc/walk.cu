// Fused palindrome-walk loss: forward (walk_fwd_kernel) and backward
// (walk_bwd_kernel), one block per batch element.
//
// Replaces the Pallas TPU kernels videowalk_tpu/ops/walk_kernel.py::
// _walk_fwd_kernel (via _fwd_call) and ::_walk_bwd_kernel (via _bwd_call),
// built from what they compute, not from their (8, 128) layout. Per batch
// element, S = T - 1 steps:
//   forward   A_s = q_s q_{s+1}^T (f32 FMA chains, no TF32: logits reach
//             +-20 at T 0.05, so a 1e-3 error in A moves a ZeroSoftmax
//             weight by ~4%); D12_s = (m12_s ? -1e20 : A_s) / T,
//             D21_s = (m21_s ? -1e20 : A_s^T) / T; P = zsm(D12), Q = zsm(D21)
//             with zsm(x) = expm1(x)^2 / (row sum + 1e-5); F_0 = P_0,
//             F_i = F_{i-1} P_i; B_0 = Q_0, B_i = Q_i B_{i-1}; AA_i = F_i B_i;
//             per cycle i = 1..S-1: loss = mean_rows[log(rowsum + N 1e-20) -
//             log(diag + 1e-20)], acc = mean_rows[diag >= rowmax].
//   backward  the hand VJP from the residuals D12, D21, F, B walked in
//             reverse (dF, dB accumulators; zsm VJP; dA = dD12 + dD21^T;
//             dq_s += dA q_{s+1}, dq_{s+1} += dA^T q_s).
// No padding of N or C; losses/accs come out as (B, S-1) f32; the masks are
// drawn outside (uint8, nonzero = dropped).
//
// Bound. At the flagship shape (B=8, T=8, N=49, C=128) the forward reads q
// and the masks and writes four (B,S,N,N) f32 residuals, ~4.0 MB for 68 MFLOP
// of f32; the backward reads q and the residuals and writes dq, ~5.4 MB for
// 148 MFLOP. At 3.35 TB/s and 67 TFLOP/s that is 1.2 us (bytes) and 2.2 us
// (operations): far below a launch's latency, so what decides the time is
// the serial chain of small dependent products inside one block.
//
// Design: simple and correct first. One block of 256 threads per batch
// element loops over the S steps (8 blocks on 132 SMs at the flagship shape:
// the card is mostly idle; splitting a batch element's rows over several
// blocks is later work). Every N x N product is one output element per
// thread, a sequential f32 FMA chain over k. Row reductions (ZeroSoftmax,
// the loss rows, the zsm VJP) take one warp per row, each lane holding at
// most 4 of the N <= 128 columns in registers. (A variant in which each
// thread ran a tile of 16 independent outputs side by side, with guarded
// loads, measured slower on the H100: 0.82 / 2.44 ms against 0.52 / 1.29 ms
// at the flagship shape; its extra address and guard instructions cost more
// than the chains' latency it hid. Faster designs stage operand tiles in
// shared memory and split a batch element over several blocks.)
//   forward   shared memory holds P or Q (N x N), the affinity / AA matrix
//             (N x N) and 32-channel chunks of the q rows of the two frames
//             (2 x N x 33): 162 KB at N = 128. F_i and B_i are computed
//             straight into their residual slots in global memory (they are
//             outputs anyway) and read back from L2 for the next step; F_0 and
//             B_0 are stored too, so the backward reads F_{i-1} uniformly.
//   backward  five N x N matrices (dF, dB and three temporaries): in shared
//             memory while they fit (N <= 101, 200 KB), else in a per-block
//             global scratch the wrapper allocates (N = 128: 320 KB a block,
//             L2-resident). Each block writes only its own dq slice, and a
//             given dq element is always updated by the same thread, so no
//             atomics are needed.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (videowalk_tpu_torch/ops/_build.py); plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;              // threads per block
constexpr int NW = NT / 32;          // warps per block
constexpr int KC = 32;               // q channels per staged chunk
constexpr int MAXN = 128;            // widest node count (4 columns a lane)
constexpr int BWD_MATS = 5;          // dF, dB, W1, W2, W3
constexpr int SMEM_OPTIN = 232448;   // shared memory one Hopper block may use
constexpr int BWD_SMEM_MAX = 200 * 1024;
constexpr float EPS = 1e-20f;        // reference code/model.py:12
constexpr float ZSM_EPS = 1e-5f;     // ZeroSoftmax eps
constexpr float NEG = -1e20f;        // edge-dropout fill

size_t fwd_smem_bytes(int N) {
  return sizeof(float) * ((size_t)2 * N * N + (size_t)2 * N * (KC + 1) + 2 * N);
}

bool bwd_in_smem(int N) {
  return sizeof(float) * (size_t)BWD_MATS * N * N <= (size_t)BWD_SMEM_MAX;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// dst rows = zsm(src rows), N x N; one warp per row. dst may alias src.
__device__ void zsm_rows(const float* src, float* dst, int N) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < N; r += NW) {
    float u[MAXN / 32];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < MAXN / 32; ++j) {
      const int m = lane + 32 * j;
      u[j] = 0.f;
      if (m < N) {
        const float e = expm1f(src[r * N + m]);
        u[j] = e * e;
        s += u[j];
      }
    }
    s = warp_sum(s) + ZSM_EPS;
#pragma unroll
    for (int j = 0; j < MAXN / 32; ++j) {
      const int m = lane + 32 * j;
      if (m < N) dst[r * N + m] = u[j] / s;
    }
  }
}

// dy rows <- VJP of zsm at logits x for upstream dy, divided by the
// temperature (in place); one warp per row.
__device__ void zsm_bwd_rows(const float* x, float* dy, int N, float temp) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < N; r += NW) {
    float e[MAXN / 32], u[MAXN / 32], g[MAXN / 32];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < MAXN / 32; ++j) {
      const int m = lane + 32 * j;
      e[j] = u[j] = g[j] = 0.f;
      if (m < N) {
        e[j] = expm1f(x[r * N + m]);
        u[j] = e[j] * e[j];
        g[j] = dy[r * N + m];
        s += u[j];
      }
    }
    s = warp_sum(s) + ZSM_EPS;
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < MAXN / 32; ++j) t += g[j] * (u[j] / s);
    t = warp_sum(t);
#pragma unroll
    for (int j = 0; j < MAXN / 32; ++j) {
      const int m = lane + 32 * j;
      if (m < N) {
        const float du = (g[j] - t) / s;
        dy[r * N + m] = du * 2.f * e[j] * expf(x[r * N + m]) / temp;
      }
    }
  }
}

// Cm (=|+=) op(A) op(B), N x N, one output element per thread: op(A)(n, k)
// is A[n][k] or, with TA, A[k][n]; likewise op(B)(k, m) with TB. Cm must not
// alias A or B (with ACC each element is read and written by one thread).
template <bool TA, bool TB, bool ACC>
__device__ void mm(const float* A, const float* B, float* Cm, int N) {
  for (int idx = threadIdx.x; idx < N * N; idx += NT) {
    const int n = idx / N, m = idx - n * N;
    float acc = 0.f;
    for (int k = 0; k < N; ++k) {
      const float a = TA ? A[k * N + n] : A[n * N + k];
      const float b = TB ? B[m * N + k] : B[k * N + m];
      acc = fmaf(a, b, acc);
    }
    if (ACC) Cm[idx] += acc; else Cm[idx] = acc;
  }
}

// dq_s += dA q_{s+1}; dq_{s+1} += dA^T q_s (the block's own (T, N, C) slice).
// Element (frame, row, c) is always owned by thread (row * C + c) % NT.
__device__ void add_dq(float* dq, const float* q, const float* dA, int s,
                       int N, int C) {
  for (int idx = threadIdx.x; idx < N * C; idx += NT) {
    const int n = idx / C, c = idx - n * C;
    const float* qn = q + (size_t)(s + 1) * N * C + c;
    float acc = 0.f;
    for (int m = 0; m < N; ++m) acc = fmaf(dA[n * N + m], qn[(size_t)m * C], acc);
    dq[(size_t)s * N * C + idx] += acc;
  }
  for (int idx = threadIdx.x; idx < N * C; idx += NT) {
    const int m = idx / C, c = idx - m * C;
    const float* qs = q + (size_t)s * N * C + c;
    float acc = 0.f;
    for (int n = 0; n < N; ++n) acc = fmaf(dA[n * N + m], qs[(size_t)n * C], acc);
    dq[(size_t)(s + 1) * N * C + idx] += acc;
  }
}

__global__ void __launch_bounds__(NT)
walk_fwd_kernel(const float* q, const uint8_t* m12, const uint8_t* m21,
                float* losses, float* accs, float* d12, float* d21, float* f,
                float* bk, int T, int N, int C, float temp) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x, S = T - 1, NN = N * N;
  float* P = smem;                      // zsm(D12_i) / zsm(D21_i)
  float* AA = P + NN;                   // affinity A_s, then AA_i
  float* qa = AA + NN;                  // q_s chunk, rows padded to KC + 1
  float* qb = qa + N * (KC + 1);        // q_{s+1} chunk
  float* rl = qb + N * (KC + 1);        // per-row loss
  float* rc = rl + N;                   // per-row correct
  const float* qbase = q + (size_t)b * T * N * C;
  const size_t mo = (size_t)b * S * NN;

  // 1. logits: A_s over 32-channel chunks, then the fill and the divide
  for (int s = 0; s < S; ++s) {
    for (int i = tid; i < NN; i += NT) AA[i] = 0.f;
    for (int c0 = 0; c0 < C; c0 += KC) {
      const int kc = min(KC, C - c0);
      __syncthreads();                  // the previous chunk is consumed
      for (int i = tid; i < N * KC; i += NT) {
        const int n = i / KC, c = i - n * KC;
        const bool ok = c < kc;
        qa[n * (KC + 1) + c] = ok ? qbase[((size_t)s * N + n) * C + c0 + c] : 0.f;
        qb[n * (KC + 1) + c] = ok ? qbase[((size_t)(s + 1) * N + n) * C + c0 + c] : 0.f;
      }
      __syncthreads();
      for (int i = tid; i < NN; i += NT) {
        const int n = i / N, m = i - n * N;
        float acc = AA[i];
        for (int c = 0; c < kc; ++c)
          acc = fmaf(qa[n * (KC + 1) + c], qb[m * (KC + 1) + c], acc);
        AA[i] = acc;
      }
    }
    // each AA[i] was accumulated by this same thread: no barrier needed
    for (int i = tid; i < NN; i += NT) {
      const int n = i / N, m = i - n * N;
      const float a = AA[i];
      const size_t o = mo + (size_t)s * NN;
      d12[o + i] = (m12[o + i] ? NEG : a) / temp;
      d21[o + m * N + n] = (m21[o + m * N + n] ? NEG : a) / temp;
    }
  }
  __syncthreads();

  // 2. prefix products and the per-cycle loss
  zsm_rows(d12 + mo, f + mo, N);
  zsm_rows(d21 + mo, bk + mo, N);
  __syncthreads();
  for (int i = 1; i < S; ++i) {
    const size_t cur = mo + (size_t)i * NN, prev = cur - NN;
    zsm_rows(d12 + cur, P, N);
    __syncthreads();
    mm<false, false, false>(f + prev, P, f + cur, N);         // F_i = F_{i-1} P_i
    __syncthreads();
    zsm_rows(d21 + cur, P, N);
    __syncthreads();
    mm<false, false, false>(P, bk + prev, bk + cur, N);       // B_i = Q_i B_{i-1}
    __syncthreads();
    mm<false, false, false>(f + cur, bk + cur, AA, N);        // AA_i = F_i B_i
    __syncthreads();
    for (int r = warp; r < N; r += NW) {
      float s = 0.f, mx = -CUDART_INF_F;
      for (int m = lane; m < N; m += 32) {
        const float v = AA[r * N + m];
        s += v;
        mx = fmaxf(mx, v);
      }
      s = warp_sum(s);
      mx = warp_max(mx);
      if (lane == 0) {
        const float diag = AA[r * N + r];
        rl[r] = logf(s + N * EPS) - logf(diag + EPS);
        rc[r] = diag >= mx ? 1.f : 0.f;
      }
    }
    __syncthreads();
    if (tid == 0) {
      float L = 0.f, A = 0.f;
      for (int r = 0; r < N; ++r) {
        L += rl[r];
        A += rc[r];
      }
      losses[(size_t)b * (S - 1) + i - 1] = L / N;
      accs[(size_t)b * (S - 1) + i - 1] = A / N;
    }
  }
}

__global__ void __launch_bounds__(NT)
walk_bwd_kernel(const float* q, const float* d12, const float* d21,
                const float* f, const float* bk, const float* dl, float* dq,
                float* ws, int T, int N, int C, float temp, int in_smem) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  const int b = blockIdx.x, S = T - 1, NN = N * N;
  float* base = in_smem ? smem : ws + (size_t)b * BWD_MATS * NN;
  float* dF = base;
  float* dB = base + NN;
  float* W1 = base + 2 * NN;
  float* W2 = base + 3 * NN;
  float* W3 = base + 4 * NN;
  const float* qb = q + (size_t)b * T * N * C;
  float* dqb = dq + (size_t)b * T * N * C;
  const size_t mo = (size_t)b * S * NN;

  for (int i = tid; i < T * N * C; i += NT) dqb[i] = 0.f;
  for (int i = tid; i < NN; i += NT) dF[i] = dB[i] = 0.f;
  __syncthreads();

  for (int i = S - 1; i >= 1; --i) {
    const size_t cur = mo + (size_t)i * NN, prev = cur - NN;
    const float* F = f + cur;
    const float* Bk = bk + cur;
    mm<false, false, false>(F, Bk, W1, N);                    // AA
    __syncthreads();
    // dAA = (softmax of log(AA + eps) - I) * dl_i / N / (AA + eps)
    const float g = dl[(size_t)b * (S - 1) + i - 1] / N;
    for (int r = tid >> 5; r < N; r += NW) {
      float s = 0.f;
      for (int m = lane; m < N; m += 32) s += W1[r * N + m];
      s = warp_sum(s) + N * EPS;
      for (int m = lane; m < N; m += 32) {
        const float aa = W1[r * N + m];
        const float dlog = ((aa + EPS) / s - (m == r ? 1.f : 0.f)) * g;
        W1[r * N + m] = dlog / (aa + EPS);
      }
    }
    __syncthreads();
    mm<false, true, true>(W1, Bk, dF, N);                     // dF += dAA B_i^T
    mm<true, false, true>(F, W1, dB, N);                      // dB += F_i^T dAA
    __syncthreads();
    mm<true, false, false>(f + prev, dF, W2, N);              // dP = F_{i-1}^T dF
    mm<false, true, false>(dB, bk + prev, W3, N);             // dQ = dB B_{i-1}^T
    __syncthreads();
    zsm_bwd_rows(d12 + cur, W2, N, temp);                     // dD12
    zsm_bwd_rows(d21 + cur, W3, N, temp);                     // dD21
    __syncthreads();
    for (int idx = tid; idx < NN; idx += NT) {                // dA = dD12 + dD21^T
      const int n = idx / N, m = idx - n * N;
      W2[idx] += W3[m * N + n];
    }
    __syncthreads();
    add_dq(dqb, qb, W2, i, N, C);
    __syncthreads();
    zsm_rows(d12 + cur, W3, N);                               // P_i
    __syncthreads();
    mm<false, true, false>(dF, W3, W2, N);                    // dF P_i^T
    __syncthreads();
    zsm_rows(d21 + cur, W3, N);                               // Q_i
    __syncthreads();
    mm<true, false, false>(W3, dB, W1, N);                    // Q_i^T dB
    __syncthreads();
    float* t = dF; dF = W2; W2 = t;
    t = dB; dB = W1; W1 = t;
  }
  // step 0: P_0 = F_0 takes dF, Q_0 = B_0 takes dB
  zsm_bwd_rows(d12 + mo, dF, N, temp);
  zsm_bwd_rows(d21 + mo, dB, N, temp);
  __syncthreads();
  for (int idx = tid; idx < NN; idx += NT) {
    const int n = idx / N, m = idx - n * N;
    dF[idx] += dB[m * N + n];
  }
  __syncthreads();
  add_dq(dqb, qb, dF, 0, N, C);
}

}  // namespace

extern "C" {

long walk_bwd_workspace_floats(int N) {
  return bwd_in_smem(N) ? 0L : (long)BWD_MATS * N * N;
}

int walk_fwd_launch(const float* q, const uint8_t* m12, const uint8_t* m21,
                    float* losses, float* accs, float* d12, float* d21,
                    float* f, float* bk, int B, int T, int N, int C,
                    float temp, cudaStream_t stream) {
  if (B < 1 || T < 3 || N < 1 || N > MAXN || C < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(
      walk_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_OPTIN);
  if (err != cudaSuccess) return (int)err;
  walk_fwd_kernel<<<B, NT, smem, stream>>>(q, m12, m21, losses, accs, d12, d21,
                                           f, bk, T, N, C, temp);
  return (int)cudaGetLastError();
}

int walk_bwd_launch(const float* q, const float* d12, const float* d21,
                    const float* f, const float* bk, const float* dl, float* dq,
                    float* ws, int B, int T, int N, int C, float temp,
                    cudaStream_t stream) {
  if (B < 1 || T < 3 || N < 1 || N > MAXN || C < 1) return (int)cudaErrorInvalidValue;
  const int in_smem = bwd_in_smem(N) ? 1 : 0;
  const size_t smem = in_smem ? sizeof(float) * (size_t)BWD_MATS * N * N : 0;
  cudaError_t err = cudaFuncSetAttribute(
      walk_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_OPTIN);
  if (err != cudaSuccess) return (int)err;
  walk_bwd_kernel<<<B, NT, smem, stream>>>(q, d12, d21, f, bk, dl, dq, ws, T, N,
                                           C, temp, in_smem);
  return (int)cudaGetLastError();
}

}  // extern "C"
