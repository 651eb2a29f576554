// Block-sparse top-k label propagation, one launch per target frame.
//
// Replaces the Pallas TPU kernel videowalk_tpu/ops/prop_sparse_kernel.py::_kernel
// (reached through sparse_band_propagate :271; built from what it computes,
// not from its layout). For every valid query cell of the target frame:
//   candidates  every in-frame cell of each long-term context frame (raster
//               order), then for each short-term frame in context-slot order
//               the in-frame cells with dy^2 + dx^2 < radius^2 (row-major,
//               which is raster order);
//   logit       dot_f32(q, k) / T: f32 FMAs in channel order, no TF32;
//   selection   the top-k logits; a tie goes to the earlier candidate, id
//               l*HW + cell;
//   output      sum_j exp(a_j - a_max) label_j / sum_j exp(a_j - a_max).
//
// Bound (DAVIS-480p: C=256, 60x107, 1 long + 20 short frames, r=12): about
// 6420 queries x ~15.5k valid candidates x 256 channels per target, 51 GFLOP
// of f32 products, 0.76 ms at 67 TFLOP/s. Key bytes are reused from L2, so
// the kernel is bound by operations, not bytes.
//
// Why f32 FMAs and not the tensor cores: 3xTF32 (mma.sync m16n8k8, each
// operand split into two TF32 parts, three products) was built and measured
// first. On random features it kept the plain version's top-k on all but
// 4e-5 of the queries, but on features whose candidates tie to within
// ~1e-5 in logit (rolled copies of one texture) it moved 0.3% of the label
// cells by more than 1e-4, where f32 FMAs move none (PERF.md): near-tie
// flips drift the autoregressive propagation.
//
// Design. One block per 8x8 query tile (112 blocks at DAVIS-480p on 132
// SMs: the rest stay idle; any even split of a tile's candidates over more
// blocks leaves the busiest SMs as much work, PERF.md). The tile's 64 query
// vectors stay in shared memory; the candidates stream as one list through
// all context frames in chunks of 256 keys, each chunk in steps of 32
// channels through two shared-memory stages filled by cp.async (the next
// step's copies overlap this step's FMAs; one barrier a step).
//
//   Wide features. The resident query tile takes 64 x C floats, which fits
//   one block's shared memory up to C = 576 (k = 10, r = 12). Wider
//   features (ResNet-50: 1024 without layer4, 2048 with it) take the
//   streamed form, STREAM_Q: each step's 32-channel slice of the 64 queries
//   rides the keys' two cp.async stages (2 x 64 x 32 floats, 16 KB), so the
//   tile is read again from L2 once a key chunk (256 KB a chunk at C =
//   1024, beside 268M FMAs). Each dot keeps its channel order, so both
//   forms give the same bits; the host takes the resident one wherever it
//   fits.
//
//   Candidates. Short-frame candidates are only those some query of the
//   tile can take: the union of the 64 queries' disks, offsets (oy, ox)
//   from the tile's corner whose distance to the tile's nearest query is
//   under the radius (|d| <= ceil(r) - 1), in row-major order. Each row of
//   the union is one interval of columns, so a block keeps one table row a
//   union row (its first list index, oy, the first ox and the count, cut to
//   the frame) and finds a candidate's row by binary search. At DAVIS the
//   union holds 808 cells (the previous window 1024): the block scores
//   22.6k candidates a query where 15.2k are valid.
//
//   Register tile. Warp w owns queries 8w .. 8w+7 against all 256 keys of
//   a chunk: a thread holds 8 queries x 8 keys (lane + 32j), 64 f32
//   accumulators. Per 4 channels it reads 8 query float4s (the same for
//   every lane: broadcast) and 8 key float4s (its own; rows XOR-swizzled so
//   a quarter-warp's reads hit distinct banks) for 256 FMAs, half the
//   shared-memory loads per FMA of the previous 4 x 4 tile, so the loop is
//   bound by the FMAs, not by shared memory. Each pair's dot is summed in
//   channel order, as before.
//
//   Selection without a serial pass over the chunk. A score is filtered
//   where its accumulator sits, against its query's current k-th value
//   (exact: every earlier candidate has a smaller id); only lanes with a hit
//   take part: one at a time (by ballot) it stages its 8 x 8 hits in the
//   warp's scratch and lanes 0-7 insert them, each into its own query's
//   top-k list, sorted by (value descending, id ascending). The lists are
//   the warp's own, so no block barrier is spent on the selection. At the
//   end the k label rows are gathered from the label buffer as it stands in
//   stream order, so the prediction of an earlier target (written between
//   launches) is read, never cached.
//
//   Tile-row bands. A launch covers the tile rows row0 .. row0+n_rows-1 of
//   the query grid (grid.y = n_rows) and writes those rows alone, at band-
//   local rows of out; the keys keep their whole frame and halo. A query's
//   candidates, their order and its sums do not depend on the band, so the
//   bands of a frame give the whole frame's bits (eval --data-parallel
//   splits a target over devices this way, eval/propagation.py).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (videowalk_tpu_torch/ops/_build.py); plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TQ = 8;            // query tile side
constexpr int NQ = TQ * TQ;      // queries per block
constexpr int NT = 256;          // threads per block: 8 warps of 8 queries
constexpr int KC = 256;          // keys a chunk: one a thread to copy
constexpr int CS = 32;           // channels a step
constexpr int SMEM_OPTIN = 232448;  // shared memory one Hopper block may use

__host__ __device__ constexpr int padded(int C) { return (C + CS - 1) / CS * CS; }

// Dynamic shared memory of a launch (bytes) with the query tile resident
// (C rounded up to a step) or streamed (two stages of NQ x CS): the query
// floats, two key stages of KC x CS, the top-k lists (values, then ids),
// two chunks' key cells, offsets and slots, the warps' scratch, the
// union's row table, two counters.
__host__ __device__ constexpr size_t smem_form_bytes(int C, int topk, int rr,
                                                     bool stream_q) {
  return 4 * ((stream_q ? (size_t)2 * NQ * CS : (size_t)NQ * padded(C))
              + 2 * KC * CS) + (size_t)NQ * topk * 8
         + (size_t)2 * KC * 12 + (size_t)(NT / 32) * 64 * 4
         + (size_t)(TQ + 2 * rr) * 16 + 16;
}
// The streamed form where the resident one does not fit one block.
__host__ __device__ constexpr bool streams_query(int C, int topk, int rr) {
  return smem_form_bytes(C, topk, rr, false) > SMEM_OPTIN;
}
__host__ __device__ constexpr size_t smem_bytes(int C, int topk, int rr) {
  return smem_form_bytes(C, topk, rr, streams_query(C, topk, rr));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  // 16-byte global->shared copy; zero-fills when !valid (nothing is read)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// (v, id) ranks above (w, jd): higher value, or the same and an earlier id
__device__ __forceinline__ bool above(float v, int id, float w, int jd) {
  return v > w || (v == w && id < jd);
}

template <bool STREAM_Q>
__global__ void __launch_bounds__(NT, 1) prop_sparse_kernel(
    const float* __restrict__ feats,    // (N, HW, C) L2-normalized features
    const float* __restrict__ labels,   // (N, HW, NL) label buffer
    const int* __restrict__ ctx,        // (L,) context frame indices
    float* __restrict__ out,            // (band rows x W, NL) predictions
    int H, int W, int C, int NL, int L, int n_long, int t_query, int topk,
    float inv_t, float r2, int rr, int row0) {
  extern __shared__ float4 smem4[];
  const int CQ = padded(C);             // channels a dot runs over
  const int QS = STREAM_Q ? CS : CQ;    // query row stride in q_s, floats
  const int C4 = C / 4;                 // 16-byte chunks of a feature row
  const int HW = H * W;
  float* q_s = reinterpret_cast<float*>(smem4);  // NQ x CQ, or 2 x NQ x CS
  float* k_s = q_s + (STREAM_Q ? 2 * NQ * CS : NQ * CQ);  // 2 x KC x CS
  float* lv = k_s + 2 * KC * CS;                        // NQ x topk values
  int* li = reinterpret_cast<int*>(lv + NQ * topk);     // ... and ids
  int* kcell = li + NQ * topk;                          // [2][KC]: -1 none
  int* koff = kcell + 2 * KC;                           // [2][KC]: oy<<16|ox
  int* kslot = koff + 2 * KC;                           // [2][KC]: slot l
  float* scratch = reinterpret_cast<float*>(kslot + 2 * KC);  // [8][64]
  int4* rowt = reinterpret_cast<int4*>(scratch + (NT / 32) * 64);
  int* counts = reinterpret_cast<int*>(rowt + TQ + 2 * rr);   // rows, cells

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty0 = (row0 + (int)blockIdx.y) * TQ, tx0 = (int)blockIdx.x * TQ;

  // ---- the union of the tile's disks, in frame: one interval a row
  const int nwin = TQ + 2 * rr;
  for (int i = tid; i < nwin; i += NT) {
    const int oy = i - rr, y = ty0 + oy;
    const int dyc = oy < 0 ? -oy : (oy > TQ - 1 ? oy - (TQ - 1) : 0);
    int lo = 0, cnt = 0;
    if (y >= 0 && y < H && (float)(dyc * dyc) < r2) {
      int m = rr;
      while (m > 0 && !((float)(dyc * dyc + m * m) < r2)) --m;
      lo = max(-m, -tx0);
      const int hi = min(TQ - 1 + m, W - 1 - tx0);
      cnt = max(hi - lo + 1, 0);
    }
    rowt[i] = make_int4(0, oy, lo, cnt);
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0, start = 0;
    for (int i = 0; i < nwin; ++i) {
      int4 e = rowt[i];
      if (e.w > 0) {
        e.x = start;
        start += e.w;
        rowt[n++] = e;
      }
    }
    counts[0] = n;
    counts[1] = start;
  }
  __syncthreads();
  const int nrows = counts[0], nsc = counts[1];

  // ---- the query tile, resident (streamed: a slice a step, with the keys);
  // cells past the frame load zeros (their threshold is +inf, so they never
  // insert, and they are never written); channels past C are zero, so the
  // last step adds exact zeros. Then the lists.
  const float* qf = feats + (size_t)t_query * HW * C;
  if (!STREAM_Q) {
    for (int i = tid; i < NQ * (CQ / 4); i += NT) {
      const int q = i / (CQ / 4), c4 = i % (CQ / 4);
      const int y = ty0 + q / TQ, x = tx0 + q % TQ;
      const bool ok = y < H && x < W && c4 < C4;
      cp_async16(q_s + q * CQ + 4 * c4,
                 ok ? qf + ((size_t)y * W + x) * C + 4 * c4 : feats, ok);
    }
  }
  for (int i = tid; i < NQ * topk; i += NT) {
    const int q = i / topk, j = i % topk;
    const bool dead = ty0 + q / TQ >= H || tx0 + q % TQ >= W;
    lv[i] = (dead && j == topk - 1) ? CUDART_INF_F : -CUDART_INF_F;
    li[i] = 0x7fffffff;
  }

  // the candidate list: n_long whole frames, then L - n_long unions
  const int n_longc = n_long * HW;
  const int total = n_longc + (L - n_long) * nsc;
  const int nchunks = (total + KC - 1) / KC;
  const int steps_a_chunk = CQ / CS;
  const int nsteps = nchunks * steps_a_chunk;

  // this thread's key of the chunk being copied: its cell (-1: none), slot
  // and tile offset
  int my_cell = -1, my_slot = 0, my_off = 0;
  auto locate = [&](int chunk) {
    const int w = chunk * KC + tid;
    my_cell = -1;
    my_slot = 0;
    my_off = 0;
    if (w < n_longc) {
      my_slot = w / HW;
      my_cell = w - my_slot * HW;
    } else if (w < total) {
      const int w2 = w - n_longc;
      my_slot = n_long + w2 / nsc;
      const int j = w2 - (my_slot - n_long) * nsc;
      int lo = 0, hi = nrows - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (rowt[mid].x <= j) lo = mid; else hi = mid - 1;
      }
      const int4 e = rowt[lo];
      const int oy = e.y, ox = e.z + (j - e.x);
      my_cell = (ty0 + oy) * W + tx0 + ox;
      my_off = (int)(((unsigned)oy << 16) | ((unsigned)ox & 0xffffu));
    }
    const int p = chunk & 1;
    kcell[p * KC + tid] = my_cell;
    koff[p * KC + tid] = my_off;
    kslot[p * KC + tid] = my_slot;
  };
  // step s's copies into stage s & 1: this thread's key, CS channels,
  // 16-byte chunk c4 of row tid at c4 ^ (tid & 7); streamed, also the
  // queries' CS channels (two 16-byte chunks a thread)
  auto issue = [&](int s) {
    const int chunk = s / steps_a_chunk, c0 = (s % steps_a_chunk) * CS;
    if (c0 == 0) locate(chunk);
    const float* src = feats + ((size_t)ctx[my_slot] * HW
                                + (my_cell < 0 ? 0 : my_cell)) * C + c0;
    float* dst = k_s + ((s & 1) * KC + tid) * CS;
#pragma unroll
    for (int c4 = 0; c4 < CS / 4; ++c4) {
      const bool ok = my_cell >= 0 && c0 / 4 + c4 < C4;
      cp_async16(dst + 4 * (c4 ^ (tid & 7)), ok ? src + 4 * c4 : feats, ok);
    }
    if (STREAM_Q) {
      static_assert(NQ * (CS / 4) % NT == 0, "query chunks a thread");
#pragma unroll
      for (int r = 0; r < NQ * (CS / 4) / NT; ++r) {
        const int i = tid + r * NT;
        const int q = i / (CS / 4), c4 = i % (CS / 4);
        const int y = ty0 + q / TQ, x = tx0 + q % TQ;
        const bool ok = y < H && x < W && c0 / 4 + c4 < C4;
        cp_async16(q_s + ((s & 1) * NQ + q) * CS + 4 * c4,
                   ok ? qf + ((size_t)y * W + x) * C + c0 + 4 * c4 : feats,
                   ok);
      }
    }
    cp_async_commit();
  };

  const int q0 = warp * 8;              // this warp's queries q0 .. q0+7
  float acc[8][8];
  if (nsteps > 0) issue(0);
  else cp_async_commit();
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait_all();
    __syncthreads();   // step s landed; the other stage is free
    if (s + 1 < nsteps) issue(s + 1);
    const int chunk = s / steps_a_chunk, cs = s % steps_a_chunk;
    if (cs == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    // ---- CS channels of 8 queries x 8 keys, f32 FMAs in channel order
    const float* ks = k_s + ((s & 1) * KC + lane) * CS;
    const float* qs = q_s + (STREAM_Q ? ((s & 1) * NQ + q0) * CS
                                      : q0 * CQ + cs * CS);
#pragma unroll
    for (int c4 = 0; c4 < CS / 4; ++c4) {
      float4 qv[8], kv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        qv[i] = reinterpret_cast<const float4*>(qs + i * QS)[c4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        kv[j] = reinterpret_cast<const float4*>(ks + j * 32 * CS)[c4 ^ (lane & 7)];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float a = acc[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          acc[i][j] = a;
        }
    }
    if (cs != steps_a_chunk - 1) continue;

    // ---- the chunk's scores: hits above their query's k-th value
    const int p = chunk & 1;
    float thr[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) thr[i] = lv[(q0 + i) * topk + topk - 1];
    unsigned long long hits = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kk = lane + 32 * j;
      const int cell = kcell[p * KC + kk];
      const bool is_short = kslot[p * KC + kk] >= n_long;
      const int off = koff[p * KC + kk];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int q = q0 + i;
        bool ok = cell >= 0;
        if (ok && is_short) {
          const int dy = (off >> 16) - q / TQ;
          const int dx = (int)(short)(off & 0xffff) - q % TQ;
          ok = (float)(dy * dy + dx * dx) < r2;
        }
        const float sc = acc[i][j] * inv_t;
        acc[i][j] = sc;
        if (ok && sc > thr[i]) hits |= 1ull << (i * 8 + j);
      }
    }
    // ---- inserted: each lane with a hit, in turn, stages its 8 x 8 scores
    // (-inf where none) and lanes 0-7 insert them into their query's list
    unsigned who = __ballot_sync(0xffffffffu, hits != 0);
    float* sw = scratch + warp * 64;
    while (who) {
      const int r = __ffs(who) - 1;
      who &= who - 1;
      if (lane == r) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            sw[i * 8 + j] = (hits >> (i * 8 + j) & 1ull) ? acc[i][j]
                                                          : -CUDART_INF_F;
      }
      __syncwarp();
      if (lane < 8) {
        const int q = q0 + lane;
        float* v = lv + q * topk;
        int* ix = li + q * topk;
        for (int j = 0; j < 8; ++j) {
          const float sc = sw[lane * 8 + j];
          if (!(sc > -CUDART_INF_F)) continue;
          const int kk = r + 32 * j;
          const int id = kslot[p * KC + kk] * HW + kcell[p * KC + kk];
          if (!above(sc, id, v[topk - 1], ix[topk - 1])) continue;
          int pos = topk - 1;
          while (pos > 0 && above(sc, id, v[pos - 1], ix[pos - 1])) {
            v[pos] = v[pos - 1];
            ix[pos] = ix[pos - 1];
            --pos;
          }
          v[pos] = sc;
          ix[pos] = id;
        }
      }
      __syncwarp();
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // ---- softmax over the kept k and the label mix; 4 threads per query
  // split the label channels
  const int q = tid % NQ;
  const int y = ty0 + q / TQ, x = tx0 + q % TQ;
  if (y >= H || x >= W) return;
  const float m = lv[q * topk];
  for (int c = tid / NQ; c < NL; c += NT / NQ) {
    float z = 0.f, s = 0.f;
    if (m > -CUDART_INF_F) {
      for (int j = 0; j < topk; ++j) {
        const float v = lv[q * topk + j];
        if (!(v > -CUDART_INF_F)) break;
        const float e = expf(v - m);
        const int id = li[q * topk + j];
        const int fl = id / HW;
        z += e;
        s = fmaf(e, labels[((size_t)ctx[fl] * HW + (id - fl * HW)) * NL + c], s);
      }
    }
    out[((size_t)(y - row0 * TQ) * W + x) * NL + c] = z > 0.f ? s / z : 0.f;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs, in bytes, at C channels, k kept
// and a short-frame halo rr (the streamed form's where the resident query
// tile does not fit).
size_t prop_sparse_smem_bytes(int C, int topk, int rr) {
  return smem_bytes(C, topk, rr);
}

// Launches the kernel for tile rows row0 .. row0+n_rows-1 of one target
// frame on `stream` (the whole frame: 0 and ceil(H / 8)); out holds those
// rows' cells, (min(H, 8 (row0 + n_rows)) - 8 row0) x W of them. Returns the
// cudaError_t of the launch (0 on success).
int prop_sparse_launch(const float* feats, const float* labels, const int* ctx,
                       float* out, int H, int W, int C, int NL, int L,
                       int n_long, int t_query, int topk, float inv_t, float r2,
                       int rr, int row0, int n_rows, void* stream) {
  const size_t smem = smem_bytes(C, topk, rr);
  const int tile_rows = (H + TQ - 1) / TQ;
  if (smem > SMEM_OPTIN || row0 < 0 || n_rows < 1 || row0 + n_rows > tile_rows)
    return (int)cudaErrorInvalidValue;
  auto kernel = streams_query(C, topk, rr) ? prop_sparse_kernel<true>
                                           : prop_sparse_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TQ - 1) / TQ, n_rows);
  kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      feats, labels, ctx, out, H, W, C, NL, L, n_long, t_query, topk, inv_t,
      r2, rr, row0);
  return (int)cudaGetLastError();
}

}  // extern "C"
