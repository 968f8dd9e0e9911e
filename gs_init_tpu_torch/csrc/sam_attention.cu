// The SAM mask decoder's attention core (K8), hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's DecoderAttention
// (gs_init_tpu/models/sam.py) is plain XLA, which fuses it. The port called
// F.scaled_dot_product_attention, whose memory-efficient kernel spent ~5.3 ms
// a 64-prompt decoder batch on the decoder's shapes, ~13x their byte bound:
// seven queries fill one mostly empty 64-row tile while each (batch, head)
// walks 4,096 keys alone; 4,096 queries meet seven keys padded to a 64-key
// tile; head width 16 runs in a 64-wide layout.
//
// Computes, for q [B, Nq, H * hd], k and v [B, Nk, H * hd] (contiguous: the
// projections' own layout) and each batch entry and head h,
// out[b, :, h] = softmax((q_h / sqrt(hd)) k_h^T) v_h, written as
// [B, Nq, H * hd], in float32 (no TF32), as
// models/sam.py::decoder_attention_plain does. The heads' split and merge are
// index arithmetic: lane l of a warp owns the float4 columns l + 32 r of a row
// (r < D / 128, D = H * hd), so a warp reads and writes whole 512-byte rows
// with 16-byte accesses, and the hd / 4 lanes of one head combine their
// partial dot products by shuffles.
//
// Two paths, chosen from the shapes:
// - few keys (Nk <= 64: image-to-token, 4,096 queries against 7 tokens, and
//   the 7 x 7 self-attention): a block stages its batch entry's keys and
//   values in shared memory, and each warp copies them to registers, KC at a
//   time (the decoder's seven keys are one chunk). Each warp streams its
//   query rows through a ring of shared memory (cp.async) and computes, in
//   registers, a row's scores, their max, the exponentials, their sum and
//   the weighted values (with an online rescale between chunks where
//   Nk > KC).
// - few queries (Nq <= 64 < Nk: token-to-image, 7 queries against 4,096 image
//   tokens): a block takes a slice of FQ_SLICE keys and up to FQ_QB queries;
//   each of its warps streams FQ_WARP_KEYS keys through its own ring of
//   shared memory (cp.async), hd / 4 keys a stage, and keeps an online
//   softmax (max, sum, weighted values) per query and head; the block merges
//   its warps' in a fixed order into one partial a slice. A second kernel, in
//   the same call, merges the slices in a fixed order and normalises. No
//   atomics: the result is the same to the bit from run to run.
// In both, the hd / 4 lanes of a head reduce-scatter their partial dot
// products with hd / 4 keys (hd / 4 - 1 shuffles), so that each lane holds
// one key's score and takes one exponential, and pass the weights on by
// shuffles: the first design summed every score on every lane and took each
// exponential hd / 4 times over, ~1.9x the byte bound where this runs at
// ~1.3x.
//
// Bound on this card: bytes. At the decoder's shapes (B 64, 4,096 image
// tokens, 7 tokens, 8 heads of 16) a token-to-image call reads k and v and an
// image-to-token call reads q and writes out: 2 x 134 MB, 0.080 ms at 3.35
// TB/s, against 0.94 GFLOP (4 D FLOP a query-key pair), 0.014 ms at 67
// TFLOP/s. Both paths read every input byte once from device memory and
// write every output byte once; the few-queries partials add ~4 MB.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "smem.cuh"

namespace {

constexpr int MAX_SHORT = 64;  // the short side's largest token count

// Few keys: blocks of 4 warps, 128 query rows a block; each warp's ring
// holds 4 stages of 4 rows (at D = 128).
constexpr int FK_THREADS = 128;
constexpr int FK_WARPS = FK_THREADS / 32;
constexpr int FK_ROWS = 128;
constexpr int FK_U = 4;
constexpr int FK_STAGES = 4;
// Few queries: blocks of 4 warps, 64 keys a warp, a 12 KB ring a warp; 7
// queries a block at head 16: the decoder's 5 tokens and 2 prompt points in
// one block.
constexpr int FQ_WARPS = 4;
constexpr int FQ_THREADS = FQ_WARPS * 32;
constexpr int FQ_WARP_KEYS = 64;
constexpr int FQ_SLICE = FQ_WARPS * FQ_WARP_KEYS;  // keys a block: one partial
constexpr int FQ_RING_BYTES = 12288;
constexpr int FQ_QB = 7;
constexpr unsigned FULL = 0xffffffffu;

// q / sqrt(hd), as the JAX package scales it: sqrt(16) and sqrt(32) rounded
// to float.
template <int HD>
constexpr float kScale = HD == 16 ? 4.0f : 5.65685424949238019520f;

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

template <int HD>
__device__ __forceinline__ float4 scaled(const float4 a) {
  constexpr float s = kScale<HD>;
  return make_float4(a.x / s, a.y / s, a.z / s, a.w / s);
}

__device__ __forceinline__ float4 mul4(const float4 a, const float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

// acc + p v
__device__ __forceinline__ float4 fma4(const float p, const float4 v, const float4 acc) {
  return make_float4(fmaf(p, v.x, acc.x), fmaf(p, v.y, acc.y), fmaf(p, v.z, acc.z), fmaf(p, v.w, acc.w));
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}

// Over the CH lanes of one head (aligned groups of a warp), every lane
// getting the result. All 32 lanes must call these.
template <int CH>
__device__ __forceinline__ float head_sum(float x) {
#pragma unroll
  for (int o = 1; o < CH; o <<= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

template <int CH>
__device__ __forceinline__ float head_max(float x) {
#pragma unroll
  for (int o = 1; o < CH; o <<= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

// x[j]: this lane's partial dot products with CH keys; returns the whole
// dot product (over the head's CH lanes) of key lane % CH. CH - 1 shuffles
// for CH keys, where a sum on every lane would take CH log2(CH).
template <int CH>
__device__ __forceinline__ float reduce_scatter(float (&x)[CH], const int lane) {
#pragma unroll
  for (int o = CH / 2; o >= 1; o >>= 1) {
    const bool upper = lane & o;
#pragma unroll
    for (int j = 0; j < o; ++j) {
      const float send = upper ? x[j] : x[j + o];
      const float keep = upper ? x[j + o] : x[j];
      x[j] = keep + __shfl_xor_sync(FULL, send, o);
    }
  }
  return x[0];
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ------------------------------------------------------------------ few keys

constexpr int FK_STAGE = FK_U * 32;  // float4 a stage of a warp's ring: FK_U rows at D = 128

// grid (ceil(Nq / FK_ROWS), B); dynamic shared memory: k and v [Nk][D4],
// then each warp's ring of FK_STAGES stages of U query rows.
template <int HD>
__global__ void __launch_bounds__(FK_THREADS, 4)
    few_keys_kernel(const float4* __restrict__ q, const float4* __restrict__ k, const float4* __restrict__ v,
                    float4* __restrict__ out, int nq, int nk) {
  constexpr int CH = HD / 4;               // lanes a head
  constexpr int R = HD / 16;               // float4 columns a lane: D = 8 HD = 128 R
  constexpr int D4 = 32 * R;               // float4 a row
  constexpr int KC = 8 / R;                // keys a chunk in registers
  constexpr int G = (KC + CH - 1) / CH;    // reduce-scatter groups a chunk
  constexpr int U = FK_U / R;              // rows a stage
  constexpr int STAGE = FK_STAGE;
  constexpr int STEP = FK_WARPS * U;
  extern __shared__ float4 fk_smem[];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane % CH;
  const int b = blockIdx.y;
  float4* ks = fk_smem;
  float4* vs = ks + nk * D4;
  float4* ring = vs + nk * D4 + warp * FK_STAGES * STAGE;

  // This warp's rows: first + t STEP + u, for groups t. Each lane copies and
  // later reads only its own columns, so the ring needs no barrier.
  const int row_end = min(nq, (blockIdx.x + 1) * FK_ROWS);
  const int first = blockIdx.x * FK_ROWS + warp * U;
  const int groups = first < row_end ? (row_end - first + STEP - 1) / STEP : 0;
  const long long q0 = static_cast<long long>(b) * nq * D4;
  auto issue = [&](const int t) {
    if (t < groups) {
      float4* dst = ring + (t % FK_STAGES) * STAGE;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int row = first + t * STEP + u;
        if (row < row_end) {
#pragma unroll
          for (int r = 0; r < R; ++r)
            cp_async16(dst + u * D4 + lane + 32 * r, q + q0 + static_cast<long long>(row) * D4 + lane + 32 * r);
        }
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int t = 0; t < FK_STAGES - 1; ++t) issue(t);

  const long long kv0 = static_cast<long long>(b) * nk * D4;
  for (int t = threadIdx.x; t < nk * D4; t += FK_THREADS) {
    ks[t] = k[kv0 + t];
    vs[t] = v[kv0 + t];
  }
  __syncthreads();

  // Keys past Nk are zeros: their scores are set to -inf, their weights 0.
  float4 kr[KC][R], vr[KC][R];
  auto load_chunk = [&](const int c0) {
#pragma unroll
    for (int j = 0; j < KC; ++j) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        kr[j][r] = c0 + j < nk ? ks[(c0 + j) * D4 + lane + 32 * r] : zero4();
        vr[j][r] = c0 + j < nk ? vs[(c0 + j) * D4 + lane + 32 * r] : zero4();
      }
    }
  };
  const bool resident = nk <= KC;
  if (resident) load_chunk(0);

  for (int t = 0; t < groups; ++t) {
    issue(t + FK_STAGES - 1);
    cp_async_wait<FK_STAGES - 1>();  // group t's rows have landed
    const float4* cur = ring + (t % FK_STAGES) * STAGE;
    const int row0 = first + t * STEP;
    // Rows past the block's are zeros: computed alongside, never written.
    float4 qr[U][R], acc[U][R];
    float m[U][R], l[U][R];  // l: this lane's share of the sum
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        qr[u][r] = row0 + u < row_end ? scaled<HD>(cur[u * D4 + lane + 32 * r]) : zero4();
        acc[u][r] = zero4();
        m[u][r] = -CUDART_INF_F;
        l[u][r] = 0.f;
      }
    }
    for (int c0 = 0; c0 < nk; c0 += KC) {
      if (!resident) load_chunk(c0);
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float s[G];
          float cm = -CUDART_INF_F;
#pragma unroll
          for (int gi = 0; gi < G; ++gi) {
            float x[CH];
#pragma unroll
            for (int j = 0; j < CH; ++j) x[j] = gi * CH + j < KC ? dot4(qr[u][r], kr[gi * CH + j][r]) : 0.f;
            s[gi] = reduce_scatter<CH>(x, lane);
            if (gi * CH + g >= KC || c0 + gi * CH + g >= nk) s[gi] = -CUDART_INF_F;
            cm = fmaxf(cm, s[gi]);
          }
          const float mn = fmaxf(m[u][r], head_max<CH>(cm));
          const float corr = expf(m[u][r] - mn);  // 0 at the first chunk
          float li = l[u][r] * corr;
          float4 ai = mul4(acc[u][r], corr);
#pragma unroll
          for (int gi = 0; gi < G; ++gi) {
            const float p = expf(s[gi] - mn);
            li += p;
#pragma unroll
            for (int j = 0; j < CH; ++j) {
              if (gi * CH + j < KC) ai = fma4(__shfl_sync(FULL, p, j, CH), vr[gi * CH + j][r], ai);
            }
          }
          m[u][r] = mn;
          l[u][r] = li;
          acc[u][r] = ai;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float total = head_sum<CH>(l[u][r]);
        if (row0 + u < row_end)
          out[q0 + static_cast<long long>(row0 + u) * D4 + lane + 32 * r] = mul4(acc[u][r], 1.f / total);
      }
    }
  }
  cp_async_wait<0>();
}

// --------------------------------------------------------------- few queries

template <int HD>
__host__ __device__ constexpr int fq_stage() {  // float4 a stage of a warp's ring: HD / 4 keys, k and v
  return 2 * (HD / 4) * 2 * HD;
}

template <int HD>
__host__ __device__ constexpr int fq_stages() {
  return FQ_RING_BYTES / (fq_stage<HD>() * 16) > 2 ? FQ_RING_BYTES / (fq_stage<HD>() * 16) : 2;
}

// Queries a block: FQ_QB at head 16, 2 at head 32, whose rows and stages are
// four times as wide (the registers hold them all).
template <int HD>
__host__ __device__ constexpr int fq_queries() {
  return HD == 16 ? FQ_QB : 2;
}

// A slice's partial: acc [B, S, Nq, D4] float4, then (max, sum) [B, S, Nq, H]
// float2.
// grid (S, B, ceil(Nq / QB)); dynamic shared memory: each warp's ring.
template <int HD>
__global__ void __launch_bounds__(FQ_THREADS, 4)
    few_queries_kernel(const float4* __restrict__ q, const float4* __restrict__ k, const float4* __restrict__ v,
                       float4* __restrict__ part_acc, float2* __restrict__ part_ml, int nq, int nk, int heads,
                       int slices) {
  constexpr int CH = HD / 4;
  constexpr int R = HD / 16;
  constexpr int D4 = 32 * R;
  constexpr int C = CH;  // keys a stage: one reduce-scatter
  constexpr int QB = fq_queries<HD>();
  constexpr int STAGE = fq_stage<HD>();
  constexpr int STAGES = fq_stages<HD>();
  extern __shared__ float4 fq_smem[];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane % CH;
  const int b = blockIdx.y, slice = blockIdx.x, i0 = blockIdx.z * QB;
  const int nqb = min(QB, nq - i0);

  // This warp's keys, and its ring: stage t holds keys key0 + t C + j, k at
  // [j], v at [C + j]. Each lane copies and later reads only its own columns,
  // so the ring needs no barrier.
  const int key0 = slice * FQ_SLICE + warp * FQ_WARP_KEYS;
  const int key1 = min(nk, key0 + FQ_WARP_KEYS);
  const int stages = key1 > key0 ? (key1 - key0 + C - 1) / C : 0;
  float4* ring = fq_smem + warp * STAGES * STAGE;
  const long long kv0 = static_cast<long long>(b) * nk * D4;
  auto issue = [&](const int t) {
    if (t < stages) {
      float4* dst = ring + (t % STAGES) * STAGE;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const int key = key0 + t * C + j;
        if (key < key1) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const long long src = kv0 + static_cast<long long>(key) * D4 + lane + 32 * r;
            cp_async16(dst + j * D4 + lane + 32 * r, k + src);
            cp_async16(dst + (C + j) * D4 + lane + 32 * r, v + src);
          }
        }
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) issue(t);

  // Queries past Nq are zeros: computed alongside and never written.
  float4 qr[QB][R], acc[QB][R];
  float m[QB][R], l[QB][R];  // l: this lane's share of the sum
#pragma unroll
  for (int i = 0; i < QB; ++i) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      qr[i][r] = i < nqb ? scaled<HD>(q[(static_cast<long long>(b) * nq + i0 + i) * D4 + lane + 32 * r]) : zero4();
      acc[i][r] = zero4();
      m[i][r] = -CUDART_INF_F;
      l[i][r] = 0.f;
    }
  }

  for (int t = 0; t < stages; ++t) {
    issue(t + STAGES - 1);
    cp_async_wait<STAGES - 1>();  // stage t's copies have landed
    const float4* cur = ring + (t % STAGES) * STAGE;
    const bool valid = key0 + t * C + g < key1;  // this lane's key of the stage
#pragma unroll
    for (int r = 0; r < R; ++r) {
      // Keys past the warp's are zeros: score -inf, weight 0.
      float4 kc[C], vc[C];
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const bool in = key0 + t * C + j < key1;
        kc[j] = in ? cur[j * D4 + lane + 32 * r] : zero4();
        vc[j] = in ? cur[(C + j) * D4 + lane + 32 * r] : zero4();
      }
#pragma unroll
      for (int i = 0; i < QB; ++i) {
        float x[C];
#pragma unroll
        for (int j = 0; j < C; ++j) x[j] = dot4(qr[i][r], kc[j]);
        float s = reduce_scatter<CH>(x, lane);
        if (!valid) s = -CUDART_INF_F;
        const float mn = fmaxf(m[i][r], head_max<CH>(s));
        const float corr = expf(m[i][r] - mn);  // 0 at the first stage
        const float p = expf(s - mn);
        float4 ai = mul4(acc[i][r], corr);
#pragma unroll
        for (int j = 0; j < C; ++j) ai = fma4(__shfl_sync(FULL, p, j, CH), vc[j], ai);
        l[i][r] = l[i][r] * corr + p;
        m[i][r] = mn;
        acc[i][r] = ai;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // The block's warps merged in order 0, 1, ...: each lane leaves its state
  // in shared memory (the rings' space), then a thread a (query, column).
  float4* w_acc = fq_smem;                                                 // [FQ_WARPS][QB][D4]
  float2* w_ml = reinterpret_cast<float2*>(fq_smem + FQ_WARPS * QB * D4);  // [FQ_WARPS][QB][D4]
#pragma unroll
  for (int i = 0; i < QB; ++i) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int at = (warp * QB + i) * D4 + lane + 32 * r;
      w_acc[at] = acc[i][r];
      w_ml[at] = make_float2(m[i][r], head_sum<CH>(l[i][r]));
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < nqb * D4; t += FQ_THREADS) {
    const int i = t / D4, c = t % D4;
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < FQ_WARPS; ++w) mx = fmaxf(mx, w_ml[(w * QB + i) * D4 + c].x);
    float sum = 0.f;
    float4 a = zero4();
#pragma unroll
    for (int w = 0; w < FQ_WARPS; ++w) {
      const float2 ml = w_ml[(w * QB + i) * D4 + c];
      const float e = expf(ml.x - mx);  // 0 for a warp past Nk
      sum += ml.y * e;
      a = fma4(e, w_acc[(w * QB + i) * D4 + c], a);
    }
    const long long row = (static_cast<long long>(b) * slices + slice) * nq + i0 + i;
    part_acc[row * D4 + c] = a;
    if (c % CH == 0) part_ml[row * heads + c / CH] = make_float2(mx, sum);
  }
}

// grid (Nq, B), D4 threads: the slices of each query and column merged in
// order 0, 1, ..., then normalised.
template <int HD>
__global__ void __launch_bounds__(2 * HD) merge_kernel(const float4* __restrict__ part_acc,
                                                       const float2* __restrict__ part_ml, float4* __restrict__ out,
                                                       int nq, int heads, int slices) {
  constexpr int CH = HD / 4;
  constexpr int R = HD / 16;
  constexpr int D4 = 32 * R;
  const int i = blockIdx.x, b = blockIdx.y, c = threadIdx.x, h = c / CH;
  const long long row0 = static_cast<long long>(b) * slices * nq + i;  // + s nq
  float mx = -CUDART_INF_F;
#pragma unroll 8
  for (int s = 0; s < slices; ++s) mx = fmaxf(mx, part_ml[(row0 + static_cast<long long>(s) * nq) * heads + h].x);
  float sum = 0.f;
  float4 a = zero4();
#pragma unroll 8
  for (int s = 0; s < slices; ++s) {
    const long long row = row0 + static_cast<long long>(s) * nq;
    const float2 ml = part_ml[row * heads + h];
    const float e = expf(ml.x - mx);
    sum += ml.y * e;
    a = fma4(e, part_acc[row * D4 + c], a);
  }
  out[(static_cast<long long>(b) * nq + i) * D4 + c] = mul4(a, 1.f / sum);
}

// The shapes K8 takes: 8 heads of 16 or of 32; nk <= MAX_SHORT (few keys)
// or nq <= MAX_SHORT < nk (few queries).
bool takes(int b, int nq, int nk, int heads, int head) {
  return b > 0 && b <= 65535 && nq > 0 && nk > 0 && heads == 8 && (head == 16 || head == 32) &&
         (nk <= MAX_SHORT || nq <= MAX_SHORT);
}

// Key slices of the few-queries path (0 on the few-keys path): one partial
// each.
int slices_of(int nq, int nk) { return nk <= MAX_SHORT ? 0 : (nk + FQ_SLICE - 1) / FQ_SLICE; }

template <int HD>
int launch(const float4* q, const float4* k, const float4* v, float4* out, void* part, int b, int nq, int nk,
           int heads, cudaStream_t stream) {
  constexpr int R = HD / 16;
  constexpr int D4 = 32 * R;
  if (nk <= MAX_SHORT) {
    const size_t smem = (2 * static_cast<size_t>(nk) * D4 + FK_WARPS * FK_STAGES * FK_STAGE) * sizeof(float4);
    const cudaError_t e = gs::allow_smem<few_keys_kernel<HD>>(smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid((nq + FK_ROWS - 1) / FK_ROWS, b);
    few_keys_kernel<HD><<<grid, FK_THREADS, smem, stream>>>(q, k, v, out, nq, nk);
    return static_cast<int>(cudaGetLastError());
  }
  if (part == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int slices = slices_of(nq, nk);
  constexpr int QB = fq_queries<HD>();
  constexpr size_t smem = static_cast<size_t>(FQ_WARPS) * fq_stages<HD>() * fq_stage<HD>() * sizeof(float4);
  static_assert(FQ_WARPS * QB * D4 * (sizeof(float4) + sizeof(float2)) <= smem, "the merge fits the rings");
  cudaError_t err = gs::allow_smem<few_queries_kernel<HD>>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  float4* part_acc = static_cast<float4*>(part);
  float2* part_ml = reinterpret_cast<float2*>(part_acc + static_cast<size_t>(b) * slices * nq * D4);
  const dim3 grid(slices, b, (nq + QB - 1) / QB);
  few_queries_kernel<HD><<<grid, FQ_THREADS, smem, stream>>>(q, k, v, part_acc, part_ml, nq, nk, heads, slices);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<HD><<<dim3(nq, b), D4, 0, stream>>>(part_acc, part_ml, out, nq, heads, slices);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The bytes of the few-queries path's partials (acc, then max and sum, for
// each batch entry, key slice and query) that sam_attention's `part` must
// hold for these shapes: 0 on the few-keys path, -1 for shapes K8 does not
// take.
extern "C" long long sam_attention_workspace(int b, int nq, int nk, int heads, int head) {
  if (!takes(b, nq, nk, heads, head)) return -1;
  return static_cast<long long>(b) * slices_of(nq, nk) * nq * (heads * head + 2 * heads) * sizeof(float);
}

// q [b, nq, 8 * head], k and v [b, nk, 8 * head], out [b, nq, 8 * head],
// float32, contiguous, 16-byte aligned; 8 heads of 16 (the cross-attentions,
// width 128) or of 32 (the self-attention, width 256); nk <= 64 (few keys:
// one kernel) or nq <= 64 < nk (few queries: the slices' kernel, then the
// merge; part holds sam_attention_workspace's bytes). Anything else:
// cudaErrorInvalidValue, nothing launched.
extern "C" int sam_attention(const void* q, const void* k, const void* v, void* out, void* part, int b, int nq,
                             int nk, int heads, int head, void* stream) {
  if (!takes(b, nq, nk, heads, head)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* q4 = static_cast<const float4*>(q);
  const auto* k4 = static_cast<const float4*>(k);
  const auto* v4 = static_cast<const float4*>(v);
  auto* o4 = static_cast<float4*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return head == 16 ? launch<16>(q4, k4, v4, o4, part, b, nq, nk, heads, s)
                    : launch<32>(q4, k4, v4, o4, part, b, nq, nk, heads, s);
}

extern "C" const char* gs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
