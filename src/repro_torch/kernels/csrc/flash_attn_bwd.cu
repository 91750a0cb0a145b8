// Blockwise GQA flash attention, backward, f32, on the CUDA cores.
//
// flash_attention_bwd_launch computes, for f32 inputs, the gradient of
// B8's forward (the f32 kernel of flash_attn.cu), which replaces the
// gradient of the Pallas TPU kernel src/repro/kernels/flash_attn.py:66
// flash_attention: that kernel had no backward, JAX differentiates the jnp
// scan of src/repro/models/layers.py:attention_flash.  bf16 inputs take
// the tensor-core kernel of flash_attn_bwd_sm90.cu.  From the saved q, k,
// v, out and lse (natural log) and the incoming dout it computes, in f32
// and with positions 0 .. S-1 on both sides,
//     D  = rowsum(dO * O)                  (a small first launch)
//     P  = exp(S * scale - lse),  S = Q K^T
//     dV = P^T dO,   dS = P * (dO V^T - D)
//     dQ = dS K * scale,   dK = dS^T Q * scale
// and writes dq, dk, dv contiguous in f32.
//
// What bounds it: 10 hd operations per visible (row, key) pair (five
// products), 8.06e10 at the LM path's shape (smollm-360m, B = 4, S = 2048,
// 15 heads over 5 KV heads, hd = 64, causal): 1.20 ms at the card's 67
// TFLOP/s of f32 outside the tensor cores, against 0.06 ms for its bytes.
// Operations bound it; f32 keeps full precision, so no tensor-core type
// applies, and the products run as f32 FMA.
//
// Design: two launches after the D pass, deterministic, no atomics.
//   (a) dK/dV: a block per (b, kv, 64 keys); its four warps own 16 keys
//       each and loop over the flattened (position, head) row tiles from
//       the diagonal on (under causal a key tile meets only the rows at or
//       past its first key), so dK and dV sum over all G heads in
//       registers.  It computes S^T = K Q^T and dP^T = V dO^T, so P^T and
//       dS^T come out keys x rows, and go through a per-warp f32 scratch
//       in shared memory as the left operand of dV += P^T dO and dK +=
//       dS^T Q.
//   (b) dQ: a block per (b, kv, 64 rows); its warps own 16 rows each and
//       loop over the key tiles up to the block's last position, again
//       recomputing P, then dQ += dS K.
// Each thread holds a 2 x 2 patch of every 8 columns of its warp's 16
// rows.  Row tiles stream through two shared-memory stages by cp.async,
// 16 bytes a thread (the wrapper hands over inputs with a unit innermost
// stride and 16-byte aligned rows).  Exponentials are exp2f of
// log2-scaled scores against lse * log2(e), as in the forward.
//
// The launcher runs on the caller's stream, allocates nothing (the caller
// passes D's scratch) and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 64;   // keys a block of (a), keys a tile of (b)
constexpr int kQRows = 64;  // rows a block of (b)
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Cfg {
  static constexpr int LD = HD + 4;                // padded shared row
  static constexpr int BM = HD == 128 ? 32 : 64;   // rows a tile of (a)
  static constexpr int PLD = BM + 4;               // f32 scratch rows
  static constexpr int QPLD = kKeys + 4;
  static constexpr int SMEM_A =
      (2 * kKeys + 4 * BM) * LD * 4 + 4 * BM * 4 + kWarps * 16 * PLD * 4;
  static constexpr int SMEM_B =
      (2 * kQRows + 4 * kKeys) * LD * 4 + kWarps * 16 * QPLD * 4;
};

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* out;
  const float* dout;
  const float* lse;   // natural log, (B, KV, G, Sq)
  float* delta;       // D, (B, KV, G, Sq)
  float* dq;
  float* dk;
  float* dv;
  int B, Sq, Sk, KV, G, causal;
  float scale, scale2;  // 1 / sqrt(hd), log2(e) / sqrt(hd)
  // element strides (the innermost is 1): q and dout (b, s, kv, g); k and
  // v (b, s, kv)
  int64_t qb, qs, qk, qg, kb, ks, kk, vb, vs, vk;
  int64_t ob, os, ok, og;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// rows of a tile: row i starts at (*this)(i), or is zeros past the end
struct KeyRows {
  const float* p;
  int k0, Sk;
  int64_t ss;
  __device__ const float* operator()(int i) const {
    return k0 + i < Sk ? p + (k0 + i) * ss : nullptr;
  }
};
struct QRows {
  const float* p;
  int r0, n_rows;
  int64_t ss, sg;
  int G;
  __device__ const float* operator()(int i) const {
    const int r = r0 + i;
    return r < n_rows ? p + (r / G) * ss + (r % G) * sg : nullptr;
  }
};

template <int HD, typename Rows>
__device__ void load_tile(float* dst, int n, Rows rows) {
  constexpr int LD = Cfg<HD>::LD, V = 4, CH = HD / V;
  for (int e = threadIdx.x; e < n * CH; e += kThreads) {
    const int i = e / CH, c = e % CH;
    float* d = dst + i * LD + c * V;
    const float* s = rows(i);
    if (s != nullptr) cp_async16(d, s + c * V);
    else *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
}

// ---- warp products: acc (16 x N; element [n8][e] is row lane / 4 +
// 8 (e / 2), column 8 n8 + 2 (lane % 4) + e % 2)

// acc += A B: A (16 x K) row-major in shared memory, B stored [n][k]
template <int N, int K>
__device__ __forceinline__ void mma_nk(float (&acc)[N / 8][4], const float* sA,
                                       int lda, const float* sB, int ldb) {
  const int lane = threadIdx.x % 32;
  const int r = lane / 4, c = (lane % 4) * 2;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a0 = sA[r * lda + k], a1 = sA[(r + 8) * lda + k];
#pragma unroll
    for (int n8 = 0; n8 < N / 8; ++n8) {
      const float b0 = sB[(n8 * 8 + c) * ldb + k];
      const float b1 = sB[(n8 * 8 + c + 1) * ldb + k];
      acc[n8][0] = fmaf(a0, b0, acc[n8][0]);
      acc[n8][1] = fmaf(a0, b1, acc[n8][1]);
      acc[n8][2] = fmaf(a1, b0, acc[n8][2]);
      acc[n8][3] = fmaf(a1, b1, acc[n8][3]);
    }
  }
}

// the accumulator (16 x K) into a warp's f32 scratch
template <int K>
__device__ __forceinline__ void to_scratch(float* w, int ldw,
                                           const float (&c)[K / 8][4]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int n8 = 0; n8 < K / 8; ++n8)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w[(lane / 4 + (e / 2) * 8) * ldw + n8 * 8 + (lane % 4) * 2 + e % 2] =
          c[n8][e];
  __syncwarp();
}

// acc += A B: A (16 x K) in the scratch, B (K x N) stored [k][n]
template <int N, int K>
__device__ __forceinline__ void mma_kn(float (&acc)[N / 8][4], const float* w,
                                       int ldw, const float* sB, int ldb) {
  const int lane = threadIdx.x % 32;
  const int r = lane / 4, c = (lane % 4) * 2;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a0 = w[r * ldw + k], a1 = w[(r + 8) * ldw + k];
#pragma unroll
    for (int n8 = 0; n8 < N / 8; ++n8) {
      const float b0 = sB[k * ldb + n8 * 8 + c];
      const float b1 = sB[k * ldb + n8 * 8 + c + 1];
      acc[n8][0] = fmaf(a0, b0, acc[n8][0]);
      acc[n8][1] = fmaf(a0, b1, acc[n8][1]);
      acc[n8][2] = fmaf(a1, b0, acc[n8][2]);
      acc[n8][3] = fmaf(a1, b1, acc[n8][3]);
    }
  }
  __syncwarp();
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

__device__ __forceinline__ int64_t stat_index(const Args& a, int b, int h,
                                              int r) {
  return ((static_cast<int64_t>(b) * a.KV + h) * a.G + r % a.G) * a.Sq +
         r / a.G;
}

// ---- D = rowsum(dO * O): a warp per row (b, s, kv, g)
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const Args a) {
  const int64_t R = static_cast<int64_t>(blockIdx.x) * kWarps +
                    threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t n = static_cast<int64_t>(a.B) * a.Sq * a.KV * a.G;
  if (R >= n) return;
  const int g = static_cast<int>(R % a.G);
  const int h = static_cast<int>(R / a.G % a.KV);
  const int64_t s = R / a.G / a.KV % a.Sq;
  const int b = static_cast<int>(R / a.G / a.KV / a.Sq);
  const float* o = a.out + R * HD;
  const float* d = a.dout + b * a.ob + s * a.os + h * a.ok + g * a.og;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < HD; c += 32) acc = fmaf(d[c], o[c], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0)
    a.delta[((static_cast<int64_t>(b) * a.KV + h) * a.G + g) * a.Sq + s] =
        acc;
}

// ---- (a) dK, dV: a block per (b, kv, 64 keys)
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const Args a) {
  using C = Cfg<HD>;
  constexpr int LD = C::LD, BM = C::BM;
  extern __shared__ __align__(16) uint8_t smem[];
  float* sK = reinterpret_cast<float*>(smem);   // [kKeys][LD]
  float* sV = sK + kKeys * LD;                  // [kKeys][LD]
  float* sQ = sV + kKeys * LD;                  // [2][BM][LD]
  float* sO = sQ + 2 * BM * LD;                 // dO, [2][BM][LD]
  float* sL = sO + 2 * BM * LD;                 // [2][BM]
  float* sD = sL + 2 * BM;                      // [2][BM]
  float* sP = sD + 2 * BM;                      // [kWarps][16][PLD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // a 1-d grid, key tile slowest: under causal the first tiles meet the
  // most rows, and they start first
  const int bh = blockIdx.x % (a.B * a.KV);
  const int h = bh % a.KV, b = bh / a.KV;
  const int k0 = blockIdx.x / (a.B * a.KV) * kKeys;
  const int n_rows = a.Sq * a.G;       // < 2^31 (the wrapper checks)
  // under causal, the rows at or past position k0
  const int rstart = a.causal ? k0 * a.G / BM * BM : 0;
  const int n_tiles =
      rstart >= n_rows ? 0 : (n_rows - rstart + BM - 1) / BM;
  const float* q = a.q + b * a.qb + h * a.qk;
  const float* dout = a.dout + b * a.ob + h * a.ok;

  load_tile<HD>(sK, kKeys, KeyRows{a.k + b * a.kb + h * a.kk, k0, a.Sk,
                                   a.ks});
  load_tile<HD>(sV, kKeys, KeyRows{a.v + b * a.vb + h * a.vk, k0, a.Sk,
                                   a.vs});
  auto load_rows = [&](int i, int st) {
    const int r0 = rstart + i * BM;
    load_tile<HD>(sQ + st * BM * LD, BM,
                  QRows{q, r0, n_rows, a.qs, a.qg, a.G});
    load_tile<HD>(sO + st * BM * LD, BM,
                  QRows{dout, r0, n_rows, a.os, a.og, a.G});
    for (int e = threadIdx.x; e < BM; e += kThreads) {
      const int r = r0 + e;
      const bool in = r < n_rows;
      sL[st * BM + e] = in ? a.lse[stat_index(a, b, h, r)] * kLog2e : 0.f;
      sD[st * BM + e] = in ? a.delta[stat_index(a, b, h, r)] : 0.f;
    }
  };
  if (n_tiles > 0) load_rows(0, 0);
  cp_async_commit();

  float dk[HD / 8][4], dv[HD / 8][4];
  zero(dk);
  zero(dv);
  const int tA = k0 + warp * 16 + lane / 4;  // this thread's keys: tA, tA + 8
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i & 1;
    if (i + 1 < n_tiles) load_rows(i + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    const float* tQ = sQ + st * BM * LD;
    const float* tO = sO + st * BM * LD;
    const float* tL = sL + st * BM;
    const float* tD = sD + st * BM;
    const int r0 = static_cast<int>(rstart) + i * BM;
    // masks only where the tile crosses the diagonal or an end
    const bool edge = r0 + BM > n_rows || k0 + kKeys > a.Sk ||
                      (a.causal && (k0 + kKeys - 1) * a.G > r0);

    float s[BM / 8][4], dp[BM / 8][4];  // S^T and dP^T: keys x rows
    zero(s);
    zero(dp);
    mma_nk<BM, HD>(s, sK + warp * 16 * LD, LD, tQ, LD);
    mma_nk<BM, HD>(dp, sV + warp * 16 * LD, LD, tO, LD);
#pragma unroll
    for (int n8 = 0; n8 < BM / 8; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = n8 * 8 + (lane % 4) * 2 + e % 2;
        float p = exp2f(s[n8][e] * a.scale2 - tL[j]);
        if (edge) {
          // key t is seen by row r (position r / G) iff t G <= r
          const int t = tA + (e / 2) * 8, r = r0 + j;
          if (t >= a.Sk || r >= n_rows || (a.causal && t * a.G > r))
            p = 0.f;
        }
        s[n8][e] = p;
        dp[n8][e] = p * (dp[n8][e] - tD[j]);
      }
    float* w = sP + warp * 16 * C::PLD;
    to_scratch<BM>(w, C::PLD, s);
    mma_kn<HD, BM>(dv, w, C::PLD, tO, LD);
    to_scratch<BM>(w, C::PLD, dp);
    mma_kn<HD, BM>(dk, w, C::PLD, tQ, LD);
    __syncthreads();  // this stage is consumed
  }

#pragma unroll
  for (int n8 = 0; n8 < HD / 8; ++n8)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = tA + (e / 2) * 8;
      if (t >= a.Sk) continue;
      const int64_t idx =
          ((static_cast<int64_t>(b) * a.Sk + t) * a.KV + h) * HD + n8 * 8 +
          (lane % 4) * 2 + e % 2;
      a.dk[idx] = dk[n8][e] * a.scale;
      a.dv[idx] = dv[n8][e];
    }
}

// ---- (b) dQ: a block per (b, kv, 64 rows)
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const Args a) {
  using C = Cfg<HD>;
  constexpr int LD = C::LD;
  extern __shared__ __align__(16) uint8_t smem[];
  float* sQ = reinterpret_cast<float*>(smem);   // [kQRows][LD]
  float* sO = sQ + kQRows * LD;                 // dO, [kQRows][LD]
  float* sK = sO + kQRows * LD;                 // [2][kKeys][LD]
  float* sV = sK + 2 * kKeys * LD;              // [2][kKeys][LD]
  float* sP = sV + 2 * kKeys * LD;              // [kWarps][16][QPLD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x % (a.B * a.KV);
  const int h = bh % a.KV, b = bh / a.KV;
  const int n_rows = a.Sq * a.G;       // < 2^31 (the wrapper checks)
  // a 1-d grid, row tile slowest and the longest (latest) tiles first
  const int row0 =
      ((n_rows + kQRows - 1) / kQRows - 1 - blockIdx.x / (a.B * a.KV)) *
      kQRows;
  const int last = min(row0 + kQRows, n_rows) - 1;
  const int n_keys = a.causal ? min(a.Sk, last / a.G + 1) : a.Sk;
  const int n_tiles = (n_keys + kKeys - 1) / kKeys;
  const int first = row0 / a.G;        // the block's first position
  const float* kp = a.k + b * a.kb + h * a.kk;
  const float* vp = a.v + b * a.vb + h * a.vk;

  load_tile<HD>(sQ, kQRows, QRows{a.q + b * a.qb + h * a.qk, row0, n_rows,
                                  a.qs, a.qg, a.G});
  load_tile<HD>(sO, kQRows, QRows{a.dout + b * a.ob + h * a.ok, row0,
                                  n_rows, a.os, a.og, a.G});
  auto load_keys = [&](int j, int st) {
    load_tile<HD>(sK + st * kKeys * LD, kKeys,
                  KeyRows{kp, j * kKeys, a.Sk, a.ks});
    load_tile<HD>(sV + st * kKeys * LD, kKeys,
                  KeyRows{vp, j * kKeys, a.Sk, a.vs});
  };
  load_keys(0, 0);
  cp_async_commit();

  // this thread's rows rA and rA + 8, their log2-scaled lse and D
  const int rA = row0 + warp * 16 + lane / 4;
  const int rows[2] = {rA, rA + 8};
  float L[2], D[2];
  int pos[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const bool in = rows[x] < n_rows;
    L[x] = in ? a.lse[stat_index(a, b, h, rows[x])] * kLog2e : 0.f;
    D[x] = in ? a.delta[stat_index(a, b, h, rows[x])] : 0.f;
    pos[x] = rows[x] / a.G;
  }

  float dq[HD / 8][4];
  zero(dq);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) load_keys(j + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    const float* tK = sK + st * kKeys * LD;
    const float* tV = sV + st * kKeys * LD;
    float s[kKeys / 8][4], dp[kKeys / 8][4];
    zero(s);
    zero(dp);
    mma_nk<kKeys, HD>(s, sQ + warp * 16 * LD, LD, tK, LD);
    mma_nk<kKeys, HD>(dp, sO + warp * 16 * LD, LD, tV, LD);
    const bool edge = (j + 1) * kKeys > a.Sk ||
                      (a.causal && (j + 1) * kKeys - 1 > first);
#pragma unroll
    for (int n8 = 0; n8 < kKeys / 8; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = e / 2;
        float p = exp2f(s[n8][e] * a.scale2 - L[x]);
        if (edge) {
          const int t = j * kKeys + n8 * 8 + (lane % 4) * 2 + e % 2;
          if (t >= a.Sk || (a.causal && t > pos[x])) p = 0.f;
        }
        dp[n8][e] = p * (dp[n8][e] - D[x]);
      }
    float* w = sP + warp * 16 * C::QPLD;
    to_scratch<kKeys>(w, C::QPLD, dp);
    mma_kn<HD, kKeys>(dq, w, C::QPLD, tK, LD);
    __syncthreads();  // this stage is consumed
  }

#pragma unroll
  for (int x = 0; x < 2; ++x) {
    if (rows[x] >= n_rows) continue;
    const int s = rows[x] / a.G, g = rows[x] % a.G;
    float* row = a.dq + (((b * static_cast<int64_t>(a.Sq) + s) * a.KV + h) *
                             a.G + g) * HD;
#pragma unroll
    for (int n8 = 0; n8 < HD / 8; ++n8)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        row[n8 * 8 + (lane % 4) * 2 + e] = dq[n8][2 * x + e] * a.scale;
  }
}

template <int HD>
int launch(const Args& a, cudaStream_t stream) {
  using C = Cfg<HD>;
  const int64_t n = static_cast<int64_t>(a.B) * a.Sq * a.KV * a.G;
  flash_bwd_delta_kernel<HD>
      <<<static_cast<unsigned>((n + kWarps - 1) / kWarps), kThreads, 0,
         stream>>>(a);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM_A);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_bwd_dq_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM_B);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned bh = static_cast<unsigned>(a.B) * a.KV;
  flash_bwd_dkdv_kernel<HD>
      <<<(a.Sk + kKeys - 1) / kKeys * bh, kThreads, C::SMEM_A, stream>>>(a);
  const int n_rows = a.Sq * a.G;
  flash_bwd_dq_kernel<HD>
      <<<(n_rows + kQRows - 1) / kQRows * bh, kThreads, C::SMEM_B,
         stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, dout: f32 device pointers read through their outer element
// strides (the innermost stride is 1, the rows start 16-byte aligned); out
// contiguous (B, Sq, KV, G, hd); lse f32 (B, KV, G, Sq); delta f32 scratch
// of lse's size; dq, dk, dv contiguous f32 outputs.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int KV, int G, int hd, int causal,
    long long qb, long long qs, long long qk, long long qg, long long kb,
    long long ks, long long kk, long long vb, long long vs, long long vk,
    long long ob, long long os, long long ok, long long og,
    cudaStream_t stream) {
  const double scale = 1.0 / sqrt(static_cast<double>(hd));
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(out),
               static_cast<const float*>(dout), lse, delta,
               static_cast<float*>(dq), static_cast<float*>(dk),
               static_cast<float*>(dv), B, Sq, Sk, KV, G, causal,
               static_cast<float>(scale),
               static_cast<float>(scale * 1.4426950408889634), qb, qs, qk,
               qg, kb, ks, kk, vb, vs, vk, ob, os, ok, og};
  switch (hd) {
    case 32: return launch<32>(a, stream);
    case 64: return launch<64>(a, stream);
    case 128: return launch<128>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
