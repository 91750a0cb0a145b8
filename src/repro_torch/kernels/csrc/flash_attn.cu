// Blockwise GQA flash attention, forward, for Hopper (sm_90a).
//
// flash_attention_launch replaces the Pallas TPU kernel
// src/repro/kernels/flash_attn.py:flash_attention (_kernel), the hot path
// of the LM's attention_train at S >= 2048.  For q (B, Sq, KV, G, hd) and
// k, v (B, Sk, KV, hd), every query row (b, s, kv, g) is
//     out  = softmax_t(q . k_t / sqrt(hd)) v_t   over t <= s (causal) or all t
//     lse  = log sum_t exp(q . k_t / sqrt(hd))   (f32, kept for the backward)
// by the online softmax: a running max m, a running sum l and an f32
// accumulator, rescaled by exp(m_old - m_new) as keys stream past.  out is
// written in f32, contiguous (B, Sq, KV, G, hd);
// lse contiguous (B, KV, G, Sq).  Inputs are read through their strides,
// so the model's (B, S, KV, G, hd) projections need no transpose copy.
//
// What bounds it: at the LM path's shape (smollm-360m, B = 4, S = 2048,
// 15 heads over 5 KV heads, hd = 64, causal) the forward needs 4 hd
// operations per (query row, visible key) pair, 32.2 GFLOP, 33 us at the
// tensor cores' 989 TFLOP/s in bf16; it moves 42 MB, 13 us at 3.35 TB/s.
// So operations bound it.  This kernel runs on the CUDA cores (67 TFLOP/s
// in f32, 0.48 ms for the same work) and takes f32 inputs; bf16 inputs go
// to the tensor-core kernel of flash_attn_sm90.cu (wgmma fed by TMA).
//
// Design: a block takes 64 consecutive rows of the flattened (s, g) axis
// of one (b, kv) pair, so all G query heads of a position share each K/V
// tile, whatever G is.  Keys stream through shared memory in tiles of 64
// (32 at hd = 128), converted to f32 once.  A row belongs to hd / 16
// neighbouring threads of a warp; each holds 16 elements of q (scaled by
// log2(e) / sqrt(hd)) and of the accumulator, interleaved by float4 so that
// the row's threads read one contiguous run of shared memory (no bank
// conflicts; the rows of a warp read the same key, a broadcast).  Keys are
// scored 16 at a time: 16 partial dot products, summed across the row's
// threads by xor shuffles, masked, then one rescale of the accumulator per
// 16 keys.  Under causal the block reads keys only up to its last row's
// position (the TPU kernel's kv-block skip); rows past the diagonal inside
// the last tile are masked to -inf, so they add exactly 0.  Exponentials
// are exp2f of log2-scaled scores.
//
// The launcher runs on the caller's stream, allocates nothing and returns
// cudaGetLastError() so that a refused launch surfaces in the wrapper.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;     // query rows (position, head) per block
constexpr int kChunk = 16;    // keys scored before one rescale
constexpr int kPer = 16;      // head-dim elements per thread
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kLn2 = 0.69314718055994530942f;

__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  int B, Sq, Sk, KV, G, causal;
  float q_scale;  // log2(e) / sqrt(hd)
  // element strides: q (b, s, kv, g, d); k and v (b, s, kv, d)
  int64_t qb, qs, qk, qg, qd, kb, ks, kk, kd, vb, vs, vk, vd;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kRows * (HD / kPer))
flash_attention_kernel(const Args a) {
  constexpr int TPR = HD / kPer;          // threads per query row
  constexpr int V4 = HD / 4;              // float4s in a row of K or V
  constexpr int BK = HD <= 64 ? 64 : 32;  // keys per shared-memory tile
  static_assert(BK % kChunk == 0, "tile holds whole chunks");
  __shared__ float4 k_tile[BK][V4];
  __shared__ float4 v_tile[BK][V4];

  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ kp = static_cast<const T*>(a.k);
  const T* __restrict__ vp = static_cast<const T*>(a.v);
  T* __restrict__ out = static_cast<T*>(a.out);

  const int tid = threadIdx.x;
  const int part = tid % TPR;             // this thread's share of the row
  const int64_t n_rows = static_cast<int64_t>(a.Sq) * a.G;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int64_t r = row0 + tid / TPR;
  const bool valid = r < n_rows;
  const int s = valid ? static_cast<int>(r / a.G) : 0;
  const int g = valid ? static_cast<int>(r % a.G) : 0;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t last = (row0 + kRows < n_rows ? row0 + kRows : n_rows) - 1;
  const int n_keys =
      a.causal ? min(a.Sk, static_cast<int>(last / a.G) + 1) : a.Sk;

  // element c of float4 i of this thread is head-dim index 4 (i TPR + part) + c
  float qr[kPer], acc[kPer];
  const T* qrow = q + b * a.qb + s * a.qs + h * a.qk + g * a.qg;
#pragma unroll
  for (int i = 0; i < kPer / 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = 4 * (i * TPR + part) + c;
      qr[4 * i + c] = valid ? to_f32(qrow[d * a.qd]) * a.q_scale : 0.f;
      acc[4 * i + c] = 0.f;
    }
  float m = -INFINITY, l = 0.f;

  const T* krow = kp + b * a.kb + h * a.kk;
  const T* vrow = vp + b * a.vb + h * a.vk;
  float* kt = reinterpret_cast<float*>(k_tile);
  float* vt = reinterpret_cast<float*>(v_tile);
  for (int k0 = 0; k0 < n_keys; k0 += BK) {
    const int nk = min(BK, n_keys - k0);
    __syncthreads();                      // the previous tile is consumed
    for (int e = tid; e < BK * HD; e += blockDim.x) {
      const int j = e / HD, d = e % HD;
      float kx = 0.f, vx = 0.f;
      if (j < nk) {
        kx = to_f32(krow[(k0 + j) * a.ks + d * a.kd]);
        vx = to_f32(vrow[(k0 + j) * a.vs + d * a.vd]);
      }
      kt[e] = kx;
      vt[e] = vx;
    }
    __syncthreads();
    for (int j0 = 0; j0 < nk; j0 += kChunk) {
      float sc[kChunk];
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < kPer / 4; ++i) {
          const float4 kx = k_tile[j0 + jj][i * TPR + part];
          dot = fmaf(qr[4 * i], kx.x, dot);
          dot = fmaf(qr[4 * i + 1], kx.y, dot);
          dot = fmaf(qr[4 * i + 2], kx.z, dot);
          dot = fmaf(qr[4 * i + 3], kx.w, dot);
        }
        sc[jj] = dot;
      }
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj)
#pragma unroll
        for (int off = TPR / 2; off > 0; off >>= 1)
          sc[jj] += __shfl_xor_sync(kFullMask, sc[jj], off);
      float m_new = m;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int t = k0 + j0 + jj;
        const bool seen = j0 + jj < nk && (!a.causal || t <= s);
        sc[jj] = seen ? sc[jj] : -INFINITY;
        m_new = fmaxf(m_new, sc[jj]);
      }
      // a row sees key 0 in its first chunk, so m_new is finite from then
      const float corr = m_new == -INFINITY ? 1.f : exp2f(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        sc[jj] = m_new == -INFINITY ? 0.f : exp2f(sc[jj] - m_new);
        psum += sc[jj];
      }
      l = l * corr + psum;
#pragma unroll
      for (int c = 0; c < kPer; ++c) acc[c] *= corr;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
#pragma unroll
        for (int i = 0; i < kPer / 4; ++i) {
          const float4 vx = v_tile[j0 + jj][i * TPR + part];
          acc[4 * i] = fmaf(sc[jj], vx.x, acc[4 * i]);
          acc[4 * i + 1] = fmaf(sc[jj], vx.y, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(sc[jj], vx.z, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(sc[jj], vx.w, acc[4 * i + 3]);
        }
      }
      m = m_new;
    }
  }

  if (!valid) return;
  const float inv = 1.f / l;
  T* orow = out + ((((static_cast<int64_t>(b) * a.Sq + s) * a.KV + h) * a.G
                    + g) * HD);
#pragma unroll
  for (int i = 0; i < kPer / 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = 4 * (i * TPR + part) + c;
      orow[d] = from_f32<T>(acc[4 * i + c] * inv);
    }
  if (part == 0)
    a.lse[((static_cast<int64_t>(b) * a.KV + h) * a.G + g) * a.Sq + s] =
        (m + log2f(l)) * kLn2;
}

template <typename T, int HD>
void launch(const Args& a, cudaStream_t stream) {
  const int64_t n_rows = static_cast<int64_t>(a.Sq) * a.G;
  const dim3 grid(static_cast<unsigned>((n_rows + kRows - 1) / kRows), a.KV,
                  a.B);
  flash_attention_kernel<T, HD><<<grid, kRows * (HD / kPer), 0, stream>>>(a);
}

template <typename T>
int dispatch_hd(const Args& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: launch<T, 32>(a, stream); break;
    case 64: launch<T, 64>(a, stream); break;
    case 128: launch<T, 128>(a, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: f32 device pointers; out
// contiguous (B, Sq, KV, G, hd) of that type; lse contiguous f32
// (B, KV, G, Sq).  Strides in elements.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, float* lse,
    int B, int Sq, int Sk, int KV, int G, int hd, int causal,
    long long qb, long long qs, long long qk, long long qg, long long qd,
    long long kb, long long ks, long long kk, long long kd, long long vb,
    long long vs, long long vk, long long vd, cudaStream_t stream) {
  Args a{q, k, v, out, lse, B, Sq, Sk, KV, G, causal,
         static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(hd))),
         qb, qs, qk, qg, qd, kb, ks, kk, kd, vb, vs, vk, vd};
  return dispatch_hd<float>(a, hd, stream);
}
