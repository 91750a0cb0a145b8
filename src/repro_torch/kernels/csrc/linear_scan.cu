// The linear recurrence of the SSM and hybrid LMs, forward and backward,
// for Hopper (sm_90a).
//
// linear_scan_launch computes, for f32 a, b (B, S, C) and h0 (B, C), all
// contiguous,
//     h[i, t, c] = a[i, t, c] * h[i, t - 1, c] + b[i, t, c],
//     h[i, -1, c] = h0[i, c],   h_last = h[:, S - 1],
// the contract of src/repro/models/ssm.py:57 chunked_linear_scan (jnp, no
// Pallas kernel: a lax.scan over chunks of an associative scan) with the
// trailing axes flattened into C: Mamba's (d_inner, N) state, d_inner * 16
// channels, and RG-LRU's lru_width.
//
// linear_scan_bwd_launch computes its gradient for g = dL/dh and g_last =
// dL/dh_last (may be null): the same recurrence run backwards with a
// shifted by one step,
//     dh[t] = g[t] + a[t + 1] * dh[t + 1],   dh[S - 1] = g[S - 1] + g_last,
// and from it da[t] = dh[t] * h[t - 1] (h[-1] = h0), db[t] = dh[t] and
// dh0 = a[0] * dh[0].  JAX differentiates the reference's scan instead.
//
// What bounds it: bytes.  The forward reads a and b and writes h, 12 bytes
// a (step, channel); at falcon-mamba-7b's width (B 1, S 2,048, C 131,072)
// 3.2 GB, 0.96 ms at 3.35 TB/s.  The backward reads a, h and g and writes
// da and db, 20 bytes a (step, channel).  The arithmetic is one FMA a step.
// A step depends on the one before it, so what stands between the kernel
// and its bound is the chain's latency where there are few channels
// (RG-LRU: 2,560 channels, one thread each would be 80 warps on 132 SMs).
//
// Design: a block takes 32 neighbouring channels of one sequence (a lane a
// channel, so every load and store of a warp is one 128-byte line) and W
// warps (8 when the grid holds many blocks a SM, 32 when it does not).
// It walks the sequence in tiles of W * 8 steps; in a tile warp w holds
// steps [8 w, 8 w + 8) of its lanes' channels in registers:
//   1. each thread loads its 8 (a, b) pairs (independent loads, so a tile's
//      are all in flight at once) and reduces them to their composite map
//      h -> A h + B;
//   2. the composites go to shared memory, one barrier;
//   3. each thread composes the block's carry with the composites of the
//      warps before it (at most W - 1 FMAs), then runs its 8 steps from
//      that value, writing h; the last warp's final h is the next tile's
//      carry.
// So a and b are read once and h written once, and the dependent chain a
// tile is 8 + (W - 1) + 8 steps for W * 8 steps of sequence.  The
// composites and the carry are double-buffered by tile parity, so one
// barrier a tile suffices: a warp that runs ahead writes the other buffer,
// and cannot reach the same buffer again before every warp has passed the
// next barrier.  Within a thread the steps are summed in order; the
// composites group them in another order than the reference's associative
// scan, so results agree to rounding, not bit for bit.  The backward is the
// same walk over the reversed sequence (tile 0 holds the last steps).
//
// The launchers run on the caller's stream, allocate nothing and return
// cudaGetLastError() so that a refused launch surfaces in the wrapper.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;     // channels a block, a lane each
constexpr int kSteps = 8;      // steps a thread holds in a tile
constexpr int kMaxWarps = 32;

struct Tiles {
  float A[2][kMaxWarps][kLanes];   // each warp's composite h -> A h + B
  float B[2][kMaxWarps][kLanes];
  float carry[2][kLanes];          // the value entering the tile
};

// The value entering warp `warp`'s steps of the tile: the tile's carry
// composed with the composites of the warps before it.
__device__ __forceinline__ float carry_in(const Tiles& sm, int par, int warp,
                                          int lane) {
  float h = sm.carry[par][lane];
  for (int j = 0; j < warp; ++j)
    h = fmaf(sm.A[par][j][lane], h, sm.B[par][j][lane]);
  return h;
}

__global__ void __launch_bounds__(kLanes * kMaxWarps)
linear_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ h0, float* __restrict__ h,
                   float* __restrict__ h_last, int S, int C) {
  __shared__ Tiles sm;
  const int lane = threadIdx.x, warp = threadIdx.y, W = blockDim.y;
  const int col_blocks = (C + kLanes - 1) / kLanes;
  const int seq = blockIdx.x / col_blocks;
  const int c = (blockIdx.x % col_blocks) * kLanes + lane;
  const bool live = c < C;
  const int64_t row0 = static_cast<int64_t>(seq) * S * C + c;  // (seq, 0, c)
  if (warp == 0)
    sm.carry[0][lane] = live ? h0[static_cast<int64_t>(seq) * C + c] : 0.f;
  float hv = 0.f;
  for (int t0 = 0, k = 0; t0 < S; t0 += W * kSteps, ++k) {
    const int par = k & 1;
    const int s0 = t0 + warp * kSteps;
    float av[kSteps], bv[kSteps];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const bool in = live && s0 + i < S;   // past the end: the identity
      const int64_t at = row0 + static_cast<int64_t>(s0 + i) * C;
      av[i] = in ? a[at] : 1.f;
      bv[i] = in ? b[at] : 0.f;
    }
    float A = 1.f, B = 0.f;
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      B = fmaf(av[i], B, bv[i]);
      A *= av[i];
    }
    sm.A[par][warp][lane] = A;
    sm.B[par][warp][lane] = B;
    __syncthreads();
    hv = carry_in(sm, par, warp, lane);
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      hv = fmaf(av[i], hv, bv[i]);
      if (live && s0 + i < S) h[row0 + static_cast<int64_t>(s0 + i) * C] = hv;
    }
    if (warp == W - 1) sm.carry[par ^ 1][lane] = hv;
  }
  // the last warp's final value is h[S - 1] (steps past the end are the
  // identity)
  if (warp == W - 1 && live) h_last[static_cast<int64_t>(seq) * C + c] = hv;
}

__global__ void __launch_bounds__(kLanes * kMaxWarps)
linear_scan_bwd_kernel(const float* __restrict__ a,
                       const float* __restrict__ h,
                       const float* __restrict__ h0,
                       const float* __restrict__ g,
                       const float* __restrict__ g_last,
                       float* __restrict__ da, float* __restrict__ db,
                       float* __restrict__ dh0, int S, int C) {
  __shared__ Tiles sm;
  const int lane = threadIdx.x, warp = threadIdx.y, W = blockDim.y;
  const int col_blocks = (C + kLanes - 1) / kLanes;
  const int seq = blockIdx.x / col_blocks;
  const int c = (blockIdx.x % col_blocks) * kLanes + lane;
  const bool live = c < C;
  const int64_t row0 = static_cast<int64_t>(seq) * S * C + c;
  const int64_t vec = static_cast<int64_t>(seq) * C + c;      // (seq, c)
  if (warp == 0) sm.carry[0][lane] = 0.f;
  // step r of the reversed walk is t = S - 1 - r
  for (int r0 = 0, k = 0; r0 < S; r0 += W * kSteps, ++k) {
    const int par = k & 1;
    const int s0 = r0 + warp * kSteps;
    float cv[kSteps], gv[kSteps], hp[kSteps];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int t = S - 1 - (s0 + i);
      const bool in = live && t >= 0;
      const int64_t at = row0 + static_cast<int64_t>(t) * C;
      // a[t + 1] carries dh[t + 1] into dh[t]; at t = S - 1 the carry is 0
      cv[i] = !in ? 1.f : (t + 1 < S ? a[at + C] : 0.f);
      gv[i] = in ? g[at] : 0.f;
      if (in && g_last != nullptr && t == S - 1) gv[i] += g_last[vec];
      hp[i] = !in ? 0.f : (t > 0 ? h[at - C] : h0[vec]);
    }
    float A = 1.f, B = 0.f;
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      B = fmaf(cv[i], B, gv[i]);
      A *= cv[i];
    }
    sm.A[par][warp][lane] = A;
    sm.B[par][warp][lane] = B;
    __syncthreads();
    float dh = carry_in(sm, par, warp, lane);
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      dh = fmaf(cv[i], dh, gv[i]);
      const int t = S - 1 - (s0 + i);
      if (live && t >= 0) {
        const int64_t at = row0 + static_cast<int64_t>(t) * C;
        db[at] = dh;
        da[at] = dh * hp[i];
        if (t == 0) dh0[vec] = a[row0] * dh;
      }
    }
    if (warp == W - 1) sm.carry[par ^ 1][lane] = dh;
  }
}

int grid(int B, int C) { return B * ((C + kLanes - 1) / kLanes); }

}  // namespace

extern "C" int linear_scan_launch(const void* a, const void* b,
                                  const void* h0, void* h, void* h_last,
                                  int B, int S, int C, int warps,
                                  void* stream) {
  if (B == 0 || S == 0 || C == 0) return 0;
  if (warps < 1 || warps > kMaxWarps) return cudaErrorInvalidValue;
  linear_scan_kernel<<<grid(B, C), dim3(kLanes, warps), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h),
      static_cast<float*>(h_last), S, C);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int linear_scan_bwd_launch(const void* a, const void* h,
                                      const void* h0, const void* g,
                                      const void* g_last, void* da, void* db,
                                      void* dh0, int B, int S, int C,
                                      int warps, void* stream) {
  if (B == 0 || S == 0 || C == 0) return 0;
  if (warps < 1 || warps > kMaxWarps) return cudaErrorInvalidValue;
  linear_scan_bwd_kernel<<<grid(B, C), dim3(kLanes, warps), 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(h),
      static_cast<const float*>(h0), static_cast<const float*>(g),
      static_cast<const float*>(g_last), static_cast<float*>(da),
      static_cast<float*>(db), static_cast<float*>(dh0), S, C);
  return static_cast<int>(cudaGetLastError());
}
