// Masked nearest-point distance for a fleet of robots, on Hopper.
//
// Replaces the Pallas TPU kernel dddmr_navigation_tpu/ops/distance_field.py
// (_pallas_min_dist -> _pallas_kernel, public masked_min_distance). For
// robot b and query q it computes sqrt(min over valid points p of
// |q - p|^2), the squared distance taken as dx*dx + dy*dy + dz*dz of the
// direct differences; a masked query gives 1e6, and an empty point set
// gives sqrt(1e12) = 1e6.
//
// What bounds it: arithmetic. The tick calls it twice: the stick-path
// critic with every (sample, step) row as a query against the 128-pose
// prune plan (64 x 11,560 queries at the headline, 327,680 at the fused
// tick: 95 M and 42 M pairs of 8 flops, 11.6 and 5.1 us at 67 TFLOP/s f32;
// the inputs are a few MB, a few us at 3.35 TB/s) and the toward-plan
// critic with one query per sample, which is small. Only unmasked queries
// and valid points need work, so a run's own bound is lower;
// navbench/bounds.py computes it from the run's data. Without FMA (the
// result must equal the plain version's bit for bit) a pair issues 3 FSUB,
// 3 FMUL, 2 FADD and a FMNMX; a kernel with one thread per query that stages
// the points in shared memory adds three shared loads a pair.
//
// What the design does about it:
//  * register tiling: a thread owns 4 queries (the wide variant, taken when
//    B*Q is large enough to fill the card with 4x fewer threads), and each
//    point is read from shared memory once, as a float4, for all 4: 0.25
//    shared loads a pair; the point loop is unrolled by 8;
//  * a warp whose queries are all masked writes 1e6 and skips the loop (the
//    stick-path call masks every invalid step);
//  * only valid points are computed: the block compacts its robot's valid
//    points into shared memory (__ballot_sync and __popc give each its
//    slot), and adds the parking point (1e6, 1e6, 1e6) once when any point
//    is invalid, since every invalid point stands there in the plain
//    version. The ticks' prune plans hold 31-36 valid poses of 128, so
//    this drops about three quarters of the pairs.
// The minimum of a set of floats does not depend on the order it is taken
// in (d2 is never -0, and fminf ignores a NaN d2 in any order), so the
// compacted set gives the same bits.
//
// A per-warp point cull by a box lower bound against the warp's running
// minima was tried first and dropped: on the ticks' prune plans it kept
// every valid point, and its per-group warp reductions left the fused
// tick's two calls at 11.7 us of device time against 8.0 us with the
// compacted set (chip_smoke.py, H100 80GB HBM3 at 700 W).
//
// Every multiply, add and difference of d2 is rounded separately
// (__fmul_rn/__fadd_rn/__fsub_rn, and the build passes --fmad=false) in the
// plain version's order, and sqrtf is correctly rounded, so the result
// equals the plain PyTorch version's bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kFar = 1.0e6f;    // parking coordinate / masked result
constexpr float kBig = 1.0e12f;   // initial squared distance
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float dist2(float qx, float qy, float qz, float px,
                                       float py, float pz) {
  const float dx = __fsub_rn(qx, px);
  const float dy = __fsub_rn(qy, py);
  const float dz = __fsub_rn(qz, pz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// ---------------------------------------------------------------------------
// The kernel: register tiling, masked-warp skip and the compacted point
// set.
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;               // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 512;             // points staged at once (8 KB)
constexpr long long kWideFrom = 1 << 17;  // B*Q from which a thread owns 4

// A warp owns 32 * QPT consecutive queries: lane l holds l, l + 32, ...
template <int QPT>
__global__ void __launch_bounds__(kThreads)
masked_min_distance_kernel(const float* __restrict__ queries,   // (B,Q,3)
                           const uint8_t* __restrict__ q_mask,  // (B,Q)
                           const float* __restrict__ points,    // (B,M,3)
                           const uint8_t* __restrict__ p_mask,  // (B,M)
                           int Q, int M, float* __restrict__ out) {  // (B,Q)
  __shared__ float4 pts[kChunk + 1];  // the chunk's valid points, compacted
  __shared__ int counts[kWarps];      // valid points of each warp's share
  __shared__ int parked[kWarps];      // whether its share holds an invalid

  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = (blockIdx.x * kWarps + warp) * 32 * QPT + lane;

  float qx[QPT], qy[QPT], qz[QPT], best[QPT];
  bool valid[QPT];
  bool any = false;
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int q = q0 + 32 * i;
    const size_t gq = static_cast<size_t>(b) * Q + q;
    valid[i] = q < Q && q_mask[gq] != 0;
    qx[i] = qy[i] = qz[i] = 0.f;
    if (valid[i]) {
      qx[i] = queries[gq * 3 + 0];
      qy[i] = queries[gq * 3 + 1];
      qz[i] = queries[gq * 3 + 2];
    }
    best[i] = kBig;
    any = any || valid[i];
  }
  const bool warp_live = __any_sync(kFull, any);

  const float* pp = points + static_cast<size_t>(b) * M * 3;
  const uint8_t* pvalid = p_mask + static_cast<size_t>(b) * M;
  for (int base = 0; base < M; base += kChunk) {
    const int cnt = min(kChunk, M - base);
    // Compact the chunk's valid points into pts[0, n); n and has_parked
    // come out the same in every thread.
    int n = 0;
    bool has_parked = false;
    for (int r = 0; r < cnt; r += kThreads) {
      const int i = r + threadIdx.x;
      const bool in = i < cnt;
      const bool ok = in && pvalid[base + i] != 0;
      const unsigned oks = __ballot_sync(kFull, ok);
      const unsigned bad = __ballot_sync(kFull, in && !ok);
      __syncthreads();  // the previous round's counts, or chunk, are read
      if (lane == 0) {
        counts[warp] = __popc(oks);
        parked[warp] = bad != 0u;
      }
      __syncthreads();
      int slot = n;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (w < warp) slot += counts[w];
        n += counts[w];
        has_parked = has_parked || parked[w] != 0;
      }
      if (ok) {
        pts[slot + __popc(oks & ((1u << lane) - 1u))] =
            make_float4(pp[(base + i) * 3 + 0], pp[(base + i) * 3 + 1],
                        pp[(base + i) * 3 + 2], 0.f);
      }
    }
    // Every invalid point stands at the parking point: one copy does.
    if (has_parked) {
      if (threadIdx.x == 0) pts[n] = make_float4(kFar, kFar, kFar, 0.f);
      ++n;
    }
    __syncthreads();
    if (warp_live) {  // warp-uniform: skipped when every query is masked
      int j = 0;
      for (; j + 8 <= n; j += 8) {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float4 p = pts[j + u];
#pragma unroll
          for (int i = 0; i < QPT; ++i)
            best[i] = fminf(best[i], dist2(qx[i], qy[i], qz[i], p.x, p.y, p.z));
        }
      }
      for (; j < n; ++j) {
        const float4 p = pts[j];
#pragma unroll
        for (int i = 0; i < QPT; ++i)
          best[i] = fminf(best[i], dist2(qx[i], qy[i], qz[i], p.x, p.y, p.z));
      }
    }
    __syncthreads();  // pts is read; the next chunk may overwrite it
  }
#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int q = q0 + 32 * i;
    if (q < Q)
      out[static_cast<size_t>(b) * Q + q] = valid[i] ? sqrtf(best[i]) : kFar;
  }
}

}  // namespace

// Launches on `stream`. Returns the launch's cudaError_t (0 on success).
extern "C" int masked_min_distance_launch(const void* queries,
                                          const void* q_mask,
                                          const void* points,
                                          const void* p_mask, int B, int Q,
                                          int M, void* out, void* stream) {
  if (B == 0 || Q == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* qs = static_cast<const float*>(queries);
  const auto* qm = static_cast<const uint8_t*>(q_mask);
  const auto* ps = static_cast<const float*>(points);
  const auto* pm = static_cast<const uint8_t*>(p_mask);
  auto* o = static_cast<float*>(out);
  if (static_cast<long long>(B) * Q >= kWideFrom) {
    const dim3 grid((Q + 4 * kThreads - 1) / (4 * kThreads), B);
    masked_min_distance_kernel<4><<<grid, kThreads, 0, s>>>(qs, qm, ps, pm, Q,
                                                            M, o);
  } else {
    const dim3 grid((Q + kThreads - 1) / kThreads, B);
    masked_min_distance_kernel<1><<<grid, kThreads, 0, s>>>(qs, qm, ps, pm, Q,
                                                            M, o);
  }
  return static_cast<int>(cudaGetLastError());
}
