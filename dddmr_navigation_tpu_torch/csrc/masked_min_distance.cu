// Masked nearest-point distance for a fleet of robots, on Hopper.
//
// Replaces the Pallas TPU kernel dddmr_navigation_tpu/ops/distance_field.py
// (_pallas_min_dist -> _pallas_kernel, public masked_min_distance). For
// robot b and query q it computes sqrt(min over valid points p of
// |q - p|^2), the squared distance taken as dx*dx + dy*dy + dz*dz of the
// direct differences; a masked query gives 1e6, and an empty point set
// gives sqrt(1e12) = 1e6.
//
// What bounds it: arithmetic and launch. The tick calls it twice: the
// stick-path critic with 64 x 11,560 queries against 128 plan points
// (~95 M distances of 8 flops, ~0.8 GFLOP, ~11 us at 67 TFLOP/s f32, on
// ~9 MB of queries, ~3 us at 3.35 TB/s) and the toward-plan critic with
// 64 x 289 queries, which is all launch.
//
// What the design does about it: one thread per query keeps the query and
// its running minimum in registers; the block stages its robot's points in
// shared memory in chunks, moving invalid points to 1e6 as it stages them,
// so each point is read from device memory once per block. Every multiply,
// add and difference is rounded separately (__fmul_rn/__fadd_rn/__fsub_rn,
// and the build passes --fmad=false) in the plain version's order, and
// sqrtf is correctly rounded, so the result equals the plain PyTorch
// version's bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;     // queries per block
constexpr int kChunk = 512;       // points staged in shared memory at once
constexpr float kFar = 1.0e6f;    // parking coordinate / masked result
constexpr float kBig = 1.0e12f;   // initial squared distance

__global__ void __launch_bounds__(kThreads)
masked_min_distance_kernel(const float* __restrict__ queries,   // (B,Q,3)
                           const uint8_t* __restrict__ q_mask,  // (B,Q)
                           const float* __restrict__ points,    // (B,M,3)
                           const uint8_t* __restrict__ p_mask,  // (B,M)
                           int Q, int M, float* __restrict__ out) {  // (B,Q)
  __shared__ float px[kChunk];
  __shared__ float py[kChunk];
  __shared__ float pz[kChunk];

  const int b = blockIdx.y;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const size_t gq = static_cast<size_t>(b) * Q + q;
  const bool active = q < Q;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = queries[gq * 3 + 0];
    qy = queries[gq * 3 + 1];
    qz = queries[gq * 3 + 2];
  }

  const float* pts = points + static_cast<size_t>(b) * M * 3;
  const uint8_t* pvalid = p_mask + static_cast<size_t>(b) * M;
  float best = kBig;
  for (int base = 0; base < M; base += kChunk) {
    const int n = min(kChunk, M - base);
    __syncthreads();  // the previous chunk is no longer read
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const bool ok = pvalid[base + i] != 0;
      px[i] = ok ? pts[(base + i) * 3 + 0] : kFar;
      py[i] = ok ? pts[(base + i) * 3 + 1] : kFar;
      pz[i] = ok ? pts[(base + i) * 3 + 2] : kFar;
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float dx = __fsub_rn(qx, px[i]);
      const float dy = __fsub_rn(qy, py[i]);
      const float dz = __fsub_rn(qz, pz[i]);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      best = fminf(best, d2);
    }
  }
  if (active) out[gq] = q_mask[gq] != 0 ? sqrtf(best) : kFar;
}

}  // namespace

// Launches on `stream`. Returns the launch's cudaError_t (0 on success).
extern "C" int masked_min_distance_launch(const void* queries,
                                          const void* q_mask,
                                          const void* points,
                                          const void* p_mask, int B, int Q,
                                          int M, void* out, void* stream) {
  if (B == 0 || Q == 0) return 0;
  const dim3 grid((Q + kThreads - 1) / kThreads, B);
  masked_min_distance_kernel<<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(queries),
      static_cast<const uint8_t*>(q_mask),
      static_cast<const float*>(points),
      static_cast<const uint8_t*>(p_mask), Q, M, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
