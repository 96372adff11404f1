// Swept oriented-box collision test for a fleet of robots, on Hopper.
//
// Replaces the Pallas TPU kernel dddmr_navigation_tpu/ops/collision.py
// (_pallas_hits -> _pallas_kernel, public swept_box_hits). It computes, for
// robot b and rollout sample s, whether any valid obstacle p satisfies
// |axes[b,s,n,k] . p - projc[b,s,n,k]| <= half[k] for k = 0, 1, 2 at any step
// n with step_valid[b,s,n] set.
//
// What bounds it: arithmetic. At the 64-robot tick (289 samples, 40 steps,
// 128 near obstacles) it is ~95 M point-box tests of ~21 flops each (~2
// GFLOP, ~30 us at the card's 67 TFLOP/s f32) on ~36 MB of inputs (~11 us
// at 3.35 TB/s), so the f32 rate, not memory, is the limit, and at this
// size the launch itself is a large share of the time.
//
// What the design does about it: one thread per (sample, step) row keeps
// that row's nine axis components and three center projections in
// registers; the block stages its robot's obstacles in shared memory in
// chunks, so each obstacle is read from device memory once per block and
// broadcast from shared memory to all its threads. A row stops at its first
// hit. Invalid obstacles are parked at 1e9 while staged, which puts them
// outside every box, as the TPU kernel's padding does. Every multiply and
// add is rounded separately (__fmul_rn/__fadd_rn, and the build passes
// --fmad=false) in the plain version's order, so the hits equal the plain
// PyTorch version's bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // (sample, step) rows per block
constexpr int kChunk = 512;     // obstacles staged in shared memory at once
constexpr float kFar = 1.0e9f;  // parking coordinate of invalid obstacles

__device__ __forceinline__ float dot3(float ax, float ay, float az, float x,
                                      float y, float z) {
  // (ax*x + ay*y) + az*z, each product and sum rounded on its own.
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, x), __fmul_rn(ay, y)),
                   __fmul_rn(az, z));
}

__global__ void __launch_bounds__(kThreads)
swept_box_hits_kernel(const float* __restrict__ axes,          // (B,S,N,9)
                      const float* __restrict__ projc,         // (B,S,N,3)
                      const uint8_t* __restrict__ step_valid,  // (B,S,N)
                      const float* __restrict__ obstacles,     // (B,K,3)
                      const uint8_t* __restrict__ obs_valid,   // (B,K)
                      int S, int N, int K, float h0, float h1, float h2,
                      uint8_t* __restrict__ hits) {            // (B,S), zeroed
  __shared__ float px[kChunk];
  __shared__ float py[kChunk];
  __shared__ float pz[kChunk];

  const int b = blockIdx.y;
  const int rows = S * N;
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const size_t grow = static_cast<size_t>(b) * rows + row;
  const bool active = row < rows && step_valid[grow] != 0;

  float a[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float c0 = 0.f, c1 = 0.f, c2 = 0.f;
  if (active) {
#pragma unroll
    for (int i = 0; i < 9; ++i) a[i] = axes[grow * 9 + i];
    c0 = projc[grow * 3 + 0];
    c1 = projc[grow * 3 + 1];
    c2 = projc[grow * 3 + 2];
  }

  const float* obs = obstacles + static_cast<size_t>(b) * K * 3;
  const uint8_t* ovalid = obs_valid + static_cast<size_t>(b) * K;
  bool hit = false;
  for (int base = 0; base < K; base += kChunk) {
    const int n = min(kChunk, K - base);
    __syncthreads();  // the previous chunk is no longer read
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const bool ok = ovalid[base + i] != 0;
      px[i] = ok ? obs[(base + i) * 3 + 0] : kFar;
      py[i] = ok ? obs[(base + i) * 3 + 1] : kFar;
      pz[i] = ok ? obs[(base + i) * 3 + 2] : kFar;
    }
    __syncthreads();
    if (active && !hit) {
      for (int i = 0; i < n; ++i) {
        const float x = px[i], y = py[i], z = pz[i];
        const bool in0 =
            fabsf(__fsub_rn(dot3(a[0], a[1], a[2], x, y, z), c0)) <= h0;
        const bool in1 =
            fabsf(__fsub_rn(dot3(a[3], a[4], a[5], x, y, z), c1)) <= h1;
        const bool in2 =
            fabsf(__fsub_rn(dot3(a[6], a[7], a[8], x, y, z), c2)) <= h2;
        if (in0 && in1 && in2) {
          hit = true;
          break;
        }
      }
    }
  }
  // Every writer stores the same value, so concurrent stores are benign.
  if (hit) hits[static_cast<size_t>(b) * S + row / N] = 1;
}

}  // namespace

// Launches on `stream`; `hits` must be zeroed by the caller. Returns the
// launch's cudaError_t (0 on success).
extern "C" int swept_box_hits_launch(const void* axes, const void* projc,
                                     const void* step_valid,
                                     const void* obstacles,
                                     const void* obs_valid, int B, int S,
                                     int N, int K, float h0, float h1,
                                     float h2, void* hits, void* stream) {
  if (B == 0 || S == 0 || N == 0) return 0;
  const dim3 grid((S * N + kThreads - 1) / kThreads, B);
  swept_box_hits_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(axes), static_cast<const float*>(projc),
      static_cast<const uint8_t*>(step_valid),
      static_cast<const float*>(obstacles),
      static_cast<const uint8_t*>(obs_valid), S, N, K, h0, h1, h2,
      static_cast<uint8_t*>(hits));
  return static_cast<int>(cudaGetLastError());
}
