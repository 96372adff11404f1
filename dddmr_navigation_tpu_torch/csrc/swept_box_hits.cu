// Swept oriented-box collision test for a fleet of robots, on Hopper.
//
// Replaces the Pallas TPU kernel dddmr_navigation_tpu/ops/collision.py
// (_pallas_hits -> _pallas_kernel, public swept_box_hits). It computes, for
// robot b and rollout sample s, whether any valid obstacle p satisfies
// |axes[b,s,n,k] . p - projc[b,s,n,k]| <= half[k] for k = 0, 1, 2 at any step
// n with step_valid[b,s,n] set.
//
// What bounds it. At the 64-robot headline tick (289 samples, 40 steps, 128
// near obstacles) the function is 94.7 M point-box tests of 21 flops if every
// step is valid (2 GFLOP, 29.7 us at the card's 67 TFLOP/s f32) on 36 MB of
// inputs (10.8 us at 3.35 TB/s); the fused config-3 tick (1 robot, 8,192
// samples) is 41.9 M tests (13.1 us). Only the valid steps need testing, so
// a run's own bound is lower; navbench/bounds.py computes it from the run's
// data. The exact test cannot use FMA (the result must equal the plain
// version's bit for bit): in the SASS (cuobjdump -sass on the card) a kernel
// with one thread per row that runs every test spends 32 instructions a test
// (three shared loads, 9 FMUL, 9 FADD, the compares and the loop), so it is
// issue-bound at about three times the f32 bound whatever its schedule.
//
// What the design does about it: fewer exact tests. A warp owns a tile of
// 8 neighbouring samples x 4 consecutive steps, rows that lie close
// together in space (of the tiles 1x32, 2x16, 4x8 and 8x4, 8x4 took the
// least device time over the headline's and the fused tick's data;
// tools/kernel_variants.py). Each lane bounds its row's box by a sphere,
// the warp bounds its 32 spheres by one, and each lane then tests one
// obstacle of a 32-obstacle group against the warp's sphere (one FMA chain
// and a compare; about 32 instructions a group in the SASS);
// __ballot_sync collects the survivors, and only those go through the
// exact test, unchanged, for all 32 rows: 46 instructions a survivor, 24
// of them the test (one broadcast LDS.128, 9 FMUL, 9 FADD, 3 FSETP), the
// rest the loop over the ballot's bits. On the ticks' data 3-20 % of
// (row, obstacle) pairs survive (ops/collision.py::swept_box_cull_plain
// mirrors the cull). Once a row hits it stops;
// once a sample hits, the flag of that sample in shared memory stops the
// sample's other rows in the block.
//
// Why the cull is conservative. Write A for a row's 3x3 axes (rows a_k), c
// for its projc and h for the half extents, and x0 = A^T c. For any point
// p, p - x0 = (I - A^T A) p + A^T u with u = A p - c. With
// eta = ||A A^T - I||_F (>= ||I - A^T A||_2, since A A^T and A^T A have the
// same eigenvalues) and ||A||_2 <= sqrt(1 + eta):
//     |p - x0| <= (eta |x0| + sqrt(1 + eta) |u|) / (1 - eta).
// The exact test passes only if |u_k| <= h_k + e_k, where e_k, the rounding
// of the test itself, is below 4e-7 (|p| + 1) (three rounded products, two
// rounded sums and a rounded difference). So every hit lies within
//     R = (eta |x0| + sqrt(1 + eta) |h|) / (1 - eta) + kMarginAbs
//         + kMarginRel (|x0| + |h|)
// of x0. The margins, 1e-3 m and 1e-5 relative, are over ten times the sum
// of the test's rounding, the rounding of x0 and eta themselves, and that
// of the sphere test below; they also cover axes that are only nearly unit
// length and orthogonal, as the critic's are (critics.py's cuboid_box
// divides by rounded norms, and two rounded rotations follow). A row whose
// eta is not below 0.5, or whose numbers are not finite, gets R = inf: the
// warp then culls nothing. The warp's sphere is centered on the middle of
// its rows' x0 box and has radius max(|x0 - c_w| + R) (1 + 1e-5); a point is
// kept as keep = !(d2 > r2), so that it is dropped only when its squared
// distance from c_w exceeds the radius squared, and a NaN anywhere keeps it.
// The exact test never changes, so a kept point is judged exactly as
// before, and a dropped point lies outside every box of the warp.
//
// Every multiply and add of the exact test is rounded separately
// (__fmul_rn/__fadd_rn, and the build passes --fmad=false) in the plain
// version's order, so the hits equal the plain PyTorch version's bit for
// bit. The cull uses explicit fmaf, which --fmad=false leaves alone.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kFar = 1.0e9f;  // parking coordinate of invalid obstacles
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float dot3(float ax, float ay, float az, float x,
                                      float y, float z) {
  // (ax*x + ay*y) + az*z, each product and sum rounded on its own.
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, x), __fmul_rn(ay, y)),
                   __fmul_rn(az, z));
}

// The exact test of one point against one row's box, in the plain
// version's operation order.
__device__ __forceinline__ bool inside(const float (&a)[9], float c0, float c1,
                                       float c2, float h0, float h1, float h2,
                                       float x, float y, float z) {
  const bool in0 = fabsf(__fsub_rn(dot3(a[0], a[1], a[2], x, y, z), c0)) <= h0;
  const bool in1 = fabsf(__fsub_rn(dot3(a[3], a[4], a[5], x, y, z), c1)) <= h1;
  const bool in2 = fabsf(__fsub_rn(dot3(a[6], a[7], a[8], x, y, z), c2)) <= h2;
  return in0 && in1 && in2;
}

// ---------------------------------------------------------------------------
// The kernel: the warp's bounding-sphere cull, then the exact test on
// survivors.
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;                   // warps (tiles) per block
constexpr int kThreads = 32 * kWarps;
constexpr int kTileSamples = 8;             // a warp's tile: 8 samples
constexpr int kTileSteps = 4;               //   x 4 steps = 32 rows
constexpr int kChunk = 256;                 // obstacles staged at once
constexpr int kBlockSamples = kWarps * kTileSamples;  // flags per block
constexpr float kMarginAbs = 1.0e-3f;       // m
constexpr float kMarginRel = 1.0e-5f;       // of |x0| + |h|
constexpr float kMaxEta = 0.5f;             // rows further from orthonormal
                                            // disable the warp's cull

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__global__ void __launch_bounds__(kThreads)
swept_box_hits_kernel(const float* __restrict__ axes,          // (B,S,N,9)
                      const float* __restrict__ projc,         // (B,S,N,3)
                      const uint8_t* __restrict__ step_valid,  // (B,S,N)
                      const float* __restrict__ obstacles,     // (B,K,3)
                      const uint8_t* __restrict__ obs_valid,   // (B,K)
                      int S, int N, int K, float h0, float h1, float h2,
                      uint8_t* __restrict__ hits) {            // (B,S), zeroed
  __shared__ float4 pts[kChunk];
  __shared__ int done[kBlockSamples];  // per sample of the block: it hit

  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int step_tiles = (N + kTileSteps - 1) / kTileSteps;
  const int tile = blockIdx.x * kWarps + warp;
  const int s = (tile / step_tiles) * kTileSamples + lane / kTileSteps;
  const int n = (tile % step_tiles) * kTileSteps + lane % kTileSteps;
  // The block's tiles are consecutive, so they span at most kWarps sample
  // groups, starting at the first tile's.
  const int sample0 = (blockIdx.x * kWarps / step_tiles) * kTileSamples;
  const int ls = s - sample0;  // in [0, kBlockSamples)
  const size_t grow = (static_cast<size_t>(b) * S + s) * N + n;
  const bool active = s < S && n < N && step_valid[grow] != 0;
  if (threadIdx.x < kBlockSamples) done[threadIdx.x] = 0;

  float a[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float c0 = 0.f, c1 = 0.f, c2 = 0.f;
  if (active) {
#pragma unroll
    for (int i = 0; i < 9; ++i) a[i] = axes[grow * 9 + i];
    c0 = projc[grow * 3 + 0];
    c1 = projc[grow * 3 + 1];
    c2 = projc[grow * 3 + 2];
  }

  // The row's sphere: center x0 = A^T c, radius R (see the note above).
  const float x0 = fmaf(a[0], c0, fmaf(a[3], c1, a[6] * c2));
  const float y0 = fmaf(a[1], c0, fmaf(a[4], c1, a[7] * c2));
  const float z0 = fmaf(a[2], c0, fmaf(a[5], c1, a[8] * c2));
  const float g00 = fmaf(a[0], a[0], fmaf(a[1], a[1], a[2] * a[2])) - 1.f;
  const float g11 = fmaf(a[3], a[3], fmaf(a[4], a[4], a[5] * a[5])) - 1.f;
  const float g22 = fmaf(a[6], a[6], fmaf(a[7], a[7], a[8] * a[8])) - 1.f;
  const float g01 = fmaf(a[0], a[3], fmaf(a[1], a[4], a[2] * a[5]));
  const float g02 = fmaf(a[0], a[6], fmaf(a[1], a[7], a[2] * a[8]));
  const float g12 = fmaf(a[3], a[6], fmaf(a[4], a[7], a[5] * a[8]));
  const float eta = sqrtf(fmaf(g00, g00, fmaf(g11, g11, g22 * g22))
                          + 2.f * fmaf(g01, g01, fmaf(g02, g02, g12 * g12)));
  const float hn = sqrtf(fmaf(h0, h0, fmaf(h1, h1, h2 * h2)));
  const float xn = sqrtf(fmaf(x0, x0, fmaf(y0, y0, z0 * z0)));
  float radius = (eta * xn + sqrtf(1.f + eta) * hn) / (1.f - eta)
                 + kMarginAbs + kMarginRel * (xn + hn);
  if (!(eta < kMaxEta)) radius = INFINITY;

  // The warp's sphere around its valid rows' spheres.
  const float lox = warp_min(active ? x0 : INFINITY);
  const float loy = warp_min(active ? y0 : INFINITY);
  const float loz = warp_min(active ? z0 : INFINITY);
  const float hix = warp_max(active ? x0 : -INFINITY);
  const float hiy = warp_max(active ? y0 : -INFINITY);
  const float hiz = warp_max(active ? z0 : -INFINITY);
  const float wx = 0.5f * (lox + hix), wy = 0.5f * (loy + hiy),
              wz = 0.5f * (loz + hiz);
  const float dx0 = x0 - wx, dy0 = y0 - wy, dz0 = z0 - wz;
  float reach = sqrtf(fmaf(dx0, dx0, fmaf(dy0, dy0, dz0 * dz0))) + radius;
  if (!(reach <= 3.0e38f)) reach = INFINITY;  // NaN or inf: cull nothing
  const float wr = warp_max(active ? reach : -INFINITY) * (1.f + 1.0e-5f);
  const float wr2 = wr * wr;

  const float* obs = obstacles + static_cast<size_t>(b) * K * 3;
  const uint8_t* ovalid = obs_valid + static_cast<size_t>(b) * K;
  volatile int* vdone = done;
  bool hit = false;
  for (int base = 0; base < K; base += kChunk) {
    const int cnt = min(kChunk, K - base);
    __syncthreads();  // the previous chunk is no longer read; flags zeroed
    for (int i = threadIdx.x; i < cnt; i += kThreads) {
      const bool ok = ovalid[base + i] != 0;
      pts[i] = ok ? make_float4(obs[(base + i) * 3 + 0],
                                obs[(base + i) * 3 + 1],
                                obs[(base + i) * 3 + 2], 0.f)
                  : make_float4(kFar, kFar, kFar, 0.f);
    }
    __syncthreads();
    bool live = active && !hit && vdone[ls] == 0;
    if (!__any_sync(kFull, live)) continue;  // warp-uniform
    for (int j0 = 0; j0 < cnt; j0 += 32) {
      bool keep = false;
      if (j0 + lane < cnt) {
        const float4 p = pts[j0 + lane];
        const float dx = p.x - wx, dy = p.y - wy, dz = p.z - wz;
        keep = !(fmaf(dx, dx, fmaf(dy, dy, dz * dz)) > wr2);
      }
      unsigned mask = __ballot_sync(kFull, keep);
      while (mask != 0u) {
        const int k = __ffs(mask) - 1;
        mask &= mask - 1u;
        const float4 p = pts[j0 + k];
        if (live && inside(a, c0, c1, c2, h0, h1, h2, p.x, p.y, p.z)) {
          hit = true;
          live = false;
          vdone[ls] = 1;
        }
      }
      live = live && vdone[ls] == 0;
      if (!__any_sync(kFull, live)) break;  // warp-uniform
    }
  }
  // Every writer stores the same value, so concurrent stores are benign.
  if (hit) hits[static_cast<size_t>(b) * S + s] = 1;
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
  const long long tiles =
      static_cast<long long>((S + kTileSamples - 1) / kTileSamples) *
      ((N + kTileSteps - 1) / kTileSteps);
  const dim3 grid(static_cast<unsigned>((tiles + kWarps - 1) / kWarps), B);
  swept_box_hits_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(axes), static_cast<const float*>(projc),
      static_cast<const uint8_t*>(step_valid),
      static_cast<const float*>(obstacles),
      static_cast<const uint8_t*>(obs_valid), S, N, K, h0, h1, h2,
      static_cast<uint8_t*>(hits));
  return static_cast<int>(cudaGetLastError());
}
