// The global planner's successor-table walk for a fleet of robots, on
// Hopper.
//
// Replaces no Pallas kernel: it is the JAX package's lax.scan over the
// successor table (dddmr_navigation_tpu/planning/global_/wavefront.py:416),
// which the port's plain version runs as one gather a step
// (ops/walk.py::walk_table_plain). For robot b it emits the start node,
// then follows e <- succ[b, e] from e0[b], emitting node_of[e] at each
// state, until the first terminal state (stuck[b, e], or node_of[e] is the
// goal) or max_len slots. Slot 0 is terminal when the start is the goal or
// its first hop is impossible (stuck0). Past the stop every slot holds the
// final node and is not valid; with no stop, length = max_len and the
// final node is the last slot's.
//
// What bounds it: dependent-load latency. Each hop's address is the value
// the previous hop loaded, so a walk of n hops is n round trips to memory,
// one after the other. The table was written by the extraction's argmin
// just before (B x S int64: 0.3 MB at robot8k, 9.9 MB at fleet64), so it
// sits in the 50 MB L2, and a hop costs one L2 round trip, some hundreds
// of cycles. The bytes (17 a hop) and the operations (two compares a hop)
// are nothing beside it; a 200-hop path is tens of microseconds, the
// longest walk (max_len - 1 = 511 hops) about a hundred.
//
// What the design does about it:
//  * one block per robot, so the robots' chains run side by side;
//  * one thread chases the chain and issues a hop's three loads (succ,
//    stuck, node_of) together, before it tests the state, so a hop costs
//    one round trip; the terminal test is made on the fly, so the plain
//    version's self-looped copy of the table (a B x S where) is never
//    built;
//  * the walk ends at the first terminal state: the plain walk self-loops
//    there, so every later slot repeats it, and the work follows each
//    path's length instead of max_len;
//  * the emitted nodes go to shared memory (max_len x 8 B), and the whole
//    block then writes idxs, valids, length and final, consecutive threads
//    on consecutive slots.
// More threads on one chain cannot shorten it: hop k + 1 needs hop k's
// value. Pointer doubling would read the whole table log2(max_len) = 9
// times to save round trips that cost less than one such pass.
//
// Integers only: the outputs equal the plain version's bit for bit.
// Precondition, as for the plain version's gathers: every entry of succ
// and e0 lies in [0, S).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// A load issued where it stands. The successor is needed only past the
// hop's terminal test, so ptxas moves a plain load of it (even one written
// as inline PTX) behind that test's branch, and a hop then costs two round
// trips, one after the other. A volatile access is made where the program
// makes it, on both sides of the branch, so it stays before the test.
__device__ __forceinline__ int64_t load_now(const int64_t* p) {
  return *static_cast<const volatile int64_t*>(p);
}

__global__ void __launch_bounds__(kThreads)
walk_table_kernel(const int64_t* __restrict__ succ,      // (B, S)
                  const uint8_t* __restrict__ stuck,     // (B, S)
                  const int64_t* __restrict__ e0,        // (B,)
                  const uint8_t* __restrict__ stuck0,    // (B,)
                  const int64_t* __restrict__ node_of,   // (S,)
                  const int64_t* __restrict__ start,     // (B,)
                  const int64_t* __restrict__ goal,      // (B,)
                  int S, int L,
                  int64_t* __restrict__ idxs,            // (B, L)
                  uint8_t* __restrict__ valids,          // (B, L)
                  int64_t* __restrict__ length,          // (B,)
                  int64_t* __restrict__ final_node) {    // (B,)
  extern __shared__ int64_t nodes[];  // nodes[i]: the node of slot i
  __shared__ int stop_slot;           // the last valid slot

  const int b = blockIdx.x;
  if (threadIdx.x == 0) {
    const int64_t g = goal[b];
    const int64_t s0 = start[b];
    nodes[0] = s0;
    int stop = 0;
    if (s0 != g && stuck0[b] == 0) {
      const int64_t* row = succ + static_cast<size_t>(b) * S;
      const uint8_t* row_stuck = stuck + static_cast<size_t>(b) * S;
      int64_t e = e0[b];
      stop = L - 1;
      for (int i = 1; i < L; ++i) {
        // the hop's three loads, issued together before its test
        const int64_t next = load_now(row + e);
        const int64_t node = node_of[e];
        const bool term = row_stuck[e] != 0 || node == g;
        nodes[i] = node;
        if (term) {
          stop = i;
          break;
        }
        e = next;
      }
    }
    stop_slot = stop;
  }
  __syncthreads();

  const int stop = stop_slot;
  const int64_t fin = nodes[stop];
  int64_t* out = idxs + static_cast<size_t>(b) * L;
  uint8_t* out_valid = valids + static_cast<size_t>(b) * L;
  for (int i = threadIdx.x; i < L; i += kThreads) {
    const bool v = i <= stop;
    out[i] = v ? nodes[i] : fin;
    out_valid[i] = v;
  }
  if (threadIdx.x == 0) {
    length[b] = stop + 1;
    final_node[b] = fin;
  }
}

}  // namespace

// Launches on `stream`. Returns the launch's cudaError_t (0 on success).
extern "C" int walk_table_launch(const void* succ, const void* stuck,
                                 const void* e0, const void* stuck0,
                                 const void* node_of, const void* start,
                                 const void* goal, int B, int S, int L,
                                 void* idxs, void* valids, void* length,
                                 void* final_node, void* stream) {
  if (B == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  walk_table_kernel<<<B, kThreads, static_cast<size_t>(L) * sizeof(int64_t),
                      s>>>(
      static_cast<const int64_t*>(succ), static_cast<const uint8_t*>(stuck),
      static_cast<const int64_t*>(e0), static_cast<const uint8_t*>(stuck0),
      static_cast<const int64_t*>(node_of),
      static_cast<const int64_t*>(start), static_cast<const int64_t*>(goal),
      S, L, static_cast<int64_t*>(idxs), static_cast<uint8_t*>(valids),
      static_cast<int64_t*>(length), static_cast<int64_t*>(final_node));
  return static_cast<int>(cudaGetLastError());
}
