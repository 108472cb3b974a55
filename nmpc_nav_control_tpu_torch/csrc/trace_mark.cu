// The phase mark of a traced tick, for Hopper (sm_90a), and the node count
// of a captured CUDA graph.
//
// Replaces no TPU kernel.  The tracing of utils/telemetry.py puts one
// launch of trace_mark_kernel into a CUDA graph at each phase mark of a tick
// captured while tracing is on (ops/trace_mark.py, nmpc_tpu::trace_mark),
// so that every replay records on the card when each phase began and ended.
//
// One thread reads the card's %globaltimer (nanoseconds), takes the next
// slot of a ring of B entries (B a power of two) by advancing the ring's
// 64-bit cursor with an atomic add, and writes the entry (code, ns): code =
// graph << 8 | phase, as the host packed it.  Marks enqueued on one stream
// run in the order enqueued, each after the work before it, so the cursor
// positions follow the host's enqueue order and the host, which counts the
// marks it enqueues, knows which replay wrote each entry.
//
// Bound: the launch, a few microseconds in a graph; 16 bytes written.
#include <cuda_runtime.h>

namespace {

__global__ void trace_mark_kernel(long long* ring, unsigned long long* cursor, int code,
                                  unsigned long long mask) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const unsigned long long at = atomicAdd(cursor, 1ULL) & mask;
  ring[2 * at] = code;
  ring[2 * at + 1] = static_cast<long long>(now);
}

}  // namespace

// p = {ring [B, 2] int64, cursor [1] int64}; N = code; B = the ring's entries.
extern "C" int trace_mark_ring(void* const* p, int n, int N, int B, float, float, void* s) {
  if (n != 2 || B <= 0 || (B & (B - 1)) != 0) return static_cast<int>(cudaErrorInvalidValue);
  trace_mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(s)>>>(
      static_cast<long long*>(p[0]), static_cast<unsigned long long*>(p[1]), N,
      static_cast<unsigned long long>(B) - 1ULL);
  return static_cast<int>(cudaGetLastError());
}

// The number of nodes of a captured graph (a cudaGraph_t).
extern "C" int graph_node_count(void* graph, size_t* count) {
  return static_cast<int>(cudaGraphGetNodes(static_cast<cudaGraph_t>(graph), nullptr, count));
}
