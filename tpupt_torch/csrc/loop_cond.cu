// The wavefront's loop on the card: the condition kernels of its loops, and the graph of
// CUDA conditional WHILE nodes that runs them.
//
// K5 replaces the conditions that XLA runs on the device in the reference: those of the
// render's compaction stages, each a lax.while_loop (tpupt/render/integrator.py:306-322),
// and those of the gradient pass (tpupt/render/diff.py:232-248), a lax.scan of segments
// of trips, each gated by lax.cond(has_work, ...), whose VJP walks the trips backwards.
// A lane has work when alive | (sample < k & sample0 + sample < spp_limit), as in
// render/integrator.py's work_mask. Three conditions:
//   stage     (cond_kernel, MODE_STAGE) a stage iterates while the lanes with work are
//             more than its threshold thr: go = (count > thr); iters [1] i64 is bumped when
//             bump != 0 (the body of the stage just ran once).
//   gate      (cond_kernel, MODE_GATE) a forward trip of the gradient pass: bump adds one to
//             the trip counter trips [1] i64; then go = trips < cap & trips < chunk[1] &
//             (trips % segment != 0 | count > 0): inside a segment the trips go on, at a
//             segment boundary only while some lane has work (lax.cond's has_work), and
//             they stop at the cap (every segment run) and at the end of the chunk of
//             trips that the staging buffer holds (render/diff.py).
//   countdown (countdown_kernel) a backward trip: bump takes one from the trip index and
//             adds one to the replay counter; go = index >= chunk[0], the chunk's first trip.
// Outputs out [2] i64: the lanes with work and go (stage, gate); the index and go
// (countdown). Inside a graph the kernel also sets the WHILE node's condition to go. A
// stage also adds the lanes with work to its sum work [1] i64 whenever go is 1: over a
// launch, the lanes with work summed over the iterations the stage ran.
//
// Stamps (stamp_kernel, one thread): the card's clock (%globaltimer, ns) into a slot of a
// device buffer, at a fixed slot or at a device cursor that it advances. The chains take
// them as kernel nodes (tpupt_loop_graph_add_stamp): the render's at its head, after each
// stage's WHILE node and after the film; the gradient pass's at the head and the tail of
// each chain. They ride in the host reads the chains have anyway (render/graph.py).
//
// Bound. A work count reads 9 bytes a lane and writes 24 bytes: 3.2 MB at the Cornell
// launch's 360000 lanes, about 1 us at the card's 3.35 TB/s. Design: one pass over the
// lanes by a grid of at most two blocks an SM, a warp-shuffle sum in each block, one
// atomic add a block; the last block to finish (a ticket counter) reads the total,
// decides, bumps the counter, resets the scratch for the next launch and sets the
// condition. So the decision costs one kernel and no trip to the host. The countdown
// reads and writes a few words: one thread.
//
// The graph. A launch is a chain in one CUDA graph: for each loop, its condition kernel
// once (the WHILE node's first value: lax.while_loop and lax.cond test before the first
// body), then a WHILE node whose body is the loop's captured step (a child graph,
// captured by PyTorch on one stream) followed by the condition kernel with bump = 1;
// between the render's stages, the captured compaction (a child graph). The host
// launches the chain once and reads its counters once (render/graph.py).

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MODE_STAGE = 0;
constexpr int MODE_GATE = 1;

struct CondArgs {
  const unsigned char* alive;
  const int* sample;
  const int* sample0;
  int n, k, spp_limit, thr;
  unsigned int* scratch;   // [2]: lanes with work so far, blocks done; zero between launches
  long long* iters;        // stage: its iteration counter; gate: the trip counter
  long long* work;         // stage: its sum of lanes with work over go decisions (may be null)
  long long* out;          // [2]: lanes with work, go
  int bump;
  int mode;                // MODE_STAGE or MODE_GATE
  int segment;             // gate: trips a segment
  long long cap;           // gate: the most trips
  const long long* chunk;  // gate: [2] the chunk's first trip and its end
};

struct CountdownArgs {
  long long* index;        // the trip to replay next
  const long long* chunk;  // [2] the chunk's first trip and its end
  long long* replays;      // trips replayed
  long long* out;          // [2]: the index, go
  int bump;
};

__global__ void __launch_bounds__(THREADS)
cond_kernel(CondArgs a, cudaGraphConditionalHandle handle, int set_handle) {
  unsigned int count = 0;
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < a.n; i += gridDim.x * THREADS) {
    const int s = a.sample[i];
    count += (a.alive[i] != 0 || (s < a.k && a.sample0[i] + s < a.spp_limit)) ? 1u : 0u;
  }
  for (int off = 16; off > 0; off >>= 1) count += __shfl_down_sync(0xffffffffu, count, off);
  __shared__ unsigned int warp_sums[WARPS];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int block = 0;
    for (int w = 0; w < WARPS; ++w) block += warp_sums[w];
    atomicAdd(&a.scratch[0], block);
    __threadfence();  // the sum lands before the ticket
    last = atomicAdd(&a.scratch[1], 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last || threadIdx.x != 0) return;
  __threadfence();
  const long long total = atomicExch(&a.scratch[0], 0u);
  a.scratch[1] = 0u;
  if (a.bump) *a.iters += 1;
  bool go;
  if (a.mode == MODE_GATE) {
    const long long t = *a.iters;
    go = t < a.cap && t < a.chunk[1] && (t % a.segment != 0 || total > 0);
  } else {
    go = total > static_cast<long long>(a.thr);
    if (go && a.work) *a.work += total;
  }
  a.out[0] = total;
  a.out[1] = go ? 1 : 0;
  if (set_handle) cudaGraphSetConditional(handle, go ? 1u : 0u);
}

__global__ void countdown_kernel(CountdownArgs a, cudaGraphConditionalHandle handle, int set_handle) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  if (a.bump) {
    *a.index -= 1;
    *a.replays += 1;
  }
  const long long j = *a.index;
  const bool go = j >= a.chunk[0];
  a.out[0] = j;
  a.out[1] = go ? 1 : 0;
  if (set_handle) cudaGraphSetConditional(handle, go ? 1u : 0u);
}

// The card's clock into slots[slot]; with a cursor, into slots[*cursor] (dropped at n or
// past it) and the cursor advanced.
__global__ void stamp_kernel(long long* slots, int slot, long long* cursor, int n) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  if (cursor == nullptr) {
    slots[slot] = static_cast<long long>(t);
    return;
  }
  const long long i = *cursor;
  if (i < n) slots[i] = static_cast<long long>(t);
  *cursor = i + 1;
}

int blocks_for(int n) {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
    sms = 132;
  }
  return std::max(1, std::min(2 * sms, (n + THREADS - 1) / THREADS));
}

CondArgs stage_args(const unsigned char* alive, const int* sample, const int* sample0, int n, int k,
                    int spp_limit, int thr, unsigned int* scratch, long long* iters, long long* work,
                    long long* out, int bump) {
  return CondArgs{alive, sample, sample0, n, k, spp_limit, thr, scratch, iters, work, out, bump,
                  MODE_STAGE, 1, 0, nullptr};
}

CondArgs gate_args(const unsigned char* alive, const int* sample, const int* sample0, int n, int k,
                   int spp_limit, int segment, long long cap, long long* trips, const long long* chunk,
                   unsigned int* scratch, long long* out, int bump) {
  return CondArgs{alive, sample, sample0, n, k, spp_limit, 0, scratch, trips, nullptr, out, bump,
                  MODE_GATE, segment, cap, chunk};
}

// The launch's graph: a chain of nodes, `last` the node the next one follows.
struct LoopGraph {
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
  cudaGraphNode_t last = nullptr;
};

cudaError_t add_kernel_node(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* deps,
                            size_t n_deps, void* func, int blocks, int threads, void** params) {
  cudaKernelNodeParams kp = {};
  kp.func = func;
  kp.gridDim = dim3(blocks);
  kp.blockDim = dim3(threads);
  kp.sharedMemBytes = 0;
  kp.kernelParams = params;  // copied into the node
  kp.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, deps, n_deps, &kp);
}

// The condition kernel of a stage or a gate as a graph node, its bump set to `bump`.
struct AddCond {
  CondArgs a;
  cudaError_t operator()(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* deps,
                         size_t n_deps, int bump, cudaGraphConditionalHandle handle) const {
    CondArgs args = a;
    args.bump = bump;
    int set_handle = 1;
    void* params[] = {&args, &handle, &set_handle};
    return add_kernel_node(node, graph, deps, n_deps, reinterpret_cast<void*>(cond_kernel),
                           blocks_for(args.n), THREADS, params);
  }
};

struct AddCountdown {
  CountdownArgs a;
  cudaError_t operator()(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* deps,
                         size_t n_deps, int bump, cudaGraphConditionalHandle handle) const {
    CountdownArgs args = a;
    args.bump = bump;
    int set_handle = 1;
    void* params[] = {&args, &handle, &set_handle};
    return add_kernel_node(node, graph, deps, n_deps, reinterpret_cast<void*>(countdown_kernel), 1, 32,
                           params);
  }
};

// Append a loop to the chain: its condition (bump = 0), then a WHILE node whose body is a
// copy of `body` followed by the condition with bump = 1.
template <typename Cond>
int add_while(LoopGraph* g, cudaGraph_t body, const Cond& add_cond) {
  cudaGraphConditionalHandle cond;
  cudaError_t err = cudaGraphConditionalHandleCreate(&cond, g->graph, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNode_t first;
  err = add_cond(&first, g->graph, g->last ? &g->last : nullptr, g->last ? 1 : 0, 0, cond);
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = cond;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t loop;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&loop, g->graph, &first, nullptr, 1, &params);
#else
  err = cudaGraphAddNode(&loop, g->graph, &first, 1, &params);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraph_t body_graph = params.conditional.phGraph_out[0];
  cudaGraphNode_t step;
  err = cudaGraphAddChildGraphNode(&step, body_graph, nullptr, 0, body);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNode_t again;
  err = add_cond(&again, body_graph, &step, 1, 1, cond);
  if (err != cudaSuccess) return static_cast<int>(err);
  g->last = loop;
  return 0;
}

int census(cudaGraph_t graph, int* counts, int n_types) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n];
  err = cudaGraphGetNodes(graph, nodes, &n);
  for (size_t i = 0; err == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    if (err != cudaSuccess) break;
    const int t = static_cast<int>(type);
    if (t >= 0 && t < n_types) counts[t] += 1;
    if (type == cudaGraphNodeTypeGraph) {
      cudaGraph_t child = nullptr;
      err = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (err == cudaSuccess) err = static_cast<cudaError_t>(census(child, counts, n_types));
    }
  }
  delete[] nodes;
  return static_cast<int>(err);
}

}  // namespace

// The condition kernels launched on their own (no graph): the tests' and chip_smoke.py's
// comparisons with their plain versions, and the gradient pass's eager first trips.
extern "C" int tpupt_stage_cond(const unsigned char* alive, const int* sample, const int* sample0,
                                int n, int k, int spp_limit, int thr, unsigned int* scratch,
                                long long* iters, long long* work, long long* out, int bump,
                                void* stream) {
  if (n < 0 || thr < 0) return static_cast<int>(cudaErrorInvalidValue);
  const CondArgs a = stage_args(alive, sample, sample0, n, k, spp_limit, thr, scratch, iters, work, out,
                                bump);
  cond_kernel<<<blocks_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a, 0, 0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpupt_grad_gate(const unsigned char* alive, const int* sample, const int* sample0, int n,
                               int k, int spp_limit, int segment, long long cap, long long* trips,
                               const long long* chunk, unsigned int* scratch, long long* out, int bump,
                               void* stream) {
  if (n < 0 || segment < 1) return static_cast<int>(cudaErrorInvalidValue);
  const CondArgs a = gate_args(alive, sample, sample0, n, k, spp_limit, segment, cap, trips, chunk, scratch,
                               out, bump);
  cond_kernel<<<blocks_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a, 0, 0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpupt_grad_countdown(long long* index, const long long* chunk, long long* replays,
                                    long long* out, int bump, void* stream) {
  const CountdownArgs a{index, chunk, replays, out, bump};
  countdown_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(a, 0, 0);
  return static_cast<int>(cudaGetLastError());
}

// The stamp kernel launched on its own: the clock's calibration against the host's.
extern "C" int tpupt_stamp(long long* slots, int slot, void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(slots, slot, nullptr, 0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpupt_loop_graph_create(void** out) {
  LoopGraph* g = new LoopGraph();
  const cudaError_t err = cudaGraphCreate(&g->graph, 0);
  if (err != cudaSuccess) {
    delete g;
    return static_cast<int>(err);
  }
  *out = g;
  return 0;
}

// Append a copy of `child` (a captured graph) to the chain.
extern "C" int tpupt_loop_graph_add_child(void* handle, void* child) {
  LoopGraph* g = static_cast<LoopGraph*>(handle);
  cudaGraphNode_t node;
  const cudaError_t err = cudaGraphAddChildGraphNode(&node, g->graph, g->last ? &g->last : nullptr,
                                                     g->last ? 1 : 0, static_cast<cudaGraph_t>(child));
  if (err == cudaSuccess) g->last = node;
  return static_cast<int>(err);
}

// Append a stamp: the card's clock into slots[slot], or with a cursor (non-null) into
// slots[*cursor] (n slots) and the cursor advanced.
extern "C" int tpupt_loop_graph_add_stamp(void* handle, long long* slots, int slot, long long* cursor,
                                          int n) {
  LoopGraph* g = static_cast<LoopGraph*>(handle);
  if (slot < 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  void* params[] = {&slots, &slot, &cursor, &n};
  cudaGraphNode_t node;
  const cudaError_t err = add_kernel_node(&node, g->graph, g->last ? &g->last : nullptr, g->last ? 1 : 0,
                                          reinterpret_cast<void*>(stamp_kernel), 1, 1, params);
  if (err == cudaSuccess) g->last = node;
  return static_cast<int>(err);
}

// Append a render stage: a WHILE node over `body` under the stage condition.
extern "C" int tpupt_loop_graph_add_while(void* handle, void* body, const unsigned char* alive,
                                          const int* sample, const int* sample0, int n, int k,
                                          int spp_limit, int thr, unsigned int* scratch,
                                          long long* iters, long long* work, long long* out) {
  if (n < 0 || thr < 0) return static_cast<int>(cudaErrorInvalidValue);
  return add_while(static_cast<LoopGraph*>(handle), static_cast<cudaGraph_t>(body),
                   AddCond{stage_args(alive, sample, sample0, n, k, spp_limit, thr, scratch, iters, work,
                                      out, 0)});
}

// Append the gradient pass's forward trips: a WHILE node over `body` under the gate.
extern "C" int tpupt_loop_graph_add_gate_while(void* handle, void* body, const unsigned char* alive,
                                               const int* sample, const int* sample0, int n, int k,
                                               int spp_limit, int segment, long long cap, long long* trips,
                                               const long long* chunk, unsigned int* scratch,
                                               long long* out) {
  if (n < 0 || segment < 1) return static_cast<int>(cudaErrorInvalidValue);
  return add_while(static_cast<LoopGraph*>(handle), static_cast<cudaGraph_t>(body),
                   AddCond{gate_args(alive, sample, sample0, n, k, spp_limit, segment, cap, trips, chunk,
                                     scratch, out, 0)});
}

// Append the gradient pass's backward trips: a WHILE node over `body` under the countdown.
extern "C" int tpupt_loop_graph_add_countdown_while(void* handle, void* body, long long* index,
                                                    const long long* chunk, long long* replays,
                                                    long long* out) {
  return add_while(static_cast<LoopGraph*>(handle), static_cast<cudaGraph_t>(body),
                   AddCountdown{CountdownArgs{index, chunk, replays, out, 0}});
}

extern "C" int tpupt_loop_graph_instantiate(void* handle) {
  LoopGraph* g = static_cast<LoopGraph*>(handle);
  if (g->exec) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGraphInstantiate(&g->exec, g->graph, 0));
}

extern "C" int tpupt_loop_graph_launch(void* handle, void* stream) {
  LoopGraph* g = static_cast<LoopGraph*>(handle);
  if (!g->exec) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGraphLaunch(g->exec, static_cast<cudaStream_t>(stream)));
}

extern "C" int tpupt_loop_graph_destroy(void* handle) {
  LoopGraph* g = static_cast<LoopGraph*>(handle);
  cudaError_t err = cudaSuccess;
  if (g->exec) err = cudaGraphExecDestroy(g->exec);
  if (g->graph) {
    const cudaError_t e = cudaGraphDestroy(g->graph);
    if (err == cudaSuccess) err = e;
  }
  delete g;
  return static_cast<int>(err);
}

// Nodes of `graph` (a cudaGraph_t) by cudaGraphNodeType, child graphs' nodes included:
// counts[type] += 1 for each type below n_types.
extern "C" int tpupt_graph_census(void* graph, int* counts, int n_types) {
  return census(static_cast<cudaGraph_t>(graph), counts, n_types);
}

extern "C" const char* tpupt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
