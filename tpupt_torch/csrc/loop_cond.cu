// The wavefront's loop on the card: the condition kernel of a stage, and the launch's
// graph of CUDA conditional WHILE nodes that runs it.
//
// Replaces the condition of the reference's compaction stages, each a lax.while_loop
// that XLA runs on the device (tpupt/render/integrator.py:306-322): a stage iterates
// while lanes with work are left and more of them than the stage's threshold.
//   inputs  alive [n] bool, sample [n] i32, sample0 [n] i32 (the stage's state), k,
//           spp_limit, thr; a lane has work when alive | (sample < k & sample0 + sample
//           < spp_limit), as in render/integrator.py's work_mask.
//   outputs out [2] i64: the lanes with work, and go = (that count > thr); iters [1] i64
//           is bumped when bump != 0 (the body of the stage just ran once). Inside a
//           graph the kernel also sets the WHILE node's condition to go.
//
// Bound. It reads 9 bytes a lane and writes 24 bytes: 3.2 MB at the Cornell launch's
// 360000 lanes, about 1 us at the card's 3.35 TB/s. Design: one pass over the lanes by
// a grid of at most two blocks an SM, a warp-shuffle sum in each block, one atomic add
// a block; the last block to finish (a ticket counter) reads the total, decides, bumps
// the counter, resets the scratch for the next launch and sets the condition. So the
// decision costs one kernel and no trip to the host.
//
// The graph. A launch is a chain in one CUDA graph: for each stage, this kernel once
// (the WHILE node's first value: lax.while_loop tests its condition before the first
// body), then a WHILE node whose body is the stage's captured iteration (a child graph,
// captured by PyTorch on one stream) followed by this kernel with bump = 1; between the
// stages, the captured compaction (a child graph). The host launches the chain once and
// reads its counters once (render/graph.py).

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

struct CondArgs {
  const unsigned char* alive;
  const int* sample;
  const int* sample0;
  int n, k, spp_limit, thr;
  unsigned int* scratch;  // [2]: lanes with work so far, blocks done; zero between launches
  long long* iters;       // the stage's iteration counter
  long long* out;         // [2]: lanes with work, go
  int bump;
};

__global__ void __launch_bounds__(THREADS)
stage_cond_kernel(CondArgs a, cudaGraphConditionalHandle handle, int set_handle) {
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
  const unsigned int total = atomicExch(&a.scratch[0], 0u);
  a.scratch[1] = 0u;
  const bool go = static_cast<long long>(total) > static_cast<long long>(a.thr);
  if (a.bump) *a.iters += 1;
  a.out[0] = total;
  a.out[1] = go ? 1 : 0;
  if (set_handle) cudaGraphSetConditional(handle, go ? 1u : 0u);
}

int blocks_for(int n) {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
    sms = 132;
  }
  return std::max(1, std::min(2 * sms, (n + THREADS - 1) / THREADS));
}

CondArgs make_args(const unsigned char* alive, const int* sample, const int* sample0, int n,
                   int k, int spp_limit, int thr, unsigned int* scratch, long long* iters,
                   long long* out, int bump) {
  return CondArgs{alive, sample, sample0, n, k, spp_limit, thr, scratch, iters, out, bump};
}

// The launch's graph: a chain of nodes, `last` the node the next one follows.
struct LoopGraph {
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
  cudaGraphNode_t last = nullptr;
};

cudaError_t add_cond_node(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* deps,
                          size_t n_deps, CondArgs a, cudaGraphConditionalHandle handle) {
  int set_handle = 1;
  void* params[] = {&a, &handle, &set_handle};
  cudaKernelNodeParams kp = {};
  kp.func = reinterpret_cast<void*>(stage_cond_kernel);
  kp.gridDim = dim3(blocks_for(a.n));
  kp.blockDim = dim3(THREADS);
  kp.sharedMemBytes = 0;
  kp.kernelParams = params;  // copied into the node
  kp.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, deps, n_deps, &kp);
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

// The condition kernel launched on its own (no graph): the tests' and chip_smoke.py's
// comparison with its plain version.
extern "C" int tpupt_stage_cond(const unsigned char* alive, const int* sample, const int* sample0,
                                int n, int k, int spp_limit, int thr, unsigned int* scratch,
                                long long* iters, long long* out, int bump, void* stream) {
  if (n < 0 || thr < 0) return static_cast<int>(cudaErrorInvalidValue);
  const CondArgs a = make_args(alive, sample, sample0, n, k, spp_limit, thr, scratch, iters, out, bump);
  stage_cond_kernel<<<blocks_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a, 0, 0);
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

// Append a stage: the condition kernel, then a WHILE node whose body is a copy of `body`
// followed by the condition kernel with bump = 1.
extern "C" int tpupt_loop_graph_add_while(void* handle, void* body, const unsigned char* alive,
                                          const int* sample, const int* sample0, int n, int k,
                                          int spp_limit, int thr, unsigned int* scratch,
                                          long long* iters, long long* out) {
  LoopGraph* g = static_cast<LoopGraph*>(handle);
  if (n < 0 || thr < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaGraphConditionalHandle cond;
  cudaError_t err = cudaGraphConditionalHandleCreate(&cond, g->graph, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  CondArgs a = make_args(alive, sample, sample0, n, k, spp_limit, thr, scratch, iters, out, 0);
  cudaGraphNode_t first;
  err = add_cond_node(&first, g->graph, g->last ? &g->last : nullptr, g->last ? 1 : 0, a, cond);
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
  err = cudaGraphAddChildGraphNode(&step, body_graph, nullptr, 0, static_cast<cudaGraph_t>(body));
  if (err != cudaSuccess) return static_cast<int>(err);
  a.bump = 1;
  cudaGraphNode_t again;
  err = add_cond_node(&again, body_graph, &step, 1, a, cond);
  if (err != cudaSuccess) return static_cast<int>(err);
  g->last = loop;
  return 0;
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
