// stamp -- a device timestamp at a span's boundary inside the training
// step, and the census of a captured step's graph.
//
// No TPU kernel is replaced: the JAX package reads its step's layers from
// the XLA profiler's trace. On the card the device loop replays the whole
// step as one CUDA graph, which carries none of the host's record_function
// spans; a stamp is a node of that graph, so every replay records where
// each span began and ended on the device.
//
// What it computes: stamps[counter[0] * n_slots + slot] = %globaltimer (the
// device's nanosecond clock), one thread of one block. The row is the
// device loop's step counter, read on the device at the replay, so each
// replayed step writes its own row; the slot is fixed at the capture.
//
// What bounds it on an H100: launch latency (one 8-byte read and one
// 8-byte write). Its cost is one more node on the graph's chain per span
// boundary, ~1-2 us of a step.
//
// bs_graph_size and bs_graph_census list a captured graph's nodes (type,
// and the slot of a stamp node) and edges; bs_graph_drop_stamps takes
// stamp nodes out of it before it is instantiated (a stamp with no work
// since the one before it reads what that one reads), joining each of
// their predecessors to each of their successors. The stamp kernel is
// recognised by its function, which this library's runtime registered, so
// these run here.
#include <cuda_runtime.h>

#include <unordered_map>
#include <vector>

namespace {

__device__ __forceinline__ long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}

__global__ void stamp_kernel(long long* __restrict__ stamps,
                             const long long* __restrict__ counter, int rows,
                             int n_slots, int slot) {
  const long long t = globaltimer();
  const long long row = *counter;
  if (row >= 0 && row < rows) stamps[row * n_slots + slot] = t;
}

cudaError_t graph_edges(cudaGraph_t g, cudaGraphNode_t* from,
                        cudaGraphNode_t* to, size_t* n) {
#if CUDART_VERSION >= 13000
  return cudaGraphGetEdges(g, from, to, nullptr, n);
#else
  return cudaGraphGetEdges(g, from, to, n);
#endif
}

cudaError_t node_deps(cudaGraphNode_t v, cudaGraphNode_t* out, size_t* n) {
#if CUDART_VERSION >= 13000
  return cudaGraphNodeGetDependencies(v, out, nullptr, n);
#else
  return cudaGraphNodeGetDependencies(v, out, n);
#endif
}

cudaError_t node_users(cudaGraphNode_t v, cudaGraphNode_t* out, size_t* n) {
#if CUDART_VERSION >= 13000
  return cudaGraphNodeGetDependentNodes(v, out, nullptr, n);
#else
  return cudaGraphNodeGetDependentNodes(v, out, n);
#endif
}

cudaError_t add_edge(cudaGraph_t g, cudaGraphNode_t a, cudaGraphNode_t b) {
#if CUDART_VERSION >= 13000
  return cudaGraphAddDependencies(g, &a, &b, nullptr, 1);
#else
  return cudaGraphAddDependencies(g, &a, &b, 1);
#endif
}

cudaError_t neighbours(cudaGraphNode_t v, bool users,
                       std::vector<cudaGraphNode_t>* out) {
  size_t n = 0;
  cudaError_t err = users ? node_users(v, nullptr, &n)
                          : node_deps(v, nullptr, &n);
  if (err != cudaSuccess) return err;
  out->resize(n);
  return users ? node_users(v, out->data(), &n)
               : node_deps(v, out->data(), &n);
}

// a kernel node's stamp slot, -1 for any other kernel (one another runtime
// registered may not resolve here: it is no stamp, and its error is
// cleared)
int stamp_slot(cudaGraphNode_t v) {
  cudaKernelNodeParams p;
  if (cudaGraphKernelNodeGetParams(v, &p) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return p.func == (void*)stamp_kernel ? *(int*)p.kernelParams[4] : -1;
}

}  // namespace

extern "C" int bs_stamp(long long* stamps, const long long* counter,
                        int rows, int n_slots, int slot, void* stream) {
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(stamps, counter, rows,
                                                  n_slots, slot);
  return (int)cudaGetLastError();
}

extern "C" int bs_graph_size(void* graph, long long* n_nodes,
                             long long* n_edges) {
  cudaGraph_t g = (cudaGraph_t)graph;
  size_t nn = 0, ne = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &nn);
  if (err == cudaSuccess) err = graph_edges(g, nullptr, nullptr, &ne);
  *n_nodes = (long long)nn;
  *n_edges = (long long)ne;
  return (int)err;
}

// types[i]: node i's cudaGraphNodeType; slots[i]: a stamp node's slot, -1
// for any other node; edge e runs from node edge_from[e] to edge_to[e].
// n_nodes and n_edges are bs_graph_size's.
extern "C" int bs_graph_census(void* graph, long long n_nodes,
                               long long n_edges, int* types, int* slots,
                               long long* edge_from, long long* edge_to) {
  cudaGraph_t g = (cudaGraph_t)graph;
  std::vector<cudaGraphNode_t> nodes(n_nodes), from(n_edges), to(n_edges);
  size_t nn = (size_t)n_nodes, ne = (size_t)n_edges;
  cudaError_t err = cudaGraphGetNodes(g, nodes.data(), &nn);
  if (err != cudaSuccess) return (int)err;
  if (nn != (size_t)n_nodes) return (int)cudaErrorInvalidValue;
  err = graph_edges(g, from.data(), to.data(), &ne);
  if (err != cudaSuccess) return (int)err;
  if (ne != (size_t)n_edges) return (int)cudaErrorInvalidValue;
  std::unordered_map<cudaGraphNode_t, long long> index;
  for (long long i = 0; i < n_nodes; ++i) {
    index[nodes[i]] = i;
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    if (err != cudaSuccess) return (int)err;
    types[i] = (int)type;
    slots[i] = -1;
    if (type == cudaGraphNodeTypeKernel) slots[i] = stamp_slot(nodes[i]);
  }
  for (long long e = 0; e < n_edges; ++e) {
    edge_from[e] = index[from[e]];
    edge_to[e] = index[to[e]];
  }
  return (int)cudaSuccess;
}

// Take out the stamp nodes of the slots s with drop[s] != 0 (s < n_slots),
// each predecessor of one joined to each of its successors; *dropped: how
// many were taken out.
extern "C" int bs_graph_drop_stamps(void* graph, const int* drop, int n_slots,
                                    long long* dropped) {
  cudaGraph_t g = (cudaGraph_t)graph;
  *dropped = 0;
  size_t nn = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &nn);
  if (err != cudaSuccess) return (int)err;
  std::vector<cudaGraphNode_t> nodes(nn), deps, users, after;
  err = cudaGraphGetNodes(g, nodes.data(), &nn);
  if (err != cudaSuccess) return (int)err;
  for (cudaGraphNode_t v : nodes) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(v, &type);
    if (err != cudaSuccess) return (int)err;
    if (type != cudaGraphNodeTypeKernel) continue;
    const int slot = stamp_slot(v);
    if (slot < 0 || slot >= n_slots || !drop[slot]) continue;
    if ((err = neighbours(v, false, &deps)) != cudaSuccess) return (int)err;
    if ((err = neighbours(v, true, &users)) != cudaSuccess) return (int)err;
    for (cudaGraphNode_t a : deps) {
      if ((err = neighbours(a, true, &after)) != cudaSuccess) return (int)err;
      for (cudaGraphNode_t b : users) {
        bool joined = false;
        for (cudaGraphNode_t c : after) joined = joined || c == b;
        if (!joined && (err = add_edge(g, a, b)) != cudaSuccess)
          return (int)err;
      }
    }
    if ((err = cudaGraphDestroyNode(v)) != cudaSuccess) return (int)err;
    ++*dropped;
  }
  return (int)cudaSuccess;
}
