// Native topology compiler: the host-side graph-builder step of the
// framework (validation + child-CSR + DFS preorder + depths), the C++
// counterpart of the reference's compile_topology_data
// (reference: sip_optimal_control/lqr.cpp:563-631) re-designed for a jitted
// runtime: instead of pointer tables consumed by a serial solver, it emits
// the static index arrays (CSR, preorder, depth, parent maps) that the
// Python layer bakes into jitted programs as trace-time constants.
//
// Exposed as a tiny C ABI consumed via ctypes (sip_optimal_control_tpu/
// native/__init__.py); a NumPy implementation with identical semantics
// remains the fallback (types.compile_topology), and the test suite checks
// the two agree on every topology shape.
//
// Build: g++ -O2 -shared -fPIC -o libsoc_topology.so topology.cpp

#include <cstdint>
#include <vector>

extern "C" {

// Status codes mirror InputValidationStatus / TopologyError conditions.
enum SocTopologyStatus : int32_t {
  SOC_TOPOLOGY_OK = 0,
  SOC_TOPOLOGY_INVALID_ROOT = 1,
  SOC_TOPOLOGY_BAD_EDGE = 2,
  SOC_TOPOLOGY_IN_DEGREE = 3,
  SOC_TOPOLOGY_CYCLE = 4,
  SOC_TOPOLOGY_DISCONNECTED = 5,
};

// All output buffers are caller-allocated:
//   child_offsets: [num_nodes + 1], child_edges: [num_edges],
//   preorder: [num_nodes], depth: [num_nodes],
//   parent_edge/parent_node: [num_nodes].
int32_t soc_compile_topology(int32_t num_edges, int32_t root,
                             const int32_t* edge_parents,
                             const int32_t* edge_children,
                             int32_t* child_offsets, int32_t* child_edges,
                             int32_t* preorder, int32_t* depth,
                             int32_t* parent_edge, int32_t* parent_node) {
  const int32_t num_nodes = num_edges + 1;
  if (root < 0 || root >= num_nodes) return SOC_TOPOLOGY_INVALID_ROOT;

  for (int32_t e = 0; e < num_edges; ++e) {
    const int32_t p = edge_parents[e];
    const int32_t c = edge_children[e];
    if (p < 0 || p >= num_nodes || c < 0 || c >= num_nodes || p == c) {
      return SOC_TOPOLOGY_BAD_EDGE;
    }
  }

  // child CSR (counting sort by parent, stable in edge order)
  for (int32_t i = 0; i <= num_nodes; ++i) child_offsets[i] = 0;
  for (int32_t e = 0; e < num_edges; ++e) ++child_offsets[edge_parents[e] + 1];
  for (int32_t i = 0; i < num_nodes; ++i) child_offsets[i + 1] += child_offsets[i];
  std::vector<int32_t> fill(child_offsets, child_offsets + num_nodes);
  for (int32_t e = 0; e < num_edges; ++e) {
    child_edges[fill[edge_parents[e]]++] = e;
  }

  for (int32_t i = 0; i < num_nodes; ++i) {
    parent_edge[i] = -1;
    parent_node[i] = -1;
    depth[i] = -1;
  }
  for (int32_t e = 0; e < num_edges; ++e) {
    const int32_t c = edge_children[e];
    if (parent_edge[c] != -1) return SOC_TOPOLOGY_IN_DEGREE;
    parent_edge[c] = e;
    parent_node[c] = edge_parents[e];
  }
  if (parent_edge[root] != -1) return SOC_TOPOLOGY_IN_DEGREE;

  // Iterative DFS; children pushed in reverse CSR order so they pop in edge
  // order (matching the NumPy path and the reference's stack order).
  std::vector<int32_t> stack;
  std::vector<uint8_t> marks(num_nodes, 0);
  stack.reserve(num_nodes);
  stack.push_back(root);
  depth[root] = 0;
  int32_t size = 0;
  while (!stack.empty()) {
    const int32_t node = stack.back();
    stack.pop_back();
    if (size >= num_nodes || marks[node]) return SOC_TOPOLOGY_CYCLE;
    marks[node] = 1;
    preorder[size++] = node;
    for (int32_t ci = child_offsets[node + 1] - 1; ci >= child_offsets[node];
         --ci) {
      const int32_t e = child_edges[ci];
      const int32_t c = edge_children[e];
      depth[c] = depth[node] + 1;
      stack.push_back(c);
    }
  }
  if (size != num_nodes) return SOC_TOPOLOGY_DISCONNECTED;
  return SOC_TOPOLOGY_OK;
}

int32_t soc_topology_abi_version() { return 1; }

}  // extern "C"
