// Native graph/schedule engine for rscm_tpu.
//
// Mirror of the reference's Rust scheduling core: petgraph storage +
// traversal (crates/rscm-core/src/model/runtime.rs:504-510 BFS execution
// order, model/validation.rs:176 cycle detection).  The rebuild keeps the
// same contracts but exposes them as a plain C ABI so the Python runtime
// binds via ctypes — no pybind11 dependency.
//
// Semantics replicated exactly (kept in lock-step with the pure-Python
// implementations in rscm_tpu/core/model/graph.py, which remain as the
// fallback and the differential-testing oracle):
//
//  * neighbor iteration order  = reverse edge-insertion order per source
//    node (petgraph's `neighbors`);
//  * bfs_order                 = FIFO BFS from a start node in that
//    neighbor order;
//  * topo_order                = Kahn's algorithm, FIFO tie-break over
//    node index for the initial frontier, then discovery order — identical
//    to BFS on chain graphs, fixes the diamond-graph read-before-write
//    hazard of plain BFS;
//  * find_cycle                = iterative DFS over all roots, GRAY-hit
//    detection, self-loops tolerated; returns the first offending node so
//    the Python side can raise CircularDependencyError with the same
//    component name the fallback would.
//
// All functions are single-threaded and allocation-light: callers pass
// edge arrays (src[i] -> dst[i], insertion order) and receive node orders
// in caller-allocated buffers.  Graphs here are tiny (tens of nodes), so
// the value is architectural parity with the reference's native core, not
// raw speed.

#include <cstddef>
#include <cstdint>
#include <utility>
#include <vector>

namespace {

// Adjacency in insertion order: head[node] -> first edge slot, chained.
// We build a simple CSR-like structure each call; n is small.
struct Adjacency {
    std::vector<int32_t> offsets;  // node -> start into `targets`
    std::vector<int32_t> targets;  // edge targets grouped by source, insertion order
};

// Edge indices come from an FFI boundary; an out-of-range index must be a
// reportable error (-2 from the entry points), never UB in build_adjacency.
bool edges_valid(int32_t n_nodes, int32_t n_edges,
                 const int32_t* src, const int32_t* dst) {
    for (int32_t e = 0; e < n_edges; ++e) {
        if (src[e] < 0 || src[e] >= n_nodes) return false;
        if (dst[e] < 0 || dst[e] >= n_nodes) return false;
    }
    return true;
}

Adjacency build_adjacency(int32_t n_nodes, int32_t n_edges,
                          const int32_t* src, const int32_t* dst) {
    Adjacency adj;
    adj.offsets.assign(static_cast<size_t>(n_nodes) + 1, 0);
    for (int32_t e = 0; e < n_edges; ++e) adj.offsets[src[e] + 1]++;
    for (int32_t v = 0; v < n_nodes; ++v) adj.offsets[v + 1] += adj.offsets[v];
    adj.targets.assign(static_cast<size_t>(n_edges), 0);
    std::vector<int32_t> cursor(adj.offsets.begin(), adj.offsets.end() - 1);
    for (int32_t e = 0; e < n_edges; ++e)
        adj.targets[cursor[src[e]]++] = dst[e];
    return adj;
}

}  // namespace

extern "C" {

// BFS from `start` with petgraph neighbor order (reverse insertion).
// Writes visit order into `order` (capacity n_nodes); returns count.
int32_t rscm_bfs_order(int32_t n_nodes, int32_t n_edges,
                       const int32_t* src, const int32_t* dst,
                       int32_t start, int32_t* order) {
    if (n_nodes <= 0 || start < 0 || start >= n_nodes) return 0;
    if (!edges_valid(n_nodes, n_edges, src, dst)) return -2;
    Adjacency adj = build_adjacency(n_nodes, n_edges, src, dst);
    std::vector<uint8_t> discovered(static_cast<size_t>(n_nodes), 0);
    std::vector<int32_t> queue;
    queue.reserve(static_cast<size_t>(n_nodes));
    discovered[start] = 1;
    queue.push_back(start);
    int32_t head = 0, count = 0;
    while (head < static_cast<int32_t>(queue.size())) {
        int32_t node = queue[head++];
        order[count++] = node;
        // reverse insertion order = iterate the CSR slice backwards
        for (int32_t i = adj.offsets[node + 1] - 1; i >= adj.offsets[node]; --i) {
            int32_t succ = adj.targets[i];
            if (!discovered[succ]) {
                discovered[succ] = 1;
                queue.push_back(succ);
            }
        }
    }
    return count;
}

// Kahn topological order, FIFO tie-break; self-loop edges ignored.
// Writes order into `order` (capacity n_nodes); returns count (== number
// of nodes reachable in topological order; < n_nodes implies a cycle).
int32_t rscm_topo_order(int32_t n_nodes, int32_t n_edges,
                        const int32_t* src, const int32_t* dst,
                        int32_t* order) {
    if (n_nodes <= 0) return 0;
    if (!edges_valid(n_nodes, n_edges, src, dst)) return -2;
    std::vector<int32_t> indegree(static_cast<size_t>(n_nodes), 0);
    for (int32_t e = 0; e < n_edges; ++e)
        if (src[e] != dst[e]) indegree[dst[e]]++;

    std::vector<int32_t> queue;
    queue.reserve(static_cast<size_t>(n_nodes));
    for (int32_t v = 0; v < n_nodes; ++v)
        if (indegree[v] == 0) queue.push_back(v);

    // insertion-order successor iteration (Kahn decrements don't depend on
    // neighbor order, but discovery order does — match the Python fallback,
    // which walks _out[node] forwards).
    Adjacency adj = build_adjacency(n_nodes, n_edges, src, dst);
    int32_t head = 0, count = 0;
    while (head < static_cast<int32_t>(queue.size())) {
        int32_t node = queue[head++];
        order[count++] = node;
        for (int32_t i = adj.offsets[node]; i < adj.offsets[node + 1]; ++i) {
            int32_t succ = adj.targets[i];
            if (succ == node) continue;
            if (--indegree[succ] == 0) queue.push_back(succ);
        }
    }
    return count;
}

// Cycle detection: iterative DFS from every unvisited root in node order,
// neighbors in reverse insertion order, GRAY-successor hit = cycle
// (self-loops tolerated, mirroring the reference's BackEdge(a, a) case).
// Returns the GRAY node the DFS ran into (a node on a cycle), or -1 if
// the graph is acyclic.
int32_t rscm_find_cycle(int32_t n_nodes, int32_t n_edges,
                        const int32_t* src, const int32_t* dst) {
    if (n_nodes <= 0) return -1;
    if (!edges_valid(n_nodes, n_edges, src, dst)) return -2;
    Adjacency adj = build_adjacency(n_nodes, n_edges, src, dst);
    enum : uint8_t { WHITE = 0, GRAY = 1, BLACK = 2 };
    std::vector<uint8_t> color(static_cast<size_t>(n_nodes), WHITE);
    // stack of (node, next reverse-order neighbor cursor)
    std::vector<std::pair<int32_t, int32_t>> stack;
    stack.reserve(static_cast<size_t>(n_nodes));

    for (int32_t root = 0; root < n_nodes; ++root) {
        if (color[root] != WHITE) continue;
        color[root] = GRAY;
        stack.emplace_back(root, adj.offsets[root + 1] - 1);
        while (!stack.empty()) {
            auto& frame = stack.back();
            int32_t node = frame.first;
            bool advanced = false;
            while (frame.second >= adj.offsets[node]) {
                int32_t succ = adj.targets[frame.second--];
                if (color[succ] == GRAY && succ != node) return succ;
                if (color[succ] == WHITE) {
                    color[succ] = GRAY;
                    stack.emplace_back(succ, adj.offsets[succ + 1] - 1);
                    advanced = true;
                    break;
                }
            }
            if (!advanced) {
                color[node] = BLACK;
                stack.pop_back();
            }
        }
    }
    return -1;
}

// ABI version so the Python loader can refuse mismatched builds.
int32_t rscm_graph_abi_version(void) { return 1; }

}  // extern "C"
