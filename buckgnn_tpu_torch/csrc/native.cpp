// buckgnn_tpu_torch native host-ETL kernels.
//
// The card owns all model compute (PyTorch and the CUDA kernels beside this
// file); these C++ routines own the host-side hot loops that feed it: the
// role torch_scatter/PyG's C++ ops and the PyG DataLoader collation play
// for the reference (SURVEY.md §2.1). Host C++, built with g++ (not nvcc)
// at first use and exposed as a plain C ABI consumed through ctypes
// (buckgnn_tpu_torch/utils/native.py); every routine has a NumPy fallback
// so the package runs without the compiled library.
//
// Routines:
//   bg_shell_edges     unique element-perimeter edges + occurrence counts
//                      (GraphCreate.py:112-141 boundary detection's O(E log E)
//                      host hot loop).
//   bg_rcm_order       reverse Cuthill–McKee bandwidth-reducing node
//                      permutation, so arbitrary-order BDF meshes get the
//                      same in-band locality that row-major synthetic grids
//                      have (feeds the banded SAGE kernels' band).
//   bg_band_count      count in-band edges under a given ordering (cheap
//                      quality probe for band_width selection).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// Collect perimeter edges of quad (4-node) and tria (3-node) elements as
// sorted (min,max) pairs, deduplicate, and return per-unique-edge counts.
// Returns number of unique edges; caller provides output buffers sized
// 4*n_quad + 3*n_tria.
int64_t bg_shell_edges(const int64_t* quads, int64_t n_quad,
                       const int64_t* trias, int64_t n_tria,
                       int64_t* out_pairs,  // [max_edges, 2]
                       int64_t* out_counts) // [max_edges]
{
    const int64_t max_edges = 4 * n_quad + 3 * n_tria;
    std::vector<uint64_t> keys;
    keys.reserve(static_cast<size_t>(max_edges));
    auto push = [&keys](int64_t a, int64_t b) {
        if (a > b) std::swap(a, b);
        keys.push_back((static_cast<uint64_t>(a) << 32) |
                       static_cast<uint64_t>(b));
    };
    for (int64_t e = 0; e < n_quad; ++e) {
        const int64_t* q = quads + 4 * e;
        for (int k = 0; k < 4; ++k) push(q[k], q[(k + 1) & 3]);
    }
    for (int64_t e = 0; e < n_tria; ++e) {
        const int64_t* t = trias + 3 * e;
        for (int k = 0; k < 3; ++k) push(t[k], t[(k + 1) % 3]);
    }
    std::sort(keys.begin(), keys.end());
    int64_t n_out = 0;
    for (size_t i = 0; i < keys.size();) {
        size_t j = i;
        while (j < keys.size() && keys[j] == keys[i]) ++j;
        out_pairs[2 * n_out] = static_cast<int64_t>(keys[i] >> 32);
        out_pairs[2 * n_out + 1] = static_cast<int64_t>(keys[i] & 0xffffffffu);
        out_counts[n_out] = static_cast<int64_t>(j - i);
        ++n_out;
        i = j;
    }
    return n_out;
}

// Reverse Cuthill–McKee ordering over an undirected graph given as a
// symmetric edge list (both directions or either; symmetrized internally).
// out_perm[new_index] = old_index. Handles disconnected components by
// restarting from the unvisited node of minimum degree.
void bg_rcm_order(int64_t n_nodes,
                  const int64_t* senders, const int64_t* receivers,
                  int64_t n_edges, int64_t* out_perm)
{
    // Build symmetric CSR.
    std::vector<int64_t> deg(static_cast<size_t>(n_nodes), 0);
    for (int64_t e = 0; e < n_edges; ++e) {
        int64_t s = senders[e], r = receivers[e];
        if (s < 0 || r < 0 || s >= n_nodes || r >= n_nodes || s == r)
            continue;
        ++deg[static_cast<size_t>(s)];
        ++deg[static_cast<size_t>(r)];
    }
    std::vector<int64_t> offs(static_cast<size_t>(n_nodes) + 1, 0);
    std::partial_sum(deg.begin(), deg.end(), offs.begin() + 1);
    std::vector<int64_t> adj(static_cast<size_t>(offs.back()));
    std::vector<int64_t> cur(offs.begin(), offs.end() - 1);
    for (int64_t e = 0; e < n_edges; ++e) {
        int64_t s = senders[e], r = receivers[e];
        if (s < 0 || r < 0 || s >= n_nodes || r >= n_nodes || s == r)
            continue;
        adj[static_cast<size_t>(cur[static_cast<size_t>(s)]++)] = r;
        adj[static_cast<size_t>(cur[static_cast<size_t>(r)]++)] = s;
    }
    // Dedup neighbor lists (multiple elements share edges) and recompute
    // true degrees.
    std::vector<int64_t> tdeg(static_cast<size_t>(n_nodes));
    for (int64_t v = 0; v < n_nodes; ++v) {
        int64_t* b = adj.data() + offs[static_cast<size_t>(v)];
        int64_t* e = adj.data() + offs[static_cast<size_t>(v) + 1];
        std::sort(b, e);
        tdeg[static_cast<size_t>(v)] = std::unique(b, e) - b;
    }

    std::vector<uint8_t> visited(static_cast<size_t>(n_nodes), 0);
    std::vector<int64_t> order;
    order.reserve(static_cast<size_t>(n_nodes));
    std::vector<int64_t> queue;
    queue.reserve(static_cast<size_t>(n_nodes));
    std::vector<int64_t> nbrs;

    // Min-degree-first scan gives pseudo-peripheral-ish starts cheaply.
    std::vector<int64_t> by_deg(static_cast<size_t>(n_nodes));
    std::iota(by_deg.begin(), by_deg.end(), 0);
    std::stable_sort(by_deg.begin(), by_deg.end(),
                     [&tdeg](int64_t a, int64_t b) {
                         return tdeg[static_cast<size_t>(a)] <
                                tdeg[static_cast<size_t>(b)];
                     });

    for (int64_t start : by_deg) {
        if (visited[static_cast<size_t>(start)]) continue;
        visited[static_cast<size_t>(start)] = 1;
        queue.clear();
        queue.push_back(start);
        size_t head = 0;
        while (head < queue.size()) {
            int64_t v = queue[head++];
            order.push_back(v);
            nbrs.clear();
            const int64_t* b = adj.data() + offs[static_cast<size_t>(v)];
            for (int64_t k = 0; k < tdeg[static_cast<size_t>(v)]; ++k) {
                int64_t w = b[k];
                if (!visited[static_cast<size_t>(w)]) {
                    visited[static_cast<size_t>(w)] = 1;
                    nbrs.push_back(w);
                }
            }
            std::stable_sort(nbrs.begin(), nbrs.end(),
                             [&tdeg](int64_t a, int64_t c) {
                                 return tdeg[static_cast<size_t>(a)] <
                                        tdeg[static_cast<size_t>(c)];
                             });
            for (int64_t w : nbrs) queue.push_back(w);
        }
    }
    // Reverse for RCM.
    const int64_t n = static_cast<int64_t>(order.size());
    for (int64_t i = 0; i < n; ++i) out_perm[i] = order[static_cast<size_t>(n - 1 - i)];
}

// Count edges with |pos[s] - pos[r]| within the banded slab reach for a
// given tile/width (mirrors graph/batch.py::_band_split's inband test under
// identity positions: receiver tile t covers rows [t*T - W/2, t*T - W/2 + T + W)).
int64_t bg_band_count(const int64_t* senders, const int64_t* receivers,
                      int64_t n_edges, const int64_t* pos, int64_t n_nodes,
                      int64_t tile, int64_t width)
{
    const int64_t slab = tile + width;
    int64_t count = 0;
    for (int64_t e = 0; e < n_edges; ++e) {
        int64_t s = senders[e], r = receivers[e];
        if (s < 0 || r < 0 || s >= n_nodes || r >= n_nodes) continue;
        int64_t ps = pos[s], pr = pos[r];
        int64_t t = pr / tile;
        int64_t start = t * tile - width / 2;
        if (start < 0) start = 0;
        if (start > n_nodes - slab) start = n_nodes - slab;
        if (start < 0) start = 0;
        int64_t k = ps - start;
        if (k >= 0 && k < slab) ++count;
    }
    return count;
}

}  // extern "C"
