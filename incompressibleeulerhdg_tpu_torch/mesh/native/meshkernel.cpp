// Native mesh-connectivity kernel.
//
// The port's own copy of incompressibleeulerhdg_tpu/mesh/native/meshkernel.cpp:
// C++ for the Python connectivity loops in mesh/triangle_mesh.py.  Built
// with g++ -O3 for the host's baseline instruction set (no -march=native)
// on first use (mesh/native/__init__.py).  Builds, for a triangle mesh given
// as (n_vertices, cells):
//   - global facet enumeration (canonical key = sorted vertex pair, facets
//     ordered by ascending key, then stably partitioned interior-first)
//   - facet -> (cell, local facet, orientation flip) tables for both sides
//   - cell -> (facet, side) tables
//   - greedy graph coloring of the cell adjacency (facet-sharing) graph
//
// The enumeration exactly matches the numpy reference implementation so the
// two paths are interchangeable.
//
// Exposed via a C ABI for ctypes; no Python dependencies.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Half {
    uint64_t key;
    int32_t cell;
    int32_t local;
    int32_t flip;
};

}  // namespace

extern "C" {

// Returns the number of facets; fills the output arrays (caller allocates
// with capacity 3 * n_cells).  All arrays int32 unless noted.
//
// out_facet_cells  : (nf, 2)  minus cell = -1 on boundary
// out_facet_local  : (nf, 2)
// out_facet_flip   : (nf, 2)
// out_cell_facets  : (nc, 3)
// out_cell_side    : (nc, 3)
// out_n_interior   : (1,)
int64_t build_connectivity(
    int64_t n_vertices,
    int64_t n_cells,
    const int32_t* cells,  // (nc, 3)
    int32_t* out_facet_cells,
    int32_t* out_facet_local,
    int32_t* out_facet_flip,
    int32_t* out_cell_facets,
    int32_t* out_cell_side,
    int64_t* out_n_interior) {
    static const int LF[3][2] = {{1, 2}, {2, 0}, {0, 1}};

    const int64_t nh = 3 * n_cells;
    std::vector<Half> halves(nh);
    for (int64_t c = 0; c < n_cells; ++c) {
        const int32_t* v = cells + 3 * c;
        for (int l = 0; l < 3; ++l) {
            int32_t a = v[LF[l][0]];
            int32_t b = v[LF[l][1]];
            int32_t lo = a < b ? a : b;
            int32_t hi = a < b ? b : a;
            Half& h = halves[3 * c + l];
            h.key = (uint64_t)lo * (uint64_t)(n_vertices + 1) + (uint64_t)hi;
            h.cell = (int32_t)c;
            h.local = l;
            h.flip = (a > b) ? 1 : 0;
        }
    }

    // sort half-facets by (key, insertion index) — stable sort keeps the
    // (cell, local) order within a key, matching numpy's argsort(stable)
    std::vector<int64_t> idx(nh);
    for (int64_t i = 0; i < nh; ++i) idx[i] = i;
    std::stable_sort(idx.begin(), idx.end(), [&](int64_t x, int64_t y) {
        return halves[x].key < halves[y].key;
    });

    // provisional facet ids in ascending-key order (numpy np.unique order)
    std::vector<int32_t> prov_of_half(nh);
    std::vector<int32_t> count;
    count.reserve(nh);
    for (int64_t i = 0; i < nh; ++i) {
        if (i == 0 || halves[idx[i]].key != halves[idx[i - 1]].key) {
            count.push_back(1);
        } else {
            ++count.back();
        }
        prov_of_half[idx[i]] = (int32_t)(count.size() - 1);
    }
    const int32_t nf = (int32_t)count.size();

    // interior-first permutation (stable within each group)
    std::vector<int32_t> newid(nf);
    int32_t n_int = 0;
    for (int32_t f = 0; f < nf; ++f)
        if (count[f] == 2) newid[f] = n_int++;
    int32_t nb = n_int;
    for (int32_t f = 0; f < nf; ++f)
        if (count[f] != 2) newid[f] = nb++;

    for (int64_t i = 0; i < 2 * (int64_t)nf; ++i) out_facet_cells[i] = -1;
    std::vector<int32_t> seen(nf, 0);
    // iterate half-facets in (cell, local) order: first occurrence is plus
    for (int64_t i = 0; i < nh; ++i) {
        const Half& h = halves[i];
        int32_t f = newid[prov_of_half[i]];
        int32_t side = seen[prov_of_half[i]]++;
        out_facet_cells[2 * f + side] = h.cell;
        out_facet_local[2 * f + side] = h.local;
        out_facet_flip[2 * f + side] = h.flip;
        out_cell_facets[3 * h.cell + h.local] = f;
        out_cell_side[3 * h.cell + h.local] = side;
    }

    *out_n_interior = n_int;
    return nf;
}

// Greedy coloring of the cell adjacency graph.  Returns the color count.
int32_t color_cells(
    int64_t n_cells,
    int64_t n_interior_facets,
    const int32_t* facet_cells,  // (nf, 2), interior first
    int32_t* out_colors) {
    std::vector<int32_t> head(n_cells, -1);
    std::vector<int32_t> nxt(2 * n_interior_facets);
    std::vector<int32_t> adj(2 * n_interior_facets);
    int64_t e = 0;
    for (int64_t f = 0; f < n_interior_facets; ++f) {
        int32_t a = facet_cells[2 * f];
        int32_t b = facet_cells[2 * f + 1];
        adj[e] = b; nxt[e] = head[a]; head[a] = (int32_t)e; ++e;
        adj[e] = a; nxt[e] = head[b]; head[b] = (int32_t)e; ++e;
    }
    for (int64_t c = 0; c < n_cells; ++c) out_colors[c] = -1;
    int32_t ncol = 0;
    for (int64_t c = 0; c < n_cells; ++c) {
        uint32_t used = 0;
        for (int32_t it = head[c]; it >= 0; it = nxt[it]) {
            int32_t col = out_colors[adj[it]];
            if (adj[it] < c && col >= 0 && col < 32) used |= (1u << col);
        }
        int32_t k = 0;
        while (used & (1u << k)) ++k;
        out_colors[c] = k;
        if (k + 1 > ncol) ncol = k + 1;
    }
    return ncol;
}

}  // extern "C"
