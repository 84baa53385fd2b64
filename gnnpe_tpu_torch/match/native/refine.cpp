// Native host refinement engine: exact backtracking enumeration over
// candidate sets (the irregular stage kept off-device, SURVEY.md §7.1.4).
//
// Re-implements the semantics of the reference's QuickSI-style explorer
// (GNN-PE/include/custom.h:757-888): depth-first extension through the
// pivot's data-graph neighbors, filtered by label, degree, visited flag,
// and backward-neighbor edge existence (binary search in sorted CSR).
//
// Exposed with a plain C ABI for ctypes (no pybind11 in this image).
// Arrays are borrowed from numpy; no allocation crosses the boundary.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Csr {
    const int32_t* offsets;
    const int32_t* neighbors;
    const int32_t* labels;
    int32_t num_vertices;

    inline int32_t degree(int32_t v) const {
        return offsets[v + 1] - offsets[v];
    }
    inline bool has_edge(int32_t u, int32_t v) const {
        const int32_t* lo = neighbors + offsets[u];
        const int32_t* hi = neighbors + offsets[u + 1];
        while (lo < hi) {
            const int32_t* mid = lo + (hi - lo) / 2;
            if (*mid < v) lo = mid + 1;
            else if (*mid > v) hi = mid;
            else return true;
        }
        return false;
    }
};

}  // namespace

extern "C" {

// Count (and optionally emit) monomorphism embeddings.
//
//   d_*: data graph CSR;  q_*: query graph CSR (both sorted adjacency)
//   order/pivot: matching order and pivots, int32[nq]
//   bn_flat/bn_off: backward neighbors, CSR-style (bn_off int32[nq+1])
//   cand_flat/cand_off: per-query-vertex candidates (by query vertex id)
//   max_answers: stop after this many (UINT32_MAX = unlimited)
//   out_embeddings: int32[max_emit * nq] or null; emitted row-major in
//     query-vertex-id order. out_emitted: number of rows written.
// Returns the match count (possibly > max_emit when only counting).
uint64_t gnnpe_refine(
    const int32_t* d_offsets, const int32_t* d_neighbors,
    const int32_t* d_labels, int32_t d_num_vertices,
    const int32_t* q_offsets, const int32_t* q_neighbors,
    const int32_t* q_labels, int32_t q_num_vertices,
    const int32_t* order, const int32_t* pivot,
    const int32_t* bn_flat, const int32_t* bn_off,
    const int32_t* cand_flat, const int64_t* cand_off,
    uint64_t max_answers,
    int32_t* out_embeddings, int64_t max_emit, int64_t* out_emitted) {

    Csr d{d_offsets, d_neighbors, d_labels, d_num_vertices};
    Csr q{q_offsets, q_neighbors, q_labels, q_num_vertices};
    const int nq = q_num_vertices;

    std::vector<uint8_t> visited(d_num_vertices, 0);
    std::vector<int32_t> embedding(nq, -1);
    // Per-depth candidate stacks; depth 0 is the start vertex's
    // candidate list (borrowed), deeper levels are filled in place.
    std::vector<std::vector<int32_t>> stack(nq);
    std::vector<size_t> idx(nq, 0);

    {
        int32_t u0 = order[0];
        const int32_t* c0 = cand_flat + cand_off[u0];
        stack[0].assign(c0, c0 + (cand_off[u0 + 1] - cand_off[u0]));
    }

    uint64_t count = 0;
    int64_t emitted = 0;
    int depth = 0;
    idx[0] = 0;

    while (true) {
        bool descended = false;
        while (idx[depth] < stack[depth].size()) {
            int32_t v = stack[depth][idx[depth]++];
            int32_t u = order[depth];
            embedding[u] = v;
            if (depth == nq - 1) {
                count++;
                if (out_embeddings && emitted < max_emit) {
                    std::memcpy(out_embeddings + emitted * nq,
                                embedding.data(), nq * sizeof(int32_t));
                    emitted++;
                }
                if (count >= max_answers) goto done;
            } else {
                visited[v] = 1;
                depth++;
                idx[depth] = 0;
                // generateValidCandidates (custom.h:757-797)
                int32_t uu = order[depth];
                int32_t u_label = q.labels[uu];
                int32_t u_degree = q.degree(uu);
                int32_t p = embedding[pivot[depth]];
                stack[depth].clear();
                const int32_t* nb = d_neighbors + d_offsets[p];
                int32_t cnt = d.degree(p);
                const int32_t* bns = bn_flat + bn_off[depth];
                int32_t bn_cnt = bn_off[depth + 1] - bn_off[depth];
                for (int32_t i = 0; i < cnt; i++) {
                    int32_t w = nb[i];
                    if (visited[w] || d_labels[w] != u_label ||
                        d.degree(w) < u_degree)
                        continue;
                    bool valid = true;
                    for (int32_t j = 0; j < bn_cnt; j++) {
                        if (!d.has_edge(w, embedding[bns[j]])) {
                            valid = false;
                            break;
                        }
                    }
                    if (valid) stack[depth].push_back(w);
                }
                descended = true;
                break;
            }
        }
        if (descended) continue;
        depth--;
        if (depth < 0) break;
        visited[embedding[order[depth]]] = 0;
    }

done:
    if (out_emitted) *out_emitted = emitted;
    return count;
}

}  // extern "C"
