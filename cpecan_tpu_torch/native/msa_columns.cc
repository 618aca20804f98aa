// Poset closure for greedy MSA column merging (the consistency structure
// behind getMultipleSequenceAlignment, reference impl/multipleAligner.c:
// 272-297, where sonLib's stPosetAlignment plays this role).
//
// Exact native mirror of msa/multiple_aligner.py::_Poset (pure integer
// ops, so decisions are bit-identical to the numpy backend):
//   le[u][v][x] = min y such that the column holding (u, x) precedes or
//                 equals the column holding (v, y)   (BIG when unrelated)
//   ge[u][v][x] = max y such that the column holding (v, y) precedes or
//                 equals the column holding (u, x)   (-1 when unrelated)
// Both monotone non-decreasing in x.  The numpy backend rewrites whole
// prefixes/suffixes per merge (memory-bound); here every update is
// range-trimmed with a binary search so only entries that actually
// change are written — per merge O(n^2 log L + writes-that-change).

#include <algorithm>
#include <cstdint>
#include <cstdlib>

namespace {

constexpr int32_t BIG = 1 << 30;

struct Poset {
    int n;
    int64_t lmax;
    int32_t *le;
    int32_t *ge;
    int32_t *scratch;  // 2*n ints: out, inn

    int32_t *le_row(int u, int v) const {
        return le + ((int64_t)u * n + v) * lmax;
    }
    int32_t *ge_row(int u, int v) const {
        return ge + ((int64_t)u * n + v) * lmax;
    }
};

}  // namespace

extern "C" {

void *poset_new(int n, const int64_t *lengths) {
    Poset *p = new Poset;
    p->n = n;
    int64_t lmax = 0;
    for (int i = 0; i < n; ++i) lmax = std::max(lmax, lengths[i]);
    p->lmax = lmax;
    int64_t total = (int64_t)n * n * lmax;
    p->le = (int32_t *)malloc(total * sizeof(int32_t));
    p->ge = (int32_t *)malloc(total * sizeof(int32_t));
    p->scratch = (int32_t *)malloc(2 * (size_t)n * sizeof(int32_t));
    if (!p->le || !p->ge || !p->scratch) {
        // NULL handle: the caller falls back to the numpy backend (which
        // raises a catchable MemoryError) instead of faulting here
        free(p->le);
        free(p->ge);
        free(p->scratch);
        delete p;
        return nullptr;
    }
    std::fill(p->le, p->le + total, BIG);
    std::fill(p->ge, p->ge + total, (int32_t)-1);
    for (int u = 0; u < n; ++u) {
        int32_t *lrow = p->le_row(u, u);
        int32_t *grow = p->ge_row(u, u);
        for (int64_t x = 0; x < lengths[u]; ++x) {
            lrow[x] = (int32_t)x;
            grow[x] = (int32_t)x;
        }
    }
    return p;
}

void poset_free(void *h) {
    Poset *p = (Poset *)h;
    free(p->le);
    free(p->ge);
    free(p->scratch);
    delete p;
}

// 1 iff neither column strictly precedes the other (merge is consistent).
int poset_consistent(void *h, int ka, const int32_t *sa, const int32_t *pa,
                     int kb, const int32_t *sb, const int32_t *pb) {
    Poset *p = (Poset *)h;
    for (int i = 0; i < ka; ++i) {
        const int32_t *row = p->le + (int64_t)sa[i] * p->n * p->lmax;
        for (int j = 0; j < kb; ++j)
            if (row[(int64_t)sb[j] * p->lmax + pa[i]] <= pb[j]) return 0;
    }
    for (int j = 0; j < kb; ++j) {
        const int32_t *row = p->le + (int64_t)sb[j] * p->n * p->lmax;
        for (int i = 0; i < ka; ++i)
            if (row[(int64_t)sa[i] * p->lmax + pb[j]] <= pa[i]) return 0;
    }
    return 1;
}

// Record that the columns with members (ss, pp)[0:k] merged into one.
// Call only after poset_consistent said yes for the two halves.
void poset_merge(void *h, int k, const int32_t *ss, const int32_t *pp) {
    Poset *p = (Poset *)h;
    const int n = p->n;
    const int64_t lmax = p->lmax;
    int32_t *out = p->scratch;      // min y: C <= (v, y)
    int32_t *inn = p->scratch + n;  // max x: (u, x) <= C
    std::fill(out, out + n, BIG);
    std::fill(inn, inn + n, (int32_t)-1);
    for (int m = 0; m < k; ++m) {
        const int32_t s = ss[m], q = pp[m];
        for (int v = 0; v < n; ++v) {
            out[v] = std::min(out[v], p->le_row(s, v)[q]);
            inn[v] = std::max(inn[v], p->ge_row(s, v)[q]);
        }
    }
    for (int u = 0; u < n; ++u) {
        const int32_t hi = inn[u];
        if (hi < 0) continue;
        for (int v = 0; v < n; ++v) {
            const int32_t o = out[v];
            int32_t *row = p->le_row(u, v);
            if (row[hi] <= o) continue;  // monotone: whole prefix already <=
            // entries > o form a suffix of [0..hi]
            int32_t *x0 = std::upper_bound(row, row + hi + 1, o);
            std::fill(x0, row + hi + 1, o);
        }
    }
    for (int v = 0; v < n; ++v) {
        const int32_t y0 = out[v];
        if (y0 >= BIG) continue;
        for (int u = 0; u < n; ++u) {
            const int32_t i = inn[u];
            int32_t *row = p->ge_row(v, u);
            if (row[y0] >= i) continue;  // monotone: whole suffix already >=
            // entries < i form a prefix of [y0..lmax)
            int32_t *y1 = std::lower_bound(row + y0, row + lmax, i);
            std::fill(row + y0, y1, i);
        }
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Full greedy column builder (getMultipleSequenceAlignment,
// impl/multipleAligner.c:272-297): the heap / union-find / weight-graph /
// poset loop in one native pass.  The Python loop in
// msa/multiple_aligner.py::make_columns_greedy is the semantic mirror (and
// the differential oracle); per-candidate Python overhead (~100us across
// heap ops, dict lookups, ctypes marshalling) dominated the MSA bench, so
// the whole greedy pass runs here when the toolchain is available.
//
// Exact mirrors of the Python semantics that matter for decisions:
//   - duplicate input pairs overwrite the adjacency slot (dict assignment)
//     but keep the FIRST insertion position (dict ordering);
//   - WeightGraph.merge iterates the dissolved root's neighbors in
//     insertion order (re-averaging is order-sensitive in float);
//   - heap staleness: an entry is dead when the edge object was replaced
//     or its avg changed (value compare, like `-negw != w.avg`);
//   - union by member count, first root wins ties.

#include <cstring>
#include <deque>
#include <queue>
#include <unordered_map>
#include <vector>

namespace {

struct GEdge {
    int a, b;          // current column roots (kept root-current)
    double avg, n;
};

struct AdjSlot { int nbr; int edge; };  // edge < 0 => tombstone

struct Adj {
    std::vector<AdjSlot> items;              // insertion-ordered
    std::unordered_map<int, int> pos;        // nbr -> index in items

    int get(int nbr) const {
        auto it = pos.find(nbr);
        return it == pos.end() ? -1 : items[it->second].edge;
    }
    void put(int nbr, int edge) {
        auto it = pos.find(nbr);
        if (it == pos.end()) {
            pos.emplace(nbr, (int)items.size());
            items.push_back({nbr, edge});
        } else {
            items[it->second].edge = edge;   // overwrite keeps position
        }
    }
    void remove(int nbr) {
        auto it = pos.find(nbr);
        if (it != pos.end()) {
            items[it->second].edge = -1;
            pos.erase(it);
        }
    }
};

struct HeapEnt {
    double avg;
    int64_t seq;
    int edge;
};
struct HeapCmp {
    // max-avg first; ties by earliest push (python ties go by id(w) —
    // arbitrary but the 1e-5 rng noise on avg makes exact ties
    // measure-zero)
    bool operator()(const HeapEnt &x, const HeapEnt &y) const {
        if (x.avg != y.avg) return x.avg < y.avg;
        return x.seq > y.seq;
    }
};

}  // namespace

extern "C" {

// assign_out[flat position] = flat id of its column root.
// Returns 0 on success, 1 on allocation failure.
int msa_greedy(int n, const int64_t *lengths,
               int64_t n_pairs, const int32_t *s1, const int32_t *p1,
               const int32_t *s2, const int32_t *p2, const double *avgs,
               double match_gamma, int32_t *assign_out) {
    Poset *po = (Poset *)poset_new(n, lengths);
    if (!po) return 1;

    std::vector<int64_t> base(n + 1, 0);
    for (int i = 0; i < n; ++i) base[i + 1] = base[i] + lengths[i];
    const int64_t N = base[n];

    // union-find with member lists (as parallel (seq, pos) arrays for the
    // poset calls)
    std::vector<int32_t> parent(N), sz(N, 1);
    std::vector<std::vector<int32_t>> mss(N), mpp(N);
    for (int s = 0; s < n; ++s)
        for (int64_t p = 0; p < lengths[s]; ++p) {
            int64_t f = base[s] + p;
            parent[f] = (int32_t)f;
            mss[f].push_back(s);
            mpp[f].push_back((int32_t)p);
        }
    auto find = [&](int32_t k) {
        int32_t root = k;
        while (parent[root] != root) root = parent[root];
        while (parent[k] != root) {
            int32_t nxt = parent[k];
            parent[k] = root;
            k = nxt;
        }
        return root;
    };

    std::vector<GEdge> edges;
    edges.reserve((size_t)n_pairs);
    std::unordered_map<int, Adj> adj;
    adj.reserve((size_t)n_pairs * 2);
    for (int64_t i = 0; i < n_pairs; ++i) {
        int a = (int)(base[s1[i]] + p1[i]);
        int b = (int)(base[s2[i]] + p2[i]);
        edges.push_back({a, b, avgs[i], 1.0});
        int e = (int)edges.size() - 1;
        adj[a].put(b, e);
        adj[b].put(a, e);
    }

    std::priority_queue<HeapEnt, std::vector<HeapEnt>, HeapCmp> heap;
    {
        // unique surviving edges, python all_weights() dedup-by-identity
        std::vector<char> inq(edges.size(), 0);
        for (auto &kv : adj)
            for (auto &slot : kv.second.items)
                if (slot.edge >= 0 && !inq[slot.edge]) {
                    inq[slot.edge] = 1;
                    heap.push({edges[slot.edge].avg, (int64_t)slot.edge,
                               slot.edge});
                }
    }
    int64_t seq_ctr = (int64_t)edges.size();

    std::vector<int32_t> cat_ss, cat_pp;
    while (!heap.empty()) {
        HeapEnt top = heap.top();
        heap.pop();
        GEdge &w = edges[top.edge];
        int ra = find(w.a), rb = find(w.b);
        if (ra == rb) continue;
        auto ita = adj.find(ra);
        if (ita == adj.end() || ita->second.get(rb) != top.edge) continue;
        if (top.avg != w.avg) continue;
        if (w.avg < match_gamma) break;
        int ok = poset_consistent(
            po, (int)mss[ra].size(), mss[ra].data(), mpp[ra].data(),
            (int)mss[rb].size(), mss[rb].data(), mpp[rb].data());
        if (ok) {
            cat_ss.clear();
            cat_pp.clear();
            cat_ss.insert(cat_ss.end(), mss[ra].begin(), mss[ra].end());
            cat_ss.insert(cat_ss.end(), mss[rb].begin(), mss[rb].end());
            cat_pp.insert(cat_pp.end(), mpp[ra].begin(), mpp[ra].end());
            cat_pp.insert(cat_pp.end(), mpp[rb].begin(), mpp[rb].end());
            poset_merge(po, (int)cat_ss.size(), cat_ss.data(),
                        cat_pp.data());
            // graph merge (WeightGraph.merge): a, b are the edge's kept
            // roots
            int a = w.a, b = w.b;
            adj[a].remove(b);
            adj[b].remove(a);
            // union by member count; first root wins ties
            int keep = a, drop = b;
            if ((int64_t)mss[a].size() < (int64_t)mss[b].size()) {
                keep = b;
                drop = a;
            }
            parent[drop] = keep;
            sz[keep] += sz[drop];
            mss[keep].insert(mss[keep].end(), mss[drop].begin(),
                             mss[drop].end());
            mpp[keep].insert(mpp[keep].end(), mpp[drop].begin(),
                             mpp[drop].end());
            mss[drop].clear();
            mss[drop].shrink_to_fit();
            mpp[drop].clear();
            mpp[drop].shrink_to_fit();
            int root = keep, other = drop;
            auto ito = adj.find(other);
            if (ito != adj.end()) {
                Adj &root_adj = adj[root];
                for (AdjSlot &slot : ito->second.items) {
                    if (slot.edge < 0) continue;
                    int c = slot.nbr;
                    GEdge &w2 = edges[slot.edge];
                    adj[c].remove(other);
                    if (c == root) continue;
                    int ex = root_adj.get(c);
                    if (ex >= 0) {
                        GEdge &e2 = edges[ex];
                        double tot = e2.n + w2.n;
                        e2.avg = (e2.avg * e2.n + w2.avg * w2.n) / tot;
                        e2.n = tot;
                        heap.push({e2.avg, seq_ctr++, ex});
                    } else {
                        w2.a = root;
                        w2.b = c;
                        root_adj.put(c, slot.edge);
                        adj[c].put(root, slot.edge);
                    }
                }
                adj.erase(other);
            }
        } else {
            ita->second.remove(rb);
            auto itb = adj.find(rb);
            if (itb != adj.end()) itb->second.remove(ra);
        }
    }

    for (int64_t f = 0; f < N; ++f) assign_out[f] = find((int32_t)f);
    poset_free(po);
    return 0;
}

}  // extern "C"
