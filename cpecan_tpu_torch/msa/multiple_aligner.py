"""Multiple sequence alignment over posterior-aligned pairs (a copy of
``cpecan_tpu/msa/multiple_aligner.py``).

Host-side port of impl/multipleAligner.c: MSA is graph work over sparse
aligned-pair lists (the heavy pairwise posteriors come from the card,
``msa.gpu.gpu_batch_align_fn``), so it stays in Python/numpy, with the
greedy column build in C++ (``native/msa_columns.cc``).

Columns are represented with a union-find over (seq, pos) positions plus
per-root member lists; alignment weights live in adjacency dicts keyed by
column root.
"""

import bisect
import heapq
import math
import random
from dataclasses import dataclass, field

import numpy as np

from ..constants import PAIR_ALIGNMENT_PROB_1


@dataclass
class SeqFrag:
    """impl/multipleAligner.c:25-37."""

    seq: str
    left_end_id: int = 0
    right_end_id: int = 0

    @property
    def length(self):
        return len(self.seq)


class Columns:
    """Union-find columns over sequence positions (makeColumns/mergeColumns,
    impl/multipleAligner.c:74-270)."""

    def __init__(self, seq_frags):
        self.parent = {}
        self.members = {}
        for s, frag in enumerate(seq_frags):
            for p in range(frag.length):
                key = (s, p)
                self.parent[key] = key
                self.members[key] = [key]

    def find(self, key):
        root = key
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[key] != root:
            self.parent[key], key = root, self.parent[key]
        return root

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return ra
        if len(self.members[ra]) < len(self.members[rb]):
            ra, rb = rb, ra
        self.parent[rb] = ra
        self.members[ra].extend(self.members.pop(rb))
        return ra

    def roots(self):
        return list(self.members.keys())


class _Weight:
    """An undirected alignment weight between two column roots
    (AlignmentWeight, impl/multipleAligner.c:96-120)."""

    __slots__ = ("a", "b", "avg", "n")

    def __init__(self, a, b, avg, n=1.0):
        self.a = a
        self.b = b
        self.avg = avg
        self.n = n

    def other(self, c):
        return self.b if c == self.a else self.a


class WeightGraph:
    """Adjacency dict of _Weight objects keyed by column root."""

    def __init__(self, columns: Columns, multiple_aligned_pairs, rng=None):
        rng = rng or random.Random(0)
        self.adj = {}
        for score, s1, p1, s2, p2 in multiple_aligned_pairs:
            a = columns.find((s1, p1))
            b = columns.find((s2, p2))
            # tiny randomness breaks ties like the reference
            # (impl/multipleAligner.c:146)
            avg = score / PAIR_ALIGNMENT_PROB_1 + rng.random() * 0.00001
            w = _Weight(a, b, avg)
            self.adj.setdefault(a, {})[b] = w
            self.adj.setdefault(b, {})[a] = w

    def merge(self, columns: Columns, w: _Weight, changed=None):
        """mergeColumns (impl/multipleAligner.c:214-270): merge w's columns,
        averaging duplicate edges.  ``changed``, when given, collects the
        weights whose avg was re-averaged — the only ones whose existing
        heap entries go stale (transferred edges keep identity and avg,
        so their old entries still resolve via find())."""
        a, b = w.a, w.b
        self.adj[a].pop(b, None)
        self.adj[b].pop(a, None)
        root = columns.union(a, b)
        other = b if root == a else a
        adj_root = self.adj.setdefault(root, {})
        for c, w2 in list(self.adj.pop(other, {}).items()):
            self.adj[c].pop(other, None)
            if c == root:
                continue
            existing = adj_root.get(c)
            if existing is not None:
                tot = existing.n + w2.n
                existing.avg = (existing.avg * existing.n + w2.avg * w2.n) / tot
                existing.n = tot
                if changed is not None:
                    changed.append(existing)
            else:
                w2.a, w2.b = root, c
                adj_root[c] = w2
                self.adj[c][root] = w2
        return root

    def all_weights(self):
        seen = set()
        out = []
        for a, nbrs in self.adj.items():
            for b, w in nbrs.items():
                if id(w) not in seen:
                    seen.add(id(w))
                    out.append(w)
        return out


class _Poset:
    """Incremental partial-order-alignment consistency — the role sonLib's
    stPosetAlignment plays in getMultipleSequenceAlignment
    (impl/multipleAligner.c:276-295).  Maintains the transitive closure of
    column precedence as per-sequence-pair monotone staircases, so each
    accept/reject test is O(|A|·|B|) array lookups and each accepted merge
    a few vectorized prefix/suffix min/max updates — instead of a BFS over
    the whole column DAG per candidate (`_columns_consistent`), which made
    the greedy build O(merges × columns).

    le[u, v, x] = min y such that the column holding (u, x) precedes or
    equals the column holding (v, y) (BIG when unrelated);
    ge[u, v, x] = max y such that the column holding (v, y) precedes or
    equals the column holding (u, x) (-1 when unrelated).
    Both are monotone non-decreasing in x.  Every precedence edge
    ((s, p) -> (s, p+1)) is strict, so any path between two DISTINCT
    columns is strict: for members (s1, p) of column A and (s2, q) of
    column B, ``le[s1, s2, p] <= q`` is exactly "A strictly precedes B" —
    and the u == v diagonal makes the same-sequence-twice rejection fall
    out of the same lookup.
    """

    BIG = np.int32(2 ** 30)

    def __init__(self, lengths):
        n = len(lengths)
        lmax = max(lengths) if lengths else 0
        self.le = np.full((n, n, lmax), self.BIG, np.int32)
        self.ge = np.full((n, n, lmax), -1, np.int32)
        for u, l in enumerate(lengths):
            self.le[u, u, :l] = np.arange(l, dtype=np.int32)
            self.ge[u, u, :l] = np.arange(l, dtype=np.int32)

    def _precedes(self, mem_a, mem_b):
        le = self.le
        for s1, p in mem_a:
            row = le[s1]
            for s2, q in mem_b:
                if row[s2, p] <= q:
                    return True
        return False

    def consistent(self, mem_a, mem_b):
        return not self._precedes(mem_a, mem_b) and \
            not self._precedes(mem_b, mem_a)

    def merge(self, mem_a, mem_b):
        """Record that columns A and B (member lists) are now one column.
        Call only after ``consistent(A, B)``.  One composition step
        through the merged column closes the relation: a precedence path
        can cross the new column at most once (twice would be a cycle),
        so the new pairs are exactly {(u,x) ⪯ C} × {C ⪯ (v,y)}."""
        mem = mem_a + mem_b
        k = len(mem)
        ss = np.fromiter((m[0] for m in mem), np.int64, k)
        pp = np.fromiter((m[1] for m in mem), np.int64, k)
        out = self.le[ss, :, pp].min(axis=0)  # [n]: min y with C ⪯ (v, y)
        inn = self.ge[ss, :, pp].max(axis=0)  # [n]: max x with (u, x) ⪯ C
        le, ge, big = self.le, self.ge, self.BIG
        for u, hi in enumerate(inn):
            # monotone in x: if the prefix's LAST column already meets the
            # bound, the whole prefix does — steady-state merges are
            # mostly no-ops, so this guard does the heavy lifting
            if hi >= 0 and (le[u, :, hi] > out).any():
                np.minimum(le[u, :, : hi + 1], out[:, None],
                           out=le[u, :, : hi + 1])
        for v, y0 in enumerate(out):
            if y0 < big and (ge[v, :, y0] < inn).any():
                np.maximum(ge[v, :, y0:], inn[:, None], out=ge[v, :, y0:])


_poset_lib = None
_poset_lib_tried = False


def _get_poset_lib():
    global _poset_lib, _poset_lib_tried
    if not _poset_lib_tried:
        _poset_lib_tried = True
        import ctypes

        from ..native import load_library
        lib, _what = load_library("msa_columns")
        if lib is not None and hasattr(lib, "msa_greedy"):
            # array args as c_void_p: numpy .ctypes.data addresses
            vp = ctypes.c_void_p
            lib.msa_greedy.restype = ctypes.c_int
            lib.msa_greedy.argtypes = [
                ctypes.c_int, vp, ctypes.c_int64, vp, vp, vp, vp, vp,
                ctypes.c_double, vp]
        _poset_lib = lib
    return _poset_lib


def _native_greedy(seq_frags, multiple_aligned_pairs, match_gamma, rng):
    """The whole greedy column build in one native call
    (native/msa_columns.cc::msa_greedy) — heap, union-find, weight graph,
    and poset closure together; the per-candidate Python overhead was the
    MSA bench's dominant cost.  Draws the same rng tie-break noise in the
    same order as WeightGraph.__init__ (so outer rng streams stay
    aligned), mirrors decisions exactly (differential tests vs the Python
    loop).  Returns None when the native library is unavailable (before
    any draw).  A failed native allocation raises ``MemoryError``: the
    noise is drawn by then, and a Python loop run after it would see an
    advanced rng (the JAX package returns None there)."""
    lib = _get_poset_lib()
    if lib is None or not hasattr(lib, "msa_greedy"):
        return None
    n = len(seq_frags)
    lengths = np.ascontiguousarray([f.length for f in seq_frags], np.int64)
    m = len(multiple_aligned_pairs)
    arr = (np.asarray(multiple_aligned_pairs, np.float64).reshape(m, 5)
           if m else np.zeros((0, 5)))
    noise = np.asarray([rng.random() for _ in range(m)], np.float64)
    av = np.ascontiguousarray(arr[:, 0] / PAIR_ALIGNMENT_PROB_1
                              + noise * 0.00001)
    s1 = np.ascontiguousarray(arr[:, 1], np.int32)
    p1 = np.ascontiguousarray(arr[:, 2], np.int32)
    s2 = np.ascontiguousarray(arr[:, 3], np.int32)
    p2 = np.ascontiguousarray(arr[:, 4], np.int32)
    total = int(lengths.sum())
    assign = np.empty(total, np.int32)
    rc = lib.msa_greedy(n, lengths.ctypes.data, m, s1.ctypes.data,
                        p1.ctypes.data, s2.ctypes.data, p2.ctypes.data,
                        av.ctypes.data, float(match_gamma),
                        assign.ctypes.data)
    if rc != 0:  # msa_greedy's only failure: an allocation
        raise MemoryError("native msa_greedy allocation failed")
    columns = Columns(seq_frags)
    reps = {}
    flat = 0
    for s in range(n):
        for p in range(int(lengths[s])):
            root = int(assign[flat])
            flat += 1
            rep = reps.get(root)
            if rep is None:
                reps[root] = (s, p)
            else:
                columns.union(rep, (s, p))
    return columns


def _columns_consistent(columns: Columns, ra, rb):
    """A merge of columns ra/rb keeps a valid partial-order alignment iff
    neither column strictly precedes the other (BFS over the successor DAG:
    the column holding (s, p) precedes the column holding (s, p+1)).
    Equivalent to sonLib's stPosetAlignment_add acceptance test.  Kept as
    the slow reference checker for `_Poset` (selectable via
    ``make_columns_greedy(consistency="bfs")``, differentially tested)."""
    for s1, _ in columns.members[ra]:
        for s2, _ in columns.members[rb]:
            if s1 == s2:
                return False

    def reaches(src, dst):
        seen = {src}
        stack = [src]
        while stack:
            cur = stack.pop()
            for s, p in columns.members[cur]:
                nxt_key = (s, p + 1)
                if nxt_key not in columns.parent:
                    continue
                nxt = columns.find(nxt_key)
                if nxt == dst:
                    return True
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append(nxt)
        return False

    return not reaches(ra, rb) and not reaches(rb, ra)


def make_columns_greedy(seq_frags, multiple_aligned_pairs, match_gamma,
                        rng=None, consistency="poset"):
    """getMultipleSequenceAlignment (impl/multipleAligner.c:272-297):
    greedily merge the highest-weight consistent column pair.

    ``consistency`` picks how: "poset" (default) is the whole build in
    one native call (`_native_greedy`) when the toolchain can build it,
    else the Python loop below on the incremental closure (`_Poset`);
    "poset-numpy" forces that loop; "bfs" is the loop on the direct
    per-candidate DAG search (`_columns_consistent`) — same decisions,
    O(columns) slower per candidate, kept for differential testing."""
    if consistency == "poset":
        cols = _native_greedy(seq_frags, multiple_aligned_pairs,
                              match_gamma, rng or random.Random(0))
        if cols is not None:
            return cols
    columns = Columns(seq_frags)
    graph = WeightGraph(columns, multiple_aligned_pairs, rng=rng)
    lengths = [f.length for f in seq_frags]
    poset = _Poset(lengths) if consistency != "bfs" else None
    heap = [(-w.avg, id(w), w) for w in graph.all_weights()]
    heapq.heapify(heap)
    changed = []
    while heap:
        negw, _, w = heapq.heappop(heap)
        ra = columns.find(w.a)
        rb = columns.find(w.b)
        if ra == rb or graph.adj.get(ra, {}).get(rb) is not w or -negw != w.avg:
            continue
        if w.avg < match_gamma:
            break
        if poset is not None:
            ok = poset.consistent(columns.members[ra], columns.members[rb])
        else:
            ok = _columns_consistent(columns, ra, rb)
        if ok:
            if poset is not None:
                poset.merge(columns.members[ra], columns.members[rb])
            # only re-averaged weights need a fresh heap entry: transferred
            # edges keep identity and avg, so their old entries still
            # resolve (find() follows the union) — re-pushing the whole
            # adjacency made the heap O(merges x degree)
            changed.clear()
            graph.merge(columns, w, changed)
            for w2 in changed:
                heapq.heappush(heap, (-w2.avg, id(w2), w2))
        else:
            graph.adj.get(ra, {}).pop(rb, None)
            graph.adj.get(rb, {}).pop(ra, None)
    return columns


def pairwise_align_columns(seq_x_cols, seq_y_cols, graph, columns,
                           match_gamma):
    """pairwiseAlignColumns (impl/multipleAligner.c:356-490): sparse
    best-chain DP over alignment weights between two column sequences,
    merging the chained columns."""

    def total_weights(cols):
        return sum(len(graph.adj.get(columns.find(c), {})) for c in cols)

    if total_weights(seq_x_cols) > total_weights(seq_y_cols):
        seq_x_cols, seq_y_cols = seq_y_cols, seq_x_cols

    y_index = {columns.find(c): i for i, c in enumerate(seq_y_cols)}

    # best-scoring chain endpoints ordered by yIndex:
    # lists kept sorted by y
    ys = [-1, len(seq_y_cols)]
    entries = {-1: (0.0, -1, None, None),        # y -> (score, x, prev_y, w)
               len(seq_y_cols): (math.inf, len(seq_x_cols), -1, None)}

    for i, cx in enumerate(seq_x_cols):
        rx = columns.find(cx)
        aws = graph.adj.get(rx)
        if not aws:
            continue
        cands = []
        for rc, w in aws.items():
            if w.avg >= match_gamma and w.avg > 0.0 and rc in y_index:
                yi = y_index[rc]
                k = bisect.bisect_left(ys, yi)
                # highest scoring point strictly left of yi
                py = ys[k - 1]
                score = entries[py][0] + w.avg * w.n
                cands.append((yi, score, py, w))
        cands.sort()
        for yi, score, py, w in reversed(cands):
            k = bisect.bisect_left(ys, yi)
            ny = ys[k]
            if score >= entries[ny][0] or ny > yi:
                while score >= entries[ys[k]][0]:
                    dead = ys.pop(k)
                    del entries[dead]
                if yi not in entries:
                    ys.insert(bisect.bisect_left(ys, yi), yi)
                entries[yi] = (score, i, py, w)

    # link the right buffer to the rightmost real point
    end_y = ys[-1]
    prev_y = ys[-2]
    entries[end_y] = (math.inf, len(seq_x_cols), prev_y, None)

    # traceback
    alignment = []
    y = end_y
    while True:
        score, x, py, w = entries[y]
        psx = entries[py][1]
        yy = y
        while yy - 1 > py:
            yy -= 1
            alignment.append(seq_y_cols[yy])
        xx = x
        while xx - 1 > psx:
            xx -= 1
            alignment.append(seq_x_cols[xx])
        y = py
        if y == -1:
            break
        w2 = entries[y][3]
        merged = graph.merge(columns, w2)
        alignment.append(merged)
    alignment.reverse()
    return alignment


def make_columns_progressive(seq_frags, multiple_aligned_pairs, match_gamma,
                             seq_pair_similarity_scores, rng=None):
    """getMultipleSequenceAlignmentProgressive (impl/multipleAligner.c:510-556)."""
    columns = Columns(seq_frags)
    graph = WeightGraph(columns, multiple_aligned_pairs, rng=rng)
    scores = sorted(seq_pair_similarity_scores)
    col_seqs = [[(s, p) for p in range(f.length)]
                for s, f in enumerate(seq_frags)]
    while scores:
        _, sx, sy = scores.pop()
        if col_seqs[sx] is not col_seqs[sy]:
            merged = pairwise_align_columns(col_seqs[sx], col_seqs[sy],
                                            graph, columns, match_gamma)
            old_x, old_y = col_seqs[sx], col_seqs[sy]
            for i in range(len(col_seqs)):
                if col_seqs[i] is old_x or col_seqs[i] is old_y:
                    col_seqs[i] = merged
    return columns


def filter_multiple_aligned_pairs(columns: Columns, multiple_aligned_pairs):
    """filterMultipleAlignedPairs (impl/multipleAligner.c:569-602)."""
    out = []
    for pair in multiple_aligned_pairs:
        score, s1, p1, s2, p2 = pair
        if columns.find((s1, p1)) == columns.find((s2, p2)):
            out.append(pair)
    return out


def filter_pairwise_alignment_to_make_pairs_ordered(aligned_pairs, seq_x,
                                                    seq_y, match_gamma,
                                                    rng=None):
    """filterPairwiseAlignmentToMakePairsOrdered
    (impl/multipleAligner.c:949-977): expected-accuracy consistency filter
    used by cPecanRealign."""
    maps = [(score, 0, x, 1, y) for score, x, y in aligned_pairs]
    frags = [SeqFrag(seq_x), SeqFrag(seq_y)]
    columns = make_columns_progressive(frags, maps, match_gamma,
                                       [(0, 0, 1)], rng=rng)
    kept = filter_multiple_aligned_pairs(columns, maps)
    return [(score, p1, p2) for score, _, p1, _, p2 in kept]


def get_alignment_score(aligned_pairs, len1, len2):
    """getAlignmentScore (impl/multipleAligner.c:607-622)."""
    total = sum(score for score, _, _ in aligned_pairs)
    j = max(min(len1, len2), 1)
    d = total / (j * PAIR_ALIGNMENT_PROB_1)
    return int(max(min(d, 1.0), 0.0) * PAIR_ALIGNMENT_PROB_1)


def get_reference_pairwise_alignments(seq_frags):
    """getReferencePairwiseAlignments (impl/multipleAligner.c:740-776):
    spanning chains by shared right-end id."""
    chosen = []
    if not seq_frags:
        return chosen
    l = sorted((f.right_end_id, f.length, i) for i, f in enumerate(seq_frags))

    def pick(sub):
        ref = sub[len(sub) // 2][2]
        for _, _, m in sub:
            if m != ref:
                chosen.append(tuple(sorted((ref, m))))
        return ref

    groups = []
    start = 0
    for j in range(1, len(l) + 1):
        if j == len(l) or l[j][0] != l[start][0]:
            groups.append(pick(l[start:j]))
            start = j
    # align reference sequences of each group to a central one
    refs = [(0, 0, r) for r in groups]
    pick(refs)
    return chosen


def get_distance_matrix(columns: Columns, seq_frags, max_pairs_to_consider):
    """getDistanceMatrix (impl/multipleAligner.c:814-844): per-pair counts of
    substitutions / identities within MSA columns."""
    n = len(seq_frags)
    subs = [[0] * n for _ in range(n)]
    nonsubs = [[0] * n for _ in range(n)]
    considered = 0
    for root, members in columns.members.items():
        if considered >= max_pairs_to_consider:
            break
        for i in range(len(members)):
            s1, p1 = members[i]
            b1 = seq_frags[s1].seq[p1]
            for j in range(i + 1, len(members)):
                s2, p2 = members[j]
                b2 = seq_frags[s2].seq[p2]
                if b1 == b2:
                    nonsubs[min(s1, s2)][max(s1, s2)] += 1
                else:
                    subs[max(s1, s2)][min(s1, s2)] += 1
                considered += 1
    return subs, nonsubs


def _subs_per_site(s1, s2, subs, nonsubs):
    sub = subs[max(s1, s2)][min(s1, s2)]
    iden = nonsubs[min(s1, s2)][max(s1, s2)]
    return 0.0 if sub + iden == 0 else sub / (sub + iden)


def get_next_best_pair(seq1, n, subs, nonsubs, chosen, rng):
    """getNextBestPair (impl/multipleAligner.c:863-890): Dijkstra over chosen
    alignments; pick the unaligned pair with the largest gain."""
    adj = {i: [] for i in range(n)}
    for a, b in chosen:
        w = _subs_per_site(a, b, subs, nonsubs)
        adj[a].append((b, w))
        adj[b].append((a, w))
    dist = {i: math.inf for i in range(n)}
    dist[seq1] = 0.0
    pq = [(0.0, seq1)]
    while pq:
        d, u = heapq.heappop(pq)
        if d > dist[u]:
            continue
        for v, w in adj[u]:
            nd = d + w
            if nd < dist[v]:
                dist[v] = nd
                heapq.heappush(pq, (nd, v))
    max_gain = -math.inf
    best = None
    for seq2 in range(n):
        if seq2 == seq1:
            continue
        gain = dist[seq2] - _subs_per_site(seq1, seq2, subs, nonsubs)
        if gain > max_gain or (gain == max_gain and rng.random() > 0.5):
            if tuple(sorted((seq1, seq2))) not in chosen:
                max_gain = gain
                best = seq2
    return best


@dataclass
class MultipleAlignment:
    columns: Columns = None
    aligned_pairs: list = field(default_factory=list)
    chosen_pairwise_alignments: list = field(default_factory=list)


def make_alignment(align_fn, seq_frags, spanning_trees, max_pairs_to_consider,
                   use_progressive_merging, match_gamma, rng=None,
                   batch_align_fn=None, stage=None):
    """makeAlignment (impl/multipleAligner.c:892-944).

    ``align_fn(seq_x, seq_y, ragged_left, ragged_right)`` returns reweighted
    (score, x, y) pairs — the caller wires in the aligner (addMultiple-
    AlignedPairs uses getAlignedPairs + reweightAlignedPairs2).

    ``batch_align_fn(jobs)`` — jobs a list of the same 4-tuples — aligns a
    whole round of pairwise jobs at once and returns one pair list per job
    (e.g. `msa.gpu.gpu_batch_align_fn`: every round is a handful of CUDA
    kernel launches instead of one DP per pair).  When given, ``align_fn``
    may be None.

    ``stage(name, fn)``, when given, runs each column build ("columns")
    and returns ``fn()``, so that a caller can time them.
    """
    rng = rng or random.Random(0)
    stage = stage or (lambda _name, fn: fn())
    n = len(seq_frags)

    mA = MultipleAlignment()

    def add_pairs_many(pair_list):
        """Align every (s1, s2) in pair_list (one batch when
        batch_align_fn is wired), extend mA, return per-pair distances."""
        jobs = [(seq_frags[a].seq, seq_frags[b].seq,
                 seq_frags[a].left_end_id != seq_frags[b].left_end_id,
                 seq_frags[a].right_end_id != seq_frags[b].right_end_id)
                for a, b in pair_list]
        if batch_align_fn is not None:
            results = batch_align_fn(jobs)
        else:
            results = [align_fn(*job) for job in jobs]
        dists = []
        for (s1, s2), pairs in zip(pair_list, results):
            f1, f2 = seq_frags[s1], seq_frags[s2]
            dists.append(get_alignment_score(pairs, f1.length, f2.length))
            mA.aligned_pairs.extend((sc, s1, x, s2, y)
                                    for sc, x, y in pairs)
        return dists

    def add_pairs(s1, s2):
        return add_pairs_many([(s1, s2)])[0]

    def build_columns():
        if n == 2 or use_progressive_merging:
            return stage("columns", lambda: make_columns_progressive(
                seq_frags, mA.aligned_pairs, match_gamma,
                mA.chosen_pairwise_alignments, rng=rng))
        return stage("columns", lambda: make_columns_greedy(
            seq_frags, mA.aligned_pairs, match_gamma, rng=rng))

    if spanning_trees * (n - 1) >= (n * (n - 1)) // 2:
        all_prs = [(s1, s2) for s1 in range(n) for s2 in range(s1 + 1, n)]
        sim = [(d, s1, s2) for d, (s1, s2)
               in zip(add_pairs_many(all_prs), all_prs)]
        mA.chosen_pairwise_alignments = sim
        mA.columns = build_columns()
        mA.aligned_pairs = filter_multiple_aligned_pairs(mA.columns,
                                                         mA.aligned_pairs)
        return mA

    chosen = set(get_reference_pairwise_alignments(seq_frags))
    first = sorted(chosen)
    mA.chosen_pairwise_alignments.extend(
        (d, s1, s2) for d, (s1, s2) in zip(add_pairs_many(first), first))
    iteration = 0
    while True:
        mA.columns = build_columns()
        iteration += 1
        if iteration >= spanning_trees:
            mA.aligned_pairs = filter_multiple_aligned_pairs(
                mA.columns, mA.aligned_pairs)
            return mA
        subs, nonsubs = get_distance_matrix(mA.columns, seq_frags,
                                            max_pairs_to_consider)
        round_pairs = []
        for seq in range(n):
            other = get_next_best_pair(seq, n, subs, nonsubs, chosen, rng)
            if other is not None:
                pair = tuple(sorted((seq, other)))
                round_pairs.append(pair)
                chosen.add(pair)
        mA.chosen_pairwise_alignments.extend(
            (d, s1, s2) for d, (s1, s2)
            in zip(add_pairs_many(round_pairs), round_pairs))
