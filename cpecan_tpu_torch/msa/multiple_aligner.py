"""The progressive column filter of cPecanRealign (the part of
``cpecan_tpu/msa/multiple_aligner.py`` that the realign CLI calls:
``filter_pairwise_alignment_to_make_pairs_ordered`` and what it needs).

Host-side port of impl/multipleAligner.c: columns are a union-find over
(seq, pos) positions plus per-root member lists; alignment weights live in
adjacency dicts keyed by column root.  The progressive path never touches
the greedy poset or the native library, so neither is copied.
"""

import bisect
import math
import random
from dataclasses import dataclass

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
