"""Posterior compaction on the device and pair extraction on the host
(counterparts of ``cpecan_tpu/ops/pallas_fb.py`` ``compact_posteriors``
:3416, ``extract_pairs_from_pallas`` :3394, ``_compact_row`` :3482,
``_flat_ix`` :3495, ``extract_pairs_compact`` :3508,
``extract_echelon_pairs`` :3538, ``extract_pairs_auto`` :3585,
``extract_pairs_chunk`` :3625, ``extract_echelon_pairs_chunk`` :3685,
``extract_pairs_long`` :3747, and the per-chunk compaction of
``_run_tiled`` :2597-2614).

The wire format is the JAX package's: per read the top-k cells of the
windowed posterior plane as u16 fixed-point values (p * 65535, clipped to
[0, 1]) and the flat plane index (d - 1) * W' + l split into ``drow`` =
flat // W' (u16 while the row count fits, else int32) and ``lane`` =
flat % W' (u8 for W' <= 256, else u16).  W' is the window W, or NP * W
for a multi-state plane [G, ND+1, NP, R, W] (echelon), whose state and
lane flatten into one row of NP * W: flat = (d - 1) * NP * W + state * W
+ lane.  The compaction leaves for the host in flight (``HostCopy``): a run
returns without waiting for its kernels, so that host work overlaps the
next ones, and the extractors wait for the copy (``fetch``).
"""

import numpy as np
import torch

from ..constants import PAIR_ALIGNMENT_PROB_1


def host_array(a):
    """numpy view of a tensor (copied from the device) or array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class HostCopy:
    """Tensors on their way to the host, and what becomes of them there.

    On the card, each tensor starts a ``non_blocking`` copy into pinned
    host memory at construction, and a CUDA event is recorded after the
    copies on the current stream: the caller goes on queueing work (the
    JAX driver's ``copy_to_host_async``).  ``wait()`` blocks on that event
    only, not on work queued after it, and returns ``finish(numpy
    arrays)``.  On the CPU the tensors are the host arrays already."""

    def __init__(self, tensors, finish):
        self.finish = finish
        self.event = None
        if tensors[0].device.type == "cuda":
            self.host = [torch.empty(t.shape, dtype=t.dtype,
                                     pin_memory=True) for t in tensors]
            for h, t in zip(self.host, tensors):
                h.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(tensors[0].device))
        else:
            self.host = [t.detach() for t in tensors]

    def wait(self):
        if self.event is not None:
            self.event.synchronize()
        return self.finish([h.numpy() for h in self.host])


def fetch(out):
    """Wait for the compaction of a run's output (out["compact"], or the
    tiled path's out["compact_chunks"], a ``HostCopy``) and put the host
    arrays in its place; returns ``out``."""
    for key in ("compact", "compact_chunks"):
        if isinstance(out.get(key), HostCopy):
            out[key] = out[key].wait()
    return out


def _top_k(p, k, W, n_rows, finish=None):
    """The exact top-k along the last axis of ``p`` (flat (row, lane)
    plane indices, ``n_rows`` rows of W lanes) in the wire format, on its
    way to the host: a ``HostCopy`` whose ``wait()`` gives (values u16,
    drow, lane) numpy arrays, passed through ``finish`` when given.
    Values are quantized in int32 on the device and take their wire dtypes
    on the host."""
    vals, idx = torch.topk(p, min(k, p.shape[-1]), dim=-1)
    qv = torch.round(torch.clamp(vals, 0.0, 1.0) * 65535.0).to(torch.int32)
    drow = torch.div(idx, W, rounding_mode="floor").to(torch.int32)
    lane = (idx % W).to(torch.int32)
    d_dt = np.uint16 if n_rows < 65536 else np.int32
    l_dt = np.uint8 if W <= 256 else np.uint16

    def wire(arrays):
        qv, drow, lane = arrays
        out = qv.astype(np.uint16), drow.astype(d_dt), lane.astype(l_dt)
        return finish(out) if finish else out

    return HostCopy([qv, drow, lane], wire)


def compact_posteriors(posts, k=4096):
    """Per read, the top-k posterior cells over all diagonals of the
    windowed plane ``posts`` [G, ND+1, R, W], or a multi-state plane
    [G, ND+1, NP, R, W] -> (values u16, drow, lane), each [G, R, k], on
    their way to the host (a ``HostCopy``: ``_top_k``).

    One exact ``torch.topk`` over the [G, R, ND*W'] plane, W' = W or
    NP * W (diagonal 0 is never emitted)."""
    if posts.ndim == 5:
        G, ND1, NP, R, W0 = posts.shape
        p = posts[:, 1:].permute(0, 3, 1, 2, 4).reshape(
            G, R, (ND1 - 1) * NP * W0)
        W = NP * W0
    else:
        G, ND1, R, W = posts.shape
        p = posts[:, 1:].permute(0, 2, 1, 3).reshape(G, R, (ND1 - 1) * W)
    return _top_k(p, k, W, ND1 - 1)


def compact_chunks(posts, DC, k):
    """The tiled path's per-chunk compaction: for every chunk c of DC
    diagonals (off = c * DC, diagonals off+1 .. off+DC) and every read, the
    exact top-k of that chunk, as ``compact_posteriors`` of the rows
    off .. off+DC would give it (drow counts from off).  One ``torch.topk``
    over [G, R, NC, DC*W]; a ``HostCopy`` of [(off, (values, drow, lane)),
    ...], each array [G, R, k]."""
    G, ND1, R, W = posts.shape
    NC = (ND1 - 1) // DC
    if NC * DC != ND1 - 1:
        raise ValueError(f"{ND1 - 1} diagonals are not whole chunks of {DC}")
    p = posts[:, 1:].reshape(G, NC, DC, R, W).permute(0, 3, 1, 2, 4)

    def split(wire):
        return [(c * DC, tuple(np.ascontiguousarray(a[:, :, c])
                               for a in wire)) for c in range(NC)]

    return _top_k(p.reshape(G, R, NC, DC * W), k, W, DC, finish=split)


def extract_pairs_full(out, read_idx, threshold):
    """Pairs of one read from the full windowed posterior plane
    (posteriors[g, d, r, l] = match posterior of cell (x = win[g, d] + l,
    y = d - x)); counterpart of ``extract_pairs_from_pallas``."""
    posts = out["posteriors"]
    prep = out["prep"]
    R = prep["R"]
    win = prep["win"]
    g, r = divmod(read_idx, R)
    band = prep["bands"][read_idx]
    pairs = []
    sub = host_array(posts[g, : band.n_diag + 1, r])
    d_idx, l_idx = np.nonzero(sub >= threshold)
    for d, l in zip(d_idx, l_idx):
        p = min(float(sub[d, l]), 1.0)
        x = int(win[g, d]) + int(l)
        pairs.append((int(np.floor(p * PAIR_ALIGNMENT_PROB_1)),
                      x - 1, int(d) - x - 1))
    return pairs


def _compact_row(vals, g, r):
    """One read's compacted values as f32 probabilities (dequantizing the
    u16 wire format)."""
    v = np.asarray(vals[g, r])
    if v.dtype == np.uint16:
        v = v.astype(np.float32) / np.float32(65535.0)
    return v


def _flat_ix(compact_tail, W, sel=None):
    """int64 flat plane indices from the split (drow, lane) wire format."""
    drow, lane = (np.asarray(a) for a in compact_tail)
    if sel is not None:
        drow, lane = drow[sel], lane[sel]
    return drow.astype(np.int64) * W + lane.astype(np.int64)


def extract_pairs_compact(vals, idx, read_idx, n_diag, prep, threshold,
                          as_array=False):
    """Pairs of one read from the compacted (top-k) posteriors; ``idx`` is
    the (drow, lane) tuple.  ``as_array`` returns an [N, 3] int64
    (score, x, y) array instead of a list of tuples."""
    R, W = prep["R"], prep["W"]
    win = prep["win"]
    g, r = divmod(read_idx, R)
    v = _compact_row(vals, g, r)
    ix = _flat_ix(tuple(a[g, r] for a in idx), W)
    d = ix // W + 1
    keep = (v >= threshold) & (d <= n_diag)
    v = v[keep]
    d = d[keep]
    l = ix[keep] % W
    x = win[g, d] + l
    scores = np.floor(np.minimum(v.astype(np.float64), 1.0)
                      * PAIR_ALIGNMENT_PROB_1).astype(np.int64)
    if as_array:
        return np.stack([scores, x - 1, d - x - 1], axis=1)
    return list(zip(scores.tolist(), (x - 1).tolist(),
                    (d - x - 1).tolist()))


def _single_state(out):
    """Refuse a multi-state posterior output (echelon), whose rows these
    extractors would decode with W lanes instead of NP * W."""
    if out["posteriors"].ndim == 5:
        raise ValueError("multi-state posterior output: use "
                         "extract_echelon_pairs or "
                         "extract_echelon_pairs_chunk")


def _expand(score, x, y, j):
    """The echelon expansion (diagonalCalculationMultiPosteriorMatchProbs,
    impl/pairwiseAligner.c:845-856) of cells (x, y) in state j (match_{j+1},
    j = 0..4) scoring ``score``: each emits the j + 1 pairs (x + n - 1,
    y - 1), n = 0..j ascending, cell after cell -> [N, 3] int64."""
    reps = j + 1
    base = np.repeat(np.arange(len(x)), reps)
    ends = np.cumsum(reps)
    n = (np.arange(int(ends[-1]) if len(ends) else 0)
         - np.repeat(ends - reps, reps))
    return np.stack([score[base], x[base] + n - 1, y[base] - 1],
                    axis=1).astype(np.int64).reshape(-1, 3)


def _scores(p):
    return np.floor(np.minimum(np.asarray(p, np.float64), 1.0)
                    * PAIR_ALIGNMENT_PROB_1).astype(np.int64)


def extract_echelon_pairs(out, read_idx, n_diag, threshold):
    """One read's pairs of a multi-state (echelon) run, with the echelon
    expansion: a cell (x, y) in state match_s (s = 1..5) above the
    threshold emits the s pairs (x + n - 1, y - 1), n < s (``_expand``).
    Reads the compacted top-k (flat = (d - 1) * NP * W + state * W + lane),
    or, when the read's top-k saturated (every kept cell clears the
    threshold), the read's full plane [ND+1, NP, W].  Returns a list of
    (score, x, y) in the JAX package's order: the top-k order, or the full
    plane's (d, state, lane) order."""
    fetch(out)
    vals, *idx = out["compact"]
    prep = out["prep"]
    R, W = prep["R"], prep["W"]
    NP = out["posteriors"].shape[2]
    win = np.asarray(prep["win"])
    g, r = divmod(read_idx, R)
    v = _compact_row(vals, g, r)
    if v.size and v[-1] >= threshold:
        sub = host_array(out["posteriors"][g, : n_diag + 1, :, r])
        d, j, l = np.nonzero(sub >= threshold)
        p = sub[d, j, l]
    else:
        ix = _flat_ix(tuple(a[g, r] for a in idx), NP * W)
        keep = v >= threshold
        ix, p = ix[keep], v[keep]
        d = ix // (NP * W) + 1
        j = ix % (NP * W) // W
        l = ix % W
        ok = d <= n_diag
        d, j, l, p = d[ok], j[ok], l[ok], p[ok]
    x = win[g, d].astype(np.int64) + l
    y = d - x
    ok = (x >= 1) & (y >= 1)
    ap = _expand(_scores(p[ok]), x[ok], y[ok], j[ok].astype(np.int64))
    return list(map(tuple, ap.tolist()))


def extract_pairs_auto(out, read_idx, n_diag, threshold, as_array=False):
    """Pair extraction that detects top-k saturation: when every one of a
    read's k compacted cells clears the threshold, pairs may have been
    dropped, so read that read's full windowed plane instead.  A tiled
    run's output goes to ``extract_pairs_long``; a multi-state output
    raises ``ValueError``."""
    _single_state(out)
    fetch(out)
    if "tiled" in out:
        return extract_pairs_long(out, read_idx, n_diag, threshold,
                                  as_array=as_array)
    vals, *idx = out["compact"]
    idx = tuple(idx)
    prep = out["prep"]
    R = prep["R"]
    g, r = divmod(read_idx, R)
    v = _compact_row(vals, g, r)
    if v.size == 0 or v[-1] < threshold:
        return extract_pairs_compact(vals, idx, read_idx, n_diag, prep,
                                     threshold, as_array=as_array)
    # saturated (diagonal 0 is never swept; valid pairs need x, y >= 1)
    win = prep["win"]
    sub = host_array(out["posteriors"][g, 1: n_diag + 1, r])
    d_idx, l_idx = np.nonzero(sub >= threshold)
    d = d_idx.astype(np.int64) + 1
    x = win[g, d] + l_idx
    p = np.minimum(sub[d_idx, l_idx].astype(np.float64), 1.0)
    keep = (x >= 1) & (d - x >= 1)
    scores = np.floor(p[keep] * PAIR_ALIGNMENT_PROB_1).astype(np.int64)
    ap = np.stack([scores, x[keep] - 1, (d - x)[keep] - 1], axis=1)
    if as_array:
        return ap
    return list(map(tuple, ap.tolist()))


def extract_pairs_chunk(out, rels, n_diags, threshold):
    """Batched pair extraction: one vectorized numpy pass over a chunk's
    compacted posteriors.

    Returns a list of [N, 3] int64 (score, x, y) arrays, one per entry of
    ``rels`` (read indices into the run's packed groups), each sorted by
    diagonal x + y with stable ties, exactly ``extract_pairs_auto(...,
    as_array=True)`` followed by a stable argsort.  Reads whose top-k
    saturated fall back to the per-read full-plane path.  A tiled run's
    output is extracted per read (``extract_pairs_long``, rows already in
    that order).  A multi-state output raises ``ValueError``."""
    _single_state(out)
    fetch(out)
    if "tiled" in out:
        return [extract_pairs_long(out, int(rel), int(nd_i), threshold,
                                   as_array=True)
                for rel, nd_i in zip(rels, n_diags)]
    vals, *idx = out["compact"]
    prep = out["prep"]
    R, W = prep["R"], prep["W"]
    win = np.asarray(prep["win"])
    rels = np.asarray(rels, np.int64)
    nd = np.asarray(n_diags, np.int64)
    v = np.asarray(vals)
    k = v.shape[-1]
    v = v.reshape(-1, k)[rels]
    if v.dtype == np.uint16:
        v = v.astype(np.float32) / np.float32(65535.0)
    ix = _flat_ix(tuple(np.asarray(a).reshape(-1, k) for a in idx), W,
                  sel=rels)
    sat = (v[:, -1] >= threshold) if k else np.zeros(len(rels), bool)
    d = ix // W + 1
    keep = (v >= threshold) & (d <= nd[:, None]) & ~sat[:, None]
    rsel, csel = np.nonzero(keep)
    dk = d[rsel, csel]
    lk = ix[rsel, csel] % W
    gk = rels[rsel] // R
    x = win[gk, dk].astype(np.int64) + lk
    vk = v[rsel, csel].astype(np.float64)
    scores = np.floor(np.minimum(vk, 1.0)
                      * PAIR_ALIGNMENT_PROB_1).astype(np.int64)
    ap = np.stack([scores, x - 1, dk - x - 1], axis=1)
    # one global stable sort; x + y = d - 2, so diagonal order is d
    order = np.argsort((rsel << np.int64(32)) | dk, kind="stable")
    ap = ap[order]
    splits = np.searchsorted(rsel[order], np.arange(1, len(rels)))
    parts = np.split(ap, splits)
    for i in np.nonzero(sat)[0]:
        full = extract_pairs_auto(out, int(rels[i]), int(nd[i]), threshold,
                                  as_array=True).reshape(-1, 3)
        parts[i] = full[np.argsort(full[:, 1] + full[:, 2], kind="stable")]
    return parts


def extract_echelon_pairs_chunk(out, rels, n_diags, threshold):
    """``extract_pairs_chunk`` for a multi-state (echelon) run, with the
    echelon expansion (state j emits j + 1 pairs, ``_expand``), vectorized
    over the chunk: a list of [N, 3] int64 (score, x, y) arrays, one per
    entry of ``rels``, each sorted by x + y with stable ties, exactly
    ``extract_echelon_pairs`` followed by a stable argsort on x + y.
    Reads whose top-k saturated fall back to the per-read path."""
    fetch(out)
    vals, *idx = out["compact"]
    prep = out["prep"]
    R, W = prep["R"], prep["W"]
    NP = out["posteriors"].shape[2]
    win = np.asarray(prep["win"])
    rels = np.asarray(rels, np.int64)
    nd = np.asarray(n_diags, np.int64)
    v = np.asarray(vals)
    k = v.shape[-1]
    v = v.reshape(-1, k)[rels]
    if v.dtype == np.uint16:
        v = v.astype(np.float32) / np.float32(65535.0)
    ix = _flat_ix(tuple(np.asarray(a).reshape(-1, k) for a in idx),
                  NP * W, sel=rels)
    sat = (v[:, -1] >= threshold) if k else np.zeros(len(rels), bool)
    d = ix // (NP * W) + 1
    keep = (v >= threshold) & (d <= nd[:, None]) & ~sat[:, None]
    rsel, csel = np.nonzero(keep)
    dk = d[rsel, csel]
    jk = ix[rsel, csel] % (NP * W) // W
    x = win[rels[rsel] // R, dk].astype(np.int64) + ix[rsel, csel] % W
    y = dk - x
    ok = (x >= 1) & (y >= 1)
    rsel, jk, x, y = rsel[ok], jk[ok], x[ok], y[ok]
    ap = _expand(_scores(v[rsel, csel[ok]]), x, y, jk)
    rr = np.repeat(rsel, jk + 1)
    order = np.argsort((rr << np.int64(32)) | (ap[:, 1] + ap[:, 2]),
                       kind="stable")
    ap = ap[order]
    parts = np.split(ap, np.searchsorted(rr[order], np.arange(1, len(rels))))
    for i in np.nonzero(sat)[0]:
        full = np.asarray(extract_echelon_pairs(out, int(rels[i]),
                                                int(nd[i]), threshold),
                          np.int64).reshape(-1, 3)
        parts[i] = full[np.argsort(full[:, 1] + full[:, 2], kind="stable")]
    return parts


def extract_pairs_long(out, read_idx, n_diag, threshold, as_array=False):
    """Pairs of one read of a tiled run (``StrawmanAligner._run_tiled``):
    each chunk of ``compact_chunks`` extracts like
    ``extract_pairs_compact`` with its diagonal offset, and a chunk whose
    top-k saturated reads that read's rows of the chunk from the full
    windowed plane instead.  Returns (score, x, y) rows sorted by diagonal
    (stable), as ``extract_pairs_auto`` + the pipelines' drain order."""
    fetch(out)
    prep = out["prep"]
    R, W = prep["R"], prep["W"]
    win = prep["win"]
    DC = out["tiled"]["DC"]
    g, r = divmod(read_idx, R)
    parts = []
    for off, comp in out["compact_chunks"]:
        if off >= n_diag:
            break
        v = _compact_row(comp[0], g, r)
        if not (v.size and float(v[-1]) >= threshold):
            ix = _flat_ix(tuple(np.asarray(a)[g, r] for a in comp[1:]), W)
            d = ix // W + 1 + off
            keep = (v >= threshold) & (d <= n_diag)
            d = d[keep]
            l = ix[keep] % W
            p = v[keep].astype(np.float64)
        else:
            # saturated chunk: this read's rows of the full plane
            hi = min(off + DC, n_diag)
            sub = host_array(out["posteriors"][g, off + 1:hi + 1, r])
            d_i, l = np.nonzero(sub >= threshold)
            d = d_i.astype(np.int64) + off + 1
            p = np.minimum(sub[d_i, l].astype(np.float64), 1.0)
        x = win[g, d].astype(np.int64) + l
        y = d - x
        ok = (x >= 1) & (y >= 1)
        scores = np.floor(np.minimum(p[ok], 1.0)
                          * PAIR_ALIGNMENT_PROB_1).astype(np.int64)
        part = np.stack([scores, x[ok] - 1, y[ok] - 1], axis=1)
        parts.append(part[np.argsort(d[ok], kind="stable")])
    ap = (np.concatenate(parts, axis=0) if parts
          else np.zeros((0, 3), np.int64))
    if as_array:
        return ap
    return list(map(tuple, ap.tolist()))
