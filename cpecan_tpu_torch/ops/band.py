"""Band geometry on the host, numpy (the part of ``cpecan_tpu/ops/band.py``
that the port uses: ``BandGeometry``, ``band_construct``, ``make_band`` and
``make_bands``).

Anti-diagonal coordinate system of the reference DP core
(impl/pairwiseAligner.c:35-227):

    xay = x + y   (anti-diagonal index, 0 .. lX+lY)
    xmy = x - y   (position along an anti-diagonal)

Cells exist only where (xay + xmy) is even; the x/y coordinates are
x = (xay+xmy)/2, y = (xay-xmy)/2.  A band assigns every anti-diagonal an
[xmyL, xmyR] interval derived from a monotone chain of anchor pairs expanded
by ``expansion`` diagonals (band_construct, impl/pairwiseAligner.c:131-184).
Diagonal ``d`` holds the cells x in [x_lo[d], x_lo[d] + width[d]).
"""

from dataclasses import dataclass

import numpy as np


def band_construct(anchor_pairs, l_x, l_y, expansion):
    """Vectorized band_construct (impl/pairwiseAligner.c:131-184).

    Between consecutive anchors the four band-corner coordinates are
    constant, so the per-diagonal loop factors into one numpy pass: compute
    corners per anchor segment, np.repeat them over each segment's diagonal
    range, then apply the parity fix and the four sequential coordinate
    bounds (band_setCurrentDiagonal(P), :97-125) as array arithmetic.
    Returns (xmy_l, xmy_r) int64 arrays of length lX+lY+1.
    """
    assert l_x >= 0 and l_y >= 0
    assert expansion % 2 == 0
    n = l_x + l_y
    # matrix-coordinate waypoints: origin, anchors+1, terminal corner
    ap = np.asarray(anchor_pairs, dtype=np.int64).reshape(-1, 2)
    ax = ap[:, 0] + 1
    ay = ap[:, 1] + 1
    if len(ax):
        if not (np.all(np.diff(ax) > 0) and np.all(np.diff(ay) > 0)
                and ax[0] > 0 and ay[0] > 0 and ax[-1] <= l_x
                and ay[-1] <= l_y):
            raise ValueError("anchors must be strictly increasing and "
                             "in range")
    wx = np.concatenate([[0], ax, [l_x]])
    wy = np.concatenate([[0], ay, [l_y]])
    pxay = wx[:-1] + wy[:-1]      # segment k: previous waypoint
    pxmy = wx[:-1] - wy[:-1]
    nxay = wx[1:] + wy[1:]        # segment k: next waypoint
    nxmy = wx[1:] - wy[1:]

    def clip(v, hi):
        return np.clip(v, 0, hi)

    seg_x_l = clip((pxay + (pxmy - expansion)) // 2, l_x)
    seg_y_l = clip((nxay - (nxmy - expansion)) // 2, l_y)
    seg_x_u = clip((nxay + (nxmy + expansion)) // 2, l_x)
    seg_y_u = clip((pxay - (pxmy + expansion)) // 2, l_y)

    # diagonal d>=1 belongs to the first segment with nxay >= d (the loop
    # advances corners whenever nxay == cur); diagonal 0 uses zero corners
    lengths = np.diff(np.concatenate([[0], nxay]))
    x_l = np.concatenate([[0], np.repeat(seg_x_l, lengths)])
    y_l = np.concatenate([[0], np.repeat(seg_y_l, lengths)])
    x_u = np.concatenate([[0], np.repeat(seg_x_u, lengths)])
    y_u = np.concatenate([[0], np.repeat(seg_y_u, lengths)])
    # degenerate waypoints (repeated nxay) are skipped by np.repeat(0) — but
    # the final waypoint may coincide with the last anchor; pad to n+1
    if len(x_l) < n + 1:
        pad = n + 1 - len(x_l)
        x_l = np.concatenate([x_l, np.repeat(x_l[-1], pad)])
        y_l = np.concatenate([y_l, np.repeat(y_l[-1], pad)])
        x_u = np.concatenate([x_u, np.repeat(x_u[-1], pad)])
        y_u = np.concatenate([y_u, np.repeat(y_u[-1], pad)])

    xay = np.arange(n + 1, dtype=np.int64)
    xmy_l = x_l - y_l
    xmy_r = x_u - y_u
    xmy_l = np.where((xay + xmy_l) % 2 != 0, xmy_l + 1, xmy_l)
    xmy_r = np.where((xay + xmy_r) % 2 != 0, xmy_r + 1, xmy_r)
    # sequential coordinate bounds (band_setCurrentDiagonalP): clamp x
    # below by x_l / y above by y_l on the left edge, and x above by x_u /
    # y below by y_u on the right edge
    xmy_l = xmy_l + 2 * np.maximum(x_l - (xay + xmy_l) // 2, 0)
    xmy_l = xmy_l + 2 * np.maximum((xay - xmy_l) // 2 - y_l, 0)
    xmy_r = xmy_r - 2 * np.maximum((xay + xmy_r) // 2 - x_u, 0)
    xmy_r = xmy_r - 2 * np.maximum(y_u - (xay - xmy_r) // 2, 0)
    bad = ((xay + xmy_l) % 2 != 0) | ((xay + xmy_r) % 2 != 0) | (xmy_l > xmy_r)
    if np.any(bad):
        d0 = int(np.nonzero(bad)[0][0])
        raise ValueError(f"invalid diagonal: xay {d0} xmyL {xmy_l[d0]} "
                         f"xmyR {xmy_r[d0]}")
    return xmy_l, xmy_r


@dataclass
class BandGeometry:
    """x-indexed band layout."""

    l_x: int
    l_y: int
    xmy_l: np.ndarray  # [nDiag+1]
    xmy_r: np.ndarray  # [nDiag+1]
    x_lo: np.ndarray   # [nDiag+1] lowest x-coordinate in band at each diagonal
    width: np.ndarray  # [nDiag+1] number of cells on each diagonal

    @property
    def n_diag(self):
        return self.l_x + self.l_y

    @property
    def max_width(self):
        return int(self.width.max())


def make_band(anchor_pairs, l_x, l_y, expansion):
    xmy_l, xmy_r = band_construct(anchor_pairs, l_x, l_y, expansion)
    d = np.arange(l_x + l_y + 1, dtype=np.int64)
    x_lo = (d + xmy_l) // 2
    width = (xmy_r - xmy_l) // 2 + 1
    return BandGeometry(l_x, l_y, xmy_l, xmy_r, x_lo, width)


def make_bands(anchor_lists, l_xs, l_ys, expansion):
    """Batched make_band: one flat numpy pass over every read's anchor
    chain.  Returns a list of BandGeometry whose arrays are views into
    shared [B, NDmax+1] planes, per read identical to make_band."""
    assert expansion % 2 == 0
    B = len(l_xs)
    l_xs = np.asarray(l_xs, np.int64)
    l_ys = np.asarray(l_ys, np.int64)
    n = l_xs + l_ys
    nd1 = int(n.max()) + 1

    aps = [np.asarray(a, np.int64).reshape(-1, 2) for a in anchor_lists]
    n_a = np.asarray([len(a) for a in aps], np.int64)
    # flat waypoints per read: [0, anchors+1 ..., terminal corner]
    woff = np.concatenate([[0], np.cumsum(n_a + 2)])
    wx = np.empty(int(woff[-1]), np.int64)
    wy = np.empty(int(woff[-1]), np.int64)
    for r, ap in enumerate(aps):
        o = woff[r]
        wx[o] = 0
        wy[o] = 0
        if len(ap):
            ax = ap[:, 0] + 1
            ay = ap[:, 1] + 1
            if not (np.all(np.diff(ax) > 0) and np.all(np.diff(ay) > 0)
                    and ax[0] > 0 and ay[0] > 0 and ax[-1] <= l_xs[r]
                    and ay[-1] <= l_ys[r]):
                raise ValueError("anchors must be strictly increasing and "
                                 "in range")
            wx[o + 1:o + 1 + len(ax)] = ax
            wy[o + 1:o + 1 + len(ay)] = ay
        wx[woff[r + 1] - 1] = l_xs[r]
        wy[woff[r + 1] - 1] = l_ys[r]

    # segment s of read r spans waypoints (s, s+1); S_r = n_a + 1 segments
    n_s = n_a + 1
    soff = np.concatenate([[0], np.cumsum(n_s)])
    seg_read = np.repeat(np.arange(B), n_s)
    seg_i = np.arange(int(soff[-1])) - soff[seg_read]
    wp = woff[seg_read] + seg_i
    pxay = wx[wp] + wy[wp]
    pxmy = wx[wp] - wy[wp]
    nxay = wx[wp + 1] + wy[wp + 1]
    nxmy = wx[wp + 1] - wy[wp + 1]
    lxs = l_xs[seg_read]
    lys = l_ys[seg_read]
    seg_x_l = np.clip((pxay + (pxmy - expansion)) // 2, 0, lxs)
    seg_y_l = np.clip((nxay - (nxmy - expansion)) // 2, 0, lys)
    seg_x_u = np.clip((nxay + (nxmy + expansion)) // 2, 0, lxs)
    seg_y_u = np.clip((pxay - (pxmy + expansion)) // 2, 0, lys)

    # diagonals 1..n_r of read r take the first segment with nxay >= d;
    # np.repeat over per-segment diagonal counts (sums to n_r per read)
    prev = np.concatenate([[0], nxay[:-1]])
    lengths = nxay - np.where(seg_i == 0, 0, prev)
    drow = np.repeat(np.arange(B), n)
    doff = np.concatenate([[0], np.cumsum(n)])
    dcol = np.arange(int(doff[-1])) - doff[drow] + 1
    # int32 planes + in-place ops: the [B, ND] elementwise block is
    # memory-bound and coordinates fit int32 with lots of headroom
    x_l = np.zeros((B, nd1), np.int32)
    y_l = np.zeros((B, nd1), np.int32)
    x_u = np.zeros((B, nd1), np.int32)
    y_u = np.zeros((B, nd1), np.int32)
    x_l[drow, dcol] = np.repeat(seg_x_l, lengths)
    y_l[drow, dcol] = np.repeat(seg_y_l, lengths)
    x_u[drow, dcol] = np.repeat(seg_x_u, lengths)
    y_u[drow, dcol] = np.repeat(seg_y_u, lengths)

    xay = np.broadcast_to(np.arange(nd1, dtype=np.int32)[None, :], (B, nd1))
    xmy_l = x_l - y_l
    xmy_r = x_u - y_u
    t = xay + xmy_l
    t &= 1
    xmy_l += t          # parity fix: +1 when (xay+xmy) is odd
    t = xay + xmy_r
    t &= 1
    xmy_r += t
    # sequential coordinate bounds (band_setCurrentDiagonalP)
    t = xay + xmy_l
    t //= 2
    np.subtract(x_l, t, out=t)
    np.maximum(t, 0, out=t)
    t += t
    xmy_l += t
    t = xay - xmy_l
    t //= 2
    t -= y_l
    np.maximum(t, 0, out=t)
    t += t
    xmy_l += t
    t = xay + xmy_r
    t //= 2
    t -= x_u
    np.maximum(t, 0, out=t)
    t += t
    xmy_r -= t
    t = xay - xmy_r
    t //= 2
    np.subtract(y_u, t, out=t)
    np.maximum(t, 0, out=t)
    t += t
    xmy_r -= t
    live = xay <= n[:, None]
    bad = live & ((((xay + xmy_l) & 1) != 0) | (((xay + xmy_r) & 1) != 0)
                  | (xmy_l > xmy_r))
    if np.any(bad):
        r0, d0 = (int(v[0]) for v in np.nonzero(bad))
        raise ValueError(f"invalid diagonal: xay {d0} xmyL {xmy_l[r0, d0]} "
                         f"xmyR {xmy_r[r0, d0]}")
    x_lo = (xay + xmy_l) >> 1
    width = ((xmy_r - xmy_l) >> 1) + 1
    return [BandGeometry(int(l_xs[r]), int(l_ys[r]),
                         xmy_l[r, :n[r] + 1], xmy_r[r, :n[r] + 1],
                         x_lo[r, :n[r] + 1], width[r, :n[r] + 1])
            for r in range(B)]
