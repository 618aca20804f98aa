"""Tolerances and checks that hold one run of the wavefront passes against
another: the port against the JAX package (tests), and each CUDA kernel
against its plain PyTorch version (tests on the card, ``chip_smoke.py``).

Both sides run f32 log-space passes; XLA's and PyTorch's exp/log differ in
the last bits, and the forward's rounding walks along the diagonals:

- forward plane: out-of-band cells exactly NEG, in-band
  |d| <= FWD_RTOL * |v| + FWD_ATOL;
- posterior plane: max |d| <= POST_ATOL;
- totals: relative |d| <= TOTAL_RTOL;
- extracted pairs: equal sets, except pairs whose posterior lies within
  FRINGE of the threshold in either run (the fringe the JAX package's
  compiled-TPU differential campaign accepted); common pairs' scores
  within the posterior tolerance plus two u16 wire steps.

Each check raises AssertionError with the size of the miss.
"""

import numpy as np

from .ops.compact import host_array as _host
from .ops.fb_kernels import NEG

FWD_RTOL, FWD_ATOL = 1e-5, 1e-3
POST_ATOL = 2e-3
TOTAL_RTOL = 1e-4
FRINGE = 2e-3
SCORE_ATOL = POST_ATOL * 1e7 + 2 * 153


def band_mask(prep, basef, widthf):
    """[G, ND+1, R, W] bool: the cells inside each read's band."""
    G, R, W, ND = prep["Bp"] // prep["R"], prep["R"], prep["W"], prep["ND"]
    base = _host(basef).reshape(G, R, -1)[:, :, :ND + 1]
    width = _host(widthf).reshape(G, R, -1)[:, :, :ND + 1]
    x = (prep["win"][:, :ND + 1, None] + np.arange(W)).astype(np.float32)
    x = x[:, :, None, :]                                  # [G, ND+1, 1, W]
    base = base.transpose(0, 2, 1)[..., None]             # [G, ND+1, R, 1]
    width = width.transpose(0, 2, 1)[..., None]
    return (x >= base) & (x < base + width)


def check_fwd(got, want, mask):
    """fwd planes [G, ND+1, 3, R, W] against the band ``mask``; returns the
    in-band max |d|."""
    got, want = _host(got), _host(want)
    m = np.broadcast_to(mask[:, :, None], got.shape)
    if not (np.all(got[~m] == NEG) and np.all(want[~m] == NEG)):
        raise AssertionError("out-of-band fwd cells are not exactly NEG")
    err = np.abs(got[m] - want[m])
    bound = FWD_RTOL * np.abs(want[m]) + FWD_ATOL
    if not np.all(err <= bound):
        raise AssertionError(
            f"fwd planes differ by {(err / bound).max():.3g}x the tolerance")
    return float(err.max()) if err.size else 0.0


def check_posts(got, want):
    """Posterior planes; returns the max |d|."""
    err = float(np.abs(_host(got) - _host(want)).max())
    if not err <= POST_ATOL:
        raise AssertionError(f"posterior planes differ by {err}")
    return err


def check_totals(got, want):
    """Per-read totals; returns the max relative |d|."""
    got = _host(got).astype(np.float64)
    want = _host(want).astype(np.float64)
    rel = float((np.abs(got - want) / np.abs(want)).max())
    if not rel <= TOTAL_RTOL:
        raise AssertionError(f"totals differ by {rel} (relative)")
    return rel


def _posterior(out, read_idx, x, y):
    """Match posterior of pair (x, y) in a run's windowed plane (0 where
    the cell lies outside the read's window)."""
    prep = out["prep"]
    g, r = divmod(read_idx, prep["R"])
    d = x + y + 2
    lane = x + 1 - int(prep["win"][g, d])
    if not 0 <= lane < prep["W"]:
        return 0.0
    return float(out["posteriors"][g, d, r, lane])


def check_pairs(got, want, got_out, want_out, read_idx, threshold):
    """One read's pair lists (score, x, y) from two runs; returns the
    number of fringe pairs (in one set only)."""
    gs = {(int(x), int(y)): s for s, x, y in got}
    ws = {(int(x), int(y)): s for s, x, y in want}
    for x, y in set(gs) ^ set(ws):
        p = [_posterior(o, read_idx, x, y) for o in (got_out, want_out)]
        if min(abs(v - threshold) for v in p) > FRINGE:
            raise AssertionError(f"read {read_idx} pair {(x, y)} "
                                 f"posteriors {p} differ away from the "
                                 "threshold")
    for key in set(gs) & set(ws):
        if abs(gs[key] - ws[key]) > SCORE_ATOL:
            raise AssertionError(f"read {read_idx} pair {key} scores "
                                 f"{gs[key]} vs {ws[key]}")
    return len(set(gs) ^ set(ws))
