"""Synthetic kernel inputs shared by the tests of the port's CUDA kernels:
``tests/test_torch_gpu.py`` (the kernels on the card) and
``tests/test_torch_wavefront_emulated.py`` (the kernels' source compiled for
the CPU).  Imports no JAX."""

import numpy as np
import torch

from cpecan_tpu_torch.ops import fb_kernels as fk


def synthetic_case(cuda, spec, W, ND, ragged, seed, every=False, scal=None,
                   edge=False):
    """Synthetic inputs of ``spec`` (dna5, strawman, sm4, vanilla, echelon
    or hdp) at window W over ND diagonals: G 2 x R 2 reads (G 1 at W
    1024) on ``cuda`` (a device).  Each group's band lower edge steps by 0
    or 1 a diagonal (x ~ d / 2, as a real band's) and its window by 0, 1
    or 2, mostly 0, so the band drifts across the window's lanes, and over
    128 diagonals or more it steps by each of 0, 1 and 2 (asserted); with
    ``every`` the edge steps by 1 from diagonal 20 on and the window with
    it, so that it shifts on (asserted: over 95% of) the diagonals there.
    The dna5 draws at a given seed are those the dna5 tiled cases have
    always drawn.  Each read's band ends at its seed diagonal (within 40
    of ND).  Random rows and scalars (``scal``, if given, replaces the
    latter): dna5 y bases 0..4 (4 = N) and a few outside 0..4,
    log-probability rows; strawman and sm4
    Gaussian model rows with a few sd <= 0 (NEG emissions), events near the
    model means, a gap-X log-probability row; vanilla Gaussian level and
    inverse-Gaussian noise rows with a few sd <= 0, lambda <= 0 and noise
    means of 0, noise near the noise means with a few zeros, log
    transition rows; echelon the vanilla's level and noise rows for each
    offset and for gap-Y, log skip rows, random validity bits, log
    duration rows; hdp the strawman's rows (nothing reads rows 0-7) and a
    stream est [G, ND+3, R, W] of log densities, about 5% of them NEG.
    With ``edge`` every read's band is its group's whole window (base the
    window's start, width W) up to its seed diagonal, so that the lanes at
    the window's edges lie in the band: where the window stays at d + 1
    and moves at d + 2, the backward's carried emissions at lane l + o1 +
    1 = W lie outside the window while their stream entry, at lane l + o2
    + 1, lies inside (asserted for ND >= 100).  Returns (fwd args, bwd args,
    dims; a streamed spec's dims hold ``est``)."""
    rng = np.random.default_rng(seed)
    G, R = (1 if W == 1024 else 2), 2
    NDp = -(-(ND + 3) // 128) * 128 + 128
    X, C = W + 2 * NDp, ND + 3
    Y = C + X + 256
    wmin, wmax = min(W // 2, 48), min(W - W // 4, 96)
    lo = np.zeros((G, NDp), np.int64)   # the group's band lower edge
    win = np.zeros((G, NDp), np.int64)
    for g in range(G):
        for d in range(1, NDp):
            lo[g, d] = lo[g, d - 1] + (int(d > 20) if every
                                       else rng.integers(0, 2))
            off = lo[g, d] - win[g, d - 1]
            # a window step keeping lanes [off, off + wmax) in the window:
            # 0 preferred (the band drifts across the lanes), or with
            # ``every`` 1 (the window follows the band)
            ok = [s for s in (0, 1, 2) if 0 <= off - s <= W - wmax - 2]
            p = np.array([0.01, 1.0, 0.01] if every
                         else [6.0, 1.0, 1.0])[ok]
            win[g, d] = win[g, d - 1] + rng.choice(ok, p=p / p.sum())
    steps = np.diff(win[:, :ND + 3])
    if every:
        # the window moves on nearly every diagonal past 20
        assert np.mean(steps[:, 20:] != 0) > 0.95
    elif ND >= 128:
        assert set(steps.ravel()) == {0, 1, 2}
    B = G * R
    base, width, seedf = (np.zeros((B, NDp)) for _ in range(3))
    for b in range(B):
        n = ND - int(rng.integers(0, min(40, ND)))
        base[b, :n + 1] = lo[b // R, :n + 1] + rng.integers(0, 2, n + 1)
        width[b, :n + 1] = rng.integers(wmin, wmax + 1, n + 1)
        seedf[b, n] = 1.0
        if edge:
            base[b, :n + 1] = win[b // R, :n + 1]
            width[b, :n + 1] = W
    if edge and ND >= 100:
        # below every read's seed diagonal
        d = np.arange(1, ND - 39)
        assert np.any((win[:, d + 1] == win[:, d])
                      & (win[:, d + 2] > win[:, d + 1]))
    if spec is fk.Dna5Spec:
        ybase = rng.choice([0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 0.5], size=(B, Y),
                           p=[0.22, 0.22, 0.22, 0.22, 0.08, 0.02, 0.02])
        yf = np.stack([ybase, np.log(rng.uniform(0.05, 0.9, (B, Y)))],
                      axis=1)
        # the random scalars are drawn before the x rows (the dna5 tiled
        # cases' draws since they were written)
        rscal = np.log(rng.uniform(0.05, 0.9, spec.NS + 3 * spec.S))
        xf = np.log(rng.uniform(0.05, 0.9, (B, 6, X)))
    elif spec is fk.VanillaSpec:
        # level (mean, sd) rows 0-1 and 4-5, noise (mean, lambda) rows 2-3
        # and 6-7, a few sd <= 0, lambda <= 0 and noise means of 0; the
        # log transitions of rows 8-12; events near the level means, noise
        # near the noise means, a few <= 0
        xf = np.empty((B, 13, X))
        xf[:, 0:8:4] = rng.uniform(70.0, 90.0, (B, 2, X))
        xf[:, 1:8:4] = rng.uniform(3.0, 12.0, (B, 2, X))
        xf[:, 2:8:4] = rng.uniform(0.8, 2.5, (B, 2, X))
        xf[:, 3:8:4] = rng.uniform(5.0, 60.0, (B, 2, X))
        for r0, bad_vals in ((1, [0.0, -1.0]), (2, [0.0]), (3, [0.0, -2.0])):
            bad = rng.random((B, 2, X)) < 0.01
            xf[:, r0:8:4][bad] = rng.choice(bad_vals, bad.sum())
        xf[:, 8:] = np.log(rng.uniform(0.05, 0.9, (B, 5, X)))
        yf = np.stack([rng.uniform(70.0, 90.0, (B, Y)),
                       rng.uniform(0.5, 3.0, (B, Y))], axis=1)
        yf[:, 1][rng.random((B, Y)) < 0.001] = 0.0
        rscal = np.log(rng.uniform(0.05, 0.9, spec.NS + 3 * spec.S))
    elif spec is fk.EchelonSpec:
        # per offset and for gap-Y: level (mean, sd) and noise (mean,
        # lambda), a few sd <= 0, lambda <= 0 and noise means of 0; the
        # skip logs (rows 24-27) and the validity bits (28-32); durations
        # as log probabilities, events near the level means, noise near
        # the noise means with a few zeros
        xf = np.empty((B, 33, X))
        xf[:, 0:24:4] = rng.uniform(70.0, 90.0, (B, 6, X))
        xf[:, 1:24:4] = rng.uniform(3.0, 12.0, (B, 6, X))
        xf[:, 2:24:4] = rng.uniform(0.8, 2.5, (B, 6, X))
        xf[:, 3:24:4] = rng.uniform(5.0, 60.0, (B, 6, X))
        for r0, bad_vals in ((1, [0.0, -1.0]), (2, [0.0]), (3, [0.0, -2.0])):
            bad = rng.random((B, 6, X)) < 0.01
            xf[:, r0:24:4][bad] = rng.choice(bad_vals, bad.sum())
        xf[:, 24:28] = np.log(rng.uniform(0.05, 0.9, (B, 4, X)))
        xf[:, 28:] = rng.integers(0, 2, (B, 5, X))
        yf = np.concatenate([np.log(rng.uniform(0.05, 0.9, (B, 6, Y))),
                             rng.uniform(70.0, 90.0, (B, 1, Y)),
                             rng.uniform(0.5, 3.0, (B, 1, Y))], axis=1)
        yf[:, 7][rng.random((B, Y)) < 0.001] = 0.0
        rscal = np.log(rng.uniform(0.05, 0.9, spec.NS + 3 * spec.S))
    else:
        xf = np.empty((B, 9, X))
        xf[:, 0:8:2] = rng.uniform(70.0, 90.0, (B, 4, X))
        xf[:, 1:8:2] = rng.uniform(3.0, 12.0, (B, 4, X))
        bad = rng.random((B, 4, X)) < 0.01
        xf[:, 1:8:2][bad] = rng.choice([0.0, -1.0], bad.sum())
        xf[:, 8] = np.log(rng.uniform(0.05, 0.9, (B, X)))
        yf = rng.uniform(70.0, 90.0, (B, 2, Y))
        rscal = np.log(rng.uniform(0.05, 0.9, spec.NS + 3 * spec.S))
    if fk.streamed(spec):
        est = np.log(rng.uniform(1e-4, 0.5, (G, ND + 3, R, W)))
        est[rng.random(est.shape) < 0.05] = fk.NEG

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=cuda)

    if scal is None:
        scal = dev(rscal)
    fa = [scal, dev(win, torch.int32), dev(xf), dev(yf), dev(base),
          dev(width)]
    ba = fa + [dev(seedf), dev(seedf * float(ragged))]
    dims = dict(R=R, W=W, ND=ND, C=C, spec=spec)
    if fk.streamed(spec):
        dims["est"] = dev(est)
    return fa, ba, dims
