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
  within the posterior tolerance plus two u16 wire steps.  The echelon
  machine's expanded pairs (``check_echelon_pairs``) take the same bars:
  a pair there comes from one cell of one of five match states, and one
  (x, y) can come from several, so its rows pair up by score and a
  pair's fringe is that of its source cells.

EM expectations (``run(expectations=True)``) carry the posterior error of
their terms, so they get the bar that ``tests/test_pallas.py::
test_pallas_expectations_match_engine`` sets for the f32 kernel against
the f64 engine:

- transition sums: |d| <= EXP_TRANS_RTOL * |v| + EXP_TRANS_ATOL;
- gap-X mass per column or per k-mer bin: |d| <= EXP_GAP_RTOL * |v| +
  EXP_GAP_ATOL, and each read's total within EXP_GAP_SUM_RTOL;
- likelihood (total * n_diag): relative |d| <= TOTAL_RTOL, as the totals.

The vanilla expectations (the skip-bin E-step) are per-column masses
binned by k-mer skip bin, as the strawman's gap-X masses are binned by
k-mer, and take the gap-X bars (``check_vanilla_expectations``): skip bins
|d| <= EXP_GAP_RTOL * |v| + EXP_GAP_ATOL, each read's total within
EXP_GAP_SUM_RTOL, likelihoods within TOTAL_RTOL (port and JAX package
differ by ~6e-5 relative in the skip bins on the fixture reads).  A
vanilla pair set on the Zymo read is held to the JAX package's own bar
for the f32 kernel against the f64 engine
(``tests/test_pallas.py::test_vanilla_pallas_matches_engine_pairs``): at
least ZYMO_SHARED of the stored pairs found, at most ZYMO_SYMDIFF pairs
in one set only (``check_pair_sets``).

The dna5 expectations (cPecanEm's E-step) take the same bars: per-column
accumulators as the gap-X columns, finalized transition and emission
expectations (``check_dna5_expectations``) as the transition sums, as
``tests/test_pallas.py::test_dna5_pallas_expectations_match_engine`` holds
the f32 kernel to the f64 engine.  A trained cPecanEm model (normalized
transitions and emissions after a few iterations from the same start,
kept in memory, never rounded through a file) agrees within
|d| <= EM_RTOL * |v| + EM_ATOL, its running likelihoods within
TOTAL_RTOL (``check_em``): port and JAX package differ by ~2e-6 in the
model and ~2e-7 relative in likelihood on the fixture case.

The expectation kernel against its plain version on the same card inputs
runs the same f32 operations in the same order: posts, totals and
transition sums are equal bit for bit, per-column accumulators within
KERNEL_GAPX_ATOL, the margin of a denormal term (the plain version adds
them with a gather and a scatter, which keep denormal terms; an f32
atomic add on the card flushes them, as dna5's expectation kernel's
column adds do).

The tiled path against the untiled one on the same reads
(``tests/test_pallas_tiled.py``'s bar): the re-centering moves the f32
rounding against log totals of -1e3 .. -1e5, so posteriors agree within
TILED_POST_ATOL, totals within TILED_TOTAL_ATOL, and a pair found by one
run only scores at most TILED_POST_ATOL above the threshold; common
scores within TILED_POST_ATOL plus 155 score units.

Long reads (the tiled path, ~27k diagonals; ``fixtures.load_long_read``):
the stored pairs carry no posterior planes, so a pair in one set only must
have its score within FRINGE of the threshold, and common pairs' scores
agree within LONG_SCORE_ATOL (probability units): f32 against the f64
engine drifts along the read (the JAX tiled path: 8 one-sided pairs, all
within 1.4e-4 of the threshold, common scores within 2.08e-2 on the
fixture read), and the port against the JAX tiled path on the CPU agrees
within 3.9e-3.

The 10 kb DNA pair (``fixtures.load_dna5_realign``, ~20,000 diagonals,
tiled) is held to the same bars against the JAX tiled path's pairs, but
against the f64 engine its common scores get LONG_DNA_ENGINE_SCORE_ATOL:
the JAX tiled path itself drifts from the engine by up to 5.11e-2 there
(14 one-sided pairs, all within 3.9e-4 of the threshold), largest near the
start of the pair, where the f32 backward carries the whole pair's mass.

Trained HMMs (Baum-Welch iterations from the same start): each iteration
writes its HMM with six decimals (``%f``) and the next reads it back, so
two runs that agree to ~1e-5 can round a value apart; the second
iteration then moves by up to ~7e-5 in k-mer gap probabilities of up to
~1e-2 (Zymo read, the port against the JAX package).  Transitions keep
the EXP_TRANS bar, k-mer gap probabilities |d| <= EXP_GAP_RTOL * |v| +
TRAIN_GAP_ATOL, likelihoods TOTAL_RTOL.  A trained VanillaHmm's 60 skip
bins (normalized together) take the k-mer gap probabilities' bar: on Zymo
the port is within 1.3e-6 of the JAX package after two iterations.

Posterior tsvs of the signalAlign batch pipeline (``check_tsv``): the
rows of two files, keyed by (strand, reference position, event index),
have the same key sets except rows whose posterior lies within FRINGE of
the threshold in the file that has them; on a shared row every column but
the posterior (column 13) is byte-equal, and the posteriors agree within
TSV_POST_ATOL: the posterior planes' POST_ATOL, plus one step of the u16
compaction (1/65535) and the 1e-6 of the tsv's six decimals.  One u16
step alone does not hold between two f32 runs: a read's log total is
-1e3 .. -1e4, where one f32 ulp is 2^-12 .. 2^-10, so a last-bit
difference in the forward (XLA's and PyTorch's exp and log, or the card's
and the CPU's) moves every posterior near 1 of the strand by 2.4e-4 or
more (Zymo, the port's plain passes against the JAX package's, threeState:
up to 7.33e-4 on the template strand, 2.45e-4 on the complement).  An
echelon tsv can hold several rows of one key (cells of different match
states expand to the same pair): ``check_tsv(multi=True)`` pairs a key's
rows up in posterior order, and a row past the other file's count for its
key is a row in one file only.

The HDP emission stream (``check_hdp_stream``): two builds of the stream
[G, ND+3, R, W] have the same NEG cells (y outside the events, invalid
k-mers, zero densities in log mode), and the other entries agree within
HDP_STREAM_ATOL, the bar ``tests/test_pallas.py::
test_hdp_stream_builds_agree`` holds the JAX package's two builds (matrix
product and scan) to: f32 sums of the spline's four terms in another
order.

Each check raises AssertionError with the size of the miss.
"""

import numpy as np
import torch

from .constants import PAIR_ALIGNMENT_PROB_1
from .ops.compact import host_array as _host
from .ops.fb_kernels import NEG

FWD_RTOL, FWD_ATOL = 1e-5, 1e-3
POST_ATOL = 2e-3
TOTAL_RTOL = 1e-4
FRINGE = 2e-3
SCORE_ATOL = POST_ATOL * 1e7 + 2 * 153
EXP_TRANS_RTOL, EXP_TRANS_ATOL = 2e-3, 1e-3
EXP_GAP_RTOL, EXP_GAP_ATOL = 5e-3, 1e-3
EXP_GAP_SUM_RTOL = 2e-3
TRAIN_GAP_ATOL = 1e-4
KERNEL_GAPX_ATOL = 1e-30
EM_RTOL, EM_ATOL = 1e-3, 2e-5
ZYMO_SHARED, ZYMO_SYMDIFF = 0.98, 1
LONG_SCORE_ATOL = 2.5e-2
LONG_DNA_ENGINE_SCORE_ATOL = 6e-2
TILED_POST_ATOL, TILED_TOTAL_ATOL = 1e-2, 5e-2
TSV_POST_ATOL = POST_ATOL + 1.0 / 65535.0 + 1e-6
TSV_POSTERIOR_COLUMN = 12   # 0-based: column 13 of writePosteriorProbs
HDP_STREAM_ATOL = 1e-4


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


def check_hdp_stream(got, want):
    """Two HDP emission streams [G, ND+3, R, W]: equal NEG masks (entries
    below -1e29), the rest within HDP_STREAM_ATOL; returns the max |d|."""
    got, want = _host(got), _host(want)
    if got.shape != want.shape:
        raise AssertionError(f"streams of shapes {got.shape} and "
                             f"{want.shape}")
    neg = want < -1e29
    if not np.array_equal(neg, got < -1e29):
        raise AssertionError(f"the streams' NEG masks differ in "
                             f"{int((neg != (got < -1e29)).sum())} cells")
    err = float(np.abs(np.where(neg, 0.0, got - want)).max())
    if not err < HDP_STREAM_ATOL:
        raise AssertionError(f"streams differ by {err}")
    return err


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


def _close(what, got, want, rtol, atol):
    """max |d| of two arrays held to |d| <= rtol * |want| + atol."""
    got = _host(got).astype(np.float64)
    want = _host(want).astype(np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shapes {got.shape} vs {want.shape}")
    err = np.abs(got - want)
    bound = rtol * np.abs(want) + atol
    if not np.all(err <= bound):
        raise AssertionError(
            f"{what} differ by {(err / bound).max():.3g}x the tolerance")
    return float(err.max()) if err.size else 0.0


def _rel(what, got, want, rtol):
    got = _host(got).astype(np.float64)
    want = _host(want).astype(np.float64)
    rel = float((np.abs(got - want) / np.abs(want)).max())
    if not rel <= rtol:
        raise AssertionError(f"{what} differ by {rel} (relative)")
    return rel


def check_exp_sums(trans, gapx, want_trans, want_gapx):
    """The expectation backward's sums: trans [G, R, S*S] and the
    per-column accumulators gapx [G, NACC, R, X]; returns (trans max |d|,
    accumulators max |d|)."""
    err_t = _close("transition sums", trans, want_trans, EXP_TRANS_RTOL,
                   EXP_TRANS_ATOL)
    err_g = _close("per-column accumulators", gapx, want_gapx, EXP_GAP_RTOL,
                   EXP_GAP_ATOL)
    _rel("per-read accumulated mass", _host(gapx).sum(-1).sum(1),
         _host(want_gapx).sum(-1).sum(1), EXP_GAP_SUM_RTOL)
    return err_t, err_g


def check_exp_kernel(got, want):
    """The expectation kernel's (posts, totals, trans, gapx) against its
    plain version's on the same inputs; returns the gapx max |d|."""
    for what, g, w in zip(("posterior planes", "totals", "transition sums"),
                          got[:3], want[:3]):
        if not torch.equal(g, w):
            raise AssertionError(
                f"{what} differ from the plain version by "
                f"{float((g - w).abs().max())}")
    err = float((got[3] - want[3]).abs().max())
    if not err <= KERNEL_GAPX_ATOL:
        raise AssertionError(f"per-column accumulators differ from the "
                             f"plain version by {err}")
    return err


def check_expectations(got, want):
    """Finalized per-read expectations {"trans", "kmer_gap",
    "likelihood"}; returns the transition sums' max |d|."""
    err = _close("transition expectations", got["trans"], want["trans"],
                 EXP_TRANS_RTOL, EXP_TRANS_ATOL)
    _close("k-mer gap expectations", got["kmer_gap"], want["kmer_gap"],
           EXP_GAP_RTOL, EXP_GAP_ATOL)
    _rel("per-read k-mer gap mass", np.sum(got["kmer_gap"], -1),
         np.sum(want["kmer_gap"], -1), EXP_GAP_SUM_RTOL)
    _rel("likelihoods", got["likelihood"], want["likelihood"], TOTAL_RTOL)
    return err


def check_vanilla_expectations(got, want):
    """Finalized per-read vanilla expectations {"skip_bins" [B, 60],
    "likelihood" [B]}; returns the skip bins' max |d|."""
    err = _close("skip-bin expectations", got["skip_bins"],
                 want["skip_bins"], EXP_GAP_RTOL, EXP_GAP_ATOL)
    _rel("per-read skip-bin mass", np.sum(got["skip_bins"], -1),
         np.sum(want["skip_bins"], -1), EXP_GAP_SUM_RTOL)
    _rel("likelihoods", got["likelihood"], want["likelihood"], TOTAL_RTOL)
    return err


def check_dna5_expectations(got, want):
    """Finalized per-read dna5 expectations {"trans" [B, 5, 5], "emis"
    [B, 5, 4, 4], "likelihood" [B]}; returns (trans max |d|, emis
    max |d|)."""
    err_t = _close("transition expectations", got["trans"], want["trans"],
                   EXP_TRANS_RTOL, EXP_TRANS_ATOL)
    err_e = _close("emission expectations", got["emis"], want["emis"],
                   EXP_TRANS_RTOL, EXP_TRANS_ATOL)
    _rel("likelihoods", got["likelihood"], want["likelihood"], TOTAL_RTOL)
    return err_t, err_e


def check_em(transitions, emissions, running, want_transitions,
             want_emissions, want_running):
    """A trained cPecanEm model (normalized transitions and emissions) and
    its running likelihoods against another run's; returns the model's
    max |d|."""
    err = max(_close("EM transitions", transitions, want_transitions,
                     EM_RTOL, EM_ATOL),
              _close("EM emissions", emissions, want_emissions, EM_RTOL,
                     EM_ATOL))
    _close("running likelihoods", np.asarray(running, np.float64),
           np.asarray(want_running, np.float64), TOTAL_RTOL, 0.0)
    return err


def check_trained(t_hmm, c_hmm, trajectory, want, first=False):
    """Trained template/complement HMMs and the likelihood trajectory
    against ``want``: ContinuousPairHmm against the arrays of
    tests/fixtures/zymo_train.npz, VanillaHmm (``kmer_skip_bins``) against
    those of tests/fixtures/vanilla_zymo.npz; its last iteration, or with
    ``first`` its first (``t1_*``/``c1_*`` and the first trajectory row).
    Returns the transitions' (vanilla: the skip bins') max |d|."""
    tag = "1" if first else ""
    want_traj = want["trajectory"][:1] if first else want["trajectory"]
    err = 0.0
    for name, hmm in (("t", t_hmm), ("c", c_hmm)):
        if hasattr(hmm, "kmer_skip_bins"):
            err = max(err, _close(f"{name} skip bins", hmm.kmer_skip_bins,
                                  want[f"{name}{tag}_skip"], EXP_GAP_RTOL,
                                  TRAIN_GAP_ATOL))
            continue
        err = max(err, _close(f"{name} transitions", hmm.transitions,
                              want[f"{name}{tag}_trans"], EXP_TRANS_RTOL,
                              EXP_TRANS_ATOL))
        _close(f"{name} k-mer gap probabilities", hmm.kmer_gap_probs,
               want[f"{name}{tag}_kmer_gap"], EXP_GAP_RTOL, TRAIN_GAP_ATOL)
    _rel("likelihood trajectories", np.asarray(trajectory, np.float64),
         want_traj, TOTAL_RTOL)
    return err


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


def _echelon_posterior(out, read_idx, x, y, j):
    """Posterior of match state j + 1 at cell (x, y) (1-based) in a run's
    multi-state plane [G, ND+1, NP, R, W] (0 outside the read's window)."""
    prep = out["prep"]
    g, r = divmod(read_idx, prep["R"])
    d = x + y
    if not 0 < d < out["posteriors"].shape[1]:
        return 0.0
    lane = x - int(prep["win"][g, d])
    if not 0 <= lane < prep["W"]:
        return 0.0
    return float(out["posteriors"][g, d, j, r, lane])


def check_echelon_pairs(got, want, got_out, want_out, read_idx, threshold):
    """One read's expanded echelon pairs (score, x, y) from two runs: each
    (x, y) may come from several cells (state j + 1 at (x - n + 1, y + 1)
    emits it for n <= j).  The pairs of a key pair up in order of their
    scores, highest first, within SCORE_ATOL; a pair one run has past the
    other's count for its key must have a source cell whose posterior lies
    within FRINGE of the threshold in either run.  Returns the number of
    such fringe pairs."""
    gs, ws = {}, {}
    for rows, dst in ((got, gs), (want, ws)):
        for s, x, y in rows:
            dst.setdefault((int(x), int(y)), []).append(int(s))
    n_one = 0
    for key in set(gs) | set(ws):
        g = sorted(gs.get(key, []), reverse=True)
        w = sorted(ws.get(key, []), reverse=True)
        n = min(len(g), len(w))
        for a, b in zip(g[:n], w[:n]):
            if abs(a - b) > SCORE_ATOL:
                raise AssertionError(f"read {read_idx} pair {key} scores "
                                     f"{a} vs {b}")
        if len(g) == len(w):
            continue
        n_one += abs(len(g) - len(w))
        px, py = key
        near = False
        for j in range(5):
            for n in range(j + 1):
                # the cell (x, y) of state j + 1 emitting (x + n - 1, y - 1)
                x, y = px - n + 1, py + 1
                p = [_echelon_posterior(o, read_idx, x, y, j)
                     for o in (got_out, want_out)]
                if ((p[0] >= threshold) != (p[1] >= threshold)
                        and min(abs(v - threshold) for v in p) <= FRINGE):
                    near = True
        if not near:
            raise AssertionError(f"read {read_idx} pair {key}: {len(g)} vs "
                                 f"{len(w)} rows, no source cell near the "
                                 "threshold")
    return n_one


def check_pair_sets(got, want):
    """Two pair sets {(x, y)} of one read: at least ZYMO_SHARED of
    ``want`` in ``got`` and at most ZYMO_SYMDIFF pairs in one set only;
    returns (shared, in one set only)."""
    shared, one = len(got & want), len(got ^ want)
    if shared < ZYMO_SHARED * len(want) or one > ZYMO_SYMDIFF:
        raise AssertionError(f"{shared} of {len(want)} pairs shared, {one} "
                             "in one set only")
    return shared, one


def check_long_pairs(got, want, threshold, score_atol=LONG_SCORE_ATOL):
    """(score, x, y) rows of one long read against a stored set [N, 3]
    (common scores within ``score_atol``, one-sided pairs within FRINGE of
    the threshold); returns (pairs in one set only, their largest distance
    from the threshold, the largest common-score |d|), the last two in
    probability units."""
    gs = {(int(x), int(y)): int(s) for s, x, y in np.asarray(got).tolist()}
    ws = {(int(x), int(y)): int(s) for s, x, y in np.asarray(want).tolist()}
    one = set(gs) ^ set(ws)
    fringe = max((abs(gs.get(k, ws.get(k)) / PAIR_ALIGNMENT_PROB_1
                      - threshold) for k in one), default=0.0)
    if fringe > FRINGE:
        raise AssertionError(f"{len(one)} pairs in one set only, up to "
                             f"{fringe:.3g} from the threshold")
    common = max((abs(gs[k] - ws[k]) / PAIR_ALIGNMENT_PROB_1
                  for k in set(gs) & set(ws)), default=0.0)
    if common > score_atol:
        raise AssertionError(f"common pair scores differ by {common:.3g}")
    return len(one), fringe, common


def check_tiled(posts_t, totals_t, posts_u, totals_u):
    """A tiled run's posteriors [G, NDT+1, R, W] and totals against an
    untiled run's [G, ND+1, R, W] (the rows past ND must be 0); returns
    (posteriors max |d|, totals max |d|)."""
    pt, pu = _host(posts_t), _host(posts_u)
    if np.any(pt[:, pu.shape[1]:] != 0.0):
        raise AssertionError("tiled posteriors past ND are not 0")
    err = float(np.abs(pt[:, :pu.shape[1]] - pu).max())
    if not err <= TILED_POST_ATOL:
        raise AssertionError(f"tiled posteriors differ by {err}")
    terr = float(np.abs(_host(totals_t).astype(np.float64)
                        - _host(totals_u)).max())
    if not terr <= TILED_TOTAL_ATOL:
        raise AssertionError(f"tiled totals differ by {terr}")
    return err, terr


def check_tiled_pairs(got, want, threshold):
    """One read's (score, x, y) rows from a tiled run against an untiled
    run's; returns the number of pairs in one set only."""
    gs = {(int(x), int(y)): int(s) for s, x, y in np.asarray(got).tolist()}
    ws = {(int(x), int(y)): int(s) for s, x, y in np.asarray(want).tolist()}
    near = (threshold + TILED_POST_ATOL) * PAIR_ALIGNMENT_PROB_1
    for k in set(gs) ^ set(ws):
        if gs.get(k, ws.get(k)) > near:
            raise AssertionError(f"pair {k} scores {gs.get(k, ws.get(k))} "
                                 "in one run only")
    tol = TILED_POST_ATOL * PAIR_ALIGNMENT_PROB_1 + 155
    for k in set(gs) & set(ws):
        if abs(gs[k] - ws[k]) > tol:
            raise AssertionError(f"pair {k} scores {gs[k]} vs {ws[k]}")
    return len(set(gs) ^ set(ws))


def _tsv_rows(text, multi=False):
    """{(strand, reference position, event index): the row's 15 fields} of
    a posterior tsv's text (str or bytes); with ``multi`` {key: [rows,
    highest posterior first]}, for the echelon expansion, where several
    cells can emit the same pair."""
    if isinstance(text, bytes):
        text = text.decode()
    rows = {}
    for line in text.splitlines():
        f = line.split("\t")
        if len(f) != 15:
            raise AssertionError(f"tsv row with {len(f)} fields: {line!r}")
        key = (f[4], int(f[1]), int(f[5]))
        if multi:
            rows.setdefault(key, []).append(f)
            continue
        if key in rows:
            raise AssertionError(f"tsv row {key} twice")
        rows[key] = f
    if multi:
        for v in rows.values():
            v.sort(key=lambda f: -float(f[TSV_POSTERIOR_COLUMN]))
    return rows


def check_tsv(got, want, threshold=0.01, multi=False):
    """Two posterior tsvs (text or bytes) of the same read; returns (rows
    in one file only, the largest posterior |d| on shared rows).  With
    ``multi`` (echelon) a key may hold several rows: the rows of a key pair
    up in order of their posteriors, highest first, and the rows one file
    has past the other's count are its rows in one file only."""
    gr, wr = _tsv_rows(got, multi), _tsv_rows(want, multi)
    if not wr:
        raise AssertionError("the reference tsv has no rows")
    if not multi:
        gr = {k: [v] for k, v in gr.items()}
        wr = {k: [v] for k, v in wr.items()}
    col = TSV_POSTERIOR_COLUMN
    one = []
    err = 0.0
    for key in set(gr) | set(wr):
        g, w = gr.get(key, []), wr.get(key, [])
        n = min(len(g), len(w))
        one += [(key, f) for f in g[n:] + w[n:]]
        for gf, wf in zip(g[:n], w[:n]):
            if gf[:col] != wf[:col] or gf[col + 1:] != wf[col + 1:]:
                raise AssertionError(f"tsv row {key} differs: {gf} vs {wf}")
            err = max(err, abs(float(gf[col]) - float(wf[col])))
    for key, f in one:
        p = float(f[col])
        if abs(p - threshold) > FRINGE:
            raise AssertionError(f"tsv row {key} (posterior {p}) in one "
                                 "file only, away from the threshold")
    if not err <= TSV_POST_ATOL:
        raise AssertionError(f"tsv posteriors differ by {err}")
    return len(one), err
