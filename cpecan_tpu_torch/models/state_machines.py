"""Pair-HMM state machines of the port (counterpart of
``cpecan_tpu/models/state_machines.py``).

The strawman, HDP and vanilla 3-state signal machines, the 4-state
signal machine, the 7-state echelon machine (and its echelonB variant) and
the 5-state DNA machine, each an ``nn.Module`` whose
buffers are the model tables the wavefront kernels gather from: moving
the module to a device moves its tables once, which takes the place of
the JAX aligner's per-machine table cache (``pallas_fb.py:1575``
``_model_cache``).  Each gives the kernels' scalars (``scalars``),
uploaded without waiting for queued kernels.
"""

import numpy as np
import torch
from torch import nn

from ..constants import GAP_X, LOG_ZERO, MATCH1, NUM_OF_KMERS
from ..io.poremodel import (LEVEL_MEAN, LEVEL_SD, NOISE_LAMBDA, NOISE_MEAN,
                            PoreModel)
from ..models import kmers
from ..ops.features import upload
from ..ops.fb_kernels import NEG

LOG_TENTH = -2.3025850929940455  # log(0.1), impl/stateMachine.c:1557

# impl/stateMachine.c:1279-1290
SM3_NANOPORE_DEFAULTS = dict(
    match_continue=-0.23552123624314988,
    match_from_gap_x=-0.21880828092192281,
    match_from_gap_y=-0.013406326748077823,
    gap_open_x=-1.6269694202638481,
    gap_open_y=-4.3187242127300092,
    gap_extend_x=-1.6269694202638481,
    gap_extend_y=-4.3187242127239411,
    gap_switch_to_x=LOG_ZERO,
    gap_switch_to_y=LOG_ZERO,
)


class StateMachine3SignalStrawman(nn.Module):
    """threeState nanopore signal machine ("strawMan",
    getStrawManStateMachine3, impl/stateMachine.c:1775-1785).

    X = reference 6-mers, Y = events.  Match and gap-Y emissions are
    independent Gaussians over (event mean, event noise); gap-X emission
    is a per-kmer table initialised to log(0.1).

    Buffers (f32): ``match_model`` [4096, 5] and ``gap_y_model`` [4096, 4]
    (the pore model's columns), ``gap_x`` [4096] (log probabilities, -inf
    clamped to NEG).  ``p`` holds the transition log probabilities.
    """

    S = 3

    def __init__(self, model: PoreModel, params=None, gap_x_log_probs=None):
        super().__init__()
        self.model = model
        self.p = dict(params or SM3_NANOPORE_DEFAULTS)
        self.gap_x_log_probs = (np.full(NUM_OF_KMERS, LOG_TENTH)
                                if gap_x_log_probs is None
                                else np.asarray(gap_x_log_probs))
        self.register_buffer("match_model", torch.from_numpy(np.asarray(
            model.match_model[:, :5], np.float32).copy()))
        self.register_buffer("gap_y_model", torch.from_numpy(np.asarray(
            model.gap_y_model[:, :4], np.float32).copy()))
        self.register_buffer("gap_x", torch.from_numpy(np.nan_to_num(
            np.asarray(self.gap_x_log_probs, np.float32), neginf=NEG)))

    # impl/stateMachine.c:1169-1208
    def start_vec(self):
        return [0.0, LOG_ZERO, LOG_ZERO]

    def ragged_start_vec(self):
        return [LOG_ZERO, 0.0, 0.0]

    def end_vec(self):
        p = self.p
        return [p["match_continue"], p["match_from_gap_x"],
                p["match_from_gap_y"]]

    def ragged_end_vec(self):
        p = self.p
        return [(p["gap_open_x"] + p["gap_open_y"]) / 2.0,
                p["gap_extend_x"], p["gap_extend_y"]]

    def scalars(self, ragged_left=False):
        """Kernel scalars [1, 17] f32 on the buffers' device:
        [8 transitions, start(3), end(3), ragged_end(3)], -inf clamped to
        NEG in f64 before the cast (``StrawmanPallasAligner._scalars``,
        pallas_fb.py:1486-1497)."""
        return _sm3_scalars(self, ragged_left, self.match_model.device)


def _sm3_scalars(sm, ragged_left, device):
    """The 3-state signal machines' kernel scalars (strawman, HDP)."""
    p = sm.p
    vals = [p["match_continue"], p["match_from_gap_x"],
            p["match_from_gap_y"], p["gap_open_x"], p["gap_extend_x"],
            p["gap_switch_to_x"], p["gap_open_y"], p["gap_extend_y"]]
    start = sm.ragged_start_vec() if ragged_left else sm.start_vec()
    return _scalar_tensor(vals + list(start) + list(sm.end_vec())
                          + list(sm.ragged_end_vec()), device)


def _scalar_tensor(vals, device):
    """Kernel scalars [1, n] f32 on ``device`` from log values: -inf
    clamped to NEG in f64 before the cast."""
    arr = np.array([vals], dtype=np.float64)
    arr = np.maximum(np.nan_to_num(arr, neginf=NEG), NEG)
    return upload(arr.astype(np.float32), device)


def _pore_model_from_jax(m):
    """The port's ``PoreModel`` with the fields of the JAX package's."""
    return PoreModel(float(m.match_correlation),
                     np.asarray(m.match_model, np.float64),
                     np.asarray(m.skip_bins, np.float64),
                     float(m.gap_y_correlation),
                     np.asarray(m.gap_y_model, np.float64))


def machine_from_jax(sm):
    """The port's strawman machine with the weights of the JAX package's
    ``StateMachine3SignalStrawman``.

    Reads only numpy and float attributes (``sm.p``, ``sm.gap_x_log_probs``
    and the fields of ``sm.model``), so it needs no JAX import of its own;
    the JAX package's pore model becomes the port's ``PoreModel``."""
    return StateMachine3SignalStrawman(_pore_model_from_jax(sm.model),
                                       params=sm.p,
                                       gap_x_log_probs=sm.gap_x_log_probs)


# Template-read transition defaults of the 4-state machine
# (impl/stateMachine.c:996-1012)
SM4_DEFAULTS = dict(
    match_continue=-0.23552123624314988,
    gap_short_open_x=-1.6269694202638481,
    gap_short_open_y=-4.7241893208381773,
    gap_long_open_x=-5.4173365013981227,
    gap_short_extend_x=-1.6269694202638481,
    match_from_short_gap_x=-0.21880828092192281,
    gap_long_extend_x=-0.003442492794189331,
    match_from_long_gap_x=-5.6732801731704612,
    match_from_short_gap_y=-0.013406326748077823,
    gap_short_extend_y=-4.724189320832104,
    gap_long_switch_to_x=-5.4173365013920494,
)


class StateMachine4(StateMachine3SignalStrawman):
    """fourState signal machine (getStateMachine4,
    impl/stateMachine.c:961-1040, 1800-1809): match, shortGapX (skip),
    shortGapY (extra event), longGapX.  The strawman's emissions and
    buffers, but stateMachine4_construct leaves the gap-X table at the
    zeros of emissions_signal_initEmissionsToZero (:1037), where the
    strawman fills log(0.1)."""

    S = 4

    def __init__(self, model: PoreModel, params=None, gap_x_log_probs=None):
        super().__init__(model, params=dict(params or SM4_DEFAULTS),
                         gap_x_log_probs=(np.zeros(NUM_OF_KMERS)
                                          if gap_x_log_probs is None
                                          else gap_x_log_probs))

    def start_vec(self):
        return [0.0, LOG_ZERO, LOG_ZERO, LOG_ZERO]

    def ragged_start_vec(self):
        # stateMachine4_raggedStartStateProb (impl/stateMachine.c:792-795)
        return [LOG_ZERO, LOG_ZERO, 0.0, 0.0]

    def end_vec(self):
        p = self.p
        return [p["match_continue"], p["match_from_short_gap_x"],
                p["match_from_short_gap_y"], p["match_from_long_gap_x"]]

    def ragged_end_vec(self):
        p = self.p
        return [p["gap_long_open_x"], p["gap_long_open_x"],
                p["gap_long_open_x"], p["gap_long_extend_x"]]

    def scalars(self, ragged_left=False):
        """Kernel scalars [1, 23] f32 on the buffers' device: [11
        transitions (lower 5, middle 4, upper 2), start(4), end(4),
        ragged_end(4)], -inf clamped to NEG in f64 before the cast
        (``Sm4PallasAligner._scalars``, pallas_fb.py:3069-3081)."""
        p = self.p
        vals = [p["gap_short_open_x"], p["gap_short_extend_x"],
                p["gap_long_open_x"], p["gap_long_extend_x"],
                p["gap_long_switch_to_x"],
                p["match_continue"], p["match_from_short_gap_x"],
                p["match_from_short_gap_y"], p["match_from_long_gap_x"],
                p["gap_short_open_y"], p["gap_short_extend_y"]]
        start = self.ragged_start_vec() if ragged_left else self.start_vec()
        return _scalar_tensor(vals + list(start) + list(self.end_vec())
                              + list(self.ragged_end_vec()),
                              self.match_model.device)


def machine4_from_jax(sm):
    """The port's 4-state machine with the weights of the JAX package's
    ``StateMachine4``: reads only ``sm.p``, ``sm.gap_x_log_probs`` and the
    numpy fields of ``sm.model``."""
    return StateMachine4(_pore_model_from_jax(sm.model), params=sm.p,
                         gap_x_log_probs=np.asarray(sm.gap_x_log_probs,
                                                    np.float64))


# the vanilla model columns the kernels read (_model_tables, pallas_fb.py
# :2652): the noise lambda, not the noise sd
VANILLA_MODEL_COLUMNS = [LEVEL_MEAN, LEVEL_SD, NOISE_MEAN, NOISE_LAMBDA]


class StateMachine3Vanilla(nn.Module):
    """Nanopolish-style vanilla 3-state signal machine
    (getSignalStateMachine3Vanilla, impl/stateMachine.c:1368-1409; the
    reference signalAlign's default): per-column transitions from k-mer
    skip probabilities in 30 |delta level mean| bins, Gaussian level x
    inverse-Gaussian noise emissions, a silent gap-X.

    Buffers (f32): ``match4`` and ``gap_y4`` [4096, 4], the pore model's
    level mean, level sd, noise mean and noise lambda columns; ``skip60``
    [60], the skip-bin probabilities (beta [0:30], alpha [30:60]; by
    default the pore model's 30 bins twice, as
    emissions_signal_loadPoreModel reads them).  The strand sets M -> Y's
    share of the non-skip mass (``t_m_to_y_not_x``) and Y -> Y
    (``t_e_to_e``), impl/stateMachine.c:1292-1304, 1625-1629."""

    S = 3

    def __init__(self, model: PoreModel, strand="template",
                 skip_bin_probs=None):
        super().__init__()
        self.model = model
        if strand == "template":
            self.t_m_to_y_not_x, self.t_e_to_e = 0.17, 0.55
        else:
            self.t_m_to_y_not_x, self.t_e_to_e = 0.14, 0.49
        if skip_bin_probs is None:
            skip_bin_probs = np.concatenate([model.skip_bins,
                                             model.skip_bins])
        self.skip_bin_probs = np.asarray(skip_bin_probs, np.float64)
        self.default_end_match_prob = -0.23552123624314988
        self.default_end_from_x_prob = -1.6269694202638481
        self.default_end_from_y_prob = -4.3187242127300092
        cols = VANILLA_MODEL_COLUMNS
        # the host copy of the level means gives the expectation finalize
        # its skip bins without reading the card
        self.level_mean = np.asarray(model.match_model[:, LEVEL_MEAN],
                                     np.float32)
        self.register_buffer("match4", torch.from_numpy(np.asarray(
            model.match_model[:, cols], np.float32).copy()))
        self.register_buffer("gap_y4", torch.from_numpy(np.asarray(
            model.gap_y_model[:, cols], np.float32).copy()))
        self.register_buffer("skip60", torch.from_numpy(np.asarray(
            self.skip_bin_probs, np.float32).copy()))

    def start_vec(self):
        return [0.0, LOG_ZERO, LOG_ZERO]

    def ragged_start_vec(self):
        return [LOG_ZERO, 0.0, 0.0]

    def end_vec(self):
        return [self.default_end_match_prob, self.default_end_from_x_prob,
                self.default_end_from_y_prob]

    def ragged_end_vec(self):
        # impl/stateMachine.c:1210-1222
        return [(self.default_end_from_x_prob
                 + self.default_end_from_y_prob) / 2.0,
                self.default_end_from_x_prob, self.default_end_from_y_prob]

    def scalars(self, ragged_left=False):
        """Kernel scalars [1, 11] f32 on the buffers' device: [log Y -> M,
        log Y -> Y, start(3), end(3), ragged_end(3)]
        (``VanillaPallasAligner._scalars``, pallas_fb.py:2627-2636)."""
        a_yy = self.t_e_to_e
        start = self.ragged_start_vec() if ragged_left else self.start_vec()
        return _scalar_tensor(
            [np.log(1.0 - a_yy), np.log(a_yy)] + start + self.end_vec()
            + self.ragged_end_vec(), self.match4.device)


def vanilla_from_jax(sm):
    """The port's vanilla machine with the weights of the JAX package's
    ``StateMachine3Vanilla``: its pore model, skip-bin probabilities,
    strand constants and end probabilities, read as numpy and floats."""
    out = StateMachine3Vanilla(_pore_model_from_jax(sm.model),
                               skip_bin_probs=np.asarray(sm.skip_bin_probs,
                                                         np.float64))
    for name in ("t_m_to_y_not_x", "t_e_to_e", "default_end_match_prob",
                 "default_end_from_x_prob", "default_end_from_y_prob"):
        setattr(out, name, float(getattr(sm, name)))
    return out


def _getkmer2_positions(l_x):
    """sequence_getKmer2 pointer positions per column x
    (impl/pairwiseAligner.c:336-341): index x-1 maps to element x-2 for
    x >= 2, else element 0."""
    x = np.arange(l_x + 1)
    return np.where(x - 1 > 0, x - 2, 0)


def _kmer_idx_at(ref_seq, positions):
    all_idx = kmers.seq_to_kmer_indices(ref_seq, length=len(ref_seq))
    return all_idx[np.clip(positions, 0, len(ref_seq) - 1)]


class StateMachineEchelon(nn.Module):
    """7-state multi-k-mer-per-event signal machine (stateMachineEchelon,
    getStateMachineEchelon, impl/stateMachine.c:1411-1459, 1652-1692,
    1823-1833): states match0..match5 and gap-X.  An event emits 1..5
    k-mers (match1..match5) with a Poisson duration posterior, or none
    (match0, an extra event); gap-X skips a k-mer silently.  The skip
    transitions of a column come from the k-mer skip bin of its k-mer pair:
    echelon couples alpha to beta (``_skip_logs``).

    Buffers (f32): ``mm4`` and ``gm4`` [4096, 4], the pore model's match
    and gap-Y (extra event) level mean, level sd, noise mean and noise
    lambda columns (``EchelonPallasAligner._model_tables``,
    pallas_fb.py:3285-3295).  ``skip_bin_probs`` [60] (numpy f64): the pore
    model's 30 skip bins twice, as emissions_signal_loadPoreModel reads
    them; getKmerSkipProb reads only [bin].  The reference has no echelon
    EM: its expectation hook is NULL (impl/stateMachine.c:1831)."""

    S = 7

    def __init__(self, model: PoreModel, skip_bin_probs=None):
        super().__init__()
        self.model = model
        if skip_bin_probs is None:
            skip_bin_probs = np.concatenate([model.skip_bins,
                                             model.skip_bins])
        self.skip_bin_probs = np.asarray(skip_bin_probs, np.float64)
        # the reference keeps these end probabilities in *probability*
        # space, flagged "todo these aren't log and won't work"
        # (impl/stateMachine.c:1667-1669); kept verbatim
        self.default_end_match_prob = 0.79015888282447311
        self.default_end_from_x_prob = 0.19652425498269727
        cols = VANILLA_MODEL_COLUMNS
        self.register_buffer("mm4", torch.from_numpy(np.asarray(
            model.match_model[:, cols], np.float32).copy()))
        self.register_buffer("gm4", torch.from_numpy(np.asarray(
            model.gap_y_model[:, cols], np.float32).copy()))

    def start_vec(self):
        v = [LOG_ZERO] * 7
        v[MATCH1] = 0.0
        return v

    def ragged_start_vec(self):
        v = [LOG_ZERO] * 7
        v[GAP_X] = 0.0
        return v

    def end_vec(self):
        return ([self.default_end_match_prob] * 6
                + [self.default_end_from_x_prob])

    def ragged_end_vec(self):
        return self.end_vec()

    def _skip_logs(self, a_mx):
        """Per-column skip transition logs (la_mx, la_mh, la_xx, la_xh) from
        the skip probabilities ``a_mx`` (f64): echelon couples alpha to beta
        (a_xx = a_mx, la_xh = la_mh; impl/stateMachine.c:1420-1426)."""
        with np.errstate(divide="ignore"):
            la_mx = np.log(a_mx)
            la_mh = np.log(1.0 - a_mx)
        return la_mx, la_mh, la_mx, la_mh

    def scalars(self, ragged_left=False):
        """Kernel scalars [1, 21] f32 on the buffers' device: [start(7),
        end(7), ragged_end(7)] (no transition scalars: the transitions are
        per column), -inf clamped to NEG in f64 before the cast
        (``EchelonPallasAligner._scalars``, pallas_fb.py:3242-3247)."""
        start = self.ragged_start_vec() if ragged_left else self.start_vec()
        return _scalar_tensor(list(start) + list(self.end_vec())
                              + list(self.ragged_end_vec()),
                              self.mm4.device)


class StateMachineEchelonB(StateMachineEchelon):
    """EchelonB variant (stateMachineEchelonB_cellCalculate,
    impl/stateMachine.c:1461-1510): echelon's topology and emissions, but
    the skip transitions are four global scalars (match -> skip / hub,
    skip continue / -> hub) instead of per-k-mer skip bins, decoupling
    alpha from beta.  The reference defines no constructor; the default
    takes the pore model's mean skip-bin probability for both, as the JAX
    package does."""

    def __init__(self, model: PoreModel, match_to_skip=None,
                 skip_continue=None):
        super().__init__(model)
        if match_to_skip is None:
            match_to_skip = float(np.mean(model.skip_bins))
        if skip_continue is None:
            skip_continue = match_to_skip
        self.match_to_skip = float(match_to_skip)
        self.skip_continue = float(skip_continue)

    def _skip_logs(self, a_mx):
        with np.errstate(divide="ignore"):
            la_mx = np.full_like(a_mx, np.log(self.match_to_skip))
            la_mh = np.full_like(a_mx, np.log1p(-self.match_to_skip))
            la_xx = np.full_like(a_mx, np.log(self.skip_continue))
            la_xh = np.full_like(a_mx, np.log1p(-self.skip_continue))
        return la_mx, la_mh, la_xx, la_xh


def echelon_from_jax(sm):
    """The port's echelon machine (``StateMachineEchelonB`` for the JAX
    package's echelonB) with the weights of the JAX package's: its pore
    model, skip-bin probabilities, end probabilities and echelonB's
    ``match_to_skip``/``skip_continue``, read as numpy and floats."""
    model = _pore_model_from_jax(sm.model)
    if hasattr(sm, "match_to_skip"):
        out = StateMachineEchelonB(model, match_to_skip=sm.match_to_skip,
                                   skip_continue=sm.skip_continue)
    else:
        out = StateMachineEchelon(model)
    out.skip_bin_probs = np.asarray(sm.skip_bin_probs, np.float64)
    for name in ("default_end_match_prob", "default_end_from_x_prob"):
        setattr(out, name, float(getattr(sm, name)))
    return out


class StateMachine3Hdp(nn.Module):
    """threeState machine with HDP k-mer density emissions
    (getHdpStateMachine3, stateMachine3Hdp_construct,
    impl/stateMachine.c:1563-1608): the strawman's topology, transitions
    and gap-X table; the match and gap-Y emissions are one density, the
    cubic-spline interpolation of the k-mer's sampled HDP density on the
    grid (get_nanopore_kmer_density -> grid_spline_interp,
    impl/hdp.c:2577-2601), evaluated on the card as the emission stream
    (``ops.features.hdp_stream``).

    ``nhdp`` is a sampled and finalized ``hdp.nanopore_hdp.NanoporeHDP``
    (anything with its ``density_tables()``).  ``log_density=True`` takes
    the log of the density; False keeps the reference's raw density where
    its DP expects a log probability (impl/stateMachine.c:1353), kept on
    purpose as the JAX package keeps it.

    Buffers (f32, as ``HdpPallasAligner._hdp_tables``): ``tables`` and
    ``slopes`` [4096, G], the k-mer leaves' densities and spline slopes on
    the grid, and ``gap_x`` [4096] (log probabilities, -inf clamped to
    NEG).  ``grid`` [G] stays a host f64 array: the stream reads its
    first point, step and last point as f32 scalars (``grid_scalars``)."""

    S = 3

    def __init__(self, nhdp, params=None, gap_x_log_probs=None,
                 log_density=True):
        super().__init__()
        self.nhdp = nhdp
        self.p = dict(params or SM3_NANOPORE_DEFAULTS)
        self.log_density = bool(log_density)
        self.gap_x_log_probs = (np.full(NUM_OF_KMERS, LOG_TENTH)
                                if gap_x_log_probs is None
                                else np.asarray(gap_x_log_probs))
        grid, tables, slopes = nhdp.density_tables()
        self.grid = np.asarray(grid, np.float64)
        self.register_buffer("tables", torch.from_numpy(np.asarray(
            tables, np.float32).copy()))
        self.register_buffer("slopes", torch.from_numpy(np.asarray(
            slopes, np.float32).copy()))
        self.register_buffer("gap_x", torch.from_numpy(np.nan_to_num(
            np.asarray(self.gap_x_log_probs, np.float32), neginf=NEG)))

    start_vec = StateMachine3SignalStrawman.start_vec
    ragged_start_vec = StateMachine3SignalStrawman.ragged_start_vec
    end_vec = StateMachine3SignalStrawman.end_vec
    ragged_end_vec = StateMachine3SignalStrawman.ragged_end_vec

    def scalars(self, ragged_left=False):
        """The strawman's kernel scalars [1, 17] f32 on the buffers' device
        (``HdpPallasAligner`` inherits ``StrawmanPallasAligner._scalars``)."""
        return _sm3_scalars(self, ragged_left, self.tables.device)

    def grid_scalars(self):
        """(first point, step, last point) of the grid as f32, the step
        taken in f64 (``_stream_args``' grid0, dx and glast)."""
        g = self.grid
        return (float(np.float32(g[0])), float(np.float32(g[1] - g[0])),
                float(np.float32(g[-1])))


class _DensityTables:
    """Another HDP's density tables as numpy arrays: what
    ``StateMachine3Hdp`` reads of an HDP."""

    def __init__(self, grid, tables, slopes):
        self.tables = (np.array(grid, np.float64), np.array(tables),
                       np.array(slopes))

    def density_tables(self):
        return self.tables


def hdp_from_jax(sm):
    """The port's HDP machine with the model of the JAX package's
    ``StateMachine3Hdp``: its HDP's density tables
    (``sm.nhdp.density_tables()``), transition params, gap-X table and
    ``log_density``, read as numpy arrays and floats, so that both
    packages run one sampled model with no second Gibbs run."""
    return StateMachine3Hdp(_DensityTables(*sm.nhdp.density_tables()),
                            params=sm.p,
                            gap_x_log_probs=np.asarray(sm.gap_x_log_probs,
                                                       np.float64),
                            log_density=sm.log_density)


# Default log transition params of the 5-state machine,
# impl/stateMachine.c:921-938.
SM5_DEFAULTS = dict(
    match_continue=-0.030064059121770816,
    match_from_short_gap_x=-1.272871422049609,
    match_from_long_gap_x=-5.673280173170473,
    gap_short_open_x=-4.34381910900448,
    gap_short_extend_x=-0.3388262689231553,
    gap_short_switch_to_x=-4.910694825551255,
    gap_long_open_x=-6.30810595366929,
    gap_long_extend_x=-0.003442492794189331,
    gap_long_switch_to_x=-6.30810595366929,
)

# Default DNA emission tables, impl/stateMachine.c:60-82.
EMISSION_MATCH = -2.1149196655034745
EMISSION_TRANSVERSION = -4.5691014376830479
EMISSION_TRANSITION = -3.9833860032220842
EMISSION_GAP = -1.6094379124341003  # log(0.2)
LOG_QUARTER = -1.386294361          # impl/stateMachine.c:159 (N gap prob)
LOG_QUARTER_SQ = -2.772588722       # impl/stateMachine.c:170 (N match prob)


def default_dna_match_table():
    m = np.array([
        [EMISSION_MATCH, EMISSION_TRANSVERSION, EMISSION_TRANSITION,
         EMISSION_TRANSVERSION],
        [EMISSION_TRANSVERSION, EMISSION_MATCH, EMISSION_TRANSVERSION,
         EMISSION_TRANSITION],
        [EMISSION_TRANSITION, EMISSION_TRANSVERSION, EMISSION_MATCH,
         EMISSION_TRANSVERSION],
        [EMISSION_TRANSVERSION, EMISSION_TRANSITION, EMISSION_TRANSVERSION,
         EMISSION_MATCH],
    ])
    return m


def _extend_tables_with_n(match4, gapx4, gapy4):
    """Row/col 4 holds the reference's N fallback values
    (impl/stateMachine.c:155-173)."""
    match5 = np.full((5, 5), LOG_QUARTER_SQ)
    match5[:4, :4] = match4
    gapx5 = np.concatenate([gapx4, [LOG_QUARTER]])
    gapy5 = np.concatenate([gapy4, [LOG_QUARTER]])
    return match5, gapx5, gapy5


def _neg_clamped(a):
    """f32 copy of a log table, -inf clamped to NEG in f64 first."""
    return np.maximum(np.nan_to_num(np.asarray(a, np.float64), neginf=NEG),
                      NEG).astype(np.float32)


class StateMachine5(nn.Module):
    """Classic 5-state affine-gap DNA pair-HMM (fiveState,
    getStateMachine5, impl/stateMachine.c:902-959): states M, shortGapX,
    shortGapY, longGapX, longGapY; X and Y are DNA bases (4 = N).

    ``p`` holds the transition log probabilities, symmetric unless the
    ``_y`` ones are given (impl/stateMachine.c:930-938); ``match_table``
    [4, 4], ``gap_x_table`` and ``gap_y_table`` [4] the emission log
    probabilities (numpy), which the N row and column extend to the
    buffers (f32, -inf clamped to NEG): ``match5`` [5, 5], ``gapx5`` [5]
    and ``gapy5`` [5]."""

    S = 5

    def __init__(self, params=None, match_table=None, gap_x_table=None,
                 gap_y_table=None):
        super().__init__()
        p = dict(SM5_DEFAULTS) if params is None else dict(params)
        for k in list(p):
            if k.endswith("_x") and k[:-2] + "_y" not in p:
                p[k[:-2] + "_y"] = p[k]
        self.p = p
        self.match_table = (default_dna_match_table() if match_table is None
                            else np.asarray(match_table))
        self.gap_x_table = (np.full(4, EMISSION_GAP) if gap_x_table is None
                            else np.asarray(gap_x_table))
        self.gap_y_table = (np.full(4, EMISSION_GAP) if gap_y_table is None
                            else np.asarray(gap_y_table))
        tables = [_neg_clamped(t) for t in _extend_tables_with_n(
            self.match_table, self.gap_x_table, self.gap_y_table)]
        # the host copy of the gap-Y table builds the y side without
        # reading the card
        self.gapy5_host = tables[2]
        for name, table in zip(("match5", "gapx5", "gapy5"), tables):
            self.register_buffer(name, torch.from_numpy(table.copy()))

    # impl/stateMachine.c:744-790
    def start_vec(self):
        return [0.0, LOG_ZERO, LOG_ZERO, LOG_ZERO, LOG_ZERO]

    def ragged_start_vec(self):
        return [LOG_ZERO, LOG_ZERO, LOG_ZERO, 0.0, 0.0]

    def end_vec(self):
        p = self.p
        return [p["match_continue"], p["match_from_short_gap_x"],
                p["match_from_short_gap_y"], p["match_from_long_gap_x"],
                p["match_from_long_gap_y"]]

    def ragged_end_vec(self):
        p = self.p
        return [p["gap_long_open_x"], p["gap_long_open_x"],
                p["gap_long_open_y"], p["gap_long_extend_x"],
                p["gap_long_extend_y"]]

    def scalars(self, ragged_left=False):
        """Kernel scalars [1, 28] f32 on the buffers' device: [13
        transitions (lower 4, middle 5, upper 4), start(5), end(5),
        ragged_end(5)], -inf clamped to NEG in f64 before the cast
        (``Dna5PallasAligner._scalars``, pallas_fb.py:3091-3104)."""
        p = self.p
        vals = [p["gap_short_open_x"], p["gap_short_extend_x"],
                p["gap_long_open_x"], p["gap_long_extend_x"],
                p["match_continue"], p["match_from_short_gap_x"],
                p["match_from_short_gap_y"], p["match_from_long_gap_x"],
                p["match_from_long_gap_y"],
                p["gap_short_open_y"], p["gap_short_extend_y"],
                p["gap_long_open_y"], p["gap_long_extend_y"]]
        start = self.ragged_start_vec() if ragged_left else self.start_vec()
        return _scalar_tensor(vals + list(start) + list(self.end_vec())
                              + list(self.ragged_end_vec()),
                              self.match5.device)


def machine5_from_jax(sm):
    """The port's 5-state machine with the weights of the JAX package's
    ``StateMachine5``: reads only ``sm.p`` and its numpy tables
    (``match_table``, ``gap_x_table``, ``gap_y_table``)."""
    return StateMachine5(params=sm.p,
                         match_table=np.asarray(sm.match_table, np.float64),
                         gap_x_table=np.asarray(sm.gap_x_table, np.float64),
                         gap_y_table=np.asarray(sm.gap_y_table, np.float64))
