"""EM expectation containers and their text formats (the part of
``cpecan_tpu/models/hmm.py`` that the port uses).

``ContinuousPairHmm`` ports impl/continuousHmm.c:74-375: it holds the
merged expectation counts, normalizes them (the M-step), round-trips the
reference's text format (three- and four-state transition tables), and
loads the result back into strawman or 4-state machine parameters.
``VanillaHmm`` (impl/continuousHmm.c:378-635) does the same for the
vanilla machine's 60 k-mer skip bins.  ``HmmDiscrete``
(impl/discreteHmm.c) and ``sm5_from_hmm`` are cut to what cPecanRealign's
``--loadHmm`` calls: load, normalize and the 5-state machine's symmetric
or asymmetric load.
"""

import numpy as np

from ..constants import (LOG_ZERO, LONG_GAP_X, LONG_GAP_Y, MATCH,
                         NUM_OF_KMERS, SHORT_GAP_X, SHORT_GAP_Y)

# StateMachineType enum values (inc/stateMachine.h:18-27)
TYPE_FIVE_STATE = 0
TYPE_FIVE_STATE_ASYMMETRIC = 1
TYPE_THREE_STATE = 2
TYPE_VANILLA = 4


def _fmt(values):
    return "".join("%f\t" % v for v in values)


class HmmDiscrete:
    """Dense transition + emission expectation table (impl/discreteHmm.c)."""

    def __init__(self, state_number, symbol_set_size, type_=TYPE_FIVE_STATE,
                 pseudocount=0.0):
        self.type = type_
        self.state_number = state_number
        self.symbol_set_size = symbol_set_size
        self.transitions = np.full((state_number, state_number), pseudocount,
                                   dtype=np.float64)
        self.emissions = np.full(
            (state_number, symbol_set_size, symbol_set_size), pseudocount,
            dtype=np.float64)
        self.likelihood = 0.0

    def normalize(self):
        """hmmDiscrete_normalize (impl/discreteHmm.c:111-141): transitions
        row-normalized; emissions normalized per state."""
        self.transitions /= self.transitions.sum(axis=1, keepdims=True)
        self.emissions /= self.emissions.sum(axis=(1, 2), keepdims=True)

    @classmethod
    def load(cls, path):
        # impl/discreteHmm.c:198-295
        with open(path) as fh:
            header = fh.readline().split()
            type_, s, k = int(header[0]), int(header[1]), int(header[2])
            hmm = cls(s, k, type_)
            toks = fh.readline().split()
            if len(toks) != s * s + 1:
                raise ValueError("wrong number of transitions")
            hmm.transitions = np.array(toks[:-1],
                                       dtype=np.float64).reshape(s, s)
            hmm.likelihood = float(toks[-1])
            toks = fh.readline().split()
            if len(toks) != s * k * k:
                raise ValueError("wrong number of emissions")
            hmm.emissions = np.array(toks, dtype=np.float64).reshape(s, k, k)
        return hmm

    # M-step: load expectations into state-machine parameters
    # (stateMachine5_loadSymmetric, impl/stateMachine.c:1101-1155)

    def _em_match_probs_symmetric(self):
        # emissions_em_loadMatchProbsSymmetrically
        # (impl/stateMachine.c:689-700)
        e = self.emissions[MATCH]
        sym = (e + e.T) / 2.0
        out = np.log(sym)
        np.fill_diagonal(out, np.log(np.diag(e)))
        return out

    def _em_gap_probs(self, x_states, y_states):
        # emissions_em_loadGapProbs (impl/stateMachine.c:711-733)
        k = self.symbol_set_size
        gap = np.zeros(k)
        for s in x_states:
            gap += self.emissions[s].sum(axis=1)
        for s in y_states:
            gap += self.emissions[s].sum(axis=0)
        return np.log(gap / gap.sum())

    def to_sm5_params_symmetric(self):
        """Returns (params dict, match_table, gap_x_table, gap_y_table) for
        StateMachine5, with the reference's short/long-gap switch guard."""
        t = self.transitions

        def avg(a, b):
            return (t[a[0], a[1]] + t[b[0], b[1]]) / 2.0

        p = {}
        p["match_continue"] = np.log(t[MATCH, MATCH])
        p["match_from_short_gap_x"] = np.log(
            avg((SHORT_GAP_X, MATCH), (SHORT_GAP_Y, MATCH)))
        p["match_from_long_gap_x"] = np.log(
            avg((LONG_GAP_X, MATCH), (LONG_GAP_Y, MATCH)))
        p["gap_short_open_x"] = np.log(
            avg((MATCH, SHORT_GAP_X), (MATCH, SHORT_GAP_Y)))
        p["gap_short_extend_x"] = np.log(
            avg((SHORT_GAP_X, SHORT_GAP_X), (SHORT_GAP_Y, SHORT_GAP_Y)))
        p["gap_short_switch_to_x"] = np.log(
            avg((SHORT_GAP_X, SHORT_GAP_Y), (SHORT_GAP_Y, SHORT_GAP_X)))
        p["gap_long_open_x"] = np.log(
            avg((MATCH, LONG_GAP_X), (MATCH, LONG_GAP_Y)))
        p["gap_long_extend_x"] = np.log(
            avg((LONG_GAP_X, LONG_GAP_X), (LONG_GAP_Y, LONG_GAP_Y)))
        p["gap_long_switch_to_x"] = np.log(
            avg((LONG_GAP_X, LONG_GAP_Y), (LONG_GAP_Y, LONG_GAP_X)))

        # switch guard (impl/stateMachine.c:1133-1139)
        if p["gap_short_extend_x"] > p["gap_long_extend_x"]:
            for a, b in (("gap_short_extend_x", "gap_long_extend_x"),
                         ("match_from_short_gap_x", "match_from_long_gap_x"),
                         ("gap_short_open_x", "gap_long_open_x"),
                         ("gap_short_switch_to_x", "gap_long_switch_to_x")):
                p[a], p[b] = p[b], p[a]

        match_table = self._em_match_probs_symmetric()
        gap = self._em_gap_probs([SHORT_GAP_X, LONG_GAP_X],
                                 [SHORT_GAP_Y, LONG_GAP_Y])
        return p, match_table, gap.copy(), gap.copy()

    def to_sm5_params_asymmetric(self):
        """stateMachine5_loadAsymmetric (impl/stateMachine.c:1052-1100):
        X and Y transition banks each loaded from their own states (no
        averaging), each with its own short/long switch guard; match
        emissions un-symmetrized; gap X/Y tables collapsed from the X/Y
        gap states only."""
        t = self.transitions
        with np.errstate(divide="ignore"):
            p = {"match_continue": np.log(t[MATCH, MATCH])}
            for side, short_g, long_g, other_short, other_long in (
                    ("x", SHORT_GAP_X, LONG_GAP_X, SHORT_GAP_Y, LONG_GAP_Y),
                    ("y", SHORT_GAP_Y, LONG_GAP_Y, SHORT_GAP_X, LONG_GAP_X)):
                p["match_from_short_gap_" + side] = np.log(t[short_g, MATCH])
                p["match_from_long_gap_" + side] = np.log(t[long_g, MATCH])
                p["gap_short_open_" + side] = np.log(t[MATCH, short_g])
                p["gap_short_extend_" + side] = np.log(t[short_g, short_g])
                p["gap_short_switch_to_" + side] = np.log(
                    t[other_short, short_g])
                p["gap_long_open_" + side] = np.log(t[MATCH, long_g])
                p["gap_long_extend_" + side] = np.log(t[long_g, long_g])
                p["gap_long_switch_to_" + side] = np.log(
                    t[other_long, long_g])
                # per-side switch guard
                # (impl/stateMachine.c:1068-1075,1090-1097)
                if (p["gap_short_extend_" + side]
                        > p["gap_long_extend_" + side]):
                    for a, b in (
                            ("gap_short_extend_", "gap_long_extend_"),
                            ("match_from_short_gap_", "match_from_long_gap_"),
                            ("gap_short_open_", "gap_long_open_"),
                            ("gap_short_switch_to_", "gap_long_switch_to_")):
                        p[a + side], p[b + side] = p[b + side], p[a + side]
            # emissions_em_loadMatchProbs (impl/stateMachine.c:680-687)
            match_table = np.log(self.emissions[MATCH])
        gap_x = self._em_gap_probs([SHORT_GAP_X, LONG_GAP_X], [])
        gap_y = self._em_gap_probs([], [SHORT_GAP_Y, LONG_GAP_Y])
        return p, match_table, gap_x, gap_y


def sm5_from_hmm(hmm: HmmDiscrete):
    """getStateMachine5 (impl/stateMachine.c:1748-1773): the port's
    StateMachine5 from an expectation container, dispatching on the hmm
    type (fiveState -> loadSymmetric, fiveStateAsymmetric -> loadAsymmetric;
    anything else is an error in the reference too)."""
    from .state_machines import StateMachine5
    if hmm.type == TYPE_FIVE_STATE:
        p, match_t, gap_x, gap_y = hmm.to_sm5_params_symmetric()
    elif hmm.type == TYPE_FIVE_STATE_ASYMMETRIC:
        p, match_t, gap_x, gap_y = hmm.to_sm5_params_asymmetric()
    else:
        raise ValueError(
            f"hmm type {hmm.type} cannot be loaded into a 5-state machine "
            "(getStateMachine5 supports fiveState/fiveStateAsymmetric only, "
            "impl/stateMachine.c:1748-1773)")
    return StateMachine5(params=p, match_table=match_t, gap_x_table=gap_x,
                         gap_y_table=gap_y)


class ContinuousPairHmm:
    """3-state transitions + per-kmer skip expectations
    (impl/continuousHmm.c:74-375)."""

    def __init__(self, state_number=3, symbol_set_size=NUM_OF_KMERS,
                 type_=TYPE_THREE_STATE, pseudocount=0.0):
        self.type = type_
        self.state_number = state_number
        self.symbol_set_size = symbol_set_size
        self.transitions = np.full((state_number, state_number), pseudocount,
                                   dtype=np.float64)
        self.kmer_gap_probs = np.full(symbol_set_size, pseudocount,
                                      dtype=np.float64)
        self.likelihood = 0.0

    def add_expectations(self, acc):
        self.transitions += np.asarray(acc["trans"])
        # the kmer_gap sums have 2 sentinel bins at the end for invalid kmers
        kg = np.asarray(acc["kmer_gap"])
        self.kmer_gap_probs += kg[: self.symbol_set_size]
        self.likelihood += float(acc["likelihood"])

    def normalize(self):
        # continuousPairHmm_normalize (impl/continuousHmm.c:159-173)
        self.transitions /= self.transitions.sum(axis=1, keepdims=True)
        self.kmer_gap_probs /= self.kmer_gap_probs.sum()

    def to_sm3_params(self):
        """continuousPairHmm_loadTransitionsAndKmerGapProbs
        (impl/continuousHmm.c:187-214): returns (params, gap_x_log_probs)."""
        t = self.transitions
        with np.errstate(divide="ignore"):
            p = dict(
                match_continue=np.log(t[MATCH, MATCH]),
                gap_open_x=np.log(t[MATCH, SHORT_GAP_X]),
                gap_open_y=np.log(t[MATCH, SHORT_GAP_Y]),
                match_from_gap_x=np.log(t[SHORT_GAP_X, MATCH]),
                gap_extend_x=np.log(1.0 - t[SHORT_GAP_X, MATCH]),
                gap_switch_to_y=LOG_ZERO,
                match_from_gap_y=np.log(t[SHORT_GAP_Y, MATCH]),
                gap_extend_y=np.log(t[SHORT_GAP_Y, SHORT_GAP_Y]),
                gap_switch_to_x=np.log(t[SHORT_GAP_Y, SHORT_GAP_X]),
            )
            gap_x = np.log(self.kmer_gap_probs)
        return p, gap_x

    def to_sm4_params(self):
        """The fourState machine's (params, gap_x_log_probs) from the
        normalized [4, 4] transitions (the JAX package's M-step loader for
        it: the reference wires the same expectation hook into the 4-state
        machine, impl/stateMachine.c:986,1800-1810, but ships no load)."""
        t = self.transitions
        with np.errstate(divide="ignore"):
            p = dict(
                match_continue=np.log(t[MATCH, MATCH]),
                gap_short_open_x=np.log(t[MATCH, SHORT_GAP_X]),
                gap_short_open_y=np.log(t[MATCH, SHORT_GAP_Y]),
                gap_long_open_x=np.log(t[MATCH, LONG_GAP_X]),
                match_from_short_gap_x=np.log(t[SHORT_GAP_X, MATCH]),
                gap_short_extend_x=np.log(t[SHORT_GAP_X, SHORT_GAP_X]),
                match_from_short_gap_y=np.log(t[SHORT_GAP_Y, MATCH]),
                gap_short_extend_y=np.log(t[SHORT_GAP_Y, SHORT_GAP_Y]),
                gap_long_switch_to_x=np.log(t[SHORT_GAP_Y, LONG_GAP_X]),
                match_from_long_gap_x=np.log(t[LONG_GAP_X, MATCH]),
                gap_long_extend_x=np.log(t[LONG_GAP_X, LONG_GAP_X]),
            )
            gap_x = np.log(self.kmer_gap_probs)
        return p, gap_x

    def write(self, fh):
        # impl/continuousHmm.c:217-268 (3-line format)
        if np.isnan(self.transitions).any():
            return  # hmmContinuous_checkTransitions guard
        fh.write("%i\t%i\t%i\t\n" % (self.type, self.state_number,
                                     self.symbol_set_size))
        fh.write(_fmt(self.transitions.ravel()))
        fh.write("%f\n" % self.likelihood)
        fh.write(_fmt(self.kmer_gap_probs))
        fh.write("\n")

    @classmethod
    def load(cls, path):
        # impl/continuousHmm.c:271-375
        with open(path) as fh:
            header = fh.readline().split()
            type_, s, k = int(header[0]), int(header[1]), int(header[2])
            hmm = cls(s, k, type_)
            toks = fh.readline().split()
            if len(toks) != s * s + 1:
                raise ValueError("wrong number of transitions")
            hmm.transitions = np.array(toks[:-1],
                                       dtype=np.float64).reshape(s, s)
            hmm.likelihood = float(toks[-1])
            toks = fh.readline().split()
            if len(toks) != k:
                raise ValueError("wrong number of kmer gap probs")
            hmm.kmer_gap_probs = np.array(toks, dtype=np.float64)
        return hmm


class VanillaHmm:
    """60 k-mer skip-bin expectations (30 beta + 30 alpha) and copies of
    the pore model (impl/continuousHmm.c:378-635)."""

    def __init__(self, state_number=3, symbol_set_size=NUM_OF_KMERS,
                 pseudocount=0.0):
        self.type = TYPE_VANILLA
        self.state_number = state_number
        self.symbol_set_size = symbol_set_size
        self.kmer_skip_bins = np.full(60, pseudocount, dtype=np.float64)
        self.match_model = np.zeros(1 + symbol_set_size * 5)
        self.scaled_match_model = np.zeros(1 + symbol_set_size * 5)
        self.likelihood = 0.0

    def add_expectations(self, acc):
        self.kmer_skip_bins += np.asarray(acc["skip_bins"])
        self.likelihood += float(acc["likelihood"])

    def normalize(self):
        # vanillaHmm_normalizeKmerSkipBins (impl/continuousHmm.c:429-438):
        # alpha and beta normalized together, a reference quirk kept
        self.kmer_skip_bins /= self.kmer_skip_bins.sum()

    def implant_match_models(self, pore_model):
        # vanillaHmm_implantMatchModelsintoHmm (impl/continuousHmm.c:448-459)
        self.match_model = np.concatenate(
            [[pore_model.match_correlation], pore_model.match_model.ravel()])
        self.scaled_match_model = np.concatenate(
            [[pore_model.gap_y_correlation], pore_model.gap_y_model.ravel()])

    def write(self, fh):
        # the 4-line format (impl/continuousHmm.c:482)
        if np.isnan(self.kmer_skip_bins).any():
            return
        fh.write("%i\t%i\t%i\t\n" % (self.type, self.state_number,
                                     self.symbol_set_size))
        fh.write(_fmt(self.kmer_skip_bins))
        fh.write("%f\n" % self.likelihood)
        fh.write(_fmt(self.match_model))
        fh.write("\n")
        fh.write(_fmt(self.scaled_match_model))
        fh.write("\n")

    @classmethod
    def load(cls, path):
        with open(path) as fh:
            header = fh.readline().split()
            hmm = cls(int(header[1]), int(header[2]))
            toks = fh.readline().split()
            if len(toks) != 61:
                raise ValueError("wrong number of skip bins")
            hmm.kmer_skip_bins = np.array(toks[:60], dtype=np.float64)
            hmm.likelihood = float(toks[-1])
            hmm.match_model = np.array(fh.readline().split(),
                                       dtype=np.float64)
            hmm.scaled_match_model = np.array(fh.readline().split(),
                                              dtype=np.float64)
        return hmm
