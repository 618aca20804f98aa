"""The signal strawman EM expectation container and its text format (the
part of ``cpecan_tpu/models/hmm.py`` that the port uses).

``ContinuousPairHmm`` ports impl/continuousHmm.c:74-375: it holds the
merged expectation counts, normalizes them (the M-step), round-trips the
reference's text format, and loads the result back into strawman machine
parameters.
"""

import numpy as np

from ..constants import (LOG_ZERO, MATCH, NUM_OF_KMERS, SHORT_GAP_X,
                         SHORT_GAP_Y)

# StateMachineType enum value of threeState (inc/stateMachine.h:18-27)
TYPE_THREE_STATE = 2


def _fmt(values):
    return "".join("%f\t" % v for v in values)


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
