"""Constants of the port (the subset of ``cpecan_tpu/constants.py`` that it
uses).

Parity sources (reference: jeizenga/cPecan):
  - PAIR_ALIGNMENT_PROB_1: inc/pairwiseAligner.h:27
  - LOG_ZERO:              inc/pairwiseAligner.h:192
  - KMER_LENGTH/NUM_OF_KMERS: inc/emissionMatrix.h:4-6
  - MODEL_PARAMS:          inc/stateMachine.h:14-16
  - NB_EVENT_PARAMS:       inc/nanopore.h:4
"""

# Integer fixed-point scale: probability 1.0 == 10^7.
PAIR_ALIGNMENT_PROB_1 = 10_000_000

LOG_ZERO = float("-inf")

KMER_LENGTH = 6
NUM_OF_KMERS = 4096  # 4**6
# Sentinel index returned by the reference for 'N'/unknown symbols
# (impl/stateMachine.c:116 returns NUM_OF_KMERS + 1).
N_SENTINEL = NUM_OF_KMERS + 1

# Pore model: level_mean, level_sd, noise_mean, noise_sd, noise_lambda per kmer.
MODEL_PARAMS = 5
# Event: mean, stdev, duration.
NB_EVENT_PARAMS = 3

# State indices (inc/stateMachine.h:30-34): the 3-state machines use the
# first three, the 5-state DNA machine all five.
MATCH = 0
SHORT_GAP_X = 1
SHORT_GAP_Y = 2
LONG_GAP_X = 3
LONG_GAP_Y = 4
# The 7-state echelon machine's states (inc/stateMachine.h:38): match0 (an
# extra event), match1..match5 (an event emitting 1..5 k-mers), gap-X.
MATCH0, MATCH1, MATCH2, MATCH3, MATCH4, MATCH5, GAP_X = 0, 1, 2, 3, 4, 5, 6

# Strands (inc/stateMachine.h:34-37).
TEMPLATE = 0
COMPLEMENT = 1
