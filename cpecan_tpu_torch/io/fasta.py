"""Sequence utilities (the part of ``cpecan_tpu/io/fasta.py``, a sonLib
bioio subset, that the port uses)."""

_COMP = str.maketrans("ACGTacgtNnRYSWKMBDHVryswkmbdhv",
                      "TGCAtgcaNnYRSWMKVHDByrswmkvhdb")


def reverse_complement(seq):
    return seq.translate(_COMP)[::-1]
