"""Fasta reading and sequence utilities (the part of
``cpecan_tpu/io/fasta.py``, a sonLib bioio subset, that the port uses)."""

_COMP = str.maketrans("ACGTacgtNnRYSWKMBDHVryswkmbdhv",
                      "TGCAtgcaNnYRSWMKVHDByrswmkvhdb")


def read_fasta(fh):
    """Yields (header, sequence) tuples."""
    header = None
    chunks = []
    for line in fh:
        line = line.strip()
        if line.startswith(">"):
            if header is not None:
                yield header, "".join(chunks)
            header = line[1:]
            chunks = []
        elif line:
            chunks.append(line)
    if header is not None:
        yield header, "".join(chunks)


def read_fasta_file(path):
    with open(path) as fh:
        yield from read_fasta(fh)


def reverse_complement(seq):
    return seq.translate(_COMP)[::-1]


def sequences_from_fastas(paths):
    """cPecanRealign's addToSequencesHash (cPecanRealign.c:233-260):
    sequences keyed by the first header token; on repeats, the longer
    sequence wins."""
    sequences = {}
    for path in paths:
        for header, seq in read_fasta_file(path):
            key = header.split()[0]
            if key in sequences:
                if len(seq) > len(sequences[key]):
                    sequences[key] = seq
            else:
                sequences[key] = seq
    return sequences
