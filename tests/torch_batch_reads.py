"""Small signalAlign batches for the port's pipeline and CLI tests
(tests/test_torch_batch*.py): copies of the Zymo MinION read, each guided
by a prefix of the stored lastz guide, so that a read's band stays a few
hundred diagonals and a CPU run takes seconds."""

import dataclasses
import os
import shutil

import numpy as np

from cpecan_tpu_torch.fixtures import ZYMO_TRAIN, fixture_path
from cpecan_tpu_torch.io.cigar import cigar_write, parse_cigar_line


def guide_prefix(line, ref_bases, name=None, query_end=None):
    """The guide cigar ``line`` cut to its first operations spanning at
    least ``ref_bases`` reference bases (both strands '+'), its read
    renamed to ``name``; ``query_end`` overrides the end on the read
    (shorter than the operations span: anchors past the event slice)."""
    aln = parse_cigar_line(line)
    assert aln.strand1 and aln.strand2
    ops, span1, span2 = [], 0, 0
    for op, n in aln.operations:
        ops.append((op, n))
        span1 += n if op != "I" else 0
        span2 += n if op != "D" else 0
        if span1 >= ref_bases and op == "M":
            break
    cut = dataclasses.replace(
        aln, end1=aln.start1 + span1,
        end2=aln.start2 + span2 if query_end is None else query_end,
        operations=ops, contig2=name or aln.contig2)
    return cigar_write(cut)


def stored_guide():
    return str(np.load(ZYMO_TRAIN)["guide"])


def make_reads(directory, lengths, bad=()):
    """Copies of the Zymo npRead in ``directory`` named read{i}, guided by
    prefixes of ``lengths[i]`` reference bases; the reads in ``bad`` get a
    guide whose anchors run past their event slice.  Returns
    [(npRead path, guide line)]."""
    os.makedirs(directory, exist_ok=True)
    pairs = []
    for i, n in enumerate(lengths):
        label = f"read{i}"
        path = os.path.join(directory, label + ".npRead")
        shutil.copy(fixture_path("ZymoC_ch_1_file1.npRead"), path)
        guide = guide_prefix(stored_guide(), n, name=label)
        if i in bad:
            aln = parse_cigar_line(guide)
            guide = guide_prefix(stored_guide(), n, name=label,
                                 query_end=aln.start2 + 20)
        pairs.append((path, guide))
    return pairs
