"""Guide-alignment helpers of the port (the part of
``cpecan_tpu/io/guide.py`` that it uses): ``TargetRegions``, the
``--target_regions`` filter of the batch CLI.  Guiding fast5 reads with
bwa or lastz is not ported (ROADMAP Queue 1 item 8b)."""

import os

import numpy as np


class TargetRegions:
    """Keep only reads whose guide alignment contains one of the given
    [start, end] reference intervals (scripts/nanoporeLib.py:246-270)."""

    def __init__(self, tsv, already_sorted=False):
        if os.stat(tsv).st_size == 0:
            raise ValueError("Empty regions file")
        arr = np.loadtxt(tsv, usecols=(0, 1), dtype=np.int32)
        if arr.ndim == 1:
            arr = arr[None, :]
        if not already_sorted:
            arr = np.sort(arr, axis=1)
        self.region_array = arr

    def check_aligned_region(self, left, right):
        if right < left:
            left, right = right, left
        return bool(np.any((self.region_array[:, 0] >= left)
                           & (self.region_array[:, 1] <= right)))
