"""Helpers of the vanillaAlign-equivalent CLI that the port's pipelines
need (a subset of ``cpecan_tpu/cli/signal_align.py``, which imports JAX
through its aligners and so cannot be imported here).  The CLI itself is
not ported yet (ROADMAP Queue 1 item 8)."""

from ..io.npread import remap_anchor_pairs_with_offset
from ..ops.anchors import filter_to_remove_overlap


def get_remapped_anchor_pairs(unmapped, event_map, map_offset):
    """getRemappedAnchorPairs (vanillaAlign.c:97-102)."""
    remapped = remap_anchor_pairs_with_offset(unmapped, event_map, map_offset)
    return filter_to_remove_overlap(remapped)


def make_event_slice(events, query_start, query_end, event_map):
    """makeEventSequenceFromPairwiseAlignment (vanillaAlign.c:272-287).

    The complement event map runs backwards along the read, so the
    reference's `endIdx - startIdx` length is negative there (undefined
    behaviour in the C).  We take the [min, max) event window instead —
    complement events in increasing index order correspond to the
    reverse-complemented reference in forward order.
    """
    start_idx = int(event_map[query_start])
    end_idx = int(event_map[query_end])
    lo, hi = min(start_idx, end_idx), max(start_idx, end_idx)
    return events[lo:hi], lo
