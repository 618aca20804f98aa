"""Anchor utilities on the host (a copy of ``cpecan_tpu/ops/anchors.py``).

Ports of the anchoring helpers in impl/pairwiseAligner.c:
  filterToRemoveOverlap   :1209-1249
  getSplitPoints          :1338-1389
  convertPairwiseForwardStrandAlignmentToAnchorPairs :1088-1112 (lives in
  cli/realign.py)
"""

import math


def filter_to_remove_overlap(sorted_pairs):
    """Keep only pairs that are strictly monotone against both the following
    and preceding pairs (impl/pairwiseAligner.c:1209-1249).  Input must be
    sorted by (x, y)."""
    keep = set()
    p_x = p_y = math.inf
    for i in range(len(sorted_pairs) - 1, -1, -1):
        x, y = sorted_pairs[i]
        if x < p_x and y < p_y:
            keep.add((x, y))
        p_x = min(x, p_x)
        p_y = min(y, p_y)

    out = []
    p_x = p_y = -math.inf
    for x, y in sorted_pairs:
        if x > p_x and y > p_y and (x, y) in keep:
            out.append((x, y))
        p_x = max(x, p_x)
        p_y = max(y, p_y)
    return out


def _get_split_points_p(x1, y1, x2, y2, x3, y3, split_points,
                        split_matrix_bigger_than_this, skip_block):
    """impl/pairwiseAligner.c:1338-1360.  Returns (x1, y1, did_split)."""
    l_x2 = x3 - x2
    l_y2 = y3 - y2
    matrix_size = l_x2 * l_y2
    if matrix_size > split_matrix_bigger_than_this:
        max_seq_len = int(math.sqrt(split_matrix_bigger_than_this))
        h_x = max_seq_len if l_x2 // 2 > max_seq_len else l_x2 // 2
        h_y = max_seq_len if l_y2 // 2 > max_seq_len else l_y2 // 2
        if not skip_block:
            split_points.append((x1, y1, x2 + h_x, y2 + h_y))
        return x3 - h_x, y3 - h_y, True
    return x1, y1, False


def get_split_points(anchor_pairs, l_x, l_y, split_matrix_bigger_than_this,
                     ragged_left_end, ragged_right_end):
    """impl/pairwiseAligner.c:1362-1389: split the banded problem into
    independent (x1, y1, x2, y2) sub-regions at large anchor gaps."""
    x1 = y1 = x2 = y2 = 0
    split_points = []
    for i, (x3, y3) in enumerate(anchor_pairs):
        x1, y1, _ = _get_split_points_p(
            x1, y1, x2, y2, x3, y3, split_points,
            split_matrix_bigger_than_this, ragged_left_end and i == 0)
        if not (x3 >= x2 and y3 >= y2 and x3 < l_x and y3 < l_y):
            raise ValueError(
                f"anchor ({x3}, {y3}) not strictly increasing within "
                f"[{x2}, {l_x}) x [{y2}, {l_y})")
        x2, y2 = x3 + 1, y3 + 1
    x1, y1, did_split = _get_split_points_p(
        x1, y1, x2, y2, l_x, l_y, split_points,
        split_matrix_bigger_than_this, ragged_left_end and not anchor_pairs)
    if not did_split or not ragged_right_end:
        split_points.append((x1, y1, l_x, l_y))
    return split_points
