"""Pair-HMM state machines of the port (counterpart of
``cpecan_tpu/models/state_machines.py``).

So far only the strawman 3-state signal machine, as an ``nn.Module`` whose
buffers are the model tables the wavefront kernels gather from: moving the
module to a device moves its tables once, which takes the place of the JAX
aligner's per-machine table cache (``pallas_fb.py:1575`` ``_model_cache``).
"""

import numpy as np
import torch
from torch import nn

from ..constants import LOG_ZERO, NUM_OF_KMERS
from ..io.poremodel import PoreModel
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
        p = self.p
        vals = [p["match_continue"], p["match_from_gap_x"],
                p["match_from_gap_y"], p["gap_open_x"], p["gap_extend_x"],
                p["gap_switch_to_x"], p["gap_open_y"], p["gap_extend_y"]]
        start = self.ragged_start_vec() if ragged_left else self.start_vec()
        arr = np.array([vals + list(start) + list(self.end_vec())
                        + list(self.ragged_end_vec())], dtype=np.float64)
        arr = np.maximum(np.nan_to_num(arr, neginf=NEG), NEG)
        return torch.from_numpy(arr.astype(np.float32)).to(
            self.match_model.device)


def machine_from_jax(sm):
    """The port's strawman machine with the weights of the JAX package's
    ``StateMachine3SignalStrawman``.

    Reads only numpy and float attributes (``sm.p``, ``sm.gap_x_log_probs``
    and the fields of ``sm.model``), so it needs no JAX import of its own;
    the JAX package's pore model becomes the port's ``PoreModel``."""
    m = sm.model
    model = PoreModel(float(m.match_correlation),
                      np.asarray(m.match_model, np.float64),
                      np.asarray(m.skip_bins, np.float64),
                      float(m.gap_y_correlation),
                      np.asarray(m.gap_y_model, np.float64))
    return StateMachine3SignalStrawman(model, params=sm.p,
                                       gap_x_log_probs=sm.gap_x_log_probs)
