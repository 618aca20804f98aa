"""cPecanEm-equivalent of the port: Baum-Welch EM over DNA alignment
shards, the E-step batched through the 5-state wavefront kernels
(counterpart of ``cpecan_tpu/pipeline/em.py`` with ``engine="pallas"``).

Port of cPecanEm.py (the jobTree-distributed EM pipeline): shard cigars by
aligned length, sample, iterate E-steps over the shards and a merged
M-step, with multi-trial random restarts and a lastz scoring-matrix
export.  The reference distributes shards as cluster jobs exchanging text
files (cPecanEm.py:164-210); here every alignment of every shard runs
through ``Dna5Aligner.run(expectations=True)`` in chunks, on the CUDA
device unless the caller says otherwise, and the merge is an in-memory
sum.

Not ported (each raises ``NotImplementedError`` naming its ROADMAP item):
the per-alignment scan engine (``engine="scan"``) and
``update_the_band``, whose re-alignment runs the scan engine (Queue 1
item 7); data-parallel E-steps (``mesh=``, Queue 1 item 9).
"""

import copy
import math
import random
from dataclasses import dataclass, field
from itertools import product

import numpy as np

from ..align import AlignmentParams
from ..cli.realign import aligner_for, get_sub_sequence, rebase_coordinates
from ..models.hmm import HmmDiscrete, sm5_from_hmm
from ..models.state_machines import StateMachine5
from ..ops.anchors import get_split_points
from ..ops.fb import _call

SYMBOL_NUMBER = 4
# alignments per kernel run (calculate_expectations_pallas' chunk)
CHUNK = 64

_MODEL_TYPES = {"fiveState": 0, "fiveStateAsymmetric": 1, "threeState": 2,
                "threeStateAsymmetric": 3}
_STATE_NUMBERS = {"fiveState": 5, "fiveStateAsymmetric": 5, "threeState": 3,
                  "threeStateAsymmetric": 3}

SCAN_ENGINE = ("the per-alignment scan engine is not ported (ROADMAP Queue 1 "
               "item 7); the port's E-step engine is the wavefront one, "
               "engine='pallas'")


class PipelineHmm:
    """cPecanEm.py's Hmm class + text format (cPecanEm.py:19-105):
    line 1: modelTypeInt transitions... likelihood
    line 2: emissions
    line 3 (optional): running likelihoods."""

    def __init__(self, model_type="fiveState"):
        self.model_type = model_type
        self.state_number = _STATE_NUMBERS[model_type]
        self.transitions = np.zeros(self.state_number ** 2)
        self.emissions = np.zeros(SYMBOL_NUMBER ** 2 * self.state_number)
        self.likelihood = 0.0
        self.running_likelihoods = []

    def write(self, path):
        with open(path, "w") as f:
            f.write(("%s " % _MODEL_TYPES[self.model_type])
                    + " ".join(map(str, self.transitions))
                    + (" %s\n" % self.likelihood))
            f.write(" ".join(map(str, self.emissions)) + "\n")

    def add_expectations_file(self, path):
        with open(path) as fh:
            l = list(map(float, fh.readline().split()))
            assert int(l[0]) == _MODEL_TYPES[self.model_type]
            self.likelihood += l[-1]
            self.transitions = self.transitions + np.array(l[1:-1])
            l = list(map(float, fh.readline().split()))
            self.emissions = self.emissions + np.array(l)
            rest = fh.readline().split()
            self.running_likelihoods = list(map(float, rest))
        return self

    @classmethod
    def load(cls, path):
        with open(path) as fh:
            l = fh.readline().split()
        model_type = {v: k for k, v in _MODEL_TYPES.items()}[int(l[0])]
        return cls(model_type).add_expectations_file(path)

    def normalise(self):
        t = self.transitions.reshape(self.state_number, self.state_number)
        self.transitions = (t / t.sum(axis=1, keepdims=True)).ravel()
        e = self.emissions.reshape(self.state_number, -1)
        self.emissions = (e / e.sum(axis=1, keepdims=True)).ravel()

    def randomise(self, rng=None):
        rng = rng or random
        self.transitions = np.array([rng.random()
                                     for _ in range(self.state_number ** 2)])
        self.emissions = np.array([rng.random() for _ in range(
            self.state_number * SYMBOL_NUMBER ** 2)])
        self.normalise()

    def equalise(self):
        self.transitions = np.full(self.state_number ** 2,
                                   1.0 / self.state_number)
        self.emissions = np.full(self.state_number * SYMBOL_NUMBER ** 2,
                                 1.0 / SYMBOL_NUMBER ** 2)

    def set_emissions_to_jukes_cantor(self, divergence):
        i = (0.25 + 0.75 * math.exp(-4.0 * divergence / 3.0)) / 4.0
        j = (0.25 - 0.25 * math.exp(-4.0 * divergence / 3.0)) / 4.0
        e = self.emissions.reshape(self.state_number, SYMBOL_NUMBER,
                                   SYMBOL_NUMBER)
        for x in range(SYMBOL_NUMBER):
            for y in range(SYMBOL_NUMBER):
                e[:, x, y] = i if x == y else j
        self.emissions = e.ravel()

    def tie_emissions(self):
        e = self.emissions.reshape(self.state_number, SYMBOL_NUMBER,
                                   SYMBOL_NUMBER)
        for s in range(self.state_number):
            ident = np.trace(e[s])
            e[s][:] = (1.0 - ident) / (SYMBOL_NUMBER ** 2 - SYMBOL_NUMBER)
            np.fill_diagonal(e[s], ident / SYMBOL_NUMBER)
        self.emissions = e.ravel()

    def to_state_machine(self):
        """getStateMachine5-equivalent (impl/stateMachine.c:1748-1773):
        fiveState loads symmetric, fiveStateAsymmetric loads asymmetric;
        threeState types abort there too (getStateMachine5 has no branch
        for them)."""
        if self.state_number != 5:
            raise ValueError(
                f"model type {self.model_type!r} cannot be loaded into a "
                "5-state machine (getStateMachine5, "
                "impl/stateMachine.c:1748-1773)")
        hd = HmmDiscrete(self.state_number, SYMBOL_NUMBER,
                         type_=_MODEL_TYPES[self.model_type])
        hd.transitions = self.transitions.reshape(self.state_number,
                                                  self.state_number).copy()
        hd.emissions = self.emissions.reshape(self.state_number,
                                              SYMBOL_NUMBER,
                                              SYMBOL_NUMBER).copy()
        return sm5_from_hmm(hd)


@dataclass
class EmOptions:
    """cPecanEm.py Options (cPecanEm.py:361-380)."""

    model_type: str = "fiveState"
    input_model: str = None
    iterations: int = 10
    trials: int = 3
    random_start: bool = False
    update_the_band: bool = False
    max_alignment_length_per_job: int = 1_000_000
    max_alignment_length_to_sample: int = 50_000_000
    use_default_model_as_start: bool = False
    set_jukes_cantor_starting_emissions: float = None
    tie_emissions: bool = False
    train_emissions: bool = False
    blast_scoring_matrix_file: str = None
    # 'pallas' (the JAX package's name for it): the whole E-step batched
    # through the 5-state wavefront kernels with in-kernel transition and
    # emission expectations; 'scan' is not ported (SCAN_ENGINE)
    engine: str = "pallas"
    # optionsToRealign defaults (cPecanEm.py:371): the CLI squares
    # --splitMatrixBiggerThanThis=3000 (cPecanRealign.c:453)
    realign_params: AlignmentParams = field(default_factory=lambda: AlignmentParams(
        diagonal_expansion=10, split_matrix_bigger_than_this=3000 * 3000,
        constraint_diagonal_trim=0))


def _check_options(options):
    """Refuse what the port does not run, before any work."""
    if options.engine != "pallas":
        raise NotImplementedError(f"engine={options.engine!r}: {SCAN_ENGINE}")
    if options.update_the_band:
        raise NotImplementedError(
            "update_the_band re-aligns each shard with the scan engine "
            "(realign_shard), which is not ported (ROADMAP Queue 1 item 7)")


def _shard_alignments(alignments, options, rng):
    """Shard the cigars by aligned length and sample
    (cPecanEm.py:129-158)."""
    shards = []
    cur = []
    cur_len = 0.0
    for aln in alignments:
        cur.append(aln)
        cur_len += (abs(aln.start1 - aln.end1) + abs(aln.start2 - aln.end2)) / 2.0
        if cur_len > options.max_alignment_length_per_job:
            shards.append((cur, cur_len))
            cur = []
            cur_len = 0.0
    if cur:
        shards.append((cur, cur_len))
    rng.shuffle(shards)
    sampled = []
    total = 0.0
    for shard, length in shards:
        total += length
        sampled.append(shard)
        if total >= options.max_alignment_length_to_sample:
            break
    return sampled


def _anchor_pairs_np(aln, trim):
    """convert_alignment_to_anchor_pairs (cli/realign.py,
    impl/pairwiseAligner.c:1088-1112) vectorized: one arange per M op
    instead of a Python loop per matched column."""
    segs = []
    j, k = aln.start1, aln.start2
    assert aln.strand1 and aln.strand2
    for op, length in aln.operations:
        if op == "M":
            l = np.arange(trim, length - trim, dtype=np.int64)
            segs.append(np.stack([j + l, k + l], axis=1))
        if op != "I":
            j += length
        if op != "D":
            k += length
    if not segs:
        return np.zeros((0, 2), np.int64)
    return np.concatenate(segs, axis=0)


def _alignment_jobs(alignments, sequences, params):
    """Slice/rebase/anchor each cigar and split at large anchor-free gaps,
    yielding kernel jobs (sub_x, sub_y, l_x, l_y, anchors), the geometry
    the scan E-step sees.

    Anchor generation, the match/N filter and the no-split check are
    vectorized; alignments that need splitting take the reference's
    get_split_points walk."""
    jobs = []
    n_code = ord("N")
    T = params.split_matrix_bigger_than_this
    for aln in alignments:
        aln = copy.copy(aln)
        sub_x = get_sub_sequence(sequences[aln.contig1], aln.start1,
                                 aln.end1, aln.strand1)
        sub_y = get_sub_sequence(sequences[aln.contig2], aln.start2,
                                 aln.end2, aln.strand2)
        aln.operations = list(aln.operations)
        rebase_coordinates(aln, 1, -(aln.start1 if aln.strand1 else aln.end1),
                           not aln.strand1)
        rebase_coordinates(aln, 2, -(aln.start2 if aln.strand2 else aln.end2),
                           not aln.strand2)
        pairs = _anchor_pairs_np(aln, params.constraint_diagonal_trim)
        sxb = np.frombuffer(sub_x.upper().encode("latin-1"), np.uint8)
        syb = np.frombuffer(sub_y.upper().encode("latin-1"), np.uint8)
        bx = sxb[pairs[:, 0]]
        keep = (bx == syb[pairs[:, 1]]) & (bx != n_code)
        anchors = pairs[keep]
        l_x, l_y = len(sub_x), len(sub_y)
        ax, ay = anchors[:, 0], anchors[:, 1]
        # block (x2,y2)->(x3,y3) sizes between consecutive anchors plus
        # the two ragged ends: the quantities get_split_points tests
        # (impl/pairwiseAligner.c:1338-1389)
        x2 = np.concatenate([[0], ax + 1])
        y2 = np.concatenate([[0], ay + 1])
        x3 = np.concatenate([ax, [l_x]])
        y3 = np.concatenate([ay, [l_y]])
        if len(ax) and not (np.all(np.diff(ax) > 0) and np.all(
                np.diff(ay) > 0) and ax[0] >= 0 and ay[0] >= 0
                and ax[-1] < l_x and ay[-1] < l_y):
            raise ValueError("anchors not strictly increasing within "
                             f"[0, {l_x}) x [0, {l_y})")
        if ((x3 - x2) * (y3 - y2) <= T).all():
            jobs.append((sub_x, sub_y, l_x, l_y, anchors))
            continue
        anchors = [(int(x), int(y)) for x, y in anchors]
        split_points = get_split_points(anchors, l_x, l_y, T, True, True)
        j = 0
        for (x1, y1, x2, y2) in split_points:
            sub_anchors = []
            while j < len(anchors):
                ax, ay = anchors[j]
                if ax + ay >= x2 + y2:
                    break
                sub_anchors.append((ax - x1, ay - y1))
                j += 1
            if x2 - x1 <= 0 or y2 - y1 <= 0:
                continue
            jobs.append((sub_x[x1:x2], sub_y[y1:y2], x2 - x1, y2 - y1,
                         sub_anchors))
    return jobs


def calculate_expectations_pallas(shards, sequences, sm, params, aligner,
                                  mesh=None, stage=None):
    """The whole E-step on the wavefront kernels: every alignment of every
    shard through ``aligner`` (a ``Dna5Aligner``) with in-kernel transition
    and emission expectations, the counterpart of per-shard cPecanRealign
    --outputExpectations jobs.  Returns the merged ``HmmDiscrete``
    (pseudocount 1e-12) with the summed likelihood.

    The jobs run in chunks of CHUNK, ragged at both ends.  Every chunk's
    run is deferred (``run(defer_expectations=True)``): all chunks' kernels
    are queued before the first chunk's one device-to-host copy
    (``finalize_expectations``) waits, so the host's work on one chunk
    overlaps the card's on the next.  ``stage(name, fn)``, when given,
    runs each step ("jobs", the runs' own steps, "finalize") so that a
    caller can time them."""
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel E-steps are not ported yet (ROADMAP Queue 1 "
            "item 9)")
    stage = stage or _call
    jobs = stage("jobs", lambda: _alignment_jobs(
        [a for shard in shards for a in shard], sequences, params))
    hmm = HmmDiscrete(5, SYMBOL_NUMBER, pseudocount=1e-12)
    hmm.likelihood = 0.0
    if not jobs:
        return hmm
    outs = [aligner.run(sm, jobs[i:i + CHUNK], expectations=True,
                        defer_expectations=True, ragged_left=True,
                        ragged_right=True, stage=stage)
            for i in range(0, len(jobs), CHUNK)]
    for out in outs:
        exp = stage("finalize", lambda: aligner.finalize_expectations(sm,
                                                                      out))
        hmm.transitions += exp["trans"].sum(axis=0)
        hmm.emissions += exp["emis"].sum(axis=0)
        hmm.likelihood += float(exp["likelihood"].sum())
    return hmm


def expectation_maximisation(sequences, alignments, options: EmOptions,
                             rng=None, checkpoint_dir=None, resume=False,
                             aligner=None, device="cuda", stage=None):
    """Single EM run (expectationMaximisation(2), cPecanEm.py:107-214).
    Returns the trained PipelineHmm with running likelihoods.

    The E-steps run on ``aligner`` (one is made for ``device`` unless
    given: the CUDA device by default, whose kernels run them; "cpu" runs
    their plain versions).  With checkpoint_dir set, the trainer state
    (HMM, running likelihoods, the shard draw's RNG state) is checkpointed
    after every M-step and resume=True continues an interrupted run from
    the latest iteration.  ``stage`` goes to every E-step
    (``calculate_expectations_pallas``)."""
    _check_options(options)
    rng = rng or random.Random(0)
    if options.input_model is not None:
        hmm = PipelineHmm.load(options.input_model)
        hmm.normalise()
    else:
        hmm = PipelineHmm(options.model_type)
        if options.random_start:
            hmm.randomise(rng)
        else:
            hmm.equalise()
    if options.set_jukes_cantor_starting_emissions is not None:
        hmm.set_emissions_to_jukes_cantor(
            options.set_jukes_cantor_starting_emissions)

    manager = None
    start_iteration = 0
    running = []
    if checkpoint_dir is not None:
        from ..utils.checkpoint import (CheckpointManager,
                                        rng_state_from_json,
                                        rng_state_to_json)
        manager = CheckpointManager(checkpoint_dir)
        if resume:
            restored = manager.restore()
            if restored is not None:
                step, arrays, meta = restored
                start_iteration = step + 1
                hmm = PipelineHmm(meta["model_type"])
                hmm.transitions = arrays["transitions"].copy()
                hmm.emissions = arrays["emissions"].copy()
                hmm.likelihood = meta["likelihood"]
                running = list(meta["running"])
                rng = rng_state_from_json(meta["rng_state"])

    # checkpoint the PRE-sharding RNG state: a resumed run must re-draw the
    # same shard sample/shuffle as the interrupted run
    if manager is not None:
        shard_rng_state = rng_state_to_json(rng)
    shards = _shard_alignments(alignments, options, rng)
    if aligner is None:
        # shared across iterations (and across trials when the caller
        # passes one in)
        aligner = aligner_for(options.realign_params, device)
    for iteration in range(start_iteration, options.iterations):
        use_default = options.use_default_model_as_start and iteration == 0
        sm = StateMachine5() if use_default else hmm.to_state_machine()
        merged = calculate_expectations_pallas(
            shards, sequences, sm, options.realign_params, aligner,
            stage=stage)
        if not shards:
            break
        new = PipelineHmm(options.model_type)
        new.transitions = merged.transitions.ravel().copy()
        new.emissions = merged.emissions.ravel().copy()
        new.likelihood = merged.likelihood
        new.normalise()
        running.append(new.likelihood)
        if not options.train_emissions:
            new.emissions = hmm.emissions.copy()
        elif options.tie_emissions:
            new.tie_emissions()
        hmm = new
        if manager is not None:
            manager.save(iteration,
                         arrays={"transitions": hmm.transitions,
                                 "emissions": hmm.emissions},
                         meta={"model_type": hmm.model_type,
                               "likelihood": hmm.likelihood,
                               "running": running,
                               "rng_state": shard_rng_state})
    hmm.running_likelihoods = running
    return hmm


def expectation_maximisation_trials(sequences, alignments, options: EmOptions,
                                    rng=None, device="cuda"):
    """Multi-trial random restarts picking max likelihood
    (expectationMaximisationTrials(2), cPecanEm.py:217-242), every trial
    on one aligner for ``device``."""
    _check_options(options)
    rng = rng or random.Random(0)
    aligner = aligner_for(options.realign_params, device)
    if options.input_model is not None or not options.random_start:
        return expectation_maximisation(sequences, alignments, options, rng,
                                        aligner=aligner)
    trials = [expectation_maximisation(sequences, alignments, options,
                                       random.Random(rng.random()),
                                       aligner=aligner)
              for _ in range(options.trials)]
    return max(trials, key=lambda h: h.likelihood)


def make_blast_scoring_matrix(hmm: PipelineHmm, sequences):
    """makeBlastScoringMatrix (cPecanEm.py:301-337)."""
    hmm2 = PipelineHmm("threeState")
    t = hmm.transitions
    n = hmm.state_number
    hmm2.transitions = np.concatenate([t[:3], t[n:n + 3], t[2 * n:2 * n + 3]])
    hmm2.emissions = hmm.emissions[: 3 * SYMBOL_NUMBER ** 2].copy()
    hmm2.normalise()
    hmm = hmm2

    gc = sum(sum(1.0 for y in x if y in "GC") for x in sequences) / \
        max(sum(len(x) for x in sequences), 1)

    def base_prob(x):
        return gc / 2.0 if x in (1, 2) else (1.0 - gc) / 2.0

    match_probs = [hmm.emissions[x * SYMBOL_NUMBER + y] / (base_prob(x) * base_prob(y))
                   for x, y in product(range(SYMBOL_NUMBER), range(SYMBOL_NUMBER))]
    match_continue = hmm.transitions[0]
    n_prob = math.sqrt(math.exp(
        (6.94 + sum(math.log(x * match_continue) for x in match_probs))
        / len(match_probs)))
    weight = 100
    match_probs = [weight * math.log((x * match_continue) / n_prob ** 2)
                   for x in match_probs]
    s = hmm.state_number
    gap_open = weight * math.log(
        (0.5 * (hmm.transitions[1] / n_prob + hmm.transitions[2] / n_prob))
        * ((hmm.transitions[s * 1 + 0] + hmm.transitions[s * 2 + 0]) / (2 * n_prob ** 2))
        * ((n_prob ** 2) / match_continue))
    gap_extend = weight * math.log(
        0.5 * (hmm.transitions[s * 1 + 1] / n_prob
               + hmm.transitions[s * 2 + 2] / n_prob))
    return match_probs, gap_open, gap_extend


def write_lastz_scoring_matrix(fh, match_probs, gap_open, gap_extend):
    """writeLastzScoringMatrix (cPecanEm.py:339-359)."""
    fh.write("gap_open_penalty = %s\n" % int(round(-gap_open)))
    fh.write("gap_extend_penalty = %s\n" % int(round(-gap_extend)))
    bases = "ACGT"
    fh.write("\t\t" + "\t".join(bases) + "\n")
    for x in range(4):
        row = match_probs[x * SYMBOL_NUMBER:(x + 1) * SYMBOL_NUMBER]
        fh.write("\t%s\t%s\n" % (bases[x],
                                 "\t".join(str(int(round(v))) for v in row)))
