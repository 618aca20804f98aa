"""Build ``zymo_train.npz``: the JAX package's trainModels result on the Zymo
MinION read, for the PyTorch port's training checks.

The port trains without lastz or JAX (neither is installed beside the
GPU).  This script runs both once, on the CPU, and stores what the port
needs:

- ``guide`` str: the lastz guide cigar line of the read's 2D sequence
  against ZymoRef, as ``tests/test_signal_cli.py::_guide_cigar`` makes it;
- ``t_trans``/``c_trans`` f64 [3, 3] and ``t_kmer_gap``/``c_kmer_gap`` f64
  [4096]: the template and complement HMMs after ``ITERATIONS`` iterations
  of ``cpecan_tpu.pipeline.train_models.train(engine="pallas")`` (Pallas
  kernels in interpret mode, float64 enabled as in the test suite);
- ``t1_trans``/``c1_trans`` and ``t1_kmer_gap``/``c1_kmer_gap``: the same
  after the first iteration, as the M-step left them in memory, before
  the six-decimal HMM file the second iteration starts from;
- ``trajectory`` f64 [ITERATIONS, 2]: the (template, complement)
  likelihood of each iteration.

The first iteration runs alone with a checkpoint and the rest resume
from it, which is the same computation as one uninterrupted run: the
next iteration loads its machine from the written HMM file either way.

Run from the repository root:  python tests/fixtures/make_zymo_train_fixture.py
"""

import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "zymo_train.npz")
ITERATIONS = 2


def guide_cigar():
    """The first lastz cigar line of the read's 2D sequence against the
    reference; needs lastz."""
    from cpecan_tpu.fixtures import fixture_path
    from cpecan_tpu.io.npread import load_npread
    from cpecan_tpu.ops.blast import LASTZ_ARGS, find_lastz

    ref = open(fixture_path("ZymoRef.txt")).read().splitlines()[0]
    npr = load_npread(fixture_path("ZymoC_ch_1_file1.npRead"))
    with tempfile.TemporaryDirectory() as tmp:
        ref_fa = os.path.join(tmp, "ref.fa")
        read_fa = os.path.join(tmp, "read.fa")
        with open(ref_fa, "w") as fh:
            fh.write(">ref\n" + ref + "\n")
        with open(read_fa, "w") as fh:
            fh.write(">read2d\n" + npr.twod_read + "\n")
        res = subprocess.run([find_lastz()] + LASTZ_ARGS + [ref_fa, read_fa],
                             capture_output=True, text=True, check=True)
    return next(l for l in res.stdout.splitlines() if l.startswith("cigar:"))


def build_fixture():
    """The fixture's arrays (a dict); needs lastz and JAX on the CPU."""
    from cpecan_tpu.fixtures import fixture_path
    from cpecan_tpu.io.cigar import parse_cigar_line
    from cpecan_tpu.pipeline.train_models import TrainOptions, train

    guide = guide_cigar()
    ref = open(fixture_path("ZymoRef.txt")).read().splitlines()[0]
    out = dict(guide=np.array(guide))
    with tempfile.TemporaryDirectory() as tmp:
        ref_file = os.path.join(tmp, "ref.seq")
        with open(ref_file, "w") as fh:
            fh.write(ref + "\n")
        for iterations, tag in ((1, "1"), (ITERATIONS, "")):
            t_hmm, c_hmm, traj = train(
                ref_file,
                [(fixture_path("ZymoC_ch_1_file1.npRead"),
                  parse_cigar_line(guide))],
                fixture_path("template_median68pA.model"),
                fixture_path("complement_median68pA_pop2.model"),
                os.path.join(tmp, "t.hmm"), os.path.join(tmp, "c.hmm"),
                TrainOptions(iterations=iterations, engine="pallas"),
                log=lambda m: None, checkpoint_dir=os.path.join(tmp, "ckpt"),
                resume=iterations > 1)
            for s, hmm in (("t", t_hmm), ("c", c_hmm)):
                out[f"{s}{tag}_trans"] = hmm.transitions
                out[f"{s}{tag}_kmer_gap"] = hmm.kmer_gap_probs
    return dict(out, trajectory=np.asarray(traj, np.float64))


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    np.savez_compressed(OUT, **build_fixture())
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
