"""Build ``batch_zymo.npz``: what the port's signalAlign batch pipeline
(``cpecan_tpu_torch.pipeline.signal_align_batch.run_batch_fast``) is held
to, on the CPU and on the card, where there is no JAX.

From the Zymo MinION read and the lastz guide cigar that
``zymo_train.npz`` holds, with the JAX package on the CPU (interpret-mode
Pallas kernels, float64 enabled as in the test suite):

- ``{sm}_tsv`` uint8 [n]: the bytes of the read's posterior tsv (both
  strands, the 15 columns of writePosteriorProbs) that the JAX
  ``cpecan_tpu.pipeline.signal_align_batch.run_batch_fast`` writes for
  ``sm_type`` ``sm`` in ``threeState``, ``vanilla`` and ``fourState``
  (untrained machines, the vendored pore models, the default threshold and
  ``compact_k``, one read per kernel group);
- ``guide``: the guide cigar line (``zymo_train.npz``'s), ``label``: the
  read's label (its npRead's base name), ``threshold`` and ``group``: the
  run's settings.

Neither lastz nor JAX is needed to use it (``fixtures.load_batch_zymo``).

Run from the repository root (needs JAX; a few minutes):
    python tests/fixtures/make_batch_fixture.py
"""

import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "batch_zymo.npz")
SM_TYPES = ("threeState", "vanilla", "fourState")
GROUP = 1


def build_fixture():
    """The fixture's arrays (a dict); needs JAX on the CPU."""
    from cpecan_tpu.align import AlignmentParams
    from cpecan_tpu.fixtures import fixture_path
    from cpecan_tpu.pipeline.signal_align_batch import run_batch_fast

    guide = str(np.load(os.path.join(HERE, "zymo_train.npz"))["guide"])
    npread = fixture_path("ZymoC_ch_1_file1.npRead")
    label = os.path.basename(npread).replace(".npRead", "")
    threshold = AlignmentParams().threshold
    res = dict(guide=np.array(guide), label=np.array(label),
               threshold=np.float64(threshold), group=np.int64(GROUP))
    for sm_type in SM_TYPES:
        with tempfile.TemporaryDirectory() as tmp:
            rows = run_batch_fast(
                fixture_path("ZymoRef.txt"), [(npread, guide)], tmp,
                template_model_file=fixture_path("template_median68pA.model"),
                complement_model_file=fixture_path(
                    "complement_median68pA_pop2.model"),
                threshold=threshold, group=GROUP, log=print,
                sm_type=sm_type)
            if not (len(rows) == 1 and rows[0][1]):
                raise RuntimeError(f"{sm_type}: {rows}")
            with open(os.path.join(tmp, label + ".tsv"), "rb") as fh:
                res[f"{sm_type}_tsv"] = np.frombuffer(fh.read(), np.uint8)
        print(f"{sm_type}: {rows[0][2]}, {len(res[f'{sm_type}_tsv'])} bytes")
    return res


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    np.savez_compressed(OUT, **build_fixture())
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
