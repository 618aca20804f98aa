"""PyTorch/CUDA port of cpecan_tpu (banded pair-HMM alignment).

The pair-HMM machines (the strawman, vanilla and 4-state signal machines,
the 7-state echelon signal machine, the 5-state DNA machine) run their
banded forward, posterior and EM expectation passes, untiled and tiled, on
hand-written CUDA kernels for NVIDIA Hopper (``csrc/``, wrapped by
``ops.fb_kernels``) and on the CPU through their plain PyTorch versions
(echelon: forward and posteriors, untiled; ``models.state_machines.
StateMachineEchelon``/``StateMachineEchelonB``, ``ops.fb.EchelonAligner``,
``ops.compact.extract_echelon_pairs``/``_chunk``).  On them sit the
posterior aligners (``ops.fb``), the signalAlign batch pipeline
(``pipeline.signal_align_batch``), trainModels (``pipeline.train_models``),
cPecanRealign (``cli.realign``) and cPecanEm (``pipeline.em``), with their
CLIs (``cli.batch``).  The JAX package ``cpecan_tpu`` is the reference;
this package imports nothing of it, nor JAX, and keeps its own copies of
the numpy-only modules it needs.
"""
