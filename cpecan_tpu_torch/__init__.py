"""PyTorch/CUDA port of cpecan_tpu (banded pair-HMM signal alignment).

Its first slice is the strawman 3-state signal machine's posterior fast
path (``ops.fb.StrawmanAligner``), running on an NVIDIA Hopper GPU through
hand-written CUDA kernels (``csrc/``) and on the CPU through their plain
PyTorch versions.  The JAX package ``cpecan_tpu`` is the reference; this
package imports only its numpy modules.
"""
