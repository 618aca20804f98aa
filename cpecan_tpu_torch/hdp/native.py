"""ctypes bridge to the native C++ Gibbs sampler (native/hdp_gibbs.cc;
a copy of ``cpecan_tpu/hdp/native.py`` on the port's own build of the
sampler, ``cpecan_tpu_torch.native.load_library``).

Runs the whole Gibbs phase (factor moves, distribution samples, gamma
resampling) natively against a mirror of a Python
HierarchicalDirichletProcess, then copies the accumulated posterior grids
and concentration parameters back.  Factor-tree state stays native — the
downstream pipeline (finalize_distributions -> density queries / tables)
only needs the grid accumulators, exactly like the reference's consumers
(impl/hdp.c:2540-2601).
"""

import ctypes

import numpy as np

from ..native import load_library

_lib = None
_lib_tried = False


def _get_lib():
    global _lib, _lib_tried
    if not _lib_tried:
        _lib_tried = True
        lib, _what = load_library("hdp_gibbs")
        if lib is not None:
            c_double_p = ctypes.POINTER(ctypes.c_double)
            c_int64_p = ctypes.POINTER(ctypes.c_int64)
            lib.hdp_new.restype = ctypes.c_void_p
            lib.hdp_new.argtypes = [ctypes.c_int, ctypes.c_int] + \
                [ctypes.c_double] * 6 + [ctypes.c_int, ctypes.c_uint64]
            lib.hdp_free.argtypes = [ctypes.c_void_p]
            lib.hdp_set_gamma.argtypes = [ctypes.c_void_p, c_double_p]
            lib.hdp_set_gamma_prior.argtypes = [ctypes.c_void_p, c_double_p,
                                                c_double_p]
            lib.hdp_set_parent.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_int]
            lib.hdp_finalize.argtypes = [ctypes.c_void_p]
            lib.hdp_pass_data.argtypes = [ctypes.c_void_p, c_double_p,
                                          c_int64_p, ctypes.c_long]
            lib.hdp_gibbs.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                      ctypes.c_long, ctypes.c_long]
            lib.hdp_samples_taken.restype = ctypes.c_long
            lib.hdp_samples_taken.argtypes = [ctypes.c_void_p]
            lib.hdp_observed.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.hdp_get_posterior.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                              c_double_p]
            lib.hdp_get_gamma.argtypes = [ctypes.c_void_p, c_double_p]
            lib.hdp_num_factors.restype = ctypes.c_long
            lib.hdp_num_factors.argtypes = [ctypes.c_void_p, ctypes.c_int]
        _lib = lib
    return _lib


def native_available():
    return _get_lib() is not None


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def run_native_gibbs(hdp, num_samples, burn_in, thinning, seed=None):
    """Mirror `hdp` (a Python HierarchicalDirichletProcess with finalized
    structure + data) into the native sampler, run the Gibbs phase, and
    write the posterior-grid accumulators / sample count / gammas back
    into `hdp`.  Raises RuntimeError when the native library is missing.

    The native sampler re-initializes factor state from the data (the
    normal pass_data -> execute flow); a sampler deserialized mid-stream
    that must resume from its exact factor configuration should use
    backend='python'."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native hdp_gibbs library unavailable")
    if hdp.data is None or not hdp.finalized:
        raise ValueError("need data and finalized structure")
    if seed is None:
        seed = int(hdp.rng.integers(0, 2 ** 63 - 1))
    grid = hdp.sampling_grid
    h = lib.hdp_new(hdp.num_dps, hdp.depth, hdp.mu, hdp.nu, hdp.two_alpha,
                    hdp.beta, float(grid[0]), float(grid[-1]),
                    hdp.grid_length, seed)
    try:
        if hdp.sample_gamma:
            ga = np.ascontiguousarray(hdp.gamma_alpha, dtype=np.float64)
            gb = np.ascontiguousarray(hdp.gamma_beta, dtype=np.float64)
            lib.hdp_set_gamma_prior(h, _dptr(ga), _dptr(gb))
        else:
            g = np.ascontiguousarray(hdp.gamma, dtype=np.float64)
            lib.hdp_set_gamma(h, _dptr(g))
        for dp in hdp.dps:
            if dp.parent is not None:
                lib.hdp_set_parent(h, dp.id, dp.parent.id)
        lib.hdp_finalize(h)
        data = np.ascontiguousarray(hdp.data, dtype=np.float64)
        dp_ids = np.ascontiguousarray(hdp.data_pt_dp_id, dtype=np.int64)
        lib.hdp_pass_data(h, _dptr(data),
                          dp_ids.ctypes.data_as(
                              ctypes.POINTER(ctypes.c_int64)),
                          len(data))
        lib.hdp_gibbs(h, num_samples, burn_in, thinning)
        # copy accumulators back (adding on top of any prior samples)
        buf = np.zeros(hdp.grid_length, dtype=np.float64)
        for dp in hdp.dps:
            if not lib.hdp_observed(h, dp.id):
                continue
            lib.hdp_get_posterior(h, dp.id, _dptr(buf))
            if dp.posterior_predictive is None:
                dp.posterior_predictive = np.zeros(hdp.grid_length)
            dp.posterior_predictive += buf
        hdp.samples_taken += int(lib.hdp_samples_taken(h))
        gout = np.zeros(hdp.depth, dtype=np.float64)
        lib.hdp_get_gamma(h, _dptr(gout))
        hdp.gamma = gout if hdp.sample_gamma else hdp.gamma
    finally:
        lib.hdp_free(h)
    return hdp
