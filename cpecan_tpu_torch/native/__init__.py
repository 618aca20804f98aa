"""Host-side native code of the port: the posterior-tsv block formatter
(``tsv_format.cc``, a copy of ``cpecan_tpu/native/tsv_format.cc``), the
HDP Gibbs sampler (``hdp_gibbs.cc``, a copy of
``cpecan_tpu/native/hdp_gibbs.cc``; wrapped by ``cpecan_tpu_torch.hdp.
native``) and the MSA layer's greedy column build (``msa_columns.cc``, a
copy of ``cpecan_tpu/native/msa_columns.cc``; wrapped by
``cpecan_tpu_torch.msa.multiple_aligner``).

A source builds with ``g++`` at its first use into ``build/native/`` at the
repository root (gitignored), named by a hash of the source and flags, and
loads with ``ctypes``.  Callers build it once, before any thread uses it;
where no C++ toolchain is present ``load_library`` returns None and says
why, and the caller's Python path runs instead (the tsv formatter's output
is identical, and so are the greedy column build's columns; the Python
sampler draws another random stream).  Each
library has its own flags (``LIBRARY_FLAGS``): the sampler's are the JAX
package's build (``-march=native``, OpenMP), retried without those two
where the toolchain refuses them, as that build retries.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
# per library: the flag sets to try in turn (FLAGS where none is named)
LIBRARY_FLAGS = {"hdp_gibbs": (("-O3", "-march=native", "-fopenmp",
                                "-shared", "-fPIC", "-std=c++17"), FLAGS)}

_LOCK = threading.Lock()
_LOADED = {}


def load_library(name):
    """(ctypes handle of ``<name>.cc``'s library or None, what happened:
    the library's path, or why it did not build)."""
    with _LOCK:
        if name not in _LOADED:
            _LOADED[name] = _build_and_load(name)
        return _LOADED[name]


def _build_and_load(name):
    src = SRC_DIR / f"{name}.cc"
    why = []
    for flags in LIBRARY_FLAGS.get(name, (FLAGS,)):
        lib, what = _build_one(src, name, flags)
        if lib is not None:
            return lib, what
        why.append(what)
    return None, "; ".join(why)


def _build_one(src, name, flags):
    h = hashlib.sha256(" ".join(flags).encode() + src.read_bytes())
    path = BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"
    if not path.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            return None, "no g++ on PATH"
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run([gxx, *flags, str(src), "-o", str(tmp)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            return None, f"g++ failed ({res.returncode}): {res.stderr[-500:]}"
        os.replace(tmp, path)
    try:
        return ctypes.CDLL(str(path)), str(path)
    except OSError as exc:
        return None, f"could not load {path}: {exc}"
