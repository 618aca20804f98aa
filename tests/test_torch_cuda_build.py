"""The kernel library's build cache (``cpecan_tpu_torch/ops/cuda_build.py``),
with a stand-in for ``nvcc``: a cached library comes back with the ptxas
report of the run that built it, and a failed build raises.  And the entry
table: the C entry points of ``csrc/wavefront.cu``, the ctypes signatures
that load them and ``chip_smoke.py``'s kernels line name the same 26
kernel instances (25 wavefront instances and the echelon emission
pre-pass)."""

import ctypes
import re
import stat

import pytest

from cpecan_tpu_torch.ops import cuda_build

FAKE_NVCC = """#!/bin/sh
echo run >> "{calls}"
while [ $# -gt 0 ]; do
    if [ "$1" = "-o" ]; then : > "$2"; fi
    shift
done
echo "ptxas info    : Used 12 registers, used 1 barriers"
exit {rc}
"""


def _fake_nvcc(tmp_path, monkeypatch, rc=0):
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(calls=calls, rc=rc))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "kernels")
    return calls


def test_cached_library_keeps_its_ptxas_report(tmp_path, monkeypatch):
    calls = _fake_nvcc(tmp_path, monkeypatch)
    path, seconds, log = cuda_build._built()
    assert path.exists() and seconds is not None
    assert "Used 12 registers" in log
    # the second call finds the library and its stored report
    again, seconds2, log2 = cuda_build._built()
    assert (again, seconds2, log2) == (path, None, log)
    assert calls.read_text().count("run") == 1
    # a library without its report is built again
    path.with_suffix(".log").unlink()
    _, seconds3, log3 = cuda_build._built()
    assert seconds3 is not None and log3 == log
    assert calls.read_text().count("run") == 2
    assert sorted(p.name for p in path.parent.iterdir()) == sorted(
        [path.name, path.with_suffix(".log").name])


def test_failed_build_raises_and_caches_nothing(tmp_path, monkeypatch):
    _fake_nvcc(tmp_path, monkeypatch, rc=1)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cuda_build._built()
    assert not any(p.suffix in (".so", ".log")
                   for p in (tmp_path / "kernels").iterdir())


# -- the entry table: wavefront.cu's C entry points, the ctypes signatures
# of cuda_build._SIGNATURES and chip_smoke.py's kernels line agree --------

REPO = cuda_build.CSRC.parents[1]
WAVEFRONT = (cuda_build.CSRC / "wavefront.cu").read_text()


def _entry_macros():
    """{macro name: its C parameter list as ctypes types}, from the
    ``#define WAVEFRONT_*_ENTRY(NAME, SPEC) int NAME(...)`` definitions."""
    macros = {}
    for m in re.finditer(r"#define (WAVEFRONT_\w+_ENTRY)\(NAME, SPEC\)\s*\\\n"
                         r"\s*int NAME\((.*?)\)\s*\{", WAVEFRONT, re.S):
        params = [p.replace("\\", " ").split()
                  for p in m.group(2).split(",")]
        kinds = []
        for p in params:
            assert p[-1].isidentifier(), p
            kinds.append(ctypes.c_void_p if p[-1].startswith("*")
                         or "void*" in p else ctypes.c_int)
            assert kinds[-1] is ctypes.c_void_p or p[:-1] == ["int"], p
        macros[m.group(1)] = kinds
    return macros


def _entries():
    """[(entry point, macro)] in the order wavefront.cu defines them."""
    return re.findall(r"^(WAVEFRONT_\w+_ENTRY)\((\w+), \w+\)$", WAVEFRONT,
                      re.M)


def test_every_signature_has_one_entry_point_of_its_shape():
    """Each name of ``_SIGNATURES`` is defined exactly once among the entry
    macros' instances, no instance lacks a signature, and each signature
    lists the macro's C parameters in order (a pointer where the C side
    takes one, an int where it takes an int): ctypes would otherwise cut
    a pointer or shift the arguments."""
    macros = _entry_macros()
    entries = _entries()
    names = [name for _, name in entries]
    assert sorted(names) == sorted(cuda_build._SIGNATURES)
    assert len(set(names)) == len(names) == 26
    for macro, name in entries:
        assert cuda_build._SIGNATURES[name] == macros[macro], name


def test_chip_smoke_kernels_line_names_every_entry_point():
    """chip_smoke.py's kernels line has one entry per kernel instance: all
    26 entry points, each once."""
    smoke = (REPO / "chip_smoke.py").read_text()
    line = smoke[smoke.index('log(json.dumps({"kernels": ['):]
    named = re.findall(r'entry\("(wavefront_\w+)",', line)
    assert sorted(named) == sorted(cuda_build._SIGNATURES)
