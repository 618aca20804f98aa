"""The kernel library's build cache (``cpecan_tpu_torch/ops/cuda_build.py``),
with a stand-in for ``nvcc``: a cached library comes back with the ptxas
report of the run that built it, and a failed build raises."""

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
