"""The branch-free ``log_add_sel`` of ``cpecan_tpu_torch/csrc/logspace.cuh``
(the log-add of the tiled dna5 kernels) against the branch ``log_add`` of
the same header and against the plain ``fb_kernels.log_add``.

``log_add_sel`` selects the coefficients of the gap's cubic and evaluates
one Horner form; under ``--fmad=false`` that is the f32 operation sequence
of the branch ``log_add``.  The header's constants are read from the
source and the select-then-Horner form is transcribed in torch, so the CPU
shows what the card's kernels compute bit for bit."""

import inspect
import re
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

from cpecan_tpu_torch.ops import fb_kernels as fk

HEADER = (Path(__file__).resolve().parents[1] / "cpecan_tpu_torch" / "csrc"
          / "logspace.cuh").read_text()
LITERAL = r"(-?\d+\.\d+)"


def _body(name):
    """The source of ``float name(float x, float y) { ... }``."""
    m = re.search(r"float " + name + r"\(float x, float y\) \{\n(.*?)\n\}",
                  HEADER, re.S)
    assert m, name
    return m.group(1)


def _branch_table():
    """(bounds, coefficients by interval highest power first, cutoff) of
    the branch ``log_add``: ``gap >= 7.5`` first, then per interval its
    bound and its cubic, the last without a bound."""
    vals = re.findall(LITERAL + "f", _body("log_add"))
    cutoff, rest = vals[0], vals[1:]
    bounds, coefs = [], []
    while len(rest) > 4:
        bounds.append(rest[0])
        coefs.append(rest[1:5])
        rest = rest[5:]
    coefs.append(rest)
    return bounds, coefs, cutoff


def _sel_table():
    """The same table read out of ``log_add_sel``: its three interval
    tests, the selects of c3, c2, c1, c0 (one literal per interval each)
    and its cutoff."""
    body = _body("log_add_sel")
    bounds = re.findall(r"d <= " + LITERAL + "f", body)
    by_power = [re.findall(LITERAL + "f",
                           re.search(rf"const float c{k} = (.*?);", body,
                                     re.S).group(1))
                for k in (3, 2, 1, 0)]
    coefs = [list(c) for c in zip(*by_power)]
    cutoff = re.search(r"d >= " + LITERAL + r"f \? hi", body).group(1)
    return bounds, coefs, cutoff


def test_log_add_sel_constants_equal_log_add():
    """Same interval bounds, the same four cubics in the same interval
    order and the same cutoff as the branch log_add; and the plain
    ``fb_kernels.log_add`` spells the same decimals."""
    branch, sel = _branch_table(), _sel_table()
    assert sel == branch
    bounds, coefs, cutoff = sel
    assert bounds == ["1.0", "2.5", "4.5"] and cutoff == "7.5"
    assert len(coefs) == 4 and all(len(c) == 4 for c in coefs)
    plain = re.findall(LITERAL, inspect.getsource(fk.log_add))
    for c in coefs:
        # each cubic appears in the plain version as (c3 * d + c2) ...
        assert any(plain[i:i + 4] == c for i in range(len(plain) - 3)), c


def _f32_nearest(text):
    """The f32 nearest to the decimal ``text`` (ties to even): what nvcc
    makes of the literal ``text``f."""
    exact = Fraction(text)
    f = np.float32(float(text))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    best = min(cands, key=lambda c: (abs(Fraction(float(c)) - exact),
                                     int(np.float32(c).view(np.int32)) & 1))
    return np.float32(best)


def test_log_add_constants_round_alike_on_both_paths():
    """The decimals round to the same f32 directly (the CUDA literal) and
    through a Python float (the plain version's scalar)."""
    bounds, coefs, cutoff = _sel_table()
    for text in bounds + [cutoff] + [c for cs in coefs for c in cs]:
        assert _f32_nearest(text).view(np.int32) == \
            np.float32(float(text)).view(np.int32), text


def _log_add_sel_torch(x, y):
    """Select-then-Horner, transcribed from the header's log_add_sel."""
    bounds, coefs, cutoff = _sel_table()
    b0, b1, b2 = (float(b) for b in bounds)
    lo = torch.minimum(x, y)
    hi = torch.maximum(x, y)
    d = hi - lo
    i0, i1, i2 = d <= b0, d <= b1, d <= b2

    def sel(k):
        c = [torch.tensor(float(cs[k]), dtype=torch.float32)
             for cs in coefs]
        return torch.where(i0, c[0], torch.where(
            i1, c[1], torch.where(i2, c[2], c[3])))

    c3, c2, c1, c0 = (sel(k) for k in range(4))
    lk = ((c3 * d + c2) * d + c1) * d + c0
    return torch.where(d >= float(cutoff), hi, lk + lo)


def _grid():
    """(x, y) f32 pairs: a dense grid of gaps 0..9 at several offsets, the
    interval ends 0, 1.0, 2.5, 4.5, 7.5 and their f32 neighbours exactly,
    both orders, and NEG operands."""
    f32 = np.float32
    dense = np.linspace(0.0, 9.0, 400_001, dtype=np.float32)
    ends = np.array([0.0, 1.0, 2.5, 4.5, 7.5], np.float32)
    near = [ends]
    for direction in (-np.inf, np.inf):
        v = ends
        for _ in range(3):
            v = np.nextafter(v, f32(direction))
            near.append(v)
    near = np.abs(np.concatenate(near)).astype(np.float32)
    xs, ys = [], []
    for off in (0.0, -3.7, -1234.5, 10.25, -88.0):
        for gaps in (dense, near):
            a = np.full_like(gaps, off)
            xs += [a, a + gaps]
            ys += [a + gaps, a]
    # exact gaps at offset 0 (hi - lo == gap)
    xs.append(np.zeros_like(near))
    ys.append(near)
    neg = f32(fk.NEG)
    vals = np.array([0.0, -0.5, -7.0, -1e3, neg, neg + f32(5e23)],
                    np.float32)
    px, py = np.meshgrid(vals, vals)
    xs += [px.ravel(), np.full(3, neg)]
    ys += [py.ravel(), np.array([neg, 1.0, -1e29], np.float32)]
    return (torch.from_numpy(np.concatenate(xs).astype(np.float32)),
            torch.from_numpy(np.concatenate(ys).astype(np.float32)))


@pytest.mark.parametrize("order", ["xy", "yx"])
def test_log_add_sel_equals_plain_log_add_bit_for_bit(order):
    """The transcription of log_add_sel equals fb_kernels.log_add bit for
    bit (as int32 views) on every grid pair, NEG arithmetic included
    (NEG - NEG = 0: the gap-0 cubic added to NEG)."""
    x, y = _grid()
    if order == "yx":
        x, y = y, x
    got = _log_add_sel_torch(x, y)
    want = fk.log_add(x, y)
    assert got.dtype == want.dtype == torch.float32
    diff = got.view(torch.int32) != want.view(torch.int32)
    assert not diff.any(), (x[diff][:5], y[diff][:5], got[diff][:5],
                            want[diff][:5])
    # every interval and the cutoff are exercised
    d = (torch.maximum(x, y) - torch.minimum(x, y))
    for lo_, hi_ in ((0, 1.0), (1.0, 2.5), (2.5, 4.5), (4.5, 7.5),
                     (7.5, 1e38)):
        assert ((d > lo_) & (d <= hi_)).sum() > 1000
    assert (got == np.float32(fk.NEG)).any()
