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


# -- gauss_sel and the strawman's forms written once (wavefront.cu
# Strawman::bwd_update_with, emissions_with, emissions_in), transcribed
# from the sources and held to the plain fb_kernels versions ---------------

WAVEFRONT = (Path(__file__).resolve().parents[1] / "cpecan_tpu_torch"
             / "csrc" / "wavefront.cu").read_text()


def _gauss_sel_torch(x, mu, sd, logsd):
    """gauss_sel, transcribed from the header: its constant, guard and
    expression read from the source."""
    m = re.search(r"float gauss_sel\(float x, float mu, float sd,\s*"
                  r"float logsd\) \{\n(.*?)\n\}", HEADER, re.S)
    body = m.group(1)
    assert "const float a = (x - mu) / sd;" in body
    c = re.search(r"const float v = " + LITERAL
                  + r"f - logsd - 0\.5f \* a \* a;", body).group(1)
    assert "return sd > 0.0f ? v : CPECAN_NEG;" in body
    a = (x - mu) / sd
    v = float(c) - logsd - 0.5 * a * a
    return torch.where(sd > 0.0, v, torch.full_like(v, fk.NEG))


def _gauss_grid():
    """(x, mu, sd) f32: sd <= 0 (0, -0, negatives), tiny and huge sds, and
    ordinary ones, against events near and far from the mean."""
    rng = np.random.default_rng(11)
    sd = np.concatenate([[0.0, -0.0, -1.0, -1e-30, 1e-30, 1e-20, 1e-3,
                          1e20, 3.4e38], rng.uniform(0.1, 10.0, 200),
                         rng.uniform(-2.0, 0.5, 50)]).astype(np.float32)
    x = rng.normal(80.0, 30.0, sd.size).astype(np.float32)
    mu = (x + rng.normal(0.0, 5.0, sd.size)).astype(np.float32)
    mu[:9] = x[:9] - np.float32(2.5)
    g = np.meshgrid(np.arange(sd.size), np.arange(3), indexing="ij")[0]
    shift = np.float32([0.0, 1.5, -300.0])[np.arange(3)][None, :]
    return (torch.from_numpy((x[g] + shift).ravel()),
            torch.from_numpy(mu[g].ravel()), torch.from_numpy(sd[g].ravel()))


def test_gauss_sel_equals_plain_gauss_bit_for_bit():
    """gauss_sel with logsd = log(sd) equals fb_kernels.gauss bit for bit,
    NEG where sd <= 0 (the discarded arithmetic's NaN and inf never leak;
    a tiny sd overflows to -inf in both)."""
    x, mu, sd = _gauss_grid()
    got = _gauss_sel_torch(x, mu, sd, torch.log(sd))
    want = fk.gauss(x, mu, sd)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool((got[sd <= 0] == np.float32(fk.NEG)).all())
    assert torch.isfinite(got[sd >= 1e-3]).all() and (sd <= 0).sum() >= 9


def _method(struct, name):
    """The statements of ``struct::name``'s body, one per line, its
    comments dropped (the struct's own method, not one it inherits)."""
    start = WAVEFRONT.index(f"struct {struct} : ")
    end = WAVEFRONT.index("\n};\n", start)
    m = re.compile(name + r"\((.*?)\) \{\n(.*?)\n    \}", re.S).search(
        WAVEFRONT, start, end)
    assert m, (struct, name)
    body = re.sub(r"//[^\n]*", "", m.group(2))
    return [s.strip() for s in body.split(";") if s.strip()]


def _run_statements(stmts, env):
    """Run the C statements ``type name = expr`` / ``name = expr`` /
    ``return ...`` as Python in ``env`` (LA::add3 -> LA3, LA::add ->
    LA), each on one line."""
    for s in stmts:
        s = re.sub(r"\s+", " ", re.sub(r"^(const )?(float|Emissions) ", "",
                                        s))
        s = s.replace("LA::add3", "LA3").replace("LA::add", "LA")
        if re.fullmatch(r"\w+", s):
            continue        # a declaration without a value
        exec(s, env)
    return env


def _bwd_update_torch(la, t, e_gapx_p, eg1, em2p, n1a, n1p, n2p):
    """Strawman::bwd_update_with<LA>, transcribed statement by statement
    from wavefront.cu."""
    stmts = _method("Strawman", "bwd_update_with")
    assert sum("LA::add" in s for s in stmts) == 5
    out = [None] * 3
    env = dict(t=t, e_gapx_p=e_gapx_p, eg1=eg1, em2p=em2p, n1a=n1a,
               n1p=n1p, n2p=n2p, out=out, LA=la,
               **{k: getattr(fk, k) for k in ("T_MM", "T_XM", "T_YM",
                                              "T_OX", "T_EX", "T_SX",
                                              "T_OY", "T_EY")})
    _run_statements(stmts, env)
    return out


def _fwd_update_torch(la, t, p1m, p1a, p2m, e_match, e_gapy, e_gapx):
    """Strawman::fwd_update_with<LA>, transcribed statement by statement
    from wavefront.cu; LA::add3 is the header's log_add3 (or
    log_add3_sel), two LA::adds."""
    stmts = _method("Strawman", "fwd_update_with")
    assert sum("LA::add3" in s for s in stmts) == 2
    assert sum("LA::add(" in s for s in stmts) == 1
    for name in ("log_add3", "log_add3_sel"):
        inner = "log_add" + name[len("log_add3"):]
        assert re.search(r"float " + name + r"\(float a, float b, float c\) "
                         r"\{\n    return " + inner + r"\(" + inner
                         + r"\(a, b\), c\);\n\}", HEADER), name
    for cls, two, three in (("LogAddBranch", "log_add", "log_add3"),
                            ("LogAddSel", "log_add_sel", "log_add3_sel")):
        body = re.search(r"struct " + cls + r" \{\n(.*?)\n\};", HEADER,
                         re.S).group(1)
        assert f"return {two}(x, y);" in body
        assert f"return {three}(a, b, c);" in body
    out = [None] * 3
    env = dict(t=t, p1m=p1m, p1a=p1a, p2m=p2m, e_gapx=e_gapx, out=out,
               LA=la, LA3=lambda a, b, c: la(la(a, b), c),
               e=type("E", (), dict(match=e_match, gap_y=e_gapy))(),
               **{k: getattr(fk, k) for k in ("T_MM", "T_XM", "T_YM",
                                              "T_OX", "T_EX", "T_SX",
                                              "T_OY", "T_EY")})
    _run_statements(stmts, env)
    return out


def _update_grid(nt=8):
    """Sources with NEG operands and gaps at the cubic boundaries: every
    input a mix of ordinary log values, NEG and values 1.0, 2.5, 4.5 and
    7.5 apart (and their f32 neighbours) from a common offset; ``nt``
    transition scalars."""
    rng = np.random.default_rng(12)
    n = 20_000
    f32 = np.float32
    ends = np.array([0.0, 1.0, 2.5, 4.5, 7.5], np.float32)
    near = np.concatenate([ends, np.nextafter(ends, f32(np.inf)),
                           np.nextafter(ends, f32(-np.inf))])

    def draw():
        v = rng.uniform(-30.0, 0.0, n).astype(np.float32)
        k = rng.random(n)
        v[k < 0.15] = f32(fk.NEG)
        pick = (k >= 0.15) & (k < 0.5)
        v[pick] = f32(-5.0) - rng.choice(near, pick.sum())
        return torch.from_numpy(v)

    t = torch.from_numpy(np.log(rng.uniform(0.05, 0.9, nt)).astype(
        np.float32))
    pick = [i for i in (0, 3, 5) if i < nt]
    t[pick] = torch.tensor([0.0, -4.5, -2.5][:len(pick)])
    return t, draw


@pytest.mark.parametrize("form", ["branch", "sel"])
def test_strawman_bwd_update_with_equals_plain(form):
    """Strawman::bwd_update_with, transcribed, equals
    fb_kernels.StrawmanSpec.bwd_update_w bit for bit with either log-add
    (bwd_update: the branch log_add, which fb_kernels.log_add equals;
    bwd_update_sel: log_add_sel), NEG sources and cubic-boundary gaps
    included."""
    t, draw = _update_grid()
    e_gapx_p, eg1, em2p = draw(), draw(), draw()
    n1a, n1p, n2p = ([draw() for _ in range(3)] for _ in range(3))
    la = fk.log_add if form == "branch" else _log_add_sel_torch
    got = _bwd_update_torch(la, t, e_gapx_p, eg1, [em2p], n1a, n1p, n2p)
    xfp = torch.zeros((9, e_gapx_p.numel()))
    xfp[fk.StrawmanSpec.GAP_X] = e_gapx_p
    want = fk.StrawmanSpec.bwd_update_w(t, None, xfp, eg1, em2p, n1a, n1p,
                                        n2p)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert any(bool((g == np.float32(fk.NEG)).any()) for g in got)


@pytest.mark.parametrize("form", ["branch", "sel"])
def test_strawman_fwd_update_with_equals_plain(form):
    """Strawman::fwd_update_with, transcribed, equals
    fb_kernels.StrawmanSpec.fwd_update_w bit for bit with either log-add
    (fwd_update, the older sm3_fwd_kernel's: the branch log_add;
    fwd_update_sel, K1 and K6a strawman and K1 hdp: log_add_sel), NEG
    sources, NEG emissions and cubic-boundary gaps included."""
    t, draw = _update_grid()
    p1m, p1a, p2m = ([draw() for _ in range(3)] for _ in range(3))
    e_match, e_gapy, e_gapx = draw(), draw(), draw()
    la = fk.log_add if form == "branch" else _log_add_sel_torch
    got = _fwd_update_torch(la, t, p1m, p1a, p2m, e_match, e_gapy, e_gapx)
    xf = torch.zeros((9, e_gapx.numel()))
    xf[fk.StrawmanSpec.GAP_X] = e_gapx
    want = fk.StrawmanSpec.fwd_update_w(t, xf, e_match, e_gapy, p1m, p1a,
                                        p2m)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert any(bool((g == np.float32(fk.NEG)).any()) for g in got)
    # the sources reach every cubic and the cutoff
    d = (p2m[0] + t[fk.T_MM] - p2m[1] - t[fk.T_XM]).abs()
    for lo_, hi_ in ((0, 1.0), (1.0, 2.5), (2.5, 4.5), (4.5, 7.5),
                     (7.5, 1e38)):
        assert ((d > lo_) & (d <= hi_)).sum() > 100


def test_strawman_emissions_in_equals_plain():
    """Strawman::emissions_in (emissions_with over gauss_sel, the sd rows'
    logs from col_logs or col_logs_at), transcribed, equals
    fb_kernels.StrawmanSpec.emissions bit for bit, sd <= 0 included."""
    x, mu, sd = _gauss_grid()
    n = x.numel()
    rng = np.random.default_rng(13)
    rows = torch.from_numpy(rng.uniform(50.0, 120.0, (9, n)).astype(
        np.float32))
    rows[1::2][:4] = sd[torch.from_numpy(rng.permutation(
        np.tile(np.arange(n), 4)).reshape(4, n))]
    mean, noise = x, mu
    # col_logs: lsd[k] = logf(in[YR + 2k + 1])
    col = " ".join(_method("SignalRows", "col_logs"))
    assert "lsd[k] = logf(in[YR + 2 * k + 1])" in col
    col_at = " ".join(_method("SignalRows", "col_logs_at"))
    assert "lsd[k] = logf(xb[(2 * k + 1) * X + x])" in col_at
    lsd = [torch.log(rows[2 * k + 1]) for k in range(4)]
    # emissions_in: g(v, i) = gauss_sel(v, in[YR + i], in[YR + i + 1],
    # lsd[i / 2]) folded by emissions_with
    body = " ".join(_method("GaussRows", "emissions_in"))
    assert "gauss_sel(v, in[YR + i], in[YR + i + 1], lsd[i / 2])" in body
    assert "emissions_with(in[0], in[1]," in body
    env = dict(mean=mean, noise=noise, e=type("E", (), {})(),
               g=lambda v, i: _gauss_sel_torch(v, rows[i], rows[i + 1],
                                               lsd[i // 2]))
    _run_statements([s for s in _method("GaussRows", "emissions_with")
                     if not s.startswith("return")], env)
    e_match, e_gapy = fk.StrawmanSpec.emissions(rows, mean, noise)
    for g, w in ((env["e"].match, e_match), (env["e"].gap_y, e_gapy)):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert bool((e_match == np.float32(fk.NEG)).any())


# -- the fourState and vanilla forms of sm3_bwd_tiled_sel and
# sm3_fwd_tiled_sel (wavefront.cu Sm4:: and Vanilla::bwd_update_with and
# fwd_update_with, Vanilla::emissions_in, and the header's inv_gauss_sel),
# transcribed and held to fb_kernels ---------------------------------------


def _la3(la):
    """LA::add3 of the header's log-add types: log_add3 (log_add3_sel),
    the pair log-add applied twice (asserted in the strawman's forward
    test)."""
    return lambda a, b, c: la(la(a, b), c)


def _bits_equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("form", ["branch", "sel"])
def test_sm4_bwd_update_with_equals_plain(form):
    """Sm4::bwd_update_with, transcribed, equals
    fb_kernels.Sm4Spec.bwd_update_w bit for bit with either log-add
    (bwd_update, K2 and K3 sm4: the branch log_add; bwd_update_sel, K6b
    sm4: log_add_sel), NEG sources and cubic-boundary gaps included."""
    stmts = _method("Sm4", "bwd_update_with")
    assert sum(len(re.findall(r"LA::add\(", s)) for s in stmts) == 5
    assert sum(len(re.findall(r"LA::add3\(", s)) for s in stmts) == 1
    for form_name, la_type in (("bwd_update", "LogAddBranch"),
                               ("bwd_update_sel", "LogAddSel")):
        call = " ".join(_method("Sm4", form_name))
        assert f"bwd_update_with<{la_type}>(t," in call, form_name
    t, draw = _update_grid(11)
    e_gapx_p, eg1, em2p = draw(), draw(), draw()
    n1a, n1p, n2p = ([draw() for _ in range(4)] for _ in range(3))
    la = fk.log_add if form == "branch" else _log_add_sel_torch
    out = [None] * 4
    env = dict(t=t, e_gapx_p=e_gapx_p, eg1=eg1, em2p=[em2p], n1a=n1a,
               n1p=n1p, n2p=n2p, out=out, LA=la, LA3=_la3(la),
               **{k: getattr(fk, k) for k in dir(fk)
                  if k.startswith("T4_")})
    _run_statements(stmts, env)
    xfp = torch.zeros((9, e_gapx_p.numel()))
    xfp[fk.Sm4Spec.GAP_X] = e_gapx_p
    want = fk.Sm4Spec.bwd_update_w(t, None, xfp, eg1, em2p, n1a, n1p, n2p)
    _bits_equal(out, want)
    assert all(bool((g == np.float32(fk.NEG)).any()) for g in out)
    d = (out[0] - out[1]).abs()
    assert ((d > 0.0) & (d < 7.5)).sum() > 1000


def _vanilla_row_at_next():
    """Vanilla::row_at_next, transcribed: the x rows sm3_bwd_tiled_sel
    loads at next_col(x) (the template's load asserted too)."""
    body = " ".join(_method("Vanilla", "row_at_next"))
    m = re.fullmatch(r"return i >= (\w+) && i <= (\w+)", body)
    assert m, body
    lo, hi = (getattr(fk.VanillaSpec, v) for v in m.groups())
    assert re.search(r"in\[YR \+ i\] = xb\[i \* X \+ \(row_at_next<Spec>"
                     r"\(i\) \? xp : x\)\]", WAVEFRONT)
    return lambda i: lo <= i <= hi


@pytest.mark.parametrize("form", ["branch", "sel"])
def test_vanilla_bwd_update_with_equals_plain(form):
    """Vanilla::bwd_update_with, transcribed, equals
    fb_kernels.VanillaSpec.bwd_update_w bit for bit with either log-add
    (bwd_update, the older sm3_bwd_kernel's: the branch log_add;
    bwd_update_sel, K2, K3 and K6b vanilla: log_add_sel): the transitions
    into M and X read at x + 1
    (rows 8-11, row_at_next), M -> Y at x; NEG sources and cubic-boundary
    gaps included."""
    stmts = _method("Vanilla", "bwd_update_with")
    assert sum(len(re.findall(r"LA::add\(", s)) for s in stmts) == 2
    assert sum(len(re.findall(r"LA::add3\(", s)) for s in stmts) == 1
    branch = " ".join(_method("Vanilla", "bwd_update"))
    assert ("bwd_update_with<LogAddBranch>( t, [&](int i) { return "
            "xb[i * X + (row_at_next(i) ? xp : x)]") in re.sub(
                r"\s+", " ", branch)
    sel = " ".join(_method("Vanilla", "bwd_update_sel"))
    assert "bwd_update_with<LogAddSel>(t, [&](int i) { return xr[i]" in sel
    at_next = _vanilla_row_at_next()
    t, draw = _update_grid(2)
    eg1, em2p = draw(), draw()
    n1a, n1p, n2p = ([draw() for _ in range(3)] for _ in range(3))
    n = eg1.numel()
    xf, xfp = torch.zeros((13, n)), torch.zeros((13, n))
    for i in range(8, 13):
        (xfp if at_next(i) else xf)[i] = draw()
    la = fk.log_add if form == "branch" else _log_add_sel_torch
    out = [None] * 3
    env = dict(t=t, eg1=eg1, em2p=[em2p], n1a=n1a, n1p=n1p, n2p=n2p,
               out=out, LA=la, LA3=_la3(la),
               row=lambda i: (xfp if at_next(i) else xf)[i],
               VA_YM=fk.VA_YM, VA_YY=fk.VA_YY,
               **{k: getattr(fk.VanillaSpec, k)
                  for k in ("LA_MX", "LA_XX", "LA_MM", "LA_XM", "LA_MY")})
    _run_statements(stmts, env)
    want = fk.VanillaSpec.bwd_update_w(t, xf, xfp, eg1, em2p, n1a, n1p, n2p)
    _bits_equal(out, want)
    assert all(bool((g == np.float32(fk.NEG)).any()) for g in out)
    assert [i for i in range(13) if at_next(i)] == [8, 9, 10, 11]


def _cubic_ranges_reached(d):
    """Each cubic of the log-add and its cutoff holds over 100 of the gaps
    ``d``."""
    for lo_, hi_ in ((0, 1.0), (1.0, 2.5), (2.5, 4.5), (4.5, 7.5),
                     (7.5, 1e38)):
        assert ((d > lo_) & (d <= hi_)).sum() > 100


@pytest.mark.parametrize("form", ["branch", "sel"])
def test_sm4_fwd_update_with_equals_plain(form):
    """Sm4::fwd_update_with, transcribed, equals
    fb_kernels.Sm4Spec.fwd_update_w bit for bit with either log-add
    (fwd_update, K1 sm4: the branch log_add; fwd_update_sel, K6a sm4 on
    sm3_fwd_tiled_sel: log_add_sel), the JAX grouping of M's four sources
    kept; NEG sources, NEG emissions and cubic-boundary gaps included."""
    stmts = _method("Sm4", "fwd_update_with")
    assert sum(len(re.findall(r"LA::add\(", s)) for s in stmts) == 5
    assert sum(len(re.findall(r"LA::add3\(", s)) for s in stmts) == 1
    branch = re.sub(r"\s+", " ", " ".join(_method("Sm4", "fwd_update")))
    assert ("fwd_update_with<LogAddBranch>(t, p1m, p1a, p2m, e, "
            "xb[GAP_X * X + x], out)") in branch
    sel = " ".join(_method("Sm4", "fwd_update_sel"))
    assert ("fwd_update_with<LogAddSel>(t, p1m, p1a, p2m, e, e_gapx, out)"
            in sel)
    t, draw = _update_grid(11)
    p1m, p1a, p2m = ([draw() for _ in range(4)] for _ in range(3))
    e_match, e_gapy, e_gapx = draw(), draw(), draw()
    la = fk.log_add if form == "branch" else _log_add_sel_torch
    out = [None] * 4
    env = dict(t=t, p1m=p1m, p1a=p1a, p2m=p2m, e_gapx=e_gapx, out=out,
               LA=la, LA3=_la3(la),
               e=type("E", (), dict(match=e_match, gap_y=e_gapy))(),
               **{k: getattr(fk, k) for k in dir(fk)
                  if k.startswith("T4_")})
    _run_statements(stmts, env)
    xf = torch.zeros((9, e_gapx.numel()))
    xf[fk.Sm4Spec.GAP_X] = e_gapx
    want = fk.Sm4Spec.fwd_update_w(t, xf, e_match, e_gapy, p1m, p1a, p2m)
    _bits_equal(out, want)
    assert all(bool((g == np.float32(fk.NEG)).any()) for g in out)
    # M's inner pairs reach every cubic and the cutoff
    _cubic_ranges_reached(
        (p2m[0] + t[fk.T4_MM] - p2m[1] - t[fk.T4_MSX]).abs())


@pytest.mark.parametrize("form", ["branch", "sel"])
def test_vanilla_fwd_update_with_equals_plain(form):
    """Vanilla::fwd_update_with, transcribed, equals
    fb_kernels.VanillaSpec.fwd_update_w bit for bit with either log-add
    (fwd_update, K1 vanilla: the branch log_add; fwd_update_sel, K6a
    vanilla on sm3_fwd_tiled_sel: log_add_sel): every transition row read
    at x (the branch form from xb at x, the select form from the x rows
    the template loads at x, handed over whole by tiled_fwd_update); NEG
    sources, NEG emissions and cubic-boundary gaps included."""
    stmts = _method("Vanilla", "fwd_update_with")
    assert sum(len(re.findall(r"LA::add\(", s)) for s in stmts) == 2
    assert sum(len(re.findall(r"LA::add3\(", s)) for s in stmts) == 1
    branch = re.sub(r"\s+", " ", " ".join(_method("Vanilla", "fwd_update")))
    assert ("fwd_update_with<LogAddBranch>( t, [&](int i) { return "
            "xb[i * X + x] }, p1m, p1a, p2m, e, out)") in branch
    sel = re.sub(r"\s+", " ", " ".join(_method("Vanilla", "fwd_update_sel")))
    assert "fwd_update_with<LogAddSel>(t, [&](int i) { return xr[i]" in sel
    fwd = WAVEFRONT[WAVEFRONT.index("void sm3_fwd_tiled_sel("):]
    assert "in[YR + i] = xb[i * X + x];" in fwd[:fwd.index("\n}\n")]
    assert re.search(r"if constexpr \(Spec::COL_TRANS\) \{\s*"
                     r"Spec::fwd_update_sel\(t, p1m, p1a, p2m, e, "
                     r"in \+ Spec::YR, out\);", WAVEFRONT)
    t, draw = _update_grid(2)
    p1m, p1a, p2m = ([draw() for _ in range(3)] for _ in range(3))
    e_match, e_gapy = draw(), draw()
    n = e_match.numel()
    xf = torch.zeros((13, n))
    for i in range(8, 13):
        xf[i] = draw()
    la = fk.log_add if form == "branch" else _log_add_sel_torch
    out = [None] * 3
    env = dict(t=t, p1m=p1m, p1a=p1a, p2m=p2m, out=out, LA=la,
               LA3=_la3(la), row=lambda i: xf[i],
               e=type("E", (), dict(match=e_match, gap_y=e_gapy))(),
               VA_YM=fk.VA_YM, VA_YY=fk.VA_YY,
               **{k: getattr(fk.VanillaSpec, k)
                  for k in ("LA_MX", "LA_XX", "LA_MM", "LA_XM", "LA_MY")})
    _run_statements(stmts, env)
    want = fk.VanillaSpec.fwd_update_w(t, xf, e_match, e_gapy, p1m, p1a,
                                       p2m)
    _bits_equal(out, want)
    assert all(bool((g == np.float32(fk.NEG)).any()) for g in out)
    _cubic_ranges_reached((p1m[0] + xf[fk.VanillaSpec.LA_MX]
                           - p1m[1] - xf[fk.VanillaSpec.LA_XX]).abs())


def _inv_gauss_sel_torch(x, mu, lam, loglam, logx):
    """inv_gauss_sel, transcribed from the header: its constant, guard and
    expression read from the source."""
    m = re.search(r"float inv_gauss_sel\(float x, float mu, float lam,\s*"
                  r"float loglam, float logx\) \{\n(.*?)\n\}", HEADER, re.S)
    body = re.sub(r"\s+", " ", m.group(1))
    assert "const float a = (x - mu) / mu;" in body
    c = re.search(r"const float v = \(loglam - " + LITERAL
                  + r"f - 3\.0f \* logx - lam \* a \* a / x\) / 2\.0f;",
                  body).group(1)
    assert ("return (x <= 0.0f || lam <= 0.0f || mu == 0.0f) ? CPECAN_NEG "
            ": v;") in body
    # the plain version's constant, the same decimals
    assert c in inspect.getsource(fk.inv_gauss)
    a = (x - mu) / mu
    v = (loglam - float(c) - 3.0 * logx - lam * a * a / x) / 2.0
    bad = (x <= 0.0) | (lam <= 0.0) | (mu == 0.0)
    return torch.where(bad, torch.full_like(v, fk.NEG), v)


def _inv_gauss_grid():
    """(x, mu, lam) f32: x <= 0 (0, -0, negatives), lam <= 0, mu == 0 (0,
    -0), tiny and huge values, and ordinary noise values near their
    means."""
    rng = np.random.default_rng(14)
    n = 3000
    x = rng.uniform(0.2, 4.0, n)
    mu = x * rng.uniform(0.5, 1.5, n)
    lam = rng.uniform(0.5, 80.0, n)
    specials = [0.0, -0.0, -1.0, -1e-30, 1e-30, 1e-20, 1e20]
    k = len(specials)
    x[:k], mu[k:2 * k], lam[2 * k:3 * k] = specials, specials, specials
    x, mu, lam = (torch.from_numpy(v.astype(np.float32))
                  for v in (x, mu, lam))
    return x, mu, lam


def test_inv_gauss_sel_equals_plain_inv_gauss_bit_for_bit():
    """inv_gauss_sel with loglam = log(lam) and logx = log(x) equals
    fb_kernels.inv_gauss bit for bit, NEG where x <= 0, lam <= 0 or mu ==
    0 (the discarded arithmetic's NaN and inf never leak)."""
    x, mu, lam = _inv_gauss_grid()
    got = _inv_gauss_sel_torch(x, mu, lam, torch.log(lam), torch.log(x))
    want = fk.inv_gauss(x, mu, lam)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    bad = (x <= 0) | (lam <= 0) | (mu == 0)
    assert bool((got[bad] == np.float32(fk.NEG)).all())
    assert int((x <= 0).sum()) >= 4 and int((lam <= 0).sum()) >= 4
    assert int((mu == 0).sum()) == 2
    # past the special values every input is an ordinary noise value
    assert torch.isfinite(got[21:]).all() and bool((~bad).sum() > 2900)


def test_vanilla_emissions_in_equals_plain():
    """Vanilla::emissions_in (emissions_with over gauss_sel and
    inv_gauss_sel, the sd and lambda rows' logs from col_logs, the noise's
    log taken once a cell), transcribed, equals
    fb_kernels.VanillaSpec.emissions bit for bit, sd <= 0, lambda <= 0, a
    zero noise mean and noise <= 0 included."""
    gx, gmu, gsd = _gauss_grid()
    n = gx.numel()
    ix, imu, ilam = (v[torch.from_numpy(np.random.default_rng(15).integers(
        0, v.numel(), n))] for v in _inv_gauss_grid())
    rng = np.random.default_rng(16)
    rows = torch.zeros((13, n))
    rows[0], rows[4] = gmu, gmu.flip(0)
    rows[1], rows[5] = gsd, gsd.roll(7)
    rows[2], rows[6] = imu, imu.roll(11)
    rows[3], rows[7] = ilam, ilam.flip(0)
    rows[8:] = torch.from_numpy(rng.uniform(-5.0, 0.0, (5, n)).astype(
        np.float32))
    mean, noise = gx, ix
    # col_logs (SignalRows): the logs of rows 1, 3, 5, 7
    assert "lsd[k] = logf(in[YR + 2 * k + 1])" in " ".join(
        _method("SignalRows", "col_logs"))
    lsd = [torch.log(rows[2 * k + 1]) for k in range(4)]
    body = re.sub(r"\s+", " ", " ".join(_method("Vanilla", "emissions_in")))
    assert "lnoise = logf(in[1])" in body
    assert "emissions_with( in[0], in[1]," in body
    assert "gauss_sel(v, in[YR + i], in[YR + i + 1], lsd[i / 2])" in body
    assert ("inv_gauss_sel(v, in[YR + i], in[YR + i + 1], lsd[i / 2], "
            "lnoise)") in body
    lnoise = torch.log(noise)
    env = dict(mean=mean, noise=noise, e=type("E", (), {})(),
               g=lambda v, i: _gauss_sel_torch(v, rows[i], rows[i + 1],
                                               lsd[i // 2]),
               ig=lambda v, i: _inv_gauss_sel_torch(v, rows[i], rows[i + 1],
                                                    lsd[i // 2], lnoise))
    _run_statements([s for s in _method("Vanilla", "emissions_with")
                     if not s.startswith("return")], env)
    e_match, e_gapy = fk.VanillaSpec.emissions(rows, mean, noise)
    _bits_equal((env["e"].match, env["e"].gap_y), (e_match, e_gapy))
    for e in (e_match, e_gapy):
        neg = e == np.float32(fk.NEG)
        assert bool(neg.any()) and int((~neg).sum()) > n // 2


# -- the echelon machine's select updates (wavefront.cu
# Echelon::fwd_update_sel and bwd_update_sel, K1/K2 echelon on the select
# templates), transcribed and held to fb_kernels ----------------------------


def _echelon_rows(name):
    """The x rows ``Echelon::name`` names (fwd_row, bwd_row, row_at_next),
    transcribed."""
    body = " ".join(_method("Echelon", name))
    m = (re.fullmatch(r"return i >= (\w+) && i <= (\w+)", body)
         or re.fullmatch(r"return i == (\w+)", body))
    assert m, body
    lo, hi = (getattr(fk, v) for v in (m.groups() * 2)[:2])
    return [i for i in range(fk.EchelonSpec.NXF) if lo <= i <= hi]


def _echelon_env(draw, rows):
    """x rows [NXF, n]: the named ``rows`` drawn (log transitions), every
    other row NaN, so that a row the update reads without loading it
    shows."""
    n = draw().numel()
    xr = torch.full((fk.EchelonSpec.NXF, n), float("nan"))
    for i in rows:
        xr[i] = draw()
    return xr


def _sel_env(**kw):
    return dict(kw, log_add_sel=_log_add_sel_torch,
                log_add3_sel=_la3(_log_add_sel_torch),
                **{k: getattr(fk, k) for k in ("EC_LA_MX", "EC_LA_MH",
                                               "EC_LA_XX", "EC_LA_XH")})


def test_echelon_fwd_update_sel_equals_plain():
    """Echelon::fwd_update_sel (15 log_add_sel in _EchelonSpec's grouping),
    transcribed, equals fb_kernels.EchelonSpec.fwd_update_w bit for bit on
    the x rows the forward template loads (fwd_row: the four skip logs at
    x; every other row NaN), NEG sources, NEG emissions and
    cubic-boundary gaps included."""
    stmts = _method("Echelon", "fwd_update_sel")
    assert sum(len(re.findall(r"log_add_sel\(", s)) for s in stmts) == 15
    assert not any("log_add(" in s or "log_add3(" in s for s in stmts)
    fwd = WAVEFRONT[WAVEFRONT.index("void sm3_fwd_tiled_sel("):]
    fwd = fwd[:fwd.index("\n}\n")]
    assert "if (Spec::fwd_row(i)) in[YR + i] = xb[i * X + x];" in fwd
    assert re.search(r"Spec::fwd_update_sel\(p1m, p1a, p2m,\s*"
                     r"plane_emissions<Spec>\(es \+ rs \* NL \* W, l,\s*"
                     r"W\),\s*in \+ YR, nv\);", fwd)
    rows = _echelon_rows("fwd_row")
    assert rows == [24, 25, 26, 27]
    _, draw = _update_grid(1)
    p1m, p1a, p2m = ([draw() for _ in range(7)] for _ in range(3))
    e_match = tuple(draw() for _ in range(5))
    e_gapy = draw()
    xr = _echelon_env(draw, rows)
    out = [None] * 7
    env = _sel_env(p1m=p1m, p1a=p1a, p2m=p2m, xr=xr, out=out,
                   e=type("E", (), dict(match=list(e_match),
                                        gap_y=e_gapy))())
    _run_statements(stmts, env)
    want = fk.EchelonSpec.fwd_update_w(None, xr, e_match, e_gapy, p1m, p1a,
                                       p2m)
    _bits_equal(out, want)
    assert all(bool((g == np.float32(fk.NEG)).any()) for g in out)
    assert all(bool(torch.isfinite(g).all()) for g in out)
    _cubic_ranges_reached((p2m[0] - p2m[1]).abs())


def test_echelon_bwd_update_sel_equals_plain():
    """Echelon::bwd_update_sel (seven log_add_sel in _EchelonSpec's
    grouping), transcribed, equals fb_kernels.EchelonSpec.bwd_update_w bit
    for bit on the x rows the backward template loads (row_at_next: the
    four skip logs at next_col(x); bwd_row: la_mh at x; every other row
    NaN), NEG sources and cubic-boundary gaps included."""
    stmts = _method("Echelon", "bwd_update_sel")
    assert sum(len(re.findall(r"log_add_sel\(", s)) for s in stmts) == 5
    assert sum(len(re.findall(r"log_add3_sel\(", s)) for s in stmts) == 1
    bwd = WAVEFRONT[WAVEFRONT.index("void sm3_bwd_tiled_sel("):]
    bwd = bwd[:bwd.index("\n}\n")]
    assert "if (Spec::bwd_row(i)) in[YR + i] = xb[i * X + x];" in bwd
    assert "if (Spec::row_at_next(i)) inp[i] = xb[i * X + xp];" in bwd
    assert re.search(r"Spec::bwd_update_sel\(in \+ YR, inp,\s*"
                     r"ps\[\(es \* Spec::EM_PLANE \+ NEM\) \* W \+ l\],"
                     r"\s*em2p, n1a, n1p, n2p, bw\);", bwd)
    at_x, at_next = _echelon_rows("bwd_row"), _echelon_rows("row_at_next")
    assert at_x == [25] and at_next == [24, 25, 26, 27]
    _, draw = _update_grid(1)
    eg1 = draw()
    em2p = [draw() for _ in range(5)]
    n1a, n1p, n2p = ([draw() for _ in range(7)] for _ in range(3))
    xr, xrp = _echelon_env(draw, at_x), _echelon_env(draw, at_next)
    out = [None] * 7
    env = _sel_env(xr=xr, xrp=xrp, eg1=eg1, em2p=em2p, n1a=n1a, n1p=n1p,
                   n2p=n2p, out=out)
    _run_statements(stmts, env)
    want = fk.EchelonSpec.bwd_update_w(None, xr, xrp, eg1, em2p, n1a, n1p,
                                       n2p)
    _bits_equal(out, want)
    assert all(bool((g == np.float32(fk.NEG)).any()) for g in out)
    assert all(bool(torch.isfinite(g).all()) for g in out)
    _cubic_ranges_reached((em2p[0] + n2p[1] - em2p[1] - n2p[2]).abs())
