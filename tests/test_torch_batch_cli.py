"""The port's posterior tsv writer and its batch signalAlign CLI
(``cpecan-torch-signal-align-batch``) against the JAX package's:
``write_posterior_probs`` byte for byte through the native and the Python
formatter, and the CLI's reference conversion, read choice, target
regions and refusals, with the JAX CLI's ``run_batch_fast`` call captured
(so that neither runs a kernel), then one CLI run end to end on the CPU.
"""

import io

import numpy as np
import pytest

import cpecan_tpu.cli.signal_align as j_sa
import cpecan_tpu.pipeline.signal_align_batch as j_sab
from cpecan_tpu.cli.batch import signal_align_batch_main as j_main

import cpecan_tpu_torch.cli.signal_align as t_sa
import cpecan_tpu_torch.pipeline.signal_align_batch as t_sab
from cpecan_tpu_torch.cli.batch import signal_align_batch_main as t_main
from cpecan_tpu_torch.constants import COMPLEMENT, TEMPLATE
from cpecan_tpu_torch.fixtures import fixture_path
from cpecan_tpu_torch.io.npread import load_npread
from cpecan_tpu_torch.io.poremodel import load_pore_model, scale_model
from tests.torch_batch_reads import make_reads, stored_guide


def _writer_inputs(strand, seed):
    """The Zymo read's strand, a guide-region target and random pairs
    (score, x, y) inside it."""
    npr = load_npread(fixture_path("ZymoC_ch_1_file1.npRead"))
    ref = open(fixture_path("ZymoRef.txt")).read().splitlines()[0]
    target = ref[3:887]
    events, npp = ((npr.template_events, npr.template_params)
                   if strand == TEMPLATE else
                   (npr.complement_events, npr.complement_params))
    model = scale_model(load_pore_model(fixture_path(
        "template_median68pA.model")), npp.scale, npp.shift, npp.var,
        npp.scale_sd, npp.var_sd).match_model
    rng = np.random.default_rng(seed)
    n = 600
    pairs = np.stack([rng.integers(100_000, 10_000_000, n),
                      np.sort(rng.integers(0, len(target) - 5, n)),
                      np.sort(rng.integers(0, len(events) - 20, n))],
                     axis=1)
    return dict(read_label="ZymoC_ch_1_file1", match_model=model,
                scale=npp.scale, shift=npp.shift, events=events,
                target=target, contig="ref", event_offset=11,
                ref_offset=3 if strand == TEMPLATE else 887,
                aligned_pairs=pairs, strand=strand)


@pytest.mark.parametrize("formatter", ["native", "python"])
@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("strand", [TEMPLATE, COMPLEMENT], ids=["t", "c"])
def test_write_posterior_probs_matches_jax(monkeypatch, formatter, forward,
                                           strand):
    """The 15-column text equals the JAX writer's, byte for byte."""
    kw = _writer_inputs(strand, seed=3 + strand + 2 * forward)
    if formatter == "python":
        monkeypatch.setattr(t_sa, "_native_tsv", lambda: None)
        assert t_sa.tsv_formatter().startswith("python")
    else:
        assert t_sa.tsv_formatter().startswith("native")
    got, want = io.StringIO(), io.StringIO()
    t_sa.write_posterior_probs(got, forward=forward, **kw)
    j_sa.write_posterior_probs(want, forward=forward, **kw)
    lines = got.getvalue().splitlines()
    assert len(lines) == 600 and all(len(r.split("\t")) == 15
                                     for r in lines)
    assert got.getvalue() == want.getvalue()


@pytest.fixture
def capture(monkeypatch):
    """Both packages' run_batch_fast replaced by a recorder of its
    reference text, its (npRead name, guide) pairs and its keywords."""
    calls = {}

    def recorder(name):
        def fake(ref_path, pairs, out_dir, **kw):
            calls[name] = dict(ref=open(ref_path).read(), kw=kw, pairs=[
                (p.split("/")[-1], g) for p, g in pairs])
            return [("r", True, "")]
        return fake

    monkeypatch.setattr(j_sab, "run_batch_fast", recorder("jax"))
    monkeypatch.setattr(t_sab, "run_batch_fast", recorder("port"))
    return calls


@pytest.fixture
def read_dir(tmp_path):
    """Five reads with guides keyed by read name; a fasta reference."""
    pairs = make_reads(tmp_path / "reads", [100, 120, 140, 160, 180])
    (tmp_path / "guides.cig").write_text(
        "\n".join(g for _, g in pairs) + "\n")
    ref = open(fixture_path("ZymoRef.txt")).read().splitlines()[0]
    (tmp_path / "ref.fa").write_text(">ZymoRef\n" + ref + "\n")
    return tmp_path


def _argv(d, out, *extra):
    return ["-d", str(d / "reads"), "-r", str(d / "ref.fa"), "-o",
            str(d / out), "--guides", str(d / "guides.cig"), *extra]


@pytest.mark.parametrize("extra", [
    ("-smt", "threeState"),
    ("-smt", "vanilla", "-n", "3", "-t", "0.05"),
    ("-smt", "threeState", "-q", "regions")], ids=["all", "nb_files",
                                                  "target_regions"])
def test_cli_hands_the_pipeline_what_the_jax_cli_does(capture, read_dir,
                                                      extra):
    """The bare reference converted from the fasta, the same reads (the
    seeded shuffle-then-slice of --nb_files, the --target_regions filter)
    in the same order, the same machine and threshold."""
    ends = [int(g.split()[7]) for g in
            (read_dir / "guides.cig").read_text().splitlines()]
    if "regions" in extra:
        # only the guides that contain [3, the third read's end] pass (the
        # second interval holds no guide; the first is given end first)
        (read_dir / "regions").write_text(f"{ends[2]}\t3\n900\t5000\n")
        extra = extra[:-1] + (str(read_dir / "regions"),)
    assert j_main(_argv(read_dir, "j", "--engine", "pallas", *extra)) == 0
    assert t_main(_argv(read_dir, "t", "--device", "cpu", *extra)) == 0
    j, t = capture["jax"], capture["port"]
    ref = open(fixture_path("ZymoRef.txt")).read().splitlines()[0]
    assert t["ref"] == j["ref"] == ref + "\n"
    assert t["pairs"] == j["pairs"]
    if "-q" in extra:
        want = [f"read{i}.npRead" for i, e in enumerate(ends)
                if e >= ends[2]]
        assert [p for p, _ in t["pairs"]] == want and 0 < len(want) < 5
    else:
        assert len(t["pairs"]) == (3 if "-n" in extra else 5)
    for key in ("sm_type", "threshold", "template_model_file",
                "complement_model_file"):
        assert t["kw"][key] == j["kw"][key]
    assert t["kw"]["device"] == "cpu"


def test_cli_refusals(capture, read_dir, capsys):
    """fourState on the wavefront engine (as the JAX CLI refuses it), the
    scan engine, -ub and .fast5 inputs; nothing reaches the pipeline."""
    for main in (j_main, t_main):
        with pytest.raises(SystemExit):
            main(_argv(read_dir, "o", "--engine", "pallas", "-smt",
                       "fourState"))
    assert "requires -smt threeState or vanilla" in capsys.readouterr().err
    with pytest.raises(NotImplementedError, match="item 7"):
        t_main(_argv(read_dir, "o", "--engine", "scan"))
    with pytest.raises(SystemExit):
        t_main(_argv(read_dir, "o", "-ub"))
    assert "un-banded" in capsys.readouterr().err
    (read_dir / "reads" / "x.fast5").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="item 8b"):
        t_main(_argv(read_dir, "o"))
    assert not capture


def test_cli_runs_end_to_end_on_the_cpu(read_dir, capsys):
    """cpecan-torch-signal-align-batch -smt threeState on two reads: their
    tsvs, the formatter named once in the log, the summary line."""
    for p in sorted((read_dir / "reads").iterdir())[2:]:
        p.unlink()
    assert t_main(_argv(read_dir, "out", "--device", "cpu", "-smt",
                        "threeState")) == 0
    err = capsys.readouterr().err
    assert err.count("tsv formatter: native") == 1
    assert "aligned 2/2 reads" in err
    for i in range(2):
        rows = (read_dir / "out" / f"read{i}.tsv").read_text().splitlines()
        assert {r.split("\t")[4] for r in rows} == {"t", "c"}
        assert all(r.split("\t")[3] == f"read{i}" for r in rows)
    assert stored_guide().startswith("cigar: read2d")
