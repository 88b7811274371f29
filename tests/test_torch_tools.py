"""The port's host tools against the JAX package's, on seeded inputs, byte
for byte: call_freq, combine_freq, combine_strands, evaluate (with its
roc_auc), the dataset tools, the runner and the log plots."""

import gzip
import itertools
import os
import random
import sys

import numpy as np
import pytest
import torch

import deepsignal_tpu.runtime.caller as jax_caller
from deepsignal_tpu.tools import combine as jax_combine
from deepsignal_tpu.tools import dataset as jax_dataset
from deepsignal_tpu.tools import evaluate as jax_evaluate
from deepsignal_tpu.tools import frequency as jax_frequency
from deepsignal_tpu.tools import runner as jax_runner
from deepsignal_tpu.tools import vis as jax_vis
from deepsignal_tpu_torch.io.feature_codec import format_feature_row
from deepsignal_tpu_torch.runtime import caller
from deepsignal_tpu_torch.tools import (combine, dataset, evaluate, frequency,
                                        runner, vis)
from deepsignal_tpu_torch.train.checkpoints import (save_checkpoint,
                                                    state_dict_to_variables)
from tests import torch_tiny

torch.set_num_threads(1)

PROB_TOL = 1e-5  # float32 calls, sums in another order (test_torch_caller)
GENOME_LEN = 600


def _genome(rng) -> str:
    return "".join(np.array(list("ACGT"))[rng.integers(0, 4, GENOME_LEN)])


def _cg_sites(seq: str) -> list:
    return [i for i in range(len(seq) - 1) if seq[i:i + 2] == "CG"]


def _call_rows(rng, n: int, genome: dict, off_motif: int = 0) -> list:
    """``n`` call rows on the CG sites of ``genome``'s contigs, both
    strands ('-' rows at the G: pos + 1), float32 probabilities printed as
    the caller prints them, and ``off_motif`` rows at positions that are no
    CG site."""
    rows = []
    contigs = sorted(genome)
    for i in range(n + off_motif):
        chrom = contigs[rng.integers(0, len(contigs))]
        seq = genome[chrom]
        sites = _cg_sites(seq)
        strand = "+-"[int(rng.integers(0, 2))]
        if i < n:
            pos = sites[rng.integers(0, len(sites))] + (strand == "-")
        else:
            pos = next(p for p in rng.integers(2, len(seq) - 2, 50)
                       if seq[p - 1:p + 2].find("CG") == -1)
        p1 = np.float32(rng.uniform(0, 1))
        p0 = np.float32(1) - p1
        rows.append("\t".join([
            chrom, str(pos), strand,
            str(pos if strand == "+" else len(seq) - 1 - pos),
            f"read{int(rng.integers(0, 30))}", "t", str(p0), str(p1),
            str(int(p1 > p0)),
            "".join(np.array(list("ACGT"))[rng.integers(0, 4, 17)])]))
    return rows


@pytest.fixture(scope="module")
def calls(tmp_path_factory):
    """A reference genome of two contigs, three call files, one of them
    gzip-compressed, and a directory holding two of them beside a file
    that ``file_uid`` excludes."""
    d = tmp_path_factory.mktemp("calls")
    rng = np.random.default_rng(70)
    genome = {"chr1": _genome(rng), "chr2": _genome(rng)}
    with open(d / "ref.fa", "w") as f:
        for name, seq in genome.items():
            f.write(f">{name} test contig\n")
            f.write("\n".join(seq[i:i + 60] for i in range(0, len(seq), 60))
                    + "\n")
    paths = []
    for k in range(3):
        rows = _call_rows(rng, 300, genome)
        path = d / "in" / f"part{k}.calls.tsv"
        path.parent.mkdir(exist_ok=True)
        path.write_text("\n".join(rows) + "\n")
        paths.append(str(path))
    gz = d / "part2.calls.tsv.gz"
    with gzip.open(gz, "wt") as f:
        f.write(open(paths[2]).read())
    (d / "in" / "notes.txt").write_text("\t".join(["x"] * 10) + "\n")
    off = d / "off_motif.calls.tsv"
    off.write_text("\n".join(_call_rows(rng, 200, genome, off_motif=20))
                   + "\n")
    return {"dir": d, "ref": str(d / "ref.fa"), "files": paths,
            "gz": str(gz), "in_dir": str(d / "in"), "off": str(off),
            "genome": genome}


def _same_output(tmp_path, port_fn, jax_fn, name="out.tsv"):
    port, want = tmp_path / f"port.{name}", tmp_path / f"jax.{name}"
    port_ret = port_fn(str(port))
    jax_ret = jax_fn(str(want))
    assert port.read_bytes() == want.read_bytes()
    assert port.stat().st_size > 0
    return port_ret, jax_ret


@pytest.mark.parametrize("is_bed,is_sort,prob_cf",
                         list(itertools.product([False, True], [False, True],
                                                [0.0, 0.2])))
def test_call_freq_matches_jax(calls, tmp_path, is_bed, is_sort, prob_cf):
    files = calls["files"][:2] + [calls["gz"]]
    port, want = _same_output(
        tmp_path,
        lambda out: frequency.call_mods_frequency_to_file(
            files, out, prob_cf=prob_cf, is_sort=is_sort, is_bed=is_bed),
        lambda out: jax_frequency.call_mods_frequency_to_file(
            files, out, prob_cf=prob_cf, is_sort=is_sort, is_bed=is_bed))
    kept = sum(abs(float(r.split("\t")[6]) - float(r.split("\t")[7]))
               >= prob_cf for f in calls["files"]
               for r in open(f).read().splitlines())
    assert sum(s.coverage for s in port.values()) == kept
    assert {k: vars(s) for k, s in port.items()} == \
        {k: vars(s) for k, s in want.items()}


def test_call_freq_of_a_directory_matches_jax(calls, tmp_path):
    """A directory in ``os.listdir`` order, with and without ``file_uid``
    (without it the directory's other file must be refused as a call row
    by both)."""
    _same_output(
        tmp_path,
        lambda out: frequency.call_mods_frequency_to_file(
            [calls["in_dir"]], out, file_uid=".calls."),
        lambda out: jax_frequency.call_mods_frequency_to_file(
            [calls["in_dir"]], out, file_uid=".calls."))
    assert frequency.collect_mods_files([calls["in_dir"]], ".calls.") == \
        jax_frequency.collect_mods_files([calls["in_dir"]], ".calls.")
    for fn in (frequency.call_mods_frequency_to_file,
               jax_frequency.call_mods_frequency_to_file):
        with pytest.raises(ValueError):
            fn([calls["in_dir"]], str(tmp_path / "x.tsv"))
        with pytest.raises(ValueError, match="neither a file"):
            fn([str(tmp_path / "missing")], str(tmp_path / "x.tsv"))


def test_combine_freq_matches_jax(calls, tmp_path):
    freqs = []
    for i, f in enumerate(calls["files"]):
        freqs.append(str(tmp_path / f"f{i}.tsv"))
        frequency.call_mods_frequency_to_file([f], freqs[-1])
    port, want = _same_output(
        tmp_path, lambda out: frequency.combine_freq_files(freqs, out),
        lambda out: jax_frequency.combine_freq_files(freqs, out))
    assert port == want


@pytest.mark.parametrize("is_bed", [False, True])
def test_combine_strands_matches_jax(calls, tmp_path, is_bed, capsys):
    ext = ".bed" if is_bed else ".tsv"
    freq = str(tmp_path / f"freq{ext}")
    frequency.call_mods_frequency_to_file([calls["off"]], freq,
                                          is_bed=is_bed)
    outs = {}
    for name, mod in (("port", combine), ("jax", jax_combine)):
        outs[name] = mod.combine_two_strands_frequency(
            freq, calls["ref"], out_fp=str(tmp_path / f"{name}{ext}"))
        printed = capsys.readouterr().out
        # the off-motif rows are reported, the others are not
        assert printed.count("not in selected motif poses") == 20
    port, want = (open(outs[k], "rb").read() for k in ("port", "jax"))
    assert port == want and port
    rows = [r.split("\t") for r in port.decode().splitlines()]
    cg = {(c, p) for c, s in calls["genome"].items() for p in _cg_sites(s)}
    assert {(r[0], int(r[1])) for r in rows} <= cg
    assert all(r[2 if not is_bed else 5] == "+" for r in rows)


def test_combine_strands_default_output_and_contig(calls, tmp_path):
    freq = tmp_path / "freq.tsv"
    frequency.call_mods_frequency_to_file(calls["files"][:1], str(freq))
    out = combine.combine_two_strands_frequency(str(freq), calls["ref"],
                                                contig="chr2")
    want = jax_combine.combine_two_strands_frequency(
        str(freq), calls["ref"], out_fp=str(tmp_path / "jax.tsv"),
        contig="chr2")
    assert out == str(tmp_path / "freq.fb_combined.tsv")
    assert open(out, "rb").read() == open(want, "rb").read()
    assert {r.split("\t")[0] for r in open(out)} == {"chr2"}


def test_combine_strands_bed_truncates_the_percentage(tmp_path):
    """bedMethyl's ``int(round(rate, 2) * 100)`` truncates: a rate of 0.29
    is written 28, by the JAX package and by the port."""
    (tmp_path / "ref.fa").write_text(">chrT\nAACGTTACGTT\n")
    # 29 of 100 on the + strand at 2; 1 of 2 on the - strand of 7 (pos 8)
    (tmp_path / "freq.bed").write_text(
        "chrT\t2\t3\t.\t100\t+\t2\t3\t0,0,0\t100\t29\n"
        "chrT\t8\t9\t.\t2\t-\t8\t9\t0,0,0\t2\t50\n")
    rows = {}
    for name, mod in (("port", combine), ("jax", jax_combine)):
        out = mod.combine_two_strands_frequency(
            str(tmp_path / "freq.bed"), str(tmp_path / "ref.fa"),
            out_fp=str(tmp_path / f"{name}.bed"))
        rows[name] = open(out).read()
    assert rows["port"] == rows["jax"] == (
        "chrT\t2\t3\t.\t100\t+\t2\t3\t0,0,0\t100\t28\n"
        "chrT\t7\t8\t.\t2\t+\t7\t8\t0,0,0\t2\t50\n")


@pytest.fixture(scope="module")
def truth_sets(tmp_path_factory, calls):
    """Call files of a methylated and an unmethylated truth set whose
    probabilities overlap, with tied probabilities and probabilities on
    the cut-offs of the sweep."""
    d = tmp_path_factory.mktemp("truth")
    rng = np.random.default_rng(71)
    paths = {}
    for name, shift in (("meth", 0.15), ("unmeth", -0.15)):
        rows = _call_rows(rng, 400, calls["genome"])
        out = []
        for i, r in enumerate(rows):
            w = r.split("\t")
            if i % 7 == 0:  # ties and values on the grid's cut-offs
                p1 = np.float32(0.5 + 0.025 * (i % 5) / 2)
            else:
                p1 = np.float32(np.clip(rng.normal(0.5 + shift, 0.2), 0, 1))
            w[6], w[7], w[8] = str(np.float32(1) - p1), str(p1), \
                str(int(p1 > 0.5))
            out.append("\t".join(w))
        paths[name] = d / f"{name}.tsv"
        paths[name].write_text("\n".join(out) + "\n")
    return str(paths["meth"]), str(paths["unmeth"])


@pytest.mark.parametrize("seed", [3, 19])
def test_evaluate_matches_jax(truth_sets, tmp_path, seed):
    meth, unmeth = truth_sets
    port = tmp_path / "port.txt"
    evaluate.evaluate_mods_call(meth, unmeth, str(port),
                                rng=random.Random(seed))
    random.seed(seed)
    jax_evaluate.evaluate_mods_call(meth, unmeth, str(tmp_path / "jax.txt"))
    jax_evaluate.evaluate_mods_call(meth, unmeth, str(tmp_path / "jax2.txt"),
                                    rng=random.Random(seed))
    text = port.read_bytes()
    assert text == (tmp_path / "jax.txt").read_bytes() == \
        (tmp_path / "jax2.txt").read_bytes()
    lines = text.decode().splitlines()
    assert len(lines) == 1 + len(evaluate.PROB_CFS) + 1
    assert [ln.split("\t")[1] for ln in lines[1:-1]] == \
        ["%.3f" % c for c in np.arange(0, 0.70, 0.025)]
    auc = float(lines[-1].split("\t")[14])
    assert 0.6 < auc < 1.0


def test_evaluate_cutoffs_are_float64_arange():
    """The cut-offs are np.arange's float64 values, not the decimals: at
    0.075 a |p1 - p0| of exactly 0.075 is not called."""
    assert evaluate.PROB_CFS.dtype == np.float64
    np.testing.assert_array_equal(evaluate.PROB_CFS, jax_evaluate.PROB_CFS)
    assert evaluate.PROB_CFS[3] > 0.075
    site = evaluate.CallRecord("chr1||5", 1, True, 0.0, 0.075)
    assert evaluate.evaluate_sites([site], evaluate.PROB_CFS[3]).split(
        "\t")[14] == "0"
    assert evaluate.evaluate_sites([site], 0.075).split("\t")[14] == "1"


def test_roc_auc_with_ties_matches_jax_and_pairs():
    rng = np.random.default_rng(72)
    y = rng.integers(0, 2, 300).astype(bool)
    s = np.round(rng.normal(y * 0.6, 1.0), 1)  # many ties
    pos, neg = s[y], s[~y]
    pairs = ((pos[:, None] > neg[None, :]).sum()
             + 0.5 * (pos[:, None] == neg[None, :]).sum()) / (len(pos)
                                                              * len(neg))
    got = evaluate.roc_auc(y, s)
    assert got == jax_evaluate.roc_auc(y, s)
    assert got == pytest.approx(pairs, abs=1e-12)
    with pytest.raises(ValueError, match="one class"):
        evaluate.roc_auc(np.ones(4, bool), np.arange(4.0))


# --------------------------------------------------------------------------
# dataset tools


@pytest.fixture(scope="module")
def features(tmp_path_factory):
    """120 feature rows at k-mer 5, labels mixed, in one file and split
    over a directory."""
    d = tmp_path_factory.mktemp("features")
    rng = np.random.default_rng(73)
    rows = []
    for i in range(120):
        rows.append(format_feature_row(
            f"chr{1 + i % 2}", 100 + 3 * i, "+-"[i % 2], 100 + 3 * i,
            f"read{i // 6}", "t",
            "".join(rng.choice(list("ACGT"), 5)), rng.normal(0, 1, 5),
            np.abs(rng.normal(0, 1, 5)), rng.integers(1, 50, 5),
            np.around(rng.normal(0, 1, 9), 6), int(rng.integers(0, 2))))
    path = d / "all.tsv"
    path.write_text("\n".join(rows) + "\n")
    (d / "dir").mkdir()
    for k in range(3):
        (d / "dir" / f"p{k}.tsv").write_text(
            "\n".join(rows[k::3]) + "\n")
    (d / "dir" / "skip.txt").write_text(rows[0] + "\n")
    pos = d / "pos.tsv"
    pos.write_text("".join(f"chr{1 + i % 2}\t{100 + 3 * i}\t+\n"
                           for i in range(0, 120, 5)))
    return {"file": str(path), "dir": str(d / "dir"), "pos": str(pos),
            "rows": rows}


@pytest.mark.parametrize("other,header,maxrows",
                         [(True, False, 50), (False, True, 30),
                          (True, False, 10**8)])
def test_random_select_file_rows_matches_jax(features, tmp_path, other,
                                             header, maxrows):
    outs = {}
    for name, fn in (("port", dataset.random_select_file_rows),
                     ("jax", jax_dataset.random_select_file_rows)):
        w = tmp_path / f"{name}.sel"
        o = tmp_path / f"{name}.other" if other else None
        n = fn(features["file"], str(w), str(o) if o else None, maxrows,
               header, rng=random.Random(5))
        outs[name] = (n, w.read_bytes(), o.read_bytes() if o else None)
    assert outs["port"] == outs["jax"]
    assert outs["port"][0] == min(maxrows, 120 - header)


def test_shuffle_big_file_matches_jax(features, tmp_path):
    got = dataset.shuffle_big_file(
        features["file"], str(tmp_path / "port.tsv"), num_lines_shuffle=17,
        temp_dir=str(tmp_path), rng=np.random.default_rng(9))
    want = jax_dataset.shuffle_big_file(
        features["file"], str(tmp_path / "jax.tsv"), num_lines_shuffle=17,
        temp_dir=str(tmp_path), seed=9)
    data = open(got, "rb").read()
    assert data == open(want, "rb").read()
    assert sorted(data.decode().splitlines()) == sorted(features["rows"])
    assert data.decode().splitlines() != features["rows"]
    assert sorted(os.listdir(tmp_path)) == ["jax.tsv", "port.tsv"]


def test_write_kmer_distribution_matches_jax(features, tmp_path):
    _same_output(
        tmp_path,
        lambda out: dataset.write_kmer_distribution(features["file"], out),
        lambda out: jax_dataset.write_kmer_distribution(features["file"],
                                                        out))
    default = dataset.write_kmer_distribution(features["file"])
    assert default.endswith("all.kmer_distri.tsv")
    os.remove(default)


@pytest.mark.parametrize("where", ["file", "dir"])
@pytest.mark.parametrize("label", [0, 1])
def test_filter_samples_by_label_matches_jax(features, tmp_path, where,
                                             label):
    n, m = _same_output(
        tmp_path,
        lambda out: dataset.filter_samples_by_label(features[where], out,
                                                    label),
        lambda out: jax_dataset.filter_samples_by_label(features[where],
                                                        out, label))
    assert n == m == sum(r.endswith(f"\t{label}") for r in features["rows"])


@pytest.mark.parametrize("where", ["file", "dir"])
def test_filter_samples_by_positions_matches_jax(features, tmp_path, where):
    n, m = _same_output(
        tmp_path,
        lambda out: dataset.filter_samples_by_positions(
            features[where], features["pos"], out, label="0"),
        lambda out: jax_dataset.filter_samples_by_positions(
            features[where], features["pos"], out, label="0"))
    assert n == m == 24


# --------------------------------------------------------------------------
# runner


def _runner_cfg(mod, tmp_path, **kw):
    return mod.RunnerConfig(
        input_path=str(tmp_path / "reads") + "/", ref_fp="ref.fa",
        model_path="model.ckpt", result_file="calls.tsv", **kw)


@pytest.mark.parametrize("multi,basecalled,resquiggled",
                         list(itertools.product([False, True], repeat=3)))
def test_runner_plan_matches_jax(tmp_path, capsys, multi, basecalled,
                                 resquiggled):
    kw = dict(is_multi_reads=multi, is_basecalled=basecalled,
              is_resquiggled=resquiggled, threads=3, gpu="cuda:1")
    got = runner.run_pipeline(_runner_cfg(runner, tmp_path, **kw),
                              dry_run=True)
    port_printed = capsys.readouterr().out
    want = jax_runner.run_pipeline(_runner_cfg(jax_runner, tmp_path, **kw),
                                   dry_run=True)
    assert got == want == runner.plan(_runner_cfg(runner, tmp_path, **kw))
    assert port_printed == capsys.readouterr().out
    assert got[-1][:2] == ["<in-process>", "call_mods"]
    assert len(got) == 1 + multi + (0 if resquiggled else 1) + \
        (2 if not (basecalled or resquiggled) else 0)


def test_run_pipeline_matches_jax(tmp_path, monkeypatch):
    """Every stage: the external ones through an injected executor (which
    sees combined.fastq in place), the in-process call_mods on the tiny
    checkpoint, on the CPU in float32 for the port, against the JAX
    package's runner."""
    cfg = torch_tiny.tiny_cfg()
    ckpt = save_checkpoint(
        str(tmp_path / "m.ckpt"), cfg,
        state_dict_to_variables(cfg, torch_tiny.tiny_state_dict()))
    reads = tmp_path / "features.tsv"
    reads.write_bytes(open(torch_tiny.FEATURES, "rb").read())
    fq = tmp_path / "features.tsv.guppy.fq"
    fq.mkdir()
    for k in range(2):
        (fq / f"r{k}.fastq").write_text(f"@r{k}\nACGT\n+\nIIII\n")
    for mod in (caller, jax_caller):
        monkeypatch.setattr(mod, "DEFAULT_COMPUTE_DTYPE", "float32")
    results = {}
    for name, mod, kw in (("port", runner, {"device": "cpu"}),
                          ("jax", jax_runner, {})):
        seen, fastqs = [], []

        def exe(argv):
            if argv[:2] == ["tombo", "preprocess"]:
                fastq = argv[argv.index("--fastq-filenames") + 1]
                fastqs.append(open(fastq).read())
            seen.append(argv)

        rcfg = mod.RunnerConfig(
            input_path=str(reads), ref_fp="ref.fa", model_path=ckpt,
            result_file=str(tmp_path / f"{name}.calls.tsv"),
            kmer_len=torch_tiny.K, cent_signals_len=torch_tiny.S, threads=1)
        cmds = mod.run_pipeline(rcfg, runner=exe, **kw)
        results[name] = (cmds, seen, fastqs,
                         [r.split("\t") for r in
                          open(rcfg.result_file).read().splitlines()])
        assert not (fq / "combined.fastq").exists()
    (cmds, seen, fastqs, got) = results["port"]
    (jcmds, jseen, jfastqs, want) = results["jax"]
    assert [c[0] for c in cmds] == ["guppy_basecaller", "tombo", "tombo",
                                    "<in-process>"]
    assert cmds[:-1] == jcmds[:-1] == seen == jseen
    assert fastqs == jfastqs == ["@r0\nACGT\n+\nIIII\n@r1\nACGT\n+\nIIII\n"]
    assert len(got) == len(want) == torch_tiny.N_ROWS
    for g, w in zip(got, want):
        assert g[:6] + g[8:] == w[:6] + w[8:]
        np.testing.assert_allclose(np.float32(g[6:8]), np.float32(w[6:8]),
                                   rtol=0, atol=PROB_TOL)


def test_run_pipeline_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rcfg = runner.RunnerConfig(
        input_path=torch_tiny.FEATURES, ref_fp="ref.fa",
        model_path=str(tmp_path / "m"), result_file=str(tmp_path / "o.tsv"),
        is_resquiggled=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner.run_pipeline(rcfg)


# --------------------------------------------------------------------------
# log plots


@pytest.fixture
def log_dir(tmp_path):
    rng = np.random.default_rng(74)
    for name in ("train.txt", "valid.txt"):
        lines = [f"epoch:{i // 3}, iterid:{100 * i}, loss:{rng.uniform():.3f}"
                 f", accuracy:{rng.uniform():.3f}, recall:{rng.uniform():.3f}"
                 f", precision:{rng.uniform():.3f}" for i in range(7)]
        lines.insert(2, "a line of another shape")
        (tmp_path / name).write_text("\n".join(lines) + "\n")
    return tmp_path


def test_parse_log_file_matches_jax(log_dir):
    for name in ("train.txt", "valid.txt"):
        got = vis.parse_log_file(str(log_dir / name))
        assert got == jax_vis.parse_log_file(str(log_dir / name))
        assert [len(v) for v in got.values()] == [7, 7, 7, 7]


def test_draw_log_writes_a_png(log_dir):
    out = vis.draw_log(str(log_dir))
    assert out == str(log_dir / "train_valid_curves.png")
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_draw_log_without_matplotlib_raises(log_dir, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    for mod in (vis, jax_vis):
        with pytest.raises(RuntimeError, match="matplotlib is required"):
            mod.draw_log(str(log_dir))
