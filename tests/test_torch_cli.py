"""The port's command line against the JAX package's: the same 18
subcommands with the same flags, short forms and defaults (less
``--lstm_impl``, plus ``--device`` on the model subcommands); the host
tools' CLI runs write the JAX package's files; and the host-only
subcommands run with torch blocked."""

import argparse
import os
import subprocess
import sys

import numpy as np
import pytest

from deepsignal_tpu.cli.main import build_parser as jax_build_parser
from deepsignal_tpu.cli.main import main as jax_main
from deepsignal_tpu_torch.cli.main import build_parser
from deepsignal_tpu_torch.cli.main import main as port_main
from deepsignal_tpu_torch.io.feature_codec import format_feature_row

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_SUBCOMMANDS = {"call_mods", "train", "denoise", "runner"}
JAX_ONLY_FLAGS = {("call_mods", "--lstm_impl")}
ALL_SUBCOMMANDS = {
    "extract", "call_mods", "train", "denoise", "call_freq", "combine_freq",
    "combine_strands", "evaluate", "runner", "binarize", "filter_label",
    "filter_positions", "select_neg", "kmer_dist", "randsel", "shuffle",
    "concat", "visualize_log"}


def _subparsers(parser) -> dict:
    action = next(a for a in parser._actions
                  if isinstance(a, argparse._SubParsersAction))
    return dict(action.choices)


def _flags(parser) -> dict:
    """long flag -> what a user sees of it: its option strings, default,
    type, choices, whether it is required, its nargs and action kind."""
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        long = next(s for s in a.option_strings if s.startswith("--"))
        out[long] = (sorted(a.option_strings), a.default,
                     getattr(a.type, "__name__", a.type), a.choices,
                     a.required, a.nargs, type(a).__name__, a.dest)
    return out


def test_every_subcommand_and_flag_of_the_jax_cli():
    port, jax = _subparsers(build_parser()), _subparsers(jax_build_parser())
    assert set(jax) == set(port) == ALL_SUBCOMMANDS
    for name in sorted(jax):
        want = {k: v for k, v in _flags(jax[name]).items()
                if (name, k) not in JAX_ONLY_FLAGS}
        got = _flags(port[name])
        extra = set(got) - set(want)
        assert extra == ({"--device"} if name in MODEL_SUBCOMMANDS
                         else set()), name
        for flag, spec in want.items():
            assert got.get(flag) == spec, (name, flag)
    assert _flags(port["runner"])["--device"][1] == "cuda"
    assert "--lstm_impl" in _flags(jax["call_mods"])


def test_help_lists_all_18_subcommands():
    out = subprocess.run([sys.executable, "-m", "deepsignal_tpu_torch.cli",
                          "--help"], cwd=REPO, capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    listed = out.stdout.split("{", 1)[1].split("}", 1)[0].split(",")
    assert set(listed) == ALL_SUBCOMMANDS


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(80)
    genome = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 400)])
    (d / "ref.fa").write_text(">chrC\n" + genome + "\n")
    sites = [i for i in range(len(genome) - 1) if genome[i:i + 2] == "CG"]
    calls = []
    for i in range(150):
        strand = "+-"[i % 2]
        pos = sites[int(rng.integers(0, len(sites)))] + (strand == "-")
        p1 = np.float32(rng.uniform())
        calls.append("\t".join(["chrC", str(pos), strand, str(pos),
                                f"r{i % 9}", "t", str(np.float32(1) - p1),
                                str(p1), str(int(p1 > 0.5)), "ACGTA"]))
    (d / "calls.tsv").write_text("\n".join(calls) + "\n")
    feats = [format_feature_row(
        "chrC", 10 + i, "+", 10 + i, f"r{i // 4}", "t",
        "".join(rng.choice(list("ACGT"), 5)), rng.normal(0, 1, 5),
        np.abs(rng.normal(0, 1, 5)), rng.integers(1, 50, 5),
        np.around(rng.normal(0, 1, 9), 6), i % 2) for i in range(40)]
    (d / "feats.tsv").write_text("\n".join(feats) + "\n")
    (d / "pos.tsv").write_text("".join(f"chrC\t{10 + i}\t+\n"
                                       for i in range(0, 40, 3)))
    return d


@pytest.mark.parametrize("name,argv,outs", [
    ("call_freq", ["call_freq", "-i", "{d}/calls.tsv", "-o", "{o}/f.tsv",
                   "--prob_cf", "0.2", "--sort"], ["f.tsv"]),
    ("call_freq_bed", ["call_freq", "-i", "{d}/calls.tsv", "-i",
                       "{d}/calls.tsv", "-o", "{o}/f.bed", "--bed"],
     ["f.bed"]),
    ("binarize", ["binarize", "-i", "{o}/feats.tsv", "-x", "5", "-y", "9"],
     ["feats.bin"]),
    ("filter_label", ["filter_label", "-i", "{d}/feats.tsv", "-o",
                      "{o}/l0.tsv", "--label", "0"], ["l0.tsv"]),
    ("filter_positions", ["filter_positions", "-i", "{d}/feats.tsv", "-p",
                          "{d}/pos.tsv", "-o", "{o}/p.tsv", "--label", "0"],
     ["p.tsv"]),
    ("combine_strands", ["combine_strands", "--frequency_fp", "{o}/f.tsv",
                         "-r", "{d}/ref.fa"], ["f.fb_combined.tsv"]),
    ("kmer_dist", ["kmer_dist", "-i", "{o}/feats.tsv"],
     ["feats.kmer_distri.tsv"]),
])
def test_cli_runs_write_the_jax_files(inputs, tmp_path, name, argv, outs):
    files = {}
    for pkg, main in (("port", port_main), ("jax", jax_main)):
        o = tmp_path / pkg
        o.mkdir()
        (o / "feats.tsv").write_bytes((inputs / "feats.tsv").read_bytes())
        if name == "combine_strands":
            port_main(["call_freq", "-i", str(inputs / "calls.tsv"), "-o",
                       str(o / "f.tsv")])
        assert main([a.format(d=inputs, o=o) for a in argv]) == 0
        files[pkg] = [(o / f).read_bytes() for f in outs]
    assert files["port"] == files["jax"]
    assert all(files["port"])


HOST_ONLY = [
    ["call_freq", "-i", "{d}/calls.tsv", "-o", "{o}/f.tsv"],
    ["combine_freq", "--modsfile", "{o}/f.tsv", "--modsfile", "{o}/f.tsv",
     "--wfile", "{o}/ff.tsv"],
    ["combine_strands", "--frequency_fp", "{o}/f.tsv", "-r", "{d}/ref.fa"],
    ["evaluate", "--methylated", "{d}/calls.tsv", "--unmethylated",
     "{d}/calls.tsv", "--result_file", "{o}/eval.txt"],
    ["binarize", "-i", "{d}/feats.tsv", "-o", "{o}/feats.bin", "-x", "5",
     "-y", "9"],
    ["filter_label", "-i", "{d}/feats.tsv", "-o", "{o}/l.tsv"],
    ["filter_positions", "-i", "{d}/feats.tsv", "-p", "{d}/pos.tsv", "-o",
     "{o}/p.tsv"],
    ["select_neg", "--pos_file", "{o}/l.tsv", "--neg_file", "{d}/feats.tsv",
     "-o", "{o}/neg.tsv"],
    ["kmer_dist", "-i", "{o}/l.tsv"],
    ["randsel", "-i", "{d}/feats.tsv", "-o", "{o}/sel.tsv",
     "--write_other_filepath", "{o}/rest.tsv", "--num_lines", "10"],
    ["shuffle", "-i", "{o}/l.tsv", "--num_lines_shuffle", "7",
     "--temp_dir", "{o}"],
    ["concat", "--fp1", "{o}/l.tsv", "--fp2", "{o}/p.tsv", "-o",
     "{o}/cat.tsv", "--shuffle_lines_num", "5"],
    ["visualize_log", "-i", "{o}"],
    ["runner", "-i", "{d}/fast5", "-r", "{d}/ref.fa", "-m", "{o}/model",
     "-o", "{o}/calls.tsv", "--dry_run", "yes"],
]


def test_host_only_subcommands_run_without_torch(inputs, tmp_path):
    """Every host-only subcommand (and ``runner --dry_run``) in one process
    where ``import torch`` fails."""
    (tmp_path / "train.txt").write_text(
        "epoch:0, iterid:1, loss:0.693, accuracy:0.500, recall:0.400, "
        "precision:0.600\n")
    (tmp_path / "valid.txt").write_bytes(
        (tmp_path / "train.txt").read_bytes())
    runs = [[a.format(d=inputs, o=tmp_path) for a in argv]
            for argv in HOST_ONLY]
    code = ("import sys\n"
            "sys.modules['torch'] = None\n"
            "from deepsignal_tpu_torch.cli.main import main\n"
            f"for argv in {runs!r}:\n"
            "    assert main(argv) == 0, argv\n"
            "print('torch' in sys.modules and sys.modules['torch'] is not "
            "None)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "False"
    assert {r[0] for r in runs} == ALL_SUBCOMMANDS - {
        "extract", "call_mods", "train", "denoise"}
    for name in ("ff.tsv", "f.fb_combined.tsv", "eval.txt", "feats.bin",
                 "neg.tsv", "l.kmer_distri.tsv", "sel.tsv", "rest.tsv",
                 "l.shuffle.tsv", "cat.tsv", "train_valid_curves.png"):
        assert (tmp_path / name).stat().st_size > 0, name
