"""One-shot pipeline runner: basecall -> resquiggle -> call_mods (port of
deepsignal_tpu/tools/runner.py).

Equivalent of ``scripts/guppy_deepsignal_runner.py`` (reference
scripts/guppy_deepsignal_runner.py:16-154): drives the external
preprocessing tools (ont_fast5_api ``multi_to_single_fast5``, the guppy
basecaller, tombo preprocess and resquiggle) and then calls modifications.

As in the JAX package, and unlike the reference:

- external stages run through ``subprocess`` with list argv (no shell);
- the calling stage runs in this process, through
  ``runtime/caller.py::run_call_mods`` on ``device`` (``cuda`` unless the
  caller asks for the CPU), not through a second CLI process;
- every stage can be skipped, and ``dry_run`` returns the argv plan
  without running it (how the tests drive it without guppy or tombo).

Only the calling stage imports torch.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import shutil
import subprocess
import time
from typing import List, Sequence


@dataclasses.dataclass
class RunnerConfig:
    """Flags of the reference runner (guppy_deepsignal_runner.py:160-252)."""

    input_path: str
    ref_fp: str
    model_path: str
    result_file: str
    # fast5 layout
    is_multi_reads: bool = False
    # guppy
    flowcell: str = "FLO-MIN106"
    kit: str = "SQK-LSK108"
    num_callers: int = 4
    gpu: str = "cuda:0"
    # tombo
    basecall_group: str = "Basecall_1D_000"
    basecall_subgroup: str = "BaseCalled_template"
    corrected_group: str = "RawGenomeCorrected_000"
    # call_mods
    kmer_len: int = 17
    cent_signals_len: int = 360
    motifs: str = "CG"
    mod_loc: int = 0
    threads: int = 4
    # stage toggles (the reference's is_basecalled / is_resquiggled)
    is_basecalled: bool = False
    is_resquiggled: bool = False


def multi_to_single_cmd(input_path: str, threads: int) -> List[str]:
    """argv of ont_fast5_api's multi -> single conversion
    (guppy_deepsignal_runner.py:16-28)."""
    input_path = input_path.rstrip("/")
    return ["multi_to_single_fast5",
            "--input_path", input_path,
            "--save_path", input_path + ".single",
            "--recursive", "--threads", str(threads)]


def guppy_cmd(input_path: str, cfg: RunnerConfig) -> List[str]:
    """argv of guppy basecalling (guppy_deepsignal_runner.py:31-46)."""
    input_path = input_path.rstrip("/")
    return ["guppy_basecaller", "-i", input_path, "-r",
            "-s", input_path + ".guppy.fq",
            "--flowcell", cfg.flowcell, "--kit", cfg.kit,
            "--num_callers", str(cfg.num_callers), "-x", cfg.gpu]


def tombo_preprocess_cmd(input_path: str, combined_fastq: str,
                         summary_txt: str, cfg: RunnerConfig) -> List[str]:
    """argv of tombo's fastq annotation (guppy_deepsignal_runner.py:49-79)."""
    return ["tombo", "preprocess", "annotate_raw_with_fastqs",
            "--fast5-basedir", input_path.rstrip("/"),
            "--fastq-filenames", combined_fastq,
            "--sequencing-summary-filenames", summary_txt,
            "--basecall-group", cfg.basecall_group,
            "--basecall-subgroup", cfg.basecall_subgroup,
            "--overwrite", "--processes", str(cfg.threads)]


def tombo_resquiggle_cmd(input_path: str, cfg: RunnerConfig) -> List[str]:
    """argv of tombo resquiggle (guppy_deepsignal_runner.py:82-96)."""
    return ["tombo", "resquiggle", input_path.rstrip("/"), cfg.ref_fp,
            "--processes", str(cfg.threads),
            "--corrected-group", cfg.corrected_group,
            "--basecall-group", cfg.basecall_group,
            "--overwrite", "--ignore-read-locks"]


def plan(cfg: RunnerConfig) -> List[List[str]]:
    """The stages' argv, in order.  The in-process call_mods stage is the
    pseudo-argv ``["<in-process>", "call_mods", ...]``, so that a dry run
    shows the whole pipeline."""
    cmds: List[List[str]] = []
    input_path = cfg.input_path.rstrip("/")
    if cfg.is_multi_reads:
        cmds.append(multi_to_single_cmd(input_path, cfg.threads))
        input_path = input_path + ".single"
    if not cfg.is_basecalled and not cfg.is_resquiggled:
        cmds.append(guppy_cmd(input_path, cfg))
        fastq_dir = input_path + ".guppy.fq"
        cmds.append(tombo_preprocess_cmd(
            input_path, os.path.join(fastq_dir, "combined.fastq"),
            os.path.join(fastq_dir, "sequencing_summary.txt"), cfg))
    if not cfg.is_resquiggled:
        cmds.append(tombo_resquiggle_cmd(input_path, cfg))
    cmds.append(["<in-process>", "call_mods",
                 "--input_path", input_path,
                 "--model_path", cfg.model_path,
                 "--result_file", cfg.result_file,
                 "--motifs", cfg.motifs])
    return cmds


def _combine_fastqs(fastq_dir: str) -> str:
    """cat <dir>/*.fastq > <dir>/combined.fastq
    (guppy_deepsignal_runner.py:60-62), without a shell."""
    combined = os.path.join(fastq_dir, "combined.fastq")
    with open(combined, "wb") as out:
        for fq in sorted(glob.glob(os.path.join(fastq_dir, "*.fastq"))):
            if os.path.abspath(fq) == os.path.abspath(combined):
                continue
            with open(fq, "rb") as f:
                shutil.copyfileobj(f, out)
    return combined


def run_pipeline(cfg: RunnerConfig, dry_run: bool = False, runner=None,
                 device=None) -> Sequence[List[str]]:
    """Run the pipeline (guppy_deepsignal_runner.py:124-154); returns the
    argv plan that ran (or, with ``dry_run``, would run).

    ``runner`` replaces the subprocess executor of the external stages
    (the tests inject one); ``device`` is the calling stage's torch device
    (``None``: ``cuda``, which raises without a GPU)."""
    cmds = plan(cfg)
    if dry_run:
        for c in cmds:
            print("cmd:", " ".join(c))
        return cmds

    exe = runner or (lambda argv: subprocess.run(argv, check=True))
    for argv in cmds:
        start = time.time()
        if argv[0] == "<in-process>":
            from ..core.config import FeatureConfig
            from ..runtime.caller import run_call_mods
            print("[deepsignal_tpu_torch] call_mods ================")
            fcfg = FeatureConfig(
                kmer_len=cfg.kmer_len, cent_signals_len=cfg.cent_signals_len,
                motifs=cfg.motifs, mod_loc=cfg.mod_loc,
                corrected_group=cfg.corrected_group,
                basecall_subgroup=cfg.basecall_subgroup)
            run_call_mods(argv[3], cfg.model_path, cfg.result_file, fcfg,
                          nproc=cfg.threads, reference_path=cfg.ref_fp,
                          device=device)
        else:
            print("cmd:", " ".join(argv))
            is_preprocess = argv[0] == "tombo" and argv[1] == "preprocess"
            if is_preprocess:
                # materialize combined.fastq first (the reference's cmd1)
                fastq = argv[argv.index("--fastq-filenames") + 1]
                _combine_fastqs(os.path.dirname(fastq))
            exe(argv)
            if is_preprocess:
                os.remove(fastq)
        print("stage %s costs %.2f seconds" % (
            "call_mods" if argv[0] == "<in-process>" else argv[0],
            time.time() - start))
    return cmds
