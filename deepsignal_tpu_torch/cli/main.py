"""deepsignal-tpu-torch command line: the JAX package's 18 subcommands.

The four model subcommands (``extract``, ``call_mods``, ``train``,
``denoise``) and the reference's scripts/ tools as subcommands:
``call_freq``, ``combine_freq``, ``combine_strands``, ``evaluate``,
``runner``, ``binarize``, ``filter_label``, ``filter_positions``,
``select_neg``, ``kmer_dist``, ``randsel``, ``shuffle``, ``concat`` and
``visualize_log``.

Flag names, short forms and defaults follow the JAX package's CLI (and the
reference's).  Two differences: ``--device`` (default ``cuda``) is new on
the subcommands that run the model (``call_mods``, ``train``, ``denoise``,
``runner``), and ``call_mods`` has no ``--lstm_impl``, whose choices name
the JAX package's TPU implementations (XLA scan or Pallas kernel); the
port always runs its CUDA kernels on the card.  Only the handlers of
``call_mods``, ``train``, ``denoise`` and ``runner`` import torch; the
other subcommands are host code.  The random tools draw unseeded, as the
JAX package's CLI does.

Under ``torchrun --nproc_per_node N`` (one process per GPU; each rank on
``cuda:{LOCAL_RANK}`` unless ``--device`` names a card), ``call_mods``,
``train`` and ``denoise`` first make the process group
(``parallel/dist.py``) and destroy it when they end: ``call_mods`` calls
rank k's stride shard of the input into ``<result_file>.part<k>-of-<N>``,
``train`` and ``denoise`` train on the mesh of all ranks, as the JAX
CLI's ``make_mesh()`` over all devices does.  Without torchrun's
environment no group is made.
"""

from __future__ import annotations

import argparse
import os
import random
import sys

from ..core.constants import str2bool


def display_args(args) -> None:
    """Flag echo banner (process_utils.py:42-49)."""
    print("# ===============================================")
    print("## parameters: ")
    for k, v in vars(args).items():
        if k != "func":
            print("{}:\n\t{}".format(k, v))
    print("# ===============================================")


def _feature_cfg_from_args(args):
    from ..core.config import FeatureConfig
    return FeatureConfig(
        kmer_len=args.kmer_len, cent_signals_len=args.cent_signals_len,
        motifs=args.motifs, mod_loc=args.mod_loc,
        methy_label=getattr(args, "methy_label", 1),
        normalize_method=args.normalize_method,
        is_dna=str2bool(args.is_dna),
        corrected_group=args.corrected_group,
        basecall_subgroup=args.basecall_subgroup)


def main_extract(args) -> int:
    """Exit code 1 when every fast5 file failed."""
    display_args(args)
    from ..runtime.pipeline import run_extract
    stats = {}
    errors = run_extract(
        args.fast5_dir, args.write_path, _feature_cfg_from_args(args),
        reference_path=args.reference_path, nproc=args.nproc,
        f5_batch_num=args.f5_batch_num, w_is_dir=str2bool(args.w_is_dir),
        w_batch_num=args.w_batch_num, position_file=args.positions,
        is_recursive=str2bool(args.recursively), stats=stats)
    if errors and errors == stats["inputs"]:
        print(f"extract: all {errors} fast5 files failed", file=sys.stderr)
        return 1
    return 0


def _group_mesh():
    """The mesh of every rank when a process group is up, else None."""
    from ..parallel.dist import group_is_up
    from ..parallel.mesh import make_mesh
    return make_mesh() if group_is_up() else None


def main_call_mods(args) -> None:
    display_args(args)
    from ..core.config import ModelConfig
    from ..parallel.dist import distributed
    from ..runtime.caller import run_call_mods
    feature_cfg = _feature_cfg_from_args(args)
    override = None
    if args.is_cnn is not None:
        override = ModelConfig(
            kmer_len=args.kmer_len, cent_signals_len=args.cent_signals_len,
            class_num=args.class_num, is_cnn=str2bool(args.is_cnn),
            is_rnn=str2bool(args.is_rnn), is_base=str2bool(args.is_base))
    with distributed(args.device):
        run_call_mods(args.input_path, args.model_path, args.result_file,
                      feature_cfg, batch_size=args.batch_size,
                      f5_batch_num=args.f5_batch_num,
                      model_cfg_override=override,
                      compute_dtype=args.compute_dtype, device=args.device,
                      nproc=args.nproc, reference_path=args.reference_path,
                      position_file=args.positions,
                      is_recursive=str2bool(args.recursively))


def main_train(args) -> None:
    display_args(args)
    from ..core.config import ModelConfig, TrainConfig
    from ..parallel.dist import distributed
    from ..train.trainer import train
    mcfg = ModelConfig(
        kmer_len=args.kmer_len, cent_signals_len=args.cent_signals_len,
        class_num=args.class_num, is_cnn=str2bool(args.is_cnn),
        is_rnn=str2bool(args.is_rnn), is_base=str2bool(args.is_base),
        pos_weight=args.pos_weight)
    tcfg = TrainConfig(
        batch_size=args.batch_size, learning_rate=args.learning_rate,
        decay_rate=args.decay_rate, keep_prob=args.keep_prob,
        max_epoch_num=args.max_epoch_num, min_epoch_num=args.min_epoch_num,
        display_step=args.display_step, pos_weight=args.pos_weight,
        seed=args.seed)
    with distributed(args.device):
        train(args.train_file, args.valid_file, args.model_dir, args.log_dir,
              mcfg, tcfg, is_binary=str2bool(args.is_binary),
              resume=str2bool(args.resume), device=args.device,
              mesh=_group_mesh())


def main_denoise(args) -> None:
    display_args(args)
    from ..core.config import DenoiseConfig, ModelConfig
    from ..parallel.dist import distributed
    from ..train.denoise import denoise
    dcfg = DenoiseConfig(
        iterations=args.iterations, epoch_num=args.epoch_num,
        rounds=args.rounds, score_cf=args.score_cf,
        step_interval=args.step_interval, batch_size=args.batch_size,
        learning_rate=args.lr, decay_rate=args.decay_rate,
        keep_prob=args.keep_prob, pos_weight=args.pos_weight,
        is_cnn=str2bool(args.is_cnn), is_base=str2bool(args.is_base),
        is_rnn=str2bool(args.is_rnn))
    # the JAX package's mapping of the flags, kept as it is: --layer_num is
    # parsed and not passed on (the model keeps ModelConfig's 3 layers)
    mcfg = ModelConfig(
        kmer_len=args.seq_len, cent_signals_len=args.cent_signals_len,
        class_num=args.class_num, is_cnn=dcfg.is_cnn, is_rnn=dcfg.is_rnn,
        is_base=dcfg.is_base, pos_weight=dcfg.pos_weight)
    with distributed(args.device):
        denoise(args.train_file, mcfg, dcfg, device=args.device,
                mesh=_group_mesh())


def main_call_freq(args) -> None:
    from ..tools.frequency import call_mods_frequency_to_file
    call_mods_frequency_to_file(args.input_path, args.result_file,
                                prob_cf=args.prob_cf, file_uid=args.file_uid,
                                is_sort=args.sort, is_bed=args.bed)


def main_combine_freq(args) -> None:
    from ..tools.frequency import combine_freq_files
    combine_freq_files(args.modsfile, args.wfile)


def main_combine_strands(args) -> None:
    from ..tools.combine import combine_two_strands_frequency
    out = combine_two_strands_frequency(args.frequency_fp, args.ref_fp,
                                        contig=args.contig)
    print("combined file: {}".format(out))


def main_evaluate(args) -> None:
    from ..tools.evaluate import evaluate_mods_call
    evaluate_mods_call(args.methylated, args.unmethylated, args.result_file,
                       rng=random.Random())


def main_runner(args) -> None:
    from ..tools.runner import RunnerConfig, run_pipeline
    cfg = RunnerConfig(
        input_path=args.input_path, ref_fp=args.ref_fp,
        model_path=args.model_path, result_file=args.result_file,
        is_multi_reads=args.is_multi_reads, flowcell=args.flowcell,
        kit=args.kit, num_callers=args.num_callers, gpu=args.gpu,
        basecall_group=args.basecall_group,
        basecall_subgroup=args.basecall_subgroup,
        corrected_group=args.corrected_group, kmer_len=args.kmer_len,
        cent_signals_len=args.cent_signals_len, motifs=args.motifs,
        mod_loc=args.mod_loc, threads=args.nproc,
        is_basecalled=args.is_basecalled, is_resquiggled=args.is_resquiggled)
    run_pipeline(cfg, dry_run=args.dry_run, device=args.device)


def main_binarize(args) -> None:
    from ..io.feature_codec import convert_txt_to_binary
    out = args.write_path
    if out is None:
        out = os.path.splitext(args.feature_file)[0] + ".bin"
    n = convert_txt_to_binary(args.feature_file, out, args.kmer_len,
                              args.cent_signals_len)
    print("wrote {} records to {}".format(n, out))


def main_filter_label(args) -> None:
    from ..tools.dataset import filter_samples_by_label
    n = filter_samples_by_label(args.input_path, args.write_path, args.label,
                                args.unique_fid)
    print("kept {} rows".format(n))


def main_filter_positions(args) -> None:
    from ..tools.dataset import filter_samples_by_positions
    n = filter_samples_by_positions(args.sf_path, args.pos_fp,
                                    args.write_path, label=args.label,
                                    chrom_col=args.chrom_col,
                                    pos_col=args.pos_col,
                                    unique_fid=args.unique_fid)
    print("kept {} rows".format(n))


def main_select_neg(args) -> None:
    from ..tools.dataset import select_negsamples_asposkmer
    n = select_negsamples_asposkmer(args.pos_file, args.neg_file,
                                    args.write_path, rng=random.Random())
    print("selected {} negative rows".format(n))


def main_kmer_dist(args) -> None:
    from ..tools.dataset import write_kmer_distribution
    out = write_kmer_distribution(args.feafile)
    print("kmer distribution written to {}".format(out))


def main_randsel(args) -> None:
    from ..tools.dataset import random_select_file_rows
    n = random_select_file_rows(args.ori_filepath, args.write_filepath,
                                args.write_other_filepath, args.num_lines,
                                str2bool(args.header), rng=random.Random())
    print("selected {} rows".format(n))


def main_shuffle(args) -> None:
    import numpy as np

    from ..tools.dataset import shuffle_big_file
    out = shuffle_big_file(args.fp, num_lines_shuffle=args.num_lines_shuffle,
                           temp_dir=args.temp_dir,
                           rng=np.random.default_rng())
    print("shuffled file: {}".format(out))


def main_concat(args) -> None:
    import numpy as np

    from ..tools.dataset import concat_two_files
    concat_two_files(args.fp1, args.fp2, args.concated_fp,
                     shuffle_lines_num=args.shuffle_lines_num,
                     isheader=str2bool(args.header),
                     rng=np.random.default_rng())
    print("done concating files to: {}".format(args.concated_fp))


def main_visualize_log(args) -> None:
    from ..tools.vis import draw_log
    out = draw_log(args.log_dir, args.out_fp)
    print("figure saved to {}".format(out))


def _add_device_arg(p) -> None:
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device, default cuda; 'cpu' runs the plain "
                        "versions of the kernels")


def _add_fast5_args(p, with_methy_label: bool = True) -> None:
    """The featurizer's flags (the JAX CLI's, cli/main.py:267-310)."""
    grp = p.add_argument_group("FAST5_EXTRACTION")
    grp.add_argument("--recursively", "-r", type=str, default="yes",
                     help="is to find fast5 files from fast5_dir recursively. "
                          "default true, t, yes, 1")
    grp.add_argument("--corrected_group", type=str,
                     default="RawGenomeCorrected_000",
                     help="the corrected_group of fast5 files after tombo "
                          "re-squiggle. default RawGenomeCorrected_000")
    grp.add_argument("--basecall_subgroup", type=str,
                     default="BaseCalled_template",
                     help="the corrected subgroup of fast5 files. "
                          "default BaseCalled_template")
    grp.add_argument("--is_dna", type=str, default="yes",
                     help="whether the fast5 files are from a DNA sample. "
                          "set no for RNA. default yes")
    grp.add_argument("--normalize_method", type=str,
                     choices=["mad", "zscore"], default="mad",
                     help="read-level signal normalization. default mad")
    if with_methy_label:
        grp.add_argument("--methy_label", type=int, choices=[1, 0],
                         default=1,
                         help="label of the interested modified bases "
                              "(training). default 1")
    grp.add_argument("--motifs", type=str, default="CG",
                     help="motif seq to be extracted, default CG. "
                          "comma-separated, IUPAC allowed")
    grp.add_argument("--mod_loc", type=int, default=0,
                     help="0-based location of the targeted base in the "
                          "motif, default 0")
    grp.add_argument("--positions", type=str, default=None,
                     help="tab-separated file (chrom, fwd pos, strand) "
                          "restricting extracted motif sites")
    grp.add_argument("--reference_path", type=str, default=None,
                     help="reference genome .fa (optional)")
    grp.add_argument("--kmer_len", "-x", type=int, default=17,
                     help="len of kmer. default 17")
    grp.add_argument("--cent_signals_len", "-y", type=int, default=360,
                     help="central signal points used. default 360")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="deepsignal-tpu-torch",
        description="deepsignal-tpu-torch: detection of DNA methylation "
                    "state from Oxford Nanopore reads, in PyTorch on CUDA")
    subparsers = parser.add_subparsers(title="modules", dest="command")

    p = subparsers.add_parser(
        "extract",
        description="extract features from corrected (tombo) fast5s for "
                    "training or testing")
    p.add_argument("--fast5_dir", "-i", type=str, required=True,
                   help="the directory of fast5 files")
    _add_fast5_args(p)
    p.add_argument("--write_path", "-o", type=str, required=True,
                   help="file path to save the features")
    p.add_argument("--w_is_dir", type=str, default="no",
                   help="save features into multiple files in a dir")
    p.add_argument("--w_batch_num", type=int, default=200,
                   help="batches per file when --w_is_dir is true")
    p.add_argument("--nproc", "-p", type=int, default=1,
                   help="number of processes, default 1")
    p.add_argument("--f5_batch_num", type=int, default=50,
                   help="fast5 files per worker batch, default 50")
    p.set_defaults(func=main_extract)

    p = subparsers.add_parser("call_mods", description="call modifications")
    p.add_argument("--input_path", "-i", type=str, required=True,
                   help="feature TSV from extract, or a fast5 directory")
    p.add_argument("--model_path", "-m", type=str, required=True,
                   help="checkpoint directory of the trained model")
    p.add_argument("--result_file", "-o", type=str, required=True,
                   help="path to save the predicted result")
    p.add_argument("--batch_size", "-b", default=4096, type=int,
                   help="device batch size, default 4096")
    p.add_argument("--class_num", "-c", default=2, type=int,
                   help="class num, default 2")
    p.add_argument("--is_cnn", type=str, default=None,
                   help="override: model contains inception module")
    p.add_argument("--is_rnn", type=str, default=None,
                   help="override: model contains BiLSTM module")
    p.add_argument("--is_base", type=str, default=None,
                   help="override: BiLSTM takes base features")
    p.add_argument("--nproc", "-p", type=int, default=2,
                   help="number of processes for a fast5 directory (one "
                        "main, the rest extract workers), default 2")
    p.add_argument("--f5_batch_num", type=int, default=50,
                   help="reads/files per batch, default 50")
    p.add_argument("--compute_dtype", type=str, default=None,
                   choices=["float32", "bfloat16"],
                   help="bfloat16 = fast path (default), float32 = "
                        "reference-parity mode")
    _add_device_arg(p)
    _add_fast5_args(p, with_methy_label=False)
    p.set_defaults(func=main_call_mods)

    p = subparsers.add_parser(
        "train", description="train a model; needs independent training and "
                             "validation datasets")
    p.add_argument("--train_file", type=str, required=True)
    p.add_argument("--valid_file", type=str, required=True)
    p.add_argument("--is_binary", type=str, default="no",
                   choices=["yes", "no"],
                   help="binary-format train/valid files")
    p.add_argument("--model_dir", "-o", type=str, required=True)
    p.add_argument("--log_dir", "-g", type=str, default=None)
    p.add_argument("--is_cnn", type=str, default="yes")
    p.add_argument("--is_base", type=str, default="yes")
    p.add_argument("--is_rnn", type=str, default="yes")
    p.add_argument("--kmer_len", "-x", default=17, type=int)
    p.add_argument("--cent_signals_len", "-y", default=360, type=int)
    p.add_argument("--batch_size", "-b", default=512, type=int)
    p.add_argument("--learning_rate", "-l", default=0.001, type=float)
    p.add_argument("--decay_rate", "-d", default=0.1, type=float)
    p.add_argument("--class_num", "-c", default=2, type=int)
    p.add_argument("--keep_prob", default=0.5, type=float)
    p.add_argument("--max_epoch_num", default=10, type=int)
    p.add_argument("--min_epoch_num", default=5, type=int)
    p.add_argument("--display_step", default=100, type=int)
    p.add_argument("--pos_weight", default=1.0, type=float)
    p.add_argument("--seed", default=42, type=int,
                   help="init/dropout/shuffle seed (reproducible runs)")
    p.add_argument("--resume", type=str, default="no", choices=["yes", "no"],
                   help="continue from the rolling train-state checkpoint in "
                        "model_dir (params + optimizer + generator + shuffle "
                        "stream); reproduces an unbroken run exactly")
    _add_device_arg(p)
    p.set_defaults(func=main_train)

    p = subparsers.add_parser(
        "denoise", description="denoise training samples by cross-rank")
    p.add_argument("--train_file", type=str, required=True)
    p.add_argument("--is_cnn", type=str, default="no")
    p.add_argument("--is_base", type=str, default="no")
    p.add_argument("--is_rnn", type=str, default="yes")
    p.add_argument("--seq_len", type=int, default=17)
    p.add_argument("--cent_signals_len", type=int, default=360)
    p.add_argument("--layer_num", type=int, default=3)
    p.add_argument("--class_num", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--decay_rate", type=float, default=0.1)
    p.add_argument("--keep_prob", default=0.5, type=float)
    p.add_argument("--iterations", type=int, default=6)
    p.add_argument("--epoch_num", type=int, default=5)
    p.add_argument("--step_interval", type=int, default=100)
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--score_cf", type=float, default=0.5,
                   help="score cutoff")
    p.add_argument("--pos_weight", type=float, default=1.0)
    _add_device_arg(p)
    p.set_defaults(func=main_denoise)

    # ---- tools ------------------------------------------------------------
    p = subparsers.add_parser(
        "call_freq",
        description="calculate per-site modification frequency")
    p.add_argument("--input_path", "-i", action="append", type=str,
                   required=True,
                   help="call_mods result file or a directory of them "
                        "(repeatable)")
    p.add_argument("--result_file", "-o", type=str, required=True)
    p.add_argument("--bed", action="store_true", default=False,
                   help="save in bedMethyl format")
    p.add_argument("--sort", action="store_true", default=False,
                   help="sort items in the result")
    p.add_argument("--prob_cf", type=float, default=0.0,
                   help="ambiguous-call filter: use call only if "
                        "abs(prob1-prob0)>=prob_cf. default 0.0")
    p.add_argument("--file_uid", type=str, default=None,
                   help="substring identifying input files in a directory")
    p.set_defaults(func=main_call_freq)

    p = subparsers.add_parser("combine_freq",
                              description="sum multiple frequency files "
                                          "per site")
    p.add_argument("--modsfile", action="append", type=str, required=True)
    p.add_argument("--wfile", type=str, required=True)
    p.set_defaults(func=main_combine_freq)

    p = subparsers.add_parser(
        "combine_strands",
        description="combine CG frequencies of +/- strands onto forward "
                    "positions")
    p.add_argument("--frequency_fp", type=str, required=True,
                   help="frequency file, freq TSV or .bed")
    p.add_argument("-r", "--ref_fp", type=str, required=True)
    p.add_argument("--contig", type=str, default="")
    p.set_defaults(func=main_combine_strands)

    p = subparsers.add_parser(
        "evaluate", description="evaluate call accuracy vs truth call files")
    p.add_argument("--unmethylated", type=str, required=True)
    p.add_argument("--methylated", type=str, required=True)
    p.add_argument("--result_file", type=str, required=True)
    p.set_defaults(func=main_evaluate)

    p = subparsers.add_parser(
        "runner",
        description="one-shot pipeline: multi_to_single_fast5 -> guppy -> "
                    "tombo resquiggle -> call_mods (the external tools must "
                    "be installed; call_mods runs in this process)")
    p.add_argument("--input_path", "-i", type=str, required=True)
    p.add_argument("--ref_fp", "-r", type=str, required=True)
    p.add_argument("--model_path", "-m", type=str, required=True)
    p.add_argument("--result_file", "-o", type=str, required=True)
    p.add_argument("--is_multi_reads", type=str2bool, default=False,
                   help="input fast5s are multi-read files")
    p.add_argument("--is_basecalled", type=str2bool, default=False)
    p.add_argument("--is_resquiggled", type=str2bool, default=False)
    p.add_argument("--flowcell", type=str, default="FLO-MIN106")
    p.add_argument("--kit", type=str, default="SQK-LSK108")
    p.add_argument("--num_callers", type=int, default=4)
    p.add_argument("--gpu", type=str, default="cuda:0",
                   help="guppy's device argument (guppy only)")
    p.add_argument("--basecall_group", type=str, default="Basecall_1D_000")
    p.add_argument("--basecall_subgroup", type=str,
                   default="BaseCalled_template")
    p.add_argument("--corrected_group", type=str,
                   default="RawGenomeCorrected_000")
    p.add_argument("--kmer_len", type=int, default=17)
    p.add_argument("--cent_signals_len", type=int, default=360)
    p.add_argument("--motifs", type=str, default="CG")
    p.add_argument("--mod_loc", type=int, default=0)
    p.add_argument("--nproc", "-p", type=int, default=4)
    p.add_argument("--dry_run", type=str2bool, default=False,
                   help="print the stage commands without executing")
    _add_device_arg(p)
    p.set_defaults(func=main_runner)

    p = subparsers.add_parser(
        "binarize", description="feature TSV -> fixed-length binary records")
    p.add_argument("--feature_file", "-i", type=str, required=True)
    p.add_argument("--write_path", "-o", type=str, default=None)
    p.add_argument("--kmer_len", "-x", type=int, default=17)
    p.add_argument("--cent_signals_len", "-y", type=int, default=360)
    p.set_defaults(func=main_binarize)

    p = subparsers.add_parser("filter_label",
                              description="keep rows with a given "
                                          "methy_label")
    p.add_argument("--input_path", "-i", type=str, required=True)
    p.add_argument("--write_path", "-o", type=str, required=True)
    p.add_argument("--label", type=int, default=1, choices=[0, 1])
    p.add_argument("--unique_fid", type=str, default=".tsv")
    p.set_defaults(func=main_filter_label)

    p = subparsers.add_parser(
        "filter_positions",
        description="keep rows whose (chrom,pos) is in a positions file; "
                    "rewrites the label column")
    p.add_argument("--sf_path", "-i", type=str, required=True)
    p.add_argument("--pos_fp", "-p", type=str, required=True)
    p.add_argument("--write_path", "-o", type=str, required=True)
    p.add_argument("--label", type=str, default="1", choices=["0", "1"])
    p.add_argument("--chrom_col", type=int, default=1)
    p.add_argument("--pos_col", type=int, default=2)
    p.add_argument("--unique_fid", type=str, default=".tsv")
    p.set_defaults(func=main_filter_positions)

    p = subparsers.add_parser(
        "select_neg",
        description="select negative samples matching the positive file's "
                    "k-mer distribution")
    p.add_argument("--pos_file", type=str, required=True)
    p.add_argument("--neg_file", type=str, required=True)
    p.add_argument("--write_path", "-o", type=str, required=True)
    p.set_defaults(func=main_select_neg)

    p = subparsers.add_parser("kmer_dist",
                              description="write the k-mer distribution of "
                                          "a feature file")
    p.add_argument("--feafile", "-i", type=str, required=True)
    p.set_defaults(func=main_kmer_dist)

    p = subparsers.add_parser("randsel",
                              description="random row subsampling of a file")
    p.add_argument("--ori_filepath", "-i", type=str, required=True)
    p.add_argument("--write_filepath", "-o", type=str, required=True)
    p.add_argument("--write_other_filepath", type=str, default=None)
    p.add_argument("--num_lines", type=int, default=100000000)
    p.add_argument("--header", type=str, default="no")
    p.set_defaults(func=main_randsel)

    p = subparsers.add_parser("shuffle",
                              description="external-memory shuffle of a "
                                          "big file")
    p.add_argument("--fp", "-i", type=str, required=True)
    p.add_argument("--num_lines_shuffle", type=int, default=3000000)
    p.add_argument("--temp_dir", type=str, default="/tmp")
    p.set_defaults(func=main_shuffle)

    p = subparsers.add_parser("concat",
                              description="streaming shuffle-concat of two "
                                          "files")
    p.add_argument("--fp1", type=str, required=True)
    p.add_argument("--fp2", type=str, required=True)
    p.add_argument("--concated_fp", "-o", type=str, required=True)
    p.add_argument("--shuffle_lines_num", type=int, default=2000000)
    p.add_argument("--header", type=str, default="no")
    p.set_defaults(func=main_concat)

    p = subparsers.add_parser("visualize_log",
                              description="plot train/valid metric curves")
    p.add_argument("--log_dir", "-i", type=str, required=True)
    p.add_argument("--out_fp", "-o", type=str, default=None)
    p.set_defaults(func=main_visualize_log)
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if getattr(args, "func", None) is None:
        parser.print_help()
        return 1
    return args.func(args) or 0


if __name__ == "__main__":
    sys.exit(main())
