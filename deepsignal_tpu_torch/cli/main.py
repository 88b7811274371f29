"""deepsignal-tpu-torch command line: the ``call_mods`` subcommand.

Flag names and defaults follow ``deepsignal_tpu``'s CLI (and the
reference's); ``--device`` (default ``cuda``) is new.  Torch is imported
only inside the handler.
"""

from __future__ import annotations

import argparse
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


def main_call_mods(args) -> None:
    display_args(args)
    from ..core.config import FeatureConfig, ModelConfig
    from ..runtime.caller import run_call_mods
    feature_cfg = FeatureConfig(is_dna=str2bool(args.is_dna))
    override = None
    if args.is_cnn is not None:
        override = ModelConfig(
            kmer_len=args.kmer_len, cent_signals_len=args.cent_signals_len,
            class_num=args.class_num, is_cnn=str2bool(args.is_cnn),
            is_rnn=str2bool(args.is_rnn), is_base=str2bool(args.is_base))
    run_call_mods(args.input_path, args.model_path, args.result_file,
                  feature_cfg, batch_size=args.batch_size,
                  f5_batch_num=args.f5_batch_num,
                  model_cfg_override=override,
                  compute_dtype=args.compute_dtype, device=args.device)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="deepsignal-tpu-torch",
        description="deepsignal-tpu-torch: detection of DNA methylation "
                    "state from Oxford Nanopore reads, in PyTorch on CUDA")
    subparsers = parser.add_subparsers(title="modules", dest="command")

    p = subparsers.add_parser("call_mods", description="call modifications")
    p.add_argument("--input_path", "-i", type=str, required=True,
                   help="feature TSV from extract (fast5 input is not yet "
                        "ported)")
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
    p.add_argument("--f5_batch_num", type=int, default=50,
                   help="reads per feature batch, default 50")
    p.add_argument("--compute_dtype", type=str, default=None,
                   choices=["float32", "bfloat16"],
                   help="bfloat16 = fast path (default), float32 = "
                        "reference-parity mode")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device, default cuda; 'cpu' runs the plain "
                        "versions of the kernels")
    p.add_argument("--is_dna", type=str, default="yes",
                   help="whether the features come from a DNA sample; set "
                        "no for RNA. default yes")
    p.add_argument("--kmer_len", "-x", type=int, default=17,
                   help="len of kmer. default 17")
    p.add_argument("--cent_signals_len", "-y", type=int, default=360,
                   help="central signal points used. default 360")
    p.set_defaults(func=main_call_mods)
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if getattr(args, "func", None) is None:
        parser.print_help()
        return 1
    args.func(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
