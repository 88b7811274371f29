"""Alphabet tables (deepsignal/utils/process_utils.py:21-24,52-54)."""

from __future__ import annotations

BASE2CODE_DNA = {"A": 0, "C": 1, "G": 2, "T": 3, "N": 4}
CODE2BASE_DNA = {v: k for k, v in BASE2CODE_DNA.items()}
BASE2CODE_RNA = {"A": 0, "C": 1, "G": 2, "U": 3, "N": 4}
CODE2BASE_RNA = {v: k for k, v in BASE2CODE_RNA.items()}

KEY_SEP = "||"  # position-file / site-key separator (extract_features.py:32)


def str2bool(v: str) -> bool:
    """CLI boolean-flag convention of the reference (process_utils.py:52-54)."""
    return str(v).lower() in ("yes", "true", "t", "1")
