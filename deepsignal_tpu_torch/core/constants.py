"""Alphabet tables, the IUPAC motif grammar and sequence helpers (port of
deepsignal_tpu/core/constants.py; deepsignal/utils/process_utils.py:12-143).

The motif-site scan is vectorized with numpy: a base-5 hash of every
window, matched against the hashed motif set.
"""

from __future__ import annotations

import numpy as np

BASE2CODE_DNA = {"A": 0, "C": 1, "G": 2, "T": 3, "N": 4}
CODE2BASE_DNA = {v: k for k, v in BASE2CODE_DNA.items()}
BASE2CODE_RNA = {"A": 0, "C": 1, "G": 2, "U": 3, "N": 4}
CODE2BASE_RNA = {v: k for k, v in BASE2CODE_RNA.items()}

KEY_SEP = "||"  # position-file / site-key separator (extract_features.py:32)


def str2bool(v: str) -> bool:
    """CLI boolean-flag convention of the reference (process_utils.py:52-54)."""
    return str(v).lower() in ("yes", "true", "t", "1")


# --- complement pairs incl. IUPAC letters (process_utils.py:12-19) ---------
BASEPAIRS_DNA = {
    "A": "T", "C": "G", "G": "C", "T": "A", "N": "N",
    "W": "W", "S": "S", "M": "K", "K": "M", "R": "Y",
    "Y": "R", "B": "V", "V": "B", "D": "H", "H": "D",
    "Z": "Z",
}
BASEPAIRS_RNA = {
    "A": "U", "C": "G", "G": "C", "U": "A", "N": "N",
    "W": "W", "S": "S", "M": "K", "K": "M", "R": "Y",
    "Y": "R", "B": "V", "V": "B", "D": "H", "H": "D",
    "Z": "Z",
}

# --- IUPAC degenerate-letter expansions (process_utils.py:26-37) -----------
IUPAC_DNA = {
    "A": ["A"], "T": ["T"], "C": ["C"], "G": ["G"],
    "R": ["A", "G"], "M": ["A", "C"], "S": ["C", "G"],
    "Y": ["C", "T"], "K": ["G", "T"], "W": ["A", "T"],
    "B": ["C", "G", "T"], "D": ["A", "G", "T"],
    "H": ["A", "C", "T"], "V": ["A", "C", "G"],
    "N": ["A", "C", "G", "T"],
}
IUPAC_RNA = {
    "A": ["A"], "C": ["C"], "G": ["G"], "U": ["U"],
    "R": ["A", "G"], "M": ["A", "C"], "S": ["C", "G"],
    "Y": ["C", "U"], "K": ["G", "U"], "W": ["A", "U"],
    "B": ["C", "G", "U"], "D": ["A", "G", "U"],
    "H": ["A", "C", "U"], "V": ["A", "C", "G"],
    "N": ["A", "C", "G", "U"],
}

# 256-entry ASCII -> code lookup used by the vectorized encoders.  Unknown
# characters map to the N code (4), matching `_alphabet`'s N fallback
# (process_utils.py:57-60).
_DNA_CODE_LUT = np.full(256, BASE2CODE_DNA["N"], dtype=np.int64)
for _b, _c in BASE2CODE_DNA.items():
    _DNA_CODE_LUT[ord(_b)] = _c
_RNA_CODE_LUT = np.full(256, BASE2CODE_RNA["N"], dtype=np.int64)
for _b, _c in BASE2CODE_RNA.items():
    _RNA_CODE_LUT[ord(_b)] = _c


def complement_seq(base_seq: str, seq_type: str = "DNA") -> str:
    """Reverse-complement of a sequence (process_utils.py:63-75).

    Unknown letters become 'N'.
    """
    if seq_type == "DNA":
        pairs = BASEPAIRS_DNA
    elif seq_type == "RNA":
        pairs = BASEPAIRS_RNA
    else:
        raise ValueError("the seq_type must be DNA or RNA")
    return "".join(pairs.get(ch, "N") for ch in reversed(base_seq))


def encode_seq(seq: str, is_dna: bool = True) -> np.ndarray:
    """Vectorized base->code encoding; returns an int64 array."""
    raw = np.frombuffer(seq.encode("ascii", errors="replace"), dtype=np.uint8)
    lut = _DNA_CODE_LUT if is_dna else _RNA_CODE_LUT
    return lut[raw]


def decode_seq(codes, is_dna: bool = True) -> str:
    code2base = CODE2BASE_DNA if is_dna else CODE2BASE_RNA
    return "".join(code2base[int(c)] for c in codes)


def _convert_motif_seq(ori_seq: str, is_dna: bool = True) -> list[str]:
    """Expand one IUPAC motif to all concrete sequences
    (process_utils.py:113-134).  Expansion order matches the reference's
    recursive permutation (first letter varies slowest)."""
    table = IUPAC_DNA if is_dna else IUPAC_RNA
    seqs = [""]
    for ch in ori_seq:
        try:
            choices = table[ch]
        except KeyError as e:
            raise KeyError(f"invalid IUPAC letter {ch!r} in motif {ori_seq!r}") from e
        seqs = [s + c for s in seqs for c in choices]
    return seqs


def get_motif_seqs(motifs: str, is_dna: bool = True) -> list[str]:
    """Parse the comma-separated motif string into concrete motif sequences
    (process_utils.py:137-143)."""
    out: list[str] = []
    for ori in motifs.strip().split(","):
        out.extend(_convert_motif_seq(ori.strip().upper(), is_dna))
    return out


def _hash_codes(codes: np.ndarray, motif_len: int) -> np.ndarray:
    """Base-5 positional hash of every length-``motif_len`` window of
    ``codes``; exact (injective) for motif_len <= 26 in int64."""
    n = codes.shape[0] - motif_len + 1
    if n <= 0:
        return np.empty((0,), dtype=np.int64)
    acc = np.zeros(n, dtype=np.int64)
    for j in range(motif_len):
        acc = acc * 5 + codes[j:j + n]
    return acc


def motif_sites_in_seq(seq, motif_seqs, mod_loc: int = 0,
                       is_dna: bool = True) -> np.ndarray:
    """0-based positions of the modified base for every motif occurrence.

    Vectorized equivalent of ``get_refloc_of_methysite_in_motif``
    (process_utils.py:95-110): scans with a rolling exact hash and matches
    against the hashed motif set.  All motifs must share one length (the
    reference implicitly assumes this by reading len() of an arbitrary set
    element).

    ``seq`` may be a str or an already-encoded int array.
    """
    motif_seqs = list(motif_seqs)
    if not motif_seqs:
        return np.empty((0,), dtype=np.int64)
    motif_len = len(motif_seqs[0])
    for m in motif_seqs:
        if len(m) != motif_len:
            raise ValueError("all motifs must have the same length")
    codes = encode_seq(seq, is_dna) if isinstance(seq, str) else np.asarray(seq, dtype=np.int64)
    window_hash = _hash_codes(codes, motif_len)
    motif_hash = np.fromiter(
        (_hash_codes(encode_seq(m, is_dna), motif_len)[0] for m in motif_seqs),
        dtype=np.int64, count=len(motif_seqs))
    hits = np.flatnonzero(np.isin(window_hash, motif_hash))
    return hits + mod_loc
