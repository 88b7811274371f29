"""FASTA reference reading (port of deepsignal_tpu/io/fasta.py;
deepsignal/utils/ref_reader.py:33-57): sequences upper-cased, the contig
name the first space-delimited word after '>', contigs in file order."""

from __future__ import annotations


def read_fasta(ref_path: str) -> dict[str, str]:
    """Parse a FASTA file into an ordered contig-name -> sequence map."""
    contigs: dict[str, str] = {}
    name = None
    parts: list[str] = []
    with open(ref_path, "r") as rf:
        for line in rf:
            if line.startswith(">"):
                if name is not None and parts:
                    contigs[name] = "".join(parts)
                name = line.strip()[1:].split(" ")[0]
                parts = []
            else:
                parts.append(line.strip().upper())
    if name is not None:
        contigs[name] = "".join(parts)
    return contigs


def get_contig2len(ref_path: str) -> dict[str, int]:
    """contig name -> length map (ref_reader.py:7-13)."""
    return {name: len(seq) for name, seq in read_fasta(ref_path).items()}
