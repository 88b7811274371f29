"""Work of the whole forward at batch ``batch``: the encoder, the
Inception CNN and the joint head (the embedding gather does no
operation).  Bytes: the sum of the three parts' bytes."""

from dsbench.spec import load


def count(cfg: dict, batch: int, elem: int) -> tuple:
    """(operations, bytes) of one forward; ``elem`` bytes a value."""
    parts = [load("counts", n).count(cfg, batch, elem)
             for n in ("encoder", "inception", "head") if
             n != "encoder" or cfg["is_rnn"]]
    return sum(p[0] for p in parts), sum(p[1] for p in parts)
