"""The writer process of the TSV cells: it makes the traffic's block of
feature rows from the seed and writes it into a named pipe again and
again, until the reading side closes.  It imports numpy and the
generator only."""

from __future__ import annotations

from . import traffic


def block_for(seed: int, cfg: dict, params: dict) -> bytes:
    """The block of ``params["block_rows"]`` rows the writer repeats."""
    return traffic.tsv_block(traffic.rows(seed, params["block_rows"], cfg,
                                          params, text=True))


def write_forever(fifo: str, seed: int, cfg: dict, params: dict) -> None:
    """Open ``fifo`` for writing and write the block into it until the
    reader goes away, which ends the writer without an error."""
    block = memoryview(block_for(seed, cfg, params))
    try:
        with open(fifo, "wb", buffering=0) as f:
            while True:
                view = block
                while view:
                    view = view[f.write(view):]
    except BrokenPipeError:
        pass
