"""Work of the Inception CNN (the signal branch) at batch ``batch``: two
operations per multiply-add of every convolution, at its output length;
batch norm, relu, pooling and concatenation are not counted.  Bytes: the
central signals, every convolution and batch-norm parameter, and the
flattened output, each once."""

from dsbench.spec import load


def count(cfg: dict, batch: int, elem: int) -> tuple:
    """(operations, bytes) of one call; ``elem`` bytes a value."""
    if not cfg["is_cnn"]:
        return 0, 0
    convs, lengths, length, ch = load("references",
                                      "deepsignal").inception_plan(cfg)
    flops = sum(2 * batch * cout * cin * k * n
                for (_, cin, cout, k, _), n in zip(convs, lengths))
    params = sum(cout * cin * k + 4 * cout for _, cin, cout, k, _ in convs)
    nbytes = (batch * cfg["cent_signals_len"] + params
              + batch * length * ch) * elem
    return flops, nbytes
