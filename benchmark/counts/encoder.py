"""Work of the BiLSTM encoder (the event branch) at batch ``batch``: the
layer-0 input projection of both directions, then ``kmer_len`` steps of
every layer-direction's products (layer 0 its recurrent product alone,
upper layers input and recurrent); the gate math is not counted.  Bytes:
the fusion input, every kernel and bias, and the [B, 2H] output, each
once."""


def count(cfg: dict, batch: int, elem: int) -> tuple:
    """(operations, bytes) of one encoder call; ``elem`` bytes a value."""
    t, h, layers = cfg["kmer_len"], cfg["lstm_hidden"], cfg["lstm_layers"]
    d = 3 + (cfg["embedding_size"] if cfg["is_base"] else 0)
    per_dir = 4 * h * (h + (layers - 1) * 2 * h)
    flops = 2 * batch * t * d * 2 * 4 * h + 2 * t * batch * 2 * per_dir
    weights = 2 * ((d + h) * 4 * h + (layers - 1) * 2 * h * 4 * h) \
        + 2 * layers * 4 * h
    return flops, (batch * t * d + weights + batch * 2 * h) * elem
