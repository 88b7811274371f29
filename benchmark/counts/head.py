"""Work of the joint head at batch ``batch``: fc1 (joint x joint) and fc2
(joint x classes), two operations per multiply-add.  Bytes: the joint
input, both weights and the logits, each once."""

from dsbench.spec import load


def count(cfg: dict, batch: int, elem: int) -> tuple:
    """(operations, bytes) of one call; ``elem`` bytes a value."""
    dim = load("references", "deepsignal").joint_dim(cfg)
    classes = cfg["class_num"]
    flops = 2 * batch * dim * (dim + classes)
    return flops, (batch * dim + dim * (dim + classes)
                   + batch * classes) * elem
