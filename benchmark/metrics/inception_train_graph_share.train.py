"""inception_train_graph_share.train: share (%) of Inception's training
forwards on the card in the measured window that replayed its CUDA graphs
(``inception.train_graph_replay``), not the eager forward
(``inception.train_eager``); None where the program counts neither."""

from dsbench.program import counted


def read(res, cell):
    graph = sum(counted(res, "inception.train_graph_replay") or [])
    eager = sum(counted(res, "inception.train_eager") or [])
    return 100.0 * graph / (graph + eager) if graph + eager else None
