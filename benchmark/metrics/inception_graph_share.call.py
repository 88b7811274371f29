"""inception_graph_share.call: share (%) of Inception's inference forwards
on the card in the measured window that replayed its CUDA graph
(``inception.graph_replay``), not the eager forward (``inception.eager``);
None where the program counts neither."""

from dsbench.program import counted


def read(res, cell):
    graph = sum(counted(res, "inception.graph_replay") or [])
    eager = sum(counted(res, "inception.eager") or [])
    return 100.0 * graph / (graph + eager) if graph + eager else None
