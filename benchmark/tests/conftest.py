import sys

import pytest

from tiny import BENCH, REPO

for path in (str(REPO), str(BENCH)):
    if path not in sys.path:
        sys.path.insert(0, path)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, at run time, never at import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A tiny copy of the benchmark (``tiny.tiny_tree``)."""
    from tiny import tiny_tree
    return tiny_tree(tmp_path_factory.mktemp("tinybench"))
