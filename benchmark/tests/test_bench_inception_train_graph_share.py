"""The reader of inception_train_graph_share.train on hand-built records:
the share of Inception's training forwards on the card in the window that
replayed its CUDA graphs, and None where the program counts neither path
or keeps no record."""

import pytest

from tiny import BENCH

W0, W1 = 100.0, 110.0   # the synthetic measured window
NAME = "inception_train_graph_share.train"


def _reader():
    from dsbench import spec
    return spec.load("metrics", NAME, str(BENCH))


@pytest.fixture
def program_record(monkeypatch):
    from deepsignal_tpu_torch.core.logging import Record
    from dsbench import program
    rec = Record()
    monkeypatch.setattr(program, "record", lambda: rec)
    return rec


def test_replays_alone_read_100(program_record):
    for at in (101.0, 102.0, 103.0):
        program_record.add_count("inception.train_graph_replay", at, 1)
    program_record.add_count("inception.train_eager", 99.0, 1)  # before it
    assert _reader().read({"window": (W0, W1)}, None) == 100.0


def test_eager_forwards_in_the_window_lower_the_share(program_record):
    for at in (101.0, 102.0, 103.0):
        program_record.add_count("inception.train_graph_replay", at, 1)
    program_record.add_count("inception.train_eager", 104.0, 1)
    program_record.add_count("inception.train_graph_replay", 111.0, 1)
    assert _reader().read({"window": (W0, W1)}, None) == pytest.approx(75.0)


def test_inference_counts_are_not_training_forwards(program_record):
    program_record.add_count("inception.graph_replay", 101.0, 1)
    program_record.add_count("inception.eager", 102.0, 1)
    assert _reader().read({"window": (W0, W1)}, None) is None


def test_no_counts_read_nothing(program_record):
    program_record.add_count("inception.train_graph_replay", 111.0, 1)
    assert _reader().read({"window": (W0, W1)}, None) is None


def test_a_program_without_a_record_reads_nothing(monkeypatch):
    from dsbench import program
    monkeypatch.setattr(program, "record", lambda: None)
    assert _reader().read({"window": (W0, W1), "trace": None}, None) is None
