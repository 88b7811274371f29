"""The reader of merged_conv_share.call on hand-built records: the share of
the Inception blocks of the card's inference forwards in the window that
ran their five 1x1 convs as one, and None where the program counts neither
path."""

import pytest

from tiny import BENCH

W0, W1 = 100.0, 110.0   # the synthetic measured window
NAME = "merged_conv_share.call"


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


def test_merged_counts_alone_read_100(program_record):
    for at in (101.0, 102.0, 103.0):
        program_record.add_count("conv.merged", at, 11)
    program_record.add_count("conv.split", 99.0, 11)  # before the window
    assert _reader().read({"window": (W0, W1)}, None) == 100.0


def test_split_blocks_in_the_window_lower_the_share(program_record):
    for at in (101.0, 102.0, 103.0):
        program_record.add_count("conv.merged", at, 11)
    program_record.add_count("conv.split", 104.0, 11)
    program_record.add_count("conv.merged", 111.0, 11)  # after the window
    assert _reader().read({"window": (W0, W1)}, None) == pytest.approx(75.0)


def test_no_counts_read_nothing(program_record):
    program_record.add_count("conv.merged", 111.0, 11)  # after the window
    assert _reader().read({"window": (W0, W1)}, None) is None
