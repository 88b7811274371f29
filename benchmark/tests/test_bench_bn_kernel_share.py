"""The reader of bn_kernel_share.call on hand-built records: the share of
the batch norms of Inception's inference forwards on the card in the window
that ran the hand-written kernel, and None where the program counts neither
path or keeps no record."""

import pytest

from tiny import BENCH

W0, W1 = 100.0, 110.0   # the synthetic measured window
NAME = "bn_kernel_share.call"


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


def test_kernel_counts_alone_read_100(program_record):
    for at in (101.0, 102.0, 103.0):
        program_record.add_count("bn.kernel", at, 113)
    program_record.add_count("bn.plain", 99.0, 113)  # before the window
    assert _reader().read({"window": (W0, W1)}, None) == 100.0


def test_plain_batch_norms_in_the_window_lower_the_share(program_record):
    for at in (101.0, 102.0, 103.0):
        program_record.add_count("bn.kernel", at, 113)
    program_record.add_count("bn.plain", 104.0, 113)
    program_record.add_count("bn.kernel", 105.0, 100)
    program_record.add_count("bn.plain", 105.0, 13)
    program_record.add_count("bn.kernel", 111.0, 113)  # after the window
    assert _reader().read({"window": (W0, W1)}, None) == pytest.approx(
        100.0 * 439 / 565)


def test_no_counts_read_nothing(program_record):
    program_record.add_count("bn.kernel", 111.0, 113)  # after the window
    assert _reader().read({"window": (W0, W1)}, None) is None


def test_a_program_without_a_record_reads_nothing(monkeypatch):
    from dsbench import program
    monkeypatch.setattr(program, "record", lambda: None)
    assert _reader().read({"window": (W0, W1), "trace": None}, None) is None
