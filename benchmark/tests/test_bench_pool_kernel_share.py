"""The reader of pool_kernel_share.call on hand-built records: the share of
the max-pools of Inception's inference forwards on the card in the window
that ran the hand-written kernel, and None where the program counts neither
path."""

import pytest

from tiny import BENCH

W0, W1 = 100.0, 110.0   # the synthetic measured window
NAME = "pool_kernel_share.call"


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
        program_record.add_count("pool.kernel", at, 14)
    program_record.add_count("pool.plain", 99.0, 14)  # before the window
    assert _reader().read({"window": (W0, W1)}, None) == 100.0


def test_plain_pools_in_the_window_lower_the_share(program_record):
    for at in (101.0, 102.0, 103.0):
        program_record.add_count("pool.kernel", at, 14)
    program_record.add_count("pool.plain", 104.0, 14)
    program_record.add_count("pool.kernel", 111.0, 14)  # after the window
    assert _reader().read({"window": (W0, W1)}, None) == pytest.approx(75.0)


def test_no_counts_read_nothing(program_record):
    program_record.add_count("pool.kernel", 111.0, 14)  # after the window
    assert _reader().read({"window": (W0, W1)}, None) is None
