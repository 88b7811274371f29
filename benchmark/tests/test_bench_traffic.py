"""The traffic generator: the same seed gives the same inputs, another
seed the same work in another order, and the pipe writer streams whole
rows, block after block."""

import os

import numpy as np

from dsbench import pipe_writer, traffic

CFG = {"kmer_len": 17, "cent_signals_len": 360}
PARAMS = {"reads": {"median": 60, "sigma": 1.2, "max": 5000},
          "signals_per_base": 9, "block_rows": 1500}
BIG = 2**31 + 12345


def test_same_seed_same_inputs():
    a = traffic.rows(BIG, 3000, CFG, PARAMS, text=True)
    b = traffic.rows(BIG, 3000, CFG, PARAMS, text=True)
    for k in ("kmer", "means", "stds", "lens", "signals", "labels"):
        assert np.array_equal(a[k], b[k]), k
    assert a["sampleinfo"] == b["sampleinfo"]
    assert traffic.tsv_block(a) == traffic.tsv_block(b)


def test_another_seed_same_work_in_another_order():
    a = traffic.rows(BIG, 3000, CFG, PARAMS)
    b = traffic.rows(BIG + 1, 3000, CFG, PARAMS)
    assert not np.array_equal(a["signals"], b["signals"])
    assert sorted(a["read_sizes"]) == sorted(b["read_sizes"])
    assert list(a["read_sizes"]) != list(b["read_sizes"])
    assert a["labels"].sum() == b["labels"].sum() == 1500


def test_reads_are_heavy_tailed_and_fill_the_rows():
    sizes = traffic.read_sizes(20000, PARAMS["reads"])
    assert sizes.sum() == 20000
    assert 50 <= np.median(sizes) <= 70
    assert sizes.max() >= 1000


def test_rows_of_a_read_are_contiguous():
    d = traffic.rows(7, 3000, CFG, PARAMS)
    names = [s.split("\t")[4] for s in d["sampleinfo"]]
    runs = [n for i, n in enumerate(names) if i == 0 or n != names[i - 1]]
    assert len(runs) == len(set(runs)) == len(d["read_sizes"])


def test_text_parses_to_the_arrays():
    from deepsignal_tpu_torch.io.feature_codec import parse_feature_bytes
    d = traffic.rows(11, 500, CFG, PARAMS, text=True)
    fb = parse_feature_bytes(traffic.tsv_block(d))
    assert fb.sampleinfo == d["sampleinfo"]
    for got, want in ((fb.kmers, d["kmer"]), (fb.means, d["means"]),
                      (fb.stds, d["stds"]), (fb.lens, d["lens"]),
                      (fb.signals, d["signals"]), (fb.labels, d["labels"])):
        assert np.array_equal(got, want)


def test_pipe_writer_streams_whole_blocks(tmp_path):
    import multiprocessing as mp
    fifo = str(tmp_path / "features.tsv")
    os.mkfifo(fifo)
    block = pipe_writer.block_for(BIG, CFG, PARAMS)
    writer = mp.get_context("spawn").Process(
        target=pipe_writer.write_forever, args=(fifo, BIG, CFG, PARAMS))
    writer.start()
    got = bytearray()
    with open(fifo, "rb") as f:
        while len(got) < 2 * len(block) + len(block) // 2:
            got += f.read(1 << 20)
    writer.join(timeout=30)
    assert not writer.is_alive() and writer.exitcode == 0
    assert got[:2 * len(block)] == block * 2
    assert block.endswith(b"\n") and block.count(b"\n") == 1500
    lines = block.split(b"\n")
    first, last = lines[0].split(b"\t")[4], lines[-2].split(b"\t")[4]
    assert first != last  # the next block starts a new read
