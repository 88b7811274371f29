"""The port's multi-GPU helpers on the CPU, in one process, held against the
JAX package's ``parallel/`` and ``host_shard`` (the two-rank runs are in
``tests/test_torch_multiprocess.py``)."""

import os
import random
import socket
import sys

import jax
import numpy as np
import pytest
import torch

from deepsignal_tpu.core.config import ModelConfig as JaxModelConfig
from deepsignal_tpu.io.feature_codec import \
    iter_feature_batches_by_read as jax_iter_by_read
from deepsignal_tpu.models.deepsignal import init_model
from deepsignal_tpu.parallel import dist as jax_dist
from deepsignal_tpu.parallel import mesh as jax_mesh
from deepsignal_tpu_torch.core.config import FeatureConfig, ModelConfig, \
    TrainConfig
from deepsignal_tpu_torch.core.device import resolve_device
from deepsignal_tpu_torch.io import native
from deepsignal_tpu_torch.io.fast5 import synthetic_read
from deepsignal_tpu_torch.io.feature_codec import \
    iter_feature_batches_by_read
from deepsignal_tpu_torch.models.deepsignal import DeepSignalNet
from deepsignal_tpu_torch.parallel import dist, mesh
from deepsignal_tpu_torch.runtime.pipeline import stream_read_feature_batches
from deepsignal_tpu_torch.train.checkpoints import _flax_path
from deepsignal_tpu_torch.train.trainer import Trainer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_tiny as tt  # noqa: E402

torch.set_num_threads(1)

TINY = dict(lstm_hidden=8, lstm_layers=1, inception_times=1,
            inception_blocks=(1, 1, 1), cent_signals_len=24, kmer_len=5)
FIELDS = ("kmers", "means", "stds", "lens", "signals", "labels")


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_shard_file_list_matches_jax(n):
    files = [f"d{i % 3}/f{i}.fast5" for i in range(11)]
    shuffled = files[:]
    random.Random(n).shuffle(shuffled)
    parts = [dist.shard_file_list(shuffled, k, n) for k in range(n)]
    assert parts == [jax_dist.shard_file_list(shuffled, k, n)
                     for k in range(n)]
    assert sorted(f for p in parts for f in p) == sorted(files)
    # without a group the defaults are rank 0 of 1: the whole sorted list
    assert dist.shard_file_list(shuffled) == sorted(files)


def test_shard_output_path_matches_jax():
    for k, n in ((0, 1), (0, 2), (1, 2), (2, 3)):
        assert dist.shard_output_path("/o/calls.tsv", k, n) == \
            jax_dist.shard_output_path("/o/calls.tsv", k, n)
    assert dist.shard_output_path("calls.tsv") == "calls.tsv"


@pytest.mark.parametrize("remove", [False, True])
def test_merge_call_shards_matches_jax(tmp_path, remove):
    out = {}
    for pkg, fn in (("jax", jax_dist.merge_call_shards),
                    ("port", dist.merge_call_shards)):
        d = tmp_path / pkg
        d.mkdir()
        base = str(d / "calls.tsv")
        for k in range(3):
            with open(dist.shard_output_path(base, k, 3), "w") as f:
                f.write("".join(f"r{k}\t{i}\t0.25\n" for i in range(k + 1)))
        assert fn(base, 3, remove_shards=remove) == base
        out[pkg] = (open(base, "rb").read(), sorted(os.listdir(d)))
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1]
    assert (len(out["port"][1]) == 1) == remove


@pytest.mark.parametrize("shape,multiple,axis", [
    ((5, 3), 4, 0), ((8, 3), 4, 0), ((0, 3), 4, 0), ((3, 7), 3, 1),
    ((1,), 16, 0), ((2, 2, 5), 4, 2)])
def test_pad_to_multiple_matches_jax(shape, multiple, axis):
    arr = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    got, n = mesh.pad_to_multiple(arr, multiple, axis)
    want, wn = jax_mesh.pad_to_multiple(arr, multiple, axis)
    assert n == wn == shape[axis]
    np.testing.assert_array_equal(got, want)
    assert got.shape[axis] % multiple == 0


def test_make_mesh_without_a_group():
    assert not dist.group_is_up()
    m = mesh.make_mesh()
    assert m.shape == {mesh.DATA_AXIS: 1, mesh.MODEL_AXIS: 1}
    assert (m.data_group, m.model_group) == (None, None)
    assert not mesh.mesh_is_multiprocess(m)
    # the JAX package's ValueError on a count the model axis does not divide
    with pytest.raises(ValueError, match="not divisible"):
        mesh.make_mesh(n_devices=6, model_parallel=4)
    with pytest.raises(ValueError, match="not divisible"):
        jax_mesh.make_mesh(n_devices=6, model_parallel=4)
    # a mesh spans every rank
    with pytest.raises(ValueError, match="every rank"):
        mesh.make_mesh(n_devices=2)


def test_param_shardings_name_only_fc1():
    model = DeepSignalNet(ModelConfig(**TINY))
    tp = mesh.param_shardings(model, mesh.Mesh(data=1, model=2))
    assert tp.keys() == dict(model.named_parameters()).keys()
    sharded = {k: v for k, v in tp.items() if v != ()}
    assert sharded == {mesh.TP_PARAM: (mesh.MODEL_AXIS, None)}
    assert all(v == () for v in mesh.param_shardings(
        model, mesh.Mesh(data=2, model=1)).values())
    # the JAX package shards the same leaf, on the same (output) axis of
    # its [in, out] kernel
    _, variables = init_model(JaxModelConfig(**TINY))
    specs = jax_mesh.param_shardings(jax_mesh.make_mesh(model_parallel=2),
                                     variables["params"])
    flat = jax.tree_util.tree_flatten_with_path(specs)[0]
    jax_sharded = [tuple(p.key for p in path) for path, s in flat
                   if s.spec != jax.sharding.PartitionSpec()]
    coll, path, perm = _flax_path(mesh.TP_PARAM)
    assert (coll, perm) == ("params", (1, 0)) and jax_sharded == [path]


def test_local_block_is_a_contiguous_block():
    batch = {"a": np.arange(12), "b": np.arange(24).reshape(12, 2)}
    blocks = [mesh.local_block(batch, r, 3) for r in range(3)]
    np.testing.assert_array_equal(blocks[1]["a"], [4, 5, 6, 7])
    for k in batch:
        np.testing.assert_array_equal(
            np.concatenate([b[k] for b in blocks]), batch[k])
    t = torch.arange(8)
    assert mesh.local_block(t, 1, 2).tolist() == [4, 5, 6, 7]
    with pytest.raises(ValueError, match="not divisible by 5"):
        mesh.local_block(batch, 0, 5)


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g.sampleinfo) == list(w.sampleinfo)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))


@pytest.mark.parametrize("n", [1, 2, 3])
def test_host_shard_of_the_tsv_matches_jax(n):
    whole = list(iter_feature_batches_by_read(tt.FEATURES, 2))
    shards = []
    for k in range(n):
        native.parse_feature_block.calls = 0
        got = list(iter_feature_batches_by_read(tt.FEATURES, 2, (k, n)))
        # the batches of other ranks are never parsed
        assert native.parse_feature_block.calls == len(got)
        _assert_batches_equal(got, list(jax_iter_by_read(tt.FEATURES, 2,
                                                         (k, n))))
        _assert_batches_equal(got, whole[k::n])
        shards.append(got)
    assert sorted(r for s in shards for b in s for r in b.sampleinfo) == \
        sorted(r for b in whole for r in b.sampleinfo)


def test_host_shard_of_reads_is_a_stride_over_the_reads():
    rng = np.random.default_rng(5)
    reads = []
    for i in range(5):
        seq = "".join(rng.choice(list("ACGT"), 80))
        lengths = rng.integers(3, 12, 80)
        reads.append(synthetic_read(
            f"rid-{i}", rng.integers(400, 900, int(lengths.sum()) + 4),
            np.concatenate([[0], np.cumsum(lengths)[:-1]]), lengths, seq,
            "chrI", 1000 * i, "+-"[i % 2]))
    cfg = FeatureConfig(kmer_len=5, cent_signals_len=24)

    def rows(host_shard):
        stream = stream_read_feature_batches(reads, cfg, nproc=2,
                                             f5_batch_num=2,
                                             host_shard=host_shard)
        try:
            return sorted(r for fb in stream for r in fb.sampleinfo)
        finally:
            stream.close()

    shards = [rows((k, 2)) for k in range(2)]
    assert {r.split("\t")[4] for r in shards[1]} == {"rid-1", "rid-3"}
    assert sorted(shards[0] + shards[1]) == rows(None)


def test_resolve_device_takes_the_local_rank(monkeypatch):
    current = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert resolve_device(None) == torch.device("cuda")
    # outside torchrun resolving a card changes no process state
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    assert current == []
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    for asked in (None, "cuda"):
        assert resolve_device(asked) == torch.device("cuda", 1)
    # the rank's card becomes the current device (NCCL's communicator)
    assert current == [torch.device("cuda", 1)] * 2
    # an explicit card is kept, and is not made current: two ranks may
    # share one
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    assert current == [torch.device("cuda", 1)] * 2
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="LOCAL_RANK 2 has no card"):
        resolve_device(None)


def test_init_distributed_without_torchrun_makes_no_group(monkeypatch):
    for k in dist.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    with dist.distributed("cpu") as got:
        assert got == (0, 1) and not dist.group_is_up()
    assert dist.rank_and_world() == (0, 1)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_a_world_of_one_trains_as_one_process(monkeypatch):
    """Under torchrun's environment at WORLD_SIZE 1 the group is made (as
    the card's NCCL run at world size 1 makes it), and two steps and an
    eval on its mesh issue no collective (each axis has one rank) and
    equal the same work without a group bit for bit; the group is gone
    after the block."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    rng = np.random.default_rng(3)
    batch = dict(
        kmer=rng.integers(0, 4, (16, 5)).astype(np.int32),
        means=rng.normal(0, 1, (16, 5)).astype(np.float32),
        stds=np.abs(rng.normal(0, 1, (16, 5))).astype(np.float32),
        sanums=rng.integers(1, 30, (16, 5)).astype(np.float32),
        signals=rng.normal(0, 1, (16, 24)).astype(np.float32),
        labels=rng.integers(0, 2, 16).astype(np.int32), __valid__=13)
    tcfg = TrainConfig(batch_size=16, keep_prob=0.5, seed=9)

    def two_steps(m):
        trainer = Trainer(ModelConfig(**TINY), tcfg, device="cpu", mesh=m)
        out = [trainer.train_on_batch(dict(batch), 1e-3) for _ in range(2)]
        out.append(trainer.eval_on_batch(dict(batch)))
        return out, sum(float(p.detach().double().sum())
                        for p in trainer.model.parameters())

    want, want_sum = two_steps(None)
    import torch.distributed as tdist
    collectives = []
    for name in ("all_reduce", "all_gather", "broadcast"):
        real = getattr(tdist, name)
        monkeypatch.setattr(tdist, name, lambda *a, _n=name, _f=real, **k:
                            collectives.append(_n) or _f(*a, **k))
    with dist.distributed("cpu") as got:
        assert got == (0, 1) and dist.group_is_up()
        m = mesh.make_mesh()
        assert m.data_group is not None
        steps, checksum = two_steps(m)
    assert not dist.group_is_up()
    assert collectives == []
    for g, w in zip(steps, want):
        assert g[0] == w[0]
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(a, b)
    assert checksum == want_sum

