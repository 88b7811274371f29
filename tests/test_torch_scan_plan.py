"""The per-layer scan kernel's launch plan, on the CPU: the variant and
shape ``ops/cuda/lstm_scan.py::scan_plan`` hands the kernel for every
batch and hidden size, the L2 weight bytes it implies, and the identity the
kernel's bias add relies on.  The kernel itself is held against its plain
version on the card, in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from deepsignal_tpu_torch.ops import bilstm
from deepsignal_tpu_torch.ops.cuda import lstm_scan

torch.set_num_threads(1)

DTYPES = [torch.float32, torch.bfloat16]
ELEM = {torch.float32: 4, torch.bfloat16: 2}
# clusters of the resident kernel an H100 SXM (132 SMs) runs at once, by
# CTAs per cluster, as cudaOccupancyMaxActiveClusters reports there
H100_ACTIVE_CLUSTERS = {2: 66, 4: 30, 8: 15}


def h100_plan(batch, hidden, dtype):
    units = lstm_scan.UNITS_PER_CTA[dtype]
    at_once = (H100_ACTIVE_CLUSTERS[hidden // units]
               if hidden in lstm_scan.RESIDENT_HIDDEN else None)
    return lstm_scan.scan_plan(batch, hidden, dtype, at_once), at_once


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hidden", [16, 100, 128, 256, 512])
@pytest.mark.parametrize("batch", [1, 4, 9, 300, 512, 4096])
def test_scan_plan_fits_every_shape(batch, hidden, dtype):
    plan, at_once = h100_plan(batch, hidden, dtype)
    elem = ELEM[dtype]
    rows, cluster = plan["rows"], plan["cluster"]
    assert plan["smem_bytes"] <= lstm_scan.SMEM_LIMIT == 232_448
    assert 1 <= cluster <= 8
    if hidden not in (128, 256):
        assert plan["variant"] == "streaming"
        tiles = plan["grid"][0]
        assert cluster == 1 and plan["threads"] == hidden <= 1024
        assert tiles * rows >= batch > (tiles - 1) * rows
        return
    assert plan["variant"] == "resident"
    ranks, tiles = plan["grid"]
    # the grid covers the batch with no empty tile; one cluster rank per
    # block of hidden units
    assert tiles * rows >= batch > (tiles - 1) * rows
    assert ranks == cluster == hidden // plan["units"]
    assert plan["threads"] == 256
    # a CTA holds exactly its H x cols slice of W_h, the slices of the
    # cluster make up W_h, and h of the tile is double-buffered beside it
    assert plan["cols"] == 4 * plan["units"]
    assert plan["w_slice_bytes"] == hidden * plan["cols"] * elem
    assert cluster * plan["w_slice_bytes"] == hidden * 4 * hidden * elem
    assert plan["smem_bytes"] == (plan["w_slice_bytes"]
                                  + 2 * rows * hidden * elem + 8)
    # bfloat16 rows are whole m16 tiles, float32 rows 8 per warp
    assert rows % (16 if dtype == torch.bfloat16 else 8) == 0
    # the smallest built tile whose clusters run in one wave
    fits = [r for r in lstm_scan.ROW_TILES[dtype] if -(-batch // r) <= at_once]
    assert rows == (fits[0] if fits else lstm_scan.ROW_TILES[dtype][-1])


@pytest.mark.parametrize("dtype", DTYPES)
def test_scan_plan_at_the_train_shape(dtype):
    """B 512, H 256: one wave, with the tile and the shared-memory sum the
    kernel's source note gives."""
    plan, at_once = h100_plan(512, 256, dtype)
    want = {torch.bfloat16: (32, 4, (4, 16), 163_848),
            torch.float32: (40, 8, (8, 13), 213_000)}[dtype]
    assert (plan["rows"], plan["cluster"], plan["grid"],
            plan["smem_bytes"]) == want
    assert plan["w_slice_bytes"] == 128 * 1024
    assert plan["grid"][1] <= at_once


@pytest.mark.parametrize("dtype, at_once, rows", [
    (torch.bfloat16, 32, 16), (torch.bfloat16, 16, 32),
    (torch.bfloat16, 8, 32), (torch.bfloat16, 4, 32),
    (torch.float32, 16, 32), (torch.float32, 13, 40),
    (torch.float32, 10, 40)])
def test_scan_plan_follows_the_cards_cluster_count(dtype, at_once, rows):
    # B 512 in one wave of `at_once` clusters if a built tile allows it,
    # else the largest tile
    assert lstm_scan.scan_plan(512, 256, dtype, at_once)["rows"] == rows


@pytest.mark.parametrize("dtype", DTYPES)
def test_l2_weight_bytes_at_the_train_shape(dtype):
    """A resident cluster reads W_h once per launch: 16 x 512 KB in
    bfloat16, 13 x 1 MB in float32 at B 512, H 256; the streaming kernel
    reads it in every CTA at every step, 128 x 17 x |W_h|."""
    w_h = 256 * 1024 * ELEM[dtype]
    plan, _ = h100_plan(512, 256, dtype)
    clusters = {torch.bfloat16: 16, torch.float32: 13}[dtype]
    assert lstm_scan.l2_weight_bytes(plan, 17, 256, dtype) == clusters * w_h
    assert lstm_scan.l2_weight_bytes(plan, 17, 256, dtype) <= 16 * 2 ** 20
    streaming = lstm_scan.streaming_plan(512, 256)
    assert lstm_scan.l2_weight_bytes(streaming, 17, 256, dtype) == (
        128 * 17 * w_h)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hidden", [128, 256])
@pytest.mark.parametrize("at_once", [0, None])
def test_scan_plan_refuses_a_card_without_room(at_once, hidden, dtype):
    """A card that runs no resident cluster (count 0) gets an error that
    names the cause, not a plan; the streaming variant needs no count."""
    with pytest.raises(RuntimeError, match="runs no cluster"):
        lstm_scan.scan_plan(512, hidden, dtype, at_once)
    assert lstm_scan.scan_plan(512, 100, dtype, at_once)["variant"] == (
        "streaming")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_bias_add_in_float32_equals_torch_add(scale, dtype):
    """The kernel adds the bias to x @ W_x as round(float(p) + float(b)):
    that is what torch's `p + b` gives for two tensors of the storage
    type."""
    rng = np.random.default_rng(int(scale * 1000) % 997)

    def mk(*shape):
        return torch.from_numpy(
            rng.normal(0, scale, shape).astype(np.float32)).to(dtype)

    p, b = mk(17, 1024), mk(1024)
    want = p + b
    got = (p.float() + b.float()).to(dtype)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("depth", [131, 256])
def test_input_product_is_the_plain_product_on_the_cpu(depth, dtype):
    """``input_product`` pads only a bfloat16 depth on the card; on the CPU
    it is ``x @ w`` bit for bit, and ``layer0_product`` is it on the
    concatenated directions."""
    rng = np.random.default_rng(depth)
    x = torch.from_numpy(rng.normal(0, 1, (3, 5, depth)).astype(
        np.float32)).to(dtype)
    kf, kb = (torch.from_numpy(rng.normal(0, 0.1, (depth + 8, 32)).astype(
        np.float32)).to(dtype) for _ in range(2))
    x2 = x.reshape(15, depth)
    assert torch.equal(bilstm.input_product(x2, kf[:depth]), x2 @ kf[:depth])
    both = bilstm.layer0_product(x, kf, kb)
    assert torch.equal(both.reshape(15, 64),
                       x2 @ torch.cat([kf[:depth], kb[:depth]], dim=1))
