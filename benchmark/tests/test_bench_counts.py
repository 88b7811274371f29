"""The counting functions against counts made by hand."""


from dsbench import spec

CPG = {"kmer_len": 17, "cent_signals_len": 360, "class_num": 2,
       "vocab_size": 1024, "embedding_size": 128, "lstm_hidden": 256,
       "lstm_layers": 3, "inception_times": 16,
       "inception_blocks": [3, 5, 3], "is_cnn": True, "is_rnn": True,
       "is_base": True}
RNN = dict(CPG, is_cnn=False, is_base=False)


def count(part, cfg, batch, elem):
    return spec.load("counts", part).count(cfg, batch, elem)


def test_encoder_bound_is_chip_smokes():
    # chip_smoke.encoder_bound_ms at B=4096, T=17, D=131, H=256, bf16
    b, t, d, h = 4096, 17, 131, 256
    flops = 2 * b * t * d * 8 * h + 2 * t * b * 2 * 4 * h * (h + 4 * h)
    weights = 2 * ((d + h) + 4 * h) * 4 * h + 2 * 3 * 4 * h
    got = count("encoder", CPG, b, 2)
    assert got == (flops, (b * t * d + weights + b * 2 * h) * 2)
    assert abs(got[0] / 989e12 * 1e3 - 0.407) < 5e-4


def test_encoder_at_depth_3():
    b, t, h = 512, 17, 256
    flops = 2 * b * t * 3 * 8 * h + 2 * t * b * 2 * 4 * h * 5 * h
    assert count("encoder", RNN, b, 4)[0] == flops


def test_inception_by_hand():
    # stem: 7/2 over 360 -> 180, 1x1 and 3 over 90; blocks at 90, 45, 23
    t = 16
    stem = 2 * (64 * 1 * 7 * 180 + 128 * 64 * 90 + 256 * 128 * 3 * 90)

    def block(cin, n):
        macs = (3 * t * cin + 3 * t * cin + 2 * t * cin + 3 * t * 2 * t * 3
                + 2 * t * cin + 3 * t * 2 * t * 5 + 3 * t * cin + 2 * t * cin
                + 4 * t * 2 * t * 3 + 3 * t * 4 * t)
        return 2 * macs * n
    want = stem + block(256, 90) + 2 * block(240, 90) + 5 * block(240, 45) \
        + 3 * block(240, 23)
    assert count("inception", CPG, 1, 2)[0] == want
    assert abs(want / 1e9 - 0.109) < 1e-3
    assert count("inception", RNN, 1, 4) == (0, 0)


def test_head_and_model():
    assert count("head", CPG, 1, 2)[0] == 2 * 6032 * (6032 + 2)
    assert count("head", RNN, 1, 4)[0] == 2 * 512 * 514
    total = sum(count(p, CPG, 3, 2)[0] for p in ("encoder", "inception",
                                                 "head"))
    assert count("model", CPG, 3, 2)[0] == total
    assert abs(count("model", CPG, 1, 2)[0] / 1e9 - 0.280) < 1e-3


def test_bytes_count_each_tensor_once():
    f1, b1 = count("head", CPG, 1, 2)
    f2, b2 = count("head", CPG, 2, 2)
    assert b2 - b1 == (6032 + 2) * 2  # one more row in, one more out
