"""Two real ranks of the port over gloo on the CPU, held against one process.

The module's fixture starts two ranks once, as a user would, with torchrun
(``python -m torch.distributed.run --standalone --nproc_per_node 2
tests/test_torch_multiprocess.py worker <workdir>``, bounded), which make
the process group with ``init_distributed`` and then run:

- sharded ``run_call_mods`` from a synthetic fast5 directory and from the
  golden feature TSV: each rank calls its stride shard and writes
  ``.part<k>-of-2``, issuing no collective;
- 3 data-parallel train steps of a global batch of 16, the last one a padded
  tail, at keep_prob 0.5, on ``make_mesh()``;
- one fc1-tensor-parallel step on ``make_mesh(model_parallel=2)``;
- at keep_prob 1.0 from the JAX package's initial weights: the same 3
  data-parallel steps, one data-parallel step of the padded tail alone (on
  2 ranks one block holds no real row) and one tensor-parallel step;
- ``train()`` on the data-parallel mesh, counting each rank's file writes;
- ``denoise()`` of the RNN-only tiny model on the mesh, counting each
  rank's calls of the functions that write its files.

Each rank writes its numbers to ``worker<rank>.json`` (and the keep_prob
1.0 steps' gradients and weights to ``jax_legs<rank>.npz``); the tests
compare them with the same work done here in one process of the port (the
JAX package's own 2-process test, ``tests/test_multiprocess.py``, allows
the same tolerances) and, for the keep_prob 1.0 steps, with the JAX
package's ``Trainer`` on the same global batches.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TESTS)
import torch_tiny as tt  # noqa: E402

# the JAX package's 2-process test's train widths (tests/test_multiprocess.py)
TRAIN_TINY = dict(lstm_hidden=8, lstm_layers=1, inception_times=1,
                  inception_blocks=(1, 1, 1), cent_signals_len=24,
                  kmer_len=5)
BATCH = 16
STEPS = 3
TRAIN_ROWS = 2 * BATCH + 8     # the third batch is a padded tail
VALID_ROWS = 20
SEED = 7
PROB_TOL_RANKS = 3e-7          # the JAX package's 2-process tolerance
PROB_TOL_GOLDEN = 1e-5         # tests/test_torch_caller.py's PROB_TOL
REL = 1e-5
LR = 1e-3
# the port's step against the JAX step, float32 on the CPU both sides: the
# gradients and the batch-norm statistics within tests/test_torch_train.py's
# TOL (absolute); the weights that Adam moved by its first step within the
# bounds that test derives (1e-6 where |g| > 1e-4, else 2 lr)
JAX_TOL = 1e-5
# the keep_prob 1.0 legs: (name, model_parallel, the batches stepped on, in
# file order); the gradients and weights are those of the first step
JAX_LEGS = (("dp", 1, (0, 1, 2)), ("tail", 1, (2,)), ("tp", 2, (0,)))
WAIT_S = 300                   # each worker takes seconds here


def _make_fast5_dir(d, rng, n_reads=6):
    from deepsignal_tpu_torch.io.fast5 import write_synthetic_fast5
    os.makedirs(d, exist_ok=True)
    for i in range(n_reads):
        n = 120
        seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, n)])
        lengths = rng.integers(3, 20, size=n)
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        raw = rng.integers(400, 900,
                           size=int(lengths.sum()) + 5).astype(np.int16)
        write_synthetic_fast5(
            os.path.join(d, f"r{i}.fast5"), read_id=f"rid-{i}",
            raw_signal=raw, event_starts_rel=starts, event_lengths=lengths,
            seq=seq, mapped_chrom="chrI", mapped_start=1000 * i,
            mapped_strand="+" if i % 2 == 0 else "-")


def _make_binary_file(path, rng, n_rows):
    from deepsignal_tpu_torch.io.feature_codec import binary_record_dtype
    k, s = TRAIN_TINY["kmer_len"], TRAIN_TINY["cent_signals_len"]
    rec = np.zeros(n_rows, dtype=binary_record_dtype(k, s))
    rec["bases"] = rng.integers(0, 4, (n_rows, k))
    rec["means"] = rng.normal(0, 1, (n_rows, k))
    rec["stds"] = np.abs(rng.normal(0, 1, (n_rows, k)))
    rec["lens"] = rng.integers(1, 40, (n_rows, k))
    rec["signals"] = rng.normal(0, 1, (n_rows, s))
    rec["label"] = rng.integers(0, 2, n_rows)
    rec.tofile(path)


def _denoise_rows(rng, n=64, k=5, s=24):
    """Labelled rows whose positives carry a shifted signal, a third of
    them mislabelled (tests/test_torch_denoise.py's recipe)."""
    from deepsignal_tpu_torch.io.feature_codec import format_feature_row
    rows = []
    for i in range(n):
        label = int(rng.integers(0, 2))
        shift = 1.5 if label and rng.random() > 0.3 else -1.5
        rows.append(format_feature_row(
            "chr1", i, "+", i, f"r{i}", "t",
            "".join(rng.choice(list("ACGT"), k)), rng.normal(shift, 0.3, k),
            np.abs(rng.normal(0, 0.3, k)), rng.integers(1, 30, k),
            np.around(rng.normal(shift, 0.3, s), 6), label))
    return "".join(r + "\n" for r in rows)


def _denoise(train_file, mesh=None):
    from deepsignal_tpu_torch.core.config import DenoiseConfig, ModelConfig
    from deepsignal_tpu_torch.train.denoise import denoise
    dcfg = DenoiseConfig(iterations=1, rounds=1, epoch_num=1, batch_size=16)
    cfg = ModelConfig(**dict(TRAIN_TINY, is_cnn=False, is_base=False))
    return denoise(train_file, cfg, dcfg, seed=3, device="cpu", mesh=mesh)


def _feature_cfg():
    from deepsignal_tpu_torch.core.config import FeatureConfig
    return FeatureConfig(kmer_len=tt.K, cent_signals_len=tt.S)


def _call(input_path, ckpt, out):
    """The port's call_mods of the tiny model, float32, on the CPU."""
    from deepsignal_tpu_torch.runtime.caller import run_call_mods
    return run_call_mods(input_path, ckpt, out, _feature_cfg(),
                         batch_size=16, f5_batch_num=2, nproc=2,
                         compute_dtype="float32", device="cpu")


def _trainer(mesh=None, keep_prob=0.5):
    from deepsignal_tpu_torch.core.config import ModelConfig, TrainConfig
    from deepsignal_tpu_torch.train.trainer import Trainer
    return Trainer(ModelConfig(**TRAIN_TINY),
                   TrainConfig(batch_size=BATCH, keep_prob=keep_prob,
                               seed=SEED),
                   device="cpu", mesh=mesh)


def _train_steps(trainer, train_file, steps=STEPS, batch_ids=None,
                 after_first=None):
    """The step sequence every run takes: ``steps`` batches of the binary
    file in file order (or the batches ``batch_ids`` of that order); per
    step the loss, the counts and the predictions.  ``after_first`` is
    called after the first step."""
    from deepsignal_tpu_torch.train.data import open_dataset
    ds = open_dataset(train_file, True, TRAIN_TINY["kmer_len"],
                      TRAIN_TINY["cent_signals_len"])
    batch_ids = range(steps) if batch_ids is None else batch_ids
    out = []
    for i, batch in enumerate(ds.batches(BATCH)):
        if i not in batch_ids:
            continue
        loss, counts, preds, valid = trainer.train_on_batch(batch, LR)
        out.append({"loss": loss, "counts": [int(c) for c in counts],
                    "preds": preds.tolist(), "valid": valid})
        if len(out) == 1 and after_first is not None:
            after_first()
        if len(out) == len(batch_ids):
            break
    return out


def _whole_state(trainer) -> dict:
    """The gradients (``grad/<name>``) and the state dict (``sd/<name>``)
    of the port's model, fc1 whole (every rank must call it)."""
    from deepsignal_tpu_torch.parallel.mesh import TP_PARAM, all_gather_cat
    tp = trainer.mesh is not None and trainer.mesh.model > 1
    out = {}
    for name, p in trainer.model.named_parameters():
        g = p.grad
        if tp and name == TP_PARAM:
            g = all_gather_cat(g, trainer.mesh.model_group)
        out[f"grad/{name}"] = g.numpy().copy()
    sd = trainer.model.state_dict()
    if tp:
        sd[TP_PARAM] = all_gather_cat(sd[TP_PARAM], trainer.mesh.model_group)
    out.update({f"sd/{k}": v.numpy().copy() for k, v in sd.items()})
    return out


def _jax_trainer():
    from deepsignal_tpu.core.config import ModelConfig as JaxModelConfig
    from deepsignal_tpu.core.config import TrainConfig as JaxTrainConfig
    from deepsignal_tpu.train.trainer import Trainer as JaxTrainer
    return JaxTrainer(JaxModelConfig(**TRAIN_TINY),
                      JaxTrainConfig(batch_size=BATCH, keep_prob=1.0,
                                     seed=SEED))


def _jax_legs_worker(workdir: str, make_mesh) -> tuple:
    """The keep_prob 1.0 legs (``JAX_LEGS``), each from the JAX package's
    initial weights (``jax_init.npz``): per leg its steps, and the
    gradients and state after its first step."""
    from deepsignal_tpu_torch.parallel.mesh import TP_PARAM, shard_rows
    init = {k: torch.from_numpy(v) for k, v in
            np.load(os.path.join(workdir, "jax_init.npz")).items()}
    steps, arrays = {}, {}
    for name, model_parallel, batch_ids in JAX_LEGS:
        trainer = _trainer(make_mesh(model_parallel=model_parallel), 1.0)
        sd = dict(init)
        if model_parallel > 1:
            sd[TP_PARAM] = shard_rows(sd[TP_PARAM], trainer.mesh)
        trainer.model.load_state_dict(sd)
        first = {}
        steps[name] = _train_steps(
            trainer, os.path.join(workdir, "train.bin"), batch_ids=batch_ids,
            after_first=lambda t=trainer: first.update(_whole_state(t)))
        arrays.update({f"{name}/{k}": v for k, v in first.items()})
    return steps, arrays


def _sums(trainer) -> dict:
    """float64 sums of the params (fc1 whole), of each batch-norm
    statistic and of each parameter's |gradient| of the last step (Adam's
    update does not move when a gradient is scaled, so the params alone
    would not show a gradient off by a factor)."""
    from deepsignal_tpu_torch.parallel.mesh import TP_PARAM, all_gather_cat

    def leaves(tree, prefix=""):
        for k, v in sorted(tree.items()):
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", np.asarray(v, dtype=np.float64)

    grads = {}
    for name, p in trainer.model.named_parameters():
        g = p.grad
        if name == TP_PARAM and trainer.mesh is not None:
            g = all_gather_cat(g, trainer.mesh.model_group)
        grads[name] = float(g.double().abs().sum())
    v = trainer.variables
    return {"params": float(sum(a.sum() for _, a in leaves(v["params"]))),
            "bn": {k: float(a.sum()) for k, a in leaves(v["batch_stats"])},
            "grads": grads}


def _worker_main(workdir: str) -> None:
    rank = int(os.environ["RANK"])
    torch.set_num_threads(1)
    from deepsignal_tpu_torch.core.config import ModelConfig, TrainConfig
    from deepsignal_tpu_torch.parallel.dist import distributed
    from deepsignal_tpu_torch.parallel.mesh import make_mesh
    from deepsignal_tpu_torch.train import trainer as trainer_mod

    out = {}
    # inference and training each in a group of their own: the second
    # group of the process keys torchrun's store apart from the first
    with distributed("cpu") as got:
        assert got == (rank, 2), got
        _call(os.path.join(workdir, "f5"), os.path.join(workdir, "ckpt"),
              os.path.join(workdir, "calls_f5.tsv"))
        _call(tt.FEATURES, os.path.join(workdir, "ckpt"),
              os.path.join(workdir, "calls_tsv.tsv"))
    with distributed("cpu") as got:
        assert got == (rank, 2), got
        train_bin = os.path.join(workdir, "train.bin")
        dp = _trainer(make_mesh())
        out["dp"] = {"steps": _train_steps(dp, train_bin), **_sums(dp)}
        tp_mesh = make_mesh(model_parallel=2)
        tp = _trainer(tp_mesh)
        out["tp"] = {"steps": _train_steps(tp, train_bin, 1), **_sums(tp),
                     "fc1_rows": int(tp.model.joint_model.fc1.weight
                                     .shape[0])}
        # the whole train state (fc1 and its Adam moments gathered) restored
        # into a fresh trainer of the same mesh continues the same run
        resumed = _trainer(tp_mesh)
        resumed.restore(tp.variables, tp.train_state())
        out["tp"]["resume"] = [_train_steps(t, train_bin, 2)[1]
                               for t in (tp, resumed)]
        out["jax_legs"], arrays = _jax_legs_worker(workdir, make_mesh)
        np.savez(os.path.join(workdir, f"jax_legs{rank}.npz"), **arrays)

        writes = {"save_checkpoint": 0, "save_train_state": 0, "open": 0}

        def counted(name, fn):
            def wrapper(*args, **kwargs):
                writes[name] += 1
                return fn(*args, **kwargs)
            return wrapper

        trainer_mod.save_checkpoint = counted(
            "save_checkpoint", trainer_mod.save_checkpoint)
        trainer_mod.save_train_state = counted(
            "save_train_state", trainer_mod.save_train_state)
        trainer_mod.open = counted("open", open)  # the log files' writes
        summary = trainer_mod.train(
            train_bin, os.path.join(workdir, "valid.bin"),
            os.path.join(workdir, "model"), os.path.join(workdir, "logs"),
            ModelConfig(**TRAIN_TINY),
            TrainConfig(batch_size=BATCH, keep_prob=0.5, seed=SEED,
                        max_epoch_num=1, min_epoch_num=1, display_step=2),
            is_binary=True, device="cpu", mesh=make_mesh())
        out["train"] = {"summary": summary, "writes": writes}

        from deepsignal_tpu_torch.train import denoise as denoise_mod
        writers = {}
        for name in ("_all_negative_samples", "random_select_file_rows_s",
                     "clean_samples", "select_negsamples_asposkmer",
                     "concat_two_files"):
            writers[name] = 0

            def wrapped(*args, _name=name, _fn=getattr(denoise_mod, name),
                        **kwargs):
                writers[_name] += 1
                return _fn(*args, **kwargs)
            setattr(denoise_mod, name, wrapped)
        denoised = _denoise(os.path.join(workdir, "denoise", "train.tsv"),
                            make_mesh())
        out["denoise"] = {"out": denoised, "writers": writers}
    with open(os.path.join(workdir, f"worker{rank}.json"), "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def mp_run(tmp_path_factory):
    """Write the shared inputs, run both ranks, return the workdir."""
    from deepsignal_tpu_torch.train.checkpoints import (
        save_checkpoint, state_dict_to_variables, variables_to_state_dict)
    rng = np.random.default_rng(SEED)
    workdir = str(tmp_path_factory.mktemp("mp"))
    _make_fast5_dir(os.path.join(workdir, "f5"), rng)
    _make_binary_file(os.path.join(workdir, "train.bin"), rng, TRAIN_ROWS)
    _make_binary_file(os.path.join(workdir, "valid.bin"), rng, VALID_ROWS)
    os.makedirs(os.path.join(workdir, "denoise"))
    with open(os.path.join(workdir, "denoise", "train.tsv"), "w") as f:
        f.write(_denoise_rows(rng))
    save_checkpoint(os.path.join(workdir, "ckpt"), tt.tiny_cfg(),
                    state_dict_to_variables(tt.tiny_cfg(),
                                            tt.tiny_state_dict()))
    import jax
    from deepsignal_tpu_torch.core.config import ModelConfig
    np.savez(os.path.join(workdir, "jax_init.npz"), **variables_to_state_dict(
        ModelConfig(**TRAIN_TINY), jax.device_get(_jax_trainer().variables)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO, TESTS,
                                         env.get("PYTHONPATH", "")])
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", os.path.abspath(__file__), "worker",
         workdir], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        start_new_session=True)
    try:
        out = proc.communicate(timeout=WAIT_S)[0].decode(errors="replace")
    finally:
        if proc.poll() is None:
            # the agent stops its ranks (each in a session of its own) on
            # SIGTERM; SIGKILL then ends whatever is left of its group
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:  # the group ended with the agent
                pass
            proc.wait(timeout=10)
    assert proc.returncode == 0, f"torchrun failed:\n{out[-4000:]}"
    workers = [json.load(open(os.path.join(workdir, f"worker{r}.json")))
               for r in (0, 1)]
    return workdir, workers, out


def _lines(path):
    with open(path, "rb") as f:
        return sorted(f.read().splitlines())


def _assert_calls_match(got_lines, want_lines, tol):
    assert got_lines and len(got_lines) == len(want_lines)
    for got, want in zip(got_lines, want_lines):
        g, w = got.split(b"\t"), want.split(b"\t")
        assert g[:6] == w[:6] and g[8:] == w[8:], (got, want)
        for gp, wp in zip(g[6:8], w[6:8]):
            assert abs(float(gp) - float(wp)) <= tol, (got, want)


@pytest.mark.parametrize("source", ["f5", "tsv"])
def test_two_rank_call_mods_matches_one_process(mp_run, tmp_path, source):
    """The merged shards equal one process's calls: the same rows, every
    structural column byte-identical, the probabilities within 3e-7; each
    rank wrote only its shard (no duplicated call)."""
    from deepsignal_tpu_torch.parallel.dist import merge_call_shards
    workdir, _, out = mp_run
    base = os.path.join(workdir, f"calls_{source}.tsv")
    parts = [_lines(f"{base}.part{k}-of-2") for k in (0, 1)]
    assert all(parts) and not set(parts[0]) & set(parts[1])
    merged = merge_call_shards(base, 2)
    single = str(tmp_path / "single.tsv")
    _call(os.path.join(workdir, "f5") if source == "f5" else tt.FEATURES,
          os.path.join(workdir, "ckpt"), single)
    _assert_calls_match(_lines(merged), _lines(single), PROB_TOL_RANKS)
    if source == "f5":
        # the JAX package's line for a rank's share of the sorted files
        for rank in (0, 1):
            assert f"host {rank}/2: 3 fast5 files in shard.." in out


def test_two_rank_tsv_calls_match_the_golden_jax_calls(mp_run):
    from deepsignal_tpu_torch.parallel.dist import merge_call_shards
    workdir, _, _ = mp_run
    merged = merge_call_shards(os.path.join(workdir, "calls_tsv.tsv"), 2)
    _assert_calls_match(_lines(merged), _lines(tt.CALLS_F32),
                        PROB_TOL_GOLDEN)


def _assert_steps_match(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["counts"] == w["counts"]  # exact integer counts
        assert g["preds"] == w["preds"] and g["valid"] == w["valid"]
        assert g["loss"] == pytest.approx(w["loss"], rel=REL)


def _assert_sums_match(got, want):
    assert got["params"] == pytest.approx(want["params"], rel=REL)
    for part in ("bn", "grads"):
        assert got[part].keys() == want[part].keys()
        for k, v in want[part].items():
            assert got[part][k] == pytest.approx(v, rel=REL), (part, k)


def test_two_rank_train_steps_match_one_process(mp_run):
    """3 data-parallel steps of the global batch (the last a padded tail,
    so the ranks' valid counts differ) equal one process's: counts and
    predictions exact, loss, params and batch-norm statistics within rel
    1e-5, and every number the same on both ranks."""
    workdir, (w0, w1), _ = mp_run
    assert w0["dp"] == w1["dp"]
    assert [s["valid"] for s in w0["dp"]["steps"]] == [BATCH, BATCH, 8]
    one = _trainer()
    want = _train_steps(one, os.path.join(workdir, "train.bin"))
    _assert_steps_match(w0["dp"]["steps"], want)
    _assert_sums_match(w0["dp"], _sums(one))


def test_tensor_parallel_step_matches_one_process(mp_run):
    """One step with fc1's output rows split over 2 model ranks equals one
    process's step."""
    workdir, (w0, w1), _ = mp_run
    assert w0["tp"] == w1["tp"]
    cont, resumed = w0["tp"]["resume"]
    assert resumed == cont
    one = _trainer()
    assert 2 * w0["tp"]["fc1_rows"] == \
        one.model.joint_model.fc1.weight.shape[0]
    want = _train_steps(one, os.path.join(workdir, "train.bin"), 1)
    _assert_steps_match(w0["tp"]["steps"], want)
    _assert_sums_match(w0["tp"], _sums(one))


@pytest.fixture(scope="module")
def jax_steps(mp_run):
    """The JAX package's ``Trainer`` on each leg of ``JAX_LEGS``, from its
    initial weights, on the same global batches: per leg its steps, and
    the gradients (``jax.grad`` of the train step's loss at the weights
    before the first step) and the state after the first step, in the
    port's names and layout."""
    import jax
    import jax.numpy as jnp
    from deepsignal_tpu.train.data import open_dataset as jax_open_dataset
    from deepsignal_tpu.train.trainer import \
        masked_mean_loss as jax_masked_loss
    from deepsignal_tpu_torch.core.config import ModelConfig
    from deepsignal_tpu_torch.train.checkpoints import variables_to_state_dict
    from deepsignal_tpu_torch.train.trainer import INPUTS
    workdir = mp_run[0]
    cfg = ModelConfig(**TRAIN_TINY)
    batches = list(jax_open_dataset(
        os.path.join(workdir, "train.bin"), True, TRAIN_TINY["kmer_len"],
        TRAIN_TINY["cent_signals_len"]).batches(BATCH))
    jt = _jax_trainer()
    init = jax.device_get(jt.variables)

    def loss_fn(params, batch_stats, inputs, labels, mask):
        logits, _ = jt.model.apply(
            {"params": params, "batch_stats": batch_stats}, *inputs,
            train=True, keep_prob=1.0, mutable=["batch_stats"])
        return jax_masked_loss(logits, labels, mask, cfg.class_num, 1.0)

    grad_fn = jax.jit(jax.grad(loss_fn))
    out = {}
    for name, _model_parallel, batch_ids in JAX_LEGS:
        jt.restore(init, jt.tx.init(init["params"]), jt.rng)
        steps, first = [], None
        for i in batch_ids:
            batch = batches[i]
            if first is None:
                mask = (np.arange(BATCH) < batch["__valid__"]).astype(
                    np.float32)
                grads = jax.device_get(grad_fn(
                    jt.params, jt.batch_stats,
                    [jnp.asarray(batch[k]) for k in INPUTS],
                    jnp.asarray(batch["labels"]), jnp.asarray(mask)))
            loss, counts, preds, valid = jt.train_on_batch(dict(batch), LR)
            steps.append({"loss": loss, "counts": [int(c) for c in counts],
                          "preds": preds.tolist(), "valid": valid})
            if first is None:
                sd = variables_to_state_dict(cfg, jax.device_get(
                    jt.variables))
                first = {f"sd/{k}": v for k, v in sd.items()}
                first.update({f"grad/{k}": v for k, v in
                              variables_to_state_dict(cfg, {
                                  "params": grads,
                                  "batch_stats": init["batch_stats"]}).items()
                              if not k.endswith((".mean", ".var"))})
        out[name] = (steps, first)
    return out


@pytest.mark.parametrize("leg", [name for name, _, _ in JAX_LEGS])
def test_two_rank_steps_match_the_jax_trainer(mp_run, jax_steps, leg):
    """At keep_prob 1.0, from the JAX package's initial weights, the two
    ranks' steps of the global batch equal the JAX ``Trainer``'s steps on
    that batch: every step's counts and predictions exact and loss within
    rel 1e-5; after the first step every gradient and batch-norm statistic
    within JAX_TOL, and the weights Adam moved within its first step's
    bounds.  Legs: the 3 data-parallel steps, the padded tail alone (rank
    1's block holds no real row) and a fc1-tensor-parallel step."""
    workdir, (w0, w1), _ = mp_run
    assert w0["jax_legs"][leg] == w1["jax_legs"][leg]
    want_steps, want = jax_steps[leg]
    got_steps = w0["jax_legs"][leg]
    assert len(got_steps) == len(want_steps)
    for g, w in zip(got_steps, want_steps):
        assert g["counts"] == w["counts"] and g["valid"] == w["valid"]
        assert g["preds"] == w["preds"]
        assert g["loss"] == pytest.approx(w["loss"], rel=REL)
    if leg == "tail":
        assert got_steps[0]["valid"] == BATCH // 2
    ranks = [np.load(os.path.join(workdir, f"jax_legs{r}.npz"))
             for r in (0, 1)]
    got = {k[len(leg) + 1:]: ranks[0][k] for k in ranks[0].files
           if k.startswith(f"{leg}/")}
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], ranks[1][f"{leg}/{k}"])
    for k, w in want.items():
        if k.startswith("grad/") or k.endswith((".mean", ".var")):
            np.testing.assert_allclose(got[k], w, rtol=0, atol=JAX_TOL,
                                       err_msg=k)
            continue
        g = np.abs(want[f"grad/{k[3:]}"])
        diff = np.abs(got[k] - w)
        assert diff[g > 1e-4].max(initial=0) <= 1e-6, k
        assert diff.max() <= 2 * LR * (1 + 1e-6), k


def test_two_rank_train_writes_from_rank_zero_only(mp_run):
    """train() at world 2: rank 0 writes the logs, checkpoints and train
    state, rank 1 nothing; both take the same decisions; the checkpoint
    loads in both packages."""
    from deepsignal_tpu.train.checkpoints import \
        load_checkpoint as jax_load_checkpoint
    from deepsignal_tpu_torch.train.checkpoints import (
        load_checkpoint, variables_to_state_dict)
    workdir, (w0, w1), _ = mp_run
    assert w0["train"]["summary"] == w1["train"]["summary"]
    assert w1["train"]["writes"] == {"save_checkpoint": 0,
                                     "save_train_state": 0, "open": 0}
    writes = w0["train"]["writes"]
    assert writes["save_checkpoint"] >= 1 and writes["save_train_state"] == 1
    assert writes["open"] >= 2
    for name in ("train.txt", "valid.txt"):
        with open(os.path.join(workdir, "logs", name)) as f:
            assert len(f.read().splitlines()) == writes["open"] // 2
    path = w0["train"]["summary"]["model_path"]
    cfg, variables = load_checkpoint(path)
    sd = variables_to_state_dict(cfg, variables)
    _jax_cfg, jax_variables = jax_load_checkpoint(path)
    jax_sd = variables_to_state_dict(cfg, jax_variables)
    assert sd.keys() == jax_sd.keys()
    for k, v in jax_sd.items():
        np.testing.assert_array_equal(sd[k], v)


def test_two_rank_denoise_writes_from_rank_zero(mp_run, tmp_path):
    """denoise() on a 2-rank mesh: rank 0 alone writes its files (the JAX
    package writes them from every process), both ranks end with the same
    path, and the denoised file equals one process's byte for byte."""
    workdir, (w0, w1), _ = mp_run
    assert w0["denoise"]["out"] == w1["denoise"]["out"]
    assert set(w1["denoise"]["writers"].values()) == {0}
    assert min(w0["denoise"]["writers"].values()) == 1
    src = os.path.join(workdir, "denoise")
    assert sorted(os.listdir(src)) == ["train.denoise1.tsv", "train.tsv"]
    single = tmp_path / "train.tsv"
    with open(os.path.join(src, "train.tsv"), "rb") as f:
        single.write_bytes(f.read())
    out = _denoise(str(single))
    with open(out, "rb") as f, open(w0["denoise"]["out"], "rb") as g:
        assert f.read() == g.read()


if __name__ == "__main__":
    if len(sys.argv) >= 2 and sys.argv[1] == "worker":
        _worker_main(sys.argv[2])
