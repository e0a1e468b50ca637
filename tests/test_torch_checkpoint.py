"""Checkpointed ALS training on the port (``core/checkpoint.py``,
``ops/als.py als_train``), held against the JAX package on the CPU.

The port's cases of ``tests/test_checkpoint.py``'s ``TestSnapshotFile``,
``TestSingleChipResume`` and ``TestTrainCLIPlumbing`` (at f32, bf16 and
int8 storage; the sharded class waits for the multi-GPU slice), then the
two packages against each other: one ``data_fingerprint`` for one run,
and a checkpoint either package wrote resumed by the other. A resumed
run is held to the resuming package's one-shot run of the writer's
training: rtol 5e-4 / atol 5e-5 for f32 factors, the JAX package's RMSE
bar (``e < e_ref * 1.01 + 0.01`` both ways) for bf16 and int8. The JAX
package cannot resume a bf16 checkpoint of its own (its ``np.load``
returns the bf16 bytes as ``|V2``, which ``jax.device_put`` refuses), so
the JAX side resumes f32 and int8 only.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from predictionio_tpu.core import checkpoint as jckpt
from predictionio_tpu.ops import als as jals
from predictionio_tpu_torch import faults
from predictionio_tpu_torch.core import checkpoint as ckpt
from predictionio_tpu_torch.ops import als

DTYPES = ["float32", "bfloat16", "int8"]


def _coo(seed=0, n_u=30, n_i=20, nnz=200):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_u, nnz).astype(np.int32)
    cols = rng.integers(0, n_i, nnz).astype(np.int32)
    vals = (1 + 4 * rng.random(nnz)).astype(np.float32)
    return rows, cols, vals, n_u, n_i


def _data(seed=0, **kw):
    return als.build_ratings_data(*_coo(seed, **kw))


def _cfg(tmp_path, **kw):
    kw.setdefault("every", 2)
    return ckpt.CheckpointConfig(directory=str(tmp_path / "ckpt"), **kw)


def _host(table):
    """Comparable host copy of a factor table (dense or int8 pair); bf16
    as its bits."""
    if isinstance(table, tuple):
        return tuple(_host(t) for t in table)
    if isinstance(table, torch.Tensor):
        if table.dtype == torch.bfloat16:
            return table.view(torch.int16).numpy()
        return table.numpy()
    a = np.asarray(table)
    return a.view(np.int16) if a.dtype.itemsize == 2 and a.dtype.kind != "i" else a


def _same(a, b) -> bool:
    a, b = _host(a), _host(b)
    if isinstance(a, tuple) != isinstance(b, tuple):
        return False
    if isinstance(a, tuple):
        return all(np.array_equal(x, y) for x, y in zip(a, b))
    return np.array_equal(a, b)


def _params(storage="float32", iterations=6, **kw):
    return als.ALSParams(rank=4, iterations=iterations, reg=0.1,
                         storage_dtype=storage, **kw)


def _train(data, params, **kw):
    return als.als_train(data, params, device="cpu", **kw)


@pytest.fixture(autouse=True)
def _no_checkpoint_env(monkeypatch):
    for k in ("PIO_CHECKPOINT_EVERY", "PIO_RESUME", "PIO_CHECKPOINT_DIR"):
        monkeypatch.delenv(k, raising=False)


class TestSnapshotFile:
    def test_save_load_roundtrip(self, tmp_path):
        cfg = _cfg(tmp_path)
        U = np.arange(12, dtype=np.float32).reshape(3, 4)
        V = np.arange(8, dtype=np.float32).reshape(2, 4)
        assert ckpt.save_checkpoint(cfg, "fp1", U, V, iteration=5, seed=9)
        snap = ckpt.load_checkpoint(cfg, "fp1")
        assert snap is not None
        assert snap.iteration == 5 and snap.seed == 9 and snap.mesh == "single"
        assert np.array_equal(snap.U, U) and np.array_equal(snap.V, V)

    def test_int8_pair_roundtrip(self, tmp_path):
        cfg = _cfg(tmp_path)
        U = (
            torch.arange(12, dtype=torch.int8).reshape(3, 4),
            torch.ones(3, dtype=torch.float32),
        )
        V = torch.zeros((2, 4))
        assert ckpt.save_checkpoint(cfg, "fp1", U, V, iteration=1, seed=0)
        snap = ckpt.load_checkpoint(cfg, "fp1")
        assert isinstance(snap.U, tuple) and _same(snap.U, U)
        assert not isinstance(snap.V, tuple)

    def test_bfloat16_roundtrip_to_the_device_form(self, tmp_path):
        cfg = _cfg(tmp_path)
        U = torch.randn((5, 3)).to(torch.bfloat16)
        assert ckpt.save_checkpoint(cfg, "fp1", U, U, iteration=1, seed=0)
        snap = ckpt.load_checkpoint(cfg, "fp1")
        assert snap.U.dtype.str == "|V2"  # the JAX package's bytes
        back = ckpt.table_to_device(snap.U, torch.device("cpu"))
        assert back.dtype == torch.bfloat16 and _same(back, U)

    def test_missing_and_corrupt_load_to_none(self, tmp_path):
        cfg = _cfg(tmp_path)
        assert ckpt.load_checkpoint(cfg, "nope") is None
        path = ckpt.checkpoint_path(cfg, "torn")
        path.parent.mkdir(parents=True)
        path.write_bytes(b"PK\x03\x04 definitely not a whole npz")
        assert ckpt.load_checkpoint(cfg, "torn") is None

    def test_fingerprint_mismatch_refused(self, tmp_path):
        cfg = _cfg(tmp_path)
        U = np.zeros((2, 2), np.float32)
        ckpt.save_checkpoint(cfg, "fpA", U, U, iteration=1, seed=0)
        path = ckpt.checkpoint_path(cfg, "fpA")
        path.rename(ckpt.checkpoint_path(cfg, "fpB"))
        assert ckpt.load_checkpoint(cfg, "fpB") is None

    def test_failed_write_is_best_effort(self, tmp_path):
        cfg = _cfg(tmp_path)
        U = np.zeros((2, 2), np.float32)
        with faults.injected("train.checkpoint:times=1"):
            assert not ckpt.save_checkpoint(cfg, "fp", U, U, 1, 0)
        # a kill between tmp write and rename leaves no visible file
        with faults.injected("storage.rename:times=1"):
            assert not ckpt.save_checkpoint(cfg, "fp", U, U, 1, 0)
        assert ckpt.load_checkpoint(cfg, "fp") is None
        with faults.injected("storage.fsync:times=1"):
            assert not ckpt.save_checkpoint(cfg, "fp", U, U, 1, 0)
        assert ckpt.save_checkpoint(cfg, "fp", U, U, 1, 0)  # clean retry

    def test_fingerprint_ignores_iterations_but_not_data(self):
        d = _data()
        p6 = als.ALSParams(rank=4, iterations=6, reg=0.1)
        p10 = als.ALSParams(rank=4, iterations=10, reg=0.1)
        fp = ckpt.data_fingerprint(d.rows, d.cols, d.vals, p6)
        assert fp == ckpt.data_fingerprint(d.rows, d.cols, d.vals, p10)
        other = _data(seed=1)
        assert fp != ckpt.data_fingerprint(other.rows, other.cols, other.vals, p6)
        p_reg = als.ALSParams(rank=4, iterations=6, reg=0.2)
        assert fp != ckpt.data_fingerprint(d.rows, d.cols, d.vals, p_reg)
        assert fp != ckpt.data_fingerprint(d.rows, d.cols, d.vals, p6,
                                           mesh="sharded:data=8:gather")

    def test_from_env(self, monkeypatch):
        assert ckpt.from_env() is None
        monkeypatch.setenv("PIO_CHECKPOINT_EVERY", "3")
        monkeypatch.setenv("PIO_CHECKPOINT_DIR", "/tmp/x")
        cfg = ckpt.from_env()
        assert cfg.every == 3 and cfg.directory == "/tmp/x" and not cfg.resume
        monkeypatch.setenv("PIO_RESUME", "1")
        assert ckpt.from_env().resume

    def test_a_save_counts_its_bytes_and_time(self, tmp_path):
        from predictionio_tpu_torch.obs import device as obs_device
        from predictionio_tpu_torch.obs import metrics as obs_metrics

        cfg = _cfg(tmp_path)
        U = (torch.zeros((3, 4), dtype=torch.int8), torch.ones(3))
        before = obs_device.transfer_totals().get("d2h.checkpoint", 0)
        hist = obs_metrics.histogram("pio_checkpoint_write_seconds",
                                     "Wall time of one checkpoint write")
        n = hist.merged()[2]
        assert ckpt.save_checkpoint(cfg, "fp", U, U, 1, 0)
        after = obs_device.transfer_totals().get("d2h.checkpoint", 0)
        assert after - before == 2 * (12 + 12)
        assert hist.merged()[2] == n + 1


@pytest.mark.parametrize("storage", DTYPES)
class TestSingleChipResume:
    def test_checkpointed_run_matches_plain(self, tmp_path, storage):
        data = _data()
        U0, V0 = _train(data, _params(storage))
        U1, V1 = _train(data, _params(storage), checkpoint_cfg=_cfg(tmp_path))
        assert _same(U0, U1) and _same(V0, V1)
        # every 1: a snapshot after each iteration but the last
        U2, V2 = _train(data, _params(storage), checkpoint_cfg=_cfg(tmp_path, every=1))
        assert _same(U0, U2) and _same(V0, V2)
        assert als.LAST_TRAIN_INFO["iterations_run"] == 6

    def test_resume_after_kill_is_bit_identical(self, tmp_path, storage):
        """Kill a 6-iteration run after 4 (a 4-iteration twin leaves the
        iteration-2 snapshot), then resume the full run: bit for bit."""
        data, cfg = _data(), _cfg(tmp_path)
        full = _params(storage)
        U0, V0 = _train(data, full)
        _train(data, _params(storage, iterations=4), checkpoint_cfg=cfg)
        snap = ckpt.load_checkpoint(
            cfg, ckpt.data_fingerprint(data.rows, data.cols, data.vals, full))
        assert snap is not None and snap.iteration == 2
        U2, V2 = _train(data, full, checkpoint_cfg=_cfg(tmp_path, resume=True))
        assert _same(U0, U2) and _same(V0, V2)
        assert als.LAST_TRAIN_INFO["iterations_run"] == 4

    def test_resume_without_checkpoint_trains_from_scratch(self, tmp_path, storage):
        data, params = _data(), _params(storage, iterations=3)
        U0, V0 = _train(data, params)
        U1, V1 = _train(data, params,
                        checkpoint_cfg=_cfg(tmp_path, every=0, resume=True))
        assert _same(U0, U1) and _same(V0, V1)

    def test_corrupt_checkpoint_degrades_to_scratch(self, tmp_path, storage):
        data, cfg = _data(), _cfg(tmp_path)
        params = _params(storage, iterations=4)
        _train(data, params, checkpoint_cfg=cfg)
        fp = ckpt.data_fingerprint(data.rows, data.cols, data.vals, params)
        ckpt.checkpoint_path(cfg, fp).write_bytes(b"garbage")
        U0, V0 = _train(data, params)
        U1, V1 = _train(data, params, checkpoint_cfg=_cfg(tmp_path, resume=True))
        assert _same(U0, U1) and _same(V0, V1)

    def test_env_vars_drive_the_checkpoints(self, tmp_path, monkeypatch, storage):
        """``PIO_CHECKPOINT_EVERY`` / ``PIO_RESUME`` / ``PIO_CHECKPOINT_DIR``
        (what ``train --checkpoint-every/--resume/--checkpoint-dir`` set)
        checkpoint and resume without a config argument."""
        data, full = _data(), _params(storage)
        U0, V0 = _train(data, full)
        monkeypatch.setenv("PIO_CHECKPOINT_EVERY", "2")
        monkeypatch.setenv("PIO_CHECKPOINT_DIR", str(tmp_path / "env"))
        _train(data, _params(storage, iterations=4))
        assert len(list((tmp_path / "env").glob("als-*.npz"))) == 1
        monkeypatch.setenv("PIO_RESUME", "1")
        U1, V1 = _train(data, full)
        assert _same(U0, U1) and _same(V0, V1)


def test_progress_file_follows_the_segments(tmp_path, monkeypatch):
    """``als_train`` publishes the train progress file (``obs/progress.py``)
    once a segment, with the segment's RMSE, as the JAX package does."""
    import json

    path = tmp_path / "progress.json"
    monkeypatch.setenv("PIO_PROGRESS_FILE", str(path))
    data = _data()
    _train(data, _params(iterations=4), checkpoint_cfg=_cfg(tmp_path))
    doc = json.loads(path.read_text())
    assert doc["iteration"] == 4 and doc["state"] == "done"
    assert len(doc["rmse"]) == 2 and doc["rmse"][1] <= doc["rmse"][0]
    assert doc["trainer"] == "single" and doc["mesh"] == "single"


def test_progress_file_counts_the_runs_k1_launches(tmp_path, monkeypatch):
    """The terminal progress document carries the K1 launches of this run
    alone, as ``solve_bucket.launches`` saw them: 0 on the CPU (the plain
    version launches nothing), and what a counted half-step adds
    otherwise, whatever the counter held before the run."""
    import json

    path = tmp_path / "progress.json"
    monkeypatch.setenv("PIO_PROGRESS_FILE", str(path))
    data = _data()
    _train(data, _params(iterations=2))
    doc = json.loads(path.read_text())
    assert doc["state"] == "done" and doc["k1_launches"] == 0

    half_step = als._half_step

    def counted(target, other, buckets, params, *a, **kw):
        als.solve_bucket.launches.add(len(buckets))
        return half_step(target, other, buckets, params, *a, **kw)

    monkeypatch.setattr(als, "_half_step", counted)
    als.solve_bucket.launches.add(7)  # launches of an earlier run
    _train(data, _params(iterations=3))
    doc = json.loads(path.read_text())
    per_iter = len(data.row_buckets) + len(data.col_buckets)
    assert doc["iteration"] == 3 and doc["k1_launches"] == 3 * per_iter


def test_train_histograms_observe_each_run():
    from predictionio_tpu_torch.obs import metrics as obs_metrics

    whole = obs_metrics.histogram("pio_als_train_seconds",
                                  "Whole-run ALS training time", path="single")
    half = obs_metrics.histogram(
        "pio_als_halfstep_seconds",
        "Derived per-half-step time of the fused sharded ALS loop", mode="single")
    n_whole, n_half = whole.merged()[2], half.merged()[2]
    _train(_data(), _params(iterations=2))
    assert whole.merged()[2] == n_whole + 1 and half.merged()[2] == n_half + 1


class TestTrainCLIPlumbing:
    def test_train_flags_set_env(self, monkeypatch, tmp_path):
        from predictionio_tpu_torch.cli import main as cli_main
        from predictionio_tpu_torch.core import workflow

        def stop(*a, **k):
            raise SystemExit(0)  # stop before real training

        # cmd_train imports run_train when it runs
        monkeypatch.setattr(workflow, "run_train", stop)
        args = cli_main.build_parser().parse_args([
            "train", "--checkpoint-every", "5", "--resume",
            "--checkpoint-dir", str(tmp_path), "--device", "cpu",
        ])
        try:
            with pytest.raises(SystemExit):
                args.fn(args)
            assert os.environ["PIO_CHECKPOINT_EVERY"] == "5"
            assert os.environ["PIO_RESUME"] == "1"
            assert os.environ["PIO_CHECKPOINT_DIR"] == str(tmp_path)
        finally:
            for k in ("PIO_CHECKPOINT_EVERY", "PIO_RESUME", "PIO_CHECKPOINT_DIR"):
                os.environ.pop(k, None)

    def test_no_flag_sets_nothing(self, monkeypatch):
        from predictionio_tpu_torch.cli import main as cli_main
        from predictionio_tpu_torch.core import workflow

        monkeypatch.setattr(workflow, "run_train",
                            lambda *a, **k: (_ for _ in ()).throw(SystemExit(0)))
        args = cli_main.build_parser().parse_args(["train", "--device", "cpu"])
        with pytest.raises(SystemExit):
            args.fn(args)
        assert not {"PIO_CHECKPOINT_EVERY", "PIO_RESUME",
                    "PIO_CHECKPOINT_DIR"} & set(os.environ)


# -- the two packages ------------------------------------------------------------


FINGERPRINT_PARAMS = [
    {},
    {"storage_dtype": "bfloat16"},
    {"storage_dtype": "int8", "rank": 20},
    {"rank": 4, "iterations": 6, "reg": 0.1, "seed": 3},
]


@pytest.mark.parametrize("kw", FINGERPRINT_PARAMS)
def test_data_fingerprint_equals_the_jax_packages(kw):
    """One run has one identity in both packages: the COO arrays as the
    bucket layouts keep them and the ``repr`` of ``ALSParams`` at
    ``iterations=0`` are byte-equal."""
    coo = _coo(seed=4)
    td, jd = als.build_ratings_data(*coo), jals.build_ratings_data(*coo)
    tp, jp = als.ALSParams(**kw), jals.ALSParams(**kw)
    from dataclasses import replace

    assert repr(replace(tp, iterations=0)) == repr(replace(jp, iterations=0))
    assert ckpt.data_fingerprint(td.rows, td.cols, td.vals, tp) == \
        jckpt.data_fingerprint(jd.rows, jd.cols, jd.vals, jp)


def _both(storage):
    coo = _coo(seed=2)
    kw = dict(rank=4, reg=0.1, storage_dtype=storage)
    return (als.build_ratings_data(*coo), jals.build_ratings_data(*coo), kw)


def _factors_agree(got, want, storage, data) -> None:
    """Resumed (U, V) against the one-shot run: f32 factors at rtol 5e-4 /
    atol 5e-5, reduced storage by the JAX package's RMSE bar."""
    if storage == "float32":
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=5e-4, atol=5e-5)
        return
    e_got = jals.rmse(*(_jax_table(t) for t in got), data.rows, data.cols, data.vals)
    e_want = jals.rmse(*(_jax_table(t) for t in want), data.rows, data.cols, data.vals)
    assert e_got < e_want * 1.01 + 0.01 and e_want < e_got * 1.01 + 0.01


def _jax_table(t):
    """A table of either package as a JAX array (or int8 pair)."""
    import jax.numpy as jnp

    if isinstance(t, tuple):
        return tuple(_jax_table(x) for x in t)
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(t.numpy())
    return t


@pytest.mark.parametrize("storage", DTYPES)
def test_port_resumes_a_jax_checkpoint(tmp_path, storage):
    """A JAX run of 4 iterations checkpointing every 2 leaves its
    iteration-2 file; the port resumes it to iteration 4 and lands on
    the JAX package's 4-iteration tables."""
    td, jd, kw = _both(storage)
    directory = str(tmp_path / "ckpt")
    JU, JV = jals.als_train(jd, jals.ALSParams(iterations=4, **kw),
                            checkpoint_cfg=jckpt.CheckpointConfig(every=2, directory=directory))
    files = list((tmp_path / "ckpt").glob("als-*.npz"))
    assert len(files) == 1
    U, V = als.als_train(td, als.ALSParams(iterations=4, **kw), device="cpu",
                         checkpoint_cfg=ckpt.CheckpointConfig(directory=directory, resume=True))
    assert als.LAST_TRAIN_INFO["iterations_run"] == 2
    assert (U[0] if storage == "int8" else U).dtype == getattr(torch, storage)
    _factors_agree((U, V), (JU, JV), storage, jd)


@pytest.mark.parametrize("storage", ["float32", "int8"])
def test_jax_package_resumes_a_port_checkpoint(tmp_path, storage):
    """The reverse: the port's iteration-2 file, resumed to iteration 4 by
    the JAX package, lands on the port's 4-iteration tables."""
    td, jd, kw = _both(storage)
    directory = str(tmp_path / "ckpt")
    U, V = als.als_train(td, als.ALSParams(iterations=4, **kw), device="cpu",
                         checkpoint_cfg=ckpt.CheckpointConfig(every=2, directory=directory))
    JU, JV = jals.als_train(jd, jals.ALSParams(iterations=4, **kw),
                            checkpoint_cfg=jckpt.CheckpointConfig(directory=directory,
                                                                  resume=True))
    assert jals.LAST_TRAIN_INFO["iterations_run"] == 2
    _factors_agree((JU, JV), (U, V), storage, jd)


def test_checkpoint_files_read_both_ways(tmp_path):
    """The snapshot fields of one package's file as the other reads them:
    tables bit for bit, iteration, seed, mesh."""
    U = (torch.arange(12, dtype=torch.int8).reshape(3, 4), torch.rand(3))
    V = torch.randn((2, 4)).to(torch.bfloat16)
    cfg = ckpt.CheckpointConfig(every=1, directory=str(tmp_path / "a"))
    assert ckpt.save_checkpoint(cfg, "fp", U, V, iteration=3, seed=7)
    snap = jckpt.load_checkpoint(jckpt.CheckpointConfig(every=1, directory=cfg.directory), "fp")
    assert (snap.iteration, snap.seed, snap.mesh) == (3, 7, "single")
    assert _same(snap.U, U) and _same(snap.V, V)

    import ml_dtypes

    jcfg = jckpt.CheckpointConfig(every=1, directory=str(tmp_path / "b"))
    JU = np.arange(8, dtype=np.float32).reshape(2, 4)
    JV = np.linspace(-1, 1, 8, dtype=np.float32).reshape(2, 4).astype(ml_dtypes.bfloat16)
    assert jckpt.save_checkpoint(jcfg, "fp", JU, JV, iteration=2, seed=1)
    snap = ckpt.load_checkpoint(ckpt.CheckpointConfig(every=1, directory=jcfg.directory), "fp")
    assert (snap.iteration, snap.seed, snap.mesh) == (2, 1, "single")
    V_port = ckpt.table_to_device(snap.V, torch.device("cpu"))
    assert np.array_equal(ckpt.table_to_device(snap.U, torch.device("cpu")).numpy(), JU)
    assert np.array_equal(V_port.float().numpy(), JV.astype(np.float32))
