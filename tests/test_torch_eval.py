"""The port's evaluation path against the JAX package's, on the CPU.

Both packages get the same inputs (numpy arrays, or the same events in
each package's store). On CPU tensors the port's kernel wrappers run
their plain versions, which are what the CUDA kernels are held to on the
card (chip_smoke.py). Tolerances and their reasons:

- ``read_eval``'s folds and held-out queries, and ``encode_actuals``:
  equal (the same numpy operations);
- ``ranking_metrics_batch`` (K3's plain version): precision and valid
  equal; ap and ndcg within abs 1e-6 (the JAX package's bar against the
  per-query functions, tests/test_eval_fast_path.py:98-100; row sums in
  another order on the card);
- ``top_k_items_batch``: ids equal, scores within rtol 1e-5 (the serving
  bar, tests/test_torch_topk.py);
- the whole slice (``run_evaluation`` of both packages on the same events,
  from the same injected initial factors): each candidate's scores within
  abs 1e-6 and the same best candidate; a top-k row that differs must be
  a near tie (a score gap under 1e-5), and the JAX package's rows put in
  its place must give the JAX package's scores within 1e-6.
"""

from __future__ import annotations

import contextlib
import io
import json
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.core import ranking as jranking
from predictionio_tpu.ops import als as jals
from predictionio_tpu.ops import topk as jtopk
from predictionio_tpu_torch.core import EngineParams, WorkflowContext
from predictionio_tpu_torch.core import ranking as tranking
from predictionio_tpu_torch.core.base import Algorithm, DataSource, FirstServing, Serving
from predictionio_tpu_torch.core.engine import Engine
from predictionio_tpu_torch.core.evaluation import MetricEvaluator
from predictionio_tpu_torch.core.fast_eval import FastEvalEngineWorkflow
from predictionio_tpu_torch.core.params import Params
from predictionio_tpu_torch.core.ranking import MAPAtK, NDCGAtK, PrecisionAtK
from predictionio_tpu_torch.models import recommendation as trec
from predictionio_tpu_torch.ops import als as tals
from predictionio_tpu_torch.ops import topk as ttopk

CPU = WorkflowContext(mode="FastEvalTest", device="cpu")


# -- read_eval ------------------------------------------------------------------


def _training(package_rec, seed: int, n_users: int = 60, n_items: int = 30, n: int = 700):
    rng = np.random.default_rng(seed)
    return package_rec.TrainingData(
        user_ids=[f"u{j}" for j in range(n_users)],
        item_ids=[f"i{j}" for j in range(n_items)],
        rows=rng.integers(0, n_users, n).astype(np.int32),
        cols=rng.integers(0, n_items, n).astype(np.int32),
        ratings=rng.integers(1, 6, n).astype(np.float32),
    )


@pytest.mark.parametrize("folds,eval_seed", [(3, 42), (2, 7), (5, 0)])
def test_read_eval_folds_equal_jax(folds, eval_seed):
    from predictionio_tpu.models import recommendation as jrec

    def source(rec):
        td = _training(rec, 11)

        class Fixed(rec.RecommendationDataSource):
            def read_training(self, ctx):
                return td

        return Fixed(rec.DataSourceParams(app_name="x", eval_folds=folds,
                                          eval_seed=eval_seed))

    port = source(trec).read_eval(None)
    ref = source(jrec).read_eval(None)
    assert len(port) == len(ref) == folds
    for (ptd, pinfo, pqa), (jtd, jinfo, jqa) in zip(port, ref):
        assert pinfo == jinfo
        assert ptd.user_ids == jtd.user_ids and ptd.item_ids == jtd.item_ids
        for f in ("rows", "cols", "ratings"):
            a, b = getattr(ptd, f), getattr(jtd, f)
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert [(q.user, q.num, a) for q, a in pqa] == [(q.user, q.num, a) for q, a in jqa]


# -- encode_actuals and K3's plain version -----------------------------------------


def _random_eval_points(seed: int, n_queries: int, vocab: int, k: int):
    """tests/test_eval_fast_path.py's generator: empty actuals, out-of-vocab
    actuals and short prediction rows (-1 after a query's num cap)."""
    rng = np.random.default_rng(seed)
    index = {f"i{j}": j for j in range(vocab)}
    pred = np.full((n_queries, k), -1, dtype=np.int32)
    actuals: list[list[str]] = []
    for qi in range(n_queries):
        n_pred = int(rng.integers(0, k + 1))
        pred[qi, :n_pred] = rng.choice(vocab, size=n_pred, replace=False)
        if qi % 7 == 3:
            actuals.append([])
            continue
        ids = [f"i{j}" for j in rng.choice(vocab, size=rng.integers(1, 6), replace=False)]
        if qi % 5 == 0:
            ids.append(f"oov{qi}")
        actuals.append(ids)
    return pred, actuals, index


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_actuals_equal_jax(seed):
    _, actuals, index = _random_eval_points(seed, 150, 40, 8)
    actuals.append({"item": "i3", "rating": 4.0})  # a k-fold held-out rating
    actuals.append({"item": "gone", "rating": 2.0})
    p_enc, p_counts = tranking.encode_actuals(actuals, index)
    j_enc, j_counts = jranking.encode_actuals(actuals, index)
    assert p_enc.dtype == j_enc.dtype and np.array_equal(p_enc, j_enc)
    assert np.array_equal(p_counts, j_counts)
    assert tranking.ACTUAL_PAD == jranking.ACTUAL_PAD


@pytest.mark.parametrize("seed,k,width", [(0, 8, 8), (1, 8, 3), (2, 1, 1), (3, 40, 40),
                                          (4, 10, 1), (5, 2, 2), (6, 3, 3), (7, 10, 10),
                                          (8, 31, 31), (9, 32, 32), (10, 33, 33),
                                          (11, 128, 100)])
def test_ranking_metrics_plain_equals_jax(seed, k, width):
    """Held to the JAX package's ``ranking_metrics_batch`` on the cases of
    tests/test_eval_fast_path.py:79-125: -1 slots, codes <= -2, empty
    actual rows, and a prediction width below k; and at widths on both
    sides of each of K3's lane-group sizes (1, 2, 3, 10, 31, 32, 33,
    100: ``k3_group``). Width 100 runs at k = 128:
    :func:`test_ranking_precision_is_a_true_division` pins what differs at
    k = 100."""
    pred, actuals, index = _random_eval_points(seed, 300, max(60, k), k)
    enc, counts = tranking.encode_actuals(actuals, index)
    pred = np.ascontiguousarray(pred[:, :width])
    port = [r.numpy() for r in ttopk.ranking_metrics_batch(pred, enc, counts, k)]
    ref = [np.asarray(r) for r in jtopk.ranking_metrics_batch(pred, enc, counts, k=k)]
    assert np.array_equal(port[0], ref[0]) and np.array_equal(port[3], ref[3])
    np.testing.assert_allclose(port[1], ref[1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(port[2], ref[2], rtol=0, atol=1e-6)
    assert port[3].dtype == np.bool_ and port[0].dtype == np.float32


def test_ranking_metrics_match_per_query_functions():
    """The plain version against core/ranking.py's per-query functions
    (tests/test_eval_fast_path.py:79-100)."""
    K = 8
    pred, actuals, index = _random_eval_points(0, 200, 40, K)
    enc, counts = tranking.encode_actuals(actuals, index)
    precision, ap, ndcg, valid = (r.numpy() for r in
                                  ttopk.ranking_metrics_batch(pred, enc, counts, K))
    inv = {j: s for s, j in index.items()}
    for qi in range(pred.shape[0]):
        raw = [inv[j] for j in pred[qi] if j >= 0]
        p_ref = tranking.precision_at_k(raw, actuals[qi], K)
        if p_ref is None:
            assert not valid[qi]
            continue
        assert valid[qi]
        assert precision[qi] == pytest.approx(p_ref, abs=1e-6)
        assert ap[qi] == pytest.approx(tranking.average_precision_at_k(raw, actuals[qi], K),
                                       abs=1e-6)
        assert ndcg[qi] == pytest.approx(tranking.ndcg_at_k(raw, actuals[qi], K), abs=1e-6)


def test_ranking_metrics_smaller_k_is_exact_prefix():
    pred, actuals, index = _random_eval_points(1, 64, 30, 8)
    enc, counts = tranking.encode_actuals(actuals, index)
    direct = ttopk.ranking_metrics_batch(pred[:, :3].copy(), enc, counts, 3)
    sliced = ttopk.ranking_metrics_batch(torch.from_numpy(pred)[:, :3], enc, counts, 3)
    for a, b in zip(direct, sliced):
        assert torch.equal(a, b)


def test_ranking_metrics_empty_and_refusals():
    enc, counts = tranking.encode_actuals([], {})
    out = ttopk.ranking_metrics_batch(np.zeros((0, 4), np.int32), enc, counts, 4)
    assert all(o.shape == (0,) for o in out)
    with pytest.raises(ValueError, match="pred_ids"):
        ttopk.ranking_metrics_batch(np.zeros((3, 4), np.int32),
                                    np.zeros((2, 1), np.int32), np.zeros(3, np.int32), 4)


def test_ranking_precision_is_a_true_division():
    """A known difference from the JAX package, kept: the port's precision
    is ``hits / k`` rounded once (K3 divides with ``__fdiv_rn``, its plain
    version by a tensor), while XLA compiles the JAX package's ``hits /
    float(k)`` to ``hits * fl(1 / k)``, which rounds twice. The two agree
    where ``1 / k`` is exact (k a power of two) and within one ulp
    elsewhere: at k = 100, 30 of the hit counts 0..100 differ."""
    k = 100
    Q = k + 1
    pred = np.tile(np.arange(k, dtype=np.int32), (Q, 1))
    actual = np.full((Q, k), tranking.ACTUAL_PAD, np.int32)
    for q in range(Q):  # row q hits its first q positions
        actual[q, :q] = np.arange(q)
    counts = np.maximum(np.arange(Q), 1).astype(np.int32)
    port = ttopk.ranking_metrics_batch(pred, actual, counts, k)[0].numpy()
    ref = np.asarray(jtopk.ranking_metrics_batch(pred, actual, counts, k=k)[0])
    hits = np.arange(Q, dtype=np.float32)
    assert np.array_equal(port, hits / np.float32(k))
    assert np.array_equal(ref, hits * (np.float32(1) / np.float32(k)))
    ulp = np.spacing(np.maximum(np.abs(port), np.abs(ref)))
    assert (np.abs(port - ref) <= ulp).all() and int((port != ref).sum()) == 30
    for k2 in (1, 8, 32, 128):  # 1 / k exact: the same bits
        p2 = ttopk.ranking_metrics_batch(pred[:, :1], actual, counts, k2)[0].numpy()
        r2 = np.asarray(jtopk.ranking_metrics_batch(pred[:, :1], actual, counts, k=k2)[0])
        assert np.array_equal(p2, r2)


@pytest.mark.parametrize("P", [0, 1, 2, 3, 10, 31, 32, 33, 100])
def test_k3_group_matches_the_cu(P):
    """K3's lanes a query row (ops/topk.py ``k3_group``) are the kernel's
    own choice (csrc/ranking.cu ``k3_group``: a chain of ``P <= n ? g``),
    a power of two from 1 to K3_MAX_GROUP, the fewest that leave a lane
    at most K3_POSITIONS rank positions."""
    import re
    from pathlib import Path

    src = (Path(ttopk.__file__).resolve().parent.parent / "csrc" / "ranking.cu").read_text()
    assert int(re.search(r"constexpr int K3_MAX_GROUP = (\d+);", src).group(1)) == \
        ttopk.K3_MAX_GROUP
    assert int(re.search(r"constexpr int K3_POSITIONS = (\d+);", src).group(1)) == \
        ttopk.K3_POSITIONS
    body = src[src.index("int k3_group(int P)"):]
    body = body[body.index("return") + len("return"):body.index(";")]
    steps = [(int(n), int(g)) for n, g in re.findall(r"P <= (\d+) \? (\d+)", body)]
    last = int(body.rsplit(":", 1)[1])
    cu = next((g for n, g in steps if P <= n), last)
    g = ttopk.k3_group(P)
    assert g == cu
    assert g & (g - 1) == 0 and 1 <= g <= ttopk.K3_MAX_GROUP
    assert g == ttopk.K3_MAX_GROUP or P <= ttopk.K3_POSITIONS * g
    assert g == 1 or P > ttopk.K3_POSITIONS * (g // 2)


def test_ranking_cpu_calls_launch_no_kernel():
    pred, actuals, index = _random_eval_points(2, 20, 10, 4)
    enc, counts = tranking.encode_actuals(actuals, index)
    before = ttopk.ranking_metrics_batch.launches.value
    ttopk.ranking_metrics_batch(pred, enc, counts, 4)
    assert ttopk.ranking_metrics_batch.launches.value == before


# -- top_k_items_batch ------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("k,masked", [(1, False), (5, True), (10, False), (400, True)])
def test_top_k_items_batch_equals_jax(dtype, k, masked):
    rng = np.random.default_rng(7)
    queries = rng.normal(size=(33, 12)).astype(np.float32)
    items = rng.normal(size=(300, 12)).astype(np.float32)
    mask = rng.random(300) < 0.2 if masked else None
    if dtype == "int8":
        q, s = tals.quantize_rows(torch.from_numpy(items))
        port_items, jax_items = (q, s), (jnp.asarray(q.numpy()), jnp.asarray(s.numpy()))
    else:
        port_items, jax_items = torch.from_numpy(items), jnp.asarray(items)
    sp, ip = ttopk.top_k_items_batch(queries, port_items, k,
                                     None if mask is None else torch.from_numpy(mask))
    sj, ij = jtopk.top_k_items_batch(jnp.asarray(queries), jax_items, k=k,
                                     exclude_mask=None if mask is None else jnp.asarray(mask))
    assert ip.dtype == torch.int32 and ip.shape == (33, min(k, 300))
    assert np.array_equal(ip.numpy(), np.asarray(ij))
    np.testing.assert_allclose(sp.numpy(), np.asarray(sj), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("k,I,B,chunks", [
    (4, 26_744, 1, 1), (4, 26_744, 64, 1), (128, 26_744, 64, 1), (200, 26_744, 64, 1),
    (1, 3_706, 524_280, 1), (1, 3_706, 524_281, 2), (1, 3_706, 1_200_000, 3),
    (10, 3_706, 333_334, 2), (200, 26_744, 20_000, 3),
])
def test_k2_chunk_plan(k, I, B, chunks):
    """K2's row chunks (ops/topk.py k2_chunks): at most 65,535 x 8 rows
    a chunk (CUDA's gridDim.y row blocks), and the route's scratch within
    K2_SCRATCH_BYTES; serving batches are one chunk; the chunks cover the
    rows in order."""
    plan = ttopk.k2_chunks(k, I, B)
    assert len(plan) == chunks
    assert plan[0][0] == 0 and plan[-1][1] == B
    assert all(a[1] == b[0] for a, b in zip(plan, plan[1:]))
    route = ttopk.k2_route(k, I, B)
    per_row = route.tiles * route.group * 8 if route.name == "tile" else I * 4 + k * 8
    for lo, hi in plan:
        assert 0 < hi - lo <= ttopk.K2_MAX_GRID_Y * ttopk.K2_TILE_B
        assert hi - lo == 1 or (hi - lo) * per_row <= ttopk.K2_SCRATCH_BYTES
    assert ttopk.k2_launches(k, I, B) == len(plan) * (2 if route.name == "tile" else 2)


def test_k2_tile_rows_constant_matches_the_cu():
    import re
    from pathlib import Path

    src = (Path(ttopk.__file__).resolve().parent.parent / "csrc" / "topk.cu").read_text()
    assert int(re.search(r"constexpr int TILE_B = (\d+);", src).group(1)) == ttopk.K2_TILE_B


# -- the fast path's parity and gates (tests/test_eval_fast_path.py:144-345) -------


@dataclass
class _SynthDSParams(Params):
    seed: int = 0
    n_users: int = 40
    n_items: int = 25
    n_queries: int = 120


class _SynthDS(DataSource):
    """tests/test_eval_fast_path.py's eval sets on the port: unknown users,
    empty actual sets, out-of-vocab actual ids, per-query num caps."""

    params_class = _SynthDSParams

    def _training(self, rng):
        p = self.params
        n = p.n_users * 15
        return trec.TrainingData(
            user_ids=[f"u{j}" for j in range(p.n_users)],
            item_ids=[f"i{j}" for j in range(p.n_items)],
            rows=rng.integers(0, p.n_users, n).astype(np.int32),
            cols=rng.integers(0, p.n_items, n).astype(np.int32),
            ratings=rng.integers(1, 6, n).astype(np.float32),
        )

    def read_training(self, ctx):
        return self._training(np.random.default_rng(self.params.seed))

    def read_eval(self, ctx):
        p = self.params
        folds = []
        for fold in range(2):
            rng = np.random.default_rng(p.seed * 1000 + fold)
            td = self._training(rng)
            qa = []
            for qi in range(p.n_queries):
                user = f"ghost{qi}" if qi % 11 == 5 else f"u{rng.integers(0, p.n_users)}"
                q = trec.Query(user=user, num=int(rng.integers(1, 9)))
                if qi % 7 == 3:
                    qa.append((q, []))
                    continue
                ids = [f"i{j}" for j in rng.choice(p.n_items, size=rng.integers(1, 5),
                                                   replace=False)]
                if qi % 5 == 0:
                    ids.append(f"oov{qi}")
                qa.append((q, ids))
            folds.append((td, {"fold": fold}, qa))
        return folds


def _make_engine(algo_cls=trec.ALSAlgorithm, serving_cls=FirstServing, ds=_SynthDS):
    return Engine(datasource_classes=ds, preparator_classes=trec.RecommendationPreparator,
                  algorithm_classes={"als": algo_cls}, serving_classes=serving_cls)


def _candidates(n=4, **extra):
    return [EngineParams(datasource=("", _SynthDSParams()), algorithms=[(
        "als", trec.ALSAlgorithmParams(rank=8, num_iterations=3, lambda_=0.01 * (ci + 1),
                                       seed=5, **extra))]) for ci in range(n)]


def _scores_of(result):
    return [[ms.score, *ms.other_scores] for _ep, ms in result.engine_params_scores]


K = 5
METRIC_KW = dict(other_metrics=[MAPAtK(k=K), NDCGAtK(k=K)])


def test_device_path_matches_per_query_path():
    candidates = _candidates(4)
    fast = MetricEvaluator(PrecisionAtK(k=K), **METRIC_KW).evaluate(
        CPU, _make_engine(), candidates)
    serial = MetricEvaluator(PrecisionAtK(k=K), use_device_path=False, **METRIC_KW).evaluate(
        CPU, _make_engine(), candidates)
    assert fast.fast_path_candidates == 4 and serial.fast_path_candidates == 0
    np.testing.assert_allclose(_scores_of(fast), _scores_of(serial), atol=1e-6)
    assert fast.best_idx == serial.best_idx
    assert set(fast.phase_seconds) >= {"train", "predict", "metric"}
    assert fast.cache_stats["misses"]["topk"] == 4
    assert "serial" in serial.phase_seconds


def test_empty_actuals_score_nan():
    class AllEmptyDS(_SynthDS):
        def read_eval(self, ctx):
            return [(td, info, [(q, []) for q, _ in qa])
                    for td, info, qa in super().read_eval(ctx)]

    wf = FastEvalEngineWorkflow(_make_engine(ds=AllEmptyDS), CPU)
    vals = wf.eval_device(_candidates(1)[0], [PrecisionAtK(k=K)])
    assert vals is not None and np.isnan(vals[0])


def test_metric_subclass_falls_back():
    class MyPrecision(PrecisionAtK):
        pass

    sub = MetricEvaluator(MyPrecision(k=K)).evaluate(CPU, _make_engine(), _candidates(2))
    stock = MetricEvaluator(PrecisionAtK(k=K)).evaluate(CPU, _make_engine(), _candidates(2))
    assert MyPrecision(k=K).device_spec() is None
    assert sub.fast_path_candidates == 0 and stock.fast_path_candidates == 2
    np.testing.assert_allclose(_scores_of(sub), _scores_of(stock), atol=1e-6)


def test_custom_serving_falls_back():
    class PassServing(Serving):
        def serve(self, query, predictions):
            return predictions[0]

    result = MetricEvaluator(PrecisionAtK(k=K)).evaluate(
        CPU, _make_engine(serving_cls=PassServing), _candidates(2))
    assert result.fast_path_candidates == 0
    assert all(np.isfinite(s) for row in _scores_of(result) for s in row)


def test_algorithm_without_eval_topk_falls_back():
    class NoTopK(trec.ALSAlgorithm):
        eval_topk = Algorithm.eval_topk

    no_topk = MetricEvaluator(PrecisionAtK(k=K)).evaluate(
        CPU, _make_engine(algo_cls=NoTopK), _candidates(2))
    stock = MetricEvaluator(PrecisionAtK(k=K)).evaluate(CPU, _make_engine(), _candidates(2))
    assert no_topk.fast_path_candidates == 0
    np.testing.assert_allclose(_scores_of(no_topk), _scores_of(stock), atol=1e-6)


def test_eval_device_gates_directly():
    wf = FastEvalEngineWorkflow(_make_engine(), CPU)
    ep = _candidates(1)[0]

    class NotStock(PrecisionAtK):
        pass

    assert wf.eval_device(ep, [NotStock(k=K)]) is None
    assert wf.fast_path_candidates == 0
    vals = wf.eval_device(ep, [PrecisionAtK(k=K), MAPAtK(k=K)])
    assert vals is not None and len(vals) == 2 and wf.fast_path_candidates == 1
    wf.eval_device(ep, [PrecisionAtK(k=K), MAPAtK(k=K)])
    assert wf.hits["topk"] == 1


def test_sharded_serving_raises_on_the_fast_path():
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        FastEvalEngineWorkflow(_make_engine(), CPU).eval_device(
            _candidates(1, sharded_serving=True)[0], [PrecisionAtK(k=K)])


def test_a_failing_sweep_raises_instead_of_falling_back(monkeypatch):
    """A failure inside the stacked training (a kernel build or launch on
    the card) is not swallowed into the serial path."""

    def broken(*a, **k):
        raise RuntimeError("K1s launch failed")

    monkeypatch.setattr(tals, "als_train_sweep", broken)
    with pytest.raises(RuntimeError, match="K1s launch failed"):
        MetricEvaluator(PrecisionAtK(k=K)).evaluate(CPU, _make_engine(), _candidates(2))


def test_eval_topk_rows_capped_and_unknown_users_empty():
    td = _training(trec, 3)
    algo = trec.ALSAlgorithm(trec.ALSAlgorithmParams(rank=4, num_iterations=2))
    algo.device = torch.device("cpu")
    model = algo.train(CPU, td)
    qs = [trec.Query(user="u1", num=2), trec.Query(user="nobody", num=4),
          trec.Query(user="u2", num=9)]
    out = algo.eval_topk(model, qs, 5)
    ids = out.ids.numpy()
    assert ids.shape == (3, 5) and (ids[0, 2:] == -1).all() and (ids[1] == -1).all()
    assert (ids[2] >= 0).all() and out.index is model.item_index
    solo = algo.predict(model, trec.Query(user="u2", num=5))
    assert [model.item_index.inverse[int(i)] for i in ids[2]] == [
        s.item for s in solo.itemScores]


def test_swept_models_keep_their_tables_on_the_device():
    """``train_sweep``'s models hold the tables K1s trained as their
    device copy, so ``eval_topk`` uploads nothing; they score as a model
    rebuilt from the same host arrays does."""
    td = _training(trec, 3)
    algo = trec.ALSAlgorithm(trec.ALSAlgorithmParams(rank=4, num_iterations=2))
    algo.device = torch.device("cpu")
    plist = [trec.ALSAlgorithmParams(rank=4, num_iterations=2, lambda_=reg)
             for reg in (0.01, 0.1)]
    models = algo.train_sweep(CPU, td, plist)
    qs = [trec.Query(user=f"u{j}", num=5) for j in range(6)]
    for model in models:
        assert model._device is not None and model._device[0] == torch.device("cpu")
        U, _ = model.device_factors(torch.device("cpu"))
        assert torch.equal(U, torch.from_numpy(model.user_factors))
        fresh = trec.ALSModel(model.user_index, model.item_index,
                              model.user_factors, model.item_factors)
        a, b = algo.eval_topk(model, qs, 5), algo.eval_topk(fresh, qs, 5)
        assert torch.equal(a.ids, b.ids) and torch.equal(a.scores, b.scores)


# -- the whole slice against the JAX package ----------------------------------------


def _fixed_init(num: int, rank: int) -> np.ndarray:
    """The initial factors both packages are given in the slice test: a
    function of the table's shape, drawn with numpy."""
    rng = np.random.default_rng(num * 1000 + rank)
    return (rng.normal(size=(num, rank)) / np.sqrt(rank)).astype(np.float32)


SLICE_SWEEP = [(4, 0.05), (8, 0.05), (8, 0.2)]  # one padded group in both packages


def _write_events(storage_mod, event_mod, env, events):
    storage = storage_mod.Storage(env=env)
    app_id = storage.get_metadata_apps().insert(storage_mod.App(0, "EvalApp"))
    storage.get_events().init(app_id)
    storage.get_events().batch_insert([
        event_mod.Event(event="rate", entity_type="user", entity_id=u,
                        target_entity_type="item", target_entity_id=i,
                        properties={"rating": r}) for u, i, r in events], app_id)
    return storage


def _evaluation(eval_mod, params_mod, rank_mod, rec, answers, folds):
    class RecordingSource(rec.RecommendationDataSource):
        def read_eval(self, ctx):
            folds[:] = super().read_eval(ctx)
            return folds

    class Recording(rec.ALSAlgorithm):
        def eval_topk(self, model, queries, k):
            out = super().eval_topk(model, queries, k)
            answers.append((self.params.rank, self.params.lambda_, queries, out))
            return out

    engine = type(rec.engine())(
        datasource_classes=RecordingSource,
        preparator_classes=rec.RecommendationPreparator,
        algorithm_classes={"als": Recording},
        serving_classes=rec.engine().serving_classes[""],
    )
    grid = params_mod.EngineParamsGenerator()
    grid.engine_params_list = [engine.params_from_variant({
        "datasource": {"params": {"app_name": "EvalApp"}},
        "algorithms": [{"name": "als", "params": {
            "rank": r, "lambda": reg, "num_iterations": 2}}]}) for r, reg in SLICE_SWEEP]
    return eval_mod.Evaluation(engine=engine, evaluator=eval_mod.MetricEvaluator(
        metric=rank_mod.PrecisionAtK(k=1),
        other_metrics=[rank_mod.MAPAtK(k=1), rank_mod.NDCGAtK(k=1)])), grid


def test_run_evaluation_matches_jax(monkeypatch, tmp_path):
    from predictionio_tpu.core import evaluation as jeval
    from predictionio_tpu.core import params as jparams
    from predictionio_tpu.core.workflow_eval import run_evaluation as jrun
    from predictionio_tpu.data import event as jevent
    from predictionio_tpu.data import storage as jst
    from predictionio_tpu.models import recommendation as jrec
    from predictionio_tpu_torch.core import evaluation as teval
    from predictionio_tpu_torch.core import params as tparams
    from predictionio_tpu_torch.core.workflow_eval import run_evaluation as trun
    from predictionio_tpu_torch.data import event as tevent
    from predictionio_tpu_torch.data import storage as tst

    monkeypatch.setattr(jals, "init_factors",
                        lambda num, rank, key, scale=None: jnp.asarray(_fixed_init(num, rank)))
    monkeypatch.setattr(tals, "init_factors",
                        lambda num, rank, generator, device="cpu", scale=None:
                        torch.from_numpy(_fixed_init(num, rank)).to(device))
    rng = np.random.default_rng(21)
    n = 2400
    events = list(zip((f"u{u}" for u in rng.integers(0, 300, n)),
                      (f"i{i}" for i in rng.integers(0, 80, n)),
                      (float(r) for r in rng.integers(1, 6, n))))
    results = {}
    for name, st, ev, evm, pm, rk, rec, run, ctx in (
        ("port", tst, tevent, teval, tparams, tranking, trec, trun,
         WorkflowContext(mode="Evaluation", device="cpu")),
        ("jax", jst, jevent, jeval, jparams, jranking, jrec, jrun, None),
    ):
        env = {"PIO_FS_BASEDIR": str(tmp_path / name),
               "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
               "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
               "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
               "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "MEM"}
        storage = _write_events(st, ev, env, events)
        st.set_storage(storage)
        try:
            answers, folds = [], []
            evaluation, grid = _evaluation(evm, pm, rk, rec, answers, folds)
            kw = {"ctx": ctx} if ctx is not None else {}
            iid, result = run(evaluation, grid, storage=storage, **kw)
            inst = storage.get_metadata_evaluation_instances().get(iid)
            assert inst.status == "EVALCOMPLETED"
            results[name] = (result, answers, folds)
        finally:
            st.set_storage(None)
    port, jax_ = results["port"][0], results["jax"][0]
    assert port.fast_path_candidates == jax_.fast_path_candidates == len(SLICE_SWEEP)
    p_ans, j_ans = results["port"][1], results["jax"][1]
    assert [a[:2] for a in p_ans] == [a[:2] for a in j_ans]
    folds = results["port"][2]
    tied_rows = 0
    patched: dict[tuple, list] = {}
    for (rank, reg, qs, pa), (_, _, _, ja) in zip(p_ans, j_ans):
        pi, ji = pa.ids.numpy().copy(), np.asarray(ja.ids)
        differ = np.flatnonzero((pi != ji).any(axis=1))
        tied_rows += len(differ)
        for r in differ:  # a flipped row is a near tie of its top item
            assert abs(float(np.asarray(ja.scores)[r, 0])
                       - float(pa.scores.numpy()[r, 0])) < 1e-5, f"row {r} is no tie"
        pi[differ] = ji[differ]
        qa = next(qa for _, _, qa in folds if qa[0][0] is qs[0])
        inv = pa.index.inverse
        patched.setdefault((rank, reg), []).extend(
            ([inv[int(i)] for i in row if i >= 0], a) for row, (_, a) in zip(pi, qa))
    p_scores, j_scores = np.asarray(_scores_of(port)), np.asarray(_scores_of(jax_))
    if tied_rows == 0:
        np.testing.assert_allclose(p_scores, j_scores, rtol=0, atol=1e-6)
        assert port.best_idx == jax_.best_idx
    # with the JAX package's rows in the tied rows' place, the per-query
    # functions give the JAX package's scores
    for (rank, reg), want in zip(SLICE_SWEEP, j_scores):
        pts = patched[(rank, reg)]
        got = [np.mean([f(p, a, 1) for p, a in pts]) for f in (
            tranking.precision_at_k, tranking.average_precision_at_k, tranking.ndcg_at_k)]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_eval_verb_end_to_end_on_sqlite(tmp_path, monkeypatch):
    """``cli.main eval --device cpu`` of the shipped sweep on a sqlite
    store: an EVALCOMPLETED instance whose views the JAX package reads
    back, and a last stdout line with the JAX verb's summary keys."""
    from predictionio_tpu.data import storage as jst
    from predictionio_tpu_torch.cli import main as cli
    from predictionio_tpu_torch.data import event as tevent
    from predictionio_tpu_torch.data import storage as tst

    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
    monkeypatch.setenv("PIO_EVAL_APP_NAME", "EvalApp")
    rng = np.random.default_rng(4)
    n = 1500
    events = list(zip((f"u{u}" for u in rng.integers(0, 150, n)),
                      (f"i{i}" for i in rng.integers(0, 60, n)),
                      (float(r) for r in rng.integers(1, 6, n))))
    tst.set_storage(None)
    storage = _write_events(tst, tevent, {"PIO_FS_BASEDIR": str(tmp_path)}, events)
    storage.close()
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["eval",
                           "predictionio_tpu_torch.models.recommendation_eval.evaluation",
                           "predictionio_tpu_torch.models.recommendation_eval.param_grid",
                           "--device", "cpu"])
    finally:
        tst.get_storage().close()
        tst.set_storage(None)
    assert rc == 0
    lines = buf.getvalue().strip().splitlines()
    summary = json.loads(lines[-1])
    assert set(summary) == {"metric", "best_index", "best_params", "best_scores", "scores",
                            "candidates", "fast_path_candidates", "phase_seconds", "cache",
                            "instance_id"}
    assert summary["candidates"] == summary["fast_path_candidates"] == 4
    assert lines[-2] == f"Evaluation completed. Evaluation instance ID: {summary['instance_id']}"
    # the JAX package reads the port's instance from the same sqlite file
    jstorage = jst.Storage(env={"PIO_FS_BASEDIR": str(tmp_path)})
    inst = jstorage.get_metadata_evaluation_instances().get(summary["instance_id"])
    jstorage.close()
    assert inst.status == "EVALCOMPLETED"
    assert inst.evaluator_results == lines[-3]
    assert json.loads(inst.evaluator_results_json)["bestIndex"] == summary["best_index"]


def test_eval_verb_runs_on_cuda_unless_told_otherwise(tmp_path, monkeypatch):
    """Without ``--device cpu`` the verb asks for CUDA, and on a machine
    without it raises rather than evaluating on the CPU."""
    from predictionio_tpu_torch.cli import main as cli

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["eval", "predictionio_tpu_torch.models.recommendation_eval.evaluation"])


def test_evaluation_instances_round_trip_between_packages(tmp_path):
    """The sqlite rows are the JAX package's: either package reads what
    the other wrote."""
    from datetime import datetime, timezone

    from predictionio_tpu.data import storage as jst
    from predictionio_tpu_torch.data import storage as tst

    now = datetime(2026, 1, 2, 3, 4, 5, tzinfo=timezone.utc)
    for writer, reader in ((tst, jst), (jst, tst)):
        w = writer.Storage(env={"PIO_FS_BASEDIR": str(tmp_path)})
        iid = w.get_metadata_evaluation_instances().insert(writer.EvaluationInstance(
            id="", status="INIT", start_time=now, end_time=now,
            evaluation_class="a.b", batch="x", env={"k": "v"},
            evaluator_results_json='{"s": 1}'))
        w.close()
        r = reader.Storage(env={"PIO_FS_BASEDIR": str(tmp_path)})
        got = r.get_metadata_evaluation_instances().get(iid)
        r.close()
        assert (got.status, got.start_time, got.evaluation_class, got.batch, got.env,
                got.evaluator_results_json) == ("INIT", now, "a.b", "x", {"k": "v"},
                                                '{"s": 1}')
