"""The port's model file reader/writer against the JAX package's.

A model file either package writes, the other reads: the JAX package
serializes an ALSModel or a SimilarProductModel (f32, bf16, int8
storage) and the port loads the same arrays, id maps and categories; the
port's file reads back in the JAX package as its own class.
Class names resolve through the port's fixed table; corrupt files and
pickled models are refused.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from predictionio_tpu.core import persistence as jpersist
from predictionio_tpu.data.bimap import BiMap as JBiMap
from predictionio_tpu.models import modelfile as jmf
from predictionio_tpu.models import recommendation as jrec
from predictionio_tpu.models import similarproduct as jsim
from predictionio_tpu_torch.core import persistence as tpersist
from predictionio_tpu_torch.models import modelfile as tmf
from predictionio_tpu_torch.models import recommendation as trec
from predictionio_tpu_torch.models import similarproduct as tsim

STORAGE = ("float32", "bfloat16", "int8")


def _jax_model(storage: str, n_users=13, n_items=9, rank=5) -> jrec.ALSModel:
    rng = np.random.default_rng(STORAGE.index(storage))
    uf = rng.standard_normal((n_users, rank), dtype=np.float32)
    vf = rng.standard_normal((n_items, rank), dtype=np.float32)
    us = vs = None
    if storage == "int8":
        from predictionio_tpu.ops import als as jals

        uq, us_ = jals.quantize_rows(jnp.asarray(uf))
        vq, vs_ = jals.quantize_rows(jnp.asarray(vf))
        uf, us, vf, vs = (np.asarray(a) for a in (uq, us_, vq, vs_))
    elif storage == "bfloat16":
        uf = np.asarray(jnp.asarray(uf, jnp.bfloat16))
        vf = np.asarray(jnp.asarray(vf, jnp.bfloat16))
    return jrec.ALSModel(
        user_index=JBiMap.from_dense([f"u{j}" for j in range(n_users)]),
        item_index=JBiMap.from_dense([f"ié{j}" for j in range(n_items)]),
        user_factors=uf, item_factors=vf, user_scales=us, item_scales=vs,
    )


def _bits(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype.names == ("bfloat16",):
        return a.view(np.uint16)
    return a.view(np.uint8)


def _assert_same_model(a, b):
    assert a.user_index.to_dict() == b.user_index.to_dict()
    assert a.item_index.to_dict() == b.item_index.to_dict()
    for f in ("user_factors", "item_factors", "user_scales", "item_scales"):
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
            continue
        assert x.shape == y.shape, f
        np.testing.assert_array_equal(_bits(x), _bits(y), err_msg=f)


class _Algo:
    def make_persistent_model(self, model):
        return model


@pytest.mark.parametrize("storage", STORAGE)
def test_port_reads_jax_written_file(storage):
    jm = _jax_model(storage)
    blob = jmf.serialize([("arrays", jm)], "m1")
    [(kind, tm)] = tmf.deserialize(blob)
    assert kind == "arrays" and isinstance(tm, trec.ALSModel)
    _assert_same_model(tm, jm)
    if storage == "bfloat16":
        assert tm.user_factors.dtype == tmf.BFLOAT16
    # the persistence layer resolves the same blob for an engine's slots
    [tm2] = tpersist.deserialize_models(
        jpersist.serialize_models([_Algo()], [jm], "m1"), [_Algo()], "m1"
    )
    _assert_same_model(tm2, jm)


@pytest.mark.parametrize("storage", STORAGE)
def test_jax_reads_port_written_file(storage):
    jm = _jax_model(storage)
    tm = trec.model_from_numpy(
        [jm.user_index.inverse[j] for j in range(len(jm.user_index))],
        [jm.item_index.inverse[j] for j in range(len(jm.item_index))],
        jm.user_factors, jm.item_factors, jm.user_scales, jm.item_scales,
    )
    blob = tpersist.serialize_models([_Algo()], [tm], "m2")
    [(kind, back)] = jmf.deserialize(blob)
    assert kind == "arrays"
    _assert_same_model(back, jm)
    if storage == "bfloat16":  # the block carries the JAX package's bf16 tag
        assert jmf.ModelFile(blob)._arr("e0.user_factors").dtype.name == "bfloat16"
    # and the port reads its own file back
    [again] = tpersist.deserialize_models(blob, [_Algo()], "m2")
    _assert_same_model(again, jm)


def test_port_writes_its_own_class_name():
    """A ported model class is recorded under the JAX package's name, so
    the JAX package deploys a port-trained model as its own ALSModel;
    the port reads that name back as its own class."""
    tm = trec.model_from_numpy(["a"], ["x"], np.ones((1, 2), np.float32),
                               np.ones((1, 2), np.float32))
    blob = tmf.serialize([("arrays", tm)], "m")
    mf = tmf.ModelFile(blob)
    assert mf._header["entries"][0]["cls"] == [
        "predictionio_tpu.models.recommendation", "ALSModel"]
    [(_, back)] = tmf.deserialize(blob)
    assert type(back) is trec.ALSModel
    [(_, jback)] = jmf.deserialize(blob)
    assert type(jback) is jrec.ALSModel


def test_mmap_deploy_path(tmp_path):
    jm = _jax_model("int8")
    path = tmp_path / "model.bin"
    path.write_bytes(jpersist.serialize_models([_Algo()], [jm], "m3"))
    [tm] = tpersist.deserialize_model_path(path, [_Algo()], "m3")
    _assert_same_model(tm, jm)


def test_corrupt_header_raises():
    blob = bytearray(jmf.serialize([("arrays", _jax_model("float32"))], "m"))
    blob[30] ^= 0xFF  # inside the JSON header: crc mismatch
    with pytest.raises(tmf.ModelFileError, match="checksum"):
        tmf.deserialize(bytes(blob))


def test_bad_magic_and_truncation_raise():
    blob = jmf.serialize([("arrays", _jax_model("float32"))], "m")
    with pytest.raises(tmf.ModelFileError, match="magic"):
        tmf.deserialize(b"NOTMODEL" + blob[8:])
    with pytest.raises(tmf.ModelFileError, match="truncated"):
        tmf.deserialize(blob[:-40])


def test_block_checksums_under_verify(monkeypatch):
    blob = bytearray(jmf.serialize([("arrays", _jax_model("float32"))], "m"))
    blob[-1] ^= 0x01  # last byte of the last array block
    tmf.deserialize(bytes(blob))  # not verified by default
    monkeypatch.setenv("PIO_MODEL_VERIFY", "1")
    with pytest.raises(tmf.ModelFileError, match="checksum"):
        tmf.deserialize(bytes(blob))


def test_legacy_pickle_manifest_is_refused(monkeypatch):
    monkeypatch.setenv("PIO_MODEL_MMAP", "0")
    blob = jpersist.serialize_models([_Algo()], [_jax_model("float32")], "m")
    assert not jmf.is_modelfile(blob)
    with pytest.raises(tmf.ModelFileError, match="retrain"):
        tpersist.deserialize_models(blob, [_Algo()], "m")


def test_pickle_entry_and_unported_class_are_refused():
    blob = jmf.serialize([("pickle", b"\x80\x04N.")], "m")
    with pytest.raises(tmf.ModelFileError, match="pickled"):
        tpersist.deserialize_models(blob, [_Algo()], "m")
    with pytest.raises(tmf.ModelFileError, match="no counterpart"):
        tmf.resolve_class("predictionio_tpu.models.classification", "NBModel")


def test_retrain_marker_round_trips():
    class Retrain:
        def make_persistent_model(self, model):
            return None

    blob = tpersist.serialize_models([Retrain()], [object()], "m")
    [m] = jpersist.deserialize_models(blob, [Retrain()], "m")
    assert m is jpersist.RETRAIN
    [m] = tpersist.deserialize_models(blob, [Retrain()], "m")
    assert m is tpersist.RETRAIN


def test_tensor_fields_are_pulled_to_the_host():
    import torch

    tm = trec.model_from_numpy(["a", "b"], ["x"], np.ones((2, 3), np.float32),
                               np.ones((1, 3), np.float32))
    tm = dataclasses.replace(
        tm, user_factors=torch.full((2, 3), 1.5, dtype=torch.bfloat16))
    blob = tpersist.serialize_models([_Algo()], [tm], "m")
    [(_, back)] = tmf.deserialize(blob)
    assert back.user_factors.dtype == tmf.BFLOAT16  # the port's host bf16
    [(_, jback)] = jmf.deserialize(blob)
    assert jback.user_factors.dtype.name == "bfloat16"  # the JAX package's
    assert jmf.ModelFile(blob)._arr("e0.user_factors").dtype.name == "bfloat16"
    np.testing.assert_array_equal(
        np.asarray(jmf.ModelFile(blob)._arr("e0.user_factors"), np.float32), 1.5)


@pytest.mark.parametrize("storage", STORAGE)
def test_similar_product_model_files_cross(storage):
    """A JAX-written SimilarProductModel loads as the port's class with the
    same bits; the port writes it under the JAX package's class name, and
    the JAX package reads that file back as its own."""
    jm0 = _jax_model(storage, n_items=11)
    cats = {f"ié{j}": ["even" if j % 2 == 0 else "odd"] for j in range(0, 11, 3)}
    jm = jsim.SimilarProductModel(item_index=jm0.item_index, item_factors=jm0.item_factors,
                                  categories=cats, item_scales=jm0.item_scales)
    [(_, tm)] = tmf.deserialize(jmf.serialize([("arrays", jm)], "s1"))
    assert type(tm) is tsim.SimilarProductModel and tm.categories == cats
    assert tm.item_index.to_dict() == jm.item_index.to_dict()
    np.testing.assert_array_equal(_bits(tm.item_factors), _bits(jm.item_factors))
    assert (tm.item_scales is None) == (jm.item_scales is None)
    if jm.item_scales is not None:
        np.testing.assert_array_equal(tm.item_scales, jm.item_scales)
    blob = tpersist.serialize_models([_Algo()], [tm], "s2")
    assert tmf.ModelFile(blob)._header["entries"][0]["cls"] == [
        "predictionio_tpu.models.similarproduct", "SimilarProductModel"]
    [(_, back)] = jmf.deserialize(blob)
    assert type(back) is jsim.SimilarProductModel and back.categories == cats
    np.testing.assert_array_equal(_bits(back.item_factors), _bits(jm.item_factors))
