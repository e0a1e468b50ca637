"""Engine: named DASE component classes; variant JSON -> EngineParams.

Port of ``predictionio_tpu/core/engine.py`` for serving: component
registries keyed by name, instantiation, engine-params extraction from a
variant (jValueToEngineParams, Engine.scala:357-420), and engine factory
resolution. Training (``Engine.train``) is the next slice.
"""

from __future__ import annotations

import importlib
from typing import Any, Generic, Mapping, TypeVar

from predictionio_tpu_torch.core.base import (
    Algorithm,
    DataSource,
    Preparator,
    Serving,
    doer,
)
from predictionio_tpu_torch.core.params import EngineParams, Params

TD = TypeVar("TD")
PD = TypeVar("PD")
Q = TypeVar("Q")
P = TypeVar("P")
A = TypeVar("A")

_PORT = "predictionio_tpu_torch"
_JAX_PACKAGE = "predictionio_tpu"
#: the factory a deploy uses when neither the variant nor the instance names one
DEFAULT_ENGINE_FACTORY = f"{_PORT}.models.recommendation.engine"


class Engine(Generic[TD, PD, Q, P, A]):
    """An engine: named component classes for each DASE slot
    (``Engine(dataSourceClassMap, preparatorClassMap, algorithmClassMap,
    servingClassMap)``, Engine.scala:83-130), with ``""`` naming the
    single class of a slot."""

    def __init__(
        self,
        datasource_classes: type | Mapping[str, type],
        preparator_classes: type | Mapping[str, type],
        algorithm_classes: type | Mapping[str, type],
        serving_classes: type | Mapping[str, type],
    ):
        self.datasource_classes = _as_map(datasource_classes)
        self.preparator_classes = _as_map(preparator_classes)
        self.algorithm_classes = _as_map(algorithm_classes)
        self.serving_classes = _as_map(serving_classes)

    def _make(self, registry: Mapping[str, type], slot: str, name: str, params: Params):
        if name not in registry:
            raise KeyError(
                f"{slot} named '{name}' is not registered on this engine "
                f"(available: {sorted(registry)})"
            )
        return doer(registry[name], params)

    def make_datasource(self, ep: EngineParams) -> DataSource:
        return self._make(self.datasource_classes, "datasource", *ep.datasource)

    def make_preparator(self, ep: EngineParams) -> Preparator:
        return self._make(self.preparator_classes, "preparator", *ep.preparator)

    def make_algorithms(self, ep: EngineParams) -> list[Algorithm]:
        return [
            self._make(self.algorithm_classes, "algorithm", name, params)
            for name, params in ep.algorithms
        ]

    def make_serving(self, ep: EngineParams) -> Serving:
        return self._make(self.serving_classes, "serving", *ep.serving)

    def params_from_variant(self, variant: Mapping[str, Any]) -> EngineParams:
        def one(slot: str, registry: Mapping[str, type]) -> tuple[str, Params]:
            spec = variant.get(slot)
            if spec is None:
                name = "" if "" in registry else next(iter(sorted(registry)), "")
                cls = registry.get(name)
                params_cls = getattr(cls, "params_class", None)
                return (name, params_cls() if params_cls else Params())
            name, raw = _split_spec(spec)
            if name not in registry:
                raise KeyError(
                    f"variant references unknown {slot} '{name}' "
                    f"(available: {sorted(registry)})"
                )
            params_cls = getattr(registry[name], "params_class", Params)
            return (name, params_cls.from_dict(raw))

        algo_specs = variant.get("algorithms")
        if algo_specs is None:
            algorithms = [one("algorithms", self.algorithm_classes)]
        else:
            algorithms = []
            for spec in algo_specs:
                name, raw = _split_spec(spec)
                if name not in self.algorithm_classes:
                    raise KeyError(
                        f"variant references unknown algorithm '{name}' "
                        f"(available: {sorted(self.algorithm_classes)})"
                    )
                params_cls = getattr(self.algorithm_classes[name], "params_class", Params)
                algorithms.append((name, params_cls.from_dict(raw)))

        return EngineParams(
            datasource=one("datasource", self.datasource_classes),
            preparator=one("preparator", self.preparator_classes),
            algorithms=algorithms,
            serving=one("serving", self.serving_classes),
        )


def _as_map(classes: type | Mapping[str, type]) -> dict[str, type]:
    if isinstance(classes, Mapping):
        return dict(classes)
    return {"": classes}


def _split_spec(spec: Mapping[str, Any]) -> tuple[str, Mapping[str, Any]]:
    """Accept {"name": n, "params": {...}} or bare params {...}: a dict is
    the wrapper form only when its keys are a subset of {name, params}."""
    if spec and set(spec.keys()) <= {"name", "params"}:
        return spec.get("name", ""), spec.get("params", {}) or {}
    return "", spec


class EngineFactory:
    """User entry object: ``apply()`` returns the Engine
    (reference controller/EngineFactory.scala)."""

    def apply(self) -> Engine:
        raise NotImplementedError


def port_factory_name(dotted_name: str) -> str:
    """A recorded factory name -> the port's: ``predictionio_tpu.<path>``
    becomes ``predictionio_tpu_torch.<path>``; port names stay."""
    if dotted_name.startswith(_JAX_PACKAGE + "."):
        return _PORT + dotted_name[len(_JAX_PACKAGE):]
    return dotted_name


def resolve_engine_factory(dotted_name: str) -> Engine:
    """Import-by-name engine discovery (reference WorkflowUtils.getEngine),
    restricted to the port: the name is mapped by :func:`port_factory_name`
    and must then lie in ``predictionio_tpu_torch``. Accepts a
    module-level Engine, a zero-arg callable returning one, or an
    EngineFactory class/instance."""
    name = port_factory_name(dotted_name)
    module_name, _, attr = name.rpartition(".")
    if not module_name:
        raise ValueError(f"engine factory {dotted_name!r} is not a dotted path")
    if module_name != _PORT and not module_name.startswith(_PORT + "."):
        raise ValueError(
            f"engine factory {dotted_name!r} is outside the PyTorch port "
            f"({_PORT})"
        )
    try:
        obj = getattr(importlib.import_module(module_name), attr)
    except (ImportError, AttributeError) as e:
        raise ValueError(
            f"engine factory {dotted_name!r} is not ported yet ({name}: {e})"
        ) from e
    if isinstance(obj, Engine):
        return obj
    if isinstance(obj, type):
        obj = obj()
    if isinstance(obj, EngineFactory):
        return obj.apply()
    if callable(obj):
        result = obj()
        if isinstance(result, Engine):
            return result
    raise TypeError(f"{name} did not yield an Engine")
