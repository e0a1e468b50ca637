"""Typed component parameters and per-engine parameter bundles.

A copy of ``predictionio_tpu/core/params.py`` (reference
controller/Params.scala:26, EngineParams.scala:35): a ``Params`` marker
with JSON round-trip, ``EngineParams`` bundling (name, params) per
DASE slot, and ``EngineParamsGenerator`` for evaluation sweeps
(EngineParamsGenerator.scala).

Params classes are plain dataclasses; JSON extraction (the reference's
json4s/Gson ``JsonExtractor``) becomes dataclass-field-driven coercion.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence, Type, TypeVar

P = TypeVar("P", bound="Params")


def _snake(name: str) -> str:
    """camelCase JSON key -> snake_case dataclass field name."""
    out = []
    for ch in name:
        if ch.isupper():
            out.append("_")
            out.append(ch.lower())
        else:
            out.append(ch)
    return "".join(out)


@dataclass
class Params:
    """Base class for component parameters. Subclass as a dataclass."""

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls: Type[P], d: Mapping[str, Any] | None) -> P:
        """Construct from a JSON object, ignoring unknown keys.

        The reference tolerates extra JSON fields and fills defaults for
        missing ones (JsonExtractor.extract, workflow/JsonExtractor.scala:60);
        same here, but a missing field with no default is an error.
        """
        d = d or {}
        if not dataclasses.is_dataclass(cls):
            raise TypeError(f"{cls.__name__} must be a dataclass")
        names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        sources: dict[str, str] = {}  # field -> JSON key that set it
        for k, v in d.items():
            # accept both snake_case and the reference engine.json's
            # camelCase (Scala field names), plus Python-keyword escapes
            # ("lambda" -> field "lambda_")
            for cand in (k, _snake(k), k + "_", _snake(k) + "_"):
                if cand in names:
                    if cand in sources and kwargs[cand] != v:
                        # e.g. both "numIterations" and "num_iterations"
                        # present with different values: refusing beats
                        # silently letting dict order pick the winner
                        raise ValueError(
                            f"{cls.__name__}.from_dict: keys "
                            f"{sources[cand]!r} and {k!r} both map to "
                            f"field {cand!r} with different values"
                        )
                    kwargs[cand] = v
                    sources[cand] = k
                    break
        return cls(**kwargs)

    @classmethod
    def from_json(cls: Type[P], s: str) -> P:
        return cls.from_dict(json.loads(s) if s else {})


@dataclass
class EmptyParams(Params):
    """No parameters (reference EmptyParams)."""


@dataclass
class EngineParams:
    """Per-engine bundle of (component name, params) for every DASE slot
    (reference controller/EngineParams.scala:35-101).

    Names select among an engine's registered component classes;
    ``algorithms`` is an ordered list because an engine can ensemble
    multiple algorithms whose predictions Serving combines.
    """

    datasource: tuple[str, Params] = ("", EmptyParams())
    preparator: tuple[str, Params] = ("", EmptyParams())
    algorithms: Sequence[tuple[str, Params]] = field(
        default_factory=lambda: [("", EmptyParams())]
    )
    serving: tuple[str, Params] = ("", EmptyParams())

    def copy(
        self,
        datasource: tuple[str, Params] | None = None,
        preparator: tuple[str, Params] | None = None,
        algorithms: Sequence[tuple[str, Params]] | None = None,
        serving: tuple[str, Params] | None = None,
    ) -> "EngineParams":
        return EngineParams(
            datasource=datasource if datasource is not None else self.datasource,
            preparator=preparator if preparator is not None else self.preparator,
            algorithms=list(algorithms if algorithms is not None else self.algorithms),
            serving=serving if serving is not None else self.serving,
        )

    def to_jsonable(self) -> dict[str, Any]:
        def pair(p: tuple[str, Params]) -> dict[str, Any]:
            name, params = p
            return {"name": name, "params": params.to_dict()}

        return {
            "dataSourceParams": pair(self.datasource),
            "preparatorParams": pair(self.preparator),
            "algorithmParamsList": [pair(a) for a in self.algorithms],
            "servingParams": pair(self.serving),
        }


class EngineParamsGenerator:
    """Produces the candidate EngineParams list for a tuning sweep
    (reference controller/EngineParamsGenerator.scala). Subclasses set
    ``engine_params_list`` in ``__init__`` or override the property."""

    _engine_params_list: list[EngineParams] | None = None

    @property
    def engine_params_list(self) -> list[EngineParams]:
        if self._engine_params_list is None:
            raise ValueError("engine_params_list is empty")
        return self._engine_params_list

    @engine_params_list.setter
    def engine_params_list(self, value: Sequence[EngineParams]) -> None:
        if self._engine_params_list is not None:
            raise ValueError("engine_params_list can be set at most once")
        self._engine_params_list = list(value)
