"""Realtime speed layer: event tailing + incremental ALS fold-in.

Port of ``predictionio_tpu/realtime/``. The reference PredictionIO is a
Lambda architecture -- batch retrain plus a speed layer where serving
reflects events that arrived after the last train. :class:`EventTailer`
follows an event store incrementally with a durable cursor,
:class:`ALSFoldIn` solves touched user rows in closed form on K1 against
the fixed item factors, and :class:`SpeedLayer` drives the loop against a
deployed engine server, hot-patching its model tables under an epoch
fence so a full retrain + ``/reload`` always wins.
"""

from predictionio_tpu_torch.realtime.foldin import ALSFoldIn, FoldInConfig, FoldInStats
from predictionio_tpu_torch.realtime.speed_layer import SpeedLayer
from predictionio_tpu_torch.realtime.tailer import EventTailer

__all__ = [
    "ALSFoldIn",
    "EventTailer",
    "FoldInConfig",
    "FoldInStats",
    "SpeedLayer",
]
