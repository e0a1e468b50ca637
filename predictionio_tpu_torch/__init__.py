"""PredictionIO on PyTorch and CUDA: the port of ``predictionio_tpu``.

A second package beside the JAX one, module for module: the same DASE
engine contracts, model file format, storage layout and HTTP serving,
with device work in PyTorch and hand-written CUDA kernels for an NVIDIA
Hopper card (H100). The JAX package stays the reference; this package
imports nothing from it and never imports ``jax``.

Entry points run on CUDA unless the caller asks for the CPU
(``device="cpu"``), where every kernel's plain PyTorch version runs
instead (:mod:`predictionio_tpu_torch.utils.device`).

Ported so far, for the ALS recommendation template on one card:
training, from events in the event store through ``train`` to a model
file, on the fused bucket-solve kernel (``csrc/als_solve.cu``, K1); and
serving, from ``deploy`` to ``POST /queries.json``, on the fused gather
-> score -> top-k kernel (``csrc/topk.cu``, K2).
"""

__version__ = "0.1.0"
