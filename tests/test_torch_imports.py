"""The port stands alone: no JAX, nothing of the JAX package; and its
entry points default to CUDA, running on the CPU only when asked.

The import guard runs in a fresh interpreter where ``import jax`` fails
and a meta-path finder refuses ``predictionio_tpu`` and
``predictionio_tpu.*`` (but not ``predictionio_tpu_torch``), then imports
every module of the port and the top level of ``chip_smoke.py``.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "predictionio_tpu_torch"

_GUARD = r"""
import importlib, importlib.abc, pkgutil, sys
sys.modules["jax"] = None

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "predictionio_tpu" or name.startswith("predictionio_tpu."):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Refuse())
sys.path.insert(0, sys.argv[1])
import predictionio_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
          or m == "predictionio_tpu" or m.startswith("predictionio_tpu.")]
assert not [m for m in leaked if sys.modules[m] is not None], leaked
print(" ".join(names))
"""

_IMPORT_LINE = re.compile(r"^\s*(import|from)\s+(jax|predictionio_tpu)(\.|\s|$)")


def test_port_imports_without_jax_or_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", _GUARD, str(ROOT)],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stderr
    walked = set(proc.stdout.split())
    assert len(walked) >= 60  # every module was walked
    # the training, similar-product, serving-stack, evaluation, two-stage
    # retrieval, other-ALS-template, speed-layer, ingest and file-log slices'
    # modules among them
    assert {f"predictionio_tpu_torch.{m}" for m in (
        "data.datamap", "data.event", "data.store", "data.storage.base",
        "data.storage.sqlite", "data.storage.memory", "ops.als",
        "core.engine", "core.workflow", "models.recommendation", "cli.main",
        "data.propertymap", "data.aggregator", "models.columnar",
        "models.filters", "models.similarproduct", "ops.topk",
        "obs", "obs.metrics", "obs.trace", "obs.freshness", "obs.slo",
        "obs.progress", "obs.history", "obs.incident", "obs.device",
        "faults", "faults.inject", "common", "common.server_config",
        "server", "server.http", "server.query_cache", "server.plugins",
        "server.engine_server", "server.jsonx",
        "core.metrics", "core.ranking", "core.fast_eval", "core.evaluation",
        "core.workflow_eval", "models.recommendation_eval", "ops.retrieval",
        "ops.cosine_sim", "models.recommendeduser", "models.ecommerce",
        "core.checkpoint", "common.breaker", "realtime", "realtime.tailer",
        "realtime.foldin", "realtime.speed_layer",
        "native", "data.storage.colspans", "data.storage.wire",
        "data.storage.frame", "server.stats", "server.webhooks",
        "server.webhooks.mailchimp", "server.webhooks.segmentio",
        "server.event_server", "cli.commands",
        "data.storage.groupcommit", "data.storage.columnar_cache",
        "data.storage.jsonl", "data.storage.partitioned", "data.view",
        "core.self_cleaning", "cli.daemon", "server.supervisor", "server.router",
    )} <= walked


def test_no_import_line_names_jax_or_the_jax_package():
    sources = [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]
    offending = [
        f"{p.relative_to(ROOT)}:{n}"
        for p in sources
        for n, line in enumerate(p.read_text().splitlines(), 1)
        if _IMPORT_LINE.match(line)
    ]
    assert not offending


def test_entry_points_default_to_cuda():
    from predictionio_tpu_torch.core.context import WorkflowContext
    from predictionio_tpu_torch.utils.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    assert WorkflowContext(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="CUDA"):
            WorkflowContext()


def test_chip_smoke_refuses_to_run_without_its_package(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    proc = subprocess.run(
        [sys.executable, str(lone)], capture_output=True, text=True,
        timeout=120, cwd=tmp_path,
    )
    assert proc.returncode != 0 and proc.stdout == ""


def test_chip_smoke_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run in full")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
        text=True, timeout=120, cwd=ROOT,
    )
    assert proc.returncode != 0 and proc.stdout == ""


_NATIVE_PROBE = r"""
import importlib.abc, sys
sys.modules["jax"] = None

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "predictionio_tpu" or name.startswith("predictionio_tpu."):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Refuse())
sys.path.insert(0, sys.argv[1])
from predictionio_tpu_torch import native
line = b'{"event":"rate","entityType":"user","entityId":"u1","targetEntityType":"item","targetEntityId":"i1","properties":{"rating":4}}\n'
(event,) = native.parse_events_jsonl(line)
assert event.entity_id == "u1" and native.native_available()
print(native.library_path())
"""


def test_native_codec_builds_into_the_port_and_writes_nothing_under_native(tmp_path):
    """The port's binding compiles ``native/pio_native.cpp`` into
    ``predictionio_tpu_torch/_build/`` and loads it from there; importing
    it and decoding a buffer leaves ``native/`` as it was. Run on a copy
    of the port beside a copy of the C++ source, so no other test's build
    can touch the listing."""
    shutil.copytree(PORT, tmp_path / "predictionio_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    (tmp_path / "native").mkdir()
    shutil.copy(ROOT / "native" / "pio_native.cpp", tmp_path / "native")

    def listing():
        return sorted((p.name, p.stat().st_size, p.stat().st_mtime_ns)
                      for p in (tmp_path / "native").iterdir())

    before = listing()
    proc = subprocess.run(
        [sys.executable, "-c", _NATIVE_PROBE, str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
    )
    assert proc.returncode == 0, proc.stderr
    lib = Path(proc.stdout.strip())
    assert lib.parent == tmp_path / "predictionio_tpu_torch" / "_build"
    assert lib.name.startswith("libpio_native-") and lib.exists()
    assert listing() == before
