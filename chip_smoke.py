#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, ``nvcc``
and PyTorch built for CUDA. It imports nothing of JAX and nothing of the
JAX package (``predictionio_tpu``). Phases:

1. environment: torch/CUDA versions, the card, ``nvidia-smi`` name and
   power limit, ``nvcc`` release, ``triton`` version or ``absent``;
2. build ``predictionio_tpu_torch/csrc/topk.cu`` (K2) with ``nvcc`` for
   ``sm_90a``;
3. K2 against its plain PyTorch version on the card at the ML-20M shape
   (U = 138,493 users, I = 26,744 items): D = 20 with every f32/bf16/int8
   storage pair, D = 128 with each storage dtype, both at B in {1, 64},
   and D = 50 at B = 17 (partial factor chunk and batch tile); k in {4,
   16, 128, I}, with and without an exclude mask: bit for bit on exact (small-integer)
   inputs, within rtol=1e-5/atol=1e-6 on random-normal ones (ids equal
   outside runs of near-tied scores, where the id sets must match), and
   row b of a B=64 call bit for bit equal to the B=1 call for that user;
   the selection stage alone on rows of ties, signed zeros, NaN and inf;
4. the slice: f32 and int8 models at full width (D = 20) saved through
   the port's storage as COMPLETED engine instances, deployed through
   the ``deploy`` entry point on 127.0.0.1, answering ``POST
   /queries.json`` (checked against the plain version), with K2's launch
   count read around the run, then one 64-query ``batch_predict``;
5. times: K2, the plain version and a ``torch.topk(u @ V.T)`` yardstick
   at D = 20 for f32 and int8, B in {1, 64} -- per call (median of CUDA
   event pairs around one call, launch gaps included) and on the device
   (``torch.profiler`` kernel time per call, K2 split into its two
   launches) -- beside the bound ``max(bytes / memory rate, FP32
   operations / FP32 rate)`` of the card named in phase 1; the HTTP p50
   of ``/queries.json``.

Every phase prints its results; any failure makes the exit code 1 and
suppresses the result lines. Without CUDA, or without the package beside
the script, it exits 2 and prints no result. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``,
the one before it the ``{"kernels": [...]}`` summary.
"""

from __future__ import annotations

import http.client
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20
U_ROWS, I_ROWS = 138_493, 26_744  # ML-20M users x items
BATCHES = (1, 64)
RTOL, ATOL = 1e-5, 1e-6
DTYPES = ("float32", "bfloat16", "int8")

# Published peaks by card (NVIDIA data sheets): memory bytes/s, FP32
# (non-tensor) FLOP/s. Matched on the name torch reports.
_PEAKS = (
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100", 3.35e12, 67e12),
    ("H200", 4.8e12, 67e12),
)

failures: list[str] = []


def log(*parts) -> None:
    print(*parts, flush=True)


def phase(name):
    """Run a phase; a failure is printed and recorded, never ignored."""
    def wrap(fn):
        def run(*a, **kw):
            log(f"== {name}")
            t0 = time.perf_counter()
            try:
                out = fn(*a, **kw)
            except Exception:
                failures.append(name)
                log(f"FAILED {name}:\n{traceback.format_exc()}")
                return None
            log(f"== {name}: ok ({time.perf_counter() - t0:.1f}s)")
            return out
        return run
    return wrap


# -- phase 1 -----------------------------------------------------------------


@phase("environment")
def environment(torch):
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    from predictionio_tpu_torch.kernels import _build

    nvcc = subprocess.run(
        [_build.nvcc_path(), "--version"], capture_output=True, text=True,
        timeout=60, check=True,
    ).stdout
    log("nvcc " + next((ln.strip() for ln in nvcc.splitlines() if "release" in ln), "?"))
    try:
        import triton

        log(f"triton {triton.__version__}")
    except ImportError:
        log("triton absent")
    return smi


# -- phase 2 -----------------------------------------------------------------


@phase("build")
def build():
    from predictionio_tpu_torch.kernels import _build

    _build.load("topk")
    info = _build.build_info["topk"]
    log(f"built csrc/topk.cu in {info['seconds']:.2f}s (cached={info['cached']})")
    for ln in info["log"].splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            log("  ptxas: " + ln.strip())


# -- inputs ------------------------------------------------------------------


def make_table(torch, dtype: str, rows: int, rank: int, exact: bool, gen, device):
    """A factor table in storage form. Exact tables hold small integers
    (int8: power-of-two scales), so every score is an exact f32 sum."""
    if exact:
        if dtype == "int8":
            q = torch.randint(-8, 9, (rows, rank), generator=gen, device=device,
                              dtype=torch.int8)
            s = torch.pow(2.0, torch.randint(-2, 3, (rows,), generator=gen,
                                             device=device).float())
            return (q, s)
        x = torch.randint(-3, 4, (rows, rank), generator=gen, device=device).float()
        return x.to(getattr(torch, dtype))
    x = torch.randn((rows, rank), generator=gen, device=device)
    if dtype == "int8":
        from predictionio_tpu_torch.ops.als import quantize_rows

        return quantize_rows(x)
    return x.to(getattr(torch, dtype))


def with_nan_row(torch, table, row: int):
    """A dense table with one NaN factor: a NaN score for every user."""
    if isinstance(table, tuple):
        return table
    t = table.clone()
    t[row, 0] = float("nan")
    return t


def host(t):
    return t.detach().cpu().numpy()


def same_bits(torch, a, b) -> bool:
    """Bitwise equality of f32 tensors, any NaN equal to any NaN."""
    nan = torch.isnan(a) & torch.isnan(b)
    return bool(torch.equal(torch.isnan(a), torch.isnan(b))) and bool(
        torch.equal(a.view(torch.int32)[~nan], b.view(torch.int32)[~nan])
    )


def near_tie_ids_ok(ids_k, ids_p, s_p) -> bool:
    """Ids of one row equal outside runs of adjacent plain scores closer
    than RTOL (relative); inside a run the id sets must match, except in
    the run that reaches position k, which may hold other near-tied ids."""
    if np.array_equal(ids_k, ids_p):
        return True
    n = len(ids_p)
    close = np.abs(np.diff(s_p)) <= RTOL * np.maximum(
        np.abs(s_p[:-1]), np.abs(s_p[1:])) + ATOL
    start = 0
    for j in range(1, n + 1):
        if j == n or not close[j - 1]:
            a, b = set(ids_k[start:j].tolist()), set(ids_p[start:j].tolist())
            if a != b and j != n:
                return False
            start = j
    return len(set(ids_k.tolist())) == n


# -- phase 3 -----------------------------------------------------------------


@phase("kernel vs plain")
def kernel_vs_plain(torch, device, stats):
    from predictionio_tpu_torch.ops import topk

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    mask = torch.rand(I_ROWS, generator=gen, device=device) < 0.1
    checks = 0
    every_pair = [(u, v) for u in DTYPES for v in DTYPES]
    same_pair = [(d, d) for d in DTYPES]
    groups = [
        (20, every_pair, BATCHES),
        (128, same_pair, BATCHES),
        # a partial last factor chunk (50 = 32 + 18) and batch tile (17)
        (50, same_pair, (17,)),
    ]
    for rank, pairs, batches in groups:
        for udt, vdt in pairs:
            for exact in (True, False):
                users = make_table(torch, udt, U_ROWS, rank, exact, gen, device)
                items = make_table(torch, vdt, I_ROWS, rank, exact, gen, device)
                if exact:
                    items = with_nan_row(torch, items, 17)
                for batch in batches:
                    ixs = torch.randint(0, U_ROWS, (batch,), generator=gen,
                                        device=device, dtype=torch.int32)
                    for k in (4, 16, 128, I_ROWS):
                        for m in (None, mask):
                            sk, ik = topk.gather_top_k_batch(ixs, users, items, k, m)
                            sp, ip = topk.gather_top_k_batch_reference(
                                ixs, users, items, k, m)
                            torch.cuda.synchronize()
                            what = (f"D={rank} {udt}x{vdt} exact={exact} B={batch} "
                                    f"k={k} mask={m is not None}")
                            if exact:
                                if not (torch.equal(ik, ip) and same_bits(torch, sk, sp)):
                                    raise AssertionError(f"not bitwise equal: {what}")
                            else:
                                hk, hp = host(sk), host(sp)
                                fin = np.isfinite(hp)
                                err = float(np.max(np.abs(hk[fin] - hp[fin]), initial=0.0))
                                stats["max_abs_err"] = max(stats["max_abs_err"], err)
                                if not np.allclose(hk, hp, rtol=RTOL, atol=ATOL):
                                    raise AssertionError(
                                        f"scores differ (max abs {err}): {what}")
                                ids_k, ids_p = host(ik), host(ip)
                                for r in range(batch):
                                    if not near_tie_ids_ok(ids_k[r], ids_p[r], hp[r]):
                                        raise AssertionError(f"ids differ row {r}: {what}")
                            if batch > 1 and k == 16:
                                for r in range(batch):
                                    s1, i1 = topk.gather_top_k_batch(
                                        ixs[r:r + 1], users, items, k, m)
                                    if not (torch.equal(i1[0], ik[r])
                                            and same_bits(torch, s1[0], sk[r])):
                                        raise AssertionError(
                                            f"row {r} differs from its B=1 call: {what}")
                            checks += 1
    log(f"{checks} kernel-vs-plain configurations agree")

    # the selection stage alone on crafted rows: ties, signed zeros, NaN, inf
    rows = torch.randint(-2, 3, (6, I_ROWS), generator=gen, device=device).float()
    rows[0] = torch.tensor([-0.0, 0.0, -0.0], device=device).repeat(I_ROWS // 3 + 1)[:I_ROWS]
    rows[1, ::97] = float("nan")
    rows[1].view(torch.int32)[5::89] = -1  # a NaN with the sign bit set
    rows[2, ::13] = float("inf")
    rows[2, 3::17] = float("-inf")
    rows[3] = 0.0
    for k in (1, 4, 16, 128, 3000, I_ROWS):
        sk, ik = topk.top_k_rows(rows, k)
        sp, ip = topk.top_k_rows_reference(rows, k)
        if not (torch.equal(ik, ip) and torch.equal(sk.view(torch.int32),
                                                    sp.view(torch.int32))):
            raise AssertionError(f"top_k_rows not bitwise equal at k={k}")
    log("selection stage bitwise equal on tie / signed-zero / NaN / inf rows")


# -- phase 4 -----------------------------------------------------------------


def expected_items(torch, model, device, queries):
    """What batch_predict must answer, from the plain K2 on the card."""
    from predictionio_tpu_torch.ops import topk

    U, V = model.device_factors(device)
    inv = model.item_index.inverse
    out = []
    for q in queries:
        if q["user"] not in model.user_index:
            out.append(([], []))
            continue
        k = 1 << max(0, q["num"] - 1).bit_length()
        s, i = topk.gather_top_k_batch_reference(
            [model.user_index[q["user"]]], U, V, k)
        s, i = host(s)[0, :q["num"]], host(i)[0, :q["num"]]
        out.append(([inv[int(x)] for x in i], s))
    return out


def check_answer(items, scores, exp_items, exp_scores, model, what):
    if len(items) != len(exp_items):
        raise AssertionError(f"{what}: {len(items)} items, expected {len(exp_items)}")
    if not items:
        return
    s = np.asarray(scores, np.float32)
    if not np.allclose(s, exp_scores, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{what}: scores {s} vs {exp_scores}")
    idx = model.item_index
    ids_k = np.asarray([idx[x] for x in items])
    ids_p = np.asarray([idx[x] for x in exp_items])
    if not near_tie_ids_ok(ids_k, ids_p, np.asarray(exp_scores, np.float32)):
        raise AssertionError(f"{what}: items {items} vs {exp_items}")


def post(conn, body):
    conn.request("POST", "/queries.json", json.dumps(body).encode(),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    if resp.status != 200:
        raise AssertionError(f"HTTP {resp.status}: {data[:300]!r}")
    return json.loads(data)


@phase("slice: deploy -> POST /queries.json")
def the_slice(torch, device, stats):
    from predictionio_tpu_torch.cli import main as cli
    from predictionio_tpu_torch.data import storage as st
    from predictionio_tpu_torch.models import recommendation as rec
    from predictionio_tpu_torch.ops import topk
    from predictionio_tpu_torch.ops.als import quantize_rows
    from predictionio_tpu_torch.core.workflow import save_instance

    rng = np.random.default_rng(SEED)
    uf = rng.standard_normal((U_ROWS, 20), dtype=np.float32)
    vf = rng.standard_normal((I_ROWS, 20), dtype=np.float32)
    user_ids = [f"u{j}" for j in range(U_ROWS)]
    item_ids = [f"i{j}" for j in range(I_ROWS)]
    uq, us = (host(t) for t in quantize_rows(torch.from_numpy(uf)))
    vq, vs = (host(t) for t in quantize_rows(torch.from_numpy(vf)))
    models = {
        "f32": rec.model_from_numpy(user_ids, item_ids, uf, vf),
        "int8": rec.model_from_numpy(user_ids, item_ids, uq, vq, us, vs),
    }
    basedir = tempfile.mkdtemp(prefix="pio_chip_smoke_")
    storage = st.Storage(env={"PIO_FS_BASEDIR": basedir})
    st.set_storage(storage)
    engine = rec.engine()
    ids = {}
    for name, model in models.items():
        ep = engine.params_from_variant({"algorithms": [{"name": "als", "params": {
            "rank": 20, "storage_dtype": "float32" if name == "f32" else "int8"}}]})
        ids[name] = save_instance(
            engine, ep, [model], engine_id="chip-smoke", engine_variant=name,
            engine_factory="predictionio_tpu_torch.models.recommendation.engine",
            storage=storage,
        )
    queries = [
        {"user": "u0", "num": 1}, {"user": "u17", "num": 4},
        {"user": "u138492", "num": 20}, {"user": "u4242", "num": 4},
        {"user": "nobody", "num": 4}, {"user": "u99", "num": 100},
    ]
    launches_before = launches_queries = 0
    servers = []
    try:
        topk.gather_top_k_batch.launches.reset()  # the main path starts here
        for name in models:
            args = cli.build_parser().parse_args([
                "deploy", "--engine-instance-id", ids[name], "--ip", "127.0.0.1",
                "--port", "0", "--device", "cuda",
            ])
            server = cli.deploy_server(args)
            servers.append(server)
            server.warmup()
            port = server.start(background=True)
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            conn.request("GET", "/")
            status = json.loads(conn.getresponse().read())
            log(f"deployed {name} instance {ids[name]} on :{port} ({status['deviceName']})")
            launches_before = topk.gather_top_k_batch.launches.value
            model = server.models[0]
            for q, (exp_items, exp_scores) in zip(
                    queries, expected_items(torch, model, device, queries)):
                got = post(conn, q)["itemScores"]
                check_answer([x["item"] for x in got], [x["score"] for x in got],
                             exp_items, exp_scores, model, f"{name} {q}")
            launches_queries += topk.gather_top_k_batch.launches.value - launches_before
            if name == "f32":
                times = []
                for _ in range(60):
                    t0 = time.perf_counter()
                    post(conn, {"user": "u17", "num": 4})
                    times.append(time.perf_counter() - t0)
                stats["http_p50_ms"] = statistics.median(times[10:]) * 1e3
                # the same query without HTTP: the query path's share
                algo, q = server.algorithms[0], rec.Query(user="u17", num=4)
                times = []
                for _ in range(60):
                    t0 = time.perf_counter()
                    algo.predict(model, q)
                    times.append(time.perf_counter() - t0)
                stats["predict_p50_ms"] = statistics.median(times[10:]) * 1e3
            conn.close()
            # one 64-query batch through the algorithm's batch entry point
            algo = server.algorithms[0]
            batch = [(j, rec.Query(user=f"u{j * 997}", num=8)) for j in range(64)]
            answers = dict(algo.batch_predict(model, batch))
            exp = expected_items(torch, model, device,
                                 [{"user": q.user, "num": q.num} for _, q in batch])
            for (j, q), (exp_items, exp_scores) in zip(batch, exp):
                r = answers[j].itemScores
                check_answer([x.item for x in r], [x.score for x in r],
                             exp_items, exp_scores, model, f"{name} batch row {j}")
        stats["launches"] = topk.gather_top_k_batch.launches.value  # main path read
    finally:
        for s in servers:
            s.stop()
        st.set_storage(None)
        storage.close()
        shutil.rmtree(basedir, ignore_errors=True)
    if launches_queries <= 0 or stats["launches"] <= 0:
        raise AssertionError("the HTTP queries did not launch the K2 kernel")
    log(f"K2 launches on the main path: {stats['launches']} "
        f"({launches_queries} during the HTTP queries); "
        f"HTTP p50 {stats['http_p50_ms']:.3f} ms")
    log(json.dumps({"timing": "http /queries.json", "model": "f32", "num": 4,
                    "http_p50_ms": stats["http_p50_ms"],
                    "predict_p50_ms": stats["predict_p50_ms"]}))


# -- phase 5 -----------------------------------------------------------------


def cuda_median_ms(torch, fn, runs: int = 50, warmup: int = 20) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def device_ms(torch, fn, runs: int = 50) -> dict:
    """Device time per call from ``torch.profiler`` (CUPTI): {kernel or
    copy name: ms per call}; empty when the profiler saw no device work."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if "CUDA" not in str(e.device_type):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us:
            out[e.key] = us / runs / 1e3
    return out


def _total(times: dict, part: str = ""):
    picked = [v for k, v in times.items() if part in k]
    return sum(picked) if picked else None


def peaks(name: str):
    for key, mem, fp32 in _PEAKS:
        if key in name:
            return mem, fp32
    return _PEAKS[2][1], _PEAKS[2][2]


@phase("times")
def timings(torch, device, stats):
    from predictionio_tpu_torch.ops import topk

    mem_rate, fp32_rate = peaks(torch.cuda.get_device_name(0))
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 1)
    rank, k = 20, 4
    rows = []
    for dtype in ("float32", "int8"):
        users = make_table(torch, dtype, U_ROWS, rank, False, gen, device)
        items = make_table(torch, dtype, I_ROWS, rank, False, gen, device)
        for batch in BATCHES:
            ixs = torch.randint(0, U_ROWS, (batch,), generator=gen, device=device,
                                dtype=torch.int32)
            if dtype == "int8":
                (uq, us), (vq, vs) = users, items

                def library():
                    u = uq[ixs.long()].float() * us[ixs.long()][:, None]
                    return torch.topk((u @ vq.float().T) * vs, k)
                elem = 1
            else:
                def library():
                    return torch.topk(users[ixs.long()] @ items.T, k)
                elem = 4
            kernel_ms = cuda_median_ms(
                torch, lambda: topk.gather_top_k_batch(ixs, users, items, k))
            plain_ms = cuda_median_ms(
                torch, lambda: topk.gather_top_k_batch_reference(ixs, users, items, k),
                runs=20)
            library_ms = cuda_median_ms(torch, library)
            # K2's second launch alone, on this call's score matrix
            scores = topk.gather_top_k_batch_reference(ixs, users, items, I_ROWS)[0]
            select_ms = cuda_median_ms(torch, lambda: topk.top_k_rows(scores, k))
            k2_dev = device_ms(torch, lambda: topk.gather_top_k_batch(ixs, users, items, k))
            plain_dev = device_ms(
                torch, lambda: topk.gather_top_k_batch_reference(ixs, users, items, k),
                runs=20)
            library_dev = device_ms(torch, library)
            scale_bytes = 4 if dtype == "int8" else 0
            nbytes = (I_ROWS * (rank * elem + scale_bytes)  # catalog, read once
                      + batch * (rank * elem + scale_bytes + 4)  # user rows + ids
                      + batch * k * 8)  # scores + ids out
            flops = 2 * batch * I_ROWS * rank
            bound_ms = max(nbytes / mem_rate, flops / fp32_rate) * 1e3
            bound_by = "bytes" if nbytes / mem_rate >= flops / fp32_rate else "operations"
            row = {"timing": "gather_top_k_batch", "dtype": dtype, "B": batch,
                   "D": rank, "k": k, "I": I_ROWS, "kernel_ms": kernel_ms,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "select_ms": select_ms,
                   "kernel_device_ms": _total(k2_dev),
                   "score_device_ms": _total(k2_dev, "score_kernel"),
                   "select_device_ms": _total(k2_dev, "select_kernel"),
                   "plain_device_ms": _total(plain_dev),
                   "library_device_ms": _total(library_dev),
                   "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
                   "flops": flops}
            rows.append(row)
            log(json.dumps(row))
    stats["timings"] = rows


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test needs a GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "predictionio_tpu_torch")):
        print("chip_smoke: run it from a checkout (predictionio_tpu_torch/ "
              "beside the script)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from predictionio_tpu_torch.utils.device import resolve_device

    device = resolve_device("cuda")
    stats = {"max_abs_err": 0.0, "launches": 0}
    t0 = time.perf_counter()
    smi = environment(torch)
    build()
    if not failures:
        kernel_vs_plain(torch, device, stats)
        the_slice(torch, device, stats)
        timings(torch, device, stats)
    log(f"total {time.perf_counter() - t0:.1f}s")
    if failures:
        log(f"chip_smoke FAILED phases: {failures}")
        return 1
    rep = stats["timings"][0]  # f32, B = 1: the per-request serving call
    # device time when the profiler measured it (the kernels' own time);
    # else the per-call CUDA-event time, which includes launch gaps
    dev = None not in (rep["kernel_device_ms"], rep["plain_device_ms"],
                       rep["library_device_ms"])
    log(smi)
    log(json.dumps({"kernels": [{
        "name": "gather_top_k_batch",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/topk.cu",
        "replaces": "predictionio_tpu/ops/topk.py:90",
        "launches": stats["launches"],
        "max_abs_err": stats["max_abs_err"],
        "ms": rep["kernel_device_ms"] if dev else rep["kernel_ms"],
        "plain_ms": rep["plain_device_ms"] if dev else rep["plain_ms"],
        "bound_ms": rep["bound_ms"],
        "bound_by": rep["bound_by"],
        "library_ms": rep["library_device_ms"] if dev else rep["library_ms"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
