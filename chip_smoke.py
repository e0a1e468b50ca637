#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--phases k2,k1,k1i,k1route,k2s,k2route,k6,k2cos,k4,k5,
                                    times,retimes,serve,batchserve,lifecycle,ingest,
                                    filelog,prepcache,fleet,workers,simlife,templife,train,
                                    ckpt,
                                    realtime,
                                    simtrain,templates,eval,retrieval,k1times,simtimes]

Run from the root of a checkout, on a machine with a CUDA card, ``nvcc``
and PyTorch built for CUDA. It imports nothing of JAX and nothing of the
JAX package (``predictionio_tpu``). Phases:

1. environment: torch/CUDA versions, the card, ``nvidia-smi`` name and
   power limit, ``nvcc`` release, ``triton`` version or ``absent``;
2. build ``predictionio_tpu_torch/csrc/topk.cu`` (K2),
   ``csrc/als_solve.cu`` (K1, K1s), ``csrc/ranking.cu`` (K3),
   ``csrc/retrieval.cu`` (K4, K5) and ``csrc/cosine_sim.cu`` (K6) with
   ``nvcc`` for ``sm_90a``, one ``nvcc`` per source, started together;
   the checks up to k2cos need none of ``csrc/retrieval.cu`` (the
   longest build), which goes on building beside them; the first phase
   after them waits for it (``build: the late sources``). The device-only
   checks and re-timings up to retimes run beside the ingest
   preparations; every later phase times host work and starts once they
   are done;
3. k2: K2 against its plain PyTorch version on the card at the ML-20M
   shape (U = 138,493 users, I = 26,744 items): D = 20 with every
   f32/bf16/int8 storage pair, D = 128 with each storage dtype, both at B
   in {1, 64}, and D = 50 at B = 17; k in {4, 16, 128, I}, with and
   without an exclude mask: bit for bit on exact (small-integer) inputs,
   within rtol=1e-5/atol=1e-6 on random-normal ones (ids equal outside
   runs of near-tied scores, where the id sets must match), and row b of
   a B=64 call bit for bit equal to the B=1 call for that user; each call
   served by the route ``k2_route`` names (the tile route at k <= 128,
   the select route at k = I); the selection stage alone on rows of
   ties, signed zeros, NaN and inf;
4. k1: K1 against its plain version: storage {f32, bf16, int8} x compute
   {f32, bf16} x D {1, 10, 20, 30, 32, 33, 40, 64, 80, 128} x width {8, 2048},
   unsegmented and segmented (1 and 33 segments), with rows of n = 0;
   each solve within atol=1e-5 + rtol=1e-4 * max|x| of its row of the
   plain version and of a float64 solve, the written-back table bit for
   bit;
5. serve: f32 and int8 models at full width (D = 20) saved through the
   port's storage, deployed through ``deploy`` on 127.0.0.1 (the port's
   event-loop front end, ``server/http.py``), answering ``POST
   /queries.json`` (checked against the plain version) -- K2's call and
   per-route counts are reset before and read after: its main-path
   count, every call on the tile route; HTTP and ``predict`` p50 of
   each model at concurrency 1;
6. lifecycle: ML-100K-shaped ratings written as ``rate`` events into the
   port's sqlite store, ``cli.main train`` then ``deploy`` on the card,
   queries POSTed; train RMSE against the same training on the CPU;
7. train: ML-20M-shaped ratings, rank 20, 2 iterations through
   ``run_train`` (K1's launch count reset before and read after: its
   main-path count), persisted, deployed, queried; then 1 iteration with
   K1 against 1 with its plain version from the same init;
8. times: K2 by its route (tile and merge launches apart), the select
   route on the same inputs, its plain version and a ``torch.topk(u @
   V.T)`` yardstick at D = 20 for f32 and int8, B in {1, 64}, k = 4; then
   both routes of both modes at k in {1, 4, 16, 32, 64, 128}, B in {1,
   64};
9. k1times: K1 per bucket at ML-20M rank 20, f32 and int8 storage, with
   its launches (the warp route: 1, or 2 for a segmented bucket, each
   timed), the block kernel on the same bucket, its plain version and a
   torch gather + bmm + cholesky yardstick, and one iteration's wall time. Device times are ``torch.profiler`` kernel
   time per call; per-call times the median of CUDA event pairs; bounds
   ``max(bytes / memory rate, FP32 operations / FP32 rate)`` of the card
   named in phase 1, computed from this run's inputs.

The serving-stack slice adds, run after serve:

- batchserve: the serve phase's f32 model at the ML-20M shape (num = 4)
  deployed by ``cli.main deploy`` in a subprocess, with the
  micro-batcher on (``--batch-window-ms 2``) and off (``0``); closed-loop
  keep-alive clients at concurrency 1, 8 and 64, 1,000 queries a level
  for distinct users from a seed: p50, p99, queries/s, the server's
  ``pio_batch_size`` histogram and K2 tile-route calls (``/metrics``)
  per level; every answer byte-identical to the user's solo answer, a
  sample against the plain version, batches of more than one query at
  concurrency 64. Then a deploy with ``--query-cache-mb 64``: a repeated
  query gives the same bytes and no K2 call; ``/metrics`` device-memory
  gauges live (``supported = 1``, in-use bytes >= the tables);
  ``POST /profile?seconds=1`` during traffic writes a ``torch.profiler``
  trace naming ``tile_topk_kernel`` and ``merge_topk_kernel``; ``POST
  /reload`` onto a newer instance bumps the epoch and answers from the
  new model; SIGTERM drains with queries in flight (all 200, exit 0).
  simtrain also deploys through the batcher and sends rounds of 8
  concurrent queries until K2s runs at B > 1.

The similar-product slice adds (run in this order among the above:
k1i and k2s after k1, simlife after lifecycle, simtrain after train,
simtimes last):

- k1i: K1's implicit mode against its plain version: storage x compute
  x D {1, 10, 20, 32, 33, 64, 128} x width {8, 2048}, unsegmented and segmented,
  alpha {1, 40}, implicit_weighted_reg both ways, an indefinite row that
  both must solve to NaN; the same per-solve bars and bit-equal
  write-back as k1;
- k2s: K2's summed-rows mode against its plain version at I = 26,744:
  f32 and int8 catalogs, D {10, 20, 128}, B {1, 64}, L {1, 4, 16}, k
  {4, 16, 128}, with and without a mask, bit for bit on exact inputs,
  rtol 1e-5 / atol 1e-6 on random ones; batch and padding invariance;
- simlife: similar-product events (~1,000 users x 300 items) in sqlite,
  ``cli.main train`` of als + likealgo, ``deploy``, POSTed queries
  against the plain path; factors against the same training on the CPU;
- simtrain: the ML-20M-shaped pairs as 20 M view events through
  ``run_train`` at the template's defaults (rank 10, 20 iterations),
  K1's counter reset before and read after (iterations x launches),
  deployed and queried (K2's summed-rows counters: every call on the
  tile route); 1 implicit
  iteration with K1 against its plain version;
- simtimes: K1 implicit per bucket with its launches, the block kernel,
  plain, library yardstick, compute_gram and iteration wall time; K2
  summed rows at B = 1 and 64 by its route, the select route on the same
  inputs, the query rows summed by a launch of their own instead (the
  select route's sum_rows_kernel plus the tile route on the sums), and a
  ``torch.topk(q @ V.T)`` yardstick; the similar-product HTTP p50 comes
  from simtrain.

The K1 redesign (the warp route at D <= 32) adds, run after k1i:

- k1route: the warp route against the block kernel on the same CUDA
  tensors: D {1, 10, 20, 32} x storage x compute x explicit/implicit x
  width {8, 2048}, unsegmented (one launch) and segmented (two launches;
  rows of 1, 2 and 33 segments): every one-segment row's x and written
  back storage bit-equal to the block kernel's; every multi-segment row
  within atol 1e-5 + rtol 1e-4 * max|x| of the plain version and of a
  float64 solve; crafted indefinite rows NaN in both; empty rows zeros.

The K2 redesign (the tile route, k <= 128) adds, run after k2s:

- k2route: the tile route against the select route on the same CUDA
  tensors, both modes: f32/bf16/int8 x I {50, 1,000, 26,744} x B {1, 7,
  64} x k {1, 4, 128, 129}, unmasked and with all but two items masked,
  on crafted exact catalogs (ties across tiles, NaN, infinities, signed
  zeros) and random ones: bit-equal across routes, crafted ones bit-equal
  to the plain version, B = 64 rows equal to their B = 1 calls.

The evaluation slice adds (lifecycle also runs ``cli.main eval`` of the
shipped recommendation sweep on its ML-100K app: an EVALCOMPLETED
instance and the JAX verb's summary as the last stdout line), run after
simtrain:

- eval: K3 (``ranking_metrics_batch``, ``csrc/ranking.cu``) against its
  plain version at an ML-1M fold (Q = 333,334) x P {1, 10} x A {1, 3},
  k = P and 10, and P = 40: precision and valid equal, ap and ndcg within
  1e-6; K2 (``gather_top_k_batch``, which ``eval_topk`` calls) against
  its plain version at an ML-1M fold's B = 333,334 user rows (f32, int8;
  k 1, 10), and ``top_k_items_batch`` (the dense-row alias over it) at B
  = 600,000, above the 524,280 rows one launch took (row chunks); K1s at
  the ML-20M shape, rank 20, a 4-candidate lambda sweep of 2 iterations:
  each candidate bit-identical to ``als_train`` of it alone, C = 1
  bit-identical to K1, ranks 10 + 20 split into two groups, ranks
  10/20/20/20 one padded group (padded columns +0.0 bitwise, real ones
  equal to rank 10 alone), 1 iteration against the plain version; then
  ``run_evaluation`` of the shipped sweep (ranks 5/10/10/20, 10
  iterations, 3 folds) on the ML-1M-shaped ratings, the K1s / K2 / K3
  counts set to 0 before and read after, every candidate on the fast
  path, its scores equal to core/ranking.py's per-query functions on the
  same top-k matrices within 1e-6 (worker processes, stopped after), and
  each kernel held at the shapes that run gave it: K1s's launches equal
  to its three groups' (ranks 5, 10 + 10, 20: C = 1, 2, 1), every swept
  model bit-identical to its candidate's training alone, one iteration
  of each group against the plain version, every ``eval_topk`` answer (D
  = 5, 10, 20) against K2's plain version; and the times of K3, K2 at
  the eval shape and one K1s iteration (against K1 alone x 4) beside
  their plain versions, yardsticks and bounds.

The two-stage retrieval slice adds (k4 and k5 after k2cos, retrieval
after eval, retimes after times):

- k4: K4 (``ops/retrieval.py coarse_topk``) on both of its routes (the
  warp route for k' <= 128, the stream route above, and the stream route
  reached at k' <= 128 through ``_coarse_topk_stream``) against its plain
  version at I = 1,000,000 and 10,000,000, D = 32 (tiles of 2^18, the
  last padded): modes int8 and int8_dot on an int8 pair, bf16 on a dense
  table's copy, B {1, 8, 64} x k' {32, 128, 256, 1024} at 1M (a subset
  at 10M), bit for bit; crafted catalogs of exact ties at every k'
  boundary with a NaN row, k' >= I on each route, and k' above K4_MAX_K
  refused; each route's shared-memory size in C against Python's, and
  one launch a warp-route call;
- k5: K5 (``rescore_top_k``) against its plain version at I = 1,000,000:
  gather (every user x item storage pair), vectors and summed-rows
  queries, B {1, 8, 64}, candidates from a K4 shortlist with -1 slots,
  bit for bit; rows against K2 / K2s on the same pairs (the rest of the
  catalog masked): scores bit for bit;
- retrieval: the 1M-item recommendation model (U = 138,493, rank 32; f32
  and int8, the int8 server probing recall on every dispatch) and a
  1M-item similar-product model (rank 10) saved through the port's
  storage and served by ``cli.main deploy`` with the micro-batcher:
  500 distinct users (500 item queries) at concurrency 1 and 8 at num =
  10, blackList queries deeper than the top 20, categories queries on
  the exact path: answers against the plain two-stage versions, recall@10
  >= 0.999 against exact K2 / K2s, K2's scores bit for bit where the
  shortlist covers the exact top 10, K4 / K5 / K2 calls per dispatch from
  ``/metrics`` (every num = 10 dispatch's K4 call on the warp route, one
  launch; the blackList queries', k' = 512, on the stream route, two),
  the ``/stats.json`` retrieval block, a traced request's
  ``dispatch.shortlist`` / ``dispatch.rescore`` spans, ready_s, p50 /
  p99 / q/s;
- retimes: K4's warp route against its stream route on the same inputs
  at I = 1M and 10M, D = 32 (every mode, B = 8 at k' = 32 and 128; at 1M
  also B = 1 and 64 at k' = 128), each beside its bound (bytes, and the
  FP32 instructions of the unfused products and sums); K4 per mode and
  K5 at B = 8, k' = 128, beside their plain versions, bounds and one-call
  yardsticks; two-stage (K4 + K5) beside the exact path (K2,
  ``torch.topk(u @ V.T)``) on f32 and int8 catalogs.

The other ALS templates' slice adds (k6 and k2cos after k5, templife
after simlife, templates after simtrain; retrieval serves two more
templates):

- k6: K6 (``ops/cosine_sim.py item_similarity_topn``,
  ``csrc/cosine_sim.cu``: the dense stage ``gram_s8_kernel`` for the
  heavy users where the layout splits them off, the sparse stage
  ``cosine_topn_kernel``, K2's ``select_kernel`` above top_n 128) against
  its plain version (the JAX program in torch: dense user-chunk tiles,
  ``tile_b^T @ tile``, the masks, a stable sort on the order key):
  integer view counts bit for bit (ids of -inf padding included),
  fractional values within atol 1e-5; every case on the layout's design
  and with H = 0. ML-100K (with 37 empty items; top_n 1, 20, 128, 129,
  256, I - 1) and ML-1M views in full (top_n 20, 129, 256, I - 1; also
  in forced column passes), T forced to 0, to the cost model's pick and
  above the largest degree on both, I = 100 at top_n = 99, I = 120,000
  (three column passes; three blocks held), the ML-20M views at top_n =
  20 (the kernels on every row, the plain version on every block,
  timed); the dense stage alone bit for bit against its plain version
  (at 100k and 20m); at 20m each stage's device time, the heaviest row's
  block alone, the H = 0 and ordered-route times, the function's bound
  and each stage's;
- k2cos: ``top_k_similar`` (K2's cosine mode) against its plain version
  at I {50, 26,744, 1M} x f32/bf16/int8 x norms given or not x masked or
  not x k {4, 128, 300}, crafted ties and a zero row (ids equal, scores
  rtol 1e-5), ``top_k_items`` bit for bit; their times at I = 26,744;
- templife: recommended-user, e-commerce and the cosine similar-product
  engine from ML-100K-shaped events in sqlite through ``cli.main train``
  and ``deploy``, queries against the plain path on the same model;
- templates: the three engines at the ML-20M shape and their defaults
  through ``run_train`` (K6's counters reset before the cosine training
  and read after: the main path's launches, by stage; the dense stage
  must have run), saved, deployed in
  subprocesses with the batcher, 500 distinct queries at concurrency 1
  and 8: answers against the plain path, ready_s, p50 / p99 / q/s, K2 /
  K2s calls per dispatch from /metrics, the e-commerce live-filter cache
  (one store read per user per change token, dropped after a write);
- retrieval also serves a 1M-row recommended-user model and a 1M-item
  e-commerce model (rank 32) two-stage: recall@10 >= 0.999 against exact
  K2s / K2, answers against the plain two-stage versions, one warp-route
  K4 launch per dispatch.

The two-stage redesign (K4's stream route one launch, K5 the epilogue
of K4's merge: every two-stage call one launch) changes three phases:

- k4 also holds the stream route at k' in {129, 256, 512, 2048, 8192}
  (and B = 64 at 512 and 8192), the pair it replaced (two launches, the
  baseline) on the crafted catalogs, one launch a call on either route,
  the C entries' shared-memory sizes of both routes fused and alone,
  and the fused call (``two_stage_top_k``) at 1M: every coarse mode x
  item-table dtype x query form at (B, k', k) = (1, 32, 4), (8, 128,
  16), (8, 512, 64) and (64, 256, 32), bit for bit against the composed
  plain versions and against K4 then the standalone K5, one launch each
  and no standalone K5 launch; and past small catalogs (-1 slots);
- retrieval checks every two-stage dispatch of the four templates is
  one fused call of one launch (``pio_two_stage_calls{route}``,
  ``pio_k4_kernel_launches``; ``pio_k5_kernel_launches`` stays 0), the
  warp route at num = 10 and the stream route for the similar-product
  blackList queries (k' = 512) and for e-commerce users whose exact top
  20 are seen (k = 32, k' = 256; their seen items never come back), and
  a traced request's ``dispatch.shortlist`` / ``dispatch.rescore``
  spans on each template's server;
- retimes times K4's three routes (warp, stream, pair) on the same
  inputs at k' = 32, 128 and 512, K4 at k' = 128 and 512 beside its plain
  version and ``torch.topk(q @ V.float().T, k')``, and the serving
  call's paths at B in {1, 8}, (k', k) = (128, 16) and (512, 64): the
  fused call, the two-wrapper path it replaced, K4 then K5 back to back,
  exact K2 and ``torch.topk(q @ V.T, k)``, by ``torch.profiler`` and by
  CUDA events; and the card's ``%globaltimer`` tick.

The K1s and K3 redesign (K1s: entry-major stacks, a warp a table row for
a chunk of candidates with register-blocked products, then the finish a
thread a system or a warp a row; K3: lanes a query sized to the cutoff)
changes the eval phase:

- K3 and its earlier one-warp design against the plain version at P in
  {1, 3, 10, 32, 33, 40, 100}, across the lane groups' sizes;
- K1s's launch counts are its own (two a bucket up to rank 32), on the
  ML-20M sweeps and the eval path;
- every bucket of the ML-20M layout (rank 20 at C = 4, and ranks 10/20/20
  padded to 20) and of the eval path's first fold (its groups: ranks 5 C
  = 1, 10 C = 2, 20 C = 1), for f32, bf16 and int8 storage, explicit and
  implicit: the redesigned kernels, the earlier design
  (``_solve_bucket_sweep_grid``) and K1 alone for each candidate write
  bit-identical tables, and the C entry's plan is ``k1s_plan``'s;
- eval times: K3 beside its earlier design (in turns); one K1s iteration
  at ML-20M C = 4 beside the earlier design and K1 alone x 4, and at each
  eval group beside the earlier design, on three clocks (CUDA events as
  enqueued, events behind a queued ``torch.cuda._sleep`` -- device time
  without host gaps -- and ``torch.profiler`` with the launches its
  trace held against those made) and the host's enqueue time.

The checkpointed-training and speed-layer slice adds (ckpt and
realtime after train):

- ckpt: ``als_train`` on the train phase's ML-20M layout, rank 20, 4
  iterations, f32 and int8 storage: one shot, checkpointed every
  iteration, checkpointed every 2 (the iteration-2 snapshot) and resumed
  from it -- tables bit for bit on the card; the checkpoint write
  seconds and file bytes;
- realtime: the ckpt phase's f32 model in a sqlite store holding 50
  known users' histories (the heaviest with 9,254 distinct items),
  ``cli.main deploy --realtime 0.5`` in a subprocess; 200 new users x 20
  ratings, 5 new ratings for each known user and ratings of 10 unseen
  items in one commit, folded (``/stats.json`` foldin epoch, nothing
  behind) in one fold whose K1 launches the server's ``/metrics`` counts;
  each folded user's answer against K1's fold plus the plain top-k; each
  fold group's K1 against its plain version, the grouped layout bit for
  bit against K1 on one padded bucket (256 x 16,384); the fold cycle's
  seconds, K1 per fold and the K = 16,384 group alone against bound,
  plain and library; HTTP p50 at concurrency 1 idle and while folding.

The ingest-front slice adds (ingest after lifecycle):

- ingest: the quickstart through ``cli.main`` on a fresh sqlite store.
  Beside the build and the kernel checks (``IngestPrep``, processes of
  their own, no device; the first phase that times host work waits for
  it):
  the ML-1M-shaped ratings (1,000,000 ``rate`` events) written as JSON
  lines, ``app new ML1M`` (the access key from stdout), ``import`` of the
  first 500,000 (a Python row an event into sqlite; all of them outlast
  the build) with ``version`` and ``status`` beside it (the native
  event codec must have loaded, from ``predictionio_tpu_torch/_build/``),
  then ``export`` (as many lines as events imported) with the imported
  ratings read back by ``find_ratings`` beside it (equal to the generated
  ones as multisets).
  Then ``eventserver --stats`` in a process of its own: 1,000 single
  ``POST /events.json``, 100 batches of 50, 20,000 events by
  ``import --http`` (binary frames), a Segment.io and a MailChimp
  webhook, reads, a delete, and ``/stats.json``'s counts (its device
  block shows CUDA never initialised); ``train`` at rank 20, 10
  iterations, and ``deploy`` in this process with K1's and K2's counts
  reset before and read after, queries against K2's plain version, and
  ``undeploy``, which must close the server's port. It prints import
  and export events/s, each endpoint's events/s and the p50 of one
  ``POST /events.json`` beside the card's name and power limit.

The file-log slice adds (filelog after ingest, on IngestPrep's file):

- filelog: beside the build (``FilelogPrep``, once IngestPrep's file is
  written; the first phase that times host work waits for it) ``app
  new``, then ``import`` of the ML-1M file's first 500,000 events into a
  partitioned store (8 partitions, 4 MiB segments, ``--warm-cache``;
  a fold there replays the whole store) and of all of it into a jsonl
  store,
  both on the splice route (``import_events`` calls ``append_jsonl`` and
  never ``insert``/``batch_insert``, checked in process on the first
  10,000 lines), and ``export`` from both. In the phase: the ratings
  read back by ``find_ratings`` and ``read_training`` equal to the
  generated ones as multisets; ``read_training`` cold (no columnar cache)
  and warm. ``train`` (rank 20, 10 iterations) on the partitioned store,
  K1's count 10 x the buckets; one ``$set`` through the event server into
  each partition without an active log (so every partition has one when
  the tailer attaches; the store keeps one segment size throughout, and a
  partition that seals while the new events arrive is counted);
  ``deploy --realtime 0.5`` in a subprocess (files mode), 50 known users
  against K2's plain version (K2's calls from its /metrics); the deploy
  stops, the event server takes
  200 new users x 20 ratings, 5 for each known user (the heaviest among
  them), 20 of 10 unseen items and 100 ``$set`` lines as PIF1 frames, and
  the deploy starts again on its cursor and folds them once: columnar +
  fallback lines = lines posted, the fold's K1 launches (``/metrics``) =
  one fold's grouped launches, every folded user's answer against K1's
  fold plus the plain top-k; in this process ``fold_in_columnar`` against
  ``fold`` on the same lines bit for bit, f32 and int8. Then
  retrain-on-deploy: ``run_train`` with an algorithm that persists no
  model, and the engine server's deploy trains (K1 2 x the buckets) and
  answers against the plain version (K2 counted). It prints import and export
  events/s, ``read_training`` seconds, the fold's seconds, K1 ms and
  ``secondsBehind`` beside the card's name and power limit.

The prep-cache slice adds (prepcache after filelog, on its stores; every
train of the script runs with ``PIO_PREP_CACHE_DIR`` under a temporary
directory of its own):

- prepcache: ``cli.main train`` (rank 20, 5 iterations) on the filelog
  phase's jsonl store into a fresh cache directory (``--prep-cache-dir``):
  a miss that publishes an entry, then a hit (no scan), then, after
  ``import`` of 5,000 rating events (200 new users, 50 new items, known
  users), a splice; each with K1's count reset before and read after
  (the iterations x the buckets). The hit's and the splice's batch and
  both bucket lists, as ``als_train`` received them, bit-equal to a
  ``PIO_PREP_CACHE=0`` read and ``build_padded_buckets`` of the same
  log; the splice-fed train's factors bit-equal to a ``train
  --no-prep-cache`` from the same seed (both on K1). On the partitioned
  store, the entry its filelog ``train`` published, then a seal (an
  append through a client with small segments): the probe rebuilds,
  counted with reason ``changed``. Then ``cache list --json``, ``cache
  evict`` and ``cache prune --max-mb``. It prints each train's status,
  ``read_training`` and layout seconds, train wall and K1 launches beside
  the card's name and power limit.

The daemon and supervisor slice adds (fleet after prepcache, on the
filelog phase's jsonl store; every child loads the kernels the build
phase built into the package's ``_build/`` and shares the prepcache
phase's cache directory):

- fleet: ``train`` of an ML-1M variant (rank 20, 5 iterations), which
  publishes the prep-cache entry; ``cli.main supervise --no-dashboard
  --no-adminserver`` in a process of its own with the event server and
  the engine (deployed on the card, K2) as its children, a run dir of
  its own and ``--retrain-every`` FLEET_RETRAIN_EVERY: 50 known users'
  answers; 3,000 rating events (100 new users) posted as PIF1 frames
  through the supervised event server before the first retrain falls
  due (the cadence counts from the supervisor's start); kill -9 of the
  engine child (its pid file), the seconds to a new instance id on
  ``/healthz`` and to the first 200 on ``/queries.json``, the answers
  byte-identical (the same instance: no retrain has finished),
  ``restarts 1`` in ``supervisor.json`` and
  ``pio_supervisor_restarts_total`` on the supervisor's ``/metrics``;
  then the one scheduled warm retrain (K1; its launches the retrain
  child's own count in its progress file, held against its iterations x
  the buckets), a prep-cache splice of every posted event
  (the retrain's log), and its ``/reload``: the engine serves the new
  instance, its answers (new users too) against that instance's model
  loaded here and scored by K2's plain version; ``status`` and ``status
  --json``; SIGTERM to the supervisor stops the engine, then the event
  server, leaving no pid file, no fleet process and no fleet memory on
  the card (``nvidia-smi --query-compute-apps``, the card's free
  memory). Then ``start-all`` with the same flags, ``rolling-restart
  engine`` under a keep-alive query loop (no non-200, byte-identical
  answers, a new instance id; the overlap's extra device memory), and
  ``stop-all`` (ports closed, nothing left on the card). It prints every
  child's spawn-to-healthy and spawn-to-ready seconds, the retrain's wall
  time and prep-cache status, and K2's calls on each engine.

The worker-process and router slice adds (workers after fleet, on the
fleet phase's jsonl store and its newest instance, rank 20; needs fleet):

- workers: ``cli.main deploy --workers 2`` of that instance on the card
  beside a single-process ``deploy`` of it, started together: fresh
  connections to ``/healthz`` until two worker pids answered; the
  parent maps neither torch nor the CUDA driver (``/proc/<pid>/maps``),
  each worker maps the driver and holds the model in its own CUDA
  allocator (its ``/stats.json`` ``device`` block), and the card's free
  memory shows what the two workers hold once the single deploy stops
  (``nvidia-smi --query-compute-apps`` is printed as it lists them: on
  a container's card one entry, not the processes);
  WORKERS_IDENTITY distinct users over fresh connections byte-identical
  to the single process, a sample against the model loaded here and
  scored by K2's plain version; closed-loop q/s at concurrency 8 and 64
  (WORKERS_LOAD distinct users a level) of the single process and of
  the workers, every answer byte-identical; each worker's K2 tile-route
  calls from its own ``/metrics`` (``/healthz`` then ``/metrics`` on
  one keep-alive connection), each some and all of them the queries sent
  plus one warmup a worker; kill -9 of one worker: the parent exits
  nonzero, the other worker goes, nothing is left on the card. Then
  ``cli.main supervise --no-dashboard --no-adminserver --replicas 2``
  (the event server, ``engine-0``, ``engine-1`` and ``router``): routed
  answers and answers straight from each replica byte-identical to the
  single process's, q/s through the router at 8 and 64, both replicas
  with routed requests, a repeated query kept on its replica, each
  replica's K2 calls equal to the router's attempts on it plus the
  straight queries plus its warmup; a keep-alive loop through the router
  across a kill -9 of ``engine-0`` (no non-200, byte-identical, retries
  or ejections, the supervisor's restart and the router's admission of
  the new instance, with their seconds); ``status`` (replica lines) and
  ``status --json``; the router and the event server still without
  torch; SIGTERM to the supervisor leaves no pid file, no process and no
  memory of the replica set on the card.

Every phase prints its results and seconds; any failure makes the exit
code 1 and suppresses the result lines. Without CUDA, or without the
package beside the script, it exits 2 and prints no result. A run of a
subset of the phases (``--phases``, for development) prints no result.
The last line is ``{"ok": true, "device": {"platform": "gpu", "kind":
..., "count": 1}}``, the one before it the ``{"kernels": [...]}``
summary, and the one before that the ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import http.client
import io
import json
import os
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

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


KERNEL_SOURCES = ("topk", "als_solve", "ranking", "retrieval", "cosine_sim")
#: the sources of the checks before k4 (EARLY_STEPS); the rest, the
#: longest build among them, go on building beside those checks
EARLY_SOURCES = ("topk", "als_solve", "ranking", "cosine_sim")
EARLY_STEPS = ("k2", "k1", "k1i", "k1route", "k2s", "k2route", "k6", "k2cos")


class LateBuild(threading.Thread):
    """The kernel sources outside EARLY_SOURCES, built beside the early
    checks. ``_build.load`` holds a lock a source, so a call that needs
    one of them meanwhile waits for its build instead of starting
    another."""

    def __init__(self):
        super().__init__(name="late-build", daemon=True)
        self.names = [n for n in KERNEL_SOURCES if n not in EARLY_SOURCES]
        self.error: str | None = None

    def run(self):
        from predictionio_tpu_torch.kernels import _build

        try:
            _build.load_all(self.names)
        except Exception:
            self.error = traceback.format_exc()


def log_build(name: str) -> None:
    from predictionio_tpu_torch.kernels import _build

    info = _build.build_info[name]
    log(f"built csrc/{name}.cu in {info['seconds']:.2f}s (cached={info['cached']})")
    for ln in info["log"].splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            log("  ptxas: " + ln.strip())


@phase("build")
def build(late: LateBuild):
    from predictionio_tpu_torch.kernels import _build

    late.start()  # one nvcc per source, all started together
    _build.load_all(EARLY_SOURCES)
    for name in EARLY_SOURCES:
        log_build(name)


@phase("build: the late sources")
def finish_build(late: LateBuild):
    late.join()
    if late.error:
        raise AssertionError(late.error)
    for name in late.names:
        log_build(name)


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
                            route = topk.k2_route(k, I_ROWS, batch).name
                            before = topk.gather_top_k_batch.routes[route].value
                            sk, ik = topk.gather_top_k_batch(ixs, users, items, k, m)
                            if topk.gather_top_k_batch.routes[route].value != before + 1:
                                raise AssertionError(f"k={k} B={batch}: not the {route} route")
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


# -- K2 summed rows vs plain ------------------------------------------------------

K2S_RANKS = (10, 20, 128)
K2S_WIDTHS = (1, 4, 16)


def normalized_catalog(torch, dtype: str, rank: int, gen, device):
    """A random catalog as the cosine templates deploy it
    (models/filters.py normalized_device_factors): f32 unit rows, or the
    int8 pair (values, 1/||values||)."""
    from predictionio_tpu_torch.models.filters import normalized_device_factors
    from predictionio_tpu_torch.ops.als import quantize_rows

    x = torch.randn((I_ROWS, rank), generator=gen, device=device)
    if dtype == "int8":
        q, s = quantize_rows(x)
        return normalized_device_factors(host(q), host(s), device)[0]
    return normalized_device_factors(host(x), None, device)[0]


def query_rows(torch, rng, batch: int, width: int, device):
    """[B, L] lists of 1..L distinct catalog rows, right-padded with
    weight-0 copies of row 0 (models/similarproduct.py's padding)."""
    ixs = np.zeros((batch, width), np.int32)
    w = np.zeros((batch, width), np.float32)
    for b in range(batch):
        n = int(rng.integers(1, width + 1))
        ixs[b, :n] = rng.choice(I_ROWS, n, replace=False)
        w[b, :n] = 1.0
    return torch.from_numpy(ixs).to(device), torch.from_numpy(w).to(device)


@phase("K2 summed rows vs plain")
def k2_sum_rows_vs_plain(torch, device, stats):
    """K2's summed-rows mode (ops/topk.py sum_rows_top_k_batch) against its
    plain version at the ML-20M catalog (I = 26,744): f32 and int8
    catalogs x D {10, 20, 128} x B {1, 64} x L {1, 4, 16} x k {4, 16,
    128}, with and without an exclude mask: bit for bit on exact
    (small-integer) catalogs, within rtol 1e-5 / atol 1e-6 on normalized
    random ones with ids equal outside runs of near-tied scores. Then the
    two invariances the template promises, bit for bit: row b of a B=64
    call equals the same query alone, and a query padded from L to 2L
    with weight-0 copies of row 0 equals itself unpadded."""
    from predictionio_tpu_torch.ops import topk

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 7)
    rng = np.random.default_rng(SEED + 7)
    mask = torch.rand(I_ROWS, generator=gen, device=device) < 0.1
    checks = 0
    worst = 0.0
    for rank in K2S_RANKS:
        for dtype in ("float32", "int8"):
            for exact in (True, False):
                items = (make_table(torch, dtype, I_ROWS, rank, True, gen, device) if exact
                         else normalized_catalog(torch, dtype, rank, gen, device))
                for batch in BATCHES:
                    for width in K2S_WIDTHS:
                        ixs, w = query_rows(torch, rng, batch, width, device)
                        for k in (4, 16, 128):
                            for m in (None, mask):
                                before = topk.sum_rows_top_k_batch.routes["tile"].value
                                sk, ik = topk.sum_rows_top_k_batch(ixs, w, items, k, m)
                                if topk.sum_rows_top_k_batch.routes["tile"].value != before + 1:
                                    raise AssertionError(f"k={k}: not the tile route")
                                sp, ip = topk.sum_rows_top_k_batch_reference(
                                    ixs, w, items, k, m)
                                torch.cuda.synchronize()
                                what = (f"D={rank} {dtype} exact={exact} B={batch} "
                                        f"L={width} k={k} mask={m is not None}")
                                if exact:
                                    if not (torch.equal(ik, ip) and same_bits(torch, sk, sp)):
                                        raise AssertionError(f"not bitwise equal: {what}")
                                else:
                                    hk, hp = host(sk), host(sp)
                                    err = float(np.max(np.abs(hk - hp), initial=0.0))
                                    worst = max(worst, err)
                                    if not np.allclose(hk, hp, rtol=RTOL, atol=ATOL):
                                        raise AssertionError(
                                            f"scores differ (max abs {err}): {what}")
                                    ids_k, ids_p = host(ik), host(ip)
                                    for r in range(batch):
                                        if not near_tie_ids_ok(ids_k[r], ids_p[r], hp[r]):
                                            raise AssertionError(f"ids differ row {r}: {what}")
                                checks += 1
                        if batch > 1 and not exact:  # the two invariances
                            sk, ik = topk.sum_rows_top_k_batch(ixs, w, items, 16, mask)
                            pad_i = torch.cat([ixs, torch.zeros_like(ixs)], 1)
                            pad_w = torch.cat([w, torch.zeros_like(w)], 1)
                            s2, i2 = topk.sum_rows_top_k_batch(pad_i, pad_w, items, 16, mask)
                            if not (torch.equal(i2, ik) and same_bits(torch, s2, sk)):
                                raise AssertionError(f"L -> 2L padding changed bits: "
                                                     f"D={rank} {dtype} L={width}")
                            for r in range(batch):
                                s1, i1 = topk.sum_rows_top_k_batch(
                                    ixs[r:r + 1], w[r:r + 1], items, 16, mask)
                                if not (torch.equal(i1[0], ik[r])
                                        and same_bits(torch, s1[0], sk[r])):
                                    raise AssertionError(f"row {r} differs from its B=1 "
                                                         f"call: D={rank} {dtype} L={width}")
    stats["k2s_max_abs_err"] = worst
    log(f"{checks} summed-rows kernel-vs-plain configurations agree (worst abs diff "
        f"{worst:.3g}); batch and padding invariance bit for bit")


# -- K2's two routes against each other ----------------------------------------

K2ROUTE_ITEMS = (50, 1000, I_ROWS)  # below one tile; not multiples of 128
K2ROUTE_BATCHES = (1, 7, 64)
K2ROUTE_USERS = 4096


def crafted_catalog(torch, dtype: str, rows: int, rank: int, gen, device):
    """An exact (small-integer) catalog whose scores hold ties across tile
    and chunk boundaries (rows 120..135 and the last row copy row 0),
    NaN (int8: from a NaN scale with either sign bit), +inf and -inf, and
    (int8 only: a zero row times a negative scale) -0.0 beside +0.0.
    Dense tables carry the specials in their values, the int8 pair in
    its scales."""
    table = make_table(torch, dtype, rows, rank, True, gen, device)
    values = table[0] if isinstance(table, tuple) else table
    if rows > 136:
        values[120:136] = values[0]
        values[rows - 1] = values[0]
    if isinstance(table, tuple):
        q, s = table
        s[3], s[5], s[7] = float("nan"), float("inf"), float("-inf")
        s[6].view(torch.int32).fill_(-1)  # a NaN with the sign bit set
        q[9], s[9] = 0, -1.0  # -0.0 for every user
        q[11], s[11] = 0, 1.0  # +0.0
        return q, s
    values[3, 0] = float("nan")
    values[5, 1] = float("inf")
    values[7, 0] = float("-inf")
    values[11] = 0
    return values


@phase("K2 tile route vs select route")
def k2_route_vs_select(torch, device, stats):
    """K2's tile route (ops/topk.py k2_route, k <= K2_TILE_MAX_K) against
    its select route on the same CUDA tensors, in both modes (user rows,
    and summed catalog rows at L = 4): f32, bf16 and int8 storage x I {50
    (below one tile), 1,000, 26,744 (not multiples of 128)} x B {1, 7, 64}
    x k {1, 4, cap, cap + 1}, with no mask and with all but two items
    masked (so k exceeds the unmasked count), on crafted exact catalogs
    (ties across tiles, NaN, infinities, signed zeros) and
    random ones: scores and ids bit-equal across the routes; on the
    crafted catalogs bit-equal to the plain version too; every row of a
    B = 64 call bit-equal to its B = 1 call. At k = cap + 1 (the select
    route) the first cap entries equal the tile route's k = cap answer."""
    from predictionio_tpu_torch.ops import topk

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 29)
    rng = np.random.default_rng(SEED + 29)
    cap = topk.K2_TILE_MAX_K
    checks = 0
    routes_seen = set()

    def same(a, b):
        return torch.equal(a[1], b[1]) and same_bits(torch, a[0], b[0])

    for num_items in K2ROUTE_ITEMS:
        all_but_two = torch.ones(num_items, dtype=torch.bool, device=device)
        all_but_two[torch.randperm(num_items, generator=gen, device=device)[:2]] = False
        for dtype in DTYPES:
            for crafted in (True, False):
                if crafted:
                    items = crafted_catalog(torch, dtype, num_items, 20, gen, device)
                    users = make_table(torch, dtype, K2ROUTE_USERS, 20, True, gen, device)
                else:
                    items = make_table(torch, dtype, num_items, 20, False, gen, device)
                    users = make_table(torch, dtype, K2ROUTE_USERS, 20, False, gen, device)
                for batch in K2ROUTE_BATCHES:
                    uix = torch.randint(0, K2ROUTE_USERS, (batch,), generator=gen,
                                        device=device, dtype=torch.int32)
                    rix, w = (torch.from_numpy(a).to(device) for a in (
                        rng.integers(0, num_items, (batch, 4)).astype(np.int32),
                        (rng.random((batch, 4)) < 0.8).astype(np.float32)))
                    for k in (1, 4, cap, cap + 1):
                        for m in (None, all_but_two):
                            what = (f"I={num_items} {dtype} crafted={crafted} B={batch} "
                                    f"k={k} mask={m is not None}")
                            calls = (
                                ("gather", lambda f, kk: f(uix, users, items, kk, m),
                                 topk.gather_top_k_batch, topk._gather_top_k_select,
                                 topk.gather_top_k_batch_reference),
                                ("summed", lambda f, kk: f(rix, w, items, kk, m),
                                 topk.sum_rows_top_k_batch, topk._sum_rows_top_k_select,
                                 topk.sum_rows_top_k_batch_reference),
                            )
                            for mode, call, routed, select, plain in calls:
                                route = topk.k2_route(min(k, num_items), num_items, batch)
                                before = routed.routes[route.name].value
                                kernels = routed.kernel_launches.value
                                got = call(routed, k)
                                if routed.routes[route.name].value != before + 1:
                                    raise AssertionError(f"not served by the {route.name} "
                                                         f"route: {mode} {what}")
                                want = topk.k2_launches(min(k, num_items), num_items, batch,
                                                        mode == "summed")
                                if routed.kernel_launches.value - kernels != want:
                                    raise AssertionError(f"not {want} kernel launches: "
                                                         f"{mode} {what}")
                                routes_seen.add(route.name)
                                kernels = select.kernel_launches.value
                                base = call(select, k)
                                if select.kernel_launches.value - kernels != (
                                        3 if mode == "summed" else 2):
                                    raise AssertionError(f"select route launch count: "
                                                         f"{mode} {what}")
                                torch.cuda.synchronize()
                                if not same(got, base):
                                    raise AssertionError(f"routes differ: {mode} {what}")
                                if crafted and not same(got, call(plain, k)):
                                    raise AssertionError(f"not the plain version's bits: "
                                                         f"{mode} {what}")
                                if k == cap + 1 and num_items > cap:
                                    tile = call(routed, cap)
                                    if not same(tile, (got[0][:, :cap], got[1][:, :cap])):
                                        raise AssertionError(f"k=cap differs from the "
                                                             f"k=cap+1 prefix: {mode} {what}")
                                if batch == 64 and k in (4, cap):
                                    for r in range(batch):
                                        if mode == "gather":
                                            one = routed(uix[r:r + 1], users, items, k, m)
                                        else:
                                            one = routed(rix[r:r + 1], w[r:r + 1], items, k, m)
                                        if not same((one[0][0], one[1][0]),
                                                    (got[0][r], got[1][r])):
                                            raise AssertionError(f"row {r} differs from its "
                                                                 f"B=1 call: {mode} {what}")
                                checks += 1
    if routes_seen != {"tile", "select"}:
        raise AssertionError(f"routes exercised: {sorted(routes_seen)}")
    log(f"{checks} route-vs-route configurations bit-equal (both modes; crafted ones "
        f"also to the plain version); B=64 rows equal their B=1 calls")


# -- K1 vs plain ---------------------------------------------------------------

# per solve (normwise over a solved row), f32 and bf16 compute alike
K1_RTOL, K1_ATOL = 1e-4, 1e-5
# the ranks in use (10-128), each register-tile size of the block kernel
# (1, 2, 4, 9, 17 and 33 owned entries a thread: D = 20, 30, 40, 64, 80,
# 128), and the two sides of the warp route's bound (32: warp, 33: block)
K1_RANKS = (1, 10, 20, 30, 32, 33, 40, 64, 80, 128)
K1_WIDTHS = (8, 2048)
K1_REG = 0.05


def k1_bucket(torch, rng, counts, K: int, n_other: int, device):
    """(col_ids, ratings, mask, seg_start) of a bucket whose solved row r
    has ``counts[r]`` entries, packed to the front of ceil(n / K) >= 1
    consecutive table rows of width K."""
    nseg = [max(1, -(-n // K)) for n in counts]
    seg_start = np.concatenate([[0], np.cumsum(nseg)]).astype(np.int32)
    B = int(seg_start[-1])
    col = np.zeros((B * K,), np.int32)
    rat = np.zeros((B * K,), np.float32)
    msk = np.zeros((B * K,), np.float32)
    for r, n in enumerate(counts):
        base = int(seg_start[r]) * K
        for s0 in range(0, n, K):  # segment by segment, packed to the front
            m = min(K, n - s0)
            lo = base + s0
            col[lo:lo + m] = rng.integers(0, n_other, m)
            rat[lo:lo + m] = rng.integers(1, 11, m) / 2.0
            msk[lo:lo + m] = 1.0
    put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return (put(col.reshape(B, K)), put(rat.reshape(B, K)), put(msk.reshape(B, K)),
            put(seg_start))


def solve_float64(torch, other, col, rat, msk, seg_row, R: int, reg: float,
                  weighted: bool, compute: str, implicit: bool = False,
                  alpha: float = 1.0, gram=None):
    """The bucket's systems solved in float64 from the inputs as K1 rounds
    them: the gathered values, the weights w and r (explicit: the mask
    and rating * mask; implicit: alpha r m and (1 + alpha r) m) and w g
    in the compute dtype; for the implicit form the float32 Gramian; the
    lower triangle of A (in bf16 compute w g is rounded before the
    product, so A's two triangles can differ)."""
    from predictionio_tpu_torch.ops import als

    dt = getattr(torch, compute)
    g = als._read_rows(other, col.long(), dt)
    w, r = als._bucket_weights(rat, msk, dt, implicit, alpha)
    wg = (g * w[..., None]).double()
    g, r = g.double(), r.double()
    A = torch.bmm(wg.transpose(1, 2), g)
    b = torch.bmm(r[:, None, :], g)[:, 0]
    n = msk.double().sum(1)
    if seg_row is not None:
        A = torch.zeros((R,) + A.shape[1:], dtype=A.dtype, device=A.device).index_add_(
            0, seg_row, A)
        b = torch.zeros((R, b.shape[1]), dtype=b.dtype, device=b.device).index_add_(
            0, seg_row, b)
        n = torch.zeros((R,), dtype=n.dtype, device=n.device).index_add_(0, seg_row, n)
    lam = torch.where(n > 0, reg * (n if weighted else torch.ones_like(n)),
                      torch.ones_like(n))
    A = A + lam[:, None, None] * torch.eye(A.shape[1], dtype=A.dtype, device=A.device)
    if implicit:
        A = A + gram.double()[None]
    A = torch.tril(A)
    return torch.linalg.solve(A + A.tril(-1).transpose(1, 2), b)


def per_solve_ok(torch, x, ref) -> bool:
    """Every solved row of ``x`` within atol + rtol * max|ref row| of
    ``ref``, normwise: a component much smaller than its row is as
    uncertain as the row's largest, by the system's conditioning."""
    err = (x.double() - ref.double()).abs().amax(dim=1)
    scale = ref.double().abs().amax(dim=1)
    return bool((err <= K1_ATOL + K1_RTOL * scale).all())


@phase("K1 vs plain")
def k1_vs_plain(torch, device, stats):
    """K1 (csrc/als_solve.cu) against its plain version on the same CUDA
    tensors: storage {f32, bf16, int8} x compute {f32, bf16} x D {1, 10,
    20, 30, 32, 33, 40, 64, 80, 128} x width {8, 2048}, each as an unsegmented
    bucket (with one row of n = 0) and a segmented one (rows of 1 and 33
    segments and one of n = 0). Each solve's x within atol 1e-5 + rtol
    1e-4 * max|x| of its row (normwise per solve) of the plain version,
    and of a float64 solve of the same rounded inputs, at both compute
    dtypes: both versions gather and round the same values at the same
    points (bf16 compute included), so only the f32 summation order and
    the Cholesky algorithm differ, and the buckets hold rows with fewer
    entries than D (rank-deficient Gramians lifted by the regularizer),
    where a small component of x is as uncertain as the row's largest.
    Empty rows must solve to exact zeros. The written-back storage table
    must equal the plain _scatter_rows of the kernel's own x, bit for bit."""
    from predictionio_tpu_torch.ops import als

    rng = np.random.default_rng(SEED + 2)
    n_other = 4096
    configs = 0
    worst = worst_rel_plain = worst_rel_k = worst_rel_p = 0.0
    for D in K1_RANKS:
        base = torch.from_numpy(
            (rng.standard_normal((n_other, D)) / np.sqrt(D)).astype(np.float32)
        ).to(device)
        for storage in DTYPES:
            other = als.to_storage(base, storage)
            for compute in ("float32", "bfloat16"):
                for K in K1_WIDTHS:
                    R = 64 if K == 8 else 8
                    plain = [int(rng.integers(1, K + 1)) for _ in range(R)]
                    plain[1] = 0
                    segmented = list(plain)
                    segmented[0] = int(rng.integers(1, K + 1))  # 1 segment
                    segmented[1] = 32 * K + int(rng.integers(1, K + 1))  # 33
                    segmented[2] = 0
                    weighted = (compute == "float32") != (K == 8)
                    for kind, counts in (("plain", plain), ("segmented", segmented)):
                        col, rat, msk, seg_start = k1_bucket(
                            torch, rng, counts, K, n_other, device)
                        row_ids = torch.from_numpy(
                            rng.permutation(2 * R)[:R].astype(np.int32)).to(device)
                        target = als.to_storage(
                            torch.zeros((2 * R, D), device=device), storage)
                        xk = als.solve_bucket(
                            other, col, rat, msk, seg_start, K1_REG,
                            weighted_reg=weighted, compute_dtype=compute,
                            target=target, row_ids=row_ids)
                        seg_row = als.seg_rows(seg_start, col.shape[0])
                        xp = als.solve_bucket_reference(
                            other, col, rat, msk, K1_REG, seg_row, R,
                            weighted_reg=weighted, compute_dtype=compute)
                        x64 = solve_float64(torch, other, col, rat, msk, seg_row, R,
                                            K1_REG, weighted, compute)
                        torch.cuda.synchronize()
                        what = (f"D={D} storage={storage} compute={compute} K={K} "
                                f"{kind} weighted={weighted}")
                        if not bool(torch.isfinite(xk).all()):
                            raise AssertionError(f"non-finite x: {what}")
                        err = float((xk - xp).abs().max())
                        worst = max(worst, err)
                        scale = x64.abs().amax(dim=1).clamp_min(1e-30)
                        worst_rel_plain = max(worst_rel_plain, float(
                            ((xk.double() - xp.double()).abs().amax(dim=1) / scale).max()))
                        worst_rel_k = max(worst_rel_k, float(
                            ((xk.double() - x64).abs().amax(dim=1) / scale).max()))
                        worst_rel_p = max(worst_rel_p, float(
                            ((xp.double() - x64).abs().amax(dim=1) / scale).max()))
                        if not per_solve_ok(torch, xk, xp):
                            raise AssertionError(f"x differs from the plain version "
                                                 f"(max abs {err}): {what}")
                        if not per_solve_ok(torch, xk, x64):
                            raise AssertionError(f"x differs from the float64 solve: {what}")
                        empty = [r for r, n in enumerate(counts) if n == 0]
                        if not bool((xk[empty] == 0).all()):
                            raise AssertionError(f"an empty row did not solve to 0: {what}")
                        want = als.to_storage(torch.zeros((2 * R, D), device=device),
                                              storage)
                        als._scatter_rows(want, row_ids, xk)
                        got_t = target if isinstance(target, tuple) else (target,)
                        want_t = want if isinstance(want, tuple) else (want,)
                        for g, w in zip(got_t, want_t):
                            if not torch.equal(g.view(torch.uint8), w.view(torch.uint8)):
                                raise AssertionError(f"write-back not bit-equal: {what}")
                        configs += 1
    stats["k1_max_abs_err"] = worst
    log(f"{configs} K1-vs-plain configurations agree (each solve within atol "
        f"{K1_ATOL} + rtol {K1_RTOL} * max|x| of the plain version and of a float64 "
        f"solve; worst abs diff to the plain version {worst:.3g}; worst per-solve "
        f"relative diff {worst_rel_plain:.3g} to the plain version, {worst_rel_k:.3g} "
        f"kernel to float64, {worst_rel_p:.3g} plain to float64; write-back bit-equal)")


# -- K1 implicit vs plain ------------------------------------------------------

K1I_RANKS = (1, 10, 20, 32, 33, 64, 128)
K1I_BAD = 100  # entries of the crafted indefinite row (one column, r = -1)


def craft_dislikes(col, rat, msk, seg_start, K: int, heavy: int, counts, row: int = 3):
    """Solved row ``row`` (one table row) rates column ``heavy``
    min(K1I_BAD, K) times with r = -1 (a dislike): its implicit A is
    indefinite. Edits the bucket in place; returns the new counts."""
    lo = int(seg_start[row]) * K
    flat_c, flat_r, flat_m = (t.view(-1) for t in (col, rat, msk))
    flat_m[lo:lo + K] = 0
    flat_r[lo:lo + K] = 0
    flat_c[lo:lo + K] = 0
    m = min(K1I_BAD, K)
    flat_c[lo:lo + m] = heavy
    flat_r[lo:lo + m] = -1.0
    flat_m[lo:lo + m] = 1.0
    counts = list(counts)
    counts[row] = m
    return counts


@phase("K1 implicit vs plain")
def k1_implicit_vs_plain(torch, device, stats):
    """K1's implicit mode against its plain version on the same CUDA
    tensors: storage {f32, bf16, int8} x compute {f32, bf16} x D {1, 10,
    20, 32, 33, 64, 128} x width {8, 2048}, each as an unsegmented bucket and a
    segmented one (rows of 1 and 33 segments), with rows of n = 0; alpha
    1 at width 8 and 40 at width 2048, implicit_weighted_reg on at f32
    compute and off at bf16, so each pair of the two occurs. At alpha
    40 one crafted row rates one column 100 times with r = -1 (a
    dislike): its A is indefinite, and both versions must solve it to
    an all-NaN x (its int8 write-back: zeros, scale 1). Every other solve
    within atol 1e-5 + rtol 1e-4 * max|x| of its row of the plain version
    and of a float64 solve of the same rounded inputs; written-back
    tables bit for bit equal to the plain _scatter_rows of the kernel's x."""
    from predictionio_tpu_torch.ops import als

    rng = np.random.default_rng(SEED + 5)
    n_other = 4096
    configs = nan_rows = 0
    worst = worst_rel_k = worst_rel_p = 0.0
    for D in K1I_RANKS:
        base_np = (rng.standard_normal((n_other, D)) / np.sqrt(D)).astype(np.float32)
        heavy = int(np.argmax((base_np ** 2).sum(1)))  # the disliked column
        base = torch.from_numpy(base_np).to(device)
        for storage in DTYPES:
            other = als.to_storage(base, storage)
            for compute in ("float32", "bfloat16"):
                gram = als.compute_gram(other, compute)
                weighted = compute == "float32"
                for K in K1_WIDTHS:
                    alpha = 1.0 if K == 8 else 40.0
                    R = 64 if K == 8 else 8
                    plain = [int(rng.integers(1, K + 1)) for _ in range(R)]
                    plain[1] = 0
                    segmented = list(plain)
                    segmented[0] = int(rng.integers(1, K + 1))  # 1 segment
                    segmented[1] = 32 * K + int(rng.integers(1, K + 1))  # 33
                    segmented[2] = 0
                    for kind, counts in (("plain", plain), ("segmented", segmented)):
                        col, rat, msk, seg_start = k1_bucket(
                            torch, rng, counts, K, n_other, device)
                        rat = rat * 2  # counts 1..10
                        bad = []
                        if alpha == 40.0:  # row 3: K1I_BAD dislikes of one column
                            counts = craft_dislikes(col, rat, msk, seg_start, K, heavy, counts)
                            bad = [3]
                        row_ids = torch.from_numpy(
                            rng.permutation(2 * R)[:R].astype(np.int32)).to(device)
                        target = als.to_storage(
                            torch.zeros((2 * R, D), device=device), storage)
                        xk = als.solve_bucket(
                            other, col, rat, msk, seg_start, K1_REG,
                            weighted_reg=weighted, compute_dtype=compute,
                            target=target, row_ids=row_ids,
                            implicit=True, alpha=alpha, gram=gram)
                        seg_row = als.seg_rows(seg_start, col.shape[0])
                        xp = als.solve_bucket_reference(
                            other, col, rat, msk, K1_REG, seg_row, R,
                            weighted_reg=weighted, compute_dtype=compute,
                            implicit=True, alpha=alpha, gram=gram)
                        x64 = solve_float64(
                            torch, other, col, rat, msk, seg_row, R, K1_REG,
                            weighted, compute, implicit=True, alpha=alpha, gram=gram)
                        torch.cuda.synchronize()
                        what = (f"D={D} storage={storage} compute={compute} K={K} "
                                f"{kind} weighted={weighted} alpha={alpha}")
                        nan_k = torch.isnan(xk).any(dim=1)
                        want_nan = torch.zeros_like(nan_k)
                        want_nan[bad] = True
                        if not (torch.equal(nan_k, want_nan)
                                and torch.equal(torch.isnan(xk), torch.isnan(xp))
                                and bool(torch.isnan(xk[bad]).all())):
                            raise AssertionError(f"NaN rows differ (kernel "
                                                 f"{nan_k.nonzero().tolist()}, want {bad}): "
                                                 f"{what}")
                        nan_rows += len(bad)
                        ok = ~nan_k
                        if not bool(torch.isfinite(xk[ok]).all()):
                            raise AssertionError(f"non-finite x: {what}")
                        err = float((xk[ok] - xp[ok]).abs().max())
                        worst = max(worst, err)
                        scale = x64[ok].abs().amax(dim=1).clamp_min(1e-30)
                        worst_rel_k = max(worst_rel_k, float(
                            ((xk[ok].double() - x64[ok]).abs().amax(dim=1) / scale).max()))
                        worst_rel_p = max(worst_rel_p, float(
                            ((xp[ok].double() - x64[ok]).abs().amax(dim=1) / scale).max()))
                        if not per_solve_ok(torch, xk[ok], xp[ok]):
                            raise AssertionError(f"x differs from the plain version "
                                                 f"(max abs {err}): {what}")
                        if not per_solve_ok(torch, xk[ok], x64[ok]):
                            raise AssertionError(f"x differs from the float64 solve: {what}")
                        empty = [r for r, n in enumerate(counts) if n == 0]
                        if not bool((xk[empty] == 0).all()):
                            raise AssertionError(f"an empty row did not solve to 0: {what}")
                        want = als.to_storage(torch.zeros((2 * R, D), device=device),
                                              storage)
                        als._scatter_rows(want, row_ids, xk)
                        got_t = target if isinstance(target, tuple) else (target,)
                        want_t = want if isinstance(want, tuple) else (want,)
                        for g, w in zip(got_t, want_t):
                            if not torch.equal(g.view(torch.uint8), w.view(torch.uint8)):
                                raise AssertionError(f"write-back not bit-equal: {what}")
                        if bad and storage == "int8":
                            rows = row_ids[bad].long()
                            if not (bool((target[0][rows] == 0).all())
                                    and bool((target[1][rows] == 1).all())):
                                raise AssertionError(f"int8 NaN row not q=0/scale 1: {what}")
                        configs += 1
    stats["k1i_max_abs_err"] = worst
    log(f"{configs} K1-implicit-vs-plain configurations agree ({nan_rows} indefinite "
        f"rows NaN in both; each other solve within atol {K1_ATOL} + rtol {K1_RTOL} * "
        f"max|x| of the plain version and of a float64 solve; worst abs diff to the "
        f"plain version {worst:.3g}; worst per-solve relative diff {worst_rel_k:.3g} "
        f"kernel to float64, {worst_rel_p:.3g} plain to float64; write-back bit-equal)")


# -- K1's warp route vs its block kernel ------------------------------------------

K1ROUTE_RANKS = (1, 10, 20, 32)


def storage_rows(torch, table, rows) -> list:
    """The bytes of rows ``rows`` of a storage table, values then (int8)
    scales, as flat uint8 tensors."""
    parts = table if isinstance(table, tuple) else (table,)
    return [p[rows].contiguous().view(-1).view(torch.uint8) for p in parts]


@phase("K1 warp route vs block kernel")
def k1_route_vs_block(torch, device, stats):
    """K1's warp route (ops/als.py k1_route at D <= 32) against its block
    kernel (_solve_bucket_block) on the same CUDA tensors: D {1, 10, 20,
    32} x storage {f32, bf16, int8} x compute {f32, bf16} x explicit /
    implicit x width {8, 2048}, as an unsegmented bucket (the one-launch
    route) and a segmented one (two launches: rows of 1, 2 and 33
    segments), with rows of n = 0 and, implicit at alpha 40, a crafted
    indefinite row. Every row of one segment: x and its written-back
    storage bit for bit equal to the block kernel's. Every row of several
    segments (summed in another order): within atol 1e-5 + rtol 1e-4 *
    max|x| of the plain version and of a float64 solve. Indefinite rows
    NaN in both; empty rows exact zeros in both; the launches counted
    as the route says."""
    from predictionio_tpu_torch.ops import als

    rng = np.random.default_rng(SEED + 19)
    n_other = 4096
    configs = bit_rows = multi_rows = nan_rows = 0
    worst_rel = 0.0
    for D in K1ROUTE_RANKS:
        base_np = (rng.standard_normal((n_other, D)) / np.sqrt(D)).astype(np.float32)
        heavy = int(np.argmax((base_np ** 2).sum(1)))
        base = torch.from_numpy(base_np).to(device)
        for storage in DTYPES:
            other = als.to_storage(base, storage)
            for compute in ("float32", "bfloat16"):
                for implicit in (False, True):
                    gram = als.compute_gram(other, compute) if implicit else None
                    weighted = (compute == "float32") != implicit
                    for K in K1_WIDTHS:
                        alpha = 1.0 if K == 8 else 40.0
                        R = 64 if K == 8 else 8
                        plain = [int(rng.integers(1, K + 1)) for _ in range(R)]
                        plain[1] = 0
                        segmented = list(plain)
                        segmented[0] = int(rng.integers(1, K + 1))  # 1 segment
                        segmented[1] = 32 * K + int(rng.integers(1, K + 1))  # 33
                        segmented[2] = 0
                        segmented[4] = K + int(rng.integers(1, K + 1))  # 2
                        for kind, counts in (("unsegmented", plain), ("segmented", segmented)):
                            col, rat, msk, seg_start = k1_bucket(
                                torch, rng, counts, K, n_other, device)
                            bad = []
                            if implicit:
                                rat = rat * 2  # counts 1..10
                                if alpha == 40.0:
                                    counts = craft_dislikes(col, rat, msk, seg_start, K,
                                                            heavy, counts)
                                    bad = [3]
                            B = col.shape[0]
                            route = als.k1_route(D, R, B)
                            what = (f"D={D} storage={storage} compute={compute} "
                                    f"implicit={implicit} K={K} {kind} route={route}")
                            if route != ("warp" if kind == "unsegmented" else "split"):
                                raise AssertionError(f"unexpected route: {what}")
                            row_ids = torch.from_numpy(
                                rng.permutation(2 * R)[:R].astype(np.int32)).to(device)
                            kw = dict(weighted_reg=weighted, compute_dtype=compute,
                                      implicit=implicit, alpha=alpha, gram=gram)
                            tw = als.to_storage(torch.zeros((2 * R, D), device=device), storage)
                            tb = als.to_storage(torch.zeros((2 * R, D), device=device), storage)
                            before = als.solve_bucket.launches.value
                            xw = als.solve_bucket(other, col, rat, msk, seg_start, K1_REG,
                                                  target=tw, row_ids=row_ids, **kw)
                            launched = als.solve_bucket.launches.value - before
                            xb = als._solve_bucket_block(other, col, rat, msk, seg_start,
                                                         K1_REG, target=tb, row_ids=row_ids,
                                                         **kw)
                            torch.cuda.synchronize()
                            if launched != als.k1_launches(D, R, B):
                                raise AssertionError(f"{launched} launches: {what}")
                            nseg = np.diff(host(seg_start))
                            one = torch.from_numpy(nseg == 1).to(device)
                            if not same_bits(torch, xw[one], xb[one]):
                                raise AssertionError(f"one-segment x not bit-equal to the "
                                                     f"block kernel's: {what}")
                            rows = row_ids[one].long()
                            for g, w in zip(storage_rows(torch, tw, rows),
                                            storage_rows(torch, tb, rows)):
                                if not torch.equal(g, w):
                                    raise AssertionError(f"one-segment write-back not "
                                                         f"bit-equal: {what}")
                            multi = torch.from_numpy(nseg > 1).to(device)
                            if bool(multi.any()):
                                seg_row = als.seg_rows(seg_start, B)
                                xp = als.solve_bucket_reference(
                                    other, col, rat, msk, K1_REG, seg_row, R,
                                    weighted_reg=weighted, compute_dtype=compute,
                                    implicit=implicit, alpha=alpha, gram=gram)
                                x64 = solve_float64(torch, other, col, rat, msk, seg_row, R,
                                                    K1_REG, weighted, compute, implicit,
                                                    alpha, gram)
                                if not per_solve_ok(torch, xw[multi], xp[multi]):
                                    raise AssertionError(f"multi-segment x differs from the "
                                                         f"plain version: {what}")
                                if not per_solve_ok(torch, xw[multi], x64[multi]):
                                    raise AssertionError(f"multi-segment x differs from the "
                                                         f"float64 solve: {what}")
                                worst_rel = max(worst_rel, rowwise_rel(torch, xw[multi],
                                                                       x64[multi]))
                                multi_rows += int(multi.sum())
                            want_nan = torch.zeros(R, dtype=torch.bool, device=device)
                            want_nan[bad] = True
                            for x in (xw, xb):
                                if not torch.equal(torch.isnan(x).any(dim=1), want_nan):
                                    raise AssertionError(f"NaN rows differ: {what}")
                                if not bool(torch.isnan(x[bad]).all()):
                                    raise AssertionError(f"indefinite row not all NaN: {what}")
                            empty = [r for r, n in enumerate(counts) if n == 0]
                            if not (bool((xw[empty] == 0).all()) and bool((xb[empty] == 0).all())):
                                raise AssertionError(f"an empty row did not solve to 0: {what}")
                            bit_rows += int(one.sum())
                            nan_rows += len(bad)
                            configs += 1
    stats["k1route"] = {"configurations": configs, "bit_equal_rows": bit_rows,
                        "multi_segment_rows": multi_rows, "nan_rows": nan_rows,
                        "worst_multi_rel_to_float64": worst_rel}
    log(f"{configs} warp-route-vs-block configurations agree: {bit_rows} one-segment rows "
        f"bit-equal in x and write-back, {multi_rows} multi-segment rows within atol "
        f"{K1_ATOL} + rtol {K1_RTOL} * max|x| of the plain version and of float64 (worst "
        f"per-solve relative to float64 {worst_rel:.3g}), {nan_rows} indefinite rows NaN "
        f"in both")


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
        topk.gather_top_k_batch.kernel_launches.reset()
        for count in topk.gather_top_k_batch.routes.values():
            count.reset()
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
            # concurrency 1, in-process: HTTP round trip, then the same
            # query without HTTP (the query path's share)
            times = []
            for _ in range(60):
                t0 = time.perf_counter()
                post(conn, {"user": "u17", "num": 4})
                times.append(time.perf_counter() - t0)
            http_p50 = statistics.median(times[10:]) * 1e3
            algo, q = server.algorithms[0], rec.Query(user="u17", num=4)
            times = []
            for _ in range(60):
                t0 = time.perf_counter()
                algo.predict(model, q)
                times.append(time.perf_counter() - t0)
            stats.setdefault("serve_p50_ms", {})[name] = {
                "http_p50_ms": http_p50,
                "predict_p50_ms": statistics.median(times[10:]) * 1e3}
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
        stats["http_p50_ms"] = stats["serve_p50_ms"]["f32"]["http_p50_ms"]
        stats["predict_p50_ms"] = stats["serve_p50_ms"]["f32"]["predict_p50_ms"]
        stats["k2_kernel_launches"] = topk.gather_top_k_batch.kernel_launches.value
        stats["k2_routes"] = {r: c.value for r, c in topk.gather_top_k_batch.routes.items()}
    finally:
        for s in servers:
            s.stop()
        st.set_storage(None)
        storage.close()
        shutil.rmtree(basedir, ignore_errors=True)
    if launches_queries <= 0 or stats["launches"] <= 0:
        raise AssertionError("the HTTP queries did not launch the K2 kernel")
    # every serving k (the power of two >= num, num <= 100 here) is on the tile route
    if stats["k2_routes"] != {"tile": stats["launches"], "select": 0}:
        raise AssertionError(f"K2 calls by route {stats['k2_routes']}: expected all "
                             f"{stats['launches']} on the tile route")
    # the kernels the C entries counted as they launched them: two a tile call
    if stats["k2_kernel_launches"] != stats["launches"] * topk.k2_launches(4, I_ROWS, 1):
        raise AssertionError(f"{stats['launches']} K2 calls launched "
                             f"{stats['k2_kernel_launches']} kernels, expected "
                             f"{topk.k2_launches(4, I_ROWS, 1)} a call")
    log(f"K2 calls on the main path: {stats['launches']} "
        f"({launches_queries} during the HTTP queries), all on the tile route: "
        f"{stats['k2_kernel_launches']} kernel launches; "
        f"HTTP p50 {stats['http_p50_ms']:.3f} ms")
    for name, p50 in stats["serve_p50_ms"].items():
        log(json.dumps({"timing": "http /queries.json", "model": name, "num": 4,
                        "concurrency": 1, **p50}))


# -- phase: batched serving through the deploy CLI --------------------------------

BATCH_LEVELS = (1, 8, 64)  # closed-loop client concurrency
BATCH_QUERIES = 1000  # queries per level, each for a distinct user
BATCH_WINDOW_MS = 2.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cli_env(basedir: str, extra: dict | None = None) -> dict:
    """The environment of a ``cli.main`` process on the store under
    ``basedir``, with ``extra`` (``PIO_STORAGE_*`` sources) on top."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("PIO_STORAGE_")}
    env.update(PIO_FS_BASEDIR=basedir, PIO_RUN_DIR=os.path.join(basedir, "run"),
               PYTHONPATH=os.pathsep.join(
                   p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    env.update(extra or {})
    return env


class DeployProcess:
    """``python -m predictionio_tpu_torch.cli.main deploy`` of one
    instance in a process of its own (so the clients here do not share
    its GIL), on 127.0.0.1, ready once ``/readyz`` answers 200. Stopped
    with SIGTERM: the front end drains, then the command exits."""

    def __init__(self, basedir: str, iid: str, device: str, flags: list[str],
                 name: str, env_extra: dict | None = None, wait: bool = True):
        self._spawn(basedir, ["deploy", "--engine-instance-id", iid, "--device", device,
                              *flags], f"deploy-{name}", env_extra, wait)

    def _spawn(self, basedir: str, args: list[str], name: str,
               env_extra: dict | None = None, wait: bool = True) -> None:
        """``cli.main ARGS --ip 127.0.0.1 --port P``, logged to
        ``basedir/NAME.log``; returns once ``/readyz`` answers 200, or at
        once with ``wait=False`` (then :meth:`wait_ready`)."""
        self.name = name
        self.port = free_port()
        self.log_path = os.path.join(basedir, f"{name}.log")
        env = cli_env(basedir, env_extra)
        cmd = [sys.executable, "-m", "predictionio_tpu_torch.cli.main", *args,
               "--ip", "127.0.0.1", "--port", str(self.port)]
        self._log = open(self.log_path, "w")
        self.spawned = time.perf_counter()
        self.proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=self._log,
                                     stderr=subprocess.STDOUT)
        # /readyz polled from the spawn on, so the ready time is the
        # server's whenever the caller asks for it
        self._ready = ThreadPoolExecutor(1).submit(self._poll_ready)
        if wait:
            self.wait_ready()

    def _poll_ready(self) -> float:
        deadline = self.spawned + 180
        while True:
            if self.proc.poll() is not None:
                raise AssertionError(f"{self.name} exited {self.proc.returncode}:\n"
                                     + self.log_tail())
            try:
                if self.get("/readyz")[0] == 200:
                    return time.perf_counter() - self.spawned
            except OSError:
                pass
            if time.perf_counter() > deadline:
                raise AssertionError(f"{self.name} not ready in 180 s:\n" + self.log_tail())
            time.sleep(0.2)

    def wait_ready(self) -> float:
        """Seconds from the spawn until ``/readyz`` answered 200."""
        return self._ready.result()

    def log_tail(self, n: int = 40) -> str:
        self._log.flush()
        with open(self.log_path) as f:
            return "".join(f.readlines()[-n:])

    def request(self, method: str, path: str, body: bytes | None = None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=60)
        try:
            conn.request(method, path, body)
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def get(self, path: str):
        return self.request("GET", path)

    def metrics(self) -> dict:
        from predictionio_tpu_torch.obs.metrics import parse_prometheus

        status, body = self.get("/metrics")
        if status != 200:
            raise AssertionError(f"/metrics answered {status}")
        return parse_prometheus(body)

    def stop(self) -> int:
        """SIGTERM (drain) and wait; the exit code."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self._log.close()
        return self.proc.returncode


def batch_histogram(m: dict) -> dict:
    """{upper bound: batches} of ``pio_batch_size`` from parsed
    /metrics (the cumulative ``le`` buckets, differenced)."""
    cum = sorted(
        (float("inf") if k.split('le="')[1].split('"')[0] == "+Inf"
         else float(k.split('le="')[1].split('"')[0]), v)
        for k, v in m.items() if k.startswith("pio_batch_size_bucket{"))
    out, prev = {}, 0.0
    for le, c in cum:
        out["+Inf" if le == float("inf") else str(int(le))] = int(c - prev)
        prev = c
    return out


def hist_delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v - before.get(k, 0)}


def k2_tile_calls(m: dict) -> int:
    return int(m.get('pio_k2_calls{kernel="gather_top_k_batch",route="tile"}', 0))


def closed_loop(port: int, queries: list, concurrency: int, key=lambda q: q["user"]) -> dict:
    """``concurrency`` closed-loop keep-alive clients, each on its own
    connection, take the next query until none is left. Returns each
    query's raw answer (by ``key``: the user), the latencies and the wall
    time."""
    lock = threading.Lock()
    todo = iter(queries)
    answers, lat, errors = {}, [], []

    def client():
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            while True:
                with lock:
                    q = next(todo, None)
                if q is None:
                    return
                body = json.dumps(q).encode()
                t0 = time.perf_counter()
                conn.request("POST", "/queries.json", body,
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                data = resp.read()
                dt = time.perf_counter() - t0
                with lock:
                    lat.append(dt)
                    answers[key(q)] = data
                    if resp.status != 200:
                        errors.append((q, resp.status, data[:200]))
        except Exception as e:  # reported, then raised by the caller
            with lock:
                errors.append(repr(e))
        finally:
            conn.close()

    threads = [threading.Thread(target=client) for _ in range(concurrency)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise AssertionError(f"{len(errors)} failed queries at concurrency "
                             f"{concurrency}, first {errors[0]}")
    if len(answers) != len(queries):
        raise AssertionError(f"{len(answers)} answers for {len(queries)} queries")
    return {"answers": answers, "lat": lat, "wall_s": wall}


def sweep(server: DeployProcess, levels: dict) -> dict:
    """One closed-loop level per concurrency; per level the latencies,
    throughput, ``pio_batch_size`` histogram and K2 tile-route calls
    (the server's /metrics before and after)."""
    out = {}
    for c, queries in levels.items():
        m0 = server.metrics()
        run = closed_loop(server.port, queries, c)
        m1 = server.metrics()
        lat = sorted(run["lat"])
        out[c] = {
            "answers": run["answers"],
            "p50_ms": lat[len(lat) // 2] * 1e3,
            "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))] * 1e3,
            "qps": len(queries) / run["wall_s"],
            "batch_sizes": hist_delta(batch_histogram(m1), batch_histogram(m0)),
            "k2_tile_calls": k2_tile_calls(m1) - k2_tile_calls(m0),
        }
    return out


def check_device_gauges(m: dict, table_bytes: int) -> dict:
    """/metrics of a server scoring on the card: the allocator gauges
    are live and hold at least the factor tables."""
    sup = m.get('pio_device_memory_stats_supported{device="cuda:0"}')
    in_use = m.get('pio_device_memory_bytes{device="cuda:0",kind="in_use"}', 0.0)
    if sup != 1.0 or in_use < table_bytes:
        raise AssertionError(f"device gauges: supported {sup}, in_use {in_use} "
                             f"< the tables' {table_bytes} bytes")
    return {"supported": sup, "in_use_bytes": int(in_use)}


def check_k2_calls(levels_out: dict, window: float, per_level: int) -> None:
    """K2's tile-route calls in the server process, per level: one per
    batch with the batcher on, one per query with it off."""
    for c, lv in levels_out.items():
        want = sum(lv["batch_sizes"].values()) if window else per_level
        if lv["k2_tile_calls"] != want:
            raise AssertionError(f"window {window} ms, concurrency {c}: "
                                 f"{lv['k2_tile_calls']} K2 tile calls, expected {want}")


def check_cache_k2(k0: int, k1: int, k2: int) -> None:
    """A cache miss calls K2 once; the repeated query (a hit) not at all."""
    if (k1 - k0, k2 - k1) != (1, 0):
        raise AssertionError(f"K2 tile calls {k0} -> {k1} (miss) -> {k2} (hit)")


def check_profile_trace(text: str) -> list:
    """The capture's Chrome trace names both K2 tile-route kernels."""
    names = [n for n in ("tile_topk_kernel", "merge_topk_kernel") if n in text]
    if names != ["tile_topk_kernel", "merge_topk_kernel"]:
        raise AssertionError(f"the profile trace names {names} of the K2 kernels")
    return names


def trace_kernel_time(text: str, seconds: float) -> dict:
    """Device kernels in a ``torch.profiler`` Chrome trace: their count,
    summed duration and share of the capture window (the device's busy
    share), and the summed duration by kernel name."""
    events = [e for e in json.loads(text)["traceEvents"] if e.get("cat") == "kernel"]
    by_name: dict = {}
    for e in events:
        # "void (anonymous namespace)::tile_topk_kernel(TileArgs)" -> the name
        name = e["name"].replace("(anonymous namespace)::", "").split("(")[0]
        name = name.split("<")[0].split("::")[-1].split(" ")[-1]
        by_name[name] = by_name.get(name, 0.0) + float(e["dur"]) / 1e3
    total_ms = sum(by_name.values())
    return {"kernels": len(events), "kernel_ms": total_ms,
            "busy_share": total_ms / (seconds * 1e3), "ms_by_name": by_name}


@phase("batchserve: deploy --batch-window-ms (subprocess), concurrency 1/8/64")
def batch_serve(torch, device, stats, users: int = U_ROWS, items: int = I_ROWS,
                per_level: int = BATCH_QUERIES):
    """The serve phase's f32 model (ML-20M shape, D = 20, random from the
    seed) deployed by ``cli.main deploy`` in a subprocess, with the
    micro-batcher on (``--batch-window-ms 2``) and off (``0``);
    closed-loop keep-alive clients at concurrency 1, 8 and 64, each level
    ``per_level`` queries (num = 4) for distinct users drawn from a seed.
    Every answer of both servers must be byte-identical to the batcher
    server's solo answer for that user (K2 is batch-invariant bit for
    bit), a sample must match K2's plain version on the card, and
    batches of more than one query must form at concurrency 64. Then, on
    a third deploy with ``--query-cache-mb 64``: a repeated query gives
    the same bytes and no K2 call; ``/metrics`` carries live device
    memory gauges holding the tables; ``POST /profile?seconds=1`` during
    traffic (8 clients) writes a trace naming K2's kernels, whose kernel
    events give the device's busy share of the window; ``POST /reload`` onto a
    newer instance bumps the epoch and the next answer is the new
    model's; SIGTERM drains with queries in flight (every answer 200,
    exit 0). The three servers start together and are measured one at a
    time, the others idle (``ready_s``: the start-ups share the host)."""
    from predictionio_tpu_torch.core.workflow import save_instance
    from predictionio_tpu_torch.data import storage as st
    from predictionio_tpu_torch.models import recommendation as rec

    rng = np.random.default_rng(SEED)
    uf = rng.standard_normal((users, 20), dtype=np.float32)
    vf = rng.standard_normal((items, 20), dtype=np.float32)
    user_ids = [f"u{j}" for j in range(users)]
    item_ids = [f"i{j}" for j in range(items)]
    model = rec.model_from_numpy(user_ids, item_ids, uf, vf)
    basedir = tempfile.mkdtemp(prefix="pio_chip_smoke_batch_")
    storage = st.Storage(env={"PIO_FS_BASEDIR": basedir})
    engine = rec.engine()
    ep = engine.params_from_variant({"algorithms": [{"name": "als", "params": {
        "rank": 20}}]})

    def save(m) -> str:
        return save_instance(
            engine, ep, [m], engine_id="chip-smoke-batch", engine_variant="batch",
            engine_factory="predictionio_tpu_torch.models.recommendation.engine",
            storage=storage)

    iid = save(model)
    pick = np.random.default_rng(SEED + 7).permutation(users)
    n = per_level
    levels = {c: [{"user": f"u{int(j)}", "num": 4} for j in pick[i * n:(i + 1) * n]]
              for i, c in enumerate(BATCH_LEVELS)}
    warm = [{"user": f"u{int(j)}", "num": 4}
            for j in pick[len(BATCH_LEVELS) * n:len(BATCH_LEVELS) * n + 256]]
    dev = device.type
    servers = []
    result = {}
    try:
        # the three servers start together and are measured one at a time,
        # the others idle: two windows, then the cache / reload / drain one
        started = {window: DeployProcess(basedir, iid, dev, ["--batch-window-ms", str(window)],
                                         f"w{window:g}", wait=False)
                   for window in (BATCH_WINDOW_MS, 0.0)}
        started["cache"] = DeployProcess(basedir, iid, dev, [
            "--batch-window-ms", str(BATCH_WINDOW_MS), "--query-cache-mb", "64"], "cache",
            wait=False)
        servers += started.values()
        for window in (BATCH_WINDOW_MS, 0.0):
            server = started[window]
            ready_s = server.wait_ready()
            closed_loop(server.port, warm, 8)
            levels_out = sweep(server, levels)
            check_k2_calls(levels_out, window, n)
            if window:
                # each user's solo answer: one query at a time
                solo = dict(levels_out[1]["answers"])
                for c in BATCH_LEVELS[1:]:
                    solo.update(closed_loop(server.port, levels[c], 1)["answers"])
            for c, lv in levels_out.items():
                same = sum(lv["answers"][u] == solo[u] for u in lv["answers"])
                if same != len(lv["answers"]):
                    raise AssertionError(f"window {window} ms, concurrency {c}: "
                                         f"{len(lv['answers']) - same} answers differ "
                                         "from the solo answers")
                lv.pop("answers")
            result[f"window_{window:g}ms"] = {"ready_s": ready_s, **levels_out}
            server.stop()
            log(json.dumps({"batchserve": f"--batch-window-ms {window:g}",
                            "ready_s": ready_s, **{
                                f"c{c}": lv for c, lv in levels_out.items()}}))
        on = result[f"window_{BATCH_WINDOW_MS:g}ms"]
        big = sum(v for k, v in on[64]["batch_sizes"].items() if k != "1")
        if big <= 0:
            raise AssertionError(f"no batch of more than one query at concurrency 64: "
                                 f"{on[64]['batch_sizes']}")
        # a sample of the solo answers against K2's plain version on the card
        sample = levels[64][:64]
        for q, (exp_items, exp_scores) in zip(
                sample, expected_items(torch, model, device, sample)):
            got = json.loads(solo[q["user"]])["itemScores"]
            check_answer([x["item"] for x in got], [x["score"] for x in got],
                         exp_items, exp_scores, model, f"batchserve {q}")

        # cache, metrics, profile, reload and drain on one more deploy
        server = started["cache"]
        server.wait_ready()
        q0 = json.dumps({"user": "u17", "num": 4}).encode()
        k_miss = k2_tile_calls(server.metrics())
        s1, b1 = server.request("POST", "/queries.json", q0)
        k_before = k2_tile_calls(server.metrics())
        s2, b2 = server.request("POST", "/queries.json", q0)
        k_after = k2_tile_calls(server.metrics())
        if (s1, s2) != (200, 200) or b1 != b2:
            raise AssertionError(f"cache: statuses {s1}/{s2}, same bytes {b1 == b2}")
        check_cache_k2(k_miss, k_before, k_after)
        gauges = check_device_gauges(server.metrics(),
                                     int(uf.nbytes + vf.nbytes))

        stop_traffic = threading.Event()
        traffic_errors, traffic_answers = [], []

        def traffic():
            conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
            r = np.random.default_rng(threading.get_ident() % 2**32)
            try:
                while not stop_traffic.is_set():
                    body = json.dumps({"user": f"u{int(r.integers(users))}",
                                       "num": 4}).encode()
                    conn.request("POST", "/queries.json", body)
                    resp = conn.getresponse()
                    resp.read()
                    traffic_answers.append(resp.status)
                    if resp.status != 200:
                        traffic_errors.append(resp.status)
            except Exception as e:
                traffic_errors.append(repr(e))
            finally:
                conn.close()

        clients = [threading.Thread(target=traffic) for _ in range(8)]
        for t in clients:
            t.start()
        trace_dir = os.path.join(basedir, "profile")
        try:
            status, body = server.request(
                "POST", f"/profile?seconds=1&out={trace_dir}", b"")
        finally:
            stop_traffic.set()
            for t in clients:
                t.join()
        if status != 200 or traffic_errors:
            raise AssertionError(f"profile: {status} {body[:300]!r}, traffic errors "
                                 f"{traffic_errors[:3]}")
        with open(os.path.join(trace_dir, "trace.json")) as f:
            text = f.read()
        named = check_profile_trace(text)
        busy = trace_kernel_time(text, json.loads(body)["seconds"])

        rng2 = np.random.default_rng(SEED + 1)
        model2 = rec.model_from_numpy(
            user_ids, item_ids, rng2.standard_normal((users, 20), dtype=np.float32),
            rng2.standard_normal((items, 20), dtype=np.float32))
        iid2 = save(model2)
        epoch0 = json.loads(server.get("/stats.json")[1])["variants"]["batch"]["epoch"]
        status, body = server.request("POST", "/reload", b"")
        doc = json.loads(server.get("/stats.json")[1])
        epoch1 = doc["variants"]["batch"]["epoch"]
        s3, b3 = server.request("POST", "/queries.json", q0)
        if (status, s3) != (200, 200) or epoch1 != epoch0 + 1 \
                or doc["engineInstanceId"] != iid2 or b3 == b1:
            raise AssertionError(f"reload: {status} {body[:200]!r}, epoch {epoch0} -> "
                                 f"{epoch1}, instance {doc['engineInstanceId']}, "
                                 f"answer changed {b3 != b1}")
        [(exp_items, exp_scores)] = expected_items(
            torch, model2, device, [{"user": "u17", "num": 4}])
        got = json.loads(b3)["itemScores"]
        check_answer([x["item"] for x in got], [x["score"] for x in got],
                     exp_items, exp_scores, model2, "after /reload")

        # SIGTERM with queries in flight: every answer 200, a clean exit
        statuses, closes = [], []

        def drain_client():
            conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
            try:
                while True:
                    conn.request("POST", "/queries.json", q0)
                    resp = conn.getresponse()
                    resp.read()
                    statuses.append(resp.status)
                    if (resp.getheader("Connection") or "").lower() == "close":
                        closes.append(1)
                        return
            except (ConnectionError, http.client.HTTPException, OSError):
                return  # the listener closed: a new request was refused
            finally:
                conn.close()

        clients = [threading.Thread(target=drain_client) for _ in range(16)]
        for t in clients:
            t.start()
        time.sleep(0.3)
        rc = server.stop()
        for t in clients:
            t.join(timeout=60)
        bad = [s for s in statuses if s != 200]
        if rc != 0 or bad or not closes:
            raise AssertionError(f"drain: exit {rc}, non-200 {bad[:5]}, "
                                 f"{len(closes)} answers with Connection: close\n"
                                 + server.log_tail())
        result["cache_reload_obs"] = {
            "cache_hit_same_bytes": True, "k2_calls_on_hit": k_after - k_before,
            "device_gauges": gauges, "profile_names": named,
            "profile_window": {"clients": 8, "answers": len(traffic_answers), **busy},
            "reload_epoch": [epoch0, epoch1],
            "drain": {"answers": len(statuses), "connection_close": len(closes),
                      "exit": rc},
        }
        log(json.dumps({"batchserve": "cache, reload, obs, drain",
                        **result["cache_reload_obs"]}))
    except BaseException:
        for s in servers:
            if s.proc.poll() is None:
                log(s.log_tail())
        raise
    finally:
        for s in servers:
            if s.proc.poll() is None:
                s.stop()
        storage.close()
        shutil.rmtree(basedir, ignore_errors=True)
    stats["batchserve"] = result


# -- training: data ------------------------------------------------------------

# bench.py:53-59 SCALES and SEED: users, items, ratings, max user degree,
# max item degree (the real MovieLens datasets' degree maxima)
ML_SCALES = {
    "100k": (943, 1682, 100_000, 737, 583),
    "1m": (6_040, 3_706, 1_000_000, 2_314, 3_428),
    "20m": (138_493, 26_744, 20_000_000, 9_254, 67_310),
}
ML_SEED = 42
TRAIN_REG = 0.05


def make_ml_shaped(scale: str):
    """bench.py:95-122 ``make_ml_shaped``, copied: MovieLens-shaped
    ratings (Pareto popularity tails capped at the real degree maxima,
    half-star-free 1..5 ratings from a rank-8 ground truth plus noise).
    Returns (rows, cols, vals, num_users, num_items)."""
    num_users, num_items, num_ratings, max_u, max_i = ML_SCALES[scale]
    rng = np.random.default_rng(ML_SEED)

    def capped(weights, cap):
        p = weights / weights.sum()
        for _ in range(16):  # cap-and-renormalize to a fixed point
            p = np.minimum(p, cap)
            p /= p.sum()
            if p.max() <= cap * 1.001:
                break
        return p

    user_p = capped(rng.pareto(1.2, num_users) + 1, max_u / num_ratings)
    item_p = capped(rng.pareto(1.1, num_items) + 1, max_i / num_ratings)
    rows = rng.choice(num_users, num_ratings, p=user_p).astype(np.int32)
    cols = rng.choice(num_items, num_ratings, p=item_p).astype(np.int32)
    gt_rank = 8
    U = (rng.normal(size=(num_users, gt_rank)) / np.sqrt(gt_rank)).astype(np.float32)
    V = (rng.normal(size=(num_items, gt_rank)) / np.sqrt(gt_rank)).astype(np.float32)
    vals = np.empty(num_ratings, np.float32)
    chunk = 2_000_000  # bound peak memory of the gather at large scales
    for lo in range(0, num_ratings, chunk):
        hi = min(lo + chunk, num_ratings)
        raw = (U[rows[lo:hi]] * V[cols[lo:hi]]).sum(1)
        raw += 0.3 * rng.standard_normal(hi - lo).astype(np.float32)
        vals[lo:hi] = np.clip(np.round(3.0 + 1.5 * raw), 1, 5)
    return rows, cols, vals, num_users, num_items


def k1_launches_per_iteration(data, rank: int) -> int:
    """K1's kernel launches in one iteration over ``data``'s buckets: one
    per bucket, two for a segmented bucket on the warp route."""
    from predictionio_tpu_torch.ops import als

    return sum(als.k1_launches(rank, len(b.row_ids), b.col_ids.shape[0])
               for b in data.row_buckets + data.col_buckets)


def k1s_launches_per_iteration(data, rank: int) -> int:
    """K1s's kernel launches in one iteration over ``data``'s buckets
    (``als.k1s_launches``: two a bucket up to rank 32, one above)."""
    from predictionio_tpu_torch.ops import als

    return sum(als.k1s_launches(rank, len(b.row_ids), b.col_ids.shape[0])
               for b in data.row_buckets + data.col_buckets)


def plain_iteration(torch, data, params, device):
    """One ALS iteration (explicit or implicit) with K1's plain version on
    the card, from the cold init ``als_train`` draws for ``params.seed``."""
    from predictionio_tpu_torch.ops import als

    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(params.seed))
    U = als.to_storage(als.init_factors(data.num_rows, params.rank, gen, device),
                       params.storage_dtype)
    V = als.to_storage(als.init_factors(data.num_cols, params.rank, gen, device),
                       params.storage_dtype)
    weighted = params.implicit_weighted_reg if params.implicit else params.weighted_reg
    for target, other, buckets in ((U, V, data.row_buckets), (V, U, data.col_buckets)):
        gram = als.compute_gram(other, params.compute_dtype) if params.implicit else None
        for b in als.device_buckets(buckets, device):
            x = als.solve_bucket_reference(
                other, b.col_ids, b.ratings, b.mask, params.reg,
                als.seg_rows(b.seg_start, b.col_ids.shape[0]), b.row_ids.shape[0],
                weighted, params.compute_dtype, params.gather_chunk_bytes,
                params.implicit, params.alpha, gram)
            als._scatter_rows(target, b.row_ids, x)
    return U, V


@contextlib.contextmanager
def storage_env(basedir: str, extra: dict | None = None):
    """The PIO_* environment of a store under ``basedir`` (with ``extra``
    sources), as the CLI reads it, restored afterwards."""
    from predictionio_tpu_torch.data import storage as st

    saved = {k: v for k, v in os.environ.items()
             if k.startswith("PIO_STORAGE_") or k in ("PIO_FS_BASEDIR",)}
    for k in saved:
        del os.environ[k]
    os.environ["PIO_FS_BASEDIR"] = basedir
    os.environ.update(extra or {})
    st.set_storage(None)
    try:
        yield
    finally:
        st.get_storage().close()
        st.set_storage(None)
        for k in [k for k in os.environ if k.startswith("PIO_STORAGE_")]:
            del os.environ[k]
        os.environ.pop("PIO_FS_BASEDIR", None)
        os.environ.update(saved)


# -- phase: the training lifecycle through the CLI ------------------------------


@phase("lifecycle: events -> train -> deploy (ML-100K shape, CLI)")
def lifecycle(torch, device, stats):
    """ML-100K-shaped ratings as ``rate`` events in the port's sqlite
    store, ``cli.main train`` then ``deploy`` on the card, POSTed
    queries. The trained model's train RMSE must be within 1e-3
    relative of the same training run on the CPU with K1's plain
    version (the same init and data; float32 sums in another order over
    10 iterations), and both launch counters must move. Then ``cli.main
    eval`` of the shipped recommendation sweep on the same app (eval_cli)."""
    from predictionio_tpu_torch.cli import main as cli
    from predictionio_tpu_torch.data import store
    from predictionio_tpu_torch.data import storage as st
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.ops import als, topk

    rows, cols, vals, _, _ = make_ml_shaped("100k")
    basedir = tempfile.mkdtemp(prefix="pio_chip_smoke_ml100k_")
    variant_path = os.path.join(basedir, "engine.json")
    params = {"rank": 10, "numIterations": 10, "lambda": TRAIN_REG, "seed": 3}
    with open(variant_path, "w") as f:
        json.dump({"id": "chip-smoke-ml100k",
                   "engineFactory": "predictionio_tpu_torch.models.recommendation.engine",
                   "datasource": {"params": {"appName": "ML100K"}},
                   "algorithms": [{"name": "als", "params": params}]}, f)
    server = None
    try:
        with storage_env(basedir):
            storage = st.get_storage()
            app_id = storage.get_metadata_apps().insert(st.App(0, "ML100K"))
            t0 = time.perf_counter()
            storage.get_events().batch_insert([
                Event(event="rate", entity_type="user", entity_id=f"u{r}",
                      target_entity_type="item", target_entity_id=f"i{c}",
                      properties={"rating": float(v)})
                for r, c, v in zip(rows.tolist(), cols.tolist(), vals.tolist())
            ], app_id)
            log(f"wrote {len(vals)} rate events in {time.perf_counter() - t0:.1f}s")
            als.solve_bucket.launches.reset()
            topk.gather_top_k_batch.launches.reset()
            t0 = time.perf_counter()
            if cli.main(["train", "--variant", variant_path]) != 0:
                raise AssertionError("cli train failed")
            train_s = time.perf_counter() - t0
            k1 = als.solve_bucket.launches.value
            server = cli.deploy_server(cli.build_parser().parse_args([
                "deploy", "--variant", variant_path, "--ip", "127.0.0.1",
                "--port", "0"]))
            server.warmup()
            port = server.start(background=True)
            model = server.models[0]
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            queries = [{"user": "u0", "num": 4}, {"user": "u17", "num": 10},
                       {"user": "u942", "num": 1}, {"user": "nobody", "num": 4}]
            for q, (exp_items, exp_scores) in zip(
                    queries, expected_items(torch, model, device, queries)):
                got = post(conn, q)["itemScores"]
                check_answer([x["item"] for x in got], [x["score"] for x in got],
                             exp_items, exp_scores, model, f"ml100k {q}")
                log(f"ml100k {json.dumps(q)} -> {json.dumps(got[:4])}")
            conn.close()
            k2 = topk.gather_top_k_batch.launches.value
            batch = store.find_ratings(
                "ML100K", event_names=["rate", "buy"], entity_type="user",
                target_entity_type="item", override_ratings={"buy": 4.0})
            t0 = time.perf_counter()
            summary = eval_cli(cli, storage, "ML100K")
            eval_s = time.perf_counter() - t0
        if k1 <= 0 or k2 <= 0:
            raise AssertionError(f"launch counters did not move: K1 {k1}, K2 {k2}")
        U, V = model.device_factors(device)
        e_gpu = als.rmse(U, V, batch.rows, batch.cols, batch.vals)
        data = als.build_ratings_data(batch.rows, batch.cols, batch.vals,
                                      len(batch.entity_ids), len(batch.target_ids))
        Uc, Vc = als.als_train(data, als.ALSParams(rank=10, iterations=10, reg=TRAIN_REG,
                                                   seed=3), device="cpu")
        e_cpu = als.rmse(Uc, Vc, batch.rows, batch.cols, batch.vals)
        if not (np.isfinite(e_gpu) and abs(e_gpu - e_cpu) <= 1e-3 * e_cpu):
            raise AssertionError(f"train RMSE {e_gpu} on the card vs {e_cpu} on the CPU")
    finally:
        if server is not None:
            server.stop()
        shutil.rmtree(basedir, ignore_errors=True)
    stats["lifecycle"] = {"train_s": train_s, "rmse": e_gpu, "rmse_cpu": e_cpu,
                          "k1_launches": k1, "k2_launches": k2, "cli_eval_s": eval_s,
                          "cli_eval_scores": summary["scores"],
                          "cli_eval_best_index": summary["best_index"]}
    log(json.dumps({"lifecycle": "ml100k", **stats["lifecycle"]}))


# -- phase: the quickstart's ingest front ---------------------------------------

INGEST_SINGLE = 1_000  # POST /events.json, one event a request
INGEST_BATCHES = 100  # POST /batch/events.json of INGEST_BATCH events
INGEST_BATCH = 50
INGEST_HTTP = 20_000  # events through import --http (/batch/events.bin)
#: the ML-1M file's first events go into sqlite: a Python row an event,
#: the whole file (with the filelog phase's imports beside it) outlasts
#: the build and the first checks by up to 90 s
INGEST_SQLITE = 500_000
INGEST_RANK = 20
INGEST_ITERATIONS = 10
INGEST_TIME = "2020-01-01T00:00:00.000Z"


def rate_lines(rows, cols, vals) -> str:
    """``rate`` events as JSON lines, the import file format."""
    return "".join(
        '{"event":"rate","entityType":"user","entityId":"u%d","targetEntityType":'
        '"item","targetEntityId":"i%d","properties":{"rating":%.1f},'
        '"eventTime":"%s"}\n' % (r, c, v, INGEST_TIME)
        for r, c, v in zip(rows.tolist(), cols.tolist(), vals.tolist()))


def cli_run(basedir: str, *args, timeout: float = 900,
            env: dict | None = None) -> tuple[str, float]:
    """``python -m predictionio_tpu_torch.cli.main ARGS`` in a process of
    its own (``env``: extra storage sources): (stdout, wall seconds,
    interpreter start included)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch.cli.main", *args],
        cwd=ROOT, env=cli_env(basedir, env), capture_output=True, text=True,
        timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"cli {' '.join(args)} exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout, wall


#: phases that may run while IngestPrep imports: checks against the plain
#: versions, whose times (where they print any) are device times
BESIDE_PREP = EARLY_STEPS + ("k4", "k5", "times", "retimes")


class IngestPrep(threading.Thread):
    """The ingest phase's host-only start, run beside the kernels' build
    and the checks of BESIDE_PREP (it touches no device; the first other
    phase waits for it): the ML-1M-shaped ratings as a JSON-lines
    file (kept for the filelog phase), then ``cli.main`` processes on a
    fresh sqlite store -- ``app new ML1M`` (the access key from stdout),
    ``import`` of the file's first INGEST_SQLITE events with ``version``
    and ``status`` (which event codec runs) beside it, then ``export``
    with the imported ratings read back by ``find_ratings`` beside it."""

    def __init__(self):
        super().__init__(name="ingest-prep", daemon=True)
        self.basedir = tempfile.mkdtemp(prefix="pio_chip_smoke_ingest_")
        # the ML-1M file, kept for the filelog phase; main() removes it
        self.datadir = tempfile.mkdtemp(prefix="pio_chip_smoke_ml1m_")
        self.data_path = os.path.join(self.datadir, "ml1m.jsonl")
        self.file_written = threading.Event()  # set once data_path is whole
        self.out: dict = {}
        self.error: str | None = None
        self.started = self.done = 0.0

    def run(self):
        self.started = time.perf_counter()
        try:
            self.out = self.prep()
        except Exception:
            self.error = traceback.format_exc()
        self.file_written.set()  # also on failure: no waiter hangs
        self.done = time.perf_counter()

    def prep(self) -> dict:
        from predictionio_tpu_torch.data import store
        from predictionio_tpu_torch.data.storage import Storage

        rows, cols, vals, nu, ni = make_ml_shaped("1m")
        path = self.data_path
        t0 = time.perf_counter()
        with open(path, "w") as f:
            for lo in range(0, len(vals), 100_000):
                f.write(rate_lines(rows[lo:lo + 100_000], cols[lo:lo + 100_000],
                                   vals[lo:lo + 100_000]))
        write_s = time.perf_counter() - t0
        self.out = {"rows": rows, "cols": cols, "vals": vals, "num_users": nu,
                    "num_items": ni}
        self.file_written.set()
        n = min(INGEST_SQLITE, len(vals))
        rows, cols, vals = rows[:n], cols[:n], vals[:n]
        path = os.path.join(self.basedir, "ml1m_head.jsonl")
        with open(self.data_path) as src, open(path, "w") as dst:
            dst.writelines(line for _, line in zip(range(n), src))
        out, _ = cli_run(self.basedir, "app", "new", "ML1M")
        key = next(ln.split(":", 1)[1].strip() for ln in out.splitlines()
                   if ln.startswith("Access Key:"))
        # version and status run beside the import, off its path
        with ThreadPoolExecutor(2) as side:
            version = side.submit(cli_run, self.basedir, "version")
            status = side.submit(cli_run, self.basedir, "status")
            out, import_s = cli_run(self.basedir, "import", "--appid-or-name", "ML1M",
                                    "--input", path)
            if f"Imported {len(vals)} events." not in out:
                raise AssertionError(f"import printed {out!r}")
            version, status = version.result()[0], status.result()[0]
        codec = json.loads(status[:status.rindex("}") + 1])["event_codec"]
        export = os.path.join(self.basedir, "export.jsonl")
        # beside the export: the imported ratings read back through
        # find_ratings (as training reads them), equal to the generated
        # ones as multisets
        with ThreadPoolExecutor(1) as side:
            exporting = side.submit(cli_run, self.basedir, "export", "--appid-or-name",
                                    "ML1M", "--output", export)
            storage = Storage(env=cli_env(self.basedir))
            try:
                batch = store.find_ratings("ML1M", event_names=["rate"], storage=storage)
            finally:
                storage.close()
            users = np.asarray([int(u[1:]) for u in batch.entity_ids])[batch.rows]
            items = np.asarray([int(i[1:]) for i in batch.target_ids])[batch.cols]
            imported_equal = np.array_equal(ingest_triples(users, items, batch.vals),
                                            ingest_triples(rows, cols, vals))
            out, export_s = exporting.result()
        with open(export, "rb") as f:
            exported = sum(1 for _ in f)
        os.unlink(export)
        os.unlink(path)
        return {**self.out, "imported": n, "key": key, "codec": codec,
                "version": version.strip(), "write_s": write_s, "import_s": import_s,
                "export_s": export_s, "exported": exported,
                "export_printed": out.strip(), "imported_equal": imported_equal}


def ingest_triples(users, items, vals):
    """Rows of (user, item, rating) in one canonical order: a multiset."""
    order = np.lexsort((vals, items, users))
    return np.stack([users[order].astype(np.float64), items[order].astype(np.float64),
                     vals[order].astype(np.float64)])


class EventServerProcess(DeployProcess):
    """``cli.main eventserver --stats`` on the store under ``basedir``, in
    a process of its own, ready once ``/readyz`` answers 200."""

    def __init__(self, basedir: str, env_extra: dict | None = None):
        self._spawn(basedir, ["eventserver", "--stats"], "eventserver", env_extra)


def http_json(conn, method: str, path: str, body=None, ctype="application/json"):
    """(status, parsed body) of one request on a keep-alive connection."""
    data = body if isinstance(body, (bytes, type(None))) else json.dumps(body).encode()
    conn.request(method, path, data, {"Content-Type": ctype} if data else {})
    resp = conn.getresponse()
    raw = resp.read()
    return resp.status, json.loads(raw) if raw else None


def event_server_drive(es, key: str, rng, nu: int, ni: int) -> dict:
    """The event server's routes under load, on one keep-alive
    connection: single events, batches, webhooks, reads and a delete;
    ``import --http`` (binary frames) in this process. Returns the
    throughputs and the counts /stats.json must show."""
    from urllib.parse import urlencode

    from predictionio_tpu_torch.cli import main as cli

    conn = http.client.HTTPConnection("127.0.0.1", es.port, timeout=60)
    q = f"accessKey={key}"

    def events(n):
        r = rng.integers(0, nu, n)
        c = rng.integers(0, ni, n)
        v = rng.integers(1, 6, n)
        return [{"event": "rate", "entityType": "user", "entityId": f"u{a}",
                 "targetEntityType": "item", "targetEntityId": f"i{b}",
                 "properties": {"rating": float(x)}, "eventTime": INGEST_TIME}
                for a, b, x in zip(r.tolist(), c.tolist(), v.tolist())]

    out = {}
    singles = events(INGEST_SINGLE)
    lat, ids = [], []
    t0 = time.perf_counter()
    for e in singles:
        t1 = time.perf_counter()
        status, body = http_json(conn, "POST", f"/events.json?{q}", e)
        lat.append(time.perf_counter() - t1)
        if status != 201:
            raise AssertionError(f"POST /events.json answered {status}: {body}")
        ids.append(body["eventId"])
    wall = time.perf_counter() - t0
    out["events_json"] = {"events": len(singles), "wall_s": wall,
                          "events_per_s": len(singles) / wall,
                          "p50_ms": 1e3 * statistics.median(lat),
                          "p99_ms": 1e3 * float(np.quantile(lat, 0.99))}
    batches = [events(INGEST_BATCH) for _ in range(INGEST_BATCHES)]
    t0 = time.perf_counter()
    for b in batches:
        status, body = http_json(conn, "POST", f"/batch/events.json?{q}", b)
        if status != 200 or [r["status"] for r in body] != [201] * len(b):
            raise AssertionError(f"POST /batch/events.json answered {status}: {body}")
    wall = time.perf_counter() - t0
    n = INGEST_BATCHES * INGEST_BATCH
    out["batch_json"] = {"events": n, "requests": INGEST_BATCHES, "wall_s": wall,
                         "events_per_s": n / wall}
    framed = events(INGEST_HTTP)
    path = os.path.join(tempfile.mkdtemp(prefix="pio_chip_smoke_bin_"), "http.jsonl")
    with open(path, "w") as f:
        f.writelines(json.dumps(e) + "\n" for e in framed)
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        rc = cli.main(["import", "--appid-or-name", "ML1M", "--input", path,
                       "--http", f"http://127.0.0.1:{es.port}", "--access-key", key])
    wall = time.perf_counter() - t0
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    if rc != 0 or f"Imported {INGEST_HTTP} events." not in printed.getvalue():
        raise AssertionError(f"import --http: rc {rc}, printed {printed.getvalue()!r}")
    out["batch_bin"] = {"events": INGEST_HTTP, "wall_s": wall,
                        "events_per_s": INGEST_HTTP / wall}
    seg = {"version": "2", "type": "track", "userId": "sio-user", "event": "Signed Up",
           "properties": {"plan": "Pro"}, "timestamp": "2020-01-02T03:04:05.000Z"}
    status, body = http_json(conn, "POST", f"/webhooks/segmentio.json?{q}", seg)
    if status != 201:
        raise AssertionError(f"segmentio webhook answered {status}: {body}")
    form = urlencode({"type": "subscribe", "fired_at": "2009-03-26 21:35:57",
                      "data[id]": "mc-user", "data[list_id]": "a6b5da1054",
                      "data[email]": "api@mailchimp.com"}).encode()
    status, body = http_json(conn, "POST", f"/webhooks/mailchimp.form?{q}", form,
                             "application/x-www-form-urlencoded")
    if status != 201:
        raise AssertionError(f"mailchimp webhook answered {status}: {body}")
    for user, name in (("sio-user", "track"), ("mc-user", "subscribe")):
        status, body = http_json(conn, "GET", f"/events.json?{q}&entityId={user}")
        if status != 200 or [e["event"] for e in body] != [name]:
            raise AssertionError(f"GET /events.json for {user}: {status} {body}")
    status, body = http_json(conn, "GET", f"/events.json?{q}&limit=5")
    if status != 200 or len(body) != 5:
        raise AssertionError(f"GET /events.json?limit=5: {status} {body}")
    status, body = http_json(conn, "GET", f"/events/{ids[0]}.json?{q}")
    if status != 200 or body["entityId"] != singles[0]["entityId"]:
        raise AssertionError(f"GET /events/{ids[0]}.json: {status} {body}")
    status, body = http_json(conn, "DELETE", f"/events/{ids[0]}.json?{q}")
    if status != 200:
        raise AssertionError(f"DELETE /events/{ids[0]}.json: {status} {body}")
    status, _ = http_json(conn, "GET", f"/events/{ids[0]}.json?{q}")
    if status != 404:
        raise AssertionError(f"a deleted event answered {status}")
    status, st = http_json(conn, "GET", f"/stats.json?{q}")
    conn.close()
    rates = INGEST_SINGLE + n + INGEST_HTTP
    counts = st["eventCount"]
    if (counts.get("rate"), counts.get("track"), counts.get("subscribe")) != (rates, 1, 1):
        raise AssertionError(f"/stats.json eventCount {counts}, expected rate {rates}")
    if st["statusCount"].get("201") != rates + 2:
        raise AssertionError(f"/stats.json statusCount {st['statusCount']}")
    if st["ingest"]["frames_total"] < INGEST_HTTP // 2000:
        raise AssertionError(f"/stats.json ingest {st['ingest']}")
    # the event server is host code: CUDA was never initialised in it
    if any(d["memory"] is not None for d in st["device"]["devices"]):
        raise AssertionError(f"the event server initialised CUDA: {st['device']}")
    out["stats"] = {"eventCount": counts, "frames_total": st["ingest"]["frames_total"]}
    out["stored_rates"] = rates - 1  # one deleted
    # the users of the stored ratings (the deleted one, singles[0], aside)
    out["users"] = {int(e["entityId"][1:]) for e in singles[1:] + framed
                    + [e for b in batches for e in b]}
    return out


@phase("ingest: app new -> import -> export -> eventserver -> train -> deploy -> "
       "undeploy (ML-1M shape, CLI, sqlite)")
def ingest(torch, device, stats, prep: IngestPrep):
    """The quickstart through the port's CLI on a sqlite store: ``app
    new``, ``import`` and ``export`` of the first INGEST_SQLITE
    ML-1M-shaped ratings (run beside the build by IngestPrep; the native
    codec must have loaded;
    the imported ratings, read back by ``find_ratings``, equal to the
    generated ones as multisets);
    then ``eventserver --stats`` in a process of its own, driven by
    single events, batches, ``import --http``, two webhooks, reads and a
    delete, its /stats.json counts checked; then ``train`` (rank 20, 10
    iterations) and ``deploy`` in this process with K1's and K2's counts
    reset before and read after, queries against K2's plain version, and
    ``undeploy``, which must stop the server. The model must hold every
    user with a stored rating."""
    from predictionio_tpu_torch import native
    from predictionio_tpu_torch.cli import main as cli
    from predictionio_tpu_torch.data import store
    from predictionio_tpu_torch.ops import als, topk

    prep.join(timeout=900)
    if prep.is_alive():
        raise AssertionError("the ingest preparation did not finish")
    if prep.error:
        raise AssertionError(f"ingest preparation failed:\n{prep.error}")
    p = prep.out
    basedir = prep.basedir
    lib = native.library_path()
    if p["codec"]["path"] != "native" or lib is None:
        raise AssertionError(f"the native event codec did not load: status said "
                             f"{p['codec']}, this process {lib}")
    if not str(lib).startswith(os.path.join(ROOT, "predictionio_tpu_torch", "_build")):
        raise AssertionError(f"the native codec loaded from {lib}")
    n = p["imported"]
    if not p["imported_equal"]:
        raise AssertionError("the imported ratings differ from the generated ones")
    if p["exported"] != n or p["export_printed"] != (
            f"Exported {n} events to {os.path.join(basedir, 'export.jsonl')}."):
        raise AssertionError(f"export wrote {p['exported']} lines, printed "
                             f"{p['export_printed']!r}; expected {n}")
    variant_path = os.path.join(basedir, "engine.json")
    with open(variant_path, "w") as f:
        json.dump({"id": "chip-smoke-ml1m", "engineFactory": REC_FACTORY,
                   "datasource": {"params": {"appName": "ML1M"}},
                   "algorithms": [{"name": "als", "params": {
                       "rank": INGEST_RANK, "numIterations": INGEST_ITERATIONS,
                       "lambda": TRAIN_REG, "seed": 3}}]}, f)
    server = es = None
    try:
        es = EventServerProcess(basedir)
        drive = event_server_drive(es, p["key"], np.random.default_rng(ML_SEED + 1),
                                   p["num_users"], p["num_items"])
        if es.stop() != 0:
            raise AssertionError("eventserver did not exit 0 on SIGTERM:\n" + es.log_tail())
        es = None
        with storage_env(basedir):
            als.solve_bucket.launches.reset()  # the main path starts here
            topk.gather_top_k_batch.launches.reset()
            topk.gather_top_k_batch.kernel_launches.reset()
            t0 = time.perf_counter()
            if cli.main(["train", "--variant", variant_path]) != 0:
                raise AssertionError("cli train failed")
            train_s = time.perf_counter() - t0
            k1 = als.solve_bucket.launches.value
            server = cli.deploy_server(cli.build_parser().parse_args([
                "deploy", "--variant", variant_path, "--ip", "127.0.0.1",
                "--port", "0"]))
            server.warmup()
            port = server.start(background=True)
            model = server.models[0]
            users = set(p["rows"][:n].tolist()) | drive["users"]
            if len(model.user_index) != len(users):
                raise AssertionError(f"{len(model.user_index)} users trained, "
                                     f"{len(users)} rated")
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            queries = [{"user": "u0", "num": 4}, {"user": "u17", "num": 10},
                       {"user": "u6039", "num": 1}, {"user": "nobody", "num": 4}]
            for q, (exp_items, exp_scores) in zip(
                    queries, expected_items(torch, model, device, queries)):
                got = post(conn, q)["itemScores"]
                check_answer([x["item"] for x in got], [x["score"] for x in got],
                             exp_items, exp_scores, model, f"ml1m {q}")
            conn.close()
            k2 = topk.gather_top_k_batch.launches.value  # read just after
            k2_kernels = topk.gather_top_k_batch.kernel_launches.value
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                rc = cli.main(["undeploy", "--ip", "127.0.0.1", "--port", str(port)])
            if rc != 0 or printed.getvalue().strip() != "Undeployed.":
                raise AssertionError(f"undeploy: rc {rc}, printed {printed.getvalue()!r}")
            deadline = time.perf_counter() + 10
            while True:
                try:
                    socket.create_connection(("127.0.0.1", port), timeout=1).close()
                except OSError:
                    break  # the port is closed: the server stopped
                if time.perf_counter() > deadline:
                    raise AssertionError("the server still answers after undeploy")
                time.sleep(0.1)
        if k1 <= 0 or k2 <= 0:
            raise AssertionError(f"launch counters did not move: K1 {k1}, K2 {k2}")
    finally:
        if es is not None:
            es.stop()
        if server is not None:
            server.stop()
        shutil.rmtree(basedir, ignore_errors=True)
    stats["ingest"] = {
        "card": stats.get("smi"), "codec": p["codec"], "version": p["version"],
        "prep_s": prep.done - prep.started,
        "prep_done_after_build_s": prep.done - stats.get("build_done", prep.done),
        "events": n, "write_file_s": p["write_s"],
        "import_s": p["import_s"], "import_events_per_s": n / p["import_s"],
        "export_s": p["export_s"], "export_events_per_s": n / p["export_s"],
        "events_json": drive["events_json"], "batch_json": drive["batch_json"],
        "batch_bin": drive["batch_bin"], "stats": drive["stats"],
        "train_s": train_s, "trained_ratings": n + drive["stored_rates"],
        "k1_launches": k1, "k2_launches": k2, "k2_kernel_launches": k2_kernels,
    }
    log(json.dumps({"ingest": "ml1m sqlite", **stats["ingest"]}))


# -- phase: the file-log stores -------------------------------------------------------

FILELOG_PARTITIONS = 8  # the partitioned store's default
FILELOG_SEGMENT = 4 << 20  # so that every partition seals segments at import
FILELOG_SPLICE_LINES = 10_000  # the in-process splice-route check
FILELOG_SETS = 100  # $set lines among the new events: the object parser's
FILELOG_RETRAIN_ITERATIONS = 2
#: the partitioned store holds the file's first FILELOG_PARTITIONED
#: events: a fold there replays its whole history (no entity index), so
#: the store's size sets the fold's seconds; the jsonl store holds all
FILELOG_PARTITIONED = 500_000


def filelog_env(basedir: str, kind: str) -> dict:
    """``PIO_STORAGE_*`` of a store under ``basedir`` whose events live in
    a ``kind`` (jsonl or partitioned) source, apps in sqlite and models in
    localfs (the repositories bind to them by capability)."""
    env = {"PIO_STORAGE_SOURCES_DB_TYPE": "sqlite",
           "PIO_STORAGE_SOURCES_DB_PATH": os.path.join(basedir, "pio.db"),
           "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
           "PIO_STORAGE_SOURCES_FS_PATH": os.path.join(basedir, "models"),
           "PIO_STORAGE_SOURCES_LOG_TYPE": kind,
           "PIO_STORAGE_SOURCES_LOG_PATH": os.path.join(basedir, kind)}
    if kind == "partitioned":
        env["PIO_STORAGE_SOURCES_LOG_PARTITIONS"] = str(FILELOG_PARTITIONS)
        env["PIO_STORAGE_SOURCES_LOG_SEGMENT_BYTES"] = str(FILELOG_SEGMENT)
    return env


def ratings_equal(user_ids, item_ids, r, c, v, rows, cols, vals) -> bool:
    """Dense-indexed ratings of ``u<n>`` / ``i<n>`` ids against the
    generated triples, as multisets."""
    users = np.asarray([int(u[1:]) for u in user_ids])[r]
    items = np.asarray([int(i[1:]) for i in item_ids])[c]
    return np.array_equal(ingest_triples(users, items, v),
                          ingest_triples(rows, cols, vals))


def sealed_segments(basedir: str) -> dict:
    """Sealed ``seg_*.jsonl`` files per partition directory under
    ``basedir``."""
    out: dict = {}
    for d, _, files in os.walk(basedir):
        if re.fullmatch(r"p[0-9a-f]{2}", os.path.basename(d)):
            out[d] = sum(1 for f in files if f.startswith("seg_") and f.endswith(".jsonl"))
    return out


def splice_route_check(kind: str, path: str) -> dict:
    """``cli/commands.py import_events`` of the file's first
    FILELOG_SPLICE_LINES lines into a fresh ``kind`` store, in this
    process: the store's ``append_jsonl`` takes every line, and
    ``insert`` / ``batch_insert`` are never called."""
    from predictionio_tpu_torch.cli import commands
    from predictionio_tpu_torch.data.storage import App, Storage

    basedir = tempfile.mkdtemp(prefix="pio_chip_smoke_splice_")
    small = os.path.join(basedir, "head.jsonl")
    with open(path) as src, open(small, "w") as dst:
        for _, line in zip(range(FILELOG_SPLICE_LINES), src):
            dst.write(line)
    storage = Storage(env=filelog_env(basedir, kind))
    cls = type(storage.get_events())
    splice = cls.append_jsonl
    calls = {"append_jsonl": 0, "lines": 0}

    def counted(self, blob, *a, **kw):
        calls["append_jsonl"] += 1
        calls["lines"] += blob.count(b"\n")
        return splice(self, blob, *a, **kw)

    def refused(self, *a, **kw):
        raise AssertionError(f"{kind}: import took the Event path")

    saved = {name: cls.__dict__[name] for name in ("append_jsonl", "insert", "batch_insert")}
    try:
        storage.get_metadata_apps().insert(App(0, "Head"))
        cls.append_jsonl, cls.insert, cls.batch_insert = counted, refused, refused
        n = commands.import_events("Head", small, storage=storage)
    finally:
        for name, fn in saved.items():
            setattr(cls, name, fn)
        storage.close()
        shutil.rmtree(basedir, ignore_errors=True)
    if n != FILELOG_SPLICE_LINES or calls["lines"] != n or not calls["append_jsonl"]:
        raise AssertionError(f"{kind}: splice check {n} imported, {calls}")
    return calls


def filelog_new_events(rng, nu: int, ni: int, known: list) -> list:
    """The fold's events as event-server dicts: RT_NEW_USERS new users x
    RT_NEW_RATINGS ratings, 5 for each of ``known``, 2 x RT_COLD of
    unseen items, and FILELOG_SETS ``$set`` lines (the object parser's)."""
    out = []

    def rate(u, i, v):
        out.append({"event": "rate", "entityType": "user", "entityId": u,
                    "targetEntityType": "item", "targetEntityId": i,
                    "properties": {"rating": float(v)}})

    for j in range(RT_NEW_USERS):
        for i in rng.choice(ni, size=RT_NEW_RATINGS, replace=False):
            rate(f"new{j}", f"i{int(i)}", rng.integers(1, 6))
    for u in known:
        for i in rng.choice(ni, size=5, replace=False):
            rate(f"u{u}", f"i{int(i)}", rng.integers(1, 6))
    for c in range(RT_COLD):
        rate(f"new{c}", f"cold{c}", 5)
        rate(f"u{known[c]}", f"cold{c}", 4)
    for j in range(FILELOG_SETS):
        out.append({"event": "$set", "entityType": "item", "entityId": f"i{j}",
                    "properties": {"genre": f"g{j % 7}", "year": 1990 + j % 30}})
    return out


def post_frames(es, key: str, events: list) -> None:
    """``events`` as PIF1 frames on the event server's
    ``/batch/events.bin`` (the splice route on a file-log store)."""
    from predictionio_tpu_torch.data.storage import frame

    status, raw = es.request("POST", f"/batch/events.bin?accessKey={key}",
                             frame.encode_body(events))
    if status != 200 or json.loads(raw)["accepted"] != len(events):
        raise AssertionError(f"/batch/events.bin answered {status}: {raw[:300]!r}")


class FindOnce:
    """An Events DAO whose ``find`` answers each distinct call once: the
    phase's in-process folds re-read the same unchanged store, and a
    partitioned store replays every partition for each read."""

    def __init__(self, events):
        self._events = events
        self._found: dict = {}

    def __getattr__(self, name):
        return getattr(self._events, name)

    def find(self, *args, **kwargs):
        key = repr((args, sorted(kwargs.items())))
        if key not in self._found:
            self._found[key] = self._events.find(*args, **kwargs)
        return list(self._found[key])


def columnar_vs_object(torch, device, events, app_id: int, model, t_col, t_obj) -> dict:
    """The tailed batch two ways, on the card: ``fold_in_columnar`` on the
    columnar tailer's poll and ``fold`` on the object tailer's Event
    objects of the same lines give bit-identical patched user tables (and
    int8 scales), for f32 and int8 storage. Returns (the summary, the
    Event objects)."""
    from predictionio_tpu_torch.models import recommendation as rec
    from predictionio_tpu_torch.ops import als
    from predictionio_tpu_torch.realtime import ALSFoldIn, FoldInConfig

    batch = t_col.poll_columnar(limit=10**6)
    objs = t_obj.poll(limit=10**6)
    arrays = sum(s.n_rows for s in batch.segments if not isinstance(s, list))
    if not arrays or batch.n_events != len(objs):
        raise AssertionError(f"columnar poll: {arrays} array rows of {batch.n_events}, "
                             f"object poll {len(objs)} events")
    uids = list(model.user_index.keys())  # dense: index = position
    iids = list(model.item_index.keys())
    q_u, s_u = als.quantize_rows(torch.from_numpy(np.array(model.user_factors)))
    q_v, s_v = als.quantize_rows(torch.from_numpy(np.array(model.item_factors)))
    forms = {"float32": model, "int8": rec.model_from_numpy(
        uids, iids, q_u.numpy(), q_v.numpy(), s_u.numpy(), s_v.numpy())}
    cfg = FoldInConfig(override_ratings={"buy": 4.0}, reg=TRAIN_REG)
    out = {"array_rows": arrays, "events": len(objs)}
    for name, m in forms.items():
        a, sa = ALSFoldIn(events, app_id, config=cfg, device=device).fold_in_columnar(m, batch)
        b, sb = ALSFoldIn(events, app_id, config=cfg, device=device).fold(m, objs)
        if a is None or b is None or a.user_index != b.user_index:
            raise AssertionError(f"{name}: the two folds patched different users")
        for attr in ("user_factors", "user_scales"):
            x, y = getattr(a, attr), getattr(b, attr)
            if (x is None) != (y is None) or (x is not None and not np.array_equal(
                    np.asarray(x).view(np.uint8), np.asarray(y).view(np.uint8))):
                raise AssertionError(f"{name}: {attr} of the columnar fold differs "
                                     "from the object fold's")
        if (sa.users_touched, sa.users_added, sa.rating_events) != (
                sb.users_touched, sb.users_added, sb.rating_events):
            raise AssertionError(f"{name}: fold stats {sa} vs {sb}")
        out[name] = {"users_touched": sa.users_touched, "users_added": sa.users_added,
                     "bit_identical": True}
    return out, objs


class FilelogPrep(threading.Thread):
    """The filelog phase's host-only start, beside the build like
    IngestPrep (it touches no device; the first phase that times host
    work waits for it): once IngestPrep's ML-1M file is written, per
    store (partitioned, then jsonl) ``app new`` (the access key from
    stdout), ``import`` (``--warm-cache`` on the partitioned store) and
    ``export`` as ``cli.main`` processes of their own, and the splice-route
    check in this process."""

    def __init__(self, ingest: IngestPrep):
        super().__init__(name="filelog-prep", daemon=True)
        self.ingest = ingest
        self.dirs = {kind: tempfile.mkdtemp(prefix=f"pio_chip_smoke_{kind}_")
                     for kind in ("partitioned", "jsonl")}
        self.out: dict = {}
        self.error: str | None = None
        self.started = self.done = 0.0

    def run(self):
        self.started = time.perf_counter()
        try:
            self.out = self.prep()
        except Exception:
            self.error = traceback.format_exc()
        self.done = time.perf_counter()

    def prep(self) -> dict:
        self.ingest.file_written.wait()
        if "vals" not in self.ingest.out:
            raise AssertionError(f"no ML-1M file: {self.ingest.error}")
        full, out = self.ingest.data_path, {"keys": {}}
        head = os.path.join(self.dirs["partitioned"], "ml1m_head.jsonl")
        with open(full) as src, open(head, "w") as dst:
            dst.writelines(line for _, line in zip(range(FILELOG_PARTITIONED), src))
        for kind, basedir in self.dirs.items():
            path = head if kind == "partitioned" else full
            n = self.events(kind)
            env = filelog_env(basedir, kind)
            o, _ = cli_run(basedir, "app", "new", "ML1M", env=env)
            out["keys"][kind] = next(ln.split(":", 1)[1].strip() for ln in o.splitlines()
                                     if ln.startswith("Access Key:"))
            flags = ["--warm-cache"] if kind == "partitioned" else []
            o, import_s = cli_run(basedir, "import", "--appid-or-name", "ML1M",
                                  "--input", path, *flags, env=env)
            if f"Imported {n} events." not in o or (
                    flags and f"Columnar cache warmed ({n} rating rows)." not in o):
                raise AssertionError(f"{kind} import printed {o!r}")
            export = os.path.join(basedir, "export.jsonl")
            o, export_s = cli_run(basedir, "export", "--appid-or-name", "ML1M",
                                  "--output", export, env=env)
            with open(export, "rb") as f:
                exported = sum(1 for _ in f)
            os.unlink(export)
            if exported != n:
                raise AssertionError(f"{kind} export wrote {exported} lines: {o!r}")
            out[kind] = {"import_s": import_s, "import_events_per_s": n / import_s,
                         "export_s": export_s, "export_events_per_s": n / export_s,
                         "splice": splice_route_check(kind, path)}
        os.unlink(head)
        return out

    def events(self, kind: str) -> int:
        """Rating events imported into the ``kind`` store: the file's
        first ones (its lines are the generated triples in order)."""
        n = len(self.ingest.out["vals"])
        return min(n, FILELOG_PARTITIONED) if kind == "partitioned" else n


@phase("filelog: import --warm-cache -> export -> train -> deploy --realtime -> "
       "columnar fold on K1 -> retrain-on-deploy (ML-1M shape, partitioned + jsonl)")
def filelog(torch, device, stats, prep: IngestPrep, fprep: FilelogPrep):
    """The file-log stores on IngestPrep's ML-1M file. (1) FilelogPrep's
    ``app new``, ``import`` of its first FILELOG_PARTITIONED events into a
    partitioned store (8 partitions, 4 MiB segments, ``--warm-cache``) and
    of all of it into a jsonl store, both on the splice
    route (checked in process on the file's first 10,000 lines), and
    ``export`` from both, beside the build; here every partition must have
    sealed segments, the ratings read back by ``find_ratings`` and by
    ``read_training`` must equal the generated ones as multisets, and
    ``read_training`` is timed cold (no columnar cache) and warm. (2)
    ``train`` (rank 20, 10 iterations) on the partitioned store with K1's
    count reset before and read after (10 x the buckets), ``deploy
    --realtime 0.5`` in a subprocess (files mode), 50 known users' answers
    against K2's plain version. (3) The deploy stops (its cursor flushed);
    an event server in its own process takes the new events as PIF1
    frames on ``/batch/events.bin`` (the splice route); the deploy starts
    again on the same cursor, so its first poll tails every new line and
    folds once (a partition that sealed meanwhile is fresh lineage, whose
    re-read may take more polls, a fold each): every posted line tailed
    once, the fold's K1 launches, columnar and fallback line counts and
    fold seconds from its ``/metrics``, every new and touched user's
    answer against K1's fold plus the plain top-k; meanwhile, in this
    process, ``fold_in_columnar`` against ``fold`` on the same lines, bit
    for bit, f32 and int8. (4) ``run_train`` with an algorithm that persists no
    model (a ``retrain`` entry), then the engine server, whose deploy
    trains (K1 2 x the buckets), answering against the plain version."""
    from predictionio_tpu_torch import native
    from predictionio_tpu_torch.cli import main as cli
    from predictionio_tpu_torch.core.context import WorkflowContext
    from predictionio_tpu_torch.core.workflow import prepare_deploy, run_train
    from predictionio_tpu_torch.data import store
    from predictionio_tpu_torch.data import storage as st
    from predictionio_tpu_torch.data.storage import colspans
    from predictionio_tpu_torch.models import recommendation as rec
    from predictionio_tpu_torch.ops import als, topk
    from predictionio_tpu_torch.realtime import EventTailer, FoldInConfig
    from predictionio_tpu_torch.realtime import foldin as foldin_mod
    from predictionio_tpu_torch.server.engine_server import EngineServer

    if not native.native_available():
        raise AssertionError("the native event codec did not load")
    fprep.join(timeout=900)
    if fprep.is_alive() or fprep.error:
        raise AssertionError(f"filelog preparation: {fprep.error or 'not finished'}")
    nu, ni = prep.out["num_users"], prep.out["num_items"]
    n = {kind: fprep.events(kind) for kind in fprep.dirs}
    out: dict = {"card": stats.get("smi"), "events": n,
                 "prep_s": fprep.done - fprep.started,
                 "prep_done_after_build_s": fprep.done - stats.get("build_done", fprep.done)}
    dirs, keys = fprep.dirs, fprep.out["keys"]
    part, part_env = dirs["partitioned"], filelog_env(dirs["partitioned"], "partitioned")
    server = es = None
    try:
        # (1) the stores, built by FilelogPrep
        for kind, basedir in dirs.items():
            env = filelog_env(basedir, kind)
            warmed = kind == "partitioned"  # import --warm-cache built its cache
            rows, cols, vals = (prep.out[k][:n[kind]] for k in ("rows", "cols", "vals"))
            out[kind] = dict(fprep.out[kind])
            with storage_env(basedir, env):
                ds = rec.RecommendationDataSource(rec.DataSourceParams(app_name="ML1M"))
                # cold: the row logs (train --no-columnar-cache); warm: the
                # column blocks, which import --warm-cache built on the
                # partitioned store and the first cached read ("first", a
                # miss) builds on the jsonl one; the file cache is warm
                reads = ("cold", "warm") if warmed else ("cold", "first", "warm")
                for cache in reads:
                    os.environ["PIO_COLUMNAR_CACHE"] = "0" if cache == "cold" else "1"
                    t0 = time.perf_counter()
                    td = ds.read_training(None)
                    out[kind][f"read_training_{cache}_s"] = time.perf_counter() - t0
                    b = store.find_ratings("ML1M", event_names=["rate"])
                    if not (ratings_equal(b.entity_ids, b.target_ids, b.rows, b.cols, b.vals,
                                          rows, cols, vals)
                            and ratings_equal(td.user_ids, td.item_ids, td.rows, td.cols,
                                              td.ratings, rows, cols, vals)):
                        raise AssertionError(f"{kind} ({cache}): ratings read back differ")
                os.environ.pop("PIO_COLUMNAR_CACHE")
        segs = sealed_segments(part)
        if len(segs) != FILELOG_PARTITIONS or min(segs.values()) < 1:
            raise AssertionError(f"sealed segments per partition: {segs}")
        out["partitioned"]["sealed_segments"] = sum(segs.values())

        # (2) train and deploy on the partitioned store (its triples)
        rows, cols, vals = (prep.out[k][:n["partitioned"]] for k in ("rows", "cols", "vals"))
        variant = os.path.join(part, "engine.json")
        with open(variant, "w") as f:
            json.dump({"id": "chip-smoke-filelog", "engineFactory": REC_FACTORY,
                       "datasource": {"params": {"appName": "ML1M"}},
                       "algorithms": [{"name": "als", "params": {
                           "rank": INGEST_RANK, "numIterations": INGEST_ITERATIONS,
                           "lambda": TRAIN_REG, "seed": 3}}]}, f)
        per_iter = k1_launches_per_iteration(
            als.build_ratings_data(rows, cols, vals, nu, ni), INGEST_RANK)
        with storage_env(part, part_env):
            als.solve_bucket.launches.reset()  # the main path starts here
            t0 = time.perf_counter()
            if cli.main(["train", "--variant", variant]) != 0:
                raise AssertionError("cli train failed")
            out["train_s"] = time.perf_counter() - t0
            out["train_k1_launches"] = als.solve_bucket.launches.value
            if out["train_k1_launches"] != INGEST_ITERATIONS * per_iter:
                raise AssertionError(f"train: K1 launched {out['train_k1_launches']}, "
                                     f"expected {INGEST_ITERATIONS} x {per_iter}")
            storage = st.get_storage()
            inst = storage.get_metadata_engine_instances().get_latest_completed(
                "chip-smoke-filelog", "0", "engine.json")
            model = prepare_deploy(rec.engine(), inst, storage,
                                   WorkflowContext(device=device))[2][0]
            app_id = store.app_name_to_id("ML1M", None, storage)[0]
            events = storage.get_events()
            cursor = os.path.join(part, "cursor.json")
            flags = ["--realtime", str(RT_INTERVAL), "--realtime-cursor", cursor]
            # one $set line a partition, by an id that embeds it, before the
            # deploy attaches: a log that did not exist at attach is fresh
            # lineage to the tailer (the object path, as the JAX tailer does
            # after a seal), so every partition gets an active log first; a
            # line that seals its partition leaves none, and a second one
            # starts the partition's next active log
            es = EventServerProcess(part, part_env)

            def without_active():
                have = {os.path.basename(str(f.parent)) for f in events.tail_files(app_id)
                        if f.name == "active.jsonl" and f.exists()}
                return [pp for pp in range(FILELOG_PARTITIONS) if f"p{pp:02x}" not in have]

            for attempt in range(3):
                missing = without_active()
                if not missing:
                    break
                post_frames(es, keys["partitioned"], [
                    {"event": "$set", "entityType": "item", "entityId": f"i{pp}",
                     "eventId": f"{pp:02x}-filelog-attach{attempt}",
                     "properties": {"attach": True}} for pp in missing])
            if without_active():
                raise AssertionError(f"partitions {without_active()} have no active log "
                                     "before the deploy")
            server = DeployProcess(part, inst.id, device.type, flags, "filelog", part_env)
            rt = rt_stats(server)["realtime"]
            if rt["mode"] != "files":
                raise AssertionError(f"the speed layer tails in mode {rt['mode']}")
            rng = np.random.default_rng(SEED + 17)
            deg = np.bincount(rows, minlength=nu)
            known = [int(np.argmax(deg))] + [
                int(u) for u in rng.choice(np.flatnonzero((deg > 0) & (deg != deg.max())),
                                           size=RT_KNOWN - 1, replace=False)]
            queries = [{"user": f"u{u}", "num": 10} for u in known]
            conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
            for q, (exp_items, exp_scores) in zip(
                    queries, expected_items(torch, model, device, queries)):
                got = post(conn, q)["itemScores"]
                check_answer([x["item"] for x in got], [x["score"] for x in got],
                             exp_items, exp_scores, model, f"filelog {q}")
            conn.close()
            out["deploy_k2_calls"] = k2_tile_calls(server.metrics())
            if out["deploy_k2_calls"] < len(queries):
                raise AssertionError(f"the deploy made {out['deploy_k2_calls']} K2 calls "
                                     f"for {len(queries)} queries")
            if server.stop() != 0:
                raise AssertionError("deploy did not exit 0:\n" + server.log_tail())
            server = None
            with open(cursor) as f:
                if json.load(f)["mode"] != "files":
                    raise AssertionError("the deploy's cursor is not a files cursor")

            # (3) the new events through the event server, the columnar fold
            decode = colspans.DecodeConfig(event_names=("rate", "buy"),
                                           override_ratings={"buy": 4.0})
            t_col = EventTailer(events, app_id, columnar_config=decode)
            t_obj = EventTailer(events, app_id)
            sealed_before = sum(sealed_segments(part).values())
            new = filelog_new_events(rng, nu, ni, known)
            post_frames(es, keys["partitioned"], new)
            if es.stop() != 0:
                raise AssertionError("eventserver did not exit 0:\n" + es.log_tail())
            es = None
            # a partition that sealed while they arrived moved its active
            # log, new lines and all, to a segment the tailer never saw:
            # fresh lineage, which the tailer re-reads on the object path
            sealed_while_posting = sum(sealed_segments(part).values()) - sealed_before
            # the deploy starts again on its cursor, and folds, while this
            # process holds the two in-process folds against each other
            with ThreadPoolExecutor(1) as spawn:
                starting = spawn.submit(DeployProcess, part, inst.id, device.type, flags,
                                        "filelog2", part_env)
                try:
                    found = FindOnce(events)  # the store no longer changes here
                    out["columnar_vs_object"], objs = columnar_vs_object(
                        torch, device, found, app_id, model, t_col, t_obj)
                    fold = foldin_mod.ALSFoldIn(found, app_id,
                                                config=FoldInConfig(reg=TRAIN_REG),
                                                device=device)
                    fstats = foldin_mod.FoldInStats()
                    touched: list = []
                    fold._collect_events(model, objs, fstats, touched, set())
                    users, pairs = fold.touched_pairs(model, touched, fstats)
                finally:
                    server = starting.result()
            rt1 = wait_folded(server, 0, "the new events", timeout=300,
                              folded=fstats.rating_events)
            m1 = server.metrics()
            V = model.device_factors(device)[1]
            k1 = fold_k1_checks(torch, als, foldin_mod, V, pairs, TRAIN_REG, stats)
            col = int(metric_delta(m1, {}, "pio_tailer_columnar_lines_total"))
            fb = int(metric_delta(m1, {}, "pio_tailer_columnar_fallback_lines_total"))
            tailed = int(metric_delta(m1, {}, "pio_tailer_events_total"))
            k1_main = int(metric_delta(m1, {}, "pio_k1_kernel_launches"))
            # every posted line once, and no line of the history
            if tailed != len(new) or rt1["events_folded"] != fstats.rating_events:
                raise AssertionError(f"{tailed} events tailed of {len(new)} posted, "
                                     f"{rt1['events_folded']} rating events folded of "
                                     f"{fstats.rating_events}")
            if not sealed_while_posting:
                if col <= 0 or col + fb != len(new):
                    raise AssertionError(f"columnar {col} + fallback {fb} lines, "
                                         f"{len(new)} posted")
                if rt1["foldin_epoch"] != 1 or k1_main != k1["launches_per_fold"]:
                    raise AssertionError(f"{rt1['foldin_epoch']} folds, {k1_main} K1 "
                                         f"launches, expected 1 fold of "
                                         f"{k1['launches_per_fold']}")
            # a sealed partition's segment is fresh lineage: its new lines
            # take the object path, counted by neither counter, and the
            # re-read of the segment's history can take more than one poll
            # (a fold each), which launches K1 at least as often as one
            elif (col <= 0 or col + fb >= len(new)
                  or k1_main < k1["launches_per_fold"]):
                raise AssertionError(f"after a seal: columnar {col} + fallback {fb} lines "
                                     f"of {len(new)}, {k1_main} K1 launches in "
                                     f"{rt1['foldin_epoch']} folds, one fold "
                                     f"{k1['launches_per_fold']}")
            if rt1["users_added"] != RT_NEW_USERS or rt1["cold_start_items"] != RT_COLD:
                raise AssertionError(f"fold stats {rt1}")
            check_folded_answers(torch, model, V, users, pairs, server.port, device)
            fold_n = metric_delta(m1, {}, "pio_foldin_solve_seconds_count")
            out["fold"] = {
                "events": len(new), "columnar_lines": col, "fallback_lines": fb,
                "tailed_events": tailed, "sealed_while_posting": sealed_while_posting,
                "users_folded": len(users), "folds": rt1["foldin_epoch"],
                "k1_launches_main_path": k1_main,
                "fold_s": metric_delta(m1, {}, "pio_foldin_solve_seconds_sum") / fold_n,
                "seconds_behind": rt1["seconds_behind"], "k1": k1}
            if server.stop() != 0:
                raise AssertionError("deploy did not exit 0:\n" + server.log_tail())
            server = None

            # (4) retrain-on-deploy
            class Transient(rec.ALSAlgorithm):
                def make_persistent_model(self, model):
                    return None

            engine = rec.engine()
            engine.algorithm_classes = {"als": Transient}
            ep = engine.params_from_variant({
                "datasource": {"params": {"appName": "ML1M"}},
                "algorithms": [{"name": "als", "params": {
                    "rank": INGEST_RANK, "numIterations": FILELOG_RETRAIN_ITERATIONS,
                    "lambda": TRAIN_REG, "seed": 3}}]})
            # its own cache directory: the prepcache phase probes the
            # entry the train above published, from before the new events
            prep_dir = os.environ["PIO_PREP_CACHE_DIR"]
            os.environ["PIO_PREP_CACHE_DIR"] = os.path.join(prep_dir, "retrain")
            try:
                iid = run_train(engine, ep, engine_id="chip-smoke-retrain", storage=storage,
                                ctx=WorkflowContext(device=device))
            finally:
                os.environ["PIO_PREP_CACHE_DIR"] = prep_dir
            batch = store.find_ratings("ML1M", event_names=["rate", "buy"])
            per_iter2 = k1_launches_per_iteration(als.build_ratings_data(
                batch.rows, batch.cols, batch.vals, len(batch.entity_ids),
                len(batch.target_ids)), INGEST_RANK)
            als.solve_bucket.launches.reset()
            topk.gather_top_k_batch.launches.reset()
            t0 = time.perf_counter()
            os.environ["PIO_PREP_CACHE_DIR"] = os.path.join(prep_dir, "retrain")
            try:
                server = EngineServer(engine, storage.get_metadata_engine_instances().get(iid),
                                      storage=storage, host="127.0.0.1", port=0,
                                      device=device)
            finally:
                os.environ["PIO_PREP_CACHE_DIR"] = prep_dir
            retrain_s = time.perf_counter() - t0
            k1_retrain = als.solve_bucket.launches.value
            if k1_retrain != FILELOG_RETRAIN_ITERATIONS * per_iter2:
                raise AssertionError(f"retrain-on-deploy: K1 launched {k1_retrain}, expected "
                                     f"{FILELOG_RETRAIN_ITERATIONS} x {per_iter2}")
            port = server.start(background=True)
            retrained = server.models[0]
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            qs = queries[:10] + [{"user": "new0", "num": 10}]
            for q, (exp_items, exp_scores) in zip(
                    qs, expected_items(torch, retrained, device, qs)):
                got = post(conn, q)["itemScores"]
                check_answer([x["item"] for x in got], [x["score"] for x in got],
                             exp_items, exp_scores, retrained, f"retrained {q}")
            conn.close()
            k2_retrained = topk.gather_top_k_batch.launches.value
            if k2_retrained <= 0:
                raise AssertionError("the retrained deploy launched no K2")
            server.stop()
            server = None
            out["retrain_on_deploy"] = {"deploy_s": retrain_s, "k1_launches": k1_retrain,
                                        "k2_calls": k2_retrained, "ratings": len(batch.vals)}
    finally:
        # the stores stay for the prepcache phase; main() removes them
        for proc in (server, es):
            if proc is not None:
                proc.stop()
    stats["filelog"] = out
    log(json.dumps({"filelog": "ml1m partitioned + jsonl", **out}))


# -- phase: the packed-prep cache ------------------------------------------------

PREP_ITERATIONS = 5
PREP_NEW_USERS, PREP_NEW_ITEMS = 200, 50  # in the appended tail
PREP_APPEND = 5_000  # rating events appended through import
PREP_SEAL_SEGMENT = 4 << 10  # the sealing client's segment size


class TrainCapture:
    """What one ``cli.main train`` hands K1, captured in process:
    ``read_training``'s TrainingData and seconds, the seconds of the
    bucket layout (built or from the prep cache), and ``als_train``'s
    RatingsData and factors."""

    def __init__(self, rec, als, prep_cache):
        self.rec, self.als, self.prep_cache = rec, als, prep_cache
        self.out: dict = {}

    def __enter__(self):
        rec, als, handle = self.rec, self.als, self.prep_cache.PrepHandle
        self.saved = (rec.RecommendationDataSource.read_training, als.build_ratings_data,
                      handle.packed_buckets, als.als_train)
        read, build, packed, train = self.saved
        out = self.out

        def timed(key, fn):
            def call(*a, **kw):
                t0 = time.perf_counter()
                result = fn(*a, **kw)
                out[key] = out.get(key, 0.0) + time.perf_counter() - t0
                return result
            return call

        def read_training(ds, ctx):
            out["td"] = td = timed("read_training_s", read)(ds, ctx)
            return td

        def packed_buckets(h, *a, **kw):
            result = timed("layout_s", packed)(h, *a, **kw)
            out["from_cache"] = result is not None
            return result

        def als_train(data, *a, **kw):
            out["data"] = data
            out["factors"] = timed("als_train_s", train)(data, *a, **kw)
            return out["factors"]

        rec.RecommendationDataSource.read_training = read_training
        als.build_ratings_data = timed("layout_s", build)
        handle.packed_buckets = packed_buckets
        als.als_train = als_train
        return self

    def __exit__(self, *exc):
        (self.rec.RecommendationDataSource.read_training, self.als.build_ratings_data,
         self.prep_cache.PrepHandle.packed_buckets, self.als.als_train) = self.saved


def same_batch(td, ref) -> bool:
    """Two TrainingData bit for bit: ids, and rows / cols / ratings with
    their dtypes."""
    return (list(td.user_ids) == list(ref.user_ids)
            and list(td.item_ids) == list(ref.item_ids)
            and all(a.dtype == b.dtype and np.array_equal(a, b)
                    for a, b in ((td.rows, ref.rows), (td.cols, ref.cols),
                                 (td.ratings, ref.ratings))))


def same_buckets(got, want) -> bool:
    """Two PaddedBucket lists bit for bit, ``seg_row`` included."""
    return len(got) == len(want) and all(
        all(getattr(a, f).dtype == getattr(b, f).dtype
            and np.array_equal(getattr(a, f), getattr(b, f))
            for f in ("row_ids", "col_ids", "ratings", "mask"))
        and (a.seg_row is None) == (b.seg_row is None)
        and (a.seg_row is None or np.array_equal(a.seg_row, b.seg_row))
        for a, b in zip(got, want))


def prep_tail_lines(rng, nu: int, ni: int) -> str:
    """PREP_APPEND rating events: PREP_NEW_USERS new users (``tail<j>``),
    PREP_NEW_ITEMS new items (``tailitem<c>``), the rest known users and
    items."""
    users = [f"tail{j}" for j in range(PREP_NEW_USERS)]
    items = [f"tailitem{c}" for c in range(PREP_NEW_ITEMS)]
    lines = []
    for k in range(PREP_APPEND):
        u = users[k % len(users)] if k % 3 == 0 else f"u{int(rng.integers(0, nu))}"
        i = items[k % len(items)] if k % 7 == 0 else f"i{int(rng.integers(0, ni))}"
        lines.append('{"event":"rate","entityType":"user","entityId":"%s",'
                     '"targetEntityType":"item","targetEntityId":"%s",'
                     '"properties":{"rating":%.1f},"eventTime":"%s"}\n'
                     % (u, i, float(rng.integers(1, 6)), INGEST_TIME))
    return "".join(lines)


@phase("prepcache: train miss -> hit -> import a tail -> splice, each held to a fresh "
       "scan and layout; a seal on the partitioned store; the cache verb (ML-1M shape)")
def prep_cache_phase(torch, device, stats, prep: IngestPrep, fprep: FilelogPrep):
    """The packed-prep cache on the filelog phase's stores (see the module
    docstring): three ``train`` runs on the jsonl store (miss, hit, splice)
    and a ``--no-prep-cache`` one, each holding what K1 received to a
    fresh read and layout; a seal's rebuild on the partitioned store; the
    ``cache`` verb."""
    from predictionio_tpu_torch.cli import main as cli
    from predictionio_tpu_torch.core import prep_cache
    from predictionio_tpu_torch.data import storage as st
    from predictionio_tpu_torch.data import store
    from predictionio_tpu_torch.models import recommendation as rec
    from predictionio_tpu_torch.obs import metrics as obs_metrics
    from predictionio_tpu_torch.ops import als

    jl, part = fprep.dirs["jsonl"], fprep.dirs["partitioned"]
    jl_env, part_env = filelog_env(jl, "jsonl"), filelog_env(part, "partitioned")
    nu, ni = prep.out["num_users"], prep.out["num_items"]
    global_dir = os.environ["PIO_PREP_CACHE_DIR"]
    cache_dir = os.path.join(global_dir, "prepcache")
    variant = os.path.join(jl, "engine.json")
    with open(variant, "w") as f:
        json.dump({"id": "chip-smoke-prepcache", "engineFactory": REC_FACTORY,
                   "datasource": {"params": {"appName": "ML1M"}},
                   "algorithms": [{"name": "als", "params": {
                       "rank": INGEST_RANK, "numIterations": PREP_ITERATIONS,
                       "lambda": TRAIN_REG, "seed": 3}}]}, f)
    out: dict = {"card": stats.get("smi"), "iterations": PREP_ITERATIONS}
    knobs = ("PIO_PREP_CACHE", "PIO_PREP_CACHE_DIR")
    saved = {k: os.environ.get(k) for k in knobs}

    def restore_knobs():
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def train(what: str, *flags) -> tuple[dict, dict]:
        """One ``cli.main train`` with K1's count reset before and read
        after; the K1 launches must be the iterations x the buckets."""
        with TrainCapture(rec, als, prep_cache) as cap:
            als.solve_bucket.launches.reset()  # this path starts here
            t0 = time.perf_counter()
            try:
                rc = cli.main(["train", "--variant", variant, *flags])
            finally:
                restore_knobs()  # cmd_train sets the knobs it is given
            wall = time.perf_counter() - t0
            k1 = als.solve_bucket.launches.value
        if rc != 0:
            raise AssertionError(f"{what}: cli train exited {rc}")
        got = cap.out
        td, data = got["td"], got["data"]
        expect = PREP_ITERATIONS * k1_launches_per_iteration(data, INGEST_RANK)
        if k1 != expect:
            raise AssertionError(f"{what}: K1 launched {k1}, expected {expect}")
        status = td.prep.status if td.prep is not None else "off"
        row = {"status": status, "ratings": len(td.ratings),
               "read_training_s": got["read_training_s"], "layout_s": got["layout_s"],
               "layout_from_cache": bool(got.get("from_cache")),
               "als_train_s": got["als_train_s"], "train_s": wall, "k1_launches": k1}
        log(json.dumps({"prepcache": what, **row}))
        return row, got

    def held_to_fresh(what: str, got: dict) -> None:
        """The batch and both bucket lists K1 received, bit-equal to a
        PIO_PREP_CACHE=0 read and build_padded_buckets of the same log."""
        os.environ["PIO_PREP_CACHE"] = "0"
        try:
            ref = rec.RecommendationDataSource(
                rec.DataSourceParams(app_name="ML1M")).read_training(None)
        finally:
            restore_knobs()
        data = got["data"]
        if not same_batch(got["td"], ref):
            raise AssertionError(f"{what}: the batch differs from a fresh read")
        widths = rec.ALSAlgorithmParams().bucket_widths
        if not (same_buckets(data.row_buckets, als.build_padded_buckets(
                    ref.rows, ref.cols, ref.ratings, widths))
                and same_buckets(data.col_buckets, als.build_padded_buckets(
                    ref.cols, ref.rows, ref.ratings, widths))):
            raise AssertionError(f"{what}: the buckets differ from a fresh layout")

    def rebuilds(reason: str) -> float:
        return obs_metrics.counter("pio_prep_cache_rebuilds_total", reason=reason).value()

    def cache_cli(*argv) -> tuple[int, str]:
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc = cli.main(["cache", *argv])
        return rc, printed.getvalue()

    try:
        with storage_env(jl, jl_env):
            flags = ["--prep-cache-dir", cache_dir]
            miss, _ = train("miss", *flags)
            entries = [n for n in os.listdir(cache_dir) if n.endswith(".prep")]
            if miss["status"] != "miss" or len(entries) != 1:
                raise AssertionError(f"the first train: {miss}, entries "
                                     f"{os.listdir(cache_dir)}")
            hit, got = train("hit", *flags)
            if hit["status"] != "hit" or not hit["layout_from_cache"]:
                raise AssertionError(f"the second train: {hit}")
            held_to_fresh("hit", got)
            tail = os.path.join(jl, "tail.jsonl")
            with open(tail, "w") as f:
                f.write(prep_tail_lines(np.random.default_rng(SEED + 19), nu, ni))
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                rc = cli.main(["import", "--appid-or-name", "ML1M", "--input", tail])
            if rc != 0 or f"Imported {PREP_APPEND} events." not in printed.getvalue():
                raise AssertionError(f"import of the tail: {rc} {printed.getvalue()!r}")
            splice, got = train("splice", *flags)
            if splice["status"] != "splice" or not splice["layout_from_cache"]:
                raise AssertionError(f"the train after the append: {splice}")
            if splice["ratings"] != hit["ratings"] + PREP_APPEND:
                raise AssertionError(f"the splice read {splice['ratings']} ratings, "
                                     f"expected {hit['ratings']} + {PREP_APPEND}")
            held_to_fresh("splice", got)
            cold, cold_got = train("cold", "--no-prep-cache", *flags)
            if cold["status"] != "off" or cold["layout_from_cache"]:
                raise AssertionError(f"train --no-prep-cache: {cold}")
            (U, V), (U0, V0) = got["factors"], cold_got["factors"]
            if not (same_bits(torch, U, U0) and same_bits(torch, V, V0)):
                raise AssertionError("the splice-fed train's factors differ from a "
                                     "--no-prep-cache train's from the same seed")
            out.update(miss=miss, hit=hit, splice=splice, cold=cold)

            # the cache verb on the phase's directory
            os.environ["PIO_PREP_CACHE_DIR"] = cache_dir
            rc, text = cache_cli("list", "--json")
            listing = json.loads(text)
            names = [e["name"] for e in listing["entries"]]
            if (rc != 0 or len(names) != 1 or listing["entries"][0]["n"] != splice["ratings"]
                    or not listing["entries"][0]["single_pack"]):
                raise AssertionError(f"cache list --json: {rc} {listing}")
            rc, text = cache_cli("evict", names[0])
            if rc != 0 or prep_cache.cache_entries():
                raise AssertionError(f"cache evict: {rc} {text!r}")
            restore_knobs()

        # the partitioned store: the entry the filelog phase's train
        # published, then a seal
        with storage_env(part, part_env):
            storage = st.get_storage()
            app_id = store.app_name_to_id("ML1M", None, storage)[0]
            probe = dict(entity_type="user", event_names=["rate", "buy"],
                         target_entity_type="item", rating_key="rating",
                         default_ratings=None, override_ratings={"buy": 4.0})
            [entry] = [e for e in prep_cache.cache_entries(detail=True)]
            if not entry["spliceable"]:
                raise AssertionError(f"the filelog train's entry is not spliceable: {entry}")
            sealed0 = sum(sealed_segments(part).values())
        with storage_env(part, part_env | {
                "PIO_STORAGE_SOURCES_LOG_SEGMENT_BYTES": str(PREP_SEAL_SEGMENT)}):
            from predictionio_tpu_torch.data.event import Event

            st.get_storage().get_events().batch_insert([
                Event(event="rate", entity_type="user", entity_id=f"u{u}",
                      target_entity_type="item", target_entity_id="i1",
                      properties={"rating": 3.0}) for u in range(4 * FILELOG_PARTITIONS)],
                app_id)
        sealed = sum(sealed_segments(part).values()) - sealed0
        if sealed <= 0:
            raise AssertionError("the append through a small-segment client sealed nothing")
        with storage_env(part, part_env):
            changed0 = rebuilds("changed")
            t0 = time.perf_counter()
            handle = prep_cache.probe("ML1M", **probe)
            probe_s = time.perf_counter() - t0
            if handle.status != "miss" or rebuilds("changed") != changed0 + 1:
                raise AssertionError(f"after a seal: status {handle.status}, "
                                     f"changed rebuilds {rebuilds('changed') - changed0}")
        out["partitioned_seal"] = {"sealed_segments": sealed, "status": handle.status,
                                   "reason": "changed", "probe_s": probe_s}
        # cache prune --max-mb on the script's own directory
        husk = os.path.join(global_dir, "x.prep.tmp.1")
        with open(husk, "wb") as f:
            f.write(b"partial")
        os.utime(husk, (time.time() - 1e4, time.time() - 1e4))
        before = [e["name"] for e in prep_cache.cache_entries()]
        rc, text = cache_cli("prune", "--max-mb", "0.000001", "--json")
        pruned = json.loads(text)
        if (rc != 0 or pruned["husks"] != ["x.prep.tmp.1"]
                or sorted(pruned["evicted"]) != sorted(before) or not before
                or prep_cache.cache_entries()):
            raise AssertionError(f"cache prune: {rc} {pruned}, entries before {before}")
        out["cache_verb"] = {"listed": names, "evicted": names, "pruned": pruned}
    finally:
        restore_knobs()
    stats["prepcache"] = out
    log(json.dumps({"prepcache": "ml1m jsonl + partitioned", **out}))


# -- phase: the supervised fleet ---------------------------------------------------

#: the scheduler's cadence: the first retrain falls due this long after the
#: supervisor starts (not after the bring-up), so the events are posted
#: right after the bring-up, and the kill -9's checks must end before the
#: retrain does (the restarted engine would load its instance): on the
#: card the bring-up takes ~16 s and the kill -9 ~10 s, which leaves 20 s
#: a few seconds of margin, so 30 s
FLEET_RETRAIN_EVERY = "30s"
FLEET_USERS = 50  # known users queried across the kill, the retrain and the roll
FLEET_NEW_USERS = 100  # new users among the posted events
FLEET_EVENTS = 3_000  # rating events posted through the supervised event server
FLEET_VARIANT_ID = "chip-smoke-fleet"


def proc_start_wall(pid: int) -> float | None:
    """Wall-clock start of process ``pid`` (``/proc``: its start in clock
    ticks after boot, against ``/proc/uptime`` read now), or None."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return None
    return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))


class BootWatch(threading.Thread):
    """Polls ``/healthz`` and ``/readyz`` of the fleet's ports every 50 ms.
    For each instance id (one boot of one child): its pid, its process's
    start (``proc_start_wall``) and when it first answered healthy and
    ready, so every child's spawn-to-healthy and spawn-to-ready seconds."""

    def __init__(self, ports: dict):
        super().__init__(name="boot-watch", daemon=True)
        self.ports = ports
        self.boots: dict = {}
        self.done = threading.Event()

    def run(self):
        from predictionio_tpu_torch.cli import daemon

        while not self.done.is_set():
            for service, port in self.ports.items():
                doc = daemon.probe_health("127.0.0.1", port, timeout=0.5)
                if doc is None:
                    continue
                boot = self.boots.get(doc["instance"])
                if boot is None:
                    boot = self.boots[doc["instance"]] = {
                        "service": service, "pid": doc["pid"], "healthy": time.time(),
                        "started": proc_start_wall(doc["pid"])}
                if "ready" not in boot:
                    ready = daemon.probe_ready("127.0.0.1", port, timeout=0.5)
                    if ready and ready.get("ready") and ready["instance"] == doc["instance"]:
                        boot["ready"] = time.time()
            self.done.wait(0.05)

    def stop(self) -> list:
        """The boots seen, in order, each with its seconds from spawn."""
        self.done.set()
        self.join(timeout=10)
        out = []
        for instance, b in sorted(self.boots.items(), key=lambda kv: kv[1]["healthy"]):
            row = {"service": b["service"], "instance": instance, "pid": b["pid"]}
            if b["started"] is not None:
                row["spawn_to_healthy_s"] = b["healthy"] - b["started"]
                if "ready" in b:
                    row["spawn_to_ready_s"] = b["ready"] - b["started"]
            out.append(row)
        return out


def http_call(port: int, method: str, path: str, body: bytes | None = None,
              conn=None, timeout: float = 30):
    """(status, body bytes) of one request, on ``conn`` when given."""
    own = conn is None
    conn = conn or http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        headers = {"Content-Type": "application/json"} if body is not None else {}
        conn.request(method, path, body, headers)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        if own:
            conn.close()


def ask_all(port: int, queries: list) -> list:
    """Each query's raw answer bytes, on one keep-alive connection; all 200."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        out = []
        for q in queries:
            status, raw = http_call(port, "POST", "/queries.json", json.dumps(q).encode(), conn)
            if status != 200:
                raise AssertionError(f"{q}: HTTP {status} {raw[:300]!r}")
            out.append(raw)
        return out
    finally:
        conn.close()


def fleet_state(run: str) -> dict:
    try:
        with open(os.path.join(run, "supervisor.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def wait_for(what: str, cond, timeout: float, proc=None, log_path=None):
    """Poll ``cond`` every 50 ms until it gives something true; fails on
    the timeout or when ``proc`` exits."""
    deadline = time.perf_counter() + timeout
    while True:
        got = cond()
        if got:
            return got
        if proc is not None and proc.poll() is not None:
            tail = open(log_path).read()[-3000:] if log_path else ""
            raise AssertionError(f"{what}: the process exited {proc.returncode}\n{tail}")
        if time.perf_counter() > deadline:
            tail = open(log_path).read()[-3000:] if log_path else ""
            raise AssertionError(f"timed out ({timeout:.0f}s) waiting for {what}\n{tail}")
        time.sleep(0.05)


def card_pids() -> set:
    """Pids ``nvidia-smi`` lists as compute processes on the card."""
    return set(card_apps())


def free_card_bytes(torch, device) -> int | None:
    """Free device memory as CUDA reports it (every process's
    contexts and allocations count), or None off the card."""
    if device.type != "cuda":
        return None
    torch.cuda.empty_cache()
    return torch.cuda.mem_get_info(device)[0]


class MemoryLow(threading.Thread):
    """The least free device memory seen while it runs (every 20 ms)."""

    def __init__(self, torch, device):
        super().__init__(name="memory-low", daemon=True)
        self.torch, self.device = torch, device
        self.low: int | None = None
        self.done = threading.Event()

    def run(self):
        while not self.done.is_set():
            free = self.torch.cuda.mem_get_info(self.device)[0]
            self.low = free if self.low is None else min(self.low, free)
            self.done.wait(0.02)

    def stop(self) -> int | None:
        self.done.set()
        self.join(timeout=10)
        return self.low


class KeepAlive(threading.Thread):
    """Queries in a loop on one keep-alive connection (a new one after
    the server closes it, counted): every answer's status and bytes."""

    def __init__(self, port: int, queries: list):
        super().__init__(name="keep-alive", daemon=True)
        self.port, self.queries = port, queries
        self.answers: list = []  # (query index, status, bytes)
        self.errors: list = []
        self.reconnects = 0
        self.done = threading.Event()

    def run(self):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=60)
        i = 0
        while not self.done.is_set():
            j = i % len(self.queries)
            body = json.dumps(self.queries[j]).encode()
            for attempt in (0, 1):
                try:
                    status, raw = http_call(self.port, "POST", "/queries.json", body, conn)
                    self.answers.append((j, status, raw))
                    break
                except (OSError, http.client.HTTPException) as e:
                    # the draining instance closed the connection between
                    # requests: reconnect (to whichever instance accepts)
                    conn.close()
                    conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=60)
                    self.reconnects += 1
                    if attempt:
                        self.errors.append(repr(e))
            i += 1
        conn.close()

    def stop(self):
        self.done.set()
        self.join(timeout=70)


@phase("fleet: supervise (event server + engine) -> events -> kill -9 -> a scheduled retrain -> "
       "status --json -> SIGTERM; start-all -> rolling-restart -> stop-all (ML-1M, jsonl)")
def fleet(torch, device, stats, prep: IngestPrep, fprep: FilelogPrep):
    """The supervised fleet on the filelog phase's jsonl store (see the
    module docstring): ``supervise`` with the engine deployed on the card,
    events posted through its event server, a kill -9 of the engine child,
    one scheduled warm retrain (a prep-cache splice of the events) and its
    ``/reload``, ``status`` and ``status --json``, SIGTERM to the
    supervisor; then ``start-all`` and ``rolling-restart engine`` under a
    keep-alive query loop, and ``stop-all``."""
    from predictionio_tpu_torch.cli import daemon
    from predictionio_tpu_torch.cli import main as cli
    from predictionio_tpu_torch.core.context import WorkflowContext
    from predictionio_tpu_torch.core.workflow import prepare_deploy
    from predictionio_tpu_torch.data import storage as st
    from predictionio_tpu_torch.data.storage import frame
    from predictionio_tpu_torch.models import recommendation as rec
    from predictionio_tpu_torch.obs.metrics import parse_prometheus
    from predictionio_tpu_torch.ops import als

    jl = fprep.dirs["jsonl"]
    jl_env = filelog_env(jl, "jsonl")
    key = fprep.out["keys"]["jsonl"]
    nu, ni = prep.out["num_users"], prep.out["num_items"]
    run = tempfile.mkdtemp(prefix="pio_chip_smoke_fleet_")
    cache_dir = os.path.join(os.environ["PIO_PREP_CACHE_DIR"], "prepcache")
    # the children load the kernels this run built (the package's
    # _build/); the retrain shares the prepcache phase's cache directory
    env = jl_env | {"PIO_RUN_DIR": run, "PIO_PREP_CACHE_DIR": cache_dir}
    variant = os.path.join(jl, "fleet.json")
    with open(variant, "w") as f:
        json.dump({"id": FLEET_VARIANT_ID, "engineFactory": REC_FACTORY,
                   "datasource": {"params": {"appName": "ML1M"}},
                   "algorithms": [{"name": "als", "params": {
                       "rank": INGEST_RANK, "numIterations": PREP_ITERATIONS,
                       "lambda": TRAIN_REG, "seed": 3}}]}, f)
    ev, eng, sp = free_port(), free_port(), free_port()
    # on the card every child runs on its default device; elsewhere the
    # device is named
    device_flags = [] if device.type == "cuda" else ["--device", device.type]
    flags = ["--ip", "127.0.0.1", "--no-dashboard", "--no-adminserver", "--variant", variant,
             "--event-port", str(ev), "--engine-port", str(eng), *device_flags]
    rng = np.random.default_rng(SEED + 21)
    deg = np.bincount(prep.out["rows"], minlength=nu)
    known = rng.choice(np.flatnonzero(deg > 0), size=FLEET_USERS, replace=False)
    queries = [{"user": f"u{u}", "num": 10} for u in known.tolist()]
    new_users = [f"fleet{j}" for j in range(FLEET_NEW_USERS)]
    out: dict = {"card": stats.get("smi"), "retrain_every": FLEET_RETRAIN_EVERY}
    pids: set = set()
    watch = BootWatch({"eventserver": ev, "engine": eng})
    sup = log_f = None
    saved = os.environ.get("PIO_PREP_CACHE_DIR")
    finished = False
    try:
        # the engine's first instance, and the prep-cache entry the
        # scheduled retrain splices onto
        with storage_env(jl, jl_env):
            t0 = time.perf_counter()
            try:
                if cli.main(["train", "--variant", variant, "--prep-cache-dir", cache_dir,
                             *device_flags]) != 0:
                    raise AssertionError("the fleet's first train failed")
                out["first_train_s"] = time.perf_counter() - t0
                os.environ["PIO_PREP_CACHE_DIR"] = cache_dir
                td0 = rec.RecommendationDataSource(
                    rec.DataSourceParams(app_name="ML1M")).read_training(None)
            finally:
                os.environ["PIO_PREP_CACHE_DIR"] = saved
            if td0.prep is None or td0.prep.status != "hit":
                raise AssertionError("the first train published no prep-cache entry")
            first = st.get_storage().get_metadata_engine_instances().get_latest_completed(
                FLEET_VARIANT_ID, "0", "fleet.json").id
        free0 = free_card_bytes(torch, device)

        # (1) the supervised bring-up
        watch.start()
        log_path = os.path.join(run, "supervise.out")
        log_f = open(log_path, "w")
        t_spawn = time.perf_counter()
        sup = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.cli.main", "supervise", *flags,
             "--supervise-port", str(sp), "--retrain-every", FLEET_RETRAIN_EVERY],
            cwd=ROOT, env=cli_env(jl, env), stdout=log_f, stderr=subprocess.STDOUT)
        pids.add(sup.pid)
        wait_for("the supervised fleet up", lambda: all(
            fleet_state(run).get("services", {}).get(n, {}).get("state") == "up"
            for n in ("eventserver", "engine")), 180, sup, log_path)
        out["supervised_up_s"] = time.perf_counter() - t_spawn
        if daemon.wait_ready("127.0.0.1", eng, timeout=60) is None:
            raise AssertionError("the engine is up but not ready")
        before = ask_all(eng, queries)
        status, raw = http_call(eng, "GET", "/metrics")
        k2_first = k2_tile_calls(parse_prometheus(raw))

        # (2) events through the supervised event server, before the
        # first retrain falls due: it splices them
        state = fleet_state(run)
        if state["retrain"]["runs"] or state["retrain"]["state"] != "idle":
            raise AssertionError(f"the retrain cadence fired before the events were posted: "
                                 f"{state['retrain']} (FLEET_RETRAIN_EVERY too short)")
        users = [new_users[k % FLEET_NEW_USERS] if k % 3 == 0 else f"u{int(rng.integers(0, nu))}"
                 for k in range(FLEET_EVENTS)]
        events = [{"event": "rate", "entityType": "user", "entityId": u,
                   "targetEntityType": "item", "targetEntityId": f"i{int(rng.integers(0, ni))}",
                   "properties": {"rating": float(rng.integers(1, 6))}, "eventTime": INGEST_TIME}
                  for u in users]
        for lo in range(0, FLEET_EVENTS, 1_000):
            status, raw = http_call(ev, "POST", f"/batch/events.bin?accessKey={key}",
                                    frame.encode_body(events[lo:lo + 1_000]))
            if status != 200 or json.loads(raw)["accepted"] != len(events[lo:lo + 1_000]):
                raise AssertionError(f"/batch/events.bin answered {status}: {raw[:300]!r}")
        out["posted_after_spawn_s"] = time.perf_counter() - t_spawn
        out["next_retrain_in_s_after_post"] = fleet_state(run)["retrain"]["next_in_s"]

        # (3) kill -9 of the engine child: its restart serves the same
        # instance (no retrain has finished yet) with the same bytes
        with open(os.path.join(run, "engine.pid")) as f:
            victim = int(f.read())
        old = json.loads(http_call(eng, "GET", "/healthz")[1])["instance"]
        t_kill = time.perf_counter()
        os.kill(victim, signal.SIGKILL)
        if daemon.wait_healthy("127.0.0.1", eng, timeout=120, not_instance=old) is None:
            raise AssertionError("no new engine instance in 120 s\n" + open(log_path).read()[-3000:])
        out["kill_to_healthy_s"] = time.perf_counter() - t_kill

        def first_answer():
            try:
                return http_call(eng, "POST", "/queries.json",
                                 json.dumps(queries[0]).encode(), timeout=5)[0] == 200
            except (OSError, http.client.HTTPException):
                return False

        wait_for("the restarted engine's first answer", first_answer, 120, sup, log_path)
        out["kill_to_first_answer_s"] = time.perf_counter() - t_kill
        after = ask_all(eng, queries)
        served = json.loads(http_call(eng, "GET", "/")[1])["engineInstanceId"]
        if fleet_state(run)["retrain"]["runs"] or served != first:
            raise AssertionError(f"a retrain finished before the kill -9 checks (serving "
                                 f"{served}, first {first})")
        if after != before:
            raise AssertionError("the restarted engine's answers differ from the first ones")
        out["kill_checks_done_after_spawn_s"] = time.perf_counter() - t_spawn
        state = wait_for("the engine up with one restart", lambda: (s := fleet_state(run))
                         and s["services"]["engine"]["state"] == "up"
                         and s["services"]["engine"]["restarts"] == 1 and s, 60, sup, log_path)
        if "signal 9" not in (state["services"]["engine"]["last_exit"] or ""):
            raise AssertionError(f"the engine's last exit: {state['services']['engine']}")
        status, raw = http_call(sp, "GET", "/metrics")
        restarts = parse_prometheus(raw).get('pio_supervisor_restarts_total{service="engine"}')
        if status != 200 or restarts != 1:
            raise AssertionError(f"the supervisor's /metrics: {status}, restarts {restarts}")
        out["restarts_metric"] = restarts

        # (4) the scheduled retrain: a splice of the posted events, and a
        # /reload
        t_wait = time.perf_counter()
        rt = wait_for("one scheduled retrain", lambda: (s := fleet_state(run))
                      and s.get("retrain", {}).get("runs", 0) + s.get("retrain", {}).get(
                          "failures", 0) >= 1 and s["retrain"], 240, sup, log_path)
        last = rt["last_run"]
        if not (rt["runs"] == 1 and rt["failures"] == 0 and last["ok"]
                and last["exit"] == "exit code 0" and last["reloaded"] == 1):
            raise AssertionError(f"the scheduled retrain: {rt}\n"
                                 + open(os.path.join(run, "retrain.log")).read()[-3000:])
        with open(os.path.join(run, "train_progress.json")) as f:
            progress = json.load(f)
        pids.add(progress["pid"])
        with storage_env(jl, jl_env):
            # the entry the retrain published: a hit on the same log
            os.environ["PIO_PREP_CACHE_DIR"] = cache_dir
            try:
                td = rec.RecommendationDataSource(
                    rec.DataSourceParams(app_name="ML1M")).read_training(None)
            finally:
                os.environ["PIO_PREP_CACHE_DIR"] = saved
            data = als.build_ratings_data(td.rows, td.cols, td.ratings, len(td.user_ids),
                                          len(td.item_ids),
                                          bucket_widths=rec.ALSAlgorithmParams().bucket_widths)
            per_iter = k1_launches_per_iteration(data, INGEST_RANK)
            storage = st.get_storage()
            if td.prep is None or td.prep.status != "hit":
                raise AssertionError("the retrain published no prep-cache entry")
            served = json.loads(http_call(eng, "GET", "/")[1])["engineInstanceId"]
            latest = storage.get_metadata_engine_instances().get_latest_completed(
                FLEET_VARIANT_ID, "0", "fleet.json")
            if served == first or served != latest.id:
                raise AssertionError(f"the engine serves {served}: first {first}, "
                                     f"latest {latest.id}")
            model = prepare_deploy(rec.engine(), latest, storage,
                                   WorkflowContext(device=device))[2][0]
        # what the retrain child read, from its log: every posted event,
        # spliced onto the first train's prep-cache entry
        with open(os.path.join(run, "retrain.log")) as f:
            reads = re.findall(r"read_training: (\d+) rating rows in [0-9.]+s "
                               r"\(prep cache: (\w+)\)", f.read())
        expect = len(td0.ratings) + FLEET_EVENTS
        # K1's launches as the retrain child's own counter saw them (its
        # progress file), held against its iterations x the buckets
        k1 = progress.get("k1_launches")
        k1_expect = progress["iteration"] * per_iter if device.type == "cuda" else 0
        if k1 != k1_expect:
            raise AssertionError(f"the scheduled retrain launched K1 {k1} times, expected "
                                 f"{k1_expect}: {progress}")
        if (len(reads) != 1 or reads[0] != (str(expect), "splice")
                or progress.get("prep_cache") != "splice" or progress.get("warm_start") is not True
                or len(td.ratings) != expect):
            raise AssertionError(f"the scheduled train read {reads} (expected {expect}, "
                                 f"splice; the store holds {len(td.ratings)}): {progress}")
        out["retrain"] = {
            "wall_s": last["wall_s"], "waited_after_kill_checks_s": time.perf_counter() - t_wait,
            "prep_cache": progress["prep_cache"], "iterations": progress["iteration"],
            "ratings": len(td.ratings), "k1_launches": k1,
            "k1_launches_per_iteration": per_iter, "reloaded": last["reloaded"]}
        held = queries + [{"user": u, "num": 10} for u in new_users[:10]]
        conn = http.client.HTTPConnection("127.0.0.1", eng, timeout=60)
        for q, (exp_items, exp_scores) in zip(held, expected_items(torch, model, device, held)):
            got = post(conn, q)["itemScores"]
            if not exp_items:
                raise AssertionError(f"{q['user']} is not in the retrained model")
            check_answer([x["item"] for x in got], [x["score"] for x in got],
                         exp_items, exp_scores, model, f"fleet after the reload {q}")
        conn.close()
        status, raw = http_call(eng, "GET", "/metrics")
        k2_second = k2_tile_calls(parse_prometheus(raw))

        # (4) status and status --json of the supervised fleet
        with ThreadPoolExecutor(2) as side:
            plain = side.submit(cli_run, jl, "status", env=env)
            summary = side.submit(cli_run, jl, "status", "--json", env=env)
            plain, summary = plain.result()[0], summary.result()[0]
        if "supervisor[engine]: up (restarts 1," not in plain:
            raise AssertionError(f"status: {plain[-2000:]}")
        lines = summary.strip().splitlines()
        doc = json.loads(lines[-1])
        if (len(lines) != 1 or set(doc["services"]) != {"eventserver", "engine"}
                or not all(doc["services"][n].get("metrics") for n in doc["services"])
                or doc["supervisor"]["retrain"]["runs"] < 1
                or doc["supervisor"]["services"]["engine"]["restarts"] != 1):
            raise AssertionError(f"status --json: {summary[:3000]}")
        out["status_json_bytes"] = len(lines[0])

        # (5) SIGTERM to the supervisor: the fleet stops in reverse order
        t0 = time.perf_counter()
        sup.send_signal(signal.SIGTERM)
        rc = sup.wait(timeout=120)
        out["supervisor_stop_s"] = time.perf_counter() - t0
        log_f.close()
        text = open(log_path).read()
        stopped = [ln for ln in text.splitlines() if "-> stopped" in ln]
        order = [name for ln in stopped for name in ("engine", "eventserver")
                 if f"supervisor: {name} " in ln]
        if rc != 0 or order != ["engine", "eventserver"]:
            raise AssertionError(f"the supervisor exited {rc}, stop order {order}:\n"
                                 + text[-3000:])
        out["supervised_boots"] = watch.stop()
        pids |= {b["pid"] for b in out["supervised_boots"]}
        check_fleet_gone(torch, device, run, pids, free0, "after SIGTERM to the supervisor")
        out["after_supervisor_free_delta_bytes"] = (
            None if free0 is None else free0 - free_card_bytes(torch, device))

        # (6) the daemonized fleet and a rolling restart under a keep-alive
        # query loop
        watch = BootWatch({"eventserver": ev, "engine": eng})
        watch.start()
        printed, out["start_all_s"] = cli_run(jl, "start-all", *flags, env=env)
        if "engine: up on port" not in printed:
            raise AssertionError(f"start-all printed {printed!r}")
        answers = ask_all(eng, queries)
        old = json.loads(http_call(eng, "GET", "/healthz")[1])["instance"]
        status, raw = http_call(eng, "GET", "/metrics")
        k2_daemon = k2_tile_calls(parse_prometheus(raw))
        loop = KeepAlive(eng, queries)
        low = MemoryLow(torch, device) if device.type == "cuda" else None
        free_before_roll = free_card_bytes(torch, device)
        loop.start()
        if low is not None:
            low.start()
        try:
            printed, out["rolling_restart_s"] = cli_run(jl, "rolling-restart", "engine", env=env)
            time.sleep(1.0)  # the loop goes on against the new instance alone
        finally:
            loop.stop()
            lowest = low.stop() if low is not None else None
        new = json.loads(http_call(eng, "GET", "/healthz")[1])["instance"]
        non_200 = sum(1 for _, s, _ in loop.answers if s != 200) + len(loop.errors)
        differ = sum(1 for j, s, raw in loop.answers if s == 200 and raw != answers[j])
        if non_200 or differ or new == old or "engine: rolled pid" not in printed:
            raise AssertionError(f"rolling-restart: {non_200} non-200 ({loop.errors[:3]}), "
                                 f"{differ} answers differ, instance {old} -> {new}: "
                                 f"{printed!r}")
        status, raw = http_call(eng, "GET", "/metrics")
        k2_rolled = k2_tile_calls(parse_prometheus(raw))
        out["rolling_restart"] = {
            "queries": len(loop.answers), "non_200": non_200, "reconnects": loop.reconnects,
            "answers_differ": differ, "old_instance": old, "new_instance": new,
            "overlap_extra_device_bytes": (None if lowest is None
                                           else free_before_roll - lowest)}
        printed, out["stop_all_s"] = cli_run(jl, "stop-all", env=env)
        if "engine: stopped" not in printed or "eventserver: stopped" not in printed:
            raise AssertionError(f"stop-all printed {printed!r}")
        out["daemon_boots"] = watch.stop()
        pids |= {b["pid"] for b in out["daemon_boots"]}
        for port in (ev, eng):
            try:
                with socket.create_connection(("127.0.0.1", port), timeout=0.5):
                    raise AssertionError(f"port {port} still open after stop-all")
            except OSError:
                pass
        check_fleet_gone(torch, device, run, pids, free0, "after stop-all")
        out["k2_calls"] = {"supervised_first": k2_first, "supervised_after_reload": k2_second,
                           "daemonized_old": k2_daemon, "daemonized_rolled": k2_rolled}
        # (the CPU's plain version counts no K2 call)
        if device.type == "cuda" and (min(k2_first, k2_daemon) < len(queries)
                                      or k2_second < len(held) + len(queries) + 1):
            raise AssertionError(f"K2 calls on the fleet's engines: {out['k2_calls']}")
        finished = True
    finally:
        watch.done.set()
        if sup is not None and sup.poll() is None:
            sup.kill()
            sup.wait()
        if log_f is not None:
            log_f.close()
        if not finished:  # a fleet left running by a failed check goes too
            subprocess.run([sys.executable, "-m", "predictionio_tpu_torch.cli.main",
                            "stop-all"], cwd=ROOT, env=cli_env(jl, env),
                           capture_output=True, timeout=120)
        shutil.rmtree(run, ignore_errors=True)
    stats["fleet"] = out
    # the workers phase deploys this store's newest instance
    stats["fleet_store"] = {"dir": jl, "env": jl_env, "variant": variant}
    log(json.dumps({"fleet": "ml1m jsonl", **out}))


def check_fleet_gone(torch, device, run: str, pids: set, free0, what: str) -> None:
    """No pid file left, no fleet process alive or on the card, and the
    card's free memory back to what it was before the fleet started."""
    from predictionio_tpu_torch.cli import daemon

    left = [n for n in os.listdir(run) if n.endswith(".pid")]
    alive = sorted(p for p in pids if daemon._alive(p))
    if left or alive:
        raise AssertionError(f"{what}: pid files {left}, live fleet pids {alive}")
    if device.type != "cuda":
        return
    on_card = card_pids() & pids
    # a CUDA context alone takes hundreds of MB: a fleet process that kept
    # one would show here
    gap = free0 - free_card_bytes(torch, device)
    if on_card or gap > 256 << 20:
        raise AssertionError(f"{what}: fleet pids on the card {sorted(on_card)}, "
                             f"{gap} bytes of the card still taken")


# -- phase: worker processes and the router tier ------------------------------------

WORKERS_IDENTITY = 200  # distinct users held byte for byte to one process
WORKERS_LOAD = 1_000  # distinct users a concurrency level of the q/s sweeps
WORKERS_LEVELS = (8, 64)
WORKERS_SAMPLE = 20  # answers held to K2's plain version in this process


def card_apps() -> dict:
    """{pid: MiB} of the compute processes ``nvidia-smi`` lists on the card
    (inside a container it may list them under pids of another
    namespace, or as one entry)."""
    proc = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                           "--format=csv,noheader,nounits"],
                          capture_output=True, text=True, timeout=30)
    if proc.returncode != 0:
        raise AssertionError(f"nvidia-smi --query-compute-apps: {proc.stderr}")
    out = {}
    for line in proc.stdout.splitlines():
        parts = [x.strip() for x in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit():
            out[int(parts[0])] = float(parts[1]) if parts[1].replace(".", "").isdigit() else None
    return out


def worker_pids(port: int, n: int, proc, log_path: str, timeout: float = 180) -> set:
    """Fresh connections to ``/healthz`` until ``n`` distinct pids
    answered (the kernel spreads new connections over the port's
    SO_REUSEPORT sockets; a worker binds after its warmup)."""
    from predictionio_tpu_torch.cli import daemon

    pids: set = set()

    def seen():
        doc = daemon.probe_health("127.0.0.1", port, timeout=2.0)
        if doc is not None:
            pids.add(doc["pid"])
        return len(pids) >= n

    wait_for(f"{n} workers on port {port}", seen, timeout, proc, log_path)
    return pids


def per_worker(port: int, pids: set, path: str) -> dict:
    """{pid: raw ``GET path``} of each worker: ``/healthz`` then ``path``
    on one keep-alive connection reach the same worker."""
    out: dict = {}

    def read_one():
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        try:
            status, raw = http_call(port, "GET", "/healthz", conn=conn)
            pid = json.loads(raw)["pid"]
            status, raw = http_call(port, "GET", path, conn=conn)
            if status == 200:
                out[pid] = raw
        finally:
            conn.close()
        return set(out) >= pids

    wait_for(f"every worker's {path}", read_one, 60)
    return out


def maps_lib(pid: int, lib: str) -> bool:
    """Whether process ``pid`` has mapped a shared library named ``lib``
    (``libcuda``: the CUDA driver, loaded when the process starts CUDA;
    ``libtorch``)."""
    with open(f"/proc/{pid}/maps") as f:
        return f"/{lib}" in f.read()


def fresh_answers(port: int, queries: list) -> list:
    """Each query's raw answer, each on a fresh connection; all 200."""
    out = []
    for q in queries:
        status, raw = http_call(port, "POST", "/queries.json", json.dumps(q).encode())
        if status != 200:
            raise AssertionError(f"{q} on port {port}: HTTP {status} {raw[:300]!r}")
        out.append(raw)
    return out


def qps_level(port: int, queries: list, concurrency: int, want: dict) -> dict:
    """Closed-loop q/s, p50 and p99 on distinct users, every answer held
    byte for byte to ``want`` ({user: bytes}, one process's answers)."""
    run = closed_loop(port, queries, concurrency)
    differ = [u for u, raw in run["answers"].items() if raw != want[u]]
    if differ:
        raise AssertionError(f"{len(differ)} answers on port {port} at concurrency "
                             f"{concurrency} differ from one process's, first {differ[0]}")
    lat = sorted(run["lat"])
    return {"qps": len(queries) / run["wall_s"], "p50_ms": lat[len(lat) // 2] * 1e3,
            "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))] * 1e3}


def port_free(port: int) -> bool:
    with socket.socket() as s:
        try:
            s.bind(("127.0.0.1", port))
            return True
        except OSError:
            return False


def listen_ports(n: int) -> list:
    """``n`` consecutive free ports below the kernel's ephemeral range: a
    server that binds seconds after the choice (a worker after its
    warmup, the second replica after the first's boot) cannot lose its
    port meanwhile to the local end of a client connection."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    rng = np.random.default_rng()
    for _ in range(1000):
        start = int(rng.integers(10_000, low - n))
        if all(port_free(start + i) for i in range(n)):
            return list(range(start, start + n))
    raise AssertionError(f"no {n} consecutive free ports below {low}")


def replica_k2_calls(ports: dict) -> dict:
    """{replica: K2 tile-route calls} from each replica's own /metrics."""
    from predictionio_tpu_torch.obs.metrics import parse_prometheus

    out = {}
    for name, port in ports.items():
        status, raw = http_call(port, "GET", "/metrics")
        if status != 200:
            raise AssertionError(f"{name}'s /metrics answered {status}")
        out[name] = k2_tile_calls(parse_prometheus(raw))
    return out


def router_stats(port: int) -> dict:
    status, raw = http_call(port, "GET", "/stats.json")
    if status != 200:
        raise AssertionError(f"the router's /stats.json answered {status}")
    return json.loads(raw)


@phase("workers: deploy --workers 2 on the card (pids, byte identity, K2 in each worker, q/s, "
       "kill -9); supervise --replicas 2 behind the router (kill -9 of a replica, status)")
def workers(torch, device, stats):
    """Worker processes and the router tier on the fleet phase's ML-1M
    jsonl store and its newest instance (see the module docstring)."""
    from predictionio_tpu_torch.cli import daemon
    from predictionio_tpu_torch.core.context import WorkflowContext
    from predictionio_tpu_torch.core.workflow import prepare_deploy
    from predictionio_tpu_torch.data import storage as st
    from predictionio_tpu_torch.models import recommendation as rec
    from predictionio_tpu_torch.obs.metrics import parse_prometheus

    if "fleet_store" not in stats:
        raise AssertionError("the workers phase needs the fleet phase's store")
    jl, jl_env, variant = (stats["fleet_store"][k] for k in ("dir", "env", "variant"))
    cuda = device.type == "cuda"
    with storage_env(jl, jl_env):
        storage = st.get_storage()
        inst = storage.get_metadata_engine_instances().get_latest_completed(
            FLEET_VARIANT_ID, "0", "fleet.json")
        model = prepare_deploy(rec.engine(), inst, storage, WorkflowContext(device=device))[2][0]
    rng = np.random.default_rng(SEED + 22)
    users = sorted(model.user_index.keys())
    picked = rng.choice(len(users), size=WORKERS_IDENTITY + len(WORKERS_LEVELS) * WORKERS_LOAD,
                        replace=False)
    queries = [{"user": users[int(j)], "num": 10} for j in picked]
    ident, load = queries[:WORKERS_IDENTITY], queries[WORKERS_IDENTITY:]
    load = {c: load[i * WORKERS_LOAD:(i + 1) * WORKERS_LOAD]
            for i, c in enumerate(WORKERS_LEVELS)}
    out: dict = {"card": stats.get("smi"), "instance": inst.id}
    run = tempfile.mkdtemp(prefix="pio_chip_smoke_workers_")
    env = jl_env | {"PIO_RUN_DIR": run}
    free0 = free_card_bytes(torch, device)
    single = parent = sup = log_f = sup_log = watch = None
    pids: set = set()
    finished = False
    try:
        # (a) one process and a set of two workers of the same instance,
        # started together
        port, = listen_ports(1)
        log_path = os.path.join(run, "workers.log")
        log_f = open(log_path, "w")
        t_spawn = time.perf_counter()
        single = DeployProcess(jl, inst.id, device.type, [], "single", env_extra=jl_env,
                               wait=False)
        parent = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.cli.main", "deploy",
             "--engine-instance-id", inst.id, "--device", device.type, "--ip", "127.0.0.1",
             "--port", str(port), "--workers", "2"],
            cwd=ROOT, env=cli_env(jl, jl_env), stdout=log_f, stderr=subprocess.STDOUT)
        pids |= {parent.pid, single.proc.pid}
        wpids = worker_pids(port, 2, parent, log_path)
        out["workers_up_s"] = time.perf_counter() - t_spawn
        out["single_ready_s"] = single.wait_ready()
        pids |= wpids
        if parent.pid in wpids:
            raise AssertionError(f"the parent {parent.pid} answered as a worker")
        out["worker_pids"], out["parent_pid"] = sorted(wpids), parent.pid
        # the parent holds neither torch nor a CUDA context; each worker
        # has started CUDA and holds the model in its own allocator
        if maps_lib(parent.pid, "libtorch") or maps_lib(parent.pid, "libcuda"):
            raise AssertionError(f"the worker set's parent {parent.pid} loaded torch or CUDA")
        docs = {p: json.loads(raw)["device"]
                for p, raw in per_worker(port, wpids, "/stats.json").items()}
        out["workers_device_in_use"] = {}
        for p, doc in docs.items():
            mem = doc["devices"][0]["memory"]
            if cuda and (not maps_lib(p, "libcuda") or not mem or mem["in_use"] <= 0):
                raise AssertionError(f"worker {p} holds no CUDA context or model: {doc}")
            out["workers_device_in_use"][str(p)] = mem["in_use"] if mem else None
        if cuda:
            # what nvidia-smi lists, as it lists it
            out["nvidia_smi_compute_apps_mib"] = {str(k): v for k, v in card_apps().items()}

        # byte identity over fresh connections, and a sample against K2's
        # plain version here
        want = dict(zip((q["user"] for q in ident), fresh_answers(single.port, ident)))
        got = fresh_answers(port, ident)
        differ = [q["user"] for q, raw in zip(ident, got) if raw != want[q["user"]]]
        if differ:
            raise AssertionError(f"{len(differ)} of {len(ident)} worker answers differ from one "
                                 f"process's, first {differ[0]}")
        sample = ident[:WORKERS_SAMPLE]
        for q, raw, (exp_items, exp_scores) in zip(
                sample, got, expected_items(torch, model, device, sample)):
            items = json.loads(raw)["itemScores"]
            check_answer([x["item"] for x in items], [x["score"] for x in items],
                         exp_items, exp_scores, model, f"worker answer {q}")
        out["identity_queries"] = len(ident)

        # q/s of one process and of the two workers, on the same users
        for qs in load.values():
            want.update(zip((q["user"] for q in qs), ask_all(single.port, qs)))
        out["qps"] = {
            "single": {c: qps_level(single.port, qs, c, want) for c, qs in load.items()},
            "workers": {c: qps_level(port, qs, c, want) for c, qs in load.items()}}

        # K2 in each worker, read from the worker's own /metrics
        sent = len(ident) + sum(len(qs) for qs in load.values())
        k2 = {pid: k2_tile_calls(parse_prometheus(raw))
              for pid, raw in per_worker(port, wpids, "/metrics").items()}
        out["workers_k2_calls"] = [k2[p] for p in sorted(wpids)]
        out["workers_queries"] = sent
        # one warmup call a worker; the CPU's plain version counts none
        if cuda and (min(k2.values()) < 1 or sum(k2.values()) != sent + len(wpids)):
            raise AssertionError(f"K2 calls by worker {k2}: expected {sent} queries + "
                                 f"{len(wpids)} warmups, each worker some")
        out["single_stop_rc"] = single.stop()
        if cuda:
            # the card's memory the two workers' contexts and models take
            held = free0 - free_card_bytes(torch, device)
            out["workers_card_bytes"] = held
            if held < 2 * (256 << 20):
                raise AssertionError(f"the two workers hold {held} bytes of the card: "
                                     "less than two CUDA contexts")

        # kill -9 of one worker: the parent exits nonzero and stops the other
        victim, other = sorted(wpids)
        t_kill = time.perf_counter()
        os.kill(victim, signal.SIGKILL)
        rc = parent.wait(timeout=60)
        out["kill"] = {"parent_rc": rc, "parent_exit_s": time.perf_counter() - t_kill}
        if rc == 0:
            raise AssertionError("the worker set's parent exited 0 after a worker's kill -9")
        wait_for("the other worker gone", lambda: not daemon._alive(other), 30)
        log_f.close()
        log_f = None
        check_fleet_gone(torch, device, run, pids, free0, "after the worker set ended")

        # (b) the replica set behind the router, supervised
        ev, eng, _, rp = listen_ports(4)  # engine-0 and engine-1 on eng, eng + 1
        device_flags = [] if cuda else ["--device", device.type]
        sup_path = os.path.join(run, "supervise.out")
        sup_log = open(sup_path, "w")
        watch = BootWatch({"eventserver": ev, "engine-0": eng, "engine-1": eng + 1,
                           "router": rp})
        watch.start()
        t_spawn = time.perf_counter()
        sup = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.cli.main", "supervise", "--ip",
             "127.0.0.1", "--no-dashboard", "--no-adminserver", "--variant", variant,
             "--event-port", str(ev), "--engine-port", str(eng), "--router-port", str(rp),
             "--replicas", "2", *device_flags],
            cwd=ROOT, env=cli_env(jl, env), stdout=sup_log, stderr=subprocess.STDOUT)
        pids.add(sup.pid)
        names = ("eventserver", "engine-0", "engine-1", "router")
        wait_for("the replica set up", lambda: all(
            fleet_state(run).get("services", {}).get(n, {}).get("state") == "up"
            for n in names), 240, sup, sup_path)
        wait_for("both replicas admitted", lambda: all(
            r["state"] == "ready" for r in router_stats(rp)["replicas"].values()), 60,
            sup, sup_path)
        out["replica_set_up_s"] = time.perf_counter() - t_spawn
        via = fresh_answers(rp, ident)
        direct = {0: [], 1: []}
        for i, q in enumerate(ident):
            direct[i % 2].append(q)
        straight = {r: ask_all(eng + r, qs) for r, qs in direct.items()}
        for r, qs in direct.items():
            for q, raw in zip(qs, straight[r]):
                if raw != want[q["user"]]:
                    raise AssertionError(f"engine-{r}'s answer to {q} differs from one process's")
        differ = [q["user"] for q, raw in zip(ident, via) if raw != want[q["user"]]]
        if differ:
            raise AssertionError(f"{len(differ)} routed answers differ, first {differ[0]}")
        out["qps"]["router"] = {c: qps_level(rp, qs, c, want) for c, qs in load.items()}
        reps = router_stats(rp)["replicas"]
        if not all(r["requests"] > 0 for r in reps.values()):
            raise AssertionError(f"a replica took no routed query: {reps}")
        before = {n: r["requests"] for n, r in reps.items()}
        for _ in range(10):
            status, raw = http_call(rp, "POST", "/queries.json", json.dumps(ident[0]).encode())
            if status != 200 or raw != want[ident[0]["user"]]:
                raise AssertionError(f"a repeated routed query: HTTP {status} {raw[:300]!r}")
        moved = {n: r["requests"] - before[n] for n, r in router_stats(rp)["replicas"].items()}
        if 10 not in moved.values():
            raise AssertionError(f"a repeated query moved between replicas: {moved}")
        out["affinity_repeat"] = moved
        # K2 in each replica: its own /metrics against the router's attempts
        # on it, the straight queries and its warmup
        time.sleep(0.5)  # an abandoned hedge attempt finishes on its replica
        reps = router_stats(rp)["replicas"]
        replica_ports = {"engine-0": eng, "engine-1": eng + 1}
        k2_before = replica_k2_calls(replica_ports)
        expect = {f"engine-{r}": reps[f"engine-{r}"]["requests"] + len(direct[r]) + 1
                  for r in (0, 1)}
        if cuda and k2_before != expect:
            raise AssertionError(f"K2 calls by replica {k2_before}, expected {expect} "
                                 "(the router's attempts, the straight queries, a warmup)")

        # kill -9 of engine-0 under a keep-alive loop through the router
        loop_qs = ident[:50]
        loop = KeepAlive(rp, loop_qs)
        loop.start()
        time.sleep(0.5)
        with open(os.path.join(run, "engine-0.pid")) as f:
            victim = int(f.read())
        old = json.loads(http_call(eng, "GET", "/healthz")[1])["instance"]
        t_kill = time.perf_counter()
        os.kill(victim, signal.SIGKILL)
        new = wait_for("a new engine-0", lambda: (d := daemon.probe_health(
            "127.0.0.1", eng, timeout=0.5)) and d["instance"] != old and d, 180, sup, sup_path)
        t_healthy = time.perf_counter() - t_kill
        admitted = wait_for("the router admitting the new engine-0", lambda: (
            r := router_stats(rp)["replicas"]["engine-0"])["state"] == "ready"
            and r["instance"] == new["instance"] and r, 60, sup, sup_path)
        t_admit = time.perf_counter() - t_kill
        time.sleep(1.0)  # the loop goes on against the re-admitted replica
        loop.stop()
        pids.add(new["pid"])
        non_200 = sum(1 for _, s, _ in loop.answers if s != 200) + len(loop.errors)
        differ = sum(1 for j, s, raw in loop.answers
                     if s == 200 and raw != want[loop_qs[j]["user"]])
        doc = router_stats(rp)
        retried = doc["routing"]["retries"] + doc["replicas"]["engine-0"]["ejections"]
        out["replica_kill"] = {
            "queries": len(loop.answers), "non_200": non_200, "answers_differ": differ,
            "reconnects": loop.reconnects, "kill_to_healthy_s": t_healthy,
            "kill_to_readmitted_s": t_admit, "retries": doc["routing"]["retries"],
            "ejections": doc["replicas"]["engine-0"]["ejections"],
            "hedges": doc["routing"]["hedges"], "old_instance": old,
            "new_instance": admitted["instance"]}
        if non_200 or differ or retried < 1:
            raise AssertionError(f"the router across engine-0's kill -9: {out['replica_kill']}, "
                                 f"errors {loop.errors[:3]}")
        state = fleet_state(run)["services"]["engine-0"]
        if state["restarts"] != 1 or "signal 9" not in (state["last_exit"] or ""):
            raise AssertionError(f"the supervisor's engine-0: {state}")
        # the restarted replica's K2 (the loop's queries since it was
        # admitted) and the survivor's
        k2_after = replica_k2_calls(replica_ports)
        out["replica_k2_calls"] = {"before_kill": k2_before, "after_readmission": k2_after}
        if cuda and (min(k2_after.values()) < 1
                     or k2_after["engine-1"] <= k2_before["engine-1"]):
            raise AssertionError(f"K2 calls by replica: {out['replica_k2_calls']}")

        # status and status --json of the replica set
        with ThreadPoolExecutor(2) as side:
            plain = side.submit(cli_run, jl, "status", env=env)
            summary = side.submit(cli_run, jl, "status", "--json", env=env)
            plain, summary = plain.result()[0], summary.result()[0]
        for line in ("replica[router/engine-0]: ready", "replica[router/engine-1]: ready",
                     "supervisor[engine-0]: up (restarts 1,", "supervisor[router]: up"):
            if line not in plain:
                raise AssertionError(f"status lacks {line!r}: {plain[-3000:]}")
        lines = summary.strip().splitlines()
        sdoc = json.loads(lines[-1])
        if (len(lines) != 1 or set(sdoc["services"]) != set(names)
                or set(sdoc["services"]["router"]["stats"]["replicas"]) != {"engine-0", "engine-1"}
                or sdoc["supervisor"]["services"]["engine-0"]["restarts"] != 1):
            raise AssertionError(f"status --json: {summary[:3000]}")
        out["status_json_bytes"] = len(lines[0])
        # host-only children: scraped by status --json, still without torch
        for name in ("router", "eventserver"):
            with open(os.path.join(run, f"{name}.pid")) as f:
                if maps_lib(int(f.read()), "libtorch"):
                    raise AssertionError(f"the {name} child loaded torch")

        # SIGTERM to the supervisor: nothing of the replica set is left
        t0 = time.perf_counter()
        sup.send_signal(signal.SIGTERM)
        rc = sup.wait(timeout=120)
        out["supervisor_stop_s"] = time.perf_counter() - t0
        out["boots"] = watch.stop()
        pids |= {b["pid"] for b in out["boots"]}
        if rc != 0:
            raise AssertionError(f"the supervisor exited {rc}:\n" + open(sup_path).read()[-3000:])
        check_fleet_gone(torch, device, run, pids, free0, "after SIGTERM to the supervisor")
        finished = True
    finally:
        if watch is not None:
            watch.done.set()
        for f in (log_f, sup_log):
            if f is not None:
                f.close()
        if parent is not None and parent.poll() is None:
            parent.terminate()  # the parent forwards it to its workers
            try:
                parent.wait(timeout=60)
            except subprocess.TimeoutExpired:
                parent.kill()
                parent.wait()
        if sup is not None and sup.poll() is None:
            sup.kill()
            sup.wait()
        if single is not None and single.proc.poll() is None:
            single.stop()
        if not finished:  # children a failed check left behind go too
            if sup is not None:  # the supervisor's daemons outlive its kill
                subprocess.run([sys.executable, "-m", "predictionio_tpu_torch.cli.main",
                                "stop-all"], cwd=ROOT, env=cli_env(jl, env),
                               capture_output=True, timeout=120)
            for pid in pids:
                with contextlib.suppress(OSError):
                    os.kill(pid, signal.SIGKILL)
            for name in sorted(os.listdir(run)):
                if name.endswith(".log"):
                    with open(os.path.join(run, name)) as f:
                        log(f"-- {name}, its end:\n{f.read()[-2000:]}")
        shutil.rmtree(run, ignore_errors=True)
    stats["workers"] = out
    log(json.dumps({"workers": "ml1m jsonl", **out}))


# -- phase: full width -------------------------------------------------------------


@phase("train at full width: ML-20M shape, rank 20, run_train -> deploy")
def full_width(torch, device, stats):
    """The generated ML-20M-shaped ratings through ``run_train`` (2
    iterations, f32 storage) -- K1's counter reset just before and read
    just after: the main path's launches, 2 x the route's launches per
    iteration (k1_launches_per_iteration) -- persisted, deployed and
    queried. Then 1 iteration with K1 against 1 with its plain version
    from the same init: factors within rtol 5e-4 / atol 5e-5
    (tests/test_als.py:188) and train RMSE within 1e-4 relative."""
    from predictionio_tpu_torch.cli import main as cli
    from predictionio_tpu_torch.core import DataSource, Engine, FirstServing
    from predictionio_tpu_torch.core.context import WorkflowContext
    from predictionio_tpu_torch.core.workflow import run_train
    from predictionio_tpu_torch.data import storage as st
    from predictionio_tpu_torch.models import recommendation as rec
    from predictionio_tpu_torch.ops import als

    t0 = time.perf_counter()
    if "ml20m_arrays" not in stats:  # the k6 phase may have drawn them
        stats["ml20m_arrays"] = make_ml_shaped("20m")
    rows, cols, vals, nu, ni = stats["ml20m_arrays"]
    log(f"ML-20M-shaped ratings ready ({len(vals)}) in {time.perf_counter() - t0:.1f}s")
    td = rec.TrainingData(user_ids=[f"u{j}" for j in range(nu)],
                          item_ids=[f"i{j}" for j in range(ni)],
                          rows=rows, cols=cols, ratings=vals)

    class GeneratedSource(DataSource):
        params_class = rec.DataSourceParams

        def read_training(self, ctx):
            return td

    engine = Engine(GeneratedSource, rec.RecommendationPreparator,
                    {"als": rec.ALSAlgorithm}, FirstServing)
    ep = engine.params_from_variant({
        "datasource": {"params": {"appName": "ML20M"}},
        "algorithms": [{"name": "als", "params": {
            "rank": 20, "numIterations": 2, "lambda": TRAIN_REG, "seed": 3}}]})
    basedir = tempfile.mkdtemp(prefix="pio_chip_smoke_ml20m_")
    storage = st.Storage(env={"PIO_FS_BASEDIR": basedir})
    st.set_storage(storage)
    server = None
    try:
        als.solve_bucket.launches.reset()  # the main path starts here
        t0 = time.perf_counter()
        iid = run_train(engine, ep, engine_id="chip-smoke-ml20m",
                        engine_factory="predictionio_tpu_torch.models.recommendation.engine",
                        storage=storage, ctx=WorkflowContext(mode="Training", device="cuda"))
        train_s = time.perf_counter() - t0
        stats["k1_launches"] = als.solve_bucket.launches.value  # main path read
        server = cli.deploy_server(cli.build_parser().parse_args([
            "deploy", "--engine-instance-id", iid, "--ip", "127.0.0.1", "--port", "0"]))
        server.warmup()
        port = server.start(background=True)
        model = server.models[0]
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        queries = [{"user": "u0", "num": 4}, {"user": "u138492", "num": 20},
                   {"user": "u4242", "num": 4}]
        for q, (exp_items, exp_scores) in zip(
                queries, expected_items(torch, model, device, queries)):
            got = post(conn, q)["itemScores"]
            check_answer([x["item"] for x in got], [x["score"] for x in got],
                         exp_items, exp_scores, model, f"ml20m {q}")
        conn.close()
        U, V = model.device_factors(device)
        rmse_2 = als.rmse(U, V, rows, cols, vals)
    finally:
        if server is not None:
            server.stop()
        st.set_storage(None)
        storage.close()
        shutil.rmtree(basedir, ignore_errors=True)

    t0 = time.perf_counter()
    data = als.build_ratings_data(rows, cols, vals, nu, ni)
    log(f"bucket layout in {time.perf_counter() - t0:.1f}s: " + ", ".join(
        f"{side} K={b.width} B={b.col_ids.shape[0]} R={len(b.row_ids)}"
        for side, bs in (("user", data.row_buckets), ("item", data.col_buckets))
        for b in bs))
    per_iter = k1_launches_per_iteration(data, 20)
    if stats["k1_launches"] != 2 * per_iter:
        raise AssertionError(f"K1 launched {stats['k1_launches']} times on the main "
                             f"path, expected 2 iterations x {per_iter} launches")
    params = als.ALSParams(rank=20, iterations=1, reg=TRAIN_REG, seed=3)
    Uk, Vk = als.als_train(data, params, device=device)
    Up, Vp = plain_iteration(torch, data, params, device)
    torch.cuda.synchronize()
    diffs = {}
    for name, a, b in (("U", Uk, Up), ("V", Vk, Vp)):
        err = float((a - b).abs().max())
        diffs[f"{name}_max_abs_diff"] = err
        diffs[f"{name}_rows_bit_equal"] = float((a == b).all(dim=1).float().mean())
        stats["k1_max_abs_err"] = max(stats.get("k1_max_abs_err", 0.0), err)
        if not torch.allclose(a, b, rtol=5e-4, atol=5e-5):
            raise AssertionError(f"1 iteration: {name} differs from the plain "
                                 f"version (max abs {err})")
    e_k = als.rmse(Uk, Vk, rows, cols, vals)
    e_p = als.rmse(Up, Vp, rows, cols, vals)
    if abs(e_k - e_p) > 1e-4 * e_p:
        raise AssertionError(f"1 iteration: train RMSE {e_k} vs plain {e_p}")
    stats["ml20m"] = data
    stats["full_width"] = {"train_s": train_s, "iterations": 2, "rmse_2_iterations": rmse_2,
                           "rmse_1_iteration": e_k, "rmse_1_iteration_plain": e_p,
                           "k1_launches": stats["k1_launches"], **diffs}
    log(json.dumps({"full_width": "ml20m rank 20 f32", **stats["full_width"]}))


# -- the checkpointed training and the speed layer ------------------------------


def same_storage_table(torch, a, b) -> bool:
    """Two storage-form tables (a tensor or the int8 pair) bit for bit."""
    if isinstance(a, tuple) != isinstance(b, tuple):
        return False
    if isinstance(a, tuple):
        return bool(torch.equal(a[0], b[0])) and same_bits(torch, a[1], b[1])
    return same_bits(torch, a, b)


@phase("ckpt: checkpointed training at ML-20M shape, rank 20")
def checkpointed(torch, device, stats):
    """``als_train`` on the train phase's ML-20M layout at rank 20, 4
    iterations, f32 and int8 storage: one shot, checkpointed every
    iteration, and checkpointed every 2 (which leaves the iteration-2
    snapshot) then resumed from it to 4. All four runs' tables bit for
    bit on the card; the checkpoint write seconds
    (``pio_checkpoint_write_seconds``) and bytes."""
    from predictionio_tpu_torch.core import checkpoint as ckpt
    from predictionio_tpu_torch.obs import metrics as obs_metrics
    from predictionio_tpu_torch.ops import als

    data = stats["ml20m"]
    hist = obs_metrics.histogram("pio_checkpoint_write_seconds",
                                 "Wall time of one checkpoint write")
    out = {}
    for storage in ("float32", "int8"):
        params = als.ALSParams(rank=20, iterations=4, reg=TRAIN_REG, seed=3,
                               storage_dtype=storage)
        basedir = tempfile.mkdtemp(prefix="pio_chip_smoke_ckpt_")
        try:
            def cfg(**kw):
                return ckpt.CheckpointConfig(directory=basedir, **kw)

            t0 = time.perf_counter()
            U0, V0 = als.als_train(data, params, device=device, checkpoint_cfg=cfg())
            one_shot_s = time.perf_counter() - t0
            _, s0, n0 = hist.merged()
            t0 = time.perf_counter()
            U1, V1 = als.als_train(data, params, device=device, checkpoint_cfg=cfg(every=1))
            every1_s = time.perf_counter() - t0
            _, s1, n1 = hist.merged()
            if n1 - n0 != 3:
                raise AssertionError(f"{storage}: {n1 - n0} checkpoint writes, expected 3")
            U2, V2 = als.als_train(data, params, device=device, checkpoint_cfg=cfg(every=2))
            fp = ckpt.data_fingerprint(data.rows, data.cols, data.vals, params)
            snap = ckpt.load_checkpoint(cfg(), fp)
            if snap is None or snap.iteration != 2:
                raise AssertionError(f"{storage}: no iteration-2 snapshot ({snap})")
            nbytes = os.path.getsize(ckpt.checkpoint_path(cfg(), fp))
            t0 = time.perf_counter()
            U3, V3 = als.als_train(data, params, device=device,
                                   checkpoint_cfg=cfg(resume=True))
            resume_s = time.perf_counter() - t0
            if als.LAST_TRAIN_INFO["iterations_run"] != 2:
                raise AssertionError(f"{storage}: resumed {als.LAST_TRAIN_INFO}")
        finally:
            shutil.rmtree(basedir, ignore_errors=True)
        for what, (U, V) in (("every 1", (U1, V1)), ("every 2", (U2, V2)),
                             ("resumed from 2", (U3, V3))):
            if not (same_storage_table(torch, U, U0) and same_storage_table(torch, V, V0)):
                raise AssertionError(f"{storage}: {what} differs from the one-shot run")
        out[storage] = {"one_shot_s": one_shot_s, "every1_s": every1_s, "resume_s": resume_s,
                        "write_s_mean": (s1 - s0) / (n1 - n0), "file_bytes": nbytes,
                        "bit_identical": True}
        if storage == "float32":
            stats["ckpt_tables"] = (als.host_factors(U0)[0], als.host_factors(V0)[0])
    stats["ckpt"] = out
    log(json.dumps({"ckpt": "ml20m rank 20, 4 iterations", **out}))


RT_NEW_USERS, RT_NEW_RATINGS = 200, 20  # new users x ratings each
RT_KNOWN = 50  # known users with new ratings, the heaviest among them
RT_COLD = 10  # unseen items rated
RT_INTERVAL = 0.5  # deploy --realtime SECONDS
RT_P50_QUERIES = 600
RT_HEAVY = ML_SCALES["20m"][3]  # MovieLens-20M's heaviest user: 9,254 items


def realtime_events(Event, rng, nu: int, ni: int, known: list, t0: float) -> list:
    """The phase's new events: RT_NEW_USERS new users x RT_NEW_RATINGS
    ratings of known items, 5 new ratings for each of ``known``, and
    ratings of RT_COLD unseen items (some by new, some by known users)."""
    out = []

    def rate(u, i, v):
        out.append(Event(event="rate", entity_type="user", entity_id=u,
                         target_entity_type="item", target_entity_id=i,
                         properties={"rating": float(v)}))

    for j in range(RT_NEW_USERS):
        for i in rng.choice(ni, size=RT_NEW_RATINGS, replace=False):
            rate(f"new{j}", f"i{int(i)}", rng.integers(1, 6))
    for u in known:
        for i in rng.choice(ni, size=5, replace=False):
            rate(f"u{u}", f"i{int(i)}", rng.integers(1, 6))
    for c in range(RT_COLD):
        rate(f"new{c}", f"cold{c}", 5)
        rate(f"u{known[c]}", f"cold{c}", 4)
    return out


def rt_stats(server) -> dict:
    status, body = server.get("/stats.json")
    if status != 200:
        raise AssertionError(f"/stats.json answered {status}")
    return json.loads(body)


def wait_folded(server, epoch: int, what: str, timeout: float = 120.0,
                folded: int = 0) -> dict:
    """/stats.json until the fold-in epoch passed ``epoch``, nothing is
    behind and at least ``folded`` rating events were folded (when the
    lines take more than one fold, the last poll leaves nothing behind
    before its fold lands)."""
    deadline = time.perf_counter() + timeout
    while True:
        rt = rt_stats(server)["realtime"]
        if (rt["foldin_epoch"] > epoch and rt["events_behind"] == 0
                and rt["events_folded"] >= folded):
            return rt
        if time.perf_counter() > deadline:
            raise AssertionError(f"{what}: not folded in {timeout} s: {rt}\n"
                                 + server.log_tail())
        time.sleep(0.1)


def fold_k1_checks(torch, als, foldin_mod, V, pairs, reg: float, stats) -> dict:
    """K1 on every group of the fold's grouped layout against its plain
    version (per_solve_ok), the grouped rows bit for bit against K1 on the
    JAX package's one padded bucket, and times: K1 on all groups (one
    fold's launches, queued CUDA events), each group alone, the heaviest
    group, the plain version and the library yardstick, beside the bound."""
    import types

    mem_rate, fp32_rate = peaks(stats["device_name"])
    D = als.table_dim(V)
    groups = []
    for rows, c, r, m in foldin_mod.grouped_buckets(pairs):
        b = types.SimpleNamespace(
            col_ids=torch.from_numpy(c).to(device=V.device),
            ratings=torch.from_numpy(r).to(device=V.device),
            mask=torch.from_numpy(m).to(device=V.device),
            row_ids=torch.arange(len(rows), dtype=torch.int32, device=V.device))
        groups.append((rows, b))
    x_group, err = {}, 0.0
    for rows, b in groups:
        x = als.solve_bucket_explicit(V, b.col_ids, b.ratings, b.mask, reg)
        ref = als.solve_bucket_reference(V, b.col_ids, b.ratings, b.mask, reg)
        if not per_solve_ok(torch, x, ref):
            raise AssertionError(f"fold group K={b.col_ids.shape[1]}: K1 vs plain "
                                 f"{float((x - ref).abs().max())}")
        err = max(err, float((x - ref).abs().max()))
        x_group[b.col_ids.shape[1]] = (rows, x)
    c, r, m = (torch.from_numpy(a).to(V.device) for a in foldin_mod.padded_bucket(pairs))
    x_pad = als.solve_bucket_explicit(V, c, r, m, reg)
    for K, (rows, x) in x_group.items():
        if not same_bits(torch, x, x_pad[torch.from_numpy(rows).to(V.device)]):
            raise AssertionError(f"fold group K={K}: not bit-equal to the padded bucket")
    padded_shape = tuple(c.shape)
    del c, r, m, x_pad

    def kernel_all():
        for _, b in groups:
            als.solve_bucket_explicit(V, b.col_ids, b.ratings, b.mask, reg)

    def plain_all():
        for _, b in groups:
            als.solve_bucket_reference(V, b.col_ids, b.ratings, b.mask, reg)

    def library_all():
        for _, b in groups:
            library_solve(torch, V, b, None, reg)

    launches = sum(als.k1_launches(D, len(rows), len(rows)) for rows, _ in groups)
    clocks = clock_readings(torch, kernel_all, launches)
    per_group = []
    nbytes = flops = 0
    for rows, b in groups:
        _, nb, fl = k1_bound(torch, b, D, 4, 0)
        nbytes += nb
        flops += fl

        def one(b=b):
            als.solve_bucket_explicit(V, b.col_ids, b.ratings, b.mask, reg)

        per_group.append({"K": b.col_ids.shape[1], "rows": len(rows),
                          "live": int(b.mask.sum()),
                          "ms": cuda_median_ms(torch, one, runs=10, warmup=3),
                          "bound_ms": max(nb / mem_rate, fl / fp32_rate) * 1e3})
    return {
        "groups": per_group, "launches_per_fold": launches, "max_abs_err": err,
        "padded_shape": padded_shape, "grouped_bit_equal_padded": True,
        "ms": clocks["queued_ms"], "events_ms": clocks["events_ms"],
        "profiler_ms": clocks["device_ms"], "host_ms": clocks["host_ms"],
        "plain_ms": cuda_median_ms(torch, plain_all, runs=5, warmup=2),
        "library_ms": cuda_median_ms(torch, library_all, runs=5, warmup=2),
        "bound_ms": max(nbytes / mem_rate, flops / fp32_rate) * 1e3,
        "bound_by": "bytes" if nbytes / mem_rate >= flops / fp32_rate else "operations",
        "heavy_ms": per_group[-1]["ms"], "heavy_K": per_group[-1]["K"],
    }


def check_folded_answers(torch, model, V, users, pairs, port: int, device) -> None:
    """Every folded user's ``POST /queries.json`` answer (num 10) against
    K1's fold of the user (its rows solved here, on the fold's grouped
    layout) plus the plain top-k."""
    from predictionio_tpu_torch.ops import als, topk
    from predictionio_tpu_torch.realtime import foldin as foldin_mod

    x = torch.empty((len(pairs), als.table_dim(V)), dtype=torch.float32, device=device)
    for rws, c, r, m in foldin_mod.grouped_buckets(pairs):
        x[torch.from_numpy(rws).to(device)] = als.solve_bucket_explicit(
            V, c, r, m, TRAIN_REG)
    s_exp, i_exp = topk.gather_top_k_batch_reference(
        torch.arange(len(users), device=device), x, V, 16)
    s_exp, i_exp = host(s_exp)[:, :10], host(i_exp)[:, :10]
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    inv = model.item_index.inverse
    try:
        for j, u in enumerate(users):
            got = post(conn, {"user": u, "num": 10})["itemScores"]
            check_answer([g["item"] for g in got], [g["score"] for g in got],
                         [inv[int(i)] for i in i_exp[j]], s_exp[j], model,
                         f"folded user {u}")
    finally:
        conn.close()


@phase("realtime: deploy --realtime on sqlite, fold-in on K1 (ML-20M shape)")
def realtime_serving(torch, device, stats):
    """The ckpt phase's f32 ML-20M rank-20 model saved in a sqlite store
    whose app holds the histories of RT_KNOWN known users (the heaviest,
    9,254 ratings, among them), deployed by ``cli.main deploy --realtime
    0.5`` in a subprocess. Then, in one sqlite commit, RT_NEW_USERS new
    users x RT_NEW_RATINGS ratings, 5 new ratings for each known user and
    ratings of RT_COLD unseen items (the heaviest user's history holds
    RT_HEAVY distinct items): ``/stats.json`` must show the fold-in
    epoch advanced with nothing behind. Each new and touched user's
    ``POST /queries.json`` answer must equal K1's fold of the user (held
    to the plain fold by the per-solve bar) plus the plain top-k; the
    fold's K1 launches are read from the server's ``/metrics``
    (``pio_k1_kernel_launches``, 0 at its start: the main path's count)
    and must be one fold's grouped launches; every group's K1 is held
    against its plain version and the grouped layout bit for bit against
    K1 on the JAX package's one padded bucket (the heaviest user makes K =
    16,384). Times: ``pio_foldin_solve_seconds`` per fold, K1 per fold
    against its bound, plain version and library yardstick, the heaviest
    group alone, and HTTP p50 at concurrency 1 idle (before the new
    events, and again after the busy window) and with the speed layer
    folding a trickle of events."""
    from predictionio_tpu_torch.core.workflow import save_instance
    from predictionio_tpu_torch.data import storage as st
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.models import recommendation as rec
    from predictionio_tpu_torch.ops import als, topk
    from predictionio_tpu_torch.realtime import foldin as foldin_mod

    rows, cols, vals, nu, ni = stats["ml20m_arrays"]
    uf, vf = stats["ckpt_tables"]
    model = rec.model_from_numpy([f"u{j}" for j in range(nu)], [f"i{j}" for j in range(ni)],
                                 uf, vf)
    rng = np.random.default_rng(SEED + 15)
    deg = np.bincount(rows, minlength=nu)
    heavy = int(np.argmax(deg))
    known = [heavy] + [int(u) for u in rng.choice(np.flatnonzero((deg > 0) & (deg < 2048)),
                                                  size=RT_KNOWN - 1, replace=False)]
    basedir = tempfile.mkdtemp(prefix="pio_chip_smoke_rt_")
    storage = st.Storage(env={"PIO_FS_BASEDIR": basedir})
    server = None
    try:
        app_id = storage.get_metadata_apps().insert(st.App(0, "ML20M"))
        events = storage.get_events()
        events.init(app_id)
        order = np.argsort(rows, kind="stable")
        starts = np.searchsorted(rows[order], known)
        ends = np.searchsorted(rows[order], known, side="right")
        history = [Event(event="rate", entity_type="user", entity_id=f"u{u}",
                         target_entity_type="item", target_entity_id=f"i{int(cols[k])}",
                         properties={"rating": float(vals[k])})
                   for u, a, b in zip(known, starts, ends) for k in order[a:b]]
        # the generator draws ratings with replacement, so the heaviest
        # user's 9,497 ratings name ~4,900 distinct items: topped up here
        # to MovieLens-20M's 9,254 distinct ones, its fold row is K = 16,384
        seen = {int(cols[k]) for k in order[starts[0]:ends[0]]}
        extra = rng.choice(np.setdiff1d(np.arange(ni), list(seen)),
                           size=max(0, RT_HEAVY - len(seen)), replace=False)
        history += [Event(event="rate", entity_type="user", entity_id=f"u{heavy}",
                          target_entity_type="item", target_entity_id=f"i{int(i)}",
                          properties={"rating": float(rng.integers(1, 6))})
                    for i in extra]
        events.batch_insert(history, app_id)
        engine = rec.engine()
        ep = engine.params_from_variant({
            "datasource": {"params": {"appName": "ML20M"}},
            "algorithms": [{"name": "als", "params": {
                "rank": 20, "numIterations": 4, "lambda": TRAIN_REG, "seed": 3}}]})
        iid = save_instance(engine, ep, [model], engine_id="chip-smoke-rt",
                            engine_variant="rt",
                            engine_factory="predictionio_tpu_torch.models.recommendation.engine",
                            storage=storage)
        server = DeployProcess(basedir, iid, device.type,
                               ["--realtime", str(RT_INTERVAL), "--realtime-cursor",
                                os.path.join(basedir, "cursor.json")], "realtime")
        pick = rng.permutation(nu)[:RT_P50_QUERIES]
        idle = closed_loop(server.port, [{"user": f"u{int(j)}", "num": 10} for j in pick], 1)
        m0 = server.metrics()
        rt0 = rt_stats(server)["realtime"]
        if rt0["mode"] != "seq" or rt0["foldin_epoch"] != 0:
            raise AssertionError(f"speed layer not attached on sqlite: {rt0}")
        new = realtime_events(Event, rng, nu, ni, known, time.time())
        t_ins = time.perf_counter()
        events.batch_insert(new, app_id)
        rt1 = wait_folded(server, 0, "the new events")
        visible_s = time.perf_counter() - t_ins
        m1 = server.metrics()
        k1_main = int(metric_delta(m1, m0, "pio_k1_kernel_launches"))
        folds = rt1["foldin_epoch"]
        fold_n = metric_delta(m1, m0, "pio_foldin_solve_seconds_count")
        fold_s = metric_delta(m1, m0, "pio_foldin_solve_seconds_sum")

        # the fold as the server ran it, here: its users and rows
        from predictionio_tpu_torch.realtime import ALSFoldIn, FoldInConfig

        fold = ALSFoldIn(events, app_id, config=FoldInConfig(reg=TRAIN_REG), device=device)
        fstats = foldin_mod.FoldInStats()
        touched: list = []
        fold._collect_events(model, new, fstats, touched, set())
        users, pairs = fold.touched_pairs(model, touched, fstats)
        if rt1["users_added"] != RT_NEW_USERS or rt1["cold_start_items"] != RT_COLD:
            raise AssertionError(f"fold stats {rt1}")
        if len(users) != RT_NEW_USERS + RT_KNOWN or max(map(len, pairs)) < RT_HEAVY:
            raise AssertionError(f"{len(users)} users, widest {max(map(len, pairs))}")
        V = model.device_factors(device)[1]
        k1 = fold_k1_checks(torch, als, foldin_mod, V, pairs, TRAIN_REG, stats)
        if folds != 1 or k1_main != k1["launches_per_fold"]:
            raise AssertionError(f"{folds} folds, {k1_main} K1 launches on the main path, "
                                 f"expected 1 fold of {k1['launches_per_fold']}")
        check_folded_answers(torch, model, V, users, pairs, server.port, device)

        # HTTP p50 with the layer folding a trickle of new users' events
        stop = threading.Event()

        def trickle():
            k = 0
            while not stop.is_set():
                events.batch_insert([
                    Event(event="rate", entity_type="user", entity_id=f"new{k % RT_NEW_USERS}",
                          target_entity_type="item", target_entity_id=f"i{int(i)}",
                          properties={"rating": 4.0})
                    for i in rng.choice(ni, size=4, replace=False)], app_id)
                k += 1
                stop.wait(0.1)

        writer = threading.Thread(target=trickle)
        epoch0 = rt_stats(server)["realtime"]["foldin_epoch"]
        writer.start()
        try:
            busy = closed_loop(server.port,
                               [{"user": f"u{int(j)}", "num": 10} for j in pick], 1)
        finally:
            stop.set()
            writer.join()
        rt2 = wait_folded(server, rt_stats(server)["realtime"]["foldin_epoch"] - 1,
                          "the trickle")
        folds_busy = rt2["foldin_epoch"] - epoch0
        if folds_busy < 1:
            raise AssertionError("no fold ran during the busy p50 window")
        m2 = server.metrics()
        # idle again, now that the server is as warm as in the busy window
        idle_after = closed_loop(server.port,
                                 [{"user": f"u{int(j)}", "num": 10} for j in pick], 1)
        code = server.stop()
        server = None
        if code != 0:
            raise AssertionError(f"deploy --realtime exited {code}")
    finally:
        if server is not None:
            server.stop()
        storage.close()
        shutil.rmtree(basedir, ignore_errors=True)

    def p50(run):
        lat = sorted(run["lat"])
        return lat[len(lat) // 2] * 1e3

    out = {
        "events": len(new), "users_folded": len(users), "users_added": rt1["users_added"],
        "cold_items": rt1["cold_start_items"], "folds": folds, "widest_history": max(map(len, pairs)),
        "k1_launches_main_path": k1_main, "visible_s": visible_s,
        "fold_cycle_s": fold_s / fold_n if fold_n else None,
        "fold_cycles_s_all": (metric_delta(m2, m0, "pio_foldin_solve_seconds_sum")
                              / max(1.0, metric_delta(m2, m0, "pio_foldin_solve_seconds_count"))),
        "http_p50_ms_idle_first": p50(idle), "http_p50_ms_folding": p50(busy),
        "http_p50_ms_idle": p50(idle_after),
        "folds_during_busy_window": folds_busy, "k1": k1,
    }
    stats["realtime"] = out
    log(json.dumps({"realtime": "ml20m rank 20 f32, sqlite", **out}))


# -- the similar-product template ------------------------------------------------

SIM_USERS, SIM_ITEMS, SIM_GROUPS = 1000, 300, 5
SIM_FACTORY = "predictionio_tpu_torch.models.similarproduct.engine"


def similar_events(Event, rng) -> list:
    """The similar-product template's events: items ``$set`` with two
    categories each (a taste group and a parity), users ``$set``, and per
    user ~20 views, 5 likes and 1 dislike, mostly inside the user's
    taste group; event times increase."""
    from datetime import datetime, timedelta, timezone

    t0 = datetime(2024, 1, 1, tzinfo=timezone.utc)
    out = []

    def at(n):
        return t0 + timedelta(seconds=n)

    for j in range(SIM_ITEMS):
        out.append(Event(event="$set", entity_type="item", entity_id=f"i{j}",
                         properties={"categories": [f"c{j % SIM_GROUPS}",
                                                    "odd" if j % 2 else "even"]},
                         event_time=at(len(out))))
    groups = [np.arange(g, SIM_ITEMS, SIM_GROUPS) for g in range(SIM_GROUPS)]
    for u in range(SIM_USERS):
        out.append(Event(event="$set", entity_type="user", entity_id=f"u{u}",
                         properties={}, event_time=at(len(out))))
        own = groups[u % SIM_GROUPS]
        views = np.where(rng.random(20) < 0.8, rng.choice(own, 20),
                         rng.integers(0, SIM_ITEMS, 20))
        signals = [("view", int(i)) for i in views]
        signals += [("like", int(i)) for i in rng.choice(own, 5)]
        signals.append(("dislike", int(rng.integers(0, SIM_ITEMS))))
        for name, i in signals:
            out.append(Event(event=name, entity_type="user", entity_id=f"u{u}",
                             target_entity_type="item", target_entity_id=f"i{i}",
                             event_time=at(len(out))))
    return out


def plain_similar(torch, server, q: dict):
    """What the deployed engine must answer: each algorithm's model scored
    on the CPU through the template's own batch scorer, where K2 runs its
    plain version, then the engine's serving."""
    from predictionio_tpu_torch.models import similarproduct as sim

    query = sim.Query(**q)
    preds = [sim._score_similar_batch(m, [query], torch.device("cpu"))[0]
             for m in server.models]
    return server.serving.serve(query, preds)


def check_similar(got: list, want, model, what: str) -> None:
    """HTTP itemScores against the plain path's PredictedResult: the same
    length, scores within rtol/atol (NaN where NaN), the same items
    outside runs of near-tied scores."""
    exp_items = [x.item for x in want.itemScores]
    exp_scores = np.asarray([x.score for x in want.itemScores], np.float32)
    items = [x["item"] for x in got]
    scores = np.asarray([np.nan if x["score"] is None else x["score"] for x in got],
                        np.float32)
    if len(items) != len(exp_items):
        raise AssertionError(f"{what}: {len(items)} items, expected {len(exp_items)}")
    if not np.allclose(scores, exp_scores, rtol=RTOL, atol=ATOL, equal_nan=True):
        raise AssertionError(f"{what}: scores {scores} vs {exp_scores}")
    idx = model.item_index
    if not near_tie_ids_ok(np.asarray([idx[x] for x in items]),
                           np.asarray([idx[x] for x in exp_items]), exp_scores):
        raise AssertionError(f"{what}: items {items} vs {exp_items}")


def same_factors(torch, a: np.ndarray, b: np.ndarray, what: str) -> float:
    """Host factor tables equal in NaN pattern and within rtol 5e-4 /
    atol 5e-5 elsewhere; returns the largest finite difference."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    if not np.array_equal(np.isnan(a), np.isnan(b)):
        raise AssertionError(f"{what}: NaN rows differ")
    ok = ~np.isnan(a)
    if not np.allclose(a[ok], b[ok], rtol=5e-4, atol=5e-5):
        raise AssertionError(f"{what}: factors differ (max abs "
                             f"{np.abs(a[ok] - b[ok]).max()})")
    return float(np.abs(a[ok] - b[ok]).max(initial=0.0))


@phase("similar-product lifecycle: events -> train -> deploy (CLI, sqlite)")
def similar_lifecycle(torch, device, stats):
    """~1,000 users x 300 items of similar-product events (``$set`` items
    with categories, users, views, likes, dislikes) in the port's sqlite
    store; ``cli.main train`` of both algorithms (als on view counts,
    likealgo on like = 1 / dislike = -1) on the card, ``deploy``, and
    POSTed queries (simple, blackList, categories, an unknown item), each
    answered as the plain path answers it. The trained item factors must
    match the same trainings on the CPU (rtol 5e-4 / atol 5e-5, NaN rows
    where NaN), and K1's and K2's counters must move."""
    from predictionio_tpu_torch.cli import main as cli
    from predictionio_tpu_torch.core.context import WorkflowContext
    from predictionio_tpu_torch.data import storage as st
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.models import similarproduct as sim
    from predictionio_tpu_torch.ops import als, topk

    rng = np.random.default_rng(SEED + 11)
    basedir = tempfile.mkdtemp(prefix="pio_chip_smoke_sim_")
    variant_path = os.path.join(basedir, "engine.json")
    algos = [{"name": name, "params": {"rank": 10, "numIterations": 10, "lambda": 0.01,
                                       "alpha": 1.0, "seed": 3}}
             for name in ("als", "likealgo")]
    with open(variant_path, "w") as f:
        json.dump({"id": "chip-smoke-sim", "engineFactory": SIM_FACTORY,
                   "datasource": {"params": {"appName": "SimApp"}},
                   "algorithms": algos}, f)
    server = None
    try:
        with storage_env(basedir):
            storage = st.get_storage()
            app_id = storage.get_metadata_apps().insert(st.App(0, "SimApp"))
            events = similar_events(Event, rng)
            storage.get_events().batch_insert(events, app_id)
            log(f"wrote {len(events)} similar-product events")
            als.solve_bucket.launches.reset()
            topk.sum_rows_top_k_batch.launches.reset()
            t0 = time.perf_counter()
            if cli.main(["train", "--variant", variant_path]) != 0:
                raise AssertionError("cli train failed")
            train_s = time.perf_counter() - t0
            k1 = als.solve_bucket.launches.value
            server = cli.deploy_server(cli.build_parser().parse_args([
                "deploy", "--variant", variant_path, "--ip", "127.0.0.1", "--port", "0"]))
            server.warmup()
            port = server.start(background=True)
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            queries = [{"items": ["i3"], "num": 5},
                       {"items": ["i3", "i10"], "num": 8, "blackList": ["i8", "i13"]},
                       {"items": ["i7"], "num": 6, "categories": ["c2"]},
                       {"items": ["nope"], "num": 4}]
            for q in queries:
                got = post(conn, q)["itemScores"]
                check_similar(got, plain_similar(torch, server, q), server.models[0],
                              f"similar {q}")
                log(f"similar {json.dumps(q)} -> {json.dumps(got[:3])}")
            conn.close()
            k2 = topk.sum_rows_top_k_batch.launches.value
            td = sim.SimilarProductDataSource(
                sim.DataSourceParams(app_name="SimApp")).read_training(None)
        if k1 <= 0 or k2 <= 0:
            raise AssertionError(f"launch counters did not move: K1 {k1}, K2 {k2}")
        cpu = WorkflowContext(mode="Training", device="cpu")
        diffs = {}
        for algo, model in zip(server.algorithms, server.models):
            name = type(algo).__name__
            cpu_model = type(algo)(algo.params).train(cpu, td)
            diffs[name] = same_factors(
                torch, model.item_factors, cpu_model.item_factors,
                f"{name} factors, card vs CPU")
            diffs[name + "_nan_rows"] = int(np.isnan(model.item_factors).any(1).sum())
    finally:
        if server is not None:
            server.stop()
        shutil.rmtree(basedir, ignore_errors=True)
    stats["similar_lifecycle"] = {"train_s": train_s, "k1_launches": k1,
                                  "k2s_launches": k2, "max_abs_diff_vs_cpu": diffs}
    log(json.dumps({"lifecycle": "similar-product", **stats["similar_lifecycle"]}))


SIM_TRAIN = {"rank": 10, "numIterations": 20, "lambda": 0.01, "alpha": 1.0, "seed": 3}


def rowwise_rel(torch, x, ref) -> float:
    """The largest per-row error of ``x`` against ``ref``, over that row's
    largest |ref| value (normwise)."""
    err = (x.double() - ref.double()).abs().amax(dim=1)
    return float((err / ref.double().abs().amax(dim=1).clamp_min(1e-30)).max())


def rows_within(torch, x, ref, rtol: float, atol: float) -> bool:
    """Every row of ``x`` within atol + rtol * max|row of ref| of ``ref``."""
    err = (x.double() - ref.double()).abs().amax(dim=1)
    return bool((err <= atol + rtol * ref.double().abs().amax(dim=1)).all())


def float64_implicit_iteration(torch, data, params, device):
    """One implicit ALS iteration in float64 from the cold init
    ``als_train`` draws: each bucket's systems built from the gathered
    rows and solved by ``torch.linalg.solve`` (the reference the kernel
    and its plain version are both held to)."""
    from predictionio_tpu_torch.ops import als

    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(params.seed))
    U = als.init_factors(data.num_rows, params.rank, gen, device).double()
    V = als.init_factors(data.num_cols, params.rank, gen, device).double()
    eye = torch.eye(params.rank, dtype=torch.float64, device=device)
    for target, other, buckets in ((U, V, data.row_buckets), (V, U, data.col_buckets)):
        gram = other.T @ other
        for b in als.device_buckets(buckets, device):
            R = b.row_ids.shape[0]
            seg_row = als.seg_rows(b.seg_start, b.col_ids.shape[0])
            A = torch.empty((b.col_ids.shape[0],) + gram.shape, dtype=torch.float64,
                            device=device)
            rhs = torch.empty((b.col_ids.shape[0], params.rank), dtype=torch.float64,
                              device=device)
            for lo in range(0, b.col_ids.shape[0], 2048):
                g = other[b.col_ids[lo:lo + 2048].long()]
                rat, msk = b.ratings[lo:lo + 2048].double(), b.mask[lo:lo + 2048].double()
                A[lo:lo + 2048] = torch.bmm(
                    (g * (params.alpha * rat * msk)[..., None]).transpose(1, 2), g)
                rhs[lo:lo + 2048] = torch.bmm(((1 + params.alpha * rat) * msk)[:, None],
                                              g)[:, 0]
            n = b.mask.double().sum(1)
            if seg_row is not None:
                A = torch.zeros((R,) + gram.shape, dtype=A.dtype, device=device
                                ).index_add_(0, seg_row, A)
                rhs = torch.zeros((R, params.rank), dtype=A.dtype, device=device
                                  ).index_add_(0, seg_row, rhs)
                n = torch.zeros((R,), dtype=A.dtype, device=device).index_add_(0, seg_row, n)
            lam = torch.where(n > 0, params.reg, 1.0)
            A = A + lam[:, None, None] * eye + gram
            target[b.row_ids.long()] = torch.linalg.solve(A, rhs)
    return U, V


@phase("similar-product at full width: ML-20M-shaped views, rank 10, run_train")
def similar_full_width(torch, device, stats):
    """The ML-20M-shaped (user, item) pairs of the train phase as 20 M
    view events of the similar-product template, through ``run_train``
    at the template's defaults (rank 10, 20 iterations, lambda 0.01,
    alpha 1.0, f32): views -> per-pair counts -> implicit ALS on K1, K1's
    counter reset just before and read just after (the main path's
    launches; it must equal iterations x the route's launches per
    iteration); persisted, deployed,
    queried over HTTP against the plain path (K2's summed-rows counter:
    the serving main path's launches). Then 1 implicit iteration with K1
    against 1 with its plain version and 1 in float64, from the same
    init: each factor row within atol 5e-5 + rtol 5e-4 * its largest
    |value| of both. The rows are held normwise, as K1's per-solve check
    holds them: a hot item's row reaches |x| ~ 10^2 here, and f32 sums
    of ~67,000 entries then leave its small components an absolute error
    near 10^-4 in any f32 solver (the elementwise count is reported)."""
    from predictionio_tpu_torch.cli import main as cli
    from predictionio_tpu_torch.core import DataSource, Engine, IdentityPreparator
    from predictionio_tpu_torch.core.context import WorkflowContext
    from predictionio_tpu_torch.core.workflow import run_train
    from predictionio_tpu_torch.data import storage as st
    from predictionio_tpu_torch.models import similarproduct as sim
    from predictionio_tpu_torch.models.columnar import aggregate_counts
    from predictionio_tpu_torch.ops import als, topk

    if "ml20m_arrays" not in stats:
        stats["ml20m_arrays"] = make_ml_shaped("20m")
    rows, cols, vals, nu, ni = stats["ml20m_arrays"]
    views = st.RatingsBatch([f"u{j}" for j in range(nu)], [f"i{j}" for j in range(ni)],
                            rows, cols, np.ones(len(rows), np.float32))
    td = sim.TrainingData(users=views.entity_ids, items={}, view_events=views)

    class GeneratedViews(DataSource):
        params_class = sim.DataSourceParams

        def read_training(self, ctx):
            return td

    engine = Engine(GeneratedViews, IdentityPreparator, {"als": sim.ALSAlgorithm},
                    sim.SumScoreServing)
    ep = engine.params_from_variant({
        "datasource": {"params": {"appName": "ML20M"}},
        "algorithms": [{"name": "als", "params": SIM_TRAIN}]})
    basedir = tempfile.mkdtemp(prefix="pio_chip_smoke_sim20m_")
    storage = st.Storage(env={"PIO_FS_BASEDIR": basedir})
    st.set_storage(storage)
    server = None
    try:
        als.solve_bucket.launches.reset()  # the main path starts here
        t0 = time.perf_counter()
        iid = run_train(engine, ep, engine_id="chip-smoke-sim20m", engine_factory=SIM_FACTORY,
                        storage=storage, ctx=WorkflowContext(mode="Training", device="cuda"))
        train_s = time.perf_counter() - t0
        stats["k1i_launches"] = als.solve_bucket.launches.value  # main path read
        server = cli.deploy_server(cli.build_parser().parse_args([
            "deploy", "--engine-instance-id", iid, "--ip", "127.0.0.1", "--port", "0",
            "--batch-window-ms", str(BATCH_WINDOW_MS)]))
        server.warmup()
        port = server.start(background=True)
        model = server.models[0]
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        topk.sum_rows_top_k_batch.launches.reset()  # the serving main path starts here
        topk.sum_rows_top_k_batch.kernel_launches.reset()
        for count in topk.sum_rows_top_k_batch.routes.values():
            count.reset()
        queries = [{"items": ["i0"], "num": 4},
                   {"items": ["i5", "i77", "i26743"], "num": 10, "blackList": ["i1"]},
                   {"items": ["i42"], "num": 20}, {"items": ["nope"], "num": 4}]
        for q in queries:
            got = post(conn, q)["itemScores"]
            check_similar(got, plain_similar(torch, server, q), model, f"sim20m {q}")
        stats["sim_batch_sizes"] = similar_concurrent_round(torch, server, port, model)
        stats["k2s_launches"] = topk.sum_rows_top_k_batch.launches.value  # main path read
        stats["k2s_kernel_launches"] = topk.sum_rows_top_k_batch.kernel_launches.value
        k2s_routes = {r: c.value for r, c in topk.sum_rows_top_k_batch.routes.items()}
        times = []
        for _ in range(60):
            t0 = time.perf_counter()
            post(conn, {"items": ["i42"], "num": 4})
            times.append(time.perf_counter() - t0)
        stats["sim_http_p50_ms"] = statistics.median(times[10:]) * 1e3
        # the same query without HTTP: the query path's share
        algo, q = server.algorithms[0], sim.Query(items=["i42"], num=4)
        times = []
        for _ in range(60):
            t0 = time.perf_counter()
            algo.predict(model, q)
            times.append(time.perf_counter() - t0)
        stats["sim_predict_p50_ms"] = statistics.median(times[10:]) * 1e3
        conn.close()
        nan_rows = int(np.isnan(np.asarray(model.item_factors, np.float32)).any(1).sum())
    finally:
        if server is not None:
            server.stop()
        st.set_storage(None)
        storage.close()
        shutil.rmtree(basedir, ignore_errors=True)
    if stats["k2s_launches"] <= 0:
        raise AssertionError("the HTTP queries did not launch the summed-rows K2")
    if k2s_routes != {"tile": stats["k2s_launches"], "select": 0}:
        raise AssertionError(f"summed-rows K2 calls by route {k2s_routes}: expected all "
                             f"{stats['k2s_launches']} on the tile route")
    per_call = topk.k2_launches(4, I_ROWS, 1, summed=True)
    if stats["k2s_kernel_launches"] != stats["k2s_launches"] * per_call:
        raise AssertionError(f"{stats['k2s_launches']} summed-rows K2 calls launched "
                             f"{stats['k2s_kernel_launches']} kernels, expected "
                             f"{per_call} a call")

    t0 = time.perf_counter()
    r = aggregate_counts(views)
    data = als.build_ratings_data(r.rows, r.cols, r.vals, nu, ni)
    log(f"view counts and bucket layout in {time.perf_counter() - t0:.1f}s: "
        f"{len(r.vals)} pairs; " + ", ".join(
            f"{side} K={b.width} B={b.col_ids.shape[0]} R={len(b.row_ids)}"
            for side, bs in (("user", data.row_buckets), ("item", data.col_buckets))
            for b in bs))
    per_iter = k1_launches_per_iteration(data, SIM_TRAIN["rank"])
    if stats["k1i_launches"] != SIM_TRAIN["numIterations"] * per_iter:
        raise AssertionError(f"K1 launched {stats['k1i_launches']} times on the main "
                             f"path, expected {SIM_TRAIN['numIterations']} iterations x "
                             f"{per_iter} launches")
    params = als.ALSParams(rank=10, iterations=1, reg=0.01, implicit=True, alpha=1.0,
                           seed=3)
    Uk, Vk = als.als_train(data, params, device=device)
    Up, Vp = plain_iteration(torch, data, params, device)
    U64, V64 = float64_implicit_iteration(torch, data, params, device)
    torch.cuda.synchronize()
    diffs = {}
    for name, a, b, x64 in (("U", Uk, Up, U64), ("V", Vk, Vp, V64)):
        err = float((a - b).abs().max())
        diffs[f"{name}_max_abs_diff"] = err
        diffs[f"{name}_max_abs"] = float(b.abs().max())
        diffs[f"{name}_elementwise_outside"] = int(
            ((a - b).abs() > 5e-5 + 5e-4 * b.abs()).sum())
        diffs[f"{name}_rel_kernel_f64"] = rowwise_rel(torch, a, x64)
        diffs[f"{name}_rel_plain_f64"] = rowwise_rel(torch, b, x64)
        stats["k1i_max_abs_err"] = max(stats.get("k1i_max_abs_err", 0.0), err)
        if not rows_within(torch, a, b, rtol=5e-4, atol=5e-5):
            raise AssertionError(f"1 implicit iteration: {name} differs from the plain "
                                 f"version (max abs {err})")
        if not rows_within(torch, a, x64, rtol=5e-4, atol=5e-5):
            raise AssertionError(f"1 implicit iteration: {name} differs from the float64 "
                                 f"iteration")
    stats["sim20m"] = data
    stats["similar_full_width"] = {
        "train_s": train_s, "iterations": SIM_TRAIN["numIterations"],
        "k1_launches": stats["k1i_launches"], "k2s_launches": stats["k2s_launches"],
        "k2s_kernel_launches": stats["k2s_kernel_launches"],
        "pairs": int(len(r.vals)), "nan_item_rows": nan_rows,
        "http_p50_ms": stats["sim_http_p50_ms"],
        "predict_p50_ms": stats["sim_predict_p50_ms"], **diffs}
    log(json.dumps({"full_width": "similar-product ml20m rank 10 implicit f32",
                    **stats["similar_full_width"]}))


def similar_concurrent_round(torch, server, port: int, model) -> dict:
    """Rounds of 8 concurrent similar-product queries (8 keep-alive
    clients, distinct items) through the micro-batcher, until a round
    coalesces queries into one K2s call at B > 1 (at most 20 rounds):
    each answer against the plain path. Returns the rounds' batch-size
    histogram (``pio_batch_size``, this process's registry)."""
    from predictionio_tpu_torch.obs import metrics as obs_metrics

    hist = obs_metrics.histogram("pio_batch_size")
    before = hist.merged()[0]
    conns = [http.client.HTTPConnection("127.0.0.1", port, timeout=60) for _ in range(8)]
    answers = {}
    errors = []

    def one(conn, q):
        try:
            answers[json.dumps(q)] = post(conn, q)["itemScores"]
        except Exception as e:
            errors.append(repr(e))

    try:
        for r in range(20):
            qs = [{"items": [f"i{100 + 8 * r + j}"], "num": 4 + j} for j in range(8)]
            threads = [threading.Thread(target=one, args=(c, q)) for c, q in zip(conns, qs)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errors:
                raise AssertionError(f"concurrent similar queries: {errors[0]}")
            after = hist.merged()[0]
            if sum(after[1:]) > sum(before[1:]):
                break
    finally:
        for c in conns:
            c.close()
    counts = [a - b for a, b in zip(hist.merged()[0], before)]
    if sum(counts[1:]) <= 0:
        raise AssertionError("20 rounds of 8 concurrent queries formed no batch of "
                             "more than one query")
    for key, got in answers.items():
        q = json.loads(key)
        check_similar(got, plain_similar(torch, server, q), model, f"sim20m batched {q}")
    bounds = [str(int(b)) for b in hist.bounds] + ["+Inf"]
    return {b: c for b, c in zip(bounds, counts) if c}


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


def device_trace(torch, fn, runs: int = 50) -> tuple[dict, dict]:
    """``torch.profiler`` (CUPTI) over ``runs`` calls of ``fn``: ({kernel
    or copy name: ms per call}, {name: launches the trace holds}); empty
    when the profiler saw no device work. A name's time is its traced
    total over the launches the trace holds, times its launches a call
    (rounded, at least 1): a trace now and then records only some of the
    runs."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out: dict = {}
    held: dict = {}
    for _ in range(5):  # a trace now and then comes back without device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if "CUDA" not in str(e.device_type):
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            if us:
                n = getattr(e, "count", 0) or runs
                out[e.key] = us / n * max(1, round(n / runs)) / 1e3
                held[e.key] = n
        if out:
            break
    return out, held


def device_ms(torch, fn, runs: int = 50) -> dict:
    """Device time per call from ``torch.profiler``: :func:`device_trace`'s
    {name: ms per call}."""
    return device_trace(torch, fn, runs)[0]


def clock_readings(torch, fn, launches: int, runs: int = 5) -> dict:
    """One call of ``fn`` (``launches`` kernel launches) on every clock
    this script has, from the same runs' kind of work:

    - ``events_ms``: CUDA events around the call as enqueued (median), the
      card's idle time between launches included;
    - ``queued_ms``: the same with the call queued behind a 50 ms
      ``torch.cuda._sleep``, so every launch is on the card before the
      first event fires: device time with no host gaps;
    - ``host_ms``: the host's time to enqueue the call (perf_counter, no
      synchronize; median);
    - ``device_ms``: ``torch.profiler``'s kernel time per call, with the
      launches its trace holds beside the ``runs x launches`` made."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    events, queued, host = [], [], []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        events.append(a.elapsed_time(b))
        torch.cuda._sleep(100_000_000)  # ~50 ms of cycles: the launches queue up
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        b.record()
        torch.cuda.synchronize()
        queued.append(a.elapsed_time(b))
    dev, held = device_trace(torch, fn, runs)
    return {"events_ms": statistics.median(events), "queued_ms": statistics.median(queued),
            "host_ms": statistics.median(host), "device_ms": _total(dev),
            "launches_held": sum(held.values()), "launches_made": runs * launches}


def _total(times: dict, part: str = ""):
    picked = [v for k, v in times.items() if part in k]
    return sum(picked) if picked else None


def peaks(name: str):
    for key, mem, fp32 in _PEAKS:
        if key in name:
            return mem, fp32
    return _PEAKS[2][1], _PEAKS[2][2]


K2_SWEEP_K = (1, 4, 16, 32, 64, 128)


def kernel_launches_of(torch, wrapper, fn) -> int:
    """Kernels one call of ``fn`` launched, as ``wrapper``'s C entry
    counted them."""
    before = wrapper.kernel_launches.value
    fn()
    torch.cuda.synchronize()
    return wrapper.kernel_launches.value - before


def k2_route_times(torch, topk, call, select, k: int, batch: int,
                   summed: bool = False) -> dict:
    """The route k2_route picks against the select route on the same
    inputs, in this run: device ms per call and each launch's share."""
    route = topk.k2_route(k, I_ROWS, batch)
    counted = topk.sum_rows_top_k_batch if summed else topk.gather_top_k_batch
    counted_select = topk._sum_rows_top_k_select if summed else topk._gather_top_k_select
    launches, base_launches = (kernel_launches_of(torch, c, f) for c, f in (
        (counted, call), (counted_select, select)))
    dev = device_ms(torch, call)
    base = device_ms(torch, select)
    out = {"route": route.name, "tile_width": route.width, "tiles": route.tiles,
           "launches": launches,
           "kernel_device_ms": _total(dev),
           "tile_device_ms": _total(dev, "tile_topk_kernel"),
           "merge_device_ms": _total(dev, "merge_topk_kernel"),
           "baseline_route": "select",
           "baseline_launches": base_launches,
           "baseline_device_ms": _total(base),
           "baseline_score_device_ms": _total(base, "score_kernel"),
           "baseline_select_device_ms": _total(base, "select_kernel")}
    if summed:
        out["baseline_sum_rows_device_ms"] = _total(base, "sum_rows_kernel")
    return out


@phase("times")
def timings(torch, device, stats):
    """K2 at D = 20, f32 and int8, B in {1, 64}, k = 4: the route
    k2_route picks (device ms per launch), the select route on the same
    inputs (``baseline_device_ms``), the plain version, a ``torch.topk(u
    @ V.T)`` yardstick and the bound. Then, f32, both modes, the device ms
    of both routes at k in K2_SWEEP_K and B in {1, 64}."""
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
            call = lambda: topk.gather_top_k_batch(ixs, users, items, k)  # noqa: E731
            select = lambda: topk._gather_top_k_select(ixs, users, items, k)  # noqa: E731
            kernel_ms = cuda_median_ms(torch, call)
            baseline_ms = cuda_median_ms(torch, select)
            plain_ms = cuda_median_ms(
                torch, lambda: topk.gather_top_k_batch_reference(ixs, users, items, k),
                runs=20)
            library_ms = cuda_median_ms(torch, library)
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
                   "baseline_ms": baseline_ms,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   **k2_route_times(torch, topk, call, select, k, batch),
                   "plain_device_ms": _total(plain_dev),
                   "library_device_ms": _total(library_dev),
                   "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
                   "flops": flops}
            rows.append(row)
            log(json.dumps(row))
    stats["timings"] = rows

    # both routes across k, both modes, f32 (D = 20 user rows; D = 10
    # normalized catalog, L = 4, for the summed rows)
    users = make_table(torch, "float32", U_ROWS, rank, False, gen, device)
    items = make_table(torch, "float32", I_ROWS, rank, False, gen, device)
    catalog = normalized_catalog(torch, "float32", 10, gen, device)
    rng = np.random.default_rng(SEED + 2)
    sweep = []
    for batch in BATCHES:
        ixs = torch.randint(0, U_ROWS, (batch,), generator=gen, device=device,
                            dtype=torch.int32)
        rix = torch.from_numpy(rng.integers(0, I_ROWS, (batch, 4)).astype(np.int32)).to(device)
        w = torch.ones((batch, 4), device=device)
        for kk in K2_SWEEP_K:
            for mode in ("gather", "summed"):
                if mode == "gather":
                    call = lambda: topk.gather_top_k_batch(ixs, users, items, kk)  # noqa: E731
                    select = lambda: topk._gather_top_k_select(  # noqa: E731
                        ixs, users, items, kk)
                else:
                    call = lambda: topk.sum_rows_top_k_batch(rix, w, catalog, kk)  # noqa: E731
                    select = lambda: topk._sum_rows_top_k_select(  # noqa: E731
                        rix, w, catalog, kk)
                row = {"timing": "k2 routes", "mode": mode, "dtype": "float32",
                       "B": batch, "k": kk, "D": rank if mode == "gather" else 10,
                       **k2_route_times(torch, topk, call, select, kk, batch,
                                        summed=mode == "summed")}
                sweep.append(row)
                log(json.dumps(row))
    stats["k2_sweep"] = sweep


def library_solve(torch, other, b, seg_row, reg: float, implicit: bool = False,
                  alpha: float = 1.0, gram=None):
    """The library yardstick for one K1 bucket (timed here, never called by
    the port): torch gather + bmm (+ the Gramian for the implicit form) +
    torch.linalg.cholesky + cholesky_solve, in f32, without the
    write-back. Explicit: ALS-WR reg * n; implicit: plain reg."""
    ids = b.col_ids.long()
    if isinstance(other, tuple):
        vg = other[0][ids].float() * other[1][ids][..., None]
    else:
        vg = other[ids].float()
    w, r = ((alpha * b.ratings * b.mask, (1.0 + alpha * b.ratings) * b.mask) if implicit
            else (b.mask, b.ratings * b.mask))
    A = torch.bmm((vg * w[..., None]).transpose(1, 2), vg)
    rhs = torch.bmm(r[:, None, :], vg)[:, 0]
    n = b.mask.sum(1)
    if seg_row is not None:
        R = b.row_ids.shape[0]
        A = torch.zeros((R,) + A.shape[1:], device=A.device).index_add_(0, seg_row, A)
        rhs = torch.zeros((R, rhs.shape[1]), device=A.device).index_add_(0, seg_row, rhs)
        n = torch.zeros((R,), device=A.device).index_add_(0, seg_row, n)
    lam = torch.where(n > 0, reg * (torch.ones_like(n) if implicit else n),
                      torch.ones_like(n))
    A.diagonal(dim1=1, dim2=2).add_(lam[:, None])
    if implicit:
        A += gram
    return torch.cholesky_solve(rhs[..., None], torch.linalg.cholesky(A))[..., 0]


@phase("K1 times")
def k1_timings(torch, device, stats):
    """K1 per bucket at ML-20M rank 20, f32 and int8 storage: device time
    per call (torch.profiler) of the route k1_route picks, each of a
    segmented bucket's two launches apart, the block kernel on the same
    bucket, its plain version (solve + _scatter_rows) and the library
    yardstick, beside the bound max(bytes / memory rate, FP32 operations
    / FP32 rate) computed from this run's buckets; then the wall time of
    one iteration (host clock around synchronize)."""
    from predictionio_tpu_torch.ops import als

    mem_rate, fp32_rate = peaks(stats["device_name"])
    data = stats["ml20m"]
    D = 20
    rows = []
    iteration_ms = {}
    for storage in ("float32", "int8"):
        params = als.ALSParams(rank=D, iterations=1, reg=TRAIN_REG, seed=3,
                               storage_dtype=storage)
        gen = torch.Generator(device="cpu")
        gen.manual_seed(3)
        U = als.to_storage(als.init_factors(data.num_rows, D, gen, device), storage)
        V = als.to_storage(als.init_factors(data.num_cols, D, gen, device), storage)
        rb = als.device_buckets(data.row_buckets, device)
        cb = als.device_buckets(data.col_buckets, device)
        elem, scale_bytes = (1, 4) if storage == "int8" else (4, 0)
        for side, target, other, buckets in (("user", U, V, rb), ("item", V, U, cb)):
            for b in buckets:
                R, (B, K) = b.row_ids.shape[0], b.col_ids.shape
                seg_row = als.seg_rows(b.seg_start, b.col_ids.shape[0])

                def kernel():
                    als.solve_bucket(other, b.col_ids, b.ratings, b.mask, b.seg_start,
                                     TRAIN_REG, target=target, row_ids=b.row_ids,
                                     return_x=False)

                def plain():
                    als._scatter_rows(target, b.row_ids, als.solve_bucket_reference(
                        other, b.col_ids, b.ratings, b.mask, TRAIN_REG, seg_row, R))

                def library():
                    return library_solve(torch, other, b, seg_row, TRAIN_REG)

                def block():
                    als._solve_bucket_block(other, b.col_ids, b.ratings, b.mask,
                                            b.seg_start, TRAIN_REG, target=target,
                                            row_ids=b.row_ids, return_x=False)

                n_live, nbytes, flops = k1_bound(torch, b, D, elem, scale_bytes)
                row = {"timing": "solve_bucket", "storage": storage, "side": side,
                       "K": K, "B": B, "R": R, "live": n_live,
                       "kernel_ms": cuda_median_ms(torch, kernel, runs=5, warmup=2),
                       **route_times(torch, als, kernel, block, D, R, B),
                       "plain_device_ms": _total(device_ms(torch, plain, runs=2)),
                       "library_device_ms": _total(device_ms(torch, library, runs=2)),
                       "bytes": nbytes, "flops": flops,
                       "bound_ms": max(nbytes / mem_rate, flops / fp32_rate) * 1e3,
                       "bound_by": ("bytes" if nbytes / mem_rate >= flops / fp32_rate
                                    else "operations")}
                rows.append(row)
                log(json.dumps(row))

        def iteration():
            als._half_step(U, V, rb, params)
            als._half_step(V, U, cb, params)

        iteration()
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            iteration()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        iteration_ms[storage] = statistics.median(walls)
        per = [r for r in rows if r["storage"] == storage]
        log(json.dumps({"timing": "iteration", "storage": storage,
                        "wall_ms": iteration_ms[storage],
                        "launches": sum(r["launches"] for r in per),
                        "kernel_device_ms": sum(r["kernel_device_ms"] or 0 for r in per),
                        "block_device_ms": sum(r["block_device_ms"] or 0 for r in per),
                        "bound_ms": sum(r["bound_ms"] for r in per),
                        "workspace_bytes": sum(r["workspace_bytes"] for r in per)}))
    stats["k1_timings"] = rows
    stats["iteration_ms"] = iteration_ms


def route_times(torch, als, kernel, block, D: int, R: int, B: int) -> dict:
    """Device times (torch.profiler, per call) of one bucket on the route
    k1_route picks (``kernel``) -- a segmented bucket's two launches also
    apart -- and on the block kernel (``block``), with the route's
    launches and the bytes its workspace takes (written once, read once;
    the design's own traffic, not part of the bound)."""
    route = als.k1_route(D, R, B)
    dev = device_ms(torch, kernel, runs=5)
    out = {"route": route, "launches": als.k1_launches(D, R, B),
           "kernel_device_ms": _total(dev)}
    if route == "split":
        out["partials_device_ms"] = _total(dev, "warp_partials_kernel")
        out["finish_device_ms"] = _total(dev, "warp_finish_kernel")
    out["workspace_bytes"] = 2 * B * (D * (D + 3) // 2 + 2) * 4 if route == "split" else 0
    out["block_device_ms"] = _total(device_ms(torch, block, runs=5))
    return out


def k1_bound(torch, b, D: int, elem: int, scale_bytes: int, implicit: bool = False):
    """(bytes, FP32 operations) K1 needs for one bucket of this run: the
    bucket arrays, offsets and ids, each distinct gathered row once, the
    rows written, and for the implicit form the [D, D] Gramian read;
    D(D+1) + 2D operations per live entry (the symmetric Gramian and the
    rhs) and D^3/3 + 2 D^2 per solved row (Cholesky and substitutions),
    plus D(D+1)/2 per row to add the Gramian."""
    R, (B, K) = b.row_ids.shape[0], b.col_ids.shape
    live = b.mask > 0
    n_live = int(live.sum())
    n_other = int(torch.unique(b.col_ids[live]).numel())
    nbytes = (B * K * 12 + (R + 1) * 4 + R * 4 + n_other * (D * elem + scale_bytes)
              + R * (D * elem + scale_bytes) + (D * D * 4 if implicit else 0))
    flops = n_live * (D * (D + 1) + 2 * D) + R * (D ** 3 / 3 + 2 * D * D)
    if implicit:
        flops += R * D * (D + 1) / 2
    return n_live, nbytes, flops


@phase("similar-product times")
def similar_timings(torch, device, stats):
    """K1's implicit mode per bucket at ML-20M-shaped view counts, rank 10
    f32 (the similar-product defaults), each launch of its route, beside
    the block kernel, its plain version, the library yardstick and the
    bound of this run's buckets; compute_gram
    and one iteration's wall time. Then K2's summed-rows mode at B = 1
    and B = 64 (L = 4, k = 4) on a normalized f32 rank-10 catalog of the
    ML-20M item count, beside its plain version, a ``torch.topk(q @
    V.T)`` yardstick and its bound."""
    from predictionio_tpu_torch.ops import als, topk

    mem_rate, fp32_rate = peaks(stats["device_name"])
    data = stats["sim20m"]
    D, reg, alpha = 10, 0.01, 1.0
    params = als.ALSParams(rank=D, iterations=1, reg=reg, implicit=True, alpha=alpha,
                           seed=3)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(3)
    U = als.init_factors(data.num_rows, D, gen, device)
    V = als.init_factors(data.num_cols, D, gen, device)
    rb = als.device_buckets(data.row_buckets, device)
    cb = als.device_buckets(data.col_buckets, device)
    rows = []
    gram_ms = {}
    for side, target, other, buckets in (("user", U, V, rb), ("item", V, U, cb)):
        gram = als.compute_gram(other)
        gram_ms[side] = _total(device_ms(torch, lambda: als.compute_gram(other), runs=20))
        for b in buckets:
            R, (B, K) = b.row_ids.shape[0], b.col_ids.shape
            seg_row = als.seg_rows(b.seg_start, b.col_ids.shape[0])

            def kernel():
                als.solve_bucket(other, b.col_ids, b.ratings, b.mask, b.seg_start, reg,
                                 weighted_reg=False, target=target, row_ids=b.row_ids,
                                 return_x=False, implicit=True, alpha=alpha, gram=gram)

            def plain():
                als._scatter_rows(target, b.row_ids, als.solve_bucket_reference(
                    other, b.col_ids, b.ratings, b.mask, reg, seg_row, R, False,
                    implicit=True, alpha=alpha, gram=gram))

            def library():
                return library_solve(torch, other, b, seg_row, reg, implicit=True,
                                     alpha=alpha, gram=gram)

            def block():
                als._solve_bucket_block(other, b.col_ids, b.ratings, b.mask, b.seg_start,
                                        reg, weighted_reg=False, target=target,
                                        row_ids=b.row_ids, return_x=False, implicit=True,
                                        alpha=alpha, gram=gram)

            n_live, nbytes, flops = k1_bound(torch, b, D, 4, 0, implicit=True)
            row = {"timing": "solve_bucket implicit", "storage": "float32", "side": side,
                   "K": K, "B": B, "R": R, "live": n_live,
                   "kernel_ms": cuda_median_ms(torch, kernel, runs=5, warmup=2),
                   **route_times(torch, als, kernel, block, D, R, B),
                   "plain_device_ms": _total(device_ms(torch, plain, runs=2)),
                   "library_device_ms": _total(device_ms(torch, library, runs=2)),
                   "bytes": nbytes, "flops": flops,
                   "bound_ms": max(nbytes / mem_rate, flops / fp32_rate) * 1e3,
                   "bound_by": ("bytes" if nbytes / mem_rate >= flops / fp32_rate
                                else "operations")}
            rows.append(row)
            log(json.dumps(row))

    def iteration():
        als._half_step(U, V, rb, params)
        als._half_step(V, U, cb, params)

    iteration()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        iteration()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    stats["k1i_timings"] = rows
    stats["k1i_iteration_ms"] = statistics.median(walls)
    log(json.dumps({"timing": "implicit iteration", "storage": "float32", "rank": D,
                    "wall_ms": stats["k1i_iteration_ms"],
                    "launches": sum(r["launches"] for r in rows),
                    "kernel_device_ms": sum(r["kernel_device_ms"] or 0 for r in rows),
                    "block_device_ms": sum(r["block_device_ms"] or 0 for r in rows),
                    "workspace_bytes": sum(r["workspace_bytes"] for r in rows),
                    "compute_gram_device_ms": gram_ms,
                    "bound_ms": sum(r["bound_ms"] for r in rows)}))

    # K2 summed rows at the similar-product serving shape
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 13)
    rng = np.random.default_rng(SEED + 13)
    items = normalized_catalog(torch, "float32", D, gen, device)
    width, k = 4, 4
    k2s = []
    for batch in BATCHES:
        ixs = torch.from_numpy(rng.integers(0, I_ROWS, (batch, width)).astype(
            np.int32)).to(device)
        w = torch.ones((batch, width), device=device)

        def library():
            q = (items[ixs.long()] * w[..., None]).sum(1)
            return torch.topk(q @ items.T, k)

        call = lambda: topk.sum_rows_top_k_batch(ixs, w, items, k)  # noqa: E731
        select = lambda: topk._sum_rows_top_k_select(ixs, w, items, k)  # noqa: E731
        ref = lambda: topk.sum_rows_top_k_batch_reference(ixs, w, items, k)  # noqa: E731
        nbytes = (I_ROWS * D * 4  # the catalog, read once (query rows are part of it)
                  + batch * width * 8  # row ids and weights
                  + batch * k * 8)  # scores + ids out
        flops = 2 * batch * width * D + 2 * batch * I_ROWS * D
        routes = k2_route_times(torch, topk, call, select, k, batch, summed=True)
        # the fold's alternative: the query rows summed by their own launch
        # (the select route's sum_rows_kernel, timed above), then the tile
        # route on them as user rows
        qvec = (items[ixs.long()] * w[..., None]).sum(1).contiguous()
        qix = torch.arange(batch, dtype=torch.int32, device=device)
        on_rows = _total(device_ms(
            torch, lambda: topk.gather_top_k_batch(qix, qvec, items, k)))
        separate = (None if None in (on_rows, routes["baseline_sum_rows_device_ms"])
                    else on_rows + routes["baseline_sum_rows_device_ms"])
        row = {"timing": "sum_rows_top_k_batch", "dtype": "float32", "B": batch,
               "L": width, "D": D, "k": k, "I": I_ROWS,
               "kernel_ms": cuda_median_ms(torch, call),
               "baseline_ms": cuda_median_ms(torch, select),
               "plain_ms": cuda_median_ms(torch, ref, runs=20),
               "library_ms": cuda_median_ms(torch, library),
               **routes,
               "separate_sum_device_ms": separate,
               "plain_device_ms": _total(device_ms(torch, ref, runs=20)),
               "library_device_ms": _total(device_ms(torch, library)),
               "bound_ms": max(nbytes / mem_rate, flops / fp32_rate) * 1e3,
               "bound_by": "bytes" if nbytes / mem_rate >= flops / fp32_rate
               else "operations", "bytes": nbytes, "flops": flops}
        k2s.append(row)
        log(json.dumps(row))
    stats["k2s_timings"] = k2s


# -- the evaluation slice: K3, K2 at the eval shape, K1s, the shipped sweep ---------

EVAL_Q = 333_334  # eval queries of one ML-1M fold (1,000,000 / 3)
EVAL_USERS, EVAL_ITEMS = 6_040, 3_706  # ML-1M users and items
EVAL_RANK = 20  # the sweep's largest rank
K2_ROW_LIMIT = 65_535 * 8  # rows one K2 launch took before row chunks
K1S_REGS = (0.02, 0.05, 0.1, 0.2)  # the ML-20M lambda sweep of the K1s check


def ranking_case(torch, rng, Q: int, P: int, A: int, device):
    """K3 inputs: ``[Q, P]`` predicted ids with -1 slots (~10%), ``[Q, A]``
    sorted actual rows (ACTUAL_PAD-padded) holding a planted hit in
    about half the rows, codes <= -2 (~5%), and empty rows (count 0,
    every 17th); ``[Q]`` counts."""
    from predictionio_tpu_torch.core.ranking import ACTUAL_PAD

    pred = rng.integers(0, EVAL_ITEMS, (Q, P)).astype(np.int32)
    vals = rng.integers(0, EVAL_ITEMS, (Q, A)).astype(np.int64)
    plant = rng.random(Q) < 0.5
    vals[plant, 0] = pred[plant, rng.integers(0, P, int(plant.sum()))]
    pred[rng.random((Q, P)) < 0.1] = -1
    codes = rng.random((Q, A)) < 0.05
    vals[codes] = -2 - rng.integers(0, 50, int(codes.sum()))
    counts = rng.integers(1, A + 1, Q)
    counts[::17] = 0
    vals[np.arange(A)[None, :] >= counts[:, None]] = ACTUAL_PAD
    actual = np.sort(vals, axis=1).astype(np.int32)
    return (torch.from_numpy(pred).to(device), torch.from_numpy(actual).to(device),
            torch.from_numpy(counts.astype(np.int32)).to(device))


@phase("eval: K3 (ranking_metrics_batch) vs plain")
def k3_vs_plain(torch, device, stats):
    """K3 (``k3_group(P)`` lanes a query row) against its plain version on
    the same CUDA tensors: an ML-1M fold's Q = 333,334 rows at P in {1,
    10} x A in {1, 3} with k = P and k = 10 (the denominators' k past P),
    and on 20,000 rows P in {3, 32, 33, 40, 100} (A = 3, k = P), across
    the lane groups' sizes (1, 4, 16, 32, and a warp's second group of
    positions): precision and valid equal, ap and ndcg within 1e-6; the
    earlier one-warp design (``_ranking_metrics_warp``) held the same way
    on every case."""
    from predictionio_tpu_torch.ops import topk

    rng = np.random.default_rng(SEED)
    err = 0.0
    cases = [(EVAL_Q, P, A, k) for P in (1, 10) for A in (1, 3) for k in sorted({P, 10})]
    cases += [(20_000, P, 3, P) for P in (3, 32, 33, 40, 100)]
    for Q, P, A, k in cases:
        pred, actual, counts = ranking_case(torch, rng, Q, P, A, device)
        want = topk.ranking_metrics_batch_reference(pred, actual, counts, k)
        for fn in (topk.ranking_metrics_batch, topk._ranking_metrics_warp):
            before = fn.launches.value
            got = fn(pred, actual, counts, k)
            if fn.launches.value != before + 1:
                raise AssertionError(f"{fn.__name__} did not count its launch")
            torch.cuda.synchronize()
            what = f"{fn.__name__} Q={Q} P={P} A={A} k={k}"
            if not (torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])):
                raise AssertionError(f"K3 precision/valid differ from the plain version: {what}")
            for name, a, b in (("ap", got[1], want[1]), ("ndcg", got[2], want[2])):
                e = float((a - b).abs().max())
                err = max(err, e)
                if not e <= 1e-6:
                    raise AssertionError(f"K3 {name} off by {e}: {what}")
        hits = int((got[0] > 0).sum())
        log(f"K3 Q={Q} P={P} A={A} k={k} ({topk.k3_group(P)} lanes a row): equal to plain, "
            f"and so is the one-warp design ({hits} rows with hits, "
            f"{int((~got[3]).sum())} empty)")
    stats["k3_max_abs_err"] = err


def hold_topk(sk, ik, plain, what: str) -> tuple[float, int]:
    """``[B, k]`` scores and ids from the card against ``plain(lo, hi)``,
    the plain version's answer for rows lo..hi, run in chunks of 65,536
    rows (each row is scored alone): scores within rtol/atol, ids equal
    outside near ties. Returns (max abs error, rows id-equal)."""
    err, equal_rows = 0.0, 0
    for lo in range(0, sk.shape[0], 65_536):
        hi = min(sk.shape[0], lo + 65_536)
        sp, ip = plain(lo, hi)
        hk, hp = host(sk[lo:hi]), host(sp)
        err = max(err, float(np.max(np.abs(hk - hp), initial=0.0)))
        if not np.allclose(hk, hp, rtol=RTOL, atol=ATOL):
            raise AssertionError(f"{what}: scores differ (max abs {err})")
        ids_k, ids_p = host(ik[lo:hi]), host(ip)
        same = (ids_k == ids_p).all(axis=1)
        equal_rows += int(same.sum())
        for r in np.flatnonzero(~same):
            if not near_tie_ids_ok(ids_k[r], ids_p[r], hp[r]):
                raise AssertionError(f"{what}: ids differ in row {lo + r}")
    return err, equal_rows


def k2_eval_check(torch, topk, call, plain, B: int, k: int, what: str) -> float:
    """One K2 call (``call()``: ``gather_top_k_batch``, or the
    ``top_k_items_batch`` alias over it) of ``B`` rows on the card: one
    call and :func:`k2_launches` kernels added to K2's counts, and the
    answer held against ``plain`` (:func:`hold_topk`)."""
    calls0 = topk.gather_top_k_batch.launches.value
    kl0 = topk.gather_top_k_batch.kernel_launches.value
    sk, ik = call()
    torch.cuda.synchronize()
    launched = topk.gather_top_k_batch.kernel_launches.value - kl0
    if (topk.gather_top_k_batch.launches.value != calls0 + 1
            or launched != topk.k2_launches(k, EVAL_ITEMS, B)):
        raise AssertionError(f"{what}: {launched} kernel launches, expected "
                             f"{topk.k2_launches(k, EVAL_ITEMS, B)}")
    err, equal_rows = hold_topk(sk, ik, plain, what)
    log(f"K2 {what}: {equal_rows}/{B} rows id-equal to plain, max abs {err:.3g}, "
        f"{launched} kernel launches in {len(topk.k2_chunks(k, EVAL_ITEMS, B))} chunks")
    return err


@phase("eval: K2 eval top-k vs plain (ML-1M fold, and above the row limit)")
def topk_items_vs_plain(torch, device, stats):
    """K2 at the eval fast path's shape (``eval_topk`` calls
    ``gather_top_k_batch``) against its plain version: an ML-1M fold's B =
    333,334 user indices into a 6,040 x 20 user table, scored against the
    3,706-item catalog, f32 and int8 tables, k in {1, 10}; then
    ``top_k_items_batch`` (dense query rows through ``arange(B)``) at B =
    600,000 rows, above the 524,280 rows one K2 launch took, which the
    wrapper serves in row chunks (k2_chunks)."""
    from predictionio_tpu_torch.ops import topk

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 1)
    err = 0.0
    uixs = torch.randint(0, EVAL_USERS, (EVAL_Q,), generator=gen, device=device,
                         dtype=torch.int32)
    for dtype in ("float32", "int8"):
        users = make_table(torch, dtype, EVAL_USERS, EVAL_RANK, False, gen, device)
        items = make_table(torch, dtype, EVAL_ITEMS, EVAL_RANK, False, gen, device)
        for k in (1, 10):
            err = max(err, k2_eval_check(
                torch, topk, lambda: topk.gather_top_k_batch(uixs, users, items, k),
                lambda lo, hi: topk.gather_top_k_batch_reference(
                    uixs[lo:hi], users, items, k),
                EVAL_Q, k, f"eval fold B={EVAL_Q} {dtype} k={k}"))
    items = make_table(torch, "float32", EVAL_ITEMS, EVAL_RANK, False, gen, device)
    big = torch.randn((600_000, EVAL_RANK), generator=gen, device=device)
    for k in (1, 10):
        if len(topk.k2_chunks(k, EVAL_ITEMS, big.shape[0])) < 2:
            raise AssertionError(f"B=600000 k={k} should take more than one chunk")
        err = max(err, k2_eval_check(
            torch, topk, lambda: topk.top_k_items_batch(big, items, k),
            lambda lo, hi: topk._score_top_k_reference(big[lo:hi], items, k),
            big.shape[0], k, f"top_k_items_batch B=600000 (> {K2_ROW_LIMIT}) k={k}"))
    stats["topk_items_max_abs_err"] = err


def k1s_params(rank_regs_seeds, iterations: int = 2):
    from predictionio_tpu_torch.ops import als

    return [als.ALSParams(rank=r, iterations=iterations, reg=reg, seed=s)
            for r, reg, s in rank_regs_seeds]


def same_table(torch, a, b) -> bool:
    """Bitwise equality of two storage tables of the same representation."""
    if isinstance(a, tuple):
        return all(same_bits(torch, x.float(), y.float()) for x, y in zip(a, b))
    return same_bits(torch, a.float(), b.float())


@phase("eval: K1s (the candidate axis) at the ML-20M shape, rank 20")
def k1s_vs_k1(torch, device, stats):
    """K1s at the ML-20M shape (the train phase's layout), rank 20 f32, a
    4-candidate lambda sweep of 2 iterations: K1s's launches of a bucket
    serving all 4 (its counter), each candidate bit-identical to
    ``als_train`` of that candidate alone from the same init; a
    one-candidate sweep bit-identical to K1; ranks 10 and 20 split into
    two groups by the cost model; ranks 10, 20, 20, 20 as one padded
    group whose rank-10 candidate keeps its padded columns exactly +0.0
    (bitwise) and its real columns bit-identical to its rank-10 training
    alone; then 1 iteration of K1s against its plain version on the card
    (rtol 5e-4 / atol 5e-5, tests/test_als.py:188)."""
    from predictionio_tpu_torch.ops import als

    data = stats.get("ml20m")
    if data is None:
        rows, cols, vals, nu, ni = stats.get("ml20m_arrays") or make_ml_shaped("20m")
        data = stats["ml20m"] = als.build_ratings_data(rows, cols, vals, nu, ni)
    per_iter = k1s_launches_per_iteration(data, 20)
    ps = k1s_params([(20, reg, 3 + c) for c, reg in enumerate(K1S_REGS)])
    als.solve_bucket_sweep.launches.reset()
    out = als.als_train_sweep(data, ps, device)
    if als.solve_bucket_sweep.launches.value != 2 * per_iter:
        raise AssertionError(f"K1s launched {als.solve_bucket_sweep.launches.value} "
                             f"kernels for 2 iterations, expected 2 x {per_iter}")
    alone = []
    for c, p in enumerate(ps):
        U1, V1 = als.als_train(data, p, device=device)
        alone.append((U1, V1))
        if not (same_table(torch, out[c][0], U1) and same_table(torch, out[c][1], V1)):
            raise AssertionError(f"K1s candidate {c} (reg {p.reg}) is not bit-identical "
                                 "to als_train of it alone")
    U0, V0 = als.sweep_init(data, ps[:1], device)
    Us, Vs = als._train_sweep(data, ps[:1], U0, V0)
    if not (same_bits(torch, Us[0], alone[0][0]) and same_bits(torch, Vs[0], alone[0][1])):
        raise AssertionError("K1s at C = 1 is not bit-identical to K1")
    log(f"K1s: 4 candidates in {2 * per_iter} launches, each bit-identical to its "
        "training alone; C = 1 bit-identical to K1")

    mixed = k1s_params([(10, 0.05, 3), (20, 0.05, 4)])
    als.solve_bucket_sweep.launches.reset()
    als.als_train_sweep(data, mixed, device)
    groups = als.solve_bucket_sweep.launches.value
    expect = 2 * (k1s_launches_per_iteration(data, 10) + per_iter)
    if groups != expect:
        raise AssertionError(f"ranks 10 + 20: {groups} launches, expected two groups' {expect}")
    padded = k1s_params([(10, 0.05, 3), (20, 0.05, 4), (20, 0.1, 5), (20, 0.2, 6)])
    U0, V0 = als.sweep_init(data, padded, device)
    Up, Vp = als._train_sweep(data, padded, U0, V0)
    for name, t in (("U", Up), ("V", Vp)):
        if not bool((t[0, :, 10:].contiguous().view(torch.int32) == 0).all()):
            raise AssertionError(f"rank-10 candidate: padded {name} columns not exactly +0.0")
    U10, V10 = als.als_train(data, padded[0], device=device)
    real_equal = (same_bits(torch, Up[0, :, :10].contiguous(), U10)
                  and same_bits(torch, Vp[0, :, :10].contiguous(), V10))
    if not real_equal:
        raise AssertionError("rank-10 candidate of a padded sweep differs from its "
                             "rank-10 training alone")
    log("K1s ranks 10 + 20: two groups; ranks 10, 20, 20, 20: one padded group, "
        "the padded columns +0.0 and the real ones bit-identical to rank 10 alone")

    one = k1s_params([(20, reg, 3 + c) for c, reg in enumerate(K1S_REGS)], iterations=1)
    err = k1s_iteration_vs_plain(torch, data, one, device)
    stats["k1s_max_abs_err"] = max(stats.get("k1s_max_abs_err", 0.0), err)
    log(f"K1s 1 iteration vs plain: max abs {err:.3g}")


def k1s_iteration_vs_plain(torch, data, params, device) -> float:
    """One iteration of K1s over ``data`` for the candidates ``params``
    (one group, as ``als.sweep_groups`` makes them) against its plain
    version on the card, from the same stacked init: within rtol 5e-4 /
    atol 5e-5 (tests/test_als.py:188). Returns the max abs error."""
    from predictionio_tpu_torch.ops import als

    U0, V0 = als.sweep_init(data, params, device)
    Uk, Vk = als._train_sweep(data, params, U0, V0)
    regs = torch.tensor([p.reg for p in params], dtype=torch.float32, device=device)
    Upl, Vpl = U0.clone(), V0.clone()
    for target, other, buckets in ((Upl, Vpl, data.row_buckets), (Vpl, Upl, data.col_buckets)):
        for b in als.device_buckets(buckets, device):
            als.solve_bucket_sweep_reference(other, b.col_ids, b.ratings, b.mask,
                                             b.seg_start, regs, target, b.row_ids)
    torch.cuda.synchronize()
    err = max(float((Uk - Upl).abs().max()), float((Vk - Vpl).abs().max()))
    if not (torch.allclose(Uk, Upl, rtol=5e-4, atol=5e-5)
            and torch.allclose(Vk, Vpl, rtol=5e-4, atol=5e-5)):
        ranks = [p.rank for p in params]
        raise AssertionError(f"K1s 1 iteration (ranks {ranks}) differs from its plain "
                             f"version (max abs {err})")
    return err


K1S_FORMS = (  # (storage, compute) of the bucket-level K1s checks
    ("float32", "float32"), ("bfloat16", "bfloat16"), ("int8", "float32"))


def k1s_buckets_hold(torch, device, data, group, what: str) -> int:
    """K1s on every bucket of ``data`` (both sides) for the candidates
    ``group`` (ALSParams: rank, reg; a candidate below the group's rank D
    zero-padded to it), for each storage of :data:`K1S_FORMS`, explicit
    and implicit (alpha 1, 40, 3, ...), from random entry-major stacks:
    the redesigned kernel (``solve_bucket_sweep``), the earlier design
    (``_solve_bucket_sweep_grid``, K1's launches on the candidate axis, on
    contiguous copies) and K1 alone for each candidate (``solve_bucket``)
    write bit-identical tables; the C entry's plan is ``k1s_plan``'s.
    Returns the buckets held."""
    from predictionio_tpu_torch.ops import als

    C, D = len(group), max(p.rank for p in group)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 7)
    regs = torch.tensor([p.reg for p in group], dtype=torch.float32, device=device)
    alphas = torch.tensor([1.0, 40.0, 3.0, 0.5][:C] + [2.0] * max(0, C - 4),
                          dtype=torch.float32, device=device)
    cols = torch.arange(D, device=device)
    live = torch.stack([(cols < p.rank).float() for p in group])[:, None, :]  # padding

    held = 0
    for storage, compute in K1S_FORMS:
        for implicit in (False, True):
            weighted = not implicit
            for nt, no, buckets in ((data.num_rows, data.num_cols, data.row_buckets),
                                    (data.num_cols, data.num_rows, data.col_buckets)):
                O = torch.randn((C, no, D), generator=gen, device=device) / D ** 0.5 * live
                T0 = torch.randn((C, nt, D), generator=gen, device=device) * live
                other = als.entry_major(als.to_storage(O, storage))
                other_g = (tuple(t.contiguous() for t in other) if isinstance(other, tuple)
                           else other.contiguous())
                gram = als.compute_gram(other, compute) if implicit else None
                for b in als.device_buckets(buckets, device):
                    new = als.entry_major(als.to_storage(T0.clone(), storage))
                    old = als.to_storage(T0.clone(), storage)
                    n0 = als.solve_bucket_sweep.launches.value
                    als.solve_bucket_sweep(other, b.col_ids, b.ratings, b.mask, b.seg_start,
                                           regs, new, b.row_ids, weighted_reg=weighted,
                                           compute_dtype=compute, implicit=implicit,
                                           alphas=alphas, gram=gram)
                    R, B = b.row_ids.shape[0], b.col_ids.shape[0]
                    if als.solve_bucket_sweep.launches.value - n0 != als.k1s_launches(D, R, B):
                        raise AssertionError(f"{what}: K1s launch count")
                    plan = als.solve_bucket_sweep.last_plan
                    if plan != als.k1s_plan(C, D):
                        raise AssertionError(f"{what}: the C plan {plan} is not "
                                             f"k1s_plan's {als.k1s_plan(C, D)}")
                    als._solve_bucket_sweep_grid(other_g, b.col_ids, b.ratings, b.mask,
                                                 b.seg_start, regs, old, b.row_ids,
                                                 weighted_reg=weighted, compute_dtype=compute,
                                                 implicit=implicit, alphas=alphas, gram=gram)
                    for c in range(C):
                        alone = als.to_storage(T0[c].clone(), storage)
                        als.solve_bucket(als._candidate(other_g, c, D), b.col_ids, b.ratings,
                                         b.mask, b.seg_start, float(regs[c]),
                                         weighted_reg=weighted, compute_dtype=compute,
                                         target=alone, row_ids=b.row_ids, return_x=False,
                                         implicit=implicit, alpha=float(alphas[c]),
                                         gram=None if gram is None else gram[c].contiguous())
                        mine = als._candidate(new, c, D)
                        if not (same_table(torch, mine, alone)
                                and same_table(torch, als._candidate(old, c, D), alone)):
                            raise AssertionError(
                                f"{what} {storage}/{compute} implicit={implicit} bucket K="
                                f"{b.col_ids.shape[1]} candidate {c}: the new K1s, the earlier "
                                "design and K1 alone differ")
                    held += 1
    torch.cuda.synchronize()
    return held


@phase("eval: K1s redesigned vs the earlier design and K1 alone (bucket level)")
def k1s_new_vs_old(torch, device, stats):
    """:func:`k1s_buckets_hold` at the ML-20M shape (rank 20, the C = 4
    lambda sweep; ranks 10 + 20 + 20 padded to 20) and at the eval main
    path's shapes (the first ML-1M fold's buckets and its groups: ranks 5
    C = 1, 10 C = 2, 20 C = 1): every bucket, segmented ones included, bit
    for bit across the three."""
    from predictionio_tpu_torch.ops import als

    data = stats["ml20m"]
    ps = k1s_params([(20, reg, 3 + c) for c, reg in enumerate(K1S_REGS)])
    padded = k1s_params([(10, 0.05, 3), (20, 0.1, 4), (20, 0.2, 5)])
    held = k1s_buckets_hold(torch, device, data, ps, "ML-20M rank 20 C=4")
    held += k1s_buckets_hold(torch, device, data, padded, "ML-20M ranks 10/20/20")
    fold, groups = stats["eval_fold"]
    for g in groups:
        held += k1s_buckets_hold(torch, device, fold, g,
                                 f"ML-1M fold rank {max(p.rank for p in g)} C={len(g)}")
    plans = {f"rank {max(p.rank for p in g)} C={len(g)}": dataclasses.asdict(
        als.k1s_plan(len(g), max(p.rank for p in g))) for g in [ps, *groups]}
    stats["k1s_plans"] = plans
    log(f"K1s: {held} bucket solves bit-identical across the redesign, the earlier design "
        f"and K1 alone ({len(K1S_FORMS)} storages x explicit/implicit); plans {plans}")


def per_query_sums(chunk) -> tuple:
    """Sums of core/ranking.py's per-query P@K, AP@K and NDCG@K over a
    chunk ``(key, pred, actual, k)`` of queries, and the count of scored
    points (a worker of the eval phase's parity check). Items are coded
    as their index in the generated item ids: ``pred [n, K]`` (-1 pads),
    ``actual [n]`` the held-out item of each query, passed to the
    functions as the ``{"item": ...}`` record the folds hold."""
    sys.path.insert(0, ROOT)
    from predictionio_tpu_torch.core import ranking

    key, preds, actuals, k = chunk
    sums, n = [0.0, 0.0, 0.0], 0
    for row, item in zip(preds.tolist(), actuals.tolist()):
        pred = [x for x in row if x >= 0]
        actual = {"item": item}
        vals = (ranking.precision_at_k(pred, actual, k),
                ranking.average_precision_at_k(pred, actual, k),
                ranking.ndcg_at_k(pred, actual, k))
        if vals[0] is None:
            continue
        n += 1
        for j in range(3):
            sums[j] += vals[j]
    return key, sums, n


@phase("eval: the shipped recommendation sweep at the ML-1M shape (run_evaluation)")
def eval_sweep(torch, device, stats):
    """``run_evaluation`` of the shipped ``recommendation_eval`` sweep
    (ranks 5/10/10/20, 10 iterations, 3 folds, Precision@1 with MAP@1 and
    NDCG@1) on the port's recommendation engine, fed by a datasource of
    the ML-1M-shaped ratings (bench.py:2176 ``bench_eval``'s way):
    K1s, K2 and K3 counts set to 0 just before and read just after (the
    main path's), every candidate on the fast path, an EVALCOMPLETED
    instance, and each candidate's three scores equal to core/ranking.py's
    per-query functions on the same top-k matrices within 1e-6
    (tests/test_eval_fast_path.py:98-100).

    Then each kernel is held at the shapes the main path gave it, on what
    the main path recorded: K1s's launches equal to its groups' (the cost
    model trains ranks 5, 10 + 10 and 20 as three groups, C = 1, 2, 1),
    each candidate's factors bit-identical to ``ALSAlgorithm.train`` of
    it alone on its fold, one iteration of each group against K1s's plain
    version on the first fold, and each ``eval_topk`` answer (D = 5, 10,
    20) against K2's plain version on the same user rows."""
    from predictionio_tpu_torch.core import Engine, FirstServing
    from predictionio_tpu_torch.core.context import WorkflowContext
    from predictionio_tpu_torch.core.evaluation import Evaluation, MetricEvaluator
    from predictionio_tpu_torch.core.params import EngineParamsGenerator
    from predictionio_tpu_torch.core.ranking import MAPAtK, NDCGAtK, PrecisionAtK
    from predictionio_tpu_torch.core.workflow_eval import run_evaluation
    from predictionio_tpu_torch.data import storage as st
    from predictionio_tpu_torch.models import recommendation as rec
    from predictionio_tpu_torch.models import recommendation_eval as rec_eval
    from predictionio_tpu_torch.ops import als, topk

    t0 = time.perf_counter()
    rows, cols, vals, nu, ni = make_ml_shaped("1m")
    td = rec.TrainingData(user_ids=[f"u{j}" for j in range(nu)],
                          item_ids=[f"i{j}" for j in range(ni)],
                          rows=rows, cols=cols, ratings=vals)
    log(f"generated {len(vals)} ML-1M-shaped ratings in {time.perf_counter() - t0:.1f}s")
    # what the datasource and the algorithm handed on
    folds, sweeps, answers = [], [], []

    class GeneratedSource(rec.RecommendationDataSource):
        def read_training(self, ctx):
            return td

        def read_eval(self, ctx):
            folds[:] = super().read_eval(ctx)
            return folds

    class RecordingALS(rec.ALSAlgorithm):
        def train_sweep(self, ctx, fold_td, params_list):
            out = super().train_sweep(ctx, fold_td, params_list)
            sweeps.append((fold_td, list(params_list), out))
            return out

        def eval_topk(self, model, queries, k):
            out = super().eval_topk(model, queries, k)
            answers.append((self.params, model, queries, out))
            return out

    engine = Engine(GeneratedSource, rec.RecommendationPreparator,
                    {"als": RecordingALS}, FirstServing)
    grid = EngineParamsGenerator()
    grid.engine_params_list = [engine.params_from_variant({
        "datasource": {"params": {"app_name": "ML1M"}},
        "algorithms": [{"name": "als", "params": {
            "rank": rank, "lambda": reg, "num_iterations": 10}}]})
        for rank, reg in rec_eval.SWEEP]
    evaluation = Evaluation(engine=engine, evaluator=MetricEvaluator(
        metric=PrecisionAtK(k=rec_eval.K),
        other_metrics=[MAPAtK(k=rec_eval.K), NDCGAtK(k=rec_eval.K)]))
    storage = st.Storage(env={"PIO_FS_BASEDIR": tempfile.mkdtemp(prefix="pio_chip_smoke_eval_")})
    counters = (als.solve_bucket_sweep.launches, topk.gather_top_k_batch.launches,
                topk.gather_top_k_batch.kernel_launches, topk.ranking_metrics_batch.launches)
    try:
        for c in counters:  # the main path starts here
            c.reset()
        t0 = time.perf_counter()
        iid, result = run_evaluation(evaluation, grid, storage=storage,
                                     ctx=WorkflowContext(mode="Evaluation", device=device))
        wall = time.perf_counter() - t0
        k1s, k2_calls, k2_kernels, k3 = (c.value for c in counters)  # main path read
        inst = storage.get_metadata_evaluation_instances().get(iid)
    finally:
        shutil.rmtree(storage.env["PIO_FS_BASEDIR"], ignore_errors=True)
        storage.close()
    n_cand = len(rec_eval.SWEEP)
    if inst is None or inst.status != "EVALCOMPLETED":
        raise AssertionError(f"evaluation instance {iid}: {inst and inst.status}")
    if result.fast_path_candidates != n_cand:
        raise AssertionError(f"{result.fast_path_candidates}/{n_cand} candidates on the fast path")
    n_folds = len(folds)
    if min(k1s, k2_calls, k2_kernels, k3) <= 0 or k3 != n_cand * n_folds:
        raise AssertionError(f"main-path counts: K1s {k1s}, K2 {k2_calls} "
                             f"({k2_kernels} kernels), K3 {k3}")
    queries = sum(len(qa) for _, _, qa in folds)

    # parity: the per-query functions on the same top-k matrices
    # (item ids coded as their index in td.item_ids, a bijection, so the
    # functions see the same membership and order), in a pool beside the
    # K1s and K2 holds below
    code = {item: j for j, item in enumerate(td.item_ids)}
    by_fold = {id(qa[0][0]): np.fromiter((code[a["item"]] for _, a in qa), np.int64, len(qa))
               for _, _, qa in folds}
    workers = min(8, os.cpu_count() or 1)
    chunks = []
    for params, _, qs, answer in answers:
        actual = by_fold[id(qs[0])]
        inv = answer.index.inverse
        to_code = np.fromiter((code[inv[m]] for m in range(len(inv))), np.int64, len(inv))
        ids = host(answer.ids).astype(np.int64)
        pred = np.where(ids >= 0, to_code[np.clip(ids, 0, None)], -1)
        key = json.dumps(params.to_dict(), sort_keys=True)
        step = -(-len(actual) // workers)
        chunks += [(key, pred[i:i + step], actual[i:i + step], rec_eval.K)
                   for i in range(0, len(actual), step)]
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(workers)
    try:
        pending = pool.map_async(per_query_sums, chunks)
        k1s_err = eval_k1s_holds(torch, device, rec, sweeps, k1s, stats)
        stats["k1s_max_abs_err"] = max(stats.get("k1s_max_abs_err", 0.0), k1s_err)
        stats["topk_items_max_abs_err"] = max(stats.get("topk_items_max_abs_err", 0.0),
                                              eval_topk_holds(torch, device, topk, answers))
        parts = pending.get()
    finally:
        pool.terminate()
    per_query = {}
    for key in {p[0] for p in parts}:
        mine = [p for p in parts if p[0] == key]
        n = sum(p[2] for p in mine)
        per_query[key] = [sum(p[1][j] for p in mine) / n for j in range(3)]
    diff = 0.0
    for ep, ms in result.engine_params_scores:
        key = json.dumps(ep.algorithms[0][1].to_dict(), sort_keys=True)
        for got, want in zip([ms.score, *ms.other_scores], per_query[key]):
            diff = max(diff, abs(got - want))
    if not diff <= 1e-6:
        raise AssertionError(f"fast-path scores differ from the per-query functions by {diff}")

    phases = result.phase_seconds
    scoring_s = phases.get("predict", 0.0) + phases.get("metric", 0.0)
    stats["eval_launches"] = {"k1s": k1s, "k2_eval_calls": k2_calls,
                              "k2_eval_kernels": k2_kernels, "k3": k3}
    stats["eval"] = {
        "shape": f"ML-1M {nu} x {ni}, {len(vals)} ratings, {n_folds} folds",
        "candidates": n_cand, "fast_path_candidates": result.fast_path_candidates,
        "eval_queries": queries, "wall_s": wall, "phase_seconds": phases,
        "scores": [ms.score for _, ms in result.engine_params_scores],
        "best_index": result.best_idx, "per_query_max_abs_diff": diff,
        "eval_queries_per_s": n_cand * queries / scoring_s if scoring_s else None,
        "candidates_per_min": 60.0 * n_cand / wall, **stats["eval_launches"]}
    log(json.dumps({"eval": "recommendation_eval sweep", **stats["eval"]}))


def eval_k1s_holds(torch, device, rec, sweeps, k1s: int, stats) -> float:
    """K1s at the shapes the eval main path gave it, on what it recorded
    (``sweeps``: each fold's training data, candidate params and swept
    models): ``k1s`` launches equal to the groups' (``als.sweep_groups``)
    iterations x K1 launches an iteration; each candidate's factors
    bit-identical to ``ALSAlgorithm.train`` of it alone on the same fold;
    one iteration of each group against the plain version on the first
    fold, whose layout and groups go to ``stats["eval_fold"]``. Returns
    the max abs error of the plain comparisons."""
    from predictionio_tpu_torch.core.context import WorkflowContext
    from predictionio_tpu_torch.ops import als

    if not sweeps:
        raise AssertionError("the eval main path made no stacked training")
    expect, err, shapes = 0, 0.0, []
    for f, (fold_td, plist, models) in enumerate(sweeps):
        data = als.build_ratings_data(
            fold_td.rows, fold_td.cols, np.asarray(fold_td.ratings, np.float32),
            len(fold_td.user_ids), len(fold_td.item_ids),
            bucket_widths=tuple(plist[0].bucket_widths))
        cands = [als.ALSParams(rank=p.rank, iterations=p.num_iterations, reg=p.lambda_,
                               seed=p.seed, compute_dtype=p.compute_dtype,
                               storage_dtype=p.storage_dtype) for p in plist]
        if f == 0:
            stats["eval_fold"] = (data, [[cands[i] for i in idx]
                                         for idx in als.sweep_groups(cands)])
        for idx in als.sweep_groups(cands):
            rank = max(cands[i].rank for i in idx)
            expect += cands[0].iterations * k1s_launches_per_iteration(data, rank)
            if f == 0:
                shapes.append(f"rank {rank} C={len(idx)}")
                one = [als.ALSParams(rank=cands[i].rank, iterations=1, reg=cands[i].reg,
                                     seed=cands[i].seed) for i in idx]
                err = max(err, k1s_iteration_vs_plain(torch, data, one, device))
        for c, (p, model) in enumerate(zip(plist, models)):
            algo = rec.ALSAlgorithm(p)
            algo.device = device
            alone = algo.train(WorkflowContext(mode="Evaluation", device=device), fold_td)
            for name in ("user_factors", "item_factors", "user_scales", "item_scales"):
                a, b = getattr(model, name), getattr(alone, name)
                if (a is None) != (b is None) or (a is not None and a.tobytes() != b.tobytes()):
                    raise AssertionError(f"fold {f} candidate {c} (rank {p.rank}, lambda "
                                         f"{p.lambda_}): swept {name} not bit-identical to "
                                         "its training alone")
    if k1s != expect:
        raise AssertionError(f"K1s launched {k1s} kernels on the eval path, its groups "
                             f"need {expect}")
    log(f"K1s on the eval path: {k1s} launches as its groups need ({', '.join(shapes)}); "
        f"{sum(len(m) for _, _, m in sweeps)} candidate models bit-identical to their "
        f"trainings alone; 1 iteration of each group vs plain: max abs {err:.3g}")
    return err


def eval_topk_holds(torch, device, topk, answers) -> float:
    """Each ``eval_topk`` answer of the eval main path against K2's plain
    version on the same model's user rows: the known queries' rows equal
    to ``gather_top_k_batch_reference`` capped to each query's ``num``
    (:func:`hold_topk`), the unknown queries' rows all -1. Returns the max
    abs error."""
    err, ranks = 0.0, set()
    for params, model, queries, out in answers:
        known = [qi for qi, q in enumerate(queries) if q.user in model.user_index]
        unknown = sorted(set(range(len(queries))) - set(known))
        if unknown and not bool((out.ids[torch.tensor(unknown, device=device)] == -1).all()):
            raise AssertionError("eval_topk: an unknown user's row is not empty")
        U, V = model.device_factors(device)
        kr = out.ids.shape[1]
        at = torch.tensor(known, dtype=torch.int64, device=device)
        uixs = torch.tensor([model.user_index[queries[qi].user] for qi in known],
                            dtype=torch.int32, device=device)
        nums = torch.tensor([int(queries[qi].num) for qi in known], device=device)
        over = torch.arange(kr, device=device)[None, :] >= nums[:, None]

        def plain(lo, hi):
            s, i = topk.gather_top_k_batch_reference(uixs[lo:hi], U, V, kr)
            return s.masked_fill(over[lo:hi], 0.0), i.masked_fill(over[lo:hi], -1)

        e, equal = hold_topk(out.scores[at], out.ids[at], plain,
                             f"eval_topk rank {params.rank} lambda {params.lambda_}")
        err = max(err, e)
        ranks.add(params.rank)
        if equal != len(known):
            log(f"eval_topk rank {params.rank}: {len(known) - equal} near-tie rows")
    log(f"eval_topk: {len(answers)} answers (D = {sorted(ranks)}) equal to K2's plain "
        f"version on the same user rows, max abs {err:.3g}")
    return err


def eval_cli(cli, storage, app: str) -> dict:
    """``cli.main eval`` of the shipped sweep on ``app`` (its stdout
    captured): the last line the JAX verb's summary, the instance
    EVALCOMPLETED, every candidate on the fast path."""
    import io

    buf = io.StringIO()
    os.environ["PIO_EVAL_APP_NAME"] = app
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["eval",
                           "predictionio_tpu_torch.models.recommendation_eval.evaluation",
                           "predictionio_tpu_torch.models.recommendation_eval.param_grid"])
    finally:
        os.environ.pop("PIO_EVAL_APP_NAME", None)
    lines = buf.getvalue().strip().splitlines()
    summary = json.loads(lines[-1])
    keys = {"metric", "best_index", "best_params", "best_scores", "scores", "candidates",
            "fast_path_candidates", "phase_seconds", "cache", "instance_id"}
    inst = storage.get_metadata_evaluation_instances().get(summary["instance_id"])
    if (rc != 0 or set(summary) != keys or inst is None or inst.status != "EVALCOMPLETED"
            or summary["fast_path_candidates"] != summary["candidates"]):
        raise AssertionError(f"cli eval: rc {rc}, summary {lines[-1]}, "
                             f"instance {inst and inst.status}")
    return summary


@phase("eval times")
def eval_timings(torch, device, stats):
    """Device time per call (torch.profiler) of K3 at an ML-1M fold (Q =
    333,334, P = A = 1, k = 1: the shipped sweep's shape; and P = 10, A =
    3) beside its earlier one-warp design, of K2 at the eval shape (B =
    333,334 indices into a 6,040-row user table, D = 20, f32 and int8, k
    in {1, 10}), and of one K1s iteration at the ML-20M shape, rank 20, C
    = 4, beside its earlier design and K1 alone on the same tables 4
    times, on every clock (:func:`k1s_clocks`), and at the eval path's
    shapes (the first ML-1M fold's groups) beside its earlier design;
    each beside its plain version, its library yardstick
    (``torch.topk(U[ixs] @ V.T)``; K1s: the gather + bmm + cholesky path
    per bucket and candidate; none for K3) and its bound from this run's
    inputs."""
    from predictionio_tpu_torch.ops import als, topk

    mem_rate, fp32_rate = peaks(stats["device_name"])

    def bound(nbytes, flops):
        by = "bytes" if nbytes / mem_rate >= flops / fp32_rate else "operations"
        return max(nbytes / mem_rate, flops / fp32_rate) * 1e3, by

    rng = np.random.default_rng(SEED + 2)
    k3 = []
    for P, A in ((1, 1), (10, 3)):
        pred, actual, counts = ranking_case(torch, rng, EVAL_Q, P, A, device)
        nbytes = EVAL_Q * (P + A + 1) * 4 + EVAL_Q * 13
        b_ms, b_by = bound(nbytes, 0)

        def kernel():
            topk.ranking_metrics_batch(pred, actual, counts, P)

        def warp():  # the earlier design, one warp a row: the same-run baseline
            topk._ranking_metrics_warp(pred, actual, counts, P)

        # the two designs in turns: new, old, old, new
        dev = [_total(device_ms(torch, fn)) for fn in (kernel, warp, warp, kernel)]
        plain = device_ms(torch, lambda: topk.ranking_metrics_batch_reference(
            pred, actual, counts, P), runs=10)
        row = {"kernel": "ranking_metrics_batch", "Q": EVAL_Q, "P": P, "A": A, "k": P,
               "group": topk.k3_group(P),
               "kernel_device_ms": None if None in dev else (dev[0] + dev[3]) / 2,
               "kernel_device_ms_runs": [dev[0], dev[3]],
               "kernel_ms": cuda_median_ms(torch, kernel),
               "baseline_device_ms": None if None in dev else (dev[1] + dev[2]) / 2,
               "baseline_device_ms_runs": [dev[1], dev[2]],
               "baseline_ms": cuda_median_ms(torch, warp),
               "plain_device_ms": _total(plain), "plain_ms": cuda_median_ms(
                   torch, lambda: topk.ranking_metrics_batch_reference(
                       pred, actual, counts, P), runs=10, warmup=3),
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}
        k3.append(row)
        log(json.dumps(row))
    stats["k3_timings"] = k3

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 3)
    uixs = torch.randint(0, EVAL_USERS, (EVAL_Q,), generator=gen, device=device,
                         dtype=torch.int32)
    items6 = []
    for dtype in ("float32", "int8"):
        users = make_table(torch, dtype, EVAL_USERS, EVAL_RANK, False, gen, device)
        items = make_table(torch, dtype, EVAL_ITEMS, EVAL_RANK, False, gen, device)
        dense_u, dense = als.dense_factors(users), als.dense_factors(items)
        row_bytes = EVAL_RANK * (1 if dtype == "int8" else 4) + (4 if dtype == "int8" else 0)
        for k in (1, 10):
            nbytes = (EVAL_Q * 4 + (EVAL_USERS + EVAL_ITEMS) * row_bytes + EVAL_Q * k * 8)
            flops = 2 * EVAL_Q * EVAL_ITEMS * EVAL_RANK
            b_ms, b_by = bound(nbytes, flops)

            def kernel():
                topk.gather_top_k_batch(uixs, users, items, k)

            def plain():
                for lo in range(0, EVAL_Q, 65_536):
                    topk.gather_top_k_batch_reference(uixs[lo:lo + 65_536], users, items, k)

            def library():
                torch.topk(dense_u[uixs] @ dense.T, k, dim=1)

            dev = device_ms(torch, kernel, runs=10)
            row = {"kernel": "gather_top_k_batch (eval)", "B": EVAL_Q, "D": EVAL_RANK,
                   "U": EVAL_USERS, "I": EVAL_ITEMS, "dtype": dtype, "k": k,
                   "route": topk.k2_route(k, EVAL_ITEMS, EVAL_Q).name,
                   "chunks": len(topk.k2_chunks(k, EVAL_ITEMS, EVAL_Q)),
                   "kernel_device_ms": _total(dev),
                   "tile_device_ms": _total(dev, "tile_topk_kernel"),
                   "merge_device_ms": _total(dev, "merge_topk_kernel"),
                   "kernel_ms": cuda_median_ms(torch, kernel, runs=10),
                   "plain_ms": cuda_median_ms(torch, plain, runs=2, warmup=1),
                   "library_device_ms": _total(device_ms(torch, library, runs=10)),
                   "library_ms": cuda_median_ms(torch, library, runs=10),
                   "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops}
            items6.append(row)
            log(json.dumps(row))
    stats["topk_items_timings"] = items6

    mem_rate, fp32_rate = peaks(stats["device_name"])
    data = stats["ml20m"]
    ps = k1s_params([(20, reg, 3 + c) for c, reg in enumerate(K1S_REGS)], iterations=1)
    C = len(ps)
    rb = als.device_buckets(data.row_buckets, device)
    cb = als.device_buckets(data.col_buckets, device)
    clocks = k1s_clocks(torch, als, data, ps, rb, cb, runs=5, alone=True)
    regs = torch.tensor(K1S_REGS, dtype=torch.float32, device=device)
    U0, V0 = als.sweep_init(data, ps, device)
    Up, Vp = U0.clone(), V0.clone()

    def plain_iteration_c():
        for target, other, buckets in ((Up, Vp, rb), (Vp, Up, cb)):
            for b in buckets:
                als.solve_bucket_sweep_reference(other, b.col_ids, b.ratings, b.mask,
                                                 b.seg_start, regs, target, b.row_ids)

    def library_iteration():
        for target, other, buckets in ((Up, Vp, rb), (Vp, Up, cb)):
            for b in buckets:
                seg = als.seg_rows(b.seg_start, b.col_ids.shape[0])
                for c in range(C):
                    library_solve(torch, other[c], b, seg, K1S_REGS[c])

    b_ms, b_by, nbytes, flops = k1s_iteration_bound(torch, rb + cb, 20, C, mem_rate, fp32_rate)
    stats["k1s_timings"] = {
        "C": C, "rank": 20, "plan": dataclasses.asdict(als.k1s_plan(C, 20)), **clocks,
        "plain_ms": cuda_median_ms(torch, plain_iteration_c, runs=2, warmup=1),
        "library_ms": cuda_median_ms(torch, library_iteration, runs=2, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops}
    log(json.dumps({"k1s": "one iteration, ML-20M rank 20 f32", **stats["k1s_timings"]}))

    # the eval main path's shapes: the first fold's buckets, its groups
    fold, groups = stats["eval_fold"]
    frb = als.device_buckets(fold.row_buckets, device)
    fcb = als.device_buckets(fold.col_buckets, device)
    rows = []
    for g in groups:
        D, Cg = max(p.rank for p in g), len(g)
        one = [dataclasses.replace(p, iterations=1) for p in g]
        row = {"rank": D, "C": Cg, "plan": dataclasses.asdict(als.k1s_plan(Cg, D)),
               **k1s_clocks(torch, als, fold, one, frb, fcb, runs=20, alone=False)}
        row["bound_ms"], row["bound_by"], _, _ = k1s_iteration_bound(
            torch, frb + fcb, D, Cg, mem_rate, fp32_rate)
        rows.append(row)
        log(json.dumps({"k1s": "one iteration, an ML-1M fold (eval path)", **row}))
    stats["k1s_eval_timings"] = rows


def k1s_iteration_bound(torch, buckets, D: int, C: int, mem_rate, fp32_rate):
    """(bound ms, what bounds it, bytes, FP32 operations) of one K1s
    iteration of C candidates at rank D over ``buckets`` (f32 tables):
    :func:`k1_bound` of each bucket, its tables' bytes and its operations
    taken C times."""
    nbytes = flops = 0
    for b in buckets:
        _, bb, ff = k1_bound(torch, b, D, 4, 0)
        R = b.row_ids.shape[0]
        n_other = int(torch.unique(b.col_ids[b.mask > 0]).numel())
        tables = (n_other + R) * D * 4
        nbytes += bb - tables + C * tables
        flops += C * ff
    by = "bytes" if nbytes / mem_rate >= flops / fp32_rate else "operations"
    return max(nbytes / mem_rate, flops / fp32_rate) * 1e3, by, nbytes, flops


def k1s_clocks(torch, als, data, params, rb, cb, runs: int, alone: bool) -> dict:
    """One K1s iteration (f32, explicit) of the candidates ``params`` on
    :func:`clock_readings`' clocks: the redesigned kernel
    (``solve_bucket_sweep`` through ``_half_step``), the earlier design on
    contiguous stacks (``_solve_bucket_sweep_grid``) and, with ``alone``,
    K1 on each candidate's table in turn -- in turns new, old, [alone,]
    old, new, from the same init. ``ms``/``baseline_ms``/``k1_alone_ms``:
    the mean of the readings on the queued-events clock (device time with
    no host gaps), the clock every K1s and K1 time is stated on: a
    profiler trace now and then holds only some of an iteration's
    launches (``launches_held`` against ``launches_made``), and its
    per-launch mean times the launches a call then reads low;
    ``device_ms`` (torch.profiler) stays beside it."""
    device = rb[0].col_ids.device
    C, D = len(params), max(p.rank for p in params)
    per = k1s_launches_per_iteration(data, D)
    per_k1 = k1_launches_per_iteration(data, D)  # the earlier design's, and K1's
    regs = torch.tensor([p.reg for p in params], dtype=torch.float32, device=device)
    alphas = torch.ones_like(regs)
    U0, V0 = als.sweep_init(data, params, device)
    U, V = U0.clone(), V0.clone()
    Ug, Vg = U0.contiguous(), V0.contiguous()
    U1 = [U0[c].contiguous() for c in range(C)]
    V1 = [V0[c].contiguous() for c in range(C)]

    def new():
        als._half_step(U, V, rb, params[0], regs, alphas)
        als._half_step(V, U, cb, params[0], regs, alphas)

    def old():
        for target, other, buckets in ((Ug, Vg, rb), (Vg, Ug, cb)):
            for b in buckets:
                als._solve_bucket_sweep_grid(other, b.col_ids, b.ratings, b.mask, b.seg_start,
                                             regs, target, b.row_ids, alphas=alphas)

    def k1_alone():
        for c in range(C):
            als._half_step(U1[c], V1[c], rb, params[c])
            als._half_step(V1[c], U1[c], cb, params[c])

    order = [("new", new, per), ("old", old, per_k1)]
    if alone:
        order.append(("k1_alone", k1_alone, C * per_k1))
    order += [("old", old, per_k1), ("new", new, per)]
    read: dict = {}
    for name, fn, n in order:
        read.setdefault(name, []).append(clock_readings(torch, fn, n, runs=runs))
    out: dict = {}
    for name, rs in read.items():
        dev = [r["device_ms"] for r in rs]
        out[name] = {"queued_ms": sum(r["queued_ms"] for r in rs) / len(rs),
                     "device_ms": None if None in dev else sum(dev) / len(dev),
                     "launches_held": [r["launches_held"] for r in rs],
                     "launches_made": [r["launches_made"] for r in rs], "readings": rs}
    return {"clock": "queued CUDA events", "ms": out["new"]["queued_ms"],
            "baseline_ms": out["old"]["queued_ms"],
            "k1_alone_ms": out["k1_alone"]["queued_ms"] if alone else None,
            "launches_per_iteration": per, "baseline_launches_per_iteration": per_k1,
            "clocks": out}


def eval_phase(torch, device, stats):
    """The evaluation slice's checks, main path and times, in order."""
    for step in (k3_vs_plain, topk_items_vs_plain, k1s_vs_k1, eval_sweep, k1s_new_vs_old,
                 eval_timings):
        if failures:
            return
        step(torch, device, stats)


# -- the two-stage retrieval slice --------------------------------------------

RET_D = 32  # the JAX package's retrieval bench rank (bench.py:4957-4963)
RET_ROWS = (1_000_000, 10_000_000)  # its catalog rungs
RET_ITEMS = 1_000_000  # the retrieval phase's catalog
K4_BATCHES = (1, 8, 64)
K4_KPRIMES = (32, 128, 256, 1024)  # num = 4, 10, 20, 100
RET_NUM = 10  # serving num: k = 16, k' = 128
RET_USERS = 500  # distinct users a concurrency level
SIM_QUERIES = 500  # similar-product queries a concurrency level
RET_LEVELS = (1, 8)
REC_FACTORY = "predictionio_tpu_torch.models.recommendation.engine"


def coarse_pair(torch, rows: int, seed: int, device):
    """The dense f32 ``[rows, 32]`` table from the seed (host) and its int8
    pair (``quantize_rows`` on the card)."""
    from predictionio_tpu_torch.ops.als import quantize_rows

    f = np.random.default_rng(seed).standard_normal((rows, RET_D), dtype=np.float32)
    return f, quantize_rows(torch.from_numpy(f).to(device))


def hold_k4(torch, retrieval, cat, q, k: int, mode: str, fn=None) -> float:
    """K4 (``fn``: ``coarse_topk``, which takes the route ``k4_route``
    picks, ``_coarse_topk_stream`` or ``_coarse_topk_pair``, the
    two-launch baseline) against its plain version on the
    same catalog, scores and ids bit for bit (the same arithmetic in the
    same order, and a unique top k' under the composite order). Returns
    the max abs error of the finite scores (0 when bit-equal)."""
    fn = fn or retrieval.coarse_topk
    s_k, i_k = fn(q, cat._tiles, cat._scales, cat.num_rows, k, mode)
    s_p, i_p = retrieval.coarse_topk_reference(q, cat._tiles, cat._scales, cat.num_rows, k, mode)
    torch.cuda.synchronize()
    sk, sp = host(s_k), host(s_p)
    fin = np.isfinite(sp) & np.isfinite(sk)
    err = float(np.max(np.abs(sk[fin] - sp[fin]), initial=0.0))
    if not (same_bits(torch, s_k, s_p) and bool(torch.equal(i_k, i_p))):
        route = {retrieval._coarse_topk_stream: "stream",
                 retrieval._coarse_topk_pair: "pair"}.get(fn, retrieval.k4_route(k))
        raise AssertionError(f"K4 {route} route {mode} I={cat.num_rows} B={len(q)} k'={k}: "
                             f"not bit-equal to the plain version (max abs {err})")
    return err


K4_SMEM_CASES = (("warp", 8, 8, 32, "bf16", 3, 128, -1), ("warp", 8, 8, 32, "int8", 4, 32, -1),
                  ("warp", 1, 8, 32, "int8_dot", 4, 128, 0), ("warp", 8, 8, 10, "bf16", 4, 64, 1),
                  ("warp", 8, 5, 128, "bf16", 2, 128, 2), ("warp", 4, 3, 20, "int8", 3, 17, 0),
                  ("stream", 8, 8, 32, "bf16", 2, 512, -1), ("stream", 1, 8, 32, "int8", 2, 8192, 0),
                  ("stream", 4, 8, 10, "int8_dot", 3, 1024, 1), ("stream", 2, 4, 128, "bf16", 2, 2048, 2),
                  ("stream", 8, 8, 32, "bf16", 3, 129, 0))
K4_STREAM_KPRIMES = (129, 256, 512, 2048, 8192)  # the stream route's k' held at 1M


@phase("k4: coarse shortlist vs plain, both routes, and the fused two-stage call")
def k4_vs_plain(torch, device, stats):
    """K4 against its plain version on the card at the JAX package's
    retrieval rungs (I = 1,000,000 and 10,000,000, D = 32; tiles of 2^18,
    the last one padded): every mode (``int8`` and ``int8_dot`` on the
    int8 pair, ``bf16`` on the dense table's copy), B in {1, 8, 64}, k' in
    {32, 128} (the warp route) and {129, 256, 512, 1024, 2048, 8192} (the
    stream route) at 1M; at 10M k' 32 and 128 at every B and 512, 1024
    and 8192 at B = 8. Then crafted catalogs on both routes and on the
    pair (the two-launch baseline): 50 distinct rows repeated (exact ties
    at every k' boundary) with a NaN row (a NaN scale in the int8 pair);
    k' >= I (I = 100 on the warp route, 200 on the stream route); k' above
    K4_MAX_K refused. Every case bit for bit. Also: the C entries'
    shared-memory sizes of both routes (K4 alone and fused) against
    Python's, and one launch a call on either route. Then the fused
    two-stage call (``two_stage_top_k``, K5 as the epilogue of K4's
    merge) at 1M: every mode x every item-table dtype (f32, bf16, int8
    pair) x every query form, at (B, k', k) = (1, 32, 4), (8, 128, 16)
    (the warp route), (8, 512, 64) and (64, 256, 32) (the stream route),
    bit for bit against the composed plain versions and against K4 then
    the standalone K5 on the card, one launch a call and no standalone
    K5 launch; and on catalogs of 100 and 200 rows at k' past them (-1
    shortlist slots)."""
    from predictionio_tpu_torch.ops import retrieval

    lib = retrieval._lib()
    for rb, S, D in ((8, 512, 32), (1, 16384, 32), (4, 2048, 10), (2, 4096, 128)):
        got, want = lib.pio_k4_tile_smem(rb, S, D), retrieval.k4_tile_smem(rb, S, D)
        if got != want:
            raise AssertionError(f"k4_tile_smem({rb}, {S}, {D}): C {got}, Python {want}")
    for route, rb, nw, D, mode, st, kp, vd in K4_SMEM_CASES:
        got = lib.pio_k4_smem(retrieval._ROUTE_CODE[route], rb, nw, D, retrieval._MODE_CODE[mode],
                              st, kp, vd)
        want = retrieval.k4_smem(route, rb, nw, D, mode, st, kp, vd)
        if got != want:
            raise AssertionError(f"k4_smem({route}, {rb}, {nw}, {D}, {mode}, {st}, {kp}, {vd}): "
                                 f"C {got}, Python {want}")
    gen = torch.Generator(device=device).manual_seed(SEED + 30)
    queries = torch.randn((max(K4_BATCHES), RET_D), generator=gen, device=device)
    cases = {"warp": 0, "stream": 0, "pair": 0}
    max_err = 0.0

    def held(cat, b, k, mode, fn=None):
        nonlocal max_err
        max_err = max(max_err, hold_k4(torch, retrieval, cat, queries[:b], k, mode, fn))
        cases[{None: retrieval.k4_route(k), retrieval._coarse_topk_stream: "stream",
               retrieval._coarse_topk_pair: "pair"}[fn]] += 1

    fused = {"cases": 0, "launches": 0}
    for rows in RET_ROWS:
        f, pair = coarse_pair(torch, rows, SEED + 31, device)
        cats = {"int8": retrieval.CoarseCatalog(pair, device=device),
                "bf16": retrieval.CoarseCatalog(f, device=device)}
        if cats["int8"].mode != "int8" or cats["bf16"].mode != "bf16":
            raise AssertionError("auto coarse modes: int8 pair -> int8, dense -> bf16")
        if rows % cats["int8"].tile == 0:
            raise AssertionError("the rung's tiles should not divide I")
        grid = [(b, k) for b in K4_BATCHES for k in (32, 128, 256, 1024)] \
            + [(8, k) for k in K4_STREAM_KPRIMES] + [(1, 512), (64, 512), (64, 8192)] \
            if rows == RET_ROWS[0] else \
            [(b, k) for b in K4_BATCHES for k in (32, 128)] + [(8, 512), (8, 1024), (8, 8192)]
        for mode in retrieval.MODES:
            cat = cats["bf16" if mode == "bf16" else "int8"]
            for b, k in grid:
                held(cat, b, k, mode)
            # one launch a call on either route, counted on its route
            for k in (128, 512):
                route = retrieval.k4_route(k)
                w0 = (retrieval.coarse_topk.kernel_launches.value,
                      retrieval.coarse_topk.routes[route].value)
                retrieval.coarse_topk(queries[:8], cat._tiles, cat._scales, rows, k, mode)
                torch.cuda.synchronize()
                w1 = (retrieval.coarse_topk.kernel_launches.value,
                      retrieval.coarse_topk.routes[route].value)
                if (w1[0] - w0[0], w1[1] - w0[1]) != (1, 1):
                    raise AssertionError(f"K4 {route} route {mode}: launches, calls {w0} -> {w1}")
        log(f"K4 I={rows}: {len(grid) * 3} cases held")
        if rows == RET_ROWS[0]:
            fused = k45_fused_vs_plain(torch, retrieval, device, f, pair, cats, fused)
        del f, pair, cats
        torch.cuda.empty_cache()

    rng = np.random.default_rng(SEED + 32)
    base = rng.integers(-3, 4, (50, RET_D)).astype(np.float32)
    f = base[np.arange(100_000) % 50]
    vq, vs = quantize_rows_host(torch, f, device)
    vs[777] = float("nan")
    f[777, 5] = float("nan")
    tied = {"int8": retrieval.CoarseCatalog((vq, vs), tile=1 << 15, device=device),
            "bf16": retrieval.CoarseCatalog(f, tile=1 << 15, device=device)}
    small = {}
    for n, tile in ((200, 256), (100, 128)):
        fs = np.random.default_rng(SEED + 33).standard_normal((n, RET_D), dtype=np.float32)
        small[n] = {"int8": retrieval.CoarseCatalog(quantize_rows_host(torch, fs, device),
                                                    tile=tile, device=device),
                    "bf16": retrieval.CoarseCatalog(fs, tile=tile, device=device),
                    "table": torch.from_numpy(fs).to(device)}
    for mode in retrieval.MODES:
        cat = tied["bf16" if mode == "bf16" else "int8"]
        for b, k in ((1, 128), (8, 32), (64, 128), (8, 1024), (64, 256), (8, 129), (8, 8192)):
            held(cat, b, k, mode)
            held(cat, b, k, mode, retrieval._coarse_topk_stream)
            held(cat, b, k, mode, retrieval._coarse_topk_pair)
        for n, k in ((200, 256), (100, 128)):
            cat = small[n]["bf16" if mode == "bf16" else "int8"]
            s, ids = retrieval.coarse_topk(queries[:8], cat._tiles, cat._scales, n, k, mode)
            held(cat, 8, k, mode)
            n_pad = int((ids < 0).sum())
            if n_pad != 8 * (k - n) or bool((s[ids < 0] != -1e30).any()):
                raise AssertionError(f"K4 {mode} k'={k} >= I={n}: {n_pad} pad slots")
            # the fused call past the catalog: -1 slots in the shortlist
            table = small[n]["table"]
            cm = retrieval.CoarseCatalog(host(table), tile=cat.tile, mode=mode, device=device)
            got = retrieval.two_stage_top_k(cm, queries[:8], k, k, "vectors", table,
                                            vectors=queries[:8])
            _, cand = retrieval.coarse_topk_reference(queries[:8], cm._tiles, cm._scales, n, k,
                                                      mode)
            ps, pi = retrieval.rescore_top_k_reference("vectors", table, cand, k,
                                                       vectors=queries[:8])
            if not (np.array_equal(got[0].view(np.int32), host(ps).view(np.int32))
                    and np.array_equal(got[1], host(pi)) and (got[1][:, n:] == -1).all()):
                raise AssertionError(f"two_stage_top_k {mode} k'={k} >= I={n}: not the plain "
                                     "answer")
            fused["cases"] += 1
    try:
        retrieval.coarse_topk(queries[:1], small[200]["bf16"]._tiles, None, 200,
                              retrieval.K4_MAX_K + 1, "bf16")
    except ValueError as e:
        if "K4_MAX_K" not in str(e):
            raise
    else:
        raise AssertionError(f"K4 took k' = {retrieval.K4_MAX_K + 1}")
    stats["k4_max_abs_err"] = max_err
    stats["k45_max_abs_err"] = 0.0
    stats["k45_cases"] = fused["cases"]
    log(json.dumps({"k4": {"cases": cases, "bit_equal": sum(cases.values()),
                           "max_abs_err": max_err},
                    "two_stage": {"cases": fused["cases"], "bit_equal": fused["cases"],
                                  "launches_per_call": 1}}))


K45_CASES = ((1, 32, 4), (8, 128, 16), (8, 512, 64), (64, 256, 32))  # (B, k', k)


def k45_fused_vs_plain(torch, retrieval, device, f: np.ndarray, pair, cats: dict,
                       fused: dict) -> dict:
    """The fused two-stage call at one rung: every coarse mode x item-table
    dtype x query form x K45_CASES, bit for bit against the composed
    plain versions (coarse_topk_reference, then rescore_top_k_reference)
    and against K4 then the standalone K5 on the card; each call one
    launch on K4's counter, none on K5's, one K4 and one K5 call."""
    rng = np.random.default_rng(SEED + 35)
    rows = f.shape[0]
    V = torch.from_numpy(f).to(device)
    tables = {"float32": V, "bfloat16": V.to(torch.bfloat16), "int8": pair}
    uf = torch.from_numpy(rng.standard_normal((U_ROWS, RET_D), dtype=np.float32)).to(device)
    users = storage_forms(torch, host(uf), device)
    B = max(b for b, _, _ in K45_CASES)
    uixs = torch.from_numpy(rng.choice(U_ROWS, B, replace=False).astype(np.int32)).to(device)
    vecs = torch.from_numpy(rng.standard_normal((B, RET_D), dtype=np.float32)).to(device)
    row_ixs = torch.from_numpy(rng.integers(0, rows, (B, 4)).astype(np.int32)).to(device)
    row_w = torch.ones((B, 4), device=device)
    row_w[::3, 2:] = 0.0  # weight-0 padding, as the templates pad
    coarse = {"int8": cats["int8"], "bf16": cats["bf16"],
              "int8_dot": retrieval.CoarseCatalog(pair, mode="int8_dot", device=device)}
    counters = (retrieval.coarse_topk.kernel_launches, retrieval.rescore_top_k.kernel_launches,
                retrieval.coarse_topk.launches, retrieval.rescore_top_k.launches)
    for mode, cat in coarse.items():
        for vd, table in tables.items():
            for form in retrieval.QUERY_FORMS:
                U = users[vd]
                for b, kp, k in K45_CASES:
                    if form == "gather":
                        args = dict(user_ixs=uixs[:b], user_factors=U)
                        q = topk_dense_rows(torch, U, uixs[:b])
                    elif form == "vectors":
                        args = dict(vectors=vecs[:b])
                        q = vecs[:b]
                    else:
                        args = dict(row_ixs=row_ixs[:b], row_weights=row_w[:b])
                        q = (topk_dense_rows(torch, table, row_ixs[:b]) * row_w[:b, :, None]).sum(1)
                    before = [c.value for c in counters]
                    s, i = retrieval.two_stage_top_k(cat, q, kp, k, form, table, **args)
                    moved = [c.value - v for c, v in zip(counters, before)]
                    if moved != [1, 0, 1, 1]:
                        raise AssertionError(f"two_stage_top_k {mode} {vd} {form} B={b} "
                                             f"k'={kp}: K4/K5 launches, calls moved {moved}")
                    _, cand = retrieval.coarse_topk_reference(q, cat._tiles, cat._scales, rows,
                                                              kp, mode)
                    ps, pi = retrieval.rescore_top_k_reference(form, table, cand, k, **args)
                    _, c2 = retrieval.coarse_topk(q, cat._tiles, cat._scales, rows, kp, mode)
                    s2, i2 = retrieval.rescore_top_k(form, table, c2, k, **args)
                    for what, (ws, wi) in (("the composed plain versions", (ps, pi)),
                                           ("K4 then the standalone K5", (s2, i2))):
                        if not (np.array_equal(s.view(np.int32), host(ws).view(np.int32))
                                and np.array_equal(i, host(wi))):
                            bad = np.nonzero(i != host(wi))
                            raise AssertionError(
                                f"two_stage_top_k {mode} {vd} {form} B={b} k'={kp} k={k}: not "
                                f"bit-equal to {what} (ids differ at {list(zip(*bad))[:4]})")
                    fused["cases"] += 1
                    fused["launches"] += moved[0]
    log(f"two-stage fused at I={rows}: {fused['cases']} cases held, one launch each")
    return fused


def topk_dense_rows(torch, table, ixs):
    """``table[ixs]`` as f32 (an int8 pair dequantized after the gather)."""
    from predictionio_tpu_torch.ops import topk

    return topk._dense_rows(table, ixs.long())


def quantize_rows_host(torch, f: np.ndarray, device):
    """``quantize_rows`` of a host table on the card, back on the host."""
    from predictionio_tpu_torch.ops.als import quantize_rows

    q, s = quantize_rows(torch.from_numpy(f).to(device))
    return host(q), host(s)


def storage_forms(torch, f: np.ndarray, device) -> dict:
    """A host f32 table on the card in each storage dtype."""
    from predictionio_tpu_torch.ops.als import quantize_rows

    t = torch.from_numpy(f).to(device)
    return {"float32": t, "bfloat16": t.to(torch.bfloat16), "int8": quantize_rows(t)}


def same_as_k2(torch, s5, i5, s2, i2, what: str) -> None:
    """K5's top list against K2's on the same pairs: scores bit for bit;
    ids equal, or the same set within a run of equal scores."""
    if not same_bits(torch, s5, s2):
        raise AssertionError(f"{what}: K5 scores not bit-equal to K2's")
    a, b, s = host(i5), host(i2), host(s2)
    start = 0
    for j in range(1, len(s) + 1):
        if j == len(s) or s[j] != s[start]:
            if set(a[start:j].tolist()) != set(b[start:j].tolist()):
                raise AssertionError(f"{what}: ids {a[start:j]} vs K2 {b[start:j]}")
            start = j


@phase("k5: shortlist rescore vs plain and K2")
def k5_vs_plain(torch, device, stats):
    """K5 against its plain version on the card, at I = 1,000,000, D = 32:
    each query form (user rows of a 138,493-row table, given vectors,
    summed catalog rows) with every f32/bf16/int8 storage (user x item
    for the gather form), B in {1, 8, 64}, candidates from a real K4
    shortlist (k' = 128) with every 9th slot of odd rows set to -1:
    scores and ids bit for bit. Then rows 0..7 of each B = 8 call against
    K2 on the same pairs (K2, or K2's summed-rows mode, over the catalog
    with everything but the row's candidates masked): every score bit for
    bit, ids equal outside runs of equal scores."""
    from predictionio_tpu_torch.ops import retrieval, topk

    rng = np.random.default_rng(SEED + 34)
    vf = rng.standard_normal((RET_ITEMS, RET_D), dtype=np.float32)
    uf = rng.standard_normal((U_ROWS, RET_D), dtype=np.float32)
    Vs, Us = storage_forms(torch, vf, device), storage_forms(torch, uf, device)
    uixs = torch.from_numpy(rng.choice(U_ROWS, 64, replace=False).astype(np.int32)).to(device)
    cat = retrieval.CoarseCatalog(vf, device=device)
    _, cand = retrieval.coarse_topk(Us["float32"][uixs.long()], cat._tiles, None,
                                    RET_ITEMS, 128, "bf16")
    cand = cand.clone()
    cand[1::2, 4::9] = -1
    vecs = torch.from_numpy(rng.standard_normal((64, RET_D), dtype=np.float32)).to(device)
    row_ixs = torch.from_numpy(rng.integers(0, RET_ITEMS, (64, 4)).astype(np.int32)).to(device)
    row_w = torch.ones((64, 4), device=device)
    row_w[::3, 2:] = 0.0  # weight-0 padding, as the template pads
    cases = 0
    for vd, V in Vs.items():
        forms = [("gather", ud, dict(user_ixs=uixs, user_factors=U)) for ud, U in Us.items()]
        forms += [("vectors", "-", dict(vectors=vecs)),
                  ("sum_rows", "-", dict(row_ixs=row_ixs, row_weights=row_w))]
        for form, ud, args in forms:
            for b in K4_BATCHES:
                part = {n: a[:b] if n != "user_factors" else a for n, a in args.items()}
                s_k, i_k = retrieval.rescore_top_k(form, V, cand[:b], RET_NUM, **part)
                s_p, i_p = retrieval.rescore_top_k_reference(form, V, cand[:b], RET_NUM, **part)
                torch.cuda.synchronize()
                if not (same_bits(torch, s_k, s_p) and torch.equal(i_k, i_p)):
                    raise AssertionError(f"K5 {form} U {ud} V {vd} B={b}: not bit-equal")
                cases += 1
            for r in range(8):
                ok = cand[r] >= 0
                kk = int(ok.sum())
                mask = torch.ones(RET_ITEMS, dtype=torch.bool, device=device)
                mask[cand[r][ok].long()] = False
                one = {n: a[r:r + 1] if n != "user_factors" else a for n, a in args.items()}
                s5, i5 = retrieval.rescore_top_k(form, V, cand[r:r + 1], kk, **one)
                if form == "gather":
                    s2, i2 = topk.gather_top_k_batch(one["user_ixs"], one["user_factors"], V,
                                                     kk, exclude_mask=mask)
                elif form == "vectors":
                    s2, i2 = topk.top_k_items_batch(one["vectors"], V, kk, exclude_mask=mask)
                else:
                    s2, i2 = topk.sum_rows_top_k_batch(one["row_ixs"], one["row_weights"], V,
                                                       kk, exclude_mask=mask)
                same_as_k2(torch, s5[0], i5[0], s2[0], i2[0], f"K5 {form} U {ud} V {vd} row {r}")
    log(json.dumps({"k5": {"cases": cases, "bit_equal_to_plain": cases,
                           "rows_bit_equal_to_k2": 8 * 5 * len(Vs)}}))
    stats["k5_max_abs_err"] = 0.0


def metric_delta(after: dict, before: dict, name: str) -> float:
    return after.get(name, 0.0) - before.get(name, 0.0)


def check_warm_k4(m: dict, mode: str, what: str) -> None:
    """The server's warmup went two-stage: the coarse catalog was built
    and K4 ran before /readyz answered."""
    if m.get(K4_CALLS % mode, 0) < 1:
        raise AssertionError(f"{what}: warmup did not build the coarse catalog and run K4")


def check_dispatch_counts(lv: dict, k2: int, what: str, route: str = "warp") -> None:
    """Per two-stage dispatch: one fused call (``pio_two_stage_calls``),
    one launch (``pio_k4_kernel_launches``: K5 runs as the epilogue of
    K4's merge) on ``route`` (the warp route for k' <= 128, the stream
    route above), counted as one K4 call (``pio_k4_calls``,
    ``pio_k4_route_calls``) and one K5 call (``pio_k5_calls``), with no
    standalone K5 launch; K2 (or K2s) ``k2`` calls -- the live probe's."""
    d = lv["dispatches"]
    k2_seen = lv.get("k2", lv.get("k2s"))
    if not (d > 0 and lv["k4"] == lv["k5"] == d and lv[f"k4_{route}"] == d
            and lv["k4_warp"] + lv["k4_stream"] == d and lv[f"two_stage_{route}"] == d
            and lv["two_stage_warp"] + lv["two_stage_stream"] == d and lv["k4_kernels"] == d
            and lv["k5_kernels"] == 0 and k2_seen == k2 and lv.get("probes", k2) == k2):
        raise AssertionError(f"{what}: counts per dispatch {lv} ({d} dispatches)")


def check_exact_round(lv: dict, n: int) -> None:
    """Queries that stay exact at retrieval scale: no K4, one K2s each."""
    if lv["k4"] != 0 or lv["k2s"] != n:
        raise AssertionError(f"exact round: {lv}")


def plain_rec_two_stage(torch, retrieval, model, cat, device, uixs: np.ndarray, k: int):
    """What a two-stage recommendation dispatch must answer, from the
    plain versions of K4 and K5 on the card: ([B, k] scores, [B, k] ids,
    [B, k'] shortlist)."""
    U, V = model.device_factors(device)
    kp = retrieval.shortlist_k(k, cat.num_rows)
    q = torch.from_numpy(model.user_rows(uixs)).to(device)
    _, cand = retrieval.coarse_topk_reference(q, cat._tiles, cat._scales, cat.num_rows, kp,
                                              cat.mode)
    s, i = retrieval.rescore_top_k_reference("gather", V, cand, k, user_ixs=uixs,
                                             user_factors=U)
    return host(s), host(i), host(cand)


def hold_rec_answers(torch, retrieval, topk, model, device, answers: dict, users: list,
                     what: str) -> dict:
    """Every answer against the plain two-stage version (ids outside near
    ties; scores within RTOL) and against exact K2: recall@num over all
    queries, and where the shortlist holds the exact top num, the answer
    is K2's, scores bit for bit."""
    cat = model.coarse_catalog(device)
    U, V = model.device_factors(device)
    k = 1 << (RET_NUM - 1).bit_length()
    hits = covered = 0
    for lo in range(0, len(users), 50):
        chunk = users[lo:lo + 50]
        uixs = np.asarray([model.user_index[u] for u in chunk], np.int32)
        ps, pi, cand = plain_rec_two_stage(torch, retrieval, model, cat, device, uixs, k)
        es, ei = topk.gather_top_k_batch(uixs, U, V, k)
        es, ei = host(es)[:, :RET_NUM], host(ei)[:, :RET_NUM]
        for b, u in enumerate(chunk):
            got = json.loads(answers[u])["itemScores"]
            ids = np.asarray([model.item_index[x["item"]] for x in got])
            sc = np.asarray([x["score"] for x in got], np.float32)
            if len(ids) != RET_NUM or not np.allclose(sc, ps[b, :RET_NUM], rtol=RTOL, atol=ATOL) \
                    or not near_tie_ids_ok(ids, pi[b, :RET_NUM], ps[b, :RET_NUM]):
                raise AssertionError(f"{what} {u}: {ids} {sc} vs plain {pi[b, :RET_NUM]} "
                                     f"{ps[b, :RET_NUM]}")
            hits += len(set(ids.tolist()) & set(ei[b].tolist()))
            if set(ei[b].tolist()) <= set(cand[b].tolist()):
                covered += 1
                if not np.array_equal(sc.view(np.int32), es[b].view(np.int32)) or \
                        not near_tie_ids_ok(ids, ei[b], es[b]):
                    raise AssertionError(f"{what} {u}: covered, yet {ids} {sc} vs K2 "
                                         f"{ei[b]} {es[b]}")
    recall = hits / (RET_NUM * len(users))
    if recall < 0.999:
        raise AssertionError(f"{what}: recall@{RET_NUM} {recall} < 0.999")
    return {"recall": recall, "covered": covered, "queries": len(users)}


def retrieval_round(server, queries: list, concurrency: int, key, kernels: dict) -> dict:
    """One closed-loop level against a two-stage server: answers,
    p50/p99/qps, and per-dispatch counts from its /metrics."""
    m0 = server.metrics()
    run = closed_loop(server.port, queries, concurrency, key)
    m1 = server.metrics()
    lat = sorted(run["lat"])
    counts = {name: int(metric_delta(m1, m0, metric)) for name, metric in kernels.items()}
    counts["dispatches"] = int(metric_delta(m1, m0, "pio_batch_size_count"))
    counts["k2cos"] = k2cos_served(m1, m0)
    return {"answers": run["answers"], "p50_ms": lat[len(lat) // 2] * 1e3,
            "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))] * 1e3,
            "qps": len(queries) / run["wall_s"], **counts}


def check_traced(server, body: dict, trace_id: str) -> list:
    """A traced two-stage request carries dispatch.shortlist/rescore
    (sent before the query rounds: /traces.json keeps the slowest recent
    traces)."""
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
    try:
        conn.request("POST", "/queries.json", json.dumps(body).encode(),
                     {"Content-Type": "application/json", "X-PIO-Trace": trace_id})
        resp = conn.getresponse()
        resp.read()
    finally:
        conn.close()
    traces = json.loads(server.get("/traces.json")[1])["traces"]
    mine = [t for t in traces if t["traceId"] == trace_id]
    names = [sp["name"] for sp in mine[0]["spans"]] if mine else []
    if resp.status != 200 or not {"dispatch.shortlist", "dispatch.rescore"} <= set(names):
        raise AssertionError(f"traced request: HTTP {resp.status}, spans {names}")
    return names


K4_CALLS = 'pio_k4_calls{mode="%s"}'
K2COS_CALLS = tuple(f'pio_k2_calls{{kernel="top_k_similar",route="{r}"}}'
                    for r in ("tile", "select"))


def k2cos_served(after: dict, before: dict) -> int:
    """``top_k_similar`` (K2's cosine mode) calls a deployed server made
    between two /metrics reads."""
    return int(sum(metric_delta(after, before, name) for name in K2COS_CALLS))

K4_ROUTES = {"k4_warp": 'pio_k4_route_calls{route="warp"}',
             "k4_stream": 'pio_k4_route_calls{route="stream"}',
             "two_stage_warp": 'pio_two_stage_calls{route="warp"}',
             "two_stage_stream": 'pio_two_stage_calls{route="stream"}'}
K5_CALLS = 'pio_k5_calls{query="%s"}'


def rec_retrieval(torch, device, storage, basedir, stats, servers) -> dict:
    """The recommendation template at U = 138,493, I = 1,000,000, rank 32,
    f32 (probe off) and int8 (probe every dispatch) storage."""
    from predictionio_tpu_torch.core.workflow import save_instance
    from predictionio_tpu_torch.models import recommendation as rec
    from predictionio_tpu_torch.ops import retrieval, topk

    rng = np.random.default_rng(SEED + 40)
    uf = rng.standard_normal((U_ROWS, RET_D), dtype=np.float32)
    vf = rng.standard_normal((RET_ITEMS, RET_D), dtype=np.float32)
    user_ids = [f"u{j}" for j in range(U_ROWS)]
    item_ids = [f"i{j}" for j in range(RET_ITEMS)]
    users = [f"u{int(j)}" for j in rng.permutation(U_ROWS)[:RET_USERS]]
    queries = [{"user": u, "num": RET_NUM} for u in users]
    engine = rec.engine()
    out = {}
    started = []
    for dtype, probe in (("float32", 0), ("int8", 1)):
        if dtype == "int8":
            (uq, us), (vq, vs) = (quantize_rows_host(torch, a, device) for a in (uf, vf))
            model = rec.model_from_numpy(user_ids, item_ids, uq, vq, us, vs)
        else:
            model = rec.model_from_numpy(user_ids, item_ids, uf, vf)
        ep = engine.params_from_variant({"algorithms": [{"name": "als", "params": {
            "rank": RET_D, "storage_dtype": dtype}}]})
        iid = save_instance(engine, ep, [model], engine_id=f"chip-smoke-ret-{dtype}",
                            engine_variant="ret", engine_factory=REC_FACTORY, storage=storage)
        server = DeployProcess(basedir, iid, device.type, ["--batch-window-ms", str(BATCH_WINDOW_MS)],
                               f"ret-{dtype}", {"PIO_RETRIEVAL_PROBE_EVERY": str(probe)},
                               wait=False)
        servers.append(server)
        started.append((dtype, probe, model, server))
    yield  # every server of the phase starts before the first is measured
    for dtype, probe, model, server in started:
        mode = "int8" if dtype == "int8" else "bf16"
        kernels = {"k4": K4_CALLS % mode, "k5": K5_CALLS % "gather", **K4_ROUTES,
                   "k4_kernels": "pio_k4_kernel_launches", "k5_kernels": "pio_k5_kernel_launches",
                   "k2": 'pio_k2_calls{kernel="gather_top_k_batch",route="tile"}',
                   "probes": "pio_retrieval_probes_total"}
        ready_s = server.wait_ready()
        check_warm_k4(server.metrics(), mode, dtype)
        # first, while the server's ring of slowest traces has room
        spans = check_traced(server, queries[0], f"c0ffee00000000{len(out):02d}")
        levels = {}
        for c in RET_LEVELS:
            levels[c] = lv = retrieval_round(server, queries, c, lambda q: q["user"], kernels)
            check_dispatch_counts(lv, lv["dispatches"] if probe else 0, f"{dtype} c={c}")
        if levels[1]["answers"] != levels[8]["answers"]:
            raise AssertionError(f"{dtype}: batched answers differ from solo ones")
        held = hold_rec_answers(torch, retrieval, topk, model, device, levels[1]["answers"],
                                users, f"recommendation {dtype}")
        doc = json.loads(server.get("/stats.json")[1])
        block = doc.get("retrieval", {})
        if set(block) != set(retrieval.stats_block()) or \
                block["two_stage_queries"] < len(RET_LEVELS) * RET_USERS:
            raise AssertionError(f"{dtype}: /stats.json retrieval block {block}")
        m = server.metrics()
        out[dtype] = {"ready_s": ready_s, "coarse_mode": mode, **held,
                      "probe_recall": m.get("pio_retrieval_probe_recall"),
                      "stats_block": {k: block[k] for k in ("two_stage_queries", "exact_queries",
                                                            "probes")},
                      "trace_spans": spans,
                      **{f"c{c}": {k: v for k, v in lv.items() if k != "answers"}
                         for c, lv in levels.items()}}
        server.stop()
        log(json.dumps({"retrieval": f"recommendation {dtype}", **out[dtype]}))
    return out


def plain_sim(torch, retrieval, topk, model, device, qs: list, index=None, factors=None,
              field: str = "items") -> list:
    """Each similar-product query alone (k = pow2(num + |excluded|)),
    from the plain two-stage versions on the card, and from exact K2s:
    [(plain ids, plain scores, exact ids, exact scores)] after the
    template's exclusions. ``index``, ``factors`` and ``field`` name the
    catalog of another cosine template (recommended-user: the followed
    users, queried by ``users``)."""
    from predictionio_tpu_torch.models.filters import normalized_query_vectors

    V = model.device_factors(device)
    cat = model.coarse_catalog(device)
    index = model.item_index if index is None else index
    factors = model.item_factors if factors is None else factors
    out = []
    for q in qs:
        known = [index[i] for i in q[field]]
        excluded = set(known) | {index[i] for i in q.get("blackList", ())}
        L = 1 << (len(known) - 1).bit_length()
        ixs = np.zeros((1, L), np.int32)
        w = np.zeros((1, L), np.float32)
        ixs[0, :len(known)] = known
        w[0, :len(known)] = 1.0
        k = 1 << (q["num"] + len(excluded) - 1).bit_length()
        kp = retrieval.shortlist_k(k, RET_ITEMS)
        qv = torch.from_numpy(normalized_query_vectors(factors, None, ixs, w)).to(device)
        _, cand = retrieval.coarse_topk_reference(qv, cat._tiles, None, RET_ITEMS, kp, cat.mode)
        ps, pi = retrieval.rescore_top_k_reference("sum_rows", V, cand, k, row_ixs=ixs,
                                                   row_weights=w)
        es, ei = topk.sum_rows_top_k_batch(ixs, w, V, k)
        row = []
        for s, i in ((ps, pi), (es, ei)):
            keep = [(int(x), float(y)) for y, x in zip(host(s)[0], host(i)[0])
                    if x >= 0 and int(x) not in excluded][:q["num"]]
            row += [np.asarray([x for x, _ in keep]), np.asarray([y for _, y in keep], np.float32)]
        out.append(row)
    return out


def sim_retrieval(torch, device, storage, basedir, stats, servers) -> dict:
    """The similar-product template at I = 1,000,000, rank 10 (its
    default), f32: queries of 1-4 items at num = 10 at concurrency 1 and
    8; then alone: queries whose blackList holds the exact top 20 (their
    answers come from deeper in a larger shortlist), and queries with
    ``categories`` (exact masked K2s, counted as exact)."""
    from predictionio_tpu_torch.core.workflow import save_instance
    from predictionio_tpu_torch.data.bimap import BiMap
    from predictionio_tpu_torch.models import similarproduct as sim
    from predictionio_tpu_torch.ops import retrieval, topk

    rng = np.random.default_rng(SEED + 41)
    vf = rng.standard_normal((RET_ITEMS, 10), dtype=np.float32)
    item_ids = [f"i{j}" for j in range(RET_ITEMS)]
    cats = {f"i{j}": ["c0"] for j in range(0, RET_ITEMS, 10)}
    model = sim.SimilarProductModel(item_index=BiMap.from_dense(item_ids), item_factors=vf,
                                    categories=cats)
    engine = sim.engine()
    ep = engine.params_from_variant({"algorithms": [{"name": "als", "params": {"rank": 10}}]})
    iid = save_instance(engine, ep, [model], engine_id="chip-smoke-ret-sim",
                        engine_variant="ret", engine_factory=SIM_FACTORY, storage=storage)
    simple = [{"items": [f"i{int(x)}" for x in rng.choice(RET_ITEMS, int(n), replace=False)],
               "num": RET_NUM} for n in rng.integers(1, 5, SIM_QUERIES)]

    def key(q):
        return json.dumps(q, sort_keys=True)

    kernels = {"k4": K4_CALLS % "bf16", "k5": K5_CALLS % "sum_rows", **K4_ROUTES,
               "k4_kernels": "pio_k4_kernel_launches", "k5_kernels": "pio_k5_kernel_launches",
               "k2s": 'pio_k2_calls{kernel="sum_rows_top_k_batch",route="tile"}'}
    server = DeployProcess(basedir, iid, device.type, ["--batch-window-ms", str(BATCH_WINDOW_MS)],
                           "ret-sim", {"PIO_RETRIEVAL_PROBE_EVERY": "0"}, wait=False)
    servers.append(server)
    yield  # every server of the phase starts before the first is measured
    ready_s = server.wait_ready()
    spans = check_traced(server, simple[0], "c0ffee0000000099")
    levels = {}
    for c in RET_LEVELS:
        levels[c] = lv = retrieval_round(server, simple, c, key, kernels)
        check_dispatch_counts(lv, 0, f"similar c={c}")
    if levels[1]["answers"] != levels[8]["answers"]:
        raise AssertionError("similar: batched answers differ from solo ones")
    expected = plain_sim(torch, retrieval, topk, model, device, simple)
    black = [{"items": q["items"], "num": RET_NUM, "blackList": [
        f"i{int(x)}" for x in topk_ids(topk, model, device, q, 20)]} for q in simple[:50]]
    expected_black = plain_sim(torch, retrieval, topk, model, device, black)
    solo = retrieval_round(server, black, 1, key, kernels)
    # k = pow2(10 + 21..24 excluded) = 64, k' = 512: the stream route
    check_dispatch_counts(solo, 0, "similar blackList", route="stream")
    hits = covered = 0
    for qs, exp, answers in ((simple, expected, levels[1]["answers"]),
                             (black, expected_black, solo["answers"])):
        for q, (pi, ps, ei, es) in zip(qs, exp):
            got = json.loads(answers[key(q)])["itemScores"]
            ids = np.asarray([model.item_index[x["item"]] for x in got])
            sc = np.asarray([x["score"] for x in got], np.float32)
            if set(q.get("blackList", ())) & {x["item"] for x in got}:
                raise AssertionError(f"similar {q}: a blackListed item came back")
            if len(ids) != len(pi) or not np.allclose(sc, ps, rtol=RTOL, atol=ATOL) \
                    or not near_tie_ids_ok(ids, pi, ps):
                raise AssertionError(f"similar {q}: {ids} {sc} vs plain {pi} {ps}")
            hits += len(set(ids.tolist()) & set(ei.tolist()))
            if set(ids.tolist()) == set(ei.tolist()):
                covered += 1
                if not np.array_equal(sc.view(np.int32), es.view(np.int32)):
                    raise AssertionError(f"similar {q}: scores differ from K2s's")
    recall = hits / (RET_NUM * (len(simple) + len(black)))
    if recall < 0.999:
        raise AssertionError(f"similar: recall@{RET_NUM} {recall} < 0.999")
    before = json.loads(server.get("/stats.json")[1])["retrieval"]
    catq = [{"items": q["items"], "num": RET_NUM, "categories": ["c0"]} for q in simple[:5]]
    cat_round = retrieval_round(server, catq, 1, key, kernels)
    after = json.loads(server.get("/stats.json")[1])["retrieval"]
    if after["exact_queries"] - before["exact_queries"] != len(catq):
        raise AssertionError(f"similar categories: exact queries {before} -> {after}")
    check_exact_round(cat_round, len(catq))
    V = model.device_factors(device)
    for q in catq:
        got = json.loads(cat_round["answers"][key(q)])["itemScores"]
        mask = sim._exclude_mask(model.item_index, cats, sim.Query(**q))
        known = [model.item_index[i] for i in q["items"]]
        L = 1 << (len(known) - 1).bit_length()
        ixs = np.zeros((1, L), np.int32)
        w = np.zeros((1, L), np.float32)
        ixs[0, :len(known)], w[0, :len(known)] = known, 1.0
        s, i = topk.sum_rows_top_k_batch_reference(ixs, w, V, 16, exclude_mask=mask)
        want = [f"i{int(x)}" for x in host(i)[0, :RET_NUM]]
        if [x["item"] for x in got] != want or any(int(x["item"][1:]) % 10 for x in got):
            raise AssertionError(f"similar categories {q}: {got} vs {want}")
    server.stop()
    out = {"ready_s": ready_s, "recall": recall, "covered": covered,
           "queries": len(simple) + len(black), "category_queries": len(catq),
           "exact_queries_counted": after["exact_queries"] - before["exact_queries"],
           "trace_spans": spans,
           **{f"c{c}": {k: v for k, v in lv.items() if k != "answers"} for c, lv in levels.items()},
           "blacklist_solo": {k: v for k, v in solo.items() if k != "answers"}}
    log(json.dumps({"retrieval": "similar products f32", **out}))
    return out


def topk_ids(topk, model, device, q: dict, n: int) -> np.ndarray:
    """The exact top n of a similar-product query without exclusions
    other than its own items (K2s on the card)."""
    V = model.device_factors(device)
    known = [model.item_index[i] for i in q["items"]]
    L = 1 << (len(known) - 1).bit_length()
    ixs = np.zeros((1, L), np.int32)
    w = np.zeros((1, L), np.float32)
    ixs[0, :len(known)], w[0, :len(known)] = known, 1.0
    k = 1 << (n + len(known) - 1).bit_length()
    _, i = topk.sum_rows_top_k_batch(ixs, w, V, k)
    return np.asarray([x for x in host(i)[0] if int(x) not in set(known)][:n])


@phase("retrieval: two-stage serving at 1M items through deploy")
def retrieval_serving(torch, device, stats):
    """The slice through its entry points: each model saved through the
    port's storage and served by ``cli.main deploy`` in a subprocess
    with the micro-batcher on (``--batch-window-ms 2``): the
    recommendation template (U = 138,493, I = 1,000,000, rank 32; f32 and
    int8; 500 distinct users at num = 10, at concurrency 1 and 8) and
    the similar-product template (I = 1,000,000, rank 10). The five
    servers start together, once their models are saved, and are
    measured one at a time while the others idle. Per server: ready_s
    (process start to /readyz, the coarse build at warmup included: K4
    ran before the first query; the five start-ups share the host),
    every answer against the
    plain two-stage version, recall@num >= 0.999 against exact K2/K2s,
    answers whose shortlist holds the exact top num equal to K2's with
    scores bit for bit, batched answers equal to solo ones, K4 / K5 / K2
    calls per dispatch from /metrics (K2 only for the live probe, which
    the int8 server runs on every dispatch), the /stats.json retrieval
    block, a traced request's dispatch.shortlist / dispatch.rescore
    spans, and HTTP p50 / p99 / queries/s."""
    from predictionio_tpu_torch.data import storage as st
    from predictionio_tpu_torch.ops import topk

    basedir = tempfile.mkdtemp(prefix="pio_chip_smoke_retrieval_")
    storage = st.Storage(env={"PIO_FS_BASEDIR": basedir})
    servers: list = []
    topk.top_k_similar.launches.reset()  # the main path's K2 cosine calls, read below
    try:
        # each part builds and saves its models and starts its servers (the
        # e-commerce part first: it writes events into the store), then
        # each is measured in turn, the other servers idle
        parts = {name: fn(torch, device, storage, basedir, stats, servers) for name, fn in (
            ("ecommerce", ec_retrieval), ("recommendation", rec_retrieval),
            ("similar", sim_retrieval), ("recommended_user", ru_retrieval))}
        for part in parts.values():
            next(part)
        out = {}
        for name in ("recommendation", "similar", "recommended_user", "ecommerce"):
            try:
                next(parts[name])
                raise AssertionError(f"retrieval {name}: a second start")
            except StopIteration as done:
                out[name] = done.value
    except BaseException:
        for s in servers:
            if s.proc.poll() is None:
                log(s.log_tail())
        raise
    finally:
        for s in servers:
            if s.proc.poll() is None:
                s.stop()
        storage.close()
        shutil.rmtree(basedir, ignore_errors=True)
    main = [out["recommendation"][d][f"c{c}"] for d in out["recommendation"] for c in RET_LEVELS]
    main += [out["similar"][f"c{c}"] for c in RET_LEVELS] + [out["similar"]["blacklist_solo"]]
    main += [out[t][f"c{c}"] for t in ("recommended_user", "ecommerce") for c in RET_LEVELS]
    main += [out["ecommerce"]["seen_solo"]]
    stats["ret_launches"] = {
        name: sum(lv[name] for lv in main)
        for name in ("k4", "k4_warp", "k4_stream", "k5", "k4_kernels", "k5_kernels",
                     "two_stage_warp", "two_stage_stream", "dispatches")}
    got = stats["ret_launches"]
    if not (got["two_stage_warp"] > 0 and got["two_stage_stream"] > 0
            and got["k4_kernels"] == got["dispatches"] == got["k4"] == got["k5"]
            and got["k5_kernels"] == 0):
        raise AssertionError(f"the main path's two-stage dispatches: {got}")
    stats["k2cos_launches"] = (stats.get("k2cos_launches", 0) + topk.top_k_similar.launches.value
                               + sum(lv["k2cos"] for lv in main))
    stats["retrieval"] = out


def two_stage_bound(mem_rate, fp32_rate, nbytes: float, flops: float) -> dict:
    t_b, t_o = nbytes / mem_rate, flops / fp32_rate
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations"}


INT8_PEAK = 1979e12  # H100 SXM dense int8 tensor OP/s (NVIDIA data sheet)


def k4_bound(mem_rate, fp32_rate, rows: int, B: int, kp: int, mode: str) -> dict:
    """K4's least time: the bytes (the catalog once, I * 2D for bf16 and
    I * (D + 4) for int8, the queries, the [B, k'] winners) against the
    memory rate; and 2 * B * I * D operations -- for int8 and bf16 the
    products and sums that bit-equality keeps apart (no FMA), FP32
    instructions at half the FMA peak; for int8_dot int8 x int8 sums, at
    the int8 tensor rate."""
    elem = 2 * RET_D if mode == "bf16" else RET_D + 4
    nbytes = rows * elem + B * RET_D * 4 + B * kp * 8
    ops = 2.0 * B * rows * RET_D
    rate = INT8_PEAK if mode == "int8_dot" else fp32_rate / 2
    t_b, t_o = nbytes / mem_rate, ops / rate
    return {"bytes": nbytes, "ops": ops, "bytes_ms": t_b * 1e3, "ops_ms": t_o * 1e3,
            "bound_ms": max(t_b, t_o) * 1e3, "bound_by": "bytes" if t_b >= t_o else "operations"}


#: profiler and CUDA-event repetitions a reading in the retimes phase, whose
#: kernels (K4, K5, the fused call) have had their redesign
RETIME_RUNS = 10


def k4_route_times(torch, retrieval, cat, q, rows: int, kp: int, mode: str, bound: dict) -> dict:
    """K4's routes on the same inputs: the warp route (``coarse_topk``,
    k' <= 128), the stream route (``_coarse_topk_stream``) and the pair it
    replaced (``_coarse_topk_pair``, two launches): their answers bit for
    bit, then device ms per call (``torch.profiler``) in turns (pair,
    stream, warp, warp, stream, pair) and CUDA-event ms per call, each
    beside the bound."""
    fns = {"pair": retrieval._coarse_topk_pair, "stream": retrieval._coarse_topk_stream}
    if kp <= retrieval.K4_WARP_MAX_K:
        fns["warp"] = retrieval.coarse_topk
    calls = {name: (lambda fn=fn: fn(q, cat._tiles, cat._scales, rows, kp, mode))
             for name, fn in fns.items()}
    outs = {name: call() for name, call in calls.items()}
    torch.cuda.synchronize()
    s0, i0 = outs["pair"]
    for name, (sx, ix) in outs.items():
        if not (same_bits(torch, sx, s0) and bool(torch.equal(ix, i0))):
            raise AssertionError(f"K4 {mode} I={rows} B={len(q)} k'={kp}: {name} differs")
    order = list(calls)
    t = {name: [] for name in order}
    for name in order + order[::-1]:
        t[name].append(_total(device_ms(torch, calls[name], runs=RETIME_RUNS)))
    # the mean of the readings whose trace held device events (a trace now
    # and then comes back without any); at least one a route
    if not all(any(x is not None for x in v) for v in t.values()):
        raise AssertionError(f"K4 {mode} k'={kp}: no profiler reading for a route: {t}")
    out = {f"{name}_ms": statistics.mean(x for x in v if x is not None)
           for name, v in t.items()}
    out.update({f"{name}_event_ms": cuda_median_ms(torch, calls[name], runs=RETIME_RUNS,
                                                   warmup=5)
                for name in order})
    out["pair_over_stream"] = out["pair_ms"] / out["stream_ms"]
    if "warp" in out:
        out["stream_over_warp"] = out["stream_ms"] / out["warp_ms"]
        out["warp_over_bound"] = out["warp_ms"] / bound["bound_ms"]
    out["stream_over_bound"] = out["stream_ms"] / bound["bound_ms"]
    return {**out, **bound}


def two_stage_bytes(rows: int, B: int, kp: int, k: int, mode: str, v_elem: int) -> float:
    """The fused call's bytes, each read or written once: the coarse
    catalog, the queries, the [B, k'] shortlist's item rows (and int8
    scales), the [B, k] answers."""
    elem = 2 * RET_D if mode == "bf16" else RET_D + 4
    return (rows * elem + B * RET_D * 4 + B * kp * (RET_D * v_elem + (4 if v_elem == 1 else 0))
            + B * k * 8)


def fused_bound(mem_rate, fp32_rate, rows: int, B: int, kp: int, k: int, mode: str,
                v_elem: int) -> dict:
    """The fused call's least time: its bytes (two_stage_bytes) against
    the memory rate, and its operations -- K4's (k4_bound's rule) and
    K5's 2 * B * k' * D products and sums as separate FP32 instructions
    at half the FMA peak -- one after the other."""
    nbytes = two_stage_bytes(rows, B, kp, k, mode, v_elem)
    k4 = k4_bound(mem_rate, fp32_rate, rows, B, kp, mode)
    t_b = nbytes / mem_rate
    t_o = k4["ops_ms"] / 1e3 + 2.0 * B * kp * RET_D / (fp32_rate / 2)
    return {"bytes": nbytes, "ops": k4["ops"] + 2.0 * B * kp * RET_D,
            "bound_ms": max(t_b, t_o) * 1e3, "bound_by": "bytes" if t_b >= t_o else "operations"}


@phase("retimes: K4's routes, the fused two-stage call, K5 and exact K2 at 1M and 10M items")
def retrieval_timings(torch, device, stats):
    """At I = 1,000,000 and 10,000,000, D = 32: K4's three routes on the
    same inputs (the warp route at k' <= 128, the stream route and the
    pair it replaced; every mode at B = 8, k' 32, 128 and 512, and B = 1
    at k' 128 and 512; at 1M also B = 64 at 128), each beside its bound; K4
    per mode at B = 8, k' = 128 (the warp route) and 512 (the stream
    route), beside its plain version and ``torch.topk(q @ V.float().T
    [* s], k')``; the standalone K5 at B = 8, k' = 128, k = 16; and the
    serving call's paths on the same catalog at B in {1, 8}, (k', k) =
    (128, 16) and (512, 64), f32 and int8 tables: the fused call
    (``two_stage_top_k``, one launch, host answers), the two-wrapper path
    it replaced (``CoarseCatalog.shortlist`` then
    ``rescore_gather_top_k_batch``), K4 then K5 launched back to back
    without a host step, exact K2 (``gather_top_k_batch``, host answers)
    and ``torch.topk(q @ V.T, k)``; device time by ``torch.profiler``,
    call time by CUDA events. Also the card's ``%globaltimer`` tick, the
    resolution of the fused call's stage split."""
    from predictionio_tpu_torch.ops import retrieval, topk

    mem_rate, fp32_rate = peaks(stats["device_name"])
    B, k, kp = 8, 16, 128
    gen = torch.Generator(device=device).manual_seed(SEED + 50)
    U = torch.randn((U_ROWS, RET_D), generator=gen, device=device)
    uixs64 = torch.arange(64, dtype=torch.int32, device=device) * 17
    uixs = uixs64[:B]
    q = U[uixs.long()].contiguous()
    q64 = U[uixs64.long()].contiguous()
    out = {"globaltimer_tick_ns": retrieval.globaltimer_tick(device)}
    log(json.dumps({"retimes": "globaltimer", "tick_ns": out["globaltimer_tick_ns"]}))
    for rows in RET_ROWS:
        f, pair = coarse_pair(torch, rows, SEED + 51, device)
        V = torch.from_numpy(f).to(device)
        del f
        cats = {"int8": retrieval.CoarseCatalog(pair, device=device),
                "bf16": retrieval.CoarseCatalog(host(V), device=device)}
        res = {"k4": {}, "k4_routes": {}, "k5": {}, "paths": {}}
        for mode in retrieval.MODES:
            cat = cats["bf16" if mode == "bf16" else "int8"]
            if mode == "int8_dot":
                cat = retrieval.CoarseCatalog(pair, mode="int8_dot", device=device)
            cases = [(8, 32), (8, 128), (8, 512), (1, 128), (1, 512)]
            cases += [(64, 128)] if rows == RET_ROWS[0] else []
            for b, kk in cases:
                res["k4_routes"][f"{mode} B={b} k'={kk}"] = k4_route_times(
                    torch, retrieval, cat, q64[:b], rows, kk, mode,
                    k4_bound(mem_rate, fp32_rate, rows, b, kk, mode))
            vals = cat._tiles.view(-1, RET_D)[:rows]
            sc = None if cat._scales is None else cat._scales.view(-1)[:rows]
            for kk in (kp, 512):
                def plain(cat=cat, mode=mode, kk=kk):
                    return retrieval.coarse_topk_reference(q, cat._tiles, cat._scales, rows, kk,
                                                           mode)

                if mode == "bf16":
                    def lib(vals=vals, kk=kk):
                        return torch.topk(q @ vals.float().T, kk)
                elif mode == "int8":
                    def lib(vals=vals, sc=sc, kk=kk):
                        return torch.topk((q @ vals.float().T) * sc, kk)
                else:
                    qi = retrieval.quantize_queries(q)

                    def lib(vals=vals, sc=sc, qi=qi, kk=kk):
                        return torch.topk((qi.float() @ vals.float().T) * sc, kk)
                route = res["k4_routes"][f"{mode} B={B} k'={kk}"]
                res["k4"][f"{mode} k'={kk}"] = {
                    "route": retrieval.k4_route(kk),
                    "kernel_device_ms": route["warp_ms" if kk <= 128 else "stream_ms"],
                    "stream_device_ms": route["stream_ms"],
                    "pair_device_ms": route["pair_ms"],
                    "plain_ms": cuda_median_ms(torch, plain, runs=3, warmup=1),
                    "library_device_ms": _total(device_ms(torch, lib, runs=5)),
                    "plan": retrieval.k4_plan(B, rows, RET_D, kk, retrieval._sm_count(device),
                                              mode)._asdict(),
                    **k4_bound(mem_rate, fp32_rate, rows, B, kk, mode)}
        _, cand = retrieval.coarse_topk(q, cats["bf16"]._tiles, None, rows, kp, "bf16")
        for name, table in (("float32", V), ("int8", pair)):

            def k5(table=table):
                return retrieval.rescore_top_k("gather", table, cand, k, user_ixs=uixs,
                                               user_factors=U)

            def k5_plain(table=table):
                return retrieval.rescore_top_k_reference("gather", table, cand, k, user_ixs=uixs,
                                                         user_factors=U)

            def k5_lib(table=table):
                rows_ = topk._dense_rows(table, cand.long())
                return torch.topk(torch.einsum("bd,bsd->bs", q, rows_), k)

            elem = RET_D * 4 if name == "float32" else RET_D + 4
            dev = device_ms(torch, k5)
            res["k5"][name] = {
                "kernel_device_ms": _total(dev),
                "plain_ms": cuda_median_ms(torch, k5_plain, runs=20, warmup=5),
                "library_device_ms": _total(device_ms(torch, k5_lib)),
                **two_stage_bound(mem_rate, fp32_rate,
                                  B * kp * (elem + 4) + B * RET_D * 4 + B * k * 8,
                                  2.0 * B * kp * RET_D)}
            cat = cats["bf16" if name == "float32" else "int8"]
            for b, kpp, kk in ((8, 128, 16), (1, 128, 16), (8, 512, 64), (1, 512, 64)):
                qb, ub = q64[:b], uixs64[:b]
                res["paths"][f"{name} B={b} k'={kpp}"] = path_times(
                    torch, retrieval, topk, cat, qb, ub, U, table, rows, kpp, kk, name,
                    mem_rate, fp32_rate)
        out[str(rows)] = res
        log(json.dumps({"retimes": rows, **res}))
        del V, pair, cats, cand
        torch.cuda.empty_cache()
    stats["retimes"] = out


def path_times(torch, retrieval, topk, cat, q, uixs, U, table, rows: int, kp: int, k: int,
               name: str, mem_rate, fp32_rate) -> dict:
    """One serving call's paths on the same inputs, answers held equal:
    the fused call, the two-wrapper path it replaced, K4 then K5 back to
    back (device only), exact K2 and its one-call yardstick; device ms
    (``torch.profiler``: kernels and copies) and CUDA-event ms per call;
    the fused call's bound and plain version (K4's then K5's plain
    versions)."""
    def fused():
        return retrieval.two_stage_top_k(cat, q, kp, k, "gather", table, user_ixs=uixs,
                                         user_factors=U)

    def old():
        _, c = cat.shortlist(q, kp)
        return retrieval.rescore_gather_top_k_batch(uixs, U, table, c, k)

    def k4_k5():
        _, c = retrieval.coarse_topk(q, cat._tiles, cat._scales, rows, kp, cat.mode)
        return retrieval.rescore_top_k("gather", table, c, k, user_ixs=uixs, user_factors=U)

    def plain():
        _, c = retrieval.coarse_topk_reference(q, cat._tiles, cat._scales, rows, kp, cat.mode)
        return retrieval.rescore_top_k_reference("gather", table, c, k, user_ixs=uixs,
                                                 user_factors=U)

    def exact():
        s, i = topk.gather_top_k_batch(uixs, U, table, k)
        return s.cpu().numpy(), i.cpu().numpy()

    def exact_lib():
        return torch.topk(q @ topk._dense_rows(table, torch.arange(rows, device=q.device)).T, k) \
            if name == "int8" else torch.topk(q @ table.T, k)

    (fs, fi), (os_, oi) = fused(), old()
    if not (np.array_equal(fs.view(np.int32), os_.view(np.int32)) and np.array_equal(fi, oi)):
        raise AssertionError(f"fused vs two-wrapper path {name} I={rows} B={len(q)} k'={kp}")
    retrieval.take_stage_split()
    fused()
    split = retrieval.take_stage_split()
    t = {"fused": [], "old": []}
    for which in ("old", "fused", "fused", "old"):
        t[which].append(cuda_median_ms(torch, fused if which == "fused" else old,
                                       runs=RETIME_RUNS, warmup=5))
    bound = fused_bound(mem_rate, fp32_rate, rows, len(q), kp, k, cat.mode,
                        4 if name == "float32" else 1)
    return {"fused_ms": statistics.mean(t["fused"]), "old_ms": statistics.mean(t["old"]),
            "fused_runs_ms": t["fused"], "old_runs_ms": t["old"],
            "fused_device_ms": _total(device_ms(torch, fused, runs=RETIME_RUNS)),
            "fused_kernel_device_ms": _total(device_ms(torch, fused, runs=RETIME_RUNS),
                                             "coarse_"),
            "old_device_ms": _total(device_ms(torch, old, runs=RETIME_RUNS)),
            "k4_k5_ms": cuda_median_ms(torch, k4_k5, runs=RETIME_RUNS, warmup=5),
            "k4_k5_device_ms": _total(device_ms(torch, k4_k5, runs=RETIME_RUNS)),
            "exact_k2_ms": cuda_median_ms(torch, exact, runs=RETIME_RUNS, warmup=5),
            "exact_k2_device_ms": _total(device_ms(torch, exact, runs=RETIME_RUNS)),
            "exact_library_device_ms": _total(device_ms(torch, exact_lib, runs=5)),
            "plain_ms": cuda_median_ms(torch, plain, runs=3, warmup=1),
            "route": retrieval.k4_route(kp), "stage_split_s": split, **bound}


# -- the other ALS templates' slice: K6, K2's cosine mode, three templates ---------

K6_TOP_N = 20  # CosineAlgorithmParams' default top_n
K6_PASSES_I = 120_000  # a catalog wider than one shared-memory pass (57,344 columns)
K6_WIDE_USERS, K6_WIDE_NNZ = 30_000, 1_500_000  # its sparse draw
K2COS_ROWS = (50, I_ROWS, 1_000_000)  # catalog sizes of the k2cos phase
RU_FACTORY = "predictionio_tpu_torch.models.recommendeduser.engine"
EC_FACTORY = "predictionio_tpu_torch.models.ecommerce.engine"
TEMPLATE_USERS = 500  # distinct queried users (or items) a concurrency level
TEMPLATE_LEVELS = (1, 8)


def ml_views(stats, scale: str):
    """An ML-shaped draw's (user, item) pairs as views (value 1 each;
    repeated pairs sum to counts): (rows, cols, vals, U, I)."""
    if scale == "20m":
        if "ml20m_arrays" not in stats:
            stats["ml20m_arrays"] = make_ml_shaped("20m")
        rows, cols, _, nu, ni = stats["ml20m_arrays"]
    else:
        rows, cols, _, nu, ni = make_ml_shaped(scale)
    return rows, cols, np.ones(len(rows), np.float32), nu, ni


def k6_inputs(cs, device, rows, cols, vals, nu: int, ni: int, threshold=None) -> dict:
    """Deduped triples, host norms, K6's layout (``threshold``: None for
    the cost model's T, else that T forced) and its upload."""
    r, c, v = cs._dedupe(rows, cols, vals, nu, ni)
    norms = cs.column_norms(c, v, ni)
    lay = cs.cosine_layout(r, c, v, nu, ni, threshold=threshold)
    return {"trip": (r, c, v), "norms": norms, "lay": lay, "nu": nu, "ni": ni,
            "dev": cs.upload_layout(lay, norms, device)}


def k6_blocks(torch, cs, device, inp: dict, top_n: int, starts, ks, ki, what: str) -> dict:
    """K6's answer (``ks``, ``ki``: host [I, n]) against the plain version
    on the item blocks starting at ``starts`` (256 rows each, the JAX
    package's block): the atomic route (integer values) bit for bit, ids
    of -inf padding included; the ordered route within atol 1e-5, ids
    equal outside near ties. Returns the rows checked and the largest
    finite difference."""
    r, c, v = inp["trip"]
    ni = inp["ni"]
    chunk_r, chunk_c, chunk_v, chunk, block = cs.plain_inputs(r, c, v, inp["nu"], ni, 256,
                                                              1024, device)
    nd = torch.from_numpy(inp["norms"]).to(device)
    exact = inp["lay"].route == "atomic"
    worst, checked = 0.0, 0
    for start in starts:
        first = min(start, max(0, ni - block))
        ps, pi = cs.plain_block_topn(chunk_r, chunk_c, chunk_v, nd, first, ni, chunk, block,
                                     top_n)
        ps, pi = host(ps), host(pi)
        a, b = ks[first:first + block], ki[first:first + block]
        fin = np.isfinite(ps)
        if not np.array_equal(np.isfinite(a), fin):
            raise AssertionError(f"k6 {what}: -inf pattern differs at rows from {first}")
        diff = np.abs(a[fin] - ps[fin]).max(initial=0.0)
        worst = max(worst, float(diff))
        if exact:
            bad = (a.view(np.int32) != ps.view(np.int32)).any(1) | (b != pi).any(1)
            if bad.any():
                raise AssertionError(f"k6 {what}: rows {first + np.nonzero(bad)[0][:5]} differ "
                                     "from the plain version")
        else:
            if diff > 1e-5:
                raise AssertionError(f"k6 {what}: scores differ by {diff} > 1e-5")
            for row in range(a.shape[0]):
                if not near_tie_ids_ok(b[row], pi[row], ps[row]):
                    raise AssertionError(f"k6 {what}: row {first + row} ids {b[row]} vs "
                                         f"{pi[row]}")
        checked += a.shape[0]
    return {"rows_checked": checked, "max_abs_err": worst}


def k6_stage_counts(cs) -> dict:
    return {k: c.value for k, c in cs.item_similarity_topn.stages.items()}


def k6_case(torch, cs, device, inp: dict, top_n: int, what: str, starts=None,
            pass_cols=None, both: bool = True) -> list:
    """K6 over every row, held to the plain version (every block, or the
    blocks at ``starts``): on the layout's design (the dense stage when
    it has heavy users) and, with ``both``, again with ``H = 0``
    (``dense=False``) where the layout has heavy users -- that run held
    bit for bit to the first (the atomic route's sums are exact), so to
    the plain version too. The stages each run launched are recorded."""
    ni, lay = inp["ni"], inp["lay"]
    tn = cs.clamp_top_n(top_n, ni)
    kw = {} if pass_cols is None else {"pass_cols": pass_cols}
    if starts is None:
        starts = range(0, ni, 256)
    out, first = [], None
    for dense in ((True, False) if both and len(lay.heavy) else (True,)):
        before = k6_stage_counts(cs)
        ks, ki = cs.cosine_topn_kernel(inp["dev"], ni, tn, lay.route, dense=dense, **kw)
        torch.cuda.synchronize()
        stages = {k: v - before[k] for k, v in k6_stage_counts(cs).items()}
        ks, ki = host(ks), host(ki)
        if dense and len(lay.heavy) and lay.route == "atomic" and stages["dense"] == 0:
            raise AssertionError(f"k6 {what}: the layout has heavy users, no dense launch")
        if not dense and stages["dense"]:
            raise AssertionError(f"k6 {what}: H = 0 launched the dense stage")
        if tn > cs.K6_SELECT_MAX_N and stages["select"] == 0:
            raise AssertionError(f"k6 {what}: top_n {tn} launched no selection")
        if first is None:
            held = k6_blocks(torch, cs, device, inp, tn, starts, ks, ki, f"{what} (H="
                             f"{len(lay.heavy)})")
            first = (ks, ki, held)
        elif not (np.array_equal(ks.view(np.int32), first[0].view(np.int32))
                  and np.array_equal(ki, first[1])):
            raise AssertionError(f"k6 {what}: H = 0 differs from the dense design")
        else:
            held = first[2]
        res = {"case": what, "route": lay.route, "I": ni, "top_n": tn, "T": lay.threshold,
               "H": len(lay.heavy) if dense else 0, "stages": stages,
               "passes": -(-ni // min(pass_cols or cs.K6_PASS_COLS, ni)), **held}
        log(json.dumps({"k6": res}))
        out.append(res)
    return out


def k6_bound(mem_rate, fp32_rate, inp: dict, top_n: int) -> dict:
    """The least time for K6's work: its inputs read once (CSR and CSC
    pointers, ids and values, norms, the row order) and its [I, n] f32 +
    int32 outputs written once, against the multiply-adds the data needs
    (sum_u deg(u)^2, 2 FLOP each) at the FP32 peak."""
    lay, ni = inp["lay"], inp["ni"]
    nnz = len(lay.user_items)
    nbytes = (8 * (len(lay.user_ptr) + len(lay.item_ptr)) + 16 * nnz + 8 * ni
              + 8 * ni * top_n)
    flops = 2.0 * float(lay.work.sum())
    t_b, t_o = nbytes / mem_rate, flops / fp32_rate
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations"}


INT8_TENSOR_PEAK = 1979e12  # H100 SXM dense int8 tensor-core operations a second


def k6_stage_bounds(cs, mem_rate, fp32_rate, inp: dict, top_n: int) -> dict:
    """Each stage's own least time. Dense: 2 I I_pad H_pad s8 operations
    at the int8 tensor peak against its operand read once and the [I, I]
    f32 Gram written once. Sparse: the light users' multiply-adds (2 FLOP
    each) at the FP32 peak against the light CSC, the CSR, the Gram read
    back once and the [I, n] outputs."""
    lay, ni = inp["lay"], inp["ni"]
    i_pad = -(-ni // cs.K6_DENSE_TILE) * cs.K6_DENSE_TILE
    h_pad = -(-len(lay.heavy) // cs.K6_DENSE_K) * cs.K6_DENSE_K
    d_ops = 2.0 * ni * i_pad * h_pad
    d_bytes = i_pad * h_pad + 4.0 * ni * ni
    s_flops = 2.0 * float(lay.light_work.sum())
    s_bytes = (8 * (len(lay.user_ptr) + len(lay.light_ptr)) + 8 * len(lay.user_items)
               + 8 * len(lay.light_users) + 4.0 * ni * ni * (h_pad > 0) + 8 * ni * top_n)

    def bound(t_b, t_o):
        return {"bound_ms": max(t_b, t_o) * 1e3, "bound_by": "bytes" if t_b >= t_o
                else "operations"}

    return {"dense": {"ops": d_ops, "bytes": d_bytes, **bound(d_bytes / mem_rate,
                                                              d_ops / INT8_TENSOR_PEAK)},
            "sparse": {"flops": s_flops, "bytes": s_bytes, **bound(s_bytes / mem_rate,
                                                                   s_flops / fp32_rate)}}


def k6_dense_check(torch, cs, inp: dict) -> dict:
    """The dense stage alone on the 20m layout's first chunk (the
    heaviest rows): bit for bit against gram_s8_reference, its device time
    over every chunk, the plain version's and one ``torch._int_mm`` call's
    (the yardstick: an int32 product of the same operands)."""
    dev, ni = inp["dev"], inp["ni"]
    a, order = dev["heavy_a"], dev["light_order"]
    chunk = cs.k6_chunk_rows(ni)
    part = order[:chunk]
    scratch = torch.empty((chunk, ni), dtype=torch.float32, device=a.device)

    def dense_all():
        for r0 in range(0, ni, chunk):
            cs.gram_s8(a, order[r0:r0 + chunk], ni, scratch)

    dense_all()  # leaves the last chunk; the first is checked below
    cs.gram_s8(a, part, ni, scratch)
    torch.cuda.synchronize()
    want = cs.gram_s8_reference(a, part, ni)
    err = float((scratch - want).abs().max())
    if not torch.equal(scratch.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"gram_s8 differs from its plain version (max {err})")
    del want

    def plain_all():
        for r0 in range(0, ni, chunk):
            cs.gram_s8_reference(a, order[r0:r0 + chunk], ni)

    at = a.t()
    gathered = [a[order[r0:r0 + chunk].long()] for r0 in range(0, ni, chunk)]

    def library_all():
        for rows_a in gathered:
            torch._int_mm(rows_a, at)

    try:
        library_all()
        library_ms = cuda_median_ms(torch, library_all, runs=3, warmup=1)
    except RuntimeError as e:  # a yardstick only: the port never calls it
        log(f"k6 dense: torch._int_mm unavailable here: {e}")
        library_ms = None
    times = device_ms(torch, dense_all, runs=3)
    return {"max_abs_err": err, "dense_device_ms": _total(times, "gram_s8"),
            "dense_event_ms": cuda_median_ms(torch, dense_all, runs=3, warmup=1),
            "plain_ms": cuda_median_ms(torch, plain_all, runs=3, warmup=1),
            "library_ms": library_ms, "chunks": -(-ni // chunk),
            "rate_ops_per_s": 2.0 * ni * a.shape[0] * a.shape[1]
            / max(1e-9, (_total(times, "gram_s8") or 1e9) * 1e-3)}


def k6_times(torch, fn, runs: int = 3) -> dict:
    """``fn``'s CUDA-event median (``event_ms``) and its device time by
    kernel from ``torch.profiler`` (``kernels``), the trace taken again
    (up to three times) while its total reads below 0.75x the event time:
    a trace now and then records only some of the runs. ``device_ms`` is
    the trace's total, or the event time when no trace was whole
    (``traced`` False)."""
    event = cuda_median_ms(torch, fn, runs=runs, warmup=1)
    for _ in range(3):
        kernels = device_ms(torch, fn, runs=runs)
        total = _total(kernels)
        if total is not None and total >= 0.75 * event:
            return {"event_ms": event, "kernels": kernels, "device_ms": total, "traced": True}
    return {"event_ms": event, "kernels": {}, "device_ms": event, "traced": False}


@phase("k6: item-item cosine top-n vs plain")
def k6_vs_plain(torch, device, stats):
    """K6 (``ops/cosine_sim.py``, ``csrc/cosine_sim.cu``) against its plain
    version (the JAX program stated in torch: dense user-chunk tiles,
    ``tile_b^T @ tile`` with TF32 off, the masks, a stable sort on the
    order key) on the card. Integer view counts (the atomic route) bit
    for bit, ids of -inf padding included; fractional values (the
    ordered route) within atol 1e-5. Every case runs on the layout's
    design (the dense stage for the heavy users when the cost model
    splits them off) and with ``H = 0``. ML-100K views (37 empty items;
    top_n 1, 20, 128, and 129, 256, I - 1 on the scores route) and ML-1M
    views in full (also in forced column passes; top_n 129, 256, I - 1),
    T forced to 0, to the cost model's pick and above the largest degree
    on both; fractional values; I = 100 at top_n = I - 1; I = 120,000 on
    a sparse draw (three column passes; the first, middle and last blocks
    held); the ML-20M views at top_n = 20 (every row by the kernels, every
    block by the plain version, timed), the dense stage alone against its
    plain version. Then at 20m: each stage's device time
    (``torch.profiler``), the heaviest row's block alone, the H = 0 and
    ordered-route times, the bounds."""
    from predictionio_tpu_torch.ops import cosine_sim as cs

    cases = []
    rows, cols, vals, nu, ni = ml_views(stats, "100k")
    inp = k6_inputs(cs, device, rows, cols, vals, nu, ni + 37)
    if len(inp["trip"][0]) >= len(rows):
        raise AssertionError("the 100k views hold no repeated pair to sum")
    # the cost model's T forced: a layout with heavy users at this size too
    split = k6_inputs(cs, device, rows, cols, vals, nu, ni + 37,
                      threshold=cs.k6_threshold(ni + 37))
    for tn in (1, K6_TOP_N, 128):
        cases += k6_case(torch, cs, device, inp, tn, f"100k views top_n={tn}")
    for tn in (K6_TOP_N, 129, 256, ni + 36):
        cases += k6_case(torch, cs, device, split, tn, f"100k views T=cost model top_n={tn}")
    for t, name in ((0, "T=0"), (10 ** 9, "T>max deg")):
        forced = k6_inputs(cs, device, rows, cols, vals, nu, ni + 37, threshold=t)
        cases += k6_case(torch, cs, device, forced, K6_TOP_N, f"100k views {name}", both=False)
    small_dense = k6_dense_check(torch, cs, split)  # a launch's fixed cost, at a small shape
    log(json.dumps({"k6 dense stage, 100k views": small_dense}))
    rng = np.random.default_rng(SEED + 60)
    frac = rng.random(len(rows)).astype(np.float32) * 3.0
    fin = k6_inputs(cs, device, rows, cols, frac, nu, ni + 37)
    if fin["lay"].route != "ordered":
        raise AssertionError("fractional values did not take the ordered route")
    for tn in (K6_TOP_N, 128, 129):
        cases += k6_case(torch, cs, device, fin, tn, "100k fractional")
    rows, cols, vals, nu, ni = ml_views(stats, "1m")
    inp = k6_inputs(cs, device, rows, cols, vals, nu, ni)
    split = k6_inputs(cs, device, rows, cols, vals, nu, ni, threshold=cs.k6_threshold(ni))
    cases += k6_case(torch, cs, device, inp, K6_TOP_N, f"1m views top_n={K6_TOP_N}")
    cases += k6_case(torch, cs, device, inp, K6_TOP_N, "1m views, passes of 1,000",
                     pass_cols=1000)
    for tn in (K6_TOP_N, 129, 256, ni - 1):
        cases += k6_case(torch, cs, device, split, tn, f"1m views T=cost model top_n={tn}")
    cases += k6_case(torch, cs, device, split, K6_TOP_N, "1m views T=cost model, passes of "
                     "1,000", pass_cols=1000)
    for t, name in ((0, "T=0"), (10 ** 9, "T>max deg")):
        forced = k6_inputs(cs, device, rows, cols, vals, nu, ni, threshold=t)
        cases += k6_case(torch, cs, device, forced, K6_TOP_N, f"1m views {name}", both=False)
    frac = (vals * 0.5 + rng.random(len(vals)).astype(np.float32)).astype(np.float32)
    cases += k6_case(torch, cs, device, k6_inputs(cs, device, rows, cols, frac, nu, ni),
                     64, "1m fractional, passes of 1,000", pass_cols=1000)
    small = k6_inputs(cs, device, rng.integers(0, 300, 4000), rng.integers(0, 97, 4000),
                      rng.integers(1, 4, 4000).astype(np.float32), 300, 100)
    cases += k6_case(torch, cs, device, small, 99, "I=100 top_n=I-1")
    # a catalog wider than one shared-memory pass: three column passes
    wide = k6_inputs(cs, device, rng.integers(0, K6_WIDE_USERS, K6_WIDE_NNZ),
                     rng.integers(0, K6_PASSES_I, K6_WIDE_NNZ),
                     rng.integers(1, 4, K6_WIDE_NNZ).astype(np.float32), K6_WIDE_USERS,
                     K6_PASSES_I)
    cases += k6_case(torch, cs, device, wide, K6_TOP_N, "I=120,000 sparse",
                     starts=(0, K6_PASSES_I // 2, K6_PASSES_I - 1))
    del wide, small, fin, forced, split
    # the ML-20M views: every row by the kernels, every block by the plain version
    rows, cols, vals, nu, ni = ml_views(stats, "20m")
    t0 = time.perf_counter()
    inp = k6_inputs(cs, device, rows, cols, vals, nu, ni)
    layout_s = time.perf_counter() - t0
    lay = inp["lay"]
    if not len(lay.heavy):
        raise AssertionError("k6 20m views: the cost model split off no heavy user")
    before = k6_stage_counts(cs)
    ks, ki = cs.cosine_topn_kernel(inp["dev"], ni, K6_TOP_N, lay.route)
    torch.cuda.synchronize()
    stages = {k: v - before[k] for k, v in k6_stage_counts(cs).items()}
    ks, ki = host(ks), host(ki)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    held = k6_blocks(torch, cs, device, inp, K6_TOP_N, range(0, ni, 256), ks, ki, "20m views")
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    hot = int(np.argmax(np.diff(lay.item_ptr)))
    cases.append({"case": "20m views (every block)", "route": lay.route, "I": ni,
                  "top_n": K6_TOP_N, "T": lay.threshold, "H": len(lay.heavy),
                  "stages": stages, "passes": 1, **held})
    log(json.dumps({"k6": cases[-1]}))

    def call():
        cs.cosine_topn_kernel(inp["dev"], ni, K6_TOP_N, lay.route)

    def heaviest():
        cs.cosine_topn_kernel(inp["dev"], ni, K6_TOP_N, lay.route, rows=1)

    def flat():  # H = 0: the same kernel without a dense stage
        return cs.cosine_topn_kernel(inp["dev"], ni, K6_TOP_N, lay.route, dense=False)

    def flat_heaviest():
        cs.cosine_topn_kernel(inp["dev"], ni, K6_TOP_N, lay.route, rows=1, dense=False)

    # the ordered route on the same integer views: every sum is exact on
    # both routes, so the same bits; its time beside the atomic route's
    def ordered():
        return cs.cosine_topn_kernel(inp["dev"], ni, K6_TOP_N, "ordered")

    def ordered_heaviest():
        cs.cosine_topn_kernel(inp["dev"], ni, K6_TOP_N, "ordered", rows=1)

    for name, fn in (("H = 0", flat), ("the ordered route", ordered)):
        os_, oi = fn()
        torch.cuda.synchronize()
        if not (np.array_equal(host(os_).view(np.int32), ks.view(np.int32))
                and np.array_equal(host(oi), ki)):
            raise AssertionError(f"k6 20m views: {name} differs from the dense design")
        del os_, oi
    dense = k6_dense_check(torch, cs, inp)
    log(json.dumps({"k6 dense stage": dense}))
    mem_rate, fp32_rate = peaks(stats["device_name"])
    bound = k6_bound(mem_rate, fp32_rate, inp, K6_TOP_N)
    stage_bounds = k6_stage_bounds(cs, mem_rate, fp32_rate, inp, K6_TOP_N)
    t_call = k6_times(torch, call)
    t_flat = k6_times(torch, flat)
    t_heavy = k6_times(torch, heaviest)
    t_ordered = k6_times(torch, ordered)
    light_adds = float(lay.light_work.sum())
    sparse_ms = _total(t_call["kernels"], "cosine_topn")
    timing = {
        "kernel_ms": t_call["event_ms"], "kernel_device_ms": t_call["device_ms"],
        "traced": {"call": t_call["traced"], "h0": t_flat["traced"],
                   "heaviest": t_heavy["traced"], "ordered": t_ordered["traced"]},
        "dense_ms": _total(t_call["kernels"], "gram_s8"), "sparse_ms": sparse_ms,
        "select_ms": _total(t_call["kernels"], "select_kernel"),
        "slowest_block_ms": _total(t_heavy["kernels"], "cosine_topn") or t_heavy["device_ms"],
        "h0_ms": t_flat["device_ms"], "h0_kernel_ms": t_flat["event_ms"],
        "h0_slowest_block_ms": k6_times(torch, flat_heaviest)["device_ms"],
        "ordered_device_ms": t_ordered["device_ms"], "ordered_event_ms": t_ordered["event_ms"],
        "ordered_slowest_block_ms": k6_times(torch, ordered_heaviest)["device_ms"],
        "plain_ms": plain_ms, "library_ms": None, **bound, "stage_bounds": stage_bounds,
        "T": lay.threshold, "H": len(lay.heavy), "stages": stages,
        "pairs": int(len(lay.user_items)), "sum_deg_sq": int(lay.work.sum()),
        "light_sum_deg_sq": int(light_adds),
        "sparse_rate_adds_per_s": light_adds / max(1e-9, (sparse_ms or 1e9) * 1e-3),
        "h0_rate_adds_per_s": float(lay.work.sum()) / max(1e-9, t_flat["device_ms"] * 1e-3),
        "hottest_item_users": int(np.diff(lay.item_ptr)[hot]),
        "heaviest_row_work": int(lay.work[lay.row_order[0]]),
        "heaviest_light_row_work": int(lay.light_work[lay.light_order[0]]),
        "layout_s": layout_s,
    }
    stats["k6_20m"] = (ks, ki)
    stats["k6_max_abs_err"] = max(c["max_abs_err"] for c in cases)
    stats["k6"] = {"cases": cases, "timing": timing, "dense": dense,
                   "dense_100k": small_dense}
    log(json.dumps({"k6 timing": timing}))


@phase("k2cos: K2's cosine mode (top_k_similar) and top_k_items vs plain")
def k2_cosine_vs_plain(torch, device, stats):
    """``top_k_similar`` (K2's cosine mode: scores divided by max(norms
    x ||v||, 1e-12), int8 values without scales) against its plain
    version: f32, bf16 and int8 catalogs at I in {50, 26,744, 1M}, D = 10,
    with and without precomputed norms, masked and unmasked, k 4 and 128
    (the tile route) and 300 (the select route), on random rows with
    crafted exact ties and a zero row: ids equal, scores within rtol 1e-5.
    ``top_k_items`` (K2 at B = 1, row 0) against the plain gather version
    bit for bit. Then their times at the similar-product shape (I =
    26,744, D = 10, f32, k = 4) beside the plain versions, a
    ``cosine_similarity`` + ``topk`` yardstick and the bound."""
    import torch.nn.functional as F

    from predictionio_tpu_torch.ops import topk

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 61)
    worst, calls = 0.0, 0
    topk.top_k_similar.launches.reset()
    for I in K2COS_ROWS:
        for dtype in DTYPES:
            table = make_table(torch, dtype, I, 10, False, gen, device)
            vals = table[0] if isinstance(table, tuple) else table
            vals[3:6] = vals[7]  # exact ties with row 7 (the query)
            vals[9] = 0  # a zero row: its divisor is max(0, 1e-12)
            if isinstance(table, tuple):
                table[1][3:6] = table[1][7]
            query = vals[7].to(torch.float32)
            for with_norms in (False, True):
                norms = topk.catalog_norms(table) if with_norms else None
                for masked in (False, True):
                    mask = (torch.rand(I, generator=gen, device=device) < 0.3) if masked else None
                    for k in (4, 128, 300):
                        k = min(k, I)
                        ks, ki = topk.top_k_similar(query, table, k, mask, norms)
                        ps, pi = topk.top_k_similar_reference(query, table, k, mask, norms)
                        calls += 1
                        if not torch.equal(ki, pi) or not torch.allclose(
                                ks, ps, rtol=RTOL, atol=0.0):
                            raise AssertionError(f"top_k_similar {dtype} I={I} k={k} "
                                                 f"norms={with_norms} masked={masked}")
                        worst = max(worst, float((ks - ps).abs().max()))
                    u = torch.randn(10, generator=gen, device=device)
                    ks, ki = topk.top_k_items(u, table, 16, mask)
                    ps, pi = topk.gather_top_k_batch_reference([0], u[None], table, 16, mask)
                    if not (same_bits(torch, ks, ps[0]) and torch.equal(ki, pi[0])):
                        raise AssertionError(f"top_k_items {dtype} I={I} masked={masked}")
            del table, vals
    if topk.top_k_similar.launches.value != calls:
        raise AssertionError(f"{calls} top_k_similar calls launched "
                             f"{topk.top_k_similar.launches.value} times")
    torch.cuda.empty_cache()
    # times at the similar-product catalog's shape
    V = torch.randn((I_ROWS, 10), generator=gen, device=device)
    norms = topk.catalog_norms(V)
    q = V[42].clone()

    def kernel():
        topk.top_k_similar(q, V, 4, norms=norms)

    def plain():
        topk.top_k_similar_reference(q, V, 4, norms=norms)

    def library():
        torch.topk(F.cosine_similarity(V, q[None], dim=1), 4)

    mem_rate, fp32_rate = peaks(stats["device_name"])
    nbytes = I_ROWS * 10 * 4 + I_ROWS * 4 + 10 * 4 + 4 * 8
    flops = 2.0 * I_ROWS * 10 + 2.0 * I_ROWS  # the dots, then a product and a divide
    t_b, t_o = nbytes / mem_rate, flops / fp32_rate
    stats["k2cos"] = {
        "calls_checked": calls, "max_abs_err": worst,
        "route": topk.k2_route(4, I_ROWS, 1)._asdict(),
        "kernel_ms": cuda_median_ms(torch, kernel),
        "kernel_device_ms": _total(device_ms(torch, kernel)),
        "plain_ms": cuda_median_ms(torch, plain, runs=20, warmup=5),
        "plain_device_ms": _total(device_ms(torch, plain, runs=20)),
        "library_ms": cuda_median_ms(torch, library),
        "library_device_ms": _total(device_ms(torch, library)),
        "bytes": nbytes, "flops": flops, "bound_ms": max(t_b, t_o) * 1e3,
        "bound_by": "bytes" if t_b >= t_o else "operations"}
    log(json.dumps({"k2cos": stats["k2cos"]}))


# -- the templates through the CLI at the ML-100K shape ----------------------------


def template_events(Event, kind: str, rows, cols, rng) -> list:
    """ML-100K-shaped pairs as one template's events: follows (user ->
    user) for recommended-user; items ``$set`` with a category each,
    users ``$set``, views, a buy per tenth pair and one ``$set
    unavailableItems`` for e-commerce; items, users and views for the
    similar-product cosine algorithm."""
    from datetime import datetime, timedelta, timezone

    t0 = datetime(2024, 1, 1, tzinfo=timezone.utc)
    out = []

    def add(**kw):
        out.append(Event(event_time=t0 + timedelta(seconds=len(out)), **kw))

    for u in range(int(rows.max()) + 1):
        add(event="$set", entity_type="user", entity_id=f"u{u}", properties={})
    if kind == "recuser":
        for r, c in zip(rows.tolist(), cols.tolist()):
            add(event="follow", entity_type="user", entity_id=f"u{r}",
                target_entity_type="user", target_entity_id=f"u{c}")
        return out
    for j in range(int(cols.max()) + 1):
        add(event="$set", entity_type="item", entity_id=f"i{j}",
            properties={"categories": [f"c{j % 5}"]})
    for n, (r, c) in enumerate(zip(rows.tolist(), cols.tolist())):
        add(event="view", entity_type="user", entity_id=f"u{r}",
            target_entity_type="item", target_entity_id=f"i{c}")
        if kind == "ecommerce" and n % 10 == 0:
            add(event="buy", entity_type="user", entity_id=f"u{r}",
                target_entity_type="item", target_entity_id=f"i{c}")
    if kind == "ecommerce":
        add(event="$set", entity_type="constraint", entity_id="unavailableItems",
            properties={"items": [f"i{int(j)}" for j in rng.choice(int(cols.max()), 20)]})
    return out


TEMPLIFE = {
    "recuser": ("predictionio_tpu.models.recommendeduser.engine",
                [{"name": "als", "params": {"rank": 10, "numIterations": 10}}],
                [{"users": ["u0"], "num": 4}, {"users": ["u17", "u3"], "num": 10},
                 {"users": ["u5"], "num": 6, "blackList": ["u1", "u2"]},
                 {"users": ["u7"], "num": 5, "whiteList": [f"u{j}" for j in range(0, 400, 7)]},
                 {"users": ["nobody"], "num": 4}]),
    "ecommerce": ("predictionio_tpu.models.ecommerce.engine",
                  [{"name": "als", "params": {"appName": "TPL", "rank": 10,
                                              "numIterations": 10, "unseenOnly": True}}],
                  [{"user": "u0", "num": 4}, {"user": "u17", "num": 10},
                   {"user": "u5", "num": 6, "categories": ["c1", "c3"]},
                   {"user": "u7", "num": 5, "whiteList": [f"i{j}" for j in range(0, 600, 7)]},
                   {"user": "u9", "num": 4, "blackList": ["i0", "i1"]},
                   {"user": "nobody", "num": 4}]),
    "cosine": ("predictionio_tpu.models.similarproduct.engine",
               [{"name": "cosine", "params": {"topN": K6_TOP_N}}],
               [{"items": ["i0"], "num": 4}, {"items": ["i17", "i3"], "num": 10},
                {"items": ["i5"], "num": 6, "categories": ["c1"]},
                {"items": ["i7"], "num": 5, "blackList": ["i1", "i2"]},
                {"items": ["nothing"], "num": 4}]),
}


def plain_answer(torch, server, q: dict) -> dict:
    """What the deployed engine must answer: each algorithm's model
    scored on the CPU (K2 and K2s run their plain versions there; the
    cosine algorithm's host loop is the same code), then its serving."""
    algos = [cpu_algorithm(torch, type(a), a.params) for a in server.algorithms]
    query = server.algorithms[0].query_class(**q)
    preds = [a.predict(m, query) for a, m in zip(algos, server.models)]
    return json.loads(json.dumps(dataclasses.asdict(server.serving.serve(query, preds))))


def check_template_answer(got: dict, want: dict, what: str) -> None:
    """Served JSON against the plain path's: the same entries (ids
    outside runs of near ties), scores within rtol 1e-5."""
    (key, g), = got.items()
    (_, w), = want.items()
    name = "user" if key == "userScores" else "item"
    gs = np.asarray([x["score"] for x in g], np.float32)
    ws = np.asarray([x["score"] for x in w], np.float32)
    if len(g) != len(w) or not np.allclose(gs, ws, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{what}: {g} vs plain {w}")
    ids = {x[name]: n for n, x in enumerate(w)}
    gi = np.asarray([ids.get(x[name], -1 - n) for n, x in enumerate(g)])
    if not near_tie_ids_ok(gi, np.arange(len(w)), ws):
        raise AssertionError(f"{what}: entries {g} vs plain {w}")


@phase("templates lifecycle: events -> train -> deploy (CLI, sqlite, ML-100K shape)")
def templates_lifecycle(torch, device, stats):
    """Each of the three engines -- recommended-user (follows), e-commerce
    (views, buys, an unavailableItems constraint; unseen only) and the
    similar-product template's cosine algorithm (views) -- from
    ML-100K-shaped events in the port's sqlite store through ``cli.main
    train`` (its variant names the JAX package's factory) and ``deploy``
    on the card, queries POSTed and held to the plain path on the same
    model. The cosine model's neighbor tables against the plain version
    bit for bit; K1 (implicit), K2, K2s and K6 launch counters move."""
    from predictionio_tpu_torch.cli import main as cli
    from predictionio_tpu_torch.data import storage as st
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.models import similarproduct as sim
    from predictionio_tpu_torch.ops import als, topk
    from predictionio_tpu_torch.ops import cosine_sim as cs

    rows, cols, _, _, _ = make_ml_shaped("100k")
    rng = np.random.default_rng(SEED + 62)
    out = {}
    topk.top_k_similar.launches.reset()  # the main path's K2 cosine calls, read below
    for kind, (factory, algos, queries) in TEMPLIFE.items():
        basedir = tempfile.mkdtemp(prefix=f"pio_chip_smoke_tpl_{kind}_")
        variant_path = os.path.join(basedir, "engine.json")
        with open(variant_path, "w") as f:
            json.dump({"id": f"chip-smoke-{kind}", "engineFactory": factory,
                       "datasource": {"params": {"appName": "TPL"}}, "algorithms": algos}, f)
        server = None
        try:
            with storage_env(basedir):
                storage = st.get_storage()
                app_id = storage.get_metadata_apps().insert(st.App(0, "TPL"))
                storage.get_events().batch_insert(
                    template_events(Event, kind, rows, cols, rng), app_id)
                counters = (als.solve_bucket.launches, topk.gather_top_k_batch.launches,
                            topk.sum_rows_top_k_batch.launches, cs.item_similarity_topn.launches)
                before = [c.value for c in counters]
                t0 = time.perf_counter()
                flags = ["--device", device.type]
                if cli.main(["train", "--variant", variant_path, *flags]) != 0:
                    raise AssertionError(f"{kind}: cli train failed")
                train_s = time.perf_counter() - t0
                server = cli.deploy_server(cli.build_parser().parse_args([
                    "deploy", "--variant", variant_path, "--ip", "127.0.0.1", "--port", "0",
                    *flags]))
                server.warmup()
                port = server.start(background=True)
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
                for q in queries:
                    got = post(conn, q)
                    check_template_answer(got, plain_answer(torch, server, q),
                                          f"{kind} {q}")
                    log(f"{kind} {json.dumps(q)[:80]} -> {json.dumps(got)[:160]}")
                conn.close()
                moved = [c.value - b for c, b in zip(counters, before)]
                model = server.models[0]
                if kind == "cosine":
                    r = sim._view_counts(sim.SimilarProductDataSource(
                        sim.DataSourceParams(app_name="TPL")).read_training(None))
                    ps, pi = cs.item_similarity_topn_reference(
                        r.rows, r.cols, r.vals, len(r.user_index), len(r.item_index),
                        top_n=K6_TOP_N, device=device)
                    if not (np.array_equal(model.sim_scores.view(np.int32), ps.view(np.int32))
                            and np.array_equal(model.sim_ids, pi)):
                        raise AssertionError("cosine: trained tables differ from the plain "
                                             "version")
        finally:
            if server is not None:
                server.stop()
            shutil.rmtree(basedir, ignore_errors=True)
        check_template_launches(kind, moved)
        out[kind] = {"train_s": train_s, "launches_k1_k2_k2s_k6": moved}
        log(json.dumps({"templife": kind, **out[kind]}))
    stats["k2cos_launches"] = stats.get("k2cos_launches", 0) + topk.top_k_similar.launches.value
    stats["templife"] = out


def check_template_launches(kind: str, moved: list) -> None:
    """The engine's kernels ran on the card: K1 and K2s for
    recommended-user, K1 and K2 for e-commerce, K6 for the cosine
    algorithm (``moved``: K1, K2, K2s, K6 calls during train + queries)."""
    need = {"recuser": (0, 2), "ecommerce": (0, 1), "cosine": (3,)}[kind]
    if any(moved[j] <= 0 for j in need):
        raise AssertionError(f"{kind}: launch counters (K1, K2, K2s, K6) moved {moved}")


# -- the templates at full width -----------------------------------------------


def level_stats(run: dict, n: int) -> dict:
    lat = sorted(run["lat"])
    return {"p50_ms": lat[len(lat) // 2] * 1e3,
            "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))] * 1e3,
            "qps": n / run["wall_s"]}


def serve_levels(server, queries: list, key, kernel: str) -> dict:
    """Closed-loop rounds at concurrency 1 and 8: the answers (equal at
    both levels), p50 / p99 / q/s, and the K2 wrapper ``kernel``'s calls
    by route from the server's /metrics."""
    levels = {}
    for c in TEMPLATE_LEVELS:
        m0 = server.metrics()
        run = closed_loop(server.port, queries, c, key)
        m1 = server.metrics()
        calls = {r: int(metric_delta(m1, m0, f'pio_k2_calls{{kernel="{kernel}",route="{r}"}}'))
                 for r in ("tile", "select")}
        levels[c] = {"answers": run["answers"], **level_stats(run, len(queries)),
                     "kernel_calls": sum(calls.values()), "k2_routes": calls,
                     "dispatches": int(metric_delta(m1, m0, "pio_batch_size_count")),
                     "k2cos": k2cos_served(m1, m0)}
    if levels[1]["answers"] != levels[8]["answers"]:
        raise AssertionError("batched answers differ from solo ones")
    return levels


def check_serving_calls(levels: dict, what: str) -> None:
    """Every dispatch of simple queries is one K2 (or K2s) call, by the
    server's /metrics: on the tile route at k <= 128, on the select route
    when a user's seen items push k = pow2(num + |excluded|) past it."""
    for c, lv in levels.items():
        if lv["kernel_calls"] != lv["dispatches"] or lv["dispatches"] <= 0:
            raise AssertionError(f"{what} c={c}: {lv['kernel_calls']} kernel calls for "
                                 f"{lv['dispatches']} dispatches")


def hold_sample(answers: dict, queries: list, key, expected, what: str) -> int:
    """The first 200 answers against ``expected(q)`` (the plain path)."""
    for q in queries[:200]:
        check_template_answer(json.loads(answers[key(q)]), expected(q), f"{what} {q}")
    return min(200, len(queries))


def cpu_algorithm(torch, cls, params):
    """A copy of an algorithm that scores on the CPU: its kernels' plain
    versions."""
    algo = cls(params)
    algo.device = torch.device("cpu")
    return algo


def generated_engine(module, td, algo_name: str, algo_cls, serving):
    """The template's engine with a data source that returns ``td``."""
    from predictionio_tpu_torch.core import DataSource, Engine, IdentityPreparator

    class Generated(DataSource):
        params_class = module.DataSourceParams

        def read_training(self, ctx):
            return td

    return Engine(Generated, IdentityPreparator, {algo_name: algo_cls}, serving)


@phase("templates at full width: recommended-user, e-commerce, cosine (ML-20M shape)")
def templates_full_width(torch, device, stats):
    """The three engines at their defaults (rank 10, 20 iterations,
    implicit, f32; the cosine algorithm at top_n = 20) through
    ``run_train`` on ML-20M-shaped data, the model saved, then ``deploy``
    in a subprocess with the batcher (``--batch-window-ms 2``) and
    ``POST /queries.json`` at concurrency 1 and 8 (500 distinct query
    entities a level): recommended-user on a follow graph (138,493
    followers, 26,744 followed, the 20 M draws), e-commerce on the views
    (its sqlite store holds the view and buy events of the 500 queried
    users and one ``$set unavailableItems``; its live-filter cache read
    once per user per token and dropped after a write), the
    similar-product template's cosine algorithm on the views (K6's
    counter reset just before ``run_train`` and read just after: the main
    path's launch). Answers held to the plain path on the same model;
    ready_s, p50 / p99, q/s and K2 / K2s calls from /metrics."""
    from predictionio_tpu_torch.core import FirstServing
    from predictionio_tpu_torch.core.context import WorkflowContext
    from predictionio_tpu_torch.core.workflow import prepare_deploy, run_train
    from predictionio_tpu_torch.data import storage as st
    from predictionio_tpu_torch.data import store
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.models import ecommerce as ec
    from predictionio_tpu_torch.models import recommendeduser as ru
    from predictionio_tpu_torch.models import similarproduct as sim
    from predictionio_tpu_torch.ops import als, topk
    from predictionio_tpu_torch.ops import cosine_sim as cs

    rows, cols, _, nu, ni = ml_views(stats, "20m")
    rng = np.random.default_rng(SEED + 63)
    topk.top_k_similar.launches.reset()  # the main path's K2 cosine calls, read below
    users = [f"u{j}" for j in range(nu)]
    basedir = tempfile.mkdtemp(prefix="pio_chip_smoke_templates_")
    storage = st.Storage(env={"PIO_FS_BASEDIR": basedir})
    st.set_storage(storage)
    ctx = WorkflowContext(mode="Training", device=device)
    servers, out = [], {}
    try:
        # recommended-user: u{r} follows u{c}
        follows = st.RatingsBatch(users, [f"u{j}" for j in range(ni)], rows, cols,
                                  np.ones(len(rows), np.float32))
        engine = generated_engine(ru, ru.TrainingData(users=[], follow_events=follows), "als",
                                  ru.ALSAlgorithm, FirstServing)
        ep = engine.params_from_variant({"algorithms": [{"name": "als", "params": {}}]})
        als.solve_bucket.launches.reset()
        t0 = time.perf_counter()
        iid = run_train(engine, ep, engine_id="chip-smoke-ru20m", engine_factory=RU_FACTORY,
                        storage=storage, ctx=ctx)
        train_s = time.perf_counter() - t0
        k1 = als.solve_bucket.launches.value
        t0 = time.perf_counter()
        server = DeployProcess(basedir, iid, device.type,
                               ["--batch-window-ms", str(BATCH_WINDOW_MS)], "ru20m")
        servers.append(server)
        ready_s = time.perf_counter() - t0
        followed = [f"u{int(j)}" for j in rng.permutation(np.unique(cols))[:TEMPLATE_USERS]]
        queries = [{"users": [u], "num": 4} for u in followed]
        levels = serve_levels(server, queries, lambda q: q["users"][0], "sum_rows_top_k_batch")
        check_serving_calls(levels, "recommended-user 20m")
        inst = storage.get_metadata_engine_instances().get(iid)
        _, [algo], [model], _ = prepare_deploy(engine, inst, storage=storage, ctx=ctx)
        cpu = cpu_algorithm(torch, ru.ALSAlgorithm, algo.params)
        held = hold_sample(levels[1]["answers"], queries, lambda q: q["users"][0],
                           lambda q: dataclasses.asdict(cpu.predict(model, ru.Query(**q))),
                           "recommended-user 20m")
        out["recommended_user"] = {"train_s": train_s, "k1_launches": k1, "ready_s": ready_s,
                                   "held": held, **{f"c{c}": {k: v for k, v in lv.items()
                                                             if k != "answers"}
                                                    for c, lv in levels.items()}}
        server.stop()
        log(json.dumps({"templates": "recommended-user 20m", **out["recommended_user"]}))
        del model
        # e-commerce: views, live filters from the sqlite store
        views = st.RatingsBatch(users, [f"i{j}" for j in range(ni)], rows, cols,
                                np.ones(len(rows), np.float32))
        engine = generated_engine(ec, ec.TrainingData(users=[], items={}, view_events=views),
                                  "als", ec.ECommAlgorithm, FirstServing)
        ep = engine.params_from_variant({"algorithms": [{"name": "als", "params": {
            "appName": "EC20M", "unseenOnly": True}}]})
        queried = rng.permutation(np.unique(rows))[:TEMPLATE_USERS]
        app_id = storage.get_metadata_apps().insert(st.App(0, "EC20M"))
        pick = np.isin(rows, queried)  # each seen (user, item) pair once
        seen = np.unique(rows[pick].astype(np.int64) * ni + cols[pick])
        evs = [Event(event="view", entity_type="user", entity_id=f"u{r}",
                     target_entity_type="item", target_entity_id=f"i{c}")
               for r, c in zip((seen // ni).tolist(), (seen % ni).tolist())]
        evs += [Event(event="buy", entity_type="user", entity_id=f"u{u}",
                      target_entity_type="item", target_entity_id=f"i{int(rng.integers(ni))}")
                for u in queried.tolist()]
        popular = np.argsort(-np.bincount(cols, minlength=ni))[:50]
        evs.append(Event(event="$set", entity_type="constraint", entity_id="unavailableItems",
                         properties={"items": [f"i{int(j)}" for j in popular]}))
        t0 = time.perf_counter()
        storage.get_events().batch_insert(evs, app_id)
        insert_s = time.perf_counter() - t0
        als.solve_bucket.launches.reset()
        t0 = time.perf_counter()
        iid = run_train(engine, ep, engine_id="chip-smoke-ec20m", engine_factory=EC_FACTORY,
                        storage=storage, ctx=ctx)
        train_s = time.perf_counter() - t0
        k1 = als.solve_bucket.launches.value
        t0 = time.perf_counter()
        server = DeployProcess(basedir, iid, device.type,
                               ["--batch-window-ms", str(BATCH_WINDOW_MS)], "ec20m")
        servers.append(server)
        ready_s = time.perf_counter() - t0
        queries = [{"user": f"u{int(u)}", "num": 4} for u in queried]
        levels = serve_levels(server, queries, lambda q: q["user"], "gather_top_k_batch")
        check_serving_calls(levels, "e-commerce 20m")
        inst = storage.get_metadata_engine_instances().get(iid)
        _, [algo], [model], _ = prepare_deploy(engine, inst, storage=storage, ctx=ctx)
        cpu = cpu_algorithm(torch, ec.ECommAlgorithm, algo.params)
        held = hold_sample(levels[1]["answers"], queries, lambda q: q["user"],
                           lambda q: dataclasses.asdict(cpu.predict(model, ec.Query(**q))),
                           "e-commerce 20m")
        banned = {f"i{int(j)}" for j in popular}
        for a in levels[1]["answers"].values():
            if banned & {x["item"] for x in json.loads(a)["itemScores"]}:
                raise AssertionError("e-commerce 20m: an unavailable item was served")
        cache = filter_cache_reads(store, storage, app_id, cpu, model, queries[:100], ec, Event)
        out["ecommerce"] = {"train_s": train_s, "k1_launches": k1, "ready_s": ready_s,
                            "held": held, "store_events": len(evs), "insert_s": insert_s,
                            "filter_cache": cache,
                            **{f"c{c}": {k: v for k, v in lv.items() if k != "answers"}
                               for c, lv in levels.items()}}
        server.stop()
        log(json.dumps({"templates": "e-commerce 20m", **out["ecommerce"]}))
        del model
        # the similar-product template's cosine algorithm on the views
        engine = generated_engine(sim, sim.TrainingData(users=[], items={}, view_events=views),
                                  "cosine", sim.CosineAlgorithm, sim.SumScoreServing)
        ep = engine.params_from_variant({"algorithms": [{"name": "cosine", "params": {}}]})
        cs.item_similarity_topn.launches.reset()  # the main path starts here
        for c in cs.item_similarity_topn.stages.values():
            c.reset()
        t0 = time.perf_counter()
        iid = run_train(engine, ep, engine_id="chip-smoke-cos20m", engine_factory=SIM_FACTORY,
                        storage=storage, ctx=ctx)
        train_s = time.perf_counter() - t0
        stats["k6_launches"] = cs.item_similarity_topn.launches.value  # main path read
        stats["k6_stages"] = k6_stage_counts(cs)
        if stats["k6_stages"]["dense"] < 1 or stats["k6_stages"]["sparse"] < 1 or (
                stats["k6_launches"] != sum(stats["k6_stages"].values())):
            raise AssertionError(f"cosine training launched K6 {stats['k6_launches']} times, "
                                 f"by stage {stats['k6_stages']}: no dense stage")
        inst = storage.get_metadata_engine_instances().get(iid)
        _, [algo], [model], serving = prepare_deploy(engine, inst, storage=storage, ctx=ctx)
        if "k6_20m" in stats:  # the k6 phase's launch on the same views
            ks, ki = stats["k6_20m"]
            if not (np.array_equal(model.sim_scores.view(np.int32), ks.view(np.int32))
                    and np.array_equal(model.sim_ids, ki)):
                raise AssertionError("cosine 20m: the trained tables differ from the k6 "
                                     "phase's, which the plain version held")
        t0 = time.perf_counter()
        server = DeployProcess(basedir, iid, device.type,
                               ["--batch-window-ms", str(BATCH_WINDOW_MS)], "cos20m")
        servers.append(server)
        ready_s = time.perf_counter() - t0
        items = [f"i{int(j)}" for j in rng.permutation(np.unique(cols))[:TEMPLATE_USERS]]
        queries = [{"items": [i], "num": 4} for i in items]
        levels = serve_levels(server, queries, lambda q: q["items"][0], "sum_rows_top_k_batch")
        cpu = cpu_algorithm(torch, sim.CosineAlgorithm, algo.params)
        for q in queries:  # the host loop: the same bytes
            want = serving.serve(sim.Query(**q), [cpu.predict(model, sim.Query(**q))])
            if json.loads(levels[1]["answers"][q["items"][0]]) != json.loads(
                    json.dumps(dataclasses.asdict(want))):
                raise AssertionError(f"cosine 20m {q}: served answer differs")
        out["cosine"] = {"train_s": train_s, "k6_launches": stats["k6_launches"],
                         "k6_stages": stats["k6_stages"],
                         "ready_s": ready_s, "held": len(queries),
                         **{f"c{c}": {k: v for k, v in lv.items() if k != "answers"}
                            for c, lv in levels.items()}}
        server.stop()
        log(json.dumps({"templates": "cosine 20m", **out["cosine"]}))
        served = sum(out[t][f"c{c}"]["k2cos"] for t in out for c in TEMPLATE_LEVELS)
        stats["k2cos_launches"] = (stats.get("k2cos_launches", 0)
                                   + topk.top_k_similar.launches.value + served)
    except BaseException:
        for s in servers:
            if s.proc.poll() is None:
                log(s.log_tail())
        raise
    finally:
        for s in servers:
            if s.proc.poll() is None:
                s.stop()
        st.set_storage(None)
        storage.close()
        shutil.rmtree(basedir, ignore_errors=True)
    stats["templates"] = out


def filter_cache_reads(store, storage, app_id, algo, model, queries, ec, Event) -> dict:
    """The e-commerce live filters' store reads, counted around the
    template's ``store.find_by_entity``: a first round reads each user's
    seen events once (and the constraint once), a second round reads
    nothing, and after a write the next query reads again."""
    calls = []
    real = store.find_by_entity

    def counting(*a, **kw):
        calls.append(kw.get("entity_type"))
        return real(*a, **kw)

    store.find_by_entity = counting
    try:
        algo._filters = None  # a fresh cache
        for q in queries:
            algo.predict(model, ec.Query(**q))
        first = list(calls)
        del calls[:]
        for q in queries:
            algo.predict(model, ec.Query(**q))
        second = list(calls)
        storage.get_events().insert(Event(event="view", entity_type="user",
                                          entity_id="u0", target_entity_type="item",
                                          target_entity_id="i1"), app_id)
        del calls[:]
        algo.predict(model, ec.Query(**queries[0]))
        after = list(calls)
    finally:
        store.find_by_entity = real
    if first.count("user") != len(queries) or first.count("constraint") != 1 or second \
            or not after:
        raise AssertionError(f"filter cache reads: first {len(first)}, second {second}, "
                             f"after a write {after}")
    return {"first_round_reads": len(first), "second_round_reads": len(second),
            "reads_after_write": len(after)}


# -- two-stage branches of the recommended-user and e-commerce templates -----------


def hold_cosine_two_stage(model_index, qs: list, exp: list, answers: dict, key, field: str,
                          what: str) -> dict:
    """Served cosine-template answers against the plain two-stage version
    (ids outside near ties, scores within RTOL) and recall@num against
    exact K2s; answers equal to K2s's where they hold its ids, scores bit
    for bit."""
    name = "user" if field == "users" else "item"
    hits = covered = 0
    for q, (pi, ps, ei, es) in zip(qs, exp):
        got = json.loads(answers[key(q)])[f"{name}Scores"]
        ids = np.asarray([model_index[x[name]] for x in got])
        sc = np.asarray([x["score"] for x in got], np.float32)
        if set(q.get("blackList", ())) & {x[name] for x in got}:
            raise AssertionError(f"{what} {q}: a blackListed entry came back")
        if len(ids) != len(pi) or not np.allclose(sc, ps, rtol=RTOL, atol=ATOL) \
                or not near_tie_ids_ok(ids, pi, ps):
            raise AssertionError(f"{what} {q}: {ids} {sc} vs plain {pi} {ps}")
        hits += len(set(ids.tolist()) & set(ei.tolist()))
        if set(ids.tolist()) == set(ei.tolist()):
            covered += 1
            if not np.array_equal(sc.view(np.int32), es.view(np.int32)):
                raise AssertionError(f"{what} {q}: scores differ from K2s's")
    recall = hits / (RET_NUM * len(qs))
    if recall < 0.999:
        raise AssertionError(f"{what}: recall@{RET_NUM} {recall} < 0.999")
    return {"recall": recall, "covered": covered, "queries": len(qs)}


def ru_retrieval(torch, device, storage, basedir, stats, servers) -> dict:
    """The recommended-user template at 1,000,000 followed users, rank 32,
    f32: queries of 1-3 users at num = 10, at concurrency 1 and 8."""
    from predictionio_tpu_torch.core.workflow import save_instance
    from predictionio_tpu_torch.data.bimap import BiMap
    from predictionio_tpu_torch.models import recommendeduser as ru
    from predictionio_tpu_torch.ops import retrieval, topk

    rng = np.random.default_rng(SEED + 42)
    vf = rng.standard_normal((RET_ITEMS, RET_D), dtype=np.float32)
    model = ru.RecommendedUserModel(
        followed_index=BiMap.from_dense([f"u{j}" for j in range(RET_ITEMS)]),
        followed_factors=vf)
    engine = ru.engine()
    ep = engine.params_from_variant({"algorithms": [{"name": "als", "params": {"rank": RET_D}}]})
    iid = save_instance(engine, ep, [model], engine_id="chip-smoke-ret-ru",
                        engine_variant="ret", engine_factory=RU_FACTORY, storage=storage)
    queries = [{"users": [f"u{int(x)}" for x in rng.choice(RET_ITEMS, int(n), replace=False)],
                "num": RET_NUM} for n in rng.integers(1, 4, SIM_QUERIES)]

    def key(q):
        return json.dumps(q, sort_keys=True)

    kernels = {"k4": K4_CALLS % "bf16", "k5": K5_CALLS % "sum_rows", **K4_ROUTES,
               "k4_kernels": "pio_k4_kernel_launches", "k5_kernels": "pio_k5_kernel_launches",
               "k2s": 'pio_k2_calls{kernel="sum_rows_top_k_batch",route="tile"}'}
    server = DeployProcess(basedir, iid, device.type, ["--batch-window-ms", str(BATCH_WINDOW_MS)],
                           "ret-ru", {"PIO_RETRIEVAL_PROBE_EVERY": "0"}, wait=False)
    servers.append(server)
    yield  # every server of the phase starts before the first is measured
    ready_s = server.wait_ready()
    check_warm_k4(server.metrics(), "bf16", "recommended-user")
    spans = check_traced(server, queries[0], "c0ffee00000000a1")
    levels = {}
    for c in RET_LEVELS:
        levels[c] = lv = retrieval_round(server, queries, c, key, kernels)
        check_dispatch_counts(lv, 0, f"recommended-user c={c}")
    if levels[1]["answers"] != levels[8]["answers"]:
        raise AssertionError("recommended-user: batched answers differ from solo ones")
    expected = plain_sim(torch, retrieval, topk, model, device, queries,
                         index=model.followed_index, factors=model.followed_factors,
                         field="users")
    held = hold_cosine_two_stage(model.followed_index, queries, expected, levels[1]["answers"],
                                 key, "users", "recommended-user 1M")
    server.stop()
    out = {"ready_s": ready_s, **held, "trace_spans": spans,
           **{f"c{c}": {k: v for k, v in lv.items() if k != "answers"} for c, lv in levels.items()}}
    log(json.dumps({"retrieval": "recommended-user f32", **out}))
    return out


EC_SEEN_USERS = 50  # e-commerce users with seen items, served alone
EC_SEEN = 20  # their seen items: their exact top 20, so k = 32 and k' = 256


def ec_seen_events(torch, topk, model, device, V, storage, app_id: int, users: list) -> dict:
    """``view`` events of each user's exact top EC_SEEN items into the
    app (before the server starts): {user: seen item ids}."""
    from datetime import datetime, timezone

    from predictionio_tpu_torch.data.event import Event

    events = storage.get_events()
    events.init(app_id)
    uixs = np.asarray([model.user_index[u] for u in users])
    q = torch.from_numpy(model.user_rows(uixs)).to(device)
    _, top = topk.top_k_items_batch(q, V, EC_SEEN)
    seen = {u: [int(x) for x in row] for u, row in zip(users, host(top))}
    t0 = datetime(2024, 1, 1, tzinfo=timezone.utc)
    for u, items in seen.items():
        for j in items:
            events.insert(Event(event="view", entity_type="user", entity_id=u,
                                target_entity_type="item", target_entity_id=f"i{j}",
                                event_time=t0), app_id)
    return seen


def ec_seen_expected(torch, retrieval, topk, model, device, V, cat, seen: dict) -> list:
    """What the e-commerce server must answer users with seen items: k =
    pow2(num + |seen|), the plain two-stage top k without the seen items,
    its first num; and exact K2 with the seen items masked."""
    out = []
    for u, items in seen.items():
        q = torch.from_numpy(model.user_rows(np.asarray([model.user_index[u]]))).to(device)
        k = 1 << (RET_NUM + len(items) - 1).bit_length()
        kp = retrieval.shortlist_k(k, RET_ITEMS)
        _, cand = retrieval.coarse_topk_reference(q, cat._tiles, cat._scales, RET_ITEMS, kp,
                                                  cat.mode)
        ps, pi = retrieval.rescore_top_k_reference("vectors", V, cand, k, vectors=q)
        keep = [(int(i), float(x)) for x, i in zip(host(ps)[0], host(pi)[0])
                if i >= 0 and int(i) not in set(items)][:RET_NUM]
        mask = torch.zeros(RET_ITEMS, dtype=torch.bool, device=device)
        mask[torch.tensor(items, device=device)] = True
        es, ei = topk.top_k_items_batch(q, V, 16, exclude_mask=mask)
        out.append((np.asarray([i for i, _ in keep]), np.asarray([x for _, x in keep], np.float32),
                    host(ei)[0, :RET_NUM], host(es)[0, :RET_NUM]))
    return out


def ec_retrieval(torch, device, storage, basedir, stats, servers) -> dict:
    """The e-commerce template at U = 138,493, I = 1,000,000, rank 32, f32
    (its app in the store): 500 distinct users without events (unseen-only
    filters read and cached empty) at num = 10, at concurrency 1 and 8 --
    k = 16, k' = 128, the warp route; then, alone, 50 users whose exact
    top 20 are seen (``view`` events written before the deploy): k = 32,
    k' = 256, the stream route, the seen items never returned."""
    from predictionio_tpu_torch.core.workflow import save_instance
    from predictionio_tpu_torch.data import storage as st
    from predictionio_tpu_torch.data.bimap import BiMap
    from predictionio_tpu_torch.models import ecommerce as ec
    from predictionio_tpu_torch.ops import retrieval, topk

    rng = np.random.default_rng(SEED + 43)
    uf = rng.standard_normal((U_ROWS, RET_D), dtype=np.float32)
    vf = rng.standard_normal((RET_ITEMS, RET_D), dtype=np.float32)
    model = ec.ECommModel(user_index=BiMap.from_dense([f"u{j}" for j in range(U_ROWS)]),
                          item_index=BiMap.from_dense([f"i{j}" for j in range(RET_ITEMS)]),
                          user_factors=uf, item_factors=vf, categories={})
    app_id = storage.get_metadata_apps().insert(st.App(0, "EC1M"))
    engine = ec.engine()
    ep = engine.params_from_variant({"algorithms": [{"name": "als", "params": {
        "appName": "EC1M", "rank": RET_D}}]})
    iid = save_instance(engine, ep, [model], engine_id="chip-smoke-ret-ec",
                        engine_variant="ret", engine_factory=EC_FACTORY, storage=storage)
    perm = rng.permutation(U_ROWS)
    users = [f"u{int(j)}" for j in perm[:RET_USERS]]
    queries = [{"user": u, "num": RET_NUM} for u in users]
    V = torch.from_numpy(vf).to(device)
    seen = ec_seen_events(torch, topk, model, device, V, storage, app_id,
                          [f"u{int(j)}" for j in perm[RET_USERS:RET_USERS + EC_SEEN_USERS]])
    kernels = {"k4": K4_CALLS % "bf16", "k5": K5_CALLS % "vectors", **K4_ROUTES,
               "k4_kernels": "pio_k4_kernel_launches", "k5_kernels": "pio_k5_kernel_launches",
               "k2": 'pio_k2_calls{kernel="gather_top_k_batch",route="tile"}'}
    server = DeployProcess(basedir, iid, device.type, ["--batch-window-ms", str(BATCH_WINDOW_MS)],
                           "ret-ec", {"PIO_RETRIEVAL_PROBE_EVERY": "0"}, wait=False)
    servers.append(server)
    yield  # every server of the phase starts before the first is measured
    ready_s = server.wait_ready()
    check_warm_k4(server.metrics(), "bf16", "e-commerce")
    spans = check_traced(server, queries[0], "c0ffee00000000e1")
    levels = {}
    for c in RET_LEVELS:
        levels[c] = lv = retrieval_round(server, queries, c, lambda q: q["user"], kernels)
        check_dispatch_counts(lv, 0, f"e-commerce c={c}")
    if levels[1]["answers"] != levels[8]["answers"]:
        raise AssertionError("e-commerce: batched answers differ from solo ones")
    seen_queries = [{"user": u, "num": RET_NUM} for u in seen]
    solo = retrieval_round(server, seen_queries, 1, lambda q: q["user"], kernels)
    # k = pow2(10 + 20 seen) = 32, k' = 256: the stream route, one launch
    check_dispatch_counts(solo, 0, "e-commerce seen items", route="stream")
    for q in seen_queries:
        got = {x["item"] for x in json.loads(solo["answers"][q["user"]])["itemScores"]}
        if got & {f"i{j}" for j in seen[q["user"]]}:
            raise AssertionError(f"e-commerce {q}: a seen item came back")
    cat = retrieval.CoarseCatalog(V, device=device)
    k = 1 << (RET_NUM - 1).bit_length()
    kp = retrieval.shortlist_k(k, RET_ITEMS)
    exp = []
    for lo in range(0, len(users), 50):
        uixs = np.asarray([model.user_index[u] for u in users[lo:lo + 50]])
        q = torch.from_numpy(model.user_rows(uixs)).to(device)
        _, cand = retrieval.coarse_topk_reference(q, cat._tiles, cat._scales, RET_ITEMS, kp,
                                                  cat.mode)
        ps, pi = retrieval.rescore_top_k_reference("vectors", V, cand, k, vectors=q)
        es, ei = topk.top_k_items_batch(q, V, k)
        for b in range(len(uixs)):
            exp.append((host(pi)[b, :RET_NUM], host(ps)[b, :RET_NUM],
                        host(ei)[b, :RET_NUM], host(es)[b, :RET_NUM]))
    held = hold_cosine_two_stage(model.item_index, queries, exp, levels[1]["answers"],
                                 lambda q: q["user"], "items", "e-commerce 1M")
    held_seen = hold_cosine_two_stage(
        model.item_index, seen_queries,
        ec_seen_expected(torch, retrieval, topk, model, device, V, cat, seen), solo["answers"],
        lambda q: q["user"], "items", "e-commerce 1M seen items")
    server.stop()
    out = {"ready_s": ready_s, **held, "seen": held_seen, "trace_spans": spans,
           **{f"c{c}": {k: v for k, v in lv.items() if k != "answers"} for c, lv in levels.items()},
           "seen_solo": {k: v for k, v in solo.items() if k != "answers"}}
    log(json.dumps({"retrieval": "e-commerce f32", **out}))
    return out


# -- summary lines -------------------------------------------------------------------


def k6_summary(stats) -> dict:
    """K6's line: the ML-20M views at top_n = 20, every row (the dense
    stage's chunks, then the sparse stage's); launches: every K6 launch of
    the cosine template's run_train in the templates phase (the main
    path), ``stages`` by stage; ``ms`` the stages' device time together;
    ``slowest_block_ms``: the heaviest row's sparse block launched alone;
    ``h0_ms``: the same views with H = 0 (no dense stage), same run;
    ``ordered_ms``: the ordered route on the same integer views. No single
    PyTorch call computes it: library_ms null."""
    t = stats["k6"]["timing"]
    return {
        "name": "item_similarity_topn",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/cosine_sim.cu",
        "replaces": "predictionio_tpu/ops/cosine_sim.py:73",
        "launches": stats["k6_launches"],
        "max_abs_err": stats["k6_max_abs_err"],
        "ms": t["kernel_device_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
        "stages": stats["k6_stages"],
        "dense_ms": t["dense_ms"],
        "sparse_ms": t["sparse_ms"],
        "sparse_bound_ms": t["stage_bounds"]["sparse"]["bound_ms"],
        "slowest_block_ms": t["slowest_block_ms"],
        "h0_ms": t["h0_ms"],
        "ordered_ms": t["ordered_device_ms"],
    }


def k6_dense_summary(stats) -> dict:
    """K6's dense stage (``gram_s8_kernel``): the heavy users' Gram of the
    ML-20M views, every chunk; launches: the cosine template's run_train
    (the main path); held bit for bit to ``gram_s8_reference`` (the f32
    product of the same operand) on the first chunk; library_ms: one
    ``torch._int_mm`` a chunk on the same operands."""
    d, t = stats["k6"]["dense"], stats["k6"]["timing"]
    return {
        "name": "gram_s8 (K6 dense stage)",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/cosine_sim.cu",
        "replaces": "predictionio_tpu/ops/cosine_sim.py:91",
        "launches": stats["k6_stages"]["dense"],
        "max_abs_err": d["max_abs_err"],
        "ms": d["dense_device_ms"] or d["dense_event_ms"],
        "plain_ms": d["plain_ms"],
        "bound_ms": t["stage_bounds"]["dense"]["bound_ms"],
        "bound_by": t["stage_bounds"]["dense"]["bound_by"],
        "library_ms": d["library_ms"],
    }


def k2cos_summary(stats) -> dict:
    """K2's cosine mode (``top_k_similar``): one query against the
    similar-product catalog's shape (I = 26,744, D = 10, f32, k = 4);
    launches: its calls on the three templates' main path (templife,
    templates, retrieval: in this process, counter set to 0 before each
    and read after, and the deployed servers' /metrics), 0 while no
    template calls it; ``checked_calls``: the k2cos phase's calls, each
    held to the plain version."""
    t = stats["k2cos"]
    dev = None not in (t["kernel_device_ms"], t["plain_device_ms"], t["library_device_ms"])
    return {
        "name": "top_k_similar",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/topk.cu",
        "replaces": "predictionio_tpu/ops/topk.py:247",
        "launches": stats["k2cos_launches"],
        "max_abs_err": t["max_abs_err"],
        "ms": t["kernel_device_ms"] if dev else t["kernel_ms"],
        "plain_ms": t["plain_device_ms"] if dev else t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_device_ms"] if dev else t["library_ms"],
        "k2_route": t["route"],
        "checked_calls": t["calls_checked"],
    }


def k4_summary(stats) -> list:
    """K4's lines and the fused call's, one a route, at I = 1,000,000, D =
    32, B = 8, bf16 coarse (the f32 recommendation model's): the warp
    route at k' = 128 (every num = 10 dispatch), the stream route at k' =
    512 (the blackList queries; the pair it replaced on the same inputs
    beside it), each with its own plain version, bound and
    ``torch.topk(q @ V.float().T, k')``; the fused two-stage call at (k',
    k) = (128, 16) and (512, 64) on the f32 table (kernel device time;
    its plain version K4's then K5's; no one PyTorch call computes it).
    Launches: the retrieval phase's query rounds, from the servers'
    /metrics -- every dispatch one fused call, counted as one K4 call on
    its route."""
    t = stats["retimes"][str(RET_ITEMS)]
    launches = stats["ret_launches"]
    common = {"route": "cuda", "source": "predictionio_tpu_torch/csrc/retrieval.cu",
              "max_abs_err": stats["k4_max_abs_err"]}
    rows = []
    for name, route, kp in (("coarse_topk", "warp", 128), ("coarse_topk_stream", "stream", 512)):
        r = t["k4"][f"bf16 k'={kp}"]
        rows.append({"name": name, "k4_route": route, **common,
                     "replaces": "predictionio_tpu/ops/retrieval.py:212",
                     "launches": launches[f"k4_{route}"], "ms": r["kernel_device_ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r["library_device_ms"],
                     "k_prime": kp, "pair_ms": r["pair_device_ms"],
                     "by_mode_ms": {m: t["k4"][f"{m} k'={kp}"]["kernel_device_ms"]
                                    for m in ("int8", "int8_dot", "bf16")}})
    rows[0]["kernel_launches"] = launches["k4_kernels"]
    for route, kp, k in (("warp", 128, 16), ("stream", 512, 64)):
        r = t["paths"][f"float32 B=8 k'={kp}"]
        rows.append({"name": "two_stage_top_k", "k4_route": route, **common,
                     "max_abs_err": stats["k45_max_abs_err"],
                     "replaces": "predictionio_tpu/ops/retrieval.py:212 + :375",
                     "launches": launches[f"two_stage_{route}"], "ms": r["fused_kernel_device_ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": None, "k_prime": kp, "k": k,
                     "call_ms": r["fused_ms"], "old_call_ms": r["old_ms"]})
    return rows


def k5_summary(stats) -> dict:
    """K5's line: the standalone kernel at B = 8, S = k' = 128, k = 16, D =
    32, user rows of an f32 table. Launches: the K5 calls of the retrieval
    phase's query rounds, every one fused into K4's launch
    (``kernel_launches``: the standalone kernel's launches there, 0)."""
    t = stats["retimes"][str(RET_ITEMS)]["k5"]["float32"]
    return {
        "name": "rescore_top_k",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/retrieval.cu",
        "replaces": "predictionio_tpu/ops/retrieval.py:375",
        "launches": stats["ret_launches"]["k5"],
        "max_abs_err": stats["k5_max_abs_err"],
        "ms": t["kernel_device_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_device_ms"],
        "kernel_launches": stats["ret_launches"]["k5_kernels"],
    }


def k3_summary(stats) -> dict:
    """K3's line: one ML-1M fold of the shipped sweep (Q = 333,334, P = A
    = k = 1), lanes sized to the cutoff; launches from the sweep's main
    path; ``baseline_ms``: the earlier one-warp-a-row design on the same
    inputs in this run."""
    rep = stats["k3_timings"][0]
    dev = None not in (rep["kernel_device_ms"], rep["baseline_device_ms"])
    return {
        "name": "ranking_metrics_batch",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/ranking.cu",
        "replaces": "predictionio_tpu/ops/topk.py:179",
        "launches": stats["eval_launches"]["k3"],
        "max_abs_err": stats["k3_max_abs_err"],
        "ms": rep["kernel_device_ms"] if dev else rep["kernel_ms"],
        "plain_ms": rep["plain_device_ms"] or rep["plain_ms"],
        "bound_ms": rep["bound_ms"],
        "bound_by": rep["bound_by"],
        "library_ms": None,
        "design": f"lanes a query row: {rep['group']}",
        "baseline_ms": rep["baseline_device_ms"] if dev else rep["baseline_ms"],
    }


def topk_items_summary(stats) -> dict:
    """K2's eval line (``eval_topk``'s ``gather_top_k_batch`` calls, the
    port of the JAX package's ``top_k_items_batch``): one ML-1M fold (B =
    333,334 user rows, D = 20, f32, k = 1: the shipped sweep's call);
    launches (calls) and kernel launches from the sweep's main path."""
    rep = stats["topk_items_timings"][0]
    return {
        "name": "gather_top_k_batch (eval top-k)",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/topk.cu",
        "replaces": "predictionio_tpu/ops/topk.py:69",
        "launches": stats["eval_launches"]["k2_eval_calls"],
        "max_abs_err": stats["topk_items_max_abs_err"],
        "ms": rep["kernel_device_ms"] or rep["kernel_ms"],
        "plain_ms": rep["plain_ms"],
        "bound_ms": rep["bound_ms"],
        "bound_by": rep["bound_by"],
        "library_ms": rep["library_device_ms"] or rep["library_ms"],
        "k2_route": rep["route"],
        "kernel_launches": stats["eval_launches"]["k2_eval_kernels"],
    }


def k1s_summary(stats) -> dict:
    """K1s's line: one iteration of 4 candidates at ML-20M rank 20 f32
    (device ms on the queued-events clock, :func:`k1s_clocks`); launches
    from the sweep's main path; ``baseline_ms``: the earlier design (K1's
    launches on the candidate axis) and ``k1_alone_x_C_ms``: K1 on the
    same tables, one candidate at a time, both in this run on the same
    clock; ``eval_groups``: the same at the eval path's shapes."""
    t = stats["k1s_timings"]
    return {
        "name": "solve_bucket_sweep",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/als_solve.cu",
        "replaces": "predictionio_tpu/ops/als.py:1088",
        "launches": stats["eval_launches"]["k1s"],
        "max_abs_err": stats["k1s_max_abs_err"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
        "baseline_ms": t["baseline_ms"],
        "k1_alone_x_C_ms": t["k1_alone_ms"],
        "clock": t["clock"],
        "plan": t["plan"],
        "eval_groups": [{k: g[k] for k in ("rank", "C", "ms", "baseline_ms", "bound_ms",
                                           "launches_per_iteration")}
                        for g in stats["k1s_eval_timings"]],
    }


def k1i_summary(stats) -> dict:
    """K1 implicit's line of the kernels summary: one iteration at the
    ML-20M-shaped view counts, rank 10 f32 (the sum over its launches);
    ``block_ms``: the block kernel on the same buckets in this run."""
    per = stats["k1i_timings"]

    def total(key):
        vals = [r[key] for r in per]
        return None if None in vals else sum(vals)

    nbytes = sum(r["bytes"] for r in per)
    flops = sum(r["flops"] for r in per)
    mem_rate, fp32_rate = peaks(stats["device_name"])
    return {
        "name": "solve_bucket (implicit)",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/als_solve.cu",
        "replaces": "predictionio_tpu/ops/als.py:457",
        "launches": stats["k1i_launches"],
        "max_abs_err": stats["k1i_max_abs_err"],
        "ms": total("kernel_device_ms") or sum(r["kernel_ms"] for r in per),
        "plain_ms": total("plain_device_ms"),
        "bound_ms": sum(r["bound_ms"] for r in per),
        "bound_by": "bytes" if nbytes / mem_rate >= flops / fp32_rate else "operations",
        "library_ms": total("library_device_ms"),
        "block_ms": total("block_device_ms"),
    }


def k2s_summary(stats) -> dict:
    """K2 summed rows' line: one served query (B = 1, L = 4, k = 4);
    ``k2_route``: the route that served it, ``kernel_launches`` the
    kernels the main path's calls launched, as the C entry counted them;
    ``baseline_ms``: the select route on the same inputs in this run;
    ``batch_sizes``: simtrain's concurrent rounds through the
    micro-batcher, batches by size."""
    rep = stats["k2s_timings"][0]
    dev = None not in (rep["kernel_device_ms"], rep["plain_device_ms"],
                       rep["library_device_ms"], rep["baseline_device_ms"])
    return {
        "name": "sum_rows_top_k_batch",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/topk.cu",
        "replaces": "predictionio_tpu/ops/topk.py:135",
        "launches": stats["k2s_launches"],
        "max_abs_err": stats["k2s_max_abs_err"],
        "ms": rep["kernel_device_ms"] if dev else rep["kernel_ms"],
        "plain_ms": rep["plain_device_ms"] if dev else rep["plain_ms"],
        "bound_ms": rep["bound_ms"],
        "bound_by": rep["bound_by"],
        "library_ms": rep["library_device_ms"] if dev else rep["library_ms"],
        "k2_route": rep["route"],
        "kernel_launches": stats["k2s_kernel_launches"],
        "baseline_ms": rep["baseline_device_ms"] if dev else rep["baseline_ms"],
        "batch_sizes": stats["sim_batch_sizes"],
    }


def k1_summary(stats) -> dict:
    """K1's line of the kernels summary: one iteration at ML-20M rank 20,
    f32 storage (the sum over its launches); ``block_ms``: the block
    kernel on the same buckets in this run."""
    per = [r for r in stats["k1_timings"] if r["storage"] == "float32"]

    def total(key):
        vals = [r[key] for r in per]
        return None if None in vals else sum(vals)

    nbytes = sum(r["bytes"] for r in per)
    flops = sum(r["flops"] for r in per)
    mem_rate, fp32_rate = peaks(stats["device_name"])
    return {
        "name": "solve_bucket",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/als_solve.cu",
        "replaces": "predictionio_tpu/ops/als.py:772",
        "launches": stats["k1_launches"],
        "max_abs_err": stats["k1_max_abs_err"],
        "ms": total("kernel_device_ms") or sum(r["kernel_ms"] for r in per),
        "plain_ms": total("plain_device_ms"),
        "bound_ms": sum(r["bound_ms"] for r in per),
        "bound_by": "bytes" if nbytes / mem_rate >= flops / fp32_rate else "operations",
        "library_ms": total("library_device_ms"),
        "block_ms": total("block_device_ms"),
    }


def filelog_k1_summary(stats) -> dict:
    """K1 on the columnar fold of the filelog phase (the partitioned
    store, ML-1M): one fold's grouped buckets on the queued-events clock;
    ``launches`` the deploy's count over its one fold (its /metrics);
    ``train_launches`` and ``retrain_launches`` the phase's ``train`` and
    retrain-on-deploy; ``prepcache_launches`` the prepcache phase's four
    trains (miss, hit, splice, and the cold one); ``fleet_retrain_launches``
    the fleet phase's scheduled retrain (the retrain child's own count,
    from its progress file)."""
    fl = stats["filelog"]
    k1 = fl["fold"]["k1"]
    return {
        "name": "solve_bucket_explicit (columnar fold-in, partitioned store)",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/als_solve.cu",
        "replaces": "predictionio_tpu/ops/als.py:424",
        "launches": fl["fold"]["k1_launches_main_path"],
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"],
        "train_launches": fl["train_k1_launches"],
        "retrain_launches": fl["retrain_on_deploy"]["k1_launches"],
        "prepcache_launches": {k: stats["prepcache"][k]["k1_launches"]
                               for k in ("miss", "hit", "splice", "cold")},
        "fleet_retrain_launches": stats["fleet"]["retrain"]["k1_launches"],
    }


def foldin_k1_summary(stats) -> dict:
    """K1 on the fold-in path (the realtime phase): one fold's grouped
    buckets at the ML-20M shape, on the queued-events clock; ``launches``
    the server's count over the phase's fold, read from its /metrics."""
    rt = stats["realtime"]
    k1 = rt["k1"]
    return {
        "name": "solve_bucket_explicit (fold-in)",
        "route": "cuda",
        "source": "predictionio_tpu_torch/csrc/als_solve.cu",
        "replaces": "predictionio_tpu/ops/als.py:424",
        "launches": rt["k1_launches_main_path"],
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"],
        "heavy_K": k1["heavy_K"],
        "heavy_ms": k1["heavy_ms"],
    }


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
    stats = {"max_abs_err": 0.0, "launches": 0,
             "device_name": torch.cuda.get_device_name(0)}
    steps = {
        "k2": lambda: kernel_vs_plain(torch, device, stats),
        "k1": lambda: k1_vs_plain(torch, device, stats),
        "k1i": lambda: k1_implicit_vs_plain(torch, device, stats),
        "k1route": lambda: k1_route_vs_block(torch, device, stats),
        "k2s": lambda: k2_sum_rows_vs_plain(torch, device, stats),
        "k2route": lambda: k2_route_vs_select(torch, device, stats),
        "k6": lambda: k6_vs_plain(torch, device, stats),
        "k2cos": lambda: k2_cosine_vs_plain(torch, device, stats),
        "k4": lambda: k4_vs_plain(torch, device, stats),
        "k5": lambda: k5_vs_plain(torch, device, stats),
        "times": lambda: timings(torch, device, stats),
        "retimes": lambda: retrieval_timings(torch, device, stats),
        "serve": lambda: the_slice(torch, device, stats),
        "batchserve": lambda: batch_serve(torch, device, stats),
        "lifecycle": lambda: lifecycle(torch, device, stats),
        "ingest": lambda: ingest(torch, device, stats, prep),
        "filelog": lambda: filelog(torch, device, stats, prep, fprep),
        "prepcache": lambda: prep_cache_phase(torch, device, stats, prep, fprep),
        "fleet": lambda: fleet(torch, device, stats, prep, fprep),
        "workers": lambda: workers(torch, device, stats),
        "simlife": lambda: similar_lifecycle(torch, device, stats),
        "templife": lambda: templates_lifecycle(torch, device, stats),
        "train": lambda: full_width(torch, device, stats),
        "ckpt": lambda: checkpointed(torch, device, stats),
        "realtime": lambda: realtime_serving(torch, device, stats),
        "simtrain": lambda: similar_full_width(torch, device, stats),
        "templates": lambda: templates_full_width(torch, device, stats),
        "eval": lambda: eval_phase(torch, device, stats),
        "retrieval": lambda: retrieval_serving(torch, device, stats),
        "k1times": lambda: k1_timings(torch, device, stats),
        "simtimes": lambda: similar_timings(torch, device, stats),
    }
    args = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    args.add_argument(
        "--phases", default=",".join(steps),
        help="comma list of phases to run after environment and build "
        f"(default: all of {','.join(steps)}); a partial run prints no result")
    chosen = args.parse_args().phases.split(",")
    unknown = sorted(set(chosen) - set(steps))
    if unknown:
        print(f"chip_smoke: unknown phases {unknown}", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    smi = environment(torch)
    stats["smi"] = smi
    # the ingest phase's host-only start (files, import, export) runs
    # beside the build and the kernel checks: it touches no device
    prep = (IngestPrep() if {"ingest", "filelog", "prepcache", "fleet", "workers"} & set(chosen)
            else None)
    fprep = (FilelogPrep(prep) if {"filelog", "prepcache", "fleet", "workers"} & set(chosen)
             else None)
    # every train of the run keeps its packed-prep cache entries here, so
    # no entry of an earlier run gives a false hit
    prep_dir = tempfile.mkdtemp(prefix="pio_chip_smoke_prep_")
    os.environ["PIO_PREP_CACHE_DIR"] = prep_dir
    preps = [p for p in (prep, fprep) if p is not None]
    for p in preps:
        p.start()
    late = LateBuild()
    build(late)
    stats["build_done"] = time.perf_counter()
    late_joined = False
    for name in steps:
        if name in chosen and not failures:
            if name not in EARLY_STEPS and not late_joined:
                late_joined = True
                finish_build(late)
                if failures:
                    break
            if name not in BESIDE_PREP and any(p.is_alive() for p in preps):
                # the phases from here on time host work: none of them
                # shares the CPU with the preparations' imports
                t1 = time.perf_counter()
                for p in preps:
                    p.join(timeout=900)
                log(f"waited {time.perf_counter() - t1:.1f}s for the ingest preparations")
            steps[name]()
    if not late_joined:  # a partial run: the late sources still build
        finish_build(late)
    # when a phase failed before ingest or filelog, their import and export
    # processes still end, and their stores go, before the script does
    for p in preps:
        p.join()
    if prep is not None:
        shutil.rmtree(prep.basedir, ignore_errors=True)
        shutil.rmtree(prep.datadir, ignore_errors=True)
    for basedir in (fprep.dirs.values() if fprep is not None else ()):
        shutil.rmtree(basedir, ignore_errors=True)
    shutil.rmtree(prep_dir, ignore_errors=True)
    log(f"total {time.perf_counter() - t0:.1f}s")
    if failures:
        log(f"chip_smoke FAILED phases: {failures}")
        return 1
    if set(chosen) != set(steps):
        log(f"partial run ({','.join(chosen)}): no result lines")
        return 0
    rep = stats["timings"][0]  # f32, B = 1: the per-request serving call
    # device time when the profiler measured it (the kernels' own time);
    # else the per-call CUDA-event time, which includes launch gaps
    dev = None not in (rep["kernel_device_ms"], rep["plain_device_ms"],
                       rep["library_device_ms"], rep["baseline_device_ms"])
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
        "k2_route": rep["route"],
        "kernel_launches": stats["k2_kernel_launches"],
        "baseline_ms": rep["baseline_device_ms"] if dev else rep["baseline_ms"],
        "batch_sizes": stats["batchserve"][f"window_{BATCH_WINDOW_MS:g}ms"][64]["batch_sizes"],
        "filelog_calls": (stats["filelog"]["deploy_k2_calls"]
                          + stats["filelog"]["retrain_on_deploy"]["k2_calls"]),
        "fleet_calls": stats["fleet"]["k2_calls"],
        "workers_calls": stats["workers"]["workers_k2_calls"],
        "replicas_calls": stats["workers"]["replica_k2_calls"],
    }, k1_summary(stats), k1i_summary(stats), k2s_summary(stats),
        k1s_summary(stats), topk_items_summary(stats), k3_summary(stats),
        *k4_summary(stats), k5_summary(stats), k6_summary(stats), k6_dense_summary(stats),
        k2cos_summary(stats), foldin_k1_summary(stats), filelog_k1_summary(stats)]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
