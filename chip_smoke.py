#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``heat_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA device and the
CUDA toolkit:

    python3 chip_smoke.py [--out FILE]

Phases (any failure exits non-zero; nothing is caught and continued):

1. build the CUDA kernels from ``heat_tpu_torch/csrc`` (one ``nvcc`` per
   source, all at once) and print the card's name and power limit;
2. hold each kernel against its plain PyTorch version on the card,
   bitwise, at the main path's shape (8192 rows = 2^20 values), at odd
   row counts, at the KMeans error-feedback ring's 4 and 8 rows, at 8191
   and 8193 rows (not a multiple of the quantize kernels' slab) and at
   2^17 rows (every CTA of the capped grid walks several slabs), on
   random and special blocks (zero, NaN, +-Inf, the 1e36 saturation
   block, subnormal, flushed scales, near FLT_MAX, ties); then time
   kernel, plain version and, where one exists, the single PyTorch call
   computing the same function, the ring hop's kernel beside the two
   launches it replaces (dequantize_fma + quantize, in the same CUDA
   graph), and quantize and the hop at the KMeans ring's 4 and 8 rows
   (their launch floor); quantize, the hop and the pair are timed both
   back to back and as the main path launches them, behind a ring hop's
   rolls (``after_roll_ms``: the time each adds behind them);
3. the main path at ONE position, exact: 500 000 x 32 float32 blobs
   split over rows, mean/std, cdist on 20 000 rows, KMeans (k=8, 30
   Lloyd steps, explicit initial centers) and predict, checked against
   numpy;
4. the compressed path at FOUR positions on the one card under the
   ``int8_block`` policy: allreduce of a (4, 2^20) payload, mean/var/std,
   and the error-feedback KMeans fit, each held to the documented ring
   bound ``p * sum_i absmax_i / 254`` of what rides the ring (the labels
   to 99.9 % of the exact fit's), and the allreduce bitwise equal to the
   ring composed of the unfused kernels; the kernels' launch counts are
   set to 0 before this phase and read after it, and must be exactly 64
   quantize, 102 hops, 30 dequantize_fma and 34 dequantize;
5. the flash-attention kernels (B3 ``flash_attention``, B4
   ``flash_attention_partial``) against their plain versions on the card
   at the kernel's tiles (``kernel_blocks``) at the reference benchmark's
   attention shape (S=4096, H=16, D=64: bf16, bf16 causal, f32 causal)
   and at edge cases (D 8/16/32/40/128, float16, S=384, K/V of 640 rows
   through the K/V ring, q_base 64 and 256 with K/V longer than Q, a q
   tile wholly before its K/V segment, B4 at four positions on distinct
   bases, B4 on the zig-zag ring's non-contiguous slices, a chain of two
   partial folds), each also against float64 dense attention, then timed
   beside their bound, their achieved TFLOP/s and, for B3, PyTorch's
   ``scaled_dot_product_attention`` (timed as a yardstick only), with the
   card's SM clock and power read right after the timed window;
6. the attention path at FOUR positions on the one card: ring attention
   (f32 contiguous flash fold at S=2048, H=8; bf16 causal zig-zag fold at
   S=4096, H=16, three calls back to back), Ulysses (bf16 causal) and ring self-attention (f32,
   x 4096 x 1024 and weights 1024 x 64 carried in through ``interop``),
   each held against single-card ``flash_attention`` or float64 dense
   attention; both kernels' launch counts are set to 0 before this phase
   and read after it, and each must be above 0;
7. linear algebra and Lasso at the reference benchmark's sizes, through
   the entry points: QR and SVD of a tall-skinny 131 072 x 64 float32
   matrix (``bench.py`` qr_svd_ms), split on rows, at 1 position and at 4
   (TSQR), each held to ``||QR - A|| / ||A|| <= 1e-5``, ``max|Q^T Q - I|
   <= 1e-4``, an upper-triangular R, S within rtol 1e-4 of float64
   singular values computed on the card and ``||U diag(S) V^T - A|| /
   ||A|| <= 1e-5``; Lasso coordinate descent at 1 position on the blobs
   (y as ``bench.py`` lasso_rate builds it; lam 0.1, 50 sweeps) held to a
   float64 numpy replay of the same sweeps within 1e-4 of its largest
   coefficient; Lasso ISTA (gd) at 4 positions, exact and under
   ``int8_block`` (1000 steps each), the exact fit within 1e-4 of its
   largest coefficient of a float64 numpy replay of the same steps (on
   the Gram matrix, its step from an eigensolver), the compressed fit's
   loss within 1e-3 of the exact one's (the reference's own gate); the
   kernels' launch counts are set to 0 before the compressed fit and read
   after it, and must be exactly 2 quantize, 3 hops, 1 dequantize_fma and
   1 dequantize a step; the QR input is drawn as the reference benchmark
   draws it, ``randn(131072, 64, split=0)``;
8. the threefry RNG and the estimators that draw from it: the draws of
   the main path (``randn`` 131 072 x 64, ``rand`` 20 000 x 300, ``randint``
   and ``randperm`` over the blobs) on the card at 1 and 4 positions, bit
   for bit the port's CPU draws of the same seed and counter (``randn``
   within 4 ulps), the counter advancing by the elements drawn; KMeans
   with ``init="random"`` and k-means++ on the blobs (the initial centers
   the rows a CPU draw and a float64 replay of the d^2 CDF pick, or for a
   draw within 1e-5 of a CDF step a row that reaches it; each step of the
   fit held to a float64
   numpy Lloyd step, labels equal off float32 ties); KMedians
   (30 steps bitwise equal to numpy's medians) and KMedoids (30 steps
   each held to numpy's snapped means) from the generating centers, and
   their "++" inits; Spectral on 20 000 rows (V orthonormal to 1e-4,
   ``||V^T L V - T|| / ||T|| <= 1e-4``, the 8 smallest Ritz residuals
   under 1e-4, the blob labels recovered at least as well as the
   reference on the CPU); GaussianNB exact (1e-10 of float64 numpy,
   predict equal to numpy's argmax) and under ``int8_block`` at 4
   positions (sigma_ within the ring bound; exactly 1 quantize, 3 hops,
   1 dequantize launched by the fit); KNN (k=5, 20 000 x 20 000) equal to
   a numpy replay off distance ties; an int64 2048^3 product, exact.
9. the array API's foundation on the blobs at 1 and at FOUR positions:
   ``cumsum`` along the split held to float64 numpy within ``gamma_k *
   sum|x|`` (``gamma_k = k u / (1 - k u)``, ``u = 2^-24``, k the row's
   count of terms), ``cumprod`` of ``1 + 1e-3 sin(100 x)`` (in [0.999, 1.001]) within
   ``gamma_k * |prod|``; ``scan``/``exscan``/``reduce`` max, min and sum of
   per-position partials, ``permute``, ``bcast``, ``scatter`` + ``gather``,
   ``where``, ``nonzero`` and the count of ``x[:, 0] > 0``, ``__setitem__``
   across position boundaries, ``diff`` along the split and halos of 2
   rows, all bitwise numpy's; at FOUR positions ``gather`` (each value
   within its block's absmax/254) and ``reduce`` (the ring bound of phase
   4, bitwise the unfused ring) under ``int8_block``, their launches set
   to 0 before and read after, exactly 2 quantize, 3 hops, 2 dequantize;
   ``eye(20 000, split=0)``, ``linspace``/``logspace`` of 500 000 points
   and ``str`` bitwise the port's CPU results; division by zero and
   shifts past the width numpy's values.  Each operation prints its wall
   time and the device time of one call (``torch.profiler``).
10. sort, take, manipulations and the rest of statistics on the blobs at
   1 and FOUR positions, bitwise numpy's unless stated: at FOUR positions
   ``sort(X, axis=0)`` both ways (the resplit sort), the 1-D ring rank
   sort of a column and of one with +-0.0 and NaN written in, the narrow
   ring on two columns, each also bitwise one stable ``torch.sort`` of the
   same keys (timed beside it), and the local sort's two layouts timed;
   ``percentile(X, [5, 25, 50, 75, 95], axis=0)``, ``median`` and the
   global median of a column within 1 ulp of float32 of numpy's float64;
   ``unique`` of phase 3's labels with its inverse, of the rows of the
   sign pattern (int8, 32 columns: the lexsort) and of three of them side
   by side (96 columns: the hash; equal to the port's CPU result, to
   numpy's as a set of rows, and with ``sorted=True`` to numpy's);
   ``topk`` along both axes, ties lowest index first; ``X[perm]`` and
   ``Y[perm] = X`` (the ring take/put, ``perm`` the port's ``randperm``;
   the take beside ``index_select``), a mask key, out-of-range array keys
   clamped and dropped; ``resplit`` and back, ``reshape``, ``flatten``,
   ``concatenate``, ``pad``, ``flip``, ``rot90``, ``repeat``, ``stack``,
   ``diag`` of a 20 000^2 array; ``argmax``, ``maximum``/``minimum``,
   ``bincount``, ``cov`` within ``gamma_n sum|x_i||x_j| / (n - 1)`` of
   float64, ``histogram`` equal to the port's CPU result, ``kurtosis`` and
   ``skew`` within 1e-4 of scipy's, ``average`` weighted and exact within
   gamma_n bounds; at FOUR positions ``average(X, axis=0)`` under
   ``int8_block`` within phase 4's ring bound and bitwise the unfused
   ring, its launches set to 0 before and read after: exactly 1 quantize,
   3 hops, 1 dequantize.  Each operation prints its wall and device time.
11. the 2-D grid of positions at the reference benchmark's sizes, on
   grids of 2 x 2 and 2 x 4 positions on the one card: the grid SUMMA of
   two 1024 x 1024 float32 operands (seed 13, ``bench.py:1352-1357``) in
   its three layouts, each within ``gamma_k |A||B|`` (k = 1024) of the
   float64 product, at ``splits=(0, 1)``; the grid CAQR QR of 4096 x 512
   (seed 29, ``bench.py:1487-1498``): ``||QR - A|| / ||A|| <= 1e-5``,
   ``max|Q^T Q - I| <= 1e-4``, R's strict lower triangle exactly zero, Q
   and R within 1e-4 of their largest entry of the port's CPU result on
   the same input (cuSOLVER's Householder signs against LAPACK's); the
   QDWH SVD of 1024 x 256 (the same draw): S within ``50 eps s_max`` of
   numpy's float64 SVD, ``U S V^T - A`` within ``100 eps s_max``, U and V
   orthonormal within ``200 eps`` (the reference's gates,
   ``tests/test_linalg2d.py``), and its iteration count; the ``resplit``
   round trip ``(0, 1) -> (None, 1) -> (1, 0) -> None`` bitwise; ``sum(0)``
   of the blobs' first 10 007 x 31 values and ``prod(0)`` of ``1 + 1e-3
   sin(100 x)`` of them at ``(0, 1)``: numpy's shapes, within ``gamma_n
   sum|x|`` and ``gamma_n |prod|`` of float64.  Each call prints its wall
   time, host syncs and device time (SUMMA: a CUDA graph; QR and SVD,
   which synchronize, the profiler), beside ``torch.matmul``,
   ``torch.linalg.qr`` and ``torch.linalg.svd`` of the same operands, and
   ``summa2d_tflops`` (2mkn), ``qr2d_tflops`` (``2mn^2 - 2n^3/3``) and
   ``svd2d_tflops`` (the reference's 12-iteration nominal,
   ``bench.py:1491-1496``) over the wall time.
12. the base layer (telemetry and the resilience seams) on the main
   path at FOUR positions under ``int8_block``: phase 4's (4, 2^20)
   allreduce, the error-feedback KMeans fit (k=8, 30 steps) and its
   predict, and the allgather of the blobs split on rows.  (1) Telemetry
   off, their launches are exactly phases 4 and 9's for the same calls
   (62 quantize, 93 hops, 30 dequantize_fma, 32 dequantize); on, the same
   launches and bitwise the same results, the counters as the reference
   counts the same calls (2 allreduce entries, the fit's one for its 30
   rings; 1 allgather), the exact and wire bytes ``wire_model``'s, the
   wire ratio exactly 0.2578125 after the block-aligned allreduce and
   within 2 % of 0.258 after the fit, the ``fit:KMeans``,
   ``predict:KMeans`` and ``commq:*`` spans once each; the allreduce's
   wall time, device time (a CUDA graph, off and on, within the run's
   spread) and host syncs (0 off, 1 on, 2 guarded).  (2) A trace around
   one allreduce: valid host trace-event JSON with the ``commq:allreduce``
   span and the issue/consume pair, and a ``torch.profiler`` device trace
   naming the quantize, hop and dequantize kernels.  (3) NaN, +Inf, the
   1e36 saturation and the bit-30 flip armed on the allreduce: each
   result bitwise the plain ring's on the same corrupted input (every NaN
   0x7fc00000), the first three unhealthy to the guard; under the guard ``raise`` raises naming ``allreduce_q``,
   ``warn`` gives one ``GuardWarning``, ``degrade`` is bitwise
   ``precision="f32"``'s result (a healthy call stays compressed), ``off``
   lets the fault through, each intervention an incident and a flight
   postmortem.  (4) ``inject("nonfinite", rate=0.3, seed=0)`` over 20
   allreduces fires at the pinned indices.  (5) ``/metrics`` of a
   ``MetricsServer`` on 127.0.0.1, port 0, is the Prometheus text of the
   counters.

13. IO, the out-of-core stream, snapshots and resume, at the reference
   benchmark's stream configuration (``bench.py:2715-2719``): the blobs'
   first 200 000 rows (25.6 MB), 8 chunks of 25 000 rows an epoch, 2
   epochs, k = 8.  (1) The rows and the Lasso target written as NetCDF-3
   and CSV (and HDF5 where ``h5py`` imports) and read back onto the card,
   bitwise; (2) the native CSV scanner must have built, and ``load_csv``
   is timed; one NetCDF-3 read of the slab and one pinned copy of it to
   the card give the host's read and copy rates (``stream_model``'s
   defaults).  (3) ``KMeans(mini_batch=25 000)`` and ``Lasso(solver="gd",
   mini_batch=25 000)`` (lam 0.1, y as ``bench.py`` lasso_rate builds it)
   from the file with prefetch off and on, and from the in-memory rows:
   all three bitwise equal, the slab peaks 1 and 2, their wall times the
   medians of 5 alternating rounds; KMeans' chunk updates
   replayed one by one on the card (bitwise the fit), each held to a
   float64 update with the card's labels within 1e-3 of its largest
   center, its labels float64's off near ties (1e-4 of the distance);
   Lasso within 1e-3 of its largest coefficient of a float64 replay;
   rows a second, the measured overlap (off over on) beside
   ``stream_model``'s prediction from this run's read, copy and chunk
   times.  (4) Where ``h5py`` imports (else the phase says
   ``phase 13: hdf5 absent, snapshots not run``): ``int8_block`` KMeans (30
   steps, a snapshot every 10) and Lasso gd (1000 steps, every 250) at FOUR
   positions, each killed by a seeded preemption after its second
   snapshot and resumed, bitwise the uninterrupted fit, the killed and
   resumed pair launching exactly what the uninterrupted fit launches
   (Lasso: phase 7's 2000 quantize, 3000 hops, 1000 dequantize_fma, 1000
   dequantize); the mini-batch KMeans at FOUR positions losing a position
   after its first epoch's snapshot and recovered by ``elastic.recover``
   at TWO, bitwise the uninterrupted 2-position fit; an estimator saved
   and loaded, its predictions equal.  Each step prints its wall time and
   device time (one call under ``torch.profiler``), and the phase
   ``phase13_s``.
14. the compiled-program layer (``htt.fuse``: one CUDA-graph replay a
   call) at the reference benchmark's sizes.  (1) The library's fused
   programs on the blobs at 1 position: ``KMeans.predict`` (k = 8),
   GaussianNB's ``predict``, ``predict_log_proba`` and ``predict_proba``
   (8 classes), ``Lasso.predict`` (33 coefficients), ``kurtosis`` and
   ``skew`` along axis 0, each bitwise its program run eagerly, with its
   build time (warm-up, capture, first replay), peak memory, wall and
   device time beside the eager call's, host synchronize calls and
   ``cudaGraphLaunch`` calls a call (exactly 1); the bytes the cached
   programs hold; the bounded cache: ``KMeans.predict`` on 8 row counts
   under a 256 MiB limit holds at most the limit, and the graph pools,
   the live allocations and (once the allocator lets its free blocks go)
   the reserved memory grow by at most the limit plus 64 MiB.  ``svd`` of
   131 072 x 64 stays unfused: a subprocess shows that capturing its pipeline raises
   (cuSOLVER's ``gesvdj`` fails under capture) and prints the error.  (2) The
   ``int8_block`` path in a graph: mean and std along axis 0 of a (64,
   2^20) float32 array split over rows at FOUR positions (each ring 2^20
   values a position), bitwise the eager call, the profiler finding the
   eager call's kernels in the replay (2 quantize, 6 hops, 2 dequantize).
   (3) The same pipeline under a ``"degrade"`` guard: healthy, one scalar
   read a call and no incident; a NaN in the input, the exact re-run's
   result and the reference's incidents (degraded, then unrecoverable:
   the exact path is unhealthy too); an overflow limit between the exact
   and the quantized result, one incident and the exact result bitwise.
   (4) B3 in a graph: a fused bf16 causal ``flash_attention`` at S = 4096,
   H = 16, D = 64, bitwise the eager call; the build records one kernel,
   and in a process of its own the profiler reads one flash kernel in
   each replay (it drops them in the full run).  (5) AOT:
   the library programs captured, exported, pickled, the cache cleared and
   the bundles installed: no ``fuse.cache.misses`` over the next call of
   each, results bitwise the pre-export ones; a bundle of another
   fingerprint skipped.  (6) A pipeline calling ``float()`` on a DNDarray
   raises ``FuseTraceError``.  Every line carries the card's name and
   power limit; the phase prints ``phase14_s``.
15. planned redistribution (``comm/redistribute.py``) at the reference
   benchmark's sizes: ``resplit_rates``' 2048 x 512 float32, 0 -> 1 at 4
   and 8 positions, exact and ``int8_block``; the blobs 0 -> 1 under
   ``int8_block`` at 4 positions and a mixed-split ``x + y`` on them; a
   grid plan of 4096 x 512 float32 from ``(0, 1)`` to ``(1, 0)`` on 2 x 2
   and 2 x 4, exact and ``int8_block``.  The counts are set to 0 before
   these calls and read after (B1 and B2 once for each split -> split
   stage that compresses).  Exact plans give the input bitwise; the int8
   results are bitwise the plain version (the 1-D ones the reference's
   rotation schedule replayed piece by piece with the plain quantize and
   dequantize on the card, the grid ones the port's CPU run) and within
   ``absmax/254`` of the input.  Each call's wall and device time is
   printed beside its monolithic twin (the padded copy), the batched
   pieces beside a per-piece loop of the kernels, the measured peak
   allocation beside ``Plan.peak_live_bytes``, and the rate of a roll of
   the stacked ``(4, ...)`` blobs by one position (the port's move between
   positions: ``comm/_costs.py``'s ``DEFAULT_ICI_GBPS``); ``phase15_s``.
16. in-process serving (``heat_tpu_torch.serve``) as the reference
   benchmark runs it (bench.py:2255-2293): KMeans (k=8, 3 steps,
   ``random_state`` 0) fit on the blobs' first 20 000 rows and served by
   ``ServeEngine(max_batch_rows=64, min_bucket=8)`` from an in-memory
   stand-in of the model registry (``MemoryRegistry``: the card machine
   has no ``h5py`` for checkpoint files); 32 warm-up requests, then 7
   seeded runs of 512 requests, the unbatched direct twin on the first,
   then the obs twin (bench.py:2299-2322: telemetry on, an SLO monitor
   that never burns) on the same schedules.  The counts are set to 0
   before the main path and read after (no kernel of B1-B4 serves a
   predict: 0 each).  The phase fails unless every served reply is
   bitwise its direct twin and ``dispatches_per_batch`` is 1.0.  It
   prints ``serve_predictions_per_sec`` and ``serve_p99_ms`` (median and
   interquartile spread), ``dispatches_per_batch``, the batch occupancy,
   ``wire_bytes_per_row``, ``direct_bitwise_equal`` and
   ``obs_overhead_p99``.  Then each of the four fused predicts (KNN on
   phase 8's 20 000 rows with k=5, GaussianNB on the blob labels, Lasso
   on ``bench.py``'s target, the KMeans) is exported with
   ``export_warm``, its fuse cache cleared, and installed by a fresh
   engine's ``warm``: the cold latency (install plus the first request
   of 5 rows, which must build nothing) and the warm one (a replay); and
   phase 8's ``knn_predict_ms`` beside the eager float ``topk`` formula it
   replaced, timed in the same run.
17. the serving fleet (``FleetEngine``, ``ProcFleet``, ``Ingress``) as the
   reference benchmark runs it, unreduced (bench.py:2329-2680), KMeans
   (k=8, 3 steps, ``random_state`` 0) on the blobs' first 20 000 rows
   behind ``ServeEngine(max_batch_rows=64, min_bucket=8)``, its AOT
   bundles exported to the sidecar of ``DiskRegistry`` (the fitted state
   as ``.npz``: the card has no ``h5py``; the replica processes open it
   through this script's ``--replica`` mode).  (1) ``fleet_rates``: a
   ``WatermarkAutoscaler(low=1, high=4, hysteresis=1, max_replicas=2)``
   fleet in this process through 20 scale events, each a tick that adds a
   warm replica and one request a replica: ``replica_cold_start_ms``,
   ``scale_event_p99_ms``, ``installed_per_scale_up``, and no fuse or
   compile miss across any scale-up (``zero_compile_scale_ups``, a gate).
   (2) ``procfleet_rates``: 1, 2 and 4 replica processes on this card (each
   its own CUDA context: time-sliced unless MPS runs, and the phase prints
   the compute mode and whether it does), 160 seeded requests of 1-32 rows
   a drive, a warm-up drive and 3 timed ones: ``pps_by_replicas`` and
   ``scaling_efficiency``; gates: every hello 0 fuse and 0 compile misses
   with every bundle installed (``zero_compile_spinups``), the first
   drive's reply ledger equal to the in-process ``FleetEngine`` twin's
   CRCs (``twin_ledger_equal``), one CUDA context for each replica while
   it runs (by pid where ``nvidia-smi`` lists the processes' own pids, else
   by count) and none left after close; in the two-replica fleet, one
   kill -9 of a replica at request 80 of an extra drive: the disposition
   ledger only ``ok`` and ``requeued-ok`` (as many as re-queued), the
   reply ledger the twin's, the replacement warm, the killed replica's
   context gone.  (3) ``hedged_rates``: 2 replicas behind ``Ingress``, 96
   requests of 1-16 rows a drive, 250 ms straggles on ``replica0`` at its
   8th, 24th and 40th dispatch: ``hedged_tail_p99_ms``,
   ``unhedged_tail_p99_ms``, ``hedged_vs_unhedged`` and
   ``armed_idle_overhead_p99``.  No kernel of B1-B4 runs (the counts are
   set to 0 before the phase and must read 0 after it); ``phase17_s``.
18. ``htt.autoshard`` (the static layout analysis, the solved plan, the
   plan applied inside a fused program) as the reference benchmark's
   ``autoshard_rates`` runs it, unreduced (bench.py:2048-2130): 1024 x 512
   float32 ones, the dead 0 -> 1 -> None hop, then ``sqrt(abs(w + 1.0))``,
   at 4 and 8 positions on the card.  Solved and its hand twin
   (``htt.fuse`` of the same function) agree bitwise in values and split
   metadata before any timing; each is one dispatch and one
   ``cudaGraphLaunch`` a call; the plan is not None, elides exactly one
   decision and models fewer wire bytes than the hand layout; the
   telemetry wire ledger around one solved call equals the modeled bytes.
   Printed: the plan's fingerprint, the first call's build split into
   analysis, solve and capture, each call's wall time (median and
   interquartile spread of 21) and profiler device time, and
   ``autoshard_speedup`` = hand ms / solved ms.  Then the seven fixture
   pipelines of ``tests/splitflow_pipelines.py`` at 4 positions under
   ``"f32"`` and ``"int8_block"``, each solved call held bitwise to its
   hand twin (the pipeline called eagerly), with B1 / B2 / dequantize_fma
   / hop launches a call counted for the hand, the first and the steady
   solved call and held to ``P18_RING``; ``svd_pipeline``'s solved call
   runs in a process of its own (its capture is refused, as phase 14's
   probe shows, and the refusal reaches the caller).  Then the ladder:
   the reference's loopy pipeline gets no plan and the hand result; an
   untraceable pipeline with telemetry on records ``autoshard.fallback``
   with reason ``untraceable``.  The counts are set to 0 at the start;
   ``phase18_s``.
19. the port's linter and its capture rules on the card.  (1) ``python -m
   heat_tpu_torch.analysis.cli --baseline`` over the whole
   ``heat_tpu_torch`` tree in a subprocess, with a fresh findings cache:
   cold, warm and warm with ``--format json``; each exits 0 with 0 new
   findings against the committed empty baseline, the warm run's cache
   hits every file and misses none, the JSON parses to 0 findings.
   Printed: files analyzed, findings, the cold and warm seconds.  (2) the
   ground truth of ``tests/test_torch_capture_rules.py`` (imported from
   the checkout; it imports no jax): its SPMD202 positives fused at one
   position in a process of their own, each capture refused with the
   error reaching the caller (its type printed); its SPMD201/205
   positives each give two equal fused calls where two eager calls
   differ (the host value frozen at capture); its SPMD210 positive
   records its observation at the first call's warm-up and capture and
   never at a replay; its negatives each capture, replay as one
   ``cudaGraphLaunch`` a call and give their eager call's bits.  No
   kernel of B1-B4 runs (the counts are set to 0 before the phase and
   must read 0 after it); ``phase19_s``.

Tolerances: float32 within 2e-5 of the plain version and of float64 dense;
bfloat16/float16 within 5e-2 of float64 dense and within 2 ulps of the
output type of the plain version, the ulp taken at each output row's
largest magnitude (its D values: a bf16 rounding of one ``p`` that flips
when kernel and plain scores differ in their last float32 bit moves the
row by about 2^-8 of a value of that row's scale); a partial chain within
2e-6 of the full kernel.

Then it prints a metrics line, the card line, the kernels line, and as its
last line ``{"ok": true, "device": {...}}``.  ``--out`` also writes every
JSON line to FILE.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

N, F, K, ITERS = 500_000, 32, 8, 30
SUB = 20_000
PAYLOAD = 1 << 20
POSITIONS = 4
BLOCK = 128
#: rows at which every CTA of the quantize kernels' capped grid walks
#: several slabs
WALK_ROWS = 1 << 17
#: the KMeans error-feedback ring's shapes: a chunk of 4 rows, a residual of 8
SMALL_ROWS = (4, 8)
#: H100 SXM data sheet: HBM3 bandwidth, float32 (non-tensor-core) rate and
#: the bf16/fp16 and TF32 dense tensor-core rates
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12
TF32_TC_OPS_PER_S = 495e12
#: the float32 attention kernel runs 3xTF32: three TF32 products per product
TF32_PASSES = 3
FLT_MIN = float(np.finfo(np.float32).tiny)
SOURCE = "heat_tpu_torch/csrc/blockquant.cu"
ATTN_SOURCE = "heat_tpu_torch/csrc/flash_attention.cu"
#: the reference benchmark's attention headline (bench.py:67-68) and ring
#: family (bench.py:1678)
ATTN_S, ATTN_H, ATTN_D = 4096, 16, 64
RING_S, RING_H = 2048, 8
SELF_E = 1024
F32_TOL, HALF_TOL, CHAIN_TOL = 2e-5, 5e-2, 2e-6
#: the reference benchmark's tall-skinny QR/SVD (bench.py qr_svd_ms)
QR_M, QR_N = 131_072, 64
QR_TOL, ORTH_TOL, S_RTOL = 1e-5, 1e-4, 1e-4
#: Lasso on the blobs (bench.py lasso_rate): penalty, cd sweeps, gd steps
LASSO_LAM, LASSO_SWEEPS, LASSO_STEPS = 0.1, 50, 1000
#: cd and exact gd against their float64 replays, as a share of the largest
#: coefficient (gd's 1000 steps stop short of the minimiser, so theta still
#: carries the step size); the compressed gd loss against the exact one
#: (the reference's gate)
CD_TOL, GD_TOL, LOSS_RTOL = 1e-4, 1e-4, 1e-3
#: phase 8's draws at the main path's sizes: the reference benchmark's QR
#: input (bench.py:2189), a 20 000-row Spectral fit's Lanczos restart
#: matrix, k-means++'s first row and KMeans' random init over the blobs
RNG_DRAWS = (("randn", (QR_M, QR_N)), ("rand", (SUB, 300)), ("randint", (0, N, (1,))), ("randperm", (N,)))
#: randn against the port's CPU draw: torch's log1p on the card is not the
#: CPU's (tests/test_torch_random.py holds the CPU to the reference so)
RANDN_ULPS = 4
#: a k-means++ draw closer than this share of the total to a step of the
#: d^2 CDF may pick a neighbouring row where two float32 cumsums round
#: apart (the CPU tests assert no draw of their few hundred rows comes so
#: close; over the blobs' 500 000 rows the steps lie 2e-6 apart on
#: average, so there a pick is held to the float64 row or, for a draw
#: this close, to the rows whose interval reaches it)
KPP_GAP = 1e-5
#: Spectral on every 25th row of the blobs (phase 3's SUB rows): the rbf
#: similarity is about 0.94 within a blob and 1.7e-3 across, so the graph
#: is connected and the eigengap after the 8th eigenvalue is clear
SPECTRAL_GAMMA, SPECTRAL_M = 1e-3, 300
#: the share of blob labels the JAX package's Spectral recovers on the CPU
#: at 2 000 rows (every 250th) of the same blobs, with these settings:
#: 1.0, from scripts/spectral_reference_share.py
SPECTRAL_SHARE = 1.0
#: the 8 smallest Ritz pairs' residuals ||L u - theta u|| (||L|| <= 2):
#: 2e-7 at 2 000 rows on the CPU, float32's reach
RITZ_TOL = 1e-4
#: KMedians/KMedoids fits: the benchmark's steps (medians_medoids_rates)
MED_STEPS = 30
KNN_K = 5
#: phase 16: the reference benchmark's serving run (bench.py:2255-2293):
#: KMeans fit rows, the engine's batch cap and bucket floor, warm-up
#: requests, requests a run and runs; the cold/warm request's rows (the
#: loadgen's mean), replays timed, Lasso's cd sweeps (a predict's time
#: does not depend on the fit)
SERVE_FIT_ROWS, SERVE_MAX_BATCH, SERVE_MIN_BUCKET = 20_000, 64, 8
SERVE_WARMUP, SERVE_REQUESTS, SERVE_RUNS = 32, 512, 7
SERVE_REQUEST_ROWS, SERVE_WARM_REPS, SERVE_LASSO_SWEEPS = 5, 20, 10
#: phase 17: the reference benchmark's three fleet runs, unreduced
#: (bench.py:2329-2680): scale events of fleet_rates; procfleet_rates'
#: requests a drive, their rows, timed drives and fleet sizes; the
#: request at which a replica is killed in an extra drive of the
#: two-replica fleet; hedged_rates' requests, rows, straggle and the
#: dispatches of replica 0 it pins the straggles to
FLEET_EVENTS = 20
PROC_REQUESTS, PROC_MAX_ROWS, PROC_DRIVES, PROC_SIZES = 160, 32, 3, (1, 2, 4)
PROC_KILL_AT = 80
HEDGE_REQUESTS, HEDGE_MAX_ROWS, HEDGE_STRAGGLE_S, HEDGE_NTH = 96, 16, 0.25, (8, 24, 40)
#: phase 9: float32's unit roundoff, the halo width, the identity's order
U32 = 2.0 ** -24
HALO = 2
EYE_N = 20_000
#: phase 11: the reference benchmark's grid headlines (bench.py:1317-1600):
#: its 2 x 4 mesh and a 2 x 2 one, the SUMMA's square side, the grid QR's
#: and the QDWH SVD's operands, and the ragged slice of the blobs
GRID_MESHES = ((2, 2), (2, 4))
SUMMA2D_N = 1024
QR2D_M, QR2D_N = 4096, 512
SVD2D_M, SVD2D_N = 1024, 256
RAGGED_ROWS, RAGGED_COLS = 10_007, 31
#: the grid QR's Q and R against the port's CPU result, as a share of each
#: factor's largest entry (float32 roundings of one algorithm on two
#: devices: 1e-6-ish; a flipped Householder sign moves a column by 2|q|)
QR2D_CPU_TOL = 1e-4
#: float32 eps, the unit of the reference's QDWH gates (50/100/200 eps)
EPS32 = float(np.finfo(np.float32).eps)
#: phase 12: the call indices (0-based) of 20 allreduces at which
#: ``inject("nonfinite", rate=0.3, seed=0)`` fires: the port's CPU run
#: and the reference's (``tests/test_torch_resilience.py`` ties them)
SCHEDULE_FIRES = (1, 2, 3, 11, 13, 15, 18)
SCHEDULE_CALLS = 20
#: phase 12: each kernel's symbol as a ``torch.profiler`` trace names it
#: (demangled, or mangled), by its wrapper's C name
TRACE_SYMBOLS = {
    "blockquant_quantize": ("quantize_stream_kernel<false>", "quantize_stream_kernelILb0E"),
    "blockquant_dequantize_add_quantize": ("quantize_stream_kernel<true>", "quantize_stream_kernelILb1E"),
    "blockquant_dequantize": ("dequantize_kernel<false>", "dequantize_kernelILb0E"),
}
#: phase 12: rounds of (off, on, guarded) wall readings of allreduce_q
PHASE12_ROUNDS = 5
#: phase 13: the reference benchmark's stream configuration
#: (bench.py:2715-2719, stream_rates): the blobs' first 200 000 rows, 8
#: chunks of 25 000 rows an epoch, 2 epochs; a chunk is 3.2 MB and the
#: slab 25.6 MB
STREAM_ROWS, STREAM_CHUNKS, STREAM_EPOCHS = 200_000, 8, 2
STREAM_MB = STREAM_ROWS // STREAM_CHUNKS
#: phase 13: the mini-batch fits against their float64 numpy replays, as
#: a share of the largest center or coefficient (float32 chunk updates:
#: 1e-6-ish; a label flipped at a float32 near-tie moves a center by
#: about |x - c| / count, some 1e-4 of the blobs' scale)
STREAM_TOL = 1e-3
#: phase 13: alternating rounds of (off, on, in memory) wall readings of
#: each mini-batch fit
STREAM_ROUNDS = 5
#: phase 13: a mini-batch KMeans label may differ from float64's only
#: where the row's two nearest centers' squared distances lie within this
#: share of each other (float32 rounding of |c|^2 - 2 x.c)
KM_TIE = 1e-4
#: phase 13: the checkpointed int8_block fits at 4 positions: KMeans 30
#: steps a snapshot every 10, Lasso gd 1000 steps every 250, each killed
#: by a seeded preemption after its second snapshot and resumed
CKPT_KM_EVERY, CKPT_LASSO_EVERY, CKPT_KILL_AT = 10, 250, 2
#: phase 14: the int8_block pipeline's operand, 64 rows of 2^20 values
#: split over rows at 4 positions (each allreduce carries 2^20 values a
#: position, as phase 12's allreduce_q), and the kernels one call of its
#: mean and std launches there (two rings of 1 quantize, 3 hops, 1 dequantize)
P14_ROWS = 64
P14_RING = {"blockquant_quantize": 2, "blockquant_dequantize_add_quantize": 6,
            "blockquant_dequantize": 2}
#: phase 14's bounded fuse cache: KMeans.predict on 8 row counts of the
#: blobs, 25 000 rows apart, under a 256 MiB limit; the graph pools, the
#: live allocations and (once the allocator lets its free blocks go) the
#: reserved memory may grow by the limit plus this much (outputs in flight)
FUSE_BOUND_LIMIT, FUSE_BOUND_STEP, FUSE_BOUND_SLACK = 256 << 20, 25_000, 64 << 20
#: phase 15: ``resplit_rates``' shape and position counts (bench.py:1216-1300)
#: and the grid plan at phase 11's QR size (bench.py:1487-1498)
RESPLIT_SHAPE, RESPLIT_POSITIONS = (2048, 512), (4, 8)
GRID_PLAN_SHAPE = (4096, 512)
#: phase 15's launches: B1 and B2 once for each compressed split -> split
#: stage: 2048 x 512 at 4 and 8 (2), the blobs' resplit and their mixed
#: add (2), the grid's two compressed stages on 2 x 2 and 2 x 4 (4)
P15_LAUNCHES = {"blockquant_quantize": 8, "blockquant_dequantize": 8,
                "blockquant_dequantize_fma": 0, "blockquant_dequantize_add_quantize": 0}
#: phase 18's copies of what it runs from the JAX package's tree (the card
#: machine has no JAX): ``tests/splitflow_pipelines.py`` whole, ``bench.py``'s
#: ``_autoshard_bench_pipeline`` (bench.py:2048-2063) and
#: ``tests/test_autoshard.py``'s ``_loopy_pipeline``, each the same source
#: with only its import line changed to ``heat_tpu_torch``
#: (``tests/test_torch_autoshard.py`` checks).  The phase writes them into
#: one file and imports it by path: ``htt.autoshard`` analyzes a pipeline's
#: source file.
AUTOSHARD_PIPELINES = r'''"""Oracle pipelines: the SAME source is analyzed statically and executed.

tests/test_splitflow_oracle.py points the splitflow engine at this file,
reads the inferred split for every local variable, then runs each
pipeline on a real mesh and asserts the runtime ``.split`` matches the
static inference exactly — at mesh sizes 1, 2, 4 and 8.  The resplit
pipeline additionally reconciles the static comm-cost report against the
telemetry wire-byte ledger.

Keep every shape a literal and divisible by 8 so all mesh sizes shard
evenly; the engine prices collectives from these literals.
"""

import heat_tpu_torch as ht

__all__ = [
    "svd_pipeline", "kmeans_pipeline", "lasso_pipeline", "gnb_pipeline",
    "fused_pipeline", "resplit_pipeline", "staged_resplit_pipeline",
]


def _features(comm=None):
    """Deterministic row-split design matrix, (64, 32) float32."""
    flat = ht.arange(2048, dtype=ht.float32, split=0, comm=comm)
    x = flat.reshape((64, 32))
    return x


def _labels(comm=None):
    """Alternating binary labels aligned with the rows of _features."""
    y = ht.arange(64, split=0, comm=comm) % 2
    return y


def svd_pipeline(comm=None):
    a = _features(comm)
    u, s, v = ht.linalg.svd(a)
    return a, u, s, v


def kmeans_pipeline(comm=None):
    x = _features(comm)
    km = ht.cluster.KMeans(n_clusters=2, max_iter=3, random_state=0)
    km.fit(x)
    labels = km.predict(x)
    return x, labels


def lasso_pipeline(comm=None):
    x = _features(comm)
    y = _labels(comm)
    model = ht.regression.Lasso(lam=0.01, max_iter=5)
    model.fit(x, y)
    pred = model.predict(x)
    return x, y, pred


def gnb_pipeline(comm=None):
    x = _features(comm)
    y = _labels(comm)
    model = ht.naive_bayes.GaussianNB()
    model.fit(x, y)
    pred = model.predict(x)
    proba = model.predict_proba(x)
    return x, y, pred, proba


@ht.fuse
def _fused_core(a, b):
    c = a + b
    d = ht.sqrt(ht.abs(c))
    return d


def fused_pipeline(comm=None):
    a = ht.ones((64, 32), dtype=ht.float32, split=0, comm=comm)
    b = ht.full((64, 32), 3.0, dtype=ht.float32, split=0, comm=comm)
    out = _fused_core(a, b)
    return a, b, out


def resplit_pipeline(comm=None):
    """Pure layout traffic — every byte it moves is statically priceable."""
    x = ht.ones((64, 32), dtype=ht.float32, split=0, comm=comm)
    y = x.resplit(1)
    z = ht.zeros((32, 64), dtype=ht.float32, split=1, comm=comm)
    w = z.resplit(0)
    return x, y, z, w


def staged_resplit_pipeline(comm=None):
    """Hand layout with a DEAD intermediate hop — the autoshard win case.

    ``t`` exists only to feed the second resplit, so the hand plan pays
    0→1 plus 1→None while one 0→None all-gather suffices.  The solver
    must find that (tests/test_autoshard.py prices both); the dead hop
    is deliberate, hence the SPMD502 suppression.
    """
    x = _features(comm)
    t = x.resplit(1)
    w = t.resplit(None)  # spmdlint: disable=SPMD502
    return x, w
'''
AUTOSHARD_BENCH = r'''def _autoshard_bench_pipeline(comm=None):
    """Hand-layout pipeline with a DEAD staging hop — the autoshard win
    case at bench scale (2 MB operand, shapes literal and divisible by
    8 so every mesh shards evenly).  MODULE-LEVEL for the same
    cache-stability reason as _bench_pipeline.  The hand resplits ARE
    the benchmark's subject, hence the suppressions: SPMD502 flags the
    dead intermediate hop and SPMD505 flags hand layout inside an
    autoshard-wrapped function — both deliberate here, this is the twin
    the solver must beat."""
    import heat_tpu_torch as ht

    x = ht.ones((1024, 512), dtype=ht.float32, split=0, comm=comm)
    t = x.resplit(1)  # spmdlint: disable=SPMD505
    w = t.resplit(None)  # spmdlint: disable=SPMD502,SPMD505
    y = ht.sqrt(ht.abs(w + 1.0))
    return x, y
'''
AUTOSHARD_LOOPY = r'''def _loopy_pipeline(comm=None):
    x = ht.ones((64, 32), dtype=ht.float32, split=0, comm=comm)
    for axis in (1, 0):
        # deliberately summary-hostile: layout traffic under control flow
        x = x.resplit(axis)  # spmdlint: disable=SPMD206
    return (x,)
'''
#: phase 18: the fixtures' positions, the benchmark pipeline's (bench.py:
#: 2066-2130 runs it on the mesh it is given), the wall-time calls of each
#: timed program, and B1 / B2 / dequantize_fma / hop launches a call of each
#: fixture under int8_block at 4 positions: the reference quantizes the
#: fits' rings (KMeans: one error-feedback ring a step, 3 steps; GaussianNB:
#: one ring of its moments), not Lasso's coordinate descent, and no resplit
#: of these 8 KiB arrays (below the redistribution threshold eagerly,
#: monolithic inside a trace)
P18_POSITIONS = 4
AUTOSHARD_BENCH_POSITIONS = (4, 8)
P18_WALL_REPS = 21
P18_RING = {"kmeans_pipeline": (6, 3, 3, 9), "gnb_pipeline": (1, 1, 0, 3)}
#: phase 12's armed plans, each firing on the first allreduce: NaN and
#: +Inf written to element 0, the 1e36 saturation, the bit-30 flip
PHASE12_FAULTS = (("nonfinite", {}), ("nonfinite", {"value": float("inf")}), ("saturate", {}),
                  ("bitflip", {"seed": 3}))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def smi(query: str) -> str:
    """One line of ``nvidia-smi --query-gpu=<query>`` for the first card."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def card_line() -> str:
    return smi("name,power.limit")


def make_blobs():
    """The reference benchmark's blobs (bench.py make_blobs), same seed."""
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=10, size=(K, F)).astype(np.float32)
    return np.concatenate(
        [c + rng.normal(size=(N // K, F)).astype(np.float32) for c in centers]
    ), centers


def numpy_lloyd(data: np.ndarray, init: np.ndarray, iters: int):
    """The reference benchmark's numpy Lloyd loop (bench.py
    numpy_kmeans_rate), per-cluster sums by masks."""
    centers = init.copy()
    for _ in range(iters):
        d2 = (
            (data * data).sum(1, keepdims=True)
            + (centers * centers).sum(1)[None, :]
            - 2.0 * data @ centers.T
        )
        labels = d2.argmin(1)
        sums = np.stack([data[labels == k].sum(0, dtype=np.float64) for k in range(K)])
        counts = np.bincount(labels, minlength=K).astype(np.float64)[:, None]
        centers = np.where(counts > 0, sums / np.maximum(counts, 1), centers).astype(np.float32)
    return centers


def special_rows(rng) -> np.ndarray:
    """One row per special block kind (see the kernel source)."""
    def scaled(amax):
        r = rng.normal(size=BLOCK).astype(np.float32)
        r = (r / np.abs(r).max() * np.float32(amax)).astype(np.float32)
        r[10], r[11] = 0.0, np.float32(0.5 * FLT_MIN)
        return r

    rows = [np.zeros(BLOCK, np.float32)]
    for idx, val in ((5, np.nan), (7, np.inf), (9, -np.inf), ((3, 4), (np.inf, np.nan))):
        r = rng.normal(size=BLOCK).astype(np.float32)
        r[list(np.atleast_1d(idx))] = val
        rows.append(r)
    rows.append((rng.normal(size=BLOCK) * 1e36).astype(np.float32))
    rows.append((rng.uniform(-0.99, 0.99, size=BLOCK) * FLT_MIN).astype(np.float32))
    for amax in (FLT_MIN * 2, 1e-37, 1e-36, 127 * FLT_MIN * 0.9999, 200 * FLT_MIN, 3e38):
        rows.append(scaled(amax))
    rows.append(np.array([127.0, 2.5, -3.5, 0.5, -0.5, 126.5] + [0.0] * (BLOCK - 6), np.float32))
    return np.stack(rows)


def near_tie_rows(rng, count: int) -> np.ndarray:
    """Rows whose quotients x / scale sit on or within 2 ulps of a
    half-integer: the cases where a division that is not correctly
    rounded would round to the other integer.  Each row's absmax is
    log-uniform in [2^-119, 2^100] (so some scales lie under 2^-96, the
    kernels' IEEE-division path); in every other row the scale has at most
    12 significant bits, so that many quotients are exact ties."""
    inv127 = np.float32(1.0) / np.float32(127.0)
    out = np.empty((count, BLOCK), np.float32)
    for i in range(count):
        amax = np.float32(2.0 ** rng.uniform(-119, 100))
        if i % 2:
            e = int(np.floor(np.log2(amax / 127))) - 11
            s0 = np.float32(np.ldexp(float(rng.integers(2048, 4096)), e))
            cand = np.float32(s0 / inv127)
            if np.float32(cand * inv127) == s0:
                amax = cand
        scale = np.float32(amax * inv127)
        h = rng.integers(-127, 127, size=BLOCK).astype(np.float32) + np.float32(0.5)
        x = (h * scale).astype(np.float32)
        steps = rng.integers(-2, 3, size=BLOCK)
        for _ in range(2):
            x = np.where(steps > 0, np.nextafter(x, np.float32(np.inf)), x)
            x = np.where(steps < 0, np.nextafter(x, np.float32(-np.inf)), x)
            steps = steps - np.sign(steps)
        x[0] = amax if rng.integers(2) else -amax
        out[i] = x
    return out


def payload(rows: int, seed: int) -> np.ndarray:
    """``rows`` rows of 128 values: one of each special block first, then
    random rows, every other one of them near ties (:func:`near_tie_rows`)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, BLOCK)) * 3.0).astype(np.float32)
    sp = special_rows(rng)
    k = min(rows, len(sp))
    x[:k] = sp[:k] if rows >= len(sp) else sp[rng.choice(len(sp), size=k, replace=False)]
    ties = x[k + 1::2]  # a view: every other random row
    if len(ties):
        ties[:] = near_tie_rows(rng, min(len(ties), 512))[np.arange(len(ties)) % 512]
    return x.reshape(-1)


def bitwise_equal(a, b) -> bool:
    import torch

    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def max_abs_err(a, b) -> float:
    import torch

    both = torch.isfinite(a) & torch.isfinite(b)
    if not bool(both.any()):
        return 0.0
    return float((a[both].double() - b[both].double()).abs().max())


def device_ms(fn, argsets, per_graph: int = 32, trials: int = 9) -> float:
    """Median device time of one call: ``per_graph`` calls, rotating over
    ``argsets`` (sized past the 50 MB L2 so each call reads from HBM), are
    captured in one CUDA graph and replayed between CUDA events."""
    return float(np.median(device_times(fn, argsets, per_graph, trials)))


def device_times(fn, argsets, per_graph: int = 32, trials: int = 9) -> list:
    """The ``trials`` device times of one call behind :func:`device_ms`."""
    import torch

    for a in argsets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(per_graph):
            fn(*argsets[i % len(argsets)])
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_graph)
    return times


def after_ms(kernel, prep, argsets):
    """Device time that ``kernel`` adds behind ``prep``, the PyTorch op
    that comes before it on the main path: ``(prep then kernel) - prep``,
    each timed with :func:`device_ms`.  ``prep`` maps an argset to the
    kernel's arguments.  Back to back, a kernel launched with programmatic
    dependent launch overlaps its own previous launch; behind a PyTorch
    op, which never triggers its dependents early, it cannot.  Returns
    ``(added, both, prep alone)`` in ms."""
    both = device_ms(lambda *a: kernel(*prep(*a)), argsets)
    alone = device_ms(prep, argsets)
    return both - alone, both, alone


def hop_prep(cq, q, s, a):
    """What the ring runs before a hop kernel, at the same sizes: the
    addend's gather (a roll stands in for it), then the payload's roll."""
    add = cq._hop((a,), POSITIONS)[0]
    return (*cq._hop((q, s), POSITIONS), add)


def wall_ms(fn, reps: int = 5) -> float:
    """Median host time of ``fn`` fenced by a device synchronise."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def bound_ms(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def phase_kernels(torch, cq, dev):
    """Phase 2: every kernel bitwise against its plain version, then timed."""
    big = PAYLOAD // BLOCK
    for rows in (1, 3, 33, big, *SMALL_ROWS, big - 1, big + 1, WALK_ROWS):
        x = torch.from_numpy(payload(rows, seed=rows)).to(dev)
        add = torch.from_numpy(payload(rows, seed=rows + 1)).to(dev)
        q, s = cq.quantize_blocks(x)
        qp, sp = cq.quantize_blocks_plain(x.reshape(rows, BLOCK))
        d, dp = cq.dequantize_blocks(q, s), cq.dequantize_blocks_plain(q, s)
        pairs = [("quantize q", q, qp), ("quantize scale", s, sp), ("dequantize", d, dp)]
        for negate in (False, True):
            f = cq.dequantize_fma_blocks(q, s, add, negate=negate)
            fp = cq.dequantize_fma_blocks_plain(q, s, add, negate=negate)
            pairs.append((f"dequantize_fma negate={negate}", f, fp))
        h, hs = cq.dequantize_add_quantize_blocks(q, s, add)
        hp, hsp = cq.dequantize_add_quantize_blocks_plain(q, s, add)
        pairs += [("dequantize_add_quantize q", h, hp), ("dequantize_add_quantize scale", hs, hsp)]
        torch.cuda.synchronize()
        for what, a, b in pairs:
            check(bitwise_equal(a, b), f"{what} kernel != plain at rows={rows}")
        print(f"kernels == plain, bitwise, at rows={rows}")
    for fused in (False, True):
        grids = {rows: cq._quantize_grid(rows, fused) for rows in (*SMALL_ROWS, big, WALK_ROWS)}
        ctas, step = grids[WALK_ROWS]
        check(grids[SMALL_ROWS[0]][0] == 1 and ctas * step < WALK_ROWS,
              f"quantize grid (fused={fused}): {grids}")
        print(f"{'hop' if fused else 'quantize'} grid (rows: CTAs, rows per step): {grids}")

    n = big * BLOCK
    bufs = 16  # 16 x 4 MiB inputs: past the L2
    xs = [torch.randn(n, device=dev) for _ in range(bufs)]
    adds = [torch.randn(n, device=dev) for _ in range(bufs)]
    enc = [cq.quantize_blocks(x) for x in xs]
    torch.cuda.synchronize()
    q0, s0 = enc[0]
    x0 = xs[0]

    def q_err(got, want):
        return max(max_abs_err(got[1], want[1]), max_abs_err(got[0].float(), want[0].float()))

    err = {
        "blockquant_quantize": q_err(cq.quantize_blocks(x0), cq.quantize_blocks_plain(x0.reshape(big, BLOCK))),
        "blockquant_dequantize": max_abs_err(cq.dequantize_blocks(q0, s0), cq.dequantize_blocks_plain(q0, s0)),
        "blockquant_dequantize_fma": max_abs_err(
            cq.dequantize_fma_blocks(q0, s0, adds[0]), cq.dequantize_fma_blocks_plain(q0, s0, adds[0])
        ),
        "blockquant_dequantize_add_quantize": q_err(
            cq.dequantize_add_quantize_blocks(q0, s0, adds[0]),
            cq.dequantize_add_quantize_blocks_plain(q0, s0, adds[0]),
        ),
    }
    qargs = [(x,) for x in xs]
    qargs_plain = [(x.reshape(big, BLOCK),) for x in xs]
    dargs = [e for e in enc]
    fargs = [(e[0], e[1], a) for e, a in zip(enc, adds)]
    scale_b = big * 4
    rows_out = []
    for name, kernel, plain, library, args, plain_args, nbytes, ops, replaces in (
        ("blockquant_quantize", cq.quantize_blocks, cq.quantize_blocks_plain, None,
         qargs, qargs_plain, n * 4 + n + scale_b, n * 6, "heat_tpu/comm/compressed.py:230"),
        ("blockquant_dequantize", cq.dequantize_blocks, cq.dequantize_blocks_plain,
         lambda q, s: torch.mul(q, s), dargs, dargs, n + scale_b + n * 4, n, "heat_tpu/comm/compressed.py:249"),
        ("blockquant_dequantize_fma", cq.dequantize_fma_blocks, cq.dequantize_fma_blocks_plain,
         lambda q, s, a: torch.addcmul(a.reshape(q.shape), q, s), fargs, fargs,
         n + scale_b + n * 4 + n * 4, n * 2, "heat_tpu/comm/compressed.py:249"),
        ("blockquant_dequantize_add_quantize", cq.dequantize_add_quantize_blocks,
         cq.dequantize_add_quantize_blocks_plain, None, fargs, fargs,
         n + scale_b + n * 4 + n + scale_b, n * 8, "heat_tpu/comm/compressed.py:230"),
    ):
        ms = device_ms(kernel, args)
        plain_ms = device_ms(plain, plain_args)
        lib_ms = device_ms(library, args) if library is not None else None
        b_ms, b_by = bound_ms(nbytes, ops)
        row = {
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": None, "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        }
        extra = ""
        pair = lambda q, s, a: cq.quantize_blocks(cq.dequantize_fma_blocks(q, s, a))  # noqa: E731
        if name == "blockquant_dequantize_add_quantize":
            row["unfused_pair_ms"] = device_ms(pair, fargs)
            extra = f", the two launches it replaces {row['unfused_pair_ms'] * 1e3:.2f} us"
        if name in ("blockquant_quantize", "blockquant_dequantize_add_quantize"):
            # the launch floor at the KMeans error-feedback ring's shapes;
            # and at every shape, as the main path launches the kernel:
            # behind a ring hop's roll (for the hop, the addend's roll,
            # standing in for the ring's gather of it, then the payload's)
            hop = name == "blockquant_dequantize_add_quantize"
            if hop:
                prep = lambda q, s, a: hop_prep(cq, q, s, a)  # noqa: E731
            else:
                prep = lambda x: cq._hop((x,), POSITIONS)  # noqa: E731
            row["small_ms"], row["after_roll_ms"], rolls = {}, {}, []
            for rows in (big, *SMALL_ROWS):
                sets = args
                if rows != big:
                    xs_s = [torch.randn(rows * BLOCK, device=dev) for _ in range(bufs)]
                    sets = [(*cq.quantize_blocks(x), torch.randn(rows * BLOCK, device=dev)) if hop
                            else (x,) for x in xs_s]
                    row["small_ms"][str(rows)] = device_ms(kernel, sets)
                added, _, alone = after_ms(kernel, prep, sets)
                row["after_roll_ms"][str(rows)] = added
                rolls.append(f"{rows} rows {added * 1e3:.2f} us (roll alone {alone * 1e3:.2f} us)")
            if hop:
                row["unfused_pair_after_roll_ms"] = after_ms(pair, prep, fargs)[0]
                rolls.append(f"the two launches it replaces {row['unfused_pair_after_roll_ms'] * 1e3:.2f} us")
            added = row["after_roll_ms"][str(big)]
            share = (f"{b_ms / added * 100:.1f} % of the bound at {big} rows" if added > 0
                     else "share of the bound not resolved")
            extra += ("; at " + ", ".join(f"{r} rows {t * 1e3:.2f} us" for r, t in row["small_ms"].items())
                      + "; behind a roll, as on the main path: " + ", ".join(rolls)
                      + f" ({share})")
        rows_out.append(row)
        print(f"{name}: {ms * 1e3:.2f} us (bound {b_ms * 1e3:.2f} us by {b_by}, "
              f"{b_ms / ms * 100:.1f} %), plain {plain_ms * 1e3:.2f} us, library "
              f"{'none: no single PyTorch call computes it' if lib_ms is None else f'{lib_ms * 1e3:.2f} us'}"
              + extra)
    return rows_out


def ring_unfused(torch, cq, stacked, size: int):
    """The int8 ring allreduce with every reduce-scatter hop as two
    launches, ``dequantize_fma`` then ``quantize`` (the f32 partial sum
    written and read back): the composition the hop kernel replaces."""
    n = stacked.shape[1]
    chunk = cq._padded_len(-(-n // size), BLOCK)
    chunks = torch.nn.functional.pad(stacked, (0, size * chunk - n)).reshape(size, size, chunk)
    pos = torch.arange(size, device=stacked.device)
    cur = chunks[pos, pos]
    for s in range(size - 1):
        payload = cq._hop(cq.quantize_blocks(cur.reshape(-1)), size)
        add = chunks[pos, (pos - s - 1) % size].reshape(-1)
        cur = cq.dequantize_fma_blocks(*payload, add).reshape(size, chunk)
    return cq.dequantize_blocks(*cq._hop(cq.quantize_blocks(cur.reshape(-1)), size))[:n]


def ring_plain(torch, cq, stacked, size: int):
    """The int8 ring allreduce composed of the kernels' plain PyTorch
    versions, on the tensor's own device: the ring every faulted
    ``allreduce_q`` of phase 12 is held to, bitwise."""
    n = stacked.shape[1]
    chunk = cq._padded_len(-(-n // size), BLOCK)
    chunks = torch.nn.functional.pad(stacked, (0, size * chunk - n)).reshape(size, size, chunk)
    pos = torch.arange(size, device=stacked.device)
    payload = cq.quantize_blocks_plain(chunks[pos, pos].reshape(-1, BLOCK))
    for s in range(size - 1):
        add = chunks[pos, (pos - s - 1) % size].reshape(-1)
        payload = cq.dequantize_add_quantize_blocks_plain(*cq._hop(payload, size), add)
    return cq.dequantize_blocks_plain(*cq._hop(payload, size))[:n]


def trace_kernel_names(text: str) -> set:
    """The wrappers of :data:`TRACE_SYMBOLS` whose kernels a Chrome trace
    (``torch.profiler``'s JSON) names."""
    names = [str(e.get("name", "")) for e in json.loads(text).get("traceEvents", [])]
    return {k for k, syms in TRACE_SYMBOLS.items() if any(sym in n for n in names for sym in syms)}


# --------------------------------------------------------------------- #
# attention (phases 5 and 6)                                              #
# --------------------------------------------------------------------- #
def attn_inputs(shape, dtype, seed: int, dev, n: int = 3):
    """``n`` float32 normal arrays from a numpy seed, on ``dev`` in ``dtype``."""
    import torch

    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev).to(dtype)
            for _ in range(n)]


def dense64(q, k, v, causal: bool, q_base: int = 0):
    """Float64 dense attention on (B, S, H, D), one head at a time."""
    import torch

    B, S, H, D = q.shape
    Sk = k.shape[1]
    out = torch.empty((B, S, H, D), dtype=torch.float64, device=q.device)
    keep = None
    if causal:
        keep = (q_base + torch.arange(S, device=q.device)[:, None]) >= torch.arange(Sk, device=q.device)[None, :]
    for b in range(B):
        for h in range(H):
            qh, kh, vh = (t[b, :, h].double() for t in (q, k, v))
            sc = (qh @ kh.T) / np.sqrt(D)
            if keep is not None:
                sc = sc.masked_fill(~keep, -np.inf)
            out[b, :, h] = torch.softmax(sc, dim=-1) @ vh
    return out


def ulps(a, b) -> float:
    """Largest distance of ``a`` from ``b`` in ulps of their (half-precision
    or float32) dtype, the ulp taken at the largest magnitude of each row
    of ``b`` (its last axis)."""
    import torch

    mant = {torch.bfloat16: 7, torch.float16: 10, torch.float32: 23}[a.dtype]
    mag = torch.clamp_min(b.double().abs().amax(dim=-1, keepdim=True), 2.0 ** -100)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - mant)
    return float(((a.double() - b.double()).abs() / ulp).max())


def hold(what: str, out, plain, ref) -> float:
    """Hold a kernel's output to its plain version and to float64 dense at
    the stated tolerances; returns the max abs error against plain."""
    import torch

    check(bool(torch.isfinite(out).all()), f"{what}: non-finite output")
    err_plain = max_abs_err(out.float(), plain.float())
    err_ref = float((out.double() - ref).abs().max())
    if out.dtype == torch.float32:
        check(err_plain <= F32_TOL, f"{what}: {err_plain:.3g} from plain > {F32_TOL}")
        check(err_ref <= F32_TOL, f"{what}: {err_ref:.3g} from float64 dense > {F32_TOL}")
        print(f"{what}: plain {err_plain:.3g}, dense {err_ref:.3g}")
    else:
        u = ulps(out, plain)
        check(u <= 2.0, f"{what}: {u:.3g} ulps from plain > 2")
        check(err_ref <= HALF_TOL, f"{what}: {err_ref:.3g} from float64 dense > {HALF_TOL}")
        print(f"{what}: plain {err_plain:.3g} ({u:.2f} ulps), dense {err_ref:.3g}")
    return err_plain


def hold_state(what: str, got, want, dtype) -> float:
    """Hold a partial fold's state to its plain version: ``m`` and ``l``
    within 2e-5 relative (float32 maxima and sums of the float32 ``p``),
    the normalized ``acc / l`` at the output tolerance of ``dtype`` (2e-5
    for float32, 2 ulps per row for bf16/f16: the PV product takes ``p``
    rounded to ``dtype``).  Returns the max abs error of ``acc / l``."""
    import torch

    (m, l, acc), (m0, l0, acc0) = got, want
    check(bool(torch.equal(torch.isfinite(m), torch.isfinite(m0))), f"{what}: m finiteness differs")
    for name, a, b in (("m", m, m0), ("l", l, l0)):
        err = max_abs_err(a, b)
        scale = float(b[torch.isfinite(b)].abs().max()) if bool(torch.isfinite(b).any()) else 1.0
        check(err <= F32_TOL * max(1.0, scale), f"{what}: {name} {err:.3g} from plain")
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out0 = acc0 / torch.clamp_min(l0, 1e-30)[..., None]
    err = max_abs_err(out, out0)
    if dtype == torch.float32:
        check(err <= F32_TOL, f"{what}: acc/l {err:.3g} from plain > {F32_TOL}")
        print(f"{what}: acc/l {err:.3g} from plain")
    else:
        u = ulps(out.to(dtype), out0.to(dtype))
        check(u <= 2.0, f"{what}: acc/l {u:.3g} ulps from plain > 2")
        print(f"{what}: acc/l {err:.3g} from plain ({u:.2f} ulps)")
    return err


def attn_flops(S: int, Sk: int, D: int, heads: int, causal: bool) -> float:
    """4*D operations per (query, key) pair per head (2 for QK^T, 2 for PV)
    over the pairs the function needs, queries and keys both from position
    0: all S * Sk, or under causal min(Sk, i + 1) keys for query row i."""
    pairs = sum(min(Sk, i + 1) for i in range(S)) if causal else S * Sk
    return 4.0 * D * heads * pairs


def rate_line(ms: float, ops: float, b_ms: float) -> str:
    """Achieved TFLOP/s (the algorithm's operations, not the passes) and
    the share of the bound reached."""
    return f"kernel: {ops / (ms * 1e-3) / 1e12:.1f} TFLOP/s, {b_ms / ms * 100:.1f} % of its bound"


def _bshd(t):
    """(heads, L, d) -> (1, L, heads, d), the layout of ``dense64``."""
    return t.transpose(0, 1)[None]


def check_partial_positions(fa, dev, dtype, d: int = 64, per: int = 2, L: int = 256) -> float:
    """B4 at four positions on distinct bases in one launch.  From the
    initial state, the normalized fold is held to the plain version at the
    kernel's tiles and to float64 dense attention of each position's
    queries over its segment; from a random state, to the plain version.
    Position 0's queries lie wholly before its keys: its state comes back
    bit for bit.  Returns the largest error of acc / l against plain."""
    import torch

    qb, kb = [0, 256, 64, 128], [256, 0, 0, 64]
    P = len(qb)
    blocks = fa.kernel_blocks(dtype)
    q, k, v = attn_inputs((P * per, L, d), dtype, seed=11, dev=dev)
    init = (torch.full((P * per, L), -float("inf"), device=dev),
            torch.zeros((P * per, L), device=dev), torch.zeros((P * per, L, d), device=dev))
    m0, l0 = attn_inputs((P * per, L), torch.float32, seed=12, dev=dev, n=2)
    rand = (m0, l0.abs() + 1.0, attn_inputs((P * per, L, d), torch.float32, seed=13, dev=dev, n=1)[0])
    errs = []
    for what, st in (("initial", init), ("random", rand)):
        got = fa.flash_attention_partial(q, k, v, *st, qb, kb, causal=True)
        want = fa.flash_attention_partial_plain(q, k, v, *st, qb, kb, True, *blocks)
        torch.cuda.synchronize()
        errs.append(hold_state(f"partial 4 positions {dtype} D={d} ({what} state)", got, want,
                               dtype))
        check(all(bool(torch.equal(a[:per], b[:per])) for a, b in zip(got, st)),
              f"partial 4 positions {dtype}: the fully masked position changed its state")
        if what == "initial":
            out = got[2] / torch.clamp_min(got[1], 1e-30)[..., None]
            tol = F32_TOL if dtype == torch.float32 else HALF_TOL
            for i in range(1, P):
                sl = slice(i * per, (i + 1) * per)
                ref = dense64(_bshd(q[sl]), _bshd(k[sl]), _bshd(v[sl]), True, qb[i] - kb[i])
                err = float((out[sl].double() - ref[0].transpose(0, 1)).abs().max())
                check(err <= tol, f"partial position {i} {dtype}: {err:.3g} from float64 dense > {tol}")
    return max(errs)


def check_partial_zigzag(fa, dev, dtype, p: int = 4, bh: int = 4, Lh: int = 128,
                         d: int = 64) -> float:
    """B4 on the zig-zag ring's operands: the halves of a (p, BH, 2Lh, D)
    K/V buffer, handed over without a copy.  The diagonal fold (causal)
    and the unmasked fold are each held to the plain version and to
    float64 dense attention, and must equal the kernel on contiguous
    copies bit for bit.  Returns the largest error against plain."""
    import torch

    blocks = fa.kernel_blocks(dtype)
    kz, vz = attn_inputs((p, bh, 2 * Lh, d), dtype, seed=14, dev=dev, n=2)
    q = attn_inputs((p * bh, Lh, d), dtype, seed=15, dev=dev, n=1)[0]
    rows = lambda t: t.reshape((p * bh,) + tuple(t.shape[2:]))  # noqa: E731
    base = (torch.arange(p, device=dev) * Lh).tolist()
    errs = []
    for half, causal in ((slice(0, Lh), True), (slice(Lh, 2 * Lh), False)):
        ks, vs = rows(kz[:, :, half]), rows(vz[:, :, half])
        check(not ks.is_contiguous() and ks.stride(0) == 2 * Lh * d, "zig-zag slice is a copy")
        st = (torch.full((p * bh, Lh), -float("inf"), device=dev),
              torch.zeros((p * bh, Lh), device=dev), torch.zeros((p * bh, Lh, d), device=dev))
        got = fa.flash_attention_partial(q, ks, vs, *st, base, base, causal=causal)
        copy = fa.flash_attention_partial(q, ks.contiguous(), vs.contiguous(), *st, base, base,
                                          causal=causal)
        want = fa.flash_attention_partial_plain(q, ks, vs, *st, base, base, causal, *blocks)
        torch.cuda.synchronize()
        what = f"partial zig-zag slices {dtype} causal={causal}"
        check(all(bool(torch.equal(a, b)) for a, b in zip(got, copy)),
              f"{what}: differs from the kernel on contiguous copies")
        errs.append(hold_state(what, got, want, dtype))
        out = got[2] / torch.clamp_min(got[1], 1e-30)[..., None]
        ref = dense64(_bshd(q), _bshd(ks), _bshd(vs), causal)[0].transpose(0, 1)
        err = float((out.double() - ref).abs().max())
        tol = F32_TOL if dtype == torch.float32 else HALF_TOL
        check(err <= tol, f"{what}: {err:.3g} from float64 dense > {tol}")
    return max(errs)


def phase_attention_kernels(torch, fa, dev):
    """Phase 5: B3/B4 against their plain versions (at the kernel's tiles)
    and float64 dense, at edge cases and the headline shape; then timed.
    Returns the two kernel rows and the three tokens/s metrics."""
    plain = lambda q, k, v, c, qb=0: fa.flash_attention_plain(  # noqa: E731
        q, k, v, c, qb, *fa.kernel_blocks(q.dtype))
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32

    # -- edge cases at small shapes
    for D in (16, 32, 128, 8, 40):
        for dt in (f32, bf16):
            q, k, v = attn_inputs((1, 256, 2, D), dt, seed=D, dev=dev)
            hold(f"flash D={D} {dt} causal", fa.flash_attention(q, k, v, True),
                 plain(q, k, v, True), dense64(q, k, v, True))
    q, k, v = attn_inputs((2, 256, 2, 64), f16, seed=5, dev=dev)
    hold("flash f16 causal B=2", fa.flash_attention(q, k, v, True), plain(q, k, v, True),
         dense64(q, k, v, True))
    for dt in (f32, bf16):
        q, k, v = attn_inputs((2, 384, 3, 64), dt, seed=8, dev=dev)
        hold(f"flash S=384 {dt} causal", fa.flash_attention(q, k, v, True), plain(q, k, v, True),
             dense64(q, k, v, True))
        q, k, v = attn_inputs((1, 640, 2, 64), dt, seed=9, dev=dev)
        qs = q[:, 512:]
        hold(f"flash Sq=128 Sk=640 q_base=512 {dt} causal",
             fa.flash_attention(qs, k, v, True, q_base=512), plain(qs, k, v, True, 512),
             dense64(q, k, v, True)[:, 512:])
        for lo, Sk in ((256, 512), (64, 384)):
            q, k, v = attn_inputs((1, Sk, 2, 64), dt, seed=6, dev=dev)
            qs = q[:, lo:lo + 128]
            hold(f"flash q_base={lo} Sq=128 Sk={Sk} {dt}",
                 fa.flash_attention(qs, k, v, True, q_base=lo), plain(qs, k, v, True, lo),
                 dense64(q, k, v, True)[:, lo:lo + 128])
    for dt in (f32, bf16, f16):
        check_partial_positions(fa, dev, dt, d=40)
    for dt in (f32, bf16):
        check_partial_zigzag(fa, dev, dt)

    BH, L, D = 8, 256, 64
    q, k, v = attn_inputs((BH, 2 * L, D), f32, seed=7, dev=dev)
    st0 = (torch.full((BH, L), -float("inf"), device=dev), torch.zeros((BH, L), device=dev),
           torch.zeros((BH, L, D), device=dev))
    # a q tile wholly before its K/V segment: no tile visited, state untouched
    m, l, acc = fa.flash_attention_partial(q[:, :L], k[:, L:], v[:, L:], *st0, 0, L, causal=True)
    torch.cuda.synchronize()
    check(all(bool(torch.equal(a, b)) for a, b in zip((m, l, acc), st0)),
          "partial: a q tile before its segment changed the state")
    # a chain of two segments equals the full kernel
    for causal in (False, True):
        st = (torch.full((BH, 2 * L), -float("inf"), device=dev),
              torch.zeros((BH, 2 * L), device=dev), torch.zeros((BH, 2 * L, D), device=dev))
        for r in range(2):
            sl = slice(r * L, (r + 1) * L)
            st = fa.flash_attention_partial(q, k[:, sl], v[:, sl], *st, 0, r * L, causal=causal)
        chained = st[2] / torch.clamp_min(st[1], 1e-30)[..., None]
        full = fa.flash_attention(q.transpose(0, 1)[None], k.transpose(0, 1)[None],
                                  v.transpose(0, 1)[None], causal)[0].transpose(0, 1)
        err = max_abs_err(chained, full)
        check(err <= CHAIN_TOL, f"partial chain causal={causal}: {err:.3g} from full > {CHAIN_TOL}")
        print(f"partial chain of 2 == full kernel, causal={causal}: {err:.3g}")

    # -- the headline shape, checked then timed
    S, H, D = ATTN_S, ATTN_H, ATTN_D
    sets = 3  # 3 x (Q, K, V) of 8-16 MiB each: past the L2
    results, metrics = {}, {}
    for key, dt, causal in (("attention", bf16, False), ("causal_attention", bf16, True),
                            ("causal_attention_f32", f32, True)):
        argsets = [tuple(attn_inputs((1, S, H, D), dt, seed=100 + i, dev=dev)) for i in range(sets)]
        q, k, v = argsets[0]
        out = fa.flash_attention(q, k, v, causal)
        err = hold(f"flash S={S} H={H} D={D} {dt} causal={causal}", out, plain(q, k, v, causal),
                   dense64(q, k, v, causal))
        ms = device_ms(lambda a, b, c: fa.flash_attention(a, b, c, causal), argsets)
        clocks = smi("clocks.sm,power.draw,power.limit")
        plain_ms = device_ms(lambda a, b, c: plain(a, b, c, causal), argsets, per_graph=2, trials=3)
        lib_ms = device_ms(
            lambda a, b, c: torch.nn.functional.scaled_dot_product_attention(
                a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2), is_causal=causal),
            argsets)
        nbytes = 4 * S * H * D * q.element_size()
        ops = attn_flops(S, S, D, H, causal)
        if dt == f32:  # 3xTF32: three tensor-core passes per product
            b_ms, b_by = bound_ms(nbytes, TF32_PASSES * ops, TF32_TC_OPS_PER_S)
        else:
            b_ms, b_by = bound_ms(nbytes, ops, BF16_TC_OPS_PER_S)
        results[key] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                            bound_by=b_by, max_abs_err=err)
        metrics[f"{key}_tokens_per_s"] = S / (ms / 1e3)
        print(f"clocks.sm, power.draw, power.limit right after timing {key}: {clocks}")
        print(f"flash_attention {key}: {ms * 1e3:.1f} us (bound {b_ms * 1e3:.1f} us by {b_by}), "
              f"plain {plain_ms * 1e3:.1f} us, scaled_dot_product_attention {lib_ms * 1e3:.1f} us; "
              + rate_line(ms, ops, b_ms))

    # B4 at the zig-zag ring's round fold: 4 positions x 16 heads, Lh = 512
    P, Lh = POSITIONS, ATTN_S // POSITIONS // 2
    rows = P * ATTN_H
    argsets = []
    for i in range(sets):
        q, k, v = attn_inputs((rows, Lh, D), bf16, seed=200 + i, dev=dev)
        m0, l0 = attn_inputs((rows, Lh), f32, seed=300 + i, dev=dev, n=2)
        acc0 = attn_inputs((rows, Lh, D), f32, seed=400 + i, dev=dev, n=1)[0]
        argsets.append((q, k, v, m0, l0.abs() + 1.0, acc0))
    bases = (torch.arange(P, device=dev) * Lh, torch.zeros(P, dtype=torch.int64, device=dev))
    blocks = fa.kernel_blocks(bf16)
    got = fa.flash_attention_partial(*argsets[0], *bases)
    want = fa.flash_attention_partial_plain(*argsets[0], *[b.tolist() for b in bases], False, *blocks)
    err = hold_state("flash_attention_partial bf16 round fold", got, want, bf16)
    ms = device_ms(lambda *a: fa.flash_attention_partial(*a, *bases), argsets)
    clocks = smi("clocks.sm,power.draw,power.limit")
    plain_ms = device_ms(lambda *a: fa.flash_attention_partial_plain(*a, 0, 0, False, *blocks),
                         argsets, per_graph=4, trials=3)
    nbytes = 3 * rows * Lh * D * 2 + 2 * (2 * rows * Lh * 4) + 2 * rows * Lh * D * 4
    ops = attn_flops(Lh, Lh, D, rows, False)
    b_ms, b_by = bound_ms(nbytes, ops, BF16_TC_OPS_PER_S)
    results["partial"] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                              bound_by=b_by, max_abs_err=err)
    print(f"clocks.sm, power.draw, power.limit right after timing partial: {clocks}")
    print(f"flash_attention_partial (bf16, {rows} x {Lh} x {D}, one ring round): "
          f"{ms * 1e3:.1f} us (bound {b_ms * 1e3:.1f} us by {b_by}), plain {plain_ms * 1e3:.1f} us, "
          f"library none: no single PyTorch call folds into a running softmax state; "
          + rate_line(ms, ops, b_ms)
          + f", {nbytes / (ms * 1e-3) / 1e9:.0f} GB/s")

    kernel_rows = []
    for name, key, replaces in (
        ("flash_attention", "attention", "heat_tpu/parallel/flash_attention.py:137"),
        ("flash_attention_partial", "partial", "heat_tpu/parallel/flash_attention.py:161"),
    ):
        r = results[key]
        kernel_rows.append({
            "name": name, "route": "cuda", "source": ATTN_SOURCE, "replaces": replaces,
            "launches": None, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    kernel_rows[0]["cases"] = {k: v for k, v in results.items() if k != "partial"}
    return kernel_rows, metrics


def phase_attention_path(torch, htt, fa, dev):
    """Phase 6: ring, Ulysses and ring self-attention at POSITIONS positions
    on the one card, through the entry points; returns the launch counts
    and the path's metrics."""
    from heat_tpu_torch import interop

    par = htt.parallel
    comm4 = htt.TorchCommunication([dev] * POSITIONS)
    f32, bf16 = torch.float32, torch.bfloat16
    counted = (fa.flash_attention, fa.flash_attention_partial)
    for fn in counted:
        fn.launches = 0

    # ring, f32, non-causal: the contiguous flash fold
    q, k, v = attn_inputs((RING_S, RING_H, ATTN_D), f32, seed=500, dev=dev)
    qd, kd, vd = (htt.array(t, split=0, comm=comm4) for t in (q, k, v))
    ring32 = par.ring_attention(qd, kd, vd, causal=False)
    single32 = fa.flash_attention(q, k, v, False)
    ref32 = dense64(q[None], k[None], v[None], False)[0]
    # ring, bf16, causal: the zig-zag fold
    qb, kb, vb = attn_inputs((ATTN_S, ATTN_H, ATTN_D), bf16, seed=501, dev=dev)
    qbd, kbd, vbd = (htt.array(t, split=0, comm=comm4) for t in (qb, kb, vb))
    # three calls back to back, no sync between: each fold's state must be
    # complete when the next kernel reads it
    ringzs = [par.ring_attention(qbd, kbd, vbd, causal=True) for _ in range(3)]
    ringz = ringzs[0]
    uly = par.ulysses_attention(qbd, kbd, vbd, causal=True)
    singleb = fa.flash_attention(qb, kb, vb, True)
    refb = dense64(qb[None], kb[None], vb[None], True)[0]
    # ring self-attention, f32: weights made by numpy, carried in through interop
    rng = np.random.default_rng(502)
    x_np = rng.normal(size=(ATTN_S, SELF_E)).astype(np.float32)
    w_np = [(rng.normal(size=(SELF_E, ATTN_D)) / np.sqrt(SELF_E)).astype(np.float32) for _ in range(3)]
    xd = interop.array_from_numpy(x_np, split=0, comm=comm4)
    wd = [interop.array_from_numpy(w, comm=comm4) for w in w_np]
    selfo = par.ring_self_attention(xd, *wd)
    proj = [(xd.larray @ w.larray)[:, None, :] for w in wd]
    single_self = fa.flash_attention(*proj, False)[:, 0]
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counted}
    print(f"{POSITIONS} positions, attention: launches {launches} "
          f"(expected flash_attention 4, flash_attention_partial 4 + 3 x 9 + 4 = 35)")
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the attention path")

    for what, out, single, ref, tol in (
        ("ring f32 contiguous", ring32, single32, ref32, F32_TOL),
        *((f"ring bf16 zig-zag causal, call {i + 1}", r, singleb, refb, HALF_TOL)
          for i, r in enumerate(ringzs)),
        ("ulysses bf16 causal", uly, singleb, refb, HALF_TOL),
        ("ring self-attention f32", selfo, single_self, None, F32_TOL),
    ):
        check(tuple(out.shape) == tuple(single.shape) and bool(torch.isfinite(out).all()),
              f"{what}: shape {tuple(out.shape)} or non-finite values")
        e_single = max_abs_err(out.float(), single.float())
        line = f"{what}: {e_single:.3g} from single-card flash_attention"
        if out.dtype == f32:
            check(e_single <= tol, f"{what}: {e_single:.3g} from single-card flash > {tol}")
        if ref is not None:
            e_ref = float((out.double() - ref).abs().max())
            check(e_ref <= tol, f"{what}: {e_ref:.3g} from float64 dense > {tol}")
            line += f", {e_ref:.3g} from float64 dense"
        print(line)
    check(bool(torch.equal(uly, singleb)), "ulysses != single-card flash_attention on the same global tensor")
    xs = torch.from_numpy(x_np).double().to(dev)
    ref_self = dense64(*[(xs @ torch.from_numpy(w).double().to(dev))[None, :, None, :] for w in w_np],
                       False)[0, :, 0]
    e = float((selfo.double() - ref_self).abs().max())
    check(e <= F32_TOL, f"ring self-attention: {e:.3g} from float64 dense > {F32_TOL}")

    metrics = {
        "ring_attention_ms": wall_ms(lambda: par.ring_attention(qbd, kbd, vbd, causal=True), reps=9),
        "ring_attention_f32_ms": wall_ms(lambda: par.ring_attention(qd, kd, vd, causal=False), reps=9),
        "ulysses_attention_ms": wall_ms(lambda: par.ulysses_attention(qbd, kbd, vbd, causal=True), reps=9),
    }
    print(f"ring bf16 zig-zag causal {metrics['ring_attention_ms']:.3f} ms, ring f32 "
          f"{metrics['ring_attention_f32_ms']:.3f} ms, ulysses bf16 causal "
          f"{metrics['ulysses_attention_ms']:.3f} ms")
    return launches, metrics


# --------------------------------------------------------------------- #
# linear algebra and Lasso (phase 7)                                    #
# --------------------------------------------------------------------- #
def lasso_target(data: np.ndarray) -> np.ndarray:
    """y as the reference benchmark builds it (bench.py lasso_rate)."""
    return (data @ np.arange(1, F + 1, dtype=np.float32) / F
            + np.random.default_rng(1).normal(size=data.shape[0]).astype(np.float32))


def columns64(data: np.ndarray) -> np.ndarray:
    """Lasso's design matrix in float64, as ``(f + 1, n)`` columns: the
    intercept's row of ones, then the features."""
    cols = np.empty((data.shape[1] + 1, data.shape[0]))
    cols[0], cols[1:] = 1.0, data.T
    return cols


def numpy_cd(data: np.ndarray, y: np.ndarray, lam: float, sweeps: int) -> np.ndarray:
    """The reference's coordinate descent (heat_tpu/regression/lasso.py
    ``_fit_segment``) replayed in float64 with numpy: the intercept column
    first, ``rho_j = mean(x_j (r + x_j theta_j))``, the soft threshold,
    the residual kept incrementally."""
    n, f = data.shape
    cols = columns64(data)
    z = np.maximum(np.einsum("ij,ij->i", cols, cols) / n, 1e-12)
    theta = np.zeros(f + 1)
    for _ in range(sweeps):
        resid = y.astype(np.float64) - cols.T @ theta
        for j in range(f + 1):
            rho = cols[j] @ resid / n + theta[j] * z[j]
            new = (rho if j == 0 else np.sign(rho) * max(abs(rho) - lam, 0.0)) / z[j]
            resid -= cols[j] * (new - theta[j])
            theta[j] = new
    return theta


def numpy_ista(data: np.ndarray, y: np.ndarray, lam: float, steps: int) -> np.ndarray:
    """The reference's exact ISTA (heat_tpu/regression/lasso.py
    ``_gd_segment``) replayed in float64 with numpy on the Gram matrix:
    ``grad = G theta - b`` with ``G = A^T A / n`` and ``b = A^T y / n`` over
    the columns [1, data], the step ``1 / lambda_max(G)`` from an
    eigensolver (not a power iteration), the soft threshold ``step * lam``
    on all but the intercept."""
    n, f = data.shape
    cols = columns64(data)
    g, b = cols @ cols.T / n, cols @ y.astype(np.float64) / n
    step = 1.0 / np.linalg.eigvalsh(g)[-1]
    theta = np.zeros(f + 1)
    for _ in range(steps):
        theta = theta - step * (g @ theta - b)
        theta[1:] = np.sign(theta[1:]) * np.maximum(np.abs(theta[1:]) - step * lam, 0.0)
    return theta


def lasso_loss(data: np.ndarray, y: np.ndarray, theta: np.ndarray, lam: float) -> float:
    """The Lasso objective ``mean(r^2) / 2 + lam |theta_1:|_1``, in float64."""
    r = data.astype(np.float64) @ theta[1:] + theta[0] - y
    return 0.5 * float(np.mean(r * r)) + lam * float(np.abs(theta[1:]).sum())


def phase_linalg_lasso(torch, htt, cq, dev, data, counted):
    """Phase 7: QR/SVD and Lasso through the entry points; returns the
    kernels' launch counts of the compressed gd fit and the metrics."""
    metrics = {}
    m, n, sweeps, steps = QR_M, QR_N, LASSO_SWEEPS, LASSO_STEPS
    # drawn as the reference benchmark draws it (bench.py:2189)
    htt.random.seed(0)
    A = htt.random.randn(m, n, split=0, comm=htt.TorchCommunication([dev])).larray
    A64 = A.double()
    s64 = torch.linalg.svdvals(A64)
    norm_a = float(torch.linalg.norm(A64))
    eye = torch.eye(n, dtype=torch.float64, device=dev)
    for p in (1, POSITIONS):
        comm = htt.TorchCommunication([dev] * p)
        X = htt.array(A, split=0, comm=comm)
        q, r = htt.linalg.qr(X)
        Q, R = q.larray.double(), r.larray.double()
        res = float(torch.linalg.norm(Q @ R - A64)) / norm_a
        orth = float((Q.T @ Q - eye).abs().max())
        check(q.shape == (m, n) and r.shape == (n, n) and q.split == 0, f"qr shapes at {p}")
        check(res <= QR_TOL, f"qr at {p} position(s): ||QR - A|| / ||A|| = {res:.3g} > {QR_TOL}")
        check(orth <= ORTH_TOL, f"qr at {p} position(s): max|Q^T Q - I| = {orth:.3g} > {ORTH_TOL}")
        check(bool((torch.tril(r.larray, -1) == 0).all()), f"qr at {p} position(s): R not upper-triangular")
        u, s, v = htt.linalg.svd(X)
        check(u.shape == (m, n) and u.split == 0 and s.shape == (n,) and v.shape == (n, n),
              f"svd shapes at {p}")
        s_err = float(((s.larray.double() - s64).abs() / s64).max())
        rec = float(torch.linalg.norm((u.larray.double() * s.larray.double()) @ v.larray.double().T - A64)) / norm_a
        check(s_err <= S_RTOL, f"svd at {p} position(s): S {s_err:.3g} from float64 > rtol {S_RTOL}")
        check(rec <= QR_TOL, f"svd at {p} position(s): ||U S V^T - A|| / ||A|| = {rec:.3g} > {QR_TOL}")
        ms = wall_ms(lambda: htt.linalg.svd(X))
        metrics["qr_svd_ms" if p == 1 else f"qr_svd_{p}pos_ms"] = ms
        print(f"qr/svd {m} x {n}, {p} position(s): ||QR - A||/||A|| {res:.3g}, max|Q^T Q - I| {orth:.3g}, "
              f"S rtol {s_err:.3g}, ||USV^T - A||/||A|| {rec:.3g}; svd {ms:.3f} ms")

    Lasso = htt.regression.Lasso
    y = lasso_target(data).astype(np.float32)
    comm1 = htt.TorchCommunication([dev])
    X1, Y1 = htt.array(data, split=0, comm=comm1), htt.array(y, split=0, comm=comm1)
    cd = Lasso(lam=LASSO_LAM, max_iter=sweeps, tol=-1.0).fit(X1, Y1)
    theta = cd.theta.numpy().reshape(-1)
    t0 = time.perf_counter()
    theta64 = numpy_cd(data, y, LASSO_LAM, sweeps)
    replay_s = time.perf_counter() - t0
    cd_err = float(np.abs(theta - theta64).max())
    check(cd.n_iter == sweeps, f"lasso cd ran {cd.n_iter} sweeps, not {sweeps}")
    check(cd_err <= CD_TOL * float(np.abs(theta64).max()),
          f"lasso cd: {cd_err:.3g} from the float64 replay > {CD_TOL} x {np.abs(theta64).max():.3g}")
    cd_ms = wall_ms(lambda: Lasso(lam=LASSO_LAM, max_iter=sweeps, tol=-1.0).fit(X1, Y1), reps=3)
    metrics["lasso_sweeps_per_s"] = sweeps / cd_ms * 1e3
    print(f"lasso cd, 1 position, {sweeps} sweeps: {cd_err:.3g} from the float64 replay "
          f"(max|theta| {np.abs(theta64).max():.4g}; replay {replay_s:.1f} s on the host); "
          f"{metrics['lasso_sweeps_per_s']:.1f} sweeps/s")

    comm4 = htt.TorchCommunication([dev] * POSITIONS)
    X4, Y4 = htt.array(data, split=0, comm=comm4), htt.array(y, split=0, comm=comm4)

    def gd():
        return Lasso(lam=LASSO_LAM, max_iter=steps, tol=-1.0, solver="gd").fit(X4, Y4)

    exact = gd()
    theta_gd = exact.theta.numpy().reshape(-1).astype(np.float64)
    t0 = time.perf_counter()
    ista64 = numpy_ista(data, y, LASSO_LAM, steps)
    replay_s = time.perf_counter() - t0
    gd_err = float(np.abs(theta_gd - ista64).max())
    check(gd_err <= GD_TOL * float(np.abs(ista64).max()),
          f"lasso gd: {gd_err:.3g} from the float64 replay > {GD_TOL} x {np.abs(ista64).max():.3g}")
    with cq.collective_precision("int8_block"):
        for fn in counted:
            fn.launches = 0
        comp = gd()
        torch.cuda.synchronize()
        launches = {f"blockquant_{fn.__name__.removesuffix('_blocks')}": fn.launches for fn in counted}
        gd_q_ms = wall_ms(gd, reps=3)
    gd_ms = wall_ms(gd, reps=3)
    le = lasso_loss(data, y, theta_gd, LASSO_LAM)
    lq = lasso_loss(data, y, comp.theta.numpy().reshape(-1).astype(np.float64), LASSO_LAM)
    l0 = lasso_loss(data, y, np.zeros(F + 1), LASSO_LAM)
    check(exact.n_iter == comp.n_iter == steps, f"lasso gd ran {exact.n_iter} / {comp.n_iter} steps")
    check(np.isfinite(le) and le < l0, f"lasso gd: exact loss {le} not under the start's {l0}")
    check(abs(lq - le) <= LOSS_RTOL * le, f"lasso gd int8: loss {lq} not within {LOSS_RTOL} of exact {le}")
    # each ISTA step: the EF encode and the ring's first encode, the EF
    # residual, POSITIONS - 1 reduce-scatter hops and the gather's decode
    expected = {"blockquant_quantize": 2 * steps, "blockquant_dequantize": steps,
                "blockquant_dequantize_fma": steps,
                "blockquant_dequantize_add_quantize": (POSITIONS - 1) * steps}
    check(launches == expected, f"lasso gd int8 launches {launches} != {expected}")
    metrics["lasso_gd_iter_per_s"] = steps / gd_ms * 1e3
    metrics["lasso_gd_int8_4pos_iter_per_s"] = steps / gd_q_ms * 1e3
    print(f"lasso gd, {POSITIONS} positions, {steps} steps: exact {gd_err:.3g} from the float64 replay "
          f"(max|theta| {np.abs(ista64).max():.4g}, its loss {lasso_loss(data, y, ista64, LASSO_LAM):.7g}; "
          f"replay {replay_s:.1f} s on the host), loss exact "
          f"{le:.7g}, int8_block {lq:.7g} (rel {abs(lq - le) / le:.3g}, start {l0:.4g}); launches {launches}; exact "
          f"{metrics['lasso_gd_iter_per_s']:.1f} iter/s, int8_block "
          f"{metrics['lasso_gd_int8_4pos_iter_per_s']:.1f} iter/s")
    return launches, metrics


# --------------------------------------------------------------------- #
# the RNG and the estimators that draw from it (phase 8)                  #
# --------------------------------------------------------------------- #
def label_share(labels: np.ndarray, truth: np.ndarray, k: int) -> float:
    """The share of rows whose label maps to their true label under the
    best one-to-one relabelling."""
    from scipy.optimize import linear_sum_assignment

    counts = np.zeros((k, k))
    np.add.at(counts, (labels, truth), 1)
    rows, cols = linear_sum_assignment(-counts)
    return float(counts[rows, cols].sum() / len(labels))


def ulps_from(a: np.ndarray, b: np.ndarray) -> float:
    """Largest distance of ``a`` from ``b`` in ulps of ``b``'s dtype, the ulp
    taken at each element of ``b``."""
    return float((np.abs(a.astype(np.float64) - b) / np.spacing(np.abs(b))).max())


def kpp_check(data64: np.ndarray, picks, us: np.ndarray, margin: float = KPP_GAP):
    """Hold k-means++ picks (row indices, the first one given) to a float64
    replay of the d^2 CDF from the same picks: pick i must be the row in
    whose CDF interval ``us[i] * total`` falls (left side), or, where that
    draw lies within ``margin`` of the total from a CDF step (where two
    float32 cumsums may round apart), a row whose interval reaches within
    that margin of it.  Returns the number of such draws near a step and
    the smallest distance of a draw from a step, as a share of the total."""
    dmin, near, gmin = np.full(len(data64), np.inf), 0, np.inf
    for i in range(1, len(picks)):
        dmin = np.minimum(dmin, ((data64 - data64[picks[i - 1]]) ** 2).sum(1))
        cdf = np.cumsum(dmin)
        total = cdf[-1]
        draw = float(us[i]) * total
        j = min(int(np.searchsorted(cdf, draw)), len(cdf) - 1)
        gap = float(np.abs(cdf[max(j - 1, 0):j + 1] - draw).min() / total)
        gmin = min(gmin, gap)
        if int(picks[i]) != j:
            lo = cdf[picks[i] - 1] if picks[i] else 0.0
            check(gap <= margin and lo - margin * total <= draw <= cdf[picks[i]] + margin * total,
                  f"k-means++ draw {i} picked row {picks[i]}, the float64 CDF row {j} "
                  f"(the draw {gap:.3g} of the total from a step)")
            near += 1
    return near, gmin


def rows_of(data: np.ndarray, centers: np.ndarray) -> list:
    """The index of each center among the rows of ``data`` (raises when a
    center is not a row)."""
    idx = []
    for c in centers:
        hit = np.flatnonzero((data == c).all(1))
        check(len(hit) == 1, f"a center is not a row of the data ({len(hit)} matches)")
        idx.append(int(hit[0]))
    return idx


def nb_log_likelihood(x64: np.ndarray, theta, sigma, prior) -> np.ndarray:
    """GaussianNB's joint log-likelihood in float64 numpy."""
    n_ij = -0.5 * np.log(2.0 * np.pi * sigma).sum(1)
    ll = np.stack([n_ij[c] - 0.5 * (((x64 - theta[c]) ** 2) / sigma[c]).sum(1) for c in range(len(theta))], 1)
    return np.log(np.maximum(prior, 1e-300))[None, :] + ll


def knn_replay(train: np.ndarray, labels: np.ndarray, query: np.ndarray, k: int, classes: int):
    """KNN in float64 numpy: the k nearest training rows of each query
    (argsort of the distances), their vote, the lowest class of most votes;
    and the rows where the k-th and (k+1)-th distances tie within float32
    rounding of the quadratic expansion (where either neighbour may win)."""
    t64, q64 = train.astype(np.float64), query.astype(np.float64)
    t2 = (t64 * t64).sum(1)
    pred, tie = np.empty(len(q64), np.int64), np.zeros(len(q64), bool)
    for lo in range(0, len(q64), 1000):
        q = q64[lo:lo + 1000]
        q2 = (q * q).sum(1)[:, None]
        d2 = q2 + t2[None, :] - 2.0 * q @ t64.T
        part = np.argpartition(d2, k, axis=1)[:, :k + 1]
        order = np.take_along_axis(d2, part, 1).argsort(1)
        near = np.take_along_axis(part, order, 1)
        dk = np.take_along_axis(d2, near, 1)
        tol = 64 * np.finfo(np.float32).eps * (q2[:, 0] + t2[near[:, k]])
        tie[lo:lo + 1000] = dk[:, k] - dk[:, k - 1] <= tol
        votes = np.stack([(labels[near[:, :k]] == c).sum(1) for c in range(classes)], 1)
        pred[lo:lo + 1000] = votes.argmax(1)
    return pred, tie


def knn_unfused(torch, knn, Q):
    """KNN's predict before it was fused (eager ops) and before it took
    the reference's tie order (``torch.topk`` of the float distances)."""
    from heat_tpu_torch.spatial.distance import quadratic_d2

    d2 = quadratic_d2(Q.larray, knn.x.larray)
    idx = torch.topk(d2, knn.num_neighbours, dim=1, largest=False).indices
    return torch.argmax(torch.sum(knn.y.larray.to(torch.float32)[idx], dim=1), dim=1)


def phase_rng(torch, htt, dev):
    """Phase 8, first part: the draws on the card at 1 and POSITIONS
    positions against the port's CPU draws of the same seed and counter,
    and the counter advancing by the elements drawn.  Returns the metrics."""
    import math

    cpu = htt.TorchCommunication(["cpu"])
    got = {}
    for p in (1, POSITIONS):
        comm = htt.TorchCommunication([dev] * p)
        htt.random.seed(0)
        counter = 0
        for fn, args in RNG_DRAWS:
            out = getattr(htt.random, fn)(*args, split=0, comm=comm)
            counter += math.prod(args[2] if fn == "randint" else args)
            check(htt.random.get_state() == ("Threefry", 0, counter, 0, 0.0),
                  f"{fn} at {p} position(s): state {htt.random.get_state()}, counter {counter} expected")
            check(out.larray.device.type == "cuda", f"{fn} drew off the card")
            got[p, fn] = out.larray
    htt.random.seed(0)
    for fn, args in RNG_DRAWS:
        want = getattr(htt.random, fn)(*args, split=0, comm=cpu).larray
        card, card4 = got[1, fn], got[POSITIONS, fn]
        check(bitwise_equal(card, card4), f"{fn}: 1 and {POSITIONS} positions differ on the card")
        if fn == "randn":
            u = ulps_from(card.cpu().numpy(), want.numpy())
            check(u <= RANDN_ULPS, f"randn: {u} ulps from the CPU draw > {RANDN_ULPS}")
            same = float((card.cpu() == want).double().mean())
            print(f"randn {tuple(args)}: {u:.0f} ulps at most from the CPU draw ({same:.4f} bitwise equal)")
        else:
            check(bitwise_equal(card.cpu(), want), f"{fn} on the card != the CPU draw")
            print(f"{fn} {tuple(args)}: bitwise equal to the CPU draw, at 1 and {POSITIONS} positions")
    perm = got[1, "randperm"].cpu().numpy()
    check(bool((np.sort(perm) == np.arange(N)).all()), "randperm is not a permutation")

    comm1 = htt.TorchCommunication([dev])
    randn_ms = device_ms(lambda: htt.random.randn(QR_M, QR_N, split=0, comm=comm1), [()])
    metrics = {
        "rng_randn_gb_per_s": QR_M * QR_N * 4 / randn_ms / 1e6,
        "rng_randn_wall_ms": wall_ms(lambda: htt.random.randn(QR_M, QR_N, split=0, comm=comm1)),
        "randperm_500k_ms": wall_ms(lambda: htt.random.randperm(N, comm=comm1)),
        "randperm_500k_device_ms": device_ms(lambda: htt.random.randperm(N, comm=comm1), [()]),
    }
    print(f"randn {QR_M} x {QR_N}: {randn_ms:.3f} ms of device time, "
          f"{metrics['rng_randn_gb_per_s']:.1f} GB/s written; randperm({N}): "
          f"{metrics['randperm_500k_ms']:.3f} ms wall, {metrics['randperm_500k_device_ms']:.3f} ms device")
    return metrics


def phase_kclusterers(torch, htt, dev, data, centers):
    """Phase 8, second part: KMeans with its string inits, KMedians and
    KMedoids on the blobs at one position.  Returns the metrics."""
    from heat_tpu_torch.cluster.kmeans import _assign

    comm1, cpu = htt.TorchCommunication([dev]), htt.TorchCommunication(["cpu"])
    X = htt.array(data, split=0, comm=comm1)
    arr = X.larray
    d64 = data.astype(np.float64)
    metrics = {}
    state = ("Threefry", 7, 0, 0, 0.0)

    # KMeans with its defaults: init="random" (k rows at randperm's first k
    # places), then k-means++.  Each step of the fit is held to a float64
    # numpy Lloyd step from the same centers: the labels equal off float32
    # ties, the new centers the means of the port's labels.  (A whole
    # float32 trajectory is not comparable after a blob is split between
    # two centers: its tie flips drift, 0.023 between torch on the CPU and
    # numpy after the 109 steps of the random init's fit.)
    x2 = (d64 * d64).sum(1)
    for init, key in (("random", "kmeans_random_init_ms"), ("probability_based", "kmeanspp_init_ms")):
        htt.random.set_state(state)
        km = htt.cluster.KMeans(n_clusters=K, init=init)
        km._initialize_cluster_centers(X)
        init_c = km.cluster_centers_.larray
        htt.random.set_state(state)
        rows = rows_of(data, init_c.cpu().numpy())
        if init == "random":
            check(rows == htt.random.randperm(N, comm=cpu).larray[:K].tolist(),
                  f"KMeans init=random: rows {rows}, not the CPU draw's")
            drawn = ""
        else:
            first = int(htt.random.randint(0, N, (1,), comm=cpu).larray[0])
            us = htt.random.rand(K, comm=cpu).larray.numpy()
            check(rows[0] == first, f"k-means++ first row {rows[0]}, not the CPU draw's {first}")
            near, gmin = kpp_check(d64, rows, us)
            drawn = (f" ({near} picks off the float64 CDF's row, each by a draw within {KPP_GAP} "
                     f"of a step; the closest draw {gmin:.3g} of the total from a step)")
        htt.random.set_state(state)
        fitted = htt.cluster.KMeans(n_clusters=K, init=init).fit(X)
        carry, tol, flips, c_err = (0, init_c, float("inf")), float(np.float32(km.tol)), 0, 0.0
        while carry[0] < km.max_iter and carry[2] > tol:
            lab = _assign(arr, carry[1]).cpu().numpy()
            c64 = carry[1].double().cpu().numpy()
            # d^2 less the row's |x|^2, which moves neither argmin nor gaps
            d2 = d64 @ (-2.0 * c64.T)
            d2 += (c64 * c64).sum(1)
            best = d2.argmin(1)
            first = d2[np.arange(N), best]
            d2[np.arange(N), best] = np.inf
            ties = d2.min(1) - first <= 64 * np.finfo(np.float32).eps * (x2 + (c64 * c64).sum(1).max())
            off = lab != best
            check(not bool((off & ~ties).any()), f"KMeans init={init} step {carry[0]}: labels off ties")
            flips += int(off.sum())
            carry = htt.cluster.KMeans._fit_segment(arr, tol, carry[0] + 1, carry)
            counts = np.bincount(lab, minlength=K)[:, None]
            sums = np.eye(K)[lab].T @ d64
            means = np.where(counts > 0, sums / np.maximum(counts, 1), c64)
            got = carry[1].cpu().numpy()
            check(np.allclose(got, means, rtol=1e-5, atol=1e-4), f"KMeans init={init} step {carry[0]}: centers")
            c_err = max(c_err, float(np.abs(got - means).max()))
        check(carry[0] == fitted.n_iter_ and bitwise_equal(carry[1], fitted.cluster_centers_.larray),
              f"KMeans init={init}: the fit != its steps")

        def init_once(init=init):
            htt.random.set_state(state)
            htt.cluster.KMeans(n_clusters=K, init=init)._initialize_cluster_centers(X)

        metrics[key] = wall_ms(init_once)
        print(f"KMeans init={init}: rows {rows}{drawn}, {fitted.n_iter_} steps, each held to float64 numpy ({flips} labels on float32 ties, "
              f"centers within {c_err:.3g}); init {metrics[key]:.3f} ms")

    # KMedians: the benchmark's init (the generating centers), exactly
    # MED_STEPS steps, against numpy's median of each cluster's rows under
    # the port's own labels, step by step
    init = htt.array(centers, comm=comm1)
    med = htt.cluster.KMedians(n_clusters=K, init=init, max_iter=MED_STEPS, tol=-1.0).fit(X)
    check(med.n_iter_ == MED_STEPS, f"KMedians ran {med.n_iter_} steps")
    c, made_by = centers.copy(), None
    for _ in range(MED_STEPS):
        lab = _assign(arr, torch.from_numpy(c).to(dev)).cpu().numpy()
        if made_by is not None and np.array_equal(lab, made_by):
            continue  # the labels that made c: the same medians again
        c = np.stack([np.median(data[lab == j], axis=0) if (lab == j).any() else c[j]
                      for j in range(K)]).astype(np.float32)
        made_by = lab
    check(bool((med.cluster_centers_.numpy() == c).all()), "KMedians centers != numpy's medians, bitwise")
    med_ms = wall_ms(lambda: htt.cluster.KMedians(n_clusters=K, init=init, max_iter=MED_STEPS, tol=-1.0).fit(X),
                     reps=3)
    metrics["kmedians_iter_per_s"] = MED_STEPS / med_ms * 1e3

    # KMedoids: MED_STEPS assign-and-snap steps from the same init, each
    # held to numpy: the mean of each cluster's rows (float64) snapped to
    # its nearest member (float64 distances); a member whose distance ties
    # the nearest within float32 rounding may win instead
    KMedoids = htt.cluster.KMedoids
    c_t = torch.from_numpy(centers).to(dev)
    ties, held = 0, None
    for _ in range(MED_STEPS):
        lab = _assign(arr, c_t).cpu().numpy()
        nxt = KMedoids._step_loop(arr, c_t, 1)
        got = nxt.cpu().numpy()
        if held is not None and bitwise_equal(held, c_t) and bitwise_equal(nxt, c_t):
            continue  # a fixed point, its step already held to numpy
        held = c_t
        for j in range(K):
            rows = np.flatnonzero(lab == j)
            if not len(rows):
                check(bool((got[j] == c_t[j].cpu().numpy()).all()), "KMedoids moved an empty cluster")
                continue
            mean = d64[rows].mean(0)
            dist = ((d64[rows] - mean) ** 2).sum(1)
            best = rows[int(dist.argmin())]
            if not (got[j] == data[best]).all():
                pick = np.flatnonzero((data[rows] == got[j]).all(1))
                tol = 64 * np.finfo(np.float32).eps * float((mean * mean).sum() + (d64[best] ** 2).sum())
                check(len(pick) == 1 and dist[pick[0]] - dist.min() <= tol,
                      f"KMedoids center {j} is not its cluster's medoid (or a tie of it)")
                ties += 1
        c_t = nxt
    fit = KMedoids(n_clusters=K, init=init, max_iter=MED_STEPS).fit(X)
    check(bitwise_equal(fit.cluster_centers_.larray, KMedoids._step_loop(arr, init.larray, fit.n_iter_)),
          "KMedoids.fit != its steps")
    check(all((data == row).all(1).any() for row in fit.cluster_centers_.numpy()),
          "KMedoids centers are not data rows")
    medoid_ms = wall_ms(lambda: KMedoids._step_loop(arr, init.larray, MED_STEPS), reps=3)
    metrics["kmedoids_iter_per_s"] = MED_STEPS / medoid_ms * 1e3

    # the "++" inits through the RNG: the initial centers are the float64
    # replay's rows, the fits run
    for cls, alias in ((htt.cluster.KMedians, "kmedians++"), (KMedoids, "probability_based")):
        htt.random.set_state(state)
        first = int(htt.random.randint(0, N, (1,), comm=cpu).larray[0])
        us = htt.random.rand(K, comm=cpu).larray.numpy()
        htt.random.set_state(state)
        est = cls(n_clusters=K, init=alias, max_iter=MED_STEPS)
        est._initialize_cluster_centers(X)
        rows = rows_of(data, est.cluster_centers_.numpy())
        check(rows[0] == first, f"{cls.__name__} {alias}: first row {rows[0]}, not the CPU draw's {first}")
        kpp_check(d64, rows, us)
        est.fit(X)
        check(bool(np.isfinite(est.cluster_centers_.numpy()).all()), f"{cls.__name__} {alias}: fit")
    print(f"KMedians {MED_STEPS} steps bitwise equal to numpy's medians, "
          f"{metrics['kmedians_iter_per_s']:.1f} iter/s; KMedoids {MED_STEPS} steps held to numpy "
          f"({ties} float32 ties), fit converged in {fit.n_iter_} steps, "
          f"{metrics['kmedoids_iter_per_s']:.1f} iter/s")
    return metrics


def phase_spectral_nb_knn(torch, htt, cq, dev, data, counted):
    """Phase 8, third part: Spectral on SUB rows, GaussianNB exact and
    under int8_block at POSITIONS positions (the kernels' launches of its
    fit), KNN.  Returns the launch counts and the metrics."""
    comm1, comm4 = htt.TorchCommunication([dev]), htt.TorchCommunication([dev] * POSITIONS)
    truth = np.repeat(np.arange(K), N // K)
    metrics = {}

    # Spectral: the Lanczos basis and T, the Ritz pairs, the labels
    sub, t_sub = data[::N // SUB], truth[::N // SUB]
    Xs = htt.array(sub, split=0, comm=comm1)
    sp = htt.cluster.Spectral(n_clusters=K, gamma=SPECTRAL_GAMMA, metric="rbf", n_lanczos=SPECTRAL_M)
    L = sp._laplacian.construct(Xs)
    v0 = htt.full((SUB,), 1.0 / np.sqrt(SUB), dtype=htt.float32, comm=comm1)
    t0 = time.perf_counter()
    V, T = htt.linalg.lanczos(L, SPECTRAL_M, v0=v0)
    torch.cuda.synchronize()
    metrics["lanczos_ms"] = (time.perf_counter() - t0) * 1e3
    Vd, Td, Ld = V.larray.double(), T.larray.double(), L.larray
    eye = torch.eye(SPECTRAL_M, dtype=torch.float64, device=dev)
    orth = float((Vd.T @ Vd - eye).abs().max())
    LV = (Ld @ V.larray).double()
    tri = float(torch.linalg.norm(Vd.T @ LV - Td) / torch.linalg.norm(Td))
    theta, Y = torch.linalg.eigh(Td)
    U = Vd @ Y[:, :K]
    ritz = float(torch.linalg.vector_norm((LV @ Y[:, :K]) - U * theta[:K], dim=0).max())
    check(orth <= ORTH_TOL, f"lanczos: max|V^T V - I| = {orth:.3g} > {ORTH_TOL}")
    check(tri <= 1e-4, f"lanczos: ||V^T L V - T|| / ||T|| = {tri:.3g} > 1e-4")
    check(ritz <= RITZ_TOL, f"lanczos: Ritz residual {ritz:.3g} > {RITZ_TOL}")
    # device time of the 300 steps (busy 0.93 in the profile), one call a graph
    metrics["lanczos_device_ms"] = device_ms(lambda: htt.linalg.lanczos(L, SPECTRAL_M, v0=v0), [()],
                                             per_graph=1, trials=3)
    del L, LV, Ld
    t0 = time.perf_counter()
    sp.fit(Xs)
    torch.cuda.synchronize()
    metrics["spectral_fit_ms"] = (time.perf_counter() - t0) * 1e3
    share = label_share(sp.labels_.numpy(), t_sub, K)
    check(share >= SPECTRAL_SHARE, f"Spectral recovers {share} of the blob labels < {SPECTRAL_SHARE}")
    print(f"Spectral {SUB} rows: max|V^T V - I| {orth:.3g}, ||V^T L V - T||/||T|| {tri:.3g}, Ritz residual "
          f"{ritz:.3g} (theta {theta[:K].cpu().numpy().round(5).tolist()}), label share {share}; lanczos "
          f"{metrics['lanczos_ms']:.1f} ms ({metrics['lanczos_device_ms']:.1f} ms of device time), fit "
          f"{metrics['spectral_fit_ms']:.1f} ms")

    # GaussianNB on the blobs, labels their blob index
    d64 = data.astype(np.float64)
    nb = htt.naive_bayes.GaussianNB
    X1, y1 = htt.array(data, split=0, comm=comm1), htt.array(truth, split=0, comm=comm1)
    exact = nb().fit(X1, y1)
    theta64 = np.stack([d64[truth == c].mean(0) for c in range(K)])
    var64 = np.stack([d64[truth == c].var(0) for c in range(K)]) + 1e-9 * d64.var(0).max()
    for name, got, want in (("theta_", exact.theta_, theta64), ("sigma_", exact.sigma_, var64)):
        rel = float((np.abs(got - want) / np.abs(want)).max())
        check(rel <= 1e-10, f"GaussianNB {name}: {rel:.3g} relative from float64 numpy > 1e-10")
    pred = exact.predict(X1).numpy()
    want_pred = nb_log_likelihood(d64, exact.theta_, exact.sigma_, exact.class_prior_).argmax(1)
    check(bool((pred == want_pred).all()), "GaussianNB predict != numpy's argmax of the log-likelihood")
    metrics["gaussian_nb_fit_ms"] = wall_ms(lambda: nb().fit(X1, y1), reps=3)

    X4, y4 = htt.array(data, split=0, comm=comm4), htt.array(truth, split=0, comm=comm4)
    with cq.collective_precision("int8_block"):
        for fn in counted:
            fn.launches = 0
        comp = nb().fit(X4, y4)
        torch.cuda.synchronize()
        launches = {f"blockquant_{fn.__name__.removesuffix('_blocks')}": fn.launches for fn in counted}
        metrics["gaussian_nb_int8_4pos_fit_ms"] = wall_ms(lambda: nb().fit(X4, y4), reps=3)
    # one ring_allreduce_q of the (4, k, f) ssd partials: its first encode,
    # POSITIONS - 1 reduce-scatter hops and the gather's decode
    expected = {"blockquant_quantize": 1, "blockquant_dequantize": 1, "blockquant_dequantize_fma": 0,
                "blockquant_dequantize_add_quantize": POSITIONS - 1}
    check(launches == expected, f"GaussianNB int8 launches {launches} != {expected}")
    blocks, lab4 = d64.reshape(POSITIONS, -1, F), truth.reshape(POSITIONS, -1)
    parts = np.stack([np.stack([((blocks[i][lab4[i] == c] - theta64[c]) ** 2).sum(0) for c in range(K)])
                      for i in range(POSITIONS)])
    bound = (POSITIONS + 1) * float(np.abs(parts).reshape(POSITIONS, -1).max(1).sum()) / 254.0 / (N // K)
    s_err = float(np.abs(comp.sigma_ - exact.sigma_).max())
    check(s_err <= bound, f"GaussianNB int8: sigma_ {s_err:.3g} from exact > the ring bound {bound:.3g}")
    # the compressed fit's means come from float32 sums (combined exactly):
    # within float32's summation bound n eps sum|x| / count of the exact ones
    t_err = np.abs(comp.theta_ - exact.theta_)
    t_bound = (N // POSITIONS) * float(np.finfo(np.float32).eps) * np.stack(
        [np.abs(d64[truth == c]).sum(0) for c in range(K)]) / (N // K)
    check(bool((t_err <= t_bound).all()), f"GaussianNB int8: theta_ {t_err.max():.3g} from exact, "
          f"past float32's summation bound {t_bound.min():.3g}")
    print(f"GaussianNB: exact within 1e-10 of float64 numpy, predict == numpy on all {N} rows; int8_block "
          f"at {POSITIONS} positions: sigma_ {s_err:.3g} from exact (bound {bound:.3g}), theta_ "
          f"{t_err.max():.3g} (float32 sums), launches {launches}; "
          f"fit {metrics['gaussian_nb_fit_ms']:.1f} ms, int8 {metrics['gaussian_nb_int8_4pos_fit_ms']:.1f} ms")

    # KNN: train on SUB rows, predict SUB others
    train, query = data[::N // SUB], data[1::N // SUB]
    knn = htt.classification.KNN(htt.array(train, split=0, comm=comm1),
                                 htt.array(t_sub, split=0, comm=comm1), KNN_K)
    Q = htt.array(query, split=0, comm=comm1)
    got = knn.predict(Q).numpy()
    want, tie = knn_replay(train, t_sub, query, KNN_K, K)
    off = got != want
    check(not bool((off & ~tie).any()), f"KNN: {int((off & ~tie).sum())} labels differ from numpy off ties")
    metrics["knn_predict_ms"] = wall_ms(lambda: knn.predict(Q))
    metrics["knn_predict_device_ms"] = device_ms(lambda: knn.predict(Q), [()], per_graph=4, trials=5)
    # the predict as it ran before it was fused and took the reference's
    # tie order: eager ops, torch.topk over the float distances
    metrics["knn_predict_before_ms"] = wall_ms(lambda: knn_unfused(torch, knn, Q))
    print(f"KNN {SUB} x {SUB}, k={KNN_K}: labels equal numpy's on every row but {int(off.sum())} "
          f"({int(tie.sum())} rows with a distance tie at the k-th neighbour); predict "
          f"{metrics['knn_predict_ms']:.2f} ms ({metrics['knn_predict_device_ms']:.2f} ms of device time), "
          f"the unfused float topk of before {metrics['knn_predict_before_ms']:.2f} ms")
    # the 20 000-square program's graph pool holds its temporaries
    htt.fuse.clear_cache()

    # an int64 2048^3 product (exact in float64: |a|, |b| < 1000)
    rng = np.random.default_rng(3)
    a, b = (torch.from_numpy(rng.integers(-1000, 1000, size=(2048, 2048))).to(dev) for _ in range(2))
    A, B = htt.array(a, split=0, comm=comm1), htt.array(b, comm=comm1)
    prod = (A @ B).larray
    check(bool(torch.equal(prod, (a.double() @ b.double()).to(torch.int64))), "int64 matmul != exact product")
    metrics["int_matmul_2048_ms"] = wall_ms(lambda: A @ B, reps=3)
    metrics["int_matmul_2048_device_ms"] = device_ms(lambda: A @ B, [()], per_graph=1, trials=3)
    print(f"int64 2048^3 matmul: exact, {metrics['int_matmul_2048_ms']:.1f} ms "
          f"({metrics['int_matmul_2048_device_ms']:.1f} ms of device time)")
    return launches, metrics


# --------------------------------------------------------------------- #
# the array API's foundation (phase 9)                                    #
# --------------------------------------------------------------------- #
def gamma(k):
    """Higham's gamma_k = k u / (1 - k u) for float32 (u = 2^-24): the
    bound on the relative error of any sum or product of k + 1 terms."""
    k = np.asarray(k, dtype=np.float64)
    return k * U32 / (1.0 - k * U32)


def profiled_ms(torch, fn) -> float:
    """Device time of one call of ``fn``: the device-side events of a
    ``torch.profiler`` trace, summed (the aten ops that launched them
    report the same time again and are left out)."""
    return _profiled(torch, fn)[0]


def profile_counts(torch, fn):
    """``(device ms, host synchronize calls)`` of one call of ``fn`` from a
    ``torch.profiler`` trace, less the synchronize events of the trace's
    own trailing fence (those an empty call shows)."""
    ms, syncs = _profiled(torch, fn)
    return ms, syncs - _profiled(torch, lambda: None)[1]


def _profiled(torch, fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total, syncs = 0.0, 0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            if "Synchronize" in evt.key:
                syncs += int(evt.count)
            continue
        if evt.key.startswith("Activity Buffer"):
            continue
        us = getattr(evt, "self_device_time_total", None)
        total += float(us if us is not None else getattr(evt, "self_cuda_time_total", 0.0))
    return total / 1e3, syncs


def timed(torch, metrics: dict, key: str, fn):
    """Record ``fn``'s wall time (median of 3, synchronised) and the
    device time of one call under ``key``, print both, return ``fn()``."""
    out = fn()
    metrics[f"{key}_ms"] = wall_ms(fn, reps=3)
    metrics[f"{key}_device_ms"] = profiled_ms(torch, fn)
    print(f"  {key}: {metrics[f'{key}_ms']:.3f} ms wall, {metrics[f'{key}_device_ms']:.3f} ms of device time")
    return out


def exact(got, want, what: str) -> None:
    got, want = np.asarray(got), np.asarray(want)
    ok = got.shape == want.shape and got.dtype == want.dtype
    if ok and got.dtype.kind == "f":  # bitwise, any NaN matching any NaN
        nan = np.isnan(got)
        ok = bool((nan == np.isnan(want)).all()) and bool(
            (got.view(f"i{got.itemsize}") == want.view(f"i{want.itemsize}"))[~nan].all())
    elif ok:
        ok = bool((got == want).all())
    check(ok, f"{what}: not bitwise numpy's ({got.shape} {got.dtype} vs {want.shape} {want.dtype})")


def phase_array_api(torch, htt, cq, dev, data, counted):
    """Phase 9: the array API's foundation on the blobs at 1 and
    POSITIONS positions: cumsum/cumprod along the split held to float64
    numpy under gamma_k bounds, scans over the positions, permute, bcast,
    scatter, gather and reduce exact and (at POSITIONS) gather/reduce on
    the int8 ring with exact launch counts, where/nonzero, setitem across
    position boundaries, diff, halos, factories and the printed string
    against the port's CPU, division by zero and shifts against numpy.
    Returns the int8 launches and the metrics."""
    metrics = {}
    d64 = data.astype(np.float64)
    rows = np.arange(1, N + 1, dtype=np.float64)[:, None]
    launches = None
    for p in (1, POSITIONS):
        comm, cpu = htt.TorchCommunication([dev] * p), htt.TorchCommunication(["cpu"] * p)
        print(f"phase 9 at {p} position(s):")
        X = htt.array(data, split=0, comm=comm)
        tag = f"p{p}"

        # cumulative ops along the split axis: any order of k terms is
        # within gamma_k of the exact prefix (float64 numpy's, whose own
        # error is below k 2^-53)
        cs = timed(torch, metrics, f"{tag}_cumsum", lambda: htt.cumsum(X, 0))
        err = np.abs(cs.numpy().astype(np.float64) - np.cumsum(d64, 0))
        bound = (gamma(rows) + rows * 2.0 ** -52) * np.cumsum(np.abs(d64), 0)
        check(bool((err <= bound).all()), f"cumsum at {p}: outside gamma_k * sum|x|")
        metrics[f"{tag}_cumsum_err_share_of_bound"] = float((err / np.maximum(bound, 1e-300)).max())
        # factors in [0.999, 1.001] whose running product stays near 1
        # (a random walk of 1e-3 steps): the blobs' own drift would
        # overflow float32 over 500 000 rows
        bounded = (1.0 + np.float32(1e-3) * np.sin(np.float32(100.0) * data)).astype(np.float32)
        B = htt.array(bounded, split=0, comm=comm)
        cp = timed(torch, metrics, f"{tag}_cumprod", lambda: htt.cumprod(B, 0))
        want = np.cumprod(bounded.astype(np.float64), 0)
        err = np.abs(cp.numpy().astype(np.float64) - want)
        check(bool((err <= (gamma(rows) + rows * 2.0 ** -52) * np.abs(want)).all()),
              f"cumprod at {p}: outside gamma_k * |prod|")
        del cs, cp, B, err, bound, want

        # scans and reductions over the positions, exact
        blocks = comm.blocks(X._buffer, 0)
        parts = {"max": blocks.amax(dim=1), "min": blocks.amin(dim=1), "sum": (blocks > 0).sum(dim=1)}
        accumulate = {"max": np.maximum.accumulate, "min": np.minimum.accumulate, "sum": np.cumsum}
        ident = {"max": np.finfo(np.float32).min, "min": np.finfo(np.float32).max, "sum": 0}
        for op, part in parts.items():
            host = part.cpu().numpy()
            inc = accumulate[op](host, axis=0).astype(host.dtype)
            exact(comm.scan(part, op).cpu().numpy(), inc, f"scan {op} at {p}")
            exc = np.concatenate([np.full_like(inc[:1], ident[op]), inc[:-1]])
            exact(comm.exscan(part, op).cpu().numpy(), exc, f"exscan {op} at {p}")
            exact(comm.reduce(part, op).cpu().numpy(), inc[-1], f"reduce {op} at {p}")
        timed(torch, metrics, f"{tag}_exscan_sum", lambda: comm.exscan(parts["sum"], "sum"))

        # point-to-point and rooted collectives, exact
        perm = [(i, p - 1 - i) for i in range(p)]
        got = timed(torch, metrics, f"{tag}_permute", lambda: comm.permute(X._buffer, perm))
        exact(got.cpu().numpy(), data.reshape(p, -1, F)[::-1].reshape(N, F), f"permute at {p}")
        root = p - 1
        _, _, sl = comm.chunk((N, F), 0, rank=root)
        got = timed(torch, metrics, f"{tag}_bcast", lambda: comm.bcast(X.larray, root=root, split=0))
        exact(got.cpu().numpy(), data[sl], f"bcast at {p}")
        got = comm.gather(comm.scatter(X.larray, axis=0), axis=0)
        exact(got.cpu().numpy(), data, f"scatter + gather at {p}")
        del got

        if p == POSITIONS:
            rng = np.random.default_rng(1)
            stacked = torch.from_numpy(rng.normal(size=(POSITIONS, PAYLOAD)).astype(np.float32)).to(dev)
            with cq.collective_precision("int8_block"):
                for fn in counted:
                    fn.launches = 0
                g8 = comm.gather(X.larray, axis=0)
                r8 = comm.reduce(stacked, "sum")
                torch.cuda.synchronize()
                launches = {f"blockquant_{fn.__name__.removesuffix('_blocks')}": fn.launches for fn in counted}
                timed(torch, metrics, "p4_gather_int8", lambda: comm.gather(X.larray, axis=0))
                timed(torch, metrics, "p4_reduce_int8", lambda: comm.reduce(stacked, "sum"))
            # one quantize + one dequantize for the gather; the reduce's
            # ring: one quantize, POSITIONS - 1 hops, one dequantize
            expected = {"blockquant_quantize": 2, "blockquant_dequantize": 2,
                        "blockquant_dequantize_fma": 0, "blockquant_dequantize_add_quantize": POSITIONS - 1}
            check(launches == expected, f"phase 9 int8 launches {launches} != {expected}")
            # the gather's B1 and B2 at the shape it gives them (N * F / BLOCK
            # rows), bitwise against their plain versions, and the gathered
            # values bitwise the plain round trip
            payload = X.larray.reshape(-1)
            q, s = cq.quantize_blocks(payload)
            q_plain, s_plain = cq.quantize_blocks_plain(payload.reshape(-1, BLOCK))
            check(bitwise_equal(q, q_plain) and bitwise_equal(s, s_plain),
                  f"phase 9 quantize_blocks at {tuple(q.shape)} != quantize_blocks_plain, bitwise")
            deq = cq.dequantize_blocks(q, s)
            check(bitwise_equal(deq, cq.dequantize_blocks_plain(q, s)),
                  f"phase 9 dequantize_blocks at {tuple(q.shape)} != dequantize_blocks_plain, bitwise")
            check(bitwise_equal(g8.reshape(-1), cq.dequantize_blocks_plain(q_plain, s_plain)),
                  "int8 gather != the plain quantize/dequantize round trip, bitwise")
            metrics["p4_gather_int8_blocks"] = int(q.shape[0])
            del payload, q, s, q_plain, s_plain, deq
            flat = data.reshape(-1, BLOCK).astype(np.float64)
            g_err = np.abs(g8.cpu().numpy().reshape(-1, BLOCK) - flat)
            # half a scale, plus the float32 rounding of the scale, the
            # quotient and the decode (absmax 2^-22 in all)
            g_bound = np.abs(flat).max(axis=1, keepdims=True) * (1.0 / 254.0 + 2.0 ** -22)
            check(bool((g_err <= g_bound).all()), "int8 gather: a value outside its block's absmax/254")
            check(bool((g_err > 0).any()), "int8 gather did not quantize")
            s64 = stacked.double().cpu().numpy()
            r_bound = POSITIONS * float(np.abs(s64).max(axis=1).sum()) / 254.0
            r_err = float(np.abs(r8.cpu().numpy() - s64.sum(0)).max())
            check(r_err <= r_bound, f"int8 reduce error {r_err} outside p*sum(absmax)/254 = {r_bound}")
            check(bitwise_equal(r8, ring_unfused(torch, cq, stacked, POSITIONS)),
                  "int8 reduce != the ring of unfused kernels, bitwise")
            metrics["p4_gather_int8_max_err"] = float(g_err.max())
            metrics["p4_reduce_int8_err"], metrics["p4_reduce_int8_bound"] = r_err, r_bound
            print(f"  int8_block: launches {launches}; gather's B1/B2 bitwise their plain versions at "
                  f"{metrics['p4_gather_int8_blocks']} blocks; gather within absmax/254 of each block (max error "
                  f"{g_err.max():.4g}); reduce error {r_err:.4g} (bound {r_bound:.4g}), bitwise the unfused ring")
            del g8, r8, stacked, g_err, flat

        # where, nonzero and a boolean mask's count, exact
        col = data[:, 0]
        mask = X[:, 0] > 0
        nz = timed(torch, metrics, f"{tag}_nonzero", lambda: htt.nonzero(mask))
        exact(nz.numpy(), np.nonzero(col > 0)[0].astype(np.int64), f"nonzero at {p}")
        check(nz.split == 0 and nz.dtype is htt.int64, "nonzero: not int64 split 0")
        w = timed(torch, metrics, f"{tag}_where", lambda: htt.where(mask, X[:, 0], 0.0))
        exact(w.numpy(), np.where(col > 0, col, np.float32(0.0)), f"where at {p}")
        check(int(mask.sum().item()) == int((col > 0).sum()), f"mask count at {p}")

        # setitem across position boundaries, exact
        Y, Yn = X.copy(), data.copy()
        edge = N // POSITIONS  # the position boundaries at POSITIONS
        value = np.arange(40, dtype=np.float32).reshape(10, 4)
        keys = (((slice(edge - 10, edge + 10)), -1.0), ((slice(2 * edge - 5, 2 * edge + 5), slice(3, 7)), value),
                ((slice(None, None, -50_000), 0), 7.0), ((min(3 * edge, N - 1),), np.arange(F, dtype=np.float32)))

        def write():
            for key, val in keys:
                Y[key] = val

        timed(torch, metrics, f"{tag}_setitem", write)
        for key, val in keys:
            Yn[key] = val
        exact(Y.numpy(), Yn, f"setitem at {p}")
        del Y, Yn

        d = timed(torch, metrics, f"{tag}_diff", lambda: htt.diff(X, axis=0))
        exact(d.numpy(), np.diff(data, axis=0), f"diff at {p}")
        del d

        # halos at HALO rows, exact
        timed(torch, metrics, f"{tag}_get_halo", lambda: X.get_halo(HALO))
        blk = data.reshape(p, -1, F)
        zeros = np.zeros((1, HALO, F), np.float32)
        prev = np.concatenate([zeros, blk[:-1, -HALO:]]) if p > 1 else zeros
        nxt = np.concatenate([blk[1:, :HALO], zeros]) if p > 1 else zeros
        exact(X.halo_prev.cpu().numpy(), prev.reshape(-1, F), f"halo_prev at {p}")
        exact(X.halo_next.cpu().numpy(), nxt.reshape(-1, F), f"halo_next at {p}")
        exact(X.array_with_halos.cpu().numpy(), np.concatenate([prev, blk, nxt], axis=1).reshape(-1, F),
              f"array_with_halos at {p}")

        # factories, bitwise the port's CPU results
        eye = timed(torch, metrics, f"{tag}_eye", lambda: htt.eye(EYE_N, split=0, comm=comm))
        check(bool(torch.equal(eye.larray.cpu(), htt.eye(EYE_N, split=0, comm=cpu).larray)), f"eye at {p}")
        del eye
        for name in ("linspace", "logspace"):
            fn = getattr(htt, name)
            got = timed(torch, metrics, f"{tag}_{name}", lambda: fn(-3, 2, N, split=0, comm=comm))
            check(bool(torch.equal(got.larray.cpu(), fn(-3, 2, N, split=0, comm=cpu).larray)),
                  f"{name} at {p}: not bitwise the CPU's")

        # the printed string equals the CPU's
        text = timed(torch, metrics, f"{tag}_str", lambda: str(X))
        check(text.replace("device=gpu", "device=cpu") == str(htt.array(data, split=0, comm=cpu)),
              f"str at {p} differs from the CPU's")
        del X, mask, nz, w, parts, blocks

    # division by zero and shifts past the width: numpy's values
    comm = htt.TorchCommunication([dev] * POSITIONS)
    with np.errstate(divide="ignore", invalid="ignore"):
        for dtype in ("int32", "int64", "float32", "float64"):
            num = np.array([7, -7, 5, 0, 1.5, -2.5, 3, 9], np.float64).astype(dtype)
            den = np.array([0, 2, -3, 0, 0, 0, -1, 0], np.float64).astype(dtype)
            a, b = htt.array(num, split=0, comm=comm), htt.array(den, split=0, comm=comm)
            for name, fn in (("floordiv", np.floor_divide), ("mod", np.remainder), ("fmod", np.fmod)):
                # equal values (a zero remainder's sign is the reference's, not numpy's)
                got = getattr(htt, name)(a, b).numpy()
                check(got.dtype == num.dtype and np.array_equal(got, fn(num, den), equal_nan=True),
                      f"{name} by zero, {dtype}: {got} != numpy's {fn(num, den)}")
    for dtype in ("int32", "int64", "int8"):
        bits = np.iinfo(dtype).bits
        a = np.array([5, -5, -1, 100, -128, 127, 3, -3], dtype)
        c = np.array([1, bits - 1, bits, bits + 1, 40 % 127, 2 * bits % 127, 0, bits], dtype)
        x, s = htt.array(a, comm=comm), htt.array(c, comm=comm)
        big = c.astype(np.int64) >= bits
        lw = np.where(big, 0, np.left_shift(a, np.minimum(c, bits - 1)))
        rw = np.where(big, np.where(a < 0, -1, 0), np.right_shift(a, np.minimum(c, bits - 1)))
        exact(htt.left_shift(x, s).numpy(), lw.astype(dtype), f"left_shift {dtype}")
        exact(htt.right_shift(x, s).numpy(), rw.astype(dtype), f"right_shift {dtype}")
    print("phase 9: division by zero gives numpy's values; shifts past the width give 0 / the sign fill")
    return launches, metrics


# --------------------------------------------------------------------- #
# sort, take, manipulations and the rest of statistics (phase 10)         #
# --------------------------------------------------------------------- #
def ulps32(got: np.ndarray, want64: np.ndarray) -> float:
    """Largest distance, in float32 ulps, of float32 ``got`` from float64
    ``want64`` rounded to float32 (ordered-integer distance of the bits)."""
    def ordered(a):
        i = a.astype(np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return float(np.abs(ordered(got) - ordered(want64.astype(np.float32))).max())


def graph_ms(torch, metrics: dict, key: str, fn) -> float:
    """Device time of one call of ``fn`` from CUDA events around replays
    of a CUDA graph of 8 calls (:func:`device_ms`), recorded as
    ``{key}_graph_ms``: the profiler's per-call reading drops some calls'
    kernels (it read 0.000 ms for ``index_select`` on an H100)."""
    ms = device_ms(fn, [()], per_graph=8, trials=5)
    metrics[f"{key}_graph_ms"] = ms
    print(f"  {key}: {ms:.4f} ms of device time (CUDA graph)")
    return ms


def routed(take) -> dict:
    """Count the calls of ``take.ring_take`` and ``take.ring_put`` from
    now on, in the returned dict."""
    calls = {"ring_take": 0, "ring_put": 0}
    for name in calls:
        fn = getattr(take, name)
        fn = getattr(fn, "__wrapped__", fn)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        counted.__wrapped__ = fn
        setattr(take, name, counted)
    return calls


def unique_rows(a: np.ndarray) -> np.ndarray:
    """``np.unique(a, axis=0)`` of a matrix of 0/1 bytes, sorted as bytes
    (the same order for these values) in a fraction of numpy's time."""
    v = np.ascontiguousarray(a).view(np.dtype((np.void, a.shape[1] * a.itemsize)))[:, 0]
    return np.unique(v).view(a.dtype).reshape(-1, a.shape[1])


def phase_sort_stats(torch, htt, cq, dev, data, labels, counted):
    """Phase 10: the distributed sort, ring take/put and array keys,
    manipulations and the rest of statistics on the blobs at 1 and
    POSITIONS positions, each held to numpy (bitwise unless a tolerance is
    stated), the ring sort and ring take beside their single library
    call; ``average`` under ``int8_block`` with exact launch counts.
    Returns the int8 launches and the metrics."""
    import scipy.stats

    from heat_tpu_torch.core import dndarray
    from heat_tpu_torch.parallel import take

    metrics = {}
    d64 = data.astype(np.float64)
    launches = None
    q = [5.0, 25.0, 50.0, 75.0, 95.0]
    # numpy's results, computed once for both position counts
    order = {desc: np.argsort(-data if desc else data, axis=0, kind="stable") for desc in (False, True)}
    top = {dim: np.take(np.argsort(-data, axis=dim, kind="stable"), np.arange(k), axis=dim)
           for dim, k in ((0, 8), (1, 5))}
    signs = (data > 0).astype(np.int8)
    wide = np.concatenate([signs] * 3, axis=1)
    ref = {
        "percentile": np.percentile(d64, q, axis=0), "median": np.median(d64, axis=0),
        "global": np.percentile(d64[:, 0], 50.0), "unique": np.unique(labels, return_inverse=True),
        "rows": unique_rows(signs), "wide": unique_rows(wide), "cov": np.cov(d64, rowvar=False),
        "kurtosis": scipy.stats.kurtosis(d64, axis=0, bias=False), "skew": scipy.stats.skew(d64, axis=0, bias=False),
    }
    absx = np.abs(d64 - d64.mean(0))
    cov_bound = gamma(N) * (absx.T @ absx) / (N - 1) + gamma(N) * np.abs(ref["cov"])
    del absx
    for p in (1, POSITIONS):
        comm, cpu = htt.TorchCommunication([dev] * p), htt.TorchCommunication(["cpu"] * p)
        print(f"phase 10 at {p} position(s):")
        X = htt.array(data, split=0, comm=comm)
        tag = f"p{p}"

        # ---- sorting: the resplit sort, the 1-D ring, the narrow ring
        if p == POSITIONS:
            for desc in (False, True):
                want_i = order[desc]
                v, i = timed(torch, metrics, f"{tag}_sort_axis0{'_desc' if desc else ''}",
                             lambda: htt.sort(X, axis=0, descending=desc))
                exact(i.numpy(), want_i.astype(np.int32), f"sort axis 0 (descending={desc}) indices")
                exact(v.numpy(), np.take_along_axis(data, want_i, 0), f"sort axis 0 (descending={desc}) values")
                keys = -X.larray if desc else X.larray
                ref_i = torch.sort(keys, dim=0, stable=True)[1]
                check(bool(torch.equal(i.larray.to(torch.int64), ref_i)), "sort axis 0: not torch.sort's order")
            timed(torch, metrics, f"{tag}_sort_axis0_torch_sort", lambda: torch.sort(X.larray, dim=0, stable=True))
            graph_ms(torch, metrics, f"{tag}_sort_axis0", lambda: htt.sort(X, axis=0))
            graph_ms(torch, metrics, f"{tag}_sort_axis0_torch_sort", lambda: torch.sort(X.larray, dim=0, stable=True))
            # the local sorts' two layouts: each position's (n, F/p) column
            # block sorted along dim 1, or its transposed copy along the last
            blk = X.larray.reshape(N, p, F // p).permute(1, 0, 2)
            for name, fn in (("sort_layout_columns", lambda: torch.sort(blk, dim=1, stable=True)),
                             ("sort_layout_transposed",
                              lambda: torch.sort(blk.transpose(1, 2).contiguous(), dim=-1, stable=True))):
                timed(torch, metrics, name, fn)
                graph_ms(torch, metrics, name, fn)
            col = data[:, 1].copy()
            col[::97], col[1::97], col[2::1001] = 0.0, -0.0, np.nan
            for name, x in (("ring_sort", data[:, 0]), ("ring_sort_zeros_nan", col)):
                C = htt.array(x, split=0, comm=comm)
                for desc in (False, True):
                    key = -x if desc else x
                    want_i = np.argsort(key, kind="stable")
                    v, i = timed(torch, metrics, f"{tag}_{name}{'_desc' if desc else ''}",
                                 lambda: htt.sort(C, descending=desc))
                    exact(i.numpy(), want_i.astype(np.int32), f"{name} (descending={desc}) indices")
                    exact(v.numpy(), x[want_i], f"{name} (descending={desc}) values")
                    keys = -C.larray if desc else C.larray
                    check(bool(torch.equal(i.larray.to(torch.int64), torch.sort(keys, stable=True)[1])),
                          f"{name}: not torch.sort's order")
                timed(torch, metrics, f"{tag}_{name}_torch_sort", lambda: torch.sort(C.larray, stable=True))
                graph_ms(torch, metrics, f"{tag}_{name}", lambda: htt.sort(C))
                graph_ms(torch, metrics, f"{tag}_{name}_torch_sort", lambda: torch.sort(C.larray, stable=True))
            X2 = htt.array(data[:, :2], split=0, comm=comm)
            v, i = timed(torch, metrics, f"{tag}_narrow_ring_sort", lambda: htt.sort(X2, axis=0))
            want_i = np.argsort(data[:, :2], axis=0, kind="stable")
            exact(i.numpy(), want_i.astype(np.int32), "narrow ring sort indices")
            check(bool(torch.equal(i.larray.to(torch.int64), torch.sort(X2.larray, dim=0, stable=True)[1])),
                  "narrow ring sort: not torch.sort's order")
            timed(torch, metrics, f"{tag}_narrow_ring_sort_torch_sort",
                  lambda: torch.sort(X2.larray, dim=0, stable=True))
            graph_ms(torch, metrics, f"{tag}_narrow_ring_sort", lambda: htt.sort(X2, axis=0))
            graph_ms(torch, metrics, f"{tag}_narrow_ring_sort_torch_sort",
                     lambda: torch.sort(X2.larray, dim=0, stable=True))
            del v, i, blk, X2, C

        # ---- quantiles: within 1 ulp of float32 of numpy's float64
        got = timed(torch, metrics, f"{tag}_percentile_axis0", lambda: htt.percentile(X, q, axis=0))
        check(ulps32(got.numpy(), ref["percentile"]) <= 1, f"percentile axis 0 at {p}")
        got = timed(torch, metrics, f"{tag}_median_axis0", lambda: htt.median(X, axis=0))
        check(ulps32(got.numpy(), ref["median"]) <= 1, f"median axis 0 at {p}")
        X0 = X[:, 0]
        got = timed(torch, metrics, f"{tag}_percentile_global", lambda: htt.percentile(X0, 50.0))
        check(ulps32(got.numpy(), ref["global"]) <= 1, f"global percentile at {p}")

        # ---- unique and topk
        L = htt.array(labels, split=0, comm=comm)
        u, inv = timed(torch, metrics, f"{tag}_unique_labels", lambda: htt.unique(L, return_inverse=True))
        nu, ninv = ref["unique"]
        exact(u.numpy().astype(np.int64), nu, f"unique labels at {p}")
        exact(inv.numpy(), ninv.astype(np.int64), f"unique labels' inverse at {p}")
        B = htt.array(signs, split=0, comm=comm)
        u = timed(torch, metrics, f"{tag}_unique_rows", lambda: htt.unique(B, axis=0))
        exact(u.numpy(), ref["rows"], f"unique rows at {p}")
        B3 = htt.concatenate([B, B, B], axis=1)
        u = timed(torch, metrics, f"{tag}_unique_rows_hashed", lambda: htt.unique(B3, axis=0))
        if p == POSITIONS:
            on_cpu = htt.unique(htt.array(wide, split=0, comm=cpu), axis=0)
            exact(u.numpy(), on_cpu.numpy(), "hashed unique: not the port's CPU result")
        want = ref["wide"]
        check(u.shape == want.shape and {r.tobytes() for r in u.numpy()} == {r.tobytes() for r in want},
              f"hashed unique at {p}: not numpy's rows")
        exact(htt.unique(B3, sorted=True, axis=0).numpy(), want, f"hashed unique sorted=True at {p}")
        for dim, k in ((0, 8), (1, 5)):
            v, i = timed(torch, metrics, f"{tag}_topk_dim{dim}", lambda: htt.topk(X, k, dim=dim))
            want_i = top[dim]
            exact(i.numpy(), want_i.astype(np.int64), f"topk dim {dim} at {p}")
            exact(v.numpy(), np.take_along_axis(data, want_i, dim), f"topk values dim {dim} at {p}")
        del L, u, inv, B, B3

        # ---- array keys: the ring take/put at p positions (16 M elements)
        perm_t = htt.random.randperm(N, comm=comm)
        perm = perm_t.numpy()
        if p == POSITIONS:  # 16 M elements at several positions: the ring's
            check(X.size >= dndarray._RING_INDEX_MIN, "X[perm] would not take the ring")
            ring = routed(take)
            X[perm_t]
            check(ring == {"ring_take": 1, "ring_put": 0}, f"X[perm] took {ring}, not the ring take")
        g = timed(torch, metrics, f"{tag}_take_perm", lambda: X[perm_t])
        exact(g.numpy(), data[perm], f"X[perm] at {p}")
        check(bool(torch.equal(g.larray, torch.index_select(X.larray, 0, perm_t.larray))),
              f"X[perm] != index_select at {p}")
        timed(torch, metrics, f"{tag}_take_perm_index_select", lambda: torch.index_select(X.larray, 0, perm_t.larray))
        graph_ms(torch, metrics, f"{tag}_take_perm", lambda: X[perm_t])
        graph_ms(torch, metrics, f"{tag}_take_perm_index_select",
                 lambda: torch.index_select(X.larray, 0, perm_t.larray))
        Y = htt.zeros((N, F), split=0, comm=comm)

        def put():
            Y[perm_t] = X

        if p == POSITIONS:
            ring = routed(take)
            put()
            check(ring == {"ring_take": 0, "ring_put": 1}, f"Y[perm] = X took {ring}, not the ring put")
        timed(torch, metrics, f"{tag}_put_perm", put)
        graph_ms(torch, metrics, f"{tag}_put_perm", put)
        graph_ms(torch, metrics, f"{tag}_put_perm_index_copy",
                 lambda: torch.zeros_like(X.larray).index_copy_(0, perm_t.larray, X.larray))
        want = np.zeros_like(data)
        want[perm] = data
        exact(Y.numpy(), want, f"Y[perm] = X at {p}")
        m = timed(torch, metrics, f"{tag}_mask", lambda: X[X[:, 0] > 0])
        exact(m.numpy(), data[data[:, 0] > 0], f"X[mask] at {p}")
        oob = np.array([N + 5, -N - 3, 7, -1], np.int64)
        exact(X[oob].numpy(), data[[N - 1, 0, 7, N - 1]], f"out-of-range array key clamps at {p}")
        Y[np.array([N + 10, -N - 10])] = 1.0  # out of range: dropped, no device assert
        exact(Y.numpy(), want, f"out-of-range array key drops at {p}")
        del g, Y, m, want

        # ---- manipulations, bitwise numpy's
        r1 = timed(torch, metrics, f"{tag}_resplit", lambda: htt.resplit(htt.resplit(X, 1), 0))
        exact(r1.numpy(), data, f"resplit and back at {p}")
        checks = (
            ("reshape", lambda: htt.reshape(X, (N // 2, 2 * F), new_split=0), data.reshape(N // 2, 2 * F)),
            ("flatten", lambda: htt.flatten(X), data.reshape(-1)),
            ("concatenate", lambda: htt.concatenate([X, X]), np.concatenate([data, data])),
            ("pad", lambda: htt.pad(X, ((1, 2), (0, 3))), np.pad(data, ((1, 2), (0, 3)))),
            ("flip", lambda: htt.flip(X, 0), data[::-1]),
            ("rot90", lambda: htt.rot90(X), np.rot90(data)),
            ("repeat", lambda: htt.repeat(X, 2, axis=0), np.repeat(data, 2, axis=0)),
            ("stack", lambda: htt.stack([X, X]), np.stack([data, data])),
        )
        for name, fn, want in checks:
            exact(timed(torch, metrics, f"{tag}_{name}", fn).numpy(), want, f"{name} at {p}")
        A = htt.random.randn(EYE_N, EYE_N, split=0, comm=comm)
        dg = timed(torch, metrics, f"{tag}_diag", lambda: htt.diag(A))
        idx = np.arange(EYE_N)
        exact(dg.numpy(), A[idx, idx].numpy(), f"diag of {EYE_N}^2 at {p}")
        del r1, A, dg

        # ---- statistics
        a = timed(torch, metrics, f"{tag}_argmax", lambda: htt.argmax(X, axis=0))
        exact(a.numpy(), np.argmax(data, axis=0).astype(np.int64), f"argmax at {p}")
        Xf = htt.flip(X, 0)
        exact(htt.maximum(X, Xf).numpy(), np.maximum(data, data[::-1]), f"maximum at {p}")
        exact(htt.minimum(X, Xf).numpy(), np.minimum(data, data[::-1]), f"minimum at {p}")
        L = htt.array(labels, split=0, comm=comm)
        bc = timed(torch, metrics, f"{tag}_bincount", lambda: htt.bincount(L))
        exact(bc.numpy(), np.bincount(labels).astype(np.int64), f"bincount at {p}")
        c = timed(torch, metrics, f"{tag}_cov", lambda: htt.cov(X, rowvar=False))
        check(bool((np.abs(c.numpy() - ref["cov"]) <= cov_bound).all()),
              f"cov at {p}: outside gamma_n sum|x_i||x_j|/(n-1)")
        h, edges = timed(torch, metrics, f"{tag}_histogram", lambda: htt.histogram(X0, bins=100))
        hc, ec = htt.histogram(htt.array(data[:, 0], split=0, comm=cpu), bins=100)
        exact(h.numpy(), hc.numpy(), f"histogram counts at {p}: not the port's CPU result")
        exact(edges.numpy(), ec.numpy(), f"histogram edges at {p}: not the port's CPU result")
        check(int(h.numpy().sum()) == N, "histogram: counts do not sum to N")
        for name, fn in (("kurtosis", htt.kurtosis), ("skew", htt.skew)):
            got = timed(torch, metrics, f"{tag}_{name}", lambda: fn(X, 0)).numpy()
            want = ref[name]
            check(bool((np.abs(got - want) <= 1e-4 * np.abs(want)).all()), f"{name} at {p}: not within 1e-4 of scipy")
        w = np.random.default_rng(3).random(N).astype(np.float32)
        W = htt.array(w, split=0, comm=comm)
        got = timed(torch, metrics, f"{tag}_average_weighted", lambda: htt.average(X, axis=0, weights=W)).numpy()
        w64 = w.astype(np.float64)
        want = (d64 * w64[:, None]).sum(0) / w64.sum()
        bound = 3 * gamma(N) * (np.abs(d64) * w64[:, None]).sum(0) / w64.sum()
        check(bool((np.abs(got - want) <= bound).all()), f"weighted average at {p}")
        got = timed(torch, metrics, f"{tag}_average", lambda: htt.average(X, axis=0)).numpy()
        check(bool((np.abs(got - d64.mean(0)) <= 2 * gamma(N) * np.abs(d64).mean(0)).all()), f"average at {p}")
        if p == POSITIONS:
            with cq.collective_precision("int8_block"):
                for fn in counted:
                    fn.launches = 0
                got = htt.average(X, axis=0)
                torch.cuda.synchronize()
                launches = {f"blockquant_{fn.__name__.removesuffix('_blocks')}": fn.launches for fn in counted}
                timed(torch, metrics, "p4_average_int8", lambda: htt.average(X, axis=0))
            expected = {"blockquant_quantize": 1, "blockquant_dequantize": 1,
                        "blockquant_dequantize_fma": 0, "blockquant_dequantize_add_quantize": POSITIONS - 1}
            check(launches == expected, f"phase 10 int8 average launches {launches} != {expected}")
            parts = d64.reshape(POSITIONS, N // POSITIONS, F).sum(1)
            m_bound = POSITIONS * float(np.abs(parts).max(axis=1).sum()) / 254.0 / N
            m_err = float(np.abs(got.numpy() - d64.mean(0)).max())
            check(m_err <= m_bound, f"int8 average error {m_err} outside the ring bound {m_bound}")
            partials = comm.blocks(X._buffer, 0).sum(dim=1)
            unfused = ring_unfused(torch, cq, partials.reshape(POSITIONS, -1), POSITIONS) / float(N)
            check(bitwise_equal(got.larray, unfused.reshape(F)), "int8 average != the unfused ring, bitwise")
            metrics["p4_average_int8_err"], metrics["p4_average_int8_bound"] = m_err, m_bound
            print(f"  int8_block average: launches {launches}; error {m_err:.4g} (bound {m_bound:.4g}), "
                  "bitwise the unfused ring")
        del X, X0, Xf, W, L
    return launches, metrics


# --------------------------------------------------------------------- #
# the 2-D grid of positions (phase 11)                                   #
# --------------------------------------------------------------------- #
def grid_call(torch, metrics: dict, key: str, fn, graph: bool = False):
    """Record ``fn``'s wall time (median of 3), host synchronize calls and
    device time under ``key``: from a CUDA graph of 8 calls when ``graph``
    (``{key}_graph_ms``), else from the profiler (``{key}_device_ms``).
    Returns ``fn()`` and the wall time."""
    out = fn()
    wall = metrics[f"{key}_ms"] = wall_ms(fn, reps=3)
    dev_ms, syncs = profile_counts(torch, fn)
    metrics[f"{key}_syncs"] = syncs
    if graph:
        dev_ms = metrics[f"{key}_graph_ms"] = device_ms(fn, [()], per_graph=8, trials=5)
        source = "CUDA graph"
    else:
        metrics[f"{key}_device_ms"] = dev_ms
        source = "profiler"
    print(f"  {key}: {wall:.3f} ms wall, {syncs} host syncs, {dev_ms:.3f} ms of device time ({source})")
    return out, wall


def phase_grid(torch, htt, dev, data):
    """Phase 11: the grid of positions at the reference benchmark's sizes
    on 2 x 2 and 2 x 4 grids; returns its metrics."""
    import importlib

    svd_mod = importlib.import_module("heat_tpu_torch.core.linalg.svd")
    metrics = {}
    rng = np.random.default_rng(13)
    a = rng.normal(size=(SUMMA2D_N, SUMMA2D_N)).astype(np.float32)
    b = rng.normal(size=(SUMMA2D_N, SUMMA2D_N)).astype(np.float32)
    prod64 = a.astype(np.float64) @ b.astype(np.float64)
    summa_bound = gamma(SUMMA2D_N) * (np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64))
    rng = np.random.default_rng(29)
    qa = rng.normal(size=(QR2D_M, QR2D_N)).astype(np.float32)
    sa = rng.normal(size=(SVD2D_M, SVD2D_N)).astype(np.float32)
    sm, sn = SVD2D_M, SVD2D_N
    summa_flops = 2.0 * SUMMA2D_N ** 3
    qr_flops = float(2 * QR2D_M * QR2D_N ** 2 - 2 * QR2D_N ** 3 // 3)
    stacked_qr = 2 * (sm + sn) * sn * sn - 2 * sn ** 3 // 3
    svd_flops = float(svd_mod._QDWH_MAXIT * (stacked_qr + 2 * (sm + sn) * sn * sn) + 4 * sm * sn * sn + 9 * sn ** 3)
    s64 = np.linalg.svd(sa.astype(np.float64), compute_uv=False)
    smax = float(s64[0])

    # the single-call yardsticks, once: they do not depend on the grid
    at, bt = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    qt, st = torch.from_numpy(qa).to(dev), torch.from_numpy(sa).to(dev)
    print("phase 11 yardsticks:")
    grid_call(torch, metrics, "torch_matmul_1024", lambda: torch.matmul(at, bt), graph=True)
    _, qr_wall = grid_call(torch, metrics, "torch_linalg_qr_4096x512", lambda: torch.linalg.qr(qt))
    _, svd_wall = grid_call(torch, metrics, "torch_linalg_svd_1024x256",
                            lambda: torch.linalg.svd(st, full_matrices=False))
    metrics["torch_linalg_qr_tflops"] = qr_flops / qr_wall / 1e9
    metrics["torch_linalg_svd_tflops"] = svd_flops / svd_wall / 1e9
    metrics["torch_matmul_tflops"] = summa_flops / metrics["torch_matmul_1024_graph_ms"] / 1e9

    for mesh in GRID_MESHES:
        r, c = mesh
        tag = f"{r}x{c}"
        comm = htt.grid_comm(mesh, [dev] * (r * c))
        cpu = htt.grid_comm(mesh, ["cpu"] * (r * c))
        print(f"phase 11 on a {tag} grid of positions:")

        # 1. the grid SUMMA in its three layouts
        for layout, sa_, sb_ in (("grid", (0, 1), (0, 1)), ("rowcol", (0, None), (None, 1)),
                                 ("colrow", (None, 1), (0, None))):
            A = htt.array(a, splits=sa_, comm=comm)
            B = htt.array(b, splits=sb_, comm=comm)
            C, wall = grid_call(torch, metrics, f"summa2d_{layout}_{tag}", lambda: A @ B, graph=True)
            check(C.splits == (0, 1) and C.shape == (SUMMA2D_N, SUMMA2D_N), f"summa2d {layout} layout")
            got = C.numpy().astype(np.float64)
            check(bool(np.isfinite(got).all()), f"summa2d {layout} at {tag}: non-finite")
            err = np.abs(got - prod64)
            check(bool((err <= summa_bound).all()), f"summa2d {layout} at {tag}: outside gamma_k |A||B|")
            metrics[f"summa2d_{layout}_{tag}_err_share_of_bound"] = float((err / summa_bound).max())
        metrics[f"summa2d_tflops_{tag}"] = summa_flops / metrics[f"summa2d_grid_{tag}_graph_ms"] / 1e9
        print(f"  summa2d_tflops {metrics[f'summa2d_tflops_{tag}']:.2f} (device time), torch.matmul "
              f"{metrics['torch_matmul_tflops']:.2f}")

        # 2. the grid CAQR QR
        QA = htt.array(qa, splits=(0, 1), comm=comm)
        (q, rr), wall = grid_call(torch, metrics, f"qr2d_{tag}", lambda: htt.linalg.qr(QA))
        check(q.splits == (0, 1) and rr.splits == (None, 1), f"qr2d layouts at {tag}")
        qv, rv = q.numpy().astype(np.float64), rr.numpy().astype(np.float64)
        resid = float(np.linalg.norm(qv @ rv - qa) / np.linalg.norm(qa))
        orth = float(np.abs(qv.T @ qv - np.eye(QR2D_N)).max())
        check(resid <= QR_TOL, f"qr2d at {tag}: ||QR - A|| / ||A|| = {resid:.3g}")
        check(orth <= ORTH_TOL, f"qr2d at {tag}: max|Q^T Q - I| = {orth:.3g}")
        check(not np.tril(rv, -1).any(), f"qr2d at {tag}: R not upper triangular")
        qc, rc = htt.linalg.qr(htt.array(qa, splits=(0, 1), comm=cpu))
        qc, rc = qc.numpy().astype(np.float64), rc.numpy().astype(np.float64)
        signs = float((np.sign(np.diag(rv)) == np.sign(np.diag(rc))).mean())
        dq = float(np.abs(qv - qc).max() / np.abs(qc).max())
        dr = float(np.abs(rv - rc).max() / np.abs(rc).max())
        metrics.update({f"qr2d_{tag}_residual": resid, f"qr2d_{tag}_orth": orth,
                        f"qr2d_{tag}_sign_agreement": signs, f"qr2d_{tag}_q_vs_cpu": dq,
                        f"qr2d_{tag}_r_vs_cpu": dr})
        print(f"  qr2d: residual {resid:.3g}, orthogonality {orth:.3g}, R's diagonal signs as the CPU's "
              f"at {signs:.4f} of columns; Q, R against the CPU {dq:.3g}, {dr:.3g} of their largest entry")
        check(dq <= QR2D_CPU_TOL and dr <= QR2D_CPU_TOL, f"qr2d at {tag}: card and CPU factors differ")
        metrics[f"qr2d_tflops_{tag}"] = qr_flops / wall / 1e9
        del q, rr, qv, rv, qc, rc

        # 3. the QDWH SVD
        SA = htt.array(sa, splits=(0, 1), comm=comm)
        res, wall = grid_call(torch, metrics, f"svd2d_{tag}", lambda: htt.linalg.svd(SA))
        u, s, v = (x.numpy().astype(np.float64) for x in res)
        check(res.U.splits == (0, 1) and res.S.splits == (None,) and res.V.splits == (None, None),
              f"svd2d layouts at {tag}")
        iters = svd_mod._grid_svd_parts(SA, htt.float32)[3]
        s_err = float(np.abs(s - s64).max()) / (EPS32 * smax)
        rec = float(np.abs(u @ np.diag(s) @ v.T - sa).max()) / (EPS32 * smax)
        orth = max(float(np.abs(u.T @ u - np.eye(sn)).max()), float(np.abs(v.T @ v - np.eye(sn)).max())) / EPS32
        metrics.update({f"svd2d_{tag}_iterations": iters, f"svd2d_{tag}_s_err_eps": s_err,
                        f"svd2d_{tag}_reconstruction_eps": rec, f"svd2d_{tag}_orth_eps": orth,
                        f"svd2d_tflops_{tag}": svd_flops / wall / 1e9})
        print(f"  svd2d: {iters} QDWH iterations; S {s_err:.2f} eps s_max from numpy's, reconstruction "
              f"{rec:.2f} eps s_max, orthogonality {orth:.2f} eps (gates 50, 100, 200)")
        check(s_err <= 50 and rec <= 100 and orth <= 200, f"svd2d at {tag}: outside the reference's gates")
        print(f"  qr2d_tflops {metrics[f'qr2d_tflops_{tag}']:.3f} (torch.linalg.qr "
              f"{metrics['torch_linalg_qr_tflops']:.3f}), svd2d_tflops {metrics[f'svd2d_tflops_{tag}']:.3f} "
              f"(torch.linalg.svd {metrics['torch_linalg_svd_tflops']:.3f}), over wall time")
        del res, u, s, v

        # 4. layouts and the reference's reduce fault
        x = QA
        for dst, want in (((None, 1), (None, 1)), ((1, 0), (1, 0)), (None, (None, None))):
            x = x.resplit(dst)
            check(x.splits == want, f"resplit to {dst} at {tag}: {x.splits}")
            exact(x.numpy(), qa, f"resplit round trip to {dst} at {tag}")
        part = np.ascontiguousarray(data[:RAGGED_ROWS, :RAGGED_COLS])
        n = RAGGED_ROWS
        bounded = (1.0 + np.float32(1e-3) * np.sin(np.float32(100.0) * part)).astype(np.float32)
        for what, vals, op in (("sum", part, np.sum), ("prod", bounded, np.prod)):
            X = htt.array(vals, splits=(0, 1), comm=comm)
            got = getattr(X, what)(0)
            check(got.shape == (RAGGED_COLS,) and got.splits == (None,), f"{what}(0) at {tag}: {got.shape}")
            want = op(vals.astype(np.float64), axis=0)
            scale = np.sum(np.abs(vals.astype(np.float64)), 0) if what == "sum" else np.abs(want)
            err = np.abs(got.numpy().astype(np.float64) - want)
            check(bool((err <= (gamma(n - 1) + n * 2.0 ** -52) * scale).all()),
                  f"{what}(0) at {tag}: outside gamma_n bound")
        print(f"  resplit round trip bitwise; sum(0), prod(0) of {RAGGED_ROWS} x {RAGGED_COLS}: numpy's "
              f"shapes, within gamma_n")
    return metrics


# --------------------------------------------------------------------- #
# the base layer: telemetry and the resilience seams (phase 12)          #
# --------------------------------------------------------------------- #
def _nan_canonical(torch, t) -> bool:
    """Every NaN of a float32 tensor is the quiet NaN 0x7fc00000."""
    return bool((t.view(torch.int32)[t.isnan()] == 0x7FC00000).all())


def _get(port: int, path: str):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def phase_base_layer(torch, htt, cq, dev, data, centers, counted):
    """Phase 12 (see the module docstring).  Returns ``(launches of the
    disabled-mode run, metrics)``; leaves telemetry off and reset, no
    plan armed, the guard off and no listener open."""
    import glob
    import os
    import tempfile
    import warnings

    from heat_tpu_torch import telemetry as tel
    from heat_tpu_torch.resilience import faults, guards, incidents
    from heat_tpu_torch.telemetry import export, flight, httpz

    check(not tel.is_enabled() and not faults.any_active() and guards.get_guard_policy() == "off",
          "phase 12 starts with telemetry off, no plan armed and the guard off")
    comm4 = htt.TorchCommunication([dev] * POSITIONS)
    stacked = torch.from_numpy(np.random.default_rng(1).normal(size=(POSITIONS, PAYLOAD)).astype(np.float32)).to(dev)
    X4 = htt.array(data, split=0, comm=comm4)
    init4 = htt.array(centers, comm=comm4)
    metrics = {}

    def allreduce():
        return comm4.allreduce(stacked, "sum")

    def three_calls():
        red = allreduce()
        km = htt.cluster.KMeans(n_clusters=K, init=init4, max_iter=ITERS, tol=-1.0).fit(X4)
        pred = km.predict(X4)
        gat = comm4.allgather(X4.larray, 0)
        torch.cuda.synchronize()
        return [red, km.cluster_centers_.larray, km.labels_.larray, pred.larray, gat]

    def launches_of(fn):
        for f in counted:
            f.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {f"blockquant_{f.__name__.removesuffix('_blocks')}": f.launches for f in counted}

    tmp = tempfile.TemporaryDirectory()
    try:
        with cq.collective_precision("int8_block"):
            # ---------------------------------------------------- 12.1
            off, launches = launches_of(three_calls)
            # phase 4's allreduce and 30-step EF fit less its three moment
            # rings (61 / 93 / 30 / 31), and phase 9's gather (1 / 0 / 0 / 1)
            expected = {"blockquant_quantize": 62, "blockquant_dequantize_add_quantize": 93,
                        "blockquant_dequantize_fma": 30, "blockquant_dequantize": 32}
            check(launches == expected, f"phase 12 disabled-mode launches {launches} != {expected}")
            tel.enable()
            tel.reset()
            allreduce()
            ratio1 = tel.snapshot()["gauges"]["comm.wire_ratio.int8_block"]
            check(ratio1 == 0.2578125, f"phase 12 block-aligned allreduce wire ratio {ratio1} != 0.2578125")
            tel.reset()
            on, launches_on = launches_of(three_calls)
            check(launches_on == expected, f"phase 12 enabled-mode launches {launches_on} != {expected}")
            for a, b, what in zip(off, on, ("allreduce", "centers", "labels", "predict", "allgather")):
                check(bitwise_equal(a, b), f"phase 12 {what} with telemetry on != off, bitwise")
            agree = float((off[2] == off[3]).float().mean())
            check(agree >= 0.9999, f"phase 12 predict agrees with the fit's labels on {agree}")
            snap = tel.snapshot()
            c, g, spans = snap["counters"], snap["gauges"], snap["spans"]
            # the allreduce, then the fit's one entry for its ITERS rings
            wm = [cq.wire_model(PAYLOAD, POSITIONS, "int8_block")]
            wm += [cq.wire_model(K * F, POSITIONS, "int8_block")] * ITERS
            wg = cq.wire_model(N * F // POSITIONS, POSITIONS, "int8_block", op="allgather")
            want_exact = sum(w["exact_wire_bytes"] for w in wm) + wg["exact_wire_bytes"]
            want_wire = sum(w["wire_bytes"] for w in wm) + wg["wire_bytes"]
            check(c.get("comm.collectives.allreduce") == 2 and c.get("comm.collectives.allgather") == 1,
                  f"phase 12 collective counts {c}")
            check(c["comm.exact_bytes.int8_block"] == want_exact and c["comm.wire_bytes.int8_block"] == want_wire,
                  f"phase 12 byte ledger {c} != wire_model's {want_exact} / {want_wire}")
            ratio = g["comm.wire_ratio.int8_block"]
            check(abs(ratio - 0.258) / 0.258 < 0.02, f"phase 12 wire ratio after the fit {ratio}")
            span_counts = {k: spans.get(k, {}).get("count", 0) for k in (
                "fit:KMeans", "predict:KMeans", "commq:allreduce", "commq:allgather",
                "comm:allreduce_q:step:issue", "comm:allreduce_q:step:consume",
                "comm:allgather_q:step:issue", "comm:allgather_q:step:consume")}
            check(span_counts == {"fit:KMeans": 1, "predict:KMeans": 1, "commq:allreduce": 1,
                                  "commq:allgather": 1, "comm:allreduce_q:step:issue": 1,
                                  "comm:allreduce_q:step:consume": 1, "comm:allgather_q:step:issue": 1,
                                  "comm:allgather_q:step:consume": 1}, f"phase 12 spans {span_counts}")
            tel.disable()
            tel.reset()

            # wall and device time, host syncs: off, on, on with a guard;
            # the host readings in PHASE12_ROUNDS alternating rounds, so
            # drift on the shared host falls on every mode alike
            def mode_of(mode):
                (tel.enable if mode != "off" else tel.disable)()
                return guards.guard("raise" if mode == "guard" else "off")

            walls = {m: [] for m in ("off", "on", "guard")}
            for _ in range(PHASE12_ROUNDS):
                for mode in walls:
                    with mode_of(mode):
                        walls[mode].append(wall_ms(allreduce, reps=9))
                    tel.disable()
                    tel.reset()
            for mode, ws in walls.items():
                metrics[f"allreduce_q_{mode}_wall_ms"] = float(np.median(ws))
                metrics[f"allreduce_q_{mode}_wall_range_ms"] = [float(min(ws)), float(max(ws))]
                with mode_of(mode):
                    dev_ms, syncs = profile_counts(torch, allreduce)
                    metrics[f"allreduce_q_{mode}_profiled_device_ms"] = dev_ms
                    metrics[f"allreduce_q_{mode}_host_syncs"] = syncs
                    if mode != "guard":  # the guard's host read cannot be captured in a graph
                        times = device_times(lambda: allreduce(), [()])
                        metrics[f"allreduce_q_{mode}_device_ms"] = float(np.median(times))
                        metrics[f"allreduce_q_{mode}_device_spread_ms"] = float(max(times) - min(times))
                tel.disable()
                tel.reset()
            gap = abs(metrics["allreduce_q_on_device_ms"] - metrics["allreduce_q_off_device_ms"])
            spread = max(metrics["allreduce_q_on_device_spread_ms"], metrics["allreduce_q_off_device_spread_ms"])
            check(gap <= spread + 0.02 * metrics["allreduce_q_off_device_ms"],
                  f"phase 12 device time on/off {metrics['allreduce_q_on_device_ms']:.4f} / "
                  f"{metrics['allreduce_q_off_device_ms']:.4f} ms apart by more than the spread {spread:.4f}")
            check((metrics["allreduce_q_off_host_syncs"], metrics["allreduce_q_on_host_syncs"],
                   metrics["allreduce_q_guard_host_syncs"]) == (0, 1, 2),
                  f"phase 12 host syncs off/on/guard {metrics['allreduce_q_off_host_syncs']}/"
                  f"{metrics['allreduce_q_on_host_syncs']}/{metrics['allreduce_q_guard_host_syncs']} != 0/1/2")
            print(f"phase 12 allreduce_q (4, 2^20): wall off / on / guarded "
                  f"{metrics['allreduce_q_off_wall_ms']:.4f} / {metrics['allreduce_q_on_wall_ms']:.4f} / "
                  f"{metrics['allreduce_q_guard_wall_ms']:.4f} ms (median of {PHASE12_ROUNDS} alternating "
                  f"rounds; ranges {[metrics[f'allreduce_q_{m}_wall_range_ms'] for m in walls]}); device (graph) off / on "
                  f"{metrics['allreduce_q_off_device_ms']:.4f} / {metrics['allreduce_q_on_device_ms']:.4f} ms "
                  f"(spread {spread:.4f}); profiled device off / on / guarded "
                  f"{metrics['allreduce_q_off_profiled_device_ms']:.4f} / "
                  f"{metrics['allreduce_q_on_profiled_device_ms']:.4f} / "
                  f"{metrics['allreduce_q_guard_profiled_device_ms']:.4f} ms; host syncs 0 / 1 / 2")
            print(f"phase 12 counters: allreduce {c['comm.collectives.allreduce']}, allgather "
                  f"{c['comm.collectives.allgather']}, exact {want_exact} B, wire {want_wire} B, ratio "
                  f"{ratio!r} (block-aligned allreduce {ratio1!r}); spans {span_counts}")

            # ---------------------------------------------------- 12.2
            host_path = f"{tmp.name}/host.json"
            export.start_trace(host_path, device_trace_dir=f"{tmp.name}/device")
            try:
                allreduce()
            finally:
                export.stop_trace()
                tel.disable()
                tel.reset()
            host = json.loads(open(host_path).read())["traceEvents"]
            names = {e["name"] for e in host}
            check({"commq:allreduce", "comm:allreduce_q:step:issue", "comm:allreduce_q:step:consume"} <= names
                  and all({"ph", "ts", "name", "pid"} <= set(e) for e in host),
                  f"phase 12 host trace events {sorted(names)}")
            dev_traces = sorted(glob.glob(f"{tmp.name}/device/device-*.json"))
            check(len(dev_traces) == 1, "phase 12: no device trace written")
            found = trace_kernel_names(open(dev_traces[0]).read())
            check(found == set(TRACE_SYMBOLS), f"phase 12 device trace names {sorted(found)} of {sorted(TRACE_SYMBOLS)}")
            print(f"phase 12 trace: host {len(host)} events; device trace names {sorted(found)}")

            # ---------------------------------------------------- 12.3
            for kind, kw in PHASE12_FAULTS:
                with faults.inject(kind, nth=1, **kw):
                    got = allreduce()
                with faults.inject(kind, nth=1, **kw):
                    if kind == "bitflip":
                        want = faults.comm_output("allreduce_q", ring_plain(torch, cq, stacked, POSITIONS))
                    else:
                        want = ring_plain(torch, cq, faults.comm_input("allreduce_q", stacked), POSITIONS)
                check(bitwise_equal(got, want), f"phase 12 {kind} {kw}: the faulted ring != the plain ring, bitwise")
                check(_nan_canonical(torch, got), f"phase 12 {kind} {kw}: a NaN other than 0x7fc00000")
                check(kind == "bitflip" or not guards.is_healthy(got), f"phase 12 {kind} {kw}: the fault did not show")
                print(f"phase 12 fault {kind} {kw}: bitwise the plain ring; non-finite values "
                      f"{int((~torch.isfinite(got)).sum())}, max |finite| "
                      f"{float(got[torch.isfinite(got)].abs().max()):.4g}")
            exact = cq.allreduce_q(stacked, comm=comm4, precision="f32")
            compressed = allreduce()
            incidents.clear_incident_log()
            prior_dir = flight.dump_dir()
            flight.set_dump_dir(f"{tmp.name}/flight")
            try:
                with guards.guard("raise"), faults.inject("saturate", nth=1):
                    try:
                        allreduce()
                        raised = ""
                    except guards.NumericalHealthError as e:
                        raised = str(e)
                check("allreduce_q" in raised, "phase 12 guard 'raise' did not raise naming allreduce_q")
                with guards.guard("warn"), faults.inject("saturate", nth=1):
                    with warnings.catch_warnings(record=True) as w:
                        warnings.simplefilter("always")
                        warned = allreduce()
                n_warn = sum(issubclass(x.category, guards.GuardWarning) for x in w)
                check(n_warn == 1 and not guards.is_healthy(warned),
                      f"phase 12 guard 'warn': {n_warn} GuardWarnings")
                with guards.guard("degrade"), faults.inject("saturate", nth=1):
                    degraded = allreduce()
                    healthy = allreduce()
                check(bitwise_equal(degraded, exact), "phase 12 guard 'degrade' != precision='f32', bitwise")
                check(bitwise_equal(healthy, compressed), "phase 12 a healthy guarded call != the compressed one")
                with guards.guard("off"), faults.inject("saturate", nth=1):
                    passed = allreduce()
                check(not guards.is_healthy(passed), "phase 12 guard 'off' stopped the fault")
                log = incidents.incident_log()
                check([(i.site, i.policy, i.action) for i in log] == [
                    ("allreduce_q", "raise", "raised"), ("allreduce_q", "warn", "warned"),
                    ("allreduce_q", "degrade", "degraded")], f"phase 12 incidents {[i.render() for i in log]}")
                dumps = sorted(os.listdir(f"{tmp.name}/flight"))
                last = json.loads(open(f"{tmp.name}/flight/{dumps[-1]}").read())
                check(len(dumps) == 3 and last["kind"] == "heat_tpu-flight-postmortem"
                      and last["incident"]["action"] == "degraded"
                      and any("degraded" in r for r in last["incident_log"]),
                      f"phase 12 flight dumps {dumps}")
            finally:
                flight.set_dump_dir(prior_dir)
                incidents.clear_incident_log()
            print(f"phase 12 guards: raise named allreduce_q; warn gave 1 GuardWarning; degrade bitwise "
                  f"precision='f32'; off let the fault through; incidents {[i.action for i in log]}; "
                  f"postmortems {dumps}")

            # ---------------------------------------------------- 12.4
            fires = []
            with faults.inject("nonfinite", rate=0.3, seed=0) as plan:
                for i in range(SCHEDULE_CALLS):
                    if not bool(torch.isfinite(allreduce()[:BLOCK]).all()):
                        fires.append(i)
            check(tuple(fires) == SCHEDULE_FIRES and plan.calls == SCHEDULE_CALLS,
                  f"phase 12 seeded schedule fired at {fires}, pinned {SCHEDULE_FIRES}")
            print(f"phase 12 seeded schedule: fired at {fires} of {SCHEDULE_CALLS} (pinned)")

            # ---------------------------------------------------- 12.5
            tel.enable()
            tel.reset()
            try:
                allreduce()
                comm4.allgather(X4.larray, 0)
                with tel.MetricsServer(port=0) as srv:
                    status, body = _get(srv.port, "/metrics")
                    health = _get(srv.port, "/healthz")
                text = httpz.prometheus_text()
            finally:
                tel.disable()
                tel.reset()
            check(status == 200 and health == (200, "ok\n"), f"phase 12 /metrics {status}, /healthz {health}")
            want_lines = {"heat_comm_collectives_allreduce_total 1", "heat_comm_collectives_allgather_total 1",
                          f"heat_comm_wire_ratio_int8_block {float(0.2578125)!r}"}
            lines = set(body.splitlines())
            check(want_lines <= lines and body == text, f"phase 12 /metrics lacks {sorted(want_lines - lines)}")
            print(f"phase 12 /metrics on 127.0.0.1:{srv.port}: {len(lines)} lines, {sorted(want_lines)}")
    finally:
        tmp.cleanup()
        faults.clear()
        guards.set_guard_policy("off")
        tel.disable()
        tel.reset()
    return launches, metrics


# --------------------------------------------------------------------- #
# IO, the out-of-core stream, checkpoints and resume (phase 13)           #
# --------------------------------------------------------------------- #
def once(torch, fn):
    """``(fn(), wall ms, device ms)`` of ONE call of ``fn`` under
    ``torch.profiler`` (calls with side effects, a snapshot or a kill, run
    once; the profiler's overhead is in the wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = 0.0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and not evt.key.startswith("Activity Buffer"):
            us = getattr(evt, "self_device_time_total", None)
            dev += float(us if us is not None else getattr(evt, "self_cuda_time_total", 0.0))
    return out, wall, dev / 1e3


def step13(torch, metrics: dict, key: str, fn):
    """Run ``fn`` once (:func:`once`), record and print its wall and
    device time under ``key``, return ``fn()``."""
    out, wall, dev = once(torch, fn)
    metrics[f"{key}_ms"], metrics[f"{key}_device_ms"] = wall, dev
    print(f"  {key}: {wall:.3f} ms wall, {dev:.3f} ms of device time")
    return out


def hold_minibatch_kmeans(torch, dev, x: np.ndarray, init: np.ndarray, mb: int, epochs: int):
    """Replay the mini-batch KMeans fit's chunk updates on the card and
    hold each to float64 numpy: every label the float64 nearest center's
    unless the row's two nearest centers lie within ``KM_TIE`` of its
    squared distance, and the new centers and counts within ``STREAM_TOL``
    of the float64 update made with the card's labels.  (Starting from
    rows of one blob, several centers split it: over the fit, float32 near
    ties steer the trajectory away from a float64 one, so each step is
    held, not the end.)  Returns the final centers, ``(worst label margin
    of a disagreeing row, worst center error)``."""
    from heat_tpu_torch.cluster.kmeans import _assign, _kmeans_mb_step

    k, n = init.shape[0], x.shape[0]
    c = torch.from_numpy(init).to(dev)
    counts = torch.zeros((k, 1), device=dev)
    worst_tie, worst_err = 0.0, 0.0
    for s in range(epochs * -(-n // mb)):
        lo = (s * mb) % (-(-n // mb) * mb)
        xb = x[lo:lo + mb]
        nv = xb.shape[0]
        chunk = torch.zeros((mb, x.shape[1]), device=dev)
        chunk[:nv] = torch.from_numpy(xb).to(dev)
        lab = _assign(chunk[:nv], c).cpu().numpy()
        c64, n64 = c.double().cpu().numpy(), counts.double().cpu().numpy()
        x64 = xb.astype(np.float64)
        d = ((x64[:, None, :] - c64[None]) ** 2).sum(-1)
        off = np.nonzero(lab != d.argmin(1))[0]
        if off.size:
            tie = float(((d[off, lab[off]] - d[off].min(1)) / d[off].min(1).clip(1e-30)).max())
            worst_tie = max(worst_tie, tie)
            check(tie <= KM_TIE, f"mini-batch step {s}: {off.size} labels off the float64 nearest by {tie:.3g}")
        sel = np.eye(k)[lab]
        bs, bc = sel.T @ x64, sel.sum(0)[:, None]
        n2 = n64 + bc
        want = np.where(bc > 0, c64 + (bs - bc * c64) / np.maximum(n2, 1.0), c64)
        _, c, counts = _kmeans_mb_step(chunk, nv, 0, c, counts, mb=mb, k=k)
        err = float(np.abs(c.double().cpu().numpy() - want).max()) / float(np.abs(want).max())
        worst_err = max(worst_err, err)
        check(err <= STREAM_TOL and np.array_equal(counts.cpu().numpy(), n2),
              f"mini-batch step {s}: centers {err:.3g} of their largest from the float64 update")
    return c, (worst_tie, worst_err)


def numpy_minibatch_ista(x: np.ndarray, y: np.ndarray, lam: float, mb: int, epochs: int) -> np.ndarray:
    """The mini-batch ISTA steps in float64, the step from the first
    chunk's largest eigenvalue of ``A^T A / n``."""
    n, f = x.shape
    a0 = np.concatenate([np.ones((min(mb, n), 1)), x[:mb]], axis=1)
    step = 1.0 / np.linalg.eigvalsh(a0.T @ a0 / a0.shape[0])[-1]
    th = np.zeros(f + 1)
    for _ in range(epochs):
        for lo in range(0, n, mb):
            a = np.concatenate([np.ones((min(mb, n - lo), 1)), x[lo:lo + mb]], axis=1)
            t2 = th - step * (a.T @ (a @ th - y[lo:lo + mb]) / a.shape[0])
            th = np.concatenate([t2[:1], np.sign(t2[1:]) * np.maximum(np.abs(t2[1:]) - step * lam, 0.0)])
    return th


def phase_io_stream(torch, htt, cq, dev, data, centers, counted):
    """Phase 13 (see the module docstring).  Returns ``(launches of the
    checkpointed int8_block fits, metrics)``; leaves no plan armed and the
    prefetch policy as it found it."""
    import os
    import shutil
    import tempfile

    from heat_tpu_torch import native
    from heat_tpu_torch.comm._costs import stream_model
    from heat_tpu_torch.io import stream
    from heat_tpu_torch.resilience import elastic, faults
    from heat_tpu_torch.resilience.faults import DeviceLossError, Preempted
    from heat_tpu_torch import telemetry as tel

    check(not faults.any_active() and not tel.is_enabled(), "phase 13 starts with no plan armed")
    metrics = {}
    rows, mb, h, epochs = STREAM_ROWS, STREAM_MB, STREAM_CHUNKS, STREAM_EPOCHS
    x = np.ascontiguousarray(data[:rows])
    y = lasso_target(x).astype(np.float32)
    comm1 = htt.TorchCommunication([dev])
    X1 = htt.array(x, split=0, comm=comm1)
    Y1 = htt.array(y, split=0, comm=comm1)
    tmp = tempfile.mkdtemp(prefix="phase13-")
    has_h5 = htt.io.supports_hdf5()
    launches = {f"blockquant_{fn.__name__.removesuffix('_blocks')}": 0 for fn in counted}
    try:
        # (1) files written and read back on the card, bitwise
        nc, csv = os.path.join(tmp, "blobs.nc"), os.path.join(tmp, "blobs.csv")
        step13(torch, metrics, "save_netcdf", lambda: (htt.save_netcdf(X1, nc, "features"),
                                                        htt.save_netcdf(Y1, nc, "target", mode="a")))
        got = step13(torch, metrics, "load_netcdf", lambda: htt.load_netcdf(nc, "features", split=0, comm=comm1))
        exact(got.numpy(), x, "load_netcdf of save_netcdf")
        check(got.larray.device.type == "cuda", "load_netcdf did not land on the card")
        step13(torch, metrics, "save_csv", lambda: htt.save_csv(X1, csv))
        # (2) the native scanner, timed
        check(native.fastcsv_available(), "the native CSV scanner did not build on this machine")
        got = step13(torch, metrics, "load_csv", lambda: htt.load_csv(csv, split=0, comm=comm1))
        exact(got.numpy(), x, "load_csv of save_csv")
        if has_h5:
            h5 = os.path.join(tmp, "blobs.h5")
            step13(torch, metrics, "save_hdf5", lambda: (htt.save_hdf5(X1, h5, "features"),
                                                          htt.save_hdf5(Y1, h5, "target", mode="a")))
            got = step13(torch, metrics, "load_hdf5", lambda: htt.load_hdf5(h5, "features", split=0, comm=comm1))
            exact(got.numpy(), x, "load_hdf5 of save_hdf5")
            srcs = lambda: (stream.HDF5Source(h5, "features"), stream.HDF5Source(h5, "target"))  # noqa: E731
        else:
            print("phase 13: hdf5 absent, snapshots not run")
            srcs = lambda: (stream.NetCDFSource(nc, "features"), stream.NetCDFSource(nc, "target"))  # noqa: E731
        del got
        metrics["stream_source"] = "hdf5" if has_h5 else "netcdf3"

        # the host's rates behind stream_model's defaults: one read of
        # the 25.6 MB slab from NetCDF-3, one pinned non_blocking copy of
        # it to the card (medians of 5)
        slab_bytes = rows * F * 4
        reads, copies = [], []
        nsrc = stream.NetCDFSource(nc, "features")
        pinned = torch.empty((rows, F), dtype=torch.float32, pin_memory=True)
        dst = torch.empty((rows, F), dtype=torch.float32, device=dev)
        for _ in range(5):
            t0 = time.perf_counter()
            block = nsrc.read(0, rows)
            reads.append(time.perf_counter() - t0)
            pinned.copy_(torch.from_numpy(block))
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            dst.copy_(pinned, non_blocking=True)
            end.record()
            end.synchronize()
            copies.append(start.elapsed_time(end) / 1e3)
        exact(dst.cpu().numpy(), x, "the pinned copy")
        read_gbps = slab_bytes / float(np.median(reads)) / 1e9
        h2d_gbps = slab_bytes / float(np.median(copies)) / 1e9
        metrics["host_read_gbps"], metrics["h2d_gbps"] = read_gbps, h2d_gbps
        print(f"host rates ({card_line()}): NetCDF-3 read of {slab_bytes} B {read_gbps:.3f} GB/s, "
              f"pinned copy to the card {h2d_gbps:.3f} GB/s (medians of 5)")
        del pinned, dst

        # (3) the mini-batch fits: prefetch off and on from the file, and
        # the in-memory twin, bitwise
        Lasso, KMeans = htt.regression.Lasso, htt.cluster.KMeans

        def km(source, mode):
            with stream.prefetch(mode):
                return KMeans(n_clusters=K, mini_batch=mb, max_iter=epochs, random_state=0).fit(source, comm=comm1)

        def ls(sx, sy, mode):
            with stream.prefetch(mode):
                return Lasso(lam=LASSO_LAM, solver="gd", mini_batch=mb, max_iter=epochs).fit(sx, sy, comm=comm1)

        fits = {}
        for mode in ("off", "on"):
            stream.reset_slab_peak()
            fits[f"km_{mode}"] = step13(torch, metrics, f"stream_kmeans_{mode}", lambda: km(srcs()[0], mode))
            metrics[f"slab_peak_{mode}"] = stream.slab_peak()
            stream.reset_slab_peak()
            fits[f"ls_{mode}"] = step13(torch, metrics, f"stream_lasso_{mode}", lambda: ls(*srcs(), mode))
            metrics[f"slab_peak_lasso_{mode}"] = stream.slab_peak()
        fits["km_mem"] = step13(torch, metrics, "stream_kmeans_memory", lambda: km(X1, "off"))
        fits["ls_mem"] = step13(torch, metrics, "stream_lasso_memory", lambda: ls(X1, Y1, "off"))
        c_off = fits["km_off"].cluster_centers_.larray
        t_off = fits["ls_off"].theta.larray
        check(bitwise_equal(fits["km_on"].cluster_centers_.larray, c_off), "mini-batch KMeans: prefetch on != off")
        check(bitwise_equal(fits["km_mem"].cluster_centers_.larray, c_off), "mini-batch KMeans: in-memory != streamed")
        check(bitwise_equal(fits["ls_on"].theta.larray, t_off), "mini-batch Lasso: prefetch on != off")
        check(bitwise_equal(fits["ls_mem"].theta.larray, t_off), "mini-batch Lasso: in-memory != streamed")
        check(fits["km_off"].n_iter_ == epochs * h and fits["ls_off"].n_iter == epochs * h, "mini-batch step counts")
        check((metrics["slab_peak_off"], metrics["slab_peak_on"]) == (1, 2)
              and (metrics["slab_peak_lasso_off"], metrics["slab_peak_lasso_on"]) == (1, 2),
              "slab peaks off / on != 1 / 2")
        init = x[np.sort(np.random.default_rng(0).choice(mb, size=K, replace=False))]
        replay, (c_tie, c_err) = hold_minibatch_kmeans(torch, dev, x, init, mb, epochs)
        check(bitwise_equal(replay, c_off), "mini-batch KMeans != its chunk updates replayed one by one")
        th64 = numpy_minibatch_ista(x.astype(np.float64), y.astype(np.float64), LASSO_LAM, mb, epochs)
        t_err = float(np.abs(t_off.cpu().numpy().reshape(-1) - th64).max())
        check(t_err <= STREAM_TOL * float(np.abs(th64).max()),
              f"mini-batch Lasso {t_err:.3g} from its float64 replay > {STREAM_TOL} x {np.abs(th64).max():.3g}")
        # wall time: medians of alternating rounds (a single call moves 2x
        # with the host), the profiled calls above giving device time
        runs = {"kmeans_off": lambda: km(srcs()[0], "off"), "kmeans_on": lambda: km(srcs()[0], "on"),
                "kmeans_memory": lambda: km(X1, "off"), "lasso_off": lambda: ls(*srcs(), "off"),
                "lasso_on": lambda: ls(*srcs(), "on"), "lasso_memory": lambda: ls(X1, Y1, "off")}
        walls = {key: [] for key in runs}
        for _ in range(STREAM_ROUNDS):
            for key, fn in runs.items():
                walls[key].append(wall_ms(fn, reps=1))
        for key, times in walls.items():
            metrics[f"stream_{key}_wall_ms"] = float(np.median(times))
            metrics[f"stream_{key}_wall_range_ms"] = [min(times), max(times)]
        for key in ("kmeans", "lasso"):
            metrics[f"stream_{key}_rows_per_s"] = epochs * rows / metrics[f"stream_{key}_on_wall_ms"] * 1e3
            metrics[f"stream_{key}_overlap"] = (metrics[f"stream_{key}_off_wall_ms"]
                                                / metrics[f"stream_{key}_on_wall_ms"])
            print(f"  {key}: wall medians of {STREAM_ROUNDS} rounds off / on / in memory "
                  + " / ".join(f"{metrics[f'stream_{key}_{m}_wall_ms']:.3f}" for m in ("off", "on", "memory"))
                  + " ms")

        # stream_model from this run: the read and copy spans of one
        # epoch under telemetry, the chunk update timed alone; an epoch
        # held whole first, so the spanned one allocates nothing new
        from heat_tpu_torch.cluster.kmeans import _kmeans_mb_step

        with stream.prefetch("off"):
            chunks = list(stream.stream_chunks(srcs()[0], mb, 0, h, comm=comm1))
            del chunks
            tel.enable()
            tel.reset()
            try:
                chunks = [(c[0], nv) for c, nv in stream.stream_chunks(srcs()[0], mb, 0, h, comm=comm1)]
                torch.cuda.synchronize()
                snap = tel.snapshot()
            finally:
                tel.disable()
                tel.reset()
        read_s = snap["spans"]["io:read"]["total_s"]
        h2d_s = snap["spans"]["io:h2d"]["total_s"]
        carry = (0, torch.from_numpy(init).to(dev), torch.zeros((K, 1), device=dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for chunk, nv in chunks:
            carry = _kmeans_mb_step(chunk, nv, *carry, mb=mb, k=K)
        torch.cuda.synchronize()
        compute_ms = (time.perf_counter() - t0) * 1e3 / h
        chunk_bytes = mb * F * 4
        model = stream_model(chunk_bytes, h, compute_ms, read_gbps=chunk_bytes * h / read_s / 1e9,
                             h2d_gbps=chunk_bytes * h / h2d_s / 1e9, prefetch=True)
        metrics["stream_model_speedup"] = model["speedup"]
        metrics["stream_model_bound"] = model["bound"]
        metrics["stream_compute_ms_per_chunk"] = compute_ms
        del chunks
        print(f"mini-batch fits, {rows} x {F} from {metrics['stream_source']}, {h} chunks of {mb} rows, {epochs} "
              f"epochs: prefetch on, off and in memory bitwise; slab peaks 1 / 2; KMeans's chunk updates "
              f"within {c_err:.3g} of float64 (labels off only at near ties, worst {c_tie:.3g}), Lasso "
              f"{t_err:.3g} from its float64 replay; KMeans {metrics['stream_kmeans_rows_per_s']:.0f} rows/s, "
              f"Lasso {metrics['stream_lasso_rows_per_s']:.0f} rows/s (prefetch on); overlap measured "
              f"{metrics['stream_kmeans_overlap']:.3f} (KMeans), {metrics['stream_lasso_overlap']:.3f} (Lasso), "
              f"stream_model predicts {model['speedup']:.3f} ({model['bound']}-bound: read "
              f"{model['read_ms_per_chunk']:.3f} + copy {model['h2d_ms_per_chunk']:.3f} ms against compute "
              f"{compute_ms:.3f} ms a chunk)")

        # (4) snapshots, resume and elastic recovery (they need HDF5)
        if has_h5:
            comm4 = htt.TorchCommunication([dev] * POSITIONS)
            X4 = htt.array(data, split=0, comm=comm4)
            init4 = htt.array(centers, comm=comm4)
            yb = lasso_target(data).astype(np.float32)
            Y4 = htt.array(yb, split=0, comm=comm4)
            snap_km, snap_ls = os.path.join(tmp, "km.h5"), os.path.join(tmp, "ls.h5")

            def kmq(**kw):
                return KMeans(n_clusters=K, init=init4, max_iter=ITERS, tol=-1.0, **kw)

            def lsq(**kw):
                return Lasso(lam=LASSO_LAM, max_iter=LASSO_STEPS, tol=-1.0, solver="gd", **kw)

            def counts():
                torch.cuda.synchronize()
                return {f"blockquant_{fn.__name__.removesuffix('_blocks')}": fn.launches for fn in counted}

            def killed(make, every, path, *args):
                with faults.inject("preempt", site="iteration", nth=CKPT_KILL_AT):
                    try:
                        make(checkpoint_every=every, checkpoint_path=path).fit(*args)
                    except Preempted:
                        return True
                return False

            with cq.collective_precision("int8_block"):
                for fn in counted:
                    fn.launches = 0
                clean_km = kmq().fit(X4)
                plain_km = counts()
                for fn in counted:
                    fn.launches = 0
                check(step13(torch, metrics, "kmeans_int8_killed", lambda: killed(kmq, CKPT_KM_EVERY, snap_km, X4)),
                      "the seeded preemption did not stop the KMeans fit")
                res_km = step13(torch, metrics, "kmeans_int8_resumed", lambda: kmq(
                    checkpoint_every=CKPT_KM_EVERY, checkpoint_path=snap_km).fit(X4, resume=True))
                seg_km = counts()
                for fn in counted:
                    fn.launches = 0
                clean_ls = lsq().fit(X4, Y4)
                plain_ls = counts()
                for fn in counted:
                    fn.launches = 0
                check(step13(torch, metrics, "lasso_int8_killed",
                             lambda: killed(lsq, CKPT_LASSO_EVERY, snap_ls, X4, Y4)),
                      "the seeded preemption did not stop the Lasso fit")
                res_ls = step13(torch, metrics, "lasso_int8_resumed", lambda: lsq(
                    checkpoint_every=CKPT_LASSO_EVERY, checkpoint_path=snap_ls).fit(X4, Y4, resume=True))
                seg_ls = counts()
            check(bitwise_equal(res_km.cluster_centers_.larray, clean_km.cluster_centers_.larray)
                  and res_km.n_iter_ == ITERS, "resumed int8 KMeans != the uninterrupted fit, bitwise")
            check(bitwise_equal(res_ls.theta.larray, clean_ls.theta.larray) and res_ls.n_iter == LASSO_STEPS,
                  "resumed int8 Lasso gd != the uninterrupted fit, bitwise")
            check(seg_km == plain_km, f"killed + resumed KMeans launches {seg_km} != uninterrupted {plain_km}")
            steps = LASSO_STEPS
            expected = {"blockquant_quantize": 2 * steps, "blockquant_dequantize": steps,
                        "blockquant_dequantize_fma": steps,
                        "blockquant_dequantize_add_quantize": (POSITIONS - 1) * steps}
            check(seg_ls == plain_ls == expected, f"killed + resumed Lasso launches {seg_ls}, uninterrupted "
                  f"{plain_ls}, phase 7's {expected}")
            for name in launches:
                launches[name] = seg_km[name] + seg_ls[name]

            # elastic: a mini-batch KMeans at 4 positions loses a position
            # after its first epoch's snapshot, recovers at 2
            comm2 = htt.TorchCommunication([dev] * 2)
            X2 = htt.array(x, split=0, comm=comm2)
            snap_mb = os.path.join(tmp, "mb.h5")
            clean2 = KMeans(n_clusters=K, mini_batch=mb, max_iter=epochs, random_state=0).fit(X2)
            mb_est = KMeans(n_clusters=K, mini_batch=mb, max_iter=epochs, random_state=0,
                            checkpoint_every=h, checkpoint_path=snap_mb)
            try:
                with faults.inject("device_loss", site="iteration", nth=1):
                    mb_est.fit(htt.array(x, split=0, comm=comm4))
                check(False, "the seeded device loss did not stop the mini-batch fit")
            except DeviceLossError:
                pass
            rec = step13(torch, metrics, "elastic_recover_4_to_2",
                         lambda: elastic.recover(mb_est, snap_mb, X2, comm=comm2))
            check(bitwise_equal(rec.cluster_centers_.larray, clean2.cluster_centers_.larray),
                  "elastic recovery 4 -> 2 != the uninterrupted 2-position fit, bitwise")

            # one estimator saved and loaded
            est_path = os.path.join(tmp, "kmeans.h5")
            step13(torch, metrics, "save_estimator", lambda: htt.save_estimator(res_km, est_path))
            loaded = step13(torch, metrics, "load_estimator", lambda: htt.load_estimator(est_path))
            check(bitwise_equal(loaded.cluster_centers_.larray, res_km.cluster_centers_.larray)
                  and bool(torch.equal(loaded.predict(X1).larray, res_km.predict(X1).larray)),
                  "the loaded estimator's centers or predictions differ")
            print(f"snapshots: int8 KMeans ({ITERS} steps, every {CKPT_KM_EVERY}) and int8 Lasso gd ({LASSO_STEPS} "
                  f"steps, every {CKPT_LASSO_EVERY}) at {POSITIONS} positions killed after snapshot {CKPT_KILL_AT} "
                  f"and resumed: bitwise the uninterrupted fits; launches KMeans {seg_km}, Lasso {seg_ls} (phase "
                  f"7's); elastic recover 4 -> 2 of the mini-batch KMeans bitwise the 2-position fit; an "
                  f"estimator saved and loaded")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(not faults.any_active(), "phase 13 left a plan armed")
    return launches, metrics


# ---------------------------------------------------------------------- #
# phase 14: the compiled-program layer                                     #
# ---------------------------------------------------------------------- #
def _moments14(a):
    import heat_tpu_torch as htt

    return htt.mean(a, axis=0), htt.std(a, axis=0)


def _attention14(q, k, v):
    import importlib

    fa = importlib.import_module("heat_tpu_torch.parallel.flash_attention")
    return fa.flash_attention(q, k, v, causal=True)


def _forces_value14(a):
    return a * float(a.sum())


def replay_profile(torch, fn, tries: int = 3):
    """One call of ``fn`` (after a warm-up) under ``torch.profiler``:
    ``(device ms, host synchronize calls, cudaGraphLaunch calls, device
    kernel counts by name)``, the synchronize calls less those of the
    profiler's own fence.  The profiler drops a whole call's kernels now
    and then (PERF.md), never adds any: of ``tries`` profiled calls the
    one with the most device time is kept, and each kernel's count is
    its most over the tries (the call with the most device time has
    been seen to lose one of its two quantize kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def one(f):
        f()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            f()
            torch.cuda.synchronize()
        total, syncs, graphs, kernels = 0.0, 0, 0, {}
        for evt in prof.key_averages():
            if evt.device_type != DeviceType.CUDA:
                if "Synchronize" in evt.key:
                    syncs += int(evt.count)
                if evt.key == "cudaGraphLaunch":
                    graphs += int(evt.count)
                continue
            if evt.key.startswith("Activity Buffer"):
                continue
            us = getattr(evt, "self_device_time_total", None)
            total += float(us if us is not None else getattr(evt, "self_cuda_time_total", 0.0))
            kernels[evt.key] = kernels.get(evt.key, 0) + int(evt.count)
        return total / 1e3, syncs, graphs, kernels

    runs = [one(fn) for _ in range(tries)]
    ms, syncs, graphs, _ = max(runs, key=lambda r: r[0])
    kernels = {k: max(r[3].get(k, 0) for r in runs) for r in runs for k in r[3]}
    return ms, syncs - one(lambda: None)[1], graphs, kernels


def ring_kernels(kernels: dict) -> dict:
    """Launches of B1, the hop and B2 among profiled kernel names."""
    out = {}
    for name, symbols in TRACE_SYMBOLS.items():
        out[name] = sum(n for key, n in kernels.items() if any(sym in key for sym in symbols))
    return out


def _svd_probe_code(m: int, n: int) -> str:
    return (
        "import numpy as np, torch, heat_tpu_torch as htt\n"
        "import importlib\n"
        "S = importlib.import_module('heat_tpu_torch.core.linalg.svd')\n"
        "dev = torch.device('cuda', 0)\n"
        "comm = htt.TorchCommunication([dev])\n"
        f"a = htt.array(np.random.default_rng(0).standard_normal(({m}, {n})).astype(np.float32),"
        " split=0, comm=comm)\n"
        "htt.linalg.svd(a)\n"
        "assert htt.fuse.cache_size() == 0, 'svd built a fused program'\n"
        "try:\n"
        "    htt.fuse(S._svd_pipeline)(a, 0, a.dtype, True)\n"
        "    print('CAPTURED')\n"
        "except htt.FuseTraceError as e:\n"
        "    print('FUSETRACEERROR ' + str(e).splitlines()[0])\n"
        "except RuntimeError as e:\n"
        "    import traceback\n"
        "    first = e.__cause__.__context__ if e.__cause__ is not None else None\n"
        "    frames = traceback.extract_tb(first.__traceback__) if first is not None else []\n"
        "    ours = [f for f in frames if 'heat_tpu_torch' in f.filename]\n"
        "    at = f'{ours[-1].filename.split(\"heat_tpu_torch/\")[-1]}:{ours[-1].lineno} {ours[-1].line}' if ours else '?'\n"
        "    print('RAISED ' + str(first or e).splitlines()[0] + ' | at ' + at)\n"
    )


def graph_pool_bytes(torch) -> int:
    """Bytes reserved in graph memory pools (segments outside the caching
    allocator's default pool, which no eager op can use)."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) != (0, 0))


def _b3_replay_probe_code(shape, tries: int) -> str:
    """Phase 14's B3 program alone in a fresh process, its replays under
    the profiler (which drops B3's kernels in the full run, PERF.md)."""
    return (
        "import json, importlib\n"
        "import numpy as np, torch\n"
        "from torch.autograd import DeviceType\n"
        "from torch.profiler import ProfilerActivity, profile\n"
        "import heat_tpu_torch as htt\n"
        "fa = importlib.import_module('heat_tpu_torch.parallel.flash_attention')\n"
        "def attention(q, k, v):\n"
        "    return fa.flash_attention(q, k, v, causal=True)\n"
        "dev = torch.device('cuda', 0)\n"
        "rng = np.random.default_rng(14)\n"
        f"q, k, v = [torch.from_numpy(rng.normal(size={tuple(shape)}).astype(np.float32)).to(dev)"
        ".to(torch.bfloat16) for _ in range(3)]\n"
        "fused = htt.fuse(attention)\n"
        "out = fused(q, k, v)\n"
        "ok = bool(torch.equal(out.view(torch.int16), attention(q, k, v).view(torch.int16)))\n"
        "rows = []\n"
        f"for _ in range({tries}):\n"
        "    torch.cuda.synchronize()\n"
        "    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:\n"
        "        fused(q, k, v)\n"
        "        torch.cuda.synchronize()\n"
        "    ev = prof.key_averages()\n"
        "    rows.append([sum(int(e.count) for e in ev if e.device_type == DeviceType.CUDA"
        " and 'flash_kernel' in e.key), sum(int(e.count) for e in ev if e.key == 'cudaGraphLaunch')])\n"
        "print('B3REPLAY ' + json.dumps({'bitwise': ok, 'replays': rows}))\n"
    )


def phase_compiled(torch, htt, cq, dev, data, labels, counted, card):
    """Phase 14 (see the module docstring): the fused library programs, the
    int8_block pipeline and B3 in a graph, a guarded program, AOT bundles
    and the no-fallback contract.  Returns ``(launches, metrics)``."""
    import pickle

    from heat_tpu_torch.cluster import _kcluster
    from heat_tpu_torch.core import aot
    from heat_tpu_torch.core import statistics as st
    from heat_tpu_torch.naive_bayes import gaussianNB as gnb
    from heat_tpu_torch.regression import lasso as plasso
    from heat_tpu_torch.resilience import guards, incidents
    from heat_tpu_torch.telemetry import _core as tel

    fa = __import__("importlib").import_module("heat_tpu_torch.parallel.flash_attention")
    metrics = {}
    for f in counted:
        f.launches = 0
    fa.flash_attention.launches = 0
    htt.fuse.clear_cache()

    def program(name, fused, eager, extra="", counter=None):
        """Build ``fused`` (timed, peak memory; ``counter()`` read around the
        build, for a kernel wrapper's launches), hold it bitwise to
        ``eager``, then time and profile both."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        n0 = counter() if counter else 0
        t0 = time.perf_counter()
        out = fused()
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
        built = counter() - n0 if counter else None
        peak_mb = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        want = eager()
        outs = out if isinstance(out, tuple) else (out,)
        wants = want if isinstance(want, tuple) else (want,)
        for o, w in zip(outs, wants):
            o = o.larray if hasattr(o, "larray") else o
            w = w.larray if hasattr(w, "larray") else w
            check(bitwise_equal(o, w), f"phase 14 {name}: fused != eager, bitwise")
        wall, ewall = wall_ms(fused), wall_ms(eager)
        dev_ms, syncs, graphs, kernels = replay_profile(torch, fused)
        edev_ms, esyncs, _, _ = replay_profile(torch, eager)
        check(graphs == 1, f"phase 14 {name}: {graphs} cudaGraphLaunch calls a call, want 1")
        row = {"build_ms": build_ms, "peak_mb": peak_mb, "wall_ms": wall, "device_ms": dev_ms,
               "syncs": syncs, "graph_launches": graphs, "eager_wall_ms": ewall,
               "eager_device_ms": edev_ms, "eager_syncs": esyncs}
        metrics[f"fuse_{name}"] = row
        eread = f"{edev_ms:.4f} ms device" if edev_ms else "device time not read (the profiler dropped it)"
        row["built_launches"] = built
        print(f"  {name}: build {build_ms:.1f} ms (peak +{peak_mb:.1f} MiB), fused {wall:.3f} ms wall / "
              f"{dev_ms:.4f} ms device / {syncs} syncs / {graphs} graph launch, eager {ewall:.3f} ms wall / "
              f"{eread} / {esyncs} syncs; bitwise{extra} [{card}]")
        return kernels, built

    # ---------------------------------------------------------------- 14.1
    comm1 = htt.TorchCommunication([dev])
    X = htt.array(data, split=0, comm=comm1)
    # one row of each blob (the blobs are stacked in order) as the centers
    init = htt.array(np.ascontiguousarray(data[:: N // K][:K]), comm=comm1)
    km = htt.cluster.KMeans(n_clusters=K, init=init, max_iter=2, tol=-1.0).fit(X)
    nb = htt.naive_bayes.GaussianNB().fit(X, htt.array(labels, split=0, comm=comm1))
    la = htt.regression.Lasso(lam=LASSO_LAM, max_iter=3).fit(X, htt.array(lasso_target(data), split=0,
                                                                          comm=comm1))
    theta, sigma, prior = (torch.as_tensor(t, device=dev) for t in nb._fit_params())
    classes = torch.as_tensor(np.asarray(nb.classes_), device=dev)
    library = [
        ("kmeans_predict", lambda: km.predict(X),
         lambda: _kcluster._assign_program(X, km.cluster_centers_, km._metric)),
        ("nb_predict", lambda: nb.predict(X),
         lambda: gnb._nb_predict_program(X, theta, sigma, prior, classes)),
        ("nb_predict_log_proba", lambda: nb.predict_log_proba(X),
         lambda: gnb._nb_log_proba_program(X, theta, sigma, prior)),
        ("nb_predict_proba", lambda: nb.predict_proba(X),
         lambda: gnb._nb_proba_program(X, theta, sigma, prior)),
        ("lasso_predict", lambda: la.predict(X), lambda: plasso._lasso_predict_program(X, la.theta)),
        ("kurtosis", lambda: htt.kurtosis(X, axis=0), lambda: st._kurtosis_program(X, 0, True, True)),
        ("skew", lambda: htt.skew(X, axis=0), lambda: st._skew_program(X, 0, True)),
    ]
    for name, fused, eager in library:
        program(name, fused, eager)
    metrics["fuse_cache_bytes_library"] = htt.fuse.cache_bytes(dev)
    print(f"  the {htt.fuse.cache_size()} cached programs hold {metrics['fuse_cache_bytes_library'] / 2 ** 20:.1f} "
          f"MiB (static inputs and the graph pool; default limit "
          f"{torch.cuda.get_device_properties(dev).total_memory // 8 / 2 ** 30:.1f} GiB) [{card}]")
    # the bounded cache: KMeans.predict over 8 row counts of the blobs
    limit = FUSE_BOUND_LIMIT
    sizes = [N - FUSE_BOUND_STEP * i for i in (3, 0, 6, 1, 7, 2, 5, 4)]
    xs = [htt.array(data[:n], split=0, comm=comm1) for n in sizes]
    unbounded = sum(x.larray.numel() * 4 for x in xs)
    prev_limit = htt.fuse.set_cache_limit(limit)
    htt.fuse.clear_cache()
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        pools0, allocated0 = graph_pool_bytes(torch), torch.cuda.memory_allocated(dev)
        reserved0 = torch.cuda.memory_reserved(dev)
        held = pools = allocated = 0
        for x in xs:
            got = km.predict(x)
            check(bitwise_equal(got.larray, _kcluster._assign_program(x, km.cluster_centers_, km._metric).larray),
                  "phase 14 bounded cache: fused KMeans.predict != eager, bitwise")
            del got
            held = max(held, htt.fuse.cache_bytes(dev))
            pools = max(pools, graph_pool_bytes(torch) - pools0)
            allocated = max(allocated, torch.cuda.memory_allocated(dev) - allocated0)
        kept = htt.fuse.cache_size()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev) - reserved0
    finally:
        htt.fuse.set_cache_limit(prev_limit)
        htt.fuse.clear_cache()
    check(held <= limit and max(pools, allocated, reserved) <= limit + FUSE_BOUND_SLACK,
          f"phase 14 bounded cache: held {held >> 20}, graph pools {pools >> 20}, allocated {allocated >> 20}, "
          f"reserved {reserved >> 20} MiB over a {limit >> 20} MiB limit")
    metrics["fuse_bounded"] = {"limit_mb": limit / 2 ** 20, "held_max_mb": held / 2 ** 20,
                               "graph_pools_max_mb": pools / 2 ** 20, "allocated_max_mb": allocated / 2 ** 20,
                               "reserved_after_mb": reserved / 2 ** 20, "programs_kept": kept,
                               "static_inputs_of_all_mb": unbounded / 2 ** 20}
    print(f"  bounded cache: KMeans.predict on {len(sizes)} row counts ({min(sizes)}-{max(sizes)}) under a "
          f"{limit >> 20} MiB limit: {kept} programs kept; at most {held / 2 ** 20:.1f} MiB held, "
          f"{pools / 2 ** 20:.1f} MiB in graph pools, {allocated / 2 ** 20:.1f} MiB more allocated; "
          f"{reserved / 2 ** 20:.1f} MiB more reserved once the allocator lets its free blocks go (the 8 "
          f"programs' static inputs alone: {unbounded / 2 ** 20:.1f} MiB); bitwise [{card}]")
    del xs
    labels_ok = float((km.predict(X).numpy() == km.labels_.numpy()).mean())
    check(labels_ok >= 0.9999, f"phase 14 fused KMeans.predict agrees with the fit on {labels_ok}")
    proc = subprocess.run([sys.executable, "-c", _svd_probe_code(QR_M, QR_N)], capture_output=True,
                          text=True, timeout=300)
    probe = (proc.stdout.strip().splitlines() or [proc.stderr.strip()[-300:]])[-1]
    check(proc.returncode == 0 and probe.startswith("RAISED"),
          f"phase 14 svd pipeline capture probe: rc {proc.returncode}, {probe}")
    metrics["svd_capture"] = probe
    print(f"  svd {QR_M} x {QR_N}: left unfused; its capture: {probe} [{card}]")

    # ---------------------------------------------------------------- 14.2
    comm4 = htt.TorchCommunication([dev] * POSITIONS)
    gen = torch.Generator(device=dev).manual_seed(14)
    X14 = htt.array(torch.randn((P14_ROWS, PAYLOAD), generator=gen, device=dev), split=0, comm=comm4)
    fused_moments = htt.fuse(_moments14)
    with cq.collective_precision("int8_block"):
        kernels, _ = program("int8_moments", lambda: fused_moments(X14), lambda: _moments14(X14),
                             extra=", 4 positions")
        _, _, _, ekernels = replay_profile(torch, lambda: _moments14(X14))
        in_replay, in_eager = ring_kernels(kernels), ring_kernels(ekernels)
        check(in_replay == in_eager == P14_RING,
              f"phase 14 int8 kernels in the replay {in_replay}, eager {in_eager}, want {P14_RING}")
    metrics["int8_moments_replay_kernels"] = in_replay
    print(f"  int8_moments: the replay launches {in_replay} (eager {in_eager}) [{card}]")

    # ---------------------------------------------------------------- 14.3
    incidents.clear_incident_log()
    with cq.collective_precision("int8_block"), guards.guard("degrade"):
        fused_moments(X14)
        _, syncs, graphs, _ = replay_profile(torch, lambda: fused_moments(X14))
        check(syncs == 1 and graphs == 1 and not incidents.incident_log(),
              f"phase 14 guarded healthy call: {syncs} syncs, {graphs} graph launches, "
              f"{len(incidents.incident_log())} incidents")
        bad = X14.larray.clone()
        bad[3, 7] = float("nan")
        Xbad = htt.array(bad, split=0, comm=comm4)
        got = fused_moments(Xbad)
    log = [(e.site, e.action) for e in incidents.incident_log()]
    check(log == [("fuse:_moments14", "degraded"), ("fuse:_moments14", "unrecoverable")],
          f"phase 14 NaN input incidents {log}")
    for g, w in zip(got, _moments14(Xbad)):
        check(bool(torch.equal(torch.isnan(g.larray), torch.isnan(w.larray))) and bitwise_equal(
            torch.nan_to_num(g.larray), torch.nan_to_num(w.larray)), "phase 14 NaN input: not the exact re-run")
    incidents.clear_incident_log()
    limit = None
    for seed in range(8):
        gen.manual_seed(100 + seed)
        Xs = htt.array(torch.randn((P14_ROWS, PAYLOAD), generator=gen, device=dev), split=0, comm=comm4)
        exact_max = max(float(t.larray.abs().max()) for t in _moments14(Xs))
        with cq.collective_precision("int8_block"):
            quant_max = max(float(t.larray.abs().max()) for t in _moments14(Xs))
        if quant_max > exact_max:
            limit = (exact_max + quant_max) / 2
            break
    check(limit is not None, "phase 14: no seed separates the quantized moments from the exact ones")
    with cq.collective_precision("int8_block"), guards.guard("degrade", overflow_limit=limit):
        got = fused_moments(Xs)
    log = [(e.site, e.action) for e in incidents.incident_log()]
    check(log == [("fuse:_moments14", "degraded")], f"phase 14 over-limit incidents {log}")
    for g, w in zip(got, _moments14(Xs)):
        check(bitwise_equal(g.larray, w.larray), "phase 14 over-limit: not the exact re-run, bitwise")
    incidents.clear_incident_log()
    metrics["guarded_healthy_syncs"] = syncs
    print(f"  guarded int8_moments: healthy {syncs} sync a call, no incident; NaN input: the exact re-run, "
          f"incidents degraded + unrecoverable; over the limit {limit:.6g}: one incident, the exact result "
          f"bitwise [{card}]")
    del Xbad, bad, Xs

    # ---------------------------------------------------------------- 14.4
    q, k, v = attn_inputs((1, ATTN_S, ATTN_H, ATTN_D), torch.bfloat16, 14, dev)
    fused_attention = htt.fuse(_attention14)
    kernels, built = program("flash_attention_bf16_causal", lambda: fused_attention(q, k, v),
                             lambda: _attention14(q, k, v), counter=lambda: fa.flash_attention.launches)
    # the build launches B3 twice, the warm-up and the capture's recording:
    # the graph holds one kernel node, which every replay launches once
    check(built == 2, f"phase 14 B3 launches while building the fused program: {built}, want 2")
    seen = sum(n for key, n in kernels.items() if "flash_kernel" in key)
    # the profiler drops B3's kernels in the full run: the replay's kernel
    # is read in a process of its own
    proc = subprocess.run([sys.executable, "-c", _b3_replay_probe_code((1, ATTN_S, ATTN_H, ATTN_D), 3)],
                          capture_output=True, text=True, timeout=300)
    line = next((x for x in proc.stdout.splitlines() if x.startswith("B3REPLAY ")), None)
    check(proc.returncode == 0 and line is not None,
          f"phase 14 B3 replay probe: rc {proc.returncode}, {proc.stderr.strip()[-300:]}")
    probe = json.loads(line.removeprefix("B3REPLAY "))
    replays = probe["replays"]
    check(probe["bitwise"] and all(g == 1 for _, g in replays) and max(n for n, _ in replays) == 1,
          f"phase 14 B3 replay probe: {probe} (want bitwise, 1 graph launch and 1 flash kernel a replay)")
    metrics["flash_kernels_captured"] = built - 1
    metrics["flash_kernels_a_replay"] = max(n for n, _ in replays)
    metrics["flash_kernels_profiled_in_full_run"] = seen
    print(f"  B3 in a graph: {built - 1} kernel captured; alone, the profiler reads "
          f"{[n for n, _ in replays]} flash kernels in 3 replays of one graph launch each (in the full run "
          f"{seen}) [{card}]")

    # ---------------------------------------------------------------- 14.5
    calls = [fused for _, fused, _ in library]
    with aot.capture_programs() as cap:
        before = [c() for c in calls]
    bundles = pickle.loads(pickle.dumps(aot.export_programs(cap)))
    check(len(bundles) == len(calls), f"phase 14 exported {len(bundles)} bundles of {len(calls)}")
    htt.fuse.clear_cache()
    t0 = time.perf_counter()
    installed = aot.install_programs(bundles, comm=comm1)
    torch.cuda.synchronize()
    install_ms = (time.perf_counter() - t0) * 1e3
    check(installed == len(calls), f"phase 14 installed {installed} of {len(calls)}")
    tel.reset()
    tel.enable()
    try:
        after = [c() for c in calls]
        counters = tel.snapshot()["counters"]
    finally:
        tel.disable()
        tel.reset()
    check(counters.get("fuse.cache.misses", 0) == 0 and counters.get("fuse.cache.hits") == len(calls),
          f"phase 14 after install: {counters.get('fuse.cache.misses', 0)} misses")
    for b, a in zip(before, after):
        check(bitwise_equal(a.larray, b.larray), "phase 14 installed program != the pre-export one, bitwise")
    other = [dict(bundles[0], fingerprint=bundles[0]["fingerprint"][:-1] + (("other",),))]
    check(aot.install_programs(other, comm=comm1) == 0, "phase 14 a bundle of another fingerprint installed")
    metrics["aot_install_ms"] = install_ms
    print(f"  AOT: {installed} programs installed in {install_ms:.1f} ms, 0 misses on the next calls, "
          f"bitwise; another fingerprint skipped [{card}]")

    # ---------------------------------------------------------------- 14.6
    try:
        htt.fuse(_forces_value14)(X)
        raised = False
    except htt.FuseTraceError:
        raised = True
    check(raised, "phase 14: float() on a traced DNDarray did not raise FuseTraceError")

    torch.cuda.synchronize()
    launches = {f"blockquant_{f.__name__.removesuffix('_blocks')}": f.launches for f in counted}
    launches["flash_attention"] = fa.flash_attention.launches
    return launches, metrics


# --------------------------------------------------------------------- #
# phase 15: planned redistribution                                        #
# --------------------------------------------------------------------- #
def pieces_replay(torch, x, p: int, src: int, dst: int, quant, dequant):
    """The reference's rotation schedule replayed piece by piece on a
    true-shape tensor split at ``src`` over ``p`` positions, resplit to
    ``dst``: the destination axis padded to ``p * ceil(n/p)``, every piece
    (source block ``s`` restricted to destination block ``d != s``)
    flattened in its own row-major order, zero-padded to a multiple of
    BLOCK (at least one), encoded by ``quant`` and decoded by ``dequant``;
    diagonal pieces kept.  One ``quant`` and one ``dequant`` call a piece."""
    n_d = int(x.shape[dst])
    w_d, w_s = -(-n_d // p), int(x.shape[src]) // p
    pads = [0] * (2 * x.ndim)
    pads[2 * (x.ndim - 1 - dst) + 1] = p * w_d - n_d
    xp = torch.constant_pad_nd(x, pads)
    out = xp.clone()
    for s in range(p):
        for d in range(p):
            if s == d:
                continue
            piece = xp.narrow(src, s * w_s, w_s).narrow(dst, d * w_d, w_d)
            flat = piece.reshape(-1).to(torch.float32)
            n = flat.numel()
            flat = torch.nn.functional.pad(flat, (0, max(BLOCK, -(-n // BLOCK) * BLOCK) - n))
            dec = dequant(*quant(flat))[:n].reshape(piece.shape).to(x.dtype)
            out.narrow(src, s * w_s, w_s).narrow(dst, d * w_d, w_d).copy_(dec)
    return out


def peak_bytes(torch, fn) -> int:
    """Bytes ``fn()`` allocates at its peak above what was live before."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return int(peak)


def phase_redistribute(torch, htt, cq, dev, data, counted, card):
    """Phase 15 (see the module docstring).  Returns ``(launches, metrics)``."""
    from heat_tpu_torch.comm import redistribute as rd

    metrics = {}
    rng = np.random.default_rng(15)
    small = rng.standard_normal(RESPLIT_SHAPE).astype(np.float32)
    wide = rng.standard_normal(GRID_PLAN_SHAPE).astype(np.float32)
    plain_q = lambda f: cq.quantize_blocks_plain(f.reshape(-1, BLOCK))  # noqa: E731
    comms = {p: htt.TorchCommunication([dev] * p) for p in RESPLIT_POSITIONS}
    grids = {m: htt.grid_comm(m, [dev] * (m[0] * m[1])) for m in GRID_MESHES}
    y_np = rng.standard_normal(data.shape).astype(np.float32)
    inputs = {p: htt.array(small, split=0, comm=comms[p]) for p in RESPLIT_POSITIONS}
    blobs = htt.array(data, split=0, comm=comms[4])
    y_blobs = htt.array(y_np, split=1, comm=comms[4])
    gin = {m: htt.array(wide, splits=(0, 1), comm=grids[m]) for m in GRID_MESHES}

    # the main path: every call once, the counts set to 0 just before
    calls = []
    for p in RESPLIT_POSITIONS:
        calls.append((f"resplit_2048x512_{p}pos_exact", "f32", lambda p=p: htt.resplit(inputs[p], 1)))
        calls.append((f"resplit_2048x512_{p}pos_int8", "int8_block", lambda p=p: htt.resplit(inputs[p], 1)))
    calls.append(("resplit_blobs_4pos_int8", "int8_block", lambda: htt.resplit(blobs, 1)))
    calls.append(("mixed_add_blobs_4pos_int8", "int8_block", lambda: blobs + y_blobs))
    for m in GRID_MESHES:
        tag = f"{m[0]}x{m[1]}"
        calls.append((f"grid_resplit_4096x512_{tag}_exact", "f32", lambda m=m: htt.resplit(gin[m], (1, 0))))
        calls.append((f"grid_resplit_4096x512_{tag}_int8", "int8_block", lambda m=m: htt.resplit(gin[m], (1, 0))))
    for f in counted:
        f.launches = 0
    results, per_call = {}, {}
    for key, mode, fn in calls:
        before = [f.launches for f in counted]
        with cq.collective_precision(mode):
            results[key] = fn()
        per_call[key] = [f.launches - b for f, b in zip(counted, before)]
    torch.cuda.synchronize()
    launches = {f"blockquant_{f.__name__.removesuffix('_blocks')}": f.launches for f in counted}
    check(launches == P15_LAUNCHES, f"phase 15 launches {launches} != {P15_LAUNCHES}")
    print(f"phase 15 launches {launches} (B1/B2/fma/hop a call: "
          + ", ".join(f"{k} {v[0]}/{v[1]}/{v[2]}/{v[3]}" for k, v in per_call.items()) + f") [{card}]")

    # correctness: exact plans bitwise the input, int8 bitwise the plain
    # version and within absmax/254
    def within(got, want_np, what):
        err = float(np.abs(got.astype(np.float64) - want_np).max())
        bound = float(np.abs(want_np).max()) / 254.0
        check(0.0 < err <= bound * (1 + 1e-6), f"phase 15 {what}: error {err} outside (0, absmax/254 = {bound}]")
        return err

    for p in RESPLIT_POSITIONS:
        got = results[f"resplit_2048x512_{p}pos_exact"]
        check(got.split == 1 and np.array_equal(got.numpy(), small), f"phase 15 exact 0 -> 1 at {p}: not the input")
        got = results[f"resplit_2048x512_{p}pos_int8"]
        plain = pieces_replay(torch, inputs[p].larray, p, 0, 1, plain_q, cq.dequantize_blocks_plain)
        check(bitwise_equal(got._buffer, plain), f"phase 15 int8 0 -> 1 at {p}: != the plain replay, bitwise")
        metrics[f"resplit_2048x512_{p}pos_int8_err"] = within(got.numpy(), small, f"int8 0 -> 1 at {p}")
    got = results["resplit_blobs_4pos_int8"]
    plain = pieces_replay(torch, blobs.larray, 4, 0, 1, plain_q, cq.dequantize_blocks_plain)
    check(bitwise_equal(got._buffer, plain), "phase 15 blobs int8 0 -> 1: != the plain replay, bitwise")
    metrics["resplit_blobs_4pos_int8_err"] = within(got.numpy(), data, "blobs int8 0 -> 1")
    got = results["mixed_add_blobs_4pos_int8"]
    y0 = pieces_replay(torch, y_blobs.larray, 4, 1, 0, plain_q, cq.dequantize_blocks_plain)
    check(got.split == 0 and bitwise_equal(got.larray, blobs.larray + y0),
          "phase 15 mixed-split x + y: != x + the plain replay of y's resplit, bitwise")
    within(got.numpy() - data, y_np, "mixed-split x + y")
    cpu_grids = {m: htt.grid_comm(m, ["cpu"] * (m[0] * m[1])) for m in GRID_MESHES}
    for m in GRID_MESHES:
        tag = f"{m[0]}x{m[1]}"
        got = results[f"grid_resplit_4096x512_{tag}_exact"]
        check(got.splits == (1, 0) and np.array_equal(got.numpy(), wide), f"phase 15 grid exact {tag}: not the input")
        got = results[f"grid_resplit_4096x512_{tag}_int8"]
        with cq.collective_precision("int8_block"):
            on_cpu = htt.resplit(htt.array(wide, splits=(0, 1), comm=cpu_grids[m]), (1, 0))
        check(bitwise_equal(got._buffer.cpu(), on_cpu._buffer),
              f"phase 15 grid int8 {tag}: != the plain version (the port's CPU run), bitwise")
        metrics[f"grid_resplit_4096x512_{tag}_int8_err"] = within(got.numpy(), wide, f"grid int8 {tag}")
    print(f"phase 15: exact plans bitwise the input; int8 bitwise the plain version, errors "
          + ", ".join(f"{k.removesuffix('_err')} {v:.4g}" for k, v in metrics.items()) + " (within absmax/254)")

    # times: each call beside its monolithic twin
    for key, mode, fn in calls:
        with cq.collective_precision(mode):
            wall, dms = wall_ms(fn), profiled_ms(torch, fn)
            with rd.redistribution("monolithic"):
                mwall, mdms = wall_ms(fn), profiled_ms(torch, fn)
        metrics.update({f"{key}_ms": wall, f"{key}_device_ms": dms,
                        f"{key}_monolithic_ms": mwall, f"{key}_monolithic_device_ms": mdms})
        print(f"  {key}: {wall:.3f} ms wall, {dms:.3f} ms device; monolithic twin {mwall:.3f} / {mdms:.3f} ms")

    # the batched pieces beside a per-piece loop of the kernels
    for p, x in [(4, blobs), (8, inputs[8])]:
        tag = "blobs_4pos" if p == 4 else "2048x512_8pos"
        with cq.collective_precision("int8_block"):
            loop = pieces_replay(torch, x.larray, p, 0, 1, cq.quantize_blocks, cq.dequantize_blocks)
            batched = htt.resplit(x, 1)
            check(bitwise_equal(batched._buffer, loop), f"phase 15 {tag}: batched != per-piece loop, bitwise")
            b_dev = profiled_ms(torch, lambda: htt.resplit(x, 1))
            l_dev = profiled_ms(torch, lambda: pieces_replay(torch, x.larray, p, 0, 1, cq.quantize_blocks,
                                                             cq.dequantize_blocks))
            b_wall = wall_ms(lambda: htt.resplit(x, 1))
            l_wall = wall_ms(lambda: pieces_replay(torch, x.larray, p, 0, 1, cq.quantize_blocks,
                                                   cq.dequantize_blocks))
        metrics.update({f"pieces_{tag}_batched_ms": b_wall, f"pieces_{tag}_batched_device_ms": b_dev,
                        f"pieces_{tag}_loop_ms": l_wall, f"pieces_{tag}_loop_device_ms": l_dev})
        print(f"  int8 pieces {tag}: batched {b_wall:.3f} ms wall / {b_dev:.3f} ms device, per-piece loop "
              f"{l_wall:.3f} / {l_dev:.3f} ms ({p * (p - 1)} pieces)")

    # measured peak allocation beside the plan's modeled peak (per position)
    for key, mode, shape, dt, src, dst, size, mesh, fn in [
        ("resplit_2048x512_8pos_int8", "int8_block", RESPLIT_SHAPE, "float32", 0, 1, 8, None,
         lambda: htt.resplit(inputs[8], 1)),
        ("resplit_blobs_4pos_int8", "int8_block", data.shape, "float32", 0, 1, 4, None,
         lambda: htt.resplit(blobs, 1)),
        ("grid_resplit_4096x512_2x4_int8", "int8_block", GRID_PLAN_SHAPE, "float32", (0, 1), (1, 0), 8, (2, 4),
         lambda: htt.resplit(gin[(2, 4)], (1, 0))),
    ]:
        with cq.collective_precision(mode):
            plan = rd.plan(shape, dt, src, dst, size, mesh_shape=mesh)
            peak = peak_bytes(torch, fn)
        metrics[f"{key}_peak_bytes"] = peak
        metrics[f"{key}_plan_peak_live_bytes"] = plan.peak_live_bytes
        print(f"  {key}: peak {peak} B allocated on the card for all {size} positions; "
              f"Plan.peak_live_bytes {plan.peak_live_bytes} B a position ({plan.mode}, {len(plan.steps)} steps)")

    # the rate of a move between positions: a roll of the stacked pieces
    stacked = blobs.larray.reshape(4, -1)
    roll_ms = device_ms(lambda t: torch.roll(t, 1, dims=0), [(stacked,)], per_graph=8, trials=7)
    small4 = inputs[4].larray.reshape(4, -1)
    roll_small_ms = device_ms(lambda t: torch.roll(t, 1, dims=0), [(small4,)], per_graph=32, trials=7)
    metrics["roll_gbps"] = stacked.numel() * 4 / (roll_ms * 1e6)
    metrics["roll_4mb_gbps"] = small4.numel() * 4 / (roll_small_ms * 1e6)
    print(f"phase 15 roll of the stacked (4, ...) pieces: {metrics['roll_gbps']:.1f} GB/s at 64 MB "
          f"({roll_ms:.4f} ms), {metrics['roll_4mb_gbps']:.1f} GB/s at 4 MB [{card}]")
    return launches, metrics


# ---------------------------------------------------------------------- #
# in-process serving (phase 16)                                          #
# ---------------------------------------------------------------------- #
def summary(values):
    """``(median, interquartile spread as % of the median)``, as the
    reference benchmark summarizes its runs (bench.py ``_summary``);
    the spread is None below 3 values."""
    values = sorted(values)
    n = len(values)
    med = values[n // 2]
    if n < 3 or not med:
        return med, None
    q1, q3 = values[int(0.25 * (n - 1))], values[int(0.75 * (n - 1))]
    return med, abs(100.0 * (q3 - q1) / med)


def same_bytes(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


class MemoryRegistry:
    """The engine's registry interface over fitted estimators held in
    memory: ``publish``, ``versions``, ``resolve``, ``load`` and the
    executable sidecars.  ``serve.ModelRegistry`` keeps HDF5 checkpoints,
    and the card machine has no ``h5py``."""

    def __init__(self):
        self.models, self.sidecars = {}, {}

    def publish(self, tenant, model, est):
        versions = self.models.setdefault((tenant, model), [])
        versions.append(est)
        return len(versions)

    def versions(self, tenant, model):
        return list(range(1, len(self.models.get((tenant, model), ())) + 1))

    def resolve(self, tenant, model, version=None):
        versions = self.versions(tenant, model)
        check(bool(versions), f"phase 16: nothing published for {tenant}/{model}")
        version = versions[-1] if version is None else int(version)
        check(version in versions, f"phase 16: {tenant}/{model} has no version {version}")
        return version, f"<memory>/{tenant}/{model}/v{version}"

    def load(self, tenant, model, version=None):
        version, _ = self.resolve(tenant, model, version)
        return self.models[(tenant, model)][version - 1], version

    def publish_executables(self, tenant, model, version, bundles):
        self.sidecars[(tenant, model, int(version))] = list(bundles)

    def load_executables(self, tenant, model, version=None, *, policy=None):
        version, _ = self.resolve(tenant, model, version)
        return self.sidecars.get((tenant, model, version), []), version


def phase_serving(torch, htt, dev, data, counted, card, knn_ms, knn_before_ms):
    """Phase 16 (see the module docstring).  Returns ``(launches,
    metrics)``."""
    from heat_tpu_torch import telemetry
    from heat_tpu_torch.serve import ServeEngine, loadgen

    fa = __import__("importlib").import_module("heat_tpu_torch.parallel.flash_attention")
    kernels = list(counted) + [fa.flash_attention, fa.flash_attention_partial]
    metrics = {}
    comm1 = htt.TorchCommunication([dev])
    htt.fuse.clear_cache()

    # the main path: the reference benchmark's serving run
    # (bench.py:2255-2293), the counts set to 0 just before it
    for f in kernels:
        f.launches = 0
    t0 = time.perf_counter()
    km = htt.cluster.KMeans(n_clusters=K, max_iter=3, random_state=0)
    km.fit(htt.array(data[:SERVE_FIT_ROWS], split=0, comm=comm1))
    reg = MemoryRegistry()
    reg.publish("bench", "km", km)
    eng = ServeEngine(reg, max_batch_rows=SERVE_MAX_BATCH, min_bucket=SERVE_MIN_BUCKET)
    loadgen.run(eng, "bench", "km", seed=0, n_requests=SERVE_WARMUP, twin=False)
    reports, built = [], []
    for s in range(SERVE_RUNS):
        programs = htt.fuse.cache_size()
        reports.append(loadgen.run(eng, "bench", "km", seed=s + 1, n_requests=SERVE_REQUESTS,
                                   twin=(s == 0)))
        built.append(htt.fuse.cache_size() - programs)  # the twin's shapes included
    stats = eng.stats()
    twin = reports[0].twin
    # the obs twin (bench.py:2299-2322): telemetry on and an SLO monitor
    # that never burns, on the same warm engine and schedules
    telemetry.enable()
    eng.slo = telemetry.SloMonitor("bench.serve", target_ms=1e9)
    try:
        obs = [loadgen.run(eng, "bench", "km", seed=s + 1, n_requests=SERVE_REQUESTS, twin=False)
               for s in range(SERVE_RUNS)]
        obs_counters = telemetry.snapshot()["counters"]
    finally:
        eng.slo = None
        telemetry.disable()
        telemetry.reset()
    eng.close()
    torch.cuda.synchronize()
    launches = {f"blockquant_{f.__name__.removesuffix('_blocks')}": f.launches for f in counted}
    launches.update({f.__name__: f.launches for f in kernels[len(counted):]})
    metrics["phase16_main_s"] = time.perf_counter() - t0

    pps, pps_spread = summary([r.predictions_per_sec for r in reports])
    p99, p99_spread = summary([r.p99_ms for r in reports])
    p99_obs, _ = summary([r.p99_ms for r in obs])
    metrics.update({
        "serve_predictions_per_sec": pps, "serve_predictions_per_sec_spread_pct": pps_spread,
        "serve_p99_ms": p99, "serve_p99_ms_spread_pct": p99_spread,
        "serve_predictions_per_sec_runs": [r.predictions_per_sec for r in reports],
        "serve_p99_ms_runs": [r.p99_ms for r in reports],
        "serve_programs_built_runs": built,
        "dispatches_per_batch": stats["dispatches_per_batch"],
        "batch_occupancy": stats["batch_occupancy"],
        "wire_bytes_per_row": (stats["payload_bytes"] + stats["reply_bytes"]) / stats["rows"],
        "direct_bitwise_equal": bool(twin["bitwise_equal"]),
        "direct_compared": twin["compared"],
        "direct_predictions_per_sec": twin["predictions_per_sec"],
        "direct_p99_ms": twin["p99_ms"],
        "obs_p99_ms": p99_obs,
        "obs_overhead_p99": p99_obs / p99 if p99 else None,
    })
    check(metrics["direct_bitwise_equal"] and twin["compared"] == SERVE_REQUESTS,
          f"phase 16: served replies != the direct twin, bitwise ({twin})")
    check(stats["dispatches_per_batch"] == 1.0,
          f"phase 16: dispatches_per_batch {stats['dispatches_per_batch']} != 1.0")
    check(obs_counters.get("serve.batches", 0) == sum(r.batches for r in obs),
          "phase 16: the obs twin's serve.batches counter")
    check(all(r.dispatches_per_batch == 1.0 and not r.degraded for r in reports + obs),
          "phase 16: a run with dispatches_per_batch != 1.0 or a degraded reply")
    print(f"phase 16 serving, KMeans k={K} on {SERVE_FIT_ROWS} rows, {SERVE_RUNS} x {SERVE_REQUESTS} "
          f"requests: serve_predictions_per_sec {pps:.1f} (spread {pps_spread}%), serve_p99_ms "
          f"{p99:.4f} (spread {p99_spread}%); dispatches_per_batch {stats['dispatches_per_batch']}, "
          f"batch_occupancy {stats['batch_occupancy']:.4f}, wire_bytes_per_row "
          f"{metrics['wire_bytes_per_row']:.2f}, direct_bitwise_equal {metrics['direct_bitwise_equal']} "
          f"({twin['compared']} compared; direct {twin['predictions_per_sec']:.1f} predictions/s, p99 "
          f"{twin['p99_ms']:.4f} ms); obs_p99_ms {p99_obs:.4f}, obs_overhead_p99 "
          f"{metrics['obs_overhead_p99']:.4f}; launches {launches} [{card}]")
    print(f"phase 16 runs: predictions/s {[round(r.predictions_per_sec, 1) for r in reports]}, p99 ms "
          f"{[round(r.p99_ms, 4) for r in reports]}, programs built {built}, batches "
          f"{[r.batches for r in reports]}")

    # each of the four fused predicts, cold (install + first request) and
    # warm (replay), from a sidecar of AOT bundles
    truth = np.repeat(np.arange(K), N // K)
    sub, t_sub = data[::N // SUB], truth[::N // SUB]
    X = htt.array(sub, split=0, comm=comm1)
    y_lasso = lasso_target(data)[::N // SUB]
    estimators = {
        "knn": htt.classification.KNN(X, htt.array(t_sub, split=0, comm=comm1), KNN_K),
        "gaussian_nb": htt.naive_bayes.GaussianNB().fit(X, htt.array(t_sub, split=0, comm=comm1)),
        "lasso": htt.regression.Lasso(lam=LASSO_LAM, max_iter=SERVE_LASSO_SWEEPS).fit(
            X, htt.array(y_lasso, split=0, comm=comm1)),
        "kmeans": km,
    }
    request = np.random.default_rng(16).standard_normal((SERVE_REQUEST_ROWS, F)).astype(np.float32)
    prev_comm = htt.core.communication._default_comm
    htt.use_comm(comm1)  # GaussianNB's lane takes the default communicator
    try:
        for name, est in estimators.items():
            reg.publish("bench", name, est)
            e = ServeEngine(reg, max_batch_rows=SERVE_MAX_BATCH, min_bucket=SERVE_MIN_BUCKET)
            bundles = e.export_warm("bench", name)
            e.close()
            reg.publish_executables("bench", name, reg.versions("bench", name)[-1], bundles)
            htt.fuse.clear_cache()
            e = ServeEngine(reg, max_batch_rows=SERVE_MAX_BATCH, min_bucket=SERVE_MIN_BUCKET)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            installed = e.warm("bench", name)
            t1 = time.perf_counter()
            programs = htt.fuse.cache_size()
            first = e.predict("bench", name, request)
            t2 = time.perf_counter()
            check(installed == len(bundles) == len(e._buckets()),
                  f"phase 16 {name}: installed {installed} of {len(bundles)} bundles")
            check(htt.fuse.cache_size() == programs, f"phase 16 {name}: the first request built a program")
            warm = []
            for _ in range(SERVE_WARM_REPS):
                ts = time.perf_counter()
                reply = e.predict("bench", name, request)
                warm.append((time.perf_counter() - ts) * 1e3)
            direct = e.direct_predict("bench", name, request)
            same = same_bytes(reply.value, direct)
            check(same_bytes(reply.value, first.value), f"phase 16 {name}: a replay differs from the first reply")
            check(e.stats()["dispatches_per_batch"] == 1.0, f"phase 16 {name}: dispatches_per_batch")
            e.close()
            metrics[f"serve_{name}_install_ms"] = (t1 - t0) * 1e3
            metrics[f"serve_{name}_cold_ms"] = (t2 - t0) * 1e3
            metrics[f"serve_{name}_warm_ms"] = float(np.median(warm))
            metrics[f"serve_{name}_direct_bitwise"] = bool(same)
            print(f"phase 16 {name}: {installed} programs installed in {(t1 - t0) * 1e3:.2f} ms; cold "
                  f"(install + first request of {SERVE_REQUEST_ROWS} rows) {(t2 - t0) * 1e3:.2f} ms, warm "
                  f"(replay) {metrics[f'serve_{name}_warm_ms']:.4f} ms (median of {SERVE_WARM_REPS}); served "
                  f"== direct, bitwise: {same} [{card}]")
    finally:
        htt.use_comm(prev_comm)
        htt.fuse.clear_cache()
    metrics["knn_predict_ms"] = knn_ms
    metrics["knn_predict_before_ms"] = knn_before_ms
    print(f"phase 8's knn_predict_ms {knn_ms:.2f} (fused, the reference's tie order) beside "
          f"{knn_before_ms:.2f} (eager, a float torch.topk), this run [{card}]")
    return launches, metrics


# ---------------------------------------------------------------------- #
# the serving fleet (phase 17)                                           #
# ---------------------------------------------------------------------- #
class DiskRegistry:
    """The engine's registry interface over a directory that the card
    machine can read without ``h5py`` (``serve.ModelRegistry`` keeps HDF5
    checkpoints): each version of a k-clusterer as
    ``<root>/<tenant>/<model>/v<N>.npz``, its fitted state (class, centers,
    ``n_iter``, ``inertia``), beside the port's pickled AOT sidecar
    ``v<N>.aotx``.  ``load`` rebuilds a version with its class's
    ``from_fitted`` on the default communicator, once: every request of
    a version sees one estimator.  A replica process opens it by its root
    (``python3 chip_smoke.py --replica CONFIG``)."""

    def __init__(self, root):
        self.root = str(root)
        self._cache = {}
        self._lock = threading.Lock()

    def _path(self, tenant, model, version, ext):
        return os.path.join(self.root, tenant, model, f"v{int(version)}.{ext}")

    def versions(self, tenant, model):
        folder = os.path.join(self.root, tenant, model)
        if not os.path.isdir(folder):
            return []
        return sorted(int(f[1:-4]) for f in os.listdir(folder) if f.startswith("v") and f.endswith(".npz"))

    def resolve(self, tenant, model, version=None):
        from heat_tpu_torch.serve.registry import ModelNotFoundError, VersionNotFoundError

        versions = self.versions(tenant, model)
        if not versions:
            raise ModelNotFoundError(f"tenant={tenant!r} model={model!r}: nothing published in {self.root}")
        version = versions[-1] if version is None else int(version)
        if version not in versions:
            raise VersionNotFoundError(f"tenant={tenant!r} model={model!r} has no version {version}")
        return version, self._path(tenant, model, version, "npz")

    def publish(self, tenant, model, est):
        version = (self.versions(tenant, model) or [0])[-1] + 1
        path = self._path(tenant, model, version, "npz")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        cls = type(est)
        np.savez(path, cls=np.array(f"{cls.__module__}:{cls.__qualname__}"),
                 cluster_centers=est.cluster_centers_.numpy(),
                 n_iter=np.array(-1 if est.n_iter_ is None else est.n_iter_),
                 inertia=np.array(np.nan if est.inertia_ is None else est.inertia_))
        return version

    def load(self, tenant, model, version=None):
        import importlib

        version, path = self.resolve(tenant, model, version)
        key = (tenant, model, version)
        with self._lock:
            if key not in self._cache:
                with np.load(path) as f:
                    module, name = str(f["cls"]).split(":")
                    state = {"cluster_centers": f["cluster_centers"],
                             "n_iter": None if int(f["n_iter"]) < 0 else int(f["n_iter"]),
                             "inertia": None if np.isnan(f["inertia"]) else float(f["inertia"])}
                cls = getattr(importlib.import_module(module), name)
                self._cache[key] = cls.from_fitted(state)
            return self._cache[key], version

    def publish_executables(self, tenant, model, version, bundles):
        import pickle

        with open(self._path(tenant, model, version, "aotx"), "wb") as fh:
            pickle.dump(list(bundles), fh)

    def load_executables(self, tenant, model, version=None, *, policy=None):
        import pickle

        version, _ = self.resolve(tenant, model, version)
        path = self._path(tenant, model, version, "aotx")
        if not os.path.exists(path):
            return [], version
        with open(path, "rb") as fh:  # written by this program's publish_executables
            return pickle.load(fh), version


def replica_argv():
    """The command (after the interpreter) that makes a fleet replica of
    this script: ``ReplicaProc._child_argv`` while phase 17 and the card
    tests run."""
    return (os.path.abspath(__file__), "--replica")


def replica(config: str) -> int:
    """A replica process over :class:`DiskRegistry`: the port's replica
    body (``heat_tpu_torch.serve._replica_main.serve``) with the registry
    the card can read."""
    from heat_tpu_torch.serve import _replica_main

    cfg = json.loads(config)
    return _replica_main.serve(cfg, DiskRegistry(cfg["registry_root"]))


def compute_apps() -> list:
    """The pid of each CUDA context ``nvidia-smi`` lists on the machine."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi --query-compute-apps failed: {out.stderr.strip()}")
    return [int(x) for x in out.stdout.split()]


def check_contexts(base: list, pids: list, what: str) -> str:
    """Hold the card's CUDA contexts to the replicas running: each pid in
    ``pids`` listed by ``nvidia-smi``, and no pid of an ended replica.
    Where ``nvidia-smi`` does not list processes under their own pids (a
    container whose PID namespace the GPU kernel module cannot see shows every
    context under one other pid; this process's own pid is then missing
    too), each replica must add one context to ``base``, the list before
    any replica started.  Polls for up to
    20 s: a killed process's context goes after it exits.  Returns the
    route: "pids" or "count"."""
    deadline = time.monotonic() + 20
    while True:
        apps = compute_apps()
        by_pid = os.getpid() in apps
        ok = (set(pids) <= set(apps) and len(apps) == len(base) + len(pids)) if by_pid \
            else len(apps) == len(base) + len(pids)
        if ok or time.monotonic() > deadline:
            break
        time.sleep(0.25)
    check(ok, f"phase 17 {what}: nvidia-smi lists {apps} with {len(base)} context(s) before the "
              f"replicas; want {'the replica pids ' + str(pids) if by_pid else str(len(pids)) + ' more'}")
    return "pids" if by_pid else "count"


def phase_fleet(torch, htt, dev, data, counted, card):
    """Phase 17 (see the module docstring).  Returns ``(launches,
    metrics)``."""
    import tempfile
    import zlib

    from heat_tpu_torch import telemetry
    from heat_tpu_torch.resilience import faults
    from heat_tpu_torch.serve import (
        FleetEngine, HedgePolicy, Ingress, IngressClient, ProcFleet, ReplicaProc, ServeEngine,
        WatermarkAutoscaler, loadgen,
    )

    fa = __import__("importlib").import_module("heat_tpu_torch.parallel.flash_attention")
    kernels = list(counted) + [fa.flash_attention, fa.flash_attention_partial]
    metrics = {}
    kw = dict(max_batch_rows=SERVE_MAX_BATCH, min_bucket=SERVE_MIN_BUCKET)
    comm1 = htt.TorchCommunication([dev])
    prev_comm, prev_argv = htt.core.communication._default_comm, ReplicaProc._child_argv
    tmp = tempfile.TemporaryDirectory(prefix="phase17-")
    mps = os.path.exists(os.environ.get("CUDA_MPS_PIPE_DIRECTORY", "/tmp/nvidia-mps"))
    metrics.update(compute_mode=smi("compute_mode"), mps=mps)
    htt.use_comm(comm1)  # the replicas take the parent's positions: one, on this card
    ReplicaProc._child_argv = replica_argv()
    try:
        base = compute_apps()
        htt.fuse.clear_cache()
        for f in kernels:
            f.launches = 0
        t0 = time.perf_counter()
        km = htt.cluster.KMeans(n_clusters=K, max_iter=3, random_state=0)
        km.fit(htt.array(data[:SERVE_FIT_ROWS], split=0, comm=comm1))
        reg = DiskRegistry(tmp.name)
        reg.publish("bench", "km", km)
        src = ServeEngine(reg, **kw)
        bundles = src.export_warm("bench", "km", version=1)
        src.close()
        reg.publish_executables("bench", "km", 1, bundles)

        # (1) fleet_rates (bench.py:2329-2410): in-process replicas
        auto = WatermarkAutoscaler(low=1.0, high=4.0, hysteresis=1, max_replicas=2)
        fleet = FleetEngine(reg, autoscaler=auto, warm_models=[("bench", "km", 1)], **kw)
        telemetry.enable()
        pay8 = np.ascontiguousarray(data[:8], dtype=np.float32)
        try:
            fleet.predict("bench", "km", pay8, version=1)
            scale_ms, zero_compiles = [], True
            for _ in range(FLEET_EVENTS):
                before = dict(telemetry.snapshot()["counters"])
                ts = time.perf_counter()
                fleet.tick(queue_depth=50.0)
                for _r in range(len(fleet.replicas)):
                    fleet.predict("bench", "km", pay8, version=1)
                scale_ms.append((time.perf_counter() - ts) * 1e3)
                after = telemetry.snapshot()["counters"]
                zero_compiles &= all(after.get(c, 0) == before.get(c, 0)
                                     for c in ("fuse.cache.misses", "compile.cache.misses"))
                fleet.tick(queue_depth=0.0)
            installed = [e["installed"] for e in fleet.scale_events if e["action"] == "scale-up"]
            cold = list(fleet.cold_start_ms[1:])
            fstats = fleet.stats()
        finally:
            fleet.close()
            telemetry.disable()
            telemetry.reset()
        cold_ms, cold_spread = summary(cold)
        metrics.update({
            "replica_cold_start_ms": cold_ms, "replica_cold_start_spread_pct": cold_spread,
            "scale_event_p99_ms": float(np.percentile(scale_ms, 99)),
            "scale_event_p50_ms": float(np.percentile(scale_ms, 50)),
            "installed_per_scale_up": min(installed), "exported_bundles": len(bundles),
            "zero_compile_scale_ups": bool(zero_compiles),
            "scale_ups": fstats["scale_ups"], "scale_downs": fstats["scale_downs"],
        })
        check(zero_compiles, "phase 17 fleet_rates: a scale-up's first predicts built a program")
        check(min(installed) == len(bundles) and fstats["scale_ups"] == FLEET_EVENTS + 1,
              f"phase 17 fleet_rates: installed {installed}, scale-ups {fstats['scale_ups']}")
        print(f"phase 17 fleet_rates: {FLEET_EVENTS} scale events, replica_cold_start_ms {cold_ms:.3f} "
              f"(spread {cold_spread}%), scale_event_p99_ms {metrics['scale_event_p99_ms']:.3f}, "
              f"installed_per_scale_up {min(installed)} of {len(bundles)}, zero_compile_scale_ups "
              f"{zero_compiles} [{card}]")

        # (2) procfleet_rates (bench.py:2413-2530): replica processes
        seed = loadgen.chaos_seed()
        arrivals = loadgen.schedule(seed, n_requests=PROC_REQUESTS, min_rows=1, max_rows=PROC_MAX_ROWS)
        pays = loadgen.payloads(arrivals, F, seed=seed)
        total_rows = sum(a.rows for a in arrivals)
        twin = FleetEngine(reg, warm_models=[("bench", "km", 1)], **kw)
        try:
            twin_crcs = [zlib.crc32(np.asarray(twin.predict("bench", "km", p, version=1).value).tobytes())
                         for p in pays]
        finally:
            twin.close()

        def drive(fleet, tag, kill_at=None):
            ts = time.perf_counter()
            futs = []
            for i, p in enumerate(pays):
                futs.append(fleet.submit("bench", "km", p, version=1, request_id=f"{tag}-{i}"))
                if i == kill_at:
                    fleet.kill_replica(fleet.alive()[0].index)
            fleet.flush()
            wall = time.perf_counter() - ts
            for f in futs:
                f.result()
            return total_rows / wall

        pps_by_n, spread_by_n, spawn_ms, zero_spinups, routes = {}, {}, [], True, set()
        twin_equal = None
        for n in PROC_SIZES:
            with ProcFleet(tmp.name, n_replicas=n, warm_models=[("bench", "km", 1)], **kw) as pf:
                spawn_ms += pf.cold_start_ms
                zero_spinups &= all(r.hello["fuse_misses"] == 0 and r.hello["compile_misses"] == 0
                                    and r.hello["installed"] == len(bundles) for r in pf.alive())
                routes.add(check_contexts(base, [r.pid for r in pf.alive()], f"{n} replica(s)"))
                drive(pf, f"warm{n}")
                if n == 1:
                    twin_equal = [c for _, c in pf.ledger()[:PROC_REQUESTS]] == twin_crcs
                pps, spread = summary([drive(pf, f"d{n}{r}") for r in range(PROC_DRIVES)])
                pps_by_n[n], spread_by_n[n] = pps, spread
                if n == 2:
                    # one kill -9 in the middle of a drive
                    drive(pf, "kill", kill_at=PROC_KILL_AT)
                    disp = [d for d in pf.disposition_ledger() if d[0].startswith("kill-")]
                    kinds = sorted({d[1] for d in disp})
                    kstats = pf.stats()
                    requeued = sum(d[1] == "requeued-ok" for d in disp)
                    check(set(kinds) <= {"ok", "requeued-ok"} and len(disp) == PROC_REQUESTS,
                          f"phase 17 kill -9: dispositions {kinds} over {len(disp)} requests")
                    check([d[2] for d in disp] == twin_crcs,
                          "phase 17 kill -9: the reply ledger != the in-process twin's")
                    check(requeued == kstats["requeued"] and kstats["replica_losses"] == 1
                          and kstats["respawns"] == 1,
                          f"phase 17 kill -9: {requeued} requeued-ok, stats {kstats}")
                    check(all(r.hello["fuse_misses"] == 0 and r.hello["compile_misses"] == 0
                              for r in pf.alive()), "phase 17 kill -9: the respawned replica built a program")
                    routes.add(check_contexts(base, [r.pid for r in pf.alive()], "after kill -9 and respawn"))
                    metrics.update(kill_requeued=requeued, kill_dispositions=kinds)
                    print(f"phase 17 kill -9 of a replica at request {PROC_KILL_AT} of {PROC_REQUESTS}: "
                          f"{requeued} un-acked re-queued and answered (requeued-ok), dispositions {kinds}, "
                          f"ledger == twin, respawned warm (hello 0/0 misses)")
            routes.add(check_contexts(base, [], f"after the {n}-replica fleet closed"))
        eff = {n: pps_by_n[n] / (n * pps_by_n[1]) for n in PROC_SIZES}
        metrics.update({
            "pps_by_replicas": {str(n): v for n, v in pps_by_n.items()},
            "pps_spread_pct_by_replicas": {str(n): v for n, v in spread_by_n.items()},
            "scaling_efficiency": {str(n): v for n, v in eff.items()},
            "fleet_aggregate_pps": pps_by_n[max(PROC_SIZES)],
            "replica_spawn_ms": spawn_ms, "zero_compile_spinups": bool(zero_spinups),
            "twin_ledger_equal": bool(twin_equal), "contexts_checked_by": sorted(routes),
            "rows_per_drive": total_rows,
        })
        check(zero_spinups, "phase 17 procfleet_rates: a replica's hello reported misses or a partial install")
        check(bool(twin_equal), "phase 17 procfleet_rates: the reply ledger != the in-process FleetEngine twin's")
        print(f"phase 17 procfleet_rates: {PROC_REQUESTS} requests ({total_rows} rows) a drive, "
              f"{PROC_DRIVES} drives: pps_by_replicas {metrics['pps_by_replicas']}, scaling_efficiency "
              f"{metrics['scaling_efficiency']}; spawn ms {[round(x, 1) for x in spawn_ms]}; "
              f"zero_compile_spinups {zero_spinups}, twin_ledger_equal {twin_equal}; contexts checked by "
              f"{sorted(routes)}; compute_mode {metrics['compute_mode']}, MPS {mps} [{card}]")

        # (3) hedged_rates (bench.py:2532-2680): the ingress, a gray replica
        h_arrivals = loadgen.schedule(seed, n_requests=HEDGE_REQUESTS, min_rows=1, max_rows=HEDGE_MAX_ROWS)
        h_pays = loadgen.payloads(h_arrivals, F, seed=seed)

        def drive_p99(cli, tag):
            lats = []
            for i, p in enumerate(h_pays):
                ts = time.perf_counter()
                cli.predict("bench", "km", p, version=1, request_id=f"{tag}-{i}")
                lats.append((time.perf_counter() - ts) * 1e3)
            lats.sort()
            return lats[min(len(lats) - 1, int(0.99 * len(lats)))]

        with ProcFleet(tmp.name, n_replicas=2, warm_models=[("bench", "km", 1)], seed=seed, **kw) as pf:
            check(all(r.hello["fuse_misses"] == 0 and r.hello["compile_misses"] == 0 for r in pf.alive()),
                  "phase 17 hedged_rates: a replica's hello reported misses")
            with Ingress(pf) as ing:
                plain = IngressClient("127.0.0.1", ing.port)
                hedged = IngressClient("127.0.0.1", ing.port, hedge=HedgePolicy(
                    hedge_after_quantile=0.9, min_hedge_delay_s=0.02, budget_tokens=64.0, seed=seed))
                try:
                    drive_p99(plain, "warm-p")
                    drive_p99(hedged, "warm-h")
                    p99_plain, _ = summary([drive_p99(plain, f"idle-p{r}") for r in range(PROC_DRIVES)])
                    p99_armed, _ = summary([drive_p99(hedged, f"idle-h{r}") for r in range(PROC_DRIVES)])

                    def faulty(cli, tag):
                        out = []
                        for r in range(PROC_DRIVES):
                            with faults.inject("slow_replica", seed=seed, nth=HEDGE_NTH, site="replica0",
                                               delay=HEDGE_STRAGGLE_S):
                                out.append(drive_p99(cli, f"{tag}{r}"))
                        return summary(out)

                    p99_unhedged, unhedged_spread = faulty(plain, "tail-p")
                    p99_hedged, hedged_spread = faulty(hedged, "tail-h")
                    hstats = hedged.hedge_stats()
                finally:
                    plain.close()
                    hedged.close()
            hfleet = pf.stats()
        routes.add(check_contexts(base, [], "after the hedged fleet closed"))
        metrics.update({
            "hedged_tail_p99_ms": p99_hedged, "hedged_tail_spread_pct": hedged_spread,
            "unhedged_tail_p99_ms": p99_unhedged, "unhedged_tail_spread_pct": unhedged_spread,
            "hedged_vs_unhedged": p99_hedged / p99_unhedged if p99_unhedged else None,
            "idle_plain_p99_ms": p99_plain, "idle_armed_p99_ms": p99_armed,
            "armed_idle_overhead_p99": p99_armed / p99_plain if p99_plain else None,
            "hedges": hstats["hedges"], "hedge_wins": hstats["hedge_wins"],
            "budget_exhausted": hstats["budget_exhausted"], "hedge_cancelled": hfleet["cancelled"],
            "hedge_requeued": hfleet["requeued"], "breaker_opens": hfleet["breaker_opens"],
        })
        check(hstats["hedges"] > 0, "phase 17 hedged_rates: the hedged client never hedged")
        print(f"phase 17 hedged_rates: {HEDGE_REQUESTS} requests a drive, {HEDGE_STRAGGLE_S * 1e3:.0f} ms "
              f"straggles on replica0 at dispatches {HEDGE_NTH}: hedged_tail_p99_ms {p99_hedged:.3f} "
              f"(spread {hedged_spread}%), unhedged_tail_p99_ms {p99_unhedged:.3f} (spread "
              f"{unhedged_spread}%), hedged_vs_unhedged {metrics['hedged_vs_unhedged']:.3f}; idle p99 plain "
              f"{p99_plain:.3f}, armed {p99_armed:.3f}, armed_idle_overhead_p99 "
              f"{metrics['armed_idle_overhead_p99']:.3f}; hedges {hstats['hedges']}, wins "
              f"{hstats['hedge_wins']}, cancelled {hfleet['cancelled']} [{card}]")
        torch.cuda.synchronize()
        launches = {f"blockquant_{f.__name__.removesuffix('_blocks')}": f.launches for f in counted}
        launches.update({f.__name__: f.launches for f in kernels[len(counted):]})
        metrics["phase17_main_s"] = time.perf_counter() - t0
    finally:
        ReplicaProc._child_argv = prev_argv
        htt.use_comm(prev_comm)
        htt.fuse.clear_cache()
        tmp.cleanup()
    return launches, metrics


def autoshard_module(tmpdir: str):
    """Phase 18's pipelines as a module of their own: the carried sources
    written into one file under ``tmpdir`` and imported from it by path."""
    import importlib.util

    path = os.path.join(tmpdir, "autoshard_pipelines.py")
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(AUTOSHARD_PIPELINES + "\n\n" + AUTOSHARD_BENCH + "\n\n" + AUTOSHARD_LOOPY)
    spec = importlib.util.spec_from_file_location("autoshard_pipelines", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def on_card(dev, outs, what: str) -> None:
    """Every array of ``outs`` lies on the card."""
    for o in outs:
        t = o.larray if hasattr(o, "larray") else o
        check(t.device.type == dev.type, f"phase 18 {what}: a result lies on {t.device}, not the card")


def twin_equal(a_outs, h_outs) -> bool:
    """Values bitwise and split metadata equal, output by output."""
    return len(a_outs) == len(h_outs) and all(
        a.split == h.split and a.gshape == h.gshape and a.dtype == h.dtype and bitwise_equal(a._buffer, h._buffer)
        for a, h in zip(a_outs, h_outs))


def _autoshard_svd_probe_code(path: str, positions: int) -> str:
    """``htt.autoshard(svd_pipeline)`` on the card under each precision, in
    a process of its own (as phase 14 probes ``svd``'s capture): one line
    each, ``CAPTURED <bitwise the hand twin>``, ``FUSETRACEERROR ...`` or
    ``RAISED <the capture's error>``."""
    return (
        "import importlib.util, torch, heat_tpu_torch as htt\n"
        f"spec = importlib.util.spec_from_file_location('autoshard_pipelines', {path!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        f"comm = htt.TorchCommunication([torch.device('cuda', 0)] * {positions})\n"
        "for precision in ('f32', 'int8_block'):\n"
        "    with htt.comm.collective_precision(precision):\n"
        "        hand = mod.svd_pipeline(comm)\n"
        "        try:\n"
        "            got = htt.autoshard(mod.svd_pipeline)(comm)\n"
        "            same = all(torch.equal(a._buffer, b._buffer) and a.split == b.split for a, b in zip(got, hand))\n"
        "            print(precision, 'CAPTURED', same)\n"
        "        except htt.FuseTraceError as e:\n"
        "            print(precision, 'FUSETRACEERROR', str(e).splitlines()[0][:200])\n"
        "        except RuntimeError as e:\n"
        "            print(precision, 'RAISED', str(e).splitlines()[0][:200])\n"
    )


def phase_autoshard(torch, htt, cq, dev, counted, card):
    """Phase 18 (see the module docstring).  Returns ``(launches,
    metrics)``."""
    import tempfile

    from heat_tpu_torch.telemetry import _core as tel

    auto_mod = __import__("importlib").import_module("heat_tpu_torch.core.autoshard")
    fa = __import__("importlib").import_module("heat_tpu_torch.parallel.flash_attention")
    kernels = list(counted) + [fa.flash_attention, fa.flash_attention_partial]
    metrics = {}
    tmp = tempfile.TemporaryDirectory(prefix="phase18-")
    try:
        mod = autoshard_module(tmp.name)
        htt.fuse.clear_cache()
        for f in kernels:
            f.launches = 0

        # ------------------------------------------------------------ 18.1
        for p in AUTOSHARD_BENCH_POSITIONS:
            comm = htt.TorchCommunication([dev] * p)
            fn = mod._autoshard_bench_pipeline
            auto, hand = htt.autoshard(fn), htt.fuse(fn)
            t0 = time.perf_counter()
            summary_ = auto._summarize()
            t1 = time.perf_counter()
            plan = auto.plan(comm)
            t2 = time.perf_counter()
            a_out = auto(comm)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            h_out = hand(comm)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            build = {"analysis_ms": (t1 - t0) * 1e3, "solve_ms": (t2 - t1) * 1e3, "capture_ms": (t3 - t2) * 1e3,
                     "hand_build_ms": (t4 - t3) * 1e3}
            check(summary_ is not None and plan is not None,
                  f"phase 18 bench at {p}: no plan (the plain rung): summary {summary_}")
            check(auto._programs[auto_mod._policy_key(comm)][0] == "fused",
                  f"phase 18 bench at {p}: rung {auto._programs[auto_mod._policy_key(comm)][0]}, want fused")
            on_card(dev, a_out + h_out, f"bench at {p}")
            check(twin_equal(a_out, h_out), f"phase 18 bench at {p}: solved != hand twin (values or split)")
            elided = [d for d in plan["decisions"] if d["elide"]]
            check(len(elided) == 1, f"phase 18 bench at {p}: {len(elided)} elided decisions, want 1")
            check(plan["modeled_wire_bytes"] < plan["hand_wire_bytes"],
                  f"phase 18 bench at {p}: modeled {plan['modeled_wire_bytes']} B not below the hand "
                  f"layout's {plan['hand_wire_bytes']} B")
            dispatches = []
            for prog in (auto, hand):
                # a window reads the count since its entry: read it at once
                with htt.telemetry.counting_dispatches() as d:
                    prog(comm)
                    dispatches.append(d.count)
            check(dispatches == [1, 1], f"phase 18 bench at {p}: dispatches solved/hand {dispatches}, want 1 each")
            # the wire ledger around one solved call: the plan's modeled bytes
            was = tel.is_enabled()
            tel.enable()
            tel.reset()
            try:
                auto(comm)
                torch.cuda.synchronize()
                counters = tel.snapshot()["counters"]
            finally:
                tel.reset()
                (tel.enable if was else tel.disable)()
            ledger = (counters.get("comm.wire_bytes", 0), counters.get("comm.exact_bytes", 0))
            check(ledger == (plan["modeled_wire_bytes"], plan["modeled_exact_bytes"]),
                  f"phase 18 bench at {p}: ledger {ledger} != modeled "
                  f"{(plan['modeled_wire_bytes'], plan['modeled_exact_bytes'])}")
            walls = {"solved": [], "hand": []}
            for _ in range(P18_WALL_REPS):
                for key, prog in (("solved", auto), ("hand", hand)):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    prog(comm)
                    torch.cuda.synchronize()
                    walls[key].append((time.perf_counter() - t0) * 1e3)
            s_ms, s_spread = summary(walls["solved"])
            h_ms, h_spread = summary(walls["hand"])
            s_dev, s_syncs, s_graphs, _ = replay_profile(torch, lambda: auto(comm))
            h_dev, h_syncs, h_graphs, _ = replay_profile(torch, lambda: hand(comm))
            check(s_graphs == 1 and h_graphs == 1,
                  f"phase 18 bench at {p}: cudaGraphLaunch a call solved {s_graphs}, hand {h_graphs}, want 1")
            row = {**build, "fingerprint": plan["fingerprint"], "decisions": len(plan["decisions"]),
                   "elided": len(elided), "modeled_wire_bytes": plan["modeled_wire_bytes"],
                   "hand_wire_bytes": plan["hand_wire_bytes"], "ledger_wire_bytes": ledger[0],
                   "solved_wall_ms": s_ms, "solved_spread_pct": s_spread, "hand_wall_ms": h_ms,
                   "hand_spread_pct": h_spread, "solved_device_ms": s_dev, "hand_device_ms": h_dev,
                   "solved_syncs": s_syncs, "hand_syncs": h_syncs, "graph_launches": [s_graphs, h_graphs],
                   "autoshard_speedup": h_ms / s_ms,
                   "device_speedup": h_dev / s_dev if s_dev else None}
            metrics[f"autoshard_bench_{p}pos"] = row
            print(f"phase 18 bench 1024x512 f32 at {p} positions: plan {plan['fingerprint']} ({len(plan['decisions'])}"
                  f" decisions, {len(elided)} elided), modeled {plan['modeled_wire_bytes']} B against the hand "
                  f"layout's {plan['hand_wire_bytes']} B, ledger {ledger[0]} B; cold build: analysis "
                  f"{build['analysis_ms']:.1f} ms, solve {build['solve_ms']:.2f} ms, capture "
                  f"{build['capture_ms']:.1f} ms (hand fuse {build['hand_build_ms']:.1f} ms); solved "
                  f"{s_ms:.4f} ms wall (spread {s_spread}%), {s_dev:.4f} ms device; hand {h_ms:.4f} ms wall "
                  f"(spread {h_spread}%), {h_dev:.4f} ms device; autoshard_speedup {h_ms / s_ms:.3f}; "
                  f"1 dispatch and 1 cudaGraphLaunch a call each; bitwise [{card}]")

        # ------------------------------------------------------------ 18.2
        comm = htt.TorchCommunication([dev] * P18_POSITIONS)
        per = {}
        rungs = {}
        for precision in ("f32", "int8_block"):
            for name in sorted(mod.__all__):
                fn = getattr(mod, name)
                auto = htt.autoshard(fn)
                calls = {}
                with cq.collective_precision(precision):
                    before = [f.launches for f in counted]
                    hand = fn(comm)
                    torch.cuda.synchronize()
                    calls["hand"] = tuple(f.launches - b for f, b in zip(counted, before))
                    on_card(dev, hand, f"{name} hand")
                    # svd's capture is refused on the card (it reads and copies
                    # on the host, as phase 14's probe shows): its solved call
                    # runs in the probe below, in a process of its own
                    for call in () if name == "svd_pipeline" else ("solved", "steady"):
                        before = [f.launches for f in counted]
                        got = auto(comm)
                        torch.cuda.synchronize()
                        calls[call] = tuple(f.launches - b for f, b in zip(counted, before))
                        on_card(dev, got, f"{name} solved")
                        check(twin_equal(got, hand), f"phase 18 {name} {precision}: solved != hand twin, bitwise")
                    entry = auto._programs.get(auto_mod._policy_key(comm))
                    rungs[f"{name}_{precision}"] = entry[0] if entry else "probe"
                want = P18_RING.get(name, (0, 0, 0, 0)) if precision == "int8_block" else (0, 0, 0, 0)
                for call, got in calls.items():
                    check(got == want, f"phase 18 {name} {precision} {call}: launches B1/B2/fma/hop {got}, want {want}")
                per[f"{name}_{precision}"] = {k: list(v) for k, v in calls.items()}
        for name in P18_RING:
            check(per[f"{name}_int8_block"]["hand"][0] > 0, f"phase 18 {name}: no B1 launch under int8_block")
        torch.cuda.synchronize()
        launches = {f"blockquant_{f.__name__.removesuffix('_blocks')}": f.launches for f in counted}
        launches.update({f.__name__: f.launches for f in kernels[len(counted):]})
        proc = subprocess.run([sys.executable, "-c", _autoshard_svd_probe_code(mod.__file__, P18_POSITIONS)],
                              capture_output=True, text=True, timeout=300)
        probe = proc.stdout.strip().splitlines()
        check(proc.returncode == 0 and len(probe) == 2, f"phase 18 svd probe: rc {proc.returncode}, "
              f"{probe or proc.stderr.strip()[-300:]}")
        for line in probe:
            precision, outcome = line.split(" ", 2)[:2]
            check(line.endswith("CAPTURED True") or (outcome == "RAISED" and "as a CUDA graph failed" in line),
                  f"phase 18 svd_pipeline {precision}: {line}")
            rungs[f"svd_pipeline_{precision}"] = "fused" if outcome == "CAPTURED" else "refused (RuntimeError)"
        metrics["autoshard_fixtures"] = per
        metrics["autoshard_rungs"] = rungs
        metrics["autoshard_svd_probe"] = probe
        print(f"phase 18 fixtures at {P18_POSITIONS} positions, f32 and int8_block: solved bitwise the hand "
              f"twin, no plan reroutes a quantized hop; rungs {rungs}; svd's solved call in a process of its "
              f"own: {probe}; B1/B2/fma/hop a call under int8_block "
              + ", ".join(f"{n} " + " ".join(f"{k} {v}" for k, v in per[n + '_int8_block'].items())
                          for n in sorted(mod.__all__))
              + f" [{card}]")

        # ------------------------------------------------------------ 18.3
        loopy = htt.autoshard(mod._loopy_pipeline)
        check(loopy.plan(comm) is None, "phase 18 loopy pipeline: a plan was solved, want None")
        got, want = loopy(comm), mod._loopy_pipeline(comm)
        on_card(dev, got, "loopy")
        check(twin_equal(got, want), "phase 18 loopy pipeline: != the hand result")
        was = tel.is_enabled()
        tel.enable()
        tel.reset()
        try:
            untraceable = htt.autoshard(mod.kmeans_pipeline)
            check(twin_equal(untraceable(comm), mod.kmeans_pipeline(comm)), "phase 18 untraceable: != hand")
            falls = [e for e in tel.events() if e["type"] == "autoshard.fallback"]
        finally:
            tel.reset()
            (tel.enable if was else tel.disable)()
        check([e["reason"] for e in falls] == ["untraceable"],
              f"phase 18 untraceable pipeline: fallback events {falls}")
        print(f"phase 18 ladder: the loopy pipeline plain (plan None, the hand result); kmeans_pipeline eager "
              f"with autoshard.fallback reason untraceable [{card}]")
    finally:
        htt.fuse.clear_cache()
        tmp.cleanup()
    return launches, metrics


#: the ground-truth file of the capture rules, in the checkout
CAPTURE_RULES_FILE = os.path.join("tests", "test_torch_capture_rules.py")
_LINT_LINE = (r"spmdlint: (\d+) new, (\d+) baselined, (\d+) stale baseline entries  "
              r"\[([0-9.]+)s, cache (\d+) hit, (\d+) miss\]")


def _root() -> str:
    return os.path.dirname(os.path.abspath(__file__))


def capture_rules_module():
    """``tests/test_torch_capture_rules.py``, loaded by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("capture_rules", os.path.join(_root(), CAPTURE_RULES_FILE))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lint_run(cache_dir: str, *args):
    """One run of the port's linter CLI over its package against the
    committed baseline: ``(completed process, wall seconds)``."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "heat_tpu_torch.analysis.cli", "--baseline",
                           "--cache-dir", cache_dir, *args], capture_output=True, text=True, timeout=600,
                          cwd=_root())
    return proc, time.perf_counter() - t0


def capture_ground_truth(torch, dev, card: str) -> dict:
    """Part (2) of phase 19: each capture-rule fixture held to what its
    finding means on the card.  Returns the metrics."""
    import re

    mod = capture_rules_module()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(_root(), CAPTURE_RULES_FILE), "--refused"],
                          capture_output=True, text=True, timeout=300, cwd=_root())
    check(proc.returncode == 0, f"phase 19 refused captures: rc {proc.returncode}, {proc.stderr.strip()[-400:]}")
    refused = json.loads(proc.stdout.strip().splitlines()[-1])
    check(sorted(refused) == sorted(mod.REFUSED), f"phase 19 refused captures: cases {sorted(refused)}")
    for name, row in refused.items():
        check(row["raised"], f"phase 19 {name}: the capture was not refused (SPMD202 says it reads the host)")
        check(re.search(r"capturing|capture|FuseTraceError", row["message"] + row["error"]) is not None,
              f"phase 19 {name}: raised {row['error']}: {row['message']}, not a capture refusal")
    refused_s = time.perf_counter() - t0
    frozen = mod.run_frozen(dev)
    for name, row in frozen.items():
        check(row["fused_equal"] and row["eager_differ"],
              f"phase 19 {name}: fused calls equal {row['fused_equal']}, eager calls differ {row['eager_differ']}")
    observed = mod.run_observed(dev)
    check(observed["after_first"] >= 1 and observed["after_all"] == observed["after_first"],
          f"phase 19 pos_observe: {observed} (observations at capture only, none a replay)")
    clean = mod.run_clean(dev)
    t = mod.operand(dev)
    for name, row in clean.items():
        row["graph_launches"] = replay_profile(torch, lambda: getattr(mod, name)(t), tries=1)[2]
        check(row["bitwise"] and row["graph_launches"] == 1,
              f"phase 19 {name}: bitwise {row['bitwise']}, cudaGraphLaunch a call {row['graph_launches']}")
    torch.cuda.synchronize()
    print(f"phase 19 capture rules at 1 position: SPMD202 positives refused "
          + ", ".join(f"{n} {r['error']}" for n, r in sorted(refused.items()))
          + f" ({refused_s:.1f} s in a process of their own); SPMD201/205 positives frozen at capture "
          f"({', '.join(sorted(frozen))}: 2 fused calls equal, 2 eager calls differ); SPMD210 positive "
          f"{observed['after_first']} observations at the first call, {observed['after_all']} after "
          f"{observed['calls']} calls; negatives {', '.join(sorted(clean))} bitwise eager, 1 "
          f"cudaGraphLaunch a call [{card}]")
    return {"capture_refused": {n: f"{r['error']}: {r['message'][:200]}" for n, r in refused.items()},
            "capture_frozen": frozen,
            "capture_observed": observed, "capture_clean": clean}


def phase_linter(torch, htt, cq, dev, counted, card):
    """Phase 19 (see the module docstring).  Returns ``(launches,
    metrics)``."""
    import re
    import tempfile

    fa = __import__("importlib").import_module("heat_tpu_torch.parallel.flash_attention")
    kernels = list(counted) + [fa.flash_attention, fa.flash_attention_partial]
    for f in kernels:
        f.launches = 0
    metrics = {}
    with tempfile.TemporaryDirectory(prefix="phase19-") as tmp:
        cache = os.path.join(tmp, "cache")
        from heat_tpu_torch.analysis import iter_py_files

        files = sum(1 for _ in iter_py_files([os.path.join(_root(), "heat_tpu_torch")]))
        runs = {}
        for label in ("cold", "warm"):
            proc, secs = lint_run(cache)
            check(proc.returncode == 0, f"phase 19 linter {label}: exit {proc.returncode}: "
                  f"{(proc.stdout + proc.stderr).strip()[-800:]}")
            m = re.fullmatch(_LINT_LINE, proc.stdout.strip().splitlines()[-1])
            check(m is not None, f"phase 19 linter {label}: summary line {proc.stdout.strip()[-200:]!r}")
            new, based, stale, analysis_s, hits, misses = m.groups()
            check((new, based, stale) == ("0", "0", "0"), f"phase 19 linter {label}: {m.group(0)}")
            runs[label] = {"wall_s": secs, "analysis_s": float(analysis_s), "hits": int(hits), "misses": int(misses)}
        check(runs["cold"]["hits"] == 0 and runs["cold"]["misses"] == files,
              f"phase 19 linter cold: {runs['cold']} for {files} files")
        check(runs["warm"]["hits"] == files and runs["warm"]["misses"] == 0,
              f"phase 19 linter warm: {runs['warm']}, want {files} hits and no miss")
        proc, json_s = lint_run(cache, "--format", "json")
        check(proc.returncode == 0, f"phase 19 linter json: exit {proc.returncode}")
        doc = json.loads(proc.stdout)
        check(doc == {"count": 0, "findings": []}, f"phase 19 linter json: {str(doc)[:300]}")
    metrics["lint"] = {"files": files, "findings": doc["count"], **{f"{k}_{f}": v for k, row in runs.items()
                                                                  for f, v in row.items()}, "json_wall_s": json_s}
    print(f"phase 19 linter: {files} files analyzed, {doc['count']} findings against the empty baseline; cold "
          f"{runs['cold']['wall_s']:.2f} s ({runs['cold']['analysis_s']:.2f} s of analysis, {files} misses), "
          f"warm {runs['warm']['wall_s']:.2f} s ({runs['warm']['analysis_s']:.2f} s, {files} hits), --format "
          f"json {json_s:.2f} s [{card}]")
    metrics.update(capture_ground_truth(torch, dev, card))
    torch.cuda.synchronize()
    launches = {f"blockquant_{f.__name__.removesuffix('_blocks')}": f.launches for f in counted}
    launches.update({f.__name__: f.launches for f in kernels[len(counted):]})
    return launches, metrics


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every JSON line to this file")
    ap.add_argument("--replica", metavar="CONFIG",
                    help="serve as a phase 17 fleet replica (spawned by the fleet, not run by hand)")
    args = ap.parse_args(argv)
    if args.replica is not None:
        return replica(args.replica)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    return run(torch.device("cuda", 0), args.out)


def run(dev, out_path=None) -> int:
    import torch

    import importlib

    import heat_tpu_torch as htt
    from heat_tpu_torch import kernels
    from heat_tpu_torch.comm import compressed as cq

    fa = importlib.import_module("heat_tpu_torch.parallel.flash_attention")

    lines = []
    t_run = time.perf_counter()

    # ---------------------------------------------------------------- 1
    t0 = time.perf_counter()
    built = kernels.build_all()
    build_s = time.perf_counter() - t0
    card = card_line()
    print(f"build: {build_s:.1f} s ({built}); card: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    for name in ("blockquant", "flash_attention"):
        for row in kernels.ptxas_report(name):
            print(f"ptxas {name}: {row['entry']}: {row['registers']} registers, spill stores "
                  f"{row['spill_stores']} B, spill loads {row['spill_loads']} B"
                  + "".join(f"; {w}" for w in row["warnings"]))
    half = [r for r in kernels.ptxas_report("flash_attention")
            if "__nv_bfloat16" in r["entry"] or "6__half" in r["entry"]]
    check(bool(half) and all(r["spill_stores"] == 0 and r["spill_loads"] == 0 for r in half),
          "ptxas: no bf16/f16 flash instantiation reported, or one spills")

    # ---------------------------------------------------------------- 2
    kernel_rows = phase_kernels(torch, cq, dev)

    # ---------------------------------------------------------------- 3
    data, centers = make_blobs()
    comm1 = htt.TorchCommunication([dev])
    X = htt.array(data, split=0, comm=comm1)
    mean, std = htt.mean(X, axis=0), htt.std(X, axis=0)
    d64 = data.astype(np.float64)
    check(np.allclose(mean.numpy(), d64.mean(0), rtol=1e-4, atol=1e-4), "mean != numpy")
    check(np.allclose(std.numpy(), d64.std(0), rtol=1e-4), "std != numpy")
    moments_ms = wall_ms(lambda: (htt.mean(X, axis=0), htt.std(X, axis=0)))

    X_sub = htt.array(data[:SUB], split=0, comm=comm1)
    D = htt.spatial.cdist(X_sub, quadratic_expansion=True)
    check(D.shape == (SUB, SUB) and D.split == 0, f"cdist shape {D.shape}")
    sample = data[:64].astype(np.float64)
    ref = np.sqrt(((sample[:, None, :] - d64[None, :SUB, :]) ** 2).sum(-1))
    got = D.larray[:64].cpu().numpy()
    check(bool(np.isfinite(got).all()), "cdist has non-finite values")
    check(np.allclose(got, ref, rtol=1e-4, atol=5e-2), "cdist != numpy on the first 64 rows")
    del D
    cdist_ms = wall_ms(lambda: htt.spatial.cdist(X_sub, quadratic_expansion=True))

    init1 = htt.array(centers, comm=comm1)
    km = htt.cluster.KMeans(n_clusters=K, init=init1, max_iter=ITERS, tol=-1.0).fit(X)
    np_centers = numpy_lloyd(data, centers, ITERS)
    c1 = km.cluster_centers_.numpy()
    check(km.n_iter_ == ITERS, f"n_iter {km.n_iter_}")
    check(np.allclose(c1, np_centers, rtol=1e-4, atol=1e-4), "KMeans centers != numpy Lloyd")
    labels1 = km.labels_.numpy()
    pred = km.predict(X).numpy()
    check(float((pred == labels1).mean()) >= 0.9999, "predict disagrees with the fit's labels")
    fit_ms = wall_ms(
        lambda: htt.cluster.KMeans(n_clusters=K, init=init1, max_iter=ITERS, tol=-1.0).fit(X), reps=3
    )
    print(f"one position: KMeans {ITERS / fit_ms * 1e3:.1f} iter/s, cdist "
          f"{SUB * SUB * 4 / cdist_ms / 1e6:.1f} GB/s, mean+std {N * F * 4 * 2 / moments_ms / 1e6:.1f} GB/s")

    # ---------------------------------------------------------------- 4
    comm4 = htt.TorchCommunication([dev] * POSITIONS)
    rng = np.random.default_rng(1)
    stacked_np = rng.normal(size=(POSITIONS, PAYLOAD)).astype(np.float32)
    stacked = torch.from_numpy(stacked_np).to(dev)
    X4 = htt.array(data, split=0, comm=comm4)
    init4 = htt.array(centers, comm=comm4)
    counted = (cq.quantize_blocks, cq.dequantize_blocks, cq.dequantize_fma_blocks,
               cq.dequantize_add_quantize_blocks)
    with cq.collective_precision("int8_block"):
        for fn in counted:
            fn.launches = 0
        red = comm4.allreduce(stacked, "sum")
        m4, v4, s4 = htt.mean(X4, axis=0), htt.var(X4, axis=0), htt.std(X4, axis=0)
        km4 = htt.cluster.KMeans(n_clusters=K, init=init4, max_iter=ITERS, tol=-1.0).fit(X4)
        torch.cuda.synchronize()
        launches = {f"blockquant_{fn.__name__.removesuffix('_blocks')}": fn.launches for fn in counted}

        exact = stacked_np.astype(np.float64).sum(0)
        bound = POSITIONS * float(np.abs(stacked_np).max(axis=1).sum()) / 254.0
        got = red.cpu().numpy()
        check(got.shape == (PAYLOAD,) and bool(np.isfinite(got).all()), "allreduce_q output")
        check(float(np.abs(got - exact).max()) <= bound, "allreduce_q outside p*sum(absmax)/254")
        check(bool((got != exact.astype(np.float32)).any()), "allreduce_q did not quantize")
        unfused = ring_unfused(torch, cq, stacked, POSITIONS)
        check(bitwise_equal(red, unfused), "allreduce_q != the ring of unfused kernels, bitwise")
        # the documented ring bound on the per-position partial sums, over N
        parts = d64.reshape(POSITIONS, N // POSITIONS, F).sum(1)
        m_bound = POSITIONS * float(np.abs(parts).max(axis=1).sum()) / 254.0 / N
        m_err = float(np.abs(m4.numpy() - d64.mean(0)).max())
        check(m_err <= m_bound, f"int8 mean error {m_err} outside its bound {m_bound}")
        # var/std: the same bound on the per-position centered sums of
        # squares, which is what rides the ring
        ssd = ((d64.reshape(POSITIONS, N // POSITIONS, F) - d64.mean(0)) ** 2).sum(1)
        v_bound = POSITIONS * float(np.abs(ssd).max(axis=1).sum()) / 254.0 / N
        v_err = float(np.abs(v4.numpy() - d64.var(0)).max())
        s_err = float((np.abs(s4.numpy() - d64.std(0)) * d64.std(0)).max())
        check(v_err <= v_bound, f"int8 var error {v_err} outside its bound {v_bound}")
        check(s_err <= v_bound, f"int8 std error outside its bound")
        # KMeans: the EF ring's error on a step's sums is at most the ring
        # bound plus the carried residual, (p+1) * sum_i absmax_i / 254,
        # divided by the cluster's count for its center
        agree = float((km4.labels_.numpy() == labels1).mean())
        shift = float(np.abs(km4.cluster_centers_.numpy() - c1).max())
        blocks = d64.reshape(POSITIONS, N // POSITIONS, F)
        lab = labels1.reshape(POSITIONS, -1)
        sums = np.stack([np.stack([blocks[i][lab[i] == k].sum(0) for k in range(K)]) for i in range(POSITIONS)])
        count = np.bincount(labels1, minlength=K).min()
        c_bound = (POSITIONS + 1) * float(np.abs(sums).reshape(POSITIONS, -1).max(1).sum()) / 254.0 / count
        check(agree >= 0.999, f"int8 KMeans labels agree on {agree:.5f} < 0.999")
        check(shift <= c_bound, f"int8 KMeans centers {shift} from exact, bound {c_bound}")
        allreduce_ms = wall_ms(lambda: comm4.allreduce(stacked, "sum"), reps=9)
        fit4_ms = wall_ms(
            lambda: htt.cluster.KMeans(n_clusters=K, init=init4, max_iter=ITERS, tol=-1.0).fit(X4),
            reps=3,
        )
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the main path")
    # 34 rings (1 allreduce, 3 moments, 30 KMeans steps): 1 quantize, 3
    # hops and 1 dequantize each; 30 error-feedback residuals: 1 quantize
    # and 1 dequantize_fma each
    expected = {"blockquant_quantize": 64, "blockquant_dequantize": 34,
                "blockquant_dequantize_fma": 30, "blockquant_dequantize_add_quantize": 102}
    check(launches == expected, f"launches {launches} != {expected}")
    for row in kernel_rows:
        row["launches"] = launches[row["name"]]
    print(f"{POSITIONS} positions, int8_block: launches {launches} ({sum(launches.values())} in all); "
          f"allreduce bitwise equal to the unfused ring; allreduce error "
          f"{float(np.abs(got - exact).max()):.4g} (bound {bound:.4g}); var error {v_err:.4g} "
          f"(bound {v_bound:.4g}); KMeans labels agree {agree:.6f}, max center shift "
          f"{shift:.4g} (bound {c_bound:.4g})")

    # ---------------------------------------------------------------- 5
    attn_rows, attn_metrics = phase_attention_kernels(torch, fa, dev)

    # ---------------------------------------------------------------- 6
    attn_launches, path_metrics = phase_attention_path(torch, htt, fa, dev)
    for row in attn_rows:
        row["launches"] = attn_launches[row["name"]]

    # ---------------------------------------------------------------- 7
    lasso_launches, linalg_metrics = phase_linalg_lasso(torch, htt, cq, dev, data, counted)
    for row in kernel_rows:
        row["launches_by_phase"] = {"4": row["launches"], "7": lasso_launches[row["name"]]}
        row["launches"] += lasso_launches[row["name"]]
    # ---------------------------------------------------------------- 8
    rng_metrics = phase_rng(torch, htt, dev)
    kc_metrics = phase_kclusterers(torch, htt, dev, data, centers)
    nb_launches, est_metrics = phase_spectral_nb_knn(torch, htt, cq, dev, data, counted)
    for row in kernel_rows:
        row["launches_by_phase"]["8"] = nb_launches[row["name"]]
        row["launches"] += nb_launches[row["name"]]
    # ---------------------------------------------------------------- 9
    api_launches, api_metrics = phase_array_api(torch, htt, cq, dev, data, counted)
    for row in kernel_rows:
        row["launches_by_phase"]["9"] = api_launches[row["name"]]
        row["launches"] += api_launches[row["name"]]
    # ---------------------------------------------------------------- 10
    t10 = time.perf_counter()
    sort_launches, sort_metrics = phase_sort_stats(torch, htt, cq, dev, data, labels1, counted)
    sort_metrics["phase10_s"] = time.perf_counter() - t10
    for row in kernel_rows:
        row["launches_by_phase"]["10"] = sort_launches[row["name"]]
        row["launches"] += sort_launches[row["name"]]
    kernel_rows += attn_rows
    # ---------------------------------------------------------------- 11
    t11 = time.perf_counter()
    grid_metrics = phase_grid(torch, htt, dev, data)
    grid_metrics["phase11_s"] = time.perf_counter() - t11
    # ---------------------------------------------------------------- 12
    t12 = time.perf_counter()
    base_launches, base_metrics = phase_base_layer(torch, htt, cq, dev, data, centers, counted)
    base_metrics["phase12_s"] = time.perf_counter() - t12
    for row in kernel_rows:
        if row["name"] in base_launches:
            row["launches_by_phase"]["12"] = base_launches[row["name"]]
            row["launches"] += base_launches[row["name"]]
    print(f"phase 12: {base_metrics['phase12_s']:.1f} s; launches {base_launches}")
    # ---------------------------------------------------------------- 13
    t13 = time.perf_counter()
    io_launches, io_metrics = phase_io_stream(torch, htt, cq, dev, data, centers, counted)
    io_metrics["phase13_s"] = time.perf_counter() - t13
    for row in kernel_rows:
        if row["name"] in io_launches:
            row["launches_by_phase"]["13"] = io_launches[row["name"]]
            row["launches"] += io_launches[row["name"]]
    print(f"phase 13: {io_metrics['phase13_s']:.1f} s; launches {io_launches}")
    # ---------------------------------------------------------------- 14
    t14 = time.perf_counter()
    fuse_launches, fuse_metrics = phase_compiled(torch, htt, cq, dev, data, labels1, counted, card)
    fuse_metrics["phase14_s"] = time.perf_counter() - t14
    for row in kernel_rows:
        if row["name"] in fuse_launches:
            row.setdefault("launches_by_phase", {})["14"] = fuse_launches[row["name"]]
            row["launches"] += fuse_launches[row["name"]]
    print(f"phase 14: {fuse_metrics['phase14_s']:.1f} s; launches {fuse_launches} [{card}]")
    # ---------------------------------------------------------------- 15
    t15 = time.perf_counter()
    redist_launches, redist_metrics = phase_redistribute(torch, htt, cq, dev, data, counted, card)
    redist_metrics["phase15_s"] = time.perf_counter() - t15
    for row in kernel_rows:
        if row["name"] in redist_launches:
            row.setdefault("launches_by_phase", {})["15"] = redist_launches[row["name"]]
            row["launches"] += redist_launches[row["name"]]
    print(f"phase 15: {redist_metrics['phase15_s']:.1f} s; launches {redist_launches} [{card}]")
    # ---------------------------------------------------------------- 16
    t16 = time.perf_counter()
    serve_launches, serve_metrics = phase_serving(
        torch, htt, dev, data, counted, card, est_metrics["knn_predict_ms"],
        est_metrics["knn_predict_before_ms"])
    serve_metrics["phase16_s"] = time.perf_counter() - t16
    for row in kernel_rows:
        if row["name"] in serve_launches:
            row.setdefault("launches_by_phase", {})["16"] = serve_launches[row["name"]]
            row["launches"] += serve_launches[row["name"]]
    print(f"phase 16: {serve_metrics['phase16_s']:.1f} s; launches {serve_launches} [{card}]")
    # ---------------------------------------------------------------- 17
    t17 = time.perf_counter()
    fleet_launches, fleet_metrics = phase_fleet(torch, htt, dev, data, counted, card)
    fleet_metrics["phase17_s"] = time.perf_counter() - t17
    check(not any(fleet_launches.values()), f"phase 17 launched {fleet_launches}: the fleet runs no B1-B4")
    for row in kernel_rows:
        if row["name"] in fleet_launches:
            row.setdefault("launches_by_phase", {})["17"] = fleet_launches[row["name"]]
            row["launches"] += fleet_launches[row["name"]]
    print(f"phase 17: {fleet_metrics['phase17_s']:.1f} s; launches {fleet_launches} [{card}]")
    # ---------------------------------------------------------------- 18
    t18 = time.perf_counter()
    auto_launches, auto_metrics = phase_autoshard(torch, htt, cq, dev, counted, card)
    auto_metrics["phase18_s"] = time.perf_counter() - t18
    for row in kernel_rows:
        if row["name"] in auto_launches:
            row.setdefault("launches_by_phase", {})["18"] = auto_launches[row["name"]]
            row["launches"] += auto_launches[row["name"]]
    print(f"phase 18: {auto_metrics['phase18_s']:.1f} s; launches {auto_launches} [{card}]")
    # ---------------------------------------------------------------- 19
    t19 = time.perf_counter()
    lint_launches, lint_metrics = phase_linter(torch, htt, cq, dev, counted, card)
    lint_metrics["phase19_s"] = time.perf_counter() - t19
    check(not any(lint_launches.values()), f"phase 19 launched {lint_launches}: the linter runs no B1-B4")
    for row in kernel_rows:
        if row["name"] in lint_launches:
            row.setdefault("launches_by_phase", {})["19"] = lint_launches[row["name"]]
            row["launches"] += lint_launches[row["name"]]
    print(f"phase 19: {lint_metrics['phase19_s']:.1f} s; launches {lint_launches} [{card}]")

    metrics = {
        "kmeans_iter_per_s": ITERS / fit_ms * 1e3,
        "cdist_gb_per_s": SUB * SUB * 4 / cdist_ms / 1e6,
        "moments_gb_per_s": N * F * 4 * 2 / moments_ms / 1e6,
        "allreduce_q_exact_payload_gb_per_s": PAYLOAD * 4 / allreduce_ms / 1e6,
        "kmeans_int8_4pos_iter_per_s": ITERS / fit4_ms * 1e3,
        "allreduce_q_ms": allreduce_ms,
        **attn_metrics,
        **path_metrics,
        **linalg_metrics,
        **rng_metrics,
        **kc_metrics,
        **est_metrics,
        **api_metrics,
        **sort_metrics,
        **grid_metrics,
        **base_metrics,
        **io_metrics,
        **fuse_metrics,
        **redist_metrics,
        **serve_metrics,
        **fleet_metrics,
        **auto_metrics,
        **lint_metrics,
        "build_s": build_s,
        "run_s": time.perf_counter() - t_run,
        "card": card,
    }
    lines.append(json.dumps({"metrics": metrics}))
    lines.append(json.dumps({"kernels": kernel_rows}))
    lines.append(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    print(lines[0])
    print(card)
    print(lines[1])
    print(lines[2])
    if out_path:
        with open(out_path, "w") as fh:
            fh.write("\n".join([json.dumps({"card": card})] + lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
