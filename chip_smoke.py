#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It drives the
port (``cme213_tpu_torch``) and imports nothing of JAX or of the JAX
package.  ``--only GROUP[,GROUP]`` runs groups of phases alone:
``kernels`` (1-16), ``guarded`` (17-27), ``tooling`` (28-29), ``gang``
(30), ``serving`` (31), ``fleet`` (32) and ``multicard`` (33); a phase
number names its group.  Phase 1's identity always runs, and the build
with any group but ``fleet``; a group run without ``kernels`` makes what
it takes from phases 1-16 itself (``NEEDS``: pwtk and its f64 plain
solve, the hw5 set-up, B1's time, the headline lines, the sweeps' CSVs),
and ``tooling`` without ``guarded`` its calibration and flight dump.
Without ``--only`` every group runs, ``multicard`` only on a machine
with four cards or more (else a line says it was not run and why);
``--only multicard`` fails on fewer.  ``--parent DIR`` adds phase 15,
old-vs-new timing turns against the package of another tree (e.g. the
parent commit, unpacked with ``git archive``) found at
``DIR/cme213_tpu_torch``.  Before the last lines, the host-clock seconds
of each phase that ran (``phase N: S s``, then ``{"phase_seconds":
...}``).  Phases, each of which fails the run (non-zero exit) when it
fails:

1. Identity and build: the card's name and power limit (``nvidia-smi``),
   the torch and CUDA versions, and the time ``nvcc`` takes to build every
   library from ``cme213_tpu_torch/csrc`` (one ``nvcc`` per source, all
   started together; set-up, not measured work), with each kernel's
   registers and spills.
2. The example: ``apps.heat2d.run_single`` on ``examples/params.in``
   (512², order 8, 400 iterations) on ``cuda``: both phases pass the
   numpy-golden ULP-10 check, the kernel was launched, and the ladder
   (``ops.stencil_pipeline.run_heat_resilient``) served ``pipeline``
   undemoted after its first conformance probe.
3. Kernel against its plain version on the card, on the same CUDA
   tensors: ``run_heat_pipeline`` and ``run_heat_pipeline2d`` × k ∈
   {1,2,3,4,8} × order ∈ {2,4,8} at 1000² f32 (8·k iterations), f64
   cases, awkward shapes (257×121; 3999×4001, whose rows are not 16-byte
   aligned; 5×7, smaller than one tile), and the main path's shapes (512²
   and 4000², order 8).  Fails above 0 ULP: both round every operation
   alike.
4. Full size, the headline workload of ``bench.py``: 4000² order 8 f32.
   ``run_single`` with 1000 iterations, then each entry point at each k
   for 1000 iterations: ms/iter, GB/s and % of the card's memory peak, the
   bound, the plain version's and ``ops.stencil.run_heat``'s ms/iter, and
   ``library_ms``, one step of ``conv2d`` with the cross-shaped stencil
   (TF32 off), a yardstick the port never calls; each k's launch plan
   (tile, blocks an SM from the occupancy calculator, registers and local
   memory a thread).  Every kernel result is held to ``run_heat`` at 0
   ULP.
5. The SpMV-scan example (hw_final) through its CLI,
   ``apps.spmv_scan.main``, in a temporary directory: ``gen`` at its
   default size (n = 100,000, p = 1,000, q = 999, seed 0), then a run with
   ``cpu_check`` for each of ``--kernel=pallas-fused`` (B7) and
   ``--kernel=pallas`` (B6), each through the ladder, whose first use of
   the kernel runs its conformance probe; each must print "Worked!" (the
   numpy f64 golden at rel L2 ≤ 1e-4 and rel L∞ ≤ 1e-3).
6. A real instance at full size: the suite's Williams/dense2
   reconstruction (``dense2_problem(iters=10, seed=0)``: n = 4,000,000,
   2,000 segments, N = 10) through ``run_spmv_scan`` with each kernel, held
   to ``external_check`` (the f64 golden) at rel L2 ≤ 1e-4, rel L∞ ≤ 1e-3.
7. B6 and B7 against their plain versions on the same CUDA tensors: n ∈
   {1, 31, T−1, T, T+1, 3T+5, 100,003, 2²²} (T = 2048, the kernel's tile)
   × heads {one segment, every element, on tile boundaries, random}, B7 at
   1 and 8 iterations; one head over n = 2²⁴ (the look-back's longest
   walks); and the main path's full-size shape (below).  Fails above 0
   ULP: both make the same additions in the same order.
8. Full size, the suite's largest instance: ``suite_problem("pwtk")``
   (n = 11,634,424, p = 217,919, N = 25) through ``run_spmv_scan`` with
   ``pallas-fused``, ``pallas``, ``auto`` (blocked torch) and ``flat``:
   ms per iteration (CUDA events, one warm-up, best of 2), GB/s against
   ``spmv_scan_cost`` and % of the card's memory peak, the bound; each
   result held to the plain version run in float64 on the card at rel L2
   ≤ 1e-5 and rel L∞ ≤ 1e-3 (``auto``, the blocked scan: rel L2 ≤ 1e-4,
   see ``PWTK_TOL``).  Three more B7 solves must be bitwise equal to the
   first (the look-back's carry does not depend on which blocks finish
   first).  Then B6 alone per scan, the plain versions
   in f32, and ``torch.cumsum`` of n f32 as a yardstick the port never
   calls (no single PyTorch call computes a segmented scan, so
   ``library_ms`` is null).

9. B3, the shard kernel (``stencil_local_multistep``), against its plain
   version on the same CUDA tensors: the K-padded shard blocks the
   distributed solve assembles (``dist/heat._assemble_padded``) from a
   seeded 2000² interior — corners of a 2×2 mesh, an edge stripe of a
   1-D mesh of 4, the interior shard of a 3×3 mesh (2001²), a ghost-padded
   shard of a 2×2 mesh over 1999×2001 — × order ∈ {2,4,8} × k ∈
   {1,2,3,4,8} in f32, and f64 cases, one launch a shard; then all nine
   shards of the 3×3 mesh in one launch (``stencil_local_multistep_shards``,
   exactly one launch counted).  The rows and columns ``[K, H−K)`` are
   compared; fails above 0 ULP.
10. The distributed heat solve (hw5) at the reference's largest size,
   2000², order 8, 1000 iterations, on four shards of the one card
   (``core.virtual_devices(4)``): ``apps.heat2d.run_distributed`` for 1-D
   stripes and 2-D blocks × sync and async with the ``xla`` local step and
   for 1-D and 2-D with ``pallas`` (B3); then ``run_distributed_heat`` on
   the 2-D mesh at k ∈ {2, 4} with each local kernel, and with ``pallas``
   on a 1-shard mesh.  Every result is held to ``ops.run_heat`` on the
   card within ULP-10 (the ``pallas`` paths at 0 ULP).  Each path is timed
   again through ``prepare_distributed_heat`` (``iterate()`` times the
   step loop between device synchronisations): ms/step, GB/s and % of the
   memory peak by ``roofline.heat_cost``, and the bound.  Then B3 alone on
   the 2-D path's four padded blocks (ms per step at k ∈ {1,2,4}, CUDA
   events around many calls, so the host's work is in the time): the
   batched call (one launch for the four), and for the record the loop of
   four single-shard calls; its plain version and ``library_ms``:
   ``conv2d`` over each padded block with the cross-shaped stencil (TF32
   off).  Then the device's idle share of the 2-D ``pallas`` path's step
   loop over a short ``torch.profiler`` window (CUDA activity only: 1 −
   the union of the device's kernel and copy intervals ÷ the window's
   host-clock length; also against the same loop's unprofiled length,
   since the profiler's own host work stretches the window).  Last, the
   CLI,
   ``heat2d.main([..., "examples/params_dist.in", "--distributed",
   "--local-kernel=pallas"])`` in a temporary directory, a 1×1 mesh of
   the physical card: its dumps must exist and its grid equal
   ``ops.run_heat``'s within ULP-10.
11. The sharded SpMV-scan at pwtk: ``run_spmv_scan_distributed`` over four
   shards of the card (``ring`` carries), held to phase 8's f64 plain run
   at ``auto``'s bound (rel L2 ≤ 1e-4, rel L∞ ≤ 1e-3: the per-shard scan
   is the blocked one), ms per iteration.

12. B4 and B5, the band-staged stencil (``ops.stencil_pallas``), against
   their plain versions on the same CUDA tensors: ``run_heat_pallas`` (B4,
   k = 1) and ``run_heat_multistep`` (B5) × order ∈ {2,4,8} × k ∈
   {1,2,3,4,8} at the sweeps' tiles (40, 80, 200, 400 at 2000²; a cell
   whose windows fit no block is listed and skipped), the main path's
   4000² tile 200 at k ∈ {1,2,4,8}, 255×121 at tile 85 (a ragged row
   chunk) at orders 2, 4 and 8, 3999×4001 (rows not 16-byte aligned), f64
   at every k class, and B4 (and ``stencil_interior_pallas``, which writes
   a bare array) at orders 2, 4 and 8 on a halo that does not hold the
   boundary values.  Fails above 0 ULP.  Prints each case's launch plan
   (strip width, threads, micro-tile rows, buffers, run, blocks an SM,
   registers, local memory) and fails if an instance spills.
13. B8, the tiled transpose (``ops.transpose.transpose_pallas``), against
   ``x.t().contiguous()``: 4096² f32 with tile 256, a non-square shape and
   1-, 2-, 4- and 8-byte dtypes; bit for bit.
14. The sweep harness at full size, the slice's main path:
   ``bench.run_all.main(["--out", tmp, "--only",
   "heat_kernels,pallas_tile,scan_bandwidth"])`` (4000² order 8 × 64
   iterations of every heat kernel; 2000² order 8 × 100 iterations at
   tiles 40, 80, 200, 400; 2^26-float scans and the 4096² transpose).
   Every CSV row must have an empty ``error``.  Then one full-size
   ``run_heat_pallas`` and one ``run_heat_multistep`` per k, held to
   ``ops.run_heat`` at 0 ULP; B4 and B5 per step and B8 per call (CUDA
   events) beside their bounds, plain versions and library calls
   (``conv2d``, phase 4's; ``x.t().contiguous()``), with each cell's plan;
   B4 at each ``pallas_tile`` cell by CUDA events and by the host clock,
   beside that cell's bound; the device's idle share of a 100-step B4
   solve at 2000² tile_y 200 (as phase 10 measures it); and the other
   ported sweeps at ``--quick`` as a coverage run (exit 0, no error row).

15. With ``--parent DIR``: old-vs-new turns, parent, this tree, this
   tree, parent, in one process on one card: B1 and B2 at 4000² order 8
   (ms per step at k ∈ {1,2,4,8}; B2 at k = 1), with ``heat_stencil.cu``'s
   ptxas report (registers, spills) compared to the parent's build; B4
   and B5 at 4000² tile_y 200 (k ∈ {1,2,4,8}); B4 at 2000² at each
   ``pallas_tile`` tile, by CUDA events and by the host clock; B3 alone on
   the four 1008² blocks (the parent's loop of four launches against the
   batched call) and the 2-D ``pallas`` distributed solve at 2000² (ms
   per step by ``iterate()``); B7 (ms an iteration) and B6 (ms a scan) at
   pwtk, each result held to its own tree's plain version at 0 ULP and to
   phase 8's f64 reference under ``PWTK_TOL`` (parent and new differ in
   bits by design: their carries associate differently); and B7 and B6
   again with one head over pwtk's values (one segment across all tiles,
   the look-back's longest walks), each held to its plain version at 2
   iterations.  The parent's
   package is imported under another name and builds its kernels into its
   own tree.
16. The runtime core and the headline bench, as a user runs them:
   ``python -m cme213_tpu_torch doctor --json`` must report the card
   healthy, with ``torch.cuda.device_count()`` CUDA devices and the card's
   name; ``python -m cme213_tpu_torch.bench.headline`` (each candidate in
   its own child process, 4000² order 8) in f32, where every row must be
   ok, each pipeline row with one tile, and ``pct_hbm_peak`` against the
   card's peak, then ``--dtype=f64`` (``xla``); each pipeline row's
   host-clocked ms/iter is printed beside phase 4's CUDA-event time of
   the same kernel and k; ``--spmv``, whose ``pallas`` (B6) and
   ``pallas-fused`` (B7) rows at 2^16, 2^20 and 2^22 must carry no error.
   Each child's row and the ``--spmv`` line report their kernel launches,
   which must be what their runs imply.  Their JSON lines are printed with
   the seconds each took.  Then one
   child's measurement in this process, ``measure_one("pipeline-k1",
   "f32")``, whose B1 launches must be exactly two calibration runs and
   the final-count runs its row reports.
17. The guarded main path at full width: ``run_single`` at 4000² order 8
   f32, 1000 steps, with the conformance verdicts and the program cache
   emptied first, then again in the same process.  The first run must be
   served by ``pipeline`` undemoted after exactly one ``conformance-probe``
   (ok) of ``pipeline``; the second must make no program-cache miss and no
   probe; both grids 0 ULP from ``ops.run_heat``.  Prints each probe's
   milliseconds, each ``heat.compile`` span (a miss), and the "gpu
   computation shared" ms/step of each run beside phase 4's CUDA-event
   time of B1 at k = 1, with the gap.
18. Injected demotions at 4000² order 8, 100 steps, each in a child
   process of its own, all started together: ``fail:heat.pipeline`` and
   ``wrong:heat`` are served by ``pipeline2d`` (B2; one ``wrong:`` clause
   perturbs the first probe only); ``wrong:heat,wrong:heat`` refuses both
   kernel rungs, so the ladder raises, and with ``plain_fallback=True``
   is served by ``xla``; ``oom:heat.pipeline`` is served by ``pipeline``
   at half the picked ``tile_y``; each served result 0 ULP from
   ``ops.run_heat``.
19. The SpMV-scan ladder: pwtk through ``run_spmv_scan`` with
   ``pallas-fused`` (cold since phase 17: the probe's 4 launches, the
   warm-up and ``n_it``) served undemoted within the CLI's bounds of the
   f64 run; the gen example with
   ``--canonical`` (n = 100,000 into the 131,072 bucket) through the
   bucket gate, bitwise equal to the unpadded solve; then on the gen
   example ``fail:spmv_scan.pallas-fused`` served by ``pallas`` (B6),
   both kernels failed raising, and both failed with
   ``plain_fallback=True`` served by ``flat``; each served result within
   the CLI's bounds of the f64 golden (rel L2 ≤ 1e-4, rel L∞ ≤ 1e-3).
20. The distributed gates: ``run_distributed_heat`` at 2000² order 8 on
   the 2×2 mesh of four virtual shards with ``pallas`` and
   ``conformance=True`` (verdicts emptied first): one probe ``pallas-k1``
   ok, no demotion, bit for bit phase 10's one-device ``run_heat``; and
   ``make_iterated_sharded_scan_gated`` on four shards serves ``ring``.
21. The tuner: ``tune run --op heat`` at 4000² order 8 k = 1 over
   ``tile_y`` ∈ {picked/2, picked, 2·picked} (and ``xla``), 100 steps a
   trial, median of 5, every clock read
   after a device synchronise, into a temporary ``CME213_TUNE_CACHE``;
   each candidate's median printed; then ``run_heat_resilient`` with open
   tile knobs must resolve the winner from that cache (``tune-hit``) and
   run at its ``tile_y``.
22. ``python -m cme213_tpu_torch doctor calibrate --json`` exits 0 with
   its five rows (the roofline models of spmv_scan and heat against a
   torch rung's FlopCounterMode count and a kernel rung's launch plan, and
   ``torch.sort`` of 4096 keys against ``sort_cost``).
23. The checkpointed heat solve at the headline grid (4000² order 8 f32,
   1000 steps, a checkpoint every 250, in a temporary directory):
   ``apps.heat2d.run_heat_checkpointed`` equals the uninterrupted
   ``ops.run_heat`` bit for bit with one ``solver-progress`` event a
   chunk; a run to 500 steps and a second call to 1000 from the same path,
   ``nan:heat2d:2`` (a rollback) and ``oom:heat_chunk:1`` (250 → 125) each
   equal it bit for bit.  Prints ms a chunk (the ``checkpoint.chunk``
   spans, the guard's wait for the device included) and ms a save (the
   ``checkpoint.save`` spans: copy to the host, CRC, ``np.savez``,
   rename), the saves' share of the solve's host-clock time and the
   share checkpointing adds over the uninterrupted solve.  The
   preflight's byte count (``ops.stencil.run_heat_bytes``) must lie within
   [1×, 2×] of one chunk's measured peak (the rise of
   ``max_memory_allocated()`` over ``memory_allocated()`` before it), and a
   ``CME213_MEMORY_BUDGET`` one byte below the count refuses the solve
   (``AdmissionError``) with no chunk run.
24. The checkpointed SpMV-scan at pwtk (25 iterations, a checkpoint every
   5) with ``auto``, ``flat`` and ``blocked``: each equals
   ``apps.spmv_scan._iterate`` on the card bit for bit, within
   ``PWTK_TOL`` of phase 8's f64 plain solve, one ``solver-progress``
   event a chunk; resume, ``nan:spmv_scan:2`` and
   ``oom:spmv_scan_chunk:1`` as in phase 23, and the preflight's count
   (``apps.spmv_scan.spmv_chunk_bytes``, the scan's workspace from
   ``ops.segmented.scan_peak_bytes``) within [1×, 2×] of one chunk's
   measured peak, as in phase 23.
25. The batched heat solve, B = 8 lanes with per-lane CFL factors (alpha
   drawn from the seed): the serving traffic's class (24², order 2, 4
   steps; ``cme213_tpu/serve/loadgen.py``) and ``examples/params.in``
   (512², order 8, 400 steps).  Every lane equals its serial
   ``ops.run_heat`` bit for bit; ms a batch (warm, results on the host)
   beside 8 serial solves that also end on the host, host clock between
   device synchronisations; and the solves alone, stacked and serial, on
   tensors already on the card (CUDA events).
26. The batched SpMV-scan: B = 8 at n = 512 and 1024, 6 iterations, with
   ``flat`` and ``blocked`` (the load generator's classes), and B = 4 at
   pwtk with ``blocked``.  Every lane equals its serial ``_iterate`` bit
   for bit; ms a batch beside the serial solves, each of which also
   uploads its problem (``problem_tensors``) and copies its result back;
   and the solves alone, as in phase 25.
27. The flight recorder on the card: a child process with
   ``CME213_FLIGHT_DIR`` set and ``CME213_FAULTS=nan:heat2d:1,
   nan:heat2d:2`` runs a checkpointed 4000² heat solve with
   ``max_retries=1`` and dies of the unhandled ``NonFiniteError``.  It
   finds CUDA uninitialised at its start and after a first dump (which
   names no card); the abort's dump, taken inside the open
   ``checkpoint.chunk`` span, and the excepthook's both name the card.
   The seconds of phases 23-27 are printed, and their numbers on a
   ``{"runners": ...}`` line.  These runners launch no hand-written
   kernel: their paths are counted and must launch none.
28. The telemetry tooling on the card, over traces of the main path.
   ``python -m cme213_tpu_torch heat2d`` at the headline size (4000²
   order 8 f32, 1000 steps, through the ladder onto B1, cold) and
   ``spmv_scan a.txt x.txt cpu_check --kernel=pallas-fused`` on pwtk (B7,
   the problem written to files first), each a child process with its
   ``CME213_TRACE_FILE`` sink; a child's launches come from the
   ``kernel.launches.*`` counters of its sink's final metrics snapshot
   and must be exactly those of its cold path (B1: 1000 + the warm-up +
   the probe's 5; B7: 25 + 1 + 4).  Then, in this process, a traced
   checkpointed 4000² solve (no kernel), and the ladder's 4000² solve
   untraced and traced in turns (untraced, traced, traced, untraced; ms
   per step by the host clock between device synchronisations: the
   spans' and sink's cost) and once under ``CME213_DEVICE_PEAKS`` at half
   the card's memory rate.  Over those sinks, through the workload table
   (``python -m cme213_tpu_torch``'s entry) in this process: ``trace
   summary --json --require heat.run,conformance-probe`` exits 0 and its
   ``heat.run [pipeline]`` row carries ``pct_peak`` = 100 × ``best_gbs``
   / the card's peak (``roofline.attribute`` names the normalised
   device), twice that share under the override; ``trace timeline``;
   ``trace export`` (Chrome JSON with a B/E pair per ``heat.run``);
   ``trace metrics`` (the launch counters); ``numerics report
   --forbid-stall --json`` over the checkpointed sink (4 epochs, not
   stalled); ``trace flight`` over phase 27's abort dump, whose platform
   line names torch, CUDA and the card; the ms of one flight dump;
   ``collect --once --json`` and ``top --once --json --hb-dir`` over
   every sink and a heartbeat file.  ``bench.run_all --quick --only
   heat_kernels,scan_bandwidth`` under ``CME213_PROFILE_DIR``: its
   profiler trace must show ``heat_ksteps``, ``heat_band`` and
   ``transpose_kernel``, with one memory snapshot a sweep.
   ``bench.regress`` of phase 14's CSVs against themselves passes
   ``--strict``, a copy with one ``gbs`` cut by 20% exits 1, and
   ``--bench`` on phase 16's f32 line skips every ``BENCH_r*.json`` of
   the checkout; ``bench.batch`` of ``cme213_tpu_torch/jobs/spmv_scaling.job``
   at one of its sweep points (``OMP_NUM_THREADS=1``; a child) exits 0; ``bench.report`` renders the headline lines, the
   CSVs, the verdict and the batch summary.  The numbers go on a
   ``{"telemetry": ...}`` line with the card's name and power limit.
29. The hw1, hw3 and hw4 workloads on the card at the reference's own
   sizes (plain torch and host code: each path is counted and launches no
   hand-written kernel, but the suite sweep's B7).  Cipher:
   ``apps.cipher.run_cipher`` on the shipped corpus ×16 (20,004,128 B),
   every variant byte-exact, then each variant by CUDA events against
   ``cipher_cost``.  PageRank: ``apps.pagerank.main`` at its defaults (2^21
   nodes, average 8 edges, 20 iterations; "Worked!" by ULP-10), then the
   same graph again held bitwise to ``host_graph_iterate`` and a second
   solve bitwise to the first; ms by CUDA events, GB/s by
   ``pagerank_cost``, the bound.  Vigenère: the ``create`` and ``solve``
   CLIs on the shipped corpus with period 7 must print the key and write
   the sanitised text back.  Sorts: the ``sorts`` CLI at its defaults
   (1,000,000 keys: native merge, radix and serial radix, and the device
   radix) exits 0; the device radix, bitonic and ``torch.sort`` of 2^20
   uint32 keys are exact, with ms (CUDA events) and each one's peak device
   bytes over its input.  ``tune run --op sort`` at 2^20 into a temporary
   cache, and ``sort_auto`` must resolve its winner (``tune-hit``) and sort
   exactly; phase 22's sort row is printed.  ``bench.run_all --only`` the
   five sweeps this slice ports, full size but ``spmv_suite`` at scale
   ``SUITE_SWEEP_SCALE`` (its full table: a call of its own), every row
   without an error and ``ok``, the suite's ``flat`` and ``pallas-fused``
   rows within ``rel_l2`` ≤ 1e-2 of the f64 golden (float32 rounding over
   up to 77 iterations costs up to ~2e-3 there) and its ``blocked`` rows
   finite (the JAX package's blocked scan cancels, a few 1e-2); its
   ``pallas-fused`` rows' B7 launches are recorded.  Last, phase 28's pwtk files through
   ``load_problem`` with the native and the Python tokenizer: the
   ``spmv_scan.load`` span must name each, the problems bitwise equal, the
   seconds of each printed.  The numbers go on a ``{"workloads": ...}``
   line.
30. The hw5 solves as a gang of two processes on the one card (gloo, the
   slabs staged through the host; 2000², order 8, 1000 steps, as phases 10
   and 20), each through ``python -m cme213_tpu_torch.dist.launch`` with
   every process's sink at ``{tag}-{rank}.jsonl``; a worker script runs
   each rank's command (the heat CLI's ``main`` with the distributed grid
   caught at full precision, or the supervised SpMV-scan).  (a) ``--np 2
   --devices-per-proc 2`` of ``heat2d P --distributed
   --local-kernel=pallas`` with gridMethod 2 (a 2×2 mesh, a row of it a
   rank): both ranks name gloo, each rank's grid is bit for bit the
   single-process 2×2 ``pallas`` solve, each launches B3 exactly 1000 + 4
   (the probe) times (its sink's ``kernel.launches.local``), the dumps
   exist; the solve's seconds (``dist_heat.solve_s``) against phase 10's
   single-process seconds, and the share of them its cross-rank exchanges
   took (``dist_heat.exchange_s``).  (b) the same with ``--supervised``,
   ``--stall-timeout 60 --max-restarts 1 --ckpt-every 250`` under
   ``rankkill:1:1``: exit 0, the kill, the verdict and the restart in the
   output, both ranks' grids bit for bit ``run_heat``'s; ``commit.ms``
   p50 and max (rank 0's ``epoch-commit`` events), the seconds from the
   kill to the verdict and to the resumed incarnation's first beat, and
   each incarnation's start-up (gang-launch to its ranks' first beats).
   (c) a worker whose rank 1 freezes after its first beat, ``--stall-timeout
   5``: condemned by the stall clock (the detection seconds from its beat
   to the verdict), both ranks complete in the second incarnation; its
   ranks touch no card, so it runs beside (d) and (e).  (d)
   (b)'s last commit resumed in this process on a 1-D mesh of 4 shards for
   250 more steps: bit for bit a 1250-step ``run_heat``.  (e)
   ``run_spmv_scan_distributed_supervised`` at pwtk on a 2-rank gang of 2
   shards a rank, a commit every 5 iterations, uninterrupted and under
   ``rankkill:0:2``: the two bit for bit, within ``PWTK_TOL["auto"]`` of
   phase 8's f64 plain run; ms an iteration of the supervised solve.  The
   numbers go on a ``{"gang": ...}`` line.
31. The serving front end on the card (``cme213_tpu_torch/serve``; every
   rung plain torch, as the JAX package serves XLA programs only, so
   every path is counted and must launch no hand-written kernel).  (a)
   ``python -m cme213_tpu_torch serve loadgen --mix spmv,heat,cipher,sort
   --requests 64 --json`` in a child on ``cuda`` in ``--mode closed`` and
   ``--mode open``, then ``serve warmup --json`` (each child's launches
   from its sink): the report and its JSON line (req/s, p50 and p99 per op
   and phase, batch sizes, sheds); the same two runs in this process
   (``loadgen.run_load`` on a ``Server(device="cuda")``), every OK result
   bit for bit its own serial solve on the card.  (b) Full size under
   ``CME213_MEMORY_BUDGET=10G``: 4 heat requests at 2000² order 8 × 200
   steps, 4 SpMV requests at pwtk (10 iterations, padded to 2^24) served
   on ``blocked`` and (degraded mode) ``flat``, 8 cipher requests of the
   corpus ×16 (20,004,128 B) on ``packed``, 8 sorts of 2^20 keys on
   ``radix`` (the batch must shrink: ``chunk-shrunk``) and ``bitonic``:
   the admitted widths, ms a request, req/s, the batched-vs-serial ratio
   (the same requests through ``max_batch=1``), the peak bytes beside the
   adapter's preflight count, the idle share of one batch (``idle_share``),
   every lane bit for bit its serial solve.  (c) A ``TransportServer``
   over a card ``Server``: 2000 ``stub`` requests from a v2 client on the
   shared-memory lane, 16 in flight (req/s, the codec's share of the p99
   RTT), and 17 cipher requests over the wire (one of 20 MB, over the
   socket) bit for bit the in-process results.  (d) A PageRank job (4096
   nodes, 48 iterations, epochs of 8) submitted over the wire and run on
   ``cuda`` by a ``JobExecutor``: preempted by interactive traffic after
   two epochs, its replica closed, resumed by a new executor (``restart``),
   each epoch run once, the result bit for bit ``host_graph_iterate``.
   The numbers go on a ``{"serving": ...}`` line; the script's wall time
   is printed.

32. The replicated fleet on the card (``serve/fleet.py`` behind ``python
   -m cme213_tpu_torch fleet up`` in a child; replicas serve phase 31's
   plain torch rungs, each inheriting ``CME213_MEMORY_BUDGET`` = the
   card's memory / 2).  (a) Two replicas over phase 31's mix: ``serve
   loadgen --transport`` children closed and open (req/s, p50/p99), then
   the same 64 requests from client threads closed and open (round trips
   per op), every result bit for bit its serial solve on the card; the
   card's used memory sampled throughout.  (b) The same under
   ``CME213_FAULTS=replica-kill:1:2``: submitted − shed == served, the
   requeues, the requests the flight dump confirmed in flight, the kill
   (the dump's time) to the relaunched replica's ``replica-up`` (ready
   for the front end's ping), the p99 against (a)'s.  (c) ``--autoscale
   --slo-p99-ms 0.001`` under cipher load: up to 3 replicas and back to
   2 once the load stops, the seconds to each.  (d) A PageRank job
   through ``fleet up --jobs-dir`` and ``fleet jobs``, its replica killed
   after epoch 2 by an interactive request (``replica-kill:0:1``): the
   relaunched incarnation resumes it, every epoch runs once, the result
   bit for bit ``host_graph_iterate``.  (e) ``chaos run --backend fleet
   --replicas 2 --campaigns 4 --seed 1 --mix cipher,sort,heat --device
   cuda`` exits 0 (campaigns a minute, the cocktails); a ``--disable
   drift-compensation`` drill violates, shrinks and banks into a
   temporary directory; ``chaos replay`` of the repository's four
   fixtures and the drill's matches every ``expect``.  (f) No replica
   process and no ``psm_`` segment left; no hand-written kernel launched
   by any replica, campaign or drill (their sinks' exit snapshots).  The
   numbers go on a ``{"fleet": ...}`` line.  ``--only fleet`` runs this
   phase alone (nothing is built).
33. Four cards (``--only multicard``; the default run on a machine with
   four or more).  (a) One process, a mesh over ``cuda:0``-``cuda:3``, a
   shard a card (halos peer to peer): phase 10's runs at 2000² order 8 ×
   1000 (1-D and 2-D × sync and async with ``xla``; 1-D and 2-D with
   ``pallas``; the 2-D mesh at k ∈ {2, 4} with each), each bit for bit the
   same run on four shards of ``cuda:0``, with B3's launches on each card
   (``ops.stencil_pipeline.LOCAL_LAUNCHES``: ``iters / k``, plus the gate's
   probe on a first use), ms a step on four cards and on the four shards
   of one card, and one exchange alone beside its steps; then the 2-D
   ``pallas`` solve at 8000² order 8 × 200 (a 4000² block a card), bit
   for bit ``ops.run_heat`` on ``cuda:0``, beside B1's ms a step there.
   (b) Phase 11's sharded SpMV-scan at pwtk over the four cards, bit for
   bit the four shards of ``cuda:0``, ms an iteration.  (c) ``python -m
   cme213_tpu_torch.dist.launch --np 4``, one rank a card: ``heat2d P
   --distributed --local-kernel=pallas`` for gridMethod 2 and 1 on NCCL,
   and gridMethod 2 again with ``--backend gloo`` (host-staged); every
   rank names its backend, as the ``gang-launch`` span does, each rank's
   grid is bit for bit (a)'s, B3 launched ``iters`` + the probe's in each
   rank, ``solve_s`` and ``exchange_s`` by rank and backend.  (d) The
   supervised NCCL gang: ``--supervised --ckpt-every 250`` under
   ``rankkill:1:1`` (exit 0, the restart, every rank's grid bit for bit
   ``run_heat``'s), and ``run_spmv_scan_distributed_supervised`` at pwtk
   on 4 ranks uninterrupted and under ``rankkill:0:2`` (bit for bit the
   same); kill to verdict and each incarnation's start-up.  The numbers go
   on a ``{"multicard": ...}`` line.

The main paths are what phases 2, 4, 5, 6, 8, 10, 11, 14, 16, 17-20, 28,
29, 30, 31 and 32 drive through the entry points a user calls: ``run_single``
at 512² and at 4000² (kernel B1, through the ladder), one solve of each of
``run_heat_pipeline`` and ``run_heat_pipeline2d`` (B2) at each k, the
SpMV-scan runs (B6 through ``pallas``, B7 through ``pallas-fused``), the
distributed heat solves (B3 through ``pallas``),
the sharded SpMV-scan, the full-size sweeps (B4, B5, B8, and B1, B2 through
their rows), the full-size solves of phase 14, the headline's child
measurement of phase 16 (B1), phase 28's traced runs (B1 through the
``heat2d`` CLI and the ladder's turns, B7 through the ``spmv_scan`` CLI,
and B1, B2, B4, B5 and B8 through the profiled sweeps, whose counts are
recorded but not predicted), phase 29's suite sweep (B7, recorded),
phase 30's gang (B3 in each rank, read from its sink) and phase 33's
four-card runs (B3 on each card, and in each rank of its gangs); phase
31's serving
paths and phase 32's fleet launch none.  Every launch count
(``ops.stencil_pipeline.LAUNCHES``, ``ops.segmented_pallas.LAUNCHES``,
``ops.stencil_pallas.LAUNCHES``, ``ops.transpose.LAUNCHES``) is set to 0
just before each of these paths and read just after; each path must launch
exactly its own kernels, ``iters + 1`` times for ``run_single`` and
``run_spmv_scan`` on a program-cache miss (one untimed step or iteration,
then the solve) and ``iters`` on a hit, plus a gate's probe on the first
use of a kernel rung (5 launches for heat: the probe program's warm-up
and 4 k-step launches; 4 for the SpMV-scan kernels: a warm-up iteration
and the probe's 3), ``iters / k`` times for a heat solve, ``devices ×
iters / k`` for a distributed solve with ``pallas`` (one launch a device
for all its shards) plus 4 for its gate's probe solve on the first use of
a (mesh, k, order), for the
headline's child what its row reports, and for the sweeps what their loops imply (each heat row
runs its solve twice, warm-up and timed; the transpose row calls its kernel
``1 + sweeps.TIME_ITERS`` times); ``auto``, ``flat``, the ``xla``
distributed solves and the sharded SpMV-scan launch none.  The launches of
phases 3, 7, 9, 12 and 13's comparisons and of the timed repeats are not
read.

The lines before the last: the card's identity, then one JSON object
``{"kernels": [...]}`` with each kernel's launches on its full-size main
path (``launches``) and on every path (``launches_by_path``), its error,
times and bound (B1, B2, B4, B5: ms per step at 4000² order 8 f32, k = 1
and for B5 k = 2, with every k in ``per_k``; B3: ms per step of the
batched call, one launch on the 2-D pallas path's four 1008² blocks at
2000²; the scan: ms per iteration or per
scan at pwtk; B8: ms per 4096² f32 transpose); B1, B2, B6 and B7 also
carry their rows of phase 16's headline (``headline``).  The last line:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import csv
import glob
import io
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = {"pipeline": "cme213_tpu_torch/csrc/heat_stencil.cu",
          "pipeline2d": "cme213_tpu_torch/csrc/heat_stencil.cu",
          "local": "cme213_tpu_torch/csrc/heat_stencil.cu",
          "segscan": "cme213_tpu_torch/csrc/segmented_scan.cu",
          "spmv_fused": "cme213_tpu_torch/csrc/segmented_scan.cu",
          "stencil_full": "cme213_tpu_torch/csrc/heat_band.cu",
          "multistep": "cme213_tpu_torch/csrc/heat_band.cu",
          "transpose": "cme213_tpu_torch/csrc/transpose.cu"}
REPLACES = {"pipeline": "cme213_tpu/ops/stencil_pipeline.py:169",
            "pipeline2d": "cme213_tpu/ops/stencil_pipeline.py:558",
            "local": "cme213_tpu/ops/stencil_pipeline.py:656",
            "segscan": "cme213_tpu/ops/segmented_pallas.py:140",
            "spmv_fused": "cme213_tpu/ops/segmented_pallas.py:182",
            "stencil_full": "cme213_tpu/ops/stencil_pallas.py:115",
            "multistep": "cme213_tpu/ops/stencil_pallas.py:241",
            "transpose": "cme213_tpu/ops/transpose.py:34"}
MAX_ULPS = 10
#: launches of one heat gate probe (``ops/stencil_pipeline.
#: _heat_conformance_gate``): its program's warm-up launch, then 4k steps
#: in k-step launches
HEAT_PROBE_LAUNCHES = 5
#: launches of one distributed-heat gate probe on one card
#: (``dist/heat._gated_heat_config``): a 4k-step solve in k-step launches,
#: one launch a device for all its shards
DIST_PROBE_LAUNCHES = 4
FULL_N, FULL_ORDER, FULL_ITERS = 4000, 8, 1000
#: hw5's largest size (BASELINE.md, hw5 table), on four shards of the card
DIST_N, DIST_ITERS, DIST_SHARDS = 2000, 1000, 4
#: the SpMV-scan kernels by ``run_spmv_scan`` kernel name, and the full size
SCAN_KERNELS = {"pallas-fused": "spmv_fused", "pallas": "segscan"}
SUITE = "pwtk"
NO_LIBRARY = "no single PyTorch call computes a segmented scan"
#: the sweeps the slice's main path runs at full size (phase 14), and the
#: others, run at --quick as a coverage run
SWEEP_PATH = ("heat_kernels", "pallas_tile", "scan_bandwidth")
#: the band kernel's main-path tile at 4000² (heat_kernel_sweep's
#: pick_tile(4000, 200)) and the transpose's side and tile (scan_sweep)
BAND_TILE, SIDE, SIDE_TILE = 200, 4096, 256
#: (rel L2, rel L∞) of each pwtk result from the f64 plain run.  ``auto`` is
#: the blocked scan, whose local sums are cumsums over 4096-element blocks
#: minus the cumsum before the segment's head, taken in float64 and rounded
#: once; it is held to the engine's own pass bound (``apps/spmv_scan.py``
#: ``cpu_check``), since an ill-conditioned segment can amplify any scan's
#: rounding past 1e-5 (pwtk's shape at seed 3100000005, on an H100: 5.1e-5);
#: ``blocked`` by name (phase 24) is the same scan.
PWTK_TOL = {"pallas-fused": (1e-5, 1e-3), "pallas": (1e-5, 1e-3),
            "flat": (1e-5, 1e-3), "auto": (1e-4, 1e-3),
            "blocked": (1e-4, 1e-3)}


def fail(msg: str) -> None:
    if PHASE_SECONDS or _OPEN_PHASE:
        phase(None)
        print(f"phase seconds until the failure: "
              f"{json.dumps(PHASE_SECONDS)}", file=sys.stderr)
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def idle_share(torch, run, steps):
    """The device's idle share over ``run()``, a loop of ``steps`` steps
    (after a warm-up): 1 − (union of the CUDA kernel and copy intervals the
    profiler saw) ÷ (the host-clock length of the loop, synchronised at
    both ends), over the profiled loop and over the same loop run again
    unprofiled."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    plain_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        return {"idle_share": None, "window_ms": wall_us / 1e3,
                "note": "not measured: the profiler saw no device activity"}
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in device):
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    # the profiler's own host work stretches the window; the same loop
    # unprofiled gives the share without it
    return {"idle_share": 1 - busy / wall_us, "window_ms": wall_us / 1e3,
            "busy_ms": busy / 1e3, "steps": steps,
            "ms_per_step": wall_us / 1e3 / steps,
            "unprofiled_ms_per_step": plain_us / 1e3 / steps,
            "idle_share_unprofiled": 1 - busy / plain_us,
            "device_events": len(device),
            "top_device_ms": {name[:60]: us / 1e3 for name, us in top}}


def dist_idle_share(dheat, config, dist, torch, devices, n, steps=100):
    """``idle_share`` of the step loop of the 2-D sync ``pallas``
    distributed solve at n², order 8 (``steps`` steps)."""
    p = config.SimParams(nx=n, ny=n, order=8, iters=steps,
                         grid_method=config.GridMethod.BLOCKS_2D)
    mesh = dist.mesh_for_method(p.grid_method, devices=devices)
    y_size, x_size, ny_loc, nx_loc = dheat._mesh_layout(p, mesh)
    u0 = torch.full((y_size * ny_loc, x_size * nx_loc), p.ic)
    blocks = dheat._scatter(u0, dheat._shard_devices(mesh, y_size, x_size),
                            ny_loc, nx_loc)
    return idle_share(torch, lambda: dheat._run(blocks, p, steps, False, 1,
                                                "pallas"), steps)


def old_new_turns(parent, torch, np, config, core, grid, ops, dist, dheat,
                  sp, spl, segp, pwtk):
    """Phase 15: parent, this tree, this tree, parent, each metric in turns
    in this process (ms per step)."""
    import importlib.util

    pkg = os.path.join(parent, "cme213_tpu_torch")
    if not os.path.isfile(os.path.join(pkg, "__init__.py")):
        fail(f"--parent {parent}: no cme213_tpu_torch package there")
    spec = importlib.util.spec_from_file_location(
        "parent_cme213_tpu_torch", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    old = importlib.util.module_from_spec(spec)
    sys.modules["parent_cme213_tpu_torch"] = old
    spec.loader.exec_module(old)
    odist = importlib.import_module("parent_cme213_tpu_torch.dist")
    oops = importlib.import_module("parent_cme213_tpu_torch.ops")
    osp = importlib.import_module("parent_cme213_tpu_torch.ops."
                                  "stencil_pipeline")
    okern = importlib.import_module("parent_cme213_tpu_torch.ops._kernels")
    okern.build()
    # heat_stencil.cu now includes the shared tile body: its instances'
    # registers, shared memory and spills as ptxas reports them, against
    # the parent's build
    from cme213_tpu_torch.ops import _kernels

    def ptxas(kern):
        log = kern.library_path("heat_stencil").with_suffix(".log")
        return [line.split("ptxas info    :")[-1].strip()
                for line in log.read_text().splitlines() if "Used" in line]

    same = ptxas(okern) == ptxas(_kernels)
    print(f"  heat_stencil.cu ptxas report (registers, spills) equal to the "
          f"parent's: {same}")

    full = config.SimParams(nx=FULL_N, ny=FULL_N, order=FULL_ORDER)
    u = grid.make_initial_grid(full, device="cuda")
    n = 200
    args = (n, full.order, full.xcfl, full.ycfl, full.bc)

    def ms_of(fn, reps):
        return core.time_fn(lambda _: fn(), u, warmup=1, iters=2) / reps

    def host_ms_of(fn, reps):
        """Best of 2 host-clocked runs after a warm-up, synchronised at
        both ends (as the sweeps time a cell)."""
        fn()
        best = float("inf")
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) * 1e3)
        return best / reps

    def turn(label, old_fn, new_fn, reps, timer=ms_of):
        a, b, c, d = (timer(fn, reps)
                      for fn in (old_fn, new_fn, new_fn, old_fn))
        print(f"  turns {label}: parent {a:.6f}, new {b:.6f}, new {c:.6f}, "
              f"parent {d:.6f} ms/step")
        return {"parent": [a, d], "new": [b, c]}

    out = {}
    for k in (1, 2, 4, 8):
        if not torch.equal(oops.run_heat_pipeline(u, 8, *args[1:], k=k),
                           ops.run_heat_pipeline(u, 8, *args[1:], k=k)):
            fail(f"turns: parent and new B1 differ at k={k}")
        out[f"B1 k={k}"] = turn(
            f"B1 {FULL_N}x{FULL_N} k={k}",
            lambda k=k: oops.run_heat_pipeline(u, *args, k=k),
            lambda k=k: ops.run_heat_pipeline(u, *args, k=k), n)
    out["B2 k=1"] = turn(
        f"B2 {FULL_N}x{FULL_N} k=1",
        lambda: oops.run_heat_pipeline2d(u, *args, k=1),
        lambda: ops.run_heat_pipeline2d(u, *args, k=1), n)
    # B4 and B5, the band kernel: 4000² at tile_y 200, and B4 at 2000² at
    # each pallas_tile tile, by CUDA events and by the host clock
    ospl = importlib.import_module("parent_cme213_tpu_torch.ops."
                                   "stencil_pallas")
    for k in (1, 2, 4, 8):
        if k == 1:
            def band(m, mod, v=u):
                return mod.run_heat_pallas(v, m, *args[1:4],
                                           tile_y=BAND_TILE)
        else:
            def band(m, mod, k=k, v=u):
                return mod.run_heat_multistep(v, m, *args[1:], k=k,
                                              tile_y=BAND_TILE)
        if not torch.equal(band(8, ospl), band(8, spl)):
            fail(f"turns: parent and new band kernels differ at k={k}")
        out[f"{'B4' if k == 1 else 'B5'} k={k}"] = turn(
            f"{'B4' if k == 1 else 'B5'} {FULL_N}x{FULL_N} tile_y "
            f"{BAND_TILE} k={k}", lambda band=band: band(n, ospl),
            lambda band=band: band(n, spl), n)
    tp = config.SimParams(nx=DIST_N, ny=DIST_N, order=8)
    tu = grid.make_initial_grid(tp, device="cuda")
    for tile in (40, 80, 200, 400):
        def b4(mod, tile=tile):
            return mod.run_heat_pallas(tu, 100, 8, tp.xcfl, tp.ycfl,
                                       tile_y=tile)
        if not torch.equal(b4(ospl), b4(spl)):
            fail(f"turns: parent and new B4 differ at tile_y {tile}")
        for clock, timer in (("events", ms_of), ("host", host_ms_of)):
            out[f"B4 {DIST_N} tile_y {tile} {clock}"] = turn(
                f"B4 {DIST_N}x{DIST_N} tile_y {tile} ({clock} clock)",
                lambda b4=b4: b4(ospl), lambda b4=b4: b4(spl), 100, timer)
    vdev = core.virtual_devices(DIST_SHARDS)
    dp = config.SimParams(nx=DIST_N, ny=DIST_N, order=8)
    mesh = dist.make_mesh_2d(2, 2, devices=vdev)
    y_size, x_size, ny_loc, nx_loc = dheat._mesh_layout(dp, mesh)
    u0 = torch.from_numpy(dheat._pad_interior_for_mesh(
        dp.ic + np.random.default_rng(0).uniform(0, 1, (dp.ny, dp.nx)), dp,
        y_size, x_size)).float()
    blocks = dheat._scatter(u0, dheat._shard_devices(mesh, y_size, x_size),
                            ny_loc, nx_loc)
    b = dp.border_size
    for k in (1, 2, 4):
        K = k * b
        padded = dheat._assemble_padded(blocks, dp, border=K)
        pads = [q for row in padded for q in row]
        offs = [(yi * ny_loc + b - K, xi * nx_loc + b - K)
                for yi in range(y_size) for xi in range(x_size)]
        a = (dp.ny, dp.nx, dp.order, dp.xcfl, dp.ycfl, dp.bc)

        def old_loop(k=k, pads=pads, offs=offs):
            for _ in range(n):
                for q, (gy0, gx0) in zip(pads, offs):
                    osp.stencil_local_multistep(q, gy0, gx0, *a, k=k)

        def new_batched(k=k, pads=pads, offs=offs):
            for _ in range(n):
                sp.stencil_local_multistep_shards(pads, offs, *a, k=k)

        out[f"B3 k={k}"] = turn(
            f"B3 alone, 2x2 blocks of {DIST_N}x{DIST_N} k={k} (parent: "
            f"four launches, new: one)", old_loop, new_batched, n * k)
    pd = config.SimParams(nx=DIST_N, ny=DIST_N, order=8, iters=400,
                          grid_method=config.GridMethod.BLOCKS_2D)
    it_new, _, _ = dist.prepare_distributed_heat(pd, mesh,
                                                 local_kernel="pallas")
    it_old, _, _ = odist.prepare_distributed_heat(
        pd, odist.make_mesh_2d(2, 2, devices=old.core.virtual_devices(4)),
        local_kernel="pallas")
    if not torch.equal(it_new()[1].cpu(), it_old()[1].cpu()):
        fail("turns: parent and new 2-D pallas solves differ")
    rows = [fn()[0] * 1e3 / pd.iters
            for fn in (it_old, it_new, it_new, it_old)]
    print(f"  turns run_distributed {DIST_N}x{DIST_N} 2d sync pallas: parent "
          f"{rows[0]:.6f}, new {rows[1]:.6f}, new {rows[2]:.6f}, parent "
          f"{rows[3]:.6f} ms/step")
    out["run_distributed 2d sync pallas"] = {"parent": [rows[0], rows[3]],
                                             "new": [rows[1], rows[2]]}
    # B7 and B6 at pwtk: parent and new differ in bits by design, so each
    # is held to its own plain version and to the f64 reference
    oseg = importlib.import_module("parent_cme213_tpu_torch.ops."
                                   "segmented_pallas")
    a, xx, flags, n_it, ref64, errors = pwtk
    w = a * xx
    bits = lambda t: t.view(torch.int32)  # noqa: E731 (+0 and -0 differ)
    for who, mod in (("parent", oseg), ("new", segp)):
        got7 = mod.spmv_scan_pallas(a, xx, flags, n_it)
        got6 = mod.segmented_scan_pallas(w, flags)
        if not (torch.equal(bits(got7), bits(mod.spmv_scan_pallas_plain(
                a, xx, flags, n_it))) and torch.equal(bits(got6), bits(
                    mod.segmented_scan_pallas_plain(w, flags)))):
            fail(f"turns: the {who} B6/B7 differ from their plain versions")
        rel_l2, rel_linf = errors(ref64, got7.cpu().numpy())
        tol_l2, tol_linf = PWTK_TOL["pallas-fused"]
        print(f"  turns: {who} B7 {SUITE} vs f64: rel L2 {rel_l2:.3e}, rel "
              f"Linf {rel_linf:.3e}")
        if not (rel_l2 <= tol_l2 and rel_linf <= tol_linf):
            fail(f"turns: {who} B7 at {SUITE}: rel L2 {rel_l2:.3e} / rel "
                 f"Linf {rel_linf:.3e} (limits {tol_l2} / {tol_linf})")
    out[f"B7 {SUITE}"] = turn(
        f"B7 {SUITE} (ms an iteration)",
        lambda: oseg.spmv_scan_pallas(a, xx, flags, n_it),
        lambda: segp.spmv_scan_pallas(a, xx, flags, n_it), n_it)
    out[f"B6 {SUITE}"] = turn(
        f"B6 {SUITE} (ms a scan)",
        lambda: [oseg.segmented_scan_pallas(w, flags) for _ in range(n_it)],
        lambda: [segp.segmented_scan_pallas(w, flags) for _ in range(n_it)],
        n_it)
    # one head over pwtk's values: one segment across all tiles, the new
    # kernel's longest look-backs (the parent's three passes do the same
    # work whatever the heads).  Held to the plain versions at 2
    # iterations; the timed N iterations run past the f32 range.
    one = torch.zeros_like(flags)
    one[0] = 1
    for who, mod in (("parent", oseg), ("new", segp)):
        if not (torch.equal(bits(mod.spmv_scan_pallas(a, xx, one, 2)), bits(
                mod.spmv_scan_pallas_plain(a, xx, one, 2))) and torch.equal(
                    bits(mod.segmented_scan_pallas(w, one)),
                    bits(mod.segmented_scan_pallas_plain(w, one)))):
            fail(f"turns: the {who} B6/B7 differ from their plain versions "
                 f"with one head")
    out[f"B7 {SUITE} one head"] = turn(
        f"B7 {SUITE} one head (ms an iteration)",
        lambda: oseg.spmv_scan_pallas(a, xx, one, n_it),
        lambda: segp.spmv_scan_pallas(a, xx, one, n_it), n_it)
    out[f"B6 {SUITE} one head"] = turn(
        f"B6 {SUITE} one head (ms a scan)",
        lambda: [oseg.segmented_scan_pallas(w, one) for _ in range(n_it)],
        lambda: [segp.segmented_scan_pallas(w, one) for _ in range(n_it)],
        n_it)
    return out


#: phase 23: the checkpointed solve at the headline grid, its chunk
RUNNER_EVERY = 250
#: phase 25: the batched heat cases, (label, params.in or None, B)
HEAT_BATCH = 8
#: phase 26: the load generator's SpMV classes (serve/loadgen.py), B = 8
SPMV_BATCH_N, SPMV_BATCH, PWTK_BATCH = (512, 1024), 8, 4


def _events_since(core, mark, event=None, op=None):
    return [e for e in core.trace.events()[mark:]
            if (event is None or e["event"] == event)
            and (op is None or e.get("op") == op)]


def _span_ms(core, mark, name):
    return [e["ms"] for e in _events_since(core, mark, "span-end")
            if e["span"] == name]


def runner_phases(counted, only, pwtk, pwtk_ref64, keep):
    """Phases 23-27: the checkpointed and batched runners and the flight
    recorder on the card (see the module's docstring).  ``counted`` and
    ``only`` are ``main``'s launch-count helpers; ``pwtk`` is phase 8's
    problem and ``pwtk_ref64`` its f64 plain solve; the abort's flight dump
    is copied into ``keep``.  Returns the numbers for the ``runners``
    line."""
    import dataclasses

    import numpy as np
    import torch

    from cme213_tpu_torch import config, core, grid, ops
    from cme213_tpu_torch.apps import heat2d
    from cme213_tpu_torch.apps import spmv_scan as spmv
    from cme213_tpu_torch.verify.checkers import (relative_l2_error,
                                                  relative_linf_error)

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    none = only(None, 0)  # the runners launch no hand-written kernel
    t_phases = time.perf_counter()
    rows = {}

    def bitwise(label, out, ref):
        out, ref = np.asarray(out), np.asarray(ref)
        if not (np.isfinite(out).all() and out.shape == ref.shape
                and np.array_equal(out.view(np.uint32),
                                   ref.view(np.uint32))):
            fail(f"{label}: not bit for bit the uninterrupted solve")

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def device_ms(fn, anchor):
        """CUDA events around ``fn()`` (best of 2 after a warm-up); the
        inputs are already on the card and the outputs stay there."""
        return core.time_fn(lambda _: fn(), anchor, warmup=1, iters=2)

    # ------------------------------------------- 23. checkpointed heat
    phase(23)
    full = config.SimParams(nx=FULL_N, ny=FULL_N, order=FULL_ORDER,
                            iters=FULL_ITERS)
    fargs = (full.order, full.xcfl, full.ycfl)
    u0 = grid.make_initial_grid(full, device=dev)
    ops.run_heat(u0, 1, *fargs)  # the device's lazy set-up
    ref_t, plain_ms = host_ms(lambda: ops.run_heat(u0, full.iters, *fargs))
    ref = ref_t.cpu().numpy()
    del ref_t
    n_chunks = full.iters // RUNNER_EVERY
    with tempfile.TemporaryDirectory() as ck_dir:
        ck = os.path.join(ck_dir, "heat.npz")
        mark = len(core.trace.events())
        t0 = time.perf_counter()
        out = counted(f"run_heat_checkpointed {FULL_N}x{FULL_N}", none,
                      lambda: heat2d.run_heat_checkpointed(
                          full, ck, every=RUNNER_EVERY, device="cuda"))
        wall_ms = (time.perf_counter() - t0) * 1e3
        bitwise("checkpointed heat", out, ref)
        progress = _events_since(core, mark, "solver-progress", "heat2d")
        if [e["step"] for e in progress] != [
                RUNNER_EVERY * (i + 1) for i in range(n_chunks)]:
            fail(f"checkpointed heat: solver-progress {progress}")
        chunk_ms = _span_ms(core, mark, "checkpoint.chunk")
        save_ms = _span_ms(core, mark, "checkpoint.save")
        if len(chunk_ms) != n_chunks or len(save_ms) != n_chunks:
            fail(f"checkpointed heat: chunk spans {chunk_ms}, saves "
                 f"{save_ms}")
        heat_row = {
            "wall_ms": wall_ms, "run_heat_ms": plain_ms,
            "chunk_ms": chunk_ms, "save_ms": save_ms,
            "save_share": sum(save_ms) / wall_ms,
            "overhead_share": 1 - plain_ms / wall_ms,
            "solver_progress": len(progress)}
        print(f"checkpointed heat {FULL_N}x{FULL_N} order {FULL_ORDER} "
              f"{full.iters} iters every {RUNNER_EVERY}: {wall_ms:.1f} ms "
              f"(uninterrupted run_heat {plain_ms:.1f} ms), bit for bit; "
              f"{len(progress)} solver-progress events; ms a chunk "
              f"{[round(m, 3) for m in chunk_ms]}, ms a save (host copy, "
              f"CRC, np.savez, rename) {[round(m, 3) for m in save_ms]}; "
              f"saves {heat_row['save_share']:.2%} of the solve, "
              f"checkpointing {heat_row['overhead_share']:.2%}")

        # resume: to half the iterations, then to all from the same path
        ck2 = os.path.join(ck_dir, "resume.npz")
        half = dataclasses.replace(full, iters=full.iters // 2)
        heat2d.run_heat_checkpointed(half, ck2, every=RUNNER_EVERY,
                                     device="cuda")
        mark = len(core.trace.events())
        out = heat2d.run_heat_checkpointed(full, ck2, every=RUNNER_EVERY,
                                           device="cuda")
        bitwise("checkpointed heat resumed", out, ref)
        steps = [e["step"] for e in _events_since(core, mark,
                                                  "solver-progress")]
        print(f"  resumed at {half.iters}: bit for bit, progress at "
              f"{steps}")
        if steps != list(range(half.iters + RUNNER_EVERY, full.iters + 1,
                               RUNNER_EVERY)):
            fail(f"checkpointed heat resume: progress at {steps}")

        # injected faults: a rollback and a halving, both bit for bit
        for spec, event, want in (
                ("nan:heat2d:2", "checkpoint-rollback",
                 [{"resumed_step": RUNNER_EVERY}]),
                ("oom:heat_chunk:1", "chunk-shrunk",
                 [{"from_size": RUNNER_EVERY,
                   "to_size": RUNNER_EVERY // 2}])):
            mark = len(core.trace.events())
            with core.faults.injected(spec):
                out = heat2d.run_heat_checkpointed(
                    full, os.path.join(ck_dir, f"{spec[:3]}.npz"),
                    every=RUNNER_EVERY, device="cuda")
            bitwise(f"checkpointed heat under {spec}", out, ref)
            seen = [{k: e[k] for k in want[0]}
                    for e in _events_since(core, mark, event)]
            print(f"  CME213_FAULTS={spec}: {event} {seen}, bit for bit")
            if seen != want:
                fail(f"checkpointed heat under {spec}: {event} {seen}")

        # memory: the preflight's count beside one chunk's measured peak
        count = ops.stencil.run_heat_bytes(full.gy, full.gx, full.order,
                                           u0.element_size())
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        chunk = ops.run_heat(u0, RUNNER_EVERY, *fargs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        del chunk
        heat_row.update(preflight_bytes=count, chunk_peak_bytes=peak)
        print(f"  preflight count {count} bytes, one chunk's measured peak "
              f"{peak} bytes (count/peak {count / peak:.4f})")
        if not peak <= count <= 2 * peak:
            fail(f"preflight count {count} outside [1, 2] x the measured "
                 f"peak {peak}")

        # a budget below the count refuses before any chunk runs
        ck3 = os.path.join(ck_dir, "refused.npz")
        os.environ[core.admission.BUDGET_ENV] = str(count - 1)
        mark = len(core.trace.events())
        try:
            heat2d.run_heat_checkpointed(full, ck3, every=RUNNER_EVERY,
                                         device="cuda")
            fail("a budget below the count did not refuse the solve")
        except core.admission.AdmissionError as e:
            print(f"  {core.admission.BUDGET_ENV}={count - 1}: refused "
                  f"({e})")
        finally:
            del os.environ[core.admission.BUDGET_ENV]
        if os.path.exists(ck3) or _span_ms(core, mark, "checkpoint.chunk"):
            fail("the refused solve ran a chunk")
    del u0
    rows["heat_checkpointed"] = heat_row

    # ------------------------------------------- 24. checkpointed pwtk
    phase(24)
    a, xx, flags, _ = spmv.problem_tensors(pwtk, device=dev)
    every, n_it = 5, pwtk.iters
    spmv_rows = {}
    with tempfile.TemporaryDirectory() as ck_dir:
        for kernel in ("auto", "flat", "blocked"):
            ref_k, plain_ms = host_ms(
                lambda k=kernel: spmv._iterate(a, xx, flags, n_it, scan=k))
            ref_k = ref_k.cpu().numpy()
            mark = len(core.trace.events())
            t0 = time.perf_counter()
            out = counted(
                f"run_spmv_scan_checkpointed {SUITE} {kernel}", none,
                lambda k=kernel: spmv.run_spmv_scan_checkpointed(
                    pwtk, os.path.join(ck_dir, f"{k}.npz"), every=every,
                    kernel=k, device="cuda"))
            wall_ms = (time.perf_counter() - t0) * 1e3
            bitwise(f"checkpointed {SUITE} {kernel}", out, ref_k)
            rel_l2 = relative_l2_error(pwtk_ref64, out)
            rel_linf = relative_linf_error(pwtk_ref64, out)
            tol_l2, tol_linf = PWTK_TOL[kernel]
            if not (rel_l2 <= tol_l2 and rel_linf <= tol_linf):
                fail(f"checkpointed {SUITE} {kernel}: rel L2 {rel_l2:.3e}, "
                     f"rel Linf {rel_linf:.3e} (limits {tol_l2}, "
                     f"{tol_linf})")
            progress = _events_since(core, mark, "solver-progress",
                                     "spmv_scan")
            if len(progress) != n_it // every:
                fail(f"checkpointed {SUITE} {kernel}: {len(progress)} "
                     f"solver-progress events")
            row = {"wall_ms": wall_ms, "iterate_ms": plain_ms,
                   "chunk_ms": _span_ms(core, mark, "checkpoint.chunk"),
                   "save_ms": _span_ms(core, mark, "checkpoint.save"),
                   "rel_l2_vs_f64": rel_l2, "rel_linf_vs_f64": rel_linf,
                   "solver_progress": len(progress)}
            row["save_share"] = sum(row["save_ms"]) / wall_ms
            # memory: the preflight's count beside one chunk's measured
            # peak, as for heat
            count = spmv.spmv_chunk_bytes(pwtk.n, pwtk.p, a.element_size(),
                                          kernel)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            chunk = spmv._iterate(a, xx, flags, every, scan=kernel)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            del chunk
            row.update(preflight_bytes=count, chunk_peak_bytes=peak)
            print(f"  {kernel}: preflight count {count} bytes, one chunk's "
                  f"measured peak {peak} bytes (count/peak "
                  f"{count / peak:.4f})")
            if not peak <= count <= 2 * peak:
                fail(f"checkpointed {SUITE} {kernel}: preflight count "
                     f"{count} outside [1, 2] x the measured peak {peak}")
            # resume from the middle, then a rollback and a halving
            ck = os.path.join(ck_dir, f"{kernel}-resume.npz")
            spmv.run_spmv_scan_checkpointed(
                spmv.Problem(pwtk.a, pwtk.s, pwtk.k, pwtk.x, 2 * every), ck,
                every=every, kernel=kernel, device="cuda")
            bitwise(f"checkpointed {SUITE} {kernel} resumed",
                    spmv.run_spmv_scan_checkpointed(
                        pwtk, ck, every=every, kernel=kernel, device="cuda"),
                    ref_k)
            for spec, event, want in (
                    ("nan:spmv_scan:2", "checkpoint-rollback",
                     [{"resumed_step": every}]),
                    ("oom:spmv_scan_chunk:1", "chunk-shrunk",
                     [{"from_size": every, "to_size": every // 2}])):
                mark = len(core.trace.events())
                with core.faults.injected(spec):
                    out = spmv.run_spmv_scan_checkpointed(
                        pwtk, os.path.join(ck_dir, f"{kernel}-{spec[:3]}"
                                                   ".npz"),
                        every=every, kernel=kernel, device="cuda")
                bitwise(f"checkpointed {SUITE} {kernel} under {spec}", out,
                        ref_k)
                seen = [{k: e[k] for k in want[0]}
                        for e in _events_since(core, mark, event)]
                if seen != want:
                    fail(f"checkpointed {SUITE} {kernel} under {spec}: "
                         f"{event} {seen}")
            spmv_rows[kernel] = row
            print(f"checkpointed {SUITE} {kernel} {n_it} iters every "
                  f"{every}: {wall_ms:.1f} ms (_iterate {plain_ms:.1f} ms), "
                  f"bit for bit, rel L2 {rel_l2:.3e} from f64; ms a chunk "
                  f"{[round(m, 3) for m in row['chunk_ms']]}, ms a save "
                  f"{[round(m, 3) for m in row['save_ms']]} (saves "
                  f"{row['save_share']:.2%}); resume, nan:spmv_scan:2 "
                  f"(rollback) and oom:spmv_scan_chunk:1 ({every} -> "
                  f"{every // 2}) bit for bit")
    del a, xx, flags
    rows["spmv_checkpointed"] = spmv_rows

    # ------------------------------------------- 25. batched heat
    phase(25)
    rng = np.random.default_rng(25)
    example = config.SimParams.from_file(
        os.path.join(HERE, "examples", "params.in"))
    heat_batches = {}
    for label, base in (("serving 24x24 order 2", config.SimParams(
            nx=24, ny=24, order=2, iters=4)), ("params.in", example)):
        lanes = [dataclasses.replace(base, alpha=float(a))
                 for a in rng.uniform(0.5, 2.0, HEAT_BATCH) * base.alpha]
        grids = []
        for lane in lanes:
            g = grid.make_initial_grid(lane, device=dev)
            b = lane.border_size
            g[b:-b, b:-b] += torch.from_numpy(rng.uniform(
                0, 1, (lane.ny, lane.nx)).astype(np.float32)).to(dev)
            grids.append(g)
        xs, ys = [p.xcfl for p in lanes], [p.ycfl for p in lanes]
        run = lambda: heat2d.run_heat_batched(  # noqa: E731
            grids, base.iters, base.order, xs, ys, device="cuda")
        outs = counted(f"run_heat_batched {label} b{HEAT_BATCH}", none, run)
        _, batch_ms = host_ms(run)  # warm: a program-cache hit
        # like for like: each serial solve also ends on the host
        serial, serial_ms = host_ms(lambda: [ops.run_heat(
            g, base.iters, base.order, p_.xcfl, p_.ycfl).cpu().numpy()
            for g, p_ in zip(grids, lanes)])
        for i, (out, ser) in enumerate(zip(outs, serial)):
            bitwise(f"batched heat {label} lane {i}", out, ser)
        # the solves alone, inputs and outputs on the card
        u = torch.stack(grids)
        xc = torch.tensor(xs, dtype=torch.float32, device=dev).view(-1, 1, 1)
        yc = torch.tensor(ys, dtype=torch.float32, device=dev).view(-1, 1, 1)
        batch_dev = device_ms(lambda: ops.run_heat(
            u, base.iters, base.order, xc, yc), u)
        serial_dev = device_ms(lambda: [ops.run_heat(
            g, base.iters, base.order, p_.xcfl, p_.ycfl)
            for g, p_ in zip(grids, lanes)], u)
        heat_batches[label] = {"batch_ms": batch_ms,
                               "serial_ms": serial_ms,
                               "batch_device_ms": batch_dev,
                               "serial_device_ms": serial_dev,
                               "b": HEAT_BATCH, "shape": [base.gy, base.gx],
                               "order": base.order, "iters": base.iters}
        print(f"batched heat {label} ({base.gy}x{base.gx} order "
              f"{base.order}, {base.iters} iters) b={HEAT_BATCH}: every "
              f"lane bit for bit its serial run_heat; {batch_ms:.3f} ms a "
              f"batch, {serial_ms:.3f} ms for {HEAT_BATCH} serial solves; "
              f"the solves alone (CUDA events) {batch_dev:.3f} and "
              f"{serial_dev:.3f} ms")
        del u
    rows["heat_batched"] = heat_batches

    # ------------------------------------------- 26. batched SpMV-scan
    phase(26)
    spmv_batches = {}
    cases = [(f"n={n} {k}", k, [spmv.generate_problem(
        n, p=max(2, n // 64), q=n // 2, iters=6, seed=26 + i)
        for i in range(SPMV_BATCH)])
        for n in SPMV_BATCH_N for k in ("flat", "blocked")]
    cases.append((f"{SUITE} blocked", "blocked", [pwtk] + [
        spmv.suite_problem(SUITE, seed=s) for s in range(1, PWTK_BATCH)]))
    for label, kernel, probs in cases:
        run = lambda k=kernel, pr=probs: spmv.run_spmv_scan_batched(  # noqa
            pr, kernel=k, device="cuda")
        outs = counted(f"run_spmv_scan_batched {label} b{len(probs)}",
                       none, run)
        _, batch_ms = host_ms(run)
        # like for like: each serial solve also uploads its problem and
        # ends on the host, as the batch does
        serial, serial_ms = host_ms(lambda: [spmv._iterate(
            *spmv.problem_tensors(pr, device=dev)[:3], pr.iters,
            scan=kernel).cpu().numpy() for pr in probs])
        for i, (out, ser) in enumerate(zip(outs, serial)):
            bitwise(f"batched SpMV-scan {label} lane {i}", out, ser)
        # the solves alone, inputs and outputs on the card
        lanes = [spmv.problem_tensors(pr, device=dev)[:3] for pr in probs]
        stack = [torch.stack(t) for t in zip(*lanes)]
        n_it = probs[0].iters
        batch_dev = device_ms(lambda: spmv._iterate(
            *stack, n_it, scan=kernel), stack[0])
        serial_dev = device_ms(lambda: [spmv._iterate(
            *t, n_it, scan=kernel) for t in lanes], stack[0])
        spmv_batches[label] = {"batch_ms": batch_ms, "serial_ms": serial_ms,
                               "batch_device_ms": batch_dev,
                               "serial_device_ms": serial_dev,
                               "b": len(probs), "n": probs[0].n,
                               "iters": n_it}
        print(f"batched SpMV-scan {label} b={len(probs)} ({n_it} iters): "
              f"every lane bit for bit its serial _iterate; {batch_ms:.3f} "
              f"ms a batch, {serial_ms:.3f} ms for the serial solves; the "
              f"solves alone (CUDA events) {batch_dev:.3f} and "
              f"{serial_dev:.3f} ms")
        del serial, outs, lanes, stack
    rows["spmv_batched"] = spmv_batches

    # ------------------------------------------- 27. flight recorder
    phase(27)
    rows.update(flight_child(kind, keep))
    rows["seconds"] = time.perf_counter() - t_phases
    print(f"phases 23-27: {rows['seconds']:.1f} s")
    return rows


#: phase 28: the sweeps profiled under CME213_PROFILE_DIR (at --quick) and
#: the kernels their profiler trace must show
PROFILED = ("heat_kernels", "scan_bandwidth")
PROFILED_KERNELS = ("heat_ksteps", "heat_band", "transpose_kernel")


def telemetry_phase(counted, only, paths, work, ident, pwtk, headline,
                    flight_dump, sweep_dir):
    """Phase 28: the telemetry tooling on the card (see the module's
    docstring).  ``counted``, ``only`` and ``paths`` are ``main``'s
    launch-count helpers and table (the child processes' launches come
    from their sinks' final metrics snapshot); ``work`` holds the files;
    ``pwtk`` is phase 8's problem, ``headline`` phase 16's lines,
    ``flight_dump`` phase 27's abort dump and ``sweep_dir`` phase 14's
    CSVs.  Returns the numbers for the ``telemetry`` line."""
    import glob

    import torch

    from cme213_tpu_torch import config, core, grid, models, ops, trace_cli
    from cme213_tpu_torch.apps import heat2d
    from cme213_tpu_torch.apps import spmv_scan as spmv
    from cme213_tpu_torch.bench import regress, report, run_all, sweeps
    from cme213_tpu_torch.core import flight, roofline

    kind = torch.cuda.get_device_name(0)
    peak = roofline.peak_for(kind)
    half = f"{peak.name}:{peak.gbs / 2}:{peak.gfs_f32 / 2}"
    trace_env = core.trace.TRACE_FILE_ENV
    t_phase = time.perf_counter()
    rows = {"card": ident}
    env = {k: v for k, v in os.environ.items()
           if k not in ("CME213_FAULTS", trace_env,
                        roofline.DEVICE_PEAKS_ENV, run_all.PROFILE_DIR_ENV)}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p)

    def call(label, fn, argv, want=0):
        """``fn(argv)`` (a CLI's ``main``, or the workload table's
        ``dispatch``, which ``python -m cme213_tpu_torch`` runs) in this
        process: (stdout, seconds); fails unless it exits ``want``."""
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = fn(list(argv))
        secs = time.perf_counter() - t0
        if rc != want:
            fail(f"{label}: exit {rc}, expected {want}\n"
                 f"{buf.getvalue()[-2000:]}")
        return buf.getvalue(), secs

    def child(label, args, cwd, sink=None, timeout=600):
        """``python -m args`` from the checkout in a session of its own,
        with its trace sink at ``sink``: (stdout, seconds)."""
        os.makedirs(cwd, exist_ok=True)
        e = dict(env, **({trace_env: sink} if sink else {}))
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", *args], cwd=cwd,
                                env=e, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                start_new_session=True)
        try:
            stdout, stderr = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            fail(f"{label}: no result in {timeout} s")
        if proc.returncode != 0:
            fail(f"{label}: rc {proc.returncode}\n{stderr[-3000:]}")
        return stdout, time.perf_counter() - t0

    def sink_launches(label, path, expect):
        """A child's kernel launches, from the ``kernel.launches.*``
        counters of its sink's final metrics snapshot."""
        snap = trace_cli.load_metrics_snapshot(path)
        got = only(None, 0)
        for name, n in snap.get("counters", {}).items():
            if name.startswith("kernel.launches."):
                got[name[len("kernel.launches."):]] = n
        paths[label] = got
        print(f"launches of {label}: {got}")
        if got != expect:
            fail(f"{label}: launches {got}, expected {expect}")

    def traced(sink, run, **extra):
        """``run()`` with this process's sink at ``sink`` (and ``extra``
        variables set), closed after."""
        os.environ.update({trace_env: sink, **extra})
        try:
            return run()
        finally:
            core.trace.flush_sink()
            for var in (trace_env, *extra):
                os.environ.pop(var, None)

    def sink_path(name):
        return os.path.join(work, f"{name}-main.jsonl")

    # the headline workload as a user runs it: 4000² order 8 through the
    # ladder onto B1, cold (probe, warm-up, solve), traced by its sink
    full = config.SimParams(nx=FULL_N, ny=FULL_N, order=FULL_ORDER,
                            iters=FULL_ITERS)
    params_in = os.path.join(work, "full.in")
    with open(params_in, "w") as f:
        f.write(f"{full.nx} {full.ny}\n{full.lx} {full.ly}\n{full.alpha}\n"
                f"{full.iters}\n{full.order}\n{full.ic}\n{full.bc_top} "
                f"{full.bc_left} {full.bc_bottom} {full.bc_right}\n")
    label = f"heat2d CLI {FULL_N}x{FULL_N} traced"
    out, rows["heat_child_s"] = child(
        label, ["cme213_tpu_torch", "heat2d", params_in],
        os.path.join(work, "heat"), os.path.join(work, "heat-{rank}.jsonl"))
    print(f"{label} ({rows['heat_child_s']:.1f} s): "
          f"{out.strip().splitlines()[-1]}")
    if "\npipeline: " not in "\n" + out:
        fail(f"{label}: not served by the kernel rung undemoted:\n{out}")
    sink_launches(label, sink_path("heat"),
                  only("pipeline", FULL_ITERS + 1 + HEAT_PROBE_LAUNCHES))

    # pwtk through the SpMV-scan CLI with the fused kernel (B7), cold
    spmv_dir = os.path.join(work, "spmv")
    os.makedirs(spmv_dir)
    t0 = time.perf_counter()
    spmv.save_problem(pwtk, os.path.join(spmv_dir, "a.txt"),
                      os.path.join(spmv_dir, "x.txt"))
    rows["pwtk_files_s"] = time.perf_counter() - t0
    label = f"spmv_scan CLI {SUITE} pallas-fused traced"
    out, rows["spmv_child_s"] = child(
        label, ["cme213_tpu_torch", "spmv_scan", "a.txt", "x.txt",
                "cpu_check", "--kernel=pallas-fused"], spmv_dir,
        os.path.join(work, "spmv-{rank}.jsonl"), timeout=900)
    print(f"{label} ({rows['spmv_child_s']:.1f} s, files "
          f"{rows['pwtk_files_s']:.1f} s): {out.strip()}")
    if "Worked!" not in out:
        fail(f"{label}: the f64 check failed:\n{out}")
    sink_launches(label, sink_path("spmv"),
                  only("spmv_fused",
                       pwtk.iters + 1 + 1 + spmv._PROBE_SHAPE["iters"]))

    # the checkpointed 4000² solve, traced (plain torch: no kernel)
    label = f"run_heat_checkpointed {FULL_N}x{FULL_N} traced"
    traced(os.path.join(work, "ck-{rank}.jsonl"), lambda: counted(
        label, only(None, 0), lambda: heat2d.run_heat_checkpointed(
            full, os.path.join(work, "ck.npz"), every=RUNNER_EVERY,
            device="cuda")))

    # the spans' cost: the ladder's 4000² solve untraced and traced, in
    # turns (untraced, traced, traced, untraced), host clock between
    # device synchronisations, after an untimed solve that builds the
    # program
    u0 = grid.make_initial_grid(full, device="cuda")
    fargs = (full.iters, full.order, full.xcfl, full.ycfl, full.bc)

    def solve():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ops.stencil_pipeline.run_heat_resilient(u0, *fargs, k=1)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / full.iters

    solve()
    turns = {"untraced": [], "traced": []}
    for i, on in enumerate((False, True, True, False)):
        label = (f"run_heat_resilient {FULL_N}x{FULL_N} "
                 f"{'traced' if on else 'untraced'}, turn {i + 1}")
        run = (lambda: traced(os.path.join(work, "turns-{rank}.jsonl"),
                              solve)) if on else solve
        turns["traced" if on else "untraced"].append(
            counted(label, only("pipeline", FULL_ITERS), run))
    ratio = sum(turns["traced"]) / sum(turns["untraced"])
    rows.update(ms_per_step=turns, traced_over_untraced=ratio)
    print(f"spans' cost, ms/step at {FULL_N}^2 order {FULL_ORDER} "
          f"({ident}): untraced {turns['untraced']}, traced "
          f"{turns['traced']}, ratio {ratio:.6f}")
    label = f"run_heat_resilient {FULL_N}x{FULL_N} traced, {half}"
    traced(os.path.join(work, "half-{rank}.jsonl"), lambda: counted(
        label, only("pipeline", FULL_ITERS), solve),
        **{roofline.DEVICE_PEAKS_ENV: half})

    # trace summary: the gate, and each roofline row against the table
    out, rows["summary_s"] = call(
        "trace summary", models.dispatch,
        ["trace", "summary", sink_path("heat"), "--json", "--require",
         "heat.run,conformance-probe"])
    row = json.loads(out)["attribution"].get("heat.run [pipeline]")
    if row is None or abs(row["pct_peak"] - 100 * row["best_gbs"]
                          / peak.gbs) > 0.011:
        fail(f"trace summary: heat.run [pipeline] {row} against "
             f"{peak.gbs} GB/s")
    att = roofline.attribute(row["best_gbs"], device=kind)
    if att["device"] != roofline.normalize(kind) or \
            abs(att["pct_peak"] - row["pct_peak"]) > 0.011:
        fail(f"roofline.attribute: {att} against the summary's {row}")
    out, _ = call("trace summary, half peak", models.dispatch,
                  ["trace", "summary", sink_path("half"), "--json",
                   "--require", "heat.run"])
    half_row = json.loads(out)["attribution"]["heat.run [pipeline]"]
    share = (half_row["pct_peak"] / half_row["best_gbs"]) / \
        (row["pct_peak"] / row["best_gbs"])
    if abs(half_row["pct_peak"] - 200 * half_row["best_gbs"]
           / peak.gbs) > 0.011 or abs(share - 2) > 0.01:
        fail(f"{roofline.DEVICE_PEAKS_ENV}={half}: {half_row}, "
             f"share x{share}")
    rows["roofline"] = {"heat.run": row, "half_peak": half_row,
                        "device": att["device"], "share_ratio": share}
    print(f"trace summary ({rows['summary_s']:.3f} s): heat.run "
          f"[pipeline] {row}; under {half}: {half_row} (x{share:.4f}); "
          f"device {att['device']}")

    # timeline, Chrome export, metrics
    out, _ = call("trace timeline", models.dispatch,
                  ["trace", "timeline", sink_path("heat")])
    if "heat.run" not in out:
        fail("trace timeline: no heat.run line")
    chrome = os.path.join(work, "heat.chrome.json")
    call("trace export", models.dispatch,
         ["trace", "export", sink_path("heat"), "--out", chrome])
    with open(chrome) as f:
        evs = json.load(f)["traceEvents"]
    pairs = [sum(1 for e in evs if e.get("name") == "heat.run"
                 and e["ph"] == ph) for ph in "BE"]
    if pairs[0] != pairs[1] or pairs[0] < 1:
        fail(f"trace export: heat.run B/E {pairs}")
    out, _ = call("trace metrics", models.dispatch,
                  ["trace", "metrics", sink_path("heat")])
    if "kernel_launches_pipeline" not in out:
        fail(f"trace metrics: no kernel launches in\n{out[-2000:]}")

    # numerics over the checkpointed trace, flight over phase 27's dump
    out, _ = call("numerics report", models.dispatch,
                  ["numerics", "report", sink_path("ck"), "--forbid-stall",
                   "--json"])
    conv = json.loads(out)["convergence"]["heat2d"]
    if conv["epochs"] != FULL_ITERS // RUNNER_EVERY or conv["stalled"] \
            or conv["last_step"] != FULL_ITERS:
        fail(f"numerics report: {conv}")
    out, _ = call("trace flight", models.dispatch,
                  ["trace", "flight", flight_dump])
    platform = out.splitlines()[1]
    if f"torch {torch.__version__}" not in platform or \
            f"CUDA {torch.version.cuda}" not in platform or \
            kind not in platform:
        fail(f"trace flight: platform line {platform!r}")
    os.environ[flight.FLIGHT_DIR_ENV] = os.path.join(work, "flight")
    try:
        t0 = time.perf_counter()
        dump = flight.dump("telemetry-cost")
        rows["flight_dump_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        os.environ.pop(flight.FLIGHT_DIR_ENV)
    call("trace flight", models.dispatch, ["trace", "flight", dump])
    print(f"numerics report: heat2d {conv}; trace flight: {platform}; "
          f"one flight dump {rows['flight_dump_ms']:.3f} ms")

    # the consoles over every sink, with a supervised rank's heartbeat
    sinks = sorted(glob.glob(os.path.join(work, "*-main.jsonl")))
    rows["sinks"] = {}
    for path in sinks:
        with open(path) as f:
            n = sum(1 for _ in f)
        rows["sinks"][os.path.basename(path)] = {
            "bytes": os.path.getsize(path), "records": n}
    out, rows["collect_s"] = call(
        "collect", models.dispatch,
        ["collect", os.path.join(work, "*-main.jsonl"), "--once", "--json"])
    state = json.loads(out)
    if state["events"] != sum(r["records"] for r in rows["sinks"].values()) \
            or state["malformed"]:
        fail(f"collect: {state['events']} events, {rows['sinks']}")
    hb_dir = os.path.join(work, "hb")
    os.makedirs(hb_dir)
    with open(os.path.join(hb_dir, "rank0.json"), "w") as f:
        json.dump({"rank": 0, "step": FULL_ITERS, "pid": os.getpid(),
                   "incarnation": 0, "t": time.time()}, f)
    out, _ = call("top", models.dispatch,
                  ["top", os.path.join(work, "*-main.jsonl"), "--once",
                   "--json", "--hb-dir", hb_dir])
    if json.loads(out)["heartbeats"]["0"]["step"] != FULL_ITERS:
        fail("top --hb-dir: the heartbeat was not folded")
    print(f"sinks {rows['sinks']}; collect {rows['collect_s']:.3f} s over "
          f"{state['events']} records")

    # the sweeps under the profiler: its trace shows the kernels, and each
    # sweep leaves a memory snapshot
    prof = os.path.join(work, "profile")
    mark = len(core.trace.events())
    os.environ[run_all.PROFILE_DIR_ENV] = prof
    label = f"run_all --only {','.join(PROFILED)} (quick, profiled)"
    try:
        t0 = time.perf_counter()
        rc = counted(label, None, lambda: run_all.main(
            ["--out", os.path.join(work, "profiled"), "--quick", "--only",
             ",".join(PROFILED)]))
        rows["profiled_s"] = time.perf_counter() - t0
    finally:
        os.environ.pop(run_all.PROFILE_DIR_ENV)
    if rc != 0 or any(paths[label][k] <= 0 for k in (
            "pipeline", "pipeline2d", "stencil_full", "multistep",
            "transpose")):
        fail(f"{label}: rc {rc}, launches {paths[label]}")
    traces = glob.glob(os.path.join(prof, "trace-*.json"))
    if len(traces) != 1:
        fail(f"{label}: profiler traces {traces}")
    with open(traces[0]) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"}
    seen = {k: sorted(n for n in names if k in n) for k in PROFILED_KERNELS}
    memory = [e["path"] for e in core.trace.events()[mark:]
              if e["event"] == "device-memory"]
    if not all(seen.values()) or sorted(memory) != [
            os.path.join(prof, f"memory_{s}.json") for s in sorted(PROFILED)]:
        fail(f"{label}: kernels {seen}, memory snapshots {memory}")
    rows["profile"] = {"trace_bytes": os.path.getsize(traces[0]),
                       "kernels": seen, "memory": [
                           os.path.getsize(m) for m in memory]}
    print(f"{label} ({rows['profiled_s']:.1f} s): {rows['profile']}")

    # the regression gate, the batch runner and the report
    results = os.path.join(work, "bench_results_torch")
    os.makedirs(results)
    for dtype_name, line in headline.items():
        with open(os.path.join(results, f"bench_{dtype_name}.json"),
                  "w") as f:
            f.write(json.dumps({k: v for k, v in line.items()
                                if k != "seconds"}) + "\n")
    for name in os.listdir(sweep_dir):
        shutil.copy(os.path.join(sweep_dir, name), results)
    call("regress, self", regress.main,
         ["--fresh", sweep_dir, "--baseline", sweep_dir, "--strict"])
    cut = shutil.copytree(sweep_dir, os.path.join(work, "sweeps_cut"))
    with open(os.path.join(cut, "heat_kernels.csv"), newline="") as f:
        table = list(csv.DictReader(f))
    first = next(r for r in table if float(r["gbs"] or 0) > 0)
    first["gbs"] = round(float(first["gbs"]) * 0.8, 2)
    sweeps.write_csv(table, os.path.join(cut, "heat_kernels.csv"))
    out, _ = call("regress, gbs cut 20%", regress.main,
                  ["--fresh", cut, "--baseline", sweep_dir, "--strict"],
                  want=1)
    if "REGRESSION heat_kernels.csv" not in out:
        fail(f"regress: the cut row was not flagged\n{out}")
    verdict = os.path.join(results, "regress.json")
    call("regress --bench", regress.main,
         ["--fresh", sweep_dir, "--baseline", sweep_dir, "--strict",
          "--bench", os.path.join(results, "bench_f32.json"), "--history",
          HERE, "--json", verdict])
    with open(verdict) as f:
        trajectory = json.load(f)["trajectory"]
    captures = sorted(os.path.basename(p) for p in
                      glob.glob(os.path.join(HERE, "BENCH_r*.json")))
    if [s["capture"] for s in trajectory["skipped"]] != captures or \
            trajectory["history"] or trajectory["device_kind"] != kind:
        fail(f"regress --bench: trajectory {trajectory}")
    # the job file at one sweep point of its three (OMP_NUM_THREADS=1):
    # the batch machinery is the same at every point, and the script's
    # time limit holds every phase
    with open(os.path.join(HERE, "cme213_tpu_torch", "jobs",
                           "spmv_scaling.job")) as f:
        job = f.read()
    sweep = "#CME sweep OMP_NUM_THREADS=1,2,4\n"
    if sweep not in job:
        fail(f"spmv_scaling.job: no {sweep.strip()!r} line")
    jobfile = os.path.join(work, "spmv_scaling.job")
    with open(jobfile, "w") as f:
        f.write(job.replace(sweep, "#CME sweep OMP_NUM_THREADS=1\n"))
    out, rows["batch_s"] = child("bench.batch spmv_scaling.job",
                                 ["cme213_tpu_torch.bench.batch", jobfile],
                                 work, timeout=900)
    print(f"bench.batch ({rows['batch_s']:.1f} s): {out.strip()}")
    data = os.path.join(work, "DATA.md")
    call("bench.report", report.main, ["--dir", results, "--out", data])
    with open(data) as f:
        text = f.read()
    for part in ("## Headline bench (f32)", "### heat_kernels.csv",
                 "### spmv_scaling.jobs.csv", "## Regression gate"):
        if part not in text:
            fail(f"bench.report: no {part!r} in DATA.md")
    rows["seconds"] = time.perf_counter() - t_phase
    print(f"regress: cut row flagged, {len(captures)} TPU captures skipped; "
          f"DATA.md {len(text.splitlines())} lines; phase 28: "
          f"{rows['seconds']:.1f} s")
    return rows


#: phase 29: the suite sweep's scale here (its full-scale table runs in a
#: call of its own: ``bench.run_all --only spmv_suite``)
SUITE_SWEEP_SCALE = 0.1
#: phase 29: the device sorts' size and the Vigenère key's period
SORT_N, VIGENERE_PERIOD = 1 << 20, 7


def workloads_phase(counted, only, paths, work, ident, calibration):
    """Phase 29: the hw1, hw3 and hw4 workloads on the card (see the
    module's docstring).  ``counted``, ``only`` and ``paths`` are
    ``main``'s launch-count helpers and table; ``work`` holds phase 28's
    pwtk files; ``calibration`` is phase 22's ``doctor calibrate`` table.
    Returns the numbers for the ``workloads`` line."""
    import numpy as np
    import torch

    from cme213_tpu_torch import core, native, tune_cli
    from cme213_tpu_torch.apps import cipher, pagerank, sorts
    from cme213_tpu_torch.apps import spmv_scan as spmv
    from cme213_tpu_torch.apps import vigenere as vg
    from cme213_tpu_torch.apps.corpus import corpus_path, load_corpus
    from cme213_tpu_torch.bench import run_all
    from cme213_tpu_torch.core import roofline, tune
    from cme213_tpu_torch.ops import bitonic_sort, radix_sort
    from cme213_tpu_torch.ops import sort as lib_sort  # the function
    from cme213_tpu_torch.ops.sort import sort_auto
    from cme213_tpu_torch.verify import golden

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    peak = roofline.peak_for(kind)
    t_phase = time.perf_counter()
    rows = {"card": ident}
    none = only(None, 0)  # plain torch and host code: no hand-written kernel

    def quiet(fn, *args):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = fn(*args)
        return out, buf.getvalue()

    def rate(cost, ms):
        gbs = cost.gbs(ms)
        return {"ms": ms, "gbs": gbs, "pct_peak": 100.0 * gbs / peak.gbs}

    # cipher: the shipped corpus ×16 through run_cipher, each variant
    # byte-exact against the host golden; then each variant by CUDA events
    timer = core.PhaseTimer()
    ok, out = quiet(lambda: counted(
        "run_cipher corpus x16", none,
        lambda: cipher.run_cipher(timer=timer, device=dev)))
    if not ok:
        fail(f"run_cipher: a variant is not byte-exact\n{out}")
    text = np.tile(load_corpus(), 16)
    d_text = torch.from_numpy(text).to(dev)
    cost = roofline.cipher_cost(text.size)
    rows["cipher"] = {"bytes": int(text.size), "variants": {}}
    for name, fn in cipher.VARIANTS:
        ms = core.time_fn(lambda d, fn=fn: fn(d, 17), d_text, warmup=1,
                          iters=5)
        rows["cipher"]["variants"][name] = dict(
            rate(cost, ms), phase_ms=timer.last_ms(name))
        r = rows["cipher"]["variants"][name]
        print(f"cipher {name} ({text.size} B): {ms:.6f} ms (CUDA events), "
              f"{r['gbs']:.1f} GB/s ({r['pct_peak']:.2f}% of "
              f"{peak.gbs:.0f}); phase (host clock) {r['phase_ms']:.3f} ms; "
              f"byte-exact")

    # PageRank at the reference's defaults: main (ULP-10 against the host
    # golden), then the same graph again: bitwise the golden, twice
    ok, out = quiet(lambda: counted("pagerank.main", none,
                                    lambda: pagerank.main(device=dev)))
    if not ok or "Worked!" not in out:
        fail(f"pagerank.main: {out}")
    g = pagerank.build_graph(1 << 21, 8, 0)
    first = pagerank.run_pagerank(g, 20, device=dev).cpu().numpy()
    t0 = time.perf_counter()
    ref = golden.host_graph_iterate(g.indices, g.edges, g.rank0, g.inv_deg,
                                    20)
    golden_s = time.perf_counter() - t0
    again = pagerank.run_pagerank(g, 20, device=dev).cpu().numpy()
    ulp = int(core.ulp_distance(first, ref).max())
    if ulp != 0 or not np.array_equal(first, again):
        fail(f"pagerank: {ulp} ULP from the golden, repeatable "
             f"{np.array_equal(first, again)}")
    dg = pagerank.upload(g, dev)
    rank0 = torch.from_numpy(g.rank0).to(dev)
    ms = core.time_fn(lambda r: pagerank.iterate(dg, r, 20), rank0,
                      warmup=1, iters=3)
    cost = roofline.pagerank_cost(g.num_nodes, g.edges.shape[0], 20)
    b_ms, b_by = roofline.bound_ms(cost, peak, torch.float32)
    rows["pagerank"] = dict(rate(cost, ms), nodes=g.num_nodes,
                            edges=int(g.edges.shape[0]), iters=20,
                            bound_ms=b_ms, bound_by=b_by, golden_ulp=ulp,
                            repeatable=True, golden_s=golden_s)
    print(f"pagerank 2^21 nodes, {g.edges.shape[0]} edges, 20 iters: "
          f"{ms:.6f} ms (CUDA events), {rows['pagerank']['gbs']:.1f} GB/s "
          f"({rows['pagerank']['pct_peak']:.2f}%), bound {b_ms:.6f} ms by "
          f"{b_by}; bitwise the golden and repeatable; golden "
          f"{golden_s:.1f} s on the host")

    # Vigenère: the create and solve CLIs on the shipped corpus
    vdir = os.path.join(work, "vigenere")
    os.makedirs(vdir)
    cwd = os.getcwd()
    os.chdir(vdir)
    try:
        t0 = time.perf_counter()
        rc, created = quiet(vg.main, ["vigenere", corpus_path(),
                                      str(VIGENERE_PERIOD)])
        rc2, solved = quiet(vg.main, ["vigenere", "solve",
                                      "cipher_text.txt"])
        secs = time.perf_counter() - t0
        plain = np.fromfile("plain_text.txt", dtype=np.uint8)
    finally:
        os.chdir(cwd)
    clean = vg.sanitize(load_corpus(), device=dev)
    key = vg.key_string(vg.generate_key(VIGENERE_PERIOD))
    if rc or rc2 or f"Key: {key}" not in created or \
            f"keyLength: {VIGENERE_PERIOD}" not in solved or \
            f"Key: {key}" not in solved or not np.array_equal(plain, clean):
        fail(f"vigenere: rc {rc}/{rc2}, key {key}\n{created}\n"
             f"{solved[-600:]}")
    rows["vigenere"] = {"chars": int(clean.size), "key": key, "s": secs}
    print(f"vigenere create + solve CLIs on the corpus ({clean.size} "
          f"letters, {secs:.2f} s): key {key} and the plain text recovered")

    # sorts: the CLI at its defaults (host merge, radix, serial radix, and
    # the device radix), then the device sorts at 2^20 uint32 keys
    t0 = time.perf_counter()
    rc, out = quiet(lambda: counted("sorts CLI defaults", none,
                                    lambda: sorts.main(["sorts"])))
    rows["sorts_cli"] = {"s": time.perf_counter() - t0,
                         "threads": native.thread_count()}
    if rc != 0:
        fail(f"sorts CLI: rc {rc}\n{out}")
    print(f"sorts CLI ({rows['sorts_cli']['s']:.1f} s, "
          f"{native.thread_count()} threads):\n  "
          + "\n  ".join(out.strip().splitlines()))
    keys_host = np.random.default_rng(0).integers(0, 2 ** 32, SORT_N,
                                                  dtype=np.uint32)
    keys = torch.from_numpy(keys_host).to(dev)
    want = np.sort(keys_host)
    rows["sorts"] = {}
    for name, fn in (("radix", radix_sort), ("bitonic", bitonic_sort),
                     ("torch.sort", lib_sort)):
        got = counted(f"{name} {SORT_N}", none, lambda fn=fn: fn(keys))
        if not np.array_equal(got.cpu().numpy(), want):
            fail(f"{name} sort of {SORT_N} keys is not exact")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn(keys)
        torch.cuda.synchronize()
        peak_bytes = torch.cuda.max_memory_allocated() - base
        ms = core.time_fn(fn, keys, warmup=1, iters=3)
        cost = roofline.sort_cost(SORT_N, "radix" if name == "radix"
                                  else "merge")
        rows["sorts"][name] = dict(rate(cost, ms), peak_bytes=peak_bytes)
        print(f"{name} {SORT_N} uint32: {ms:.6f} ms (CUDA events), "
              f"{rows['sorts'][name]['gbs']:.1f} GB/s by sort_cost, peak "
              f"{peak_bytes} B over its inputs; exact")

    # the tuner's sort space at 2^20, then sort_auto serving its winner
    with tempfile.TemporaryDirectory() as tdir:
        os.environ[tune.CACHE_ENV] = os.path.join(tdir, "tune.json")
        tune.reset()
        try:
            rc, out = quiet(tune_cli.main, [
                "run", "--op", "sort", "--n", str(SORT_N), "--runs", "5",
                "--json"])
            if rc != 0:
                fail(f"tune run --op sort: rc {rc}\n{out}")
            (rep,) = json.loads(out)
            tune.reset()  # the winner comes back from the disk cache
            mark = len(core.trace.events())
            got = sort_auto(keys)
            hits = [e for e in core.trace.events()[mark:]
                    if e["event"] == "tune-hit" and e["op"] == "sort"]
        finally:
            del os.environ[tune.CACHE_ENV]
            tune.reset()
    win = rep["winner"]
    served = json.loads(hits[-1]["statics"]) if hits else None
    print(f"tune run --op sort {rep['shape_class']}: winner "
          f"{win['candidate']} ({win['ms']} ms); trials "
          f"{[(t['candidate'], t['ms'], t['ok']) for t in rep['trials']]}; "
          f"sort_auto served {served}")
    if served != win["statics"] or not np.array_equal(got.cpu().numpy(),
                                                      want) or \
            not all(t["ok"] for t in rep["trials"]):
        fail(f"sort_auto did not serve the tuned winner: {rep}, {hits}")
    rows["tune_sort"] = {"winner": win, "trials": rep["trials"]}
    sort_row = [r for r in calibration if r["op"] == "sort"]
    print(f"doctor calibrate (phase 22), sort row: {json.dumps(sort_row)}")
    rows["calibrate_sort"] = sort_row

    # the five sweeps through run_all, the suite at a cut scale
    names = ("data_bandwidth_vector_length", "bandwidth_vs_avg_edges",
             "sort_threads", "sort_sweep", "spmv_suite")
    sweep_dir = os.path.join(work, "sweeps29")
    fn_name, quick, full = run_all.JOBS["spmv_suite"]
    run_all.JOBS["spmv_suite"] = (fn_name, quick,
                                  dict(full, scale=SUITE_SWEEP_SCALE))
    print(f"spmv_suite here at scale {SUITE_SWEEP_SCALE} (cut from "
          f"{full['scale']}; its full table runs in a call of its own)")
    label = f"run_all hw1/hw3/hw4 sweeps (spmv_suite scale " \
            f"{SUITE_SWEEP_SCALE})"
    t0 = time.perf_counter()
    try:
        rc, out = quiet(lambda: counted(label, None, lambda: run_all.main(
            ["--out", sweep_dir, "--only", ",".join(names)])))
    finally:
        run_all.JOBS["spmv_suite"] = (fn_name, quick, full)
    rows["sweeps_s"] = time.perf_counter() - t0
    if rc != 0 or paths[label]["spmv_fused"] <= 0:
        fail(f"{label}: rc {rc}, launches {paths[label]}\n{out[-3000:]}")
    rows["sweeps"] = {}
    with open(os.path.join(sweep_dir, "metrics.json")) as f:
        sweep_ms = json.load(f)
    for name in names:
        with open(os.path.join(sweep_dir, f"{name}.csv")) as f:
            table = list(csv.DictReader(f))
        # the suite's float32 iterations lose up to ~2e-3 against the f64
        # golden by rounding alone (rma10 at a tenth, 74 iterations: flat
        # 9.7e-4, JAX's flat the same; B7 2.0e-3, its plain version the
        # same on the CPU), and the JAX package's blocked scan's
        # cancellation a few 1e-2 (jonheart at a tenth: 3.6e-2 on the CPU;
        # the port's blocked scan sums its blocks in float64); a wrong
        # scan is off by O(1).  So flat and pallas-fused rows are held to
        # 1e-2 and blocked rows finite; B7 against its plain version is
        # phase 7's, at 0 ULP
        bad = [r for r in table if r.get("error") or r.get("ok") == "False"
               or ("rel_l2" in r and not float(r["rel_l2"]) <= (
                   float("inf") if r["kernel"] == "blocked" else 1e-2))]
        if not table or bad:
            fail(f"{name}.csv: {len(table)} rows, bad {bad[:3]}")
        rows["sweeps"][name] = table
        print(f"{name}.csv: {len(table)} rows in "
              f"{sweep_ms[name]['ms'] / 1e3:.1f} s")
        for r in table:
            print(f"  {json.dumps(r)}")

    # the loader: phase 28's pwtk files by each tokenizer
    a_txt = os.path.join(work, "spmv", "a.txt")
    x_txt = os.path.join(work, "spmv", "x.txt")
    loads = {}
    for name, use_native in (("native", True), ("python", False)):
        mark = len(core.trace.events())
        t0 = time.perf_counter()
        loads[name] = spmv.load_problem(a_txt, x_txt, use_native=use_native)
        secs = time.perf_counter() - t0
        spans = [(e["tokenizer"], "error" in e)
                 for e in core.trace.events()[mark:]
                 if e["event"] == "span-end"
                 and e.get("span") == "spmv_scan.load"]
        if spans != [(name, False)]:
            fail(f"load_problem with the {name} tokenizer: spans {spans}")
        rows[f"load_{name}_s"] = secs
    same = all(np.array_equal(getattr(loads["native"], f),
                              getattr(loads["python"], f)) for f in "askx")
    print(f"load_problem pwtk: native {rows['load_native_s']:.2f} s, python "
          f"{rows['load_python_s']:.2f} s, bitwise equal {same}")
    if not same or loads["native"].iters != loads["python"].iters:
        fail("the two tokenizers gave different problems")
    rows["seconds"] = time.perf_counter() - t_phase
    print(f"phase 29: {rows['seconds']:.1f} s")
    return rows


#: phase 30: the gang's worker, written into a temporary directory and run
#: by ``python -m cme213_tpu_torch.dist.launch`` as every rank.  ``argv``:
#: out_dir, tag, then the mode: ``heat2d`` runs the heat CLI's ``main`` on
#: the rest of the line and saves the grid its distributed entry returns at
#: full precision (a text dump prints 3 digits); ``spmv NPZ`` runs the
#: supervised sharded SpMV-scan on the problem in NPZ; ``stall`` beats once
#: and, rank 1 in its first incarnation, freezes
GANG_WORKER = r'''
import os, sys, time
sys.path.insert(0, {here!r})
import numpy as np

out_dir, tag, mode = sys.argv[1:4]
rank = os.environ.get("RANK", "0")
inc = os.environ.get("CME213_INCARNATION", "0")
save = f"{{out_dir}}/{{tag}}-rank{{rank}}-inc{{inc}}.npy"
if mode == "stall":
    from cme213_tpu_torch.dist.supervisor import heartbeat_from_env

    hb = heartbeat_from_env()
    hb.beat(1)
    if inc == "0" and rank == "1":
        time.sleep(600)   # alive, its step frozen
    hb.beat(2)
    print("recovered incarnation", inc, flush=True)
elif mode == "spmv":
    from cme213_tpu_torch.apps import spmv_scan as sp
    from cme213_tpu_torch.dist import make_mesh_1d
    from cme213_tpu_torch.dist.mesh import default_devices
    from cme213_tpu_torch.dist.multihost import initialize_multihost
    from cme213_tpu_torch.dist.supervisor import (heartbeat_from_env,
                                                  supervised_env_config)

    initialize_multihost()
    z = np.load(sys.argv[4])
    prob = sp.Problem(a=z["a"], s=z["s"], k=z["k"], x=z["x"],
                      iters=int(z["iters"]))
    cfg = supervised_env_config()
    mesh = make_mesh_1d(devices=default_devices())
    t0 = time.perf_counter()
    out = sp.run_spmv_scan_distributed_supervised(
        prob, mesh, cfg["ckpt_dir"], every=cfg["ckpt_every"],
        resume=cfg["resume"], heartbeat=heartbeat_from_env())
    print(f"supervised solve: {{time.perf_counter() - t0:.6f}} s",
          flush=True)
    np.save(save, out)
else:
    from cme213_tpu_torch.apps import heat2d

    name = ("run_distributed_supervised" if "--supervised" in sys.argv
            else "run_distributed")
    entry = getattr(heat2d, name)

    def caught(*args, **kwargs):
        grid = entry(*args, **kwargs)
        np.save(save, grid)
        return grid

    setattr(heat2d, name, caught)
    sys.exit(heat2d.main(["heat2d", *sys.argv[4:]]))
'''


def bitwise(label, got, want):
    """Fail unless the arrays ``got`` and ``want`` are equal bit for bit."""
    import numpy as np

    if not (got.shape == want.shape and got.dtype == want.dtype
            and np.array_equal(got.view(np.uint8), want.view(np.uint8))):
        fail(f"{label}: not bit for bit")


class Gangs:
    """Gangs of ranks run by ``python -m cme213_tpu_torch.dist.launch``,
    each in a session and a directory of its own under ``root``, over the
    worker script ``GANG_WORKER``; every process's sink is at
    ``root/<tag>-<rank>.jsonl`` (the launcher's ``main``)."""

    def __init__(self, root: str):
        from cme213_tpu_torch import core

        self.root = root
        self.worker = os.path.join(root, "worker.py")
        with open(self.worker, "w") as f:
            f.write(GANG_WORKER.format(here=HERE))
        self.trace_env = core.trace.TRACE_FILE_ENV
        self.env = {k: v for k, v in os.environ.items()
                    if k not in ("CME213_FAULTS", self.trace_env)}
        self.env["PYTHONPATH"] = os.pathsep.join(
            p for p in (HERE, os.environ.get("PYTHONPATH")) if p)

    def run(self, tag, launcher_args, cmd, faults=None, timeout=400):
        """``python -m cme213_tpu_torch.dist.launch launcher_args --
        python worker.py root tag cmd``: (output, seconds); fails on a
        non-zero exit or after ``timeout`` seconds."""
        cwd = os.path.join(self.root, tag)
        os.makedirs(cwd)
        env = dict(self.env, **{self.trace_env: os.path.join(
            self.root, tag + "-{rank}.jsonl")})
        if faults:
            env["CME213_FAULTS"] = faults
        argv = [sys.executable, "-m", "cme213_tpu_torch.dist.launch",
                *launcher_args, "--timeout", str(timeout - 30), "--",
                sys.executable, self.worker, self.root, tag, *cmd]
        t0 = time.perf_counter()
        proc = subprocess.Popen(argv, cwd=cwd, env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)
        try:
            out, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            fail(f"gang {tag}: no result in {timeout} s")
        secs = time.perf_counter() - t0
        print(f"gang {tag} ({secs:.2f} s): {' '.join(launcher_args)}\n"
              + "".join(f"  {line}\n" for line in out.splitlines()
                        if "socket.cpp" not in line), end="")
        if proc.returncode != 0:
            fail(f"gang {tag}: rc {proc.returncode}")
        return out, secs

    def records(self, tag, rank):
        with open(os.path.join(self.root, f"{tag}-{rank}.jsonl")) as f:
            return [json.loads(line) for line in f if line.strip()]

    def events(self, tag, rank, event, **match):
        return [r for r in self.records(tag, rank) if r["event"] == event
                and all(r.get(k) == v for k, v in match.items())]

    def snapshot(self, tag, rank):
        snaps = self.events(tag, rank, "metrics-snapshot")
        if not snaps:
            fail(f"gang {tag}: rank {rank} left no metrics snapshot")
        return snaps[-1]["metrics"]

    def grid(self, tag, rank, inc):
        import numpy as np

        return np.load(os.path.join(self.root,
                                    f"{tag}-rank{rank}-inc{inc}.npy"))

    def startup(self, tag, inc, ranks):
        """Seconds from the launcher's gang-launch of incarnation ``inc``
        to the last of ``ranks``' first heartbeats."""
        t_launch = self.events(tag, "main", "gang-launch",
                               incarnation=inc)[0]["t"]
        first = [min(r["t"] for r in self.events(tag, rank, "heartbeat",
                                                 incarnation=inc))
                 for rank in ranks]
        return max(first) - t_launch


def gang_phase(counted, only, paths, work, dist_p, dist_ref, dist_rows,
               vdev, pwtk, pwtk_ref64):
    """Phase 30: the hw5 solves as a gang of two processes on the one card
    (see the module's docstring).  ``counted``, ``only`` and ``paths`` are
    ``main``'s launch-count helpers and table; ``dist_p`` and ``dist_ref``
    phase 10's parameters and one-device ``run_heat`` grid, ``dist_rows``
    its timed paths, ``vdev`` its four virtual shards; ``pwtk`` and
    ``pwtk_ref64`` phase 8's problem and f64 plain solve.  Returns the
    numbers for the ``gang`` line."""
    import numpy as np
    import torch

    from cme213_tpu_torch import config, core, dist, grid, ops
    from cme213_tpu_torch.verify.checkers import (relative_l2_error,
                                                  relative_linf_error)

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    gangs = Gangs(tempfile.mkdtemp(prefix="gang-", dir=work))
    g = gangs.root
    params = config.SimParams(nx=DIST_N, ny=DIST_N, order=8,
                              iters=DIST_ITERS,
                              grid_method=config.GridMethod.BLOCKS_2D)
    params_path = os.path.join(g, "params.in")
    params.to_file(params_path, distributed=True)
    rows = {}
    gang, events, snapshot = gangs.run, gangs.events, gangs.snapshot
    grid_of = gangs.grid

    def startup(tag, inc):
        return gangs.startup(tag, inc, (0, 1))

    # the gloo gang on one card (on a machine with more cards the ranks
    # would get a card each and NCCL: phase 33)
    gang_dev = ["--np", "2", "--devices-per-proc", "2", "--backend", "gloo"]
    want = dist_ref.cpu().numpy()

    # (a) the plain gang through the heat CLI, B3 in each rank
    mesh2d = dist.make_mesh_2d(2, 2, devices=vdev)
    single = counted(f"run_distributed_heat {DIST_N}x{DIST_N} 2x2 pallas "
                     f"(phase 30's single-process reference)", None,
                     lambda: dist.run_distributed_heat(dist_p, mesh2d,
                                                       local_kernel="pallas"))
    out, secs = gang("a", gang_dev, ["heat2d", params_path, "--distributed",
                                     "--local-kernel=pallas"])
    if out.count("torch.distributed backend gloo") != 2:
        fail("gang a: the ranks did not name the gloo backend")
    per_rank = {}
    for rank in (0, 1):
        bitwise(f"gang a rank {rank} vs the single-process 2x2 pallas "
                f"solve", grid_of("a", rank, 0), single)
        snap = snapshot("a", rank)
        n = snap["counters"].get("kernel.launches.local", 0)
        if n != DIST_ITERS + DIST_PROBE_LAUNCHES:
            fail(f"gang a rank {rank}: {n} B3 launches, expected "
                 f"{DIST_ITERS + DIST_PROBE_LAUNCHES}")
        solve = snap["gauges"]["dist_heat.solve_s"]
        exchange = snap["gauges"]["dist_heat.exchange_s"]
        per_rank[rank] = {"b3_launches": n, "solve_s": solve,
                          "exchange_s": exchange,
                          "exchange_share": exchange / solve}
    label_a = (f"gang 2 ranks x 2 shards, heat2d CLI {DIST_N}x{DIST_N} 2d "
               f"sync pallas")
    paths[label_a] = only("local", sum(r["b3_launches"]
                                       for r in per_rank.values()))
    print(f"launches of {label_a}: {paths[label_a]}")
    dumps = sorted(os.listdir(os.path.join(g, "a")))
    if dumps != ["grid0_final.txt", "grid1_final.txt", "grid2_final.txt",
                 "grid3_final.txt", "grid_final.txt", "grid_init.txt"]:
        fail(f"gang a: dumps {dumps}")
    one = dist_rows[f"run_distributed {DIST_N}x{DIST_N} 2d sync pallas"]
    single_s = one["ms"] * DIST_ITERS / 1e3
    rows["a"] = {"backend": "gloo", "launcher_s": secs, "ranks": per_rank,
                 "single_process_s": single_s,
                 "gang_over_single": max(r["solve_s"]
                                         for r in per_rank.values())
                 / single_s}
    print(f"phase 30 (a): gang solve {[r['solve_s'] for r in per_rank.values()]}"
          f" s against phase 10's single-process {single_s:.6f} s; the "
          f"host-staged exchange takes "
          f"{[round(r['exchange_share'], 6) for r in per_rank.values()]} "
          f"of the bracket; backend gloo; bit for bit the 2x2 pallas solve")

    # (b) the supervised gang, rank 1 killed after one commit
    ckpt = os.path.join(g, "ckpt")
    out, secs = gang("b", [*gang_dev, "--stall-timeout", "60",
                           "--max-restarts", "1", "--ckpt-dir", ckpt,
                           "--ckpt-every", "250"],
                     ["heat2d", params_path, "--distributed",
                      "--supervised"], faults="rankkill:1:1")
    for needle in ("injected kill: rank 1 at step 1", "condemning the gang",
                   "gang restart (incarnation 1/1)"):
        if needle not in out:
            fail(f"gang b: no {needle!r} in its output")
    for rank in (0, 1):
        bitwise(f"gang b rank {rank} vs the uninterrupted solve",
                grid_of("b", rank, 1), want)
    commit_ms = sorted(e["ms"] for e in events("b", 0, "epoch-commit"))
    if len(commit_ms) != 4:
        fail(f"gang b: {len(commit_ms)} epoch commits, expected 4")
    (kill,) = events("b", 1, "fault-injected", kind="rankkill")
    (verdict,) = events("b", "main", "rank-failed")
    resumed = min(r["t"] for rank in (0, 1)
                  for r in events("b", rank, "heartbeat", incarnation=1))
    rows["b"] = {"launcher_s": secs,
                 "commit_ms_p50": commit_ms[(len(commit_ms) - 1) // 2],
                 "commit_ms_max": commit_ms[-1], "commit_ms": commit_ms,
                 "kill_to_verdict_s": verdict["t"] - kill["t"],
                 "kill_to_resumed_beat_s": resumed - kill["t"],
                 "startup_s": [startup("b", 0), startup("b", 1)]}
    print(f"phase 30 (b): {json.dumps(rows['b'])}")

    # (c) a frozen rank, condemned by the stall clock; its ranks touch no
    # card and mostly sleep, so it runs beside (d) and (e)
    beside = ThreadPoolExecutor(1)
    gang_c = beside.submit(gang, "c", ["--np", "2", "--stall-timeout", "5",
                                       "--max-restarts", "1"], ["stall"],
                           timeout=200)

    # (d) (b)'s last commit resumed on one process's 1-D mesh of 4 shards
    more = 250
    p_more = config.SimParams(nx=DIST_N, ny=DIST_N, order=8,
                              iters=DIST_ITERS + more,
                              grid_method=config.GridMethod.BLOCKS_2D)
    mark = len(core.trace.events())
    t0 = time.perf_counter()
    resumed = counted(f"run_distributed_heat_supervised {DIST_N}x{DIST_N} "
                      f"resumed on 1-D x 4", only(None, 0),
                      lambda: dist.run_distributed_heat_supervised(
                          p_more, dist.make_mesh_1d(4, devices=vdev), ckpt,
                          ckpt_every=more))
    secs = time.perf_counter() - t0
    loaded = [e for e in core.trace.events()[mark:]
              if e["event"] == "commit-loaded"]
    if not loaded or loaded[0]["step"] != DIST_ITERS:
        fail(f"phase 30 (d): resumed from {loaded}")
    ref_more = ops.run_heat(grid.make_initial_grid(p_more, device=dev),
                            p_more.iters, p_more.order, p_more.xcfl,
                            p_more.ycfl).cpu().numpy()
    bitwise("phase 30 (d) vs the uninterrupted 1250-step solve", resumed,
            ref_more)
    rows["d"] = {"resumed_from_step": DIST_ITERS, "steps": more,
                 "seconds": secs}
    print(f"phase 30 (d): {json.dumps(rows['d'])}")

    # (e) the supervised sharded SpMV-scan at pwtk, uninterrupted and with
    # rank 0 killed after two commits
    npz = os.path.join(g, "pwtk.npz")
    np.savez(npz, a=pwtk.a, s=pwtk.s, k=pwtk.k, x=pwtk.x, iters=pwtk.iters)
    solves = {}
    for tag, faults, restarts in (("e0", None, "0"),
                                  ("e1", "rankkill:0:2", "1")):
        out, secs = gang(tag, [*gang_dev, "--stall-timeout", "120",
                               "--max-restarts", restarts, "--ckpt-dir",
                               os.path.join(g, f"ckpt-{tag}"),
                               "--ckpt-every", "5"], ["spmv", npz],
                         faults=faults)
        inc = 1 if faults else 0
        res = [grid_of(tag, rank, inc) for rank in (0, 1)]
        bitwise(f"gang {tag} rank 1 vs rank 0", res[1], res[0])
        seconds = [float(line.split()[-2]) for line in out.splitlines()
                   if "supervised solve:" in line]
        solves[tag] = (res[0], seconds, secs)
    if "condemning the gang" not in out:
        fail("gang e1: no gang verdict")
    bitwise("gang e1 vs the uninterrupted gang", solves["e1"][0],
            solves["e0"][0])
    rel_l2 = relative_l2_error(pwtk_ref64, solves["e0"][0])
    rel_linf = relative_linf_error(pwtk_ref64, solves["e0"][0])
    tol_l2, tol_linf = PWTK_TOL["auto"]
    if not (rel_l2 <= tol_l2 and rel_linf <= tol_linf):
        fail(f"gang e: rel L2 {rel_l2:.3e} / rel Linf {rel_linf:.3e} "
             f"(limits {tol_l2} / {tol_linf})")
    e_commits = sorted(e["ms"] for e in events("e0", 0, "epoch-commit"))
    rows["e"] = {"rel_l2": rel_l2, "rel_linf": rel_linf,
                 "supervised_ms_per_iter": [s * 1e3 / pwtk.iters
                                            for s in solves["e0"][1]],
                 "commit_ms_p50": e_commits[(len(e_commits) - 1) // 2],
                 "commit_ms_max": e_commits[-1],
                 "launcher_s": [solves["e0"][2], solves["e1"][2]]}
    print(f"phase 30 (e): {json.dumps(rows['e'])}")

    out, secs = gang_c.result()
    beside.shutdown()
    if "stalled at step 1 for" not in out \
            or out.count("recovered incarnation 1") != 2:
        fail("gang c: no stall verdict or no recovery")
    (beat,) = events("c", 1, "heartbeat", incarnation=0)
    (verdict,) = events("c", "main", "rank-failed")
    if verdict["reason"] != "stall":
        fail(f"gang c: verdict {verdict}")
    rows["c"] = {"launcher_s": secs, "stall_timeout_s": 5,
                 "detection_s": verdict["t"] - beat["t"]}
    print(f"phase 30 (c): {json.dumps(rows['c'])}")
    rows["seconds"] = time.perf_counter() - t_phase
    print(f"phase 30: {rows['seconds']:.1f} s")
    return rows


#: phase 31's loadgen mix and request count (the CLI children and the
#: in-process runs held lane by lane), and its full-size request counts
SERVE_MIX, SERVE_REQUESTS = "spmv,heat,cipher,sort", 64
SERVE_HEAT_N, SERVE_HEAT_ITERS, SERVE_HEAT_REQS = 2000, 200, 4
SERVE_SPMV_ITERS, SERVE_SPMV_REQS = 10, 4
SERVE_CIPHER_REQS, SERVE_SORT_N, SERVE_SORT_REQS = 8, 1 << 20, 8
#: the memory budget of phase 31(b): four radix lanes of 2^20 keys fit
#: (``ops.sort.radix_peak_bytes``: 2.46 GB a lane), five do not, so the
#: batch of eight shrinks to four
SERVE_BUDGET = "10G"
#: phase 31(d)'s durable job: the reference's PageRank job defaults
SERVE_JOB = {"nodes": 4096, "avg_edges": 8, "iters": 48, "epoch": 8,
             "seed": 0}


def serial_solve(op, payload, rung, dev):
    """One served request's serial solve on ``dev``, outside any server:
    what phases 31 and 32 hold every served result to, bit for bit."""
    from cme213_tpu_torch import ops
    from cme213_tpu_torch.apps import spmv_scan as spmv
    from cme213_tpu_torch.grid import make_initial_grid
    from cme213_tpu_torch.serve.workloads import _sort_one

    import torch

    if op == "cipher":
        t = torch.from_numpy(payload.text).to(dev)
        fn = (ops.shift_cipher_packed if rung == "packed"
              else ops.shift_cipher)
        return fn(t, payload.shift).cpu().numpy()
    if op == "sort":
        return _sort_one(payload, rung, dev)
    if op == "heat":
        return ops.run_heat(make_initial_grid(payload, device=dev),
                            payload.iters, payload.order,
                            payload.xcfl, payload.ycfl).cpu().numpy()
    a, xx, flags, _ = spmv.problem_tensors(payload, device=dev)
    return spmv._iterate(a, xx, flags, payload.iters,
                         scan=rung).cpu().numpy()


def serving_phase(counted, only, paths, work, ident, pwtk):
    """Phase 31: the serving front end on the card (see the module's
    docstring).  ``counted``, ``only`` and ``paths`` are ``main``'s
    launch-count helpers and table, ``work`` its scratch directory and
    ``pwtk`` phase 8's problem.  Every path is counted and must launch no
    hand-written kernel: the JAX package serves XLA programs only.
    Returns the numbers for the ``serving`` line."""
    import dataclasses

    import numpy as np
    import torch

    from cme213_tpu_torch import config, core, trace_cli
    from cme213_tpu_torch.apps import pagerank
    from cme213_tpu_torch.apps.corpus import load_corpus
    from cme213_tpu_torch.serve import (OK, RequestSpec, Server, jobs,
                                        loadgen, wire)
    from cme213_tpu_torch.serve.transport import (TransportClient,
                                                  TransportServer)
    from cme213_tpu_torch.serve.workloads import (ADAPTERS, CipherRequest,
                                                  SortAdapter)
    from cme213_tpu_torch.verify import golden

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    none = only(None, 0)  # plain torch and host code: no hand-written kernel
    rows = {"card": ident}
    s_dir = tempfile.mkdtemp(prefix="serve-", dir=work)
    env = {k: v for k, v in os.environ.items()
           if k not in ("CME213_FAULTS", core.trace.TRACE_FILE_ENV,
                        core.admission.BUDGET_ENV)}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p)

    def bitwise(label, got, want):
        got, want = np.asarray(got), np.asarray(want)
        if got.dtype != want.dtype or got.shape != want.shape or \
                got.tobytes() != want.tobytes():
            fail(f"{label}: not bit for bit its serial solve")

    def serial(op, payload, rung):
        return serial_solve(op, payload, rung, dev)

    def child(label, args, timeout=300):
        """``python -m cme213_tpu_torch serve args`` on the card with its
        own sink: (stdout, seconds); its launches from the sink."""
        sink = os.path.join(s_dir, f"{label}.jsonl")
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "cme213_tpu_torch", "serve", *args],
            cwd=s_dir, env=dict(env, **{core.trace.TRACE_FILE_ENV: sink}),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            start_new_session=True)
        try:
            out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            fail(f"serve {label}: no result in {timeout} s")
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"serve {label}: rc {proc.returncode}\n{err[-3000:]}")
        snap = trace_cli.load_metrics_snapshot(sink)
        got = only(None, 0)
        for name, n in snap.get("counters", {}).items():
            if name.startswith("kernel.launches."):
                got[name[len("kernel.launches."):]] = n
        paths[f"serve {label} (child)"] = got
        print(f"launches of serve {label} (child): {got}")
        if got != none:
            fail(f"serve {label}: launched hand-written kernels {got}")
        return out, secs

    # ------------------------------------------- (a) the CLI, in children
    cli = {}
    base = ["loadgen", "--mix", SERVE_MIX, "--requests", str(SERVE_REQUESTS),
            "--json"]
    for mode in ("closed", "open"):
        out, secs = child(f"loadgen-{mode}", [*base, "--mode", mode])
        rep = json.loads(out)
        print(f"serve loadgen --mode {mode} on cuda ({secs:.1f} s, the "
              f"child's start and CUDA set-up included):")
        print("".join(f"  {line}\n" for line in
                      loadgen.format_report(rep).splitlines()), end="")
        print(json.dumps({f"loadgen_{mode}": rep}))
        if rep["failed"] or rep["served"] + rep["shed"] != SERVE_REQUESTS \
                or (mode == "closed" and rep["shed"]):
            fail(f"loadgen {mode}: {rep['served']} served, {rep['shed']} "
                 f"shed, {rep['failed']} failed")
        cli[mode] = {"seconds": secs, "throughput_rps": rep["throughput_rps"],
                     "latency_ms": rep["latency_ms"], "phases": rep["phases"],
                     "batch_mean_size": rep["batch_mean_size"],
                     "batches": rep["batches"],
                     "shed_by_reason": rep["shed_by_reason"]}
    out, secs = child("warmup", ["warmup", "--mix", SERVE_MIX, "--json"])
    warm = json.loads(out)
    print(f"serve warmup on cuda ({secs:.1f} s): {len(warm['warmed'])} "
          f"buckets, {warm['programs']} programs, build-and-warm "
          f"{warm['compile']['compile_ms']} ms; CME213_COMPILE_CACHE "
          f"{warm['compile_cache_env']}")
    if not warm["warmed"] or warm["persistent_cache"] is not None:
        fail(f"serve warmup: {warm}")
    cli["warmup"] = {"seconds": secs, "buckets": len(warm["warmed"]),
                     "programs": warm["programs"],
                     "compile_ms": warm["compile"]["compile_ms"]}
    # the same runs in this process, every OK result held to its own
    # serial solve on the card
    held = 0
    for mode in ("closed", "open"):
        specs = loadgen.build_mix(SERVE_MIX, SERVE_REQUESTS, seed=0)
        server = Server(capacity=64, max_batch=8, device=dev)
        run = counted(f"serve run_load {mode} {SERVE_MIX}", none,
                      lambda: loadgen.run_load(server, specs, mode=mode))
        by_rid = {r.rid: r for r in run["results"]}
        for rid, spec in enumerate(specs):
            res = by_rid[rid]
            if res.status == OK:
                bitwise(f"run_load {mode} rid {rid} ({spec.op})", res.value,
                        serial(spec.op, spec.payload, res.rung))
                held += 1
    print(f"run_load closed and open on cuda: {held} served results, each "
          f"bit for bit its serial solve on the card")
    rows["cli"] = dict(cli, lanes_held=held)

    # ------------------------------------------- (b) full size, batched
    rng = np.random.default_rng(31)
    heat = [config.SimParams(nx=SERVE_HEAT_N, ny=SERVE_HEAT_N, order=8,
                             iters=SERVE_HEAT_ITERS,
                             alpha=float(rng.uniform(0.5, 2.0)))
            for _ in range(SERVE_HEAT_REQS)]
    spmv_reqs = [dataclasses.replace(
        pwtk, x=(pwtk.x if i == 0 else rng.permutation(pwtk.x)),
        iters=SERVE_SPMV_ITERS) for i in range(SERVE_SPMV_REQS)]
    text = np.tile(load_corpus(), 16)
    cipher_reqs = [CipherRequest(text, int(s)) for s in
                   rng.integers(1, 26, SERVE_CIPHER_REQS)]
    keys = [rng.integers(0, 2**32, SERVE_SORT_N, dtype=np.uint32)
            for _ in range(SERVE_SORT_REQS)]
    # (op, rung, adapter, payloads, server knobs): spmv's flat rung is
    # what degraded mode serves (a queue of 1 already degrades)
    def one_rung_sorts(rung):
        # the sort adapter's ladder starts at lax: serve one rung alone,
        # so the batch is preflighted at that rung's bytes
        class OneRung(SortAdapter):
            def rungs(self, degraded=False):
                return (rung,)
        return OneRung()

    cases = [("heat", "xla", ADAPTERS["heat"], heat, {}),
             ("spmv_scan", "blocked", ADAPTERS["spmv_scan"], spmv_reqs, {}),
             ("spmv_scan", "flat", ADAPTERS["spmv_scan"], spmv_reqs,
              {"degrade_depth": 1}),
             ("cipher", "packed", ADAPTERS["cipher"], cipher_reqs, {}),
             ("sort", "radix", one_rung_sorts("radix"), keys, {}),
             ("sort", "bitonic", one_rung_sorts("bitonic"), keys, {})]
    full = {}
    os.environ[core.admission.BUDGET_ENV] = SERVE_BUDGET
    try:
        for op, rung, adapter, payloads, knobs in cases:
            label = f"{op} {rung}"

            def serve_all(max_batch, adapter=adapter, payloads=payloads,
                          op=op, knobs=knobs):
                server = Server(capacity=64, max_batch=max_batch,
                                device=dev, adapters={op: adapter}, **knobs)
                for pl in payloads:
                    server.submit(op, pl)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = server.drain()
                torch.cuda.synchronize()
                return out, time.perf_counter() - t0

            core.trace.clear_events()
            serve_all(SERVE_SORT_REQS)  # warm: programs, probes, verdicts
            mark = len(core.trace.events())
            torch.cuda.reset_peak_memory_stats()
            base_mem = torch.cuda.memory_allocated()
            results, b_s = counted(f"serve {label} full size", none,
                                   lambda: serve_all(8))
            peak = torch.cuda.max_memory_allocated() - base_mem
            widths = sorted({r.batch_size for r in results})
            shrunk = [e for e in core.trace.events()[mark:]
                      if e["event"] == "chunk-shrunk"]
            _, s_s = serve_all(1)
            for i, (r, pl) in enumerate(zip(results, payloads)):
                if r.status != OK or r.rung != rung:
                    fail(f"serve {label} lane {i}: {r.status} on {r.rung} "
                         f"({r.reason})")
                bitwise(f"serve {label} lane {i}", r.value,
                        serial(op, pl, rung))
            width = widths[-1]
            step = payloads[:width]
            builder = adapter.preflight_builder(step, rung, device=dev)
            counted_bytes = (builder(width).required_bytes
                             if builder is not None else None)
            idle = idle_share(torch, lambda: adapter.run_batch(
                step, rung, device=dev), 1)
            n_req = len(payloads)
            full[label] = {
                "requests": n_req, "admitted_widths": widths,
                "chunk_shrunk": [(e["from_size"], e["to_size"])
                                 for e in shrunk],
                "ms_per_request": b_s * 1e3 / n_req,
                "req_s": n_req / b_s,
                "serial_ms_per_request": s_s * 1e3 / n_req,
                "batched_vs_serial": s_s / b_s,
                "peak_bytes_over_baseline": peak,
                "preflight_bytes_at_width": counted_bytes,
                "idle_share": idle["idle_share"],
                "idle_share_unprofiled": idle.get("idle_share_unprofiled"),
                "batch_ms": idle.get("unprofiled_ms_per_step")}
            print(f"serve {label} at full size: {n_req} requests, admitted "
                  f"widths {widths} (chunk-shrunk "
                  f"{full[label]['chunk_shrunk']}), "
                  f"{full[label]['ms_per_request']:.3f} ms a request, "
                  f"{full[label]['req_s']:.2f} req/s, batched/serial "
                  f"{full[label]['batched_vs_serial']:.3f}x, peak "
                  f"{peak / 1e9:.3f} GB over the baseline (preflight count "
                  f"at width {width}: {counted_bytes}), idle share of a "
                  f"{width}-wide batch {idle['idle_share']}; every lane bit "
                  f"for bit its serial solve; card {ident}")
            del results
    finally:
        os.environ.pop(core.admission.BUDGET_ENV, None)
    if full["sort radix"]["admitted_widths"][-1] >= SERVE_SORT_REQS \
            or not full["sort radix"]["chunk_shrunk"]:
        fail(f"the radix batch did not shrink under {SERVE_BUDGET}: "
             f"{full['sort radix']}")
    rows["full_size"] = dict(full, budget=SERVE_BUDGET)

    # ------------------------------------------- (c) the socket front end
    server = Server(capacity=256, max_batch=8, device=dev)
    ts = TransportServer(server, drive="thread",
                         poll_interval_s=0.001).start()
    try:
        stub = loadgen.build_mix("stub", 2000, seed=1)
        before = core.metrics.snapshot()

        def stub_loop():
            with TransportClient(ts.addr, shm=True, timeout_s=60.0) as c:
                if not c.shm_active:
                    fail("transport: the shm lane did not negotiate")
                t0 = time.perf_counter()
                out, window = [], []
                for spec in stub:
                    window.append(c.submit(spec.op, spec.payload))
                    if len(window) >= 16:
                        out.append(c.result(window.pop(0)))
                out += [c.result(r) for r in window]
                return {"results": out,
                        "elapsed_s": time.perf_counter() - t0}

        run = counted("serve transport stub closed loop (v2, shm)", none,
                      stub_loop)
        tsec = loadgen.transport_section(run, before,
                                         core.metrics.snapshot())
        ok_n = sum(r.status == OK for r in run["results"])
        for r, spec in zip(run["results"], stub):
            bitwise("transport stub echo", r.value, spec.payload)
        stub_rps = ok_n / run["elapsed_s"]
        print(f"transport stub closed loop on the card's server (v2 + shm "
              f"lane, 16 in flight): {ok_n} served, {stub_rps:.1f} req/s, "
              f"codec share of p99 rtt {tsec.get('codec_share')}, client "
              f"rtt p50/p99 {tsec['client']['rtt_ms']}; card {ident}")
        ciphers = loadgen.build_mix("cipher", 16, seed=2) + [
            RequestSpec("cipher", cipher_reqs[0])]
        local = Server(max_batch=8, device=dev)
        for spec in ciphers:
            local.submit(spec.op, spec.payload)
        ref = {r.rid: r.value for r in local.drain()}

        def cipher_wire():
            with TransportClient(ts.addr, shm=True, timeout_s=60.0) as c:
                rids = [c.submit(s.op, s.payload) for s in ciphers]
                return [c.result(r) for r in rids]

        got = counted("serve transport cipher over the wire", none,
                      cipher_wire)
        for i, r in enumerate(got):
            if r.status != OK:
                fail(f"transport cipher {i}: {r.status} {r.reason}")
            bitwise(f"transport cipher {i}", r.value, ref[i])
        print(f"transport cipher over the wire: {len(got)} requests "
              f"(4096 B on the shm lane, one of {text.nbytes} B over the "
              f"socket), each bit for bit the in-process result")
        rows["transport"] = {"stub_req_s": stub_rps, "stub_served": ok_n,
                             "codec_share": tsec.get("codec_share"),
                             "client": tsec["client"],
                             "cipher_wire_bitwise": len(got)}
    finally:
        ts.close()

    # ------------------------------------------- (d) a durable job
    j_dir = os.path.join(s_dir, "jobs")
    params = SERVE_JOB
    graph = pagerank.build_graph(params["nodes"], params["avg_edges"],
                                 params["seed"])
    want = golden.host_graph_iterate(graph.indices, graph.edges,
                                     graph.rank0, graph.inv_deg,
                                     params["iters"])

    def job_lane(rank="0"):
        srv = Server(capacity=8, max_batch=4, device=dev)
        store = jobs.JobStore(j_dir)
        ex = jobs.JobExecutor(store, server=srv, rank=rank)
        return srv, TransportServer(srv, drive="caller").attach_jobs(
            ex).start(), ex

    def first_lane():
        srv, ts1, ex = job_lane()
        try:
            with TransportClient(ts1.addr, timeout_s=60.0) as c:
                sub = c.control("job-submit", job="pr1", op="pagerank",
                                params=params)
                if not (sub["ok"] and sub["created"]):
                    fail(f"job-submit: {sub}")
                while c.control("job-status",
                                job="pr1")["job"]["epoch"] < 2:
                    ts1.pump()
                # interactive traffic arrives: the job yields at the
                # epoch boundary, and the replica then goes away
                spec = loadgen.build_mix("cipher", 1, seed=3)[0]
                srv.submit(spec.op, spec.payload)
                ex.tick()
                srv.step()
                st = c.control("job-status", job="pr1")["job"]
            return st
        finally:
            ts1.close()

    st = counted("serve job pagerank epochs 1-2", none, first_lane)
    if st["state"] != "PREEMPTED" or st["epoch"] != 2:
        fail(f"job after two epochs: {st}")

    def second_lane():
        srv, ts2, ex = job_lane()
        try:
            with TransportClient(ts2.addr, timeout_s=60.0) as c:
                t0 = time.perf_counter()
                while c.control("job-status", job="pr1")["job"][
                        "state"] not in jobs.TERMINAL:
                    ts2.pump()
                secs = time.perf_counter() - t0
                done = c.control("job-status", job="pr1")["job"]
                res = c.control("job-result", job="pr1")
            return done, res, secs
        finally:
            ts2.close()

    done, res, secs = counted("serve job pagerank resumed", none,
                              second_lane)
    value = wire.nd_b64_decode(res["value"]) if res.get("ok") else None
    resumed = core.trace.events("job-resumed")
    epochs = [e["epoch"] for e in core.trace.events("job-epoch")
              if e["job"] == "pr1"]
    print(f"durable job pagerank {params['nodes']} nodes, {params['iters']} "
          f"iterations, epoch {params['epoch']}: preempted at epoch 2, "
          f"resumed by a new executor ({[e['source'] for e in resumed]}), "
          f"{done['state']} at epoch {done['epoch']}/{done['total_epochs']} "
          f"in {secs:.2f} s; epochs run {epochs}")
    if done["state"] != "DONE" or value is None:
        fail(f"job: {done} {res.get('error')}")
    bitwise("job pagerank result vs host_graph_iterate", value, want)
    if sorted(set(epochs)) != epochs or epochs != list(
            range(1, done["total_epochs"] + 1)):
        fail(f"job epochs ran twice or were skipped: {epochs}")
    rows["job"] = {"state": done["state"], "epochs": epochs,
                   "resumes": done["resumes"],
                   "preemptions": done["preemptions"],
                   "resume_to_done_s": secs, "bitwise_golden": True}
    rows["seconds"] = time.perf_counter() - t_phase
    print(f"phase 31 (serving): {rows['seconds']:.1f} s; every serving "
          f"path launched no hand-written kernel")
    return rows


#: phase 32: replicas of the fleet on the one card, phase 31's loadgen mix
#: (closed and open), the chaos game day's flags, the drill's (a seed
#: whose cocktail drifts the spmv rung that serves), and the durable job:
#: long enough (100 epochs of 2 iterations) that the kill lands mid-job
FLEET_REPLICAS, FLEET_MAX_REPLICAS = 2, 3
FLEET_CHAOS = ["--backend", "fleet", "--replicas", "2", "--campaigns", "4",
               "--seed", "1", "--mix", "cipher,sort,heat"]
FLEET_DRILL = ["--backend", "inproc", "--campaigns", "1", "--seed", "0",
               "--mix", "spmv", "--disable", "drift-compensation"]
FLEET_JOB = {"nodes": 65536, "avg_edges": 8, "iters": 200, "epoch": 2,
             "seed": 5, "stall_epochs": 1000}


def _fleet_workers() -> list[int]:
    """Live replica processes (``... cme213_tpu_torch fleet worker``)."""
    pids = []
    for name in os.listdir("/proc"):
        try:
            with open(f"/proc/{name}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ")
        except OSError:
            continue
        if b"cme213_tpu_torch fleet worker" in cmd:
            pids.append(int(name))
    return sorted(pids)


def _process_note(pid: int) -> str:
    """A live process's parent, rank, incarnation, age and command line,
    from ``/proc``."""
    try:
        with open(f"/proc/{pid}/status") as f:
            ppid = next(line.split()[1] for line in f
                        if line.startswith("PPid:"))
        with open(f"/proc/{pid}/environ", "rb") as f:
            env = dict(kv.split(b"=", 1) for kv in f.read().split(b"\0")
                       if b"=" in kv)
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        age = time.time() - os.stat(f"/proc/{pid}").st_ctime
    except (OSError, StopIteration) as e:
        return f"pid {pid}: {e}"
    keys = (b"RANK", b"CME213_INCARNATION", b"CME213_TRACE_FILE")
    return (f"pid {pid}, parent {ppid}, about {age:.0f} s old, "
            + ", ".join(f"{k.decode()}={env.get(k, b'').decode()}"
                        for k in keys) + f": {cmd}")


def _sink_events(path, event):
    """``event`` records of one trace sink; a line torn by a SIGKILL is
    skipped."""
    out = []
    if not os.path.exists(path):
        return out
    with open(path, errors="replace") as f:
        for line in f:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("event") == event:
                out.append(rec)
    return out


def _sink_launches(paths) -> dict[str, int]:
    """Hand-written kernel launches from the exit ``metrics-snapshot`` of
    every process that wrote to the sinks ``paths`` (a replica killed by
    SIGKILL writes none)."""
    got: dict[str, int] = {}
    for path in paths:
        for rec in _sink_events(path, "metrics-snapshot"):
            for name, n in rec.get("metrics", {}).get("counters",
                                                       {}).items():
                if name.startswith("kernel.launches."):
                    key = name[len("kernel.launches."):]
                    got[key] = got.get(key, 0) + n
    return got


def fleet_phase(counted, only, paths, work, ident):
    """Phase 32: the replicated fleet on the card (see the module's
    docstring).  ``counted``, ``only`` and ``paths`` are ``main``'s
    launch-count helpers and table, ``work`` its scratch directory.  The
    replicas serve plain torch rungs, as phase 31's server does, so every
    replica, campaign and drill must launch no hand-written kernel.
    Returns the numbers for the ``fleet`` line."""
    import threading

    import numpy as np
    import torch

    from cme213_tpu_torch import fleet_cli
    from cme213_tpu_torch.apps import pagerank
    from cme213_tpu_torch.core import admission, chaos, trace
    from cme213_tpu_torch.serve import FAILED, OK, SHED, SolveResult
    from cme213_tpu_torch.serve import loadgen
    from cme213_tpu_torch.serve.transport import TransportClient
    from cme213_tpu_torch.verify import golden

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    none = only(None, 0)  # plain torch and host code: no hand-written kernel
    f_dir = tempfile.mkdtemp(prefix="fleet-", dir=work)
    shm_before = chaos._shm_segments()
    if _fleet_workers():
        fail(f"replica processes alive before phase 32: {_fleet_workers()}")
    total = torch.cuda.get_device_properties(dev).total_memory
    budget = total // FLEET_REPLICAS
    rows = {"card": ident, "replicas": FLEET_REPLICAS,
            "memory_budget_bytes": budget, "card_memory_bytes": total}
    base_env = {k: v for k, v in os.environ.items()
                if k not in ("CME213_FAULTS", trace.TRACE_FILE_ENV,
                             admission.BUDGET_ENV, "CME213_FLIGHT_DIR",
                             "CME213_JOBS_DIR", "RANK")}
    base_env["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p)
    base_env["TMPDIR"] = f_dir      # chaos campaigns' scratch: removed
    base_env[admission.BUDGET_ENV] = str(budget)
    sinks: list[str] = []

    def bitwise(label, got, want):
        got, want = np.asarray(got), np.asarray(want)
        if got.dtype != want.dtype or got.shape != want.shape or \
                got.tobytes() != want.tobytes():
            fail(f"{label}: not bit for bit its serial solve on the card")

    def fleet_up(label, args, faults=None):
        """``python -m cme213_tpu_torch fleet up`` in a session of its own
        with per-rank sinks and a flight directory; (proc, addr, env,
        seconds to the address)."""
        env = dict(base_env)
        env[trace.TRACE_FILE_ENV] = os.path.join(f_dir,
                                                 f"{label}-{{rank}}.jsonl")
        env["CME213_FLIGHT_DIR"] = os.path.join(f_dir, f"{label}-flight")
        if faults:
            env["CME213_FAULTS"] = faults
        sinks.append(env[trace.TRACE_FILE_ENV])
        addr_file = os.path.join(f_dir, f"{label}.addr")
        log = open(os.path.join(f_dir, f"{label}.log"), "w")
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "cme213_tpu_torch", "fleet", "up",
             "--addr-file", addr_file, "--json", "--max-seconds", "900",
             *args], cwd=f_dir, env=env, stdout=subprocess.PIPE,
            stderr=log, text=True, start_new_session=True)
        log.close()
        while not os.path.exists(addr_file):
            if proc.poll() is not None or time.perf_counter() - t0 > 180:
                os.killpg(proc.pid, signal.SIGKILL)
                fail(f"fleet up {label}: no address (rc {proc.poll()}); "
                     f"{open(log.name).read()[-3000:]}")
            time.sleep(0.05)
        time.sleep(0.05)  # the address is written once listening
        with open(addr_file) as f:
            addr = f.read().strip()
        return proc, addr, env, time.perf_counter() - t0

    def fleet_down(label, proc):
        """SIGTERM: the front end prints its stats, stops its replicas."""
        proc.send_signal(signal.SIGTERM)
        try:
            out, _ = proc.communicate(timeout=90)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            fail(f"fleet up {label}: did not stop in 90 s")
        if proc.returncode != 0:
            fail(f"fleet up {label}: rc {proc.returncode}")
        return json.loads(out)

    def stats(addr):
        with TransportClient(addr, timeout_s=30.0) as c:
            return c.control("stats")["stats"]

    def drive(addr, specs, mode="closed", concurrency=8):
        """Client threads against the front end, as ``serve loadgen
        --transport`` drives it, keeping each request beside its result
        and its round trip: closed ``concurrency`` connections, open one
        connection a request, all at once."""
        pairs = [None] * len(specs)
        work_q = list(enumerate(specs))
        mu = threading.Lock()

        def one(client, i, spec):
            t0 = time.perf_counter()
            try:
                res = client.solve(spec.op, spec.payload,
                                   deadline_ms=spec.deadline_ms,
                                   tenant=spec.tenant)
            except (OSError, ConnectionError, ValueError,
                    TimeoutError) as e:
                res = SolveResult(-1, spec.op, FAILED,
                                  reason=f"transport: {e}",
                                  tenant=spec.tenant)
            pairs[i] = (spec, res, (time.perf_counter() - t0) * 1e3)

        def worker():
            with TransportClient(addr, timeout_s=120.0) as client:
                while True:
                    with mu:
                        if not work_q:
                            return
                        i, spec = work_q.pop(0)
                    one(client, i, spec)

        def fire(i, spec):
            with TransportClient(addr, timeout_s=120.0) as client:
                one(client, i, spec)

        threads = ([threading.Thread(target=worker)
                    for _ in range(concurrency)] if mode == "closed" else
                   [threading.Thread(target=fire, args=(i, s))
                    for i, s in enumerate(specs)])
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        secs = time.perf_counter() - t0
        if any(p is None for p in pairs):
            fail(f"fleet drive {mode}: requests without a response")
        return pairs, secs

    def summarise(pairs, secs):
        res = [r for _, r, _ in pairs]
        served = sum(r.status == OK for r in res)
        shed = sum(r.status == SHED for r in res)
        failed = [r for r in res if r.status not in (OK, SHED)]
        if failed or len(res) - shed != served:
            fail(f"fleet: {len(res)} submitted, {shed} shed, {served} "
                 f"served, {len(failed)} failed "
                 f"({failed[0].reason if failed else ''})")
        by_op = {}
        for spec, r, ms in pairs:
            by_op.setdefault(spec.op, []).append(ms)
        rtt = {op: {"n": len(v), "p50": float(np.percentile(v, 50)),
                    "p99": float(np.percentile(v, 99))}
               for op, v in sorted(by_op.items())}
        every = [ms for _, _, ms in pairs]
        return {"submitted": len(res), "served": served, "shed": shed,
                "req_s": served / secs, "seconds": secs,
                "rtt_ms": {"p50": float(np.percentile(every, 50)),
                           "p99": float(np.percentile(every, 99))},
                "rtt_ms_by_op": rtt,
                "replicas_seen": sorted({getattr(r, "replica", None)
                                         for r in res} - {None})}

    def hold_bitwise(label, pairs):
        n = 0
        for i, (spec, r, _) in enumerate(pairs):
            if r.status == OK:
                bitwise(f"{label} request {i} ({spec.op}, {r.rung})",
                        r.value, serial_solve(spec.op, spec.payload,
                                              r.rung, dev))
                n += 1
        return n

    class MemPoll(threading.Thread):
        """The card's used memory, every process's (``mem_get_info``),
        sampled every 0.25 s.  A replica's own share is not separable:
        ``nvidia-smi`` in the card's container names one pid for all."""

        def __init__(self):
            super().__init__(daemon=True)
            self.halt = threading.Event()
            self.card_peak = 0

        def run(self):
            while not self.halt.wait(0.25):
                free, tot = torch.cuda.mem_get_info(dev)
                self.card_peak = max(self.card_peak, tot - free)

    # ---------------------------------- (a) two replicas, no fault
    specs = loadgen.build_mix(SERVE_MIX, SERVE_REQUESTS, seed=0)
    torch.cuda.synchronize()
    free0, _ = torch.cuda.mem_get_info(dev)
    proc, addr, env, up_s = fleet_up(
        "a", ["--replicas", str(FLEET_REPLICAS), "--mix", SERVE_MIX])
    print(f"fleet up --replicas {FLEET_REPLICAS} on cuda: listening on "
          f"{addr} after {up_s:.2f} s (each replica with "
          f"CME213_MEMORY_BUDGET={budget} B of the card's {total})")
    poll = MemPoll()
    poll.start()
    cli = {}
    for mode in ("closed", "open"):
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "cme213_tpu_torch", "serve", "loadgen",
             "--transport", addr, "--mix", SERVE_MIX, "--requests",
             str(SERVE_REQUESTS), "--mode", mode, "--json"],
            cwd=f_dir, env=base_env, capture_output=True, text=True,
            timeout=300)
        if out.returncode != 0:
            fail(f"serve loadgen --transport {mode}: rc {out.returncode}"
                 f"\n{out.stderr[-3000:]}")
        rep = json.loads(out.stdout)
        secs = time.perf_counter() - t0
        if rep["failed"] or rep["served"] + rep["shed"] != SERVE_REQUESTS:
            fail(f"loadgen --transport {mode}: {rep['served']} served, "
                 f"{rep['shed']} shed, {rep['failed']} failed")
        cli[mode] = {"throughput_rps": rep["throughput_rps"],
                     "latency_ms": rep["latency_ms"],
                     "served": rep["served"], "shed": rep["shed"],
                     "fleet": rep.get("fleet"), "child_s": secs}
        print(f"serve loadgen --transport (fleet, {mode}, {secs:.1f} s "
              f"with the child's start): {rep['throughput_rps']} req/s, "
              f"latency p50/p99 {rep['latency_ms']['p50']}/"
              f"{rep['latency_ms']['p99']} ms, {rep['served']} served, "
              f"{rep['shed']} shed")
    runs = {}
    for mode in ("closed", "open"):
        pairs, secs = counted(f"fleet a drive {mode}", none,
                              lambda: drive(addr, specs, mode))
        runs[mode] = (pairs, summarise(pairs, secs))
    poll.halt.set()
    poll.join()
    st_a = fleet_down("a", proc)
    mem = {"card_peak_bytes": poll.card_peak,
           "card_used_before_bytes": int(total - free0),
           "replicas_together_bytes": int(poll.card_peak - (total - free0))}
    held = sum(hold_bitwise(f"fleet a {mode}", runs[mode][0])
               for mode in runs)
    rows["a"] = {"up_s": up_s, "cli": cli,
                 **{mode: runs[mode][1] for mode in runs},
                 "bitwise_held": held, "memory": mem,
                 "routing": {k: st_a.get(k) for k in (
                     "requeues", "replicas", "replicas_up")}}
    for mode in runs:
        r = runs[mode][1]
        print(f"fleet (a) {mode}: {r['served']}/{r['submitted']} served "
              f"by replicas {r['replicas_seen']}, {r['req_s']:.1f} req/s, "
              f"rtt p50/p99 {r['rtt_ms']['p50']:.3f}/"
              f"{r['rtt_ms']['p99']:.3f} ms; by op "
              + ", ".join(f"{op} {v['p50']:.3f}/{v['p99']:.3f}"
                          for op, v in r["rtt_ms_by_op"].items()))
    print(f"fleet (a): {held} served results, each bit for bit its "
          f"serial solve on the card; the card's used memory peaked at "
          f"{poll.card_peak} B, the replicas together "
          f"{mem['replicas_together_bytes']} B over this process's "
          f"(a budget of {budget} B each)")

    # ---------------------------------- (b) the same under replica-kill
    proc, addr, env, up_s = fleet_up(
        "b", ["--replicas", str(FLEET_REPLICAS), "--mix", SERVE_MIX],
        faults="replica-kill:1:2")
    pairs, secs = counted("fleet b drive closed (replica-kill:1:2)", none,
                          lambda: drive(addr, specs, "closed"))
    run_b = summarise(pairs, secs)
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        st = stats(addr)
        r1 = st["replicas"].get("r1", {})
        if r1.get("incarnation") == 1 and r1.get("up"):
            break
        time.sleep(0.1)
    else:
        fail(f"fleet b: replica 1 not relaunched: {st}")
    st_b = fleet_down("b", proc)
    held_b = hold_bitwise("fleet b", pairs)
    dumps = sorted(glob.glob(os.path.join(env["CME213_FLIGHT_DIR"],
                                          "flight-*.json")))
    kills = [json.load(open(p)) for p in dumps]
    kills = [d for d in kills if d.get("reason") == "replica-kill"]
    ups = [e for e in _sink_events(os.path.join(f_dir, "b-1.jsonl"),
                                   "replica-up")
           if e.get("incarnation") == 1]
    if not kills or not ups:
        fail(f"fleet b: kill dumps {len(kills)}, relaunch events {ups}")
    relaunch_s = ups[0]["t"] - kills[0]["t"]
    rows["b"] = dict(run_b, bitwise_held=held_b,
                     requeues=st_b["requeues"],
                     flight_confirmed=st_b["flight_confirmed"],
                     kill_to_relaunched_ready_s=relaunch_s,
                     p99_rtt_ms_with_kill=run_b["rtt_ms"]["p99"],
                     p99_rtt_ms_without=rows["a"]["closed"]["rtt_ms"]["p99"])
    if st_b["requeues"] < 1 or run_b["submitted"] - run_b["shed"] != \
            run_b["served"]:
        fail(f"fleet b: {rows['b']}")
    print(f"fleet (b) replica-kill:1:2: {run_b['submitted']} submitted - "
          f"{run_b['shed']} shed == {run_b['served']} served (zero loss), "
          f"{held_b} bit for bit; {st_b['requeues']} requeued, "
          f"{st_b['flight_confirmed']} confirmed in flight by the dump; "
          f"kill -> relaunched replica ready for its ping "
          f"{relaunch_s:.3f} s; p99 rtt {run_b['rtt_ms']['p99']:.3f} ms "
          f"with the kill against {rows['b']['p99_rtt_ms_without']:.3f}")

    # ---------------------------------- (c) autoscaling on a burning SLO
    proc, addr, env, up_s = fleet_up(
        "c", ["--replicas", str(FLEET_REPLICAS), "--mix", "cipher",
              "--warm-requests", "2", "--autoscale", "--min-replicas",
              str(FLEET_REPLICAS), "--max-replicas",
              str(FLEET_MAX_REPLICAS), "--slo-p99-ms", "0.001"])
    load_stop = threading.Event()
    burst = loadgen.build_mix("cipher", 8, seed=4)

    def burn():
        with TransportClient(addr, timeout_s=60.0) as c:
            while not load_stop.is_set():
                for spec in burst:
                    c.solve(spec.op, spec.payload, tenant=spec.tenant)

    loaders = [threading.Thread(target=burn) for _ in range(4)]
    t0 = time.perf_counter()
    for t in loaders:
        t.start()
    peak_n = FLEET_REPLICAS
    while time.perf_counter() - t0 < 90:
        st = stats(addr)
        live = [s for s in st["replica_states"].values()
                if s in ("up", "starting")]
        peak_n = max(peak_n, len(live))
        if st["scale_ups"] >= 1:
            break
        time.sleep(0.1)
    up_after = time.perf_counter() - t0
    load_stop.set()
    for t in loaders:
        t.join(60)
    t1 = time.perf_counter()
    while time.perf_counter() - t1 < 90:
        st = stats(addr)
        live = [s for s in st["replica_states"].values()
                if s in ("up", "starting")]
        peak_n = max(peak_n, len(live))
        if st["scale_downs"] >= 1:
            break
        time.sleep(0.1)
    down_after = time.perf_counter() - t1
    st_c = fleet_down("c", proc)
    scale = [(e["event"], e["t"], e.get("replicas")) for e in
             _sink_events(os.path.join(f_dir, "c-main.jsonl"), "scale-up")
             + _sink_events(os.path.join(f_dir, "c-main.jsonl"),
                            "scale-down")]
    rows["c"] = {"scale_ups": st_c["scale_ups"],
                 "scale_downs": st_c["scale_downs"],
                 "load_to_scale_up_s": up_after,
                 "load_stop_to_scale_down_s": down_after,
                 "peak_replicas": peak_n, "events": sorted(
                     scale, key=lambda e: e[1])}
    if st_c["scale_ups"] < 1 or st_c["scale_downs"] < 1 or \
            peak_n != FLEET_MAX_REPLICAS:
        fail(f"fleet c: {rows['c']}")
    print(f"fleet (c) --autoscale --slo-p99-ms 0.001: scaled up to "
          f"{peak_n} replicas {up_after:.2f} s after the load began, down "
          f"to {FLEET_REPLICAS} {down_after:.2f} s after it stopped "
          f"(+{st_c['scale_ups']}/-{st_c['scale_downs']})")

    # ---------------------------------- (d) a durable job, owner killed
    j_dir = os.path.join(f_dir, "jobs")
    graph = pagerank.build_graph(FLEET_JOB["nodes"], FLEET_JOB["avg_edges"],
                                 FLEET_JOB["seed"])
    want = golden.host_graph_iterate(graph.indices, graph.edges,
                                     graph.rank0, graph.inv_deg,
                                     FLEET_JOB["iters"])
    proc, addr, env, up_s = fleet_up(
        "d", ["--replicas", "1", "--mix", "cipher", "--warm-requests", "2",
              "--jobs-dir", j_dir], faults="replica-kill:0:1")
    jargs = ["--addr", addr, "--job", "pr-fleet"]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = fleet_cli.main(["jobs", "submit", *jargs, "--json", *(
            f"--param={k}={v}" for k, v in FLEET_JOB.items())])
    if rc != 0:
        fail(f"fleet jobs submit: rc {rc} {buf.getvalue()}")
    while True:
        with TransportClient(addr, timeout_s=30.0) as c:
            job = c.control("job-status", job="pr-fleet")["job"]
        if job["state"] in ("DONE", "FAILED", "STALLED"):
            fail(f"fleet d: the job ended before the kill: {job}")
        if (job["epoch"] or 0) >= 2:
            break
        if time.perf_counter() - t0 > 120:
            fail(f"fleet d: the job did not start: {job}")
        time.sleep(0.02)
    killed_at = job["epoch"]
    # interactive traffic: the replica's first batch fires the kill; the
    # front end requeues it to the relaunched incarnation
    pairs, _ = drive(addr, loadgen.build_mix("cipher", 4, seed=5),
                     "closed", concurrency=1)
    for _, r, _ in pairs:
        if r.status != OK:
            fail(f"fleet d: interactive request {r.status} {r.reason}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fleet_cli.main(["jobs", "wait", *jargs, "--wait-s", "180",
                             "--json"])
    done_s = time.perf_counter() - t0
    done = json.loads(buf.getvalue())["job"]
    out_npy = os.path.join(f_dir, "pr-fleet.npy")
    with contextlib.redirect_stdout(io.StringIO()):
        rc_r = fleet_cli.main(["jobs", "result", *jargs, "--out", out_npy])
    st_d = fleet_down("d", proc)
    if rc != 0 or rc_r != 0 or done["state"] != "DONE":
        fail(f"fleet d: {done}")
    bitwise("fleet d job vs host_graph_iterate", np.load(out_npy), want)
    epochs = [e["epoch"] for e in _sink_events(
        os.path.join(f_dir, "d-0.jsonl"), "job-epoch")]
    resumed = _sink_events(os.path.join(f_dir, "d-0.jsonl"), "job-resumed")
    if epochs != list(range(1, done["total_epochs"] + 1)) or not resumed:
        fail(f"fleet d: epochs {epochs}, resumed {resumed}")
    rows["d"] = {"killed_at_epoch": killed_at, "state": done["state"],
                 "resumes": done["resumes"],
                 "resumed_by": [(e.get("source"), e.get("epoch"))
                                for e in resumed],
                 "epochs_once_each": True, "submit_to_done_s": done_s,
                 "incarnation": st_d["replicas"]["r0"]["incarnation"],
                 "bitwise_golden": True}
    print(f"fleet (d) PageRank job {FLEET_JOB['nodes']} nodes x "
          f"{FLEET_JOB['iters']} iterations, epochs of "
          f"{FLEET_JOB['epoch']}: owner killed after epoch {killed_at}, "
          f"resumed by incarnation {rows['d']['incarnation']} "
          f"({rows['d']['resumed_by']}), DONE {done_s:.2f} s after "
          f"submit, each of {done['total_epochs']} epochs run once, "
          f"bitwise the golden")

    # ---------------------------------- (e) chaos on the fleet
    def chaos_cli(label, args, expect_rc=0, timeout=600):
        env = dict(base_env)
        env[trace.TRACE_FILE_ENV] = os.path.join(f_dir, f"{label}.jsonl")
        sinks.append(env[trace.TRACE_FILE_ENV])
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "cme213_tpu_torch", "chaos", *args],
            cwd=f_dir, env=env, capture_output=True, text=True,
            timeout=timeout)
        secs = time.perf_counter() - t0
        try:
            doc = json.loads(out.stdout)
        except ValueError:
            doc = None
        if out.returncode != expect_rc or doc is None:
            fail(f"chaos {label}: rc {out.returncode} (want {expect_rc})\n"
                 f"{out.stdout[-2000:]}\n{out.stderr[-3000:]}")
        return doc, secs

    bank = os.path.join(f_dir, "bank")
    game, secs = chaos_cli("run", ["run", *FLEET_CHAOS, "--device", "cuda",
                                   "--bank-dir", bank, "--json"])
    per_min = len(game["campaigns"]) / secs * 60
    cocktails = [c["cocktail"] for c in game["campaigns"]]
    print(f"chaos run {' '.join(FLEET_CHAOS)} --device cuda: exit 0 in "
          f"{secs:.1f} s, {per_min:.2f} campaigns a minute; cocktails:")
    for c in game["campaigns"]:
        print(f"  {c['campaign']}: {c['cocktail']} ({c['elapsed_s']} s, "
              f"served {c['report'].get('served')})")
    drill, d_secs = chaos_cli("drill", ["run", *FLEET_DRILL, "--device",
                                        "cuda", "--bank-dir", bank,
                                        "--json"], expect_rc=1)
    if not drill["fixtures"] or drill["ok"]:
        fail(f"chaos drill did not violate and bank: {drill}")
    minimal = json.load(open(drill["fixtures"][0]))["minimal_cocktail"]
    # the repository's four banked fixtures (read only) and the drill's
    repo_fixtures = sorted(glob.glob(os.path.join(chaos.fixtures_dir(),
                                                  "*.json")))
    replay, r_secs = chaos_cli("replay", [
        "replay", *repo_fixtures, *drill["fixtures"], "--device", "cuda",
        "--json"])
    rows["e"] = {"campaigns": len(game["campaigns"]), "seconds": secs,
                 "campaigns_per_minute": per_min, "cocktails": cocktails,
                 "replayed": [(d["fixture"], d["observed"])
                              for d in replay["fixtures"]],
                 "replay_s": r_secs, "drill": {
                     "cocktail": drill["campaigns"][0]["cocktail"],
                     "violated": sorted({v["invariant"] for v in
                                         drill["campaigns"][0][
                                             "violations"]}),
                     "minimal": minimal, "seconds": d_secs,
                     "replay_match": replay["ok"]}}
    print(f"chaos drill {' '.join(FLEET_DRILL)}: violated "
          f"{rows['e']['drill']['violated']}, shrunk to {minimal!r} and "
          f"banked in {d_secs:.1f} s")
    print(f"chaos replay of the {len(repo_fixtures)} banked fixtures and "
          f"the drill's on cuda: every one matched its expect "
          f"({r_secs:.1f} s)")

    # ---------------------------------- (f) leaks and launches
    deadline = time.monotonic() + 15
    while _fleet_workers() and time.monotonic() < deadline:
        time.sleep(0.1)
    left = _fleet_workers()
    leaked = sorted(chaos._shm_segments() - shm_before)
    files = sorted({p for t in sinks for p in glob.glob(
        t.replace("{rank}", "*"))} | set(glob.glob(os.path.join(
            f_dir, "chaos-*", "trace-r*.jsonl"))))
    launches = _sink_launches(files)
    paths["fleet (every replica, campaign and drill)"] = dict(
        none, **launches)
    rows["f"] = {"replica_processes_left": left, "shm_leaked": leaked,
                 "sinks_read": len(files), "kernel_launches": launches}
    print(f"fleet (f): replica processes left {left}, psm_ segments "
          f"leaked {leaked}, hand-written kernel launches {launches or 0} "
          f"over {len(files)} sinks")
    for pid in left:
        print(f"  left: {_process_note(pid)}")
    if left or leaked or any(launches.values()):
        fail(f"fleet f: {rows['f']}")
    rows["seconds"] = time.perf_counter() - t_phase
    print(f"phase 32 (fleet): {rows['seconds']:.1f} s")
    return rows


#: phase 33: the cards it needs, and its headline-sized grid (8000²
#: order 8: a 4000² block a card)
MULTICARD = 4
BIG_N, BIG_ITERS = 8000, 200


def multicard_phase(counted, only, paths, work, ident, pwtk, pwtk_ref64):
    """Phase 33: hw5 and the sharded SpMV-scan on four cards, one shard set
    a card (see the module's docstring).  ``counted``, ``only`` and
    ``paths`` are ``main``'s launch-count helpers and table; ``pwtk`` and
    ``pwtk_ref64`` phase 8's problem and f64 plain solve.  Returns the
    numbers for the ``multicard`` line."""
    import numpy as np
    import torch

    from cme213_tpu_torch import config, core, dist, grid, ops
    from cme213_tpu_torch.apps import spmv_scan as spmv
    from cme213_tpu_torch.dist import heat as dheat
    from cme213_tpu_torch.ops import stencil_pipeline as sp
    from cme213_tpu_torch.verify.checkers import (relative_l2_error,
                                                  relative_linf_error)

    t_phase = time.perf_counter()
    cards = [torch.device("cuda", i) for i in range(MULTICARD)]
    vdev = core.virtual_devices(MULTICARD)  # four shards of cuda:0
    rows = {"cards": [torch.cuda.get_device_name(d) for d in cards],
            "card": ident}
    core.conformance.reset()  # every gate below probes on first use
    gated = set()

    def probe(mesh, k, order):
        """The gate's probe launches a card of the first pallas use of
        (mesh shape, k, order) in this process."""
        key = (mesh.devices.shape, k, order)
        if key in gated:
            return 0
        gated.add(key)
        return DIST_PROBE_LAUNCHES

    def per_card(label, run, expect):
        """``run`` with B3's per-card counts zeroed just before it; fails
        unless each card launched ``expect`` times (0: none at all)."""
        sp.LOCAL_LAUNCHES.clear()
        out = counted(label, None, run)
        seen = dict(sp.LOCAL_LAUNCHES)
        want = {str(d): expect for d in cards} if expect else {}
        print(f"B3 launches a card, {label}: {seen}")
        if seen != want:
            fail(f"{label}: B3 launches a card {seen}, expected {want}")
        return out, seen

    def sync_all():
        for d in cards:
            torch.cuda.synchronize(d)

    def exchange_ms(p, mesh, K, reps=50):
        """One halo exchange of ``mesh``'s blocks (``border`` K), alone:
        ms, the cards synchronised around the loop."""
        y, x, ny_loc, nx_loc = dheat._mesh_layout(p, mesh)
        u0 = torch.from_numpy(dheat._pad_interior_for_mesh(
            grid.interior(grid.make_initial_grid(p, device="cpu"),
                          p.border_size).numpy(), p, y, x))
        blocks = dheat._scatter(u0, dheat._shard_devices(mesh, y, x),
                                ny_loc, nx_loc)
        dheat._assemble_padded(blocks, p, border=K)
        sync_all()
        t0 = time.perf_counter()
        for _ in range(reps):
            dheat._assemble_padded(blocks, p, border=K)
        sync_all()
        return (time.perf_counter() - t0) * 1e3 / reps

    # (a) one process, a mesh over the four cards, each run held bit for
    # bit to the same run on four shards of cuda:0
    base = dict(nx=DIST_N, ny=DIST_N, order=8, iters=DIST_ITERS)
    method = {"1d": config.GridMethod.STRIPES_1D,
              "2d": config.GridMethod.BLOCKS_2D}
    ref = ops.run_heat(grid.make_initial_grid(
        config.SimParams(**base), device=cards[0]), DIST_ITERS, 8,
        config.SimParams(**base).xcfl, config.SimParams(**base).ycfl
    ).cpu().numpy()
    runs = [("1d", True, "xla", 1), ("1d", False, "xla", 1),
            ("2d", True, "xla", 1), ("2d", False, "xla", 1),
            ("1d", True, "pallas", 1), ("2d", True, "pallas", 1),
            ("2d", True, "xla", 2), ("2d", True, "xla", 4),
            ("2d", True, "pallas", 2), ("2d", True, "pallas", 4)]
    one_process = {}
    rows["a"] = {}
    for dim, sync, kernel, k in runs:
        p = config.SimParams(**base, grid_method=method[dim],
                             synchronous=sync)
        label = (f"{DIST_N}x{DIST_N} {dim} {'sync' if sync else 'async'} "
                 f"{kernel} k={k}")
        mesh4 = dist.mesh_for_method(p.grid_method, devices=cards)
        meshv = dist.mesh_for_method(p.grid_method, devices=vdev)
        kw = dict(steps_per_exchange=k, local_kernel=kernel)
        expect = (DIST_ITERS // k + probe(mesh4, k, p.order)
                  if kernel == "pallas" else 0)
        got, seen = per_card(f"run_distributed_heat {label} on 4 cards",
                             lambda: dist.run_distributed_heat(p, mesh4,
                                                               **kw), expect)
        want = dist.run_distributed_heat(p, meshv, **kw)
        bitwise(f"phase 33 (a) {label}: 4 cards vs 4 shards of cuda:0",
                got, want)
        one_process[(dim, kernel, k, sync)] = got
        ulp = int(core.ulp_distance(got, ref).max())
        times = {}
        for where, mesh in (("cards", mesh4), ("one_card", meshv)):
            iterate, _, k_used = dist.prepare_distributed_heat(p, mesh, **kw)
            if k_used != k:
                fail(f"phase 33 (a) {label}: ran k={k_used}")
            seconds, _ = iterate()
            times[where] = seconds * 1e3 / DIST_ITERS
        K = k * p.border_size
        ex = exchange_ms(p, mesh4, K)
        rows["a"][label] = {
            "ms_per_step": times["cards"],
            "ms_per_step_4_shards_one_card": times["one_card"],
            "exchange_ms": ex, "exchange_share": ex / (k * times["cards"]),
            "b3_launches": seen, "max_ulp_vs_run_heat": ulp}
        print(f"phase 33 (a) {label}: {times['cards']:.6f} ms/step on 4 "
              f"cards ({times['one_card']:.6f} on 4 shards of cuda:0); one "
              f"exchange alone {ex:.6f} ms ({ex / (k * times['cards']):.1%} "
              f"of its {k} step(s)); bit for bit the one-card mesh; vs "
              f"run_heat max ULP {ulp}")
    # 8000² order 8: a 4000² block a card, against run_heat on one card
    pb = config.SimParams(nx=BIG_N, ny=BIG_N, order=8, iters=BIG_ITERS,
                          grid_method=config.GridMethod.BLOCKS_2D)
    mesh4 = dist.mesh_for_method(pb.grid_method, devices=cards)
    label = f"run_distributed_heat {BIG_N}x{BIG_N} 2d sync pallas k=1"
    got, seen = per_card(f"{label} on 4 cards",
                         lambda: dist.run_distributed_heat(
                             pb, mesh4, local_kernel="pallas"),
                         BIG_ITERS + probe(mesh4, 1, pb.order))
    u = grid.make_initial_grid(pb, device=cards[0])
    want = ops.run_heat(u, BIG_ITERS, pb.order, pb.xcfl, pb.ycfl)
    bitwise(f"phase 33 (a) {label} vs run_heat on cuda:0", got,
            want.cpu().numpy())
    iterate, _, _ = dist.prepare_distributed_heat(pb, mesh4,
                                                  local_kernel="pallas")
    seconds, _ = iterate()
    args = (BIG_ITERS, pb.order, pb.xcfl, pb.ycfl, pb.bc)
    b1_ms = core.time_fn(lambda v: ops.run_heat_pipeline(v, *args, k=1), u,
                         warmup=1, iters=2) / BIG_ITERS
    ex = exchange_ms(pb, mesh4, pb.border_size)
    step = core.roofline.heat_cost(BIG_N, BIG_N, order=8, iters=1)
    big = {"ms_per_step": seconds * 1e3 / BIG_ITERS,
           "b1_one_card_ms_per_step": b1_ms, "exchange_ms": ex,
           "b3_launches": seen}
    big["gbs"] = step.gbs(big["ms_per_step"])
    big["speedup_over_one_card_b1"] = b1_ms / big["ms_per_step"]
    rows["a"][f"{BIG_N}x{BIG_N} 2d sync pallas k=1"] = big
    print(f"phase 33 (a) {label}: {big['ms_per_step']:.6f} ms/step on 4 "
          f"cards ({big['gbs']:.1f} GB/s over the grid), B1 on one card "
          f"{b1_ms:.6f} ms/step ({big['speedup_over_one_card_b1']:.2f}x); "
          f"one exchange alone {ex:.6f} ms; bit for bit run_heat")
    del got, want, u

    # (b) the sharded SpMV-scan at pwtk over the four cards
    timers = {}
    out = {}
    for where, devices in (("cards", cards), ("one_card", vdev)):
        timers[where] = core.PhaseTimer()
        out[where] = counted(
            f"run_spmv_scan_distributed {SUITE} on {where}", only(None, 0),
            lambda devices=devices, where=where:
            spmv.run_spmv_scan_distributed(
                pwtk, dist.make_mesh_1d(MULTICARD, devices=devices),
                timer=timers[where]))
    bitwise("phase 33 (b) pwtk: 4 cards vs 4 shards of cuda:0",
            out["cards"], out["one_card"])
    rel_l2 = relative_l2_error(pwtk_ref64, out["cards"])
    rel_linf = relative_linf_error(pwtk_ref64, out["cards"])
    tol_l2, tol_linf = PWTK_TOL["auto"]
    if not (rel_l2 <= tol_l2 and rel_linf <= tol_linf):
        fail(f"phase 33 (b): rel L2 {rel_l2:.3e} / rel Linf {rel_linf:.3e}")
    rows["b"] = {w: timers[w].last_ms("spmv_scan_distributed") / pwtk.iters
                 for w in timers}
    rows["b"].update(rel_l2=rel_l2, rel_linf=rel_linf)
    print(f"phase 33 (b) {SUITE} sharded over 4 cards: {rows['b']['cards']:.6f}"
          f" ms/iter ({rows['b']['one_card']:.6f} on 4 shards of cuda:0); "
          f"bit for bit; vs f64 plain rel L2 {rel_l2:.3e}")

    # (c) python -m cme213_tpu_torch.dist.launch --np 4, one rank a card
    gangs = Gangs(tempfile.mkdtemp(prefix="multicard-", dir=work))
    params = {}
    for dim in ("2d", "1d"):
        params[dim] = os.path.join(gangs.root, f"params-{dim}.in")
        config.SimParams(**base, grid_method=method[dim]).to_file(
            params[dim], distributed=True)
    four = ["--np", str(MULTICARD)]
    rows["c"] = {}
    # auto: each rank takes the backend of its layout, a card a rank
    for tag, dim, asked, backend in (("c-nccl-2d", "2d", "auto", "nccl"),
                                     ("c-nccl-1d", "1d", "auto", "nccl"),
                                     ("c-gloo-2d", "2d", "gloo", "gloo")):
        out_c, secs = gangs.run(tag, [*four, "--backend", asked],
                                ["heat2d", params[dim], "--distributed",
                                 "--local-kernel=pallas"])
        if out_c.count(f"torch.distributed backend {backend}") != MULTICARD:
            fail(f"gang {tag}: not every rank named {backend}")
        ranks = {}
        for rank in range(MULTICARD):
            bitwise(f"gang {tag} rank {rank} vs the one-process 4-card run",
                    gangs.grid(tag, rank, 0),
                    one_process[(dim, "pallas", 1, True)])
            snap = gangs.snapshot(tag, rank)
            n = snap["counters"].get("kernel.launches.local", 0)
            if n != DIST_ITERS + DIST_PROBE_LAUNCHES:
                fail(f"gang {tag} rank {rank}: {n} B3 launches, expected "
                     f"{DIST_ITERS + DIST_PROBE_LAUNCHES}")
            solve = snap["gauges"]["dist_heat.solve_s"]
            exchange = snap["gauges"]["dist_heat.exchange_s"]
            ranks[rank] = {"b3_launches": n, "solve_s": solve,
                           "exchange_s": exchange,
                           "exchange_share": exchange / solve}
        (span,) = gangs.events(tag, "main", "span-begin",
                               span="gang-launch")
        if span.get("backend") != backend:
            fail(f"gang {tag}: the gang-launch span names "
                 f"{span.get('backend')}, not {backend}")
        rows["c"][tag] = {"backend": backend, "launcher_s": secs,
                          "ranks": ranks}
        label = f"gang {tag}: 4 ranks, heat2d CLI {DIST_N}x{DIST_N} pallas"
        paths[label] = only("local", sum(r["b3_launches"]
                                         for r in ranks.values()))
        print(f"launches of {label}: {paths[label]}")
        print(f"phase 33 (c) {tag}: solve_s "
              f"{[round(r['solve_s'], 6) for r in ranks.values()]}, "
              f"exchange_s {[round(r['exchange_s'], 6) for r in ranks.values()]}"
              f"; bit for bit the one-process 4-card run on every rank")

    # (d) the supervised NCCL gang: heat under rankkill:1:1, pwtk
    # uninterrupted and under rankkill:0:2
    ckpt = os.path.join(gangs.root, "ckpt")
    out_d, secs = gangs.run("d", [*four, "--stall-timeout", "60",
                                  "--max-restarts", "1", "--ckpt-dir", ckpt,
                                  "--ckpt-every", "250"],
                            ["heat2d", params["2d"], "--distributed",
                             "--supervised"], faults="rankkill:1:1")
    for needle in ("injected kill: rank 1 at step 1", "condemning the gang",
                   "gang restart (incarnation 1/1)"):
        if needle not in out_d:
            fail(f"gang d: no {needle!r} in its output")
    if out_d.count("torch.distributed backend nccl") != 2 * MULTICARD:
        fail("gang d: not every rank of both incarnations named nccl")
    for rank in range(MULTICARD):
        bitwise(f"gang d rank {rank} vs run_heat", gangs.grid("d", rank, 1),
                ref)
    (kill,) = gangs.events("d", 1, "fault-injected", kind="rankkill")
    (verdict,) = gangs.events("d", "main", "rank-failed")
    resumed = min(r["t"] for rank in range(MULTICARD)
                  for r in gangs.events("d", rank, "heartbeat",
                                        incarnation=1))
    rows["d"] = {"launcher_s": secs,
                 "kill_to_verdict_s": verdict["t"] - kill["t"],
                 "kill_to_resumed_beat_s": resumed - kill["t"],
                 "startup_s": [gangs.startup("d", inc, range(MULTICARD))
                               for inc in (0, 1)]}
    print(f"phase 33 (d) heat: {json.dumps(rows['d'])}")
    npz = os.path.join(gangs.root, "pwtk.npz")
    np.savez(npz, a=pwtk.a, s=pwtk.s, k=pwtk.k, x=pwtk.x, iters=pwtk.iters)
    solves = {}
    for tag, faults, restarts in (("e0", None, "0"),
                                  ("e1", "rankkill:0:2", "1")):
        out_e, secs = gangs.run(tag, [*four, "--stall-timeout", "120",
                                      "--max-restarts", restarts,
                                      "--ckpt-dir",
                                      os.path.join(gangs.root, f"ck-{tag}"),
                                      "--ckpt-every", "5"], ["spmv", npz],
                                faults=faults)
        inc = 1 if faults else 0
        res = [gangs.grid(tag, rank, inc) for rank in range(MULTICARD)]
        for rank in range(1, MULTICARD):
            bitwise(f"gang {tag} rank {rank} vs rank 0", res[rank], res[0])
        solves[tag] = (res[0], secs, inc)
        if faults and "condemning the gang" not in out_e:
            fail(f"gang {tag}: no gang verdict")
    bitwise("gang e1 vs the uninterrupted gang", solves["e1"][0],
            solves["e0"][0])
    (kill,) = gangs.events("e1", 0, "fault-injected", kind="rankkill")
    (verdict,) = gangs.events("e1", "main", "rank-failed")
    rows["d"]["spmv"] = {
        "launcher_s": [solves["e0"][1], solves["e1"][1]],
        "kill_to_verdict_s": verdict["t"] - kill["t"],
        "startup_s": [gangs.startup("e1", inc, range(MULTICARD))
                      for inc in (0, 1)],
        "equals_one_process_4_cards": bool(np.array_equal(
            solves["e0"][0].view(np.uint8), out["cards"].view(np.uint8)))}
    print(f"phase 33 (d) pwtk: {json.dumps(rows['d']['spmv'])}")
    rows["seconds"] = time.perf_counter() - t_phase
    print(f"phase 33: {rows['seconds']:.1f} s")
    return rows


def flight_child(kind: str, keep: str) -> dict:
    """Phase 27: a child that dies of a non-finite chunk under the flight
    recorder; its abort dump is copied into ``keep`` (phase 28 reads it).
    Returns ``{"flight_dump": path, "flight": {...}}``."""
    rows = {}
    child = (
        "import json, os, sys\n"
        f"sys.path.insert(0, {HERE!r})\n"
        "import torch\n"
        "from cme213_tpu_torch.apps import heat2d\n"
        "from cme213_tpu_torch.config import SimParams\n"
        "from cme213_tpu_torch.core import flight\n"
        "start = torch.cuda.is_initialized()\n"
        "flight.install_from_env()\n"
        "flight.dump('probe')\n"
        "print(json.dumps({'cuda_at_start': start,\n"
        "                  'cuda_after_probe': torch.cuda.is_initialized()}),\n"
        "      flush=True)\n"
        f"p = SimParams(nx={FULL_N}, ny={FULL_N}, order={FULL_ORDER}, "
        f"iters={2 * RUNNER_EVERY})\n"
        "heat2d.run_heat_checkpointed(p, sys.argv[1], "
        f"every={RUNNER_EVERY}, max_retries=1, device='cuda')\n")
    with tempfile.TemporaryDirectory() as fdir:
        env = dict(os.environ, CME213_FLIGHT_DIR=fdir,
                   CME213_FAULTS="nan:heat2d:1,nan:heat2d:2")
        env.pop("CME213_TRACE_FILE", None)
        proc = subprocess.Popen(
            [sys.executable, "-c", child, os.path.join(fdir, "h.npz")],
            cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, start_new_session=True)
        try:
            stdout, stderr = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            fail("flight child: no result in 300 s")
        state = json.loads(stdout.strip().splitlines()[0])
        docs = {}
        for name in sorted(os.listdir(fdir)):
            if name.startswith("flight-") and name.endswith(".json"):
                with open(os.path.join(fdir, name)) as f:
                    doc = json.load(f)
                docs[doc["reason"]] = doc
                if doc["reason"] == "numeric-abort":
                    rows["flight_dump"] = shutil.copy(
                        os.path.join(fdir, name), keep)
    summary = {r: {"card": d["platform"].get("card"),
                   "open_spans": [s["span"] for s in d["open_spans"]]}
               for r, d in docs.items()}
    print(f"flight child: rc {proc.returncode}, CUDA at start "
          f"{state['cuda_at_start']}, after a dump {state['cuda_after_probe']};"
          f" dumps {json.dumps(summary)}")
    abort = docs.get("numeric-abort")
    if proc.returncode == 0 or "NonFiniteError" not in stderr:
        fail(f"flight child did not die of NonFiniteError: rc "
             f"{proc.returncode}\n{stderr[-2000:]}")
    if state["cuda_at_start"] or state["cuda_after_probe"]:
        fail(f"flight child: CUDA initialised before its solve: {state}")
    if set(docs) != {"probe", "numeric-abort", "unhandled-exception"}:
        fail(f"flight dumps {sorted(docs)}")
    if docs["probe"]["platform"].get("card") is not None:
        fail("a dump before any CUDA work named the card")
    if any(docs[r]["platform"].get("card") != kind
           for r in ("numeric-abort", "unhandled-exception")):
        fail(f"flight dumps do not name the card {kind!r}: {summary}")
    if "checkpoint.chunk" not in summary["numeric-abort"]["open_spans"] \
            or "NonFiniteError" not in (abort["traceback"] or ""):
        fail(f"the abort's dump: {summary['numeric-abort']}")
    rows["flight"] = {"rc": proc.returncode, "dumps": summary}
    return rows


#: the groups of phases ``--only`` selects, in the order a run takes them
GROUPS = {"kernels": range(1, 17), "guarded": range(17, 28),
          "tooling": range(28, 30), "gang": range(30, 31),
          "serving": range(31, 32), "fleet": range(32, 33),
          "multicard": range(33, 34)}
#: what a group takes from phases 1-16, made for it when they do not run:
#: pwtk and its f64 plain solve (phase 8), phase 10's hw5 set-up, B1's
#: 4000² time (phase 4), the headline lines (16), the sweeps' CSVs (14)
NEEDS = {"kernels": set(), "guarded": {"pwtk", "dist", "b1"},
         "tooling": {"pwtk", "headline", "sweeps"},
         "gang": {"pwtk", "dist"}, "serving": {"pwtk"}, "fleet": set(),
         "multicard": {"pwtk"}}
#: host-clock seconds of each phase that ran, in order ("set-up": what a
#: group run alone makes for itself)
PHASE_SECONDS: dict[str, float] = {}
_OPEN_PHASE: list = []


def phase(n) -> None:
    """Stop the clock of the open phase and start phase ``n``'s (``None``:
    stop only)."""
    now = time.perf_counter()
    if _OPEN_PHASE:
        name, t0 = _OPEN_PHASE.pop()
        PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + now - t0
    if n is not None:
        _OPEN_PHASE.append((str(n), now))


def parse_args(argv: list[str]) -> tuple[str | None, set[str] | None]:
    """``(parent, groups)`` from ``[--parent DIR] [--only GROUP[,GROUP]]``;
    a group may be named by a phase number of its own; ``groups`` is
    ``None`` without ``--only``."""
    usage = (f"usage: chip_smoke.py [--parent DIR] [--only GROUP[,GROUP]] "
             f"(groups: {', '.join(GROUPS)}, or a phase number), got {argv}")
    parent, groups, rest = None, None, list(argv)
    while rest:
        flag = rest.pop(0)
        if flag not in ("--parent", "--only") or not rest:
            fail(usage)
        value = rest.pop(0)
        if flag == "--parent":
            parent = os.path.abspath(value)
            continue
        groups = set()
        for name in value.split(","):
            if name.isdigit():
                name = next((g for g, r in GROUPS.items()
                             if int(name) in r), name)
            if name not in GROUPS:
                fail(usage)
            groups.add(name)
    return parent, groups


def module_env() -> dict:
    """The environment of a ``python -m`` child: the checkout on its path,
    no fault plan."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p))
    env.pop("CME213_FAULTS", None)
    return env


def run_module(args, timeout):
    """``python -m args`` from the checkout: (stdout, seconds).  It runs
    in a session of its own, so a timeout stops its children too."""
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", *args], cwd=HERE,
                            env=module_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"{' '.join(args)}: no result in {timeout} s")
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"{' '.join(args)}: rc {proc.returncode}\n{stderr[-3000:]}")
    return stdout, secs


def headline_lines(kind, peak) -> dict:
    """Phase 16's headline bench as a user runs it, each in a child:
    ``bench.headline`` at f32 and f64, and ``--spmv``; every row ok, the
    card and its peak named, the scan rows' launches as their runs imply.
    Returns the lines by name, each with its child's seconds."""
    headline = {}
    for dtype_name in ("f32", "f64"):
        out, secs = run_module(["cme213_tpu_torch.bench.headline",
                                f"--dtype={dtype_name}"], 900)
        line = json.loads(out.strip().splitlines()[-1])
        headline[dtype_name] = dict(line, seconds=secs)
        print(f"headline {dtype_name} ({secs:.1f} s): {json.dumps(line)}")
        bad = [r for r in line["kernels"] if not r.get("ok")]
        if bad:
            fail(f"headline {dtype_name}: rows not ok: {bad}")
        if line["device_kind"] != kind or line["platform"] != "cuda" or \
                line["pct_hbm_peak"] != round(100 * line["value"]
                                              / peak.gbs, 1):
            fail(f"headline {dtype_name}: device or peak: {line}")
    out, secs = run_module(["cme213_tpu_torch.bench.headline", "--spmv"],
                           600)
    spmv_line = json.loads(out.strip().splitlines()[-1])
    headline["spmv"] = dict(spmv_line, seconds=secs)
    print(f"headline --spmv ({secs:.1f} s): {json.dumps(spmv_line)}")
    scan_rows = [r for r in spmv_line["kernels"]
                 if r["kernel"] in SCAN_KERNELS]
    if len(scan_rows) != 2 * 3 or any(r["error"] for r in scan_rows):
        fail(f"headline --spmv: {scan_rows}")
    # one run_spmv_scan a size and kernel: an untimed iteration, then 8
    want = sum(r["iters"] + 1 for r in scan_rows) // 2
    if spmv_line["launches"] != {"segscan": want, "spmv_fused": want}:
        fail(f"headline --spmv: launches {spmv_line['launches']}, "
             f"expected {want} each")
    return headline


def calibrate() -> list:
    """Phase 22: ``doctor calibrate --json`` in a child, its five rows."""
    out, secs = run_module(["cme213_tpu_torch", "doctor", "calibrate",
                            "--json"], 300)
    calibration = json.loads(out)
    print(f"doctor calibrate --json ({secs:.1f} s):")
    for r in calibration:
        print(f"  {json.dumps(r)}")
    if len(calibration) != 5 or any("error" in r for r in calibration) or \
            {(r["op"], r["rung"]) for r in calibration} != {
                ("spmv_scan", "flat"), ("spmv_scan", "pallas-fused"),
                ("heat", "xla"), ("heat", "pipeline"), ("sort", "xla")}:
        fail(f"doctor calibrate: {calibration}")
    return calibration


def pwtk_problem(spmv, segp, dev):
    """Phase 8's instance, pwtk, and its plain solve in float64 on the
    card: ``(problem, f64 result)``."""
    prob = spmv.suite_problem(SUITE)
    a, xx, flags, _ = spmv.problem_tensors(prob, device=dev)
    ref64 = segp.spmv_scan_pallas_plain(a.double(), xx.double(), flags,
                                        prob.iters).cpu().numpy()
    print(f"{SUITE} (set-up): n={prob.n} p={prob.p} q={prob.q} "
          f"N={prob.iters}")
    return prob, ref64


def dist_setup(config, core, dist, grid, ops, dev):
    """Phase 10's hw5 set-up: ``(params, run_heat's grid on the card, four
    virtual shards, their 2 x 2 mesh, rows)``, ``rows`` holding the 2-D
    sync ``pallas`` path's ms a step as phase 10 times it."""
    vdev = core.virtual_devices(DIST_SHARDS)
    dist_p = config.SimParams(nx=DIST_N, ny=DIST_N, order=8,
                              iters=DIST_ITERS)
    dist_ref = ops.run_heat(grid.make_initial_grid(dist_p, device=dev),
                            DIST_ITERS, dist_p.order, dist_p.xcfl,
                            dist_p.ycfl)
    mesh2d = dist.make_mesh_2d(2, 2, devices=vdev)
    iterate, _, _ = dist.prepare_distributed_heat(dist_p, mesh2d,
                                                  local_kernel="pallas")
    iterate()  # the first use builds the plan
    seconds, _ = iterate()
    label = f"run_distributed {DIST_N}x{DIST_N} 2d sync pallas"
    rows = {label: {"ms": seconds * 1e3 / DIST_ITERS}}
    print(f"{label} (set-up): {rows[label]['ms']:.6f} ms/step")
    return dist_p, dist_ref, vdev, mesh2d, rows


def b1_timing(core, grid, ops, full, dev) -> dict:
    """Phase 4's B1 time at 4000² order 8 f32, k = 1 (CUDA events, one
    warm-up, best of 2), as ``timings["pipeline"][0]``."""
    u = grid.make_initial_grid(full, device=dev)
    args = (full.iters, full.order, full.xcfl, full.ycfl, full.bc)
    ms = core.time_fn(lambda v: ops.run_heat_pipeline(v, *args, k=1), u,
                      warmup=1, iters=2) / full.iters
    print(f"B1 {FULL_N}x{FULL_N} k=1 (set-up): {ms:.6f} ms/step")
    return {"pipeline": [{"k": 1, "ms": ms}]}


def sweep_csvs(run_all, work: str) -> str:
    """Phase 14's full-size sweeps (``SWEEP_PATH``) into ``work/sweeps``:
    the directory."""
    out_dir = os.path.join(work, "sweeps")
    rc = run_all.main(["--out", out_dir, "--only", ",".join(SWEEP_PATH)])
    if rc != 0:
        fail(f"run_all --only {','.join(SWEEP_PATH)} (set-up): rc {rc}")
    return out_dir


def main(argv=None) -> int:
    t_script = time.perf_counter()
    parent, groups = parse_args(sys.argv[1:] if argv is None else argv)
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"needs torch and numpy: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this test needs a card")
    cards = torch.cuda.device_count()
    if groups is None:
        groups = set(GROUPS)
        if cards < MULTICARD:
            groups.discard("multicard")
            print(f"phase 33 (multicard) needs {MULTICARD} cards; this "
                  f"machine has {cards}: not run")
    elif "multicard" in groups and cards < MULTICARD:
        fail(f"--only multicard needs {MULTICARD} cards; this machine has "
             f"{cards}")
    sys.path.insert(0, HERE)
    try:
        import cme213_tpu_torch
        from cme213_tpu_torch import config, core, dist, grid, ops
        from cme213_tpu_torch.apps import heat2d
        from cme213_tpu_torch.apps import spmv_scan as spmv
        from cme213_tpu_torch.apps.matrix_market import dense2_problem
        from cme213_tpu_torch.core import roofline
        from cme213_tpu_torch.dist import heat as dheat
        from cme213_tpu_torch.ops import _kernels
        from cme213_tpu_torch.bench import run_all, sweeps
        from cme213_tpu_torch.ops import segmented_pallas as segp
        from cme213_tpu_torch.ops import stencil_pallas as spl
        from cme213_tpu_torch.ops import stencil_pipeline as sp
        from cme213_tpu_torch.ops import transpose as tp
        from cme213_tpu_torch.verify.checkers import (relative_l2_error,
                                                      relative_linf_error)
    except ImportError as e:
        fail(f"the port's package is not beside this script: {e}")
    if os.path.dirname(os.path.dirname(
            os.path.abspath(cme213_tpu_torch.__file__))) != HERE:
        fail(f"imported {cme213_tpu_torch.__file__}, not the checkout's "
             f"package beside this script")

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    peak = roofline.peak_for(kind)
    if peak is None:
        fail(f"no peak figures for {kind!r} in core/roofline.PEAKS")
    # files later phases read back (phase 28): removed at exit
    work_dir = tempfile.TemporaryDirectory(prefix="chip_smoke-")
    work = work_dir.name
    entries = {"pipeline": ops.run_heat_pipeline,
               "pipeline2d": ops.run_heat_pipeline2d}

    def max_errors(a, b, limit=MAX_ULPS) -> tuple[int, float]:
        a, b = a.cpu().numpy(), b.cpu().numpy()
        ulp = int(core.ulp_distance(a, b).max())
        err = float(np.abs(a.astype(np.float64) - b).max())
        if not (np.isfinite(a).all() and ulp <= limit):
            fail(f"{ulp} ULP apart (limit {limit}) or not finite")
        return ulp, err

    def seeded_grid(p, dtype, seed):
        u = grid.make_initial_grid(p, dtype=torch.float64, device="cpu")
        b = p.border_size
        rng = np.random.default_rng(seed)
        u[b:-b, b:-b] += torch.from_numpy(rng.uniform(0, 1, (p.ny, p.nx)))
        return u.to(device=dev, dtype=dtype)

    paths: dict[str, dict[str, int]] = {}

    counters = (sp.LAUNCHES, segp.LAUNCHES, spl.LAUNCHES, tp.LAUNCHES)

    def counted(label, expect, run):
        """Drive one path with every count set to 0 just before it; fail
        unless the counts read just after are ``expect`` (``None``: only
        record them)."""
        for counter in counters:
            for key in counter:
                counter[key] = 0
        out = run()
        torch.cuda.synchronize()
        paths[label] = {k: v for c in counters for k, v in c.items()}
        print(f"launches of {label}: {paths[label]}")
        if expect is not None and paths[label] != expect:
            fail(f"{label}: launches {paths[label]}, expected {expect}")
        return out

    def only(name, n):
        return {key: (n if key == name else 0)
                for counter in counters for key in counter}

    def served(op):
        """The rung that last served ``op`` (its ``served`` event)."""
        ev = [e for e in core.trace.events("served") if e["op"] == op]
        if not ev:
            fail(f"no served event for {op}")
        return ev[-1]

    cwd = os.getcwd()
    env = module_env()
    full = config.SimParams(nx=FULL_N, ny=FULL_N, order=FULL_ORDER,
                            iters=FULL_ITERS)
    # the first use of each SpMV kernel rung runs its conformance probe:
    # the probe program's warm-up iteration and its iterations
    scan_probe = 1 + spmv._PROBE_SHAPE["iters"]

    # ---------------------------------------------------- 1. identity, build
    phase(1)
    ident = core.card_identity()
    print(f"card: {ident}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    print(f"groups: {', '.join(g for g in GROUPS if g in groups)}")
    if groups != {"fleet"}:
        # phase 32 launches no hand-written kernel; every other group does
        t0 = time.perf_counter()
        built = _kernels.build()
        print(f"kernel build (set-up): {time.perf_counter() - t0:.2f} s, "
              f"{len(built)} libraries, one nvcc each, in parallel")
        for name, path in built.items():
            _kernels.library(name)
            print(f"  {name}: {path.name}")
            for line in path.with_suffix(".log").read_text().splitlines():
                if "Compiling" in line or "Used" in line or "spill" in line:
                    print(f"    ptxas: {line.strip()}")
    lines = {}  # the groups' JSON lines, by name

    if "kernels" in groups:
        # ---------------------------------------------------- 2. the example
        phase(2)

        params = config.SimParams.from_file(
            os.path.join(HERE, "examples", "params.in"))
        with tempfile.TemporaryDirectory() as out_dir:
            # run_single goes through the ladder: the first use of the kernel
            # rung runs its conformance probe, then the program's warm-up
            # launch, then the timed solve
            res = counted(
                f"run_single {params.nx}x{params.ny}",
                only("pipeline", params.iters + 1 + HEAT_PROBE_LAUNCHES),
                lambda: heat2d.run_single(params, check_cpu=True,
                                          save_files=True, out_dir=out_dir,
                                          device="cuda"))
            dumps = sorted(os.listdir(out_dir))
        ev = served("heat")
        print(f"example {params.nx}x{params.ny} order {params.order} "
              f"{params.iters} iters: ok={res.ok} dumps={dumps}, served by "
              f"{ev['rung']} (demoted {ev['demoted']})")
        if not res.ok:
            fail("the example failed its golden ULP-10 check")
        if ev["rung"] != "pipeline" or ev["demoted"]:
            fail(f"the example was served demoted: {ev}")
        if len(dumps) != 4:
            fail(f"example: dumps {dumps}")

        # ---------------------------------------------------- 3. kernel vs plain
        phase(3)
        worst_ulp = dict.fromkeys(entries, 0)
        worst_err = dict.fromkeys(entries, 0.0)

        def note(name, ulp, err):
            worst_ulp[name] = max(worst_ulp[name], ulp)
            worst_err[name] = max(worst_err[name], err)

        cases = [((1000, 1000), order, k, torch.float32)
                 for order in (2, 4, 8) for k in (1, 2, 3, 4, 8)]
        cases += [((1000, 1000), 8, 4, torch.float64),
                  ((1000, 1000), 4, 1, torch.float64),
                  ((1000, 1000), 2, 3, torch.float64),
                  ((257, 121), 8, 1, torch.float32),
                  ((257, 121), 4, 8, torch.float32),
                  # rows not 16-byte aligned: the kernel stages element-wise
                  ((3999, 4001), 8, 1, torch.float32),
                  ((3999, 4001), 2, 3, torch.float32),
                  ((3999, 4001), 8, 2, torch.float64),
                  # a grid smaller than one tile
                  ((5, 7), 8, 1, torch.float32),
                  ((5, 7), 8, 3, torch.float32),
                  ((512, 512), 8, 1, torch.float32)]
        # the main path's own shapes: the example's and the full size's
        cases += [((FULL_N, FULL_N), FULL_ORDER, k, torch.float32)
                  for k in (1, 2, 4, 8)]
        for seed, ((ny, nx), order, k, dtype) in enumerate(cases):
            p = config.SimParams(nx=nx, ny=ny, order=order, bc_top=1.5,
                                 bc_left=0.5, bc_bottom=2.0, bc_right=0.25)
            u = seeded_grid(p, dtype, seed)
            args = (8 * k, order, p.xcfl, p.ycfl, p.bc)
            plain = ops.run_heat_pipeline_plain(u, *args, k=k)
            for name, fn in entries.items():
                ulp, err = max_errors(core.check_op(name, fn(u, *args, k=k)),
                                      plain, limit=0)
                note(name, ulp, err)
                print(f"  vs plain: {name:<10} {ny}x{nx} order {order} k={k} "
                      f"{str(dtype)[6:]}: max ULP {ulp}, max |err| {err:.3g}")

        # ---------------------------------------------------- 4. full size
        phase(4)
        full_path = f"run_single {FULL_N}x{FULL_N}"
        res = counted(full_path, only("pipeline", full.iters + 1),
                      lambda: heat2d.run_single(full, check_cpu=False,
                                                device="cuda"))
        if not res.ok:
            fail("full-size run_single")
        u = grid.make_initial_grid(full, device="cuda")
        args = (full.iters, full.order, full.xcfl, full.ycfl, full.bc)
        step = roofline.heat_cost(full.ny, full.nx, order=full.order, iters=1)
        timings = {name: [] for name in entries}
        outs = []
        for name, fn in entries.items():
            for k in (1, 2, 4, 8):
                # one counted solve (its result is checked below), then the
                # timed solves, whose launches are not read
                out = counted(f"{fn.__name__} {FULL_N}x{FULL_N} k={k}",
                              only(name, full.iters // k),
                              lambda fn=fn, k=k: fn(u, *args, k=k))
                outs.append((name, k, out))
                ms = core.time_fn(lambda v, fn=fn, k=k: fn(v, *args, k=k), u,
                                  warmup=1, iters=2) / full.iters
                # one launch runs k steps: it reads and writes the grid once
                # and does k steps' arithmetic
                launch = roofline.Cost(step.nbytes, step.flops * k)
                b_ms, b_by = roofline.bound_ms(launch, peak, torch.float32)
                gbs = step.gbs(ms)
                timings[name].append({"k": k, "ms": ms, "bound_ms": b_ms / k,
                                      "bound_by": b_by, "gbs": gbs})
                att = roofline.attribute(gbs, step.gflops(ms), device=kind)
                plan = sp.launch_plan(u, 1, k, full.order)
                per_sm, regs, local = _kernels.heat_ksteps_occupancy(
                    dev, 4, full.order, k, plan.smem)
                timings[name][-1].update(
                    tile=f"{plan.tile_y}x{plan.tile_x}", threads=plan.threads,
                    grid=list(plan.grid), blocks_per_sm=per_sm, registers=regs,
                    local_bytes=local)
                print(f"full {name:<10} k={k}: {ms:.6f} ms/iter, {gbs:.1f} GB/s "
                      f"({att['pct_peak']}% of {peak.gbs:.0f} GB/s), "
                      f"bound {b_ms / k:.6f} ms/iter by {b_by}; tile "
                      f"{plan.tile_y}x{plan.tile_x}, {plan.threads} threads, "
                      f"grid {plan.grid}, {per_sm} blocks/SM, {regs} registers, "
                      f"{local} B local (spills)")
        n_plain = 10
        plain_ms = core.time_fn(
            lambda v: ops.run_heat_pipeline_plain(v, n_plain, *args[1:], k=1),
            u, warmup=1, iters=2) / n_plain
        torch_ms = core.time_fn(lambda v: ops.run_heat(v, n_plain, *args[1:4]),
                                u, warmup=1, iters=2) / n_plain
        ref = ops.run_heat(u, *args[:4])
        for name, k, out in outs:
            ulp, err = max_errors(out, ref, limit=0)
            note(name, ulp, err)
            print(f"  vs run_heat: {name:<10} k={k} {FULL_ITERS} iters: "
                  f"max ULP {ulp}, max |err| {err:.3g}")

        torch.backends.cudnn.allow_tf32 = False

        def cross_weight(p):
            """``p``'s stencil step as a (1, 1, 2b+1, 2b+1) conv2d weight."""
            b = p.border_size
            w = torch.zeros(2 * b + 1, 2 * b + 1, dtype=torch.float32)
            coeffs = torch.tensor(ops.STENCIL_COEFFS[p.order])
            w[b, :] += coeffs * p.xcfl
            w[:, b] += coeffs * p.ycfl
            w[b, b] += 1.0
            return w.to(dev)[None, None]

        w = cross_weight(full)
        conv = torch.nn.functional.conv2d
        library_ms = core.time_fn(lambda v: conv(v[None, None], w), u,
                                  warmup=2, iters=5)
        print(f"plain version {plain_ms:.6f} ms/iter, ops.stencil.run_heat "
              f"{torch_ms:.6f} ms/iter, conv2d yardstick {library_ms:.6f} ms")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
             "power.limit,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        print(f"card after the runs: {smi.stdout.strip()}")

        # ---------------------------------------------------- 5. SpMV example
        phase(5)
        with tempfile.TemporaryDirectory() as out_dir:
            os.chdir(out_dir)  # the CLI writes b.txt and b_cpu.txt here
            try:
                if spmv.main(["spmv_scan", "gen", "a.txt", "x.txt"]) != 0:
                    fail("spmv_scan gen")
                gen = spmv.load_problem("a.txt", "x.txt")
                for kernel, name in SCAN_KERNELS.items():
                    buf = io.StringIO()

                    def cli(kernel=kernel, buf=buf):
                        with contextlib.redirect_stdout(buf):
                            return spmv.main(["spmv_scan", "a.txt", "x.txt",
                                              "cpu_check", f"--kernel={kernel}"])
                    rc = counted(f"spmv_scan CLI gen n={gen.n} {kernel}",
                                 only(name, gen.iters + 1 + scan_probe), cli)
                    print(buf.getvalue(), end="")
                    if rc != 0 or "Worked!" not in buf.getvalue():
                        fail(f"spmv_scan CLI --kernel={kernel}: rc {rc}, no "
                             f"'Worked!'")
            finally:
                os.chdir(cwd)

        # ---------------------------------------------------- 6. dense2
        phase(6)
        d2 = dense2_problem(iters=10, seed=0)
        for kernel, name in SCAN_KERNELS.items():
            out = counted(f"run_spmv_scan dense2 {kernel}",
                          only(name, d2.iters + 1),
                          lambda k=kernel: spmv.run_spmv_scan(d2, kernel=k,
                                                              device=dev))
            errs = spmv.external_check(d2, out)
            print(f"dense2 n={d2.n} p={d2.p} N={d2.iters} {kernel}: rel L2 "
                  f"{errs['rel_l2']:.3e}, rel Linf {errs['rel_linf']:.3e}")
            if not (np.isfinite(out).all() and errs["rel_l2"] <= 1e-4
                    and errs["rel_linf"] <= 1e-3):
                fail(f"dense2 {kernel}: external_check {errs}")

        # ---------------------------------------------------- 7. scan vs plain
        phase(7)
        scan_ulp = dict.fromkeys(SCAN_KERNELS.values(), 0)
        scan_err = dict.fromkeys(SCAN_KERNELS.values(), 0.0)

        def scan_note(name, got, ref, label):
            got, ref = got.cpu().numpy(), ref.cpu().numpy()
            if not np.isfinite(ref).all():
                fail(f"{label}: the plain version is not finite")
            ulp = int(core.ulp_distance(got, ref).max())
            err = float(np.abs(got.astype(np.float64) - ref).max())
            print(f"  vs plain: {label}: max ULP {ulp}, max |err| {err:.3g}")
            if ulp > 0:
                fail(f"{label}: {ulp} ULP from the plain version (limit 0)")
            scan_ulp[name] = max(scan_ulp[name], ulp)
            scan_err[name] = max(scan_err[name], err)

        tile = segp.TILE
        rng = np.random.default_rng(2)
        for n in (1, 31, tile - 1, tile, tile + 1, 3 * tile + 5, 100_003,
                  1 << 22):
            v = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
            xx = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32))
            v, xx = v.to(dev), xx.to(dev)
            for heads in ("one", "every", "tile-edges", "random"):
                f = np.zeros(n, np.int32)
                if heads == "one":
                    f[0] = 1
                elif heads == "every":
                    f[:] = 1
                elif heads == "tile-edges":
                    f[::tile] = 1
                else:
                    f[rng.random(n) < 0.02] = 1
                    f[0] = 1
                f = torch.from_numpy(f).to(dev)
                scan_note("segscan", segp.segmented_scan_pallas(v, f),
                          segp.segmented_scan_pallas_plain(v, f),
                          f"B6 n={n} heads={heads}")
                for it in (1, 8):
                    scan_note("spmv_fused", segp.spmv_scan_pallas(v, xx, f, it),
                              segp.spmv_scan_pallas_plain(v, xx, f, it),
                              f"B7 n={n} heads={heads} N={it}")
        # one head over 2^24 elements: 8192 tiles, the look-back's longest walks
        n = 1 << 24
        v = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
        xx = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32)).to(dev)
        f = torch.zeros(n, dtype=torch.int32, device=dev)
        f[0] = 1
        scan_note("segscan", segp.segmented_scan_pallas(v, f),
                  segp.segmented_scan_pallas_plain(v, f), f"B6 n={n} heads=one")
        scan_note("spmv_fused", segp.spmv_scan_pallas(v, xx, f, 2),
                  segp.spmv_scan_pallas_plain(v, xx, f, 2),
                  f"B7 n={n} heads=one N=2")
        del v, xx, f

        # ---------------------------------------------------- 8. full size: pwtk
        phase(8)
        prob = spmv.suite_problem(SUITE)
        a, xx, flags, starts = spmv.problem_tensors(prob, device=dev)
        n, n_it = prob.n, prob.iters
        print(f"{SUITE}: n={n} p={prob.p} q={prob.q} N={n_it}")
        ref64 = segp.spmv_scan_pallas_plain(a.double(), xx.double(), flags,
                                            n_it).cpu().numpy()
        it_cost = roofline.spmv_scan_cost(n, 1)
        it_bound, it_by = roofline.bound_ms(it_cost, peak, torch.float32)

        def per_call_ms(fn, x, reps):
            """Best of 2 timed runs of ``reps`` calls after one warm-up run
            (CUDA events), per call."""
            def run(v):
                for _ in range(reps):
                    out = fn(v)
                return out
            return core.time_fn(run, x, warmup=1, iters=2) / reps

        spmv_rows = {}
        for kernel in ("pallas-fused", "pallas", "auto", "flat"):
            label = f"run_spmv_scan {SUITE} {kernel}"
            out = counted(label, only(SCAN_KERNELS.get(kernel), n_it + 1),
                          lambda k=kernel: spmv.run_spmv_scan(prob, kernel=k,
                                                              device=dev))
            runner = spmv._build_runner(kernel, n_it)
            ms = core.time_fn(lambda v, r=runner: r(v, xx, flags, starts), a,
                              warmup=1, iters=2) / n_it
            rel_l2 = relative_l2_error(ref64, out)
            rel_linf = relative_linf_error(ref64, out)
            gbs = it_cost.gbs(ms)
            att = roofline.attribute(gbs, it_cost.gflops(ms), device=kind)
            spmv_rows[kernel] = {"ms": ms, "gbs": gbs, "pct_peak": att["pct_peak"],
                                 "bound_ms": it_bound, "bound_by": it_by,
                                 "rel_l2_vs_f64": rel_l2,
                                 "rel_linf_vs_f64": rel_linf}
            print(f"full {SUITE} {kernel:<12}: {ms:.6f} ms/iter, {gbs:.1f} GB/s "
                  f"({att['pct_peak']}% of {peak.gbs:.0f} GB/s), bound "
                  f"{it_bound:.6f} ms/iter by {it_by}; vs f64 plain: rel L2 "
                  f"{rel_l2:.3e}, rel Linf {rel_linf:.3e}")
            tol_l2, tol_linf = PWTK_TOL[kernel]
            if not (np.isfinite(out).all() and rel_l2 <= tol_l2
                    and rel_linf <= tol_linf):
                fail(f"{label}: rel L2 {rel_l2:.3e} / rel Linf {rel_linf:.3e} "
                     f"from the f64 plain run (limits {tol_l2} / {tol_linf})")

        w = a * xx  # B6's input on the pallas path's first iteration
        scan_note("segscan", segp.segmented_scan_pallas(w, flags),
                  segp.segmented_scan_pallas_plain(w, flags), f"B6 {SUITE} n={n}")
        first = segp.spmv_scan_pallas(a, xx, flags, n_it)
        scan_note("spmv_fused", first,
                  segp.spmv_scan_pallas_plain(a, xx, flags, n_it),
                  f"B7 {SUITE} n={n} N={n_it}")
        for rep in range(3):
            if not torch.equal(
                    first.view(torch.int32),
                    segp.spmv_scan_pallas(a, xx, flags, n_it).view(torch.int32)):
                fail(f"B7 {SUITE}: solve {rep + 2} differs in bits from the "
                     f"first")
        print(f"B7 {SUITE}: three more solves bitwise equal to the first")
        scan_cost = roofline.segmented_scan_cost(n)
        b6_bound, b6_by = roofline.bound_ms(scan_cost, peak, torch.float32)
        b6_ms = per_call_ms(lambda v: segp.segmented_scan_pallas(v, flags), w,
                            n_it)
        b6_plain_ms = per_call_ms(
            lambda v: segp.segmented_scan_pallas_plain(v, flags), w, 3)
        b7_plain_ms = per_call_ms(
            lambda v: segp.spmv_scan_pallas_plain(v, xx, flags, 1), a, 3)
        cumsum_ms = per_call_ms(lambda v: torch.cumsum(v, 0), a, n_it)
        print(f"B6 alone {SUITE}: {b6_ms:.6f} ms/scan, "
              f"{scan_cost.gbs(b6_ms):.1f} GB/s, bound {b6_bound:.6f} ms by "
              f"{b6_by}; plain version {b6_plain_ms:.6f} ms/scan")
        print(f"B7 plain version {SUITE}: {b7_plain_ms:.6f} ms/iter")
        print(f"library_ms: null ({NO_LIBRARY})")
        print(f"yardstick, not a segmented scan: torch.cumsum of {n} f32 "
              f"{cumsum_ms:.6f} ms")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
             "power.limit,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        print(f"card after the runs: {smi.stdout.strip()}")

        # ---------------------------------------------------- 9. B3 vs plain
        phase(9)
        local_ulp, local_err = 0, 0.0

        def note_local(ulp, err):
            nonlocal local_ulp, local_err
            local_ulp = max(local_ulp, ulp)
            local_err = max(local_err, err)

        def shard_blocks(p, mesh, K, dtype, seed=0):
            """{(yi, xi): (K-padded block, gy0, gx0)} as the distributed solve
            assembles them on the card from a seeded interior of ``p``."""
            y_size, x_size, ny_loc, nx_loc = dheat._mesh_layout(p, mesh)
            rng = np.random.default_rng(seed)
            u = dheat._pad_interior_for_mesh(
                p.ic + rng.uniform(0, 1, (p.ny, p.nx)), p, y_size, x_size)
            blocks = dheat._scatter(torch.from_numpy(u).to(dtype),
                                    dheat._shard_devices(mesh, y_size, x_size),
                                    ny_loc, nx_loc)
            padded = dheat._assemble_padded(blocks, p, border=K)
            b = p.border_size
            return {(yi, xi): (padded[yi][xi], yi * ny_loc + b - K,
                               xi * nx_loc + b - K)
                    for yi in range(y_size) for xi in range(x_size)}

        vdev = core.virtual_devices(DIST_SHARDS)
        local_cases = {  # name: (ny, nx, mesh, shard)
            "corner": (DIST_N, DIST_N, dist.make_mesh_2d(2, 2, devices=vdev),
                       [(0, 0), (1, 1)]),
            "edge": (DIST_N, DIST_N, dist.make_mesh_1d(4, devices=vdev),
                     [(1, 0)]),
            "interior": (2001, 2001,
                         dist.make_mesh_2d(3, 3, devices=vdev * 3), [(1, 1)]),
            "ghost": (1999, 2001, dist.make_mesh_2d(2, 2, devices=vdev),
                      [(1, 1)])}
        local_runs = [(order, k, torch.float32) for order in (2, 4, 8)
                      for k in (1, 2, 3, 4, 8)] + [(8, 4, torch.float64),
                                                   (2, 8, torch.float64),
                                                   (4, 3, torch.float64)]
        for seed, (order, k, dtype) in enumerate(local_runs):
            for where, (ny, nx, mesh, shards) in local_cases.items():
                p = config.SimParams(nx=nx, ny=ny, order=order, bc_top=1.5,
                                     bc_left=0.5, bc_bottom=2.0, bc_right=0.25)
                K = k * p.border_size
                blocks = shard_blocks(p, mesh, K, dtype, seed)
                for shard in shards:
                    blk, gy0, gx0 = blocks[shard]
                    args = (gy0, gx0, p.ny, p.nx, order, p.xcfl, p.ycfl, p.bc)
                    got = sp.stencil_local_multistep(blk, *args, k=k)
                    ref = sp.stencil_local_multistep_plain(blk, *args, k=k)
                    ulp, err = max_errors(got[K:-K, K:-K], ref[K:-K, K:-K],
                                          limit=0)
                    note_local(ulp, err)
                    print(f"  vs plain: local {where} {shard} of {ny}x{nx} "
                          f"order {order} k={k} {str(dtype)[6:]}: max ULP {ulp}, "
                          f"max |err| {err:.3g}")
        # all nine shards of the 3x3 mesh (corner, edge, interior shards) in
        # one launch
        mesh3 = local_cases["interior"][2]
        for order, k, dtype in [(8, 1, torch.float32), (8, 2, torch.float32),
                                (4, 3, torch.float32), (2, 8, torch.float32),
                                (8, 4, torch.float64)]:
            p = config.SimParams(nx=2001, ny=2001, order=order, bc_top=1.5,
                                 bc_left=0.5, bc_bottom=2.0, bc_right=0.25)
            K = k * p.border_size
            blocks = shard_blocks(p, mesh3, K, dtype, seed=order + k)
            pads = [blk for blk, _, _ in blocks.values()]
            offs = [(gy0, gx0) for _, gy0, gx0 in blocks.values()]
            args = (p.ny, p.nx, order, p.xcfl, p.ycfl, p.bc)
            before = sp.LAUNCHES["local"]
            got = sp.stencil_local_multistep_shards(pads, offs, *args, k=k)
            torch.cuda.synchronize()
            if sp.LAUNCHES["local"] - before != 1:
                fail(f"nine shards took {sp.LAUNCHES['local'] - before} launches")
            ref = sp.stencil_local_multistep_shards_plain(pads, offs, *args, k=k)
            worst = 0
            for g, r in zip(got, ref):
                ulp, err = max_errors(g[K:-K, K:-K], r[K:-K, K:-K], limit=0)
                note_local(ulp, err)
                worst = max(worst, ulp)
            print(f"  vs plain: local, the 3x3 mesh's nine shards of 2001x2001 "
                  f"in one launch, order {order} k={k} {str(dtype)[6:]}: max ULP "
                  f"{worst}")

        # ---------------------------------------------------- 10. hw5 full size
        phase(10)
        base = dict(nx=DIST_N, ny=DIST_N, order=8, iters=DIST_ITERS)
        dist_p = config.SimParams(**base)
        dist_ref = ops.run_heat(grid.make_initial_grid(dist_p, device=dev),
                                DIST_ITERS, dist_p.order, dist_p.xcfl,
                                dist_p.ycfl)
        dist_step = roofline.heat_cost(DIST_N, DIST_N, order=8, iters=1)
        dist_bound, dist_by = roofline.bound_ms(dist_step, peak, torch.float32)
        method = {"1d": config.GridMethod.STRIPES_1D,
                  "2d": config.GridMethod.BLOCKS_2D}
        dist_rows = {}

        def dist_path(label, out, kernel, timed):
            """Hold ``out`` (the full halo grid) to ``run_heat`` (the ``pallas``
            paths bit for bit) and time the same solve again through ``timed``
            (an ``iterate``)."""
            ulp, err = max_errors(torch.from_numpy(out), dist_ref,
                                  limit=0 if kernel == "pallas" else MAX_ULPS)
            if kernel == "pallas":
                note_local(ulp, err)
            seconds, _ = timed()
            ms = seconds * 1e3 / DIST_ITERS
            gbs = dist_step.gbs(ms)
            att = roofline.attribute(gbs, dist_step.gflops(ms), device=kind)
            dist_rows[label] = {"ms": ms, "gbs": gbs,
                                "pct_peak": att["pct_peak"],
                                "bound_ms": dist_bound, "bound_by": dist_by,
                                "max_ulp_vs_run_heat": ulp}
            print(f"{label}: {ms:.6f} ms/step, {gbs:.1f} GB/s "
                  f"({att['pct_peak']}% of {peak.gbs:.0f} GB/s), bound "
                  f"{dist_bound:.6f} ms/step by {dist_by}; vs run_heat: max "
                  f"ULP {ulp}, max |err| {err:.3g}")

        # the first gated use of pallas per (mesh shape, k, order) runs the
        # gate's probe solve on that mesh
        gated = set()

        def dist_probe(mesh, k, order):
            key = (mesh.devices.shape, k, order)
            if key in gated:
                return 0
            gated.add(key)
            return DIST_PROBE_LAUNCHES

        for dim, sync, kernel in [("1d", True, "xla"), ("1d", False, "xla"),
                                  ("2d", True, "xla"), ("2d", False, "xla"),
                                  ("1d", True, "pallas"), ("2d", True, "pallas")]:
            p = config.SimParams(**base, grid_method=method[dim],
                                 synchronous=sync)
            label = (f"run_distributed {DIST_N}x{DIST_N} {dim} "
                     f"{'sync' if sync else 'async'} {kernel}")
            # one launch a device a step: the four shards share the card
            n_local = DIST_ITERS + dist_probe(
                dist.mesh_for_method(p.grid_method, devices=vdev), 1,
                p.order) if kernel == "pallas" else 0
            out = counted(label, only("local", n_local),
                          lambda p=p, kernel=kernel: heat2d.run_distributed(
                              p, local_kernel=kernel, devices=vdev))
            mesh = dist.mesh_for_method(p.grid_method, devices=vdev)
            iterate, _, _ = dist.prepare_distributed_heat(p, mesh,
                                                          local_kernel=kernel)
            dist_path(label, out, kernel, iterate)
        mesh2d = dist.make_mesh_2d(2, 2, devices=vdev)
        mesh1 = dist.make_mesh_1d(1, devices=[dev])
        for mesh, k, kernel in [(mesh2d, 2, "xla"), (mesh2d, 4, "xla"),
                                (mesh2d, 2, "pallas"), (mesh2d, 4, "pallas"),
                                (mesh1, 1, "pallas")]:
            devices = len(set(mesh.devices.flat))
            label = (f"run_distributed_heat {DIST_N}x{DIST_N} "
                     f"{'x'.join(map(str, mesh.devices.shape))} {kernel} k={k}")
            n_local = devices * DIST_ITERS // k + dist_probe(
                mesh, k, dist_p.order) if kernel == "pallas" else 0
            out = counted(label, only("local", n_local),
                          lambda mesh=mesh, k=k, kernel=kernel:
                          dist.run_distributed_heat(
                              dist_p, mesh, steps_per_exchange=k,
                              local_kernel=kernel))
            iterate, _, k_used = dist.prepare_distributed_heat(
                dist_p, mesh, steps_per_exchange=k, local_kernel=kernel)
            if k_used != k:
                fail(f"{label}: ran k={k_used}")
            dist_path(label, out, kernel, iterate)

        # B3 alone on the 2-D path's four padded blocks, per step: the batched
        # call, and for the record the loop of four single-shard calls
        local_timing = []
        for k in (1, 2, 4):
            K = k * dist_p.border_size
            blocks = list(shard_blocks(dist_p, mesh2d, K,
                                       torch.float32).values())
            pads = [blk for blk, _, _ in blocks]
            offs = [(gy0, gx0) for _, gy0, gx0 in blocks]
            args = (dist_p.ny, dist_p.nx, dist_p.order, dist_p.xcfl,
                    dist_p.ycfl, dist_p.bc)

            def batched(_, pads=pads, offs=offs, k=k):
                return sp.stencil_local_multistep_shards(pads, offs, *args, k=k)

            def per_shard(_, blocks=blocks, k=k):
                return [sp.stencil_local_multistep(blk, gy0, gx0, *args, k=k)
                        for blk, gy0, gx0 in blocks]

            ms = per_call_ms(batched, pads[0], 200) / k
            loop_ms = per_call_ms(per_shard, pads[0], 200) / k
            nbytes = sum(2 * blk.numel() * blk.element_size() for blk in pads)
            cost = roofline.Cost(nbytes, ops.flops_per_point(dist_p.order) * k
                                 * DIST_N * DIST_N)
            b_ms, b_by = roofline.bound_ms(cost, peak, torch.float32)
            plan = sp.launch_plan(pads[0], len(pads), k, dist_p.order)
            local_timing.append({"k": k, "ms": ms, "per_shard_loop_ms": loop_ms,
                                 "bound_ms": b_ms / k, "bound_by": b_by,
                                 "gbs": dist_step.gbs(ms),
                                 "tile": f"{plan.tile_y}x{plan.tile_x}",
                                 "grid": list(plan.grid),
                                 "blocks_per_sm": plan.blocks_per_sm})
            print(f"B3 alone, 2x2 blocks of {DIST_N}x{DIST_N} k={k}: batched "
                  f"{ms:.6f} ms/step (one launch, grid {plan.grid}, "
                  f"{plan.blocks_per_sm} blocks/SM), loop of four calls "
                  f"{loop_ms:.6f} ms/step; bound {b_ms / k:.6f} ms/step by "
                  f"{b_by}")
            if k == 1:
                local_plain_ms = per_call_ms(
                    lambda _: sp.stencil_local_multistep_shards_plain(
                        pads, offs, *args, k=1), pads[0], 5)
                w_dist = cross_weight(dist_p)
                local_library_ms = per_call_ms(
                    lambda _: [conv(blk[None, None], w_dist) for blk in pads],
                    pads[0], 20)
        print(f"B3 plain version {local_plain_ms:.6f} ms/step, conv2d "
              f"yardstick over the 4 padded blocks {local_library_ms:.6f} ms")

        # the device's idle share of the 2-D pallas path's step loop
        idle = dist_idle_share(dheat, config, dist, torch, vdev, DIST_N)
        print(f"idle share, run_distributed {DIST_N}x{DIST_N} 2d sync pallas: "
              f"{json.dumps(idle)}")

        # the CLI: a 1x1 mesh of the physical card; the grid it computes is
        # caught on its way to the dumps
        params_dist = os.path.join(HERE, "examples", "params_dist.in")
        cli_p = config.SimParams.from_file(params_dist, distributed=True)
        caught = {}
        run_distributed = heat2d.run_distributed

        def catch(*a, **kw):
            caught["out"] = run_distributed(*a, **kw)
            return caught["out"]

        with tempfile.TemporaryDirectory() as out_dir:
            os.chdir(out_dir)
            heat2d.run_distributed = catch
            try:
                cli_mesh = dist.mesh_for_method(cli_p.grid_method)
                rc = counted(f"heat2d CLI --distributed pallas {cli_p.nx}x"
                             f"{cli_p.ny}", only("local", cli_p.iters
                                                 * torch.cuda.device_count()
                                                 + dist_probe(cli_mesh, 1,
                                                              cli_p.order)),
                             lambda: heat2d.main(["heat2d", params_dist,
                                                  "--distributed",
                                                  "--local-kernel=pallas"]))
                dumps = sorted(os.listdir(out_dir))
            finally:
                heat2d.run_distributed = run_distributed
                os.chdir(cwd)
        # a shard a card: one card here, four on a machine with four
        want_dumps = sorted([f"grid{i}_final.txt" for i in range(
            torch.cuda.device_count())] + ["grid_final.txt", "grid_init.txt"])
        if rc != 0 or dumps != want_dumps:
            fail(f"heat2d --distributed CLI: rc {rc}, dumps {dumps}")
        cli_ref = ops.run_heat(grid.make_initial_grid(cli_p, device=dev),
                               cli_p.iters, cli_p.order, cli_p.xcfl, cli_p.ycfl)
        ulp, err = max_errors(torch.from_numpy(caught["out"]), cli_ref)
        note_local(ulp, err)
        print(f"heat2d CLI --distributed --local-kernel=pallas: dumps {dumps}, "
              f"vs run_heat max ULP {ulp}, max |err| {err:.3g}")

        # ---------------------------------------------------- 11. sharded pwtk
        phase(11)
        timer = core.PhaseTimer()
        label = f"run_spmv_scan_distributed {SUITE} {DIST_SHARDS} shards"
        out = counted(label, only(None, 0),
                      lambda: spmv.run_spmv_scan_distributed(
                          prob, dist.make_mesh_1d(devices=vdev), timer=timer))
        dist_scan_ms = timer.last_ms("spmv_scan_distributed") / n_it
        rel_l2 = relative_l2_error(ref64, out)
        rel_linf = relative_linf_error(ref64, out)
        print(f"{label}: {dist_scan_ms:.6f} ms/iter (host clock after a sync), "
              f"vs f64 plain: rel L2 {rel_l2:.3e}, rel Linf {rel_linf:.3e}")
        tol_l2, tol_linf = PWTK_TOL["auto"]
        if not (np.isfinite(out).all() and rel_l2 <= tol_l2
                and rel_linf <= tol_linf):
            fail(f"{label}: rel L2 {rel_l2:.3e} / rel Linf {rel_linf:.3e} "
                 f"(limits {tol_l2} / {tol_linf})")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
             "power.limit,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        print(f"card after the runs: {smi.stdout.strip()}")

        # ---------------------------------------------------- 12. B4/B5 vs plain
        phase(12)
        band_ulp = {"stencil_full": 0, "multistep": 0}
        band_err = {"stencil_full": 0.0, "multistep": 0.0}
        sms = torch.cuda.get_device_properties(dev).multi_processor_count

        def band_note(name, got, ref, label):
            ulp, err = max_errors(got, ref, limit=0)
            band_ulp[name] = max(band_ulp[name], ulp)
            band_err[name] = max(band_err[name], err)
            print(f"  vs plain: {label}: max ULP {ulp}, max |err| {err:.3g}")

        def band_plan(u, order, k, tile):
            """The launch plan of the band kernel for grid ``u`` and what the
            card says of its instance, as a dict and a printable line."""
            plan = spl.launch_plan(u, k, order, tile)
            per_sm, regs, local = _kernels.heat_band_occupancy(
                dev, u.element_size(), order, k, plan.smem)
            blocks = plan.grid[0] * plan.grid[1]
            row = {"tile": f"{plan.tile_y}x{plan.tile_x}",
                   "threads": plan.threads, "rows": plan.rows,
                   "nbuf": plan.nbuf, "run": plan.run, "grid": list(plan.grid),
                   "smem": plan.smem, "blocks_per_sm": per_sm,
                   "registers": regs, "local_bytes": local,
                   "waves": blocks / (sms * max(1, per_sm))}
            line = (f"TX {plan.tile_x}, {plan.threads} threads, R {plan.rows}, "
                    f"nbuf {plan.nbuf}, run {plan.run}, grid {plan.grid}, smem "
                    f"{plan.smem} B, {per_sm} blocks/SM, {regs} registers, "
                    f"{local} B local (spills), {row['waves']:.2f} waves")
            if local:
                fail(f"band kernel spills at order {order} k={k} tile {tile}: "
                     f"{line}")
            return row, line

        def band_case(n_y, n_x, order, k, tile, dtype, seed):
            p = config.SimParams(nx=n_x, ny=n_y, order=order, bc_top=1.5,
                                 bc_left=0.5, bc_bottom=2.0, bc_right=0.25)
            u = seeded_grid(p, dtype, seed)
            try:
                _, plan = band_plan(u, order, k, tile)
            except ValueError as e:
                print(f"  skipped: {n_y}x{n_x} order {order} k={k} tile {tile} "
                      f"{str(dtype)[6:]}: {e}")
                return
            args = (2 * k, order, p.xcfl, p.ycfl)
            label = (f"{n_y}x{n_x} order {order} k={k} tile {tile} "
                     f"{str(dtype)[6:]} ({plan})")
            band_note("multistep", spl.run_heat_multistep(u, *args, p.bc, k=k,
                                                          tile_y=tile),
                      spl.run_heat_multistep_plain(u, *args, p.bc, k=k),
                      f"B5 {label}")
            if k == 1:
                band_note("stencil_full", spl.run_heat_pallas(u, 3, *args[1:],
                                                              tile_y=tile),
                          spl.run_heat_pallas_plain(u, 3, *args[1:]),
                          f"B4 {label}")

        seed = 0
        for tile in (40, 80, 200, 400):
            for order in (2, 4, 8):
                for k in (1, 2, 3, 4, 8):
                    seed += 1
                    band_case(DIST_N, DIST_N, order, k, tile, torch.float32,
                              seed)
        for k in (1, 2, 4, 8):
            band_case(FULL_N, FULL_N, FULL_ORDER, k, BAND_TILE, torch.float32,
                      100 + k)
        # tile_y 85 is no multiple of any micro-tile height (a ragged row
        # chunk); orders 2 and 4 put the interior off the 16-byte grid
        for order in (2, 4, 8):
            for k in (1, 2, 3):
                band_case(255, 121, order, k, 85, torch.float32, 110 + order + k)
        # rows not 16-byte aligned: staged and stored cell by cell
        band_case(3999, 4001, 8, 1, 93, torch.float32, 120)
        band_case(3999, 4001, 2, 2, 93, torch.float32, 121)
        # f64 at every k class
        for k in (1, 2, 3, 4, 8):
            band_case(DIST_N, DIST_N, 8, k, 80, torch.float64, 130 + k)
        band_case(255, 121, 2, 3, 85, torch.float64, 136)
        # B4 on a halo that does not hold the boundary values: it passes
        # through; stencil_interior_pallas writes a bare (ny, nx) array, whose
        # rows at orders 2 and 4 are off a grid quad's 16-byte store
        for order in (8, 4, 2):
            b = order // 2
            p = config.SimParams(nx=DIST_N, ny=DIST_N, order=order)
            u = seeded_grid(p, torch.float32, 114 + order)
            u[:b] += 3.0
            u[:, -b:] -= 2.0
            band_note("stencil_full",
                      spl.run_heat_pallas(u, 3, order, p.xcfl, p.ycfl,
                                          tile_y=40),
                      spl.run_heat_pallas_plain(u, 3, order, p.xcfl, p.ycfl),
                      f"B4 {DIST_N}x{DIST_N} order {order} foreign halo tile 40")
            band_note("stencil_full",
                      spl.stencil_interior_pallas(u, order, p.xcfl, p.ycfl,
                                                  tile_y=40),
                      spl.stencil_interior_pallas_plain(u, order, p.xcfl,
                                                        p.ycfl),
                      f"B4 stencil_interior_pallas {DIST_N}x{DIST_N} order "
                      f"{order} into a bare array, foreign halo")
        band_plans = {}
        for n_sq, tile, k in [(DIST_N, t, 1) for t in (40, 80, 200, 400)] + [
                (FULL_N, BAND_TILE, k) for k in (1, 2, 4, 8)]:
            p = config.SimParams(nx=n_sq, ny=n_sq, order=8)
            row, line = band_plan(grid.make_initial_grid(p, device=dev), 8, k,
                                  tile)
            band_plans[f"{n_sq}^2 tile_y {tile} k={k}"] = row
            print(f"plan {n_sq}^2 order 8 f32 tile_y {tile} k={k}: {line}")

        # ---------------------------------------------------- 13. B8 vs library
        phase(13)
        def transpose_case(shape, dtype, tile):
            gen = torch.Generator().manual_seed(shape[0] + shape[1])
            width = shape[1] * torch.empty(0, dtype=dtype).element_size()
            x = torch.randint(0, 256, (shape[0], width), dtype=torch.uint8,
                              generator=gen).to(dev).view(dtype)
            got = tp.transpose_pallas(x, tile=tile)
            ref = x.t().contiguous()
            same = torch.equal(got.flatten().view(torch.uint8),
                               ref.flatten().view(torch.uint8))
            print(f"  vs x.t().contiguous(): B8 {shape[0]}x{shape[1]} "
                  f"{str(dtype)[6:]} tile {tile}: bitwise {same}")
            if not same:
                fail(f"B8 {shape} {dtype}: not bit for bit x.t().contiguous()")

        transpose_case((SIDE, SIDE), torch.float32, SIDE_TILE)
        transpose_case((1024, 3072), torch.float32, SIDE_TILE)
        for dtype in (torch.uint8, torch.bfloat16, torch.int32, torch.float64):
            transpose_case((2048, 768), dtype, SIDE_TILE)

        # ---------------------------------------------------- 14. the sweeps
        phase(14)
        hk = run_all.JOBS["heat_kernels"][2]
        pt = run_all.JOBS["pallas_tile"][2]
        # each heat row runs its solve twice (warm-up, timed)
        fused = [k for k in hk["ks"] if hk["iters"] % k == 0]
        per_pipe = 2 * sum(hk["iters"] // k for k in [1] + fused)
        expect = only(None, 0)
        expect.update({
            "pipeline": per_pipe, "pipeline2d": per_pipe,
            "stencil_full": 2 * hk["iters"] + 2 * pt["iters"] * len(
                [t for t in pt["tiles"] if pt["size"] % t == 0]),
            "multistep": 2 * sum(hk["iters"] // k for k in fused),
            "transpose": 1 + sweeps.TIME_ITERS})
        sweep_path = f"run_all --only {','.join(SWEEP_PATH)} (full)"
        csv_rows = {}
        with tempfile.TemporaryDirectory() as out_dir:
            rc = counted(sweep_path, expect, lambda: run_all.main(
                ["--out", out_dir, "--only", ",".join(SWEEP_PATH)]))
            for name in SWEEP_PATH:
                with open(os.path.join(out_dir, f"{name}.csv")) as f:
                    csv_rows[name] = list(csv.DictReader(f))
            with open(os.path.join(out_dir, "failures.json")) as f:
                failures = json.load(f)
            sweep_copy = shutil.copytree(out_dir, os.path.join(work, "sweeps"))
        if rc != 0 or failures != {"failed": [], "retried": []}:
            fail(f"{sweep_path}: rc {rc}, failures {failures}")
        for name, rows in csv_rows.items():
            print(f"{name}.csv ({len(rows)} rows):")
            for row in rows:
                print(f"  {json.dumps(row)}")
                if row.get("error"):
                    fail(f"{name}.csv: error row {row}")

        iters = hk["iters"]
        args = (iters, full.order, full.xcfl, full.ycfl)
        u = grid.make_initial_grid(full, device="cuda")
        ref = ops.run_heat(u, *args)
        solves = [("stencil_full", 1, lambda: spl.run_heat_pallas(
            u, *args, tile_y=BAND_TILE))] + [
            ("multistep", k, lambda k=k: spl.run_heat_multistep(
                u, *args, full.bc, k=k, tile_y=BAND_TILE)) for k in fused]
        for name, k, solve in solves:
            label = (f"{'run_heat_pallas' if k == 1 else 'run_heat_multistep'} "
                     f"{FULL_N}x{FULL_N} k={k}")
            out = counted(label, only(name, iters // k), solve)
            band_note(name, out, ref, f"{label} {iters} iters vs run_heat")

        n_band = 200
        band_timing = {}
        for name, k, _ in solves:
            if k == 1:
                fn = lambda v: spl.run_heat_pallas(  # noqa: E731
                    v, n_band, *args[1:], tile_y=BAND_TILE)
            else:
                fn = lambda v, k=k: spl.run_heat_multistep(  # noqa: E731
                    v, n_band, *args[1:], full.bc, k=k, tile_y=BAND_TILE)
            ms = core.time_fn(fn, u, warmup=1, iters=2) / n_band
            launch = roofline.Cost(step.nbytes, step.flops * k)
            b_ms, b_by = roofline.bound_ms(launch, peak, torch.float32)
            row, line = band_plan(u, full.order, k, BAND_TILE)
            band_timing.setdefault(name, []).append(
                {"k": k, "ms": ms, "bound_ms": b_ms / k, "bound_by": b_by,
                 "gbs": step.gbs(ms), "share_of_bound": b_ms / k / ms,
                 "plan": row})
            print(f"full {name} k={k} tile {BAND_TILE}: {ms:.6f} ms/step, "
                  f"{step.gbs(ms):.1f} GB/s, bound {b_ms / k:.6f} ms/step by "
                  f"{b_by} ({b_ms / k / ms:.0%}); plan: {line}")
        # B4 at the pallas_tile cells (2000², 100 steps): kernel time (CUDA
        # events) and the host-clocked solve the sweep reports, with each
        # cell's own bound
        tp_p = config.SimParams(nx=pt["size"], ny=pt["size"], order=pt["order"])
        tp_u = grid.make_initial_grid(tp_p, device=dev)
        tp_step = roofline.heat_cost(tp_p.ny, tp_p.nx, order=tp_p.order,
                                     iters=1)
        tp_bound, tp_by = roofline.bound_ms(tp_step, peak, torch.float32)
        tile_timing = []
        for tile in pt["tiles"]:
            def solve(v, tile=tile):
                return spl.run_heat_pallas(v, pt["iters"], tp_p.order,
                                           tp_p.xcfl, tp_p.ycfl, tile_y=tile)
            ms = core.time_fn(solve, tp_u, warmup=1, iters=3) / pt["iters"]
            host = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                solve(tp_u)
                torch.cuda.synchronize()
                host.append((time.perf_counter() - t0) * 1e3 / pt["iters"])
            row, line = band_plan(tp_u, tp_p.order, 1, tile)
            tile_timing.append({"tile_y": tile, "ms": ms, "host_ms": min(host),
                                "bound_ms": tp_bound, "bound_by": tp_by,
                                "share_of_bound": tp_bound / ms, "plan": row})
            print(f"B4 pallas_tile {pt['size']}^2 tile_y {tile}: {ms:.6f} "
                  f"ms/step by CUDA events, {min(host):.6f} host-clocked; "
                  f"bound {tp_bound:.6f} by {tp_by} ({tp_bound / ms:.0%}); "
                  f"plan: {line}")
        band_idle = idle_share(
            torch, lambda: spl.run_heat_pallas(tp_u, 100, tp_p.order, tp_p.xcfl,
                                               tp_p.ycfl, tile_y=BAND_TILE), 100)
        print(f"idle share, run_heat_pallas {pt['size']}x{pt['size']} tile_y "
              f"{BAND_TILE}, 100 steps: {json.dumps(band_idle)}")

        m = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (SIDE, SIDE)).astype(np.float32)).to(dev)
        t_cost = roofline.transpose_cost(SIDE, SIDE)
        t_bound, t_by = roofline.bound_ms(t_cost, peak, torch.float32)
        t_ms = per_call_ms(lambda v: tp.transpose_pallas(v, tile=SIDE_TILE), m,
                           100)
        t_plain_ms = per_call_ms(tp.transpose_pallas_plain, m, 100)
        t_library_ms = per_call_ms(lambda v: v.t().contiguous(), m, 100)
        print(f"B8 {SIDE}x{SIDE} f32: {t_ms:.6f} ms, {t_cost.gbs(t_ms):.1f} "
              f"GB/s, bound {t_bound:.6f} ms by {t_by}; plain version "
              f"{t_plain_ms:.6f} ms, x.t().contiguous() {t_library_ms:.6f} ms")

        coverage = [name for name in run_all.JOBS if name not in SWEEP_PATH]
        with tempfile.TemporaryDirectory() as out_dir:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = run_all.main(["--out", out_dir, "--quick", "--only",
                                   ",".join(coverage)])
            for name in coverage:
                with open(os.path.join(out_dir, f"{name}.csv")) as f:
                    for row in csv.DictReader(f):
                        if row.get("error") or row.get("ok") == "False":
                            fail(f"--quick {name}.csv: {row}")
        print(f"run_all --quick --only {','.join(coverage)}: rc {rc}")
        if rc != 0:
            fail(f"run_all --quick coverage run: rc {rc}")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
             "power.limit,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        print(f"card after the runs: {smi.stdout.strip()}")

        # ---------------------------------------------------- 15. old vs new
        phase(15)
        if parent is None:
            print("old-vs-new turns: not run (no --parent tree given)")
            turns = None
        else:
            turns = old_new_turns(
                parent, torch, np, config, core, grid, ops, dist, dheat, sp, spl,
                segp, (a, xx, flags, n_it, ref64,
                       lambda r, g: (relative_l2_error(r, g),
                                     relative_linf_error(r, g))))
            print(f"old-vs-new turns: {json.dumps(turns)}")

        # ---------------------------------------------------- 16. doctor, headline
        phase(16)
        out, secs = run_module(["cme213_tpu_torch", "doctor", "--json"], 300)
        doctor = json.loads(out)
        devices = doctor["stages"][0]["detail"]["devices"]
        print(f"doctor --json ({secs:.1f} s): healthy {doctor['healthy']}, "
              f"platform {doctor['platform']}, {doctor['device_count']} "
              f"device(s): {[d['kind'] for d in devices]}; liveness "
              f"{doctor['probe_ms']} ms")
        if not (doctor["healthy"] and doctor["platform"] == "cuda"
                and doctor["device_count"] == torch.cuda.device_count()
                and devices[0]["kind"] == kind):
            fail(f"doctor: {json.dumps(doctor)}")

        headline = headline_lines(kind, peak)
        # each pipeline row beside phase 4's CUDA-event time of its kernel at k
        beside = []
        for r in headline["f32"]["kernels"]:
            if not r["kernel"].startswith("pipeline"):
                continue
            entry, k = r["kernel"].split("-k")
            k = int(k)
            if r["variant"].count("tile_y=") != 1:
                fail(f"headline {r['kernel']}: variant {r['variant']}")
            want = (2 * r["calibration_iters"]
                    + r["final_runs"] * r["iters"]) // k
            if r["launches"] != {entry: want}:
                fail(f"headline {r['kernel']}: launches {r['launches']}, "
                     f"expected {want}")
            events_ms = next(t["ms"] for t in timings[entry] if t["k"] == k)
            gap = r["ms_per_iter"] / events_ms - 1
            beside.append({"kernel": r["kernel"], "variant": r["variant"],
                           "ms_per_iter": r["ms_per_iter"], "gbs": r["gbs"],
                           "pct_peak": r["pct_peak"], "iters": r["iters"],
                           "launches": want, "phase4_ms": events_ms,
                           "gap": gap})
            print(f"  {r['kernel']:<14} {r['variant']:<22} {r['ms_per_iter']:.4f}"
                  f" ms/iter host-clocked over {r['iters']} steps, "
                  f"{r['gbs']} GB/s ({r['pct_peak']}%); phase 4 CUDA events "
                  f"{events_ms:.6f}: {gap:+.1%}{'  GAP > 25%' if abs(gap) > 0.25 else ''}")
        spmv_line = headline["spmv"]
        # one child's measurement in this process: B1 launched exactly as its
        # calibration and timed runs imply
        from cme213_tpu_torch.bench import headline as hl

        for counter in counters:
            for key in counter:
                counter[key] = 0
        row = hl.measure_one("pipeline-k1", "f32")
        torch.cuda.synchronize()
        label = "headline measure_one pipeline-k1"
        paths[label] = {k: v for c in counters for k, v in c.items()}
        want = 2 * row.get("calibration_iters", 0) + \
            row.get("final_runs", 0) * row.get("iters", 0)
        print(f"launches of {label}: {paths[label]} (calibration 2 x "
              f"{row.get('calibration_iters')}, {row.get('final_runs')} x "
              f"{row.get('iters')}); {row.get('ms_per_iter')} ms/iter")
        if not row["ok"] or paths[label] != only("pipeline", want):
            fail(f"{label}: {row}, launches {paths[label]}, expected {want}")

    if "kernels" not in groups:
        # what the groups that run need from phases 1-16, made here
        phase("set-up")
        needs = set().union(*(NEEDS[g] for g in groups))
        if "pwtk" in needs:
            prob, ref64 = pwtk_problem(spmv, segp, dev)
            n_it = prob.iters
        if "dist" in needs:
            dist_p, dist_ref, vdev, mesh2d, dist_rows = dist_setup(
                config, core, dist, grid, ops, dev)
        if "b1" in needs:
            timings = b1_timing(core, grid, ops, full, dev)
        if "headline" in needs:
            headline = headline_lines(kind, peak)
        if "sweeps" in needs:
            sweep_copy = sweep_csvs(run_all, work)

    if "guarded" in groups:
        # ---------------------------------------------------- 17. guarded path
        phase(17)
        # the main path as a user reaches it: run_single at full width through
        # the ladder, cold (no verdict, no program) and then warm; the grid and
        # the timer are caught on their way out of the ladder
        core.trace.clear_events()  # also empties the program cache
        core.conformance.reset()
        real_ladder = heat2d.run_heat_resilient
        caught_runs = []

        def catch_ladder(*a, **kw):
            res = real_ladder(*a, **kw)
            caught_runs.append((res, kw["timer"].last_ms(
                kw.get("phase_label", "gpu computation shared"))))
            return res

        guarded = {}
        heat2d.run_heat_resilient = catch_ladder
        try:
            for turn, expect in (("cold", full.iters + 1 + HEAT_PROBE_LAUNCHES),
                                 ("warm", full.iters)):
                mark = len(core.trace.events())
                label = f"run_single {FULL_N}x{FULL_N} guarded {turn}"
                out = counted(label, only("pipeline", expect),
                              lambda: heat2d.run_single(full, check_cpu=False,
                                                        device="cuda"))
                if not out.ok:
                    fail(f"{label}: not ok")
                new = core.trace.events()[mark:]
                guarded[turn] = {
                    "ms": caught_runs[-1][1],
                    "probes": [e for e in new
                               if e["event"] == "conformance-probe"],
                    "misses": [e for e in new
                               if e["event"] == "program-cache-miss"],
                    "compile_ms": [e["ms"] for e in new
                                   if e["event"] == "span-end"
                                   and e["span"] == "heat.compile"],
                    "report": out.reports[1]}
        finally:
            heat2d.run_heat_resilient = real_ladder
        for res, _ in caught_runs:
            if res.rung != "pipeline" or res.demoted:
                fail(f"guarded run_single served {res.rung}, failures "
                     f"{res.failures}")
        cold, warm = guarded["cold"], guarded["warm"]
        if [(e["op"], e["rung"], e["ok"]) for e in cold["probes"]] != \
                [("heat", "pipeline", True)]:
            fail(f"guarded cold run: probes {cold['probes']}")
        if warm["probes"] or warm["misses"]:
            fail(f"guarded warm run: {len(warm['misses'])} program-cache "
                 f"misses, {len(warm['probes'])} probes (expected none)")
        guarded_ref = ops.run_heat(grid.make_initial_grid(full, device=dev),
                                   full.iters, full.order, full.xcfl, full.ycfl)
        ulp = max(max_errors(res.value, guarded_ref, limit=0)[0]
                  for res, _ in caught_runs)
        b1_ms = timings["pipeline"][0]["ms"]
        guarded_row = {
            "probe_ms": {e["rung"]: e["ms"] for e in cold["probes"]},
            "miss_ms": cold["compile_ms"], "cold_misses": len(cold["misses"]),
            "warm_misses": 0, "warm_probes": 0,
            "shared_ms_per_step": {t: g["ms"] / full.iters
                                   for t, g in guarded.items()},
            "b1_cuda_event_ms": b1_ms,
            "gap": {t: g["ms"] / full.iters / b1_ms - 1
                    for t, g in guarded.items()},
            "max_ulp_vs_run_heat": ulp}
        print(f"guarded run_single {FULL_N}x{FULL_N}: served pipeline, "
              f"undemoted; probe {guarded_row['probe_ms']} ms at first use; "
              f"program-cache misses {cold['compile_ms']} ms (heat.compile "
              f"spans: the probe's pipeline and xla programs, the solve's); "
              f"warm run: 0 misses, 0 probes; vs run_heat max ULP {ulp}")
        for turn, g in guarded.items():
            per = g["ms"] / full.iters
            print(f"  'gpu computation shared' {turn}: {per:.6f} ms/step "
                  f"({g['report']}); B1 k=1 by CUDA events (phase 4) "
                  f"{b1_ms:.6f}: gap {per / b1_ms - 1:+.2%}")

        # ---------------------------------------------------- 18. demotions
        phase(18)
        # injected faults, each in a child process of its own (its fault plan
        # read from CME213_FAULTS at start), all started together; a child
        # whose ladder raises reports the error
        child = (
            "import json, os, sys\n"
            f"sys.path.insert(0, {HERE!r})\n"
            "from cme213_tpu_torch import config, core, grid, ops\n"
            "from cme213_tpu_torch.core import programs\n"
            "from cme213_tpu_torch.ops import stencil_pipeline as sp\n"
            f"p = config.SimParams(nx={FULL_N}, ny={FULL_N}, order=8, "
            "iters=100)\n"
            "u = grid.make_initial_grid(p, device='cuda')\n"
            "plain = os.environ.get('SMOKE_PLAIN_FALLBACK') == '1'\n"
            "try:\n"
            "    res = sp.run_heat_resilient(u, p.iters, 8, p.xcfl, p.ycfl,\n"
            "                                p.bc, plain_fallback=plain)\n"
            "except core.FrameworkError as e:\n"
            "    print(json.dumps({'rung': None, 'error': str(e)[:300],\n"
            "                      'launches': dict(sp.LAUNCHES)}))\n"
            "    sys.exit(0)\n"
            "ref = ops.run_heat(u, p.iters, 8, p.xcfl, p.ycfl)\n"
            "ulp = int(core.ulp_distance(res.value.cpu().numpy(),\n"
            "                            ref.cpu().numpy()).max())\n"
            "tiles = sorted({dict(k[5]).get('tile_y') for k in programs.keys()\n"
            "                if k[1] == res.rung and k[2].startswith('4008')})\n"
            "print(json.dumps({'rung': res.rung, 'ulp': ulp,\n"
            "    'failed': [[f.rung, f.kind.value] for f in res.failures],\n"
            "    'shrunk': [[e['from_size'], e['to_size']]\n"
            "               for e in core.trace.events('chunk-shrunk')],\n"
            "    'tiles': tiles, 'launches': dict(sp.LAUNCHES)}))\n")
        picked = sp.pick_pipeline_tile(full.gy, 1, full.order)
        # a single wrong: clause perturbs the first probe only (pipeline's), so
        # pipeline2d serves; two clauses perturb both kernel rungs' probes, and
        # on the card the ladder then raises unless the caller asks for xla
        both = "wrong:heat,wrong:heat"
        plans = {("fail:heat.pipeline", False): ("pipeline2d", []),
                 ("wrong:heat", False): ("pipeline2d", []),
                 (both, False): (None, []),
                 (both, True): ("xla", []),
                 ("oom:heat.pipeline", False): ("pipeline",
                                                [[picked, picked // 2]])}
        procs = {}
        for plan, plain in plans:
            child_env = dict(env, CME213_FAULTS=plan,
                             SMOKE_PLAIN_FALLBACK="1" if plain else "0")
            procs[plan, plain] = subprocess.Popen(
                [sys.executable, "-c", child], cwd=HERE, env=child_env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                start_new_session=True)
        demotions = {}
        for (plan, plain), proc in procs.items():
            name = f"{plan}{' plain_fallback' if plain else ''}"
            try:
                stdout, stderr = proc.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                for other in procs.values():
                    if other.poll() is None:
                        os.killpg(other.pid, signal.SIGKILL)
                        other.communicate()
                fail(f"demotion child {name}: no result in 300 s")
            if proc.returncode != 0:
                fail(f"demotion child {name}: rc {proc.returncode}\n"
                     f"{stderr[-3000:]}")
            row = json.loads(stdout.strip().splitlines()[-1])
            demotions[name] = row
            want_rung, want_shrunk = plans[plan, plain]
            if want_rung is None:
                print(f"CME213_FAULTS={name}: raised ({row['error']}), "
                      f"launches {row['launches']}")
                if row["rung"] is not None or "all 2 rungs of heat" not in \
                        row["error"]:
                    fail(f"{name}: {row}, expected the ladder to raise")
                continue
            print(f"CME213_FAULTS={name}: served {row['rung']} (failed "
                  f"{row['failed']}), tile_y {row['tiles']}, shrunk "
                  f"{row['shrunk']}, vs run_heat max ULP {row['ulp']}, "
                  f"launches {row['launches']}")
            if row["rung"] != want_rung or row["ulp"] != 0 or \
                    row["shrunk"] != want_shrunk:
                fail(f"{name}: {row}, expected {want_rung} at 0 ULP, shrunk "
                     f"{want_shrunk}")
            kernel = {"pipeline": "pipeline", "pipeline2d": "pipeline2d"}.get(
                want_rung)
            if kernel and row["launches"][kernel] < 100:
                fail(f"{name}: the serving kernel {kernel} was not launched")
        if demotions["oom:heat.pipeline"]["tiles"] != [str(picked // 2)]:
            fail(f"oom: served at tile_y {demotions['oom:heat.pipeline']}")

        # ---------------------------------------------------- 19. SpMV ladder
        phase(19)
        # pwtk through the ladder, cold again (phase 17 emptied the verdicts
        # and the programs): the gate's probe, the warm-up iteration, the solve
        label = f"run_spmv_scan {SUITE} pallas-fused guarded"
        out = counted(label, only("spmv_fused", n_it + 1 + scan_probe),
                      lambda: spmv.run_spmv_scan(prob, kernel="pallas-fused",
                                                 device=dev))
        ev = served("spmv_scan")
        rel_l2 = relative_l2_error(ref64, out)
        rel_linf = relative_linf_error(ref64, out)
        print(f"{label}: served {ev['rung']} (demoted {ev['demoted']}), vs f64 "
              f"plain: rel L2 {rel_l2:.3e}, rel Linf {rel_linf:.3e}")
        if ev["rung"] != "pallas-fused" or ev["demoted"] or not (
                rel_l2 <= 1e-4 and rel_linf <= 1e-3):
            fail(f"{label}: {ev}, rel L2 {rel_l2}, rel Linf {rel_linf}")
        spmv_guarded = {"pwtk": {"rung": ev["rung"], "rel_l2": rel_l2,
                                 "rel_linf": rel_linf}}
        with tempfile.TemporaryDirectory() as out_dir:
            os.chdir(out_dir)
            try:
                if spmv.main(["spmv_scan", "gen", "a.txt", "x.txt"]) != 0:
                    fail("spmv_scan gen")
                gen = spmv.load_problem("a.txt", "x.txt")
                exact = spmv.run_spmv_scan(gen, kernel="pallas-fused",
                                           device=dev)
                mark = len(core.trace.events())
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc = spmv.main(["spmv_scan", "a.txt", "x.txt", "cpu_check",
                                    "--kernel=pallas-fused", "--canonical"])
                padded = np.loadtxt("b.txt", dtype=np.float32)
            finally:
                os.chdir(cwd)
        pad_probes = [e for e in core.trace.events()[mark:]
                      if e["event"] == "conformance-probe"
                      and e["op"] == "spmv_scan.pad"]
        n_to = core.programs.canonical_size(gen.n)
        print(f"spmv_scan CLI --canonical gen n={gen.n} -> bucket {n_to}: rc "
              f"{rc}, bucket gate {[(e['rung'], e['ok']) for e in pad_probes]},"
              f" bitwise equal to the unpadded solve: "
              f"{np.array_equal(padded, exact)}")
        if rc != 0 or "Worked!" not in buf.getvalue() or \
                [(e["rung"], e["ok"]) for e in pad_probes] != \
                [("pallas-fused", True)] or not np.array_equal(padded, exact):
            fail(f"--canonical: rc {rc}, probes {pad_probes}\n{buf.getvalue()}")
        if not any(k[2] == f"n{n_to}/i{gen.iters}"
                   for k in core.programs.keys()):
            fail("--canonical did not solve in its bucket")
        # on the card a kernel demotes only to the other kernel (B7 to B6), and
        # to flat, the gate's reference, only when the caller asks; each
        # demoted result is held to the CLI's own bounds of the f64 golden
        both = "fail:spmv_scan.pallas-fused,fail:spmv_scan.pallas"
        fail_cases = (("fail:spmv_scan.pallas-fused", False, "pallas"),
                      (both, False, None), (both, True, "flat"))
        for plan, plain, want in fail_cases:
            name = f"{plan}{' plain_fallback' if plain else ''}"
            marked = len(core.trace.events("served"))
            try:
                with core.faults.injected(plan):
                    out = spmv.run_spmv_scan(gen, kernel="pallas-fused",
                                             plain_fallback=plain, device=dev)
            except core.FrameworkError as e:
                print(f"CME213_FAULTS={name}: raised ({str(e)[:200]})")
                if want is not None or "all 2 rungs of spmv_scan" not in str(e) \
                        or len(core.trace.events("served")) != marked:
                    fail(f"{name}: raised {e}")
                spmv_guarded[name] = {"rung": None}
                continue
            ev = served("spmv_scan")
            errs = spmv.external_check(gen, out)
            print(f"CME213_FAULTS={name}: served {ev['rung']} (failed "
                  f"{ev['failed_rungs']}); vs f64: rel L2 "
                  f"{errs['rel_l2']:.3e}, rel Linf {errs['rel_linf']:.3e}")
            if ev["rung"] != want or not (errs["rel_l2"] <= 1e-4
                                          and errs["rel_linf"] <= 1e-3):
                fail(f"{name}: {ev}, {errs}, expected {want} within the CLI's "
                     f"bounds")
            spmv_guarded[name] = {"rung": ev["rung"], **errs}
        spmv_guarded.update(canonical={"n": gen.n, "bucket": n_to,
                                       "bitwise": True})

        # ---------------------------------------------------- 20. hw5 gates
        phase(20)
        core.conformance.reset()
        mark = len(core.trace.events())
        label = (f"run_distributed_heat {DIST_N}x{DIST_N} 2x2 pallas "
                 f"conformance")
        out = counted(label, only("local", DIST_ITERS + DIST_PROBE_LAUNCHES),
                      lambda: dist.run_distributed_heat(dist_p, mesh2d,
                                                        local_kernel="pallas"))
        new = core.trace.events()[mark:]
        probes = [(e["rung"], e["ok"]) for e in new
                  if e["event"] == "conformance-probe"]
        demoted = [e for e in new if e["event"] == "rung-failed"]
        ulp, err = max_errors(torch.from_numpy(out), dist_ref, limit=0)
        print(f"{label}: probes {probes}, demotions {len(demoted)}, vs the "
              f"1-device run_heat max ULP {ulp}")
        if probes != [("pallas-k1", True)] or demoted:
            fail(f"{label}: probes {probes}, demotions {demoted}")
        _, mode = dist.make_iterated_sharded_scan_gated(
            dist.make_mesh_1d(devices=vdev))
        print(f"make_iterated_sharded_scan_gated on {DIST_SHARDS} shards: "
              f"serves {mode}")
        if mode != "ring":
            fail(f"the gated sharded scan served {mode}")

        # ---------------------------------------------------- 21. tune
        phase(21)
        from cme213_tpu_torch import tune_cli
        from cme213_tpu_torch.core import tune

        tune_iters = 100
        with tempfile.TemporaryDirectory() as tune_dir:
            os.environ[tune.CACHE_ENV] = os.path.join(tune_dir, "tune.json")
            tune.reset()
            try:
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc = tune_cli.main([
                        "run", "--op", "heat", "--gy", str(FULL_N), "--gx",
                        str(FULL_N), "--order", str(FULL_ORDER), "--k", "1",
                        "--heat-iters", str(tune_iters), "--runs", "5",
                        "--json"])
                if rc != 0:
                    fail(f"tune run --op heat: rc {rc}\n{buf.getvalue()}")
                (tune_rep,) = json.loads(buf.getvalue())
                tune.reset()  # the winner comes back from the disk cache
                core.programs.reset()  # only the next solve's programs
                mark = len(core.trace.events())
                u = grid.make_initial_grid(full, device=dev)
                res = sp.run_heat_resilient(u, tune_iters, full.order,
                                            full.xcfl, full.ycfl, full.bc)
                hits = [e for e in core.trace.events()[mark:]
                        if e["event"] == "tune-hit" and e["op"] == "heat"]
            finally:
                del os.environ[tune.CACHE_ENV]
                tune.reset()
        win = tune_rep["winner"]
        print(f"tune run --op heat {tune_rep['shape_class']} on "
              f"{tune_rep['device']}: winner {win['candidate']} "
              f"{json.dumps(win['statics'])}")
        for t in tune_rep["trials"]:
            print(f"  {t['candidate']:<24} median {t['ms'] / tune_iters:.6f} "
                  f"ms/step over {tune_iters} steps (device-synchronised), "
                  f"ok {t['ok']}")
        if not all(t["ok"] for t in tune_rep["trials"]) or len(
                tune_rep["trials"]) != 1 + 3:
            fail(f"tune: {tune_rep}")
        ty_run = {dict(k[5]).get("tile_y") for k in core.programs.keys()
                  if k[1] == res.rung and k[2] == tune_rep["shape_class"]
                  and dict(k[5]).get("iters") == str(tune_iters)}
        print(f"run_heat_resilient with open tiles: tune-hit {hits[-1:]}, "
              f"served {res.rung} at tile_y {sorted(ty_run)}")
        if not hits or (win["statics"] and ty_run != {
                str(win["statics"]["tile_y"])}):
            fail(f"the tuned winner did not serve: hits {hits}, tiles {ty_run}")

        # ---------------------------------------------------- 22. calibrate
        phase(22)
        calibration = calibrate()

        # ---------------------------------------------------- 23-27. runners
        core.trace.clear_events()
        runners = runner_phases(counted, only, prob, ref64, work)
        flight_dump = runners.pop("flight_dump")
        lines["runners"] = runners
    if "tooling" in groups:
        if "guarded" not in groups:
            phase("set-up")
            calibration = calibrate()
            flight_dump = flight_child(kind, work)["flight_dump"]
        # ------------------------------------------------ 28. telemetry
        phase(28)
        lines["telemetry"] = telemetry_phase(counted, only, paths, work,
                                             ident, prob, headline,
                                             flight_dump, sweep_copy)
        # ------------------------------------------------ 29. hw1/hw3/hw4
        phase(29)
        lines["workloads"] = workloads_phase(counted, only, paths, work,
                                             ident, calibration)

    # ---------------------------------------------------- 30. the gang
    if "gang" in groups:
        phase(30)
        gang = gang_phase(counted, only, paths, work, dist_p, dist_ref,
                          dist_rows, vdev, prob, ref64)
        lines["gang"] = gang

    # ---------------------------------------------------- 31. serving
    if "serving" in groups:
        phase(31)
        lines["serving"] = serving_phase(counted, only, paths, work, ident,
                                         prob)

    # ---------------------------------------------------- 32. the fleet
    if "fleet" in groups:
        phase(32)
        lines["fleet"] = fleet_phase(counted, only, paths, work, ident)

    # ---------------------------------------------------- 33. four cards
    if "multicard" in groups:
        phase(33)
        lines["multicard"] = multicard_phase(counted, only, paths, work,
                                             ident, prob, ref64)
    phase(None)

    # ---------------------------------------------------- summary lines
    kernels = None
    if "kernels" in groups:
        # launches: the full-size path a user reaches each kernel by (B1 through
        # run_single behind the ladder, cold: its gate's probe included; B2
        # through its own entry point at k = 1; B6 and B7 through run_spmv_scan
        # at pwtk)
        main_path = {"pipeline": f"run_single {FULL_N}x{FULL_N} guarded cold",
                     "pipeline2d": f"run_heat_pipeline2d {FULL_N}x{FULL_N} k=1",
                     "local": f"run_distributed {DIST_N}x{DIST_N} 2d sync "
                              f"pallas",
                     "segscan": f"run_spmv_scan {SUITE} pallas",
                     "spmv_fused": f"run_spmv_scan {SUITE} pallas-fused",
                     "stencil_full": sweep_path, "multistep": sweep_path,
                     "transpose": sweep_path}
        for name, path in main_path.items():
            if paths[path][name] <= 0:
                fail(f"kernel {name} was not launched on the main path")

        def by_path(name):
            return {label: seen[name] for label, seen in paths.items()
                    if seen[name]}

        kernels = []
        for name in entries:
            k1 = timings[name][0]
            kernels.append({
                "name": f"heat_ksteps ({name})", "route": "cuda",
                "source": SOURCE[name], "replaces": REPLACES[name],
                "launches": paths[main_path[name]][name],
                "main_path": main_path[name],
                "launches_by_path": by_path(name),
                "max_abs_err": worst_err[name], "max_ulp": worst_ulp[name],
                "ms": k1["ms"], "plain_ms": plain_ms, "bound_ms": k1["bound_ms"],
                "bound_by": k1["bound_by"], "library_ms": library_ms,
                "unit": f"ms per step, {FULL_N}x{FULL_N} order {FULL_ORDER} "
                        f"f32, k=1", "per_k": timings[name]})
        kernels[0]["headline"] = [b for b in beside
                                  if b["kernel"].startswith("pipeline-")]
        kernels[1]["headline"] = [b for b in beside
                                  if b["kernel"].startswith("pipeline2d-")]
        k1 = local_timing[0]
        kernels.append({
            "name": "heat_ksteps (local)", "route": "cuda",
            "source": SOURCE["local"], "replaces": REPLACES["local"],
            "launches": paths[main_path["local"]]["local"],
            "main_path": main_path["local"],
            "launches_by_path": by_path("local"),
            "max_abs_err": local_err, "max_ulp": local_ulp,
            "ms": k1["ms"], "plain_ms": local_plain_ms,
            "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
            "library_ms": local_library_ms,
            "unit": f"ms per step (one launch on the 2x2 mesh's four padded "
                    f"blocks), {DIST_N}x{DIST_N} order 8 f32, k=1",
            "per_k": local_timing, "paths": dist_rows, "idle_share": idle})
        scan_rows = {
            "segscan": (b6_ms, b6_plain_ms, b6_bound, b6_by,
                        f"ms per scan, {SUITE} n={n} f32"),
            "spmv_fused": (spmv_rows["pallas-fused"]["ms"], b7_plain_ms,
                           it_bound, it_by,
                           f"ms per iteration, {SUITE} n={n} f32")}
        for name, (ms, p_ms, b_ms, b_by, unit) in scan_rows.items():
            kernels.append({
                "name": f"segmented_scan ({name})", "route": "cuda",
                "source": SOURCE[name], "replaces": REPLACES[name],
                "launches": paths[main_path[name]][name],
                "main_path": main_path[name],
                "launches_by_path": by_path(name),
                "max_abs_err": scan_err[name], "max_ulp": scan_ulp[name],
                "ms": ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None, "library_note": NO_LIBRARY,
                "cumsum_yardstick_ms": cumsum_ms, "unit": unit,
                "headline": [r for r in spmv_line["kernels"]
                             if SCAN_KERNELS.get(r["kernel"]) == name]})
        kernels[-1]["paths"] = spmv_rows  # B7's row: every kernel at pwtk
        # B4 and B5: per step at 4000² order 8 f32 tile 200 (B5 at k = 2);
        # their plain versions are run_heat and run_heat_roll, phase 4's
        band_rows = {"stencil_full": (band_timing["stencil_full"], torch_ms),
                     "multistep": (band_timing["multistep"], plain_ms)}
        for name, (per_k, p_ms) in band_rows.items():
            first = per_k[0]
            kernels.append({
                "name": f"heat_band ({name})", "route": "cuda",
                "source": SOURCE[name], "replaces": REPLACES[name],
                "launches": paths[main_path[name]][name],
                "main_path": main_path[name],
                "launches_by_path": by_path(name),
                "max_abs_err": band_err[name], "max_ulp": band_ulp[name],
                "ms": first["ms"], "plain_ms": p_ms,
                "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
                "library_ms": library_ms,
                "unit": f"ms per step, {FULL_N}x{FULL_N} order {FULL_ORDER} "
                        f"f32, tile_y {BAND_TILE}, k={first['k']}",
                "per_k": per_k})
        # B4's row: the sweeps' CSVs, the pallas_tile cells by CUDA events and
        # host clock, the idle share of a 2000² solve; both rows: the plans
        kernels[-2].update(sweep_rows=csv_rows, pallas_tile=tile_timing,
                           idle_share=band_idle)
        kernels[-2]["plans"] = kernels[-1]["plans"] = band_plans
        kernels.append({
            "name": "transpose_tiles", "route": "cuda",
            "source": SOURCE["transpose"], "replaces": REPLACES["transpose"],
            "launches": paths[main_path["transpose"]]["transpose"],
            "main_path": main_path["transpose"],
            "launches_by_path": by_path("transpose"),
            "max_abs_err": 0.0, "max_ulp": 0,
            "ms": t_ms, "plain_ms": t_plain_ms, "bound_ms": t_bound,
            "bound_by": t_by, "library_ms": t_library_ms,
            "unit": f"ms per transpose, {SIDE}x{SIDE} f32"})
        if turns is not None:
            for row in kernels[:-1]:  # every kernel but B8
                row["turns"] = turns
    if kernels is not None:
        # the other groups' numbers on the kernels they read
        row = {r["name"]: r for r in kernels}
        if "guarded" in groups:
            row["heat_ksteps (pipeline)"]["guarded"] = dict(
                guarded_row, demotions=demotions, tune=tune_rep)
            row["segmented_scan (spmv_fused)"]["guarded"] = spmv_guarded
        if "gang" in groups:
            row["heat_ksteps (local)"]["gang"] = gang["a"]["ranks"]
    for name, value in lines.items():
        print(json.dumps({name: value, "card": ident} if name == "gang"
                         else {name: value}))
    for name, secs in PHASE_SECONDS.items():
        print(f"phase {name}: {secs:.1f} s")
    print(json.dumps({"phase_seconds": PHASE_SECONDS}))
    print(f"chip_smoke wall time: {time.perf_counter() - t_script:.1f} s")
    print(ident)
    if kernels is not None:
        print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())