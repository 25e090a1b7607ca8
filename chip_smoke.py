#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (multiverso_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. device  — the card's name, count and power limit.
2. build   — compiles the three flash-attention kernels from
             ``multiverso_tpu_torch/ops/csrc`` (one nvcc each, in parallel)
             and reports, per kernel, ptxas's registers and spill bytes
             and the SASS counts of HGMMA (wgmma), UTMALDG (TMA loads) and
             LDL/STL (local memory) from ``cuobjdump -sass``.  Each
             library must hold its bf16 Hopper kernels (all three at D
             32, 64, 128 and 256) and its float32 plane kernels (D 64,
             128 and 256; dq and dk/dv at 32 too), each of them with HGMMA
             and UTMALDG and no bytes spilled.
3. parity  — each kernel against its plain PyTorch version on the card:
             the trainer's attention shape (B=4, H=16, T=2048, D=128, bf16,
             causal, nonzero lse cotangent), small ragged shapes (T=200)
             in float32 and bf16, causal and not, every head dim,
             cross-length cases (not causal: Tq=40, Tk=136 at D 64; in
             bf16 at D 128 both Tq=40, Tk=136 and Tq=136, Tk=40), and the
             edges of the 128-row Hopper tiles in bf16: T=2112 (a
             half-full last tile), T=130 at D 64 and 128 causal and not (a
             second tile of 2 rows), and one head at T=2048; the same
             edges at D 32 and 256 (T=2112 and T=130, and for D 256's
             64-row tiles T=2080 and T=66; Tq≠Tk both ways); and bh 65,600
             at T 64, D 32, causal, in bf16 and float32 (past grid y's
             65,535).  The float32 plane design (all three at D 64 and
             128): the trainer's attention shape in float32 (nonzero lse
             cotangent) and 8 heads at T=8192, whose o, lse, dq, dk and
             dv must also stay within 8x the plain version's largest
             error against float64; T=2080 (a half-full last 64-row
             tile), T=2112 (a half-full last 128-row tile), T=66 and
             T=130 causal and not (a last block or second tile of 2 rows)
             and Tq≠Tk both ways at D 64 and 128; T=2064 at D 128 (a
             half-full 32-row block); one head at T=2048.  All three at
             D 256 (q, q and do, or k and v float32, split in registers):
             8 heads at T=8192 under the same float64 gate, T=2080 and
             T=66 (the 64-row tiles' edges), T=130 (the forward's second
             tile of 2 rows) and Tq≠Tk both ways.  All three at D 32:
             8 heads at T=8192 under the same float64 gate, T=2080,
             2112, 66 and 130 and Tq≠Tk both ways.
             Each output is judged by its own dtype: float32 outputs
             (lse, and every output of a float32 case) element by element
             at atol = rtol = 1e-4; bf16 outputs by their error relative
             to the output's scale, max|got-want| / max|want| and
             ||got-want|| / ||want||, each at most 1e-2.  Two planted
             faults at the trainer's shape (the causal diagonal dropped,
             one future key admitted) must fail that test.
4. trainer — ``TransformerTrainer`` at the full width of the repo's
             largest dense config (bench_transformer_large: vocab 32768,
             dim 2048, 16 heads, hidden 5632, 16 layers, bf16, seq 2048,
             SGD), runs of 5 steps from one draw of the float32 masters
             (``TransformerTrainer(params=...)``): no remat at batch 4
             (the continuity line), remat "dots" at batch 4
             (``transformer_large_tokens_per_sec``), no remat at batch 8
             (the batch of 4 twice) and full remat at batch 8
             (``transformer_large_fullremat_tokens_per_sec``).  Each loss
             trajectory must be finite and fall, each remat run's stay
             within 1e-3 of the no-remat run's and its parameters' change
             within 1e-3 of the no-remat run's at its batch, the kernels
             at the batch of 8's attention shape (bh 128) must agree
             with their plain versions, and the kernels launch per layer
             and step: the forward once (twice under full remat, whose
             backward recomputes it; "dots" keeps its output), dq and
             dkv once.
   profile — one more step under torch.profiler: device time by kernel
             class (flash kernels, matrix products, other) and the
             device's busy share of the step.
5. check   — a small trainer on the card against the same trainer on the
             CPU (plain attention): loss trajectories within 2e-2.
6. timing  — each kernel at the trainer's shape with CUDA events, beside
             its plain version, its bound (with the achieved TFLOP/s and
             the bound's share of the time), and PyTorch's flash attention
             as a yardstick that the port never calls.
   small   — bench_transformer (vocab 8192, dim 512, 4 layers, 8 heads of
             64, hidden 1408, batch 8, seq 2048, no remat): 5 steps
             (``transformer_tokens_per_sec``), one ``accum=2`` step
             against one ``accum=1`` step from the same weights (loss and
             every parameter's change within 2e-2), and the kernels at
             its attention shape (D 64): parity and timing as above.
   headdims — the Hopper designs at D 256 and D 32 and the float32 plane
             design on the trainer's path: transformer_large's widths with
             8 heads of 256 (the trainer's masters, bf16, SGD, no remat,
             batch 4, seq 2048), bench_transformer's with 16 heads of 32
             (batch 8, seq 2048), transformer_large in float32 (16
             heads of 128, and 8 heads of 256, the same masters and
             batch) and bench_transformer's in float32 with 16 heads of
             32, 5 steps each (finite, falling losses, every kernel
             launched once a layer and step), the kernels at [4, 8, 2048,
             256], [8, 16, 2048, 32], [4, 16, 2048, 128] float32, [4, 8,
             2048, 256] float32 and [8, 16, 2048, 32] float32 against
             their plain versions (float32
             also against float64, as in parity) and
             timed (beside each bound the exp unit's: one exp a kept
             score at 16 a clock an SM; the float32 kernels bound at six
             bf16 products a product with the split's time alone and
             its share, timed with CUDA events, FP32 and TF32 bounds
             beside).
   moe     — bench_moe (vocab 16384, dim 1024, 8 layers, 8 heads, hidden
             2816, 8 experts, top-2, capacity factor 1.25, full remat,
             batch 8, seq 1024): 5 steps with each dispatch from one draw
             (``moe_dense_tokens_per_sec``,
             ``moe_capacity_tokens_per_sec``, ``moe_capacity_vs_dense``);
             one MoE layer's forward and backward with each dispatch
             must not make the host wait for the card
             (``torch.cuda.set_sync_debug_mode("error")``); the kernels
             at its attention shape (bh 64, T 1024, D 128, bf16, causal)
             against their plain versions; then a seeded 2-layer
             float32 copy on the card and on the CPU: the capacity
             dispatch with room for every route drops none and equals
             the dense one, each layer's dropped routes at capacity
             factors 1.25 and 0.5 match, the aux losses agree within
             1e-5 and the logits within 1e-4 of their scale.
   longctx — bench_long_context (vocab 8192, dim 1024, 4 layers, 8 heads
             of 128, hidden 2816, batch 1, seq 16,384, full remat): 5
             steps (``longctx_tokens_per_sec``, ``longctx_seq``), the
             kernels at T 16,384 against their plain versions at bh 2,
             and their times at bh 8.  Then bench_long_context's seq
             65,536 run (the same model, batch 1, 5 steps,
             ``longctx64k_tokens_per_sec``), the single-device path that
             sequence parallelism extends, with the kernels at T 65,536
             against their plain versions at bh 2 (the plain versions
             taken in blocks of 4,096 query rows or key columns, since
             one head's [T, T] float32 scores hold 16 GiB).
   mesh    — the transformer's mesh code on the card: (1) the trainer's
             full-width config over ``torch.distributed`` with NCCL at
             world size 1, on a mesh ("dp", "sp", "tp") of sizes 1, 3
             SGD steps from the same masters as the no-mesh trainer: every
             parameter and every loss equal to the no-mesh run's, bit for
             bit (the vocabulary-parallel cross-entropy included; see
             ``_VocabCE``), step times side by side; (2) the ring's
             compute at sp 4 in one process: every virtual rank's
             schedule (``ring_attention_shard``) through an in-process
             rotation (``InProcessRing``) at bench_long_context's
             attention shape [1, 8, 16384, 128] bf16 in both layouts, o,
             lse, dq, dk and dv held against single-device attention by
             the parity criterion, and again in float32 at [2, 4, 2048,
             64]; the kernel launches per virtual rank, and each
             kernel's launches by piece shape as its wrapper counts them
             (``launch_shapes``), must be the schedule's; the ring's time
             beside single-device attention's; then each kernel at each
             of the ring's piece shapes at T
             16,384 (contiguous: 4,096 x 4,096 causal and full; zigzag:
             2,048 x 2,048 causal and full, 4,096 x 2,048 and 2,048 x
             4,096) against its plain version, timed beside its bound and
             the library call; (3) a planted fault: a rotation that hands
             each rank the blocks of the rank one further back must fail
             check (2), in both layouts.
   moe_mesh — MoE and the ep axis on a mesh: (1) bench_moe (E 8, top-2,
             capacity factor 1.25, full remat, batch 8, seq 1024, bf16)
             at its full width through the mesh code over NCCL at world
             size 1, a mesh ("dp", "sp", "tp", "ep") of 1s, each
             dispatch 3 SGD steps against the no-mesh trainer from the
             same draw: every loss and parameter bit for bit, and one
             MoE layer's forward and backward through the mesh path
             must not make the host wait for the card; (2) the
             moe phase's 2-layer float32 copy at its check shape (batch
             2, seq 256) at capacity factor 1.0 on 2 gloo ranks sharing
             the card (an NCCL rank per card with two cards, four ranks
             with four: ``moe_layout``), each a process of this script
             (``--moe-rank``), on (ep 2) and (dp 2) (four ranks: (dp 2,
             ep 2) and (ep 4)), each dispatch 3 momentum steps held
             against the same steps in one process on the card: losses
             at rtol 1e-5, every gathered parameter and updater slot at
             rtol 1e-5 with a floor at 1e-5 of its largest entry; the
             capacity runs must drop routes; (3) three planted faults
             (``planted_moe_fault``) must fail check (2): a per-rank slot
             order, a per-rank load-balancing loss, the routers'
             gradients also summed over ep; (4) bench_transformer's
             config with momentum, 3 steps with the state offloaded to
             ``OffloadedState(backend="local")`` against 3 in memory, bit
             for bit, both step times.
   shard   — tables sharded across ranks: one NCCL rank per card with
             two cards or more, else 2 gloo ranks sharing the card
             (tables on the card, collectives staged through the host),
             each a process of this script (``--shard-rank``).  Every
             rank checks, against numpy, each table's change from a
             random start: ArrayTables of 16 Mi float32 (bench_add_get's)
             under SGD and AdaGrad, ASP and BSP (invisible before the
             barrier), at lr 0.1; the word2vec MatrixTable (100,000 x
             128, SGD) and a 1,048,576 x 128 AdaGrad MatrixTable (512
             MiB of data and 512 MiB of state), each by ``add_rows`` of
             8,192 ids a rank (duplicates, overlapping between ranks) at
             word2vec's step size, ``get_rows`` of other ids and the
             whole ``get()``: max |got - want| over max |want - start| at
             most 1e-5.  Each rank's ``_data`` and state hold
             ``ceil(rows / W)`` rows, and ``torch.cuda.memory_allocated``
             grows by exactly their bytes when a table is made.  LR's 20
             fused steps (phase 8's shape) and word2vec's fused steps
             (phase 10's batch, SGD and AdaGrad) on sharded tables match
             the same steps in one process on the card within 1e-4 of the
             change.  A planted fault, one rank's shard offset off by one
             row, must fail the row check.  Add/get and row rates and
             each rank's bytes are reported.
             Each of trainer, small, moe and longctx reports step times
             (mean of steps 2-5), peak memory and its own launch counts,
             and each new run a profile of one more step (the device's
             busy share, launches, the top kernels).
7. tables  — the parameter-server path on the card: ``init()`` with no
             device (so ``cuda:0``), then ArrayTables of 16,777,216
             float32 (64 MiB, the size of ``bench.py``'s add/get bench),
             each held against the same operations in numpy on the host
             at 1e-6 of the largest entry: host adds and gets through
             ``sgd`` and ``adagrad``, a device-tensor add with
             ``get(device=True)``, a BSP table whose two adds are
             invisible before ``barrier()`` and applied after it, and one
             1-bit add against ``dequantize_1bit`` of the same payload.
             Then the add/get rates: device-resident (CUDA events, with
             the bytes each op moves over 3.35 TB/s as its bound and the
             share reached) and host (host clock, numpy in and out), and
             the peak device memory.
8. lr      — ``LogisticRegression(784, 10)`` on 8192 synthetic samples
             (``bench.py``'s LR shape): 20 fused steps on the card and the
             same 20 on the CPU (a second ``init`` lifecycle), loss
             trajectories within rtol 1e-4 and falling; one push-pull
             ``train_batch`` against one fused step from the same start,
             within rtol 1e-4 / atol 1e-5; then
             ``lr_fused_samples_per_sec`` (CUDA events over 100 queued
             steps) and ``lr_pushpull_samples_per_sec`` (host clock, 5
             iterations).
9. rows    — the row path on the card: ``MatrixTable``s of 100,000 x 128
             float32 (``bench.py``'s word2vec table), each held against
             numpy at 1e-6 of the largest entry: ``add_rows``/``get_rows``
             of 8,192 ids with duplicates and ids past the table through
             ``sgd`` and ``adagrad``, a whole-matrix device add with
             ``get(device=True)``, BSP row adds invisible before
             ``barrier()`` and applied after it, a ``SparseMatrixTable``
             whose cached rows change after an ``add_rows``, and a
             ``KVTable`` add/get; and every updater's row apply straight
             from tensors on the card (``apply_rows`` with a mask, and
             ``scatter_apply`` with duplicates, as the fused steps call
             it; ids past the table in both) against the same call on the
             CPU, and sgd's and adagrad's against numpy; ``assign``'s
             ``apply_rows`` of 8,192 ids, each repeated 2-4 times with
             its own values, some masked and some past the table, against
             the CPU and numpy's last write, exactly (it also reports how
             many rows a plain ``index_put_`` gives another value).  Then a
             checkpoint of those tables restored into fresh ones,
             exactly.  It reports what one ``add_rows`` of 8,192 rows
             allocated on the card, which must stay below the table's own
             bytes (the add is in place).
10. w2v    — ``SkipGram(100_000, 128, negatives=5)`` on ``bench.py``'s
             word2vec batch (8,192 pairs, seed 0).  Each check starts
             from an output table drawn like the input table and runs at
             word2vec's per-pair step size (sgd at 0.025 x 8,192 on the
             mean loss, adagrad at 0.025 with eps 1e-6), and holds each
             table and updater state by its change: max |got - want|
             over max |want - start| at most 1e-4.  The checks: 20 sgd and 5
             adagrad fused steps on the card, under
             ``torch.cuda.set_sync_debug_mode("error")``, against the
             same steps on the CPU (a second ``init`` lifecycle), losses
             within rtol 1e-4 and falling; one push-pull ``train_batch``
             against one fused step from the same start, for each
             updater; ``train_epoch_fused`` (prefetch on a side stream)
             against the same batches placed one by one.  Then, at
             ``bench.py``'s lr 0.025, ``w2v_fused_pairs_per_sec`` (CUDA
             events over 100 queued steps) and
             ``w2v_pushpull_pairs_per_sec`` (host clock, 5 iterations
             after 2), a profile of 20 fused steps and the peak device
             memory; last ``DLRMRecommender`` (32,768 users and items,
             dim 16, zipf 1.0, 0.05 per pair): 10 ``train_step``s of 512
             pairs, the table's change and the losses card against CPU
             within 1e-4.  The SGNS kernel (``ops/csrc/sgns.cu``): one
             launch a fused step (its launch count over the card's 20 sgd
             and 5 adagrad steps), its loss and gradients against the
             plain version at [131,072, 300, K 5] (the benchmark's cell),
             [8,192, 128, K 5] and a ragged [1,001, 7, K 3] (``SGNS_CASES``,
             within ``SGNS_RTOL``), and its times at the first two
             (``sgns_times``: ms, the bytes bound, the plain version's ms
             and autograd's chain with the cat it needed, the yardstick).
11. lda    — ``LightLDA`` at ``bench.py``'s shape (bench_lightlda: 2,048
             docs of 64 tokens, V 10,000, K 64, alpha 0.5, beta 0.1).  One
             fused and one MH sweep (4 steps) on the card against the same
             sweeps on the CPU, each from ``initialize_counts``, with the
             same draws made once on the host: at most 1e-3 of the tokens
             may take another topic (a comparison on a rounding boundary
             can flip), and after every sweep the counts are conserved
             exactly (each doc-topic row sums to its doc's length, the
             topic totals to the token count, the word-topic columns to the
             topic totals).  One ``sample_pass`` on 256 of the docs, card
             against CPU, exactly.  Topic recovery: 25 MH sweeps at the
             planted-topic test's setting (60 docs, V 80, K 4,
             concentration 0.05) reach ``topic_purity`` > 0.6.  Then
             ``bench.py``'s rates (the median of 3 sweeps after one
             warm-up, host clock, each sweep ending in a synchronize):
             ``lda_tokens_per_sec`` (fused, K 64) and
             ``lda_mh_k{1024,8192}_tokens_per_sec``; for each, the
             launches and the device's busy share of one profiled sweep,
             the conserved counts after the timed sweeps, and for the MH
             sweeps the bound of their [V, K] passes (``mh_bound_bytes``
             over 3.35 TB/s) and its share of the sweep; the peak device
             memory.
12. sgmix  — ``SkipGramMixture`` at ``bench_w2v``'s vocabulary and width
             (V 100,000, dim 128, 2 senses, window 5, 5 negatives), 20
             batches of 1,024 occurrences drawn by ``batches`` from
             ``synthetic_corpus(20_480, 100_000, seed=0)``.  The checks run
             sgd at the mixture's own 0.05 per occurrence (lr 51.2 on the
             batch-mean loss; at the app's 0.05 a step moves most entries
             little more than their rounding) and hold each table by its
             change, max |got - want| over max |want - start| at most
             1e-4: 20 fused steps on the card, under
             ``torch.cuda.set_sync_debug_mode("error")``, against the
             same steps on the CPU (a second ``init``
             lifecycle), losses within rtol 1e-4; one push-pull
             ``train_batch`` against one fused step from the same start;
             one ``momentum`` step whose padded bag slots (id V) sit next
             to row V-1 must leave row V-1 of every table, and its state,
             unchanged; and the homonym test's setting (V 21, dim 16, 12
             epochs) must separate the two senses of token 0 on the card.
             Then ``sgmix_fused_occurrences_per_sec`` (CUDA events over
             100 queued steps at lr 0.05), a profile of 20 fused steps and
             the peak device memory.
13. resnet — ``ResNet20DataParallel`` (``apps/resnet.py``) at its real
             widths (16/32/64, 3 x 3 basic blocks, 272,474 parameters,
             10 classes), 2 workers, lr 0.1, batch 64 split across them,
             through ``TorchParamManager`` (``ext/torch_ext.py``) on one
             draw of ``synthetic_cifar(60_000)``: 50,000 training and
             10,000 held-out images.  Checks: (a) the card's initial
             weights equal the CPU build from the same seed, bit for bit;
             (c) 5 steps from one start on the same batches on the card
             (TF32 off, deterministic cuDNN, for this check only) and on
             the CPU (a second ``init`` lifecycle), each worker's
             parameters held by their change after the first step, by
             the largest entry within 2.1e-2 and 3.3e-2 and by the L2
             norm within 6.3e-3 and 9.8e-3, every step's gaps reported
             beside the CPU's own gaps to a run whose inputs moved by one
             ulp, and the same 5 steps with cuDNN's TF32 on as a control
             that both workers' held step must reject.  The rest runs under
             PyTorch's defaults (cuDNN TF32 on, not deterministic): (b)
             after each manager's sync in a step the table equals the
             table before plus (flat_i - synced_i) / 2 computed in
             float32 on the card, and net i's parameters equal the table,
             bit for bit; (d) one whole step (both workers' forward,
             backward and SGD step, both syncs) under
             ``torch.cuda.set_sync_debug_mode("error")``; (e) one epoch
             (781 steps), then held-out accuracy above 0.5.  Then
             ``resnet_images_per_sec`` (CUDA events over 100 steps after
             5, with the precision switches read as it starts and
             printed), the two syncs alone (their share of a step), one
             profiled step and 20 profiled pairs of syncs (launches, the
             device's busy share), and the peak device memory.
14. planes — the LR fused step (phase 8's shape) for 300 steps under
             CUDA events in eight lifecycles on the card, disarmed, armed,
             armed, disarmed, twice; armed is ``-profile_hz=97
             -metrics_flush_ms=50 -health_rules=true -trace_dir=<tmp>``.
             Each armed run's ``trace_rank0.json`` must hold the
             profiler's folded-stack events beside the spans, its
             ``metrics_rank0.prom`` the health evaluator's series, and
             the evaluator the default rule pack.  It reports the step
             times and the ratio of their medians, armed over disarmed.
             No kernel of ``ops/csrc`` runs on phases 7 to 14; each
             reports the launch counts of its own run (0).
15. native — the native runtime (``multiverso_tpu_torch/native``): its
             library built from the checkout's C++ sources (in a thread
             started beside the kernels' builds; the seconds, whether
             ``make`` and ``g++`` exist), loaded from inside the
             checkout.  An in-process runtime under the ``assign``
             updater: ``OffloadedState`` at the dim-512 trainer's state
             size (21,238,272 float32) round-trips bit for bit; then
             bench_transformer's config (dim 512, bf16, batch 8, seq
             2048) with momentum, 3 steps each in memory, offloaded to
             the local store and to the native store: losses, parameters
             and state bit for bit across all three, step times and the
             bridge's push/wait p50s; the native arm must launch every
             flash kernel.  Planted faults that must fail: a bridge
             that drops the first step's push (the arms' comparison),
             and runtimes under the ``default`` and ``sgd`` updaters
             (the bridge's ``init`` probe).  Then bench.py's
             denominators through the port's workers over loopback
             TcpNet (``spawn_native_workers``): ``lr_native_worker`` at
             8 ranks, 60 steps, batch 1,024
             (``lr_native8_samples_per_sec``), ``w2v_native_worker`` at
             8 ranks, 20 steps, batch 512, prefetch on and off
             (``w2v_native8_pairs_per_sec``,
             ``w2v_native8_prefetch_speedup``), each rank's marker
             required; ``lr_fused_vs_native8`` and
             ``w2v_fused_vs_native8`` from this run's fused rates (only
             when the lr and w2v phases ran); the host's CPU count; and
             ``serve_bench_worker`` on 2 ranks
             (``serve_cached_vs_cold_p50``, beside the JAX package's
             acceptance of 10x, not gated).
16. serve  — the serve tier's fleet workers on the card's host (numpy
             programs over the native runtime; no kernel runs) at
             bench.py's sizes (``SERVE``), after the host's facts (CPU
             count, RLIMIT_NOFILE soft and hard, raised toward the tail
             herd as bench_tail does, io_uring support, ``luajit``): the
             fan-in herd (1,000 anonymous sockets, inflight 8) on epoll
             and, where ``MV_UringSupported``, on uring; its ``tail``
             (10,000, degraded to what the fd limit allows, with the
             reason), ``ops``, ``latency``, ``audit`` (1,000) and
             ``health`` (256) modes; failover (3 replicated ranks, rank 1
             SIGKILLs itself); skew (1,000 x 2,048 x 2,048); capacity
             (256 x 2,048 x 512, the port's ``tools/mvplan.py``); then
             the JAX package's demo drivers' runs with the port's
             modules (``SERVE_DEMO``): fan-in chaos, skew's NaN add,
             capacity's demo, audit ``chaos`` (epoll and tcp) / ``loss``
             / ``plain``, and the doctor, latency and ops demos driven
             over stdin (``Fleet``), and the failover demo's 3 ranks of
             the interactive failover worker (rank 1 SIGKILLed under a
             read herd); and the Lua smoke where a ``luajit`` is on PATH.
             The port's operator CLIs (``multiverso_tpu_torch/tools``)
             read those fleets as the JAX drivers' steps do, each a
             script in a child with no ``jax`` importable (``Tool``):
             ``mvdoctor --fleet`` on the doctor fleet (``--strict`` 0
             quiet, 1 under the delay, 0 once resolved; the top finding
             ``[critical] rank 1: latency SLO burn``) with ``mvtop
             --alerts``, ``latdoctor --fleet`` on the latency fleet,
             ``mvtop --fleet`` in each view of ``MVTOP_VIEWS`` on the ops
             fleet, ``mvaudit --settle 0.5`` and ``mvtop --replication
             --fleet`` on the failover survivor, and ``mvaudit`` over the
             audit chaos and loss fleets' books (``ScrapeReplay``: those
             fleets exit once the books are printed).  Gated, each by its
             judge: every connection accepted; in the demo's run the
             overload shed and the chaos adds exact; no acked add lost in
             failover, a promotion within 10 s; the audit plane's named
             duplicate, the health alert fired, the latency stages summing
             to >= 0.85; the hot keys, the zipf ratio over 3x uniform and
             the NaN black box; the byte books within 10% and mvplan's
             spread <= 2x (demo: skews > 2x, RSS and arena moved); audit
             chaos exactly the two duplicates, loss a gap with its black
             box, plain converged disarmed; the doctor's alert firing then
             resolved, its fleet's shutdown within ``DOCTOR_SHUTDOWN_S``;
             ``apply`` the latency demo's dominant stage under its delay;
             the ops demo's fleet scrape, exemplars and barrier-timeout
             black box; the failover demo's promotion, beacons and exact
             convergence; and each CLI step (``judge_doctor_cli``,
             ``judge_latdoctor``, ``judge_mvtop_views``,
             ``judge_mvaudit``, ``judge_mvtop_replication``), the
             doctor's top finding and latdoctor's rank 1 ``dominant p99
             stage`` naming ``apply`` among them (each held in 10 of 10
             runs on the card's host; ``--demo-repeats N`` runs the
             doctor and latency demos N times and counts).  Every part
             runs and prints its line, then the phase fails naming each
             part that failed.  The overheads (``SERVE_BARS``) and every
             p50/p99 are recorded beside bench.py's acceptance bars, not
             gated, with the phase's own wall clock.

Then the kernels line (the trainer's numbers, the launches of every
path, and the kernels' numbers at every other path's shapes, the ring's
pieces among them with their measured launches per ring call), the
nvidia-smi line, and the result line.  Any
failure exits non-zero and prints no result.  ``--steps``/``--phases``
shorten a run while iterating; such a run ends with a line naming what it
skipped instead of the result line, and exits 4.

``python3 chip_smoke.py --kernel-times [--root DIR] B,H,T,D,DTYPE ...``
builds the kernels of the package under DIR (this checkout by default;
an older tree to compare with, unpacked under ``build/``, which the
tree-walking lint skips) and prints each kernel's times at each shape,
as the timing phase does, with no result line.  A shape ``sgns,B,D,K``
times the SGNS kernel instead (``sgns_times``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published dense peaks (NVIDIA data sheet).
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12     # outside the tensor cores
PEAK_HBM_BYTES = 3.35e12
# The exp unit (MUFU ex2): 16 results a clock an SM (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0)
# against the tensor cores' 4,096 bf16 flops a clock an SM (132 SMs x
# 4,096 x 1.83 GHz = the 989 TFLOP/s above), at the same clock.
PEAK_EX2_PER_S = PEAK_BF16_FLOPS * 16 / 4096

# The main path: the trainer's configuration and the attention shape it
# gives the kernels.  The parity and timing phases use the same shape.
LAYERS, STEPS, BATCH, SEQ = 16, 5, 4, 2048
HEADS, HEAD_DIM = 16, 128
PHASES = ("parity", "trainer", "profile", "check", "timing", "small",
          "headdims", "moe", "longctx", "mesh", "moe_mesh", "shard",
          "tables", "lr", "rows", "w2v", "lda", "sgmix", "resnet", "planes",
          "native", "serve")
# Remat reschedules the backward and recomputes the same numbers: on the
# card "dots" matched the no-remat losses to the last bit and full remat
# (batch 8, the batch of 4 twice) within 5.3e-5, so the losses are held
# within 1e-3, about 20x room; so is each remat run's parameter change
# against the no-remat run's at its batch, where a layer whose update was
# lost shows as 1.  accum=2 against accum=1 (sums of bf16 products in
# another order) is held within the card-vs-CPU trainer check's 2e-2.
REMAT_TOL = 1e-3
CHANGE_TOL = 2e-2
# bench.py's other transformer configs, each at its own batch and seq:
# bench_transformer (:1418-1424), bench_moe (:1590-1616) and
# bench_long_context (:1619-1640).
SMALL = dict(vocab_size=8192, dim=512, n_layers=4, n_heads=8, hidden=1408)
SMALL_BATCH, SMALL_SEQ = 8, 2048
# The headdims phase: the head dims outside bench.py's configs (64, 128)
# that the Hopper designs cover, at full width: transformer_large's widths
# in 8 heads of 256 (Gemma 7B's head dim) and bench_transformer's in 16
# heads of 32; and transformer_large in float32 (the plane design at the
# trainer's attention shape, and in 8 heads of 256).
WIDE_HEADS = 8
NARROW = dict(SMALL, n_heads=16)
MOE = dict(vocab_size=16384, dim=1024, n_layers=8, n_heads=8, hidden=2816,
           num_experts=8, top_k=2, capacity_factor=1.25, remat=True)
MOE_BATCH, MOE_SEQ = 8, 1024
# The MoE checks' 2-layer float32 copy, small enough for the CPU side.
MOE_CHECK_BATCH, MOE_CHECK_SEQ = 2, 256
# Two float32 paths (dense against capacity dispatch, card against CPU)
# sum products over dim 1024 and hidden 2816 in other orders: logits
# within 1e-4 of their scale; the aux loss, a mean of softmax outputs,
# within 1e-5 relative.  A dropped or misrouted route moves the logits
# by O(1) of their scale.
MOE_TOL, MOE_AUX_TOL = 1e-4, 1e-5
LONG = dict(vocab_size=8192, dim=1024, n_layers=4, n_heads=8, hidden=2816,
            remat=True)
LONG_BATCH, LONG_SEQ = 1, 16384
# The plain versions hold [bh, T, T] float32 scores, 1 GiB a head at T
# 16,384: the kernels are held against them at bh 2.
LONG_PARITY_BH = 2
# bench_long_context's seq 65,536 run (bench.py:1646-1656): the same
# model at 4x the sequence.  Its plain versions run in blocks of rows or
# columns (16 GiB of scores a head otherwise).
LONG64K_SEQ, LONG64K_BLOCK = 65536, 4096
# The mesh phase: the trainer's config over NCCL at one rank, and the
# ring's compute at sp 4 (its bf16 shape is bench_long_context's
# attention: B 1, 8 heads of 128, T 16,384).
MESH_STEPS = 3
RING_SP = 4
RING_BF16 = (1, 8, LONG_SEQ, 128)
RING_F32 = (2, 4, 2048, 64)
# The moe_mesh phase: bench_moe on a mesh.  At one NCCL rank the full
# width, 3 steps, bit for bit against no mesh; on several ranks the moe
# phase's 2-layer float32 copy at its check shape, at a capacity factor
# where routes overflow, held like the CPU mesh tests: losses at rtol
# 1e-5, every parameter and slot at rtol 1e-5 with a floor at 1e-5 of
# the tensor's largest entry.
MOE_MESH_STEPS = 3
MOE_MESH_CF = 1.0
MOE_MESH_TOL = 1e-5
MOE_MESH_TIMEOUT_S = 600

# The parameter-server path: bench.py's add/get table (bench_add_get,
# 16 Mi float32) and its LR shape (bench_lr: batch 8192, 784 features,
# 10 classes).
TABLE_SIZE = 16 * 1024 * 1024
CARD = "cuda:0"            # where init() with no device must put tables
TABLE_TOL = 1e-6           # max |got - want| over max |want|
LR_BATCH, LR_FEATURES, LR_CLASSES, LR_STEPS = 8192, 784, 10, 20
LR_RTOL, LR_ATOL = 1e-4, 1e-5
# The row path: bench.py's word2vec bench (bench_w2v) and the rows of its
# embedding bench (bench_embedding: 65,536 rows).
W2V_VOCAB, W2V_DIM, W2V_BATCH, W2V_NEG, W2V_LR = 100_000, 128, 8192, 5, 0.025
W2V_STEPS = 20
# adagrad divides each coordinate's step by its gradient's size plus eps.
# At eps 1e-8, below the batch-mean loss's gradients (1e-7 to 1e-6), a
# coordinate whose duplicate sum cancels takes a step that rounding
# decides: the card against the CPU drifted to 1.5e-4 of the change in 5
# steps.  The checks set eps to 1e-6, where the step is a smooth function
# of the gradient, and stop at 5 steps, before the loss falls from 4.16
# to 0.4 and amplifies rounding (a reordered batch on the CPU at 50,000 x
# 128: 6e-7 of the change after 5 steps, 3.3e-5 after 20).
W2V_ADAGRAD_EPS, W2V_ADAGRAD_STEPS = 1e-6, 5
# Two runs from one start agree when max |got - want| over max |want -
# start| is at most W2V_RTOL: each table (and updater state) is judged by
# the change the reference made, never by its values, which one step
# barely moves.
W2V_RTOL = 1e-4
# The SGNS kernel against its plain version on the card, [pairs, D, K]:
# the benchmark's word2vec cell, bench_w2v's batch, and a ragged shape
# (scalar loads at D 7, a last block of one pair).  Both sides are float32
# and sum D products and 1 + K gradient terms in other orders: within rtol
# 1e-5, with an atol of 1e-6 of the tensor's largest entry for entries
# that cancel (tests/test_torch_sgns.py holds the plain version to
# autograd the same way).
SGNS_CASES = ((131_072, 300, 5), (W2V_BATCH, W2V_DIM, W2V_NEG),
              (1_001, 7, 3))
SGNS_RTOL, SGNS_ATOL_SHARE = 1e-5, 1e-6
# The shard phase: tables across ranks (2 gloo ranks on one card, or an
# NCCL rank per card).  Row batches of bench_w2v's batch; the big table
# is a word-embedding vocabulary of 2^20 rows.
SHARD_BIG_ROWS = 1 << 20
SHARD_IDS = W2V_BATCH
SHARD_LR = 0.1              # the array checks' step (LR's)
SHARD_TOL = 1e-5            # max |got - want| over max |want - start|
SHARD_TIMEOUT_S = 600
DLRM_USERS = DLRM_ITEMS = 32768
DLRM_DIM, DLRM_BATCH, DLRM_STEPS, DLRM_LR = 16, 512, 10, 0.05
ROW_UPDATERS = ("default", "sgd", "adagrad", "momentum", "smooth_gradient",
                "assign")
# LightLDA: bench.py's bench_lightlda (2,048 docs of 64 tokens, V 10,000,
# K 64) and bench_lightlda_mh (K 1,024 and 8,192, the same docs).
LDA_DOCS, LDA_VOCAB, LDA_TOPICS, LDA_LEN = 2048, 10000, 64, 64
LDA_ALPHA, LDA_BETA, LDA_MH_STEPS = 0.5, 0.1, 4
LDA_MH_TOPICS = (1024, 8192)
LDA_Z_TOL = 1e-3          # share of tokens whose topic may differ
LDA_SAMPLE_DOCS = 256
# tests/test_lightlda.py's planted-topic recovery (the MH case).
LDA_PURITY = dict(docs=60, vocab=80, topics=4, doc_len=48, seed=7,
                  concentration=0.05, sweeps=25)
LDA_PURITY_MIN = 0.6
# The skip-gram mixture at bench_w2v's vocabulary and width.
SGMIX_VOCAB, SGMIX_DIM, SGMIX_SENSES = 100_000, 128, 2
SGMIX_WINDOW, SGMIX_NEG, SGMIX_BATCH, SGMIX_STEPS = 5, 5, 1024, 20
SGMIX_LR = 0.05
# The checks' step size: the mixture's 0.05 per occurrence, so sgd on the
# batch-mean loss takes lr x batch.  At the app's 0.05 on the batch-mean
# loss a step moves most entries little more than float32's rounding of
# them, so a batch whose occurrences are merely reordered drifts a
# sizeable share of W2V_RTOL from the original in 20 steps.
SGMIX_CHECK_LR = SGMIX_LR * SGMIX_BATCH
# ResNet-20 / CIFAR-10 data-parallel (BASELINE.json's torch-binding
# config) at its real widths (16/32/64, 3 x 3 basic blocks, 272,474
# parameters), on one draw of synthetic_cifar split into training and
# held-out images, with the app's defaults: 2 workers, lr 0.1, batch 64
# split across them.
RESNET_TRAIN, RESNET_HELD, RESNET_CLASSES = 50_000, 10_000, 10
RESNET_WORKERS, RESNET_LR, RESNET_BATCH = 2, 0.1, 64
RESNET_PARAMS = 272_474
RESNET_CHECK_STEPS, RESNET_TIMED_STEPS = 5, 100
# Card (TF32 off, deterministic cuDNN) against CPU from one start on the
# same batches, each worker's parameters held by their change: max |got -
# want| over max |want - start|.  Float32 training from ResNet-20's
# initial weights at lr 0.1 is chaotic: on the card the gap read 2.0e-3
# and 3.2e-3 after one step and grew about 4x a step to 0.13 after five,
# as the CPU's own run does against itself with its inputs moved by one
# ulp (6.2e-6 and 3.2e-3 after one step; reported beside it).  So the
# first step is held, each worker within 10x its reading, and all five
# are reported.  The same step with cuDNN's TF32 on read 2.9e-2 and
# 2.0e-2 (the control): worker 0's limit rejects it; worker 1's cannot,
# since its first step is as chaotic on the CPU against itself as on the
# card, so worker 1 is held by the L2 measure below as well.
RESNET_TOL = (2.1e-2, 3.3e-2)
# The same first step held by the L2 measure, ||card - CPU|| over ||CPU
# - start||, which a few chaotic entries move little and TF32's error in
# every product moves in full: on the card it read 1.25e-3 and 1.96e-3
# (TF32 off), the CPU's one-ulp run 2.4e-6 and 1.81e-3, and the TF32-on
# control 3.06e-2 and 2.63e-2 (NVIDIA H100 80GB HBM3, 700 W).  Each
# worker is held within 5x its reading, so the control fails worker 1's
# limit by 2.7x, worker 0's by 4.9x; the phase fails unless both
# workers' checks reject the control.
RESNET_L2_TOL = (6.3e-3, 9.8e-3)
RESNET_ACC_MIN = 0.5      # held-out accuracy after one epoch; chance 0.1
# The planes phase: the lr phase's fused step with the host planes armed
# (the flag set that raised before they were ported) and disarmed.
PLANES_FLAGS = ("-profile_hz=97", "-metrics_flush_ms=50",
                "-health_rules=true")
PLANES_STEPS = 300
# Host-bound steps vary between lifecycles, so the two settings take
# turns: off, on, on, off, twice.
PLANES_ORDER = (False, True, True, False) * 2

F32_TOL = 1e-4   # float32 outputs: every element within atol + rtol·|want|
# The float32 plane design's largest error against float64, at most this
# many times the plain float32 version's (one bf16 piece fewer, or TF32,
# would miss it by far: their errors are of order 2^-16 and 2^-11).
F32_F64_RATIO = 8.0
# The parity cases held to that gate: the trainer's float32 attention
# shape, and 8 heads at T 8,192 (at D 32, 128 and 256), where every
# output sums four times as many wgmma products as at T 2,048.
F64_CASES = ("full_width_f32", "long_f32", "long_f32_d256", "long_f32_d32")
LONG_F32_BH, LONG_F32_SEQ = 8, 8192
BF16_TOL = 1e-2  # bf16 outputs: max and L2 error relative to the scale
KERNELS = {
    "flash_fwd": ("multiverso_tpu_torch/ops/csrc/flash_fwd.cu",
                  "multiverso_tpu/ops/flash_attention.py:83"),
    "flash_dq": ("multiverso_tpu_torch/ops/csrc/flash_dq.cu",
                 "multiverso_tpu/ops/flash_attention.py:138"),
    "flash_dkv": ("multiverso_tpu_torch/ops/csrc/flash_dkv.cu",
                  "multiverso_tpu/ops/flash_attention.py:184"),
}


# Which kernel each (dtype, head dim) launches (dq_for_dim, dkv_for_dim
# and fwd_for_dim in the sources).
KERNEL_DESIGNS = {
    "flash_fwd": {"bfloat16 D 32, 64, 128, 256": "flash_fwd_hopper<D>",
                  "float32 D 64, 128": "flash_fwd_hopper_f32<D> (three "
                                       "bf16 planes, six wgmma products)",
                  "float32 D 256": "flash_fwd_hopper_f32<256> (q float32, "
                                   "split in registers; k and v planes; "
                                   "32-key blocks)",
                  "float32 D 32": "flash_fwd_hopper_f32<32> (three bf16 "
                                  "planes in 64-byte rows; 64-key blocks in "
                                  "three stages; o's hi·hi summed apart)"},
    "flash_dq": {"bfloat16 D 32, 64, 128, 256": "flash_dq_hopper<D>",
                 "float32 D 64, 128": "flash_dq_hopper_f32<D> (three bf16 "
                                      "planes, six wgmma products)",
                 "float32 D 256": "flash_dq_hopper_f32<256> (q and do "
                                  "float32, split in registers; k and v "
                                  "planes; 16-key blocks)",
                 "float32 D 32": "flash_dq_hopper_f32<32> (three bf16 "
                                 "planes in 64-byte rows; 128 q rows, 64 a "
                                 "warpgroup, over one ring of 64-key "
                                 "blocks; hi·hi summed apart)"},
    "flash_dkv": {"bfloat16 D 32, 64, 128, 256": "flash_dkv_hopper<D>",
                  "float32 D 64, 128": "flash_dkv_hopper_f32<D> (three "
                                       "bf16 planes, six wgmma products)",
                  "float32 D 256": "flash_dkv_hopper_f32<256> (k and v "
                                   "float32, split in registers; q and do "
                                   "planes; dv and dk by warpgroup)",
                  "float32 D 32": "flash_dkv_hopper_f32<32> (three "
                                  "bf16 planes in 64-byte rows; 128 k rows, "
                                  "64 a warpgroup, over one ring of 64-row "
                                  "q blocks; hi·hi summed apart, dk and dv "
                                  "flushed into float32 sums)"},
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attn_inputs(bh, t, d, dtype, seed, tk=None):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    tk = tk or t

    def r(*shape, dt=dtype):
        return torch.randn(*shape, generator=g, device="cuda").to(dt)

    return dict(q=r(bh, t, d), k=r(bh, tk, d), v=r(bh, tk, d),
                do=r(bh, t, d), dlse=r(bh, t, dt=torch.float32))


def run_three(fa, x, causal, plain: bool, saved):
    """(o, lse, dq, dk, dv) through the kernels or their plain versions.
    Both backward sides start from the same ``saved`` (lse, delta) — the
    plain forward's, with the lse cotangent folded in — so each kernel is
    held to its own function."""
    q, k, v, do = x["q"], x["k"], x["v"], x["do"]
    scale = q.shape[-1] ** -0.5
    fwd, dq_fn, dkv_fn = ((fa.flash_fwd_ref, fa.flash_dq_ref,
                           fa.flash_dkv_ref) if plain else
                          (fa.flash_fwd, fa.flash_dq, fa.flash_dkv))
    o, lse = fwd(q, k, v, scale, causal)
    dq = dq_fn(q, k, v, do, *saved, scale, causal)
    dk, dv = dkv_fn(q, k, v, do, *saved, scale, causal)
    return {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv}


def compare(got, want):
    """Errors per output, and whether all pass: a float32 output when
    every element is within F32_TOL·(1 + |want|), a bf16 output when its
    max and L2 errors relative to the output's scale are within
    BF16_TOL."""
    import torch

    out, ok = {}, True
    for key in want:
        g, w = got[key].detach().float(), want[key].detach().float()
        if g.shape != w.shape or not bool(g.isfinite().all()):
            return {key: {"max_abs": float("nan")}}, False
        err = (g - w).abs()
        e = {"max_abs": float(err.max()),
             "scaled": float(err.max() / w.abs().max().clamp_min(1e-30)),
             "rel_l2": float(err.double().norm()
                             / w.double().norm().clamp_min(1e-30))}
        out[key] = e
        if want[key].dtype == torch.float32:
            ok = ok and bool((err <= F32_TOL + F32_TOL * w.abs()).all())
        else:
            ok = ok and e["scaled"] <= BF16_TOL and e["rel_l2"] <= BF16_TOL
    return out, ok


def planted_fault(x, causal_offset):
    """(o, lse, dq, dk, dv) of attention whose causal mask keeps keys up
    to ``causal_offset`` past the diagonal (-1 drops the diagonal, 1
    admits one future key), by float32 autograd, cast as the kernels
    cast: what a kernel with that fault would return."""
    import torch

    q, k, v = (x[n].float().requires_grad_() for n in ("q", "k", "v"))
    t = q.shape[1]
    s = (q @ k.transpose(1, 2)) * q.shape[-1] ** -0.5
    keep = torch.ones(t, t, dtype=torch.bool,
                      device=s.device).tril(causal_offset)
    s = s.masked_fill(~keep, -1e30)
    lse = torch.logsumexp(s, -1)
    o = torch.softmax(s, -1) @ v
    dq, dk, dv = torch.autograd.grad((o, lse), (q, k, v),
                                     (x["do"].float(), x["dlse"]))
    dt = x["q"].dtype
    return {"o": o.detach().to(dt), "lse": lse.detach(), "dq": dq.to(dt),
            "dk": dk.to(dt), "dv": dv.to(dt)}


def demangle(names):
    """Kernel names as C++ reads them, where c++filt is at hand."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60,
                             check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return list(names)
    return [o.split("(")[0] for o in out] if len(out) == len(names) \
        else list(names)


def ptxas_report(log_text):
    """{kernel: {"registers": n, "spill_bytes": stores + loads}} from the
    ``-Xptxas -v`` lines of one library's build log."""
    per, name = {}, None
    for ln in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", ln)
        if m:
            name = m.group(1)
            per.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            per[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            per[name]["registers"] = int(m.group(1))
    return per


SASS_OPS = ("HGMMA", "UTMALDG", "LDL", "STL")


def sass_counts(sass_text):
    """{kernel: {op: count}} of the SASS instructions in SASS_OPS, per
    kernel, from the text ``cuobjdump -sass`` prints for one library."""
    per, name = {}, None
    for ln in sass_text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = m.group(1)
            per[name] = dict.fromkeys(SASS_OPS, 0)
        elif name is not None:
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                          ln)
            if m and m.group(1) in per[name]:
                per[name][m.group(1)] += 1
    return per


# The bf16 Hopper kernels each library must hold, by head dim.
HOPPER_DIMS = {"flash_fwd": (32, 64, 128, 256),
               "flash_dq": (32, 64, 128, 256),
               "flash_dkv": (32, 64, 128, 256)}
# The float32 plane design's kernels (six bf16 products a product).
HOPPER_F32_DIMS = {"flash_fwd": (32, 64, 128, 256),
                   "flash_dq": (32, 64, 128, 256),
                   "flash_dkv": (32, 64, 128, 256)}


def hopper_dim(kname, name, suffix=""):
    """The head dim of ``kname``'s Hopper kernel ``name`` (demangled, or
    mangled where c++filt is missing; ``suffix`` "_f32" for the float32
    plane design's), or None for another kernel."""
    m = (re.search(rf"{kname}_hopper{suffix}<(\d+)>", name)
         or re.search(rf"{kname}_hopper{suffix}ILi(\d+)EE", name))
    return int(m.group(1)) if m else None


def judge_build(libs):
    """The failures of a build report: a library missing one of its
    HOPPER_DIMS or HOPPER_F32_DIMS kernels, or a Hopper kernel without
    HGMMA or UTMALDG in its SASS, or with bytes spilled."""
    bad = []
    for kname, lib in libs.items():
        for suffix, dims in (("", HOPPER_DIMS), ("_f32", HOPPER_F32_DIMS)):
            found = {hopper_dim(kname, n, suffix) for n in lib["kernels"]}
            missing = [d for d in dims[kname] if d not in found]
            if missing:
                bad.append(f"{kname}: no Hopper{suffix} kernel at D "
                           f"{missing}")
        for n, c in lib["kernels"].items():
            if "_hopper" not in n:
                continue
            if not (c.get("HGMMA", 0) > 0 and c.get("UTMALDG", 0) > 0):
                bad.append(f"{n}: no HGMMA or no UTMALDG in its SASS")
            if c.get("spill_bytes", 0) > 0:
                bad.append(f"{n}: {c['spill_bytes']} bytes spilled")
    return bad


def phase_build(_build, paths, build_s):
    """Per kernel of each library: ptxas registers and spill bytes, and
    the SASS counts of wgmma (HGMMA), TMA loads (UTMALDG) and local-memory
    traffic (LDL/STL).  Every library must hold its bf16 Hopper kernels
    (HOPPER_DIMS) and float32 plane kernels (HOPPER_F32_DIMS), and each of
    them HGMMA and UTMALDG and no spills; the SGNS library's kernels
    (where built) no spills."""
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()),
                             "cuobjdump")
    libs = {}
    for kname in KERNELS:
        with open(os.path.join(_build.BUILD_DIR, f"{kname}.log")) as f:
            log_text = f.read()
        ptx = ptxas_report(log_text)
        sass = sass_counts(subprocess.run(
            [cuobjdump, "-sass", paths[kname]], capture_output=True,
            text=True, timeout=300, check=True).stdout)
        mangled = sorted(set(ptx) | set(sass))
        kernels = {}
        for mname, readable in zip(mangled, demangle(mangled)):
            kernels[readable] = {**ptx.get(mname, {}),
                                 **sass.get(mname, {})}
        warnings = [ln.strip() for ln in log_text.splitlines()
                    if "warning" in ln.lower()
                    or "performance loss" in ln.lower()][:8]
        libs[kname] = {"lib": os.path.relpath(paths[kname], HERE),
                       "kernels": kernels, "warnings": warnings,
                       "ptxas": [ln.strip() for ln in log_text.splitlines()
                                 if "registers" in ln or "spill" in ln][:40]}
    bad = judge_build(libs)
    sgns = None
    if "sgns" in paths:
        # The SGNS kernels (no wgmma, no TMA): registers and no spills.
        with open(os.path.join(_build.BUILD_DIR, "sgns.log")) as f:
            ptx = ptxas_report(f.read())
        sgns = {"lib": os.path.relpath(paths["sgns"], HERE),
                "kernels": dict(zip(demangle(sorted(ptx)),
                                    (ptx[n] for n in sorted(ptx))))}
        bad += [f"{n}: {c['spill_bytes']} bytes spilled"
                for n, c in sgns["kernels"].items()
                if c.get("spill_bytes", 0) > 0]
    emit({"phase": "build", "ok": not bad, "s": build_s, "failures": bad,
          "libs": libs, "sgns": sgns})
    if bad:
        raise AssertionError("build phase: " + "; ".join(bad))


def f64_forward(torch, x, causal, heads=8):
    """o and lse in float64 of the function the float32 forward kernel
    and its plain version compute: the same float32 operands (q
    pre-scaled in float32), ``heads`` heads at a time."""
    q, k, v = x["q"], x["k"], x["v"]
    scale = q.shape[-1] ** -0.5
    out = {"o": [], "lse": []}
    for h0 in range(0, q.shape[0], heads):
        hs = slice(h0, h0 + heads)
        s = (q[hs].float() * scale).double() @ k[hs].double().transpose(1, 2)
        if causal:
            keep = torch.ones(s.shape[1:], dtype=torch.bool,
                              device=s.device).tril()
            s = s.masked_fill(~keep, -math.inf)
        lse = torch.logsumexp(s, -1)
        out["o"].append(torch.exp(s - lse[..., None]) @ v[hs].double())
        out["lse"].append(lse)
        del s
    return {n: torch.cat(a) for n, a in out.items()}


def f64_backward(torch, x, saved, causal, heads=8):
    """dq, dk and dv in float64 of the function the float32 kernels and
    their plain versions compute: the same float32 operands (q pre-scaled
    in float32) and the same saved (lse, delta), ``heads`` heads at a
    time."""
    q, k, v, do = x["q"], x["k"], x["v"], x["do"]
    scale = q.shape[-1] ** -0.5
    out = {n: [] for n in ("dq", "dk", "dv")}
    for h0 in range(0, q.shape[0], heads):
        hs = slice(h0, h0 + heads)
        qs = (q[hs].float() * scale).double()
        kd, vd, dod = k[hs].double(), v[hs].double(), do[hs].double()
        s = qs @ kd.transpose(1, 2)
        if causal:
            keep = torch.ones(s.shape[1:], dtype=torch.bool,
                              device=s.device).tril()
            s = s.masked_fill(~keep, -math.inf)
        p = torch.exp(s - saved[0][hs].double()[..., None])
        ds = p * (dod @ vd.transpose(1, 2)
                  - saved[1][hs].double()[..., None])
        out["dq"].append(ds @ kd * scale)
        out["dk"].append(ds.transpose(1, 2) @ qs)
        out["dv"].append(p.transpose(1, 2) @ dod)
        del s, p, ds
    return {n: torch.cat(a) for n, a in out.items()}


def f64_errors(got, want, ref):
    """Per output, the largest absolute error of the kernel
    (``got``) and of the plain version (``want``) against the float64
    ``ref``, and whether the kernel's is within F32_F64_RATIO of the
    plain version's."""
    out, ok = {}, True
    for n, r in ref.items():
        ek = float((got[n].double() - r).abs().max())
        ep = float((want[n].double() - r).abs().max())
        out[n] = {"kernel": ek, "plain": ep,
                  "ratio": ek / ep if ep > 0 else math.inf}
        ok = ok and ek <= F32_F64_RATIO * ep
    return out, ok


def parity_case(fa, torch, bh, t, tk, d, dtype, causal, tag, seed,
                f64=False):
    """One case of the three kernels against their plain versions:
    (result line, inputs, plain outputs).  With ``f64`` (float32), the
    errors of kernel and plain version against float64 too, of every
    output, the kernel's held within F32_F64_RATIO of the plain
    version's."""
    x = attn_inputs(bh, t, d, dtype, seed=seed, tk=tk)
    o_ref, lse_ref = fa.flash_fwd_ref(x["q"], x["k"], x["v"], d ** -0.5,
                                      causal)
    saved = (lse_ref, (x["do"].float() * o_ref.float()).sum(-1) - x["dlse"])
    del o_ref
    got = run_three(fa, x, causal, False, saved)
    want = run_three(fa, x, causal, True, saved)
    torch.cuda.synchronize()
    errs, ok = compare(got, want)
    result = {"case": tag, "bh": bh, "T": t, "Tk": tk, "D": d,
              "dtype": str(dtype).split(".")[-1], "causal": causal,
              "ok": ok, "errors": errs}
    if f64:
        ref = f64_forward(torch, x, causal)
        ref.update(f64_backward(torch, x, saved, causal))
        result["f64"], f64_ok = f64_errors(got, want, ref)
        del ref
        result["f64_ratio_max"] = F32_F64_RATIO
        result["ok"] = ok and f64_ok
        torch.cuda.empty_cache()
    return result, x, want


def kernel_errors(errs):
    """The largest absolute error of each kernel's outputs in one case."""
    worst = {n: errs.get(n, {}).get("max_abs", math.nan)
             for n in ("o", "lse", "dq", "dk", "dv")}
    return {"flash_fwd": max(worst["o"], worst["lse"]),
            "flash_dq": worst["dq"],
            "flash_dkv": max(worst["dk"], worst["dv"])}


def edge_cases(torch):
    """The parity phase's cases for the D 32 and D 256 Hopper designs and
    the grids: (bh, T, Tk, D, dtype, causal, tag).  The
    128-row tiles' edges at both dims (a half-full last tile, a second
    tile of 2 rows), D 256's 64-row k and q blocks' edges (T 2080, T 66),
    Tq≠Tk both ways, and bh 65,600 (past grid y's 65,535) in bf16 and
    float32."""
    bf16 = torch.bfloat16
    cases = []
    for d in (32, 256):
        cases.append((4, SEQ + 64, SEQ + 64, d, bf16, True, "half_tile"))
        for t in ((130, 66) if d == 256 else (130,)):
            for causal in (True, False):
                cases.append((3, t, t, d, bf16, causal, "two_row_tile"))
        for t, tk in ((40, 136), (136, 40)):
            cases.append((3, t, tk, d, bf16, False, "cross_length"))
    cases.append((4, SEQ + 32, SEQ + 32, 256, bf16, True, "half_tile"))
    for dtype in (bf16, torch.float32):
        cases.append((65_600, 64, 64, 32, dtype, True, "bh_past_grid_y"))
    return cases


def f32_cases(torch):
    """The parity phase's cases for the float32 plane design (all three
    kernels at D 32, 64, 128 and 256): the trainer's full
    attention shape with the lse cotangent and 8 heads at T 8,192, at D
    32, 128 and 256 (all with the float64 gate, F64_CASES), the 64-row
    tiles' edges of dq and dk/dv and the forward's 128-row tiles' edges (a
    half-full last tile, a last block or second tile of 2 rows), D 128's
    32-row blocks' half-full last block, one head, and Tq≠Tk both ways;
    at D 32 and 256 the 64-row tiles' edges (T 2080, 2112, 66 and 130)
    and Tq≠Tk both ways, causal too (at Tq < Tk the k blocks past Tq see
    no q block and their gradients are 0)."""
    f32 = torch.float32
    cases = [(BATCH * HEADS, SEQ, SEQ, HEAD_DIM, f32, True,
              "full_width_f32"),
             (LONG_F32_BH, LONG_F32_SEQ, LONG_F32_SEQ, HEAD_DIM, f32, True,
              "long_f32")]
    for d in (64, 128):
        for t in (SEQ + 32, SEQ + 64):
            cases.append((4, t, t, d, f32, True, "half_tile"))
        for t in (66, 130):
            for causal in (True, False):
                cases.append((3, t, t, d, f32, causal, "two_row_tile"))
        for t, tk in ((40, 136), (136, 40)):
            cases.append((3, t, tk, d, f32, False, "cross_length"))
    cases.append((2, SEQ + 16, SEQ + 16, HEAD_DIM, f32, True, "half_block"))
    cases.append((1, SEQ, SEQ, HEAD_DIM, f32, True, "one_head"))
    d256 = HEADS * HEAD_DIM // WIDE_HEADS  # the headdims runs' head dim
    cases.append((LONG_F32_BH, LONG_F32_SEQ, LONG_F32_SEQ, d256, f32, True,
                  "long_f32_d256"))
    cases.append((4, SEQ + 32, SEQ + 32, d256, f32, True, "half_tile"))
    for t in (66, 130):
        for causal in (True, False):
            cases.append((3, t, t, d256, f32, causal, "two_row_tile"))
    for t, tk in ((40, 136), (136, 40)):
        for causal in (True, False):
            cases.append((3, t, tk, d256, f32, causal, "cross_length"))
    d32 = NARROW["dim"] // NARROW["n_heads"]  # headdims_f32_d32's head dim
    cases.append((LONG_F32_BH, LONG_F32_SEQ, LONG_F32_SEQ, d32, f32, True,
                  "long_f32_d32"))
    for t in (SEQ + 32, SEQ + 64):
        cases.append((4, t, t, d32, f32, True, "half_tile"))
    for t in (66, 130):
        for causal in (True, False):
            cases.append((3, t, t, d32, f32, causal, "two_row_tile"))
    for t, tk in ((40, 136), (136, 40)):
        for causal in (True, False):
            cases.append((3, t, tk, d32, f32, causal, "cross_length"))
    return cases


def phase_parity(fa, torch):
    results, full_err, faults = [], {}, []
    cases = [(BATCH * HEADS, SEQ, SEQ, HEAD_DIM, torch.bfloat16, True,
              "full_width")]
    for dtype in (torch.float32, torch.bfloat16):
        for d in (32, 64, 128, 256):
            for causal in (True, False):
                cases.append((3, 200, 200, d, dtype, causal, "ragged"))
        cases.append((3, 40, 136, 64, dtype, False, "cross_length"))
        # Head dims outside the compiled set launch the next dim's kernel
        # on zero-padded operands (16: the JAX tests' transformer).
        for d in (16, 48, 96):
            cases.append((3, 200, 200, d, dtype, True, "padded_head_dim"))
    # q tiles over k blocks that straddle Tk, both ways round.
    for t, tk in ((40, 136), (136, 40)):
        cases.append((3, t, tk, HEAD_DIM, torch.bfloat16, False,
                      "cross_length"))
    # The edges of the Hopper design's 128-row tiles (bf16, D 64 and 128):
    # a half-full last tile, a second tile of 2 rows, a single head.
    cases.append((4, SEQ + 64, SEQ + 64, HEAD_DIM, torch.bfloat16, True,
                  "half_tile"))
    for d in (64, 128):
        for causal in (True, False):
            cases.append((3, 130, 130, d, torch.bfloat16, causal,
                          "two_row_tile"))
    cases.append((1, SEQ, SEQ, HEAD_DIM, torch.bfloat16, True, "one_head"))
    cases += edge_cases(torch) + f32_cases(torch)
    for i, (bh, t, tk, d, dtype, causal, tag) in enumerate(cases):
        result, x, want = parity_case(fa, torch, bh, t, tk, d, dtype,
                                      causal, tag, seed=100 + i,
                                      f64=tag in F64_CASES)
        results.append(result)
        if tag == "full_width":
            full_err = kernel_errors(result["errors"])
            for fault, offset in (("drop_diagonal", -1), ("next_key", 1)):
                f_errs, f_ok = compare(planted_fault(x, offset), want)
                faults.append({"fault": fault, "rejected": not f_ok,
                               "errors": f_errs})
        del x, want
    ok = (all(r["ok"] for r in results)
          and all(f["rejected"] for f in faults))
    emit({"phase": "parity", "ok": ok, "f32_tol": F32_TOL,
          "bf16_tol": BF16_TOL, "cases": results, "planted_faults": faults})
    if not all(r["ok"] for r in results):
        raise AssertionError("a kernel disagrees with its plain version")
    if not ok:
        raise AssertionError("the parity test accepted a planted fault")
    return full_err


def large_host(torch):
    """The trainer's float32 masters (seed 0) and the seconds the draw
    took.  ``main`` draws them once for the phases that train the large
    config."""
    from multiverso_tpu_torch.models import init_params

    t0 = time.perf_counter()
    host = init_params(large_config(torch), seed=0)
    return host, time.perf_counter() - t0


def large_config(torch, heads=HEADS, dtype=None, **kw):
    """bench_transformer_large's model (bench.py:1468-1469) in bf16 (or
    ``dtype``); its dim 2048 in ``heads`` heads (16 of 128 in
    bench.py)."""
    from multiverso_tpu_torch.models import TransformerConfig

    return TransformerConfig(vocab_size=32768, dim=HEADS * HEAD_DIM,
                             n_layers=LAYERS, n_heads=heads, hidden=5632,
                             max_seq=SEQ,
                             compute_dtype=dtype or torch.bfloat16, **kw)


def expected_launches(remat_policy, layers, steps):
    """Kernel launches of ``steps`` train steps of ``layers`` layers: the
    forward once per layer and step, and once more in the backward under
    full remat ("dots" keeps its (o, lse)); each backward kernel once."""
    fwd = 2 if remat_policy == "full" else 1
    return {"flash_fwd": fwd * layers * steps,
            "flash_dq": layers * steps, "flash_dkv": layers * steps}


def judge_launches(counts, remat_policy, layers, steps) -> bool:
    want = expected_launches(remat_policy, layers, steps)
    return all(counts.get(k) == n for k, n in want.items())


def judge_remat_losses(losses, base, tol=REMAT_TOL):
    """(max relative difference, verdict) of a remat run's losses against
    the no-remat run's from the same weights and tokens: remat is a pure
    rescheduling, so only bf16 rounding may part them."""
    if len(losses) != len(base) or not all(math.isfinite(x)
                                           for x in losses + base):
        return math.inf, False
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, base))
    return rel, rel <= tol


def train_run(torch, mv, cfg, host, tokens, steps, accum=1, profile=False,
              mesh=None):
    """``steps`` trainer steps from the float32 masters ``host`` on one
    batch (on ``mesh`` when given): the losses, each step's host-clock
    time (ending in a synchronize), tokens/s over steps 2-5, the peak
    device memory and the launch counts of these steps alone; with
    ``profile``, one more step under torch.profiler (the device's busy
    share, launches, the top kernels).  Returns (report, trainer)."""
    from multiverso_tpu_torch.models import TransformerTrainer

    t0 = time.perf_counter()
    tr = TransformerTrainer(cfg, updater_type="sgd", params=host, mesh=mesh)
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    mv.ops.reset_launch_counts()
    losses, step_s = [], []
    for _ in range(steps):
        s0 = time.perf_counter()
        loss = tr.train_step_async(tokens, accum)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - s0)
        losses.append(float(loss))
    counts = mv.ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steady = step_s[1:] or step_s
    step_mean = sum(steady) / len(steady)
    prof = (profile_calls(torch, lambda: tr.train_step_async(tokens, accum),
                          1, top=8) if profile else None)
    return {"remat": cfg.remat and cfg.remat_policy, "batch": tokens.shape[0],
            "seq": tokens.shape[1], "n_layers": cfg.n_layers,
            "place_s": place_s, "losses": losses, "step_s": step_s,
            "step_s_mean_after_first": step_mean,
            "tokens_per_s": tokens.numel() / step_mean,
            "peak_mem_bytes": peak, "launch_counts": counts,
            "launches_expected": expected_launches(
                cfg.remat and cfg.remat_policy, cfg.n_layers, steps),
            "profile": prof}, tr


def run_ok(run, steps) -> bool:
    """Finite, falling losses and the kernels launched as the remat
    policy says."""
    losses = run["losses"]
    return (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
            and judge_launches(run["launch_counts"], run["remat"],
                               run["n_layers"], steps))


def phase_trainer(args, torch, fa, mv, card, host, draw_s):
    """bench_transformer_large's three runs from one draw of the float32
    masters: no remat at batch 4 (PERF.md's continuity line), remat
    "dots" at batch 4 (transformer_large_tokens_per_sec) and full remat
    at batch 8 (transformer_large_fullremat_tokens_per_sec).  The batch
    of 8 is the batch of 4 twice, so its mean loss and gradients are the
    batch of 4's and every run's losses can be held against the no-remat
    run's; each remat run's parameter change is held against that of a
    no-remat run at its own batch (the batch of 8 picks other product
    shapes, whose bf16 rounding parts it from the batch of 4 by 2.8e-2 of
    the change in five steps).  Then the kernels at the batch of 8's
    attention shape against their plain versions.  Returns the
    runs' launch counts and the kernels' errors at that shape."""
    cfg = large_config(torch)
    n_params = sum(p.numel() for p in
                   [host["embed"], host["head"], host["out_norm"]]
                   + [w for lyr in host["layers"] for w in lyr.values()])
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ),
                           generator=torch.Generator().manual_seed(1))
    base, tr = train_run(torch, mv, cfg, host, tokens, args.steps)
    ok = run_ok(base, args.steps)
    start, moved = snapshot(host), snapshot(tr.params)
    if "profile" in args.phases.split(","):
        profile_step(tr, tokens, torch, card)
    del tr
    torch.cuda.empty_cache()
    # init_s, as in every earlier PR: the draw and placing the weights on
    # the card.
    emit({"phase": "trainer", "ok": ok, "n_layers": cfg.n_layers,
          "dim": cfg.dim, "n_heads": cfg.n_heads, "hidden": cfg.hidden,
          "vocab": cfg.vocab_size, "batch": BATCH, "seq": SEQ,
          "params": n_params, "init_s": draw_s + base["place_s"],
          "losses": base["losses"], "step_s": base["step_s"],
          "step_s_mean_after_first": base["step_s_mean_after_first"],
          "tokens_per_s": base["tokens_per_s"],
          "peak_mem_bytes": base["peak_mem_bytes"],
          "launch_counts": base["launch_counts"],
          "launches_expected_each": cfg.n_layers * args.steps,
          "card": card})
    if not ok:
        raise AssertionError(
            f"trainer phase failed: losses {base['losses']}, launches "
            f"{base['launch_counts']}")
    counts = {"trainer": base["launch_counts"]}
    refs = {BATCH: (base, moved)}
    for policy, batch, key in (
            ("dots", BATCH, "transformer_large_tokens_per_sec"),
            ("full", 2 * BATCH, "transformer_large_fullremat_tokens_per_sec")):
        batch_tokens = tokens.repeat(batch // BATCH, 1)
        if batch not in refs:
            # The no-remat run at this batch, whose parameter change the
            # remat run must reproduce.
            ref, tr = train_run(torch, mv, cfg, host, batch_tokens,
                                args.steps)
            refs[batch] = ref, snapshot(tr.params)
            del tr
            torch.cuda.empty_cache()
        ref, ref_params = refs[batch]
        run, tr = train_run(torch, mv, large_config(
            torch, remat=True, remat_policy=policy), host, batch_tokens,
            args.steps)
        change = max(rel_change(g, w, s0) for g, w, s0 in
                     zip(snapshot(tr.params), ref_params, start))
        run["profile"] = profile_calls(
            torch, lambda: tr.train_step_async(batch_tokens), 1, top=8)
        del tr
        torch.cuda.empty_cache()
        rel, same = judge_remat_losses(run["losses"], base["losses"])
        ok = run_ok(run, args.steps) and same and change <= REMAT_TOL
        emit({"phase": "trainer", "ok": ok, **run, key: run["tokens_per_s"],
              "losses_no_remat": base["losses"], "max_rel_diff": rel,
              "tol": REMAT_TOL, "change_vs_no_remat": change,
              "no_remat_at_batch": {k: ref[k] for k in (
                  "batch", "losses", "step_s_mean_after_first",
                  "peak_mem_bytes")},
              "card": card})
        if not ok:
            raise AssertionError(
                f"trainer remat {policy} failed: losses {run['losses']} vs "
                f"{base['losses']}, change {change}, launches "
                f"{run['launch_counts']} (want {run['launches_expected']})")
        counts[f"trainer_{policy}"] = run["launch_counts"]
    del start, moved, refs
    bh = 2 * BATCH * HEADS
    parity, _, _ = parity_case(fa, torch, bh, SEQ, SEQ, HEAD_DIM,
                               torch.bfloat16, True, "full_remat_bh128",
                               seed=600)
    torch.cuda.empty_cache()
    emit({"phase": "trainer", "ok": parity["ok"], "kernel_parity": parity,
          "card": card})
    if not parity["ok"]:
        raise AssertionError("a kernel disagrees with its plain version at "
                             f"the full-remat run's shape (bh {bh})")
    return counts, {"trainer_full": {
        "errors": kernel_errors(parity["errors"]),
        "shape": [2 * BATCH, HEADS, SEQ, HEAD_DIM]}}


def snapshot(params):
    """Every leaf of a parameter tree as float32 numpy, in one order."""
    from multiverso_tpu_torch.models.transformer import _leaves

    return [host_array(p) for p in _leaves(params)]


def phase_small(args, torch, fa, mv, card):
    """bench_transformer's config (``transformer_tokens_per_sec``): five
    steps at batch 8, seq 2048, no remat; one ``accum=2`` step against
    one ``accum=1`` step from the same weights; and the kernels at its
    attention shape (D 64): parity against the plain versions and their
    times."""
    from multiverso_tpu_torch.models import (TransformerConfig,
                                             TransformerTrainer, init_params)

    cfg = TransformerConfig(**SMALL, max_seq=SMALL_SEQ,
                            compute_dtype=torch.bfloat16)
    host = init_params(cfg, seed=0)
    tokens = torch.randint(0, cfg.vocab_size, (SMALL_BATCH, SMALL_SEQ),
                           generator=torch.Generator().manual_seed(1))
    run, tr = train_run(torch, mv, cfg, host, tokens, args.steps,
                        profile=True)
    del tr
    start = snapshot(host)
    steps = {}
    for accum in (1, 2):
        tr = TransformerTrainer(cfg, updater_type="sgd", params=host)
        loss = float(tr.train_step_async(tokens, accum))
        steps[accum] = (loss, snapshot(tr.params))
        del tr
    torch.cuda.empty_cache()
    accum_err = {"loss": abs(steps[2][0] - steps[1][0]) / abs(steps[1][0]),
                 "leaves": max(rel_change(g, w, s0) for g, w, s0 in zip(
                     steps[2][1], steps[1][1], start))}
    heads = cfg.n_heads
    parity, _, _ = parity_case(fa, torch, SMALL_BATCH * heads, SMALL_SEQ,
                               SMALL_SEQ, cfg.head_dim, torch.bfloat16,
                               True, "small_d64", seed=300)
    times = kernel_times(fa, torch, SMALL_BATCH, heads, SMALL_SEQ,
                         cfg.head_dim)
    ok = (run_ok(run, args.steps) and parity["ok"]
          and all(e <= CHANGE_TOL for e in accum_err.values()))
    emit({"phase": "small", "ok": ok, "config": SMALL, **run,
          "transformer_tokens_per_sec": run["tokens_per_s"],
          "accum2_vs_accum1": accum_err, "accum_tol": CHANGE_TOL,
          "kernel_parity": parity, "kernel_times": times, "card": card})
    if not ok:
        raise AssertionError(
            f"small phase failed: losses {run['losses']}, launches "
            f"{run['launch_counts']}, accum {accum_err}, kernel parity "
            f"{parity['ok']}")
    return {"launches": run["launch_counts"],
            "errors": kernel_errors(parity["errors"]), "times": times,
            "shape": [SMALL_BATCH, heads, SMALL_SEQ, cfg.head_dim]}


def phase_headdims(args, torch, fa, mv, card, host):
    """The D 256 and D 32 Hopper designs and the float32 plane design on
    the trainer's path: five steps of transformer_large's widths in 8
    heads of 256 (from the trainer's float32 masters: the head count
    changes no parameter's shape), of bench_transformer's in 16 heads of
    32, of transformer_large in float32 (16 heads of 128, and 8 heads of
    256, from the same masters) and of bench_transformer's in float32 in
    16 heads of 32, each held by ``run_ok``; the kernels at each run's
    attention shape against their plain versions (in float32 also
    against float64, F32_F64_RATIO) and timed.  Returns each path's entry
    for the kernels line."""
    from multiverso_tpu_torch.models import TransformerConfig, init_params

    narrow, narrow_f32 = (TransformerConfig(**NARROW, max_seq=SMALL_SEQ,
                                            compute_dtype=dtype)
                          for dtype in (torch.bfloat16, torch.float32))
    runs = (("headdims_d256", large_config(torch, heads=WIDE_HEADS), host,
             BATCH, SEQ, 610),
            ("headdims_d32", narrow, None, SMALL_BATCH, SMALL_SEQ, 620),
            ("headdims_f32", large_config(torch, dtype=torch.float32), host,
             BATCH, SEQ, 630),
            ("headdims_f32_d256", large_config(torch, heads=WIDE_HEADS,
                                               dtype=torch.float32), host,
             BATCH, SEQ, 640),
            ("headdims_f32_d32", narrow_f32, None, SMALL_BATCH, SMALL_SEQ,
             650))
    entries, failed = {}, []
    for path, cfg, masters, batch, seq, seed in runs:
        dtype = cfg.compute_dtype
        if masters is None:
            masters = init_params(cfg, seed=0)
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                               generator=torch.Generator().manual_seed(1))
        run, tr = train_run(torch, mv, cfg, masters, tokens, args.steps)
        del tr, masters
        torch.cuda.empty_cache()
        d, heads = cfg.head_dim, cfg.n_heads
        f32 = dtype == torch.float32
        parity, _, _ = parity_case(fa, torch, batch * heads, seq, seq, d,
                                   dtype, True, path, seed=seed, f64=f32)
        torch.cuda.empty_cache()
        times = kernel_times(fa, torch, batch, heads, seq, d, dtype=dtype)
        ok = run_ok(run, args.steps) and parity["ok"]
        emit({"phase": "headdims", "ok": ok, "path": path, "dim": cfg.dim,
              "n_heads": heads, "head_dim": d, "hidden": cfg.hidden,
              "vocab": cfg.vocab_size, "dtype": str(dtype).split(".")[-1],
              **run, "kernel_parity": parity, "kernel_times": times,
              "card": card})
        if not ok:
            failed.append(f"{path}: losses {run['losses']}, launches "
                          f"{run['launch_counts']}, kernel parity "
                          f"{parity['ok']}")
        entries[path] = {"launches": run["launch_counts"],
                         "errors": kernel_errors(parity["errors"]),
                         "times": times, "shape": [batch, heads, seq, d],
                         **({"dtype": "float32"} if f32 else {})}
    if failed:
        raise AssertionError("headdims phase failed: " + "; ".join(failed))
    return entries


def dropped_routes(moe, fn):
    """``fn()``'s result and the dropped-route count of each capacity
    dispatch it made (one per MoE layer)."""
    seen, plan = [], moe.capacity_plan

    def counted(*args):
        out = plan(*args)
        seen.append(int((~out[1]).sum()))
        return out

    moe.capacity_plan = counted
    try:
        return fn(), seen
    finally:
        moe.capacity_plan = plan


def moe_check_run(torch, cfg_kw, host, tokens, device):
    """The seeded 2-layer copy of bench_moe's config in float32 on
    ``device``: logits and aux of the dense dispatch, of the capacity
    dispatch with room for every route (cf = E/top_k), and at cf 1.25 and
    0.5 with each layer's dropped routes."""
    from multiverso_tpu_torch.models import (TransformerConfig,
                                             params_from_jax,
                                             transformer_forward)
    from multiverso_tpu_torch.models import moe

    out = {}
    ample = cfg_kw["num_experts"] / cfg_kw["top_k"]
    for name, disp, cf in (("dense", "dense", 1.25),
                           ("ample", "capacity", ample),
                           ("cf1.25", "capacity", 1.25),
                           ("cf0.5", "capacity", 0.5)):
        cfg = TransformerConfig(**{**cfg_kw, "moe_dispatch": disp,
                                   "capacity_factor": cf},
                                compute_dtype=torch.float32)
        params = params_from_jax(host, cfg, device)
        with torch.no_grad():
            (logits, aux), dropped = dropped_routes(
                moe, lambda: transformer_forward(params, tokens.to(device),
                                                 cfg, return_aux=True))
        out[name] = {"logits": host_array(logits), "aux": float(aux),
                     "dropped": dropped}
    return out


def moe_layer_sync_free(torch, params, x, dispatch, shard=None) -> bool:
    """Whether one MoE layer's forward and backward on the card ran
    without making the host wait for the device (on a mesh with
    ``shard``, a ``models.moe.TokenShard``)."""
    from multiverso_tpu_torch.models.moe import moe_ffn

    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}

    def layer():
        out, aux = moe_ffn(leaves, x, top_k=MOE["top_k"],
                           compute_dtype=torch.bfloat16, dispatch=dispatch,
                           capacity_factor=MOE["capacity_factor"],
                           shard=shard)
        torch.autograd.grad(out.float().sum() + aux, list(leaves.values()))

    _, free = without_sync(torch, layer)
    torch.cuda.synchronize()
    return free


def judge_moe(card, cpu, tol=MOE_TOL, aux_tol=MOE_AUX_TOL):
    """({check: value}, verdict) of the MoE checks, card against CPU on
    one seeded 2-layer copy: the capacity dispatch with room for every
    route drops none and equals the dense dispatch on each device; the
    dropped routes per layer are the same on both at cf 1.25 and 0.5
    (some must drop at 0.5); the aux losses agree within ``aux_tol``
    and the logits within ``tol`` of their scale."""
    checks = {
        "ample_vs_dense_card": rel_to_peak(card["ample"]["logits"],
                                           card["dense"]["logits"]),
        "ample_vs_dense_cpu": rel_to_peak(cpu["ample"]["logits"],
                                          cpu["dense"]["logits"]),
        "ample_dropped": sum(card["ample"]["dropped"])
        + sum(cpu["ample"]["dropped"]),
        "dropped_card": {k: card[k]["dropped"] for k in ("cf1.25", "cf0.5")},
        "dropped_cpu": {k: cpu[k]["dropped"] for k in ("cf1.25", "cf0.5")},
        "aux_rel": max(abs(card[k]["aux"] - cpu[k]["aux"]) / abs(cpu[k]["aux"])
                       for k in cpu),
        "logits_card_vs_cpu": max(rel_to_peak(card[k]["logits"],
                                              cpu[k]["logits"])
                                  for k in cpu),
    }
    ok = (checks["ample_vs_dense_card"] <= tol
          and checks["ample_vs_dense_cpu"] <= tol
          and checks["ample_dropped"] == 0
          and checks["dropped_card"] == checks["dropped_cpu"]
          and sum(checks["dropped_cpu"]["cf0.5"]) > 0
          and checks["aux_rel"] <= aux_tol
          and checks["logits_card_vs_cpu"] <= tol)
    return checks, ok


def phase_moe(args, torch, fa, mv, card):
    """bench_moe (E 8, top-2, capacity factor 1.25, full remat, batch 8,
    seq 1024): five steps with each dispatch from one draw of the
    weights, the kernels at its attention shape against their plain
    versions, and the card-against-CPU checks of ``judge_moe``.  Returns
    the runs' launch counts and the kernels' errors at that shape."""
    from multiverso_tpu_torch.models import TransformerConfig, init_params

    base = dict(MOE, max_seq=MOE_SEQ)
    host = init_params(TransformerConfig(**base), seed=0)
    tokens = torch.randint(0, base["vocab_size"], (MOE_BATCH, MOE_SEQ),
                           generator=torch.Generator().manual_seed(1))
    runs, counts = {}, {}
    for disp in ("dense", "capacity"):
        cfg = TransformerConfig(**base, moe_dispatch=disp,
                                compute_dtype=torch.bfloat16)
        runs[disp], tr = train_run(torch, mv, cfg, host, tokens, args.steps,
                                   profile=True)
        del tr
        torch.cuda.empty_cache()
        counts[f"moe_{disp}"] = runs[disp]["launch_counts"]
    layer = {k: v.to("cuda") for k, v in host["layers"][0]["moe"].items()}
    x = torch.randn(MOE_BATCH, MOE_SEQ, base["dim"], device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3))
    sync_free = {disp: moe_layer_sync_free(torch, layer, x, disp)
                 for disp in ("dense", "capacity")}
    del host, layer, x
    torch.cuda.empty_cache()
    heads = base["n_heads"]
    parity, _, _ = parity_case(fa, torch, MOE_BATCH * heads, MOE_SEQ,
                               MOE_SEQ, base["dim"] // heads, torch.bfloat16,
                               True, "moe_t1024", seed=500)
    torch.cuda.empty_cache()
    check_kw = dict(base, n_layers=2, max_seq=MOE_CHECK_SEQ)
    check_host = init_params(TransformerConfig(**check_kw), seed=0)
    check_tokens = torch.randint(0, base["vocab_size"],
                                 (MOE_CHECK_BATCH, MOE_CHECK_SEQ),
                                 generator=torch.Generator().manual_seed(2))
    sides = {dev: moe_check_run(torch, check_kw, check_host, check_tokens,
                                dev) for dev in ("cuda", "cpu")}
    checks, same = judge_moe(sides["cuda"], sides["cpu"])
    dense_s = runs["dense"]["step_s_mean_after_first"]
    cap_s = runs["capacity"]["step_s_mean_after_first"]
    ok = (same and all(run_ok(r, args.steps) for r in runs.values())
          and all(sync_free.values()) and parity["ok"])
    emit({"phase": "moe", "ok": ok, "config": MOE, "batch": MOE_BATCH,
          "seq": MOE_SEQ, "runs": runs,
          "moe_dense_tokens_per_sec": runs["dense"]["tokens_per_s"],
          "moe_capacity_tokens_per_sec": runs["capacity"]["tokens_per_s"],
          "moe_capacity_vs_dense": dense_s / cap_s,
          "checks": checks, "check_shape": [MOE_CHECK_BATCH, MOE_CHECK_SEQ],
          "layer_sync_free": sync_free, "kernel_parity": parity,
          "tol": MOE_TOL, "aux_tol": MOE_AUX_TOL, "card": card})
    if not ok:
        raise AssertionError(
            f"moe phase failed: checks {checks}, sync free {sync_free}, "
            f"kernel parity {parity['ok']}, losses "
            f"{[r['losses'] for r in runs.values()]}, launches "
            f"{[r['launch_counts'] for r in runs.values()]}")
    return counts, {"errors": kernel_errors(parity["errors"]),
                    "shape": [MOE_BATCH, heads, MOE_SEQ, base["dim"] // heads]}


def phase_longctx(args, torch, fa, mv, card):
    """bench_long_context (seq 16,384, batch 1, full remat):
    ``longctx_tokens_per_sec``; the kernels at T 16,384 (bf16, D 128,
    causal) against their plain versions at bh 2, and timed at the
    config's bh 8 beside their bounds and the library calls."""
    from multiverso_tpu_torch.models import TransformerConfig, init_params

    cfg = TransformerConfig(**LONG, max_seq=LONG_SEQ,
                            compute_dtype=torch.bfloat16)
    host = init_params(cfg, seed=0)
    tokens = torch.randint(0, cfg.vocab_size, (LONG_BATCH, LONG_SEQ),
                           generator=torch.Generator().manual_seed(1))
    run, tr = train_run(torch, mv, cfg, host, tokens, args.steps,
                        profile=True)
    del tr
    torch.cuda.empty_cache()
    parity, _, _ = parity_case(fa, torch, LONG_PARITY_BH, LONG_SEQ,
                               LONG_SEQ, cfg.head_dim, torch.bfloat16, True,
                               "long_t16384", seed=400)
    torch.cuda.empty_cache()
    times = kernel_times(fa, torch, LONG_BATCH, cfg.n_heads, LONG_SEQ,
                         cfg.head_dim, plain_bh=LONG_PARITY_BH)
    torch.cuda.empty_cache()
    ok = run_ok(run, args.steps) and parity["ok"]
    emit({"phase": "longctx", "ok": ok, "config": LONG, **run,
          "longctx_tokens_per_sec": run["tokens_per_s"],
          "longctx_seq": float(LONG_SEQ), "kernel_parity": parity,
          "kernel_times": times, "card": card})
    if not ok:
        raise AssertionError(
            f"longctx phase failed: losses {run['losses']}, launches "
            f"{run['launch_counts']}, kernel parity {parity['ok']}")
    return {"launches": run["launch_counts"],
            "errors": kernel_errors(parity["errors"]), "times": times,
            "shape": [LONG_BATCH, cfg.n_heads, LONG_SEQ, cfg.head_dim]}


def phase_longctx64k(args, torch, fa, mv, card):
    """bench_long_context's seq 65,536 run (``longctx64k_tokens_per_sec``)
    and the kernels at T 65,536 against their plain versions, taken in
    blocks, at bh 2."""
    from multiverso_tpu_torch.models import TransformerConfig, init_params

    cfg = TransformerConfig(**LONG, scan_layers=True, max_seq=LONG64K_SEQ,
                            compute_dtype=torch.bfloat16)
    host = init_params(cfg, seed=0)
    tokens = torch.randint(0, cfg.vocab_size, (LONG_BATCH, LONG64K_SEQ),
                           generator=torch.Generator().manual_seed(1))
    run, tr = train_run(torch, mv, cfg, host, tokens, args.steps,
                        profile=True)
    del tr
    torch.cuda.empty_cache()
    parity = blocked_parity_case(fa, torch, LONG_PARITY_BH, LONG64K_SEQ,
                                 cfg.head_dim, True, "long_t65536",
                                 seed=410, block=LONG64K_BLOCK)
    torch.cuda.empty_cache()
    ok = run_ok(run, args.steps) and parity["ok"]
    emit({"phase": "longctx", "ok": ok, "config": dict(LONG,
                                                       scan_layers=True),
          **run, "longctx64k_tokens_per_sec": run["tokens_per_s"],
          "longctx64k_seq": float(LONG64K_SEQ), "kernel_parity": parity,
          "card": card})
    if not ok:
        raise AssertionError(
            f"longctx seq 65,536 failed: losses {run['losses']}, launches "
            f"{run['launch_counts']}, kernel parity {parity['ok']}")
    return {"launches": run["launch_counts"],
            "errors": kernel_errors(parity["errors"]),
            "shape": [LONG_BATCH, cfg.n_heads, LONG64K_SEQ, cfg.head_dim]}


def blocked_plain(fa, x, causal, block, saved=None):
    """The plain versions of the three kernels (``fa._fwd_plain``,
    ``_dq_plain``, ``_dkv_plain``, at their rounding points) computed in
    blocks of ``block`` query rows (o, lse, dq) or key columns (dk, dv),
    so no [bh, T, T] float32 score tensor is ever whole.  Causal blocks
    read only the keys (queries) the mask keeps.  Without ``saved``:
    ``{"o", "lse"}``; with ``saved`` = (lse, delta), as ``run_three``
    takes it: ``{"dq", "dk", "dv"}``."""
    import torch

    q, k, v, do = x["q"], x["k"], x["v"], x["do"]
    scale = q.shape[-1] ** -0.5
    qs = fa._prescale(q, scale)
    T, Tk = q.shape[1], k.shape[1]
    out = {n: [] for n in (("dq",) if saved else ("o", "lse"))}

    def scores(q_blk, k_blk, q0, k0):
        s = torch.einsum("btd,bsd->bts", q_blk.float(), k_blk.float())
        if causal:
            keep = (torch.arange(q0, q0 + s.shape[1], device=s.device)[:, None]
                    >= torch.arange(k0, k0 + s.shape[2],
                                    device=s.device)[None, :])
            s = s.masked_fill(~keep, fa._NEG)
        return s

    for r0 in range(0, T, block):
        r1 = min(r0 + block, T)
        kend = r1 if causal else Tk
        kb, vb = k[:, :kend], v[:, :kend]
        s = scores(qs[:, r0:r1], kb, r0, 0)
        if not saved:
            m = s.amax(-1, keepdim=True)
            p = torch.exp(s - m)
            l = p.sum(-1, keepdim=True).clamp_min(1e-30)
            o = torch.einsum("bts,bsd->btd", p.to(v.dtype).float(),
                             vb.float()) / l
            out["o"].append(o.to(q.dtype))
            out["lse"].append((m + torch.log(l))[..., 0])
            continue
        lse_in, delta = (a.float() for a in saved)
        p = torch.exp(s - lse_in[:, r0:r1, None])
        dp = torch.einsum("btd,bsd->bts", do[:, r0:r1].float(), vb.float())
        ds = p * (dp - delta[:, r0:r1, None])
        dq = torch.einsum("bts,bsd->btd", ds.to(k.dtype).float(), kb.float())
        out["dq"].append((dq * scale).to(q.dtype))
        del s, p, dp, ds
    res = {n: torch.cat(parts, 1) for n, parts in out.items()}
    if not saved:
        return res
    lse_in, delta = (a.float() for a in saved)
    dk, dv = [], []
    for c0 in range(0, Tk, block):
        c1 = min(c0 + block, Tk)
        qstart = c0 if causal else 0
        qb, dob = qs[:, qstart:], do[:, qstart:]
        s = scores(qb, k[:, c0:c1], qstart, c0)
        p = torch.exp(s - lse_in[:, qstart:, None])
        dp = torch.einsum("btd,bsd->bts", dob.float(), v[:, c0:c1].float())
        ds = p * (dp - delta[:, qstart:, None])
        dv.append(torch.einsum("bts,btd->bsd", p.to(do.dtype).float(),
                               dob.float()).to(v.dtype))
        dk.append(torch.einsum("bts,btd->bsd", ds.to(q.dtype).float(),
                               qb.float()).to(k.dtype))
        del s, p, dp, ds
    res["dk"], res["dv"] = torch.cat(dk, 1), torch.cat(dv, 1)
    return res


def blocked_parity_case(fa, torch, bh, t, d, causal, tag, seed, block):
    """``parity_case`` with the plain side in blocks (``blocked_plain``)."""
    x = attn_inputs(bh, t, d, torch.bfloat16, seed=seed)
    want = blocked_plain(fa, x, causal, block)
    saved = (want["lse"], (x["do"].float() * want["o"].float()).sum(-1)
             - x["dlse"])
    want.update(blocked_plain(fa, x, causal, block, saved))
    got = run_three(fa, x, causal, False, saved)
    torch.cuda.synchronize()
    errs, ok = compare(got, want)
    return {"case": tag, "bh": bh, "T": t, "Tk": t, "D": d,
            "dtype": "bfloat16", "causal": causal, "ok": ok,
            "plain_block": block, "errors": errs}


def ring_pieces(t, sp, layout):
    """The flash pieces of one causal ring call at sequence length t over
    sp ranks, summed over the ranks: [(tq, tk, causal, count)]."""
    if layout == "zigzag":
        c, pairs = t // (2 * sp), sp * (sp - 1) // 2
        return [(c, c, True, 2 * sp), (c, c, False, sp),
                (2 * c, c, False, pairs), (c, 2 * c, False, pairs)]
    n = t // sp
    return [(n, n, True, sp), (n, n, False, sp * (sp - 1) // 2)]


def ring_launches(sp, layout):
    """Forward launches of each virtual rank's schedule (each piece is
    one flash forward; its backward one dq and one dkv)."""
    if layout == "zigzag":
        return [3 + sp - 1 for _ in range(sp)]
    return [1 + r for r in range(sp)]


def ring_case(fa, torch, shape, dtype, layout, seed, shift=0):
    """Every virtual rank's schedule of an sp ring (``RING_SP``) through
    the port's ``ring_attention_shard`` with an in-process rotation,
    forward and backward (do and a nonzero lse cotangent), against
    single-device flash attention on the same inputs.  Returns (result
    line, ring ms, single-device ms)."""
    from multiverso_tpu_torch.parallel import (InProcessRing,
                                               ring_attention_shard,
                                               sequence_positions)

    B, H, T, D = shape
    zigzag = layout == "zigzag"
    x = attn_inputs(B * H, T, D, dtype, seed=seed)
    q, k, v, do = (x[n].view(B, H, T, D) for n in ("q", "k", "v", "do"))
    dlse = x["dlse"].view(B, H, T)
    pos = [sequence_positions(T, RING_SP, r, zigzag, q.device)
           for r in range(RING_SP)]
    everywhere = torch.cat(pos)

    def ring():
        qs, ks, vs = ([a.index_select(2, p).detach().requires_grad_()
                       for p in pos] for a in (q, k, v))
        rot = InProcessRing(ks, vs, shift=shift)
        fwd, outs = [], []
        fa.reset_launch_counts()
        for r in range(RING_SP):
            before = fa.launch_counts()["flash_fwd"]
            outs.append(ring_attention_shard(qs[r], ks[r], vs[r], r, RING_SP,
                                             rot.rotate_for(r), True, None,
                                             zigzag))
            fwd.append(fa.launch_counts()["flash_fwd"] - before)
        torch.autograd.backward(
            [a for o in outs for a in o],
            [g for p in pos for g in (do.index_select(2, p),
                                      dlse.index_select(2, p))])
        bwd = fa.launch_counts()
        bwd["flash_fwd"] -= sum(fwd)
        pieces = {}
        for (kname, tq, tk, causal), n in fa.launch_shapes().items():
            pieces.setdefault((tq, tk, causal), {})[kname] = n

        def whole(parts):
            cat = torch.cat(parts, 2)
            return torch.empty_like(cat).index_copy_(2, everywhere, cat)

        res = {"o": whole([o for o, _ in outs]),
               "lse": whole([lse for _, lse in outs]),
               "dq": whole([a.grad for a in qs]),
               "dk": whole([a.grad for a in ks]),
               "dv": whole([a.grad for a in vs])}
        return res, fwd, bwd, pieces

    def single():
        qq, kk, vv = (a.detach().requires_grad_() for a in (q, k, v))
        o, lse = fa.flash_attention(qq, kk, vv, causal=True,
                                    return_lse=True)
        torch.autograd.backward([o, lse], [do, dlse])
        return {"o": o.detach(), "lse": lse.detach(), "dq": qq.grad,
                "dk": kk.grad, "dv": vv.grad}

    want = single()
    got, fwd, bwd, pieces = ring()
    torch.cuda.synchronize()
    errs, ok = compare({n: a.flatten(0, 1) for n, a in got.items()},
                       {n: a.flatten(0, 1) for n, a in want.items()})
    expected = ring_launches(RING_SP, layout)
    schedule = {(tq, tk, causal): {k: n for k in KERNELS}
                for tq, tk, causal, n in ring_pieces(T, RING_SP, layout)}
    launches_ok = (fwd == expected and bwd["flash_fwd"] == 0
                   and bwd["flash_dq"] == sum(expected)
                   and bwd["flash_dkv"] == sum(expected)
                   and pieces == schedule)
    del got, want
    ring_ms = cuda_ms(lambda: ring(), iters=3, warmup=1)
    single_ms = cuda_ms(lambda: single(), iters=3, warmup=1)
    return ({"case": f"ring_sp{RING_SP}_{layout}", "shape": list(shape),
             "dtype": str(dtype).split(".")[-1], "shift": shift,
             "ok": ok and (launches_ok or shift != 0),
             "launches_ok": launches_ok,
             "fwd_launches_per_rank": fwd, "fwd_launches_expected": expected,
             "bwd_launches": bwd, "launches_by_piece": [
                 {"tq": tq, "tk": tk, "causal": causal, **n}
                 for (tq, tk, causal), n in sorted(pieces.items())],
             "errors": errs}, ring_ms, single_ms)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mesh_trainer_check(torch, mv, card, host):
    """Check (1): the trainer's full-width config through the mesh code
    over NCCL at world size 1 against the no-mesh trainer, from one draw
    of the masters on one batch, in turns (no mesh, mesh, mesh, no mesh:
    the first run of a process pays the allocator's growth).  Every run
    must equal the first bit for bit.  Returns the mesh runs' launch
    counts (the first)."""
    import torch.distributed as dist

    from multiverso_tpu_torch.parallel import make_mesh

    cfg = large_config(torch)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, SEQ),
                           generator=torch.Generator().manual_seed(1))
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_mesh((1, 1, 1), ("dp", "sp", "tp"))
        backend = dist.get_backend()
        runs, want, diffs = [], None, []
        for on_mesh in (False, True, True, False):
            run, tr = train_run(torch, mv, cfg, host, tokens, MESH_STEPS,
                                mesh=mesh if on_mesh else None)
            got = snapshot(tr.params)
            del tr
            torch.cuda.empty_cache()
            if want is None:
                want = got
            diffs.append(max(float(np.abs(g - w).max())
                             for g, w in zip(got, want)))
            run["mesh"] = on_mesh
            runs.append(run)
            del got
    finally:
        dist.destroy_process_group()
    base = runs[0]
    same = (all(d == 0.0 for d in diffs)
            and all(r["losses"] == base["losses"] for r in runs))
    ok = (same and all(run_ok(r, MESH_STEPS) for r in runs)
          and backend == "nccl")
    emit({"phase": "mesh", "check": "trainer_one_rank", "ok": ok,
          "backend": backend, "mesh": {"dp": 1, "sp": 1, "tp": 1},
          "steps": MESH_STEPS, "order": [r["mesh"] for r in runs],
          "losses": [r["losses"] for r in runs], "bitwise_equal": same,
          "max_abs_diff_vs_first": diffs,
          "step_s_mean_after_first": [r["step_s_mean_after_first"]
                                      for r in runs],
          "tokens_per_s": [r["tokens_per_s"] for r in runs],
          "peak_mem_bytes": [r["peak_mem_bytes"] for r in runs],
          "launch_counts": [r["launch_counts"] for r in runs],
          "launches_expected": base["launches_expected"], "card": card})
    if not ok:
        raise AssertionError(
            f"mesh trainer at one NCCL rank differs from the no-mesh "
            f"trainer: max differences {diffs}, losses "
            f"{[r['losses'] for r in runs]}")
    return runs[1]["launch_counts"]


def phase_mesh(args, torch, fa, mv, card, host):
    """Checks (1) to (3) of the mesh phase (see the module docstring).
    Returns the launch counts of its paths and the kernels at the ring's
    piece shapes."""
    counts = {"mesh": mesh_trainer_check(torch, mv, card, host)}
    shapes, results, times = {}, [], {}
    for dtype, shape in ((torch.bfloat16, RING_BF16),
                         (torch.float32, RING_F32)):
        for i, layout in enumerate(("contiguous", "zigzag")):
            res, ring_ms, single_ms = ring_case(fa, torch, shape, dtype,
                                                layout, seed=700 + i)
            res.update(ring_ms=ring_ms, single_device_ms=single_ms)
            results.append(res)
            torch.cuda.empty_cache()
            if dtype == torch.bfloat16:
                counts[f"ring_sp{RING_SP}_{layout}"] = {
                    "flash_fwd": sum(res["fwd_launches_per_rank"]),
                    "flash_dq": res["bwd_launches"]["flash_dq"],
                    "flash_dkv": res["bwd_launches"]["flash_dkv"]}
    faults = []
    for i, layout in enumerate(("contiguous", "zigzag")):
        res, _, _ = ring_case(fa, torch, RING_F32, torch.float32, layout,
                              seed=700 + i, shift=1)
        faults.append({"fault": f"rotation_off_by_one_{layout}",
                       "rejected": not res["ok"], "errors": res["errors"]})
    emit({"phase": "mesh", "check": "ring_sp4", "sp": RING_SP,
          "ok": all(r["ok"] for r in results), "cases": results,
          "planted_faults": faults, "f32_tol": F32_TOL,
          "bf16_tol": BF16_TOL, "card": card})
    if not all(r["ok"] for r in results):
        raise AssertionError("the sp 4 ring disagrees with single-device "
                             "attention, or launched other kernels than "
                             "its schedule")
    if not all(f["rejected"] for f in faults):
        raise AssertionError("the ring check accepted a rotation that "
                             "hands each rank the wrong blocks")
    # The pieces the bf16 rings launched, as their wrappers counted them.
    B, H, T, D = RING_BF16
    pieces = {}
    for res in results:
        if res["dtype"] != "bfloat16":
            continue
        layout = res["case"].rsplit("_", 1)[1]
        for row in res["launches_by_piece"]:
            tq, tk, causal = row["tq"], row["tk"], row["causal"]
            key = f"{tq}x{tk}_{'causal' if causal else 'full'}"
            pieces.setdefault(key, (tq, tk, causal, {}))[3][layout] = {
                k: row[k] for k in KERNELS}
    ok = True
    for i, (key, (tq, tk, causal, per_call)) in enumerate(pieces.items()):
        parity, _, _ = parity_case(fa, torch, B * H, tq, tk, D,
                                   torch.bfloat16, causal, f"ring_{key}",
                                   seed=720 + i)
        torch.cuda.empty_cache()
        t = kernel_times(fa, torch, B, H, tq, D, tk=tk, causal=causal)
        torch.cuda.empty_cache()
        times[key] = t
        ok = ok and parity["ok"]
        shapes[f"ring_{key}"] = {"errors": kernel_errors(parity["errors"]),
                                 "times": t, "shape": [B, H, tq, tk, D],
                                 "causal": causal,
                                 "launches_per_ring_call": per_call}
        emit({"phase": "mesh", "check": "ring_piece", "piece": key,
              "ok": parity["ok"], "launches_per_ring_call": per_call,
              "kernel_parity": parity, "kernel_times": t, "card": card})
    if not ok:
        raise AssertionError("a kernel disagrees with its plain version at "
                             "a ring piece's shape")
    return counts, shapes


# --------------------------------------------------- the moe_mesh phase


def _local_plan(experts, num_experts, capacity, top_k, shard):
    """Planted fault: each rank plans the buckets from its own routes
    alone (a per-rank slot order), at the global capacity."""
    from multiverso_tpu_torch.models import moe

    return moe.capacity_plan(experts, num_experts, capacity)


def _local_stats(stats, n, shard):
    """Planted fault: each rank's load-balancing means over its own
    tokens (a per-rank aux loss)."""
    return stats, n


def _router_over_ep(plain):
    """Planted fault: a ``_sum_grads`` that also sums every router's
    gradient over ep (the aux term then counts ep times)."""
    def summed(self, grads):
        from multiverso_tpu_torch.models.transformer import _with_leaves
        from multiverso_tpu_torch.parallel.collectives import \
            all_reduce_grads

        plain(self, grads)
        tree = _with_leaves(self.params, grads)
        all_reduce_grads([lyr["moe"]["router"] for lyr in tree["layers"]],
                         self.mesh, ("ep",))

    return summed


@contextlib.contextmanager
def planted_moe_fault(fault):
    """Plant ``fault`` ("local_slots", "local_aux", "router_over_ep", or
    None for none) in the MoE mesh path for the body."""
    from multiverso_tpu_torch.models import moe
    from multiverso_tpu_torch.models.transformer import TransformerTrainer

    if fault is None:
        yield
        return
    owner, name = {"local_slots": (moe, "_global_plan"),
                   "local_aux": (moe, "_global_stats"),
                   "router_over_ep": (TransformerTrainer, "_sum_grads")
                   }[fault]
    keep = getattr(owner, name)
    setattr(owner, name, {"local_slots": _local_plan,
                          "local_aux": _local_stats,
                          "router_over_ep": _router_over_ep(keep)}[fault])
    try:
        yield
    finally:
        setattr(owner, name, keep)


def moe_layout(device_count: int):
    """(backend, world) of the several-rank MoE runs: an NCCL rank per
    card on four cards (or two), else 2 gloo ranks sharing ``cuda:0``."""
    if device_count >= 4:
        return "nccl", 4
    return ("nccl", 2) if device_count >= 2 else ("gloo", 2)


def moe_meshes(world: int):
    """[(key, sizes, names)] the ranks run, and [(fault, key, dispatch)]
    the planted faults they run: the per-rank slot order and aux loss
    need the tokens split (dp), the router's sum over ep the experts
    split (ep)."""
    if world == 4:
        meshes = [("dpep", [2, 2], ["dp", "ep"]), ("ep4", [4], ["ep"])]
        faults = [("local_slots", "dpep", "capacity"),
                  ("local_aux", "dpep", "dense"),
                  ("router_over_ep", "dpep", "dense")]
    else:
        meshes = [("ep2", [2], ["ep"]), ("dp2", [2], ["dp"])]
        faults = [("local_slots", "dp2", "capacity"),
                  ("local_aux", "dp2", "dense"),
                  ("router_over_ep", "ep2", "dense")]
    return meshes, faults


def moe_mesh_spec(backend, world, device="cuda", **cfg_kw):
    """What the ranks run (written to a JSON file they read): the moe
    phase's 2-layer float32 copy of bench_moe at its check shape, at a
    capacity factor where routes overflow, on ``moe_meshes(world)``."""
    meshes, faults = moe_meshes(world)
    cfg = {**MOE, "n_layers": 2, "max_seq": MOE_CHECK_SEQ,
           "capacity_factor": MOE_MESH_CF, **cfg_kw}
    return {"backend": backend, "world": world, "device": device,
            "cfg": cfg, "batch": MOE_CHECK_BATCH,
            "seq": min(MOE_CHECK_SEQ, cfg["max_seq"]),
            "steps": MOE_MESH_STEPS, "meshes": meshes, "faults": faults}


def moe_trained(torch, cfg, host, tokens, device, mesh, steps):
    """``steps`` momentum steps of an MoE trainer from ``host``: losses,
    the routes the first step's capacity plans dropped, the step times,
    and the gathered tree (every parameter, then every slot) as host
    arrays (a collective under a mesh)."""
    from multiverso_tpu_torch.models import TransformerTrainer, moe
    from multiverso_tpu_torch.models.transformer import _leaves

    tr = TransformerTrainer(cfg, device=device, updater_type="momentum",
                            params=host, mesh=mesh)
    losses, step_s, dropped = [], [], []
    for i in range(steps):
        s0 = time.perf_counter()
        loss, seen = dropped_routes(moe, lambda: tr.train_step_async(tokens))
        losses.append(float(loss))
        step_s.append(time.perf_counter() - s0)
        dropped = dropped or seen
    tree = tr._full_tree()
    arrays = ([host_array(a) for a in _leaves(tree["params"])]
              + [host_array(a) for sl in _leaves(tree["state"]) for a in sl])
    return {"losses": losses, "step_s": step_s,
            "dropped_first_step": sum(dropped)}, arrays


def judge_moe_mesh(got, want, tol=MOE_MESH_TOL):
    """({check: error}, verdict): a mesh run against the run in one
    process — the losses by relative error, every parameter and slot by
    max |got - want| / (max |want| + |want|), the rtol at which the CPU
    tests' check (a floor at rtol times the tensor's largest entry)
    passes; each at most ``tol``."""
    (g_run, g_arrays), (w_run, w_arrays) = got, want
    g_loss = np.asarray(g_run["losses"], np.float64)
    w_loss = np.asarray(w_run["losses"], np.float64)
    errs = {"losses": (float(np.max(np.abs(g_loss - w_loss) / np.abs(w_loss)))
                       if g_loss.shape == w_loss.shape else math.inf)}
    worst = 0.0 if len(g_arrays) == len(w_arrays) else math.inf
    for g, w in zip(g_arrays, w_arrays):
        if np.shape(g) != np.shape(w):
            worst = math.inf
            break
        # float32 throughout: the trees hold 10^8 entries and more.
        w = np.asarray(w, np.float32)
        den = np.abs(w)
        den += den.max() or np.float32(1)
        d = np.abs(np.asarray(g, np.float32) - w)
        d /= den
        top = float(d.max())
        worst = max(worst, top if math.isfinite(top) else math.inf)
    errs["tree"] = worst
    return errs, all(e <= tol for e in errs.values())


def moe_mesh_rank(argv) -> int:
    """One rank of the moe_mesh phase (``chip_smoke.py --moe-rank <rank>
    <spec.json> <store> <out dir>``): joins the group, runs the spec's
    meshes and planted faults for each dispatch, and writes
    ``rank<r>.json``.  Rank 0 also runs each dispatch in one process
    first and judges every mesh run against it."""
    import datetime

    rank, spec_path, store, out_dir = (int(argv[0]), argv[1], argv[2],
                                       argv[3])
    sys.path.insert(0, HERE)
    import torch
    import torch.distributed as dist

    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if spec["device"] == "cuda":
        device = shard_device(spec["backend"], rank)
        torch.cuda.set_device(device)
    else:
        device = "cpu"
        torch.set_num_threads(1)
    dist.init_process_group(
        spec["backend"], init_method="file://" + store,
        world_size=spec["world"], rank=rank,
        timeout=datetime.timedelta(seconds=MOE_MESH_TIMEOUT_S))
    from multiverso_tpu_torch.models import TransformerConfig, init_params
    from multiverso_tpu_torch.parallel import make_mesh

    def config(dispatch):
        return TransformerConfig(**{**spec["cfg"], "moe_dispatch": dispatch},
                                 compute_dtype=torch.float32)

    host = init_params(config("dense"), seed=0)
    tokens = torch.randint(0, spec["cfg"]["vocab_size"],
                           (spec["batch"], spec["seq"]),
                           generator=torch.Generator().manual_seed(2))
    dispatches = ("dense", "capacity")
    refs = {d: moe_trained(torch, config(d), host, tokens, device, None,
                           spec["steps"]) for d in dispatches} \
        if rank == 0 else {}
    runs, faults = [], []
    for key, sizes, names in spec["meshes"]:
        mesh = make_mesh(sizes, names, device=device)
        todo = [(d, None) for d in dispatches] + [
            (d, fault) for fault, at, d in spec["faults"] if at == key]
        for dispatch, fault in todo:
            with planted_moe_fault(fault):
                got = moe_trained(torch, config(dispatch), host, tokens,
                                  device, mesh, spec["steps"])
            row = {"mesh": key, "dispatch": dispatch, **got[0]}
            if rank == 0:
                row["errors"], row["ok"] = judge_moe_mesh(got, refs[dispatch])
            (runs if fault is None else faults).append(
                {**row, **({"fault": fault} if fault else {})})
            del got
    out = {"rank": rank, "world": spec["world"], "backend": spec["backend"],
           "device": str(device), "runs": runs, "faults": faults}
    if rank == 0:
        out["reference"] = {d: r[0] for d, r in refs.items()}
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def launch_moe_ranks(spec, out_dir, timeout=MOE_MESH_TIMEOUT_S):
    """Run the spec's ranks (processes of this script) under ``timeout``
    (all killed on expiry); returns [each rank's json] and the
    seconds."""
    spec_path = os.path.join(out_dir, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    store = os.path.join(out_dir, "store")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--moe-rank", str(r),
         spec_path, store, out_dir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(spec["world"])]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise AssertionError(f"moe_mesh ranks did not finish within "
                             f"{timeout} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"moe_mesh rank {r} failed:\n{log[-4000:]}")
    ranks = []
    for r in range(spec["world"]):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks, time.perf_counter() - t0


def judge_moe_ranks(rank0):
    """({check: verdict}, every mesh run held the one-process run and
    every capacity run dropped routes, every planted fault rejected)."""
    verdicts = {}
    for run in rank0["runs"]:
        name = f"{run['mesh']}_{run['dispatch']}"
        verdicts[name] = run["ok"]
        if run["dispatch"] == "capacity":
            verdicts[name + "_dropped"] = run["dropped_first_step"] > 0
    for run in rank0["faults"]:
        verdicts[f"{run['fault']}_rejected"] = not run["ok"]
    return verdicts, bool(verdicts) and all(verdicts.values())


def moe_one_rank_check(torch, mv, card):
    """Check (1): bench_moe at full width through the mesh code at one
    NCCL rank, a mesh (dp, sp, tp, ep) of 1s, against the no-mesh trainer
    from the same draw, each dispatch: every loss and parameter bit for
    bit after MOE_MESH_STEPS steps, and one MoE layer through the mesh
    path without a host sync (each run also profiles one more step).
    Returns the mesh runs' launch counts."""
    import torch.distributed as dist

    from multiverso_tpu_torch.models import TransformerConfig, init_params
    from multiverso_tpu_torch.models.moe import TokenShard
    from multiverso_tpu_torch.parallel import make_mesh

    base = dict(MOE, max_seq=MOE_SEQ)
    host = init_params(TransformerConfig(**base), seed=0)
    tokens = torch.randint(0, base["vocab_size"], (MOE_BATCH, MOE_SEQ),
                           generator=torch.Generator().manual_seed(1))
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    counts, runs, ok = {}, {}, True
    try:
        mesh = make_mesh((1, 1, 1, 1), ("dp", "sp", "tp", "ep"))
        layer = {k: v.to("cuda") for k, v in host["layers"][0]["moe"].items()}
        x = torch.randn(MOE_BATCH, MOE_SEQ, base["dim"], device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(3))
        n = MOE_BATCH * MOE_SEQ
        shard = TokenShard(mesh, torch.arange(n, device="cuda"), n)
        for disp in ("dense", "capacity"):
            cfg = TransformerConfig(**base, moe_dispatch=disp,
                                    compute_dtype=torch.bfloat16)
            sync_free = moe_layer_sync_free(torch, layer, x, disp, shard)
            pair = []
            for on_mesh in (False, True):
                run, tr = train_run(torch, mv, cfg, host, tokens,
                                    MOE_MESH_STEPS, profile=True,
                                    mesh=mesh if on_mesh else None)
                pair.append((run, snapshot(tr.params)))
                del tr
                torch.cuda.empty_cache()
            (plain, want), (meshed, got) = pair
            diff = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
            same = diff == 0.0 and meshed["losses"] == plain["losses"]
            ok = ok and same and sync_free and all(
                run_ok(r, MOE_MESH_STEPS) for r, _ in pair)
            counts[f"moe_mesh_{disp}"] = meshed["launch_counts"]
            runs[disp] = {"bitwise_equal": same, "max_abs_diff": diff,
                          "layer_sync_free_on_mesh": sync_free,
                          "step_s": [plain["step_s"], meshed["step_s"]],
                          "profile": [plain["profile"], meshed["profile"]],
                          "losses": [plain["losses"], meshed["losses"]],
                          "step_s_mean_after_first": [
                              plain["step_s_mean_after_first"],
                              meshed["step_s_mean_after_first"]],
                          "tokens_per_s": [plain["tokens_per_s"],
                                           meshed["tokens_per_s"]],
                          "peak_mem_bytes": meshed["peak_mem_bytes"],
                          "launch_counts": meshed["launch_counts"],
                          "launches_expected": meshed["launches_expected"]}
            del pair, want, got
        del layer, x, shard
    finally:
        dist.destroy_process_group()
    emit({"phase": "moe_mesh", "check": "one_rank", "ok": ok,
          "mesh": {"dp": 1, "sp": 1, "tp": 1, "ep": 1}, "config": MOE,
          "batch": MOE_BATCH, "seq": MOE_SEQ, "steps": MOE_MESH_STEPS,
          "order": ["no mesh", "mesh"], "runs": runs, "card": card})
    if not ok:
        raise AssertionError(f"MoE at one NCCL rank differs from the "
                             f"no-mesh trainer: {runs}")
    return counts


def small_offload_setup(torch, cfg_kw=SMALL, seq=SMALL_SEQ,
                        batch=SMALL_BATCH, dtype="bfloat16"):
    """bench_transformer's config (dim 512) and one draw of its masters
    and tokens: what every offload arm starts from."""
    from multiverso_tpu_torch.models import TransformerConfig, init_params

    cfg = TransformerConfig(**cfg_kw, max_seq=seq,
                            compute_dtype=getattr(torch, dtype))
    host = init_params(cfg, seed=0)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                           generator=torch.Generator().manual_seed(1))
    return cfg, host, tokens


def offload_arm(torch, cfg, host, tokens, store=None, rt=None,
                device=None, steps=MOE_MESH_STEPS, bridge_hook=None):
    """``steps`` momentum steps of a trainer from ``host``, its state in
    memory (``store`` None) or offloaded to ``OffloadedState`` with that
    backend (``"native"`` over the runtime ``rt``); ``bridge_hook``
    may wrap the bridge first (a planted fault).  Returns the losses,
    the host-clock step times, the parameters, the state (fetched from
    the bridge when offloaded), the state's size and the bridge's
    ``push_s``/``wait_s`` p50s."""
    from multiverso_tpu_torch import metrics
    from multiverso_tpu_torch.models import TransformerTrainer
    from multiverso_tpu_torch.parallel import OffloadedState

    tr = TransformerTrainer(cfg, updater_type="momentum", params=host,
                            device=device)
    bridge = None
    if store is not None:
        for name in ("bridge.push_s", "bridge.wait_s"):
            metrics.REGISTRY.remove(name)
        bridge = OffloadedState(rt, tr.offload_size(), backend=store)
        if bridge_hook is not None:
            bridge = bridge_hook(bridge)
        tr.offload_state(bridge)
    losses, step_s = [], []
    for _ in range(steps):
        s0 = time.perf_counter()
        losses.append(float(tr.train_step_async(tokens)))
        step_s.append(time.perf_counter() - s0)
    state = tr._flat_to_state(bridge.wait()) if bridge else tr.state
    p50 = ({k: metrics.histogram(f"bridge.{k}").quantile(0.5)
            for k in ("push_s", "wait_s")} if bridge else {})
    out = (losses, step_s, snapshot(tr.params),
           [host_array(a) for sl in state for a in sl], tr.offload_size(),
           p50)
    if bridge is not None:
        bridge.close()
    del tr, state, bridge
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def judge_offload_arms(ref, arms):
    """Each arm's losses, parameters and state against ``ref``'s, bit for
    bit (``offload_arm`` results).  Returns ({arm: equal}, all equal)."""
    def same(a, b):
        return (a[0] == b[0] and len(a[2]) == len(b[2])
                and len(a[3]) == len(b[3])
                and all(np.array_equal(x, y) for x, y in zip(a[2], b[2]))
                and all(np.array_equal(x, y) for x, y in zip(a[3], b[3])))

    verdict = {name: same(arm, ref) for name, arm in arms.items()}
    return verdict, all(verdict.values())


def offload_check(torch, card):
    """Check (4): bench_transformer's config (dim 512) with momentum, 3
    steps with the state offloaded to the local store against 3 in
    memory from the same draw: losses, parameters and state bit for bit,
    and both step times."""
    cfg, host, tokens = small_offload_setup(torch)
    mem = offload_arm(torch, cfg, host, tokens)
    off = offload_arm(torch, cfg, host, tokens, "local")
    _, same = judge_offload_arms(mem, {"local": off})
    n = mem[4]
    res = {"bitwise_equal": same, "losses": [mem[0], off[0]],
           "step_s": {"in_memory": mem[1], "offloaded": off[1]},
           "state_elements": n, "state_bytes": 4 * n}
    emit({"phase": "moe_mesh", "check": "offload", "ok": same,
          "config": SMALL, "batch": SMALL_BATCH, "seq": SMALL_SEQ, **res,
          "card": card})
    if not same:
        raise AssertionError(f"the offloaded trainer differs from the "
                             f"in-memory one: {res}")


def phase_moe_mesh(torch, mv, card):
    """The moe_mesh phase (see the module docstring).  Returns the
    launch counts of the one-rank runs."""
    import tempfile

    counts = moe_one_rank_check(torch, mv, card)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    backend, world = moe_layout(torch.cuda.device_count())
    spec = moe_mesh_spec(backend, world)
    with tempfile.TemporaryDirectory(prefix="mvt_moe_") as out_dir:
        ranks, ranks_s = launch_moe_ranks(spec, out_dir)
    verdicts, ok = judge_moe_ranks(ranks[0])
    emit({"phase": "moe_mesh", "check": "ranks", "ok": ok,
          "backend": backend, "world": world, "ranks_s": ranks_s,
          "config": spec["cfg"], "batch": spec["batch"], "seq": spec["seq"],
          "steps": spec["steps"], "tol": MOE_MESH_TOL, "verdicts": verdicts,
          "reference": ranks[0]["reference"], "runs": ranks[0]["runs"],
          "planted_faults": ranks[0]["faults"], "card": card})
    if not ok:
        raise AssertionError(f"moe_mesh ranks failed: {verdicts}")
    offload_check(torch, card)
    return counts


# ------------------------------------------------------ the shard phase


def shard_layout(device_count: int):
    """(backend, world): an NCCL rank per card with two cards or more,
    else 2 gloo ranks sharing ``cuda:0``."""
    return ("nccl", device_count) if device_count >= 2 else ("gloo", 2)


def shard_device(backend: str, rank: int) -> str:
    """Rank ``rank``'s card: its own under NCCL, ``cuda:0`` under gloo."""
    return f"cuda:{rank}" if backend == "nccl" else "cuda:0"


def np_dense_apply(w, g, updater, lr, eps=1e-8):
    """numpy's dense add into a fresh table (state zero): SGD or AdaGrad
    in float32, as the port's updaters compute it."""
    w, g = np.asarray(w, np.float32), np.asarray(g, np.float32)
    lr = np.float32(lr)
    if updater == "sgd":
        return w - lr * g
    h = g * g
    return w - lr * g / (np.sqrt(h) + np.float32(eps))


def shard_row_batch(rank, rows, cols, world):
    """Rank ``rank``'s ``add_rows`` batch: SHARD_IDS ids with duplicates,
    a quarter of them shared by every rank, and batch-mean-sized deltas."""
    rng = np.random.RandomState(40 + rank)
    shared = np.random.RandomState(39).randint(rows, size=SHARD_IDS // 4)
    ids = np.concatenate([shared, rng.randint(
        rows, size=SHARD_IDS - shared.size)]).astype(np.int64)
    g = (rng.randn(SHARD_IDS, cols) / SHARD_IDS).astype(np.float32)
    return ids, g


def shifted_shard(shard):
    """The planted fault: ``shard`` with its offset one row past its own
    (its owned rows follow the offset)."""
    from multiverso_tpu_torch.parallel.sharding import TableShard

    class Shifted(TableShard):
        @property
        def offset(self):
            return self.rank * self.size + 1

    return Shifted(*shard)


def block_bytes(t) -> int:
    data, state = t.raw_value()
    return sum(x.numel() * x.element_size() for x in (data, *state))


def made_table(torch, device, make):
    """(table, bytes ``torch.cuda.memory_allocated`` grew by while
    ``make()`` built it)."""
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    t = make()
    torch.cuda.synchronize(device)
    return t, torch.cuda.memory_allocated(device) - before


def block_checks(t, grown, world, cols=None):
    """Each rank's block: ``ceil(rows / world)`` rows in ``_data`` and
    every state tensor, and the bytes the allocator grew by equal to
    theirs (each tensor rounds up to 512 bytes)."""
    data, state = t.raw_value()
    rows = getattr(t, "num_rows", None) or t.size
    want = -(-rows // world)
    lengths = [x.shape[0] for x in (data, *state)]
    nbytes = block_bytes(t)
    return {"rows": rows, "block_rows": lengths, "want_block_rows": want,
            "block_bytes": nbytes, "allocated_growth": grown,
            "ok": (all(n == want for n in lengths)
                   and 0 <= grown - nbytes <= 512 * len(lengths))}


def timed(torch, device, fn, reps=3):
    """Seconds of the fastest of ``reps`` calls of ``fn`` (a collective on
    every rank; the card synchronized around each)."""
    best = math.inf
    for _ in range(reps):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return best


def shard_array_checks(torch, mv, rank, world, device):
    """ArrayTables of TABLE_SIZE under SGD and AdaGrad, ASP and BSP."""
    out = {}
    start = np.random.RandomState(11).randn(TABLE_SIZE).astype(np.float32)
    deltas = [np.random.RandomState(20 + r).randn(TABLE_SIZE).astype(
        np.float32) for r in range(world)]
    total = np.sum(deltas, axis=0, dtype=np.float32)
    for upd in ("sgd", "adagrad"):
        for sync in (False, True):
            name = f"array_{upd}_{'bsp' if sync else 'asp'}"
            t, grown = made_table(torch, device, lambda: mv.ArrayTable(
                TABLE_SIZE, init=start, updater_type=upd, sync=sync,
                name=name, default_option=mv.AddOption(
                    learning_rate=SHARD_LR)))
            res = {"block": block_checks(t, grown, world)}
            t.add(deltas[rank])
            if sync:
                res["before_barrier_unchanged"] = bool(
                    np.array_equal(t.get(), start))
                mv.barrier()
            res["change_rel_error"] = rel_change(
                t.get(), np_dense_apply(start, total, upd, SHARD_LR), start)
            res["ok"] = (res["block"]["ok"]
                         and res["change_rel_error"] <= SHARD_TOL
                         and res.get("before_barrier_unchanged", True))
            if not sync:
                add_s = timed(torch, device, lambda: t.add(deltas[rank]))
                get_s = timed(torch, device, t.get)
                res.update(add_ms=add_s * 1e3, get_ms=get_s * 1e3,
                           add_gbps=TABLE_SIZE * 4 / add_s / 1e9,
                           get_gbps=TABLE_SIZE * 4 / get_s / 1e9)
            out[name] = res
            t.close()
    return out


def shard_rows_check(torch, mv, rank, world, device, rows, cols, upd,
                     name, fault=False):
    """A MatrixTable of ``rows`` x ``cols`` from a random start: every
    rank's ``add_rows`` batch, then ``get_rows`` of the next rank's ids
    and the whole ``get()``, against numpy; with ``fault``, the last
    rank's shard offset is one row off."""
    lr = W2V_LR * SHARD_IDS if upd == "sgd" else W2V_LR
    eps = W2V_ADAGRAD_EPS
    start = ((np.random.RandomState(12).rand(rows, cols) - 0.5)
             / cols).astype(np.float32)
    t, grown = made_table(torch, device, lambda: mv.MatrixTable(
        rows, cols, init=start, updater_type=upd, name=name,
        default_option=mv.AddOption(learning_rate=lr, eps=eps)))
    if fault and rank == world - 1:
        t.shard = shifted_shard(t.shard)
    res = {"block": block_checks(t, grown, world)}
    batches = [shard_row_batch(r, rows, cols, world) for r in range(world)]
    t.add_rows(*batches[rank])
    want, h = start.copy(), np.zeros_like(start)
    _np_row_apply(want, h, np.concatenate([b[0] for b in batches]),
                  np.concatenate([b[1] for b in batches]), lr, eps, upd)
    read = batches[(rank + 1) % world][0][:1024]
    res["get_rows_rel_error"] = rel_change(t.get_rows(read), want[read],
                                           start[read])
    res["get_rel_error"] = rel_change(t.get(), want, start)
    res["ok"] = (res["block"]["ok"] and res["get_rows_rel_error"] <= SHARD_TOL
                 and res["get_rel_error"] <= SHARD_TOL)
    if not fault:
        ids, g = batches[rank]
        add_s = timed(torch, device, lambda: t.add_rows(ids, g))
        get_s = timed(torch, device, lambda: t.get_rows(ids))
        res.update(add_rows_ms=add_s * 1e3, get_rows_ms=get_s * 1e3,
                   add_rows_per_sec=SHARD_IDS / add_s,
                   get_rows_per_sec=SHARD_IDS / get_s)
    t.close()
    return res


def shard_app_runs(torch, mv, tag):
    """LR's fused steps (phase 8's shape) and word2vec's (phase 10's
    batch, SGD and AdaGrad) on whatever tables the runtime makes:
    {name: (start, end, losses)} with ``get()`` snapshots (collective
    under several processes)."""
    from multiverso_tpu_torch.apps import (LogisticRegression, SkipGram,
                                           synthetic_classification)

    x, y = synthetic_classification(LR_BATCH, LR_FEATURES, LR_CLASSES,
                                    seed=0)
    out = {}
    lr = LogisticRegression(LR_FEATURES, LR_CLASSES, learning_rate=0.1,
                            name=f"lr_{tag}")
    start = {"w": lr.table.get()}
    step, place = lr.make_fused_step()
    losses, _ = run_fused(torch, [lr.table], step,
                          [(place(x), place(y))] * LR_STEPS)
    out["lr"] = (start, {"w": lr.table.get()}, losses)
    lr.table.close()
    rng = np.random.RandomState(0)
    V, B, K = W2V_VOCAB, W2V_BATCH, W2V_NEG
    batch = (rng.randint(V, size=B).astype(np.int32),
             rng.randint(V, size=B).astype(np.int32),
             rng.randint(V, size=(B, K)).astype(np.int32))
    for upd in ("sgd", "adagrad"):
        sg = w2v_model(SkipGram, V, W2V_DIM, B, upd, f"w2v_{upd}_{tag}")

        def take():
            return {"in": sg.table_in.get(), "out": sg.table_out.get()}

        start = take()
        steps = W2V_STEPS if upd == "sgd" else W2V_ADAGRAD_STEPS
        losses, _ = w2v_fused(torch, sg, [batch] * steps)
        out[f"w2v_{upd}"] = (start, take(), losses)
        sg.table_in.close()
        sg.table_out.close()
    return out


def shard_rank(argv) -> int:
    """One rank of the shard phase (``chip_smoke.py --shard-rank <rank>
    <world> <backend> <store> <out dir>``): joins the group, runs the
    checks and writes ``rank<r>.json`` (rank 0 also ``apps.npz``)."""
    import datetime

    rank, world = int(argv[0]), int(argv[1])
    backend, store, out_dir = argv[2], argv[3], argv[4]
    sys.path.insert(0, HERE)
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = shard_device(backend, rank)
    torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method="file://" + store, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
    import multiverso_tpu_torch as mv

    mv.ops.reset_launch_counts()
    mv.init(device=device)
    res = {"rank": rank, "world": world, "backend": backend,
           "device": device}
    res["arrays"] = shard_array_checks(torch, mv, rank, world, device)
    res["w2v_table"] = shard_rows_check(torch, mv, rank, world, device,
                                        W2V_VOCAB, W2V_DIM, "sgd", "rows_w2v")
    res["big_table"] = shard_rows_check(torch, mv, rank, world, device,
                                        SHARD_BIG_ROWS, W2V_DIM, "adagrad",
                                        "rows_big")
    res["fault"] = shard_rows_check(torch, mv, rank, world, device,
                                    W2V_VOCAB, W2V_DIM, "sgd", "rows_fault",
                                    fault=True)
    t = mv.ArrayTable(8, name="refuse")
    try:
        t.get(device=True)
        res["device_get_refused"] = False
    except RuntimeError:
        res["device_get_refused"] = True
    t.close()
    s0 = time.perf_counter()
    apps = shard_app_runs(torch, mv, "shard")
    res["apps_s"] = time.perf_counter() - s0
    res["apps_losses"] = {k: v[2] for k, v in apps.items()}
    if rank == 0:
        np.savez(os.path.join(out_dir, "apps.npz"), **{
            f"{k}.{side}.{a}": arr for k, (start, end, _) in apps.items()
            for side, snap in (("start", start), ("end", end))
            for a, arr in snap.items()})
    res["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    res["launch_counts"] = mv.ops.launch_counts()
    mv.shutdown()
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def launch_shard_ranks(torch, out_dir):
    """Run the ranks under SHARD_TIMEOUT_S (all killed on expiry);
    returns (backend, world, [each rank's json], seconds)."""
    backend, world = shard_layout(torch.cuda.device_count())
    store = os.path.join(out_dir, "store")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--shard-rank", str(r),
         str(world), backend, store, out_dir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SHARD_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise AssertionError(f"shard ranks did not finish within "
                             f"{SHARD_TIMEOUT_S} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"shard rank {r} failed:\n{log[-4000:]}")
    ranks = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return backend, world, ranks, time.perf_counter() - t0


def judge_shard_apps(sharded, one):
    """({run.side.array: rel_change}, all within W2V_RTOL, losses within
    LR_RTOL): the sharded runs' tables against one process's, each held
    by the change the one-process run made."""
    errs, loss_rel = {}, {}
    for k, (start, end, losses) in one.items():
        for side in ("w", "in", "out"):
            if side in end:
                errs[f"{k}.{side}"] = rel_change(
                    sharded.get(f"{k}.end.{side}"), end[side], start[side])
        got = np.asarray(sharded.get(f"{k}.losses", []), np.float64)
        want = np.asarray(losses, np.float64)
        loss_rel[k] = (float(np.max(np.abs(got - want) / np.abs(want)))
                       if got.shape == want.shape and want.size else math.inf)
    ok = (bool(errs) and all(e <= W2V_RTOL for e in errs.values())
          and all(r <= LR_RTOL for r in loss_rel.values()))
    return {"change_rel_errors": errs, "loss_rel_errors": loss_rel}, ok


def judge_shard_ranks(ranks):
    """({check: verdict}, every rank passed every check, and the planted
    fault failed on some rank)."""
    verdicts = {}
    for res in ranks:
        r = res["rank"]
        for name, a in res["arrays"].items():
            verdicts[f"r{r}.{name}"] = a["ok"]
        for name in ("w2v_table", "big_table"):
            verdicts[f"r{r}.{name}"] = res[name]["ok"]
        verdicts[f"r{r}.device_get_refused"] = res["device_get_refused"]
    fault_rejected = any(not res["fault"]["ok"] for res in ranks)
    return verdicts, (bool(verdicts) and all(verdicts.values())
                      and fault_rejected), fault_rejected


def phase_shard(torch, mv, card):
    """Tables sharded across ranks (see the module docstring): the
    ranks' checks, then LR's and word2vec's steps in one process on the
    card against the ranks'."""
    import tempfile

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="mvt_shard_") as out_dir:
        backend, world, ranks, ranks_s = launch_shard_ranks(torch, out_dir)
        with np.load(os.path.join(out_dir, "apps.npz")) as z:
            sharded = {k: z[k] for k in z.files}
    for k, losses in ranks[0]["apps_losses"].items():
        sharded[f"{k}.losses"] = losses
    mv.ops.reset_launch_counts()
    mv.init(device=None)
    one = shard_app_runs(torch, mv, "one")
    mv.shutdown()
    apps, apps_ok = judge_shard_apps(sharded, one)
    verdicts, ranks_ok, fault_rejected = judge_shard_ranks(ranks)
    ok = ranks_ok and apps_ok
    emit({"phase": "shard", "ok": ok, "backend": backend, "world": world,
          "ranks_s": ranks_s, "verdicts": verdicts,
          "fault_rejected": fault_rejected, "apps": apps,
          "tol": SHARD_TOL, "apps_tol": W2V_RTOL, "ranks": ranks,
          "launch_counts": mv.ops.launch_counts(), "card": card})
    if not ok:
        raise AssertionError(
            f"shard phase failed: checks {verdicts}, planted fault "
            f"rejected {fault_rejected}, apps {apps}")


def device_kernel_times(prof, torch):
    """[(device µs, calls, name)] of every CUDA kernel a profile saw."""
    out = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        out.append((float(getattr(evt, "self_device_time_total", 0.0)),
                    evt.count, evt.key))
    return out


def profile_calls(torch, fn, calls, top=10):
    """``fn()`` called ``calls`` times under torch.profiler, ending in a
    synchronize: the wall and device busy time, the device's busy share,
    the kernels launched per call and the ``top`` kernels by time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - s0) * 1e6
    kernels = sorted(device_kernel_times(prof, torch), reverse=True)
    busy_us = sum(us for us, _, _ in kernels)
    return {"steps": calls, "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / wall_us,
            "kernels_per_step": sum(n for _, n, _ in kernels) / calls,
            "top_kernels": [{"ms": us / 1e3, "calls": n, "name": nm[:90]}
                            for us, n, nm in kernels[:top]]}


def profile_step(tr, tokens, torch, card):
    """One more trainer step under torch.profiler: device time by kernel
    class and the device's busy share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        s0 = time.perf_counter()
        loss = tr.train_step_async(tokens)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - s0) * 1e6
    if not math.isfinite(float(loss)):
        raise AssertionError(f"profiled step loss {float(loss)}")
    by_class = {"flash_kernels": 0.0, "matmul": 0.0, "other": 0.0}
    top = []
    for us, count, name in device_kernel_times(prof, torch):
        low = name.lower()
        if "flash_" in low:
            cls = "flash_kernels"
        elif any(t in low for t in ("gemm", "cutlass", "xmma", "nvjet")):
            cls = "matmul"
        else:
            cls = "other"
        by_class[cls] += us
        top.append((us, count, cls, name[:90]))
    busy = sum(by_class.values())
    top.sort(reverse=True)
    emit({"phase": "profile", "step_wall_ms": wall_us / 1e3,
          "device_busy_ms": busy / 1e3,
          "device_busy_share": busy / wall_us if wall_us else None,
          "ms_by_class": {k: v / 1e3 for k, v in by_class.items()},
          "top_kernels": [{"ms": us / 1e3, "calls": n, "class": c,
                           "name": nm} for us, n, c, nm in top[:15]],
          "card": card})


def phase_check(torch):
    """A small trainer on the card vs the same trainer on the CPU."""
    from multiverso_tpu_torch.models import (TransformerConfig,
                                             TransformerTrainer)

    cfg = TransformerConfig(vocab_size=16384, dim=256, n_layers=2,
                            n_heads=2, hidden=512, max_seq=256,
                            compute_dtype=torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256),
                           generator=torch.Generator().manual_seed(2))
    traj = {}
    for dev in ("cuda", "cpu"):
        tr = TransformerTrainer(cfg, device=dev, updater_type="momentum",
                                seed=3)
        traj[dev] = [float(tr.train_step_async(tokens)) for _ in range(3)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(traj["cuda"],
                                                   traj["cpu"]))
    ok = rel <= 2e-2 and all(math.isfinite(x) for x in traj["cuda"])
    emit({"phase": "check", "ok": ok, "losses_cuda": traj["cuda"],
          "losses_cpu": traj["cpu"], "max_rel_diff": rel, "tol": 2e-2})
    if not ok:
        raise AssertionError("card and CPU trainers disagree")


def flash_work(bh, t, d, tk=None, causal=True, elem=2):
    """{kernel: (flops, bytes)} of attention of [bh, t, d] queries over
    [bh, tk, d] keys (tk = t by default) in a type of ``elem`` bytes (bf16
    by default): 2 flops per multiply-add over the (q, k) pairs the causal
    mask keeps (all of them without it), each input read once and each
    output written once (q, o, do and dq have t rows; k, v, dk and dv tk;
    lse and delta are float32)."""
    tk = tk or t
    pairs = t * (t + 1) // 2 if causal else t * tk
    e, f4 = elem, 4
    return {
        "flash_fwd": (2 * 2 * d * pairs * bh,
                      (2 * t + 2 * tk) * bh * d * e + bh * t * f4),
        "flash_dq": (3 * 2 * d * pairs * bh,
                     (3 * t + 2 * tk) * bh * d * e + 2 * bh * t * f4),
        "flash_dkv": (4 * 2 * d * pairs * bh,
                      (2 * t + 4 * tk) * bh * d * e + 2 * bh * t * f4),
    }


def phase_timing(fa, torch, card):
    """Each kernel alone at the trainer's attention shape."""
    out = kernel_times(fa, torch, BATCH, HEADS, SEQ, HEAD_DIM)
    emit({"phase": "timing", "shape": [BATCH, HEADS, SEQ, HEAD_DIM],
          "dtype": "bfloat16", "causal": True, "kernels": out, "card": card})
    return out


def library_bwd(torch, q4, k4, v4, do4, causal, scale):
    """One PyTorch call that returns dq, dk and dv from a forward's saved
    output and lse: the flash backward for bf16, the memory-efficient
    one for float32 (which the flash kernels do not take)."""
    aten = torch.ops.aten
    if q4.dtype == torch.float32:
        o4, lse4, seed, offset = aten._scaled_dot_product_efficient_attention(
            q4, k4, v4, None, True, 0.0, causal, scale=scale)
        return lambda: aten._scaled_dot_product_efficient_attention_backward(
            do4, q4, k4, v4, None, o4, lse4, seed, offset, 0.0,
            [True, True, True, False], causal, scale=scale)
    o4, lse4, cq, ck, mq, mk, seed, offset, _ = (
        aten._scaled_dot_product_flash_attention(q4, k4, v4, 0.0, causal,
                                                 False, scale=scale))
    return lambda: aten._scaled_dot_product_flash_attention_backward(
        do4, q4, k4, v4, o4, lse4, cq, ck, mq, mk, 0.0, causal, seed,
        offset, scale=scale)


# The flops a second a kernel's bound is taken at: the tensor cores' bf16
# rate for bf16, a sixth of it for float32 (the plane design, six bf16
# products a product, which runs every float32 kernel), and the card's
# FP32 rate for an older tree's float32 kernel outside the plane design
# (``--kernel-times --root``: the first port's forward at D 32).
RATES = {"bf16": PEAK_BF16_FLOPS, "bf16x6": PEAK_BF16_FLOPS / 6,
         "fp32": PEAK_FP32_FLOPS}


def split_share(split, call_ms, timer=None):
    """The float32 plane design's split inside a call: ``split`` runs the
    call's split alone (``fa.plane_split`` on the call's operands and
    scratch: three ``flash_split3`` launches a forward call, four a dq or
    dk/dv call, two at D 256), timed with CUDA events (``timer``,
    ``cuda_ms`` unless given) as the call was, and its share of the call's
    ``call_ms``."""
    split_ms = (timer or cuda_ms)(split)
    return {"split_ms": split_ms, "split_share": split_ms / call_ms}


def bound_rate(fa, name, dtype, d) -> str:
    """Which of RATES bounds kernel ``name`` at ``dtype`` and head dim
    ``d``: bf16, or for float32 the design the launch at its padded head
    dim runs, as the package's table of plane designs
    (``fa._F32_PLANE_DIMS``) says: every head dim in this tree, D 32's
    forward excepted in trees before it."""
    if dtype != fa.torch.float32:
        return "bf16"
    planes = fa._F32_PLANE_DIMS[name]
    return "bf16x6" if fa._kernel_dim(d) in planes else "fp32"


def kernel_times(fa, torch, B, H, T, D, plain_bh=None, tk=None,
                 causal=True, dtype=None):
    """Each kernel alone on operands prepared as the trainer's attention
    call prepares them ([B, H, T, D] queries over [B, H, tk, D] keys, bf16
    unless ``dtype`` says otherwise, causal or not), beside its plain
    version (on the first ``plain_bh`` heads where given: the plain
    versions hold [bh, T, tk] float32 scores), its bound, the exp unit's
    bound (one exp a kept score) and the library call that computes the
    same function.  A float32 kernel's bound is taken at the plane
    design's rate (``bound_rate``), as six times its flops at the bf16
    rate, with the split's time and share beside it (``split_share``);
    the FP32 and TF32 bounds stand beside it."""
    import torch.nn.functional as F

    dtype = dtype or torch.bfloat16
    bh, tk = B * H, tk or T
    x = attn_inputs(bh, T, D, dtype, seed=7, tk=tk)
    q, k, v, do = x["q"], x["k"], x["v"], x["do"]
    scale = D ** -0.5
    qs, kc, vc = fa._prepare(q, k, v, scale)
    o, lse = fa._fwd(qs, kc, vc, causal)
    rows = fa._rows(do, lse, (do.float() * o.float()).sum(-1), q.dtype)
    work = flash_work(bh, T, D, tk, causal, elem=q.element_size())
    pb = plain_bh or bh
    pq, pk, pv = qs[:pb], kc[:pb], vc[:pb]
    prows = [r[:pb] for r in rows]
    calls = {
        "flash_fwd": (lambda: fa._fwd(qs, kc, vc, causal),
                      lambda: fa._fwd_plain(pq, pk, pv, causal)),
        "flash_dq": (lambda: fa._dq(qs, kc, vc, *rows, scale, causal),
                     lambda: fa._dq_plain(pq, pk, pv, *prows, scale,
                                          causal)),
        "flash_dkv": (lambda: fa._dkv(qs, kc, vc, *rows, causal),
                      lambda: fa._dkv_plain(pq, pk, pv, *prows, causal)),
    }
    # The float32 launches' split alone, on the same operands (a tree
    # before ``plane_split`` times none).
    splits = {name: (lambda name=name: fa.plane_split(
        name, qs, kc, vc, None if name == "flash_fwd" else rows[0]))
        for name in calls if hasattr(fa, "plane_split")}
    # The library: scaled_dot_product_attention for the forward, and one
    # backward call returning dq, dk and dv for the dq + dkv pair.
    q4, do4 = (t.view(B, H, T, D) for t in (q, do))
    k4, v4 = (t.view(B, H, tk, D) for t in (k, v))
    lib_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=causal, scale=scale))
    lib_bwd_ms = cuda_ms(library_bwd(torch, q4, k4, v4, do4, causal, scale))
    pairs = T * (T + 1) // 2 if causal else T * tk
    exp_ms = pairs * bh / PEAK_EX2_PER_S * 1e3
    out = {}
    for name, (kern, plain) in calls.items():
        flops, nbytes = work[name]
        rate = bound_rate(fa, name, dtype, D)
        t_ops = flops / RATES[rate] * 1e3
        t_mem = nbytes / PEAK_HBM_BYTES * 1e3
        ms = cuda_ms(kern)
        out[name] = {
            "ms": ms, "plain_ms": cuda_ms(plain, iters=3),
            "bound_ms": max(t_ops, t_mem),
            "bound_by": "operations" if t_ops >= t_mem else "bytes",
            "bound_share": max(t_ops, t_mem) / ms,
            "exp_bound_ms": exp_ms, "exp_bound_share": exp_ms / ms,
            "tflops": flops / (ms * 1e-3) / 1e12,
            "flops": flops, "bytes": nbytes,
            "library_ms": lib_fwd_ms if name == "flash_fwd" else lib_bwd_ms,
            "bound_rate": rate,
        }
        if rate == "bf16x6" and name in splits:
            out[name].update(split_share(splits[name], ms))
        if dtype == torch.float32:
            out[name]["bound_ms_fp32"] = max(
                flops / PEAK_FP32_FLOPS * 1e3, t_mem)
            out[name]["bound_ms_tf32"] = max(
                flops / PEAK_TF32_FLOPS * 1e3, t_mem)
        if pb != bh:
            out[name]["plain_bh"] = pb
        if name != "flash_fwd":
            out[name]["library_covers"] = "flash_dq+flash_dkv"
    return out


def rel_to_peak(got, want) -> float:
    """max |got - want| over max |want|; inf for a wrong shape or a
    non-finite value."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        return math.inf
    if got.size == 0:
        return 0.0
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def judge_tables(checks, tol=TABLE_TOL):
    """({name: error relative to the largest entry}, all within tol) for
    ``checks`` = {name: (got, want)}."""
    errs = {name: rel_to_peak(got, want)
            for name, (got, want) in checks.items()}
    return errs, bool(errs) and all(e <= tol for e in errs.values())


def judge_lr(card, cpu, pushpull_w, fused_w):
    """The lr phase's verdict: the card's fused-step losses against the
    CPU's within LR_RTOL, falling, and one push-pull step's table against
    one fused step's within LR_RTOL / LR_ATOL."""
    card = np.asarray(card, np.float64)
    cpu = np.asarray(cpu, np.float64)
    same_len = card.shape == cpu.shape and card.size > 1
    traj_rel = (float(np.max(np.abs(card - cpu) / np.abs(cpu)))
                if same_len else math.inf)
    finite = bool(np.isfinite(card).all())
    falls = same_len and finite and bool(card[-1] < card[0])
    pushpull_w = np.asarray(pushpull_w, np.float64)
    fused_w = np.asarray(fused_w, np.float64)
    step_ok = (pushpull_w.shape == fused_w.shape
               and bool(np.isfinite(pushpull_w).all())
               and bool(np.allclose(pushpull_w, fused_w, rtol=LR_RTOL,
                                    atol=LR_ATOL)))
    out = {"trajectory_max_rel_diff": traj_rel, "loss_falls": falls,
           "step_max_abs_diff": (float(np.abs(pushpull_w - fused_w).max())
                                 if pushpull_w.shape == fused_w.shape
                                 else math.inf),
           "step_within_tol": step_ok}
    ok = same_len and finite and traj_rel <= LR_RTOL and falls and step_ok
    return out, ok


def phase_tables(torch, mv, card):
    """ArrayTables of TABLE_SIZE float32 on the card against numpy on the
    host, then the add/get rates and the peak device memory."""
    from multiverso_tpu_torch.util.quantization import (dequantize_1bit,
                                                        quantize_1bit)

    n = TABLE_SIZE
    rng = np.random.RandomState(11)
    w0, g1, g2 = (rng.randn(n).astype(np.float32) for _ in range(3))
    lr, eps = np.float32(0.1), np.float32(1e-8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mv.ops.reset_launch_counts()
    ctx = mv.init(device=None)
    if ctx.device != torch.device(CARD):
        raise AssertionError(f"init() placed the tables on {ctx.device}")
    opt = mv.AddOption(learning_rate=float(lr))
    checks = {}

    t = mv.ArrayTable(n, name="sgd", updater_type="sgd", init=w0)
    t.add(g1, option=opt)
    t.add(g2, option=opt)
    checks["host_sgd"] = (t.get(), (w0 - lr * g1) - lr * g2)
    t.close()

    t = mv.ArrayTable(n, name="adagrad", updater_type="adagrad", init=w0)
    t.add(g1, option=opt)
    t.add(g2, option=opt)
    h = g1 * g1
    w = w0 - lr * g1 / (np.sqrt(h) + eps)
    h = h + g2 * g2
    checks["host_adagrad"] = (t.get(), w - lr * g2 / (np.sqrt(h) + eps))
    t.close()

    t = mv.ArrayTable(n, name="device", init=w0)
    d = torch.from_numpy(g1).to(CARD)
    t.add(d)
    dev = t.get(device=True)
    if dev.device != torch.device(CARD):
        raise AssertionError(f"get(device=True) returned {dev.device}")
    checks["device_add_get"] = (dev.cpu().numpy(), w0 + g1)
    del dev

    tb = mv.ArrayTable(n, name="bsp", sync=True, init=w0)
    tb.add(g1)
    tb.add(g2)
    checks["bsp_before_barrier"] = (tb.get(), w0)
    mv.barrier()
    checks["bsp_after_barrier"] = (tb.get(), w0 + (g1 + g2))
    tb.close()

    tq = mv.ArrayTable(n, name="one_bit", init=w0)
    tq.add(g1, compress="1bit")
    packed, p, m, _ = quantize_1bit(g1)
    checks["one_bit"] = (tq.get(), w0 + dequantize_1bit(packed, p, m, n))
    tq.close()
    errs, ok = judge_tables(checks)

    # Rates on the "device" table (default updater: w + d, one kernel).
    nbytes = n * 4
    add_ms = cuda_ms(lambda: t.add(d), iters=50, warmup=3)
    get_ms = cuda_ms(lambda: t.get(device=True), iters=50, warmup=3)
    moved = {"add": 3 * nbytes, "get": 2 * nbytes}   # w, d in; w' out
    rates = {}
    for op, ms in (("add", add_ms), ("get", get_ms)):
        bound = moved[op] / PEAK_HBM_BYTES * 1e3
        rates.update({f"{op}_dev_gbps": nbytes / (ms * 1e-3) / 1e9,
                      f"{op}_dev_ms": ms,
                      f"{op}_dev_bytes_moved": moved[op],
                      f"{op}_dev_bound_ms": bound,
                      f"{op}_dev_bound_share": bound / ms})

    def host_s(fn, iters=5):
        fn()
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - s0) / iters

    rates["add_host_gbps"] = nbytes / host_s(lambda: t.add(g1, sync=True)) / 1e9
    rates["get_host_gbps"] = nbytes / host_s(t.get) / 1e9
    peak = torch.cuda.max_memory_allocated()
    mv.shutdown()
    emit({"phase": "tables", "ok": ok, "size": n, "dtype": "float32",
          "tol": TABLE_TOL, "rel_errors": errs, **rates,
          "gbps_counts": "table payload bytes (size x 4) per second",
          "peak_bytes": peak, "launch_counts": mv.ops.launch_counts(),
          "card": card})
    if not ok:
        raise AssertionError(f"a table disagrees with numpy: {errs}")


def phase_lr(torch, mv, card):
    """LR at bench.py's shape: the card's fused trajectory against the
    CPU's, one push-pull step against one fused step, and both rates.
    Returns ``lr_fused_samples_per_sec``."""
    from multiverso_tpu_torch.apps import (LogisticRegression,
                                           synthetic_classification)

    x, y = synthetic_classification(LR_BATCH, LR_FEATURES, LR_CLASSES,
                                    seed=0)

    def fused_losses(name):
        lr = LogisticRegression(LR_FEATURES, LR_CLASSES, learning_rate=0.1,
                                name=name)
        step, place = lr.make_fused_step()
        data, state = lr.table.raw_value()
        xb, yb = place(x), place(y)
        losses = []
        for _ in range(LR_STEPS):
            data, state, loss = step(data, state, xb, yb)
            losses.append(loss)
        lr.table.raw_assign(data, state)
        return [float(v) for v in losses]

    mv.ops.reset_launch_counts()
    mv.init(device=None)
    card_losses = fused_losses("lr_fused")
    a = LogisticRegression(LR_FEATURES, LR_CLASSES, learning_rate=0.1,
                           name="lr_a", seed=7)
    b = LogisticRegression(LR_FEATURES, LR_CLASSES, learning_rate=0.1,
                           name="lr_b", seed=7)
    a.train_batch(x, y)
    step, place = b.make_fused_step()
    data, state, _ = step(*b.table.raw_value(), place(x), place(y))
    b.table.raw_assign(data, state)
    pushpull_w, fused_w = a.table.get(), b.table.get()

    bench = LogisticRegression(LR_FEATURES, LR_CLASSES, learning_rate=0.1,
                               name="lr_bench")
    step, place = bench.make_fused_step()
    cur = list(bench.table.raw_value())
    xb, yb = place(x), place(y)

    def fused_once():
        cur[0], cur[1], _ = step(cur[0], cur[1], xb, yb)

    fused_ms = cuda_ms(fused_once, iters=100, warmup=3)
    # Where a fused step's time goes: device busy time over wall time
    # across 20 queued steps, and the kernels that fill it.
    fused_profile = profile_calls(torch, fused_once, 20, top=8)
    bench.table.raw_assign(*cur)
    pp = LogisticRegression(LR_FEATURES, LR_CLASSES, learning_rate=0.1,
                            name="lr_pp")
    for _ in range(2):
        pp.train_batch(x, y)
    torch.cuda.synchronize()
    s0 = time.perf_counter()
    for _ in range(5):
        pp.train_batch(x, y)
    torch.cuda.synchronize()
    pushpull_s = (time.perf_counter() - s0) / 5
    mv.shutdown()
    counts = mv.ops.launch_counts()

    mv.init(device="cpu")
    cpu_losses = fused_losses("lr_fused")
    mv.shutdown()
    verdict, ok = judge_lr(card_losses, cpu_losses, pushpull_w, fused_w)
    emit({"phase": "lr", "ok": ok, "batch": LR_BATCH,
          "features": LR_FEATURES, "classes": LR_CLASSES,
          "steps": LR_STEPS, "losses_cuda": card_losses,
          "losses_cpu": cpu_losses, "rtol": LR_RTOL, "atol": LR_ATOL,
          **verdict, "lr_fused_ms_per_step": fused_ms,
          "lr_fused_samples_per_sec": LR_BATCH / (fused_ms * 1e-3),
          "lr_pushpull_ms_per_step": pushpull_s * 1e3,
          "lr_pushpull_samples_per_sec": LR_BATCH / pushpull_s,
          "fused_profile": fused_profile,
          "launch_counts": counts, "card": card})
    if not ok:
        raise AssertionError(f"lr phase failed: {verdict}")
    return LR_BATCH / (fused_ms * 1e-3)


def _trajectory(card, cpu):
    """(max relative difference of two loss trajectories, both the same
    length with more than one finite entry)."""
    card = np.asarray(card, np.float64)
    cpu = np.asarray(cpu, np.float64)
    ok = (card.shape == cpu.shape and card.size > 1
          and bool(np.isfinite(card).all()) and bool(np.isfinite(cpu).all()))
    rel = (float(np.max(np.abs(card - cpu) / np.abs(cpu))) if ok
           else math.inf)
    return rel, ok


def judge_row_add_memory(allocated, table_bytes):
    """Repair 2's verdict: one ``add_rows`` allocated less than the table
    it adds into (an out-of-place scatter would copy the whole table)."""
    return allocated < table_bytes


def rel_change(got, want, start) -> float:
    """max |got - want| over max |want - start|: a run judged against the
    change the reference run made from the same start.  inf for a wrong
    shape, a non-finite value, or a reference that changed nothing."""
    start = np.asarray(start, np.float64)
    if np.shape(got) != start.shape or np.shape(want) != start.shape:
        return math.inf
    moved = np.asarray(want, np.float64) - start
    if not (moved.size and np.abs(moved).max() > 0):
        return math.inf
    return rel_to_peak(np.asarray(got, np.float64) - start, moved)


def judge_changes(runs, tol=W2V_RTOL):
    """({run.array: rel_change}, all within tol) for ``runs`` = {run:
    (got, want, start)}, each a snapshot {array name: array}; an array
    the got snapshot lacks is an error."""
    errs = {f"{run}.{k}": rel_change(got.get(k), want[k], start.get(k))
            for run, (got, want, start) in runs.items() for k in want}
    return errs, bool(errs) and all(e <= tol for e in errs.values())


def judge_w2v(changes, trajectories, sync_free):
    """The w2v phase's verdict: every table change (card against CPU,
    push-pull against fused, prefetched against placed, DLRM card against
    CPU) within W2V_RTOL of the reference's (``judge_changes``); every
    loss trajectory {name: (card, cpu, must_fall)} within W2V_RTOL of the
    CPU's, falling where ``must_fall``; every fused step checked free of
    host syncs."""
    errs, changes_ok = judge_changes(changes)
    traj, traj_ok = {}, bool(trajectories)
    for name, (card, cpu, must_fall) in trajectories.items():
        rel, same = _trajectory(card, cpu)
        falls = same and card[-1] < card[0]
        traj[name] = {"max_rel_diff": rel, "falls": falls}
        traj_ok = (traj_ok and same and rel <= W2V_RTOL
                   and (falls or not must_fall))
    out = {"change_rel_errors": errs, "trajectories": traj,
           "sync_free": dict(sync_free)}
    ok = (changes_ok and traj_ok and bool(sync_free)
          and all(sync_free.values()))
    return out, ok


def _np_row_apply(w, h, ids, g, lr, eps, updater):
    """numpy's row add: duplicates summed, ids past the table dropped,
    then the default updater, sgd or adagrad on the rows (w and h
    updated in place)."""
    uniq, inv = np.unique(ids, return_inverse=True)
    agg = np.zeros((uniq.shape[0], w.shape[1]), np.float32)
    np.add.at(agg, inv.reshape(-1), g)
    live = (uniq >= 0) & (uniq < w.shape[0])
    u, a = uniq[live], agg[live]
    if updater == "default":
        w[u] = w[u] + a
    elif updater == "sgd":
        w[u] = w[u] - lr * a
    else:
        h[u] = h[u] + a * a
        w[u] = w[u] - lr * a / (np.sqrt(h[u]) + eps)


def _np_rows(w, ids):
    """numpy's get_rows: ids past the table read zeros."""
    out = np.zeros((len(ids), w.shape[1]), w.dtype)
    live = (ids >= 0) & (ids < w.shape[0])
    out[live] = w[ids[live]]
    return out


def device_row_applies(torch, device, w0, ids, g, mask, lr):
    """Each updater of ROW_UPDATERS applied to rows straight from tensors
    on ``device``, as the fused steps apply them: ``apply_rows`` on the
    distinct ids with ``mask``, and ``scatter_apply`` on ``ids`` with
    their duplicates (segment-summed on the device for the non-linear
    updaters).  Ids past the table go in both.  Yields (case, [w, *state]
    as numpy)."""
    from multiverso_tpu_torch.updaters import AddOption, get_updater
    from multiverso_tpu_torch.updaters.base import scatter_apply

    opt = AddOption(learning_rate=float(lr))
    uniq = np.unique(ids)

    def put(a):
        return torch.tensor(a, device=device)

    for name in ROW_UPDATERS:
        upd = get_updater(name)
        for how in ("apply_rows", "scatter_apply"):
            w = put(w0)
            state = upd.init_state(w.shape, w.dtype, device)
            if how == "apply_rows":
                w, state = upd.apply_rows(w, state, put(uniq),
                                          put(g[:len(uniq)]), opt,
                                          mask=put(mask))
            else:
                w, state = scatter_apply(upd, w, state, put(ids), put(g),
                                         opt)
            yield (f"{name}_{how}",
                   [w.cpu().numpy()] + [x.cpu().numpy() for x in state])


def row_apply_checks(torch, w0, ids, g, mask, lr, eps, device):
    """{check: (got, want)}: ``device_row_applies`` on ``device`` against
    the same calls on the CPU, and sgd's and adagrad's against numpy."""
    uniq = np.unique(ids)
    want_np = {}
    for upd in ("sgd", "adagrad"):
        for how, r, d in (("apply_rows", uniq[mask], g[:len(uniq)][mask]),
                          ("scatter_apply", ids, g)):
            w, h = w0.copy(), np.zeros_like(w0)
            _np_row_apply(w, h, r, d, lr, eps, upd)
            want_np[f"{upd}_{how}"] = [w, h] if upd == "adagrad" else [w]
    checks = {}
    for (case, got), (_, want) in zip(
            device_row_applies(torch, device, w0, ids, g, mask, lr),
            device_row_applies(torch, "cpu", w0, ids, g, mask, lr)):
        for i, (x, y) in enumerate(zip(got, want)):
            checks[f"{case}_{i}_vs_cpu"] = (x, y)
        for i, y in enumerate(want_np.get(case, [])):
            checks[f"{case}_{i}_vs_numpy"] = (got[i], y)
    return checks


def assign_duplicates_case(rng, n, rows):
    """(ids, values, mask) for ``assign``'s apply: ``n`` entries whose ids
    each repeat 2-4 times in shuffled order, each entry with its own
    values, a tenth masked off, and 31 distinct ids past the table."""
    k = -(-n // 3)                       # 3 entries an id, up to 2 with 2
    counts = np.full(k, 3)
    counts[:3 * k - n] -= 1
    swap = rng.permutation(np.arange(2, k))[:2 * (k // 3)]
    counts[swap[:k // 3]] += 1
    counts[swap[k // 3:]] -= 1
    uniq = np.concatenate([rng.choice(rows, size=k - 31, replace=False),
                           rows + rng.choice(1000, size=31, replace=False)])
    ids = np.repeat(uniq[rng.permutation(k)], counts)
    ids = ids[rng.permutation(n)].astype(np.int64)
    values = rng.randn(n, W2V_DIM).astype(np.float32)
    return ids, values, rng.rand(n) > 0.1


def last_write(w0, ids, values, mask):
    """numpy's assign: entries in order, masked ones and ids past the
    table skipped, the last write to a row kept."""
    w = w0.copy()
    for i, v, m in zip(ids, values, mask):
        if m and 0 <= i < w.shape[0]:
            w[i] = v
    return w


def assign_duplicates(torch, device, w0, ids, values, mask):
    """``assign``'s ``apply_rows`` on ``device`` (numpy out), and the
    number of rows where a plain ``index_put_`` of the kept entries,
    whose order of writes to one row CUDA leaves undefined, ends with
    another value."""
    from multiverso_tpu_torch.updaters import AddOption, get_updater

    def put(a):
        return torch.tensor(a, device=device)

    w, _ = get_updater("assign").apply_rows(put(w0), (), put(ids),
                                            put(values), AddOption(),
                                            mask=put(mask))
    got = w.cpu().numpy()
    kept = mask & (ids < w0.shape[0])
    plain = put(w0).index_put_((put(ids[kept]),), put(values[kept]))
    differ = int((plain.cpu().numpy() != got).any(axis=1).sum())
    return got, differ


def phase_rows(torch, mv, card):
    """MatrixTables of bench_w2v's shape on the card against numpy, the
    sparse and KV tables, a checkpoint round trip, and what one row add
    allocates."""
    import tempfile

    V, D, B = W2V_VOCAB, W2V_DIM, W2V_BATCH
    rng = np.random.RandomState(12)
    w0 = rng.randn(V, D).astype(np.float32)
    ids = np.concatenate([rng.randint(V, size=B - 3), [V, V + 7, 2 * V]])
    g1, g2 = (rng.randn(B, D).astype(np.float32) for _ in range(2))
    lr, eps = np.float32(0.1), np.float32(1e-8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mv.ops.reset_launch_counts()
    ctx = mv.init(device=None)
    if ctx.device != torch.device(CARD):
        raise AssertionError(f"init() placed the tables on {ctx.device}")
    opt = mv.AddOption(learning_rate=float(lr))
    checks = {}

    for upd in ("sgd", "adagrad"):
        t = mv.MatrixTable(V, D, name=upd, updater_type=upd, init=w0)
        w, h = w0.copy(), np.zeros_like(w0)
        for g in (g1, g2):
            t.add_rows(ids, g, option=opt)
            _np_row_apply(w, h, ids, g, lr, eps, upd)
        checks[f"rows_{upd}_get_rows"] = (t.get_rows(ids), _np_rows(w, ids))
        checks[f"rows_{upd}_table"] = (t.get(), w.copy())

    # Repair 2: one add of 8,192 rows (on the adagrad table: w and h)
    # allocates what the rows need, not a copy of the table.
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t.add_rows(ids, g1, option=opt, sync=True)
    row_add_alloc = torch.cuda.max_memory_allocated() - base
    table_bytes = V * D * 4
    _np_row_apply(w, h, ids, g1, lr, eps, "adagrad")
    checks["rows_adagrad_after_measured_add"] = (t.get(), w)

    # Repair 1 on the card: the drop masks and the segment-sum that the
    # fused steps run on the device, for every updater.
    mask = rng.rand(len(np.unique(ids))) < 0.75
    checks.update(row_apply_checks(torch, w0, ids, g1, mask, lr, eps, CARD))

    # assign with duplicate ids: the last kept entry wins on the card as
    # on the CPU, exactly.
    a_ids, a_vals, a_mask = assign_duplicates_case(rng, B, V)
    a_card, plain_differ = assign_duplicates(torch, CARD, w0, a_ids, a_vals,
                                             a_mask)
    a_cpu, _ = assign_duplicates(torch, "cpu", w0, a_ids, a_vals, a_mask)
    assign_exact = bool(np.array_equal(a_card, a_cpu) and np.array_equal(
        a_card, last_write(w0, a_ids, a_vals, a_mask)))

    td = mv.MatrixTable(V, D, name="device", init=w0)
    gd = rng.randn(V, D).astype(np.float32)
    td.add(torch.from_numpy(gd).to(CARD))
    dev = td.get(device=True)
    if dev.device != torch.device(CARD):
        raise AssertionError(f"get(device=True) returned {dev.device}")
    checks["whole_add_get_device"] = (dev.cpu().numpy(), w0 + gd)
    del dev
    td.close()

    tb = mv.MatrixTable(V, D, name="bsp", sync=True, init=w0)
    tb.add_rows(ids, g1)
    tb.add_rows(ids[::-1], g2)
    checks["bsp_before_barrier"] = (tb.get_rows(ids), _np_rows(w0, ids))
    mv.barrier()
    wb = w0.copy()
    _np_row_apply(wb, None, np.concatenate([ids, ids[::-1]]),
                  np.concatenate([g1, g2]), lr, eps, "default")
    checks["bsp_after_barrier"] = (tb.get(), wb)
    tb.close()

    ts = mv.SparseMatrixTable(V, D, name="sparse", updater_type="sgd",
                              init=w0)
    hot = ids[:64]
    first = ts.get_rows(hot)
    cached = bool(ts._cache_valid[hot].all())
    ts.add_rows(hot[:16], g1[:16], option=opt)
    ws = w0.copy()
    _np_row_apply(ws, None, hot[:16], g1[:16], lr, eps, "sgd")
    checks["sparse_cached_rows"] = (first, w0[hot])
    checks["sparse_rows_after_add"] = (ts.get_rows(hot), ws[hot])

    tk = mv.KVTable(value_shape=(D,), name="kv", updater_type="sgd")
    keys = [int(k) for k in ids[:8]] + ["bias"]
    want_kv = {}
    for g in (g1, g2):
        ups = {k: g[i] for i, k in enumerate(keys)}
        tk.add(ups, option=opt)
        for k, v in ups.items():
            want_kv[k] = want_kv.get(k, np.zeros(D, np.float32)) - lr * v
    got_kv = tk.get(keys)
    checks["kv_add_get"] = (np.stack([got_kv[k] for k in keys]),
                            np.stack([want_kv[k] for k in keys]))
    errs, ok = judge_tables(checks)

    # Checkpoint: every live table into a file, then into fresh tables of
    # a second lifecycle; the snapshots must come back bit for bit.
    live = {tt.name: tt for tt in ctx.tables()}
    snaps = {name: tt.store_state() for name, tt in live.items()}
    specs = {name: (type(tt).__name__, tt.updater_type)
             for name, tt in live.items()}
    peak = torch.cuda.max_memory_allocated()
    with tempfile.TemporaryDirectory() as tmp:
        uri = os.path.join(tmp, "rows.ckpt")
        s0 = time.perf_counter()
        mv.checkpoint.save(uri, extra={"phase": "rows"})
        save_s = time.perf_counter() - s0
        mv.shutdown()
        mv.init(device=None)
        fresh = {}
        for name, (kind, upd) in specs.items():
            if kind == "KVTable":
                fresh[name] = mv.KVTable(value_shape=(D,), name=name,
                                         updater_type=upd)
            else:
                fresh[name] = getattr(mv, kind)(V, D, name=name,
                                                updater_type=upd)
        s0 = time.perf_counter()
        extra = mv.checkpoint.restore(uri)
        restore_s = time.perf_counter() - s0
    exact = extra == {"phase": "rows"} and all(
        _same_snapshot(fresh[name].store_state(), snap)
        for name, snap in snaps.items())
    mv.shutdown()
    mem_ok = judge_row_add_memory(row_add_alloc, table_bytes)
    ok = ok and assign_exact
    emit({"phase": "rows", "ok": ok and exact and cached and mem_ok,
          "shape": [V, D], "ids": len(ids), "tol": TABLE_TOL,
          "rel_errors": errs, "sparse_rows_cached": cached,
          "assign_duplicates": {"ids": len(a_ids),
                                "exact_vs_cpu_and_numpy": assign_exact,
                                "plain_index_put_rows_differing":
                                    plain_differ},
          "checkpoint_exact": exact, "checkpoint_tables": sorted(snaps),
          "checkpoint_save_s": save_s, "checkpoint_restore_s": restore_s,
          "row_add_allocated_bytes": row_add_alloc,
          "table_bytes": table_bytes, "row_add_below_table": mem_ok,
          "peak_bytes": peak, "launch_counts": mv.ops.launch_counts(),
          "card": card})
    if not (ok and exact and cached and mem_ok):
        raise AssertionError(
            f"rows phase failed: errors {errs}, cached {cached}, checkpoint "
            f"exact {exact}, row add allocated {row_add_alloc} bytes, "
            f"assign duplicates exact {assign_exact}")


def _same_snapshot(got, want) -> bool:
    """Two table snapshots hold the same keys and bit-equal arrays."""
    if isinstance(want, dict):
        return (isinstance(got, dict) and set(got) == set(want)
                and all(_same_snapshot(got[k], want[k]) for k in want))
    if isinstance(want, (list, tuple)):
        return (len(got) == len(want)
                and all(_same_snapshot(g, w) for g, w in zip(got, want)))
    if isinstance(want, np.ndarray):
        return np.array_equal(got, want)
    return got == want


def w2v_check_lr(updater, batch):
    """The checks' step size: word2vec's own 0.025 per pair, so sgd on
    the batch-mean loss takes lr x batch; adagrad's step sizes are per
    coordinate and stay at lr.  At bench_w2v's lr a step moves a table by
    about 1e-8, below float32's rounding of its entries, so no check could
    see a wrong step there."""
    return W2V_LR * batch if updater == "sgd" else W2V_LR


def w2v_model(SkipGram, vocab, dim, batch, updater, name):
    """A SkipGram for the checks: ``w2v_check_lr`` (and adagrad's eps at
    W2V_ADAGRAD_EPS), and the output table drawn like the input table
    (seed 1) where SkipGram starts it at zero, so that a step moves both
    tables from the first."""
    import torch

    from multiverso_tpu_torch.updaters import AddOption

    sg = SkipGram(vocab, dim, negatives=W2V_NEG,
                  learning_rate=w2v_check_lr(updater, batch),
                  updater_type=updater, name=name)
    if updater == "adagrad":
        sg.option = AddOption(learning_rate=sg.option.learning_rate,
                              eps=W2V_ADAGRAD_EPS)
    rng = np.random.RandomState(1)
    out = ((rng.rand(vocab, dim) - 0.5) / dim).astype(np.float32)
    data, state = sg.table_out.raw_value()
    sg.table_out.raw_assign(sg.table_out.local_part(
        torch.from_numpy(out).to(data.device)), state)
    return sg


def tables_snapshot(tables):
    """Tables and their updater state, {name: numpy copy} for ``tables``
    = {name: table}; state slot i of table t is "t_state{i}"."""
    snap = {}
    for side, t in tables.items():
        data, state = t.raw_value()
        snap[side] = data.cpu().numpy().copy()
        for i, x in enumerate(state):
            snap[f"{side}_state{i}"] = x.cpu().numpy().copy()
    return snap


def w2v_snapshot(sg):
    """A SkipGram's tables and updater state, {name: numpy copy}."""
    return tables_snapshot({"in": sg.table_in, "out": sg.table_out})


def without_sync(torch, fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("error")``: (its
    result, True), or (None, False) when an op in it made the host wait
    for the device; the frames that led to that op go to stderr."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(), True
    except RuntimeError as exc:
        if "called a synchronizing CUDA operation" not in str(exc):
            raise
        print("chip_smoke: the host waited for the device:\n"
              + traceback.format_exc(limit=-6), file=sys.stderr)
        return None, False
    finally:
        torch.cuda.set_sync_debug_mode(0)


def run_fused(torch, tables, step, placed, sync_check=False):
    """An app's fused ``step`` over batches already on the device, from
    ``tables``' tensors, which get the results back.  Returns the step
    losses and, with ``sync_check``, whether the steps ran under
    ``without_sync`` without a host sync (else None)."""
    cur = [x for t in tables for x in t.raw_value()]
    losses = []

    def steps():
        nonlocal cur
        for b in placed:
            *cur, loss = step(*cur, *b)
            losses.append(loss)

    sync_free = None
    if sync_check:
        _, sync_free = without_sync(torch, steps)
    else:
        steps()
    for i, t in enumerate(tables):
        t.raw_assign(cur[2 * i], cur[2 * i + 1])
    return [float(x) for x in losses], sync_free


def w2v_fused(torch, sg, batches, sync_check=False):
    """The fused step over host batches (c, o, neg), all placed first; the
    tables are handed back after.  Returns the step losses and, with
    ``sync_check``, whether the steps ran under
    ``torch.cuda.set_sync_debug_mode("error")`` without raising (else
    None)."""
    step, place = sg.make_fused_step()
    placed = [tuple(place(a) for a in b) for b in batches]
    return run_fused(torch, [sg.table_in, sg.table_out], step, placed,
                     sync_check)


def sgns_inputs(torch, b, d, k, seed):
    """Centre rows [b, d] and output rows [b·(1 + k), d] on the card,
    normal with scores of about N(0, 4), so that the sigmoids span their
    range."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    scale = 2.0 / math.sqrt(d)
    vc = torch.randn(b, d, generator=g, device="cuda") * scale
    out = torch.randn(b * (1 + k), d, generator=g, device="cuda") * scale
    return vc, out


def sgns_close(got, want, rtol=SGNS_RTOL, atol_share=SGNS_ATOL_SHARE):
    """(max |got - want| over max |want|, within rtol and atol_share of
    the largest entry everywhere)."""
    got, want = got.double(), want.double()
    peak = float(want.abs().max())
    diff = (got - want).abs()
    ok = bool((diff <= rtol * want.abs() + atol_share * peak).all()
              and got.isfinite().all())
    return float(diff.max()) / peak if peak else float(diff.max()), ok


def sgns_case(torch, sgns, b, d, k, seed):
    """The kernel's loss, dvc and dout against the plain version's on one
    set of card rows: {name: error share} and whether all are within
    SGNS_RTOL."""
    vc, out = sgns_inputs(torch, b, d, k, seed)
    got = sgns.sgns_grads(vc, out, k)
    want = sgns.sgns_plain(vc, out, k)
    torch.cuda.synchronize()
    errs, ok = {}, True
    for name, g, w in zip(("loss", "dvc", "dout"), got, want):
        errs[name], good = sgns_close(g, w)
        ok = ok and good
    return {"shape": [b, d, k], "errors": errs, "ok": ok}


def sgns_bytes(b, d, k) -> int:
    """The least bytes of one SGNS call: every gathered row (b centres,
    b·(1 + k) output rows) read once and its gradient written once."""
    return 2 * b * (2 + k) * d * 4


def sgns_times(torch, sgns, b, d, k):
    """The kernel alone at [b, d, k] beside its bytes bound, the plain
    version on the card, and the yardstick: autograd's chain over
    ``_sgns_loss`` with the cat that joined its context and negative
    gradients for the scatter (the fused step before the kernel)."""
    from multiverso_tpu_torch.apps.word2vec import _sgns_value_and_grad

    vc, out = sgns_inputs(torch, b, d, k, seed=11)
    uo, un = out[:b], out[b:].view(b, k, d)

    def autograd_cat():
        _, (dvc, duo, dun) = _sgns_value_and_grad(vc, uo, un)
        return dvc, torch.cat([duo, dun.reshape(b * k, d)])

    nbytes = sgns_bytes(b, d, k)
    bound_ms = nbytes / PEAK_HBM_BYTES * 1e3
    ms = cuda_ms(lambda: sgns.sgns_grads(vc, out, k), iters=50, warmup=3)
    return {"shape": [b, d, k], "ms": ms, "bytes": nbytes,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "bound_share": bound_ms / ms,
            "gbytes_per_s": nbytes / (ms * 1e-3) / 1e9,
            "plain_ms": cuda_ms(lambda: sgns.sgns_plain(vc, out, k),
                                iters=10),
            "autograd_cat_ms": cuda_ms(autograd_cat, iters=10)}


def phase_w2v(torch, mv, card):
    """word2vec at bench_w2v's shape: card against CPU, push-pull against
    fused, prefetched against placed (each judged by the table changes),
    no host sync in the fused step, both rates and a profile; then DLRM
    card against CPU.  Returns ``w2v_fused_pairs_per_sec``."""
    from multiverso_tpu_torch.apps import DLRMRecommender, SkipGram
    from multiverso_tpu_torch.ops import sgns

    V, D, B, K = W2V_VOCAB, W2V_DIM, W2V_BATCH, W2V_NEG
    rng = np.random.RandomState(0)
    c = rng.randint(V, size=B).astype(np.int32)
    o = rng.randint(V, size=B).astype(np.int32)
    neg = rng.randint(V, size=(B, K)).astype(np.int32)
    corpus = np.random.RandomState(5).randint(V, size=12000).astype(np.int32)
    updaters = ("sgd", "adagrad")

    def model(name, updater="sgd"):
        return w2v_model(SkipGram, V, D, B, updater, name)

    def close(*models):
        for m in models:
            m.table_in.close()
            m.table_out.close()

    def fused_runs():
        """The fused steps on bench_w2v's batch per updater: {upd:
        (start, end, losses, sync_free)}; sync checked on a card only."""
        out = {}
        for upd in updaters:
            sg = model(f"w2v_{upd}", upd)
            start = w2v_snapshot(sg)
            steps = W2V_STEPS if upd == "sgd" else W2V_ADAGRAD_STEPS
            losses, free = w2v_fused(torch, sg, [(c, o, neg)] * steps,
                                     sync_check=sg.device.type == "cuda")
            out[upd] = (start, w2v_snapshot(sg), losses, free)
            close(sg)
        return out

    def dlrm_run():
        # The check's step size is 0.05 per pair (DLRM_LR x batch on the
        # batch-mean loss), so the table moves far above its rounding.
        rec = DLRMRecommender(DLRM_USERS, DLRM_ITEMS, dim=DLRM_DIM,
                              learning_rate=DLRM_LR * DLRM_BATCH)
        start = {"table": rec.table.get()}
        losses = rec.train_epoch(DLRM_STEPS, DLRM_BATCH, seed=0, s=1.0)
        end = {"table": rec.table.get()}
        rec.close()
        return start, end, losses

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mv.ops.reset_launch_counts()
    mv.init(device=None)
    sgns.reset_launch_counts()
    card_runs = fused_runs()
    # One SGNS launch a fused step.
    sgns_launches = sgns.launch_counts()["sgns"]
    sgns_launches_ok = sgns_launches == W2V_STEPS + W2V_ADAGRAD_STEPS
    changes = {}

    # One push-pull step against one fused step from the same start: the
    # host segment-sum and the device one (adagrad) must agree.
    for upd in updaters:
        a, b = model(f"w2v_pp_{upd}", upd), model(f"w2v_fu_{upd}", upd)
        start = w2v_snapshot(a)
        a.train_batch(c, o, neg)
        w2v_fused(torch, b, [(c, o, neg)])
        changes[f"{upd}_pushpull_vs_fused"] = (w2v_snapshot(a),
                                               w2v_snapshot(b), start)
        close(a, b)

    # train_epoch_fused (prefetch: pinned staging, a side stream) against
    # the same batches placed one by one.
    pe, pm = model("w2v_prefetch"), model("w2v_placed")
    start = w2v_snapshot(pe)
    pe_steps, pe_loss = pe.train_epoch_fused(corpus, B, seed=1)
    w2v_fused(torch, pm, list(pm.batches(corpus, B, seed=1)))
    changes["prefetched_vs_placed"] = (w2v_snapshot(pe), w2v_snapshot(pm),
                                       start)
    close(pe, pm)

    bench = SkipGram(V, D, negatives=K, learning_rate=W2V_LR,
                     name="w2v_bench")
    step, place = bench.make_fused_step()
    cur = [*bench.table_in.raw_value(), *bench.table_out.raw_value()]
    cb, ob, nb = place(c), place(o), place(neg)

    def fused_once():
        cur[:] = step(*cur, cb, ob, nb)[:4]

    fused_ms = cuda_ms(fused_once, iters=100, warmup=3)
    fused_profile = profile_calls(torch, fused_once, 20)
    bench.table_in.raw_assign(cur[0], cur[1])
    bench.table_out.raw_assign(cur[2], cur[3])
    for _ in range(2):
        bench.train_batch(c, o, neg)
    torch.cuda.synchronize()
    s0 = time.perf_counter()
    for _ in range(5):
        bench.train_batch(c, o, neg)
    torch.cuda.synchronize()
    pushpull_s = (time.perf_counter() - s0) / 5
    close(bench)
    peak = torch.cuda.max_memory_allocated()
    dlrm_card = dlrm_run()
    mv.shutdown()
    counts = mv.ops.launch_counts()
    sgns_parity = [sgns_case(torch, sgns, *shape, seed=20 + i)
                   for i, shape in enumerate(SGNS_CASES)]
    sgns_timing = [sgns_times(torch, sgns, *shape)
                   for shape in SGNS_CASES[:2]]

    mv.init(device="cpu")
    cpu_runs = fused_runs()
    dlrm_cpu = dlrm_run()
    mv.shutdown()
    trajectories, sync_free = {}, {}
    for upd in updaters:
        start, end, losses, free = card_runs[upd]
        _, cpu_end, cpu_losses, _ = cpu_runs[upd]
        changes[f"{upd}_card_vs_cpu"] = (end, cpu_end, start)
        trajectories[upd] = (losses, cpu_losses, True)
        sync_free[upd] = free
    changes["dlrm_card_vs_cpu"] = (dlrm_card[1], dlrm_cpu[1], dlrm_card[0])
    trajectories["dlrm"] = (dlrm_card[2], dlrm_cpu[2], False)
    verdict, ok = judge_w2v(changes, trajectories, sync_free)
    moved = {name: {k: float(np.abs(want[k].astype(np.float64)
                                    - start[k]).max()) for k in want}
             for name, (_, want, start) in changes.items()}
    prefetch_ok = pe_steps > 0 and math.isfinite(pe_loss)
    sgns_ok = sgns_launches_ok and all(c["ok"] for c in sgns_parity)
    ok = ok and prefetch_ok and sgns_ok
    emit({"phase": "w2v", "ok": ok, "vocab": V, "dim": D, "batch": B,
          "negatives": K, "learning_rate": W2V_LR,
          "check_learning_rate": {u: w2v_check_lr(u, B) for u in updaters},
          "check_adagrad_eps": W2V_ADAGRAD_EPS,
          "steps": {"sgd": W2V_STEPS, "adagrad": W2V_ADAGRAD_STEPS},
          "rtol": W2V_RTOL,
          "losses_cuda": {u: card_runs[u][2] for u in updaters},
          "losses_cpu": {u: cpu_runs[u][2] for u in updaters},
          **verdict, "reference_change_max": moved,
          "prefetch_epoch": {"steps": pe_steps, "loss": pe_loss},
          "w2v_fused_ms_per_step": fused_ms,
          "w2v_fused_pairs_per_sec": B / (fused_ms * 1e-3),
          "w2v_pushpull_ms_per_step": pushpull_s * 1e3,
          "w2v_pushpull_pairs_per_sec": B / pushpull_s,
          "fused_profile": fused_profile, "peak_bytes": peak,
          "dlrm": {"users": DLRM_USERS, "items": DLRM_ITEMS,
                   "dim": DLRM_DIM, "batch": DLRM_BATCH,
                   "learning_rate": DLRM_LR * DLRM_BATCH,
                   "losses_cuda": dlrm_card[2], "losses_cpu": dlrm_cpu[2]},
          "launch_counts": counts,
          "sgns": {"launches": sgns_launches,
                   "fused_steps": W2V_STEPS + W2V_ADAGRAD_STEPS,
                   "rtol": SGNS_RTOL, "atol_share": SGNS_ATOL_SHARE,
                   "parity": sgns_parity, "times": sgns_timing},
          "card": card})
    if not ok:
        raise AssertionError(
            f"w2v phase failed: {verdict}, prefetch epoch {pe_steps} steps "
            f"loss {pe_loss}, sgns launches {sgns_launches}, sgns parity "
            f"{sgns_parity}")
    return B / (fused_ms * 1e-3)


# ------------------------------------------------------------ LightLDA


def z_disagreement(got_z, want_z, docs) -> float:
    """Share of the tokens (``docs`` != -1) whose topic in ``got_z``
    differs from ``want_z``; 1.0 for a shape mismatch."""
    got_z, want_z, docs = (np.asarray(a) for a in (got_z, want_z, docs))
    if got_z.shape != want_z.shape or got_z.shape != docs.shape:
        return 1.0
    valid = docs != -1
    if not valid.any():
        return 0.0
    return float((got_z[valid] != want_z[valid]).mean())


def lda_counts_conserved(docs, doc_topic, word_topic, topic_sum):
    """({check: bool}, all hold) for LightLDA's counts, exactly: every
    doc-topic row sums to its doc's length, the topic totals to the token
    count, and each word-topic column to its topic's total."""
    docs = np.asarray(docs)
    dt = np.asarray(doc_topic, np.float64)
    wt = np.asarray(word_topic, np.float64)
    ts = np.asarray(topic_sum, np.float64)
    lengths = (docs != -1).sum(axis=1)
    shapes = (dt.shape == (docs.shape[0], ts.shape[0])
              and wt.ndim == 2 and wt.shape[1] == ts.shape[0])
    checks = {
        "doc_rows_sum_to_lengths": bool(
            shapes and np.array_equal(dt.sum(axis=1), lengths)),
        "topic_totals_sum_to_tokens": bool(ts.sum() == lengths.sum()),
        "word_columns_equal_topic_totals": bool(
            shapes and np.array_equal(wt.sum(axis=0), ts)),
    }
    return checks, all(checks.values())


def mh_bound_bytes(vocab, topics) -> int:
    """Bytes the MH sweep's [V, K] passes must move, each input read once
    and each output written once, in float32: the proposal build (read
    the counts, write the density and its cumsum: 3), the dense
    word-topic delta (written once: 1) and the table's add (read the
    table and the delta, write the table: 3)."""
    return 4 * vocab * topics * (3 + 1 + 3)


def lda_host_draws(torch, docs_shape, topics, mh_steps, seed):
    """One fused and one MH sweep's draws, made once on the host from a
    seeded generator: (Gumbel noise [D, L, K], MHDraws)."""
    from multiverso_tpu_torch.apps.lightlda import MHDraws, gumbel_noise

    g = torch.Generator().manual_seed(seed)
    shape = tuple(docs_shape)
    gumbel = gumbel_noise(torch.rand(shape + (topics,), generator=g))
    u = torch.rand((3, mh_steps) + shape, generator=g)
    t = torch.randint(0, topics, (mh_steps,) + shape, generator=g)
    return gumbel, MHDraws(u[0], u[1], t, u[2])


def host_array(x) -> np.ndarray:
    """A tensor (on any device) or an array as a host array."""
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def lda_sweep(LightLDA, docs, sweep, draws, vocab=LDA_VOCAB,
              topics=LDA_TOPICS):
    """A fresh LightLDA (``bench_lightlda``'s alpha and beta) from
    ``initialize_counts`` through one sweep — "fused", "mh" (``draws`` on
    the host: moved to the tables' device) or "sample" — and its state
    after it as host arrays: (z, doc_topic, word_topic, topic_sum)."""
    from multiverso_tpu_torch.apps.lightlda import MHDraws

    lda = LightLDA(vocab, topics, alpha=LDA_ALPHA, beta=LDA_BETA,
                   name=f"lda_{sweep}")
    dt = lda.initialize_counts(docs, seed=0)
    if sweep == "fused":
        dt = lda.run_fused_pass(docs, dt, gumbel=draws.to(lda.device))
    elif sweep == "mh":
        dt = lda.run_mh_pass(docs, dt, mh_steps=LDA_MH_STEPS,
                             draws=MHDraws(*(x.to(lda.device)
                                             for x in draws)))
    else:
        dt = lda.sample_pass(docs, dt, seed=0)
    out = (lda._z.copy(), host_array(dt), lda.word_topic.get(),
           lda.topic_sum.get())
    lda.close()
    return out


def lda_check_runs(LightLDA, docs, sample_docs, gumbel, mh):
    """The three sweeps the lda phase holds card against CPU: {sweep:
    state after it}."""
    return {"fused": lda_sweep(LightLDA, docs, "fused", gumbel),
            "mh": lda_sweep(LightLDA, docs, "mh", mh),
            "sample": lda_sweep(LightLDA, sample_docs, "sample", None)}


def lda_rate(torch, LightLDA, docs, sweep, topics):
    """``bench.py``'s rate of one sweep kind: one warm-up sweep, then the
    median of 3 on the host clock (each ending in a synchronize); then
    one profiled sweep (launches, the device's busy share) and the
    conserved counts after all of them."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lda = LightLDA(LDA_VOCAB, topics, alpha=LDA_ALPHA, beta=LDA_BETA,
                   name=f"lda_{sweep}_k{topics}")

    dt = [lda.initialize_counts(docs)]

    def run():
        if sweep == "fused":
            dt[0] = lda.run_fused_pass(docs, dt[0])
        else:
            dt[0] = lda.run_mh_pass(docs, dt[0], mh_steps=LDA_MH_STEPS)

    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        s0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - s0)
    prof = profile_calls(torch, run, 1, top=8)
    sec = float(np.median(times))
    checks, conserved = lda_counts_conserved(
        docs, host_array(dt[0]), lda.word_topic.get(), lda.topic_sum.get())
    out = {"topics": topics, "sweep_s": times, "sweep_ms_median": sec * 1e3,
           "tokens_per_sec": docs.size / sec,
           "launches_per_sweep": prof["kernels_per_step"],
           "device_busy_share": prof["device_busy_share"],
           "profiled_sweep": prof, "conserved": checks,
           "peak_bytes": torch.cuda.max_memory_allocated()}
    if sweep == "mh":
        nbytes = mh_bound_bytes(LDA_VOCAB, topics)
        bound_ms = nbytes / PEAK_HBM_BYTES * 1e3
        out.update({"bound_bytes": nbytes, "bound_ms": bound_ms,
                    "bound_share_of_sweep": bound_ms / (sec * 1e3)})
    lda.close()
    torch.cuda.empty_cache()
    return out, conserved


def lda_purity_run(LightLDA, synthetic_documents):
    """25 MH sweeps at the planted-topic test's setting; topic_purity."""
    p = LDA_PURITY
    docs, true = synthetic_documents(p["docs"], p["vocab"], p["topics"],
                                     doc_len=p["doc_len"], seed=p["seed"],
                                     concentration=p["concentration"])
    lda = LightLDA(p["vocab"], p["topics"], alpha=LDA_ALPHA, beta=LDA_BETA,
                   seed=p["seed"], name="lda_purity")
    dt = lda.initialize_counts(docs, seed=p["seed"])
    for _ in range(p["sweeps"]):
        dt = lda.run_mh_pass(docs, dt, mh_steps=LDA_MH_STEPS)
    purity = float(lda.topic_purity(docs, true, dt))
    lda.close()
    return purity


def phase_lda(torch, mv, card):
    """LightLDA at bench_lightlda's shape: the device sweeps card against
    CPU with one set of draws, exact count conservation, an exact
    ``sample_pass``, topic recovery, and bench.py's three rates."""
    from multiverso_tpu_torch.apps import LightLDA, synthetic_documents

    docs, _ = synthetic_documents(LDA_DOCS, LDA_VOCAB, LDA_TOPICS,
                                  doc_len=LDA_LEN, seed=0)
    gumbel, mh = lda_host_draws(torch, docs.shape, LDA_TOPICS,
                                LDA_MH_STEPS, seed=1)
    sample_docs = docs[:LDA_SAMPLE_DOCS]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mv.ops.reset_launch_counts()
    mv.init(device=None)
    runs = {"card": lda_check_runs(LightLDA, docs, sample_docs, gumbel, mh)}
    purity = lda_purity_run(LightLDA, synthetic_documents)
    check_peak = torch.cuda.max_memory_allocated()
    rates, conserved_after_rates = {}, {}
    for sweep, topics in (("fused", LDA_TOPICS),
                          *(("mh", k) for k in LDA_MH_TOPICS)):
        key = "fused" if sweep == "fused" else f"mh_k{topics}"
        rates[key], conserved_after_rates[key] = lda_rate(
            torch, LightLDA, docs, sweep, topics)
    mv.shutdown()
    counts = mv.ops.launch_counts()
    mv.init(device="cpu")
    runs["cpu"] = lda_check_runs(LightLDA, docs, sample_docs, gumbel, mh)
    mv.shutdown()

    z_shares, conservation = {}, {}
    for sweep in ("fused", "mh"):
        card_z, card_dt, card_wt, card_ts = runs["card"][sweep]
        z_shares[sweep] = z_disagreement(card_z, runs["cpu"][sweep][0], docs)
        conservation[sweep] = lda_counts_conserved(docs, card_dt, card_wt,
                                                   card_ts)[0]
    sample_exact = all(np.array_equal(a, b) for a, b in
                       zip(runs["card"]["sample"], runs["cpu"]["sample"]))
    conservation["sample"] = lda_counts_conserved(
        sample_docs, *runs["card"]["sample"][1:])[0]
    ok = (all(v <= LDA_Z_TOL for v in z_shares.values())
          and all(all(c.values()) for c in conservation.values())
          and all(conserved_after_rates.values())
          and sample_exact and purity > LDA_PURITY_MIN)
    emit({"phase": "lda", "ok": ok, "docs": LDA_DOCS, "doc_len": LDA_LEN,
          "vocab": LDA_VOCAB, "topics": LDA_TOPICS, "alpha": LDA_ALPHA,
          "beta": LDA_BETA, "mh_steps": LDA_MH_STEPS,
          "z_differing_share": z_shares, "z_tol": LDA_Z_TOL,
          "conserved": conservation,
          "conserved_after_timed_sweeps": conserved_after_rates,
          "sample_pass_docs": LDA_SAMPLE_DOCS,
          "sample_pass_exact": sample_exact, "purity": purity,
          "purity_min": LDA_PURITY_MIN, "purity_setting": LDA_PURITY,
          "lda_tokens_per_sec": rates["fused"]["tokens_per_sec"],
          **{f"lda_mh_k{k}_tokens_per_sec": rates[f"mh_k{k}"]
             ["tokens_per_sec"] for k in LDA_MH_TOPICS},
          "sweeps": rates, "checks_peak_bytes": check_peak,
          "launch_counts": counts, "card": card})
    if not ok:
        raise AssertionError(
            f"lda phase failed: z differing {z_shares}, conserved "
            f"{conservation} / {conserved_after_rates}, sample_pass exact "
            f"{sample_exact}, purity {purity}")


# ---------------------------------------------------- skip-gram mixture


def sgmix_tables(sg):
    """A SkipGramMixture's three tables, in its fused step's order."""
    return {"sense": sg.table_sense, "out": sg.table_out,
            "prior": sg.table_prior}


def sgmix_snapshot(sg):
    """A SkipGramMixture's three tables and their updater state, {name:
    numpy copy}."""
    return tables_snapshot(sgmix_tables(sg))


def sgmix_fused(torch, sg, batches, sync_check=False):
    """The mixture's fused step over host batches (c, bags, mask, neg),
    all placed first; the tables are handed back after.  Returns the
    step losses and, with ``sync_check``, whether the steps ran under
    ``torch.cuda.set_sync_debug_mode("error")`` without raising (else
    None)."""
    step, place = sg.make_fused_step()
    placed = [(place(c), place(bags), torch.as_tensor(mask).to(sg.device),
               place(neg)) for c, bags, mask, neg in batches]
    return run_fused(torch, list(sgmix_tables(sg).values()), step, placed,
                     sync_check)


def sgmix_batches(sg, synthetic_corpus, n):
    """``n`` batches of SGMIX_BATCH occurrences through ``sg.batches``
    from the word2vec stream ``synthetic_corpus(n·B, V, seed=0)``."""
    import itertools

    corpus = synthetic_corpus(n * SGMIX_BATCH, sg.vocab_size, seed=0)
    return list(itertools.islice(sg.batches(corpus, SGMIX_BATCH, seed=0),
                                 n))


def padding_batches(batches, vocab):
    """Two momentum batches for the padding check: the first makes word
    V-1 a center and a context, so its rows gain momentum state; the
    second holds no id V-1, only the padding id V beside it."""
    c, bags, mask, neg = (np.array(x) for x in batches[0])
    c[0], bags[0, 0], mask[0, 0] = vocab - 1, vocab - 1, True
    second = tuple(np.where(x == vocab - 1, vocab - 2, x) if x.dtype != bool
                   else x for x in batches[1])
    return (c, bags, mask, neg), second


def rows_unchanged(before, after, vocab, senses):
    """{table: bool}: word V-1's rows of the sense, out and prior tables
    and of their updater state are bit for bit the same."""
    sense_rows = slice((vocab - 1) * senses, vocab * senses)
    out = {}
    for k, b in before.items():
        rows = sense_rows if k.startswith("sense") else slice(vocab - 1,
                                                             vocab)
        out[k] = bool(np.array_equal(b[rows], after[k][rows]))
    return out


def senses_separate(post_a, post_b, prior, cos):
    """The homonym test's verdict (tests/test_apps.py): each context world
    picks its own dominant sense, neither sense starves, and the two
    sense vectors differ."""
    post_a, post_b, prior = (np.asarray(x) for x in (post_a, post_b, prior))
    return bool(post_a.max() > 0.8 and post_b.max() > 0.8
                and post_a.argmax() != post_b.argmax()
                and prior.min() > 0.2 and cos < 0.9)


def sgmix_homonym(SkipGramMixture, synthetic_homonym_corpus):
    """The homonym test's training (V 21, dim 16, 12 epochs) and what it
    judges: (posterior under A-contexts, under B-contexts, prior, cosine
    of the two winning sense vectors)."""
    corpus = synthetic_homonym_corpus(4000, vocab_size=21,
                                      groups=((1, 10), (11, 20)), seed=0)
    sg = SkipGramMixture(21, dim=16, senses=2, learning_rate=0.3,
                         negatives=3, window=3, seed=3, name="sgmix_homonym")
    for epoch in range(12):
        sg.train_epoch_fused(corpus, batch_size=256, seed=epoch)
    post_a = sg.sense_posterior(0, np.arange(1, 11))
    post_b = sg.sense_posterior(0, np.arange(11, 21))
    sv_a = sg.sense_vector(0, int(post_a.argmax()))
    sv_b = sg.sense_vector(0, int(post_b.argmax()))
    cos = float((sv_a @ sv_b) / (np.linalg.norm(sv_a) * np.linalg.norm(sv_b)
                                 + 1e-12))
    return post_a, post_b, sg.sense_priors(0), cos


def phase_sgmix(torch, mv, card):
    """The skip-gram mixture at bench_w2v's vocabulary and width: card
    against CPU and push-pull against fused by the table changes, a
    sync-free fused step, padding that leaves row V-1 alone under
    momentum, the homonym's senses separating, and the fused rate."""
    from multiverso_tpu_torch.apps import (SkipGramMixture, synthetic_corpus,
                                           synthetic_homonym_corpus)

    V = SGMIX_VOCAB

    def model(name, updater="sgd", lr=SGMIX_CHECK_LR):
        return SkipGramMixture(V, SGMIX_DIM, senses=SGMIX_SENSES,
                               learning_rate=lr, negatives=SGMIX_NEG,
                               window=SGMIX_WINDOW, updater_type=updater,
                               name=name)

    def close(*models):
        for m in models:
            for t in sgmix_tables(m).values():
                t.close()

    def fused_run(sg, batches):
        start = sgmix_snapshot(sg)
        losses, free = sgmix_fused(torch, sg, batches,
                                   sync_check=sg.device.type == "cuda")
        end = sgmix_snapshot(sg)
        close(sg)
        return start, end, losses, free

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mv.ops.reset_launch_counts()
    mv.init(device=None)
    sg = model("sgmix_sgd")
    batches = sgmix_batches(sg, synthetic_corpus, SGMIX_STEPS)
    start, card_end, card_losses, sync_free = fused_run(sg, batches)

    a, b = model("sgmix_pp"), model("sgmix_fu")
    pp_start = sgmix_snapshot(a)
    a.train_batch(*batches[0])
    sgmix_fused(torch, b, batches[:1])
    pushpull = (sgmix_snapshot(a), sgmix_snapshot(b), pp_start)
    close(a, b)

    m = model("sgmix_momentum", "momentum", lr=SGMIX_LR)
    first, second = padding_batches(batches, V)
    sgmix_fused(torch, m, [first])
    before = sgmix_snapshot(m)
    sgmix_fused(torch, m, [second])
    after = sgmix_snapshot(m)
    untouched = rows_unchanged(before, after, V, SGMIX_SENSES)
    moved_elsewhere = bool(np.abs(after["out"] - before["out"]).max() > 0)
    close(m)

    post_a, post_b, prior, cos = sgmix_homonym(SkipGramMixture,
                                               synthetic_homonym_corpus)
    separate = senses_separate(post_a, post_b, prior, cos)

    bench = model("sgmix_bench", lr=SGMIX_LR)
    step, place = bench.make_fused_step()
    c, bags, mask, neg = batches[0]
    placed = (place(c), place(bags), torch.as_tensor(mask).to(CARD),
              place(neg))
    cur = [x for t in sgmix_tables(bench).values() for x in t.raw_value()]

    def fused_once():
        cur[:] = step(*cur, *placed)[:6]

    fused_ms = cuda_ms(fused_once, iters=100, warmup=3)
    fused_profile = profile_calls(torch, fused_once, 20)
    close(bench)
    peak = torch.cuda.max_memory_allocated()
    mv.shutdown()
    counts = mv.ops.launch_counts()

    mv.init(device="cpu")
    _, cpu_end, cpu_losses, _ = fused_run(model("sgmix_sgd"), batches)
    mv.shutdown()
    verdict, ok = judge_w2v(
        {"sgd_card_vs_cpu": (card_end, cpu_end, start),
         "pushpull_vs_fused": pushpull},
        {"sgd": (card_losses, cpu_losses, False)}, {"sgd": sync_free})
    ok = ok and all(untouched.values()) and moved_elsewhere and separate
    emit({"phase": "sgmix", "ok": ok, "vocab": V, "dim": SGMIX_DIM,
          "senses": SGMIX_SENSES, "window": SGMIX_WINDOW,
          "negatives": SGMIX_NEG, "batch": SGMIX_BATCH,
          "steps": SGMIX_STEPS, "learning_rate": SGMIX_LR,
          "check_learning_rate": SGMIX_CHECK_LR, "rtol": W2V_RTOL,
          "losses_cuda": card_losses, "losses_cpu": cpu_losses, **verdict,
          "padding_row_v_minus_1_unchanged": untouched,
          "padding_step_moved_the_table": moved_elsewhere,
          "homonym": {"posterior_a": post_a.tolist(),
                      "posterior_b": post_b.tolist(),
                      "prior": prior.tolist(), "cos": cos,
                      "separate": separate},
          "sgmix_fused_ms_per_step": fused_ms,
          "sgmix_fused_occurrences_per_sec": SGMIX_BATCH / (fused_ms * 1e-3),
          "fused_profile": fused_profile, "peak_bytes": peak,
          "launch_counts": counts, "card": card})
    if not ok:
        raise AssertionError(
            f"sgmix phase failed: {verdict}, V-1 untouched {untouched}, "
            f"senses separate {separate}")


# ------------------------------------------------------- ResNet-20 (ext)


@contextlib.contextmanager
def cudnn_flags(torch, allow_tf32, deterministic):
    """cuDNN's TF32 and determinism switches set for the block, and the
    values found restored after it.  ``allow_tf32=True,
    deterministic=False`` are PyTorch's defaults, which ``main`` turns
    off for the kernel checks."""
    cudnn = torch.backends.cudnn
    old = cudnn.allow_tf32, cudnn.deterministic
    cudnn.allow_tf32, cudnn.deterministic = allow_tf32, deterministic
    try:
        yield
    finally:
        cudnn.allow_tf32, cudnn.deterministic = old


def torch_float_settings(torch) -> dict:
    """The switches that pick a float32 convolution's or matmul's
    precision and algorithm, read as they stand."""
    return {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "cudnn.deterministic": torch.backends.cudnn.deterministic,
            "cudnn.benchmark": torch.backends.cudnn.benchmark,
            "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32}


def net_flat(torch, net):
    """A net's parameters as one float32 vector on their device."""
    return torch.cat([p.detach().reshape(-1).float()
                      for p in net.parameters()])


def same_state(a, b) -> bool:
    """Two modules' parameters and buffers are bit for bit the same."""
    sa, sb = a.state_dict(), b.state_dict()
    return list(sa) == list(sb) and all(
        np.array_equal(sa[k].detach().cpu().numpy(),
                       sb[k].detach().cpu().numpy()) for k in sa)


def resnet_sync_records(torch, app, xb, yb):
    """One step of ``app``: ``local_steps``, then each manager's sync in
    turn, recording around it (table before, net i's flat parameters and
    the manager's last synced value, table after, net i's parameters
    after), all on the app's device."""
    app.local_steps(xb, yb)
    records = []
    for net, mgr in zip(app.nets, app.mgrs):
        before = mgr.table.get(device=True)
        flat, synced = net_flat(torch, net), mgr._synced.clone()
        mgr.sync_all_param()
        records.append((before, flat, synced, mgr.table.get(device=True),
                        net_flat(torch, net)))
    return records


def judge_protocol(torch, records, workers):
    """({sync i: {table, params}}, verdict) of the delta protocol, bit for
    bit: after manager i's sync the table equals the table before plus
    ``(flat_i - synced_i) · (1/N)`` in float32, and net i's parameters
    equal the table."""
    out = {}
    for i, (before, flat, synced, after, params) in enumerate(records):
        want = before + (flat - synced) * (1.0 / workers)
        out[f"sync{i}"] = {"table_exact": bool(torch.equal(after, want)),
                           "params_exact": bool(torch.equal(params, after))}
    ok = bool(out) and all(all(v.values()) for v in out.values())
    return out, ok


def rel_l2_change(got, want, start) -> float:
    """||got - want|| over ||want - start||: the L2 counterpart of
    ``rel_change``.  A few chaotic flips weigh little in it, an error in
    every product (TF32) weighs in full."""
    start = np.asarray(start, np.float64)
    if np.shape(got) != start.shape or np.shape(want) != start.shape:
        return math.inf
    moved = np.linalg.norm(np.asarray(want, np.float64) - start)
    if not (np.isfinite(moved) and moved > 0):
        return math.inf
    err = np.linalg.norm(np.asarray(got, np.float64)
                         - np.asarray(want, np.float64))
    return float(err / moved) if np.isfinite(err) else math.inf


def resnet_l2_changes(card, cpu, start, tol=RESNET_L2_TOL):
    """({worker: rel_l2_change}, each within its worker's tol)."""
    rels = {f"worker{i}": rel_l2_change(g, w, s)
            for i, (g, w, s) in enumerate(zip(card, cpu, start))}
    return rels, (len(rels) == len(tol)
                  and all(r <= t for r, t in zip(rels.values(), tol)))


def resnet_step_held(card, cpu, start):
    """({worker: passes}, both) of a first step held by both measures:
    the largest entry's change (``RESNET_TOL``) and the L2 change
    (``RESNET_L2_TOL``)."""
    rels, _ = judge_resnet_changes(card, cpu, start)
    l2, _ = resnet_l2_changes(card, cpu, start)
    held = {w: rels[w] <= t and l2[w] <= t2 for w, t, t2 in
            zip(rels, RESNET_TOL, RESNET_L2_TOL)}
    return held, len(held) == len(RESNET_TOL) and all(held.values())


def judge_resnet_changes(card, cpu, start, tol=RESNET_TOL):
    """({worker: rel_change}, each within its worker's tol): each
    worker's parameters after the same steps on the card and on the CPU,
    held by the change the CPU run made from ``start``."""
    rels = {f"worker{i}": rel_change(g, w, s)
            for i, (g, w, s) in enumerate(zip(card, cpu, start))}
    return rels, (len(rels) == len(tol)
                  and all(r <= t for r, t in zip(rels.values(), tol)))


def converged(accuracy, floor=RESNET_ACC_MIN) -> bool:
    return bool(accuracy > floor)


def resnet_check_run(torch, app, x, y, steps):
    """``steps`` of ``app.train_step`` on the first batches of ``x``/``y``
    (on the app's device): each worker's flat parameters at the start
    and after every step, as numpy, and the losses."""
    xd, yd = app.place(x[:steps * RESNET_BATCH], y[:steps * RESNET_BATCH])

    def flats():
        return [net_flat(torch, n).cpu().numpy() for n in app.nets]

    start, after, losses = flats(), [], []
    for s in range(steps):
        b = slice(s * RESNET_BATCH, (s + 1) * RESNET_BATCH)
        losses.append(float(app.train_step(xd[b], yd[b])))
        after.append(flats())
    return start, after, losses


def close_app(app):
    app.mgrs[0].table.close()


def phase_resnet(torch, mv, card):
    """Data-parallel ResNet-20 on CIFAR-shaped data: the card's initial
    weights against the CPU build, the delta protocol bit for bit, 5
    steps card against CPU (the first held, all reported beside the
    CPU's one-ulp floor and a TF32 control step), a step free of host
    syncs, one epoch's held-out accuracy, then the rate, the syncs'
    share, launches, busy share and peak memory; all but the card
    against CPU under PyTorch's defaults."""
    from multiverso_tpu_torch.apps.resnet import (ResNet20DataParallel,
                                                  build_resnet20,
                                                  synthetic_cifar)

    def app_on(device=None):
        return ResNet20DataParallel(RESNET_WORKERS, RESNET_LR,
                                    RESNET_CLASSES, seed=0, device=device)

    x, y = synthetic_cifar(RESNET_TRAIN + RESNET_HELD, RESNET_CLASSES,
                           seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mv.ops.reset_launch_counts()
    mv.init(device=None)
    # (a) the card's nets against the CPU build from the same seed.
    app = app_on()
    with torch.random.fork_rng(devices=[]):
        cpu_nets = []
        for _ in range(RESNET_WORKERS):
            torch.manual_seed(0)
            cpu_nets.append(build_resnet20(RESNET_CLASSES))
    params = sum(p.numel() for p in app.nets[0].parameters())
    init_exact = (all(same_state(a, b) for a, b in zip(app.nets, cpu_nets))
                  and params == RESNET_PARAMS)
    # (c), the card's side: TF32 off and deterministic cuDNN, here only.
    with cudnn_flags(torch, allow_tf32=False, deterministic=True):
        start, card_end, card_losses = resnet_check_run(
            torch, app, x, y, RESNET_CHECK_STEPS)
    close_app(app)
    # The control for (c)'s limits: the same steps with cuDNN's TF32 on,
    # which the held first step must reject for every worker.
    app = app_on()
    with cudnn_flags(torch, allow_tf32=True, deterministic=True):
        _, tf32_end, _ = resnet_check_run(torch, app, x, y,
                                          RESNET_CHECK_STEPS)
    close_app(app)
    # The rest under PyTorch's defaults (cuDNN TF32 on, not deterministic).
    with cudnn_flags(torch, allow_tf32=True, deterministic=False):
        # (b) the protocol on a step of a fresh app, then (d) a whole
        # step under sync-debug "error".
        app = app_on()
        xd, yd = app.place(x[:RESNET_TRAIN], y[:RESNET_TRAIN])
        protocol, protocol_ok = judge_protocol(
            torch, resnet_sync_records(torch, app, xd[:RESNET_BATCH],
                                       yd[:RESNET_BATCH]), RESNET_WORKERS)
        b2 = slice(RESNET_BATCH, 2 * RESNET_BATCH)
        _, sync_free = without_sync(torch, lambda: app.train_step(xd[b2],
                                                                  yd[b2]))
        close_app(app)
        # (e) one epoch from the start, then the held-out accuracy.
        app = app_on()
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        epoch_loss = app.train_epoch(xd, yd, batch_size=RESNET_BATCH)
        epoch_s = time.perf_counter() - s0
        accuracy = app.accuracy(x[RESNET_TRAIN:], y[RESNET_TRAIN:])
        steps_per_epoch = RESNET_TRAIN // RESNET_BATCH
        # The rate, going on from the trained app through the training
        # batches, with the switches it ran under read as it starts.
        batch_at = [0]

        def step_once():
            i = batch_at[0] % steps_per_epoch * RESNET_BATCH
            batch_at[0] += 1
            app.train_step(xd[i:i + RESNET_BATCH], yd[i:i + RESNET_BATCH])

        def syncs_once():
            for m in app.mgrs:
                m.sync_all_param()

        rate_settings = torch_float_settings(torch)
        step_ms = cuda_ms(step_once, iters=RESNET_TIMED_STEPS, warmup=5)
        sync_ms = cuda_ms(syncs_once, iters=RESNET_TIMED_STEPS, warmup=5)
        step_profile = profile_calls(torch, step_once, 1)
        sync_profile = profile_calls(torch, syncs_once, 20, top=5)
        close_app(app)
    peak = torch.cuda.max_memory_allocated()
    mv.shutdown()
    counts = mv.ops.launch_counts()

    mv.init(device="cpu")
    cpu_app = app_on("cpu")
    cpu_start, cpu_end, cpu_losses = resnet_check_run(
        torch, cpu_app, x, y, RESNET_CHECK_STEPS)
    close_app(cpu_app)
    mv.shutdown()
    # The CPU's float32 noise floor: the same run with every input image
    # moved by one ulp, against the CPU run.
    mv.init(device="cpu")
    floor_app = app_on("cpu")
    _, floor_end, _ = resnet_check_run(
        torch, floor_app, np.nextafter(x[:RESNET_CHECK_STEPS * RESNET_BATCH],
                                       np.float32(np.inf)), y,
        RESNET_CHECK_STEPS)
    close_app(floor_app)
    mv.shutdown()
    start_same = all(np.array_equal(a, b) for a, b in zip(start, cpu_start))
    by_step = [judge_resnet_changes(c, w, start)[0]
               for c, w in zip(card_end, cpu_end)]
    floor_by_step = [judge_resnet_changes(f, w, start)[0]
                     for f, w in zip(floor_end, cpu_end)]
    changes, changes_ok = judge_resnet_changes(card_end[0], cpu_end[0],
                                               start)
    tf32_changes, _ = judge_resnet_changes(tf32_end[0], cpu_end[0], start)
    l2_by_step = {
        run: [resnet_l2_changes(e, w, start)[0]
              for e, w in zip(ends, cpu_end)]
        for run, ends in (("card", card_end), ("tf32", tf32_end),
                          ("cpu_one_ulp", floor_end))}
    tf32_by_step = [judge_resnet_changes(c, w, start)[0]
                    for c, w in zip(tf32_end, cpu_end)]
    l2_changes, l2_ok = resnet_l2_changes(card_end[0], cpu_end[0], start)
    # The control: TF32 on must fail the held step for every worker.
    tf32_held, _ = resnet_step_held(tf32_end[0], cpu_end[0], start)
    tf32_rejected = bool(tf32_held) and not any(tf32_held.values())
    ok = (init_exact and protocol_ok and start_same and changes_ok
          and l2_ok and tf32_rejected and sync_free and converged(accuracy))
    emit({"phase": "resnet", "ok": ok, "workers": RESNET_WORKERS,
          "lr": RESNET_LR, "batch": RESNET_BATCH, "classes": RESNET_CLASSES,
          "train_images": RESNET_TRAIN, "held_out_images": RESNET_HELD,
          "parameters": params, "initial_weights_exact": init_exact,
          "protocol": protocol, "check_steps": RESNET_CHECK_STEPS,
          "card_vs_cpu_change_step1": changes, "tol": RESNET_TOL,
          "card_vs_cpu_change_by_step": by_step,
          "tf32_control_change_step1": tf32_changes,
          "tol_rejects_tf32_control": {
              w: r > t for (w, r), t in zip(tf32_changes.items(),
                                            RESNET_TOL)},
          "card_vs_cpu_l2_change_step1": l2_changes,
          "l2_tol": RESNET_L2_TOL,
          "held_step_rejects_tf32_control": {
              w: not h for w, h in tf32_held.items()},
          "cpu_one_ulp_change_by_step": floor_by_step,
          "tf32_control_change_by_step": tf32_by_step,
          "l2_change_by_step": l2_by_step,
          "check_losses_cuda": card_losses,
          "check_losses_cpu": cpu_losses,
          "step_sync_free": sync_free, "epoch_steps": steps_per_epoch,
          "epoch_s": epoch_s, "epoch_last_loss": epoch_loss,
          "held_out_accuracy": accuracy, "accuracy_min": RESNET_ACC_MIN,
          "resnet_ms_per_step": step_ms,
          "resnet_images_per_sec": RESNET_BATCH / (step_ms * 1e-3),
          "syncs_ms": sync_ms, "syncs_share_of_step": sync_ms / step_ms,
          "step_profile": step_profile, "syncs_profile": sync_profile,
          "rate_settings": rate_settings,
          "peak_bytes": peak, "launch_counts": counts, "card": card})
    if not ok:
        raise AssertionError(
            f"resnet phase failed: initial weights exact {init_exact}, "
            f"protocol {protocol}, same start {start_same}, card vs CPU "
            f"{changes} (tol {RESNET_TOL}), L2 {l2_changes} (tol "
            f"{RESNET_L2_TOL}), TF32 control rejected {tf32_rejected}, "
            f"sync-free {sync_free}, "
            f"held-out accuracy {accuracy}")


# ------------------------------------------------------- the host planes


def judge_planes(trace_doc, prom_text, rules_loaded, default_rules):
    """({check: value}, verdict) of an armed run: the trace holds the
    profiler's folded-stack events beside the spans, the metrics file
    was written with the health evaluator's series in it, and the
    evaluator held the default rule pack."""
    events = trace_doc.get("traceEvents", []) if trace_doc else []
    profile = [e for e in events if e.get("name", "").startswith("profile:")
               and e.get("args", {}).get("plane") == "profiler/python"]
    spans = [e for e in events if not e.get("name", "").startswith(
        "profile:")]
    out = {"profile_events": len(profile), "spans": len(spans),
           "metrics_written": bool(prom_text),
           "health_evaluated": "health_alerts_firing" in (prom_text or ""),
           "rules_loaded": rules_loaded, "default_rules": default_rules}
    ok = bool(profile and spans and out["health_evaluated"]
              and rules_loaded == default_rules)
    return out, ok


def planes_run(torch, mv, LogisticRegression, x, y, armed, trace_dir):
    """The lr phase's fused step, PLANES_STEPS times under CUDA events,
    in one lifecycle with the planes armed or not: (ms per step, the
    armed evaluator's rule count, profiler samples)."""
    from multiverso_tpu_torch import health, profiler

    args = [*PLANES_FLAGS, f"-trace_dir={trace_dir}"] if armed else []
    mv.init(device=None, args=args)
    try:
        lr = LogisticRegression(LR_FEATURES, LR_CLASSES, learning_rate=0.1,
                                name="lr_planes")
        step, place = lr.make_fused_step()
        cur = list(lr.table.raw_value())
        xb, yb = place(x), place(y)

        def fused_once():
            cur[0], cur[1], _ = step(cur[0], cur[1], xb, yb)

        ms = cuda_ms(fused_once, iters=PLANES_STEPS, warmup=3)
        lr.table.raw_assign(*cur)
        lr.table.get()
        ev, prof = health.evaluator(), profiler.active()
        rules = len(ev.snapshot()) if ev is not None else 0
        samples = prof.samples if prof is not None else 0
        if armed and ev is not None:
            deadline = time.time() + 5   # at least one flush evaluates
            while not any(s.name == "health.alerts.firing"
                          for s in mv.metrics.REGISTRY.series()) \
                    and time.time() < deadline:
                time.sleep(0.01)
    finally:
        mv.shutdown()
        mv.config.reset()          # -flags are process-global
        mv.tracing.disable()
    return ms, rules, samples


def phase_planes(torch, mv, card):
    """The host planes armed on the card (-profile_hz, -metrics_flush_ms,
    -health_rules, -trace_dir): the LR fused step runs, shutdown writes
    the trace with the profiler's stacks and the metrics file, and the
    health evaluator ran; the step's time armed against disarmed, in
    turns."""
    import tempfile

    from multiverso_tpu_torch import health
    from multiverso_tpu_torch.apps import (LogisticRegression,
                                           synthetic_classification)

    x, y = synthetic_classification(LR_BATCH, LR_FEATURES, LR_CLASSES,
                                    seed=0)
    mv.ops.reset_launch_counts()
    runs = {"disarmed": [], "armed": []}
    with tempfile.TemporaryDirectory() as tmp:
        for i, armed in enumerate(PLANES_ORDER):
            trace_dir = os.path.join(tmp, f"run{i}")
            ms, rules, samples = planes_run(torch, mv, LogisticRegression,
                                            x, y, armed, trace_dir)
            runs["armed" if armed else "disarmed"].append(ms)
            if armed:
                with open(os.path.join(trace_dir, "trace_rank0.json")) as f:
                    trace = json.load(f)
                prom = os.path.join(trace_dir, "metrics_rank0.prom")
                with open(prom) as f:
                    prom_text = f.read()
                verdict, ok = judge_planes(trace, prom_text, rules,
                                           len(health.default_rules()))
                verdict["profiler_samples"] = samples
                if not ok:
                    raise AssertionError(f"planes phase failed: {verdict}")
    counts = mv.ops.launch_counts()
    on, off = (float(np.median(runs[k])) for k in ("armed", "disarmed"))
    emit({"phase": "planes", "ok": True, "flags": list(PLANES_FLAGS),
          "steps": PLANES_STEPS, **verdict,
          "lr_fused_ms_disarmed": runs["disarmed"],
          "lr_fused_ms_armed": runs["armed"],
          "armed_over_disarmed_medians": on / off,
          "launch_counts": counts, "card": card})


# ------------------------------------------------------ the native phase

# bench.py's sizes for the north-star denominators (bench_lr_native8,
# bench_w2v_native8: :498-556) and its serve section (bench_serve:
# 2 ranks).  The JAX package's acceptance for serve_cached_vs_cold_p50
# is >= 10x: printed beside the reading, not gated.
NATIVE_LR = dict(procs=8, steps=60, batch=1024)
NATIVE_W2V = dict(procs=8, steps=20, batch=512)
NATIVE_SERVE_PROCS = 2
SERVE_ACCEPT = 10.0
NATIVE_TIMEOUT_S = 300
NATIVE_ATTEMPTS = 3
NATIVE_BIND_RACE = ("Address already in use", "Failed to bind",
                    "bind failed", "EADDRINUSE")


def machine_file(tmp, procs):
    """A loopback machine file of ``procs`` free ports in ``tmp``: its
    path and the endpoints."""
    import socket

    socks = [socket.socket() for _ in range(procs)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    eps = [f"127.0.0.1:{s.getsockname()[1]}" for s in socks]
    for s in socks:
        s.close()
    mf = os.path.join(tmp, "machines")
    with open(mf, "w") as f:
        f.write("\n".join(eps) + "\n")
    return mf, eps


def worker_env(procs, **extra):
    """The ranks' environment: the checkout on the path and each rank's
    BLAS on its share of the host's cores (``blas_threads``)."""
    threads = str(blas_threads(procs))
    return dict(os.environ, PYTHONPATH=HERE, OMP_NUM_THREADS=threads,
                OPENBLAS_NUM_THREADS=threads, MKL_NUM_THREADS=threads,
                **extra)


def spawn_native_workers(script, procs, marker, extra_args=(),
                         timeout=NATIVE_TIMEOUT_S, exempt_ranks=(), env=None):
    """``procs`` ranks of the port's worker ``apps/<script>`` over a fresh
    loopback machine file (bench.py's ``_spawn_native_workers``): every
    rank's output, or an error naming the rank that failed or lacked
    ``marker``.  A rank in ``exempt_ranks`` (failover's victim, which
    SIGKILLs itself) is held to neither; ``env`` adds variables to the
    ranks' environment.  A launch whose failed ranks all lost a port to
    another process is retried on fresh ports.  At the deadline every rank
    still running is killed, what each rank wrote is read, and the error
    names each rank that was still running with the tail of its output.
    Each rank's BLAS gets its share of the host's cores
    (``blas_threads``), as one process a core under ``mpirun`` would:
    with every rank running a BLAS thread per core, 8 LR ranks on the
    H100 host's 8 cores ran 16-19x slower (33,442 samples/s against
    551,841-647,695)."""
    import tempfile

    worker = os.path.join(HERE, "multiverso_tpu_torch", "apps", script)
    env = worker_env(procs, **(env or {}))
    for attempt in range(NATIVE_ATTEMPTS):
        with tempfile.TemporaryDirectory(prefix="mvt_native_") as tmp:
            mf, _ = machine_file(tmp, procs)
            children = [subprocess.Popen(
                [sys.executable, worker, mf, str(r), *map(str, extra_args)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=env) for r in range(procs)]
            t0 = time.monotonic()
            outs = [None] * procs
            late = []
            try:
                for r, p in enumerate(children):
                    left = max(1.0, timeout - (time.monotonic() - t0))
                    try:
                        outs[r] = p.communicate(timeout=left)[0]
                    except subprocess.TimeoutExpired:
                        late = [q for q, c in enumerate(children)
                                if c.poll() is None]
                        break
            finally:
                for p in children:
                    if p.poll() is None:
                        p.kill()
                for r, p in enumerate(children):
                    if outs[r] is None:
                        outs[r] = p.communicate()[0]
        if late:
            raise RuntimeError(f"{script}: ranks {late} still running at "
                               f"the {timeout} s deadline, killed:\n" +
                               "\n".join(f"rank {r}:\n{outs[r][-2000:]}"
                                         for r in late))
        failed = [r for r, p in enumerate(children)
                  if p.returncode != 0 and r not in exempt_ranks]
        if failed and attempt < NATIVE_ATTEMPTS - 1 and all(
                any(m in outs[r] for m in NATIVE_BIND_RACE) for r in failed):
            continue
        for r, (p, out) in enumerate(zip(children, outs)):
            if r in exempt_ranks:
                continue
            if p.returncode != 0 or marker not in out:
                raise RuntimeError(f"{script} rank {r} failed "
                                   f"(rc={p.returncode}):\n{out[-2000:]}")
        return outs


def blas_threads(procs: int) -> int:
    """BLAS threads per rank: the host's cores shared among the ranks."""
    return max(1, (os.cpu_count() or 1) // procs)


def native_wall(outs) -> float:
    """The job's wall clock: the largest per-rank barrier-to-barrier
    ``dt=`` (bench.py's ``_run_native_workers``)."""
    return max(float(re.search(r"dt=([0-9.]+)", out).group(1))
               for out in outs)


def native_ratios(lr_fused, w2v_fused, lr_native, w2v_native) -> dict:
    """bench.py's north-star ratios, fused rate over the 8-process native
    job's rate, each only when this run measured its fused rate."""
    out = {}
    if lr_fused is not None:
        out["lr_fused_vs_native8"] = lr_fused / lr_native
    if w2v_fused is not None:
        out["w2v_fused_vs_native8"] = w2v_fused / w2v_native
    return out


def serve_numbers(rank0_out) -> dict:
    """bench_serve's keys from rank 0's ``SERVE_BENCH_OK`` line, and
    ``serve_cached_vs_cold_p50``."""
    res = {f"serve_{m.group(1)}": float(m.group(2))
           for m in re.finditer(r"(\w+)=([0-9.]+)", rank0_out)
           if m.group(1) != "rank"}
    res["serve_cached_vs_cold_p50"] = (res["serve_cold_p50_ms"]
                                       / res["serve_cached_p50_ms"])
    return res


def dropping_push(drop_at):
    """A bridge hook (planted fault): the bridge loses its ``drop_at``-th
    push (``init`` makes the first two; 3 is the first step's)."""
    def hook(bridge):
        push, calls = bridge.push, [0]

        def dropped(vec, blocking=False):
            calls[0] += 1
            if calls[0] != drop_at:
                push(vec, blocking=blocking)

        bridge.push = dropped
        return bridge

    return hook


def native_probe_rejects(nat, OffloadedState, updater) -> bool:
    """A runtime under ``updater`` (not ``assign``): the bridge's ``init``
    probe must raise.  The runtime is the process's only one while it
    runs."""
    rt = nat.NativeRuntime(args=[f"-updater_type={updater}",
                                 "-log_level=error"])
    try:
        off = OffloadedState(rt, 64)
        try:
            off.init(np.arange(1, 65, dtype=np.float32))
        except RuntimeError:
            return True
        finally:
            off.close()
        return False
    finally:
        rt.shutdown()


def start_native_build():
    """Start building the native library in a thread, beside the
    kernels' nvcc builds.  Returns the thread and a dict that receives
    whether the library was there already, the build's seconds and any
    error, which the native phase re-raises."""
    import threading

    from multiverso_tpu_torch import native as nat

    out = {"prebuilt": os.path.exists(nat.lib_path())}

    def run():
        t0 = time.perf_counter()
        try:
            nat.ensure_built()
        except (OSError, subprocess.SubprocessError) as exc:
            out["error"] = exc
        out["build_s"] = time.perf_counter() - t0

    thread = threading.Thread(target=run, name="native-build", daemon=True)
    thread.start()
    return thread, out


def phase_native(torch, fa, card, build, lr_fused=None, w2v_fused=None):
    """The native phase (see the module docstring); ``build`` is
    ``start_native_build``'s.  Returns the flash kernels' launch counts
    of the native-store trainer run."""
    import shutil

    from multiverso_tpu_torch import native as nat
    from multiverso_tpu_torch.parallel import OffloadedState

    tools = {name: shutil.which(name) for name in ("make", "g++")}
    thread, built = build
    thread.join()
    if "error" in built:
        raise built["error"]
    lib = nat.lib_path()
    nat.load()
    with open("/proc/self/maps") as f:
        mapped = lib in f.read()
    inside = os.path.realpath(lib).startswith(os.path.realpath(HERE) + os.sep)
    emit({"phase": "native", "check": "build", "ok": mapped and inside,
          "library": os.path.relpath(lib, HERE), **built, "tools": tools,
          "host_cpus": os.cpu_count()})
    if not (mapped and inside):
        raise AssertionError(f"the native library {lib} is not the "
                             f"checkout's own (mapped {mapped})")

    cfg, host, tokens = small_offload_setup(torch)
    arms = {"in_memory": offload_arm(torch, cfg, host, tokens)}
    n = arms["in_memory"][4]
    rt = nat.NativeRuntime(args=["-updater_type=assign", "-log_level=error"])
    try:
        # The bridge alone at the trainer's state size, bit for bit.
        off = OffloadedState(rt, n)
        rng = np.random.default_rng(3)
        v = rng.standard_normal(n, dtype=np.float32)
        v[:3] = (np.float32(1e-38), np.float32(-0.0), np.float32(np.inf))
        s0 = time.perf_counter()
        off.init(v)
        init_s = time.perf_counter() - s0
        w = (v * np.float32(0.5)).astype(np.float32)
        s0 = time.perf_counter()
        off.push(w)
        off.prefetch()
        round_trip = off.wait().tobytes() == w.tobytes()
        round_s = time.perf_counter() - s0
        off.close()
        arms["local"] = offload_arm(torch, cfg, host, tokens, "local")
        fa.reset_launch_counts()
        arms["native"] = offload_arm(torch, cfg, host, tokens, "native", rt)
        counts = fa.launch_counts()
        dropped = offload_arm(torch, cfg, host, tokens, "native", rt,
                              bridge_hook=dropping_push(3))
    finally:
        rt.shutdown()
    verdict, same = judge_offload_arms(
        arms["in_memory"], {k: arms[k] for k in ("local", "native")})
    _, dropped_passes = judge_offload_arms(arms["in_memory"],
                                           {"dropped_push": dropped})
    probe = {u: native_probe_rejects(nat, OffloadedState, u)
             for u in ("default", "sgd")}
    launched = judge_launches(counts, None, SMALL["n_layers"],
                              MOE_MESH_STEPS)
    ok = (round_trip and same and not dropped_passes
          and all(probe.values()) and launched)
    emit({"phase": "native", "check": "offload", "ok": ok,
          "config": SMALL, "batch": SMALL_BATCH, "seq": SMALL_SEQ,
          "updater": "momentum", "steps": MOE_MESH_STEPS,
          "state_elements": n, "state_bytes": 4 * n,
          "bridge_round_trip_bitwise": round_trip, "bridge_init_s": init_s,
          "bridge_push_prefetch_wait_s": round_s,
          "bitwise_equal": verdict,
          "losses": {k: a[0] for k, a in arms.items()},
          "step_s": {k: a[1] for k, a in arms.items()},
          "steps_2_3_s": {k: a[1][1:] for k, a in arms.items()},
          "bridge_p50_s": {k: a[5] for k, a in arms.items() if a[5]},
          "planted": {"dropped_push_passes": dropped_passes,
                      "dropped_push_losses": dropped[0],
                      "non_assign_probe_raises": probe},
          "launch_counts": counts, "card": card})
    if not ok:
        raise AssertionError(
            f"native offload failed: round trip {round_trip}, arms "
            f"{verdict}, dropped push passes {dropped_passes}, probe "
            f"{probe}, launches {counts}")

    lr = spawn_native_workers("lr_native_worker.py", NATIVE_LR["procs"],
                              "NATIVE_LR_OK",
                              (NATIVE_LR["steps"], NATIVE_LR["batch"]))
    w2v = {pf: spawn_native_workers(
        "w2v_native_worker.py", NATIVE_W2V["procs"], "NATIVE_W2V_OK",
        (NATIVE_W2V["steps"], NATIVE_W2V["batch"], pf)) for pf in (1, 0)}
    serve = spawn_native_workers("serve_bench_worker.py", NATIVE_SERVE_PROCS,
                                 "SERVE_BENCH_OK")
    lr_rate = (NATIVE_LR["procs"] * NATIVE_LR["steps"] * NATIVE_LR["batch"]
               / native_wall(lr))
    w2v_rate = (NATIVE_W2V["procs"] * NATIVE_W2V["steps"]
                * NATIVE_W2V["batch"] / native_wall(w2v[1]))
    losses = [float(re.search(r"loss=([0-9.]+)", o).group(1)) for o in lr]
    served = serve_numbers(serve[0])
    emit({"phase": "native", "check": "workers", "ok": True,
          "host_cpus": os.cpu_count(), "lr": NATIVE_LR, "w2v": NATIVE_W2V,
          "blas_threads_per_rank": {
              "lr": blas_threads(NATIVE_LR["procs"]),
              "w2v": blas_threads(NATIVE_W2V["procs"]),
              "serve": blas_threads(NATIVE_SERVE_PROCS)},
          "lr_native8_samples_per_sec": lr_rate,
          "lr_native8_final_losses": losses,
          "w2v_native8_pairs_per_sec": w2v_rate,
          "w2v_native8_prefetch_speedup": native_wall(w2v[0])
          / native_wall(w2v[1]),
          **native_ratios(lr_fused, w2v_fused, lr_rate, w2v_rate),
          "lr_fused_samples_per_sec": lr_fused,
          "w2v_fused_pairs_per_sec": w2v_fused,
          **served, "serve_cached_vs_cold_p50_acceptance": SERVE_ACCEPT,
          "card": card})
    return counts


# ------------------------------------------------------- the serve phase

# bench.py's sizes for the serve tier, the JAX package's full width for
# these planes: bench_serve_fanin (:586; 1,000 clients, inflight 8, on
# epoll and on uring where the probe says yes), bench_tail (:626; 10,000),
# bench_ops (:679), bench_latency (:705) and bench_audit (:738) at 1,000,
# bench_health (:863; 256), bench_failover (:767; the worker's defaults),
# bench_skew (:803; clients x rows x requests) and bench_capacity (:832).
SERVE = dict(fanin=1000, tail=10000, ops=1000, latency=1000, audit=1000,
             health=256, skew=(1000, 2048, 2048), capacity=(256, 2048, 512))
SERVE_INFLIGHT = 8        # -server_inflight_max of every run but tail's (0)
# The JAX package's demo drivers' sizes: tools/fanin_demo.py (256 clients
# at inflight 1, the chaos adds), tools/skew_demo.py (64 x 2,048 x 256,
# the NaN add) and tools/capacity_demo.py (3 ranks, 64 x 2,048 x 192,
# demo on).
SERVE_DEMO = dict(fanin=(256, 1), skew=(64, 2048, 256),
                  capacity=(3, 64, 2048, 192))
# The acceptance bars bench.py's docstrings name for the recorded keys:
# printed beside each reading, not gated (host-noise figures).
SERVE_BARS = {"ops_overhead_pct": "< 1", "ops_scrape_p99_ms": "< 5",
              "audit_overhead_pct": "< 1", "health_overhead_pct": "< 1",
              "hotkey_track_overhead_pct": "< 2",
              "capacity_overhead_pct": "< 1", "repl_overhead_pct": "< 3",
              "latency_profiler_overhead_pct": "< 1",
              "tail_qos_isolation": "< 2", "tail_overhead_pct": "< 1",
              "health_alert_detect_ms": "< 2000"}
AUDIT_DUPS = 2            # audit_demo_worker.DUP_ADDS
LATENCY_STAGES = ("queue", "wire_out", "mailbox", "apply", "reactor",
                  "wire_back")


def worker_keys(outs) -> dict:
    """The ``key=value`` numbers of the ranks' report lines (those naming
    ``rank=<n>``); where two ranks print one key, the first rank's."""
    keys = {}
    for out in outs:
        for line in out.splitlines():
            if not re.search(r"\brank=\d", line):
                continue
            for m in re.finditer(r"(\w+)=(-?\d+(?:\.\d+)?)(?![\w.])", line):
                if m.group(1) != "rank":
                    keys.setdefault(m.group(1), float(m.group(2)))
    return keys


def bench_names(keys, prefix, keep=()) -> dict:
    """bench.py's names for a worker's keys: ``prefix`` before each key
    that does not already start with one of ``keep``."""
    return {(k if k.startswith(keep) else prefix + k): v
            for k, v in keys.items()}


def read_json(path):
    """The JSON document at ``path``, or None when there is none."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def judge_fanin(keys, clients, demo=False):
    """({check: verdict}, all pass) of a fan-in run: every anonymous
    connection accepted and served; in the demo's run
    (tools/fanin_demo.py: inflight 1, the chaos adds) the overload burst
    shed and every faulted add landed exactly once (the worker asserts
    the table's final value; ``adds_ok`` is its receipt).  At bench.py's
    inflight 8 the shed is recorded, not judged: the card's host shed 1
    to 221 of 1,000 bursts' requests over 12 runs."""
    checks = {"accepted": keys.get("accepted") == clients,
              "clients": keys.get("clients") == clients}
    if demo:
        checks.update(shed=keys.get("shed_rate", 0.0) > 0.0,
                      adds_ok=keys.get("adds_ok") == 1.0)
    return checks, all(checks.values())


def judge_failover(keys):
    """Failover (tools/failover_demo.py): no acked add lost, the backup
    promoted, and the promotion within 10 s of the blackout."""
    promote = keys.get("failover_promote_ms", math.inf)
    checks = {"lost_acked_adds": keys.get("failover_lost_acked_adds") == 0,
              "promoted": keys.get("promotions", 0.0) >= 1,
              "promote_ms": math.isfinite(promote) and 0 <= promote < 1e4}
    return checks, all(checks.values())


def judge_serve_plane(mode, keys):
    """The fan-in worker's plane modes: the audit plane names its
    injected duplicate, the health plane's alert fires under the seeded
    apply delay, the latency plane's stages add up to >= 0.85 of the end
    to end, the ops scrape ran under load, the tail herd ran."""
    checks = {
        "audit": {"dup_named": keys.get("audit_detect_ms", -1) >= 0},
        "health": {"alert_fired": keys.get("health_alert_fired") == 1.0},
        "latency": {"stage_sum_ratio": keys.get("stage_sum_ratio", 0.0)
                    >= 0.85},
        "ops": {"scraped": keys.get("ops_scrapes", 0.0) > 0},
        "tail": {"herd": keys.get("clients", 0.0) > 0},
    }[mode]
    return checks, all(checks.values())


def judge_skew(keys, box=None, nan=False):
    """Skew (tools/skew_demo.py): every planted hot key in the top-K, the
    zipf skew ratio over 3x the uniform control's, observed-staleness
    samples recorded; with ``nan`` the NaN add dumped the black box
    naming its table."""
    checks = {"hot_keys": 0 < keys.get("hot_expected", 0.0)
              == keys.get("hot_hits"),
              "skew_ratio": keys.get("skew_ratio_zipf", 0.0)
              > 3.0 * keys.get("skew_ratio_uniform", math.inf),
              "staleness": keys.get("staleness_count", 0.0) > 0}
    if nan:
        reason = (box or {}).get("reason", "")
        checks["nan_blackbox"] = (
            reason.startswith("nan_update: table")
            and f"table {int(keys.get('nan_table', -1))}" in reason)
    return checks, all(checks.values())


def judge_capacity(keys, demo=False):
    """Capacity (tools/capacity_demo.py): the scraped byte books within
    10% of the ground truth, the advisor's projected spread <= 2x; in the
    demo the KV table's bucket bytes and the herd's bucket load skewed
    over 2x, and rank 0's RSS and arena gauges moved by the big table."""
    checks = {"bytes_accuracy": 0.9 <= keys.get("capacity_bytes_accuracy",
                                                0.0) <= 1.1,
              "kv_accuracy": 0.9 <= keys.get("capacity_kv_accuracy",
                                             0.0) <= 1.1,
              "mvplan_spread": keys.get("mvplan_spread_after",
                                        math.inf) <= 2.0}
    if demo:
        checks.update(
            bytes_skew=keys.get("demo_bytes_skew", 0.0) > 2.0,
            load_skew=keys.get("demo_load_skew", 0.0) > 2.0,
            rss_moved=keys.get("demo_rss_delta", 0.0) > 1e6,
            arena_moved=keys.get("demo_arena_delta", 0.0) >= 1 << 20)
    return checks, all(checks.values())


def judge_audit(mode, findings, outs, box=None):
    """The audit demo's modes (tools/audit_demo.py): ``chaos`` names
    exactly the injected duplicates and no loss, gap or unacked stream;
    ``loss`` names a gap, no loss, the never-acked async tail, and fires
    the ``audit_gap`` black box; ``plain`` converges with the plane
    disarmed (the worker asserts both)."""
    kinds = [f["kind"] for f in findings]
    if mode == "chaos":
        checks = {"adds_exact": "CHAOS_ADDS_OK" in outs[1],
                  "no_loss_gap_unacked": not {"lost", "gap",
                                              "unacked"} & set(kinds),
                  "dups_named": sum(f["count"] for f in findings
                                    if f["kind"] == "dup") == AUDIT_DUPS}
    elif mode == "loss":
        checks = {"gap": "gap" in kinds, "no_loss": "lost" not in kinds,
                  "unacked_tail": "unacked" in kinds,
                  "blackbox": "audit_gap" in (box or {}).get("reason", "")}
    else:
        checks = {"plain_converged_disarmed": "PLAIN_OK" in outs[1]}
    return checks, all(checks.values())


def judge_ops_demo(facts):
    """The ops demo (tools/ops_demo.py): both ranks up and labeled in the
    fleet scrape, exemplar trace ids present, the injected barrier
    timeout's black box with spans, and the box's and the exemplars'
    trace ids found in the merged Chrome trace."""
    checks = {"ranks_up": facts["ranks"] == ["0", "1"]
              and facts["silent"] == [] and facts["rank_up"] == [1.0, 1.0]
              and min(facts["labeled_series"]) > 0,
              "exemplars": facts["exemplar_ids"] > 0,
              "barrier_timeout_blackbox": facts["blackbox_reason"]
              .startswith("barrier_timeout") and facts["blackbox_spans"] > 0,
              "box_ids_in_trace": facts["shared_trace_ids"] > 0,
              "exemplars_in_trace": facts["resolved_exemplars"] > 0}
    return checks, all(checks.values())


def judge_latency_demo(facts):
    """The latency demo (tools/latency_demo.py:96-128): timed probes'
    stages within 10% of their end to end, every stage populated on both
    ranks with clock offsets and the profiler running, ``apply`` the
    dominant stage under the seeded apply delay, and the p99 exemplar in
    the merged trace.  The profiler's flame spans there are reported, not
    judged: the idle ranks' CPU-time sampler took none in 1 of 10 runs on
    an 8-core host."""
    checks = {"stage_sums": 0.9 <= facts["stage_sum_ratio"] <= 1.1,
              "stages_populated": facts["stages_populated"],
              "dominant_apply": facts["dominant_stage"] == "apply",
              "exemplar_in_trace": facts["exemplar_in_trace"]}
    return checks, all(checks.values())


def judge_doctor_demo(facts):
    """The doctor demo (tools/doctor_demo.py): a healthy fleet armed with
    nothing firing; rank 1's burn-rate alert firing under the seeded
    apply delay; the alert resolved once the fault is cleared."""
    checks = {"healthy_quiet": facts["healthy_armed"]
              and facts["healthy_firing"] == 0,
              "fault_fires": facts["fault_state"] == "firing",
              "clear_resolves": facts["cleared_state"] == "ok"
              and facts["resolved"] >= 1}
    return checks, all(checks.values())


# ------------------------------------------- the port's operator CLIs

PORT_TOOLS = os.path.join(HERE, "multiverso_tpu_torch", "tools")
TOOL_TIMEOUT_S = 120
# The doctor demo's shutdown wall clock, from "quit" to every rank's
# exit: a rank whose shutdown waits out a departed peer's reconnect
# budget (-connect_retry_ms on each of 3 attempts) takes 45 s more.
DOCTOR_SHUTDOWN_S = 10.0
# A child that runs one of the port's CLIs as an operator would: the
# script by its path (its own header puts the checkout on the path),
# with ``jax`` and the JAX package not importable.  It executes the
# script's body, imports included, says so on stderr, and calls its
# ``main`` with the arguments once a line arrives on stdin, as the
# script's ``__main__`` clause would.
_TOOL_CHILD = ("import runpy, sys\n"
               "sys.modules['jax'] = None\n"
               "sys.modules['multiverso_tpu'] = None\n"
               "sys.argv = sys.argv[1:]\n"
               "tool = runpy.run_path(sys.argv[0], run_name='mvt_tool')\n"
               "print('TOOL_READY', file=sys.stderr, flush=True)\n"
               "sys.stdin.readline()\n"
               "sys.exit(tool['main'](sys.argv[1:]))\n")
# The mvtop view of each ops report kind (mvtop's KIND_VIEWS), as flags.
MVTOP_VIEWS = {"metrics": ("--metrics",), "health": (), "tables": (),
               "hotkeys": ("--hotkeys",), "latency": ("--qos",),
               "audit": ("--audit",), "replication": ("--replication",),
               "capacity": ("--capacity",), "alerts": ("--alerts",)}


class Tool:
    """The port's CLI ``multiverso_tpu_torch/tools/<name>.py`` in a child
    started at once, from a scratch directory with ``JAX_PLATFORMS`` and
    ``PYTHONPATH`` unset and no ``jax`` importable.  The child imports
    the CLI (most of its start: torch) and waits; ``go`` runs it and
    ``finish`` returns its exit code and output.  A scrape whose moment
    matters (a burn-rate alert un-fires within seconds of its traffic)
    is taken on ``go``, not seconds of imports later."""

    def __init__(self, name, *args):
        import tempfile

        self.name, self.args = name, [str(a) for a in args]
        self._cwd = tempfile.TemporaryDirectory(prefix="mvt_tool_")
        env = {k: v for k, v in os.environ.items()
               if k not in ("JAX_PLATFORMS", "PYTHONPATH")}
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _TOOL_CHILD,
             os.path.join(PORT_TOOLS, f"{name}.py"), *self.args],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=self._cwd.name, env=env)
        self._err, self._went = [], False

    def ready(self):
        """Wait until the child has imported the CLI (or ended)."""
        if self._went:
            return
        for line in self.proc.stderr:
            if line.strip() == "TOOL_READY":
                return
            self._err.append(line)

    def go(self):
        self.proc.stdin.write("go\n")
        self.proc.stdin.flush()
        self._went = True

    def finish(self, timeout=TOOL_TIMEOUT_S):
        went, self._went = self._went, True
        try:
            out, err = self.proc.communicate(None if went else "go\n",
                                             timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.communicate()
            raise RuntimeError(f"{self.name} {self.args} still running "
                               f"after {timeout} s") from None
        finally:
            self._cwd.cleanup()
        err = "".join(self._err) + err.replace("TOOL_READY\n", "")
        return {"tool": self.name, "args": self.args,
                "rc": self.proc.returncode, "out": out, "err": err[-2000:]}

    def close(self):
        """Stop the child if it is still waiting or running."""
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()
        self._cwd.cleanup()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ScrapeReplay:
    """A loopback endpoint answering the anonymous ops wire's OpsQuery
    with reports captured from a fleet (``reports``: ``{kind: text}``,
    which may be filled in after the endpoint is handed out), so the
    CLIs read a one-shot fleet's scrape through the wire exactly as they
    read a live rank.  Serves one connection at a time until ``close``."""

    def __init__(self, reports):
        import socket
        import threading

        self.reports = reports
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.endpoint = "127.0.0.1:%d" % self.sock.getsockname()[1]
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        from multiverso_tpu_torch.serve import wire

        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            with conn, contextlib.suppress(OSError):   # a client gone
                frames = wire.FrameDecoder()
                while True:
                    frame = frames.next_frame()
                    if frame is None:
                        chunk = conn.recv(65536)
                        if not chunk:
                            break
                        frames.feed(chunk)
                        continue
                    q = wire.unpack_frame(frame)
                    kind = q["blobs"][0].decode() if q["blobs"] else ""
                    text = self.reports.get(kind, "{}")
                    conn.sendall(wire.pack_frame(
                        wire.MSG["OpsReply"], -1, q["msg_id"],
                        blobs=[text.encode()]))

    def close(self):
        import socket

        # A listening socket's close alone does not wake its accept.
        with contextlib.suppress(OSError):
            self.sock.shutdown(socket.SHUT_RDWR)
        self.sock.close()
        self._thread.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


_NAMED = re.compile(r"^(SILENT|LOST|GAP|DUP|REORDER|UNACKED"
                    r"|PENDING_DROPPED)\b"
                    r"(?: table (\S+) origin (\S+) shard (\S+))?"
                    r"(?: x(\d+))?")


def audit_named(text):
    """mvaudit's named findings, ``(kind, table, origin, shard, count)``
    each, from its text (``ops.audit.render_findings``' lines)."""
    out = []
    for line in text.splitlines():
        m = _NAMED.match(line)
        if m:
            out.append((m.group(1).lower(), *m.group(2, 3, 4),
                        int(m.group(5) or 0)))
    return out


def findings_named(findings):
    """``audit_named``'s tuples of ``ops.audit.diff_fleet``'s findings."""
    return [(f["kind"], *(str(f[k]) if k in f and "table" in f else None
                          for k in ("table", "origin", "shard")),
             int(f.get("count", 0))) for f in findings]


def judge_mvaudit(mode, run, findings):
    """mvaudit over a fleet's audit books beside ``ops.audit.diff_fleet``'s
    ``findings`` over the same fleet: in the audit demo's ``chaos`` mode it
    names exactly the planted duplicates that diff does, no loss or gap,
    and exits 0 (duplicates are tolerated without ``--strict``); in
    ``loss`` mode it names the gap and exits 1; on failover's survivor
    (mode ``settle``) it exits 0 with no lost acked add and no gap, the
    verdict of diff over a scrape of its own."""
    named = audit_named(run["out"])
    kinds = [n[0] for n in named]
    if mode == "chaos":
        dups = [n for n in named if n[0] == "dup"]
        checks = {"exit_0": run["rc"] == 0,
                  "dups_named": sum(n[4] for n in dups) == AUDIT_DUPS,
                  "same_dups_as_diff": dups == [
                      n for n in findings_named(findings) if n[0] == "dup"],
                  "no_loss_gap": not {"lost", "gap"} & set(kinds)}
    elif mode == "loss":
        checks = {"exit_1": run["rc"] == 1, "gap_named": "gap" in kinds,
                  "no_loss": "lost" not in kinds}
    else:
        bad = {"lost", "gap"}
        checks = {"exit_0": run["rc"] == 0,
                  "zero_lost": "lost" not in kinds
                  and "mvaudit @" in run["out"],
                  "verdict_as_diff": (not bad & set(kinds)) == (
                      not bad & {f["kind"] for f in findings})}
    return checks, all(checks.values())


def table_rows(text, first="rank"):
    """The rows of a table mvtop rendered (``mvtop.render``): a dict per
    row keyed by the header's columns, split on whitespace (a cell with
    a space, as the hotkey view's top keys, runs into the last column)."""
    lines = text.splitlines()
    for i, line in enumerate(lines):
        cols = line.split()
        if cols[:1] == [first]:
            rows = []
            for body in lines[i + 1:]:
                cells = body.split()
                if cells:
                    rows.append(dict(zip(cols, cells)))
            return rows
    return []


def judge_mvtop_views(runs, ranks=("0", "1")):
    """mvtop over a fleet, one run per ops report kind (``MVTOP_VIEWS``):
    each exits 0 and renders a row for every rank (the metrics view
    every rank's labeled series).  A fleet with no health rules armed
    (the ops demo's) has no alert to list: there the alerts view must
    render its table with no ``unknown`` row, the row of a rank that did
    not answer."""
    checks = {}
    for kind, run in runs.items():
        rows = table_rows(run["out"])
        if kind == "metrics":
            seen = {r for r in ranks if f'rank="{r}"' in run["out"]}
        else:
            seen = {row.get("rank") for row in rows}
        ok = run["rc"] == 0 and set(ranks) <= seen
        if kind == "alerts" and not rows:
            ok = (run["rc"] == 0 and "— 0 alert(s), 0 firing" in run["out"]
                  and "rank  rule" in run["out"])
        checks[kind] = ok
    return checks, bool(checks) and all(checks.values())


def judge_mvtop_alerts(run, firing=("1", "lat-slo-burn")):
    """``mvtop --alerts --fleet`` over the doctor demo's fleet under its
    seeded delay: exits 0, lists both ranks' rules, and shows rank 1's
    latency burn rule firing."""
    rows = table_rows(run["out"])
    checks = {"exit_0": run["rc"] == 0,
              "both_ranks": {r.get("rank") for r in rows} >= {"0", "1"},
              "burn_firing": any((r.get("rank"), r.get("rule"),
                                  r.get("state")) == (*firing, "firing")
                                 for r in rows)}
    return checks, all(checks.values())


def judge_mvtop_replication(run, promoted="2", shard="1"):
    """``mvtop --replication --fleet`` on a survivor after failover
    (tools/failover_demo.py (f)): exits 0, the backup rank shows the
    promoted shard, and its routing epoch is raised."""
    rows = {r.get("rank"): r for r in table_rows(run["out"])}
    row = rows.get(promoted) or {}
    epoch = row.get("epoch", "")
    checks = {"exit_0": run["rc"] == 0,
              "promoted_shown": row.get("promoted") == shard,
              "epoch_raised": epoch.isdigit() and int(epoch) > 0}
    return checks, all(checks.values())


def latdoctor_ranks(text):
    """latdoctor's text per rank: the stage rows it printed and its
    ``dominant p99 stage``."""
    ranks, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"rank (\S+) \(timing", line)
        if m:
            cur = ranks.setdefault(m.group(1), {"stages": [],
                                                "dominant_p99": None})
            continue
        if cur is None:
            continue
        m = re.match(r"  (\w+)\s+-?[\d.]+ms\s+-?[\d.]+ms\s+-?[\d.]+ms"
                     r"\s+\d+$", line)
        if m and m.group(1) != "total":
            cur["stages"].append(m.group(1))
        m = re.match(r"  dominant p99 stage = (\w+) ", line)
        if m:
            cur["dominant_p99"] = m.group(1)
    return ranks


def judge_latdoctor(run, ranks=("0", "1"), gate_apply=False):
    """``latdoctor --fleet`` over the latency demo's fleet under its delay
    (tools/latency_demo.py:129-139): exits 0, a row for each of the six
    stages on every rank, and a ``dominant p99 stage`` line on each;
    with ``gate_apply``, rank 1's (the delayed traffic's) names
    ``apply``.  The serve phase gates it on the card's host, where it
    held in 10 of 10 runs; on a loaded CPU the whole run's largest p99
    named a wire stage in 4 of 10."""
    got = latdoctor_ranks(run["out"])
    checks = {"exit_0": run["rc"] == 0,
              "ranks": sorted(got) == sorted(ranks),
              "six_stages_each": all(
                  set(LATENCY_STAGES) <= set(got.get(r, {}).get("stages", ()))
                  for r in ranks),
              "dominant_p99_line": all(
                  got.get(r, {}).get("dominant_p99") for r in ranks)}
    if gate_apply:
        checks["rank_1_dominant_p99_apply"] = (
            got.get("1", {}).get("dominant_p99") == "apply")
    return checks, all(checks.values())


def judge_doctor_cli(facts, shutdown_s=DOCTOR_SHUTDOWN_S,
                     gate_apply=False):
    """mvdoctor over the doctor demo's fleet (tools/doctor_demo.py:106-165):
    ``--fleet --strict`` exits 0 on the quiet fleet; under the seeded
    apply delay the plain run exits 0 with its top finding
    ``[critical] rank 1: latency SLO burn`` and ``--strict`` exits 1;
    after the alert resolves ``--strict`` exits 0.  The fleet's shutdown
    ends inside ``shutdown_s``.  With ``gate_apply`` the top finding also
    names ``'apply'``, the latency plane's whole-run dominant p99 stage:
    the serve phase gates it on the card's host, where it held in 10 of
    10 runs; on a loaded CPU a wire stage outweighs it in some runs.
    Beside the doctor under the delay, ``mvtop --alerts --fleet``
    (``judge_mvtop_alerts``)."""
    runs = facts["cli"]
    head = (runs["fault"]["out"].splitlines() or [""])[0]
    checks = {"quiet_strict_exit_0": runs["quiet_strict"]["rc"] == 0,
              "fault_exit_0": runs["fault"]["rc"] == 0,
              "top_critical_rank_1": re.search(
                  r"\[critical\] rank 1:", head) is not None,
              "top_latency_slo_burn": "latency SLO burn" in head,
              "fault_strict_exit_1": runs["fault_strict"]["rc"] == 1,
              "cleared_strict_exit_0": runs["cleared_strict"]["rc"] == 0,
              "shutdown_wall": facts["shutdown_s"] < shutdown_s}
    if gate_apply:
        checks["top_names_apply"] = "'apply'" in head
    alerts, _ = judge_mvtop_alerts(runs["mvtop_alerts"])
    checks.update({f"mvtop_alerts_{k}": v for k, v in alerts.items()})
    return checks, all(checks.values())


class Fleet:
    """The ranks of an interactive worker (``apps/<script>``), which print
    ``ready`` and then serve commands on stdin.  A reader thread a rank
    queues its output lines, so every wait has a deadline; a start whose
    ranks lost a port to another process is retried on fresh ports."""

    def __init__(self, script, procs, ready, extra_args=(),
                 timeout=NATIVE_TIMEOUT_S):
        import tempfile

        self.script = script
        worker = os.path.join(HERE, "multiverso_tpu_torch", "apps", script)
        for attempt in range(NATIVE_ATTEMPTS):
            self._tmp = tempfile.TemporaryDirectory(prefix="mvt_serve_")
            mf, self.eps = machine_file(self._tmp.name, procs)
            self.procs = [subprocess.Popen(
                [sys.executable, worker, mf, str(r), *map(str, extra_args)],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
                env=worker_env(procs)) for r in range(procs)]
            self._start_readers()
            try:
                for r in range(procs):
                    self.expect(r, ready, timeout)
                return
            except RuntimeError:
                raced = any(m in "".join(seen) for seen in self.seen
                            for m in NATIVE_BIND_RACE)
                self.close()
                if not raced or attempt == NATIVE_ATTEMPTS - 1:
                    raise

    def _start_readers(self):
        import queue
        import threading

        self.queues = [queue.Queue() for _ in self.procs]
        self.seen = [[] for _ in self.procs]

        def read(p, q):
            for line in p.stdout:
                q.put(line)
            q.put(None)

        self._readers = [threading.Thread(target=read, args=(p, q),
                                          daemon=True)
                         for p, q in zip(self.procs, self.queues)]
        for t in self._readers:
            t.start()

    def expect(self, r, marker, timeout=120):
        """The first line of rank ``r``'s output holding ``marker``."""
        import queue

        deadline = time.monotonic() + timeout
        while True:
            left = deadline - time.monotonic()
            try:
                line = self.queues[r].get(timeout=max(left, 0.01))
            except queue.Empty:
                line = None
                left = 0
            if line is None:
                tail = "".join(self.seen[r])[-2000:]
                why = "timed out" if left <= 0 else "ended"
                raise RuntimeError(f"{self.script} rank {r} {why} before "
                                   f"{marker!r}:\n{tail}")
            self.seen[r].append(line)
            if marker in line:
                return line

    def send(self, r, cmd):
        self.procs[r].stdin.write(cmd + "\n")
        self.procs[r].stdin.flush()

    def command(self, r, cmd, marker, timeout=120):
        self.send(r, cmd)
        return self.expect(r, marker, timeout)

    def finish(self, marker, timeout=NATIVE_TIMEOUT_S, exempt=()):
        """Every rank's whole output once all have exited, each but those
        in ``exempt`` required to exit 0 holding ``marker(rank)``."""
        deadline = time.monotonic() + timeout
        outs = []
        for r, (p, t) in enumerate(zip(self.procs, self._readers)):
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            t.join(timeout=10)
            while not self.queues[r].empty():
                line = self.queues[r].get()
                if line is not None:
                    self.seen[r].append(line)
            outs.append("".join(self.seen[r]))
            if r in exempt:
                continue
            if p.returncode != 0 or marker(r) not in outs[-1]:
                raise RuntimeError(f"{self.script} rank {r} failed "
                                   f"(rc={p.returncode}):\n"
                                   f"{outs[-1][-2000:]}")
        return outs

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            for f in (p.stdin, p.stdout):
                with contextlib.suppress(OSError):
                    f.close()
        self._tmp.cleanup()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def serve_fanin(clients, inflight, chaos=0, mode="", engine="epoll",
                timeout=NATIVE_TIMEOUT_S):
    """One 2-rank run of the fan-in worker: its keys and the outputs."""
    outs = spawn_native_workers(
        "fanin_bench_worker.py", 2, "FANIN_BENCH_OK",
        (clients, inflight, chaos, mode, engine), timeout=timeout)
    return worker_keys(outs), outs


def serve_failover(timeout=NATIVE_TIMEOUT_S):
    """The 3-rank replicated fleet whose rank 1 SIGKILLs itself."""
    return worker_keys(spawn_native_workers(
        "failover_bench_worker.py", 3, "FAILOVER_BENCH_OK", (),
        timeout=timeout, exempt_ranks=(1,)))


def serve_skew(clients, rows, reqs, nan=0, timeout=NATIVE_TIMEOUT_S):
    """The skew worker on 2 ranks: its keys and, with ``nan``, rank 0's
    black box."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="mvt_skew_") as tmp:
        outs = spawn_native_workers(
            "skew_bench_worker.py", 2, "SKEW_BENCH_OK",
            (clients, rows, reqs, nan), timeout=timeout,
            env={"MVTPU_SKEW_TRACE_DIR": tmp})
        return worker_keys(outs), read_json(
            os.path.join(tmp, "blackbox_rank0.json"))


def serve_capacity(ranks, clients, rows, reqs, demo=0,
                   timeout=NATIVE_TIMEOUT_S):
    """The capacity worker's keys (the last rank drives the herd)."""
    return worker_keys(spawn_native_workers(
        "capacity_bench_worker.py", ranks, "CAPACITY_BENCH_OK",
        (clients, rows, reqs, demo), timeout=timeout))


def serve_audit(mode, extra=(), timeout=NATIVE_TIMEOUT_S):
    """The audit demo worker's ``mode`` on 2 ranks: the port's auditor's
    findings over rank 0's fleet books, the outputs, rank 0's black box."""
    import tempfile

    from multiverso_tpu_torch.ops.audit import diff_fleet

    with tempfile.TemporaryDirectory(prefix="mvt_audit_") as tmp:
        outs = spawn_native_workers(
            "audit_demo_worker.py", 2, "AUDIT_DEMO_WORKER_OK",
            (mode, tmp, *extra), timeout=timeout)
        box = read_json(os.path.join(tmp, "blackbox_rank0.json"))
    return diff_fleet(json.loads(audit_fleet_text(outs))), outs, box


def audit_fleet_text(outs):
    """The fleet ``"audit"`` report the audit demo's rank 0 printed."""
    line = next(ln for ln in outs[0].splitlines()
                if ln.startswith("AUDIT_FLEET "))
    return line[len("AUDIT_FLEET "):]


def serve_audit_cli(mode, extra=(), timeout=NATIVE_TIMEOUT_S):
    """``serve_audit`` and mvaudit (fleet scope, its default) over the
    fleet's books, served by a ``ScrapeReplay``: the demo's fleet exits
    as soon as rank 0 has printed them.  The CLI child imports while the
    fleet runs."""
    with ScrapeReplay({}) as replay, Tool("mvaudit", replay.endpoint) as tool:
        findings, outs, box = serve_audit(mode, extra, timeout)
        replay.reports = {"audit": audit_fleet_text(outs)}
        return findings, outs, box, tool.finish()


def trace_ids(trace_dir):
    """The merged Chrome trace of ``trace_dir``: its trace ids and its
    events."""
    from multiverso_tpu_torch import tracing

    with open(tracing.merge_dir(trace_dir)) as f:
        events = json.load(f)["traceEvents"]
    ids = {e.get("args", {}).get("trace_id") for e in events} - {None}
    return ids, events


def serve_ops_demo(timeout=NATIVE_TIMEOUT_S):
    """tools/ops_demo.py's steps with the port's modules: a fleet scrape
    of the held 2-rank fleet and the port's ``mvtop --fleet`` in each of
    its views, then the injected barrier timeout."""
    import tempfile

    from multiverso_tpu_torch.ops.introspect import OpsClient

    with tempfile.TemporaryDirectory(prefix="mvt_ops_") as traces:
        with contextlib.ExitStack() as stack:
            fleet = stack.enter_context(Fleet(
                "ops_demo_worker.py", 2, "OPS_READY", (traces,), timeout))
            tools = {kind: stack.enter_context(
                Tool("mvtop", fleet.eps[0], "--fleet", *flags))
                for kind, flags in MVTOP_VIEWS.items()}
            with OpsClient(fleet.eps[0], timeout=15) as c:
                health = c.health(fleet=True)
                values, exemplars = c.metrics(fleet=True)
            # One view at a time: a rank aggregates at most
            # -ops_inflight_max (4) fleet queries at once and answers the
            # rest with a busy document, which renders no rows.
            views = {}
            for kind, t in tools.items():
                t.go()
                views[kind] = t.finish()
            for r in range(2):
                fleet.send(r, "")
            outs = fleet.finish(lambda r: f"OPS_WORKER_OK {r}", timeout)
        box = read_json(os.path.join(traces, "blackbox_rank0.json")) or {}
        ids, _ = trace_ids(traces)
    exemplar_ids = {ex["trace_id"] for ex in exemplars.values()
                    if "trace_id" in ex}
    box_ids = {s["trace_id"] for s in box.get("spans", [])} - {"0x0"}
    return {"ranks": sorted(health["ranks"]), "silent": health["silent"],
            "rank_up": [values.get(f'mv_ops_rank_up{{rank="{r}"}}')
                        for r in range(2)],
            "labeled_series": [sum(f'rank="{r}"' in k for k in values)
                               for r in range(2)],
            "exemplar_ids": len(exemplar_ids),
            "blackbox_dumped": "BLACKBOX_DUMPED" in outs[0],
            "blackbox_reason": box.get("reason", ""),
            "blackbox_spans": len(box.get("spans", [])),
            "shared_trace_ids": len(box_ids & ids),
            "resolved_exemplars": len(exemplar_ids & ids),
            "cli": {"mvtop": views}}


def serve_latency_demo(timeout=NATIVE_TIMEOUT_S):
    """tools/latency_demo.py's steps with the port's modules: 20 timed
    probes, the fleet latency report, a seeded 25 ms apply delay on rank
    0 and rank 1's traffic, then the merged trace.  The stage named under
    the delay is the one with the largest mean over that traffic (rank
    1's stage histograms' counts and sums, scraped before and after it);
    the port's ``latdoctor --fleet`` then reads the fleet, and its
    reading, the largest p99 over the whole run, is reported beside it:
    one slow request of the fleet's warm-up in a wire stage outweighs it
    on a loaded host."""
    import tempfile

    from multiverso_tpu_torch import latency
    from multiverso_tpu_torch.ops.introspect import OpsClient
    from multiverso_tpu_torch.serve import wire

    with tempfile.TemporaryDirectory(prefix="mvt_lat_") as traces:
        with contextlib.ExitStack() as stack:
            fleet = stack.enter_context(Fleet(
                "latency_demo_worker.py", 2, "LATD_READY", (traces,),
                timeout))
            tool = stack.enter_context(
                Tool("latdoctor", fleet.eps[0], "--fleet"))
            client = wire.AnonServeClient(fleet.eps[0], timeout=15,
                                          timing=True)
            ratios = []
            for _ in range(20):
                client.table_version(0)
                st = client.last_stages
                if st["total"] > 0:
                    ratios.append(sum(v for k, v in st.items()
                                      if k != "total") / st["total"])
            client.close()
            with OpsClient(fleet.eps[0], timeout=15) as c:
                before = c.latency(fleet=True)["ranks"]
            exemplar = (before["1"].get("total", {}).get("exemplar_p99")
                        or before["0"].get("total", {}).get("exemplar_p99"))
            fleet.command(0, "fault", "LATD_FAULT_ARMED")
            fleet.command(1, "traffic", "LATD_TRAFFIC_DONE")
            with OpsClient(fleet.eps[0], timeout=15) as c:
                after = c.latency(fleet=True)["ranks"]["1"]
            latdoctor = tool.finish()
            window = {s: (after["stages"][s]["sum_s"]
                          - before["1"]["stages"][s]["sum_s"]) * 1e3
                      / max(after["stages"][s]["count"]
                            - before["1"]["stages"][s]["count"], 1)
                      for s in LATENCY_STAGES}
            for r in range(2):
                fleet.send(r, "quit")
            fleet.finish(lambda r: f"LATD_OK {r}", timeout)
        ids, events = trace_ids(traces)
    populated = all(
        rep["armed"] and rep["offsets"] and rep["profiler"]["running"]
        and all(rep["stages"][s]["count"] > 0 for s in LATENCY_STAGES)
        for rep in (before.get("0"), before.get("1")) if rep) \
        and len(before) == 2
    return {"stage_sum_ratio": sum(ratios) / max(len(ratios), 1),
            "probes": len(ratios), "stages_populated": bool(populated),
            "dominant_stage": max(window, key=window.get),
            "stage_means_under_delay_ms": window,
            "dominant_p99_stage": latency.dominant_stage(after, "p99_ms"),
            "latdoctor_dominant_p99": {
                r: v["dominant_p99"] for r, v in
                latdoctor_ranks(latdoctor["out"]).items()},
            "exemplar": exemplar,
            "exemplar_in_trace": bool(exemplar) and exemplar in ids,
            "flame_spans": sum(e["name"].startswith("profile:")
                               for e in events),
            "cli": {"latdoctor": latdoctor}}


def serve_doctor_demo(timeout=NATIVE_TIMEOUT_S):
    """tools/doctor_demo.py's steps with the port's modules and its
    ``mvdoctor --fleet``: a healthy fleet's alerts and a quiet strict
    doctor, a seeded 25 ms apply delay on rank 0 under rank 1's probes
    with the doctor's top finding and its strict verdict, then the fault
    cleared until the alert resolves and the strict doctor once more.
    ``seconds`` is the wall clock from the fleet's start to every rank's
    exit, ``shutdown_s`` from "quit" to every rank's exit."""
    from multiverso_tpu_torch.apps.doctor_demo_worker import FLUSH_MS
    from multiverso_tpu_torch.ops.introspect import OpsClient

    flush = FLUSH_MS / 1e3
    t0 = time.perf_counter()

    def alerts(ep):
        with OpsClient(ep, timeout=15) as c:
            return c.alerts(fleet=True).get("ranks") or {}

    with contextlib.ExitStack() as stack:
        fleet = stack.enter_context(Fleet("doctor_demo_worker.py", 2,
                                          "DOC_READY", (), timeout))
        ep = fleet.eps[0]
        # Every CLI child imports while the fleet warms up; each scrapes
        # on ``go``, right after the traffic its step reads.
        tools = {}
        stack.callback(lambda: [t.close() for t in tools.values()])
        tools.update({"quiet_strict": Tool("mvdoctor", ep, "--fleet", "--strict"),
                 "fault": Tool("mvdoctor", ep, "--fleet"),
                 "mvtop_alerts": Tool("mvtop", ep, "--alerts", "--fleet"),
                 "fault_strict": Tool("mvdoctor", ep, "--fleet", "--strict"),
                 "cleared_strict": Tool("mvdoctor", ep, "--fleet",
                                        "--strict")})
        for r in range(2):
            fleet.command(r, "probe", "DOC_PROBE_DONE")
        time.sleep(2.5 * flush)
        hosts = [(rep or {}).get("host") or {}
                 for rep in alerts(ep).values()]
        facts = {"healthy_armed": len(hosts) == 2
                 and all(h.get("armed") for h in hosts),
                 "healthy_firing": sum(h.get("firing", 0) for h in hosts)}
        doc = {"quiet_strict": tools["quiet_strict"].finish()}
        for t in tools.values():
            t.ready()
        fleet.command(0, "fault", "DOC_FAULT_ARMED")
        fleet.command(1, "probe", "DOC_PROBE_DONE", timeout=180)
        time.sleep(2.0 * flush)
        tools["fault"].go()
        tools["mvtop_alerts"].go()
        host1 = (alerts(ep).get("1") or {}).get("host") or {}
        burn = [a for a in host1.get("alerts") or []
                if a["rule"] == "lat-slo-burn"]
        facts["fault_state"] = burn[0]["state"] if burn else None
        doc["fault"] = tools["fault"].finish()
        doc["mvtop_alerts"] = tools["mvtop_alerts"].finish()
        # A probe burst before the strict run keeps the burn windows hot
        # (the multiwindow rule un-fires once recent traffic stops
        # breaching), as the JAX package's driver does.
        fleet.command(1, "probe", "DOC_PROBE_DONE", timeout=180)
        time.sleep(2.0 * flush)
        doc["fault_strict"] = tools["fault_strict"].finish()
        fleet.command(0, "clear", "DOC_CLEARED")
        deadline = time.monotonic() + 30
        while True:
            fleet.command(1, "probe", "DOC_PROBE_DONE")
            line = fleet.command(1, "alerts", "DOC_ALERTS")
            local = json.loads(line.split("DOC_ALERTS ", 1)[1])
            a = next(x for x in local["alerts"] if x["rule"] == "lat-slo-burn")
            if (a["state"] == "ok" and a["resolved"] >= 1
                    or time.monotonic() > deadline):
                break
            time.sleep(flush)
        facts.update(cleared_state=a["state"], resolved=a["resolved"])
        doc["cleared_strict"] = tools["cleared_strict"].finish()
        t_quit = time.perf_counter()
        for r in range(2):
            fleet.send(r, "quit")
        fleet.finish(lambda r: f"DOC_OK {r}", timeout)
    t_end = time.perf_counter()
    head = (doc["fault"]["out"].splitlines() or [""])[0]
    facts.update(seconds=t_end - t0, shutdown_s=t_end - t_quit,
                 doctor_top=head,
                 doctor_top_names_apply="'apply'" in head, cli=doc)
    return facts


def serve_failover_demo(timeout=NATIVE_TIMEOUT_S, herd=12):
    """tools/failover_demo.py's steps with the port's modules and CLIs,
    over 3 replicated ranks of the port's interactive failover worker
    (``apps/failover_demo_worker.py``): an anonymous read herd on ranks
    0 and 2 while rank 1, shard 1's primary, is SIGKILLed; its backup
    (rank 2) sees the lease expire and promotes the shard, and rank 0
    adopts the route; the promoted shard's checksums equal the dead
    primary's last audited ones; re-routed adds and a barrier that
    excuses the corpse converge exactly; then, on the survivor rank 0,
    ``mvaudit --settle 0.5`` beside ``ops.audit.diff_fleet`` of the
    survivor's own fleet scrape, and ``mvtop --replication --fleet``."""
    import signal
    import threading

    from multiverso_tpu_torch.ops.audit import diff_fleet
    from multiverso_tpu_torch.serve.wire import AnonServeClient

    def reply(fleet, r, cmd, prefix):
        fleet.send(r, cmd)
        got = None
        while True:
            line = fleet.expect(r, "", timeout)
            if prefix and line.startswith(prefix):
                got = line[len(prefix):].strip()
            if line.startswith(f"OK {cmd.split()[0]}"):
                return got

    with contextlib.ExitStack() as stack:
        fleet = stack.enter_context(Fleet(
            "failover_demo_worker.py", 3, "FAILOVER_READY", (), timeout))
        audit_tool = stack.enter_context(
            Tool("mvaudit", fleet.eps[0], "--settle", "0.5"))
        repl_tool = stack.enter_context(
            Tool("mvtop", fleet.eps[0], "--replication", "--fleet"))
        stop = threading.Event()
        served = [0]

        def reader(ep):
            try:
                c = AnonServeClient(ep, timeout=10.0, timing=False)
                while not stop.is_set():
                    c.get_shard(0)
                    served[0] += 1
            except (ConnectionError, OSError):
                pass

        herds = [threading.Thread(target=reader, args=(fleet.eps[r],),
                                  daemon=True)
                 for r in (0, 2) for _ in range(herd // 2)]
        for t in herds:
            t.start()
        try:
            pre = json.loads(reply(fleet, 1, "sums", "SUMS "))
            t_kill = time.monotonic()
            fleet.procs[1].send_signal(signal.SIGKILL)
            fleet.procs[1].wait(timeout=30)
            dead = int(reply(fleet, 2, "waitdead 1", "DEAD "))
            t_detect = time.monotonic() - t_kill
            owner2 = reply(fleet, 2, "waitowner 1 2", "OWNER ")
            t_promote = time.monotonic() - t_kill
            owner0 = reply(fleet, 0, "waitowner 1 2", "OWNER ")
            post = json.loads(reply(fleet, 2, "sums", "SUMS "))
            for r in (0, 2):
                reply(fleet, r, "add 1", None)
            for r in (0, 2):
                fleet.send(r, "barrier")
            barriers = [fleet.expect(r, "BARRIER ", timeout).strip()
                        for r in (0, 2)]
            for r in (0, 2):
                fleet.expect(r, "OK barrier", timeout)
            values = json.loads(reply(fleet, 0, "get", "VALUES "))
        finally:
            stop.set()
            for t in herds:
                t.join(timeout=5)
        audit = audit_tool.finish()
        findings = diff_fleet(json.loads(
            reply(fleet, 0, "audit_fleet", "AUDIT_FLEET ")))
        repl = repl_tool.finish()
        for r in (0, 2):
            fleet.send(r, "done")
        fleet.finish(lambda r: f"FAILOVER_WORKER_OK {r}", timeout,
                     exempt=(1,))
    return {"dead_peers": dead, "detect_s": t_detect,
            "promote_s": t_promote, "owner_seen": [owner2, owner0],
            "beacons_match": post["backup_shard"] == 1
            and post["backup"] == pre["server"],
            "barriers": barriers, "array": values["array"],
            "herd_reads": served[0],
            "diff_kinds": sorted({f["kind"] for f in findings}),
            "diff": findings, "cli": {"mvaudit": audit, "mvtop": repl}}


def judge_failover_demo(facts):
    """tools/failover_demo.py's bars: the backup saw the death and shard
    1 routes to rank 2 on both survivors within 10 s, the promoted
    shard's beacons equal the dead primary's, both barriers pass with
    the corpse excused, the array exact (3 warm adds + 2), and the
    herd served reads across the kill."""
    checks = {"dead_seen": facts["dead_peers"] >= 1,
              "promoted": facts["owner_seen"] == ["1=2", "1=2"]
              and facts["promote_s"] < 10.0,
              "beacons_match": facts["beacons_match"],
              "barriers": facts["barriers"] == ["BARRIER ok"] * 2,
              "exact": bool(facts["array"])
              and all(v == 5.0 for v in facts["array"]),
              "herd_served": facts["herd_reads"] > 0}
    return checks, all(checks.values())


def judge_failover_cli(facts):
    """The failover demo's CLI steps: ``judge_mvaudit`` in mode
    ``settle`` and ``judge_mvtop_replication``."""
    checks = {}
    for name, (part, _) in (
            ("mvaudit", judge_mvaudit("settle", facts["cli"]["mvaudit"],
                                      facts["diff"])),
            ("mvtop", judge_mvtop_replication(facts["cli"]["mvtop"]))):
        checks.update({f"{name}_{k}": v for k, v in part.items()})
    return checks, all(checks.values())


LUA_SMOKE = """
package.path = package.path .. ";%s/?.lua"
local mv = require("multiverso")
mv.init({"-updater_type=default", "-log_level=error"})
local t = mv.ArrayTableHandler:new(8)
t:add({1, 1, 1, 1, 1, 1, 1, 1})
local w = t:get()
assert(math.abs(w[0] - 1.0) < 1e-6)
local m = mv.MatrixTableHandler:new(6, 3)
m:add_rows({1, 4}, {1, 2, 3, 4, 5, 6})
local rows = m:get_rows({4, 1})
assert(math.abs(rows[0] - 4.0) < 1e-6)   -- row 4, col 0
assert(math.abs(rows[3] - 1.0) < 1e-6)   -- row 1, col 0
m:add_rows({1}, {10, 10, 10}, {async = true})
mv.barrier()
local again = m:get_rows({1})
assert(math.abs(again[0] - 11.0) < 1e-6)
local kv = mv.KVTableHandler:new()
kv:add("alpha", 2.5)
assert(math.abs(kv:get("alpha") - 2.5) < 1e-6)
kv:add_batch({"b", "cc"}, {1.0, 2.0})
local vals = kv:get_batch({"cc", "b", "absent"})
assert(math.abs(vals[0] - 2.0) < 1e-6)
assert(math.abs(vals[1] - 1.0) < 1e-6)
assert(vals[2] == 0.0)
mv.barrier()
mv.shutdown()
print("LUA_SMOKE_OK")
"""


def lua_smoke(luajit, timeout=60):
    """The port's Lua module (``binding/lua/multiverso.lua``) under
    ``luajit`` over the port's library: array, matrix-row and KV round
    trips.  Returns the completed process."""
    import tempfile

    lua_dir = os.path.join(HERE, "multiverso_tpu_torch", "binding", "lua")
    with tempfile.TemporaryDirectory(prefix="mvt_lua_") as tmp:
        script = os.path.join(tmp, "smoke.lua")
        with open(script, "w") as f:
            f.write(LUA_SMOKE % lua_dir)
        return subprocess.run([luajit, script], capture_output=True,
                              text=True, timeout=timeout)


def raise_fd_limit(want):
    """Raise this process's soft RLIMIT_NOFILE toward ``want`` (its ranks
    inherit it, as bench_tail's do); (soft, hard) before and the soft
    limit after."""
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft != resource.RLIM_INFINITY and soft < want:
        cap = want if hard == resource.RLIM_INFINITY else min(want, hard)
        with contextlib.suppress(ValueError, OSError):
            resource.setrlimit(resource.RLIMIT_NOFILE, (cap, hard))
    return soft, hard, resource.getrlimit(resource.RLIMIT_NOFILE)[0]


def tool_records(cli):
    """``cli``'s CLI runs (nested by step) as printed: exit code, args
    and the tail of the output."""
    if "rc" in cli:
        return {"args": cli["args"], "rc": cli["rc"],
                "out": cli["out"][-1500:], "err": cli["err"][-500:]}
    return {k: tool_records(v) for k, v in cli.items()}


def apply_counts(doctors, latencies):
    """How often the doctor and latency demos' fleets named ``apply``:
    the doctor's top finding, latdoctor's rank 1 dominant p99 stage and
    the latency demo's gated mean-based stage, each as ``[named, runs]``
    over every run that got that far."""
    def count(xs):
        return [sum(map(bool, xs)), len(xs)]

    return {"doctor_top_names_apply": count(
                [f["doctor_top_names_apply"] for f in doctors]),
            "latdoctor_dominant_p99_apply": count(
                [f["latdoctor_dominant_p99"].get("1") == "apply"
                 for f in latencies]),
            "latency_mean_stage_apply": count(
                [f["dominant_stage"] == "apply" for f in latencies])}


def falsy_checks(checks):
    """The names of the checks in ``checks`` (nested dicts of booleans)
    that did not pass, as dotted paths."""
    out = []
    for k, v in (checks or {}).items():
        if isinstance(v, dict):
            out += [f"{k}.{sub}" for sub in falsy_checks(v)]
        elif not v:
            out.append(k)
    return out


def phase_serve(card, build, demo_repeats=1):
    """The serve phase (see the module docstring) at the sizes ``SERVE``
    and ``SERVE_DEMO``; ``build`` is ``start_native_build``'s.  Every
    part runs and prints its line; the phase raises at its end naming
    each part that failed and its failed checks.  ``demo_repeats`` > 1 runs the doctor and
    latency demos that many times in all and prints how often each
    named ``apply`` (``apply_counts``)."""
    import shutil

    from multiverso_tpu_torch import native as nat

    sizes, demo, timeout = SERVE, SERVE_DEMO, NATIVE_TIMEOUT_S
    thread, built = build
    thread.join()
    if "error" in built:
        raise built["error"]
    t_phase = time.perf_counter()
    soft, hard, raised = raise_fd_limit(sizes["tail"] + 512)
    uring = bool(nat.load().MV_UringSupported())
    luajit = shutil.which("luajit")
    emit({"phase": "serve", "check": "host", "host_cpus": os.cpu_count(),
          "rlimit_nofile": {"soft": soft, "hard": hard, "soft_now": raised},
          "uring_supported": uring, "luajit": luajit, "card": card})
    failed, recorded, why = [], {}, {}

    def part(name, run):
        t0 = time.perf_counter()
        try:
            rec = run()
        except Exception as exc:     # reported; the phase fails at its end
            traceback.print_exc()
            rec = {"ok": False, "error": f"{type(exc).__name__}: {exc}"}
        rec["seconds"] = time.perf_counter() - t0
        if not name.startswith("demo_"):     # bench.py's sizes only
            recorded.update((k, v) for k, v in rec.get("keys", {}).items()
                            if k in SERVE_BARS)
        emit({"phase": "serve", "check": name, **rec})
        if not rec["ok"]:
            failed.append(name)
            why[name] = rec.get("error") or falsy_checks(rec.get("checks"))

    def fanin(clients, inflight, chaos=0, engine="epoll", prefix="fanin_"):
        keys, _ = serve_fanin(clients, inflight, chaos, "", engine, timeout)
        checks, ok = judge_fanin(keys, clients, demo=bool(chaos))
        return {"ok": ok, "checks": checks, "clients": clients,
                "inflight": inflight, "engine": engine,
                "keys": bench_names(keys, prefix)}

    def plane(mode, clients, inflight=SERVE_INFLIGHT):
        keys, outs = serve_fanin(clients, inflight, 0, mode, "epoll",
                                 timeout)
        checks, ok = judge_serve_plane(mode, keys)
        rec = {"ok": ok, "checks": checks, "clients": clients,
               "keys": bench_names(keys, f"{mode}_", (f"{mode}_",))}
        if mode == "tail":
            rec["fd_limit"] = [ln for out in outs for ln in out.splitlines()
                               if ln.startswith("fd_limit:")]
        return rec

    def failover():
        keys = serve_failover(timeout)
        checks, ok = judge_failover(keys)
        return {"ok": ok, "checks": checks,
                "keys": bench_names(keys, "failover_",
                                    ("failover_", "repl_"))}

    def skew(size, nan=0):
        keys, box = serve_skew(*size, nan=nan, timeout=timeout)
        checks, ok = judge_skew(keys, box, bool(nan))
        return {"ok": ok, "checks": checks, "size": size,
                "blackbox_reason": (box or {}).get("reason"),
                "keys": bench_names(keys, "skew_",
                                    ("skew_", "hotkey_", "hot_"))}

    def capacity(ranks, size, flag=0):
        keys = serve_capacity(ranks, *size, demo=flag, timeout=timeout)
        checks, ok = judge_capacity(keys, bool(flag))
        return {"ok": ok, "checks": checks, "ranks": ranks, "size": size,
                "keys": bench_names(keys, "capacity_",
                                    ("capacity_", "mvplan_"))}

    def audit(mode, *extra):
        if mode == "plain":
            findings, outs, box = serve_audit(mode, extra, timeout)
        else:
            findings, outs, box, run = serve_audit_cli(mode, extra, timeout)
        checks, ok = judge_audit(mode, findings, outs, box)
        rec = {"flags": list(extra),
               "findings": [{k: f.get(k) for k in ("kind", "count")}
                            for f in findings],
               "blackbox_reason": (box or {}).get("reason")}
        if mode != "plain":
            checks["mvaudit"], cli_ok = judge_mvaudit(mode, run, findings)
            ok = ok and cli_ok
            rec["cli"] = {"mvaudit": tool_records(run)}
        return {"ok": ok, "checks": checks, **rec}

    seen = {serve_doctor_demo: [], serve_latency_demo: []}

    def demo_part(run, judge, cli=None):
        """``run``'s facts judged by ``judge`` and, with ``cli``, its CLI
        steps by that judge (their checks under ``"cli"``)."""
        facts = run(timeout)
        seen.get(run, []).append(facts)
        checks, ok = judge(facts)
        if cli is not None:
            checks["cli"], cli_ok = cli(facts)
            ok = ok and cli_ok
        facts = dict(facts, cli=tool_records(facts.get("cli", {})))
        facts.pop("diff", None)
        return {"ok": ok, "checks": checks, "facts": facts}

    def lua():
        if luajit is None:
            return {"ok": True, "ran": False,
                    "note": "no luajit on PATH: the Lua smoke did not run"}
        out = lua_smoke(luajit)
        ok = out.returncode == 0 and "LUA_SMOKE_OK" in out.stdout
        return {"ok": ok, "ran": True, "luajit": luajit,
                "output": (out.stdout + out.stderr)[-2000:]}

    part("fanin", lambda: fanin(sizes["fanin"], SERVE_INFLIGHT))
    if uring:
        part("fanin_uring", lambda: fanin(sizes["fanin"], SERVE_INFLIGHT,
                                          engine="uring",
                                          prefix="fanin_uring_"))
    else:
        emit({"phase": "serve", "check": "fanin_uring", "ok": True,
              "ran": False, "note": "MV_UringSupported() is 0 on this host"})
    part("tail", lambda: plane("tail", sizes["tail"], 0))
    for mode in ("ops", "latency", "audit", "health"):
        part(mode, lambda mode=mode: plane(mode, sizes[mode]))
    part("failover", failover)
    part("demo_failover", lambda: demo_part(
        serve_failover_demo, judge_failover_demo, judge_failover_cli))
    part("skew", lambda: skew(sizes["skew"]))
    part("capacity", lambda: capacity(2, sizes["capacity"]))
    part("demo_fanin_chaos", lambda: fanin(*demo["fanin"], chaos=1))
    part("demo_skew_nan", lambda: skew(demo["skew"], nan=1))
    part("demo_capacity", lambda: capacity(demo["capacity"][0],
                                           demo["capacity"][1:], 1))
    for engine in ("epoll", "tcp"):
        part(f"demo_audit_chaos_{engine}",
             lambda engine=engine: audit("chaos", f"-net_engine={engine}"))
    part("demo_audit_loss", lambda: audit("loss"))
    part("demo_audit_plain", lambda: audit("plain", "-audit=false"))
    part("demo_doctor", lambda: demo_part(
        serve_doctor_demo, judge_doctor_demo,
        lambda f: judge_doctor_cli(f, gate_apply=True)))
    part("demo_latency", lambda: demo_part(
        serve_latency_demo, judge_latency_demo,
        lambda f: judge_latdoctor(f["cli"]["latdoctor"], gate_apply=True)))
    part("demo_ops", lambda: demo_part(
        serve_ops_demo, judge_ops_demo,
        lambda f: judge_mvtop_views(f["cli"]["mvtop"])))
    part("lua", lua)
    for i in range(1, demo_repeats):
        part(f"demo_doctor_repeat_{i}", lambda: demo_part(
            serve_doctor_demo, judge_doctor_demo,
            lambda f: judge_doctor_cli(f, gate_apply=True)))
        part(f"demo_latency_repeat_{i}", lambda: demo_part(
            serve_latency_demo, judge_latency_demo,
            lambda f: judge_latdoctor(f["cli"]["latdoctor"],
                                      gate_apply=True)))
    emit({"phase": "serve", "check": "apply_naming", "ok": True,
          **apply_counts(seen[serve_doctor_demo],
                         seen[serve_latency_demo])})
    emit({"phase": "serve", "check": "recorded", "ok": not failed,
          "failed": failed, "host_cpus": os.cpu_count(),
          "rlimit_nofile": {"soft": soft, "hard": hard, "soft_now": raised},
          "uring_supported": uring, "luajit": luajit,
          "overheads_beside_bars": {k: {"value": recorded.get(k),
                                        "acceptance": bar}
                                    for k, bar in SERVE_BARS.items()},
          "serve_seconds": time.perf_counter() - t_phase, "card": card})
    if failed:
        # The failed checks go into the message: a caller that keeps
        # only the end of stderr still learns why.
        raise AssertionError(f"serve phase failed: {why}")


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--demo-repeats", type=int, default=1,
                    help="run the serve phase's doctor and latency demos "
                         "this many times and count how often each named "
                         "'apply' (a run with more is partial)")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if phases - set(PHASES):
        ap.error(f"unknown phases {sorted(phases - set(PHASES))}; "
                 f"choose from {PHASES}")

    if not os.path.isdir(os.path.join(HERE, "multiverso_tpu_torch")):
        print("chip_smoke: multiverso_tpu_torch/ not found beside this "
              "script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import multiverso_tpu_torch as mv
    from multiverso_tpu_torch.ops import _build
    from multiverso_tpu_torch.ops import flash_attention as fa

    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    card = {"name": name, "nvidia_smi": smi}
    emit({"phase": "device", "name": name,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    native_build = (start_native_build() if phases & {"native", "serve"}
                    else None)
    t0 = time.perf_counter()
    paths = _build.build()
    build_s = time.perf_counter() - t0
    phase_build(_build, paths, build_s)

    errs = phase_parity(fa, torch) if "parity" in phases else {}
    host, draw_s = (large_host(torch)
                    if phases & {"trainer", "headdims", "mesh"}
                    else (None, None))
    paths, shapes = (phase_trainer(args, torch, fa, mv, card, host, draw_s)
                     if "trainer" in phases else ({}, {}))
    if "check" in phases:
        phase_check(torch)
    times = phase_timing(fa, torch, card) if "timing" in phases else {}
    if "small" in phases:
        shapes["small"] = phase_small(args, torch, fa, mv, card)
        paths["small"] = shapes["small"]["launches"]
    if "headdims" in phases:
        for path, entry in phase_headdims(args, torch, fa, mv, card,
                                          host).items():
            shapes[path] = entry
            if "launches" in entry:
                paths[path] = entry["launches"]
    if "moe" in phases:
        moe_counts, shapes["moe"] = phase_moe(args, torch, fa, mv, card)
        paths.update(moe_counts)
    if "longctx" in phases:
        shapes["longctx"] = phase_longctx(args, torch, fa, mv, card)
        paths["longctx"] = shapes["longctx"]["launches"]
        shapes["longctx64k"] = phase_longctx64k(args, torch, fa, mv, card)
        paths["longctx64k"] = shapes["longctx64k"]["launches"]
    if "mesh" in phases:
        mesh_counts, ring_shapes = phase_mesh(args, torch, fa, mv, card,
                                              host)
        paths.update(mesh_counts)
        shapes.update(ring_shapes)
    if "moe_mesh" in phases:
        paths.update(phase_moe_mesh(torch, mv, card))
    if "shard" in phases:
        phase_shard(torch, mv, card)
    if "tables" in phases:
        phase_tables(torch, mv, card)
    lr_fused = phase_lr(torch, mv, card) if "lr" in phases else None
    if "rows" in phases:
        phase_rows(torch, mv, card)
    w2v_fused = phase_w2v(torch, mv, card) if "w2v" in phases else None
    if "lda" in phases:
        phase_lda(torch, mv, card)
    if "sgmix" in phases:
        phase_sgmix(torch, mv, card)
    if "resnet" in phases:
        phase_resnet(torch, mv, card)
    if "planes" in phases:
        phase_planes(torch, mv, card)
    if "native" in phases:
        paths["native"] = phase_native(torch, fa, card, native_build,
                                       lr_fused, w2v_fused)
    if "serve" in phases:
        fa.reset_launch_counts()
        phase_serve(card, native_build, args.demo_repeats)
        paths["serve"] = fa.launch_counts()

    kernels = []
    for kname, (src, replaces) in KERNELS.items():
        t = times.get(kname, {})
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": paths.get("trainer", {}).get(kname),
            "max_abs_err": errs.get(kname), "ms": t.get("ms"),
            "plain_ms": t.get("plain_ms"), "bound_ms": t.get("bound_ms"),
            "bound_by": t.get("bound_by"), "library_ms": t.get("library_ms"),
            "tflops": t.get("tflops"), "bound_share": t.get("bound_share"),
            "launches_by_path": {p: c.get(kname) for p, c in paths.items()},
            "other_shapes": [
                {"path": p, "shape": sh["shape"],
                 "max_abs_err": sh.get("errors", {}).get(kname),
                 **({"dtype": sh["dtype"]} if "dtype" in sh else {}),
                 **({"causal": sh["causal"]} if "causal" in sh else {}),
                 **({"launches_per_ring_call": {
                     layout: n[kname] for layout, n in
                     sh["launches_per_ring_call"].items()}}
                    if "launches_per_ring_call" in sh else {}),
                 **sh.get("times", {}).get(kname, {})}
                for p, sh in shapes.items()],
        })
        if "library_covers" in t:
            kernels[-1]["library_covers"] = t["library_covers"]
        kernels[-1]["designs"] = KERNEL_DESIGNS[kname]
    emit({"kernels": kernels})
    print(smi, flush=True)
    skipped = [p for p in PHASES if p not in phases]
    if skipped or args.steps != STEPS or args.demo_repeats != 1:
        # A shortened run proves less than the main path: no result line.
        emit({"ok": False, "partial": True, "skipped_phases": skipped,
              "steps": args.steps, "steps_full": STEPS,
              "demo_repeats": args.demo_repeats})
        return 4
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


def kernel_times_main(argv) -> int:
    """``--kernel-times``: each kernel's times at each shape, for the
    package under ``--root`` (see the module docstring)."""
    ap = argparse.ArgumentParser(prog="chip_smoke.py --kernel-times")
    ap.add_argument("--root", default=HERE,
                    help="the checkout whose multiverso_tpu_torch to time")
    ap.add_argument("shapes", nargs="+",
                    metavar="B,H,T,D,DTYPE | sgns,B,D,K")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    if not os.path.isdir(os.path.join(root, "multiverso_tpu_torch")):
        print(f"chip_smoke: no multiverso_tpu_torch/ under {root}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from multiverso_tpu_torch.ops import _build
    from multiverso_tpu_torch.ops import flash_attention as fa

    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": nvidia_smi_line(), "root": root,
          "package": os.path.dirname(os.path.dirname(fa.__file__))})
    _build.build()
    for spec in args.shapes:
        if spec.startswith("sgns,"):
            from multiverso_tpu_torch.ops import sgns

            b, d, k = (int(x) for x in spec.split(",")[1:])
            emit({"phase": "kernel_times", "root": root, "kernel": "sgns",
                  **sgns_times(torch, sgns, b, d, k)})
            continue
        b, h, t, d, dt = spec.split(",")
        b, h, t, d, dtype = int(b), int(h), int(t), int(d), getattr(torch,
                                                                    dt)
        emit({"phase": "kernel_times", "root": root, "shape": [b, h, t, d],
              "dtype": dt, "causal": True,
              "kernels": kernel_times(fa, torch, b, h, t, d, dtype=dtype)})
    print(nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--kernel-times"]:
            sys.exit(kernel_times_main(sys.argv[2:]))
        if sys.argv[1:2] == ["--shard-rank"]:
            sys.exit(shard_rank(sys.argv[2:]))
        if sys.argv[1:2] == ["--moe-rank"]:
            sys.exit(moe_mesh_rank(sys.argv[2:]))
        sys.exit(main(sys.argv[1:]))
    except Exception:
        traceback.print_exc()
        sys.exit(1)
