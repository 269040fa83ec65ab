#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs its serving and training
paths on one NVIDIA GPU (H100, sm_90a). Run from the repository root:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it goes wrong:

1. Build: compiles every CUDA source of the port, one nvcc per source, all
   started together (TF32 is off for all float32 products).
2. Kernels: holds ``embedding_bag`` and ``unique_bag`` bit for bit against
   their plain torch versions on the card, at the serving shape (B=64,
   L=8, D=128, V=62,500) and on edge cases (all-padding bags, plan
   padding, all-duplicate bags, indices past the end, clamped, D=13 on
   the scalar path), and times each
   kernel, its plain version and ``torch.nn.functional.embedding_bag`` as a
   yardstick (the port never calls it) over 32 tables of that shape. The
   grouped ``unique_bag`` (one launch for a group of tables) bit for bit
   against the plain version and the one-table kernel on every table of
   the 32-table serving and training stages, of tables of unequal V, U, B,
   L and D (D=13, B=0, U=0, L=40, padding, clamped indices, the identity
   dev, a misaligned table) and of 100 tables (two launches); timed as one
   launch per stage at the serving (B=64) and training (batch 512) shapes
   beside each stage's bound. ``embedding_bag`` is that kernel's identity
   case: bit for bit on the 32 occurrence-width tables of a serving and a
   training stage, on edge cases (D=13, B=0, ids past the end, a
   misaligned table, L=40), alone and in one launch with plan tables (the
   dense flush's 16 + 16); timed one table at the training shape and one
   launch per stage beside 32 ``F.embedding_bag`` calls. Then
   ``fused_backward`` bit for bit (payload, table and accumulator) against
   its plain version at the training shape (kwai_video batch of 512, 4,096
   occurrences, D=128, queue width 4,096): the hybrid put (the popped put
   applied, -1 rows in it), the sync put (its own sums applied), sgd, a
   row that three positions share (hybrid and sync), all-padding and D=13
   on the scalar path; timed over 32 tables, with each launch's device
   time from the profiler (``device_split``). Then
   ``blockscale_compress`` and ``blockscale_decompress`` bit for bit (fp16
   payload, scales, output) on a real training lookup's unique rows and a
   real put's sums, on an all-zero block, fp16- and fp32-subnormal blocks,
   a partial last block, the scalar path and block 64; timed over 32
   tables' unique rows. The grouped compress bit for bit against the
   plain version and the one-table kernel on the training get stage (32
   tables' unique rows), the put stage (32 tables' put sums), the wire
   serving stage (32 tables' occurrence rows), payloads of unequal length
   and block (empty, partial last block, the scalar path, a misaligned
   input, a NaN block, a block of 200, the edge blocks above) and 100
   payloads (two launches); timed as one launch per stage. The grouped
   decompress bit for bit on the 32
   tables' unique rows written into given buffers (as a put's payloads
   are), on payloads of unequal length and block (empty, partial last
   block, the scalar path, a misaligned output) and on 100 payloads (two
   launches); timed as one launch for the 32 tables beside
   ``torch.div(comp, scales[:, None])``, its one-call yardstick.
3. Serve: the full width of ``kwai-dlrm`` (32 tables of 62,500 x 128 fp32,
   FFNN 4112-4096-2048-1024-512-256-4) with random weights from a seeded
   generator. A ``ServingService(max_batch=64)`` answers 512 traffic-model
   requests from 4 client threads; half the tables read through the dedup
   plan (``unique_bag``), half at occurrence width (``embedding_bag``),
   all 32 in ONE bag launch per flush. The
   predictions must be finite, in (0, 1), agree with the plain lookup
   (gather + pool, no kernel) and the launch and table counts must show
   that every flush pooled both kinds of table in that one launch. Then
   ``trainer.eval`` on a 1024-row
   batch. The same again with every table ``dense+compressed``: every
   flush must run ONE compress, ONE decompress and ONE bag launch for all
   the tables, and the predictions agree
   with the plain lookup (gather, plain codec, pool).
4. Train: ``PersiaTrainer.step`` at the full kwai-dlrm width, batch 512,
   Adam lr 3e-3, adagrad lr 5e-2: hybrid(3) for 2 warm-up and 30 timed
   steps, 10 more with a stage breakdown and 5 under the profiler; then
   sync and async(3,3) for 4 steps each. Every step must launch the bag
   kernel once for all 32 tables and ``fused_backward`` once per
   table, every loss must be
   finite and the queues' ring pointers must be where the step count puts
   them. Then the card against the CPU (``device="cpu"``, the plain
   versions) from one starting state: sync for 2 steps and hybrid(3) for 5
   (two popped puts applied), tables, accumulators, queues and dense
   parameters compared. Eval loss and AUC on a 4096-row batch.
5. Compressed train: the same model with every table ``dense+compressed``:
   hybrid(3) for 2 warm-up and 10 timed steps (each step launches ONE
   compress and ONE decompress for all the tables' get and the same for
   their put, ONE bag launch and ``fused_backward`` once per table), 5
   with a stage
   breakdown and 3 under
   the profiler, the wire's byte ratio (>= 1.8, the JAX test's bound),
   sync (two ``fused_backward`` launches per table: the sums cross the
   wire before they are applied) and async(3,3) for 3 steps each, and the
   card against the CPU for sync 2 and hybrid(3) 4 steps.
6. Occurrence-width train: every table ``batch_dedup=False``, hybrid(3)
   for 4 steps: ONE bag launch (``embedding_bag``, 32 tables) per step
   and ``fused_backward`` once per table, rings checked.
7. The ``embedding_sgd`` entry point, once (``ops.embedding_sgd`` with its
   ``check_unique``), bit for bit against the plain version.
8. LM serving: ``launch.serve.serve`` at the full width of granite-3-2b
   (40 layers, d_model 2048, 32/8 heads of 64, vocab 49,155 padded to
   49,664, fp32: 10.1 GB of dense weights, a 0.40 GB vocab table, a 1.36
   GB KV cache) with random weights from a seeded generator: B=4, a 2,048
   token prompt, 32 greedy tokens. The prefill must launch
   ``flash_attention_fwd`` once per layer (40); its last-token logits must
   be finite and equal those of the plain attention on the card (max |d|
   <= 1e-3 max |logit|, the first token equal). Prefill ms, ms per decoded
   token, decode tokens/s and the device-busy share under the profiler.
   Then the same model cut to 2 layers, B=1, prompt 256, 4 tokens, on the
   card and on the CPU from one state: logits within rtol 1e-4 / atol
   1e-5, greedy tokens equal; before that check, the card's error split
   into what the fp32 GEMMs leave alone (the card with the plain attention
   against the CPU) and what the attention kernel adds (kernel against
   plain attention on the card).
   Then DeepSeek-V2 serving (``lm_moe_serve``): deepseek-v2-lite-16b at
   full width and depth (27 layers: MLA with 16 heads, a query/key head of
   128 + 64 rope and a value head of 128, kv_lora 512; 64 routed experts
   top-6 + 2 shared of 1,408, the first layer a dense FFN of 10,944; vocab
   102,400; fp32: 62.0 GB of dense weights drawn on the card, scaled in
   place) through ``launch.serve.serve``, B=4, a 2,048-token prompt, 32
   greedy tokens: 27 ``flash_attention_fwd`` launches per prefill, all at
   (192, 128); tokens in the vocab and equal on a second (profiled) run;
   the prefill's last-token logits through the kernel and through the
   plain attention on the card within 1e-3 of the largest, the first
   token equal, with both runs' routing compared (the (layer, token)
   choices that differ and the smallest top-k gap among them are
   printed; a check that fails names them and still fails). Prefill ms,
   ms per token, the device-busy share, peak GiB and the decode's weight
   bytes per token (every expert runs at a decode step). Then the model
   cut to 2 layers (the prologue and one MoE layer), B=1, prompt 256, 4
   tokens, on the card and on the CPU from one state: the logits of every
   step up to the first MoE call that routed a token otherwise within
   rtol 1e-4 / atol 1e-5, the greedy tokens there equal, the flips
   reported (the first must lie within 1e-5 of a top-k boundary).
9. The out-of-core tier, train: kwai-dlrm with every table ``host_lru``
   (a device cache of 7,812 slots, ``default_cache_rows``, over the
   62,500 host rows), hybrid(3), batch 512: 2 warm-up and 30 timed steps
   (ONE bag launch over the cache slots and ``fused_backward`` once per
   table, as dense), 5 with a stage breakdown whose prepare is split into
   fault-in, eviction (and its wait for the stream) and plan, 3 under the
   profiler; faults, write-backs and hits per step. Every table must fault
   more rows than its cache holds and write rows back, the caches must
   hold fewer bytes than the host stores, and eval must fault nothing.
10. The out-of-core tier, serve: that trained state behind the
   ``ServingService`` (512 Zipf requests, 4 clients, ``max_batch=64``):
   every flush ONE bag launch over each table's hits (gathered from the
   cache) and misses (read from the host store), reads that miss, nothing
   faulted in, predictions equal to the plain read's. Then the card
   against the CPU for 4 more hybrid(3) steps from that state (carried as
   checkpoint blobs): the classes of phase 4, slot maps and counters
   exactly. Then ``host_lru+disk`` (a host tier of 2,048 rows over mmap
   files under ``build/``) bit for bit against ``host_lru`` over 4 steps
   from one seed, and ``host_lru+compressed`` for 4 steps (ONE compress
   and ONE decompress per get and per put).
11. The out-of-core tier, LM: granite-3-2b at full width with the vocab
   table on ``host_lru`` (6,144 slots), B=1, a 2,048-token prompt, 32
   greedy tokens through ``launch.serve.serve``: its prefill logits equal
   those of the dense vocab table from the same seed bit for bit, and its
   tokens those of the dense serve.
12. The pipelined trainer: kwai-dlrm at full width, hybrid(3), batch 512,
   on ``dense`` and on ``host_lru`` (7,812 slots, warmed by 26 serial
   steps until it evicts), from one start state per backend through the
   serial ``trainer.run``, ``PipelinedTrainer(max_inflight=1)`` and
   ``PipelinedTrainer(max_inflight=4)`` (host_lru: ``prefetch=2``),
   without host latency and with a prepare delay of one serial step: 2
   trials of 2 + 8 steps per runner, the runners taking turns; steps/s
   (median and spread), the stages' busy seconds and occupancy, host_lru's
   faults, write-backs and eviction wait per step. max_inflight=1 must
   equal the serial run bit for bit (losses, tables, accumulators, queues,
   dense parameters and moments, slot maps and host rows); every run must
   make the serial step's launches; the deep runs must apply every put in
   order, stay within the put window min(4, 3) and release every pin.
   Then, per regime, syncs per step (``torch.cuda.set_sync_debug_mode(
   "warn")``) and the device-busy share of profiled steps, serial and
   pipelined.
13. The in-process online loop (``launch.online``'s loop): kwai-dlrm at
   full width on ``host_lru``, hybrid(2), training batch 512, a
   ``ServingService(max_batch=64)``, 4 closed-loop clients x 256 requests
   fed back as clicks, 30 trainer steps over the one embedding state:
   exactly 30 steps, every served impression fed back, every table's
   staleness gauge <= 2, predictions finite in [0, 1] (the first Adam
   steps saturate some of fp32's sigmoids: their share is reported) and
   the untrained model's in (0, 1), one bag launch per flush and per step
   and 32 ``fused_backward`` per step; steps/s,
   feedback and fallback batches, p50/p99/QPS under training beside a
   serve-only run of the same service and clients from the same call.
14. LM training: ``PersiaTrainer(lm_adapter)`` at the full width and
   depth of granite-3-2b (fp32, remat per layer, B=2, S=2,048,
   hybrid(1), Adam, ``lm_batches``): 2 warm-up and 3 timed steps, each
   80 ``flash_attention_fwd`` (forward and recompute) and one
   ``fused_backward`` at D=2,048, one profiled step; step ms, tokens/s,
   device-busy share, peak memory, finite losses. Then (a) the attention
   backward (the kernel's forward, the recompute backward) against
   autograd through the plain attention at one layer's shape (B=1, S=2,048)
   and at a ragged S=1,000 with window 256, within 1e-3 of the largest
   |grad|; (b) ``fused_backward`` at the LM put's shape (4,096
   occurrences, D=2,048, 49,155 rows), hybrid and sync, bit for bit, timed
   beside its bound; (c) the model cut to 2 layers, B=1, S=256, 3 steps on
   the card and on the CPU from one state (losses rtol 1e-4; the dense
   parameters as ``dense_agreement`` holds them, and the vocab table the
   same way: updates equal in norm to 1e-3, no element off by more than
   lr / 100 per applied put; the accumulator in norm to 1e-3, the queued
   put to 1e-3 of its largest element).
15. DeepSeek-V2 training (``lm_moe_train``): ``PersiaTrainer(lm_adapter)``
   at the full width of deepseek-v2-lite-16b, its depth cut to the
   prologue and 5 MoE layers (3.21 G dense parameters; with their
   gradients and Adam's moments ~51 GB), fp32, remat, B=2, S=2,048,
   hybrid(1), Adam: 2 warm-up and 3 timed steps, each 11
   ``flash_attention_fwd`` at (192, 128) (the prologue's forward, each MoE
   layer's forward and recompute) and one ``fused_backward`` at D=2,048,
   one profiled step; step ms, tokens/s, busy share, peak memory, the top
   device kernels, finite losses. Then the attention backward at the MLA
   shape (B=1, S=2,048, 16 heads, 192 / 128; and S=1,000 with window 256)
   against autograd through the plain attention, within 1e-3 of the
   largest |grad|, and the 2-layer cut (the prologue and one MoE layer,
   B=1, S=256): one step's loss and every gradient on the card against
   the CPU within rtol 1e-4 / atol 1e-5, its routing compared.
16. Mamba-2 serving (``ssm_serve``): mamba2-1.3b at full width and depth
   (48 layers, 1.34 G parameters, 5.38 GB fp32) through
   ``launch.serve.serve``, B=4, prompt 2,048, 32 greedy tokens: no kernel
   launch (the SSD mixer is plain torch), tokens equal on a second
   (profiled) run; prefill ms, ms a token, busy share, peak memory; one
   layer's chunked SSD against the step-by-step recurrence on the card
   (within 1e-4 of its largest output); the 2-layer cut on the card
   against the CPU (B=1, prompt 256, 4 tokens: logits within rtol 1e-4 /
   atol 1e-5, tokens equal).
17. The Jamba hybrid (``hybrid_serve``): jamba-v0.1-52b at full width cut
   to 1 of its 4 pattern repeats (8 layers: 7 mamba2, 1 GQA of 32 / 8
   heads of 128; 4 dense FFNs and 4 MoE of 16 experts top-2 of 14,336;
   13.0 G parameters, 52.0 GB fp32), B=4, prompt 2,048, 32 greedy tokens:
   one ``flash_attention_fwd`` a prefill at (128, 128), tokens equal on a
   second (profiled) run; prefill ms, ms a token, busy share, peak
   memory, the decode's weight bytes; then the 2-layer cut (the GQA +
   dense block and the mamba2 + MoE block after it) on the card against
   the CPU as in phase 8, split as granite's is: where a step's logits
   miss rtol 1e-4 / atol 1e-5, within twice the distance that the card's
   fp32 GEMMs alone (the plain attention on the card) leave from the CPU
   at Jamba's widths.
18. Whisper serving (``encdec_serve``): whisper-medium at full width and
   depth (24 encoder and 24 decoder layers, d_model 1,024, 16 heads of
   64, GELU, LayerNorm, vocab 51,865, 65,536 learned decoder positions;
   828.1 M parameters, 3.31 GB fp32) through ``launch.serve.serve``, B=4,
   a 2,048-token prompt over 1,500 frames of 1,024 (random normal x 0.1
   from the prompts' stream, as the JAX serve draws them), 32 greedy
   tokens: 72 ``flash_attention_fwd`` a serve (24 encoder layers over the
   1,500 frames, non-causal; 24 causal self-attentions; 24
   cross-attentions, 2,048 x 1,500) and none in the decode (its
   cross-attention is plain torch over the cached memory K/V), tokens
   equal on a second (profiled) run, the prefill's logits through the
   kernel and through the plain attention within 1e-3 of the largest,
   the first token equal; prefill ms, ms a token, busy share, peak GiB.
   Then the cut to 2 encoder + 2 decoder layers on the card against the
   CPU (B=1, prompt 256, 4 tokens) in the plain class.
19. Llama-3.2-Vision serving (``vlm_serve``): llama-3.2-vision-90b at
   full width cut to 1 of its 20 pattern repeats (4 gqa layers of 64 / 8
   heads of 128 and one tanh-gated ``cross_attn`` layer; d_ff 28,672;
   5.33 G parameters, 21.3 GB, and a 4.2 GB vocab table), every
   ``xgate`` set to 0.5 (at its init value 0 the cross-attention would
   add nothing), 1,600 patches of 8,192, served as whisper: 5
   ``flash_attention_fwd`` a serve (4 causal at a group of 8, one 2,048
   x 1,600 cross); then the gqa + cross_attn cut on the card against
   the CPU, split.
20. Whisper training (``encdec_train``): ``PersiaTrainer(lm_adapter)`` at
   full width and depth, fp32, remat in the encoder and the decoder,
   B=2, S=2,048, 1,500 frames a row, hybrid(1), Adam: 2 warm-up and 3
   timed steps, each 144 ``flash_attention_fwd`` (72 forward, 72
   recompute) and one ``fused_backward`` at D=1,024, one profiled step;
   the attention backward at the cross-attention's shape (2,048 over
   1,500) and the encoder's (1,500, non-causal) against autograd
   through the plain attention, within 1e-3 of the largest |grad|; the
   put at D=1,024 (51,865 rows) bit for bit and timed; the 2 + 2 layer
   cut trained 2 steps on the card against the CPU (the classes of phase
   14). Then granite-3-2b cut to 2 layers with a 64-token sliding window
   (the kernel's windowed prefill and the ring decode's mask) and with
   logit soft-capping at 50 (the capped attention is plain torch,
   blockwise), each on the card against the CPU, split.
21. The sharded embedding-PS router (``sharded_phase``, k=4), kwai-dlrm
   at full width, batch 512, hybrid(3): (a) dense tables at 65,536 rows
   (a power of two: no uniform-shuffle collision), 4 shards against one
   from one seed over 2 + 10 steps, the losses, every logical row and
   accumulator and eval bit for bit, each router step ONE bag launch and
   32 sum-only + 128 apply-only ``fused_backward`` launches (the sum-only
   ones counted apart); both states behind a ``ServingService(
   max_batch=64)`` for 512 requests, predictions bit-equal to each other
   and to the plain read's within rtol 1e-5; the 4-shard checkpoint saved
   under ``build/`` and restored into 1 and 2 shards, every logical row
   exact, the queues restarted; (b) at the config's 62,500 rows, where
   ids that share a row on one shard are apart on four, the router on the
   card against the router on the CPU fed the same inputs stage by stage,
   4 steps bit for bit (``router_card_vs_cpu``); (c) host_lru (7,812
   slots, 1,953 a shard) on 4 shards against one over 37 steps that
   evict, the losses and every logical row bit for bit, faults,
   write-backs and hits a step, the prepare's parts, the imbalance gauge;
   (d) that 4-shard state through ``PipelinedTrainer``: max_inflight 1
   bit for bit with serial, max_inflight 4 in order, within its put
   window, every pin released.
22. The multi-process embedding PS (``remote_phase``), kwai-dlrm at full
   width, batch 512, hybrid(3), dense and host_lru (7,812 slots): (a) PS
   servers as threads on the card, the port's remote trainer against its
   in-process trainer from one seed, bit for bit (losses, every logical
   row and accumulator): one endpoint dense over 2 + 10 steps and
   host_lru over 30 that evict, 4 endpoints against the in-process router
   k=4 at 62,500 rows, the lossy wire on one endpoint against
   ``dense+compressed``, ``PipelinedTrainer(max_inflight=1)`` against
   serial, the blocking transport against the pipelined one (more
   frames); each remote step ONE bag launch and 32 sum-only
   ``fused_backward`` launches in the trainer and 32 k apply-only ones in
   the PS threads; (b) PS processes (``launch.cluster.spawn_cluster``,
   ``--device cuda``): steps/s and step ms at k=1 and k=4, dense and
   host_lru, k=1 beside the in-process trainer's from the same call and
   k=4 beside ``sharded_phase``'s router readings; the
   trainer's prepare, lookup and put wall and thread ms, the PS-side
   prepare ms (``metrics`` op), frames and wire bytes a step (the lossy
   wire's from its bit check), syncs a step, the device-busy share, the
   PS processes' apply-only launches (no spool: ``spool_every=0``); (c)
   ``launch.cluster.run_cluster``'s kill drill (3 PS processes spooling
   every put, shard 1 SIGKILLed mid-run): the step ms with the spool,
   recovery seconds and lost rows; (d) ``run_online(n_ps=2)``'s loop
   (``spawn_cluster``, ``connect_remote_backends``, ``_online_loop``; no
   spool): trainer steps/s and serving p50/p99/QPS under training. The
   lossy check runs on the timed runs' batches, over their loss spike.
23. The mesh paths (``mesh_phase``): the script runs itself as 4
   ``--mesh-worker`` processes on the one card, a gloo world meshed data
   2 x model 2 (NCCL takes one card a rank), and as a world of one over
   NCCL through ``make_host_mesh()``. Each worker first checks that its
   backend carries the collectives the paths call on CUDA tensors
   (``all_reduce`` SUM and MAX, ``all_gather_into_tensor``,
   ``all_to_all_single``); a part whose collectives are not carried is
   recorded, not run. The gloo world: (a) kwai-dlrm at full width under
   the mesh, hybrid(3) for 4 steps and sync for 2 (each data rank on 256
   rows of the 512, the 32 tables' rows over all 4 ranks, 15,625 a
   rank), against the port's trainer in one process on the card from the
   same seed: the first step's pooled lookups bit for bit, the losses
   within rtol 1e-4, tables, accumulators and dense parameters in
   ``card_vs_cpu``'s classes; per rank and step 1 bag launch and 64
   ``fused_backward`` launches (a sum-only and a dedup-and-apply per
   table), the collectives and ms a step; (b) deepseek-v2-lite-16b's
   MoE layer (64 experts top-6, 2 shared, d_model 2,048; 32 experts a
   model rank), B=2, S=2,048, the psum and the a2a dispatch at capacity
   factor 8 against ``moe_forward`` with no mesh: the plain class (rtol
   1e-4 / atol 1e-5) or twice the GEMM-only distance (the no-mesh layer
   against itself in fp64); (c) 32 decode steps after a 2,048-token
   prefill of granite-3-2b's attention and DeepSeek-V2-Lite's MLA (B=4,
   a 4,096-position cache, 2,048 positions a model rank) against the
   decode with no mesh, within 3e-5 of the largest output; (d) the LM
   under the mesh, tensor-parallel over model and ZeRO-3 over data
   (``mesh_lm_rank``): granite-3-2b cut to 2 layers at full width, 2
   hybrid(1) Adam steps at B=2, S=2,048 with remat (4 attention
   launches at 16 / 4 heads of 64 and 1 ``fused_backward`` a step a
   rank), and its serve (a 2,048-token prefill and 8 greedy tokens at
   B=4, a 4,096-position cache, 2,048 a model rank); deepseek-v2-lite-16b
   cut to its prologue and one MoE layer, 2 steps under psum and under
   a2a (3 attention launches a step at 8 heads of (192, 128)). Each is
   held against one process on the card from the same state (one rank's
   at a time): the losses within rtol 1e-4, the dense blocks in
   ``dense_agreement``'s trajectory class after each step whose lookups
   read the initial table while the MoE routed alike, the vocab table on
   the rows no two ids share, every greedy token equal where the top-2
   gap exceeds the prefill's distance; then ``launch.op_cost`` around one
   more granite step; (e) the embedding tiers that earlier slices did
   not run under a mesh (``mesh_emb_rank``): the router over 4 shards
   (dense at 65,536 rows a table; host_lru at 1,953 slots a shard with
   admission, warmed until it writes back a row an applied put moved,
   also behind the compressed wire) and kwai-dlrm's tables at occurrence
   width, each held step by step as the tiers are; the serve read of the
   replicated and the row-sharded tier's held state, bit for bit with
   one process; the pipelined trainer on the row-sharded tier
   (max_inflight 1 bit for bit with serial, PIPE_INFLIGHT's puts in
   batch order, the host tiers alike on every rank); remote tables over
   PS processes (one with the dense tables, REMOTE_K with the host_lru
   ones, in one run of tau + 2 steps) against the same run of this
   process beside the world: the first step's lookups bit for bit, each
   applied put against one process's put of the mesh's own ranks'
   shares, the PS's counters, launches and frames equal. The NCCL world of one
   decodes granite through ``decode_dist`` the same way.
24. The dry run (``dryrun_phase``, a CPU process started before the LM
   training phases): granite-3-2b's train_4k, prefill_32k and decode_32k
   rows on the 16 x 16 mesh on the meta device, all ``ok``, and the mesh
   phase's granite cut at (2, 2), whose FLOPs, collectives and argument
   bytes must equal rank 0's count on the card, its HBM bytes within 1%.
25. The launcher, ``repro_torch.launch.train.main`` on the card: 8
   pipelined steps of the CTR task, then ``--task lm --steps 8 --batch 8
   --seq-len 128 --eval-every 4`` (the launcher's lm-100m), finite losses.

The kernel phase also holds ``embedding_sgd`` bit for bit on 32 tables'
real kwai-dlrm puts (the unique physical rows of a training put, -1 and
ids >= V mixed in; ``check_unique`` must raise on a duplicate), and
``flash_attention_fwd`` against its plain version at granite's prefill
shape (B=4, 32/8 heads of 64, S=2,048, fp32, causal; o within 2e-5, lse
within 1e-4) and on edge cases (S=1,000, a ragged tile; window 256;
non-causal; Hq = Hkv; Dh 96 and 128, and phi3-mini's 32 / 32 heads of 96
and qwen3-14b's 40 / 8 of 128; q and k x30 with the scale / 900; bf16
inputs, o within 4e-2, and bf16 at Dh 12, whose K/V go by cp.async;
DeepSeek-V2-Lite's MLA prefill, B=4, 16 heads, S=2,048, a query/key head
of 192 and a value head of 128, in fp32 and bf16, and a ragged Dh 160 /
Dv 72 with Sk 777; Jamba's GQA prefill, B=4, 32 / 8 heads of 128;
whisper-medium's encoder (16 / 16 heads of 64, 1,500 frames,
non-causal), cross-attention (2,048 queries over 1,500 frames, the last
key tile ragged; also in bf16) and decoder self-attention, and
llama-3.2-vision's self-attention (64 / 8 heads of 128, a group of 8)
and cross-attention (2,048 over 1,600), all at B=4; the MLA, Jamba,
whisper and vision shapes are timed beside their bounds, their plain
versions and SDPA, whose backend is named),
each timed beside its bound, its plain version and its library call
(``index_add_``, ``scaled_dot_product_attention``; the port calls
neither). The attention's bound is three TF32 passes of its operations
(its fp32 products run as 3xTF32), with the one-pass fp32 bound beside
it; the same shape with bf16 inputs is timed against its own bound.
``embedding_sgd`` is also timed as one call per graph replay (``lone_ms``),
beside the launch floor (``launch_floor_ms``): an empty one-thread kernel
timed the same two ways, a chain of 32 launches in one graph and one
launch per replay, as a plain launch and as a programmatic dependent.

The bag kernel serves both bag functions: a launch counts once, on
``unique_bag`` when it pooled a plan table and on ``embedding_bag``
otherwise, and each function counts the tables it served (``tables`` in
the kernels line).

It prints the card's name and power limit, one JSON line per phase, the
``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": ...}``.
The full record goes to ``chiprun_out/chip_smoke.json``. Without a GPU it
exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.recsys_configs import KWAI  # noqa: E402
from repro_torch.core import adapters  # noqa: E402
from repro_torch.core import backend as BK  # noqa: E402
from repro_torch.core import compression as C  # noqa: E402
from repro_torch.core import dedup as D  # noqa: E402
from repro_torch.core import embedding_ps as PS  # noqa: E402
from repro_torch.core.hybrid import PersiaTrainer, TrainMode  # noqa: E402
from repro_torch.core.pipeline import STAGES, PipelinedTrainer  # noqa: E402
from repro_torch.data.ctr import CTR_BENCHMARKS  # noqa: E402
from repro_torch.data.lm import lm_batches  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.launch import cluster as ps_cluster  # noqa: E402
from repro_torch.launch import online  # noqa: E402
from repro_torch.launch import serve as lm_serve  # noqa: E402
from repro_torch.launch.shards import (build_embedding_spec,  # noqa: E402
                                       default_cache_rows)
from repro_torch.models import flash as lm_flash  # noqa: E402
from repro_torch.models import layers as lm_layers  # noqa: E402
from repro_torch.models import mamba2 as lm_ssm  # noqa: E402
from repro_torch.models import moe as lm_moe  # noqa: E402
from repro_torch.models import tp as lm_tp  # noqa: E402
from repro_torch.models import transformer as lm_model  # noqa: E402
from repro_torch.models.recsys import pool_bag  # noqa: E402
from repro_torch.net import connect_remote_backends  # noqa: E402
from repro_torch.net.ps_server import PSServer  # noqa: E402
from repro_torch.net.rpc import RpcClient  # noqa: E402
from repro_torch.optim.optimizers import OptConfig  # noqa: E402
from repro_torch.serving import (ServingConfig, ServingService,  # noqa: E402
                                 StateCell, TrafficModel)
from repro_torch.sharding import partition as SP  # noqa: E402
from repro_torch.utils import Mesh, set_mesh  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, fp32 outside the
# tensor cores, dense TF32 and bf16 on them. The bound of a kernel is the
# larger of its bytes over the bandwidth and its operations over the peak
# of their type (the attention's fp32 products run as three TF32 passes).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12

B, L, DIM, V = 64, 8, 128, 62_500        # the serving flush of one table
N_TABLES = 32                             # kwai-dlrm's tables
N_REQUESTS, N_CLIENTS, CHUNK = 512, 4, 16
SEED = 0
# training (the JAX package's launch/train.py defaults): batch, dense Adam
# lr, embedding adagrad lr; hybrid staleness; steps
TRAIN_B, DENSE_LR, EMB_LR, TAU = 512, 3e-3, 5e-2, 3
WARMUP_STEPS, TIMED_STEPS, BREAKDOWN_STEPS, PROFILED_STEPS = 2, 30, 10, 5
# the compressed path's shorter run, and the wire's block
WIRE_STEPS = {"timed": 10, "breakdown": 5, "profiled": 3, "modes": 3}
WIRE = "dense+compressed"
BLOCK = 128
# LM serving: granite-3-2b at full width (40 layers, d_model 2048, vocab
# 49,155), batch, prompt and generated tokens; the card-against-CPU run's
# depth and sizes; the attention kernel's shape at that prefill
LM_ARCH, LM_B, LM_PROMPT, LM_GEN = "granite_3_2b", 4, 2048, 32
LM_CPU = {"layers": 2, "batch": 1, "prompt": 256, "gen": 4}
EMB_SGD_LR = 1e-2
# the out-of-core tier: kwai-dlrm's steps on host_lru (the device cache is
# default_cache_rows of the 62,500 rows: 7,812), the short runs of
# host_lru+disk and host_lru+compressed, the card-against-CPU steps; the
# granite vocab table's cache (vocab/8) and batch
HOST_LRU = "host_lru"
LRU_STEPS = {"timed": 30, "breakdown": 5, "profiled": 3, "short": 4,
             "cpu": 4}
LM_LRU_CACHE, LM_LRU_B = 6144, 1
# the +disk runs' host tier: small enough that 4 steps spill to disk
LRU_HOST_ROWS = 2048
# graph replays of a one-launch graph (a lone call, the launch floor)
LONE_REPS = 200
# the pipelined trainer: kwai-dlrm's steps per run (warm-up and timed),
# trials per (backend, regime, runner), steps counted under the sync debug
# mode and profiled, serial steps that warm a host_lru cache until it
# evicts; the deep runner's window and a host_lru trainer's look-ahead
PIPE_STEPS = {"warmup": 2, "timed": 8, "trials": 2, "syncs": 6,
              "profiled": 4, "lru_warm": 26}
PIPE_INFLIGHT, PIPE_PREFETCH = 4, 2
# the sharded router: kwai-dlrm over SHARDS shards; its dense tables at a
# power-of-two row count, where the uniform shuffle has no collision (at
# 62,500 rows ids that share a row on one shard are apart on four, so one
# and four shards differ there, in both packages); warm-up, timed dense
# and host_lru steps (the latter evict), staged host_lru steps, the
# card-against-CPU steps at 62,500 rows (tau + 1, so a put applies), the
# pipelined runs' steps
SHARDS = 4
SHARD_ROWS_POW2 = 65_536
SHARD_STEPS = {"warmup": 2, "dense": 10, "lru": 30, "staged": 5, "cpu": 4,
               "pipe": 8}

# the multi-process PS: endpoints of the sharded runs; steps of the bit
# checks (one endpoint dense and host_lru, 4 endpoints, the lossy wire,
# pipelined, blocking) and of the timed runs over PS processes (warm-up,
# timed, staged, counted for syncs, profiled); the kill drill's steps and
# the step before which shard 1 dies. The lossy check runs the timed
# runs' first 10 batches, over the loss spike of their steps 5-8
REMOTE_K = 4
REMOTE_STEPS = {"warmup": 2, "dense": 10, "lru": 30, "k4": 4, "lossy": 10,
                "pipe": 6, "blocking": 4, "timed": 6, "staged": 4,
                "syncs": 3, "profiled": 3, "kill": 4, "kill_at": 2}
REMOTE_TIMED_SEED = SEED + 41
# the online loop over 2 PS processes: half the in-process loop's steps
# and requests (its rates need no longer a run)
REMOTE_ONLINE = {"steps": 15, "requests": 128}

# the in-process online loop: kwai-dlrm on host_lru, hybrid(tau), the
# service's micro-batch, closed-loop clients x requests each, trainer steps
ONLINE = {"tau": 2, "max_batch": 64, "clients": 4, "requests": 256,
          "steps": 30}
# LM training: granite-3-2b at full width and depth (batch, sequence,
# warm-up and timed steps), and the card-against-CPU cut
LM_TRAIN = {"batch": 2, "seq": 2048, "warmup": 2, "timed": 3}
LM_TRAIN_CPU = {"layers": 2, "batch": 1, "seq": 256, "steps": 3}
# DeepSeek-V2 serving: deepseek-v2-lite-16b at full width and depth (27
# layers: an mla + dense prologue, 26 mla + MoE), served as granite is
# (LM_B, LM_PROMPT, LM_GEN); the card-against-CPU cut keeps the prologue
# and one MoE layer. A routing choice that flips within this gap of a
# top-k boundary may follow from rounding alone
MOE_ARCH = "deepseek_v2_lite_16b"
MOE_CPU = {"repeats": 1, "batch": 1, "prompt": 256, "gen": 4}
FLIP_GAP = 1e-5
# DeepSeek-V2 training: deepseek-v2-lite-16b at full width, its depth cut
# to the prologue and 5 MoE layers (6 of 27: a MoE layer's 585 M
# parameters take 9.4 GB with their gradient and Adam's two moments, all
# 27 layers ~250 GB); B=2, S=2,048 as granite's training; the
# card-against-CPU cut keeps the prologue and one MoE layer, one step
MOE_TRAIN = {"repeats": 5, "batch": 2, "seq": 2048, "warmup": 2, "timed": 3}
MOE_TRAIN_CPU = {"repeats": 1, "batch": 1, "seq": 256}
# Mamba-2 serving: mamba2-1.3b at full width and depth (48 layers), served
# as granite is; the card-against-CPU cut keeps 2 layers
SSM_ARCH = "mamba2_1_3b"
SSM_CPU = {"repeats": 2, "batch": 1, "prompt": 256, "gen": 4}
# the Jamba hybrid: jamba-v0.1-52b at full width, its depth cut to 1 of 4
# pattern repeats (8 layers: 7 mamba2 and 1 GQA; 4 dense FFNs and 4 MoE
# of 16 experts x 14,336: 12.7 G parameters, 50.9 GB fp32; all 4 ~210
# GB); the card-against-CPU cut keeps the GQA + dense block and the
# mamba2 + MoE block after it (pattern positions 4 and 5)
HYBRID_ARCH = "jamba_v0_1_52b"
HYBRID_REPEATS = 1
HYBRID_CPU = {"blocks": (4, 5), "batch": 1, "prompt": 256, "gen": 4}
# whisper-medium (the encoder-decoder: 24 encoder and 24 decoder layers,
# 1,500 frames of memory) served and trained at full width and depth;
# llama-3.2-vision-90b at full width cut to 1 of its 20 pattern repeats
# (4 gqa + 1 gated cross_attn layer over 1,600 patches of 8,192: 21.3 GB
# of dense weights and a 4.2 GB vocab table; all 100 layers ~350 GB),
# its gates opened to tanh(0.5) (at 0 the cross-attention adds nothing).
# Training: B=2, S=2,048, warm-up, timed, profiled steps. The
# card-against-CPU cuts: whisper at 2 + 2 layers (served, and trained 2
# steps), the vision model's gqa + cross_attn blocks, granite at 2 layers
# with a 64-token sliding window (under the 256-token prompt: the window
# bites in the prefill and the ring decode) and with soft-capping at 50
ENCDEC_ARCH, VLM_ARCH = "whisper_medium", "llama_3_2_vision_90b"
VLM_REPEATS, XGATE = 1, 0.5
ENCDEC_TRAIN = {"batch": 2, "seq": 2048, "warmup": 2, "timed": 3}
ENCDEC_CPU = {"layers": 2, "batch": 1, "prompt": 256, "gen": 4}
ENCDEC_TRAIN_CPU = {"layers": 2, "batch": 1, "seq": 256, "steps": 2}
VLM_CPU = {"batch": 1, "prompt": 256, "gen": 4}
GRANITE_CUTS = {"sliding_window": {"sliding_window": 64},
                "softcap": {"attn_logit_softcap": 50.0}}

# the mesh paths: a world of 4 gloo processes on the one card, mesh (data
# 2, model 2); kwai-dlrm at full width (each data rank on 256 of the 512
# rows, the tables over all 4 ranks: 15,625 rows a rank) for hybrid(3) and
# sync steps (hybrid tau + 1 = 4 steps, so a put applies); the
# expert-parallel MoE at deepseek-v2-lite-16b's layer widths; the
# sequence-sharded decode at granite-3-2b's attention and DeepSeek-V2-
# Lite's MLA after a prefill; then a world of one over NCCL
MESH_SHAPE, MESH_AXES = (2, 2), ("data", "model")
MESH_TRAIN = (("hybrid", TrainMode.hybrid(TAU), 4),
              ("sync", TrainMode.sync(), 2))
MESH_MOE = {"batch": 2, "seq": 2048, "cf": 8.0}
MESH_DECODE = {"batch": 4, "cache": 4096, "prefill": 2048, "steps": 32}
MESH_SEED = SEED + 70
# the LM under the mesh (tensor parallelism over model, ZeRO-3 over data)
# in the same world: granite-3-2b at full width cut to 2 layers, 2
# hybrid(1) Adam steps (tau + 1) at B = 2, S = 2,048 with remat; its serve (a
# 2,048-token prefill, 8 greedy tokens at B = 4 into a 4,096-position
# cache sequence-sharded over model); deepseek-v2-lite-16b cut to its
# dense prologue and one MoE layer, 2 steps under each dispatch
MESH_LM = {"layers": 2, "batch": 2, "seq": 2048, "steps": 2}
MESH_LM_SERVE = {"batch": 4, "prompt": 2048, "gen": 8, "cache": 4096}
MESH_LM_MOE = {"repeats": 1, "batch": 2, "seq": 2048, "steps": 2}
MESH_COLLECTIVES = ("all_reduce", "all_gather_into_tensor",
                    "all_to_all_single")
# the out-of-core tier and the wire under the mesh (hybrid(3), kwai-dlrm at
# full width): host_lru with admission (threshold 1.5) and its default
# bypass, 7,812 + 1,953 = 9,765 slots a table, which do not divide the 4
# ranks (the rules replicate the cache); the same with bypass_rows 1,952:
# 9,764 slots, 2,441 a rank (row-sharded); dense+compressed. One process
# trains alone for tau + 1 steps, so every later step applies a put, and
# on until every host_lru table has written back a row that a put moved
# (at most "warm_cap" steps: admission evicts first-seen rows before their
# puts apply), so the held steps' write-backs carry updated rows; the
# mesh takes its state, then "steps" steps are held step by step; the
# sharded tier's state is then saved and resumed for "resume" steps (the
# resumed run is mesh_online's trajectory, the uninterrupted one its
# serial run)
MESH_TIERS = (("lru_replicated", HOST_LRU, {"admit_threshold": 1.5}),
              ("lru_sharded", HOST_LRU, {"admit_threshold": 1.5,
                                         "bypass_rows": 1952}),
              ("wire", WIRE, {}))
MESH_TIER = {"warm_cap": 60, "steps": 3, "resume": 3,
             "checkpoint": "lru_sharded"}
# the embedding tiers under the mesh that earlier slices refused (mesh_emb,
# in the same world), each held as MESH_TIERS are: the router over SHARDS
# shards, its dense shards at SHARD_ROWS_POW2 rows a table (16,384 a
# shard: the shuffle is a bijection), its host_lru shards at
# sharded_lru_runs' 1,953 slots a shard, with admission and a bypass of
# 487 (2,440 slots: 610 a rank), and the same behind the compressed wire
# (its block the dim); kwai-dlrm's tables at occurrence width
# (batch_dedup=False) on the row-sharded tier's cache. The serve read on
# the replicated and the row-sharded tiers' held state; the pipelined
# trainer on the row-sharded one (serial, max_inflight 1, PIPE_INFLIGHT
# with a look-ahead of PIPE_PREFETCH; "pipe_steps" steps each); remote
# tables over PS processes that mesh_start starts, in one run (the even
# tables dense on one PS process, the odd ones host_lru over REMOTE_K),
# "remote_steps" steps (tau + 2: the last loss reads the first applied
# put) against the same run of one process (this one, beside the world)
# over PS processes of its own. Each applied put's distance from one
# process's is held to PUT_CAP of its largest element (the card's dense
# backward at a rank's 256-row block against the 512-row batch: 5.5e-4
# and 1.4e-3 read, PERF.md), and the rows after the run, in norm, to
# ROWS_REL of what the applied puts moved them
MESH_EMB_TIERS = (
    ("router_dense", "dense", {"emb_shards": SHARDS,
                               "rows": SHARD_ROWS_POW2}),
    ("router_lru", HOST_LRU, {"emb_shards": SHARDS, "admit_threshold": 1.5,
                              "bypass_rows": 1948}),
    ("router_wire", HOST_LRU + "+compressed", {
        "emb_shards": SHARDS, "admit_threshold": 1.5, "bypass_rows": 1948}),
    ("lru_flat", HOST_LRU, {"batch_dedup": False, "admit_threshold": 1.5,
                            "bypass_rows": 1952}))
MESH_EMB = {"serve": ("lru_replicated", "lru_sharded"),
            "pipe": "lru_sharded", "pipe_steps": 3, "remote_steps": TAU + 2}
PUT_CAP, ROWS_REL = 1e-2, 0.05
# the service and the online loop under the mesh (mesh_online, in the first
# gloo world after the tiers, in time its ranks would spend waiting for
# the mesh_emb world): kwai-dlrm at full width on the row-sharded host_lru
# tier of MESH_TIERS, on the tiers part's checkpoint resume: the resumed
# run is the trajectory, the uninterrupted run of the same blocks its
# serial run (so the part adds no step of its own there). The trajectory:
# "steps" (the resume's) published steps, each taken by ServingService.
# train_turn after a flush of the 2 reader threads a rank read the step
# before it, against the same mesh's serial run of the same batches and
# reads (bit for bit); then launch.online._online_loop, from the
# trajectory's state, for tau + 2 steps with "clients" closed-loop clients a rank
# of "requests" requests each, ServingConfig(max_batch=64): every flush
# pads (a closed loop of 2 clients holds at most 2 requests a rank), every
# step falls back to the sampler (a feedback share is 128 impressions a
# rank)
MESH_ONLINE = {"steps": MESH_TIER["resume"], "max_batch": 64, "clients": 2,
               "requests": 2, "loop_steps": TAU + 2}

KERNELS = {
    "embedding_bag": {"source": "src/repro_torch/kernels/csrc/bag.cu",
                      "replaces": "src/repro/kernels/embedding_bag.py:35"},
    "unique_bag": {"source": "src/repro_torch/kernels/csrc/bag.cu",
                   "replaces": "src/repro/kernels/unique_bag.py:45"},
    "fused_backward": {
        "source": "src/repro_torch/kernels/csrc/fused_backward.cu",
        "replaces": "src/repro/kernels/fused_backward.py:79"},
    "blockscale_compress": {
        "source": "src/repro_torch/kernels/csrc/blockscale.cu",
        "replaces": "src/repro/kernels/blockscale.py:37"},
    "blockscale_decompress": {
        "source": "src/repro_torch/kernels/csrc/blockscale.cu",
        "replaces": "src/repro/kernels/blockscale.py:57"},
    "embedding_sgd": {
        "source": "src/repro_torch/kernels/csrc/embedding_sgd.cu",
        "replaces": "src/repro/kernels/embedding_sgd.py:52"},
    "flash_attention_fwd": {
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:73"},
}
CODEC = ("blockscale_compress", "blockscale_decompress")
# the kernels line's fields beyond the contract's: the grouped kernels'
# per-stage times, fused_backward's at the LM puts (D = 2,048 and 1,024)
STAGE_KEYS = ("stage_tables", "stage_ms", "stage_bound_ms", "stage_library_ms",
              "lm_put_ms", "lm_put_bound_ms", "lm_put_bound_by",
              "lm_put_plain_ms", "train_stage_ms", "train_stage_bound_ms",
              "put_stage_ms", "put_stage_bound_ms", "train_ms",
              "train_bound_ms", "lm_put_1024_ms", "lm_put_1024_bound_ms",
              "lm_put_1024_bound_by", "lm_put_1024_plain_ms")
# the attention's shapes timed beside its bound, plain version and SDPA
# (the kernels line takes each one's keys with its name in front)
FLASH_SHAPES = ("mla", "jamba", "whisper_encoder", "whisper_cross",
                "whisper_self", "vision_self", "vision_cross",
                "whisper_cross_bf16")
SHAPE_KEYS = tuple(f"{shape}_{k}" for shape in FLASH_SHAPES
                   for k in ("ms", "bound_ms", "bound_by", "plain_ms",
                             "library_ms", "library_backend"))


BAG_KERNELS = ("embedding_bag", "unique_bag")


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str):
    if not cond:
        raise SmokeFailure(what)


# (phase, seconds since the script started) of every emitted record: where
# the script's time goes
TIMELINE: list = []
T_START = time.perf_counter()


def emit(obj: dict):
    TIMELINE.append((obj.get("phase", next(iter(obj), None)),
                     round(time.perf_counter() - T_START, 1)))
    print(json.dumps(obj), flush=True)


def eager_ms(fn, reps: int) -> float:
    """Mean ms of one eager ``fn()`` call between CUDA events, after a
    warm-up call: what a caller pays, host enqueue included."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_ms(fn, reps: int) -> float:
    """Mean device ms of one ``fn()`` call: ``fn`` is captured once into a
    CUDA graph and replayed ``reps`` times between CUDA events, so the
    host's enqueue cost drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_split(fn, reps: int, calls_per_fn: int) -> dict:
    """Device us per call of each device activity (each kernel by name, a
    memset) that ``reps`` eager runs of ``fn``, ``calls_per_fn`` calls
    each, launch, from ``torch.profiler``; a warm-up run first."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    n = reps * calls_per_fn
    split = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            split[e.key] = us / n
    # the raw events' sums every other profiled run reads stand here beside
    # the profiler's own
    raw = {k: us / n for k, (us, _) in device_times(prof).items() if us > 0}
    check(raw.keys() == split.keys() and all(
        abs(raw[k] - split[k]) <= 1e-6 * max(1.0, split[k]) for k in raw),
        f"device times from the raw events {raw} against key_averages "
        f"{split}")
    return split


def device_times(prof) -> dict:
    """{name: [device us, count]} of every device activity (kernel, copy,
    memset) ``prof`` recorded, summed from the profiler's raw events: the
    ``self_device_time_total`` and ``count`` that ``key_averages()`` gives
    under device-only profiling, without building its event tree (which
    takes seconds at a full model's events)."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name, _rewrite_name
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or _filter_name(e.name()) \
                or getattr(e, "is_hidden_event", lambda: False)() \
                or e.is_async() or e.start_thread_id() != e.end_thread_id():
            continue
        t = out.setdefault(_rewrite_name(name=e.name(), with_wildcard=True),
                           [0.0, 0])
        t[0] += (e.end_ns() - e.start_ns()) / 1e3
        t[1] += 1
    return out


def device_us(prof) -> float:
    """Device us of everything ``prof`` recorded (``device_times``)."""
    return sum(us for us, _ in device_times(prof).values())


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def bag_ids(rng, b, l, v):
    """(b, l) ids in [0, v) with a random-length tail of -1 padding."""
    ids = rng.integers(0, v, (b, l))
    lens = rng.integers(1, l + 1, b)
    return np.where(np.arange(l)[None, :] < lens[:, None], ids, -1)


def plan_of(ids, v):
    """Dedup plan of host ids: (dev (U,) int32 rows, inv (B, L) int32)."""
    u_pad, inv, _, _ = D.make_plan(ids, v, D.dedup_cap(max(ids.size, 1), v))
    return u_pad.astype(np.int32), inv


def exact(name, case, got, want):
    """Bit-for-bit agreement of a kernel with its plain version."""
    err = float((got - want).abs().max()) if got.numel() else 0.0
    check(got.shape == want.shape and torch.equal(got, want),
          f"{name}[{case}]: kernel differs from plain version "
          f"(max abs err {err})")
    return err


def bag_cost(ids, n_rows, n_index) -> tuple[float, float]:
    """(bytes, operations) of one bag call on (B, L) host ``ids``
    (``ops.bag_work``): ``n_rows`` distinct rows, ``n_index`` indices,
    the valid slots' adds."""
    no, nb = ops.bag_work(int((ids >= 0).sum()), n_rows, ids.shape[0],
                          n_index, DIM)
    return nb, no


def bound_of(costs) -> tuple[float, str]:
    """(bound ms, what bounds it) of work whose (bytes, operations) are
    ``costs``, summed: the larger of bytes over the memory rate and fp32
    operations over their peak."""
    nb, no = (sum(c[k] for c in costs) for k in (0, 1))
    b_bytes, b_ops = nb / HBM_BYTES_PER_S, no / FP32_OPS_PER_S
    return max(b_bytes, b_ops) * 1e3, \
        "bytes" if b_bytes >= b_ops else "operations"


# groups of tables for the grouped unique_bag: (V, D, B, L, kind)
BAG_GROUP = [
    (V, DIM, B, L, "plan"),
    (1000, 13, 40, 5, "plan"),          # D % 4 != 0: the scalar path
    (500, 64, 0, 8, "plan"),            # B = 0: no bag
    (800, DIM, 20, 8, "empty_dev"),     # U = 0: every bag reads nothing
    (V, DIM, B, L, "past_end"),         # inv >= U, dev >= V: clamped
    (V, DIM, B, L, "dev_padding"),      # inv pointing at dev's -1 slots
    (300, 24, 30, 6, "identity"),       # dev None: the rows themselves
    (700, 32, 50, 8, "misaligned"),     # table 4 bytes off: scalar path
    (400, 16, 9, 40, "plan"),           # L > 32: two index rounds a bag
]
CHUNK_TABLES = 100          # more tables than one launch takes


def bag_group(rng, dev, specs):
    """(tables, devs, invs) on ``dev`` for the grouped unique_bag."""
    tables, devs, invs = [], [], []
    for v, d, b, l, kind in specs:
        t = torch.as_tensor(rng.standard_normal((v, d)).astype(np.float32),
                            device=dev)
        if kind == "misaligned":
            buf = torch.empty(t.numel() + 1, device=dev)
            buf[1:].copy_(t.reshape(-1))
            t = buf[1:].view(v, d)
        ids = bag_ids(rng, b, l, v) if b and l else np.full((b, l), -1)
        u, inv = plan_of(ids, v)
        if kind == "past_end" and l:
            u[0] = v + 11
            inv[:, -1] = u.size + 5
        elif kind == "dev_padding" and l:
            n_u = int((u >= 0).sum())
            u = np.concatenate([u, np.full(32, -1, np.int32)])
            inv = np.where((np.arange(l)[None, :] % 2 == 1) & (inv >= 0),
                           n_u + (inv % 32), inv).astype(np.int32)
        elif kind == "empty_dev":
            u = u[:0]
        tables.append(t)
        if kind == "identity":
            devs.append(None)
            inv = rng.integers(-1, v + 3, (b, l)).astype(np.int32)
        else:
            devs.append(torch.as_tensor(u, device=dev))
        invs.append(torch.as_tensor(inv.astype(np.int32), device=dev))
    return tables, devs, invs


def random_specs(rng, n, kinds):
    return [(int(rng.integers(1, 2000)), int(rng.choice([4, 13, 64, 128])),
             int(rng.integers(0, 80)), int(rng.integers(1, 12)),
             str(rng.choice(kinds))) for _ in range(n)]


# occurrence-width tables for the bag kernel's identity case: (V, D, B, L,
# kind)
FLAT_GROUP = [
    (V, DIM, B, L, "flat"),
    (1000, 13, 40, 5, "flat"),          # D % 4 != 0: the scalar path
    (500, 64, 0, 8, "flat"),            # B = 0: no bag
    (V, DIM, B, L, "past_end"),         # ids >= V: clamped to row V - 1
    (700, 32, 50, 8, "misaligned"),     # table 4 bytes off: scalar path
    (400, 16, 9, 40, "flat"),           # L > 32: two index rounds a bag
]


def flat_group(rng, dev, specs):
    """(tables, ids) on ``dev`` of occurrence-width tables."""
    tables, ids = [], []
    for v, d, b, l, kind in specs:
        t = torch.as_tensor(rng.standard_normal((v, d)).astype(np.float32),
                            device=dev)
        if kind == "misaligned":
            buf = torch.empty(t.numel() + 1, device=dev)
            buf[1:].copy_(t.reshape(-1))
            t = buf[1:].view(v, d)
        i = bag_ids(rng, b, l, v) if b and l else np.full((b, l), -1)
        if kind == "past_end" and b:
            i[:, 0] = v + 7
        tables.append(t)
        ids.append(torch.as_tensor(i.astype(np.int32), device=dev))
    return tables, ids


def grouped_bag_checks(dev, rng, groups) -> dict:
    """The grouped bag kernel bit for bit on every table of every group
    (tables, devs, invs, flat): a plan table against ``unique_bag``'s plain
    version and one-table kernel, an occurrence-width (flat) table against
    ``embedding_bag``'s; with the launches each grouped call made (one per
    56 non-empty tables), counted once, on ``unique_bag`` when the call
    pooled a plan table, and each kind's tables counted on its own."""
    out = {}
    for case, (tables, devs, invs, flat) in groups.items():
        ops.reset_launch_counts()
        got = ops.unique_bag_grouped(tables, devs, invs, flat)
        torch.cuda.synchronize()
        launches, served = ops.launch_counts(), ops.table_counts()
        live = [bool(i.shape[0] and t.shape[1])
                for t, i in zip(tables, invs)]
        n_flat = sum(1 for x, f in zip(live, flat) if x and f)
        n_plan = sum(live) - n_flat
        owner = "unique_bag" if n_plan else "embedding_bag"
        want = dict.fromkeys(BAG_KERNELS, 0)
        want[owner] = -(-sum(live) // 56)
        check({k: launches[k] for k in want} == want
              and served["unique_bag"] == n_plan
              and served["embedding_bag"] == n_flat,
              f"bag grouped[{case}]: launches {launches}, tables {served}, "
              f"want {want} and {n_plan} plan / {n_flat} flat tables")
        err = {"unique_bag": 0.0, "embedding_bag": 0.0}
        for k, (t, d, i, f, g) in enumerate(zip(tables, devs, invs, flat,
                                                got)):
            if f:
                name, plain = "embedding_bag", ref.embedding_bag_ref(t, i)
                one = (lambda t=t, i=i: ops.embedding_bag(t, i))
            else:
                full = torch.arange(t.shape[0], dtype=torch.int32,
                                    device=dev) if d is None else d
                name, plain = "unique_bag", ref.unique_bag_ref(t, full, i)
                one = (lambda t=t, i=i, full=full: ops.unique_bag(t, full, i))
            err[name] = max(err[name], exact(
                f"{name} grouped", f"{case}: table {k}", g, plain))
            if i.shape[0]:
                exact(f"{name} grouped", f"{case}: table {k} against the "
                      "one-table kernel", g, one())
        out[case] = {"tables": len(tables), "plan_tables": n_plan,
                     "flat_tables": n_flat, "launches": launches[owner],
                     "max_abs_err": err}
    torch.cuda.synchronize()
    return out


def kernel_phase(dev, rng, ds):
    """The bag kernels: bit-exactness and per-call times; the grouped
    unique_bag bit for bit on groups of tables and timed per stage."""
    cuda = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    errs = {k: 0.0 for k in BAG_KERNELS}

    def both(case, table, ids, plan=None):
        ids_t = cuda(ids.astype(np.int32))
        errs["embedding_bag"] = max(errs["embedding_bag"], exact(
            "embedding_bag", case, ops.embedding_bag(table, ids_t),
            ref.embedding_bag_ref(table, ids_t)))
        u, inv = plan if plan is not None else plan_of(ids, table.shape[0])
        u_t, inv_t = cuda(u), cuda(inv)
        errs["unique_bag"] = max(errs["unique_bag"], exact(
            "unique_bag", case, ops.unique_bag(table, u_t, inv_t),
            ref.unique_bag_ref(table, u_t, inv_t)))

    gen = torch.Generator(device=dev).manual_seed(SEED)
    tables = [torch.randn((V, DIM), generator=gen, device=dev) * 0.02
              for _ in range(N_TABLES)]
    serve_ids = [bag_ids(rng, B, L, V) for _ in range(N_TABLES)]
    t = tables[0]
    both("serve", t, serve_ids[0])
    both("all_padding", t, np.full((B, L), -1))
    both("all_duplicate", t, np.full((B, L), 4242))
    out_of_range = serve_ids[1].copy()
    out_of_range[:, 0] = V + 7
    both("ids_past_end", t, out_of_range)
    # plan padding: half the occurrences point at dev slots holding -1
    u, inv = plan_of(serve_ids[2], V)
    n_u = int((u >= 0).sum())
    u = np.concatenate([u, np.full(32, -1, np.int32)])
    inv = np.where((np.arange(L)[None, :] % 2 == 1) & (inv >= 0),
                   n_u + (inv % 32), inv).astype(np.int32)
    both("dev_padding", t, serve_ids[2], plan=(u, inv))
    # past the end, clamped as the JAX package's gathers clamp: ids >= V
    # read row V - 1, inv >= U reads dev[U - 1], a dev entry >= V row V - 1
    past = serve_ids[3].copy()
    past[:, -1] = V + 3
    u, inv = plan_of(serve_ids[3], V)
    u[0], u[-1] = V + 11, 17
    inv[:, -1] = u.size + 5
    both("past_end_clamped", t, past, plan=(u, inv))
    t13 = torch.randn((1000, 13), generator=gen, device=dev)
    both("d13_scalar", t13, bag_ids(rng, B, L, 1000))
    torch.cuda.synchronize()

    # timing: one call per table over the 32 tables, as one serving flush
    # does; the 1 GB of tables is 20x the L2, so rows come from HBM. Each
    # time is per call: on the device (graph replay) and eager
    ids_t = [cuda(i.astype(np.int32)) for i in serve_ids]
    plans = [tuple(cuda(a) for a in plan_of(i, V)) for i in serve_ids]
    safe = [torch.clamp(i, min=0).long() for i in ids_t]
    wts = [(i >= 0).float() for i in ids_t]
    rows_u = [torch.where(inv >= 0, u[inv.clamp(min=0).long()], -1)
              for u, inv in plans]
    safe_u = [torch.clamp(r, min=0).long() for r in rows_u]
    wts_u = [(r >= 0).float() for r in rows_u]
    reps = 20

    def loop(f):
        return lambda: [f(k) for k in range(N_TABLES)]

    fns = {
        "embedding_bag": {
            "ms": lambda k: ops.embedding_bag(tables[k], ids_t[k]),
            "plain_ms": lambda k: ref.embedding_bag_ref(tables[k], ids_t[k]),
            "library_ms": lambda k: F.embedding_bag(
                safe[k], tables[k], mode="sum", per_sample_weights=wts[k]),
        },
        "unique_bag": {
            "ms": lambda k: ops.unique_bag(tables[k], *plans[k]),
            "plain_ms": lambda k: ref.unique_bag_ref(tables[k], *plans[k]),
            "library_ms": lambda k: F.embedding_bag(
                safe_u[k], tables[k], mode="sum", per_sample_weights=wts_u[k]),
        },
    }
    timing = {name: {} for name in fns}
    for name, by in fns.items():
        for key, f in by.items():
            run = loop(f)
            timing[name][key] = device_ms(run, reps) / N_TABLES
            timing[name]["eager_" + key] = eager_ms(run, reps) / N_TABLES
    # bound: each distinct row read once, each output row written once,
    # each index read once; operations: one fp32 add per valid element
    for name in BAG_KERNELS:
        costs = [bag_cost(ids, np.unique(ids[ids >= 0]).size, ids.size + (
            plans[k][0].numel() if name == "unique_bag" else 0))
            for k, ids in enumerate(serve_ids)]
        timing[name].update(
            bound_ms=float(np.mean([bound_of([c])[0] for c in costs])),
            bound_by=bound_of(costs)[1], max_abs_err=errs[name])

    # the grouped bag kernel: bit for bit on every table of each group
    # (the serving and training stages of plan tables and of
    # occurrence-width tables, the dense flush's 16 plan and 16 flat tables
    # in one launch, unequal and edge-case tables of both kinds, more
    # tables than one launch takes), then timed as one launch per stage of
    # the 32 tables, at the serving shape (B = 64) and at the training
    # shape (kwai_video batch of 512)
    names, batches = train_plans(dev, ds, 1, SEED + 18)
    ids_tr, plans_tr = batches[0]
    # a training batch's occurrence rows: what an occurrence-width step
    # pools (the physical row of every id, -1 at padding)
    occ_tr = [torch.where(p.inv >= 0, p.rows[p.inv.clamp(min=0).long()], -1)
              for p in (plans_tr[n] for n in names)]
    plan_cases = bag_group(rng, dev, BAG_GROUP)
    flat_cases = flat_group(rng, dev, FLAT_GROUP)
    half = N_TABLES // 2
    flat_marks = [False] * N_TABLES
    groups = {
        "serve_stage": (tables, [p[0] for p in plans],
                        [p[1] for p in plans], flat_marks),
        "train_stage": (tables, [plans_tr[n].rows for n in names],
                        [plans_tr[n].inv for n in names], flat_marks),
        "flat_serve_stage": (tables, [None] * N_TABLES, ids_t,
                             [True] * N_TABLES),
        "flat_train_stage": (tables, [None] * N_TABLES, occ_tr,
                             [True] * N_TABLES),
        # the dense flush: even tables through their plan, odd ones flat
        "dense_flush": (tables, [plans[k][0] if k % 2 == 0 else None
                                 for k in range(N_TABLES)],
                        [plans[k][1] if k % 2 == 0 else ids_t[k]
                         for k in range(N_TABLES)],
                        [k % 2 == 1 for k in range(N_TABLES)]),
        "mixed": (*plan_cases, [False] * len(plan_cases[0])),
        "flat_edge": (flat_cases[0], [None] * len(flat_cases[0]),
                      flat_cases[1], [True] * len(flat_cases[0])),
        "mixed_both": (plan_cases[0] + flat_cases[0],
                       plan_cases[1] + [None] * len(flat_cases[0]),
                       plan_cases[2] + flat_cases[1],
                       [False] * len(plan_cases[0])
                       + [True] * len(flat_cases[0])),
        f"{CHUNK_TABLES}_tables": (*bag_group(rng, dev, random_specs(
            rng, CHUNK_TABLES, ["plan", "past_end", "identity"])),
            [False] * CHUNK_TABLES),
    }
    check(sum(groups["dense_flush"][3]) == half, "dense flush group")
    cases = grouped_bag_checks(dev, rng, groups)
    serve_args, train_args = groups["serve_stage"], groups["train_stage"]
    flat_serve, flat_train = groups["flat_serve_stage"], \
        groups["flat_train_stage"]
    serve_bound = bound_of([bag_cost(ids, np.unique(ids[ids >= 0]).size,
                                     ids.size + plans[k][0].numel())
                            for k, ids in enumerate(serve_ids)])
    train_bound = bound_of([bag_cost(
        ids_tr[n], int(torch.unique(p.rows[p.rows >= 0]).numel()),
        p.inv.numel() + p.rows.numel())
        for n, p in ((n, plans_tr[n]) for n in names)])
    timing["unique_bag"].update(
        stage_tables=N_TABLES,
        stage_ms=device_ms(lambda: ops.unique_bag_grouped(*serve_args),
                           reps),
        eager_stage_ms=eager_ms(lambda: ops.unique_bag_grouped(*serve_args),
                                reps),
        stage_bound_ms=serve_bound[0], stage_bound_by=serve_bound[1],
        train_stage_ms=device_ms(lambda: ops.unique_bag_grouped(*train_args),
                                 reps),
        train_stage_bound_ms=train_bound[0],
        train_stage_bound_by=train_bound[1], grouped_cases=cases)
    # embedding_bag, the bag kernel's identity case: one table at the
    # training shape, and one launch per stage of the 32 occurrence-width
    # tables (a wire serving flush at B = 64; an occurrence-width training
    # step at batch 512)
    train_loop = [(tables[k], o) for k, o in enumerate(occ_tr)]
    flat_serve_bound = bound_of([bag_cost(ids, np.unique(ids[ids >= 0]).size,
                                          ids.size) for ids in serve_ids])
    occ_host = [o.cpu().numpy() for o in occ_tr]
    flat_train_bound = bound_of([bag_cost(o, np.unique(o[o >= 0]).size,
                                          o.size) for o in occ_host])
    timing["embedding_bag"].update(
        train_ms=device_ms(lambda: [ops.embedding_bag(t, o)
                                    for t, o in train_loop], reps) / N_TABLES,
        train_bound_ms=float(np.mean([bound_of([bag_cost(
            o, np.unique(o[o >= 0]).size, o.size)])[0] for o in occ_host])),
        stage_tables=N_TABLES,
        stage_ms=device_ms(lambda: ops.unique_bag_grouped(*flat_serve),
                           reps),
        eager_stage_ms=eager_ms(lambda: ops.unique_bag_grouped(*flat_serve),
                                reps),
        stage_library_ms=device_ms(loop(fns["embedding_bag"]["library_ms"]),
                                   reps),
        stage_bound_ms=flat_serve_bound[0],
        stage_bound_by=flat_serve_bound[1],
        train_stage_ms=device_ms(lambda: ops.unique_bag_grouped(*flat_train),
                                 reps),
        train_stage_bound_ms=flat_train_bound[0],
        train_stage_bound_by=flat_train_bound[1],
        dense_flush_ms=device_ms(lambda: ops.unique_bag_grouped(
            *groups["dense_flush"]), reps))
    del tables, groups, serve_args, train_args, flat_serve, flat_train
    torch.cuda.empty_cache()
    return timing


def train_plans(dev, ds, n_batches, seed):
    """The host prepare of ``n_batches`` kwai_video training batches:
    per batch, each table's dedup plan on the card (what a train step hands
    its kernels)."""
    coll = adapters.ctr_collection(KWAI, field_rows=ds.field_rows())
    backends = coll.make_backends()
    it = ds.sampler(TRAIN_B, seed=seed)
    out = []
    for _ in range(n_batches):
        b = next(it)
        ids = {n: b["ids"][:, i] for i, n in enumerate(coll.names)}
        _, plans, _ = BK.prepare_all(backends, dict.fromkeys(ids), ids, dev)
        out.append((ids, plans))
    return coll.names, out


def fb_inputs(gen, ids, plan, prev, cap, sgd=False):
    """One table's fused_backward arguments at the training shape: the
    occurrence gradients (zero at padding, as the trainer forms them), this
    batch's CSR and, for the hybrid put, the popped put of the batch before
    (``prev``: its plan rows padded with -1 to the queue width, random
    payload); ``prev=None`` is the sync put (apply_self)."""
    n_occ = ids.size
    dev = plan.inv.device
    mask = torch.as_tensor(ids.reshape(-1) >= 0, device=dev)
    grads = torch.randn((n_occ, DIM), generator=gen, device=dev) * 1e-3
    grads = grads * mask[:, None].float()
    acc = None if sgd else \
        torch.rand((V,), generator=gen, device=dev) * 1e-6
    if prev is None:
        return acc, grads, plan.rows, None, True
    idx = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    idx[:prev.rows.numel()] = prev.rows
    g = torch.randn((cap, DIM), generator=gen, device=dev) * 1e-3
    g[prev.rows.numel():] = 0
    return acc, grads, idx, g, False


def fb_bound(plan, apply_idx, apply_self, dim=DIM) -> tuple[float, float]:
    """(bytes, operations) that one call must move and do on this run's
    data (``ops.fused_backward_cost``: the live positions and their
    distinct rows)."""
    no, nb = ops.fused_backward_cost(plan.order, plan.offsets, None,
                                     apply_idx, apply_self, dim, data=True)
    return nb, no


def fused_backward_phase(dev, ds):
    """fused_backward against its plain version on the card, bit for bit,
    then its per-call time over 32 tables."""
    names, batches = train_plans(dev, ds, 2, SEED + 10)
    (_, prev_plans), (ids_now, plans) = batches
    cap = D.dedup_cap(TRAIN_B * L, V)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    tables = [torch.randn((V, DIM), generator=gen, device=dev) * 0.02
              for _ in range(N_TABLES)]
    cases, errs = {}, []

    def run(case, table, acc, plan, grads, idx, g, apply_self):
        outs = []
        for fn in (ops.fused_backward, ref.fused_backward_ref):
            t = table.clone()
            a = None if acc is None else acc.clone()
            push = fn(t, a, plan.order, plan.offsets, grads, idx, g,
                      lr=EMB_LR, eps=1e-8, apply_self=apply_self)
            outs.append((push, t, a))
        (p0, t0, a0), (p1, t1, a1) = outs
        torch.cuda.synchronize()
        errs.append(exact("fused_backward", f"{case}: payload", p0, p1))
        errs.append(exact("fused_backward", f"{case}: table", t0, t1))
        check((a0 is None) == (a1 is None),
              f"fused_backward[{case}]: acc given on one side only")
        if a0 is not None:
            errs.append(exact("fused_backward", f"{case}: acc", a0, a1))
        cases[case] = {"live_positions": int((idx >= 0).sum()),
                       "shared_rows": int((idx >= 0).sum())
                       - int(torch.unique(idx[idx >= 0]).numel()),
                       "valid_occurrences": int(plan.order.numel())}

    n0 = names[0]
    for case, prev, sgd in (("hybrid", prev_plans[n0], False),
                            ("sync", None, False),
                            ("hybrid_sgd", prev_plans[n0], True)):
        acc, grads, idx, g, self_ = fb_inputs(gen, ids_now[n0], plans[n0],
                                              prev, cap, sgd)
        run(case, tables[0], acc, plans[n0], grads, idx, g, self_)
    # a physical row that three positions of the hybrid put share (as three
    # colliding ids would), in both modes
    acc, grads, idx, g, _ = fb_inputs(gen, ids_now[n0], plans[n0],
                                      prev_plans[n0], cap)
    live = torch.nonzero(idx >= 0).flatten()
    idx[live[[5, 40]]] = idx[live[20]].clone()
    run("hybrid_shared_by_3", tables[0], acc, plans[n0], grads, idx, g,
        False)
    sync_idx = plans[n0].rows.clone()
    live = torch.nonzero(sync_idx >= 0).flatten()
    sync_idx[live[[3, 30]]] = sync_idx[live[10]].clone()
    run("sync_shared_by_3", tables[0], acc, plans[n0], grads, sync_idx,
        None, True)
    # all padding: no valid occurrence, no live row
    i32 = dict(dtype=torch.int32, device=dev)
    pad = D.DedupPlan(dev=None, inv=None, order=torch.zeros(0, **i32),
                      offsets=torch.zeros(33, **i32))
    run("all_padding", tables[1], torch.rand((V,), device=dev), pad,
        torch.randn((TRAIN_B * L, DIM), device=dev),
        torch.full((cap,), -1, **i32), torch.randn((cap, DIM), device=dev),
        False)
    # D = 13, the scalar path, on a plan of its own
    t13 = torch.randn((1000, 13), generator=gen, device=dev)
    ids13 = bag_ids(np.random.default_rng(SEED), TRAIN_B, L, 1000)
    u, inv, _, _ = D.make_plan(ids13, 1000, D.dedup_cap(ids13.size, 1000))
    order, offsets = D.occurrence_csr(inv, u.size)
    p13 = D.DedupPlan(dev=None, inv=None,
                      order=torch.from_numpy(order).to(dev),
                      offsets=torch.from_numpy(offsets).to(dev))
    idx13 = torch.full((u.size,), -1, **i32)
    idx13[:u.size // 2] = torch.randperm(1000, device=dev)[:u.size // 2] \
        .int()
    run("d13_scalar", t13, torch.rand((1000,), device=dev), p13,
        torch.randn((ids13.size, 13), generator=gen, device=dev), idx13,
        torch.randn((u.size, 13), generator=gen, device=dev), False)

    # timing: the hybrid put of each of the 32 tables, as one step does
    args = []
    for k, n in enumerate(names):
        acc, grads, idx, g, _ = fb_inputs(gen, ids_now[n], plans[n],
                                          prev_plans[n], cap)
        args.append((tables[k], acc, plans[n].order, plans[n].offsets,
                     grads, idx, g))

    def loop(fn):
        return lambda: [fn(*a, lr=EMB_LR, eps=1e-8) for a in args]

    timing = {
        "ms": device_ms(loop(ops.fused_backward), 20) / N_TABLES,
        "eager_ms": eager_ms(loop(ops.fused_backward), 20) / N_TABLES,
        # the plain version synchronises with the host (its loops are
        # sized by the data), so it cannot be captured in a graph: eager
        "plain_ms": eager_ms(loop(ref.fused_backward_ref), 2) / N_TABLES,
        "library_ms": None,          # no single PyTorch call computes it
        # device us per call of each launch (profiler, eager calls)
        "split_us": device_split(loop(ops.fused_backward), 20, N_TABLES),
    }
    nbs, nos = zip(*(fb_bound(plans[n], args[k][5], False)
                     for k, n in enumerate(names)))
    b_bytes = float(np.mean(nbs)) / HBM_BYTES_PER_S
    b_ops = float(np.mean(nos)) / FP32_OPS_PER_S
    timing.update(bound_ms=max(b_bytes, b_ops) * 1e3,
                  bound_by="bytes" if b_bytes >= b_ops else "operations",
                  bound_bytes=float(np.mean(nbs)), max_abs_err=max(errs),
                  cases=cases, cap=cap, n_occ=TRAIN_B * L)
    del tables, args
    torch.cuda.empty_cache()
    return timing


def same_bits(name, case, got, want):
    """Bit-for-bit agreement of a codec kernel with its plain version (fp16
    and fp32 compared as integers, so -0.0 and NaN payloads count too)."""
    view = torch.int16 if got.dtype == torch.float16 else torch.int32
    ok = got.shape == want.shape and got.dtype == want.dtype and \
        torch.equal(got.view(view), want.view(view))
    err = float((got.float() - want.float()).abs().nan_to_num().max()) \
        if got.numel() and got.shape == want.shape else 0.0
    check(ok, f"{name}[{case}]: kernel differs from plain version "
          f"(max abs err {err})")
    return err


def codec_bound(n: int, block: int) -> tuple[float, float]:
    """(bytes, operations) of one compress or decompress of n fp32
    elements in blocks of ``block`` (``ops.codec_cost``)."""
    return ops.codec_cost(n, block)[::-1]


# payloads for the grouped decompress: (n, block, output)
CODEC_GROUP = [
    (300 * 128, 128, "shape"),
    (1000, 64, "into"),
    (0, 128, "shape"),                  # empty
    (4096 - 76, 128, "into"),           # a partial last block
    (5000 - 77, 128, "shape"),          # n % 4 != 0: the scalar path
    (3000, 30, "shape"),                # block % 4 != 0: the scalar path
    (2048, 128, "misaligned"),          # out 4 bytes off: the scalar path
]


def codec_group(rng, dev, specs):
    """(comps, scales, outs, wants) on ``dev``: the plain compress of each
    lognormal payload, its output (a shape, a tensor written in place, or
    one 4 bytes into its buffer) and the plain decompress it must equal."""
    comps, scales, outs, wants = [], [], [], []
    for n, block, kind in specs:
        v = torch.as_tensor((rng.standard_normal(n) * np.exp(
            rng.standard_normal(n) * 4)).astype(np.float32), device=dev)
        c, sc = ref.blockscale_compress_ref(v, block)
        comps.append(c)
        scales.append(sc)
        wants.append(ref.blockscale_decompress_ref(c, sc).reshape(-1)[:n])
        outs.append((n,) if kind == "shape" else
                    torch.zeros(n, device=dev) if kind == "into" else
                    torch.zeros(n + 1, device=dev)[1:])
    return comps, scales, outs, wants


def grouped_codec_checks(groups) -> dict:
    """The grouped decompress bit for bit against the plain version and
    the one-table kernel on every payload of every group, written in place
    where an output tensor is given, with the launches each grouped call
    made (one per 80 non-empty payloads)."""
    out = {}
    for case, (comps, scales, outs, wants) in groups.items():
        ops.reset_launch_counts()
        got = ops.blockscale_decompress_grouped(comps, scales, outs)
        torch.cuda.synchronize()
        launches = ops.launch_counts()["blockscale_decompress"]
        served = sum(1 for w in wants if w.numel())
        check(launches == -(-served // 80),
              f"blockscale_decompress_grouped[{case}]: {launches} launches "
              f"for {served} payloads")
        err = 0.0
        for k, (c, sc, o, g, w) in enumerate(zip(comps, scales, outs, got,
                                                 wants)):
            check(not isinstance(o, torch.Tensor) or g is o,
                  f"blockscale_decompress_grouped[{case}]: payload {k} not "
                  "written in place")
            err = max(err, same_bits("blockscale_decompress_grouped",
                                     f"{case}: payload {k}", g.reshape(-1),
                                     w.reshape(-1)))
            if w.numel():
                same_bits("blockscale_decompress_grouped",
                          f"{case}: payload {k} against the one-table "
                          "kernel", g.reshape(-1),
                          ops.blockscale_decompress(c, sc, (w.numel(),)))
        out[case] = {"payloads": len(comps), "launches": launches,
                     "max_abs_err": err}
    torch.cuda.synchronize()
    return out


# payloads for the grouped compress: (n, block, kind)
COMPRESS_GROUP = [
    (300 * 128, 128, "plain"),
    (1000, 64, "plain"),
    (0, 128, "plain"),                  # empty
    (4096 - 76, 128, "plain"),          # a partial last block
    (5000 - 77, 128, "plain"),          # n % 4 != 0: the scalar path
    (3000, 30, "plain"),                # block % 4 != 0: the scalar path
    (2048, 128, "misaligned"),          # v 4 bytes off: the scalar path
    (1024, 128, "nan"),                 # a NaN in one block
    (3000, 200, "plain"),               # block > 128: each block read twice
    (1000, 20, "plain"),                # several blocks a warp, scalar
]


def compress_group(rng, dev, specs):
    """(vs, blocks) on ``dev``: lognormal payloads, a ``misaligned`` one 4
    bytes into its buffer, a ``nan`` one with a NaN in one block."""
    vs, blocks = [], []
    for n, block, kind in specs:
        v = (rng.standard_normal(n) * np.exp(rng.standard_normal(n) * 4)) \
            .astype(np.float32)
        if kind == "nan" and n:
            v[rng.integers(0, n)] = np.nan
        t = torch.as_tensor(v, device=dev)
        if kind == "misaligned":
            buf = torch.empty(n + 1, device=dev)
            buf[1:].copy_(t)
            t = buf[1:]
        vs.append(t)
        blocks.append(block)
    return vs, blocks


def grouped_compress_checks(groups) -> dict:
    """The grouped compress bit for bit (fp16 payload and scales) against
    the plain version and the one-table kernel on every payload of every
    group, with the launches each grouped call made (one per 80 non-empty
    payloads) and the payloads it counted."""
    out = {}
    for case, (vs, blocks) in groups.items():
        ops.reset_launch_counts()
        got = ops.blockscale_compress_grouped(vs, blocks)
        torch.cuda.synchronize()
        launches = ops.launch_counts()["blockscale_compress"]
        served = ops.table_counts()["blockscale_compress"]
        live = sum(1 for v in vs if v.numel())
        check(launches == -(-live // 80) and served == live,
              f"blockscale_compress_grouped[{case}]: {launches} launches "
              f"and {served} payloads counted for {live} payloads")
        err = 0.0
        for k, (v, b, (c, sc)) in enumerate(zip(vs, blocks, got)):
            pc, ps = ref.blockscale_compress_ref(v, b)
            err = max(err, same_bits("blockscale_compress_grouped",
                                     f"{case}: payload {k}", c, pc),
                      same_bits("blockscale_compress_grouped",
                                f"{case}: scales {k}", sc, ps))
            if v.numel():
                oc, os_ = ops.blockscale_compress(v, b)
                same_bits("blockscale_compress_grouped", f"{case}: payload "
                          f"{k} against the one-table kernel", c, oc)
                same_bits("blockscale_compress_grouped", f"{case}: scales "
                          f"{k} against the one-table kernel", sc, os_)
        out[case] = {"payloads": len(vs), "launches": launches,
                     "max_abs_err": err}
    torch.cuda.synchronize()
    return out


def blockscale_phase(dev, ds):
    """The codec kernels against their plain versions on the card, bit for
    bit, on a real lookup's unique rows, a real put's sums and the edge
    cases; then their per-call times over 32 tables' unique rows."""
    names, batches = train_plans(dev, ds, 1, SEED + 12)
    ids_now, plans = batches[0]
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    tables = [torch.randn((V, DIM), generator=gen, device=dev) * 0.02
              for _ in range(N_TABLES)]

    def unique_rows(k):
        rows = plans[names[k]].rows
        return torch.where(rows[:, None] >= 0,
                           tables[k][rows.clamp(min=0).long()], 0)

    acts = [unique_rows(k) for k in range(N_TABLES)]
    n0 = names[0]
    mask = torch.as_tensor(ids_now[n0].reshape(-1) >= 0, device=dev)
    grads = torch.randn((mask.numel(), DIM), generator=gen, device=dev) \
        * 1e-3 * mask[:, None].float()
    sums = D.csr_segment_sum(plans[n0].order, plans[n0].offsets, grads,
                             int(plans[n0].dev.numel()))
    base = torch.randn((1024, DIM), generator=gen, device=dev) * \
        torch.exp(torch.randn((1024, 1), generator=gen, device=dev) * 4)
    edge = {"zero_block": base.clone(), "fp16_subnormal": base.clone(),
            "fp32_subnormal": base.clone()}
    edge["zero_block"][5] = 0
    # |v * s| < 6.1e-5: fp16 subnormals; a block of fp32 subnormals
    edge["fp16_subnormal"][7] = torch.randn(DIM, generator=gen,
                                            device=dev) * 1e-7
    edge["fp16_subnormal"][7, 0] = 1e3
    edge["fp32_subnormal"][3] = torch.randn(DIM, generator=gen,
                                            device=dev) * 1e-39
    cases = {"lookup_unique_rows": (acts[0], BLOCK),
             "put_sums": (sums, BLOCK),
             **{k: (v, BLOCK) for k, v in edge.items()},
             "partial_last_block": (base.reshape(-1)[:-64], BLOCK),
             "scalar_path": (base.reshape(-1)[:-63], BLOCK),
             "block_64": (base, 64)}
    errs = {k: 0.0 for k in CODEC}
    for case, (v, block) in cases.items():
        comp, sc = ops.blockscale_compress(v, block)
        pc, ps = ref.blockscale_compress_ref(v, block)
        out = ops.blockscale_decompress(comp, sc, v.shape)
        want = ref.blockscale_decompress_ref(pc, ps).reshape(-1)[
            :v.numel()].reshape(v.shape)
        torch.cuda.synchronize()
        errs["blockscale_compress"] = max(
            errs["blockscale_compress"],
            same_bits("blockscale_compress", f"{case}: payload", comp, pc),
            same_bits("blockscale_compress", f"{case}: scales", sc, ps))
        errs["blockscale_decompress"] = max(
            errs["blockscale_decompress"],
            same_bits("blockscale_decompress", case, out, want))

    # the grouped decompress on every payload of each group: the 32
    # tables' unique rows (a get) written into buffers as a put's payloads
    # are, unequal and edge-case payloads, more payloads than one launch
    # takes
    comps = [ops.blockscale_compress(a, BLOCK) for a in acts]
    rng = np.random.default_rng(SEED + 19)
    groups = {
        "stage": ([c for c, _ in comps], [sc for _, sc in comps],
                  [torch.empty(a.numel(), device=dev) for a in acts],
                  [ref.blockscale_decompress_ref(*c).reshape(-1)[
                      :a.numel()] for c, a in zip(comps, acts)]),
        "mixed": codec_group(rng, dev, CODEC_GROUP),
        f"{CHUNK_TABLES}_payloads": codec_group(rng, dev, [
            (int(rng.integers(0, 6000)), int(rng.choice([30, 64, 128])),
             str(rng.choice(["shape", "into", "misaligned"])))
            for _ in range(CHUNK_TABLES)]),
    }
    grouped = grouped_codec_checks(groups)
    del groups

    # the grouped compress on every payload of each group: the training
    # get stage (32 tables' unique rows) and put stage (32 tables' put
    # sums, one row per plan slot as _wire_begin hands them over), the wire
    # serving stage (32 tables' occurrence rows at B = 64), unequal and
    # edge-case payloads, more payloads than one launch takes
    sums_all = []
    for n in names:
        m = torch.as_tensor(ids_now[n].reshape(-1) >= 0, device=dev)
        g = torch.randn((m.numel(), DIM), generator=gen, device=dev) \
            * 1e-3 * m[:, None].float()
        sums_all.append(D.csr_segment_sum(plans[n].order, plans[n].offsets,
                                          g, int(plans[n].dev.numel())))
        del g
    serve_ids = [torch.as_tensor(bag_ids(rng, B, L, V), device=dev)
                 for _ in range(N_TABLES)]
    serve_rows = [torch.where(i[..., None] >= 0,
                              tables[k][i.clamp(min=0)], 0).contiguous()
                  for k, i in enumerate(serve_ids)]
    edge_vs, edge_blocks = compress_group(rng, dev, COMPRESS_GROUP)
    edge_vs += [v.reshape(-1) for v in edge.values()]
    edge_blocks += [BLOCK] * len(edge)
    cgroups = {
        "get_stage": (acts, [BLOCK] * N_TABLES),
        "put_stage": (sums_all, [BLOCK] * N_TABLES),
        "serve_stage": (serve_rows, [BLOCK] * N_TABLES),
        "edge": (edge_vs, edge_blocks),
        f"{CHUNK_TABLES}_payloads": compress_group(rng, dev, [
            (int(rng.integers(0, 6000)),
             int(rng.choice([20, 30, 64, 128, 200])),
             str(rng.choice(["plain", "misaligned", "nan"])))
            for _ in range(CHUNK_TABLES)]),
    }
    compressed = grouped_compress_checks(cgroups)
    del cgroups, edge_vs

    # timing: one call per table over the 32 tables, as one step's get
    # roundtrip does (the put's sums have the same shape)
    fns = {
        "blockscale_compress": {
            "ms": lambda k: ops.blockscale_compress(acts[k], BLOCK),
            "plain_ms": lambda k: ref.blockscale_compress_ref(acts[k],
                                                              BLOCK)},
        "blockscale_decompress": {
            "ms": lambda k: ops.blockscale_decompress(*comps[k]),
            "plain_ms": lambda k: ref.blockscale_decompress_ref(*comps[k]),
            # fp16 -> fp32 promotion is exact, so one true division
            "library_ms": lambda k: torch.div(comps[k][0],
                                              comps[k][1][:, None])},
    }
    timing = {}
    for name, by in fns.items():
        # compress: max|v| per block, a scale, a product and an fp16 cast;
        # no single PyTorch call does all of them
        timing[name] = {"library_ms": None}
        for key, f in by.items():
            run = lambda f=f: [f(k) for k in range(N_TABLES)]  # noqa: E731
            timing[name][key] = device_ms(run, 20) / N_TABLES
            timing[name]["eager_" + key] = eager_ms(run, 20) / N_TABLES
        nbs, nos = zip(*(codec_bound(a.numel(), BLOCK) for a in acts))
        b_bytes = float(np.mean(nbs)) / HBM_BYTES_PER_S
        b_ops = float(np.mean(nos)) / FP32_OPS_PER_S
        timing[name].update(
            bound_ms=max(b_bytes, b_ops) * 1e3,
            bound_by="bytes" if b_bytes >= b_ops else "operations",
            bound_bytes=float(np.mean(nbs)), max_abs_err=errs[name],
            rows_per_table=float(np.mean([a.shape[0] for a in acts])),
            cases=list(cases))
    # the grouped decompress, one launch for the stage's 32 tables
    cs, ss = [c for c, _ in comps], [sc for _, sc in comps]
    shapes = [a.shape for a in acts]
    stage_bound = bound_of([codec_bound(a.numel(), BLOCK) for a in acts])
    timing["blockscale_decompress"].update(
        stage_tables=N_TABLES,
        stage_ms=device_ms(lambda: ops.blockscale_decompress_grouped(
            cs, ss, shapes), 20),
        eager_stage_ms=eager_ms(lambda: ops.blockscale_decompress_grouped(
            cs, ss, shapes), 20),
        stage_library_ms=device_ms(lambda: [torch.div(c, sc[:, None])
                                            for c, sc in comps], 20),
        stage_bound_ms=stage_bound[0], stage_bound_by=stage_bound[1],
        stage_bound_bytes=float(sum(codec_bound(a.numel(), BLOCK)[0]
                                    for a in acts)),
        grouped_cases=grouped)
    # the grouped compress, one launch for the stage's 32 tables: the wire
    # serving flush's occurrence rows, a training get's unique rows and a
    # put's sums (the same rows per table as the get)
    def stage(vs):
        bound = bound_of([codec_bound(v.numel(), BLOCK) for v in vs])
        return {"ms": device_ms(lambda: ops.blockscale_compress_grouped(
                    vs, BLOCK), 20),
                "eager_ms": eager_ms(lambda: ops.blockscale_compress_grouped(
                    vs, BLOCK), 20),
                "bound_ms": bound[0], "bound_by": bound[1],
                "bound_bytes": float(sum(codec_bound(v.numel(), BLOCK)[0]
                                         for v in vs)),
                "rows_per_table": float(np.mean([v.numel() / DIM
                                                 for v in vs]))}
    serve_st, get_st, put_st = stage(serve_rows), stage(acts), \
        stage(sums_all)
    timing["blockscale_compress"].update(
        stage_tables=N_TABLES, stage_ms=serve_st["ms"],
        eager_stage_ms=serve_st["eager_ms"],
        stage_bound_ms=serve_st["bound_ms"],
        stage_bound_by=serve_st["bound_by"], stage_library_ms=None,
        train_stage_ms=get_st["ms"], train_stage_bound_ms=get_st["bound_ms"],
        train_stage_bound_by=get_st["bound_by"], put_stage_ms=put_st["ms"],
        put_stage_bound_ms=put_st["bound_ms"],
        stages={"serve": serve_st, "get": get_st, "put": put_st},
        grouped_cases=compressed)
    del tables, acts, comps, cs, ss, sums_all, serve_rows
    torch.cuda.empty_cache()
    return timing


def sgd_puts(dev, ds, gen):
    """One embedding_sgd put per table at the training shape: the unique
    physical rows of a real kwai_video put (a row two ids share once; the
    plan's -1 padding kept) with -1 and ids >= V mixed in, and the put's
    segment sums as gradients."""
    names, batches = train_plans(dev, ds, 1, SEED + 14)
    ids_now, plans = batches[0]
    puts = []
    for k, n in enumerate(names):
        rows = plans[n].rows.clone()
        live = torch.nonzero(rows >= 0).flatten()
        first = torch.ones_like(live, dtype=torch.bool)
        srt, perm = torch.sort(rows[live], stable=True)
        first[perm[1:]] = srt[1:] != srt[:-1]
        rows[live[~first]] = -1            # a shared row once
        rows[live[::9]] = -1               # padding among the live rows
        past = live[1::13]                 # past the end: no-ops
        rows[past] = V + 1 + torch.arange(past.numel(), device=dev,
                                          dtype=rows.dtype)
        mask = torch.as_tensor(ids_now[n].reshape(-1) >= 0, device=dev)
        grads = torch.randn((mask.numel(), DIM), generator=gen, device=dev) \
            * 1e-3 * mask[:, None].float()
        sums = D.csr_segment_sum(plans[n].order, plans[n].offsets, grads,
                                 int(rows.numel()))
        puts.append((rows.contiguous(), sums.contiguous()))
    return puts


def sgd_phase(dev, ds):
    """embedding_sgd against its plain version on the card, bit for bit,
    on 32 tables' puts; check_unique on a duplicate; per-call times."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    tables = [torch.randn((V, DIM), generator=gen, device=dev) * 0.02
              for _ in range(N_TABLES)]
    puts = sgd_puts(dev, ds, gen)
    err = 0.0
    for k in (0, 1):
        ids, g = puts[k]
        got = ops.embedding_sgd(tables[k].clone(), ids, g, EMB_SGD_LR)
        want = ref.embedding_sgd_ref(tables[k].clone(), ids, g,
                                     lr=EMB_SGD_LR)
        torch.cuda.synchronize()
        err = max(err, exact("embedding_sgd", f"table {k}", got, want))
        untouched = torch.ones(V, dtype=torch.bool, device=dev)
        untouched[ids[(ids >= 0) & (ids < V)].long()] = False
        check(torch.equal(got[untouched], tables[k][untouched]),
              "embedding_sgd: a row outside the put changed")
    ids, g = puts[0]
    dup = ids.clone()
    live = torch.nonzero((dup >= 0) & (dup < V)).flatten()
    dup[live[1]] = dup[live[0]]
    try:
        ops.embedding_sgd(tables[0], dup, g, EMB_SGD_LR)
        raised = False
    except ValueError:
        raised = True
    check(raised, "embedding_sgd: check_unique let a duplicate through")

    valid = [(i >= 0) & (i < V) for i, _ in puts]
    lib_args = [(i[m].long(), gr[m]) for (i, gr), m in zip(puts, valid)]

    def loop(f):
        return lambda: [f(k) for k in range(N_TABLES)]

    timing = {
        "ms": device_ms(loop(lambda k: ops.embedding_sgd(
            tables[k], *puts[k], EMB_SGD_LR, assume_unique=True)), 20)
        / N_TABLES,
        # one call per graph replay: no launch before it to overlap
        "lone_ms": device_ms(lambda: ops.embedding_sgd(
            tables[0], *puts[0], EMB_SGD_LR, assume_unique=True), LONE_REPS),
        "eager_ms": eager_ms(loop(lambda k: ops.embedding_sgd(
            tables[k], *puts[k], EMB_SGD_LR, assume_unique=True)), 20)
        / N_TABLES,
        "eager_checked_ms": eager_ms(loop(lambda k: ops.embedding_sgd(
            tables[k], *puts[k], EMB_SGD_LR)), 5) / N_TABLES,
        # the plain version selects the valid ids with a mask (a sync with
        # the host), so it cannot be captured in a graph: eager
        "plain_ms": eager_ms(loop(lambda k: ref.embedding_sgd_ref(
            tables[k], *puts[k], lr=EMB_SGD_LR)), 5) / N_TABLES,
        # index_add_ takes no -1 or past-the-end id: given the valid ids
        # (selected before the timing), as the one call
        "library_ms": device_ms(loop(lambda k: tables[k].index_add_(
            0, *lib_args[k], alpha=-EMB_SGD_LR)), 20) / N_TABLES,
    }
    # bytes: each id read once, each applied put's gradient row and table
    # row read and the row written; operations: a product and a sum per
    # applied element
    n_ids = float(np.mean([i.numel() for i, _ in puts]))
    n_live = float(np.mean([int(m.sum()) for m in valid]))
    nb, no = n_ids * 4 + n_live * DIM * 4 * 3, n_live * DIM * 2
    b_bytes, b_ops = nb / HBM_BYTES_PER_S, no / FP32_OPS_PER_S
    timing.update(bound_ms=max(b_bytes, b_ops) * 1e3,
                  bound_by="bytes" if b_bytes >= b_ops else "operations",
                  bound_bytes=nb, max_abs_err=err, ids_per_put=n_ids,
                  applied_rows_per_put=n_live)
    del tables, puts, lib_args
    torch.cuda.empty_cache()
    return timing


def floor_phase(dev) -> dict:
    """The launch floor: device ms per launch of an empty one-thread kernel
    (``ops.launch_floor``), timed as the kernels are: a chain of 32 launches
    in one CUDA graph, and one launch per graph replay; each as a plain
    launch and as a programmatic dependent (PDL)."""
    floor = {}
    for pdl, tag in ((False, ""), (True, "pdl_")):
        floor[tag + "chain_ms"] = device_ms(lambda: [
            ops.launch_floor(dev, pdl) for _ in range(N_TABLES)], 20) \
            / N_TABLES
        floor[tag + "lone_ms"] = device_ms(
            lambda: ops.launch_floor(dev, pdl), LONE_REPS)
    return floor


def flash_phase(dev):
    """flash_attention_fwd against its plain version on the card at
    granite-3-2b's prefill shape and on edge cases; per-call times beside
    the plain version and SDPA."""
    lm = get_config(LM_ARCH)
    Hq, Hkv, Dh = lm.n_heads, lm.n_kv_heads, lm.head_dim
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)

    def qkv(B, hq, hkv, Sq, Sk, dh, dtype=torch.float32, dv=None):
        return [torch.randn(s, generator=gen, device=dev).to(dtype)
                for s in ((B, hq, Sq, dh), (B, hkv, Sk, dh),
                          (B, hkv, Sk, dv or dh))]

    mla, jam = mla_shape(), get_config(HYBRID_ARCH)
    # (B, Hq, Hkv, Sq, Sk, Dh, causal, window, dtype[, Dv])
    cases = {
        "prefill": (LM_B, Hq, Hkv, LM_PROMPT, LM_PROMPT, Dh, True, 0,
                    torch.float32),
        "ragged_1000": (2, Hq, Hkv, 1000, 1000, Dh, True, 0, torch.float32),
        "window_256": (2, Hq, Hkv, 1000, 1000, Dh, True, 256,
                       torch.float32),
        "non_causal": (2, Hq, Hkv, 700, 700, Dh, False, 0, torch.float32),
        "hq_eq_hkv": (2, 8, 8, 513, 513, Dh, True, 0, torch.float32),
        "dh_96": (2, 8, 2, 300, 300, 96, True, 0, torch.float32),
        "dh_128": (2, 8, 2, 300, 300, 128, True, 0, torch.float32),
        "bf16": (2, Hq, Hkv, 1000, 1000, Dh, True, 0, torch.bfloat16),
        # q and k x30 with the scale / 900: the scores keep their range,
        # single-pass TF32 would miss the fp32 check
        "x30": (2, Hq, Hkv, 300, 300, Dh, True, 0, torch.float32),
        # bf16 rows of 24 bytes: K/V by cp.async, not TMA
        "dh_12_bf16": (2, 8, 2, 300, 300, 12, True, 0, torch.bfloat16),
        # phi3-mini's 32 / 32 heads of 96 and qwen3-14b's 40 / 8 of 128
        "phi3_dh_96": (1, 32, 32, 512, 512, 96, True, 0, torch.float32),
        "qwen3_dh_128": (1, 40, 8, 512, 512, 128, True, 0, torch.float32),
        # DeepSeek-V2-Lite's MLA prefill: 16 heads, query/key 192 (128 +
        # 64 rope), value 128; its bf16 instantiation; a ragged tile with
        # both heads padded (160 -> 192, 72 -> 128)
        "mla_prefill": (LM_B, mla["H"], mla["H"], LM_PROMPT, LM_PROMPT,
                        mla["Dqk"], True, 0, torch.float32, mla["Dv"]),
        "mla_bf16": (2, mla["H"], mla["H"], 1000, 1000, mla["Dqk"], True, 0,
                     torch.bfloat16, mla["Dv"]),
        "mla_ragged": (2, 4, 2, 1000, 777, 160, True, 0, torch.float32, 72),
        # Jamba's GQA layer: 32 / 8 heads of 128 (a group of 4)
        "jamba_prefill": (LM_B, jam.n_heads, jam.n_kv_heads, LM_PROMPT,
                          LM_PROMPT, jam.head_dim, True, 0, torch.float32),
    }
    # whisper-medium and llama-3.2-vision-90b at B=4: the encoder's
    # non-causal 1,500 frames, the cross-attention of the 2,048-token
    # prefill over 1,500 frames / 1,600 patches (non-causal, Sq != Sk, the
    # last key tile ragged), the decoder's and the vision model's causal
    # self-attention (a group of 8 at a 128-wide head), and the whisper
    # cross shape in bf16
    shapes = encdec_shapes()
    cases.update({name: (LM_B, hq, hkv, sq, sk, dh, causal, 0, dtype)
                  for name, (hq, hkv, sq, sk, dh, causal, dtype)
                  in shapes.items()})
    scale = 1.0 / math.sqrt(Dh)
    errs, err32 = {}, 0.0
    for name, (B, hq, hkv, Sq, Sk, dh, causal, window, dtype, *dv) in \
            cases.items():
        q, k, v = qkv(B, hq, hkv, Sq, Sk, dh, dtype, *dv)
        sc = 1.0 / math.sqrt(dh)
        if name == "x30":
            q, k, sc = q * 30, k * 30, sc / 900
        o, lse = ops.flash_attention_fwd(q, k, v, sc, causal, window)
        po, plse = ref.flash_attention_fwd_ref(q, k, v, sc, causal, window)
        torch.cuda.synchronize()
        e_o = float((o.float() - po.float()).abs().max())
        e_l = float((lse - plse).abs().max())
        tol = 2e-5 if dtype == torch.float32 else 4e-2
        errs[name] = {"o": e_o, "lse": e_l}
        check(math.isfinite(e_o) and e_o <= tol and e_l <= 1e-4,
              f"flash_attention_fwd[{name}]: o off by {e_o} (tol {tol}), "
              f"lse by {e_l} (tol 1e-4)")
        if dtype == torch.float32:
            err32 = max(err32, e_o)
        del q, k, v, o, lse, po, plse
    torch.cuda.empty_cache()

    B, S = LM_B, LM_PROMPT
    q, k, v = qkv(B, Hq, Hkv, S, S, Dh)
    timing = {
        "ms": device_ms(lambda: ops.flash_attention_fwd(q, k, v, scale),
                        10),
        "eager_ms": eager_ms(lambda: ops.flash_attention_fwd(q, k, v,
                                                             scale), 10),
        "plain_ms": device_ms(lambda: ref.flash_attention_fwd_ref(
            q, k, v, scale), 3),
        "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale, enable_gqa=True), 10),
    }
    # fp32-equivalent operations; at fp32 accuracy the card does them as
    # three TF32 passes (the kernel's 3xTF32), outside the tensor cores as
    # one fp32 pass (the old SIMT bound, kept beside it)
    no, nb = ops.flash_cost(q, k, v, True, 0, 0)
    b_bytes, b_ops = nb / HBM_BYTES_PER_S, 3 * no / TF32_OPS_PER_S
    timing.update(bound_ms=max(b_bytes, b_ops) * 1e3,
                  bound_by="bytes" if b_bytes >= b_ops else "operations",
                  bound_simt_ms=max(b_bytes, no / FP32_OPS_PER_S) * 1e3,
                  bound_bytes=nb, bound_ops=no, max_abs_err=err32,
                  tflops=no / (timing["ms"] * 1e-3) / 1e12,
                  errors=errs, shape={"B": B, "Hq": Hq, "Hkv": Hkv,
                                      "S": S, "Dh": Dh, "causal": True})
    # the same shape with bf16 inputs: one bf16 pass per product
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    bf16_ms = device_ms(lambda: ops.flash_attention_fwd(q, k, v, scale), 10)
    _, nb16 = ops.flash_cost(q, k, v, True, 0, 0)
    timing["bf16"] = {
        "ms": bf16_ms,
        "bound_ms": max(nb16 / HBM_BYTES_PER_S, no / BF16_OPS_PER_S) * 1e3,
        "tflops": no / (bf16_ms * 1e-3) / 1e12,
        "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale, enable_gqa=True), 10)}
    del q, k, v
    torch.cuda.empty_cache()
    # DeepSeek-V2-Lite's MLA prefill and Jamba's GQA prefill (B=4, S=2,048)
    timing["mla"] = shape_timing(qkv, LM_B, mla["H"], mla["H"], LM_PROMPT,
                                 LM_PROMPT, mla["Dqk"], True, mla["Dv"])
    timing["jamba"] = shape_timing(qkv, LM_B, jam.n_heads, jam.n_kv_heads,
                                   LM_PROMPT, LM_PROMPT, jam.head_dim, True)
    for name, (hq, hkv, sq, sk, dh, causal, dtype) in shapes.items():
        timing[name] = shape_timing(qkv, LM_B, hq, hkv, sq, sk, dh, causal,
                                    dtype=dtype)
    return timing


def encdec_shapes() -> dict:
    """The attention's shapes in whisper-medium and llama-3.2-vision-90b
    (B aside): ``name: (Hq, Hkv, Sq, Sk, Dh, causal, dtype)``."""
    w, vl = get_config(ENCDEC_ARCH), get_config(VLM_ARCH)
    e = w.encoder
    wh = (w.n_heads, w.n_kv_heads)
    return {
        "whisper_encoder": (e.n_heads, e.n_kv_heads, e.n_memory_tokens,
                            e.n_memory_tokens, e.head_dim, False,
                            torch.float32),
        "whisper_cross": (*wh, LM_PROMPT, e.n_memory_tokens, w.head_dim,
                          False, torch.float32),
        "whisper_self": (*wh, LM_PROMPT, LM_PROMPT, w.head_dim, True,
                         torch.float32),
        "vision_self": (vl.n_heads, vl.n_kv_heads, LM_PROMPT, LM_PROMPT,
                        vl.head_dim, True, torch.float32),
        "vision_cross": (vl.n_heads, vl.n_kv_heads, LM_PROMPT,
                         vl.n_memory_tokens, vl.head_dim, False,
                         torch.float32),
        "whisper_cross_bf16": (*wh, LM_PROMPT, e.n_memory_tokens,
                               w.head_dim, False, torch.bfloat16),
    }


def mla_shape() -> dict:
    """The attention shape of DeepSeek-V2-Lite's MLA (Hq = Hkv = heads;
    query/key head_dim + rope_head_dim, value v_head_dim)."""
    c = get_config(MOE_ARCH)
    return {"H": c.n_heads, "Dqk": c.head_dim + c.rope_head_dim,
            "Dv": c.v_head_dim}


def sdpa_backend(q, k, v, **kw) -> dict:
    """Which backend ``F.scaled_dot_product_attention`` picks for these
    inputs: torch's own choice and the kernels the profiler saw."""
    try:
        from torch.nn.attention import SDPBackend
        choice = SDPBackend(torch._fused_sdp_choice(
            q, k, v, None, 0.0, kw.get("is_causal", False),
            scale=kw.get("scale"))).name
    except Exception as e:                    # a private API: report why
        choice = f"unknown ({type(e).__name__})"
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        F.scaled_dot_product_attention(q, k, v, **kw)
        torch.cuda.synchronize()
    kernels = sorted(k for k, (us, _) in device_times(prof).items()
                     if us > 0)
    return {"choice": choice, "kernels": kernels[:6]}


def shape_timing(qkv, B, Hq, Hkv, Sq, Sk, dqk, causal, dv=None,
                 dtype=torch.float32) -> dict:
    """flash_attention_fwd at one shape (Sq queries over Sk keys, causal
    or not, fp32 or bf16 inputs): device ms beside its bound, the plain
    version and SDPA (the backend it picks named). The bound counts the
    pairs the mask leaves: 2 (dqk + dv) operations a pair and head, in
    three TF32 passes for fp32 inputs (the kernel's 3xTF32; the one-pass
    SIMT bound beside it) or one bf16 pass; bytes: q, k, v and o once, the
    fp32 logsumexp."""
    dv = dv or dqk
    q, k, v = qkv(B, Hq, Hkv, Sq, Sk, dqk, dtype, dv)
    scale = 1.0 / math.sqrt(dqk)
    sdpa_kw = dict(is_causal=causal, scale=scale)
    if Hq != Hkv:
        sdpa_kw["enable_gqa"] = True
    rec = {
        "ms": device_ms(lambda: ops.flash_attention_fwd(q, k, v, scale,
                                                        causal), 10),
        "plain_ms": device_ms(lambda: ref.flash_attention_fwd_ref(
            q, k, v, scale, causal), 3),
        "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, **sdpa_kw), 10),
        "library_backend": sdpa_backend(q, k, v, **sdpa_kw),
    }
    no, nb = ops.flash_cost(q, k, v, causal, 0, 0)
    fp32 = dtype == torch.float32
    b_bytes = nb / HBM_BYTES_PER_S
    b_ops = 3 * no / TF32_OPS_PER_S if fp32 else no / BF16_OPS_PER_S
    rec.update(bound_ms=max(b_bytes, b_ops) * 1e3,
               bound_by="bytes" if b_bytes >= b_ops else "operations",
               bound_ops=no, bound_bytes=nb,
               tflops=no / (rec["ms"] * 1e-3) / 1e12,
               shape={"B": B, "Hq": Hq, "Hkv": Hkv, "Sq": Sq, "Sk": Sk,
                      "Dqk": dqk, "Dv": dv, "causal": causal,
                      "dtype": str(dtype).replace("torch.", "")})
    if fp32:
        rec["bound_simt_ms"] = max(b_bytes, no / FP32_OPS_PER_S) * 1e3
    del q, k, v
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# serve phase
# ---------------------------------------------------------------------------

def kwai_trainer(dev, backend="dense"):
    ds = CTR_BENCHMARKS["kwai_video"]
    # even tables read through the dedup plan (unique_bag), odd ones at
    # occurrence width (embedding_bag), so one flush runs both kernels;
    # the compressed wire reads every table at occurrence width
    coll = adapters.ctr_collection(KWAI, field_rows=ds.field_rows()) \
        .map_specs(lambda n, s: dataclasses.replace(
            s, batch_dedup=int(n.rsplit("_", 1)[1]) % 2 == 0)) \
        .with_backend(backend)
    adapter = adapters.recsys_adapter(KWAI, collection=coll)
    return ds, PersiaTrainer(adapter, TrainMode.sync(), device=dev)


def serve(trainer, cell, reqs, config):
    """Answer ``reqs`` from N_CLIENTS threads, each submitting bursts of
    CHUNK requests; returns (predictions in request order, metrics)."""
    preds = [None] * len(reqs)
    errors = []

    def client(k):
        try:
            idx = list(range(k, len(reqs), N_CLIENTS))
            for i in range(0, len(idx), CHUNK):
                part = idx[i:i + CHUNK]
                out = svc.predict_many([reqs[j] for j in part])
                for j, p in zip(part, out):
                    preds[j] = p
        except Exception as e:   # noqa: BLE001 — reported below
            errors.append(repr(e))

    svc = ServingService(trainer, cell, config).start()
    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(N_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        check(not any(th.is_alive() for th in threads),
              "serving clients did not finish")
    finally:
        svc.stop()
    check(not errors, f"serving clients failed: {errors[:3]}")
    return np.stack(preds), svc.metrics()


def stack(reqs):
    return {"ids": np.stack([r["ids"] for r in reqs]),
            "dense": np.stack([r["dense"] for r in reqs])}


def flush_breakdown(trainer, state, batch, reps: int = 20) -> dict:
    """Where one full flush (64 requests) spends its time: host wall ms of
    the pooled read (32 tables: plan, index copies, kernel) and of the
    FFNN, each ended by a synchronize, and the share of the flush's wall
    time in which the device ran work (kernel and copy times summed by the
    profiler over a second, profiled set of flushes)."""
    lookup_ms, predict_ms = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pooled, _ = trainer.serve_lookup(state, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.adapter.predict(state.dense, pooled, batch).cpu()
        t2 = time.perf_counter()
        lookup_ms.append((t1 - t0) * 1e3)
        predict_ms.append((t2 - t1) * 1e3)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            pooled, _ = trainer.serve_lookup(state, batch)
            trainer.adapter.predict(state.dense, pooled, batch).cpu()
    busy_us = device_us(prof)
    flush_ms = float(np.median(lookup_ms) + np.median(predict_ms))
    return {"lookup_ms": float(np.median(lookup_ms)),
            "predict_ms": float(np.median(predict_ms)),
            "device_ms": busy_us / 1e3 / reps,
            "device_busy_share": busy_us / 1e3 / reps / flush_ms}


def plain_predict(trainer, state, batch):
    """Predictions through the plain lookup: the gather of each table's
    occurrence rows (no kernel), the plain codec for a compressed table,
    the plain pool."""
    ids = trainer.adapter.emb_ids(batch)
    pooled = {}
    for n, b in trainer.backends.items():
        rows, _ = BK.unwrap(b).read_rows(state.emb[n], ids[n])
        if isinstance(b, BK.CompressedWireBackend):
            rows = C.blockscale_roundtrip(rows, BLOCK)
        pooled[n] = pool_bag(rows, ids[n])
    return trainer.adapter.predict(state.dense, pooled, batch).cpu().numpy()


def serve_phase(dev, backend="dense"):
    ds, trainer = kwai_trainer(dev, backend)
    wire = backend != "dense"
    state = trainer.init(seed=SEED)
    cell = StateCell(state, 0)
    reqs = [r for _, r in TrafficModel.for_dataset(ds, seed=SEED)
            .requests(N_REQUESTS, seed=1)]
    config = ServingConfig(max_batch=64, max_wait_ms=2.0)
    serve(trainer, cell, reqs[:128], config)             # warm-up
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    preds, m = serve(trainer, cell, reqs, config)
    launches, served = ops.launch_counts(), ops.table_counts()

    # per flush: ONE bag launch for every table (counted on unique_bag when
    # it pools a plan table, on embedding_bag otherwise) and, behind the
    # wire, ONE compress and ONE decompress; each kind's tables counted
    n_plan = 0 if wire else \
        sum(s.batch_dedup for _, s in trainer.collection.items())
    n_flat = len(trainer.collection) - n_plan
    n_wire = len(trainer.collection) if wire else 0
    flushes = int(m["serving/batches"])
    check(int(m["serving/requests"]) == N_REQUESTS
          and m["serving/errors"] == 0, f"service metrics {m}")
    want = {"unique_bag": int(n_plan > 0) * flushes,
            "embedding_bag": int(n_plan == 0 and n_flat > 0) * flushes,
            "blockscale_compress": int(n_wire > 0) * flushes,
            "blockscale_decompress": int(n_wire > 0) * flushes}
    want_tables = {"embedding_bag": n_flat * flushes,
                   "unique_bag": n_plan * flushes,
                   "blockscale_compress": n_wire * flushes,
                   "blockscale_decompress": n_wire * flushes}
    check(all(launches[k] == v for k, v in want.items())
          and served == want_tables,
          f"launches {launches} (tables {served}) != {want} (tables "
          f"{want_tables}): one launch per grouped kernel and flush "
          f"({flushes} flushes, {n_plan} plan / {n_flat} flat / "
          f"{n_wire} compressed tables)")
    check(preds.shape == (N_REQUESTS, KWAI.n_tasks), f"shape {preds.shape}")
    check(bool(np.all(np.isfinite(preds))) and preds.min() > 0
          and preds.max() < 1, "predictions not finite in (0, 1)")

    # the same requests through the plain lookup (gather, plain codec,
    # pool, no kernel) at another batch shape: cuBLAS may pick another
    # reduction order for another M, hence allclose and not equality
    batch = stack(reqs)
    plain = plain_predict(trainer, state, batch)
    via_kernels = trainer.predict(state, batch).cpu().numpy()
    diff = float(np.abs(preds - plain).max())
    check(np.allclose(preds, plain, rtol=1e-5, atol=1e-6),
          f"served predictions differ from the plain lookup by {diff}")
    check(np.allclose(via_kernels, plain, rtol=1e-5, atol=1e-6),
          "trainer.predict differs from the plain lookup")

    breakdown = flush_breakdown(trainer, state, stack(reqs[:64]))
    rec = {
        "phase": "serve", "model": KWAI.name, "backend": backend,
        "tables": len(state.emb),
        "table_rows": int(state.emb["field_00"]["table"].shape[0]),
        "emb_dim": KWAI.emb_dim,
        "mlp": [int(lyr["w"].shape[0]) for lyr in state.dense["mlp"]]
        + [KWAI.n_tasks],
        "requests": N_REQUESTS, "clients": N_CLIENTS, "max_batch": 64,
        "flushes": flushes, "fill": m["serving/field_00/batch_fill"],
        "p50_ms": m["serving/p50_ms"], "p99_ms": m["serving/p99_ms"],
        "qps": m["serving/qps"], "max_abs_diff_vs_plain": diff,
        "flush": breakdown,
        "tables_per_launch": tables_per_launch(launches, served),
    }
    if wire:
        return (launches, served), rec

    eb = next(ds.sampler(1024, seed=2))
    em = trainer.eval(state, eb)
    ep = trainer.predict(state, eb).cpu().numpy()
    aucs = [adapters.auc(eb["labels"][:, t], ep[:, t])
            for t in range(KWAI.n_tasks)]
    loss = float(em["loss"])
    check(np.isfinite(loss) and ep.shape == (1024, KWAI.n_tasks),
          "eval not finite")
    return (launches, served), {**rec, "eval_rows": 1024, "eval_loss": loss,
                      "eval_pred_mean": float(em["pred_mean"]),
                      "eval_auc_per_task": aucs}


# ---------------------------------------------------------------------------
# train phase
# ---------------------------------------------------------------------------

def kwai_train_trainer(dev, mode, backend="dense", batch_dedup=None,
                       disk_path=None, shards=1, rows=None):
    """kwai-dlrm's trainer; a host_lru backend gets the launchers' cache
    (``default_cache_rows``) and, under ``+disk``, a host tier of
    ``LRU_HOST_ROWS`` over mmap files in a directory of ``disk_path`` per
    table. ``shards > 1`` puts every table on the sharded router;
    ``rows`` overrides the tables' row count (the data's ids stay below
    kwai_video's 62,500)."""
    ds = CTR_BENCHMARKS["kwai_video"]
    field_rows = ds.field_rows() if rows is None \
        else (rows,) * len(ds.field_rows())
    adapter = adapters.recsys_adapter(KWAI, lr=EMB_LR, field_rows=field_rows)
    cache = default_cache_rows(ds.rows_per_field) \
        if backend.startswith(HOST_LRU) else None
    coll = adapter.collection.with_backend(backend, cache)
    if shards > 1:
        coll = coll.with_shards(shards)
    if "+disk" in backend:
        coll = coll.map_specs(lambda n, s: dataclasses.replace(
            s, host_rows=LRU_HOST_ROWS, disk_path=str(Path(disk_path) / n)))
    adapter = dataclasses.replace(adapter, collection=coll)
    return PersiaTrainer(adapter, mode, OptConfig(kind="adam", lr=DENSE_LR),
                         batch_dedup=batch_dedup, device=dev)


def step_launches(trainer) -> tuple[dict, dict]:
    """The launches one train step makes, by kernel, and the tables the
    grouped kernels serve. The get: ONE bag launch for every table, plan
    (``unique_bag``) and occurrence-width (``embedding_bag``) tables alike,
    counted on ``unique_bag`` when it pools a plan table. The put: one
    ``fused_backward`` per table (two behind the wire in sync mode, where
    the sums cross the wire between their sum and their apply; 1 + k on
    the k-shard router: one sum-only and one apply-only a shard). Behind
    the
    wire, ONE compress and ONE decompress for all the tables, for the get
    and for the put."""
    want = dict.fromkeys(ops.launch_counts(), 0)
    tables = dict.fromkeys(ops.table_counts(), 0)
    for b in trainer.backends.values():
        wire = isinstance(b, BK.CompressedWireBackend)
        inner = BK.unwrap(b)
        tables["unique_bag" if b.spec.batch_dedup else "embedding_bag"] += 1
        if b.remote:
            # a remote table: the sum-only launch here, the apply-only one
            # in each of its PS shards (counted here when they are threads
            # of this process); its lossy wire is the numpy codec
            want["fused_backward"] += 1 + getattr(b, "n_shards", 1)
            continue
        if isinstance(inner, BK.ShardedBackend):
            # the router: one sum-only launch, one apply-only per shard
            want["fused_backward"] += 1 + inner.n_shards
            continue
        want["fused_backward"] += 2 if wire and b.spec.staleness == 0 else 1
        for k in CODEC:
            tables[k] += 2 if wire else 0
    owner = "unique_bag" if tables["unique_bag"] else "embedding_bag"
    want[owner] = int(tables[owner] > 0)
    for k in CODEC:
        want[k] = 2 * int(tables[k] > 0)
    return want, tables


def tables_per_launch(launches, served) -> dict:
    return {k: served[k] / launches[k] if launches[k] else 0.0
            for k in served}


def staged_step(trainer, state, batch, times):
    """``trainer.step`` cut at its stage boundaries (the composition of
    ``PersiaTrainer.train_step``), with a synchronize at each so the host
    wall ms of every stage lands in ``times``."""
    lookup_fn, dense_step, emb_put = trainer.decomposed_fns()
    marks = [time.perf_counter()]

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    state, dev_ids, _ = trainer._prepare(state, batch)
    mark()
    pooled, _ = lookup_fn(state.emb, dev_ids)
    mark()
    dense, opt, dq, agrads, m = dense_step(state.dense, state.opt,
                                           state.dense_queue, pooled, batch,
                                           state.step)
    mark()
    emb, queues, _ = emb_put(state.emb, state.emb_queue, dev_ids, agrads)
    mark()
    for k, a, b in zip(("prepare_ms", "lookup_ms", "dense_ms", "put_ms"),
                       marks, marks[1:]):
        times.setdefault(k, []).append((b - a) * 1e3)
    return state.replace(dense=dense, opt=opt, emb=emb, emb_queue=queues,
                         dense_queue=dq, step=state.step + 1), m


def parts(tree) -> list:
    """A table's state or queue as its parts: itself, or a router's
    per-shard ones (``"s0"``, ...)."""
    if tree is None or "s0" not in tree:
        return [tree]
    return [tree[f"s{s}"] for s in range(len(tree))]


def check_rings(trainer, state, steps, what):
    """The staleness queues' and the dense delay queue's ring pointers
    after ``steps`` steps from empty (every shard's, on a router)."""
    for n, q in state.emb_queue.items():
        tau = trainer.collection[n].staleness
        want = None if tau == 0 else (steps % tau, min(steps, tau))
        for p in parts(q):
            got = None if p is None else (p["ptr"], p["filled"])
            check(got == want, f"{what}: {n} queue ring {got}, want {want}")
    tau_d = trainer.mode.dense_staleness
    dq = state.dense_queue
    got = None if dq is None else (dq["ptr"], dq["filled"])
    want = None if tau_d == 0 else (steps % tau_d, min(steps, tau_d))
    check(got == want, f"{what}: dense queue ring {got}, want {want}")


def run_steps(trainer, state, batches, what):
    """Steps with the launch counts read around them: every step must make
    the launches ``step_launches`` names. Returns the state, the losses,
    the launch counts, the wire's bytes summed over the steps and the
    tables the grouped kernels served."""
    ops.reset_launch_counts()
    losses, wire = [], {"bytes_raw": 0.0, "bytes_wire": 0.0}
    for b in batches:
        state, m = trainer.step(state, b)
        losses.append(m["loss"])
        for k, v in m.items():
            if k.startswith("wire/"):
                wire["bytes_raw" if k.endswith("_raw") else
                     "bytes_wire"] += float(v)
    for n, bk in trainer.backends.items():
        if bk.remote:
            bk.sync(state.emb[n])     # its PS has applied every put
    torch.cuda.synchronize()
    launches, served = ops.launch_counts(), ops.table_counts()
    per_step, tables = step_launches(trainer)
    want = {k: v * len(batches) for k, v in per_step.items()}
    want_tables = {k: v * len(batches) for k, v in tables.items()}
    check(launches == want and served == want_tables,
          f"{what}: launches {launches} (tables {served}), want {want} "
          f"(tables {want_tables})")
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"{what}: losses {losses}")
    return state, losses, launches, wire, served


def dense_agreement(start, a, b, steps) -> dict:
    """Card (``a``) against CPU (``b``) dense parameters, through their
    updates from the shared ``start``. Adam moves every weight by about lr
    a step whatever its gradient's size, so a weight whose gradient is near
    zero or near eps moves differently on the two devices: the updates must
    agree in norm to 1e-3 and no weight may differ by more than 2 lr per
    step (``ok``). The count of weights off by more than rtol 1e-4 / atol
    1e-6 is reported."""
    n, off, worst, diff2, upd2 = 0, 0, 0.0, 0.0, 0.0
    for w0, x, y in zip(tree_leaves(start), tree_leaves(a), tree_leaves(b)):
        y, w0 = y.to(x.device), w0.to(x.device)
        off += int((~torch.isclose(x, y, rtol=1e-4, atol=1e-6)).sum())
        n += x.numel()
        worst = max(worst, float((x - y).abs().max()))
        diff2 += float(((x - y).double() ** 2).sum())
        upd2 += float(((y - w0).double() ** 2).sum())
    rel = (diff2 / max(upd2, 1e-300)) ** 0.5
    return {"ok": rel <= 1e-3 and worst <= 2 * DENSE_LR * steps + 1e-6,
            "dense_params": n, "dense_off": off, "dense_max_abs": worst,
            "dense_update_rel": rel}


def card_vs_cpu(dev, ds, backend="dense",
                runs=((TrainMode.sync(), 2), (TrainMode.hybrid(TAU), 5))
                ) -> dict:
    """The same steps from one starting state on the card (kernels) and on
    the CPU (plain versions), per (mode, steps) run. Every comparison is
    recorded and printed before the first disagreement fails the run.

    Behind the wire (``backend`` not dense) the gets and puts are rounded
    to fp16, and the card's and the CPU's values differ in their last bits
    (the FFNN's class), so now and then one lands on the other side of an
    fp16 rounding boundary and moves by one fp16 step, 2^-11 of its
    block's largest element; through the steps that follow such a step
    moves other values too. There the tables and accumulators are held as
    ``dense_agreement`` holds the dense parameters: their updates must
    agree to 1e-3 in norm, and at most 1% of the elements may leave the
    dense tolerance."""
    it = ds.sampler(TRAIN_B, seed=SEED + 20)
    n_batches = max(steps for _, steps in runs)
    batches = [next(it) for _ in range(n_batches)]
    wire = backend != "dense"
    out, bad = {"backend": backend}, []
    for mode, steps in runs:
        tg = kwai_train_trainer(dev, mode, backend)
        tc = kwai_train_trainer("cpu", mode, backend)
        sg = tg.init(seed=SEED + 1, batch_example=batches[0])
        sc = sg.to("cpu")
        start = tree_map(torch.clone, sc.dense)  # updated in place
        start_emb = sg.to("cpu").emb if wire else None   # updated in place
        lg, lc = [], []
        for b in batches[:steps]:
            sg, mg = tg.step(sg, b)
            sc, mc = tc.step(sc, b)
            lg.append(float(mg["loss"]))
            lc.append(float(mc["loss"]))
        if not np.allclose(lg, lc, rtol=1e-4):
            bad.append(f"{mode.name}: losses card {lg} cpu {lc}")
        err = {"table": 0.0, "acc": 0.0, "queue_rel": 0.0}
        lossy = {"table_off": 0, "acc_off": 0, "table_update_rel": 0.0,
                 "acc_update_rel": 0.0}
        for n in tg.collection.names:
            for k, rtol, atol in (("table", 1e-4, 1e-6),
                                  ("acc", 1e-3, 1e-12)):
                x, y = sg.emb[n][k], sc.emb[n][k].to(dev)
                d = float((x - y).abs().max())
                err[k] = max(err[k], d)
                off = ~torch.isclose(x, y, rtol=rtol, atol=atol)
                ok = not bool(off.any())
                if wire:
                    upd = y - start_emb[n][k].to(dev)
                    rel = float((x - y).double().norm()
                                / upd.double().norm().clamp(min=1e-300))
                    lossy[f"{k}_off"] += int(off.sum())
                    lossy[f"{k}_update_rel"] = max(
                        lossy[f"{k}_update_rel"], rel)
                    ok = rel <= 1e-3 and float(off.float().mean()) <= 0.01
                if not ok:
                    bad.append(f"{mode.name}: {n}.{k} differs by {d}")
            qg, qc = sg.emb_queue[n], sc.emb_queue[n]
            if qg is None:
                continue
            if not (torch.equal(qg["ids"], qc["ids"].to(dev))
                    and (qg["ptr"], qg["filled"]) ==
                    (qc["ptr"], qc["filled"])):
                bad.append(f"{mode.name}: {n} queue ids/ring differ")
            # the payloads are gradients through the dense parameters,
            # which drift apart as dense_agreement allows (up to 1e-3 of
            # their update), and sum a unique id's occurrences, which may
            # cancel: compared to 1e-3 of the largest payload element (one
            # fp16 step of the wire is at most 2^-11 of it)
            x, y = qg["grads"], qc["grads"].to(dev)
            scale = float(y.abs().max())
            d = float((x - y).abs().max())
            err["queue_rel"] = max(err["queue_rel"], d / scale)
            if not torch.allclose(x, y, rtol=1e-3, atol=1e-3 * scale):
                bad.append(f"{mode.name}: {n} queue grads differ by {d} "
                           f"(largest {scale})")
        dense = dense_agreement(start, sg.dense, sc.dense, steps)
        if not dense.pop("ok"):
            bad.append(f"{mode.name}: dense {dense}")
        out[mode.name] = {"steps": steps, "loss_card": lg, "loss_cpu": lc,
                          "table_max_abs": err["table"],
                          "acc_max_abs": err["acc"],
                          "queue_max_rel_to_largest": err["queue_rel"],
                          **(lossy if wire else {}),
                          **dense}
        del sg, sc, tg, tc, start_emb
        torch.cuda.empty_cache()
    emit({"phase": "card_vs_cpu", **out})
    check(not bad, "card against CPU: " + "; ".join(bad[:6]))
    return out


def train_phase(dev, backend="dense", timed=TIMED_STEPS,
                breakdown=BREAKDOWN_STEPS, profiled=PROFILED_STEPS,
                mode_steps=4):
    ds = CTR_BENCHMARKS["kwai_video"]
    it = ds.sampler(TRAIN_B, seed=SEED + 3)
    n_main = WARMUP_STEPS + timed + breakdown + profiled
    batches = [next(it) for _ in range(n_main)]
    trainer = kwai_train_trainer(dev, TrainMode.hybrid(TAU), backend)
    state = trainer.init(seed=SEED, batch_example=batches[0])
    for b in batches[:WARMUP_STEPS]:
        state, _ = trainer.step(state, b)
    torch.cuda.synchronize()

    # the main path: timed steps, counts set to 0 just before
    t0 = time.perf_counter()
    state, losses, launches, wire, served = run_steps(
        trainer, state, batches[WARMUP_STEPS:WARMUP_STEPS + timed],
        f"{backend} hybrid")
    main_counts = (launches, served)
    wall = time.perf_counter() - t0
    step_ms = wall * 1e3 / timed

    times = {}
    rest = batches[WARMUP_STEPS + timed:]
    for b in rest[:breakdown]:
        state, _ = staged_step(trainer, state, b, times)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for b in rest[breakdown:]:
            state, _ = trainer.step(state, b)
        torch.cuda.synchronize()
    device_ms = device_us(prof) / 1e3 / profiled
    check_rings(trainer, state, n_main, f"{backend} hybrid")
    ratio = None
    if backend != "dense":
        ratio = wire["bytes_raw"] / wire["bytes_wire"]
        check(ratio >= 1.8, f"{backend}: wire byte ratio {ratio} < 1.8")

    eb = next(ds.sampler(4096, seed=SEED + 4))
    em = trainer.eval(state, eb)
    ep = trainer.predict(state, eb).cpu().numpy()
    aucs = [adapters.auc(eb["labels"][:, t], ep[:, t])
            for t in range(KWAI.n_tasks)]
    check(np.isfinite(float(em["loss"])) and np.all(np.isfinite(ep)),
          "eval not finite")
    del state, trainer
    torch.cuda.empty_cache()

    modes = {}
    for mode in (TrainMode.sync(), TrainMode.async_(TAU, TAU)):
        tr = kwai_train_trainer(dev, mode, backend)
        it = ds.sampler(TRAIN_B, seed=SEED + 5)
        bs = [next(it) for _ in range(mode_steps)]
        st = tr.init(seed=SEED, batch_example=bs[0])
        st, ls, mlaunch, _, _ = run_steps(tr, st, bs,
                                          f"{backend} {mode.name}")
        check_rings(tr, st, mode_steps, mode.name)
        modes[mode.name] = {"steps": mode_steps, "losses": ls,
                            "launches": mlaunch}
        del st, tr
        torch.cuda.empty_cache()

    rec = {
        "phase": "train", "model": KWAI.name, "dataset": "kwai_video",
        "backend": backend, "batch": TRAIN_B, "mode": f"hybrid({TAU})",
        "dense_lr": DENSE_LR, "emb_lr": EMB_LR, "timed_steps": timed,
        "step_ms": step_ms, "steps_per_s": timed / wall,
        "samples_per_s": timed * TRAIN_B / wall,
        "launches_per_step": {k: v / timed for k, v in launches.items()},
        "tables_per_launch": tables_per_launch(launches, served),
        "breakdown_ms": {k: float(np.median(v)) for k, v in times.items()},
        "device_ms_per_step": device_ms,
        "device_busy_share": device_ms / step_ms,
        "loss_first": losses[0], "loss_last": losses[-1],
        "steps_total": n_main, "eval_rows": 4096,
        "eval_loss": float(em["loss"]), "eval_auc_per_task": aucs,
        "other_modes": modes,
    }
    if ratio is not None:
        rec.update(wire_bytes=wire, wire_ratio=ratio)
    return main_counts, rec


def flat_train_phase(dev, steps=4, profiled=2):
    """hybrid(3) with every table at occurrence width (batch_dedup=False):
    the lookup through ``embedding_bag`` (one bag launch for the 32
    tables), the put grouped on the card and applied by
    ``fused_backward``; then ``profiled`` steps under the profiler."""
    ds = CTR_BENCHMARKS["kwai_video"]
    trainer = kwai_train_trainer(dev, TrainMode.hybrid(TAU),
                                 batch_dedup=False)
    it = ds.sampler(TRAIN_B, seed=SEED + 6)
    batches = [next(it) for _ in range(steps + profiled)]
    state = trainer.init(seed=SEED, batch_example=batches[0])
    t0 = time.perf_counter()
    state, losses, launches, _, served = run_steps(trainer, state,
                                                   batches[:steps],
                                                   "flat hybrid")
    wall = time.perf_counter() - t0
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for b in batches[steps:]:
            state, _ = trainer.step(state, b)
        torch.cuda.synchronize()
    device_ms = device_us(prof) / 1e3 / profiled
    check_rings(trainer, state, steps + profiled, "flat hybrid")
    width = int(state.emb_queue["field_00"]["ids"].shape[1])
    check(width == TRAIN_B * L, f"flat queue width {width}")
    del state, trainer
    torch.cuda.empty_cache()
    return (launches, served), {"phase": "train_flat", "model": KWAI.name,
                      "batch": TRAIN_B, "mode": f"hybrid({TAU})",
                      "steps": steps, "step_ms": wall * 1e3 / steps,
                      "device_ms_per_step": device_ms,
                      "queue_width": width, "losses": losses,
                      "launches_per_step": {k: v / steps
                                            for k, v in launches.items()},
                      "tables_per_launch": tables_per_launch(launches,
                                                             served)}


# ---------------------------------------------------------------------------
# LM serving: granite-3-2b
# ---------------------------------------------------------------------------

def sgd_entry_path(dev):
    """The embedding_sgd entry point, once: a unique put of 694 rows on a
    62,500 x 128 table through ``ops.embedding_sgd`` (``check_unique``
    first), held against the plain version."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    table = torch.randn((V, DIM), generator=gen, device=dev) * 0.02
    ids = torch.randperm(V, generator=gen, device=dev)[:694].int()
    grads = torch.randn((694, DIM), generator=gen, device=dev) * 1e-3
    want = ref.embedding_sgd_ref(table.clone(), ids, grads, lr=EMB_SGD_LR)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    ops.embedding_sgd(table, ids, grads, EMB_SGD_LR)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check(launches["embedding_sgd"] == 1, f"sgd entry launches {launches}")
    exact("embedding_sgd", "entry point", table, want)
    return (launches, ops.table_counts()), {
        "phase": "sgd_entry", "rows": 694, "table": [V, DIM],
        "launches": launches["embedding_sgd"]}


def lm_state(cfg, dev, seed, backend="dense"):
    """Random granite weights and vocab table from a seeded generator on
    ``dev``: (backend, emb state, dense params)."""
    spec = build_embedding_spec(cfg.vocab_size, cfg.d_model,
                                backend=backend)
    bk = BK.create_backend(spec)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dense = lm_model.init_dense(cfg, gen)
    return bk, bk.init(gen), dense


def open_gates(dense, value=XGATE):
    """Every ``cross_attn`` block's ``xgate`` set to ``value`` in place:
    at its init value 0, tanh(0) = 0 would hide the whole cross-attention
    branch."""
    blocks = [p for name, p in dense.items() if name.startswith("prologue")]
    for p in blocks + list(dense["stack"].values()):
        if "xgate" in p:
            p["xgate"].fill_(value)
    return dense


def plain_attention(q, k, v, **kw):
    """The plain full-sequence attention in the place of the kernel."""
    return lm_layers._attn_naive(q, k, v, **kw)


def lm_generate(cfg, bk, emb, dense, prompts, gen, memory=None):
    """Greedy generation through the serving functions (over ``memory``
    for a model with cross-attention), keeping every step's logits:
    (prefill logits (B, vocab), [decode logits], tokens)."""
    emb, logits, caches = lm_serve.prefill_step(
        cfg, bk, emb, dense, prompts, prompts.shape[1] + gen, memory)
    first = logits[:, 0, :cfg.vocab_size]
    tok = torch.argmax(first, dim=-1)[:, None].int()
    steps, toks = [], [tok]
    for _ in range(gen - 1):
        emb, lg, caches = lm_serve.decode_token(cfg, bk, emb, dense, tok,
                                                caches)
        steps.append(lg)
        tok = torch.argmax(lg, dim=-1)[:, None].int()
        toks.append(tok)
    return first, steps, torch.cat(toks, dim=1)


def lm_serve_phase(dev):
    """``launch.serve.serve`` at the full granite-3-2b width, B=4, prompt
    2,048, 32 greedy tokens: 40 flash_attention_fwd launches per prefill,
    finite logits equal to the plain attention's on the card, timings and
    the device-busy share under the profiler."""
    cfg = get_config(LM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    bk, emb, dense = lm_state(cfg, dev, SEED)
    state = (emb, dense)
    n_dense = sum(t.numel() for t in tree_leaves(dense))
    lm_serve.serve(cfg, LM_B, LM_PROMPT, 2, SEED, device=dev, state=state)
    torch.cuda.synchronize()

    # the main path: counts set to 0 just before
    ops.reset_launch_counts()
    res = lm_serve.serve(cfg, LM_B, LM_PROMPT, LM_GEN, SEED, device=dev,
                         state=state)
    launches, served = ops.launch_counts(), ops.table_counts()
    n_layers = cfg.n_layers
    check(launches["flash_attention_fwd"] == n_layers,
          f"lm serve: {launches['flash_attention_fwd']} flash_attention_fwd "
          f"launches, want {n_layers} (one prefill)")
    toks = res["tokens"]
    check(toks.shape == (LM_B, LM_GEN) and toks.min() >= 0
          and toks.max() < cfg.vocab_size, f"lm serve tokens {toks.shape}")

    # the prefill's last-token logits through the kernel and through the
    # plain attention, on the card
    vs_plain = prefill_vs_plain(dev, cfg, bk, emb, dense, toks[:, 0], "lm")

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prof_res = lm_serve.serve(cfg, LM_B, LM_PROMPT, LM_GEN, SEED,
                                  device=dev, state=state)
        wall = time.perf_counter() - t0
    device_s = device_us(prof) / 1e6
    check(np.array_equal(prof_res["tokens"], toks),
          "lm serve: a second run gave other tokens")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del bk, emb, dense, state
    torch.cuda.empty_cache()
    ms_tok = res["decode_s"] * 1e3 / (LM_GEN - 1)
    return (launches, served), {
        "phase": "lm_serve", "model": cfg.name, "layers": n_layers,
        "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads,
                                          cfg.head_dim],
        "vocab": [cfg.vocab_size, cfg.padded_vocab],
        "dense_params": n_dense, "dense_gb": n_dense * 4 / 1e9,
        "batch": LM_B, "prompt": LM_PROMPT, "gen": LM_GEN,
        "prefill_ms": res["prefill_s"] * 1e3, "ms_per_token": ms_tok,
        "decode_tok_per_s": res["decode_tok_per_s"],
        "flash_launches_per_prefill": launches["flash_attention_fwd"],
        **vs_plain, "profiled_wall_s": wall, "profiled_device_s": device_s,
        "device_busy_share": device_s / wall, "peak_gib": peak,
        "first_tokens": toks[0, :8].tolist()}


def lm_card_vs_cpu(dev):
    """The full-width granite model cut to 2 layers, from one starting
    state (drawn on the CPU, copied to the card) on the card and on the
    CPU: prefill and decode logits within rtol 1e-4 / atol 1e-5 and equal
    greedy tokens. Before the check, the card's error is split: the same
    run on the card with the plain attention in the kernel's place gives
    what the fp32 GEMMs alone leave (card, plain attention, against the
    CPU), and how far the kernel moves the logits from the plain attention
    on the card is what the attention adds."""
    cfg = get_config(LM_ARCH).replace(pattern_repeats=LM_CPU["layers"])
    bk, emb, dense = lm_state(cfg, torch.device("cpu"), SEED + 1)
    prompts = torch.as_tensor(lm_serve.make_prompts(
        cfg, LM_CPU["batch"], LM_CPU["prompt"], SEED + 1))

    def run(d):
        e = {k: t.to(d) for k, t in emb.items()}
        p = tree_map(lambda t: t.to(d), dense)
        first, steps, toks = lm_generate(cfg, bk, e, p, prompts.to(d),
                                         LM_CPU["gen"])
        return [first.cpu()] + [x.cpu() for x in steps], toks.cpu()

    (lg, tg), (lc, tc) = run(dev), run(torch.device("cpu"))
    with mock.patch.object(lm_flash, "flash_attention", plain_attention):
        lp, _ = run(dev)
    errs = [float((a - b).abs().max()) for a, b in zip(lg, lc)]
    split = {"phase": "lm_card_vs_cpu_split",
             "gemms_alone_max_abs": max(float((a - b).abs().max())
                                        for a, b in zip(lp, lc)),
             "kernel_vs_plain_attention_max_abs": max(
                 float((a - b).abs().max()) for a, b in zip(lg, lp)),
             "card_vs_cpu_max_abs": max(errs)}
    emit(split)
    ok = all(torch.allclose(a, b, rtol=1e-4, atol=1e-5)
             for a, b in zip(lg, lc))
    rec = {"phase": "lm_card_vs_cpu", **LM_CPU, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "logit_max_abs_by_step": errs,
           "tokens_card": tg.tolist(), "tokens_cpu": tc.tolist(),
           "error_split": split}
    emit(rec)
    check(ok, f"lm card against CPU: logits differ by {max(errs)}")
    check(torch.equal(tg, tc), "lm card against CPU: greedy tokens differ")
    return rec


# ---------------------------------------------------------------------------
# DeepSeek-V2 serving: MLA and the MoE FFN at deepseek-v2-lite-16b's width
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def record_routing():
    """Every MoE call's ``(probs, topi)`` while the block runs, in call
    order (the port's ``moe.router_topk`` wrapped)."""
    calls = []
    orig = lm_moe.router_topk

    def wrapped(logits, k):
        out = orig(logits, k)
        calls.append((out[0].detach(), out[2].detach()))
        return out

    with mock.patch.object(lm_moe, "router_topk", wrapped):
        yield calls


def routing_flips(ref_calls, calls, k) -> dict:
    """Where two runs' MoE calls chose other experts (or another order) for
    a token: the (layer, token) choices that differ, the smallest top-k
    boundary gap among them (the least gap between neighbours of the
    reference run's k + 1 largest probabilities), the first call that
    differs and the largest gap of its differing tokens."""
    check(len(ref_calls) == len(calls),
          f"routing: {len(calls)} MoE calls against {len(ref_calls)}")
    n, gaps, first, first_max = 0, [], None, None
    for i, ((pa, ia), (_, ib)) in enumerate(zip(ref_calls, calls)):
        d = (ia.cpu() != ib.cpu()).any(-1)
        if not bool(d.any()):
            continue
        top = torch.sort(pa.cpu()[d].double(), dim=-1,
                         descending=True).values[:, :k + 1]
        g = (top[:, :-1] - top[:, 1:]).min(dim=-1).values
        if first is None:
            first, first_max = i, float(g.max())
        gaps.append(float(g.min()))
        n += int(d.sum())
    return {"calls": len(calls), "tokens": int(calls[0][1].shape[0])
            if calls else 0, "flipped": n,
            "min_gap": min(gaps) if gaps else None, "first_call": first,
            "first_call_max_gap": first_max}


def flip_note(flips: dict) -> str:
    if not flips["flipped"]:
        return "no routing choice differs"
    small = flips["min_gap"] < FLIP_GAP
    return (f"{flips['flipped']} (layer, token) routing choices differ, "
            f"the smallest top-k gap among them {flips['min_gap']:.3g}"
            + (f" (under {FLIP_GAP}: rounding alone can flip them)"
               if small else ""))


def moe_weight_bytes(cfg, dense) -> dict:
    """The dense weights' bytes (all of them read by a decode step: the
    capacity dispatch runs every expert) and the routed experts' share."""
    total = sum(t.numel() * t.element_size() for t in tree_leaves(dense))
    experts = sum(dense["stack"][str(i)]["ffn"][w].numel()
                  * dense["stack"][str(i)]["ffn"][w].element_size()
                  for i, blk in enumerate(cfg.pattern) if blk.ffn == "moe"
                  for w in ("wg", "wu", "wd"))
    return {"weight_bytes": total, "expert_bytes": experts,
            "decode_bound_ms": total / HBM_BYTES_PER_S * 1e3,
            "expert_bound_ms": experts / HBM_BYTES_PER_S * 1e3}


def lm_moe_serve_phase(dev):
    """``launch.serve.serve`` at the full width and depth of
    deepseek-v2-lite-16b (27 layers: MLA with a 192-wide query/key head
    and a 128-wide value head, 64 routed experts top-6 + 2 shared), fp32,
    B=4, prompt 2,048, 32 greedy tokens: 27 flash_attention_fwd launches
    per prefill, tokens in the vocab and equal on a second run, the
    prefill's logits against the plain attention on the card (routing
    flips between the two runs reported), timings, the device-busy share,
    peak memory and the decode's weight bytes per token."""
    cfg = get_config(MOE_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    part = {}
    t0 = time.perf_counter()
    bk, emb, dense = lm_state(cfg, dev, SEED)
    state = (emb, dense)
    n_dense = sum(t.numel() for t in tree_leaves(dense))
    weights = moe_weight_bytes(cfg, dense)
    lm_serve.serve(cfg, LM_B, LM_PROMPT, 2, SEED, device=dev, state=state)
    torch.cuda.synchronize()
    part["init_and_warmup"] = time.perf_counter() - t0

    # the main path: counts set to 0 just before
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    res = lm_serve.serve(cfg, LM_B, LM_PROMPT, LM_GEN, SEED, device=dev,
                         state=state)
    launches, served = ops.launch_counts(), ops.table_counts()
    part["serve"] = time.perf_counter() - t0
    check(launches["flash_attention_fwd"] == cfg.n_layers,
          f"lm moe serve: {launches['flash_attention_fwd']} "
          f"flash_attention_fwd launches, want {cfg.n_layers} (one prefill)")
    toks = res["tokens"]
    check(toks.shape == (LM_B, LM_GEN) and toks.min() >= 0
          and toks.max() < cfg.vocab_size,
          f"lm moe serve tokens {toks.shape}")

    # the prefill's last-token logits through the kernel and through the
    # plain attention, on the card, with both runs' routing
    t0 = time.perf_counter()
    prompts = torch.as_tensor(
        lm_serve.make_prompts(cfg, LM_B, LM_PROMPT, SEED), device=dev)
    with record_routing() as rk:
        _, lk, _ = lm_serve.prefill_step(cfg, bk, emb, dense, prompts,
                                         LM_PROMPT + 1)
    with record_routing() as rp, \
            mock.patch.object(lm_flash, "flash_attention", plain_attention):
        _, lp, _ = lm_serve.prefill_step(cfg, bk, emb, dense, prompts,
                                         LM_PROMPT + 1)
    flips = routing_flips(rp, rk, cfg.moe_top_k)
    del rk, rp
    emit({"phase": "lm_moe_routing", "run": "kernel_vs_plain_attention",
          **flips})
    lk, lp = lk[:, 0, :cfg.vocab_size], lp[:, 0, :cfg.vocab_size]
    torch.cuda.synchronize()
    diff = float((lk - lp).abs().max())
    top = float(lp.abs().max())
    note = flip_note(flips)
    check(bool(torch.isfinite(lk).all()), "lm moe prefill logits not finite")
    check(diff <= 1e-3 * top, f"lm moe prefill logits: kernel and plain "
          f"attention differ by {diff} (largest logit {top}); {note}")
    check(torch.equal(lk.argmax(-1), lp.argmax(-1)),
          f"lm moe prefill: the first token differs with the plain "
          f"attention; {note}")
    check(torch.equal(lk.argmax(-1).cpu(),
                      torch.as_tensor(toks[:, 0]).long()),
          "lm moe prefill: serve's first token differs from the prefill's")
    del lk, lp
    torch.cuda.empty_cache()
    part["kernel_vs_plain"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        prof_res = lm_serve.serve(cfg, LM_B, LM_PROMPT, LM_GEN, SEED,
                                  device=dev, state=state)
        wall = time.perf_counter() - t1
    events = device_times(prof)
    device_s = sum(us for us, _ in events.values()) / 1e6
    top_kernels = sorted(((us / 1e3, k) for k, (us, _) in events.items()),
                         reverse=True)[:8]
    check(np.array_equal(prof_res["tokens"], toks),
          "lm moe serve: a second run gave other tokens")
    part["profiled"] = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    del bk, emb, dense, state, prof
    gc.collect()
    torch.cuda.empty_cache()
    ms_tok = res["decode_s"] * 1e3 / (LM_GEN - 1)
    return (launches, served), {
        "phase": "lm_moe_serve", "model": cfg.name, "layers": cfg.n_layers,
        "d_model": cfg.d_model,
        "heads": {"n": cfg.n_heads, "qk_nope": cfg.head_dim,
                  "rope": cfg.rope_head_dim, "v": cfg.v_head_dim,
                  "kv_lora": cfg.kv_lora_rank, "q_lora": cfg.q_lora_rank},
        "moe": {"experts": cfg.n_experts, "top_k": cfg.moe_top_k,
                "shared": cfg.n_shared_experts, "d_ff": cfg.moe_d_ff,
                "capacity_prefill": lm_moe.capacity(cfg, LM_B * LM_PROMPT),
                "capacity_decode": lm_moe.capacity(cfg, LM_B)},
        "vocab": [cfg.vocab_size, cfg.padded_vocab],
        "dense_params": n_dense, "dense_gb": n_dense * 4 / 1e9, **weights,
        "batch": LM_B, "prompt": LM_PROMPT, "gen": LM_GEN,
        "prefill_ms": res["prefill_s"] * 1e3, "ms_per_token": ms_tok,
        "decode_tok_per_s": res["decode_tok_per_s"],
        "flash_launches_per_prefill": launches["flash_attention_fwd"],
        "prefill_logit_diff_vs_plain": diff, "largest_logit": top,
        "routing_kernel_vs_plain": flips,
        "profiled_wall_s": wall, "profiled_device_s": device_s,
        "device_busy_share": device_s / wall, "peak_gib": peak,
        "resident_gib_before": resident, "top_kernels_ms": top_kernels,
        "part_s": part, "first_tokens": toks[0, :8].tolist()}


def lm_moe_card_vs_cpu(dev):
    """deepseek-v2-lite-16b at full width cut to 2 layers (the mla + dense
    prologue and one mla + MoE layer), B=1, prompt 256, 4 greedy tokens,
    from one starting state drawn on the CPU (``lm_cut_card_vs_cpu``)."""
    cfg = get_config(MOE_ARCH).replace(pattern_repeats=MOE_CPU["repeats"])
    return lm_cut_card_vs_cpu(dev, cfg, MOE_CPU, SEED + 1,
                              "lm_moe_card_vs_cpu", torch.device("cpu"))


def lm_cut_card_vs_cpu(dev, cfg, p, seed, phase, draw_dev,
                       split=False, gates=None) -> dict:
    """A model cut to a few layers, ``p["batch"]`` prompts of
    ``p["prompt"]`` tokens (and the serve's memory, for a model with
    cross-attention) and ``p["gen"]`` greedy tokens, from one starting
    state (drawn on ``draw_dev``, copied; with ``gates`` every ``xgate``
    set to it) on the card and on the CPU, both runs' MoE routing
    recorded: the logits of every step up to the first MoE call that
    routed a token otherwise are held within rtol 1e-4 / atol 1e-5 and
    the greedy tokens there equal; the flips are reported, and the first
    call that differs must lie within 1e-5 of a top-k boundary (else the
    two runs disagree for another reason than rounding). A model without
    MoE blocks routes nothing: every step is held. With ``split``, the
    card runs a third time with the plain attention in the place of the
    kernel, routed as the kernel's run: its distance from the CPU is what
    the card's fp32 GEMMs alone leave (at Jamba's widths, 4,096 and
    14,336, more than atol 1e-5 on logits of RMS 1), and a step that
    misses rtol 1e-4 / atol 1e-5 is held within twice that distance
    instead: the kernel may add no more than the GEMMs' own rounding. The
    record says which steps held in the plain class."""
    cpu = torch.device("cpu")
    bk, emb, dense = lm_state(cfg, draw_dev, seed)
    if gates is not None:
        open_gates(dense, gates)
    prompts, memory = lm_serve.make_inputs(cfg, p["batch"], p["prompt"],
                                           seed)
    prompts = torch.as_tensor(prompts)
    memory = None if memory is None else torch.as_tensor(memory)
    n_moe = sum(b.ffn == "moe" for b in cfg.prologue) + \
        sum(b.ffn == "moe" for b in cfg.pattern) * cfg.pattern_repeats

    def run(d):
        e = {k: t.to(d) for k, t in emb.items()}
        w = tree_map(lambda t: t.to(d), dense)
        with record_routing() as calls:
            first, steps, toks = lm_generate(
                cfg, bk, e, w, prompts.to(d), p["gen"],
                None if memory is None else memory.to(d))
        out = ([first.cpu()] + [x.cpu() for x in steps], toks.cpu(),
               [(a.cpu(), b.cpu()) for a, b in calls])
        del e, w
        return out

    t0 = time.perf_counter()
    (lg, tg, rg), (lc, tc, rc) = run(dev), run(cpu)
    gemm = None
    if split:
        with mock.patch.object(lm_flash, "flash_attention", plain_attention):
            lp, _, rp = run(dev)
        gemm_alike = routing_flips(rg, rp, cfg.moe_top_k)["first_call"]
        n = len(lp) if gemm_alike is None else gemm_alike // n_moe
        gemm = [float((a - b).abs().max()) for a, b in zip(lp[:n], lc)]
    del emb, dense
    torch.cuda.empty_cache()
    flips = routing_flips(rc, rg, cfg.moe_top_k)
    # steps whose MoE calls, and every earlier step's, routed alike
    alike = len(lg) if flips["first_call"] is None \
        else flips["first_call"] // n_moe
    errs = [float((a - b).abs().max()) for a, b in zip(lg, lc)]
    plain = [torch.allclose(a, b, rtol=1e-4, atol=1e-5)
             for a, b in zip(lg[:alike], lc[:alike])]
    within = [ok or (gemm is not None and i < len(gemm)
                     and errs[i] <= 2 * gemm[i])
              for i, ok in enumerate(plain)]
    ok = all(within)
    rec = {"phase": phase, **p, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "logit_max_abs_by_step": errs, "steps_routed_alike": alike,
           "plain_class_by_step": plain,
           "routing": flips, "tokens_card": tg.tolist(),
           "tokens_cpu": tc.tolist(), "seconds": time.perf_counter() - t0}
    if memory is not None:
        rec["memory"] = list(memory.shape)
    if gates is not None:
        rec["xgate"] = gates
    if split:
        rec["gemm_only_max_abs_by_step"] = gemm
    emit(rec)
    note = flip_note(flips)
    check(flips["first_call"] is None
          or flips["first_call_max_gap"] <= FLIP_GAP,
          f"{phase}: the first routing that differs is not at a top-k "
          f"boundary; {note}")
    check(alike >= 1, f"{phase}: the prefill routed apart; {note}")
    check(ok, f"{phase}: logits differ by {max(errs[:alike])} where the "
          f"routing agrees; {note}")
    check(torch.equal(tg[:, :alike], tc[:, :alike]),
          f"{phase}: greedy tokens differ; {note}")
    return rec


# ---------------------------------------------------------------------------
# the out-of-core tier: host_lru and host_lru+disk under kwai-dlrm and the
# granite vocab table
# ---------------------------------------------------------------------------

def lru_backends(trainer) -> list:
    """Every table's storage backend (a router's shard backends)."""
    out = []
    for b in trainer.backends.values():
        b = BK.unwrap(b)
        out += b.shard_backends if isinstance(b, BK.ShardedBackend) else [b]
    return out


def lru_counters(trainer) -> dict:
    """faults, writebacks, hits and the host seconds of the fault path,
    summed over the tables."""
    out = dict.fromkeys(("faults", "writebacks", "hits", "evict_s",
                         "evict_sync_s", "fault_s"), 0.0)
    for b in lru_backends(trainer):
        out["faults"] += b.faults
        out["writebacks"] += b.writebacks
        out["hits"] += b.hits
        for k, v in b.stage_s.items():
            out[f"{k}_s"] += v
    return out


def lru_delta(a, b, per=1) -> dict:
    return {k: (b[k] - a[k]) / per for k in a}


def train_host_lru_phase(dev):
    """kwai-dlrm at full width with every table ``host_lru`` (device cache
    of ``default_cache_rows`` = 7,812 slots over the 62,500 host rows),
    hybrid(3), batch 512: 2 warm-up and 30 timed steps, a staged breakdown
    with the prepare split into fault-in, eviction and plan, profiled
    steps; the fault path's counters per step; every table must fault more
    rows than its cache holds and write rows back. Returns the trainer and
    its state for the serve and card-against-CPU phases."""
    ds = CTR_BENCHMARKS["kwai_video"]
    steps = LRU_STEPS
    it = ds.sampler(TRAIN_B, seed=SEED + 3)
    n_main = WARMUP_STEPS + steps["timed"] + steps["breakdown"] + \
        steps["profiled"]
    batches = [next(it) for _ in range(n_main)]
    trainer = kwai_train_trainer(dev, TrainMode.hybrid(TAU), HOST_LRU)
    cache = trainer.collection["field_00"].cache_rows
    t0 = time.perf_counter()
    state = trainer.init(seed=SEED, batch_example=batches[0])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    for b in batches[:WARMUP_STEPS]:
        state, _ = trainer.step(state, b)
    torch.cuda.synchronize()

    # the main path: timed steps, counts set to 0 just before
    c0 = lru_counters(trainer)
    t0 = time.perf_counter()
    timed = batches[WARMUP_STEPS:WARMUP_STEPS + steps["timed"]]
    state, losses, launches, _, served = run_steps(trainer, state, timed,
                                                   "host_lru hybrid")
    wall = time.perf_counter() - t0
    main_counts = (launches, served)
    per_step = lru_delta(c0, lru_counters(trainer), steps["timed"])

    times, split = {}, {}
    rest = batches[WARMUP_STEPS + steps["timed"]:]
    for b in rest[:steps["breakdown"]]:
        c = lru_counters(trainer)
        state, _ = staged_step(trainer, state, b, times)
        for k, v in lru_delta(c, lru_counters(trainer)).items():
            split.setdefault(k, []).append(v)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for b in rest[steps["breakdown"]:]:
            state, _ = trainer.step(state, b)
        torch.cuda.synchronize()
    device_ms = device_us(prof) / 1e3 / steps["profiled"]
    check_rings(trainer, state, n_main, "host_lru hybrid")
    tables = lru_backends(trainer)
    few = [n for n, b in zip(trainer.collection.names, tables)
           if not (b.faults > cache and b.writebacks > 0)]
    check(not few, f"host_lru: tables {few[:4]} faulted no more than their "
          f"{cache} slots or wrote nothing back")
    dev_bytes = sum(b.device_bytes(state.emb[n]) for n, b
                    in zip(trainer.collection.names, tables))
    host_bytes = sum(b.host_bytes() for b in tables)
    check(dev_bytes < host_bytes, f"host_lru: device bytes {dev_bytes} >= "
          f"host bytes {host_bytes}")

    eb = next(ds.sampler(4096, seed=SEED + 4))
    before = lru_counters(trainer)["faults"]
    em = trainer.eval(state, eb)
    ep = trainer.predict(state, eb).cpu().numpy()
    check(lru_counters(trainer)["faults"] == before,
          "host_lru eval faulted rows in")
    check(np.isfinite(float(em["loss"])) and np.all(np.isfinite(ep)),
          "host_lru eval not finite")
    aucs = [adapters.auc(eb["labels"][:, t], ep[:, t])
            for t in range(KWAI.n_tasks)]
    med = {k: float(np.median(v)) for k, v in times.items()}
    prep = {k: float(np.median(v)) * 1e3
            for k, v in split.items() if k.endswith("_s")}
    step_ms = wall * 1e3 / steps["timed"]
    rec = {
        "phase": "train_host_lru", "model": KWAI.name,
        "dataset": "kwai_video", "backend": HOST_LRU, "batch": TRAIN_B,
        "mode": f"hybrid({TAU})", "table_rows": ds.rows_per_field,
        "cache_rows": cache, "init_s": init_s, "timed_steps": steps["timed"],
        "step_ms": step_ms, "steps_per_s": steps["timed"] / wall,
        "samples_per_s": steps["timed"] * TRAIN_B / wall,
        "per_step": per_step,
        "launches_per_step": {k: v / steps["timed"]
                              for k, v in launches.items()},
        "tables_per_launch": tables_per_launch(launches, served),
        "breakdown_ms": med,
        "prepare_split_ms": {
            "fault_in": prep["fault_s"], "eviction": prep["evict_s"],
            "eviction_sync": prep["evict_sync_s"],
            "plan": med["prepare_ms"] - prep["fault_s"] - prep["evict_s"]},
        "breakdown_writebacks_per_step": float(np.median(
            split["writebacks"])),
        "eviction_sync_share_of_step": prep["evict_sync_s"] / sum(
            med.values()),
        "device_ms_per_step": device_ms,
        "device_busy_share": device_ms / step_ms,
        "faults_total": sum(b.faults for b in tables),
        "writebacks_total": sum(b.writebacks for b in tables),
        "min_table_faults": min(b.faults for b in tables),
        "min_table_writebacks": min(b.writebacks for b in tables),
        "device_bytes": dev_bytes, "host_bytes": host_bytes,
        "loss_first": losses[0], "loss_last": losses[-1],
        "eval_rows": 4096, "eval_loss": float(em["loss"]),
        "eval_auc_per_task": aucs,
    }
    return main_counts, rec, (trainer, state)


def serve_host_lru_phase(dev, trainer, state):
    """The trained host_lru kwai-dlrm behind a ``ServingService``
    (max_batch 64, 512 Zipf requests, 4 clients): some rows are resident
    in the device caches and some only in the host stores. Every flush is
    ONE bag launch for the 32 tables (each table's unique rows, hits
    gathered from the cache and misses read from the store); the read
    faults nothing in, and the predictions equal the plain read's
    (``read_rows``, summed)."""
    ds = CTR_BENCHMARKS["kwai_video"]
    cell = StateCell(state, state.step)
    reqs = [r for _, r in TrafficModel.for_dataset(ds, seed=SEED)
            .requests(N_REQUESTS, seed=1)]
    config = ServingConfig(max_batch=64, max_wait_ms=2.0)
    serve(trainer, cell, reqs[:128], config)             # warm-up
    torch.cuda.synchronize()
    before = lru_counters(trainer)

    ops.reset_launch_counts()
    preds, m = serve(trainer, cell, reqs, config)
    launches, served = ops.launch_counts(), ops.table_counts()
    flushes = int(m["serving/batches"])
    n = len(trainer.collection)
    check(int(m["serving/requests"]) == N_REQUESTS
          and m["serving/errors"] == 0, f"host_lru service metrics {m}")
    check(launches["unique_bag"] == flushes and served["unique_bag"] ==
          n * flushes and launches["embedding_bag"] == 0,
          f"host_lru serve: launches {launches} (tables {served}), want one "
          f"bag launch of {n} tables per flush ({flushes} flushes)")
    after = lru_counters(trainer)
    check(all(after[k] == before[k] for k in ("faults", "writebacks")),
          "host_lru serve faulted or evicted rows")
    check(bool(np.all(np.isfinite(preds))) and preds.min() > 0
          and preds.max() < 1, "host_lru predictions not finite in (0, 1)")

    # hits and misses of each 64-request flush, summed over the tables
    hits, misses = [], []
    for i in range(0, N_REQUESTS, 64):
        _, info = trainer.serve_lookup(state, stack(reqs[i:i + 64]))
        hits.append(sum(v["hits"] for v in info.values()))
        misses.append(sum(v["misses"] for v in info.values()))
    check(sum(misses) > 0, "host_lru serve: no read missed the caches")

    batch = stack(reqs)
    plain = plain_predict(trainer, state, batch)
    diff = float(np.abs(preds - plain).max())
    check(np.allclose(preds, plain, rtol=1e-5, atol=1e-6),
          f"host_lru served predictions differ from the plain read by {diff}")
    breakdown = flush_breakdown(trainer, state, stack(reqs[:64]))
    return (launches, served), {
        "phase": "serve_host_lru", "model": KWAI.name, "backend": HOST_LRU,
        "cache_rows": trainer.collection["field_00"].cache_rows,
        "trained_steps": int(state.step), "requests": N_REQUESTS,
        "clients": N_CLIENTS, "max_batch": 64, "flushes": flushes,
        "p50_ms": m["serving/p50_ms"], "p99_ms": m["serving/p99_ms"],
        "qps": m["serving/qps"],
        "hit_rate_field_00": m["serving/field_00/hit_rate"],
        "hits_per_flush": float(np.mean(hits)),
        "misses_per_flush": float(np.mean(misses)),
        "max_abs_diff_vs_plain": diff, "flush": breakdown,
        "tables_per_launch": tables_per_launch(launches, served)}


def lru_card_vs_cpu(dev, trainer, state, steps=LRU_STEPS["cpu"]) -> dict:
    """The trained host_lru trainer (caches full, evicting) and a CPU
    trainer carried across from its state as checkpoint blobs, for
    ``steps`` hybrid(3) steps: the classes of :func:`card_vs_cpu` for the
    tables, accumulators, queue payloads, losses and dense parameters (and
    the host stores' rows, as the tables), the slot maps, device slot
    ids, queue slots and ids, and the fault counters equal exactly."""
    from repro_torch.convert import state_from_numpy, state_to_numpy
    ds = CTR_BENCHMARKS["kwai_video"]
    it = ds.sampler(TRAIN_B, seed=SEED + 21)
    batches = [next(it) for _ in range(steps)]
    tc = kwai_train_trainer("cpu", TrainMode.hybrid(TAU), HOST_LRU)
    tree = state_to_numpy(state)
    blobs = {n: BK.unwrap(b).state_for_checkpoint(state.emb[n])
             for n, b in trainer.backends.items()}
    sc = state_from_numpy(tc, tree["dense"], blobs, opt=tree["opt"],
                          emb_queue=tree["emb_queue"],
                          dense_queue=tree["dense_queue"], step=state.step)
    del blobs
    start = tree_map(torch.clone, sc.dense)     # updated in place
    sg = state
    lg, lc = [], []
    for b in batches:
        sg, mg = trainer.step(sg, b)
        sc, mc = tc.step(sc, b)
        lg.append(float(mg["loss"]))
        lc.append(float(mc["loss"]))
    bad = []
    if not np.allclose(lg, lc, rtol=1e-4):
        bad.append(f"losses card {lg} cpu {lc}")
    err = {"table": 0.0, "acc": 0.0, "store_rows": 0.0, "queue_rel": 0.0}
    wb = 0
    for n in trainer.collection.names:
        bg, bc = BK.unwrap(trainer.backends[n]), BK.unwrap(tc.backends[n])
        wb += bc.writebacks
        for k, rtol, atol in (("table", 1e-4, 1e-6), ("acc", 1e-3, 1e-12)):
            x, y = sg.emb[n][k], sc.emb[n][k].to(dev)
            err[k] = max(err[k], float((x - y).abs().max()))
            if not torch.allclose(x, y, rtol=rtol, atol=atol):
                bad.append(f"{n}.{k} differs")
        if not (torch.equal(sg.emb[n]["slot_ids"].cpu(),
                            sc.emb[n]["slot_ids"])
                and np.array_equal(bg._id_for_slot, bc._id_for_slot)
                and (bg.faults, bg.writebacks, bg.hits)
                == (bc.faults, bc.writebacks, bc.hits)):
            bad.append(f"{n}: slot maps or counters differ")
        rg, rc = bg.store.vectors, bc.store.vectors
        err["store_rows"] = max(err["store_rows"],
                                float(np.abs(rg - rc).max()))
        if not (np.allclose(rg, rc, rtol=1e-4, atol=1e-6)
                and np.allclose(bg.store.opt_acc, bc.store.opt_acc,
                                rtol=1e-3, atol=1e-12)
                and np.array_equal(bg.store.keys, bc.store.keys)):
            bad.append(f"{n}: host stores differ")
        qg, qc = sg.emb_queue[n], sc.emb_queue[n]
        if not (torch.equal(qg["slots"].cpu(), qc["slots"])
                and torch.equal(qg["ids"].cpu(), qc["ids"])
                and (qg["ptr"], qg["filled"]) == (qc["ptr"], qc["filled"])):
            bad.append(f"{n}: queue slots, ids or ring differ")
        x, y = qg["grads"], qc["grads"].to(dev)
        scale = float(y.abs().max())
        err["queue_rel"] = max(err["queue_rel"],
                               float((x - y).abs().max()) / scale)
        if not torch.allclose(x, y, rtol=1e-3, atol=1e-3 * scale):
            bad.append(f"{n}: queue grads differ")
    dense = dense_agreement(start, sg.dense, sc.dense, steps)
    if not dense.pop("ok"):
        bad.append(f"dense {dense}")
    out = {"phase": "card_vs_cpu_host_lru", "steps": steps,
           "mode": f"hybrid({TAU})", "loss_card": lg, "loss_cpu": lc,
           "writebacks_cpu": wb, **{f"{k}_max_abs": v for k, v in
                                    err.items()}, **dense}
    emit(out)
    check(wb > 0, "host_lru card against CPU: no write-back in the run")
    check(not bad, "host_lru card against CPU: " + "; ".join(bad[:6]))
    return out


def lru_tiers_phase(dev, steps=LRU_STEPS["short"]):
    """Short hybrid(3) runs from one seed: ``host_lru+disk`` (a host tier of
    ``LRU_HOST_ROWS`` over a memory-mapped disk tier under the git-ignored
    build/)
    bit for bit against ``host_lru`` (losses, caches, queues, slot maps);
    then ``host_lru+compressed``, whose every step runs ONE compress and
    ONE decompress for all the tables, get and put."""
    import shutil
    ds = CTR_BENCHMARKS["kwai_video"]
    it = ds.sampler(TRAIN_B, seed=SEED + 7)
    batches = [next(it) for _ in range(steps)]
    disk = ROOT / "build" / "host_lru_disk"
    shutil.rmtree(disk, ignore_errors=True)
    runs, paths = {}, {}
    try:
        for name in (HOST_LRU, HOST_LRU + "+disk", HOST_LRU + "+compressed"):
            tr = kwai_train_trainer(dev, TrainMode.hybrid(TAU), name,
                                    disk_path=disk)
            st = tr.init(seed=SEED, batch_example=batches[0])
            t0 = time.perf_counter()
            st, losses, launches, wire, served = run_steps(tr, st, batches,
                                                           name)
            wall = time.perf_counter() - t0
            c = lru_counters(tr)
            runs[name] = (tr, st, losses)
            paths[name] = (launches, served)
            rec = {"steps": steps, "step_ms": wall * 1e3 / steps,
                   "losses": losses, "faults": c["faults"],
                   "writebacks": c["writebacks"],
                   "launches_per_step": {k: v / steps
                                         for k, v in launches.items()}}
            if name.endswith("compressed"):
                check(all(launches[k] > 0 for k in CODEC),
                      f"{name}: codec launches {launches}")
                rec["wire_ratio"] = wire["bytes_raw"] / wire["bytes_wire"]
            if name.endswith("disk"):
                spills = sum(b.store.spills for b in lru_backends(tr))
                check(spills > 0, "host_lru+disk: the host tier never "
                      "spilled to disk")
                rec["spills"] = spills
            runs[name] += (rec,)
        (ta, sa, la, _), (tb, sb, lb, _) = runs[HOST_LRU], \
            runs[HOST_LRU + "+disk"]
        same = la == lb and all(
            torch.equal(sa.emb[n][k], sb.emb[n][k])
            for n in sa.emb for k in sa.emb[n]) and all(
            torch.equal(sa.emb_queue[n][k], sb.emb_queue[n][k])
            for n in sa.emb_queue for k in ("slots", "ids", "grads")) and \
            all(np.array_equal(x._id_for_slot, y._id_for_slot)
                and x.faults == y.faults
                for x, y in zip(lru_backends(ta), lru_backends(tb)))
        rec = {"phase": "train_host_lru_tiers", "model": KWAI.name,
               "batch": TRAIN_B, "mode": f"hybrid({TAU})",
               "disk_bit_equal_to_two_tier": bool(same),
               **{name: r[-1] for name, r in runs.items()}}
        emit(rec)
        check(same, "host_lru+disk is not bit-equal to host_lru")
    finally:
        runs.clear()
        shutil.rmtree(disk, ignore_errors=True)
        torch.cuda.empty_cache()
    return paths[HOST_LRU + "+disk"], paths[HOST_LRU + "+compressed"], rec


def lm_serve_host_lru_phase(dev):
    """``launch.serve.serve`` at the full granite-3-2b width with the vocab
    table on ``host_lru`` (6,144 device slots, vocab/8): B=1, a 2,048-token
    prompt, 32 greedy tokens, its rows faulted in before the prefill and
    before each decode step. The prefill's logits must equal, bit for bit,
    those of the dense vocab table drawn from the same seed, and so must
    the tokens: both read the same rows and nothing trains."""
    cfg = get_config(LM_ARCH)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    dense = lm_model.init_dense(cfg, gen)
    after_dense = gen.get_state()
    dbk = BK.create_backend(build_embedding_spec(cfg.vocab_size,
                                                 cfg.d_model))
    demb = dbk.init(gen)
    gen.set_state(after_dense)
    lbk = BK.create_backend(build_embedding_spec(
        cfg.vocab_size, cfg.d_model, backend=HOST_LRU,
        cache_rows=LM_LRU_CACHE))
    lemb = lbk.init(gen)
    blob = lbk.state_for_checkpoint(lemb)
    prompts = torch.as_tensor(
        lm_serve.make_prompts(cfg, LM_LRU_B, LM_PROMPT, SEED), device=dev)
    _, ld, _ = lm_serve.prefill_step(cfg, dbk, demb, dense, prompts,
                                     LM_PROMPT + 1)
    _, ll, _ = lm_serve.prefill_step(cfg, lbk, lemb, dense, prompts,
                                     LM_PROMPT + 1)
    torch.cuda.synchronize()
    check(torch.equal(ld, ll), "lm host_lru: prefill logits differ from the "
          f"dense vocab table's by {float((ld - ll).abs().max())}")
    faults = lbk.faults
    del ld, ll, lemb, lbk

    # the main path: counts set to 0 just before
    ops.reset_launch_counts()
    res = lm_serve.serve(cfg, LM_LRU_B, LM_PROMPT, LM_GEN, SEED,
                         emb_backend=HOST_LRU, cache_rows=LM_LRU_CACHE,
                         device=dev, state=(blob, dense))
    launches, served = ops.launch_counts(), ops.table_counts()
    check(launches["flash_attention_fwd"] == cfg.n_layers,
          f"lm host_lru serve: {launches['flash_attention_fwd']} "
          f"flash_attention_fwd launches, want {cfg.n_layers}")
    want = lm_serve.serve(cfg, LM_LRU_B, LM_PROMPT, LM_GEN, SEED,
                          device=dev, state=(demb, dense))
    check(np.array_equal(res["tokens"], want["tokens"]),
          "lm host_lru serve: tokens differ from the dense vocab table's")
    del dense, demb, blob
    torch.cuda.empty_cache()
    return (launches, served), {
        "phase": "lm_serve_host_lru", "model": cfg.name,
        "vocab": cfg.vocab_size, "cache_rows": LM_LRU_CACHE,
        "batch": LM_LRU_B, "prompt": LM_PROMPT, "gen": LM_GEN,
        "prefill_faults": faults, "prefill_logits_bit_equal": True,
        "prefill_ms": res["prefill_s"] * 1e3,
        "ms_per_token": res["decode_s"] * 1e3 / (LM_GEN - 1),
        "dense_prefill_ms": want["prefill_s"] * 1e3,
        "dense_ms_per_token": want["decode_s"] * 1e3 / (LM_GEN - 1),
        "first_tokens": res["tokens"][0, :8].tolist()}


# ---------------------------------------------------------------------------
# the pipelined trainer
# ---------------------------------------------------------------------------

def snapshot(trainer, state):
    """The state as numpy trees with every table's checkpoint blob (a
    host_lru table's host tiers and slot map too): the start every run of
    the pipeline phase restores."""
    from repro_torch.convert import state_to_numpy
    tree = state_to_numpy(state)
    tree["emb"] = {n: BK.unwrap(b).state_for_checkpoint(state.emb[n])
                   for n, b in trainer.backends.items()}
    return tree


def restore(trainer, tree):
    """A fresh state on the trainer's device from :func:`snapshot`'s trees
    (host tiers loaded back into the trainer's backends)."""
    from repro_torch.convert import state_from_numpy
    state = state_from_numpy(trainer, tree["dense"], tree["emb"],
                             opt=tree["opt"], emb_queue=tree["emb_queue"],
                             dense_queue=tree["dense_queue"],
                             step=tree["step"])
    torch.cuda.synchronize()
    return state


def pipe_engine(trainer, runner):
    """The runner's engine: None for the serial ``trainer.run``; the
    pipelined trainer at max_inflight 1, or at ``PIPE_INFLIGHT`` (with a
    look-ahead of ``PIPE_PREFETCH`` on a host_lru trainer)."""
    if runner == "serial":
        return None
    if runner == "pipelined_1":
        return PipelinedTrainer(trainer, max_inflight=1)
    lru = any(isinstance(b, BK.HostLRUBackend)
              for b in lru_backends(trainer))
    return PipelinedTrainer(trainer, max_inflight=PIPE_INFLIGHT,
                            prefetch=PIPE_PREFETCH if lru else 0)


def pipe_run(trainer, engine, state, batches, delay_fn=None):
    """Steps through the runner, ended by a synchronize: (state, losses
    as tensors, host wall s)."""
    t0 = time.perf_counter()
    if engine is None:
        state, ms = trainer.run(state, batches, delay_fn=delay_fn)
    else:
        state, ms = engine.run(state, batches, delay_fn=delay_fn)
    torch.cuda.synchronize()
    return state, [m["loss"] for m in ms], time.perf_counter() - t0


def lru_state_bits(trainer, state) -> tuple:
    """What a bit-equality check of two runs compares beyond the state's
    tensors: every host_lru table's slot map and host-store rows."""
    return tuple((b._id_for_slot.copy(), b.store.vectors.copy(),
                  b.store.opt_acc.copy()) for b in lru_backends(trainer)
                 if isinstance(b, BK.HostLRUBackend))


def same_run(a, b) -> list:
    """Bit-equality of two runs ``(state, losses, lru bits)``: the losses
    of every step, every table and accumulator (host_lru: cache, slot ids,
    slot maps and host rows too), the queues, the dense parameters and
    the optimizer's moments. Returns what differs."""
    (sa, la, xa), (sb, lb, xb) = a, b
    bad = []
    if [float(x) for x in la] != [float(x) for x in lb]:
        bad.append("losses")
    for n in sa.emb:
        if not all(torch.equal(x, y) for x, y in zip(
                tree_leaves(sa.emb[n]), tree_leaves(sb.emb[n]))):
            bad.append(f"{n} table")
        qa, qb = sa.emb_queue[n], sb.emb_queue[n]
        if qa is not None and not all(
                torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
                for x, y in zip(tree_leaves(qa), tree_leaves(qb))):
            bad.append(f"{n} queue")
    trees = (sa.dense, sb.dense), (sa.opt["m"], sb.opt["m"]), \
        (sa.opt["v"], sb.opt["v"])
    if not all(torch.equal(x, y) for ta, tb in trees
               for x, y in zip(tree_leaves(ta), tree_leaves(tb))):
        bad.append("dense parameters or moments")
    if sa.step != sb.step:
        bad.append("step")
    if not all(np.array_equal(p, q) for u, v in zip(xa, xb)
               for p, q in zip(u, v)):
        bad.append("host_lru slot maps or host rows")
    return bad


def count_syncs(fn) -> int:
    """Device-to-host synchronisations ``fn()`` makes, from any thread:
    the warnings of ``torch.cuda.set_sync_debug_mode("warn")``."""
    import warnings
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in got)


def spread(xs) -> dict:
    return {"median": float(np.median(xs)), "min": float(min(xs)),
            "max": float(max(xs)), "trials": [float(x) for x in xs]}


def pipe_trial(trainer, runner, start, batches, delay, want, want_tables,
               what):
    """One trial: restore the start, ``warmup`` steps, then ``timed``
    steps with the launch counts set to 0 just before. Checks the launches
    per step (the serial step's), finite losses and, for a pipelined
    runner, the order of the applied puts, the put window and the pins.
    Returns (state, losses, the run's readings, the timed run's counts)."""
    p = PIPE_STEPS
    lru = any(isinstance(b, BK.HostLRUBackend)
              for b in lru_backends(trainer))
    state = restore(trainer, start)
    engine = pipe_engine(trainer, runner)
    state, l0, _ = pipe_run(trainer, engine, state, batches[:p["warmup"]],
                            delay)
    c1 = lru_counters(trainer) if lru else None
    ops.reset_launch_counts()
    state, l1, wall = pipe_run(trainer, engine, state,
                               batches[p["warmup"]:], delay)
    launches, served = ops.launch_counts(), ops.table_counts()
    check(launches == want and served == want_tables,
          f"{what}: launches {launches} (tables {served}), want {want} "
          f"({want_tables})")
    losses = [float(x) for x in l0 + l1]
    check(all(np.isfinite(losses)), f"{what}: losses {losses}")
    run = {"wall_s": wall,
           "lru": lru_delta(c1, lru_counters(trainer), p["timed"])
           if lru else None}
    if engine is not None:
        pm = engine.pipeline_metrics()
        run["stages"] = {s: {"busy_s": pm[f"pipeline/{s}/busy_s"],
                             "occupancy": pm[f"pipeline/{s}/occupancy"]}
                         for s in STAGES}
        peak = max(engine.max_outstanding.values())
        run["max_outstanding"] = peak
        pins = sum(int(b._pin_count.sum()) for b in lru_backends(trainer)
                   if isinstance(b, BK.HostLRUBackend))
        window = min(engine.max_inflight, TAU)
        check(engine.applied_order == list(range(p["timed"]))
              and peak <= window and pins == 0,
              f"{what}: order {engine.applied_order}, peak {peak} > "
              f"{window} or {pins} pins held")
    return state, l0 + l1, run, (launches, served)


def syncs_and_busy(trainer, runner, start, batches, delay) -> dict:
    """From the start, ``warmup`` steps, then ``syncs`` steps counted under
    the sync debug mode and ``profiled`` steps under the profiler: syncs
    per step, device ms per step and the device-busy share."""
    p = PIPE_STEPS
    state = restore(trainer, start)
    engine = pipe_engine(trainer, runner)
    state, _, _ = pipe_run(trainer, engine, state, batches[:p["warmup"]],
                           delay)
    w = p["warmup"]
    counted = batches[w:w + p["syncs"]]
    profiled = batches[w + p["syncs"]:w + p["syncs"] + p["profiled"]]

    def sync_steps():
        nonlocal state
        state = pipe_run(trainer, engine, state, counted, delay)[0]
    syncs = count_syncs(sync_steps)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        state, _, wall = pipe_run(trainer, engine, state, profiled, delay)
    dev_ms = device_us(prof) / 1e3
    del state
    return {"syncs_per_step": syncs / p["syncs"],
            "device_ms_per_step": dev_ms / len(profiled),
            "device_busy_share": dev_ms / (wall * 1e3)}


def pipeline_phase(dev, backend):
    """kwai-dlrm at full width on ``backend`` (``dense``, or ``host_lru``
    at the launchers' 7,812-slot cache, warmed by ``lru_warm`` serial
    steps until it evicts), hybrid(3), batch 512, through three runners
    from one start state: the serial ``trainer.run``, ``PipelinedTrainer(
    max_inflight=1)`` and ``PipelinedTrainer(max_inflight=4)`` (host_lru:
    ``prefetch=2``). Two regimes: ``nolat``, and ``hostlat`` with a
    prepare-stage delay of the median serial step of the nolat pass (the
    host latency of an embedding PS the size of a step, the regime of
    paper Fig. 4–5). Per (regime, runner) ``trials`` runs of ``warmup`` +
    ``timed`` steps: steps/s (median and spread), the stages' busy seconds
    and occupancy, host_lru's faults, write-backs and eviction wait per
    step, and launches per step by kernel, which must equal the serial
    step's; the runners take turns within each trial. max_inflight=1 must
    equal the serial run bit for bit; the deep run must apply every put
    in order, keep each table within its put window, release every pin
    and keep its losses finite. Then, per regime, synchronisations per
    step (sync debug mode) and the device-busy share over profiled steps,
    serial and pipelined. The first nolat trial of the deep runner is the
    path whose launches the kernels line counts."""
    ds = CTR_BENCHMARKS["kwai_video"]
    p = PIPE_STEPS
    lru = backend != "dense"
    trainer = kwai_train_trainer(dev, TrainMode.hybrid(TAU), backend)
    it = ds.sampler(TRAIN_B, seed=SEED + 30)
    n_warm = p["lru_warm"] if lru else 0
    warm = [next(it) for _ in range(n_warm)]
    batches = [next(it) for _ in range(p["warmup"] + p["timed"])]
    state = trainer.init(seed=SEED, batch_example=batches[0])
    state, _ = trainer.run(state, warm)
    start = snapshot(trainer, state)
    del state
    torch.cuda.empty_cache()
    per_step, tables = step_launches(trainer)
    want = {k: v * p["timed"] for k, v in per_step.items()}
    want_tables = {k: v * p["timed"] for k, v in tables.items()}
    runners = ("serial", "pipelined_1", "pipelined_deep")
    out = {"phase": f"train_pipelined{'_' + backend if lru else ''}",
           "model": KWAI.name, "backend": backend, "batch": TRAIN_B,
           "mode": f"hybrid({TAU})", "max_inflight": PIPE_INFLIGHT,
           "prefetch": PIPE_PREFETCH if lru else 0,
           "warm_steps": n_warm, "steps": p}
    main_counts, bit_equal, lat = None, {}, 0.0
    for regime in ("nolat", "hostlat"):
        delay = None if regime == "nolat" else \
            (lambda stage, _i, d=lat: d if stage == "prepare" else 0.0)
        rec = {"prepare_delay_ms": lat * 1e3}
        sps = {r: [] for r in runners}
        runs = {r: [] for r in runners}
        # the runners take turns within each trial, so host drift over the
        # call does not fall on one runner
        for trial in range(p["trials"]):
            for runner in runners:
                what = f"{backend} {regime} {runner}"
                state, losses, run, counts = pipe_trial(
                    trainer, runner, start, batches, delay, want,
                    want_tables, what)
                sps[runner].append(p["timed"] / run["wall_s"])
                runs[runner].append(run)
                if regime == "nolat" and trial == 0:
                    if runner == "pipelined_deep":
                        main_counts = counts
                    else:
                        bit_equal[runner] = (state, losses,
                                             lru_state_bits(trainer, state))
                    if runner == "pipelined_1":
                        diff = same_run(bit_equal["serial"],
                                        bit_equal["pipelined_1"])
                        bit_equal.clear()
                        out["max_inflight_1_bit_equal"] = not diff
                        check(not diff, f"{backend}: max_inflight=1 differs "
                              f"from the serial run in {diff[:6]}")
                del state
        for runner in runners:
            rec[runner] = {"steps_per_s": spread(sps[runner]),
                           "runs": runs[runner]}
        if regime == "nolat":
            lat = 1.0 / rec["serial"]["steps_per_s"]["median"]
        rec["speedup_deep_over_serial"] = (
            rec["pipelined_deep"]["steps_per_s"]["median"]
            / rec["serial"]["steps_per_s"]["median"])
        for runner in ("serial", "pipelined_deep"):
            rec[runner].update(syncs_and_busy(trainer, runner, start,
                                              batches, delay))
        out[regime] = rec
        torch.cuda.empty_cache()

    del trainer, start
    torch.cuda.empty_cache()
    emit(out)
    return main_counts, out


# ---------------------------------------------------------------------------
# the in-process online loop, and LM training
# ---------------------------------------------------------------------------

def online_phase(dev):
    """``launch.online``'s loop (``_online_loop``) at the full kwai-dlrm
    width on ``host_lru`` (``run_online``'s default backend), hybrid(2),
    training batch 512, ``ServingConfig(max_batch=64)``, 4 closed-loop
    clients x 256 requests and 30 trainer steps over one embedding state.
    Exactly 30 steps; every impression fed back; every table's staleness
    gauge at most tau; predictions finite in [0, 1], and in (0, 1) for the
    serve-only run; one bag launch per flush and, per step, one bag launch
    and one ``fused_backward`` per table. A serve-only run of the same service and clients (no step)
    from the same call stands beside it."""
    ds = CTR_BENCHMARKS["kwai_video"]
    trainer = kwai_train_trainer(dev, TrainMode.hybrid(ONLINE["tau"]),
                                 HOST_LRU)
    kw = dict(batch=TRAIN_B, config=ServingConfig(
        max_batch=ONLINE["max_batch"]), n_clients=ONLINE["clients"],
        seed=SEED)
    online._online_loop(trainer, ds, steps=2, requests_per_client=32,
                        **kw)                             # warm-up
    alone, alone_x = online._online_loop(
        trainer, ds, steps=0, requests_per_client=ONLINE["requests"], **kw)
    torch.cuda.synchronize()

    # the main path: counts set to 0 just before
    ops.reset_launch_counts()
    res, extras = online._online_loop(
        trainer, ds, steps=ONLINE["steps"],
        requests_per_client=ONLINE["requests"], **kw)
    torch.cuda.synchronize()
    launches, served = ops.launch_counts(), ops.table_counts()
    sv, steps = res["serving"], ONLINE["steps"]
    flushes = int(sv["serving/batches"])
    n_req = ONLINE["clients"] * ONLINE["requests"]
    check(res["steps"] == steps, f"online: {res['steps']} steps, want "
          f"{steps}")
    check(res["served"] == n_req and res["feedback"]["put"] == n_req
          and sv["serving/requests"] == n_req and sv["serving/errors"] == 0,
          f"online: served {res['served']}, fed back {res['feedback']}, "
          f"service {sv['serving/requests']} requests")
    stale = {n: sv[f"serving/{n}/stale_steps"] for n in trainer.collection}
    check(max(stale.values()) <= ONLINE["tau"],
          f"online: staleness gauges {stale} above tau {ONLINE['tau']}")
    # the first Adam steps (lr 3e-3 on 4,096-wide layers) drive some
    # logits past fp32 sigmoid's range, where it rounds to exactly 0 or 1:
    # served predictions are held to [0, 1] and the saturated share is
    # reported; the untrained model's (serve-only) to (0, 1)
    preds, fresh = extras["preds"], alone_x["preds"]
    saturated = float(np.mean((preds == 0) | (preds == 1)))
    check(bool(np.all(np.isfinite(preds))) and preds.min() >= 0
          and preds.max() <= 1, f"online: predictions not finite in [0, 1]: "
          f"{int((~np.isfinite(preds)).sum())} not finite, min "
          f"{np.nanmin(preds)}, max {np.nanmax(preds)}")
    check(bool(np.all(np.isfinite(fresh))) and fresh.min() > 0
          and fresh.max() < 1, "online: serve-only predictions not finite "
          f"in (0, 1): min {np.nanmin(fresh)}, max {np.nanmax(fresh)}")
    check(np.isfinite(res["loss_first"]) and np.isfinite(res["loss_last"]),
          "online: losses not finite")
    per_step, tables = step_launches(trainer)
    n = len(trainer.collection)
    want = {k: v * steps for k, v in per_step.items()}
    want["unique_bag"] += flushes
    want_tables = {k: v * steps for k, v in tables.items()}
    want_tables["unique_bag"] += n * flushes
    check(launches == want and served == want_tables,
          f"online: launches {launches} (tables {served}), want {want} "
          f"(tables {want_tables}): one bag launch per flush ({flushes}) "
          f"and per step, {n} fused_backward per step")
    wall = extras["wall_s"]
    del trainer, extras, alone_x
    torch.cuda.empty_cache()

    def serving(r):
        s = r["serving"]
        return {"p50_ms": s["serving/p50_ms"], "p99_ms": s["serving/p99_ms"],
                "qps": s["serving/qps"], "flushes": s["serving/batches"],
                "fill": s["serving/field_00/batch_fill"]}

    return (launches, served), {
        "phase": "online", "model": KWAI.name, "backend": HOST_LRU,
        "mode": f"hybrid({ONLINE['tau']})", "train_batch": TRAIN_B,
        "max_batch": ONLINE["max_batch"], "clients": ONLINE["clients"],
        "requests_per_client": ONLINE["requests"], "steps": res["steps"],
        "wall_s": wall, "steps_per_s": res["steps_per_s"],
        "feedback_batches": res["feedback_batches"],
        "fallback_batches": res["fallback_batches"],
        "loss_first": res["loss_first"], "loss_last": res["loss_last"],
        "served_logloss_first": res["served_logloss_first"],
        "served_logloss_last": res["served_logloss_last"],
        "stale_steps_max": max(stale.values()),
        "saturated_pred_share": saturated,
        "under_training": serving(res), "serve_only": serving(alone),
        "launches_per_step": per_step}


def lm_trainer(cfg, dev):
    """granite's ``PersiaTrainer(lm_adapter)``: hybrid(emb_staleness),
    Adam, the launchers' learning rates."""
    return PersiaTrainer(adapters.lm_adapter(cfg, lr=EMB_LR),
                         TrainMode.hybrid(cfg.emb_staleness),
                         OptConfig(kind="adam", lr=DENSE_LR), device=dev)


def lm_train_run(dev, cfg, p, batches, per_step: int, what: str):
    """``PersiaTrainer(lm_adapter)`` of ``cfg`` on the card from ``SEED``
    (``lm_trainer``): init on ``batches[0]``, ``p["warmup"]`` warm-up
    steps, ``p["timed"]`` timed steps (the main path: the launch counts
    set to 0 just before; each step must launch ``flash_attention_fwd``
    ``per_step`` times and ``fused_backward`` once, and nothing else) and
    one step under the profiler; every loss finite. Returns ``((launches,
    served), the record's common fields, the last step's metrics)``."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = lm_trainer(cfg, dev)
    t0 = time.perf_counter()
    state = trainer.init(SEED, batches[0])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_dense = sum(t.numel() for t in tree_leaves(state.dense))
    losses = []
    for b in batches[1:1 + p["warmup"]]:
        state, m = trainer.step(state, b)
        losses.append(float(m["loss"]))

    # the main path: counts set to 0 just before
    ops.reset_launch_counts()
    step_ms = []
    for b in batches[1 + p["warmup"]:1 + p["warmup"] + p["timed"]]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = trainer.step(state, b)
        losses.append(float(m["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches, served = ops.launch_counts(), ops.table_counts()
    peak = torch.cuda.max_memory_allocated()
    want = dict.fromkeys(launches, 0)
    want.update(flash_attention_fwd=per_step * p["timed"],
                fused_backward=p["timed"])
    check(launches == want, f"{what}: launches {launches}, want {want} "
          f"(per step {per_step} attention forwards and one put)")
    (state, m), wall, device_s, top, n_kernels = profile_run(
        lambda: trainer.step(state, batches[-1]))
    losses.append(float(m["loss"]))
    check(all(np.isfinite(losses)), f"{what}: losses {losses}")
    del state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    med = float(np.median(step_ms))
    rec = {"model": cfg.name, "d_model": cfg.d_model,
           "vocab": [cfg.vocab_size, cfg.padded_vocab], "dtype": "fp32",
           "mode": f"hybrid({cfg.emb_staleness})", "batch": p["batch"],
           "seq": p["seq"], "dense_params": n_dense,
           "dense_gb": n_dense * 4 / 1e9, "init_s": init_s,
           "step_ms": step_ms, "step_ms_median": med,
           "tokens_per_s": p["batch"] * p["seq"] / (med / 1e3),
           "profiled_wall_s": wall, "profiled_device_s": device_s,
           "device_busy_share": device_s / wall, "top_device_ms": top,
           "device_kernels": n_kernels, "peak_gib": peak / 2**30,
           "losses": losses,
           "launches_per_step": {k: v / p["timed"]
                                 for k, v in launches.items() if v}}
    return (launches, served), rec, m


def lm_train_phase(dev):
    """``PersiaTrainer(lm_adapter)`` at the full width and depth of
    granite-3-2b (fp32, remat on), B=2, S=2,048, hybrid(1), Adam, on
    ``lm_batches``: 2 warm-up and 3 timed steps (each 80
    ``flash_attention_fwd``, forward and recompute, and one
    ``fused_backward`` at D=2,048), one profiled step (``lm_train_run``);
    then checks (a) to (c)."""
    cfg = get_config(LM_ARCH)
    check(cfg.remat, "granite's config must remat its layers")
    p = LM_TRAIN
    it = lm_batches(cfg.vocab_size, p["batch"], p["seq"], seed=SEED)
    batches = [next(it) for _ in range(1 + p["warmup"] + p["timed"] + 1)]
    paths, common, _ = lm_train_run(dev, cfg, p, batches, 2 * cfg.n_layers,
                                    "lm train")
    rec = {"phase": "lm_train", **common, "layers": cfg.n_layers,
           "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
           "d_ff": cfg.d_ff, "remat": cfg.remat}
    emit(rec)
    G, Dh = cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    rec["attention_backward"] = attention_backward_check(
        dev, {"granite_layer": (2048, 0, cfg.n_kv_heads, G, Dh, Dh),
              "ragged_window": (1000, 256, cfg.n_kv_heads, G, Dh, Dh)},
        "lm_attention_backward")
    rec["lm_put"] = lm_put_check(dev, cfg)
    rec["card_vs_cpu"] = lm_train_card_vs_cpu(dev)
    return paths, rec


def attention_backward_check(dev, cases: dict, phase: str) -> dict:
    """(a) ``flash.FlashAttention``'s dq, dk, dv (the kernel's forward, the
    recompute backward) against autograd through the plain attention
    (``layers._attn_naive``), on the card, for each case ``(S, window,
    Hkv, G, Dh, Dv[, causal, Sk])`` (causal over S keys unless given):
    within 1e-3 of the largest |grad| (the kernel's 3xTF32 forward moves
    o and the logsumexp the backward reads by its own rounding)."""
    out = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    for case, (S, window, hkv, G, Dh, Dv, *rest) in cases.items():
        causal, Sk = rest if rest else (True, S)
        q = torch.randn((1, S, hkv, G, Dh), generator=gen, device=dev)
        k = torch.randn((1, Sk, hkv, Dh), generator=gen, device=dev)
        v = torch.randn((1, Sk, hkv, Dv), generator=gen, device=dev)
        do = torch.randn((1, S, hkv, G, Dv), generator=gen, device=dev)
        kw = dict(scale=1.0 / math.sqrt(Dh), causal=causal, window=window)
        got, want = (torch.autograd.grad(
            fn(*(t.requires_grad_() for t in (q, k, v)), **kw),
            (q, k, v), do)
            for fn in (lm_flash.flash_attention,
                       lambda *a, **w: lm_layers._attn_naive(
                           *a, q_offset=0, **w)))
        share = {f"d{n}": float((a - b).abs().max() / b.abs().max())
                 for n, a, b in zip("qkv", got, want)}
        out[case] = {"S": S, "Sk": Sk, "causal": causal, "window": window,
                     "heads": [hkv * G, hkv], "Dh": Dh, "Dv": Dv,
                     "share_of_max": share}
        check(max(share.values()) <= 1e-3,
              f"attention backward [{case}]: {share} of the largest |grad| "
              "off the plain attention's")
        del q, k, v, do, got, want
    emit({"phase": phase, **out})
    torch.cuda.empty_cache()
    return out


def lm_put_check(dev, cfg, phase="lm_put") -> dict:
    """(b) ``fused_backward`` at the LM put's shape: the 4,096 token
    occurrences of a B=2, S=2,048 batch, D=d_model (granite's 2,048 over
    its 49,155 vocab rows; whisper's 1,024 over 51,865); the hybrid put
    (the batch before's plan rows popped, random payload) and the sync
    put (its own sums), bit for bit against the
    plain version on the card (payload, table, accumulator); the hybrid
    put timed by graph replay beside its bound and the plain version."""
    spec = build_embedding_spec(cfg.vocab_size, cfg.d_model)
    backends = {"vocab": BK.create_backend(spec)}
    it = lm_batches(cfg.vocab_size, LM_TRAIN["batch"], LM_TRAIN["seq"],
                    seed=SEED + 22)
    plans = [BK.prepare_all(backends, {"vocab": None},
                            {"vocab": next(it)["tokens"]}, dev)[1]["vocab"]
             for _ in range(2)]
    prev, plan = plans
    n_occ, Dm, R = plan.inv.numel(), cfg.d_model, spec.padded_rows(1)
    cap = backends["vocab"].queue_width(n_occ)
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    table = torch.randn((R, Dm), generator=gen, device=dev) * 0.02
    acc = torch.rand((R,), generator=gen, device=dev) * 1e-6
    grads = torch.randn((n_occ, Dm), generator=gen, device=dev) * 1e-3
    idx = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    idx[:prev.rows.numel()] = prev.rows
    g = torch.randn((cap, Dm), generator=gen, device=dev) * 1e-3
    g[prev.rows.numel():] = 0
    errs, cases = [], {}
    for case, ai, ag, self_ in (("hybrid", idx, g, False),
                                ("sync", plan.rows, None, True)):
        outs = []
        for fn in (ops.fused_backward, ref.fused_backward_ref):
            t, a = table.clone(), acc.clone()
            push = fn(t, a, plan.order, plan.offsets, grads, ai, ag,
                      lr=EMB_LR, eps=1e-8, apply_self=self_)
            outs.append((push, t, a))
        torch.cuda.synchronize()
        for what, x, y in zip(("payload", "table", "acc"), *outs):
            errs.append(exact("fused_backward", f"lm_{case}: {what}", x, y))
        cases[case] = {"live_positions": int((ai >= 0).sum())}

    def put(fn):
        return lambda: fn(table, acc, plan.order, plan.offsets, grads, idx,
                          g, lr=EMB_LR, eps=1e-8)

    nb, no = fb_bound(plan, idx, False, Dm)
    b_bytes, b_ops = nb / HBM_BYTES_PER_S, no / FP32_OPS_PER_S
    out = {"n_occ": n_occ, "unique": int(plan.n_unique), "cap": cap,
           "D": Dm, "rows": R, "cases": cases, "max_abs_err": max(errs),
           "ms": device_ms(put(ops.fused_backward), 20),
           "eager_ms": eager_ms(put(ops.fused_backward), 20),
           "plain_ms": eager_ms(put(ref.fused_backward_ref), 2),
           "bound_ms": max(b_bytes, b_ops) * 1e3,
           "bound_by": "bytes" if b_bytes >= b_ops else "operations",
           "bound_bytes": nb}
    emit({"phase": phase, **out})
    del table, acc, grads, g
    torch.cuda.empty_cache()
    return out


def lm_batches_with_memory(cfg, p, seed, n, dev=None) -> list:
    """``n`` ``lm_batches`` of ``p["batch"]`` x ``p["seq"]`` tokens; for a
    model with cross-attention each carries its memory (frames or
    patches, random normal x 0.1 from ``seed``, as the serve draws them),
    on ``dev`` if given (else numpy: each trainer moves it)."""
    it = lm_batches(cfg.vocab_size, p["batch"], p["seq"], seed=seed)
    batches = [next(it) for _ in range(n)]
    shape = lm_serve.memory_shape(cfg, p["batch"])
    if shape is not None:
        rng = np.random.default_rng(seed)
        for b in batches:
            m = (rng.standard_normal(shape) * 0.1).astype(np.float32)
            b["memory"] = m if dev is None else torch.as_tensor(m,
                                                                device=dev)
    return batches


def lm_train_card_vs_cpu(dev, cfg=None, p=LM_TRAIN_CPU, seed=SEED + 24,
                         phase="lm_train_card_vs_cpu") -> dict:
    """(c) granite at full width cut to 2 layers (or ``cfg``: whisper's
    2 + 2 layer cut, each batch with its frames), B=1, S=256, hybrid(1):
    ``p["steps"]`` steps from one state (drawn on the card, copied to the
    CPU) on the card and on the CPU (TF32 off). Losses within rtol 1e-4.
    The dense parameters as ``dense_agreement`` holds them (Adam's updates
    agree in norm to 1e-3, no weight off by more than 2 lr a step). From
    the second step on the two models differ by that drift, so the
    gradients that reach the vocab table differ by more than rounding, and
    the row-wise adagrad step scales each row's gradient to about lr: the
    table is held like the dense parameters, its updates equal in norm to
    1e-3 and no element off by more than lr / 100 per applied put; the
    accumulator in norm to 1e-3; the queued put as the CTR check holds it
    (rtol 1e-3, atol 1e-3 of its largest element), its ids equal."""
    if cfg is None:
        cfg = get_config(LM_ARCH).replace(pattern_repeats=p["layers"])
    tg, tc = lm_trainer(cfg, dev), lm_trainer(cfg, "cpu")
    batches = lm_batches_with_memory(cfg, p, seed, p["steps"] + 1)
    sg = tg.init(seed, batches[0])
    sc = sg.to("cpu")
    start = tree_map(torch.clone, sc.dense)     # updated in place
    start_table = sc.emb["vocab"]["table"].clone()
    lg, lc = [], []
    for b in batches[1:]:
        sg, mg = tg.step(sg, b)
        sc, mc = tc.step(sc, b)
        lg.append(float(mg["loss"]))
        lc.append(float(mc["loss"]))
    dense = dense_agreement(start, sg.dense, sc.dense, p["steps"])
    ge, ce = sg.emb["vocab"], sc.emb["vocab"]
    gq, cq = sg.emb_queue["vocab"], sc.emb_queue["vocab"]
    applied = p["steps"] - cfg.emb_staleness

    def rel(x, y, base):
        return float((x.cpu() - y).double().norm()
                     / base.double().norm().clamp(min=1e-300))

    table_d = float((ge["table"].cpu() - ce["table"]).abs().max())
    q_scale = float(cq["grads"].abs().max())
    emb = {"table_max_abs": table_d,
           "table_update_rel": rel(ge["table"], ce["table"],
                                   ce["table"] - start_table),
           "acc_rel": rel(ge["acc"], ce["acc"], ce["acc"]),
           "queue_max_abs_share": float(
               (gq["grads"].cpu() - cq["grads"]).abs().max()) / q_scale}
    rec = {"phase": phase, **p, "d_model": cfg.d_model,
           "losses_card": lg, "losses_cpu": lc, **emb, **dense}
    emit(rec)
    check(np.allclose(lg, lc, rtol=1e-4, atol=0),
          f"{phase}: losses {lg} vs {lc}")
    check(emb["table_update_rel"] <= 1e-3
          and table_d <= EMB_LR / 100 * applied and emb["acc_rel"] <= 1e-3
          and torch.allclose(gq["grads"].cpu(), cq["grads"], rtol=1e-3,
                             atol=1e-3 * q_scale)
          and torch.equal(gq["ids"].cpu(), cq["ids"]),
          f"{phase}: vocab table, acc or queue {emb}")
    check(dense["ok"], f"{phase}: dense {dense}")
    del tg, tc, sg, sc, start, start_table
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# DeepSeek-V2 training; Mamba-2 and Jamba serving
# ---------------------------------------------------------------------------

def profile_run(fn):
    """``fn()`` under the profiler (device activity): ``(its result, wall
    s, device s, the top 8 device kernels as (name, ms), the device
    kernels run)``."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = device_times(prof)
    top = sorted(((us, k) for k, (us, _) in events.items()), reverse=True)
    return (out, wall, sum(us for us, _ in top) / 1e6,
            [(k, us / 1e3) for us, k in top[:8]],
            sum(n for us, n in events.values() if us > 0))


def lm_moe_train_phase(dev):
    """``PersiaTrainer(lm_adapter)`` at the full width of
    deepseek-v2-lite-16b cut to the prologue and 5 MoE layers (fp32, remat
    on), B=2, S=2,048, hybrid(1), Adam, on ``lm_batches``: 2 warm-up and 3
    timed steps, each 11 ``flash_attention_fwd`` at (192, 128) (the
    prologue's forward, which the JAX package does not checkpoint either,
    and each MoE layer's forward and remat recompute) and one
    ``fused_backward`` at D=2,048; one profiled step (``lm_train_run``);
    then the attention backward at the MLA shape against autograd through
    the plain attention and the 2-layer cut's step on the card against the
    CPU."""
    p = MOE_TRAIN
    cfg = get_config(MOE_ARCH).replace(pattern_repeats=p["repeats"])
    check(cfg.remat, "DeepSeek-V2's config must remat its layers")
    it = lm_batches(cfg.vocab_size, p["batch"], p["seq"], seed=SEED)
    batches = [next(it) for _ in range(1 + p["warmup"] + p["timed"] + 1)]
    per_step = len(cfg.prologue) + 2 * len(cfg.pattern) * cfg.pattern_repeats
    paths, common, m = lm_train_run(dev, cfg, p, batches, per_step,
                                    "lm moe train")
    rec = {"phase": "lm_moe_train", **common, "layers": cfg.n_layers,
           "cut": "depth: the prologue and "
           f"{p['repeats']} of 26 MoE layers, full width",
           "moe": {"experts": cfg.n_experts, "top_k": cfg.moe_top_k,
                   "shared": cfg.n_shared_experts, "d_ff": cfg.moe_d_ff,
                   "capacity": lm_moe.capacity(cfg, p["batch"] * p["seq"])},
           "remat": cfg.remat,
           "moe_aux": {k: float(m[k]) for k in ("moe_balance", "moe_z",
                                                "moe_drop_frac") if k in m}}
    emit(rec)
    mla = mla_shape()
    rec["attention_backward"] = attention_backward_check(
        dev, {"mla_layer": (p["seq"], 0, mla["H"], 1, mla["Dqk"],
                            mla["Dv"]),
              "mla_ragged_window": (1000, 256, mla["H"], 1, mla["Dqk"],
                                    mla["Dv"])},
        "lm_moe_attention_backward")
    rec["card_vs_cpu"] = lm_moe_train_card_vs_cpu(dev)
    return paths, rec


def lm_moe_train_card_vs_cpu(dev) -> dict:
    """deepseek-v2-lite-16b at full width cut to 2 layers (the mla + dense
    prologue and one mla + MoE layer), B=1, S=256: one step's ``lm_loss``
    (the MoE aux term included) and its gradients (every dense leaf and
    the activations), from one state drawn on the card, on the card and
    on the CPU, both runs' routing recorded. Where every token routed
    alike: the loss, and every gradient, within rtol 1e-4 / atol 1e-5
    (``lm_moe_card_vs_cpu``'s class); a flip must lie within 1e-5 of a
    top-k boundary, and it is reported."""
    p = MOE_TRAIN_CPU
    cfg = get_config(MOE_ARCH).replace(pattern_repeats=p["repeats"])
    bk, emb, dense = lm_state(cfg, dev, SEED + 25)
    b = next(lm_batches(cfg.vocab_size, p["batch"], p["seq"],
                        seed=SEED + 25))
    emb, dev_ids = bk.prepare(emb, torch.as_tensor(b["tokens"], device=dev))
    acts, _ = bk.lookup(emb, dev_ids)
    del emb

    def run(d):
        w = tree_map(lambda t: t.detach().to(d).requires_grad_(), dense)
        a = acts.detach().to(d).requires_grad_()
        with record_routing() as calls:
            loss, _ = lm_model.lm_loss(cfg, w, a, b["targets"], b["mask"])
            loss.backward()
        return (float(loss.detach()), [a.grad.cpu()] + [x.grad.cpu()
                                               for x in tree_leaves(w)],
                [(x.cpu(), y.cpu()) for x, y in calls])

    t0 = time.perf_counter()
    (lg, gg, rg), (lc, gcpu, rc) = run(dev), run(torch.device("cpu"))
    del dense, acts
    torch.cuda.empty_cache()
    flips = routing_flips(rc, rg, cfg.moe_top_k)
    worst = max(float(((x - y).abs() / (1e-5 + 1e-4 * y.abs())).max())
                for x, y in zip(gg, gcpu))
    rec = {"phase": "lm_moe_train_card_vs_cpu", **p,
           "layers": cfg.n_layers, "loss_card": lg, "loss_cpu": lc,
           "grad_leaves": len(gg), "grad_max_abs": max(
               float((x - y).abs().max()) for x, y in zip(gg, gcpu)),
           "grad_worst_share_of_tol": worst, "routing": flips,
           "seconds": time.perf_counter() - t0}
    emit(rec)
    note = flip_note(flips)
    check(flips["first_call"] is None, f"lm moe train card against CPU: "
          f"the step routed apart, its gradients are not comparable; "
          f"{note}")
    check(abs(lg - lc) <= 1e-4 * abs(lc),
          f"lm moe train card against CPU: loss {lg} vs {lc}")
    check(worst <= 1.0, f"lm moe train card against CPU: a gradient off by "
          f"{worst} of rtol 1e-4 / atol 1e-5")
    return rec


def full_serve(dev, cfg, want_flash: int, what: str, gates=None):
    """Random weights and vocab table from ``SEED`` on the card (with
    ``gates`` every ``xgate`` set to it); a warm-up serve, then the main
    path (``launch.serve.serve``, B=4, prompt 2,048,
    32 greedy tokens; the launch counts set to 0 just before): it must
    launch ``flash_attention_fwd`` ``want_flash`` times (one prefill) and
    nothing else, and give tokens in the vocab, equal on a second run
    under the profiler. Returns ``((launches, served), the record's
    common fields, (backend, emb state, dense params))``."""
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    part = {}
    t0 = time.perf_counter()
    bk, emb, dense = lm_state(cfg, dev, SEED)
    if gates is not None:
        open_gates(dense, gates)
    state = (emb, dense)
    n_dense = sum(t.numel() for t in tree_leaves(dense))
    lm_serve.serve(cfg, LM_B, LM_PROMPT, 2, SEED, device=dev, state=state)
    torch.cuda.synchronize()
    part["init_and_warmup"] = time.perf_counter() - t0

    # the main path: counts set to 0 just before
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    res = lm_serve.serve(cfg, LM_B, LM_PROMPT, LM_GEN, SEED, device=dev,
                         state=state)
    launches, served = ops.launch_counts(), ops.table_counts()
    part["serve"] = time.perf_counter() - t0
    want = dict.fromkeys(launches, 0)
    want["flash_attention_fwd"] = want_flash
    check(launches == want, f"{what}: launches {launches}, want {want} "
          "(one prefill)")
    toks = res["tokens"]
    check(toks.shape == (LM_B, LM_GEN) and toks.min() >= 0
          and toks.max() < cfg.vocab_size, f"{what} tokens {toks.shape}")
    t0 = time.perf_counter()
    again, wall, device_s, top, n_kernels = profile_run(
        lambda: lm_serve.serve(cfg, LM_B, LM_PROMPT, LM_GEN, SEED,
                               device=dev, state=state))
    check(np.array_equal(again["tokens"], toks),
          f"{what}: a second run gave other tokens")
    part["profiled"] = time.perf_counter() - t0
    rec = {"model": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": [cfg.vocab_size, cfg.padded_vocab],
           "dense_params": n_dense, "dense_gb": n_dense * 4 / 1e9,
           "batch": LM_B, "prompt": LM_PROMPT, "gen": LM_GEN,
           "prefill_ms": res["prefill_s"] * 1e3,
           "ms_per_token": res["decode_s"] * 1e3 / (LM_GEN - 1),
           "decode_tok_per_s": res["decode_tok_per_s"],
           "flash_launches_per_prefill": launches["flash_attention_fwd"],
           "profiled_wall_s": wall, "profiled_device_s": device_s,
           "device_busy_share": device_s / wall, "device_kernels": n_kernels,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "resident_gib_before": resident, "top_kernels_ms": top,
           "part_s": part, "first_tokens": toks[0, :8].tolist(),
           "first_token_by_row": toks[:, 0].tolist()}
    return (launches, served), rec, (bk, emb, dense)


def attention_launches(cfg) -> int:
    """``flash_attention_fwd`` launches of one prefill: a self-attention
    (gqa, mla) or cross-attention (the ``cross_attn`` mixer, a ``cross``
    sub-block) a launch, and each encoder layer's."""
    def per(blocks):
        return sum((b.mixer in ("gqa", "mla", "cross_attn")) + b.cross
                   for b in blocks)
    n = per(cfg.prologue) + per(cfg.pattern) * cfg.pattern_repeats
    if cfg.is_encdec:
        n += per(cfg.encoder.pattern) * cfg.encoder.pattern_repeats
    return n


def prefill_vs_plain(dev, cfg, bk, emb, dense, first_tokens, what) -> dict:
    """The serve's prefill (its prompts and memory) through the kernel and
    through the plain attention on the card: last-token logits finite,
    within 1e-3 of the largest, the first token equal in both and equal
    to the serve's (``first_tokens``, one a row)."""
    t0 = time.perf_counter()
    prompts, memory = lm_serve.make_inputs(cfg, LM_B, LM_PROMPT, SEED)
    prompts = torch.as_tensor(prompts, device=dev)
    memory = None if memory is None else torch.as_tensor(memory, device=dev)
    _, lk, _ = lm_serve.prefill_step(cfg, bk, emb, dense, prompts,
                                     LM_PROMPT + 1, memory)
    with mock.patch.object(lm_flash, "flash_attention", plain_attention):
        _, lp, _ = lm_serve.prefill_step(cfg, bk, emb, dense, prompts,
                                         LM_PROMPT + 1, memory)
    lk, lp = lk[:, 0, :cfg.vocab_size], lp[:, 0, :cfg.vocab_size]
    torch.cuda.synchronize()
    diff, top = float((lk - lp).abs().max()), float(lp.abs().max())
    check(bool(torch.isfinite(lk).all()), f"{what}: prefill logits not "
          "finite")
    check(diff <= 1e-3 * top, f"{what}: prefill logits through the kernel "
          f"and the plain attention differ by {diff} (largest {top})")
    check(torch.equal(lk.argmax(-1), lp.argmax(-1)),
          f"{what}: the first token differs with the plain attention")
    check(lk.argmax(-1).cpu().tolist() == list(first_tokens),
          f"{what}: serve's first token differs from the prefill's")
    del lk, lp, memory
    torch.cuda.empty_cache()
    return {"prefill_logit_diff_vs_plain": diff, "largest_logit": top,
            "prefill_vs_plain_s": time.perf_counter() - t0}


def encdec_serve_phase(dev):
    """``full_serve`` of whisper-medium at full width and depth (24
    encoder and 24 decoder layers, d_model 1,024, 16 heads of 64, GELU,
    LayerNorm, 51,865 vocab, learned decoder positions), fp32, B=4, a
    2,048-token prompt over 1,500 frames of 1,024 (random normal x 0.1,
    the serve's draw): 72 ``flash_attention_fwd`` a serve (24 encoder, 24
    self, 24 cross over the frames) and none in the decode (its
    cross-attention is plain torch over the cached memory K/V); the
    prefill through the kernel against the plain attention; then the cut
    to 2 + 2 layers on the card against the CPU, in the plain class (its
    GEMMs alone leave 4.8e-6 at d_model 1,024)."""
    cfg = get_config(ENCDEC_ARCH)
    n_attn = attention_launches(cfg)
    paths, rec, (bk, emb, dense) = full_serve(dev, cfg, n_attn,
                                              "encdec serve")
    rec.update(prefill_vs_plain(dev, cfg, bk, emb, dense,
                                rec["first_token_by_row"], "encdec serve"))
    del bk, emb, dense
    gc.collect()
    torch.cuda.empty_cache()
    e = cfg.encoder
    rec = {"phase": "encdec_serve", **rec,
           "encoder_layers": e.n_layers, "decoder_layers": cfg.n_layers,
           "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
           "memory": list(lm_serve.memory_shape(cfg, LM_B)),
           "attention_launches": {"encoder": e.n_layers,
                                  "self": cfg.n_layers,
                                  "cross": cfg.n_layers}}
    emit(rec)
    rec["card_vs_cpu"] = lm_cut_card_vs_cpu(
        dev, encdec_cut(cfg, ENCDEC_CPU["layers"]),
        {k: v for k, v in ENCDEC_CPU.items() if k != "layers"}, SEED + 31,
        "encdec_card_vs_cpu", dev)
    return paths, rec


def encdec_cut(cfg, layers: int):
    """An encoder-decoder cut to ``layers`` encoder and ``layers`` decoder
    layers, full width."""
    return cfg.replace(pattern_repeats=layers,
                       encoder=cfg.encoder.replace(pattern_repeats=layers))


def vlm_serve_phase(dev):
    """``full_serve`` of llama-3.2-vision-90b at full width cut to 1 of
    its 20 pattern repeats (4 gqa layers of 64 / 8 heads of 128 and one
    tanh-gated ``cross_attn`` layer over 1,600 patches of 8,192; d_ff
    28,672; vocab 128,256), fp32, every ``xgate`` at 0.5: 5
    ``flash_attention_fwd`` a serve (4 causal, a group of 8; 1 cross,
    2,048 x 1,600); the prefill through the kernel against the plain
    attention; then the gqa + cross_attn cut on the card against the CPU
    (split: at d_model 8,192 the fp32 GEMMs alone may leave more than atol
    1e-5)."""
    full = get_config(VLM_ARCH)
    cfg = full.replace(pattern_repeats=VLM_REPEATS)
    paths, rec, (bk, emb, dense) = full_serve(
        dev, cfg, attention_launches(cfg), "vlm serve", gates=XGATE)
    rec.update(prefill_vs_plain(dev, cfg, bk, emb, dense,
                                rec["first_token_by_row"], "vlm serve"))
    del bk, emb, dense
    gc.collect()
    torch.cuda.empty_cache()
    rec = {"phase": "vlm_serve", **rec,
           "cut": f"depth: {VLM_REPEATS} of 20 pattern repeats, full width",
           "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
           "d_ff": cfg.d_ff, "xgate": XGATE,
           "memory": list(lm_serve.memory_shape(cfg, LM_B))}
    emit(rec)
    cut = full.replace(pattern=(full.pattern[0], next(
        b for b in full.pattern if b.mixer == "cross_attn")),
        pattern_repeats=1)
    rec["card_vs_cpu"] = lm_cut_card_vs_cpu(dev, cut, VLM_CPU, SEED + 32,
                                            "vlm_card_vs_cpu", dev,
                                            split=True, gates=XGATE)
    return paths, rec


def encdec_train_phase(dev):
    """``PersiaTrainer(lm_adapter)`` at the full width and depth of
    whisper-medium (fp32, remat on in the encoder and the decoder), B=2,
    S=2,048, each row with 1,500 frames (random normal x 0.1 from the
    seed, on the card), hybrid(1), Adam: 2 warm-up and 3 timed steps (each
    144 ``flash_attention_fwd``: 72 forward, 72 remat recompute, and one
    ``fused_backward`` at D=1,024), one profiled step (``lm_train_run``);
    then the attention backward at the cross-attention's shape (2,048
    queries over 1,500 frames) and the encoder's (1,500, non-causal), the
    put at D=1,024 bit for bit, and the 2 + 2 layer cut trained 2 steps
    on the card against the CPU."""
    cfg = get_config(ENCDEC_ARCH)
    e = cfg.encoder
    check(cfg.remat and e.remat, "whisper's config must remat its layers")
    p = ENCDEC_TRAIN
    batches = lm_batches_with_memory(
        cfg, p, SEED, 1 + p["warmup"] + p["timed"] + 1, dev)
    paths, common, _ = lm_train_run(dev, cfg, p, batches,
                                    2 * attention_launches(cfg),
                                    "encdec train")
    del batches
    rec = {"phase": "encdec_train", **common,
           "layers": [e.n_layers, cfg.n_layers],
           "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
           "remat": [e.remat, cfg.remat],
           "memory": list(lm_serve.memory_shape(cfg, p["batch"]))}
    emit(rec)
    H, Dh, M = cfg.n_heads, cfg.head_dim, e.n_memory_tokens
    rec["attention_backward"] = attention_backward_check(
        dev, {"whisper_cross": (p["seq"], 0, H, 1, Dh, Dh, False, M),
              "whisper_encoder": (M, 0, e.n_heads, 1, e.head_dim,
                                  e.head_dim, False, M)},
        "encdec_attention_backward")
    rec["lm_put"] = lm_put_check(dev, cfg, "encdec_put")
    rec["card_vs_cpu"] = lm_train_card_vs_cpu(
        dev, encdec_cut(cfg, ENCDEC_TRAIN_CPU["layers"]), ENCDEC_TRAIN_CPU,
        SEED + 34, "encdec_train_card_vs_cpu")
    return paths, rec


def granite_cuts_phase(dev) -> dict:
    """granite-3-2b at full width cut to 2 layers with a 64-token sliding
    window (under the 256-token prompt: the kernel's windowed prefill and
    the ring decode's mask over the prefill's full-length cache) and with
    logit soft-capping at 50 (the capped attention is plain torch on the
    card, blockwise), each on the card against the CPU, split: granite's
    GEMMs alone leave up to 1.0e-5 from the CPU, at the atol."""
    base = get_config(LM_ARCH).replace(pattern_repeats=LM_CPU["layers"])
    p = {k: v for k, v in LM_CPU.items() if k != "layers"}
    out = {}
    for i, (name, kw) in enumerate(GRANITE_CUTS.items()):
        out[name] = lm_cut_card_vs_cpu(
            dev, base.replace(**kw), {**p, **kw}, SEED + 33 + i,
            f"granite_{name}_card_vs_cpu", dev, split=True)
    return out


def ssm_serve_phase(dev):
    """``full_serve`` of mamba2-1.3b at full width and depth (48 mamba2
    layers, d_model 2,048, 64 heads of 64, state 128, chunk 256), fp32: no
    kernel launch (the mixer is plain torch, as the JAX package's is jnp);
    then one layer's chunked forward against the step-by-step oracle on
    the card, within 1e-4 of the oracle's largest output, and the 2-layer
    cut on the card against the CPU."""
    cfg = get_config(SSM_ARCH)
    paths, rec, (bk, emb, dense) = full_serve(dev, cfg, 0, "ssm serve")
    t0 = time.perf_counter()
    layer = tree_map(lambda t: t[0], dense["stack"]["0"]["mixer"])
    gen = torch.Generator(device=dev).manual_seed(SEED + 26)
    x = torch.randn((1, LM_PROMPT, cfg.d_model), generator=gen, device=dev)
    with torch.no_grad():
        chunked = lm_ssm.mamba2_forward(layer, cfg, x)
        oracle = lm_ssm.mamba2_reference_scan(layer, cfg, x)
    torch.cuda.synchronize()
    ssd_err = float((chunked - oracle).abs().max())
    ssd_top = float(oracle.abs().max())
    rec["part_s"]["ssd_vs_oracle"] = time.perf_counter() - t0
    check(math.isfinite(ssd_err) and ssd_err <= 1e-4 * ssd_top,
          f"ssm: one layer's chunked SSD {ssd_err} off the recurrence "
          f"(largest |out| {ssd_top})")
    del bk, emb, dense, layer, x, chunked, oracle
    gc.collect()
    torch.cuda.empty_cache()
    rec = {"phase": "ssm_serve", **rec,
           "ssm": {"heads": lm_ssm.ssm_dims(cfg)[1],
                   "head_dim": cfg.ssm_head_dim, "state": cfg.ssm_state,
                   "chunk": cfg.ssm_chunk, "conv": cfg.ssm_conv_width},
           "ssd_vs_oracle_max_abs": ssd_err, "ssd_largest_out": ssd_top}
    emit(rec)
    cut = cfg.replace(pattern_repeats=SSM_CPU["repeats"])
    rec["card_vs_cpu"] = lm_cut_card_vs_cpu(dev, cut, SSM_CPU, SEED + 27,
                                            "ssm_card_vs_cpu", dev)
    return paths, rec


def hybrid_serve_phase(dev):
    """``full_serve`` of jamba-v0.1-52b at full width cut to 1 of its 4
    pattern repeats (8 layers: 7 mamba2 and 1 GQA of 32 / 8 heads of 128;
    4 dense FFNs and 4 MoE of 16 experts top-2 of 14,336; vocab 65,536),
    fp32: one ``flash_attention_fwd`` per prefill at (128, 128), a group of
    4; the decode's weight bytes; then the 2-layer cut (the GQA + dense
    block and the mamba2 + MoE block) on the card against the CPU."""
    cfg = get_config(HYBRID_ARCH).replace(pattern_repeats=HYBRID_REPEATS)
    n_attn = sum(b.mixer == "gqa" for b in cfg.pattern) * cfg.pattern_repeats
    paths, rec, (bk, emb, dense) = full_serve(dev, cfg, n_attn,
                                              "hybrid serve")
    weights = moe_weight_bytes(cfg, dense)
    del bk, emb, dense
    gc.collect()
    torch.cuda.empty_cache()
    rec = {"phase": "hybrid_serve", **rec,
           "cut": f"depth: {HYBRID_REPEATS} of 4 pattern repeats, full "
           "width", "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
           "moe": {"experts": cfg.n_experts, "top_k": cfg.moe_top_k,
                   "d_ff": cfg.moe_d_ff, "capacity_prefill":
                   lm_moe.capacity(cfg, LM_B * LM_PROMPT),
                   "capacity_decode": lm_moe.capacity(cfg, LM_B)},
           **weights}
    emit(rec)
    full = get_config(HYBRID_ARCH)
    cut = full.replace(pattern=tuple(full.pattern[i]
                                     for i in HYBRID_CPU["blocks"]),
                       pattern_repeats=1)
    rec["card_vs_cpu"] = lm_cut_card_vs_cpu(
        dev, cut, {k: v for k, v in HYBRID_CPU.items() if k != "blocks"},
        SEED + 28, "hybrid_card_vs_cpu", dev, split=True)
    return paths, rec


def logical_rows(trainer, state, n):
    """Table ``n``'s logical rows and accumulators (what a lookup of each
    id reads), read off its checkpoint blob."""
    spec = trainer.collection[n]
    blob = BK.unwrap(trainer.backends[n]).state_for_checkpoint(state.emb[n])
    return BK.extract_logical_rows(
        blob, spec, BK.parse_backend_name(spec.backend)[0])


def same_rows(ta, sa, tb, sb) -> list:
    """The tables whose logical rows or accumulators differ in any bit."""
    bad = []
    for n in ta.collection.names:
        (va, aa), (vb, ab) = logical_rows(ta, sa, n), logical_rows(tb, sb, n)
        if not (np.array_equal(va, vb) and np.array_equal(aa, ab)):
            bad.append(n)
    return bad


def counted_steps(trainer, state, batches, what):
    """:func:`run_steps` (launch counts set to 0 just before, checked
    against :func:`step_launches`), timed to a synchronize, with the
    router's sum-only ``fused_backward`` launches counted apart (the calls
    of ``dedup.csr_segment_sum``): (state, losses, launches, tables
    served, wall s, sum-only launches)."""
    with mock.patch.object(D, "csr_segment_sum",
                           wraps=D.csr_segment_sum) as sums:
        t0 = time.perf_counter()
        state, losses, launches, _, served = run_steps(trainer, state,
                                                       batches, what)
        wall = time.perf_counter() - t0
    return state, losses, launches, served, wall, sums.call_count


def router_card_vs_cpu(dev, ds, steps) -> dict:
    """The 4-shard router at kwai-dlrm's 62,500 rows on the card and on the
    CPU, fed the same inputs at every step: each router prepares, looks up
    and puts from its own state, the CPU's with the card's activation
    gradients, and the CPU's FFNN runs from a copy of the card's dense
    state. The pooled bags, every shard's table, accumulator and queue
    must be equal bit for bit after every step, the loss within rtol 1e-4.
    (Whole trajectories apart are not held to ``card_vs_cpu``'s rule
    here: from this start a ReLU pre-activation lands within rounding of
    0 in the first step, the two FFNNs' gradients differ in sign on some
    weights, and Adam's first step moves each weight by about lr whatever
    its gradient's size, so the dense parameters part by 2 lr at once.)"""
    it = ds.sampler(TRAIN_B, seed=SEED + 20)
    batches = [next(it) for _ in range(steps)]
    tg = kwai_train_trainer(dev, TrainMode.hybrid(TAU), shards=SHARDS)
    tc = kwai_train_trainer("cpu", TrainMode.hybrid(TAU), shards=SHARDS)
    sg = tg.init(seed=SEED + 1, batch_example=batches[0])
    sc = sg.to("cpu")
    (lg, dg, pg_), (lc, dc, pc_) = tg.decomposed_fns(), tc.decomposed_fns()
    to_cpu = lambda x: x.to("cpu", copy=True) \
        if isinstance(x, torch.Tensor) else x  # noqa: E731
    bad, loss_card, loss_cpu = [], [], []
    for i, b in enumerate(batches):
        sg, ig, _ = tg._prepare(sg, b)
        sc, ic, _ = tc._prepare(sc, b)
        pooled_g, _ = lg(sg.emb, ig)
        pooled_c, _ = lc(sc.emb, ic)
        if not all(torch.equal(pooled_g[n].cpu(), pooled_c[n])
                   for n in pooled_g):
            bad.append(f"step {i}: pooled bags")
        # the CPU's FFNN from a copy of the card's dense state (the dense
        # step updates its arguments in place)
        _, _, _, _, mc = dc(tree_map(to_cpu, sg.dense),
                            tree_map(to_cpu, sg.opt),
                            tree_map(to_cpu, sg.dense_queue), pooled_c, b,
                            sg.step)
        dense, opt, dq, agrads, mg = dg(sg.dense, sg.opt, sg.dense_queue,
                                        pooled_g, b, sg.step)
        loss_card.append(float(mg["loss"]))
        loss_cpu.append(float(mc["loss"]))
        emb, queues, _ = pg_(sg.emb, sg.emb_queue, ig, agrads)
        emb_c, queues_c, _ = pc_(sc.emb, sc.emb_queue, ic,
                                 {n: g.cpu() for n, g in agrads.items()})
        sg = sg.replace(dense=dense, opt=opt, emb=emb, emb_queue=queues,
                        dense_queue=dq, step=sg.step + 1)
        sc = sc.replace(emb=emb_c, emb_queue=queues_c, step=sc.step + 1)
        for n in sg.emb:
            if not all(torch.equal(x.cpu(), y) for x, y in zip(
                    tree_leaves(sg.emb[n]), tree_leaves(sc.emb[n]))):
                bad.append(f"step {i}: {n} tables or accumulators")
            if not all(torch.equal(x.cpu(), y) if isinstance(
                    x, torch.Tensor) else x == y for x, y in zip(
                    tree_leaves(sg.emb_queue[n]),
                    tree_leaves(sc.emb_queue[n]))):
                bad.append(f"step {i}: {n} queues")
    if not np.allclose(loss_card, loss_cpu, rtol=1e-4):
        bad.append(f"losses card {loss_card} cpu {loss_cpu}")
    out = {"phase": "router_card_vs_cpu", "rows": ds.rows_per_field,
           "shards": SHARDS, "mode": f"hybrid({TAU})", "steps": steps,
           "loss_card": loss_card, "loss_cpu": loss_cpu,
           "bit_equal": not bad}
    emit(out)
    check(not bad, "router card against CPU: " + "; ".join(bad[:6]))
    return out


def sharded_dense_runs(dev, ds, batches) -> dict:
    """kwai-dlrm at full width with its tables at 65,536 rows, dense, on
    one shard and on the router's 4, from one seed: warm-up, then timed
    steps with the launch counts read around them."""
    st, runs = SHARD_STEPS, {}
    for k in (1, SHARDS):
        tr = kwai_train_trainer(dev, TrainMode.hybrid(TAU), shards=k,
                                rows=SHARD_ROWS_POW2)
        t0 = time.perf_counter()
        s = tr.init(seed=SEED, batch_example=batches[0])
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        warm = []
        for b in batches[:st["warmup"]]:
            s, m = tr.step(s, b)
            warm.append(float(m["loss"]))
        torch.cuda.synchronize()
        s, losses, launches, served, wall, n_sum = counted_steps(
            tr, s, batches[st["warmup"]:], f"dense, {k} shard(s)")
        runs[k] = {"trainer": tr, "state": s, "losses": warm + losses,
                   "launches": launches, "served": served, "wall": wall,
                   "sum_only": n_sum, "init_s": init_s}
    return runs


def sharded_serve(dev, ds, runs) -> tuple[dict, dict]:
    """Both dense states behind a ``ServingService(max_batch=64)``, 512
    requests from 4 clients: every flush ONE bag launch of the 32 tables
    (on the router, each table's unique rows gathered from its shards into
    one block); predictions of the two equal bit for bit (a flush is
    padded to 64 rows, so a request's row does not depend on its batch)
    and equal to the plain lookup's (rtol 1e-5 / atol 1e-6)."""
    reqs = [r for _, r in TrafficModel.for_dataset(ds, seed=SEED)
            .requests(N_REQUESTS, seed=1)]
    config = ServingConfig(max_batch=64, max_wait_ms=2.0)
    out, counts = {}, None
    for k, run in runs.items():
        tr, state = run["trainer"], run["state"]
        cell = StateCell(state, state.step)
        serve(tr, cell, reqs[:128], config)             # warm-up
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        preds, m = serve(tr, cell, reqs, config)
        launches, served = ops.launch_counts(), ops.table_counts()
        flushes = int(m["serving/batches"])
        check(launches["unique_bag"] == flushes and launches[
            "embedding_bag"] == 0 and served["unique_bag"] ==
            N_TABLES * flushes, f"sharded serve, {k} shard(s): launches "
            f"{launches} (tables {served}) for {flushes} flushes")
        plain = plain_predict(tr, state, stack(reqs))
        check(np.allclose(preds, plain, rtol=1e-5, atol=1e-6),
              f"sharded serve, {k} shard(s): predictions differ from the "
              f"plain read by {float(np.abs(preds - plain).max())}")
        out[k] = {"preds": preds, "p50_ms": m["serving/p50_ms"],
                  "p99_ms": m["serving/p99_ms"], "qps": m["serving/qps"],
                  "flushes": flushes,
                  "max_abs_diff_vs_plain": float(np.abs(preds
                                                        - plain).max())}
        if k == SHARDS:
            counts = (launches, served)
    same = np.array_equal(out[1]["preds"], out[SHARDS]["preds"])
    check(same, "sharded serve: 4-shard predictions differ from one "
          f"shard's by {float(np.abs(out[1]['preds'] - out[SHARDS]['preds']).max())}")
    for v in out.values():
        del v["preds"]
    return counts, {"requests": N_REQUESTS, "max_batch": 64,
                    "bit_equal": same, "by_shards": out}


def sharded_reshard(dev, runs, batch) -> dict:
    """The 4-shard dense state saved to disk (under the git-ignored
    build/) and restored into 1 and 2 shards: every logical row and
    accumulator exact, the queues restarted empty, one more step finite."""
    import shutil

    from repro_torch.checkpoint import checkpoint_shard_layout
    t4, s4 = runs[SHARDS]["trainer"], runs[SHARDS]["state"]
    path = ROOT / "build" / "sharded_ckpt"
    shutil.rmtree(path, ignore_errors=True)
    t0 = time.perf_counter()
    t4.save(str(path), s4)
    out = {"save_s": time.perf_counter() - t0}
    layout = checkpoint_shard_layout(str(path))
    check(set(layout.values()) == {SHARDS}, f"shard layout {layout}")
    try:
        for m in (1, 2):
            tm = kwai_train_trainer(dev, TrainMode.hybrid(TAU), shards=m,
                                    rows=SHARD_ROWS_POW2)
            t0 = time.perf_counter()
            r = tm.restore(str(path))
            restore_s = time.perf_counter() - t0
            bad = same_rows(t4, s4, tm, r)
            check(not bad, f"4 -> {m} shards: tables {bad[:4]} differ")
            empty = all(int(p["ids"].max()) == -1 for n in r.emb_queue
                        for p in parts(r.emb_queue[n]))
            resharded = all(b.last_restore_resharded
                            for b in tm.backends.values())
            check(empty and resharded, f"4 -> {m} shards: queues not "
                  "restarted or restore not marked resharded")
            r, mt = tm.step(r, batch)
            check(np.isfinite(float(mt["loss"])), f"4 -> {m}: loss")
            out[f"to_{m}"] = {"restore_s": restore_s, "rows_exact": True,
                              "queues_restarted": True,
                              "next_loss": float(mt["loss"])}
            del tm, r
    finally:
        shutil.rmtree(path, ignore_errors=True)
    return out


def sharded_lru_runs(dev, ds) -> dict:
    """kwai-dlrm at full width on host_lru (62,500 rows, 7,812 cache slots
    a table: 1,953 a shard on the router), one shard against 4 from one
    seed: warm-up, timed steps that evict (counts read around them), then
    staged steps with the prepare split by part; faults, write-backs and
    hits a step, the imbalance gauge."""
    st, runs = SHARD_STEPS, {}
    it = ds.sampler(TRAIN_B, seed=SEED + 31)
    batches = [next(it) for _ in range(st["warmup"] + st["lru"]
                                       + st["staged"])]
    w = st["warmup"]
    for k in (1, SHARDS):
        tr = kwai_train_trainer(dev, TrainMode.hybrid(TAU), HOST_LRU,
                                shards=k)
        t0 = time.perf_counter()
        s = tr.init(seed=SEED, batch_example=batches[0])
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        losses = []
        for b in batches[:w]:
            s, m = tr.step(s, b)
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        c0 = lru_counters(tr)
        s, ls, launches, served, wall, n_sum = counted_steps(
            tr, s, batches[w:w + st["lru"]], f"host_lru, {k} shard(s)")
        losses += ls
        per_step = lru_delta(c0, lru_counters(tr), st["lru"])
        times, split = {}, {}
        for b in batches[w + st["lru"]:]:
            c = lru_counters(tr)
            s, m = staged_step(tr, s, b, times)
            losses.append(float(m["loss"]))
            for key, v in lru_delta(c, lru_counters(tr)).items():
                split.setdefault(key, []).append(v)
        med = {key: float(np.median(v)) for key, v in times.items()}
        part = {key: float(np.median(v)) * 1e3
                for key, v in split.items() if key.endswith("_s")}
        gauges = BK.shard_step_metrics(tr.backends)
        imb = [v for key, v in gauges.items() if key.endswith("/imbalance")]
        runs[k] = {
            "trainer": tr, "state": s, "losses": losses,
            "launches": launches, "served": served, "init_s": init_s,
            "step_ms": wall * 1e3 / st["lru"],
            "steps_per_s": st["lru"] / wall, "sum_only": n_sum,
            "per_step": per_step, "breakdown_ms": med,
            # host seconds summed over the shards: on the router they run
            # on its pool, so their sum can exceed the prepare's wall
            "prepare_parts_ms": {
                "fault_in": part["fault_s"], "eviction": part["evict_s"],
                "eviction_sync": part["evict_sync_s"]},
            "imbalance_max": max(imb) if imb else None,
            "imbalance_mean": float(np.mean(imb)) if imb else None,
            "writebacks": sum(b.writebacks for b in lru_backends(tr))}
        check(runs[k]["writebacks"] > 0,
              f"host_lru, {k} shard(s): no row written back")
    return runs


def sharded_pipeline(dev, ds, trainer, state) -> tuple[dict, dict]:
    """The warmed (evicting) 4-shard host_lru state as a snapshot, run
    serially, through ``PipelinedTrainer(max_inflight=1)`` (bit for bit
    with serial) and at ``PIPE_INFLIGHT`` with a look-ahead (every put in
    order, the put window min(4, 3) held on every shard, every pin
    released), each making the serial step's launches."""
    tree = snapshot(trainer, state)
    it = ds.sampler(TRAIN_B, seed=SEED + 32)
    batches = [next(it) for _ in range(SHARD_STEPS["pipe"])]
    n = len(batches)
    runs, counts = {}, None
    for runner in ("serial", "pipelined_1", "pipelined_deep"):
        tr = kwai_train_trainer(dev, TrainMode.hybrid(TAU), HOST_LRU,
                                shards=SHARDS)
        s = restore(tr, tree)
        engine = pipe_engine(tr, runner)
        ops.reset_launch_counts()
        s, losses, wall = pipe_run(tr, engine, s, batches)
        launches, served = ops.launch_counts(), ops.table_counts()
        per_step, tables = step_launches(tr)
        check(launches == {k: v * n for k, v in per_step.items()}
              and served == {k: v * n for k, v in tables.items()},
              f"sharded {runner}: launches {launches} (tables {served})")
        losses = [float(x) for x in losses]
        check(all(np.isfinite(losses)), f"sharded {runner}: {losses}")
        runs[runner] = {"run": (s, losses, lru_state_bits(tr, s)),
                        "steps_per_s": n / wall}
        if engine is not None and runner == "pipelined_deep":
            check(engine.applied_order == list(range(n)),
                  f"sharded deep: order {engine.applied_order}")
            worst = max(engine.max_outstanding.values())
            check(worst <= min(PIPE_INFLIGHT, TAU),
                  f"sharded deep: {worst} puts outstanding")
            check(not any(b._pin_count.any() for b in lru_backends(tr)),
                  "sharded deep: pins left")
            runs[runner]["max_outstanding"] = worst
            counts = (launches, served)
        del tr
    bad = same_run(runs["serial"]["run"], runs["pipelined_1"]["run"])
    check(not bad, f"sharded pipelined_1 differs from serial: {bad}")
    for v in runs.values():
        del v["run"]
    return counts, {"steps": n, "inflight1_bit_equal": True, **runs}


def sharded_phase(dev, router_cpu: dict):
    """The sharded embedding-PS router at kwai-dlrm's full width (32 tables
    x D=128, FFNN 4112 -> ... -> 4, batch 512, hybrid(3), k=4), with
    ``router_card_vs_cpu``'s record ``router_cpu``. Returns the main
    paths' counts (the 4-shard runs) and the record."""
    ds = CTR_BENCHMARKS["kwai_video"]
    st = SHARD_STEPS
    t_phase = time.perf_counter()
    paths, rec = {}, {"phase": "sharded", "model": KWAI.name,
                      "shards": SHARDS, "batch": TRAIN_B,
                      "mode": f"hybrid({TAU})"}
    # (a) dense at 65,536 rows a table (no shuffle collision): 4 shards
    # against 1, bit for bit; serving; the reshard from disk
    it = ds.sampler(TRAIN_B, seed=SEED + 30)
    batches = [next(it) for _ in range(st["warmup"] + st["dense"])]
    runs = sharded_dense_runs(dev, ds, batches)
    (t1, s1), (t4, s4) = ((runs[k]["trainer"], runs[k]["state"])
                          for k in (1, SHARDS))
    check(runs[1]["losses"] == runs[SHARDS]["losses"],
          f"sharded dense: losses {runs[1]['losses']} against "
          f"{runs[SHARDS]['losses']}")
    bad = same_rows(t1, s1, t4, s4)
    check(not bad, f"sharded dense: tables {bad[:4]} differ from one shard")
    eb = next(ds.sampler(4096, seed=SEED + 4))
    e1, e4 = float(t1.eval(s1, eb)["loss"]), float(t4.eval(s4, eb)["loss"])
    check(e1 == e4, f"sharded dense: eval {e1} against {e4}")
    check(runs[SHARDS]["sum_only"] == N_TABLES * st["dense"]
          and runs[1]["sum_only"] == 0,
          f"sum-only launches {runs[SHARDS]['sum_only']} / "
          f"{runs[1]['sum_only']}")
    paths["train_sharded"] = (runs[SHARDS]["launches"],
                              runs[SHARDS]["served"])
    paths["serve_sharded"], rec["serve"] = sharded_serve(dev, ds, runs)
    rec["reshard"] = sharded_reshard(dev, runs, batches[0])
    rec["dense_65536"] = {
        k: {"init_s": r["init_s"], "step_ms": r["wall"] * 1e3 / st["dense"],
            "steps_per_s": st["dense"] / r["wall"],
            "launches_per_step": {key: v / st["dense"]
                                  for key, v in r["launches"].items()},
            "sum_only_per_step": r["sum_only"] / st["dense"],
            "apply_only_per_step": (r["launches"]["fused_backward"]
                                    - r["sum_only"]) / st["dense"]
            if k > 1 else 0.0, "losses": r["losses"]}
        for k, r in runs.items()}
    rec["dense_65536"]["bit_equal"] = {"losses": True, "rows": True,
                                       "eval": True, "eval_loss": e4}
    del runs, t1, s1, t4, s4
    torch.cuda.empty_cache()
    # (b) dense at the config's 62,500 rows: the router on the card
    # against the router on the CPU (shuffle collisions make one shard
    # differ from four there, in both packages), run before this phase
    rec["card_vs_cpu_62500"] = router_cpu
    # (c) host_lru at 62,500 rows, 7,812 slots: 4 shards against 1
    lru = sharded_lru_runs(dev, ds)
    (t1, s1), (t4, s4) = ((lru[k]["trainer"], lru[k]["state"])
                          for k in (1, SHARDS))
    check(lru[1]["losses"] == lru[SHARDS]["losses"],
          f"sharded host_lru: losses {lru[1]['losses']} against "
          f"{lru[SHARDS]['losses']}")
    bad = same_rows(t1, s1, t4, s4)
    check(not bad, f"sharded host_lru: tables {bad[:4]} differ")
    paths["train_sharded_host_lru"] = (lru[SHARDS]["launches"],
                                       lru[SHARDS]["served"])
    rec["host_lru_62500"] = {
        k: {key: v for key, v in r.items()
            if key not in ("trainer", "state", "launches", "served")}
        | {"launches_per_step": {key: v / st["lru"]
                                 for key, v in r["launches"].items()}}
        for k, r in lru.items()}
    rec["host_lru_62500"]["bit_equal"] = {"losses": True, "rows": True}
    del t1, s1
    lru.pop(1)
    torch.cuda.empty_cache()
    # (d) the pipelined trainer over the sharded host_lru table
    paths["train_sharded_pipelined"], rec["pipelined"] = sharded_pipeline(
        dev, ds, t4, s4)
    del lru, t4, s4
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    emit(rec)
    return paths, rec


# ---------------------------------------------------------------------------
# the multi-process embedding PS
# ---------------------------------------------------------------------------

def ps_threads(dev, k):
    """k PS servers as threads of this process on ``dev``."""
    return [PSServer(device=dev).start() for _ in range(k)]


def remote_trainer(dev, endpoints, backend="dense", **kw):
    """kwai-dlrm's trainer with its tables over the PS ``endpoints``."""
    tr = kwai_train_trainer(dev, TrainMode.hybrid(TAU), backend)
    connect_remote_backends(tr, endpoints, **kw)
    return tr


def close_remote(trainer, servers=()):
    for b in trainer.backends.values():
        if b.remote:
            b.close()
    for s in servers:
        s.stop()


def endpoints_of(servers):
    return [("127.0.0.1", s.port) for s in servers]


def clients(trainer) -> list:
    """The trainer's distinct RPC connections (tables share one an
    endpoint)."""
    seen = {}
    for b in trainer.backends.values():
        for sub in getattr(b, "shard_backends", None) or [b]:
            seen[id(sub._client)] = sub._client
    return list(seen.values())


def wire_counters(trainer) -> dict:
    cs = clients(trainer)
    return {"frames": sum(c.frames_sent for c in cs),
            "bytes": sum(c.bytes_sent + c.bytes_recv for c in cs)}


def remote_pair(dev, ds, batches, what, backend="dense", k=1):
    """The in-process trainer (the router at k > 1) and the remote trainer
    over k PS threads on the card, from one seed, ``batches`` each with
    the launch counts read around them: the two must agree bit for bit
    (losses, every logical row and accumulator). Returns the remote run's
    (launches, served), sum-only launches, wire bytes and losses."""
    tr0 = kwai_train_trainer(dev, TrainMode.hybrid(TAU), backend, shards=k)
    s0 = tr0.init(seed=SEED, batch_example=batches[0])
    s0, l0, _, _, _, _ = counted_steps(tr0, s0, batches,
                                       f"{what}, in process")
    servers, tr1 = ps_threads(dev, k), None
    try:
        tr1 = remote_trainer(dev, endpoints_of(servers), backend)
        s1 = tr1.init(seed=SEED, batch_example=batches[0])
        c0 = wire_counters(tr1)
        with mock.patch.object(D, "csr_segment_sum",
                               wraps=D.csr_segment_sum) as sums:
            s1, l1, launches, wire, served = run_steps(tr1, s1, batches,
                                                       f"{what}, remote")
        c1 = wire_counters(tr1)
        check(l0 == l1, f"{what}: losses {l1} against in-process {l0}")
        bad = same_rows(tr0, s0, tr1, s1)
        check(not bad, f"{what}: tables {bad[:4]} differ from in-process")
        n = len(batches)
        check(sums.call_count == N_TABLES * n and launches[
            "fused_backward"] - sums.call_count == N_TABLES * k * n,
            f"{what}: {sums.call_count} sum-only of "
            f"{launches['fused_backward']} fused_backward launches")
        return {"launches": launches, "served": served, "losses": l1,
                "losses_in_process": l0,
                "wire": wire, "steps": n,
                "wire_mb_per_step": (c1["bytes"] - c0["bytes"]) / n / 1e6}
    finally:
        if tr1 is not None:
            close_remote(tr1)
        for srv in servers:
            srv.stop()
        torch.cuda.synchronize()


def remote_same_runs(dev, ds) -> dict:
    """(a) of the phase: the bit checks over PS threads on the card."""
    st = REMOTE_STEPS
    it = ds.sampler(TRAIN_B, seed=SEED + 40)
    batches = [next(it) for _ in range(st["warmup"] + st["lru"])]
    it = ds.sampler(TRAIN_B, seed=REMOTE_TIMED_SEED)
    timed = [next(it) for _ in range(st["lossy"])]
    runs, paths, secs = {}, {}, {}
    for key, backend, k, bs in (
            ("dense_k1", "dense", 1, batches[:st["warmup"] + st["dense"]]),
            ("host_lru_k1", HOST_LRU, 1, batches),
            ("dense_k4", "dense", REMOTE_K, batches[:st["k4"]]),
            ("lossy_k1", WIRE, 1, timed)):
        t0 = time.perf_counter()
        runs[key] = remote_pair(dev, ds, bs, f"remote {key}", backend, k)
        torch.cuda.empty_cache()
        secs[key] = time.perf_counter() - t0
    paths["train_remote"] = (runs["dense_k1"]["launches"],
                             runs["dense_k1"]["served"])
    paths["train_remote_host_lru"] = (runs["host_lru_k1"]["launches"],
                                      runs["host_lru_k1"]["served"])
    paths["train_remote_sharded"] = (runs["dense_k4"]["launches"],
                                     runs["dense_k4"]["served"])
    paths["train_remote_lossy"] = (runs["lossy_k1"]["launches"],
                                   runs["lossy_k1"]["served"])
    w = runs["lossy_k1"]["wire"]
    lossy_ratio = w["bytes_raw"] / max(w["bytes_wire"], 1.0)
    check(lossy_ratio >= 1.8, f"remote lossy: wire byte ratio {lossy_ratio}")
    # the bytes the connection really moved a step, raw against lossy wire
    socket_ratio = runs["dense_k1"]["wire_mb_per_step"] \
        / runs["lossy_k1"]["wire_mb_per_step"]
    # pipelined max_inflight=1 against serial, and the blocking transport
    # against the pipelined one, each over its own PS threads
    out = {}
    for key, runner, backend, k, kw, n in (
            ("serial", "serial", HOST_LRU, 1, {}, st["pipe"]),
            ("pipelined_1", "pipelined_1", HOST_LRU, 1, {}, st["pipe"]),
            ("pipelined_wire", "serial", HOST_LRU, REMOTE_K, {},
             st["blocking"]),
            ("blocking_wire", "serial", HOST_LRU, REMOTE_K,
             {"pipelined": False}, st["blocking"])):
        t0 = time.perf_counter()
        servers = ps_threads(dev, k)
        tr = remote_trainer(dev, endpoints_of(servers), backend, **kw)
        try:
            s = tr.init(seed=SEED, batch_example=batches[0])
            c0 = wire_counters(tr)
            s, losses, wall = pipe_run(tr, pipe_engine(tr, runner), s,
                                       batches[:n])
            for name, b in tr.backends.items():
                b.sync(s.emb[name])
            c1 = wire_counters(tr)
            rows = {name: logical_rows(tr, s, name) for name in s.emb}
            out[key] = {"losses": [float(x) for x in losses],
                        "rows": rows, "steps_per_s": n / wall,
                        "frames_per_step": (c1["frames"] - c0["frames"]) / n}
        finally:
            close_remote(tr, servers)
        torch.cuda.empty_cache()
        secs[key] = time.perf_counter() - t0

    def same(a, b):
        return out[a]["losses"] == out[b]["losses"] and all(
            np.array_equal(x, y) for name in out[a]["rows"]
            for x, y in zip(out[a]["rows"][name], out[b]["rows"][name]))
    check(same("serial", "pipelined_1"),
          "remote pipelined_1 differs from serial")
    check(same("pipelined_wire", "blocking_wire"),
          "remote blocking transport differs from the pipelined one")
    check(out["blocking_wire"]["frames_per_step"]
          > out["pipelined_wire"]["frames_per_step"],
          f"remote frames a step: blocking {out['blocking_wire']} against "
          f"pipelined {out['pipelined_wire']}")
    for v in out.values():
        del v["rows"]
    rec = {key: {"steps": r["steps"], "losses": r["losses"],
                 "losses_in_process": r["losses_in_process"],
                 "wire_mb_per_step": r["wire_mb_per_step"],
                 "launches_per_step": {n: v / r["steps"]
                                       for n, v in r["launches"].items()},
                 "wire_bytes_per_step": {n: v / r["steps"]
                                         for n, v in r["wire"].items()}}
           for key, r in runs.items()}
    rec.update(bit_equal={key: True for key in runs},
               lossy_wire_byte_ratio=lossy_ratio,
               lossy_wire_mb_ratio=socket_ratio,
               inflight1_bit_equal=True, blocking_bit_equal=True,
               seconds=secs,
               frames_per_step={k: v["frames_per_step"]
                                for k, v in out.items()})
    return paths, rec


def ps_launches(members) -> dict:
    """The PS processes' kernel launch counts, summed."""
    total = {}
    for m in members:
        c = RpcClient(m.host, m.port, timeout=30.0, retries=0)
        try:
            for k, v in c.call("metrics")["launches"].items():
                total[k] = total.get(k, 0) + v
        finally:
            c.close()
    return total


def ps_seconds(trainer) -> dict:
    """The PS-side seconds of every table's prepares, lookups, reads and
    puts, summed over tables and shards."""
    total = {}
    for b in trainer.backends.values():
        for sub in getattr(b, "shard_backends", None) or [b]:
            for k, v in sub.remote_metrics()["seconds"].items():
                total[k] = total.get(k, 0.0) + v
    return total


def thread_staged(trainer, state, batch, times):
    """``staged_step`` with each stage's thread seconds beside its wall:
    what of a remote stage is this thread's work (the rest is the wire,
    the PS and the other threads)."""
    lookup_fn, dense_step, emb_put = trainer.decomposed_fns()
    marks = [(time.perf_counter(), time.thread_time())]

    def mark():
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), time.thread_time()))

    state, dev_ids, _ = trainer._prepare(state, batch)
    mark()
    pooled, _ = lookup_fn(state.emb, dev_ids)
    mark()
    dense, opt, dq, agrads, m = dense_step(state.dense, state.opt,
                                           state.dense_queue, pooled, batch,
                                           state.step)
    mark()
    emb, queues, _ = emb_put(state.emb, state.emb_queue, dev_ids, agrads)
    mark()
    for k, (a, ta), (b, tb) in zip(("prepare", "lookup", "dense", "put"),
                                   marks, marks[1:]):
        times.setdefault(f"{k}_ms", []).append((b - a) * 1e3)
        times.setdefault(f"{k}_thread_ms", []).append((tb - ta) * 1e3)
    return state.replace(dense=dense, opt=opt, emb=emb, emb_queue=queues,
                         dense_queue=dq, step=state.step + 1), m


def timed_run(dev, tr, batches, members=None) -> dict:
    """Warm-up, then ``timed`` steps to a synchronize (the trainer's
    launches counted: one bag and 32 sum-only a step; with ``members``,
    the PS processes' apply-only launches from their ``metrics``), then
    ``staged`` steps with each stage's wall and thread ms, ``syncs`` steps
    under the sync debug mode and ``profiled`` steps under the profiler
    (device ms a step, busy share). Frames, wire bytes and the PS-side
    seconds a step over the timed steps."""
    st = REMOTE_STEPS
    w, t = st["warmup"], st["timed"]
    s = tr.init(seed=SEED, batch_example=batches[0])
    for b in batches[:w]:
        s, _ = tr.step(s, b)
    torch.cuda.synchronize()
    remote = any(b.remote for b in tr.backends.values())
    if remote:
        for name, b in tr.backends.items():
            b.sync(s.emb[name])       # the warm-up's puts acked and applied
    c0 = wire_counters(tr) if remote else None
    p0 = ps_seconds(tr) if remote else None
    k0 = ps_launches(members) if members else None
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    losses = []
    for b in batches[w:w + t]:
        s, m = tr.step(s, b)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    out = {"step_ms": wall * 1e3 / t, "steps_per_s": t / wall,
           "losses": [float(x) for x in losses],
           "launches_per_step": {k: v / t for k, v in launches.items()}}
    check(all(np.isfinite(out["losses"])), f"timed run: {out['losses']}")
    if remote:
        for name, b in tr.backends.items():
            b.sync(s.emb[name])
        c1, p1 = wire_counters(tr), ps_seconds(tr)
        out["frames_per_step"] = (c1["frames"] - c0["frames"]) / t
        out["wire_mb_per_step"] = (c1["bytes"] - c0["bytes"]) / t / 1e6
        out["ps_ms_per_step"] = {k: (p1[k] - p0[k]) * 1e3 / t for k in p1}
        check(launches["unique_bag"] == t and launches["fused_backward"]
              == N_TABLES * t, f"remote timed run: trainer launches "
              f"{launches}")
    if members:
        k1 = ps_launches(members)
        apply = (k1.get("fused_backward", 0) - k0.get("fused_backward", 0))
        out["ps_apply_launches_per_step"] = apply / t
        k = len({m.endpoint for m in members})
        check(apply == N_TABLES * k * t,
              f"remote timed run: {apply} apply-only launches in the PS "
              f"processes, want {N_TABLES * k * t}")
    times = {}
    i = w + t
    for b in batches[i:i + st["staged"]]:
        s, _ = thread_staged(tr, s, b, times)
    out["stages_ms"] = {k: float(np.median(v)) for k, v in times.items()}
    i += st["staged"]
    counted = batches[i:i + st["syncs"]]

    def sync_steps():
        nonlocal s
        for b in counted:
            s, _ = tr.step(s, b)
        torch.cuda.synchronize()
    out["syncs_per_step"] = count_syncs(sync_steps) / len(counted)
    i += st["syncs"]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[i:i + st["profiled"]]:
            s, _ = tr.step(s, b)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    dev_ms = device_us(prof) / 1e3
    out["device_ms_per_step"] = dev_ms / st["profiled"]
    out["device_busy_share"] = dev_ms / (pwall * 1e3)
    return out


def remote_timed_runs(dev, ds, sharded, members) -> dict:
    """(b) of the phase: dense and host_lru at k=1 and k=4 over the PS
    processes ``members`` on the card; k=1 beside the in-process trainer
    from the same batches, k=4 beside the router's k=4 readings of
    ``sharded_phase`` in the same call (dense at 65,536 rows, host_lru at
    62,500)."""
    st = REMOTE_STEPS
    n = st["warmup"] + st["timed"] + st["staged"] + st["syncs"] \
        + st["profiled"]
    it = ds.sampler(TRAIN_B, seed=REMOTE_TIMED_SEED)
    batches = [next(it) for _ in range(n)]
    rec = {"dense_k4_router": sharded["dense_65536"][REMOTE_K]["step_ms"],
           "host_lru_k4_router": {
               "step_ms": sharded["host_lru_62500"][REMOTE_K]["step_ms"],
               "stages_ms": sharded["host_lru_62500"][REMOTE_K][
                   "breakdown_ms"]}}
    for backend in ("dense", HOST_LRU):
        for k in (1, REMOTE_K):
            key = f"{backend}_k{k}"
            if k == 1:
                tr = kwai_train_trainer(dev, TrainMode.hybrid(TAU), backend)
                rec[f"{key}_in_process"] = timed_run(dev, tr, batches)
                del tr
                torch.cuda.empty_cache()
            tr = remote_trainer(dev, [m.endpoint for m in members[:k]],
                                backend)
            try:
                rec[key] = timed_run(dev, tr, batches, members[:k])
            finally:
                close_remote(tr)
            torch.cuda.empty_cache()
    return rec


def remote_online(dev, ds, members) -> dict:
    """(c) of the phase: ``run_online(n_ps=2)``'s loop (kwai-dlrm on
    host_lru, hybrid(2)) with its tables in the first 2 PS processes of
    ``members``: exact steps, every impression fed back, staleness <=
    tau; trainer steps/s and serving p50/p99/QPS under training."""
    tr = kwai_train_trainer(dev, TrainMode.hybrid(ONLINE["tau"]), HOST_LRU)
    try:
        connect_remote_backends(tr, [m.endpoint for m in members[:2]])
        res, _ = online._online_loop(
            tr, ds, steps=REMOTE_ONLINE["steps"], batch=TRAIN_B,
            config=ServingConfig(max_batch=ONLINE["max_batch"]),
            n_clients=ONLINE["clients"],
            requests_per_client=REMOTE_ONLINE["requests"], seed=SEED)
    finally:
        close_remote(tr)
    sv = res["serving"]
    served = ONLINE["clients"] * REMOTE_ONLINE["requests"]
    check(res["steps"] == REMOTE_ONLINE["steps"] and res["served"] == served
          and res["feedback"]["put"] == served
          and sv["serving/errors"] == 0.0
          and all(v <= ONLINE["tau"] for key, v in sv.items()
                  if key.endswith("/stale_steps")),
          f"remote online loop: {res}")
    return {"steps_per_s": res["steps_per_s"], "p50_ms": sv["serving/p50_ms"],
            "p99_ms": sv["serving/p99_ms"], "qps": sv["serving/qps"],
            "served": res["served"],
            "feedback_batches": res["feedback_batches"]}


def remote_checks(dev) -> tuple[dict, dict]:
    """The multi-process embedding PS's parts that read no rate but
    ``recovery_s``: (a) the bit checks over PS threads and (d) the kill
    drill. Returns the main paths' counts (the runs over PS threads, whose
    apply-only launches count in this process) and their records, with
    the seconds of each part."""
    ds = CTR_BENCHMARKS["kwai_video"]
    t0 = time.perf_counter()
    rec = {"part_s": {}}
    paths, rec["bit_checks"] = remote_same_runs(dev, ds)
    rec["part_s"]["bit_checks"] = time.perf_counter() - t0
    # (d) the kill drill: 3 PS processes, shard 1 SIGKILLed before step
    # kill_at, its spooled rows resharded onto the survivors
    st = REMOTE_STEPS
    tr = kwai_train_trainer(dev, TrainMode.hybrid(TAU), "dense")
    t0 = time.perf_counter()
    drill = ps_cluster.run_cluster(
        steps=st["kill"], n_ps=3, kill_shard=1, kill_at=st["kill_at"],
        batch=TRAIN_B, workdir=str(ROOT / "build" / "remote_drill"),
        heartbeats=False, device=str(dev), trainer=tr, ds=ds)
    drill["wall_s"] = rec["part_s"]["kill_drill"] = \
        time.perf_counter() - t0
    shutil.rmtree(drill["workdir"], ignore_errors=True)
    resh = [e for e in drill["events"] if e["kind"] == "reshard"]
    check(drill["members"] == 2 and resh and resh[0]["dead"] == [1]
          and all(v == 0 for v in drill["lost_rows"].values())
          and np.isfinite(drill["loss"]),
          f"remote kill drill: {drill}")
    rec["kill_drill"] = {k: drill[k] for k in ("steps", "steps_per_s",
                                               "loss", "members",
                                               "recovery_s", "wall_s",
                                               "step_s")}
    rec["kill_drill"]["lost_rows"] = sum(drill["lost_rows"].values())
    # the steps before the kill: k=3 with every put spooled
    rec["kill_drill"]["spooled_step_ms"] = float(np.median(
        drill["step_s"][1:st["kill_at"]])) * 1e3
    del tr
    torch.cuda.empty_cache()
    return paths, rec


def remote_phase(dev, sharded, checks: dict):
    """The multi-process embedding PS at kwai-dlrm's full width (32 tables
    x D=128, batch 512, hybrid(3)): ``remote_checks``' record ``checks``,
    then the timed runs and the online loop over PS processes;
    ``sharded`` is ``sharded_phase``'s record, whose router k=4 readings
    stand beside the remote k=4 ones. Returns the record, with the
    seconds of each part."""
    ds = CTR_BENCHMARKS["kwai_video"]
    t_phase = time.perf_counter()
    rec = {"phase": "remote", "model": KWAI.name, "batch": TRAIN_B,
           "mode": f"hybrid({TAU})", "k": REMOTE_K, **checks,
           "part_s": dict(checks["part_s"])}
    # (b) and (c) over 4 PS processes spawned once; no spool: a spool
    # writes the table's whole state to disk per put (the kill drill of
    # remote_checks runs with it and reads its cost)
    t0 = time.perf_counter()
    work = ROOT / "build" / "remote_ps"
    members = ps_cluster.spawn_cluster(str(work), REMOTE_K, spool_every=0,
                                       device=str(dev))
    rec["part_s"]["spawn"] = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        rec["timed"] = remote_timed_runs(dev, ds, sharded, members)
        rec["part_s"]["timed"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec["online"] = remote_online(dev, ds, members)
        rec["part_s"]["online"] = time.perf_counter() - t0
    finally:
        ps_cluster.stop_ps(members)
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    emit(rec)
    return rec


# ---------------------------------------------------------------------------
# the mesh paths (mesh_phase): SPMD worlds of worker processes on the card
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def count_collectives(names=MESH_COLLECTIVES):
    """Counts the ``torch.distributed`` collectives the mesh paths call
    (by name) while it is open."""
    import torch.distributed as dist
    calls = dict.fromkeys(names, 0)

    def counted(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call
    with contextlib.ExitStack() as stack:
        for name in names:
            stack.enter_context(mock.patch.object(
                dist, name, counted(name, getattr(dist, name))))
        yield calls


def probe_collectives(mesh, dev) -> dict:
    """Each collective the mesh paths use, once on CUDA tensors over the
    mesh's group of every rank: True when it ran and gave the right
    values, else the error it raised. Wrong values fail the run."""
    import torch.distributed as dist
    g, n, r = mesh.get_group(mesh.axis_names), mesh.n_ranks, mesh.rank
    got = {}

    def probe(name, fn):
        try:
            ok = fn()
        except RuntimeError as e:        # the backend does not carry it
            got[name] = f"{type(e).__name__}: {e}"[:300]
            return
        check(ok, f"mesh: {name} over {dist.get_backend()} gave wrong "
              "values")
        got[name] = True

    def reduce(op, want):
        x = torch.tensor([r + 1.0, -r], device=dev)
        dist.all_reduce(x, op=op, group=g)
        return torch.equal(x.cpu(), torch.tensor(want))

    def gather():
        out = torch.empty(2 * n, device=dev, dtype=torch.int32)
        dist.all_gather_into_tensor(
            out, torch.tensor([r, 10 * r], device=dev, dtype=torch.int32),
            group=g)
        return out.tolist() == [v for i in range(n) for v in (i, 10 * i)]

    def a2a():
        out = torch.empty(n, device=dev)
        dist.all_to_all_single(out, torch.arange(n, device=dev) + 10.0 * r,
                               group=g)
        return out.tolist() == [10.0 * i + r for i in range(n)]

    probe("all_reduce_sum", lambda: reduce(
        dist.ReduceOp.SUM, [n * (n + 1) / 2, -n * (n - 1) / 2]))
    probe("all_reduce_max", lambda: reduce(dist.ReduceOp.MAX, [float(n),
                                                               0.0]))
    def scatter():
        out = torch.empty(2, device=dev)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            dist.reduce_scatter_tensor(
                out, torch.arange(2.0 * n, device=dev) + r, group=g)
        return out.tolist() == [n * (2 * r + i) + n * (n - 1) / 2
                                for i in range(2)]

    probe("all_gather_into_tensor", gather)
    probe("all_to_all_single", a2a)
    # the LM's ZeRO-3 gradients (utils.reduce_scatter)
    probe("reduce_scatter_tensor", scatter)
    torch.cuda.synchronize()
    return got


def mesh_batch_block(mesh, batch) -> dict:
    """A global batch's block of this rank (rows over the batch axes)."""
    return {k: SP.local_block(mesh, SP.P(SP.BATCH), torch.from_numpy(
        np.ascontiguousarray(v))).numpy() for k, v in batch.items()}


def first_pooled(trainer, state, batch) -> dict:
    """The training path's pooled lookups of ``batch`` (prepare, then the
    stage's one bag launch), changing no state."""
    st, dev_ids, _ = trainer._prepare(state, batch)
    pooled, _ = trainer.decomposed_fns()[0](st.emb, dev_ids)
    return pooled


def shared_rows(spec) -> torch.Tensor:
    """(padded rows,) bool: the physical rows that two or more logical ids
    share under the uniform shuffle (at 62,500 rows about a quarter)."""
    rows = spec.padded_rows(1)
    pos = PS.shuffle_pos(torch.arange(spec.rows), rows)
    return torch.bincount(pos, minlength=rows) > 1


def table_agreement(mesh, trainer, got: dict, want: dict, shared) -> dict:
    """A mesh state's table blocks (``got``) against the rank's blocks of
    one process's (``want``): on the rows no two ids share, the tables
    within rtol 1e-4 / atol 1e-6 and the accumulators within rtol 1e-3 /
    atol 1e-12 (``card_vs_cpu``'s classes); on the shared rows the
    largest differences, recorded. There the mesh put sums the ids'
    gradients before the accumulator sees them (the JAX mesh path's
    second dedup, on physical rows) and one process adds each id's
    increment to the accumulator first (the JAX one-device path): two
    definitions, not rounding."""
    out = {"table": 0.0, "acc": 0.0, "table_shared": 0.0, "acc_shared": 0.0,
           "off": []}
    for n in trainer.collection.names:
        spec = trainer.collection[n]
        specs = SP.emb_state_specs(want[n], spec)
        mask = SP.local_block(mesh, specs["acc"], shared).to(
            got[n]["acc"].device)
        for k, rtol, atol in (("table", 1e-4, 1e-6), ("acc", 1e-3, 1e-12)):
            x, y = got[n][k], SP.local_block(mesh, specs[k], want[n][k])
            d = (x - y).abs().reshape(mask.shape[0], -1).amax(1)
            for key, rows in ((k, d[~mask]), (f"{k}_shared", d[mask])):
                if rows.numel():
                    out[key] = max(out[key], float(rows.max()))
            close = torch.isclose(x, y, rtol=rtol, atol=atol).reshape(
                mask.shape[0], -1).all(1)
            if not bool(close[~mask].all()):
                out["off"].append(f"{n}.{k}")
    return out


def mesh_train_rank(dev, mesh) -> dict:
    """kwai-dlrm at full width under the mesh, per mode of MESH_TRAIN: the
    main path's run from ``init`` (launches, collectives and ms a step
    counted), then each step held against the port's single-process
    trainer on the card, stage by stage from a common state as
    ``router_card_vs_cpu`` holds the router: before each step the mesh
    state becomes this rank's blocks of one process's state (its queues
    cut over the batch axes: the ranks' popped halves, gathered, are its
    put), both take the step, and the pooled lookups must be equal bit
    for bit, the loss within rtol 1e-4, the dense parameters in
    ``dense_agreement``'s class and the tables and accumulators in
    ``table_agreement``'s. Whole trajectories part after the run's loss
    spikes (rounding through Adam's sign steps, and the shared rows'
    second definition), so the main run's distances are recorded, not
    held. The first pooled lookups of the main run bit for bit."""
    ds = CTR_BENCHMARKS["kwai_video"]
    out = {}
    for tag, mode, steps in MESH_TRAIN:
        it = ds.sampler(TRAIN_B, seed=MESH_SEED)
        batches = [next(it) for _ in range(steps)]
        blocks = [mesh_batch_block(mesh, b) for b in batches]
        tr = kwai_train_trainer(dev, mode)
        with set_mesh(mesh):
            st = tr.init(seed=MESH_SEED, batch_example=blocks[0])
            start0 = tree_map(torch.clone, st.dense)
            first = first_pooled(tr, st, blocks[0])
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            losses, ms = [], []
            with count_collectives() as calls:
                for b in blocks:
                    t0 = time.perf_counter()
                    st, m = tr.step(st, b)
                    losses.append(float(m["loss"]))
                    ms.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            launches, served = ops.launch_counts(), ops.table_counts()
        shared = shared_rows(tr.collection[tr.collection.names[0]])
        check(all(tr.collection[n].rows == tr.collection[
            tr.collection.names[0]].rows for n in tr.collection.names),
            "mesh: kwai-dlrm's tables differ in rows")
        rt = kwai_train_trainer(dev, mode)
        ref = rt.init(seed=MESH_SEED, batch_example=batches[0])
        ref_first = first_pooled(rt, ref, batches[0])
        bad = [n for n in first if not torch.equal(
            first[n], SP.local_block(mesh, SP.P(SP.BATCH), ref_first[n]))]
        del first, ref_first
        per_step, ref_losses = [], []
        for i, (b, blk) in enumerate(zip(batches, blocks)):
            with set_mesh(mesh):
                ms_ = tr.local_state(ref.to(dev))
                pooled = first_pooled(tr, ms_, blk)
                ms_, m = tr.step(ms_, blk)
            start = tree_map(torch.clone, ref.dense)
            ref_pooled = first_pooled(rt, ref, b)
            ref, mr = rt.step(ref, b)
            ref_losses.append(float(mr["loss"]))
            one = {"loss": float(m["loss"]), "loss_one_process":
                   float(mr["loss"]), "pooled_bit_exact": all(
                       torch.equal(pooled[n], SP.local_block(
                           mesh, SP.P(SP.BATCH), ref_pooled[n]))
                       for n in pooled),
                   **table_agreement(mesh, tr, ms_.emb, ref.emb, shared),
                   **dense_agreement(start, ms_.dense, ref.dense, 1)}
            one["ok"] = (one["ok"] and one["pooled_bit_exact"]
                         and not one["off"] and bool(np.isclose(
                             one["loss"], one["loss_one_process"],
                             rtol=1e-4)))
            per_step.append(one)
            del ms_, pooled, ref_pooled, start
        whole = table_agreement(mesh, tr, st.emb, ref.emb, shared)
        out[tag] = {
            "steps": steps, "losses": losses, "losses_one_process":
            ref_losses, "first_lookup_bit_exact": not bad,
            "first_lookup_off": bad[:4], "per_step": per_step,
            "steps_ok": all(p["ok"] for p in per_step),
            "whole_run": {"table_max_abs": whole["table"],
                          "table_shared_max_abs": whole["table_shared"],
                          "acc_max_abs": whole["acc"],
                          **dense_agreement(start0, st.dense, ref.dense,
                                            steps)},
            "shared_row_share": float(shared.float().mean()),
            "launches": launches, "tables": served,
            "collectives_per_step": {k: v / steps for k, v in calls.items()},
            "step_ms": ms}
        del tr, st, rt, ref, start0
        gc.collect()
        torch.cuda.empty_cache()
    return out


def mesh_tier_trainer(dev, backend, extra: dict):
    """kwai-dlrm's hybrid(TAU) trainer on ``backend``, its tables' specs
    given the fields ``extra``."""
    tr = kwai_train_trainer(dev, TrainMode.hybrid(TAU), backend)
    if not extra:
        return tr
    ad = dataclasses.replace(tr.adapter, collection=tr.adapter.collection
                             .map_specs(lambda _, sp: dataclasses.replace(
                                 sp, **extra)))
    return PersiaTrainer(ad, tr.mode, OptConfig(kind="adam", lr=DENSE_LR),
                         device=dev)


def lru_tiers_of(trainer) -> dict:
    """{table: its HostLRUBackend} of a trainer's host_lru tables (a
    router's host_lru shards under ``table/s<k>``)."""
    out = {}
    for key, sub, _ in storage_parts(trainer):
        if isinstance(sub, BK.HostLRUBackend):
            out[key] = sub
    return out


def storage_parts(trainer) -> list:
    """[(key, storage backend, path)] of a trainer's tables: each table's
    backend under its name, a router's shard backends under
    ``table/s<k>`` (path: the keys to its state and queue)."""
    out = []
    for n, b in trainer.backends.items():
        b = BK.unwrap(b)
        if isinstance(b, BK.ShardedBackend):
            out += [(f"{n}/s{k}", sub, (n, f"s{k}"))
                    for k, sub in enumerate(b.shard_backends)]
        else:
            out.append((n, b, (n,)))
    return out


def at(tree: dict, path: tuple):
    """``tree[path[0]][path[1]]...``."""
    for k in path:
        tree = tree[k]
    return tree


def lru_table_counters(trainer) -> dict:
    """{table: [faults, writebacks, hits, admits, bypasses, promotes]} of
    a trainer's host_lru tables."""
    return {n: [b.faults, b.writebacks, b.hits, b.admits, b.bypasses,
                b.promotes] for n, b in lru_tiers_of(trainer).items()}


def lru_maps_equal(a, b) -> bool:
    """The slot maps and LRU clocks of two trainers' host_lru tables
    equal."""
    x, y = lru_tiers_of(a), lru_tiers_of(b)
    return set(x) == set(y) and all(
        np.array_equal(x[n]._id_for_slot, y[n]._id_for_slot)
        and np.array_equal(x[n]._slot_clock, y[n]._slot_clock) for n in x)


def lru_stores_equal(a, b) -> bool:
    """The host stores (vectors, accumulators) of two trainers' host_lru
    tables bit for bit."""
    x, y = lru_tiers_of(a), lru_tiers_of(b)
    return set(x) == set(y) and all(
        np.array_equal(x[n].store.vectors, y[n].store.vectors)
        and np.array_equal(x[n].store.opt_acc, y[n].store.opt_acc)
        for n in x)


def states_equal(a, b) -> bool:
    """Two TrainStates bit for bit (tensors on either device, host ints)."""
    def eq(x, y):
        if isinstance(x, torch.Tensor):
            return isinstance(y, torch.Tensor) and x.dtype == y.dtype \
                and x.shape == y.shape and torch.equal(x, y.to(x.device))
        if isinstance(x, dict):
            return isinstance(y, dict) and set(x) == set(y) and all(
                eq(x[k], y[k]) for k in x)
        if isinstance(x, (list, tuple)):
            return len(x) == len(y) and all(eq(u, v) for u, v in zip(x, y))
        return x == y
    return all(eq(getattr(a, f), getattr(b, f)) for f in (
        "dense", "opt", "emb", "emb_queue", "dense_queue", "step"))


def tier_agreement(mesh, trainer, got: dict, want: dict, start: dict,
                   lossy: bool) -> dict:
    """A mesh state's table blocks (``got``: a host_lru table's device
    cache, a dense table's rows) against the rank's blocks of one
    process's (``want``, from ``start`` one step before). A cache (a slot
    holds one id; its slot ids equal) and a dense table's rows no two ids
    share in ``table_agreement``'s classes; behind the wire (``lossy``) at
    most 1% of the elements outside them and the distance within 1e-3 of
    the step's update (``card_vs_cpu``'s lossy class: a payload value on
    an fp16 rounding boundary rounds one way or the other)."""
    out = {"table": 0.0, "acc": 0.0, "update_rel": 0.0, "off_elements": 0,
           "off": []}
    for n, sub, path in storage_parts(trainer):
        spec = sub.spec
        g, w, w0 = at(got, path), at(want, path), at(start, path)
        specs = SP.emb_state_specs(w, spec)
        mask = None
        if "slot_ids" in w:
            if not torch.equal(g["slot_ids"], SP.local_block(
                    mesh, specs["slot_ids"], w["slot_ids"])):
                out["off"].append(f"{n}.slot_ids")
        else:
            mask = ~SP.local_block(mesh, specs["acc"], shared_rows(
                spec)).to(g["acc"].device)
        for k, rtol, atol in (("table", 1e-4, 1e-6), ("acc", 1e-3, 1e-12)):
            x = g[k]
            y = SP.local_block(mesh, specs[k], w[k])
            y0 = SP.local_block(mesh, specs[k], w0[k])
            if mask is not None:
                x, y, y0 = x[mask], y[mask], y0[mask]
            out[k] = max(out[k], float((x - y).abs().max()))
            off = ~torch.isclose(x, y, rtol=rtol, atol=atol)
            ok = not bool(off.any())
            if lossy:
                rel = float((x - y).double().norm()
                            / (y - y0).double().norm().clamp(min=1e-300))
                out["update_rel"] = max(out["update_rel"], rel)
                out["off_elements"] += int(off.sum())
                ok = rel <= 1e-3 and float(off.float().mean()) <= 0.01
            if not ok:
                out["off"].append(f"{n}.{k}")
    return out


def queue_agreement(mesh, trainer, got: dict, want: dict,
                    lossy: bool) -> dict:
    """The put a step pushed (each queue's slot before ``ptr``): the mesh
    ranks' shares gathered over the batch axes and added up by logical id
    (a rank pushes its own unique put; behind the wire, its share of the
    global one) against one process's, by id: within rtol 1e-4 / atol
    1e-4 of the largest (the ranks' sums add in another order, and a sum
    that nearly cancels keeps the rounding of its terms; ``card_vs_cpu``
    holds payloads to 1e-3 of the largest); behind the wire at most 1% of
    the elements outside that, each within 2^-10 of the largest (an fp16
    step). A host_lru put's slots equal one process's, by id. The largest
    distance over the largest element is recorded."""
    from repro_torch.utils import all_gather, batch_axes
    out = {"queue_max_abs": 0.0, "queue_rel": 0.0, "queue_off": []}
    for n, sub, path in storage_parts(trainer):
        if want[path[0]] is None:
            continue
        gq, wq = at(got, path), at(want, path)
        rows, dim = sub.spec.rows, int(wq["grads"].shape[-1])
        p = (int(wq["ptr"]) - 1) % int(wq["ids"].shape[0])

        def by_id(q, gather):
            cat = (lambda x: all_gather(x.contiguous(), batch_axes())) \
                if gather else (lambda x: x)
            ids, g = cat(q["ids"][p]).long(), cat(q["grads"][p]).float()
            ok = ids >= 0
            sums = torch.zeros((rows, dim), device=g.device).index_add_(
                0, ids[ok], g[ok])
            slot = None
            if "slots" in q:
                slot = torch.full((rows,), -1, dtype=torch.int32,
                                  device=g.device)
                slot[ids[ok]] = cat(q["slots"][p])[ok]
            return sums, slot
        (x, xs), (y, ys) = by_id(gq, True), by_id(wq, False)
        top = float(y.abs().max())
        d = (x - y).abs()
        out["queue_max_abs"] = max(out["queue_max_abs"], float(d.max()))
        out["queue_rel"] = max(out["queue_rel"],
                               float(d.max()) / max(top, 1e-30))
        off = ~torch.isclose(x, y, rtol=1e-4, atol=1e-4 * top)
        ok = not bool(off.any())
        if lossy:
            ok = float(off.float().mean()) <= 0.01 \
                and float(d.max()) <= 2.0 ** -10 * top
        if ys is not None:
            ok = ok and torch.equal(xs, ys)
        if not ok or (gq["ptr"], gq["filled"]) != (wq["ptr"], wq["filled"]):
            out["queue_off"].append(n)
    return out


def mesh_tier_checkpoint(dev, mesh, work, tr, st, blocks, backend,
                         extra, keep=None) -> dict:
    """The tier's state saved under the mesh (``PersiaTrainer.save``: the
    blocks joined, rank 0 writes) and restored by one process on rank 0:
    equal bit for bit to the joined mesh state, host tiers and counters
    too; then restored under the mesh by a fresh trainer and run
    ``blocks`` (each rank's): equal bit for bit to the uninterrupted run
    (states, counters, slot maps, stores). With ``keep`` (a dict) the
    resumed run is mesh_online's trajectory (a service beside it,
    :func:`mesh_online_trajectory`) and the uninterrupted run its serial
    run, which reads every block a flush read at the flush's step:
    ``keep`` takes the trajectory's record with the serial run's holds,
    their seconds, and the resumed trainer and state (``keep["pair"]``)
    for ``mesh_online_rank``."""
    ck = str(Path(work) / "tier_ckpt")
    with set_mesh(mesh):
        t0 = time.perf_counter()
        tr.save(ck, st)
        save_s = time.perf_counter() - t0
        saved = tr.global_state(st)
    rec = {"save_s": save_s, "bytes": sum(
        f.stat().st_size for f in Path(ck).rglob("*") if f.is_file())}
    if mesh.rank == 0:
        ot = mesh_tier_trainer(dev, backend, extra)
        t0 = time.perf_counter()
        os_ = ot.restore(ck)
        rec["one_process_restore_s"] = time.perf_counter() - t0
        rec["one_process_bit_exact"] = bool(
            states_equal(os_, saved) and lru_maps_equal(ot, tr)
            and lru_stores_equal(ot, tr)
            and lru_table_counters(ot) == lru_table_counters(tr))
        del ot, os_
    del saved
    with set_mesh(mesh):
        t2 = mesh_tier_trainer(dev, backend, extra)
        t0 = time.perf_counter()
        s2 = t2.restore(ck)
        rec["restore_s"] = time.perf_counter() - t0
        flushes = []
        if keep is None:
            for b in blocks:
                s2, _ = t2.step(s2, b)
        else:
            s2, traj, flushes = mesh_online_trajectory(mesh, t2, s2,
                                                       blocks, keep)
        # the uninterrupted run; with ``keep`` the trajectory's serial run
        t0, c0 = time.perf_counter(), time.process_time()
        cont, off, reads, losses, dist_max = st, [], 0, [], 0.0
        for t in range(len(blocks) + 1):
            for i, (at_step, block, pooled) in enumerate(flushes):
                if at_step != t:
                    continue
                got, _ = tr.serve_lookup(cont, block)
                reads += 1
                dist_max = max([dist_max] + [
                    float((got[n] - pooled[n]).abs().max()) for n in pooled])
                if not all(torch.equal(got[n], pooled[n]) for n in pooled):
                    off.append(i)
            if t < len(blocks):
                cont, m = tr.step(cont, blocks[t])
                losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        serial_s = time.perf_counter() - t0, time.process_time() - c0
        g1 = tr.global_state(cont)
        g2 = t2.global_state(s2)
    holds = {"state_bit_exact": bool(states_equal(g1, g2)),
             "counters_equal": lru_table_counters(t2)
             == lru_table_counters(tr),
             "slot_maps_equal": lru_maps_equal(t2, tr),
             "stores_equal": lru_stores_equal(t2, tr)}
    rec["resume_steps"] = len(blocks)
    rec["resume_bit_exact"] = all(holds.values())
    del g1, g2
    if keep is not None:
        traj.update(holds, reads=reads, off=off[:8],
                    pooled_max_abs=dist_max,
                    losses_equal=losses == traj["losses"])
        keep.update(trajectory=traj, pair=(t2, s2), serial_s=serial_s[0],
                    serial_cpu_s=serial_s[1])
    return rec


def mesh_tier_rank(dev, mesh, work, tiers=None, keep=None) -> dict:
    """kwai-dlrm at full width on each tier of ``tiers`` under the mesh:
    one process trains alone on the card until its queued puts apply and
    every host_lru table has written back a row a put moved (the store's
    accumulator leaves 0), the mesh takes its state
    (this rank's blocks; the host tiers, every rank's, from its checkpoint
    blobs), then each of MESH_TIER["steps"] steps is held against one
    process from a common state, as ``mesh_train_rank`` holds dense
    tables: the pooled lookups bit for bit, the loss within rtol 1e-4, the
    tables in ``tier_agreement``'s class, every LRU counter, slot map and
    clock equal to one process's (the mesh prepares the global batch's ids
    on every rank), the put it pushed in ``queue_agreement``'s class, the
    host stores bit for bit after the run (a sharded cache gathers its
    evicted rows exactly), and rows that an applied put moved among those
    written back in the held steps. Only the mesh's steps are counted
    (launches, tables, ms). The checkpointed tier is then saved
    and resumed (:func:`mesh_tier_checkpoint`); the held state of the
    tiers of MESH_EMB["serve"] is read by the serve path
    (:func:`mesh_serve_read`), and MESH_EMB["pipe"]'s is run by the
    pipelined trainer (:func:`mesh_pipeline`); ``keep`` takes the
    checkpointed tier's two trainers (:func:`mesh_tier_checkpoint`)."""
    ds = CTR_BENCHMARKS["kwai_video"]
    n_b = MESH_TIER["warm_cap"] + MESH_TIER["steps"] + max(
        MESH_TIER["resume"], MESH_EMB["pipe_steps"] + 1)
    it = ds.sampler(TRAIN_B, seed=MESH_SEED + 1)
    batches = [next(it) for _ in range(n_b)]
    out = {}
    for tag, backend, extra in MESH_TIERS if tiers is None else tiers:
        lossy = backend.endswith("+compressed")
        rt = mesh_tier_trainer(dev, backend, extra)
        ref = rt.init(seed=MESH_SEED, batch_example=batches[0])
        lru = lru_tiers_of(rt)
        warm, t0 = 0, time.perf_counter()
        # a store row's accumulator leaves 0 when the row is written back
        # with an applied put: warm on until every table's store holds one
        while warm < TAU + 1 or (warm < MESH_TIER["warm_cap"] and not all(
                b.store.opt_acc.any() for b in lru.values())):
            ref, _ = rt.step(ref, batches[warm])
            warm += 1
        rec = {"warm_steps": warm, "warm_s": time.perf_counter() - t0,
               "wrote_back_updated": all(b.store.opt_acc.any()
                                         for b in lru.values())}
        tr = mesh_tier_trainer(dev, backend, extra)
        with set_mesh(mesh):
            st = tr.init(seed=MESH_SEED,
                         batch_example=mesh_batch_block(mesh, batches[0]))
            for n, b, path in storage_parts(tr):
                if n in lru:
                    b.restore_from_checkpoint(
                        lru[n].state_for_checkpoint(at(ref.emb, path)))
        launches = dict.fromkeys(ops.launch_counts(), 0)
        served = dict.fromkeys(ops.table_counts(), 0)
        per_step, ms = [], []
        # the stores' accumulators before the held steps: a row whose
        # accumulator moves was written back with an applied put
        accs = {n: b.store.opt_acc.copy() for n, b in lru.items()}
        for i in range(MESH_TIER["steps"]):
            b = batches[warm + i]
            blk = mesh_batch_block(mesh, b)
            snap = ref.to(dev)
            with set_mesh(mesh):
                st = tr.local_state(snap)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, ids, _ = tr._prepare(st, blk)
                prep = time.perf_counter() - t0
                # the lookup held against one process's (not counted)
                pooled = tr.decomposed_fns()[0](st.emb, ids)[0]
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                st, m = tr.train_step(st, blk, ids)
                torch.cuda.synchronize()
                ms.append((prep + time.perf_counter() - t0) * 1e3)
                for k, v in ops.launch_counts().items():
                    launches[k] += v
                for k, v in ops.table_counts().items():
                    served[k] += v
            ref, rids, _ = rt._prepare(ref, b)
            rpooled = rt.decomposed_fns()[0](ref.emb, rids)[0]
            ref, mr = rt.train_step(ref, b, rids)
            with set_mesh(mesh):
                one = {"loss": float(m["loss"]),
                       "loss_one_process": float(mr["loss"]),
                       "pooled_bit_exact": all(torch.equal(
                           pooled[n], SP.local_block(mesh, SP.P(SP.BATCH),
                                                     rpooled[n]))
                           for n in pooled),
                       "counters_equal": lru_table_counters(tr)
                       == lru_table_counters(rt),
                       "slot_maps_equal": lru_maps_equal(tr, rt),
                       **tier_agreement(mesh, tr, st.emb, ref.emb, snap.emb,
                                        lossy),
                       **queue_agreement(mesh, tr, st.emb_queue,
                                         ref.emb_queue, lossy)}
            one["ok"] = bool(one["pooled_bit_exact"] and one["counters_equal"]
                             and one["slot_maps_equal"] and not one["off"]
                             and not one["queue_off"]
                             and np.isclose(one["loss"],
                                            one["loss_one_process"],
                                            rtol=1e-4))
            per_step.append(one)
            del snap, pooled, rpooled
        rec.update({
            "per_step": per_step, "steps_ok": all(p["ok"] for p in per_step),
            "stores_equal": lru_stores_equal(tr, rt),
            "updated_rows_written_back": sum(
                int((b.store.opt_acc != accs[n]).sum())
                for n, b in lru.items()),
            "counters": lru_table_counters(tr),
            "counters_one_process": lru_table_counters(rt),
            "slots_a_rank": {n: int(at(st.emb, path)["table"].shape[0])
                             for n, _, path in storage_parts(tr)[:1]},
            "cache_bytes_a_rank": sum(
                tr.backends[n].device_bytes(e) for n, e in st.emb.items()),
            "host_bytes_a_rank": sum(b.host_bytes()
                                     for b in lru_tiers_of(tr).values()),
            "launches": launches, "tables": served, "step_ms": ms})
        done = warm + MESH_TIER["steps"]
        if tag in MESH_EMB["serve"]:
            rec["serve_read"] = mesh_serve_read(mesh, tr, rt, ref,
                                                batches[done])
        if tag == MESH_EMB["pipe"]:
            rec["pipeline"] = mesh_pipeline(
                dev, mesh, backend, extra, rt, ref,
                batches[done:done + MESH_EMB["pipe_steps"]])
        if tag == MESH_TIER["checkpoint"]:
            rec["checkpoint"] = mesh_tier_checkpoint(
                dev, mesh, work, tr, st,
                [mesh_batch_block(mesh, b)
                 for b in batches[done:done + MESH_TIER["resume"]]],
                backend, extra, keep)
        out[tag] = rec
        del rt, ref, tr, st, lru
        gc.collect()
        torch.cuda.empty_cache()
    return out


def mesh_serve_read(mesh, tr, rt, ref, batch) -> dict:
    """The serve read (``PersiaTrainer.serve_lookup``) under the mesh of
    this rank's block of ``batch`` from one process's held state (the
    host tiers every rank's, the device cache its block), against that
    process's read of the whole batch: the pooled rows bit for bit, the
    read gauges of the rank's block, nothing of the tier moved; its
    launches (one bag launch)."""
    blk = mesh_batch_block(mesh, batch)
    with set_mesh(mesh):
        st = tr.local_state(ref)
        c0 = lru_table_counters(tr)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with count_collectives() as calls:
            pooled, info = tr.serve_lookup(st, blk)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches, served = ops.launch_counts(), ops.table_counts()
    want, _ = rt.serve_lookup(ref, batch)      # one process: no mesh
    with set_mesh(mesh):
        want = {n: SP.local_block(mesh, SP.P(SP.BATCH), w)
                for n, w in want.items()}
    off = [n for n in pooled if not torch.equal(pooled[n], want[n])]
    dist = max(float((pooled[n] - want[n]).abs().max()) for n in pooled)
    return {"bit_exact": not off, "off": off[:4], "max_abs": dist,
            "unchanged": lru_table_counters(tr) == c0
            and lru_maps_equal(tr, rt),
            "hits": sum(i["hits"] for i in info.values()),
            "misses": sum(i["misses"] for i in info.values()),
            "launches": launches, "tables": served, "ms": ms,
            "collectives": calls}


def lru_digest(trainer) -> str:
    """A digest of every host_lru table's slot map, clock, counters and
    store (vectors and accumulators): equal on every rank of a mesh whose
    ranks hold one process's host tiers."""
    import hashlib
    h = hashlib.sha256()
    for n, b in sorted(lru_tiers_of(trainer).items()):
        h.update(n.encode())
        for a in (b._id_for_slot, b._slot_clock, b.store.vectors,
                  b.store.opt_acc,
                  np.array([b.faults, b.writebacks, b.hits], np.int64)):
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def mesh_pipeline(dev, mesh, backend, extra, rt, ref, batches) -> dict:
    """The pipelined trainer with host_lru tables under the mesh, from one
    process's held state (its host tiers as checkpoint blobs, its device
    state cut into this rank's blocks): serial, ``max_inflight=1`` (bit
    for bit with serial: the states, the host tiers) and
    ``PIPE_INFLIGHT`` with a look-ahead of ``PIPE_PREFETCH`` (its puts in
    batch order; the host tiers' digest, compared over the ranks), each
    ``len(batches)`` steps; the serial run's launches."""
    blobs = {n: b.state_for_checkpoint(at(ref.emb, path))
             for n, b, path in storage_parts(rt)
             if isinstance(b, BK.HostLRUBackend)}
    blocks = [mesh_batch_block(mesh, b) for b in batches]
    runs, out = {}, {}
    for runner in ("serial", "pipelined_1", "pipelined_deep"):
        tr = mesh_tier_trainer(dev, backend, extra)
        for n, b in lru_tiers_of(tr).items():
            b.restore_from_checkpoint(blobs[n])
        eng = pipe_engine(tr, runner)
        with set_mesh(mesh):
            # a copy: the dense half is replicated, and a step updates it
            # in place
            st = tr.local_state(ref.to(dev))
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            st, ms = (tr.run(st, blocks) if eng is None
                      else eng.run(st, blocks))
            torch.cuda.synchronize()
            out[runner] = {"s": time.perf_counter() - t0,
                           "losses": [float(m["loss"]) for m in ms],
                           "launches": ops.launch_counts(),
                           "tables": ops.table_counts(),
                           "digest": lru_digest(tr)}
            if eng is not None:
                out[runner]["order"] = list(eng.applied_order)
        if runner != "pipelined_deep":
            runs[runner] = (tr, st)
        del tr, st, eng
    (ts, ss), (t1, s1) = runs["serial"], runs["pipelined_1"]
    out["inflight_1_bit_exact"] = bool(
        states_equal(ss, s1) and lru_maps_equal(ts, t1)
        and lru_stores_equal(ts, t1)
        and lru_table_counters(ts) == lru_table_counters(t1))
    out["deep_in_order"] = out["pipelined_deep"]["order"] == list(
        range(len(batches)))
    del runs, ts, ss, t1, s1
    return out


def remote_mixed_trainer(dev) -> tuple:
    """kwai-dlrm's hybrid(TAU) trainer with its even tables dense and its
    odd ones host_lru (the launchers' cache), and the names of each."""
    tr = kwai_train_trainer(dev, TrainMode.hybrid(TAU))
    names = list(tr.collection)
    cache = default_cache_rows(CTR_BENCHMARKS["kwai_video"].rows_per_field)
    lru = names[1::2]
    ad = dataclasses.replace(tr.adapter, collection=tr.adapter.collection
                             .map_specs(lambda n, sp: dataclasses.replace(
                                 sp, backend=HOST_LRU, cache_rows=cache)
                                 if n in lru else sp))
    return (PersiaTrainer(ad, tr.mode, OptConfig(kind="adam", lr=DENSE_LR),
                          device=dev), names[0::2], lru)


def put_share(plan, grads) -> tuple:
    """A rank's share of a remote table's put, by plain means: its
    occurrences' gradients summed by device id in fp64 on the host ->
    (sorted ids int32, fp32 sums)."""
    inv = plan.inv.reshape(-1).long().cpu()
    g = grads.reshape(inv.numel(), -1).cpu().double()
    ok = inv >= 0
    ids = plan.dev.long().cpu()[inv[ok]]
    g, keep = g[ok], ids >= 0
    u, pos = torch.unique(ids[keep], return_inverse=True)
    sums = torch.zeros((u.numel(), g.shape[1]), dtype=torch.float64)
    return u.int(), sums.index_add_(0, pos, g[keep]).float()


def mesh_remote_run(dev, mesh, eps: dict) -> dict:
    """kwai-dlrm on remote tables in one run: its even tables dense on one
    PS process (``eps["dense"]``), its odd ones host_lru over REMOTE_K
    (``eps["lru"]``, the remote router), MESH_EMB["remote_steps"]
    hybrid(TAU) steps from one seed on the global batches: under ``mesh``
    on this rank's blocks (the mesh's first rank holds the connections),
    or, with ``mesh`` None, in one process. Records every step's loss;
    the first step's pooled lookups (one lookup op more to the PS either
    way); the serve read of the first batch after the run; the global put
    of each step whose put the run applies (the first ``remote_steps -
    TAU``), as the PS got it (the first rank's, by table: valid ids and
    sums) and, under the mesh on the ranks that gather with the first
    one, this rank's share of it (:func:`put_share`, taken before the
    mesh put gathers it); the PS's counters (puts, faults, hits), its
    processes' kernel launches, the frames the steps sent (the first
    rank's); the trainer's launches and collectives a step."""
    from repro_torch.net import remote as net_remote
    from repro_torch.utils import batch_axes
    ds = CTR_BENCHMARKS["kwai_video"]
    it = ds.sampler(TRAIN_B, seed=MESH_SEED + 2)
    steps = MESH_EMB["remote_steps"]
    batches = [next(it) for _ in range(steps)]
    cut = (lambda b: mesh_batch_block(mesh, b)) if mesh is not None \
        else (lambda b: b)
    t_run = time.perf_counter()
    tr, dense, lru = remote_mixed_trainer(dev)
    applied = steps - TAU
    puts = [{} for _ in range(applied)]
    shares = [{} for _ in range(applied)]
    now = [None]
    keep = mesh is not None and all(
        mesh.coords(mesh.rank)[a] == mesh.coords(0)[a]
        for a in mesh.axis_names if a not in ("pod", "data"))

    def recorder(cls):
        orig = cls.put_host

        def put_host(self, state, queue, ids, sums, unique):
            if now[0] is not None and now[0] < applied:
                h = np.asarray(ids).reshape(-1)
                ok = h >= 0
                puts[now[0]][self._table] = (
                    torch.from_numpy(h[ok].astype(np.int32)),
                    torch.from_numpy(np.asarray(sums, np.float32)[ok]))
            return orig(self, state, queue, ids, sums, unique)
        return mock.patch.object(cls, "put_host", put_host)
    orig_mesh = BK._remote_puts_mesh

    def puts_mesh(items):
        if keep and now[0] is not None and now[0] < applied:
            for b, _, _, ids, g in items:
                shares[now[0]][b._table] = put_share(ids, g)
        return orig_mesh(items)
    with set_mesh(mesh), recorder(net_remote.RemoteBackend), \
            recorder(net_remote.RemoteShardedBackend), \
            mock.patch.object(BK, "_remote_puts_mesh", puts_mesh):
        connect_remote_backends(tr, eps["dense"], tables=dense)
        connect_remote_backends(tr, eps["lru"], tables=lru)
        check(all(tr.backends[n].remote for n in tr.collection),
              "mesh remote: a table is not remote")
        st = tr.init(seed=MESH_SEED + 2, batch_example=cut(batches[0]))
        losses, ms = [], []
        launches = dict.fromkeys(ops.launch_counts(), 0)
        served = dict.fromkeys(ops.table_counts(), 0)
        with count_collectives(MESH_COLLECTIVES
                               + ("broadcast_object_list",)) as calls:
            for i, b in enumerate(batches):
                blk = cut(b)
                if i == 0:
                    # the first step's pooled lookups (not counted; one
                    # lookup op more to the PS either way)
                    pooled = {n: p.cpu() for n, p in
                              first_pooled(tr, st, blk).items()}
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                now[0] = i
                t0 = time.perf_counter()
                st, m = tr.step(st, blk)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                now[0] = None
                for k, v in ops.launch_counts().items():
                    launches[k] += v
                for k, v in ops.table_counts().items():
                    served[k] += v
                losses.append(float(m["loss"]))
        subs = [sub for b in tr.backends.values()
                for sub in (getattr(b, "shard_backends", None) or [b])]
        lead = subs[0]._client is not None
        # the frames the steps sent (the serve read below sends one read
        # a rank's block under the mesh)
        frames = sum({id(s._client): s._client.frames_sent
                      for s in subs if lead}.values())
        rows, _ = tr.serve_lookup(st, cut(batches[0]))
        rec = {"losses": losses, "pooled_first": pooled,
               "rows": {n: r.cpu() for n, r in rows.items()},
               "puts": puts, "shares": shares,
               "launches": launches, "tables": served, "step_ms": ms,
               "collectives_per_step": {
                   k: v / len(batches) for k, v in calls.items()},
               "connected": lead, "dense_tables": len(dense),
               "lru_tables": len(lru)}
        if lead:
            rec["ps"] = {f"{n}/{k}": {key: v for key, v in sub
                                      .remote_metrics().items()
                                      if key in ("puts", "faults",
                                                 "hits")}
                         for n, b in tr.backends.items()
                         for k, sub in enumerate(getattr(
                             b, "shard_backends", None) or [b])}
            seen = {}
            for sub in subs:
                seen[sub.endpoint] = sub._client
            rec["ps_launches"] = [c.call("metrics")["launches"]
                                  for c in seen.values()]
            rec["frames"] = frames
        for b in tr.backends.values():
            b.close()
    rec["s"] = time.perf_counter() - t_run
    del tr, st
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def mesh_moe_rank(dev, mesh) -> dict:
    """deepseek-v2-lite-16b's MoE layer (64 experts top-6, 2 shared, d_model
    2,048, experts 1,408 wide) drawn whole from one seed on every rank,
    which keeps its 32 experts and its batch row; the psum and the a2a
    dispatch at capacity factor 8 against ``moe_forward`` with no mesh on
    the same draw, on this rank's block. Rank 0 also runs the no-mesh
    layer in fp64 (the experts' products in fp64): the fp32 run's
    distance from it is the GEMMs' own."""
    cfg = get_config(MOE_ARCH)
    gen = torch.Generator(device=dev)
    gen.manual_seed(MESH_SEED + 1)
    p = lm_moe.moe_init(gen, cfg, device=dev)
    x = torch.randn((MESH_MOE["batch"], MESH_MOE["seq"], cfg.d_model),
                    generator=gen, device=dev)
    cf = MESH_MOE["cf"]
    ref, _ = lm_moe.moe_forward(p, cfg, x, cf)
    rec = {"largest": float(ref.abs().max())}
    if mesh.rank == 0:
        p64 = tree_map(lambda t: t.double(), p)
        ref64, _ = lm_moe.moe_forward(p64, cfg, x.double(), cf)
        rec["gemm_only_max_abs"] = float((ref - ref64).abs().max())
        del p64, ref64
    specs = lm_moe._moe_param_specs(cfg)
    blk = {k: ({kk: SP.local_block(mesh, specs[k][kk], vv).clone()
                for kk, vv in v.items()} if isinstance(v, dict)
               else SP.local_block(mesh, specs[k], v).clone())
           for k, v in p.items()}
    del p
    torch.cuda.empty_cache()
    rec["expert_bytes_per_rank"] = sum(blk[k].numel() * 4
                                       for k in ("wg", "wu", "wd"))
    xb = SP.local_block(mesh, SP.P(SP.BATCH), x).contiguous()
    want = SP.local_block(mesh, SP.P(SP.BATCH), ref)
    with set_mesh(mesh):
        for disp in ("psum", "a2a"):
            lm_moe.MOE_DISPATCH = disp
            try:
                lm_moe.moe_forward(blk, cfg, xb, cf)       # warm-up
                with count_collectives() as calls:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    got, aux = lm_moe.moe_forward(blk, cfg, xb, cf)
                    torch.cuda.synchronize()
                    t = (time.perf_counter() - t0) * 1e3
            finally:
                lm_moe.MOE_DISPATCH = "psum"
            rec[disp] = {
                "max_abs": float((got - want).abs().max()),
                "plain_class": bool(torch.allclose(got, want, rtol=1e-4,
                                                   atol=1e-5)),
                "ms": t, "collectives": dict(calls),
                "aux": {k: float(v) for k, v in aux.items()}}
    del blk, x, ref
    torch.cuda.empty_cache()
    return rec


def decode_inputs(dev, kind: str) -> tuple:
    """One attention layer of granite-3-2b (``gqa``) or DeepSeek-V2-Lite
    (``mla``), its cache of MESH_DECODE's length filled by a prefill of
    its first positions (the layer's own projections and RoPE: the K/V or
    latents a prefill writes), and the decode steps' inputs, from one
    seed."""
    d = MESH_DECODE
    cfg = get_config("granite_3_2b" if kind == "gqa" else MOE_ARCH)
    gen = torch.Generator(device=dev)
    gen.manual_seed(MESH_SEED + (2 if kind == "gqa" else 3))
    init = lm_layers.gqa_init if kind == "gqa" else lm_layers.mla_init
    p = init(gen, cfg, device=dev)
    B, P = d["batch"], d["prefill"]
    x = torch.randn((B, P, cfg.d_model), generator=gen, device=dev)
    xs = torch.randn((d["steps"], B, 1, cfg.d_model), generator=gen,
                     device=dev)
    pos = torch.arange(P, device=dev).expand(B, P)
    if kind == "gqa":
        cache = lm_layers.gqa_cache_init(cfg, B, d["cache"], device=dev)
        _, k, v, _, _ = lm_layers._project(p, cfg, x)
        cache["k"][:, :P] = lm_layers.apply_rope(k, pos, cfg.rope_theta)
        cache["v"][:, :P] = v
    else:
        r = cfg.kv_lora_rank
        cache = lm_layers.mla_cache_init(cfg, B, d["cache"], device=dev)
        full = x @ p["wdkv"]
        cache["ckv"][:, :P] = lm_layers.rmsnorm(full[..., :r],
                                                p["kv_ln"]["w"],
                                                cfg.norm_eps)
        cache["k_rope"][:, :P] = lm_layers.apply_rope(
            full[..., None, r:], pos, cfg.rope_theta)[:, :, 0]
    cache["len"].fill_(P)
    return cfg, p, cache, xs


def mesh_decode_rank(dev, mesh, kinds=("gqa", "mla")) -> dict:
    """MESH_DECODE's steps under the mesh (this rank's batch rows and
    sequence span of the cache, through ``decode_dist``) against the same
    decode with no mesh: every step's output within 3e-5 of the largest
    (the JAX test's bound)."""
    rec = {}
    decode = {"gqa": lm_layers.gqa_decode, "mla": lm_layers.mla_decode}
    for kind in kinds:
        cfg, p, cache, xs = decode_inputs(dev, kind)
        specs = SP.cache_specs(cache, cfg)
        blk = {k: SP.local_block(mesh, specs[k], v).clone()
               for k, v in cache.items()}
        want, got, ms = [], [], []
        for x in xs:
            o, cache = decode[kind](p, cfg, x, cache)
            want.append(SP.local_block(mesh, SP.P(SP.BATCH), o))
        with set_mesh(mesh), count_collectives() as calls:
            for x in xs:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                o, blk = decode[kind](
                    p, cfg, SP.local_block(mesh, SP.P(SP.BATCH), x)
                    .contiguous(), blk)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                got.append(o)
        want, got = torch.stack(want), torch.stack(got)
        largest = float(want.abs().max())
        worst = float((got - want).abs().max())
        rec[kind] = {"max_abs": worst, "largest": largest,
                     "ok": worst <= 3e-5 * largest,
                     "len": int(blk["len"][0]), "step_ms": ms,
                     "collectives_per_step": {
                         k: v / len(xs) for k, v in calls.items()},
                     "seq_span": int(blk["k" if kind == "gqa"
                                         else "ckv"].shape[1])}
        del p, cache, blk
        torch.cuda.empty_cache()
    return rec



def mesh_lm_cfg(kind: str):
    """The LM mesh phase's cut configs (granite's 2 layers, DeepSeek-V2's
    prologue and one MoE layer), at full width."""
    if kind == "granite":
        return get_config(LM_ARCH).replace(pattern_repeats=MESH_LM["layers"])
    return get_config(MOE_ARCH).replace(pattern_repeats=MESH_LM_MOE["repeats"])


def mesh_vocab_adapter(cfg, n_model: int):
    """``lm_adapter(cfg)`` whose vocab table holds the rows the mesh pads
    it to (a multiple of the model ranks): a process with no mesh then
    shuffles the ids over the same rows as the mesh (granite's 49,155
    rows over 2 ranks are 49,156; no id reaches the extra row)."""
    import dataclasses
    from repro_torch.core.collection import EmbeddingCollection
    ad = adapters.lm_adapter(cfg)
    name, spec = ad.collection.items()[0]
    spec = dataclasses.replace(spec, rows=spec.padded_rows(n_model))
    return dataclasses.replace(
        ad, collection=EmbeddingCollection.single(name, spec))


def a2a_reference(p, cfg, xd, n: int, route):
    """The a2a dispatch's routed output over one data rank's (B, S, D)
    rows, computed in one process: each model rank's S / n span routed
    on its own, its choices bucketed per destination rank with the
    dispatch's capacity C, each destination's received choices (source
    rank, then bucket slot) cut at each local expert's capacity C2, and
    every kept choice's expert applied to its token, one expert at a time
    (``moe._moe_forward_a2a``'s drops, without its buffers). Returns the
    output and each span's chosen experts."""
    B, S, D = xd.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    e_local, Sl = E // n, S // n
    T_r = B * Sl
    C = max(1, -(-T_r * k // n) * 2)
    C2 = max(1, -(-n * C // e_local))
    spans = [xd[:, m * Sl:(m + 1) * Sl].reshape(T_r, D) for m in range(n)]
    routes = [route(p, cfg, xs) for xs in spans]     # (topv, topi) each
    slots = [lm_moe._dispatch_positions(ti // e_local, n, C)
             for _, ti in routes]
    keep = [sl < n * C for sl in slots]
    for r in range(n):                  # the expert stage on rank r
        picks = []
        for m in range(n):
            t_i, c_i = (keep[m] & (slots[m] // C == r)).nonzero(
                as_tuple=True)
            order = slots[m][t_i, c_i].argsort()
            picks.append((m, t_i[order], c_i[order]))
        e_all = torch.cat([routes[m][1][t, c] - r * e_local
                           for m, t, c in picks])
        ex = torch.arange(e_local, device=xd.device)
        pos = torch.cumsum(ex[:, None] == e_all[None, :], dim=1).gather(
            0, e_all[None, :])[0] - 1
        off = 0
        for m, t, c in picks:
            keep[m][t, c] = pos[off:off + t.numel()] < C2
            off += t.numel()
    outs = []
    for m, xs in enumerate(spans):
        topv, topi = routes[m]
        w = topv * keep[m]
        o = torch.zeros(xs.shape, dtype=torch.float32, device=xs.device)
        for e in range(E):
            t, c = (topi == e).nonzero(as_tuple=True)
            if t.numel():
                xe = xs[t]
                y = (F.silu(xe @ p["wg"][e]) * (xe @ p["wu"][e])) @ p["wd"][e]
                o = o.index_add(0, t, y.float() * w[t, c][:, None])
        outs.append(o.to(xs.dtype).view(B, Sl, D))
    return torch.cat(outs, 1), [ti for _, ti in routes]


def moe_reference(nb: int, n_model: int, disp: str, routes: list):
    """``moe_forward`` as one process computes what the mesh's dispatch
    computes: each data rank's rows routed on their own; under psum the
    capacity from the local tokens; under a2a :func:`a2a_reference`, its
    aux statistics over each model rank's span. The aux statistics
    averaged over the chunks (the mesh's mean over the ranks). Each call
    appends every data rank's chosen experts (under a2a, every span's)
    to ``routes``."""
    orig = lm_moe.moe_forward

    def route(p, cfg, xt):
        logits = xt.float() @ p["router"].float()
        probs, topv, topi = lm_moe.router_topk(logits, cfg.moe_top_k)
        return logits, probs, topv, topi

    def span_aux(p, cfg, xd):
        S, out = xd.shape[1], []
        for m in range(n_model):
            logits, probs, _, topi = route(p, cfg, xd[:, m * S // n_model:(
                m + 1) * S // n_model].reshape(-1, xd.shape[-1]))
            out.append(lm_moe._aux(probs, topi, logits, cfg.n_experts,
                                   torch.ones_like(topi, dtype=torch.bool)))
        return {k: sum(a[k] for a in out) / n_model for k in out[0]}

    def fwd(p, cfg, x, capacity_factor=None, *, with_aux=True):
        outs, auxs, chosen = [], [], []
        for xd in x.chunk(nb, 0):
            if disp == "psum":
                chosen.append(route(p, cfg, xd.reshape(-1, x.shape[-1]))[3])
                o, a = orig(p, cfg, xd, capacity_factor, with_aux=with_aux)
            else:
                o, spans = a2a_reference(
                    p, cfg, xd, n_model, lambda p_, c_, xs: route(
                        p_, c_, xs)[2:])
                chosen.append(spans)
                if cfg.n_shared_experts:
                    o = o + lm_moe._shared(
                        p, xd.reshape(-1, x.shape[-1])).view(xd.shape)
                a = span_aux(p, cfg, xd) if with_aux else {}
            outs.append(o)
            auxs.append(a)
        routes.append(chosen)
        aux = {k: sum(a[k] for a in auxs) / nb for k in auxs[0]} \
            if with_aux else {}
        return torch.cat(outs), aux
    return fwd


def routed_alike_steps(mesh, p: dict, disp: str, got: list,
                       want: list) -> tuple[list, list]:
    """Per step, whether the mesh's MoE calls up to it chose the experts
    the one-process reference chose for the same tokens (``got``: this
    rank's chosen experts a call, its data rank's rows or, under a2a, its
    span of them; ``want``: a call's per data rank, and under a2a per
    span, choices), and how many (token, choice) entries of the step's
    first call differ (-1 where the shapes differ). A step's first call
    is its forward's; a checkpointed layer's recompute routes its same
    inputs again."""
    d, m = mesh.coords(mesh.rank)["data"], mesh.coords(mesh.rank)["model"]
    pg, pw = len(got) // p["steps"], len(want) // p["steps"]
    steps, diffs, run = [], [], True
    for i in range(p["steps"]):
        w = want[i * pw][d]
        w, g = (w[m] if disp == "a2a" else w).cpu(), got[i * pg].cpu()
        diffs.append(int((g != w).sum()) if g.shape == w.shape else -1)
        run = run and torch.equal(g, w)
        steps.append(run)
    return steps, diffs


def mesh_lm_train(dev, mesh, cfg, p: dict, disp: str = "psum") -> dict:
    """``PersiaTrainer(lm_adapter)`` under the mesh for ``p["steps"]``
    hybrid(1) Adam steps (the main path: its launches and collectives
    counted) from one process's ``init`` (this rank's blocks of it), then
    the same steps from the same state in one process on the card (a MoE
    through :func:`moe_reference`), one rank's reference at a time. Held,
    on the steps while every MoE call up to them routed as the
    reference's (all of granite's): each step's loss within rtol 1e-4 /
    atol 1e-5; the rank's blocks of the dense leaves after each step
    whose lookups read the initial vocab table (the first tau + 1 = 2)
    in ``dense_agreement``'s trajectory class
    (Adam moves a weight by about lr a step whatever the size of its
    gradient); the vocab table on the rows no two ids share. Above 4,294
    rows ids share physical rows, and there the reference's mesh put sums
    a row's ids before its accumulator sees them while its one-device put
    adds each id's increment (ROADMAP Queue 3): from the first lookup of
    a row so put (step 3) the two runs part by definition, and the later
    steps' distances are recorded."""
    from repro_torch.utils import collective_counts, reset_collective_counts
    n_model, tau = mesh.shape["model"], 1
    it = lm_batches(cfg.vocab_size, p["batch"], p["seq"], seed=MESH_SEED)
    batches = [next(it) for _ in range(p["steps"])]
    ad = mesh_vocab_adapter(cfg, n_model)
    mk = lambda: PersiaTrainer(ad, TrainMode.hybrid(tau), OptConfig(  # noqa
        kind="adam", lr=DENSE_LR), device=dev)
    rt, tr = mk(), mk()
    with set_mesh(mesh):
        specs = tr.dense_specs()
    blk = lambda tree: SP._zip_map(  # noqa: E731
        lambda s, x: SP.local_block(mesh, s, x).clone(), specs, tree)
    # the global state is drawn from the seed, its blocks kept and drawn
    # again for the reference: four of it (DeepSeek-V2's cut with its
    # moments) do not fit the card beside the other processes' work, so
    # a MoE's ranks draw theirs in turn
    turns = range(mesh.n_ranks) if cfg.n_experts else [mesh.rank]
    for r in turns:
        if r == mesh.rank:
            ref = rt.init(MESH_SEED, batches[0])
            tspec = SP.emb_state_specs(ref.emb["vocab"],
                                       tr.collection["vocab"])["table"]
            with set_mesh(mesh):
                st = tr.local_state(ref)
                start = blk(ref.dense)
                unshared = ~SP.local_block(mesh, SP.P(tspec[0]), shared_rows(
                    tr.collection["vocab"]).to(dev))
            del ref
            gc.collect()
            torch.cuda.empty_cache()
        if len(turns) > 1:
            torch.distributed.barrier()
    snaps, got = [], []
    orig_topk = lm_moe.router_topk

    def recorded(logits, k):            # the mesh's chosen experts
        out = orig_topk(logits, k)
        got.append(out[2].detach().clone())
        return out
    with set_mesh(mesh), mock.patch.object(lm_moe, "router_topk",
                                           recorded):
        rec = {"dense_bytes_per_rank": sum(
            x.numel() * 4 for x in tree_leaves(st.dense)),
            "moment_bytes_per_rank": sum(
            x.numel() * 4 for x in tree_leaves(st.opt["m"]))}
        lm_moe.MOE_DISPATCH = disp
        try:
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            reset_collective_counts()
            losses, ms, drops = [], [], []
            for b in batches:
                t0 = time.perf_counter()
                st, m = tr.step(st, mesh_batch_block(mesh, b))
                losses.append(float(m["loss"]))
                ms.append((time.perf_counter() - t0) * 1e3)
                if "moe_drop_frac" in m:
                    drops.append(float(m["moe_drop_frac"]))
                snaps.append(tree_map(torch.clone, st.dense))
            torch.cuda.synchronize()
            launches = ops.launch_counts()
            colls = collective_counts()
        finally:
            lm_moe.MOE_DISPATCH = "psum"
    nb = mesh.shape["data"]
    ref_losses, per_step, want_routes = [], [], []
    gc.collect()
    torch.cuda.empty_cache()
    # one rank's reference at a time: four one-process DeepSeek-V2 cuts
    # with their gradients and moments do not fit the card together
    # (granite's cut does: its ranks run theirs at once)
    turns = range(mesh.n_ranks) if cfg.n_experts else [mesh.rank]
    for r in turns:
        if r == mesh.rank:
            ref = rt.init(MESH_SEED, batches[0])
            with mock.patch.object(lm_moe, "moe_forward", moe_reference(
                    nb, n_model, disp, want_routes)):
                for i, b in enumerate(batches):
                    ref, m = rt.step(ref, b)
                    ref_losses.append(float(m["loss"]))
                    with set_mesh(mesh):
                        want = blk(ref.dense)
                    per_step.append(dense_agreement(start, snaps[i], want,
                                                    i + 1))
                    del want
            with set_mesh(mesh):
                table_want = SP.local_block(
                    mesh, tspec, ref.emb["vocab"]["table"]).clone()
            del rt, ref
            gc.collect()
            torch.cuda.empty_cache()
        torch.distributed.barrier()
    diff = (st.emb["vocab"]["table"] - table_want).abs().amax(dim=1)
    table = float(diff[unshared].max())
    # the steps held: those while every MoE call up to them routed as the
    # reference's (their losses), and of these the ones whose lookups read
    # the initial table (their dense blocks)
    alike, routing_diff = routed_alike_steps(
        mesh, p, disp, got, want_routes) if got else (
        [True] * p["steps"], [0] * p["steps"])
    n_loss = sum(alike)
    n_held = sum(1 for i in range(min(tau + 1, p["steps"])) if alike[i])
    held = per_step[:n_held]
    rec.update({
        "steps": p["steps"], "dispatch": disp, "losses": losses,
        "losses_one_process": ref_losses,
        "loss_steps_held": n_loss,
        "losses_ok": bool(np.allclose(losses[:n_loss], ref_losses[:n_loss],
                                      rtol=1e-4, atol=1e-5)),
        "routed_alike": alike, "routing_diff": routing_diff,
        "moe_drop_frac": drops, "held_steps": len(held),
        "ok": all(a["ok"] for a in held),
        "per_step": [{k: a[k] for k in ("dense_update_rel",
                                        "dense_max_abs", "dense_off")}
                     for a in per_step],
        "dense_update_rel": max((a["dense_update_rel"] for a in held),
                                default=None),
        "dense_max_abs": max((a["dense_max_abs"] for a in held),
                             default=None),
        "dense_off": held[-1]["dense_off"] if held else None,
        "table_max_abs": table,
        "table_shared_max_abs": float(diff[~unshared].max())
        if bool((~unshared).any()) else 0.0,
        "unshared_row_share": float(unshared.float().mean()),
        # the table after the run holds the puts of steps 1..steps - tau
        "table_held": n_held >= p["steps"] - tau,
        "table_ok": n_held < p["steps"] - tau
        or table <= EMB_LR / 100 * p["steps"] + 1e-6,
        "launches": launches,
        "collectives_per_step": {k: {kk: vv / p["steps"]
                                     for kk, vv in v.items()}
                                 for k, v in colls.items()},
        "step_ms": ms})
    del tr, st, start, snaps, got, want_routes
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def mesh_lm_generate(cfg, dense, table, spec, prompts, p: dict,
                     forced=None, dtype=None):
    """Generation: the vocab lookup and ``transformer.prefill`` into
    ``p["cache"]`` positions, then ``p["gen"]`` decode steps, each fed the
    step's greedy token or, with ``forced`` (steps, B), that token (the
    teacher-forced decode: every step's logits then compare across runs).
    With ``dtype`` the activations are cast to it after the lookup. The
    logits of every step (steps, B, V) and their greedy tokens."""
    V = cfg.vocab_size

    def acts(ids):
        x = PS.lookup({"table": table}, spec, ids)
        return x if dtype is None else x.to(dtype)
    logits, caches = lm_model.prefill(cfg, dense, acts(prompts),
                                      max_len=p["cache"])
    steps = [logits[:, -1, :V].float()]
    for i in range(p["gen"]):
        tok = (steps[-1].argmax(-1) if forced is None else forced[i])[:, None]
        logits, caches = lm_model.decode_step(cfg, dense, acts(tok), caches)
        steps.append(logits[:, -1, :V].float())
    return torch.stack(steps), torch.stack([s.argmax(-1) for s in steps])


@torch.no_grad()
def mesh_lm_serve(dev, mesh, cfg, p: dict) -> dict:
    """granite's cut served under the mesh (this rank's batch rows, its
    blocks of the weights and of the vocab table, the caches sequence-
    sharded over model) against one process on the card over the same
    rows. The one process generates greedily; the mesh's decode is fed
    its tokens, so that every step's logits compare. Each step's logits
    are held within rtol 1e-4 / atol 1e-5 of the one process's, or within
    twice that step's GEMM-only distance: the one process's distance from
    the same run with its weights and activations in fp64 (the attention,
    norms and RoPE in fp32 on both, the attention plain in the fp64 run).
    The mesh's greedy token must equal the one process's wherever the
    top-2 gap of its logits exceeds twice the step's limit."""
    n_model = mesh.shape["model"]
    spec = mesh_vocab_adapter(cfg, n_model).collection["vocab"]
    gen = torch.Generator(device=dev).manual_seed(MESH_SEED + 3)
    dense = lm_model.init_dense(cfg, gen)
    table = torch.randn((spec.padded_rows(n_model), cfg.d_model),
                        generator=gen, device=dev).mul_(0.02)
    prompts = SP.local_block(mesh, SP.P(SP.BATCH), torch.as_tensor(
        lm_serve.make_prompts(cfg, p["batch"], p["prompt"], MESH_SEED),
        device=dev)).contiguous()
    want, wtoks = mesh_lm_generate(cfg, dense, table, spec, prompts, p)
    with mock.patch.object(lm_flash, "flash_attention", plain_attention):
        d64, _ = mesh_lm_generate(
            cfg, tree_map(torch.Tensor.double, dense), table, spec, prompts,
            p, wtoks[:-1], torch.float64)
    gemm = (want - d64).abs().flatten(1).amax(1)                 # (steps,)
    del d64
    torch.cuda.empty_cache()
    with set_mesh(mesh):
        specs = lm_tp.dense_specs(cfg)
        blk = SP._zip_map(lambda s, x: SP.local_block(mesh, s, x).clone(),
                          specs, dense)
        tb = SP.local_block(mesh, SP.P("model", None), table).clone()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        got, toks = mesh_lm_generate(cfg, blk, tb, spec, prompts, p,
                                     wtoks[:-1])
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = ops.launch_counts()
    del blk, tb
    dist = (got - want).abs().flatten(1).amax(1)                 # (steps,)
    plain = [bool(torch.allclose(g, w, rtol=1e-4, atol=1e-5))
             for g, w in zip(got, want)]
    held = [ok or float(d) <= 2 * float(e)
            for ok, d, e in zip(plain, dist, gemm)]
    # how far a logit may move under either class
    lim = torch.maximum(2 * gemm, 1e-5 + 1e-4 * want.abs().flatten(1).amax(
        1))
    top2 = torch.topk(want, 2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]                             # (steps, B)
    decided = gap > 2 * lim[:, None]
    rec = {"logit_max_abs_by_step": dist.tolist(),
           "gemm_only_max_abs_by_step": gemm.tolist(),
           "plain_class_by_step": plain, "held_by_step": held,
           "prefill_max_abs": float(dist[0]),
           "prefill_plain_class": plain[0],
           "tokens_equal": bool(torch.equal(toks, wtoks)),
           "tokens_off_beyond_gap": int((decided & (toks != wtoks)).sum()),
           "tokens_within_gap": int((~decided).sum()),
           "serve_s": serve_s, "launches": launches,
           "cache_span": p["cache"] // n_model}
    del dense, table
    torch.cuda.empty_cache()
    return rec


def mesh_lm_rank(dev, mesh) -> dict:
    """The LM under the mesh on this rank: granite's cut trained (ZeRO
    stages 3 and 2) and served, DeepSeek-V2's cut trained under both
    dispatches, and ``launch.op_cost`` around one more (untimed) granite
    train step at each stage, the records the dry run at mesh (2, 2) is
    held to."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun as lm_dry
    granite, ds2 = mesh_lm_cfg("granite"), mesh_lm_cfg("moe")
    rec, part_s = {}, {}

    def run(key, fn, *args):
        t0 = time.perf_counter()
        rec[key] = fn(dev, mesh, *args)
        part_s[key] = time.perf_counter() - t0
    run("granite_train", mesh_lm_train, granite, MESH_LM)
    # at ZeRO stage 2 the tensor-parallel weights are whole over data and
    # a step reduce-scatters each one's gradient into its moment block and
    # all-gathers the updated block
    with SP.zero_stage(2):
        run("granite_train_zero2", mesh_lm_train, granite, MESH_LM)
    run("granite_serve", mesh_lm_serve, granite, MESH_LM_SERVE)
    for disp in ("psum", "a2a"):
        run("moe_train_" + disp, mesh_lm_train, ds2, MESH_LM_MOE, disp)
    shape = InputShape("mesh_train", MESH_LM["seq"], MESH_LM["batch"],
                       "training")
    for key, stage in (("granite_cost", 3), ("granite_cost_zero2", 2)):
        t0 = time.perf_counter()
        with SP.zero_stage(stage):
            cost = lm_dry.measure(granite, shape, mesh, device=dev,
                                  seed=MESH_SEED)
        rec[key] = {k: cost[k] for k in (
            "flops_per_device", "hbm_bytes_per_device", "collectives",
            "argument_bytes_per_device", "kernels", "hbm_bytes_by_op")}
        part_s[key] = time.perf_counter() - t0
    rec["part_s"] = part_s
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def mesh_worker(rank: int, world: int, name: str, work: str,
                device: str = "cuda") -> int:
    """One rank of ``mesh_phase``'s worlds (``--mesh-worker rank world
    name workdir``): the gloo world of 4 (``gloo``) runs the collective
    probes, the trainer, the tiers, the MoE, the decode and the LM; the
    second gloo world of 4 (``emb``) runs ``mesh_emb_rank`` beside the
    first one's CTR parts, which wait for it to end before the LM (whose
    device memory the two would not share); the NCCL world of one runs
    the probes and the granite decode on ``make_host_mesh()``. Writes its
    record to ``<workdir>/rank<rank>.json`` and, at its end, success or
    not, ``rank<rank>.end``. ``device="cpu"`` rehearses it without a
    card."""
    import datetime
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    if device == "cuda":
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device visible", file=sys.stderr)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        build.build_all()
    # the worlds' 5 processes share the host's cores: their CPU work is
    # numpy, gloo's copies and dispatch, so few intra-op threads each
    torch.set_num_threads(2)
    dev = torch.device(device, 0) if device == "cuda" else torch.device(
        "cpu")
    t0 = time.perf_counter()
    backend = "nccl" if name == "nccl" else "gloo"
    dist.init_process_group(backend, init_method=f"file://{work}/rdzv",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    try:
        mesh = Mesh(MESH_SHAPE, MESH_AXES, device) if world > 1 \
            else make_host_mesh(device)
        rec = {"rank": rank, "backend": backend, "mesh": mesh.shape,
               "collectives": probe_collectives(mesh, dev),
               "setup_s": time.perf_counter() - t0}
        carried = {k for k, v in rec["collectives"].items() if v is True}
        parts = {"train": {"all_reduce_sum", "all_gather_into_tensor"},
                 "tiers": {"all_reduce_sum", "all_gather_into_tensor"},
                 "moe": {"all_reduce_sum", "all_gather_into_tensor",
                         "all_to_all_single"},
                 "decode": {"all_reduce_sum", "all_reduce_max"},
                 "lm": {"all_reduce_sum", "all_reduce_max",
                        "all_gather_into_tensor", "all_to_all_single"},
                 "emb": {"all_reduce_sum", "all_gather_into_tensor"},
                 "online": {"all_reduce_sum", "all_reduce_max",
                            "all_gather_into_tensor"}}
        rec["not_carried"] = {k: sorted(v - carried)
                              for k, v in parts.items() if v - carried}
        runs = {"gloo": ("train", "tiers", "online", "moe", "decode", "lm"),
                "emb": ("emb",), "nccl": ("decode",)}[name]
        kept = {}           # the tiers' checkpointed trainers, for online
        for part, fn in (("train", mesh_train_rank),
                         ("tiers", lambda d, m: mesh_tier_rank(
                             d, m, work, keep=kept)),
                         ("online",
                          lambda d, m: mesh_online_rank(d, m, kept)),
                         ("emb", lambda d, m: mesh_emb_rank(d, m, work)),
                         ("moe", mesh_moe_rank),
                         ("decode", mesh_decode_rank), ("lm", mesh_lm_rank)):
            if part in rec["not_carried"] or part not in runs:
                continue
            if part == "moe":
                t = time.process_time()
                rec["emb_wait_s"] = wait_for_world(
                    Path(work).parent / "emb", MESH_WORLDS["emb"])
                rec["emb_wait_cpu_s"] = time.process_time() - t
            t, c = time.perf_counter(), time.process_time()
            rec[part] = fn(dev, mesh, ("gqa",)) if world == 1 else \
                fn(dev, mesh)
            rec[f"{part}_s"] = time.perf_counter() - t
            rec[f"{part}_cpu_s"] = time.process_time() - c
        if device == "cuda":
            rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        dist.barrier()
        dist.destroy_process_group()
        Path(work, f"rank{rank}.json").write_text(json.dumps(rec))
    finally:
        Path(work, f"rank{rank}.end").write_text("")
    return 0


def wait_for_world(work: Path, n: int, timeout: float = 900.0) -> float:
    """Waits until every rank of the world in ``work`` has ended (its
    ``rank<r>.end``); returns the seconds waited."""
    t0 = time.perf_counter()
    while not all((work / f"rank{r}.end").exists() for r in range(n)):
        check(time.perf_counter() - t0 < timeout,
              f"mesh: the world in {work} did not end")
        time.sleep(0.5)
    return time.perf_counter() - t0


def mesh_emb_rank(dev, mesh, work) -> dict:
    """The embedding tiers under the mesh that earlier slices refused, on
    this rank: MESH_EMB_TIERS held as the tiers are
    (:func:`mesh_tier_rank`), then the remote tables
    (:func:`mesh_remote_run`) over the PS processes ``mesh_start``
    started (their endpoints in ``ps.json`` of the world's directory,
    written once they are up); the remote runs' tensors go to
    ``remote_rank<r>.pt`` there for ``mesh_phase``."""
    out = {"tiers": mesh_tier_rank(dev, mesh, work, MESH_EMB_TIERS)}
    path, t0 = Path(work) / "ps.json", time.perf_counter()
    while not path.exists():
        check(time.perf_counter() - t0 < 600, "mesh: no PS endpoints")
        time.sleep(0.2)
    eps = json.loads(path.read_text())
    check("error" not in eps, f"mesh: the PS processes: {eps.get('error')}")
    out["remote"] = mesh_remote_run(dev, mesh, eps["mesh"])
    torch.save({k: out["remote"].pop(k)
                for k in ("pooled_first", "rows", "puts", "shares")},
               Path(work) / f"remote_rank{mesh.rank}.pt")
    return out


def mesh_online_trajectory(mesh, tr, st, blocks, times: dict):
    """mesh_online's trajectory on this rank (under the mesh in scope):
    a service with 2 reader threads beside a trainer thread that takes
    each of ``blocks``' steps through ``train_turn`` once a flush read
    the step before it. Returns the final state, the record (losses,
    turns, flushes, launches and collectives of the service's run) and
    every flush's (published step, block, pooled rows); ``times`` takes
    ``trajectory_s`` / ``trajectory_cpu_s``."""
    import threading

    from repro_torch.utils import collective_counts, reset_collective_counts
    p = MESH_ONLINE
    ds = CTR_BENCHMARKS["kwai_video"]
    reqs = [r for _, r in TrafficModel.for_dataset(ds, seed=SEED).requests(
        64, seed=MESH_SEED + 10 + mesh.rank)]
    t0 = time.perf_counter(), time.process_time()
    cell = StateCell(st, 0)
    svc = ServingService(tr, cell, ServingConfig(
        max_batch=p["max_batch"], max_wait_ms=2.0))
    flushes, real = [], tr.serve_lookup

    def recording(state, batch):
        pooled, info = real(state, batch)
        flushes.append((cell.step, batch, {n: v.clone()
                                           for n, v in pooled.items()}))
        return pooled, info
    tr.serve_lookup = recording
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    reset_collective_counts()
    svc.start()
    done, losses, errors, final = threading.Event(), [], [], {}

    def train():
        s = st
        for t in range(len(blocks)):
            while not any(f[0] == t for f in flushes) and not errors:
                time.sleep(1e-3)

            def fn(agreed, t=t):
                nonlocal s
                s, m = tr.step(s, blocks[t])
                cell.publish(s, t + 1)
                return float(m["loss"])
            losses.append(svc.train_turn(fn))
        final["state"] = s

    def reader(i):
        # until a flush read the last published step (no flush after it)
        k = 0
        while not done.is_set() and not any(f[0] == len(blocks)
                                             for f in flushes):
            svc.predict(reqs[(2 * k + i) % len(reqs)])
            k += 1

    def guarded(fn, *a):
        try:
            fn(*a)
        except Exception as e:      # noqa: BLE001 -- recorded, checked
            errors.append(f"{type(e).__name__}: {e}")
    threads = [threading.Thread(target=guarded, args=(train,))] + [
        threading.Thread(target=guarded, args=(reader, i)) for i in range(2)]
    for th in threads:
        th.start()
    threads[0].join()
    while not any(f[0] == len(blocks) for f in flushes) and not errors:
        time.sleep(1e-3)
    done.set()
    for th in threads[1:]:
        th.join()
    guarded(svc.stop)
    torch.cuda.synchronize()
    del tr.serve_lookup
    times["trajectory_s"] = time.perf_counter() - t0[0]
    times["trajectory_cpu_s"] = time.process_time() - t0[1]
    traj = {"errors": errors, "losses": losses,
            "turns": svc.turn_counts(), "flushes": len(flushes),
            "flush_steps": [f[0] for f in flushes],
            "requests": svc.metrics()["serving/requests"],
            "launches": ops.launch_counts(), "tables": ops.table_counts(),
            "collectives": collective_counts()}
    check(not errors, f"mesh_online: the trajectory raised {errors[:2]}")
    return final["state"], traj, flushes


def mesh_online_rank(dev, mesh, kept: dict) -> dict:
    """The service and the online loop under the mesh on this rank
    (MESH_ONLINE). The trajectory and its serial run were the tiers
    part's checkpoint resume (:func:`mesh_tier_checkpoint`: ``kept``
    holds their record, seconds, and the trajectory's trainer and
    state); here ``_online_loop`` runs from the trajectory's state.
    Launches and collectives are counted around the loop."""
    from repro_torch.utils import collective_counts, reset_collective_counts
    p = MESH_ONLINE
    ds = CTR_BENCHMARKS["kwai_video"]
    tr, st = kept.pop("pair")
    rec = {"trajectory": kept.pop("trajectory"),
           **{k: kept.pop(k) for k in ("trajectory_s", "trajectory_cpu_s",
                                       "serial_s", "serial_cpu_s")}}

    def clock():
        return time.perf_counter(), time.process_time()

    def lap(key, start):
        rec[f"{key}_s"] = time.perf_counter() - start[0]
        rec[f"{key}_cpu_s"] = time.process_time() - start[1]

    with set_mesh(mesh):
        # the closed loop from the trajectory's state
        t0 = clock()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        reset_collective_counts()
        summary, extras = online._online_loop(
            tr, ds, steps=p["loop_steps"], batch=TRAIN_B,
            config=ServingConfig(max_batch=p["max_batch"]),
            n_clients=p["clients"], requests_per_client=p["requests"],
            seed=SEED, state=st)
        torch.cuda.synchronize()
        lap("loop", t0)
        sv = summary["serving"]
        preds = extras["preds"]
        rec["loop"] = {
            "steps": summary["steps"], "served": summary["served"],
            "feedback_put": summary["feedback"]["put"],
            "requests": sv["serving/requests"],
            "errors": sv["serving/errors"],
            "flushes": sv["serving/batches"],
            "fill": sv["serving/field_00/batch_fill"],
            "stale_max": max(sv[f"serving/{n}/stale_steps"]
                             for n in tr.collection.names),
            "feedback_batches": summary["feedback_batches"],
            "fallback_batches": summary["fallback_batches"],
            "losses_finite": bool(np.isfinite(summary["loss_first"])
                                  and np.isfinite(summary["loss_last"])),
            "preds_in_range": bool(np.all(np.isfinite(preds))
                                   and preds.min() >= 0
                                   and preds.max() <= 1),
            "p50_ms": sv["serving/p50_ms"], "p99_ms": sv["serving/p99_ms"],
            "steps_per_s": summary["steps_per_s"], "wall_s":
            extras["wall_s"], "turns": extras["turns"],
            "launches": ops.launch_counts(), "tables": ops.table_counts(),
            "collectives": collective_counts(),
            "counters": lru_table_counters(tr), "digest": lru_digest(tr)}
    del tr, st, extras
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def remote_reference(dev, started: dict) -> dict:
    """The remote runs of ``mesh_emb_rank`` in this process, with no mesh
    and the global batches, over the PS processes ``mesh_start`` started
    for it (:func:`mesh_remote_run`), beside the worlds."""
    started["ps_thread"].join()
    eps = started["ps"]
    check("error" not in eps, f"mesh: the PS processes: {eps.get('error')}")
    return mesh_remote_run(dev, None, eps["one"])


MESH_WORLDS = {"gloo": math.prod(MESH_SHAPE), "emb": math.prod(MESH_SHAPE),
               "nccl": 1}


def mesh_start() -> dict:
    """Starts ``mesh_phase``'s worlds: two worlds of 4 gloo processes
    (mesh data 2 x model 2; the second for ``mesh_emb_rank``) and a world
    of one over NCCL, together, as ``--mesh-worker`` processes of this
    script, each writing its output to a log file, and the PS processes of
    the remote runs. They run while this process goes on."""
    work = ROOT / "build" / "mesh"
    shutil.rmtree(work, ignore_errors=True)
    started = {"t0": time.perf_counter(), "work": work, "procs": [],
               "members": [], "ps": {}}
    (work / "emb").mkdir(parents=True)

    def spawn():
        # the PS processes of mesh_emb_rank's remote runs: one with the
        # dense tables and REMOTE_K with host_lru tables for the world,
        # and as many for the same runs in this process
        try:
            for key in ("mesh", "one"):
                # no spool: the kill drill is not run under the mesh
                ms = ps_cluster.spawn_cluster(
                    str(work / f"ps_{key}"), 1 + REMOTE_K, spool_every=0,
                    device="cuda")
                started["members"] += ms
                eps = [(m.host, m.port) for m in ms]
                started["ps"][key] = {"dense": eps[:1], "lru": eps[1:]}
        except Exception as e:          # noqa: BLE001
            started["ps"] = {"error": f"{type(e).__name__}: {e}"}
        out = started["ps"]
        (work / "emb" / "ps.tmp").write_text(json.dumps(
            out if "error" in out else {"mesh": out["mesh"]}))
        os.replace(work / "emb" / "ps.tmp", work / "emb" / "ps.json")
    started["ps_thread"] = threading.Thread(target=spawn, daemon=True)
    started["ps_thread"].start()
    try:
        for name, n in MESH_WORLDS.items():
            (work / name).mkdir(parents=True, exist_ok=True)
            for r in range(n):
                log = open(work / name / f"rank{r}.log", "w")
                started["procs"].append((name, r, log, subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"),
                     "--mesh-worker", str(r), str(n), name,
                     str(work / name)], stdout=log,
                    stderr=subprocess.STDOUT)))
    except BaseException:
        mesh_stop(started)
        raise
    return started


def mesh_stop(started: dict):
    """Ends every process of ``mesh_start`` that is still running (the
    PS processes too)."""
    for _, _, log, p in started["procs"]:
        if p.poll() is None:
            p.kill()
        p.wait()
        log.close()
    started["ps_thread"].join()
    ps_cluster.stop_ps(started["members"])


def mesh_phase(started: dict, remote_ref: dict):
    """The mesh paths on the card, from the worlds ``mesh_start`` started:
    waits for them, then checks every rank's record (the collectives gloo
    carries on CUDA tensors; kwai-dlrm under the mesh against one process;
    the tiers and checkpoints; the MoE's two dispatches; the decode; the
    LM) and returns the trainer's launches summed over the ranks as the
    ``mesh_train`` path, with the phase's record."""
    t_phase, work, procs = started["t0"], started["work"], started["procs"]
    worlds = MESH_WORLDS
    t_wait = time.perf_counter()
    try:
        for _, _, _, p in procs:
            p.wait(timeout=max(1.0, 900 - (time.perf_counter() - t_phase)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        mesh_stop(started)
    wait_s = time.perf_counter() - t_wait
    logs = {(b, r): (work / b / f"rank{r}.log").read_text()
            for b, r, _, _ in procs}
    procs = [(b, r, p) for b, r, _, p in procs]
    recs = {}
    for b, r, p in procs:
        path = work / b / f"rank{r}.json"
        check(p.returncode == 0 and path.exists(),
              f"mesh: {b} rank {r} exited {p.returncode}:\n"
              f"{logs[(b, r)][-3000:]}")
        recs[(b, r)] = json.loads(path.read_text())
    gl = [recs[("gloo", r)] for r in range(worlds["gloo"])]
    el = [recs[("emb", r)] for r in range(worlds["emb"])]
    emb_launches = dict.fromkeys(ops.launch_counts(), 0)
    emb_served = dict.fromkeys(ops.table_counts(), 0)
    emb = None
    if "emb" in el[0]:
        emb = mesh_emb_check(gl, el, remote_ref, work / "emb", emb_launches,
                             emb_served)
    shutil.rmtree(work, ignore_errors=True)
    nc = recs[("nccl", 0)]
    launches = dict.fromkeys(ops.launch_counts(), 0)
    served = dict.fromkeys(ops.table_counts(), 0)
    rec = {"phase": "mesh", "mesh": dict(zip(MESH_AXES, MESH_SHAPE)),
           "ranks": worlds["gloo"], "backend": "gloo",
           "collectives_gloo_cuda": gl[0]["collectives"],
           "collectives_nccl_world_of_one": nc["collectives"],
           "not_carried": gl[0]["not_carried"],
           "setup_s": max(g["setup_s"] for g in gl),
           "peak_gib_per_rank": [g.get("peak_gib") for g in gl]
           + [nc.get("peak_gib")]}
    for g in gl:
        check(g["collectives"] == gl[0]["collectives"],
              f"mesh: ranks disagree on the collectives {g['collectives']}")
    # kwai-dlrm under the mesh against one process
    if "train" in gl[0]:
        rec["train"] = {}
        for tag, _, steps in MESH_TRAIN:
            per = [g["train"][tag] for g in gl]
            for g in per:
                check(g["first_lookup_bit_exact"] and g["steps_ok"]
                      and np.isfinite(g["losses"]).all(),
                      f"mesh train {tag}: first lookups "
                      f"{g['first_lookup_bit_exact']}, steps "
                      f"{[p for p in g['per_step'] if not p['ok']][:2]}")
                for k in launches:
                    launches[k] += g["launches"][k]
                for k in served:
                    served[k] += g["tables"][k]
            want = {"unique_bag": steps, "fused_backward": 2 * N_TABLES
                    * steps}
            for g in per:
                check(all(g["launches"][k] == v for k, v in want.items()),
                      f"mesh train {tag}: launches {g['launches']}, want "
                      f"{want}")
            steps_rec = [{k: max(g["per_step"][i][k] for g in per)
                          for k in ("table", "acc", "table_shared",
                                    "acc_shared", "dense_max_abs",
                                    "dense_update_rel")}
                         | {"loss": per[0]["per_step"][i]["loss"],
                            "loss_one_process":
                            per[0]["per_step"][i]["loss_one_process"]}
                         for i in range(steps)]
            rec["train"][tag] = {
                "steps": steps, "losses": per[0]["losses"],
                "losses_one_process": per[0]["losses_one_process"],
                "per_step": steps_rec,
                "whole_run": {k: max(g["whole_run"][k] for g in per)
                              for k in per[0]["whole_run"]
                              if k != "ok"},
                "shared_row_share": per[0]["shared_row_share"],
                "launches_per_rank": per[0]["launches"],
                "collectives_per_step": per[0]["collectives_per_step"],
                "step_ms_per_rank": [float(np.median(g["step_ms"][1:]))
                                     for g in per]}
    # the out-of-core tier and the wire under the mesh, and checkpoints
    tier_launches = dict.fromkeys(ops.launch_counts(), 0)
    tier_served = dict.fromkeys(ops.table_counts(), 0)
    if "tiers" in gl[0]:
        rec["tiers"] = mesh_tier_check(gl, tier_launches, tier_served)
    # the service and the online loop under the mesh
    online_launches = dict.fromkeys(ops.launch_counts(), 0)
    online_served = dict.fromkeys(ops.table_counts(), 0)
    check("online" in gl[0], f"mesh: mesh_online did not run: "
          f"{gl[0]['not_carried']}")
    rec["online"] = mesh_online_check(gl, online_launches, online_served)
    emit({"phase": "mesh_online", **rec["online"]})
    # the expert-parallel MoE against moe_forward with no mesh
    if "moe" in gl[0]:
        gemm = gl[0]["moe"]["gemm_only_max_abs"]
        rec["moe"] = {"gemm_only_max_abs": gemm,
                      "largest": gl[0]["moe"]["largest"],
                      "expert_bytes_per_rank":
                      gl[0]["moe"]["expert_bytes_per_rank"]}
        for disp in ("psum", "a2a"):
            worst = max(g["moe"][disp]["max_abs"] for g in gl)
            plain = all(g["moe"][disp]["plain_class"] for g in gl)
            check(plain or worst <= 2 * gemm,
                  f"mesh moe {disp}: max |d| {worst}, GEMM-only {gemm}")
            rec["moe"][disp] = {
                "max_abs": worst, "plain_class": plain,
                "held_by": "plain class" if plain else "2x GEMM-only",
                "ms_per_rank": [g["moe"][disp]["ms"] for g in gl],
                "collectives": gl[0]["moe"][disp]["collectives"],
                "aux": gl[0]["moe"][disp]["aux"]}
    # the sequence-sharded decode, and the world of one over NCCL
    for name, rs in (("decode", gl), ("decode_nccl_world_of_one", [nc])):
        if "decode" not in rs[0]:
            continue
        rec[name] = {}
        for kind in rs[0]["decode"]:
            per = [g["decode"][kind] for g in rs]
            for g in per:
                check(g["ok"] and g["len"] == MESH_DECODE["prefill"]
                      + MESH_DECODE["steps"], f"mesh {name} {kind}: {g}")
            rec[name][kind] = {
                "max_abs": max(g["max_abs"] for g in per),
                "largest": per[0]["largest"], "seq_span": per[0]["seq_span"],
                "collectives_per_step": per[0]["collectives_per_step"],
                "step_ms_per_rank": [float(np.median(g["step_ms"][1:]))
                                     for g in per]}
    check("train" in rec and "tiers" in rec
          and "decode_nccl_world_of_one" in rec,
          f"mesh: gloo carries too little to train: {rec['not_carried']}")
    lm_launches = dict.fromkeys(ops.launch_counts(), 0)
    check("lm" in gl[0], f"mesh: the LM did not run: {rec['not_carried']}")
    rec["lm"] = mesh_lm_check(gl, lm_launches)
    check(emb is not None, f"mesh: mesh_emb did not run: "
          f"{el[0]['not_carried']}")
    rec["emb"] = emb
    parts = ("train", "tiers", "online", "emb", "emb_wait", "moe",
             "decode", "lm")
    rec["part_s"] = {k: max(g.get(f"{k}_s", 0.0) for g in gl + el)
                     for k in parts}
    rec["part_cpu_s"] = {k: max(g.get(f"{k}_cpu_s", 0.0) for g in gl + el)
                         for k in parts}
    # from the worlds' start; the checks run beside them until "wait_s"
    # before the end of the phase
    rec["phase_s"] = time.perf_counter() - t_phase
    rec["wait_s"] = wait_s
    emit(rec)
    return {"mesh_train": (launches, served),
            "mesh_tiers": (tier_launches, tier_served),
            "mesh_online": (online_launches, online_served),
            "mesh_emb": (emb_launches, emb_served),
            "mesh_lm": (lm_launches, dict.fromkeys(ops.table_counts(), 0))
            }, rec


def tier_step_launches(backend: str, extra: dict) -> dict:
    """What one step of a tier makes on a rank under the mesh: the get's
    one bag launch (``embedding_bag`` at occurrence width); a host_lru
    table's sum-only and gathered apply ``fused_backward`` (at occurrence
    width the gathered apply alone), a router table's sum-only and one
    apply a shard, the wire's sums, global sums and one apply a shard
    (one for a table of one); the wire's compress and decompress for the
    get and for the put."""
    wire, k = backend.endswith("+compressed"), extra.get("emb_shards", 1)
    flat = extra.get("batch_dedup") is False
    if flat:
        fb = 1
    elif wire:
        fb = 2 + k
    else:
        fb = 1 + k if k > 1 else 2
    return {"embedding_bag" if flat else "unique_bag": 1,
            "fused_backward": fb * N_TABLES,
            "blockscale_compress": 2 if wire else 0,
            "blockscale_decompress": 2 if wire else 0}


def mesh_tier_check(gl: list, launches: dict, served: dict,
                    tiers=None, part: str = "tiers") -> dict:
    """Every rank's tier records held (see :func:`mesh_tier_rank`): each
    step, the stores after the run, the warm-up of at least tau + 1 steps
    and the updated rows written back in it and in the held steps, a
    step's launches (the get's one bag launch; a host_lru table's
    sum-only and gathered apply ``fused_backward``, the wire's sums,
    global sums and apply; the wire's compress and decompress for the get
    and for the put), the checkpoint's resume on every rank and its
    one-process restore; the mesh's launches summed over the ranks into
    ``launches`` / ``served``."""
    out, steps = {}, MESH_TIER["steps"]
    for tag, backend, extra in MESH_TIERS if tiers is None else tiers:
        per = [g[part][tag] for g in gl]
        lru = backend.startswith(HOST_LRU)
        want = {k: v * steps
                for k, v in tier_step_launches(backend, extra).items()}
        for g in per:
            check(g["steps_ok"] and g["stores_equal"]
                  and g["warm_steps"] >= TAU + 1 and (not lru or (
                      g["wrote_back_updated"]
                      and g["updated_rows_written_back"] > 0)),
                  f"mesh tier {tag}: after {g['warm_steps']} warm steps "
                  f"every table wrote back an updated row: "
                  f"{g['wrote_back_updated']}; the held steps wrote back "
                  f"{g['updated_rows_written_back']}; stores equal "
                  f"{g['stores_equal']}, steps "
                  f"{[p for p in g['per_step'] if not p['ok']][:2]}")
            check(all(g["launches"][k] == v for k, v in want.items()),
                  f"mesh tier {tag}: launches {g['launches']}, want {want}")
            for k in launches:
                launches[k] += g["launches"][k]
            for k in served:
                served[k] += g["tables"][k]
        out[tag] = {
            "backend": backend, "warm_steps": per[0]["warm_steps"],
            "updated_rows_written_back":
            per[0]["updated_rows_written_back"],
            "warm_s": max(g["warm_s"] for g in per),
            "losses": [p["loss"] for p in per[0]["per_step"]],
            "losses_one_process": [p["loss_one_process"]
                                   for p in per[0]["per_step"]],
            "per_step": [{k: max(g["per_step"][i][k] for g in per)
                          for k in ("table", "acc", "update_rel",
                                    "off_elements", "queue_max_abs",
                                    "queue_rel")}
                         for i in range(steps)],
            "counters": per[0]["counters"], "slots_a_rank":
            per[0]["slots_a_rank"], "cache_bytes_a_rank":
            per[0]["cache_bytes_a_rank"], "host_bytes_a_rank":
            per[0]["host_bytes_a_rank"],
            "launches_per_rank": per[0]["launches"],
            "step_ms_per_rank": [float(np.median(g["step_ms"]))
                                 for g in per]}
        if "checkpoint" in per[0]:
            for r, g in enumerate(per):
                check(g["checkpoint"]["resume_bit_exact"],
                      f"mesh tier {tag}: the resume under the mesh differs "
                      f"from the uninterrupted run on rank {r}")
            c = per[0]["checkpoint"]
            check(c["one_process_bit_exact"],
                  f"mesh tier {tag}: one process's restore differs from the "
                  "joined mesh state")
            out[tag]["checkpoint"] = {
                k: c[k] for k in ("bytes", "save_s", "restore_s",
                                  "one_process_restore_s", "resume_steps",
                                  "resume_bit_exact",
                                  "one_process_bit_exact")}
    return out


def mesh_online_check(gl: list, launches: dict, served: dict) -> dict:
    """Every rank's mesh_online record held (see :func:`mesh_online_rank`):
    the trajectory's flushes bit for bit with the serial run's reads at
    the same steps, its losses, every rank's blocks of the final state,
    LRU counters, slot maps and stores equal to the serial run's; the
    same turns and flush steps on every rank; the loop's invariants on
    every rank (the steps asked for, every impression fed back and
    served, no error, stale steps within tau, a padded flush, the same
    flushes, turns and feedback / fallback choices, slot maps and
    counters on every rank); the launches of the trajectory's service run
    and of the loop (one ``unique_bag`` a flush a rank,
    ``tier_step_launches`` a step), summed over the ranks into
    ``launches`` / ``served``."""
    p = MESH_ONLINE
    _, backend, extra = next(t for t in MESH_TIERS
                             if t[0] == MESH_TIER["checkpoint"])
    per_step = tier_step_launches(backend, extra)
    per = [g["online"] for g in gl]
    t0, l0 = per[0]["trajectory"], per[0]["loop"]
    n_req = p["clients"] * p["requests"]
    for r, g in enumerate(per):
        t, lp = g["trajectory"], g["loop"]
        check(t["reads"] == t["flushes"] > p["steps"] and not t["off"]
              and t["losses_equal"] and t["state_bit_exact"]
              and t["counters_equal"] and t["slot_maps_equal"]
              and t["stores_equal"],
              f"mesh_online rank {r}: the trajectory left the serial run: "
              f"{t['reads']} reads of {t['flushes']} flushes, off "
              f"{t['off']}, losses {t['losses_equal']}, state "
              f"{t['state_bit_exact']}, counters {t['counters_equal']}, "
              f"slot maps {t['slot_maps_equal']}, stores "
              f"{t['stores_equal']}")
        check(t["turns"] == t0["turns"] and t["flush_steps"]
              == t0["flush_steps"] and t["turns"]["step"] == p["steps"]
              and set(t["flush_steps"]) == set(range(p["steps"] + 1)),
              f"mesh_online rank {r}: turns {t['turns']} at "
              f"{t['flush_steps']}, rank 0 {t0['turns']} at "
              f"{t0['flush_steps']}")
        check(lp["steps"] == p["loop_steps"] and lp["served"] == n_req
              and lp["feedback_put"] == n_req and lp["requests"] == n_req
              and lp["errors"] == 0 and lp["stale_max"] <= TAU
              and lp["fill"] < 1 and lp["losses_finite"]
              and lp["preds_in_range"],
              f"mesh_online rank {r}: the loop's invariants: {lp}")
        check(lp["flushes"] == l0["flushes"] and lp["turns"] == l0["turns"]
              and (lp["feedback_batches"], lp["fallback_batches"])
              == (l0["feedback_batches"], l0["fallback_batches"])
              and lp["counters"] == l0["counters"]
              and lp["digest"] == l0["digest"],
              f"mesh_online rank {r}: the loop's flushes, turns, choices or "
              f"host tiers differ from rank 0's")
        for part, steps, flushes in (("trajectory", p["steps"], t["flushes"]),
                                     ("loop", p["loop_steps"],
                                      int(lp["flushes"]))):
            got = g[part]["launches"]
            want = {k: v * steps for k, v in per_step.items()}
            want["unique_bag"] += flushes
            check(all(got[k] == want.get(k, 0) for k in got),
                  f"mesh_online rank {r} {part}: launches {got}, want {want}")
            for k in launches:
                launches[k] += got[k]
            for k in served:
                served[k] += g[part]["tables"][k]
    keys = ("trajectory", "serial", "loop")
    return {
        "tier": MESH_TIER["checkpoint"], "steps": p["steps"],
        "loop_steps": p["loop_steps"], "max_batch": p["max_batch"],
        "clients_per_rank": p["clients"],
        "requests_per_client": p["requests"],
        "pooled_max_abs": max(g["trajectory"]["pooled_max_abs"]
                              for g in per),
        "trajectory": {k: t0[k] for k in ("turns", "flushes", "reads",
                                          "flush_steps", "losses",
                                          "requests", "collectives")},
        "loop": {k: l0[k] for k in ("turns", "flushes", "fill",
                                    "stale_max", "feedback_batches",
                                    "fallback_batches", "collectives")},
        "loop_p50_ms": [g["loop"]["p50_ms"] for g in per],
        "loop_p99_ms": [g["loop"]["p99_ms"] for g in per],
        "loop_steps_per_s": [g["loop"]["steps_per_s"] for g in per],
        "launches_per_rank": {part: per[0][part]["launches"]
                              for part in ("trajectory", "loop")},
        "seconds": {k: max(g[f"{k}_s"] for g in per) for k in keys},
        "cpu_seconds": {k: max(g[f"{k}_cpu_s"] for g in per) for k in keys}}


def mesh_emb_check(gl: list, el: list, ref: dict, work: Path,
                   launches: dict, served: dict) -> dict:
    """Every rank's mesh_emb record held (see :func:`mesh_emb_rank`): the
    router (also behind the compressed wire) and occurrence-width tiers
    as the tiers are; the serve reads (bit for bit with one process,
    gauges with hits and misses, nothing of the tier moved, one bag
    launch); the pipelined trainer (max_inflight 1 bit for bit with
    serial, the deep run's puts in batch order, the host tiers' digest
    equal on every rank); the remote run against this process's run of
    it (``ref``): the ranks' losses equal, the first step's pooled
    lookups bit for bit and its loss within rtol 1e-5, the later losses
    (the last reads the first applied put) within rtol 1e-3 (a whole
    run: the mesh's dense steps part from one process's by rounding
    through Adam's sign steps, the class PR 29 records for mesh_train's
    whole run); each applied put, as the PS got it, against one
    process's put of the mesh's own ranks' shares (the same ids, the sums
    in ``queue_agreement``'s class) and against one process's run (the
    same ids, within PUT_CAP of its largest element: on the card the
    dense backward at a 256-row block and at the 512-row batch differs by
    up to ~1% of a small activation gradient); the serve read of the
    first batch after the run apart from one process's, in norm, by at
    most ROWS_REL of what the applied puts moved it (adagrad's
    1 / sqrt(eps) carries the puts' distance into rows with a small
    gradient);
    the PS's counters, its processes' launches and the frames sent equal
    one process's, the first rank alone connected.
    ``gl``: the first world's records (the tiers' serve reads and
    pipeline), ``el``: the emb world's. The launches summed over the
    ranks into ``launches`` / ``served``."""
    from repro_torch.utils import MeshLayout
    out = {"tiers": mesh_tier_check([g["emb"] for g in el], launches,
                                    served, MESH_EMB_TIERS)}
    # the serve reads and the pipeline, on MESH_TIERS' held states
    for tag in MESH_EMB["serve"]:
        per = [g["tiers"][tag]["serve_read"] for g in gl]
        for g in per:
            check(g["bit_exact"] and g["unchanged"] and g["hits"] > 0
                  and g["misses"] > 0 and g["launches"]["unique_bag"] == 1,
                  f"mesh serve read {tag}: {g}")
            for k in launches:
                launches[k] += g["launches"][k]
            for k in served:
                served[k] += g["tables"][k]
        out[f"serve_read_{tag}"] = {
            "bit_exact": True, "hits": per[0]["hits"],
            "misses": per[0]["misses"], "launches_per_rank":
            per[0]["launches"], "ms_per_rank": [g["ms"] for g in per],
            "collectives_per_rank": per[0]["collectives"]}
    per = [g["tiers"][MESH_EMB["pipe"]]["pipeline"] for g in gl]
    steps = MESH_EMB["pipe_steps"]
    extra = {t: e for t, _, e in MESH_TIERS}[MESH_EMB["pipe"]]
    want = {k: v * steps
            for k, v in tier_step_launches(HOST_LRU, extra).items()}
    for r, g in enumerate(per):
        check(g["inflight_1_bit_exact"] and g["deep_in_order"],
              f"mesh pipeline rank {r}: max_inflight 1 bit for bit "
              f"{g['inflight_1_bit_exact']}, deep in order "
              f"{g['deep_in_order']}")
        for runner in ("serial", "pipelined_1", "pipelined_deep"):
            check(g[runner]["digest"] == per[0][runner]["digest"],
                  f"mesh pipeline {runner}: rank {r}'s host tiers differ "
                  "from rank 0's")
            check(all(g[runner]["launches"][k] == v
                      for k, v in want.items()),
                  f"mesh pipeline {runner}: launches "
                  f"{g[runner]['launches']}, want {want}")
        for k in launches:
            launches[k] += g["serial"]["launches"][k]
        for k in served:
            served[k] += g["serial"]["tables"][k]
    out["pipeline"] = {
        "tier": MESH_EMB["pipe"], "steps": steps,
        "max_inflight": PIPE_INFLIGHT, "prefetch": PIPE_PREFETCH,
        "inflight_1_bit_exact": True, "deep_in_order": True,
        "losses": {k: per[0][k]["losses"] for k in
                   ("serial", "pipelined_1", "pipelined_deep")},
        "s_per_rank": {k: [g[k]["s"] for g in per] for k in
                       ("serial", "pipelined_1", "pipelined_deep")}}
    # the remote tables against this process's run
    layout = MeshLayout(MESH_SHAPE, MESH_AXES)
    n = len(el)
    tensors = [torch.load(work / f"remote_rank{r}.pt") for r in range(n)]
    per, one = [g["emb"]["remote"] for g in el], ref
    steps, applied = MESH_EMB["remote_steps"], MESH_EMB["remote_steps"] - TAU
    conn = [g["connected"] for g in per]
    check(conn == [True] + [False] * (n - 1),
          f"mesh remote: connections {conn}")
    check(all(g["losses"] == per[0]["losses"] for g in per),
          "mesh remote: the ranks' losses differ")
    rel = [abs(a - b) / abs(b) for a, b in zip(per[0]["losses"],
                                               one["losses"])]
    first = all(torch.equal(tensors[r]["pooled_first"][t],
                            SP.local_block(layout, SP.P(SP.BATCH), v, rank=r))
                for r in range(n) for t, v in one["pooled_first"].items())
    # the serve read of the first batch after the run against one
    # process's, over what the applied puts moved its rows (one process's
    # read after the run against its first step's lookup of that batch)
    blk = lambda v, r: SP.local_block(layout, SP.P(SP.BATCH), v, rank=r)  # noqa: E731
    rows = max(float((tensors[r]["rows"][t] - blk(v, r)).abs().max())
               for r in range(n) for t, v in one["rows"].items())
    rows_d, moved = (math.sqrt(sum(float(x.double().square().sum())
                                   for x in xs)) for xs in (
        [tensors[r]["rows"][t] - blk(v, r) for r in range(n)
         for t, v in one["rows"].items()],
        [blk(v - one["pooled_first"][t], r) for r in range(n)
         for t, v in one["rows"].items()]))
    rows_rel = rows_d / max(moved, 1e-30)
    # the ranks whose shares the first rank's put gathers
    group = [r for r in range(n) if all(
        layout.coords(r)[a] == layout.coords(0)[a]
        for a in MESH_AXES if a not in ("pod", "data"))]
    held = []
    for i in range(applied):
        mp, op = tensors[0]["puts"][i], one["puts"][i]
        # the mesh's global put against one process's put of its ranks'
        # shares (summed by id in fp64): the same ids, every sum in
        # queue_agreement's class (the shares' sums add in another order)
        share_ok, share_d = set(mp) == set(op) and len(mp) == N_TABLES, 0.0
        for t in op:
            ids = torch.cat([tensors[r]["shares"][i][t][0] for r in group])
            sh = torch.cat([tensors[r]["shares"][i][t][1]
                            for r in group]).double()
            u, pos = torch.unique(ids.long(), return_inverse=True)
            want = torch.zeros((u.numel(), DIM),
                               dtype=torch.float64).index_add_(0, pos, sh)
            o = mp[t][0].long().argsort()
            got = mp[t][1][o].double()
            top = float(want.abs().max()) if want.numel() else 0.0
            same = torch.equal(mp[t][0][o].long(), u)
            if same:
                share_d = max(share_d, float((got - want).abs().max()))
            share_ok = share_ok and same and bool(torch.isclose(
                got, want, rtol=1e-4, atol=1e-4 * top).all())
        # against one process's put on the same ids: its distance, the
        # card's dense backward at a rank's block against the batch's
        # (PERF.md), held to PUT_CAP of the put's largest element
        same_ids = set(mp) == set(op) and all(torch.equal(
            mp[t][0].sort().values, op[t][0].sort().values) for t in op)
        put_d = max(float((mp[t][1][mp[t][0].argsort()]
                           - op[t][1][op[t][0].argsort()]).abs().max())
                    for t in op) if same_ids else float("inf")
        put_top = max(float(v[1].abs().max()) for v in op.values())
        held.append({"step": i, "shares_held": share_ok,
                     "share_max_abs": share_d, "same_ids": same_ids,
                     "one_process_max_abs": put_d, "largest": put_top,
                     "rel": put_d / put_top})
    puts_ok = all(h["shares_held"] and h["same_ids"]
                  and h["rel"] <= PUT_CAP for h in held)
    check(first and rel[0] <= 1e-5 and max(rel) <= 1e-3 and puts_ok
          and rows_rel <= ROWS_REL
          and per[0]["ps"] == one["ps"]
          and per[0]["ps_launches"] == one["ps_launches"]
          and per[0]["frames"] == one["frames"],
          f"mesh remote: first lookups bit for bit {first}, loss distances "
          f"{rel}, the applied puts {held} (cap {PUT_CAP} of the largest), "
          f"rows after the run {rows} apart, {rows_rel} of their move "
          f"(bound {ROWS_REL}), PS counters "
          f"equal {per[0]['ps'] == one['ps']}, launches "
          f"{per[0]['ps_launches']} / {one['ps_launches']}, frames "
          f"{per[0]['frames']} / {one['frames']}")
    for r, g in enumerate(per):
        want = {"unique_bag": steps, "fused_backward":
                (2 if r == 0 else 1) * N_TABLES * steps}
        check(all(g["launches"][k] == v for k, v in want.items()),
              f"mesh remote rank {r}: launches {g['launches']}, want {want}")
        for k in launches:
            launches[k] += g["launches"][k]
        for k in served:
            served[k] += g["tables"][k]
    out["remote"] = {
        "ps_processes": len(one["ps_launches"]),
        "dense_tables": one["dense_tables"], "lru_tables": one["lru_tables"],
        "steps": steps, "applied_puts": applied,
        "losses": per[0]["losses"], "losses_one_process": one["losses"],
        "loss_rel": rel, "first_lookup_bit_exact": first, "puts": held,
        "put_cap": PUT_CAP, "rows_max_abs": rows, "rows_rel": rows_rel,
        "rows_moved_norm": moved, "rows_rel_bound": ROWS_REL,
        "ps_counters_equal": True, "ps_launches": per[0]["ps_launches"],
        "ps_launches_sum": sum(sum(v.values()) for v in one["ps_launches"]),
        "frames": per[0]["frames"],
        "launches_per_rank": [g["launches"] for g in per],
        "collectives_per_step": per[0]["collectives_per_step"],
        "step_ms_per_rank": [float(np.median(g["step_ms"])) for g in per],
        "step_ms_one_process": float(np.median(one["step_ms"])),
        "s_per_rank": [g["s"] for g in per], "s_one_process": one["s"]}
    return out


def mesh_lm_check(gl: list, launches: dict) -> dict:
    """Every rank's LM record held (see :func:`mesh_lm_train` and
    :func:`mesh_lm_serve`); the main paths' launches summed over the ranks
    into ``launches``. Per rank: the attention and put launches and the
    collectives a step, by kind and bytes. A step is held while every MoE
    call up to it routed as the reference's; every run holds at least its
    first step."""
    out = {"per_rank": []}
    keys = ("granite_train", "granite_train_zero2", "moe_train_psum",
            "moe_train_a2a")
    for key in keys:
        per = [g["lm"][key] for g in gl]
        for g in per:
            for k, v in g["launches"].items():
                launches[k] += v
            check(np.isfinite(g["losses"]).all(),
                  f"mesh lm {key}: losses {g['losses']}")
            check(g["launches"]["flash_attention_fwd"] > 0
                  and g["launches"]["fused_backward"] == g["steps"],
                  f"mesh lm {key}: launches {g['launches']}")
            check(g["losses_ok"] and g["ok"] and g["table_ok"],
                  f"mesh lm {key}: losses {g['losses']} against "
                  f"{g['losses_one_process']} (held steps "
                  f"{g['held_steps']}), dense rel {g['dense_update_rel']} "
                  f"max {g['dense_max_abs']}, table {g['table_max_abs']}")
        # granite routes nothing: its first tau + 1 = 2 steps' dense
        # blocks and every step's loss are held. A MoE run's first step
        # starts from the same state on both sides and must route alike.
        if key.startswith("granite_train"):
            check(all(g["held_steps"] == 2 and g["loss_steps_held"]
                      == g["steps"] for g in per),
                  f"mesh lm {key}: held steps "
                  f"{[g['held_steps'] for g in per]}, losses held "
                  f"{[g['loss_steps_held'] for g in per]}")
        else:
            check(all(g["held_steps"] >= 1 for g in per),
                  f"mesh lm {key}: the first step routed otherwise than "
                  f"one process; choices that differ a step, per rank: "
                  f"{[g['routing_diff'] for g in per]}")
        out[key] = {
            "held_steps": [g["held_steps"] for g in per],
            "loss_steps_held": [g["loss_steps_held"] for g in per],
            "routing_diff": [g["routing_diff"] for g in per],
            "losses": per[0]["losses"],
            "losses_one_process": per[0]["losses_one_process"],
            "moe_drop_frac": per[0]["moe_drop_frac"],
            "dense_update_rel": max(g["dense_update_rel"] for g in per),
            "dense_max_abs": max(g["dense_max_abs"] for g in per),
            "routed_alike": [g["routed_alike"] for g in per],
            "per_step_rel": [max(g["per_step"][i]["dense_update_rel"]
                                 for g in per)
                             for i in range(per[0]["steps"])],
            "table_max_abs": max(g["table_max_abs"] for g in per),
            "table_shared_max_abs": max(g["table_shared_max_abs"]
                                        for g in per),
            "unshared_row_share": per[0]["unshared_row_share"],
            "dense_bytes_per_rank": per[0]["dense_bytes_per_rank"],
            "moment_bytes_per_rank": per[0]["moment_bytes_per_rank"],
            "step_ms_per_rank": [float(np.median(g["step_ms"][1:]))
                                 for g in per],
            "launches_per_rank": per[0]["launches"],
            "collectives_per_step": per[0]["collectives_per_step"]}
    for key in ("granite_train", "granite_train_zero2"):
        check(gl[0]["lm"][key]["launches"]["flash_attention_fwd"]
              == 2 * MESH_LM["layers"] * MESH_LM["steps"],
              f"mesh lm {key}: not every attention (forward and remat "
              "recompute) went through the kernel")
    # ZeRO stage 2: no per-layer gather of the tensor-parallel weights
    gathers = {k: [g["lm"][k]["collectives_per_step"]["all-gather"]["calls"]
                   for g in gl]
               for k in ("granite_train", "granite_train_zero2")}
    check(all(z2 < z3 for z2, z3 in zip(gathers["granite_train_zero2"],
                                        gathers["granite_train"])),
          f"mesh lm: all-gathers a step at ZeRO 2 {gathers}")
    out["all_gathers_per_step"] = gathers
    sv = [g["lm"]["granite_serve"] for g in gl]
    for g in sv:
        for k, v in g["launches"].items():
            launches[k] += v
        check(all(g["held_by_step"]) and g["tokens_off_beyond_gap"] == 0
              and g["launches"]["flash_attention_fwd"] == MESH_LM["layers"],
              f"mesh lm serve: {g}")
    out["granite_serve"] = {
        "logit_max_abs": max(max(g["logit_max_abs_by_step"]) for g in sv),
        "gemm_only_max_abs": max(max(g["gemm_only_max_abs_by_step"])
                                 for g in sv),
        "prefill_max_abs": max(g["prefill_max_abs"] for g in sv),
        "plain_class_steps": [sum(g["plain_class_by_step"]) for g in sv],
        "steps": len(sv[0]["plain_class_by_step"]),
        "tokens_equal": all(g["tokens_equal"] for g in sv),
        "tokens_within_gap": sum(g["tokens_within_gap"] for g in sv),
        "serve_s_per_rank": [g["serve_s"] for g in sv],
        "cache_span": sv[0]["cache_span"]}
    for g in gl:
        out["per_rank"].append({
            "rank": g["rank"],
            **{key: {"attention_launches":
                     g["lm"][key]["launches"]["flash_attention_fwd"],
                     "fused_backward_launches":
                     g["lm"][key]["launches"]["fused_backward"],
                     "collectives_per_step":
                     g["lm"][key]["collectives_per_step"]}
               for key in keys}})
    out["part_s"] = {k: max(g["lm"]["part_s"][k] for g in gl)
                     for k in gl[0]["lm"]["part_s"]}
    out["granite_cost_rank0"] = gl[0]["lm"]["granite_cost"]
    out["granite_cost_zero2_rank0"] = gl[0]["lm"]["granite_cost_zero2"]
    return out


DRYRUN_CODE = """
import json, sys
import torch
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun as DR
from repro_torch.sharding import partition as SP
torch.set_num_threads(1)            # as the CLI does
rows = [DR.run_case("granite_3_2b", s, verbose=False)
        for s in ("train_4k", "prefill_32k", "decode_32k")]
cut = get_config("granite_3_2b").replace(pattern_repeats=%(layers)d)
for stage in (3, 2):
    with SP.zero_stage(stage):
        rows.append(DR.run_case(
            "granite_3_2b", "train_4k", cfg=cut,
            shape=InputShape("mesh_train", %(seq)d, %(batch)d, "training"),
            mesh_shape=(%(shape)r, %(axes)r), verbose=False, seed=%(seed)d))
print("ROWS" + json.dumps(rows))
"""


def dryrun_start():
    """The dry run in a process of its own, on the CPU, started before the
    LM training phases and read after the mesh phase: granite-3-2b's
    train_4k, prefill_32k and decode_32k rows on the 16 x 16 mesh (a
    world of 256 on torch.distributed's fake backend, the meta device),
    and the mesh phase's granite cut and train shape at mesh (2, 2)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = DRYRUN_CODE % {"layers": MESH_LM["layers"], "seq": MESH_LM["seq"],
                          "batch": MESH_LM["batch"], "shape": MESH_SHAPE,
                          "axes": MESH_AXES, "seed": MESH_SEED}
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), \
        time.perf_counter()


def dryrun_phase(started, mesh_rec) -> dict:
    """The dry run's rows: every one ``ok``; the (2, 2) rows' FLOPs,
    collective counts and bytes and argument bytes equal to what rank 0
    of the mesh phase counted around one more granite step on the card
    (``launch.op_cost``) at ZeRO stages 3 and 2, their HBM bytes within 1%
    (the ops whose bytes differ recorded); the stage-2 row's all-gathers
    those of a stage-2 step of the mesh's granite run."""
    proc, t0 = started
    try:
        log = proc.communicate(timeout=900)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    line = [ln for ln in log.splitlines() if ln.startswith("ROWS")]
    check(proc.returncode == 0 and bool(line),
          f"dryrun: exited {proc.returncode}:\n{log[-3000:]}")
    rows = json.loads(line[0][4:])
    for r in rows:
        check(r["status"] == "ok", f"dryrun {r['shape']}: {r.get('error')}")
    rec = {"phase": "dryrun", "seconds": time.perf_counter() - t0,
           "rows": [{k: r[k] for k in (
               "arch", "shape", "mesh", "note", "dtype", "zero_stage",
               "trace_s", "argument_bytes_per_device",
               "temp_bytes_per_device", "peak_bytes_per_device",
               "flops_per_device", "hbm_bytes_per_device", "collectives",
               "compute_s", "memory_s", "collective_s", "dominant",
               "model_flops", "useful_flops_frac", "kernels")}
               for r in rows],
           "hardware": rows[0]["hardware"]}
    lm = mesh_rec["lm"]
    for key, dry, real in (
            ("card_vs_dry_2x2", rows[-2], lm["granite_cost_rank0"]),
            ("card_vs_dry_2x2_zero2", rows[-1],
             lm["granite_cost_zero2_rank0"])):
        gap = {k: [v, dry["hbm_bytes_by_op"].get(k, 0)]
               for k, v in real["hbm_bytes_by_op"].items()
               if dry["hbm_bytes_by_op"].get(k, 0) != v}
        gap.update({k: [0, v] for k, v in dry["hbm_bytes_by_op"].items()
                    if k not in real["hbm_bytes_by_op"]})
        hbm_rel = abs(real["hbm_bytes_per_device"]
                      - dry["hbm_bytes_per_device"]) \
            / dry["hbm_bytes_per_device"]
        rec[key] = {
            "zero_stage": dry["zero_stage"],
            "flops_equal": real["flops_per_device"]
            == dry["flops_per_device"],
            "collectives_equal": real["collectives"] == dry["collectives"],
            "argument_bytes_equal": real["argument_bytes_per_device"]
            == dry["argument_bytes_per_device"],
            "kernels_equal": real["kernels"] == dry["kernels"],
            "hbm_rel": hbm_rel, "hbm_gap_by_op": gap,
            "card": {k: real[k] for k in (
                "flops_per_device", "hbm_bytes_per_device", "collectives",
                "argument_bytes_per_device", "kernels")},
            "dry": {k: dry[k] for k in (
                "flops_per_device", "hbm_bytes_per_device", "collectives",
                "argument_bytes_per_device", "kernels")}}
    z2 = rows[-1]["collectives"]["counts"]["all-gather"]
    ran = lm["all_gathers_per_step"]["granite_train_zero2"]
    rec["zero2_all_gathers"] = {"dry": z2, "run_per_rank": ran,
                                "stage3_dry": rows[-2]["collectives"][
                                    "counts"]["all-gather"]}
    emit(rec)
    for key in ("card_vs_dry_2x2", "card_vs_dry_2x2_zero2"):
        c = rec[key]
        check(c["flops_equal"] and c["collectives_equal"]
              and c["argument_bytes_equal"] and c["kernels_equal"]
              and c["hbm_rel"] <= 0.01, f"dryrun {key} against the card: {c}")
    check(all(r == z2 for r in ran) and z2 < rec["zero2_all_gathers"][
        "stage3_dry"], f"dryrun: all-gathers at ZeRO 2 {rec['zero2_all_gathers']}")
    return rec


def launcher_phase(dev):
    """``repro_torch.launch.train.main`` on the card: 8 steps of the
    default taobao_ad CTR model with ``--pipeline pipelined``, eval every
    4, two finite eval lines and the engine's metrics in its record; then
    the LM task (the launcher's lm-100m, ``--steps 8 --batch 8 --seq-len
    128 --eval-every 4``), two finite loss lines."""
    from repro_torch.launch import train as launch_train
    path = ROOT / "chiprun_out" / "train_launcher.json"
    path.parent.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    hist = launch_train.main(["--device", str(dev), "--pipeline",
                              "pipelined", "--steps", "8", "--eval-every",
                              "4", "--out", str(path)])
    wall = time.perf_counter() - t0
    rec = json.loads(path.read_text())
    check(len(hist) == 2 and all(np.isfinite(h["loss"]) and
                                 np.isfinite(h["auc"]) for h in hist)
          and rec["pipeline_metrics"]["pipeline/steps"] == 4.0,
          f"launcher: history {hist}")
    lm_argv = ["--task", "lm", "--steps", "8", "--batch", "8", "--seq-len",
               "128", "--eval-every", "4"]
    t0 = time.perf_counter()
    lm_hist = launch_train.main(["--device", str(dev), *lm_argv])
    lm_wall = time.perf_counter() - t0
    check(len(lm_hist) == 2 and all(np.isfinite(h["loss"])
                                    for h in lm_hist),
          f"launcher --task lm: history {lm_hist}")
    out = {"phase": "train_launcher", "argv": "--pipeline pipelined "
           "--steps 8 --eval-every 4", "wall_s": wall, "history": hist,
           "device": rec["device"], "lm_argv": " ".join(lm_argv),
           "lm_wall_s": lm_wall, "lm_history": lm_hist}
    emit(out)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this check runs on a GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    print(card, flush=True)

    t0 = time.perf_counter()
    libs = build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for p in libs.values()
             for ln in p.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": build_s,
          "libraries": [p.name for p in libs.values()], "ptxas": ptxas})

    ds = CTR_BENCHMARKS["kwai_video"]
    rng = np.random.default_rng(SEED)
    timing = kernel_phase(dev, rng, ds)
    timing["fused_backward"] = fused_backward_phase(dev, ds)
    timing.update(blockscale_phase(dev, ds))
    timing["embedding_sgd"] = sgd_phase(dev, ds)
    timing["flash_attention_fwd"] = flash_phase(dev)
    timing["flash_attention_fwd"].update(
        {f"{shape}_{k}": timing["flash_attention_fwd"][shape][k]
         for shape in FLASH_SHAPES
         for k in ("ms", "bound_ms", "bound_by", "plain_ms", "library_ms",
                   "library_backend")})
    floor = floor_phase(dev)
    emit({"phase": "kernels", "shape": {"B": B, "L": L, "D": DIM, "V": V,
                                        "tables": N_TABLES,
                                        "train_batch": TRAIN_B},
          "bit_exact": [k for k in KERNELS if k != "flash_attention_fwd"],
          "allclose": ["flash_attention_fwd"], "launch_floor_ms": floor,
          "per_call_ms": timing})
    # each path's launch counts, read around its own run
    paths, recs = {}, {}
    paths["serve"], recs["serve"] = serve_phase(dev)
    emit(recs["serve"])
    paths["serve_wire"], recs["serve_wire"] = serve_phase(dev, WIRE)
    emit(recs["serve_wire"])
    paths["train"], recs["train"] = train_phase(dev)
    emit(recs["train"])
    paths["train_wire"], recs["train_wire"] = train_phase(
        dev, WIRE, WIRE_STEPS["timed"], WIRE_STEPS["breakdown"],
        WIRE_STEPS["profiled"], WIRE_STEPS["modes"])
    emit(recs["train_wire"])
    paths["train_flat"], recs["train_flat"] = flat_train_phase(dev)
    emit(recs["train_flat"])
    paths["sgd_entry"], recs["sgd_entry"] = sgd_entry_path(dev)
    emit(recs["sgd_entry"])
    paths["lm_serve"], recs["lm_serve"] = lm_serve_phase(dev)
    emit(recs["lm_serve"])
    recs["lm_serve"]["card_vs_cpu"] = lm_card_vs_cpu(dev)
    paths["lm_moe_serve"], recs["lm_moe_serve"] = lm_moe_serve_phase(dev)
    emit(recs["lm_moe_serve"])
    recs["lm_moe_serve"]["card_vs_cpu"] = lm_moe_card_vs_cpu(dev)
    # the out-of-core tier
    paths["train_host_lru"], recs["train_host_lru"], (tr, st) = \
        train_host_lru_phase(dev)
    emit(recs["train_host_lru"])
    paths["serve_host_lru"], recs["serve_host_lru"] = serve_host_lru_phase(
        dev, tr, st)
    emit(recs["serve_host_lru"])
    recs["train_host_lru"]["card_vs_cpu"] = lru_card_vs_cpu(dev, tr, st)
    del tr, st
    torch.cuda.empty_cache()
    paths["train_host_lru_disk"], paths["train_host_lru_wire"], \
        recs["train_host_lru_tiers"] = lru_tiers_phase(dev)
    paths["lm_serve_host_lru"], recs["lm_serve_host_lru"] = \
        lm_serve_host_lru_phase(dev)
    emit(recs["lm_serve_host_lru"])
    # the pipelined trainer, and the launcher that drives it
    paths["train_pipelined"], recs["train_pipelined"] = pipeline_phase(
        dev, "dense")
    paths["train_pipelined_host_lru"], recs["train_pipelined_host_lru"] = \
        pipeline_phase(dev, HOST_LRU)
    # the in-process online loop and LM training
    paths["online"], recs["online"] = online_phase(dev)
    emit(recs["online"])
    # the dry run on the CPU from here on, beside the device-bound LM
    # phases (beside the mesh phase it would take a core from its ranks)
    dry = dryrun_start()
    paths["lm_train"], recs["lm_train"] = lm_train_phase(dev)
    timing["fused_backward"].update(
        {f"lm_put_{k}": recs["lm_train"]["lm_put"][k]
         for k in ("ms", "bound_ms", "bound_by", "plain_ms")})
    # DeepSeek-V2 training, then Mamba-2 and the Jamba hybrid serving
    paths["lm_moe_train"], recs["lm_moe_train"] = lm_moe_train_phase(dev)
    paths["ssm_serve"], recs["ssm_serve"] = ssm_serve_phase(dev)
    paths["hybrid_serve"], recs["hybrid_serve"] = hybrid_serve_phase(dev)
    # whisper-medium (encoder-decoder) serving and training, the vision
    # model's gated cross-attention, granite with a window and a cap
    paths["encdec_serve"], recs["encdec_serve"] = encdec_serve_phase(dev)
    paths["vlm_serve"], recs["vlm_serve"] = vlm_serve_phase(dev)
    paths["encdec_train"], recs["encdec_train"] = encdec_train_phase(dev)
    timing["fused_backward"].update(
        {f"lm_put_1024_{k}": recs["encdec_train"]["lm_put"][k]
         for k in ("ms", "bound_ms", "bound_by", "plain_ms")})
    recs["granite_cuts"] = granite_cuts_phase(dev)
    # the mesh paths: SPMD worlds of worker processes on the one card, run
    # beside this process's checks that read no rate (the card against
    # the CPU, the PS's bit checks and kill drill); the phases that time
    # steps follow once the worlds are done
    mesh = mesh_start()
    try:
        recs["train"]["card_vs_cpu"] = card_vs_cpu(dev, ds)
        recs["train_wire"]["card_vs_cpu"] = card_vs_cpu(
            dev, ds, WIRE, ((TrainMode.sync(), 2),
                            (TrainMode.hybrid(TAU), 4)))
        router_cpu = router_card_vs_cpu(dev, ds, SHARD_STEPS["cpu"])
        remote_paths, remote_recs = remote_checks(dev)
        remote_ref = remote_reference(dev, mesh)
    except BaseException:
        mesh_stop(mesh)
        raise
    paths.update(remote_paths)
    mesh_paths, recs["mesh"] = mesh_phase(mesh, remote_ref)
    paths.update(mesh_paths)
    # the sharded embedding-PS router, and the multi-process embedding PS
    sharded_paths, recs["sharded"] = sharded_phase(dev, router_cpu)
    paths.update(sharded_paths)
    recs["remote"] = remote_phase(dev, recs["sharded"], remote_recs)
    recs["dryrun"] = dryrun_phase(dry, recs["mesh"])
    recs["train_launcher"] = launcher_phase(dev)

    kernels = []
    for name, meta in KERNELS.items():
        t = timing[name]
        by_path = {p: launches[name] for p, (launches, _) in paths.items()}
        grouped = {}
        if name in ops.table_counts():
            # the tables each function served on the main paths (the bag
            # kernel's launches count once, on one of its two functions)
            tables = {p: served[name] for p, (_, served) in paths.items()}
            grouped = {"tables": sum(tables.values()),
                       "tables_by_path": tables}
            check(grouped["tables"] > 0, f"{name} served no table")
        kernels.append({
            "name": name, "route": "cuda", **meta,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            **grouped, "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            # the grouped kernels: one launch for a stage's 32 tables
            **{k: t[k] for k in STAGE_KEYS + SHAPE_KEYS if k in t}})
        check(kernels[-1]["launches"] > 0, f"{name} was never launched")
    emit({"phase": "timeline", "at_s": TIMELINE})
    record = {"card": card, "build_s": build_s, "ptxas": ptxas,
              "kernel_timing": timing, "launch_floor_ms": floor, **recs,
              "kernels": kernels, "timeline": TIMELINE}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:
        sys.exit(mesh_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                             sys.argv[5]))
    sys.exit(main())
