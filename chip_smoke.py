"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build the eight CUDA kernels from ``src/repro_torch/kernels/csrc``;
2. hold each kernel against its plain PyTorch version at the main path's
   shapes: the integer outputs exactly (the radix pass as the scatter of
   perm and words, three CUDA launches, and as ranks); the groupby
   accumulate's sums within 1e-6 of the group's sum of magnitudes and its
   mins and maxs as values (NaN == NaN, -0.0 == +0.0); the join probe past
   32 key planes and past a block's shared memory; the groupby
   accumulate also on B 512, C 7000 slabs, whose workspace the wrapper
   allocates in device memory, checked and timed;
3. the paper's Fig. 4 join with the sortmerge backend, 10 M rows per
   side at world 1, checked against the keys and a float64 sum;
4. the same join with the hash backend at 500 k rows per side, which
   must be bit-identical to a sortmerge run on the same data;
5. Table 5 GroupBy + Aggregate, 10 M rows over 1 M keys: ``dist_groupby``
   with the hash backend (65536 buckets) equal to numpy and bit-identical
   to the sort backend;
6. Unique: ``dist_unique`` hash == sort on the same table;
7. OrderBy: ``dist_sort`` over (k, v), 10 M rows, radix == xla == a
   numpy stable sort;
8. the broadcast join, 1 M x 100 k rows, bit-identical to the shuffle
   join;
9. the UNOMT data-engineering pipeline (paper Figs. 8-11), 10 M response
   rows, 65536 drugs, 1024 cells: ``unomt_dist_pipeline`` with the
   sortmerge and the hash membership backends, bit-identical to each
   other, equal to an independent numpy pipeline and dropping nothing;
   the hash run launches ``hash_semi`` twice (the drug and cell filters);
   then ``feature_label_arrays``;
10. the set operators, 10 M x 5 M rows: ``dist_isin``,
   ``dist_intersect`` and ``dist_difference`` under both membership
   backends, equal to each other and to numpy; then the slabs the
   UNOMT and set-op hash runs gave ``hash_semi`` (all five of its
   launches) are held against the plain version, with float planes and
   a slab past a block's shared memory;
10b. out-of-core morsels (``core/morsel.py``) on
   ``benchmarks/bench_outofcore.py``'s data: a 10 M-row probe side over
   1 M keys against a 1 M-row build side with one row per key.  The
   resident-build join in 1 M-row morsels (sort-merge, and again from
   ``np.memmap`` files), in 500 k-row morsels under the hash join (its
   slabs planned on one morsel), and re-streamed (1 M x 1 M rows in
   250 k morsels, 16 joins), each streamed into a sink that checks every
   row's rv and the sums; the chunked groupby (hash and sort) against
   numpy; the chunked sort in 1 M morsels under the radix sort against
   numpy's stable order, its host merge timed apart.  Launches pinned
   (``OC_LAUNCHES``); each leg's peak device memory is printed beside the
   monolithic Fig. 4 sortmerge leg's;
10c. UNOMT stage 4: the drug-response net at the reference's widths
   (1024 hidden, 3 blocks, tail 2, dropout 0.1, weights from
   ``torch.Generator`` seed 0) trained for 100 DDP steps of 32 768 rows
   of the UNOMT leg's features, exact and int8-compressed, at world 1;
   the loss must fall in both; one step on the card against the port on
   the CPU and a float64 evaluation (``TRAIN_*``); step time, samples/s,
   peak memory and a profile of one step (GEMMs against the rest);
10d. LM training (``lm_train``): lm100m at its full width and depth
   (12 layers, d_model 768, 138.4 M parameters, tied embeddings), float32
   masters from ``torch.Generator`` seed 0, ``AdamWConfig(lr=3e-4,
   total_steps=50)``, remat ``full``: 50 steps on 8 x 512 batches of
   ``lm_batch_at`` in order (their losses printed), then 20 on the next
   batch repeated, whose loss must fall; the first step on 2 x 512
   tokens held to the same step of the port on the CPU (loss within
   2e-3, grad norm within 2e-2 relative); step ms by CUDA events (median
   of the last 40 in order), tokens/s, peak memory, one profiled step
   (GEMMs against the rest) and one asynchronous checkpoint of the
   1.66 GB state, timed;
10e. the LM restart drill (``lm_drill``): ``launch.train.main`` on the
   same config, 40 steps of ``lm_batch_at`` batches in order, a
   checkpoint every 20, once plainly and once with ``--fail-at 23``; the
   restarted run's last checkpoint (every parameter and AdamW moment)
   must equal the plain run's bit for bit, and its records the plain
   run's;
10f. the UNOMT restart drill (``unomt_drill``):
   ``launch.unomt_e2e.train_stage`` on the UNOMT leg's features, 100
   steps of 32 768 rows, a checkpoint every 25, a failure at step 50,
   bit-identical to the plain run; then the checkpoint write of its
   state, host copy and thread timed apart;
10g. Mamba training (``mamba_train``): Falcon-Mamba-7B at full width (d_model
   4096, E 8192, N 16, dt_rank 256, vocab 65024), 2 of its 64 layers
   (all 64 need ~116 GB of float32 masters, gradients and moments):
   5 steps on one 1 x 1000 batch, one microbatch, through the chunked
   scan's forward and backward (the last chunk 104 steps);
   the loss must fall, the first step's held to the port on the CPU
   within 2e-3; step ms, peak memory.  No kernel runs in these four;
11. the LM serving path: Granite-3.0-2B at its published widths, 10 of
   its 40 layers (``SERVE_LAYERS``), random weights from ``torch.Generator`` seed 0, served by
   ``ServingEngine`` (8 slots, prompts up to 1024 tokens, up to 64
   generated) with both UNOMT feature stores; 32 requests; the flash
   kernel runs in every layer of every prefill.  Checked: the accounting
   identity, tokens and features of every request, nothing dropped, exact
   launch counts, two requests against the one-shot prefill/decode loop
   (fed the engine's tokens) and the first XLA_TWIN_REQUESTS (8)
   requests against the same engine on the plain ``xla`` attention
   path, within ``SERVE_LOGIT_TOL``; then
   ``flash_attention`` against ``attention_ref`` on the q, k, v one
   prefill gave it and on six more shapes; tokens/s, TTFT, prefill and
   decode-step times and a profile of one prefill and 8 decode steps;
11b. the Mamba serving path: Falcon-Mamba-7B at its published widths, 8
   of its 64 layers (SERVE_LAYERS), random weights from ``torch.Generator`` seed 0,
   the same engine settings and request stream as phase 11 (the Granite
   weights freed first); every prefill runs at the prompt's true length
   and the selective-scan kernel in every layer.  Checked: the
   accounting identity, tokens and features of every request, nothing
   dropped, exact launch counts (``mamba_scan`` one a layer a prefill, no
   ``flash_attention``), two requests against the one-shot loop (fed the
   engine's tokens) within ``SERVE_LOGIT_TOL``, and the same two
   requests on the plain scan: prefill logits, conv and ssm states and 8
   decode steps from each state; then ``mamba_scan`` against
   ``selective_scan_ref`` within ``SCAN_TOL`` on the inputs of the
   longest prefill's first layer and on six more shapes; tokens/s, TTFT,
   prefill and decode-step times and a profile;
11c. the MoE serving path (``serving_moe``): Granite-3.0-MoE-3B-A800M at
   its published widths, 8 of its 32 layers (d_model 1536, 24 q / 8 KV
   heads, 40 experts of 512 padded to 48, top-8; 3.9 GB of bf16
   weights), random weights from ``torch.Generator`` seed 0, the same
   engine settings, request stream and checks as phase 11 (the Mamba
   weights freed first); every MoE layer runs all 40 experts on every
   token (``moe_dense``, the reference's path at world 1).  Also checked:
   the experts resident as bf16, the routers as float32, TF32 off; the
   routing sets of the two requests held to the one-shot loop, flash
   engine against ``xla`` engine, counted with the smallest and largest
   probability gap among those that differ (printed, not held: a
   near-tie may pick another expert); then ``flash_attention`` against ``attention_ref``
   on the q, k, v its first prefill gave it, case (h) (Hq 24, Hkv 8);
11c'. the MoE serving path at world 2 (``serving_moe_tp2``): the same
   model at TP_LAYERS (2) of its 32 layers, the same engine settings,
   requests and feature stores, served by two
   rank processes on the one card through ``launch/serve.py``'s ``--mesh``
   set-up (``spawn``, ``init_rank``, ``make_mesh``, ``make_policy(mesh,
   "fsdp_tp")``; gloo, as NCCL refuses two ranks on one device, so every
   exchange is staged through host memory): each rank holds its 24 of
   the 48 padded experts, 12 q / 4 KV heads and half the vocabulary
   (3.9 GB); MoE layers run ``moe_shuffle`` in prefill (the dispatch plan
   on ``hash_partition``, n = 4096 ids at P = 40, ``C_send`` 128) and
   ``moe_decode`` in decode (n = 64 at P = 25).  Checked on each rank:
   the accounting identity, tokens and features, exact launch counts
   (``flash_attention`` and ``hash_partition`` one a layer a prefill,
   ``hash_partition`` one a layer a decode step beside the stores'
   shuffles), each rank's leaves its slices of the whole ones, the
   first request at ``capacity_factor = E / top_k`` (no row can drop)
   within ``SERVE_LOGIT_TOL`` of a world-1 engine's prefill (this
   process, before the ranks start, on the first 4 requests; its greedy
   tokens compared wherever no rank dropped a row), and the twin
   ``serving_moe_tp2_xla`` (the same engine on plain attention and plain
   ranks, the first 4 requests: prefill logits within
   ``SERVE_LOGIT_TOL``, greedy tokens by ``greedy_agree``); both ranks'
   tokens equal.  Then the first prefill's dispatch plans and the
   first decode plan held to the plain ranks bit for bit, and case (l),
   q (1, 12, 1024, 64) against KV (1, 4, 1024, 64), within ``FLASH_TOL``;
   tokens/s, TTFT, prefill and decode-step ms by CUDA events, each rank's
   weight bytes, peak memory and dropped rows by layer;
11c''. the MoE serving path at data=2 x model=2 (``serving_moe_dp2``):
   the same model at DP_LAYERS of its 32 layers, the same engine
   settings and feature stores (over all four ranks), the first
   DP_REQUESTS (16) of the requests, served
   by four rank processes on the one card through the same ``--mesh``
   set-up under ``make_policy(mesh, "fsdp_tp")``: each rank holds the
   2D slice of every matrix (a quarter of the attention and expert
   weights, half the experts' rows of its model half) and gathers each
   layer's over the data ranks just before the layer runs; the 8 slots
   split into blocks of 4, one a data rank (a slot's prefill runs on
   every rank, its cache kept by the slot's owner; a decode step runs
   each rank's block, its logits gathered over both axes).  Checked as
   ``serving_moe_tp2``, and: the four ranks' tokens equal, each rank
   holding 4 slots in its caches; the engine's tokens against a world-1
   engine on the first TP_TWIN_REQUESTS requests wherever no rank's
   prefill or step dropped a row (the drop counts by layer printed);
   the twin ``serving_moe_dp2_xla`` on plain attention and plain ranks
   at ``capacity_factor = E / top_k`` (no row drops), on the first
   DP_TWIN_REQUESTS (2) requests, against that world-1 engine: prefill
   logits within ``SERVE_LOGIT_TOL`` and greedy tokens by
   ``greedy_agree``.  Then its dispatch plans against the plain ranks
   and case (m) within ``FLASH_TOL``; its decode plan (n 32 at P 25)
   timed.  Recorded: the bytes a rank gathers a forward.  Then, in the
   same four ranks, ``serving_moe_pod2``: the same model and weights at
   pod=2 x data=2 x model=1 (``fsdp_tp``: the slots over pod x data,
   pod major, 2 a rank; each 2D leaf cut over data and gathered over it
   a layer at a time, whole over pod) on the first TP_TWIN_REQUESTS
   requests; at model=1 a MoE layer runs ``moe_dense``, as the
   reference's ``moe_apply`` does.  Checked: the accounting identity,
   tokens and features, exact launches (``flash_attention`` a layer a
   prefill, ``hash_partition`` the stores' shuffles), each rank's leaves
   its slices, the four ranks' tokens equal, every prefill's logits
   within ``SERVE_LOGIT_TOL`` of the world-1 engine's and its tokens by
   ``greedy_agree``; rank 0's first flash call, case (p), and the
   stores' first ranking held to the plain versions; prefill and
   decode-step ms by events on every rank, the bytes a rank gathers a
   forward, the peak, a rank-0 profile;
11c'''. the Mamba path at world 2, in the two rank processes of
   ``serving_moe_tp2``, after it: ``serving_mamba_tp2`` serves
   Falcon-Mamba-7B at full width and SERVE_LAYERS' depth (8), the
   ``serving_mamba`` weights (seed 0), engine settings, requests and
   feature stores (over both ranks) under ``make_policy(mesh,
   "fsdp_tp")`` at data=1 x model=2: each rank holds the 4096 channels of
   its half of E (``in_proj``'s x and z columns of them, the conv, the
   scan's parameters, ``x_proj`` and ``out_proj``'s rows) and their
   conv and ssm states; every prefill layer runs ``mamba_scan`` on the
   rank's channels.  Checked on each rank: the accounting identity,
   tokens and features, exact launch counts (``mamba_scan`` one a layer
   a prefill, ``hash_partition`` the stores' shuffles, nothing else),
   each rank's leaves its slices of the whole ones (``in_proj`` by its
   per-part rule), caches ssm (8, 8, 4096, 16) and conv (8, 8, 3,
   4096); against ``serving_mamba``'s own record of its first
   TP_TWIN_REQUESTS requests (world 1, the same process's earlier leg):
   the first request's prefill logits within ``SERVE_LOGIT_TOL``, its
   prefill's ssm states, gathered over the two ranks, within
   ``MAMBA_STATE_TOL`` of their largest, greedy tokens by
   ``greedy_agree``; the twin ``serving_mamba_tp2_xla`` (the plain scan,
   the first TP_TWIN_REQUESTS requests) against the engine run; both
   ranks' tokens equal.  Then rank 0's first prefill's first scan call
   (x and delta (1, S, 4096), N 16, with hT) becomes ``mamba_scan`` case
   (j), held to the plain scan within ``SCAN_TOL`` and timed.
   ``mamba_train_tp2``: ``mamba_train``'s config and seed-0 masters at
   data=1 x model=2 under ``tp``, MAMBA_TP_TRAIN_STEPS (2) steps on its
   first 1 x 1000 batch; the first step's loss and grad norm within
   2e-3 and 2e-2 of ``mamba_train``'s first step (the mesh tests'
   tolerances against world 1).  Prefill and decode-step ms, tokens/s,
   TTFT, step ms, each rank's weight bytes and peak, a profile;
11d. MoE training (``moe_train``): Granite-3.0-MoE at full width,
   16 of its 32 layers (float32 masters, gradients and AdamW moments
   take 1.91 GB a layer; AdamW writes its new state in place), remat
   full, 5
   steps on one 4 x 1024 batch repeated, whose loss must fall; the first
   step of ``MOE_CHECK_LAYERS`` layers on 1 x 128 tokens held to the port
   on the CPU (loss and ``moe_aux`` within 2e-3); step ms, tokens/s,
   peak memory beside that of one step that keeps the old state (as
   every step did before AdamW could write in place) and a profile.  No
   kernel runs here;
11d'. MoE training at data=2 x model=2 (``moe_train_mesh``): four rank
   processes on the one card (gloo: every exchange staged through pinned
   host memory), each with ``launch/train.py``'s ``--mesh`` set-up and
   the config's ``tp`` policy.  First, at 2 layers, full width, 1 x 1024
   rows a data rank and capacity factor E / top_k (no row drops): one
   step under ``tp`` and one under ``fsdp_tp``, gathered whole on rank 0,
   held by the leaf rule of ``tests/test_torch_lm_train.py`` (loss,
   moe_aux and grad norm beside it) to the port's world-1 step on the
   same weights and batch, in one microbatch per data rank and with its
   MoE layers pinned to the sharded step's routes, and ``fsdp_tp`` to
   ``tp``.  Then MESH_TRAIN_LAYERS (4) layers, capacity 1.25, MESH_TRAIN_STEPS (2) steps on
   one 4 x 1024 batch repeated: the loss must fall on every rank alike;
   ``hash_partition`` launched exactly twice per MoE layer and step on
   each rank (the plan and its recompute, n 8192 at P 40); the first
   step's 16 plans of rank 0 held to the plain ranks and its dropped
   rows to theirs; step ms, tokens/s, each rank's bytes and peak, one
   profiled step.  Times at world 4 on one card measure gloo's host
   staging, not parallelism across cards.  Then, in the same ranks,
   ``moe_train_pod2``: 2 layers at pod=2 x data=2 x model=1 under
   ``fsdp_tp`` (the moments cut over data only), one row of 1024 tokens
   a batch rank, its first step held on rank 0 by the leaf rule (loss,
   ``moe_aux``, grad norm beside it) to a world-1 step in one
   microbatch a row with the ranks' routes and the whole batch's aux;
   then one step timed; step ms, master and moment bytes a rank, the
   peak; no kernel launched;
11d''. the restart drill at data=2 x model=2 (``lm_drill_mesh``):
   ``launch.train.main --mesh data=2,model=2`` on lm100m at full size,
   DRILL_MESH_STEPS (4) steps of 2 x 512 tokens in order, a checkpoint
   every 2, plainly and with a failure at step 3 (the restart resumes
   from step 2's trained state, each rank its slices of it);
   bit-identical, no kernel launched in any rank, and the last
   checkpoint (whole leaves) restores at world 1 in this process to the
   same bits;
11e. the enc-dec and vision stacks (``serving_seamless``,
   ``serving_internvl``; with ``seamless_train`` run after phase 11c and
   before ``serving_moe_tp2``'s ranks start, each writing the record
   that phase 11g holds its leg at world 2 to): SeamlessM4T-Large-v2
   (24 encoder and 24
   decoder layers, d_model 1024, 16 heads, gelu MLP 8192, vocab 256206
   padded to 256256, untied; 1.63 B parameters) and InternVL2-2B (24
   layers, d_model 2048, 16 q / 8 KV heads of 128, vocab 92553; 1.89 B)
   at their published widths and depth, random weights from
   ``torch.Generator`` seed 0, served through ``make_prefill`` +
   ``make_serve_step`` (the reference's entry points for these
   families; its engine serves decoder-only configs): 3 one-shot
   batches of 8 requests of 1024 tokens with 256 float frames (Seamless)
   or 256 float patch embeddings in front (InternVL; its decode starts
   at position 1280), from ``default_rng(0)``, 32 greedy tokens each.
   Checked: ``flash_attention`` exactly 72 (encoder, decoder self,
   cross) or 24 launches a prefill, finite logits, the first batch on
   the plain ``xla`` path (prefill logits within ``SERVE_LOGIT_TOL``,
   greedy tokens equal up to the first difference at a margin below
   it), one request's decode-step logits against the full forward at
   the same positions (teacher forcing) within ``SERVE_LOGIT_TOL``;
   tokens/s, prefill and decode-step ms, peak memory, a profile (the
   Seamless prefill by encoder, cross-attention and flash); then
   ``flash_attention`` against ``attention_ref`` on the q, k, v the
   first prefills gave it: (i) the encoder's self-attention, (j) the
   decoder's cross-attention (Sq 1024 > Skv 256, not causal), (k)
   InternVL's causal GQA at D 128 over 1280 positions;
11f. training both (``seamless_train``, ``internvl_train``) at full
   width and depth from float32 masters (seed 0), AdamW, remat full: 3
   steps on one 2 x 1024 batch of ``lm_batch_at(0)`` with its frames
   or patch embeddings, repeated, whose loss must fall; step ms, peak
   memory, a profile.  No kernel runs here;
11g. the enc-dec and vision stacks at world 2, in ``serving_moe_tp2``'s
   two rank processes after the Mamba legs (``ENCDEC_TP_LEGS``), each
   rank under ``make_policy(mesh, "fsdp_tp")`` at data=1 x model=2
   holding its slices of the seed-0 weights: ``serving_seamless_tp2``
   (SeamlessM4T at full width and depth: 8 of the 16 heads of every
   attention, the encoder's, the decoder's and the cross-attention's,
   half the gelu MLP and of the vocabulary; 1.63 GB) and
   ``serving_internvl_tp2`` (InternVL2-2B: 8 q / 4 KV heads, half the
   SwiGLU MLP; 1.89 GB) each serve ``serving_seamless``'s /
   ``serving_internvl``'s first batch (8 x 1024 tokens with their frames
   or patch embeddings) through ``make_prefill`` + ``make_serve_step``,
   ONESHOT_TP_GEN (8) greedy tokens.  Checked on each rank:
   ``flash_attention`` exactly 72 or 24 launches a prefill and nothing
   else, each leaf the rank's slice, caches k / v (24, 8, 8, 1032, 64)
   and ck / cv (24, 8, 8, 256, 64) (Seamless) or k / v (24, 8, 4, 1288,
   128) (InternVL2); against the world-1 leg's record (phases 11e and
   11f run before these ranks start and write it): the prefill logits
   within ``SERVE_LOGIT_TOL``, row 0's ck / cv (Seamless) or prefilled
   k / v (InternVL2) of the first and last layer, gathered over the two
   ranks, within ``CACHE_TOL`` of each layer's largest or twice what
   plain attention moved them at world 1, greedy tokens by
   ``greedy_agree``; the twin ``<leg>_xla``, the same
   prefill on plain attention, its logits within ``SERVE_LOGIT_TOL`` of
   the kernel run's; both ranks' tokens equal.
   ``seamless_train_tp2``: ``seamless_train``'s config and seed-0
   masters under ``tp``, SEAMLESS_TP_TRAIN_STEPS (1) step on its 2 x
   1024 batch with frames; the first step's loss and grad norm within
   2e-3 and 2e-2 of ``seamless_train``'s first step; both ranks' losses
   equal.  Then rank 0's first InternVL2 flash call, case (n) (q (8, 8,
   1280, 128) on 4 KV heads), and first Seamless cross-attention call,
   case (o) (q (8, 8, 1024, 64), kv (8, 8, 256, 64)), held to
   ``attention_ref`` within ``FLASH_TOL`` and timed beside SDPA.  Prefill
   and decode-step ms, tokens/s, step ms, each rank's weight bytes and
   peak, a profile;
11h. the hybrid period stack (``serving_jamba``), after phase 11c: one
   whole period of Jamba-1.5-Large at its published widths (8 layers: 7
   Mamba layers, attention at layer 7 with 64 q / 8 KV heads of 128,
   MoE on layers 1, 3, 5, 7, dense MLP on 0, 2, 4, 6; d_model 8192, E
   16384, d_ff and d_expert_ff 24576, vocab 65536), its experts cut from
   16 to JAMBA_EXPERTS (8), top-2, for memory (the bf16 bytes of both,
   90.48 and 51.82 GB, printed with the weights resident and the peak),
   random weights from ``torch.Generator`` seed 0 (the earlier legs'
   freed first), phase 11's engine settings and stores; the first
   JAMBA_REQUESTS (8) requests with up to JAMBA_GEN (32) tokens each.
   Every prefill runs at the prompt's true length, ``mamba_scan`` in
   each of its 7 Mamba layers and ``flash_attention`` (GQA 8:1, D 128)
   in its attention layer; its MoE layers run ``moe_dense``.  Checked:
   the accounting identity, tokens and features, nothing dropped, exact
   launch counts, two requests against the one-shot loop (each up to its
   first position whose own token's MoE routing differs between the
   two runs, at least ROUTE_MIN_HELD (4) positions, every flip that no
   earlier flip explains a near tie within ROUTE_TIE_GAP (0.02):
   :func:`held_routes`) and the twin ``serving_jamba_xla``: the first
   JAMBA_TWIN_REQUESTS (2) requests on plain attention and the plain
   scan, their flips held so too, prefill logits within
   ``SERVE_LOGIT_TOL``, greedy tokens by ``greedy_agree`` up to the
   first own-token flip, each
   Mamba sub-layer's ssm state after the first prefill within
   ``MAMBA_STATE_TOL`` of its largest; then that prefill's first flash
   call, case (q), and first scan, case (k), held to the plain versions
   and timed (the flash case beside SDPA).  Prefill and decode-step ms,
   tokens/s, TTFT, weight bytes and peak, a profile;
11i. the dry-run (``dryrun``), after phase 11h, on the host alone:
   ``launch/dryrun.py``'s cells of Granite-3.0-2B (train_4k,
   prefill_32k, decode_32k) at full width on the 16 x 16 production
   mesh, rank 0 of 256 on ``torch.distributed``'s ``fake`` backend and
   ``meta`` tensors, each record ok with its roofline terms, and no
   process group left after it; the resident bytes ``launch/specs.py``
   predicts for the parameters and the engine's caches of phases 11 and
   11h (measured with ``torch.cuda.memory_allocated`` around their
   weights' draw and their engine's making) within RESIDENT_TOL (0.5 %);
   phase 11's 1024-token prefill counted on ``meta`` and priced with the
   H100 roofline: its measured ms, the roofline's step ms and MFU, and
   the measured MFU, which must lie in (0, 1], on a line of their own;
12. timings: each leg's median of 3 warmed runs and peak memory, a
   profile, and each kernel's CUDA-event time per call and the summed
   profiler device time of the port's kernels that call launches (two or
   three for ``hash_partition``, ``fused_bucketing`` and the radix pass),
   beside its plain version, its bound and, where there is one, a
   library call (a stable
   ``argsort`` of the ids beside ``hash_partition``, ``fused_bucketing``
   and the radix scatter pass; ``torch.isin`` of the occupied keys beside
   each ``hash_semi`` slab of a leg; SDPA beside ``flash_attention``).

The launch counters are set to 0 just before each leg's first run and
read just after it; the Table 5, UNOMT, set-ops, out-of-core and
training legs must launch
exactly the kernels their path runs, as often as it runs them.  The line before the last is the kernel table; the last line
is ``{"ok": true, "device": {...}}``.  Exits non-zero without a result
when there is no CUDA device.
"""
import collections
import contextlib
import dataclasses
import gc
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the kernels' bound and the H100 SXM rates it prices them at, one copy
from repro_torch.roofline.cost import bound  # noqa: E402
SORTMERGE_ROWS = 10_000_000
HASH_ROWS = 500_000
GROUPBY_ROWS = 10_000_000      # Table 5 groupby/unique leg
GROUPBY_KEYS = 1_000_000       # 10 % key uniqueness, as Fig. 4
GROUPBY_BUCKETS = 65536
SORT_ROWS = 10_000_000         # Table 5 OrderBy leg
BCAST_ROWS = (1_000_000, 100_000)
UNOMT_ROWS = 10_000_000        # response rows of the UNOMT leg
UNOMT_DRUGS = 65_536
UNOMT_CELLS = 1_024
SETOP_ROWS = (10_000_000, 5_000_000)   # set-ops leg: a and b
SETOP_KEYS = 1_000_000         # a.k over [0, 1 M), b.k over [500 k, 1.5 M)
SERVE_ARCH = "granite-3-2b"    # the serving leg's model, full width
MAMBA_ARCH = "falcon-mamba-7b"  # the Mamba serving leg's, full width
MOE_ARCH = "granite-moe-3b-a800m"  # the MoE serving leg's (full width and
                                   # depth) and training leg's
SERVE_SLOTS, SERVE_PROMPT, SERVE_GEN = 8, 1024, 64
SERVE_QUEUE, SERVE_REQUESTS = 64, 32
# the enc-dec and vision legs (full width and depth), served through
# make_prefill + make_serve_step, as the reference reaches them: the
# engine serves decoder-only configs alone
SEAMLESS_ARCH = "seamless-m4t-large-v2"
INTERNVL_ARCH = "internvl2-2b"
# the hybrid period stack: one whole period of Jamba-1.5-Large at its
# published widths (7 Mamba layers, attention at layer 7; MoE on the odd
# layers).  At its 16 experts one period holds 90.48 GB of bf16 weights,
# more than the card's 80 GB (rank processes on one card share it, so a
# model axis does not help), and at 12 the float32 draw of one stacked
# expert leaf and the dense MoE's (T, E, f) intermediates would not fit
# beside 71.15 GB: 8 experts, 51.82 GB, top-2 as published.  Its engine
# serves the leg's first JAMBA_REQUESTS requests with up to JAMBA_GEN
# tokens each; the twin on plain attention and the plain scan the first
# JAMBA_TWIN_REQUESTS
JAMBA_ARCH = "jamba-1.5-large-398b"
JAMBA_EXPERTS = 8
JAMBA_REQUESTS, JAMBA_GEN, JAMBA_TWIN_REQUESTS = 8, 32, 2
# 3 batches, not 4: with the legs at world 2 the script took 1 187 s of
# its 1 200 (H100 80GB HBM3, 700 W), and this was the last of the cuts
# the slice allows (a batch is ~2 s; the legs' set-up dominates)
ONESHOT_BATCHES, ONESHOT_ROWS, ONESHOT_PROMPT, ONESHOT_GEN = 3, 8, 1024, 32
AGGS = {"v": ["sum", "count", "mean", "min", "max"]}
_START = time.perf_counter()
KERNELS = ("hash_partition", "fused_bucketing", "hash_join", "radix_sort",
           "hash_groupby", "hash_semi", "flash_attention", "mamba_scan")
JOIN_KERNELS = KERNELS[:3]
# the __global__ functions of csrc/*.cu, as the profiler names them
# (the counting pass of tile_scan.cuh: count_upsweep, count_scan and
# rank_downsweep, under hash_partition, fused_bucketing and radix_sort;
# hash_semi_table builds hash_semi's tables past shared memory)
PORT_KERNEL_FNS = ("count_upsweep", "count_scan", "rank_downsweep",
                   "radix_downsweep", "hash_join", "hash_groupby",
                   "hash_semi", "hash_semi_table",
                   "flash_attention", "mamba_scan")


def _modules():
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import checkpoint
    from repro_torch.configs import ShapeCell, cells_for, get_config, \
        get_reduced
    from repro_torch.core import dist_ops
    from repro_torch.core import local_ops
    from repro_torch.core import morsel
    from repro_torch.core.context import all_gather, make_context
    from repro_torch.data import synthetic, unomt
    from repro_torch.kernels import bucketing, build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.launch import dryrun, mesh, serve, specs, train, \
        unomt_e2e
    from repro_torch.roofline import analysis as roofline
    from repro_torch.models import attention as attn
    from repro_torch.models import layers
    from repro_torch.models import model
    from repro_torch.serving import ServingEngine
    from repro_torch.kernels.fused_bucketing import ops as fb_ops
    from repro_torch.kernels.fused_bucketing import ref as fb_ref
    from repro_torch.kernels.hash_groupby import ops as hg_ops
    from repro_torch.kernels.hash_groupby import ref as hg_ref
    from repro_torch.kernels.hash_join import ops as hj_ops
    from repro_torch.kernels.hash_join import ref as hj_ref
    from repro_torch.kernels.hash_partition import ops as hp_ops
    from repro_torch.kernels.hash_partition import ref as hp_ref
    from repro_torch.kernels.hash_semi import ops as hs_ops
    from repro_torch.kernels.hash_semi import ref as hs_ref
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.kernels.mamba_scan import ref as ms_ref
    from repro_torch.models import mamba
    from repro_torch.models import moe
    from repro_torch.models import sharding
    from repro_torch.models import transformer
    from repro_torch.models import unomt_net
    from repro_torch.optim import adamw, compression
    from repro_torch.runtime import ddp
    from repro_torch.kernels.radix_sort import ops as rs_ops
    from repro_torch.kernels.radix_sort import ref as rs_ref
    return dict(D=dist_ops, L=local_ops, U=unomt, Mo=morsel, Un=unomt_net,
                Aw=adamw, Cp=compression, Rd=ddp, make_context=make_context,
                all_gather=all_gather,
                build=build, bucketing=bucketing,
                ops={"hash_partition": hp_ops, "fused_bucketing": fb_ops,
                     "hash_join": hj_ops, "radix_sort": rs_ops,
                     "hash_groupby": hg_ops, "hash_semi": hs_ops,
                     "flash_attention": fa_ops, "mamba_scan": ms_ops},
                hp_ref=hp_ref, fb_ref=fb_ref, hj_ref=hj_ref, rs_ref=rs_ref,
                hg_ref=hg_ref, hs_ref=hs_ref, fa_ref=fa_ref, ms_ref=ms_ref,
                get_config=get_config, get_reduced=get_reduced, M=model,
                A=attn, Ly=layers, Mb=mamba,
                Moe=moe, Tf=transformer, Me=mesh, Sh=sharding,
                serve=serve, ServingEngine=ServingEngine, Ck=checkpoint,
                Sy=synthetic, Tr=train, Ue=unomt_e2e, Dr=dryrun, SP=specs,
                Ro=roofline, ShapeCell=ShapeCell, cells_for=cells_for)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def emit(obj) -> None:
    """One JSON line; a phase's record also gets ``t_s``, the seconds
    since the script started."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _START}
    print(json.dumps(obj), flush=True)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _allocated(device) -> int:
    return torch.cuda.memory_allocated(device) \
        if torch.device(device).type == "cuda" else 0


# --------------------------------------------------------------------------
# kernel inputs at the main path's shapes
# --------------------------------------------------------------------------


def kernel_cases(m, device, hash_plan, groupby_sizes, groupby_loads,
                 scale=1.0, seed=1):
    """The inputs each kernel gets on the legs: hash_partition at P = 2
    (the world-1 shuffle's live + trash partitions) on 10 M rows, at
    P = 513 (a 512-bucket ranking) on 625 k rows, and past those: 10 M
    rows at P = 2 with every 7th id -1 (blocks of 4 tiles, the last
    ragged), and P = 9 on 3 M + 5 rows (a ragged tile); fused_bucketing
    at 512 buckets on 625 k rows with one int plane and with two float
    planes (-0.0 and NaN included), and with three int planes at P = 9 on
    3 M + 5 rows (the plain versions' (P, n) one-hots stay under 1 GB);
    hash_join on the 500 k leg's slab shapes;
    radix_sort's digit pass on 20 M rows (the groupby and sort legs'
    shuffled capacity), as the scatter of a random perm with the words and
    as within-digit ranks, at 8 bits, shifts 0 and 24, and its 1-bit
    pass, at 11 bits on 625 k rows, and the scatter on one ragged 64-row
    tile; hash_groupby on slabs shaped and filled as the groupby leg's
    (``groupby_loads`` rows in each bucket), with NaN and -0.0 among the
    values: once integer-valued, as the leg's, once normal-distributed,
    where the sums may round, and once with the occupied slots scattered
    over each slab, one bucket all one key and one bucket empty;
    hash_join also at K = 33 key planes and at a slab wider than a
    block's shared memory.
    hash_semi's cases come from the UNOMT leg (:func:`semi_cases`)."""
    rng = np.random.default_rng(seed)
    n_big = max(int(SORTMERGE_ROWS * scale), 1)
    n_slab = hash_plan["shuffle_sizes"]["left"][1]
    sizes = hash_plan["local_join_sizes"]
    B, C, Lc = (sizes["num_buckets"], sizes["bucket_capacity"],
                sizes["probe_capacity"])

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    cases = {}
    cases["hash_partition"] = [
        dict(shape=f"n={n_big} P=2", args=(
            dev(rng.integers(0, 2, n_big).astype(np.int32)), 2)),
        dict(shape=f"n={n_slab} P=513", args=(
            dev(rng.integers(0, 513, n_slab).astype(np.int32)), 513))]
    valid = dev(np.arange(n_slab) < int(n_slab * 0.8))
    floats = rng.normal(size=(2, n_slab)).astype(np.float32)
    floats[:, ::7] = -0.0
    floats[:, ::11] = np.nan
    cases["fused_bucketing"] = [
        dict(shape=f"n={n_slab} K=1 P={B} int", args=(
            (dev(rng.integers(0, n_slab // 10, n_slab).astype(np.int32)),),
            valid, B)),
        dict(shape=f"n={n_slab} K=2 P={B} float", args=(
            tuple(dev(f.view(np.int32)) for f in floats), valid, B))]
    # several tiles a block, ragged ends, uncounted ids, three planes: from
    # their own generator so the later cases draw what they drew before
    xrng = np.random.default_rng(seed + 200)
    n_mid = max(int(3_000_005 * scale), 1)
    skipped = xrng.integers(0, 2, n_big).astype(np.int32)
    skipped[::7] = -1
    cases["hash_partition"] += [
        dict(shape=f"n={n_big} P=2 every 7th id -1", args=(dev(skipped), 2)),
        dict(shape=f"n={n_mid} P=9", args=(
            dev(xrng.integers(0, 9, n_mid).astype(np.int32)), 9))]
    cases["fused_bucketing"].append(dict(
        shape=f"n={n_mid} K=3 P=9 int", args=(
            tuple(dev(xrng.integers(-2**31, 2**31, n_mid, dtype=np.int64)
                      .astype(np.int32)) for _ in range(3)),
            dev(xrng.random(n_mid) < 0.8), 9)))
    # each bucket holds ~1/B of the rows with ~10 rows per key, as on the
    # 500 k-row leg; the rest of each slab is empty
    fill_p = rng.integers(int(0.85 * Lc), Lc + 1, B)
    fill_b = rng.integers(int(0.85 * C), C + 1, B)
    nkeys = max(C // 10, 1)
    cases["hash_join"] = [dict(shape=f"B={B} K=1 Lc={Lc} C={C}", args=(
        dev(rng.integers(0, nkeys, (B, 1, Lc)).astype(np.int32)),
        dev((np.arange(Lc)[None, :] < fill_p[:, None]).astype(np.int32)),
        dev(rng.integers(0, nkeys, (B, 1, C)).astype(np.int32)),
        dev((np.arange(C)[None, :] < fill_b[:, None]).astype(np.int32))))]
    # past 32 key planes, and a build slab of (1 + 1) * 32768 * 4 B, more
    # than the 227 KB a block may hold
    wide = dict(K33=(64, 33, 64, 200), C32768=(4, 1, 64, 32768))
    for name, shape in wide.items():
        cases["hash_join"].append(dict(
            shape=f"B={shape[0]} K={shape[1]} Lc={shape[2]} C={shape[3]}",
            args=tuple(dev(a) for a in pooled_slabs(rng, *shape))))

    n_sort = max(int(2 * GROUPBY_ROWS * scale), 1)
    words = dev(rng.integers(-2**31, 2**31, n_sort, dtype=np.int64)
                .astype(np.int32))
    flags = dev(rng.integers(0, 2, n_sort).astype(np.int32))
    words11 = dev(rng.integers(-2**31, 2**31, n_slab, dtype=np.int64)
                  .astype(np.int32))
    # the permutations a pass carries, from their own generator so the
    # later cases draw what they drew before
    prng = np.random.default_rng(seed + 100)
    n64 = min(64, n_sort)
    perm, perm11, perm64 = (dev(prng.permutation(n).astype(np.int32))
                            for n in (n_sort, n_slab, n64))
    # a scatter pass takes (perm, words, shift, bits, tile), the ranking
    # (words, shift, bits, tile)
    cases["radix_sort"] = [
        dict(shape=f"scatter n={n_sort} bits=8 shift=0",
             args=(perm, words, 0, 8, 1024)),
        dict(shape=f"ranks n={n_sort} bits=8 shift=0",
             args=(words, 0, 8, 1024)),
        dict(shape=f"scatter n={n_sort} bits=8 shift=24",
             args=(perm, words, 24, 8, 1024)),
        dict(shape=f"scatter n={n_sort} bits=1", args=(perm, flags, 0, 1,
                                                       1024)),
        dict(shape=f"scatter n={n_slab} bits=11 shift=11",
             args=(perm11, words11, 11, 11, 1024)),
        dict(shape=f"ranks n={n_sort} bits=8 shift=24",
             args=(words, 24, 8, 1024)),
        dict(shape=f"ranks n={n_sort} bits=1", args=(flags, 0, 1, 1024)),
        dict(shape=f"ranks n={n_slab} bits=11 shift=11",
             args=(words11, 11, 11, 1024)),
        dict(shape=f"scatter n={n64} bits=8 shift=8", args=(
            perm64, words[:n64].clone(), 8, 8, 1024))]

    # each bucket holds as many rows as the leg's keys put in it, ~10 rows
    # per key
    B, C = groupby_sizes["num_buckets"], groupby_sizes["bucket_capacity"]
    B = max(int(B * scale), 1)
    fill = groupby_loads[:B]
    vals = rng.integers(-100, 100, (B, 1, C)).astype(np.float32)
    vals[rng.random(vals.shape) < 0.01] = -0.0
    vals[rng.random(vals.shape) < 0.001] = np.nan
    keys = rng.integers(0, np.maximum(fill // 10, 1)[:, None, None],
                        (B, 1, C))
    normal = rng.normal(size=(B, 1, C)).astype(np.float32)
    normal[vals == 0] = -0.0
    normal[np.isnan(vals)] = np.nan
    kb = dev(keys.astype(np.int32))
    occ = dev((np.arange(C)[None, :] < fill[:, None]).astype(np.int32))
    # the leg's fills with holes in the occupancy (not a prefix), one
    # bucket whose every slot holds one key and one empty bucket, from
    # their own generator so the cases above draw what they drew before
    hrng = np.random.default_rng(seed + 300)
    hocc = (hrng.random((B, C)) < (fill / C)[:, None]).astype(np.int32)
    hkeys = keys.astype(np.int32)
    hocc[0], hkeys[0] = 1, 7
    if B > 1:
        hocc[1] = 0
    cases["hash_groupby"] = [
        dict(shape=f"B={B} K=1 V=1 C={C} integer", args=(kb, occ, dev(vals))),
        dict(shape=f"B={B} K=1 V=1 C={C} normal", args=(kb, occ,
                                                        dev(normal))),
        dict(shape=f"B={B} K=1 V=1 C={C} integer, holes, a one-key and an "
                   "empty bucket", args=(dev(hkeys), dev(hocc), dev(vals)))]
    return cases


def groupby_workspace_case(m, device, name, B=512, C=7000, K=2, V=5,
                           seed=5):
    """The groupby accumulate on slabs whose workspace is past a block's
    shared memory, so the wrapper allocates it in device memory (B 512,
    C 7000, K 2, V 5, about a third full, ~10 rows a key, as
    ``tools/probe_variants.py`` draws them): held once to the plain
    version, then timed.  Not a leg's shape, so it is not in
    ``kernel_cases``."""
    rng = np.random.default_rng(seed)
    n = np.minimum(rng.poisson(C // 3, B), C)
    keys = rng.integers(0, np.maximum(n // 10, 1)[:, None, None], (B, 1, C))
    keys = np.concatenate([keys * (2 * k + 1) + k for k in range(K)], 1)
    args = tuple(torch.from_numpy(a).to(device) for a in (
        keys.astype(np.int32),
        (np.arange(C)[None] < n[:, None]).astype(np.int32),
        rng.integers(-100, 100, (B, V, C)).astype(np.float32)))
    op = m["ops"]["hash_groupby"]
    nbytes = op._entry()[1](B, K, V, C)
    if nbytes <= 0:
        raise AssertionError(f"hash_groupby: B {B} C {C} fits shared memory")
    err, _ = _groupby_close(m, args, _kernel(m, "hash_groupby", args),
                            _plain(m, "hash_groupby", args))
    emit({"phase": "kernel_timing", "name": "hash_groupby", "card": name,
          "shape": f"B={B} K={K} V={V} C={C} past shared memory",
          "workspace_bytes": nbytes, "max_abs_err": err,
          "ms": event_ms(lambda: _kernel(m, "hash_groupby", args)),
          "kernel_ms": port_kernel_ms(
              lambda: _kernel(m, "hash_groupby", args))[0],
          "bound_ms": bound("hash_groupby", args)[0]})


def pooled_slabs(rng, B, K, Lc, C):
    """Probe and build slabs, every slot occupied, whose keys come from a
    pool of 8 K-plane vectors per bucket (the build side uses the first
    6, so some probes miss)."""
    pool = rng.integers(-4, 4, (B, K, 8)).astype(np.int32)
    pp = np.repeat(rng.integers(0, 8, (B, 1, Lc)), K, 1)
    bp = np.repeat(rng.integers(0, 6, (B, 1, C)), K, 1)
    return (np.take_along_axis(pool, pp, 2), np.ones((B, Lc), np.int32),
            np.take_along_axis(pool, bp, 2), np.ones((B, C), np.int32))


def float_semi_slabs(rng, dev, B=512, Lc=256, C=64):
    """Two float key planes (bits) with -0.0, NaN, infinities and
    subnormals among them, about 80 % of the slots occupied."""
    vals = np.float32([0.0, -0.0, np.nan, np.inf, -np.inf, 1e-40, 1.5,
                       -2.25, 3.0e38])
    pb = rng.choice(vals, (B, 2, Lc)).view(np.int32)
    bb = rng.choice(vals, (B, 2, C)).view(np.int32)
    return (dev(pb), dev((rng.random((B, Lc)) < 0.8).astype(np.int32)),
            dev(bb), dev((rng.random((B, C)) < 0.8).astype(np.int32)))


def semi_cases(recorded, device, seed=2):
    """hash_semi's cases: the slabs its wrapper received on the counted
    hash runs of the UNOMT leg (the drug and the cell filter) and of the
    set-op legs (isin, intersect, difference), with the probe and build
    keys of their occupied slots for ``torch.isin``, then two float
    planes and a slab wider than a block's shared memory."""
    rng = np.random.default_rng(seed)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    cases = []
    for col, (pb, po, bb, bo) in zip(
            ("drug_id", "cell_id", "isin", "intersect", "difference"),
            recorded, strict=True):
        B, K, Lc = pb.shape
        cases.append(dict(
            shape=f"{col} B={B} K={K} Lc={Lc} C={bb.shape[2]}",
            args=(pb, po, bb, bo),
            library=(pb[:, 0][po > 0], bb[:, 0][bo > 0])))
    cases.append(dict(shape="B=512 K=2 Lc=256 C=64 float",
                      args=float_semi_slabs(rng, dev)))
    cases.append(dict(
        shape="B=16 K=1 Lc=256 C=32768",
        args=tuple(dev(a) for a in pooled_slabs(rng, 16, 1, 256, 32768))))
    return cases


def _plain(m, name, args):
    """The plain version on the same inputs; the probes in chunks of
    buckets to bound their memory (the radix and groupby plain versions
    chunk themselves)."""
    if name == "hash_partition":
        return m["hp_ref"].radix_histogram_ranks_ref(*args)
    if name == "fused_bucketing":
        return m["fb_ref"].fused_bucket_ranks_ref(*args)
    if name == "radix_sort" and len(args) == 5:
        return m["rs_ref"].scatter_pass_ref(*args[:4])
    if name == "radix_sort":
        return m["rs_ref"].digit_histogram_ranks_ref(*args[:3])
    if name == "hash_groupby":
        return m["hg_ref"].bucket_accumulate_ref(*args)
    if name == "flash_attention":
        q, k, v, causal = args
        return (m["fa_ref"].attention_ref(q, k, v, causal=causal),)
    if name == "mamba_scan":
        y, hT = m["ms_ref"].selective_scan_ref(*args[:6])
        return (y, hT) if args[6] else (y,)
    pb, po, bb, bo = args
    if name == "hash_semi":
        # about 2**28 pairs per chunk of buckets
        chunk = max(1, (1 << 28) // max(pb.shape[2] * bb.shape[2], 1))
        return (torch.cat([m["hs_ref"].bucket_member_ref(
            pb[i:i + chunk], po[i:i + chunk], bb[i:i + chunk],
            bo[i:i + chunk]) for i in range(0, pb.shape[0], chunk)]),)
    chunk = 32
    parts = [m["hj_ref"].bucket_probe_ref(pb[i:i + chunk], po[i:i + chunk],
                                          bb[i:i + chunk], bo[i:i + chunk])
             for i in range(0, pb.shape[0], chunk)]
    return tuple(torch.cat(p) for p in zip(*parts))


def _kernel(m, name, args):
    op = m["ops"][name]
    if name == "hash_partition":
        return op.radix_histogram_ranks(*args)
    if name == "fused_bucketing":
        return op.fused_bucket_ranks(*args)
    if name == "radix_sort" and len(args) == 5:
        return op.scatter_pass(*args)
    if name == "radix_sort":
        return op.digit_histogram_ranks(*args)
    if name == "hash_groupby":
        return op.bucket_accumulate(*args)
    if name == "hash_semi":
        return (op.bucket_member(*args),)
    if name == "flash_attention":
        q, k, v, causal = args
        return (op.flash_attention(q, k, v, causal=causal),)
    if name == "mamba_scan":
        out = op.selective_scan(*args[:6], return_state=args[6])
        return out if args[6] else (out,)
    return op.bucket_probe(*args)


def _groupby_close(m, args, got, want):
    """rep and counts exact; mins and maxs equal as values (NaN == NaN,
    -0.0 == +0.0); sums within 1e-6 of the group's sum of magnitudes.
    Returns the largest absolute sum difference and the largest ratio of
    a difference to its group's sum of magnitudes (NaN pairs excluded)."""
    for g, w in zip(got[:2], want[:2]):
        if not torch.equal(g, w):
            raise AssertionError("hash_groupby: rep/counts differ")
    for g, w in zip(got[3:], want[3:]):
        if not bool(((g == w) | (torch.isnan(g) & torch.isnan(w))).all()):
            raise AssertionError("hash_groupby: mins/maxs differ")
    kb, occ, vals = args
    scale = m["hg_ref"].bucket_accumulate_ref(kb, occ, vals.abs())[2]
    both_nan = torch.isnan(got[2]) & torch.isnan(want[2])
    diff = torch.where(both_nan, 0.0, (got[2] - want[2]).abs())
    ratio = torch.where(diff > 0, diff / scale, 0.0)
    worst = float(ratio.max()) if ratio.numel() else 0.0
    if not bool(((diff <= 1e-6 * scale) | both_nan).all()):
        raise AssertionError("hash_groupby: sums differ beyond 1e-6 of "
                             f"the group's sum of magnitudes (worst {worst})")
    return (float(diff.max()) if diff.numel() else 0.0), worst


def compare_kernels(m, cases, device) -> dict:
    """Kernel == plain version on every case (exactly, but for the
    groupby sums, see :func:`_groupby_close`); returns the largest
    absolute difference per kernel."""
    errs = {}
    for name, runs in cases.items():
        errs[name] = 0
        for case in runs:
            got = _kernel(m, name, case["args"])
            want = _plain(m, name, case["args"])
            _sync(device)
            if name in ("flash_attention", "mamba_scan"):
                close, tol = (_flash_close, FLASH_TOL) \
                    if name == "flash_attention" else (_scan_close, SCAN_TOL)
                err = close(case, got, want)
                errs[name] = max(errs[name], err)
                emit({"phase": "kernel_close", "kernel": name,
                      "shape": case["shape"], "max_abs_err": err,
                      "tolerance": tol})
                continue
            if name == "hash_groupby":
                err, worst = _groupby_close(m, case["args"], got, want)
                errs[name] = max(errs[name], err)
                emit({"phase": "kernel_equal", "kernel": name,
                      "shape": case["shape"], "equal": True,
                      "max_abs_err": err, "worst_err_over_abs_sum": worst})
                continue
            for g, w in zip(got, want):
                if g.shape != w.shape or g.dtype != w.dtype \
                        or not torch.equal(g, w):
                    raise AssertionError(f"{name} {case['shape']}: kernel "
                                         "differs from its plain version")
                if g.numel():
                    errs[name] = max(errs[name], int(
                        (g.to(torch.int64) - w.to(torch.int64)).abs().max()))
            emit({"phase": "kernel_equal", "kernel": name,
                  "shape": case["shape"], "equal": True})
    return errs


# --------------------------------------------------------------------------
# the Fig. 4 join legs
# --------------------------------------------------------------------------


def fig4_data(rows: int, seed: int = 0):
    """Two relations with ~10% key uniqueness (paper Fig. 4)."""
    rng = np.random.default_rng(seed)
    nkeys = max(rows // 10, 1)
    left = {"k": rng.integers(0, nkeys, rows).astype(np.int32),
            "lv": rng.normal(size=rows).astype(np.float32)}
    right = {"k": rng.integers(0, nkeys, rows).astype(np.int32),
             "rv": rng.normal(size=rows).astype(np.float32)}
    return left, right


def pipeline(m, ctx, fn, *datas):
    """``run()`` drives ``fn`` once through the pipeline on the
    distributed tables of ``datas``."""
    D = m["D"]
    pipe = D.DistributedPipeline(ctx, fn)
    tables = [D.distribute_table(ctx, d) for d in datas]
    return lambda: pipe(*tables)


def fig4_leg(m, ctx, left, right, impl, plan):
    """``run()`` drives ``dist_join`` once with the plan's sizes."""
    return pipeline(m, ctx, lambda c, a, b: m["D"].dist_join(
        c, a, b, left_on=["k"], out_capacity=plan["out_capacity"],
        shuffle_sizes=plan["shuffle_sizes"], local_impl=impl,
        local_join_sizes=plan["local_join_sizes"]), left, right)


def counted_run(m, run, device):
    """One run with every launch counter set to 0 just before it; returns
    (result, launches per kernel)."""
    for op in m["ops"].values():
        op.launches = 0
    out = run()
    _sync(device)
    return out, {k: op.launches for k, op in m["ops"].items()}


def check_sortmerge(m, ctx, out, dropped, left, right):
    """Exact checks of the world-1 sortmerge output: no drops, the keys
    are left-row-major with each left key repeated by its right count,
    and sum(lv*rv) equals sum over keys of sum(lv)*sum(rv)."""
    if int(dropped) != 0:
        raise AssertionError(f"sortmerge leg dropped {int(dropped)} rows")
    got = m["D"].collect_table(ctx, out)
    nkeys = int(max(left["k"].max(), right["k"].max())) + 1
    rcount = np.bincount(right["k"], minlength=nkeys)
    want_k = np.repeat(left["k"], rcount[left["k"]])
    if not np.array_equal(got["k"], want_k):
        raise AssertionError("sortmerge leg: output keys differ from "
                             "repeat(left_k, right_count[left_k])")
    prod = got["lv"].astype(np.float64) * got["rv"].astype(np.float64)
    want = np.dot(
        np.bincount(left["k"], weights=left["lv"].astype(np.float64),
                    minlength=nkeys),
        np.bincount(right["k"], weights=right["rv"].astype(np.float64),
                    minlength=nkeys))
    tol = 1e-6 * np.abs(prod).sum()
    if abs(prod.sum() - want) > tol:
        raise AssertionError(f"sortmerge leg: sum(lv*rv) {prod.sum()} != "
                             f"{want} within {tol}")
    return len(want_k)


def bit_identical(a, b) -> bool:
    """Two tables with the same rows, bit for bit (floats by their bits)."""
    if a.names != b.names or int(a.nvalid) != int(b.nvalid):
        return False
    n = int(a.nvalid)
    for k in a.names:
        x, y = a.columns[k][:n], b.columns[k][:n]
        if x.dtype != y.dtype:
            return False
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            return False
    return True


def run_legs(m, ctx, sortmerge_rows, hash_rows, device):
    """Drive both legs once each, counted and checked; returns what the
    timing phase needs."""
    D = m["D"]
    legs = {}
    left, right = fig4_data(sortmerge_rows)
    plan = D.plan_dist_join_sizes([left["k"]], [right["k"]], world=1,
                                  local_impl="sortmerge")
    run = fig4_leg(m, ctx, left, right, "sortmerge", plan)
    (out, dropped), launches = counted_run(m, run, device)
    if launches["hash_partition"] < 1:
        raise AssertionError("sortmerge leg launched no hash_partition")
    rows_out = check_sortmerge(m, ctx, out, dropped, left, right)
    del out
    emit({"phase": "fig4_sortmerge", "rows_per_side": sortmerge_rows,
          "out_rows": rows_out, "dropped": int(dropped),
          "launches": launches, "plan": plan})
    legs["sortmerge"] = dict(run=run, launches=launches,
                             rows=sortmerge_rows)

    left, right = fig4_data(hash_rows)
    plan = D.plan_dist_join_sizes([left["k"]], [right["k"]], world=1,
                                  local_impl="hash")
    run = fig4_leg(m, ctx, left, right, "hash", plan)
    (out, dropped), launches = counted_run(m, run, device)
    if min(launches[k] for k in JOIN_KERNELS) < 1:
        raise AssertionError(f"hash leg missed a kernel: {launches}")
    ref_run = fig4_leg(m, ctx, left, right, "sortmerge",
                       dict(plan, local_join_sizes=None))
    ref_out, ref_dropped = ref_run()
    if int(dropped) != 0 or int(ref_dropped) != 0:
        raise AssertionError(f"hash leg dropped {int(dropped)} rows "
                             f"(sortmerge on its data {int(ref_dropped)})")
    if not bit_identical(out, ref_out):
        raise AssertionError("hash leg differs from sortmerge on its data")
    emit({"phase": "fig4_hash", "rows_per_side": hash_rows,
          "out_rows": int(out.nvalid), "dropped": int(dropped),
          "bit_identical_to_sortmerge": True, "launches": launches,
          "plan": plan})
    legs["hash"] = dict(run=run, launches=launches, rows=hash_rows,
                        plan=plan)
    return legs


# --------------------------------------------------------------------------
# the Table 5 legs: GroupBy, Unique, OrderBy, broadcast join
# --------------------------------------------------------------------------


def groupby_data(rows: int, nkeys: int, seed: int = 0):
    """k uniform over ``nkeys`` keys, v integer-valued float32 in
    [-100, 100) (as ``benchmarks/bench_groupby.py``)."""
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, nkeys, rows).astype(np.int32),
            "v": rng.integers(-100, 100, rows).astype(np.float32)}


def plan_groupby_sizes(m, data) -> dict:
    """Host-side slab sizes for the hash groupby, as users size a traced
    hash groupby (``benchmarks/bench_groupby.hash_sizes``)."""
    B, C = m["bucketing"].plan_bucket_sizes([data["k"]],
                                            num_buckets=GROUPBY_BUCKETS)
    return {"num_buckets": B, "bucket_capacity": C}


def sort_data(rows: int, seed: int = 0):
    """k int32 in [-500 000, 500 000), v normal float32 with -0.0 and NaN
    sprinkled in."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=rows).astype(np.float32)
    v[rng.random(rows) < 0.01] = -0.0
    v[rng.random(rows) < 0.001] = np.nan
    return {"k": rng.integers(-500_000, 500_000, rows).astype(np.int32),
            "v": v}


def expect_launches(leg: str, launches: dict, want: dict) -> None:
    """Exactly ``want`` launches (0 for a kernel not named)."""
    full = {k: want.get(k, 0) for k in KERNELS}
    if any(launches[k] != full[k] for k in KERNELS):
        raise AssertionError(f"{leg}: launches {launches}, expected {full}")


def counted_leg(m, leg, run, device, want, legs):
    """One counted run that must launch exactly ``want`` and drop nothing;
    the leg is kept for the timing phase."""
    (out, dropped), launches = counted_run(m, run, device)
    expect_launches(leg, launches, want)
    if int(dropped) != 0:
        raise AssertionError(f"{leg} dropped {int(dropped)} rows")
    legs[leg] = dict(run=run, launches=launches)
    return out


def check_groupby(got: dict, data: dict) -> None:
    """Keys, counts, sums, mins and maxs equal numpy's (exact on this
    integer-valued data), and mean == float32(sum) / float32(count)."""
    k, v = data["k"], data["v"]
    uniq = np.unique(k)
    nk = int(k.max()) + 1
    counts = np.bincount(k, minlength=nk)[uniq]
    sums = np.bincount(k, weights=v.astype(np.float64),
                       minlength=nk)[uniq].astype(np.float32)
    mins = np.full(nk, np.inf, np.float32)
    maxs = np.full(nk, -np.inf, np.float32)
    np.minimum.at(mins, k, v)
    np.maximum.at(maxs, k, v)
    want = {"k": uniq.astype(np.int32), "v_sum": sums,
            "v_count": counts.astype(np.int32),
            "v_mean": sums / counts.astype(np.float32),
            "v_min": mins[uniq], "v_max": maxs[uniq]}
    if list(got) != list(want):
        raise AssertionError(f"groupby leg: columns {list(got)}")
    for name, w in want.items():
        g = got[name]
        if g.dtype != w.dtype or not np.array_equal(g.view(np.int32),
                                                    w.view(np.int32)):
            raise AssertionError(f"groupby leg: {name} differs from numpy")


def check_sorted(got: dict, data: dict) -> None:
    """The rows are a numpy stable sort by (k, v), NaN last and -0.0 equal
    to +0.0, bit for bit."""
    k, v = data["k"], data["v"]
    order = np.lexsort((np.where(np.isnan(v), np.inf, v), k))
    if not (np.array_equal(got["k"], k[order])
            and np.array_equal(got["v"].view(np.int32),
                               v[order].view(np.int32))):
        raise AssertionError("sort leg: rows are not in (k, v) order")


def run_table5(m, ctx, device, data, sizes):
    """Drive the GroupBy, Unique, OrderBy and broadcast-join phases once
    each, counted and checked; returns the legs the timing phase runs
    again."""
    D = m["D"]
    legs = {}
    uniq, first = np.unique(data["k"], return_index=True)

    hashed = {"hash_partition": 1, "radix_sort": 8, "hash_groupby": 1}
    sorted_ = {"hash_partition": 1, "radix_sort": 1}
    out = {}
    for impl, want in (("hash", hashed), ("sort", sorted_)):
        kw = dict(local_impl=impl,
                  groupby_sizes=sizes if impl == "hash" else None)
        run = pipeline(m, ctx, lambda c, a, kw=kw: D.dist_groupby(
            c, a, ["k"], AGGS, **kw), data)
        out[impl] = counted_leg(m, f"groupby_{impl}", run, device, want,
                                legs)
        legs[f"groupby_{impl}"]["rows"] = GROUPBY_ROWS
    check_groupby(D.collect_table(ctx, out["hash"]), data)
    if not bit_identical(out["hash"], out["sort"]):
        raise AssertionError("groupby leg: hash differs from sort")
    emit({"phase": "groupby", "rows": GROUPBY_ROWS, "keys": GROUPBY_KEYS,
          "groups": int(out["hash"].nvalid), "sizes": sizes,
          "equal_to_numpy": True, "bit_identical_to_sort": True,
          "launches": {i: legs[f"groupby_{i}"]["launches"] for i in out}})

    for impl, want in (("hash", hashed), ("sort", sorted_)):
        kw = dict(local_impl=impl,
                  groupby_sizes=sizes if impl == "hash" else None)
        run = pipeline(m, ctx, lambda c, a, kw=kw: D.dist_unique(
            c, a, ["k"], **kw), data)
        out[impl] = counted_leg(m, f"unique_{impl}", run, device, want, {})
    got = D.collect_table(ctx, out["hash"])
    if not (bit_identical(out["hash"], out["sort"])
            and np.array_equal(got["k"], uniq)
            and np.array_equal(got["v"], data["v"][first])):
        raise AssertionError("unique leg: hash, sort and numpy differ")
    emit({"phase": "unique", "rows": GROUPBY_ROWS, "nvalid": len(uniq),
          "bit_identical_hash_sort": True})
    del out

    sdata = sort_data(SORT_ROWS)
    out = {}
    for impl, want in (("radix", {"hash_partition": 1, "radix_sort": 27}),
                       ("xla", {"hash_partition": 1})):
        run = pipeline(m, ctx, lambda c, a, impl=impl: D.dist_sort(
            c, a, ["k", "v"], local_impl=impl), sdata)
        out[impl] = counted_leg(m, f"sort_{impl}", run, device, want, legs)
        legs[f"sort_{impl}"]["rows"] = SORT_ROWS
    if not bit_identical(out["radix"], out["xla"]):
        raise AssertionError("sort leg: radix differs from xla")
    check_sorted(D.collect_table(ctx, out["radix"]), sdata)
    emit({"phase": "orderby", "rows": SORT_ROWS,
          "bit_identical_radix_xla": True, "numpy_order": True,
          "launches": {i: legs[f"sort_{i}"]["launches"] for i in out}})
    del out

    rng = np.random.default_rng(0)
    nl, nr = BCAST_ROWS
    left = {"k": rng.integers(0, nr, nl).astype(np.int32),
            "lv": rng.normal(size=nl).astype(np.float32)}
    right = {"k": np.arange(nr, dtype=np.int32),
             "rv": rng.normal(size=nr).astype(np.float32)}
    out = {}
    for strategy, want in (("broadcast", {"radix_sort": 1}),
                           ("shuffle", {"hash_partition": 2})):
        run = pipeline(m, ctx, lambda c, a, b, s=strategy: D.dist_join(
            c, a, b, left_on=["k"], strategy=s), left, right)
        out[strategy] = counted_leg(m, f"join_{strategy}", run, device,
                                    want, {})
    if int(out["broadcast"].nvalid) != nl \
            or not bit_identical(out["broadcast"], out["shuffle"]):
        raise AssertionError("broadcast join differs from the shuffle join")
    emit({"phase": "broadcast_join", "left_rows": nl, "right_rows": nr,
          "out_rows": nl, "bit_identical_to_shuffle": True})
    return legs


# --------------------------------------------------------------------------
# the UNOMT data-engineering pipeline and the set operators
# --------------------------------------------------------------------------

UNOMT_TABLES = ("response", "descriptors", "fingerprints", "rna")


def unomt_data(m, rows, drugs, cells):
    """The leg's raw tables, at the generator's own widths (8 drug and 8
    RNA features)."""
    return m["U"].gen_unomt_tables(n_response=rows, n_drugs=drugs,
                                   n_cells=cells, seed=0)


def _scaled(x):
    x = x.astype(np.float64)
    return (x - x.mean()) / np.sqrt(x.var() + 1e-12)


def unomt_numpy(m, raw) -> dict:
    """An independent pipeline: ``np.isnan`` for the nulls, index lookups
    for the joins (drug and cell ids are unique after Fig. 9 and 10),
    ``np.isin`` for the Fig. 11 filters, float64 scaling."""
    U = m["U"]
    r, desc, fp, rna = (raw[k] for k in UNOMT_TABLES)
    ok = ~np.isnan(r["response"])
    out = {"drug_id": (r["drug_id_raw"][ok] - 1_000_000).astype(np.int32),
           "cell_id": r["cell_id"][ok],
           "concentration": _scaled(r["concentration"][ok]),
           "response": r["response"][ok]}
    if len(np.unique(desc["drug_id"])) != len(desc["drug_id"]) or \
            len(np.unique(fp["drug_id"])) != len(fp["drug_id"]):
        raise AssertionError("unomt: duplicate drug ids in a sub-table")
    drugs = np.intersect1d(desc["drug_id"], fp["drug_id"])
    cells, first = np.unique(rna["cell_id"], return_index=True)
    keep = np.isin(out["drug_id"], drugs) & np.isin(out["cell_id"], cells)
    out = {k: v[keep] for k, v in out.items()}
    for sub in (desc, fp):
        row = np.full(int(sub["drug_id"].max()) + 1, -1, np.int64)
        row[sub["drug_id"]] = np.arange(len(sub["drug_id"]))
        for c in sub:
            if c != "drug_id":
                out[c] = sub[c][row[out["drug_id"]]]
    row = np.full(int(cells.max()) + 1, -1, np.int64)
    row[cells] = np.arange(len(cells))
    for c in U.rna_cols():
        out[c] = _scaled(rna[c][first])[row[out["cell_id"]]]
    return out


def check_unomt(got: dict, want: dict) -> None:
    """The same multiset of rows, compared after a lexsort on (drug_id,
    cell_id, response): ids and unscaled floats exactly, the scaled
    columns within 1e-4."""
    if list(got) != list(want):
        raise AssertionError(f"unomt: columns {list(got)} != {list(want)}")
    if len(got["drug_id"]) != len(want["drug_id"]):
        raise AssertionError(f"unomt: {len(got['drug_id'])} rows, numpy "
                             f"{len(want['drug_id'])}")
    og = np.lexsort((got["response"], got["cell_id"], got["drug_id"]))
    ow = np.lexsort((want["response"], want["cell_id"], want["drug_id"]))
    scaled = ["concentration"] + [c for c in got if c.startswith("rna")]
    for c in got:
        g, w = got[c][og], want[c][ow]
        if c in scaled:
            err = float(np.abs(g.astype(np.float64) - w).max()) \
                if len(g) else 0.0
            if not err <= 1e-4:
                raise AssertionError(f"unomt: {c} off by {err}")
        elif not np.array_equal(g, w):
            raise AssertionError(f"unomt: {c} differs from numpy")


def _copied(a):
    """A copy of a tensor argument, or of each tensor in a tuple of them."""
    if isinstance(a, torch.Tensor):
        return a.clone()
    return tuple(_copied(x) for x in a) if isinstance(a, tuple) else a


@contextlib.contextmanager
def recording(op, fn_name, calls, picks=None):
    """Context in which ``op.fn_name`` also appends a copy of the
    arguments of each call (of the calls whose index is in ``picks``),
    positional then keyword, to ``calls``; launches are counted as
    without it."""
    plain = getattr(op, fn_name)
    seen = [0]

    def keep(*args, **kwargs):
        if picks is None or seen[0] in picks:
            calls.append(tuple(_copied(a) for a in args)
                         + tuple(kwargs.values()))
        seen[0] += 1
        return plain(*args, **kwargs)

    setattr(op, fn_name, keep)
    try:
        yield
    finally:
        setattr(op, fn_name, plain)


# exact launches of the UNOMT leg at its size and seed (the same in every
# run): 8 shuffles, the radix passes of compactions and rankings, and
# for the hash filters drug ids in 4096 buckets (hashed in torch, ranked
# by radix passes) and cell ids in 128 (fused_bucketing)
UNOMT_LAUNCHES = {
    "sortmerge": {"hash_partition": 8, "radix_sort": 5},
    "hash": {"hash_partition": 8, "radix_sort": 9, "fused_bucketing": 2,
             "hash_semi": 2}}


def run_unomt(m, ctx, device, raw):
    """Drive ``unomt_dist_pipeline`` once per membership backend, counted
    and checked; then the Table -> tensor hand-off.  Returns the legs, the
    slabs the hash run gave ``bucket_member`` (drug, then cell filter) and
    the hash run's features ``(X, y, mask, valid rows)`` on the device."""
    D, U = m["D"], m["U"]
    legs, out, slabs = {}, {}, []
    rows = len(raw["response"]["cell_id"])
    for impl in ("sortmerge", "hash"):
        run = pipeline(m, ctx, lambda c, *ts, impl=impl: U.unomt_dist_pipeline(
            c, *ts, overcommit=1.0, semi_impl=impl),
            *[raw[k] for k in UNOMT_TABLES])
        with recording(m["ops"]["hash_semi"], "bucket_member",
                       slabs if impl == "hash" else []):
            (res, dropped), launches = counted_run(m, run, device)
        if int(dropped) != 0:
            raise AssertionError(f"unomt {impl} dropped {int(dropped)} rows")
        expect_launches(f"unomt_{impl}", launches, UNOMT_LAUNCHES[impl])
        out[impl] = res
        legs[f"unomt_{impl}"] = dict(run=run, launches=launches, rows=rows)
    if not bit_identical(out["sortmerge"], out["hash"]):
        raise AssertionError("unomt: hash membership differs from sortmerge")
    got = D.collect_table(ctx, out["hash"])
    check_unomt(got, unomt_numpy(m, raw))
    X, y, mask = U.feature_label_arrays(out["hash"])
    cap, n = out["hash"].capacity, int(out["hash"].nvalid)
    if X.shape != (cap, 17) or X.dtype != torch.float32 \
            or X.device.type != device.type or y.shape != (cap,) \
            or int(mask.sum()) != n or not bool(torch.isfinite(X[:n]).all()):
        raise AssertionError(f"unomt: features {tuple(X.shape)} {X.dtype} "
                             f"on {X.device}, {int(mask.sum())} valid")
    emit({"phase": "unomt", "response_rows": rows,
          "drugs": len(raw["descriptors"]["drug_id"]),
          "cells": len(np.unique(raw["rna"]["cell_id"])),
          "out_rows": n, "capacity": cap, "features": X.shape[1],
          "dropped": 0, "bit_identical_sortmerge_hash": True,
          "equal_to_numpy": True,
          "launches": {i: legs[f"unomt_{i}"]["launches"] for i in out}})
    return legs, slabs, (X, y, mask, n)


def setop_data(rows_a, rows_b, nkeys, seed=0):
    """a.k uniform over [0, nkeys), b.k uniform over [nkeys / 2,
    3 nkeys / 2): half of a's keys can be in b."""
    rng = np.random.default_rng(seed)
    a = {"k": rng.integers(0, nkeys, rows_a).astype(np.int32),
         "v": rng.normal(size=rows_a).astype(np.float32)}
    b = {"k": rng.integers(nkeys // 2, nkeys + nkeys // 2, rows_b)
         .astype(np.int32),
         "v": rng.normal(size=rows_b).astype(np.float32)}
    return a, b


# radix passes of each set op at the leg's size and seed (the same in
# every run); each op also shuffles both sides (2 hash_partition)
SETOP_RADIX = {"isin": {"sortmerge": 1, "hash": 7},
               "intersect": {"sortmerge": 2, "hash": 8},
               "difference": {"sortmerge": 1, "hash": 7}}


def run_setops(m, ctx, device, a, b):
    """``dist_isin``, ``dist_intersect`` and ``dist_difference`` once per
    membership backend (dedup by sort either way), counted and checked
    against numpy; the membership kernel must run exactly once per hash
    call.  Returns the legs and the slabs the hash runs gave
    ``bucket_member`` (isin, intersect, difference)."""
    D = m["D"]
    mask = np.isin(a["k"], b["k"])
    uk, first = np.unique(a["k"][mask], return_index=True)
    if not np.array_equal(uk, np.intersect1d(a["k"], b["k"])):
        raise AssertionError("set ops: numpy intersect disagrees")
    want = {"isin": {"k": a["k"][mask], "v": a["v"][mask]},
            "intersect": {"k": uk, "v": a["v"][mask][first]},
            "difference": {"k": a["k"][~mask], "v": a["v"][~mask]}}
    if not np.array_equal(np.unique(want["difference"]["k"]),
                          np.setdiff1d(a["k"], b["k"])):
        raise AssertionError("set ops: numpy difference disagrees")
    ops = {
        "isin": lambda c, x, y, impl: D.dist_isin(
            c, x, "k", y, "k", overcommit=1.0, local_impl=impl),
        "intersect": lambda c, x, y, impl: D.dist_intersect(
            c, x, y, ["k"], overcommit=1.0, local_impl=impl,
            dedup_impl="sort"),
        "difference": lambda c, x, y, impl: D.dist_difference(
            c, x, y, ["k"], overcommit=1.0, local_impl=impl)}
    legs, summary, slabs = {}, {}, []
    for op, fn in ops.items():
        out = {}
        for impl in ("sortmerge", "hash"):
            run = pipeline(m, ctx, lambda c, x, y, fn=fn, impl=impl: fn(
                c, x, y, impl), a, b)
            with recording(m["ops"]["hash_semi"], "bucket_member",
                           slabs if impl == "hash" else []):
                (res, dropped), launches = counted_run(m, run, device)
            if int(dropped) != 0:
                raise AssertionError(f"{op} {impl} dropped {int(dropped)}")
            expect_launches(f"{op}_{impl}", launches,
                            {"hash_partition": 2,
                             "radix_sort": SETOP_RADIX[op][impl],
                             "hash_semi": int(impl == "hash")})
            out[impl] = res
            legs[f"{op}_{impl}"] = dict(run=run, launches=launches,
                                        rows=len(a["k"]))
        if not bit_identical(out["sortmerge"], out["hash"]):
            raise AssertionError(f"{op}: hash differs from sortmerge")
        got = D.collect_table(ctx, out["hash"])
        for c, w in want[op].items():
            if not np.array_equal(got[c].view(np.int32), w.view(np.int32)):
                raise AssertionError(f"{op}: column {c} differs from numpy")
        summary[op] = len(got["k"])
    emit({"phase": "set_ops", "rows": [len(a["k"]), len(b["k"])],
          "keys": SETOP_KEYS, "out_rows": summary, "dropped": 0,
          "bit_identical_sortmerge_hash": True, "equal_to_numpy": True,
          "launches": {k: v["launches"] for k, v in legs.items()}})
    return legs, slabs


# --------------------------------------------------------------------------
# out-of-core morsels (the shape of benchmarks/bench_outofcore.py)
# --------------------------------------------------------------------------

OC_ROWS, OC_CHUNK = 10_000_000, 1_000_000   # bench_outofcore ROWS, CHUNK
# the hash join's morsel: its pair space B * Lc * C stays under 2^31
OC_HASH_CHUNK = 500_000
OC_RESTREAM_ROWS, OC_RESTREAM_CHUNK = 1_000_000, 250_000
OC_GROUP_CAP = 2_000_000       # accumulator groups of the chunked groupby
OC_AGGS = {"lv": ["sum", "count", "mean", "min", "max"]}
OC_REPS = 1                    # timed runs of a leg after its warm run
# exact launches of each leg at its size and seed (the same in every run).
# Per probe morsel a join shuffles (1 hash_partition) and compacts the
# shuffle's receive side by the cumsum, so the joins launch 1 + morsels
# hash_partition (the build side is one morsel; restream shuffles each
# build morsel once per probe morsel: 4 + 16); the sort-merge join sorts
# the resident build side by its key (5 radix passes under
# REPRO_SORT_IMPL=radix, none under the default "xla"); the hash join
# buckets both sides (fused_bucketing 2) and probes once a morsel.  A
# groupby morsel shuffles (1), aggregates its part and merges it into the
# accumulator: under "hash" two hash_groupby, each bucketing the keys of
# 65536 buckets by three radix passes and ranking the groups by five;
# under "sort" each aggregation compacts its group boundaries (1 radix
# pass).  A sort morsel is dist_sort's three radix sorts of one key (5
# passes each) and its shuffle.
OC_LAUNCHES = {
    "oc_join_sortmerge": {"hash_partition": 11},
    "oc_join_memmap": {"hash_partition": 11},
    "oc_join_hash": {"hash_partition": 21, "fused_bucketing": 40,
                     "hash_join": 20},
    "oc_join_restream": {"hash_partition": 20},
    "oc_groupby_hash": {"hash_partition": 10, "radix_sort": 160,
                        "hash_groupby": 20},
    "oc_groupby_sort": {"hash_partition": 10, "radix_sort": 20},
    "oc_sort_radix": {"hash_partition": 10, "radix_sort": 150},
}


def oc_data(rows: int, seed: int = 0):
    """``benchmarks/_subproc_outofcore.py``'s data: a ``rows``-row probe
    side with k uniform over rows / 10 keys and lv normal float32, and a
    build side with one row per key, rv normal float32."""
    rng = np.random.default_rng(seed)
    nkeys = max(rows // 10, 1)
    left = {"k": rng.integers(0, nkeys, rows).astype(np.int32),
            "lv": rng.normal(size=rows).astype(np.float32)}
    right = {"k": np.arange(nkeys, dtype=np.int32),
             "rv": rng.normal(size=nkeys).astype(np.float32)}
    return left, right


def to_memmap(cols: dict, tmpdir: Path) -> dict:
    """The columns as read-only ``np.memmap`` files under ``tmpdir``."""
    out = {}
    for name, v in cols.items():
        path = tmpdir / f"{name}.bin"
        mm = np.memmap(path, dtype=v.dtype, mode="w+", shape=v.shape)
        mm[:] = v
        mm.flush()
        del mm
        out[name] = np.memmap(path, dtype=v.dtype, mode="r", shape=v.shape)
    return out


class JoinSink:
    """Counts the output rows and checks each morsel as it arrives: every
    row's rv is the build row's of its key, bit for bit; Σlv and Σrv in
    float64 for the end."""

    def __init__(self, rv_of_key):
        self.rv, self.rows, self.slv, self.srv, self.bad = rv_of_key, 0, \
            0.0, 0.0, 0

    def __call__(self, part):
        self.rows += len(part["k"])
        self.slv += float(part["lv"].astype(np.float64).sum())
        self.srv += float(part["rv"].astype(np.float64).sum())
        if not np.array_equal(part["rv"].view(np.int32),
                              self.rv[part["k"]].view(np.int32)):
            self.bad += 1


def oc_join_leg(M, ctx, probe, build_side, **kw):
    """``run(sink)`` streams the probe side through ``chunked_dist_join``
    into ``sink`` (a row counter when None); returns (rows, dropped)."""
    def run(sink=None):
        rows = [0]

        def count(part):
            rows[0] += len(part["k"])

        _, dropped = M.chunked_dist_join(ctx, probe, build_side,
                                         left_on=["k"], sink=sink or count,
                                         **kw)
        return (sink.rows if sink else rows[0]), dropped
    return run


def check_oc_join(leg, sink, dropped, left, right, want_rows):
    """Rows, drops, the per-row rv, and the sums within float32
    summation rounding (1e-6 of the summed magnitudes)."""
    lv = left["lv"][:want_rows].astype(np.float64)
    rv = right["rv"][left["k"][:want_rows]].astype(np.float64)
    errs = {"lv": abs(sink.slv - lv.sum()), "rv": abs(sink.srv - rv.sum())}
    tols = {"lv": 1e-6 * np.abs(lv).sum(), "rv": 1e-6 * np.abs(rv).sum()}
    if sink.rows != want_rows or int(dropped) != 0 or sink.bad \
            or any(errs[c] > tols[c] for c in errs):
        raise AssertionError(f"{leg}: {sink.rows} rows (want {want_rows}), "
                             f"dropped {int(dropped)}, {sink.bad} morsels "
                             f"with a wrong rv, sum errors {errs} > {tols}")
    return errs


def oc_groupby_want(left) -> dict:
    """numpy's groups of lv by k: float64 sums and magnitudes, int counts,
    float32 min and max."""
    k, v = left["k"], left["lv"]
    uniq = np.unique(k)
    nk = int(k.max()) + 1
    mins = np.full(nk, np.inf, np.float32)
    maxs = np.full(nk, -np.inf, np.float32)
    np.minimum.at(mins, k, v)
    np.maximum.at(maxs, k, v)
    w = v.astype(np.float64)
    return {"k": uniq.astype(np.int32),
            "sum": np.bincount(k, weights=w, minlength=nk)[uniq],
            "abs": np.bincount(k, weights=np.abs(w), minlength=nk)[uniq],
            "count": np.bincount(k, minlength=nk)[uniq].astype(np.int32),
            "min": mins[uniq], "max": maxs[uniq]}


def check_oc_groupby(leg, got, want) -> float:
    """Keys, counts, mins and maxs exactly; sums and means within
    float32 addition-order rounding (1e-6 of the group's summed
    magnitudes); returns the largest sum error."""
    if list(got) != ["k"] + [f"lv_{op}" for op in OC_AGGS["lv"]]:
        raise AssertionError(f"{leg}: columns {list(got)}")
    exact = {"k": "k", "lv_count": "count", "lv_min": "min",
             "lv_max": "max"}
    for c, w in exact.items():
        if got[c].dtype != want[w].dtype or not np.array_equal(
                got[c].view(np.int32), want[w].view(np.int32)):
            raise AssertionError(f"{leg}: {c} differs from numpy")
    tol = 1e-6 * want["abs"] + 1e-30
    serr = np.abs(got["lv_sum"].astype(np.float64) - want["sum"])
    merr = np.abs(got["lv_mean"].astype(np.float64)
                  - want["sum"] / want["count"]) * want["count"]
    if not (np.all(serr <= tol) and np.all(merr <= tol + 1e-7 * want["abs"])):
        raise AssertionError(f"{leg}: sums off by {serr.max()}, means by "
                             f"{merr.max()}")
    return float(serr.max())


def oc_counted(m, leg, run, device, legs, rows):
    """One counted run of an out-of-core leg, pinned to ``OC_LAUNCHES``;
    the leg is kept for the timing phase."""
    out, launches = counted_run(m, run, device)
    expect_launches(leg, launches, OC_LAUNCHES[leg])
    legs[leg] = dict(run=run, launches=launches, rows=rows, reps=OC_REPS)
    return out


def oc_recorders(m, leg):
    """What ``leg`` records of one morsel: (module, wrapper, picks, kernel)
    for each kernel held to its plain version at the leg's shapes.  The
    hash join: the build shuffle and the first probe morsel's
    (hash_partition), both sides' bucketing and the probe of the first
    probe morsel; the hash groupby: the last morsel's partial aggregate
    and its merge into the full accumulator; the sort: the first
    morsel's radix passes."""
    ops, n = m["ops"], OC_LAUNCHES[leg]
    if leg == "oc_join_hash":
        return [(m["D"], "radix_histogram_ranks", {0, 1}, "hash_partition"),
                (m["bucketing"], "fused_bucket_ranks", {0, 1},
                 "fused_bucketing"),
                (ops["hash_join"], "bucket_probe", {0}, "hash_join")]
    if leg == "oc_groupby_hash":
        k = n["hash_groupby"]
        return [(ops["hash_groupby"], "bucket_accumulate", {k - 2, k - 1},
                 "hash_groupby")]
    return [(ops["radix_sort"], "scatter_pass",
             range(n["radix_sort"] // (OC_ROWS // OC_CHUNK)), "radix_sort")]


@contextlib.contextmanager
def oc_recording(m, leg, cases: dict):
    """Context in which ``leg``'s wrappers record one morsel's arguments
    (:func:`oc_recorders`); on leaving, the calls are added to ``cases``
    as kernel cases (a scatter pass's ``keep_words`` dropped: the case
    keeps the words, which the plain version returns too)."""
    recs = oc_recorders(m, leg)
    calls = [[] for _ in recs]
    with contextlib.ExitStack() as stack:
        for (mod, fn, picks, _), kept in zip(recs, calls):
            stack.enter_context(recording(mod, fn, kept, picks))
        yield
    for (_, fn, _, kname), kept in zip(recs, calls):
        for j, args in enumerate(kept):
            if fn == "scatter_pass":
                args = args[:5]
            cases.setdefault(kname, []).append(dict(
                shape=f"{leg} {fn} #{j} {case_shape(kname, args)}",
                args=args))


def case_shape(kname, args) -> str:
    """A recorded call's shape, as the kernel cases name theirs."""
    if kname == "hash_partition":
        return f"n={args[0].numel()} P={args[1]}"
    if kname == "fused_bucketing":
        return f"n={args[1].numel()} K={len(args[0])} P={args[2]}"
    if kname == "radix_sort":
        return f"scatter n={args[1].numel()} bits={args[3]} shift={args[2]}"
    B, K, width = args[0].shape
    if kname == "hash_groupby":
        return f"B={B} K={K} V={args[2].shape[1]} C={width}"
    return f"B={B} K={K} Lc={width} C={args[2].shape[2]}"


def run_outofcore(m, ctx, device, tmpdir: Path):
    """The seven out-of-core legs, each driven once, counted and checked
    against numpy.  Returns the legs and, as kernel cases, the arguments
    the kernels received on one morsel of the hash join, the hash
    groupby and the sort (:func:`oc_recorders`)."""
    M, D = m["Mo"], m["D"]
    legs, cases = {}, {}
    left, right = oc_data(OC_ROWS)
    probe = M.ChunkedTable(left, OC_CHUNK)
    summary = {}

    for leg, src, kw in (
            ("oc_join_sortmerge", probe, {"local_impl": "sortmerge"}),
            ("oc_join_memmap",
             M.ChunkedTable(to_memmap(left, tmpdir), OC_CHUNK),
             {"local_impl": "sortmerge"})):
        run = oc_join_leg(M, ctx, src, right, **kw)
        sink = JoinSink(right["rv"])
        _, dropped = oc_counted(m, leg, lambda: run(sink), device, legs,
                                OC_ROWS)
        legs[leg]["run"] = run
        summary[leg] = {"chunks": src.num_chunks, "out_rows": sink.rows,
                        "sum_errors": check_oc_join(leg, sink, dropped, left,
                                                    right, OC_ROWS)}

    hprobe = M.ChunkedTable(left, OC_HASH_CHUNK)
    plan = D.plan_dist_join_sizes([hprobe.chunk(0)["k"]], [right["k"]],
                                  world=1, local_impl="hash")
    sizes = plan["local_join_sizes"]
    B, Lc, C = (sizes[k] for k in ("num_buckets", "probe_capacity",
                                   "bucket_capacity"))
    run = oc_join_leg(M, ctx, hprobe, right, local_impl="hash",
                      local_join_sizes=sizes)
    sink = JoinSink(right["rv"])
    with oc_recording(m, "oc_join_hash", cases):
        _, dropped = oc_counted(m, "oc_join_hash", lambda: run(sink), device,
                                legs, OC_ROWS)
    legs["oc_join_hash"]["run"] = run
    summary["oc_join_hash"] = {
        "chunks": hprobe.num_chunks, "out_rows": sink.rows,
        "B": B, "Lc": Lc, "C": C, "pairs": B * Lc * C,
        "sum_errors": check_oc_join("oc_join_hash", sink, dropped, left,
                                    right, OC_ROWS)}

    rl = {k: v[:OC_RESTREAM_ROWS] for k, v in left.items()}
    rprobe = M.ChunkedTable(rl, OC_RESTREAM_CHUNK)
    rbuild = M.ChunkedTable(right, OC_RESTREAM_CHUNK)
    run = oc_join_leg(M, ctx, rprobe, rbuild, build="restream",
                      local_impl="sortmerge")
    sink = JoinSink(right["rv"])
    _, dropped = oc_counted(m, "oc_join_restream", lambda: run(sink),
                            device, legs, OC_RESTREAM_ROWS)
    legs["oc_join_restream"]["run"] = run
    summary["oc_join_restream"] = {
        "chunks": [rprobe.num_chunks, rbuild.num_chunks],
        "joins": rprobe.num_chunks * rbuild.num_chunks,
        "out_rows": sink.rows,
        "sum_errors": check_oc_join("oc_join_restream", sink, dropped, left,
                                    right, OC_RESTREAM_ROWS)}

    # slabs for the hash groupby: a morsel's rows, and the merge's
    # accumulator plus a partial, where a key is at most twice
    uniq = np.unique(left["k"])
    bk = m["bucketing"]
    gsizes = {"num_buckets": GROUPBY_BUCKETS, "bucket_capacity": max(
        bk.plan_bucket_sizes([keys], num_buckets=GROUPBY_BUCKETS)[1]
        for keys in [np.concatenate([uniq, uniq])]
        + [c["k"] for c in probe.chunks()])}
    want = oc_groupby_want(left)
    for impl in ("hash", "sort"):
        leg = f"oc_groupby_{impl}"
        kw = dict(group_capacity_per_shard=OC_GROUP_CAP, local_impl=impl,
                  groupby_sizes=gsizes if impl == "hash" else None)
        run = (lambda kw=kw: M.chunked_dist_groupby(ctx, probe, ["k"],
                                                    OC_AGGS, **kw))
        with (oc_recording(m, leg, cases) if impl == "hash"
              else contextlib.nullcontext()):
            got, dropped = oc_counted(m, leg, run, device, legs, OC_ROWS)
        if int(dropped) != 0:
            raise AssertionError(f"{leg} dropped {int(dropped)}")
        summary[leg] = {"chunks": probe.num_chunks, "groups": len(got["k"]),
                        "sizes": kw["groupby_sizes"],
                        "max_sum_error": check_oc_groupby(leg, got, want)}

    run = (lambda: M.chunked_dist_sort(ctx, probe, ["k"],
                                       local_impl="radix"))
    with oc_recording(m, "oc_sort_radix", cases):
        got, dropped = oc_counted(m, "oc_sort_radix", run, device, legs,
                                  OC_ROWS)
    order = np.argsort(left["k"], kind="stable")
    if int(dropped) != 0 or not (
            np.array_equal(got["k"], left["k"][order])
            and np.array_equal(got["lv"].view(np.int32),
                               left["lv"][order].view(np.int32))):
        raise AssertionError("oc_sort_radix: not numpy's stable order of k")
    # the leg's two halves apart: each morsel's dist_sort collected to a
    # host run, then the host merge of the runs
    t0 = time.perf_counter()
    runs = [D.collect_table(ctx, D.dist_sort(ctx, g, ["k"],
                                             local_impl="radix")[0])
            for g in probe.distribute(ctx)]
    morsels_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    merged = M.merge_sorted_runs(runs, ["k"])
    merge_s = time.perf_counter() - t0
    if not all(np.array_equal(merged[c].view(np.int32),
                              got[c].view(np.int32)) for c in got):
        raise AssertionError("oc_sort_radix: the merged runs differ")
    summary["oc_sort_radix"] = {"chunks": probe.num_chunks,
                                "host_merge_s": merge_s,
                                "morsels_s": morsels_s}
    emit({"phase": "outofcore", "rows": OC_ROWS, "chunk_rows": OC_CHUNK,
          "dropped": 0, "equal_to_numpy": True, "legs": summary,
          "launches": {k: v["launches"] for k, v in legs.items()}})
    return legs, cases


# --------------------------------------------------------------------------
# UNOMT stage 4: DDP training of the drug-response net on the card
# --------------------------------------------------------------------------

TRAIN_STEPS, TRAIN_BATCH, CHECK_BATCH = 100, 32_768, 4_096
# one step on the card against the port on the CPU (float32 both, no
# TF32): the loss within TRAIN_LOSS_TOL * (1 + |loss|); an AdamW update
# on the same gradients within TRAIN_UPDATE_TOL * (1 + |p|).  Gradients:
# the float32 GEMMs add in other orders on the two devices, and a leaf's
# reduction over the batch cancels, so on 4096 rows of UNOMT features
# the CPU's own float32 gradients sit 2.3e-4 * max|g| from a float64
# evaluation (input.w, as this script records it), and the card's input.w
# 1.1e-4 * max|g| from the CPU's.  Each leaf on the card is held to a
# float64 evaluation on the CPU within TRAIN_GRAD_TOL * max|g64|, a few
# times the CPU's float32 error.  Two controls on the card must exceed
# it, and the run fails if one does not: TF32 matmuls (inputs rounded to
# 11 bits) and a step one batch row short read 6.8e-3 and 4.6e-3 on an
# H100 80GB HBM3 at 700 W.
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, TRAIN_UPDATE_TOL = 1e-5, 1e-3, 1e-6
GEMM_NAMES = ("gemm", "gemv", "cutlass", "xmma", "sm90_", "ampere_")


def loss_and_grads(N, cfg, params, batch):
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    loss, _ = N.mse_loss(leaves, cfg, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def check_train_on_cpu(m, cfg, params, batch) -> dict:
    """One step's loss and gradients on the card, with the port on the
    CPU and in float64 on the CPU; then an AdamW update on the same
    gradients on the card and on the CPU."""
    N, A = m["Un"], m["Aw"]
    cpu = torch.device("cpu")
    cparams = {k: v.cpu() for k, v in params.items()}
    cbatch = {k: v.cpu() for k, v in batch.items()}
    loss, grads = loss_and_grads(N, cfg, params, batch)
    closs, cgrads = loss_and_grads(N, cfg, cparams, cbatch)
    _, g64 = loss_and_grads(N, cfg, {k: v.double() for k, v in
                                     cparams.items()},
                            dict(cbatch, x=cbatch["x"].double(),
                                 y=cbatch["y"].double()))
    loss_err = abs(float(loss) - float(closs))

    def err(g, k):      # largest error against float64, / max|g64|
        return float((g.double().cpu() - g64[k]).abs().max()) \
            / max(float(g64[k].abs().max()), 1e-300)

    grad_err = {k: (err(grads[k], k), err(cgrads[k], k)) for k in g64}
    bad = {k: e for k, e in grad_err.items() if e[0] > TRAIN_GRAD_TOL}
    # the check's controls, on the card: TF32 matmuls, and a step that
    # leaves the batch's last valid row out (a product one row short)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = loss_and_grads(N, cfg, params, batch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    short = batch["mask"].clone()
    short[int(torch.nonzero(short > 0).max())] = 0
    controls = {}
    for what, (cl, cg) in (("tf32", tf32), ("row_left_out", loss_and_grads(
            N, cfg, params, dict(batch, mask=short)))):
        worst = max(g64, key=lambda k: err(cg[k], k))
        controls[what] = {"loss_err": abs(float(cl) - float(closs)),
                          "grad_err": err(cg[worst], worst), "leaf": worst}
        if controls[what]["grad_err"] <= TRAIN_GRAD_TOL:
            raise AssertionError(f"unomt_train: the gradient check misses "
                                 f"its {what} control: {controls[what]}")
    opt = A.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    dev = next(iter(params.values())).device
    new, _, _ = A.update(params, {k: g.to(dev) for k, g in cgrads.items()},
                         A.init(params, opt), opt)
    cnew, _, _ = A.update(cparams, cgrads, A.init(cparams, opt), opt)
    upd_err = max(float(((new[k].to(cpu) - v).abs() / (1 + v.abs())).max())
                  for k, v in cnew.items())
    if not (loss_err <= TRAIN_LOSS_TOL * (1 + abs(float(closs)))
            and not bad and upd_err <= TRAIN_UPDATE_TOL):
        raise AssertionError(f"unomt_train: card vs CPU loss {loss_err}, "
                             f"gradients (card, CPU) against float64 "
                             f"{bad}, update {upd_err}")
    card_vs_cpu = {k: float((grads[k].cpu() - g).abs().max())
                   / max(float(g.abs().max()), 1e-30)
                   for k, g in cgrads.items()}
    return {"loss": float(closs), "loss_err": loss_err,
            "grad_err_vs_float64": grad_err,
            "grad_card_vs_cpu_max": max(card_vs_cpu.values()),
            "update_err": upd_err, "controls": controls}


def profile_step(fn, top=6):
    """One warmed call of ``fn`` under torch.profiler: device ms of the
    GEMM kernels and of the rest (elementwise, reductions, copies)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    gemm = [e for e in kernels
            if any(g in e.key.lower() for g in GEMM_NAMES)]
    rest = [e for e in kernels if e not in gemm]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return {"gemm_ms": sum(e.self_device_time_total for e in gemm) / 1e3,
            "gemm_launches": sum(e.count for e in gemm),
            "other_ms": sum(e.self_device_time_total for e in rest) / 1e3,
            "other_launches": sum(e.count for e in rest),
            "top_kernels": [{"name": e.key[:80], "count": e.count,
                             "device_ms": e.self_device_time_total / 1e3}
                            for e in kernels[:top]]}


def run_unomt_train(m, ctx, device, X, y, mask, n, name):
    """UNOMT stage 4 on the UNOMT leg's features: 100 DDP steps of
    32 768 rows in order, exact and int8-compressed, with dropout; the
    loss must fall in both.  Then one step on the card against the CPU,
    and the step's time, memory and profile.  Returns the leg."""
    N, A, Cp, R = m["Un"], m["Aw"], m["Cp"], m["Rd"]
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; the net runs float32")
    if n < TRAIN_STEPS * TRAIN_BATCH:
        raise AssertionError(f"unomt_train: {n} valid rows are fewer than "
                             f"{TRAIN_STEPS} batches")
    cfg = N.UnomtNetConfig(n_features=X.shape[1])
    opt = A.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=TRAIN_STEPS)
    runs, launches = {}, None
    for compress in (False, True):
        params = N.init(torch.Generator(device).manual_seed(0), cfg)
        gen = torch.Generator(device).manual_seed(1)
        step = R.make_ddp_train_step(
            lambda p, b: N.mse_loss(p, cfg, b, train=True, generator=gen),
            opt, ctx, compress=compress)
        state = (params, A.init(params, opt), Cp.init_residuals(params))

        def train():
            nonlocal state
            losses = []
            for i in range(TRAIN_STEPS):
                rows = slice(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH)
                *state, met = step(*state, {"x": X[rows], "y": y[rows],
                                            "mask": mask[rows]})
                losses.append(met["loss"])
            return [float(v) for v in torch.stack(losses).cpu()]

        t0 = time.perf_counter()
        losses, lc = counted_run(m, train, device)
        seconds = time.perf_counter() - t0
        expect_launches(f"unomt_train/{compress}", lc, {})
        launches = lc
        first, last = np.mean(losses[:10]), np.mean(losses[-10:])
        if not last < first:
            raise AssertionError(f"unomt_train compress={compress}: loss "
                                 f"{first} -> {last} did not fall")
        batch = {"x": X[:TRAIN_BATCH], "y": y[:TRAIN_BATCH],
                 "mask": mask[:TRAIN_BATCH]}
        st = tuple(state)
        step_ms = event_ms(lambda: step(*st, batch), reps=10)
        torch.cuda.reset_peak_memory_stats(device)
        resident = torch.cuda.memory_allocated(device)
        step(*st, batch)
        _sync(device)
        runs[f"compress={compress}"] = {
            "seconds": seconds, "loss_first10": first, "loss_last10": last,
            "step_ms": step_ms, "samples_per_s": TRAIN_BATCH / step_ms * 1e3,
            "peak_bytes_above_resident":
                torch.cuda.max_memory_allocated(device) - resident,
            "profile": profile_step(lambda: step(*st, batch))}
    params = N.init(torch.Generator(device).manual_seed(0),
                    dataclasses.replace(cfg, dropout=0.0))
    check = check_train_on_cpu(m, dataclasses.replace(cfg, dropout=0.0),
                               params, {"x": X[:CHECK_BATCH],
                                        "y": y[:CHECK_BATCH],
                                        "mask": mask[:CHECK_BATCH]})
    emit({"phase": "unomt_train", "card": name, "rows": n,
          "steps": TRAIN_STEPS, "batch": TRAIN_BATCH,
          "net": dataclasses.asdict(cfg), "allow_tf32": False,
          "params": sum(p.numel() for p in params.values()),
          "runs": runs, "card_vs_cpu": check,
          "tolerances": {"loss": TRAIN_LOSS_TOL, "grad": TRAIN_GRAD_TOL,
                         "update": TRAIN_UPDATE_TOL}})
    return {"unomt_train": dict(launches=launches, rows=n)}


# --------------------------------------------------------------------------
# LM training: lm100m, the two restart drills, Falcon-Mamba at full width
# --------------------------------------------------------------------------

LM_ARCH = "lm100m"              # full width and depth
LM_STEPS, LM_BATCH, LM_SEQ, LM_TIMED = 50, 8, 512, 40
LM_FIT_STEPS = 20               # then the next batch, repeated
LM_CHECK_BATCH = 2              # rows of the card-vs-CPU step
# the first step on the card against the same step of the port on the
# CPU, from the same float32 masters and batch: the port's tolerances
# against the reference (tests/test_torch_lm_train.py), bf16 products
# with float32 sums in other orders on the two devices
LM_LOSS_RTOL, LM_GNORM_RTOL = 2e-3, 2e-2
# a checkpoint every 20 (every 10 took 43-64 s, most of it the 1.66 GB
# writes; the script must end within 1 200 s)
DRILL_STEPS, DRILL_EVERY, DRILL_FAIL = 40, 20, 23
UNOMT_DRILL_STEPS, UNOMT_DRILL_EVERY, UNOMT_DRILL_FAIL = 100, 25, 50
# Falcon-Mamba-7B at full width, 2 of its 64 layers (all 64 need about
# 116 GB of float32 masters, gradients and moments); one row of 1000
# tokens, no multiple of the 128-step scan chunk, so one microbatch (its
# TrainSettings' 2 need two rows)
MAMBA_TRAIN_LAYERS, MAMBA_TRAIN_BATCH, MAMBA_TRAIN_SEQ = 2, 1, 1000
MAMBA_TRAIN_STEPS = 5
# its first step's loss and grad norm, which mamba_train_tp2 is held to
MAMBA_TRAIN_WORLD1 = "mamba_train_world1.json"
# Granite-3.0-MoE-3B-A800M at full width (40 experts of 512 padded to 48,
# top-8), MOE_TRAIN_LAYERS of its 32 layers: a layer's float32 master,
# gradient and two AdamW moments take 1.91 GB, and a layer's recompute
# and backward hold (T, E, d) float32 products of 1 GB at 4 x 1024
# tokens.  While AdamW held its new parameters and moments beside the
# old, 16 layers did not fit in 80 GB; at 12 a step that keeps the old
# state peaked 36.9 GB above 18.2 GB resident, one that writes in place
# 18.7 GB (H100 80GB HBM3, 700 W), about 3.05 GB a layer in all, so 16
# take ~49 GB beside the ~6 GB the earlier phases keep resident.  The
# first step's loss and moe_aux are
# held to the CPU on MOE_CHECK_LAYERS layers and 1 x MOE_CHECK_SEQ
# tokens, which the CPU runs in seconds
MOE_TRAIN_LAYERS, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 16, 4, 1024
MOE_TRAIN_STEPS = 5
MOE_CHECK_LAYERS, MOE_CHECK_SEQ = 2, 128


def lm_batch(m, cfg, step, batch, seq, device):
    b = m["Sy"].lm_batch_at(step, vocab=cfg.vocab, batch=batch, seq=seq)
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) \
        if torch.device(device).type == "cuda" else 0


def _reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def event_pair():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def timed_steps(step, params, opt, batches, aux=None, norms=None):
    """``step`` over ``batches`` in order, each between two CUDA events.
    Returns (params, opt, losses, ms per step); ``aux`` and ``norms``,
    when given, get each step's ``moe_aux`` and ``grad_norm``."""
    mets, events = [], []
    for b in batches:
        ev = event_pair()
        ev[0].record()
        params, opt, met = step(params, opt, b)
        ev[1].record()
        mets.append(met)
        events.append(ev)
    torch.cuda.synchronize()
    if aux is not None:
        aux.extend(float(met["moe_aux"]) for met in mets)
    if norms is not None:
        norms.extend(float(met["grad_norm"]) for met in mets)
    return (params, opt, [float(met["loss"]) for met in mets],
            [a.elapsed_time(b) for a, b in events])


def rel_err(got, want) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def lm_step_on_cpu(m, cfg, params, batch, opt_cfg) -> dict:
    """The first train step from ``params`` on ``batch`` on the card and
    the same step of the port on the CPU: loss and grad norm within
    LM_LOSS_RTOL and LM_GNORM_RTOL."""
    M, A, Ck = m["M"], m["Aw"], m["Ck"]
    cpu = torch.device("cpu")
    out = {}
    for where, p, b in (
            ("card", params, batch),
            ("cpu", Ck.tree_map(lambda t: t.to(cpu), params),
             {k: v.to(cpu) for k, v in batch.items()})):
        t0 = time.perf_counter()
        _, _, met = M.make_train_step(cfg, None, opt_cfg)(
            p, A.init(A.flatten_params(p), opt_cfg), b)
        out[where] = {"loss": float(met["loss"]),
                      "grad_norm": float(met["grad_norm"]),
                      "seconds": time.perf_counter() - t0}
    out["loss_rel_err"] = rel_err(out["card"]["loss"], out["cpu"]["loss"])
    out["grad_norm_rel_err"] = rel_err(out["card"]["grad_norm"],
                                       out["cpu"]["grad_norm"])
    if not (out["loss_rel_err"] <= LM_LOSS_RTOL
            and out["grad_norm_rel_err"] <= LM_GNORM_RTOL):
        raise AssertionError(f"lm_train: card vs CPU {out}")
    return out


def run_lm_train(m, device, name, tmpdir: Path):
    """lm100m at full width and depth from float32 masters (seed 0),
    remat ``full``, ``AdamWConfig(lr=3e-4, total_steps=LM_STEPS)``:
    LM_STEPS steps on ``lm_batch_at(0..)`` of LM_BATCH x LM_SEQ tokens in
    order, then LM_FIT_STEPS steps on the next batch repeated, whose loss
    must fall.  The steps in order are timed and their losses printed,
    not held: each batch is new, and on these batches the loss of the
    randomly initialised model rises for the first hundreds of steps
    under every warm-up tried (``tools/lm_schedule_probe.py``).  The
    first step is held to the CPU; step times by CUDA events (the median
    of the last LM_TIMED in order), tokens/s, peak memory, one profiled
    step and one asynchronous checkpoint of the final state, timed."""
    wall = time.perf_counter()
    M, A = m["M"], m["Aw"]
    cfg = m["get_config"](LM_ARCH)
    if cfg.train.remat != "full":
        raise AssertionError(f"lm_train: remat {cfg.train.remat!r}")
    params = M.init_params(torch.Generator(device).manual_seed(0), cfg,
                           master=True)
    opt_cfg = A.AdamWConfig(lr=3e-4, total_steps=LM_STEPS)
    check = lm_step_on_cpu(m, cfg, params, lm_batch(
        m, cfg, 0, LM_CHECK_BATCH, LM_SEQ, device), opt_cfg)
    step = M.make_train_step(cfg, None, opt_cfg)
    opt = A.init(A.flatten_params(params), opt_cfg)
    batches = [lm_batch(m, cfg, s, LM_BATCH, LM_SEQ, device)
               for s in range(LM_STEPS)]
    batches += [lm_batch(m, cfg, LM_STEPS, LM_BATCH, LM_SEQ,
                         device)] * LM_FIT_STEPS
    _sync(device)
    _reset_peak(device)
    resident = _allocated(device)
    t0 = time.perf_counter()
    (params, opt, losses, ms), launches = counted_run(
        m, lambda: timed_steps(step, params, opt, batches), device)
    seconds = time.perf_counter() - t0
    expect_launches("lm_train", launches, {})
    peak = _peak(device) - resident
    losses, fit = losses[:LM_STEPS], losses[LM_STEPS:]
    step_ms = float(np.median(ms[LM_STEPS - LM_TIMED:LM_STEPS]))
    prof = profile_step(lambda: step(params, opt, batches[0]))
    ckpt = m["Ck"].AsyncCheckpointer(str(tmpdir / "lm_ckpt"), keep_last=1)
    t0 = time.perf_counter()
    ckpt.save(LM_STEPS + LM_FIT_STEPS, (params, opt))
    copy_s = time.perf_counter() - t0
    ckpt.wait()
    write_s = time.perf_counter() - t0 - copy_s
    emit({"phase": "lm_train", "card": name,
          "wall_s": time.perf_counter() - wall, "arch": cfg.name,
          "params": sum(p.numel() for p in
                        A.flatten_params(params).values()),
          "steps": LM_STEPS, "fit_steps": LM_FIT_STEPS, "batch": LM_BATCH,
          "seq": LM_SEQ, "remat": cfg.train.remat, "seconds": seconds,
          "step_ms_median_last": step_ms, "timed_steps": LM_TIMED,
          "step_ms": ms, "tokens_per_s": LM_BATCH * LM_SEQ / step_ms * 1e3,
          "peak_bytes_above_resident": peak, "resident_bytes": resident,
          "loss_first": losses[0], "loss_last": losses[-1],
          "loss_first10": float(np.mean(losses[:10])),
          "loss_last10": float(np.mean(losses[-10:])),
          "losses": losses, "fit_losses": fit, "profile": prof,
          "gemm_share": prof["gemm_ms"]
          / max(prof["gemm_ms"] + prof["other_ms"], 1e-9),
          "checkpoint": {"host_copy_s": copy_s, "write_s": write_s,
                         "bytes": sum(f.stat().st_size for f in
                                      (tmpdir / "lm_ckpt").rglob("*")
                                      if f.is_file())},
          "card_vs_cpu": check, "card_vs_cpu_batch": LM_CHECK_BATCH,
          "tolerances": {"loss_rel": LM_LOSS_RTOL,
                         "grad_norm_rel": LM_GNORM_RTOL}})
    if not fit[-1] < fit[0]:
        raise AssertionError(f"lm_train: the loss of one batch, repeated, "
                             f"went {fit[0]} -> {fit[-1]}: it did not fall")
    return {"lm_train": dict(launches=launches,
                             rows=(LM_STEPS + LM_FIT_STEPS) * LM_BATCH)}


def _final_arrays(path: Path) -> list:
    with np.load(path / "arrays.npz") as f:
        return [f[f"a{i}"] for i in range(len(f.files))]


def same_bits(a, b) -> bool:
    """Two lists of arrays (or tensors) equal bit for bit."""
    def raw(x):
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else x
        return np.ascontiguousarray(x).reshape(-1).view(np.uint8)

    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and np.array_equal(raw(x), raw(y)) for x, y in zip(a, b))


def same_history(plain, failed) -> bool:
    """The restarted run's records are the plain run's last ones."""
    keys = ("loss", "grad_norm", "lr")
    return len(failed) > 0 and [[h[k] for k in keys] for h in failed] == \
        [[h[k] for k in keys] for h in plain[-len(failed):]]


def run_lm_drill(m, device, name, tmpdir: Path):
    """``launch.train.main`` on lm100m: DRILL_STEPS steps, a checkpoint
    every DRILL_EVERY, once plainly and once with ``--fail-at
    DRILL_FAIL``; the restarted run must end bit-identical (every
    parameter and AdamW moment of the last checkpoint) and with the same
    records."""
    wall = time.perf_counter()
    argv = ["--arch", LM_ARCH, "--steps", str(DRILL_STEPS),
            "--batch", str(LM_BATCH), "--seq", str(LM_SEQ),
            "--log-every", "0", "--device", torch.device(device).type]
    runs = {}

    def drill():
        # the plain run checkpoints only its last step, which the restarted
        # run's last checkpoint is held to
        for what, extra in (("plain", ["--ckpt-every", str(DRILL_STEPS)]),
                            ("failed", ["--ckpt-every", str(DRILL_EVERY),
                                        "--fail-at", str(DRILL_FAIL)])):
            d = tmpdir / f"lm_drill_{what}"
            t0 = time.perf_counter()
            hist = m["Tr"].main(argv + ["--ckpt-dir", str(d)] + extra)
            runs[what] = dict(history=hist, dir=d,
                              seconds=time.perf_counter() - t0)

    _, launches = counted_run(m, drill, device)
    expect_launches("lm_drill", launches, {})
    final = [_final_arrays(runs[w]["dir"] / f"step_{DRILL_STEPS}")
             for w in ("plain", "failed")]
    identical = same_bits(*final)
    same = same_history(runs["plain"]["history"], runs["failed"]["history"])
    emit({"phase": "lm_drill", "card": name,
          "wall_s": time.perf_counter() - wall, "arch": LM_ARCH,
          "steps": DRILL_STEPS, "ckpt_every": DRILL_EVERY,
          "fail_at": DRILL_FAIL, "leaves": len(final[0]),
          "checkpoint_bytes": (runs["plain"]["dir"] / f"step_{DRILL_STEPS}"
                               / "arrays.npz").stat().st_size,
          "seconds": {w: r["seconds"] for w, r in runs.items()},
          "restarted_records": len(runs["failed"]["history"]),
          "bit_identical": identical, "same_records": same,
          "deterministic_algorithms":
              torch.are_deterministic_algorithms_enabled()})
    if not (identical and same):
        raise AssertionError("lm_drill: the restarted run differs from the "
                             "plain one")
    for r in runs.values():
        shutil.rmtree(r["dir"])
    return {"lm_drill": dict(launches=launches,
                             rows=2 * DRILL_STEPS * LM_BATCH)}


def run_unomt_drill(m, ctx, device, X, y, mask, n, name, tmpdir: Path):
    """``launch.unomt_e2e.train_stage`` on the UNOMT leg's features:
    UNOMT_DRILL_STEPS steps of TRAIN_BATCH rows, a checkpoint every
    UNOMT_DRILL_EVERY, once plainly and once with a failure at
    UNOMT_DRILL_FAIL; the restarted run must end with the same
    (params, opt, residuals) bit for bit and the same records.  Then an
    ``AsyncCheckpointer`` write of the state, its host copy and its
    thread timed apart."""
    wall = time.perf_counter()
    E, Ck = m["Ue"], m["Ck"]
    if n < TRAIN_BATCH:
        raise AssertionError(f"unomt_drill: {n} valid rows")
    runs = {}

    def drill():
        for what, fail in (("plain", None), ("failed", UNOMT_DRILL_FAIL)):
            t0 = time.perf_counter()
            state, hist = E.train_stage(
                ctx, X, y, mask, steps=UNOMT_DRILL_STEPS,
                ckpt_dir=str(tmpdir / f"unomt_drill_{what}"),
                batch_rows=TRAIN_BATCH, ckpt_every=UNOMT_DRILL_EVERY,
                fail_at=fail, log_every=0)
            runs[what] = dict(state=state, history=hist,
                              seconds=time.perf_counter() - t0)

    _, launches = counted_run(m, drill, device)
    expect_launches("unomt_drill", launches, {})
    leaves = [Ck.tree_leaves(runs[w]["state"]) for w in ("plain", "failed")]
    identical = same_bits(*leaves)
    same = same_history(runs["plain"]["history"], runs["failed"]["history"])
    writes = []
    ckpt = Ck.AsyncCheckpointer(str(tmpdir / "unomt_ckpt"), keep_last=1)
    for i in range(3):
        t0 = time.perf_counter()
        ckpt.save(i, runs["plain"]["state"])
        t1 = time.perf_counter()
        ckpt.wait()
        writes.append({"host_copy_s": t1 - t0,
                       "thread_s": time.perf_counter() - t1})
    emit({"phase": "unomt_drill", "card": name,
          "wall_s": time.perf_counter() - wall,
          "steps": UNOMT_DRILL_STEPS, "batch": TRAIN_BATCH,
          "ckpt_every": UNOMT_DRILL_EVERY, "fail_at": UNOMT_DRILL_FAIL,
          "seconds": {w: r["seconds"] for w, r in runs.items()},
          "loss_first_last": [runs["plain"]["history"][0]["loss"],
                              runs["plain"]["history"][-1]["loss"]],
          "restarted_records": len(runs["failed"]["history"]),
          "bit_identical": identical, "same_records": same,
          "state_bytes": sum(t.numel() * t.element_size()
                             for t in leaves[0]),
          "checkpoint_writes": writes,
          "deterministic_algorithms":
              torch.are_deterministic_algorithms_enabled()})
    if not (identical and same):
        raise AssertionError("unomt_drill: the restarted run differs from "
                             "the plain one")
    return {"unomt_drill": dict(launches=launches,
                                rows=2 * UNOMT_DRILL_STEPS * TRAIN_BATCH)}


def mamba_loss_on_cpu(m, cfg, params, batch) -> float:
    """The port's loss on the CPU (no gradients; the plain scan),
    averaged over the microbatches as the train step averages it."""
    M, Ck = m["M"], m["Ck"]
    cpu = torch.device("cpu")
    p = Ck.tree_map(lambda t: t.to(cpu), params)
    n = max(1, cfg.train.microbatches)
    rows = MAMBA_TRAIN_BATCH // n
    loss_fn = M.make_loss_fn(cfg, None, M.StackOpts(attn_impl="xla",
                                              mamba_impl="xla"))
    with torch.no_grad():
        return float(np.mean([float(loss_fn(p, {
            k: v[i * rows:(i + 1) * rows].to(cpu)
            for k, v in batch.items()})[1]["loss"]) for i in range(n)]))


def run_mamba_train(m, device, name, tmpdir: Path | None = None):
    """Falcon-Mamba-7B at full width, MAMBA_TRAIN_LAYERS layers:
    MAMBA_TRAIN_STEPS steps on one batch of MAMBA_TRAIN_BATCH x
    MAMBA_TRAIN_SEQ tokens through the chunked scan's forward and
    backward; its loss must fall (five warm-up steps learn less than one
    batch differs from the next), and the first step's is held to the
    CPU within LM_LOSS_RTOL.  With ``tmpdir`` the first step's loss and
    grad norm are written there for ``mamba_train_tp2``."""
    wall = time.perf_counter()
    M, A = m["M"], m["Aw"]
    full = m["get_config"](MAMBA_ARCH)
    cfg = dataclasses.replace(
        full, n_layers=MAMBA_TRAIN_LAYERS,
        train=dataclasses.replace(full.train, microbatches=1))
    params = M.init_params(torch.Generator(device).manual_seed(0), cfg,
                           master=True)
    opt_cfg = A.AdamWConfig(lr=3e-4, total_steps=MAMBA_TRAIN_STEPS)
    step = M.make_train_step(cfg, None, opt_cfg)
    opt = A.init(A.flatten_params(params), opt_cfg)
    batches = [lm_batch(m, cfg, 0, MAMBA_TRAIN_BATCH, MAMBA_TRAIN_SEQ,
                        device)] * MAMBA_TRAIN_STEPS
    t0 = time.perf_counter()
    cpu_loss = mamba_loss_on_cpu(m, cfg, params, batches[0])
    cpu_s = time.perf_counter() - t0
    _sync(device)
    _reset_peak(device)
    resident = _allocated(device)
    norms = []
    (params, opt, losses, ms), launches = counted_run(
        m, lambda: timed_steps(step, params, opt, batches, norms=norms),
        device)
    expect_launches("mamba_train", launches, {})
    if tmpdir is not None:
        (tmpdir / MAMBA_TRAIN_WORLD1).write_text(json.dumps(
            {"loss": losses[0], "grad_norm": norms[0]}))
    peak = _peak(device) - resident
    err = rel_err(losses[0], cpu_loss)
    emit({"phase": "mamba_train", "card": name,
          "wall_s": time.perf_counter() - wall, "arch": cfg.name,
          "layers": cfg.n_layers, "of_layers": full.n_layers,
          "d_model": cfg.d_model,
          "d_inner": cfg.d_inner, "params": sum(
              p.numel() for p in A.flatten_params(params).values()),
          "batch": MAMBA_TRAIN_BATCH, "seq": MAMBA_TRAIN_SEQ,
          "microbatches": cfg.train.microbatches,
          "steps": MAMBA_TRAIN_STEPS,
          "step_ms": ms, "step_ms_median_after_first":
              float(np.median(ms[1:])),
          "tokens_per_s": MAMBA_TRAIN_BATCH * MAMBA_TRAIN_SEQ
          / float(np.median(ms[1:])) * 1e3,
          "peak_bytes_above_resident": peak, "resident_bytes": resident,
          "losses": losses, "grad_norms": norms,
          "cpu_loss_first": cpu_loss,
          "cpu_seconds": cpu_s, "loss_rel_err": err,
          "tolerance": LM_LOSS_RTOL})
    if not losses[-1] < losses[0]:
        raise AssertionError(f"mamba_train: loss {losses[0]} -> "
                             f"{losses[-1]} did not fall")
    if not err <= LM_LOSS_RTOL:
        raise AssertionError(f"mamba_train: first loss {losses[0]} vs the "
                             f"CPU's {cpu_loss}")
    del params, opt, batches
    _free(device)
    return {"mamba_train": dict(launches=launches,
                                rows=MAMBA_TRAIN_STEPS * MAMBA_TRAIN_BATCH)}


def no_tf32(leg: str) -> None:
    """The MoE router's float32 product must not run in TF32 (ten
    mantissa bits would move its top-k choices)."""
    if torch.backends.cuda.matmul.allow_tf32 \
            or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError(f"{leg}: float32 products run in TF32")


def moe_step_on_cpu(m, full, device, opt_cfg) -> dict:
    """The first train step of ``full`` cut to MOE_CHECK_LAYERS layers, on
    1 x MOE_CHECK_SEQ tokens, on the card, and the port's loss on the CPU
    from the same float32 masters and batch: loss and moe_aux within
    LM_LOSS_RTOL."""
    M, A, Ck = m["M"], m["Aw"], m["Ck"]
    cfg = dataclasses.replace(full, n_layers=MOE_CHECK_LAYERS)
    params = M.init_params(torch.Generator(device).manual_seed(0), cfg,
                           master=True)
    batch = lm_batch(m, cfg, 0, 1, MOE_CHECK_SEQ, device)
    _, _, met = M.make_train_step(cfg, None, opt_cfg)(
        params, A.init(A.flatten_params(params), opt_cfg), batch)
    out = {"layers": MOE_CHECK_LAYERS, "tokens": MOE_CHECK_SEQ,
           "card": {"loss": float(met["loss"]),
                    "moe_aux": float(met["moe_aux"])}}
    cpu = torch.device("cpu")
    loss_fn = M.make_loss_fn(cfg, None, M.StackOpts(attn_impl="xla",
                                              mamba_impl="xla"))
    t0 = time.perf_counter()
    with torch.no_grad():
        _, cm = loss_fn(Ck.tree_map(lambda t: t.to(cpu), params),
                        {k: v.to(cpu) for k, v in batch.items()})
    out["cpu"] = {"loss": float(cm["loss"]), "moe_aux": float(cm["moe_aux"]),
                  "seconds": time.perf_counter() - t0}
    for k in ("loss", "moe_aux"):
        out[f"{k}_rel_err"] = rel_err(out["card"][k], out["cpu"][k])
    if not (out["loss_rel_err"] <= LM_LOSS_RTOL
            and out["moe_aux_rel_err"] <= LM_LOSS_RTOL):
        raise AssertionError(f"moe_train: card vs CPU {out}")
    return out


def run_moe_train(m, device, name):
    """Granite-3.0-MoE at full width, MOE_TRAIN_LAYERS layers, remat
    ``full``: MOE_TRAIN_STEPS steps on one batch of MOE_TRAIN_BATCH x
    MOE_TRAIN_SEQ tokens repeated, whose loss must fall; every MoE layer
    runs all 40 experts on every token (``moe_dense``, as the reference
    at world 1) and the auxiliary loss enters the total.  The first step
    of a shallower model is held to the CPU (:func:`moe_step_on_cpu`);
    step ms by CUDA events, tokens/s, peak memory, one profiled step."""
    wall = time.perf_counter()
    M, A = m["M"], m["Aw"]
    no_tf32("moe_train")
    full = m["get_config"](MOE_ARCH)
    if full.train.remat != "full":
        raise AssertionError(f"moe_train: remat {full.train.remat!r}")
    opt_cfg = A.AdamWConfig(lr=3e-4, warmup_steps=1,
                            total_steps=MOE_TRAIN_STEPS)
    check = moe_step_on_cpu(m, full, device, opt_cfg)
    _free(device)
    cfg = dataclasses.replace(full, n_layers=MOE_TRAIN_LAYERS)
    params = M.init_params(torch.Generator(device).manual_seed(0), cfg,
                           master=True)
    # AdamW writes the new state into the old (as launch/train.py)
    step = M.make_train_step(cfg, None, opt_cfg, donate=True)
    opt = A.init(A.flatten_params(params), opt_cfg)
    batches = [lm_batch(m, cfg, 0, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ,
                        device)] * MOE_TRAIN_STEPS
    _sync(device)
    _reset_peak(device)
    resident = _allocated(device)
    aux = []
    (params, opt, losses, ms), launches = counted_run(
        m, lambda: timed_steps(step, params, opt, batches, aux), device)
    expect_launches("moe_train", launches, {})
    peak = _peak(device) - resident
    # one step that leaves the old state as it was: the old and the new
    # state side by side, as every step held them before AdamW could
    # write in place
    _sync(device)
    _reset_peak(device)
    M.make_train_step(cfg, None, opt_cfg)(params, opt, batches[0])
    _sync(device)
    peak_copying = _peak(device) - resident
    _free(device)
    prof = profile_step(lambda: step(params, opt, batches[0]))
    step_ms = float(np.median(ms[1:]))
    emit({"phase": "moe_train", "card": name,
          "wall_s": time.perf_counter() - wall, "arch": cfg.name,
          "layers": cfg.n_layers, "of_layers": full.n_layers,
          "d_model": cfg.d_model, "experts": cfg.n_experts,
          "experts_padded": m["Moe"].n_experts_padded(cfg),
          "top_k": cfg.top_k, "params": sum(
              p.numel() for p in A.flatten_params(params).values()),
          "batch": MOE_TRAIN_BATCH, "seq": MOE_TRAIN_SEQ,
          "remat": cfg.train.remat, "steps": MOE_TRAIN_STEPS,
          "step_ms": ms, "step_ms_median_after_first": step_ms,
          "tokens_per_s": MOE_TRAIN_BATCH * MOE_TRAIN_SEQ / step_ms * 1e3,
          "peak_bytes_above_resident": peak, "resident_bytes": resident,
          "peak_bytes_above_resident_copying_step": peak_copying,
          "losses": losses, "moe_aux": aux, "profile": prof,
          "gemm_share": prof["gemm_ms"]
          / max(prof["gemm_ms"] + prof["other_ms"], 1e-9),
          "card_vs_cpu": check, "tolerance": LM_LOSS_RTOL})
    if not losses[-1] < losses[0]:
        raise AssertionError(f"moe_train: loss {losses[0]} -> "
                             f"{losses[-1]} did not fall")
    del params, opt, batches
    _free(device)
    return {"moe_train": dict(launches=launches,
                              rows=MOE_TRAIN_STEPS * MOE_TRAIN_BATCH)}


# --------------------------------------------------------------------------
# sharded training: data=2 x model=2 ranks on the one card
# --------------------------------------------------------------------------

# Granite-3.0-MoE at full width over a (data=2, model=2) mesh: four rank
# processes on the one card (gloo, every exchange staged through pinned
# host memory: NCCL refuses two ranks on one device), the config's own
# ``tp`` flavor, remat full, MESH_TRAIN_STEPS steps on one 4 x 1024 batch
# repeated (2 x 1024 rows a data rank, 1024 tokens x top-8 = n 8192 ids a
# model rank's dispatch plan, P 40), MESH_TRAIN_LAYERS of the 32 layers:
# at 12, while a step held the old and the new state side by side, four
# ranks beside this process's kernel cases ran out of the card's 79.18
# GiB; 8 took 146 s of the script, and with the data=2 serving phase the
# script must still end within 1 200 s, so 4.  First the checks, on
# MESH_CHECK_LAYERS layers and
# MESH_CHECK_ROWS x 1024 rows a data rank at capacity factor E / top_k,
# where no row drops
MESH_TRAIN = {"data": 2, "model": 2}
MESH_TRAIN_LAYERS = 4
# 2 steps, not 5: the script must end within 1 200 s (3 until the pod
# legs took the script to 1 116 s of command; the third step took 4.08 s,
# H100 80GB HBM3, 700 W)
MESH_TRAIN_BATCH, MESH_TRAIN_SEQ, MESH_TRAIN_STEPS = 4, 1024, 2
MESH_CHECK_LAYERS, MESH_CHECK_ROWS = 2, 1
# the leaf rule of tests/test_torch_lm_train.py for one AdamW step, with
# its floor on the gradients counted (SIGN_G, 200 AdamW eps)
M_RTOL, V_RTOL = 1e-2, 2e-2
SURE_FRAC, STEP_TOL, LOOSE_SHARE, SIGN_G = 0.05, 1e-3, 0.02, 2e-6
# lm100m through launch.train.main --mesh data=2,model=2, one row of 512
# tokens a data rank, 4 steps, a checkpoint every 2, so that the restart
# resumes from a trained state: 20 steps of 8 rows took 298 s for the
# two runs, 20 of 2 rows 200 s, 10 of 2 rows 123-165 s, 6 of 2 rows 135 s
# and 4 of 2 rows 160-177 s: every exchange and checkpoint gather goes
# through the host, and the script must end within 1 200 s
DRILL_MESH_STEPS, DRILL_MESH_EVERY, DRILL_MESH_FAIL = 4, 2, 3
DRILL_MESH_BATCH = 2


def _share(got, want) -> float:
    """The largest difference as a share of ``want``'s largest
    magnitude."""
    return float((got - want).abs().max()) \
        / max(float(want.abs().max()), 1e-30)


def leaf_rule(got: dict, want: dict, lr: float, device,
              noise=None) -> dict:
    """tests/test_torch_lm_train.py's rule for one step, on {leaf: tensor}
    dicts of the new parameters and the moments (``new``, ``m``, ``v``),
    each leaf compared on ``device``: moments within M_RTOL / V_RTOL of
    the leaf's largest, parameters within 2 lr + 1e-6; of the elements
    whose gradient is at least SIGN_G (the rule's branch for gradients
    near AdamW's eps, where a first step is lr g / (|g| + eps) and lr
    sign(g) only for |g| >> eps), those at least SURE_FRAC of the leaf's
    largest within STEP_TOL lr and at most LOOSE_SHARE beyond it.  At
    full width most elements' clipped gradients lie within a few eps
    (the loose share over all elements is reported beside).  With
    ``noise`` ({(moment, leaf): share}) a moment may also lie within
    twice that share of the leaf's largest (see :func:`order_noise`).
    Returns the worst shares and what failed."""
    loose = total = loose_all = total_all = 0
    worst = {"m": 0.0, "v": 0.0, "param_over_lr": 0.0, "sure_over_lr": 0.0}
    failed = []
    for k, w in want["new"].items():
        for moment, tol in (("m", M_RTOL), ("v", V_RTOL)):
            if noise is not None:
                tol = max(tol, 2 * noise[(moment, k)])
            share = _share(got[moment][k].to(device),
                           want[moment][k].to(device))
            worst[moment] = max(worst[moment], share)
            if share > tol:
                failed.append(f"leaf {k}: {moment} {share} > {tol}")
        err = (got["new"][k].to(device) - w.to(device)).abs()
        gm = want["m"][k].to(device).abs()
        sign_like = gm >= 0.1 * SIGN_G          # m = 0.1 g at step 1
        sure = sign_like & (gm >= SURE_FRAC * gm.max())
        err_max = float(err.max())
        sure_max = float(torch.where(sure, err, 0).max())
        worst["param_over_lr"] = max(worst["param_over_lr"], err_max / lr)
        worst["sure_over_lr"] = max(worst["sure_over_lr"], sure_max / lr)
        if err_max > 2 * lr + 1e-6 or sure_max > STEP_TOL * lr:
            failed.append(f"leaf {k}: parameter off by {err_max}")
        over = err > STEP_TOL * lr
        loose += int((over & sign_like).sum())
        total += int(sign_like.sum())
        loose_all += int(over.sum())
        total_all += err.numel()
    worst["loose_share"] = loose / max(total, 1)
    worst["sign_like_share"] = total / total_all
    worst["loose_share_all_elements"] = loose_all / total_all
    if loose > LOOSE_SHARE * total:
        failed.append(f"{loose} of {total} elements loose")
    worst["failed"] = failed
    return worst


def order_noise(a: dict, b: dict, device) -> dict:
    """{(moment, leaf): the largest difference of two steps' moments as a
    share of the leaf's largest}: of two world-1 steps that compute the
    same function with their rows' gradients grouped otherwise (in one
    microbatch and in one per data rank), how far the order of the bf16
    sums alone moves a moment."""
    return {(moment, k): _share(a[moment][k].to(device), w.to(device))
            for moment in ("m", "v") for k, w in b[moment].items()}


def state_arrays(m, params, opt) -> dict:
    """{new, m, v} -> {leaf: float32 tensor, where the state is} of a
    world-1 state."""
    A = m["Aw"]
    return {"new": {k: v.float() for k, v in
                    A.flatten_params(params).items()},
            "m": {k: v.float() for k, v in opt["m"].items()},
            "v": {k: v.float() for k, v in opt["v"].items()}}


def whole_arrays(m, params, opt, whole) -> dict:
    """``StateLayout.whole``'s list of a (params, opt) state as
    :func:`state_arrays` gives a world-1 one (on the host)."""
    keys = [("new", k) for k in m["Aw"].flatten_params(params)]
    keys += [("m", k) for k in sorted(opt["m"])] + [("step", "")]
    keys += [("v", k) for k in sorted(opt["v"])]
    out = {"new": {}, "m": {}, "v": {}}
    for (what, k), a in zip(keys, whole):
        if what != "step":
            out[what][k] = torch.from_numpy(a.astype(np.float32))
    return out


def pinned_routes(Moe, ids, rows: int, model: int, row_block: int):
    """A world-1 ``moe._route`` for microbatches of ``rows`` rows that
    picks, for MoE layer ``L`` (counted by its router, in the forward's
    order) of microbatch ``i`` (counted by its forward calls; a recompute
    picks as its forward did), the experts ``ids[L]`` (B, S, k) the
    sharded step chose for those rows, and returns the sharded step's
    auxiliary loss: the mean over its shards (``row_block`` rows, a
    ``model``-th of the sequence) of each shard's ``E * sum(frac *
    pmean)`` (the reference's at a mesh)."""
    layers, calls, current = {}, {}, {}

    def route(router, x2, top_k):
        L = layers.setdefault(router.data_ptr(), len(layers))
        if not Moe._recomputing:
            current[L] = calls.get(L, 0)
            calls[L] = current[L] + 1
        i = current[L]
        pick = torch.from_numpy(ids[L][i * rows:(i + 1) * rows]).to(
            x2.device)
        Bn, Sn, _ = pick.shape
        probs = torch.softmax(x2.float() @ router.float(), dim=-1)
        flat = pick.reshape(-1, top_k).long()
        vals = torch.gather(probs, 1, flat)
        w = vals / torch.clamp(vals.sum(dim=-1, keepdim=True), min=1e-9)
        E = router.shape[1]
        p3 = probs.reshape(Bn, Sn, E)
        s, b = Sn // model, row_block
        auxes = []
        for d in range(Bn // b):
            for j in range(model):
                sl = (slice(d * b, (d + 1) * b), slice(j * s, (j + 1) * s))
                first = pick[sl][..., 0].reshape(-1).long()
                frac = torch.nn.functional.one_hot(first, E).float() \
                    .mean(dim=0)
                auxes.append(E * torch.sum(
                    frac * p3[sl].reshape(-1, E).mean(dim=0)))
        return w, flat.to(torch.int32), torch.stack(auxes).mean()
    return route


def whole_batch_routes(Moe, ids, rows: int):
    """:func:`pinned_routes` for microbatches of ``rows`` rows, one shard
    each, whose aux is a dense MoE layer's under a mesh: ``E * sum(frac *
    pmean)`` with ``frac`` of the whole batch's first choices (a
    constant) and ``pmean`` the microbatch's, so that the microbatches'
    mean is the whole batch's aux, with its gradient."""
    route, layers = pinned_routes(Moe, ids, rows, 1, rows), {}

    def whole(router, x2d, top_k):
        w, flat, _ = route(router, x2d, top_k)
        L = layers.setdefault(router.data_ptr(), len(layers))
        E = router.shape[1]
        first = torch.from_numpy(ids[L][..., 0].reshape(-1)).long()
        frac = torch.nn.functional.one_hot(first.to(x2d.device), E) \
            .float().mean(dim=0)
        probs = torch.softmax(x2d.float() @ router.float(), dim=-1)
        return w, flat, E * torch.sum(frac * probs.mean(dim=0))
    return whole


def gather_objects(obj) -> list:
    got = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(got, obj)
    return got


def mesh_state(m, cfg, device, policy, opt_cfg):
    """This rank's slices of the world-1 float32 masters (seed 0, drawn
    whole, then cut; the whole draws are freed) and the ZeRO-1 moments
    of its 2D slices."""
    M, A, Sh = m["M"], m["Aw"], m["Sh"]
    params = M.init_params(torch.Generator(device).manual_seed(0), cfg,
                           master=True)
    params = Sh.shard_params(params, policy, cfg=cfg)
    _free(device)
    flat = A.flatten_params(params)
    zero = Sh.Zero1(policy, flat)
    opt = A.init({k: zero.local(k, p) for k, p in flat.items()}, opt_cfg)
    return params, opt


def mesh_checks(m, device, mesh, full, opt_cfg, rank) -> dict | None:
    """At MESH_CHECK_LAYERS layers and capacity E / top_k (no row drops):
    one step under ``tp`` and one under ``fsdp_tp`` at the mesh, then on
    rank 0 the port's world-1 step of the same weights and batch, in one
    microbatch per data rank and with the MoE layers pinned to the
    ``tp`` step's routes (:func:`pinned_routes`; a near tie of the
    router's top-k may break otherwise under the other sums), held to
    the ``tp`` step by the leaf rule, loss, moe_aux and grad norm; and
    ``fsdp_tp`` to ``tp``.  Rank 0's record (None elsewhere)."""
    M, A, Sh, Moe, Ck = m["M"], m["Aw"], m["Sh"], m["Moe"], m["Ck"]
    D, Mm = mesh.shape["data"], mesh.shape["model"]
    cfg = dataclasses.replace(
        full, n_layers=MESH_CHECK_LAYERS, train=dataclasses.replace(
            full.train, moe_capacity_factor=full.n_experts / full.top_k))
    whole_batch = lm_batch(m, cfg, 0, MESH_CHECK_ROWS * D, MESH_TRAIN_SEQ,
                           device)
    steps = {}
    for flavor in ("tp", "fsdp_tp"):
        policy = Sh.make_policy(mesh, flavor)
        params, opt = mesh_state(m, cfg, device, policy, opt_cfg)
        plans, plain = [], Moe.radix_histogram_ranks

        def plan(eid, P, plans=plans, plain=plain):
            if not Moe._recomputing:
                plans.append(eid.cpu().numpy())
            return plain(eid, P)

        Moe.radix_histogram_ranks, Moe.drop_log = plan, []
        try:
            t0 = time.perf_counter()
            new, opt, met = M.make_train_step(cfg, policy, opt_cfg)(
                params, opt, Sh.shard_batch(whole_batch, policy))
            _sync(device)
            seconds = time.perf_counter() - t0
        finally:
            drops = [int(d) for d in Moe.drop_log
                     if not isinstance(d, Moe.Recomputed)]
            Moe.radix_histogram_ranks, Moe.drop_log = plain, None
        layout = Sh.train_state_layout(policy, new, opt)
        whole = layout.whole(Ck.tree_leaves((new, opt)))
        ids = gather_objects(plans)
        if whole is not None:
            steps[flavor] = dict(
                arrays=whole_arrays(m, new, opt, whole), ids=ids,
                seconds=seconds, dropped=sum(gather_objects(drops), []),
                met={k: float(v) for k, v in met.items()})
        else:
            gather_objects(drops)
        del params, new, opt, whole
        _free(device)
    out = None
    if rank == 0:
        tp, fsdp = steps["tp"], steps["fsdp_tp"]
        if any(tp["dropped"]) or any(fsdp["dropped"]):
            raise AssertionError(f"moe_train_mesh: rows dropped at capacity "
                                 f"factor {cfg.train.moe_capacity_factor}")
        b, s = MESH_CHECK_ROWS, MESH_TRAIN_SEQ // Mm
        routes = []
        for layer in range(cfg.n_layers):
            lay = np.zeros((b * D, MESH_TRAIN_SEQ, cfg.top_k), np.int32)
            for r, got in enumerate(tp["ids"]):
                d, j = divmod(r, Mm)
                lay[d * b:(d + 1) * b, j * s:(j + 1) * s] = \
                    got[layer].reshape(b, s, -1)
            routes.append(lay)
        w1s = {}
        for micro in (D, 1):
            w1cfg = dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, microbatches=micro))
            params = M.init_params(torch.Generator(device).manual_seed(0),
                                   w1cfg, master=True)
            route = Moe._route
            Moe._route = pinned_routes(Moe, routes, b * D // micro, Mm, b)
            try:
                t0 = time.perf_counter()
                new, opt, met = M.make_train_step(w1cfg, None, opt_cfg)(
                    params, A.init(A.flatten_params(params), opt_cfg),
                    whole_batch)
                _sync(device)
                w1s[micro] = (state_arrays(m, new, opt),
                              {k: float(v) for k, v in met.items()},
                              time.perf_counter() - t0)
            finally:
                Moe._route = route
            del params, new, opt
            _free(device)
        w1, w1met, w1_seconds = w1s[D]
        noise = order_noise(w1s[1][0], w1, device)
        lr = w1met["lr"]
        out = {"layers": cfg.n_layers, "rows_per_data_rank": b,
               "capacity_factor": cfg.train.moe_capacity_factor,
               "world1": w1met, "tp": tp["met"], "fsdp_tp": fsdp["met"],
               "seconds": {"world1": w1_seconds, "tp": tp["seconds"],
                           "fsdp_tp": fsdp["seconds"]},
               "world1_one_microbatch": w1s[1][1],
               "order_noise_max": {mo: max(v for (x, _), v in noise.items()
                                           if x == mo) for mo in ("m", "v")},
               "tp_vs_world1": leaf_rule(tp["arrays"], w1, lr, device,
                                         noise),
               "fsdp_vs_tp": leaf_rule(fsdp["arrays"], tp["arrays"], lr,
                                       device, noise)}
        for k, tol in (("loss", LM_LOSS_RTOL), ("moe_aux", LM_LOSS_RTOL),
                       ("grad_norm", LM_GNORM_RTOL)):
            for what, got, want in (("tp_vs_world1", tp["met"], w1met),
                                    ("fsdp_vs_tp", fsdp["met"],
                                     tp["met"])):
                e = rel_err(got[k], want[k])
                out[what][f"{k}_rel_err"] = e
                if e > tol:
                    out[what]["failed"].append(f"{k} {got[k]} vs {want[k]}")
        print(json.dumps({"moe_train_mesh_checks": out}), flush=True)
        if out["tp_vs_world1"]["failed"] or out["fsdp_vs_tp"]["failed"]:
            raise AssertionError(f"moe_train_mesh: {out}")
    torch.distributed.barrier()
    return out


def mesh_train(m, device, rank, tmp: Path) -> dict:
    """One rank of ``moe_train_mesh``: the checks, then MESH_TRAIN_STEPS
    timed steps at MESH_TRAIN_LAYERS layers, capacity factor 1.25, with
    every dispatch plan of the first step recorded (rank 0 writes them
    to ``tmp/mesh_plans.pt``), then one profiled step."""
    M, A, Sh, Moe, ops = m["M"], m["Aw"], m["Sh"], m["Moe"], m["ops"]
    no_tf32("moe_train_mesh")
    full = m["get_config"](MOE_ARCH)
    if full.train.remat != "full" or full.train.sharding != "tp":
        raise AssertionError(f"moe_train_mesh: {full.train}")
    mesh = m["Me"].make_mesh(MESH_TRAIN)
    opt_cfg = A.AdamWConfig(lr=3e-4, warmup_steps=1,
                            total_steps=MESH_TRAIN_STEPS)
    check = mesh_checks(m, device, mesh, full, opt_cfg, rank)
    _free(device)
    cfg = dataclasses.replace(full, n_layers=MESH_TRAIN_LAYERS)
    policy = Sh.make_policy(mesh, cfg.train.sharding)
    params, opt = mesh_state(m, cfg, device, policy, opt_cfg)
    step = M.make_train_step(cfg, policy, opt_cfg, donate=True)
    batch = Sh.shard_batch(lm_batch(m, cfg, 0, MESH_TRAIN_BATCH,
                                    MESH_TRAIN_SEQ, device), policy)
    batches = [batch] * MESH_TRAIN_STEPS
    held = lambda tree: sum(t.numel() * t.element_size()     # noqa: E731
                            for t in A.flatten_params(tree).values())
    master_bytes = held(params)
    moment_bytes = held(opt["m"]) + held(opt["v"])
    E_loc = Moe.n_experts_padded(cfg) // policy.world_m
    plans = DispatchLog(Moe, cfg.n_experts, E_loc, 2 * cfg.n_layers)
    _sync(device)
    _reset_peak(device)
    resident = _allocated(device)
    for op in ops.values():
        op.launches = 0
    Moe.drop_log = []
    mets, events = [], []
    try:
        # the loop of timed_steps, here so that no caller's frame keeps
        # the state of an earlier step (AdamW writes the new state into
        # the old)
        with plans:
            for b in batches:
                ev = event_pair()
                ev[0].record()
                params, opt, met = step(params, opt, b)
                ev[1].record()
                mets.append(met)
                events.append(ev)
            torch.cuda.synchronize()
        launches = {k: op.launches for k, op in ops.items()}
        drops = [int(d) for d in Moe.drop_log
                 if not isinstance(d, Moe.Recomputed)][:cfg.n_layers]
    finally:
        Moe.drop_log = None
    peak = _peak(device) - resident
    losses = [float(met["loss"]) for met in mets]
    aux = [float(met["moe_aux"]) for met in mets]
    ms = [a.elapsed_time(b) for a, b in events]
    # a forward and a recompute plan of every MoE layer in every step
    expect_launches("moe_train_mesh", launches, {
        "hash_partition": 2 * cfg.n_layers * MESH_TRAIN_STEPS})
    if rank == 0:
        torch.save(plans.prefill, tmp / "mesh_plans.pt")
    prof = profile_tp2({"train_step": lambda: step(params, opt,
                                                   batches[0])},
                       device, rank, warm=False)
    step_ms = float(np.median(ms[1:]))
    T = MESH_TRAIN_BATCH // policy.world_d * MESH_TRAIN_SEQ \
        // policy.world_m
    return {"rank": torch.distributed.get_rank(), "coord": mesh.coord,
            "device": str(device), "backend": torch.distributed.get_backend(),
            "arch": cfg.name, "layers": cfg.n_layers,
            "of_layers": full.n_layers, "flavor": policy.flavor,
            "capacity_factor": cfg.train.moe_capacity_factor,
            "capacity_send": math.ceil(T * cfg.top_k / cfg.n_experts
                                       * cfg.train.moe_capacity_factor),
            "tokens_per_dispatch": T, "steps": MESH_TRAIN_STEPS,
            "step_ms": ms, "step_ms_median_after_first": step_ms,
            "tokens_per_s": MESH_TRAIN_BATCH * MESH_TRAIN_SEQ / step_ms
            * 1e3,
            "master_bytes": master_bytes,
            "grad_bytes_2d": moment_bytes // 2,
            "moment_bytes": moment_bytes, "resident_bytes": resident,
            "peak_bytes_above_resident": peak,
            "first_step_dropped_by_layer": drops, "launches": launches,
            "losses": losses, "moe_aux": aux,
            "profile": prof.get("train_step"), "check": check}


def mesh_train_rank(rank, world, store, tmp):
    """One rank of ``moe_train_mesh``: ``launch/train.py``'s ``--mesh``
    rank set-up (its device, the process group), then
    :func:`mesh_train`; writes its record to ``tmp/mesh_rank<r>.json``;
    then ``moe_train_pod2`` (:func:`pod_train`) at POD_MESH, its record
    in ``tmp/moe_train_pod2_rank<r>.json``."""
    m = _modules()
    device = m["serve"].rank_device(rank, world)
    m["Me"].init_rank(rank, world, store, device, timeout_s=900)
    try:
        record = mesh_train(m, device, rank, Path(tmp))
        Path(tmp, f"mesh_rank{rank}.json").write_text(json.dumps(record))
        _free(device)
        t0 = time.perf_counter()
        record = pod_train(m, device, m["Me"].make_mesh(POD_MESH), rank)
        record["leg_s"] = time.perf_counter() - t0
        Path(tmp, f"moe_train_pod2_rank{rank}.json").write_text(
            json.dumps(record))
    finally:
        torch.distributed.destroy_process_group()


def run_moe_train_mesh(m, device, name, tmpdir: Path):
    """``moe_train_mesh``: four rank processes on the one card
    (:func:`mesh_train_rank`), started by ``launch/serve.py``'s
    :func:`spawn`.  The loss must fall on every rank alike; rank 0's
    first-step dispatch plans are held to the plain ranks by the caller
    (they are the returned kernel cases) and their forward plans' drops
    to the counts the ranks logged.  Times at world 4 on one card measure
    gloo's host staging, not data or tensor parallelism across cards.
    Returns (legs, kernel cases)."""
    t0 = time.perf_counter()
    world = math.prod(MESH_TRAIN.values())
    m["serve"].spawn(world, mesh_train_rank, (str(tmpdir),), timeout_s=900)
    wall = time.perf_counter() - t0
    recs = [json.loads(Path(tmpdir, f"mesh_rank{r}.json").read_text())
            for r in range(world)]
    losses = recs[0]["losses"]
    if any(r["losses"] != losses for r in recs):
        raise AssertionError("moe_train_mesh: the ranks' losses differ")
    plans = torch.load(tmpdir / "mesh_plans.pt")
    rec0 = recs[0]
    layers, C = rec0["layers"], rec0["capacity_send"]
    want_drops = [int((m["hp_ref"].radix_histogram_ranks_ref(
        pid, P)[1] >= C).sum()) for pid, P in plans[:layers]]
    emit({"phase": "moe_train_mesh", "card": name, "wall_s": wall,
          "mesh": MESH_TRAIN, "batch": MESH_TRAIN_BATCH,
          "seq": MESH_TRAIN_SEQ, "plans_recorded": len(plans),
          "rank0_drops_from_plain_plans": want_drops, "ranks": recs})
    if not losses[-1] < losses[0]:
        raise AssertionError(f"moe_train_mesh: loss {losses[0]} -> "
                             f"{losses[-1]} did not fall")
    if want_drops != rec0["first_step_dropped_by_layer"]:
        raise AssertionError(f"moe_train_mesh: dropped rows "
                             f"{rec0['first_step_dropped_by_layer']}, the "
                             f"plain plans give {want_drops}")
    cases = []
    for i, (pid, P) in enumerate(plans):
        pid = pid.to(device)
        what = "forward" if i < layers else "recompute"
        cases.append(dict(
            shape=f"(mesh) train step {what} plan n={pid.numel()} P={P}",
            args=(pid, P),
            library=lambda pid=pid: torch.argsort(pid, stable=True)))
    legs = {"moe_train_mesh": dict(
        rows=MESH_TRAIN_BATCH * MESH_TRAIN_STEPS,
        launches={k: sum(r["launches"][k] for r in recs)
                  for k in rec0["launches"]})}
    legs.update(pod_train_results(m, tmpdir))
    return legs, {"hash_partition": cases}


def run_lm_drill_mesh(m, device, name, tmpdir: Path):
    """``launch.train.main --mesh data=2,model=2`` on lm100m at full size:
    DRILL_MESH_STEPS steps of ``lm_batch_at`` in order, a checkpoint every
    DRILL_MESH_EVERY, once plainly and once with ``--fail-at
    DRILL_MESH_FAIL``; the restarted run must end bit-identical (every
    leaf of the last checkpoint, gathered whole, and the records), and
    that checkpoint must restore at world 1 in this process to the same
    bits.  The four ranks run in their own processes, each
    ``launch/train.py``'s rank wrapped by :func:`counted_train_rank`,
    which reads its launch counters; lm100m trains through plain
    attention, so no rank may launch a kernel."""
    wall = time.perf_counter()
    M, A, Ck, Tr = m["M"], m["Aw"], m["Ck"], m["Tr"]
    argv = ["--arch", LM_ARCH, "--steps", str(DRILL_MESH_STEPS),
            "--batch", str(DRILL_MESH_BATCH), "--seq", str(LM_SEQ),
            "--log-every", "0", "--device", torch.device(device).type,
            "--mesh", ",".join(f"{k}={v}" for k, v in MESH_TRAIN.items())]
    runs = {}
    spawn = Tr.spawn
    counts = tmpdir / "lm_drill_mesh_counts"

    def counted_spawn(world, target, args):
        assert target is Tr._train_rank, target
        spawn(world, counted_train_rank, (*args, str(counts)))

    # the plain run checkpoints only its last step (each checkpoint is
    # 1.66 GB gathered whole through gloo), which the restarted run's last
    # checkpoint is held to
    for what, extra in (("plain", ["--ckpt-every", str(DRILL_MESH_STEPS)]),
                        ("failed", ["--ckpt-every", str(DRILL_MESH_EVERY),
                                    "--fail-at", str(DRILL_MESH_FAIL)])):
        d = tmpdir / f"lm_drill_mesh_{what}"
        counts.mkdir()
        t0 = time.perf_counter()
        Tr.spawn = counted_spawn
        try:
            hist = Tr.main(argv + ["--ckpt-dir", str(d)] + extra)
        finally:
            Tr.spawn = spawn
        ranks = [json.loads(p.read_text())
                 for p in sorted(counts.glob("rank*.json"))]
        shutil.rmtree(counts)
        if len(ranks) != math.prod(MESH_TRAIN.values()):
            raise AssertionError(f"lm_drill_mesh: {len(ranks)} ranks' "
                                 "launch counts")
        runs[what] = dict(history=hist, dir=d,
                          seconds=time.perf_counter() - t0,
                          launches={k: sum(r[k] for r in ranks)
                                    for k in KERNELS})
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in KERNELS}
    last = f"step_{DRILL_MESH_STEPS}"
    final = [_final_arrays(runs[w]["dir"] / last)
             for w in ("plain", "failed")]
    identical = same_bits(*final)
    same = same_history(runs["plain"]["history"], runs["failed"]["history"])
    cfg = m["get_config"](LM_ARCH)
    params = M.init_params(torch.Generator(device).manual_seed(0), cfg,
                           master=True)
    t0 = time.perf_counter()
    step, state = Ck.restore(str(runs["plain"]["dir"]), (
        params, A.init(A.flatten_params(params), A.AdamWConfig())))
    restore_s = time.perf_counter() - t0
    world1 = step == DRILL_MESH_STEPS and same_bits(
        [t.cpu().numpy() for t in Ck.tree_leaves(state)], final[0])
    del params, state
    _free(device)
    emit({"phase": "lm_drill_mesh", "card": name,
          "wall_s": time.perf_counter() - wall, "arch": LM_ARCH,
          "mesh": MESH_TRAIN, "steps": DRILL_MESH_STEPS,
          "ckpt_every": DRILL_MESH_EVERY, "fail_at": DRILL_MESH_FAIL,
          "batch": DRILL_MESH_BATCH, "seq": LM_SEQ,
          "leaves": len(final[0]),
          "checkpoint_bytes": (runs["plain"]["dir"] / last
                               / "arrays.npz").stat().st_size,
          "seconds": {w: r["seconds"] for w, r in runs.items()},
          "restarted_records": len(runs["failed"]["history"]),
          "bit_identical": identical, "same_records": same,
          "world1_restore_bit_identical": world1,
          "world1_restore_s": restore_s, "launches": launches,
          "losses": [h["loss"] for h in runs["plain"]["history"]]})
    if not (identical and same and world1):
        raise AssertionError("lm_drill_mesh: the restarted run differs "
                             "from the plain one, or its checkpoint does "
                             "not restore at world 1")
    expect_launches("lm_drill_mesh", launches, {})
    for r in runs.values():
        shutil.rmtree(r["dir"])
    return {"lm_drill_mesh": dict(launches=launches,
                                  rows=2 * DRILL_MESH_STEPS
                                  * DRILL_MESH_BATCH)}


def counted_train_rank(rank, world, store, args, out, counts):
    """``launch/train.py``'s ``--mesh`` rank, then this rank's kernel
    launches in the run written to ``counts/rank<r>.json``."""
    m = _modules()
    for op in m["ops"].values():
        op.launches = 0
    m["Tr"]._train_rank(rank, world, store, args, out)
    Path(counts, f"rank{rank}.json").write_text(json.dumps(
        {k: op.launches for k, op in m["ops"].items()}))


# --------------------------------------------------------------------------
# the LM serving path: ServingEngine with feature fetch, flash attention
# --------------------------------------------------------------------------

# bf16 outputs compared in float32: the reference's own bf16 tolerance for
# its kernel (tests/test_kernels.py::test_flash_attention_dtypes)
FLASH_TOL = 2e-2
# Prefill logits of the flash path against the plain ``xla`` path, and the
# engine's logits against the one-shot loop's at every position, agree
# within SERVE_LOGIT_TOL absolute (logits of magnitude about 4).  Each attention output of the
# kernel is within one bf16 ulp of plain attention's (it rounds P to bf16
# for the tensor cores and sums in another order), and forty layers of
# random weights amplify such differences: the first runs on the card
# measured 0.215 at most and 0.178 at the median over the leg's 32
# prompts, and plain attention_ref against xla (float32 both, other sums)
# 0.149 on one; the engine against the one-shot loop 0.165 (the same
# kernels at other batch shapes).  Greedy tokens are compared where the
# reference's top-2 logit margin is at least SERVE_LOGIT_TOL: below it a
# difference within the tolerance may pick the other token.  Against the
# ``xla`` run, which decodes freely, up to the first position where the
# two sequences differ (they may go apart at a smaller margin, and their
# contexts differ after it); against the one-shot loop, fed the engine's
# tokens, at every position.
SERVE_LOGIT_TOL = 0.3


def _margin(logits) -> np.ndarray:
    top = torch.topk(logits.float(), 2, dim=-1).values
    return (top[..., 0] - top[..., 1]).cpu().numpy()


class RouteLog:
    """While active (a context), ``moe._route`` also logs, for the rows
    that ``rows`` maps a request id to, each call's top-k expert ids (as a
    sorted set) and the gap between the k-th and (k+1)-th router
    probability: ``log[req_id]`` is a list of (ids, gaps) on the host, one
    per MoE layer call, in call order.  ``rows`` is set by
    :class:`Recorder`'s hooks around a kept request's prefill or step."""

    def __init__(self, moe):
        self.moe, self.plain = moe, moe._route
        self.rows = None
        self.log = collections.defaultdict(list)

    def route(self, router, x2d, top_k):
        out = self.plain(router, x2d, top_k)
        if self.rows:
            probs = torch.softmax(x2d.float() @ router.float(), dim=-1)
            top = torch.topk(probs, top_k + 1, dim=-1).values
            gaps = (top[:, top_k - 1] - top[:, top_k]).cpu()
            ids = torch.sort(out[1], dim=-1).values.cpu()
            for rid, rows in self.rows.items():
                self.log[rid].append((ids[rows], gaps[rows]))
        return out

    def __enter__(self):
        self.moe._route = self.route
        return self

    def __exit__(self, *exc):
        self.moe._route = self.plain


class Recorder:
    """Hooks on an engine: each request's prefill logits (float32, on the
    host) and its top-2 logit margin at every token it emits, in the order
    of its ``out_tokens``; for the requests of ``keep`` also the logits of
    every token (``steps``) and, with a :class:`RouteLog` as ``routes``,
    the routing of their real positions."""

    def __init__(self, engine, keep=(), routes=None):
        self.logits = {}
        self.margins = collections.defaultdict(list)
        self.steps = collections.defaultdict(list)
        upcoming = collections.deque()
        fetch, prefill, step = (engine._fetch_features,
                                engine._slot_prefill, engine._serve_step)

        def fetch_hook(reqs):
            good = fetch(reqs)
            upcoming.extend(good)
            return good

        def prefill_hook(params, batch, length):
            rid = upcoming.popleft().req_id
            if routes is not None and rid in keep:
                routes.rows = {rid: slice(0, int(length))}
            try:
                logits, caches = prefill(params, batch, length)
            finally:
                if routes is not None:
                    routes.rows = None
            self.logits[rid] = logits[0].float().cpu()
            self.margins[rid].append(float(_margin(logits)[0]))
            if rid in keep:
                self.steps[rid].append(self.logits[rid])
            return logits, caches

        def step_hook(params, caches, tokens, cache_lens):
            if routes is not None:
                routes.rows = {engine.batch.request_at(slot).req_id: [slot]
                               for slot in engine.batch.active()
                               if engine.batch.request_at(slot).req_id
                               in keep}
            try:
                logits, caches = step(params, caches, tokens, cache_lens)
            finally:
                if routes is not None:
                    routes.rows = None
            mg = _margin(logits)
            for slot in engine.batch.active():
                rid = engine.batch.request_at(slot).req_id
                self.margins[rid].append(float(mg[slot]))
                if rid in keep:
                    self.steps[rid].append(logits[slot].float().cpu())
            return logits, caches

        engine._fetch_features = fetch_hook
        engine._slot_prefill = prefill_hook
        engine._serve_step = step_hook


def greedy_agree(got, want, margins, tol) -> int:
    """Tokens compared up to the first position where the two sequences
    differ (their contexts are the same until there): each one whose
    margin is at least ``tol`` must be equal; a difference at a smaller
    margin ends the comparison.  Returns the tokens compared."""
    n = 0
    for i, (g, w, mg) in enumerate(zip(got, want, margins)):
        if mg >= tol:
            if g != w:
                raise AssertionError(f"token {i}: {g} != {w} at margin {mg}")
            n += 1
        elif g != w:
            break
    return n


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def count_lookups(stores) -> list:
    """Wrap each store's ``lookup``; the returned one-element list counts
    the calls."""
    n = [0]
    for store in stores.values():
        plain = store.lookup

        def lookup(keys, plain=plain):
            n[0] += 1
            return plain(keys)

        store.lookup = lookup
    return n


def check_served(done, reqs, tables, n_req):
    """Every request done with ``gen_len`` tokens and the features of its
    numpy rows."""
    if sorted(r.req_id for r in done) != list(range(n_req)):
        raise AssertionError("serving: requests lost")
    for r in done:
        if r.status != "done" or len(r.out_tokens) != r.gen_len:
            raise AssertionError(f"serving: request {r.req_id} {r.status} "
                                 f"with {len(r.out_tokens)} tokens")
        want = {}
        for attr, tbl in tables.items():
            row = int(np.flatnonzero(tbl[attr] == getattr(r, attr))[0])
            want.update({c: float(v[row]) for c, v in tbl.items()
                         if c != attr})
        if r.features != want:
            raise AssertionError(f"serving: request {r.req_id} features "
                                 "differ from its numpy rows")


def oneshot_tokens(m, cfg, params, req, device, routes=None):
    """The one-shot loop (exact-length prefill, then batch-1 decode at a
    scalar cache length) fed the engine's tokens, so both see the same
    context at every position: its greedy choice, top-2 margin and logits
    (float32, host) at each of the request's positions.  With a
    :class:`RouteLog` (active) as ``routes``, its routing of the
    request's positions is logged there."""
    M = m["M"]
    n = len(req.prompt)
    prefill = M.make_prefill(cfg, decode_len=n + req.gen_len)
    step = M.make_serve_step(cfg)

    def logged(rows, fn, *args):
        if routes is not None:
            routes.rows = {req.req_id: rows}
        try:
            return fn(*args)
        finally:
            if routes is not None:
                routes.rows = None

    logits, caches = logged(slice(0, n), prefill, params, {
        "tokens": torch.from_numpy(req.prompt[None]).to(device)})
    toks, margins, steps = [], [], []
    for i in range(req.gen_len):
        toks.append(int(torch.argmax(logits[0])))
        margins.append(float(_margin(logits)[0]))
        steps.append(logits[0].float().cpu())
        if i < req.gen_len - 1:
            logits, caches = logged([0], step, params, caches, torch.tensor(
                [[req.out_tokens[i]]], dtype=torch.int32, device=device),
                n + i)
    return toks, margins, steps


# A routing flip (a token whose top-k experts differ between two runs of
# one request) that no earlier flip explains, where the two runs' router
# inputs differ only by roundings, must be a near tie: its k-th to
# (k+1)-th probability gap (the smaller of the two runs') at most
# ROUTE_TIE_GAP.  serving_jamba's such flips were at gaps of 3.5e-5 and
# 4.0e-3 against its one-shot loop and of 1.9e-3 at most against its
# plain twin, serving_moe's flash-against-xla flips at 1.1e-3 at most,
# and flips after an earlier one at up to 0.11 (H100 80GB HBM3, 700 W).
# Each request is held for ROUTE_MIN_HELD
# positions (0 the prefill) before its own token may route otherwise: a
# fault in the decode path moves the state far enough to flip at once.
ROUTE_TIE_GAP = 0.02
ROUTE_MIN_HELD = 4


def route_diffs(got, want, n_moe, upto=None) -> dict:
    """Two :class:`RouteLog` logs of one request (``n_moe`` MoE layers:
    the prefill's calls, then each decode step's) over its positions up
    to ``upto`` (0 the prefill; default all that both logged; two runs
    that decode freely have the same context up to their first differing
    token).  ``sets_compared`` / ``sets_differ``: the (token, layer)
    routing sets; ``gaps`` / ``gaps_differing``: the smaller of the two
    runs' k-th to (k+1)-th probability gaps at each of them;
    ``first_position``: the first position whose own token (the prompt's
    last, or the decode step's one) routes otherwise in some layer, or
    None, and ``gap``, the largest gap there; ``prompt_flips``: the other
    prompt tokens that route otherwise (their effect on later positions
    passes through attention and the Mamba states); ``roots`` /
    ``root_gap``: the flips that no flip of an earlier layer at the same
    or an earlier token explains, and their largest gap."""
    n = min(len(got), len(want)) // n_moe
    if upto is not None:
        n = min(n, upto + 1)
    bad, gap = [], []
    for layer in range(n_moe):      # each layer's rows: prompt, then steps
        calls = [(got[c], want[c]) for c in range(layer, n * n_moe, n_moe)]
        bad.append(torch.cat([(g[0] != w[0]).any(dim=-1) for g, w in calls]))
        gap.append(torch.cat([torch.minimum(g[1], w[1]) for g, w in calls]))
    bad, gap = torch.stack(bad), torch.stack(gap)
    prompt, tokens = len(got[0][0]), bad.shape[1]
    # the first token of each layer that a flip of an earlier layer reaches
    hit = torch.where(bad, torch.arange(tokens), tokens).min(dim=1).values
    reach = torch.cat([torch.tensor([tokens]),
                       torch.cummin(hit, dim=0).values[:-1]])
    roots = bad & (torch.arange(tokens)[None] < reach[:, None])
    own = bad[:, prompt - 1:].any(dim=0)
    first = int(own.nonzero()[0]) if bool(own.any()) else None
    return {"sets_compared": bad.numel(), "sets_differ": int(bad.sum()),
            "gaps": gap.flatten(), "gaps_differing": gap[bad],
            "first_position": first,
            "gap": None if first is None else
            float(gap[:, prompt - 1 + first][bad[:, prompt - 1 + first]]
                  .max()),
            "prompt_flips": int(bad[:, :prompt - 1].any(dim=0).sum()),
            "roots": int(roots.sum()),
            "root_gap": float(gap[roots].max()) if bool(roots.any())
            else None}


def held_routes(leg, rid, d) -> dict:
    """Check a request's :func:`route_diffs` (every root flip a near tie
    within ROUTE_TIE_GAP, no own-token flip before ROUTE_MIN_HELD) and
    return its summary."""
    if d["root_gap"] is not None and d["root_gap"] > ROUTE_TIE_GAP:
        raise AssertionError(
            f"{leg}: request {rid} routes otherwise at a gap of "
            f"{d['root_gap']} > {ROUTE_TIE_GAP} where no earlier flip "
            "explains it")
    if d["first_position"] is not None \
            and d["first_position"] < ROUTE_MIN_HELD:
        raise AssertionError(
            f"{leg}: request {rid} routes otherwise at position "
            f"{d['first_position']} < {ROUTE_MIN_HELD}")
    return {k: d[k] for k in ("first_position", "gap", "prompt_flips",
                              "roots", "root_gap")}


def profile_serving(m, fns, device, labelled, port_kernels):
    """Each of ``fns`` (name -> callable) once warmed, then once under
    torch.profiler with the functions of ``labelled`` ((module, name)
    pairs, none calling another) in labelled ranges: wall ms, device busy
    ms and share, and device ms under each label.  ``port_kernels`` are
    the (label, port kernel's name) pairs of the labels that wrap a port
    kernel: it is launched through ctypes, not by an operator of its
    wrapper's range, so its label's time is read from the kernel
    itself."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    plain = {name: getattr(mod, name) for mod, name in labelled}

    def label(name):
        def fn(*args, **kwargs):
            with record_function(f"serve::{name}"):
                return plain[name](*args, **kwargs)
        return fn

    out = {}
    for key, fn in fns.items():
        fn()
        torch.cuda.synchronize(device)
        for mod, name in labelled:
            setattr(mod, name, label(name))
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize(device)
                wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            for mod, name in labelled:
                setattr(mod, name, plain[name])
        # kernels only: the labels also appear on the device's timeline as
        # annotation spans (first to last kernel of the range, gaps
        # included), kept apart here
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.key.startswith("serve::")]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        by_label, spans = collections.Counter(), collections.Counter()
        for e in prof.events():
            if e.name.startswith("serve::"):
                part = e.name.split("::")[1]
                if e.device_type == DeviceType.CUDA:
                    spans[part] += e.device_time_total / 1e3
                else:       # the kernels of the range's operators
                    by_label[part] += e.device_time_total / 1e3
        for lab, kname in port_kernels:
            by_label[lab] = sum(e.self_device_time_total for e in kernels
                                if kname in e.key) / 1e3
        kernels.sort(key=lambda e: -e.self_device_time_total)
        out[key] = {"wall_ms": wall_ms, "device_busy_ms": busy,
                    "device_busy_share": busy / wall_ms,
                    "device_ms_by_label": dict(by_label),
                    "device_span_ms_by_label": dict(spans),
                    "device_ms_other": busy - sum(by_label.values()),
                    "top_kernels": [{"name": e.key[:80], "count": e.count,
                                     "device_ms":
                                         e.self_device_time_total / 1e3}
                                    for e in kernels[:6]]}
    return out


def check_engine_run(leg, engine, done, rejected, reqs, tables, stores):
    """The accounting identity, no rejection or feature miss, every
    request served with its tokens and features, no feature row
    dropped."""
    mt = engine.metrics
    if mt.count("submitted") != mt.count("completed") + \
            mt.count("rejected") + mt.count("feature_misses"):
        raise AssertionError(f"{leg}: accounting identity violated")
    if rejected or mt.count("feature_misses"):
        raise AssertionError(f"{leg}: {len(rejected)} rejected, "
                             f"{mt.count('feature_misses')} feature misses")
    check_served(done, reqs, tables, len(reqs))
    dropped = {k: s.dropped for k, s in stores.items()}
    if any(dropped.values()):
        raise AssertionError(f"{leg}: feature stores dropped {dropped}")


def store_chunks(serve, stores) -> int:
    """The feature stores' ingest morsels: one shuffle each."""
    return sum(math.ceil(s.n_rows / serve.CHUNK_ROWS)
               for s in stores.values())


def against_oneshot(m, cfg, params, rec, by_id, pick, device,
                    routes=None) -> dict:
    """The requests of ``pick`` against the one-shot loop, fed the
    engine's tokens: the logits at every position within
    SERVE_LOGIT_TOL, and the same greedy token wherever the one-shot
    margin is at least that.  With ``routes``, the engine's
    :class:`RouteLog` of those requests, the one-shot loop's routing is
    logged too and each request is held so up to its first position
    whose own token's MoE routing differs (the two runs' router products,
    on other row counts, may break a near tie differently), the rest
    recorded; :func:`held_routes` checks the flips."""
    oneshot = {"requests": pick, "positions": 0, "compared": 0,
               "equal": 0, "logit_diff": 0.0}
    own = RouteLog(m["Moe"]) if routes is not None else None
    n_moe = sum(cfg._layer_has_moe(i) for i in range(cfg.n_layers))
    for rid in pick:
        r = by_id[rid]
        with own or contextlib.nullcontext():
            toks, margins, steps = oneshot_tokens(m, cfg, params, r, device,
                                                  own)
        held = len(steps)
        if routes is not None:
            flips = held_routes("serving", rid, route_diffs(
                routes.log[rid], own.log[rid], n_moe))
            oneshot.setdefault("route_flips", {})[rid] = flips
            if flips["first_position"] is not None:
                held = flips["first_position"]
        for i, (a, b) in enumerate(zip(rec.steps[rid], steps, strict=True)):
            diff = float((a - b).abs().max())
            oneshot["equal"] += toks[i] == r.out_tokens[i]
            if i >= held:
                oneshot["logit_diff_after_flip"] = max(
                    oneshot.get("logit_diff_after_flip", 0.0), diff)
                continue
            oneshot["logit_diff"] = max(oneshot["logit_diff"], diff)
            oneshot["positions"] += 1
            if margins[i] >= SERVE_LOGIT_TOL:
                oneshot["compared"] += 1
                if toks[i] != r.out_tokens[i]:
                    raise AssertionError(
                        f"serving: request {rid} token {i}: engine "
                        f"{r.out_tokens[i]}, one-shot {toks[i]} at margin "
                        f"{margins[i]}")
    if oneshot["logit_diff"] > SERVE_LOGIT_TOL or not oneshot["compared"]:
        raise AssertionError(f"serving: engine against one-shot {oneshot}")
    return oneshot


def routing_flips(cfg, routes, xroutes, pick, by_id, want) -> dict:
    """The routing sets of the requests of ``pick`` in the flash engine
    (``routes``) against the ``xla`` engine (``xroutes``): every prompt
    position of every MoE layer, and the decode steps while both engines'
    tokens so far agree (their contexts are the same),
    :func:`route_diffs`.  Counts the sets compared and those that differ,
    the smallest and largest k-th to (k+1)-th probability gap (the
    smaller of the two engines') among the differing ones and the
    smallest among all."""
    n_moe = sum(cfg._layer_has_moe(i) for i in range(cfg.n_layers))
    out = {"sets_compared": 0, "sets_differ": 0, "by_request": {}}
    gaps_all, gaps_bad = [], []
    for rid in pick:
        got, ref = by_id[rid].out_tokens, want[rid].out_tokens
        same = next((i for i, (a, b) in enumerate(zip(got, ref)) if a != b),
                    len(got))
        # step j is fed token j - 1: the same context while tokens[:j] are
        d = route_diffs(routes.log[rid], xroutes.log[rid], n_moe, same)
        out["by_request"][rid] = {"sets_compared": d["sets_compared"],
                                  "sets_differ": d["sets_differ"],
                                  "tokens_equal_prefix": same}
        out["sets_compared"] += d["sets_compared"]
        out["sets_differ"] += d["sets_differ"]
        gaps_all.append(d["gaps"])
        gaps_bad.append(d["gaps_differing"])
    gaps_bad = torch.cat(gaps_bad)
    out["min_gap"] = float(torch.cat(gaps_all).min())
    out["min_gap_differing"], out["max_gap_differing"] = (
        float(gaps_bad.min()), float(gaps_bad.max())) if len(gaps_bad) \
        else (None, None)
    return out


def experts_bf16(leg, params) -> int:
    """The MoE experts resident as bf16 and the routers as float32 (in
    each MoE sub-layer of a period stack); returns the experts' bytes."""
    layers = params["layers"]
    total = 0
    for group in [layers] + [v for v in layers.values()
                             if isinstance(v, dict)]:
        ffn = group.get("ffn_moe")
        if ffn is None:
            continue
        if ffn["router"].dtype != torch.float32 or any(
                ffn[k].dtype != torch.bfloat16
                for k in ("e_gate", "e_up", "e_down")):
            raise AssertionError(f"{leg}: MoE leaves "
                                 f"{ {k: v.dtype for k, v in ffn.items()} }")
        total += sum(ffn[k].numel() * ffn[k].element_size()
                     for k in ("e_gate", "e_up", "e_down"))
    return total


def run_serving(m, device, cfg, *, prompt_cap=SERVE_PROMPT,
                gen_cap=SERVE_GEN, n_req=SERVE_REQUESTS, slots=SERVE_SLOTS,
                queue=SERVE_QUEUE, attn_impl=None, leg="serving"):
    """Drive the serving path once with the flash kernel, counted and
    checked, then against the one-shot loop and the ``xla`` attention
    path; time and profile it.  ``attn_impl`` is the first engine's
    attention path (``None``: what the device implies; a rehearsal on the
    CPU passes ``"cuda"`` to reach the flash wrapper's plain version).
    ``leg`` names the phase and its legs (``leg`` and ``leg``_xla).  A
    config with MoE layers also checks that its experts are resident as
    bf16 and TF32 is off, logs the routing of the two requests held to
    the one-shot loop in both engines (:func:`routing_flips`) and labels
    the experts and the router in the profile.  Returns (legs, the q, k,
    v and causal flag of the first flash call)."""
    M, serve = m["M"], m["serve"]
    ops = m["ops"]
    moe = cfg.n_experts > 0
    _sync(device)
    base = _allocated(device)
    params = M.init_params(torch.Generator(device=device).manual_seed(0),
                           cfg)
    expert_bytes = experts_bf16(leg, params) if moe else 0
    if moe:
        no_tf32(leg)
    _sync(device)
    resident = _allocated(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    recorded = []

    for op in ops.values():
        op.launches = 0
    stores, tables = serve.feature_stores(m["make_context"](device), 0,
                                          max(slots, 8))
    lookups = count_lookups(stores)
    before_engine = _allocated(device)
    engine = m["ServingEngine"](
        cfg, params, slots=slots, prompt_capacity=prompt_cap,
        gen_capacity=gen_cap, queue_capacity=queue, feature_stores=stores,
        attn_impl=attn_impl, device=device)
    res_check = resident_check(m, cfg, slots, prompt_cap + gen_cap,
                               resident - base,
                               _allocated(device) - before_engine)
    reqs = serve.make_requests(cfg, n_req, prompt_cap, gen_cap, seed=0)
    pick = [r.req_id for r in reqs if r.gen_len > 1][:2]
    routes, xroutes = (RouteLog(m["Moe"]), RouteLog(m["Moe"])) if moe \
        else (None, None)
    rec = Recorder(engine, keep=set(pick), routes=routes)
    with recording(ops["flash_attention"], "flash_attention", recorded,
                   picks={0}), (routes or contextlib.nullcontext()):
        done, rejected, seconds = serve.drive(engine, reqs, slots)
    _sync(device)
    launches = {k: op.launches for k, op in ops.items()}
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0) - resident

    mt = engine.metrics
    check_engine_run(leg, engine, done, rejected, reqs, tables, stores)
    # one shuffle per ingest chunk and per lookup; the lookups' sortmerge
    # join and the ingest append run no radix pass
    expect_launches(leg, launches, {
        "flash_attention": cfg.n_layers * mt.count("prefills"),
        "hash_partition": store_chunks(serve, stores) + lookups[0],
        "radix_sort": 0})
    by_id = {r.req_id: r for r in done}
    oneshot = against_oneshot(m, cfg, params, rec, by_id, pick, device)

    # the same requests on the plain attention path
    for op in ops.values():
        op.launches = 0
    n_lookups = lookups[0]
    xla = m["ServingEngine"](
        cfg, params, slots=slots, prompt_capacity=prompt_cap,
        gen_capacity=gen_cap, queue_capacity=queue, feature_stores=stores,
        attn_impl="xla", device=device)
    xrec = Recorder(xla, keep=set(pick) if moe else (), routes=xroutes)
    xreqs = twin_requests(serve.make_requests(
        cfg, n_req, prompt_cap, gen_cap, seed=0), XLA_TWIN_REQUESTS)
    with xroutes or contextlib.nullcontext():
        xdone, _, xseconds = serve.drive(xla, xreqs, slots)
    _sync(device)
    xlaunches = {k: op.launches for k, op in ops.items()}
    expect_launches(f"{leg}_xla", xlaunches, {
        "hash_partition": lookups[0] - n_lookups, "radix_sort": 0})
    check_served(xdone, xreqs, tables, len(xreqs))
    want = {r.req_id: r for r in xdone}
    if not set(pick) <= set(want):
        raise AssertionError(f"{leg}: the twin lacks requests {pick}")
    routing = routing_flips(cfg, routes, xroutes, pick, by_id, want) \
        if moe else None
    if moe:
        emit({"phase": f"{leg}_routing", **routing})
    diffs = {rid: float((rec.logits[rid] - lg).abs().max())
             for rid, lg in xrec.logits.items()}
    worst = max(diffs.values())
    if worst > SERVE_LOGIT_TOL:
        raise AssertionError(f"{leg}: flash and xla prefill logits differ "
                             f"by {worst} > {SERVE_LOGIT_TOL}")
    compared = sum(greedy_agree(by_id[rid].out_tokens, r.out_tokens,
                                xrec.margins[rid], SERVE_LOGIT_TOL)
                   for rid, r in want.items())
    if compared == 0:
        raise AssertionError(f"{leg}: no token compared with the xla run")
    # the noise of plain attention alone: attention_ref (float32, -inf
    # masks, other sums) against xla on the first request's prompt
    r0 = reqs[0]
    padded = np.zeros((1, prompt_cap), np.int32)
    padded[0, :len(r0.prompt)] = r0.prompt
    batch = {"tokens": torch.from_numpy(padded).to(device)}
    ref_logits, _ = M.make_slot_prefill(
        cfg, decode_len=prompt_cap + gen_cap, attn_impl="ref")(
        params, batch, len(r0.prompt))
    ref_vs_xla = float((ref_logits[0].float().cpu()
                        - xrec.logits[r0.req_id]).abs().max())

    # time one full-length prefill and one decode step of all slots
    prefill = M.make_slot_prefill(cfg, decode_len=prompt_cap + gen_cap)
    full = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, prompt_cap)).astype(np.int32)).to(device)}
    step = M.make_serve_step(cfg)
    toks = torch.zeros((slots, 1), dtype=torch.int32, device=device)
    lens = np.full(slots, prompt_cap - 1, np.int32)
    prefill_ms = event_ms(lambda: prefill(params, full, prompt_cap), reps=5)
    step_ms = event_ms(lambda: step(params, engine.caches, toks, lens),
                       reps=10)
    # one layer's decode attention alone, at the step's shapes
    q1 = torch.randn((slots, cfg.n_heads, 1, cfg.d_head), device=device) \
        .to(torch.bfloat16)
    lens_dev = torch.as_tensor(lens, device=device)
    decode_attention_ms = event_ms(lambda: m["A"].decode_attention(
        q1, engine.caches["k"][0], engine.caches["v"][0], lens_dev))

    def decode8():
        for _ in range(8):
            step(params, engine.caches, toks, lens)

    labelled = [(m["Ly"], "dense"), (m["A"], "decode_attention"),
                (m["Ly"], "logits_out"),
                (ops["flash_attention"], "flash_attention")]
    if moe:
        labelled += [(m["Moe"], "_expert_ffn"), (m["Moe"], "_route")]
    prof = profile_serving(m, {
        "prefill": lambda: prefill(params, full, prompt_cap),
        "decode_8_steps": decode8}, device, labelled,
        [("flash_attention", "flash_attention_kernel")])
    busy = sum(p["device_busy_ms"] for p in prof.values()) \
        / sum(p["wall_ms"] for p in prof.values())
    tokens = mt.count("tokens_generated")
    summary = {
        "phase": leg, "arch": cfg.name, "layers": cfg.n_layers,
        "d_model": cfg.d_model, "slots": slots, "prompt_capacity":
        prompt_cap, "gen_capacity": gen_cap, "requests": n_req,
        "completed": mt.count("completed"), "prefills": mt.count("prefills"),
        "decode_steps": mt.count("decode_steps"), "tokens": tokens,
        "prompt_tokens": int(sum(len(r.prompt) for r in reqs)),
        "seconds": seconds, "tokens_per_s": tokens / seconds,
        "ttft_p50_ms": mt.percentile("ttft", 50) * 1e3,
        "ttft_p99_ms": mt.percentile("ttft", 99) * 1e3,
        "latency_p50_ms": mt.percentile("latency", 50) * 1e3,
        "latency_p99_ms": mt.percentile("latency", 99) * 1e3,
        "prefill_ms": prefill_ms, "decode_step_ms": step_ms,
        "decode_attention_ms_per_layer": decode_attention_ms,
        "peak_bytes_above_resident": peak, "resident_bytes": resident,
        "resident_check": res_check,
        "weight_bytes": sum(t.numel() * t.element_size()
                            for t in _leaves(params)),
        "expert_bytes": expert_bytes, "routing": routing,
        "feature_lookups": n_lookups, "dropped": 0, "launches": launches,
        "oneshot": oneshot, "xla_seconds": xseconds,
        "xla_tokens_per_s": xla.metrics.count("tokens_generated")
        / xseconds,
        "xla_launches": xlaunches, "logit_tol": SERVE_LOGIT_TOL,
        "prefill_logit_diff_max": worst,
        "prefill_logit_diff_median": float(np.median(list(diffs.values()))),
        "logit_diff_ref_vs_xla": ref_vs_xla,
        "tokens_compared_with_xla": compared,
        "xla_requests": len(xreqs),
        "tokens_equal_xla": sum(
            by_id[rid].out_tokens[:len(r.out_tokens)] == r.out_tokens
            for rid, r in want.items()),
        "busy_share_prefill_plus_8_decode": busy, "profile": prof}
    emit(summary)
    legs = {leg: dict(launches=launches, rows=n_req, resident=res_check,
                      prefill=dict(ms=prefill_ms, prompt=prompt_cap,
                                   decode_len=prompt_cap + gen_cap)),
            f"{leg}_xla": dict(launches=xlaunches, rows=len(xreqs))}
    del params, engine, xla, stores, prefill, step, full
    _free(device)
    return legs, recorded[0]


# --------------------------------------------------------------------------
# the MoE serving path over a mesh: tensor and expert parallelism at world
# 2, and data=2 x model=2 with the slots split over the data ranks and
# the weights' 2D slices gathered over them in every forward; the ranks
# are processes on the one card
# --------------------------------------------------------------------------

# layers of the world-2 phase: 2 of Granite-3.0-MoE's 32 (at 32 the phase
# took 141-180 s, at 16 101-145 s, at 8 53.8 s, at 4 38.7-53.2 s, most
# of it gloo's loopback; the mesh training phases and then the data=2 x
# model=2 phase pushed the script toward its 1 200 s)
TP_LAYERS = 2
# layers of the data=2 x model=2 phase: 2 of the 32.  Every forward
# gathers each layer's 2D slices over the data ranks through host memory
# (516 MB a rank a forward at 8 layers): at 8 the phase took 452-470 s, a
# prefill 2.24 s and a decode step 1.77 s, at 2 125-157 s (H100 80GB
# HBM3, 700 W), and the script must end within 1 200 s.  At 1 the no-drop
# prefill of the first request differed from world 1's by 0.64: with one
# layer e_down's scale (std / sqrt(2 layers)) makes the experts' output
# large, and a near tie of the router, computed on other row counts at
# world 1, flips one of a token's experts
DP_LAYERS = 2
# leg -> (mesh, layers)
MESH_SERVE = {"serving_moe_tp2": ({"data": 1, "model": 2}, TP_LAYERS),
              "serving_moe_dp2": ({"data": 2, "model": 2}, DP_LAYERS)}
# depth of the three engine serving legs, a quarter of each model's (40,
# 64, 32): with the mesh phases the script took 1 066-1 288 s of command
# at half depth, and with the data=2 serving phase 999-1 225 s, and it
# must end within 1 200 s
# Falcon-Mamba at 8 since the pod legs (16 before: serving_mamba and
# serving_mamba_tp2 took 15.9 and 43.3 s; with the pod legs the script
# took 1 116-1 341 s of its 1 200, the host's speed)
SERVE_LAYERS = {SERVE_ARCH: 10, MAMBA_ARCH: 8, MOE_ARCH: 8}
# requests of the Granite and Granite-MoE legs' plain-attention twins: the
# first 8 of their 32 (all 32 until the Jamba leg: they took 4.3 and 4.9
# s of the script, which then ran 1 014-1 030 s of its 1 200 on one host
# and 1 241 s on a slower one; H100 80GB HBM3, 700 W); the two requests
# held to the one-shot loop are among them
XLA_TWIN_REQUESTS = 8
# tokens a plain-path twin generates for each of its requests: the first
# 8 of the request's (its prefill logits and those tokens are what it is
# held to; the serving_moe_dp2 and serving_mamba_tp2 twins, which decode
# over gloo, took 12-13 and 10-11 s decoding up to 33 tokens)
TWIN_GEN = 8


def twin_requests(reqs, n):
    """The first ``n`` of ``reqs`` as a plain-path twin serves them: each
    one's ``gen_len`` cut to TWIN_GEN."""
    return [dataclasses.replace(r, gen_len=min(r.gen_len, TWIN_GEN))
            for r in reqs[:n]]
# requests of the plain-path twin and of the world-1 engine the mesh legs
# are held to: the first 4 of the leg's 32 (8 made the world-2 phase take
# 151 s; the twin is cut, never the main leg)
TP_TWIN_REQUESTS = 4
# serving_moe_dp2's twin on the first 2 of them: with the pod legs the
# script took 1 116 s of command (the legs 78.1 s; H100 80GB HBM3, 700 W),
# so the first cut; its 4-request twin took 15.3 s, and
# the decode steps run until its longest request (33 tokens) either way
DP_TWIN_REQUESTS = 2
# serving_moe_dp2 itself on the first 16 of the 32 requests since the pod
# legs (its engine drained 32 in 89.8 s; the script took 1 116-1 341 s of
# its 1 200 with them, the host's speed; H100 80GB HBM3, 700 W)
DP_REQUESTS = 16
# the Mamba legs at world 2, run by serving_moe_tp2's rank processes after
# it: Falcon-Mamba-7B served at serving_mamba's depth and held to its
# record, and trained at mamba_train's config for MAMBA_TP_TRAIN_STEPS
# steps, its first held to mamba_train's first
TP2_MESH = {"data": 1, "model": 2}
MAMBA_TP_LEGS = ("serving_mamba_tp2", "mamba_train_tp2")
MAMBA_TP_TRAIN_STEPS = 2
MAMBA_WORLD1 = "serving_mamba_world1.pt"
# the enc-dec and vision legs at world 2, run by the same rank processes
# after the Mamba legs: SeamlessM4T-Large-v2 and InternVL2-2B served at
# full width and depth on the first one-shot batch (ONESHOT_TP_GEN greedy
# tokens), held to their world-1 legs' records, and Seamless trained at
# full size for SEAMLESS_TP_TRAIN_STEPS steps, its first held to
# seamless_train's first.  8 tokens and 1 step, not 32 and 2: with them
# the script took 1 187 s of its 1 200 (the legs 157 s; H100 80GB HBM3,
# 700 W)
ENCDEC_TP_LEGS = ("serving_seamless_tp2", "serving_internvl_tp2",
                  "seamless_train_tp2")
ONESHOT_TP = {"serving_seamless_tp2": (SEAMLESS_ARCH, "serving_seamless"),
              "serving_internvl_tp2": (INTERNVL_ARCH, "serving_internvl")}
ONESHOT_TP_GEN = 8
SEAMLESS_TP_TRAIN_STEPS = 1
SEAMLESS_TRAIN_WORLD1 = "seamless_train_world1.json"
# row 0's gathered caches of a layer against world 1's: the largest
# difference within CACHE_TOL of the largest |want| (the CPU tests hold
# the caches at (1, 2), (2, 1) and (2, 2) to the reference within 2e-2),
# or within twice what plain attention's other roundings move that
# layer's caches at world 1 (the world-1 leg's twin): 24 random-weight
# layers amplify one rounding's difference, and a model rank's partial
# products are rounded before their sum
CACHE_TOL = 2e-2
# two batch axes (pod x data, ROADMAP Queue 1 item 3) on the card: four
# ranks at pod=2 x data=2 x model=1 in processes that exist already,
# serving_moe_pod2 in serving_moe_dp2's after it (its config, DP_LAYERS
# layers, the first TP_TWIN_REQUESTS requests, held to its world-1 record)
# and moe_train_pod2 in moe_train_mesh's after it (MESH_CHECK_LAYERS
# layers, one row of MESH_TRAIN_SEQ tokens a batch rank).  At model 1 a
# MoE layer runs moe_dense, as the reference's moe_apply does: no
# dispatch plan; the serving leg's hash_partition launches are its
# feature stores' shuffles, and the training leg launches no kernel
POD_MESH = {"pod": 2, "data": 2, "model": 1}
POD_LEGS = ("serving_moe_pod2", "moe_train_pod2")
POD_TRAIN_ROWS = 4


class DispatchLog:
    """While active (a context), ``moe.radix_histogram_ranks`` also keeps
    copies (host) of the ids of the first ``n_prefill`` calls at P =
    ``n_experts`` (the first prefill's ``moe_shuffle`` plans, one a
    layer) and of the first call at P = ``local experts + 1`` (a
    ``moe_decode`` plan).  Launches are counted as without it."""

    def __init__(self, moe, n_experts, n_local, n_prefill):
        self.moe, self.plain = moe, moe.radix_histogram_ranks
        self.P, self.P_dec, self.n = n_experts, n_local + 1, n_prefill
        self.prefill, self.decode = [], []

    def ranks(self, pid, P):
        if P == self.P and len(self.prefill) < self.n:
            self.prefill.append((pid.cpu(), P))
        elif P == self.P_dec and not self.decode:
            self.decode.append((pid.cpu(), P))
        return self.plain(pid, P)

    def __enter__(self):
        self.moe.radix_histogram_ranks = self.ranks
        return self

    def __exit__(self, *exc):
        self.moe.radix_histogram_ranks = self.plain


def profile_tp2(fns, device, rank, warm=True):
    """Each of ``fns`` once warmed (unless ``warm`` is false: the caller
    ran it already), then once more, under ``torch.profiler`` on rank 0
    (the other ranks run the same calls unprofiled, so the collectives
    pair up): wall ms, device busy ms and share, the host ms of the
    collectives (gloo's ranges) and of the staging copies, and the top
    host and device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for key, fn in fns.items():
        if warm:
            fn()
            _sync(device)
        if rank:
            fn()
            _sync(device)
            continue
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            _sync(device)
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        dev = [e for e in events if e.device_type == DeviceType.CUDA]
        host = [e for e in events if e.device_type == DeviceType.CPU]
        busy = sum(e.self_device_time_total for e in dev) / 1e3
        gloo = [e for e in host if e.key.startswith("gloo:")]
        copies = [e for e in dev if "Memcpy" in e.key]
        host.sort(key=lambda e: -e.self_cpu_time_total)
        dev.sort(key=lambda e: -e.self_device_time_total)
        out[key] = {
            "wall_ms": wall_ms, "device_busy_ms": busy,
            "device_busy_share": busy / wall_ms,
            "collective_host_ms": sum(e.cpu_time_total for e in gloo) / 1e3,
            "collectives": sum(e.count for e in gloo),
            "copy_device_ms": sum(e.self_device_time_total
                                  for e in copies) / 1e3,
            "top_host": [{"name": e.key[:60], "count": e.count,
                          "self_ms": e.self_cpu_time_total / 1e3}
                         for e in host[:6]],
            "top_device": [{"name": e.key[:60], "count": e.count,
                            "ms": e.self_device_time_total / 1e3}
                           for e in dev[:6]]}
    return out


def mesh_rank(rank, world, store, tmp, legs):
    """One rank of mesh legs, in turn: the normal ``--mesh`` rank set-up
    of ``launch/serve.py`` (its device, the process group, each leg's
    mesh, made when a leg first needs it, and ``make_policy(mesh,
    "fsdp_tp")``), then for each leg of ``legs`` :func:`serve_mesh` (a
    leg of ``MESH_SERVE``), :func:`serve_mamba_mesh` or
    :func:`mamba_train_mesh`; writes each leg's record to
    ``tmp/<leg>_rank<r>.json`` (and rank 0 the kernel inputs to
    ``tmp/<leg>_cases.pt``); the legs of ``ENCDEC_TP_LEGS`` by
    :func:`serve_oneshot_mesh` and :func:`seamless_train_mesh`, those of
    ``POD_LEGS`` by :func:`serve_pod_mesh` and :func:`pod_train`."""
    m = _modules()
    device = m["serve"].rank_device(rank, world)
    m["Me"].init_rank(rank, world, store, device, timeout_s=600)
    tmp = Path(tmp)
    meshes = {}
    try:
        for leg in legs:
            shape = POD_MESH if leg in POD_LEGS else MESH_SERVE[leg][0] \
                if leg in MESH_SERVE else TP2_MESH
            key = tuple(shape.items())
            if key not in meshes:       # every rank makes it, in turn
                meshes[key] = m["Me"].make_mesh(shape)
            mesh = meshes[key]
            t0 = time.perf_counter()
            cases = None
            if leg == "serving_moe_pod2":
                record, cases = serve_pod_mesh(
                    m, device, m["Sh"].make_policy(mesh, "fsdp_tp"), tmp)
            elif leg == "moe_train_pod2":
                record = pod_train(m, device, mesh, rank)
            elif leg in MESH_SERVE:
                record, cases = serve_mesh(
                    m, device, m["Sh"].make_policy(mesh, "fsdp_tp"), leg,
                    tmp / f"{leg}_world1.pt")
            elif leg == "serving_mamba_tp2":
                record, cases = serve_mamba_mesh(
                    m, device, m["Sh"].make_policy(mesh, "fsdp_tp"), tmp)
            elif leg in ONESHOT_TP:
                record, cases = serve_oneshot_mesh(
                    m, device, m["Sh"].make_policy(mesh, "fsdp_tp"), leg,
                    tmp)
            elif leg == "seamless_train_tp2":
                record = seamless_train_mesh(
                    m, device, m["Sh"].make_policy(mesh, "tp"), tmp)
            else:
                record = mamba_train_mesh(
                    m, device, m["Sh"].make_policy(mesh, "tp"), tmp)
            _free(device)
            record["leg_s"] = time.perf_counter() - t0
            (tmp / f"{leg}_rank{rank}.json").write_text(json.dumps(record))
            if rank == 0 and cases is not None:
                torch.save(cases, tmp / f"{leg}_cases.pt")
    finally:
        torch.distributed.destroy_process_group()


def _drops_logged(Moe, fn, into):
    """``fn`` with the rows each of its calls dropped, by layer, appended
    to ``into`` (``Moe.drop_log``)."""

    def run(*args):
        Moe.drop_log = []
        try:
            return fn(*args)
        finally:
            into.append([int(d) for d in Moe.drop_log])
            Moe.drop_log = None
    return run


def gathered_bytes(Sh, policy, params) -> int:
    """The bytes a rank receives a forward in the data axis's weight
    gathers (each 2D leaf from the other data ranks)."""
    if not policy.fsdp:
        return 0
    specs = policy.param_specs(params, use2d=True)

    def walk(node, spec):
        if isinstance(node, dict):
            return sum(walk(v, spec[k]) for k, v in node.items())
        if Sh.data_dim(spec) is None:
            return 0
        return node.numel() * node.element_size() * (policy.world_fsdp - 1)
    return walk(params, specs)


def serve_mesh(m, device, policy, leg, w1_path):
    """Serve the MoE leg's requests under ``policy`` with the feature
    stores over every rank; check and time them; hold them to the world-1
    engine of ``w1_path`` (:func:`mesh_world1`): the first request at a
    capacity where no row drops (its prefill logits), and every one of
    its requests whose prefill dropped no row (greedy tokens); then the
    plain-path twin: at world 2 at the leg's capacity against this
    engine, on a data axis of several ranks at the no-drop capacity
    against world 1.  Returns (this rank's record, the kernel inputs it
    recorded)."""
    M, serve, ops, Moe, Sh = m["M"], m["serve"], m["ops"], m["Moe"], m["Sh"]
    cfg = mesh_serve_config(m, leg)
    slots, prompt_cap, gen_cap = SERVE_SLOTS, SERVE_PROMPT, SERVE_GEN
    n_req = DP_REQUESTS if policy.world_d > 1 else SERVE_REQUESTS
    rank = torch.distributed.get_rank()
    no_tf32(leg)
    params = serve.sharded_params(cfg, device, 0, policy)
    gc.collect()
    torch.cuda.empty_cache()
    experts_bf16(leg, params)
    _sync(device)
    resident = _allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))

    for op in ops.values():
        op.launches = 0
    stores, tables = serve.feature_stores(m["make_context"](device), 0,
                                          max(slots, 8))
    lookups = count_lookups(stores)
    engine = m["ServingEngine"](
        cfg, params, policy=policy, slots=slots, prompt_capacity=prompt_cap,
        gen_capacity=gen_cap, queue_capacity=SERVE_QUEUE,
        feature_stores=stores, device=device)
    reqs = serve.make_requests(cfg, n_req, prompt_cap, gen_cap, seed=0)
    rec = Recorder(engine)
    drops, step_drops = [], []
    engine._slot_prefill = _drops_logged(Moe, engine._slot_prefill, drops)
    engine._serve_step = _drops_logged(Moe, engine._serve_step, step_drops)
    E_loc = Moe.n_experts_padded(cfg) // policy.world_m
    plans = DispatchLog(Moe, cfg.n_experts, E_loc, cfg.n_layers)
    flash = []
    with recording(ops["flash_attention"], "flash_attention", flash,
                   picks={0}), plans:
        done, rejected, seconds = serve.drive(engine, reqs, slots)
    _sync(device)
    launches = {k: op.launches for k, op in ops.items()}
    peak = torch.cuda.max_memory_allocated(device) - resident
    mt = engine.metrics
    check_engine_run(leg, engine, done, rejected, reqs, tables, stores)
    # a moe_shuffle plan per layer of each prefill and a moe_decode plan
    # per layer of each step, beside the stores' shuffles
    expect_launches(leg, launches, {
        "flash_attention": cfg.n_layers * mt.count("prefills"),
        "hash_partition": cfg.n_layers * (mt.count("prefills")
                                          + mt.count("decode_steps"))
        + store_chunks(serve, stores) + lookups[0],
        "radix_sort": 0})
    if any(len(d) != cfg.n_layers for d in drops + step_drops) \
            or len(plans.prefill) != cfg.n_layers or len(plans.decode) != 1:
        raise AssertionError(f"{leg}: drop counts of {len(drops)} prefills "
                             f"and {len(step_drops)} steps, "
                             f"{len(plans.prefill)} prefill and "
                             f"{len(plans.decode)} decode plans recorded")
    # rows dropped by any rank, for each prefill (in the order of the
    # requests' prefills) and in all decode steps
    dropped = torch.tensor([sum(d) for d in drops]
                           + [sum(map(sum, step_drops))])
    torch.distributed.all_reduce(dropped)
    prefill_drops = dict(zip(rec.logits, dropped[:-1].tolist()))

    # the first request where no row can drop (C_send = the rank's rows)
    # against world 1, whose MoE layers run every expert
    r0 = reqs[0]
    padded = np.zeros((1, prompt_cap), np.int32)
    padded[0, :len(r0.prompt)] = r0.prompt
    batch = {"tokens": torch.from_numpy(padded).to(device)}
    cf = cfg.n_experts / cfg.top_k
    cfg_nodrop = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, moe_capacity_factor=cf))
    nodrop = []
    logits, _ = _drops_logged(Moe, M.make_slot_prefill(
        cfg_nodrop, policy, decode_len=prompt_cap + gen_cap), nodrop)(
        params, batch, len(r0.prompt))
    w1 = torch.load(w1_path)
    # each rank holds its slice of every leaf under the spec table
    check_held(m, leg, params, policy, w1["shapes"])
    rows = Sh.batch_block(policy, slots)
    if engine.caches["k"].shape[1] != rows.stop - rows.start:
        raise AssertionError(f"{leg}: caches of "
                             f"{engine.caches['k'].shape[1]} slots for "
                             f"the rank's {rows}")
    vs_world1 = float((logits[0].float().cpu()
                       - w1["logits"][r0.req_id]).abs().max())
    engine_vs_world1 = float((rec.logits[r0.req_id]
                              - w1["logits"][r0.req_id]).abs().max())
    if any(nodrop[0]) or vs_world1 > SERVE_LOGIT_TOL:
        raise AssertionError(f"{leg}: at capacity factor {cf} "
                             f"{sum(nodrop[0])} rows dropped and the "
                             f"logits differ from world 1 by {vs_world1}")
    # the engine's tokens against world 1 where its routes dropped nothing
    by_id = {r.req_id: r for r in done}
    clean = [rid for rid in w1["tokens"]
             if prefill_drops[rid] == 0 and int(dropped[-1]) == 0]
    w1_compared = sum(greedy_agree(by_id[rid].out_tokens, w1["tokens"][rid],
                                   w1["margins"][rid], SERVE_LOGIT_TOL)
                      for rid in clean)

    # a full-length prefill and a decode step of all slots, timed on all
    # ranks at once (their collectives pair up)
    prefill = M.make_slot_prefill(cfg, policy,
                                  decode_len=prompt_cap + gen_cap)
    full = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, prompt_cap)).astype(np.int32)).to(device)}
    step = M.make_serve_step(cfg, policy)
    toks = torch.zeros((slots, 1), dtype=torch.int32, device=device)
    lens = np.full(slots, prompt_cap - 1, np.int32)
    prefill_ms = event_ms(lambda: prefill(params, full, prompt_cap), reps=3)
    step_ms = event_ms(lambda: step(params, engine.caches, toks, lens),
                       reps=4)
    prof = profile_tp2({
        "prefill": lambda: prefill(params, full, prompt_cap),
        "decode_4_steps": lambda: [step(params, engine.caches, toks, lens)
                                   for _ in range(4)]},
        device, rank, warm=False)

    # the twin: the same engine on plain attention and plain ranks; on a
    # data axis of several ranks at the no-drop capacity, held to world 1
    nodrop_twin = policy.world_d > 1
    for op in ops.values():
        op.launches = 0
    n_lookups = lookups[0]
    xla = m["ServingEngine"](
        cfg_nodrop if nodrop_twin else cfg, params, policy=policy,
        slots=slots, prompt_capacity=prompt_cap, gen_capacity=gen_cap,
        queue_capacity=SERVE_QUEUE, feature_stores=stores, attn_impl="xla",
        device=device)
    xrec = Recorder(xla)
    xdrops = []
    xla._slot_prefill = _drops_logged(Moe, xla._slot_prefill, xdrops)
    xreqs = twin_requests(serve.make_requests(
        cfg, n_req, prompt_cap, gen_cap, seed=0),
        DP_TWIN_REQUESTS if nodrop_twin else TP_TWIN_REQUESTS)
    Moe.radix_histogram_ranks = m["hp_ref"].radix_histogram_ranks_ref
    try:
        xdone, _, xseconds = serve.drive(xla, xreqs, slots)
    finally:
        Moe.radix_histogram_ranks = plans.plain
    _sync(device)
    xlaunches = {k: op.launches for k, op in ops.items()}
    expect_launches(f"{leg}_xla", xlaunches, {
        "flash_attention": 0, "hash_partition": lookups[0] - n_lookups,
        "radix_sort": 0})
    check_served(xdone, xreqs, tables, len(xreqs))
    if nodrop_twin and any(map(any, xdrops)):
        raise AssertionError(f"{leg}_xla: rows dropped at capacity {cf}")
    if nodrop_twin:
        against, want_logits, want_tokens, margins = \
            "world1", w1["logits"], w1["tokens"], w1["margins"]
    else:
        against, want_logits, margins = "engine", rec.logits, xrec.margins
        want_tokens = {rid: r.out_tokens for rid, r in by_id.items()}
    worst = max(float((want_logits[rid] - lg).abs().max())
                for rid, lg in xrec.logits.items())
    if worst > SERVE_LOGIT_TOL:
        raise AssertionError(f"{leg}: the plain twin's prefill logits "
                             f"differ from the {against} run's by {worst} "
                             f"> {SERVE_LOGIT_TOL}")
    compared = sum(greedy_agree(r.out_tokens, want_tokens[r.req_id],
                                margins[r.req_id], SERVE_LOGIT_TOL)
                   for r in xdone)
    if compared == 0:
        raise AssertionError(f"{leg}: no token of the twin compared")

    tokens = mt.count("tokens_generated")
    record = {
        "phase": leg, "rank": rank, "coord": policy.mesh.coord,
        "mesh": policy.mesh.shape, "arch": cfg.name,
        "layers": cfg.n_layers, "requests": n_req, "device": str(device),
        "backend": torch.distributed.get_backend(),
        "completed": mt.count("completed"), "prefills": mt.count("prefills"),
        "decode_steps": mt.count("decode_steps"), "tokens": tokens,
        "seconds": seconds, "tokens_per_s": tokens / seconds,
        "ttft_p50_ms": mt.percentile("ttft", 50) * 1e3,
        "ttft_p99_ms": mt.percentile("ttft", 99) * 1e3,
        "prefill_ms": prefill_ms, "decode_step_ms": step_ms,
        "weight_bytes": weight_bytes, "resident_bytes": resident,
        "gathered_bytes_per_forward": gathered_bytes(Sh, policy, params),
        "cache_rows": int(engine.caches["k"].shape[1]),
        "peak_bytes_above_resident": peak,
        "first_prefill_dropped_by_layer": drops[0],
        "prefills_without_drops": sum(d == 0 for d in
                                      prefill_drops.values()),
        "decode_rows_dropped": int(dropped[-1]),
        "capacity_send": math.ceil(prompt_cap // policy.world_m * cfg.top_k
                                   / cfg.n_experts
                                   * cfg.train.moe_capacity_factor),
        "launches": launches, "xla_launches": xlaunches,
        "nodrop_capacity_factor": cf,
        "nodrop_logit_diff_vs_world1": vs_world1,
        "engine_logit_diff_vs_world1": engine_vs_world1,
        "world1_requests_without_drops": clean,
        "world1_tokens_compared": w1_compared,
        "logit_tol": SERVE_LOGIT_TOL,
        "twin_requests": len(xreqs), "twin_seconds": xseconds,
        "twin_against": against,
        "twin_capacity_factor": cf if nodrop_twin
        else cfg.train.moe_capacity_factor,
        "twin_prefill_logit_diff_max": worst,
        "twin_tokens_compared": compared,
        "twin_tokens_equal": sum(
            r.out_tokens == want_tokens[r.req_id][:len(r.out_tokens)]
            for r in xdone),
        "profile": prof,
        "out_tokens": {r.req_id: r.out_tokens for r in done}}
    cases = {"plans": plans.prefill + plans.decode,
             "flash": tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                            for a in flash[0])}
    del engine, xla, params
    return record, cases


def serve_config(m, arch):
    """``arch`` at full width and SERVE_LAYERS[arch] layers."""
    return dataclasses.replace(m["get_config"](arch),
                               n_layers=SERVE_LAYERS[arch])


def mesh_serve_config(m, leg):
    return dataclasses.replace(m["get_config"](MOE_ARCH),
                               n_layers=MESH_SERVE[leg][1])


def mesh_world1(m, device, leg):
    """The world-1 engine (flash attention, every expert on every token)
    on the first TP_TWIN_REQUESTS requests of the leg's model, with the
    seed-0 weights the ranks draw: each request's prefill logits, greedy
    tokens and their top-2 margins, and every leaf's whole shape."""
    M, serve = m["M"], m["serve"]
    cfg = mesh_serve_config(m, leg)
    params = M.init_params(torch.Generator(device).manual_seed(0), cfg)
    engine = m["ServingEngine"](
        cfg, params, slots=SERVE_SLOTS, prompt_capacity=SERVE_PROMPT,
        gen_capacity=SERVE_GEN, queue_capacity=SERVE_QUEUE, device=device)
    rec = Recorder(engine)
    reqs = serve.make_requests(cfg, SERVE_REQUESTS, SERVE_PROMPT,
                               SERVE_GEN, seed=0)[:TP_TWIN_REQUESTS]
    done, _, _ = serve.drive(engine, reqs, SERVE_SLOTS)
    out = {"logits": rec.logits, "margins": dict(rec.margins),
           "tokens": {r.req_id: r.out_tokens for r in done},
           "shapes": {k: tuple(v.shape) for k, v in
                      m["Aw"].flatten_params(params).items()}}
    del engine, params
    _free(device)
    return out


def run_serving_mesh(m, device, tmpdir: Path, leg, then=()):
    """A mesh serving leg and its twin ``<leg>_xla``: the ranks of
    ``MESH_SERVE[leg]``, processes on the one card started by
    ``launch/serve.py``'s :func:`spawn` (gloo: NCCL refuses two ranks on
    one device), serving Granite-3.0-MoE-3B-A800M at full width with the
    ``serving_moe`` settings and requests (:func:`serve_mesh`).  A rank
    that fails fails the phase, and so do ranks whose tokens differ.
    Then the first prefill's dispatch plans (one a layer) and one decode
    plan against the plain ranks, and the first flash call's q, k, v.
    ``then``: the legs of ``MAMBA_TP_LEGS`` and ``ENCDEC_TP_LEGS`` the
    same rank processes run after it (:func:`mamba_tp2_results`,
    :func:`encdec_tp2_results`).  Returns (legs, kernel cases)."""
    mesh = MESH_SERVE[leg][0]
    world = math.prod(mesh.values())
    torch.save(mesh_world1(m, device, leg), tmpdir / f"{leg}_world1.pt")
    t0 = time.perf_counter()
    m["serve"].spawn(world, mesh_rank, (str(tmpdir), (leg,) + tuple(then)),
                     timeout_s=1000)
    wall = time.perf_counter() - t0
    recs = [json.loads(Path(tmpdir, f"{leg}_rank{r}.json").read_text())
            for r in range(world)]
    if any(r["out_tokens"] != recs[0]["out_tokens"] for r in recs):
        raise AssertionError(f"{leg}: the ranks' tokens differ")
    for r in recs:
        r.pop("out_tokens")
    emit({"phase": leg, "wall_s": wall, "ranks": recs})
    cases = torch.load(tmpdir / f"{leg}_cases.pt")
    legs = {}
    for name, key, rows in ((leg, "launches", recs[0]["requests"]),
                            (f"{leg}_xla", "xla_launches",
                             recs[0]["twin_requests"])):
        legs[name] = dict(rows=rows, launches={
            k: sum(r[key][k] for r in recs) for k in recs[0][key]})
    plans = []
    for i, (pid, P) in enumerate(cases["plans"]):
        pid = pid.to(device)
        what = f"prefill layer {i}" if i < len(cases["plans"]) - 1 \
            else "decode"
        plans.append(dict(
            shape=f"({leg[-3:]}) {what} n={pid.numel()} P={P}",
            args=(pid, P),
            library=lambda pid=pid: torch.argsort(pid, stable=True)))
    label = {"serving_moe_tp2": "(l)", "serving_moe_dp2": "(m)"}[leg]
    flash = recorded_flash_case(f"{label} {leg}", tuple(
        a.to(device) if isinstance(a, torch.Tensor) else a
        for a in cases["flash"]))
    out = {"hash_partition": plans, "flash_attention": [flash]}
    if set(MAMBA_TP_LEGS) & set(then):
        mamba_legs, mamba_cases = mamba_tp2_results(m, device, tmpdir)
        legs.update(mamba_legs)
        out.update(mamba_cases)
    if set(ENCDEC_TP_LEGS) & set(then):
        encdec_legs, encdec_cases = encdec_tp2_results(m, device, tmpdir)
        legs.update(encdec_legs)
        out["flash_attention"] += encdec_cases["flash_attention"]
    if "serving_moe_pod2" in then:
        pod_legs, pod_cases = pod_serving_results(m, device, tmpdir)
        legs.update(pod_legs)
        for kname, more in pod_cases.items():
            out[kname] += more
    return legs, out


def serve_pod_mesh(m, device, policy, tmp: Path):
    """``serving_moe_pod2`` on this rank: ``serving_moe_dp2``'s model
    (Granite-3.0-MoE-3B-A800M at full width, DP_LAYERS layers, seed 0)
    under ``policy`` (pod=2 x data=2 x model=1, ``fsdp_tp``: the slots
    over pod x data, each 2D leaf cut over data and gathered over it a
    layer at a time, whole over pod), the feature stores over every
    rank, on the first TP_TWIN_REQUESTS of the leg's requests; held to
    the world-1 record ``serving_moe_dp2`` wrote (the same weights and
    requests, every expert on every token, as moe_dense runs them here):
    every prefill's logits within SERVE_LOGIT_TOL and greedy tokens
    wherever the margin clears it.  Times a full-length prefill and a
    decode step of all slots by CUDA events on every rank at once,
    profiles them on rank 0.  Returns (this rank's record, the kernel
    inputs it recorded: the first flash call and the first shuffle's
    ranking of the feature stores)."""
    M, serve, ops, Sh = m["M"], m["serve"], m["ops"], m["Sh"]
    leg = "serving_moe_pod2"
    cfg = mesh_serve_config(m, "serving_moe_dp2")
    slots, prompt_cap, gen_cap = SERVE_SLOTS, SERVE_PROMPT, SERVE_GEN
    rank = torch.distributed.get_rank()
    no_tf32(leg)
    params = serve.sharded_params(cfg, device, 0, policy)
    gc.collect()
    torch.cuda.empty_cache()
    experts_bf16(leg, params)
    _sync(device)
    resident = _allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    w1 = torch.load(tmp / "serving_moe_dp2_world1.pt")
    check_held(m, leg, params, policy, w1["shapes"])

    for op in ops.values():
        op.launches = 0
    flash, shuffles = [], []
    with recording(m["D"], "radix_histogram_ranks", shuffles, picks={0}):
        stores, tables = serve.feature_stores(m["make_context"](device), 0,
                                              max(slots, 8))
        lookups = count_lookups(stores)
        engine = m["ServingEngine"](
            cfg, params, policy=policy, slots=slots,
            prompt_capacity=prompt_cap, gen_capacity=gen_cap,
            queue_capacity=SERVE_QUEUE, feature_stores=stores, device=device)
        reqs = serve.make_requests(cfg, SERVE_REQUESTS, prompt_cap, gen_cap,
                                   seed=0)[:TP_TWIN_REQUESTS]
        rec = Recorder(engine)
        with recording(ops["flash_attention"], "flash_attention", flash,
                       picks={0}):
            done, rejected, seconds = serve.drive(engine, reqs, slots)
    _sync(device)
    launches = {k: op.launches for k, op in ops.items()}
    peak = torch.cuda.max_memory_allocated(device) - resident
    mt = engine.metrics
    check_engine_run(leg, engine, done, rejected, reqs, tables, stores)
    # flash in every layer of each prefill; the stores' shuffles (moe_dense
    # makes no dispatch plan at model 1)
    expect_launches(leg, launches, {
        "flash_attention": cfg.n_layers * mt.count("prefills"),
        "hash_partition": store_chunks(serve, stores) + lookups[0],
        "radix_sort": 0})
    rows = Sh.batch_block(policy, slots)
    if engine.caches["k"].shape[1] != rows.stop - rows.start:
        raise AssertionError(f"{leg}: caches of "
                             f"{engine.caches['k'].shape[1]} slots for "
                             f"the rank's {rows}")
    diffs = {rid: float((rec.logits[rid] - w1["logits"][rid]).abs().max())
             for rid in w1["logits"]}
    if max(diffs.values()) > SERVE_LOGIT_TOL:
        raise AssertionError(f"{leg}: prefill logits differ from world 1's "
                             f"by {diffs} > {SERVE_LOGIT_TOL}")
    by_id = {r.req_id: r for r in done}
    compared = sum(greedy_agree(by_id[rid].out_tokens, w1["tokens"][rid],
                                w1["margins"][rid], SERVE_LOGIT_TOL)
                   for rid in w1["tokens"])
    if compared == 0:
        raise AssertionError(f"{leg}: no token compared with world 1's")

    prefill = M.make_slot_prefill(cfg, policy,
                                  decode_len=prompt_cap + gen_cap)
    full = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, prompt_cap)).astype(np.int32)).to(device)}
    step = M.make_serve_step(cfg, policy)
    toks = torch.zeros((slots, 1), dtype=torch.int32, device=device)
    lens = np.full(slots, prompt_cap - 1, np.int32)
    prefill_ms = event_ms(lambda: prefill(params, full, prompt_cap), reps=3)
    step_ms = event_ms(lambda: step(params, engine.caches, toks, lens),
                       reps=4)
    prof = profile_tp2({
        "prefill": lambda: prefill(params, full, prompt_cap),
        "decode_4_steps": lambda: [step(params, engine.caches, toks, lens)
                                   for _ in range(4)]},
        device, rank, warm=False)
    tokens = mt.count("tokens_generated")
    record = {
        "phase": leg, "rank": rank, "coord": policy.mesh.coord,
        "batch_rank": policy.batch_rank, "mesh": policy.mesh.shape,
        "arch": cfg.name, "layers": cfg.n_layers, "requests": len(reqs),
        "device": str(device), "backend": torch.distributed.get_backend(),
        "completed": mt.count("completed"), "prefills": mt.count("prefills"),
        "decode_steps": mt.count("decode_steps"), "tokens": tokens,
        "seconds": seconds, "tokens_per_s": tokens / seconds,
        "prefill_ms": prefill_ms, "decode_step_ms": step_ms,
        "weight_bytes": weight_bytes, "resident_bytes": resident,
        "gathered_bytes_per_forward": gathered_bytes(Sh, policy, params),
        "cache_rows": int(engine.caches["k"].shape[1]),
        "peak_bytes_above_resident": peak, "launches": launches,
        "prefill_logit_diff_vs_world1": diffs,
        "world1_tokens_compared": compared, "logit_tol": SERVE_LOGIT_TOL,
        "profile": prof,
        "out_tokens": {r.req_id: r.out_tokens for r in done}}
    cases = {"flash": tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                            for a in flash[0]),
             "shuffle": tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                              for a in shuffles[0])}
    del engine, params
    return record, cases


def pod_serving_results(m, device, tmpdir: Path):
    """``serving_moe_pod2``'s records (the ranks' tokens must agree) and
    its kernel cases: rank 0's first flash call, case (p), and its
    stores' first ranking.  Returns (legs, kernel cases)."""
    leg = "serving_moe_pod2"
    world = math.prod(POD_MESH.values())
    recs = [json.loads(Path(tmpdir, f"{leg}_rank{r}.json").read_text())
            for r in range(world)]
    if any(r["out_tokens"] != recs[0]["out_tokens"] for r in recs):
        raise AssertionError(f"{leg}: the ranks' tokens differ")
    for r in recs:
        r.pop("out_tokens")
    emit({"phase": leg, "ranks": recs})
    cases = torch.load(tmpdir / f"{leg}_cases.pt")
    flash = recorded_flash_case(f"(p) {leg}", tuple(
        a.to(device) if isinstance(a, torch.Tensor) else a
        for a in cases["flash"]))
    pid, P = cases["shuffle"]
    pid = pid.to(device)
    shuffle = dict(shape=f"(pod2) store shuffle n={pid.numel()} P={P}",
                   args=(pid, P),
                   library=lambda pid=pid: torch.argsort(pid, stable=True))
    legs = {leg: dict(rows=recs[0]["requests"], launches={
        k: sum(r["launches"][k] for r in recs) for k in recs[0]["launches"]})}
    return legs, {"flash_attention": [flash], "hash_partition": [shuffle]}


def pod_train(m, device, mesh, rank) -> dict:
    """``moe_train_pod2`` on this rank: Granite-3.0-MoE-3B-A800M at full
    width and MESH_CHECK_LAYERS layers under ``fsdp_tp`` at ``mesh``
    (pod=2 x data=2 x model=1: the rows over pod x data, the 2D leaves
    and the AdamW moments cut over data and whole over pod, the
    gradients averaged over all four), seed-0 weights, one step on
    POD_TRAIN_ROWS rows of MESH_TRAIN_SEQ tokens (one a batch rank); on
    rank 0 held to the port's world-1 step of the same weights and batch
    in one microbatch a batch rank (the same grouping of bf16 sums) with
    every MoE layer pinned to the routes the ranks took and the whole
    batch's aux, as a dense MoE layer takes it at the mesh
    (:func:`whole_batch_routes`), by the leaf rule (the noise allowance
    from the same step in one microbatch, :func:`order_noise`), the
    loss, ``moe_aux`` and the grad norm.  Then one more step, timed by CUDA
    events, writing the state in place.  The layers run moe_dense and
    plain attention: no kernel launches.  Returns this rank's record
    (rank 0's with the check)."""
    M, A, Sh, Moe, Ck, ops = (m["M"], m["Aw"], m["Sh"], m["Moe"], m["Ck"],
                              m["ops"])
    leg = "moe_train_pod2"
    no_tf32(leg)
    full = m["get_config"](MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MESH_CHECK_LAYERS)
    policy = Sh.make_policy(mesh, "fsdp_tp")
    opt_cfg = A.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=2)
    whole_batch = lm_batch(m, cfg, 0, POD_TRAIN_ROWS, MESH_TRAIN_SEQ,
                           device)
    params, opt = mesh_state(m, cfg, device, policy, opt_cfg)
    held = lambda tree: sum(t.numel() * t.element_size()     # noqa: E731
                            for t in A.flatten_params(tree).values())
    master_bytes, moment_bytes = held(params), held(opt["m"]) + held(opt["v"])
    ids, plain = [], Moe._route

    def route(router, x2d, top_k):
        out = plain(router, x2d, top_k)
        if not Moe._recomputing:
            ids.append(out[1].cpu().numpy())
        return out

    batch = Sh.shard_batch(whole_batch, policy)
    for op in ops.values():
        op.launches = 0
    _sync(device)
    _reset_peak(device)
    resident = _allocated(device)
    step = M.make_train_step(cfg, policy, opt_cfg, donate=True)
    mets, events = [], []
    Moe._route = route
    try:
        for i in range(2):
            ev = event_pair()
            ev[0].record()
            params, opt, met = step(params, opt, batch)
            ev[1].record()
            mets.append({k: float(v) for k, v in met.items()})
            events.append(ev)
            if i == 0:       # the first step's state, whole on rank 0
                torch.cuda.synchronize()
                layout = Sh.train_state_layout(policy, params, opt, cfg)
                whole = layout.whole(Ck.tree_leaves((params, opt)))
                arrays = None if whole is None \
                    else whole_arrays(m, params, opt, whole)
                del whole
        torch.cuda.synchronize()
    finally:
        Moe._route = plain
    launches = {k: op.launches for k, op in ops.items()}
    peak = _peak(device) - resident
    ms = [a.elapsed_time(b) for a, b in events]
    expect_launches(leg, launches, {k: 0 for k in launches})
    routes = gather_objects(ids[:cfg.n_layers])
    del params, opt
    _free(device)
    check = None
    if rank == 0:
        S = MESH_TRAIN_SEQ
        # batch rank r (pod major) holds row r: the ranks in global order
        layers = [np.concatenate([r[L].reshape(1, S, -1) for r in routes])
                  for L in range(cfg.n_layers)]
        w1s = {}
        for micro in (POD_TRAIN_ROWS, 1):
            w1cfg = dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, microbatches=micro))
            w1p = M.init_params(torch.Generator(device).manual_seed(0),
                                w1cfg, master=True)
            Moe._route = whole_batch_routes(Moe, layers,
                                            POD_TRAIN_ROWS // micro)
            try:
                new, w1opt, met = M.make_train_step(w1cfg, None, opt_cfg)(
                    w1p, A.init(A.flatten_params(w1p), opt_cfg),
                    whole_batch)
                _sync(device)
                w1s[micro] = (state_arrays(m, new, w1opt),
                              {k: float(v) for k, v in met.items()})
            finally:
                Moe._route = plain
            del w1p, new, w1opt
            _free(device)
        w1, w1met = w1s[POD_TRAIN_ROWS]
        noise = order_noise(w1s[1][0], w1, device)
        check = {"vs_world1": leaf_rule(arrays, w1, w1met["lr"], device,
                                        noise),
                 "world1": w1met, "pod": mets[0],
                 "world1_one_microbatch": w1s[1][1],
                 "order_noise_max": {
                     mo: max(v for (x, _), v in noise.items() if x == mo)
                     for mo in ("m", "v")}}
        for k, tol in (("loss", LM_LOSS_RTOL), ("moe_aux", LM_LOSS_RTOL),
                       ("grad_norm", LM_GNORM_RTOL)):
            e = rel_err(mets[0][k], w1met[k])
            check["vs_world1"][f"{k}_rel_err"] = e
            if e > tol:
                check["vs_world1"]["failed"].append(
                    f"{k} {mets[0][k]} vs {w1met[k]}")
        print(json.dumps({"moe_train_pod2_check": check}), flush=True)
        if check["vs_world1"]["failed"]:
            raise AssertionError(f"{leg}: {check}")
    torch.distributed.barrier()
    return {"phase": leg, "rank": torch.distributed.get_rank(),
            "coord": mesh.coord, "batch_rank": policy.batch_rank,
            "device": str(device), "backend": torch.distributed.get_backend(),
            "arch": cfg.name, "layers": cfg.n_layers,
            "of_layers": full.n_layers, "flavor": policy.flavor,
            "rows": POD_TRAIN_ROWS, "seq": MESH_TRAIN_SEQ,
            "step_ms": ms, "timed_step_ms": ms[-1],
            "tokens_per_s": POD_TRAIN_ROWS * MESH_TRAIN_SEQ / ms[-1] * 1e3,
            "master_bytes": master_bytes, "moment_bytes": moment_bytes,
            "resident_bytes": resident, "peak_bytes_above_resident": peak,
            "launches": launches, "losses": [x["loss"] for x in mets],
            "moe_aux": [x["moe_aux"] for x in mets], "check": check}


def pod_train_results(m, tmpdir: Path) -> dict:
    """``moe_train_pod2``'s records: every rank's losses alike.  Returns
    its leg."""
    leg = "moe_train_pod2"
    world = math.prod(POD_MESH.values())
    recs = [json.loads(Path(tmpdir, f"{leg}_rank{r}.json").read_text())
            for r in range(world)]
    if any(r["losses"] != recs[0]["losses"] for r in recs):
        raise AssertionError(f"{leg}: the ranks' losses differ")
    emit({"phase": leg, "ranks": recs})
    return {leg: dict(rows=POD_TRAIN_ROWS, launches={
        k: sum(r["launches"][k] for r in recs) for k in recs[0]["launches"]})}


def run_pod2(m, device, tmpdir: Path):
    """The two pod legs alone, in four rank processes of their own:
    ``serving_moe_dp2``'s world-1 record first, then
    :func:`serve_pod_mesh` and :func:`pod_train` in each rank.  Returns
    (legs, kernel cases)."""
    torch.save(mesh_world1(m, device, "serving_moe_dp2"),
               tmpdir / "serving_moe_dp2_world1.pt")
    m["serve"].spawn(math.prod(POD_MESH.values()), mesh_rank,
                     (str(tmpdir), POD_LEGS), timeout_s=1000)
    legs, cases = pod_serving_results(m, device, tmpdir)
    legs.update(pod_train_results(m, tmpdir))
    return legs, cases


def check_held(m, leg, params, policy, shapes) -> None:
    """Each leaf of ``params`` is this rank's slice under the spec table
    (``sharding.shard_slices``, ``in_proj`` by its per-part rule) of the
    whole leaf of ``shapes``."""
    Sh = m["Sh"]
    sizes, coord = policy.mesh.shape, policy.mesh.coord
    for k, t in m["Aw"].flatten_params(params).items():
        shape = shapes[k]
        idx = Sh.shard_slices(shape, policy.leaf_spec(
            k, len(shape), policy.flavor == "fsdp_tp"), sizes, coord)
        held = tuple(len(i) if isinstance(i, np.ndarray)
                     else len(range(n)[i]) for n, i in zip(shape, idx))
        if tuple(t.shape) != held:
            raise AssertionError(f"{leg}: rank {coord} holds {k} as "
                                 f"{tuple(t.shape)}, not {held} of {shape}")


def serve_mamba_mesh(m, device, policy, tmp: Path):
    """``serving_mamba_tp2`` on this rank: the ``serving_mamba`` leg's
    model (Falcon-Mamba-7B, full width, SERVE_LAYERS' depth, seed 0),
    engine settings, requests and feature stores under ``policy``,
    checked and timed; held to ``serving_mamba``'s world-1 record
    (``tmp / MAMBA_WORLD1``); then the twin on the plain scan held to
    this engine.  Returns (this rank's record, the arguments of its first
    prefill's first scan call)."""
    M, serve, ops = m["M"], m["serve"], m["ops"]
    leg = "serving_mamba_tp2"
    cfg = serve_config(m, MAMBA_ARCH)
    slots, prompt_cap, gen_cap = SERVE_SLOTS, SERVE_PROMPT, SERVE_GEN
    n_req = SERVE_REQUESTS
    rank = torch.distributed.get_rank()
    w1 = torch.load(tmp / MAMBA_WORLD1)
    params = serve.sharded_params(cfg, device, 0, policy)
    _free(device)
    _sync(device)
    resident = _allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    check_held(m, leg, params, policy, w1["shapes"])

    for op in ops.values():
        op.launches = 0
    stores, tables = serve.feature_stores(m["make_context"](device), 0,
                                          max(slots, 8))
    lookups = count_lookups(stores)
    engine = m["ServingEngine"](
        cfg, params, policy=policy, slots=slots, prompt_capacity=prompt_cap,
        gen_capacity=gen_cap, queue_capacity=SERVE_QUEUE,
        feature_stores=stores, device=device)
    reqs = serve.make_requests(cfg, n_req, prompt_cap, gen_cap, seed=0)
    first_ssm = first_prefill_ssm(engine)
    rec = Recorder(engine)
    scan = []
    with recording(ops["mamba_scan"], "selective_scan", scan, picks={0}):
        done, rejected, seconds = serve.drive(engine, reqs, slots)
    _sync(device)
    launches = {k: op.launches for k, op in ops.items()}
    peak = torch.cuda.max_memory_allocated(device) - resident
    mt = engine.metrics
    check_engine_run(leg, engine, done, rejected, reqs, tables, stores)
    expect_launches(leg, launches, {
        "mamba_scan": cfg.n_layers * mt.count("prefills"),
        "hash_partition": store_chunks(serve, stores) + lookups[0]})
    E = cfg.d_inner // policy.world_m
    rows = m["Sh"].batch_block(policy, slots)
    B = rows.stop - rows.start
    shapes = {k: tuple(v.shape) for k, v in engine.caches.items()}
    want = {"conv": (cfg.n_layers, B, cfg.ssm_conv - 1, E),
            "ssm": (cfg.n_layers, B, E, cfg.ssm_state)}
    if shapes != want:
        raise AssertionError(f"{leg}: caches {shapes}, expected {want}")

    # the first request against world 1: prefill logits and ssm states
    # (the ranks' channel blocks put together in rank order)
    first = next(iter(rec.logits))
    if first != w1["first"]:
        raise AssertionError(f"{leg}: first prefill of request {first}, "
                             f"world 1's of {w1['first']}")
    vs_world1 = float((rec.logits[first] - w1["logits"][first]).abs().max())
    ssm = torch.cat(m["all_gather"](first_ssm[0].to(device),
                                    policy.model_group), dim=2).cpu()
    ssm_vs_world1 = float((ssm - w1["ssm"]).abs().max()) \
        / float(w1["ssm"].abs().max())
    if vs_world1 > SERVE_LOGIT_TOL or ssm_vs_world1 > MAMBA_STATE_TOL:
        raise AssertionError(f"{leg}: first prefill {vs_world1} from world "
                             f"1's logits, ssm states {ssm_vs_world1} of "
                             "their largest")
    by_id = {r.req_id: r for r in done}
    w1_compared = sum(greedy_agree(by_id[rid].out_tokens, w1["tokens"][rid],
                                   w1["margins"][rid], SERVE_LOGIT_TOL)
                      for rid in w1["tokens"])

    # a full-length prefill and a decode step of all slots, timed on both
    # ranks at once (their collectives pair up)
    prefill = M.make_slot_prefill(cfg, policy,
                                  decode_len=prompt_cap + gen_cap)
    full = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, prompt_cap)).astype(np.int32)).to(device)}
    step = M.make_serve_step(cfg, policy)
    toks = torch.zeros((slots, 1), dtype=torch.int32, device=device)
    lens = np.full(slots, prompt_cap - 1, np.int32)
    prefill_ms = event_ms(lambda: prefill(params, full, prompt_cap), reps=3)
    step_ms = event_ms(lambda: step(params, engine.caches, toks, lens),
                       reps=4)
    prof = profile_tp2({
        "prefill": lambda: prefill(params, full, prompt_cap),
        "decode_4_steps": lambda: [step(params, engine.caches, toks, lens)
                                   for _ in range(4)]},
        device, rank, warm=False)

    # the twin: the same engine on the plain scan, held to this engine
    for op in ops.values():
        op.launches = 0
    n_lookups = lookups[0]
    xla = m["ServingEngine"](
        cfg, params, policy=policy, slots=slots, prompt_capacity=prompt_cap,
        gen_capacity=gen_cap, queue_capacity=SERVE_QUEUE,
        feature_stores=stores, mamba_impl="xla", device=device)
    xrec = Recorder(xla)
    xreqs = twin_requests(serve.make_requests(
        cfg, n_req, prompt_cap, gen_cap, seed=0), TP_TWIN_REQUESTS)
    xdone, _, xseconds = serve.drive(xla, xreqs, slots)
    _sync(device)
    xlaunches = {k: op.launches for k, op in ops.items()}
    expect_launches(f"{leg}_xla", xlaunches,
                    {"hash_partition": lookups[0] - n_lookups})
    check_served(xdone, xreqs, tables, len(xreqs))
    worst = max(float((rec.logits[rid] - lg).abs().max())
                for rid, lg in xrec.logits.items())
    if worst > SERVE_LOGIT_TOL:
        raise AssertionError(f"{leg}: the plain twin's prefill logits "
                             f"differ from the engine run's by {worst} "
                             f"> {SERVE_LOGIT_TOL}")
    compared = sum(greedy_agree(r.out_tokens, by_id[r.req_id].out_tokens,
                                xrec.margins[r.req_id], SERVE_LOGIT_TOL)
                   for r in xdone)
    if compared == 0:
        raise AssertionError(f"{leg}: no token of the twin compared")

    tokens = mt.count("tokens_generated")
    record = {
        "phase": leg, "rank": rank, "coord": policy.mesh.coord,
        "mesh": policy.mesh.shape, "arch": cfg.name,
        "layers": cfg.n_layers, "channels": E, "requests": n_req,
        "device": str(device), "backend": torch.distributed.get_backend(),
        "completed": mt.count("completed"), "prefills": mt.count("prefills"),
        "decode_steps": mt.count("decode_steps"), "tokens": tokens,
        "seconds": seconds, "tokens_per_s": tokens / seconds,
        "ttft_p50_ms": mt.percentile("ttft", 50) * 1e3,
        "ttft_p99_ms": mt.percentile("ttft", 99) * 1e3,
        "prefill_ms": prefill_ms, "decode_step_ms": step_ms,
        "weight_bytes": weight_bytes, "resident_bytes": resident,
        "peak_bytes_above_resident": peak, "cache_shapes": shapes,
        "launches": launches, "xla_launches": xlaunches,
        "logit_diff_vs_world1": vs_world1,
        "ssm_diff_over_max_vs_world1": ssm_vs_world1,
        "world1_tokens_compared": w1_compared,
        "logit_tol": SERVE_LOGIT_TOL, "state_tol": MAMBA_STATE_TOL,
        "twin_requests": len(xreqs), "twin_seconds": xseconds,
        "twin_prefill_logit_diff_max": worst,
        "twin_tokens_compared": compared,
        "twin_tokens_equal": sum(
            r.out_tokens == by_id[r.req_id].out_tokens[:len(r.out_tokens)]
            for r in xdone),
        "profile": prof,
        "out_tokens": {r.req_id: r.out_tokens for r in done}}
    case = tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                 for a in scan[0])
    del engine, xla, params, prefill, step
    return record, case


def mamba_train_mesh(m, device, policy, tmp: Path) -> dict:
    """``mamba_train_tp2`` on this rank: ``mamba_train``'s config
    (Falcon-Mamba-7B at full width, MAMBA_TRAIN_LAYERS layers, one
    microbatch) and seed-0 masters, this rank's slices of them under
    ``policy`` (ZeRO-1 moments, AdamW in place), MAMBA_TP_TRAIN_STEPS
    steps on its first batch; the first step's loss and grad norm
    within LM_LOSS_RTOL and LM_GNORM_RTOL of ``mamba_train``'s (``tmp /
    MAMBA_TRAIN_WORLD1``).  Returns this rank's record."""
    M, A, Sh = m["M"], m["Aw"], m["Sh"]
    leg = "mamba_train_tp2"
    w1 = json.loads((tmp / MAMBA_TRAIN_WORLD1).read_text())
    full = m["get_config"](MAMBA_ARCH)
    cfg = dataclasses.replace(
        full, n_layers=MAMBA_TRAIN_LAYERS,
        train=dataclasses.replace(full.train, microbatches=1))
    params = Sh.shard_params(M.init_params(
        torch.Generator(device).manual_seed(0), cfg, master=True), policy,
        cfg=cfg)
    _free(device)
    flat = A.flatten_params(params)
    opt_cfg = A.AdamWConfig(lr=3e-4, total_steps=MAMBA_TRAIN_STEPS)
    zero = Sh.Zero1(policy, flat)
    opt = A.init({k: zero.local(k, p) for k, p in flat.items()}, opt_cfg)
    step = M.make_train_step(cfg, policy, opt_cfg, donate=True)
    batch = lm_batch(m, cfg, 0, MAMBA_TRAIN_BATCH, MAMBA_TRAIN_SEQ, device)
    _sync(device)
    _reset_peak(device)
    resident = _allocated(device)
    norms = []
    (params, opt, losses, ms), launches = counted_run(
        m, lambda: timed_steps(step, params, opt,
                               [batch] * MAMBA_TP_TRAIN_STEPS, norms=norms),
        device)
    expect_launches(leg, launches, {})
    peak = _peak(device) - resident
    errs = {"loss": rel_err(losses[0], w1["loss"]),
            "grad_norm": rel_err(norms[0], w1["grad_norm"])}
    if errs["loss"] > LM_LOSS_RTOL or errs["grad_norm"] > LM_GNORM_RTOL:
        raise AssertionError(f"{leg}: first step {losses[0]} / {norms[0]} "
                             f"against world 1's {w1}: {errs}")
    record = {"phase": leg, "rank": torch.distributed.get_rank(),
              "coord": policy.mesh.coord, "mesh": policy.mesh.shape,
              "flavor": policy.flavor, "arch": cfg.name,
              "layers": cfg.n_layers, "batch": MAMBA_TRAIN_BATCH,
              "seq": MAMBA_TRAIN_SEQ, "steps": MAMBA_TP_TRAIN_STEPS,
              "step_ms": ms, "losses": losses, "grad_norms": norms,
              "world1": w1, "rel_err": errs, "loss_tol": LM_LOSS_RTOL,
              "grad_norm_tol": LM_GNORM_RTOL, "launches": launches,
              "master_bytes": sum(t.numel() * t.element_size()
                                  for t in A.flatten_params(params).values()),
              "resident_bytes": resident, "peak_bytes_above_resident": peak}
    del params, opt, batch, step
    return record


def mamba_tp2_results(m, device, tmpdir: Path):
    """The Mamba legs' records of both ranks (``MAMBA_TP_LEGS``): the
    ranks' tokens and losses equal; emitted as phases.  Returns (legs,
    {"mamba_scan": [case (j)]})."""
    recs = {leg: [json.loads((tmpdir / f"{leg}_rank{r}.json").read_text())
                  for r in range(2)] for leg in MAMBA_TP_LEGS}
    serving, train = recs["serving_mamba_tp2"], recs["mamba_train_tp2"]
    if any(r["out_tokens"] != serving[0]["out_tokens"] for r in serving):
        raise AssertionError("serving_mamba_tp2: the ranks' tokens differ")
    if any(r["losses"] != train[0]["losses"] for r in train):
        raise AssertionError("mamba_train_tp2: the ranks' losses differ")
    for r in serving:
        r.pop("out_tokens")
    for leg, ranks in recs.items():
        emit({"phase": leg, "leg_s": max(r["leg_s"] for r in ranks),
              "ranks": ranks})

    def summed(key, ranks):
        return {k: sum(r[key][k] for r in ranks) for k in ranks[0][key]}

    legs = {"serving_mamba_tp2": dict(rows=serving[0]["requests"],
                                      launches=summed("launches", serving)),
            "serving_mamba_tp2_xla": dict(
                rows=serving[0]["twin_requests"],
                launches=summed("xla_launches", serving)),
            "mamba_train_tp2": dict(rows=MAMBA_TP_TRAIN_STEPS
                                    * MAMBA_TRAIN_BATCH,
                                    launches=summed("launches", train))}
    args = tuple(a.to(device) if isinstance(a, torch.Tensor) else a
                 for a in torch.load(tmpdir / "serving_mamba_tp2_cases.pt"))
    x, A = args[0], args[2]
    case = dict(shape=f"(j) serving_mamba_tp2 prefill x {tuple(x.shape)} "
                      f"N {A.shape[1]} with hT", args=args)
    return legs, {"mamba_scan": [case]}


def run_mamba_tp2(m, device, tmpdir: Path):
    """The Mamba legs at world 2 alone (``tools/chip_phases.py``): two
    rank processes for ``MAMBA_TP_LEGS``; the world-1 records must be in
    ``tmpdir``.  Returns (legs, kernel cases)."""
    m["serve"].spawn(2, mesh_rank, (str(tmpdir), MAMBA_TP_LEGS),
                     timeout_s=900)
    return mamba_tp2_results(m, device, tmpdir)


def serve_oneshot_mesh(m, device, policy, leg, tmp: Path):
    """A one-shot leg of ``ONESHOT_TP`` on this rank: its world-1 leg's
    model at full width and depth (seed 0, this rank's slices under
    ``policy``) on that leg's first batch through ``make_prefill`` +
    ``make_serve_step``, ONESHOT_TP_GEN greedy tokens, counted
    (flash_attention exactly :func:`flash_per_prefill`) and timed; each
    rank's caches its rows and KV heads; held to the world-1 record
    (``tmp/<leg>_world1.pt``): the prefill logits within SERVE_LOGIT_TOL,
    row 0's caches gathered over the model group within CACHE_TOL, the
    greedy tokens by :func:`greedy_agree`; then the same prefill on plain
    attention, its logits within SERVE_LOGIT_TOL of the kernel run's.
    Returns (this rank's record, the q, k, v and causal flag of the
    prefill's first flash call (vision) or first cross-attention call
    (enc-dec))."""
    M, serve, ops, Sh = m["M"], m["serve"], m["ops"], m["Sh"]
    arch, w1_leg = ONESHOT_TP[leg]
    cfg = m["get_config"](arch)
    rank = torch.distributed.get_rank()
    t0 = time.perf_counter()
    w1 = torch.load(tmp / f"{w1_leg}_world1.pt")
    params = serve.sharded_params(cfg, device, 0, policy)
    _free(device)
    _sync(device)
    check_held(m, leg, params, policy, w1["shapes"])
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    batch = oneshot_batches(cfg, 1, ONESHOT_ROWS, ONESHOT_PROMPT, device)[0]
    gen, P = ONESHOT_TP_GEN, prefix_len(cfg)
    decode_len = P + ONESHOT_PROMPT + gen
    prefill = M.make_prefill(cfg, policy, decode_len=decode_len)
    step = M.make_serve_step(cfg, policy)
    pick = cfg.encoder_layers + 1 if cfg.is_encdec else 0
    _sync(device)
    resident = _allocated(device)
    _reset_peak(device)
    recorded = []

    def drive():
        t0 = time.perf_counter()
        with recording(ops["flash_attention"], "flash_attention", recorded,
                       picks={pick}):
            run = greedy_run(cfg, params, batch, prefill, step, gen)
        _sync(device)
        return run, time.perf_counter() - t0

    spent = {"init_s": time.perf_counter() - t0}
    (run, seconds), launches = counted_run(m, drive, device)
    spent["drive_s"] = seconds
    t0 = time.perf_counter()
    peak = _peak(device) - resident
    expect_launches(leg, launches,
                    {"flash_attention": flash_per_prefill(cfg)})
    rows = Sh.batch_block(policy, ONESHOT_ROWS)
    kv = (cfg.n_layers, rows.stop - rows.start,
          Sh.local_kv_heads(cfg, policy))
    want = {"k": kv + (decode_len, cfg.d_head),
            "v": kv + (decode_len, cfg.d_head)}
    if cfg.is_encdec:
        frames = ONESHOT_PROMPT // cfg.enc_len_ratio
        want.update(ck=kv + (frames, cfg.d_head), cv=kv + (frames, cfg.d_head))
    shapes = {k: tuple(v.shape) for k, v in run["caches"].items()}
    if shapes != want:
        raise AssertionError(f"{leg}: caches {shapes}, expected {want}")

    # against world 1: the prefill logits, row 0's caches gathered over
    # the model ranks' heads (each layer's its largest from world 1's, and
    # the tolerance: CACHE_TOL, or twice how far plain attention moved
    # them at world 1), the greedy tokens; every check made before any
    # fails
    vs_world1 = float((run["prefill_logits"]
                       - w1["prefill_logits"]).abs().max())
    cache_err, cache_tol, failed = {}, {}, []
    for c, mine in record_caches(cfg, run["caches"],
                                 P + ONESHOT_PROMPT).items():
        whole = torch.cat(m["all_gather"](mine.to(device).contiguous(),
                                          policy.model_group), dim=1).cpu()
        ref = w1["caches"][c]
        top = ref.abs().amax(dim=(1, 2, 3))
        cache_err[c] = ((whole - ref).abs().amax(dim=(1, 2, 3))
                        / top).tolist()
        cache_tol[c] = (2 * (w1["xla_caches"][c] - ref).abs().amax(
            dim=(1, 2, 3)) / top).clamp(min=CACHE_TOL).tolist()
        if any(e > t for e, t in zip(cache_err[c], cache_tol[c])):
            failed.append(f"row 0's {c} (first, last layer) {cache_err[c]} "
                          f"of their largest from world 1's, tolerance "
                          f"{cache_tol[c]}")
    if vs_world1 > SERVE_LOGIT_TOL:
        failed.append(f"prefill logits {vs_world1} from world 1's > "
                      f"{SERVE_LOGIT_TOL}")
    try:
        w1_compared = sum(greedy_agree(
            run["tokens"][i], w1["tokens"][i, :gen].numpy(),
            w1["margins"][i, :gen].numpy(), SERVE_LOGIT_TOL)
            for i in range(ONESHOT_ROWS))
    except AssertionError as e:
        failed.append(f"greedy tokens: {e}")
        w1_compared = None
    if failed:
        raise AssertionError(f"{leg}: " + "; ".join(failed) + f" (world 1's "
                             f"plain-attention twin: logits "
                             f"{w1['xla_logit_diff']})")

    # the twin: the same prefill on plain attention
    xprefill = M.make_prefill(cfg, policy, decode_len=decode_len,
                              attn_impl="xla")
    xlogits, xlaunches = counted_run(
        m, lambda: xprefill(params, batch)[0].float().cpu(), device)
    expect_launches(f"{leg}_xla", xlaunches, {})
    twin = float((xlogits - run["prefill_logits"]).abs().max())
    if twin > SERVE_LOGIT_TOL:
        raise AssertionError(f"{leg}: the plain twin's prefill logits differ "
                             f"from the kernel run's by {twin} > "
                             f"{SERVE_LOGIT_TOL}")
    del xlogits, xprefill

    # a prefill and a decode step by events (the greedy run warmed both),
    # then one each profiled, on both ranks at once (their collectives
    # pair up)
    spent["checks_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    caches = run.pop("caches")
    toks = torch.zeros((ONESHOT_ROWS, 1), dtype=torch.int32, device=device)
    last = decode_len - 1
    prefill_ms = event_ms(lambda: prefill(params, batch), reps=1, warm=False)
    step_ms = event_ms(lambda: step(params, caches, toks, last), reps=3,
                       warm=False)
    spent["event_timing_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    prof = profile_tp2({
        "prefill": lambda: prefill(params, batch),
        "decode_4_steps": lambda: [step(params, caches, toks, last)
                                   for _ in range(4)]},
        device, rank, warm=False)
    spent["profile_s"] = time.perf_counter() - t0
    tokens = ONESHOT_ROWS * gen
    record = {
        "phase": leg, "rank": rank, "coord": policy.mesh.coord,
        "mesh": policy.mesh.shape, "arch": cfg.name,
        "layers": cfg.n_layers, "encoder_layers": cfg.encoder_layers,
        "rows": ONESHOT_ROWS, "prompt": ONESHOT_PROMPT, "prefix": P,
        "gen": gen, "device": str(device),
        "backend": torch.distributed.get_backend(), "seconds": seconds,
        "tokens": tokens, "tokens_per_s": tokens / seconds,
        "prefill_ms": prefill_ms, "decode_step_ms": step_ms,
        "weight_bytes": weight_bytes, "resident_bytes": resident,
        "peak_bytes_above_resident": peak, "cache_shapes": shapes,
        "launches": launches, "xla_launches": xlaunches,
        "flash_per_prefill": flash_per_prefill(cfg),
        "logit_diff_vs_world1": vs_world1,
        "cache_diff_over_max_vs_world1": cache_err,
        "cache_tol_first_last_layer": cache_tol,
        "world1_xla_logit_diff": w1["xla_logit_diff"],
        "world1_tokens_compared": w1_compared,
        "logit_tol": SERVE_LOGIT_TOL, "cache_tol": CACHE_TOL,
        "twin_prefill_logit_diff_max": twin, "profile": prof,
        "spent": spent, "out_tokens": run["tokens"].tolist()}
    case = tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                 for a in recorded[0])
    del params, caches, prefill, step, run, batch
    return record, case


def seamless_train_mesh(m, device, policy, tmp: Path) -> dict:
    """``seamless_train_tp2`` on this rank: ``seamless_train``'s config
    (SeamlessM4T-Large-v2 at full width and depth) and seed-0 masters,
    this rank's slices of them under ``policy`` (ZeRO-1 moments, AdamW
    in place), SEAMLESS_TP_TRAIN_STEPS steps on its batch; the first
    step's loss and grad norm within LM_LOSS_RTOL and LM_GNORM_RTOL (the
    CPU tests' LOSS_RTOL and GNORM_RTOL for a mesh step against world 1)
    of ``seamless_train``'s (``tmp / SEAMLESS_TRAIN_WORLD1``).  Returns
    this rank's record."""
    M, A, Sh = m["M"], m["Aw"], m["Sh"]
    leg = "seamless_train_tp2"
    w1 = json.loads((tmp / SEAMLESS_TRAIN_WORLD1).read_text())
    cfg = m["get_config"](SEAMLESS_ARCH)
    params = Sh.shard_params(M.init_params(
        torch.Generator(device).manual_seed(0), cfg, master=True), policy,
        cfg=cfg)
    _free(device)
    flat = A.flatten_params(params)
    opt_cfg = frontend_opt(m)
    zero = Sh.Zero1(policy, flat)
    opt = A.init({k: zero.local(k, p) for k, p in flat.items()}, opt_cfg)
    step = M.make_train_step(cfg, policy, opt_cfg, donate=True)
    batch = Sh.shard_batch(frontend_train_batch(m, cfg, device), policy)
    _sync(device)
    _reset_peak(device)
    resident = _allocated(device)
    norms = []
    (params, opt, losses, ms), launches = counted_run(
        m, lambda: timed_steps(step, params, opt,
                               [batch] * SEAMLESS_TP_TRAIN_STEPS,
                               norms=norms), device)
    expect_launches(leg, launches, {})
    peak = _peak(device) - resident
    errs = {"loss": rel_err(losses[0], w1["loss"]),
            "grad_norm": rel_err(norms[0], w1["grad_norm"])}
    if errs["loss"] > LM_LOSS_RTOL or errs["grad_norm"] > LM_GNORM_RTOL:
        raise AssertionError(f"{leg}: first step {losses[0]} / {norms[0]} "
                             f"against world 1's {w1}: {errs}")
    rows = next(iter(batch.values())).shape[0]
    record = {"phase": leg, "rank": torch.distributed.get_rank(),
              "coord": policy.mesh.coord, "mesh": policy.mesh.shape,
              "flavor": policy.flavor, "arch": cfg.name,
              "layers": cfg.n_layers, "encoder_layers": cfg.encoder_layers,
              "batch": rows, "seq": FRONTEND_TRAIN_SEQ,
              "steps": SEAMLESS_TP_TRAIN_STEPS, "step_ms": ms,
              "tokens_per_s": rows * FRONTEND_TRAIN_SEQ / ms[-1] * 1e3,
              "losses": losses, "grad_norms": norms, "world1": w1,
              "rel_err": errs, "loss_tol": LM_LOSS_RTOL,
              "grad_norm_tol": LM_GNORM_RTOL, "launches": launches,
              "master_bytes": sum(t.numel() * t.element_size()
                                  for t in A.flatten_params(params).values()),
              "resident_bytes": resident, "peak_bytes_above_resident": peak}
    del params, opt, batch, step
    return record


def encdec_tp2_results(m, device, tmpdir: Path):
    """The enc-dec and vision legs' records of both ranks
    (``ENCDEC_TP_LEGS``): the ranks' tokens and losses equal; emitted as
    phases.  Returns (legs, {"flash_attention": [cases (n), (o)]})."""
    recs = {leg: [json.loads((tmpdir / f"{leg}_rank{r}.json").read_text())
                  for r in range(2)] for leg in ENCDEC_TP_LEGS}
    for leg in ONESHOT_TP:
        if any(r["out_tokens"] != recs[leg][0]["out_tokens"]
               for r in recs[leg]):
            raise AssertionError(f"{leg}: the ranks' tokens differ")
        for r in recs[leg]:
            r.pop("out_tokens")
    train = recs["seamless_train_tp2"]
    if any(r["losses"] != train[0]["losses"] for r in train):
        raise AssertionError("seamless_train_tp2: the ranks' losses differ")
    for leg, ranks in recs.items():
        emit({"phase": leg, "leg_s": max(r["leg_s"] for r in ranks),
              "ranks": ranks})

    def summed(key, ranks):
        return {k: sum(r[key][k] for r in ranks) for k in ranks[0][key]}

    legs = {"seamless_train_tp2": dict(
        rows=SEAMLESS_TP_TRAIN_STEPS * FRONTEND_TRAIN_BATCH,
        launches=summed("launches", train))}
    for leg in ONESHOT_TP:
        legs[leg] = dict(rows=ONESHOT_ROWS,
                         launches=summed("launches", recs[leg]))
        legs[f"{leg}_xla"] = dict(rows=ONESHOT_ROWS,
                                  launches=summed("xla_launches", recs[leg]))
    cases = []
    for label, leg in (("(n) serving_internvl_tp2", "serving_internvl_tp2"),
                       ("(o) serving_seamless_tp2 cross",
                        "serving_seamless_tp2")):
        cases.append(recorded_flash_case(label, tuple(
            a.to(device) if isinstance(a, torch.Tensor) else a
            for a in torch.load(tmpdir / f"{leg}_cases.pt"))))
    return legs, {"flash_attention": cases}


def run_encdec_tp2(m, device, tmpdir: Path):
    """The enc-dec and vision legs at world 2 alone
    (``tools/chip_phases.py``): two rank processes for
    ``ENCDEC_TP_LEGS``; the world-1 records must be in ``tmpdir``.
    Returns (legs, kernel cases)."""
    m["serve"].spawn(2, mesh_rank, (str(tmpdir), ENCDEC_TP_LEGS),
                     timeout_s=900)
    return encdec_tp2_results(m, device, tmpdir)


def with_sdpa(case):
    """Where Sq == Skv or without the mask the case's library call is
    ``scaled_dot_product_attention`` (its causal mask is top-left, so
    only there), with ``enable_gqa``."""
    q, k, v, causal = case["args"]
    if q.shape[2] == k.shape[2] or not causal:
        case["library"] = lambda q=q, k=k, v=v, c=causal: \
            torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=c, enable_gqa=True)
    return case


def recorded_flash_case(label, recorded):
    """A flash_attention case of the q, k, v and causal flag one prefill
    layer gave the kernel."""
    q, k, v, causal = recorded
    return with_sdpa(dict(shape=f"{label} prefill q {tuple(q.shape)} kv "
                                f"{tuple(k.shape)} "
                                f"{'causal' if causal else 'full'}",
                          args=(q, k, v, causal)))


def flash_cases(recorded, device, seed=3):
    """flash_attention's cases: (a) the q, k, v one layer of the serving
    leg's first prefill gave it; (b) (1, 32, 1024, 1024, 64) causal; (c)
    right-aligned Sq 256 < Skv 1024; (d) not causal; (e) ragged Sq = Skv
    = 1000; (f) D = 128 with Hq = Hkv; (g) B = 4; case (h), the MoE
    serving leg's (Hq 24, Hkv 8), and (i)-(k), the enc-dec leg's encoder
    and cross-attention and the vision leg's GQA at D 128, are added
    after their legs (:func:`recorded_flash_case`).  Library calls as
    :func:`with_sdpa`."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def qkv(B, Hq, Hkv, Sq, Skv, D):
        return tuple(torch.randn(s, generator=gen, device=device)
                     .to(torch.bfloat16)
                     for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D),
                               (B, Hkv, Skv, D)))

    cases = [recorded_flash_case("(a) serving", recorded)]
    for label, shape, causal in (
            ("(b)", (1, 32, 8, 1024, 1024, 64), True),
            ("(c)", (1, 32, 8, 256, 1024, 64), True),
            ("(d)", (1, 32, 8, 1024, 1024, 64), False),
            ("(e)", (1, 32, 8, 1000, 1000, 64), True),
            ("(f)", (1, 16, 16, 1024, 1024, 128), True),
            ("(g)", (4, 32, 8, 1024, 1024, 64), True)):
        B, Hq, Hkv, Sq, Skv, D = shape
        cases.append(with_sdpa(dict(
            shape=f"{label} B {B} Hq {Hq} Hkv {Hkv} Sq {Sq} Skv {Skv} "
                  f"D {D} {'causal' if causal else 'full'}",
            args=(*qkv(*shape), causal))))
    return cases


def _flash_close(case, got, want) -> float:
    """Finite, and within FLASH_TOL (absolute and relative) of the plain
    version in float32; returns the largest absolute difference."""
    got, want = got[0], want[0]
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"flash_attention {case['shape']}: "
                             f"{got.dtype} {tuple(got.shape)}")
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    if not bool(torch.isfinite(g).all()) \
            or bool((diff > FLASH_TOL * (1 + w.abs())).any()):
        raise AssertionError(f"flash_attention {case['shape']}: differs "
                             f"from attention_ref by {float(diff.max())}")
    return float(diff.max())


# --------------------------------------------------------------------------
# the enc-dec and vision stacks: SeamlessM4T-Large-v2 and InternVL2-2B
# --------------------------------------------------------------------------


def frontend_inputs(cfg, rows, seq, rng) -> dict:
    """The float inputs a config's stub frontend takes, drawn by numpy
    (as the reference's smoke test draws them): an enc-dec config's
    frames, ``seq // enc_len_ratio`` a row, and a vision config's
    ``frontend_tokens`` patch embeddings a row."""
    out = {}
    if cfg.is_encdec:
        out["frames"] = rng.normal(size=(rows, seq // cfg.enc_len_ratio,
                                         cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision":
        out["patch_embeds"] = rng.normal(
            size=(rows, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


def prefix_len(cfg) -> int:
    """The positions a vision config puts in front of the tokens."""
    return cfg.frontend_tokens if cfg.frontend == "vision" else 0


def flash_per_prefill(cfg) -> int:
    """flash_attention calls of one prefill: the decoder's self-attention,
    and an enc-dec config's encoder and cross-attention."""
    return cfg.n_layers + (cfg.encoder_layers + cfg.n_layers
                           if cfg.is_encdec else 0)


def greedy_run(cfg, params, batch, prefill, step, gen):
    """The one-shot loop: ``prefill`` on ``batch``, then ``gen`` - 1
    greedy decode steps from position P + S (a vision config's decode
    counts its patch positions).  Returns the tokens and top-2 margins
    (rows, gen) and the prefill logits (rows, V) on the host, row 0's
    logits at every position (gen, V) on the host and the caches."""
    logits, caches = prefill(params, batch)
    first = logits.float().cpu()
    pos0 = prefix_len(cfg) + batch["tokens"].shape[1]
    toks, margins, row0 = [], [], []
    for i in range(gen):
        top = torch.topk(logits, 2, dim=-1).values
        margins.append(top[:, 0] - top[:, 1])
        toks.append(torch.argmax(logits, dim=-1))
        row0.append(logits[0].float().clone())
        if i < gen - 1:
            logits, caches = step(params, caches, toks[-1][:, None].to(
                torch.int32), pos0 + i)
    return dict(tokens=torch.stack(toks, 1).cpu().numpy(),
                margins=torch.stack(margins, 1).float().cpu().numpy(),
                prefill_logits=first, row0=torch.stack(row0).cpu(),
                caches=caches)


def teacher_forced(M, cfg, params, batch, run, gen) -> float:
    """Row 0's decode-step logits against the full forward over its
    prompt and the tokens it generated, at the same positions (a slot
    prefill of the whole sequence, cut at each position): the largest
    difference."""
    seq = torch.cat([batch["tokens"][:1], torch.from_numpy(
        run["tokens"][:1, :gen - 1].astype(np.int32)).to(
        batch["tokens"].device)], dim=1)
    one = {k: v[:1] for k, v in batch.items()}
    one["tokens"] = seq
    n = batch["tokens"].shape[1]
    prefill = M.make_slot_prefill(cfg, decode_len=prefix_len(cfg) + n + gen)
    worst = 0.0
    for j in range(gen):
        logits, _ = prefill(params, one, n + j)
        worst = max(worst, float((logits[0].float().cpu()
                                  - run["row0"][j]).abs().max()))
    return worst


def oneshot_batches(cfg, batches, rows, prompt, device) -> list:
    """The one-shot legs' batches: ``rows`` x ``prompt`` tokens each with
    the config's frames or patch embeddings, drawn in turn from
    ``default_rng(0)`` (the first batch is the same for any count)."""
    rng = np.random.default_rng(0)
    return [{k: torch.from_numpy(v).to(device) for k, v in dict(
        tokens=rng.integers(0, cfg.vocab, (rows, prompt)).astype(np.int32),
        **frontend_inputs(cfg, rows, prompt, rng)).items()}
        for _ in range(batches)]


def record_caches(cfg, caches, n) -> dict:
    """Row 0's caches of the first and the last layer, float32 on the
    host: an enc-dec config's ``ck``/``cv`` (the encoder memory), else
    ``k``/``v`` at the ``n`` prefilled positions."""
    if cfg.is_encdec:
        return {c: caches[c][[0, -1], 0].float().cpu() for c in ("ck", "cv")}
    return {c: caches[c][[0, -1], 0, :, :n].float().cpu() for c in ("k", "v")}


def run_serving_oneshot(m, device, cfg, *, leg, batches=ONESHOT_BATCHES,
                        rows=ONESHOT_ROWS, prompt=ONESHOT_PROMPT,
                        gen=ONESHOT_GEN, attn_impl=None, picks=(0,),
                        record=None):
    """Serve ``batches`` one-shot batches of ``rows`` requests (``prompt``
    tokens each, with the config's frames or patch embeddings from
    ``default_rng(0)``) through ``make_prefill`` + ``make_serve_step``,
    ``gen`` greedy tokens each, counted (flash_attention exactly
    :func:`flash_per_prefill` a prefill) and timed; then the first batch
    on the plain ``xla`` attention path (prefill logits within
    SERVE_LOGIT_TOL, greedy tokens as :func:`greedy_agree` compares
    them), row 0 of the first batch teacher-forced (its decode-step
    logits against the full forward, within SERVE_LOGIT_TOL), prefill
    and decode-step ms by CUDA events, and a profile of the prefill (an
    enc-dec config's by block) and of 4 decode steps.  ``attn_impl`` is
    the first path (``None``: what the device implies).  With ``record``
    (a path), the first batch's prefill logits, greedy tokens and
    margins, row 0's caches (:func:`record_caches`) and every leaf's
    whole shape are saved there, for the legs at world 2.  Returns (legs,
    the q, k, v and causal flag of the first prefill's flash calls whose
    index is in ``picks``)."""
    M, ops = m["M"], m["ops"]
    wall = time.perf_counter()
    params = M.init_params(torch.Generator(device=device).manual_seed(0),
                           cfg)
    _sync(device)
    spent = {"init_s": time.perf_counter() - wall}
    data = oneshot_batches(cfg, batches, rows, prompt, device)
    P = prefix_len(cfg)
    decode_len = P + prompt + gen
    prefill = M.make_prefill(cfg, decode_len=decode_len, attn_impl=attn_impl)
    step = M.make_serve_step(cfg)
    _sync(device)
    resident = _allocated(device)
    _reset_peak(device)
    recorded, first_caches = [], {}

    def drive():
        out = []
        t0 = time.perf_counter()
        for i, b in enumerate(data):
            with recording(ops["flash_attention"], "flash_attention",
                           recorded, picks=set(picks)) if i == 0 \
                    else contextlib.nullcontext():
                out.append(greedy_run(cfg, params, b, prefill, step, gen))
            if i == 0 and record is not None:
                first_caches.update(record_caches(cfg, out[0]["caches"],
                                                  P + prompt))
            if i < len(data) - 1:       # the last batch's are timed below
                del out[-1]["caches"]
        _sync(device)
        return out, time.perf_counter() - t0

    (runs, seconds), launches = counted_run(m, drive, device)
    spent["drive_s"] = seconds
    peak = _peak(device) - resident
    expect_launches(leg, launches, {
        "flash_attention": flash_per_prefill(cfg) * batches})
    for r in runs:
        if r["tokens"].shape != (rows, gen) or not bool(
                torch.isfinite(r["prefill_logits"]).all()):
            raise AssertionError(f"{leg}: tokens {r['tokens'].shape}, "
                                 "or logits not finite")

    # the first batch on the plain attention path
    t0 = time.perf_counter()
    xrun, xlaunches = counted_run(m, lambda: greedy_run(
        cfg, params, data[0], M.make_prefill(
            cfg, decode_len=decode_len, attn_impl="xla"), step, gen),
        device)
    expect_launches(f"{leg}_xla", xlaunches, {})
    diff = (runs[0]["prefill_logits"] - xrun["prefill_logits"]).abs() \
        .amax(dim=-1)
    worst = float(diff.max())
    if worst > SERVE_LOGIT_TOL:
        raise AssertionError(f"{leg}: flash and xla prefill logits differ "
                             f"by {worst} > {SERVE_LOGIT_TOL}")
    compared = sum(greedy_agree(runs[0]["tokens"][i], xrun["tokens"][i],
                                xrun["margins"][i], SERVE_LOGIT_TOL)
                   for i in range(rows))
    if compared == 0:
        raise AssertionError(f"{leg}: no token compared with the xla run")
    if record is not None:
        # with how far plain attention's other roundings move the
        # logits and the caches at world 1
        torch.save({"prefill_logits": runs[0]["prefill_logits"],
                    "tokens": torch.from_numpy(runs[0]["tokens"]),
                    "margins": torch.from_numpy(runs[0]["margins"]),
                    "caches": first_caches, "xla_logit_diff": worst,
                    "xla_caches": record_caches(cfg, xrun["caches"],
                                                P + prompt),
                    "shapes": {k: tuple(v.shape) for k, v in
                               m["Aw"].flatten_params(params).items()}},
                   record)
    del xrun
    spent["xla_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    forced = teacher_forced(M, cfg, params, data[0], runs[0], gen)
    spent["teacher_forcing_s"] = time.perf_counter() - t0
    if forced > SERVE_LOGIT_TOL:
        raise AssertionError(f"{leg}: decode and the full forward differ "
                             f"by {forced} > {SERVE_LOGIT_TOL}")

    caches = runs[-1].pop("caches")
    toks = torch.zeros((rows, 1), dtype=torch.int32, device=device)
    last = decode_len - 1
    t0 = time.perf_counter()
    prefill_ms = event_ms(lambda: prefill(params, data[0]), reps=3)
    step_ms = event_ms(lambda: step(params, caches, toks, last), reps=10)

    def decode4():
        for _ in range(4):
            step(params, caches, toks, last)

    spent["event_timing_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # an enc-dec prefill by block (the flash kernel's time is read from
    # its own name: the encoder and cross-attention labels hold their
    # other kernels), the rest by operation
    flash = ("flash_attention", "flash_attention_kernel")
    blocks = [(M, "_encode"), (m["Tf"], "_cross_block")] if cfg.is_encdec \
        else [(m["Ly"], "dense")]
    prof = profile_serving(m, {"prefill": lambda: prefill(params, data[0])},
                           device, blocks + [(m["Ly"], "logits_out"),
                                             (ops["flash_attention"],
                                              "flash_attention")], [flash])
    # 4 decode steps: the profiler's host-side parsing of a step's ~1500
    # launches takes seconds
    prof.update(profile_serving(
        m, {"decode_4_steps": decode4}, device,
        [(m["Ly"], "dense"), (m["A"], "decode_attention"),
         (m["Ly"], "logits_out")], []))
    spent["profile_s"] = time.perf_counter() - t0
    tokens = batches * rows * gen
    emit({"phase": leg, "arch": cfg.name, "layers": cfg.n_layers,
          "encoder_layers": cfg.encoder_layers, "d_model": cfg.d_model,
          "batches": batches, "rows": rows, "prompt": prompt,
          "prefix": P, "frames": prompt // cfg.enc_len_ratio
          if cfg.is_encdec else 0, "gen": gen, "decode_len": decode_len,
          "seconds": seconds, "tokens": tokens,
          "tokens_per_s": tokens / seconds, "prefill_ms": prefill_ms,
          "decode_step_ms": step_ms, "launches": launches,
          "xla_launches": xlaunches,
          "flash_per_prefill": flash_per_prefill(cfg),
          "peak_bytes_above_resident": peak, "resident_bytes": resident,
          "weight_bytes": sum(t.numel() * t.element_size()
                              for t in _leaves(params)),
          "cache_bytes": sum(t.numel() * t.element_size()
                             for t in caches.values()),
          "logit_tol": SERVE_LOGIT_TOL, "prefill_logit_diff_max": worst,
          "prefill_logit_diff_median": float(diff.median()),
          "tokens_compared_with_xla": compared,
          "teacher_forcing_logit_diff": forced,
          "profile": prof, "spent": spent,
          "wall_s": time.perf_counter() - wall})
    legs = {leg: dict(launches=launches, rows=batches * rows),
            f"{leg}_xla": dict(launches=xlaunches, rows=rows)}
    del params, data, runs, caches, prefill, step
    _free(device)
    return legs, recorded


# both trained from float32 masters, 3 steps of AdamW on one batch of 2 x
# 1024 tokens with its frames or patch embeddings, repeated
FRONTEND_TRAIN_STEPS, FRONTEND_TRAIN_BATCH, FRONTEND_TRAIN_SEQ = 3, 2, 1024


def frontend_train_batch(m, cfg, device) -> dict:
    """FRONTEND_TRAIN_BATCH x FRONTEND_TRAIN_SEQ tokens of
    ``lm_batch_at(0)`` with the config's frames or patch embeddings
    (``default_rng(0)``), on ``device``."""
    batch = lm_batch(m, cfg, 0, FRONTEND_TRAIN_BATCH, FRONTEND_TRAIN_SEQ,
                     device)
    batch.update({k: torch.from_numpy(v).to(device) for k, v in
                  frontend_inputs(cfg, FRONTEND_TRAIN_BATCH,
                                  FRONTEND_TRAIN_SEQ,
                                  np.random.default_rng(0)).items()})
    return batch


def frontend_opt(m):
    # the other LM phases' schedule (100 warm-up steps): at warmup_steps=1
    # SeamlessM4T's loss rose on the third step on an H100 80GB HBM3 at
    # 700 W (12.695, 12.303, 13.307)
    return m["Aw"].AdamWConfig(lr=3e-4, total_steps=FRONTEND_TRAIN_STEPS)


def run_frontend_train(m, device, name, arch, leg, record=None):
    """``arch`` at full width and depth from float32 masters (seed 0),
    remat as its config says: FRONTEND_TRAIN_STEPS steps on one batch of
    :func:`frontend_train_batch`, repeated; the loss must fall.  Step ms
    by CUDA events, tokens/s, peak memory above the resident masters and
    moments, one profiled step.  Attention runs the plain path (the
    kernel is forward only).  With ``record`` (a path) the first step's
    loss and grad norm are written there as JSON, for the leg at world
    2."""
    wall = time.perf_counter()
    M, A = m["M"], m["Aw"]
    cfg = m["get_config"](arch)
    opt_cfg = frontend_opt(m)
    params = M.init_params(torch.Generator(device).manual_seed(0), cfg,
                           master=True)
    step = M.make_train_step(cfg, None, opt_cfg)
    opt = A.init(A.flatten_params(params), opt_cfg)
    batch = frontend_train_batch(m, cfg, device)
    batches = [batch] * FRONTEND_TRAIN_STEPS
    _sync(device)
    _reset_peak(device)
    resident = _allocated(device)
    # handed over, so that the first step's masters and moments are freed
    # with the second's, as in a training loop
    state = [params, opt]
    del params, opt
    norms = []
    (params, opt, losses, ms), launches = counted_run(
        m, lambda: timed_steps(step, state.pop(0), state.pop(0), batches,
                               norms=norms), device)
    expect_launches(leg, launches, {})
    if record is not None:
        record.write_text(json.dumps({"loss": losses[0],
                                      "grad_norm": norms[0]}))
    peak = _peak(device) - resident
    prof = profile_step(lambda: step(params, opt, batch))
    step_ms = float(np.median(ms[1:]))
    emit({"phase": leg, "card": name, "wall_s": time.perf_counter() - wall,
          "arch": cfg.name, "layers": cfg.n_layers,
          "encoder_layers": cfg.encoder_layers, "d_model": cfg.d_model,
          "params": sum(p.numel()
                        for p in A.flatten_params(params).values()),
          "batch": FRONTEND_TRAIN_BATCH, "seq": FRONTEND_TRAIN_SEQ,
          "prefix": prefix_len(cfg), "remat": cfg.train.remat,
          "loss_seq_chunks": cfg.train.loss_seq_chunks,
          "steps": FRONTEND_TRAIN_STEPS, "step_ms": ms,
          "step_ms_median_after_first": step_ms,
          "tokens_per_s": FRONTEND_TRAIN_BATCH * FRONTEND_TRAIN_SEQ
          / step_ms * 1e3,
          "peak_bytes_above_resident": peak, "resident_bytes": resident,
          "losses": losses, "grad_norms": norms, "profile": prof,
          "gemm_share": prof["gemm_ms"]
          / max(prof["gemm_ms"] + prof["other_ms"], 1e-9)})
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{leg}: loss {losses[0]} -> {losses[-1]} "
                             "did not fall")
    del params, opt, batches, batch
    _free(device)
    return {leg: dict(launches=launches,
                      rows=FRONTEND_TRAIN_STEPS * FRONTEND_TRAIN_BATCH)}


# --------------------------------------------------------------------------
# the Mamba serving path: Falcon-Mamba-7B with the selective-scan kernel
# --------------------------------------------------------------------------

# the reference's own tolerance for its scan kernel against its ref
# (tests/test_kernels.py::test_selective_scan_interpret_matches_ref),
# absolute and relative; the two sum over N in other orders
SCAN_TOL = 2e-4
# the kernel path's conv and ssm states against the plain scan's, within
# MAMBA_STATE_TOL of each state's largest magnitude (the CPU tests' rule
# against the reference): the two scans differ by float32 rounding, which
# a bf16 rounding of the next layer's input may turn into one bf16 ulp
# (2^-8) and 64 random-weight layers carry on.  The first run on the card
# measured 0.0137 at most (the ssm state after an 872-token prompt and 8
# decode steps) and logits within 0.073 of each other.
MAMBA_STATE_TOL = 2e-2


@contextlib.contextmanager
def recording_longest(op, fn_name, calls):
    """Context in which ``op.fn_name`` keeps in ``calls`` a copy of the
    arguments (positional then keyword) of the first call with the
    longest sequence (``args[0].shape[1]``) seen so far."""
    plain = getattr(op, fn_name)

    def keep(*args, **kwargs):
        if not calls or args[0].shape[1] > calls[0][0].shape[1]:
            calls[:] = [tuple(a.clone() for a in args)
                        + tuple(kwargs.values())]
        return plain(*args, **kwargs)

    setattr(op, fn_name, keep)
    try:
        yield
    finally:
        setattr(op, fn_name, plain)


def against_plain_scan(m, cfg, params, req, prompt_cap, gen_cap, device,
                       steps=8) -> dict:
    """One request's slot prefill with the scan kernel and with the plain
    scan (``mamba_impl="xla"``), then ``steps`` decode steps from each
    state fed the same tokens (the engine's, then seeded random ones):
    the kernel runs in every layer of the first prefill and in none of
    the second; logits within SERVE_LOGIT_TOL at every position; the
    conv and ssm states after the prefill and after the steps within
    MAMBA_STATE_TOL of their largest magnitude."""
    M, scan = m["M"], m["ops"]["mamba_scan"]
    n = len(req.prompt)
    padded = np.zeros((1, prompt_cap), np.int32)
    padded[0, :n] = req.prompt
    batch = {"tokens": torch.from_numpy(padded).to(device)}
    rng = np.random.default_rng(req.req_id)
    feed = (list(req.out_tokens)
            + rng.integers(0, cfg.vocab, steps).tolist())[:steps]
    step = M.make_serve_step(cfg)
    runs = {}
    for impl in ("cuda", "xla"):
        scan.launches = 0
        logits, caches = M.make_slot_prefill(
            cfg, decode_len=prompt_cap + gen_cap, mamba_impl=impl)(
            params, batch, n)
        launched = scan.launches
        states = [{k: v.clone() for k, v in caches.items()}]
        seq = [logits[0].float().cpu()]
        for i, tok in enumerate(feed):
            logits, caches = step(params, caches, torch.tensor(
                [[tok]], dtype=torch.int32, device=device), n + i)
            seq.append(logits[0].float().cpu())
        states.append(caches)
        runs[impl] = (seq, states, launched)
    _sync(device)
    if (runs["cuda"][2], runs["xla"][2]) != (cfg.n_layers, 0):
        raise AssertionError(f"serving_mamba: scan launches "
                             f"{runs['cuda'][2]} / {runs['xla'][2]}, "
                             f"expected {cfg.n_layers} / 0")
    out = {"request": req.req_id, "prompt": n, "steps": steps,
           "logit_diff": max(float((a - b).abs().max()) for a, b in zip(
               runs["cuda"][0], runs["xla"][0], strict=True))}
    for when, (a, b) in zip(("prefill", "decoded"),
                            zip(runs["cuda"][1], runs["xla"][1])):
        for k in ("conv", "ssm"):
            scale = float(b[k].abs().max())
            out[f"{k}_{when}_diff_over_max"] = \
                float((a[k] - b[k]).abs().max()) / scale
    worst = max(v for k, v in out.items() if k.endswith("_over_max"))
    if out["logit_diff"] > SERVE_LOGIT_TOL or worst > MAMBA_STATE_TOL:
        raise AssertionError(f"serving_mamba: kernel against plain scan "
                             f"{out}")
    return out


def first_prefill_ssm(engine) -> list:
    """Wrap ``engine``'s slot prefill; the returned list gets the ssm
    states (host, float32) its first call gives, a period stack's as
    ``{sub-layer: state}`` (install before a :class:`Recorder`, whose
    logits then name that call's request first)."""
    plain, kept = engine._slot_prefill, []

    def prefill(params, batch, length):
        logits, caches = plain(params, batch, length)
        if not kept:           # a period stack's: each Mamba sub-layer's
            kept.append(caches["ssm"].float().cpu() if "ssm" in caches
                        else {j: c["ssm"].float().cpu()
                              for j, c in caches.items() if "ssm" in c})
        return logits, caches

    engine._slot_prefill = prefill
    return kept


def run_serving_mamba(m, device, cfg, *, prompt_cap=SERVE_PROMPT,
                      gen_cap=SERVE_GEN, n_req=SERVE_REQUESTS,
                      slots=SERVE_SLOTS, queue=SERVE_QUEUE, mamba_impl=None,
                      record: Path | None = None):
    """Drive the serving path once with a Mamba stack and the scan kernel,
    counted and checked, then against the one-shot loop and, for two
    requests, the plain scan; time and profile it.  ``mamba_impl`` is the
    engine's scan path (``None``: what the device implies; a rehearsal on
    the CPU passes ``"cuda"`` to reach the scan wrapper's plain version).
    With ``record``, the world-1 record ``serving_mamba_tp2`` is held to
    is saved there (:func:`mamba_world1_record`).  Returns (legs, the
    arguments of the longest prefill's first scan)."""
    M, serve, ops = m["M"], m["serve"], m["ops"]
    params = M.init_params(torch.Generator(device=device).manual_seed(0),
                           cfg)
    _sync(device)
    resident = _allocated(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    recorded = []

    for op in ops.values():
        op.launches = 0
    stores, tables = serve.feature_stores(m["make_context"](device), 0,
                                          max(slots, 8))
    lookups = count_lookups(stores)
    engine = m["ServingEngine"](
        cfg, params, slots=slots, prompt_capacity=prompt_cap,
        gen_capacity=gen_cap, queue_capacity=queue, feature_stores=stores,
        mamba_impl=mamba_impl, device=device)
    reqs = serve.make_requests(cfg, n_req, prompt_cap, gen_cap, seed=0)
    pick = [r.req_id for r in reqs if r.gen_len > 1][:2]
    first_ssm = first_prefill_ssm(engine)
    rec = Recorder(engine, keep=set(pick))
    with recording_longest(ops["mamba_scan"], "selective_scan", recorded):
        done, rejected, seconds = serve.drive(engine, reqs, slots)
    _sync(device)
    if record is not None:
        torch.save(mamba_world1_record(m, params, rec, done, first_ssm),
                   record)
    launches = {k: op.launches for k, op in ops.items()}
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0) - resident

    mt = engine.metrics
    check_engine_run("serving_mamba", engine, done, rejected, reqs, tables,
                     stores)
    expect_launches("serving_mamba", launches, {
        "mamba_scan": cfg.n_layers * mt.count("prefills"),
        "hash_partition": store_chunks(serve, stores) + lookups[0],
        "radix_sort": 0})
    by_id = {r.req_id: r for r in done}
    oneshot = against_oneshot(m, cfg, params, rec, by_id, pick, device)
    plain_scan = [against_plain_scan(m, cfg, params, by_id[rid], prompt_cap,
                                     gen_cap, device) for rid in pick]

    # time one full-length prefill and one decode step of all slots
    prefill = M.make_slot_prefill(cfg, decode_len=prompt_cap + gen_cap)
    full = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, prompt_cap)).astype(np.int32)).to(device)}
    step = M.make_serve_step(cfg)
    toks = torch.zeros((slots, 1), dtype=torch.int32, device=device)
    lens = np.full(slots, prompt_cap - 1, np.int32)
    prefill_ms = event_ms(lambda: prefill(params, full, prompt_cap), reps=5)
    step_ms = event_ms(lambda: step(params, engine.caches, toks, lens),
                       reps=10)

    def decode8():
        for _ in range(8):
            step(params, engine.caches, toks, lens)

    prof = profile_serving(m, {
        "prefill": lambda: prefill(params, full, prompt_cap),
        "decode_8_steps": decode8}, device,
        [(m["Ly"], "dense"), (m["Mb"], "_ssm_inputs"),
         (m["Ly"], "logits_out"), (ops["mamba_scan"], "selective_scan")],
        [("selective_scan", "mamba_scan_kernel")])
    busy = sum(p["device_busy_ms"] for p in prof.values()) \
        / sum(p["wall_ms"] for p in prof.values())
    tokens = mt.count("tokens_generated")
    emit({
        "phase": "serving_mamba", "arch": cfg.name, "layers": cfg.n_layers,
        "d_model": cfg.d_model, "d_inner": cfg.d_inner,
        "ssm_state": cfg.ssm_state, "slots": slots,
        "prompt_capacity": prompt_cap, "gen_capacity": gen_cap,
        "requests": n_req, "completed": mt.count("completed"),
        "prefills": mt.count("prefills"),
        "decode_steps": mt.count("decode_steps"), "tokens": tokens,
        "prompt_tokens": int(sum(len(r.prompt) for r in reqs)),
        "seconds": seconds, "tokens_per_s": tokens / seconds,
        "ttft_p50_ms": mt.percentile("ttft", 50) * 1e3,
        "ttft_p99_ms": mt.percentile("ttft", 99) * 1e3,
        "latency_p50_ms": mt.percentile("latency", 50) * 1e3,
        "latency_p99_ms": mt.percentile("latency", 99) * 1e3,
        "prefill_ms": prefill_ms, "decode_step_ms": step_ms,
        "peak_bytes_above_resident": peak, "resident_bytes": resident,
        "weight_bytes": sum(t.numel() * t.element_size()
                            for t in _leaves(params)),
        "cache_bytes": {k: v.numel() * v.element_size()
                        for k, v in engine.caches.items()},
        "feature_lookups": lookups[0], "dropped": 0, "launches": launches,
        "oneshot": oneshot, "plain_scan": plain_scan,
        "logit_tol": SERVE_LOGIT_TOL, "state_tol": MAMBA_STATE_TOL,
        "busy_share_prefill_plus_8_decode": busy, "profile": prof})
    legs = {"serving_mamba": dict(launches=launches, rows=n_req)}
    del params, engine, stores, prefill, step, full
    _free(device)
    return legs, recorded[0]


def mamba_world1_record(m, params, rec, done, first_ssm) -> dict:
    """What ``serving_mamba_tp2`` is held to: of the first
    TP_TWIN_REQUESTS requests, each one's prefill logits, greedy tokens
    and their top-2 margins; the first prefill's ssm states (its request
    first in ``rec.logits``); every leaf's whole shape."""
    first = next(iter(rec.logits))
    by_id = {r.req_id: r for r in done}
    ids = sorted(by_id)[:TP_TWIN_REQUESTS]
    return {"logits": {rid: rec.logits[rid] for rid in ids},
            "margins": {rid: list(rec.margins[rid]) for rid in ids},
            "tokens": {rid: list(by_id[rid].out_tokens) for rid in ids},
            "first": first, "ssm": first_ssm[0],
            "shapes": {k: tuple(v.shape) for k, v in
                       m["Aw"].flatten_params(params).items()}}


def scan_cases(recorded, device, seed=4):
    """mamba_scan's cases: (a) the x, delta, A, B, C and D the longest
    prefill of the Mamba leg gave its first layer, with the final state;
    (b) that shape with random inputs; (c) ragged S = 1000; (d) S = 1;
    (e) B = 4; (f) N = 8; (g) y alone (no final state); (h) E = 8200, not
    a multiple of the kernel's 32-channel tile; (i) S = 961, one past a
    multiple of its 64-step time chunk.  No PyTorch call computes the
    selective scan, so there is no library time."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(B, S, E, N):
        def r(*shape):
            return torch.randn(shape, generator=gen, device=device)
        return (r(B, S, E), torch.nn.functional.softplus(r(B, S, E)),
                -torch.exp(r(E, N) * 0.5), r(B, S, N), r(B, S, N), r(E))

    x = recorded[0]
    B, S, E = x.shape
    N = recorded[2].shape[1]
    cases = [dict(shape=f"(a) serving prefill x {tuple(x.shape)} N {N} "
                        "with hT", args=tuple(recorded))]
    for label, shape, state in (("(b)", (B, S, E, N), True),
                                ("(c)", (1, 1000, E, N), True),
                                ("(d)", (1, 1, E, N), True),
                                ("(e)", (4, 1024, E, N), True),
                                ("(f)", (1, 1024, E, 8), True),
                                ("(g)", (1, 1024, E, N), False),
                                ("(h)", (1, 1024, 8200, N), True),
                                ("(i)", (1, 961, E, N), True)):
        cases.append(dict(
            shape=f"{label} B {shape[0]} S {shape[1]} E {shape[2]} "
                  f"N {shape[3]} {'with hT' if state else 'y alone'}",
            args=(*rand(*shape), state)))
    return cases


def _scan_close(case, got, want) -> float:
    """Each output finite and within SCAN_TOL (absolute and relative) of
    the plain version; returns the largest absolute difference."""
    err = 0.0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"mamba_scan {case['shape']}: {g.dtype} "
                                 f"{tuple(g.shape)}")
        diff = (g - w).abs()
        if not bool(torch.isfinite(g).all()) \
                or bool((diff > SCAN_TOL * (1 + w.abs())).any()):
            raise AssertionError(f"mamba_scan {case['shape']}: differs from "
                                 f"selective_scan_ref by {float(diff.max())}")
        err = max(err, float(diff.max()) if diff.numel() else 0.0)
    return err


# --------------------------------------------------------------------------
# the hybrid period stack: one period of Jamba-1.5-Large
# --------------------------------------------------------------------------


def jamba_config(m):
    """(Jamba at its published widths and one whole period of layers,
    the same with JAMBA_EXPERTS experts: the leg's model)."""
    full = m["get_config"](JAMBA_ARCH)
    full = dataclasses.replace(full, n_layers=full.attn_period)
    return full, dataclasses.replace(full, n_experts=JAMBA_EXPERTS)


def layer_counts(m, cfg) -> dict:
    """Attention and Mamba layers of the stack."""
    kinds = [m["Tf"].layer_kind(cfg, i)[0] for i in range(cfg.n_layers)]
    return {"attn": kinds.count("attn"), "mamba": kinds.count("mamba")}


def run_serving_jamba(m, device, *, prompt_cap=SERVE_PROMPT,
                      gen_cap=JAMBA_GEN, n_req=JAMBA_REQUESTS,
                      slots=SERVE_SLOTS, queue=SERVE_QUEUE, attn_impl=None,
                      mamba_impl=None):
    """Drive the serving path once with one period of Jamba (a period
    stack: the flash kernel in its attention layer and the scan kernel
    in each Mamba layer of every prefill; at world 1 its MoE layers run
    ``moe_dense``), counted and checked, then two requests against the
    one-shot loop and the twin ``serving_jamba_xla``: the first
    JAMBA_TWIN_REQUESTS requests through an engine on plain attention
    and the plain scan, whose prefill logits, greedy tokens and first
    prefill's ssm states (each Mamba sub-layer's) the kernel run is held
    to; time and profile it.  ``attn_impl`` / ``mamba_impl``: the
    engine's paths (``None``: what the device implies; a rehearsal on
    the CPU passes ``"cuda"`` to reach the wrappers' plain versions).
    Returns (legs, the flash and scan cases of the first prefill's first
    calls)."""
    M, serve, ops = m["M"], m["serve"], m["ops"]
    leg = "serving_jamba"
    full, cfg = jamba_config(m)
    counts = layer_counts(m, cfg)
    no_tf32(leg)
    _free(device)
    _sync(device)
    resident = _allocated(device)
    _reset_peak(device)
    params = M.init_params(torch.Generator(device=device).manual_seed(0),
                           cfg)
    expert_bytes = experts_bf16(leg, params)
    _sync(device)
    weight_alloc = _allocated(device) - resident
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    emit({"phase": f"{leg}_memory", "arch": cfg.name,
          "layers": cfg.n_layers, "experts_published": full.n_experts,
          "experts": cfg.n_experts,
          "bf16_bytes_published_period": 2 * full.param_count(),
          "bf16_bytes_cut_period": 2 * cfg.param_count(),
          "weight_bytes": weight_bytes, "expert_bytes": expert_bytes,
          "init_peak_bytes_above_resident": _peak(device) - resident})

    flash_rec, scan_rec = [], []
    for op in ops.values():
        op.launches = 0
    stores, tables = serve.feature_stores(m["make_context"](device), 0,
                                          max(slots, 8))
    lookups = count_lookups(stores)
    before_engine = _allocated(device)
    engine = m["ServingEngine"](
        cfg, params, slots=slots, prompt_capacity=prompt_cap,
        gen_capacity=gen_cap, queue_capacity=queue, feature_stores=stores,
        attn_impl=attn_impl, mamba_impl=mamba_impl, device=device)
    res_check = resident_check(m, cfg, slots, prompt_cap + gen_cap,
                               weight_alloc,
                               _allocated(device) - before_engine)
    reqs = serve.make_requests(cfg, n_req, prompt_cap, gen_cap, seed=0)
    pick = [r.req_id for r in reqs if r.gen_len > 1][:2]
    first_ssm = first_prefill_ssm(engine)
    routes = RouteLog(m["Moe"])
    rec = Recorder(engine, keep=set(pick), routes=routes)
    with recording(ops["flash_attention"], "flash_attention", flash_rec,
                   picks={0}), \
            recording(ops["mamba_scan"], "selective_scan", scan_rec,
                      picks={0}), routes:
        done, rejected, seconds = serve.drive(engine, reqs, slots)
    _sync(device)
    launches = {k: op.launches for k, op in ops.items()}
    peak = _peak(device) - resident

    mt = engine.metrics
    check_engine_run(leg, engine, done, rejected, reqs, tables, stores)
    expect_launches(leg, launches, {
        "flash_attention": counts["attn"] * mt.count("prefills"),
        "mamba_scan": counts["mamba"] * mt.count("prefills"),
        "hash_partition": store_chunks(serve, stores) + lookups[0],
        "radix_sort": 0})
    by_id = {r.req_id: r for r in done}
    oneshot = against_oneshot(m, cfg, params, rec, by_id, pick, device,
                              routes)

    # the twin: the first requests on plain attention and the plain scan
    for op in ops.values():
        op.launches = 0
    n_lookups = lookups[0]
    xla = m["ServingEngine"](
        cfg, params, slots=slots, prompt_capacity=prompt_cap,
        gen_capacity=gen_cap, queue_capacity=queue, feature_stores=stores,
        attn_impl="xla", mamba_impl="xla", device=device)
    xfirst = first_prefill_ssm(xla)
    xroutes = RouteLog(m["Moe"])
    xreqs = serve.make_requests(cfg, n_req, prompt_cap, gen_cap,
                                seed=0)[:JAMBA_TWIN_REQUESTS]
    xrec = Recorder(xla, keep={r.req_id for r in xreqs}, routes=xroutes)
    with xroutes:
        xdone, _, xseconds = serve.drive(xla, xreqs, slots)
    _sync(device)
    xlaunches = {k: op.launches for k, op in ops.items()}
    expect_launches(f"{leg}_xla", xlaunches, {
        "hash_partition": lookups[0] - n_lookups, "radix_sort": 0})
    check_served(xdone, xreqs, tables, len(xreqs))
    want = {r.req_id: r for r in xdone}
    # each request held up to its first position whose own token's MoE
    # routing differs between the two engines (a near tie broken
    # otherwise by the kernels' roundings, :func:`held_routes`): the
    # prefill logits, the greedy tokens before that position
    n_moe = sum(cfg._layer_has_moe(i) for i in range(cfg.n_layers))
    flips = {rid: held_routes(f"{leg}_xla", rid, route_diffs(
        routes.log[rid], xroutes.log[rid], n_moe,
        next((i for i, (a, b) in enumerate(zip(by_id[rid].out_tokens,
                                               r.out_tokens)) if a != b),
             None)))
        for rid, r in want.items() if rid in pick}
    held = {rid: flips[rid]["first_position"] if rid in flips else None
            for rid in want}
    worst = max(float((rec.logits[rid] - lg).abs().max())
                for rid, lg in xrec.logits.items())
    if worst > SERVE_LOGIT_TOL:
        raise AssertionError(f"{leg}: kernel and plain prefill logits "
                             f"differ by {worst} > {SERVE_LOGIT_TOL} "
                             f"(routing flips {flips})")
    compared = sum(greedy_agree(
        by_id[rid].out_tokens[:held[rid]], r.out_tokens,
        xrec.margins[rid], SERVE_LOGIT_TOL) for rid, r in want.items())
    if compared == 0:
        raise AssertionError(f"{leg}: no token compared with the plain run")
    if next(iter(rec.logits)) != next(iter(xrec.logits)):
        raise AssertionError(f"{leg}: the engines' first prefills are of "
                             "other requests")
    states = {j: float((a - xfirst[0][j]).abs().max())
              / float(xfirst[0][j].abs().max())
              for j, a in first_ssm[0].items()}
    if len(states) != counts["mamba"] \
            or max(states.values()) > MAMBA_STATE_TOL:
        raise AssertionError(f"{leg}: first prefill's ssm states against "
                             f"the plain path's {states}")

    # time one full-length prefill and one decode step of all slots
    prefill = M.make_slot_prefill(cfg, decode_len=prompt_cap + gen_cap)
    fullb = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, prompt_cap)).astype(np.int32)).to(device)}
    step = M.make_serve_step(cfg)
    toks = torch.zeros((slots, 1), dtype=torch.int32, device=device)
    lens = np.full(slots, prompt_cap - 1, np.int32)
    prefill_ms = event_ms(lambda: prefill(params, fullb, prompt_cap), reps=3)
    step_ms = event_ms(lambda: step(params, engine.caches, toks, lens),
                       reps=5)

    def decode8():
        for _ in range(8):
            step(params, engine.caches, toks, lens)

    prof = profile_serving(m, {
        "prefill": lambda: prefill(params, fullb, prompt_cap),
        "decode_8_steps": decode8}, device,
        [(m["Ly"], "dense"), (m["A"], "decode_attention"),
         (m["Mb"], "_ssm_inputs"), (m["Moe"], "_expert_ffn"),
         (m["Moe"], "_route"), (m["Ly"], "logits_out"),
         (ops["flash_attention"], "flash_attention"),
         (ops["mamba_scan"], "selective_scan")],
        [("selective_scan", "mamba_scan_kernel"),
         ("flash_attention", "flash_attention_kernel")])
    busy = sum(p["device_busy_ms"] for p in prof.values()) \
        / sum(p["wall_ms"] for p in prof.values())
    tokens = mt.count("tokens_generated")
    emit({
        "phase": leg, "arch": cfg.name, "layers": cfg.n_layers,
        "layer_kinds": [list(m["Tf"].layer_kind(cfg, i)[:2])
                        for i in range(cfg.n_layers)],
        "d_model": cfg.d_model, "d_inner": cfg.d_inner,
        "experts": cfg.n_experts, "top_k": cfg.top_k, "slots": slots,
        "prompt_capacity": prompt_cap, "gen_capacity": gen_cap,
        "requests": n_req, "completed": mt.count("completed"),
        "prefills": mt.count("prefills"),
        "decode_steps": mt.count("decode_steps"), "tokens": tokens,
        "prompt_tokens": int(sum(len(r.prompt) for r in reqs)),
        "seconds": seconds, "tokens_per_s": tokens / seconds,
        "ttft_p50_ms": mt.percentile("ttft", 50) * 1e3,
        "ttft_p99_ms": mt.percentile("ttft", 99) * 1e3,
        "latency_p50_ms": mt.percentile("latency", 50) * 1e3,
        "latency_p99_ms": mt.percentile("latency", 99) * 1e3,
        "prefill_ms": prefill_ms, "decode_step_ms": step_ms,
        "peak_bytes_above_resident": peak, "resident_bytes": resident,
        "weight_bytes": weight_bytes, "expert_bytes": expert_bytes,
        "resident_check": res_check,
        "cache_bytes": sum(v.numel() * v.element_size()
                           for _, v in M.cache_leaves(engine.caches)),
        "feature_lookups": n_lookups, "dropped": 0, "launches": launches,
        "oneshot": oneshot, "xla_requests": len(xreqs),
        "xla_seconds": xseconds, "xla_launches": xlaunches,
        "logit_tol": SERVE_LOGIT_TOL, "state_tol": MAMBA_STATE_TOL,
        "prefill_logit_diff_max": worst, "xla_route_flips": flips,
        "tokens_compared_with_xla": compared,
        "first_prefill_ssm_diff_over_max": states,
        "busy_share_prefill_plus_8_decode": busy, "profile": prof})
    legs = {leg: dict(launches=launches, rows=n_req, resident=res_check),
            f"{leg}_xla": dict(launches=xlaunches, rows=len(xreqs))}
    x = scan_rec[0][0]
    cases = {"flash_attention": [recorded_flash_case("(q) serving_jamba",
                                                     flash_rec[0])],
             "mamba_scan": [dict(
                 shape=f"(k) serving_jamba prefill x {tuple(x.shape)} "
                       f"N {scan_rec[0][2].shape[1]} with hT",
                 args=tuple(scan_rec[0]))]}
    del params, engine, xla, stores, prefill, step, fullb
    _free(device)
    return legs, cases


# --------------------------------------------------------------------------
# the dry-run: specs and the roofline held to the card
# --------------------------------------------------------------------------

# predicted resident bytes against torch.cuda.memory_allocated: within
RESIDENT_TOL = 0.005


def resident_check(m, cfg, slots, decode_len, weight_bytes,
                   cache_bytes) -> dict:
    """The bytes ``launch/specs.py`` predicts one card holds for a serving
    leg at world 1 (the parameters and the engine's caches of ``slots``
    rows of ``decode_len`` positions) beside those measured: the growth
    of ``torch.cuda.memory_allocated`` over the weights' draw and over
    the engine's making."""
    SP = m["SP"]
    cell = m["ShapeCell"]("serving", decode_len, slots, "decode")
    predicted = {"params": SP.tree_bytes(SP.param_specs(cfg, None)),
                 "caches": SP.tree_bytes(SP.cache_specs(cfg, cell, None))}
    measured = {"params": weight_bytes, "caches": cache_bytes}
    p, q = sum(predicted.values()), sum(measured.values())
    return {"predicted": predicted, "measured": measured,
            "predicted_bytes": p, "measured_bytes": q,
            "rel_err": abs(p - q) / q if q else None}


def run_dryrun(m, name, legs) -> None:
    """Phase 11i: the dry-run of Granite-3.0-2B's cells on the 16 x 16
    mesh on this torch (the ``fake`` backend and ``meta`` tensors, no
    device memory), the resident bytes predicted for the Granite and
    Jamba serving legs against their measured ones, and the Granite
    leg's 1024-token prefill priced with the roofline."""
    import torch.distributed as dist
    Dr, Ro = m["Dr"], m["Ro"]
    t0 = time.perf_counter()
    cells = {}
    for cell in m["cells_for"](SERVE_ARCH):
        rec = Dr.run_cell(SERVE_ARCH, cell, False)
        if not rec["ok"] or not rec["compute_s"] > 0 \
                or rec["bound"] not in ("compute", "memory", "collective"):
            raise AssertionError(f"dryrun: {cell} {rec}")
        cells[cell] = {k: rec[k] for k in (
            "compute_s", "memory_s", "collective_s", "bound", "step_s",
            "mfu", "flops_per_dev", "bytes_per_dev", "run_s")}
        cells[cell]["resident_bytes"] = rec["memory_per_dev"]["total_bytes"]
    if dist.is_initialized():
        raise AssertionError("dryrun: a process group is left initialised")
    resident = {}
    for leg in ("serving", "serving_jamba"):
        r = legs[leg]["resident"]
        if not r["rel_err"] <= RESIDENT_TOL:
            raise AssertionError(f"dryrun: {leg}'s resident bytes {r} "
                                 f"beyond {RESIDENT_TOL}")
        resident[leg] = r
    info = legs["serving"]["prefill"]
    cfg = serve_config(m, SERVE_ARCH)
    cell = m["ShapeCell"]("serving_prefill", info["prompt"], 1, "prefill")
    roof = Dr.measure(cfg, cell, None, decode_len=info["decode_len"])
    measured_s = info["ms"] / 1e3
    measured_mfu = roof["model_flops"] / (measured_s * Ro.PEAK_FLOPS)
    if not 0 < measured_mfu <= 1:
        raise AssertionError(f"dryrun: the prefill's MFU {measured_mfu}")
    emit({"phase": "dryrun_prefill", "card": name, "arch": cfg.name,
          "layers": cfg.n_layers, "tokens": info["prompt"],
          "measured_ms": info["ms"], "roofline_step_ms": roof["step_s"] * 1e3,
          "roofline_bound": roof["bound"], "roofline_mfu": roof["mfu"],
          "measured_mfu": measured_mfu,
          "roofline_over_measured": roof["step_s"] / measured_s,
          "compute_ms": roof["compute_s"] * 1e3,
          "memory_ms": roof["memory_s"] * 1e3,
          "flops": roof["flops_per_dev"], "bytes": roof["bytes_per_dev"],
          "model_flops": roof["model_flops"], "kernels": roof["kernels"]})
    emit({"phase": "dryrun", "card": name, "arch": SERVE_ARCH,
          "mesh": "16x16", "cells": cells, "resident": resident,
          "seconds": time.perf_counter() - t0})


# --------------------------------------------------------------------------
# timings
# --------------------------------------------------------------------------


def time_leg(run, device, reps=3):
    """Median host seconds of ``reps`` warmed runs, each ended by a
    synchronize, and the peak device memory the runs add to what is
    resident before them (the leg's input tables, the other legs' and the
    kernel cases): (seconds, peak bytes above resident, resident bytes)."""
    run()
    _sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    resident = torch.cuda.memory_allocated(device)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        _sync(device)
        ts.append(time.perf_counter() - t0)
    return (float(np.median(ts)),
            torch.cuda.max_memory_allocated(device) - resident, resident)


def profile_leg(run, top=8):
    """One warmed run under torch.profiler: the device's busy share of the
    run's wall time and the device kernels that took most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    kernels.sort(key=lambda e: -e.self_device_time_total)

    def row(e):
        return {"name": e.key[:80], "count": e.count,
                "device_ms": e.self_device_time_total / 1e3}

    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / wall_us,
            "top_kernels": [row(e) for e in kernels[:top]],
            "port_kernels": [row(e) for e in kernels
                             if any(f"{k}_kernel" in e.key
                                    for k in PORT_KERNEL_FNS)]}


def event_ms(fn, reps=10, warm=True):
    """CUDA-event milliseconds per call over ``reps`` calls, after one
    warm-up call (none with ``warm`` false: the caller ran ``fn``)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def port_kernel_ms(fn, reps=5, tries=3):
    """Device milliseconds of the port's kernels that one call of ``fn``
    launches, each once: their sum and each by name, from
    ``torch.profiler`` over ``reps`` warmed calls, as each kernel's mean
    over the launches the profile recorded (it may drop some, or all: a
    profile that recorded none is taken again, up to ``tries`` times).
    (None, {}) when none recorded any."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    mine = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        mine = {e.key[:100]: e.self_device_time_total / 1e3 / e.count
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.count
                and any(f"{k}_kernel" in e.key for k in PORT_KERNEL_FNS)}
        if mine:
            break
    return (sum(mine.values()) if mine else None), mine


def library_times(m, cases, gdata, sizes, device) -> dict:
    """One PyTorch call beside a kernel: a stable ``argsort`` of the ids,
    which gives their stable within-partition order, beside
    ``hash_partition`` (10 M pids, P = 2) and ``fused_bucketing`` (the
    bucket ids of its first case); a stable ``argsort`` of the 20 M-row
    words beside the radix pass and the port's ``radix_permutation`` of
    the same key (5 passes); the sort-backend local groupby beside the
    hash-backend one on the groupby leg's rows; ``torch.isin`` of the drug
    filter's probe keys against its build keys;
    ``scaled_dot_product_attention`` on the q, k, v of the serving leg's
    prefill."""
    L, rs = m["L"], m["ops"]["radix_sort"]
    pid = cases["hash_partition"][0]["args"][0]
    bid = m["fb_ref"].fused_bucket_ranks_ref(
        *cases["fused_bucketing"][0]["args"])[0]
    words = cases["radix_sort"][0]["args"][1]
    none = torch.zeros(words.shape[0], dtype=torch.bool, device=device)
    out = {"hash_partition": {"library_ms": event_ms(
               lambda: torch.argsort(pid, stable=True), reps=5)},
           "fused_bucketing": {"library_ms": event_ms(
               lambda: torch.argsort(bid, stable=True), reps=10)},
           "radix_sort": {
        "library_ms": event_ms(lambda: torch.argsort(words, stable=True),
                               reps=5),
        "radix_permutation_ms": event_ms(
            lambda: rs.radix_permutation((words,), none), reps=5)}}
    t = m["D"].distribute_table(m["make_context"](), gdata)
    out["hash_groupby"] = {
        "library_ms": event_ms(lambda: L.groupby_aggregate(
            t, ["k"], AGGS, impl="sort"), reps=3),
        "hash_groupby_local_ms": event_ms(lambda: L.groupby_aggregate(
            t, ["k"], AGGS, impl="hash", may_plan=False, **sizes), reps=3)}
    probe, build = cases["hash_semi"][0]["library"]
    out["hash_semi"] = {"library_ms": event_ms(
        lambda: torch.isin(probe, build), reps=5)}
    out["flash_attention"] = {"library_ms": event_ms(
        cases["flash_attention"][0]["library"], reps=20)}
    return out


def run_encdec_world1(m, device, name, tmpdir: Path, cases, errs) -> dict:
    """``serving_seamless`` and ``serving_internvl`` with flash cases
    (i)-(k) added to ``cases`` (their errors to ``errs``), then
    ``seamless_train``; each writes its world-1 record to ``tmpdir``.
    The encoder's self-attention and the decoder's cross-attention are
    the first Seamless prefill's flash calls 0 and 25 (24 encoder layers,
    then the decoder's layer 0: self, cross).  Returns the legs."""
    seamless = m["get_config"](SEAMLESS_ARCH)
    sizes = dict(batches=ONESHOT_BATCHES, rows=ONESHOT_ROWS,
                 prompt=ONESHOT_PROMPT, gen=ONESHOT_GEN)
    legs, seamless_qkv = run_serving_oneshot(
        m, device, seamless, leg="serving_seamless",
        picks=(0, seamless.encoder_layers + 1),
        record=tmpdir / "serving_seamless_world1.pt", **sizes)
    internvl_legs, internvl_qkv = run_serving_oneshot(
        m, device, m["get_config"](INTERNVL_ARCH), leg="serving_internvl",
        record=tmpdir / "serving_internvl_world1.pt", **sizes)
    legs.update(internvl_legs)
    new_cases = [recorded_flash_case(label, qkv) for label, qkv in (
        ("(i) serving_seamless encoder", seamless_qkv[0]),
        ("(j) serving_seamless cross", seamless_qkv[1]),
        ("(k) serving_internvl", internvl_qkv[0]))]
    del seamless_qkv, internvl_qkv
    errs["flash_attention"] = max(errs["flash_attention"], compare_kernels(
        m, {"flash_attention": new_cases}, device)["flash_attention"])
    cases["flash_attention"] += new_cases
    legs.update(run_frontend_train(m, device, name, SEAMLESS_ARCH,
                                   "seamless_train",
                                   record=tmpdir / SEAMLESS_TRAIN_WORLD1))
    _free(device)
    return legs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    # the memmap leg's probe columns live here until the timing phase
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        return run_all(Path(tmp))


def run_all(tmpdir: Path) -> int:
    m = _modules()
    device = torch.device("cuda")
    name = card()
    print(name, flush=True)

    t0 = time.perf_counter()
    libs = m["build"].build()
    build_s = time.perf_counter() - t0
    emit({"phase": "build", "seconds": build_s, "card": name,
          "libraries": [p.name for p in libs.values()]})
    for lib in libs.values():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print("ptxas:", lib.stem, line.strip(), flush=True)

    ctx = m["make_context"]()
    hash_plan = m["D"].plan_dist_join_sizes(
        *[[side["k"]] for side in fig4_data(HASH_ROWS)], world=1,
        local_impl="hash")
    gdata = groupby_data(GROUPBY_ROWS, GROUPBY_KEYS)
    sizes = plan_groupby_sizes(m, gdata)
    loads = np.bincount(m["bucketing"].bucket_ids_np(
        [gdata["k"]], sizes["num_buckets"]), minlength=sizes["num_buckets"])
    cases = kernel_cases(m, device, hash_plan, sizes, loads)
    errs = compare_kernels(m, cases, device)
    groupby_workspace_case(m, device, name)
    emit({"kernels": list(KERNELS)})

    legs = run_legs(m, ctx, SORTMERGE_ROWS, HASH_ROWS, device)
    legs.update(run_table5(m, ctx, device, gdata, sizes))
    raw = unomt_data(m, UNOMT_ROWS, UNOMT_DRUGS, UNOMT_CELLS)
    unomt_legs, slabs, features = run_unomt(m, ctx, device, raw)
    legs.update(unomt_legs)
    del raw
    setop_legs, setop_slabs = run_setops(
        m, ctx, device, *setop_data(*SETOP_ROWS, SETOP_KEYS))
    legs.update(setop_legs)
    oc_legs, oc_cases = run_outofcore(m, ctx, device, tmpdir)
    legs.update(oc_legs)
    for kname, err in compare_kernels(m, oc_cases, device).items():
        errs[kname] = max(errs[kname], err)
    for kname, runs in oc_cases.items():
        for case in runs:
            emit({"phase": "kernel_timing", "name": kname,
                  "shape": case["shape"], "card": name,
                  "ms": event_ms(lambda: _kernel(m, kname, case["args"]),
                                 reps=5),
                  "bound_ms": bound(kname, case["args"])[0]})
    del oc_cases
    legs.update(run_unomt_train(m, ctx, device, *features, name))
    legs.update(run_lm_train(m, device, name, tmpdir))
    _free(device)
    legs.update(run_lm_drill(m, device, name, tmpdir))
    _free(device)
    legs.update(run_unomt_drill(m, ctx, device, *features, name, tmpdir))
    del features
    legs.update(run_mamba_train(m, device, name, tmpdir))
    cases["hash_semi"] = semi_cases(slabs + setop_slabs, device)
    errs.update(compare_kernels(m, {"hash_semi": cases["hash_semi"]},
                                device))
    serving_legs, qkv = run_serving(m, device, serve_config(m, SERVE_ARCH))
    legs.update(serving_legs)
    cases["flash_attention"] = flash_cases(qkv, device)
    errs.update(compare_kernels(
        m, {"flash_attention": cases["flash_attention"]}, device))
    mamba_legs, scan_args = run_serving_mamba(
        m, device, serve_config(m, MAMBA_ARCH),
        record=tmpdir / MAMBA_WORLD1)
    legs.update(mamba_legs)
    cases["mamba_scan"] = scan_cases(scan_args, device)
    errs.update(compare_kernels(
        m, {"mamba_scan": cases["mamba_scan"]}, device))
    moe_legs, moe_qkv = run_serving(m, device, serve_config(m, MOE_ARCH),
                                    leg="serving_moe")
    legs.update(moe_legs)
    case_h = recorded_flash_case("(h) serving_moe", moe_qkv)
    errs["flash_attention"] = max(errs["flash_attention"], compare_kernels(
        m, {"flash_attention": [case_h]}, device)["flash_attention"])
    cases["flash_attention"].append(case_h)
    # one period of Jamba at its published widths (8 of its 16 experts):
    # the first prefill's flash call (q) and first scan (k) held to the
    # plain versions
    jamba_legs, jamba_cases = run_serving_jamba(m, device)
    legs.update(jamba_legs)
    for kname, err in compare_kernels(m, jamba_cases, device).items():
        errs[kname] = max(errs[kname], err)
        cases[kname] += jamba_cases[kname]
    del jamba_cases
    # the port's dry-run on this torch, its resident bytes against the
    # two serving legs', and the Granite leg's prefill priced with it
    run_dryrun(m, name, legs)
    # the enc-dec and vision stacks at world 1, whose records the legs at
    # world 2 are held to
    legs.update(run_encdec_world1(m, device, name, tmpdir, cases, errs))
    # the MoE model at world 2: two ranks on the card; every dispatch
    # plan recorded is held to the plain ranks, the first prefill's first
    # and the decode plan are timed with case (l); then, in the same
    # ranks, Falcon-Mamba served and trained at world 2, whose first
    # prefill's first scan is case (j), and SeamlessM4T and InternVL2
    # served and Seamless trained at world 2, cases (n) and (o)
    tp_legs, tp_cases = run_serving_mesh(m, device, tmpdir,
                                         "serving_moe_tp2",
                                         then=MAMBA_TP_LEGS + ENCDEC_TP_LEGS)
    legs.update(tp_legs)
    for kname, err in compare_kernels(m, tp_cases, device).items():
        errs[kname] = max(errs[kname], err)
    cases["hash_partition"] += [tp_cases["hash_partition"][0],
                                tp_cases["hash_partition"][-1]]
    cases["flash_attention"] += tp_cases["flash_attention"]
    cases["mamba_scan"] += tp_cases["mamba_scan"]
    del tp_cases
    # and at data=2 x model=2: four ranks, the slots split over the data
    # ranks, the weights gathered over them; its plans and flash inputs
    # held to the plain versions, its decode plan (n 32) timed
    # then, in the same ranks, pod=2 x data=2 x model=1: the slots over
    # both batch axes, its first flash call (p) and a store shuffle held
    # to the plain versions
    dp_legs, dp_cases = run_serving_mesh(m, device, tmpdir,
                                         "serving_moe_dp2",
                                         then=("serving_moe_pod2",))
    legs.update(dp_legs)
    for kname, err in compare_kernels(m, dp_cases, device).items():
        errs[kname] = max(errs[kname], err)
    cases["hash_partition"] += [c for c in dp_cases["hash_partition"]
                                if c["shape"].startswith("(pod2)")]
    cases["hash_partition"].append(
        [c for c in dp_cases["hash_partition"]
         if not c["shape"].startswith("(pod2)")][-1])
    cases["flash_attention"] += [c for c in dp_cases["flash_attention"]
                                 if c["shape"].startswith("(p)")]
    del dp_cases
    legs.update(run_moe_train(m, device, name))
    # training at data=2 x model=2: four ranks on the card; every dispatch
    # plan of the first step is held to the plain ranks, the first timed
    mesh_legs, mesh_cases = run_moe_train_mesh(m, device, name, tmpdir)
    legs.update(mesh_legs)
    for kname, err in compare_kernels(m, mesh_cases, device).items():
        errs[kname] = max(errs[kname], err)
    cases["hash_partition"].append(mesh_cases["hash_partition"][0])
    del mesh_cases
    _free(device)
    legs.update(run_lm_drill_mesh(m, device, name, tmpdir))
    _free(device)
    legs.update(run_frontend_train(m, device, name, INTERNVL_ARCH,
                                   "internvl_train"))

    peaks = {}
    for leg, info in legs.items():
        if "run" not in info:          # the serving and training legs
            continue                   # time themselves
        seconds, peak, resident = time_leg(info["run"], device,
                                           reps=info.get("reps", 3))
        peaks[leg] = peak
        emit({"phase": "timing", "leg": leg, "rows": info["rows"],
              "median_s": seconds, "peak_bytes_above_resident": peak,
              "resident_bytes": resident, "card": name})
        emit({"phase": "profile", "leg": leg, "card": name,
              **profile_leg(info["run"])})
    # what the morsels are for: the device holds one morsel and the
    # resident state, not the table
    emit({"phase": "outofcore_memory", "card": name,
          "fig4_sortmerge_peak_bytes": peaks["sortmerge"],
          "fig4_sortmerge_rows_per_side": SORTMERGE_ROWS,
          "peak_bytes": {k: v for k, v in peaks.items()
                         if k.startswith("oc_")}})

    library = library_times(m, cases, gdata, sizes, device)
    table = []
    for kname in KERNELS:
        case = cases[kname][0]
        args = case["args"]
        ms = event_ms(lambda: _kernel(m, kname, args))
        plain_ms = event_ms(lambda: _plain(m, kname, args), reps=3)
        bound_ms, bound_by = bound(kname, args)
        op = m["ops"][kname]
        extra = library.get(kname, {"library_ms": None})
        row = {"name": kname, "route": "cuda", "source": op.SOURCE,
               "replaces": op.REPLACES,
               "launches": sum(leg["launches"][kname]
                               for leg in legs.values()),
               "max_abs_err": errs[kname], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": extra["library_ms"]}
        kernel_ms, by_name = port_kernel_ms(lambda: _kernel(m, kname, args))
        emit(dict(row, phase="kernel_timing", shape=case["shape"],
                  card=name, per_leg={leg: info["launches"][kname]
                                      for leg, info in legs.items()},
                  kernel_ms=kernel_ms, kernel_ms_by_name=by_name,
                  **{k: v for k, v in extra.items() if k != "library_ms"}))
        table.append(row)
    for kname in KERNELS:
        for extra in cases[kname][1:]:
            lib = extra.get("library")
            if kname == "hash_semi" and lib is not None:
                lib = (lambda p=lib[0], b=lib[1]: torch.isin(p, b))
            emit({"phase": "kernel_timing", "name": kname,
                  "shape": extra["shape"], "card": name,
                  "ms": event_ms(lambda: _kernel(m, kname, extra["args"])),
                  "kernel_ms": port_kernel_ms(
                      lambda: _kernel(m, kname, extra["args"]))[0],
                  "plain_ms": event_ms(
                      lambda: _plain(m, kname, extra["args"]), reps=1),
                  "bound_ms": bound(kname, extra["args"])[0],
                  "library_ms": event_ms(lib) if lib else None})

    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
