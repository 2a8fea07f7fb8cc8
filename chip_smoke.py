#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds every CUDA kernel from ``src/repro_torch/csrc`` and drives the port's
single-device SpGEMM, cold through all six ported accumulators ('sort',
'search', 'tiled', 'bucket', 'hash', 'stream') and the planner's choice among
them (``accumulator='auto'``, and the measured autotune), warm through the
numeric phase on a 'sort' and a 'stream' structure, and its SpMM side (MoE with
``dispatch='spmm'``, ``SparseMLP``/``SparseLinear``), then the serving
engine's SpGEMM lane (``ServingEngine.submit_spgemm``/``flush_spgemm``),
the hybrid ELLPACK + COO format (``hybrid_spgemm_dense``), the
distributed SpGEMM on four shards of the card (``spgemm(a, b, mesh=,
axis=)``), token serving on the LM stack (``ServingEngine.generate_batch``
over deepseek-v2-lite-16b, all 27 layers in bfloat16) and training on it
(``launch.train.main`` over granite-moe-3b-a800m, all 32 layers in
bfloat16), and both again under a ``("data", "model")`` mesh of four
shards (``--model-parallel``), serving partitioned by the logical-axis
rules, and training partitioned (``--model-parallel``), at a real
size:
C = A·Aᵀ for the paper's Table-I
matrix bcsstk32 (dim 45,000, nnz 2.0M), regenerated from its published
statistics exactly as ``benchmarks/common.py`` does (same seeds, same draws;
this script keeps its own copy and imports nothing of the JAX package).
Values are integers in [-4, 4] \\ {0} drawn from ``--seed``, so every float32
sum is exact and every comparison below is bit for bit.

Phases (any failure exits non-zero before the last line):

1. The card, the torch/CUDA versions and the kernels' build time.
2. Each kernel against its plain torch version on the card, at the shapes
   the main path gives it, bit for bit, with its time, the plain version's
   time, one library call's time where one computes the same function, and
   the least time the card could take (``bound_ms``); K2 and K5 also with
   the grids one call launches, with each radix grid's time at the first
   and last digit (K2's stream, K5's 'hash' tables); K5 also at the rows of
   a 'tiled' call with ``tile=256``, where one shared tile holds 16 rows.
   K8 with its grids a call at each of its three shapes (13 above a tile,
   1 within) and, at one slab × B, each grid's time: the first digit's
   count and scatter, which form the products from the operands, against
   the radix library's grids of digits 1-3, the scans and the totals. K8's
   operation count is a sort's n·log2(n) comparisons of its real lanes;
   bytes set its bound. K1 with its device time (the profiler's) beside
   the events time of back-to-back wrapper calls (``[probe] sccp_multiply
   split``). K7 as its rank entry (``bin_ranks``) and as the 'bucket'
   path's binning entry (``bin_stream``: the layout and drop count, bound
   by 8 bytes a lane read and 8 a slot written) at the planned buckets and
   at the one stream-sized bucket of a call given an ``out_cap`` and no
   plan, each with its grids a call and each grid's time (``[probe]
   bin_stream grids``). K3 in both entries at every shape: grouped by row
   of C
   (``align_product_keys``, the 'search' path's and the warm 'sort' path's
   kernel) with its grids a call and each grid's time (``[probe]
   align_product_keys grids``), and flat (``align_keys``, the streaming
   step's), also on a skewed stream at the same widths (40% of A's slots
   in four rows of C). K4 as its one-launch faithful emission
   (``emit_sorted_unique(faithful=True)``) at the faithful cut's stream
   and cap and at two cuts of the full stream, against the plain loop
   (values, counts, nnz), the batched emission and ``torch.unique``, beside
   the step loop over its mask entry; and as its mask entry at the cut's
   stream, one block's keys (``minima_chunk()``), one more and 2^20 keys,
   with its grids. The planner's sizes
   for the 'bucket' and 'hash' paths are printed first (``[plan]``). Then
   ``make_structure`` for a 'sort' and a 'stream' plan, timed, and K1 and
   K3 held again at the warm phase's own shapes on those structures.
3. The main path through the front door, with the launch counters zeroed
   just before each path and read just after: ``spgemm(a, b, check=True)``
   (``'sort'``), ``spgemm(a, b, accumulator=X, check=True)`` for the other
   five, the faithful Alg. 1 emission (``search_merge(faithful=True)``) on a
   one-column cut of A, and ``spgemm(a, b, structure=st, check=True)`` for
   both structures. The eight full outputs must be bit-identical, hold
   exactly nnz(C) groups, and equal scipy's A @ Aᵀ; a stale structure with
   ``validate=False`` must poison ``ngroups``; the 'stream' call's stages,
   replayed one by one, must give its result, and before its last merge
   that step's ``merge_compact_pair`` (K6's device code, merging and
   compacting in one pass) is held bit for bit against its plain twin,
   ``count`` and ``dropped`` included, timed beside the unfused K6 level
   and compaction on the same inputs; the warm 'stream' call's stages,
   replayed one by one, must give its result too.
4. The end-to-end times with each path's per-call peak memory and the
   stage split; one cold 'stream' call under ``torch.profiler``: the
   device's busy share of its host-clock time and its kernels by device
   time. K6's levels, the stream's merge-and-compact step and K9's shapes
   also print each grid's device time from the profiler
   (``[probe] ... grids``).
4b. Backend selection on bcsstk32 A·Aᵀ and on A cut to its first 1/8 of
   columns times its transpose (``selection_phase``): three rounds of the
   six cold calls beside the cold ``accumulator='auto'`` call, and of each
   backend's planned call; the planned peaks, the model's forms, costs,
   bytes and pick; 'auto' (counters zeroed around it) runs its backend's
   kernels, equals 'sort' bit for bit, and its cold median is within 10% of
   the fastest cold call whose planned peak fits the card's budget; one
   ``StructureCache(autotune=True)`` miss (each candidate's probe µs, the
   winner's probe within 10% of the fastest cold call and its planned
   call within 10% of the fastest planned call, its numeric result equal
   to 'sort'); one 'auto' call with the tracer on (``spgemm.symbolic``,
   ``plan.decision``, ``spgemm.multiply``, ``spgemm.accumulate``; the
   planner ledger); ``measure_roofline``'s ``frac`` in (0, 1.5] for every
   backend. Last, each backend's unit and fixed term through the two
   operands' planned calls (``[fit]``, the form of ``planner.CUDA_COSTS``).
5. The SpMM slice at deepseek-v2-lite's published widths (d_model 2048, 64
   routed experts top-6 with d_ff_expert 1408, 2 shared experts, capacity
   factor 1.25, dense FFN 10944) on a prefill batch of 4 x 1,024 tokens:
   K9 at the MoE dispatch and combine shapes and K10 at the 2:4
   ``SparseMLP``'s fc_in and fc_out shapes, each bit for bit against its
   plain version on integer-valued operands, with the same times and bound
   (K9 also with its grids a call, and on normal float operands: the same
   bits on two calls, within float32 summation order of its plain version
   on the card, and whether it equals that version's bits on the CPU;
   K10's operation bound the smaller of the split-TF32 tensor-core floor
   and the condensed product at the CUDA-core rate; its floor at the FP64
   tensor cores it runs on beside it); beside K10, the time of its probe
   build with one TF32 product in place of the FP64 one
   (``_build.VARIANTS["nm_spmm_one_tf32"]``), and K10's max abs error
   against the float64 product on normal operands of each shape, required
   to be at most 4x that of its plain fp32 twin.
6. The SpMM paths, counters zeroed around each, with per-call peak memory:
   ``moe_apply`` (two K9 calls, eight grids each; routing equal to, and y
   within 1e-4 of max|y| of, the same call on CPU tensors),
   ``SparseMLP(w_in, w_out, 0.5,
   nm=(2, 4))`` (two K10 launches; each layer bit-identical to ``x @ wp``
   with TF32 off), the ELLPACK twin on 8 tokens (bit-identical to the N:M
   route), ``SparseLinear(nm="auto")`` at a 90% global prune (routes to
   ELLPACK), ``matmul_sparse(backend='sort')`` twice (a cache miss, then a
   hit) and once without ``backend=`` on a cache of its own (the planner
   chooses); then three timed calls of the MoE layer and the MLP, and the
   six backends' planned calls on ``matmul_sparse``'s activation operand,
   a shape the cost table was not fitted on (``held_out_selection``: the
   backend ``matmul_sparse`` planned within 10% of the fastest).
6b. The serving engine's SpGEMM lane (``serve_phase``) on bcsstk32 A·Aᵀ
   at A's ELLPACK width: ``ServingEngine(None, None,
   ServeConfig(max_batch=8))`` with ``repro_torch.obs`` enabled (so each
   wave's latency is device time), three patterns of one shape (A, and A
   less 0.5% and 1% of its non-zeros, drawn from ``--seed``: other
   fingerprints, other ``out_cap``s) and the 5,625-column cut (a shape of
   its own). Round 1: 16 requests cycling the patterns plus one on the
   cut, then ``flush_spgemm()``; round 2: 13 more. Every request has fresh
   integer values. The counters zeroed around each round; its misses,
   waves, batched waves and ``spgemm_occupancy_sum`` required exactly;
   each wave's ms, K1 and K3 launches (K1 once a slot) and peak over the
   resident; each miss's ms and each hit's (the fingerprint); every result
   equal to its own ``spgemm_coo_numeric(..., validate=False)`` bit for
   bit, one request of each pattern and the cut's equal to scipy, and
   ``eng.spgemm`` equal to its queued twin; ``eng.stats()``, round 2's
   requests/s.
6c. The hybrid ELLPACK + COO format (``hybrid_phase``) on A = Mᵀ, M
   bcsstk32 as generated, so A's column counts are Table I's row
   statistics: both dense operands (7.54 GiB each) built on the card from
   M's CSR arrays, one at a time; ``split_rows_hybrid`` and
   ``split_cols_hybrid`` at ``ell_width_rule``'s width with the COO cap the
   overflow count rounded up to 1,024 (each COO holding exactly the
   overflow, each ``to_dense()`` equal to its input);
   ``hybrid_spgemm_dense`` (K1 once a call), three calls and each of its
   terms alone, equal to scipy's Mᵀ·M bit for bit (compared on the card,
   4,096 rows at a time) and to ``spgemm_dense`` at the full ELLPACK width,
   whose multiply is timed alone too (the rest of that call is
   ``scatter_dense``; at the hybrid's width it is timed alone).
6d. The distributed SpGEMM (``dist_phase``) on ``make_mesh((4,),
   ("x",))``, four shards of one card (the exchange device-local copies),
   bcsstk32 A·Aᵀ uncut: ``make_dist_plan(n_dev=4)`` timed, its schedule,
   grid, caps and modeled bytes; each of ``'ring'``, ``'cstat'`` and
   ``'summa'`` with overlap on and off (the counters and the collectives'
   moved bytes zeroed around the first call; K1 16 / 16 / 8 launches; the
   median of three calls and the first one's peak over the resident), and
   ``'ring'`` with ``accumulator='stream'``, each bit-identical to the
   single-device ``spgemm(a, b, check=True)``, itself equal to scipy's A @
   Aᵀ; ``make_structure(n_dev=4)`` and the warm ``'ring'`` and
   ``'summa'`` calls (K1, K3) held the same way; a plan with ``bin_cap``
   128 poisons ``ngroups`` and raises under ``check=True``, numeric
   ``'cstat'`` raises ``ValueError``; one traced call (``dist.exchange``,
   ``plan.dist_decision``, ``dist.calls``, ``dist.comm_bytes.ring``); at
   the 5,625-column cut (k 70, padded to 72) each schedule, a batch of two
   with a ``dist_plan`` against each slice's call, and ``ring_spgemm``
   against ``spgemm_dense``: its dense C a shard is 8.1 GB whatever the
   operand, and its ``scatter_dense`` pays the dump-row cost at every
   step, so it runs at the cut only.
6e. Token serving on the LM stack (``lm_phase``): the earlier phases'
   tensors freed first. Gate (b): deepseek-v2-lite cut to its first 2
   layers (layer 0 dense, layer 1 MoE, ``'sort'``) at full width in
   float32, TF32 off, weights drawn on the card and copied to the CPU, on
   2 x 64 tokens: logits within 1e-3·max|logits| of the CPU's, expert ids
   equal but at top-k margins below 1e-5 (none decides a tie across
   devices; counted). Then the whole model at published widths and all 27
   layers, 15,706,484,224 parameters drawn in bfloat16 on the card from a
   ``torch.Generator`` seeded by ``--seed`` (29.3 GiB). Gate (a): prefill
   on 48 tokens of a 96-token prompt, then decode the other 48 one at a
   time: each step's logits within LM_TOL_A·max|logits| of the full forward's
   at its position, at capacity factor E/k so that no MoE call drops a
   pair and the check isolates the caches; two planted decode faults
   (each step's cache entry moved one slot early; RoPE at the position
   before) must each read above that limit. Gate (d): the ``'spmm'``,
   ``'sort'`` and ``'ellpack'`` MoE layers on the model's first MoE layer
   in bfloat16, on 8 x 64 tokens (capacity 60) and on the decode's 8 x 1
   (capacity 1, most pairs dropped), the routed experts' sum within
   LM_TOL_D·max|y| of ``'sort'``'s; ``'spmm'`` with one kept pair dropped
   must read above it. Then two waves through ``ServingEngine(model, params, ServeConfig(max_batch=8,
   max_new_tokens=32, s_max=2112))``, greedy, with the config's
   ``dispatch="sort"``: eight prompts of 64-512 tokens and four of
   1,025-2,048 (the longest 2,048, so the prefill takes
   ``_sdpa_chunked`` in 512-token blocks), lengths and tokens drawn from
   ``--seed``; each wave's prefill ms, decode ms a step, tokens/s, peak
   memory and ``stats()``, every output in range and stopped only at EOS
   or the token limit. The first wave again with ``'sort'`` (the share of
   greedy tokens equal to its first run), then with ``dispatch="spmm"``, its
   counters zeroed just before and read just after: K9's bfloat16 entry
   launched exactly twice a MoE layer a forward (its grids counted), and
   the share of greedy tokens equal to ``'sort'``'s. Gate (c): K9's
   bfloat16 entry against its plain twin at both waves' prefill and
   decode dispatch and combine shapes (dispatch bit for bit, combine
   within one bfloat16 rounding of the float32 sum plus twice its
   summation-order error), timed beside the twin, ``torch.sparse.mm`` of
   the CSR operand and its bytes bound (6 bytes a lane of planes, 2 a
   value of X read and C written).
6f. Training on the LM stack (``train_phase``), the ``[lm]`` weights freed
   first and the resident memory printed. (a) granite-moe-3b-a800m at its
   published widths and all 32 layers (≈3.30e9 parameters), bfloat16
   parameters and compute, the config's ``dispatch="sort"`` and
   ``remat="full"``, through ``repro_torch.launch.train.main`` (8 x 512
   tokens a step, 6 steps, default ``AdamWConfig``, no checkpoint, no
   resume), the counters zeroed around it: each step's loss, grad norm
   and ms, the median of steps 1-5 and tokens/s, the init time and the
   peak memory, all losses and grad norms finite; one more step split
   into forward + backward and the AdamW update (host clock, synchronised).
   (b) The same state with ``dispatch="spmm"`` for TRAIN_B_STEPS steps,
   counters zeroed around them: K9's bfloat16 forward (its grids counted,
   forward and checkpoint recompute) and the ``EllSpmm`` backward; one
   more backward's router and ``w_gate``/``w_up``/``w_down`` grads of
   every layer finite and not all zero, and with K9's output detached (a
   planted fault) that gate must fail. (c) A 2-layer cut at published
   widths, float32, TF32 off, 2 x 128 tokens: one loss and backward from
   the same weights on the card and the CPU, for ``'sort'`` and
   ``'spmm'``: the loss within 1e-5 relative, each grad within
   1e-3·max|g_cpu|. (d) The cut in bfloat16 through ``Trainer``, 30 steps
   at lr 3e-3, warmup 5, 8 x 64 tokens: the last logged loss below the
   first by more than 0.2 (the reference's bar). (e) The cut saved at step
   4 (``keep_n=1``) and resumed by a fresh ``Trainer``: every restored
   leaf equal to the saved one bit for bit, bfloat16 included, the history
   starting at step 4; save and restore ms and the checkpoint's bytes.
   (f) K9 at granite's training dispatch and combine (bfloat16, against
   its twin as in gate (c) of 6e); K9's training route (``ops.ell_spmm``)
   against the plain twin's autograd at (6, 4096) x (4096, 2048) -> 30,720
   rows with dead lanes, dX and dval bit for bit on integer operands and
   within one bfloat16 rounding of the float32 gradients in bfloat16, the
   backward timed; K10's bfloat16 entry at fc_in (4096, 2048) x 2:4
   (1024, 10944) within 2⁻⁸·max|y32| of its float32 result and within
   2⁻⁷·max|y_plain| (two bfloat16 roundings) of the plain twin's bfloat16
   result, timed beside its twin and ``x @ wp`` in bfloat16.
6g. The SSM, RG-LRU and encoder-decoder families (``families_phase``),
   the ``[train]`` phase's tensors freed first and the resident memory
   printed; no hand-written kernel lies on these paths (their scans are
   ``models.common.linear_scan`` in torch ops), and each path's counters
   are zeroed just before it and read just after. For each of
   falcon-mamba-7b, recurrentgemma-9b and whisper-medium in turn (built,
   checked, freed): gates (b) and (c) on a cut at full width in float32,
   TF32 off, weights drawn on the card and copied to the CPU (falcon-mamba
   2 layers on 2 x 128 tokens, recurrentgemma one (rec, rec, local) unit on
   1 x 64, whisper 2 + 2 layers on 1 x 64 over 1,500 frames): the
   prefill's logits and 8 teacher-forced decode steps' within
   1e-3·max|CPU|, the loss within 1e-5 relative and, for falcon-mamba and
   whisper, every leaf's gradient within 1e-3·max|g_cpu| (recurrentgemma's
   cut holds the loss alone: its untied 256,000-row embedding and
   unembedding would put ≈22 GB of float32 weights and gradients on the
   host). Then the whole model at published widths and all layers,
   bfloat16, drawn on the card from ``--seed`` (7,272,665,088,
   10,444,771,328 and 758,395,904 parameters). Gate (a): prefill P tokens,
   decode 32 more, each step's logits within LM_TOL_A·max|logits| of the
   full forward's at its position (falcon-mamba P 512, full forward 768;
   recurrentgemma 2,560 and 3,072, past its 2,048-token window; whisper 32
   and 64 over one encoder output); one planted fault must read above the
   limit (falcon-mamba: the SSM states zeroed after the prefill;
   recurrentgemma: the RG-LRU states ``h`` zeroed; whisper: the decode
   position one behind). falcon-mamba is gated with its mixers at the
   unstacked scale and Mamba's published A and Δ (``mamba_long_memory``;
   under the reference's init its SSM state keeps ~3% a step and no
   fault in it shows), its readings on the reference's init printed
   beside. Serving: the two decoder families through
   ``ServingEngine.generate_batch`` (greedy, ``max_new_tokens=32``) in
   two waves, eight prompts of 64-512 tokens (the longest 512) and two of
   2,049-4,096 (the longest 4,096: recurrentgemma's local attention past
   its window in prefill and in the decode's ring), lengths and tokens
   from ``--seed``; whisper through ``Model.prefill`` /
   ``Model.decode_step`` (the engine serves tokens only, as the
   reference's), eight prompts of 32 tokens over (8, 1500, 1024) frames,
   then 32 greedy steps, ``s_max`` 448. Each wave's prefill ms, decode ms
   a step, tokens/s and peak; every token in the vocabulary. Training in
   bfloat16, ``remat="full"``, 4 steps each: whisper at full depth
   through ``launch.train.main`` (8 x 256 tokens, frames from its
   ``extra_batch_fn``), falcon-mamba cut to 16 layers and recurrentgemma
   to 6 (two units) through ``runtime.Trainer`` (4 x 512 tokens, default
   ``AdamWConfig``): each step's loss, grad norm and ms, tokens/s and
   peak, all finite. The phase's seconds.
6h. The dry run held against the card (``dryrun_phase``), the
   ``[families]`` phase's tensors freed first: granite-moe-3b-a800m at its
   published widths and all 32 layers, bfloat16, one train step of the
   ``[train]`` phase's 8 x 512 tokens on ``launch.mesh.make_host_mesh()``
   (1, 1), first with the config's ``dispatch="sort"``, then
   ``"spmm"``. For each: ``launch.dryrun.analyze_cell`` traces the step on
   meta tensors; parameters (drawn from ``--seed``), AdamW state and the
   batch are put on the card once. Gate (a): the dry run's
   ``argument_bytes`` equals what ``torch.cuda.memory_allocated()`` gained
   for them, within the caching allocator's 512-byte rounding a tensor,
   and equals the allocator's requested bytes (sizes before rounding)
   exactly. One real step runs
   under ``launch.op_analysis.analyze``, the counters zeroed just before it
   and read just after. Gate (b), on ``'sort'``: its FLOPs equal the meta
   count exactly. One more step is timed (host clock, synchronised) after
   ``reset_peak_memory_stats``. Gate (c), on ``'sort'``: the meta
   ``peak_live_bytes`` within DRY_TOL_PEAK of that step's
   ``max_memory_allocated()`` over what was resident before the
   arguments, and its part beyond ``argument_bytes`` (saved activations,
   gradients, temporaries) within DRY_TOL_PEAK of the card's part beyond
   the arguments' allocation: the arguments are most of the peak, so the
   whole peak alone would pass a tracker that counted only them. The step's ms and achieved TFLOP/s (counted FLOPs over the
   step's time) are printed beside, and on ``'spmm'`` K9's launches are
   required and its FLOPs and peak printed, not gated (the meta trace
   takes K9's plain twin). The phase's seconds.
6i. The LM under a mesh (``mesh_phase``), the ``[dryrun]`` phase's
   tensors freed first, on ``launch.mesh.make_host_mesh`` over four
   shards (the cards where the machine has four, else ``cuda:0`` four
   times; the phase says which). Gate (a): granite-moe-3b-a800m at its
   published widths cut to TRAIN_CUT layers, float32, TF32 off, 2 x 128
   tokens (two token groups): ``Model.loss`` and every gradient under a
   (2, 2) mesh (the experts split over ``"model"``: offsets, ``psum``)
   against a (2, 1) mesh (the same groups, nothing split), and against
   the same (2, 2) mesh on CPU devices, within MESH_TOL_A (loss
   relative, each grad against its max). Gate (b): each of two planted
   faults, every shard combining from expert 0 (``e_off = 0``) and no
   ``psum``, must break gate (a). Gate (d):
   the cut's loss under ``'spmm'`` on (2, 2), K9 launched once a group
   (its grids counted exactly, the counters zeroed just before and read
   just after), within MESH_TOL_A of ``'ellpack'``'s on the same mesh
   (``'sort'``'s printed beside: its aux loss is the data shards' mean).
   Gate (e): deepseek-v2-lite-16b, all 27 layers, bfloat16, a wave of 8
   requests through ``launch.serve.main(..., devices=...)`` at
   ``--model-parallel`` 4 (the partitioned program): prefill ms, decode
   ms a step, tokens/s, peak and ``moved_bytes()``. Then the partitioned
   serving program (``mesh_serving``), on meshes of the same shards.
   Serving (a): 2-layer float32 cuts of deepseek-v2-lite-16b (MLA, MoE
   ``'sort'``), mistral-large-123b (GQA, 8 kv heads) and qwen2-0.5b (14
   heads, the flat split inside a head, tied vocab of 151,936), TF32 off,
   MESH_PART_A's prompts, tokens and greedy steps, the weights placed
   (``Model.place``) on (1, 4) and (2, 2): the prefill's and every
   step's logits within MESH_PART_TOL of their max of the same calls on
   whole weights under the same rules (which group the MoE tokens alike),
   and the greedy tokens equal. Serving (b): each coordinate's weight and
   cache block bytes equal the dry run's per-device argument bytes of the
   same config, mesh and shapes (``launch.steps.abstract_decode_args`` on
   a meta mesh); at full width the bytes requested from the allocator
   after placement, the whole tree dropped, equal the placed blocks'
   storages exactly (``memory_allocated`` beside it, with its rounding):
   no whole copy is left beyond the replicated leaves. Serving (c):
   deepseek-v2-lite-16b, all 27 layers, on (1, 4) and (2, 2), and
   mistral-large-123b, 8 of its 88 layers at full width, on (1, 4) and
   (1, 16) (8 kv heads over 16 shards: each shard's from a gathered flat
   dim), bfloat16, one wave of MESH_PART_WAVE's prompts through
   ``generate_batch``: prefill ms, decode ms a step, tokens/s, peak,
   ``moved_bytes()`` and ``parallel.mesh.collectives()``, the counters
   zeroed just before the wave, required equal to the dry run's count of
   the same prefill and that many decode steps
   (``launch.dryrun.collective_trace``). Serving (d): dropping the
   program's second reduce and writing each decode token's cache entries
   on the next shard must each break serving (a) on qwen2-0.5b's (1, 4).
   Then the partitioned training step (``mesh_train_cuts``,
   ``mesh_train``), the weights placed on meshes of the same shards.
   Training (a): 2-layer float32 cuts, TF32 off, MESH_TRAIN_TOKENS, one
   step of ``launch.steps.make_train_step`` on placed weights (the loss
   and every gradient from one backward through the collectives' duals,
   ``sharding.leaf_grads``, then the ZeRO-1 update) against the same
   step on whole weights under the same rules: granite-moe-3b-a800m with
   ``'sort'``, ``'spmm'`` and ``'ellpack'`` on (1, 4) and (2, 2),
   deepseek-v2-lite-16b (MLA, shared experts) and qwen2-0.5b (tied
   vocab, a flat split inside a head) on (1, 4); the loss, every
   gradient and both moments within MESH_TRAIN_TOL (of their max), the
   params within MESH_TRAIN_PARAM_TOL where the gradient's sign is sure
   and two steps' size elsewhere. Each of two planted faults on granite
   ``'sort'``'s (2, 2), every all-gather's backward keeping its own
   block (no sum over the group) and the moments one ``opt_shard`` block
   off, must break it. Training (b): a placed forward of the ``'spmm'``
   cut on (2, 2) with K9's wrapper recording: every coordinate's
   dispatch and combine planes held bit for bit against the plain twin on
   integer operands, and K9's grids, counted from zero just before the
   forward, equal to coordinates x MoE layers x each call's grids.
   Training (c): granite-moe-3b-a800m, all 32 layers, bfloat16,
   MESH_TRAIN's steps of 8 x 512 through ``launch.train.main(...,
   devices=...)``, partitioned, with ``'sort'`` then ``'spmm'``
   (MESH_TRAIN_RUNS: ``--model-parallel`` 2 and 4, (2, 2) and (1, 4),
   40 experts split either way), then the hidden-dim split
   (MESH_HIDDEN: (1, 16), 40 % 16 != 0, 512 % 16 = 0) through
   ``runtime.Trainer`` under the mesh: losses finite and falling, ms a
   step, tokens/s, peak, ``moved_bytes()``, and the live
   ``collectives()``, zeroed just before each run, equal kind by kind to
   the steps times the dry run's meta trace of one step at the same
   shapes (``launch.dryrun.collective_trace``, traced in two worker
   processes beside the card's work); ``'spmm'`` launches K9's grids
   more than once and at most twice a forward (the remat's recompute),
   and K9 at one coordinate's recorded dispatch and combine planes joins
   the kernels line, bit for bit on integer bfloat16 operands and timed.
   Training (d): the cut's placed params and moments after a step on (2,
   2), saved (``CheckpointManager``, the reference's format) and
   restored onto (1, 4) and whole, bit for bit: save and restore ms.
   Then the SSM, RG-LRU and encoder-decoder families' partitioned
   programs (``mesh_families``), on meshes of the same shards. Families
   (a): falcon-mamba-7b, recurrentgemma-9b and whisper-medium cut to
   FAM_CUT's layers at full width, float32, TF32 off, placed on (1, 4)
   and (2, 2) against whole weights under the same rules: MESH_FAM_A's
   prompts (recurrentgemma also MESH_FAM_LONG's, past its 2,048-slot
   window) and MESH_FAM_STEPS greedy steps within MESH_PART_TOL, tokens
   equal; one training step as training (a) holds it; Mamba's ``w_x``
   partial sums used without their all-reduce, and the ring's slots
   rolled within each shard, must each break it; whisper's cut saved on
   (2, 2) and restored onto (1, 4), bit for bit. Families (b): all
   layers, bfloat16, on (1, 4): falcon-mamba-7b and recurrentgemma-9b
   through ``ServingEngine.generate_batch`` (MESH_FAM_WAVES, recurrentgemma
   also 2 prompts past its window), whisper-medium through
   ``Model.prefill``/``decode_step`` (MESH_FAM_AUDIO): prefill ms, decode
   ms a step, tokens/s, peak, ``moved_bytes()``, live collectives equal
   to the dry run's of the same calls (traced in the worker processes).
   Families (c): bfloat16, MESH_FAM_TRAIN_STEPS steps, falcon-mamba-7b
   and recurrentgemma-9b cut to MESH_FAM_TRAIN's layers through
   ``runtime.Trainer`` on (1, 4), whisper-medium whole through
   ``launch.train.main(..., devices=...)`` on (1, 4) and (2, 2): ms a
   step, tokens/s, peak, ``moved_bytes()``, live collectives equal to the
   steps times the dry run's. The phase's seconds.
7. A ``kernels`` JSON line (all ten kernels, K3 as its two entries, K9 with
   its bfloat16, training and partitioned training shapes, K10 with its
   bfloat16 entry), the
   card's name and power limit, and as the last line ``{"ok": true,
   "device": {...}}``.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import math
import multiprocessing
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# Table I row 3 of the paper, as in benchmarks/common.py:
# (id, name, dim, nnz, nnz_av, sigma)
BCSSTK32 = (3, "bcsstk32", 45_000, 2_000_000, 45.2, 15.48)

ACCUMULATORS = ("sort", "search", "tiled", "bucket", "hash", "stream")
# the kernels each accumulator's cold path launches on CUDA operands
BACKEND_KERNELS = {
    "sort": ("sccp_multiply",),
    "search": ("sccp_multiply", "emit_sort", "align_product_keys"),
    "tiled": ("sccp_multiply", "sort_tiles", "merge_runs"),
    "bucket": ("sccp_multiply", "bin_ranks", "sort_tiles"),
    "hash": ("sccp_multiply", "sort_tiles"),
    "stream": ("fused_slab_sort", "merge_runs"),
}
# the selection phase's second operand: A cut to its first 1/CUT_PART columns
# (the contraction), times its transpose
CUT_PART = 8

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and the CUDA-core fp32
# rate, the table's nearest entry for the int32 compares these kernels do.
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12  # dense TF32 tensor-core rate
FP64_TC_OPS_PER_S = 67e12  # dense FP64 tensor-core rate
RADIX_TILE = 4096        # kernels/radix_sort.py TILE: longer rows are segmented
SHORT_ROW = 256          # a 'tiled' call's tile=, 16 rows a radix tile


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# The operand: benchmarks/common.py's generator for one Table-I row
# ---------------------------------------------------------------------------

def draw_row_counts(dim: int, nnz: int, sigma: float, rng) -> np.ndarray:
    counts = rng.normal(nnz / dim, sigma, size=dim)
    counts = np.clip(np.round(counts), 0, dim).astype(np.int64)
    diff = nnz - counts.sum()
    idx = rng.integers(0, dim, size=abs(int(diff)))
    np.add.at(counts, idx, 1 if diff > 0 else -1)
    return np.clip(counts, 0, dim)


def table1_matrix(row, seed: int):
    """scipy CSR of one Table-I matrix: the sparsity pattern of
    ``benchmarks.common.build_scipy(bench_matrices()[mid - 1])``, with
    integer values in [-4, 4] \\ {0} drawn from ``seed``."""
    import scipy.sparse as sp
    mid, _, dim, nnz, _, sigma = row
    counts = draw_row_counts(dim, nnz, sigma, np.random.default_rng(1000 + mid))
    rng = np.random.default_rng(2000 + mid)
    indptr = np.zeros(dim + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = np.empty(indptr[-1], np.int32)
    for r in range(dim):
        lo, hi = indptr[r], indptr[r + 1]
        k = hi - lo
        if k:
            indices[lo:hi] = rng.choice(dim, size=k, replace=False) \
                if k < dim // 4 else rng.permutation(dim)[:k]
    vals = np.random.default_rng(seed)
    data = (vals.integers(1, 5, indptr[-1])
            * vals.choice(np.array([-1, 1]), indptr[-1])).astype(np.float32)
    return sp.csr_matrix((data, indices, indptr), shape=(dim, dim))


# ---------------------------------------------------------------------------
# Measurement helpers
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def timed_ms(fn):
    """``fn()`` and its host-clock ms, synchronised before and after."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the core rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def same(name: str, got, want) -> float:
    """Require bit-identical tensors; returns max |got - want| (0.0)."""
    import torch
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{name}: {got.dtype}{tuple(got.shape)} vs "
            f"{want.dtype}{tuple(want.shape)}")
    require(torch.equal(got, want), f"{name}: kernel disagrees with plain")
    if got.dtype == torch.bool:
        return 0.0
    return float((got.double() - want.double()).abs().max()) if got.numel() \
        else 0.0


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def held_pair(name: str, kernel, plain, library, shape: str, n_bytes: float,
              n_ops: float, reps=(3, 2, 3)) -> dict:
    """Hold ``kernel()`` against ``plain()`` bit for bit (every output of a
    tuple), then time the kernel, the plain version and ``library`` (None
    where no one library call computes the same function), each over its
    count of ``reps``. Returns the shape's entry, also printed as a
    ``[kernel]`` line."""
    import torch
    got, want = kernel(), plain()
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err = max(same(f"{name}[{i}] {shape}", g, w)
              for i, (g, w) in enumerate(zip(got, want)))
    del got, want
    t, by = bound(n_bytes, n_ops)
    r = dict(shape=shape, max_abs_err=err, ms=cuda_ms(kernel, reps[0]),
             plain_ms=cuda_ms(plain, reps[1]),
             library_ms=None if library is None else cuda_ms(library,
                                                             reps[2]),
             bound_ms=t, bound_by=by)
    print(f"[kernel] {name} {shape}: bit-identical, {json.dumps(r)}",
          flush=True)
    return r


def profile_ms(fn, reps: int = 3):
    """Device ms a call of each kernel that ``fn`` launches, by kernel name,
    from ``torch.profiler`` (CUDA activity) over ``reps`` calls after one
    warm-up, and the host-clock ms a call of the profiled window (the
    profiler's own cost included); ({}, ms) where it records no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0) or getattr(
            e, "cuda_time_total", 0)
        if t > 0:            # the kernel's own name, no scope or arguments
            name = e.key.removeprefix("void ").replace(
                "(anonymous namespace)::", "")
            name = re.split(r"[<(]", name)[0].split("::")[-1]
            out[name] = out.get(name, 0.0) + t / reps / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1])), wall


def grid_ms(name: str, shape: str, fn) -> dict:
    """Each grid's device ms in one call of ``fn`` (``profile_ms``),
    printed as a ``[probe]`` line."""
    ms, _ = profile_ms(fn)
    print(f"[probe] {name} grids, {shape}: {json.dumps(ms)}", flush=True)
    return ms


def grids_of(wrapper, fn) -> int:
    """The grids one call of ``fn`` launches, read from ``wrapper``'s
    launch counter."""
    import torch
    before = wrapper.launches
    fn()
    torch.cuda.synchronize()
    return wrapper.launches - before


def radix_grid_ms(key, val, row: int) -> dict:
    """Device ms of each grid of one segmented radix pass
    (``csrc/radix_sort.cuh``) at the first and the last digit, as
    ``radix_sort.sort_rows`` launches them on ``key`` (and ``val``) in rows
    of ``row``: the count, the in-place scan (timed on restored copies of
    the counts, the copy's time taken off) and the scatter into scratch."""
    import torch
    from repro_torch.kernels import radix_sort as rs
    _, fns = rs._entries()
    stream = torch.cuda.current_stream().cuda_stream
    n = key.numel()
    g = rs.geometry(n, row)
    counts = torch.empty(g.counts, dtype=torch.int32, device=key.device)
    k_out = torch.empty_like(key)
    v_out = None if val is None else torch.empty_like(val)
    ptr = (lambda t: None if t is None else t.data_ptr())
    out = {}
    for shift in (rs.SHIFTS[0], rs.SHIFTS[-1]):
        geo = (n, row, g.blocks_per_row, g.tiles_per_block, shift)
        count = (lambda: fns["radix_upsweep"](key.data_ptr(),
                                              counts.data_ptr(), *geo,
                                              stream))
        out[f"count_{shift}"] = cuda_ms(count, 5)
        raw = counts.clone()
        restore = (lambda: counts.copy_(raw))
        scan = (lambda: (restore(), fns["radix_scan"](
            counts.data_ptr(), g.rows, g.blocks_per_row, stream)))
        out[f"scan_{shift}"] = cuda_ms(scan, 5) - cuda_ms(restore, 5)
        scan()
        out[f"scatter_{shift}"] = cuda_ms(lambda: fns["radix_downsweep"](
            key.data_ptr(), ptr(val), k_out.data_ptr(), ptr(v_out),
            counts.data_ptr(), *geo, stream), 5)
    torch.cuda.synchronize()
    print(f"[probe] radix grids, rows of {row} over {n}"
          f"{'' if val is None else ' with values'}: "
          f"{json.dumps(out)}", flush=True)
    return out


def device_split(name: str, shape: str, fn, reps: int = 20) -> dict:
    """A wrapper's kernel time split from its call time: the device ms a
    call of the kernels ``fn`` launches (``profile_ms``) beside the events
    ms a call over ``reps`` back-to-back calls (``cuda_ms``, which also
    holds the host's share where the host sets the pace), printed as a
    ``[probe]`` line."""
    events = cuda_ms(fn, reps)
    kern, wall = profile_ms(fn, reps=reps)
    r = dict(device_ms=sum(kern.values()), events_ms=events,
             profiled_host_ms=wall, kernels_ms=kern)
    print(f"[probe] {name} split, {shape}: {json.dumps(r)}", flush=True)
    return r


def kernel_row(name: str, source: str, replaces: str, shapes: list,
               **extra) -> dict:
    """A ``kernels`` line entry: the first shape's numbers, and all shapes."""
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                **shapes[0], shapes=shapes, **extra)


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version at the main path's shapes
# ---------------------------------------------------------------------------

def align_shape(shape: str, pk, uk) -> dict:
    """K3 held against its plain version on product keys ``pk`` and the
    ascending unique keys ``uk``; ``torch.searchsorted`` is the library
    call. The bound reads each product key and writes its slot and hit;
    of ``uk`` it counts at most one key a product key, since fewer product
    keys than unique keys need not read all of them."""
    import torch
    from repro_torch.kernels import insitu_search as isr
    s, u = pk.numel(), uk.numel()
    return held_pair("align_keys", lambda: isr.align_keys(pk, uk),
                     lambda: isr.align_keys_plain(pk, uk),
                     lambda: torch.searchsorted(uk, pk, out_int32=True),
                     shape, 9 * s + 4 * min(u, s),
                     s * math.ceil(math.log2(u + 1)))


def align_grouped_shape(shape: str, pk, uk, row, n_rows: int,
                        n_cols: int) -> dict:
    """K3 grouped by row of C (``align_product_keys``) held against its
    plain version on the product keys ``pk`` of SCCP's row plane ``row``
    (each group's row taken as ``ops.align_products`` takes it), with its
    grids a call and each grid's time (``[probe]``). The bound is the flat
    entry's bytes; its operations count a search of one row's share of
    ``uk`` a key."""
    import torch
    from repro_torch.kernels import insitu_search as isr
    group_row = row[:, :, 0].contiguous()
    k_b = row.shape[2]
    s, u = pk.numel(), uk.numel()

    def grouped():
        return isr.align_product_keys(pk, uk, group_row, k_b=k_b,
                                      n_rows=n_rows, n_cols=n_cols)

    r = held_pair("align_product_keys", grouped,
                  lambda: isr.align_keys_plain(pk, uk),
                  lambda: torch.searchsorted(uk, pk, out_int32=True),
                  shape, 9 * s + 4 * min(u, s),
                  s * math.ceil(math.log2(u / max(n_rows, 1) + 1)))
    r["grids"] = grids_of(isr.align_product_keys, grouped)
    r["grid_ms"] = grid_ms("align_product_keys", shape, grouped)
    return r


def skewed_stream(k_a: int, n: int, k_b: int, n_rows: int, n_cols: int, *,
                  device, heavy: float = 0.4, seed: int = 7):
    """A product stream at SCCP's (k_a, n, k_b) widths whose rows of C are
    skewed, as a few dense rows make them: a share ``heavy`` of A's slots
    fall in rows 0-3, the rest spread evenly, every B slot valid. Returns
    the packed keys, SCCP's row plane (broadcast) and the ascending unique
    keys."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    a_idx = torch.randint(0, n_rows, (k_a, n), generator=g, device=device,
                          dtype=torch.int32)
    a_idx = torch.where(torch.rand((k_a, n), generator=g, device=device)
                        < heavy, a_idx % 4, a_idx)
    b_idx = torch.randint(0, n_cols, (n, k_b), generator=g, device=device,
                          dtype=torch.int32)
    pk = (a_idx[:, :, None] * n_cols + b_idx[None]).reshape(-1)
    return pk, a_idx[:, :, None].expand(k_a, n, k_b), torch.unique(pk)


def faithful_cap(a_cut, b_cut) -> int:
    """The faithful cut's out_cap: its products, rounded up to 128."""
    import repro_torch
    return max(128, -(-int(repro_torch.count_products(a_cut, b_cut))
                      // 128) * 128)


def minima_mask_shape(v) -> dict:
    """K4's mask entry on ``v``, bit for bit against its plain version,
    with its grids a call and its device time beside its call time. Bound:
    5 bytes a key (read once, a mask byte written once); 31 bit steps a key
    beside."""
    from repro_torch.kernels import insitu_search as isr
    n = v.numel()
    r = held_pair("minima_mask", lambda: isr.minima_mask(v),
                  lambda: isr.minima_mask_plain(v), None, f"mask ({n},)",
                  5 * n, 31 * n, reps=(20, 20, 20))
    r["grids"] = grids_of(isr.minima_mask, lambda: isr.minima_mask(v))
    r["split"] = device_split("minima_mask", r["shape"],
                              lambda: isr.minima_mask(v))
    return r


def emission_shape(key, cap: int, what: str) -> dict:
    """K4's emission entry (``emit_sorted_unique(faithful=True)``, the
    faithful path's call) on ``key`` at ``cap``: ``faithful_emit``'s values,
    counts and nnz bit for bit against the plain loop, the path's call's uk
    and nnz against the batched emission (on the stream padded to a power of
    two with dead lanes), the caller's keys unchanged, one launch a call up
    to a block's keys. Timed beside ``torch.unique(key, sorted=True)``
    (``library_ms``), the plain loop (``plain_ms``), the step loop over the
    mask entry (``loop_ms``) and the call with counts (``counts_ms``,
    ``search_emit_sorted``). Bound: the keys read once and ``cap`` slots written, 4
    bytes each; a sort's n·log2(n) compares beside."""
    import torch
    from repro_torch.kernels import insitu_search as isr
    n = key.numel()
    kept = key.clone()
    want = isr.faithful_emit_plain(key, cap)
    got = isr.faithful_emit(key, cap)
    err = max(same(f"faithful_emit[{i}] {what}", g, w)
              for i, (g, w) in enumerate(zip(got, want)))
    path = (lambda: isr.emit_sorted_unique(key, cap, faithful=True))
    launches = grids_of(isr.minima_mask, path)
    require(launches == 1 or n > isr.minima_chunk(),
            f"faithful emission {what}: {launches} launches, not 1")
    uk_f, nnz_f = path()
    same(f"faithful emission uk {what}", uk_f, want[0])
    same(f"faithful emission nnz {what}", nnz_f, want[2])
    pad = key.new_full((isr.next_pot(n) - n,), isr.KEY_INVALID)
    uk_b, nnz_b = isr.emit_sorted_unique(torch.cat([key, pad]), cap)
    same(f"faithful vs batched uk {what}", uk_f, uk_b)
    nf, nb = int(nnz_f), int(nnz_b)
    require(nf == nb if nb <= cap else (nf == cap + 1 and nb > cap),
            f"faithful nnz {nf} vs batched {nb} at cap {cap}")
    same(f"faithful emission keys unchanged {what}", key, kept)
    t, by = bound(4 * n + 4 * cap, n * math.log2(max(n, 2)))
    r = dict(shape=f"emission {what}", max_abs_err=err,
             ms=cuda_ms(path, 20),
             plain_ms=cuda_ms(lambda: isr.faithful_emit_plain(key, cap), 1),
             library_ms=cuda_ms(lambda: torch.unique(key, sorted=True), 20),
             bound_ms=t, bound_by=by, grids=launches, emitted=min(nb, cap),
             loop_ms=cuda_ms(lambda: isr._emit_loop(key, cap,
                                                    isr.minima_mask), 1),
             counts_ms=cuda_ms(lambda: isr.search_emit_sorted(key, cap), 20))
    print(f"[kernel] minima emission {what}: bit-identical to the plain "
          f"loop, uk == batched, nnz {nf} / {nb}, {json.dumps(r)}",
          flush=True)
    return r


def check_minima(key, v_cut, cap: int) -> dict:
    """K4's row: the emission at the faithful cut's shape first (the main
    path's one launch; its library call ``torch.unique``), with its device
    time beside its call time, then at 512 keys cap 512 and 4,096 keys cap
    256 of the full stream; the mask entry at the cut's stream, at one
    block's keys, one more, and 2^20 keys."""
    from repro_torch.kernels import insitu_search as isr
    n_cut = v_cut.numel()
    shapes = [emission_shape(v_cut, cap, f"({n_cut},) cap {cap}")]
    shapes[0]["split"] = device_split(
        "minima emission", shapes[0]["shape"],
        lambda: isr.emit_sorted_unique(v_cut, cap, faithful=True))
    for lanes, c in ((512, 512), (4096, 256)):
        shapes.append(emission_shape(key[:lanes].contiguous(), c,
                                     f"({lanes},) cap {c}"))
    c = isr.minima_chunk()
    shapes += [minima_mask_shape(v) for v in
               (v_cut, key[:c].contiguous(), key[:c + 1].contiguous(),
                key[:1 << 20].contiguous())]
    return kernel_row("minima_mask", "src/repro_torch/csrc/insitu_search.cu",
                      "src/repro/kernels/insitu_search.py:46", shapes)


def check_kernels(a, b, a_cut, b_cut) -> list:
    import torch
    from repro_torch.kernels import insitu_search as isr
    from repro_torch.kernels import ops
    from repro_torch.kernels import sccp_multiply as k1
    rows = []

    # K1: SCCP multiply, (k_a, n) x (n, k_b)
    args = (a.val, a.idx, b.val, b.idx)
    k_a, n = a.val.shape
    k_b = b.val.shape[1]
    lanes = k_a * n * k_b
    mul = held_pair(
        "sccp_multiply", lambda: k1.sccp_multiply(*args),
        lambda: k1.sccp_multiply_plain(*args), None,
        f"({k_a},{n})x({n},{k_b})", 8 * (k_a * n + n * k_b) + 12 * lanes,
        lanes)
    mul["split"] = device_split("sccp_multiply", mul["shape"],
                                lambda: k1.sccp_multiply(*args), reps=5)
    rows.append(kernel_row("sccp_multiply",
                           "src/repro_torch/csrc/sccp_multiply.cu",
                           "src/repro/kernels/sccp_multiply.py:29", [mul]))

    # K2: emission sort of the main path's packed key stream
    val, row, col = k1.sccp_multiply(*args)
    key, _ = ops._packed_stream(row, col, val, a.n_rows, b.n_cols)
    del val, col
    torch.cuda.empty_cache()
    s = key.numel()
    emit = held_pair("emit_sort", lambda: isr.emit_sort_keys(key),
                     lambda: isr.emit_sort_keys_plain(key),
                     lambda: torch.sort(key), f"({s},)", 8 * s,
                     s * math.log2(s))
    emit["grids"] = grids_of(isr.emit_sort_keys,
                             lambda: isr.emit_sort_keys(key))
    if s > RADIX_TILE:
        emit["grid_ms"] = radix_grid_ms(key, None, s)
    rows.append(kernel_row("emit_sort", "src/repro_torch/csrc/insitu_search.cu",
                           "src/repro/kernels/insitu_search.py:164", [emit]))

    # K3: align every product key against the sorted unique keys, grouped
    # by row of C as the 'search' path does, and the flat kernel beside it
    ks = isr.emit_sort_keys(key)
    n_unique = int(isr._unique_heads(ks, 1)[1])
    uk, _ = isr._unique_heads(ks, max(128, -(-n_unique // 128) * 128))
    del ks
    shape = f"search: ({s},) in ({uk.numel()},), {n_unique} unique"
    rows.append(kernel_row(
        "align_product_keys", "src/repro_torch/csrc/insitu_search.cu",
        "src/repro/kernels/insitu_search.py:268",
        [align_grouped_shape(shape, key, uk, row, a.n_rows, b.n_cols)]))
    rows.append(kernel_row(
        "align_keys", "src/repro_torch/csrc/insitu_search.cu",
        "src/repro/kernels/insitu_search.py:268",
        [align_shape(shape, key, uk)]))
    del uk, row

    # K3 on a skewed product stream at the same widths, both entries
    pk, row, uk = skewed_stream(k_a, n, k_b, a.n_rows, b.n_cols,
                                device=key.device)
    shape = (f"skewed: ({pk.numel()},) in ({uk.numel()},), 40% of A's "
             f"slots in 4 rows of C")
    rows[-2]["shapes"].append(align_grouped_shape(shape, pk, uk, row,
                                                  a.n_rows, b.n_cols))
    rows[-1]["shapes"].append(align_shape(shape, pk, uk))
    del pk, row, uk
    torch.cuda.empty_cache()

    # K4: the minima scan's two entries on the faithful path's stream (the
    # packed stream of its one-column cut) and on cuts of the full stream
    val, row, col = k1.sccp_multiply(a_cut.val, a_cut.idx, b_cut.val,
                                     b_cut.idx)
    v_cut, _ = ops._packed_stream(row, col, val, a_cut.n_rows, b_cut.n_cols)
    del val, row, col
    rows.append(check_minima(key, v_cut, faithful_cap(a_cut, b_cut)))
    del key
    torch.cuda.empty_cache()
    return rows


def plan_sizes(a, b, nnz_c: int):
    """The planner's blocking sizes for this operand, with the histogram
    maxima they come from; printed as the ``[plan]`` line."""
    from repro_torch.plan.planner import make_plan
    from repro_torch.plan.symbolic import per_row_counts
    plan = make_plan(a, b, backend="hash")
    prod, uniq = (x.cpu().numpy() for x in per_row_counts(a, b))
    rpb = -(-a.n_rows // plan.n_buckets)

    def largest(per_row):
        return int(np.pad(per_row, (0, plan.n_buckets * rpb - a.n_rows))
                   .reshape(plan.n_buckets, rpb).sum(axis=1).max())

    lanes = a.k * a.n_cols * b.k
    pot = 1 << (lanes - 1).bit_length()
    info = dict(lanes=lanes, stream_pot=pot, n_buckets=plan.n_buckets,
                rows_per_bucket=rpb, largest_bucket_products=largest(prod),
                bucket_cap=plan.bucket_cap,
                bucket_lanes=plan.n_buckets * plan.bucket_cap,
                n_blocks=plan.n_blocks, largest_block_uniques=largest(uniq),
                block_cap=plan.block_cap,
                table_slots=plan.n_blocks * plan.block_cap,
                largest_block_load=largest(uniq) / plan.block_cap,
                table_load=nnz_c / (plan.n_blocks * plan.block_cap),
                tiled_tile=plan.tile,
                tiled_merge_levels=(pot // plan.tile).bit_length() - 1,
                out_cap=plan.out_cap)
    print(f"[plan] {json.dumps(info)}", flush=True)
    return plan


def check_accumulator_kernels(a, b, plan) -> list:
    """K5 (row sort), K6 (merge level) and K7 (bucket rank) against their
    plain versions at the shapes the 'tiled', 'bucket' and 'hash' paths give
    them: K5 at 4,096-lane rows over the packed stream, at ``bucket_cap``
    rows over the binned buckets and at ``block_cap`` rows over the hash
    tables; K6 at the merge tree's first and last level; K7 over every
    lane's bucket id (``bin_ranks``) and as the 'bucket' path's binning
    entry (``bin_stream``: layout and drop count) at the planned buckets
    and at the one stream-sized bucket of a call given an ``out_cap`` and
    no plan, each with its grids a call and each grid's time."""
    import torch
    from repro_torch.core.sccp import sccp_multiply
    from repro_torch.kernels import bitonic_merge as bm
    from repro_torch.kernels import hash_accum as ha
    from repro_torch.kernels import ops
    from repro_torch.kernels import radix_bucket as rb

    val, row, col = sccp_multiply(a, b)
    key, v = ops._packed_stream(row, col, val, a.n_rows, b.n_cols)
    del val, row, col
    torch.cuda.empty_cache()
    n = key.numel()
    kpb = rb.bucket_bounds(a.n_rows, b.n_cols, plan.n_buckets)

    def sort_shape(what, k, w, tile):
        r = held_pair("sort_tiles", lambda: bm.sort_tiles(k, w, tile=tile),
                      lambda: bm.sort_tiles_plain(k, w, tile=tile),
                      lambda: torch.sort(k.view(-1, tile), dim=1),
                      f"{what}: rows of {tile} over {k.numel()}",
                      16 * k.numel(), k.numel() * (tile.bit_length() - 1))
        r["grids"] = grids_of(bm.sort_tiles,
                              lambda: bm.sort_tiles(k, w, tile=tile))
        return r

    # K5 at its three main-path shapes, then at 'tiled''s rows with
    # tile=SHORT_ROW, where one shared tile holds many rows
    shapes = [sort_shape("tiled", key, v, plan.tile)]
    bk, bv, _ = rb.bin_stream(key, v, n_buckets=plan.n_buckets,
                              bucket_cap=plan.bucket_cap, keys_per_bucket=kpb)
    shapes.append(sort_shape("bucket", bk, bv, plan.bucket_cap))
    del bk, bv
    tk, tv, _ = ha.hash_tables(key, v, n_blocks=plan.n_blocks,
                               block_cap=plan.block_cap, keys_per_block=kpb)
    shapes.append(sort_shape("hash", tk, tv, plan.block_cap))
    if plan.block_cap > RADIX_TILE:
        shapes[-1]["grid_ms"] = radix_grid_ms(tk, tv, plan.block_cap)
    del tk, tv
    torch.cuda.empty_cache()
    shapes.append(sort_shape(f"tiled, tile={SHORT_ROW}", key, v, SHORT_ROW))

    # K6 at the merge tree's first and last level; the whole tree's time
    def merge_level(k, w, run):
        return held_pair("merge_runs", lambda: bm.merge_runs(k, w, run=run),
                    lambda: bm.merge_runs_plain(k, w, run=run),
                    lambda: torch.sort(k.view(-1, 2 * run), dim=1),
                    f"level run={run} over {k.numel()}", 16 * k.numel(),
                    k.numel() // 2 * ((2 * run).bit_length() - 1))

    k1, t1 = bm.sort_tiles(key, v, tile=plan.tile)
    levels = [merge_level(k1, t1, plan.tile)]
    run = plan.tile
    levels[0]["grid_ms"] = grid_ms("merge_runs", f"run={run}", lambda: (
        bm.merge_runs(k1, t1, run=plan.tile)))
    while run < n // 2:
        k1, t1 = bm.merge_runs(k1, t1, run=run)
        run *= 2
    levels.append(merge_level(k1, t1, run))
    levels[-1]["grid_ms"] = grid_ms("merge_runs", f"run={run}", lambda: (
        bm.merge_runs(k1, t1, run=run)))
    del k1, t1
    torch.cuda.empty_cache()
    tree_ms = cuda_ms(lambda: bm.sort_merge_tree(key, v, tile=plan.tile), 2)
    print(f"[kernel] merge tree (K5 + {(n // plan.tile).bit_length() - 1} "
          f"K6 levels) over {n}: {tree_ms:.3f} ms", flush=True)

    # K7 over every lane's bucket id (rank only), then the binning entry at
    # the planned buckets and at the one stream-sized bucket that a call
    # given an out_cap and no plan bins into (ops.bucket_merge, no sizes)
    bid = torch.where(key != ops.KEY_INVALID, key // kpb, -1).clamp(
        max=plan.n_buckets - 1).to(torch.int32)
    rank = held_pair(
        "bin_ranks", lambda: rb.bin_ranks(bid, n_buckets=plan.n_buckets),
        lambda: rb.bin_ranks_plain(bid, n_buckets=plan.n_buckets), None,
        f"({n},) ids of {plan.n_buckets} buckets", 8 * n, n)
    rank["grids"] = grids_of(rb.bin_ranks, lambda: rb.bin_ranks(
        bid, n_buckets=plan.n_buckets))
    rank["grid_ms"] = grid_ms("bin_ranks", rank["shape"], lambda: (
        rb.bin_ranks(bid, n_buckets=plan.n_buckets)))
    del bid
    torch.cuda.empty_cache()
    binning = [rank]
    for nb, cap in ((plan.n_buckets, plan.bucket_cap), (1, n)):
        kw = dict(n_buckets=nb, bucket_cap=cap,
                  keys_per_bucket=rb.bucket_bounds(a.n_rows, b.n_cols, nb))
        r = held_pair("bin_stream", lambda: rb.bin_stream(key, v, **kw),
                      lambda: rb.bin_stream_plain(key, v, **kw), None,
                      f"({n},) into {nb} x {cap}",
                      8 * n + 8 * nb * cap, n)
        r["grids"] = grids_of(rb.bin_ranks,
                              lambda: rb.bin_stream(key, v, **kw))
        r["grid_ms"] = grid_ms("bin_stream", r["shape"],
                               lambda: rb.bin_stream(key, v, **kw))
        binning.append(r)
        torch.cuda.empty_cache()
    del key, v
    torch.cuda.empty_cache()

    src = "src/repro_torch/csrc/bitonic_merge.cu"
    return [
        kernel_row("sort_tiles", src, "src/repro/kernels/bitonic_merge.py:151",
                   shapes),
        kernel_row("merge_runs", src, "src/repro/kernels/bitonic_merge.py:162",
                   levels, tree_ms=tree_ms),
        kernel_row("bin_ranks", "src/repro_torch/csrc/radix_bucket.cu",
                   "src/repro/kernels/radix_bucket.py:49", binning),
    ]


def k8_grid_ms(args, n_cols: int) -> dict:
    """Device ms of each grid of one K8 step above a tile, as
    ``fused_slab_sort`` launches them: the first digit's count and scatter,
    which form the lanes from the operands, then each of digits 1-3's count
    and scatter through the radix library, each digit's scan (timed on
    restored copies of the counts, the copy's time taken off), and the
    totals."""
    import torch
    from repro_torch.kernels import bitonic_merge as bm
    from repro_torch.kernels import fused_sccp_stream as k8
    from repro_torch.kernels import radix_sort as rs
    from repro_torch.kernels.insitu_search import next_pot
    group, n, k_b = k8._shapes(*args)
    lanes = group * n * k_b
    pot, m = next_pot(lanes), k8.sorted_lanes(lanes)
    g = rs.span_geometry(m)
    dev = args[0].device
    key = torch.empty(pot, dtype=torch.int32, device=dev)
    tot = torch.empty(pot, dtype=torch.float32, device=dev)
    bufs = [(torch.empty(m, dtype=torch.int32, device=dev),
             torch.empty(m, dtype=torch.float32, device=dev)),
            (key[:m], tot[:m])]
    v_out = torch.empty(m, dtype=torch.float32, device=dev)
    counts = torch.empty(g.counts, dtype=torch.int32, device=dev)
    slab = tuple(t.data_ptr() for t in args) + (group, n, k_b, n_cols)
    first = k8.FirstDigit(slab, key, m)
    _, fns = rs._entries()
    stream = torch.cuda.current_stream().cuda_stream
    geo = (m, m, g.blocks_per_row, g.tiles_per_block)
    raw = counts.clone()

    def scan_ms():
        """The scan's time; leaves the scanned offsets in ``counts``."""
        restore = (lambda: counts.copy_(raw))
        scan = (lambda: (restore(), fns["radix_scan"](
            counts.data_ptr(), 1, g.blocks_per_row, stream)))
        ms = cuda_ms(scan, 5) - cuda_ms(restore, 5)
        scan()
        return ms

    out = {"count_0": cuda_ms(lambda: first.upsweep(counts, g, 0, stream), 5)}
    raw.copy_(counts)
    out["scan_0"] = scan_ms()
    src = bufs[0]
    out["scatter_0"] = cuda_ms(lambda: first.downsweep(
        counts, src[0], src[1], g, 0, stream), 5)
    for p, shift in enumerate(rs.SHIFTS[1:], 1):
        dst = bufs[p % 2] if p < 3 else (key[:m], v_out)
        out[f"count_{shift}"] = cuda_ms(lambda: fns["radix_upsweep"](
            src[0].data_ptr(), counts.data_ptr(), *geo, shift, stream), 5)
        raw.copy_(counts)
        out[f"scan_{shift}"] = scan_ms()
        out[f"scatter_{shift}"] = cuda_ms(lambda: fns["radix_downsweep"](
            src[0].data_ptr(), src[1].data_ptr(), dst[0].data_ptr(),
            dst[1].data_ptr(), counts.data_ptr(), *geo, shift, stream), 5)
        src = dst
    out["totals"] = cuda_ms(lambda: bm.seg_totals(
        k8.fused_slab_sort, key, v_out, tot, pot), 5)
    torch.cuda.synchronize()
    print(f"[probe] fused_slab_sort grids, {lanes} lanes sorted as {m} of "
          f"{pot}: {json.dumps(out)}", flush=True)
    return out


def check_stream_kernel(a, b) -> dict:
    """K8 (fused slab multiply + radix sort) against its plain version at
    the shapes the 'stream' path gives it or can: one A slab times all of B
    (the planner's group of 1 on this operand), a slab of at most 4,096
    lanes (one shared-memory residency, one grid) and a block of two slabs
    (group > 1). Each entry holds the grids one call launches; the one-slab
    entry also each grid's time (``k8_grid_ms``). The bound: the operands
    read once and 8 B a padded lane written; the operations, a sort's
    n·log2(n) comparisons of the real lanes, stay below it."""
    import torch
    from repro_torch.kernels import fused_sccp_stream as k8
    k_b = b.val.shape[1]
    n_small = 4096 // k_b
    cases = [
        ("one A slab x B", a.val[0], a.idx[0], b.val, b.idx),
        ("slab cut to one tile", a.val[0, :n_small].contiguous(),
         a.idx[0, :n_small].contiguous(), b.val[:n_small].contiguous(),
         b.idx[:n_small].contiguous()),
        ("group of 2 slabs", a.val[:2], a.idx[:2], b.val, b.idx),
    ]
    shapes = []
    for what, *args in cases:
        key = k8.fused_slab_sort(*args, n_cols=b.n_cols)[0]
        require(bool((key[1:] >= key[:-1]).all()),
                f"fused_slab_sort ({what}): keys not ascending")
        pot = key.numel()
        del key
        packed, _ = k8._pack_tile(*args, b.n_cols, pot)
        lanes = args[0].numel() * k_b
        shapes.append(held_pair(
            "fused_slab_sort",
            lambda: k8.fused_slab_sort(*args, n_cols=b.n_cols),
            lambda: k8.fused_slab_sort_plain(*args, n_cols=b.n_cols),
            lambda: torch.sort(packed),
            f"{what}: a {tuple(args[0].shape)} x b {tuple(args[2].shape)} "
            f"-> {pot} lanes",
            8 * (args[0].numel() + args[2].numel()) + 8 * pot,
            lanes * math.log2(max(lanes, 2))))
        shapes[-1]["grids"] = grids_of(k8.fused_slab_sort, lambda: (
            k8.fused_slab_sort(*args, n_cols=b.n_cols)))
        if what == "one A slab x B":
            shapes[-1]["grid_ms"] = k8_grid_ms(args, b.n_cols)
        del packed
    require([s["grids"] for s in shapes] == [13, 1, 13],
            f"fused_slab_sort grids {[s['grids'] for s in shapes]}, "
            "expected 13 above a tile and 1 within")
    torch.cuda.empty_cache()
    return kernel_row("fused_slab_sort",
                      "src/repro_torch/csrc/fused_sccp_stream.cu",
                      "src/repro/kernels/fused_sccp_stream.py:58", shapes)


def check_numeric_kernels(a, b, structures, rows) -> None:
    """K1 and K3 at the warm phase's own shapes, each added to its kernel's
    row as a further shape: K1 on one slab group of A times all of B (one
    step of the 'stream' structure's numeric loop), with its device time
    split from its call time; K3 on that step's packed product keys against
    the 'stream' structure's keys (the flat kernel the loop runs, first in
    its row, and the grouped one beside it), and on the 'sort' structure's
    path: every packed product key of the full stream (dead lanes packed as
    0) against the structure's KEY_INVALID-padded keys (the grouped kernel
    the path runs, and the flat one beside it)."""
    import torch
    from repro_torch.core.spgemm import _product_keys
    from repro_torch.core.streaming import _slab_groups
    from repro_torch.kernels import sccp_multiply as k1
    by_name = {r["name"]: r for r in rows}
    grp = max(1, min(structures["stream"].plan.stream_group, a.k))
    a_val, a_idx, _ = _slab_groups(a, grp)
    args = (a_val[:grp], a_idx[:grp], b.val, b.idx)
    n, k_b = b.val.shape
    lanes = grp * n * k_b
    step = held_pair(
        "sccp_multiply", lambda: k1.sccp_multiply(*args),
        lambda: k1.sccp_multiply_plain(*args), None,
        f"numeric step: ({grp},{n})x({n},{k_b})",
        8 * (grp * n + n * k_b) + 12 * lanes, lanes)
    step["split"] = device_split("sccp_multiply", step["shape"],
                                 lambda: k1.sccp_multiply(*args))
    by_name["sccp_multiply"]["shapes"].append(step)
    for what, st, mul_args in (("numeric step", structures["stream"], args),
                               ("numeric", structures["sort"],
                                (a.val, a.idx, b.val, b.idx))):
        val, row, col = k1.sccp_multiply(*mul_args)
        _, pk = _product_keys(row, col, b.n_cols)
        del val, col
        shape = (f"{what} ({st.plan.backend} structure): ({pk.numel()},) "
                 f"in ({st.key.numel()},)")
        flat = align_shape(shape, pk, st.key)
        by_name["align_product_keys"]["shapes"].append(align_grouped_shape(
            shape, pk, st.key, row, st.n_rows, st.n_cols))
        if what == "numeric step":       # the loop's own kernel: first
            by_name["align_keys"]["shapes"].insert(0, flat)
            by_name["align_keys"].update(flat)
        else:
            by_name["align_keys"]["shapes"].append(flat)
        del pk, row
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------

def drive_paths(a, b, a_cut, b_cut, structures):
    """Each path with the launch counters zeroed just before and read just
    after: the six accumulators, the faithful cut, and the warm numeric
    phase on each of ``structures`` ({backend: SpgemmStructure}). Returns
    ({path: counts}, {path: (coo, seconds)})."""
    import torch
    import repro_torch
    from repro_torch import kernels
    from repro_torch.core.sccp import sccp_multiply
    from repro_torch.core.spgemm import _coo_from_slots

    def faithful():
        val, row, col = sccp_multiply(a_cut, b_cut)
        cap = faithful_cap(a_cut, b_cut)
        uk, sums, nnz = kernels.ops.search_merge(
            row, col, val, a_cut.n_rows, b_cut.n_cols, out_cap=cap,
            faithful=True)
        return _coo_from_slots(uk, sums, nnz, out_cap=cap,
                               n_rows=a_cut.n_rows, n_cols=b_cut.n_cols)

    paths = {
        "sort": lambda: repro_torch.spgemm(a, b, check=True),
        "search": lambda: repro_torch.spgemm(a, b, accumulator="search",
                                             check=True),
        "search_faithful_cut": faithful,
    }
    for acc in ACCUMULATORS[2:]:
        paths[acc] = (lambda acc=acc: repro_torch.spgemm(
            a, b, accumulator=acc, check=True))
    for backend, st in structures.items():
        paths[f"numeric_{backend}"] = (lambda st=st: repro_torch.spgemm(
            a, b, structure=st, check=True))
    counts, out = {}, {}
    for name, fn in paths.items():
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        coo = fn()
        torch.cuda.synchronize()
        out[name] = (coo, time.perf_counter() - t0)
        counts[name] = kernels.launch_counts()
        print(f"[path] {name}: {out[name][1] * 1e3:.1f} ms, launches "
              f"{counts[name]}", flush=True)
    return counts, out


def stage_ms(a, b) -> dict:
    """Host-clock ms of each stage of one cold call, each synchronised: the
    symbolic out_cap pass (and the planner's, which 'bucket' and 'hash' pay
    instead), the SCCP multiply, each accumulation, and the torch parts of
    'bucket' and 'hash' before their table sort (the binning, the probe
    loop)."""
    from repro_torch.core.sccp import sccp_multiply
    from repro_torch.core.spgemm import accumulate_stream
    from repro_torch.kernels import hash_accum, ops, radix_bucket
    from repro_torch.plan.planner import make_plan
    from repro_torch.plan.symbolic import out_cap_auto

    cap, t_sym = timed_ms(lambda: out_cap_auto(a, b))
    plan, t_plan = timed_ms(lambda: make_plan(a, b, backend="bucket"))
    (val, row, col), t_mul = timed_ms(lambda: sccp_multiply(a, b))
    st = {"symbolic_out_cap": t_sym, "make_plan": t_plan,
          "sccp_multiply": t_mul}
    for acc in ACCUMULATORS:
        _, st[f"accumulate_{acc}"] = timed_ms(lambda: accumulate_stream(
            row, col, val, cap, a.n_rows, b.n_cols, backend=acc, plan=plan))
    (key, v), st["pack_stream"] = timed_ms(lambda: ops._packed_stream(
        row, col, val, a.n_rows, b.n_cols))
    del val, row, col
    kpb = radix_bucket.bucket_bounds(a.n_rows, b.n_cols, plan.n_buckets)
    _, st["bucket_bin_stream"] = timed_ms(lambda: radix_bucket.bin_stream(
        key, v, n_buckets=plan.n_buckets, bucket_cap=plan.bucket_cap,
        keys_per_bucket=kpb))
    _, st["hash_tables"] = timed_ms(lambda: hash_accum.hash_tables(
        key, v, n_blocks=plan.n_blocks, block_cap=plan.block_cap,
        keys_per_block=kpb))
    return st


def compact_shape(state, tile, steps: int) -> dict:
    """The stream's merge-and-compact step (``merge_compact_pair``, K6's
    device code) held bit for bit against its plain twin on one real step's
    inputs, the buffer ``state`` and the compacted ``tile``, with its
    counts; beside it the same step unfused, as the parent ran it
    (``merge_coalesce_pair``, one K6 level over the full 2·buf_cap lanes,
    then ``coalesce_compact``). Bound: bytes, each valid lane of both lists
    read once (8 B) and every output lane written once (8 B); the kernel
    reads the valid counts on the device and no lane past them.
    ``full_width_bound_ms`` counts both lists in full."""
    import torch
    from repro_torch.kernels import bitonic_merge as bm
    key, tot, count, _ = tile
    cap = state.key.numel()
    live = int(state.count) + int(count)
    r = held_pair(
        "merge_compact_pair",
        lambda: bm.merge_compact_pair(state.key, state.tot, key, tot,
                                      cap=cap, n_a=state.count, n_b=count),
        lambda: bm.merge_compact_pair_plain(state.key, state.tot, key, tot,
                                            cap=cap),
        None, f"stream step {steps}: {cap} + {cap} lanes ({int(state.count)}"
        f" + {int(count)} valid) -> {cap}", 8 * live + 8 * cap, live)
    r["grids"] = grids_of(bm.merge_runs, lambda: bm.merge_compact_pair(
        state.key, state.tot, key, tot, cap=cap, n_a=state.count, n_b=count))

    def unfused():
        mk, mt = bm.merge_coalesce_pair(state.key, state.tot, key, tot)
        return bm.coalesce_compact(mk, mt, cap)

    r["unfused_ms"] = cuda_ms(unfused, 2)
    r["grid_ms"] = grid_ms("merge_compact_pair", f"step {steps}", lambda: (
        bm.merge_compact_pair(state.key, state.tot, key, tot, cap=cap,
                              n_a=state.count, n_b=count)))
    r["full_width_bound_ms"] = bound(16 * cap + 8 * cap, 0)[0]
    torch.cuda.empty_cache()
    print(f"[kernel] merge_compact_pair unfused (K6 level + compaction): "
          f"{r['unfused_ms']:.3f} ms, fused {r['ms']:.3f} ms, "
          f"{r['grids']} grids", flush=True)
    return r


def stream_stage_ms(a, b, want):
    """Host-clock ms of one cold 'stream' call's stages, each synchronised:
    the planner, then K8 and the two halves of ``streaming.absorb_sorted``
    summed over the steps (the tile's compaction; the buffer's merge and
    compaction, one ``merge_compact_pair``), and the final unpack. The staged
    call's result must equal ``want`` bit for bit. Before the last step's
    merge, that step is held as ``merge_compact_pair``'s shape
    (``compact_shape``). Returns (stage ms, the shape)."""
    from repro_torch.core import streaming as st
    from repro_torch.kernels import ops
    from repro_torch.plan.planner import make_plan

    plan, t_plan = timed_ms(lambda: make_plan(a, b, backend="stream"))
    a_val, a_idx, n_groups = st._slab_groups(a, plan.stream_group)
    state = st.stream_init(st.buffer_cap(plan.out_cap), a.val.dtype,
                           a.val.device)
    buf_cap = state.key.numel()
    ms = dict(stream_make_plan=t_plan, stream_fused_slab_sort=0.0,
              stream_compact_tile=0.0, stream_merge_tile=0.0)
    shape = None
    for g in range(n_groups):
        sl = slice(g * plan.stream_group, (g + 1) * plan.stream_group)
        (key, tot), t = timed_ms(lambda: ops.fused_slab_sort(
            a_val[sl], a_idx[sl], b.val, b.idx, n_cols=b.n_cols))
        ms["stream_fused_slab_sort"] += t
        tile, t = timed_ms(lambda: st._compact_tile(
            key, tot, stream_cap=plan.stream_cap, buf_cap=buf_cap))
        ms["stream_compact_tile"] += t
        del key, tot
        if g == n_groups - 1:
            shape = compact_shape(state, tile, n_groups)
        state, t = timed_ms(lambda: st._merge_tile(state, *tile))
        ms["stream_merge_tile"] += t
        del tile
    coo, ms["stream_finalize"] = timed_ms(lambda: st.finalize(
        state, plan.out_cap, a.n_rows, b.n_cols))
    for f in ("row", "col", "val", "ngroups"):
        same(f"staged stream vs path .{f}", getattr(coo, f), getattr(want, f))
    sizes = dict(steps=n_groups, stream_group=plan.stream_group,
                 stream_cap=plan.stream_cap, buf_cap=buf_cap,
                 out_cap=plan.out_cap, merge_lanes=2 * buf_cap)
    print(f"[stream] {json.dumps(sizes)}", flush=True)
    return ms, shape


def numeric_stream_stage_ms(a, b, st, want) -> dict:
    """Host-clock ms of the warm phase's stages on a 'stream' structure
    (``structure.validate``, the sparsity fingerprint the warm call checks
    first, then ``spgemm._numeric_stream`` step by step), each synchronised
    and summed over the slab-group steps: K1 on the group, the packed
    product keys, K3, the slot sum (``index_add_``) with the miss count,
    then the COO dressing; beside them the same loop with one
    synchronisation at its end (``numeric_stream_loop_unsynced``), which
    shows what the per-stage synchronisations and the host's launches cost.
    The staged result must equal ``want`` bit for bit."""
    import torch
    from repro_torch.core import spgemm as sp
    from repro_torch.core.formats import EllRows
    from repro_torch.core.sccp import sccp_multiply
    from repro_torch.core.streaming import _slab_groups
    from repro_torch.kernels.insitu_search import align_keys

    grp = max(1, min(st.plan.stream_group, a.k))
    _, t_validate = timed_ms(lambda: st.validate(a, b))
    a_val, a_idx, n_groups = _slab_groups(a, grp)
    ms = dict.fromkeys(("numeric_stream_sccp_multiply",
                        "numeric_stream_pack_keys",
                        "numeric_stream_align_keys",
                        "numeric_stream_slot_sum"), 0.0)
    ms["numeric_stream_validate"] = t_validate
    sums, ms["numeric_stream_init"] = timed_ms(lambda: sp._slot_sums_init(
        st.out_cap, a.val.dtype, a.val.device))
    n_miss = torch.zeros((), dtype=torch.int32, device=a.val.device)
    for g in range(n_groups):
        sl = slice(g * grp, (g + 1) * grp)
        (val, row, col), t = timed_ms(lambda: sccp_multiply(
            EllRows(val=a_val[sl], idx=a_idx[sl], n_rows=a.n_rows), b))
        ms["numeric_stream_sccp_multiply"] += t
        (valid, pk), t = timed_ms(lambda: sp._product_keys(row, col,
                                                           st.n_cols))
        ms["numeric_stream_pack_keys"] += t
        (slot, hit), t = timed_ms(lambda: align_keys(pk, st.key))
        ms["numeric_stream_align_keys"] += t

        def slot_sum():
            h = hit & valid
            sums.index_add_(0, sp._slot_index(slot, h, st.out_cap),
                            torch.where(valid, val.reshape(-1), 0))
            return (valid & ~h).sum(dtype=torch.int32)

        miss, t = timed_ms(slot_sum)
        n_miss += miss
        ms["numeric_stream_slot_sum"] += t
    coo, ms["numeric_stream_dress"] = timed_ms(lambda: sp._poison_overflow(
        sp._coo_from_slots(st.key, sums[:st.out_cap], st.nnz,
                           out_cap=st.out_cap, n_rows=st.n_rows,
                           n_cols=st.n_cols), n_miss))
    for f in ("row", "col", "val", "ngroups"):
        same(f"staged numeric stream vs path .{f}", getattr(coo, f),
             getattr(want, f))
    _, ms["numeric_stream_loop_unsynced"] = timed_ms(
        lambda: sp._numeric_stream(a, b, st.key, st.nnz, out_cap=st.out_cap,
                                   n_rows=st.n_rows, n_cols=st.n_cols,
                                   group=grp))
    print(f"[numeric] 'stream' structure: {n_groups} steps of {grp} slab(s)",
          flush=True)
    return ms


def numeric_stage_ms(a, b, st) -> dict:
    """Host-clock ms of the warm phase's stages on a 'sort' structure
    (``spgemm._slot_sums`` step by step), each synchronised: K1, the packed
    product keys, K3 grouped by row of C (``ops.align_products``, as the
    path runs it), the slot sum as the path runs it (dead and missing
    lanes spread over the dump slots) and, for comparison, the same sum
    with every such lane sent to one dump slot, and over the valid lanes
    only (their selection included)."""
    import torch
    from repro_torch.core import spgemm as sp
    from repro_torch.core.sccp import sccp_multiply
    from repro_torch.kernels import ops

    ms = {}
    (val, row, col), ms["numeric_sccp_multiply"] = timed_ms(
        lambda: sccp_multiply(a, b))
    (valid, pk), ms["numeric_pack_keys"] = timed_ms(
        lambda: sp._product_keys(row, col, st.n_cols))
    del col
    val = torch.where(valid, val.reshape(-1), 0)
    (slot, hit), ms["numeric_align_keys"] = timed_ms(
        lambda: ops.align_products(pk, st.key, row, st.n_rows, st.n_cols))
    del row
    hit &= valid

    def slot_sum():
        sums = sp._slot_sums_init(st.out_cap, val.dtype, val.device)
        return sums.index_add_(0, sp._slot_index(slot, hit, st.out_cap), val)

    def one_dump_slot():
        sums = sp._slot_sums_init(st.out_cap, val.dtype, val.device)
        return sums.index_add_(0, torch.where(hit, slot, st.out_cap), val)

    def valid_sum():
        sel = torch.nonzero(hit).squeeze(1)
        sums = sp._slot_sums_init(st.out_cap, val.dtype, val.device)
        return sums.index_add_(0, slot[sel], val[sel])

    want, ms["numeric_index_add_spread_dump"] = timed_ms(slot_sum)
    for name, fn in (("numeric_index_add_one_dump_slot", one_dump_slot),
                     ("numeric_index_add_valid_lanes", valid_sum)):
        got, ms[name] = timed_ms(fn)
        same(f"slot sums ({name})", got[:st.out_cap], want[:st.out_cap])
    print(f"[numeric] {int(valid.sum())} valid of {valid.numel()} lanes",
          flush=True)
    return ms


def coo_to_scipy(coo):
    import scipy.sparse as sp
    import torch
    ok = coo.row >= 0
    r, c, v = (t[ok].cpu().numpy() for t in (coo.row, coo.col, coo.val))
    return sp.csr_matrix((v.astype(np.float64), (r, c)), shape=coo.shape)


def check_against_scipy(name: str, coo, c_ref, nnz_ref: int) -> None:
    import torch
    require(int(coo.ngroups) == nnz_ref,
            f"{name}: ngroups {int(coo.ngroups)} != nnz(C) {nnz_ref}")
    ok = coo.row >= 0
    require(int(ok.sum()) == nnz_ref, f"{name}: {int(ok.sum())} valid slots")
    key = coo.row[ok].long() * coo.shape[1] + coo.col[ok].long()
    require(bool((key[1:] > key[:-1]).all()),
            f"{name}: coordinates not strictly ascending")
    diff = coo_to_scipy(coo) - c_ref
    diff.eliminate_zeros()
    require(diff.nnz == 0, f"{name}: {diff.nnz} entries differ from scipy")


# ---------------------------------------------------------------------------
# Phase 4b: backend selection ('auto', autotune) with the tracer
# ---------------------------------------------------------------------------

def median(xs):
    return sorted(xs)[len(xs) // 2]


def selection_phase(name: str, a, b):
    """'auto' on one operand pair beside the six accumulators. Returns
    ({path: launch counts}, the summary, also printed as ``[select]``).

    Three rounds, in turns: the six cold calls and the cold 'auto' call
    (``out_cap="auto"``), then each backend's planned call
    (``spgemm(a, b, plan=p)``, what 'auto' runs after planning and what the
    CUDA cost table is fitted on); each backend's planned peak; the model's
    forms (``planner.FORMS``), costs, bytes and pick. Then 'auto' with the
    counters zeroed around it (the chosen backend's kernels must run, its
    result equal 'sort' bit for bit), one autotuned ``StructureCache`` miss
    (the winner's numeric result equal 'sort' too), one 'auto' call with the
    tracer on (its spans and the planner ledger) and ``measure_roofline``'s
    ``frac`` for each backend."""
    import torch
    import repro_torch
    from repro_torch import kernels, obs
    from repro_torch.obs import roofline
    from repro_torch.plan import planner

    budget = planner.default_mem_budget(a.idx.device)
    plans = {bk: planner.make_plan(a, b, backend=bk) for bk in ACCUMULATORS}
    auto = planner.make_plan(a, b)
    forms, interm = planner.plan_costs(auto, a.k, a.n_cols, b.k,
                                       planner.FORMS)
    calls = {k: (lambda k=k: repro_torch.spgemm(a, b, accumulator=k))
             for k in (*ACCUMULATORS, "auto")}
    cold = {k: [] for k in calls}
    planned = {bk: [] for bk in ACCUMULATORS}
    for _ in range(3):
        for k, fn in calls.items():
            cold[k].append(timed_ms(fn)[1])
        for bk, p in plans.items():
            planned[bk].append(
                timed_ms(lambda p=p: repro_torch.spgemm(a, b, plan=p))[1])
    peak = {bk: peak_of(lambda p=p: repro_torch.spgemm(a, b, plan=p))[1]
            for bk, p in plans.items()}
    fits = [bk for bk in ACCUMULATORS
            if peak[bk]["call_gib"] * 2**30 <= budget]
    require(fits, f"{name}: no backend's planned peak fits {budget} B")
    best = min(fits, key=lambda bk: median(cold[bk]))
    fastest_planned = min(ACCUMULATORS, key=lambda bk: median(planned[bk]))

    # 'auto' runs the chosen backend's kernels and equals 'sort'
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    c_auto = repro_torch.spgemm(a, b, accumulator="auto", check=True)
    torch.cuda.synchronize()
    counts = {f"auto_{name}": kernels.launch_counts()}
    for kname in BACKEND_KERNELS[auto.backend]:
        require(counts[f"auto_{name}"][kname] > 0,
                f"{name}: 'auto' ({auto.backend}) skipped {kname}")
    c_sort = repro_torch.spgemm(a, b, check=True)
    for f in ("row", "col", "val", "ngroups"):
        same(f"{name} auto vs sort .{f}", getattr(c_auto, f),
             getattr(c_sort, f))
    del c_auto

    # one autotuned miss: every candidate probed on the card
    cache = repro_torch.StructureCache(autotune=True)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    st, tune_ms = timed_ms(lambda: cache.get(a, b))
    counts[f"autotune_{name}"] = kernels.launch_counts()
    probe_us = st.plan.est["autotune_us"]
    winner = st.plan.backend
    require(set(probe_us) == set(ACCUMULATORS) and winner in ACCUMULATORS
            and cache.stats()["autotuned"] == 1,
            f"{name}: autotune {probe_us}, {cache.stats()}")
    for bk in ACCUMULATORS:
        for kname in BACKEND_KERNELS[bk]:
            require(counts[f"autotune_{name}"][kname] > 0,
                    f"{name}: autotune's {bk} probe skipped {kname}")
    c_tuned = repro_torch.spgemm(a, b, structure=st, check=True)
    for f in ("row", "col", "val", "ngroups"):
        same(f"{name} autotuned numeric vs sort .{f}", getattr(c_tuned, f),
             getattr(c_sort, f))
    del c_tuned, c_sort, st, cache

    # one 'auto' call with the tracer on
    obs.enable(reset=True)
    try:
        repro_torch.spgemm(a, b, accumulator="auto")
    finally:
        obs.disable()
    events = obs.get_tracer().snapshot()["events"]
    need = {"spgemm.symbolic", "plan.decision", "spgemm.accumulate"}
    if auto.backend != "stream":       # 'stream' fuses its own multiply
        need.add("spgemm.multiply")
    require(need <= {e["name"] for e in events},
            f"{name}: traced 'auto' call recorded "
            f"{sorted({e['name'] for e in events})}")
    spans = [(e["name"], e["dur_us"]) for e in events
             if e["ph"] == "X" and e["depth"] <= 1]
    ledger = obs.metrics.snapshot()["planner"]
    obs.reset()

    rl = roofline.measure_roofline(a, b, plan=auto, iters=1)
    obs.reset()
    for bk, r in rl.items():
        require(0.0 < r["frac"] <= 1.5,
                f"{name}: roofline frac {r['frac']} for {bk}")
    costs, _ = planner.plan_costs(auto, a.k, a.n_cols, b.k,
                                  planner.cost_table(a.idx.device))
    summary = dict(
        operand=name, chosen=auto.backend, mem_budget=budget,
        stats=dataclasses.asdict(auto.stats),
        sizes={f: getattr(auto, f) for f in (
            "out_cap", "tile", "stream_cap", "stream_group", "n_buckets",
            "bucket_cap", "n_blocks", "block_cap")},
        k_a=a.k, n=a.n_cols, k_b=b.k,
        cost=costs, forms=forms, interm=interm, cold_ms=cold,
        planned_ms=planned, planned_peak=peak,
        peak_over_interm={bk: peak[bk]["call_gib"] * 2**30 / interm[bk]
                          for bk in ACCUMULATORS},
        fastest_cold_under_budget=best, fastest_planned=fastest_planned,
        autotune_us=probe_us, autotune_winner=winner,
        autotune_miss_ms=tune_ms, traced_spans_us=spans,
        planner_ledger=ledger,
        roofline={bk: {k: r[k] for k in ("us", "modeled_bytes", "frac")}
                  for bk, r in rl.items()},
        ref_bw=next(iter(rl.values()))["ref_bw"])
    print(f"[select] {name}: 'auto' chose {auto.backend} (cold median "
          f"{median(cold['auto']):.1f} ms; fastest cold under the budget "
          f"{best} {median(cold[best]):.1f}; fastest planned "
          f"{fastest_planned} {median(planned[fastest_planned]):.1f}); "
          f"autotune winner {winner} {probe_us[winner] / 1e3:.1f} ms; "
          f"'auto' == sort bit for bit; roofline frac "
          f"{ {bk: round(r['frac'], 4) for bk, r in rl.items()} }",
          flush=True)
    print(f"[select] {json.dumps(summary)}", flush=True)
    return counts, summary


def check_selection(s: dict) -> None:
    """The timing gates of one ``selection_phase``, after its numbers and
    the fit are printed: the cold 'auto' median within 10% of the fastest
    cold call whose planned peak fits the budget; the autotune winner's
    probe within 10% of the fastest cold call; and the winner's own planned
    median within 10% of the fastest planned median. The probe is a planned
    call, so it sits far under any cold call (which adds the symbolic
    pass); the last gate compares like with like and is the one a wrong
    winner fails."""
    cold, planned, name = s["cold_ms"], s["planned_ms"], s["operand"]
    best = s["fastest_cold_under_budget"]
    require(median(cold["auto"]) <= 1.10 * median(cold[best]),
            f"{name}: 'auto' ({s['chosen']}) cold "
            f"{median(cold['auto']):.1f} ms > 1.1 x {best}'s "
            f"{median(cold[best]):.1f}")
    fastest = min(median(cold[bk]) for bk in ACCUMULATORS)
    winner = s["autotune_winner"]
    won = s["autotune_us"][winner] / 1e3
    require(won <= 1.10 * fastest,
            f"{name}: autotune winner {winner} {won:.1f} ms > "
            f"1.1 x the fastest cold {fastest:.1f}")
    fp = s["fastest_planned"]
    require(median(planned[winner]) <= 1.10 * median(planned[fp]),
            f"{name}: autotune winner {winner}'s planned call "
            f"{median(planned[winner]):.1f} ms > 1.1 x {fp}'s "
            f"{median(planned[fp]):.1f}")


def held_out_selection(a, b, chosen: str) -> dict:
    """The cost table away from its fit points: the six backends' planned
    calls (``spgemm(a, b, plan=p)``, three each, in turns) on
    ``matmul_sparse``'s activation operand, whose shape and duplicate ratio
    differ from bcsstk32's. Requires the backend ``matmul_sparse`` planned
    without ``backend=`` (``chosen``) within 10% of the fastest."""
    import repro_torch
    from repro_torch.plan import planner
    auto = planner.make_plan(a, b)
    require(chosen == auto.backend,
            f"matmul_sparse planned {chosen}, make_plan {auto.backend}")
    plans = {bk: planner.make_plan(a, b, backend=bk) for bk in ACCUMULATORS}
    planned = {bk: [] for bk in ACCUMULATORS}
    for bk, p in plans.items():                          # warm each once
        repro_torch.spgemm(a, b, plan=p)
    for _ in range(3):
        for bk, p in plans.items():
            planned[bk].append(
                timed_ms(lambda p=p: repro_torch.spgemm(a, b, plan=p))[1])
    costs, _ = planner.plan_costs(auto, a.k, a.n_cols, b.k,
                                  planner.cost_table(a.idx.device))
    fastest = min(ACCUMULATORS, key=lambda bk: median(planned[bk]))
    out = dict(chosen=chosen, fastest_planned=fastest, planned_ms=planned,
               cost=costs, stats=dataclasses.asdict(auto.stats))
    print(f"[select] matmul_sparse activation operand (held out of the "
          f"fit): planned {chosen} {median(planned[chosen]):.2f} ms, fastest "
          f"planned {fastest} {median(planned[fastest]):.2f}; "
          f"{json.dumps(out)}", flush=True)
    require(median(planned[chosen]) <= 1.10 * median(planned[fastest]),
            f"matmul_sparse's planned backend {chosen} "
            f"{median(planned[chosen]):.2f} ms > 1.1 x {fastest}'s "
            f"{median(planned[fastest]):.2f} on the held-out operand")
    return out


def fit_cuda_costs(sel: list) -> dict:
    """One unit and one fixed term a backend through the planned-call
    medians (µs) of the two operands against their forms, the
    ``planner.CUDA_COSTS`` form; printed as ``[fit]``."""
    (f1, t1), (f2, t2) = ((s["forms"], s["planned_ms"]) for s in sel)
    fit = {}
    for bk in ACCUMULATORS:
        y1, y2 = median(t1[bk]) * 1e3, median(t2[bk]) * 1e3
        unit = (y1 - y2) / (f1[bk] - f2[bk])
        fit[bk] = dict(unit=unit, fixed=y1 - unit * f1[bk])
    print(f"[fit] CUDA_COSTS from the planned calls of "
          f"{[s['operand'] for s in sel]}: {json.dumps(fit)}", flush=True)
    return fit


# ---------------------------------------------------------------------------
# The SpMM slice: MoE dispatch='spmm' (K9) and SparseMLP's N:M route (K10)
# ---------------------------------------------------------------------------

# a prefill batch at deepseek-v2-lite's published widths: 4 requests x 1,024
# tokens; the ELLPACK twin materializes (tokens, d_in·k) products, so it runs
# on a cut of ELL_CUT tokens
PREFILL = (4, 1024)
ELL_CUT = 8


def moe_operands(seed: int):
    """deepseek-v2-lite's MoE layer (``dispatch='spmm'`` over the config's
    ``'sort'``), its parameters and a prefill batch, float32 on the CPU.

    Tokens are multiples of 2^-3 in [-1, 1] with feature 0 fixed at 1; the
    router's rows are multiples of 2^-6 in [-2^-5, 2^-5], except row 0,
    which holds the tags e·2^-17. Every logit is then a multiple of 2^-17
    well inside float32's 24 bits, exact in any summation order, and no two
    experts of a token tie (the tags sit below the grid of the rest), so
    both devices route every token alike; ``route_exactly`` checks it. The
    expert weights are normal draws over sqrt(fan_in)."""
    import torch
    from repro_torch.configs import deepseek_v2_lite
    base = deepseek_v2_lite.CONFIG
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, dispatch="spmm"))
    m = cfg.moe
    d, e, f = cfg.d_model, m.n_experts, m.d_ff_expert
    rng = np.random.default_rng(seed)

    def lin(*shape):
        w = rng.standard_normal(shape, dtype=np.float32)
        return torch.from_numpy(w / np.float32(math.sqrt(shape[-2])))

    router = rng.integers(-2, 3, (d, e)).astype(np.float32) / 64
    router[0] = np.arange(e, dtype=np.float32) * np.float32(2.0 ** -17)
    p = {"router": torch.from_numpy(router), "w_gate": lin(e, d, f),
         "w_up": lin(e, d, f), "w_down": lin(e, f, d)}
    fs = m.n_shared * f
    p["shared"] = {"w_gate": lin(d, fs), "w_up": lin(d, fs),
                   "w_down": lin(fs, d)}
    x = rng.integers(-8, 9, (*PREFILL, d)).astype(np.float32) / 8
    x[..., 0] = 1.0
    return cfg, p, torch.from_numpy(x)


def route_exactly(x, router) -> None:
    """Require float32 logits equal to float64 ones and distinct in every
    token, on the operand's device."""
    import torch
    x2 = x.reshape(-1, x.shape[-1])
    l64 = x2.double().cpu() @ router.double().cpu()
    require(torch.equal((x2 @ router).double().cpu(), l64),
            f"router logits on {x.device} are not exact")
    srt = l64.sort(dim=-1).values
    require(bool((srt[:, 1:] > srt[:, :-1]).all()), "router logits tie")


def int_tensor(rng, shape, dev):
    import torch
    return torch.from_numpy(rng.integers(-4, 5, shape).astype(np.float32)) \
        .to(dev)


def sparse_rows(val, idx, n_rows: int):
    """A of row-wise ELLPACK planes as a torch CSR tensor (the library
    call's operand; built outside its timing)."""
    import torch
    s, c = torch.nonzero(idx >= 0, as_tuple=True)
    with warnings.catch_warnings():        # torch's beta-state notices
        warnings.simplefilter("ignore", UserWarning)
        a = torch.sparse_coo_tensor(torch.stack([idx[s, c].long(), c]),
                                    val[s, c], (n_rows, val.shape[1]))
        return a.coalesce().to_sparse_csr()


def nm_normal_error(what: str, x_shape, wn, seed: int) -> dict:
    """K10 and its plain fp32 twin (TF32 off) on normal operands of one
    layer's shape: X and a dense weight drawn normal, pruned to the layer's
    N:M; each one's max abs error against the float64 product. Requires the
    kernel's to be at most 4x the twin's."""
    import torch
    import repro_torch
    from repro_torch.kernels import nm_spmm as k10
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    x = torch.randn(x_shape, generator=g, device=dev)
    w = torch.randn((wn.d_in, wn.d_out), generator=g, device=dev)
    wp = repro_torch.magnitude_prune_nm(w, wn.n, wn.m)
    w_nm = repro_torch.nm_from_dense(wp, wn.n, wn.m)
    want = x.double() @ wp.double()
    del w
    errs = {}
    for key, fn in (("normal_err", k10.nm_spmm),
                    ("plain_normal_err", k10.nm_spmm_plain)):
        errs[key] = float((fn(x, w_nm.val, w_nm.off, n=wn.n, m=wn.m).double()
                           - want).abs().max())
    print(f"[check] nm_spmm {what} on normal operands: max|err| vs float64 "
          f"{errs['normal_err']:.4e}, plain fp32 twin "
          f"{errs['plain_normal_err']:.4e} "
          f"({errs['normal_err'] / errs['plain_normal_err']:.2f}x), max|y| "
          f"{float(want.abs().max()):.2f}", flush=True)
    require(errs["normal_err"] <= 4 * errs["plain_normal_err"],
            f"nm_spmm {what}: error {errs['normal_err']} on normal operands "
            f"over 4x the plain twin's {errs['plain_normal_err']}")
    del x, wp, w_nm, want
    torch.cuda.empty_cache()
    return errs


def ell_float_check(what: str, val, idx, n_rows: int, d: int, rng) -> dict:
    """K9 on normal float operands on the routing's own planes: two calls
    must give the same bits, and agree with the plain twin on the card
    (``index_add_``'s atomics, another order) within float32 summation
    order: a row of m terms sums with an error of at most
    (m - 1)·2⁻²⁴·Σ|v·x|, so the two differ by at most twice that; whether
    they equal the twin's bits on the CPU, which sums each row in lane
    order as the kernel does, is reported."""
    import torch
    from repro_torch.kernels import ell_spmm as k9
    k, n = val.shape
    dev = val.device
    fv = torch.where(idx >= 0, torch.from_numpy(rng.standard_normal(
        (k, n), dtype=np.float32)).to(dev), 0.0)
    fx = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)
                          ).to(dev)
    first = k9.ell_spmm(fv, idx, fx, n_rows)
    second = k9.ell_spmm(fv, idx, fx, n_rows)
    require(torch.equal(first.view(torch.int32), second.view(torch.int32)),
            f"ell_spmm {what}: two calls on float operands differ")
    diff = (first - k9.ell_spmm_plain(fv, idx, fx, n_rows)).abs()
    mag = k9.ell_spmm_plain(fv.abs(), idx, fx.abs(), n_rows)
    ok = (idx >= 0) & (idx < n_rows)
    terms = torch.bincount(idx[ok].long(), minlength=n_rows)
    tol = 2 * (terms - 1).clamp(min=0)[:, None] * 2.0 ** -24 * mag
    err = float(diff.max())
    require(bool((diff <= tol).all()), f"ell_spmm {what}: float operands "
            f"off the card twin by {err}, over float32 summation order")
    cpu = k9.ell_spmm_plain(fv.cpu(), idx.cpu(), fx.cpu(), n_rows)
    res = dict(float_same_bits_twice=True, float_err_vs_card_twin=err,
               float_bits_equal_cpu_twin=bool(torch.equal(first.cpu(), cpu)))
    print(f"[check] ell_spmm {what} float operands: {json.dumps(res)}",
          flush=True)
    return res


def k9_grids(cfg, t: int) -> int:
    """K9's grids in one ``moe_apply`` call on ``t`` tokens: the dispatch
    ((top_k, t) planes into the capacity slots) and the combine ((1,
    slots) planes back into the tokens)."""
    from repro_torch.kernels import ell_spmm as k9
    from repro_torch.models import ffn
    slots = cfg.moe.n_experts * ffn.moe_capacity(t, cfg)
    return (k9.grids(cfg.moe.top_k, t, slots, cfg.d_model)
            + k9.grids(1, slots, t, cfg.d_model))


def check_spmm_kernels(cfg, p, x, mlp, x_int, h_int, seed: int) -> list:
    """K9 at the MoE path's dispatch and combine shapes and K10 at
    SparseMLP's fc_in and fc_out shapes, each held bit for bit against its
    plain twin on integer-valued operands (|partial sums| < 2^24, so every
    order of the atomics and of the products gives the same bits). K9's
    planes are the routing's own (dispatch: value 1 on each kept pair;
    combine: the slot → token index with integer values in place of the
    routing weights); its library call is ``torch.sparse.mm`` of A as a CSR
    tensor, and its bound reads X only at the columns of A with a valid
    lane. K10's library call is ``x @ wp``, the dense product of the pruned
    weight, TF32 off. Its operation bound is the least time any float32-
    faithful route could take, the smaller of two floors: the
    dense-expanded product's 2·t·d_in·d_out operations three times over
    (split TF32) at the TF32 tensor cores' 495 TFLOP/s, and the condensed
    2·t·R·d_out at the CUDA cores' 67 TFLOP/s; it is passed as the
    operations that take the same time at the CUDA-core rate, so the first
    floor counts 3·2·t·d_in·d_out·67/495. Each K10 entry also holds
    ``fp64_floor_ms``, the dense-expanded product at the FP64 tensor cores'
    67 TFLOP/s (the rate the kernel runs at), ``one_tf32_ms``, the probe
    build that takes one TF32 product in place of the FP64 one (inexact on
    general floats, not checked here), and the max abs errors against the
    float64 product on normal operands of the layer's shape
    (``normal_err``, and ``plain_normal_err`` of the plain fp32 twin), the
    kernel's required to be at most 4x the twin's."""
    import torch
    from repro_torch.kernels import ell_spmm as k9
    from repro_torch.kernels import nm_spmm as k10
    from repro_torch.models import ffn
    dev = x.device
    rng = np.random.default_rng(seed + 1)
    t, d = x.shape[0] * x.shape[1], cfg.d_model
    logits = x.reshape(1, t, d) @ p["router"]
    w, _, _, kept, slot = ffn._spmm_route(logits, cfg)
    n_slots = cfg.moe.n_experts * ffn.moe_capacity(t, cfg)
    disp = ffn.dispatch_planes(kept[0], slot[0], n_slots, torch.float32)
    comb = ffn.combine_planes(kept[0], slot[0], w[0], n_slots, torch.float32)
    comb_val = torch.where(comb.idx >= 0, int_tensor(rng, comb.val.shape,
                                                     dev), 0.0)
    ell = []
    for what, val, idx, xx, n_rows in (
            ("dispatch", disp.val, disp.idx, int_tensor(rng, (t, d), dev),
             n_slots),
            ("combine", comb_val, comb.idx, int_tensor(rng, (n_slots, d),
                                                       dev), t)):
        k, n = val.shape
        valid = (idx >= 0) & (idx < n_rows)
        n_used = int(valid.any(0).sum())       # columns whose X row is read
        a_csr = sparse_rows(val, idx, n_rows)
        ell.append(held_pair(
            "ell_spmm", lambda: k9.ell_spmm(val, idx, xx, n_rows),
            lambda: k9.ell_spmm_plain(val, idx, xx, n_rows),
            lambda: torch.sparse.mm(a_csr, xx),
            f"{what}: ({k},{n}) x ({n},{d}) -> ({n_rows},{d}), "
            f"{int(valid.sum())} valid lanes in {n_used} columns",
            8 * k * n + 4 * n_used * d + 4 * n_rows * d,
            2 * int(valid.sum()) * d))
        ell[-1]["grids"] = grids_of(k9.ell_spmm, lambda: k9.ell_spmm(
            val, idx, xx, n_rows))
        ell[-1]["grid_ms"] = grid_ms("ell_spmm", what, lambda: k9.ell_spmm(
            val, idx, xx, n_rows))
        ell[-1].update(ell_float_check(what, val, idx, n_rows, d, rng))
        del a_csr, xx
    nm = []
    for what, layer, xx in (("fc_in", mlp.fc_in, x_int),
                            ("fc_out", mlp.fc_out, h_int)):
        wn = layer.w_nm
        wp = wn.to_dense()
        dense_ops = 2 * t * wn.d_in * wn.d_out
        nm.append(held_pair(
            "nm_spmm", lambda: k10.nm_spmm(xx, wn.val, wn.off, n=wn.n,
                                           m=wn.m),
            lambda: k10.nm_spmm_plain(xx, wn.val, wn.off, n=wn.n, m=wn.m),
            lambda: xx @ wp,
            f"{what}: ({t},{wn.d_in}) x {wn.n}:{wn.m} ({wn.r},{wn.d_out})",
            4 * t * wn.d_in + 5 * wn.r * wn.d_out + 4 * t * wn.d_out,
            min(3 * dense_ops * CORE_OPS_PER_S / TF32_OPS_PER_S,
                2 * t * wn.r * wn.d_out)))
        nm[-1]["fp64_floor_ms"] = dense_ops / FP64_TC_OPS_PER_S * 1e3
        nm[-1]["one_tf32_ms"] = cuda_ms(lambda: k10.launch(
            "nm_spmm_one_tf32", xx, wn.val, wn.off, n=wn.n, m=wn.m), 3)
        print(f"[probe] nm_spmm {what} with one TF32 product in place of "
              f"FP64: {nm[-1]['one_tf32_ms']:.4f} ms, as built (FP64) "
              f"{nm[-1]['ms']:.4f} ms, FP64 floor "
              f"{nm[-1]['fp64_floor_ms']:.4f} ms", flush=True)
        del wp
        nm[-1].update(nm_normal_error(what, xx.shape, wn, seed))
    torch.cuda.empty_cache()
    return [kernel_row("ell_spmm", "src/repro_torch/csrc/ell_spmm.cu",
                       "src/repro/kernels/ell_spmm.py:33", ell,
                       entries={"float32": "ell_spmm_f32",
                                "bfloat16": "ell_spmm_bf16"}),
            kernel_row("nm_spmm", "src/repro_torch/csrc/nm_spmm.cu",
                       "src/repro/kernels/nm_spmm.py:41", nm,
                       entries={"float32": "nm_spmm_f32",
                                "bfloat16": "nm_spmm_bf16"})]


def peak_of(fn):
    """Run ``fn`` once; its result, the device's peak memory during the
    call, and what the call added above the memory allocated before it."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    top = torch.cuda.max_memory_allocated()
    return out, dict(peak_gib=top / 2**30, call_gib=(top - base) / 2**30)


def drive_spmm_paths(paths: dict):
    """Each SpMM path once, with the launch counters zeroed just before and
    read just after. Returns ({path: counts}, {path: result},
    {path: (ms, peak)})."""
    import torch
    from repro_torch import kernels
    counts, out, cost = {}, {}, {}
    for name, fn in paths.items():
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res, peak = peak_of(fn)
        ms = (time.perf_counter() - t0) * 1e3
        counts[name] = kernels.launch_counts()
        out[name], cost[name] = res, (ms, peak)
        print(f"[path] {name}: {ms:.1f} ms, peak {json.dumps(peak)}, "
              f"launches {counts[name]}", flush=True)
    return counts, out, cost



def spmm_stage_ms(cfg, p, x, mlp, x_int) -> dict:
    """Host-clock ms of one ``moe_apply`` call's stages, each synchronised
    (``models.ffn._moe_spmm`` step by step: router product and routing,
    K9 dispatch, the three expert ``bmm``s with the SiLU, the combine
    planes, K9 combine, the shared SwiGLU), and of one ``SparseMLP`` call's
    (K10, GELU, K10)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import ffn
    t, d = x.shape[0] * x.shape[1], cfg.d_model
    e = cfg.moe.n_experts
    cap = ffn.moe_capacity(t, cfg)
    x_grp = x.reshape(1, t, d)
    ms = {}
    (w, _, _, kept, slot), ms["moe_router_and_routing"] = timed_ms(
        lambda: ffn._spmm_route(x_grp @ p["router"], cfg))
    disp, ms["moe_dispatch_planes"] = timed_ms(
        lambda: ffn.dispatch_planes(kept[0], slot[0], e * cap, x.dtype))
    xe, ms["moe_k9_dispatch"] = timed_ms(
        lambda: ffn._spmm_ell_auto(disp, x_grp[0]).reshape(e, cap, d))

    def experts():
        h = torch.bmm(xe, p["w_gate"])
        u = torch.bmm(xe, p["w_up"])
        return torch.bmm(F.silu(h) * u, p["w_down"]).reshape(e * cap, d)

    ye, ms["moe_expert_bmm"] = timed_ms(experts)
    comb, ms["moe_combine_planes"] = timed_ms(
        lambda: ffn.combine_planes(kept[0], slot[0], w[0], e * cap, x.dtype))
    _, ms["moe_k9_combine"] = timed_ms(lambda: ffn._spmm_ell_auto(comb, ye))
    _, ms["moe_shared_swiglu"] = timed_ms(
        lambda: ffn.swiglu_apply(p["shared"], x_grp, x.dtype))
    h, ms["mlp_k10_fc_in"] = timed_ms(lambda: mlp.fc_in(x_int))
    g, ms["mlp_gelu"] = timed_ms(lambda: F.gelu(h, approximate="tanh"))
    _, ms["mlp_k10_fc_out"] = timed_ms(lambda: mlp.fc_out(g))
    return ms


def spmm_slice(seed: int):
    """The SpMM slice end to end: returns (kernel rows, {path: counts},
    the e2e summary). See the module docstring, phases 5-6."""
    import torch
    import repro_torch
    from repro_torch import kernels
    from repro_torch.core.formats import params_from_numpy
    from repro_torch.models import sparse as sl
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False    # full float32 products
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg, p_cpu, x_cpu = moe_operands(seed)
    p = params_from_numpy(p_cpu, device=dev)
    x = x_cpu.to(dev)
    route_exactly(x_cpu, p_cpu["router"])
    route_exactly(x, p["router"])
    d, f = cfg.d_model, cfg.d_ff
    t = PREFILL[0] * PREFILL[1]
    rng = np.random.default_rng(seed + 2)
    w_in, w_out = int_tensor(rng, (d, f), dev), int_tensor(rng, (f, d), dev)
    mlp = repro_torch.SparseMLP(w_in, w_out, 0.5, nm=(2, 4))
    x_int, h_int = int_tensor(rng, (t, d), dev), int_tensor(rng, (t, f), dev)
    w_auto = torch.from_numpy(rng.standard_normal((d, f), dtype=np.float32)
                              ).to(dev)
    lin_auto = repro_torch.SparseLinear(w_auto, 0.9, nm="auto")
    a_dense = int_tensor(rng, (64, d), dev) \
        * torch.from_numpy(rng.random((64, d)) < 0.05).to(dev)
    a_act = repro_torch.ell_rows_from_dense(
        a_dense, int((a_dense != 0).sum(0).max()), device=dev)
    torch.cuda.synchronize()
    print(f"[spmm] deepseek-v2-lite MoE E={cfg.moe.n_experts} "
          f"top-{cfg.moe.top_k} d_ff_expert={cfg.moe.d_ff_expert} "
          f"shared={cfg.moe.n_shared} T={t}; SparseMLP {d}->{f}->{d} 2:4 "
          f"(ELL twin k {mlp.fc_in.w_ell.k}/{mlp.fc_out.w_ell.k}); "
          f"90% SparseLinear k {lin_auto.w_ell.k}; set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # -- phase 5: K9 and K10 against their plain twins ------------------------
    rows = check_spmm_kernels(cfg, p, x, mlp, x_int, h_int, seed)

    # -- phase 6: the paths, counters zeroed around each -----------------------
    x_cut, h_cut = x_int[:ELL_CUT], h_int[:ELL_CUT]
    paths = {
        "moe_spmm": lambda: repro_torch.moe_apply(p, x, cfg, torch.float32),
        "sparse_mlp": lambda: mlp(x_int),
        "sparse_linear_ellpack_cut": lambda: (
            sl.sparse_linear_apply(x_cut, mlp.fc_in.w_ell),
            sl.sparse_linear_apply(h_cut, mlp.fc_out.w_ell)),
        "sparse_linear_auto_cut": lambda: lin_auto(x_cut),
        "matmul_sparse_miss": lambda: lin_auto.matmul_sparse(
            a_act, backend="sort"),
        "matmul_sparse_hit": lambda: lin_auto.matmul_sparse(
            a_act, backend="sort"),
        "matmul_sparse_auto": lambda: lin_planned.matmul_sparse(a_act),
    }
    # the same weight in a layer of its own cache: its miss plans 'auto'
    lin_planned = sl.SparseLinear.from_planes(lin_auto.w_ell)
    counts, out, cost = drive_spmm_paths(paths)
    require(counts["moe_spmm"]["ell_spmm"] == k9_grids(cfg, t),
            f"moe path launched {counts['moe_spmm']['ell_spmm']} K9 grids, "
            f"not {k9_grids(cfg, t)}")
    require(counts["sparse_mlp"]["nm_spmm"] == 2,
            f"SparseMLP launched K10 {counts['sparse_mlp']['nm_spmm']} times")
    for name in ("matmul_sparse_miss", "matmul_sparse_hit"):
        for kname in ("sccp_multiply", "align_product_keys"):
            require(counts[name][kname] > 0, f"{name} skipped {kname}")
    auto_backend = lin_planned.cache.get(a_act, lin_planned.w_ell).plan.backend
    numeric_kernel = "align_keys" if auto_backend == "stream" \
        else "align_product_keys"
    for kname in ("sccp_multiply", numeric_kernel):
        require(counts["matmul_sparse_auto"][kname] > 0,
                f"matmul_sparse_auto ({auto_backend}) skipped {kname}")

    # MoE: the same call on CPU tensors (the plain twins), same routing
    y, aux = out["moe_spmm"]
    require(y.shape == x.shape and bool(torch.isfinite(y).all()),
            "moe output not finite or misshapen")
    t_cpu = time.perf_counter()
    y_cpu, aux_cpu = repro_torch.moe_apply(p_cpu, x_cpu, cfg, torch.float32)
    t_cpu = time.perf_counter() - t_cpu
    from repro_torch.models import ffn
    r_dev = ffn._spmm_route(x.reshape(1, t, d) @ p["router"], cfg)
    r_cpu = ffn._spmm_route(x_cpu.reshape(1, t, d) @ p_cpu["router"], cfg)
    for i, name in ((1, "ids"), (3, "kept"), (4, "slot")):
        require(r_dev[i].is_cuda, f"moe routing {name} not on the card")
        same(f"moe routing {name}, card vs CPU", r_dev[i].cpu(), r_cpu[i])
    moe_err = float((y.cpu() - y_cpu).abs().max())
    moe_tol = 1e-4 * float(y_cpu.abs().max())
    require(moe_err <= moe_tol, f"moe y off by {moe_err} > {moe_tol}")
    aux_err = abs(float(aux) - float(aux_cpu))
    require(aux_err <= 1e-5 * abs(float(aux_cpu)), f"moe aux off by {aux_err}")
    print(f"[check] moe_apply card == CPU routing (ids, kept, slots; "
          f"{int(r_cpu[3].sum())} of {r_cpu[3].numel()} pairs kept), y "
          f"max|diff| {moe_err:.3e} <= 1e-4·max|y| = {moe_tol:.3e}, aux "
          f"{float(aux):.6f} vs {float(aux_cpu):.6f}; CPU call "
          f"{t_cpu:.1f} s", flush=True)
    del y_cpu, aux_cpu, p_cpu

    # SparseMLP: each layer equals the dense product of its pruned weight
    wp_in, wp_out = mlp.fc_in.w_nm.to_dense(), mlp.fc_out.w_nm.to_dense()
    same("SparseMLP fc_in vs x @ wp", mlp.fc_in(x_int), x_int @ wp_in)
    same("SparseMLP fc_out vs h @ wp", mlp.fc_out(h_int), h_int @ wp_out)
    ym = out["sparse_mlp"]
    require(ym.shape == (t, d) and bool(torch.isfinite(ym).all()),
            "SparseMLP output not finite or misshapen")
    want = mlp.fc_out(torch.nn.functional.gelu(x_int @ wp_in,
                                               approximate="tanh"))
    same("SparseMLP vs fc_out(gelu(x @ wp))", ym, want)
    # the ELLPACK twin equals the N:M route on the cut
    e_in, e_out = out["sparse_linear_ellpack_cut"]
    same("ELLPACK twin fc_in", e_in, mlp.fc_in(x_cut))
    same("ELLPACK twin fc_out", e_out, mlp.fc_out(h_cut))
    print(f"[check] SparseMLP layers == x @ wp bit for bit (TF32 off); "
          f"ELLPACK twin == N:M route on {ELL_CUT} tokens", flush=True)
    del wp_in, wp_out, want
    # 'auto' at a 90% global prune routes to ELLPACK
    require(lin_auto.w_nm is None, "90% global prune routed to N:M")
    ya = out["sparse_linear_auto_cut"]
    ref = x_cut @ lin_auto.w_ell.to_dense()
    auto_err = float((ya - ref).abs().max())
    require(auto_err <= 1e-5 * float(ref.abs().max()),
            f"auto ELLPACK apply off by {auto_err}")
    # matmul_sparse: a miss then a hit, both equal to the dense product
    st = lin_auto.cache.stats()
    require(st["misses"] == 1 and st["hits"] == 1, f"cache stats {st}")
    c_ref = a_dense @ lin_auto.w_ell.to_dense()
    for name in ("matmul_sparse_miss", "matmul_sparse_hit",
                 "matmul_sparse_auto"):
        coo = out[name]
        require(not bool(coo.overflowed()), f"{name} overflowed")
        err = float((coo.to_dense() - c_ref).abs().max())
        require(err <= 1e-5 * float(c_ref.abs().max()),
                f"{name} off the dense product by {err}")
    # same coordinates; the values are float sums whose slot index_add_
    # lands in a different order each call
    hit, miss = out["matmul_sparse_hit"], out["matmul_sparse_miss"]
    for f_ in ("row", "col", "ngroups"):
        same(f"matmul_sparse hit vs miss .{f_}", getattr(hit, f_),
             getattr(miss, f_))
    require(float((hit.val - miss.val).abs().max())
            <= 1e-5 * float(miss.val.abs().max()),
            "matmul_sparse hit vs miss values differ")
    same("matmul_sparse without backend= vs miss .ngroups",
         out["matmul_sparse_auto"].ngroups, miss.ngroups)
    print(f"[check] 'auto' at 90% -> ELLPACK (k {lin_auto.w_ell.k}), max|diff| "
          f"{auto_err:.3e}; matmul_sparse miss then hit {st}, "
          f"{int(out['matmul_sparse_hit'].ngroups)} groups; without "
          f"backend= it planned {auto_backend}", flush=True)
    del out

    # -- e2e: three timed calls each, K9's grids twice, K10 twice a call -------
    e2e = {}
    for name, kname, want in (("moe_spmm", "ell_spmm", k9_grids(cfg, t)),
                              ("sparse_mlp", "nm_spmm", 2)):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t1 = time.perf_counter()
            paths[name]()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
            n = kernels.launch_counts()[kname]
            require(n == want, f"{name} launched {kname} {n} times")
        e2e[name] = times
    held_out = held_out_selection(a_act, lin_auto.w_ell, auto_backend)
    summary = {"spmm_e2e_ms": e2e,
               "spmm_held_out_selection": held_out,
               "spmm_stage_ms": spmm_stage_ms(cfg, p, x, mlp, x_int),
               "spmm_path_ms": {k: v[0] for k, v in cost.items()},
               "spmm_peak_mem_per_call": {k: v[1] for k, v in cost.items()},
               "moe_max_abs_err_vs_cpu": moe_err}
    return rows, counts, summary


# ---------------------------------------------------------------------------
# Phase 6b: the serving engine's SpGEMM lane at full width
# ---------------------------------------------------------------------------

SERVE_BATCH = 8                   # ServeConfig(max_batch=...): slots a wave
SERVE_ROUNDS = (16, 13)           # requests on the three patterns a round
SERVE_DROP = (0.0, 0.005, 0.01)   # share of A's non-zeros a pattern lacks
# (misses, waves, batched waves, spgemm_occupancy_sum after the round)
SERVE_EXPECT = ((4, 3, 2, 2.0), (0, 2, 2, 3.625))


def timed_peak(fn):
    """``fn()``, its host-clock ms (synchronised before and after) and its
    peak device memory (``peak_of``'s dict)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    top = torch.cuda.max_memory_allocated()
    return out, ms, dict(peak_gib=top / 2**30, call_gib=(top - base) / 2**30)


def same_prefix(name: str, got, want) -> None:
    """Two sorted-COO results hold the same groups: equal ``ngroups`` and
    equal row, col and val over the first ``ngroups`` slots (their caps may
    differ: a wave pads to its widest structure)."""
    n = int(want.ngroups)
    require(int(got.ngroups) == n,
            f"{name}: ngroups {int(got.ngroups)} != {n}")
    for f in ("row", "col", "val"):
        same(f"{name} .{f}", getattr(got, f)[:n], getattr(want, f)[:n])


def serve_phase(A, seed: int):
    """The engine's SpGEMM lane on bcsstk32 A·Aᵀ (k = A's ELLPACK width)
    and A's first 1/CUT_PART columns times their transpose: two rounds of
    requests with fresh integer values through ``submit_spgemm`` and
    ``flush_spgemm``, the tracer on. Returns ({path: counts}, summary)."""
    import scipy.sparse as sp
    import torch
    import repro_torch
    from repro_torch import kernels, obs
    from repro_torch.core.formats import np_ell_rows_from_scipy
    from repro_torch.core.spgemm import spgemm_coo_numeric
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 23)
    A_csc = A.tocsc()
    n = A.shape[0]
    k = int(np.diff(A_csc.indptr).max())
    pats = []                                 # (name, idx plane, contraction)
    for i, drop in enumerate(SERVE_DROP):
        P = A_csc.copy()
        if drop:
            P.data[rng.choice(P.nnz, int(round(drop * P.nnz)),
                              replace=False)] = 0
            P.eliminate_zeros()
        pats.append((f"P{i}", torch.from_numpy(
            np_ell_rows_from_scipy(P, k)[1]).to(dev), n))
    cols = A.shape[1] // CUT_PART
    A8 = A_csc[:, :cols]
    cut = ("cut", torch.from_numpy(np_ell_rows_from_scipy(
        A8, int(np.diff(A8.indptr).max()))[1]).to(dev), cols)

    def request(pat):
        """X on pattern ``pat`` with fresh values; C = X·Xᵀ, B's planes
        being A's transposed."""
        name, idx, _ = pat
        v = (rng.integers(1, 5, idx.shape)
             * rng.choice(np.array([-1, 1]), idx.shape)).astype(np.float32)
        val = torch.where(idx >= 0, torch.from_numpy(v).to(dev), 0)
        return (name, repro_torch.EllRows(val=val, idx=idx, n_rows=n),
                repro_torch.EllCols(val=val.T.contiguous(),
                                    idx=idx.T.contiguous(), n_cols=n))

    def scipy_ref(a):
        ok = (a.idx >= 0).cpu().numpy()
        r = a.idx.cpu().numpy()[ok]
        c = np.broadcast_to(np.arange(a.n_cols), a.idx.shape)[ok]
        x = sp.csr_matrix((a.val.cpu().numpy()[ok].astype(np.float64),
                           (r, c)), shape=(a.n_rows, a.n_cols))
        x_abs = abs(x)
        return (x @ x.T).tocsr(), int((x_abs @ x_abs.T).nnz)

    eng = repro_torch.ServingEngine(None, None, repro_torch.ServeConfig(
        max_batch=SERVE_BATCH))
    cache, batcher = eng.structure_cache, eng.sparse_batcher
    lookup, run_wave = cache.get, batcher._run_wave
    gets, waves = [], []

    def timed_get(a, b, **kw):            # each lookup: its ms, hit or miss
        torch.cuda.synchronize()
        misses = cache.stats()["misses"]
        t0 = time.perf_counter()
        st = lookup(a, b, **kw)
        torch.cuda.synchronize()
        gets.append(((time.perf_counter() - t0) * 1e3,
                     cache.stats()["misses"] > misses, a.n_cols))
        return st

    def timed_wave(wave, wsts, out):      # each wave: ms, launches, peak
        torch.cuda.synchronize()
        before = kernels.launch_counts()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run_wave(wave, wsts, out)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        waves.append(dict(
            real=len(wave), cap=max(st.out_cap for st in wsts),
            backend=wsts[0].plan.backend,
            ms=(time.perf_counter() - t0) * 1e3,
            launches={kn: after[kn] - before[kn] for kn in (
                "sccp_multiply", "align_product_keys", "align_keys")},
            peak_over_resident_gib=(torch.cuda.max_memory_allocated()
                                    - base) / 2**30))

    cache.get, batcher._run_wave = timed_get, timed_wave
    counts, rounds = {}, []
    obs.enable(reset=True)
    try:
        for rnd, n_req in enumerate(SERVE_ROUNDS, 1):
            reqs = [request(pats[i % len(pats)]) for i in range(n_req)]
            if rnd == 1:
                reqs.append(request(cut))
            before = dict(eng.stats)
            misses, n_waves, n_gets = cache.stats()["misses"], len(waves), \
                len(gets)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            rids = [eng.submit_spgemm(a, b) for _, a, b in reqs]
            res = eng.flush_spgemm()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            counts[f"serve_round{rnd}"] = kernels.launch_counts()
            got = (cache.stats()["misses"] - misses,
                   eng.stats["spgemm_waves"] - before["spgemm_waves"],
                   eng.stats["spgemm_batched_waves"]
                   - before["spgemm_batched_waves"],
                   eng.stats["spgemm_occupancy_sum"])
            require(got == SERVE_EXPECT[rnd - 1],
                    f"serve round {rnd}: (misses, waves, batched waves, "
                    f"occupancy sum) {got} != {SERVE_EXPECT[rnd - 1]}")
            for w in waves[n_waves:]:
                require(w["launches"]["sccp_multiply"] >= 1
                        and w["launches"]["align_product_keys"]
                        + w["launches"]["align_keys"] > 0,
                        f"serve round {rnd}: a wave skipped K1 or K3: {w}")
                require(w["real"] == 1
                        or w["launches"]["sccp_multiply"] == w["real"],
                        f"serve round {rnd}: a batched wave's K1 launches "
                        f"{w['launches']} for {w['real']} slots")
            # every result is its own lone numeric call, bit for bit
            for (name, a, b), rid in zip(reqs, rids):
                same_prefix(f"serve round {rnd} request {rid} ({name})",
                            res[rid], spgemm_coo_numeric(
                                a, b, lookup(a, b), validate=False))
            sampled = {}
            if rnd == 1:                  # one request a pattern, and the cut
                for (name, a, b), rid in zip(reqs, rids):
                    if name not in sampled:
                        c_ref, nnz_ref = scipy_ref(a)
                        check_against_scipy(f"serve {name}", res[rid], c_ref,
                                            nnz_ref)
                        sampled[name] = dict(nnz_c=nnz_ref,
                                             out_cap=lookup(a, b).out_cap,
                                             wave_cap=res[rid].cap)
                caps = [sampled[p[0]]["out_cap"] for p in pats]
                require(len(set(caps)) == len(pats),
                        f"serve: the patterns' out_caps {caps} are not "
                        "distinct (the wave's KEY_INVALID padding unused)")
            else:                         # the one-shot path, a cache hit
                name, a, b = reqs[0]
                kernels.reset_launch_counts()
                one = eng.spgemm(a, b)
                torch.cuda.synchronize()
                counts["serve_spgemm"] = kernels.launch_counts()
                same_prefix("eng.spgemm vs its queued twin", one, res[rids[0]])
                del one
            flush_gets = gets[n_gets:]
            rounds.append(dict(
                round=rnd, requests=len(reqs), flush_ms=sec * 1e3,
                requests_per_s=len(reqs) / sec,
                miss_ms=[ms for ms, miss, _ in flush_gets if miss],
                hit_ms=[ms for ms, miss, _ in flush_gets if not miss],
                waves=waves[n_waves:], scipy=sampled))
            also = (f"{', '.join(sampled)} == scipy" if sampled
                    else "eng.spgemm == its queued twin")
            print(f"[serve] round {rnd}: {len(reqs)} requests in "
                  f"{sec * 1e3:.1f} ms ({len(reqs) / sec:.2f} requests/s), "
                  f"(misses, waves, batched, occupancy sum) {got}; every "
                  f"result == its lone numeric call; {also}", flush=True)
            del res, reqs
        snap = eng.stats()
        spans = [e["dur_us"] / 1e3
                 for e in obs.get_tracer().spans("serve.spgemm_wave")]
        metrics = obs.metrics.snapshot()
    finally:
        obs.disable()
        obs.reset()
    hit_ms = [ms for r in rounds for ms in r["hit_ms"]]
    summary = dict(
        operand=BCSSTK32[1], k=k, lanes=k * n * k, cut_cols=cols,
        max_batch=SERVE_BATCH, rounds=rounds, wave_span_ms=spans,
        fingerprint_ms_per_request=median(hit_ms), stats=snap,
        metrics={kind: {m: x for m, x in metrics[kind].items()
                        if m.startswith("serve.")}
                 for kind in ("counters", "gauges", "histograms")})
    print(f"[serve] {json.dumps(summary)}", flush=True)
    del eng, pats, cut
    torch.cuda.empty_cache()
    return counts, summary


# ---------------------------------------------------------------------------
# Phase 6c: the hybrid ELLPACK + COO format at full width
# ---------------------------------------------------------------------------

HYBRID_COO_ROUND = 1024           # coo_cap: the overflow count rounded up
ROW_BLOCK = 4096                  # rows of C compared on the card at a time


def hybrid_phase(M):
    """Paper §III-C on bcsstk32: A = Mᵀ, whose column counts are Table I's
    row statistics, split at ``ell_width_rule``'s width, and C = A·Aᵀ =
    Mᵀ·M through ``hybrid_spgemm_dense``, against scipy and against
    ``spgemm_dense`` at the full ELLPACK width. Returns ({path: counts},
    summary)."""
    import torch
    import repro_torch
    from repro_torch import kernels
    from repro_torch.core import hybrid
    from repro_torch.core.accumulate import scatter_dense
    from repro_torch.core.formats import from_numpy, np_ell_rows_from_scipy
    from repro_torch.core.sccp import sccp_multiply
    dev = torch.device("cuda")
    n = M.shape[0]
    line = np.diff(M.indptr)                  # A's column counts, B's rows
    k = hybrid.ell_width_rule(line)
    n_coo = int(np.maximum(line - k, 0).sum())
    coo_cap = -(-n_coo // HYBRID_COO_ROUND) * HYBRID_COO_ROUND
    r, c, v = (torch.from_numpy(x).to(dev) for x in (
        np.repeat(np.arange(n), line), M.indices.astype(np.int64),
        M.data.astype(np.float32)))

    def dense(transposed: bool):
        """M (or Mᵀ) dense on the card, from its CSR arrays."""
        d = torch.zeros((n, n), dtype=torch.float32, device=dev)
        d[(c, r) if transposed else (r, c)] = v
        return d

    splits, split_ms, split_peak = {}, {}, {}
    for side, transposed, split in (
            ("rows", True, hybrid.split_rows_hybrid),
            ("cols", False, hybrid.split_cols_hybrid)):
        x = dense(transposed)
        h, split_ms[side], split_peak[side] = timed_peak(
            lambda: split(x, k, coo_cap, device=dev))
        require(int(h.coo.ngroups) == n_coo and h.coo.cap == coo_cap,
                f"hybrid split {side}: COO holds {int(h.coo.ngroups)} of "
                f"cap {h.coo.cap}, not {n_coo} of {coo_cap}")
        require(torch.equal(h.to_dense(), x),
                f"hybrid split {side}: to_dense() differs from its input")
        splits[side] = h
        del x
    ha, hb = splits["rows"], splits["cols"]
    cnt = torch.from_numpy(line).to(dev)
    coo_terms = int(cnt[ha.coo.col[ha.coo.row >= 0].long()].sum()
                    + cnt[hb.coo.row[hb.coo.row >= 0].long()].clamp(
                        max=k).sum())
    ell_products = int(repro_torch.count_products(ha.ell, hb.ell))
    print(f"[hybrid] A = {BCSSTK32[1]}ᵀ: k {k} (max {int(line.max())}), "
          f"COO {n_coo} of cap {coo_cap} each; ELL products {ell_products} "
          f"of {k * n * k} lanes, COO terms {coo_terms}; split ms "
          f"{json.dumps(split_ms)}; each split == its input", flush=True)

    kernels.reset_launch_counts()
    c_h, ms, peak = timed_peak(lambda: hybrid.hybrid_spgemm_dense(ha, hb))
    counts = {"hybrid": kernels.launch_counts()}
    require(counts["hybrid"]["sccp_multiply"] == 1,
            f"hybrid_spgemm_dense launched {counts['hybrid']} (K1 once)")
    calls_ms = [ms] + [timed_peak(lambda: hybrid.hybrid_spgemm_dense(
        ha, hb))[1] for _ in range(2)]
    # each term alone, as hybrid_spgemm_dense runs them
    terms = {}
    (val, row, col), terms["sccp_multiply"] = timed_ms(
        lambda: sccp_multiply(ha.ell, hb.ell))
    t, terms["scatter_dense"] = timed_ms(
        lambda: scatter_dense(row, col, val, n, n))
    # the same put over the valid lanes alone: scatter_dense parks every
    # dead lane at (n, 0), one long run of one index for index_put_
    ok = row.reshape(-1) >= 0
    t_ok, terms["probe_scatter_dense_valid_lanes"] = timed_ms(
        lambda: scatter_dense(row.reshape(-1)[ok], col.reshape(-1)[ok],
                              val.reshape(-1)[ok], n, n))
    require(torch.equal(t_ok, t), "hybrid: scatter_dense over the valid "
            "lanes differs from the whole stream's")
    dead_lanes = int((~ok).sum())
    del val, row, col, t, t_ok, ok
    other, terms["b_to_dense"] = timed_ms(hb.to_dense)
    t, terms["coo_a_times_b"] = timed_ms(
        lambda: hybrid._coo_matmul_dense(ha.coo, other, left=True))
    del other, t
    other, terms["a_ell_to_dense"] = timed_ms(ha.ell.to_dense)
    t, terms["ell_a_times_coo_b"] = timed_ms(
        lambda: hybrid._coo_matmul_dense(hb.coo, other, left=False))
    del other, t

    # C against scipy's Mᵀ·M, a block of rows at a time on the card
    t0 = time.perf_counter()
    M64 = M.astype(np.float64)
    c_ref = (M64.T @ M64).tocsr()
    ref_s = time.perf_counter() - t0
    for lo in range(0, n, ROW_BLOCK):
        blk = c_ref[lo:lo + ROW_BLOCK].tocoo()
        want = torch.zeros((blk.shape[0], n), dtype=torch.float32,
                           device=dev)
        want[torch.from_numpy(blk.row.astype(np.int64)).to(dev),
             torch.from_numpy(blk.col.astype(np.int64)).to(dev)] = \
            torch.from_numpy(blk.data.astype(np.float32)).to(dev)
        require(torch.equal(c_h[lo:lo + ROW_BLOCK], want),
                f"hybrid: rows {lo}.. differ from scipy's Mᵀ·M")
        del want
    nnz_c = int((c_h != 0).sum())
    require(nnz_c == c_ref.nnz, f"hybrid: {nnz_c} non-zeros, scipy "
            f"{c_ref.nnz}")
    del c_ref
    print(f"[check] hybrid_spgemm_dense == scipy Mᵀ·M bit for bit "
          f"({nnz_c} non-zeros)", flush=True)

    # the same product at the full ELLPACK width; C waits on the host
    c_host = c_h.cpu()
    del c_h
    k_full = int(line.max())
    a_full = from_numpy(*np_ell_rows_from_scipy(M.T.tocsc(), k_full),
                        n_rows=n, device=dev)
    b_full = repro_torch.EllCols(val=a_full.val.T.contiguous(),
                                 idx=a_full.idx.T.contiguous(), n_cols=n)
    kernels.reset_launch_counts()
    c_full, full_ms, full_peak = timed_peak(
        lambda: repro_torch.spgemm_dense(a_full, b_full))
    counts["dense_full_width"] = kernels.launch_counts()
    for lo in range(0, n, ROW_BLOCK):
        require(torch.equal(c_full[lo:lo + ROW_BLOCK],
                            c_host[lo:lo + ROW_BLOCK].to(dev)),
                f"hybrid: rows {lo}.. differ from spgemm_dense at width "
                f"{k_full}")
    del c_full, c_host
    # K1 alone; the rest of the call is scatter_dense (timing it alone too
    # would cost another call of about a minute)
    planes, k1_ms = timed_ms(lambda: sccp_multiply(a_full, b_full))
    full_terms = dict(sccp_multiply=k1_ms, scatter_dense=full_ms - k1_ms)
    del planes, a_full, b_full
    print(f"[check] hybrid_spgemm_dense == spgemm_dense at width {k_full} "
          "bit for bit", flush=True)
    summary = dict(
        operand=f"{BCSSTK32[1]}^T", k=k, k_full=k_full, coo=n_coo,
        coo_cap=coo_cap, ell_lanes=k * n * k, ell_products=ell_products,
        coo_terms=coo_terms, ell_dead_lanes=dead_lanes,
        full_lanes=k_full * n * k_full, nnz_c=nnz_c,
        split_ms=split_ms, split_peak=split_peak, hybrid_ms=calls_ms,
        hybrid_median_ms=median(calls_ms), hybrid_peak=peak,
        hybrid_terms_ms=terms, dense_full_width_ms=full_ms,
        dense_full_width_peak=full_peak,
        dense_full_width_terms_ms=full_terms, scipy_ref_s=ref_s,
        k1_launches={p: x["sccp_multiply"] for p, x in counts.items()})
    print(f"[hybrid] {json.dumps(summary)}", flush=True)
    del splits, ha, hb, r, c, v, cnt
    torch.cuda.empty_cache()
    return counts, summary


# ---------------------------------------------------------------------------
# Phase 6d: the distributed SpGEMM on four shards of the card
# ---------------------------------------------------------------------------

DIST_SHARDS = 4
DIST_SCHEDULES = ("ring", "cstat", "summa")
DIST_NOTE = "4 shards of one card; the exchange is device-local copies"


def dist_phase(A, c_ref, nnz_c: int, seed: int):
    """bcsstk32 A·Aᵀ, uncut, through ``spgemm(a, b, mesh=, axis=)`` on
    ``make_mesh((4,), ("x",))``: the plan, each schedule cold with overlap
    on and off, ``'stream'``, warm on a structure with ``n_dev=4``, poison,
    and at the 5,625-column cut the batched call, ``ring_spgemm`` and the
    slab pad; one traced call. Returns ({path: counts}, summary)."""
    import torch
    import repro_torch
    from repro_torch import kernels, obs
    from repro_torch.core import distributed as dist
    from repro_torch.core.formats import (from_numpy, np_ell_cols_from_scipy,
                                          np_ell_rows_from_scipy)
    from repro_torch.parallel import make_mesh
    from repro_torch.parallel import mesh as pmesh
    dev = torch.device("cuda")
    n = A.shape[0]
    A_csc = A.tocsc()
    k = int(np.diff(A_csc.indptr).max())
    a = from_numpy(*np_ell_rows_from_scipy(A_csc, k), n_rows=n, device=dev)
    b = from_numpy(*np_ell_cols_from_scipy(A.T.tocsr(), k), n_cols=n,
                   device=dev)
    mesh = make_mesh((DIST_SHARDS,), ("x",))
    devices = [str(d) for d in mesh.devices]

    # -- planning ---------------------------------------------------------
    dp, plan_ms = timed_ms(lambda: repro_torch.make_dist_plan(
        a, b, n_dev=DIST_SHARDS))
    backend = dp.base.backend
    comm = {s: dp.est[f"{s}_comm_bytes"] for s in DIST_SCHEDULES}
    print(f"[dist] mesh {devices} ({DIST_NOTE}); make_dist_plan "
          f"{plan_ms:.1f} ms: schedule {dp.schedule}, grid "
          f"{dp.pr}x{dp.pc}, base {backend}, local_cap {dp.local_cap}, "
          f"bin_cap {dp.bin_cap}, block_cap {dp.block_cap}, out_cap "
          f"{dp.out_cap}, modeled comm bytes a device {json.dumps(comm)}, "
          f"modeled intermediate of the whole stream "
          f"{dp.base.est.get(f'interm_{backend}', 0.0) / 2**30:.2f} GiB",
          flush=True)
    shard_products = [int(x) for x in
                      repro_torch.plan.symbolic.per_shard_products(
                          a, b, DIST_SHARDS)]
    print(f"[dist] products a shard of A's slabs {shard_products}",
          flush=True)
    c_one = repro_torch.spgemm(a, b, check=True)
    check_against_scipy("dist single-device", c_one, c_ref, nnz_c)

    def held(name, got, want=c_one):
        for f in ("row", "col", "val", "ngroups"):
            same(f"{name} .{f}", getattr(got, f), getattr(want, f))

    def k1_want(s):
        return (dp.pr if s == "summa" else DIST_SHARDS) * DIST_SHARDS

    counts, cold = {}, {}

    def run(name, fn, k1):
        """``fn`` three times: the first with the counters and the moved
        bytes zeroed around it and its peak; the result held against the
        single-device call."""
        kernels.reset_launch_counts()
        pmesh.reset_moved_bytes()
        out, ms, peak = timed_peak(fn)
        counts[name] = kernels.launch_counts()
        moved = pmesh.moved_bytes()
        require(counts[name]["sccp_multiply"] == k1,
                f"{name}: K1 launched {counts[name]['sccp_multiply']} "
                f"times, not {k1}")
        held(name, out)
        del out
        times = [ms] + [timed_ms(fn)[1] for _ in range(2)]
        row = dict(ms=times, median_ms=median(times), peak=peak,
                   moved_bytes_per_shard=moved / DIST_SHARDS,
                   launches={kk: v for kk, v in counts[name].items() if v})
        print(f"[dist] {name}: {json.dumps(row)}", flush=True)
        return row

    for s in DIST_SCHEDULES:
        dps = dataclasses.replace(dp, schedule=s)
        for overlap in (True, False):
            cold[f"{s}_overlap{int(overlap)}"] = run(
                f"dist_{s}_overlap{int(overlap)}",
                lambda dps=dps, ov=overlap: repro_torch.spgemm(
                    a, b, mesh=mesh, axis="x", dist_plan=dps, overlap=ov,
                    check=True), k1_want(s))
        cold[f"{s}_overlap1"]["modeled_comm_bytes_per_shard"] = comm[s]
    print(f"[check] dist: ring, cstat and summa, overlap on and off, == "
          f"the single-device call bit for bit (== scipy A @ A.T, "
          f"ngroups {nnz_c})", flush=True)
    ring = dataclasses.replace(dp, schedule="ring")
    cold["ring_stream"] = run(
        "dist_ring_stream", lambda: repro_torch.spgemm(
            a, b, mesh=mesh, axis="x", dist_plan=ring, accumulator="stream",
            check=True), k1_want("ring"))
    require(counts["dist_ring_stream"]["merge_runs"] > 0,
            "dist 'stream' skipped the merge step")

    # -- warm: a structure with n_dev=4 -----------------------------------
    st, st_ms = timed_ms(lambda: repro_torch.make_structure(
        a, b, n_dev=DIST_SHARDS))
    warm = {}
    for s in ("ring", "summa"):
        warm[s] = run(f"dist_numeric_{s}", lambda s=s: repro_torch.spgemm(
            a, b, mesh=mesh, axis="x", structure=st, schedule=s,
            check=True), k1_want(s))
        require(counts[f"dist_numeric_{s}"]["align_product_keys"] > 0,
                f"dist numeric {s} skipped K3")
    print(f"[dist] make_structure(n_dev={DIST_SHARDS}) {st_ms:.1f} ms "
          f"(its plan: {st.dist_plan().schedule}); warm ring and summa == "
          "the single-device call", flush=True)

    # -- poison, and 'cstat' on the numeric path --------------------------
    cut = dataclasses.replace(ring, bin_cap=128)
    bad = repro_torch.spgemm(a, b, mesh=mesh, axis="x", dist_plan=cut)
    require(int(bad.ngroups) > bad.cap,
            f"dist: bin_cap 128 not poisoned, ngroups {int(bad.ngroups)}")
    try:
        repro_torch.spgemm(a, b, mesh=mesh, axis="x", dist_plan=cut,
                           check=True)
        require(False, "dist: check=True did not raise on bin_cap 128")
    except repro_torch.AccumulatorOverflow:
        pass
    try:
        repro_torch.spgemm(a, b, mesh=mesh, axis="x", structure=st,
                           schedule="cstat")
        require(False, "dist: 'cstat' on the numeric path did not raise")
    except ValueError:
        pass
    print(f"[check] dist: bin_cap 128 poisons (ngroups {int(bad.ngroups)} "
          f"> {bad.cap}) and raises under check=True; numeric 'cstat' "
          "raises ValueError", flush=True)
    del bad

    # -- traced calls: the first plans (plan.dist_decision); each call's
    # stage spans, every one ending in a device sync, split its time
    stages = {}

    def traced(name, fn):
        obs.enable(reset=True)
        try:
            out, ms = timed_ms(fn)
            held(f"dist traced {name}", out)
            evs = obs.get_tracer().snapshot()["events"]
            ctr = obs.snapshot()["metrics"]["counters"]
        finally:
            obs.disable()
            obs.reset()
        split = {"call": ms}
        for e in evs:
            if e["ph"] == "X" and e["depth"] <= 1:
                split[e["name"]] = split.get(e["name"], 0.0) + \
                    e["dur_us"] / 1e3
        stages[name] = split
        print(f"[dist] traced {name} ({DIST_NOTE}): ms {json.dumps(split)}",
              flush=True)
        return {e["name"] for e in evs}, ctr

    names, ctr = traced("ring_planned", lambda: repro_torch.spgemm(
        a, b, mesh=mesh, axis="x", schedule="ring"))
    for want in ("dist.exchange", "plan.dist_decision"):
        require(want in names, f"dist traced call: no {want}")
    for want in ("dist.comm_bytes.ring", "dist.calls"):
        require(ctr.get(want, 0) > 0, f"dist traced call: no {want}")
    print(f"[dist] traced ring call: dist.exchange, plan.dist_decision; "
          f"dist.calls {ctr['dist.calls']}, dist.comm_bytes.ring "
          f"{ctr['dist.comm_bytes.ring']}", flush=True)
    for s in DIST_SCHEDULES:
        traced(s, lambda s=s: repro_torch.spgemm(
            a, b, mesh=mesh, axis="x",
            dist_plan=dataclasses.replace(dp, schedule=s)))
    traced("numeric_ring", lambda: repro_torch.spgemm(
        a, b, mesh=mesh, axis="x", structure=st, schedule="ring"))
    del a, b, c_one, st
    torch.cuda.empty_cache()

    # -- the 5,625-column cut: the pad, batched, ring_spgemm ----------------
    cols = n // CUT_PART
    A8 = A_csc[:, :cols]
    k8 = int(np.diff(A8.indptr).max())
    a8 = from_numpy(*np_ell_rows_from_scipy(A8, k8), n_rows=n, device=dev)
    b8 = from_numpy(*np_ell_cols_from_scipy(A8.T.tocsr(), k8), n_cols=n,
                    device=dev)
    c8 = repro_torch.spgemm(a8, b8, check=True)
    for s in DIST_SCHEDULES:
        held(f"dist cut {s}", repro_torch.spgemm(
            a8, b8, mesh=mesh, axis="x", schedule=s, check=True), c8)
    rng = np.random.default_rng(seed + 25)

    def fresh(idx):                       # new integer values on a pattern
        v = (rng.integers(1, 5, idx.shape)
             * rng.choice(np.array([-1, 1]), idx.shape)).astype(np.float32)
        return torch.where(idx >= 0, torch.from_numpy(v).to(dev), 0)

    x1 = repro_torch.EllRows(val=fresh(a8.idx), idx=a8.idx, n_rows=n)
    y1 = repro_torch.EllCols(val=fresh(b8.idx), idx=b8.idx, n_cols=n)
    ab = repro_torch.EllRows(val=torch.stack([a8.val, x1.val]),
                             idx=torch.stack([a8.idx, a8.idx]), n_rows=n)
    bb = repro_torch.EllCols(val=torch.stack([b8.val, y1.val]),
                             idx=torch.stack([b8.idx, b8.idx]), n_cols=n)
    dp8 = repro_torch.make_dist_plan(a8, b8, n_dev=DIST_SHARDS)
    kernels.reset_launch_counts()
    got, batch_ms = timed_ms(lambda: repro_torch.spgemm(
        ab, bb, mesh=mesh, axis="x", dist_plan=dp8, check=True))
    counts["dist_batched_cut"] = kernels.launch_counts()
    for i, (x, y) in enumerate(((a8, b8), (x1, y1))):
        want = repro_torch.spgemm(x, y, out_cap=dp8.out_cap, check=True)
        held(f"dist batched [{i}]", repro_torch.Coo(
            row=got.row[i], col=got.col[i], val=got.val[i], shape=got.shape,
            ngroups=got.ngroups[i]), want)
    del got, ab, bb, x1, y1
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    dense, ring_ms, ring_peak = timed_peak(
        lambda: dist.ring_spgemm(a8, b8, mesh, "x"))
    counts["dist_ring_spgemm_cut"] = kernels.launch_counts()
    ref_dense, dense_ms = timed_ms(lambda: repro_torch.spgemm_dense(a8, b8))
    same("dist ring_spgemm vs spgemm_dense", dense, ref_dense)
    del dense, ref_dense
    torch.cuda.empty_cache()
    summary = dict(
        note=DIST_NOTE, operand=BCSSTK32[1], shards=DIST_SHARDS,
        devices=devices, plan_ms=plan_ms, schedule=dp.schedule,
        grid=[dp.pr, dp.pc], base_backend=backend, local_cap=dp.local_cap,
        bin_cap=dp.bin_cap, block_cap=dp.block_cap, out_cap=dp.out_cap,
        modeled_comm_bytes_per_shard=comm,
        modeled_interm_gib=dp.base.est.get(f"interm_{backend}", 0.0) / 2**30,
        launches={kk: sum(c[kk] for c in counts.values())
                  for kk in kernels.WRAPPERS
                  if any(c[kk] for c in counts.values())},
        shard_products=shard_products, cold=cold, make_structure_ms=st_ms,
        warm=warm, stages_ms=stages,
        cut=dict(cols=cols, k=k8, batched_two_ms=batch_ms,
                 ring_spgemm_ms=ring_ms, ring_spgemm_peak=ring_peak,
                 spgemm_dense_ms=dense_ms))
    print(f"[check] dist cut ({cols} columns, k {k8} padded to "
          f"{-(-k8 // DIST_SHARDS) * DIST_SHARDS}): ring, cstat, summa == "
          "the single-device call; batched (2) == each slice's call; "
          "ring_spgemm == spgemm_dense", flush=True)
    print(f"[dist] {json.dumps(summary)}", flush=True)
    return counts, summary


# ---------------------------------------------------------------------------
# Phase 6e: token serving on the LM stack at deepseek-v2-lite's full size
# ---------------------------------------------------------------------------

LM_SERVE = dict(max_batch=8, max_new_tokens=32, s_max=2112)
LM_WAVES = ((8, 64, 512), (4, 1025, 2048))   # prompts, shortest, longest
LM_GATE_A = (96, 48)          # gate (a): prompt tokens, prefill on the first
LM_GATE_B = (2, 64)           # gate (b): prompts x tokens on the 2-layer cut
LM_GATE_D = ((8, 64), (8, 1))  # gate (d): tokens through one MoE layer
LM_PLANTS_A = ("cache slot early", "rope pos-1")   # gate (a)'s planted faults
LM_TOL_A = 5e-2               # gate (a): |decode - full| <= tol·max|full|
LM_TOL_B = 1e-3               # gate (b): |card - CPU| <= tol·max|CPU|
LM_TOL_D = 2e-2               # gate (d): |other - sort| <= tol·max|sort|
LM_NEAR_TIE = 1e-5            # gate (b): a top-k margin below this decides
                              # nothing across devices


def lm_config(dispatch: str = "sort", **over):
    from repro_torch.configs import deepseek_v2_lite
    base = deepseek_v2_lite.CONFIG
    return dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, dispatch=dispatch), **over)


def lm_prompts(seed: int, vocab: int, waves_spec=LM_WAVES):
    """The waves' prompts (``(count, shortest, longest)`` each): lengths and
    tokens drawn from ``seed``; each wave's longest is exactly its upper
    end, so its padded length is that (LM_WAVES' wave 2: ``_sdpa_chunked``
    cuts it into 512-token blocks)."""
    rng = np.random.default_rng(seed + 26)
    waves = []
    for n, lo, hi in waves_spec:
        lens = rng.integers(lo, hi + 1, n)
        lens[int(np.argmax(lens))] = hi
        waves.append([rng.integers(3, vocab, int(s)).astype(np.int32)
                      for s in lens])
    return waves


def routing_recorder():
    """Wrap ``models.ffn._topk_routing`` so every MoE layer's router logits
    and expert ids are kept; returns (list of (logits, ids), restore)."""
    from repro_torch.models import ffn
    orig, seen = ffn._topk_routing, []

    def rec(logits, k):
        w, ids = orig(logits, k)
        seen.append((logits, ids))
        return w, ids
    ffn._topk_routing = rec
    return seen, (lambda: setattr(ffn, "_topk_routing", orig))


def lm_gate_b(seed: int) -> dict:
    """Gate (b): the model cut to its first 2 layers (layer 0 dense, layer 1
    MoE with 'sort') at full width in float32, TF32 off, weights drawn on
    the card and copied to the CPU; two prompts of 64 tokens. The logits
    within LM_TOL_B·max|logits|, and the expert ids equal but where the
    CPU's own margin between its k-th and (k+1)-th routing probability is
    below LM_NEAR_TIE (no device decides such a tie; counted, printed)."""
    import torch
    from repro_torch.models import build_model, transformer
    from repro_torch.models.params import tree_map
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = lm_config(n_layers=2, param_dtype="float32",
                    compute_dtype="float32")
    params = build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(seed + 2))
    b, s = LM_GATE_B
    toks = torch.from_numpy(np.random.default_rng(seed + 3).integers(
        3, cfg.vocab, (b, s)).astype(np.int32))
    out = {}
    for where in ("card", "cpu"):
        p = params if where == "card" else tree_map(lambda a: a.cpu(), params)
        seen, restore = routing_recorder()
        t0 = time.perf_counter()
        try:
            with torch.inference_mode():
                logits = transformer.decoder_forward(
                    p, toks.to(dev) if where == "card" else toks, cfg)[0]
                logits = logits.float().cpu()
        finally:
            restore()
        out[where] = (logits, [(r.float().cpu(), i.cpu()) for r, i in seen],
                      time.perf_counter() - t0)
        del p, seen
    del params
    torch.cuda.empty_cache()
    (lc, rc, t_card), (lh, rh, t_cpu) = out["card"], out["cpu"]
    require(lc.shape == (b, s, cfg.vocab) and bool(torch.isfinite(lc).all()),
            "gate (b): card logits misshapen or not finite")
    require(len(rc) == len(rh) == 1, f"gate (b): the MoE layer routed "
            f"{len(rc)}/{len(rh)} times, not once")
    err = float((lc - lh).abs().max())
    tol = LM_TOL_B * float(lh.abs().max())
    k = cfg.moe.top_k
    probs = torch.softmax(rh[0][0], -1).sort(-1, descending=True).values
    margin = (probs[..., k - 1] - probs[..., k]).reshape(-1)
    differ = (rc[0][1] != rh[0][1]).any(-1).reshape(-1)
    res = dict(logits_err=err, tol=tol, max_abs_logit=float(lh.abs().max()),
               tokens=b * s, routing_differs=int(differ.sum()),
               min_topk_margin=float(margin.min()), card_s=t_card,
               cpu_s=t_cpu)
    print(f"[lm] gate (b) 2-layer cut, float32, card vs CPU: "
          f"{json.dumps(res)}", flush=True)
    require(err <= tol, f"gate (b): logits off by {err} > {tol}")
    far = margin[differ & (margin >= LM_NEAR_TIE)]
    require(far.numel() == 0, f"gate (b): expert ids differ on {far.numel()}"
            " tokens whose CPU top-k margin is no tie")
    return res


def plant_a(fault: str):
    """Plant one decode fault for gate (a) to read it; returns restore.
    'cache slot early': after each MLA decode step its latent and k_rope
    move one slot early and its own slot is zeroed, so later steps read
    token t at slot t-1. 'rope pos-1': the decode step's q and k RoPE
    angles are those of the position before it."""
    from repro_torch.models import attention as attn
    if fault == "cache slot early":
        orig = attn.mla_decode

        def bad(p, x, cfg, dtype, cache_latent, cache_krope, pos):
            out = orig(p, x, cfg, dtype, cache_latent, cache_krope, pos)
            for c in (cache_latent, cache_krope):
                c[:, pos - 1] = c[:, pos]
                c[:, pos] = 0
            return out
        attn.mla_decode = bad
        return lambda: setattr(attn, "mla_decode", orig)
    assert fault == "rope pos-1", fault
    orig = attn._pos_tensor
    attn._pos_tensor = lambda pos, device: orig(pos - 1, device)
    return lambda: setattr(attn, "_pos_tensor", orig)


def lm_gate_a(model, params) -> dict:
    """Gate (a): prefill on the first half of one prompt, then decode the
    rest a token at a time; each step's logits against the full forward's
    at its position, within LM_TOL_A·max|full| there. Run with capacity
    factor E/k, under which no MoE call drops a pair (the full forward's
    capacity is then its token count), so the check isolates the caches.
    Each planted fault of LM_PLANTS_A (``plant_a``) must read above the
    limit, so the limit is shown to fail a wrong cache."""
    import torch
    from repro_torch.models import build_model, transformer
    cfg = model.cfg
    m = cfg.moe
    cfg_a = dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))
    ma = build_model(cfg_a)
    dev = torch.device("cuda")
    s, s0 = LM_GATE_A
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        3, cfg.vocab, (1, s)).astype(np.int32)).to(dev)

    def rel(logits, t):
        return float((logits[0].float() - full[t]).abs().max()) \
            / float(full[t].abs().max())

    def decode_errs():
        logits, cache = ma.prefill(params, {"tokens": toks[:, :s0]}, s)
        errs = [rel(logits, s0 - 1)]
        for t in range(s0, s):
            logits, cache = ma.decode_step(params, cache, toks[:, t:t + 1])
            errs.append(rel(logits, t))
        return errs

    with torch.inference_mode():
        full = transformer.decoder_forward(params, toks, cfg_a)[0][0].float()
        errs = decode_errs()
        planted = {}
        for fault in LM_PLANTS_A:
            restore = plant_a(fault)
            try:
                planted[fault] = max(decode_errs())
            finally:
                restore()
    del full
    res = dict(positions=len(errs), max_rel_err=max(errs),
               mean_rel_err=sum(errs) / len(errs), tol=LM_TOL_A,
               planted_max_rel_err=planted)
    print(f"[lm] gate (a) prefill {s0} + decode {s - s0} vs full forward of "
          f"{s}, bf16: {json.dumps(res)}", flush=True)
    require(max(errs) <= LM_TOL_A, f"gate (a): decode off the full forward "
            f"by {max(errs)} of max|logits| > {LM_TOL_A}")
    for fault, err in planted.items():
        require(err > LM_TOL_A, f"gate (a): the planted fault '{fault}' "
                f"reads {err}, within the limit {LM_TOL_A}")
    return res


def k9_bf16_shape(what: str, cfg, t: int, g) -> dict:
    """Gate (c) at one MoE call's shapes on ``t`` tokens: K9's bfloat16
    entry against its plain twin on the routing planes of random logits of
    that shape and random bfloat16 X; dispatch bit for bit, combine within
    one bfloat16 rounding (2⁻⁸·|y|) of the float32 sum plus twice its
    summation-order error. Times the kernel, the twin and
    ``torch.sparse.mm`` of A as a CSR tensor (None where torch has no
    bfloat16 CSR product on the card); bytes bound the kernel."""
    import torch
    from repro_torch.kernels import ell_spmm as k9
    from repro_torch.models import ffn
    dev = torch.device("cuda")
    e, d = cfg.moe.n_experts, cfg.d_model
    w, _, _, kept, slot = ffn._spmm_route(
        torch.randn((1, t, e), generator=g, device=dev), cfg)
    n_slots = e * ffn.moe_capacity(t, cfg)
    out = []
    for part, a, n_rows, rows_in in (
            ("dispatch", ffn.dispatch_planes(kept[0], slot[0], n_slots,
                                             torch.bfloat16), n_slots, t),
            ("combine", ffn.combine_planes(kept[0], slot[0], w[0], n_slots,
                                           torch.bfloat16), t, n_slots)):
        x = torch.randn((rows_in, d), generator=g, device=dev) \
            .to(torch.bfloat16)
        val, idx = a.val, a.idx
        got = k9.ell_spmm(val, idx, x, n_rows)
        want = k9.ell_spmm_plain(val, idx, x, n_rows)
        f32 = k9.ell_spmm_plain(val.float(), idx, x.float(), n_rows)
        valid = (idx >= 0) & (idx < n_rows)
        terms = torch.bincount(idx[valid].long(), minlength=n_rows)
        mag = k9.ell_spmm_plain(val.float().abs(), idx, x.float().abs(),
                                n_rows)
        tol = 2.0 ** -8 * f32.abs() \
            + 2 * (terms - 1).clamp(min=0)[:, None] * 2.0 ** -24 * mag
        err = float((got.float() - want.float()).abs().max())
        shape = (f"{what} {part}: ({a.val.shape[0]},{a.val.shape[1]}) x "
                 f"({rows_in},{d}) -> ({n_rows},{d}) bf16, "
                 f"{int(valid.sum())} valid lanes")
        if part == "dispatch":
            same(f"ell_spmm bf16 {shape}", got, want)
        require(bool(((got.float() - f32).abs() <= tol).all()),
                f"ell_spmm bf16 {shape}: off the float32 sum by more than "
                "one bfloat16 rounding")
        n_used = int(valid.any(0).sum())
        t_b, by = bound(6 * val.numel() + 2 * n_used * d + 2 * n_rows * d,
                        2 * int(valid.sum()) * d)
        a_csr = sparse_rows(val, idx, n_rows)
        try:
            torch.sparse.mm(a_csr, x)
            lib = cuda_ms(lambda: torch.sparse.mm(a_csr, x), 3)
        except RuntimeError as exc:
            print(f"[lm] torch.sparse.mm has no bfloat16 CSR product here: "
                  f"{str(exc).splitlines()[0]}", flush=True)
            lib = None
        r = dict(shape=shape, dtype="bfloat16", max_abs_err=err,
                 ms=cuda_ms(lambda: k9.ell_spmm(val, idx, x, n_rows), 5),
                 plain_ms=cuda_ms(lambda: k9.ell_spmm_plain(val, idx, x,
                                                            n_rows), 3),
                 library_ms=lib, bound_ms=t_b, bound_by=by,
                 grids=k9.grids(*val.shape, n_rows, d))
        print(f"[kernel] ell_spmm bf16 {shape}: {json.dumps(r)}", flush=True)
        out.append(r)
        del a_csr, got, want, f32, mag, x
    return out


def plant_d():
    """Plant one dispatch fault for gate (d): the 'spmm' route drops its
    first kept (token, expert) pair from its capacity slot; returns
    restore."""
    from repro_torch.models import ffn
    orig = ffn._spmm_route

    def bad(logits, cfg):
        w, ids, onehot, kept, slot = orig(logits, cfg)
        kept = kept.clone()
        kept.view(-1)[int(kept.reshape(-1).nonzero()[0])] = False
        return w, ids, onehot, kept, slot
    ffn._spmm_route = bad
    return lambda: setattr(ffn, "_spmm_route", orig)


def lm_gate_d(params, seed: int) -> dict:
    """Gate (d): the 'spmm', 'sort' and 'ellpack' MoE layers on the model's
    first MoE layer in bfloat16, at each token shape of LM_GATE_D (the
    prefill's 8 x 64, capacity 60, and the decode's 8 x 1, capacity 1,
    where most pairs drop and every dispatch must drop the same ones),
    within LM_TOL_D·max|y| of 'sort' (each rounds its expert and combine
    products to bfloat16 at other points). y is the routed experts' sum
    alone: the shared experts are one code path in all three, and at the
    init's scale (fan-in over the stacked expert dims) they outweigh the
    routed sum by the printed ``shared_over_routed``, which would hide a
    dispatch fault. 'spmm' with
    one capacity slot dropped (``plant_d``) must read above the limit at
    each shape."""
    import torch
    from repro_torch.models import ffn
    from repro_torch.models.params import tree_map
    dev = torch.device("cuda")
    p = tree_map(lambda a: a[0], params["segments"][1])["u0"]["ffn"]
    shared = p["shared"]
    p = {k: v for k, v in p.items() if k != "shared"}

    def routed(dispatch):
        c = lm_config(dispatch)
        return dataclasses.replace(c, moe=dataclasses.replace(c.moe,
                                                              n_shared=0))
    cfg = routed("sort")
    g = torch.Generator(device=dev).manual_seed(seed + 4)
    out = {}
    for b, t in LM_GATE_D:
        x = torch.randn((b, t, cfg.d_model), generator=g, device=dev) \
            .to(torch.bfloat16)
        ys = {}
        with torch.inference_mode():
            for dispatch in ("sort", "spmm", "ellpack"):
                ys[dispatch] = ffn.moe_apply(p, x, routed(dispatch),
                                             torch.bfloat16)[0].float()
            restore = plant_d()
            try:
                ys["spmm, a slot dropped"] = ffn.moe_apply(
                    p, x, routed("spmm"), torch.bfloat16)[0].float()
            finally:
                restore()
        scale = float(ys["sort"].abs().max())
        errs = {k: float((y - ys["sort"]).abs().max()) / scale
                for k, y in ys.items() if k != "sort"}
        errs["capacity"] = ffn.moe_capacity(b * t, cfg)
        with torch.inference_mode():
            errs["shared_over_routed"] = float(ffn.swiglu_apply(
                shared, x, torch.bfloat16).float().abs().max()) / scale
        out[f"{b}x{t}"] = errs
    print(f"[lm] gate (d) dispatches, bf16, max|y - y_sort| / max|y_sort| "
          f"(tol {LM_TOL_D}): {json.dumps(out)}", flush=True)
    for shape, errs in out.items():
        for k in ("spmm", "ellpack"):
            require(errs[k] <= LM_TOL_D,
                    f"gate (d) {shape}: {k} off 'sort' by {errs[k]}")
        require(errs["spmm, a slot dropped"] > LM_TOL_D,
                f"gate (d) {shape}: a dropped slot reads "
                f"{errs['spmm, a slot dropped']}, within {LM_TOL_D}")
    return out


def serve_wave(model, params, prompts, name: str, serve=LM_SERVE,
               tag: str = "lm") -> dict:
    """One wave through ``ServingEngine.generate_batch`` (greedy, the
    ``serve`` config), the launch counters zeroed just before and read just
    after: its outputs, the engine's stats, ms and peak."""
    import torch
    from repro_torch import kernels
    from repro_torch.serve import ServeConfig, ServingEngine
    eng = ServingEngine(model, params, ServeConfig(**serve))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    outs = eng.generate_batch(prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    st = eng.stats()
    vocab = model.cfg.vocab
    for o in outs:
        require(1 <= len(o) <= serve["max_new_tokens"]
                and all(0 <= t < vocab for t in o),
                f"{name}: a request's tokens are out of range or count")
        require(len(o) == serve["max_new_tokens"]
                or o[-1] == ServeConfig().eos_id,
                f"{name}: a request stopped early without EOS")
    require(st["requests"] == len(prompts)
            and st["tokens"] == sum(len(o) for o in outs),
            f"{name}: stats {st}")
    steps = st["decode_steps"]
    res = dict(requests=len(prompts), prompt_lens=[len(p) for p in prompts],
               padded_len=max(len(p) for p in prompts),
               prefill_ms=st["prefill_s"] * 1e3,
               decode_ms_per_step=st["decode_s"] * 1e3 / max(1, steps),
               decode_steps=steps, tokens=st["tokens"],
               tokens_per_s=st["tokens"] / (st["prefill_s"] + st["decode_s"]),
               decode_tokens_per_s=st["tokens"] / max(st["decode_s"], 1e-9),
               wall_s=wall,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches={k: v for k, v in counts.items() if v},
               stats={k: v for k, v in st.items()
                      if not k.startswith("spgemm")
                      and k != "structure_cache"})
    print(f"[{tag}] {name}: {json.dumps(res)}", flush=True)
    return dict(res, outs=outs, counts=counts)


def lm_prefill_gap(model, model_spmm, params, prompts) -> dict:
    """Wave 1's prefill (the engine's left-padded batch) through 'sort' and
    'spmm': the last position's logits apart, as a share of max|logits|;
    the requests whose greedy first token differs; and 'sort''s top-1 over
    top-2 logit margin, the same share, there and its median over the wave.
    Greedy tokens part where the gap exceeds the margin."""
    import torch
    from repro_torch.serve import ServeConfig
    plen = max(len(q) for q in prompts)
    toks = np.full((len(prompts), plen), ServeConfig().eos_id, np.int32)
    for i, q in enumerate(prompts):
        toks[i, plen - len(q):] = q
    batch = {"tokens": torch.from_numpy(toks).to("cuda")}
    with torch.inference_mode():
        ls = model.prefill(params, batch, LM_SERVE["s_max"])[0].float()
        lp = model_spmm.prefill(params, batch, LM_SERVE["s_max"])[0].float()
    scale = float(ls.abs().max())
    top2 = ls.topk(2, -1).values
    margin = (top2[:, 0] - top2[:, 1]) / scale
    differ = ls.argmax(-1) != lp.argmax(-1)
    res = dict(rel_logit_gap=float((ls - lp).abs().max()) / scale,
               first_tokens_differ=int(differ.sum()),
               sort_margin_where_differ=margin[differ].tolist(),
               sort_margin_median=float(margin.median()))
    print(f"[lm] wave 1 prefill, 'spmm' against 'sort': {json.dumps(res)}",
          flush=True)
    return res


def lm_phase(seed: int):
    """deepseek-v2-lite-16b at published widths and all 27 layers, bfloat16
    on the card (see the module docstring, phase 6e). Returns (K9's
    bfloat16 shape entries, {path: counts}, summary)."""
    import torch
    from repro_torch.models import build_model
    dev = torch.device("cuda")
    summary = {"gate_b": lm_gate_b(seed)}
    torch.backends.cuda.matmul.allow_tf32 = True
    cfg = lm_config()
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    summary["init_s"] = time.perf_counter() - t0
    summary["n_params"] = model.n_params()
    summary["weights_gib"] = torch.cuda.memory_allocated() / 2**30
    print(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k}, "
          f"{summary['n_params']} parameters drawn in bf16 in "
          f"{summary['init_s']:.1f} s, {summary['weights_gib']:.2f} GiB "
          "on the card", flush=True)
    summary["gate_a"] = lm_gate_a(model, params)
    summary["gate_d"] = lm_gate_d(params, seed)
    waves = lm_prompts(seed, cfg.vocab)
    summary["waves"], counts = {}, {}
    for i, prompts in enumerate(waves):
        r = serve_wave(model, params, prompts, f"wave {i + 1} sort")
        summary["waves"][f"wave{i + 1}_sort"] = {
            k: v for k, v in r.items() if k not in ("outs", "counts")}
        counts[f"lm_wave{i + 1}_sort"] = r["counts"]
        if i == 0:
            sort_outs = r["outs"]
    # 'sort' against itself: the yardstick of 'spmm''s agreement below
    r = serve_wave(model, params, waves[0], "wave 1 sort again")
    summary["waves"]["wave1_sort_again"] = {
        k: v for k, v in r.items() if k not in ("outs", "counts")}
    same_sort = sum(x == y for o, q in zip(sort_outs, r["outs"])
                    for x, y in zip(o, q))
    summary["wave1_sort_again_tokens_equal"] = [
        same_sort, sum(len(o) for o in sort_outs)]
    model_spmm = build_model(lm_config("spmm"))
    r = serve_wave(model_spmm, params, waves[0], "wave 1 spmm")
    summary["waves"]["wave1_spmm"] = {
        k: v for k, v in r.items() if k not in ("outs", "counts")}
    counts["lm_wave1_spmm"] = r["counts"]
    # K9 twice a MoE layer a step: the prefill's T = B·S tokens, then T = B
    n_moe = cfg.n_layers - cfg.moe.first_dense_layers
    b, plen = len(waves[0]), max(len(p) for p in waves[0])
    steps = r["decode_steps"]
    want = n_moe * (k9_grids(cfg, b * plen) + steps * k9_grids(cfg, b))
    require(r["counts"]["ell_spmm"] == want,
            f"wave 1 spmm launched K9's grids {r['counts']['ell_spmm']} "
            f"times, not {want} ({n_moe} MoE layers, {steps} decode steps)")
    summary["wave1_prefill_spmm_vs_sort"] = lm_prefill_gap(
        model, model_spmm, params, waves[0])
    same_tok = sum(x == y for o, q in zip(sort_outs, r["outs"])
                   for x, y in zip(o, q))
    summary["wave1_spmm_vs_sort_tokens_equal"] = [
        same_tok, sum(len(o) for o in sort_outs)]
    print(f"[lm] wave 1: 'spmm' launched K9 {r['counts']['ell_spmm']} grids "
          f"({n_moe} MoE layers x (prefill + {steps} steps) x 2 calls); its "
          f"greedy tokens equal 'sort''s at {same_tok} of "
          f"{sum(len(o) for o in sort_outs)}; 'sort' again equals its "
          f"first run at {same_sort}", flush=True)
    # gate (c): K9 bf16 at both waves' prefill and decode shapes
    g = torch.Generator(device=dev).manual_seed(seed + 5)
    shapes = []
    for i, prompts in enumerate(waves):
        b, plen = len(prompts), max(len(p) for p in prompts)
        shapes += k9_bf16_shape(f"wave {i + 1} prefill T={b * plen}", cfg,
                                b * plen, g)
        shapes += k9_bf16_shape(f"wave {i + 1} decode T={b}", cfg, b, g)
    del params
    torch.cuda.empty_cache()
    return shapes, counts, summary


# ---------------------------------------------------------------------------
# Phase 6f: training on the LM stack
# ---------------------------------------------------------------------------

TRAIN_ARCH = "granite-moe-3b-a800m"
TRAIN_A = dict(batch=8, seq=512, steps=6)   # (a): 4,096 tokens a step
TRAIN_B_STEPS = 3                           # (b): 'spmm' steps at full width
TRAIN_CUT = 2                               # (c)-(e): layers of the cut
TRAIN_C = (2, 128)                          # (c): tokens, card vs CPU
TRAIN_D = dict(steps=30, batch=8, seq=64, lr=3e-3, warmup_steps=5)
TRAIN_E = dict(save=4, steps=6, batch=8, seq=64)
TRAIN_TOL_C = (1e-5, 1e-3)    # (c): loss relative, grad vs max|g_cpu|
TRAIN_DROP_D = 0.2            # (d): the reference's bar (tests/test_system.py)
K9_BWD = (6, 4096, 30720, 2048)             # (f): k, n, n_rows, d
K10_BF16 = (4096, 2048, 10944, (2, 4))      # (f): t, d_in, d_out, N:M
BF16_ROUND = 2.0 ** -8        # one rounding to bfloat16, relative
BF16_TC_OPS_PER_S = 989e12    # dense bf16 tensor-core rate


def train_config(dispatch: str = "sort", **over):
    from repro_torch.configs import get_config
    base = get_config(TRAIN_ARCH)
    return dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, dispatch=dispatch), **over)


def bits(t):
    """A tensor's raw bits, for bit-for-bit comparison of any float type."""
    import torch
    kind = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.detach().contiguous().view(kind[t.element_size()])


def moe_grad_gate(model, params, batch) -> dict:
    """Gate (b): one ``loss.backward`` through ``model``; the router and
    the experts' ``w_gate``/``w_up``/``w_down`` grads of every layer must
    be finite and not all zero. Returns the layers that fail, by leaf."""
    import torch
    from repro_torch.models.params import tree_leaves
    leaves = tree_leaves(params)
    loss = model.loss(params, batch)
    grads = dict(zip(map(id, leaves), torch.autograd.grad(
        loss, leaves, allow_unused=True)))       # None: reached by nothing
    ffn_p = params["segments"][0]["u0"]["ffn"]
    bad = {}
    for name in ("router", "w_gate", "w_up", "w_down"):
        g = grads[id(ffn_p[name])]
        layers = ffn_p[name].shape[0]
        if g is None:
            bad[name] = list(range(layers))
            continue
        finite = torch.isfinite(g).flatten(1).all(1)
        live = (g != 0).flatten(1).any(1)
        bad[name] = [i for i in range(layers)
                     if not (bool(finite[i]) and bool(live[i]))]
    del grads
    return {"loss": loss.item(), "bad_layers": bad,
            "ok": not any(bad.values())}


def train_full(seed: int):
    """(a) and (b): granite-moe-3b at published widths and all 32 layers,
    bfloat16, through ``launch.train.main``; then 'spmm' for
    TRAIN_B_STEPS steps from its state, the grad gate and its planted
    fault. Returns (summary, {path: counts})."""
    import tempfile
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import ops
    from repro_torch.launch import train as tlaunch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_leaves, tree_unflatten
    from repro_torch.optim import AdamWConfig, adamw_update
    torch.backends.cuda.matmul.allow_tf32 = True
    a = TRAIN_A
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with tempfile.TemporaryDirectory() as d:
        out = tlaunch.main([
            "--arch", TRAIN_ARCH, "--steps", str(a["steps"]),
            "--batch", str(a["batch"]), "--seq", str(a["seq"]),
            "--ckpt-dir", d, "--ckpt-every", str(10 * a["steps"]),
            "--no-resume", "--log-every", "1"])
    torch.cuda.synchronize()
    counts = {"train_sort": kernels.launch_counts()}
    trainer, hist = out["trainer"], out["history"]
    model, params, opt = trainer.model, out["params"], out["opt_state"]
    cfg = model.cfg
    tokens = a["batch"] * a["seq"]
    step_ms = [h["ms"] for h in hist]
    med = median(step_ms[1:])
    s = dict(arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
             dispatch=cfg.moe.dispatch, remat=cfg.remat,
             dtype=cfg.param_dtype, n_params=model.n_params(),
             batch=a["batch"], seq=a["seq"], tokens_per_step=tokens,
             init_s=trainer.init_s, losses=[h["loss"] for h in hist],
             grad_norms=[h["grad_norm"] for h in hist], step_ms=step_ms,
             median_step_ms_1_5=med, tokens_per_s=tokens / med * 1e3,
             peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    require(len(hist) == a["steps"], f"(a) logged {len(hist)} steps")
    require(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                for h in hist), f"(a) a loss or grad norm is not finite: "
            f"{s['losses']} {s['grad_norms']}")
    require(counts["train_sort"]["ell_spmm"] == 0,
            "(a) 'sort' training launched K9")
    # one more step split: forward + backward, then the AdamW update
    batch = trainer._batch(a["steps"])
    leaves = tree_leaves(params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    gtree = tree_unflatten(params, grads)
    adamw_update(params, gtree, opt, trainer.opt_cfg)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    s["split_ms"] = {"forward_backward": (t1 - t0) * 1e3,
                     "adamw_update": (t2 - t1) * 1e3}
    del grads, gtree, loss
    s["resident_gib"] = torch.cuda.memory_allocated() / 2**30
    print(f"[train] (a) {cfg.name} {cfg.n_layers} layers d_model "
          f"{cfg.d_model}, {s['n_params']} parameters bf16, 'sort', remat "
          f"'full', {a['batch']} x {a['seq']}: {json.dumps(s)}", flush=True)

    # (b) 'spmm' from the same state: K9 forward and its autograd backward
    model_b = build_model(train_config("spmm"))
    step = make_train_step(model_b, AdamWConfig())
    batches = [trainer._batch(a["steps"] + 1 + i)
               for i in range(TRAIN_B_STEPS)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    b_ms, b_losses = [], []
    for bt in batches:
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, bt)
        b_losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        b_ms.append((time.perf_counter() - t0) * 1e3)
    counts["train_spmm"] = kernels.launch_counts()
    n_moe = cfg.n_layers - cfg.moe.first_dense_layers
    # each MoE layer's forward launches K9's dispatch and combine grids;
    # the checkpoint's recompute in the backward launches them again, as
    # far as the saved tensors it needs (its early stop may spare the
    # combine, whose output nothing saves)
    fwd = TRAIN_B_STEPS * n_moe * k9_grids(cfg, tokens)
    got = counts["train_spmm"]["ell_spmm"]
    require(all(math.isfinite(x) for x in b_losses),
            f"(b) a loss is not finite: {b_losses}")
    require(fwd < got <= 2 * fwd, f"(b) 'spmm' launched K9's grids {got} "
            f"times, not in ({fwd}, {2 * fwd}] ({TRAIN_B_STEPS} steps x "
            f"{n_moe} layers, forward and recompute)")
    gate = moe_grad_gate(model_b, params, batches[0])
    require(gate["ok"], f"(b) MoE grads dead or not finite: {gate}")
    orig = ops.ell_spmm

    def detached(*args):
        return orig(*args).detach()
    ops.ell_spmm = detached
    try:
        planted = moe_grad_gate(model_b, params, batches[0])
    finally:
        ops.ell_spmm = orig
    require(not planted["ok"], "(b) the gate passed with K9's output "
            "detached: it cannot see a missing gradient")
    sb = dict(step_ms=b_ms, losses=b_losses, k9_grids=got,
              k9_grids_one_forward=fwd,
              gate_loss=gate["loss"], planted_bad_layers={
                  k: len(v) for k, v in planted["bad_layers"].items()})
    print(f"[train] (b) 'spmm' {TRAIN_B_STEPS} steps from (a)'s state, K9 "
          f"forward + autograd backward: {json.dumps(sb)}; gate passed, and "
          f"with K9's output detached it fails", flush=True)
    s["spmm"] = sb
    del params, opt, out, trainer, model, model_b, step, batches
    gc.collect()
    torch.cuda.empty_cache()
    return s, counts


def train_cut_card_vs_cpu(seed: int) -> dict:
    """(c): the 2-layer cut at published widths, float32, TF32 off, one
    loss and backward from the same weights on the card and on the CPU,
    for 'sort' and 'spmm'."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_leaves, tree_map
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    b, sq = TRAIN_C
    res = {}
    for dispatch in ("sort", "spmm"):
        cfg = train_config(dispatch, n_layers=TRAIN_CUT,
                           param_dtype="float32", compute_dtype="float32")
        model = build_model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(seed + 7))
        toks = torch.from_numpy(np.random.default_rng(seed + 8).integers(
            3, cfg.vocab, (b, sq)).astype(np.int32))
        out = {}
        for where in ("card", "cpu"):
            p = params if where == "card" \
                else tree_map(lambda t: t.detach().cpu(), params)
            leaves = tree_leaves(p)
            for t in leaves:
                t.requires_grad_(True)
            t0 = time.perf_counter()
            loss = model.loss(p, {"tokens": toks.to(dev) if where == "card"
                                  else toks})
            grads = [g.cpu() for g in torch.autograd.grad(loss, leaves)]
            out[where] = (float(loss), grads, time.perf_counter() - t0)
        (lc, gc_, tc), (lh, gh, th) = out["card"], out["cpu"]
        loss_rel = abs(lc - lh) / abs(lh)
        grad_rel = max(float((x - y).abs().max()) / float(y.abs().max())
                       for x, y in zip(gc_, gh) if float(y.abs().max()) > 0)
        res[dispatch] = dict(loss_card=lc, loss_cpu=lh, loss_rel=loss_rel,
                             worst_grad_rel=grad_rel, card_s=tc, cpu_s=th)
        require(loss_rel <= TRAIN_TOL_C[0], f"(c) {dispatch}: loss off by "
                f"{loss_rel} relative")
        require(grad_rel <= TRAIN_TOL_C[1], f"(c) {dispatch}: a grad off by "
                f"{grad_rel} of its max")
        del params, out, model
    torch.backends.cuda.matmul.allow_tf32 = True
    print(f"[train] (c) {TRAIN_CUT}-layer cut, float32, card vs CPU, "
          f"{b} x {sq} tokens: {json.dumps(res)}", flush=True)
    return res


def train_cut_learns_and_resumes(seed: int) -> dict:
    """(d) and (e): the 2-layer cut in bfloat16 learns over TRAIN_D's steps
    (the last logged loss below the first by TRAIN_DROP_D), and a run
    saved at step TRAIN_E['save'] resumes in a fresh ``Trainer`` from
    leaves equal to the saved ones bit for bit, its history starting
    there."""
    import tempfile
    import torch
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import Trainer, TrainerConfig
    model = build_model(train_config(n_layers=TRAIN_CUT))
    d_cfg = TRAIN_D
    res = {}
    with tempfile.TemporaryDirectory() as d:
        tcfg = TrainerConfig(steps=d_cfg["steps"], log_every=5,
                             ckpt_every=10 * d_cfg["steps"], ckpt_dir=d,
                             global_batch=d_cfg["batch"],
                             seq_len=d_cfg["seq"], seed=seed)
        out = Trainer(model, tcfg, AdamWConfig(
            lr=d_cfg["lr"], warmup_steps=d_cfg["warmup_steps"])).run(
                resume=False)
    losses = [h["loss"] for h in out["history"]]
    res["d"] = dict(losses=losses, drop=losses[0] - losses[-1])
    print(f"[train] (d) {TRAIN_CUT}-layer cut, bf16, {d_cfg['steps']} steps "
          f"lr {d_cfg['lr']}: {json.dumps(res['d'])}", flush=True)
    require(all(math.isfinite(x) for x in losses) and
            losses[-1] < losses[0] - TRAIN_DROP_D,
            f"(d) the loss did not drop by {TRAIN_DROP_D}: {losses}")
    del out
    e = TRAIN_E
    with tempfile.TemporaryDirectory() as d:
        base = TrainerConfig(steps=e["save"], log_every=1,
                             ckpt_every=e["save"], ckpt_dir=d, keep_n=1,
                             global_batch=e["batch"], seq_len=e["seq"],
                             seed=seed)
        first_tr = Trainer(model, base)
        save_ms = []
        orig_save = first_tr.ckpt.save

        def timed_save(*args, **kw):
            r, ms = timed_ms(lambda: orig_save(*args, **kw))
            save_ms.append(ms)
            return r
        first_tr.ckpt.save = timed_save
        first = first_tr.run(resume=False)
        nbytes = sum(f.stat().st_size for f in
                     (Path(d) / f"step_{e['save']:08d}").iterdir())
        second = Trainer(model, dataclasses.replace(base, steps=e["steps"]))
        restored, restore_ms = [], []
        orig_restore = second.ckpt.restore

        def kept_restore(*args, **kw):
            r, ms = timed_ms(lambda: orig_restore(*args, **kw))
            restore_ms.append(ms)
            restored.append(tree_map(lambda t: t.detach().clone(), r[:2]))
            return r
        second.ckpt.restore = kept_restore
        resumed = second.run(resume=True)
        require(len(save_ms) == 1 and len(restored) == 1,
                f"(e) {len(save_ms)} saves, {len(restored)} restores")
        saved = tree_leaves((first["params"], first["opt_state"]))
        back = tree_leaves(restored[0])
        require(len(saved) == len(back), "(e) restored tree differs")
        n_bf16 = 0
        for x, y in zip(saved, back):
            require(x.dtype == y.dtype and y.device == x.device and
                    torch.equal(bits(x), bits(y)),
                    f"(e) a restored leaf differs from the saved one "
                    f"({x.dtype} {tuple(x.shape)})")
            n_bf16 += x.dtype == torch.bfloat16
        steps = [h["step"] for h in resumed["history"]]
        require(steps and steps[0] == e["save"],
                f"(e) the resumed history starts at {steps[:1]}, not "
                f"{e['save']}")
    res["e"] = dict(save_ms=save_ms[0], restore_ms=restore_ms[0],
                    checkpoint_bytes=nbytes, leaves=len(saved),
                    bf16_leaves=n_bf16, resumed_steps=steps)
    print(f"[train] (e) checkpoint at step {e['save']} and resume: "
          f"{json.dumps(res['e'])}; every leaf restored bit for bit",
          flush=True)
    torch.cuda.empty_cache()
    return res


def k9_backward_shape(seed: int) -> dict:
    """(f) K9's training route (``ops.ell_spmm``, the ``EllSpmm``
    Function: K9 forward, backward in torch ops) against the plain twin's
    own autograd on the card at the dispatch shape K9_BWD, with dead
    lanes: dX and dval bit for bit on integer-valued float32 operands; in
    bfloat16, each gradient within one bfloat16 rounding (BF16_ROUND·|g|)
    of the float32 gradients of the widened operands. The backward's ms,
    the twin's, and the bytes bound of the backward (dY read at the valid
    lanes' rows, X and the planes read, dX and dval written)."""
    import torch
    from repro_torch.kernels import ell_spmm as k9
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    k, n, n_rows, d = K9_BWD
    rng = np.random.default_rng(seed + 9)
    idx = rng.integers(0, n_rows, (k, n)).astype(np.int32)
    idx[rng.random((k, n)) < 0.25] = -1
    ti = torch.from_numpy(idx).to(dev)
    val = int_tensor(rng, (k, n), dev)
    x = int_tensor(rng, (n, d), dev)
    dy = int_tensor(rng, (n_rows, d), dev)

    def grads(route, v, xx, g):
        v = v.detach().requires_grad_(True)
        xx = xx.detach().requires_grad_(True)
        y = ops.ell_spmm(v, ti, xx, n_rows) if route == "kernel" \
            else k9.ell_spmm_plain(v, ti, xx, n_rows)
        return torch.autograd.grad(y, (v, xx), g)

    got, want = grads("kernel", val, x, dy), grads("plain", val, x, dy)
    for name, g, w in zip(("dval", "dX"), got, want):
        same(f"ell_spmm backward {name}", g, w)
    fv = (val * torch.rand(val.shape, device=dev)).bfloat16()
    fx = (x * torch.rand(x.shape, device=dev)).bfloat16()
    fdy = (dy * torch.rand(dy.shape, device=dev)).bfloat16()
    g16 = grads("kernel", fv, fx, fdy)
    g32 = grads("kernel", fv.float(), fx.float(), fdy.float())
    err16 = 0.0
    for name, g, w in zip(("dval", "dX"), g16, g32):
        require(g.dtype == torch.bfloat16 and bool(
            ((g.float() - w).abs() <= BF16_ROUND * w.abs()).all()),
            f"ell_spmm backward bf16 {name}: off the float32 gradient by "
            "more than one bfloat16 rounding")
        err16 = max(err16, float((g.float() - w).abs().max()))
    live = int((ti >= 0).sum())
    t_b, by = bound(4 * (live * d + n * d + 2 * k * n) + 4 * (n * d + k * n),
                    4 * live * d)
    y = ops.ell_spmm(val.requires_grad_(True), ti, x.requires_grad_(True),
                     n_rows)
    r = dict(shape=f"backward of dispatch ({k},{n}) x ({n},{d}) -> "
             f"({n_rows},{d}), {live} valid lanes", max_abs_err=0.0,
             bf16_max_abs_err=err16,
             ms=cuda_ms(lambda: torch.autograd.grad(y, (val, x), dy,
                                                    retain_graph=True), 3),
             plain_ms=cuda_ms(lambda: grads("plain", val, x, dy), 3),
             bound_ms=t_b, bound_by=by)
    print(f"[kernel] ell_spmm backward (torch ops) {r['shape']}: dX, dval "
          f"bit-identical to the twin's autograd; {json.dumps(r)}",
          flush=True)
    del y, val, x, dy, got, want, g16, g32
    torch.cuda.empty_cache()
    return r


def k10_bf16_shape(seed: int) -> dict:
    """(f) K10's bfloat16 entry at fc_in's shape K10_BF16: within one
    bfloat16 rounding of K10's float32 result on the widened operands
    (max|y − y32| ≤ BF16_ROUND·max|y32|), and within two of the plain
    twin's bfloat16 result on the same inputs (both round float32 sums,
    summed in different orders, to bfloat16: max|y − y_plain| ≤
    2·BF16_ROUND·max|y_plain|); its ms beside the plain twin's
    and ``x @ wp`` in bfloat16, bound by the condensed product at the bf16
    tensor cores' rate (passed as the operations that take the same time
    at the CUDA-core rate) or by bytes."""
    import torch
    import repro_torch
    from repro_torch.kernels import nm_spmm as k10
    dev = torch.device("cuda")
    t, d_in, d_out, (n, m) = K10_BF16
    g = torch.Generator(device=dev).manual_seed(seed + 10)
    x = torch.randn((t, d_in), generator=g, device=dev).bfloat16()
    w = torch.randn((d_in, d_out), generator=g, device=dev)
    wp = repro_torch.magnitude_prune_nm(w, n, m)
    wn = repro_torch.nm_from_dense(wp, n, m)
    val, off = wn.val.bfloat16(), wn.off
    wp16 = wp.bfloat16()
    del w
    before = k10.nm_spmm.launches
    y = k10.nm_spmm(x, val, off, n=n, m=m)
    torch.cuda.synchronize()
    require(k10.nm_spmm.launches == before + 1 and y.dtype == torch.bfloat16,
            "nm_spmm bf16: not one launch with a bfloat16 result")
    y32 = k10.nm_spmm(x.float(), val.float(), off, n=n, m=m)
    err = float((y.float() - y32).abs().max())
    tol = BF16_ROUND * float(y32.abs().max())
    require(err <= tol, f"nm_spmm bf16: max|y - y32| {err} > {tol}")
    yp = k10.nm_spmm_plain(x, val, off, n=n, m=m).float()
    plain_err = float((y.float() - yp).abs().max())
    plain_tol = 2 * BF16_ROUND * float(yp.abs().max())   # two roundings
    require(plain_err <= plain_tol,
            f"nm_spmm bf16: max|y - plain| {plain_err} > {plain_tol}")
    r_ = wn.r
    t_b, by = bound(2 * t * d_in + 3 * r_ * d_out + 2 * t * d_out,
                    2 * t * r_ * d_out * CORE_OPS_PER_S / BF16_TC_OPS_PER_S)
    r = dict(shape=f"fc_in bf16: ({t},{d_in}) x {n}:{m} ({r_},{d_out})",
             dtype="bfloat16", max_abs_err=err, tol=tol,
             plain_err=plain_err, plain_tol=plain_tol,
             ms=cuda_ms(lambda: k10.nm_spmm(x, val, off, n=n, m=m), 3),
             plain_ms=cuda_ms(lambda: k10.nm_spmm_plain(x, val, off, n=n,
                                                        m=m), 2),
             library_ms=cuda_ms(lambda: x @ wp16, 5),
             bound_ms=t_b, bound_by=by)
    print(f"[kernel] nm_spmm bf16 {r['shape']}: within one bfloat16 "
          f"rounding of the float32 result, two of the plain twin's "
          f"bfloat16 result; {json.dumps(r)}", flush=True)
    del x, y, y32, yp, wp, wp16, val, off, wn
    torch.cuda.empty_cache()
    return r


def train_phase(seed: int):
    """Training on the LM stack (see the module docstring, phase 6f).
    Returns (K9 shape entries, K10 shape entries, {path: counts},
    summary)."""
    import torch
    summary, counts = {}, {}
    summary["a_b"], counts = train_full(seed)
    summary["c"] = train_cut_card_vs_cpu(seed)
    summary.update(train_cut_learns_and_resumes(seed))
    g = torch.Generator(device=torch.device("cuda")).manual_seed(seed + 11)
    k9_rows = k9_bf16_shape(f"train T={TRAIN_A['batch'] * TRAIN_A['seq']}",
                            train_config(), TRAIN_A["batch"] * TRAIN_A["seq"],
                            g)
    k9_rows.append(k9_backward_shape(seed))
    return k9_rows, [k10_bf16_shape(seed)], counts, summary


# ---------------------------------------------------------------------------
# Phase 6g: the SSM, RG-LRU and encoder-decoder families
# ---------------------------------------------------------------------------

FAM_ARCHS = ("falcon-mamba-7b", "recurrentgemma-9b", "whisper-medium")
FAM_SERVE = dict(max_batch=8, max_new_tokens=32, s_max=4128)
FAM_WAVES = ((8, 64, 512), (2, 2049, 4096))    # prompts, shortest, longest
FAM_AUDIO = (8, 32, 448)      # whisper: prompts, tokens each, s_max (its
                              # text context)
FAM_GATE_A = {"falcon-mamba-7b": (512, 768),  # gate (a): prefill, full
              "recurrentgemma-9b": (2560, 3072),  # forward (whole chunks)
              "whisper-medium": (32, 64)}
FAM_DECODE_A = 32             # gate (a): decode steps after the prefill
FAM_MAMBA_DT = (1e-3, 1e-1)   # gate (a) on falcon-mamba: Mamba's Δ range
FAM_TOL_A_LONG = 0.2          # gate (a) on falcon-mamba's long-memory
                              # weights: an H100's sound reading 0.068,
                              # the planted fault 0.68 (PERF.md §6)
FAM_CUT = {"falcon-mamba-7b": dict(n_layers=2),        # gates (b), (c)
           "recurrentgemma-9b": dict(n_layers=3),      # one (rec, rec,
           "whisper-medium": dict(n_layers=2,          # local) unit
                                  n_encoder_layers=2)}
FAM_GATE_B = {"falcon-mamba-7b": (2, 128), "recurrentgemma-9b": (1, 64),
              "whisper-medium": (1, 64)}   # prompts x prefill tokens
FAM_DECODE_B = 8              # gate (b): decode steps after the prefill
FAM_GRADS_C = ("falcon-mamba-7b", "whisper-medium")   # (c): every leaf's
                              # grad; recurrentgemma's cut: the loss alone
FAM_TRAIN = {"falcon-mamba-7b": 16, "recurrentgemma-9b": 6}   # layers kept
FAM_TRAIN_SHAPE = dict(batch=4, seq=512, steps=4)     # through Trainer
FAM_TRAIN_AUDIO = dict(batch=8, seq=256, steps=4)     # through launch.train


def fam_config(arch: str, **over):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), **over)


def fam_frames(cfg, n: int, seed: int):
    """The audio stub's (n, encoder_seq, d_model) frames from ``seed``, as
    float32 on the card."""
    import torch
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(
        (n, cfg.encoder_seq, cfg.d_model), dtype=np.float32)).to(
            torch.device("cuda"))


def fam_plant(cfg, cache):
    """Gate (a)'s planted fault, on the prefill's cache: falcon-mamba's SSM
    states zeroed, recurrentgemma's RG-LRU states ``h`` zeroed, whisper's
    decode position one behind (each step then writes its keys over the
    token before and takes that token's sinusoidal position)."""
    from repro_torch.models.params import tree_items
    if cfg.family == "audio":
        return dict(cache, pos=cache["pos"] - 1)
    key = "/ssm" if cfg.family == "ssm" else "/h"
    hit = [t.zero_() for path, t in tree_items(cache["layers"])
           if path.endswith(key)]
    require(hit, f"no {key[1:]} state in the cache to plant a fault in")
    return cache


def mamba_long_memory(params, cfg):
    """Gate (a) on falcon-mamba, on the served weights in place: each mixer
    at the scale an unstacked layer is drawn at (the stacked init's 1/√L
    undone, as the nearest power of two, 8 at 64 layers: exact in bf16
    and undone exactly), with Mamba's published S4D-real A = -(1..d_state)
    and Δ spread over FAM_MAMBA_DT across the channels. Under the
    reference's init (A = -e, Δ ≈ 1.3, every mixer weight 1/8 of an
    unstacked layer's) the SSM state keeps ~3% a step and moves the logits
    by ~1e-6 of their max, so no fault in it could show. Returns
    restore."""
    import torch
    mix = params["segments"][0]["u0"]["mixer"]
    scale = 2.0 ** round(math.log2(math.sqrt(cfg.n_layers)))
    scaled = ("w_in", "conv_w", "w_x", "w_dt", "w_out")
    kept = {k: mix[k].clone() for k in ("a_log", "b_dt")}
    for k in scaled:
        mix[k].mul_(scale)
    a = torch.arange(1, cfg.ssm.d_state + 1, dtype=torch.float32,
                     device=mix["a_log"].device)
    mix["a_log"].copy_(torch.log(a).expand(mix["a_log"].shape))
    lo, hi = FAM_MAMBA_DT
    dt = torch.exp(torch.linspace(math.log(lo), math.log(hi),
                                  mix["b_dt"].shape[-1],
                                  device=mix["b_dt"].device))
    mix["b_dt"].copy_((dt + torch.log(-torch.expm1(-dt))).expand(
        mix["b_dt"].shape))        # softplus(b_dt) = Δ

    def restore():
        for k in scaled:
            mix[k].div_(scale)
        for k, v in kept.items():
            mix[k].copy_(v)
    return restore


def fam_gate_a(model, params, seed: int) -> dict:
    """Gate (a): prefill P tokens of one prompt, then decode FAM_DECODE_A
    more a token at a time; the prefill's and each step's logits against
    the full forward's at that position (over whole scan chunks), within
    LM_TOL_A·max|full| there. The planted fault (``fam_plant``) must read
    above the limit. falcon-mamba is gated so on the reference's init,
    where its planted fault cannot show (printed beside), and again on its
    long-memory weights (``mamba_long_memory``) with FAM_TOL_A_LONG, the
    sound readings below and the planted fault above."""
    import torch
    from repro_torch.models import encdec, transformer
    cfg = model.cfg
    p_len, s = FAM_GATE_A[cfg.name]
    toks = torch.from_numpy(np.random.default_rng(seed + 34).integers(
        3, cfg.vocab, (1, s)).astype(np.int32)).to(torch.device("cuda"))
    extra = {}
    if cfg.family == "audio":
        extra["frames"] = fam_frames(cfg, 1, seed + 35)

    @torch.inference_mode()
    def readings():
        """(sound errors by position, the planted fault's worst)."""
        if cfg.family == "audio":
            enc = encdec.encode(params, extra["frames"], cfg)
            logits = encdec.decode_full(params, toks, enc, cfg)[0]
            del enc
        else:
            logits = transformer.decoder_forward(params, toks, cfg)[0]
        full = logits[0, p_len - 1:p_len + FAM_DECODE_A].float()
        del logits

        def rel(logits, i):
            return float((logits[0].float() - full[i]).abs().max()) \
                / float(full[i].abs().max())

        def decode_errs(plant: bool):
            logits, cache = model.prefill(
                params, dict(extra, tokens=toks[:, :p_len]), s)
            errs = [rel(logits, 0)]
            if plant:
                cache = fam_plant(cfg, cache)
            for i in range(FAM_DECODE_A):
                t = p_len + i
                logits, cache = model.decode_step(params, cache,
                                                  toks[:, t:t + 1])
                errs.append(rel(logits, i + 1))
            return errs
        return decode_errs(False), max(decode_errs(True))

    def reading(tol: float) -> dict:
        errs, planted = readings()
        return dict(max_rel_err=max(errs), mean_rel_err=sum(errs) / len(errs),
                    rel_errs=errs, planted_max_rel_err=planted, tol=tol)

    res = dict(prefill=p_len, decode_steps=FAM_DECODE_A, full_forward=s)
    if cfg.family == "ssm":
        res["reference_init"] = r = reading(LM_TOL_A)
        restore = mamba_long_memory(params, cfg)
        try:
            res["long_memory"] = reading(FAM_TOL_A_LONG)
        finally:
            restore()
        gated = (res["long_memory"],)
    else:
        res.update(reading(LM_TOL_A))
        r, gated = res, (res,)
    print(f"[families] {cfg.name} gate (a) prefill {p_len} + decode "
          f"{FAM_DECODE_A} vs full forward of {s}, bf16: {json.dumps(res)}",
          flush=True)
    require(r["max_rel_err"] <= LM_TOL_A, f"{cfg.name} gate (a): decode off "
            f"the full forward by {r['max_rel_err']} of max|logits| > "
            f"{LM_TOL_A}")
    for g in gated:
        require(g["max_rel_err"] <= g["tol"] < g["planted_max_rel_err"],
                f"{cfg.name} gate (a): the sound reading "
                f"{g['max_rel_err']} or the planted fault's "
                f"{g['planted_max_rel_err']} is on the wrong side of "
                f"{g['tol']}")
    return res


def fam_cut_card_vs_cpu(arch: str, seed: int) -> dict:
    """Gates (b) and (c): the family cut to FAM_CUT's layers at full width,
    float32, TF32 off, weights drawn on the card and copied to the CPU.
    (b) the prefill's logits and FAM_DECODE_B teacher-forced decode steps'
    within LM_TOL_B·max|CPU| of the CPU's; (c) the loss on the prompt
    within TRAIN_TOL_C[0] relative and, for FAM_GRADS_C, every leaf's
    gradient within TRAIN_TOL_C[1]·max|g_cpu|."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_leaves, tree_map
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = fam_config(arch, param_dtype="float32", compute_dtype="float32",
                     **FAM_CUT[arch])
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed + 31))
    p_cpu = tree_map(lambda t: t.cpu(), params)
    b, s = FAM_GATE_B[arch]
    rng = np.random.default_rng(seed + 32)
    batch = {"tokens": torch.from_numpy(rng.integers(
        3, cfg.vocab, (b, s + FAM_DECODE_B)).astype(np.int32))}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model), dtype=np.float32))
    grads_too = arch in FAM_GRADS_C
    out = {}
    for where, p in (("card", params), ("cpu", p_cpu)):
        bt = {k: v.to(dev) if where == "card" else v
              for k, v in batch.items()}
        prompt = dict(bt, tokens=bt["tokens"][:, :s])
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits, cache = model.prefill(p, prompt, s + FAM_DECODE_B)
            steps = [logits.float().cpu()]
            for t in range(s, s + FAM_DECODE_B):
                logits, cache = model.decode_step(p, cache,
                                                  bt["tokens"][:, t:t + 1])
                steps.append(logits.float().cpu())
        del cache
        if grads_too:
            leaves = tree_leaves(p)
            for t in leaves:
                t.requires_grad_(True)
            loss = model.loss(p, prompt)
            grads = [g.cpu() for g in torch.autograd.grad(loss, leaves)]
        else:
            with torch.no_grad():
                loss, grads = model.loss(p, prompt), []
        out[where] = (steps, float(loss.detach()), grads,
                      time.perf_counter() - t0)
    del params, p_cpu, p
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = True
    (sc, lc, gc_, t_card), (sh, lh, gh, t_cpu) = out["card"], out["cpu"]
    step_errs = [float((x - y).abs().max()) / float(y.abs().max())
                 for x, y in zip(sc, sh)]
    finite = all(bool(torch.isfinite(x).all()) for x in sc + gc_)
    loss_rel = abs(lc - lh) / abs(lh)
    grad_rel = max((float((x - y).abs().max()) / float(y.abs().max())
                    for x, y in zip(gc_, gh) if float(y.abs().max()) > 0),
                   default=None)
    res = dict(layers={k: v for k, v in FAM_CUT[arch].items()},
               tokens=[b, s], decode_steps=FAM_DECODE_B,
               max_step_rel_err=max(step_errs), tol_b=LM_TOL_B,
               loss_card=lc, loss_cpu=lh, loss_rel=loss_rel,
               worst_grad_rel=grad_rel, grad_leaves=len(gc_),
               card_s=t_card, cpu_s=t_cpu)
    print(f"[families] {arch} gates (b), (c) cut, float32, card vs CPU: "
          f"{json.dumps(res)}", flush=True)
    require(finite and all(e <= LM_TOL_B for e in step_errs),
            f"{arch} gate (b): logits off the CPU's by {max(step_errs)} of "
            f"max|logits| > {LM_TOL_B}, or not finite")
    require(loss_rel <= TRAIN_TOL_C[0],
            f"{arch} gate (c): loss off by {loss_rel} relative")
    if grads_too:
        require(len(gc_) == len(tree_leaves(model.abstract_params()))
                and grad_rel <= TRAIN_TOL_C[1],
                f"{arch} gate (c): a grad off by {grad_rel} of its max")
    return res


def fam_serve_audio(model, params, seed: int) -> dict:
    """whisper through ``Model.prefill`` / ``Model.decode_step`` (the
    engine serves tokens only, as the reference's): FAM_AUDIO's prompts
    over frames drawn from ``seed``, then FAM_SERVE's token count of
    greedy steps, each step's ids read on the host; the counters zeroed
    just before and read just after."""
    import torch
    from repro_torch import kernels
    cfg = model.cfg
    dev = torch.device("cuda")
    n, s, s_max = FAM_AUDIO
    toks = torch.from_numpy(np.random.default_rng(seed + 33).integers(
        3, cfg.vocab, (n, s)).astype(np.int32)).to(dev)
    frames = fam_frames(cfg, n, seed + 33)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": toks,
                                               "frames": frames}, s_max)
        cur = logits.argmax(-1).cpu()
        t1 = time.perf_counter()
        outs = [cur]
        for _ in range(FAM_SERVE["max_new_tokens"]):
            logits, cache = model.decode_step(
                params, cache, cur[:, None].to(dev, torch.int32))
            cur = logits.argmax(-1).cpu()
            outs.append(cur)
        t2 = time.perf_counter()
    counts = kernels.launch_counts()
    ids = torch.stack(outs, 1)
    require(bool(((ids >= 0) & (ids < cfg.vocab)).all()),
            f"{cfg.name}: a token is out of the vocabulary")
    steps = len(outs) - 1
    res = dict(requests=n, prompt_len=s, frames=list(frames.shape),
               s_max=s_max, prefill_ms=(t1 - t0) * 1e3,
               decode_ms_per_step=(t2 - t1) * 1e3 / steps,
               decode_steps=steps, tokens=ids.numel(),
               tokens_per_s=ids.numel() / (t2 - t0),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches={k: v for k, v in counts.items() if v})
    print(f"[families] {cfg.name} prefill + decode: {json.dumps(res)}",
          flush=True)
    del cache, logits, frames
    return dict(res, counts=counts)


def fam_train_steps(hist, tokens: int) -> dict:
    step_ms = [h["ms"] for h in hist]
    med = median(step_ms[1:])
    return dict(losses=[h["loss"] for h in hist],
                grad_norms=[h["grad_norm"] for h in hist], step_ms=step_ms,
                median_step_ms_after_first=med, tokens_per_step=tokens,
                tokens_per_s=tokens / med * 1e3)


def fam_train(arch: str, seed: int) -> dict:
    """Training in bfloat16 with ``remat="full"`` and the default
    ``AdamWConfig``: whisper at full depth through
    ``launch.train.main`` (FAM_TRAIN_AUDIO, frames from its
    ``extra_batch_fn``), the decoder families cut to FAM_TRAIN's layers
    through ``runtime.Trainer`` (FAM_TRAIN_SHAPE). Each step's loss, grad
    norm and ms, tokens/s, peak memory, all finite."""
    import tempfile
    import torch
    from repro_torch.launch import train as tlaunch
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import Trainer, TrainerConfig
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as d:
        if arch == "whisper-medium":
            a = FAM_TRAIN_AUDIO
            out = tlaunch.main([
                "--arch", arch, "--steps", str(a["steps"]),
                "--batch", str(a["batch"]), "--seq", str(a["seq"]),
                "--ckpt-dir", d, "--ckpt-every", str(10 * a["steps"]),
                "--no-resume", "--log-every", "1"])
            model, init_s = out["trainer"].model, out["trainer"].init_s
        else:
            a = FAM_TRAIN_SHAPE
            model = build_model(fam_config(arch, n_layers=FAM_TRAIN[arch]))
            tr = Trainer(model, TrainerConfig(
                steps=a["steps"], log_every=1, ckpt_every=10 * a["steps"],
                ckpt_dir=d, global_batch=a["batch"], seq_len=a["seq"],
                seed=seed), AdamWConfig())
            out = tr.run(resume=False)
            init_s = tr.init_s
    torch.cuda.synchronize()
    cfg = model.cfg
    res = dict(layers=cfg.n_layers, encoder_layers=cfg.n_encoder_layers,
               n_params=model.n_params(), dtype=cfg.param_dtype,
               remat=cfg.remat, batch=a["batch"], seq=a["seq"],
               init_s=init_s,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               **fam_train_steps(out["history"], a["batch"] * a["seq"]))
    print(f"[families] {arch} training: {json.dumps(res)}", flush=True)
    require(len(out["history"]) == a["steps"] and all(
        math.isfinite(x) for x in res["losses"] + res["grad_norms"]),
        f"{arch} training: a loss or grad norm is not finite: "
        f"{res['losses']} {res['grad_norms']}")
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return res


def families_phase(seed: int):
    """falcon-mamba-7b, recurrentgemma-9b and whisper-medium, one at a time
    (see the module docstring, phase 6g). Returns ({path: counts},
    summary)."""
    import torch
    from repro_torch.models import build_model
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    counts, summary = {}, {}
    for arch in FAM_ARCHS:
        s = {"gates_b_c": fam_cut_card_vs_cpu(arch, seed)}
        cfg = fam_config(arch)
        model = build_model(cfg)
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
        torch.cuda.synchronize()
        s.update(init_s=time.perf_counter() - t0, n_params=model.n_params(),
                 weights_gib=torch.cuda.memory_allocated() / 2**30)
        print(f"[families] {arch}: {cfg.n_layers} layers"
              + (f" + {cfg.n_encoder_layers} encoder layers"
                 if cfg.n_encoder_layers else "")
              + f", d_model {cfg.d_model}, {s['n_params']} parameters drawn "
              f"in bf16 in {s['init_s']:.1f} s, {s['weights_gib']:.2f} GiB "
              "on the card", flush=True)
        s["gate_a"] = fam_gate_a(model, params, seed)
        if cfg.family == "audio":
            r = fam_serve_audio(model, params, seed)
            counts[f"families_{arch}"] = r.pop("counts")
            s["serve"] = r
        else:
            s["waves"] = {}
            for i, prompts in enumerate(lm_prompts(seed, cfg.vocab,
                                                   FAM_WAVES)):
                r = serve_wave(model, params, prompts,
                               f"{arch} wave {i + 1}", FAM_SERVE,
                               "families")
                counts[f"families_{arch}_wave{i + 1}"] = r["counts"]
                s["waves"][f"wave{i + 1}"] = {
                    k: v for k, v in r.items() if k not in ("outs", "counts")}
        del params, model
        gc.collect()
        torch.cuda.empty_cache()
        s["train"] = fam_train(arch, seed)
        summary[arch] = s
    summary["phase_s"] = time.perf_counter() - t_phase
    print(f"[families] phase {summary['phase_s']:.1f} s", flush=True)
    return counts, summary


# ---------------------------------------------------------------------------
# Phase 6h: the dry run held against the card
# ---------------------------------------------------------------------------

DRY_TOL_PEAK = 0.25           # (c): |meta peak - card peak| / card peak,
                              # on the whole peak and on its part beyond
                              # the arguments
ALLOC_ROUND = 512             # (a): the caching allocator's rounding


def requested_bytes() -> int:
    """The bytes the caching allocator was asked for and holds (its
    ``requested_bytes`` statistic: sizes before rounding)."""
    import torch
    return torch.cuda.memory_stats().get("requested_bytes.all.current", -1)


def dryrun_phase(seed: int):
    """The dry run's predictions against one real train step of
    granite-moe-3b-a800m (see the module docstring, phase 6h). Returns
    ({path: counts}, summary)."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs.base import ShapeCase
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.op_analysis import analyze
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import AdamWConfig, adamw_init
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    b, s = TRAIN_A["batch"], TRAIN_A["seq"]
    case = ShapeCase(f"train_{b}x{s}", s, b, "train")
    mesh = make_host_mesh()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.cuda.synchronize()
    base, base_req = torch.cuda.memory_allocated(), requested_bytes()
    cfg = train_config("sort")
    g = torch.Generator(device=dev).manual_seed(seed)
    params = build_model(cfg).init(g)
    opt = adamw_init(params)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=g,
                                     dtype=torch.int32, device=dev)}
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    held_req = requested_bytes() - base_req
    n_tensors = len(tree_leaves((params, opt, batch)))
    counts, summary = {}, {"card": gpu_line(), "mesh": mesh.shape,
                           "case": dataclasses.asdict(case),
                           "n_params": build_model(cfg).n_params(),
                           "tensors": n_tensors, "allocated": held,
                           "requested": held_req}
    for dispatch in ("sort", "spmm"):
        cfg = train_config(dispatch)
        meta = dryrun.analyze_cell(cfg, case, mesh)
        arg = meta["mem_per_device"]["argument_bytes"]
        step = make_train_step(build_model(cfg), AdamWConfig())
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        _, real = analyze(step, params, opt, batch)
        torch.cuda.synchronize()
        counts[f"dryrun_{dispatch}"] = kernels.launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, _, metrics = step(params, opt, batch)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - base
        r = dict(trace_s=meta["trace_s"], argument_bytes=arg,
                 allocated_minus_argument=held - arg,
                 requested_minus_argument=held_req - arg,
                 meta_flops=meta["flops"], card_flops=real["flops"],
                 meta_peak_live_bytes=meta["peak_live_bytes"],
                 card_peak_live_bytes=real["peak_live_bytes"],
                 card_max_allocated=peak,
                 peak_rel=(meta["peak_live_bytes"] - peak) / peak,
                 meta_beyond_arguments=meta["peak_live_bytes"] - arg,
                 card_beyond_arguments=peak - held,
                 beyond_rel=((meta["peak_live_bytes"] - arg) - (peak - held))
                 / (peak - held),
                 meta_bytes=meta["bytes"], card_bytes=real["hbm_bytes"],
                 step_ms=ms, achieved_tflops=meta["flops"] / ms / 1e9,
                 loss=loss, k9_grids=counts[f"dryrun_{dispatch}"]["ell_spmm"])
        summary[dispatch] = r
        print(f"[dryrun] {cfg.name} '{dispatch}' {b} x {s}, {summary['card']}: "
              f"{json.dumps(r)}", flush=True)
        require(0 <= held - arg <= ALLOC_ROUND * n_tensors,
                f"(a) '{dispatch}': the card allocated {held} bytes for the "
                f"{n_tensors} argument tensors, the dry run says {arg} (more "
                f"than {ALLOC_ROUND} bytes a tensor apart)")
        require(held_req == arg,
                f"(a) '{dispatch}': the allocator was asked for {held_req} "
                f"bytes for the arguments, the dry run says {arg}")
        require(math.isfinite(loss), f"'{dispatch}' loss {loss}")
        if dispatch == "sort":
            require(real["flops"] == meta["flops"],
                    f"(b) the step counted {real['flops']} FLOPs on the card, "
                    f"{meta['flops']} on meta")
            require(abs(r["peak_rel"]) <= DRY_TOL_PEAK,
                    f"(c) meta peak {meta['peak_live_bytes']} bytes against "
                    f"the card's {peak}: {r['peak_rel']:+.3f} relative")
            require(abs(r["beyond_rel"]) <= DRY_TOL_PEAK,
                    f"(c) meta peak beyond the arguments "
                    f"{r['meta_beyond_arguments']} bytes against the card's "
                    f"{r['card_beyond_arguments']}: {r['beyond_rel']:+.3f} "
                    f"relative")
        else:
            require(r["k9_grids"] > 0, "'spmm' step launched no K9 grid")
    del params, opt, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    summary["phase_s"] = time.perf_counter() - t_phase
    print(f"[dryrun] gates (a)-(c) passed; phase {summary['phase_s']:.1f} s",
          flush=True)
    return counts, summary


# ---------------------------------------------------------------------------
# Phase 6i: the LM under a mesh
# ---------------------------------------------------------------------------

MESH_SHARDS = 4               # the host mesh's shards (cards, or cuda:0 x 4)
MESH_GATE_A = (2, 128)        # (a), (d): prompts x tokens on the float32 cut
MESH_TOL_A = 1e-5             # (a): loss relative, each grad vs its max
MESH_TRAIN = dict(batch=8, seq=512, steps=3)     # (c) through launch.train
MESH_HIDDEN = (16, 8, 3)      # (c): model-parallel (40 % 16, 512 % 16 = 0),
                              # layers, steps: the hidden-dim split
MESH_SERVE = ("deepseek-v2-lite-16b", 8, 32, 4)  # (e): arch, requests,
                              # max new tokens, --model-parallel


def mesh_devices(n: int):
    """``n`` shards: the cards in turn where the machine has
    ``MESH_SHARDS`` or more, else ``cuda:0`` n times."""
    import torch
    cards = torch.cuda.device_count()
    if cards >= MESH_SHARDS:
        return [torch.device("cuda", i % cards) for i in range(n)]
    return [torch.device("cuda", 0)] * n


def mesh_loss_grads(model, params, toks, mesh) -> tuple:
    """``Model.loss`` and every leaf's grad under ``sharding_rules(mesh)``,
    the grads on the CPU."""
    import torch
    from repro_torch.models.params import tree_leaves
    from repro_torch.parallel import sharding_rules
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    with sharding_rules(mesh):
        loss = model.loss(params, {"tokens": toks})
        grads = [g.cpu() for g in torch.autograd.grad(loss, leaves)]
    return float(loss), grads


def mesh_apart(got, want) -> dict:
    """Loss relative and the worst grad's max gap over its max."""
    (lg, gg), (lw, gw) = got, want
    return dict(loss_rel=abs(lg - lw) / abs(lw),
                worst_grad_rel=max(float((x - y).abs().max())
                                   / float(y.abs().max())
                                   for x, y in zip(gg, gw)
                                   if float(y.abs().max()) > 0))


@contextlib.contextmanager
def mesh_plant(fault: str):
    """(b): plant ``fault`` in the ``'sort'`` region within the block:
    every shard combines from expert 0 (``e_off = 0``), or each data
    shard keeps its first ``"model"`` shard's partial combine (no
    ``psum``)."""
    from repro_torch.models import ffn
    from repro_torch.parallel import mesh as pmesh
    off = fault == "e_off = 0"
    mod, name = (ffn, "_moe_sort_body") if off else (pmesh, "psum")
    orig = getattr(mod, name)
    setattr(mod, name, (lambda *a: orig(*a[:-1], 0)) if off
            else (lambda shards: shards[0].clone()))
    try:
        yield
    finally:
        setattr(mod, name, orig)


def mesh_gates_ad(seed: int) -> tuple:
    """(a), (b), (d) on granite's published widths cut to TRAIN_CUT layers,
    float32, TF32 off: see the module docstring, phase 6i. Returns
    (summary, {path: counts})."""
    import torch
    from repro_torch import kernels
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_map
    from repro_torch.parallel import sharding_rules
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    b, sq = MESH_GATE_A
    cfg = train_config("sort", n_layers=TRAIN_CUT, param_dtype="float32",
                       compute_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed + 11))
    toks = torch.from_numpy(np.random.default_rng(seed + 12).integers(
        3, cfg.vocab, (b, sq)).astype(np.int32)).to(dev)
    devs = mesh_devices(MESH_SHARDS)
    m22, m21 = make_host_mesh(2, devs), make_host_mesh(1, devs[:2])
    cpu22 = make_host_mesh(2, ["cpu"] * MESH_SHARDS)
    res = {"meshes": {"split": m22.shape, "unsplit": m21.shape,
                      "devices": [str(d) for d in devs]}}
    t0 = time.perf_counter()
    ref = mesh_loss_grads(model, params, toks, m21)
    split = mesh_loss_grads(model, params, toks, m22)
    res["split_s"] = time.perf_counter() - t0
    cpu_params = tree_map(lambda t: t.detach().cpu(), params)
    on_cpu = mesh_loss_grads(model, cpu_params, toks.cpu(), cpu22)
    res["card_2x2_vs_2x1"] = mesh_apart(split, ref)
    res["card_2x2_vs_cpu_2x2"] = mesh_apart(split, on_cpu)
    res["losses"] = dict(card_2x2=split[0], card_2x1=ref[0],
                         cpu_2x2=on_cpu[0])
    for what in ("card_2x2_vs_2x1", "card_2x2_vs_cpu_2x2"):
        r = res[what]
        require(r["loss_rel"] <= MESH_TOL_A
                and r["worst_grad_rel"] <= MESH_TOL_A,
                f"(a) {what}: {json.dumps(r)} above {MESH_TOL_A}")
    del on_cpu, cpu_params
    # (b) each planted fault must break gate (a)
    res["planted"] = {}
    for fault in ("e_off = 0", "no psum"):
        with mesh_plant(fault):
            bad = mesh_apart(mesh_loss_grads(model, params, toks, m22), ref)
        res["planted"][fault] = bad
        require(bad["loss_rel"] > MESH_TOL_A
                or bad["worst_grad_rel"] > MESH_TOL_A,
                f"(b) gate (a) passed with '{fault}' planted: "
                f"{json.dumps(bad)}")
    del ref, split
    print(f"[mesh] (a) {TRAIN_CUT}-layer float32 cut of {cfg.name}, {b} x "
          f"{sq} tokens, {gpu_line()}: (2, 2) against (2, 1) and against "
          f"(2, 2) on CPU devices within {MESH_TOL_A}; (b) both planted "
          f"faults caught: {json.dumps(res)}", flush=True)
    # (d) 'spmm' at two groups: K9 once a group, the loss equal to
    # 'ellpack''s on the same mesh
    losses, counts = {}, {}
    for dispatch in ("spmm", "ellpack", "sort"):
        dm = build_model(train_config(dispatch, n_layers=TRAIN_CUT,
                                      param_dtype="float32",
                                      compute_dtype="float32"))
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with sharding_rules(m22), torch.no_grad():
            losses[dispatch] = float(dm.loss(params, {"tokens": toks}))
        torch.cuda.synchronize()
        counts[f"mesh_{dispatch}"] = kernels.launch_counts()
    groups = 2
    n_moe = cfg.n_layers - cfg.moe.first_dense_layers
    want = n_moe * groups * k9_grids(cfg, b * sq // groups)
    got = counts["mesh_spmm"]["ell_spmm"]
    rd = dict(losses=losses, spmm_vs_ellpack_rel=abs(
        losses["spmm"] - losses["ellpack"]) / abs(losses["ellpack"]),
        k9_grids=got, k9_grids_want=want)
    print(f"[mesh] (d) 'spmm' on (2, 2), {groups} groups, {gpu_line()}: "
          f"{json.dumps(rd)}", flush=True)
    require(got == want, f"(d) 'spmm' launched K9's grids {got} times, not "
            f"{want} ({n_moe} layers x {groups} groups)")
    require(rd["spmm_vs_ellpack_rel"] <= MESH_TOL_A,
            f"(d) 'spmm' loss {losses['spmm']} against 'ellpack' "
            f"{losses['ellpack']} on the same mesh")
    res["spmm"] = rd
    torch.backends.cuda.matmul.allow_tf32 = True
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return res, counts


def mesh_train_steps(out, tokens: int, what: str) -> dict:
    """(c): one run's losses (finite, falling), ms a step, tokens/s (the
    median step after the first), peak and moved bytes."""
    import torch
    from repro_torch.parallel import mesh as pmesh
    hist = out["history"]
    ms = [h["ms"] for h in hist]
    med = median(ms[1:])
    r = dict(mesh=out["mesh"].shape, losses=[h["loss"] for h in hist],
             step_ms=ms, median_step_ms=med, tokens_per_s=tokens / med * 1e3,
             peak_gib=torch.cuda.max_memory_allocated() / 2**30,
             moved_bytes=pmesh.moved_bytes())
    require(all(math.isfinite(x) for x in r["losses"]),
            f"(c) {what}: a loss is not finite: {r['losses']}")
    require(r["losses"][-1] < r["losses"][0],
            f"(c) {what}: losses do not fall: {r['losses']}")
    return r


def k9_part_shape(what: str, val, idx, x_shape, dtype, n_rows: int,
                  rng) -> dict:
    """K9 at one coordinate's recorded planes of the partitioned
    ``'spmm'`` step: integer operands in ``dtype`` (the combine's routing
    weights replaced by integers on its valid lanes; every sum exact),
    bit for bit against the plain twin; the kernel, the twin and
    ``torch.sparse.mm`` of A as a CSR tensor timed (None where torch has
    no such product on the card); bytes bound the kernel."""
    import torch
    from repro_torch.kernels import ell_spmm as k9
    dev = idx.device
    v = torch.where(idx >= 0, int_tensor(rng, val.shape, dev), 0.0).to(dtype)
    x = int_tensor(rng, x_shape, dev).to(dtype)
    d = x.shape[1]
    valid = (idx >= 0) & (idx < n_rows)
    n_used = int(valid.any(0).sum())
    w = x.element_size()
    a_csr = sparse_rows(v, idx, n_rows)
    try:
        torch.sparse.mm(a_csr, x)
        library = (lambda: torch.sparse.mm(a_csr, x))
    except RuntimeError:
        library = None
    r = held_pair(
        "ell_spmm", lambda: k9.ell_spmm(v, idx, x, n_rows),
        lambda: k9.ell_spmm_plain(v, idx, x, n_rows), library,
        f"{what}: ({v.shape[0]},{v.shape[1]}) x ({x.shape[0]},{d}) -> "
        f"({n_rows},{d}) {str(dtype).removeprefix('torch.')}, "
        f"{int(valid.sum())} valid lanes, one coordinate of the "
        "partitioned training step",
        (4 + w) * v.numel() + w * n_used * d + w * n_rows * d,
        2 * int(valid.sum()) * d)
    r.update(dtype=str(dtype).removeprefix("torch."),
             grids=k9.grids(*v.shape, n_rows, d))
    del a_csr
    return r


def mesh_train_run(dispatch: str, mp: int, meta, record: bool = False):
    """One full-width run of training (c) through ``launch.train.main``
    (granite-moe-3b-a800m under ``dispatch``), the counters zeroed just
    before it: its steps, the live collectives against ``meta`` (a future
    of the dry run's count of one step) times the steps, and with
    ``record`` K9's first dispatch and combine planes. Returns (summary,
    counts, the recorded calls)."""
    import tempfile
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import ops
    from repro_torch.launch import train as tlaunch
    from repro_torch.parallel import mesh as pmesh
    a = MESH_TRAIN
    tokens = a["batch"] * a["seq"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pmesh.reset_moved_bytes()
    pmesh.reset_collectives()
    kernels.reset_launch_counts()
    orig_cfg, orig_k9, seen = tlaunch.get_config, ops.ell_spmm, []

    def first_calls(val, idx, x, n_rows):
        if len(seen) < 2:
            seen.append((val.detach().clone(), idx.clone(), tuple(x.shape),
                         x.dtype, n_rows))
        return orig_k9(val, idx, x, n_rows)
    tlaunch.get_config = (lambda name: train_config(dispatch))
    if record:
        ops.ell_spmm = first_calls
    try:
        with tempfile.TemporaryDirectory() as d:
            out = tlaunch.main([
                "--arch", TRAIN_ARCH, "--steps", str(a["steps"]),
                "--batch", str(a["batch"]), "--seq", str(a["seq"]),
                "--ckpt-dir", d, "--ckpt-every", str(10 * a["steps"]),
                "--no-resume", "--log-every", "1", "--model-parallel",
                str(mp)], devices=mesh_devices(MESH_SHARDS))
        torch.cuda.synchronize()
    finally:
        tlaunch.get_config, ops.ell_spmm = orig_cfg, orig_k9
    live = pmesh.collectives()
    c = kernels.launch_counts()
    meta = meta.result()
    what = f"{dispatch} on {out['mesh'].shape}"
    r = mesh_train_steps(out, tokens, what)
    want = tuple({k: a["steps"] * v for k, v in part.items()}
                 for part in meta)
    r.update(dispatch=dispatch, init_s=out["trainer"].init_s,
             collective_bytes=live[0], collective_count=live[1],
             dry_collective_bytes_a_step=meta[0],
             dry_collective_count_a_step=meta[1])
    cfg = train_config(dispatch)
    if dispatch == "spmm":
        n_moe = cfg.n_layers - cfg.moe.first_dense_layers
        coords = MESH_SHARDS
        tg = tokens // (MESH_SHARDS // mp)     # a coordinate's group
        from repro_torch.kernels import ell_spmm as k9
        from repro_torch.models import ffn
        e_loc = cfg.moe.n_experts // mp
        slots = e_loc * ffn.moe_capacity(tg, cfg)
        one = (k9.grids(cfg.moe.top_k, tg, slots, cfg.d_model)
               + k9.grids(1, slots, tg, cfg.d_model))
        fwd = a["steps"] * coords * n_moe * one
        r.update(k9_grids=c["ell_spmm"], k9_grids_forward=fwd)
        require(fwd < c["ell_spmm"] <= 2 * fwd,
                f"training (c) {what}: K9's grids {c['ell_spmm']} not in "
                f"({fwd}, {2 * fwd}] ({a['steps']} steps x {coords} "
                f"coordinates x {n_moe} layers, forward and recompute)")
    else:
        require(c["ell_spmm"] == 0, f"training (c) {what} launched K9")
    print(f"[mesh] training (c) {TRAIN_ARCH} {cfg.n_layers} layers bf16 "
          f"'{dispatch}' {a['batch']} x {a['seq']} partitioned on "
          f"{out['mesh'].shape}, {gpu_line()}: {json.dumps(r)}", flush=True)
    require(live == want, f"training (c) {what}: the live collectives "
            f"{live} against {a['steps']} x the dry run's {meta}")
    del out
    gc.collect()
    return r, c, seen


def train_meta_traces(pool) -> dict:
    """Training (c)'s dry-run traces, submitted to ``pool``: futures by
    (dispatch, model-parallel size), and ``"hidden"``."""
    a = MESH_TRAIN
    mp_h, layers, _ = MESH_HIDDEN
    full = train_config("sort").n_layers
    metas = {(dsp, mp): pool.submit(
        train_meta_trace, dsp, (MESH_SHARDS // mp, mp), full, a["batch"],
        a["seq"]) for dsp, mp in MESH_TRAIN_RUNS}
    metas["hidden"] = pool.submit(train_meta_trace, "sort", (1, mp_h),
                                  layers, a["batch"], a["seq"])
    return metas


def mesh_train(seed: int, metas: dict) -> tuple:
    """Training (c): granite-moe-3b-a800m at all 32 layers, bfloat16,
    through ``launch.train.main(..., devices=...)``, partitioned, on (2,
    2) and (1, 4), ``'sort'`` then ``'spmm'``; then the hidden-dim split
    through ``runtime.Trainer`` under ``sharding_rules(make_host_mesh(16,
    ...))``. ``metas``: the dry run's meta traces of the same steps
    (``train_meta_traces``), run in worker processes beside the card's
    work. Returns (summary, {path: counts}, K9's shape entries)."""
    import tempfile
    import torch
    from repro_torch import kernels
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import mesh as pmesh
    from repro_torch.parallel import sharding_rules
    from repro_torch.runtime import Trainer, TrainerConfig
    torch.backends.cuda.matmul.allow_tf32 = True
    a = MESH_TRAIN
    tokens = a["batch"] * a["seq"]
    mp_h, layers, steps = MESH_HIDDEN
    res, counts, shapes = {}, {}, []
    for dsp, mp in MESH_TRAIN_RUNS:
        rec = dsp == "spmm" and mp == 2
        r, c, seen = mesh_train_run(dsp, mp, metas[(dsp, mp)], record=rec)
        res[f"{dsp}_model_parallel_{mp}"] = r
        counts[f"mesh_train_{dsp}_{mp}"] = c
        rng = np.random.default_rng(seed + 44)
        for part, (val, idx, xs, dt, n_rows) in zip(("dispatch", "combine"),
                                                    seen):
            shapes.append(k9_part_shape(f"partitioned training {part}", val,
                                        idx, xs, dt, n_rows, rng))
        del seen
    cfg = train_config("sort", n_layers=layers)
    require(cfg.moe.n_experts % mp_h and cfg.moe.d_ff_expert % mp_h == 0,
            f"(c) {mp_h} shards do not split {cfg.name}'s hidden dim alone")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pmesh.reset_moved_bytes()
    pmesh.reset_collectives()
    kernels.reset_launch_counts()
    mesh = make_host_mesh(mp_h, mesh_devices(mp_h))
    with tempfile.TemporaryDirectory() as d, sharding_rules(mesh):
        tr = Trainer(build_model(cfg), TrainerConfig(
            steps=steps, ckpt_dir=d, ckpt_every=10 * steps, log_every=1,
            global_batch=a["batch"], seq_len=a["seq"], seed=seed),
            AdamWConfig(), device=mesh.devices.flat[0])
        out = tr.run(resume=False)
    torch.cuda.synchronize()
    live = pmesh.collectives()
    meta = metas["hidden"].result()
    counts["mesh_train_hidden"] = kernels.launch_counts()
    r = res["hidden_split"] = mesh_train_steps(dict(out, mesh=mesh), tokens,
                                               "hidden split")
    want = tuple({k: steps * v for k, v in part.items()} for part in meta)
    r.update(layers=layers, collective_bytes=live[0],
             collective_count=live[1])
    print(f"[mesh] training (c) hidden-dim split, {layers} layers bf16 "
          f"partitioned on {mesh.shape}, {gpu_line()}: {json.dumps(r)}",
          flush=True)
    require(live == want, f"training (c) hidden split: the live "
            f"collectives {live} against {steps} x the dry run's {meta}")
    del out, tr
    gc.collect()
    torch.cuda.empty_cache()
    return res, counts, shapes


def mesh_serve(seed: int) -> tuple:
    """(e): one wave through ``launch.serve.main(..., devices=...)``.
    Returns (summary, {path: counts})."""
    import torch
    from repro_torch import kernels
    from repro_torch.launch import serve as slaunch
    from repro_torch.parallel import mesh as pmesh
    arch, n, new, mp = MESH_SERVE
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pmesh.reset_moved_bytes()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    eng = slaunch.main(["--arch", arch, "--requests", str(n), "--max-new",
                        str(new), "--model-parallel", str(mp)],
                       devices=mesh_devices(MESH_SHARDS))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats()
    steps = st["decode_steps"]
    r = dict(arch=arch, requests=st["requests"], tokens=st["tokens"],
             prefill_ms=st["prefill_s"] * 1e3,
             decode_ms_per_step=st["decode_s"] * 1e3 / max(1, steps),
             decode_steps=steps,
             tokens_per_s=st["tokens"] / (st["prefill_s"] + st["decode_s"]),
             decode_tokens_per_s=st["tokens"] / max(st["decode_s"], 1e-9),
             wall_s=wall, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
             moved_bytes=pmesh.moved_bytes())
    require(st["requests"] == n and n <= st["tokens"] <= n * new,
            f"(e) served {st['requests']} requests, {st['tokens']} tokens")
    require(r["moved_bytes"] > 0, "(e) no collective ran: the program "
            "did not split over 'model'")
    print(f"[mesh] (e) {arch} 27 layers bf16, a wave of {n} through "
          f"launch.serve.main on (1, {mp}), {gpu_line()}: {json.dumps(r)}",
          flush=True)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return r, {"mesh_serve": kernels.launch_counts()}


MESH_PART_CUTS = ("deepseek-v2-lite-16b", "mistral-large-123b",
                  "qwen2-0.5b")  # (a), (b): 2-layer float32 cuts
MESH_PART_MESHES = ((1, 4), (2, 2))
MESH_PART_A = (4, 64, 8, 80)  # (a): prompts, tokens, greedy steps, s_max
MESH_PART_TOL = 1e-5          # (a): each step's logits against their max
MESH_PART_FULL = (("deepseek-v2-lite-16b", 0, ((1, 4), (2, 2))),
                  ("mistral-large-123b", 8, ((1, 4), (1, 16))))
MESH_PART_WAVE = (8, 64, 512)   # (c): prompts, shortest, longest
MESH_PART_SERVE = dict(max_batch=8, max_new_tokens=16, s_max=544)


def part_greedy(model, params, toks, steps: int, s_max: int,
                extra=None) -> tuple:
    """Prefill ``toks`` (with ``extra`` inputs: whisper's frames) and
    ``steps`` greedy decode steps, each fed the argmax of the step before:
    (every step's logits on the CPU, float32; the (B, steps) tokens; the
    cache)."""
    import torch
    host = (lambda t: (t if isinstance(t, torch.Tensor) else t.whole())
            .float().cpu())
    logits, cache = model.prefill(params, dict(extra or {}, tokens=toks),
                                  s_max)
    outs, picks = [host(logits)], []
    for _ in range(steps):
        nxt = outs[-1].argmax(-1).to(torch.int32)
        picks.append(nxt)
        logits, cache = model.decode_step(params, cache,
                                          nxt[:, None].to(toks.device))
        outs.append(host(logits))
    return outs, torch.stack(picks, 1), cache


def part_apart(got, want) -> dict:
    """The worst step's logits gap over its max, and whether the greedy
    tokens are equal."""
    (go, gt, _), (wo, wt, _) = got, want
    return dict(worst_rel=max(float((a - b).abs().max() / b.abs().max())
                              for a, b in zip(go, wo)),
                tokens_equal=bool((gt == wt).all()))


def part_block_bytes(tree) -> set:
    """Each mesh coordinate's bytes of ``tree``'s placed blocks, as a set
    (one value where every coordinate holds as many)."""
    from repro_torch.models.params import tree_leaves
    from repro_torch.parallel.sharding import mesh_coords
    leaves = tree_leaves(tree)
    return {sum(t.blocks[c].numel() * t.blocks[c].element_size()
                for t in leaves) for c in mesh_coords(leaves[0].mesh)}


def part_dry(model, shape, batch: int, plen: int, s_max: int) -> dict:
    """The dry run on a meta mesh of ``shape``: the weights' and the decode
    cache's argument bytes a device, and the partitioned program's
    collectives of a prefill of ``batch`` x ``plen`` and of one decode
    step at ``s_max`` (``launch.dryrun.collective_trace``)."""
    from repro_torch.configs.base import ShapeCase
    from repro_torch.launch import dryrun, steps
    from repro_torch.parallel import make_mesh, sharding_rules
    mesh = make_mesh(shape, ("data", "model"), ["meta"] * math.prod(shape))
    pre = ShapeCase("prefill", plen, batch, "prefill")
    dec = ShapeCase("decode", s_max, batch, "decode")
    with sharding_rules(mesh):
        aparams, acache, tokens = steps.abstract_decode_args(model, dec)
        out = dict(weight_bytes=dryrun.device_bytes(aparams),
                   cache_bytes=dryrun.device_bytes(acache["layers"]))
        out["prefill"] = dryrun.collective_trace(
            model, pre, steps.make_prefill_step(model, s_max),
            steps.abstract_prefill_args(model, pre))
        out["decode"] = dryrun.collective_trace(
            model, dec, steps.make_serve_step(model),
            (aparams, {**acache, "pos": s_max - 1}, tokens))
    return out


@contextlib.contextmanager
def part_plant(fault: str):
    """(d): within the block, drop the program's second reduce (the first
    layer's after ``wo``: each shard keeps its own partial sum), or write
    each decode token's cache entries on the next shard along the
    sequence."""
    from repro_torch.parallel import sharding as sh
    name = "reduce" if fault == "drop a reduce" else "index_owner"
    orig = getattr(sh, name)
    calls = [0]

    def dropped(x, dim=None):
        calls[0] += 1
        if calls[0] != 2 or not x.partial:
            return orig(x, dim)
        own = sh.Sharded(x.mesh, x.spec, x.shape, x.blocks)
        return own if dim is None else sh.split(own, dim,
                                                sh._entry(x.partial))

    def next_shard(i, block):
        return (i // block + 1) % MESH_SHARDS, i % block
    setattr(sh, name, dropped if name == "reduce" else next_shard)
    try:
        yield
    finally:
        setattr(sh, name, orig)


def mesh_part_cuts(seed: int) -> dict:
    """(a), (b), (d) on the 2-layer float32 cuts, TF32 off."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.parallel import sharding_rules
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    b, sq, steps, s_max = MESH_PART_A
    res = {}
    for arch in MESH_PART_CUTS:
        cfg = dataclasses.replace(get_config(arch), n_layers=2,
                                  param_dtype="float32",
                                  compute_dtype="float32")
        model = build_model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(seed + 31),
                            dev)
        toks = torch.from_numpy(np.random.default_rng(seed + 32).integers(
            3, cfg.vocab, (b, sq)).astype(np.int32)).to(dev)
        r = res[arch] = {}
        for shape in MESH_PART_MESHES:
            mesh = make_host_mesh(shape[1], mesh_devices(math.prod(shape)))
            dry = part_dry(model, shape, b, sq, s_max)
            with sharding_rules(mesh):
                want = part_greedy(model, params, toks, steps, s_max)
                placed = model.place(params)
                got = part_greedy(model, placed, toks, steps, s_max)
                held = part_apart(got, want)
                held.update(
                    weight_bytes=sorted(part_block_bytes(placed)),
                    cache_bytes=sorted(part_block_bytes(got[2]["layers"])),
                    dry_weight_bytes=dry["weight_bytes"],
                    dry_cache_bytes=dry["cache_bytes"])
                if arch == MESH_PART_CUTS[-1] and shape == (1, 4):
                    held["planted"] = {}
                    for fault in ("drop a reduce", "cache at the wrong "
                                  "shard"):
                        with part_plant(fault):
                            bad = part_apart(part_greedy(
                                model, placed, toks, steps, s_max), want)
                        held["planted"][fault] = bad
                        require(bad["worst_rel"] > MESH_PART_TOL
                                or not bad["tokens_equal"],
                                f"(d) gate (a) passed with '{fault}' "
                                f"planted: {json.dumps(bad)}")
            r[f"{shape}"] = held
            what = f"{arch} 2-layer cut on {shape}"
            require(held["worst_rel"] <= MESH_PART_TOL
                    and held["tokens_equal"],
                    f"(a) {what}: {json.dumps(held)}")
            require(held["weight_bytes"] == [dry["weight_bytes"]]
                    and held["cache_bytes"] == [dry["cache_bytes"]],
                    f"(b) {what}: block bytes against the dry run's "
                    f"{json.dumps(held)}")
            del placed, got, want
        del params, model
        gc.collect()
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = True
    print(f"[mesh] serving (a) 2-layer float32 cuts, {b} x {sq} tokens, "
          f"{steps} greedy steps, placed on {MESH_PART_MESHES} against whole "
          f"weights under the same rules, within {MESH_PART_TOL}; (b) each "
          f"coordinate's weight and cache bytes equal the dry run's; (d) "
          f"both planted faults caught, {gpu_line()}: {json.dumps(res)}",
          flush=True)
    return res


def mesh_part_full(seed: int) -> dict:
    """(b) the allocator after placement and (c) the full-width waves."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.parallel import mesh as pmesh
    from repro_torch.parallel import sharding_rules
    from repro_torch.serve import ServeConfig, ServingEngine
    dev = torch.device("cuda")
    n, lo, hi = MESH_PART_WAVE
    res = {}
    for arch, layers, shapes in MESH_PART_FULL:
        base = get_config(arch)
        cfg = dataclasses.replace(base, n_layers=layers or base.n_layers)
        model = build_model(cfg)
        prompts = lm_prompts(seed, cfg.vocab, ((n, lo, hi),))[0]
        for shape in shapes:
            what = f"{arch} {cfg.n_layers} layers bf16 on {shape}"
            mesh = make_host_mesh(shape[1], mesh_devices(math.prod(shape)))
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            m0, r0 = torch.cuda.memory_allocated(), requested_bytes()
            t0 = time.perf_counter()
            with sharding_rules(mesh):
                eng = ServingEngine(model, model.init(torch.Generator(
                    device=dev).manual_seed(seed + 33), dev),
                    ServeConfig(**MESH_PART_SERVE))
            gc.collect()
            torch.cuda.synchronize()
            place_s = time.perf_counter() - t0
            storages = {t.data_ptr(): t.numel() * t.element_size()
                        for leaf in tree_leaves(eng.params)
                        for t in leaf.blocks.values()}
            placed = sum(storages.values())
            resident = torch.cuda.memory_allocated() - m0
            requested = requested_bytes() - r0
            torch.cuda.reset_peak_memory_stats()
            pmesh.reset_moved_bytes()
            pmesh.reset_collectives()
            with sharding_rules(mesh):
                eng.generate_batch(prompts)
            torch.cuda.synchronize()
            live = pmesh.collectives()
            st = eng.stats()
            steps = st["decode_steps"]
            dry = part_dry(model, shape, n, hi, MESH_PART_SERVE["s_max"])
            want = tuple({k: dry["prefill"][i][k] + steps
                          * dry["decode"][i][k] for k in live[i]}
                         for i in range(2))
            r = res[what] = dict(
                init_and_place_s=place_s, resident_bytes=resident,
                requested_bytes=requested, placed_storage_bytes=placed,
                storages=len(storages),
                dry_weight_bytes_a_device=dry["weight_bytes"],
                prefill_ms=st["prefill_s"] * 1e3,
                decode_ms_per_step=st["decode_s"] * 1e3 / max(1, steps),
                decode_steps=steps, tokens=st["tokens"],
                tokens_per_s=st["tokens"] / (st["prefill_s"]
                                             + st["decode_s"]),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                moved_bytes=pmesh.moved_bytes(),
                collective_bytes=live[0], collective_count=live[1],
                dry_collective_bytes=want[0],
                dry_collective_count=want[1])
            print(f"[mesh] serving (c) {what}, a wave of {n} x {lo}-{hi}, "
                  f"{gpu_line()}: {json.dumps(r)}", flush=True)
            require(requested == placed,
                    f"(b) {what}: {requested} bytes requested from the "
                    f"allocator after placement ({resident} allocated) "
                    f"against {placed} in the placed blocks' storages")
            require(part_block_bytes(eng.params) == {dry["weight_bytes"]},
                    f"(b) {what}: weight block bytes against the dry run's "
                    f"{dry['weight_bytes']}")
            require(live == want, f"(c) {what}: the live collectives "
                    f"{live} against the dry run's {want}")
            require(st["requests"] == n and steps > 0,
                    f"(c) {what}: {st['requests']} requests, {steps} steps")
            del eng
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return res


MESH_TRAIN_CUTS = (("granite-moe-3b-a800m", "sort", ((1, 4), (2, 2))),
                   ("granite-moe-3b-a800m", "spmm", ((1, 4), (2, 2))),
                   ("granite-moe-3b-a800m", "ellpack", ((1, 4), (2, 2))),
                   ("deepseek-v2-lite-16b", "sort", ((1, 4),)),
                   ("qwen2-0.5b", None, ((1, 4),)))  # training (a): cuts
MESH_TRAIN_TOKENS = (2, 128)  # training (a), (b), (d): prompts x tokens
MESH_TRAIN_TOL = 1e-5         # training (a): loss relative; each gradient,
                              # moment against its max; params below
MESH_TRAIN_PARAM_TOL = 1e-6   # training (a): |p| where the gradient's sign
                              # is sure (|mu| > 1e-3 of max), else two steps
MESH_TRAIN_PLANTS = ("all-gather backward keeps its own block",
                     "moments one opt_shard block off")
MESH_TRAIN_RUNS = (("sort", 2), ("sort", 4), ("spmm", 2), ("spmm", 4))


def train_part_config(arch: str, dispatch, **over):
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), **over)
    if dispatch:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=dispatch))
    return cfg


def train_meta_trace(dispatch: str, shape, layers: int, batch: int,
                     seq: int) -> tuple:
    """The dry run's count of one partitioned granite training step
    (``launch.dryrun.collective_trace`` on a meta mesh of ``shape``),
    ``(bytes, count)`` by kind. Runs on the CPU alone, in a worker process
    beside the card's work."""
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.configs.base import ShapeCase
    from repro_torch.launch import dryrun, steps
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import make_mesh, sharding_rules
    model = build_model(train_part_config(TRAIN_ARCH, dispatch,
                                          n_layers=layers))
    case = ShapeCase("train", seq, batch, "train")
    mesh = make_mesh(shape, ("data", "model"), ["meta"] * math.prod(shape))
    with sharding_rules(mesh):
        return dryrun.collective_trace(
            model, case, steps.make_train_step(model, AdamWConfig()),
            steps.abstract_train_args(model, case))


def part_step(model, params, batch, mesh) -> dict:
    """One training step (``launch.steps.make_train_step``) on whole
    weights under ``sharding_rules(mesh)``: the loss, every gradient (in
    tree order) from one backward, then the params and moments after the
    step, each copied to the host as it is made (a full-width cut's would
    not fit on the card beside a placed step's state: recurrentgemma's
    256,000-row table)."""
    import torch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.parallel import sharding_rules
    step = make_train_step(model, AdamWConfig())
    with sharding_rules(mesh):
        params = tree_map(torch.clone, params)
        state = adamw_init(params)
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        with torch.enable_grad():
            out = model.loss(params, batch)
            grads = [g.cpu() for g in torch.autograd.grad(out, leaves)]
        loss = float(out.detach())
        del out, leaves
        params, state, _ = step(params, state, batch)
    return dict(loss=loss, grads=grads,
                params=[t.detach().cpu() for t in tree_leaves(params)],
                mu=[t.cpu() for t in tree_leaves(state["mu"])],
                nu=[t.cpu() for t in tree_leaves(state["nu"])])


def part_step_apart(model, params, batch, mesh, want) -> dict:
    """The same step on ``params`` placed under ``sharding_rules(mesh)``
    against ``want`` (``part_step``'s): the loss relative; the worst
    gradient's, first and second moment's max gap over its max; the
    params' worst gap where the gradient's sign is sure and anywhere. Each
    placed leaf is made whole, compared and dropped in turn: a full-width
    cut has no room for all of them at once."""
    import torch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.params import (tree_leaves, tree_map,
                                           tree_unflatten)
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.parallel import sharding_rules
    from repro_torch.parallel.sharding import grad_leaves, leaf_grads, reduce
    card = (lambda t: t.to(torch.device("cuda")))

    def gap(x, y):
        y = card(y)
        return float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
    with sharding_rules(mesh):
        placed = model.place(tree_map(torch.clone, params))
        state = adamw_init(placed, model.specs())
        live = [grad_leaves(p) for p in tree_leaves(placed)]
        with torch.enable_grad():
            loss = model.loss(tree_unflatten(placed, live), batch)
            grads = leaf_grads(loss, live)
        loss = float(loss.first().detach())
        del live
        r = dict(loss_rel=abs(loss - want["loss"]) / abs(want["loss"]),
                 worst_grad_rel=max(gap(reduce(g).whole(), w)
                                    for g, w in zip(grads, want["grads"])))
        del grads
        placed, state, _ = make_train_step(model, AdamWConfig())(
            placed, state, batch)
    for k in ("mu", "nu"):
        r[f"worst_{k}_rel"] = max(gap(t.whole(), w) for t, w in zip(
            tree_leaves(state[k]), want[k]))
    sure, every = 0.0, 0.0
    for p, q, mu in zip(tree_leaves(placed), want["params"], want["mu"]):
        err = (p.whole().detach() - card(q)).abs()
        mu = card(mu)
        mask = mu.abs() > 1e-3 * mu.abs().max()
        sure = max(sure, float(err[mask].max()) if mask.any() else 0.0)
        every = max(every, float(err.max()))
    return dict(r, params_sure_abs=sure, params_abs=every)


def part_step_ok(r: dict, tol: float = MESH_TRAIN_TOL) -> bool:
    """Training (a)'s limits; ``tol`` for the gradients and moments."""
    from repro_torch.optim import AdamWConfig
    cfg = AdamWConfig()
    lr1 = cfg.lr / max(1, cfg.warmup_steps)
    return (r["loss_rel"] <= MESH_TRAIN_TOL
            and r["worst_grad_rel"] <= tol
            and r["worst_mu_rel"] <= tol
            and r["worst_nu_rel"] <= tol
            and r["params_sure_abs"] <= MESH_TRAIN_PARAM_TOL
            and r["params_abs"] <= 2 * lr1 + MESH_TRAIN_PARAM_TOL)


@contextlib.contextmanager
def train_plant(fault: str):
    """Training (a)'s planted faults, within the block: every all-gather's
    backward keeping its own block of its own gradient (no sum over the
    group), or each coordinate's gradient piece landing on the moment
    block of the next ``"data"`` coordinate (moments placed one
    ``opt_shard`` block off)."""
    from repro_torch.optim import adamw
    from repro_torch.parallel import mesh as pmesh
    from repro_torch.parallel.sharding import Sharded, spec_axes
    if fault == MESH_TRAIN_PLANTS[0]:
        def own(groups, dim, n):
            c = groups[0][0].shape[dim] // n
            out = [[x.narrow(dim, i * c, c).clone() for i, x in enumerate(g)]
                   for g in groups]
            pmesh._count("reduce-scatter", out[0][0])
            return out
        pmesh._RUN["own block"] = own
        pmesh._DUAL["all-gather"] = "own block"
        try:
            yield
        finally:
            pmesh._DUAL["all-gather"] = "reduce-scatter"
            del pmesh._RUN["own block"]
        return
    orig = adamw._to_layout

    def shifted(g, spec):
        out = orig(g, spec)
        if "data" not in {a for e in spec for a in spec_axes(e)}:
            return out
        mesh = out.mesh
        i, n = mesh.axis_names.index("data"), mesh.shape["data"]
        blocks = {c: out.blocks[c[:i] + ((c[i] + 1) % n,) + c[i + 1:]]
                  .to(b.device) for c, b in out.blocks.items()}
        return Sharded(mesh, out.spec, out.shape, blocks)
    adamw._to_layout = shifted
    try:
        yield
    finally:
        adamw._to_layout = orig


def k9_recorder():
    """A wrapper over ``kernels.ops.ell_spmm`` recording each call's
    operands (``(val, idx, x, n_rows)``) and its result, and the way to
    put the wrapper back."""
    from repro_torch.kernels import ops
    orig, calls = ops.ell_spmm, []

    def record(val, idx, x, n_rows):
        out = orig(val, idx, x, n_rows)
        calls.append((val.detach(), idx, x.detach(), n_rows))
        return out
    ops.ell_spmm = record
    return calls, (lambda: setattr(ops, "ell_spmm", orig))


def k9_held_int(val, idx, x, n_rows: int, rng) -> float:
    """K9 on one recorded call's planes with integer operands in the
    call's dtype (the combine's routing weights replaced by integers on
    its valid lanes), held bit for bit against its plain twin."""
    from repro_torch.kernels import ell_spmm as k9
    import torch
    dev = x.device
    v = torch.where(idx >= 0, int_tensor(rng, val.shape, dev), 0.0).to(
        val.dtype)
    xi = int_tensor(rng, x.shape, dev).to(x.dtype)
    return same(f"K9 partitioned ({tuple(val.shape)}) -> {n_rows}",
                k9.ell_spmm(v, idx, xi, n_rows),
                k9.ell_spmm_plain(v, idx, xi, n_rows))


def mesh_train_cuts(seed: int) -> tuple:
    """Training (a), (b), (d) on the 2-layer float32 cuts, TF32 off.
    Returns (summary, {path: counts})."""
    import torch
    from repro_torch import kernels
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    b, sq = MESH_TRAIN_TOKENS
    res, counts = {}, {}
    for arch, dispatch, shapes in MESH_TRAIN_CUTS:
        cfg = train_part_config(arch, dispatch, n_layers=2,
                                param_dtype="float32",
                                compute_dtype="float32")
        model = build_model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(
            seed + 41), dev)
        batch = {"tokens": torch.from_numpy(np.random.default_rng(
            seed + 42).integers(3, cfg.vocab, (b, sq)).astype(np.int32))
            .to(dev)}
        for shape in shapes:
            mesh = make_host_mesh(shape[1], mesh_devices(math.prod(shape)))
            what = f"{arch} {dispatch or ''} 2-layer cut on {shape}"
            want = part_step(model, params, batch, mesh)
            kernels.reset_launch_counts()
            r = res[what] = part_step_apart(model, params, batch, mesh, want)
            torch.cuda.synchronize()
            counts[f"mesh_train_cut_{arch}_{dispatch}_{shape[0]}x"
                   f"{shape[1]}"] = kernels.launch_counts()
            require(part_step_ok(r), f"training (a) {what}: "
                    f"{json.dumps(r)}")
            if arch == TRAIN_ARCH and dispatch == "sort" and shape == (2, 2):
                r["planted"] = {}
                for fault in MESH_TRAIN_PLANTS:
                    with train_plant(fault):
                        bad = part_step_apart(model, params, batch, mesh,
                                              want)
                    r["planted"][fault] = bad
                    require(not part_step_ok(bad), f"training (a) passed "
                            f"with '{fault}' planted: {json.dumps(bad)}")
                res["checkpoint"] = part_checkpoint(model, params, batch,
                                                    mesh)
            if dispatch == "spmm" and shape == (2, 2):
                res["k9"] = part_k9(model, params, batch, mesh, seed)
                counts["mesh_train_k9"] = res["k9"].pop("counts")
            del want
        del params, model
        gc.collect()
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = True
    print(f"[mesh] training (a) 2-layer float32 cuts, {b} x {sq} tokens, a "
          f"placed step against the same step on whole weights under the "
          f"same rules within {MESH_TRAIN_TOL} (params "
          f"{MESH_TRAIN_PARAM_TOL} where the sign is sure); both planted "
          f"faults caught; (b) K9 on each coordinate's own planes; (d) the "
          f"checkpoint across meshes, {gpu_line()}: {json.dumps(res)}",
          flush=True)
    return res, counts


def part_k9(model, params, batch, mesh, seed: int) -> dict:
    """Training (b): a placed forward of the ``'spmm'`` cut with K9's
    wrapper recording; each coordinate's dispatch and combine held bit for
    bit against the plain twin on integer operands, and K9's grids,
    counted from zero just before the forward, equal to coordinates × MoE
    layers × each call's grids."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import ell_spmm as k9
    from repro_torch.parallel import sharding_rules
    from repro_torch.parallel.sharding import mesh_coords
    cfg = model.cfg
    with sharding_rules(mesh):
        placed = model.place(params)
        calls, restore = k9_recorder()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        try:
            with torch.no_grad():
                model.loss(placed, batch)
            torch.cuda.synchronize()
            c = kernels.launch_counts()
        finally:
            restore()
    rng = np.random.default_rng(seed + 43)
    n_moe = cfg.n_layers - cfg.moe.first_dense_layers
    coords = len(mesh_coords(mesh))
    grids = [k9.grids(v.shape[0], v.shape[1], n, x.shape[1])
             for v, _, x, n in calls]
    err = max(k9_held_int(*call, rng) for call in calls)
    r = dict(calls=len(calls), grids=c["ell_spmm"],
             grids_want=sum(grids), coordinates=coords, moe_layers=n_moe,
             max_abs_err=err, shapes=sorted({(tuple(v.shape), n)
                                             for v, _, _, n in calls}),
             counts=c)
    require(len(calls) == 2 * coords * n_moe,
            f"training (b) K9 called {len(calls)} times, not 2 x {coords} "
            f"coordinates x {n_moe} MoE layers")
    require(c["ell_spmm"] == sum(grids) == coords * n_moe * (
        grids[0] + grids[1]), f"training (b) K9's grids {c['ell_spmm']} "
            f"against {sum(grids)}")
    del placed, calls
    return r


def part_checkpoint(model, params, batch, mesh) -> dict:
    """Training (d): the placed cut after one step saved on ``mesh`` (2,
    2) and restored onto (1, 4) and whole, bit for bit; save and restore
    ms and the checkpoint's bytes."""
    import tempfile
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.parallel import sharding_rules
    from repro_torch.parallel.sharding import Sharded
    other = make_host_mesh(4, mesh_devices(4))
    with tempfile.TemporaryDirectory() as d, sharding_rules(mesh):
        placed = model.place(tree_map(torch.clone, params))
        state = adamw_init(placed, model.specs())
        placed, state, _ = make_train_step(model, AdamWConfig())(
            placed, state, batch)
        mgr = CheckpointManager(d)
        _, save_ms = timed_ms(lambda: mgr.save(1, placed, state))
        n_bytes = sum(f.stat().st_size for f in Path(d).rglob("*")
                      if f.is_file())
        with sharding_rules(other):
            like = model.place(tree_map(torch.zeros_like, params),
                               adamw_init(params))
            (p14, o14, _), restore_ms = timed_ms(
                lambda: mgr.restore(1, *like))
        p1, o1, _ = mgr.restore(1, params, adamw_init(params))
        held = (lambda t: t.whole() if isinstance(t, Sharded) else t)
        ok = all(isinstance(t, Sharded) and t.mesh is other
                 for t in tree_leaves((p14, o14["mu"], o14["nu"])))
        for a, b14, b1 in zip(tree_leaves((placed, state)),
                              tree_leaves((p14, o14)), tree_leaves((p1, o1))):
            a = held(a)
            ok = (ok and bool(torch.equal(bits(a), bits(held(b14))))
                  and bool(torch.equal(bits(a), bits(b1.to(a.device)))))
    r = dict(save_ms=save_ms, restore_onto_1x4_ms=restore_ms,
             checkpoint_bytes=n_bytes, bit_equal=ok)
    require(ok, f"training (d) a leaf restored on (1, 4) or whole differs "
            f"from the one saved on (2, 2): {json.dumps(r)}")
    del placed, state, p14, o14, p1, o1, like
    return r


def mesh_serving(seed: int) -> tuple:
    """The partitioned serving program: (a), (b), (d) on the cuts, then
    (b) and (c) at full width. Returns (summary, {path: counts})."""
    from repro_torch import kernels
    kernels.reset_launch_counts()
    res = {"cuts": mesh_part_cuts(seed), "full": mesh_part_full(seed)}
    return res, {"mesh_serving": kernels.launch_counts()}


# The SSM, RG-LRU and encoder-decoder families, partitioned
MESH_FAM_MESHES = ((1, 4), (2, 2))
MESH_FAM_A = {"falcon-mamba-7b": (2, 512),    # (a): prompts x tokens on the
              "recurrentgemma-9b": (2, 128),  # float32 cuts (falcon: two
              "whisper-medium": (2, 64)}      # scan chunks)
MESH_FAM_LONG = (1, 3584)     # (a): recurrentgemma's prompt past its
                              # 2,048-slot window (whole 512-token chunks)
MESH_FAM_STEPS = 8            # (a): greedy decode steps after the prefill
MESH_FAM_GRAD_TOL = 3e-5      # (a): a training step's gradients and
                              # moments against their max: falcon-mamba's
                              # cut's whole-weights gradients on the card
                              # and on the CPU differ by 1.0e-5 of max
                              # (the [families] gate (c)), the float32
                              # floor of its scans' backward
MESH_FAM_PLANTS = ("w_x partial sums not all-reduced",
                   "ring rolled within each shard")
# (a): where each is planted. On (2, 2) the ring's shards hold 1,024
# slots: the window's roll by 3,584 % 2,048 = 1,536 cuts across them, and
# its first decode write lands in the second shard, so a roll within each
# shard is more than a permutation of the right ring
MESH_FAM_PLANTED = {
    ("falcon-mamba-7b", "prompt", (1, 4)): MESH_FAM_PLANTS[0],
    ("recurrentgemma-9b", "past the window", (2, 2)): MESH_FAM_PLANTS[1]}
MESH_FAM_SERVE = dict(max_batch=8, max_new_tokens=16, s_max=4128)
MESH_FAM_WAVES = {"falcon-mamba-7b": ((8, 64, 512),),   # (b): prompts,
                  "recurrentgemma-9b": ((8, 64, 512),   # shortest, longest
                                        (2, 2049, 3072))}
MESH_FAM_AUDIO = (8, 32, 448)  # (b) whisper: prompts, tokens, s_max
MESH_FAM_TRAIN = {"falcon-mamba-7b": (16, 4, 512),      # (c): layers,
                  "recurrentgemma-9b": (6, 4, 512),     # batch, seq
                  "whisper-medium": (None, 8, 256)}
MESH_FAM_TRAIN_STEPS = 3


def fam_meta_trace(kind: str, arch: str, shape, batch: int, seq: int,
                   layers=None, s_max=None) -> tuple:
    """The dry run's count of one partitioned call of a family's full-width
    config (bfloat16, ``layers`` kept): a prefill of ``batch`` x ``seq``
    (its cache at ``s_max``), a decode step against a cache of ``seq``, or
    a training step of ``batch`` x ``seq``
    (``launch.dryrun.collective_trace`` on a meta mesh of ``shape``),
    ``(bytes, count)`` by kind. Runs on the CPU alone, in a worker process
    beside the card's work."""
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCase
    from repro_torch.launch import dryrun, steps
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import make_mesh, sharding_rules
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = build_model(cfg)
    case = ShapeCase(kind, seq, batch, kind)
    mesh = make_mesh(shape, ("data", "model"), ["meta"] * math.prod(shape))
    with sharding_rules(mesh):
        if kind == "train":
            return dryrun.collective_trace(
                model, case, steps.make_train_step(model, AdamWConfig()),
                steps.abstract_train_args(model, case))
        if kind == "prefill":
            return dryrun.collective_trace(
                model, case, steps.make_prefill_step(model, s_max or seq),
                steps.abstract_prefill_args(model, case))
        aparams, acache, tokens = steps.abstract_decode_args(model, case)
        return dryrun.collective_trace(
            model, case, steps.make_serve_step(model),
            (aparams, {**acache, "pos": seq - 1}, tokens))


def fam_meta_traces(pool) -> dict:
    """The families' dry-run traces for serving (b) and training (c),
    submitted to ``pool``: futures by (arch, what)."""
    out, s_max = {}, MESH_FAM_SERVE["s_max"]
    for arch, waves in MESH_FAM_WAVES.items():
        for i, (n, _, hi) in enumerate(waves):
            out[(arch, f"prefill{i}")] = pool.submit(
                fam_meta_trace, "prefill", arch, (1, 4), n, hi, None, s_max)
            out[(arch, f"decode{i}")] = pool.submit(
                fam_meta_trace, "decode", arch, (1, 4), n, s_max)
    n, s, s_max = MESH_FAM_AUDIO
    out[("whisper-medium", "prefill0")] = pool.submit(
        fam_meta_trace, "prefill", "whisper-medium", (1, 4), n, s, None,
        s_max)
    out[("whisper-medium", "decode0")] = pool.submit(
        fam_meta_trace, "decode", "whisper-medium", (1, 4), n, s_max)
    for arch, (layers, b, sq) in MESH_FAM_TRAIN.items():
        for shape in ((1, 4), (2, 2)) if layers is None else ((1, 4),):
            out[(arch, f"train{shape}")] = pool.submit(
                fam_meta_trace, "train", arch, shape, b, sq, layers)
    return out


@contextlib.contextmanager
def mesh_fam_plant(fault: str):
    """(a)'s planted faults, within the block: each shard's Mamba mixer
    using its own partial sums of ``w_x`` (the all-reduce dropped), or
    each shard's slots of a ``local`` block's ring taken as its own piece
    of the last W keys rolled within the shard by ``s % W`` (the whole
    ring's roll, which crosses the shards' bounds)."""
    import torch
    from repro_torch.models import ssm, transformer
    from repro_torch.parallel.sharding import matmul
    if fault == MESH_FAM_PLANTS[0]:
        mod, name = ssm, "x_proj_sharded"
        bad = (lambda p, xc, dtype: matmul(xc, p["w_x"], dtype))
    else:
        mod, name = transformer, "_ring_block"
        orig_ring = transformer._ring_block

        def bad(kb, s, w, lo, n):
            if s < w:
                return orig_ring(kb, s, w, lo, n)
            require(s % w % n and s % w >= n, f"a roll by {s % w} within "
                    f"{n}-slot shards only permutes the ring's first slots")
            return torch.roll(kb[:, s - w + lo:s - w + lo + n], s % w, 1)
    orig = getattr(mod, name)
    setattr(mod, name, bad)
    try:
        yield
    finally:
        setattr(mod, name, orig)


def mesh_fam_cuts(seed: int) -> dict:
    """The families' (a): float32 cuts at full width (FAM_CUT's layers),
    TF32 off, placed on MESH_FAM_MESHES against whole weights under the
    same rules: prefill and MESH_FAM_STEPS greedy steps (recurrentgemma
    also past its window), one training step, both planted faults, and
    whisper's checkpoint saved on (2, 2) and restored onto (1, 4)."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.parallel import sharding_rules
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    res = {}
    for arch in FAM_ARCHS:
        cfg = fam_config(arch, param_dtype="float32", compute_dtype="float32",
                         **FAM_CUT[arch])
        model = build_model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(
            seed + 51), dev)
        rng = np.random.default_rng(seed + 52)
        b, sq = MESH_FAM_A[arch]
        extra = ({"frames": fam_frames(cfg, b, seed + 53)}
                 if cfg.family == "audio" else {})
        prompts = {"prompt": (b, sq)}
        if cfg.family == "hybrid":
            prompts["past the window"] = MESH_FAM_LONG
        toks = {k: torch.from_numpy(rng.integers(3, cfg.vocab, shp).astype(
            np.int32)).to(dev) for k, shp in prompts.items()}
        r = res[arch] = {}
        t_arch = time.perf_counter()
        # no MoE: the whole-weights step does not depend on the mesh
        batch = dict(extra, tokens=toks["prompt"])
        want_step = part_step(model, params, batch, make_host_mesh(
            1, mesh_devices(1)))
        for shape in MESH_FAM_MESHES:
            mesh = make_host_mesh(shape[1], mesh_devices(math.prod(shape)))
            held = r[f"{shape}"] = {}
            with sharding_rules(mesh):
                placed = model.place(params)
                for name, t in toks.items():
                    s_max = t.shape[1] + 2 * MESH_FAM_STEPS
                    want = part_greedy(model, params, t, MESH_FAM_STEPS,
                                       s_max, extra)
                    got = part_greedy(model, placed, t, MESH_FAM_STEPS,
                                      s_max, extra)
                    h = held[name] = part_apart(got, want)
                    require(h["worst_rel"] <= MESH_PART_TOL
                            and h["tokens_equal"],
                            f"families (a) {arch} cut on {shape}, {name}: "
                            f"{json.dumps(h)}")
                    fault = MESH_FAM_PLANTED.get((arch, name, shape))
                    if fault:
                        with mesh_fam_plant(fault):
                            bad = part_apart(part_greedy(
                                model, placed, t, MESH_FAM_STEPS, s_max,
                                extra), want)
                        h["planted"] = {fault: bad}
                        require(bad["worst_rel"] > MESH_PART_TOL
                                or not bad["tokens_equal"],
                                f"families (a) passed with '{fault}' "
                                f"planted: {json.dumps(bad)}")
                    del want, got
                del placed
            st = held["train_step"] = part_step_apart(model, params, batch,
                                                       mesh, want_step)
            require(part_step_ok(st, MESH_FAM_GRAD_TOL),
                    f"families (a) {arch} cut on {shape}, training step: "
                    f"{json.dumps(st)}")
            if cfg.family == "audio" and shape == (2, 2):
                r["checkpoint"] = part_checkpoint(model, params, batch, mesh)
        del want_step
        r["arch_s"] = time.perf_counter() - t_arch
        print(f"[mesh] families (a) {arch}, {gpu_line()}: {json.dumps(r)}",
              flush=True)
        del params, model
        gc.collect()
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = True
    print(f"[mesh] families (a) passed: float32 cuts at full width, "
          f"placed on {MESH_FAM_MESHES} against whole weights under the same "
          f"rules, prefill and {MESH_FAM_STEPS} greedy steps within "
          f"{MESH_PART_TOL} (recurrentgemma also {MESH_FAM_LONG} past its "
          f"window), a training step within {MESH_FAM_GRAD_TOL}, both "
          f"planted faults caught, whisper's checkpoint (2, 2) -> (1, 4) "
          f"bit for bit", flush=True)
    return res


def fam_collectives(live, parts) -> tuple:
    """The dry run's count of ``parts`` ((future, times) pairs) summed,
    beside ``live``'s kinds."""
    out = tuple({k: 0 for k in live[i]} for i in range(2))
    for fut, times in parts:
        meta = fut.result()
        for i in range(2):
            for k in out[i]:
                out[i][k] += times * meta[i][k]
    return out


def mesh_fam_serve(seed: int, metas: dict) -> dict:
    """The families' (b): full width, bfloat16, on (1, 4): falcon-mamba-7b
    and recurrentgemma-9b through ``ServingEngine.generate_batch``
    (MESH_FAM_WAVES), whisper-medium through ``Model.prefill`` /
    ``decode_step`` (MESH_FAM_AUDIO); live collectives equal to the dry
    run's of the same calls."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.parallel import mesh as pmesh
    from repro_torch.parallel import sharding_rules
    from repro_torch.parallel.sharding import Sharded
    from repro_torch.serve import ServeConfig, ServingEngine
    dev = torch.device("cuda")
    mesh = make_host_mesh(4, mesh_devices(4))
    res = {}
    for arch in FAM_ARCHS:
        cfg = fam_config(arch)
        model = build_model(cfg)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with sharding_rules(mesh):
            params = model.place(model.init(torch.Generator(
                device=dev).manual_seed(seed + 54), dev))
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t0
        require(all(isinstance(t, Sharded) for t in tree_leaves(params)),
                f"families (b) {arch}: a weight is not placed")
        if cfg.family == "audio":
            waves = [None]
        else:
            waves = lm_prompts(seed, cfg.vocab, MESH_FAM_WAVES[arch])
            eng = ServingEngine(model, params, ServeConfig(**MESH_FAM_SERVE))
        for i, prompts in enumerate(waves):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            pmesh.reset_moved_bytes()
            pmesh.reset_collectives()
            with sharding_rules(mesh):
                if prompts is None:
                    r = fam_audio_wave(model, params, seed)
                else:
                    r = fam_wave(eng, prompts)
            torch.cuda.synchronize()
            live = pmesh.collectives()
            want = fam_collectives(live, (
                (metas[(arch, f"prefill{i}")], 1),
                (metas[(arch, f"decode{i}")], r["decode_steps"])))
            what = f"{arch} {cfg.n_layers} layers bf16 on (1, 4), wave {i + 1}"
            r.update(init_and_place_s=place_s,
                     peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                     moved_bytes=pmesh.moved_bytes(),
                     collective_bytes=live[0], collective_count=live[1],
                     dry_collective_bytes=want[0],
                     dry_collective_count=want[1])
            res[what] = r
            print(f"[mesh] families (b) {what}, {gpu_line()}: "
                  f"{json.dumps(r)}", flush=True)
            require(live == want, f"families (b) {what}: the live "
                    f"collectives {live} against the dry run's {want}")
        del params, model
        if cfg.family != "audio":
            del eng
        gc.collect()
        torch.cuda.empty_cache()
    return res


def fam_wave(eng, prompts) -> dict:
    """One wave through ``generate_batch`` on placed weights."""
    st0 = dict(eng.stats())
    outs = eng.generate_batch(prompts)
    st = eng.stats()
    d = {k: st[k] - st0.get(k, 0) for k in ("requests", "tokens",
                                            "decode_steps", "prefill_s",
                                            "decode_s")}
    require(d["requests"] == len(prompts) and d["decode_steps"] > 0
            and d["tokens"] == sum(len(o) for o in outs),
            f"families (b): stats {d}")
    return dict(requests=d["requests"], padded_len=max(map(len, prompts)),
                prefill_ms=d["prefill_s"] * 1e3,
                decode_ms_per_step=d["decode_s"] * 1e3 / d["decode_steps"],
                decode_steps=d["decode_steps"], tokens=d["tokens"],
                tokens_per_s=d["tokens"] / (d["prefill_s"] + d["decode_s"]))


def fam_audio_wave(model, params, seed: int) -> dict:
    """whisper on placed weights: MESH_FAM_AUDIO's prompts over frames
    from ``seed``, then MESH_FAM_SERVE's token count of greedy steps, each
    step's ids read on the host."""
    import torch
    cfg = model.cfg
    dev = torch.device("cuda")
    n, s, s_max = MESH_FAM_AUDIO
    toks = torch.from_numpy(np.random.default_rng(seed + 55).integers(
        3, cfg.vocab, (n, s)).astype(np.int32)).to(dev)
    frames = fam_frames(cfg, n, seed + 55)
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": toks,
                                               "frames": frames}, s_max)
        cur = logits.whole().argmax(-1).cpu()
        t1 = time.perf_counter()
        outs = [cur]
        for _ in range(MESH_FAM_SERVE["max_new_tokens"] - 1):
            logits, cache = model.decode_step(
                params, cache, cur[:, None].to(dev, torch.int32))
            cur = logits.whole().argmax(-1).cpu()
            outs.append(cur)
        t2 = time.perf_counter()
    ids = torch.stack(outs, 1)
    require(bool(((ids >= 0) & (ids < cfg.vocab)).all()),
            f"families (b) {cfg.name}: a token is out of the vocabulary")
    steps = len(outs) - 1
    return dict(requests=n, prompt_len=s, frames=list(frames.shape),
                s_max=s_max, prefill_ms=(t1 - t0) * 1e3,
                decode_ms_per_step=(t2 - t1) * 1e3 / steps,
                decode_steps=steps, tokens=ids.numel(),
                tokens_per_s=ids.numel() / (t2 - t0))


def mesh_fam_train(seed: int, metas: dict) -> dict:
    """The families' (c): bfloat16, MESH_FAM_TRAIN_STEPS steps each, the
    counters zeroed just before each run: falcon-mamba-7b and
    recurrentgemma-9b cut to MESH_FAM_TRAIN's layers through
    ``runtime.Trainer`` on (1, 4), whisper-medium whole through
    ``launch.train.main(..., devices=...)`` on (1, 4) and (2, 2); live
    collectives equal to the steps times the dry run's of one step."""
    import tempfile
    import torch
    from repro_torch.launch import train as tlaunch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import mesh as pmesh
    from repro_torch.parallel import sharding_rules
    from repro_torch.runtime import Trainer, TrainerConfig
    steps = MESH_FAM_TRAIN_STEPS
    res = {}
    for arch, (layers, b, sq) in MESH_FAM_TRAIN.items():
        for shape in ((1, 4), (2, 2)) if layers is None else ((1, 4),):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            pmesh.reset_moved_bytes()
            pmesh.reset_collectives()
            with tempfile.TemporaryDirectory() as d:
                if layers is None:
                    out = tlaunch.main([
                        "--arch", arch, "--steps", str(steps), "--batch",
                        str(b), "--seq", str(sq), "--ckpt-dir", d,
                        "--ckpt-every", str(10 * steps), "--no-resume",
                        "--log-every", "1", "--model-parallel",
                        str(shape[1])], devices=mesh_devices(4))
                    mesh, init_s = out["mesh"], out["trainer"].init_s
                else:
                    mesh = make_host_mesh(shape[1], mesh_devices(4))
                    with sharding_rules(mesh):
                        tr = Trainer(build_model(fam_config(
                            arch, n_layers=layers)), TrainerConfig(
                            steps=steps, ckpt_dir=d, ckpt_every=10 * steps,
                            log_every=1, global_batch=b, seq_len=sq,
                            seed=seed), AdamWConfig(),
                            device=mesh.devices.flat[0])
                        out = dict(tr.run(resume=False), mesh=mesh)
                    init_s = tr.init_s
            torch.cuda.synchronize()
            live = pmesh.collectives()
            want = fam_collectives(live, (
                (metas[(arch, f"train{shape}")], steps),))
            what = (f"{arch} {layers or 'all'} layers bf16 {b} x {sq} on "
                    f"{mesh.shape}")
            r = mesh_train_steps(out, b * sq, what)
            r.update(init_s=init_s, collective_bytes=live[0],
                     collective_count=live[1], dry_collective_bytes=want[0],
                     dry_collective_count=want[1])
            res[what] = r
            print(f"[mesh] families (c) {what}, {gpu_line()}: "
                  f"{json.dumps(r)}", flush=True)
            require(live == want, f"families (c) {what}: the live "
                    f"collectives {live} against the dry run's {want}")
            del out
    gc.collect()
    torch.cuda.empty_cache()
    return res


def mesh_families(seed: int, metas: dict) -> tuple:
    """The SSM, RG-LRU and encoder-decoder families' partitioned programs:
    (a) the cuts, (b) full-width serving, (c) full-width training.
    Returns (summary, {path: counts})."""
    import resource
    from repro_torch import kernels
    t0 = time.perf_counter()
    print(f"[mesh] families: host peak RSS so far "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f}"
          f" GiB", flush=True)
    kernels.reset_launch_counts()
    res = {"cuts": mesh_fam_cuts(seed), "serve": mesh_fam_serve(seed, metas),
           "train": mesh_fam_train(seed, metas)}
    res["part_s"] = time.perf_counter() - t0
    return res, {"mesh_families": kernels.launch_counts()}


def mesh_phase(seed: int):
    """The LM under a mesh (see the module docstring, phase 6i). Returns
    ({path: counts}, summary)."""
    import torch
    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    summary = {"card": gpu_line(), "cards": cards,
               "shards_on": "cards" if cards >= MESH_SHARDS
               else f"cuda:0 x {MESH_SHARDS}"}
    print(f"[mesh] shards on {summary['shards_on']}", flush=True)
    counts = {}
    # the dry run's traces of training (c)'s steps: CPU work, in two
    # worker processes beside the card's, stopped with the phase
    with concurrent.futures.ProcessPoolExecutor(
            2, mp_context=multiprocessing.get_context("spawn")) as pool:
        metas = train_meta_traces(pool)
        fam_metas = fam_meta_traces(pool)
        for part, fn in (("cut", mesh_gates_ad), ("training_cuts",
                                                  mesh_train_cuts),
                         ("serve", mesh_serve), ("serving", mesh_serving)):
            summary[part], c = fn(seed)
            counts.update(c)
        summary["training"], c, shapes = mesh_train(seed, metas)
        counts.update(c)
        summary["families"], c = mesh_families(seed, fam_metas)
        counts.update(c)
    summary["phase_s"] = time.perf_counter() - t_phase
    print(f"[mesh] gates (a), (b), (d), (e), serving (a)-(d), training "
          f"(a)-(d) and the families' (a)-(c) passed; phase "
          f"{summary['phase_s']:.1f} s", flush=True)
    return counts, summary, shapes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the operand's integer values")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on "
              "a GPU and has nothing to run here", file=sys.stderr)
        return 2
    if not (REPO / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {REPO / 'src' / 'repro_torch'} not found; run "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    import scipy
    import repro_torch
    from repro_torch.core.formats import (from_numpy, np_ell_cols_from_scipy,
                                          np_ell_rows_from_scipy)
    from repro_torch.kernels import _build

    # -- phase 1: the card and the build --------------------------------------
    card = gpu_line()
    print(f"[gpu] {card}", flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} scipy {scipy.__version__} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    build_s = _build.build_all()
    print(f"[build] kernels built in {build_s:.2f} s", flush=True)
    for src in sorted(_build.SRC_DIR.glob("*.cu")):
        entry = ""                        # the (mangled) kernel reported on
        for line in _build.build_log(src.stem).splitlines():
            if "Function properties for" in line:
                entry = line.split()[-1]
            elif "registers" in line or "spill" in line:
                print(f"[ptxas] {src.stem} {entry}: {line.strip()}",
                      flush=True)

    # -- the operand: bcsstk32, C = A·Aᵀ ----------------------------------------
    t0 = time.perf_counter()
    A = table1_matrix(BCSSTK32, args.seed)
    A_csc = A.tocsc()
    k = int(np.diff(A_csc.indptr).max())          # lossless ELLPACK width
    dev = torch.device("cuda")
    a = from_numpy(*np_ell_rows_from_scipy(A_csc, k), n_rows=A.shape[0],
                   device=dev)
    b = from_numpy(*np_ell_cols_from_scipy(A.T.tocsr(), k), n_cols=A.shape[0],
                   device=dev)
    A64 = A.astype(np.float64)
    c_ref = (A64 @ A64.T).tocsr()
    pattern = A64.copy()
    pattern.data[:] = 1.0
    nnz_c = int((pattern @ pattern.T).nnz)
    products = int(repro_torch.count_products(a, b))
    print(f"[operand] {BCSSTK32[1]}: dim {A.shape[0]} nnz {A.nnz} k {k} "
          f"lanes {k * A.shape[0] * k} products {products} nnz(C) {nnz_c} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    # one column of the contraction: A[:, c]·A[:, c]ᵀ has nnz_c² coordinates
    cut = int(np.argmin(np.abs(np.diff(A_csc.indptr) - 20)))
    A_cut = A_csc[:, [cut]]
    a_cut = from_numpy(*np_ell_rows_from_scipy(A_cut, k), n_rows=A.shape[0],
                       device=dev)
    b_cut = from_numpy(*np_ell_cols_from_scipy(A_cut.T.tocsr(), k),
                       n_cols=A.shape[0], device=dev)

    # -- phase 2: kernels against their plain versions ------------------------
    rows = check_kernels(a, b, a_cut, b_cut)
    plan = plan_sizes(a, b, nnz_c)
    rows += check_accumulator_kernels(a, b, plan)
    rows.append(check_stream_kernel(a, b))

    # -- the warm phase's structures (symbolic, once) --------------------------
    structures, build_ms = {}, {}
    for backend in ("sort", "stream"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        structures[backend] = repro_torch.make_structure(a, b,
                                                         backend=backend)
        torch.cuda.synchronize()
        build_ms[backend] = (time.perf_counter() - t0) * 1e3
        require(int(structures[backend].nnz) == nnz_c,
                f"structure({backend}) nnz {int(structures[backend].nnz)}")
    print(f"[structure] make_structure ms {json.dumps(build_ms)}", flush=True)
    check_numeric_kernels(a, b, structures, rows)

    # -- phase 3: the main path -------------------------------------------------
    counts, out = drive_paths(a, b, a_cut, b_cut, structures)
    require(counts["search_faithful_cut"]["minima_mask"] == 1,
            f"faithful path launched "
            f"{counts['search_faithful_cut']['minima_mask']} minima_mask "
            "kernels, not 1 (the emission in one launch)")
    for acc, kernels_run in (*BACKEND_KERNELS.items(),
                             ("numeric_sort", ("sccp_multiply",
                                               "align_product_keys")),
                             ("numeric_stream", ("sccp_multiply",
                                                 "align_keys"))):
        for kname in kernels_run:
            require(counts[acc][kname] > 0, f"{acc} path skipped {kname}")
    require(counts["bucket"]["bin_ranks"] == 3,
            f"bucket path launched {counts['bucket']['bin_ranks']} K7 grids, "
            "not 3 (count, scan, place)")
    c_sort = out["sort"][0]
    check_against_scipy("sort", c_sort, c_ref, nnz_c)
    others = ACCUMULATORS[1:] + tuple(f"numeric_{s}" for s in structures)
    for acc in others:
        for f in ("row", "col", "val", "ngroups"):
            same(f"sort vs {acc} .{f}", getattr(out[acc][0], f),
                 getattr(c_sort, f))
    print(f"[check] sort == scipy A @ A.T, ngroups {nnz_c} == nnz(C); "
          f"{', '.join(others)} == sort bit for bit (row, col, val, "
          "ngroups)", flush=True)
    require(counts["stream"]["sccp_multiply"] == 0,
            "stream path materialized the product stream through K1")
    stream_ms, compact = stream_stage_ms(a, b, out["stream"][0])
    next(r for r in rows if r["name"] == "merge_runs")["shapes"].append(
        compact)
    stream_ms.update(numeric_stream_stage_ms(a, b, structures["stream"],
                                             out["numeric_stream"][0]))
    # a stale structure (one product moved to a row its column lacks) with
    # validate=False must poison ngroups
    st = structures["sort"]
    idx = a.idx.clone()
    s0, c0 = (int(x) for x in torch.nonzero(idx >= 0)[0])
    free = np.setdiff1d(np.arange(a.n_rows), idx[:, c0].cpu().numpy())
    idx[s0, c0] = int(free[0])
    a_stale = repro_torch.EllRows(val=a.val, idx=idx, n_rows=a.n_rows)
    stale = repro_torch.spgemm(a_stale, b, structure=st, validate=False)
    require(int(stale.ngroups) > st.out_cap,
            f"stale structure not poisoned: ngroups {int(stale.ngroups)}")
    print(f"[check] stale structure (validate=False): ngroups "
          f"{int(stale.ngroups)} > out_cap {st.out_cap}", flush=True)
    del stale, a_stale, idx
    c_f = out["search_faithful_cut"][0]
    A_cut64 = A_cut.astype(np.float64)
    cut_ref = (A_cut64 @ A_cut64.T).tocsr()
    check_against_scipy("faithful cut", c_f, cut_ref,
                        int(np.diff(A_csc.indptr)[cut]) ** 2)
    c_fb = repro_torch.spgemm(a_cut, b_cut, accumulator="search",
                              out_cap=c_f.cap)
    for f in ("row", "col", "val", "ngroups"):
        same(f"faithful vs batched .{f}", getattr(c_f, f), getattr(c_fb, f))
    print(f"[check] faithful cut (column {cut}): == batched search, == scipy",
          flush=True)
    del out, c_sort, c_f, c_fb
    torch.cuda.empty_cache()

    # -- end-to-end times, three more calls each; the first one's peak --------
    # device memory (reset just before it), and what the call itself added
    # on top of the resident operands and structures. With out_cap="auto"
    # every cold call's peak includes its symbolic pass; a call given its
    # backend's plan ("planned") shows the accumulation's own footprint.
    from repro_torch.plan.planner import make_plan
    plans = {acc: make_plan(a, b, backend=acc) for acc in ACCUMULATORS}
    calls = {acc: (lambda acc=acc: repro_torch.spgemm(a, b, accumulator=acc))
             for acc in ACCUMULATORS}
    for backend, st in structures.items():
        calls[f"numeric_{backend}"] = (
            lambda st=st: repro_torch.spgemm(a, b, structure=st))
    e2e, peak, planned_peak = {}, {}, {}
    for name, fn in calls.items():
        peak[name] = peak_of(fn)[1]
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        e2e[name] = times
    for acc, p in plans.items():
        planned_peak[acc] = peak_of(
            lambda: repro_torch.spgemm(a, b, plan=p))[1]
    # one cold 'stream' call under the profiler: the device's busy share of
    # the call's host-clock time, and its kernels by device time
    kern_ms, wall = profile_ms(calls["stream"], reps=1)
    busy = sum(kern_ms.values())
    stream_profile = dict(wall_ms=wall, device_ms=busy,
                          busy_share=busy / wall,
                          kernels_ms=dict(list(kern_ms.items())[:12]))
    print(f"[profile] cold 'stream' call: {json.dumps(stream_profile)}",
          flush=True)
    print(json.dumps({"e2e_ms": e2e, "peak_mem_per_call": peak,
                      "peak_mem_per_planned_call": planned_peak,
                      "make_structure_ms": build_ms,
                      "stream_profile": stream_profile,
                      "stage_ms": {**stage_ms(a, b), **stream_ms,
                                   **numeric_stage_ms(a, b,
                                                      structures["sort"])},
                      "operand": BCSSTK32[1], "nnz_c": nnz_c}), flush=True)
    del plans, calls
    torch.cuda.empty_cache()

    # -- phase 4b: backend selection on A·Aᵀ and on A's first 1/8 columns ------
    cols = A.shape[1] // CUT_PART
    A8 = A_csc[:, :cols]
    k8 = int(np.diff(A8.indptr).max())
    a8 = from_numpy(*np_ell_rows_from_scipy(A8, k8), n_rows=A.shape[0],
                    device=dev)
    b8 = from_numpy(*np_ell_cols_from_scipy(A8.T.tocsr(), k8),
                    n_cols=A.shape[0], device=dev)
    sel = []
    for name, x, y in ((BCSSTK32[1], a, b), (f"{BCSSTK32[1]}_cols{cols}",
                                             a8, b8)):
        sel_counts, summary = selection_phase(name, x, y)
        counts.update(sel_counts)
        sel.append(summary)
        torch.cuda.empty_cache()
    fit_cuda_costs(sel)
    for summary in sel:
        check_selection(summary)

    # -- phases 5-6: the SpMM slice ---------------------------------------------
    del a, b, a_cut, b_cut, a8, b8, x, y, st, structures
    torch.cuda.empty_cache()
    spmm_rows, spmm_counts, spmm_summary = spmm_slice(args.seed)
    rows += spmm_rows
    counts.update(spmm_counts)
    print(json.dumps(spmm_summary), flush=True)

    # -- phase 6b: the serving engine's SpGEMM lane ----------------------------
    serve_counts, _ = serve_phase(A, args.seed)
    counts.update(serve_counts)

    # -- phase 6c: the hybrid ELLPACK + COO format ------------------------------
    hybrid_counts, _ = hybrid_phase(A)
    counts.update(hybrid_counts)

    # -- phase 6d: the distributed SpGEMM on four shards of the card ---------
    dist_counts, _ = dist_phase(A, c_ref, nnz_c, args.seed)
    counts.update(dist_counts)
    del c_ref, A, A_csc, A_cut, A64, pattern

    # -- phase 6e: token serving on the LM stack ------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[lm] resident before the phase: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    lm_shapes, lm_counts, lm_summary = lm_phase(args.seed)
    counts.update(lm_counts)
    next(r for r in rows if r["name"] == "ell_spmm")["shapes"] += lm_shapes
    print(json.dumps({"lm": lm_summary}), flush=True)

    # -- phase 6f: training on the LM stack ---------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[train] resident before the phase: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    k9_train, k10_train, train_counts, train_summary = train_phase(args.seed)
    counts.update(train_counts)
    next(r for r in rows if r["name"] == "ell_spmm")["shapes"] += k9_train
    next(r for r in rows if r["name"] == "nm_spmm")["shapes"] += k10_train
    print(json.dumps({"train": train_summary}), flush=True)

    # -- phase 6g: the SSM, RG-LRU and encoder-decoder families -------------
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[families] resident before the phase: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    fam_counts, fam_summary = families_phase(args.seed)
    counts.update(fam_counts)
    print(json.dumps({"families": fam_summary}), flush=True)

    # -- phase 6h: the dry run held against the card ---------------------------
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[dryrun] resident before the phase: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    dry_counts, dry_summary = dryrun_phase(args.seed)
    counts.update(dry_counts)
    print(json.dumps({"dryrun": dry_summary}), flush=True)

    # -- phase 6i: the LM under a mesh ---------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[mesh] resident before the phase: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    mesh_counts, mesh_summary, mesh_shapes = mesh_phase(args.seed)
    counts.update(mesh_counts)
    next(r for r in rows if r["name"] == "ell_spmm")["shapes"] += mesh_shapes
    print(json.dumps({"mesh": mesh_summary}), flush=True)

    # -- phase 7: the kernels line and the result ------------------------------
    for r in rows:
        r["launches"] = sum(c[r["name"]] for c in counts.values())
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "grids", "shapes", "tree_ms", "entries")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in rows]}), flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
