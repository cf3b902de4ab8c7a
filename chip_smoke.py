#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--out results.json]

Needs one CUDA card (written for the H100, sm_90a) and ``nvcc``.  Phases,
each of which fails the run if it fails:

  1. build  — compile the port's CUDA kernels from ``src/repro_torch/
     kernels/csrc`` (``nvcc``, in parallel) and print ptxas's report;
  2. kernels — hold each kernel against its plain PyTorch version on the
     card, at the serving shapes (decode: B=8, H=KH=16, d=128, S=1024,
     ragged lengths with 0; prefill: B=8, H=16, T=128, d=128) and at small
     GQA / window / softcap / ragged-T shapes; time the kernel, the plain
     version and ``F.scaled_dot_product_attention`` (a yardstick only: the
     port never calls it) with CUDA events over inputs rotated past the
     50 MB L2, the card held for 20 ms or more first so the host queues
     the timed calls (the time is the card's, not the host's launch pace;
     the single-table lookup's 150 calls a batch log the host's ms beside
     it), kernel
     and SDPA in alternating turns (kernel, SDPA, SDPA, kernel); compute
     each kernel's bound from the bytes and flops these inputs need; then
     the pooled and int8 decode kernels at the serving
     decode shape (`pooled_kernel_phase`: a pool of 1024 blocks of 16
     rows, permuted tables with 4 shared blocks, ``quantize_kv`` of the
     same K/V; the int8 rows through ``ops`` once, counted), each against
     its plain version and the pooled ones bitwise the per-slot kernels on
     the gathered view; timed beside their plain versions and byte
     bounds, with SDPA on the gathered bf16 view (the gather apart) as a
     yardstick, in turns with the three kernels;
  3. reference — reduced olmo-1b with the same weights on the CPU (plain
     attention) and on the card (kernels): prefill and decode logits agree;
  4. serve — full-width olmo-1b (16 layers, d_model 2048, vocab 50304; bf16
     weights from a seeded generator) in ``ServeEngine(SliceSpec(slots=8,
     max_len=1024, prompt_len=128, chunk=8))``: 16 requests with ragged
     prompts of 32-128 tokens and 128 new tokens each (two admission
     waves).  Launch counters are zeroed just before ``run()`` and read
     just after: both kernels must have run on the main path.  Its memory
     is freed before the DLRM phases.
 4b. pooled decode — full-width olmo-1b over a pooled cache (1024 blocks
     of 16 rows, 8 slots of 64 blocks; prompts of 64-128 tokens from
     ``api.prefill_slot`` copied in; slots 0 and 1 share 4 blocks; slot 7
     unadmitted): 16 greedy steps of ``decode_step_paged(tables=)`` (the
     pooled kernel, counted), the same loop on the view gathered once, and
     ``api.decode_n(tables=)``: logits bitwise equal on the admitted
     slots, equal tokens, equal pools, no other pool row touched;
 4c. pooled engine — full-width olmo-1b in three ``ServeEngine``s on one
     shared-header trace (24 requests: one of 2 tiers' 224-token header,
     on half of them one of 2 16-token few-shot preambles, a tail of 8-32
     tokens within ``prompt_len``; 32 new tokens each): pooled with
     sharing (``benchmarks/kv_prefix.py``'s ``SliceSpec(slots=8,
     max_len=288, prompt_len=256, chunk=8, kv_block=16, suffix_len=64)``),
     pooled with ``kv_share=False`` and the dense spec of the same
     envelope, each counted on its own.  Share and no-share streams
     bitwise equal, ``kv_close`` finds every block back, sharing cuts
     ``prefill_flops_proxy`` and shares tokens, the pooled runs launch
     row 1 and never the flash kernel.  Reports tokens/s, TTFT, ms a
     decode chunk, ms a prefill dispatch (a suffix dispatch and a dense
     admission by CUDA events), a profile of one suffix dispatch, peak
     memory;
 4d. int8 weights — the serve phase's 16 requests in
     ``ServeEngine(SliceSpec(..., quant="int8"))``, counted (rows 1 and 2
     launched), then an engine on ``dequantize_params`` of the same
     quantised tree: streams bitwise equal.  Reports weight storage bytes
     against the bf16 tree's (0.5156), tokens/s and TTFT of both, and a
     profile of one decode chunk of each (the device time that
     dequantising every weight at its use adds a step);
  5. DLRM reference — reduced dlrm0 with the same weights and batch on the
     CPU (plain versions) and on the card (kernels): the logits of both
     lookup routes agree;
  6. DLRM kernels — the fused lookup, the row gather and the single-table
     lookup against their plain versions on the card: small edge cases
     (all ids -1, a mean slot with count 0, repeated rows, valency 1 and
     128, every dim; the single-table lookup at the fig9 shape V=8192,
     D=64, B=64, Vl=16), the int8 fused lookup at every dlrm0 width and
     the scatter of deduplicated ids (unique sorted ids with a -1 tail, a
     sorted stream with adjacent duplicates; bitwise), then the one-card
     dlrm0 (its 150 tables at published widths and valencies,
     vocabularies cut to 12e9 parameters = 48.0 GB f32, initialised on
     the card from seed 0 once) at B = 256 (the repo's per-chip batch:
     65,536 over 256 chips) and B = 4096 (a scoring batch for one card);
     the single-table lookup runs through ``ops.embedding_lookup``, one
     launch a table (counted), and is also held against the per-table
     route's result; each kernel is timed beside its plain version, its
     byte bound (each distinct row of the batch read once) and
     ``F.embedding_bag`` / ``F.embedding`` (yardsticks only: the port
     never calls them);
  7. DLRM scoring — ``api.forward`` on batches of B = 4096 from the port's
     ``make_batch``: 20 through the fused route, 3 through the per-table
     route, under ``torch.inference_mode()``.  Counters are zeroed just
     before and read just after: 1 fused launch a batch, 150 gathers a
     batch.  Reports samples/s, ms a batch, peak allocated memory (which
     shows that no padded copy of the 48 GB of tables was made) and the
     card's idle share over one batch.  Then the int8 fused lookup: the
     48 GB of tables quantised with ``quantize_row_space`` (12.0 GB int8
     + 0.76 GB of scales, peak < 66 GB checked), ``ops.fused_lookup_q``
     at B = 256 and 4096 (counted) against its plain version and, within
     the int8 rounding bound, the f32 fused lookup.  The tables are freed
     after.
  8. DLRM training reference — reduced dlrm0 with the same weights and
     batch on the CPU (plain versions) and on the card (kernels): one
     step's gradients agree through both lookup routes, the per-table one
     also with the fused one; then Adam on the same gradients agrees;
  9. fused-scatter kernel — the backward of the fused lookup against its
     plain version: small edge cases (a row named 10,000 times, invalid
     ids, every dim), then dlrm0 cut to 4e9 table parameters (16.0 GB f32)
     at B = 256 and B = 4096 from ``data/synthetic.Dataset``.  The kernel
     sums each row in (b, s) order, so it must equal, bit for bit, the
     plain version run with ``torch.use_deterministic_algorithms`` (whose
     ``index_add_`` sums duplicates in index order) and, on the small
     cases, the plain version on the CPU; two launches bitwise equal.  The
     whole call, the ordering alone, the kernel half alone (and its run
     and hot-run launches apart), the longest run alone and the zero fill
     alone are timed beside the plain version (default and deterministic),
     the byte bound and ``index_add_`` (one call a row space; a yardstick
     only); the batch's statistics (valid descriptors, distinct rows,
     longest run) come from the descriptors, not the key encoding.  At B = 4096, before the gradient is freed: each table's ids
     deduplicated (``dedup_ids``) and ``ops.embedding_scatter`` of its
     gradient rows (150 launches, counted) bitwise the table's slice of
     the gradient; timed whole, fill and kernel apart, beside the plain
     version and ``index_copy_``;
 10. training — ``Trainer.train`` on that dlrm0 at B = 4096 with
     ``OptimizerConfig(lr=3e-4, warmup_steps=20)``, as a user runs it:
     3 warm and 10 timed steps, each drawing its batch from
     ``Dataset.batch`` on the host (its calls timed apart), moving it to
     the card and stepping.  Counters are zeroed just before and read
     just after: one fused lookup and one fused scatter a step.  Then the
     same 13 batches, staged on the card first, through the train step
     alone (3 warm, 10 timed).  Reports ms a step and samples/s of both
     runs, the losses (all finite), that the params moved, the peak
     allocated memory of the user's run (< 72 GB: params, gradient, m and
     v of the tables are 64 GB), one step split into forward + backward
     and Adam, and the card's busy time by kernel and idle share over one
     profiled step of the user's loop and one on a batch on the card.
 11. per-table training — ``Trainer.train`` with
     ``ParallelConfig(emb_pipeline=False)`` on the same cut at B = 256, 2
     steps: one gather a table and one fused scatter a row space a step
     (counted), finite losses, params that move, peak < 72 GB.
 12. dense training — full-width olmo-1b (16 layers, d_model 2048, vocab
     50304, tied; 1.18e9 f32 parameters from seed 0) through
     ``repro_torch.cluster``: ``Supercomputer(device="cuda")``, an (8, 8, 8)
     slice, ``Slice.train`` on ``ShapeConfig("train_2k", "train", 2048,
     8)`` with ``ParallelConfig(remat="block", xent_chunk=256)`` and
     ``OptimizerConfig(lr=3e-4, warmup_steps=5)`` (2 microbatches of 4 x
     2048 tokens), 3 warm and 10 timed steps (one ``TrainSession.run`` a
     step, synchronised): tokens/s, ms a step (median, spread), finite
     losses that fall from the first, params that move, peak allocated
     memory between the 18.8 GB of f32 params, gradient, m and v and 60 GB,
     the idle share of one profiled step, and the chunked cross-entropy's
     peak with and without its per-chunk recompute (bitwise equal).  Then a
     checkpoint of the trained state (params, m, v: 14.1 GB on disk) saved
     and restored into a fresh ``Trainer``, both timed, every leaf bitwise;
     then ``Slice.serve`` of the trained params cast to bf16 on the serve
     phase's 16 requests, rows 1 and 2 counted (both launched);
 13. fault drill — full width, 2 layers: one step twice on the same state,
     remat on and off, and under ``torch.use_deterministic_algorithms``
     (all three bitwise equal; an op PyTorch flags as nondeterministic
     fails the run); a clean 12-step run on one
     slice beside a run that loses a block at step 7 (checkpoints every 4:
     a ``reconfigure`` event, a spare swapped in, step 4 restored); a run
     preempted at step 5 (``Slice.request_preempt``) and resumed on a (4,
     8, 8) slice.  Both interrupted runs end on the clean run's losses and
     params, bit for bit.
 14. fleet serving — ``examples/serve_fleet.py``'s scenario at full width
     (olmo-1b cut to FLEET_LAYERS = 4 layers since phase 24 joined)
     through ``repro_torch.fleet``: ``Supercomputer(num_blocks=3)``,
     replicas of ``SliceSpec(slots=4, max_len=128, prompt_len=64,
     chunk=8)`` on (4, 4, 4) slices sharing one weight tree of seed 0
     (moved to the card once), ``least_eta`` routing, the example's
     autoscaler, ``timing=0.05``; its bursty trace (seed 2, the model's
     vocabulary, prompts of at most 12 tokens), a spare burnt at 2.15 and
     the busiest replica's block failed at 2.2.  Rows 1 and 2 counted.
     Every request accounted for, at least one scale-up and one drain +
     scale-down, at least one migration and none truncated, every stream
     equal to its prompt served alone by one engine of the same spec (a
     difference only where the solo run's top-2 margin is under the bf16
     tolerance), allocated memory after ``close()`` within 64 MB of
     before.  Then ``uniform_burst(24, new_tokens=16, prompt_len=8)`` on 1
     and 2 replicas with measured timing (reported: one card takes the
     replicas in turns), and 2 pooled replicas (``kv_prefix``'s spec)
     under ``prefix_affinity`` on the first 16 requests of a 2-second
     shared-header trace (seed 0: it holds 10): prefix hits, no KV block
     leaked;
 15. mixed tenancy — ``examples/mixed_cluster.py``'s scenario: the fleet
     of phase 14 at ``timing=0.15``, priority 1, ``preempt_on_allocate``
     on a 4-block machine, its diurnal trace (seed 5), beside an
     ``ElasticTrainJob`` (priority 0, geometries 4x4x12 / 4x4x8 / 4x4x4)
     training the drill's 2-layer cut on train_2k for 16 steps.  The
     burst evicts it (allocated memory falls by its params, m and v
     before the eviction's notification returns), it resumes at the
     trough; its losses and final params equal an uninterrupted
     ``Trainer`` run's, bit for bit; every request accounted for.
 16. MoE (run after phase 3, while the card is empty: < 3 GB allocated,
     checked):
     rows 1 and 2 at qwen3-moe-30b-a3b's attention shapes (32 query heads
     over 4 KV heads, d = 128; decode B = 8, S = 1024, mixed lengths;
     prefill T = S = 128 for a wave of 1 and of 8) against their plain
     versions, timed in turns with SDPA (``enable_gqa``) beside their
     bounds; reduced qwen3-moe and kimi-k2 on the card against the CPU
     with the same weights (prefill logits within the serve bar, 12
     greedy steps equal; every MoE call recorded on both, a token may
     choose other experts only at a near tie of the CPU's router logits,
     and a row is compared up to its first token touched by one); then
     full-width qwen3-moe-30b-a3b (48 layers, 128 experts, top 8; 61.06
     GB of bf16 weights from seed 0) in the serve phase's engine and
     trace shape (16 requests, 128 new tokens, ids below 151936),
     counted: rows 1 and 2 launched, every request its budget, peak
     allocated < 72 GB; 8 requests of 16 tokens at chunk 8 and chunk 1
     bitwise equal, with the dropped fraction of the prefill and decode
     MoE calls; tokens/s, TTFT, ms a decode step, and the card's idle
     share over one profiled chunk.
 17. MoE training (run after phase 16, on an empty card): reduced
     qwen3-moe and kimi-k2 card vs CPU with the same f32 weights and
     batch: one step's gradients with the CPU's routes replayed on the
     card, every leaf within 2^-5 of its largest |g|; without replay, each
     fresh route split a near tie of the CPU's router logits (counted); 2
     steps of sgd and of adafactor, routes replayed: each step's loss and
     gradients within the same bars, and the card's update on the CPU's
     gradients and state within 1e-6 of the CPU's.  Then full-width
     qwen3-moe-30b-a3b cut to 4 layers (3,114,813,440 f32 parameters from
     seed 0): before its optimizer state exists, one microbatch's loss and
     gradients with remat, without, under
     ``torch.use_deterministic_algorithms`` and again, bitwise equal (an op
     PyTorch flags as nondeterministic fails the run); ``Slice.train`` on
     phase 12's cell (train_2k: 8 microbatches of 1 x 2048, remat, xent
     chunks of 256, Adam at lr 3e-4), 3 warm and 10 timed steps:
     tokens/s, ms a step (median, spread), finite losses that fall from
     the first, params that move, peak allocated < 72 GB, the dropped
     fraction of the first and the last step, the idle share of one
     profiled step, one step split into a microbatch's forward + backward
     and Adam (its share of a step); ``Slice.serve`` of the trained params
     cast to bf16 on the serve phase's 16 requests, rows 1 and 2 counted
     (``launches_moe_trained``).  Then reduced qwen3-moe preempted at step
     3 (``Slice.request_preempt``, checkpoints) and resumed on another
     slice shape: losses and params bitwise an uninterrupted run's.
 18. SSM and hybrid (run after phase 17, on an empty card: < 3 GB
     allocated before each model, checked): rows 1 and 2 at hymba-1.5b's
     attention shapes (25 query heads over 5 KV heads, d = 64; decode
     B = 16, S = 1152, lengths 0, 1, 1024, 1025, 1152 among 16, window
     1024 and global; prefill B = 16, T = S = 1088, window 1024) against
     their plain versions, timed in turns with SDPA (``enable_gqa``, the
     window as an explicit mask) beside their bounds; reduced mamba2-130m
     and hymba-1.5b card vs CPU with the same seeded weights (a 24-token
     prefill and 12 teacher-forced decode steps within the serve bar, a
     frozen lane's SSD state bitwise unchanged); then full-width
     mamba2-130m (24 layers, d_model 768, state 128) and hymba-1.5b (32
     layers, d_model 1600, 25 heads over 5, window 1024 with layers 15
     and 31 global), each in ``ServeEngine(SliceSpec(slots=16,
     max_len=1152, prompt_len=1088, chunk=8))`` on 16 prompts of
     1024-1088 tokens, 64 new tokens each, counted: every budget met with
     in-vocabulary ids, hymba's rows 1 and 2 on every layer of every step
     and admission (``launches_hymba``), mamba2 launching neither; the
     same requests at chunk 1 bitwise equal; tokens/s, mean and p95 TTFT,
     ms a decode step, peak memory (< 72 GB, checked) and the card's idle
     share over one profiled chunk.
 19. SSM and hybrid training (run after phase 18, on an empty card):
     reduced mamba2-130m and hymba-1.5b card vs CPU with the same f32
     weights and batch, one step's loss and gradients within the training
     bars (every leaf within 2^-5 of its largest |g|; the hybrid's
     ``ssm.dt_bias`` and ``ssm.A_log`` within 2^-5 of their layer's
     ``ssm`` subtree) and the card's step with remat on and off bitwise
     equal; the SSD block's gradient at full width (mamba2's and hymba's
     SSD widths, one layer, B = 1, T = 512: two chunks of 256, where the
     reference's chunked gradient is NaN) through ``ssd_forward`` against
     the sequential ``ssd_reference``'s, every leaf finite and within
     2^-5; then full-width mamba2-130m and hymba-1.5b (f32 from seed 0) on
     phase 12's cell (train_2k, remat, xent chunks of 256, Adam at lr
     3e-4, warmup 5): one 2048-token row's gradient finite on every leaf,
     ``Slice.train`` for 2 warm and 5 timed steps, then one profiled:
     tokens/s, ms a step (median, spread), finite losses that fall from
     the first, params that move, peak allocated < 72 GB, Adam's time
     and share, the card's idle share; the trained params
     cast to bf16 and served (4 prompts of 64 tokens, 32 new tokens
     each), hymba's rows 1 and 2 counted (``launches_hymba_trained``),
     mamba2 launching neither.
 20. The dense variants (run after phase 19, on an empty card: < 3 GB
     allocated before each model, checked): rows 1, 1q, 3 and 3q at
     gemma2-9b's head_dim of 256 (H = 16 over KH = 8, softcap 50, scale
     256^-0.5; decode B = 8, S = 4608, lengths 0, 1, 4096, 4097 and 4608
     among 8, window 4096 and global; rows 3 and 3q through permuted
     block tables, bitwise rows 1 and 1q on the gathered view; rows 1q, 3
     and 3q once through ``ops``, counted) and row 2 (B = 1 and 8, T = S
     = 4480, window 4096; B = 8, T = S = 512, global), and rows 1 and 2 at
     qwen2-7b's G = 7 (H = 28 over KH = 4), each against its plain
     version, timed beside it, its bound and, in turns, SDPA (without
     the softcap, which SDPA lacks: a yardstick only); reduced qwen2-7b,
     mistral-nemo-12b and gemma2-9b card vs CPU (a 24-token prefill and
     12 greedy steps, the card fed the CPU's picks: logits within the
     serve bar, picks equal but at near ties); then qwen2-7b and
     mistral-nemo-12b at full width (cut to 8 layers since phase 24
     joined, as gemma2-9b) on the serve phase's engine and trace, and
     gemma2-9b in ``ServeEngine(SliceSpec(slots=8, max_len=4608,
     prompt_len=4480, chunk=8))`` on 8 prompts of 4000-4480 tokens, 64
     new tokens each, counted: every budget met with in-vocabulary ids,
     rows 1 and 2 on every layer of every step and admission
     (``launches_qwen2``, ``launches_nemo``, ``launches_gemma2``), the
     same requests at chunk 1 bitwise equal, peak allocated < 72 GB;
     tokens/s, mean and p95 TTFT, ms a decode step and the card's idle
     share over one profiled chunk.  The kernels line lists the d = 256
     instantiations (``*_d256``).
 21. The last two families (run after phase 20, on an empty card: < 3 GB
     allocated before each model, checked): row 2 at whisper-small's
     admission shapes (B = 8, H = KH = 12, d = 64: the encoder's
     non-causal T = S = 192, the cross-attention's T = 192 over the
     published 30-second encoder length S = 1500), row 1 over cross
     caches of 1500 and of the served 192 rows and at the decoder's
     self-attention (S = 448, lengths 193-448, the clamp's 448 among
     them), row 2 at internvl2-2b's wave (B = 8, H = 16 over KH = 8, d =
     128, T = S = 1152: 1024 patches + 128 tokens) and row 1 at its decode
     (S = 1280, lengths 1152-1280), each against its plain version (over
     1500 keys within 2e-3 + 1e-2 relative, a bar checked to refuse the
     plain version with the last 28-key tile dropped), timed beside it,
     its bound and, in turns, SDPA (the same function here: no softcap, no
     window); reduced
     whisper-small and internvl2-2b card vs CPU (a 16-token prefill over
     16 random frames or 8 random patches, then 12 greedy steps through
     ``api.decode_step`` / ``decode_step_paged``, the card fed the CPU's
     picks: logits within the serve bar, picks equal but at near ties);
     then full-width whisper-small on the legacy full-batch path
     (``SliceSpec(slots=8, max_len=448, prompt_len=192)``, zero frames:
     S_enc = 192) and internvl2-2b on the fast path (``SliceSpec(slots=8,
     max_len=1280, prompt_len=128, chunk=8)``, 1024 zero patches before
     every prompt), each on 16 requests of 32-192 (32-128) tokens, 128 new
     tokens each, counted: every budget met with in-vocabulary ids,
     whisper's row 2 exactly 36 launches an admission (12 encoder, 12
     decoder, 12 cross layers) and row 1 exactly 24 a decode step (self
     and cross on 12 layers), internvl's rows 1 and 2 exactly once a
     layer a step and a wave, its requests at chunk 1 bitwise equal;
     peak allocated < 72 GB; tokens/s, mean and p95 TTFT, ms a decode
     step and the card's idle share over one profiled chunk
     (``launches_whisper``, ``launches_internvl``).
 22. The last four examples' twins, as their users run them (run after
     phase 21), each through its plain function with its stdout kept:
     ``launch.topology_explorer`` at ``--chips 512`` and ``--chips 128
     --search`` (its text the example's, by sha256 of the example's output
     on the CPU; no tensor made on the card); ``fault_tolerant_training``
     as the example runs it (``matches clean run: True``, one restart at
     step 4, losses and final params bitwise the clean run's, the
     machine's events the reference's kinds); ``serve_lm`` on full-width
     olmo-1b (seed-0 weights) and on reduced whisper-small (the legacy
     path, chunk 1) at the example's ``SliceSpec(slots=4, max_len=128,
     prompt_len=16, chunk=8)`` and 8 requests of 4-11 tokens, counted
     from just before ``run()``: rows 1 and 2 exactly once a layer a
     decode step and an admission (whisper: 2 x 2 layers a step, 2 + 2 x 2
     an admission), every budget met with in-vocabulary ids, olmo's
     prefill logits finite; ``train_dlrm``'s demo (12 tables over widths
     16, 8 and 32, B = 256) card vs CPU: one step's gradients on both
     routes within 2^-5 of each leaf's largest |g|, 5 twin steps from one
     initial state within 1e-3 + 2^-7 |loss|; then 150 twin steps fused
     and 150 ``--pergroup`` (checkpoints every 50, inside the loop, as the
     example), counted: rows 4 and 5 once a step fused, row 6 once a table
     and row 5 once a row space a step per-table, the loss improved;
     ``--scale full`` raises naming item 12 with nothing allocated.  Each
     kernel the twins launched is then held against its plain version on
     the inputs of its first call at each shape the twins gave it (rows 1,
     2, 4 and 6 within their bars, row 5 bitwise under deterministic
     algorithms) (``launches_serve_lm``, ``launches_serve_lm_whisper``,
     ``launches_train_dlrm``, ``launches_train_dlrm_pergroup``).
 23. dlrm0's tables sharded over ranks (run after phase 22): 4 ranks on a
     (2, 2) (data, model) grid, each a process of its own (this script
     with ``--sharded-rank``; the kernel library built before they
     start), NCCL with one rank a card where 4 cards exist, else gloo
     with every tensor on the one card, staged through pinned host
     buffers (the backend is printed); process groups with a timeout, so
     a hung collective fails its rank, and a failed or late rank fails
     the phase.  dlrm0 with its 150 tables at their published dims,
     valencies and combiners, vocabularies cut to 1e9 table parameters
     (4.0 GB of f32; a rank holds half of every row space), global batch
     256 (64 a rank), a2a capacity factor 0.75 (no id dropped, checked).
     Each rank: its shards drawn as the one-device init draws the whole;
     the pipelined a2a lookup bitwise the per-group one, psum within
     EMB_ATOL of it; the hot-id cache through the executor (a step, then
     the next batch observed: hit rate), the cached lookup bitwise the
     uncached one, gradients too; then the main path, counted: 3 steps
     of a ``Trainer`` over the grid from those shards, each rank putting
     its rows of each batch (ms a step, bytes sent a step, peak memory);
     rows 6, 4 and 5 exactly once, once and twice a width-group a step,
     and rank 0 holds each against its plain version on its first inputs
     at each shape.  Then against one device from the
     same state, accumulating over the same four pieces of the batch in
     rank order: the a2a outputs of the global batch within EMB_ATOL of
     the one-device lookup (``method="local"``) of the whole tables, each
     shard's first gradient within 2^-5 of its leaf's largest |g|, the 3
     losses within 1e-3 + 2^-7 |loss| (``launches_sharded_dlrm``).
 24. data-parallel olmo-1b (run after phase 23): 4 ranks on a (4, 1)
     (data, model) mesh, each a process of its own (this script with
     ``--dp-rank``), NCCL on 4 cards, else gloo on the one card.
     olmo-1b at its published width cut to 2 layers (16 with
     ``--dp-layers`` on 4 cards), one 2048-token sequence a rank, phase
     12's remat, xent chunks and Adam.  For ``grad_compression`` none,
     int8 and topk, a ``Trainer`` over the ranks takes 1 warm and 2
     timed steps (ms a step, bytes sent a rank, peak a rank): the ranks'
     params bitwise equal after them; none's first loss and exchanged
     gradient within the training bars of one device accumulating the
     same four sequences; int8's within 0.51 x each leaf's shared scale
     of none's (the uncompressed mean) and its payload cut >= 3.9x; topk
     keeping exactly k a wired leaf a rank.  Then reduced olmo-1b with
     int8 over the ranks: rank 1 alone asks for a preemption at step 2,
     every rank stops there, and the resume ends bitwise an
     uninterrupted run.  No kernel runs on this path (the reference's
     flash attention has no backward).

Prints, last: a ``{"kernels": [...]}`` line, the card's name and power
limit as ``nvidia-smi`` gives them, and
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero without a CUDA device or without the repository's ``src``.
"""
import argparse
import contextlib
import dataclasses
import gc
import hashlib
import io
import json
import math
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor cores
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
# bf16 in and out, f32 inside both the kernel and its plain version: they
# differ by the last bf16 rounding (2^-8 relative) and f32 reordering.
KERNEL_ATOL = KERNEL_RTOL = 1e-2
# over 1500 N(0, 1) keys an output is ~0.03 across: a bar of 1e-2 could
# pass a kernel that skipped the last keys' tile (phase 21)
LONG_KEYS_ATOL = 2e-3
# `cuda_ms` holds the card for at least this many clock cycles before the
# timed calls: ~20 ms at the H100's ~1.98 GHz; longer where the host
# takes longer to queue them, up to QUEUE_AHEAD_MAX_S
CARD_HZ = 1.98e9
QUEUE_AHEAD_CYCLES = 40_000_000
QUEUE_AHEAD_MAX_S = 0.5
# f32 in and out (embedding lookups): the kernel adds a slot's rows in
# column order, the plain version with torch.sum's tree; at most 128 rows
# of |x| <= ~5 differ by a few f32 ulps of the sum.  The gather is a copy.
EMB_ATOL = EMB_RTOL = 1e-5
DLRM_BATCH = 4096              # scoring batch on one card
DLRM_CHIP_BATCH = 65536 // 256   # the repo's per-chip dlrm0 batch
DLRM_TABLE_PARAMS = 12_000_000_000   # one-card cut: vocabularies only
# logits of the card (kernels, cuBLAS bf16) against the CPU (plain, CPU
# bf16 matmuls): 8 bf16 ulps at the largest logit, as the CPU tests use;
# the same bar holds each gradient leaf against its largest |g|
LOGIT_REL_TOL = 2.0 ** -5
TRAIN_TABLE_PARAMS = 4_000_000_000   # one-card training cut: 4 x 16.0 GB
TRAIN_BATCH = 4096
TRAIN_WARM, TRAIN_TIMED = 3, 10
TRAIN_PEAK_LIMIT = 72e9
# int8 copy of the 48 GB scoring tables (12.0 GB + 0.76 GB of scales)
# beside them, quantised 2^20 rows at a time
INT8_PEAK_LIMIT = 66e9
PER_TABLE_TRAIN_BATCH = DLRM_CHIP_BATCH
# Adam, card vs CPU on the same gradients: the same f32 operations, norms
# summed in other orders: 1e-6 of each element and of the leaf's largest
ADAM_RTOL = 1e-6


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


_T0 = time.perf_counter()


def log(*a):
    """Print, stamped with the seconds since the script started."""
    print(f"[{time.perf_counter() - _T0:7.1f} s]", *a, flush=True)


def cuda_ms(torch, fn, n_inputs, iters=30, warmup=3, host=None):
    """Mean ms per call of ``fn(i)`` on the card by CUDA events; ``i``
    rotates over ``n_inputs`` input sets so repeated calls do not run out
    of L2.  The card first spins while the host queues the timed calls:
    QUEUE_AHEAD_CYCLES, or twice the host's time to queue them (from the
    fastest warm-up call) where that is longer, up to QUEUE_AHEAD_MAX_S;
    so a call shorter than its host-side launch cost is timed by the
    card's work, not by the host's pace.  ``host``, a dict, gets the
    host's ms to queue one timed call (``host_ms``), the spin's ms at
    CARD_HZ (``queue_ahead_ms``) and whether the host took longer to
    queue the calls than the card spun (``host_bound``: then the card may
    have waited for the host)."""
    queue_s = []
    for i in range(warmup):
        t0 = time.perf_counter()
        fn(i % n_inputs)
        queue_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    cycles = max(QUEUE_AHEAD_CYCLES,
                 int(min(2 * min(queue_s) * iters, QUEUE_AHEAD_MAX_S)
                     * CARD_HZ))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cycles)
    start.record()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i % n_inputs)
    end.record()
    queued_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    if host is not None:
        host.update(host_ms=queued_s * 1e3 / iters,
                    queue_ahead_ms=cycles / CARD_HZ * 1e3,
                    host_bound=queued_s > cycles / CARD_HZ)
    return start.elapsed_time(end) / iters


# a kernel and its library yardstick, timed in alternating turns: a card
# that drifts (clocks, power) moves both means alike
TURNS = ("kernel", "library", "library", "kernel")


def in_turns(torch, fns, n_inputs, order=TURNS):
    """`cuda_ms` of ``fns[name]`` once for each appearance of name in
    ``order``; returns ({name: mean ms}, {name: [ms of each turn]})."""
    got = {n: [] for n in fns}
    for n in order:
        got[n].append(cuda_ms(torch, fns[n], n_inputs))
    return {n: sum(v) / len(v) for n, v in got.items()}, got


def max_err(torch, got, want, what, atol=KERNEL_ATOL, rtol=KERNEL_RTOL):
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != "
                                   f"{tuple(want.shape)}")
    if not got.numel():
        return 0.0
    err = (got.float() - want.float()).abs()
    lim = atol + rtol * want.float().abs()
    check(bool((err <= lim).all()),
          f"{what}: max |kernel - plain| {err.max().item():.3e} over "
          f"atol {atol} + rtol {rtol}")
    return err.max().item()


def int8_half_sums(torch, scales, rows, slots, dmax):
    """(B, K, dmax): per slot, half the sum of the tile scales of its valid
    rows (divided by their count in a mean slot), lane by lane; what
    round-to-nearest int8 can move a slot's value.  Gathers scales only."""
    B = rows.shape[0]
    out = torch.zeros((B, slots.shape[0], dmax), device=rows.device)
    for k, (g, a, b, mean) in enumerate(slots.tolist()):
        sc = scales[g]
        ids = rows[:, a:b]
        valid = ids >= 0
        s = torch.where(valid[..., None], sc[ids.long().clamp_min(0)], 0.0)
        s = s.sum(dim=1) / 2                                    # (B, nt)
        if mean:
            s = s / valid.sum(dim=1, keepdim=True).clamp_min(1)
        lanes = s.repeat_interleave(128, dim=1)[:, :dmax]
        out[:, k, :lanes.shape[1]] = lanes
    return out


def check_int8_bound(torch, REF, got, f32, scales, rows, slots, what):
    """Fails unless the int8 lookup ``got`` is within the int8 rounding
    bound of the f32 lookup ``f32`` (lanes past a group's dim are zero in
    both), plus EMB_ATOL + EMB_RTOL |f32|; returns the largest share of
    the bound used."""
    torch.cuda.synchronize()
    # in place: at full width each (B, K, dmax) temporary is 0.63 GB
    lim = int8_half_sums(torch, scales, rows, slots, got.shape[2])
    lim.add_(f32.abs().mul_(EMB_RTOL)).add_(EMB_ATOL)
    err = got.sub(f32).abs_()
    check(bool((err <= lim).all()),
          f"{what}: int8 vs f32 lookup differ by {err.max().item():.3e}, "
          f"past half a scale a row")
    return err.div_(lim).max().item()


def bound(nbytes, flops, flops_per_s=BF16_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "operations")


def decode_phase(torch, F, DA, REF):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def inputs(B, H, KH, S, d, lens):
        q = torch.randn((B, H, d), generator=gen, device=dev).to(bf)
        k = torch.randn((B, S, KH, d), generator=gen, device=dev).to(bf)
        v = torch.randn((B, S, KH, d), generator=gen, device=dev).to(bf)
        return q, k, v, torch.tensor(lens, dtype=torch.int32, device=dev)

    # small cases: GQA, MQA, window, softcap, lengths 0, 1 and S
    small = [((2, 8, 2, 300, 128, [0, 300]), dict(window=64, softcap=20.0)),
             ((3, 8, 1, 77, 64, [1, 77, 40]), dict(softcap=5.0)),
             ((3, 4, 4, 40, 16, [40, 0, 17]), dict(window=8, scale=0.3))]
    for (B, H, KH, S, d, lens), kw in small:
        a = inputs(B, H, KH, S, d, lens)
        max_err(torch, DA.paged_decode_attention(*a, **kw),
                REF.paged_decode_attention_ref(*a, **kw),
                f"decode B{B} H{H} KH{KH} S{S} d{d} {kw}")

    B, H, KH, S, d = 8, 16, 16, 1024, 128
    lens = [0, 1, 100, 257, 512, 700, 1000, 1024]
    sets = [inputs(B, H, KH, S, d, lens) for _ in range(3)]   # 3 x 67 MB
    err = max_err(torch, DA.paged_decode_attention(*sets[0]),
                  REF.paged_decode_attention_ref(*sets[0]),
                  "decode at serving shapes")
    plain_ms = cuda_ms(torch,
                       lambda i: REF.paged_decode_attention_ref(*sets[i]), 3)
    kpos = torch.arange(S, device=dev)
    masks = [(kpos[None, :] < s[3][:, None].long())[:, None, None, :]
             for s in sets]

    def library(i):
        q, k, v, _ = sets[i]
        return F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=masks[i])

    mean, turns = in_turns(torch, {
        "kernel": lambda i: DA.paged_decode_attention(*sets[i]),
        "library": library}, 3)
    ms, library_ms = mean["kernel"], mean["library"]
    rows = sum(lens)
    nbytes = (2 * B * H * d * 2            # q in, out
              + 2 * rows * KH * d * 2      # the valid K and V rows
              + B * 4)                     # seq_lens
    flops = 4 * rows * H * d               # q.k and p.v
    bound_ms, bound_by = bound(nbytes, flops)
    return dict(name="paged_decode_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:112",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, ms_turns=turns)


def prefill_phase(torch, F, FA, REF):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16

    def inputs(B, H, KH, T, S, d):
        return (torch.randn((B, H, T, d), generator=gen, device=dev).to(bf),
                torch.randn((B, KH, S, d), generator=gen, device=dev).to(bf),
                torch.randn((B, KH, S, d), generator=gen, device=dev).to(bf))

    small = [((2, 8, 2, 77, 77, 128), dict(window=20, softcap=30.0)),
             ((1, 4, 1, 33, 33, 64), dict(causal=False)),
             ((2, 4, 2, 37, 37, 16), dict(window=5, softcap=4.0, scale=0.3))]
    for shape, kw in small:
        a = inputs(*shape)
        max_err(torch, FA.flash_attention(*a, **kw),
                REF.flash_attention_ref(*a, **kw), f"prefill {shape} {kw}")

    B, H, KH, T, d = 8, 16, 16, 128, 128
    sets = [inputs(B, H, KH, T, T, d) for _ in range(8)]      # 8 x 17 MB
    err = max_err(torch, FA.flash_attention(*sets[0]),
                  REF.flash_attention_ref(*sets[0]),
                  "prefill at serving shapes")
    plain_ms = cuda_ms(torch, lambda i: REF.flash_attention_ref(*sets[i]), 8)
    mean, turns = in_turns(torch, {
        "kernel": lambda i: FA.flash_attention(*sets[i]),
        "library": lambda i: F.scaled_dot_product_attention(*sets[i],
                                                            is_causal=True)},
        8)
    ms, library_ms = mean["kernel"], mean["library"]
    nbytes = 4 * B * H * T * d * 2                # q, k, v in; out
    flops = 4 * B * H * d * (T * (T + 1) // 2)    # causal q.k and p.v
    bound_ms, bound_by = bound(nbytes, flops)
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:86",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, ms_turns=turns)



# pooled block-table decode: the serving decode shape over a pool of
# POOL_BLOCKS blocks of POOL_BS rows, POOL_NB blocks a slot (1024 rows)
POOL_BS, POOL_NB, POOL_BLOCKS = 16, 64, 1024
POOL_STEPS = 16


def pooled_kernel_phase(torch, np, F, DA, REF, QU, ops, dev="cuda"):
    """Rows 3, 1q and 3q at the serving decode shape (B=8, H=KH=16, d=128,
    the decode phase's lengths): row 3 on a bf16 pool of 1024 blocks of 16
    rows with permuted tables (two slots share 4 blocks), rows 1q and 3q on
    ``quantize_kv`` of the same K/V (1q on the gathered int8 view).  Rows
    1q and 3q go once through ``ops`` (counted); each is held against its
    plain version, rows 3 and 3q bitwise against rows 1 and 1q on the
    gathered view, and timed beside its plain version and its byte bound.
    SDPA on the bf16 gathered view, with the gather timed apart, is logged
    as a yardstick: no single PyTorch call reads a block table or
    dequantises int8 KV (library_ms null)."""
    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    bf = torch.bfloat16
    B, H, KH, d = 8, 16, 16, 128
    lens_l = [0, 1, 100, 257, 512, 700, 1000, 1024]
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)

    def inputs(i):
        q = torch.randn((B, H, d), generator=gen, device=dev).to(bf)
        kv = [torch.randn((POOL_BLOCKS, POOL_BS, KH, d), generator=gen,
                          device=dev).to(bf) for _ in range(2)]
        # a permutation of the pool; slots 4 and 5 (512 and 700 rows)
        # share their first 4 blocks
        t = np.random.default_rng(i).permutation(POOL_BLOCKS)[:B * POOL_NB]
        t = t.reshape(B, POOL_NB).astype(np.int32)
        t[5, :4] = t[4, :4]
        t = torch.from_numpy(t).to(dev)
        (kq, ks), (vq, vs) = (QU.quantize_kv(x) for x in kv)
        view_q = [REF.pool_rows(x, t) for x in (kq, ks, vq, vs)]
        return dict(q=q, k=kv[0], v=kv[1], t=t, kq=kq, ks=ks, vq=vq, vs=vs,
                    view_q=view_q)

    # 6 sets (~0.35 GB each): their valid int8 rows alone are 6 x 15 MB,
    # past the 50 MB L2
    sets = [inputs(i) for i in range(6)]
    a = sets[0]
    # the counted run of rows 1q and 3q: through ops, as a caller
    DA.launches_q = DA.launches_bt_q = 0
    got_1q = ops.paged_decode_attention(
        a["q"], a["view_q"][0], a["view_q"][2], lens,
        k_scale=a["view_q"][1], v_scale=a["view_q"][3])
    got_3q = ops.paged_decode_attention_bt(
        a["q"], a["kq"], a["vq"], lens, a["t"], k_scale=a["ks"],
        v_scale=a["vs"])
    torch.cuda.synchronize()
    launches = {"paged_decode_attention_q8": DA.launches_q,
                "paged_decode_attention_bt_q8": DA.launches_bt_q}
    check(launches == {"paged_decode_attention_q8": 1,
                       "paged_decode_attention_bt_q8": 1},
          f"int8 decode through ops: launches {launches}")

    got_3 = DA.paged_decode_attention_bt(a["q"], a["k"], a["v"], lens,
                                         a["t"])
    err = {
        "bt": max_err(torch, got_3, REF.paged_decode_attention_bt_ref(
            a["q"], a["k"], a["v"], lens, a["t"]), "pooled decode"),
        "q8": max_err(torch, got_1q, REF.paged_decode_attention_ref(
            a["q"], a["view_q"][0], a["view_q"][2], lens,
            k_scale=a["view_q"][1], v_scale=a["view_q"][3]),
            "int8 decode"),
        "bt_q8": max_err(torch, got_3q, REF.paged_decode_attention_bt_ref(
            a["q"], a["kq"], a["vq"], lens, a["t"], k_scale=a["ks"],
            v_scale=a["vs"]), "pooled int8 decode")}
    check(torch.equal(got_3, DA.paged_decode_attention(
        a["q"], REF.pool_rows(a["k"], a["t"]), REF.pool_rows(a["v"], a["t"]),
        lens)),
        "pooled decode is not bitwise the per-slot kernel on the view")
    check(torch.equal(got_3q, DA.paged_decode_attention_q8(
        a["q"], *a["view_q"][:2], *a["view_q"][2:], lens)),
        "pooled int8 decode is not bitwise the per-slot int8 kernel on the "
        "view")

    def bt(i):
        x = sets[i]
        return DA.paged_decode_attention_bt(x["q"], x["k"], x["v"], lens,
                                            x["t"])

    def bt_plain(i):
        x = sets[i]
        return REF.paged_decode_attention_bt_ref(x["q"], x["k"], x["v"],
                                                 lens, x["t"])

    def q8(i):
        x = sets[i]
        return DA.paged_decode_attention_q8(x["q"], *x["view_q"], lens)

    def q8_plain(i):
        x = sets[i]
        kq, ks, vq, vs = x["view_q"]
        return REF.paged_decode_attention_ref(x["q"], kq, vq, lens,
                                              k_scale=ks, v_scale=vs)

    def bt_q8(i):
        x = sets[i]
        return DA.paged_decode_attention_bt_q8(
            x["q"], x["kq"], x["ks"], x["vq"], x["vs"], lens, x["t"])

    def bt_q8_plain(i):
        x = sets[i]
        return REF.paged_decode_attention_bt_ref(
            x["q"], x["kq"], x["vq"], lens, x["t"], k_scale=x["ks"],
            v_scale=x["vs"])

    # yardstick: SDPA on the bf16 view gathered beforehand (the gather
    # timed apart); in turns with the three kernels (3, 1q, 3q, SDPA, SDPA,
    # 3q, 1q, 3): ms is the mean of the two
    views = [(REF.pool_rows(x["k"], x["t"]), REF.pool_rows(x["v"], x["t"]))
             for x in sets]
    kpos = torch.arange(POOL_NB * POOL_BS, device=dev)
    mask = (kpos[None, :] < lens[:, None].long())[:, None, None, :]
    fns = {"bt": bt, "q8": q8, "bt_q8": bt_q8,
           "sdpa": lambda i: F.scaled_dot_product_attention(
               sets[i]["q"][:, :, None], views[i][0].transpose(1, 2),
               views[i][1].transpose(1, 2), attn_mask=mask)}
    ms, turns = in_turns(torch, fns, 6, ("bt", "q8", "bt_q8", "sdpa", "sdpa",
                                         "bt_q8", "q8", "bt"))
    plain_ms = {n: cuda_ms(torch, f, 6) for n, f in
                (("bt", bt_plain), ("q8", q8_plain), ("bt_q8", bt_q8_plain))}
    gather_ms = cuda_ms(torch, lambda i: (
        REF.pool_rows(sets[i]["k"], sets[i]["t"]),
        REF.pool_rows(sets[i]["v"], sets[i]["t"])), 6)
    sdpa_ms = ms["sdpa"]
    del views, fns

    rows = sum(lens_l)
    io = 2 * B * H * d * 2 + B * 4          # q in, out, seq_lens
    tables = B * POOL_NB * 4
    flops = 4 * rows * H * d                # q.k and p.v
    deq = 2 * rows * KH * d                 # int8: one multiply an element
    nbytes = {"bt": io + 2 * rows * KH * d * 2 + tables,
              "q8": io + 2 * rows * KH * (d + 4),
              "bt_q8": io + 2 * rows * KH * (d + 4) + tables}
    meta = {
        "bt": ("paged_decode_attention_bt",
               "src/repro/kernels/decode_attention.py:217", flops),
        "q8": ("paged_decode_attention_q8",
               "src/repro/kernels/decode_attention.py:100", flops + deq),
        "bt_q8": ("paged_decode_attention_bt_q8",
                  "src/repro/kernels/decode_attention.py:210", flops + deq)}
    out = {}
    for n, (name, replaces, ops_n) in meta.items():
        bound_ms, bound_by = bound(nbytes[n], ops_n)
        out[n] = dict(name=name, route="cuda",
                      source="src/repro_torch/kernels/csrc/decode_attention.cu",
                      replaces=replaces, max_abs_err=err[n], ms=ms[n],
                      plain_ms=plain_ms[n], bound_ms=bound_ms,
                      bound_by=bound_by, library_ms=None, bytes=nbytes[n],
                      ms_turns=turns[n], launches=launches.get(name))
    out["yardstick"] = {"gather_bf16_view_ms": gather_ms,
                        "sdpa_on_gathered_view_ms": sdpa_ms,
                        "sdpa_ms_turns": turns["sdpa"]}
    return out


def fill_pool(pool, dense, lens, tables):
    """Copy rows [0, lens[b]) of slot b of the per-slot cache ``dense``
    into the pool blocks ``tables[b]`` names, in place; a block an earlier
    slot filled (a shared prefix block) keeps that slot's rows."""
    filled = set()
    bs = pool.k.shape[2]
    for b, n in enumerate(lens):
        for j in range(-(-int(n) // bs)):
            blk = int(tables[b][j])
            if blk in filled:
                continue
            rows = min(bs, int(n) - j * bs)
            for dst, src in ((pool.k, dense.k), (pool.v, dense.v)):
                dst[:, blk, :rows] = src[:, b, j * bs:j * bs + rows]
            filled.add(blk)
    return filled


def pooled_decode_phase(torch, np, cfg, api, TF, DA, dev="cuda"):
    """Full-width olmo-1b over a pooled cache of 1024 blocks of 16 rows, 8
    slots of 64 blocks: prompts of 64-128 tokens prefilled by
    ``api.prefill_slot`` and copied into the pool (`fill_pool`), slots 0
    and 1 sharing their first 4 blocks, slot 7 unadmitted (table row the
    sentinel 1024, seq_len 0, budget 0).  16 greedy steps three ways:
    (A) ``decode_step_paged(tables=)`` (row 3, counted), (B) the same loop
    on the view gathered once (row 1), (C) ``api.decode_n(tables=)``.
    A's and B's logits are bitwise equal on the admitted slots, the tokens
    of all three are equal, A's pool is bitwise C's, and every pool row
    but the decoded ones is unchanged."""
    params = api.init_params(cfg, seed=0, device=dev)
    B, V = 8, cfg.vocab_size
    rng = np.random.default_rng(3)
    plens = [int(n) for n in rng.integers(64, 129, size=B - 1)] + [0]
    prompts = [rng.integers(0, V, size=n) for n in plens[:-1]]
    prompts[1][:4 * POOL_BS] = prompts[0][:4 * POOL_BS]
    dense = api.init_cache(cfg, B, 128, device=dev)
    feed = torch.zeros(B, dtype=torch.int32, device=dev)
    for b, p in enumerate(prompts):
        logits, dense = api.prefill_slot(
            cfg, params, {"tokens": torch.as_tensor(p, device=dev)[None]},
            dense, b, max_len=128)
        feed[b] = torch.argmax(logits[0])
    t = np.random.default_rng(4).permutation(POOL_BLOCKS)[:B * POOL_NB]
    t = t.reshape(B, POOL_NB).astype(np.int32)
    t[1, :4] = t[0, :4]
    t[7] = POOL_BLOCKS
    tables = torch.from_numpy(t).to(dev)
    start = api.init_kv_pool(cfg, POOL_BLOCKS, POOL_BS, device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    for x in (start.k, start.v):            # unused rows hold garbage
        x.normal_(generator=g)
    fill_pool(start, dense, plens, t)
    del dense
    lens0 = torch.tensor(plens, dtype=torch.int32, device=dev)
    budget = torch.tensor([POOL_STEPS] * (B - 1) + [0], dtype=torch.int32,
                          device=dev)

    def copy(c):
        return TF.Cache(k=c.k.clone(), v=c.v.clone(), pos=c.pos.clone())

    def loop(cache, tables_):
        """16 greedy steps of decode_step_paged; (tokens, logits, cache,
        ms a step by the host clock between two synchronisations)."""
        tk, ln = feed, lens0
        produced = torch.zeros_like(budget)
        toks, logits = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(POOL_STEPS):
            active = produced < budget
            lg, cache, ln = TF.decode_step_paged(cfg, params, cache, tk, ln,
                                                 active, tables=tables_)
            tk = torch.where(active, torch.argmax(lg, -1).to(torch.int32),
                             tk)
            produced += active.to(torch.int32)
            toks.append(tk)
            logits.append(lg)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / POOL_STEPS
        return torch.stack(toks), torch.stack(logits), cache, step_ms

    def chunk(cache):
        """api.decode_n(tables=) over the 16 steps; (tokens, pool, ms a
        step of the chunk, its gather and write-back included)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, cache, _, _ = api.decode_n(cfg, params, cache, feed, lens0,
                                         budget, num_steps=POOL_STEPS,
                                         tables=tables)
        torch.cuda.synchronize()
        return toks, cache, (time.perf_counter() - t0) * 1e3 / POOL_STEPS

    torch.cuda.reset_peak_memory_stats()
    pool_a = copy(start)
    DA.launches = DA.launches_bt = 0
    a_toks, a_logits, pool_a, a_ms = loop(pool_a, tables)
    launches = {"paged_decode_attention_bt": DA.launches_bt,
                "paged_decode_attention": DA.launches}
    check(launches["paged_decode_attention_bt"]
          >= cfg.num_layers * POOL_STEPS and not launches[
              "paged_decode_attention"],
          f"pooled decode launches {launches} for {POOL_STEPS} steps x "
          f"{cfg.num_layers} layers")
    check(tuple(a_logits.shape) == (POOL_STEPS, B, V)
          and bool(torch.isfinite(a_logits[:, :7]).all()),
          f"pooled logits {tuple(a_logits.shape)} not finite")
    b_toks, b_logits, _, b_ms = loop(TF.pool_view(copy(start), tables), None)
    check(torch.equal(a_logits[:, :7], b_logits[:, :7]),
          "pooled (row 3) and gathered-view (row 1) logits differ on the "
          "admitted slots")
    del b_logits
    c_toks, pool_c, c_ms = chunk(copy(start))
    check(torch.equal(a_toks, b_toks) and torch.equal(a_toks, c_toks),
          "pooled step loop, gathered-view loop and decode_n(tables=) "
          "tokens differ")
    check(torch.equal(pool_a.k, pool_c.k) and torch.equal(pool_a.v, pool_c.v),
          "the pooled step loop and decode_n(tables=) wrote other pools")
    written = torch.zeros((POOL_BLOCKS, POOL_BS), dtype=torch.bool,
                          device=dev)
    for b in range(B - 1):
        for r in range(plens[b], plens[b] + POOL_STEPS):
            written[int(t[b, r // POOL_BS]), r % POOL_BS] = True
    check(not bool(written[int(t[0, 0])].any()), "a decode row in the "
                                                 "shared block")
    for x, y in ((pool_a.k, start.k), (pool_a.v, start.v)):
        check(torch.equal(x[:, ~written], y[:, ~written]),
              "pooled decode changed a pool row it did not decode")
    peak = torch.cuda.max_memory_allocated() / 1e9
    del pool_a, pool_c, a_logits
    # the host sets a step's pace and varies: time the three again in
    # turns (A, B, C, C, B, A), each on a fresh copy of the pool
    turns = {"A": [a_ms], "B": [b_ms], "C": [c_ms]}
    for w in "ABCCBA":
        if w == "A":
            turns[w].append(loop(copy(start), tables)[3])
        elif w == "B":
            turns[w].append(loop(TF.pool_view(copy(start), tables), None)[3])
        else:
            turns[w].append(chunk(copy(start))[2])
    stats = {"step_ms_pooled": turns["A"], "step_ms_gathered_view": turns["B"],
             "step_ms_decode_n_chunk": turns["C"], "steps": POOL_STEPS,
             "prompt_lens": plens, "peak_mem_gb": peak,
             "rows_written": int(written.sum()), "launches": launches}
    return stats, launches


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device)


def reference_phase(torch, registry, api, TF, dev="cuda"):
    """Reduced olmo-1b, same weights: CPU (plain attention) vs card."""
    cfg = registry.get_reduced("olmo-1b")
    p_cpu = api.init_params(cfg, seed=0, device="cpu")
    p_gpu = _to(p_cpu, dev)
    toks = torch.randint(0, cfg.vocab_size, (3, 24),
                         generator=torch.Generator().manual_seed(0))
    worst = (0.0, 0.0, 0.0)                 # (err / tol, err, tol)
    outs = {}
    for name, p, d in (("cpu", p_cpu, "cpu"), ("gpu", p_gpu, dev)):
        logits, cache = api.prefill(cfg, p, {"tokens": toks.to(d)},
                                    max_len=40)
        lens = torch.tensor([24, 24, 24], dtype=torch.int32, device=d)
        active = torch.tensor([True, True, False], device=d)
        steps = [logits]
        for t in range(6):
            tk = toks[:, t].to(d)
            lg, cache, lens = TF.decode_step_paged(cfg, p, cache, tk, lens,
                                                   active)
            steps.append(lg[:2])
        outs[name] = [s.float().cpu() for s in steps]
    for i, (c, g) in enumerate(zip(outs["cpu"], outs["gpu"])):
        check(bool(torch.isfinite(g).all()), f"reference step {i}: not finite")
        tol = LOGIT_REL_TOL * c.abs().max().item()
        err = (c - g).abs().max().item()
        check(err <= tol, f"reference step {i}: card vs CPU logits differ by "
                          f"{err:.4f} > {tol:.4f}")
        worst = max(worst, (err / tol, err, tol))
    return worst


SERVE_SPEC = dict(slots=8, max_len=1024, prompt_len=128, chunk=8)
SERVE_NEW_TOKENS = 128


def serve_trace(np, vocab):
    """The serve phase's warm-up prompt (40 tokens) and its 16 requests'
    prompts of 32-128 tokens, from seed 0."""
    rng = np.random.default_rng(0)
    warm = rng.integers(0, vocab, size=40)
    return warm, [rng.integers(0, vocab, size=int(rng.integers(32, 129)))
                  for _ in range(16)]


def serve_phase(torch, np, cfg, api, engine_mod, DA, FA, dev="cuda"):
    t0 = time.perf_counter()
    params = api.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    spec = engine_mod.SliceSpec(**SERVE_SPEC)
    warm_prompt, prompts = serve_trace(np, cfg.vocab_size)
    # warm-up (cuBLAS handles, allocator), outside the counted run
    warm = engine_mod.ServeEngine(cfg, params, spec, device=dev)
    warm.submit(warm_prompt, max_new_tokens=9)
    warm.run()
    del warm

    eng = engine_mod.ServeEngine(cfg, params, spec, device=dev)
    n_req, new_tokens = len(prompts), SERVE_NEW_TOKENS
    reqs = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    torch.cuda.reset_peak_memory_stats()
    DA.launches = FA.launches = 0
    stats = eng.run()
    launches = {"paged_decode_attention": DA.launches,
                "flash_attention": FA.launches}
    stats["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    stats["init_s"] = init_s
    stats["params"] = n_params
    check(stats["requests_done"] == n_req, f"served {stats['requests_done']}"
                                           f" of {n_req} requests")
    for r in reqs:
        check(r.done and len(r.out_tokens) == new_tokens,
              f"request {r.rid}: {len(r.out_tokens)} tokens of {new_tokens}")
        check(all(0 <= t < cfg.vocab_size for t in r.out_tokens),
              f"request {r.rid}: token id outside the vocabulary")
    waves = math.ceil(n_req / spec.slots)
    check(launches["paged_decode_attention"]
          >= cfg.num_layers * stats["decode_steps"],
          f"decode kernel launched {launches['paged_decode_attention']} times"
          f" for {stats['decode_steps']} steps x {cfg.num_layers} layers")
    check(launches["flash_attention"] >= cfg.num_layers * waves,
          f"prefill kernel launched {launches['flash_attention']} times for "
          f"{waves} waves x {cfg.num_layers} layers")
    # full-width logits are finite and of the expected shape
    toks = torch.as_tensor(np.stack([r.prompt[-64:] for r in reqs[:2]]),
                           device=dev).long()
    logits, _ = api.prefill(cfg, params, {"tokens": toks})
    check(tuple(logits.shape) == (2, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"full-width prefill logits {tuple(logits.shape)} not finite")
    stats["profile"] = profile_chunk(torch, np, cfg, params, engine_mod, spec)
    return stats, launches


# benchmarks/kv_prefix.py's pooled spec and its shared-header traffic
KV_SPEC = dict(slots=8, max_len=288, prompt_len=256, chunk=8, kv_block=16,
               suffix_len=64)
KV_HEADER, KV_FEWSHOT, KV_REQUESTS, KV_NEW_TOKENS = 224, 16, 24, 32


def kv_prefix_trace(np, vocab, n=KV_REQUESTS, seed=0):
    """Shared-header prompts: one of 2 tiers' 224-token system header (14
    blocks of 16), on half the requests one of 2 16-token few-shot
    preambles, then a random tail of 8-32 tokens cut so that the prompt
    fits ``prompt_len`` (256; with a preamble the tail is 8-16 tokens)."""
    rng = np.random.default_rng(seed)
    headers = [rng.integers(0, vocab, KV_HEADER) for _ in range(2)]
    shots = [rng.integers(0, vocab, KV_FEWSHOT) for _ in range(2)]
    out = []
    for i in range(n):
        head = [headers[int(rng.integers(2))]]
        if i % 2:
            head.append(shots[int(rng.integers(2))])
        room = KV_SPEC["prompt_len"] - sum(len(h) for h in head)
        tail = rng.integers(0, vocab, int(rng.integers(8, min(32, room) + 1)))
        out.append(np.concatenate(head + [tail]))
    return out


def _engine_run(torch, engine_mod, cfg, params, spec, prompts, new_tokens,
                DA, FA, dev):
    """Serve ``prompts`` on a fresh engine with the launch counters zeroed
    just before ``run()`` and read just after: (engine, requests, stats,
    launches)."""
    eng = engine_mod.ServeEngine(cfg, params, spec, device=dev)
    reqs = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    torch.cuda.synchronize()
    DA.launches = DA.launches_bt = FA.launches = 0
    stats = eng.run()
    launches = {"paged_decode_attention": DA.launches,
                "paged_decode_attention_bt": DA.launches_bt,
                "flash_attention": FA.launches}
    check(stats["requests_done"] == len(prompts),
          f"served {stats['requests_done']} of {len(prompts)} requests")
    for r in reqs:
        check(r.done and len(r.out_tokens) == new_tokens
              and all(0 <= t < cfg.vocab_size for t in r.out_tokens),
              f"request {r.rid}: {len(r.out_tokens)} tokens of {new_tokens}"
              f" or a token outside the vocabulary")
    return eng, reqs, stats, launches


def pooled_engine_phase(torch, np, cfg, api, engine_mod, DA, FA, dev="cuda"):
    """Full-width olmo-1b in three engines on one shared-header trace (24
    requests, 32 new tokens each): pooled with sharing
    (``benchmarks/kv_prefix.py``'s spec), pooled with ``kv_share=False``,
    and the dense spec of the same envelope.  Share and no-share streams
    bitwise equal, ``kv_close`` leak-free for both, sharing cuts the
    prefill proxy and shares tokens; the pooled runs launch row 1 (decode
    over each chunk's gathered view) and never the flash kernel (their
    prefill is the plain ``blocked_attention``).  One suffix-prefill
    dispatch and one dense admission prefill are timed by CUDA events and
    the suffix dispatch profiled."""
    params = api.init_params(cfg, seed=0, device=dev)
    specs = {"share": engine_mod.SliceSpec(**KV_SPEC),
             "noshare": engine_mod.SliceSpec(**KV_SPEC, kv_share=False),
             "dense": engine_mod.SliceSpec(
                 **{k: v for k, v in KV_SPEC.items()
                    if k not in ("kv_block", "suffix_len")})}
    prompts = kv_prefix_trace(np, cfg.vocab_size)
    warm = kv_prefix_trace(np, cfg.vocab_size, n=3, seed=1)
    for spec in specs.values():              # cuBLAS handles, allocator
        _engine_run(torch, engine_mod, cfg, params, spec, warm, 4, DA, FA,
                    dev)[0].kv_close()
    torch.cuda.reset_peak_memory_stats()
    arms, streams = {}, {}
    for name, spec in specs.items():
        eng, reqs, stats, launches = _engine_run(
            torch, engine_mod, cfg, params, spec, prompts, KV_NEW_TOKENS, DA,
            FA, dev)
        streams[name] = [list(r.out_tokens) for r in reqs]
        stats.update(launches=launches, kv_stats=eng.kv_stats(),
                     ms_decode_chunk=stats["p50_chunk_s"] * 1e3,
                     prefill_dispatches=eng.prefill_flops_proxy
                     // (spec.slots * (spec.suffix_len or spec.prompt_len)))
        if spec.kv_block:
            check(launches["paged_decode_attention"]
                  >= cfg.num_layers * stats["decode_steps"]
                  and launches["flash_attention"] == 0
                  and launches["paged_decode_attention_bt"] == 0,
                  f"pooled engine ({name}) launches {launches} for "
                  f"{stats['decode_steps']} steps x {cfg.num_layers} layers")
            eng.kv_close()               # raises if a block leaked
            stats["blocks_leaked"] = eng.kvpool.stats()["allocated_blocks"]
        arms[name] = stats
        del eng, reqs
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(streams["share"] == streams["noshare"],
          "pooled engine: sharing on and off served different tokens")
    share, noshare = arms["share"]["kv_stats"], arms["noshare"]["kv_stats"]
    check(share["prefill_flops_proxy"] < noshare["prefill_flops_proxy"]
          and share["kv_shared_tokens"] > 0,
          f"sharing did not cut the prefill proxy: {share} vs {noshare}")

    # one suffix-prefill dispatch at the engine's shape (rows resuming
    # after a shared header) and one dense admission prefill, on the card
    B, Tc, bs = KV_SPEC["slots"], KV_SPEC["suffix_len"], KV_SPEC["kv_block"]
    nb = KV_SPEC["max_len"] // bs
    pool = api.init_kv_pool(cfg, 2 * B * nb, bs, device=dev)
    tables = torch.arange(B * nb, dtype=torch.int32, device=dev).reshape(B,
                                                                         nb)
    g = torch.Generator(device=dev).manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (B, Tc), generator=g, device=dev)
    start = np.full((B,), KV_HEADER, np.int32)
    valid = np.full((B,), 24, np.int32)
    suffix = lambda i: api.prefill_suffix(cfg, params, pool, toks, start,
                                          valid, tables)
    dense_toks = torch.randint(0, cfg.vocab_size, (B, KV_SPEC["prompt_len"]),
                               generator=g, device=dev)
    dense = lambda i: api.prefill(cfg, params, {"tokens": dense_toks},
                                  max_len=KV_SPEC["max_len"])
    DA.launches = FA.launches = 0
    lg, _ = suffix(0)
    check(tuple(lg.shape) == (B, cfg.vocab_size)
          and bool(torch.isfinite(lg).all()) and FA.launches == 0,
          "suffix prefill: logits not finite or a kernel launched")
    ms = {"suffix_prefill": cuda_ms(torch, suffix, 1, iters=10),
          "dense_prefill": cuda_ms(torch, dense, 1, iters=10)}
    arms["share"]["ms_prefill_dispatch"] = ms["suffix_prefill"]
    arms["noshare"]["ms_prefill_dispatch"] = ms["suffix_prefill"]
    arms["dense"]["ms_prefill_dispatch"] = ms["dense_prefill"]
    out = {"arms": arms, "requests": len(prompts),
           "prompt_lens": [len(p) for p in prompts],
           "bitwise_share_noshare": True, "peak_mem_gb": peak,
           "dense_equals_pooled_streams": streams["dense"] == streams["share"],
           "suffix_prefill_profile": profile_busy(torch, lambda: suffix(0))}
    return out, {n: a["launches"] for n, a in arms.items()}


def int8_engine_phase(torch, np, cfg, api, engine_mod, QU, DA, FA,
                      dev="cuda"):
    """Full-width olmo-1b with int8 weights (``SliceSpec(quant="int8")``)
    on the serve phase's 16 requests, counted: rows 1 and 2 launched; then
    an engine on ``dequantize_params`` of the same quantised tree serves
    the same tokens, bit for bit.  Weight storage bytes against the bf16
    tree's, and the device time a decode step of each engine takes (the
    int8 engine dequantises every weight at its use)."""
    params = api.init_params(cfg, seed=0, device=dev)
    spec = engine_mod.SliceSpec(**SERVE_SPEC, quant="int8")
    warm_prompt, prompts = serve_trace(np, cfg.vocab_size)
    _engine_run(torch, engine_mod, cfg, params, spec, [warm_prompt], 9, DA,
                FA, dev)
    torch.cuda.reset_peak_memory_stats()
    eng, reqs, stats, launches = _engine_run(
        torch, engine_mod, cfg, params, spec, prompts, SERVE_NEW_TOKENS, DA,
        FA, dev)
    stats["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    check(launches["paged_decode_attention"]
          >= cfg.num_layers * stats["decode_steps"]
          and launches["flash_attention"] >= cfg.num_layers,
          f"int8 engine launches {launches}")
    int8_bytes = eng.weight_stream_bytes()
    bf16_bytes = QU.storage_bytes(params)
    ratio = int8_bytes / bf16_bytes
    check(0.5 < ratio < 0.53, f"int8 weight bytes {int8_bytes} are "
                              f"{ratio:.4f} of bf16's {bf16_bytes}")
    mat = QU.dequantize_params(eng.params)
    prof = profile_chunk(torch, np, cfg, params, engine_mod, spec)
    del params
    dense_spec = engine_mod.SliceSpec(**SERVE_SPEC)
    _, mreqs, mstats, _ = _engine_run(
        torch, engine_mod, cfg, mat, dense_spec, prompts, SERVE_NEW_TOKENS,
        DA, FA, dev)
    check([r.out_tokens for r in reqs] == [r.out_tokens for r in mreqs],
          "int8 engine and its dequantised tree served different tokens")
    mprof = profile_chunk(torch, np, cfg, mat, engine_mod, dense_spec)
    if "device_busy_ms" in prof and "device_busy_ms" in mprof:
        stats["dequant_device_ms_per_step"] = (
            prof["device_busy_ms"] - mprof["device_busy_ms"]) / spec.chunk
    stats.update(profile=prof, dequantized_profile=mprof)
    stats.update(launches=launches, weight_stream_bytes=int8_bytes,
                 bf16_weight_stream_bytes=bf16_bytes,
                 weight_bytes_ratio=ratio, bitwise_dequantized=True,
                 dequantized_tokens_per_s=mstats["tokens_per_s"],
                 dequantized_mean_ttft_s=mstats["mean_ttft_s"])
    return stats, launches


def profile_chunk(torch, np, cfg, params, engine_mod, spec):
    """torch.profiler over one decode chunk of 8 full slots (after a warm
    chunk): device kernel time, launches and the top kernels.  Where the
    profiler records no device time this says so instead of a number.
    Only the card's activity is recorded, as in `profile_busy`: the host's
    op events (~2,000-4,000 launches a step) took the profiler 10-20 s a
    chunk to gather."""
    from torch.profiler import ProfilerActivity, profile
    eng = engine_mod.ServeEngine(cfg, params, spec, device="cuda")
    rng = np.random.default_rng(1)
    for _ in range(spec.slots):
        eng.submit(rng.integers(0, cfg.vocab_size, size=spec.prompt_len),
                   max_new_tokens=4 * spec.chunk)
    eng.step_chunk()                        # admission + a warm chunk
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step_chunk()                        # the same work, unprofiled
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step_chunk()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    ms = [(e.name, e.time_range.elapsed_us() / 1e3) for e in dev_events]
    busy_ms = sum(t for _, t in ms)
    if not dev_events or busy_ms <= 0:
        return {"device_time": "not measured (no device events recorded)"}
    by_name = {}
    for name, t in ms:
        by_name[name] = by_name.get(name, 0.0) + t
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"steps": spec.chunk, "wall_ms": wall_plain * 1e3,
            "wall_ms_profiled": wall * 1e3, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / (wall_plain * 1e3)),
            "device_events": len(dev_events),
            "device_events_per_step": len(dev_events) / spec.chunk,
            "top_device_ms": [[n[:70], t] for n, t in top]}


def profile_busy(torch, fn, top=6, wall=None):
    """The card's busy and idle share over one call of ``fn`` (after a warm
    call): summed device kernel time from torch.profiler over the wall
    time of the same call unprofiled.  With ``wall`` (s, a like call timed
    already) ``fn`` runs once, profiled, against it.  Only the card's
    activity is recorded: host-side op events, tens of thousands a
    training step, took the profiler longer to gather than the step."""
    from torch.profiler import ProfilerActivity, profile
    if wall is None:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in dev_events:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    if not dev_events or busy_ms <= 0:
        return {"device_time": "not measured (no device events recorded)"}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / (wall * 1e3)),
            "device_events": len(dev_events),
            "top_device_ms": [[n[:70], t] for n, t in top]}


def dlrm_reference_phase(torch, registry, api, ShapeConfig, FL, EG,
                         dev="cuda"):
    """Reduced dlrm0, same weights and batch: CPU (plain) vs card
    (kernels), both lookup routes."""
    cfg = registry.get_reduced("dlrm0")
    p_cpu = api.init_params(cfg, seed=0, device="cpu")
    b_cpu = api.make_batch(cfg, ShapeConfig("dlrm_check", "prefill", 1, 64),
                           seed=1, device="cpu")
    p_gpu, b_gpu = _to(p_cpu, dev), _to(b_cpu, dev)
    worst = (0.0, 0.0, 0.0)                 # (err / tol, err, tol)
    f0, g0 = FL.launches, EG.launches
    for fused in (True, False):
        want = api.forward(cfg, p_cpu, b_cpu, fused=fused)[0]
        with torch.inference_mode():
            got = api.forward(cfg, p_gpu, b_gpu, fused=fused)[0].cpu()
        check(got.shape == want.shape == (64,)
              and bool(torch.isfinite(got).all()),
              f"dlrm reference (fused={fused}): logits {tuple(got.shape)} "
              f"not finite")
        tol = LOGIT_REL_TOL * want.abs().max().item()
        err = (got - want).abs().max().item()
        check(err <= tol, f"dlrm reference (fused={fused}): card vs CPU "
                          f"logits differ by {err:.4g} > {tol:.4g}")
        worst = max(worst, (err / tol, err, tol))
    check(FL.launches > f0 and EG.launches >= g0 + len(cfg.dlrm.tables),
          "dlrm reference: the card's forward did not reach the kernels")
    return worst


def emb_small_cases(torch, FL, EG, EL, ES, QU, REF, dev="cuda"):
    """Edge cases of the embedding kernels against their plain versions:
    the fused lookup (f32 and int8 at every dlrm0 width), the row gather,
    the single-table lookup and the scatter of deduplicated ids."""
    gen = torch.Generator(device=dev).manual_seed(2)
    dims = (32, 64, 96, 128, 192, 256)
    groups = [torch.randn((r, d), generator=gen, device=dev)
              for r, d in zip((300, 50, 7, 1000, 20, 64), dims)]
    # (group, valency, mean): valency 1 and 128, sum and mean, every dim
    spec = [(0, 1, 0), (0, 128, 1), (1, 10, 1), (2, 32, 0), (3, 128, 0),
            (4, 1, 1), (5, 100, 1), (5, 128, 0), (3, 3, 1), (1, 1, 0)]
    B = 17
    slots, cols, c0 = [], [], 0
    for g, w, mean in spec:
        slots.append((g, c0, c0 + w, mean))
        cols.append(torch.randint(-1, groups[g].shape[0], (B, w),
                                  generator=gen, device=dev))
        c0 += w
    rows = torch.cat(cols, dim=1).to(torch.int32)
    rows[0, slots[1][1]:slots[1][2]] = -1      # mean slot, count 0
    rows[0, slots[3][1]:slots[3][2]] = -1      # sum slot, every id -1
    rows[1, slots[4][1]:slots[4][2]] = 5       # one row repeated 128 times
    rows[2, slots[6][1]:slots[6][2]:2] = 3     # repeated rows among others
    rows[3, :] = -1                            # a sample with no value
    slot_t = torch.tensor(slots, dtype=torch.int32, device=dev)
    got = FL.fused_lookup(groups, rows, slot_t, 256)
    want = REF.fused_lookup_ref(groups, rows, slot_t, 256)
    err_f = max_err(torch, got, want, "fused lookup, small cases",
                    EMB_ATOL, EMB_RTOL)
    check(not got[3].any() and not got[0, 1].any() and not got[0, 3].any(),
          "fused lookup: a slot with no valid id is not zero")
    for k, (g, _, _, _) in enumerate(slots):
        check(not got[:, k, dims[g]:].any(),
              f"fused lookup: lanes past dim {dims[g]} of slot {k} not zero")
    err_g = 0.0
    for V, D, Bg, Vl in ((300, 32, 5, 1), (1000, 128, 9, 128),
                         (7, 96, 4, 10), (64, 256, 3, 100)):
        table = torch.randn((V, D), generator=gen, device=dev)
        ids = torch.randint(-1, V, (Bg, Vl), generator=gen, device=dev
                            ).to(torch.int32)
        ids[0] = -1
        got = EG.embedding_gather(table, ids)
        err_g = max(err_g, max_err(torch, got,
                                   REF.embedding_gather_ref(table, ids),
                                   f"row gather V{V} D{D} B{Bg} Vl{Vl}",
                                   EMB_ATOL, EMB_RTOL))
        check(not got[0].any(), "row gather: ids -1 gave a non-zero row")
    # int8 fused lookup: the same descriptors over the quantised groups
    qts = [QU.quantize_row_space(g) for g in groups]
    qg, qs = [q.q for q in qts], [q.scale for q in qts]
    got = FL.fused_lookup_q(qg, qs, rows, slot_t, 256)
    err_q = max_err(torch, got, REF.fused_lookup_q_ref(qg, qs, rows, slot_t,
                                                       256),
                    "int8 fused lookup, small cases", EMB_ATOL, EMB_RTOL)
    check(not got[3].any() and not got[0, 1].any() and not got[0, 3].any(),
          "int8 fused lookup: a slot with no valid id is not zero")
    check_int8_bound(torch, REF, got, FL.fused_lookup(groups, rows, slot_t,
                                                      256),
                     qs, rows, slot_t, "int8 fused lookup, small cases")
    # single-table lookup at the fig9 shape (benchmarks/fig9_sparsecore.py),
    # a sample with every id -1, a row repeated over the span
    table = torch.randn((8192, 64), generator=gen, device=dev)
    ids = torch.randint(-1, 8192, (64, 16), generator=gen, device=dev
                        ).to(torch.int32)
    ids[0] = -1
    ids[1] = 77
    err_l = 0.0
    for comb in ("sum", "mean"):
        got = EL.embedding_lookup(table, ids, comb)
        err_l = max(err_l, max_err(torch, got,
                                   REF.embedding_lookup_ref(table, ids, comb),
                                   f"embedding lookup fig9 shape {comb}",
                                   EMB_ATOL, EMB_RTOL))
        check(not got[0].any(), "embedding lookup: all ids -1, not zero")
    # scatter: unique sorted ids with a -1 tail, and a sorted stream with
    # adjacent duplicates, a -1 tail and ids past V; bitwise the plain
    # version in index order (deterministic algorithms)
    V, D = 5000, 96
    uniq = torch.cat([torch.randperm(V, generator=gen, device=dev)[:1500]
                      .sort().values, torch.full((500,), -1, device=dev)])
    dup = torch.cat([torch.randint(0, V, (3000,), generator=gen, device=dev)
                     .sort().values, torch.tensor([V, V + 9], device=dev),
                     torch.full((40,), -1, device=dev)])
    for what, sid in (("unique ids", uniq), ("adjacent duplicates", dup)):
        sid = sid.to(torch.int32)
        grads = torch.randn((sid.numel(), D), generator=gen, device=dev)
        got = ES.embedding_scatter(grads, sid, V)
        with deterministic(torch):
            want = REF.embedding_scatter_ref(grads, sid, V)
        scatter_bitwise(torch, [got], [want], f"embedding scatter, {what}")
        check(torch.equal(got.cpu(), REF.embedding_scatter_ref(
            grads.cpu(), sid.cpu(), V)), f"embedding scatter, {what}: not "
                                         f"bitwise the CPU's sequential sum")
    return err_f, err_g, err_q, err_l


def rows_by_group(torch, plan, groups, rows):
    """(valid ids, distinct valid rows) of ``rows`` per row space: what a
    lookup of this batch must read."""
    col_group = torch.tensor([g for g, a, b, _ in plan.slot_table
                              for _ in range(a, b)], device=rows.device)
    out = []
    for gi in range(len(groups)):
        ids = rows[:, col_group == gi]
        ids = ids[ids >= 0]
        out.append((ids.numel(), int(torch.unique(ids).numel())))
    return out


def _bag_inputs(torch, plan, groups, rows):
    """``F.embedding_bag`` inputs computing the fused lookup per row space:
    flat ids, bag offsets and per-id weights (0 for an invalid id, 1/count
    in a mean slot)."""
    B, dev = rows.shape[0], rows.device
    bags = []
    for gi, table in enumerate(groups):
        spans = [(a, b, m) for g, a, b, m in plan.slot_table if g == gi]
        if not spans:
            continue
        ids = torch.cat([rows[:, a:b] for a, b, _ in spans], dim=1)
        w = (ids >= 0).float()
        starts, c0 = [], 0
        for a, b, mean in spans:
            if mean:
                part = w[:, c0:c0 + b - a]
                part /= part.sum(dim=1, keepdim=True).clamp_min(1.0)
            starts.append(c0)
            c0 += b - a
        offsets = (torch.arange(B, device=dev)[:, None] * c0
                   + torch.tensor(starts, device=dev)[None, :]).reshape(-1)
        bags.append((table, ids.clamp_min(0).reshape(-1).long(), offsets,
                     w.reshape(-1)))
    return bags


def digest(tensors):
    """sha256 of the tensors' bytes, in order: whether two source trees'
    kernels give the same bits on the same inputs."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def dlrm_kernel_phase(torch, F, cfg, coll, tables, DL, ShapeConfig, FL, EG,
                      EL, REF, ops, B, dev="cuda", digests=False):
    """The lookup kernels at the one-card dlrm0's tables and batch B (the
    fused lookup, the row gather and the single-table lookup): held
    against their plain versions, timed beside them, their byte bound and
    a PyTorch yardstick.  ``digests``: each kernel's result also gets the
    `digest` of its output on the first batch (``sha256``)."""
    shape = ShapeConfig("dlrm_kernels", "prefill", 1, B)
    feats = []
    for seed in (10, 11):
        batch = DL.make_batch(cfg, shape,
                              torch.Generator(device=dev).manual_seed(seed))
        feats.append({t.name: batch[f"cat_{t.name}"]
                      for t in cfg.dlrm.tables})
        del batch
    fused_in = [coll.fused_inputs(tables, f) for f in feats]
    plan = fused_in[0][0]
    K, dmax = len(plan.fslots), plan.dmax
    out = {}
    with torch.inference_mode():
        # -- fused lookup ---------------------------------------------------
        _, groups, rows, slots = fused_in[0]
        got = FL.fused_lookup(groups, rows, slots, dmax)
        err = max_err(torch, got,
                      REF.fused_lookup_ref(groups, rows, slots, dmax),
                      f"fused lookup at B={B}", EMB_ATOL, EMB_RTOL)
        sha = digest([got]) if digests else None
        del got
        args = [(g, r, sl, dmax) for _, g, r, sl in fused_in]
        ms = cuda_ms(torch, lambda i: FL.fused_lookup(*args[i]), 2, iters=20)
        plain_ms = cuda_ms(torch, lambda i: REF.fused_lookup_ref(*args[i]),
                           2, iters=5, warmup=1)
        # bytes: each distinct row once (the Zipf ids repeat rows within a
        # batch), every id once, the (B, K, Dmax) output once; operations:
        # one add per lane of every valid id
        counts = rows_by_group(torch, plan, groups, rows)
        valid_rows = sum(v for v, _ in counts)
        distinct_rows = sum(n for _, n in counts)
        valid_elems = sum(v * g.shape[1] for (v, _), g in zip(counts, groups))
        distinct_elems = sum(n * g.shape[1]
                             for (_, n), g in zip(counts, groups))
        nbytes = (distinct_elems * 4 + rows.numel() * 4 + B * K * dmax * 4
                  + K * 16)
        bound_ms, bound_by = bound(nbytes, valid_elems, F32_FLOPS_PER_S)
        bags = [_bag_inputs(torch, p, g, r) for p, g, r, _ in fused_in]

        def library(i):
            for table, ids, offs, w in bags[i]:
                F.embedding_bag(ids, table, offs, mode="sum",
                                per_sample_weights=w)

        library_ms = cuda_ms(torch, library, 2, iters=10)
        del bags
        out["fused_lookup"] = dict(
            name="fused_lookup", route="cuda",
            source="src/repro_torch/kernels/csrc/fused_lookup.cu",
            replaces="src/repro/kernels/embedding_lookup.py:207",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=library_ms, batch=B,
            valid_rows=valid_rows, distinct_rows=distinct_rows,
            bytes=nbytes, sha256=sha)
        del fused_in, args, rows, groups
        # -- row gather: one launch per table, as the per-table route -----
        sets = [[(coll.table_view(tables, t), f[t.name])
                 for t in cfg.dlrm.tables] for f in feats]
        err = 0.0
        h = hashlib.sha256()
        for view, ids in sets[0]:
            got = EG.embedding_gather(view, ids)
            err = max(err, max_err(torch, got,
                                   REF.embedding_gather_ref(view, ids),
                                   f"row gather at B={B}", EMB_ATOL,
                                   EMB_RTOL))
            if digests:
                h.update(digest([got]).encode())
            del got

        def each(fn, i, sets=sets):
            for args in sets[i]:
                fn(*args)

        ms = cuda_ms(torch, lambda i: each(EG.embedding_gather, i), 2,
                     iters=10)
        plain_ms = cuda_ms(torch, lambda i: each(REF.embedding_gather_ref, i),
                           2, iters=5, warmup=1)
        clamped = [[(ids.clamp_min(0), view) for view, ids in st]
                   for st in sets]        # F.embedding(ids, table)
        library_ms = cuda_ms(torch, lambda i: each(F.embedding, i, clamped),
                             2, iters=10)
        # bytes: each table's distinct rows once, every id once, the
        # (B, Vl, D) output once
        valid_rows = sum(int((ids >= 0).sum()) for _, ids in sets[0])
        distinct = [int(torch.unique(ids[ids >= 0]).numel())
                    for _, ids in sets[0]]
        distinct_elems = sum(n * view.shape[1]
                             for n, (view, _) in zip(distinct, sets[0]))
        out_elems = sum(ids.numel() * view.shape[1] for view, ids in sets[0])
        nbytes = (distinct_elems + out_elems) * 4 + sum(
            ids.numel() * 4 for _, ids in sets[0])
        bound_ms, bound_by = bound(nbytes, 0)
        out["embedding_gather"] = dict(
            name="embedding_gather", route="cuda",
            source="src/repro_torch/kernels/csrc/embedding_gather.cu",
            replaces="src/repro/kernels/embedding_lookup.py:57",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=library_ms, batch=B,
            launches_timed=len(sets[0]), valid_rows=valid_rows,
            distinct_rows=sum(distinct), bytes=nbytes,
            sha256=h.hexdigest() if digests else None)
        del clamped
        # -- single-table lookup: one launch per table through ops (this
        # slice's path), counted; held against its plain version and the
        # per-table route (gather kernel + _combine) --------------------
        lsets = [[(view, ids, t.combiner) for t, (view, ids) in
                  zip(cfg.dlrm.tables, st)] for st in sets]
        EL.launches = 0
        path = [ops.embedding_lookup(*x) for x in lsets[0]]
        torch.cuda.synchronize()
        launches = EL.launches
        check(launches == len(lsets[0]), f"embedding lookup at B={B}: "
                                         f"{launches} launches for "
                                         f"{len(lsets[0])} tables")
        per_table = coll.lookup(tables, feats[0], fused=False)
        err = err_route = 0.0
        for t, got, x in zip(cfg.dlrm.tables, path, lsets[0]):
            err = max(err, max_err(torch, got, REF.embedding_lookup_ref(*x),
                                   f"embedding lookup at B={B}", EMB_ATOL,
                                   EMB_RTOL))
            err_route = max(err_route, max_err(
                torch, got, per_table[t.name], f"embedding lookup vs the "
                f"per-table route at B={B}", EMB_ATOL, EMB_RTOL))
        sha = digest(path) if digests else None
        del path, per_table
        # 150 wrapper calls a batch: 4 batches timed, so the host queues
        # every launch behind the spin (`host` says whether it did)
        host = {}
        ms = cuda_ms(torch, lambda i: each(EL.embedding_lookup, i, lsets), 2,
                     iters=4, host=host)
        plain_ms = cuda_ms(torch, lambda i: each(REF.embedding_lookup_ref, i,
                                                 lsets), 2, iters=5, warmup=1)
        bags = []                   # F.embedding_bag(ids, table, weights)
        for st in lsets:
            per = []
            for view, ids, comb in st:
                w = (ids >= 0).float()
                if comb == "mean":
                    w /= w.sum(dim=1, keepdim=True).clamp_min(1.0)
                per.append((ids.clamp_min(0).long(), view, w))
            bags.append(per)
        library_ms = cuda_ms(torch, lambda i: [
            F.embedding_bag(ids, view, mode="sum", per_sample_weights=w)
            for ids, view, w in bags[i]], 2, iters=4)
        del bags
        # bytes: each table's distinct rows once, every id once, the (B, D)
        # output once; operations: one add per lane of every valid id
        valid_elems = sum(int((ids >= 0).sum()) * view.shape[1]
                          for view, ids in sets[0])
        nbytes = (distinct_elems + sum(B * view.shape[1]
                                       for view, _ in sets[0])) * 4 + sum(
            ids.numel() * 4 for _, ids in sets[0])
        bound_ms, bound_by = bound(nbytes, valid_elems, F32_FLOPS_PER_S)
        out["embedding_lookup"] = dict(
            name="embedding_lookup", route="cuda",
            source="src/repro_torch/kernels/csrc/embedding_lookup.cu",
            replaces="src/repro/kernels/embedding_lookup.py:109",
            launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
            batch=B, max_abs_err_vs_per_table_route=err_route,
            launches_timed=len(lsets[0]), valid_rows=valid_rows,
            distinct_rows=sum(distinct), bytes=nbytes, sha256=sha,
            host_ms_a_batch=host["host_ms"],
            queue_ahead_ms=host["queue_ahead_ms"],
            host_bound=host["host_bound"])
    return out


def int8_lookup_phase(torch, cfg, coll, tables, DL, ShapeConfig, FL, QU,
                      REF, ops, dev="cuda", digests=False):
    """The int8 fused lookup at full width: the resident scoring row
    spaces quantised with ``quantize_row_space`` block by block (at most
    one f32 block's tile extra), then ``ops.fused_lookup_q`` at B = 256
    and 4096 on the scoring phase's descriptors (counted), held against
    its plain version on the card and, within the int8 bound, the f32
    fused lookup on the same batch; timed beside both."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    qt = {k: QU.quantize_row_space(v)
          for k, v in tables.items()}
    torch.cuda.synchronize()
    stats = {"quantize_s": time.perf_counter() - t0,
             "int8_gb": sum(q.q.numel() for q in qt.values()) / 1e9,
             "scales_gb": sum(q.scale.numel() * 4 for q in qt.values()) / 1e9,
             "quantize_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    launches = 0
    for B in (DLRM_CHIP_BATCH, DLRM_BATCH):
        shape = ShapeConfig("dlrm_int8", "prefill", 1, B)
        ins = []
        for seed in (20, 21):
            batch = DL.make_batch(cfg, shape, torch.Generator(
                device=dev).manual_seed(seed))
            plan, groups, rows, slots = coll.fused_inputs(
                tables, {t.name: batch[f"cat_{t.name}"]
                         for t in cfg.dlrm.tables})
            ins.append(([qt[k].q for k in plan.keys],
                        [qt[k].scale for k in plan.keys], groups, rows,
                        slots))
            del batch
        dmax, K = plan.dmax, len(plan.fslots)
        qg, qs, groups, rows, slots = ins[0]
        with torch.inference_mode():
            FL.launches_q = 0
            got = ops.fused_lookup_q(qg, qs, rows, slots, dmax)
            torch.cuda.synchronize()
            n = FL.launches_q
            check(n == 1, f"int8 fused lookup at B={B}: {n} launches for "
                          f"one batch")
            launches += n
            err = max_err(torch, got, REF.fused_lookup_q_ref(
                qg, qs, rows, slots, dmax), f"int8 fused lookup at B={B}",
                EMB_ATOL, EMB_RTOL)
            used = check_int8_bound(
                torch, REF, got, FL.fused_lookup(groups, rows, slots, dmax),
                qs, rows, slots, f"int8 fused lookup at B={B}")
            again = FL.fused_lookup_q(qg, qs, rows, slots, dmax)
            check(torch.equal(got, again), f"int8 fused lookup at B={B}: "
                                           f"two launches differ")
            sha = digest([got]) if digests else None
            del got, again
            ms = cuda_ms(torch, lambda i: FL.fused_lookup_q(
                *ins[i][:2], *ins[i][3:], dmax), 2, iters=20)
            f32_ms = cuda_ms(torch, lambda i: FL.fused_lookup(
                *ins[i][2:], dmax), 2, iters=20)
            plain_ms = cuda_ms(torch, lambda i: REF.fused_lookup_q_ref(
                *ins[i][:2], *ins[i][3:], dmax), 2, iters=5, warmup=1)
        # bytes: each distinct row's int8 lanes and its scales once, every
        # id once, the (B, K, dmax) output once; operations: a multiply
        # and an add per lane of every valid id
        counts = rows_by_group(torch, plan, qg, rows)
        nbytes = sum(nd * (q.shape[1] + s.shape[1] * 4)
                     for (_, nd), q, s in zip(counts, qg, qs)) \
            + rows.numel() * 4 + B * K * dmax * 4 + K * 16
        ops_n = 2 * sum(v * q.shape[1] for (v, _), q in zip(counts, qg))
        bound_ms, bound_by = bound(nbytes, ops_n, F32_FLOPS_PER_S)
        stats[B] = dict(
            name="fused_lookup_q", route="cuda",
            source="src/repro_torch/kernels/csrc/fused_lookup.cu",
            replaces="src/repro/kernels/embedding_lookup.py:170",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None, batch=B,
            f32_fused_lookup_ms=f32_ms, int8_bound_share_used=used,
            sha256=sha,
            valid_rows=sum(v for v, _ in counts),
            distinct_rows=sum(nd for _, nd in counts), bytes=nbytes)
        del ins, qg, qs, groups, rows, slots
    peak = torch.cuda.max_memory_allocated()
    stats["peak_mem_gb"] = peak / 1e9
    stats["launches"] = launches
    check(peak < INT8_PEAK_LIMIT, f"int8 lookup: peak allocated "
                                  f"{peak / 1e9:.2f} GB >= "
                                  f"{INT8_PEAK_LIMIT / 1e9:.0f} GB")
    del qt
    return stats


def dlrm_score_phase(torch, cfg, params, coll, api, ShapeConfig, FL, EG,
                     n_fused=20, n_legacy=3, dev="cuda"):
    """The DLRM scoring path at B = DLRM_BATCH through both lookup
    routes; counters zeroed just before and read just after."""
    shape = ShapeConfig("dlrm_score", "prefill", 1, DLRM_BATCH)
    with torch.inference_mode():           # warm-up, outside the count
        batch = api.make_batch(cfg, shape, seed=100, device=dev)
        for fused in (True, False):
            api.forward(cfg, params, batch, coll=coll, fused=fused)
        del batch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = {True: [], False: []}
    kept = {}
    FL.launches = EG.launches = 0
    with torch.inference_mode():
        for i in range(n_fused + n_legacy):
            fused = i < n_fused
            seed = 200 + (i if fused else i - n_fused)
            batch = api.make_batch(cfg, shape, seed=seed, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = api.forward(cfg, params, batch, coll=coll,
                                    fused=fused)
            torch.cuda.synchronize()
            times[fused].append(time.perf_counter() - t0)
            check(tuple(logits.shape) == (DLRM_BATCH,)
                  and bool(torch.isfinite(logits).all()),
                  f"dlrm scoring: logits {tuple(logits.shape)} not finite")
            if seed - 200 < n_legacy:
                kept[(fused, seed)] = logits.cpu()
            del batch, logits
    launches = {"fused_lookup": FL.launches, "embedding_gather": EG.launches}
    peak = torch.cuda.max_memory_allocated()
    n_tables = len(cfg.dlrm.tables)
    check(launches["fused_lookup"] == n_fused,
          f"fused lookup launched {launches['fused_lookup']} times for "
          f"{n_fused} batches")
    check(launches["embedding_gather"] == n_legacy * n_tables,
          f"row gather launched {launches['embedding_gather']} times for "
          f"{n_legacy} batches x {n_tables} tables")
    worst = (0.0, 0.0, 0.0)
    for seed in range(200, 200 + n_legacy):
        a, b = kept[(True, seed)], kept[(False, seed)]
        tol = LOGIT_REL_TOL * a.abs().max().item()
        err = (a - b).abs().max().item()
        check(err <= tol, f"dlrm scoring: fused and per-table logits differ "
                          f"by {err:.4g} > {tol:.4g} (batch seed {seed})")
        worst = max(worst, (err / tol, err, tol))
    check(peak < 52e9, f"dlrm scoring: peak allocated {peak / 1e9:.2f} GB "
                       f">= 52 GB (a copy of the tables?)")
    with torch.inference_mode():
        batch = api.make_batch(cfg, shape, seed=300, device=dev)
        prof = profile_busy(torch, lambda: api.forward(cfg, params, batch,
                                                       coll=coll))
        del batch
    fused_s, legacy_s = sum(times[True]), sum(times[False])
    stats = {
        "batch": DLRM_BATCH, "batches_fused": n_fused,
        "batches_per_table": n_legacy,
        "samples_per_s_fused": DLRM_BATCH * n_fused / fused_s,
        "samples_per_s_per_table": DLRM_BATCH * n_legacy / legacy_s,
        "ms_per_batch_fused": [t * 1e3 for t in times[True]],
        "ms_per_batch_per_table": [t * 1e3 for t in times[False]],
        "median_ms_fused": sorted(times[True])[n_fused // 2] * 1e3,
        "median_ms_per_table": sorted(times[False])[n_legacy // 2] * 1e3,
        "peak_mem_gb": peak / 1e9,
        "fused_vs_per_table_logits": {"max_err": worst[1],
                                      "tolerance": worst[2]},
        "profile_fused_batch": prof,
    }
    return stats, launches


def dlrm0_cut(registry, table_params):
    """dlrm0 with its vocabularies cut to ``table_params`` f32 table
    parameters; tables, dims, valencies, combiners and tower as published."""
    import dataclasses
    from repro_torch.configs import dlrm0
    base = registry.get_config("dlrm0")
    return base.replace(dlrm=dataclasses.replace(
        base.dlrm, tables=dlrm0._table_specs(target_params=table_params)))


def dlrm_phases(torch, F, registry, api, DL, ShapeConfig, FL, EG, EL, ES,
                QU, REF, ops, dev="cuda"):
    worst = dlrm_reference_phase(torch, registry, api, ShapeConfig, FL, EG,
                                 dev)
    log(f"dlrm reference: card vs CPU logits differ by at most "
        f"{worst[1]:.3e} (tolerance {worst[2]:.3e} at that route)")
    small = emb_small_cases(torch, FL, EG, EL, ES, QU, REF, dev)
    log(f"dlrm kernels, small cases: max |err| fused {small[0]:.3e}, "
        f"gather {small[1]:.3e}, int8 fused {small[2]:.3e}, lookup "
        f"{small[3]:.3e}; the scatter of deduplicated ids bitwise")
    cfg = dlrm0_cut(registry, DLRM_TABLE_PARAMS)
    n_emb = sum(t.vocab_size * t.dim for t in cfg.dlrm.tables)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    info = {"init_s": time.perf_counter() - t0, "emb_params": n_emb,
            "emb_gb": n_emb * 4 / 1e9,
            "dense_params": sum(t.numel() for t in _leaves(
                [params["bottom"], params["top"]])),
            "init_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    check(sum(t.numel() for t in params["tables"].values()) == n_emb,
          "dlrm0 tables: row spaces do not hold every table")
    log("dlrm0 (one card):", json.dumps(info))
    coll = DL.collection_for(cfg)
    kern = {}
    for B in (DLRM_CHIP_BATCH, DLRM_BATCH):
        kern[B] = dlrm_kernel_phase(torch, F, cfg, coll, params["tables"], DL,
                                    ShapeConfig, FL, EG, EL, REF, ops, B,
                                    dev)
        log(f"dlrm kernels at B={B}:", json.dumps(kern[B]))
        torch.cuda.empty_cache()
    stats, launches = dlrm_score_phase(torch, cfg, params, coll, api,
                                       ShapeConfig, FL, EG, dev=dev)
    stats.update(info)
    log("dlrm scoring:", json.dumps(stats))
    torch.cuda.empty_cache()
    int8 = int8_lookup_phase(torch, cfg, coll, params["tables"], DL,
                             ShapeConfig, FL, QU, REF, ops, dev)
    log("int8 fused lookup:", json.dumps({str(k): v
                                          for k, v in int8.items()}))
    return kern, stats, launches, int8


@contextlib.contextmanager
def deterministic(torch):
    """``torch.use_deterministic_algorithms`` on inside (an op with no
    deterministic form raises): the plain scatter's ``index_add_`` then
    sorts its indices stably and sums each row's duplicates in index
    order, the fused scatter's order."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def scatter_bitwise(torch, got, want, what):
    """Fails unless every row space of ``got`` is finite and bitwise
    ``want`` (tolerance 0: both sum each row in (b, s) order); returns
    the max |kernel - plain|, 0.0."""
    torch.cuda.synchronize()
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.shape == w.shape, f"{what}: row space {i} shape "
                                  f"{tuple(g.shape)} != {tuple(w.shape)}")
        check(bool(torch.isfinite(g).all()), f"{what}: non-finite gradient")
        err = (g - w).abs().max().item()
        check(torch.equal(g, w), f"{what}: row space {i} is not bitwise the "
                                 f"ordered plain sum (max |kernel - plain| "
                                 f"{err:.3e})")
        worst = max(worst, err)
    return worst


def scatter_small_cases(torch, FS, REF, dev="cuda"):
    """Edge cases of the fused scatter against its plain version, bitwise:
    on the CPU (sequential (b, s) order) and on the card (deterministic
    algorithms); two launches bitwise equal."""
    gen = torch.Generator(device=dev).manual_seed(3)
    cases = [  # row-space shapes, (group, valency, mean) per slot, B
        ([(300, 32), (50, 64), (7, 96), (1000, 128), (20, 192), (64, 256)],
         [(0, 1, 0), (0, 128, 1), (1, 10, 1), (2, 32, 0), (3, 128, 0),
          (4, 1, 1), (5, 100, 1), (5, 128, 0), (3, 3, 1), (1, 1, 0)], 17),
        ([(50, 32), (20, 256)], [(0, 1, 0), (1, 5, 1), (0, 3, 0)], 10_000),
        ([(9, 4), (40, 8)], [(1, 3, 1), (0, 6, 0), (1, 1, 0)], 64),
    ]
    worst = 0.0
    for shapes, spec, B in cases:
        slots, cols, c0 = [], [], 0
        for g, w, mean in spec:
            slots.append((g, c0, c0 + w, mean))
            cols.append(torch.randint(-1, shapes[g][0], (B, w),
                                      generator=gen, device=dev))
            c0 += w
        rows = torch.cat(cols, dim=1).to(torch.int32)
        if B == 10_000:
            rows[:, 0] = 3                     # one row named 10,000 times
            rows[::7, 1:] = -1
        else:
            rows[0, :] = -1                    # a sample with no value
            rows[1, slots[1][1]:slots[1][2]] = 2
        slot_t = torch.tensor(slots, dtype=torch.int32, device=dev)
        col_slot = REF.column_slots(slot_t, c0).int()
        dmax = max(d for _, d in shapes)
        gout = torch.randn((B, len(spec), dmax), generator=gen, device=dev)
        what = f"fused scatter, small case B={B}"
        got = FS.fused_scatter(gout, rows, slot_t, col_slot, shapes)
        again = FS.fused_scatter(gout, rows, slot_t, col_slot, shapes)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{what}: two launches differ")
        cpu = REF.fused_scatter_ref(gout.cpu(), rows.cpu(), slot_t.cpu(),
                                    shapes)
        check(all(torch.equal(a.cpu(), b) for a, b in zip(got, cpu)),
              f"{what}: not bitwise the CPU's sequential (b, s) sum")
        with deterministic(torch):
            want = REF.fused_scatter_ref(gout, rows, slot_t, shapes, col_slot)
        worst = max(worst, scatter_bitwise(torch, got, want, what))
    return worst


def dedup_scatter_phase(torch, coll, plan, feats, grads, ES, DD, REF, ops):
    """The scatter of deduplicated ids at full width: per table, its batch
    ids deduplicated (``dedup_ids``), then ``ops.embedding_scatter(
    grad_t[uniq.clamp_min(0)], uniq, V_t)`` (counted) must equal the
    table's slice ``grad_t`` of the fused scatter's gradient bitwise (rows
    the batch does not name are zero in both); the 150 calls timed whole,
    fill and kernel apart, beside the plain version, the byte bound and
    ``index_copy_``."""
    dev = grads[0].device
    gidx = {k: i for i, k in enumerate(plan.keys)}
    items = []                    # (src (N, D), uniq (N,), V, grad_t, num)
    for _, g in sorted(coll.local_groups.items()):
        for s in g.slots:
            grad_t = grads[gidx[g.name]][s.offset:s.offset + s.rows]
            uniq, _, num = DD.dedup_ids(feats[s.spec.name].reshape(-1))
            items.append((grad_t[uniq.clamp_min(0).long()], uniq, s.rows,
                          grad_t, int(num)))
    with torch.no_grad():
        ES.launches = 0
        outs = [ops.embedding_scatter(src, uniq, V)
                for src, uniq, V, _, _ in items]
        torch.cuda.synchronize()
        launches = ES.launches
        check(launches == len(items), f"embedding scatter: {launches} "
                                      f"launches for {len(items)} tables")
        err = 0.0
        for out, (_, _, _, grad_t, _) in zip(outs, items):
            check(torch.equal(out, grad_t), "embedding scatter: not bitwise "
                                            "the table's fused-scatter "
                                            "gradient")
            err = max(err, (out - grad_t).abs().max().item())
        del outs

        def whole(i):
            for src, uniq, V, _, _ in items:
                ES.embedding_scatter(src, uniq, V)

        def fill(i):
            for src, _, V, _, _ in items:
                torch.zeros((V, src.shape[1]), device=dev)

        def plain(i):
            for src, uniq, V, _, _ in items:
                REF.embedding_scatter_ref(src, uniq, V)

        ms = cuda_ms(torch, whole, 1, iters=5, warmup=1)
        fill_ms = cuda_ms(torch, fill, 1, iters=5, warmup=1)
        plain_ms = cuda_ms(torch, plain, 1, iters=3, warmup=1)
        bufs = [torch.zeros((V, src.shape[1]), device=dev)
                for src, _, V, _, _ in items]
        kernel_ms = cuda_ms(torch, lambda i: [
            ES.scatter_rows(b, src, uniq)
            for b, (src, uniq, _, _, _) in zip(bufs, items)], 1, iters=10)
        del bufs
        copies = [(V, src[:n], uniq[:n].long())
                  for src, uniq, V, _, n in items]

        def library(i):           # zero fill + index_copy_ of the unique rows
            for V, rows, idx in copies:
                torch.zeros((V, rows.shape[1]), device=dev).index_copy_(
                    0, idx, rows)

        library_ms = cuda_ms(torch, library, 1, iters=5, warmup=1)
        del copies
    # bytes: the (V, D) output written once, every id read once, the
    # gradient rows of the valid ids read once; operations: one add a lane
    n_ids = sum(uniq.numel() for _, uniq, _, _, _ in items)
    n_uniq = sum(n for *_, n in items)
    nbytes = sum(V * src.shape[1] * 4 + uniq.numel() * 4
                 + n * src.shape[1] * 4 for src, uniq, V, _, n in items)
    adds = sum(n * src.shape[1] for src, _, _, _, n in items)
    bound_ms, bound_by = bound(nbytes, adds, F32_FLOPS_PER_S)
    del items
    return dict(name="embedding_scatter", route="cuda",
                source="src/repro_torch/kernels/csrc/embedding_scatter.cu",
                replaces="src/repro/kernels/embedding_grad.py:35",
                launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                kernel_ms=kernel_ms, fill_ms=fill_ms, ids=n_ids, unique_ids=n_uniq,
                dedup_ratio=1.0 - n_uniq / max(n_ids, 1), bytes=nbytes)


def descriptor_rows(torch, rows, slots, col_slot, shapes):
    """(B, S) int64: each descriptor's row, numbered across the row spaces
    in order, -1 where it adds nothing (id < 0, id >= R_g, a column no
    slot spans); and a function from such a row to its row space's dim."""
    cs = col_slot.long()
    g = torch.where(cs >= 0, slots[:, 0].long()[cs.clamp_min(0)], -1)
    nrows = torch.tensor([r for r, _ in shapes], device=rows.device)
    dims = torch.tensor([d for _, d in shapes], device=rows.device)
    first = torch.cumsum(nrows, 0) - nrows
    gg = g.clamp_min(0)
    r = rows.long()
    valid = (g >= 0)[None, :] & (r >= 0) & (r < nrows[gg][None, :])
    gid = torch.where(valid, first[gg][None, :] + r, -1)

    def row_dim(x):
        return dims[torch.searchsorted(first, x, right=True) - 1]

    return gid, row_dim


def scatter_kernel_phase(torch, cfg, coll, Dataset, ShapeConfig, FS, REF, B,
                         dedup=None, dev="cuda"):
    """The fused scatter at the training tables' shapes and a batch of B
    from ``Dataset``: bitwise its plain version under deterministic
    algorithms and across two launches, timed whole and by part beside its
    byte bound and ``index_add_``.  ``dedup`` (ES, DD, ops) also runs the
    scatter of deduplicated ids on its gradient (`dedup_scatter_phase`)."""
    shape = ShapeConfig("dlrm_train", "train", 1, B)
    t0 = time.perf_counter()
    batch = Dataset(cfg, shape, seed=0).batch(0)
    data_s = time.perf_counter() - t0
    feats = {t.name: torch.as_tensor(batch[f"cat_{t.name}"], device=dev)
             for t in cfg.dlrm.tables}
    del batch
    meta = {g.name: torch.empty((g.total_rows, d), device="meta")
            for d, g in coll.local_groups.items()}
    plan, groups, rows, slots = coll.fused_inputs(meta, feats)
    col_slot = plan.on(rows.device)[2]
    shapes = [tuple(g.shape) for g in groups]
    K, dmax = len(plan.fslots), plan.dmax
    gen = torch.Generator(device=dev).manual_seed(4)
    gout = torch.randn((B, K, dmax), generator=gen, device=dev)
    what = f"fused scatter at B={B}"

    def plain(i=0):
        return REF.fused_scatter_ref(gout, rows, slots, shapes, col_slot)

    with torch.no_grad():
        got = FS.fused_scatter(gout, rows, slots, col_slot, shapes)
        again = FS.fused_scatter(gout, rows, slots, col_slot, shapes)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{what}: two launches differ")
        del again
        with deterministic(torch):
            want = plain()
        err = scatter_bitwise(torch, got, want, what)
        del want
        dd = None
        if dedup is not None:
            dd = dedup_scatter_phase(torch, coll, plan, feats, got, *dedup[:2],
                                     REF, dedup[2])
        del got, feats
        ms = cuda_ms(torch, lambda i: FS.fused_scatter(
            gout, rows, slots, col_slot, shapes), 1, iters=10)
        order_ms = cuda_ms(torch, lambda i: FS.order_descriptors(
            rows, slots, col_slot, shapes), 1, iters=10)
        keys, order = FS.order_descriptors(rows, slots, col_slot, shapes)
        key_bits = keys.element_size() * 8
        grads = [torch.zeros(s, device=dev) for s in shapes]
        kernel_ms = cuda_ms(torch, lambda i: FS.reduce_runs(
            grads, gout, col_slot, keys, order), 1, iters=10)
        fill_ms = cuda_ms(torch, lambda i: [torch.zeros(s, device=dev)
                                            for s in shapes], 1, iters=10)
        plain_ms = cuda_ms(torch, plain, 1, iters=3, warmup=1)
        with deterministic(torch):
            plain_det_ms = cuda_ms(torch, plain, 1, iters=3, warmup=1)
        # the kernel half's two launches apart
        short_ms = cuda_ms(torch, lambda i: FS.reduce_short_runs(
            grads, gout, col_slot, keys, order), 1, iters=10)
        hot = FS.reduce_short_runs(grads, gout, col_slot, keys, order)
        hot_ms = cuda_ms(torch, lambda i: FS.reduce_hot_runs(
            grads, gout, col_slot, keys, order, hot), 1, iters=10)
        items = FS.hot_items(hot)
        hot_runs, hot_items = items[:, 0].unique().numel(), items.shape[0]
        del hot, items
        del keys, order
        # what this batch needs: valid descriptors, distinct rows, runs;
        # from the descriptors, whatever the wrapper's key encoding
        gid, row_dim = descriptor_rows(torch, rows, slots, col_slot, shapes)
        valid = gid[gid >= 0]
        n_valid = valid.numel()
        runs, counts = torch.unique(valid, return_counts=True)
        valid_elems = int(row_dim(valid).sum())
        distinct_elems = int(row_dim(runs).sum())
        n_distinct = runs.numel()
        longest = int(counts.max())
        # the longest run alone: every other descriptor invalid
        hot_rows = torch.where(gid == runs[counts.argmax()], rows, -1)
        del valid, runs, counts, gid
        hot_in = FS.order_descriptors(hot_rows.int(), slots, col_slot, shapes)
        hot_run_ms = cuda_ms(torch, lambda i: FS.reduce_runs(
            grads, gout, col_slot, *hot_in), 1, iters=5)
        del hot_rows, hot_in, grads
        # index_add_, one call a row space, on the gathered slot gradients
        # (gathered beforehand, outside the timing)
        S = rows.shape[1]
        cs = col_slot.long()
        col_group = slots[:, 0].long()[cs]
        b_idx = torch.arange(B, device=dev)[:, None].expand(B, S)
        adds = []
        for g, (R, D) in enumerate(shapes):
            take = (col_group == g)[None, :] & (rows >= 0)
            adds.append((rows[take].long(),
                         gout[b_idx[take], cs.expand(B, S)[take], :D]))
            del take

        def library(i):
            for (R, D), (idx, src) in zip(shapes, adds):
                torch.zeros((R, D), device=dev).index_add_(0, idx, src)

        library_ms = cuda_ms(torch, library, 1, iters=5, warmup=1)
        del adds, b_idx
    lanes = B * sum(s.dim for s in plan.fslots) * 4      # gout lanes < D_k
    grad_bytes = sum(R * D * 4 for R, D in shapes)
    nbytes = grad_bytes + lanes + rows.numel() * 4 + K * 16
    bound_ms, bound_by = bound(nbytes, valid_elems, F32_FLOPS_PER_S)
    touched_ms = (distinct_elems * 4 + lanes + rows.numel() * 4) \
        / HBM_BYTES_PER_S * 1e3
    return dict(name="fused_scatter", route="cuda",
                source="src/repro_torch/kernels/csrc/fused_scatter.cu",
                replaces="src/repro/kernels/embedding_grad.py:74",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, batch=B,
                plain_deterministic_ms=plain_det_ms,
                order_ms=order_ms, kernel_ms=kernel_ms, fill_ms=fill_ms,
                key_bits=key_bits, short_ms=short_ms, hot_ms=hot_ms,
                hot_runs=hot_runs, hot_items=hot_items,
                hot_run_min=FS.HOT_RUN, hot_run_ms=hot_run_ms,
                longest_run=longest,
                valid_descriptors=n_valid, distinct_rows=n_distinct,
                touched_bound_ms=touched_ms, gout_read_gb=valid_elems * 4 / 1e9,
                bytes=nbytes, gradient_gb=grad_bytes / 1e9,
                dataset_batch_s=data_s), dd


def dlrm_train_reference_phase(torch, registry, api, ShapeConfig,
                               ParallelConfig, OptimizerConfig, STEPS, OPT,
                               FS, EG, dev="cuda", cfg=None, batch=64):
    """Reduced dlrm0 (or ``cfg``), same weights and a batch of ``batch``:
    one step's gradients on the CPU (plain versions) and on the card
    (kernels), through both lookup routes, the per-table one also against
    the fused one; then Adam on the same gradients."""
    cfg = cfg or registry.get_reduced("dlrm0")
    p_cpu = api.init_params(cfg, seed=0, device="cpu")
    b_cpu = api.make_batch(cfg, ShapeConfig("dlrm_check", "train", 1, batch),
                           seed=1, device="cpu")
    p_gpu, b_gpu = _to(p_cpu, dev), _to(b_cpu, dev)
    pcfg = ParallelConfig(remat="none")
    s0 = FS.launches
    _, g_cpu = STEPS.value_and_grad(cfg, pcfg, p_cpu, b_cpu)
    _, g_gpu = STEPS.value_and_grad(cfg, pcfg, p_gpu, b_gpu)
    torch.cuda.synchronize()
    check(FS.launches == s0 + 1,
          "dlrm training reference: the card's backward did not reach the "
          "fused-scatter kernel")
    worst = (0.0, 0.0, 0.0)                 # (err / tol, err, tol)
    for i, (a, b) in enumerate(zip(g_gpu, g_cpu)):
        check(bool(torch.isfinite(a).all()), f"gradient leaf {i} not finite")
        tol = LOGIT_REL_TOL * b.abs().max().item()
        err = (a.cpu() - b).abs().max().item()
        check(err <= tol, f"dlrm training reference: gradient leaf {i} "
                          f"differs by {err:.4g} > {tol:.4g}")
        worst = max(worst, (err / tol if tol else 0.0, err, tol))
    # the per-table route (ops.GatherRows): one gather a table forward, one
    # fused scatter a row space backward
    per_table = ParallelConfig(remat="none", emb_pipeline=False)
    g0, s0 = EG.launches, FS.launches
    _, gp_cpu = STEPS.value_and_grad(cfg, per_table, p_cpu, b_cpu)
    _, gp_gpu = STEPS.value_and_grad(cfg, per_table, p_gpu, b_gpu)
    torch.cuda.synchronize()
    check((EG.launches - g0, FS.launches - s0)
          == (len(cfg.dlrm.tables), len(p_cpu["tables"])),
          "dlrm training reference: the per-table route did not run one "
          "gather a table and one fused scatter a row space")
    for i, (a, b, f) in enumerate(zip(gp_gpu, gp_cpu, g_gpu)):
        check(bool(torch.isfinite(a).all()), f"per-table gradient leaf {i} "
                                             f"not finite")
        tol = LOGIT_REL_TOL * b.abs().max().item()
        err = (a.cpu() - b).abs().max().item()
        err_f = (a - f).abs().max().item()
        check(err <= tol and err_f <= tol,
              f"dlrm training reference: per-table gradient leaf {i} differs "
              f"from the CPU's by {err:.4g}, from the fused route's by "
              f"{err_f:.4g} (tolerance {tol:.4g})")
        worst = max(worst, (max(err, err_f) / tol if tol else 0.0,
                            max(err, err_f), tol))
    ocfg = OptimizerConfig(lr=1e-2, warmup_steps=1)
    with torch.no_grad():
        p_same = _to(p_gpu, "cpu")
        g_same = [g.cpu() for g in g_gpu]
    p1, s1, _ = OPT.apply(ocfg, p_gpu, g_gpu, OPT.init(ocfg, p_gpu))
    p2, s2, _ = OPT.apply(ocfg, p_same, g_same, OPT.init(ocfg, p_same))
    adam_err = 0.0
    for x, y in zip(OPT.leaves([p1, s1.mu, s1.nu]),
                    OPT.leaves([p2, s2.mu, s2.nu])):
        err = (x.detach().cpu() - y.detach()).abs()
        lim = ADAM_RTOL * (y.detach().abs() + y.detach().abs().max())
        check(bool((err <= lim).all()), f"dlrm training reference: Adam "
                                        f"differs by {err.max().item():.3e}")
        adam_err = max(adam_err, err.max().item())
    return worst, adam_err


def train_phase(torch, cfg, ShapeConfig, RunConfig, ParallelConfig,
                OptimizerConfig, Trainer, STEPS, OPT, FL, FS, dev="cuda",
                batch=TRAIN_BATCH, warm=TRAIN_WARM, timed=TRAIN_TIMED):
    """``Trainer.train`` on the one-card training cut, as a user runs it:
    each step draws its batch from the trainer's ``Dataset`` on the host,
    moves it to the card and steps.  The ``Dataset.batch`` calls are timed
    apart; counters are zeroed just before the run and read just after."""
    run = RunConfig(model=cfg, shape=ShapeConfig("dlrm_train", "train", 1,
                                                 batch),
                    parallel=ParallelConfig(remat="none"),
                    optimizer=OptimizerConfig(lr=3e-4, warmup_steps=20))
    trainer = Trainer(run, device=dev)
    n = warm + timed
    calls, drawn = [], []

    class TimedDataset:             # the trainer's Dataset, calls timed
        def __init__(self, ds):
            self.ds = ds

        def batch(self, step):
            t0 = time.perf_counter()
            drawn.append(self.ds.batch(step))
            calls.append(time.perf_counter() - t0)
            return drawn[-1]

    trainer.dataset = TimedDataset(trainer.dataset)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = trainer.init_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    first = sorted(state.params["tables"])[0]
    before = [state.params["tables"][first][:4096].clone(),
              state.params["top"][0]["w"][:64].clone()]
    marks = []

    def on_step(step, _):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    FL.launches = FS.launches = FS.launches_hot = FS.launches_keys = 0
    t_start = time.perf_counter()
    state = trainer.train(n, state=state, log_every=1, on_step=on_step)
    launches = {"fused_lookup": FL.launches, "fused_scatter": FS.launches,
                "fused_scatter_hot": FS.launches_hot,
                "fused_scatter_keys": FS.launches_keys}
    peak = torch.cuda.max_memory_allocated()
    step_s = [b - a for a, b in zip([t_start] + marks[:-1], marks)]
    losses = [m["loss"] for m in trainer.metrics_log]
    check(all(v == n for v in launches.values()),
          f"training: {launches} launches for {n} steps (one fused lookup "
          f"and one fused scatter, with its key and hot-run kernels, a "
          f"step)")
    check(len(losses) == n and all(math.isfinite(x) for x in losses),
          f"training: losses {losses}")
    data_s = list(calls)            # the profiled steps below draw more
    check(len(data_s) == n, f"training: {len(data_s)} Dataset.batch calls "
                            f"for {n} steps")
    after = [state.params["tables"][first][:4096],
             state.params["top"][0]["w"][:64]]
    check(all(bool(torch.isfinite(a).all()) and not torch.equal(a, b)
              for a, b in zip(after, before)),
          "training: the params did not move (or are not finite)")
    check(peak < TRAIN_PEAK_LIMIT, f"training: peak allocated "
                                   f"{peak / 1e9:.2f} GB >= "
                                   f"{TRAIN_PEAK_LIMIT / 1e9:.0f} GB")
    timed_s = step_s[warm:]
    # the same batches staged on the card first: the train step alone
    staged = [{k: torch.as_tensor(v, device=dev) for k, v in h.items()}
              for h in drawn[:n]]
    del drawn[:]
    torch.cuda.synchronize()
    card_s = []
    for b in staged:
        t0 = time.perf_counter()
        trainer.train_step(state.params, state.opt_state, b)
        torch.cuda.synchronize()
        card_s.append(time.perf_counter() - t0)
    card_s = card_s[warm:]
    # one more step, split into forward + backward and Adam
    b = staged[0]
    del staged[1:]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, grads = STEPS.value_and_grad(cfg, run.parallel, state.params, b)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, opt, _ = OPT.apply(run.optimizer, state.params, grads,
                          state.opt_state)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del grads
    state = type(state)(state.params, opt, state.step + 1)

    def user_step():                # Trainer.train: host data included
        nonlocal state
        state = trainer.train(state.step + 1, state=state, log_every=1)

    def card_step():                # the train step on a batch on the card
        trainer.train_step(state.params, state.opt_state, b)

    prof_user = profile_busy(torch, user_step, top=12)
    prof_card = profile_busy(torch, card_step, top=12)
    med = sorted(timed_s)[len(timed_s) // 2]
    med_card = sorted(card_s)[len(card_s) // 2]
    return {"batch": batch, "steps_warm": warm, "steps_timed": timed,
            "ms_per_step": [t * 1e3 for t in step_s],
            "dataset_batch_s": data_s,
            "median_ms_per_step": med * 1e3,
            "samples_per_s": batch * len(timed_s) / sum(timed_s),
            "ms_per_step_staged": [t * 1e3 for t in card_s],
            "median_ms_per_step_staged": med_card * 1e3,
            "samples_per_s_staged": batch * len(card_s) / sum(card_s),
            "losses": losses, "peak_mem_gb": peak / 1e9, "init_s": init_s,
            "fwd_bwd_ms": (t1 - t0) * 1e3, "adam_ms": (t2 - t1) * 1e3,
            "profile_user_step": prof_user,
            "profile_step_on_card": prof_card}, launches


def per_table_train_phase(torch, cfg, ShapeConfig, RunConfig,
                          ParallelConfig, OptimizerConfig, Trainer, FL, EG,
                          FS, dev="cuda", batch=PER_TABLE_TRAIN_BATCH,
                          steps=2):
    """``Trainer.train`` with ``ParallelConfig(emb_pipeline=False)`` on the
    one-card training cut: the per-table route trains on the card.
    Counters zeroed just before and read just after: one gather a table
    and one fused scatter a row space a step, no fused lookup."""
    run = RunConfig(model=cfg, shape=ShapeConfig("dlrm_train", "train", 1,
                                                 batch),
                    parallel=ParallelConfig(remat="none",
                                            emb_pipeline=False),
                    optimizer=OptimizerConfig(lr=3e-4, warmup_steps=20))
    trainer = Trainer(run, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = trainer.init_state()
    first = sorted(state.params["tables"])[0]
    before = [state.params["tables"][first][:4096].clone(),
              state.params["top"][0]["w"][:64].clone()]
    n_spaces = len(state.params["tables"])
    marks = []

    def on_step(step, _):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    FL.launches = EG.launches = FS.launches = FS.launches_hot = 0
    FS.launches_keys = 0
    t0 = time.perf_counter()
    state = trainer.train(steps, state=state, log_every=1, on_step=on_step)
    launches = {"fused_lookup": FL.launches, "embedding_gather": EG.launches,
                "fused_scatter": FS.launches,
                "fused_scatter_hot": FS.launches_hot,
                "fused_scatter_keys": FS.launches_keys}
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in trainer.metrics_log]
    want = {"fused_lookup": 0,
            "embedding_gather": steps * len(cfg.dlrm.tables),
            "fused_scatter": steps * n_spaces,
            "fused_scatter_hot": steps * n_spaces,
            "fused_scatter_keys": steps * n_spaces}
    check(launches == want, f"per-table training: launches {launches}, "
                            f"want {want}")
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"per-table training: losses {losses}")
    after = [state.params["tables"][first][:4096],
             state.params["top"][0]["w"][:64]]
    check(all(bool(torch.isfinite(a).all()) and not torch.equal(a, b)
              for a, b in zip(after, before)),
          "per-table training: the params did not move (or are not finite)")
    check(peak < TRAIN_PEAK_LIMIT, f"per-table training: peak allocated "
                                   f"{peak / 1e9:.2f} GB >= "
                                   f"{TRAIN_PEAK_LIMIT / 1e9:.0f} GB")
    return {"batch": batch, "steps": steps, "losses": losses,
            "ms_per_step": [(b - a) * 1e3
                            for a, b in zip([t0] + marks[:-1], marks)],
            "peak_mem_gb": peak / 1e9, "launches": launches}


# dense training: olmo-1b as published, one cell of train_2k on one card
DENSE_SHAPE = ("train_2k", "train", 2048, 8)       # max_seq_len x 8 rows
DENSE_XENT_CHUNK = 256
DENSE_WARM, DENSE_TIMED = 3, 10
# f32 params, gradient, m and v of 1.18e9 parameters are 18.8 GB; with the
# accumulator of the second microbatch, one recomputed layer and a chunk
# of logits the step stays far under this
DENSE_PEAK_LIMIT = 60e9
# the fault drill: full width, depth cut to 2 layers (a checkpoint of
# params, m and v is 2.85 GB instead of 14.1 GB)
DRILL_LAYERS = 2
DRILL_STEPS, DRILL_CKPT_EVERY, DRILL_FAIL_AT, DRILL_PREEMPT_AT = 12, 4, 7, 5


def _dense_run(cfg, RunConfig, ShapeConfig, ParallelConfig, OptimizerConfig):
    return RunConfig(model=cfg, shape=ShapeConfig(*DENSE_SHAPE),
                     parallel=ParallelConfig(remat="block",
                                             xent_chunk=DENSE_XENT_CHUNK),
                     optimizer=OptimizerConfig(lr=3e-4, warmup_steps=5))


def _xent_kept(torch, STEPS, cfg, params, x, labels, chunk):
    """The chunked cross-entropy summed without the per-chunk checkpoint:
    every chunk's logits stay in the graph until the backward pass."""
    B, T, _ = x.shape
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, T, chunk):
        tot = tot + STEPS._chunk_xent_sum(cfg, params, x[:, c0:c0 + chunk],
                                          labels[:, c0:c0 + chunk])
    return tot / (B * T)


def xent_memory(torch, cfg, api, STEPS, params, batch):
    """Peak memory of the chunked cross-entropy's forward and backward on
    one microbatch's final hidden states, with the loss's per-chunk
    recompute and with every chunk's logits kept: (peak GB over the
    inputs, the same kept), bitwise equal losses and gradients checked."""
    with torch.no_grad():
        x, _ = api.forward(cfg, params, {"tokens": batch["tokens"]},
                           return_hidden=True)
    out, res = {}, []
    for recompute in (True, False):
        xv = x.detach().clone().requires_grad_(True)
        emb = params["embed"].detach().requires_grad_(True)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        if recompute:
            loss = STEPS._xent_chunked(cfg, {"embed": emb}, xv,
                                       batch["labels"], DENSE_XENT_CHUNK)
        else:
            loss = _xent_kept(torch, STEPS, cfg, {"embed": emb}, xv,
                              batch["labels"], DENSE_XENT_CHUNK)
        grads = torch.autograd.grad(loss, [xv, emb])
        torch.cuda.synchronize()
        out["recompute" if recompute else "kept"] = (
            torch.cuda.max_memory_allocated() - base) / 1e9
        res.append((loss.detach(),) + tuple(grads))
        del xv, emb, loss, grads
    check(all(torch.equal(a, b) for a, b in zip(*res)),
          "chunked cross-entropy: recompute changed the loss or gradients")
    del res
    return out


def dense_train_phase(torch, np, cfg, CL, CKPT, RunConfig, ShapeConfig,
                      ParallelConfig, OptimizerConfig, Trainer, STEPS, OPT,
                      api, engine_mod, DA, FA, dev="cuda"):
    """Full-width olmo-1b through ``repro_torch.cluster``: ``Slice.train``
    for 3 warm and 10 timed steps of train_2k (2 microbatches of 4 x 2048
    tokens, remat per layer, the cross-entropy in chunks of 256), one
    profiled step, the cross-entropy's memory with and without its
    per-chunk recompute, a checkpoint of the trained state saved and
    restored into a fresh ``Trainer`` (every leaf bitwise), then
    ``Slice.serve`` of the trained params cast to bf16 on the serve phase's
    16 requests, rows 1 and 2 counted."""
    import shutil
    import tempfile
    run = _dense_run(cfg, RunConfig, ShapeConfig, ParallelConfig,
                     OptimizerConfig)
    accum = STEPS.pick_accum_steps(cfg, run.shape,
                                   xent_chunk=run.parallel.xent_chunk)
    check(accum == 2, f"dense training: {accum} microbatches, want 2")
    sc = CL.Supercomputer(device=dev)
    sl = sc.allocate((8, 8, 8))
    sess = sl.train(run)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = sess.trainer.init_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(state.params))
    static = 4 * 4 * n_params               # f32 params, gradient, m, v
    probes = [("embed", state.params["embed"][:1024]),
              ("wq", state.params["layers"]["attn"]["wq"][0, :64]),
              ("wo_mlp", state.params["layers"]["mlp"]["wo"][-1, :64])]
    before = [t.clone() for _, t in probes]
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for i in range(DENSE_WARM + DENSE_TIMED):
        t0 = time.perf_counter()
        sess.run(i + 1, state=state if i == 0 else None, log_every=1)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    state = sess.state
    losses = [m["loss"] for m in sess.metrics_log]
    check(len(losses) == DENSE_WARM + DENSE_TIMED
          and all(math.isfinite(x) for x in losses),
          f"dense training: losses {losses}")
    check(losses[-1] < losses[0], f"dense training: the loss did not fall "
                                  f"from its first value: {losses}")
    moved = [not torch.equal(a, b) and bool(torch.isfinite(b).all())
             for a, (_, b) in zip(before, probes)]
    check(all(moved), f"dense training: params moved {moved}")
    check(static < peak < DENSE_PEAK_LIMIT,
          f"dense training: peak allocated {peak / 1e9:.2f} GB outside "
          f"({static / 1e9:.2f}, {DENSE_PEAK_LIMIT / 1e9:.0f}) GB")
    prof = profile_busy(torch, lambda: sess.run(sess.state.step + 1,
                                                log_every=1), top=25)
    state = sess.state
    timed = step_s[DENSE_WARM:]
    tokens = run.shape.global_batch * run.shape.seq_len
    med = sorted(timed)[len(timed) // 2]
    # one more step, split: forward + backward of one microbatch, then Adam
    mb = {k: torch.as_tensor(v[:run.shape.global_batch // accum], device=dev)
          for k, v in sess.trainer.dataset.batch(state.step).items()}
    grads = [None] * len(list(_leaves(state.params)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    STEPS.accumulate_grad(cfg, run.parallel, state.params, mb, grads,
                          1.0 / accum)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, opt, _ = OPT.apply(run.optimizer, state.params, grads,
                          state.opt_state)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del grads
    state = type(state)(state.params, opt, state.step + 1)
    split = {"fwd_bwd_microbatch_ms": (t1 - t0) * 1e3,
             "adam_ms": (t2 - t1) * 1e3}
    # the chunked cross-entropy's memory, on the same microbatch
    xent_gb = xent_memory(torch, cfg, api, STEPS, state.params, mb)
    del mb
    # a checkpoint of the trained state, restored into a fresh Trainer
    ckpt = tempfile.mkdtemp(prefix="dense_ckpt_")
    try:
        writer = Trainer(run, device=dev, ckpt_dir=ckpt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        writer.save(state)
        save_s = time.perf_counter() - t0
        disk = sum(f.stat().st_size for f in Path(ckpt).rglob("*.npz"))
        t0 = time.perf_counter()
        back = Trainer(run, device=dev, ckpt_dir=ckpt).restore()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    mine = CKPT.flatten({"params": state.params, "opt": state.opt_state})
    theirs = CKPT.flatten({"params": back.params, "opt": back.opt_state})
    check([k for k, _ in mine] == [k for k, _ in theirs]
          and back.step == state.step
          and all((a == b) if isinstance(a, int) else
                  (b.device == a.device and torch.equal(a, b))
                  for (_, a), (_, b) in zip(mine, theirs)),
          "dense checkpoint: a restored leaf differs from the saved one")
    del back, mine, theirs
    # serve on the trained weights, in bf16
    bf16 = OPT.tree_map(lambda t: t.to(torch.bfloat16), state.params)
    stats_train = {"losses": losses, "params": n_params}
    del state, probes, before
    sess.close()
    gc.collect()
    torch.cuda.empty_cache()
    spec = engine_mod.SliceSpec(**SERVE_SPEC)
    _, prompts = serve_trace(np, cfg.vocab_size)
    serve = sl.serve(cfg, bf16, spec)
    reqs = [serve.submit(p, max_new_tokens=SERVE_NEW_TOKENS)
            for p in prompts]
    torch.cuda.synchronize()
    DA.launches = FA.launches = 0
    sstats = serve.run()
    launches = {"paged_decode_attention": DA.launches,
                "flash_attention": FA.launches}
    check(sstats["requests_done"] == len(prompts)
          and all(r.done and len(r.out_tokens) == SERVE_NEW_TOKENS
                  for r in reqs),
          f"serving the trained weights: {sstats['requests_done']} of "
          f"{len(prompts)} requests")
    check(all(v > 0 for v in launches.values()),
          f"serving the trained weights: launches {launches}")
    sl.free()
    del bf16, serve
    return dict(stats_train, **{
        "shape": list(DENSE_SHAPE), "microbatches": accum,
        "xent_chunk": DENSE_XENT_CHUNK, "remat": run.parallel.remat,
        "steps_warm": DENSE_WARM, "steps_timed": DENSE_TIMED,
        "ms_per_step": [t * 1e3 for t in step_s],
        "median_ms_per_step": med * 1e3,
        "spread_ms": [min(timed) * 1e3, max(timed) * 1e3],
        "tokens_per_s": tokens * len(timed) / sum(timed),
        "peak_mem_gb": peak / 1e9, "static_state_gb": static / 1e9,
        "init_s": init_s, "profile_step": prof, "step_split": split,
        "xent_peak_gb": xent_gb,
        "ckpt_save_s": save_s, "ckpt_restore_s": restore_s,
        "ckpt_disk_gb": disk / 1e9,
        "serve": {k: sstats[k] for k in ("requests_done", "tokens",
                                         "tokens_per_s", "mean_ttft_s",
                                         "decode_steps")},
        "launches": launches}), launches


def _losses(sess):
    return {m["step"]: m["loss"] for m in sess.metrics_log if "loss" in m}


def step_bits(torch, cfg, run, STEPS, params, batch, accum):
    """Loss and gradient share of one microbatch, as a list of tensors:
    what `make_train_step` adds into a step's fresh accumulator
    (``STEPS.accumulate_grad`` at ``1 / accum``)."""
    acc = [None] * len(list(_leaves(params)))
    m = STEPS.accumulate_grad(cfg, run.parallel, params, batch, acc,
                              1.0 / accum)
    return [m["loss"]] + acc


def fault_drill_phase(torch, cfg, CL, RunConfig, ShapeConfig,
                      ParallelConfig, OptimizerConfig, STEPS, OPT,
                      dev="cuda"):
    """The §2.3 drill at full width, depth cut to 2 layers, on one
    ``Supercomputer``: first the step's determinism on the card (one step
    twice on the same state, remat on and off, and under
    ``torch.use_deterministic_algorithms``); then a clean 12-step run on one
    slice and a run on another that loses a block at step 7 (checkpoints
    every 4: a spare swapped in, step 4 restored); then a run preempted at
    step 5 and resumed on a slice of another shape.  Both interrupted loss
    curves and final params must be the clean run's, bit for bit."""
    import dataclasses
    import shutil
    import tempfile
    cfg = cfg.replace(num_layers=DRILL_LAYERS)
    run = _dense_run(cfg, RunConfig, ShapeConfig, ParallelConfig,
                     OptimizerConfig)
    sc = CL.Supercomputer(device=dev)
    out = {"layers": DRILL_LAYERS}
    # -- determinism of one step on the card
    probe = sc.allocate((4, 4, 4))
    sess = probe.train(run)
    state = sess.trainer.init_state()
    batch = {k: torch.as_tensor(v[:run.shape.global_batch // 2], device=dev)
             for k, v in sess.trainer.dataset.batch(0).items()}
    a = step_bits(torch, cfg, run, STEPS, state.params, batch, 2)
    b = step_bits(torch, cfg, run, STEPS, state.params, batch, 2)
    out["same_step_twice_bitwise"] = all(torch.equal(x, y)
                                         for x, y in zip(a, b))
    del b
    off = run.replace(parallel=dataclasses.replace(run.parallel,
                                                   remat="none"))
    c = step_bits(torch, cfg, off, STEPS, state.params, batch, 2)
    out["remat_on_equals_off_bitwise"] = all(torch.equal(x, y)
                                             for x, y in zip(a, c))
    del c
    # an op PyTorch knows to be nondeterministic raises in here
    with deterministic(torch):
        d = step_bits(torch, cfg, run, STEPS, state.params, batch, 2)
    out["deterministic_algorithms_equal"] = all(torch.equal(x, y)
                                                for x, y in zip(a, d))
    del a, d, batch, state
    probe.free()
    check(out["same_step_twice_bitwise"] and
          out["remat_on_equals_off_bitwise"] and
          out["deterministic_algorithms_equal"],
          f"fault drill: the step is not deterministic on the card: {out}")
    gc.collect()
    torch.cuda.empty_cache()
    dirs = [tempfile.mkdtemp(prefix="drill_") for _ in range(2)]
    try:
        # -- a block fails at step 7; the clean run beside it
        faulted, reference = sc.allocate((8, 8, 8)), sc.allocate((8, 8, 8))
        t0 = time.perf_counter()
        ref = reference.train(run, DRILL_STEPS, log_every=1)
        torch.cuda.synchronize()
        clean_s = time.perf_counter() - t0
        failed_block = faulted.blocks[0]
        t0 = time.perf_counter()
        sess = faulted.train(run, DRILL_STEPS, ckpt_dir=dirs[0],
                             ckpt_every=DRILL_CKPT_EVERY,
                             fail_at=DRILL_FAIL_AT, log_every=1)
        torch.cuda.synchronize()
        drill_s = time.perf_counter() - t0
        clean = _losses(ref)
        kinds = [e.kind for e in sess.interruptions]
        restarts = [m["step"] for m in sess.metrics_log if m.get("event")]
        logged = [(m["step"], m["loss"]) for m in sess.metrics_log
                  if "loss" in m]
        check(len(clean) == DRILL_STEPS
              and all(math.isfinite(x) for x in clean.values()),
              f"fault drill: clean losses {clean}")
        check(kinds == ["reconfigure"] and failed_block not in faulted.blocks
              and failed_block not in sc.scheduler.healthy
              and restarts == [DRILL_CKPT_EVERY],
              f"fault drill: events {kinds}, restarts at {restarts}, "
              f"blocks {faulted.blocks} (failed {failed_block})")
        check(all(clean[s] == x for s, x in logged)
              and _losses(sess) == clean,
              f"fault drill: losses {logged} differ from the clean run's "
              f"{clean}")
        check(all(torch.equal(x, y) for x, y in
                  zip(OPT.leaves(sess.params), OPT.leaves(ref.params))),
              "fault drill: final params differ from the clean run's")
        out.update(steps=DRILL_STEPS, ckpt_every=DRILL_CKPT_EVERY,
                   fail_at=DRILL_FAIL_AT, restored_step=restarts[0],
                   events=kinds, downtime_s=sess.stall_s,
                   clean_losses=[clean[s] for s in sorted(clean)],
                   clean_run_s=clean_s, drill_run_s=drill_s)
        del sess
        faulted.free()
        gc.collect()
        # -- preempted at step 5, resumed on a slice of another shape
        first = sc.allocate((8, 8, 8))
        sess = first.train(run, ckpt_dir=dirs[1],
                           ckpt_every=DRILL_CKPT_EVERY)
        sess.run(DRILL_PREEMPT_AT, log_every=1)
        first.request_preempt()
        sess.run(DRILL_STEPS, log_every=1)
        check(sess.preempted and sess.state.step == DRILL_PREEMPT_AT,
              f"preempt: stopped at {sess.state.step}, preempted "
              f"{sess.preempted}")
        first.free()
        second = sc.allocate((4, 8, 8))
        resumed = second.train(run, DRILL_STEPS, ckpt_dir=dirs[1],
                               ckpt_every=DRILL_CKPT_EVERY, log_every=1)
        curve = {**_losses(sess), **_losses(resumed)}
        check(curve == clean, f"preempt/resume: losses {curve} differ from "
                              f"the clean run's {clean}")
        check(all(torch.equal(x, y) for x, y in
                  zip(OPT.leaves(resumed.params), OPT.leaves(ref.params))),
              "preempt/resume: final params differ from the clean run's")
        out.update(preempt_at=DRILL_PREEMPT_AT, resumed_on=second.describe(),
                   preempt_bitwise=True, drill_bitwise=True)
        second.free()
        reference.free()
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
    return out


# fleet serving: examples/serve_fleet.py's scenario at full width.  The
# prompt window holds a prompt (<= 12) and every decoded token (<= 32), so
# no migrated request is truncated; the vocabulary is the model's.
FLEET_SPEC = dict(slots=4, max_len=128, prompt_len=64, chunk=8)
# the fleet's olmo-1b depth (16 as published): routing, failures and
# scaling do not depend on it, and phases 14 and 15 serve host-paced a
# layer a step (at full depth 152.4 s of a 1,244.7 s script on an NVIDIA
# H100 80GB HBM3, 700.00 W, behind a slow host)
FLEET_LAYERS = 4
FLEET_AUTOSCALE = dict(min_replicas=1, max_replicas=3, tick_s=0.05,
                       cooldown_s=0.3, scale_up_backlog=3.0,
                       scale_down_backlog=0.5, provision_s=0.1)
FLEET_TRAFFIC = dict(duration_s=4.0, rate_rps=4.0, pattern="bursty",
                     burst_x=10.0, burst_period_s=2.0, burst_len_s=0.5,
                     new_tokens_choices=(8, 16, 32),
                     new_tokens_weights=(0.5, 0.35, 0.15), prompt_len_max=12)
FLEET_FAIL = [(2.15, "spare"), (2.2, "busiest")]
FLEET_MEM_SLACK = 64 * 2 ** 20      # bytes: allocated after close vs before
# benchmarks/fleet_serving.py scenario_scaling's burst, measured timing
FLEET_MEASURED = dict(n=24, new_tokens=16, prompt_len=8)
# the prefix-affinity arm: kv_prefix's pooled spec on 2 replicas
FLEET_KV_SPEC = dict(slots=4, max_len=288, prompt_len=256, chunk=8,
                     kv_block=16, suffix_len=64)
FLEET_KV_TRAFFIC = dict(duration_s=2.0, rate_rps=8.0, header_len=224,
                        new_tokens_choices=(16, 32),
                        new_tokens_weights=(0.5, 0.5))
FLEET_KV_REQUESTS = 16          # at most: the trace of seed 0 holds 10
# mixed tenancy: examples/mixed_cluster.py's scenario; the trainer is the
# drill's (full width, 2 layers, train_2k).  16 steps: 12 on 3 blocks, the
# serving burst evicts it at t = 1.0, it resumes on 1 block at t = 1.5
MIX_TRAFFIC = dict(duration_s=4.0, rate_rps=14.0, pattern="diurnal",
                   trough_frac=0.1, diurnal_period_s=4.0,
                   new_tokens_choices=(16, 32), new_tokens_weights=(0.5, 0.5),
                   prompt_len_max=8)
MIX_GEOMETRIES = ((4, 4, 12), (4, 4, 8), (4, 4, 4))
MIX_TARGET_STEPS = 16


def _mem(torch, dev):
    """Allocated bytes on ``dev`` (0 on the CPU, where nothing counts)."""
    if torch.device(dev).type != "cuda":
        return 0
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def _sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _conserved(reqs, completed, dropped, offered, what):
    """Every request done with its full budget or reported dropped."""
    check(completed + dropped == offered == len(reqs),
          f"{what}: {completed} done + {dropped} dropped of {offered} "
          f"offered, {len(reqs)} requests")
    for r in reqs:
        check(r.status in ("done", "dropped")
              and (r.status != "done"
                   or len(r.out_tokens) == r.max_new_tokens),
              f"{what}: request {r.fid} is {r.status} with "
              f"{len(r.out_tokens)} of {r.max_new_tokens} tokens")


def _solo_margin(torch, np, cfg, api, params, spec, prompt, tokens, i, dev):
    """Top-2 logit margin and the bf16 tolerance where the solo stream
    ``tokens`` chose token ``i``: the prompt left-padded to the engine's
    window, then ``tokens[:i]``, through one prefill."""
    ctx = np.zeros((spec.prompt_len,), np.int64)
    seq = np.asarray(prompt)[-spec.prompt_len:]
    ctx[-len(seq):] = seq
    ctx = np.concatenate([ctx, np.asarray(tokens[:i], np.int64)])
    logits, _ = api.prefill(cfg, params,
                            {"tokens": torch.as_tensor(ctx[None], device=dev)})
    top = torch.topk(logits[0].float(), 2).values
    return (float(top[0] - top[1]),
            LOGIT_REL_TOL * float(logits.float().abs().max()))


def fleet_kernel_cases(torch, DA, FA, REF, dev="cuda"):
    """Rows 1 and 2 against their plain versions at the shapes the fleet
    gives them: a replica's decode (4 slots, H = KH = 16, d = 128, S =
    max_len 128; ragged lengths with 0 and S), the pooled arm's gathered
    view (S = 288) and the admission and migration prefill (4 rows of T =
    prompt_len 64).  Returns the worst error of each."""
    gen = torch.Generator(device=dev).manual_seed(3)
    bf = torch.bfloat16
    B, H, KH, d = FLEET_SPEC["slots"], 16, 16, 128

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    err_d = 0.0
    for S, lens in ((FLEET_SPEC["max_len"], [0, 1, 65, 128]),
                    (FLEET_SPEC["max_len"], [64, 77, 100, 127]),
                    (FLEET_KV_SPEC["max_len"], [0, 240, 257, 288])):
        a = (randn(B, H, d), randn(B, S, KH, d), randn(B, S, KH, d),
             torch.tensor(lens, dtype=torch.int32, device=dev))
        err_d = max(err_d, max_err(torch, DA.paged_decode_attention(*a),
                                   REF.paged_decode_attention_ref(*a),
                                   f"decode at the fleet's B{B} S{S} {lens}"))
    T = FLEET_SPEC["prompt_len"]
    a = (randn(B, H, T, d), randn(B, KH, T, d), randn(B, KH, T, d))
    err_p = max_err(torch, FA.flash_attention(*a),
                    REF.flash_attention_ref(*a),
                    f"prefill at the fleet's B{B} T{T}")
    return {"paged_decode_attention": err_d, "flash_attention": err_p}


def fleet_phase(torch, np, cfg, api, CL, FLT, engine_mod, DA, FA, REF,
                dev="cuda"):
    """``examples/serve_fleet.py``'s scenario at full width through
    ``repro_torch.fleet``: an autoscaled ``least_eta`` fleet of up to 3
    replicas on a 3-block machine, a bursty trace, a spare burnt and the
    busiest replica's block failed, the rows of the decode and prefill
    kernels counted.  Every request is accounted for, scale-up, drain and
    scale-down happen, migrated requests are not truncated, every stream
    equals its prompt served alone (a difference only at a near tie), and
    allocated memory after ``close()`` is what it was before.  Then the
    measured arm (1 and 2 replicas, wall-clock chunks) and the
    prefix-affinity arm (2 pooled replicas; hits, no block leaked).

    The weights are the serve phase's (seed 0), handed to the service on
    the host: it moves them to the card once and every replica shares
    that tree.  Returns the phase's figures, the launches of rows 1 and 2
    on its path, and the tree on the card."""
    out = {}
    t_phase = time.perf_counter()
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        out["max_abs_err_at_fleet_shapes"] = fleet_kernel_cases(
            torch, DA, FA, REF, dev)
    host = _to(api.init_params(cfg, seed=0, device=dev), "cpu")
    mem0 = _mem(torch, dev)
    sc = CL.Supercomputer(num_blocks=3, device=dev)
    spec = engine_mod.SliceSpec(**FLEET_SPEC)
    svc = FLT.FleetService(
        sc, cfg, host, spec, geometry=(4, 4, 4),
        router=FLT.RouterConfig(policy="least_eta"),
        autoscale=FLT.AutoscalerConfig(**FLEET_AUTOSCALE), timing=0.05)
    params = svc.params
    moved = list(_leaves(params))
    check(all(t.device.type == sc.device.type for t in moved)
          and (not on_card or not any(
              a is b for a, b in zip(moved, _leaves(host)))),
          "fleet: the service did not move the host tree to its device")
    param_bytes = sum(t.numel() * t.element_size() for t in moved)
    del host, moved
    mem_built = _mem(torch, dev)

    def one_tree(where):
        check(all(r.session.engine.params is params for r in svc.replicas
                  if r.session is not None),
              f"fleet: a replica holds a weight tree of its own ({where})")

    one_tree("built")
    trace = FLT.generate(FLT.TrafficSpec(**FLEET_TRAFFIC,
                                         vocab_size=cfg.vocab_size), seed=2)
    _sync(torch, dev)
    DA.launches = FA.launches = 0
    t0 = time.perf_counter()
    rep = svc.run(trace, fail_plan=FLEET_FAIL, settle_s=3.0)
    _sync(torch, dev)
    out["wall_s"] = time.perf_counter() - t0
    launches = {"paged_decode_attention": DA.launches,
                "flash_attention": FA.launches}
    one_tree("after the run")
    _conserved(trace, rep.completed, rep.dropped, rep.offered, "fleet")
    drained = [ln for ln in rep.log if "(drained)" in ln]
    check(rep.scale_ups >= 1 and rep.scale_downs >= 1 and drained,
          f"fleet: {rep.scale_ups} scale-ups, {rep.scale_downs} "
          f"scale-downs, {len(drained)} drained replicas freed")
    check(rep.migrated >= 1 and rep.failures >= 1,
          f"fleet: {rep.migrated} migrated, {rep.failures} failures")
    check(all(s["truncated_migrations"] == 0 for s in rep.replica_stats),
          f"fleet: truncated migrations {rep.replica_stats}")
    out["report"] = rep.to_dict()
    out["chunks_run"] = {s["rep_id"]: s["chunks_run"]
                         for s in rep.replica_stats}
    out["log"] = rep.log
    mem_run = _mem(torch, dev)
    svc.close()
    mem1 = _mem(torch, dev)
    # the moved tree stays (the solo runs and the other arms use it)
    out["mem_gb"] = {"before_service": mem0 / 1e9,
                     "service_built": mem_built / 1e9,
                     "weights": param_bytes / 1e9, "after_run": mem_run / 1e9,
                     "after_close": mem1 / 1e9}
    check(abs(mem1 - mem0 - (param_bytes if on_card else 0))
          <= FLEET_MEM_SLACK,
          f"fleet: allocated {mem1 / 1e9:.4f} GB after close(), "
          f"{mem0 / 1e9:.4f} GB before the service and "
          f"{param_bytes / 1e9:.4f} GB of weights it moved")
    # every stream against its prompt served alone by one engine
    solo = engine_mod.ServeEngine(cfg, params, spec, device=dev)
    t0 = time.perf_counter()
    differ = []
    for r in trace:
        if r.status != "done":
            continue
        er = solo.submit(r.prompt, max_new_tokens=r.max_new_tokens)
        solo.run()
        got, want = list(r.out_tokens), list(er.out_tokens)
        if got == want:
            continue
        i = next(k for k, (a, b) in enumerate(zip(got, want)) if a != b)
        margin, tol = _solo_margin(torch, np, cfg, api, params, spec,
                                   r.prompt, want, i, dev)
        differ.append({"fid": r.fid, "migrations": r.migrations, "at": i,
                       "fleet": got[i], "solo": want[i], "margin": margin,
                       "tol": tol})
        log(f"fleet: request {r.fid} ({r.migrations} migrations) parts "
            f"from its solo stream at token {i}: top-2 margin "
            f"{margin:.4f}, tolerance {tol:.4f}")
        check(margin < tol, f"fleet: request {r.fid} differs from its solo "
                            f"run at token {i}, margin {margin} >= {tol}")
    del solo
    out["solo_s"] = time.perf_counter() - t0
    out["streams_differing"] = differ
    out["launches"] = launches
    if torch.device(dev).type == "cuda":
        check(launches["paged_decode_attention"] > 0
              and launches["flash_attention"] > 0,
              f"fleet: kernels not launched on the path: {launches}")
    # measured arm: wall-clock chunks, 1 then 2 replicas (one card takes
    # the replicas in turns: the 2-replica figure models separate slices)
    measured = {}
    for n in (1, 2):
        sc_m = CL.Supercomputer(num_blocks=3, device=dev)
        svc_m = FLT.FleetService(sc_m, cfg, params, spec, geometry=(4, 4, 4),
                                 initial_replicas=n, timing="measured")
        svc_m.warmup()
        burst = FLT.uniform_burst(FLEET_MEASURED["n"],
                                  new_tokens=FLEET_MEASURED["new_tokens"],
                                  prompt_len=FLEET_MEASURED["prompt_len"])
        t0 = time.perf_counter()
        rm = svc_m.run(burst)
        wall = time.perf_counter() - t0
        _conserved(burst, rm.completed, rm.dropped, rm.offered,
                   f"measured arm, {n} replicas")
        measured[n] = {"aggregate_tokens_per_s": rm.aggregate_tokens_per_s,
                       "p50_ttft_s": rm.p50_ttft_s,
                       "p95_ttft_s": rm.p95_ttft_s,
                       "makespan_s": rm.makespan_s, "wall_s": wall}
        svc_m.close()
    out["measured"] = measured
    # prefix affinity on 2 pooled replicas
    sc_p = CL.Supercomputer(num_blocks=3, device=dev)
    svc_p = FLT.FleetService(
        sc_p, cfg, params, engine_mod.SliceSpec(**FLEET_KV_SPEC),
        geometry=(4, 4, 4), initial_replicas=2,
        router=FLT.RouterConfig(policy="prefix_affinity"), timing=0.05)
    kv_trace = FLT.generate(FLT.TrafficSpec(**FLEET_KV_TRAFFIC,
                                            vocab_size=cfg.vocab_size),
                            seed=0)[:FLEET_KV_REQUESTS]
    t0 = time.perf_counter()
    rp = svc_p.run(kv_trace)
    wall = time.perf_counter() - t0
    _conserved(kv_trace, rp.completed, rp.dropped, rp.offered,
               "prefix-affinity arm")
    kv = {}
    for r in svc_p.replicas:
        eng = r.session.engine
        eng.kvpool.check()
        stats = eng.kv_stats()
        eng.kv_close()                      # asserts every block came back
        kv[r.rep_id] = dict(stats, leaked=eng.kvpool.stats()[
            "allocated_blocks"])
    check(svc_p.router.prefix_hits > 0
          and all(v["leaked"] == 0 for v in kv.values()),
          f"prefix-affinity arm: {svc_p.router.prefix_hits} hits, kv {kv}")
    out["prefix_affinity"] = {"report": rp.to_dict(), "wall_s": wall,
                              "prefix_hits": svc_p.router.prefix_hits,
                              "prefix_misses": svc_p.router.prefix_misses,
                              "kv": kv}
    svc_p.close()
    out["phase_s"] = time.perf_counter() - t_phase
    return out, launches, params


@contextlib.contextmanager
def _timing(torch, dev, into, patches):
    """While the block runs, count the calls of each ``(cls, name,
    label)`` in ``patches`` and add up their wall seconds (the card synced
    after each) under ``into[label(self)]``; the methods are restored
    after."""
    saved = []
    for cls, name, label in patches:
        real = vars(cls)[name]

        def timed(self, *a, _real=real, _label=label, **kw):
            t0 = time.perf_counter()
            try:
                return _real(self, *a, **kw)
            finally:
                _sync(torch, dev)
                rec = into.setdefault(_label(self), {"calls": 0, "s": 0.0})
                rec["calls"] += 1
                rec["s"] += time.perf_counter() - t0
        saved.append((cls, name, real))
        setattr(cls, name, timed)
    try:
        yield into
    finally:
        for cls, name, real in saved:
            setattr(cls, name, real)


def tenancy_phase(torch, np, cfg, run, params, api, CL, FLT, Trainer, OPT,
                  engine_mod, DA, FA, dev="cuda"):
    """``examples/mixed_cluster.py``'s scenario: a priority-1 fleet of
    full-width olmo-1b (``params``, on the card; timing 0.15,
    ``preempt_on_allocate``) and an elastic training tenant (``run``: the
    drill's 2-layer cut) on a 4-block machine under a diurnal trace.  The
    serving burst evicts the trainer, which frees its state and resumes
    at the trough; its losses and final params are the uninterrupted
    run's, bit for bit, and every request is accounted for.  The wall
    time is split by measurement: the training quanta, the checkpoint
    saves (inside a quantum or not) and restores, and the replicas'
    chunks and dispatches."""
    import shutil
    import tempfile
    out = {}
    t_phase = time.perf_counter()

    class Probed(CL.ElasticTrainJob):
        """Records allocated memory around each eviction, the bytes of
        the state the job held (params, m and v), and the wall seconds of
        its quanta."""
        evictions = []
        quanta_s = 0.0
        in_quantum = False

        def run_quantum(self, window_s, now=0.0):
            t0 = time.perf_counter()
            Probed.in_quantum = True
            try:
                n = super().run_quantum(window_s, now)
            finally:
                Probed.in_quantum = False
            _sync(torch, dev)
            Probed.quanta_s += time.perf_counter() - t0
            return n

        def _vacate(self, *, save, reason):
            st = self.session.state if self.session is not None else None
            held = 0 if st is None else sum(
                t.numel() * t.element_size() for t in _leaves(
                    [st.params, st.opt_state.mu, st.opt_state.nu]))
            del st
            before = _mem(torch, dev)
            super()._vacate(save=save, reason=reason)
            after = _mem(torch, dev)
            self.evictions.append({"state_gb": held / 1e9,
                                   "before_gb": before / 1e9,
                                   "after_gb": after / 1e9,
                                   "held": held, "freed": before - after})

    def on_machine_event(sl, ev):
        # published once the eviction's notification has returned, before
        # the requester's allocation does
        if ev.kind == "preempt" and Probed.evictions \
                and "published_gb" not in Probed.evictions[-1]:
            e = Probed.evictions[-1]
            now = _mem(torch, dev)
            e["published_gb"] = now / 1e9
            e["freed_published"] = e["before_gb"] * 1e9 - now

    sc = CL.Supercomputer(num_blocks=4, device=dev)
    svc = FLT.FleetService(
        sc, cfg, params, engine_mod.SliceSpec(**FLEET_SPEC),
        geometry=(4, 4, 4), initial_replicas=1, timing=0.15,
        autoscale=FLT.AutoscalerConfig(**FLEET_AUTOSCALE), priority=1,
        preempt_on_allocate=True)
    check(all(a is b for a, b in zip(_leaves(svc.params), _leaves(params))),
          "tenancy: the service copied weights already on its device")
    sc.subscribe(on_machine_event)
    ckpt = tempfile.mkdtemp(prefix="tenant_")
    replica = FLT.ServeReplica
    timed = {}
    try:
        job = Probed(sc, CL.TrainTenantSpec(
            run=run, target_steps=MIX_TARGET_STEPS, ckpt_dir=ckpt,
            geometries=MIX_GEOMETRIES, priority=0, base_step_s=0.25))
        check(job.try_start(0.0), "tenancy: the trainer did not start")
        trace = FLT.generate(FLT.TrafficSpec(**MIX_TRAFFIC,
                                             vocab_size=cfg.vocab_size),
                             seed=5)
        drv = CL.MixedTenancyDriver(svc, job, window_s=0.5)
        _sync(torch, dev)
        DA.launches = FA.launches = 0
        t0 = time.perf_counter()
        with _timing(torch, dev, timed, [
                (Trainer, "save", lambda _: "save_in_quantum"
                 if Probed.in_quantum else "save_outside_quanta"),
                (Trainer, "restore", lambda _: "restore"),
                (replica, "step", lambda _: "serve_chunks"),
                (replica, "dispatch", lambda _: "serve_dispatch")]):
            rep = drv.run(trace, extra_windows=6)
        _sync(torch, dev)
        out["wall_s"] = time.perf_counter() - t0
        launches = {"paged_decode_attention": DA.launches,
                    "flash_attention": FA.launches}
        svc.close()
        out["chunks_run"] = {r.rep_id: r.stats()["chunks_run"]
                             for r in svc.retired}
        # disjoint parts of the wall: a quantum holds its restore, its
        # steps and the saves made inside it
        out["split_s"] = dict(
            {k: v["s"] for k, v in timed.items()},
            train_quanta=Probed.quanta_s,
            rest=out["wall_s"] - Probed.quanta_s - sum(
                timed.get(k, {"s": 0.0})["s"] for k in (
                    "save_outside_quanta", "serve_chunks",
                    "serve_dispatch")))
        out["calls"] = {k: v["calls"] for k, v in timed.items()}
        served = rep.serve
        _conserved(trace, served["completed"], served["dropped"],
                   served["offered"], "tenancy")
        check(rep.train_preemptions >= 1 and rep.train_resumes >= 1
              and rep.train_steps == MIX_TARGET_STEPS,
              f"tenancy: {rep.train_preemptions} preemptions, "
              f"{rep.train_resumes} resumes, {rep.train_steps} steps")
        if torch.device(dev).type == "cuda":
            check(Probed.evictions and all(
                e["freed"] >= e["held"] and e["freed_published"] >= e["held"]
                for e in Probed.evictions),
                  f"tenancy: an eviction freed less than the trainer's "
                  f"state: {Probed.evictions}")
            check(launches["paged_decode_attention"] > 0
                  and launches["flash_attention"] > 0,
                  f"tenancy: kernels not launched on the path: {launches}")
        # the tenant's loss curve, from every train.metrics series
        curve = {}
        for kind, name, _, series in sc.obs.metrics.items():
            if kind == "series" and name == "train.metrics":
                curve.update({m["step"]: m["loss"] for m in series.samples
                              if "loss" in m})
        final = Trainer(run, device=dev, ckpt_dir=ckpt).restore()
        t0 = time.perf_counter()
        clean_tr = Trainer(run, device=dev)
        clean = clean_tr.train(MIX_TARGET_STEPS, log_every=1)
        _sync(torch, dev)
        out["clean_run_s"] = time.perf_counter() - t0
        want = {m["step"]: m["loss"] for m in clean_tr.metrics_log
                if "loss" in m}
        check(curve == want and len(want) == MIX_TARGET_STEPS,
              f"tenancy: tenant losses {curve} differ from the "
              f"uninterrupted run's {want}")
        check(final.step == MIX_TARGET_STEPS and all(
            torch.equal(a, b) for a, b in zip(
                OPT.leaves([final.params, final.opt_state.mu,
                            final.opt_state.nu]),
                OPT.leaves([clean.params, clean.opt_state.mu,
                            clean.opt_state.nu]))),
              "tenancy: the tenant's final params differ from the "
              "uninterrupted run's")
        out.update(report=rep.to_dict(), evictions=Probed.evictions,
                   losses=[want[s] for s in sorted(want)], bitwise=True,
                   launches=launches, job_log=job.log)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    return out, launches


# the MoE family: full-width qwen3-moe-30b-a3b served on one card (61.06
# GB of bf16 weights) at the serve phase's envelope and trace shape
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_REDUCED = ("qwen3-moe-30b-a3b", "kimi-k2-1t-a32b")
MOE_EMPTY_LIMIT = 3e9           # allocated bytes when the phase starts
MOE_PEAK_LIMIT = 72e9
MOE_UNIFORM = dict(n=8, new_tokens=16)   # the chunk-invariance trace
# router near tie: the k-th and (k+1)-th router logits of a token within
# this share of its largest |logit| (8 bf16 ulps), as the CPU tests
ROUTE_REL_TOL = 2.0 ** -5


def gqa8_kernel_phase(torch, F, DA, FA, REF, dev="cuda"):
    """Rows 1 and 2 at qwen3-moe's attention shapes (H = 32 query heads
    over KH = 4 KV heads, d = 128): decode at B = 8, S = 1024 with the
    decode phase's mixed lengths, prefill at T = S = 128 for a wave of 1
    and of 8.  Each is held against its plain version and timed in turns
    with SDPA (``enable_gqa``; a yardstick only), beside its plain version
    and its bound."""
    gen = torch.Generator(device=dev).manual_seed(25)
    bf = torch.bfloat16
    H, KH, d = 32, 4, 128

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    out = {}
    B, S = 8, 1024
    lens = [0, 1, 100, 257, 512, 700, 1000, 1024]
    sets = [(randn(B, H, d), randn(B, S, KH, d), randn(B, S, KH, d),
             torch.tensor(lens, dtype=torch.int32, device=dev))
            for _ in range(3)]                           # 3 x 17 MB
    err = max_err(torch, DA.paged_decode_attention(*sets[0]),
                  REF.paged_decode_attention_ref(*sets[0]),
                  f"decode at qwen3-moe's B{B} H{H} KH{KH} S{S}")
    kpos = torch.arange(S, device=dev)
    masks = [(kpos[None, :] < s[3][:, None].long())[:, None, None, :]
             for s in sets]

    def sdpa_decode(i):
        q, k, v, _ = sets[i]
        return F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=masks[i], enable_gqa=True)

    mean, turns = in_turns(torch, {
        "kernel": lambda i: DA.paged_decode_attention(*sets[i]),
        "library": sdpa_decode}, 3)
    rows = sum(lens)
    bound_ms, bound_by = bound(2 * B * H * d * 2 + 2 * rows * KH * d * 2
                               + B * 4, 4 * rows * H * d)
    out["paged_decode_attention"] = dict(
        shape=[B, H, KH, S, d], max_abs_err=err, ms=mean["kernel"],
        plain_ms=cuda_ms(torch,
                         lambda i: REF.paged_decode_attention_ref(*sets[i]),
                         3),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=mean["library"],
        ms_turns=turns)
    T = 128
    for B in (1, 8):
        sets = [(randn(B, H, T, d), randn(B, KH, T, d), randn(B, KH, T, d))
                for _ in range(8)]
        err = max_err(torch, FA.flash_attention(*sets[0]),
                      REF.flash_attention_ref(*sets[0]),
                      f"prefill at qwen3-moe's B{B} H{H} KH{KH} T{T}")
        mean, turns = in_turns(torch, {
            "kernel": lambda i: FA.flash_attention(*sets[i]),
            "library": lambda i: F.scaled_dot_product_attention(
                *sets[i], is_causal=True, enable_gqa=True)}, 8)
        bound_ms, bound_by = bound(
            (2 * B * H * T * d + 2 * B * KH * T * d) * 2,
            4 * B * H * d * (T * (T + 1) // 2))
        out[f"flash_attention_B{B}"] = dict(
            shape=[B, H, KH, T, d], max_abs_err=err, ms=mean["kernel"],
            plain_ms=cuda_ms(torch,
                             lambda i: REF.flash_attention_ref(*sets[i]), 8),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=mean["library"],
            ms_turns=turns)
    return out


def _kept_sets(np, e, capacity):
    """Each token's experts after capacity, sorted, a dropped pair as -1:
    the sorted dispatch's rule (an expert keeps its first ``capacity``
    pairs in the stable order of the flattened ids), in numpy."""
    flat = e.reshape(-1)
    order = np.argsort(flat, kind="stable")
    srt = flat[order]
    pos = np.empty_like(flat)
    pos[order] = np.arange(flat.size) - np.searchsorted(srt, srt)
    return np.sort(np.where((pos < capacity).reshape(e.shape), e, -1), 1)


@contextlib.contextmanager
def route_log(np, MOE):
    """Record every MoE call of the port while inside: per call, each
    token's expert ids (as the router ranked them), its chosen experts
    (sorted), its kept experts, and the margin between its k-th and
    (k+1)-th router logits with that margin's bar."""
    calls = []
    topk, dispatch = MOE.router_topk, MOE._dispatch_sorted

    def rec_topk(cfg, p, x, dtype):
        g, e, a = topk(cfg, p, x, dtype)
        lg = MOE._mm(x, p["router"], dtype).float().detach()
        if cfg.moe.router_softcap:
            c = cfg.moe.router_softcap
            lg = c * lg.div(c).tanh()
        srt = lg.sort(dim=1, descending=True).values.cpu().numpy()
        k = cfg.moe.top_k
        calls.append(dict(ids=e.cpu().numpy(),
                          chosen=np.sort(e.cpu().numpy(), 1),
                          margin=srt[:, k - 1] - srt[:, k],
                          bar=ROUTE_REL_TOL * np.abs(srt).max(1)))
        return g, e, a

    def rec_dispatch(x, gates, eidx, num_experts, capacity):
        calls[-1]["kept"] = _kept_sets(np, eidx.cpu().numpy(), capacity)
        return dispatch(x, gates, eidx, num_experts, capacity)

    MOE.router_topk, MOE._dispatch_sorted = rec_topk, rec_dispatch
    try:
        yield calls
    finally:
        MOE.router_topk, MOE._dispatch_sorted = topk, dispatch


NEVER = 1 << 30


def route_splits(np, want, got, what, rows, T, first=None):
    """Two runs' MoE calls on the same (rows, T) tokens: per row, the first
    position touched by a routing split, or NEVER (``first`` carries the
    rows' state in from earlier calls, e.g. a prefill before decode
    steps).  A token splits where it chose or kept other experts.  Fails
    unless each token that CHOSE differently while untouched (no split at
    or before its position in its row in an earlier call: causal
    attention carries a change only forward in a row) is a near tie of
    ``want``'s router logits; a kept set that differs alone lost a
    capacity slot to such a choice in the same call."""
    check(len(want) == len(got), f"{what}: {len(want)} vs {len(got)} calls")
    first = np.full((rows,), NEVER) if first is None else first.copy()
    pos = np.arange(T)
    for c, (w, g) in enumerate(zip(want, got)):
        touched = (pos[None, :] >= first[:, None]).reshape(-1)
        chose = (w["chosen"] != g["chosen"]).any(1)
        for t in np.nonzero(chose & ~touched)[0]:
            check(w["margin"][t] < w["bar"][t],
                  f"{what}: MoE call {c}, token {t} chose experts "
                  f"{g['chosen'][t].tolist()} for {w['chosen'][t].tolist()}"
                  f" at a margin {w['margin'][t]:.4f} >= {w['bar'][t]:.4f}")
        m = (chose | (w["kept"] != g["kept"]).any(1)).reshape(rows, T)
        first = np.minimum(first, np.where(m.any(1), m.argmax(1), NEVER))
    return first


def moe_reference_phase(torch, np, registry, api, TF, MOE, dev="cuda"):
    """Reduced qwen3-moe and kimi-k2 (a shared expert and a dense prefix)
    with the same weights on the CPU (plain attention, CPU matmuls) and on
    the card (rows 1 and 2, cuBLAS): prefill logits within LOGIT_REL_TOL,
    then 12 greedy ``decode_step_paged`` steps whose tokens agree.  Every
    MoE call is recorded on both: a token may choose other experts only at
    a near tie of the CPU run's router logits (`route_splits`); a row
    (lane) is compared up to its first token touched by one, and a stream
    up to a near tie of its CPU logits.  Returns each arch's worst error
    share, the rows split and the tokens compared."""
    out = {}
    for arch in MOE_REDUCED:
        cfg = registry.get_reduced(arch)
        p_cpu = api.init_params(cfg, seed=0, device="cpu")
        p_gpu = _to(p_cpu, dev)
        B, T, steps = 8, 16, 12
        toks = torch.randint(0, cfg.vocab_size, (B, T),
                             generator=torch.Generator().manual_seed(0))
        runs = {}
        for name, p, d in (("cpu", p_cpu, "cpu"), ("gpu", p_gpu, dev)):
            with route_log(np, MOE) as pre:
                logits, cache = api.prefill(cfg, p, {"tokens": toks.to(d)},
                                            max_len=T + steps)
            lens = torch.full((B,), T, dtype=torch.int32, device=d)
            active = torch.ones((B,), dtype=torch.bool, device=d)
            tk = logits.argmax(-1).to(torch.int32)
            out_toks, step_logs, step_logits = [tk.cpu()], [], [logits]
            for _ in range(steps):
                with route_log(np, MOE) as log_:
                    lg, cache, lens = TF.decode_step_paged(cfg, p, cache, tk,
                                                           lens, active)
                tk = lg.argmax(-1).to(torch.int32)
                out_toks.append(tk.cpu())
                step_logs.append(log_)
                step_logits.append(lg)
            runs[name] = dict(pre=pre, steps=step_logs,
                              toks=torch.stack(out_toks, 1).numpy(),
                              logits=[x.float().cpu() for x in step_logits])
        c, g = runs["cpu"], runs["gpu"]
        first = route_splits(np, c["pre"], g["pre"], f"{arch} prefill", B, T)
        live = first == NEVER
        worst, compared = 0.0, 0
        for s in range(steps + 1):
            if s:
                first = route_splits(np, c["steps"][s - 1],
                                     g["steps"][s - 1], f"{arch} step {s}",
                                     B, 1, np.where(live, NEVER, 0))
                live &= first == NEVER
            lc, lg = c["logits"][s], g["logits"][s]
            check(bool(torch.isfinite(lg).all()), f"{arch} step {s}: "
                                                  f"not finite")
            tol = LOGIT_REL_TOL * lc.abs().max().item()
            for b in np.nonzero(live)[0]:
                err = (lc[b] - lg[b]).abs().max().item()
                check(err <= tol, f"{arch} step {s} row {b}: card vs CPU "
                                  f"logits differ by {err:.4f} > {tol:.4f}")
                worst = max(worst, err / tol)
                top = lc[b].topk(2).values
                if c["toks"][b, s] != g["toks"][b, s]:
                    check(float(top[0] - top[1]) < tol,
                          f"{arch} step {s} row {b}: tokens "
                          f"{c['toks'][b, s]} vs {g['toks'][b, s]} at a "
                          f"CPU top-2 margin {float(top[0] - top[1]):.4f}")
                    live[b] = False
                else:
                    compared += 1
        out[arch] = dict(worst_share_of_tol=worst,
                         rows_split=int((~live).sum()),
                         tokens_compared=compared, tokens=B * (steps + 1))
    return out


def moe_serve_phase(torch, np, cfg, api, engine_mod, DA, FA, MOE,
                    dev="cuda"):
    """Full-width qwen3-moe-30b-a3b (48 layers, 128 experts, top 8, bf16
    weights from seed 0) in ``ServeEngine(SliceSpec(slots=8, max_len=1024,
    prompt_len=128, chunk=8))`` on the serve phase's trace shape (16
    requests of 32-128 prompt tokens, 128 new tokens each, ids below the
    vocabulary of 151936), counted: rows 1 and 2 launched, every request
    its budget, peak allocated < MOE_PEAK_LIMIT.  Then 8 requests of 16
    tokens (uniform budgets) at chunk 8 and chunk 1: the same tokens bit
    for bit, and the dropped fraction of each MoE call (prefill, decode);
    then a profile of one decode chunk (the card's idle share)."""
    check(torch.cuda.memory_allocated() < MOE_EMPTY_LIMIT,
          f"{torch.cuda.memory_allocated()} bytes allocated before the MoE "
          f"phase")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(t.numel() for t in _leaves(params))
    weight_gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    spec = engine_mod.SliceSpec(**SERVE_SPEC)
    warm_prompt, prompts = serve_trace(np, cfg.vocab_size)
    warm = engine_mod.ServeEngine(cfg, params, spec, device=dev)
    warm.submit(warm_prompt, max_new_tokens=9)
    warm.run()
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng, reqs, stats, launches = _engine_run(
        torch, engine_mod, cfg, params, spec, prompts, SERVE_NEW_TOKENS, DA,
        FA, dev)
    stats["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del eng, reqs
    check(stats["peak_mem_gb"] * 1e9 < MOE_PEAK_LIMIT,
          f"peak {stats['peak_mem_gb']:.2f} GB over {MOE_PEAK_LIMIT / 1e9}")
    waves = math.ceil(len(prompts) / spec.slots)
    check(launches["paged_decode_attention"]
          >= cfg.num_layers * stats["decode_steps"]
          and launches["flash_attention"] >= cfg.num_layers * waves,
          f"MoE serving launches {launches} for {stats['decode_steps']} "
          f"steps and {waves} waves x {cfg.num_layers} layers")
    stats.update(init_s=init_s, init_peak_gb=init_peak, params=n_params,
                 weight_gb=weight_gb, launches=launches,
                 ms_decode_step=stats["p50_chunk_s"] / spec.chunk * 1e3)
    # chunk invariance on a uniform-budget trace; the dropped fractions
    n, new = MOE_UNIFORM["n"], MOE_UNIFORM["new_tokens"]
    streams = {}
    for chunk in (8, 1):
        uspec = engine_mod.SliceSpec(**{**SERVE_SPEC, "chunk": chunk})
        drops = {"prefill": [], "decode": []}
        ep, dec = MOE.moe_ep, MOE.moe_decode

        def keep(name, fn):
            def wrapped(*a, **kw):
                out = fn(*a, **kw)
                drops[name].append(out[2])
                return out
            return wrapped

        MOE.moe_ep, MOE.moe_decode = keep("prefill", ep), keep("decode", dec)
        try:
            _, ureqs, _, _ = _engine_run(torch, engine_mod, cfg, params,
                                         uspec, prompts[:n], new, DA, FA,
                                         dev)
        finally:
            MOE.moe_ep, MOE.moe_decode = ep, dec
        streams[chunk] = [list(r.out_tokens) for r in ureqs]
        if chunk == 8:
            stats["dropped_prefill"] = float(torch.stack(
                drops["prefill"]).mean())
            stats["dropped_decode"] = float(torch.stack(
                drops["decode"]).mean())
            stats["dropped_prefill_by_layer"] = [float(d) for d in
                                                 drops["prefill"]]
            stats["moe_calls"] = {k: len(v) for k, v in drops.items()}
    check(streams[8] == streams[1],
          "qwen3-moe: chunk 8 and chunk 1 served different tokens")
    stats["chunk_invariant_bitwise"] = True
    # full-width logits are finite and of the expected shape
    toks = torch.as_tensor(np.stack([p[-64:] for p in prompts[:2]]),
                           device=dev).long()
    logits, _ = api.prefill(cfg, params, {"tokens": toks})
    check(tuple(logits.shape) == (2, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"full-width prefill logits {tuple(logits.shape)} not finite")
    stats["profile"] = profile_chunk(torch, np, cfg, params, engine_mod, spec)
    del params
    return stats, launches


def moe_phase(torch, np, F, registry, api, engine_mod, DA, FA, REF, MOE, TF,
              dev="cuda"):
    """Phase 16: the MoE family.  Rows 1 and 2 at qwen3-moe's shapes, the
    reduced MoE archs card vs CPU, then full-width qwen3-moe served."""
    t_phase = time.perf_counter()
    kernels = gqa8_kernel_phase(torch, F, DA, FA, REF, dev)
    gc.collect()
    torch.cuda.empty_cache()
    reference = moe_reference_phase(torch, np, registry, api, TF, MOE, dev)
    gc.collect()
    torch.cuda.empty_cache()
    serve, launches = moe_serve_phase(
        torch, np, registry.get_config(MOE_ARCH), api, engine_mod, DA, FA,
        MOE, dev)
    out = dict(kernels=kernels, reference=reference, serve=serve,
               phase_s=time.perf_counter() - t_phase)
    return out, launches


# MoE training: full-width qwen3-moe-30b-a3b cut in depth to 4 layers
# (3,114,813,440 f32 parameters; params, gradient, m and v 49.8 GB) on
# the dense training cell (train_2k: 8 microbatches of 1 x 2048, remat,
# xent chunks of 256, Adam at lr 3e-4)
MOE_TRAIN_LAYERS = 4
MOE_TRAIN_PARAMS = 3_114_813_440
MOE_TRAIN_MICROBATCHES = 8
MOE_TRAIN_PEAK_LIMIT = 72e9
# the reduced archs card vs CPU, and the preempt/resume on the card
MOE_SMALL_SHAPE = ("moe_check", "train", 32, 4)
MOE_PREEMPT_STEPS, MOE_PREEMPT_AT = 6, 3


def replayed_router(torch, F, MOE, cfg, p, x, dtype, eidx):
    """``MOE.router_topk`` with the expert ids ``eidx`` given: gates and
    aux from this run's own probabilities."""
    m = cfg.moe
    logits = MOE._mm(x, p["router"], dtype).float()
    if m.router_softcap:
        logits = m.router_softcap * torch.tanh(logits / m.router_softcap)
    probs = torch.softmax(logits, dim=-1)
    gates = probs.gather(1, eidx)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    ce = F.one_hot(eidx[:, 0], m.num_experts).float().mean(dim=0)
    return gates, eidx, m.num_experts * torch.sum(probs.mean(dim=0) * ce)


@contextlib.contextmanager
def route_replay(torch, F, MOE, calls):
    """Every MoE call inside takes the next recorded call's expert ids (a
    `route_log` list) instead of its own top-k."""
    todo, topk = iter(calls), MOE.router_topk

    def replay(cfg, p, x, dtype):
        ids = torch.from_numpy(next(todo)["ids"]).long().to(x.device)
        return replayed_router(torch, F, MOE, cfg, p, x, dtype, ids)

    MOE.router_topk = replay
    try:
        yield
    finally:
        MOE.router_topk = topk
    check(next(todo, None) is None, "route replay: a recorded call was not "
                                    "replayed")


def _grad_share(torch, got, want, what):
    """max |got - want| of each leaf over LOGIT_REL_TOL x its largest
    |want|; fails above 1 or where ``got`` is not finite.  Returns the
    worst share."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.detach().float().cpu(), b.detach().float().cpu()
        check(bool(torch.isfinite(a).all()), f"{what}: leaf {i} not finite")
        tol = LOGIT_REL_TOL * b.abs().max().item()
        err = (a - b).abs().max().item()
        check(err <= tol, f"{what}: leaf {i} differs by {err:.4g} > "
                          f"{tol:.4g}")
        worst = max(worst, err / tol if tol else 0.0)
    return worst


def _loss_near(a, b):
    return abs(a - b) <= 1e-3 + 2.0 ** -7 * abs(b)


def _state_on(OPT, state, device):
    def on(tree):
        return None if tree is None else OPT.tree_map(
            lambda t: t.clone().to(device), tree)
    return OPT.OptState(state.step, on(state.mu), on(state.nu))


def _optimizer_steps(torch, np, F, cfg, params, data, pcfg, ocfg, STEPS, OPT,
                     MOE, what, dev):
    """2 steps of ``ocfg`` from the same f32 params on the CPU and on the
    card, each step's routes the CPU's (replayed on the card): each step's
    loss within the curve bar and its gradients within LOGIT_REL_TOL;
    before each update, the card's ``OPT.apply`` on the CPU's gradients
    and state against the CPU's own, params and state within ADAM_RTOL
    (the same f32 operations, the norm summed in another order).  Returns
    the card's losses and the worst shares of each bar."""
    pc = OPT.tree_map(lambda t: t.clone(), params)
    pg = OPT.tree_map(lambda t: t.clone().to(dev), params)
    sc, sg = OPT.init(ocfg, pc), OPT.init(ocfg, pg)
    losses, g_worst, o_worst = [], 0.0, 0.0
    for step in range(2):
        b = {k: torch.as_tensor(v) for k, v in data.batch(step).items()}
        with route_log(np, MOE) as calls:
            mc, gc_ = STEPS.value_and_grad(cfg, pcfg, pc, b)
        with route_replay(torch, F, MOE, calls):
            mg, gg = STEPS.value_and_grad(cfg, pcfg, pg, _to(b, dev))
        check(_loss_near(float(mg["loss"]), float(mc["loss"])),
              f"{what} step {step}: card loss {float(mg['loss'])} vs CPU "
              f"{float(mc['loss'])}")
        losses.append(float(mg["loss"]))
        g_worst = max(g_worst, _grad_share(
            torch, gg, gc_, f"{what} step {step} gradients, routes "
                            f"replayed"))
        p_same = OPT.tree_map(lambda t: t.clone().to(dev), pc)
        s_same = _state_on(OPT, sc, dev)
        g_same = [g.clone().to(dev) for g in gc_]
        OPT.apply(ocfg, p_same, g_same, s_same)
        pc, sc, _ = OPT.apply(ocfg, pc, gc_, sc)
        for x, y in zip(OPT.leaves([t for t in (p_same, s_same.mu, s_same.nu)
                                    if t is not None]),
                        OPT.leaves([t for t in (pc, sc.mu, sc.nu)
                                    if t is not None])):
            err = (x.cpu() - y).abs()
            lim = ADAM_RTOL * (y.abs() + y.abs().max())
            check(bool((err <= lim).all()), f"{what} step {step}: the "
                  f"card's update differs by {err.max().item():.3e}")
            o_worst = max(o_worst, float((err / lim).max()))
        pg, sg, _ = OPT.apply(ocfg, pg, gg, sg)
        del p_same, s_same, g_same
    return {"losses": losses, "grad_worst_share_of_tol": g_worst,
            "update_on_same_grads_worst_share_of_tol": o_worst}


def moe_train_reference_phase(torch, np, F, registry, api, Dataset, STEPS,
                              OPT, MOE, ShapeConfig, ParallelConfig,
                              OptimizerConfig, dev="cuda"):
    """Reduced qwen3-moe and kimi-k2 with the same f32 weights and batch on
    the CPU and on the card.  One step's loss and gradients: with the
    CPU's routes replayed on the card, every leaf within LOGIT_REL_TOL of
    its largest |g|; without, each fresh route split a near tie of the
    CPU's router logits (`route_splits`), counted.  Then 2 steps of sgd
    and of adafactor, the CPU's routes replayed (`_optimizer_steps`)."""
    out = {}
    shape = ShapeConfig(*MOE_SMALL_SHAPE)
    B, T = shape.global_batch, shape.seq_len
    pcfg = ParallelConfig(remat="none")
    for arch in MOE_REDUCED:
        cfg = registry.get_reduced(arch)
        p_cpu = api.init_params(cfg, seed=0, device="cpu",
                                dtype=torch.float32)
        p_gpu = _to(p_cpu, dev)
        b_cpu = {k: torch.as_tensor(v)
                 for k, v in Dataset(cfg, shape).batch(0).items()}
        b_gpu = _to(b_cpu, dev)
        with route_log(np, MOE) as cpu_calls:
            m_cpu, g_cpu = STEPS.value_and_grad(cfg, pcfg, p_cpu, b_cpu)
        with route_replay(torch, F, MOE, cpu_calls):
            m_rep, g_rep = STEPS.value_and_grad(cfg, pcfg, p_gpu, b_gpu)
        res = {"grad_worst_share_of_tol": _grad_share(
            torch, g_rep, g_cpu, f"{arch} gradients, routes replayed")}
        for k in ("loss", "aux"):
            check(_loss_near(float(m_rep[k]), float(m_cpu[k])),
                  f"{arch}: card {k} {float(m_rep[k])} vs CPU "
                  f"{float(m_cpu[k])}")
        with route_log(np, MOE) as gpu_calls:
            m_own, _ = STEPS.value_and_grad(cfg, pcfg, p_gpu, b_gpu)
        first = route_splits(np, cpu_calls, gpu_calls,
                             f"{arch} training forward", B, T)
        res.update(
            route_splits=int(sum((w["chosen"] != g["chosen"]).any(1).sum()
                                 for w, g in zip(cpu_calls, gpu_calls))),
            rows_touched=int((first != NEVER).sum()), rows=B,
            moe_calls=len(cpu_calls), loss_cpu=float(m_cpu["loss"]),
            loss_card_replayed=float(m_rep["loss"]),
            loss_card_own_routes=float(m_own["loss"]))
        del g_rep, g_cpu
        for opt in ("sgd", "adafactor"):
            res[opt] = _optimizer_steps(
                torch, np, F, cfg, p_cpu, Dataset(cfg, shape), pcfg,
                OptimizerConfig(name=opt, lr=1e-3, warmup_steps=2), STEPS,
                OPT, MOE, f"{arch} {opt}", dev)
        out[arch] = res
    return out


def moe_train_phase(torch, np, cfg, CL, RunConfig, ShapeConfig,
                    ParallelConfig, OptimizerConfig, TrainerState, STEPS,
                    OPT, api, engine_mod, DA, FA, MOE, dev="cuda"):
    """Full-width qwen3-moe-30b-a3b cut to 4 layers (f32 from seed 0):
    first, before any optimizer state exists, one microbatch's loss and
    gradients four ways (remat on, remat off, under
    ``torch.use_deterministic_algorithms``, remat on again), all bitwise
    equal; then ``Slice.train`` on the dense training cell for 3 warm and
    10 timed steps (the dropped fraction of the first and the last step),
    a profiled step, one step split into a microbatch's forward + backward
    and Adam; then ``Slice.serve`` of the trained params cast to bf16 on
    the serve phase's 16 requests, rows 1 and 2 counted."""
    import dataclasses
    check(torch.cuda.memory_allocated() < MOE_EMPTY_LIMIT,
          f"{torch.cuda.memory_allocated()} bytes allocated before MoE "
          f"training")
    run = _dense_run(cfg, RunConfig, ShapeConfig, ParallelConfig,
                     OptimizerConfig)
    accum = STEPS.pick_accum_steps(cfg, run.shape,
                                   xent_chunk=run.parallel.xent_chunk)
    check(accum == MOE_TRAIN_MICROBATCHES,
          f"MoE training: {accum} microbatches, want "
          f"{MOE_TRAIN_MICROBATCHES}")
    sc = CL.Supercomputer(device=dev)
    sl = sc.allocate((8, 8, 8))
    sess = sl.train(run)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # the Trainer's own init (its seed, f32 master weights), without m, v
    params = api.init_params(cfg, seed=run.seed, device=dev,
                             dtype=torch.float32)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    check(n_params == MOE_TRAIN_PARAMS, f"MoE training: {n_params} params")
    out = {"layers": cfg.num_layers, "params": n_params,
           "shape": list(DENSE_SHAPE), "microbatches": accum,
           "xent_chunk": DENSE_XENT_CHUNK, "remat": run.parallel.remat,
           "init_s": init_s}
    # -- one microbatch four ways, bitwise
    mb = {k: torch.as_tensor(v[:run.shape.global_batch // accum], device=dev)
          for k, v in sess.trainer.dataset.batch(0).items()}
    torch.cuda.reset_peak_memory_stats()
    ref = step_bits(torch, cfg, run, STEPS, params, mb, accum)
    off = run.replace(parallel=dataclasses.replace(run.parallel,
                                                   remat="none"))
    same = {}
    for name, r, det in (("remat_off", off, False),
                         ("deterministic_algorithms", run, True),
                         ("again", run, False)):
        with (deterministic(torch) if det else contextlib.nullcontext()):
            other = step_bits(torch, cfg, r, STEPS, params, mb, accum)
        same[name] = all(torch.equal(x, y) for x, y in zip(ref, other))
        del other
    out["bitwise"] = dict(same, depth=cfg.num_layers, microbatch=[
        run.shape.global_batch // accum, run.shape.seq_len],
        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(all(same.values()), f"MoE training: one step is not bitwise "
                              f"repeatable on the card: {same}")
    del ref, mb
    # -- training through Slice.train
    state = TrainerState(params, OPT.init(run.optimizer, params), 0)
    del params
    probes = [state.params["embed"][:1024],
              state.params["layers"]["attn"]["wq"][0, :64],
              state.params["layers"]["moe"]["router"][-1],
              state.params["layers"]["moe"]["wg"][-1, 0, :64]]
    before = [t.clone() for t in probes]
    drops = []
    ep = MOE.moe_ep

    def counted(*a, **kw):
        res = ep(*a, **kw)
        drops[-1].append(res[2])
        return res

    steps = DENSE_WARM + DENSE_TIMED
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for i in range(steps):
        watch = i in (0, steps - 1)
        if watch:
            drops.append([])
            MOE.moe_ep = counted
        t0 = time.perf_counter()
        try:
            sess.run(i + 1, state=state if i == 0 else None, log_every=1)
            torch.cuda.synchronize()
        finally:
            MOE.moe_ep = ep
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    state = sess.state
    losses = [m["loss"] for m in sess.metrics_log]
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"MoE training: losses {losses}")
    check(losses[-1] < losses[0], f"MoE training: the loss did not fall "
                                  f"from its first value: {losses}")
    moved = [not torch.equal(a, b) and bool(torch.isfinite(b).all())
             for a, b in zip(before, probes)]
    check(all(moved), f"MoE training: params moved {moved}")
    static = 4 * 4 * n_params               # f32 params, gradient, m, v
    check(peak < MOE_TRAIN_PEAK_LIMIT,
          f"MoE training: peak allocated {peak / 1e9:.2f} GB over "
          f"{MOE_TRAIN_PEAK_LIMIT / 1e9:.0f} GB")
    dropped = [float(torch.stack(d).mean()) for d in drops]
    timed = step_s[DENSE_WARM:]
    med = sorted(timed)[len(timed) // 2]
    prof = profile_busy(torch, lambda: sess.run(sess.state.step + 1,
                                                log_every=1), top=25)
    state = sess.state
    # one more step, split: forward + backward of one microbatch, then Adam
    mb = {k: torch.as_tensor(v[:run.shape.global_batch // accum], device=dev)
          for k, v in sess.trainer.dataset.batch(state.step).items()}
    grads = [None] * len(list(_leaves(state.params)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    STEPS.accumulate_grad(cfg, run.parallel, state.params, mb, grads,
                          1.0 / accum)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    OPT.apply(run.optimizer, state.params, grads, state.opt_state)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del grads, mb
    tokens = run.shape.global_batch * run.shape.seq_len
    out.update(
        losses=losses, steps_warm=DENSE_WARM, steps_timed=DENSE_TIMED,
        ms_per_step=[t * 1e3 for t in step_s], median_ms_per_step=med * 1e3,
        spread_ms=[min(timed) * 1e3, max(timed) * 1e3],
        tokens_per_s=tokens * len(timed) / sum(timed),
        peak_mem_gb=peak / 1e9, static_state_gb=static / 1e9,
        dropped_first_step=dropped[0], dropped_last_step=dropped[1],
        moe_calls_a_step=[len(d) for d in drops], profile_step=prof,
        step_split={"fwd_bwd_microbatch_ms": (t1 - t0) * 1e3,
                    "adam_ms": (t2 - t1) * 1e3,
                    "adam_share_of_median_step": (t2 - t1) / med})
    # -- serve the trained weights, in bf16
    bf16 = OPT.tree_map(lambda t: t.to(torch.bfloat16), state.params)
    del state, probes, before
    sess.close()
    gc.collect()
    torch.cuda.empty_cache()
    spec = engine_mod.SliceSpec(**SERVE_SPEC)
    _, prompts = serve_trace(np, cfg.vocab_size)
    serve = sl.serve(cfg, bf16, spec)
    reqs = [serve.submit(p, max_new_tokens=SERVE_NEW_TOKENS)
            for p in prompts]
    torch.cuda.synchronize()
    DA.launches = FA.launches = 0
    sstats = serve.run()
    launches = {"paged_decode_attention": DA.launches,
                "flash_attention": FA.launches}
    check(sstats["requests_done"] == len(prompts)
          and all(r.done and len(r.out_tokens) == SERVE_NEW_TOKENS
                  and all(0 <= t < cfg.vocab_size for t in r.out_tokens)
                  for r in reqs),
          f"serving the trained MoE weights: {sstats['requests_done']} of "
          f"{len(prompts)} requests")
    check(all(v > 0 for v in launches.values()),
          f"serving the trained MoE weights: launches {launches}")
    sl.free()
    del bf16, serve, reqs
    out["serve"] = {k: sstats[k] for k in ("requests_done", "tokens",
                                           "tokens_per_s", "mean_ttft_s",
                                           "decode_steps")}
    out["launches"] = launches
    return out, launches


def moe_preempt_phase(torch, registry, CL, RunConfig, ShapeConfig,
                      ParallelConfig, OptimizerConfig, OPT, dev="cuda"):
    """Reduced qwen3-moe on the card with checkpoints (remat, xent chunks
    of 8, 2 microbatches a step): a clean run of 6 steps, and a run that
    ``Slice.request_preempt`` stops at step 3, resumed on a slice of
    another shape; losses and final params bitwise the clean run's."""
    import shutil
    import tempfile
    cfg = registry.get_reduced(MOE_ARCH)
    run = RunConfig(model=cfg, shape=ShapeConfig(*MOE_SMALL_SHAPE),
                    parallel=ParallelConfig(remat="block", xent_chunk=8),
                    optimizer=OptimizerConfig(lr=1e-3, warmup_steps=2))
    sc = CL.Supercomputer(device=dev)
    d = tempfile.mkdtemp(prefix="moe_preempt_")
    try:
        clean = sc.allocate((8, 8, 8))
        ref = clean.train(run, MOE_PREEMPT_STEPS, accum_steps=2, log_every=1)
        first = sc.allocate((8, 8, 8))
        sess = first.train(run, ckpt_dir=d, accum_steps=2)
        sess.run(MOE_PREEMPT_AT, log_every=1)
        first.request_preempt()
        sess.run(MOE_PREEMPT_STEPS, log_every=1)
        check(sess.preempted and sess.state.step == MOE_PREEMPT_AT,
              f"MoE preempt: stopped at {sess.state.step}, preempted "
              f"{sess.preempted}")
        first.free()
        second = sc.allocate((4, 8, 8))
        resumed = second.train(run, MOE_PREEMPT_STEPS, ckpt_dir=d,
                               accum_steps=2, log_every=1)
        want = _losses(ref)
        curve = {**_losses(sess), **_losses(resumed)}
        check(len(want) == MOE_PREEMPT_STEPS and curve == want,
              f"MoE preempt/resume: losses {curve} differ from the clean "
              f"run's {want}")
        check(all(torch.equal(x, y) for x, y in
                  zip(OPT.leaves(resumed.params), OPT.leaves(ref.params))),
              "MoE preempt/resume: final params differ from the clean run's")
        second.free()
        clean.free()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return {"steps": MOE_PREEMPT_STEPS, "preempt_at": MOE_PREEMPT_AT,
            "resumed_on": second.describe(), "bitwise": True,
            "losses": [want[s] for s in sorted(want)]}


def moe_training_phases(torch, np, F, registry, api, Dataset, CL, STEPS,
                        OPT, MOE, TrainerState, RunConfig, ShapeConfig,
                        ParallelConfig, OptimizerConfig, engine_mod, DA, FA,
                        dev="cuda"):
    """Phase 17: MoE training.  The reduced archs card vs CPU (sgd and
    adafactor too), full-width qwen3-moe cut to 4 layers trained and
    served, then a preempt/resume of the reduced qwen3-moe."""
    t_phase = time.perf_counter()
    reference = moe_train_reference_phase(
        torch, np, F, registry, api, Dataset, STEPS, OPT, MOE, ShapeConfig,
        ParallelConfig, OptimizerConfig, dev)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = registry.get_config(MOE_ARCH).replace(num_layers=MOE_TRAIN_LAYERS)
    train, launches = moe_train_phase(
        torch, np, cfg, CL, RunConfig, ShapeConfig, ParallelConfig,
        OptimizerConfig, TrainerState, STEPS, OPT, api, engine_mod, DA, FA,
        MOE, dev)
    gc.collect()
    torch.cuda.empty_cache()
    preempt = moe_preempt_phase(torch, registry, CL, RunConfig, ShapeConfig,
                                ParallelConfig, OptimizerConfig, OPT, dev)
    return dict(reference=reference, train=train, preempt=preempt,
                phase_s=time.perf_counter() - t_phase), launches


# Phase 18: the SSM and hybrid families.  mamba2-130m and hymba-1.5b at
# full width, 16 requests of prompts left-padded to 1088 tokens (4 chunks
# of 256 and a padded quarter) and 64 new tokens each; hymba decodes
# past its 1024-token window on 30 of its 32 layers
SSM_ARCHS = ("mamba2-130m", "hymba-1.5b")
SSM_EMPTY_LIMIT = 3e9           # allocated bytes when each serve starts
SERVE_PEAK_LIMIT = 72e9         # each full-width serve (phases 18, 20)
SSM_SPEC = dict(slots=16, max_len=1152, prompt_len=1088, chunk=8)
SSM_NEW_TOKENS = 64
SSM_REQUESTS = 16
# hymba-1.5b's attention: 25 query heads over 5 KV heads, d = 64
HYMBA_HEADS = (25, 5, 64)
HYMBA_WINDOW = 1024
HYMBA_LENS = [0, 1, 1024, 1025, 1152, 5, 100, 500, 1023, 1026, 1100, 1151,
              64, 700, 1088, 1090]


def hymba_kernel_phase(torch, F, DA, FA, REF, dev="cuda"):
    """Rows 1 and 2 at hymba-1.5b's attention shapes (H = 25 query heads
    over KH = 5 KV heads: one head group of 8 holds 5; d = 64).  Decode at
    B = 16, S = 1152 with lengths 0, 1, 1024, 1025 and 1152 among others,
    with the window of 1024 and global; prefill at the serve phase's
    admission wave (B = 16, T = S = 1088) with the window.  Each is held
    against its plain version, timed beside it and, in turns, beside SDPA
    (``enable_gqa``, the window as an explicit mask; a yardstick only),
    with its bound from the rows the window and lengths leave."""
    gen = torch.Generator(device=dev).manual_seed(28)
    bf = torch.bfloat16
    H, KH, d = HYMBA_HEADS
    W = HYMBA_WINDOW

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    out = {}
    B, S = len(HYMBA_LENS), 1152
    lens = torch.tensor(HYMBA_LENS, dtype=torch.int32, device=dev)
    sets = [(randn(B, H, d), randn(B, S, KH, d), randn(B, S, KH, d), lens)
            for _ in range(3)]                           # 3 x 19 MB
    kpos = torch.arange(S, device=dev)[None, :]
    ln = lens.long()[:, None]
    for window in (W, None):
        kw = dict(window=window)
        name = "window" if window else "global"
        err = max_err(torch, DA.paged_decode_attention(*sets[0], **kw),
                      REF.paged_decode_attention_ref(*sets[0], **kw),
                      f"decode at hymba's B{B} H{H} KH{KH} S{S} {name}")
        see = kpos < ln
        if window:
            see &= (ln - 1) - kpos < window
        mask = see[:, None, None, :]

        def sdpa(i, mask=mask):
            q, k, v, _ = sets[i]
            return F.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)

        mean, turns = in_turns(torch, {
            "kernel": lambda i, kw=kw: DA.paged_decode_attention(*sets[i],
                                                                 **kw),
            "library": sdpa}, 3)
        rows = int(see.sum())
        bound_ms, bound_by = bound(2 * B * H * d * 2 + 2 * rows * KH * d * 2
                                   + B * 4, 4 * rows * H * d)
        out[f"paged_decode_attention_{name}"] = dict(
            shape=[B, H, KH, S, d], window=window, rows=rows,
            max_abs_err=err, ms=mean["kernel"],
            plain_ms=cuda_ms(torch, lambda i, kw=kw:
                             REF.paged_decode_attention_ref(*sets[i], **kw),
                             3),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=mean["library"],
            ms_turns=turns)
    del sets
    B, T = SSM_SPEC["slots"], SSM_SPEC["prompt_len"]
    sets = [(randn(B, H, T, d), randn(B, KH, T, d), randn(B, KH, T, d))
            for _ in range(3)]                           # 3 x 78 MB
    err = max_err(torch, FA.flash_attention(*sets[0], window=W),
                  REF.flash_attention_ref(*sets[0], window=W),
                  f"prefill at hymba's B{B} H{H} KH{KH} T{T} window {W}")
    t = torch.arange(T, device=dev)
    allowed = (t[None, :] <= t[:, None]) & (t[:, None] - t[None, :] < W)
    mean, turns = in_turns(torch, {
        "kernel": lambda i: FA.flash_attention(*sets[i], window=W),
        "library": lambda i: F.scaled_dot_product_attention(
            *sets[i], attn_mask=allowed, enable_gqa=True)}, 3)
    pairs = int(allowed.sum())
    bound_ms, bound_by = bound((2 * B * H * T * d + 2 * B * KH * T * d) * 2,
                               4 * B * H * d * pairs)
    out["flash_attention"] = dict(
        shape=[B, H, KH, T, d], window=W, pairs=pairs, max_abs_err=err,
        ms=mean["kernel"],
        plain_ms=cuda_ms(torch, lambda i: REF.flash_attention_ref(
            *sets[i], window=W), 3),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=mean["library"],
        ms_turns=turns)
    return out


def ssm_reference_phase(torch, registry, api, TF, dev="cuda"):
    """Reduced mamba2-130m and hymba-1.5b, seeded weights, on the CPU
    (plain attention, CPU matmuls) and on the card (rows 1 and 2, cuBLAS):
    a prefill of 24 tokens (past hymba's reduced window of 16 and over the
    SSD chunk of 16 with a padded second chunk), then 12 teacher-forced
    ``decode_step_paged`` steps with one lane frozen from step 6.  Logits
    within LOGIT_REL_TOL of the CPU's largest; the frozen lane's SSD state
    and conv history bitwise what they were on both.  Returns each arch's
    worst share of the tolerance."""
    out = {}
    for arch in SSM_ARCHS:
        cfg = registry.get_reduced(arch)
        p_cpu = api.init_params(cfg, seed=0, device="cpu")
        p_gpu = _to(p_cpu, dev)
        B, T, steps = 3, 24, 12
        g = torch.Generator().manual_seed(0)
        toks = torch.randint(0, cfg.vocab_size, (B, T + steps), generator=g)
        runs = {}
        for name, p, d in (("cpu", p_cpu, "cpu"), ("gpu", p_gpu, dev)):
            logits, cache = api.prefill(cfg, p, {"tokens": toks[:, :T].to(d)},
                                        max_len=T + steps)
            lens = torch.full((B,), T, dtype=torch.int32, device=d)
            got = [logits]
            for s in range(steps):
                active = torch.tensor([True, s < 6, True], device=d)
                before = (cache.ssm[:, 1].clone(), cache.conv[:, 1].clone())
                lg, cache, lens = TF.decode_step_paged(
                    cfg, p, cache, toks[:, T + s].to(d), lens, active)
                if s >= 6:
                    check(torch.equal(cache.ssm[:, 1], before[0])
                          and torch.equal(cache.conv[:, 1], before[1]),
                          f"{arch} {name} step {s}: a frozen lane's SSD "
                          f"state moved")
                got.append(lg[active])
            runs[name] = [x.float().cpu() for x in got]
        worst = 0.0
        for s, (c, g_) in enumerate(zip(runs["cpu"], runs["gpu"])):
            check(bool(torch.isfinite(g_).all()), f"{arch} step {s}: not "
                                                  f"finite")
            tol = LOGIT_REL_TOL * c.abs().max().item()
            err = (c - g_).abs().max().item()
            check(err <= tol, f"{arch} step {s}: card vs CPU logits differ "
                              f"by {err:.4f} > {tol:.4f}")
            worst = max(worst, err / tol)
        out[arch] = dict(worst_share_of_tol=worst, steps=steps + 1)
    return out


def ssm_trace(np, vocab):
    """Phase 18's 16 prompts of 1024-1088 tokens (the engine left-pads them
    to 1088 with token 0), ids below ``vocab``, from seed 0."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=int(rng.integers(1024, 1089)))
            for _ in range(SSM_REQUESTS)]


def serve_counted_phase(torch, np, cfg, api, engine_mod, DA, FA, spec_d,
                        prompts, new_tokens, dev="cuda"):
    """Full-width ``cfg`` (bf16 weights from seed 0), on a card with less
    than SSM_EMPTY_LIMIT allocated (checked), in
    ``ServeEngine(SliceSpec(**spec_d))`` on ``prompts``, ``new_tokens``
    each, counted: every request its budget of in-vocabulary ids, rows 1
    and 2 launched on every layer of every decode step and admission (a
    family with attention) or never (the SSM family), peak allocated under
    SERVE_PEAK_LIMIT.  Then the same requests at chunk 1: the same tokens,
    bit for bit (not on whisper's legacy path, which steps one token a
    host sync whatever the chunk); finite prefill logits of the right
    shape (a VLM's over zero patches, whisper's over zero frames); a
    profile of one decode chunk (the card's idle share).  Phases 18, 20
    and 21."""
    check(torch.cuda.memory_allocated() < SSM_EMPTY_LIMIT,
          f"{torch.cuda.memory_allocated()} bytes allocated before serving "
          f"{cfg.name}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = list(_leaves(params))
    n_params = sum(t.numel() for t in leaves)
    weight_gb = sum(t.numel() * t.element_size() for t in leaves) / 1e9
    spec = engine_mod.SliceSpec(**spec_d)
    warm = engine_mod.ServeEngine(cfg, params, spec, device=dev)
    warm.submit(prompts[0][:40], max_new_tokens=9)
    warm.run()
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng, reqs, stats, launches = _engine_run(
        torch, engine_mod, cfg, params, spec, prompts, new_tokens, DA, FA,
        dev)
    stats["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    check(stats["peak_mem_gb"] * 1e9 < SERVE_PEAK_LIMIT,
          f"{cfg.name}: peak {stats['peak_mem_gb']:.2f} GB")
    streams = [list(r.out_tokens) for r in reqs]
    del eng, reqs
    waves = math.ceil(len(prompts) / spec.slots)
    if cfg.attention is not None:
        check(launches["paged_decode_attention"]
              >= cfg.num_layers * stats["decode_steps"]
              and launches["flash_attention"] >= cfg.num_layers * waves,
              f"{cfg.name} launches {launches} for {stats['decode_steps']} "
              f"steps and {waves} waves x {cfg.num_layers} layers")
    else:
        check(not any(launches.values()),
              f"{cfg.name} has no attention but launched {launches}")
    # the legacy path reports chunk 1: one step a host sync
    stats.update(init_s=init_s, params=n_params, weight_gb=weight_gb,
                 launches=launches, prompt_lens=[len(p) for p in prompts],
                 ms_decode_step=stats["p50_chunk_s"] / stats["chunk"] * 1e3)
    if stats["chunk"] > 1:
        one = engine_mod.SliceSpec(**{**spec_d, "chunk": 1})
        _, reqs1, stats1, _ = _engine_run(torch, engine_mod, cfg, params,
                                          one, prompts, new_tokens, DA, FA,
                                          dev)
        check([list(r.out_tokens) for r in reqs1] == streams,
              f"{cfg.name}: chunk {spec.chunk} and chunk 1 served different "
              f"tokens")
        stats["chunk_invariant_bitwise"] = True
        stats["chunk1_tokens_per_s"] = stats1["tokens_per_s"]
        del reqs1
    n = min(len(p) for p in prompts[:2])
    toks = torch.as_tensor(np.stack([p[-n:] for p in prompts[:2]]),
                           device=dev).long()
    batch = {"tokens": toks}
    if cfg.vision_prefix:               # a VLM's zero patches
        batch["patches"] = torch.zeros(
            (2, cfg.vision_prefix, cfg.vision_dim), device=dev)
    if cfg.family == "audio":           # whisper's zero frames
        batch["frames"] = torch.zeros((2, n, cfg.d_model), device=dev)
    logits, _ = api.prefill(cfg, params, batch)
    check(tuple(logits.shape) == (2, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"{cfg.name} prefill logits {tuple(logits.shape)} not finite")
    del logits
    stats["profile"] = profile_chunk(torch, np, cfg, params, engine_mod, spec)
    del params
    return stats, launches


def ssm_phase(torch, np, F, registry, api, engine_mod, DA, FA, REF, TF,
              dev="cuda"):
    """Phase 18: the SSM and hybrid families.  Rows 1 and 2 at hymba's
    shapes, the reduced archs card vs CPU, then full-width mamba2-130m and
    hymba-1.5b served, each on an empty card."""
    t_phase = time.perf_counter()
    kernels = hymba_kernel_phase(torch, F, DA, FA, REF, dev)
    gc.collect()
    torch.cuda.empty_cache()
    reference = ssm_reference_phase(torch, registry, api, TF, dev)
    out = dict(kernels=kernels, reference=reference)
    launches = {}
    for arch in SSM_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = registry.get_config(arch)
        out[arch], launches[arch] = serve_counted_phase(
            torch, np, cfg, api, engine_mod, DA, FA, SSM_SPEC,
            ssm_trace(np, cfg.vocab_size), SSM_NEW_TOKENS, dev)
    out["phase_s"] = time.perf_counter() - t_phase
    return out, launches["hymba-1.5b"]


# Phase 19: SSM and hybrid training.  mamba2-130m and hymba-1.5b at full
# width on phase 12's cell; the reduced archs card vs CPU; the SSD block's
# backward at full width, where the reference's is NaN
SSM_SMALL_SHAPE = ("ssm_check", "train", 32, 4)
SSM_TRAIN_PEAK_LIMIT = 72e9
# hymba's step is ~5.8 s: 2 warm and 5 timed steps keep phase 19 ~40 s
# shorter than phase 12's 3 and 10 (its losses fall within 3 steps)
SSM_WARM, SSM_TIMED = 2, 5
SSD_GRAD_T = 512                # two chunks of 256
# the trained models served: 4 prompts of 64 tokens, 32 new tokens each
SSM_TRAINED_SPEC = dict(slots=4, max_len=96, prompt_len=64, chunk=8)
SSM_TRAINED_SERVE = dict(n=4, prompt=64, new_tokens=32)
# the hybrid's two per-head decay leaves: cancelling sums over every
# position, 30-100x smaller than the rest of the SSD block's gradient, held
# to 2^-5 of the largest |g| of their layer's ``ssm`` subtree
SSM_DECAY_LEAVES = ("A_log", "dt_bias")


def _leaf_names(tree, prefix=""):
    """Leaf paths in ``OPT.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}/{i}")]
    return [prefix]


def ssm_grad_shares(torch, cfg, names, got, want, what):
    """Each gradient leaf's max |got - want| over LOGIT_REL_TOL x its
    largest |want|; a hybrid's ``ssm`` decay leaves (SSM_DECAY_LEAVES)
    layer by layer over LOGIT_REL_TOL x the largest |want| of that layer's
    ``ssm`` subtree.  Fails above 1 or where ``got`` is not finite.
    Returns (the worst share and its leaf, the worst per-leaf share and
    its leaf)."""
    got = [g.detach().float().cpu() for g in got]
    want = [w.detach().float().cpu() for w in want]
    own = {}
    for n, a, b in zip(names, got, want):
        check(bool(torch.isfinite(a).all()), f"{what}: {n} not finite")
        own[n] = ((a - b).abs().max() / (LOGIT_REL_TOL * b.abs().max())
                  .clamp_min(1e-30)).item()
    shares = dict(own)
    if cfg.family == "hybrid":
        L = cfg.num_layers
        ssm = [i for i, n in enumerate(names) if n.startswith("/layers/ssm/")]
        layer_max = torch.stack([want[i].reshape(L, -1).abs().amax(1)
                                 for i in ssm]).amax(0)
        for i in ssm:
            if names[i].rsplit("/", 1)[1] in SSM_DECAY_LEAVES:
                err = (got[i] - want[i]).reshape(L, -1).abs().amax(1)
                shares[names[i]] = (err / (LOGIT_REL_TOL * layer_max)
                                    ).max().item()
    for n, v in shares.items():
        check(v <= 1.0, f"{what}: {n} at {v:.3f} of its bar")
    w, wo = max(shares, key=shares.get), max(own, key=own.get)
    return {"worst": [w, shares[w]], "worst_per_leaf": [wo, own[wo]]}


def ssm_train_reference_phase(torch, registry, api, Dataset, STEPS,
                              ShapeConfig, ParallelConfig, dev="cuda"):
    """Reduced mamba2-130m and hymba-1.5b with the same f32 weights (seed 0)
    and batch on the CPU and on the card (xent chunks of 8): one step's
    loss within the curve bar and its gradients within the training bars
    (`ssm_grad_shares`); on the card, the same step with remat on and off
    bitwise equal."""
    out = {}
    shape = ShapeConfig(*SSM_SMALL_SHAPE)
    for arch in SSM_ARCHS:
        cfg = registry.get_reduced(arch)
        p_cpu = api.init_params(cfg, seed=0, device="cpu",
                                dtype=torch.float32)
        p_gpu = _to(p_cpu, dev)
        b_cpu = {k: torch.as_tensor(v)
                 for k, v in Dataset(cfg, shape).batch(0).items()}
        runs = {}
        for name, p, b, remat in (("cpu", p_cpu, b_cpu, "none"),
                                  ("card", p_gpu, _to(b_cpu, dev), "none"),
                                  ("card_remat", p_gpu, _to(b_cpu, dev),
                                   "block")):
            runs[name] = STEPS.value_and_grad(
                cfg, ParallelConfig(remat=remat, xent_chunk=8), p, b)
        (mc, gc_), (mg, gg), (mr, gr) = (runs[k] for k in
                                         ("cpu", "card", "card_remat"))
        check(_loss_near(float(mg["loss"]), float(mc["loss"])),
              f"{arch}: card loss {float(mg['loss'])} vs CPU "
              f"{float(mc['loss'])}")
        res = ssm_grad_shares(torch, cfg, _leaf_names(p_cpu), gg, gc_,
                              f"{arch} card vs CPU gradients")
        same = (torch.equal(mg["loss"], mr["loss"])
                and all(torch.equal(a, b) for a, b in zip(gg, gr)))
        check(same, f"{arch}: remat on and off differ on the card")
        out[arch] = dict(res, loss_cpu=float(mc["loss"]),
                         loss_card=float(mg["loss"]),
                         remat_bitwise=same, leaves=len(gg))
    return out


def ssd_grad_phase(torch, registry, SSM, dev="cuda"):
    """The SSD block's backward at full width on the card: mamba2's and
    hymba's SSD widths, one layer (f32 params from ``ssd_init``, seed 19),
    u ~ N(0, 1) in bf16 of (1, 512, d_model): the gradient of sum(out * w)
    through the chunked ``ssd_forward`` (two chunks of 256, where the
    reference's is NaN) against the sequential f32 ``ssd_reference``'s,
    every leaf (and u's) finite and within LOGIT_REL_TOL of its largest
    |g|."""
    out = {}
    for arch in SSM_ARCHS:
        cfg = registry.get_config(arch)
        gen = torch.Generator(device=dev).manual_seed(19)
        p0 = SSM.ssd_init(cfg, gen, device=dev, dtype=torch.float32)
        u0 = torch.randn((1, SSD_GRAD_T, cfg.d_model), generator=gen,
                         device=dev).to(torch.bfloat16)
        w = torch.randn((1, SSD_GRAD_T, cfg.d_model), generator=gen,
                        device=dev)
        grads = {}
        for name, fn in (("chunked", SSM.ssd_forward),
                         ("sequential", SSM.ssd_reference)):
            p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
            u = u0.clone().requires_grad_(True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = fn(cfg, p, u)[0]
            (y.float() * w).sum().backward()
            torch.cuda.synchronize()
            grads[name] = ({k: v.grad for k, v in p.items()}, u.grad,
                           (time.perf_counter() - t0) * 1e3)
        (gc_, guc, ms_c), (gs, gus, ms_s) = grads["chunked"], grads[
            "sequential"]
        shares = {}
        for k, a, b in [(k, gc_[k], gs[k]) for k in sorted(gc_)] + [
                ("u", guc, gus)]:
            a, b = a.float(), b.float()
            check(bool(torch.isfinite(a).all()),
                  f"{arch} SSD gradient: {k} not finite")
            shares[k] = ((a - b).abs().max()
                         / (LOGIT_REL_TOL * b.abs().max())).item()
            check(shares[k] <= 1.0, f"{arch} SSD gradient: {k} at "
                                    f"{shares[k]:.3f} of its bar")
        worst = max(shares, key=shares.get)
        DI, H, P, N = SSM.ssm_dims(cfg)
        out[arch] = dict(heads=H, head_dim=P, state=N, T=SSD_GRAD_T,
                         worst=[worst, shares[worst]], shares=shares,
                         ms_chunked_fwd_bwd=ms_c,
                         ms_sequential_fwd_bwd=ms_s)
        del grads
    return out


def ssm_train_phase(torch, np, cfg, CL, RunConfig, ShapeConfig,
                    ParallelConfig, OptimizerConfig, TrainerState, STEPS,
                    OPT, api, engine_mod, DA, FA, dev="cuda"):
    """Full-width ``cfg`` (f32 from seed 0) on phase 12's cell (train_2k,
    remat, xent chunks of 256, Adam at lr 3e-4, warmup 5): first
    ``STEPS.value_and_grad`` of the batch's first 2048-token row, every
    leaf finite; then ``Slice.train`` for 2 warm and 5 timed steps
    (finite losses that fall from the first, params that move, peak
    allocated < 72 GB), one more step profiled against the median timed
    step's wall time; Adam alone timed once more on the trained state; then the trained params cast to bf16 and served (4 prompts of
    64 tokens, 32 new tokens each, rows 1 and 2 counted: launched on the
    hybrid, never on the SSM).  ``split_s`` times each part."""
    check(torch.cuda.memory_allocated() < SSM_EMPTY_LIMIT,
          f"{torch.cuda.memory_allocated()} bytes allocated before training "
          f"{cfg.name}")
    run = _dense_run(cfg, RunConfig, ShapeConfig, ParallelConfig,
                     OptimizerConfig)
    accum = STEPS.pick_accum_steps(cfg, run.shape,
                                   xent_chunk=run.parallel.xent_chunk)
    sc = CL.Supercomputer(device=dev)
    sl = sc.allocate((8, 8, 8))
    sess = sl.train(run)
    split = {}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # the Trainer's own init (its seed, f32 master weights), without m, v
    params = api.init_params(cfg, seed=run.seed, device=dev,
                             dtype=torch.float32)
    torch.cuda.synchronize()
    split["init"] = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    out = {"layers": cfg.num_layers, "params": n_params,
           "shape": list(DENSE_SHAPE), "microbatches": accum,
           "xent_chunk": DENSE_XENT_CHUNK, "remat": run.parallel.remat}
    # -- one 2048-token row's gradient, before the optimizer state exists
    t0 = time.perf_counter()
    row = {k: torch.as_tensor(v[:1], device=dev)
           for k, v in sess.trainer.dataset.batch(0).items()}
    m, grads = STEPS.value_and_grad(cfg, run.parallel, params, row)
    bad = [n for n, g in zip(_leaf_names(params), grads)
           if not bool(torch.isfinite(g).all())]
    check(not bad and math.isfinite(float(m["loss"])),
          f"{cfg.name}: loss {float(m['loss'])}, gradient leaves not "
          f"finite: {bad}")
    out["first_row_gradient"] = {
        "loss": float(m["loss"]), "leaves": len(grads), "finite": True,
        "max_abs_grad": max(float(g.abs().max()) for g in grads)}
    del grads, row, m
    split["first_row_gradient"] = time.perf_counter() - t0
    # -- training through Slice.train
    state = TrainerState(params, OPT.init(run.optimizer, params), 0)
    del params
    probes = [state.params["embed"][:1024],
              state.params["layers"]["ssm"]["in_proj"][0, :64],
              state.params["layers"]["ssm"]["A_log"][-1],
              state.params["layers"]["ssm"]["dt_bias"][0]]
    if cfg.family == "hybrid":
        probes.append(state.params["layers"]["attn"]["wq"][-1, :64])
    before = [t.clone() for t in probes]
    steps = SSM_WARM + SSM_TIMED
    gc.collect()
    torch.cuda.empty_cache()
    step_s = []
    t_train = time.perf_counter()
    for i in range(steps):
        t0 = time.perf_counter()
        sess.run(i + 1, state=state if i == 0 else None, log_every=1)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    split["train_13_steps"] = time.perf_counter() - t_train
    peak = torch.cuda.max_memory_allocated()
    state = sess.state
    losses = [x["loss"] for x in sess.metrics_log]
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"{cfg.name} training: losses {losses}")
    check(losses[-1] < losses[0], f"{cfg.name} training: the loss did not "
                                  f"fall from its first value: {losses}")
    moved = [not torch.equal(a, b) and bool(torch.isfinite(b).all())
             for a, b in zip(before, probes)]
    check(all(moved), f"{cfg.name} training: params moved {moved}")
    check(peak < SSM_TRAIN_PEAK_LIMIT,
          f"{cfg.name} training: peak allocated {peak / 1e9:.2f} GB over "
          f"{SSM_TRAIN_PEAK_LIMIT / 1e9:.0f} GB")
    timed = step_s[SSM_WARM:]
    med = sorted(timed)[len(timed) // 2]
    t0 = time.perf_counter()
    prof = profile_busy(torch, lambda: sess.run(sess.state.step + 1,
                                                log_every=1), top=25,
                        wall=med)
    split["profiled_step"] = time.perf_counter() - t0
    state = sess.state
    # Adam alone, once more on the trained state (its time does not depend
    # on the gradient's values)
    grads = [torch.zeros_like(t) for t in OPT.leaves(state.params)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    OPT.apply(run.optimizer, state.params, grads, state.opt_state)
    torch.cuda.synchronize()
    adam_s = time.perf_counter() - t0
    del grads
    tokens = run.shape.global_batch * run.shape.seq_len
    out.update(
        losses=losses, steps_warm=SSM_WARM, steps_timed=SSM_TIMED,
        ms_per_step=[t * 1e3 for t in step_s], median_ms_per_step=med * 1e3,
        spread_ms=[min(timed) * 1e3, max(timed) * 1e3],
        tokens_per_s=tokens * len(timed) / sum(timed),
        peak_mem_gb=peak / 1e9, static_state_gb=4 * 4 * n_params / 1e9,
        profile_step=prof,
        adam_ms=adam_s * 1e3, adam_share_of_median_step=adam_s / med)
    # -- serve the trained weights, in bf16
    t0 = time.perf_counter()
    bf16 = OPT.tree_map(lambda t: t.to(torch.bfloat16), state.params)
    del state, probes, before
    sess.close()
    sl.free()
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(19)
    n = SSM_TRAINED_SERVE
    prompts = [rng.integers(0, cfg.vocab_size, size=n["prompt"])
               for _ in range(n["n"])]
    _, _, sstats, launches = _engine_run(
        torch, engine_mod, cfg, bf16, engine_mod.SliceSpec(
            **SSM_TRAINED_SPEC), prompts, n["new_tokens"], DA, FA, dev)
    if cfg.family == "hybrid":
        check(launches["paged_decode_attention"] > 0
              and launches["flash_attention"] > 0,
              f"serving the trained {cfg.name}: launches {launches}")
    else:
        check(not any(launches.values()),
              f"{cfg.name} has no attention but launched {launches}")
    del bf16
    out["serve"] = {k: sstats[k] for k in ("requests_done", "tokens",
                                           "tokens_per_s", "mean_ttft_s",
                                           "decode_steps")}
    out["launches"] = launches
    split["serve"] = time.perf_counter() - t0
    out["split_s"] = split
    return out, launches


def ssm_training_phases(torch, np, registry, api, Dataset, CL, STEPS, OPT,
                        SSM, TrainerState, RunConfig, ShapeConfig,
                        ParallelConfig, OptimizerConfig, engine_mod, DA, FA,
                        dev="cuda"):
    """Phase 19: SSM and hybrid training.  The reduced archs card vs CPU
    with remat on and off, the SSD block's backward at full width, then
    full-width mamba2-130m and hymba-1.5b trained and served."""
    t_phase = time.perf_counter()
    out = {"reference": ssm_train_reference_phase(
        torch, registry, api, Dataset, STEPS, ShapeConfig, ParallelConfig,
        dev)}
    out["reference_s"] = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    out["ssd_gradient"] = ssd_grad_phase(torch, registry, SSM, dev)
    out["ssd_gradient_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    launches = {}
    for arch in SSM_ARCHS:
        t0 = time.perf_counter()
        out[arch], launches[arch] = ssm_train_phase(
            torch, np, registry.get_config(arch), CL, RunConfig, ShapeConfig,
            ParallelConfig, OptimizerConfig, TrainerState, STEPS, OPT, api,
            engine_mod, DA, FA, dev)
        out[arch]["arch_s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out, launches["hymba-1.5b"]

# Phase 20: the dense variants qwen2-7b, mistral-nemo-12b and gemma2-9b
# served at full width, with rows 1, 1q, 2, 3 and 3q at gemma2's head_dim
# of 256 and at qwen2's GQA 7
DENSE_VARIANTS = ("qwen2-7b", "mistral-nemo-12b", "gemma2-9b")
# their depth in the serving runs (28, 40 and 42 as published): serving is
# host-paced a layer a step, and at full depth the three took 173.9 s of
# a 1,244.7 s script (NVIDIA H100 80GB HBM3, 700.00 W, behind a slow
# host), past its 1,200 s limit, once phase 24 was added; gemma2's 8
# layers still alternate windowed and global
DENSE_VARIANT_LAYERS = 8
# gemma2-9b's attention: 16 query heads over 8 KV heads of 256, softcap 50,
# scale 256^-0.5, a window of 4096 on every other layer
GEMMA2_HEADS = (16, 8, 256)
GEMMA2_WINDOW = 4096
GEMMA2_SOFTCAP = 50.0
GEMMA2_SPEC = dict(slots=8, max_len=4608, prompt_len=4480, chunk=8)
GEMMA2_NEW_TOKENS = 64
GEMMA2_PROMPT_LENS = (4000, 4480)       # drawn in this range, inclusive
GEMMA2_LENS = [0, 1, 4096, 4097, 4608, 129, 2000, 4480]
GEMMA2_BS = 16                  # rows 3 and 3q: pool blocks of 16 rows
QWEN2_HEADS = (28, 4, 128)      # G = 7: 7 of a head group's 8 lanes
DENSE_REFERENCE_STEPS = 12


def _sdpa_decode(F, q, k, v, mask, scale):
    """SDPA over a per-slot cache (B, S, KH, d) for q (B, H, d), GQA and an
    explicit mask; no softcap (SDPA has none)."""
    return F.scaled_dot_product_attention(
        q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
        enable_gqa=True, scale=scale)


def gemma2_kernel_phase(torch, np, F, DA, FA, REF, QU, ops, dev="cuda"):
    """Rows 1, 1q, 3 and 3q at gemma2-9b's decode shape (B = 8, S = 4608,
    lengths 0, 1, 4096, 4097, 4608 among 8; H = 16 over KH = 8, d = 256,
    softcap 50, scale 256^-0.5), with the window of 4096 and global: rows
    3 and 3q over a pool of blocks of 16 rows through permuted tables (two
    slots share 8 blocks), rows 1 and 1q on the gathered view, 1q and 3q
    on ``quantize_kv`` of the same K/V; rows 1q, 3 and 3q go once through
    ``ops`` (counted).  Row 2 at gemma2's prefill: B = 1 and 8, T = S =
    4480, window 4096, and B = 8, T = S = 512, global.  Rows 1 and 2 also
    at qwen2-7b's G = 7 (H = 28 over KH = 4, d = 128: decode B = 8, S =
    1024 with the decode phase's lengths; prefill B = 8, T = S = 128).
    Each is held against its plain version (row 2's at B = 8, T = 4480
    one batch row at a time: the same function, in 1.3 GB of f32 scores a
    row), rows 3 and 3q bitwise rows 1 and 1q on the view, and each is
    timed beside its plain version and its bound; rows 1 and 2 in turns
    with SDPA (``enable_gqa``; the window as an explicit mask, prefill
    ``is_causal`` without one; WITHOUT the softcap, which SDPA lacks: a
    yardstick of the same shape only)."""
    gen = torch.Generator(device=dev).manual_seed(30)
    bf = torch.bfloat16
    H, KH, d = GEMMA2_HEADS
    scale, cap, W = d ** -0.5, GEMMA2_SOFTCAP, GEMMA2_WINDOW

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    out = {"decode": {}, "prefill": {}}
    B, S, bs = len(GEMMA2_LENS), GEMMA2_SPEC["max_len"], GEMMA2_BS
    nb = S // bs
    NB = B * nb + 16                    # 16 blocks no table names
    lens = torch.tensor(GEMMA2_LENS, dtype=torch.int32, device=dev)

    def inputs(i):
        q = randn(B, H, d)
        k, v = randn(NB, bs, KH, d), randn(NB, bs, KH, d)
        t = np.random.default_rng(30 + i).permutation(NB)[:B * nb]
        t = t.reshape(B, nb).astype(np.int32)
        t[3, :8] = t[2, :8]
        t = torch.from_numpy(t).to(dev)
        (kq, ks), (vq, vs) = QU.quantize_kv(k), QU.quantize_kv(v)
        return dict(q=q, k=k, v=v, t=t, kq=kq, ks=ks, vq=vq, vs=vs,
                    view=[REF.pool_rows(x, t) for x in (k, v)],
                    view_q=[REF.pool_rows(x, t) for x in (kq, ks, vq, vs)])

    # 2 sets (~1 GB each): the valid bf16 rows of one are ~150 MB, 3x L2
    sets = [inputs(i) for i in range(2)]
    a = sets[0]
    kw0 = dict(window=W, softcap=cap, scale=scale)
    DA.launches_q = DA.launches_bt = DA.launches_bt_q = 0
    ops.paged_decode_attention(a["q"], a["view_q"][0], a["view_q"][2], lens,
                               k_scale=a["view_q"][1],
                               v_scale=a["view_q"][3], **kw0)
    ops.paged_decode_attention_bt(a["q"], a["k"], a["v"], lens, a["t"], **kw0)
    ops.paged_decode_attention_bt(a["q"], a["kq"], a["vq"], lens, a["t"],
                                  k_scale=a["ks"], v_scale=a["vs"], **kw0)
    torch.cuda.synchronize()
    counted = {"1q": DA.launches_q, "3": DA.launches_bt,
               "3q": DA.launches_bt_q}
    check(counted == {"1q": 1, "3": 1, "3q": 1},
          f"d = 256 decode through ops: launches {counted}")

    kern = {
        "1": lambda x, kw: DA.paged_decode_attention(
            x["q"], *x["view"], lens, **kw),
        "1q": lambda x, kw: DA.paged_decode_attention_q8(
            x["q"], *x["view_q"], lens, **kw),
        "3": lambda x, kw: DA.paged_decode_attention_bt(
            x["q"], x["k"], x["v"], lens, x["t"], **kw),
        "3q": lambda x, kw: DA.paged_decode_attention_bt_q8(
            x["q"], x["kq"], x["ks"], x["vq"], x["vs"], lens, x["t"], **kw)}
    plain = {
        "1": lambda x, kw: REF.paged_decode_attention_ref(
            x["q"], *x["view"], lens, **kw),
        "1q": lambda x, kw: REF.paged_decode_attention_ref(
            x["q"], x["view_q"][0], x["view_q"][2], lens,
            k_scale=x["view_q"][1], v_scale=x["view_q"][3], **kw),
        "3": lambda x, kw: REF.paged_decode_attention_bt_ref(
            x["q"], x["k"], x["v"], lens, x["t"], **kw),
        "3q": lambda x, kw: REF.paged_decode_attention_bt_ref(
            x["q"], x["kq"], x["vq"], lens, x["t"], k_scale=x["ks"],
            v_scale=x["vs"], **kw)}
    kpos = torch.arange(S, device=dev)[None, :]
    ln = lens.long()[:, None]
    io = 2 * B * H * d * 2 + B * 4          # q in, out, seq_lens
    for window in (W, None):
        kw = dict(window=window, softcap=cap, scale=scale)
        name = "window" if window else "global"
        got = {n: f(a, kw) for n, f in kern.items()}
        err = {n: max_err(torch, got[n], plain[n](a, kw),
                          f"row {n} at gemma2's B{B} H{H} KH{KH} S{S} d{d} "
                          f"{name}") for n in kern}
        check(torch.equal(got["3"], got["1"]) and
              torch.equal(got["3q"], got["1q"]),
              f"d = 256 {name}: the pooled launches are not bitwise the "
              f"per-slot ones on the gathered view")
        check(not got["1"][lens == 0].any(), "a slot of length 0 not zeros")
        see = kpos < ln
        if window:
            see &= (ln - 1) - kpos < window
        mask = see[:, None, None, :]
        fns = {n: (lambda i, f=f, kw=kw: f(sets[i], kw))
               for n, f in kern.items()}
        fns["sdpa"] = lambda i: _sdpa_decode(F, sets[i]["q"],
                                             *sets[i]["view"], mask, scale)
        ms, turns = in_turns(torch, fns, 2, ("1", "1q", "3", "3q", "sdpa",
                                             "sdpa", "3q", "3", "1q", "1"))
        rows = int(see.sum())
        flops, deq = 4 * rows * H * d, 2 * rows * KH * d
        nbytes = {"1": io + 2 * rows * KH * d * 2,
                  "1q": io + 2 * rows * KH * (d + 4)}
        nbytes["3"] = nbytes["1"] + B * nb * 4
        nbytes["3q"] = nbytes["1q"] + B * nb * 4
        for n in kern:
            bound_ms, bound_by = bound(nbytes[n],
                                       flops + (deq if "q" in n else 0))
            out["decode"][f"{n}_{name}"] = dict(
                shape=[B, H, KH, S, d], window=window, rows=rows,
                max_abs_err=err[n], ms=ms[n],
                plain_ms=cuda_ms(torch, lambda i, n=n, kw=kw:
                                 plain[n](sets[i], kw), 2, iters=10),
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, sdpa_no_softcap_ms=ms["sdpa"],
                ms_turns=turns[n],
                launches=counted.get(n))
    del sets, a, got

    def flash_case(key, B, H, KH, T, d, window, softcap, scale, n_sets):
        sets = [(randn(B, H, T, d), randn(B, KH, T, d), randn(B, KH, T, d))
                for _ in range(n_sets)]
        kw = dict(window=window, softcap=softcap, scale=scale)

        def plain(i):                   # one batch row at a time
            q, k, v = sets[i]
            return torch.cat([REF.flash_attention_ref(
                q[b:b + 1], k[b:b + 1], v[b:b + 1], **kw) for b in range(B)])

        err = max_err(torch, FA.flash_attention(*sets[0], **kw), plain(0),
                      f"prefill {key}: B{B} H{H} KH{KH} T{T} d{d} {kw}")
        t = torch.arange(T, device=dev)
        allowed = t[None, :] <= t[:, None]
        sdpa_kw = dict(is_causal=True)
        if window is not None:
            allowed &= t[:, None] - t[None, :] < window
            sdpa_kw = dict(attn_mask=allowed)
        mean, turns = in_turns(torch, {
            "kernel": lambda i: FA.flash_attention(*sets[i], **kw),
            "library": lambda i: F.scaled_dot_product_attention(
                *sets[i], enable_gqa=True, scale=scale, **sdpa_kw)}, n_sets)
        pairs = int(allowed.sum())
        bound_ms, bound_by = bound(
            (2 * B * H * T * d + 2 * B * KH * T * d) * 2,
            4 * B * H * d * pairs)
        # SDPA computes the same function only where there is no softcap
        out["prefill"][key] = dict(
            shape=[B, H, KH, T, d], window=window, pairs=pairs,
            max_abs_err=err, ms=mean["kernel"],
            plain_ms=cuda_ms(torch, plain, n_sets, iters=3, warmup=1),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None if softcap else mean["library"],
            sdpa_no_softcap_ms=mean["library"], ms_turns=turns)

    T = GEMMA2_SPEC["prompt_len"]
    flash_case("gemma2_B1", 1, H, KH, T, d, W, cap, scale, 3)
    flash_case("gemma2_B8", 8, H, KH, T, d, W, cap, scale, 2)
    flash_case("gemma2_B8_T512_global", 8, H, KH, 512, d, None, cap, scale,
               3)
    gc.collect()
    torch.cuda.empty_cache()

    # qwen2-7b's GQA 7 at d = 128: row 1 at the decode phase's shape, row 2
    # at the serve phase's admission wave
    H, KH, d = QWEN2_HEADS
    B, S = 8, 1024
    dl = [0, 1, 100, 257, 512, 700, 1000, 1024]
    dlens = torch.tensor(dl, dtype=torch.int32, device=dev)
    sets = [(randn(B, H, d), randn(B, S, KH, d), randn(B, S, KH, d))
            for _ in range(3)]
    err = max_err(torch, DA.paged_decode_attention(*sets[0][:3], dlens),
                  REF.paged_decode_attention_ref(*sets[0][:3], dlens),
                  f"decode at qwen2's B{B} H{H} KH{KH} S{S}")
    mask = (torch.arange(S, device=dev)[None, :]
            < dlens.long()[:, None])[:, None, None, :]
    mean, turns = in_turns(torch, {
        "kernel": lambda i: DA.paged_decode_attention(*sets[i], dlens),
        "library": lambda i: _sdpa_decode(F, *sets[i], mask, None)}, 3)
    rows = sum(dl)
    bound_ms, bound_by = bound(2 * B * H * d * 2 + 2 * rows * KH * d * 2
                               + B * 4, 4 * rows * H * d)
    out["decode"]["qwen2_g7"] = dict(
        shape=[B, H, KH, S, d], rows=rows, max_abs_err=err,
        ms=mean["kernel"],
        plain_ms=cuda_ms(torch, lambda i: REF.paged_decode_attention_ref(
            *sets[i], dlens), 3),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=mean["library"],
        ms_turns=turns)
    del sets
    flash_case("qwen2_g7", 8, H, KH, SERVE_SPEC["prompt_len"], d, None,
               None, None, 8)
    return out


def card_vs_cpu(torch, arch, runs):
    """``runs[name] = (logits, picks)`` a step, for "cpu" and "gpu" (the
    card fed the CPU's picks): every step's card logits finite and within
    LOGIT_REL_TOL of the CPU's largest; where the picks differ, the CPU's
    top-2 margin is under that bar (a near tie, counted).  Returns the
    worst share of the bar, the steps and the near ties."""
    worst, ties = 0.0, 0
    for s, (c, g) in enumerate(zip(runs["cpu"][0], runs["gpu"][0])):
        check(bool(torch.isfinite(g).all()), f"{arch} step {s}: not finite")
        tol = LOGIT_REL_TOL * c.abs().max().item()
        err = (c - g).abs().max().item()
        check(err <= tol, f"{arch} step {s}: card vs CPU logits differ by "
                          f"{err:.4f} > {tol:.4f}")
        worst = max(worst, err / tol)
        for b in torch.nonzero(runs["cpu"][1][s] != runs["gpu"][1][s]):
            top2 = c[int(b)].topk(2).values
            check(float(top2[0] - top2[1]) < tol,
                  f"{arch} step {s} row {int(b)}: the card picks another "
                  f"token off a near tie")
            ties += 1
    return dict(worst_share_of_tol=worst, steps=len(runs["cpu"][0]),
                near_ties=ties)


def dense_reference_phase(torch, registry, api, TF, dev="cuda"):
    """Reduced qwen2-7b, mistral-nemo-12b and gemma2-9b, seeded weights, on
    the CPU (plain attention, CPU matmuls) and on the card (rows 1 and 2,
    cuBLAS): a prefill of 24 tokens (past gemma2's reduced window of 16),
    then 12 greedy decode steps, the card fed the CPU's picks.  Logits
    within LOGIT_REL_TOL of the CPU's largest at every step; the card's
    pick equals the CPU's at every step, or the CPU's top-2 margin there is
    under that bar (a near tie, counted).  Returns each arch's worst share
    of the tolerance and its near ties."""
    out = {}
    for arch in DENSE_VARIANTS:
        cfg = registry.get_reduced(arch)
        p_cpu = api.init_params(cfg, seed=0, device="cpu")
        p_gpu = _to(p_cpu, dev)
        B, T, steps = 3, 24, DENSE_REFERENCE_STEPS
        toks = torch.randint(0, cfg.vocab_size, (B, T),
                             generator=torch.Generator().manual_seed(0))
        runs, feed = {}, None
        for name, p, d in (("cpu", p_cpu, "cpu"), ("gpu", p_gpu, dev)):
            logits, cache = api.prefill(cfg, p, {"tokens": toks.to(d)},
                                        max_len=T + steps)
            lens = torch.full((B,), T, dtype=torch.int32, device=d)
            active = torch.ones((B,), dtype=torch.bool, device=d)
            got = [logits.float().cpu()]
            picks = [logits.argmax(-1).cpu()]
            for s in range(steps):
                tk = (picks[-1] if feed is None else feed[s]).to(d)
                logits, cache, lens = TF.decode_step_paged(cfg, p, cache, tk,
                                                           lens, active)
                got.append(logits.float().cpu())
                picks.append(logits.argmax(-1).cpu())
            runs[name] = (got, picks)
            feed = feed or picks
        out[arch] = card_vs_cpu(torch, arch, runs)
    return out


def gemma2_trace(np, vocab):
    """Phase 20's gemma2 prompts: 8 of 4000-4480 tokens (past the window
    of 4096 but for two), ids below ``vocab``, from seed 0."""
    rng = np.random.default_rng(0)
    lo, hi = GEMMA2_PROMPT_LENS
    return [rng.integers(0, vocab, size=int(rng.integers(lo, hi + 1)))
            for _ in range(GEMMA2_SPEC["slots"])]


def dense_variants_phase(torch, np, F, registry, api, engine_mod, DA, FA,
                         REF, QU, ops, TF, dev="cuda"):
    """Phase 20: the dense variants.  Rows 1, 1q, 2, 3 and 3q at gemma2's
    head_dim of 256 and rows 1 and 2 at qwen2's GQA 7, the reduced archs
    card vs CPU, then qwen2-7b and mistral-nemo-12b at full width, cut to
    DENSE_VARIANT_LAYERS layers as gemma2-9b is, on the serve phase's
    engine and trace (16 requests, 128 new tokens each) and
    gemma2-9b in ``SliceSpec(slots=8, max_len=4608, prompt_len=4480,
    chunk=8)`` on `gemma2_trace`, 64 new tokens each (every local layer
    masks at prefill and at decode), each through `serve_counted_phase`
    on an empty card.  Returns (results, {arch: launches})."""
    t_phase = time.perf_counter()
    out = {"kernels": gemma2_kernel_phase(torch, np, F, DA, FA, REF, QU, ops,
                                          dev)}
    out["kernels_s"] = time.perf_counter() - t_phase
    gc.collect()
    torch.cuda.empty_cache()
    out["reference"] = dense_reference_phase(torch, registry, api, TF, dev)
    launches = {}
    for arch in DENSE_VARIANTS:
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cfg = registry.get_config(arch).replace(
            num_layers=DENSE_VARIANT_LAYERS)
        if arch == "gemma2-9b":     # past its window, at prefill and decode
            spec, prompts = GEMMA2_SPEC, gemma2_trace(np, cfg.vocab_size)
            new_tokens = GEMMA2_NEW_TOKENS
        else:                       # the olmo-1b serve phase's cell
            spec, prompts = SERVE_SPEC, serve_trace(np, cfg.vocab_size)[1]
            new_tokens = SERVE_NEW_TOKENS
        out[arch], launches[arch] = serve_counted_phase(
            torch, np, cfg, api, engine_mod, DA, FA, spec, prompts,
            new_tokens, dev)
        out[arch]["arch_s"] = time.perf_counter() - t0
    out["phase_s"] = time.perf_counter() - t_phase
    return out, launches


# Phase 21: whisper-small through the legacy full-batch engine path and
# internvl2-2b with its vision prefix
WHISPER_ARCH, VLM_ARCH = "whisper-small", "internvl2-2b"
# the legacy path steps one token a host sync whatever ``chunk`` says;
# zero frames of prompt_len rows: S_enc = 192
WHISPER_SPEC = dict(slots=8, max_len=448, prompt_len=192, chunk=8)
WHISPER_ENC_LEN = 1500          # the published 30-second encoder length
WHISPER_HEADS = (12, 12, 64)
# max_len counts the 1024 patch rows: 1024 + 128 prompt + 128 new
VLM_SPEC = dict(slots=8, max_len=1280, prompt_len=128, chunk=8)
VLM_HEADS = (16, 8, 128)
VLM_PREFIX = 1024               # internvl2-2b's vision_prefix
AUDIO_VLM_NEW_TOKENS = 128
AUDIO_VLM_REFERENCE_STEPS = 12


def tail_drop_caught(torch, drop, want, what, atol, rtol=KERNEL_RTOL):
    """The max |drop - want| of the plain version over all keys (``want``)
    and over all but the tail tile (``drop``): a kernel that skipped that
    tile would be off by as much.  Fails unless `max_err`'s bar at
    ``atol`` refuses it.  Returns that error."""
    err = (drop.float() - want.float()).abs()
    check(bool((err > atol + rtol * want.float().abs()).any()),
          f"{what}: the bar atol {atol} + rtol {rtol} would pass a kernel "
          f"that drops the tail tile (max error {err.max().item():.3e})")
    return err.max().item()


def audio_vlm_kernel_phase(torch, F, DA, FA, REF, dev="cuda"):
    """Rows 1 and 2 at the shapes phase 21's serves give them.  Row 2 at
    whisper-small's admission wave (B = 8, H = KH = 12, d = 64): the
    encoder's non-causal T = S = 192 and the cross-attention's T = 192
    over S = 1500 frames (the published 30-second encoder length); row 1
    over whisper's cross cache of 1500 and of 192 rows (every slot's
    length the cache's) and its decoder self-attention (S = 448, lengths
    193-448: the served 193-320 and the clamp's 448); row 2 at
    internvl2-2b's causal wave (B = 8, H = 16 over KH = 8, d = 128, T = S
    = 1152) and row 1 at its decode (S = 1280, lengths 1152-1280).  Each
    held against its plain version, timed beside it and its bound, and in
    turns with SDPA, which computes the same function at these shapes (no
    window, no softcap).  Over 1500 keys the bar is LONG_KEYS_ATOL, and
    each such case also checks that the bar refuses the plain version
    with the last 1500 % 64 = 28 keys dropped (``tail_drop_err``)."""
    gen = torch.Generator(device=dev).manual_seed(31)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    out = {}
    tail = WHISPER_ENC_LEN % 64

    def flash_case(key, B, H, KH, T, S, d, causal, n_sets,
                   atol=KERNEL_ATOL):
        sets = [(randn(B, H, T, d), randn(B, KH, S, d), randn(B, KH, S, d))
                for _ in range(n_sets)]
        kw = dict(causal=causal)
        what = f"row 2 {key}: B{B} H{H} KH{KH} T{T} S{S} d{d} {kw}"
        want = REF.flash_attention_ref(*sets[0], **kw)
        err = max_err(torch, FA.flash_attention(*sets[0], **kw), want, what,
                      atol=atol)
        drop = None
        if S == WHISPER_ENC_LEN:
            q, k, v = sets[0]
            drop = tail_drop_caught(torch, REF.flash_attention_ref(
                q, k[:, :, :-tail], v[:, :, :-tail], **kw), want, what, atol)
        del want
        mean, turns = in_turns(torch, {
            "kernel": lambda i: FA.flash_attention(*sets[i], **kw),
            "library": lambda i: F.scaled_dot_product_attention(
                *sets[i], enable_gqa=True, is_causal=causal)}, n_sets)
        pairs = T * (T + 1) // 2 if causal else T * S
        bound_ms, bound_by = bound(
            (2 * B * H * T * d + 2 * B * KH * S * d) * 2,
            4 * B * H * d * pairs)
        out[key] = dict(
            shape=[B, H, KH, T, S, d], causal=causal, pairs=pairs,
            max_abs_err=err, atol=atol, tail_drop_err=drop,
            ms=mean["kernel"],
            plain_ms=cuda_ms(torch, lambda i: REF.flash_attention_ref(
                *sets[i], **kw), n_sets, iters=3, warmup=1),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=mean["library"], ms_turns=turns)

    def decode_case(key, B, H, KH, S, d, dl, n_sets, atol=KERNEL_ATOL):
        lens = torch.tensor(dl, dtype=torch.int32, device=dev)
        sets = [(randn(B, H, d), randn(B, S, KH, d), randn(B, S, KH, d))
                for _ in range(n_sets)]
        what = (f"row 1 {key}: B{B} H{H} KH{KH} S{S} d{d} lengths "
                f"{min(dl)}-{max(dl)}")
        want = REF.paged_decode_attention_ref(*sets[0], lens)
        err = max_err(torch, DA.paged_decode_attention(*sets[0], lens), want,
                      what, atol=atol)
        drop = None
        if S == WHISPER_ENC_LEN:
            drop = tail_drop_caught(torch, REF.paged_decode_attention_ref(
                *sets[0], lens - tail), want, what, atol)
        del want
        mask = (torch.arange(S, device=dev)[None, :]
                < lens.long()[:, None])[:, None, None, :]
        mean, turns = in_turns(torch, {
            "kernel": lambda i: DA.paged_decode_attention(*sets[i], lens),
            "library": lambda i: _sdpa_decode(F, *sets[i], mask, None)},
            n_sets)
        rows = sum(dl)
        bound_ms, bound_by = bound(2 * B * H * d * 2 + 2 * rows * KH * d * 2
                                   + B * 4, 4 * rows * H * d)
        out[key] = dict(
            shape=[B, H, KH, S, d], lens=[min(dl), max(dl)], rows=rows,
            max_abs_err=err, atol=atol, tail_drop_err=drop,
            ms=mean["kernel"],
            plain_ms=cuda_ms(torch, lambda i: REF.paged_decode_attention_ref(
                *sets[i], lens), n_sets),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=mean["library"],
            ms_turns=turns)

    H, KH, d = WHISPER_HEADS
    T, S = WHISPER_SPEC["prompt_len"], WHISPER_SPEC["max_len"]
    flash_case("whisper_encoder", 8, H, KH, T, T, d, False, 8)
    flash_case("whisper_cross_1500", 8, H, KH, T, WHISPER_ENC_LEN, d, False,
               4, atol=LONG_KEYS_ATOL)
    decode_case("whisper_cross_decode_1500", 8, H, KH, WHISPER_ENC_LEN, d,
                [WHISPER_ENC_LEN] * 8, 8, atol=LONG_KEYS_ATOL)
    decode_case("whisper_cross_decode_192", 8, H, KH, T, d, [T] * 8, 8)
    decode_case("whisper_self_decode_448", 8, H, KH, S, d,
                [T + 1, T + 1, 256, 320, 320, S - 1, S, S], 8)
    H, KH, d = VLM_HEADS
    T, S = VLM_SPEC["prompt_len"] + VLM_PREFIX, VLM_SPEC["max_len"]
    flash_case("internvl_wave", 8, H, KH, T, T, d, True, 2)
    decode_case("internvl_decode_1280", 8, H, KH, S, d,
                [T, T + 1, 1170, 1200, 1231, 1250, S - 1, S], 4)
    return out


def audio_vlm_reference_phase(torch, registry, api, TF, dev="cuda"):
    """Reduced whisper-small and internvl2-2b, seeded weights, on the CPU
    (plain attention, CPU matmuls) and on the card (rows 1 and 2, cuBLAS):
    a 16-token prefill over 16 random frames (whisper) or 8 random patches
    (internvl), then 12 greedy decode steps (``api.decode_step`` over
    whisper's shared-position cache, ``decode_step_paged`` for the VLM),
    the card fed the CPU's picks.  Logits within LOGIT_REL_TOL of the
    CPU's largest at every step; the card's pick equals the CPU's at every
    step, or the CPU's top-2 margin there is under that bar (a near tie,
    counted).  Returns each arch's worst share of the tolerance and its
    near ties."""
    out = {}
    for arch in (WHISPER_ARCH, VLM_ARCH):
        cfg = registry.get_reduced(arch)
        p_cpu = api.init_params(cfg, seed=0, device="cpu")
        p_gpu = _to(p_cpu, dev)
        B, T, steps = 3, 16, AUDIO_VLM_REFERENCE_STEPS
        g = torch.Generator().manual_seed(0)
        extra = {"tokens": torch.randint(0, cfg.vocab_size, (B, T),
                                         generator=g)}
        if cfg.family == "audio":
            extra["frames"] = torch.randn((B, 16, cfg.d_model), generator=g)
        else:
            extra["patches"] = torch.randn(
                (B, cfg.vision_prefix, cfg.vision_dim), generator=g)
        P = cfg.vision_prefix
        runs, feed = {}, None
        for name, p, d in (("cpu", p_cpu, "cpu"), ("gpu", p_gpu, dev)):
            batch = {k: v.to(d) for k, v in extra.items()}
            logits, cache = api.prefill(cfg, p, batch,
                                        max_len=P + T + steps)
            lens = torch.full((B,), P + T, dtype=torch.int32, device=d)
            active = torch.ones((B,), dtype=torch.bool, device=d)
            got = [logits.float().cpu()]
            picks = [logits.argmax(-1).cpu()]
            for s in range(steps):
                tk = (picks[-1] if feed is None else feed[s]).to(d)
                if cfg.family == "audio":
                    logits, cache = api.decode_step(cfg, p, cache, tk)
                else:
                    logits, cache, lens = TF.decode_step_paged(
                        cfg, p, cache, tk, lens, active)
                got.append(logits.float().cpu())
                picks.append(logits.argmax(-1).cpu())
            runs[name] = (got, picks)
            feed = feed or picks
        out[arch] = card_vs_cpu(torch, arch, runs)
    return out


def whisper_trace(np, vocab):
    """Phase 21's whisper prompts: 16 of 32-192 tokens, from seed 0."""
    rng = np.random.default_rng(0)
    hi = WHISPER_SPEC["prompt_len"]
    return [rng.integers(0, vocab, size=int(rng.integers(min(32, hi),
                                                         hi + 1)))
            for _ in range(16)]


def audio_vlm_phase(torch, np, F, registry, api, engine_mod, DA, FA, REF,
                    TF, dev="cuda"):
    """Phase 21: the last two families.  Rows 1 and 2 at whisper-small's
    and internvl2-2b's shapes, the reduced archs card vs CPU, then
    full-width whisper-small in ``SliceSpec(**WHISPER_SPEC)`` (the legacy
    path) on `whisper_trace` and internvl2-2b in ``SliceSpec(**VLM_SPEC)``
    on the serve phase's 16 prompts, 128 new tokens each, each through
    `serve_counted_phase` on an empty card, with exact launch counts over
    its 2 admissions (16 requests, 8 slots, equal budgets): row 2
    (encoder_layers + 2 * num_layers) = 36 an admission for whisper
    (encoder, decoder, cross), num_layers = 24 for internvl; row 1
    2 * num_layers = 24 a step for whisper (self and cross), num_layers =
    24 for internvl.  Returns (results, {arch: launches})."""
    t_phase = time.perf_counter()
    out = {"kernels": audio_vlm_kernel_phase(torch, F, DA, FA, REF, dev)}
    out["kernels_s"] = time.perf_counter() - t_phase
    gc.collect()
    torch.cuda.empty_cache()
    out["reference"] = audio_vlm_reference_phase(torch, registry, api, TF,
                                                 dev)
    launches = {}
    for arch in (WHISPER_ARCH, VLM_ARCH):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cfg = registry.get_config(arch)
        if cfg.family == "audio":
            spec, prompts = WHISPER_SPEC, whisper_trace(np, cfg.vocab_size)
            per_wave, per_step = (cfg.encoder_layers + 2 * cfg.num_layers,
                                  2 * cfg.num_layers)
        else:
            spec, prompts = VLM_SPEC, serve_trace(np, cfg.vocab_size)[1]
            per_wave = per_step = cfg.num_layers
        st, launches[arch] = serve_counted_phase(
            torch, np, cfg, api, engine_mod, DA, FA, spec, prompts,
            AUDIO_VLM_NEW_TOKENS, dev)
        waves = math.ceil(len(prompts) / spec["slots"])
        check(launches[arch]["flash_attention"] == per_wave * waves
              and launches[arch]["paged_decode_attention"]
              == per_step * st["decode_steps"],
              f"{arch} launches {launches[arch]} for {st['decode_steps']} "
              f"steps and {waves} admissions: not {per_wave} row-2 launches "
              f"an admission and {per_step} row-1 launches a step")
        st.update(admissions=waves, row2_per_admission=per_wave,
                  row1_per_step=per_step, arch_s=time.perf_counter() - t0)
        out[arch] = st
    out["phase_s"] = time.perf_counter() - t_phase
    return out, launches


# Phase 22: the twins of examples/topology_explorer.py,
# fault_tolerant_training.py, serve_lm.py and train_dlrm.py.  The
# explorer's text is the example's: sha256 of the example's stdout
# (``python examples/topology_explorer.py <args>`` on the CPU)
TOPOLOGY_SHA256 = {
    ("--chips", "512"):
        "1ed00a77a6e06b5cbcaf78458f3733f8e703df73dfe54902d76b06ac7b5ea0a6",
    ("--chips", "128", "--search"):
        "b481e528b90b204bd320b1efd1ea1833918286a08c575fb529b206af2ddc6733",
}
EXAMPLE_SERVE_REQUESTS = 8
EXAMPLE_NEW_TOKENS = 16
EXAMPLE_DLRM_STEPS = 150
EXAMPLE_CHECK_STEPS = 5


def _captured(fn, *a, **k):
    """(``fn(*a, **k)``, what it printed): the twins print their reports,
    which must not reach this script's last lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*a, **k)
    return res, buf.getvalue()


@contextlib.contextmanager
def first_calls(torch, module, name):
    """``module.name`` passed through while a detached copy of the inputs
    of its first call at each distinct signature (shapes, dtypes, options)
    is kept in the yielded dict.  The wrapper itself still counts its
    launches; this adds none."""
    fn = getattr(module, name)
    seen = {}

    def copy(x):
        if isinstance(x, torch.Tensor):
            return x.detach().clone()
        if isinstance(x, (list, tuple)):
            return type(x)(copy(v) for v in x)
        return x

    def sig(x):
        if isinstance(x, torch.Tensor):
            return (tuple(x.shape), str(x.dtype))
        if isinstance(x, (list, tuple)):
            return tuple(sig(v) for v in x)
        return x

    def spy(*a, **k):
        key = sig((a, tuple(sorted(k.items()))))
        if key not in seen:
            seen[key] = (copy(a), copy(k))
        return fn(*a, **k)

    setattr(module, name, spy)
    try:
        yield seen
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def _passed(torch, module, name):
    """`first_calls`' stand-in that keeps nothing."""
    yield {}


@contextlib.contextmanager
def first_grads(torch, OPT):
    """``OPT.apply`` passed through while a copy of the gradients of its
    first call, as the optimizer receives them (before the clip scales
    them in place), is kept in the yielded list."""
    fn = OPT.apply
    kept = []

    def spy(cfg, params, grads, *a, **k):
        if not kept:
            kept.extend(g.detach().clone() for g in OPT.leaves(grads))
        return fn(cfg, params, grads, *a, **k)

    OPT.apply = spy
    try:
        yield kept
    finally:
        OPT.apply = fn


def hold_first_calls(torch, calls, kernel, plain, what, **tol):
    """Each recorded call's inputs through ``kernel`` and ``plain``: within
    `max_err`'s bars (``tol``), or bitwise under deterministic algorithms
    when ``tol`` is {"bitwise": True}.  Returns (worst error, shapes)."""
    worst, shapes = 0.0, []
    for key, (a, k) in calls.items():
        label = f"{what} at {key}"
        with torch.no_grad():
            if tol.get("bitwise"):
                got = kernel(*a, **k)
                with deterministic(torch):
                    want = plain(*a, **k)
                err = scatter_bitwise(torch, got, want, label)
            else:
                err = max_err(torch, kernel(*a, **k), plain(*a, **k), label,
                              **tol)
        worst = max(worst, err)
        shapes.append(repr(key))
    check(calls, f"{what}: never called")
    return worst, shapes


def topology_twin_phase(torch, TE, dev="cuda"):
    """The explorer twin at each of TOPOLOGY_SHA256's arguments: its text
    the example's; host analytics only (no allocation on the card)."""
    out = {}
    for argv, want in TOPOLOGY_SHA256.items():
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        _, text = _captured(TE.main, [*argv, "--device", dev])
        got = hashlib.sha256(text.encode()).hexdigest()
        check(got == want, f"topology_explorer {' '.join(argv)}: its text "
                           f"is not the example's:\n{text}")
        check(torch.cuda.memory_allocated() == before,
              f"topology_explorer {' '.join(argv)} allocated on the card")
        out[" ".join(argv)] = dict(s=time.perf_counter() - t0,
                                   lines=len(text.splitlines()), sha256=got)
    return out


def drill_twin_phase(torch, FT, OPT, dev="cuda"):
    """fault_tolerant_training as the example runs it: the report says
    the faulted run matches, one restart at step 4, losses and final
    params bitwise the clean run's, the machine's event kinds."""
    t0 = time.perf_counter()
    (sc, sess, ref), text = _captured(FT.main, ["--device", dev])
    s = time.perf_counter() - t0
    check("matches clean run: True" in text and "restarts:          1"
          in text and "steps run:         12" in text,
          f"fault_tolerant_training:\n{text}")
    check([m["step"] for m in sess.metrics_log if m.get("event")] == [4],
          "fault_tolerant_training: not one restart at step 4")
    check(_losses(sess) == _losses(ref) and len(_losses(ref)) == 12,
          f"fault_tolerant_training: losses {_losses(sess)} are not the "
          f"clean run's {_losses(ref)} bit for bit")
    check(all(torch.equal(a, b) for a, b in zip(
        OPT.leaves(sess.params), OPT.leaves(ref.params))),
          "fault_tolerant_training: final params differ from the clean "
          "run's")
    kinds = [e.split()[0] for e in sc.events]
    check(kinds == ["alloc", "alloc", "fail", "release", "release"],
          f"fault_tolerant_training: machine events {sc.events}")
    return dict(s=s, events=list(sc.events),
                losses=[_losses(sess)[k] for k in sorted(_losses(sess))],
                report=text.splitlines()[-4:])


def serve_twin_phase(torch, np, SL, api, cfg, arch, DA, FA, dev="cuda"):
    """serve_lm's function on ``cfg`` (weights from seed 0) at the
    example's spec and EXAMPLE_SERVE_REQUESTS, counted from just before
    ``run()`` (the submits launch nothing): every budget of
    in-vocabulary ids; rows 1 and 2 exactly once a layer a decode step and
    an admission (whisper: self and cross a step; encoder, decoder and
    cross an admission).  Returns (results, launches, recorded calls)."""
    t0 = time.perf_counter()
    params = api.init_params(cfg, seed=0, device=dev)
    _sync(torch, dev)
    init_s = time.perf_counter() - t0
    spec = SL.example_spec()
    DA.launches = FA.launches = 0
    with first_calls(torch, DA, "paged_decode_attention") as dcalls, \
            first_calls(torch, FA, "flash_attention") as pcalls:
        (stats, sess), text = _captured(
            SL.serve_lm, arch, cfg, params, spec,
            requests=EXAMPLE_SERVE_REQUESTS, new_tokens=EXAMPLE_NEW_TOKENS,
            device=dev)
    launches = {"paged_decode_attention": DA.launches,
                "flash_attention": FA.launches}
    reqs = sess.engine.queue
    check(stats["requests_done"] == EXAMPLE_SERVE_REQUESTS == len(reqs),
          f"serve_lm {arch}: served {stats['requests_done']}")
    for r in reqs:
        check(len(r.out_tokens) == EXAMPLE_NEW_TOKENS
              and all(0 <= t < cfg.vocab_size for t in r.out_tokens),
              f"serve_lm {arch}: request {r.rid} has {r.out_tokens}")
    audio = cfg.family == "audio"
    per_wave = (cfg.encoder_layers + 2 * cfg.num_layers if audio
                else cfg.num_layers)
    per_step = 2 * cfg.num_layers if audio else cfg.num_layers
    waves = math.ceil(EXAMPLE_SERVE_REQUESTS / spec.slots)
    check(stats["chunk"] == (1 if audio else spec.chunk),
          f"serve_lm {arch}: chunk {stats['chunk']}")
    check(launches["flash_attention"] == per_wave * waves
          and launches["paged_decode_attention"]
          == per_step * stats["decode_steps"],
          f"serve_lm {arch}: launches {launches} for "
          f"{stats['decode_steps']} steps and {waves} admissions: not "
          f"{per_wave} row-2 launches an admission and {per_step} row-1 "
          f"launches a step")
    if not audio:
        toks = torch.as_tensor(np.stack([r.prompt[-4:] for r in reqs[:2]]),
                               device=dev).long()
        logits, _ = api.prefill(cfg, params, {"tokens": toks})
        check(tuple(logits.shape) == (2, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"serve_lm {arch}: prefill logits not finite")
    out = {k: stats[k] for k in ("requests_done", "tokens", "wall_s",
                                 "tokens_per_s", "mean_ttft_s",
                                 "p95_ttft_s", "decode_steps", "chunk",
                                 "p50_chunk_s")}
    out.update(init_s=init_s, launches=launches, admissions=waves,
               row2_per_admission=per_wave, row1_per_step=per_step,
               report=text.splitlines()[-3:])
    return out, launches, (dcalls, pcalls)


def dlrm_twin_phase(torch, TD, api, OPT, TrainerState, FL, EG, FS,
                    dev="cuda"):
    """train_dlrm's demo: 5 twin steps on the card and on the CPU from one
    initial state, both routes; then EXAMPLE_DLRM_STEPS twin steps fused
    and per-table, counted, each improving its loss.  Returns (results,
    launches by route, recorded calls)."""
    cfg = TD.demo_config()
    out, launches, calls = {}, {}, {}
    for pergroup in (False, True):
        route = "pergroup" if pergroup else "fused"
        run = TD.example_run(cfg, pergroup=pergroup)
        # card vs CPU: the twin from one initial state, 5 steps
        p_cpu = api.init_params(cfg, seed=run.seed, device="cpu")
        losses = {}
        for d, p in (("cpu", p_cpu), (dev, _to(p_cpu, dev))):
            sess, _ = _captured(TD.train_dlrm, run, EXAMPLE_CHECK_STEPS, d,
                                state=TrainerState(
                                    p, OPT.init(run.optimizer, p), 0),
                                log_every=1)
            losses[d] = [m["loss"] for m in sess.metrics_log if "loss" in m]
        want, got = losses["cpu"], losses[dev]
        check(len(got) == len(want) == EXAMPLE_CHECK_STEPS and all(
            abs(g - w) <= 1e-3 + 2.0 ** -7 * abs(w)
            for g, w in zip(got, want)),
            f"train_dlrm {route}: card losses {got} vs CPU {want}")
        # the example's run, counted
        FL.launches = EG.launches = FS.launches = 0
        t0 = time.perf_counter()
        with first_calls(torch, FL, "fused_lookup") as lcalls, \
                first_calls(torch, EG, "embedding_gather") as gcalls, \
                first_calls(torch, FS, "fused_scatter") as scalls:
            sess, text = _captured(
                TD.main, ["--steps", str(EXAMPLE_DLRM_STEPS), "--device",
                          dev] + ["--pergroup"] * pergroup)
            _sync(torch, dev)
        s = time.perf_counter() - t0
        launches[route] = {"fused_lookup": FL.launches,
                           "embedding_gather": EG.launches,
                           "fused_scatter": FS.launches}
        n = EXAMPLE_DLRM_STEPS
        spaces = len(sess.params["tables"])
        want_l = ({"fused_lookup": 0, "embedding_gather": n * len(
            cfg.dlrm.tables), "fused_scatter": n * spaces} if pergroup else
                  {"fused_lookup": n, "embedding_gather": 0,
                   "fused_scatter": n})
        check(launches[route] == want_l, f"train_dlrm {route}: launches "
                                         f"{launches[route]}, want {want_l}")
        curve = [m["loss"] for m in sess.metrics_log if "loss" in m]
        check(all(math.isfinite(x) for x in curve) and curve[-1] < curve[0]
              and "(improved)" in text,
              f"train_dlrm {route}: the loss did not improve:\n{text}")
        out[route] = dict(s=s, ms_per_step=s / n * 1e3, steps=n,
                          losses=curve, card_vs_cpu=[got, want],
                          launches=launches[route],
                          report=text.splitlines()[-1])
        calls[route] = (lcalls, gcalls, scalls)
    before = torch.cuda.memory_allocated()
    try:
        TD.main(["--scale", "full", "--device", dev])
        raised = ""
    except NotImplementedError as e:
        raised = str(e)
    check("ROADMAP.md queue 1, item 12" in raised
          and torch.cuda.memory_allocated() == before,
          f"train_dlrm --scale full: raised {raised!r}, allocated "
          f"{torch.cuda.memory_allocated() - before} bytes")
    out["scale_full"] = raised
    return out, launches, calls


def examples_phase(torch, np, registry, api, DA, FA, FL, EG, FS, REF, STEPS,
                   OPT, TrainerState, ShapeConfig, ParallelConfig,
                   OptimizerConfig, dev="cuda"):
    """Phase 22: the twins of the last four examples.  Returns (results,
    {name: launches})."""
    from repro_torch.launch import fault_tolerant_training as FT
    from repro_torch.launch import serve_lm as SL
    from repro_torch.launch import topology_explorer as TE
    from repro_torch.launch import train_dlrm as TD
    t_phase = time.perf_counter()
    out = {"topology_explorer": topology_twin_phase(torch, TE, dev)}
    out["fault_tolerant_training"] = drill_twin_phase(torch, FT, OPT, dev)
    gc.collect()
    torch.cuda.empty_cache()
    launches, recorded = {}, {}
    for name, cfg, arch in (
            ("serve_lm", registry.get_config("olmo-1b"), "olmo-1b"),
            ("serve_lm_whisper", registry.get_reduced(WHISPER_ARCH),
             WHISPER_ARCH)):
        out[name], launches[name], recorded[name] = serve_twin_phase(
            torch, np, SL, api, cfg, arch, DA, FA, dev)
        gc.collect()
        torch.cuda.empty_cache()
    # rows 4, 5 and 6 at the demo's shapes through the whole model
    demo = TD.demo_config()
    worst, _ = dlrm_train_reference_phase(
        torch, registry, api, ShapeConfig, ParallelConfig, OptimizerConfig,
        STEPS, OPT, FS, EG, dev, cfg=demo, batch=256)
    out["train_dlrm_reference_worst"] = worst
    out["train_dlrm"], dlrm_launches, dlrm_calls = dlrm_twin_phase(
        torch, TD, api, OPT, TrainerState, FL, EG, FS, dev)
    launches["train_dlrm"] = dlrm_launches["fused"]
    launches["train_dlrm_pergroup"] = dlrm_launches["pergroup"]
    held = {}
    for name, (dcalls, pcalls) in recorded.items():
        held[f"{name}:paged_decode_attention"] = hold_first_calls(
            torch, dcalls, DA.paged_decode_attention,
            REF.paged_decode_attention_ref, f"{name} row 1")
        held[f"{name}:flash_attention"] = hold_first_calls(
            torch, pcalls, FA.flash_attention, REF.flash_attention_ref,
            f"{name} row 2")
    lcalls, _, scalls = dlrm_calls["fused"]
    _, gcalls, pscalls = dlrm_calls["pergroup"]
    held["train_dlrm:fused_lookup"] = hold_first_calls(
        torch, lcalls, FL.fused_lookup, REF.fused_lookup_ref,
        "train_dlrm row 4", atol=EMB_ATOL, rtol=EMB_RTOL)
    held["train_dlrm_pergroup:embedding_gather"] = hold_first_calls(
        torch, gcalls, EG.embedding_gather, REF.embedding_gather_ref,
        "train_dlrm row 6", atol=0.0, rtol=0.0)

    def scatter_plain(gout, rows, slots, col_slot, shapes):
        return REF.fused_scatter_ref(gout, rows, slots, shapes, col_slot)

    for name, c in (("train_dlrm", scalls), ("train_dlrm_pergroup",
                                             pscalls)):
        held[f"{name}:fused_scatter"] = hold_first_calls(
            torch, c, FS.fused_scatter, scatter_plain, f"{name} row 5",
            bitwise=True)
    out["held"] = {k: {"max_abs_err": v[0], "shapes": v[1]}
                   for k, v in held.items()}
    out["phase_s"] = time.perf_counter() - t_phase
    return out, launches


SHARD_TABLE_PARAMS = 1_000_000_000   # 4.0 GB of f32 tables, 2.0 a model rank
SHARD_MESH = (2, 2)                  # (data, model) ranks
SHARD_AXES = ("data", "model")
SHARD_STEPS = 3
# the reference sizes an a2a destination's slots from the GLOBAL batch (C =
# N / model x factor): its default 2.0 is 8x what a rank of this 2 x 2
# grid sends a destination; 0.75 leaves >= 1.5x over the largest demand
# of these batches (checked: no id is dropped)
SHARD_CAPACITY_FACTOR = 0.75
# hot rows a width-group: the LFU (the reference's, on the host) walks up
# to 8x this many counts once a table a step
SHARD_CACHE_ROWS = 4096
SHARD_GROUP_TIMEOUT_S = 240          # a collective that hangs fails its rank
SHARD_PHASE_LIMIT_S = 420            # the parent's wait for every rank
SHARD_OPTIMIZER = dict(lr=3e-4, warmup_steps=20)   # train_dlrm's Adam


def relayout(torch, src, dst, tables):
    """Whole row spaces of collection ``src``'s layout -> ``dst``'s: the
    same tables' rows copied where ``dst`` keeps them, padding rows 0."""
    where = {}
    for g in list(src.groups.values()) + list(src.local_groups.values()):
        for sl in g.slots:
            where[sl.spec.name] = (g.name, sl.offset)
    out = {}
    for g in list(dst.groups.values()) + list(dst.local_groups.values()):
        like = next(iter(tables.values()))
        t = torch.zeros((g.total_rows, g.dim), dtype=like.dtype,
                        device=like.device)
        for sl in g.slots:
            name, off = where[sl.spec.name]
            n = sl.spec.vocab_size
            t[sl.offset:sl.offset + n] = tables[name][off:off + n]
        out[g.name] = t
    return out


def a2a_headroom(np, ENG, coll, batch, ctx, cf):
    """(most unique ids this rank sends one owner, the owner's slots C) for
    each a2a group of ``coll``, this rank's samples of the global
    ``batch`` (numpy); fails where C is short, since a dropped id would
    read back as a zero vector."""
    ms = ctx.model_axis_size
    rows = ctx.local_rows(len(batch["labels"]))
    worst = []
    for dim, g in sorted(coll.groups.items()):
        ids = np.concatenate([np.where(batch[f"cat_{sl.spec.name}"] >= 0,
                                       batch[f"cat_{sl.spec.name}"]
                                       + sl.offset, -1) for sl in g.slots],
                             axis=1)
        C = ENG._a2a_capacity(ids.size, ms, cf)
        loc = ids[rows].reshape(-1)
        u = np.unique(loc[loc >= 0])
        most = int(np.bincount(u // (g.total_rows // ms), minlength=ms).max())
        check(most <= C, f"{g.name}: a rank sends {most} ids to one owner, "
                         f"over its {C} slots")
        worst.append((most, C))
    return worst


def sharded_rank(rank, workdir, backend, dev_kind="cuda",
                 table_params=SHARD_TABLE_PARAMS, batch=DLRM_CHIP_BATCH):
    """One rank of phase 23 (a process of its own; see the module doc).
    Writes ``rank{rank}.json`` in ``workdir``; raises on any failed
    check, so the rank exits non-zero."""
    import datetime
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.configs.base import (OptimizerConfig, ParallelConfig,
                                          RunConfig, ShapeConfig)
    from repro_torch.data.synthetic import Dataset
    from repro_torch.embeddings import engine as ENG
    from repro_torch.embeddings.cache import HotIdCache
    from repro_torch.kernels import build
    from repro_torch.kernels import embedding_gather as EG
    from repro_torch.kernels import fused_lookup as FL
    from repro_torch.kernels import fused_scatter as FS
    from repro_torch.kernels import ref as REF
    from repro_torch.launch import steps as STEPS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import dlrm as DL
    from repro_torch.optim import adam as OPT
    from repro_torch.parallel import context as PC
    from repro_torch.train.trainer import Trainer, TrainerState

    t_start = time.perf_counter()
    world = SHARD_MESH[0] * SHARD_MESH[1]
    card = dev_kind == "cuda"
    if card:
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        build.library()                 # built by the parent
    else:
        dev = torch.device("cpu")

    def sync():
        if card:
            torch.cuda.synchronize()

    def close(got, want, what, atol=EMB_ATOL, rtol=EMB_RTOL):
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"rank {rank}: {what}: shape or non-finite")
        err = (got.float() - want.float()).abs()
        check(bool((err <= atol + rtol * want.float().abs()).all()),
              f"rank {rank}: {what}: max |diff| {err.max().item():.3e}")
        return err.max().item()

    timeout = datetime.timedelta(seconds=SHARD_GROUP_TIMEOUT_S)
    dist.init_process_group(backend, store=dist.FileStore(
        str(Path(workdir) / "store"), world), rank=rank, world_size=world,
        timeout=timeout)
    ctx = PC.ParallelContext(mesh=make_mesh(SHARD_MESH, SHARD_AXES,
                                            timeout=timeout),
                             emb_capacity_factor=SHARD_CAPACITY_FACTOR)
    d_idx, m_idx = ctx.axis_index("data"), ctx.axis_index("model")
    out = dict(rank=rank, backend=backend, device=str(dev),
               coord=[d_idx, m_idx], start_s=time.perf_counter() - t_start)
    cfg = dlrm0_cut(registry, table_params)
    ms = ctx.model_axis_size
    coll = DL.collection_for(cfg, ms)
    names = [t.name for t in cfg.dlrm.tables]
    check(all(g.total_rows % ms == 0 for g in coll.groups.values()),
          "row spaces do not split over the model axis")

    # this rank's shards: each whole row space drawn on the card as the
    # one-device init draws it, this rank's rows kept
    t0 = time.perf_counter()
    p = DL.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev, ctx=ctx)
    sync()
    out["init_s"] = time.perf_counter() - t0
    check(all(t.device == dev for t in OPT.leaves(p)),
          f"rank {rank}: a param is off {dev}")
    shape = ShapeConfig("dlrm_sharded", "train", 1, batch)
    data = Dataset(cfg, shape)
    host = [data.batch(s) for s in range(SHARD_STEPS)]
    rows = ctx.local_rows(batch)

    def on(b, sl=slice(None)):
        return {k: torch.from_numpy(np.ascontiguousarray(v[sl])).to(dev)
                for k, v in b.items()}

    mine = [on(b, rows) for b in host]
    out["a2a_headroom"] = a2a_headroom(np, ENG, coll, host[0], ctx,
                                       SHARD_CAPACITY_FACTOR)
    out["batches_s"] = time.perf_counter() - t_start

    def feats(b):
        return {n: b[f"cat_{n}"] for n in names}

    def cat(o):
        return torch.cat([o[n] for n in names], dim=1)

    def sq_grads(lookup):
        tabs = {k: v.detach().requires_grad_(True)
                for k, v in p["tables"].items()}
        o = lookup(tabs)
        sum((v ** 2).sum() for v in o.values()).backward()
        return ({n: v.detach() for n, v in o.items()},
                {k: v.grad for k, v in tabs.items()})

    # lookups: the pipelined a2a (with a gradient of the sum of squares,
    # for the cache below) = per-group bitwise; psum within EMB_ATOL
    t0 = time.perf_counter()
    a2a, g_plain = sq_grads(lambda t: coll.lookup(
        t, feats(mine[0]), ctx, method="a2a"))
    sync()
    out["a2a_lookup_with_backward_s"] = time.perf_counter() - t0
    with torch.no_grad():
        per = coll.lookup(p["tables"], feats(mine[0]), ctx, method="a2a",
                          fused=False)
        psum = coll.lookup(p["tables"], feats(mine[0]), ctx, method="psum")
    check(all(a2a[n].device == dev for n in names),
          f"rank {rank}: a lookup left {dev}")
    check(all(torch.equal(a2a[n], per[n]) for n in names),
          f"rank {rank}: pipelined a2a is not bitwise the per-group a2a")
    out["psum_vs_a2a"] = close(cat(psum), cat(a2a), "psum vs a2a")
    every = ctx.all_gather(cat(a2a))          # the global batch's, in order
    del per, psum
    out["lookups_s"] = time.perf_counter() - t_start

    # the hot-id cache: the executor's step on batch 0, batch 1 observed
    # against that snapshot; cached = uncached bitwise, gradients too
    ex = ENG.PipelinedEmbeddingExecutor(
        coll, cache=HotIdCache(capacity=SHARD_CACHE_ROWS), method="a2a")
    ex.step(p["tables"], feats(mine[0]), ctx)
    h0, l0 = ex.cache.hits, ex.cache.lookups
    ex.observe(feats(mine[1]), ctx)
    out["cache_hit_rate_next_batch"] = ((ex.cache.hits - h0)
                                        / max(ex.cache.lookups - l0, 1.0))
    out["cache_hit_rate"] = ex.cache.hit_rate
    o_cached, g_cached = sq_grads(lambda t: ex.lookup(
        t, feats(mine[0]), ctx))
    check(all(torch.equal(o_cached[n], a2a[n]) for n in names),
          f"rank {rank}: the cached lookup is not bitwise the uncached")
    check(all(torch.equal(g_cached[k], g_plain[k]) for k in g_plain),
          f"rank {rank}: the cached lookup's gradient is not bitwise the "
          f"uncached one's")
    del g_plain, o_cached, g_cached, ex
    out["checks_s"] = time.perf_counter() - t_start

    # the main path, counted: SHARD_STEPS steps of a Trainer over the grid
    # from these shards (it puts this rank's rows of each batch); the
    # first step's gradient is kept as Adam receives it
    pcfg = ParallelConfig(remat="none")
    ocfg = OptimizerConfig(**SHARD_OPTIMIZER)
    run = RunConfig(model=cfg, shape=shape, parallel=pcfg, optimizer=ocfg)
    trainer = Trainer(run, device=dev, ctx=ctx)
    state = TrainerState(p, OPT.init(ocfg, p), 0)
    if card:
        torch.cuda.reset_peak_memory_stats()
    EG.launches = FS.launches = FL.launches = 0
    step_ms, step_bytes = [], []
    mark = [0.0, 0]

    def timed(step, _):
        sync()
        step_ms.append((time.perf_counter() - mark[0]) * 1e3)
        step_bytes.append(PC.wire_bytes - mark[1])
        mark[:] = time.perf_counter(), PC.wire_bytes
    # rank 0 keeps each kernel's first inputs at each shape, to hold them
    spy = first_calls if rank == 0 else _passed
    with spy(torch, EG, "embedding_gather") as gcalls, \
            spy(torch, FS, "fused_scatter") as scalls, \
            spy(torch, FL, "fused_lookup") as lcalls, \
            first_grads(torch, OPT) as g_sh:
        sync()
        mark[:] = time.perf_counter(), PC.wire_bytes
        state = trainer.train(SHARD_STEPS, state=state, log_every=1,
                              on_step=timed)
    p = state.params
    losses = [m["loss"] for m in trainer.metrics_log]
    launches = {"embedding_gather": EG.launches,
                "fused_scatter": FS.launches, "fused_lookup": FL.launches}
    out.update(losses=losses, step_ms=step_ms, step_wire_bytes=step_bytes,
               launches=launches)
    # a step: each a2a group (every group's valency is > 4) one owner
    # gather (row 6) and one combine of the received vectors (row 4),
    # each with its scatter (row 5); the replicated spaces, if any, one
    # fused lookup and its scatter
    n_a2a = len(coll.groups)
    n_rep = int(bool(coll.replicated))
    want_l = {"embedding_gather": SHARD_STEPS * n_a2a,
              "fused_scatter": SHARD_STEPS * (2 * n_a2a + n_rep),
              "fused_lookup": SHARD_STEPS * (n_a2a + n_rep)}
    if card:
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        check(launches == want_l, f"rank {rank}: launches {launches}, want "
                                  f"{want_l}")
    check(all(math.isfinite(x) for x in losses),
          f"rank {rank}: losses {losses}")
    check(all(t.device == dev for t in OPT.leaves(p)),
          f"rank {rank}: a param left {dev}")
    leaves = [path for path, _ in _named_leaves(p)]
    del p, state, trainer
    if card and rank == 0:
        torch.cuda.empty_cache()
        held = {"embedding_gather": hold_first_calls(
            torch, gcalls, EG.embedding_gather, REF.embedding_gather_ref,
            "phase 23 row 6", atol=0.0, rtol=0.0)}

        def scatter_plain(gout, rws, slots, col_slot, shapes):
            return REF.fused_scatter_ref(gout, rws, slots, shapes, col_slot)
        held["fused_scatter"] = hold_first_calls(
            torch, scalls, FS.fused_scatter, scatter_plain,
            "phase 23 row 5", bitwise=True)
        held["fused_lookup"] = hold_first_calls(
            torch, lcalls, FL.fused_lookup, REF.fused_lookup_ref,
            "phase 23 row 4", atol=EMB_ATOL, rtol=EMB_RTOL)
        out["held"] = {k: {"max_abs_err": v[0], "shapes": len(v[1])}
                       for k, v in held.items()}
    del gcalls, scalls, lcalls

    out["main_path_s"] = time.perf_counter() - t_start
    t_one = time.perf_counter()
    # against one device, from the same state: the ranks of data row 0
    # hold the two model shards between them, and each draws the whole
    # tables to hold its own shard's first gradient.  One device
    # accumulates over the same pieces of the batch in rank order
    # (microbatch i = rank i's samples), so its bf16 dense tower runs the
    # same GEMMs: against one pass over the whole batch, the GEMMs'
    # batch-size-dependent bf16 rounding alone moves a leaf past the 2^-5
    # bar at this tower's widths
    if d_idx == 0:
        shards = ctx.batch_shards
        pieces = [[on(b, slice(i * (batch // shards),
                                (i + 1) * (batch // shards)))
                   for i in range(shards)] for b in host]
        whole = DL.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               ms, device=dev)
        if rank == 0:
            with torch.no_grad():
                lo = coll.lookup(whole["tables"], feats(on(host[0])),
                                 method="local")
            out["a2a_vs_one_device"] = close(every, cat(lo),
                                             "4-rank a2a vs one-device lookup")
            del lo
        one_coll = DL.collection_for(cfg, 1)
        one = dict(whole, tables=relayout(torch, coll, one_coll,
                                          whole["tables"]))
        del whole
        g_one = [None] * len(OPT.leaves(one))
        for piece in pieces[0]:
            STEPS.accumulate_grad(cfg, pcfg, one, piece, g_one, 1.0 / shards)
        g_one_tree = _refill_tree(OPT.tree_map(lambda x: None, one),
                                  iter(g_one))
        g_one_tree["tables"] = relayout(torch, one_coll, coll,
                                        g_one_tree["tables"])
        worst = (0.0, "")
        for path, b in zip(leaves, g_sh):
            want = _at(g_one_tree, path)
            tol = LOGIT_REL_TOL * want.abs().max().item()
            if path[0] == "tables" and ENG.row_sharded(path[1]):
                rps = want.shape[0] // ms
                want = want[m_idx * rps:(m_idx + 1) * rps]
            err = (b - want).abs().max().item()
            name = "/".join(map(str, path))
            check(bool(torch.isfinite(b).all()) and err <= tol,
                  f"rank {rank}: gradient {name} differs from one "
                  f"device's by {err:.4g} > {tol:.4g}")
            worst = max(worst, (err / tol if tol else 0.0, name))
        out["grad_worst_share"], out["grad_worst_leaf"] = worst
        del g_one, g_one_tree
        if rank == 0:
            # the same SHARD_STEPS steps on one device
            step1 = STEPS.make_train_step(cfg, shape, pcfg, ocfg,
                                          accum_steps=shards)
            st1 = OPT.init(ocfg, one)
            one_losses = []
            for b in host:
                one, st1, m = step1(one, st1, on(b))
                one_losses.append(float(m["loss"]))
            out["one_device_losses"] = one_losses
            check(all(_loss_near(a, b) for a, b in zip(losses, one_losses)),
                  f"sharded losses {losses} vs one device {one_losses}")
            del st1
        del one
    del g_sh
    out["one_device_s"] = time.perf_counter() - t_one
    out["rank_s"] = time.perf_counter() - t_start
    Path(workdir, f"rank{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()
    return 0


def _named_leaves(tree, path=()):
    """(path, leaf) in ``OPT.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, path + (i,))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _refill_tree(tree, it):
    if isinstance(tree, dict):
        return {k: _refill_tree(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_refill_tree(v, it) for v in tree)
    return next(it)


def run_ranks(flag, world, limit_s, what, backend, extra=()):
    """``world`` processes of this script, each given ``flag RANK`` and
    then ``extra`` (rank r's log and ``rank{r}.json`` in a fresh
    directory); a rank that fails or outlasts ``limit_s`` fails the
    phase, and every rank is stopped before this returns.  Returns the
    ranks' JSON results."""
    import tempfile
    workdir = tempfile.mkdtemp(prefix=f"{flag.strip('-')}_")
    logs = [open(Path(workdir, f"rank{r}.log"), "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), flag, str(r),
         "--rank-dir", workdir, "--rank-backend", backend, *extra],
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    failed = None
    try:
        deadline = time.perf_counter() + limit_s
        while any(pr.poll() is None for pr in procs) and failed is None:
            bad = [r for r, pr in enumerate(procs)
                   if pr.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
            elif time.perf_counter() > deadline:
                failed = f"ranks still running after {limit_s} s"
            else:
                time.sleep(0.2)
        if failed is None:
            bad = [r for r, pr in enumerate(procs) if pr.returncode != 0]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
            pr.wait()
        for f in logs:
            f.close()
    if failed is not None:
        tails = "\n".join(f"--- rank {r} ---\n" + Path(
            workdir, f"rank{r}.log").read_text()[-3000:]
            for r in range(world))
        check(False, f"{what}: {failed}\n{tails}")
    return [json.loads(Path(workdir, f"rank{r}.json").read_text())
            for r in range(world)]


def sharded_dlrm_phase(torch):
    """Phase 23: 4 ranks on a (2, 2) (data, model) grid, each a process
    running `sharded_rank` (this script with ``--sharded-rank``).  NCCL
    with one rank a card where 4 cards exist, else gloo with the tensors
    on the one card (staged through pinned host buffers).  The parent has
    built the kernel library, so no rank builds.  Returns (results,
    launches summed over ranks)."""
    backend = "nccl" if torch.cuda.device_count() >= 4 else "gloo"
    t_phase = time.perf_counter()
    world = SHARD_MESH[0] * SHARD_MESH[1]
    ranks = run_ranks("--sharded-rank", world, SHARD_PHASE_LIMIT_S,
                      "phase 23", backend)
    check(all(rk["losses"] == ranks[0]["losses"] for rk in ranks),
          "phase 23: the ranks' losses differ")
    launches = {k: sum(rk["launches"][k] for rk in ranks)
                for k in ranks[0]["launches"]}
    check("held" in ranks[0], "phase 23: rank 0 held no kernel")
    out = dict(backend=backend, world=world, mesh=list(SHARD_MESH),
               table_params=SHARD_TABLE_PARAMS, batch=DLRM_CHIP_BATCH,
               capacity_factor=SHARD_CAPACITY_FACTOR,
               cache_rows=SHARD_CACHE_ROWS, launches=launches,
               losses=ranks[0]["losses"],
               one_device_losses=ranks[0]["one_device_losses"],
               a2a_vs_one_device=ranks[0]["a2a_vs_one_device"],
               grad_worst_share=max(rk["grad_worst_share"] for rk in ranks
                                    if "grad_worst_share" in rk),
               held=ranks[0]["held"], ranks=ranks,
               phase_s=time.perf_counter() - t_phase)
    return out, launches


# Phase 24: data-parallel olmo-1b at its published width (d 2048, 16 heads
# of 128, d_ff 8192, vocab 50304, tied embeddings), depth cut to 2 layers
# (0.24e9 parameters: f32 params, gradient, m and v 3.8 GB a rank), so 4
# ranks share the one card over gloo; one 2048-token sequence a rank,
# phase 12's remat, xent chunks and Adam
DP_MESH = (4, 1)
DP_LAYERS = 2
DP_SHAPE = ("dp_2k", "train", 2048, 4)
DP_SCHEMES = ("none", "int8", "topk")
DP_WARM, DP_TIMED = 1, 2
DP_PHASE_LIMIT_S = 420
# the preemption over the ranks: reduced olmo-1b, rank 1 alone asks
DP_PREEMPT_SHAPE = ("t", "train", 64, 4)
DP_PREEMPT_STEPS, DP_PREEMPT_AT = 4, 2


def _tree_digest(torch, OPT, tree):
    h = hashlib.sha256()
    for x in OPT.leaves(tree):
        h.update(x.detach().reshape(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def exchange_log(torch, COMP):
    """While inside: the largest |g| of each leaf this rank hands to its
    first ``compressed_allreduce`` (``maxima``), and (numel, kept) of each
    exact-k selection (``topk``)."""
    fn, pick = COMP.compressed_allreduce, COMP._topk_index
    log = {"maxima": None, "topk": []}

    def spy(grads, *a, **k):
        if log["maxima"] is None:
            log["maxima"] = torch.stack([g.detach().float().abs().amax()
                                         for g in grads])
        return fn(grads, *a, **k)

    def count(flat, frac):
        idx = pick(flat, frac)
        log["topk"].append((flat.numel(), int(idx.numel())))
        return idx
    COMP.compressed_allreduce, COMP._topk_index = spy, count
    try:
        yield log
    finally:
        COMP.compressed_allreduce, COMP._topk_index = fn, pick


def dp_rank(rank, workdir, backend, dev_kind="cuda", cfg=None,
            shape=DP_SHAPE, layers=DP_LAYERS):
    """One rank of phase 24 (a process of its own).  Writes
    ``rank{rank}.json`` in ``workdir``; raises on any failed check.
    ``cfg``/``shape``: a smaller model for a rehearsal on the CPU;
    ``layers``: olmo-1b's depth (16 for the whole model on 4 cards)."""
    import datetime
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.configs.base import (OptimizerConfig, ParallelConfig,
                                          RunConfig, ShapeConfig)
    from repro_torch.data.synthetic import Dataset
    from repro_torch.launch import steps as STEPS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api
    from repro_torch.optim import adam as OPT
    from repro_torch.parallel import compression as COMP
    from repro_torch.parallel import context as PC
    from repro_torch.train.trainer import Trainer

    t_start = time.perf_counter()
    world = DP_MESH[0] * DP_MESH[1]
    card = dev_kind == "cuda"
    if card:
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        dev = torch.device("cpu")

    def sync():
        if card:
            torch.cuda.synchronize()

    def free():
        gc.collect()
        if card:
            torch.cuda.empty_cache()

    timeout = datetime.timedelta(seconds=SHARD_GROUP_TIMEOUT_S)
    dist.init_process_group(backend, store=dist.FileStore(
        str(Path(workdir) / "store"), world), rank=rank, world_size=world,
        timeout=timeout)
    ctx = PC.ParallelContext(mesh=make_mesh(DP_MESH, ("data", "model"),
                                            timeout=timeout))
    cfg = cfg or registry.get_config("olmo-1b").replace(num_layers=layers)
    base = _dense_run(cfg, RunConfig, ShapeConfig, ParallelConfig,
                      OptimizerConfig)
    base = base.replace(shape=ShapeConfig(*shape))
    out = dict(rank=rank, backend=backend, device=str(dev),
               start_s=time.perf_counter() - t_start, schemes={})
    first_none = first_loss = None
    for scheme in DP_SCHEMES:
        run = base.replace(parallel=dataclasses.replace(
            base.parallel, grad_compression=scheme))
        trainer = Trainer(run, device=dev, ctx=ctx)
        state = trainer.init_state()
        if card:
            torch.cuda.reset_peak_memory_stats()
        keep = (first_grads(torch, OPT) if rank == 0
                else contextlib.nullcontext([]))
        with keep as g_first, exchange_log(torch, COMP) as xlog:
            sync()
            t0 = time.perf_counter()
            state = trainer.train(DP_WARM, state=state, log_every=1)
            sync()
            t1, w1 = time.perf_counter(), PC.wire_bytes
            state = trainer.train(DP_WARM + DP_TIMED, state=state,
                                  log_every=1)
            sync()
            t2, w2 = time.perf_counter(), PC.wire_bytes
        m = trainer.metrics_log[-1]
        r = dict(losses=[x["loss"] for x in trainer.metrics_log],
                 warm_ms=(t1 - t0) * 1e3,
                 step_ms=(t2 - t1) * 1e3 / DP_TIMED,
                 step_wire_bytes=(w2 - w1) / DP_TIMED,
                 wire_bytes=m["wire_bytes"],
                 wire_bytes_full=m["wire_bytes_full"],
                 wire_overhead_bytes=m["wire_overhead_bytes"],
                 digest=_tree_digest(torch, OPT, state.params))
        if card:
            r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        check(all(math.isfinite(x) for x in r["losses"]),
              f"rank {rank} {scheme}: losses {r['losses']}")
        if scheme == "none":
            first_none, first_loss = g_first, r["losses"][0]
        elif scheme == "int8":
            check(r["wire_bytes_full"] / r["wire_bytes"] >= 3.9,
                  f"int8 wire cut {r['wire_bytes_full'] / r['wire_bytes']}")
            # each leaf's shared scale: its largest |g| over the ranks
            scales = ctx.all_reduce(xlog["maxima"], op="max") / 127.0
            if rank == 0:
                worst = 0.0
                for g8, g, sc in zip(g_first, first_none, scales.tolist()):
                    err = (g8 - g).abs().max().item()
                    check(err <= 0.51 * sc, f"int8 mean off the "
                          f"uncompressed mean by {err:.3e} > 0.51 x {sc:.3e}")
                    worst = max(worst, err / sc)
                r["int8_worst_scale_share"] = worst
        else:
            want = [(n, max(1, int(n * COMP.TOPK_FRAC)))
                    for n, _ in xlog["topk"]]
            check(xlog["topk"] == want and xlog["topk"],
                  f"rank {rank}: topk kept {xlog['topk']}, want {want}")
            r["topk_leaves"] = len(want)
        out["schemes"][scheme] = r
        del trainer, state, g_first
        free()
    out["schemes_s"] = time.perf_counter() - t_start

    # scheme none against one device accumulating the same four pieces
    # (piece i = rank i's sequence) from the same initial params
    if rank == 0:
        run = base
        params = api.init_params(cfg, seed=run.seed, device=dev,
                                 dtype=torch.float32)
        b0 = Dataset(cfg, run.shape, seed=run.seed).batch(0)
        acc = [None] * len(OPT.leaves(params))
        loss = 0.0
        for i in range(world):
            piece = {k: torch.as_tensor(v[i:i + 1], device=dev)
                     for k, v in b0.items()}
            mi = STEPS.accumulate_grad(cfg, run.parallel, params, piece, acc,
                                       1.0 / world)
            loss += float(mi["loss"]) / world
        check(_loss_near(first_loss, loss),
              f"DP loss {first_loss} vs one device {loss}")
        worst = 0.0
        for g, want in zip(first_none, acc):
            tol = LOGIT_REL_TOL * want.abs().max().item()
            err = (g - want).abs().max().item()
            check(err <= tol, f"DP gradient off one device's by {err:.4g} > "
                              f"{tol:.4g}")
            worst = max(worst, err / tol if tol else 0.0)
        out.update(one_device_loss=loss, grad_worst_share=worst)
        del params, acc
    del first_none
    free()

    # a preemption over the ranks (reduced config): rank 1 alone asks at
    # step DP_PREEMPT_AT, both stop there, the resume ends bitwise an
    # uninterrupted run's
    small = RunConfig(model=registry.get_reduced("olmo-1b"),
                      shape=ShapeConfig(*DP_PREEMPT_SHAPE),
                      parallel=ParallelConfig(grad_compression="int8"),
                      optimizer=OptimizerConfig(**SHARD_OPTIMIZER))
    ck = [str(Path(workdir) / n) for n in ("whole", "cut")]
    whole = Trainer(small, device=dev, ctx=ctx, ckpt_dir=ck[0]).train(
        DP_PREEMPT_STEPS)
    cut = Trainer(small, device=dev, ctx=ctx, ckpt_dir=ck[1])
    first = cut.train(DP_PREEMPT_STEPS, on_step=lambda s, _: (
        cut.request_preempt() if s == DP_PREEMPT_AT and rank == 1 else None))
    check(cut.preempted and first.step == DP_PREEMPT_AT,
          f"rank {rank}: preempted {cut.preempted} at {first.step}")
    last = Trainer(small, device=dev, ctx=ctx, ckpt_dir=ck[1]).train(
        DP_PREEMPT_STEPS)
    same = all(torch.equal(a, b) for a, b in zip(
        OPT.leaves([whole.params, whole.opt_state.mu, whole.opt_state.nu]),
        OPT.leaves([last.params, last.opt_state.mu, last.opt_state.nu])))
    check(same, f"rank {rank}: the resumed run is not bitwise the whole one")
    out["preempt_digest"] = _tree_digest(torch, OPT, last.params)
    out["rank_s"] = time.perf_counter() - t_start
    Path(workdir, f"rank{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()
    return 0


def dp_phase(torch, layers=DP_LAYERS):
    """Phase 24: 4 ranks on a (4, 1) (data, model) mesh, each a process
    running `dp_rank` (this script with ``--dp-rank``), NCCL with one rank
    a card where 4 cards exist, else gloo on the one card.  The ranks'
    params must be bitwise equal after each scheme's steps."""
    backend = "nccl" if torch.cuda.device_count() >= 4 else "gloo"
    t_phase = time.perf_counter()
    world = DP_MESH[0] * DP_MESH[1]
    ranks = run_ranks("--dp-rank", world, DP_PHASE_LIMIT_S, "phase 24",
                      backend, ("--dp-layers", str(layers)))
    for scheme in DP_SCHEMES:
        got = [rk["schemes"][scheme] for rk in ranks]
        check(len({g["digest"] for g in got}) == 1,
              f"phase 24 {scheme}: the ranks' params differ")
        check(all(g["losses"] == got[0]["losses"] for g in got),
              f"phase 24 {scheme}: the ranks' losses differ")
    check(len({rk["preempt_digest"] for rk in ranks}) == 1,
          "phase 24: the resumed ranks' params differ")
    r0 = ranks[0]
    schemes = {s: dict(r0["schemes"][s],
                       step_ms_ranks=[rk["schemes"][s]["step_ms"]
                                      for rk in ranks],
                       peak_gb_ranks=[rk["schemes"][s].get("peak_gb")
                                      for rk in ranks])
               for s in DP_SCHEMES}
    return dict(backend=backend, world=world, mesh=list(DP_MESH),
                layers=layers, shape=list(DP_SHAPE), schemes=schemes,
                one_device_loss=r0["one_device_loss"],
                grad_worst_share=r0["grad_worst_share"],
                rank_s=[rk["rank_s"] for rk in ranks],
                phase_s=time.perf_counter() - t_phase)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the results as JSON here")
    # phases 23 and 24's ranks: this script started once a rank
    ap.add_argument("--sharded-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--dp-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--dp-layers", type=int, default=DP_LAYERS,
                    help=argparse.SUPPRESS)
    ap.add_argument("--rank-dir", help=argparse.SUPPRESS)
    ap.add_argument("--rank-backend", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    if args.sharded_rank is not None:
        return sharded_rank(args.sharded_rank, args.rank_dir,
                            args.rank_backend)
    if args.dp_rank is not None:
        return dp_rank(args.dp_rank, args.rank_dir, args.rank_backend,
                       layers=args.dp_layers)
    import numpy as np
    import torch.nn.functional as F
    from repro_torch import cluster as CL
    from repro_torch import fleet as FLT
    from repro_torch.configs import registry
    from repro_torch.configs.base import (OptimizerConfig, ParallelConfig,
                                          RunConfig, ShapeConfig)
    from repro_torch.data.synthetic import Dataset
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.embeddings import dedup as DD
    from repro_torch.kernels import embedding_gather as EG
    from repro_torch.kernels import embedding_lookup as EL
    from repro_torch.kernels import embedding_scatter as ES
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_lookup as FL
    from repro_torch.kernels import fused_scatter as FS
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as REF
    from repro_torch.launch import steps as STEPS
    from repro_torch.models import api
    from repro_torch.models import dlrm as DL
    from repro_torch.models import moe as MOE
    from repro_torch.models import quant as QU
    from repro_torch.models import ssm as SSM
    from repro_torch.models import transformer as TF
    from repro_torch.optim import adam as OPT
    from repro_torch.serve import engine as engine_mod
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train.trainer import Trainer, TrainerState

    # the plain versions compute f32 products: keep TF32 out of them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip()
    check(smi.returncode == 0 and card, f"nvidia-smi failed: {smi.stderr}")
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    build.build(verbose=True)
    build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    log(build.build_log.strip())

    decode = decode_phase(torch, F, DA, REF)
    log("decode kernel:", json.dumps(decode))
    pooled = pooled_kernel_phase(torch, np, F, DA, REF, QU, ops)
    for n in ("bt", "q8", "bt_q8"):
        log(f"{pooled[n]['name']} kernel:", json.dumps(pooled[n]))
    log("pooled decode yardstick:", json.dumps(pooled["yardstick"]))
    gc.collect()
    torch.cuda.empty_cache()
    prefill = prefill_phase(torch, F, FA, REF)
    log("prefill kernel:", json.dumps(prefill))
    worst = reference_phase(torch, registry, api, TF)
    log(f"reference: card vs CPU logits differ by at most {worst[1]:.3e} "
        f"(tolerance {worst[2]:.3e} at that step)")
    # the MoE family first, while the card is empty (61 GB of weights)
    gc.collect()
    torch.cuda.empty_cache()
    moe, moe_launches = moe_phase(torch, np, F, registry, api, engine_mod,
                                  DA, FA, REF, MOE, TF)
    log("moe:", json.dumps(moe))
    gc.collect()                    # its 61 GB of weights
    torch.cuda.empty_cache()
    moe_train, moe_train_launches = moe_training_phases(
        torch, np, F, registry, api, Dataset, CL, STEPS, OPT, MOE,
        TrainerState, RunConfig, ShapeConfig, ParallelConfig,
        OptimizerConfig, engine_mod, DA, FA)
    log("moe training:", json.dumps(moe_train))
    gc.collect()                    # its 49.8 GB of training state
    torch.cuda.empty_cache()
    ssm, hymba_launches = ssm_phase(torch, np, F, registry, api, engine_mod,
                                    DA, FA, REF, TF)
    log("ssm and hybrid:", json.dumps(ssm))
    gc.collect()
    torch.cuda.empty_cache()
    ssm_train, hymba_train_launches = ssm_training_phases(
        torch, np, registry, api, Dataset, CL, STEPS, OPT, SSM, TrainerState,
        RunConfig, ShapeConfig, ParallelConfig, OptimizerConfig, engine_mod,
        DA, FA)
    log("ssm and hybrid training:", json.dumps(ssm_train))
    gc.collect()
    torch.cuda.empty_cache()
    dense_var, dense_var_launches = dense_variants_phase(
        torch, np, F, registry, api, engine_mod, DA, FA, REF, QU, ops, TF)
    log("dense variants:", json.dumps(dense_var))
    gc.collect()
    torch.cuda.empty_cache()
    audio_vlm, audio_vlm_launches = audio_vlm_phase(
        torch, np, F, registry, api, engine_mod, DA, FA, REF, TF)
    log("whisper and internvl:", json.dumps(audio_vlm))
    gc.collect()
    torch.cuda.empty_cache()
    examples, examples_launches = examples_phase(
        torch, np, registry, api, DA, FA, FL, EG, FS, REF, STEPS, OPT,
        TrainerState, ShapeConfig, ParallelConfig, OptimizerConfig)
    log("examples' twins:", json.dumps(examples))
    gc.collect()
    torch.cuda.empty_cache()
    sharded, sharded_launches = sharded_dlrm_phase(torch)
    log(f"sharded dlrm ({sharded['backend']}, {sharded['world']} ranks on "
        f"{sharded['mesh']}):", json.dumps(sharded))
    dp = dp_phase(torch)
    log(f"data-parallel olmo-1b ({dp['backend']}, {dp['world']} ranks on "
        f"{dp['mesh']}):", json.dumps(dp))
    stats, launches = serve_phase(torch, np, registry.get_config("olmo-1b"),
                                  api, engine_mod, DA, FA)
    log("serve:", json.dumps(stats))
    gc.collect()                    # the serve phase's weights and caches
    torch.cuda.empty_cache()
    pool_stats, pool_launches = pooled_decode_phase(
        torch, np, registry.get_config("olmo-1b"), api, TF, DA)
    log("pooled decode:", json.dumps(pool_stats))
    gc.collect()                    # its weights and pools
    torch.cuda.empty_cache()
    kv_engine, kv_launches = pooled_engine_phase(
        torch, np, registry.get_config("olmo-1b"), api, engine_mod, DA, FA)
    log("pooled engine:", json.dumps(kv_engine))
    gc.collect()
    torch.cuda.empty_cache()
    int8_engine, int8_launches = int8_engine_phase(
        torch, np, registry.get_config("olmo-1b"), api, engine_mod, QU, DA,
        FA)
    log("int8 engine:", json.dumps(int8_engine))
    gc.collect()
    torch.cuda.empty_cache()

    dlrm_kern, dlrm_stats, dlrm_launches, int8 = dlrm_phases(
        torch, F, registry, api, DL, ShapeConfig, FL, EG, EL, ES, QU, REF,
        ops)
    gc.collect()                    # the scoring phase's 48 GB of tables
    torch.cuda.empty_cache()

    grad_worst, adam_err = dlrm_train_reference_phase(
        torch, registry, api, ShapeConfig, ParallelConfig, OptimizerConfig,
        STEPS, OPT, FS, EG)
    log(f"dlrm training reference: card vs CPU gradients (both routes) and "
        f"per-table vs fused differ by at most {grad_worst[1]:.3e} "
        f"(tolerance {grad_worst[2]:.3e} at that leaf); Adam on the same "
        f"gradients by {adam_err:.3e}")
    log(f"fused scatter, small cases: max |kernel - plain| "
        f"{scatter_small_cases(torch, FS, REF):.3e}; bitwise the CPU's "
        f"sequential sum; two launches bitwise equal")
    tcfg = dlrm0_cut(registry, TRAIN_TABLE_PARAMS)
    tcoll = DL.collection_for(tcfg)
    scatter = {}
    for B in (DLRM_CHIP_BATCH, TRAIN_BATCH):
        scatter[B], dedup = scatter_kernel_phase(
            torch, tcfg, tcoll, Dataset, ShapeConfig, FS, REF, B,
            dedup=(ES, DD, ops) if B == TRAIN_BATCH else None)
        log(f"fused scatter at B={B}:", json.dumps(scatter[B]))
        gc.collect()
        torch.cuda.empty_cache()
    log(f"scatter of deduplicated ids at B={TRAIN_BATCH}:", json.dumps(dedup))
    train_stats, train_launches = train_phase(
        torch, tcfg, ShapeConfig, RunConfig, ParallelConfig, OptimizerConfig,
        Trainer, STEPS, OPT, FL, FS)
    train_stats["emb_params"] = sum(t.vocab_size * t.dim
                                    for t in tcfg.dlrm.tables)
    train_stats["launches"] = train_launches
    log("dlrm training:", json.dumps(train_stats))
    gc.collect()                    # the trainer's 64 GB of state
    torch.cuda.empty_cache()
    per_table = per_table_train_phase(
        torch, tcfg, ShapeConfig, RunConfig, ParallelConfig, OptimizerConfig,
        Trainer, FL, EG, FS)
    log("dlrm training, per-table route:", json.dumps(per_table))
    gc.collect()                    # its 64 GB of state
    torch.cuda.empty_cache()
    dense, dense_launches = dense_train_phase(
        torch, np, registry.get_config("olmo-1b"), CL, CKPT, RunConfig,
        ShapeConfig, ParallelConfig, OptimizerConfig, Trainer, STEPS, OPT,
        api, engine_mod, DA, FA)
    log("dense training:", json.dumps(dense))
    gc.collect()
    torch.cuda.empty_cache()
    drill = fault_drill_phase(
        torch, registry.get_config("olmo-1b"), CL, RunConfig, ShapeConfig,
        ParallelConfig, OptimizerConfig, STEPS, OPT)
    log("fault drill:", json.dumps(drill))
    gc.collect()
    torch.cuda.empty_cache()
    olmo = registry.get_config("olmo-1b").replace(num_layers=FLEET_LAYERS)
    fleet, fleet_launches, olmo_params = fleet_phase(
        torch, np, olmo, api, CL, FLT, engine_mod, DA, FA, REF)
    log("fleet:", json.dumps({k: v for k, v in fleet.items() if k != "log"}))
    gc.collect()
    torch.cuda.empty_cache()
    mixed, mixed_launches = tenancy_phase(
        torch, np, olmo, _dense_run(olmo.replace(num_layers=DRILL_LAYERS),
                                    RunConfig, ShapeConfig, ParallelConfig,
                                    OptimizerConfig),
        olmo_params, api, CL, FLT, Trainer, OPT, engine_mod, DA, FA)
    del olmo_params
    log("mixed tenancy:", json.dumps({k: v for k, v in mixed.items()
                                      if k != "job_log"}))

    decode["launches"] = launches["paged_decode_attention"]
    # the engine paths beside the serve phase's: each counted on its own
    decode["launches_pooled_engine"] = kv_launches["share"][
        "paged_decode_attention"]
    decode["launches_int8_engine"] = int8_launches["paged_decode_attention"]
    pooled["bt"]["launches"] = pool_launches["paged_decode_attention_bt"]
    prefill["launches"] = launches["flash_attention"]
    # the trained weights served after dense training
    decode["launches_trained_serve"] = dense_launches[
        "paged_decode_attention"]
    prefill["launches_trained_serve"] = dense_launches["flash_attention"]
    prefill["launches_int8_engine"] = int8_launches["flash_attention"]
    # the fleet's replicas, and the fleet beside the training tenant
    decode["launches_fleet"] = fleet_launches["paged_decode_attention"]
    prefill["launches_fleet"] = fleet_launches["flash_attention"]
    decode["launches_mixed"] = mixed_launches["paged_decode_attention"]
    prefill["launches_mixed"] = mixed_launches["flash_attention"]
    # full-width qwen3-moe served (H = 32 over KH = 4)
    decode["launches_moe"] = moe_launches["paged_decode_attention"]
    prefill["launches_moe"] = moe_launches["flash_attention"]
    # the trained 4-layer qwen3-moe served
    decode["launches_moe_trained"] = moe_train_launches[
        "paged_decode_attention"]
    prefill["launches_moe_trained"] = moe_train_launches["flash_attention"]
    # full-width hymba-1.5b served (H = 25 over KH = 5, window 1024)
    decode["launches_hymba"] = hymba_launches["paged_decode_attention"]
    prefill["launches_hymba"] = hymba_launches["flash_attention"]
    # the trained full-width hymba-1.5b served
    decode["launches_hymba_trained"] = hymba_train_launches[
        "paged_decode_attention"]
    prefill["launches_hymba_trained"] = hymba_train_launches[
        "flash_attention"]
    # full-width qwen2-7b (GQA 7) and mistral-nemo-12b served (d = 128)
    for arch, key in (("qwen2-7b", "launches_qwen2"),
                      ("mistral-nemo-12b", "launches_nemo")):
        decode[key] = dense_var_launches[arch]["paged_decode_attention"]
        prefill[key] = dense_var_launches[arch]["flash_attention"]
    # full-width whisper-small (the legacy path: row 2 on the encoder, the
    # decoder and the cross-attention, row 1 on self and cross) and
    # internvl2-2b (G = 2 over a 1024-patch prefix) served
    for arch, key in ((WHISPER_ARCH, "launches_whisper"),
                      (VLM_ARCH, "launches_internvl")):
        decode[key] = audio_vlm_launches[arch]["paged_decode_attention"]
        prefill[key] = audio_vlm_launches[arch]["flash_attention"]
    # the d = 256 instantiations: rows 1 and 2 counted in full-width
    # gemma2-9b's serving run, rows 1q, 3 and 3q in phase 20's ops calls;
    # times at gemma2's local layers (window 4096, softcap 50), the global
    # layers' beside them; SDPA has no softcap (library_ms null), so its
    # time on the same shapes without one is a yardstick only
    g2, g2_launches = (dense_var["kernels"],
                       dense_var_launches["gemma2-9b"])
    d256 = []
    for row, name, line in (("1", "paged_decode_attention", 112),
                            ("1q", "paged_decode_attention_q8", 100),
                            ("3", "paged_decode_attention_bt", 217),
                            ("3q", "paged_decode_attention_bt_q8", 210)):
        k, kg = g2["decode"][f"{row}_window"], g2["decode"][f"{row}_global"]
        d256.append(dict(
            name=f"{name}_d256", route="cuda",
            source="src/repro_torch/kernels/csrc/decode_attention.cu",
            replaces=f"src/repro/kernels/decode_attention.py:{line}",
            launches=(g2_launches["paged_decode_attention"] if row == "1"
                      else k["launches"]),
            max_abs_err=max(k["max_abs_err"], kg["max_abs_err"]),
            ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=None, ms_global=kg["ms"],
            sdpa_no_softcap_ms=k["sdpa_no_softcap_ms"]))
    d256[0]["launches_gemma2"] = d256[0]["launches"]
    k = g2["prefill"]["gemma2_B8"]
    d256.append(dict(
        name="flash_attention_d256", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:86",
        launches=g2_launches["flash_attention"],
        launches_gemma2=g2_launches["flash_attention"],
        max_abs_err=max(c["max_abs_err"] for n, c in g2["prefill"].items()
                        if n.startswith("gemma2")),
        ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
        bound_by=k["bound_by"], library_ms=None,
        sdpa_no_softcap_ms=k["sdpa_no_softcap_ms"]))
    # the serve_lm twin: full-width olmo-1b and reduced whisper-small
    for name in ("serve_lm", "serve_lm_whisper"):
        decode[f"launches_{name}"] = examples_launches[name][
            "paged_decode_attention"]
        prefill[f"launches_{name}"] = examples_launches[name][
            "flash_attention"]
    fused, gather = (dlrm_kern[DLRM_BATCH][n]
                     for n in ("fused_lookup", "embedding_gather"))
    fused["launches"] = dlrm_launches["fused_lookup"]
    gather["launches"] = dlrm_launches["embedding_gather"]
    scat = scatter[TRAIN_BATCH]
    scat["launches"] = train_launches["fused_scatter"]
    # the train_dlrm twin's demo, fused and per-table
    fused["launches_train_dlrm"] = examples_launches["train_dlrm"][
        "fused_lookup"]
    gather["launches_train_dlrm_pergroup"] = examples_launches[
        "train_dlrm_pergroup"]["embedding_gather"]
    for name in ("train_dlrm", "train_dlrm_pergroup"):
        scat[f"launches_{name}"] = examples_launches[name]["fused_scatter"]
    # phase 23's 3 train steps over the 2 x 2 grid, summed over the ranks
    fused["launches_sharded_dlrm"] = sharded_launches["fused_lookup"]
    gather["launches_sharded_dlrm"] = sharded_launches["embedding_gather"]
    scat["launches_sharded_dlrm"] = sharded_launches["fused_scatter"]
    # the fused scatter's key and hot-run kernels, one each a run kernel
    scat["launches_hot"] = train_launches["fused_scatter_hot"]
    scat["launches_keys"] = train_launches["fused_scatter_keys"]
    lookup = dict(dlrm_kern[DLRM_BATCH]["embedding_lookup"])
    lookup["launches"] = sum(k["embedding_lookup"]["launches"]
                             for k in dlrm_kern.values())
    qlookup = dict(int8[DLRM_BATCH], launches=int8["launches"])
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    more = ("launches_hot", "launches_keys", "launches_pooled_engine",
            "launches_int8_engine", "launches_trained_serve",
            "launches_fleet", "launches_mixed", "launches_moe",
            "launches_moe_trained", "launches_hymba",
            "launches_hymba_trained", "launches_qwen2", "launches_nemo",
            "launches_gemma2", "launches_whisper", "launches_internvl",
            "launches_serve_lm", "launches_serve_lm_whisper",
            "launches_train_dlrm", "launches_train_dlrm_pergroup",
            "launches_sharded_dlrm")
    extra = ("ms_global", "sdpa_no_softcap_ms")
    kernels = {"kernels": [{k: kern[k] for k in keys}
                           | {k: kern[k] for k in more + extra if k in kern}
                           for kern in (decode, pooled["q8"], pooled["bt"],
                                        pooled["bt_q8"], prefill, fused,
                                        gather, scat, lookup, dedup,
                                        qlookup, *d256)]}
    check(all(k[n] > 0 for k in kernels["kernels"] for n in
              ("launches",) + more if n in k),
          f"a kernel was not launched on its path: {kernels}")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            dict(card=card, serve=stats, reference_worst=worst,
                 pooled_kernels=pooled, pooled_decode=pool_stats,
                 pooled_engine=kv_engine, int8_engine=int8_engine,
                 build_s=build.build_seconds, dlrm_scoring=dlrm_stats,
                 dlrm_kernels={str(b): v for b, v in dlrm_kern.items()},
                 dlrm_training=train_stats,
                 train_reference={"grad_worst": grad_worst,
                                  "adam_err": adam_err},
                 fused_scatter={str(b): v for b, v in scatter.items()},
                 dedup_scatter=dedup,
                 int8_lookup={str(b): v for b, v in int8.items()},
                 per_table_training=per_table,
                 dense_training=dense, fault_drill=drill,
                 fleet=fleet, mixed_tenancy=mixed, moe=moe,
                 moe_training=moe_train, ssm=ssm, ssm_training=ssm_train,
                 dense_variants=dense_var, audio_vlm=audio_vlm,
                 examples=examples, sharded_dlrm=sharded,
                 data_parallel=dp,
                 script_s=time.perf_counter() - _T0,
                 **kernels),
            indent=2))
    log(f"script: {time.perf_counter() - _T0:.1f} s")
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
