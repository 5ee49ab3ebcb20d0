"""On-card smoke run of the PyTorch port (deepspeed_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each printing one JSON line (any failure raises and exits non-zero):

1. device    — nvidia-smi's name and power limit; builds the CUDA kernels
               from deepspeed_tpu_torch/csrc (nvcc, sm_90a) and times it;
               counts HGMMA (wgmma) and HMMA (mma.sync) in the SASS of the
               flash kernels (cuobjdump): each must issue HGMMA, none HMMA;
               and in each 16-bit instantiation of the GQA flash-decode
               kernel and of the int8 matmul's tensor-core body (kernel 2
               at 128 columns, the gridded form at 32 and 64): each must
               issue HMMA (or HGMMA).
2. kernels   — each hand-written kernel against its plain PyTorch version on
               the card at the serving path's full LLaMA-7B shapes (fused
               decode step: 8 slots x 32 heads x Dh 128 x S 1024, per-slot
               lengths incl. 0, S-1 and S, plus a GQA rep-4 case; block
               decode step: the same slots over a pool of 16-token blocks
               through a permuted 64-wide table, lengths incl. 0, 15, 16,
               1023 and an inactive slot on a sentinel table, pools in bf16,
               int8 and fp8, plus GQA rep 4; int8 matmul: the three block
               shapes at N in {1, 8, 32}, stacked, last layer, in bf16, fp16
               and f32, each row bit-identical at batch 1 and run to run,
               timed in bf16 beside torch._weight_int8pack_mm and a bf16
               torch.matmul of the same values). Written
               cache bytes must be bit-identical (block pools: every row but
               the garbage row); decode outputs are held row by row
               (kernel_check.rel_err, 2e-2 in bf16) and both decode steps
               (split along the cache, then merged) repeat bit for bit.
               The block decode step also at its split edges (idx 63, 64,
               255, 256, 1023, two overflow slots whose garbage rows are
               compared, every pool type and Hkv), replayed from a CUDA
               graph bit for bit. Kernel rows carry bound_share (bound / kernel time)
               and vs_library (kernel / library time). Times are device
               times: 20 launches on
               inputs rotated through more than the 50 MB L2 are captured in
               a CUDA graph, whose replay is timed with CUDA events (median
               of 20).
3. reference — a small LLaMA served by the port on the CPU (plain versions)
               and on the card (kernels), fp32 with and without int8 block
               weights: identical greedy tokens. Then block-paged with a
               prefix cache on a shared-prefix trace (templates of 41
               tokens, so hits fork a block), cold and warm, with the pool in
               fp32, int8 and fp8: CPU and card tokens identical, fp32 pool
               tokens identical to slot-paged serving.
4. serve_bf16 / 5. serve_int8 — LLaMA-7B at full width and depth (random
               weights from a seeded torch.Generator) behind ServingEngine
               (8 slots, max_len 1024, buckets 128/512), 12 requests from a
               seeded trace. Every request finishes with its full token
               count; the launch counters, zeroed just before the run, equal
               32 x decode_steps (fused decode) and 7 x 32 x decode_steps
               (int8 matmul, int8 only); one request re-served alone gives
               bit-identical tokens; the probe's logits, recomputed by a
               plain no-cache forward and by a cached replay through the
               kernels, agree, and agree with its served tokens on
               margin-safe steps; a profile of five decode steps, with
               every slot holding a live request, gives the device's busy
               share and its top kernels.
   serve_block_bf16 / serve_block_kv_int8 — phase 4's bf16 engine behind a
               block-paged ServingEngine with a prefix cache (16-token
               blocks; pool in bf16, then int8), 16 requests over 2 shared
               392-token templates, served cold and then warm. Launches: 32
               x decode_steps of the block decode step and none of the slot
               one; the warm run prefills at most 0.4 x the cold run's
               tokens; forks taken; the probe check on the longest request,
               replayed through the same pool type; the decode profile,
               its slots on real block tables.
   serve_preempt_chunked — phase 4's bf16 engine (LLaMA-7B) greedy with
               chunked prefill (buckets 128 / 512, a 512-token budget)
               and priority preemption with host KV swap, 8 slots,
               max_len 2048: 8 class-1 requests at t = 0 (prompts
               1100-1800, 128 new tokens), a burst of 12 class-0 ones at
               0.5 s (prompts 16-200, 32-64 new), seeded; slot-paged in
               bf16 (kernel B), then block-paged over an int8 pool of 480
               blocks, which binds before the slots (kernel C). Each run:
               every request finishes; the decode kernel launches 32 x
               decode steps (the chunk and swap programs launch none); at
               least one preemption and the swap buffer drained; every
               program one entry, no recompile; each request's tokens
               equal its solo run on an engine of the same shapes (through
               16 tokens past its last preemption, at least 16); on a
               virtual clock (outputs cut to 24 tokens), replayed tokens
               equal the eager closure's, greedy and sampled (temperature
               0.8, top-p 0.9), and the sampled run repeats. Reported:
               TTFT and TPOT by class, swap traffic and peak host bytes,
               and the same trace on a monolithic engine (buckets 128 /
               512 / 2048, no budget, no preemption).
   serve_telemetry — the serving control plane on phase 4's bf16 engine:
               serve_preempt_chunked's trace (outputs cut to 24 tokens) on
               its virtual clock, over its int8 block pool with the prefix
               cache, armed with slo= (a TTFT page rule the class-1 prompts
               make fire, an availability SLI), tenants=True (one tenant
               per class), a span tracer and a flight recorder, twice.
               Held: tokens equal the bare run's; the tenants' decode
               tokens sum to the tokens served; both replays give one
               alert timeline, with a page alert and a flight dump
               written at it; the block decode step launches 32 x decode
               steps; record_attribution() has a row for every program of
               program_cache_sizes() and none reads above 1.05 of its
               roof. Reported: every row (analytic FLOPs and bytes over
               host wall, telemetry/attribution.py), the tenants' totals.
               JSONL and dumps under build/telemetry/.
   serve_fabric — the serving fabric on phase 4's bf16 engine, through
               run_twin: 3 slot-paged replicas (8 slots, max_len 384,
               buckets 128 / 384) over the one engine, the autoscaler
               armed (2-4 replicas), 48 seeded requests of 3 tenants
               (prompts 24-300, 32-64 new tokens) on the twin's virtual
               clock, a crash of r1, three flaky steps that trip r0's
               breaker, a straggle of r2 that the per-attempt timeout
               cuts; twice. Held: nothing failed; every stream equals its
               tokens; one fingerprint over both runs; each resumed
               request's tokens are the tokens committed before its last
               attempt followed by a fault-free engine's run of that
               attempt (bf16); no recompile; the decode kernel launched
               32 x (decode steps + warm-up captures) over every replica
               built; card bytes after the fabric is dropped within 1 GiB
               of those before. Reported: each replica's warm-up (graph
               capture) ms, host ms per replica step, the counters, the
               alert and scale timelines.
   serve_spec — speculative decoding on phase 4's bf16 engine (runs a-c2)
               and phase 5's int8 engine (runs d, d2), 8 slots, max_len
               1024, adaptive k: (a) self-drafting (120-token window,
               k-buckets 2/4/8) and (b) a TinyLlama-1.1B-shaped draft model
               (random weights; kernel B at Dh 64, rep 8) on 16 Poisson
               requests (prompts 16-64, 48 new tokens); (c) n-gram over an
               int8 block pool with the prefix cache and (d) n-gram at
               k-bucket 2 on the int8 engine (kernel 2 at 24 rows), on 16
               templated requests, and (c2, d2) the same stores and trace
               self-drafting (prompt lookup seldom drafts on a random
               model; these emit accepted blocks). Each run: every request
               finishes; verify steps and drafts happen; the decode kernel
               launches layers x plain steps (+ draft layers x rollout
               steps), kernel 2 7 x layers x steps on the int8 engine (+ 7
               x layers x rollout steps of an int8 draft); one entry a
               program, each verify and draft graph captured once; the
               probe; a self-drafting run emits a multi-token block, and
               (a) accepts at least half its drafts. Runs (a) and (c2) on
               virtual clocks: replayed tokens equal the eager closures',
               greedy and sampled, the sampled run repeating; (c2)
               tracer-armed tokens equal bare ones. The kernels phase adds
               kernel B at both drafts' rollouts (B 8, S 128: 32 / 4 heads
               at Dh 64, 32 / 32 at Dh 128) and kernel 2 at 24 rows; the
               reference phase, n-gram and draft-model speculation on the
               small fp32 LLaMA, slot- and block-paged, whose tokens equal
               the plain engine's and the CPU's.
6. probe_fp32 — LLaMA-7B at full width and 4 of its 32 layers in fp32: the
               trace's longest request served alone,
               its kernel-cached replay held to the no-cache forward within
               1e-3 of max |logit|, and its served tokens to the replay.
               Then block-paged: template + suffix A served cold, then the
               probe, template + suffix B, warm (a suffix-only prefill over
               shared blocks plus a fork), held the same way. Then
               serve_spec's self-drafting on this engine (runs e, e2:
               slot-paged and over an fp32 block pool), each accepting at
               least 0.9 of its drafts: in fp32 the draft computes the
               target's own function. Last, a twin run of 2 replicas with
               a crash serves the tokens of a fault-free pool of 2.

Training (phases added after ``reference``, before the serving phases):

   kernels (flash) — the FlashAttention-2 kernels (forward; backward dQ;
               backward dK/dV) against their plain versions: bf16 at the
               GPT-2 774M training shape (B 8, H 20, T 1024, Dh 64) and at
               Dh 128 (B 4, H 16, T 2048), causal and not, f32 at a
               small ragged shape, bf16 at the 774M width with ragged
               T 1000 (causal), and bf16 untimed at TinyLlama-1.1B's
               training shape (B 4, H 32, T 2048, Dh 64, causal). O and lse, then dQ/dK/dV from a fixed dO
               (each row within 2e-2 of its own max |x| in bf16, 1e-4 in
               f32: kernel_check.rel_err; lse within 1e-4 absolute);
               O, lse and dQ/dK/dV bit-identical across two launches, and
               dQ/dK/dV replayed from a CUDA graph bit for bit. Kernel,
               plain and SDPA (forward, backward, forward+backward) times,
               each captured in a CUDA graph; the bwd row holds E + F
               against SDPA's backward.
   reference_train — a small fp32 GPT-2 (2 layers, hidden 256, 4 heads of
               Dh 64, vocab 2048, T 128, attn_impl="flash",
               compute_dtype=float32) trained 4 steps (gas 2, AdamW,
               clipping, WarmupLR) by initialize() on the CPU (plain
               versions) and on the card (kernels) from one init and the
               same batches: loss and grad norm per step within 1e-4
               relative, parameters within 2 x lr x steps with at most 0.1%
               of elements off by more than 1e-5; each flash kernel
               launches layers x micro-steps = 16 times on the card, none
               on the CPU.
   train_774m — GPT-2 774M at full width and depth (random init, seed 0),
               attn_impl="flash", through initialize() with bench.py's
               774M config dict (bf16, AdamW lr 1e-4 wd 0.01, clipping 1.0,
               ZeRO 0, grad_accum_dtype bf16), micro-batch 8 x gas 2 x T
               1024 of arithmetic sequences: 2 warm-up and 8 measured steps.
               The loss is finite and falls; each flash kernel launches
               36 x 2 x 8 times in the measured steps; the first batch's
               loss through attn_impl="dense" on the same parameters
               agrees within 1e-3 (the model's flash route at full width).
               Tokens/s, ms per step, achieved TFLOP/s (6N + 12 L h T per
               token, GPT2Model.flops_per_token(T)), peak memory, and a
               profile of one step (device busy share, top kernels, the
               flash kernels' ms per step).
   train_774m_telemetry — a second 774M engine (after the first is
               freed), the same config, seed and batches plus a telemetry
               section (JSONL sink, sync_interval 4, spans, the flight
               recorder) and wall_clock_breakdown: 2 + 8 steps. Held:
               flash launches, losses within 1e-3 of the bare run's and
               falling, train/tokens_per_sec within 5% of the bare run's
               tokens/s and train/mfu x 989 within 5% of its TFLOP/s,
               two step-window spans. Reported: armed over bare ms per
               step, the train step's roofline row, and 2 more steps'
               forward / backward / optimizer step / batch ms on the
               wall-clock timers (CUDA events).
   train_774m (end) — one step with GPT2Config(loss_chunk=128) and one
               without, on the same batch from the same state (the
               engine's state copied): losses within 1e-5 relative, the
               global grad norms within 2^-8 relative and the updated wte
               within 2^-7 of the update's norm (the chunked backward's
               gradient of wte against autograd's), the ms and peak memory
               of each step.
   kernels (flash precise) — the three f32-precise flash kernels
               (csrc/flash_precise.cu, DSTPU_FLASH_F32_PRECISE=1) against
               their plain versions with p and dS in f32, row by row
               (1e-4 plus one ulp of a 16-bit output: 2^-7 bf16, 2^-10
               fp16; lse 1e-4 absolute), the backward bit for bit across
               launches, at the 774M and Dh 128 / T 2048 shapes in bf16,
               causal and not, and untimed rows at TinyLlama's shape (B·H
               128, T 2048, Dh 64, causal), in fp16 and f32, and ragged. On
               16-bit inputs each row also runs the default kernels D, E, F
               end to end beside the precise ones, and holds the precise
               outputs nearer an f64 evaluation (mean error over every
               element at most 1/1.1 of the default's: the kernels keep p
               and dS in f32). Times beside the plain versions and SDPA on
               f32 copies; bounds with q.k^T and dO.v^T at the 16-bit
               tensor rate and the f32-operand products at the f32
               CUDA-core rate, and f32_floor_ms with every product at the
               latter.
   train_tinyllama — TinyLlama-1.1B at full width and depth (its
               config.json; random init) through initialize() in bf16
               (AdamW, ZeRO 0, bench.py's 774M settings), attn flash,
               micro-batch 4 x gas 2 x T 2048: the first micro-batch's loss
               through flash and dense attention within 1e-3, then remat
               off, "nothing" and "save_attn" on one engine, one warm-up
               and 4 measured steps each: ms a step, tokens/s, MFU
               (LlamaModel.flops_per_token(T)), peak memory; kernel D
               launches 2 x 22 x gas a step under "nothing" and 22 x gas
               otherwise, E and F 22 x gas; the loss falls; peak memory
               under "nothing" below remat off. Then two steps under
               DSTPU_FLASH_F32_PRECISE=1: only the precise kernels launch
               (22 x gas x 2 each), the first batch's loss within 1e-3 of
               the default mode's.
   checkpoint_roundtrip — TinyLlama width at 1 of its 22 layers (0.18 B
               parameters), trained as above: a 3-step stretch replayed
               from a copy of the same state (bit-identical, or the spread
               held below), save_checkpoint at step 3 and 3 more steps; a
               fresh engine's load_checkpoint and the same 3 steps give the
               same losses; its tag at step 6, truncated, makes the next
               load walk back to step 3; init_inference(config=
               {"checkpoint": dir}) at batch 2 generates the tokens that
               the engine's in-memory parameters generate (kernel B).
               Save and load seconds, bytes written; the directory is
               temporary.
   train_774m_resilience — training resilience (after
               checkpoint_roundtrip): GPT-2 774M width at 2 of its 36
               layers (a tag ~1.3 GB), bf16, micro-batch 8 x gas 2 x T
               1024, the data through initialize(training_data=...) and
               train_batch(). (a) resilience armed, checkpoint_interval 4:
               flip_param_bit flips the top exponent bit of an f32 master
               element after steps 6 and 13, the newest tag truncated
               before the second rewind: the rewind log is the protocol's
               (nonfinite at 7 and 14, rewound to 4 and to 8 past the
               corrupt tag, gas x (anomaly - rewound + 1) batches
               skipped), the resilience counters agree, and the final
               masters, moments and counters equal a clean run's that
               skipped the same batches, bit for bit. (c) that clean run
               takes a deferred preemption after step 5: exit code 101 at
               the next step boundary, the run going on; a fresh engine
               resumes from the tag bit-identical to it through step 8.
               (b) the step-replay probe every 2 steps, its first second
               replay perturbed by one bit: a replay anomaly, a rewind
               skipping nothing, the next probe ok, the state at step 2
               bit-identical to the clean run's. Reported: an armed quiet
               step over an unarmed one, save / load / recovery ms, the
               probe's clone / step / digest ms.
   train_llama7b_offload — ZeRO-Offload and ZeRO-Infinity (after
               train_774m_resilience). The host's nproc, MemTotal and the
               free space where the swap files go; the host kernels' build
               flags. (a) LLaMA-7B width at 1 layer (0.47 B parameters),
               one seeded init and 2 batches (micro-batch 1 x gas 2 x T
               2048, bf16, AdamW, clipping 1.0, flash) through three
               engines: device-state ZeRO 0, offload_optimizer cpu at
               stage 2 and nvme at stage 3 (swap files under
               build/nvme_swap). The first loss is bit-identical across
               the three; cpu against device: the loss and grad norm of
               step 2 within 1e-3 relative, the images after step 2
               within 1e-2 row by row (kernel_check.rel_err); nvme against
               cpu: losses, grad norms and images bit-identical; each
               flash kernel launches layers x gas x 2 times a run. NVMe
               bytes read and written a step. (b) LLaMA-7B's widths at 24
               of its 32 layers (5.1 B parameters; fewer only if the
               host's MemAvailable cannot hold 12 bytes a parameter of f32
               state plus a margin, the cut recorded), offload_optimizer
               cpu, stage 2, remat
               "nothing", the same batch shape: one warm-up and one
               measured step on a fixed batch. Held: the loss falls; the engine
               adds only the bf16 images to the card's allocation, after
               init and between steps (memory_stats: at most 2 bytes a
               parameter plus 1 GiB over what was allocated before it), peak
               below 80 GB; the staging slots pinned; kernel D launches 2
               x layers x gas a step, E and F layers x gas. Reported: ms a
               step split into forward, backward, grad download wait, host
               Adam and image upload wait; host Adam GB/s over the bytes
               it sweeps; tokens/s and MFU (LlamaModel.flops_per_token);
               peak card memory and peak host RSS; the OpenMP team size.
   train_774m_data_efficiency — GPT-2 774M (attn flash, bench.py's 774M
               config, micro-batch 8 x gas 2 x T 1024; after
               train_774m_telemetry) through initialize() in three runs of
               1 warm-up and 3 measured steps, each on a fresh engine:
               (a) random-LTD keeping 512 of 1024 tokens (a schedule held
               at 512): each flash kernel launches 36 x gas a step and
               the work the launches report pins 2 of them a micro-batch
               at T 1024 and 34 at T 512; (b) progressive layer drop
               (theta 0.5, gamma 1: theta 0.684, 0.568, 0.525 over the
               measured steps, read from the engine): every block
               computed (36 x gas launches a step), the p_keep of each
               draw on the schedule (layer_keep_probs) and the kept
               blocks within 4 binomial sigmas of their expectation; (c)
               the fixed_linear curriculum 256 -> 1024 in steps of 256
               (the measured steps at 512, 768, 1024) with the csv and
               JSONL monitors at monitor_interval 1: one line per step,
               equal to the returned losses. Then the FLOPs profiler: one
               774M forward (B 8, T 1024) counted by get_model_profile
               equals the analytic count (weight products, tied logits,
               kernel D's causal pairs) within 1e-9 relative, and a small
               GPT-2's forward and forward + backward count the same on
               the card as on the CPU. Each run: ms a step, tokens/s
               (every token counted), losses, launches, beside
               train_774m's ms a step. The kernels phase adds D, E and F
               at the LTD shape (B 8, H 20, T 512, Dh 64, causal, timed).

Generate (phases added after ``reference`` and after ``probe_fp32``):

   kernels (flash-decode) — the flash-decode kernel against its plain
               version, row by row (2e-2 bf16, 1e-5 f32: kernel_check.
               rel_err): CodeLlama-34B decode (B 1 and B 4, Hq 64 / Hkv 8,
               Dh 128, S 640, bf16, idx 0, 127, 128, 639), the rep-1
               variant at LLaMA-7B's shape (B 8, H 32, S 1024; also fp16,
               Dh 64 and 256, S 1000) and an f32
               case; each idx as a python int and as a device tensor (the
               same bits), values past idx set to 1e4 (the output must not
               change), a second launch (bit-identical); at rep 8 the fused
               decode step on the same cache (writing back row idx's own
               values) gives the same bits under the same split plan (the
               two run one body). Kernel, plain and
               SDPA-over-the-valid-prefix times at the largest idx, on cache
               copies rotated past the L2, with the bound share; at rep 8
               the kernel's time under its split plan, kernel B's plan and
               32-position chunks. Kernel B
               gets rows at rep 8 (34B, B 4) and at Dh 64 MHA (GPT-2 774M,
               B 4, S 256).
   reference_generate — generate() of a small fp32 LLaMA (2 layers,
               hidden 2048, 16/2 heads: rep 8 at Dh 128, vocab 32000) on the
               CPU (plain versions) and the card (kernels): identical greedy
               tokens at batch 1 (flash-decode: layers x (new - 1) launches,
               no fused step) and batch 2 (the fused step), greedy and with
               EOS; a seeded sampled generate repeats on the card; a small
               fp32 GPT-2 at batch 2 the same way (the fused step). The CPU
               launches none.
   generate_gpt2 — GPT-2 774M in bf16 (random init): batch 4, a 128-token
               prompt, 64 new tokens; 36 x 63 fused-step launches; the
               probe (row 0 replayed at batch 1 from its prompt through a
               cache padded as generate pads it; over the last 32 steps the
               replay's logits and the no-cache forward's agree within
               GENERATE_LOGIT_TOL of max |logit|, and tokens agree with the
               no-cache argmax on margin-safe steps); a profile of 5 decode
               steps.
   generate_34b — CodeLlama-34B at full width and depth in bf16 (random
               weights from a seeded torch.Generator; 67.5 GB), after
               asserting that the earlier phases freed the card: greedy at
               batch 1, a 512-token prompt and 64 new tokens (cache 640:
               48 x 63 flash-decode launches, no fused step), the probe
               (as generate_gpt2's; the batch-1 replay is generate's own
               computation, so it reproduces every generated token),
               prefill ms, host ms per decode token, a profile of 5 decode
               steps (busy share, flash-decode ms per token, top kernels);
               the same prompt at batch 4 (48 x 63 fused-step launches at
               rep 8), with its profile; a sampled
               generate (top-k 50, top-p 0.9, temperature 0.8, seed 1) twice
               at batch 1, identical.

Sparse attention (a phase added after ``kernels``, before ``reference``):

   kernels (gridded int8) — the gridded int8 matmul (int8_matmul, unrouted
               as in the reference; kernel 2's tensor-core body at one split
               over grid_plan's column tiles) beside every int8_matmul_dma
               row: in bf16, fp16 and f32 against the same plain version and
               bound, each row the same bits at batch 1 and run to run, its
               time (bf16; f32 beside it) and bound share printed beside
               kernel 2's.
   sparse_attention — block-sparse attention through the op registry
               (get_op_builder("sparse_attn")().load().SparseSelfAttention),
               forward and then backward of a seeded dO, each row's launches
               counted (one forward, one dQ and one dK/dV launch per row):
               (a) FixedSparsityConfig (4 local, 1 global, unidirectional,
               block 16) at LLaMA-7B's attention width, 32 heads x Dh 128,
               bf16, B 1, T 8192; (b) BigBirdSparsityConfig (block 16) at
               BERT-large's, 16 heads x Dh 64, bf16, B 4, T 4096; (c) small
               rows: f32 (Longformer), bf16 at block 32 (Fixed) and 64
               (BigBird), fp16 (BigBird, its global rows cut in parts), and
               a hand-made layout whose rows of one block see no key under
               causal. Each kernel against its plain version on the same
               operands, row by row (kernel_check.rel_err: 1.6e-2 bf16,
               2e-3 fp16, 1e-5 f32; lse 1e-4 absolute), a second launch bit for
               bit, the main path's output equal to the kernel's; at (b) and
               (c) the dense oracle (block_sparse_attention_reference:
               outputs to the same bound, f32 gradients to 1e-4, bf16
               gradients reported, since its autograd rounds them at other
               points). At
               (a) and (b): kernel, plain and SDPA-over-the-dense-mask times
               (forward, backward), each captured in a CUDA graph, and
               bounds from the active-block work (dQ and dK/dV also against
               the f32 CUDA-core peak, f32_floor_ms, with the share of it
               each kernel reaches); the layouts' density, LUT width and
               longest row and column; the work lists' fwd_group_busy (the
               forward's list is dQ's), dq_group_busy and dkv_group_busy
               beside four consecutive query (key) blocks', their items,
               cut lines and partials.

The line before the last is the kernels summary; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import resource
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaModel
from deepspeed_tpu_torch.ops import cuda_build
from deepspeed_tpu_torch.ops.attention import gather_block_kv, pool_layer
from deepspeed_tpu_torch.ops.decode_step import (block_split_plan,
                                                 fused_block_decode_step,
                                                 fused_block_decode_step_plain,
                                                 fused_decode_step,
                                                 fused_decode_step_plain,
                                                 split_plan)
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
import deepspeed_tpu_torch.ops.decode_step as decode_step_module
from deepspeed_tpu_torch.ops.flash_decode import (flash_decode,
                                                  flash_decode_mha,
                                                  flash_decode_plain)
from deepspeed_tpu_torch.ops.flash_attention import (flash_bwd_dkv,
                                                     flash_bwd_dkv_plain,
                                                     flash_bwd_dkv_precise,
                                                     flash_bwd_dq,
                                                     flash_bwd_dq_plain,
                                                     flash_bwd_dq_precise,
                                                     flash_fwd_parts,
                                                     flash_fwd_parts_plain,
                                                     flash_fwd_precise)
from deepspeed_tpu_torch.ops import get_op_builder
from deepspeed_tpu_torch.ops.int8_matmul import (grid_plan, int8_matmul,
                                                 int8_matmul_dma,
                                                 int8_matmul_plain)
from deepspeed_tpu_torch.ops.int8_matmul import plan as int8_plan
from deepspeed_tpu_torch.ops.kernel_check import (PRECISE_GAIN,
                                                  block_step_inputs,
                                                  capture_graph, clone_pool,
                                                  flash_delta, flash_inputs,
                                                  flash_mean_errors_f64,
                                                  graph_replay,
                                                  masked_row_layout,
                                                  random_pool,
                                                  real_rows_equal, rel_err)
from deepspeed_tpu_torch.ops.sparse_attention.block_sparse import (
    block_sparse_attention_reference, block_sparse_bwd_dkv,
    block_sparse_bwd_dkv_plain, block_sparse_bwd_dq, block_sparse_bwd_dq_plain,
    block_sparse_delta, block_sparse_fwd, block_sparse_fwd_plain,
    group_busy, layout_to_dense_mask, row_groups, sparse_luts)
from deepspeed_tpu_torch.runtime.zero.offload import param_names
from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_map
from deepspeed_tpu_torch.serving import (BlockKVPool, Request, ServingEngine,
                                         poisson_trace, run_twin,
                                         shared_prefix_trace,
                                         synthetic_tenant_trace,
                                         templated_trace)
from deepspeed_tpu_torch.serving.speculative import DraftModelDrafter
from deepspeed_tpu_torch.telemetry import (FlightRecorder, JsonlSink,
                                           MetricsRegistry, SLOEngine,
                                           SpanTracer, get_registry,
                                           read_jsonl, reset_registry)
from deepspeed_tpu_torch.utils.timer import (BACKWARD_GLOBAL_TIMER,
                                             FORWARD_GLOBAL_TIMER,
                                             STEP_GLOBAL_TIMER,
                                             TRAIN_BATCH_TIMER)

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12      # dense bf16 tensor-core peak
F32_FLOP_PER_S = 67e12        # f32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20
# decode-step outputs (kernels B and C), per row (kernel_check.rel_err): bf16
# about two ulps of the row's largest element (the kernels round p at
# chunk- or warp-local running maxima, the plain version at the row max);
# an absolute bound passed a merge that drops one split's l (rows of ~1000
# averaged values are small: tests/test_torch_kernel_check.py)
DECODE_TOL = 2e-2
MATMUL_RTOL = 8e-3            # one bf16 ulp of |out|, plus 1e-3 absolute
# LLaMA-7B probe logits, kernel-cached replay vs plain no-cache forward, as
# a share of max |logit|. fp32: the two differ only in summation order.
# bf16/int8: the no-cache forward rounds attention logits to bf16 where the
# decode kernel keeps them in f32 (ROADMAP queue 3 item 2), and 32 random
# layers amplify that; the bound only catches a gross error (a wrong
# position or head moves logits by their own size).
LOGIT_TOL = {"fp32": 1e-3, "bf16": 0.15, "int8": 0.15}
# The same check through generate() at CodeLlama-34B's depth: 48 random
# layers amplify that rounding further (LLaMA-7B's probes read 0.07-0.10 of
# max |logit|, CodeLlama-34B's 0.149); the bound keeps the 7B bound's
# factor of about two over its readings and still catches a gross error.
GENERATE_LOGIT_TOL = 0.3
# generate_34b's new tokens a call (128 through PR 17: cut for the script's
# time limit; the probe reads the last 32)
GENERATE_34B_NEW = 64
KERNELS = {
    "fused_decode_step": {
        "source": "deepspeed_tpu_torch/csrc/decode_step.cu",
        "replaces": "deepspeed_tpu/ops/decode_step.py:170 (_kernel)"},
    "int8_matmul_dma": {
        "source": "deepspeed_tpu_torch/csrc/int8_matmul.cu",
        "replaces": "deepspeed_tpu/ops/int8_matmul.py:151 (_dma_kernel)"},
    "fused_block_decode_step": {
        "source": "deepspeed_tpu_torch/csrc/block_decode_step.cu",
        "replaces": "deepspeed_tpu/ops/decode_step.py:473 (_block_kernel)"},
    "flash_fwd": {
        "source": "deepspeed_tpu_torch/csrc/flash_attention.cu",
        "replaces": "deepspeed_tpu/ops/flash_attention.py:80 (_fwd_kernel)"},
    "flash_bwd_dq": {
        "source": "deepspeed_tpu_torch/csrc/flash_attention.cu",
        "replaces": "deepspeed_tpu/ops/flash_attention.py:121 (_bwd_dq_kernel)"},
    "flash_bwd_dkv": {
        "source": "deepspeed_tpu_torch/csrc/flash_attention.cu",
        "replaces": "deepspeed_tpu/ops/flash_attention.py:154 (_bwd_dkv_kernel)"},
    "flash_decode": {
        "source": "deepspeed_tpu_torch/csrc/flash_decode.cu",
        "replaces": "deepspeed_tpu/ops/flash_decode.py:51 (_kernel)"},
    "flash_decode_mha": {
        "source": "deepspeed_tpu_torch/csrc/flash_decode.cu",
        "replaces": "deepspeed_tpu/ops/flash_decode.py:91 (_mha_kernel)"},
    "block_sparse_fwd": {
        "source": "deepspeed_tpu_torch/csrc/block_sparse.cu",
        "replaces": "deepspeed_tpu/ops/sparse_attention/block_sparse.py:84 "
                    "(_fwd_kernel)"},
    "block_sparse_bwd_dq": {
        "source": "deepspeed_tpu_torch/csrc/block_sparse.cu",
        "replaces": "deepspeed_tpu/ops/sparse_attention/block_sparse.py:130 "
                    "(_bwd_dq_kernel)"},
    "block_sparse_bwd_dkv": {
        "source": "deepspeed_tpu_torch/csrc/block_sparse.cu",
        "replaces": "deepspeed_tpu/ops/sparse_attention/block_sparse.py:168 "
                    "(_bwd_dkv_kernel)"},
    "int8_matmul": {
        "source": "deepspeed_tpu_torch/csrc/int8_matmul_grid.cu",
        "replaces": "deepspeed_tpu/ops/int8_matmul.py:44 (_kernel)"},
    "flash_fwd_precise": {
        "source": "deepspeed_tpu_torch/csrc/flash_precise.cu",
        "replaces": "deepspeed_tpu/ops/flash_attention.py:80 (_fwd_kernel, "
                    "DSTPU_FLASH_F32_PRECISE=1)"},
    "flash_bwd_dq_precise": {
        "source": "deepspeed_tpu_torch/csrc/flash_precise.cu",
        "replaces": "deepspeed_tpu/ops/flash_attention.py:121 (_bwd_dq_kernel, "
                    "DSTPU_FLASH_F32_PRECISE=1)"},
    "flash_bwd_dkv_precise": {
        "source": "deepspeed_tpu_torch/csrc/flash_precise.cu",
        "replaces": "deepspeed_tpu/ops/flash_attention.py:154 (_bwd_dkv_kernel, "
                    "DSTPU_FLASH_F32_PRECISE=1)"},
}
WRAPPERS = {"fused_decode_step": fused_decode_step,
            "int8_matmul_dma": int8_matmul_dma,
            "fused_block_decode_step": fused_block_decode_step,
            "flash_fwd": flash_fwd_parts,
            "flash_bwd_dq": flash_bwd_dq,
            "flash_bwd_dkv": flash_bwd_dkv,
            "flash_decode": flash_decode,
            "flash_decode_mha": flash_decode_mha,
            "block_sparse_fwd": block_sparse_fwd,
            "block_sparse_bwd_dq": block_sparse_bwd_dq,
            "block_sparse_bwd_dkv": block_sparse_bwd_dkv,
            "int8_matmul": int8_matmul,
            "flash_fwd_precise": flash_fwd_precise,
            "flash_bwd_dq_precise": flash_bwd_dq_precise,
            "flash_bwd_dkv_precise": flash_bwd_dkv_precise}
FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
PRECISE = ("flash_fwd_precise", "flash_bwd_dq_precise", "flash_bwd_dkv_precise")
SPARSE = ("block_sparse_fwd", "block_sparse_bwd_dq", "block_sparse_bwd_dkv")
# flash outputs, per row: |kernel - plain| as a share of the row's max |x|
# (kernel_check.rel_err). bf16: about two ulps (2^-7 each) of the row's
# largest element; the H100 readings are at most one ulp (0.0073-0.0078).
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
LSE_TOL = 1e-4                                              # absolute
# the f32-precise flash kernels against their plain versions under
# DSTPU_FLASH_F32_PRECISE=1, per row (kernel_check.rel_err): both compute
# the same f32 values up to summation order (the f32 rows' 1e-4); a 16-bit
# output then rounds them once, where two values that close may land one
# ulp apart: at most 2^-7 (bf16) or 2^-10 (fp16) of the row's largest
# element, since an element in [2^e, 2^(e+1)) has an ulp of 2^(e-7)
# (2^(e-10))
PRECISE_TOL = {torch.bfloat16: 1e-4 + 2 ** -7, torch.float16: 1e-4 + 2 ** -10,
               torch.float32: 1e-4}
# GPT-2 774M first-batch loss through flash vs dense attention, absolute
# (the reading is 9.4e-5 at a loss of 11.1)
FLASH_DENSE_LOSS_TOL = 1e-3
# flash-decode outputs, per row (kernel_check.rel_err): bf16 (fp16) about
# two ulps of the row's largest element (the kernel rounds p at warp-local
# running maxima, the plain version at the row maximum); f32 summation
# order only
FLASH_DECODE_TOL = {torch.bfloat16: 2e-2, torch.float16: 4e-3,
                    torch.float32: 1e-5}
# block-sparse outputs and grads against their plain versions and the dense
# oracle, per row (kernel_check.rel_err): both sides compute in f32 and
# round once, so bf16 (2^-7) and fp16 (2^-10) are held to two ulps of the
# row's largest element and f32 to summation order; lse within LSE_TOL
# absolute
SPARSE_TOL = {torch.bfloat16: 1.6e-2, torch.float16: 2e-3, torch.float32: 1e-5}
# f32 gradients against autograd of the dense oracle (softmax's backward in
# another form and order)
SPARSE_ORACLE_GRAD_TOL = 1e-4
# CodeLlama-34B, codellama/CodeLlama-34b-hf config.json: every field a
# LlamaConfig field (GQA rep 8 at Dh 128, rope_theta 1e6, untied)
CODELLAMA_34B = dict(vocab_size=32000, max_seq_len=16384, num_layers=48,
                     hidden_size=8192, num_heads=64, num_kv_heads=8,
                     intermediate_size=22016, rope_theta=1e6, eps=1e-5)


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase line also carries ``t_s``, the seconds since
    the script started."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def reset_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def time_ms(fn, n_inputs: int, per: int = 20, reps: int = 20,
            stream=None) -> float:
    """Device time of one fn(i) call: ``per`` calls, ``i`` rotating through
    ``n_inputs`` input sets, are captured into one CUDA graph (so the
    host's launch cost, which exceeds a short kernel's run, is not timed),
    the graph is replayed ``reps`` times between CUDA events, and the
    median replay time is divided by ``per``. Warm-up and capture run on
    ``stream`` (default a new one): an autograd backward must be captured
    on the stream its forward ran on."""
    side = stream if stream is not None else torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):              # warm-up off the capture
        for i in range(3):
            fn(i % n_inputs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(per):
            fn(i % n_inputs)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per)
    del graph
    return float(np.median(times))


# --------------------------------------------------------------- phase 1
FLASH_SASS = ("flash_fwd_wgmma", "flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma")
# the 16-bit instantiations of the GQA flash-decode kernel, by their
# mangled (or demangled) names: bf16 and fp16 at Dh 64 (1, 2 or 4 n-tiles),
# 128 (1 or 2) and 256 (1)
FLASH_DECODE_SASS = re.compile(
    r"flash_decode_gqa(?:I13__nv_bfloat16|I6__half|<__nv_bfloat16|<__half)")
FLASH_DECODE_16BIT = 12
# the 16-bit instantiations of the int8 matmul's tensor-core body: bf16 and
# fp16 at 1-4 n-tiles and 128 columns (kernel 2), 32 and 64 (the gridded
# form, each with a 96 KB and a 200 KB ring); the column tile is the third
# template argument
INT8_MATMUL_SASS = re.compile(
    r"int8_matmul_tc(?:I(?:13__nv_bfloat16|6__half)Li\d+ELi(\d+)E"
    r"|<(?:__nv_bfloat16|__half), \d+, (\d+)[,>])")
INT8_MATMUL_COLS = {128: 8, 32: 16, 64: 16}
# the 16-bit instantiations of the block-sparse forward's tensor-core form
# (q.k^T on mma.sync): bf16 and fp16 at Dh 64 and 128 and blocks 16, 32, 64
SPARSE_FWD_SASS = re.compile(
    r"block_sparse_fwd_tc(?:I(?:13__nv_bfloat16|6__half)|<(?:__nv_bfloat16|__half))")
SPARSE_FWD_16BIT = 12


def sass_counts(lib_path) -> dict:
    """HGMMA (wgmma) and HMMA (mma.sync) instructions in the SASS of the
    built library (``cuobjdump -sass``): each 16-bit flash kernel's, summed
    over its instantiations, and each 16-bit GQA flash-decode, int8
    matmul tensor-core (kernel 2 and the gridded form, by column tile) and
    block-sparse forward tensor-core instantiation's. Fails unless every
    flash kernel issues HGMMA and no HMMA, and every flash-decode, int8
    matmul and sparse forward instantiation HMMA (their products on the
    tensor cores; the kernels they replaced issued none)."""
    cuobjdump = (shutil.which("cuobjdump")
                 or str(Path(cuda_build._nvcc()).with_name("cuobjdump")))
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    flash = {name: {"HGMMA": 0, "HMMA": 0} for name in FLASH_SASS}
    decode, matmul, sparse = {}, {}, {}
    current = None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ", 1)[1].strip()
            current = next((flash[n] for n in FLASH_SASS if n in fn), None)
            if current is None and FLASH_DECODE_SASS.search(fn):
                current = decode.setdefault(fn, {"HGMMA": 0, "HMMA": 0})
            if current is None and SPARSE_FWD_SASS.search(fn):
                current = sparse.setdefault(fn, {"HGMMA": 0, "HMMA": 0})
            tc = INT8_MATMUL_SASS.search(fn) if current is None else None
            if tc:
                current = matmul.setdefault(fn, {
                    "cols": int(tc.group(1) or tc.group(2)), "HGMMA": 0,
                    "HMMA": 0})
        elif current is not None:
            for op in ("HGMMA", "HMMA"):
                if f" {op}." in line:
                    current[op] += 1
    for name, c in flash.items():
        assert c["HGMMA"] > 0 and c["HMMA"] == 0, (name, c)
    assert len(decode) == FLASH_DECODE_16BIT, sorted(decode)
    assert len(sparse) == SPARSE_FWD_16BIT, sorted(sparse)
    cols = [c["cols"] for c in matmul.values()]
    assert {w: cols.count(w) for w in INT8_MATMUL_COLS} == INT8_MATMUL_COLS \
        and len(cols) == sum(INT8_MATMUL_COLS.values()), sorted(matmul)
    for name, c in [*decode.items(), *matmul.items(), *sparse.items()]:
        assert c["HMMA"] > 0 or c["HGMMA"] > 0, (name, c)
    return {"flash": flash, "flash_decode_gqa": decode,
            "int8_matmul_tc": matmul, "block_sparse_fwd_tc": sparse}


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    lib_path = cuda_build.build(verbose=True)
    cuda_build.kernels()
    info = {"phase": "device", "nvidia_smi": smi,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "library": str(lib_path.name),
            "build_s": time.perf_counter() - t0,
            "nvcc_build_s": cuda_build.build_seconds,
            "sass": sass_counts(lib_path)}
    emit(info)
    return info


# --------------------------------------------------------------- phase 2
def check_decode_step(b, hq, hkv, s, dh, idx, layers=2, seed=0):
    """Kernel vs plain at one geometry. Returns the row for the report."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    layer = layers - 1
    q, kn, vn = rnd(b, 1, hq, dh), rnd(b, 1, hkv, dh), rnd(b, 1, hkv, dh)
    kf, vf = rnd(layers, b, hkv, s, dh), rnd(layers, b, hkv, s, dh)
    iv = torch.tensor(idx, dtype=torch.int32, device=dev)
    k1, v1, k2, v2 = kf.clone(), vf.clone(), kf.clone(), vf.clone()
    out, _, _ = fused_decode_step(q, k1, v1, kn, vn, layer, iv)
    ref, _, _ = fused_decode_step_plain(q, k2, v2, kn, vn, layer, iv)
    again, _, _ = fused_decode_step(q, kf.clone(), vf.clone(), kn, vn, layer,
                                    iv)
    torch.cuda.synchronize()
    assert torch.equal(k1, k2) and torch.equal(v1, v2), "cache bytes differ"
    assert torch.isfinite(out.float()).all()
    assert torch.equal(again, out), "fused_decode_step not bit-identical"
    err, abs_err = rel_err(out, ref), (out.float() - ref.float()).abs().max().item()
    assert err <= DECODE_TOL, f"fused_decode_step rel err {err}"
    # scalar idx form on the same inputs
    outs, _, _ = fused_decode_step(q, k1.clone(), v1.clone(), kn, vn, layer,
                                   int(idx[1]))
    refs, _, _ = fused_decode_step_plain(q, k2.clone(), v2.clone(), kn, vn,
                                         layer, int(idx[1]))
    err = max(err, rel_err(outs, refs))
    abs_err = max(abs_err, (outs.float() - refs.float()).abs().max().item())
    assert err <= DECODE_TOL, f"fused_decode_step (scalar idx) rel err {err}"

    # timing: rotate over the layers (> L2 per call at these shapes)
    kernel_ms = time_ms(lambda i: fused_decode_step(q, kf, vf, kn, vn, i, iv),
                        layers)
    # kernel B under its plan and kernel C's, at this row's idx and with
    # every slot at the last position (flash-decode's case: one shared idx)
    iv_full = torch.full_like(iv, s - 1)
    plans = {name: _plan_times(
        "split_plan",
        lambda i, v_=v_: fused_decode_step(q, kf, vf, kn, vn, i, v_), layers,
        (b, hkv, s, dh, 2), ("split_plan", "block_split_plan"))
        for name, v_ in (("row_idx", iv), ("full_idx", iv_full))}
    plain_ms = time_ms(
        lambda i: fused_decode_step_plain(q, kf, vf, kn, vn, i, iv), layers)
    rep = hq // hkv
    n_pos = [min(int(x), s - 1) + 1 for x in idx]
    mask = (torch.arange(s, device=dev)[None, :]
            < torch.tensor(n_pos, device=dev)[:, None])[:, None, None, :]
    qs = q.transpose(1, 2)                      # [B, Hq, 1, Dh]

    gqa = {"enable_gqa": True} if rep > 1 else {}

    def sdpa(i):
        return torch.nn.functional.scaled_dot_product_attention(
            qs, kf[i], vf[i], attn_mask=mask, **gqa)

    library_ms = time_ms(sdpa, layers)
    esz = 2
    n_written = sum(1 for x in idx if 0 <= int(x) < s)
    nbytes = (b * hq * dh * esz * 2                      # q in, attn out
              + 2 * b * hkv * dh * esz                   # k_new, v_new in
              + 2 * n_written * hkv * dh * esz           # the cache writes
              + 2 * hkv * dh * esz * sum(n_pos))         # K, V prefix reads
    flops = 4 * hq * dh * sum(n_pos)                     # QK^T and P.V
    chunk, n_splits = split_plan(b, hkv, s,
                                 torch.cuda.get_device_properties(0)
                                 .multi_processor_count, dh, 2)
    return {"b": b, "hq": hq, "hkv": hkv, "s": s, "dh": dh, "idx": list(idx),
            "chunk": chunk, "n_splits": n_splits,
            "rel_err": err, "max_abs_err": abs_err, "tol_rel": DECODE_TOL,
            "cache_bit_identical": True, "bit_identical_run_to_run": True,
            "kernel_ms": kernel_ms, "plans": plans,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "scaled_dot_product_attention (attention only)",
            "bytes": nbytes, "flops": flops,
            "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                  flops / BF16_FLOP_PER_S),
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= flops / BF16_FLOP_PER_S else "operations"),
            **_shares(kernel_ms, 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                           flops / BF16_FLOP_PER_S),
                      library_ms)}


def _shares(ms, bound_ms, library_ms) -> dict:
    """bound_share: the bound as a share of the kernel's time (1 is the
    card's floor); vs_library: the kernel's time over the PyTorch call's."""
    return {"bound_share": bound_ms / ms,
            "vs_library": ms / library_ms if library_ms else None}


INT8_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
# kernel 2 against its plain version, per element: |out - ref| <= rtol
# |ref| + 1e-3 (one ulp of the output type; f32 summation order only)
MATMUL_RTOLS = {torch.bfloat16: MATMUL_RTOL, torch.float16: 1e-3,
                torch.float32: 1e-5}


def check_int8_matmul(n, d, e, seed=0):
    """Kernel 2 (``int8_matmul_dma``) and the gridded form (``int8_matmul``,
    on the same layer's [D, E] view) on the last of enough stacked layers
    that one rotation exceeds the L2: in bf16, fp16 and f32 against the
    plain version, each row's result the same bits at batch 1 and in a
    second launch. Times (bf16 x): kernel 2, the gridded form (also with
    f32 x), the plain version,
    ``torch._weight_int8pack_mm`` (library_ms) and a bf16 ``torch.matmul``
    of the same values (bf16_matmul_ms), both yardsticks only."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    # enough stacked layers that one rotation exceeds L2 (fresh weights)
    layers = max(2, math.ceil(3 * L2_BYTES / (d * e)))
    q = torch.randint(-128, 128, (layers, d, e), generator=g, device=dev,
                      dtype=torch.int8)
    s = (torch.rand((layers, 1, e), generator=g, device=dev) * 0.02)
    x32 = torch.randn((n, d), generator=g, device=dev)
    errs, grid_errs = {}, {}
    for dtype in INT8_DTYPES:
        xd = x32.to(dtype)
        out = int8_matmul_dma(xd, q, s, layers - 1)
        ref = int8_matmul_plain(xd, q, s, layers - 1)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        name = str(dtype).split(".")[-1]
        assert torch.isfinite(out.float()).all()
        bound = MATMUL_RTOLS[dtype] * ref.float().abs() + 1e-3
        assert (err <= bound).all(), \
            f"int8_matmul_dma {name} {n}x{d}x{e} err {err.max()}"
        assert torch.equal(int8_matmul_dma(xd, q, s, layers - 1), out), \
            f"int8_matmul_dma {name} {n}x{d}x{e} not bit-identical run to run"
        assert torch.equal(int8_matmul_dma(xd[-1:].contiguous(), q, s,
                                           layers - 1), out[-1:]), \
            f"int8_matmul_dma {name} {n}x{d}x{e}: the last row differs at batch 1"
        errs[name] = err.max().item()
        # the gridded form (unrouted) on the same layer's [D, E] view and
        # [1, E] scales: the same function, so the same plain version and
        # bound
        grid = int8_matmul(xd, q[layers - 1], s[layers - 1])
        torch.cuda.synchronize()
        grid_err = (grid.float() - ref.float()).abs()
        assert torch.isfinite(grid.float()).all()
        assert (grid_err <= bound).all(), \
            f"int8_matmul (gridded) {name} {n}x{d}x{e} err {grid_err.max()}"
        assert torch.equal(int8_matmul(xd, q[layers - 1], s[layers - 1]), grid), \
            f"int8_matmul (gridded) {name} {n}x{d}x{e} not bit-identical run to run"
        assert torch.equal(int8_matmul(xd[-1:].contiguous(), q[layers - 1],
                                       s[layers - 1]), grid[-1:]), \
            f"int8_matmul (gridded) {name} {n}x{d}x{e}: the last row differs at batch 1"
        grid_errs[name] = grid_err.max().item()
        if dtype == torch.bfloat16:
            x = xd
    x_f32 = x32
    kernel_ms = time_ms(lambda i: int8_matmul_dma(x, q, s, i), layers)
    grid_ms = time_ms(lambda i: int8_matmul(x, q[i], s[i]), layers)
    grid_f32_ms = time_ms(lambda i: int8_matmul(x_f32, q[i], s[i]), layers)
    plain_ms = time_ms(lambda i: int8_matmul_plain(x, q, s, i), layers)
    # yardsticks only: PyTorch's weight-only int8 matmul takes the weight as
    # [E, D] and bf16 scales, so it gets its own copies of the same values;
    # the bf16 matmul streams the same values as a bf16 weight (twice the
    # bytes), as the bf16 serving path's weight GEMMs do
    qt = q.transpose(1, 2).contiguous()                 # [L, E, D]
    sb = s.reshape(layers, e).to(torch.bfloat16).contiguous()
    library_ms = time_ms(
        lambda i: torch._weight_int8pack_mm(x, qt[i], sb[i]), layers)
    del qt, sb
    wb = q.to(torch.bfloat16)                           # [L, D, E]
    bf16_matmul_ms = time_ms(lambda i: torch.matmul(x, wb[i]), layers)
    del wb
    nbytes = d * e + n * d * 2 + e * 4 + n * e * 2
    flops = 2 * n * d * e
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)
    return {"n": n, "d": d, "e": e, "plan": list(int8_plan(d, e)),
            "max_abs_err": max(errs.values()), "max_abs_err_by_dtype": errs,
            "tol": f"rtol {MATMUL_RTOL} (bf16), 1e-3 (fp16), 1e-5 (f32) "
                   "+ atol 1e-3",
            "bit_identical_run_to_run_and_at_batch_1": True,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "grid": {"kernel_ms": grid_ms, "dma_kernel_ms": kernel_ms,
                     "plan": list(grid_plan(d, e)),
                     "bound_share": bound_ms / grid_ms,
                     "f32_kernel_ms": grid_f32_ms,
                     "max_abs_err": max(grid_errs.values()),
                     "max_abs_err_by_dtype": grid_errs},
            "library_ms": library_ms, "library": "torch._weight_int8pack_mm",
            "bf16_matmul_ms": bf16_matmul_ms,
            "bytes": nbytes,
            "flops": flops,
            "bound_ms": bound_ms,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= flops / BF16_FLOP_PER_S else "operations")}


def _bytes_bound(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def check_block_decode_step(b, hq, hkv, dh, bs, mb, kv, idx, seed=0):
    """Block decode kernel vs plain at one geometry and pool type: slot i
    names pool blocks perm[i*mb:(i+1)*mb] of a permuted pool, the last slot
    is inactive on a sentinel table (the garbage row). Checked on L = 2
    layers at layer 1; timed on ``n_t`` stacked layers so that one rotation
    reads more than the L2 holds."""
    dev = "cuda"
    nblk = (b - 1) * mb
    itemsize = 1 if kv else 2
    n_pos = [min(int(x), mb * bs - 1) + 1 for x in idx]
    read = 2 * sum(n_pos) * hkv * dh * itemsize + (
        2 * sum(n_pos) * hkv * 2 if kv else 0)
    n_t = max(2, math.ceil(3 * L2_BYTES / read))
    g, q, kp, vp, kn, vn, table = block_step_inputs(
        dev, torch.bfloat16, kv, b, hq, hkv, nblk, bs, mb, dh, seed=seed)
    iv = torch.tensor(idx, dtype=torch.int32, device=dev)
    k1, v1, k2, v2 = (clone_pool(kp), clone_pool(vp), clone_pool(kp),
                      clone_pool(vp))
    out, _, _ = fused_block_decode_step(q, k1, v1, kn, vn, 1, iv, table)
    ref, _, _ = fused_block_decode_step_plain(q, k2, v2, kn, vn, 1, iv, table)
    again, _, _ = fused_block_decode_step(q, clone_pool(kp), clone_pool(vp),
                                          kn, vn, 1, iv, table)
    torch.cuda.synchronize()
    assert real_rows_equal(k1, k2) and real_rows_equal(v1, v2), \
        f"block pool bytes differ (kv {kv})"
    assert not real_rows_equal(k1, kp), "the block writes did not land"
    assert torch.isfinite(out.float()).all()
    assert torch.equal(again, out), f"kernel C not bit-identical (kv {kv})"
    err, abs_err = rel_err(out, ref), (out.float() - ref.float()).abs().max().item()
    assert err <= DECODE_TOL, f"fused_block_decode_step kv {kv} rel err {err}"
    del kp, vp, k1, v1, k2, v2

    kt, vt = (random_pool(g, n_t, nblk, hkv, bs, dh, torch.bfloat16, kv)
              for _ in range(2))
    kernel_ms = time_ms(
        lambda i: fused_block_decode_step(q, kt, vt, kn, vn, i, iv, table), n_t)
    plans = _plan_times(
        "block_split_plan",
        lambda i: fused_block_decode_step(q, kt, vt, kn, vn, i, iv, table), n_t,
        (b, hkv, mb * bs), ("block_split_plan", "split_plan"))
    plain_ms = time_ms(
        lambda i: fused_block_decode_step_plain(q, kt, vt, kn, vn, i, iv,
                                                table), n_t)
    # yardstick: attention only, over K/V gathered beforehand into the
    # contiguous [B, Hkv, MB*bs, Dh] layout (dequantized for 8-bit pools)
    kc = torch.stack([gather_block_kv(pool_layer(kt, i), table, q.dtype)
                      for i in range(n_t)])
    vc = torch.stack([gather_block_kv(pool_layer(vt, i), table, q.dtype)
                      for i in range(n_t)])
    s = mb * bs
    mask = (torch.arange(s, device=dev)[None, :]
            < torch.tensor(n_pos, device=dev)[:, None])[:, None, None, :]
    qs = q.transpose(1, 2)
    gqa = {"enable_gqa": True} if hq != hkv else {}
    library_ms = time_ms(
        lambda i: torch.nn.functional.scaled_dot_product_attention(
            qs, kc[i], vc[i], attn_mask=mask, **gqa), n_t)
    del kt, vt, kc, vc
    nbytes = (b * hq * dh * 2 * 2                        # q in, attn out
              + 2 * b * hkv * dh * 2                     # k_new, v_new in
              + 2 * b * hkv * dh * itemsize              # the pool writes
              + (2 * b * hkv * 2 if kv else 0)           # their scales
              + b * mb * 4 + b * 4                       # table, idx
              + read)                                    # K, V prefix reads
    chunk, n_splits = block_split_plan(b, hkv, mb * bs, torch.cuda.get_device_properties(
        0).multi_processor_count)
    return {"b": b, "hq": hq, "hkv": hkv, "dh": dh, "block_size": bs,
            "mb": mb, "pool": kv or "bf16", "idx": list(idx),
            "chunk": chunk, "n_splits": n_splits,
            "rel_err": err, "max_abs_err": abs_err, "tol_rel": DECODE_TOL,
            "pool_bit_identical": True, "bit_identical_run_to_run": True,
            "kernel_ms": kernel_ms, "plans": plans,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "scaled_dot_product_attention (attention only, no "
                       "gather)", "timing_layers": n_t,
            **_bytes_bound(nbytes, 4 * hq * dh * sum(n_pos))}


def check_block_decode_edges(hkv, kv, graph: bool, b=8, hq=32, dh=128, bs=16,
                             mb=64, seed=5):
    """Kernel C at its split edges: every slot active on its own table, idx
    at 63, 64, 255, 256 and MB*bs - 1 (chunk 256 at MHA and 64 at rep 4, so
    each is a last or first position of a split at one of them), 0, and two
    overflow slots (MB*bs and MB*bs + 6) whose writes land in rows 0 and 6
    of the garbage row, written by split 0. Output row by row against the
    plain version, every pool row bit-identical (the two written garbage
    rows included), a second launch bit for bit and, with ``graph``, the
    call captured in a CUDA graph and replayed, bit for bit with the eager
    launch (output and pools)."""
    dev = "cuda"
    s = mb * bs
    idx = [63, 64, 255, 256, s - 1, s, s + 6, 0]
    # one more slot than used: block_step_inputs parks its last slot on the
    # sentinel table, and this row keeps every slot on a real one
    _, q, kp, vp, kn, vn, table = block_step_inputs(
        dev, torch.bfloat16, kv, b + 1, hq, hkv, b * mb, bs, mb, dh, seed=seed)
    q, kn, vn, table = q[:b], kn[:b], vn[:b], table[:b].contiguous()
    iv = torch.tensor(idx, dtype=torch.int32, device=dev)
    k1, v1, k2, v2 = (clone_pool(kp), clone_pool(vp), clone_pool(kp),
                      clone_pool(vp))
    out, _, _ = fused_block_decode_step(q, k1, v1, kn, vn, 1, iv, table)
    ref, _, _ = fused_block_decode_step_plain(q, k2, v2, kn, vn, 1, iv, table)
    again, _, _ = fused_block_decode_step(q, clone_pool(kp), clone_pool(vp),
                                          kn, vn, 1, iv, table)
    torch.cuda.synchronize()

    def garbage(pool, rows):
        x = pool["q"] if kv else pool
        return x[1, -1, :, rows]

    assert real_rows_equal(k1, k2) and real_rows_equal(v1, v2), \
        f"kernel C edges: pool bytes differ (kv {kv})"
    written = [s % bs, (s + 6) % bs]
    for a, r in ((k1, k2), (v1, v2)):
        assert torch.equal(garbage(a, written), garbage(r, written)), \
            f"kernel C edges: the overflow writes differ (kv {kv})"
        if kv:
            assert torch.equal(a["s"][1, -1, :, written], r["s"][1, -1, :, written])
    assert torch.isfinite(out.float()).all()
    assert torch.equal(again, out), f"kernel C edges not bit-identical (kv {kv})"
    err, abs_err = rel_err(out, ref), (out.float() - ref.float()).abs().max().item()
    assert err <= DECODE_TOL, f"kernel C edges kv {kv} rel err {err}"
    row = {"b": b, "hq": hq, "hkv": hkv, "dh": dh, "block_size": bs, "mb": mb,
           "pool": kv or "bf16", "idx": idx, "rel_err": err,
           "max_abs_err": abs_err, "tol_rel": DECODE_TOL,
           "pool_bit_identical": True, "overflow_rows_bit_identical": True,
           "bit_identical_run_to_run": True}
    if graph:
        # the warm-up call writes the same rows the replay then writes again
        kg, vg = clone_pool(kp), clone_pool(vp)
        g, (out_g, _, _) = capture_graph(
            lambda: fused_block_decode_step(q, kg, vg, kn, vn, 1, iv, table))
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out_g, out), f"kernel C graph replay differs (kv {kv})"
        assert real_rows_equal(kg, k1) and real_rows_equal(vg, v1)
        for a, r in ((kg, k1), (vg, v1)):
            assert torch.equal(garbage(a, written), garbage(r, written))
        row["graph_replay_bit_identical"] = True
        del g, kg, vg
    del kp, vp, k1, v1, k2, v2
    return row


def attn_pairs(tq: int, tk: int, causal: bool) -> int:
    """(query, key) pairs attended: all of them, or under top-left causal
    masking min(i + 1, tk) for query row i."""
    if not causal:
        return tq * tk
    if tk >= tq:
        return tq * (tq + 1) // 2
    return tk * (tk + 1) // 2 + (tq - tk) * tk


def _bound(nbytes, flops, flop_rate):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return {"bytes": nbytes, "flops": flops,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _bound_mixed(nbytes, product_flops, storage_products, f32_products,
                 storage_rate):
    """:func:`_bound` for a kernel whose first-stage products take
    storage-dtype operands (at ``storage_rate``: the tensor cores multiply
    16-bit values exactly and sum in f32) and whose second-stage products
    take f32 operands (at the f32 CUDA-core rate); the two times add.
    ``f32_floor_ms`` prices every product at the f32 CUDA-core rate."""
    products = storage_products + f32_products
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = product_flops * (storage_products / storage_rate
                             + f32_products / F32_FLOP_PER_S)
    return {"bytes": nbytes, "flops": products * product_flops,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "f32_floor_ms": 1e3 * products * product_flops / F32_FLOP_PER_S}


def _flash_bwd(q, k, v, do, lse, delta, causal):
    return (flash_bwd_dq(q, k, v, do, lse, delta, causal=causal),
            *flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal))


def _sdpa_times(sets, b, h, t, dh, causal):
    """The yardstick: SDPA's forward, backward (dQ, dK, dV together, from
    forwards kept on the stream it is captured on) and forward + backward
    times on [B, H, T, Dh] views of the same values."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    views = [[x.view(b, h, t, dh) for x in st] for st in sets]
    lib_fwd = time_ms(lambda i: sdpa(*views[i][:3], is_causal=causal), 2)

    def leaves(i):
        return [x.detach().requires_grad_() for x in views[i][:3]]

    def fwd_bwd(i):
        qq, kk, vv = leaves(i)
        torch.autograd.grad(sdpa(qq, kk, vv, is_causal=causal), (qq, kk, vv),
                            views[i][3])

    lib_fb = time_ms(fwd_bwd, 2, per=4, reps=10)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graphs = [(sdpa(*lv, is_causal=causal), lv)
                  for lv in (leaves(0), leaves(1))]
    lib_bwd = time_ms(
        lambda i: torch.autograd.grad(graphs[i][0], graphs[i][1], views[i][3],
                                      retain_graph=True), 2, per=4, reps=10,
        stream=side)
    del graphs
    return lib_fwd, lib_bwd, lib_fb


def check_flash(dtype, b, h, t, dh, causal, seed=0, timed=True):
    """The three flash kernels against their plain versions at one shape
    (flat [B*H, T, Dh] operands), then, if ``timed``, their times. The
    backward is fed the plain version's lse and delta (so each kernel is
    held alone), from a fixed dO; its outputs must be bit-identical across
    two launches and when replayed from a CUDA graph."""
    dev = "cuda"
    bh = b * h
    sets = [flash_inputs(dev, dtype, bh, t, dh, seed=seed + i) for i in range(2)]
    q, k, v, do = sets[0]
    out, lse = flash_fwd_parts(q, k, v, causal=causal)
    out2, lse2 = flash_fwd_parts(q, k, v, causal=causal)
    ref, ref_lse = flash_fwd_parts_plain(q, k, v, causal=causal)
    delta = flash_delta(do, ref)
    grads = _flash_bwd(q, k, v, do, ref_lse, delta, causal)
    again = _flash_bwd(q, k, v, do, ref_lse, delta, causal)
    replayed = graph_replay(
        lambda: _flash_bwd(q, k, v, do, ref_lse, delta, causal))
    plain = (flash_bwd_dq_plain(q, k, v, do, ref_lse, delta, causal=causal),
             *flash_bwd_dkv_plain(q, k, v, do, ref_lse, delta, causal=causal))
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype]
    errs = {}
    for name, got, want in (("out", out, ref), ("dq", grads[0], plain[0]),
                            ("dk", grads[1], plain[1]),
                            ("dv", grads[2], plain[2])):
        assert torch.isfinite(got.float()).all(), name
        errs[name] = {"max_abs_err": (got.float() - want.float()).abs().max().item(),
                      "rel_err": rel_err(got, want)}
        assert errs[name]["rel_err"] <= tol, (name, dtype, b, h, t, dh, causal,
                                              errs[name])
    lse_err = (lse - ref_lse).abs().max().item()
    assert lse_err <= LSE_TOL, ("lse", lse_err)
    assert all(torch.equal(x, y) for x, y in zip(grads, again)), \
        "flash backward not bit-identical across launches"
    assert all(torch.equal(x, y) for x, y in zip(grads, replayed)), \
        "flash backward from a CUDA graph differs from the eager launch"
    assert torch.equal(out, out2) and torch.equal(lse, lse2), \
        "flash forward not bit-identical across launches"
    del out, out2, lse2, ref, grads, again, replayed, plain
    row = {"dtype": str(dtype).split(".")[-1], "b": b, "h": h, "t": t,
           "dh": dh, "causal": causal, "tol_rel": tol,
           "lse_max_abs_err": lse_err, "lse_tol": LSE_TOL, "errors": errs,
           "bwd_bit_identical": True, "fwd_bit_identical": True,
           "bwd_replay_bit_identical": True,
           "fwd": {"max_abs_err": max(errs["out"]["max_abs_err"], lse_err)},
           "dq": {"max_abs_err": errs["dq"]["max_abs_err"]},
           "dkv": {"max_abs_err": max(errs["dk"]["max_abs_err"],
                                      errs["dv"]["max_abs_err"])}}
    if not timed:
        return row

    # times, rotating two input sets (> 50 MB of operands at the main shapes)
    lses, deltas = [], []
    for qq, kk, vv, dd in sets:
        o, l_ = flash_fwd_parts_plain(qq, kk, vv, causal=causal)
        lses.append(l_)
        deltas.append(flash_delta(dd, o))
    fwd = time_ms(lambda i: flash_fwd_parts(*sets[i][:3], causal=causal), 2)
    dq = time_ms(lambda i: flash_bwd_dq(*sets[i], lses[i], deltas[i],
                                        causal=causal), 2)
    dkv = time_ms(lambda i: flash_bwd_dkv(*sets[i], lses[i], deltas[i],
                                          causal=causal), 2)
    p_fwd = time_ms(lambda i: flash_fwd_parts_plain(*sets[i][:3], causal=causal),
                    2, per=4, reps=7)
    p_dq = time_ms(lambda i: flash_bwd_dq_plain(*sets[i], lses[i], deltas[i],
                                                causal=causal), 2, per=4, reps=7)
    p_dkv = time_ms(lambda i: flash_bwd_dkv_plain(*sets[i], lses[i], deltas[i],
                                                  causal=causal), 2, per=4, reps=7)
    lib_fwd, lib_bwd, lib_fb = _sdpa_times(sets, b, h, t, dh, causal)
    pairs = attn_pairs(t, t, causal)
    esz = q.element_size()
    rate = BF16_FLOP_PER_S if dtype != torch.float32 else F32_FLOP_PER_S
    big = bh * t * dh * esz                  # one [BH, T, Dh] operand
    rows = bh * t * 4                        # one f32 row vector
    fwd_b = _bound(4 * big + rows, 4 * bh * dh * pairs, rate)
    dq_b = _bound(5 * big + 2 * rows, 6 * bh * dh * pairs, rate)
    dkv_b = _bound(6 * big + 2 * rows, 8 * bh * dh * pairs, rate)
    # E and F together compute dQ, dK, dV from q, k, v, dO, lse, delta: five
    # products (S, dP, dV, dK, dQ), as SDPA's backward runs them. The pair
    # runs seven (S and dP in both kernels), so it cannot reach this bound.
    bwd_b = _bound(7 * big + 2 * rows, 10 * bh * dh * pairs, rate)
    return {**row,
            "attended_pairs": pairs,
            "fwd": {"kernel_ms": fwd, "plain_ms": p_fwd, "library_ms": lib_fwd,
                    "max_abs_err": max(errs["out"]["max_abs_err"], lse_err),
                    **fwd_b, **_shares(fwd, fwd_b["bound_ms"], lib_fwd)},
            "dq": {"kernel_ms": dq, "plain_ms": p_dq, "library_ms": lib_bwd,
                   "max_abs_err": errs["dq"]["max_abs_err"],
                   **dq_b, **_shares(dq, dq_b["bound_ms"], lib_bwd)},
            "dkv": {"kernel_ms": dkv, "plain_ms": p_dkv, "library_ms": lib_bwd,
                    "max_abs_err": max(errs["dk"]["max_abs_err"],
                                       errs["dv"]["max_abs_err"]),
                    **dkv_b, **_shares(dkv, dkv_b["bound_ms"], lib_bwd)},
            "bwd": {"kernel_ms": dq + dkv, "plain_ms": p_dq + p_dkv,
                    "library_ms": lib_bwd,
                    "max_abs_err": max(errs[o]["max_abs_err"]
                                       for o in ("dq", "dk", "dv")),
                    **bwd_b, **_shares(dq + dkv, bwd_b["bound_ms"], lib_bwd)},
            "library": "scaled_dot_product_attention: forward (fwd), backward "
                       "of dQ, dK and dV together (dq, dkv, bwd rows; bwd "
                       "is E + F)",
            "sdpa_fwd_bwd_ms": lib_fb}


def _precise_vs_default(q, k, v, do, causal) -> dict:
    """Kernels D, E, F and their f32-precise variants, each run end to end
    (the backward from its own forward's lse and delta) on the same 16-bit
    inputs: mean errors against the f64 evaluation, the precise ones at
    most 1 / PRECISE_GAIN of the default's."""
    def run(fwd, dq, dkv):
        out, lse = fwd(q, k, v, causal=causal)
        delta = flash_delta(do, out)
        return (out, dq(q, k, v, do, lse, delta, causal=causal),
                *dkv(q, k, v, do, lse, delta, causal=causal))

    errs = {}
    for mode, fns in (("precise", (flash_fwd_precise, flash_bwd_dq_precise,
                                   flash_bwd_dkv_precise)),
                      ("default", (flash_fwd_parts, flash_bwd_dq,
                                   flash_bwd_dkv))):
        outs = run(*fns)
        errs[mode] = dict(zip(("out", "dq", "dk", "dv"),
                              flash_mean_errors_f64(outs, q, k, v, do,
                                                    causal=causal)))
        del outs
    gain = {o: errs["default"][o] / errs["precise"][o] for o in errs["default"]}
    assert all(g >= PRECISE_GAIN for g in gain.values()), (q.shape, causal, errs)
    return {"mean_abs_err_f64": errs, "default_over_precise": gain,
            "min_gain": PRECISE_GAIN}


def check_flash_precise(dtype, b, h, t, dh, causal, seed=0, timed=True):
    """The three f32-precise flash kernels (csrc/flash_precise.cu) against
    their plain versions with ``precise=True`` (what
    DSTPU_FLASH_F32_PRECISE=1 selects), row by row, at one shape; the
    backward from the plain version's lse and delta. On 16-bit inputs, the
    precise and default kernels against an f64 evaluation
    (:func:`_precise_vs_default`). Their times beside the plain versions'
    and SDPA's on f32 copies of the operands (the library's computation in
    f32); the bound with q.k^T and dO.v^T at the storage dtype's rate and
    the f32-operand products at the f32 CUDA-core rate."""
    dev = "cuda"
    bh = b * h
    sets = [flash_inputs(dev, dtype, bh, t, dh, seed=seed + i) for i in range(2)]
    q, k, v, do = sets[0]
    out, lse = flash_fwd_precise(q, k, v, causal=causal)
    ref, ref_lse = flash_fwd_parts_plain(q, k, v, causal=causal, precise=True)
    delta = flash_delta(do, ref)
    grads = (flash_bwd_dq_precise(q, k, v, do, ref_lse, delta, causal=causal),
             *flash_bwd_dkv_precise(q, k, v, do, ref_lse, delta, causal=causal))
    again = (flash_bwd_dq_precise(q, k, v, do, ref_lse, delta, causal=causal),
             *flash_bwd_dkv_precise(q, k, v, do, ref_lse, delta, causal=causal))
    plain = (flash_bwd_dq_plain(q, k, v, do, ref_lse, delta, causal=causal,
                                precise=True),
             *flash_bwd_dkv_plain(q, k, v, do, ref_lse, delta, causal=causal,
                                  precise=True))
    torch.cuda.synchronize()
    tol = PRECISE_TOL[dtype]
    errs = {}
    for name, got, want in (("out", out, ref), ("dq", grads[0], plain[0]),
                            ("dk", grads[1], plain[1]),
                            ("dv", grads[2], plain[2])):
        assert torch.isfinite(got.float()).all(), name
        errs[name] = {"max_abs_err": (got.float() - want.float()).abs().max().item(),
                      "rel_err": rel_err(got, want)}
        assert errs[name]["rel_err"] <= tol, (name, dtype, b, h, t, dh, causal,
                                              errs[name])
    lse_err = (lse - ref_lse).abs().max().item()
    assert lse_err <= LSE_TOL, ("lse", lse_err)
    assert all(torch.equal(x, y) for x, y in zip(grads, again)), \
        "precise flash backward not bit-identical across launches"
    row = {"dtype": str(dtype).split(".")[-1], "b": b, "h": h, "t": t,
           "dh": dh, "causal": causal, "tol_rel": tol,
           "lse_max_abs_err": lse_err, "errors": errs}
    del out, ref, grads, again, plain
    if dtype != torch.float32:
        row["vs_f64"] = _precise_vs_default(q, k, v, do, causal)
    if not timed:
        return row
    lses, deltas = [], []
    for qq, kk, vv, dd in sets:
        o, l_ = flash_fwd_parts_plain(qq, kk, vv, causal=causal, precise=True)
        lses.append(l_)
        deltas.append(flash_delta(dd, o))
    fwd = time_ms(lambda i: flash_fwd_precise(*sets[i][:3], causal=causal), 2,
                  per=4, reps=7)
    dq = time_ms(lambda i: flash_bwd_dq_precise(*sets[i], lses[i], deltas[i],
                                                causal=causal), 2, per=4, reps=7)
    dkv = time_ms(lambda i: flash_bwd_dkv_precise(*sets[i], lses[i], deltas[i],
                                                  causal=causal), 2, per=4, reps=7)
    p_fwd = time_ms(lambda i: flash_fwd_parts_plain(*sets[i][:3], causal=causal,
                                                    precise=True),
                    2, per=4, reps=7)
    p_dq = time_ms(lambda i: flash_bwd_dq_plain(*sets[i], lses[i], deltas[i],
                                                causal=causal, precise=True),
                   2, per=4, reps=7)
    p_dkv = time_ms(lambda i: flash_bwd_dkv_plain(*sets[i], lses[i], deltas[i],
                                                  causal=causal, precise=True),
                    2, per=4, reps=7)
    sets32 = [[x.float() for x in st] for st in sets]
    lib_fwd, lib_bwd, lib_fb = _sdpa_times(sets32, b, h, t, dh, causal)
    del sets32
    pairs = attn_pairs(t, t, causal)
    big = bh * t * dh * q.element_size()
    rows = bh * t * 4
    # q.k^T (all three) and dO.v^T (dQ, dK/dV) from storage-dtype operands;
    # p.V (forward), dS.K (dQ), p^T.dO and dS^T.q (dK/dV) from f32 p and dS
    rate = BF16_FLOP_PER_S if dtype != torch.float32 else F32_FLOP_PER_S
    product = 2 * bh * dh * pairs
    fwd_b = _bound_mixed(4 * big + rows, product, 1, 1, rate)
    dq_b = _bound_mixed(5 * big + 2 * rows, product, 2, 1, rate)
    dkv_b = _bound_mixed(6 * big + 2 * rows, product, 2, 2, rate)
    row.update({
        "attended_pairs": pairs,
        "fwd": {"kernel_ms": fwd, "plain_ms": p_fwd, "library_ms": lib_fwd,
                "max_abs_err": max(errs["out"]["max_abs_err"], lse_err),
                **fwd_b, **_shares(fwd, fwd_b["bound_ms"], lib_fwd)},
        "dq": {"kernel_ms": dq, "plain_ms": p_dq, "library_ms": lib_bwd,
               "max_abs_err": errs["dq"]["max_abs_err"],
               **dq_b, **_shares(dq, dq_b["bound_ms"], lib_bwd)},
        "dkv": {"kernel_ms": dkv, "plain_ms": p_dkv, "library_ms": lib_bwd,
                "max_abs_err": max(errs["dk"]["max_abs_err"],
                                   errs["dv"]["max_abs_err"]),
                **dkv_b, **_shares(dkv, dkv_b["bound_ms"], lib_bwd)},
        "library": "scaled_dot_product_attention on f32 copies: forward "
                   "(fwd), backward of dQ, dK and dV together (dq, dkv)",
        "sdpa_f32_fwd_bwd_ms": lib_fb})
    return row


def check_flash_decode(dtype, b, hq, hkv, s, dh, idxs, seed=0):
    """The flash-decode kernel (rep >= 2) or its rep-1 variant against
    :func:`flash_decode_plain` at one geometry: each ``idx`` as a python int
    and as a device tensor, row by row (kernel_check.rel_err); values past
    idx set to 1e4 must leave the output bit for bit unchanged, and a second
    launch must repeat it bit for bit. At rep >= 2, the fused decode step
    (kernel B, the same body under the same plan) on the same cache,
    writing back row idx's own values, bit for bit. Then the times at the
    largest idx, on copies of the cache rotated through more than the L2
    holds: the kernel (also under the other plans of ``PLANS``), the plain
    version, and SDPA over the valid prefix."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    q, k, v = rnd(b, 1, hq, dh), rnd(b, hkv, s, dh), rnd(b, hkv, s, dh)
    tol = FLASH_DECODE_TOL[dtype]
    errs = []
    for idx in idxs:
        out = flash_decode(q, k, v, idx)
        ref = flash_decode_plain(q, k, v, idx)
        dev_idx = torch.tensor(idx, dtype=torch.int32, device=dev)
        k2, v2 = k.clone(), v.clone()
        k2[:, :, idx + 1:] = 1e4
        v2[:, :, idx + 1:] = 1e4
        torch.cuda.synchronize()
        assert torch.isfinite(out.float()).all()
        err = rel_err(out, ref)
        assert err <= tol, ("flash_decode", dtype, b, hq, hkv, s, idx, err)
        assert torch.equal(flash_decode(q, k2, v2, idx), out), \
            f"flash_decode reads past idx {idx}"
        assert torch.equal(flash_decode(q, k, v, idx), out), \
            "flash_decode not bit-identical run to run"
        assert torch.equal(flash_decode(q, k, v, dev_idx), out), \
            "device-tensor idx differs from the python int"
        errs.append({"idx": idx, "rel_err": err,
                     "max_abs_err": (out.float() - ref.float()).abs().max().item()})
        del k2, v2
    fused = None
    if hq != hkv:
        for idx in idxs:
            row = min(idx, s - 1)
            step, _, _ = fused_decode_step(
                q, k[None].clone(), v[None].clone(),
                k[:, :, row].unsqueeze(1).contiguous(),
                v[:, :, row].unsqueeze(1).contiguous(), 0, idx)
            out = flash_decode(q, k, v, idx)
            torch.cuda.synchronize()
            assert torch.equal(out, step), \
                f"flash_decode differs from the fused step at idx {idx}"
        fused = {"bit_identical": True}
    idx = max(idxs)
    n_pos = idx + 1
    esz = q.element_size()
    cache_bytes = 2 * b * hkv * s * dh * esz
    n_t = max(2, math.ceil(1.5 * L2_BYTES / cache_bytes))
    ks = [k] + [rnd(b, hkv, s, dh) for _ in range(n_t - 1)]
    vs = [v] + [rnd(b, hkv, s, dh) for _ in range(n_t - 1)]
    kernel_ms = time_ms(lambda i: flash_decode(q, ks[i], vs[i], idx), n_t)
    plans = (_plan_times("split_plan",
                         lambda i: flash_decode(q, ks[i], vs[i], idx), n_t,
                         (b, hkv, s, dh, esz), PLANS) if hq != hkv else None)
    plain_ms = time_ms(lambda i: flash_decode_plain(q, ks[i], vs[i], idx), n_t)
    qs = q.transpose(1, 2)                      # [B, Hq, 1, Dh]
    gqa = {"enable_gqa": True} if hq != hkv else {}
    library_ms = time_ms(
        lambda i: torch.nn.functional.scaled_dot_product_attention(
            qs, ks[i][:, :, :n_pos], vs[i][:, :, :n_pos], **gqa), n_t)
    del ks, vs
    nbytes = (2 * b * hq * dh * esz                      # q in, out
              + 2 * b * hkv * n_pos * dh * esz)          # K, V valid prefix
    flops = 4 * b * hq * dh * n_pos                      # QK^T and P.V
    rate = BF16_FLOP_PER_S if dtype != torch.float32 else F32_FLOP_PER_S
    bound = _bound(nbytes, flops, rate)
    return {"variant": "mha (rep 1)" if hq == hkv else "gqa",
            "dtype": str(dtype).split(".")[-1], "b": b, "hq": hq, "hkv": hkv,
            "s": s, "dh": dh, "idx": list(idxs), "errors": errs,
            "max_abs_err": max(e["max_abs_err"] for e in errs),
            "tol_rel": tol, "past_idx_unchanged": True,
            "bit_identical_run_to_run": True, "fused_step": fused,
            "timed_idx": idx, "timing_copies": n_t, "kernel_ms": kernel_ms,
            "plans": plans,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "scaled_dot_product_attention over the valid prefix"
                       + (" (enable_gqa)" if gqa else ""),
            **bound, **_shares(kernel_ms, bound["bound_ms"], library_ms)}


def _fixed_chunk(chunk: int):
    return lambda b, hkv, s, sms, *body: (chunk, -(-s // chunk))


# split plans timed against each other at the flash-decode, kernel B and
# kernel C rows: the two plans of decode_step and fixed chunks (16 to 256)
PLANS = {"split_plan": split_plan,
         "block_split_plan": lambda b, hkv, s, sms, *body: block_split_plan(
             b, hkv, s, sms),
         **{f"chunk_{c}": _fixed_chunk(c) for c in (16, 32, 64, 128, 256)}}


def _plan_times(attr: str, call, n_t: int, args: tuple, plans) -> dict:
    """``call``'s time (:func:`time_ms`) under each named plan of ``PLANS``
    in ``plans``. The wrappers look up their plan function by name in
    ``ops/decode_step.py`` at every call (``attr``: ``split_plan`` for
    kernel B and flash-decode, ``block_split_plan`` for kernel C), so each
    plan is set there for its timing and the wrapper's own is put back
    after. ``args``: the plan's arguments but the SM count, as the wrapper
    passes them ((B, Hkv, S, Dh, element size) or (B, Hkv, S)). Timing
    only: the results under the wrapper's own plan are checked by the
    caller."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    own = getattr(decode_step_module, attr)
    out = {}
    try:
        for name in plans:
            fn = PLANS[name]
            setattr(decode_step_module, attr, fn)
            out[name] = {"chunk_splits": list(fn(*args[:3], sms, *args[3:])),
                         "kernel_ms": time_ms(call, n_t)}
    finally:
        setattr(decode_step_module, attr, own)
    return out


LLAMA7B_MATMULS = [("wq", 4096, 4096), ("wk", 4096, 4096),
                   ("wv", 4096, 4096), ("wo", 4096, 4096),
                   ("w_gate", 4096, 11008), ("w_up", 4096, 11008),
                   ("w_down", 11008, 4096)]


def phase_kernels() -> dict:
    s = 1024
    idx = [0, s - 1, s, 17, 500, 733, 256, 1000]
    decode = [check_decode_step(8, 32, 32, s, 128, idx),
              check_decode_step(8, 32, 8, s, 128, idx, seed=1)]
    bidx = [0, 15, 16, 1023, 500, 733, 256, 37]    # the last slot inactive
    block, edges = [], []
    for hkv in (32, 8):
        for kv in (None, "int8", "fp8"):
            block.append(check_block_decode_step(8, 32, hkv, 128, 16, 64, kv,
                                                 bidx, seed=2))
            edges.append(check_block_decode_edges(hkv, kv, graph=True))
            torch.cuda.empty_cache()
    # N 24: the int8 engine's verify at k-bucket 2 (8 slots x 3 rows: one
    # full 16-row tile, one partly filled)
    matmul = []
    for d, e in ((4096, 4096), (4096, 11008), (11008, 4096)):
        for n in (1, 8, 24, 32):
            matmul.append(check_int8_matmul(n, d, e))
            torch.cuda.empty_cache()
    flash = [check_flash(torch.bfloat16, 8, 20, 1024, 64, True),
             check_flash(torch.bfloat16, 8, 20, 1024, 64, False),
             check_flash(torch.bfloat16, 4, 16, 2048, 128, True),
             check_flash(torch.bfloat16, 4, 16, 2048, 128, False),
             check_flash(torch.float32, 2, 4, 200, 64, True),
             check_flash(torch.float32, 2, 2, 136, 128, False),
             # ragged: T 1000 is no multiple of the 64-row tile
             check_flash(torch.bfloat16, 8, 20, 1000, 64, True),
             # TinyLlama-1.1B's training shape (train_tinyllama), untimed
             check_flash(torch.bfloat16, 4, 32, 2048, 64, True, timed=False),
             # GPT-2 774M's random-LTD middle layers (T_keep 512 of 1024)
             check_flash(torch.bfloat16, 8, 20, 512, 64, True)]
    torch.cuda.empty_cache()
    # the f32-precise kernels at the same main shapes, then untimed rows at
    # TinyLlama-1.1B's training shape, in fp16 and f32 and at a causal tail
    # no multiple of the 32-row tile
    precise = [check_flash_precise(torch.bfloat16, 8, 20, 1024, 64, True),
               check_flash_precise(torch.bfloat16, 8, 20, 1024, 64, False),
               check_flash_precise(torch.bfloat16, 4, 16, 2048, 128, True),
               check_flash_precise(torch.bfloat16, 4, 16, 2048, 128, False),
               check_flash_precise(torch.bfloat16, 4, 32, 2048, 64, True,
                                   timed=False),
               check_flash_precise(torch.float16, 2, 4, 1000, 64, True,
                                   timed=False),
               check_flash_precise(torch.float32, 2, 2, 136, 128, False,
                                   timed=False),
               check_flash_precise(torch.bfloat16, 2, 4, 130, 128, True,
                                   timed=False)]
    torch.cuda.empty_cache()
    # flash-decode: (a) CodeLlama-34B decode at batch 1 (generate's route),
    # (b) batch 4, (c) the rep-1 variant at LLaMA-7B's shape, (d, e) f32 at
    # batch 1 and 4, (f-h) more rep-1 rows
    fidx = [0, 127, 128, 639]
    fdec = [check_flash_decode(torch.bfloat16, 1, 64, 8, 640, 128, fidx),
            check_flash_decode(torch.bfloat16, 4, 64, 8, 640, 128, fidx, seed=1),
            check_flash_decode(torch.bfloat16, 8, 32, 32, 1024, 128,
                               [0, 511, 1023], seed=2),
            check_flash_decode(torch.float32, 1, 64, 8, 640, 128, fidx, seed=3),
            check_flash_decode(torch.float32, 4, 64, 8, 640, 128, fidx, seed=4),
            # rep 1 at Dh 64 and 256 and in fp16, S 1000 no multiple of
            # the 32-position stage
            check_flash_decode(torch.bfloat16, 8, 32, 32, 1000, 64,
                               [0, 31, 32, 511, 999], seed=5),
            check_flash_decode(torch.float16, 8, 32, 32, 1024, 128,
                               [0, 511, 1023], seed=6),
            check_flash_decode(torch.bfloat16, 4, 16, 16, 1000, 256,
                               [0, 63, 64, 999], seed=7)]
    torch.cuda.empty_cache()
    # kernel B on generate's routes: rep 8 (CodeLlama-34B, batch 4) and
    # Dh 64 MHA (GPT-2 774M, batch 4); enough layers to rotate past the L2
    decode += [check_decode_step(4, 64, 8, 640, 128, [0, 127, 128, 639],
                                 layers=8, seed=3),
               check_decode_step(4, 20, 20, 256, 64, [0, 127, 128, 255],
                                 layers=16, seed=4)]
    # kernel B at the TinyLlama-width draft model's rollout (serve_spec run
    # b): 8 slots, 32 / 4 heads (rep 8) at Dh 64 over the 128-position
    # draft cache; 64 layers rotate past the L2
    decode.append(check_decode_step(8, 32, 4, 128, 64,
                                    [0, 127, 128, 64, 17, 100, 1, 126],
                                    layers=64, seed=5))
    # and at the self-drafting rollout (serve_spec runs a, c2, d2): LLaMA-7B
    # MHA (32 / 32 heads, Dh 128) over the same 128-position draft cache;
    # 8 layers rotate past the L2
    decode.append(check_decode_step(8, 32, 32, 128, 128,
                                    [0, 127, 128, 64, 17, 100, 1, 126],
                                    layers=8, seed=6))
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "fused_decode_step": decode,
          "fused_block_decode_step": block,
          "fused_block_decode_step_edges": edges, "int8_matmul_dma": matmul,
          "flash_attention": flash, "flash_precise": precise,
          "flash_decode": fdec})
    return {"fused_decode_step": decode, "fused_block_decode_step": block,
            "fused_block_decode_step_edges": edges, "int8_matmul_dma": matmul,
            "flash_attention": flash, "flash_precise": precise,
            "flash_decode": fdec}


def kernel_summary(kern: dict, launches: dict, sparse: dict) -> list:
    """:func:`_kernel_rows`, each with its bound share and its time over the
    library call's."""
    return [{**row, **_shares(row["ms"], row["bound_ms"], row["library_ms"])}
            for row in _kernel_rows(kern, launches, sparse)]


def _kernel_rows(kern: dict, launches: dict, sparse: dict) -> list:
    """One entry per kernel at the main path's shapes: the MHA decode step at
    8 slots, the MHA block decode step over a bf16 pool at 8 slots, one
    decode layer's seven int8 matmuls at N = 8 (summed; the gridded form on
    the same shapes), and the block-sparse kernels at row (a) of the
    sparse_attention phase."""
    dec = kern["fused_decode_step"][0]
    blk = kern["fused_block_decode_step"][0]
    by_shape = {(r["n"], r["d"], r["e"]): r for r in kern["int8_matmul_dma"]}
    layer_rows = [by_shape[(8, d, e)] for _, d, e in LLAMA7B_MATMULS]

    def total(key):
        return sum(r[key] for r in layer_rows)

    mm_bytes = sum(r["bytes"] for r in layer_rows)
    mm_flops = sum(r["flops"] for r in layer_rows)
    return [
        dict(name="fused_decode_step", route="cuda",
             **KERNELS["fused_decode_step"],
             launches=launches["fused_decode_step"],
             max_abs_err=max(r["max_abs_err"]
                             for r in kern["fused_decode_step"]),
             ms=dec["kernel_ms"], plain_ms=dec["plain_ms"],
             bound_ms=dec["bound_ms"], bound_by=dec["bound_by"],
             library_ms=dec["library_ms"]),
        dict(name="int8_matmul_dma", route="cuda",
             **KERNELS["int8_matmul_dma"],
             launches=launches["int8_matmul_dma"],
             max_abs_err=max(r["max_abs_err"]
                             for r in kern["int8_matmul_dma"]),
             ms=total("kernel_ms"), plain_ms=total("plain_ms"),
             bound_ms=1e3 * max(mm_bytes / HBM_BYTES_PER_S,
                                mm_flops / BF16_FLOP_PER_S),
             bound_by=("bytes" if mm_bytes / HBM_BYTES_PER_S
                       >= mm_flops / BF16_FLOP_PER_S else "operations"),
             library_ms=total("library_ms")),
        dict(name="fused_block_decode_step", route="cuda",
             **KERNELS["fused_block_decode_step"],
             launches=launches["fused_block_decode_step"],
             max_abs_err=max(r["max_abs_err"]
                             for r in kern["fused_block_decode_step"]
                             + kern["fused_block_decode_step_edges"]),
             ms=blk["kernel_ms"], plain_ms=blk["plain_ms"],
             bound_ms=blk["bound_ms"], bound_by=blk["bound_by"],
             library_ms=blk["library_ms"]),
    ] + [
        # the flash kernels at the GPT-2 774M training shape (bf16, causal)
        dict(name=name, route="cuda", **KERNELS[name],
             launches=launches[name],
             max_abs_err=max(r[key]["max_abs_err"]
                             for r in kern["flash_attention"]),
             ms=kern["flash_attention"][0][key]["kernel_ms"],
             plain_ms=kern["flash_attention"][0][key]["plain_ms"],
             bound_ms=kern["flash_attention"][0][key]["bound_ms"],
             bound_by=kern["flash_attention"][0][key]["bound_by"],
             library_ms=kern["flash_attention"][0][key]["library_ms"])
        for name, key in zip(FLASH, ("fwd", "dq", "dkv"))] + [
        # the f32-precise flash kernels at the same shape; errors over
        # every row
        dict(name=name, route="cuda", **KERNELS[name],
             launches=launches[name],
             max_abs_err=max(r["errors"][o]["max_abs_err"]
                             for r in kern["flash_precise"] for o in outs),
             ms=kern["flash_precise"][0][key]["kernel_ms"],
             plain_ms=kern["flash_precise"][0][key]["plain_ms"],
             bound_ms=kern["flash_precise"][0][key]["bound_ms"],
             bound_by=kern["flash_precise"][0][key]["bound_by"],
             library_ms=kern["flash_precise"][0][key]["library_ms"])
        for name, key, outs in zip(PRECISE, ("fwd", "dq", "dkv"),
                                   (("out",), ("dq",), ("dk", "dv")))] + [
        # flash-decode at CodeLlama-34B's batch-1 decode (idx 639); its rep-1
        # variant at LLaMA-7B's (B 8, idx 1023), unrouted on the main path
        dict(name=name, route="cuda", **KERNELS[name],
             launches=launches[name],
             max_abs_err=max(r["max_abs_err"] for r in kern["flash_decode"]
                             if (r["hq"] == r["hkv"]) == (name != "flash_decode")),
             ms=row["kernel_ms"], plain_ms=row["plain_ms"],
             bound_ms=row["bound_ms"], bound_by=row["bound_by"],
             library_ms=row["library_ms"])
        for name, row in (("flash_decode", kern["flash_decode"][0]),
                          ("flash_decode_mha", kern["flash_decode"][2]))] + [
        # the block-sparse kernels at row (a); errors over every row
        dict(name=name, route="cuda", **KERNELS[name], launches=launches[name],
             max_abs_err=max(max(r["errors"][o]["max_abs_err"] for o in outs)
                             for r in sparse["rows"]),
             ms=sparse["rows"][0][key]["kernel_ms"],
             plain_ms=sparse["rows"][0][key]["plain_ms"],
             bound_ms=sparse["rows"][0][key]["bound_ms"],
             bound_by=sparse["rows"][0][key]["bound_by"],
             library_ms=sparse["rows"][0][key]["library_ms"])
        for name, key, outs in zip(SPARSE, ("fwd", "dq", "dkv"),
                                   (("out",), ("dq",), ("dk", "dv")))] + [
        # the gridded int8 matmul (unrouted) on kernel 2's layer at N = 8
        dict(name="int8_matmul", route="cuda", **KERNELS["int8_matmul"],
             launches=launches["int8_matmul"],
             max_abs_err=max(r["grid"]["max_abs_err"]
                             for r in kern["int8_matmul_dma"]),
             ms=sum(r["grid"]["kernel_ms"] for r in layer_rows),
             plain_ms=total("plain_ms"),
             bound_ms=1e3 * max(mm_bytes / HBM_BYTES_PER_S,
                                mm_flops / BF16_FLOP_PER_S),
             bound_by=("bytes" if mm_bytes / HBM_BYTES_PER_S
                       >= mm_flops / BF16_FLOP_PER_S else "operations"),
             library_ms=total("library_ms"))]


# ------------------------------------------------------- sparse attention
def _sparse_configs(sa) -> list:
    """Rows of the sparse_attention phase: (name, sparsity config or a
    hand-made layout, B, T, H, Dh, dtype, causal or None for the config's
    default, timed, held against the dense oracle)."""
    return [
        # (a) GPT-style causal at LLaMA-7B's attention width (32 x Dh 128)
        ("a_fixed_causal_llama7b",
         sa.FixedSparsityConfig(num_heads=32, block=16, num_local_blocks=4,
                                num_global_blocks=1,
                                attention="unidirectional"),
         1, 8192, 32, 128, torch.bfloat16, None, True, False),
        # (b) BERT-style bidirectional at BERT-large's width (16 x Dh 64)
        ("b_bigbird_bertlarge", sa.BigBirdSparsityConfig(num_heads=16, block=16),
         4, 4096, 16, 64, torch.bfloat16, None, True, True),
        # (c) small check rows: f32, blocks 32 and 64, a row with no key
        ("c_f32_longformer", sa.BSLongformerSparsityConfig(
            num_heads=4, block=16, global_block_indices=[0, 7]),
         2, 512, 4, 128, torch.float32, None, False, True),
        ("c_block32_fixed", sa.FixedSparsityConfig(
            num_heads=8, block=32, num_local_blocks=4,
            attention="unidirectional"),
         2, 1024, 8, 64, torch.bfloat16, None, False, True),
        ("c_block64_bigbird", sa.BigBirdSparsityConfig(
            num_heads=4, block=64, different_layout_per_head=True, seed=2),
         2, 1024, 4, 128, torch.bfloat16, None, False, True),
        # fp16, its global rows (128 entries) cut in parts of the work list
        ("c_fp16_bigbird", sa.BigBirdSparsityConfig(num_heads=8, block=16),
         2, 2048, 8, 64, torch.float16, None, False, True),
        ("c_masked_row", masked_row_layout(4, 16),
         2, 256, 4, 64, torch.bfloat16, True, False, True),
    ]


def _layout_stats(layout: np.ndarray) -> dict:
    rows, cols = layout.sum(2), layout.sum(1)
    return {"active_blocks": int(layout.sum()),
            "density": float(layout.mean()), "lut_width": int(rows.max()),
            "longest_row": int(rows.max()), "longest_col": int(cols.max()),
            "mean_row": float(rows.mean())}


def check_sparse_row(sa, name, cfg, b, t, h, dh, dtype, causal, timed, oracle,
                     dev="cuda", seed=0) -> dict:
    """One row of the sparse_attention phase: the main path (forward, then
    backward of a seeded dO, through SparseSelfAttention from the op
    registry) with launches counted; then each kernel against its plain
    version on the same flat operands (the backward kernels fed the plain
    lse and delta), a second launch bit for bit, the dense oracle, and at
    the main shapes the times of kernel, plain version and SDPA over the
    dense element mask."""
    if isinstance(cfg, np.ndarray):
        layout, block = cfg, t // cfg.shape[1]
        mod = None
    else:
        mod = sa.SparseSelfAttention(cfg)
        layout, block = mod.get_layout(t), cfg.block
        causal = (cfg.attention == "unidirectional") if causal is None else causal
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    q, k, v, do = (rnd(b, t, h, dh) for _ in range(4))
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    # the main path
    reset_counts()
    if mod is not None:
        out = mod(*leaves)
    else:
        out = sa.block_sparse_attention(*leaves, layout, block, causal)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    launches = read_counts()
    for kname, n in launches.items():
        want = 1 if kname in SPARSE else 0
        assert n == want, (name, kname, n, want)
    out = out.detach()
    # each kernel against its plain version on flat [B*H, T, Dh] operands
    flat = [x.permute(0, 2, 1, 3).reshape(b * h, t, dh).contiguous()
            for x in (q, k, v, do)]
    qf, kf, vf, dof = flat
    luts = sparse_luts(layout, dev)
    kw = dict(block=block, causal=causal)
    ref, ref_lse = block_sparse_fwd_plain(qf, kf, vf, luts, **kw)
    delta = block_sparse_delta(dof, ref)

    def kernels():
        o, lse = block_sparse_fwd(qf, kf, vf, luts, **kw)
        return (o, lse, block_sparse_bwd_dq(qf, kf, vf, dof, ref_lse, delta,
                                            luts, **kw),
                *block_sparse_bwd_dkv(qf, kf, vf, dof, ref_lse, delta, luts,
                                      **kw))

    got = kernels()
    again = kernels()
    plain = (ref, ref_lse,
             block_sparse_bwd_dq_plain(qf, kf, vf, dof, ref_lse, delta, luts, **kw),
             *block_sparse_bwd_dkv_plain(qf, kf, vf, dof, ref_lse, delta, luts,
                                         **kw))
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again)), \
        f"{name}: block-sparse kernels not bit-identical across launches"

    def to_flat(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, t, dh)

    assert torch.equal(to_flat(out), got[0]), f"{name}: main path out differs"
    tol = SPARSE_TOL[dtype]
    errs = {}
    for key, a, r in (("out", got[0], plain[0]), ("dq", got[2], plain[2]),
                      ("dk", got[3], plain[3]), ("dv", got[4], plain[4])):
        assert torch.isfinite(a.float()).all(), (name, key)
        errs[key] = {"rel_err": rel_err(a, r),
                     "max_abs_err": (a.float() - r.float()).abs().max().item()}
        assert errs[key]["rel_err"] <= tol, (name, key, errs[key])
    lse_err = (got[1] - plain[1]).abs().max().item()
    assert lse_err <= LSE_TOL, (name, "lse", lse_err)
    # the main path's gradients (from the kernel's own lse and delta)
    main_errs = {key: rel_err(to_flat(gr), p)
                 for key, gr, p in zip(("dq", "dk", "dv"), grads, plain[2:])}
    assert max(main_errs.values()) <= tol, (name, "main path grads", main_errs)
    # the work lists' balance, and that of four consecutive query (key)
    # blocks to a CUDA block (the first form of each kernel)
    groups = row_groups(block)
    row = {"row": name, "dtype": str(dtype).split(".")[-1], "b": b, "t": t,
           "h": h, "dh": dh, "block": block, "causal": causal,
           "config": type(cfg).__name__ if mod is not None else "hand-made",
           **_layout_stats(layout),
           # the forward's work list is dQ's (one table, one row geometry)
           "fwd_group_busy": group_busy(luts.fwd_items[:, 2].cpu().numpy(),
                                        groups),
           "fwd_group_busy_consecutive": group_busy(
               luts.cnt_q.cpu().numpy().reshape(-1), groups),
           "fwd_items": luts.fwd_items.shape[0],
           "fwd_split_rows": luts.fwd_merge.shape[0],
           "fwd_partials": luts.fwd_slots,
           "dq_group_busy": group_busy(luts.dq_items[:, 2].cpu().numpy(),
                                       groups),
           "dq_group_busy_consecutive": group_busy(
               luts.cnt_q.cpu().numpy().reshape(-1), groups),
           "dq_items": luts.dq_items.shape[0],
           "dq_split_rows": luts.dq_merge.shape[0],
           "dq_partials": luts.dq_slots,
           "dkv_group_busy": group_busy(luts.dkv_items[:, 2].cpu().numpy(),
                                        groups),
           "dkv_group_busy_consecutive": group_busy(
               luts.cnt_k.cpu().numpy().reshape(-1), groups),
           "dkv_items": luts.dkv_items.shape[0],
           "dkv_split_columns": luts.dkv_merge.shape[0],
           "dkv_partials": luts.dkv_slots,
           "launches": {k: launches[k] for k in SPARSE},
           "tol_rel": tol, "lse_max_abs_err": lse_err, "lse_tol": LSE_TOL,
           "errors": errs, "main_path_grad_rel_err": main_errs,
           "bit_identical_run_to_run": True}
    if name == "c_masked_row":
        rows = slice(block, 2 * block)
        assert (out[:, rows] == 0).all() and (grads[0][:, rows] == 0).all()
        assert (got[1].view(b, h, t)[..., rows] <= -1e30).all()
        row["masked_rows_zero"] = True
    del got, again, plain, ref, delta
    if oracle:
        leaves_o = [x.detach().requires_grad_() for x in (q, k, v)]
        o_ref = block_sparse_attention_reference(*leaves_o, layout, block, causal)
        g_ref = torch.autograd.grad(o_ref, leaves_o, do)
        row["oracle_rel_err"] = {"out": rel_err(out, o_ref), **{
            key: rel_err(gr, gr_ref)
            for key, gr, gr_ref in zip(("dq", "dk", "dv"), grads, g_ref)}}
        assert row["oracle_rel_err"]["out"] <= tol, (name, row["oracle_rel_err"])
        if dtype == torch.float32:
            assert max(row["oracle_rel_err"].values()) <= SPARSE_ORACLE_GRAD_TOL, \
                (name, row["oracle_rel_err"])
        del leaves_o, o_ref, g_ref
    del leaves, grads, out
    if timed:
        row.update(_time_sparse(qf, kf, vf, dof, luts, layout, kw, b, h, t, dh,
                                dtype, seed))
    return row


def _time_sparse(qf, kf, vf, dof, luts, layout, kw, b, h, t, dh, dtype, seed):
    """Times on two input sets (> 50 MB of operands at the main shapes):
    kernels, plain versions, and SDPA over the dense element mask (the
    layout's blocks, and the causal triangle where it applies), forward and
    backward, each captured in a CUDA graph. Bounds from the active-block
    work and the bytes each kernel must move."""
    g = torch.Generator(device=qf.device).manual_seed(seed + 1)
    second = [torch.randn(x.shape, generator=g, device=qf.device).to(dtype)
              for x in (qf, kf, vf, dof)]
    sets = [(qf, kf, vf, dof), tuple(second)]
    rows = []
    for qq, kk, vv, dd in sets:
        o, l_ = block_sparse_fwd_plain(qq, kk, vv, luts, **kw)
        rows.append((l_, block_sparse_delta(dd, o)))
        del o
    fwd = time_ms(lambda i: block_sparse_fwd(*sets[i][:3], luts, **kw), 2,
                  per=5, reps=5)
    dq = time_ms(lambda i: block_sparse_bwd_dq(*sets[i], *rows[i], luts, **kw),
                 2, per=5, reps=5)
    dkv = time_ms(lambda i: block_sparse_bwd_dkv(*sets[i], *rows[i], luts, **kw),
                  2, per=5, reps=5)
    p_fwd = time_ms(lambda i: block_sparse_fwd_plain(*sets[i][:3], luts, **kw),
                    2, per=1, reps=3)
    p_dq = time_ms(lambda i: block_sparse_bwd_dq_plain(*sets[i], *rows[i], luts,
                                                       **kw), 2, per=1, reps=3)
    p_dkv = time_ms(lambda i: block_sparse_bwd_dkv_plain(*sets[i], *rows[i],
                                                         luts, **kw),
                    2, per=1, reps=3)
    # yardstick: SDPA on [B, H, T, Dh] views over the dense element mask
    mask = torch.from_numpy(layout_to_dense_mask(layout, kw["block"])).to(qf.device)
    if kw["causal"]:
        mask &= torch.ones((t, t), dtype=torch.bool, device=qf.device).tril()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    views = [[x.view(b, h, t, dh) for x in st] for st in sets]
    lib_fwd = time_ms(lambda i: sdpa(*views[i][:3], attn_mask=mask), 2,
                      per=5, reps=5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graphs = []
        for i in range(2):
            lv = [x.detach().requires_grad_() for x in views[i][:3]]
            graphs.append((sdpa(*lv, attn_mask=mask), lv))
    lib_bwd = time_ms(
        lambda i: torch.autograd.grad(graphs[i][0], graphs[i][1], views[i][3],
                                      retain_graph=True), 2, per=5, reps=5,
        stream=side)
    del graphs, mask, second, sets, rows
    active = int(np.asarray(layout).sum()) * b          # active block tiles
    tile = kw["block"] ** 2 * dh
    esz = qf.element_size()
    big = b * h * t * dh * esz                          # one [BH, T, Dh]
    vec = b * h * t * 4                                 # one f32 row vector
    lut_dq = 4 * (luts.lut_q.numel() + luts.dq_items.numel()
                  + luts.dq_merge.numel())              # fwd/dq table, work list
    lut_t = 4 * (luts.lut_k.numel() + luts.dkv_items.numel()
                 + luts.dkv_merge.numel())              # dk/dv table, work list
    rate = BF16_FLOP_PER_S if dtype != torch.float32 else F32_FLOP_PER_S
    def f32_floor(ms, products):
        # the reference's f32 contract on the CUDA cores: 2 * block^2 * Dh
        # FLOP per product and active tile at the f32 peak, and the share of
        # it the kernel reaches
        floor = 1e3 * 2 * products * tile * active / F32_FLOP_PER_S
        return {"f32_floor_ms": floor, "f32_floor_share": floor / ms}

    return {
        "fwd": {"kernel_ms": fwd, "plain_ms": p_fwd, "library_ms": lib_fwd,
                **_bound(4 * big + vec + lut_dq, 4 * tile * active, rate),
                **f32_floor(fwd, 2)},
        "dq": {"kernel_ms": dq, "plain_ms": p_dq, "library_ms": lib_bwd,
               **_bound(5 * big + 2 * vec + lut_dq, 6 * tile * active, rate),
               **f32_floor(dq, 3)},
        "dkv": {"kernel_ms": dkv, "plain_ms": p_dkv, "library_ms": lib_bwd,
                **_bound(6 * big + 2 * vec + lut_t, 8 * tile * active, rate),
                **f32_floor(dkv, 4)},
        "total_ms": fwd + dq + dkv,
        "library": "scaled_dot_product_attention over the dense element "
                   "mask: forward (fwd), backward of dQ, dK and dV together "
                   "(dq, dkv rows)",
        "dense_attention_flops_fwd": 4 * b * h * dh * attn_pairs(
            t, t, kw["causal"])}


def phase_sparse_attention(dev: str = "cuda") -> dict:
    """Block-sparse attention through the op registry, at full width: rows
    (a) and (b) at the main shapes, timed; (c) small check rows."""
    sa = get_op_builder("sparse_attn")().load()
    rows = []
    for spec in _sparse_configs(sa):
        rows.append(check_sparse_row(sa, *spec, dev=dev))
        gc.collect()
        torch.cuda.empty_cache()
    launches = {k: sum(r["launches"][k] for r in rows) for k in SPARSE}
    info = {"phase": "sparse_attention", "rows": rows, "launches": launches}
    emit(info)
    return info


# --------------------------------------------------------------- phase 3
def phase_reference() -> dict:
    """A narrow LLaMA (Dh 128, widths that route both kernels) served by the
    port on the CPU — plain versions — and on the card — kernels — with the
    same weights, in fp32: the greedy tokens must be identical."""
    cfg = dict(vocab_size=512, max_seq_len=256, num_layers=2,
               hidden_size=256, num_heads=2, num_kv_heads=2,
               intermediate_size=512)
    rng = np.random.RandomState(7)
    reqs = poisson_trace(rng, 6, rate=1e3, prompt_lens=[5, 40, 100],
                         max_new_choices=[6, 12], vocab_size=512)
    out, programs = {}, {}
    for quant in (False, True):
        toks, params = {}, None
        for device in ("cpu", "cuda"):
            eng = deepspeed_tpu_torch.init_inference(
                LlamaModel(LlamaConfig(**cfg)), dtype="fp32", device=device,
                quant={"enabled": quant}, seed=3,
                params=None if params is None else _tree_to(params, device))
            params = eng.params
            if device == "cpu" and not quant:
                fp32_params = params
            reset_counts()
            srv = ServingEngine(eng, num_slots=4, max_len=256, buckets=(128,))
            toks[device] = {r.rid: r.tokens for r in srv.run(
                [Request(r.rid, r.prompt, r.max_new_tokens) for r in reqs])}
            if device == "cuda":
                assert fused_decode_step.launches > 0
                assert (int8_matmul_dma.launches > 0) == quant
                programs["int8" if quant else "fp32"] = serving_programs(srv)
        assert toks["cpu"] == toks["cuda"], (quant, toks)
        out["int8" if quant else "fp32"] = sum(map(len, toks["cpu"].values()))
    res = {"phase": "reference", "tokens_compared": out, "identical": True,
           "programs": programs,
           "block_paged": _reference_block(cfg, fp32_params),
           "speculative": _reference_spec(cfg, fp32_params)}
    emit(res)
    return res


def _reference_block(cfg: dict, params) -> dict:
    """The same small fp32 LLaMA, block-paged with a prefix cache: a
    shared-prefix trace over 41-token templates (not a multiple of the
    16-token block, so every hit after the first forks a block), served
    cold and then warm, with the pool in fp32, int8 and fp8. All requests
    arrive at once, so both devices admit in the same order."""
    reqs = shared_prefix_trace(np.random.RandomState(11), 8, rate=1e3,
                               prefix_len=41, suffix_lens=(3, 9, 20),
                               max_new_tokens=8, vocab_size=512)
    kw = dict(num_slots=4, max_len=256, buckets=(32, 64))

    def serve(srv):
        return {r.rid: r.tokens for r in srv.run(
            [Request(r.rid, r.prompt, r.max_new_tokens) for r in reqs])}

    out = {}
    for kv in (None, "int8", "fp8"):
        toks, counters = {}, {}
        for device in ("cpu", "cuda"):
            eng = deepspeed_tpu_torch.init_inference(
                LlamaModel(LlamaConfig(**cfg)), dtype="fp32", device=device,
                params=_tree_to(params, device))
            reset_counts()
            srv = ServingEngine(eng, prefix_cache=True, block_size=16,
                                kv_dtype=kv, **kw)
            toks[device] = (serve(srv), serve(srv))       # cold, warm
            counters[device] = (srv.prefill_tokens_computed,
                                srv.prefix.hit_tokens,
                                srv.prefix.blocks_cowed)
            assert srv.prefix.blocks_cowed > 0
            if device == "cuda":
                assert fused_block_decode_step.launches > 0
                assert fused_decode_step.launches == 0
                programs = serving_programs(srv)
            if kv is None:
                slot = ServingEngine(eng, **kw)
                assert serve(slot) == toks[device][0], \
                    f"block-paged != slot-paged tokens on {device}"
        assert toks["cpu"] == toks["cuda"], (kv, toks)
        assert counters["cpu"] == counters["cuda"], (kv, counters)
        out[kv or "fp32"] = {
            "tokens": 2 * sum(map(len, toks["cpu"][0].values())),
            "prefill_tokens": counters["cpu"][0],
            "hit_tokens": counters["cpu"][1], "forks": counters["cpu"][2],
            "programs": programs}
    return out


def _reference_spec(cfg: dict, params) -> dict:
    """The same small fp32 LLaMA with speculation (k-buckets 2, 4, 8):
    prompt lookup, and a draft model of the same shape from another seed
    (made on the CPU, so both devices draft with the same weights; a
    120-token window), each slot-paged and block-paged with the prefix
    cache. On each device the speculative greedy tokens equal the plain
    engine's; the card's tokens, drafts and acceptances equal the CPU's."""
    reqs = poisson_trace(np.random.RandomState(21), 6, rate=1e3,
                         prompt_lens=[5, 40, 100], max_new_choices=[12, 20],
                         vocab_size=512)
    draft_params = deepspeed_tpu_torch.init_inference(
        LlamaModel(LlamaConfig(**cfg)), dtype="fp32", device="cpu",
        seed=4).params
    kw = dict(num_slots=4, max_len=256, buckets=(128,))
    out = {}
    for store, skw in (("slot", {}),
                       ("block", dict(prefix_cache=True, block_size=16))):
        for mode in ("ngram", "draft"):
            toks, stats = {}, {}
            for device in ("cpu", "cuda"):
                eng = deepspeed_tpu_torch.init_inference(
                    LlamaModel(LlamaConfig(**cfg)), dtype="fp32",
                    device=device, params=_tree_to(params, device))
                spec = dict(mode=mode, k_buckets=(2, 4, 8))
                if mode == "draft":
                    spec.update(draft_window=120,
                                draft_engine=deepspeed_tpu_torch.init_inference(
                                    LlamaModel(LlamaConfig(**cfg)),
                                    dtype="fp32", device=device,
                                    params=_tree_to(draft_params, device)))
                reset_counts()
                srv = ServingEngine(eng, speculative=spec, **kw, **skw)
                toks[device] = {r.rid: r.tokens for r in srv.run(
                    [Request(r.rid, r.prompt, r.max_new_tokens)
                     for r in reqs])}
                launches = read_counts()
                plain = ServingEngine(eng, **kw, **skw)
                assert toks[device] == {r.rid: r.tokens for r in plain.run(
                    [Request(r.rid, r.prompt, r.max_new_tokens)
                     for r in reqs])}, f"spec != plain ({store} {mode} " \
                    f"{device})"
                stats[device] = (srv.spec_drafted_tokens,
                                 srv.spec_accepted_tokens, srv.decode_steps)
                assert srv.spec_drafted_tokens > 0
                if device == "cuda":
                    # the draft model's rollout runs the decode kernel; a
                    # block-paged n-gram engine runs it nowhere
                    if mode == "draft":
                        assert launches["fused_decode_step"] > 0, launches
                    elif skw:
                        assert launches["fused_decode_step"] == 0, launches
                    programs = spec_programs(srv)
            assert toks["cpu"] == toks["cuda"], (store, mode, toks)
            assert stats["cpu"] == stats["cuda"], (store, mode, stats)
            out[f"{store}_{mode}"] = {
                "tokens": sum(map(len, toks["cpu"].values())),
                "drafted": stats["cpu"][0], "accepted": stats["cpu"][1],
                "decode_steps": stats["cpu"][2], "programs": programs}
    return out


def _tree_to(node, device):
    if isinstance(node, dict):
        return {k: _tree_to(v, device) for k, v in node.items()}
    return node.to(device)


# ---------------------------------------------------- compile-once contract
class VirtualClock:
    """A serving clock that advances per read, so two engines that read it
    alike admit and finish alike, however long their steps take."""

    def __init__(self, dt=0.001):
        self.t, self.dt = 0.0, dt

    def __call__(self):
        self.t += self.dt
        return self.t


def serving_programs(srv) -> dict:
    """A ServingEngine's compile-once contract after its whole trace: every
    program has one entry (the decode step one CUDA graph, captured once)
    and nothing recompiled."""
    info = {"program_count": srv.program_count,
            "program_cache_sizes": srv.program_cache_sizes(),
            "recompile_count": srv.recompile_count(),
            "decode_captures": srv._decode.captures}
    assert set(info["program_cache_sizes"].values()) == {1}, info
    assert info["recompile_count"] == 0 and info["decode_captures"] == 1, info
    return info


def engine_programs(eng) -> dict:
    """An InferenceEngine's programs after its phase (jit_cache_sizes: one
    entry each, so no recompile; each generate step shape's token step
    captured once, evicted states included)."""
    sizes = eng.jit_cache_sizes()
    captures = eng.decode_captures()
    info = {"programs": len(sizes), "jit_cache_sizes": sizes,
            "recompile_count": sum(max(0, v - 1) for v in sizes.values()),
            "decode_captures": captures}
    assert set(sizes.values()) == {1} and info["recompile_count"] == 0, info
    assert captures and set(captures.values()) == {1}, info
    return info


def eager_server(srv, **kw) -> ServingEngine:
    """A ServingEngine like ``srv`` (over its own KV store, recording no
    telemetry) whose decode step runs the captured program's eager
    closure."""
    twin = ServingEngine(srv.engine, num_slots=srv.num_slots,
                         max_len=srv.max_len, buckets=srv.buckets,
                         telemetry=False, **kw)
    twin._decode = twin._decode.eager
    return twin


def replayed_vs_eager(graph_tokens: dict, eager_tokens: dict) -> dict:
    """Replayed tokens against the eager closure's, bit for bit."""
    assert graph_tokens == eager_tokens, "replayed tokens != eager tokens"
    return {"requests": len(graph_tokens),
            "tokens": sum(map(len, graph_tokens.values())),
            "bit_identical": True}


def _step_state(eng, b: int, t: int, max_new: int, do_sample=False,
                top_k=0, top_p=1.0):
    """The decode state (cache and token step) generate() runs this shape
    on."""
    return eng._decode_state(b, -(-(t + max_new) // 128) * 128, do_sample,
                             top_k, float(top_p))


def eager_generate(eng, prompt, max_new: int = None, **kw):
    """generate() with its decode state's token step run by the eager
    closure (the tokens must equal the replayed ones)."""
    max_new = kw.pop("max_new_tokens", max_new)
    b, t = prompt.shape
    state = _step_state(eng, b, t, max_new, kw.get("do_sample", False),
                        kw.get("top_k", 0), kw.get("top_p", 1.0))
    step = state.step
    state.step = step.eager
    try:
        return eng.generate(prompt, max_new_tokens=max_new, **kw)
    finally:
        state.step = step


# ------------------------------------------------------------ phases 4-5
def _trace():
    rng = np.random.RandomState(1234)
    return poisson_trace(rng, 12, rate=20.0,
                         prompt_lens=list(range(16, 501)),
                         max_new_choices=list(range(32, 65)),
                         vocab_size=32000)


def _pct(xs, p):
    return float(np.percentile(np.asarray(xs, np.float64), p))


def check_probe(eng, probe, served, tol: float, block_kv="slot") -> dict:
    """The probe request's logits recomputed two ways on the card, in the
    serving dtype: the plain no-cache forward over prompt + served tokens
    (no kernel runs: every block has > 32 rows), and a batch-1 cached replay
    (plain prefill, then one kernel decode step per served token). The
    replay goes through the slot cache (the fused decode step, scalar index)
    or, with ``block_kv`` None / "int8" / "fp8", through a one-slot block
    pool of that type (the block decode step, 16-token blocks). Their
    logits agree within ``tol`` of max |logit|, and every served token whose
    replay top-2 margin exceeds twice the measured difference is the
    replay's argmax. Also reported: the steps at which the two forms'
    argmaxes differ, and at which the served token is not the no-cache
    forward's argmax (how often rounding alone picks another token)."""
    plen = len(probe.prompt)
    seq = torch.tensor([list(probe.prompt) + served[:-1]], device=eng.device)
    with torch.no_grad():
        ref = eng.forward(seq)[0, plen - 1:].float()
    replay = _replay(eng, seq, plen, block_kv)
    assert torch.isfinite(ref).all() and torch.isfinite(replay).all()
    err = (replay - ref).abs().max().item()
    scale = ref.abs().max().item()
    assert err <= tol * scale, f"cached replay vs no-cache: {err} / {scale}"
    top2 = replay.topk(2, dim=-1).values
    safe = ((top2[:, 0] - top2[:, 1]) > 2 * err).tolist()
    picks = replay.argmax(-1).tolist()
    for step, (ok, want, got) in enumerate(zip(safe, picks, served)):
        assert not ok or want == got, f"served token {step}: {got} != {want}"
    ref_picks = ref.argmax(-1).tolist()
    return {"rid": probe.rid, "prompt_len": plen, "tokens": len(served),
            "replay": block_kv if block_kv == "slot" else
            "block pool " + (block_kv or str(eng.dtype).split(".")[-1]),
            "logit_max_abs_err": err, "logit_max_abs": scale,
            "tol": tol, "margin_safe_tokens_checked": int(sum(safe)),
            "argmax_replay_vs_no_cache_differ": sum(
                a != b for a, b in zip(picks, ref_picks)),
            "served_not_no_cache_argmax": sum(
                a != b for a, b in zip(served, ref_picks))}


def _replay(eng, seq, plen: int, block_kv="slot",
            cache_len=None) -> torch.Tensor:
    """f32 logits ``[T - plen + 1, V]`` of a batch-1 cached replay of
    ``seq``: a plain prefill of its first ``plen`` tokens, then one decode
    step per token (see :func:`check_probe` for ``block_kv``; a slot cache
    holds ``cache_len`` positions, default ``T``)."""
    model, params = eng.module, eng.params
    with torch.no_grad():
        if block_kv == "slot":
            cache = model.init_cache(1, cache_len or seq.shape[1],
                                     dtype=eng.dtype, device=eng.device)
        else:
            span = -(-seq.shape[1] // 16) * 16
            pool = BlockKVPool(model, 1, span, block_size=16, dtype=eng.dtype,
                               kv_dtype=block_kv, device=eng.device)
            cache = {"k": pool.k, "v": pool.v,
                     "index": torch.zeros((1,), dtype=torch.int32,
                                          device=eng.device),
                     "block_table": torch.arange(
                         span // 16, dtype=torch.int32,
                         device=eng.device)[None]}
        logits, cache = model.forward_with_cache(params, seq[:, :plen], cache)
        rows = [logits[0, -1]]
        for t in range(plen, seq.shape[1]):
            logits, cache = model.forward_with_cache(params, seq[:, t:t + 1],
                                                     cache)
            rows.append(logits[0, -1])
    return torch.stack(rows).float()


def kv_perturbation(eng, probe, served, kv_dtype: str) -> dict:
    """What an 8-bit pool alone changes: the probe's replay through a
    ``kv_dtype`` block pool against the same replay through a pool in the
    compute dtype (same kernels, same sequence). Per step: the largest
    logit change, and the compute-dtype replay's top-2 margin; a step whose
    margin exceeds twice its own change cannot flip."""
    plen = len(probe.prompt)
    seq = torch.tensor([list(probe.prompt) + served[:-1]], device=eng.device)
    base = _replay(eng, seq, plen, None)
    quant = _replay(eng, seq, plen, kv_dtype)
    diff = (quant - base).abs().amax(-1)
    top2 = base.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    flips = (quant.argmax(-1) != base.argmax(-1))
    return {"steps": int(diff.numel()),
            "logit_change_max": diff.max().item(),
            "logit_change_median": diff.median().item(),
            "top2_margin_median": margin.median().item(),
            "steps_margin_over_2x_change": int((margin > 2 * diff).sum()),
            "argmax_flips": int(flips.sum()),
            "argmax_flips_with_margin_over_2x_change": int(
                (flips & (margin > 2 * diff)).sum())}


def device_time(pr):
    """``(us by kernel name, busy us, summed us)`` of a profile's CUDA
    kernels. Busy time is the union of the kernels' intervals: a
    programmatic dependent launch starts while the kernel before it runs
    (and waits for it inside), which a CUDA graph's back-to-back replay
    exposes, so summed durations count that overlap twice."""
    kernels, spans = {}, []
    for ev in pr.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.name] = (kernels.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us())
            spans.append((ev.time_range.start, ev.time_range.end))
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    assert busy > 0, "the profiler saw no device time"
    return kernels, busy, sum(kernels.values())


def profile_decode(srv, reqs, steps: int = 5) -> dict:
    """Device time of a serving step against its host wall time, over
    ``steps`` steps with every slot holding a live request: the first
    ``num_slots`` of ``reqs``, re-submitted to arrive at once and to outlast
    the profile, are admitted and prefilled by one step first, so the
    profiled steps only decode (block-paged: through the slots' real
    tables). The engine is drained afterwards. Also the five kernels that
    take the most device time. The device time of a replayed step is that
    of the kernels in its CUDA graph, which the profiler reports one by
    one, as it does an eager step's launches (busy time: their union,
    :func:`device_time`). ``steps`` steps before the profiled ones are
    timed without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    n = srv.num_slots
    for r in reqs[:n]:
        srv.submit(Request(r.rid, r.prompt, 2 * steps + 3))
    srv.step()                       # admits and prefills every request
    assert srv.scheduler.waiting == 0 and srv.pending == n, srv.pending
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        assert not srv.step()        # decode only: nothing finishes
    unprofiled = time.perf_counter() - t0
    steps0 = srv.decode_steps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pr:
        t0 = time.perf_counter()
        for _ in range(steps):
            assert not srv.step()    # decode only: nothing finishes
        wall = time.perf_counter() - t0
    assert srv.decode_steps - steps0 == steps and srv.pending == n
    while srv.pending:
        srv.step()
    kernels, busy_us, sum_us = device_time(pr)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
    return {"steps": steps, "host_ms_per_step": 1e3 * wall / steps,
            "host_ms_per_step_unprofiled": 1e3 * unprofiled / steps,
            "device_ms_per_step": busy_us / 1e3 / steps,
            "kernel_ms_sum_per_step": sum_us / 1e3 / steps,
            "device_busy_share": busy_us / 1e6 / wall,
            "top_kernels_ms_per_step": {k[:60]: v / 1e3 / steps for k, v in top}}


def phase_serve(dtype: str, smi: str):
    """Returns the phase's line and the engine (phase 4's serves the
    block-paged phases next)."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = deepspeed_tpu_torch.init_inference(
        LlamaModel(LlamaConfig.llama_7b()), dtype=dtype, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    srv = ServingEngine(eng, num_slots=8, max_len=1024, buckets=(128, 512))
    t0 = time.perf_counter()
    srv.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    reqs = _trace()

    reset_counts()                       # the main path starts here
    t0 = time.perf_counter()
    results = srv.run(reqs, warmup=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()

    by_rid = {r.rid: r for r in results}
    assert sorted(by_rid) == [r.rid for r in reqs]
    vocab = eng.module.config.vocab_size
    for r in reqs:
        res = by_rid[r.rid]
        assert len(res.tokens) == r.max_new_tokens, (r.rid, len(res.tokens))
        assert all(0 <= t < vocab for t in res.tokens)
    steps = srv.decode_steps
    layers = eng.module.config.num_layers
    assert steps > 0
    assert launches["fused_decode_step"] == layers * steps, (launches, steps)
    want_mm = 7 * layers * steps if dtype == "int8" else 0
    assert launches["int8_matmul_dma"] == want_mm, (launches, steps)
    assert launches["fused_block_decode_step"] == 0, launches

    # solo re-serve: the same request alone gives bit-identical tokens
    probe = max(reqs, key=lambda r: len(r.prompt))
    [solo] = srv.run([Request(probe.rid, probe.prompt, probe.max_new_tokens)],
                     warmup=False)
    assert solo.tokens == by_rid[probe.rid].tokens, "solo != packed tokens"

    check = check_probe(eng, probe, by_rid[probe.rid].tokens, LOGIT_TOL[dtype])
    prof = profile_decode(srv, reqs)
    # the same trace through the decode program's eager closure
    twin = eager_server(srv)
    twin.warmup()
    eager = {r.rid: r.tokens for r in twin.run(
        [Request(r.rid, r.prompt, r.max_new_tokens,
                 arrival_time=r.arrival_time) for r in reqs], warmup=False)}
    vs_eager = replayed_vs_eager({rid: r.tokens for rid, r in by_rid.items()},
                                 eager)
    vs_eager["ms_per_decode_step_eager"] = \
        1e3 * twin.decode_wall / twin.decode_steps
    prof_eager = profile_decode(twin, reqs)
    del twin
    programs = serving_programs(srv)

    gen = sum(len(r.tokens) for r in results)
    lat = [r.latency for r in results]
    ttft = [r.first_token_latency for r in results]
    tpot = [(r.finish_time - r.first_token_time) / max(r.decode_calls, 1)
            for r in results]
    info = {"phase": f"serve_{dtype}", "card": smi,
            "model": "llama_7b (32 layers, hidden 4096, 32 heads, "
                     "intermediate 11008, vocab 32000), random weights seed 0",
            "requests": len(results), "tokens_generated": gen,
            "prompt_tokens": sum(len(r.prompt) for r in reqs),
            "decode_steps": steps, "launches": launches,
            "wall_s": wall, "tokens_per_s": gen / wall,
            "decode_wall_s": srv.decode_wall,
            "decode_tokens_per_s": (gen - len(results)) / srv.decode_wall,
            "ms_per_decode_step": 1e3 * srv.decode_wall / steps,
            "latency_p50_s": _pct(lat, 50), "latency_p95_s": _pct(lat, 95),
            "ttft_p50_s": _pct(ttft, 50), "ttft_p95_s": _pct(ttft, 95),
            "tpot_p50_ms": 1e3 * _pct(tpot, 50),
            "solo_identical": True, "probe": check, "decode_profile": prof,
            "replayed_vs_eager": vs_eager, "decode_profile_eager": prof_eager,
            "device_ms_replayed_over_eager": prof["device_ms_per_step"]
            / prof_eager["device_ms_per_step"],
            "programs": programs, "init_s": init_s, "warmup_s": warm_s,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(info)
    return info, eng


def _block_trace():
    """16 requests at 20/s over 2 shared templates of 392 tokens (24.5
    blocks: every hit forks the template's last, partly shared block),
    unique suffixes of 8-100 tokens, 32 new tokens each."""
    return shared_prefix_trace(np.random.RandomState(4321), 16, rate=20.0,
                               prefix_len=392, suffix_lens=range(8, 101),
                               max_new_tokens=32, vocab_size=32000)


def block_replay_vs_eager(srv, kv_dtype, reqs):
    """The block trace on two fresh block-paged engines beside ``srv``,
    under virtual clocks (so both admit, hit and fork alike): one replays
    its own capture of the decode program's closure, the other runs the
    closure eagerly. Their tokens must be bit-identical. Returns the check
    and the eager engine (for its profile)."""
    kw = dict(prefix_cache=True, block_size=srv.cache.block_size,
              kv_dtype=kv_dtype)
    graph = ServingEngine(srv.engine, num_slots=srv.num_slots,
                          max_len=srv.max_len, buckets=srv.buckets,
                          time_fn=VirtualClock(), **kw)
    eager = eager_server(srv, time_fn=VirtualClock(), **kw)
    toks, counters = {}, {}
    for name, s in (("graph", graph), ("eager", eager)):
        toks[name] = {r.rid: r.tokens for r in s.run(
            [Request(r.rid, r.prompt, r.max_new_tokens,
                     arrival_time=r.arrival_time) for r in reqs])}
        counters[name] = (s.prefix.hit_tokens, s.prefix.blocks_cowed,
                          s.decode_steps)
    assert counters["graph"] == counters["eager"], counters
    info = replayed_vs_eager(toks["graph"], toks["eager"])
    info.update(decode_steps=counters["graph"][2],
                hit_tokens=counters["graph"][0],
                forks=counters["graph"][1],
                decode_captures=graph._decode.captures,
                ms_per_decode_step_replayed=1e3 * graph.decode_wall
                / graph.decode_steps,
                ms_per_decode_step_eager=1e3 * eager.decode_wall
                / eager.decode_steps)
    return info, eager


def phase_serve_block(eng, kv_dtype, smi: str, baseline=None):
    """Phase 4's bf16 LLaMA-7B engine, block-paged with a prefix cache and
    the pool in bf16 (``kv_dtype`` None) or int8; the trace served cold,
    then again warm on the same index. ``baseline`` (the bf16 pool's cold
    tokens) gives the int8 pool's exact-token rate."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    name = "serve_block_" + ("kv_int8" if kv_dtype else "bf16")
    srv = ServingEngine(eng, num_slots=8, max_len=1024, buckets=(128, 512),
                        prefix_cache=True, block_size=16, kv_dtype=kv_dtype)
    srv.warmup()
    reqs = _block_trace()
    reset_counts()                       # the main path starts here
    runs, steps = {}, 0
    for run in ("cold", "warm"):
        pf0, st0, dw0 = (srv.prefill_tokens_computed, srv.decode_steps,
                         srv.decode_wall)
        hit0, miss0 = srv.prefix.hit_tokens, srv.prefix.miss_tokens
        t0 = time.perf_counter()
        results = srv.run([Request(r.rid, r.prompt, r.max_new_tokens,
                                   arrival_time=r.arrival_time)
                           for r in reqs], warmup=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        by_rid = {r.rid: r for r in results}
        assert sorted(by_rid) == [r.rid for r in reqs]
        for r in reqs:
            assert len(by_rid[r.rid].tokens) == r.max_new_tokens, r.rid
        n_steps = srv.decode_steps - st0
        steps += n_steps
        gen = sum(len(r.tokens) for r in results)
        hit = srv.prefix.hit_tokens - hit0
        ttft = [r.first_token_latency for r in results]
        runs[run] = {
            "results": by_rid, "wall_s": wall, "tokens_per_s": gen / wall,
            "prefill_tokens_computed": srv.prefill_tokens_computed - pf0,
            "decode_steps": n_steps,
            "ms_per_decode_step": 1e3 * (srv.decode_wall - dw0) / n_steps,
            "ttft_p50_s": _pct(ttft, 50), "ttft_p95_s": _pct(ttft, 95),
            "prefix_hit_rate": hit / (hit + srv.prefix.miss_tokens - miss0)}
    launches = read_counts()
    layers = eng.module.config.num_layers
    assert launches["fused_block_decode_step"] == layers * steps, \
        (launches, steps)
    assert launches["fused_decode_step"] == 0, launches
    assert launches["int8_matmul_dma"] == 0, launches
    cold, warm = runs["cold"], runs["warm"]
    assert (warm["prefill_tokens_computed"]
            <= 0.4 * cold["prefill_tokens_computed"]), runs
    assert srv.prefix.blocks_cowed > 0
    probe = max(reqs, key=lambda r: len(r.prompt))
    check = check_probe(eng, probe, warm["results"][probe.rid].tokens,
                        LOGIT_TOL["bf16"], block_kv=kv_dtype)
    prof = profile_decode(srv, reqs)
    vs_eager, eager = block_replay_vs_eager(srv, kv_dtype, reqs)
    prof_eager = profile_decode(eager, reqs)
    del eager
    programs = serving_programs(srv)
    info = {"phase": name, "card": smi,
            "model": "llama_7b, phase 4's engine (bf16, random weights "
                     "seed 0)",
            "pool": kv_dtype or "bf16", "requests": len(reqs),
            "blocks_per_mib": srv.cache.blocks_per_mib(),
            "pool_bytes": srv.cache.hbm_bytes(),
            "blocks_cowed": srv.prefix.blocks_cowed,
            "launches": launches, "decode_steps": steps,
            "probe": check, "decode_profile": prof,
            "replayed_vs_eager": vs_eager, "decode_profile_eager": prof_eager,
            "device_ms_replayed_over_eager": prof["device_ms_per_step"]
            / prof_eager["device_ms_per_step"],
            "programs": programs,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    for run, r in runs.items():
        info[run] = {k: v for k, v in r.items() if k != "results"}
    if baseline is not None:
        same = total = 0
        diverged = {}
        for rid, res in cold["results"].items():
            want = baseline[rid]
            same += sum(a == b for a, b in zip(res.tokens, want))
            total += len(want)
            first = next((i for i, (a, b) in enumerate(zip(res.tokens, want))
                          if a != b), None)
            if first is not None:
                diverged[rid] = first
        info["exact_token_rate_vs_bf16_pool"] = same / total
        info["first_divergence_step_by_rid"] = diverged
        info["kv_perturbation"] = kv_perturbation(
            eng, probe, warm["results"][probe.rid].tokens, kv_dtype)
    emit(info)
    return info, {rid: r.tokens for rid, r in cold["results"].items()}


# ------------------------------------------------ serve_preempt_chunked
PREEMPT_SERVE = dict(num_slots=8, max_len=2048, buckets=(128, 512),
                     prefill_token_budget=512, preemption="swap")
# block-paged over an int8 pool: 480 blocks of 16 tokens hold four or five
# of the 1100-1800-token requests (77-121 blocks each), so the pool binds
# before the 8 slots do
PREEMPT_BLOCK = dict(prefix_cache=True, block_size=16, num_blocks=480,
                     kv_dtype="int8")


def _preempt_trace():
    """8 class-1 requests at t = 0 (prompts 1100-1800 tokens: 3-4 chunks of
    512; 128 new tokens), then a burst of 12 class-0 requests at 0.5 s
    (prompts 16-200, 32-64 new tokens), seeded."""
    rng = np.random.RandomState(2468)
    reqs = [Request(i, rng.randint(0, 32000, size=int(rng.randint(
        1100, 1801))).tolist(), 128, arrival_time=0.0, priority=1)
        for i in range(8)]
    reqs += [Request(8 + j, rng.randint(0, 32000, size=int(rng.randint(
        16, 201))).tolist(), int(rng.randint(32, 65)), arrival_time=0.5,
        priority=0) for j in range(12)]
    return reqs


def _copy_reqs(reqs, max_new=None):
    return [Request(r.rid, r.prompt, min(r.max_new_tokens, max_new or
                                         r.max_new_tokens),
                    arrival_time=r.arrival_time, priority=r.priority)
            for r in reqs]


def _record_preemptions(srv) -> dict:
    """rid -> the tokens the request had emitted at each of its
    preemptions (the solo runs must reach past them)."""
    seen, inner = {}, srv._preempt

    def preempt(slot, now):
        st = srv._slots[slot]
        seen.setdefault(st.request.rid, []).append(len(st.result.tokens))
        inner(slot, now)

    srv._preempt = preempt
    return seen


def _latency_by_class(results) -> dict:
    """TTFT p50/p95 (s) and TPOT p50/p95 (ms; the engine's TPOT: decode
    time less the time preempted after the first token, per decode step)
    by priority class."""
    out = {}
    for pri in sorted({r.priority for r in results}):
        rs = [r for r in results if r.priority == pri]
        ttft = [r.first_token_latency for r in rs]
        tpot = [1e3 * max(r.finish_time - r.first_token_time
                          - r.decode_preempted_wall, 0.0) / r.decode_calls
                for r in rs if r.decode_calls]
        out[f"class{pri}"] = {
            "requests": len(rs), "ttft_p50_s": _pct(ttft, 50),
            "ttft_p95_s": _pct(ttft, 95), "tpot_p50_ms": _pct(tpot, 50),
            "tpot_p95_ms": _pct(tpot, 95),
            "preemptions": sum(r.preemptions for r in rs),
            "preempted_wall_s": sum(r.preempted_wall for r in rs)}
    return out


def _virtual_tokens(eng, kw, reqs, eager: bool, stats=None,
                    **sample) -> dict:
    """The trace (outputs cut to 24 tokens) on a fresh engine under a
    virtual clock of 0.01 s a read, so the burst lands while the class-1
    prompts still prefill; with ``eager`` through the decode program's
    eager closure (as :func:`eager_server`). Returns the tokens by rid;
    ``stats`` (a dict) takes the run's preemption and swap counts."""
    gc.collect()                         # the previous run's engine
    srv = ServingEngine(eng, telemetry=False, time_fn=VirtualClock(0.01),
                        **kw, **sample)
    if eager:
        srv._decode = srv._decode.eager
    toks = {r.rid: r.tokens for r in srv.run(_copy_reqs(reqs, 24))}
    assert srv.preemptions >= 1, "the virtual-clock run did not preempt"
    # the clock fixes where each park lands, so the upload path is held
    # here: on this trace some victim parks past its prompt blocks
    assert srv.swapped_blocks_in >= 1, "no parked block was uploaded"
    if stats is not None:
        stats.update(preemptions=srv.preemptions,
                     swapped_blocks_out=srv.swapped_blocks_out,
                     swapped_blocks_in=srv.swapped_blocks_in)
    if not eager:
        serving_programs(srv)
    return toks


def _preempt_run(eng, mode: str, smi: str) -> dict:
    """One store of the phase (see :func:`phase_serve_preempt_chunked`)."""
    kw = dict(PREEMPT_SERVE, **(PREEMPT_BLOCK if mode == "block_int8" else {}))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    srv = ServingEngine(eng, **kw)
    t0 = time.perf_counter()
    srv.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    reqs = _preempt_trace()
    parked = _record_preemptions(srv)

    reset_counts()                       # the main path starts here
    t0 = time.perf_counter()
    results = srv.run(_copy_reqs(reqs), warmup=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()

    by_rid = {r.rid: r for r in results}
    assert sorted(by_rid) == [r.rid for r in reqs]
    for r in reqs:
        assert len(by_rid[r.rid].tokens) == r.max_new_tokens, r.rid
    steps, layers = srv.decode_steps, eng.module.config.num_layers
    kernel = ("fused_block_decode_step" if mode == "block_int8"
              else "fused_decode_step")
    other = ("fused_decode_step" if mode == "block_int8"
             else "fused_block_decode_step")
    assert launches[kernel] == layers * steps, (launches, steps)
    assert launches[other] == 0 and launches["int8_matmul_dma"] == 0, launches
    assert srv.preemptions >= 1, "no preemption"
    assert len(srv.swap) == 0 and srv.swap.bytes_stored == 0, srv.swap
    # on the wall clock the burst may land only at a chunk boundary of a
    # prefilling victim: block-paged, its resume then re-pins every parked
    # block from the radix index and uploads none (swapped_blocks_in 0),
    # so the upload is held on the virtual-clock runs below
    assert srv.swapped_blocks_out >= 1 and srv.swap.peak_bytes > 0
    programs = serving_programs(srv)
    assert {"swap_out", "swap_in"} <= set(programs["program_cache_sizes"])
    swap = {"preemptions": srv.preemptions,
            "swapped_blocks_out": srv.swapped_blocks_out,
            "swapped_blocks_in": srv.swapped_blocks_in,
            "peak_bytes": srv.swap.peak_bytes, "len": len(srv.swap),
            "bytes_stored": srv.swap.bytes_stored,
            "tokens_at_preemption": {str(k): v for k, v in parked.items()}}
    chunks = srv.prefill_chunks
    decode_ms = 1e3 * srv.decode_wall / steps
    del srv
    gc.collect()                         # _record_preemptions' cycle

    # every request alone on an engine of the same shapes (one request at
    # a time: no neighbour, no radix hit), its tokens through at least 16
    # past its last preemption
    t0 = time.perf_counter()
    solo_srv = ServingEngine(eng, **kw)
    solo_srv.warmup()
    cut = {}
    for r in reqs:
        n = min(r.max_new_tokens, max([16] + [p + 16 for p in
                                              parked.get(r.rid, [])]))
        [res] = solo_srv.run([Request(r.rid, r.prompt, n)], warmup=False)
        assert res.tokens == by_rid[r.rid].tokens[:n], \
            f"rid {r.rid}: solo != served ({mode})"
        cut[r.rid] = n
    solo_s = time.perf_counter() - t0
    del solo_srv

    # replayed against eager under a virtual clock: greedy, then sampled
    # (temperature 0.8, top-p 0.9, the engine's seed) twice and eager
    t0 = time.perf_counter()
    virtual_swap = {}
    graph = _virtual_tokens(eng, kw, reqs, eager=False, stats=virtual_swap)
    vs_eager = replayed_vs_eager(graph, _virtual_tokens(eng, kw, reqs,
                                                        eager=True))
    sample = dict(do_sample=True, temperature=0.8, top_p=0.9)
    sampled = [_virtual_tokens(eng, kw, reqs, eager=False, **sample)
               for _ in range(2)]
    assert sampled[0] == sampled[1], "a sampled run did not repeat"
    assert sampled[0] != graph, "sampled tokens equal the greedy ones"
    s_eager = _virtual_tokens(eng, kw, reqs, eager=True, **sample)
    vs_eager_sampled = replayed_vs_eager(sampled[0], s_eager)
    virtual_s = time.perf_counter() - t0

    gen = sum(len(r.tokens) for r in results)
    info = {"store": mode, "card": smi, "requests": len(results),
            "tokens_generated": gen, "decode_steps": steps,
            "prefill_chunks": chunks, "launches": launches,
            "wall_s": wall, "tokens_per_s": gen / wall,
            "ms_per_decode_step": decode_ms,
            "ttft_p50_s": _pct([r.first_token_latency for r in results], 50),
            "ttft_p95_s": _pct([r.first_token_latency for r in results], 95),
            "by_class": _latency_by_class(results), "swap": swap,
            "virtual_clock_swap": virtual_swap,
            "solo_identical": True, "solo_tokens_compared": cut,
            "replayed_vs_eager": vs_eager,
            "sampled": {"repeat_identical": True, **vs_eager_sampled},
            "programs": programs, "warmup_s": warm_s, "solo_s": solo_s,
            "virtual_runs_s": virtual_s,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    return info


def phase_serve_preempt_chunked(eng, smi: str) -> dict:
    """LLaMA-7B (phase 4's bf16 engine: published widths and depth, random
    weights) greedy behind a ServingEngine with chunked prefill (buckets
    128 / 512, a 512-token budget) and priority preemption with host swap,
    8 slots, max_len 2048, on :func:`_preempt_trace`: once slot-paged in
    bf16 (kernel B), once block-paged over an int8 pool that binds before
    the slots (kernel C). Each run (:func:`_preempt_run`) holds: every
    request finishes; the decode kernel launched layers x decode steps;
    at least one preemption, the swap buffer drained; every program one
    entry, the chunk and swap programs included, no recompile; every
    request's tokens equal to its solo run on an engine of the same shapes;
    replayed tokens equal to the eager closure's (greedy, then sampled at
    temperature 0.8 and top-p 0.9, the sampled run repeating). Reported,
    not held: TTFT and TPOT by class, and the same trace on a monolithic
    engine (buckets 128 / 512 / 2048, no budget, no preemption) in the same
    call."""
    t0 = time.perf_counter()
    runs = {mode: _preempt_run(eng, mode, smi)
            for mode in ("slot_bf16", "block_int8")}
    gc.collect()
    torch.cuda.empty_cache()
    mono = ServingEngine(eng, num_slots=8, max_len=2048,
                         buckets=(128, 512, 2048))
    mono.warmup()
    t1 = time.perf_counter()
    results = mono.run(_copy_reqs(_preempt_trace()), warmup=False)
    torch.cuda.synchronize()
    monolithic = {"wall_s": time.perf_counter() - t1,
                  "decode_steps": mono.decode_steps,
                  "ms_per_decode_step": 1e3 * mono.decode_wall
                  / mono.decode_steps,
                  "by_class": _latency_by_class(results)}
    del mono
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in WRAPPERS}
    info = {"phase": "serve_preempt_chunked", "card": smi,
            "model": "llama_7b, phase 4's engine (bf16, random weights "
                     "seed 0)",
            "config": {**PREEMPT_SERVE, "block": PREEMPT_BLOCK},
            **runs, "monolithic": monolithic, "launches": launches,
            "phase_wall_s": time.perf_counter() - t0}
    emit(info)
    return info


# ------------------------------------------------------------ serve_spec
SPEC_SERVE = dict(num_slots=8, max_len=1024, buckets=(128, 512))
SPEC_K = (2, 4, 8)
# TinyLlama/TinyLlama-1.1B-Chat-v1.0 config.json: hidden 2048, intermediate
# 5632, 22 layers, 32 heads, 4 KV heads (Dh 64, GQA rep 8), vocab 32000,
# max_position_embeddings 2048, rms_norm_eps 1e-5
TINYLLAMA_1B = dict(vocab_size=32000, max_seq_len=2048, num_layers=22,
                    hidden_size=2048, num_heads=32, num_kv_heads=4,
                    intermediate_size=5632, eps=1e-5)
SPEC_BLOCK = dict(prefix_cache=True, block_size=16, kv_dtype="int8")
# the draft window: 120 + k_max 8 = a 128-position draft cache
SPEC_WINDOW = 120
# the virtual-clock replays' outputs, cut to this many tokens a request
SPEC_VIRTUAL_TOKENS = 16


def _spec_trace():
    """16 requests, Poisson at 20/s, prompts 16-64 tokens, 48 new tokens
    (seeded): every history fits the 120-token draft window."""
    return poisson_trace(np.random.RandomState(1357), 16, rate=20.0,
                         prompt_lens=list(range(16, 65)),
                         max_new_choices=[48], vocab_size=32000)


def _templated_spec_trace():
    """16 requests at 20/s, each prompt one of 4 random 8-token patterns
    repeated 6 times (48 tokens: prompt lookup finds continuations, and
    the prefix cache shares the templates), 48 new tokens (seeded)."""
    return templated_trace(np.random.RandomState(2468), 16, rate=20.0,
                           pattern_len=8, repeats=6, max_new_tokens=48,
                           vocab_size=32000)


# run -> (trace, store, drafter: None (n-gram) / "self" / "tinyllama",
# k-buckets). A random model seldom re-walks its context, so prompt lookup
# drafts little in (c) and (d) and has yet to emit an accepted block; c2
# and d2 serve the same traces on the same stores with the target drafting
# for itself, which does (multi-token emission through the int8 pool's
# quantizing verify write, and kernel 2 at 24 rows on every verify step).
SPEC_RUNS = {
    "a_self_draft": (_spec_trace, {}, "self", SPEC_K),
    "b_tinyllama_draft": (_spec_trace, {}, "tinyllama", SPEC_K),
    "c_ngram_block_int8_pool": (_templated_spec_trace, SPEC_BLOCK, None,
                                SPEC_K),
    "c2_self_draft_block_int8_pool": (_templated_spec_trace, SPEC_BLOCK,
                                      "self", SPEC_K),
    "d_ngram_int8_weights": (_templated_spec_trace, {}, None, (2,)),
    "d2_self_draft_int8_weights": (_templated_spec_trace, {}, "self", (2,)),
    # phase probe_fp32's engine: in fp32 the draft and the verify differ
    # by far less than a top-2 margin, so self-drafting accepts nearly all
    "e_self_draft_fp32": (_spec_trace, {}, "self", SPEC_K),
    "e2_self_draft_fp32_block": (_spec_trace, dict(prefix_cache=True,
                                                   block_size=16),
                                 "self", SPEC_K),
}
# the least acceptance of the runs whose draft computes the target's own
# function in the same arithmetic (c2 and d2 do not: the int8 pool's
# quantized K/V, and the draft's dequantized window prefill, stand between)
SELF_DRAFT_ACCEPTANCE = {"a_self_draft": 0.5, "e_self_draft_fp32": 0.9,
                         "e2_self_draft_fp32_block": 0.9}


def _spec_kw(run: str, draft_eng) -> dict:
    _, store, drafter, k_buckets = SPEC_RUNS[run]
    spec = dict(mode="ngram", k_buckets=k_buckets, adaptive=True)
    if drafter is not None:
        spec.update(mode="draft", draft_engine=draft_eng,
                    draft_window=SPEC_WINDOW)
    return dict(SPEC_SERVE, speculative=spec, **store)


def _record_draft_rounds(srv) -> list:
    """The k-bucket of every drafting round (a draft model's program runs
    kb - 1 single-token rollout steps)."""
    rounds, inner = [], srv._drafter.propose

    def propose(histories, want, kb):
        rounds.append(kb)
        return inner(histories, want, kb)

    srv._drafter.propose = propose
    return rounds


def spec_eager(srv) -> ServingEngine:
    """``srv`` (not yet warmed up) with its decode, verify and draft
    programs replaced by their eager closures."""
    srv._decode = srv._decode.eager
    for kb in srv.spec.k_buckets:
        srv._verify[kb] = srv._verify_fn(kb).eager
        if isinstance(srv._drafter, DraftModelDrafter):
            srv._drafter._programs[kb] = srv._drafter._program(kb).eager
    return srv


def spec_programs(srv) -> dict:
    """:func:`serving_programs` of a speculative engine, and every verify
    and draft graph captured once."""
    info = serving_programs(srv)
    names = set(info["program_cache_sizes"])
    assert {f"verify_{kb}" for kb in srv.spec.k_buckets} <= names, info
    graphs = dict(srv._verify)
    if isinstance(srv._drafter, DraftModelDrafter):
        assert {f"draft_{kb}" for kb in srv.spec.k_buckets} <= names, info
        graphs.update({f"draft_{kb}": p
                       for kb, p in srv._drafter._programs.items()})
    info["spec_captures"] = {str(k): p.captures for k, p in graphs.items()}
    assert set(info["spec_captures"].values()) == {1}, info
    return info


def _events_ms(fn, reps: int = 10) -> float:
    """ms per call of ``fn`` between CUDA events over ``reps`` calls back
    to back, after one call (a replayed graph: its device time, the host
    launching faster than the card runs it)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def profile_verify(srv, kb: int, reps: int = 3) -> dict:
    """Device time of ``reps`` replays of the verify graph of bucket
    ``kb`` (no slot active: the same work) under the profiler: busy ms per
    replay (the union of kernel intervals, :func:`device_time`) and the
    six kernels that take the most."""
    from torch.profiler import ProfilerActivity, profile

    srv._verify_call(kb, srv._next_rng())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as pr:
        for _ in range(reps):
            srv._verify_call(kb, srv._next_rng())
        torch.cuda.synchronize()
    kernels, busy_us, sum_us = device_time(pr)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    return {"device_ms": busy_us / 1e3 / reps,
            "kernel_ms_sum": sum_us / 1e3 / reps,
            "top_kernels_ms": {k[:70]: v / 1e3 / reps for k, v in top}}


def _spec_virtual(eng, kw, reqs, eager: bool, tracer=None, **sample):
    """The trace's first 8 requests (one per slot), arriving at once and
    cut to SPEC_VIRTUAL_TOKENS new tokens, on a fresh speculative engine
    under a virtual clock; with ``eager`` through the eager closures of its
    decode, verify and draft programs.
    Returns the tokens by rid, the run's wall seconds (warm-up excluded)
    and the drafted tokens."""
    gc.collect()                         # the previous run's engine
    srv = ServingEngine(eng, telemetry=False, time_fn=VirtualClock(),
                        tracer=tracer, **kw, **sample)
    if eager:
        spec_eager(srv)
    srv.warmup()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = {r.rid: r.tokens for r in srv.run(
        [Request(r.rid, r.prompt, min(r.max_new_tokens, SPEC_VIRTUAL_TOKENS))
         for r in reqs[:8]], warmup=False)}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert srv.spec_drafted_tokens > 0
    if not eager:
        spec_programs(srv)
    return toks, wall, srv.spec_drafted_tokens


def _spec_replays(eng, kw, reqs, traced: bool) -> dict:
    """Replayed against eager under a virtual clock: greedy, then sampled
    (temperature 0.8, top-p 0.9, the engine's seed) twice and eager; with
    ``traced`` a tracer-armed greedy run too, whose tokens equal the bare
    run's, with its span counts and its wall over the bare run's (a
    self-drafting engine: a random model's SPEC_VIRTUAL_TOKENS tokens, and
    its samples, give prompt lookup little or nothing to draft)."""
    t0 = time.perf_counter()
    greedy, bare_s, drafted = _spec_virtual(eng, kw, reqs, eager=False)
    eager, eager_s, _ = _spec_virtual(eng, kw, reqs, eager=True)
    info = {"drafter": kw["speculative"]["mode"],
            "greedy": {**replayed_vs_eager(greedy, eager),
                       "drafted_tokens": drafted, "replayed_run_s": bare_s,
                       "eager_run_s": eager_s}}
    sample = dict(do_sample=True, temperature=0.8, top_p=0.9)
    sampled = [_spec_virtual(eng, kw, reqs, eager=False, **sample)
               for _ in range(2)]
    assert sampled[0][0] == sampled[1][0], "a sampled run did not repeat"
    assert sampled[0][0] != greedy, "sampled tokens equal the greedy ones"
    info["sampled"] = {"repeat_identical": True,
                       "drafted_tokens": sampled[0][2], **replayed_vs_eager(
                           sampled[0][0], _spec_virtual(
                               eng, kw, reqs, eager=True, **sample)[0])}
    if traced:
        tracer = SpanTracer()
        armed, armed_s, _ = _spec_virtual(eng, kw, reqs, eager=False,
                                          tracer=tracer)
        assert armed == greedy, "tracer-armed tokens != bare tokens"
        counts = {}
        for s in tracer.spans:
            counts[s.name] = counts.get(s.name, 0) + 1
        assert {"request", "queue_wait", "prefill_chunk", "decode_segment",
                "spec_draft", "spec_verify"} <= set(counts), counts
        info["traced"] = {"tokens_identical_to_bare": True,
                          "spans_by_name": counts, "dropped": tracer.dropped,
                          "armed_wall_s": armed_s, "bare_wall_s": bare_s,
                          "armed_over_bare_wall": armed_s / bare_s}
    info["wall_s"] = time.perf_counter() - t0
    return info


def _spec_run(eng, run: str, smi: str, draft_eng=None) -> dict:
    """One run of :func:`phase_serve_spec`."""
    trace, store, drafter, k_buckets = SPEC_RUNS[run]
    kw = _spec_kw(run, draft_eng)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reg = MetricsRegistry()
    srv = ServingEngine(eng, telemetry=reg, **kw)
    t0 = time.perf_counter()
    srv.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    rounds = _record_draft_rounds(srv)
    reqs = trace()

    reset_counts()                       # the main path starts here
    t0 = time.perf_counter()
    results = srv.run(_copy_reqs(reqs), warmup=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()

    by_rid = {r.rid: r for r in results}
    assert sorted(by_rid) == [r.rid for r in reqs]
    for r in reqs:
        assert len(by_rid[r.rid].tokens) == r.max_new_tokens, r.rid
    snap = reg.snapshot()
    verify_steps = snap["counters"].get("serving/spec_verify_steps", 0)
    steps = srv.decode_steps
    plain_steps = steps - verify_steps
    assert verify_steps > 0 and srv.spec_drafted_tokens > 0, (run, snap)
    layers = eng.module.config.num_layers
    rollout = (sum(kb - 1 for kb in rounds) if drafter is not None else 0)
    draft_layers = (draft_eng.module.config.num_layers
                    if drafter is not None else 0)
    # the target's plain steps run the store's decode kernel; the draft's
    # rollout runs kernel B on the drafter's own slot cache
    plain_b = 0 if store else layers * plain_steps
    assert launches["fused_decode_step"] == (
        plain_b + draft_layers * rollout), \
        (run, launches, plain_steps, rollout)
    assert launches["fused_block_decode_step"] == (
        layers * plain_steps if store else 0), (run, launches, plain_steps)
    # kernel 2: every target step (8 rows plain, 8 (kb + 1) rows verify)
    # and, on an int8 draft, every rollout step (8 rows); the draft's
    # window prefill (8 x 120 rows) takes the dequant path
    want_mm = 7 * layers * steps if eng.weight_quant else 0
    if drafter is not None and draft_eng.weight_quant:
        want_mm += 7 * draft_layers * rollout
    assert launches["int8_matmul_dma"] == want_mm, (run, launches, steps)
    programs = spec_programs(srv)
    acceptance = srv.spec_accepted_tokens / srv.spec_drafted_tokens
    # requests that took more than one token from some verify step
    multi = sum(len(r.tokens) - 1 > r.decode_calls for r in results)
    kind = ("int8" if eng.weight_quant else
            "fp32" if eng.dtype == torch.float32 else "bf16")
    assert acceptance >= SELF_DRAFT_ACCEPTANCE.get(run, 0.0), \
        f"{run}: self-draft acceptance {acceptance}"
    assert drafter != "self" or multi > 0, f"{run}: no multi-token emission"
    hist = snap["histograms"]["serving/accepted_tokens_per_step"]
    plain_wall = srv.decode_wall - srv._draft_wall - srv._verify_wall
    # the verify graph of the largest bucket and the decode graph replayed
    # with no slot active (the same work: every row is computed)
    kb_max = k_buckets[-1]
    srv._active_host.zero_()
    srv._draft_len_host.zero_()
    verify_ms = _events_ms(lambda: srv._verify_call(kb_max, srv._next_rng()))
    srv._active.zero_()
    decode_ms = _events_ms(lambda: srv._decode(
        eng.params, *srv.cache.carry(), *srv.cache.decode_args(), srv._toks,
        srv._active, srv._temp, srv._next_rng()))
    verify_prof = profile_verify(srv, kb_max)
    probe = max(reqs, key=lambda r: len(r.prompt))
    check = check_probe(eng, probe, by_rid[probe.rid].tokens, LOGIT_TOL[kind],
                        block_kv=store.get("kv_dtype") if store else "slot")
    info = {"run": run, "card": smi, "engine": kind,
            "store": ("block pool " + store.get("kv_dtype", kind)
                      if store else "slot"),
            "drafter": drafter or "ngram", "k_buckets": list(k_buckets),
            "requests": len(results),
            "tokens_generated": sum(len(r.tokens) for r in results),
            "decode_steps": steps, "verify_steps": verify_steps,
            "plain_steps": plain_steps, "draft_rounds": len(rounds),
            "draft_rollout_steps": rollout, "launches": launches,
            "drafted_tokens": srv.spec_drafted_tokens,
            "accepted_tokens": srv.spec_accepted_tokens,
            "acceptance_rate": acceptance,
            "requests_with_multi_token_emission": multi,
            "tokens_per_verify_step": hist["sum"] / verify_steps,
            "tokens_per_slot_verify": hist["mean"],
            "wall_s": wall, "decode_wall_s": srv.decode_wall,
            "ms_per_verify_step_host": 1e3 * srv._verify_wall / verify_steps,
            "ms_per_plain_step_host": (1e3 * plain_wall / plain_steps
                                       if plain_steps else None),
            "draft_ms_per_round_host": 1e3 * srv._draft_wall / len(rounds),
            "verify_graph_ms_events_k%d" % kb_max: verify_ms,
            "decode_graph_ms_events": decode_ms,
            "verify_profile_k%d" % kb_max: verify_prof,
            "probe": check, "programs": programs, "warmup_s": warm_s}
    gen = {rid: r.tokens for rid, r in by_rid.items()}
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    # the same engine's plain greedy run on the same trace
    plain = ServingEngine(eng, telemetry=False, **SPEC_SERVE, **store)
    plain.warmup()
    ptoks = {r.rid: r.tokens for r in plain.run(_copy_reqs(reqs),
                                                warmup=False)}
    del plain
    info["requests_equal_to_plain_greedy"] = sum(
        ptoks[rid] == toks for rid, toks in gen.items())
    if run in ("a_self_draft", "c2_self_draft_block_int8_pool"):
        t0 = time.perf_counter()
        info["replayed_vs_eager"] = _spec_replays(
            eng, kw, reqs, traced=run == "c2_self_draft_block_int8_pool")
        info["virtual_runs_s"] = time.perf_counter() - t0
    info["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return info


def phase_serve_spec(eng, smi: str, runs) -> dict:
    """Speculative decoding on the LLaMA-7B engines of phases 4 (bf16:
    runs a-c2) and 5 (int8 weights: runs d, d2), 8 slots, max_len 1024,
    buckets 128 / 512, adaptive k: (a) self-drafting (the target's own
    engine as the draft model, a 120-token window), (b) a
    TinyLlama-1.1B-shaped draft (random weights, seed 7; kernel B at Dh 64,
    GQA rep 8, over its 128-position cache), both on :func:`_spec_trace`;
    (c) n-gram over an int8 block pool with the prefix cache and (d) n-gram
    on the int8 engine at k-bucket 2 only (kernel 2 at 24 rows), both on
    :func:`_templated_spec_trace`, and (c2, d2) the same stores and trace
    self-drafting. Each run holds: every request finishes; verify steps and
    drafted tokens > 0; the store's decode kernel launched layers x plain
    steps, kernel B also draft layers x the rollout steps of every draft
    round, kernel 2 7 x layers x decode steps on the int8 engine (+ 7 x
    layers x rollout steps of the int8 self-draft), no other decode kernel;
    every program one entry and every verify and draft graph captured
    once; the probe (the longest request's served tokens against a
    no-cache forward, margin-safe steps); a self-drafting run emits a
    multi-token block, and (a) accepts at least half its drafts. (a) and (c2)
    also: replayed tokens equal the eager closures', greedy and sampled,
    the sampled run repeating; (c2) a tracer-armed run gives the bare
    run's tokens. Reported: acceptance, tokens per verify step, host ms
    per verify and plain step, draft ms per round, the verify and decode
    graphs' ms, and how many requests
    equal the plain engine's greedy tokens."""
    t0 = time.perf_counter()
    out = {}
    for run in runs:
        draft = None
        if SPEC_RUNS[run][2] == "self":
            draft = eng
        elif SPEC_RUNS[run][2] == "tinyllama":
            draft = deepspeed_tpu_torch.init_inference(
                LlamaModel(LlamaConfig(**TINYLLAMA_1B)), dtype="bf16", seed=7)
        out[run] = _spec_run(eng, run, smi, draft)
        del draft
    launches = {k: sum(r["launches"][k] for r in out.values())
                for k in WRAPPERS}
    info = {"phase": "serve_spec", "card": smi,
            "model": "llama_7b, phase %s's engine (%s, random weights seed 0)"
                     % (("4", "bf16") if not eng.weight_quant else ("5", "int8")),
            **out, "launches": launches,
            "phase_wall_s": time.perf_counter() - t0}
    emit(info)
    return info


# probe_fp32's depth: 4 of LLaMA-7B's 32 layers (the checks are per layer
# and per token; the bf16 serving phases run all 32)
PROBE_FP32_LAYERS = 4


def phase_probe_fp32(smi: str) -> dict:
    """LLaMA-7B at full width and PROBE_FP32_LAYERS of its 32 layers in
    fp32 (both kernels take f32): the trace's longest request served
    alone, then its logits checked as in the serving phases, with the
    tight fp32 bound (the kernels' arithmetic at full width). Then
    serve_spec's self-drafting runs on this engine, slot-paged and over an
    fp32 block pool (runs e, e2): with rounding too small to flip an
    argmax, the draft computes the target's own function, and each run
    accepts at least 0.9 of its drafts. Last, :func:`fabric_fp32_check`:
    a twin run with a crash serves a fault-free fixed pool's tokens."""
    cfg = dataclasses.replace(LlamaConfig.llama_7b(),
                              num_layers=PROBE_FP32_LAYERS)
    eng = deepspeed_tpu_torch.init_inference(LlamaModel(cfg), dtype="fp32",
                                             seed=0)
    srv = ServingEngine(eng, num_slots=8, max_len=1024, buckets=(128, 512))
    probe = max(_trace(), key=lambda r: len(r.prompt))
    [res] = srv.run([Request(probe.rid, probe.prompt, probe.max_new_tokens)])
    assert len(res.tokens) == probe.max_new_tokens
    info = {"phase": "probe_fp32", "layers": cfg.num_layers,
            **check_probe(eng, probe, res.tokens, LOGIT_TOL["fp32"])}
    # block-paged, after freeing the slot cache: template + suffix A cold,
    # then the probe, template + suffix B, warm
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    srv = ServingEngine(eng, num_slots=2, max_len=1024, buckets=(128, 512),
                        prefix_cache=True, block_size=16)
    rng = np.random.RandomState(99)
    template = rng.randint(0, 32000, size=392).tolist()
    a, b = (rng.randint(0, 32000, size=n).tolist() for n in (40, 60))
    srv.run([Request(0, template + a, 32)])
    pf0 = srv.prefill_tokens_computed
    reset_counts()
    probe_b = Request(1, template + b, 32)
    [res] = srv.run([probe_b])
    assert fused_block_decode_step.launches == \
        cfg.num_layers * (len(res.tokens) - 1)
    assert srv.prefix.blocks_cowed == 1
    assert srv.prefill_tokens_computed - pf0 == len(probe_b.prompt) - 392
    info["block_paged"] = {
        "warm_prefill_tokens": srv.prefill_tokens_computed - pf0,
        "hit_tokens": srv.prefix.hit_tokens, "forks": srv.prefix.blocks_cowed,
        **check_probe(eng, probe_b, res.tokens, LOGIT_TOL["fp32"],
                      block_kv=None)}
    del srv
    for run in ("e_self_draft_fp32", "e2_self_draft_fp32_block"):
        info[run] = _spec_run(eng, run, smi, eng)
    gc.collect()
    info["fabric_fp32"] = fabric_fp32_check(eng)
    emit(info)
    return info


# ------------------------------------------------------------ generate
def _generate_pair(eng_cpu, eng_gpu, prompt, max_new, **kw):
    """generate() on the CPU engine (plain versions) and on the card engine
    (kernels) from the same prompt; the tokens and each side's launches."""
    out = {}
    for name, eng in (("cpu", eng_cpu), ("cuda", eng_gpu)):
        reset_counts()
        toks = eng.generate(prompt, max_new_tokens=max_new, **kw)
        out[name] = (toks, read_counts())
    assert torch.equal(out["cpu"][0], out["cuda"][0]), (kw, out)
    assert all(n == 0 for n in out["cpu"][1].values()), out["cpu"][1]
    return out["cuda"]


def phase_reference_generate() -> dict:
    """generate() on the CPU (plain versions) and on the card (kernels) with
    the same weights, in fp32: a small LLaMA at GQA rep 8 and Dh 128 at
    batch 1 (the flash-decode route: a thin cache, a scalar index) and batch
    2 (the fused step), greedy and with EOS; a seeded sampled generate that
    repeats itself on the card; a small GPT-2 at batch 2."""
    cfg = LlamaConfig(vocab_size=32000, max_seq_len=512, num_layers=2,
                      hidden_size=2048, num_heads=16, num_kv_heads=2)
    engs = {}
    for device in ("cpu", "cuda"):
        engs[device] = deepspeed_tpu_torch.init_inference(
            LlamaModel(cfg), dtype="fp32", device=device, seed=3,
            params=None if device == "cpu" else _tree_to(engs["cpu"].params,
                                                         device))
    rng = np.random.RandomState(17)
    max_new, layers = 12, cfg.num_layers
    steps = layers * (max_new - 1)
    res = {"model": "llama 2 layers, hidden 2048, 16/2 heads (rep 8, Dh "
                    "128), vocab 32000, fp32", "max_new_tokens": max_new}
    for b, route in ((1, "flash_decode"), (2, "fused_decode_step")):
        prompt = rng.randint(0, 32000, size=(b, 40))
        toks, launches = _generate_pair(engs["cpu"], engs["cuda"], prompt,
                                        max_new)
        other = "fused_decode_step" if route == "flash_decode" else "flash_decode"
        assert launches[route] == steps and launches[other] == 0, launches
        eos = int(toks[0, 40 + 3])
        first = int((toks[0, 40:] == eos).nonzero()[0, 0])
        etoks, _ = _generate_pair(engs["cpu"], engs["cuda"], prompt, max_new,
                                  eos_token_id=eos, pad_token_id=0)
        assert torch.equal(etoks[0, :41 + first], toks[0, :41 + first])
        assert (etoks[0, 41 + first:] == 0).all(), etoks
        res[f"b{b}"] = {"route": route, "launches": launches[route],
                        "tokens_compared": int(toks[:, 40:].numel()),
                        "eos": eos, "eos_tokens": etoks[:, 40:].tolist()}
    kw = dict(max_new_tokens=max_new, do_sample=True, top_k=50, top_p=0.9,
              temperature=0.8, seed=1)
    prompt = rng.randint(0, 32000, size=(1, 40))
    a = engs["cuda"].generate(prompt, **kw)
    assert torch.equal(a, engs["cuda"].generate(prompt, **kw)), "sampling"
    assert torch.equal(a, eager_generate(engs["cuda"], prompt, **kw)), \
        "sampled replay != eager"
    res["sampled_repeats"] = True
    res["programs"] = engine_programs(engs["cuda"])
    del engs
    gcfg = GPT2Config(vocab_size=2048, max_seq_len=256, num_layers=2,
                      hidden_size=256, num_heads=4)
    g_cpu = deepspeed_tpu_torch.init_inference(GPT2Model(gcfg), dtype="fp32",
                                               device="cpu", seed=4)
    g_gpu = deepspeed_tpu_torch.init_inference(
        GPT2Model(gcfg), dtype="fp32", params=_tree_to(g_cpu.params, "cuda"))
    prompt = rng.randint(0, 2048, size=(2, 30))
    toks, launches = _generate_pair(g_cpu, g_gpu, prompt, max_new)
    assert launches["fused_decode_step"] == steps, launches
    assert launches["flash_decode"] == 0, launches
    eos = int(toks[0, 30 + 3])
    etoks, _ = _generate_pair(g_cpu, g_gpu, prompt, max_new,
                              eos_token_id=eos, pad_token_id=0)
    a = g_gpu.generate(prompt, **kw)
    assert torch.equal(a, g_gpu.generate(prompt, **kw)), "sampling"
    res["gpt2_b2"] = {"model": "gpt2 2 layers, hidden 256, 4 heads (Dh 64), "
                               "vocab 2048, fp32",
                      "launches": launches["fused_decode_step"],
                      "tokens_compared": int(toks[:, 30:].numel()),
                      "eos": eos, "eos_tokens": etoks[:, 30:].tolist(),
                      "sampled_repeats": True}
    info = {"phase": "reference_generate", "identical": True, **res}
    emit(info)
    return info


def check_generate_probe(eng, tokens, plen: int, tol: float, exact: bool,
                         last: int = 32) -> dict:
    """Row 0 of a generate() output recomputed on the card two ways: a
    batch-1 cached replay (a prefill of its ``plen`` prompt tokens into a
    cache padded to a multiple of 128 as generate pads it, so decode takes
    generate's route, then one decode step per generated token) and the
    plain no-cache forward. With ``exact`` (a batch-1 generate: the replay
    is generate's own computation) the replay's argmax is every generated
    token. Over the ``last`` steps the two agree within ``tol`` of max
    |logit|, and every generated token whose no-cache top-2 margin exceeds
    twice the measured difference is the no-cache argmax."""
    seq = tokens[:1, :-1].to(eng.device)
    cache_len = -(-tokens.shape[1] // 128) * 128
    replay = _replay(eng, seq, plen, cache_len=cache_len)
    served = tokens[0, plen:].tolist()
    same = sum(int(a == b) for a, b in zip(replay.argmax(-1).tolist(), served))
    assert not exact or same == len(served), \
        f"replay reproduced {same} of {len(served)} generated tokens"
    with torch.no_grad():
        ref = eng.forward(seq)[0, -last:].float()
    tail = replay[-last:]
    assert torch.isfinite(ref).all() and torch.isfinite(tail).all()
    err = (tail - ref).abs().max().item()
    scale = ref.abs().max().item()
    assert err <= tol * scale, f"cached replay vs no-cache: {err} / {scale}"
    top2 = ref.topk(2, dim=-1).values
    safe = ((top2[:, 0] - top2[:, 1]) > 2 * err).tolist()
    for step, (ok, want, got) in enumerate(zip(safe, ref.argmax(-1).tolist(),
                                               served[-last:])):
        assert not ok or want == got, f"generated token {step}: {got} != {want}"
    return {"replayed_steps": len(served), "cache_len": cache_len,
            "replay_tokens_equal": same, "compared_steps": last,
            "logit_max_abs_err": err, "logit_max_abs": scale, "tol": tol,
            "margin_safe_tokens_checked": int(sum(safe))}


def profile_generate(eng, b: int, prompt_len: int, steps: int = 5,
                     eager: bool = False) -> dict:
    """Device time of ``steps`` decode steps of generate's decode program
    (replayed, or with ``eager`` its step's eager closure) against their
    host wall time (the prefill runs before the window), by kernel, with
    the flash-decode kernels' share."""
    from torch.profiler import ProfilerActivity, profile

    prefill, decode = eng.programs(b, prompt_len, steps + 1)
    ids = torch.randint(0, eng.module.config.vocab_size, (b, prompt_len),
                        generator=torch.Generator().manual_seed(5))
    gen = torch.Generator(device=eng.device).manual_seed(0)
    state = _step_state(eng, b, prompt_len, steps + 1)
    step = state.step
    assert step.captures == 1, "profile a step shape captured before"
    if eager:
        state.step = step.eager
    tok, cache = prefill(eng.params, ids.to(eng.device), 1.0, gen)
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as pr:
            t0 = time.perf_counter()
            decode(eng.params, tok, cache, 1.0, gen)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        state.step = step
    kernels, busy_us, sum_us = device_time(pr)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    flash_us = sum(us for k, us in kernels.items() if "flash_decode" in k)
    # kernel B is two launches: the split walk and the merge (merge_splits;
    # flash-decode's merge is flash_decode_merge, counted above)
    fused_us = sum(us for k, us in kernels.items()
                   if "fused_decode_step" in k or "merge_splits" in k)
    return {"steps": steps, "host_ms_per_token": 1e3 * wall / steps,
            "device_ms_per_token": busy_us / 1e3 / steps,
            "kernel_ms_sum_per_token": sum_us / 1e3 / steps,
            "device_busy_share": busy_us / 1e6 / wall,
            "flash_decode_ms_per_token": flash_us / 1e3 / steps,
            "fused_decode_step_ms_per_token": fused_us / 1e3 / steps,
            "top_kernels_ms_per_token": {k[:60]: v / 1e3 / steps
                                         for k, v in top}}


def _timed_generate(eng, prompt, max_new: int) -> dict:
    """generate() through the public entry point with the launch counters
    zeroed just before it, then generate's own prefill program alone, so
    the decode share of the wall time can be split off; then generate()
    again with the decode step's eager closure, whose tokens must be the
    replayed ones bit for bit."""
    b, t = prompt.shape
    # the decode state's token step captured off the clock, by a 2-token
    # generate of the same prompt (it pads to the same cache)
    assert -(-(t + 2) // 128) == -(-(t + max_new) // 128)
    eng.generate(prompt, max_new_tokens=2)
    assert _step_state(eng, b, t, max_new).step.captures == 1
    torch.cuda.synchronize()
    reset_counts()                       # the main path starts here
    t0 = time.perf_counter()
    toks = eng.generate(prompt, max_new_tokens=max_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    prefill, _ = eng.programs(b, t, max_new)
    gen = torch.Generator(device=eng.device).manual_seed(0)
    ids = torch.as_tensor(prompt).long().to(eng.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill(eng.params, ids, 1.0, gen)
    torch.cuda.synchronize()
    pf = time.perf_counter() - t0
    vocab = eng.module.config.vocab_size
    assert toks.shape == (b, t + max_new)
    assert ((toks >= 0) & (toks < vocab)).all()
    assert torch.equal(toks[:, :t], torch.as_tensor(prompt).long())
    decode_s = wall - pf
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager = eager_generate(eng, prompt, max_new)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0 - pf
    assert torch.equal(eager, toks), "replayed tokens != eager tokens"
    return {"tokens": toks, "launches": launches, "wall_s": wall,
            "prefill_ms": 1e3 * pf,
            "host_ms_per_decode_token": 1e3 * decode_s / (max_new - 1),
            "host_ms_per_decode_token_eager": 1e3 * eager_s / (max_new - 1),
            "replayed_equals_eager": True,
            "decode_tokens_per_s": b * (max_new - 1) / decode_s,
            "tokens_per_s": b * max_new / wall}


def _free_card(what: str) -> int:
    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()   # one per stream the timings made
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    print(f"{what}: torch.cuda.memory_allocated() = {held}", flush=True)
    return held


def phase_generate_34b(smi: str) -> dict:
    """CodeLlama-34B at full width and depth in bf16 (random weights from a
    seeded torch.Generator) through generate(): greedy at batch 1 (512-token
    prompt, 64 new tokens, cache 640: the flash-decode route), its probe
    and a decode profile; greedy at batch 4 (the fused step at rep 8); a
    seeded sampled generate twice at batch 1."""
    held = _free_card("before generate_34b")
    assert held < 2 ** 30, f"earlier phases still hold {held} bytes"
    torch.cuda.reset_peak_memory_stats()
    cfg = LlamaConfig(**CODELLAMA_34B)
    t0 = time.perf_counter()
    eng = deepspeed_tpu_torch.init_inference(LlamaModel(cfg), dtype="bf16",
                                             seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree_leaves(eng.params))
    weights_gb = n_params * 2 / 1e9
    rng = np.random.RandomState(34)
    prompt1 = rng.randint(0, cfg.vocab_size, size=(1, 512))
    eng.generate(prompt1[:, :64], max_new_tokens=4)         # warm-up
    layers, max_new = cfg.num_layers, GENERATE_34B_NEW
    steps = layers * (max_new - 1)

    b1 = _timed_generate(eng, prompt1, max_new)
    assert b1["launches"]["flash_decode"] == steps, b1["launches"]
    assert b1["launches"]["fused_decode_step"] == 0, b1["launches"]
    probe = check_generate_probe(eng, b1["tokens"], 512, GENERATE_LOGIT_TOL,
                                 exact=True)
    prof1 = profile_generate(eng, 1, 512)
    prof1_eager = profile_generate(eng, 1, 512, eager=True)
    peak_b1 = torch.cuda.max_memory_allocated()

    prompt4 = np.repeat(prompt1, 4, axis=0)          # the same prompt, B 4
    b4 = _timed_generate(eng, prompt4, max_new)
    assert b4["launches"]["fused_decode_step"] == steps, b4["launches"]
    assert b4["launches"]["flash_decode"] == 0, b4["launches"]
    prof4 = profile_generate(eng, 4, 512)
    prof4_eager = profile_generate(eng, 4, 512, eager=True)

    kw = dict(max_new_tokens=32, do_sample=True, top_k=50, top_p=0.9,
              temperature=0.8, seed=1)
    s1 = eng.generate(prompt1, **kw)
    s2 = eng.generate(prompt1, **kw)
    assert torch.equal(s1, s2), "sampled generate did not repeat"
    assert torch.equal(s1, eager_generate(eng, prompt1, **kw)), \
        "sampled replay != eager"
    programs = engine_programs(eng)
    weight_bound_ms = 1e3 * n_params * 2 / HBM_BYTES_PER_S
    info = {"phase": "generate_34b", "card": smi,
            "model": "codellama_34b (48 layers, hidden 8192, 64/8 heads, "
                     "Dh 128, intermediate 22016, vocab 32000, rope_theta "
                     "1e6), bf16, random weights seed 0",
            "n_params": n_params, "weights_gb": weights_gb,
            "memory_before_init": held, "init_s": init_s,
            "b1": {k: v for k, v in b1.items() if k != "tokens"},
            "b1_probe": probe, "b1_profile": prof1,
            "b1_profile_eager": prof1_eager,
            "b1_device_ms_replayed_over_eager":
                prof1["device_ms_per_token"] / prof1_eager["device_ms_per_token"],
            "b1_peak_mem_gb": peak_b1 / 1e9,
            "b4": {k: v for k, v in b4.items() if k != "tokens"},
            # not asserted: batch 4 runs other GEMM shapes than batch 1
            "b4_rows_equal_to_b1": [torch.equal(row, b1["tokens"][0])
                                    for row in b4["tokens"]],
            "b4_profile": prof4, "b4_profile_eager": prof4_eager,
            "b4_device_ms_replayed_over_eager":
                prof4["device_ms_per_token"] / prof4_eager["device_ms_per_token"],
            "programs": programs,
            "weight_stream_bound_ms_per_token": weight_bound_ms,
            "sampled_repeats": True,
            "sampled_tokens": s1[0, 512:].tolist(),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(info)
    del eng
    _free_card("after generate_34b")
    return info


def phase_generate_gpt2(smi: str) -> dict:
    """GPT-2 774M in bf16 (random init) through generate(): batch 4, a
    128-token prompt, 64 new tokens (the fused step at Dh 64), and the probe
    on row 0."""
    _free_card("before generate_gpt2")
    torch.cuda.reset_peak_memory_stats()
    cfg = GPT2Config.gpt2_774m()
    eng = deepspeed_tpu_torch.init_inference(GPT2Model(cfg), dtype="bf16",
                                             seed=0)
    rng = np.random.RandomState(774)
    prompt = rng.randint(0, cfg.vocab_size, size=(4, 128))
    eng.generate(prompt[:, :16], max_new_tokens=4)          # warm-up
    max_new = 64
    run = _timed_generate(eng, prompt, max_new)
    steps = cfg.num_layers * (max_new - 1)
    assert run["launches"]["fused_decode_step"] == steps, run["launches"]
    assert run["launches"]["flash_decode"] == 0, run["launches"]
    probe = check_generate_probe(eng, run["tokens"], 128, GENERATE_LOGIT_TOL,
                                 exact=False)
    prof = profile_generate(eng, 4, 128)
    prof_eager = profile_generate(eng, 4, 128, eager=True)
    info = {"phase": "generate_gpt2", "card": smi,
            "model": "gpt2_774m (36 layers, hidden 1280, 20 heads of Dh 64, "
                     "vocab 50257), bf16, random init seed 0",
            **{k: v for k, v in run.items() if k != "tokens"},
            "probe": probe, "decode_profile": prof,
            "decode_profile_eager": prof_eager,
            "device_ms_replayed_over_eager": prof["device_ms_per_token"]
            / prof_eager["device_ms_per_token"],
            "programs": engine_programs(eng),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(info)
    del eng
    return info


# ------------------------------------------------------------ training
# bench.py's GPT-2 774M training config (bench.py:173-183), at micro-batch 8
BENCH_774M_CONFIG = {
    "train_batch_size": 8 * 2,
    "gradient_accumulation_steps": 2,
    "bf16": {"enabled": True},
    "optimizer": {"type": "AdamW",
                  "params": {"lr": 1e-4, "weight_decay": 0.01}},
    "gradient_clipping": 1.0,
    "steps_per_print": 0,
    "zero_optimization": {"stage": 0},
    "data_types": {"grad_accum_dtype": "bf16"},
}


def lm_batches(rng, n, gas, micro, t, vocab, start_span=None):
    """``n`` stacked ``[gas, micro, t]`` batches of arithmetic sequences mod
    ``vocab`` (learnable, unlike random tokens, which sit at ln V), starting
    below ``start_span`` (default ``vocab``)."""
    out = []
    for _ in range(n):
        start = rng.randint(0, start_span or vocab, size=(gas, micro, 1))
        step = rng.randint(1, 8, size=(gas, micro, 1))
        ids = ((start + step * np.arange(t + 1)) % vocab).astype(np.int32)
        out.append({"input_ids": ids[..., :-1], "labels": ids[..., 1:]})
    return out


def phase_reference_train() -> dict:
    """A small fp32 GPT-2 trained 4 steps through initialize() on the CPU
    (plain versions) and on the card (kernels), from one init and the same
    batches."""
    cfg = GPT2Config(vocab_size=2048, max_seq_len=128, num_layers=2,
                     hidden_size=256, num_heads=4)
    ds = {"train_batch_size": 8, "gradient_accumulation_steps": 2,
          "optimizer": {"type": "AdamW",
                        "params": {"lr": 1e-3, "weight_decay": 0.01}},
          "scheduler": {"type": "WarmupLR",
                        "params": {"warmup_min_lr": 1e-4, "warmup_max_lr": 1e-3,
                                   "warmup_num_steps": 3}},
          "gradient_clipping": 1.0, "steps_per_print": 0}
    params = GPT2Model(cfg).init(torch.Generator().manual_seed(5))
    batches = lm_batches(np.random.RandomState(21), 4, 2, 4, 128, 2048)
    runs = {}
    for device in ("cpu", "cuda"):
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=GPT2Model(cfg, compute_dtype=torch.float32, attn_impl="flash"),
            config=ds, device=device, params=params)
        reset_counts()
        rows = [(float(eng.train_batch_from_stacked(b)),
                 eng.get_global_grad_norm()) for b in batches]
        runs[device] = (rows, read_counts(),
                        [p.float().cpu() for p in tree_leaves(eng.state.params)])
    micro_steps = 4 * 2
    assert all(n == 0 for n in runs["cpu"][1].values()), runs["cpu"][1]
    for name, n in runs["cuda"][1].items():
        want = cfg.num_layers * micro_steps if name in FLASH else 0
        assert n == want, (name, n, want)
    worst_loss = worst_norm = 0.0
    for (cl, cn), (gl, gn) in zip(runs["cpu"][0], runs["cuda"][0]):
        worst_loss = max(worst_loss, abs(gl - cl) / abs(cl))
        worst_norm = max(worst_norm, abs(gn - cn) / abs(cn))
    assert worst_loss <= 1e-4 and worst_norm <= 1e-4, runs
    lr_bound = 2 * 1e-3 * len(batches)
    diff_max, off, total = 0.0, 0, 0
    for a, b in zip(runs["cpu"][2], runs["cuda"][2]):
        d = (a - b).abs()
        diff_max = max(diff_max, d.max().item())
        off += int((d > 1e-5).sum())
        total += d.numel()
    assert diff_max <= lr_bound and off <= 1e-3 * total, (diff_max, off, total)
    losses = [r[0] for r in runs["cuda"][0]]
    info = {"phase": "reference_train",
            "model": "gpt2 2 layers, hidden 256, 4 heads (Dh 64), vocab 2048, "
                     "T 128, fp32, attn flash",
            "steps": len(batches), "gas": 2, "micro_batch": 4,
            "card_losses": losses, "cpu_losses": [r[0] for r in runs["cpu"][0]],
            "loss_max_rel_diff": worst_loss, "grad_norm_max_rel_diff": worst_norm,
            "param_max_abs_diff": diff_max, "params_off_by_1e-5": off,
            "params_total": total, "card_launches": runs["cuda"][1]}
    emit(info)
    return info


def profile_train_step(eng, batch) -> dict:
    """Device time of one training step against its wall time, by kernel."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pr:
        t0 = time.perf_counter()
        eng.train_batch_from_stacked(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for ev in pr.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.name] = (kernels.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us())
    busy_us = sum(kernels.values())
    assert busy_us > 0, "the profiler saw no device time"
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    flash = {}
    for name in ("flash_fwd_wgmma", "flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma"):
        flash[name] = sum(us for k, us in kernels.items() if name in k) / 1e3
    return {"host_ms": 1e3 * wall, "device_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e6 / wall,
            "flash_kernels_ms": flash,
            "top_kernels_ms": {k[:120]: v / 1e3 for k, v in top}}


def phase_train_774m(smi: str) -> dict:
    """GPT-2 774M at full width and depth through initialize() with the
    bench's config: 2 warm-up and 8 measured steps of micro-batch 8 x gas 2
    x T 1024, the launch counters zeroed just before the measured steps."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg = GPT2Config.gpt2_774m()
    gas, micro, t, warm, steps = 2, 8, 1024, 2, 8
    model = GPT2Model(cfg, attn_impl="flash")
    t0 = time.perf_counter()
    eng, *_ = deepspeed_tpu_torch.initialize(model=model,
                                             config=BENCH_774M_CONFIG)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in tree_leaves(eng.state.params))
    # starts below 1000 and steps of 1-7 keep the tokens under ~8.2k of the
    # 50k vocab: the loss can fall within ten steps at lr 1e-4
    batches = lm_batches(np.random.RandomState(0), warm + steps + 1, gas,
                         micro, t, cfg.vocab_size, start_span=1000)
    # the first micro-batch through flash and through dense attention, on
    # the same (initial) parameters: a check of the model's flash route at
    # full width (layouts, scale, causal alignment), not of the kernels'
    # arithmetic, which at init barely moves the loss (the kernels phase
    # and reference_train hold that)
    first = {k: v[0] for k, v in batches[0].items()}
    flash_loss = float(eng.eval_batch(first))
    dense = GPT2Model(cfg, attn_impl="dense")
    with torch.no_grad():
        cp = eng._cast_for_compute(eng.state.params)
        tb = {k: torch.as_tensor(v).long().to(eng.device) for k, v in first.items()}
        dense_loss = float(dense.apply(cp, tb)[0])
        del cp, tb
    assert abs(flash_loss - dense_loss) <= FLASH_DENSE_LOSS_TOL, \
        (flash_loss, dense_loss)

    losses = [eng.train_batch_from_stacked(b) for b in batches[:warm]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                       # the main path starts here
    t0 = time.perf_counter()
    for b in batches[warm:warm + steps]:
        losses.append(eng.train_batch_from_stacked(b))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], losses
    for name, n in launches.items():
        want = cfg.num_layers * gas * steps if name in FLASH else 0
        assert n == want, (name, n, want)
    prof = profile_train_step(eng, batches[-1])
    chunked = _loss_chunk_pair(eng, cfg, batches[-1])
    tokens = gas * micro * t * steps
    flops_tok = model.flops_per_token(t)
    info = {"phase": "train_774m", "card": smi,
            "model": "gpt2_774m (36 layers, hidden 1280, 20 heads, vocab "
                     "50257), random init seed 1234, attn flash, no remat, "
                     "no loss_chunk",
            "config": BENCH_774M_CONFIG, "n_params": n_params,
            "micro_batch": micro, "gas": gas, "seq_len": t,
            "warmup_steps": warm, "measured_steps": steps,
            "first_batch_loss_flash": flash_loss,
            "first_batch_loss_dense": dense_loss,
            "flash_dense_loss_tol": FLASH_DENSE_LOSS_TOL, "losses": losses,
            "launches": launches, "init_s": init_s, "wall_s": wall,
            "ms_per_step": 1e3 * wall / steps, "tokens_per_s": tokens / wall,
            "flop_per_token": flops_tok,
            "achieved_tflops": tokens / wall * flops_tok / 1e12,
            "peak_mem_gb": peak / 1e9, "profile_one_step": prof,
            "loss_chunk": chunked}
    emit(info)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return info


def _clone_tree(x):
    if isinstance(x, dict):
        return {k: _clone_tree(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_clone_tree(v) for v in x))
    return x.clone() if isinstance(x, torch.Tensor) else x


def _snapshot_state(eng):
    """A copy of everything a training step reads and updates in place."""
    return (_clone_tree(eng.state), eng.global_steps, eng.micro_steps,
            eng.skipped_steps,
            eng.lr_scheduler.state_dict() if eng.lr_scheduler else None)


def _restore_state(eng, snap) -> None:
    state, eng.global_steps, eng.micro_steps, eng.skipped_steps, lr = snap
    eng.state = _clone_tree(state)
    if lr is not None:
        eng.lr_scheduler.load_state_dict(lr)


# the 774M loss with and without the chunked LM loss, relative: the same
# f32 terms summed per chunk and then over chunks
LOSS_CHUNK_TOL = 1e-5
# ... and the step's gradients: each element of the wte gradient is a bf16
# rounding of an f32 sum of the same products (over all chunks, or in one
# GEMM), so the two may differ by an ulp (2^-8 relative, at most): the
# global grad norm within 2^-8 relative, and AdamW's update of the f32 wte
# (which the clipped gradient moves through the first moment) within 2^-7
# of its norm
LOSS_CHUNK_GRAD_NORM_TOL = 2 ** -8
LOSS_CHUNK_UPDATE_TOL = 2 ** -7


def _loss_chunk_pair(eng, cfg, batch, chunk: int = 128) -> dict:
    """One step with ``GPT2Config(loss_chunk=chunk)`` and one without, on
    the same batch from the same state (the engine's model swapped; each
    after a warm-up step from that state): the
    losses, the global grad norms and the updates of wte agree (the chunked
    loss's own backward against autograd's), and the time and peak memory
    of each step are reported."""
    snap = _snapshot_state(eng)
    module = eng.module
    wte0 = snap[0].params["wte"]
    out, updates = {}, {}
    for name, c in ((f"loss_chunk_{chunk}", chunk), ("unchunked", 0)):
        eng.module = GPT2Model(GPT2Config.gpt2_774m(loss_chunk=c),
                               attn_impl="flash")
        gc.collect()
        torch.cuda.empty_cache()
        # a warm-up step from the same state, then the one measured
        _restore_state(eng, snap)
        eng.train_batch_from_stacked(batch)
        _restore_state(eng, snap)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = float(eng.train_batch_from_stacked(batch))
        torch.cuda.synchronize()
        out[name] = {"loss": loss, "step_ms": 1e3 * (time.perf_counter() - t0),
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "grad_norm": eng.get_global_grad_norm()}
        updates[name] = eng.state.params["wte"].float() - wte0.float()
    eng.module = module
    del snap, wte0
    a, b = out[f"loss_chunk_{chunk}"], out["unchunked"]
    rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    norm_rel = abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
    du = updates["unchunked"]
    upd_rel = ((updates[f"loss_chunk_{chunk}"] - du).norm() / du.norm()).item()
    del updates, du
    out.update(loss_rel_diff=rel, tol_rel=LOSS_CHUNK_TOL,
               grad_norm_rel_diff=norm_rel,
               grad_norm_tol_rel=LOSS_CHUNK_GRAD_NORM_TOL,
               wte_update_rel_diff=upd_rel,
               wte_update_tol_rel=LOSS_CHUNK_UPDATE_TOL,
               note="peak memory includes a copy of the engine's state "
                    "(masters and moments) kept to start both steps alike")
    assert rel <= LOSS_CHUNK_TOL, out
    assert norm_rel <= LOSS_CHUNK_GRAD_NORM_TOL, out
    assert upd_rel <= LOSS_CHUNK_UPDATE_TOL, out
    return out


TINYLLAMA_TRAIN_CONFIG = {**BENCH_774M_CONFIG, "train_batch_size": 4 * 2}
# (name, remat, remat_policy) of train_tinyllama's runs
REMAT_RUNS = (("off", False, None), ("nothing", True, "nothing"),
              ("save_attn", True, "save_attn"))


def phase_train_tinyllama(smi: str) -> dict:
    """TinyLlama-1.1B at full width and depth (random init, seed 1234)
    trained through initialize() in bf16 (AdamW, ZeRO 0), attn_impl
    "flash", micro-batch 4 x gas 2 x T 2048: three runs on one engine, remat
    off, "nothing" and "save_attn" (the model swapped between runs), each
    one warm-up and 4 measured steps (2 and 6 before train_llama7b_offload
    took its share of the run's time), the launch counters zeroed just
    before the measured steps. Then two steps under
    DSTPU_FLASH_F32_PRECISE=1 (the f32-precise kernels)."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg = LlamaConfig(**TINYLLAMA_1B)
    gas, micro, t, warm, steps = 2, 4, 2048, 1, 4
    t0 = time.perf_counter()
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=LlamaModel(cfg, attn_impl="flash"), config=TINYLLAMA_TRAIN_CONFIG)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in tree_leaves(eng.state.params))
    batches = lm_batches(np.random.RandomState(1), len(REMAT_RUNS) * (warm + steps)
                         + 2, gas, micro, t, cfg.vocab_size, start_span=1000)
    # the model's flash route at full width: the first micro-batch's loss
    # through flash and through dense attention on the same parameters
    first = {k: v[0] for k, v in batches[0].items()}
    flash_loss = float(eng.eval_batch(first))
    with torch.no_grad():
        cp = eng._cast_for_compute(eng.state.params)
        tb = {k: torch.as_tensor(v).long().to(eng.device) for k, v in first.items()}
        dense_loss = float(LlamaModel(cfg, attn_impl="dense").apply(cp, tb)[0])
        del cp, tb
    assert abs(flash_loss - dense_loss) <= FLASH_DENSE_LOSS_TOL, \
        (flash_loss, dense_loss)
    flops_tok = eng.module.flops_per_token(t)
    it = iter(batches)
    runs, all_losses, launches_sum = {}, [], dict.fromkeys(WRAPPERS, 0)
    for name, remat, policy in REMAT_RUNS:
        eng.module = LlamaModel(cfg, attn_impl="flash", remat=remat,
                                remat_policy=policy)
        losses = [eng.train_batch_from_stacked(next(it)) for _ in range(warm)]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()                   # the main path starts here
        t0 = time.perf_counter()
        for _ in range(steps):
            losses.append(eng.train_batch_from_stacked(next(it)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        losses = [float(x) for x in losses]
        assert all(math.isfinite(x) for x in losses), (name, losses)
        fwd_per = (2 if policy == "nothing" else 1) * cfg.num_layers * gas
        for k, n in launches.items():
            want = {"flash_fwd": fwd_per, "flash_bwd_dq": cfg.num_layers * gas,
                    "flash_bwd_dkv": cfg.num_layers * gas}.get(k, 0) * steps
            assert n == want, (name, k, n, want)
        for k in launches_sum:
            launches_sum[k] += launches[k]
        tokens = gas * micro * t * steps
        runs[name] = {"remat": remat, "remat_policy": policy, "losses": losses,
                      "ms_per_step": 1e3 * wall / steps,
                      "tokens_per_s": tokens / wall,
                      "mfu": tokens / wall * flops_tok / BF16_FLOP_PER_S,
                      "peak_mem_gb": peak / 1e9,
                      "launches_per_step": {k: launches[k] / steps
                                            for k in FLASH}}
        all_losses += losses
    assert all_losses[-1] < all_losses[0], all_losses
    assert runs["nothing"]["peak_mem_gb"] < runs["off"]["peak_mem_gb"], runs
    # the f32-precise mode on the same path: two steps, remat off
    eng.module = LlamaModel(cfg, attn_impl="flash")
    default_now = float(eng.eval_batch(first))
    os.environ["DSTPU_FLASH_F32_PRECISE"] = "1"
    try:
        precise_first = float(eng.eval_batch(first))
        reset_counts()
        t0 = time.perf_counter()
        p_losses = [float(eng.train_batch_from_stacked(next(it)))
                    for _ in range(2)]
        torch.cuda.synchronize()
        p_wall = time.perf_counter() - t0
        p_launches = read_counts()
    finally:
        del os.environ["DSTPU_FLASH_F32_PRECISE"]
    assert all(math.isfinite(x) for x in p_losses), p_losses
    for k, n in p_launches.items():
        want = cfg.num_layers * gas * 2 if k in PRECISE else 0
        assert n == want, ("precise", k, n, want)
    assert abs(precise_first - default_now) <= FLASH_DENSE_LOSS_TOL, \
        (precise_first, default_now)
    for k in PRECISE:
        launches_sum[k] += p_launches[k]
    info = {"phase": "train_tinyllama", "card": smi,
            "model": "TinyLlama-1.1B (22 layers, hidden 2048, 32 / 4 heads of "
                     "Dh 64, intermediate 5632, vocab 32000), random init "
                     "seed 1234, attn flash",
            "config": TINYLLAMA_TRAIN_CONFIG, "n_params": n_params,
            "micro_batch": micro, "gas": gas, "seq_len": t,
            "warmup_steps": warm, "measured_steps": steps, "init_s": init_s,
            "flop_per_token": flops_tok,
            "first_batch_loss_flash": flash_loss,
            "first_batch_loss_dense": dense_loss,
            "flash_dense_loss_tol": FLASH_DENSE_LOSS_TOL, "runs": runs,
            "precise": {"first_batch_loss": precise_first,
                        "first_batch_loss_default_mode": default_now,
                        "losses": p_losses,
                        "ms_per_step": 1e3 * p_wall / 2,
                        "launches": {k: p_launches[k] for k in PRECISE}},
            "launches": launches_sum}
    emit(info)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return info


def _dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


# checkpoint_roundtrip's depth: 1 of TinyLlama's 22 layers (0.18 B
# parameters, ~2.1 GB a tag); train_774m_resilience covers save, load,
# walk-back and resume at the 774M width
CKPT_LAYERS = 1


def phase_checkpoint_roundtrip(smi: str) -> dict:
    """TinyLlama width at CKPT_LAYERS of its 22 layers, trained as
    train_tinyllama (remat off): one 3-step stretch replayed from the same
    state (is the step bit-identical run to run?); save at step 3, 3 more
    steps; a fresh
    engine loads the tag and takes the same 3 steps (losses held to the
    uninterrupted run's: bit-identical, or within the replay's spread);
    its own tag at step 6, corrupted, makes the next load walk back to
    step 3; init_inference(config={"checkpoint": dir}) then generates the
    tokens the engine's in-memory parameters generate. The directory is
    temporary and removed at the end."""
    import tempfile

    gc.collect()
    torch.cuda.empty_cache()
    cfg = LlamaConfig(**{**TINYLLAMA_1B, "num_layers": CKPT_LAYERS})
    gas, micro, t = 2, 4, 2048
    batches = lm_batches(np.random.RandomState(2), 6, gas, micro, t,
                         cfg.vocab_size, start_span=1000)
    reg = get_registry()
    events0 = {n: reg.counter(n).value for n in ("checkpoint/saves",
                                                 "checkpoint/loads")}

    def engine(seed):
        e, *_ = deepspeed_tpu_torch.initialize(
            model=LlamaModel(cfg, attn_impl="flash"),
            config={**TINYLLAMA_TRAIN_CONFIG, "seed": seed})
        return e

    root = Path(tempfile.mkdtemp(prefix="dstorch_ckpt_"))
    try:
        reset_counts()
        e1 = engine(0)
        snap = _snapshot_state(e1)
        first = [float(e1.train_batch_from_stacked(b)) for b in batches[:3]]
        p_first = _clone_tree(e1.state.params)
        _restore_state(e1, snap)
        del snap
        replay = [float(e1.train_batch_from_stacked(b)) for b in batches[:3]]
        identical = first == replay and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(p_first),
                                              tree_leaves(e1.state.params)))
        spread = max(abs(a - b) for a, b in zip(first, replay))
        del p_first
        embed3 = e1.state.params["embed"].clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e1.save_checkpoint(str(root), tag="step3")
        save_s = time.perf_counter() - t0
        tag_bytes = _dir_bytes(root / "step3")
        after = [float(e1.train_batch_from_stacked(b)) for b in batches[3:]]
        del e1
        gc.collect()
        torch.cuda.empty_cache()

        e2 = engine(1)
        t0 = time.perf_counter()
        path, _ = e2.load_checkpoint(str(root))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        assert path.endswith("step3") and e2.global_steps == 3, path
        assert torch.equal(e2.state.params["embed"], embed3)
        resumed = [float(e2.train_batch_from_stacked(b)) for b in batches[3:]]
        if identical:
            assert resumed == after, (resumed, after)
        else:
            assert max(abs(a - b) for a, b in zip(resumed, after)) \
                <= 2 * spread, (resumed, after, spread)
        # the newest tag corrupted: the next load walks back to step 3
        e2.save_checkpoint(str(root), tag="step6")
        npz = root / "step6" / "state.npz"
        raw = npz.stat().st_size
        with open(npz, "r+b") as f:
            f.truncate(raw // 2)
        path, _ = e2.load_checkpoint(str(root))
        assert path.endswith("step3") and e2.global_steps == 3, path
        assert torch.equal(e2.state.params["embed"], embed3)
        del embed3

        # serve the tag, and the engine's in-memory parameters (batch 2:
        # generate's decode steps take kernel B)
        prompt = torch.as_tensor(np.random.RandomState(3).randint(
            0, cfg.vocab_size, size=(2, 64)))
        reset_counts()
        served = deepspeed_tpu_torch.init_inference(
            LlamaModel(cfg), config={"dtype": "bf16", "checkpoint": str(root)})
        from_tag = served.generate(prompt, max_new_tokens=32).cpu()
        del served
        mem = deepspeed_tpu_torch.init_inference(
            LlamaModel(cfg), config={"dtype": "bf16"}, params=e2.state.params)
        from_mem = mem.generate(prompt, max_new_tokens=32).cpu()
        gen_launches = read_counts()
        del mem
        assert torch.equal(from_tag, from_mem), (from_tag, from_mem)
        assert gen_launches["fused_decode_step"] > 0, gen_launches
        events = {n: reg.counter(n).value - v for n, v in events0.items()}
        assert events == {"checkpoint/saves": 2, "checkpoint/loads": 2}, events
        info = {"phase": "checkpoint_roundtrip", "card": smi,
                "model": f"TinyLlama-1.1B width, {CKPT_LAYERS} of its 22 layers, bf16 "
                         "training (masters and moments f32), attn flash",
                "n_params": sum(p.numel() for p in tree_leaves(e2.state.params)),
                "replay_bit_identical": identical, "replay_spread": spread,
                "losses_uninterrupted": after, "losses_resumed": resumed,
                "save_s": save_s, "load_s": load_s, "tag_bytes": tag_bytes,
                "walked_back_to": "step3", "generated_tokens": 32,
                "served_from_tag_equals_in_memory": True,
                "generate_launches": {k: gen_launches[k]
                                      for k in ("fused_decode_step",
                                                "flash_decode")},
                "events": events}
        emit(info)
        del e2
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    info["launches"] = gen_launches
    return info


# -------------------------------------------------------------- resilience
# GPT-2 774M at full width and 2 of its 36 layers: a tag (f32 masters and
# two moments) is ~1.3 GB, so the phase's saves and loads fit its time
RES_LAYERS = 2
RES_SAMPLES = 512
RES_FLIP_AFTER = (6, 13)     # flip a master's top exponent bit after these
RES_CKPT_INTERVAL = 4
RES_A_END = 11               # run (a) and its clean run train to this step
RES_B_END = 2                # run (b): the replay probe every 2 steps
RES_C_TRIGGER, RES_C_AFTER = 5, 3   # run (c): preempt at 5, resume 3 steps
# steps 10-11 timed, armed (run (a) after its second rewind) and unarmed
# (its clean run): quiet steps late in each run (the phase's first engine
# ran its steps 2-3 ~35% slower on an H100, with the same sentinel work)
RES_TIMED = (9, 11)
# a random-init 774M's loss and grad norm fall fast over its first steps,
# which the default 8-sigma spike threshold reads as spikes (three in run
# (a) on an H100); the phase injects its own faults, so it holds the
# threshold the JAX package's chaos tests hold
RES_SPIKE_Z = 50.0
RES_FLIP_LEAF = "['blocks']['qkv_w']"
RES_FLIP_ELEMENT = 5


def _res_samples(vocab: int, t: int, n: int = RES_SAMPLES, seed: int = 0):
    """``n`` samples of ``lm_batches``' arithmetic sequences (starting
    below token 1000), for ``initialize(training_data=...)``."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        start, step = rng.randint(0, 1000), rng.randint(1, 8)
        ids = ((start + step * np.arange(t + 1)) % vocab).astype(np.int32)
        out.append({"input_ids": ids[:-1], "labels": ids[1:]})
    return out


def _res_state(eng) -> list:
    """Everything the step updates: masters, moments, counters, scale."""
    st = eng.state
    out = tree_leaves(st.params)
    if st.opt_state:
        out = out + tree_leaves(st.opt_state.exp_avg) \
            + tree_leaves(st.opt_state.exp_avg_sq) + [st.opt_state.step]
    return out + [st.global_step, float(st.scaler.cur_scale)]


def _res_equal(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(a, b))


def _res_clone(eng) -> list:
    return [x.clone() if isinstance(x, torch.Tensor) else x
            for x in _res_state(eng)]


def _res_flip(eng, names) -> None:
    """Flip bit 30 (the exponent's top bit) of one f32 master element of
    layer 0's qkv weight: one card's memory bit flip."""
    from deepspeed_tpu_torch.testing import flip_param_bit

    flip_param_bit(eng, leaf_index=names.index(RES_FLIP_LEAF),
                   byte=4 * RES_FLIP_ELEMENT + 3, bit=6)


def _res_sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _res_timed(calls: list, fn):
    """``fn`` wrapped to append its ms (the device synchronized before and
    after) to ``calls``."""
    def timed(*a, **k):
        _res_sync()
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            _res_sync()
            calls.append(1e3 * (time.perf_counter() - t0))
    return timed


def phase_train_774m_resilience(smi: str, dev: str = "cuda") -> dict:
    """Training resilience on GPT-2 774M at full width (d 1280, 20 heads,
    T 1024, vocab 50257) and a cut depth of RES_LAYERS of its 36 layers (a
    tag of f32 masters and two moments is ~1.3 GB at 2, ~9 GB at full
    depth), bf16,
    micro-batch 8 x gas 2, the bench optimizer, attn flash, the data
    through initialize(training_data=...) and train_batch() (recovery
    rewinds only a stream the engine owns). Held:

    (a) the sentinel: resilience armed (checkpoint_interval 4, a check
        every step, spikes above 50 robust sigmas); after steps 6 and 13
        flip_param_bit flips the top exponent bit of one f32 master
        element of layer 0's qkv weight, and before the second rewind the
        newest tag is truncated (corrupt_file). Each rewind_log record's
        class (nonfinite), anomaly step (7, 14), rewound-to step (4, then
        8: the walk-back past the corrupt tag 12) and skipped batches (gas
        x (anomaly - rewound + 1)) are the protocol's; the counters
        resilience/rewinds, skipped_batches and anomalies_nonfinite; the
        final masters, moments and counters bit-identical to a clean
        engine's that skipped the same batches.
    (c) preemption, on that clean run: install_preemption_handler(
        defer=True) with an exit_fn that records the code and returns;
        trigger() after step 5; the next train_batch saves at its step
        boundary (code 101) and the run goes on, uninterrupted; a fresh
        engine loads the tag and takes 3 steps bit-identical (losses and
        state) to the clean run's steps 6-8.
    (b) the step-replay probe every 2 steps: the first probe's second
        replay runs a step function that flips one bit of its clone's
        output: a replay anomaly, a rewind to the baseline tag that skips
        nothing; the next probe reads ok (the card's whole-state
        determinism check: two replays of the step on clones give the same
        crc32 over masters, moments and metrics); the state at step 2
        bit-identical to the clean run's.
    Reported: an armed, quiet step against an unarmed one (steps 10-11 of
    run (a) and of its clean run, ms, same call), save, load and recovery
    ms, the probe's ms split into clone, step and digest (the sentinel's
    functions wrapped here)."""
    import tempfile

    import deepspeed_tpu_torch.runtime.sentinel as sentinel
    from deepspeed_tpu_torch.testing import corrupt_file

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(GPT2Config.gpt2_774m(), num_layers=RES_LAYERS)
    gas = BENCH_774M_CONFIG["gradient_accumulation_steps"]
    samples = _res_samples(cfg.vocab_size, cfg.max_seq_len)
    reg = get_registry()
    names_c = ("rewinds", "skipped_batches", "anomalies_nonfinite",
               "step_replays", "step_replay_mismatches")

    def counters():
        return {n: reg.counter(f"resilience/{n}").value for n in names_c}

    def engine(res=None):
        conf = dict(BENCH_774M_CONFIG)
        if res is not None:
            conf["resilience"] = res
        e, *_ = deepspeed_tpu_torch.initialize(
            model=GPT2Model(cfg, attn_impl="flash"), config=conf,
            training_data=samples, device=None if dev == "cuda" else dev)
        return e

    root = Path(tempfile.mkdtemp(prefix="dstorch_resilience_"))
    steps_run = 0                        # train steps the kernels ran
    save_ms, load_ms = [], []
    try:
        reset_counts()                   # the main path starts here
        # ---- (a) the sentinel: two bit flips, a corrupt tag
        c0 = counters()
        ck_a = root / "a"
        eng = engine({"enabled": True, "checkpoint_dir": str(ck_a),
                      "checkpoint_interval": RES_CKPT_INTERVAL,
                      "check_interval": 1, "spike_zscore": RES_SPIKE_Z})
        names = list(param_names(eng.state.params))
        eng.save_checkpoint = _res_timed(save_ms, eng.save_checkpoint)
        eng.load_checkpoint = _res_timed(load_ms, eng.load_checkpoint)
        flips, a_losses, t0, armed_ms = list(RES_FLIP_AFTER), [], None, None
        while eng.global_steps < RES_A_END or flips:
            if flips and eng.global_steps == flips[0]:
                if len(flips) == 1:      # the newest tag rots first
                    newest = (ck_a / "latest").read_text().strip()
                    corrupt_file(str(ck_a / newest / "state.npz"))
                _res_flip(eng, names)
                flips.pop(0)
            if not flips and eng.global_steps == RES_TIMED[0]:
                _res_sync()
                t0 = time.perf_counter()
            a_losses.append(eng.train_batch())
            if t0 is not None and eng.global_steps == RES_TIMED[1]:
                _res_sync()
                armed_ms = 1e3 * (time.perf_counter() - t0) \
                    / (RES_TIMED[1] - RES_TIMED[0])
        steps_run += len(a_losses)
        a_losses = [float(x) for x in a_losses]
        log = [dict(r) for r in eng.rewind_log]
        got = [(r["class"], r["anomaly_step"], r["rewound_to"],
                r["skipped_batches"], Path(r["checkpoint"]).name)
               for r in log]
        want = [("nonfinite", 7, 4, gas * (7 - 4 + 1), "global_step4"),
                ("nonfinite", 14, 8, gas * (14 - 8 + 1), "global_step8")]
        assert got == want, (got, want)
        c1 = counters()
        a_counters = {k: c1[k] - c0[k] for k in names_c[:3]}
        assert a_counters == {"rewinds": 2,
                              "skipped_batches": want[0][3] + want[1][3],
                              "anomalies_nonfinite": 2}, a_counters
        a_state = _res_clone(eng)
        del eng
        gc.collect()

        # ---- the clean run with the same skips, preempted (c) at step 5
        clean = engine()
        ck_c, codes, c_save_ms = root / "c", [], []
        clean.save_checkpoint = _res_timed(c_save_ms, clean.save_checkpoint)
        h = clean.install_preemption_handler(str(ck_c), defer=True,
                                             exit_fn=codes.append)
        skips = {r["rewound_to"]: r["skipped_batches"] for r in log}
        clean_losses, kept, unarmed_ms = [], {}, None
        try:
            while clean.global_steps < RES_A_END:
                step = clean.global_steps
                it = clean._ensure_train_iter()
                for _ in range(skips.pop(step, 0)):
                    next(it)
                if step == RES_C_TRIGGER:
                    h.trigger(reason="maintenance event")
                    assert codes == [], codes    # deferred to the boundary
                if step == RES_TIMED[0]:
                    _res_sync()
                    t0 = time.perf_counter()
                clean_losses.append(clean.train_batch())
                if clean.global_steps == RES_TIMED[1]:
                    _res_sync()
                    unarmed_ms = 1e3 * (time.perf_counter() - t0) \
                        / (RES_TIMED[1] - RES_TIMED[0])
                if clean.global_steps in (RES_B_END,
                                          RES_C_TRIGGER + RES_C_AFTER):
                    kept[clean.global_steps] = _res_clone(clean)
        finally:
            h.uninstall()
        steps_run += RES_A_END
        assert codes == [101] and len(c_save_ms) == 1, (codes, c_save_ms)
        clean_losses = [float(x) for x in clean_losses]
        a_identical = _res_equal(a_state, _res_state(clean))
        assert a_identical, "run (a): the rewound run left the clean run"
        assert a_losses[-3:] == clean_losses[-3:], (a_losses, clean_losses)
        del clean, a_state
        gc.collect()

        # ---- (b) the replay probe, once perturbed
        c0 = counters()
        eng = engine({"enabled": True, "checkpoint_dir": str(root / "b"),
                      "check_interval": 1, "step_replay_interval": 2,
                      "spike_zscore": RES_SPIKE_Z})
        eng.save_checkpoint = _res_timed(save_ms, eng.save_checkpoint)
        eng.load_checkpoint = _res_timed(load_ms, eng.load_checkpoint)
        probe_ms = {"probe": [], "clone": [], "digest": []}
        wrapped = (("step_replay_probe", "probe"), ("clone_tree", "clone"),
                   ("_tree_digest", "digest"))
        real_fns = {n: getattr(sentinel, n) for n, _ in wrapped}
        for n, key in wrapped:
            setattr(sentinel, n, _res_timed(probe_ms[key], real_fns[n]))
        try:
            eng.train_batch()
            real, calls = eng._train_step, [0]

            def perturbed(state, *a, **k):
                out, m = real(state, *a, **k)
                calls[0] += 1
                if calls[0] == 3:        # step 2's live step, then replays
                    from deepspeed_tpu_torch.testing import flip_param_bit

                    flip_param_bit(type("Replica", (), {"state": out})(),
                                   leaf_index=names.index(RES_FLIP_LEAF),
                                   byte=1)
                return out, m

            eng._train_step = perturbed
            eng.train_batch()
            eng._train_step = real
            assert calls[0] == 3, calls
            b_log = [dict(r) for r in eng.rewind_log]
            assert [(r["class"], r["anomaly_step"], r["rewound_to"],
                     r["skipped_batches"]) for r in b_log] == \
                [("replay", 2, 0, 0)], b_log
            b_calls = 2
            while eng.global_steps < RES_B_END:
                eng.train_batch()
                b_calls += 1
        finally:
            for n, _ in wrapped:
                setattr(sentinel, n, real_fns[n])
        c1 = counters()
        b_counters = {k: c1[k] - c0[k] for k in names_c[3:]}
        assert b_counters == {"step_replays": 2,
                              "step_replay_mismatches": 1}, b_counters
        steps_run += b_calls + 2 * b_counters["step_replays"]
        b_identical = _res_equal(_res_state(eng), kept.pop(RES_B_END))
        assert b_identical, "run (b): the rewound run left the clean run"
        del eng
        gc.collect()

        # ---- (c) a fresh engine resumes from the preemption tag
        fresh = engine()
        resume_ms = []
        path, _ = _res_timed(resume_ms, fresh.load_checkpoint)(str(ck_c))
        assert Path(path).name == f"global_step{RES_C_TRIGGER}", path
        resumed = [float(fresh.train_batch()) for _ in range(RES_C_AFTER)]
        steps_run += RES_C_AFTER
        assert resumed == clean_losses[RES_C_TRIGGER:RES_C_TRIGGER
                                       + RES_C_AFTER], (resumed, clean_losses)
        c_identical = _res_equal(_res_state(fresh), kept.pop(
            RES_C_TRIGGER + RES_C_AFTER))
        assert c_identical, "run (c): the resumed run left the clean run"
        del fresh
        launches = read_counts()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    for name, n in launches.items():
        want_n = RES_LAYERS * gas * steps_run if name in FLASH else 0
        assert n == want_n, (name, n, want_n)
    n_probes = len(probe_ms["probe"])
    info = {"phase": "train_774m_resilience", "card": smi,
            "model": f"gpt2_774m width, {RES_LAYERS} of its 36 layers, bf16 "
                     "(masters and moments f32), attn flash, micro-batch 8 x "
                     "gas 2 x T 1024, data through initialize(training_data)",
            "a_rewind_log": log, "a_counters": a_counters,
            "a_losses": a_losses, "a_clean_losses": clean_losses,
            "a_bit_identical_to_clean": a_identical,
            "b_rewind_log": b_log, "b_counters": b_counters,
            "b_clean_probes_ok": True, "b_bit_identical_to_clean":
                b_identical,
            "probe_split_ms": {
                "probe": sum(probe_ms["probe"]) / n_probes,
                "clone": sum(probe_ms["clone"]) / n_probes,
                "digest": sum(probe_ms["digest"]) / n_probes,
                "step": (sum(probe_ms["probe"]) - sum(probe_ms["clone"])
                         - sum(probe_ms["digest"])) / n_probes},
            "c_exit_code": codes[0], "c_losses_resumed": resumed,
            "c_bit_identical_to_clean": c_identical,
            "armed_ms_per_step": armed_ms, "unarmed_ms_per_step": unarmed_ms,
            "armed_over_unarmed": armed_ms / unarmed_ms,
            "save_ms": save_ms, "load_ms": load_ms,
            "recovery_ms": [r["recovery_ms"] for r in log + b_log],
            "preempt_save_ms": c_save_ms[0], "resume_load_ms": resume_ms[0],
            "train_steps_run": steps_run, "launches": launches,
            "phase_s": time.perf_counter() - t_phase}
    emit(info)
    return info


# telemetry artefacts (JSONL streams, flight dumps) of the telemetry phases
# ZeRO-Offload at LLaMA-7B width: the config of train_tinyllama's runs (bench
# 774M's: bf16, AdamW lr 1e-4 wd 0.01, clipping 1.0, bf16 grad accumulation)
# at micro-batch 1 x gas 2 x T 2048, with the zero section of each run
OFFLOAD_GAS, OFFLOAD_MICRO, OFFLOAD_T = 2, 1, 2048
OFFLOAD_RUNS = (("device", {"stage": 0}),
                ("cpu", {"stage": 2, "offload_optimizer": {"device": "cpu"}}),
                ("nvme", {"stage": 3, "offload_optimizer": {"device": "nvme"}}))
OFFLOAD_PARITY_LAYERS = 1
OFFLOAD_PARITY_STEPS = 2
# (b)'s depth: 24 of LLaMA-7B's 32 layers (the host Adam's sweep and the
# card's images scale with it; 32 read 14.5-18.6 s a step, PRs 17-20)
OFFLOAD_LAYERS = 24
OFFLOAD_WARM, OFFLOAD_STEPS = 1, 1
# losses and grad norms of step 2, host (cpu) against device-state Adam,
# relative: the same f32 update in another order (the host kernel may fuse
# a multiply-add and scales the grad inside its sweep), so the bf16 images
# after step 1 may differ by an ulp here and there
OFFLOAD_LOSS_TOL = 1e-3
# ... and the images after step 2, row by row (kernel_check.rel_err): about
# one bf16 ulp (2^-8 relative at most) where the two f32 masters round
# apart, with room for three steps of it
OFFLOAD_IMAGE_TOL = 1e-2
# the host memory the depth rule keeps free beside the f32 state: the
# pinned staging ring, the process's growth while it trains, the page cache
# the IO engine's files need
OFFLOAD_HOST_MARGIN = 8e9
NVME_DIR = Path(__file__).resolve().parent / "build" / "nvme_swap"


def _llama_7b(layers: int) -> LlamaConfig:
    """LLaMA-7B's published widths at ``layers`` of its 32 layers."""
    return dataclasses.replace(LlamaConfig.llama_7b(), num_layers=layers)


def _llama_params(cfg) -> int:
    from deepspeed_tpu_torch.models.llama import _block_matmuls

    per_layer = sum(din * dout for _, din, dout, _ in _block_matmuls(cfg)) \
        + 2 * cfg.hidden_size
    return cfg.num_layers * per_layer + 2 * cfg.vocab_size * cfg.hidden_size \
        + cfg.hidden_size


def _meminfo(key: str) -> int:
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith(key + ":"):
            return int(line.split()[1]) * 1024
    raise KeyError(key)


def _proc_status(key: str) -> int:
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith(key + ":"):
            return int(line.split()[1]) * 1024
    raise KeyError(key)


def _offload_config(zero: dict) -> dict:
    return {**BENCH_774M_CONFIG,
            "train_batch_size": OFFLOAD_MICRO * OFFLOAD_GAS,
            "zero_optimization": json.loads(json.dumps(zero))}


def _images(eng) -> dict:
    """The compute-dtype weights the next forward reads, on the host."""
    return {n: p.detach().to(torch.bfloat16).cpu()
            for n, p in param_names(eng.state.params).items()}


def _offload_parity(params, batches, cfg, dev: str) -> dict:
    """(a): the same init and batches through the device-state engine (ZeRO
    0), offload_optimizer cpu (stage 2) and nvme (stage 3)."""
    out, images, launches = {}, {}, dict.fromkeys(WRAPPERS, 0)
    for name, zero in OFFLOAD_RUNS:
        zero = json.loads(json.dumps(zero))
        if name == "nvme":
            shutil.rmtree(NVME_DIR, ignore_errors=True)
            zero["offload_optimizer"]["nvme_path"] = str(NVME_DIR)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=LlamaModel(cfg, attn_impl="flash"), config=_offload_config(zero),
            params=params, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        reset_counts()                   # the main path starts here
        rows, host = [], []
        t0 = time.perf_counter()
        for b in batches:
            loss = float(eng.train_batch_from_stacked(b))
            rows.append((loss, eng.get_global_grad_norm()))
            if eng._host_opt is not None:
                host.append(dict(eng._host_opt.stats))
        wall = time.perf_counter() - t0
        got = read_counts()
        for k, n in got.items():
            want = cfg.num_layers * OFFLOAD_GAS * len(batches) if k in FLASH else 0
            assert n == want, (name, k, n, want)
            launches[k] += n
        images[name] = _images(eng)
        out[name] = {"zero": zero, "losses": [r[0] for r in rows],
                     "grad_norms": [r[1] for r in rows], "init_s": init_s,
                     "ms_per_step": 1e3 * wall / len(batches)}
        if host:
            out[name]["host_step"] = host
            out[name]["omp_threads"] = eng._host_opt.num_threads
        if name == "nvme":
            st = host[-1]
            out[name]["nvme"] = {
                "read_bytes_per_step": st["nvme_read_bytes"],
                "write_bytes_per_step": st["nvme_write_bytes"],
                "gb_per_s_over_host_step": (st["nvme_read_bytes"]
                                            + st["nvme_write_bytes"])
                / st["step_s"] / 1e9,
                "folder": str(NVME_DIR)}
        eng.destroy()
        del eng
    shutil.rmtree(NVME_DIR, ignore_errors=True)
    dev, cpu, nvme = out["device"], out["cpu"], out["nvme"]
    assert dev["losses"][0] == cpu["losses"][0] == nvme["losses"][0], out
    loss_rel = max(abs(c - d) / abs(d) for c, d in
                   zip(cpu["losses"][1:], dev["losses"][1:]))
    norm_rel = max(abs(c - d) / abs(d) for c, d in
                   zip(cpu["grad_norms"][1:], dev["grad_norms"][1:]))
    image_err = max(rel_err(images["cpu"][n], images["device"][n])
                    for n in images["device"])
    assert loss_rel <= OFFLOAD_LOSS_TOL and norm_rel <= OFFLOAD_LOSS_TOL, out
    assert image_err <= OFFLOAD_IMAGE_TOL, (image_err, out)
    assert nvme["losses"] == cpu["losses"] and \
        nvme["grad_norms"] == cpu["grad_norms"], out
    for n, img in images["cpu"].items():
        assert torch.equal(img, images["nvme"][n]), n
    out.update(cpu_vs_device={"loss_max_rel": loss_rel, "grad_norm_max_rel": norm_rel,
                              "image_rel_err": image_err,
                              "loss_tol": OFFLOAD_LOSS_TOL,
                              "image_tol": OFFLOAD_IMAGE_TOL},
               nvme_vs_cpu="bit-identical losses, grad norms and images",
               launches=launches)
    return out


def phase_train_llama7b_offload(smi: str, dev: str = "cuda") -> dict:
    """(a) LLaMA-7B width at OFFLOAD_PARITY_LAYERS layers, one seeded init
    and batches through three engines: device-state (ZeRO 0),
    offload_optimizer cpu (stage 2) and nvme (stage 3), 2 steps each. (b)
    LLaMA-7B's widths at OFFLOAD_LAYERS of its 32 layers, offload_optimizer
    cpu, remat "nothing", fewer layers only if the host cannot hold their
    f32 state: one warm-up and one measured step on a fixed batch."""
    from deepspeed_tpu_torch.ops.native.builder import compiler

    gc.collect()
    torch.cuda.empty_cache()
    NVME_DIR.parent.mkdir(parents=True, exist_ok=True)
    host = {"nproc": len(os.sched_getaffinity(0)),
            "mem_total_bytes": _meminfo("MemTotal"),
            "mem_available_bytes_at_start": _meminfo("MemAvailable"),
            "nvme_dir_df": shutil.disk_usage(NVME_DIR.parent)._asdict()}
    t0 = time.perf_counter()
    adam = get_op_builder("cpu_adam_native")()
    flags = adam.build_flags()
    adam.load().load()
    get_op_builder("async_io")().load().load()
    build_s = time.perf_counter() - t0
    # (a) parity at 7B width, OFFLOAD_PARITY_LAYERS layers
    cfg = _llama_7b(OFFLOAD_PARITY_LAYERS)
    params = LlamaModel(cfg).init(torch.Generator(device=dev).manual_seed(7),
                                  device=dev, dtype=torch.float32)
    batches = lm_batches(np.random.RandomState(3), OFFLOAD_PARITY_STEPS,
                         OFFLOAD_GAS, OFFLOAD_MICRO, OFFLOAD_T, cfg.vocab_size,
                         start_span=1000)
    parity = _offload_parity(params, batches, cfg, dev)
    del params
    # (b) LLaMA-7B's widths at OFFLOAD_LAYERS, fewer if the host's memory
    # forbids
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    avail = _meminfo("MemAvailable")
    layers = OFFLOAD_LAYERS
    while layers > 1 and 12 * _llama_params(_llama_7b(layers)) \
            + OFFLOAD_HOST_MARGIN > avail:
        layers -= 1
    cfg = _llama_7b(layers)
    n_params = _llama_params(cfg)
    zero = {"stage": 2, "offload_optimizer": {"device": "cpu"}}
    # what earlier phases left allocated (cached tables, rope caches)
    card_base = torch.cuda.memory_stats()["allocated_bytes.all.current"]
    t0 = time.perf_counter()
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=LlamaModel(cfg, attn_impl="flash", remat=True,
                         remat_policy="nothing"),
        config={**_offload_config(zero), "wall_clock_breakdown": True},
        device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rss_after_init = _proc_status("VmRSS")
    # no f32 master or moment on the card: the engine adds only the bf16
    # images (2 bytes a parameter) to what was allocated before it
    card_after_init = torch.cuda.memory_stats()["allocated_bytes.all.current"] \
        - card_base
    assert all(p.dtype == torch.bfloat16
               for p in param_names(eng.state.params).values())
    assert card_after_init <= 2 * n_params + 2 ** 30, (card_after_init, n_params)
    assert eng._host_opt.staging is None or eng._host_opt.staging.pinned()
    batch = lm_batches(np.random.RandomState(4), 1, OFFLOAD_GAS, OFFLOAD_MICRO,
                       OFFLOAD_T, cfg.vocab_size, start_span=1000)[0]
    losses = [float(eng.train_batch_from_stacked(batch))
              for _ in range(OFFLOAD_WARM)]
    staging = eng._host_opt.staging     # made at the first step on the card
    assert dev != "cuda" or staging.pinned()
    torch.cuda.synchronize()
    names = (FORWARD_GLOBAL_TIMER, BACKWARD_GLOBAL_TIMER, STEP_GLOBAL_TIMER,
             TRAIN_BATCH_TIMER)
    for n in names:
        eng.timers(n).elapsed(reset=True)
    reset_counts()                       # the main path starts here
    steps, stats = [], []
    for _ in range(OFFLOAD_STEPS):
        t0 = time.perf_counter()
        losses.append(float(eng.train_batch_from_stacked(batch)))
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
        stats.append(dict(eng._host_opt.stats))
    launches = read_counts()
    timers = {n: 1e3 * eng.timers(n).elapsed(reset=True) / OFFLOAD_STEPS
              for n in names}
    peak_card = torch.cuda.max_memory_allocated()
    card_between = torch.cuda.memory_stats()["allocated_bytes.all.current"] \
        - card_base
    assert card_between <= 2 * n_params + 2 ** 30, (card_between, n_params)
    assert peak_card < 80e9, peak_card
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], losses
    for k, n in launches.items():
        want = {"flash_fwd": 2 * layers * OFFLOAD_GAS,
                "flash_bwd_dq": layers * OFFLOAD_GAS,
                "flash_bwd_dkv": layers * OFFLOAD_GAS}.get(k, 0) * OFFLOAD_STEPS
        assert n == want, (k, n, want)
    step_s = sum(steps) / OFFLOAD_STEPS
    tokens = OFFLOAD_GAS * OFFLOAD_MICRO * OFFLOAD_T
    flops_tok = eng.module.flops_per_token(OFFLOAD_T)

    def mean(key):
        return sum(s[key] for s in stats) / len(stats)

    full = {
        "model": f"LLaMA-7B (hidden 4096, intermediate 11008, 32 heads, "
                 f"vocab 32000) at {layers} of 32 layers, random init seed "
                 f"1234, attn flash, remat \"nothing\"",
        "layers": layers, "n_params": n_params,
        "depth_rule": {"mem_available_bytes": avail,
                       "state_bytes": 12 * n_params,
                       "margin_bytes": OFFLOAD_HOST_MARGIN,
                       "cut": layers < OFFLOAD_LAYERS},
        "zero": zero, "init_s": init_s, "losses": losses,
        "ms_per_step": 1e3 * step_s, "tokens_per_s": tokens / step_s,
        "mfu": tokens / step_s * flops_tok / BF16_FLOP_PER_S,
        "flop_per_token": flops_tok,
        "split_ms": {"forward": timers[FORWARD_GLOBAL_TIMER],
                     "backward": timers[BACKWARD_GLOBAL_TIMER],
                     "step_timer": timers[STEP_GLOBAL_TIMER],
                     "host_step": 1e3 * mean("step_s"),
                     "grad_download_wait": 1e3 * mean("download_wait_s"),
                     "host_adam": 1e3 * mean("adam_s"),
                     "image_upload_wait": 1e3 * mean("upload_wait_s")},
        "host_adam_gb_per_s": mean("bytes_swept") / mean("adam_s") / 1e9,
        "host_adam_bytes_swept": mean("bytes_swept"),
        "omp_threads": eng._host_opt.num_threads,
        "staging": staging and {"slots": len(staging.grad),
                                "chunk_elements": staging.chunk,
                                "pinned": staging.pinned()},
        "peak_card_bytes": peak_card, "card_bytes_before_init": card_base,
        "card_bytes_after_init": card_after_init,
        "card_bytes_between_steps": card_between,
        "host_rss_after_init_bytes": rss_after_init,
        # the process's peak, from getrusage (kB on Linux)
        "host_rss_peak_bytes": 1024 * resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss,
        "launches": launches}
    eng.destroy()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # the phase's launches: (a)'s three runs and (b)'s measured steps
    total = {k: n + parity["launches"][k] for k, n in launches.items()}
    info = {"phase": "train_llama7b_offload", "card": smi, "host": host,
            "native_build": {"cpu_adam_native_flags": flags,
                             "compiler": compiler(), "build_s": build_s},
            "config": _offload_config({}), "micro_batch": OFFLOAD_MICRO,
            "gas": OFFLOAD_GAS, "seq_len": OFFLOAD_T,
            "parity_7b_width": {"layers": OFFLOAD_PARITY_LAYERS, **parity},
            "llama_7b": full, "launches": total}
    emit(info)
    return info


TELEMETRY_DIR = Path(__file__).resolve().parent / "build" / "telemetry"


def _fresh_dir(name: str) -> Path:
    d = TELEMETRY_DIR / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


def phase_train_774m_telemetry(smi: str, bare: dict) -> dict:
    """train_774m again, on a second engine (after the first is freed) with
    the same config, seed and batches plus ``telemetry`` (a JSONL sink,
    ``sync_interval`` 4, spans, the flight recorder) and
    ``wall_clock_breakdown``: 2 warm-up and 8 measured steps, fences at
    steps 1, 4 and 8. Held: every flash kernel launches 36 x 2 x 8 times in
    the measured steps; the losses are finite, fall, and equal the bare
    run's within 1e-3 relative; ``train/tokens_per_sec`` (the fence window
    of steps 5-8) within 5% of the bare run's tokens/s and ``train/mfu`` x
    989 within 5% of its achieved TFLOP/s; step-window spans recorded.
    Reported: armed over bare ms per step (the reference's budget is 2%);
    then 2 more steps read through the wall-clock timers (CUDA events):
    forward, backward, optimizer step and the whole batch, ms per step."""
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = _fresh_dir("train_774m")
    reset_registry()
    cfg = GPT2Config.gpt2_774m()
    gas, micro, t, warm, steps = 2, 8, 1024, 2, 8
    config = dict(BENCH_774M_CONFIG, wall_clock_breakdown=True,
                  telemetry={"jsonl_path": str(out_dir / "train.jsonl"),
                             "sync_interval": 4, "spans": True,
                             "flight_recorder": True,
                             "flight_dir": str(out_dir)})
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=GPT2Model(cfg, attn_impl="flash"), config=config)
    batches = lm_batches(np.random.RandomState(0), warm + steps + 1, gas,
                         micro, t, cfg.vocab_size, start_span=1000)
    losses = [eng.train_batch_from_stacked(b) for b in batches[:warm]]
    torch.cuda.synchronize()
    reset_counts()                       # the main path starts here
    t0 = time.perf_counter()
    for b in batches[warm:warm + steps]:
        losses.append(eng.train_batch_from_stacked(b))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    losses = [float(x) for x in losses]
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], losses
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, bare["losses"]))
    assert loss_rel <= 1e-3, (losses, bare["losses"])
    for name, n in launches.items():
        want = cfg.num_layers * gas * steps if name in FLASH else 0
        assert n == want, (name, n, want)
    gauges = get_registry().snapshot()["gauges"]
    tps, mfu = gauges["train/tokens_per_sec"], gauges["train/mfu"]
    peak = BF16_FLOP_PER_S / 1e12
    assert abs(tps / bare["tokens_per_s"] - 1) <= 0.05, (tps, bare)
    assert abs(mfu * peak / bare["achieved_tflops"] - 1) <= 0.05, (mfu, bare)
    spans = eng.tracer.spans_for(eng._train_trace)
    assert [(s.attrs["end_step"], s.attrs["steps"]) for s in spans] == \
        [(4, 3), (8, 4)], spans
    attribution = eng.train_step_attribution()["train_step"]
    # the wall-clock breakdown: 2 more steps, read through the timers
    names = (FORWARD_GLOBAL_TIMER, BACKWARD_GLOBAL_TIMER, STEP_GLOBAL_TIMER,
             TRAIN_BATCH_TIMER)
    for name in names:
        eng.timers(name).elapsed(reset=True)
    for b in batches[warm + steps - 1:warm + steps + 1]:
        eng.train_batch_from_stacked(b)
    split = {name: 1e3 * eng.timers(name).elapsed(reset=False) / 2
             for name in names}
    eng.destroy()
    ms = 1e3 * wall / steps
    info = {"phase": "train_774m_telemetry", "card": smi,
            "config": config, "losses": losses,
            "loss_max_rel_diff_vs_bare": loss_rel, "launches": launches,
            "ms_per_step": ms, "bare_ms_per_step": bare["ms_per_step"],
            "armed_over_bare": ms / bare["ms_per_step"],
            "tokens_per_s": steps * gas * micro * t / wall,
            "gauges": gauges,
            "tokens_per_sec_over_bare": tps / bare["tokens_per_s"],
            "mfu_x_peak_over_bare_tflops":
                mfu * peak / bare["achieved_tflops"],
            "step_windows": [s.as_dict() for s in spans],
            "train_step_attribution": attribution,
            "wall_clock_breakdown_ms_per_step": split,
            "breakdown_parts_over_batch":
                sum(split[n] for n in names[:3]) / split[TRAIN_BATCH_TIMER]}
    emit(info)
    del eng
    reset_registry()
    gc.collect()
    torch.cuda.empty_cache()
    return info


# the control plane's SLOs on serve_preempt_chunked's virtual trace: a TTFT
# page rule the class-1 prompts (3-4 chunks of 512 each) make fire, and an
# availability SLI over finished requests and deadline sheds
TELEMETRY_SLO = {
    "slis": [{"name": "ttft", "kind": "latency", "metric": "serving/ttft_ms",
              "threshold_ms": 1000.0, "objective": 0.5},
             {"name": "availability", "kind": "availability",
              "good": "serving/finished_requests",
              "bad": ["serving/shed_deadline"], "objective": 0.99}],
    "rules": [{"sli": "ttft", "short_s": 0.5, "long_s": 2.0, "burn": 1.5,
               "min_events": 3, "severity": "page"},
              {"sli": "availability", "short_s": 1.0, "long_s": 4.0,
               "burn": 10.0, "min_events": 4, "severity": "page"}],
}
TENANT_OF_CLASS = {0: "interactive", 1: "batch"}


def _telemetry_run(eng, kw, reqs, out_dir: Path) -> tuple:
    """serve_preempt_chunked's trace (outputs cut to 24 tokens) under its
    virtual clock with the control plane armed: slo, tenants, a span tracer
    and a flight recorder, a registry of its own."""
    gc.collect()
    reg = MetricsRegistry()
    sink = JsonlSink(str(out_dir / "serve.jsonl"))
    rec = FlightRecorder(dump_dir=str(out_dir), registry=reg)
    reg.attach_sink(rec.tee(sink))
    slo = SLOEngine(TELEMETRY_SLO, registry=reg, eval_interval_s=0.0,
                    flight_recorder=rec)
    srv = ServingEngine(eng, telemetry=reg, slo=slo, tenants=True,
                        tracer=SpanTracer(sink=reg.sink),
                        time_fn=VirtualClock(0.01), **kw)
    armed = _copy_reqs(reqs, 24)
    for r in armed:
        r.tenant_id = TENANT_OF_CLASS[r.priority]
    srv.warmup()
    reset_counts()                       # the main path starts here
    results = srv.run(armed, warmup=False)
    launches = read_counts()
    return srv, {r.rid: r.tokens for r in results}, launches, sink


def phase_serve_telemetry(eng, smi: str) -> dict:
    """The serving control plane on phase 4's bf16 engine (LLaMA-7B), on
    serve_preempt_chunked's trace and virtual clock, block-paged over its
    int8 pool with the prefix cache (chunked prefill, swap preemption):
    ``slo=`` (:data:`TELEMETRY_SLO`), ``tenants=True`` with one tenant per
    class, a span tracer, a flight recorder. Held: the served tokens equal
    the same engine's run bare bit for bit; the tenants' decode tokens sum
    to the tokens served; two armed replays give the same alert timeline,
    with a page alert and a flight dump written at it; the block decode
    step launches 32 x decode steps; ``record_attribution()`` gives a row
    for every program of ``program_cache_sizes()``, and no row's
    ``achieved_vs_attainable`` exceeds 1.05. Reported: every program's
    row, the tenants' totals and the alert timeline."""
    t0 = time.perf_counter()
    kw = dict(PREEMPT_SERVE, **PREEMPT_BLOCK)
    reqs = _preempt_trace()
    bare = _virtual_tokens(eng, kw, reqs, eager=False)
    runs = []
    for i in range(2):
        out_dir = _fresh_dir(f"serve_{i}")
        srv, tokens, launches, sink = _telemetry_run(eng, kw, reqs, out_dir)
        assert tokens == bare, f"armed run {i}: tokens differ from bare"
        layers = eng.module.config.num_layers
        assert launches["fused_block_decode_step"] == \
            layers * srv.decode_steps, launches
        totals = srv.tenants.totals()
        assert sum(t["decode_tokens"] for t in totals.values()) == \
            sum(len(v) for v in tokens.values()) == srv.tokens_generated
        table = srv.record_attribution()
        assert set(table) == set(srv.program_cache_sizes()), table
        worst = max(r["achieved_vs_attainable"] or 0.0
                    for r in table.values())
        assert worst <= 1.05, table
        timeline = [(a.rule, a.kind, a.t) for a in srv.slo.alerts]
        dumps = list(srv.slo.flight_recorder.dumps)
        sink.close()
        runs.append({"timeline": timeline, "dumps": dumps, "table": table,
                     "totals": totals, "launches": launches,
                     "decode_steps": srv.decode_steps,
                     "preemptions": srv.preemptions,
                     "records": len(read_jsonl(str(out_dir / "serve.jsonl")))})
        del srv
    assert runs[0]["timeline"] == runs[1]["timeline"], runs
    assert any(k == "fired" and r.startswith("ttft:page")
               for r, k, _ in runs[0]["timeline"]), runs[0]["timeline"]
    dump = runs[0]["dumps"][0]
    assert dump["reason"] == "slo_page" and Path(dump["path"]).exists()
    info = {"phase": "serve_telemetry", "card": smi,
            "model": "llama_7b, phase 4's engine (bf16, random weights "
                     "seed 0)",
            "config": {**kw, "slo": TELEMETRY_SLO,
                       "tenants": TENANT_OF_CLASS},
            "tokens_equal_bare": True, "timeline": runs[0]["timeline"],
            "timeline_equal_on_replay": True, "flight_dumps": runs[0]["dumps"],
            "tenants": runs[0]["totals"], "attribution": runs[0]["table"],
            "max_achieved_vs_attainable": max(
                r["achieved_vs_attainable"] or 0.0
                for r in runs[0]["table"].values()),
            "decode_steps": runs[0]["decode_steps"],
            "preemptions": runs[0]["preemptions"],
            "jsonl_records": runs[0]["records"],
            "launches": {k: sum(r["launches"][k] for r in runs)
                         for k in WRAPPERS},
            "phase_wall_s": time.perf_counter() - t0}
    emit(info)
    return info


# ---------------------------------------------------------- serving fabric
# every replica: slot-paged, 8 slots, buckets up to max_len (a failed-over
# request re-prefills prompt + committed tokens: at most prompt + max_new)
FABRIC_SERVE = dict(num_slots=8, max_len=384, buckets=(128, 384))
FABRIC_TENANTS = (
    {"name": "chat", "kind": "bimodal", "n": 24, "rate": 60.0,
     "short_lens": (24, 48, 96), "long_lens": (200, 300), "long_frac": 0.25,
     "short_new": (32, 48), "long_new": (48, 64)},
    {"name": "bots", "kind": "bursty", "n": 16, "rate": 200.0,
     "burst_size": 8, "prompt_lens": (32, 64, 128), "max_new": (32, 64)},
    {"name": "batch", "kind": "bimodal", "n": 8, "rate": 20.0,
     "short_lens": (64,), "long_lens": (256,), "long_frac": 0.5,
     "short_new": (48,), "long_new": (64,)},
)
# r1 dies mid-trace; three flaky steps on r0 trip its breaker (threshold
# 3); r2 stalls the virtual clock past the per-attempt timeout
FABRIC_FAULTS = ({"kind": "crash", "replica": "r1", "at_step": 30},
                 {"kind": "flaky", "replica": "r0", "at_step": 12,
                  "count": 3},
                 {"kind": "straggle", "replica": "r2", "delay_s": 0.6,
                  "from_step": 20, "until_step": 20})
FABRIC_ROUTER = dict(max_dispatch_depth=8, request_timeout_s=0.5)
FABRIC_SCALER = dict(min_replicas=2, max_replicas=4,
                     scale_out_cooldown_s=0.3, scale_in_cooldown_s=1.5,
                     idle_stable_s=0.5)
FABRIC_MEM_SLACK = 1 << 30      # card bytes the dropped fabric may leave


def _fabric_trace(seed: int, vocab: int, streamed=None, tenants=None):
    """The seeded multi-tenant trace; with ``streamed`` (a dict) every
    request streams its tokens into ``streamed[rid]``."""
    reqs = synthetic_tenant_trace(seed, vocab,
                                  tenants=tenants or FABRIC_TENANTS)
    if streamed is not None:
        for r in reqs:
            streamed[r.rid] = []
            r.on_token = streamed[r.rid].append
    return reqs


class _FabricProbe:
    """``run_twin``'s replica hook: per replica built (initial, resurrected,
    scaled out), its warm-up wall (the prefill warm-ups and the decode
    step's first call), that first call's wall (the step run for real,
    then captured into the replica's own graph), its captures, each step's
    host wall and its decode steps, and every request it was sent
    (prompt, max_new), in order. It keeps numbers, not the replicas: a
    dropped fabric frees the card."""

    def __init__(self, sync):
        self.sync = sync
        self.replicas = []               # per replica: a dict of numbers
        self.sent = []                   # (rid, prompt, max_new) in order

    def __call__(self, rep) -> None:
        rec = {"name": rep.name, "warmup_ms": None, "capture_ms": None,
               "captures": 0, "step_ms": [], "decode_steps": 0}
        self.replicas.append(rec)
        srv, probe = rep.serving, self
        decode = srv._decode

        def capture(sig, args, _inner=decode._capture):
            probe.sync()
            t0 = time.perf_counter()
            out = _inner(sig, args)
            probe.sync()
            rec["capture_ms"] = 1e3 * (time.perf_counter() - t0)
            return out

        def warmup(_inner=srv.warmup):
            if srv._warm:
                return _inner()
            probe.sync()
            t0 = time.perf_counter()
            _inner()
            probe.sync()
            rec["warmup_ms"] = 1e3 * (time.perf_counter() - t0)
            rec["captures"] = srv._decode.captures

        def submit(request, _inner=rep.submit):
            _inner(request)
            probe.sent.append((request.rid, list(request.prompt),
                               request.max_new_tokens))

        def step(now, _inner=rep.step):
            t0 = time.perf_counter()
            try:
                return _inner(now)
            finally:
                rec["step_ms"].append(1e3 * (time.perf_counter() - t0))
                rec["decode_steps"] = rep.decode_steps

        decode._capture = capture
        srv.warmup, rep.submit, rep.step = warmup, submit, step


def _fabric_run(eng, seed: int, sync, **kw):
    """One twin run of the chaos scenario; returns the report, the
    streams and the probe."""
    streamed = {}
    reqs = _fabric_trace(seed, eng.module.config.vocab_size, streamed)
    probe = _FabricProbe(sync)
    rep = run_twin(eng, reqs, replica_hook=probe, **kw)
    return rep, streamed, reqs, probe


def _fabric_continuations(eng, reqs, probe, rep) -> dict:
    """Each resumed request's last attempt (the prompt it was last sent:
    its own + the tokens committed before) run on a fault-free engine: its
    served tokens are those committed tokens followed by that run's, bit
    for bit. Also reported: how many of them differ from the uninterrupted
    run of their original request (bf16: a resume re-prefills what that
    run decoded). Returns the counts."""
    orig = {r.rid: r for r in reqs}
    last = {}
    sends = {}
    for rid, prompt, max_new in probe.sent:
        last[rid] = (prompt, max_new)
        sends[rid] = sends.get(rid, 0) + 1
    # one fault-free run: each resumed request's last attempt and (rids
    # offset past the trace) its original request
    resumed_rids = [rid for rid in sorted(rep.tokens)
                    if len(last[rid][0]) > len(orig[rid].prompt)]
    assert resumed_rids, "no request resumed with committed tokens"
    off = len(orig)
    srv = ServingEngine(eng, telemetry=False, time_fn=VirtualClock(),
                        **FABRIC_SERVE)
    out = {r.rid: r.tokens for r in srv.run(
        [Request(rid, *last[rid]) for rid in resumed_rids]
        + [Request(off + rid, orig[rid].prompt, orig[rid].max_new_tokens)
           for rid in resumed_rids])}
    for rid in resumed_rids:
        committed = last[rid][0][len(orig[rid].prompt):]
        assert rep.tokens[rid] == committed + out[rid], (
            f"rid {rid}: served tokens differ from the fault-free run of "
            f"its last attempt ({len(committed)} committed)")
    whole = {rid: out[off + rid] for rid in resumed_rids}
    return {"requests_checked": len(resumed_rids),
            "redispatched": sum(n > 1 for n in sends.values()),
            "resumed_with_committed_tokens": len(resumed_rids),
            "resumed_differing_from_uninterrupted": sum(
                whole[rid] != rep.tokens[rid] for rid in resumed_rids),
            "sends": sum(sends.values())}


def phase_serve_fabric(eng, smi: str, sync=None) -> dict:
    """The serving fabric (serving/fabric/) on phase 4's bf16 engine
    (LLaMA-7B) through ``run_twin``: 3 slot-paged replicas
    (:data:`FABRIC_SERVE`) wrapping the one engine, the autoscaler armed
    (:data:`FABRIC_SCALER`), 48 seeded requests of 3 tenants on the twin's
    virtual clock, and :data:`FABRIC_FAULTS` (a crash, a breaker trip, a
    straggle the per-attempt timeout cuts). Held: every request served or
    shed and none failed; each stream equals its result's tokens; a second
    chaos run gives the same fingerprint; each resumed request's tokens
    equal its committed tokens followed by a fault-free engine's run of
    its last attempt (bf16: a resumed request re-prefills what the
    uninterrupted run decoded, so this is the exact form); no recompile;
    the decode kernel launched 32 x (decode steps + warm-up captures) over
    every replica built, dead, removed and added ones included; the card
    bytes allocated after the fabric is dropped at most
    :data:`FABRIC_MEM_SLACK` above those before. Reported: walls, each
    replica's warm-up (capture) ms, host ms per replica step, the report's
    counters and timelines."""
    sync = sync or torch.cuda.synchronize
    t0 = time.perf_counter()
    layers = eng.module.config.num_layers
    kw = dict(initial_replicas=3, serving_kw=FABRIC_SERVE,
              router_kw=FABRIC_ROUTER, autoscaler_kw=FABRIC_SCALER,
              faults=FABRIC_FAULTS)
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    runs = []
    for i in range(2):
        reset_counts()                   # the main path starts here
        t_run = time.perf_counter()
        rep, streamed, reqs, probe = _fabric_run(eng, 2020, sync, **kw)
        wall = time.perf_counter() - t_run
        launches = read_counts()
        gc.collect()                     # the fabric is dropped
        torch.cuda.empty_cache()
        after = torch.cuda.memory_allocated()
        assert rep.failed == 0 and rep.served + rep.shed == len(reqs), rep
        for rid, tokens in rep.tokens.items():
            assert streamed[rid] == tokens, f"rid {rid}: stream != tokens"
        assert rep.recompiles == 0, rep.recompiles
        steps = sum(r["decode_steps"] for r in probe.replicas)
        captures = sum(r["captures"] for r in probe.replicas)
        assert launches["fused_decode_step"] == layers * (steps + captures), \
            (launches, steps, captures)
        assert launches["fused_block_decode_step"] == 0, launches
        assert after <= before + FABRIC_MEM_SLACK, (before, after)
        runs.append({"report": rep, "probe": probe, "reqs": reqs,
                     "wall_s": wall, "launches": launches,
                     "decode_steps": steps, "captures": captures,
                     "card_bytes_after": after})
    a, b = runs
    assert a["report"].fingerprint() == b["report"].fingerprint()
    counters = a["report"].counters
    assert counters["replica_crashes"] >= 1 and counters["failovers"] >= 1
    assert counters["quarantines"] >= 1 and counters["timeouts"] >= 1
    t_cont = time.perf_counter()
    cont = _fabric_continuations(eng, a["reqs"], a["probe"], a["report"])
    cont_s = time.perf_counter() - t_cont
    step_ms = [ms for r in a["probe"].replicas for ms in r["step_ms"]]
    rep = a["report"]
    info = {"phase": "serve_fabric", "card": smi,
            "model": "llama_7b, phase 4's engine (bf16, random weights "
                     "seed 0)",
            "config": {**kw, "tenants": FABRIC_TENANTS, "seed": 2020},
            "requests": len(a["reqs"]), "served": rep.served,
            "shed": rep.shed, "failed": rep.failed,
            "per_tenant": rep.per_tenant, "counters": counters,
            "alert_timeline": rep.alert_timeline,
            "scale_timeline": rep.scale_timeline,
            "pool_sizes": rep.pool_sizes,
            "drain_durations_ms": rep.drain_durations_ms,
            "slo_attainment": rep.slo_attainment,
            "recompiles": rep.recompiles,
            "fingerprint": rep.fingerprint(),
            "fingerprint_equal_on_replay": True, "streams_equal_tokens": True,
            "continuations": cont, "continuations_s": cont_s,
            "replicas": [{"name": r["name"], "warmup_ms": r["warmup_ms"],
                          "capture_ms": r["capture_ms"],
                          "captures": r["captures"],
                          "steps": len(r["step_ms"]),
                          "decode_steps": r["decode_steps"]}
                         for r in a["probe"].replicas],
            "host_ms_per_replica_step": {
                "steps": len(step_ms), "p50": _pct(step_ms, 50),
                "p95": _pct(step_ms, 95),
                "mean": float(np.mean(step_ms))},
            "decode_steps": a["decode_steps"], "captures": a["captures"],
            "run_wall_s": [r["wall_s"] for r in runs],
            "card_bytes_before": before,
            "card_bytes_after": [r["card_bytes_after"] for r in runs],
            "launches": {k: sum(r["launches"][k] for r in runs)
                         for k in WRAPPERS},
            "phase_wall_s": time.perf_counter() - t0}
    emit(info)
    return info


def fabric_fp32_check(eng) -> dict:
    """On an fp32 engine: one twin run with a crash (2 replicas, no
    autoscaler) against a fault-free fixed pool of 2: the served tokens
    equal, every request served."""
    tenants = ({"name": "chat", "kind": "bimodal", "n": 16, "rate": 60.0,
                "short_lens": (24, 48), "long_lens": (200,),
                "long_frac": 0.25, "short_new": (32,), "long_new": (32,)},)
    vocab = eng.module.config.vocab_size
    kw = dict(initial_replicas=2, serving_kw=FABRIC_SERVE,
              router_kw=dict(max_dispatch_depth=8))
    t0 = time.perf_counter()
    rep = run_twin(eng, _fabric_trace(7, vocab, tenants=tenants),
                   faults=({"kind": "crash", "replica": "r1",
                            "at_step": 12},), **kw)
    oracle = run_twin(eng, _fabric_trace(7, vocab, tenants=tenants), **kw)
    assert rep.failed == 0 and rep.served == 16 == oracle.served, rep
    assert rep.counters["replica_crashes"] == 1
    assert rep.counters["failovers"] >= 1, rep.counters
    assert rep.tokens == oracle.tokens, "fp32 failover changed tokens"
    return {"served": rep.served, "failovers": rep.counters["failovers"],
            "replica_restarts": rep.counters["replica_restarts"],
            "tokens_equal_fault_free": True,
            "wall_s": time.perf_counter() - t0}


# ------------------------------------------------------- data efficiency
DE_WARM, DE_STEPS = 1, 3
DE_LTD_KEEP = 512                 # random-LTD: 512 of the 1024 tokens
# PLD: theta(t) = 0.5 + 0.5 e^-t, 0.684 after the warm-up step
DE_PLD = {"enabled": True, "theta": 0.5, "gamma": 1.0}
PLD_THETA_BELOW = 0.7
PLD_SIGMAS = 4.0                  # the keep count's bound: 4 binomial sigmas
# curriculum: 256 at the warm-up step, then 512, 768, 1024
DE_CURRICULUM = {"enabled": True, "schedule_type": "fixed_linear",
                 "schedule_config": {"min_difficulty": 256,
                                     "max_difficulty": 1024,
                                     "total_curriculum_step": 4,
                                     "difficulty_step": 256}}
# the profiler's 774M forward against the analytic count: both sums of the
# same integer products in f64
PROFILE_TOL = 1e-9


def _flash_work(b, h, dh, t, part) -> int:
    """A flash kernel's reported products (ops/kernel_flops.py) at one
    causal [B*H, T, Dh] call."""
    return 2 * {"fwd": 2, "dq": 3, "dkv": 4}[part] * b * h * dh \
        * attn_pairs(t, t, True)


def _de_run(run: str, extra: dict, batches, smi: str, bare: dict,
            before_step=None, per_step: bool = False) -> tuple:
    """One 774M engine with ``extra`` on the bench config: DE_WARM warm-up
    and DE_STEPS measured steps, the launch counters zeroed and a kernel
    FLOPs count open just before the measured steps. ``before_step(eng)``
    runs before each measured step; ``per_step`` synchronizes after each
    one and reports its ms. Returns (info, engine)."""
    from deepspeed_tpu_torch.ops.kernel_flops import kernel_flops_counter

    gc.collect()
    torch.cuda.empty_cache()
    cfg = GPT2Config.gpt2_774m()
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=GPT2Model(cfg, attn_impl="flash"),
        config={**BENCH_774M_CONFIG, **extra})
    losses = [eng.train_batch_from_stacked(b) for b in batches[:DE_WARM]]
    torch.cuda.synchronize()
    seqs, step_ms = [], []
    reset_counts()                       # the main path starts here
    with kernel_flops_counter() as kc:
        t0 = time.perf_counter()
        for b in batches[DE_WARM:DE_WARM + DE_STEPS]:
            t_step = time.perf_counter()
            if before_step is not None:
                before_step(eng)
            losses.append(eng.train_batch_from_stacked(b))
            seqs.append(eng.curriculum_scheduler.get_current_difficulty()
                        if eng.curriculum_scheduler is not None
                        else b["input_ids"].shape[-1])
            if per_step:
                torch.cuda.synchronize()
                step_ms.append(1e3 * (time.perf_counter() - t_step))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_counts()
    losses = [float(x) for x in losses]
    assert all(math.isfinite(x) for x in losses), (run, losses)
    gas, micro = BENCH_774M_CONFIG["gradient_accumulation_steps"], 8
    tokens = gas * micro * sum(seqs)
    ms = 1e3 * wall / DE_STEPS
    info = {"phase": "train_774m_data_efficiency", "run": run, "card": smi,
            "config": extra, "warmup_steps": DE_WARM,
            "measured_steps": DE_STEPS, "seq_lens": seqs, "losses": losses,
            "launches": launches,
            "flash_flops_reported": {k: v for k, v in kc.kernels.items()},
            "ms_per_step": ms, "tokens_per_s": tokens / wall,
            "train_774m_ms_per_step": bare["ms_per_step"],
            "train_774m_tokens_per_s": bare["tokens_per_s"],
            "ms_over_train_774m": ms / bare["ms_per_step"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if per_step:
        info["step_ms"] = step_ms
    return info, eng


def _profile_counts(dev_params, cpu_params, dev: str = "cuda") -> dict:
    """The FLOPs profiler at a small GPT-2 (2 layers, hidden 128, 2 heads of
    Dh 64, flash) on the card (kernels) and on the CPU (plain versions),
    one forward and one forward + backward each: the totals and the
    kernels' reports must be equal."""
    from deepspeed_tpu_torch.profiling import count_flops, get_model_profile

    cfg = GPT2Config(vocab_size=512, max_seq_len=128, num_layers=2,
                     hidden_size=128, num_heads=2)
    ids = np.random.RandomState(3).randint(0, 512, (2, 64))
    out = {}
    for where, params in (("card", dev_params), ("cpu", cpu_params)):
        on = dev if where == "card" else "cpu"
        model = GPT2Model(cfg, attn_impl="flash")
        batch = {"input_ids": torch.as_tensor(ids).long().to(on),
                 "labels": torch.as_tensor(ids).long().to(on)}
        fwd = get_model_profile(model, batch, params=params, as_string=False)
        leaves = _grad_leaves(params)
        step = count_flops(lambda: model.apply(leaves, batch)[0].backward())
        out[where] = {"forward_flops": fwd[0], "params": fwd[2],
                      "step_flops": step["flops"],
                      "step_kernel_flops": step["kernel_flops"]}
    assert out["card"] == out["cpu"], out
    return out


def _grad_leaves(params):
    """Fresh bf16 autograd leaves of a parameter dict."""
    return tree_map(lambda p: p.detach().to(torch.bfloat16).requires_grad_(),
                    params)


def phase_train_774m_data_efficiency(smi: str, bare: dict,
                                     dev: str = "cuda") -> dict:
    """GPT-2 774M (attn flash, bench config) through initialize() in three
    runs of DE_WARM + DE_STEPS steps: (a) random-LTD keeping 512 of 1024
    tokens, (b) progressive layer drop (theta 0.5, gamma 1: theta below
    0.7 from the first measured step), (c) the fixed_linear curriculum
    256 -> 1024 (four lengths) with the csv and JSONL monitors; then the
    FLOPs profiler: the 774M forward against the analytic count, and a
    small GPT-2's count on the card against the CPU's."""
    t_phase = time.perf_counter()
    cfg = GPT2Config.gpt2_774m()
    gas, micro, t = BENCH_774M_CONFIG["gradient_accumulation_steps"], 8, 1024
    h, dh, layers = cfg.num_heads, cfg.head_dim, cfg.num_layers
    batches = lm_batches(np.random.RandomState(0), DE_WARM + DE_STEPS, gas,
                         micro, t, cfg.vocab_size, start_span=1000)
    runs = {}

    # (a) random-LTD: layers 0 and 35 at T 1024, the 34 between at T 512
    ltd = {"data_efficiency": {"data_routing": {"random_ltd": {
        "enabled": True, "random_ltd_schedule": {
            "min_value": DE_LTD_KEEP, "max_value": DE_LTD_KEEP}}}}}
    info, eng = _de_run("a_random_ltd", ltd, batches, smi, bare)
    n_micro = gas * DE_STEPS
    for name, part in zip(FLASH, ("fwd", "dq", "dkv")):
        assert info["launches"][name] == layers * n_micro, (name, info)
        # the launches' reported work pins how many ran at each length:
        # 2 at T 1024 and 34 at T 512 per micro-batch
        want = n_micro * (2 * _flash_work(micro, h, dh, t, part)
                          + (layers - 2) * _flash_work(micro, h, dh,
                                                       DE_LTD_KEEP, part))
        got = info["flash_flops_reported"]["flash_" + {
            "fwd": "fwd_parts", "dq": "bwd_dq", "dkv": "bwd_dkv"}[part]]
        assert got == want, (name, got, want)
    info["flash_launches_at_t512_per_micro_batch_forward"] = layers - 2
    info["flash_launches_at_t1024_per_micro_batch_forward"] = 2
    # where the step's time goes (after the counted steps)
    info["profile_one_step"] = profile_train_step(eng, batches[-1])
    runs["a"] = info
    emit(info)
    del eng

    # (b) progressive layer drop: every block computed, gated
    import deepspeed_tpu_torch.models.gpt2 as gpt2_module
    from deepspeed_tpu_torch.runtime.progressive_layer_drop import layer_keep_probs

    draws, thetas = [], []
    orig_keep = gpt2_module._pld_keep

    def record(p, gen, device):
        k = orig_keep(p, gen, device)
        draws.append((p, k))
        return k

    def note_theta(eng):
        thetas.append(eng.progressive_layer_drop.get_theta())
        if len(thetas) == 1:
            gpt2_module._pld_keep = record

    try:
        info, eng = _de_run("b_pld", {"progressive_layer_drop": DE_PLD},
                            batches, smi, bare, before_step=note_theta)
    finally:
        gpt2_module._pld_keep = orig_keep
    assert all(th < PLD_THETA_BELOW for th in thetas), thetas
    assert len(draws) == layers * n_micro, len(draws)
    for name in FLASH:
        assert info["launches"][name] == layers * n_micro, (name, info)
    probs = np.concatenate([np.tile(layer_keep_probs(layers, th), gas)
                            for th in thetas])
    drawn = np.array([p for p, _ in draws])
    assert np.abs(drawn - probs).max() <= 1e-6, "p_keep off the schedule"
    kept = int(sum(int(k) for _, k in draws))
    mean, sd = float(probs.sum()), float(np.sqrt((probs * (1 - probs)).sum()))
    assert abs(kept - mean) <= PLD_SIGMAS * sd, (kept, mean, sd)
    info.update(thetas=thetas, blocks_drawn=len(draws), blocks_kept=kept,
                expected_kept=mean, binomial_sd=sd, bound_sigmas=PLD_SIGMAS,
                kept_share=kept / len(draws), expected_share=mean / len(draws))
    runs["b"] = info
    emit(info)
    del eng

    # (c) curriculum, the monitors on, then the profiler
    out_dir = _fresh_dir("data_efficiency")
    cur = {"curriculum_learning": DE_CURRICULUM, "monitor_interval": 1,
           "csv_monitor": {"enabled": True, "output_path": str(out_dir),
                           "job_name": "c"},
           "jsonl_monitor": {"enabled": True, "output_path": str(out_dir),
                             "job_name": "c"}}
    info, eng = _de_run("c_curriculum", cur, batches, smi, bare,
                        per_step=True)
    assert info["seq_lens"] == [512, 768, 1024], info["seq_lens"]
    for name, part in zip(FLASH, ("fwd", "dq", "dkv")):
        assert info["launches"][name] == layers * n_micro, (name, info)
    csv = (out_dir / "c" / "Train_Samples_train_loss.csv").read_text().split()
    assert csv[0] == "step,value" and len(csv) == 1 + DE_WARM + DE_STEPS, csv
    assert [float(r.split(",")[1]) for r in csv[1:]] == info["losses"], csv
    recs = [r for r in read_jsonl(str(out_dir / "c.jsonl"))
            if r["tag"] == "Train/Samples/train_loss"]
    assert [r["value"] for r in recs] == info["losses"], recs
    assert [r["step"] for r in recs] == list(range(1, 1 + DE_WARM + DE_STEPS))
    from deepspeed_tpu_torch.profiling import get_model_profile

    first = {k: torch.as_tensor(v[0]).long().to(eng.device)
             for k, v in batches[0].items()}
    cp = eng._cast_for_compute(eng.state.params)
    counted, _, n_params = get_model_profile(
        GPT2Model(cfg, attn_impl="flash"), first, params=cp, as_string=False)
    del cp
    hid, m = cfg.hidden_size, cfg.mlp_dim
    analytic = (2 * micro * t * (layers * (4 * hid * hid + 2 * hid * m)
                                 + cfg.vocab_size * hid)
                + layers * _flash_work(micro, h, dh, t, "fwd"))
    assert abs(counted - analytic) <= PROFILE_TOL * analytic, \
        (counted, analytic)
    small_cpu = GPT2Model(GPT2Config(vocab_size=512, max_seq_len=128,
                                     num_layers=2, hidden_size=128,
                                     num_heads=2)).init(
        torch.Generator().manual_seed(4))
    small = _profile_counts(tree_map(lambda x: x.to(dev), small_cpu),
                            small_cpu, dev)
    info.update(monitor_lines=len(csv) - 1, profile_774m_forward_flops=counted,
                profile_774m_analytic_flops=analytic,
                profile_774m_params=n_params, profile_tol=PROFILE_TOL,
                profile_small_card_equals_cpu=small)
    runs["c"] = info
    emit(info)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in WRAPPERS}
    summary = {"phase": "train_774m_data_efficiency", "card": smi,
               "ms_per_step": {k: r["ms_per_step"] for k, r in runs.items()},
               "tokens_per_s": {k: r["tokens_per_s"] for k, r in runs.items()},
               "train_774m_ms_per_step": bare["ms_per_step"],
               "launches": launches,
               "phase_s": time.perf_counter() - t_phase}
    emit(summary)
    return summary


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    # fp32 matmuls in full fp32 on the card, as on the CPU (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = phase_device()
    kern = phase_kernels()
    sparse = phase_sparse_attention()
    phase_reference()
    phase_reference_generate()
    phase_reference_train()
    train = phase_train_774m(dev["nvidia_smi"])
    train_tel = phase_train_774m_telemetry(dev["nvidia_smi"], train)
    data_eff = phase_train_774m_data_efficiency(dev["nvidia_smi"], train)
    tiny = phase_train_tinyllama(dev["nvidia_smi"])
    ckpt = phase_checkpoint_roundtrip(dev["nvidia_smi"])
    resilience = phase_train_774m_resilience(dev["nvidia_smi"])
    offload = phase_train_llama7b_offload(dev["nvidia_smi"])
    launches = dict.fromkeys(WRAPPERS, 0)
    for k in FLASH:
        launches[k] = (train["launches"][k] + train_tel["launches"][k]
                       + data_eff["launches"][k] + tiny["launches"][k]
                       + resilience["launches"][k] + offload["launches"][k])
    for k in PRECISE:
        launches[k] = tiny["launches"][k]
    launches["fused_decode_step"] += ckpt["launches"]["fused_decode_step"]
    for k in SPARSE:
        launches[k] = sparse["launches"][k]
    for dtype in ("bf16", "int8"):
        info, eng = phase_serve(dtype, dev["nvidia_smi"])
        runs = [info]
        if dtype == "bf16":
            blk, bf16_tokens = phase_serve_block(eng, None, dev["nvidia_smi"])
            runs += [blk, phase_serve_block(eng, "int8", dev["nvidia_smi"],
                                            baseline=bf16_tokens)[0],
                     phase_serve_preempt_chunked(eng, dev["nvidia_smi"]),
                     phase_serve_telemetry(eng, dev["nvidia_smi"]),
                     phase_serve_fabric(eng, dev["nvidia_smi"]),
                     phase_serve_spec(eng, dev["nvidia_smi"],
                                      ("a_self_draft", "b_tinyllama_draft",
                                       "c_ngram_block_int8_pool",
                                       "c2_self_draft_block_int8_pool"))]
        else:
            runs.append(phase_serve_spec(eng, dev["nvidia_smi"],
                                         ("d_ngram_int8_weights",
                                          "d2_self_draft_int8_weights")))
        for run in runs:
            for k in launches:
                if k not in FLASH + PRECISE:
                    launches[k] += run["launches"][k]
        del eng
        gc.collect()                     # free this engine before the next
        torch.cuda.empty_cache()
    phase_probe_fp32(dev["nvidia_smi"])
    gpt2 = phase_generate_gpt2(dev["nvidia_smi"])
    big = phase_generate_34b(dev["nvidia_smi"])
    for run in (gpt2["launches"], big["b1"]["launches"],
                big["b4"]["launches"]):
        for k in ("fused_decode_step", "flash_decode", "flash_decode_mha"):
            launches[k] += run[k]
    emit({"phase": "run", "wall_s": time.perf_counter() - t_start})
    print(dev["nvidia_smi"], flush=True)
    emit({"kernels": kernel_summary(kern, launches, sparse)})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
