#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (horovod_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py [--seed 0] [--steps 10] [--warmup 2] [--batch 64]

(``--launched-worker gpt|fail|cpu_world|elastic|elastic_cpu|hier_cpu`` is
this script as a worker that the launch phases start through hvdrun-torch.)

Phases, one JSON line each (each with its seconds):

1. env: card, PyTorch, CUDA and nvcc versions. No CUDA device: exit 1.
2. build: compile every kernel source with nvcc (one process per source,
   all at once) into build/kernels/, timed; ptxas's registers and spills
   of the tensor-core flash kernels beside their dynamic shared memory.
   Checks: every instance reported, no spills at D = 64, and the dQ kernel
   with no spills and no stack at any head dim.
3. kernel_vs_plain: each scale kernel against its plain PyTorch version on
   the card, on the gradient shapes of the main paths (ResNet-50's, GPT-2
   small's up to its 38.6M-element token table and lm_head, BERT-Large's,
   LLaMA-400M's and ViT-B/16's, the last three from copies on the meta
   device) plus edge cases (0 and 1 element, odd sizes, a tensor longer
   than a grid row), in fp32, bf16 and fp16; and the rank-major tables of
   a grouped reducescatter over 4 and 8 ranks on ViT-B/16's gradients (the
   pack's row blocks, the unpack's (m/n, ...) outputs). Bit-equal,
   synchronising after every launch.
4. train: the main path. Launch counts are zeroed, then hvd.init() on
   cuda:0, ResNet-50 (bf16 activations, fp32 parameters, 1000 classes) on a
   fixed synthetic batch made from --seed, SGD(lr=0.1, momentum=0.9) in
   hvd.DistributedOptimizer, broadcast_parameters and
   broadcast_optimizer_state, warm-up and timed steps; the counts are read
   right after. Checks: finite, falling loss; at least 2 pack and 2 unpack
   launches a step; on one step the reduced gradients equal the local ones
   bit for bit (Average over 1 rank is x1.0). Reported: for each launch of
   the scale kernels, whether its rows (pointers and numels) were those of
   an earlier launch, that is, what a table kept on the card per signature
   would have hit (the wrapper passes its table by value instead).
5. timing: each kernel alone (back-to-back launches over prebuilt tables),
   its wrapper as the runtime calls it, its plain version and one PyTorch
   call for the same function, at the fp32 buckets the main path formed
   (CUDA events, median of 30), beside the least time the card could take.

6. flash_vs_plain: the three flash-attention kernels (forward, dQ, dK/dV)
   against their plain PyTorch versions on the card, synchronising after
   every launch: fp32, bf16 and fp16; causal and not; head dims 16, 32, 64
   and 128 at the ragged length 197; Lq < Lk and Lq > Lk (causal, with fully
   masked rows that must be exact zeros); kv_valid < Lk; GQA with 12 query
   heads over 4 kv heads; the GPT path's L = 1024, D = 64; in bf16 the
   BERT path's (BH = 512, L = 128, not causal), the LLaMA path's (128
   query rows over 64 kv rows, L = 1024, causal) and the ViT path's (BH =
   1536, L = 196, not causal: the last 64-key tile holds 4 keys), the
   composites' microbatches, and the GPT decodes' re-forwards (BH = 96 and
   384 at L = 128; speculative decoding's BH = 96 at L = 133, whose last
   64-key tile holds 5 keys). fp32, and lse
   in every dtype, within tolerance; the bf16/fp16 forward, dQ and dK/dV,
   which round P and dS on the tensor cores, within the rounding bound (c
   and u printed) of the plain versions that round where they do, and a
   plain version with the causal diagonal off by one (at BERT's and ViT's
   shapes: one that drops each row's last key; at ViT's by 10x or more)
   must fail that bound on every output.
   The max abs error and bound ratio of each case.
7. train_gpt: the second main path. Launch counts are zeroed, then GPT-2
   small at full width (vocab 50304, 12 layers, 12 heads, hidden 768, bf16
   activations, fp32 parameters, flash attention, untied fp32 lm_head) on
   8 x 1024 token ids made from --seed, next-token loss, AdamW(lr=1e-4,
   weight_decay=1e-4) in hvd.DistributedOptimizer after broadcast_parameters
   and broadcast_optimizer_state, --warmup and 8 timed steps; the counts are
   read right after. Checks: finite, falling loss; 12 forward, 12 dQ and 12
   dK/dV flash launches every step; one pack and one unpack launch for
   every fusion bucket of every step; on one step the reduced gradients
   equal the local ones bit for bit. Reported: the kept-table tally as in
   train. Then, outside the main path,
   gpt_flash_vs_plain: one step's loss and per-tensor gradients with flash
   attention against a copy of the model on plain attention (same weights,
   same batch), and two deliberately wrong controls (attention not causal;
   dK and dV swapped in the backward) that the same limits must reject.
   Both run their fp32 products (the lm_head) at DEFAULT precision, TF32,
   as the JAX model does on an H100; then
   precision: the lm_head's product at full shape (8192 x 768 -> 50304)
   through the port's Dense at DEFAULT, forward and both backward products,
   against float64 within the TF32 bound c 2^-11 |a| |b| (c printed), where
   a bf16 product must fail the forward's bound; the TF32 flags unchanged
   after; DEFAULT and "highest" timed in turns.
8. train_bert: the third path. BERT-Large (MLM + NSP; vocab 30522, 24
   layers, 16 heads, hidden 1024, bf16 activations, fp32 parameters and
   heads, flash, no padding mask, dropout off) on 32 x 128 token ids and
   MLM and NSP labels from --seed, AdamW(lr=1e-5) as in train_gpt; the
   same checks with 24 + 24 + 24 flash launches a step. Then
   bert_flash_vs_plain: one step's loss and per-tensor gradients with flash
   against a copy on bert.py's plain attention path, within
   BERT_CMP_LIMITS, which flash masked causally and dK and dV swapped must
   fail (and, unchecked, the kernels against their plain versions through
   the same step).
9. train_llama: the fourth path. LLaMA-400M (bench.py's config at 1024
   positions: 16 query heads over 8 kv heads, RoPE, RMSNorm, SwiGLU) on
   8 x 1024 token ids, next-token loss, AdamW(lr=1e-4); the same checks.
   Then remat on those weights and that batch: one step of a copy without
   and one with (48 forward launches, 24 dQ and 24 dK/dV; gradients equal
   bit for bit; a lower peak of allocated memory), and the same model and
   optimizer trained on with remat (48 + 24 + 24 launches a step); the
   GQA backward's repeat and fold timed alone, unchecked. Then
   llama_flash_vs_plain as for BERT, against plain attention with K/V
   repeated, within LLAMA_CMP_LIMITS; controls: flash not causal, dK and
   dV swapped.
10. train_vit: the fifth path. ViT-B/16 (bench.py's leg: hidden 768, 12
   layers, 12 heads, MLP 3072, patch 16, 1000 classes, 86,566,120
   parameters) on 128 bf16 images of 224 x 224 x 3 and labels from
   --seed, cross-entropy, AdamW(lr=1e-4); the same checks with 12 + 12 +
   12 flash launches a step (non-causal, L = 196). Then remat on the
   trained weights and batch: one step of a copy without and one with (24
   forward launches; gradients equal bit for bit; a lower peak); then the
   model timed on without and with remat: images/s as the median of 5
   repeats, the device's busy ms a step (torch.profiler) and the peak of
   allocated memory. Then vit_flash_vs_plain as for BERT, against plain
   attention, within VIT_CMP_LIMITS; controls: flash masked causally, dK
   and dV swapped.
11. collectives: at 1 rank over NCCL, on CUDA tensors in fp32 and bf16:
   ragged allgather (grouped and async too), alltoall with and without
   splits, grouped reducescatter Sum and Average with a prescale and a
   postscale (bit-equal to one rounding of x * prescale and of
   y * postscale / n; one pack and one unpack launch each),
   allgather_object, sparse_allreduce_async and join() (returns 0); every
   tensor output on the card.
12. timing_flash: each flash kernel alone at the GPT path's shapes
   (BH = 96, L = 1024, D = 64, bf16, causal), then at every other path's
   shape (BERT's, LLaMA's, ViT's, the composites' and the decodes'),
   its plain version and torch's scaled_dot_product_attention (forward, and
   backward alone; enable_gqa for LLaMA; for timing only, the port never
   calls it), CUDA events, median of repeats, beside the least time the
   card could take: achieved TFLOP/s and the share of that bound for
   each.

13. adasum_vs_plain: the Adasum combine kernels against their plain
   versions on the card, synchronising after every launch: ResNet-50's 161
   gradient shapes as one bucket of segments (each at its own scale) and
   edge cases (0 and 1 element, odd sizes, a segment past a round and past
   1024 streaming blocks, a zero a, b = a, 2a, -a, orthogonal a and b; the
   exact ones bit-exact in fp32), in fp32, bf16, fp16 and float64; then in
   each dtype a bucket that reaches both routes (a tensor one element past
   a round, so the streaming route, and tensors the schedule must keep
   within a round's steps), against the plain version in the level kernel's tile
   order and the one with whole sums; the max error of each case beside
   its tolerance.
14. train_adasum: the Adasum path. Launch counts are zeroed, then a fresh
   ResNet-50 as in train with hvd.DistributedOptimizer(SGD, op=hvd.Adasum):
   each bucket is packed, all-gathered and reduced by
   ops.adasum.reduce_gathered, then unpacked. Checks: finite, falling loss;
   one pack and one unpack launch per bucket every step; no combine launch
   (one rank is a tree of one leaf); on one step the reduced gradients
   equal the local ones bit for bit.
15. adasum_gathered: the combine kernel through reduce_gathered at the
   path's shapes: ResNet-50's gradients for K batches from --seed (what K
   ranks would hold), packed in train_adasum's bucket layout and stacked as
   the all-gather leaves them, for K = 4 and 3. Checks: within tolerance of
   the plain version; ceil(log2 K) launches per bucket, one per tree level,
   and none of the streaming route; a control with whole-bucket
   coefficients fails the same limit.
16. timing_adasum: one combine over the path's fp32 buckets (a tree level
   at K = 2): the level kernel alone, through the wrapper, the plain
   version, beside the byte bound and its share (no single PyTorch call
   computes it), with each bucket's steps, grid and shared memory.

17. wire_vs_cpu: the quantized wire's arithmetic on the card against the
   CPU: ``quantize_blocks`` (int8 and fp8), ``dequantize`` and the
   exchange's fused multiply-add, bit-equal, on blocks the size of the
   train phase's fp32 buckets (padded to whole blocks) with an all-zero
   block and a block whose maximum is its last element, and on a tail
   shorter than one block; then the scale kernels' mixed-dtype form
   (bf16/fp16 tensors into an fp32 buffer and back, fp32 tensors into a
   bf16/fp16 buffer and back, and a bucket mixing fp32 and bf16 tensors:
   one launch per dtype) on ResNet-50's gradient shapes, bit-equal to the
   plain versions, each pair timed (kernel alone, plain, library) beside
   its byte bound.
18. train_wire: the ResNet-50 of train (batch 64, SGD lr 0.1, momentum
   0.9, 64 MiB threshold, weights from --seed) in three fresh 1-rank
   worlds on the same weights and batch: exact, HOROVOD_WIRE_DTYPE=int8
   and fp8, error feedback on. Launch counts are read per step. Checks:
   a pack and an unpack launch per bucket; every bucket of n x BLOCK or
   more quantized (flush_stats against the buckets); in the first two
   steps, for every bucket, out = x + r_prev - r_new within fp32
   rounding; step 1 (deterministic cuDNN) packs the exact run's
   gradients and its averaged gradient is within the two-leg bound of
   them (int8 max/254 a leg, fp8 the JAX tests' |x|/16 + max/256 a leg);
   finite losses. Reported: images/s of each run, the exchange's device
   ms a step (CUDA events on the fusion stream) and the wire bytes a step
   by the JAX formulas (at one rank NCCL moves nothing: the ms are the
   quantize and dequantize work).
19. train_syncbn: the same ResNet-50 with every BatchNorm synchronized
   over the world (``sync_batch_norm=hvd.global_process_set``) against
   the plain one on the same weights and batch. Checks (SYNCBN_LIMITS):
   step 1's loss, parameter update (cosine) and running statistics; a
   forward and a backward collective per BatchNorm each step. Reported:
   images/s of both.
20. launch: the port's launcher on the card: ``python -m
   horovod_tpu_torch.runner -np 1 -H localhost:1 --cycle-time-ms 1`` on
   this script as ``--launched-worker gpt``, which loads the kernels the
   build phase built, calls hvd.init() (the card, NCCL) and trains GPT-2
   small as train_gpt does, with its checks; it prints its HOROVOD_* rank
   contract, its launches and buckets a step, the buckets its timer closed,
   its new signatures a step and its losses. Checks: exit code 0, the
   1-slot contract on cuda:0, every flash and both scale kernels launched,
   buckets closed by the timer, loss falling, reduced gradients bit-equal.
   The launch passes ``--timeline-filename``, ``--goodput --goodput-dir``,
   ``--run-history-dir`` and ``--flight-dir``: the worker's timeline opens
   with clock_sync and holds its allreduce spans, its goodput summary is
   conserved within 1%, it left one flight dump, and ``python -m
   horovod_tpu_torch.goodput`` reads the run as ended cleanly. It also
   passes ``--chaos-plan`` (LAUNCH_CHAOS_PLAN, JSON: one delay on step 3's
   first fusion flush; the worker advances the plan's step clock each
   step) and ``--chaos-ledger``: the worker's ledger holds that one line.
   Control: a worker that exits 1 (``--launched-worker fail``) makes the
   launcher return 1, and its process is gone.
21. launch_cpu_world: ``-np 2`` through the launcher with workers on the
   CPU (gloo; NCCL refuses two ranks on one card), each sleeping seeded
   times before CPU_WORLD_TENSORS async allreduces. Checks: each slot's
   contract, the same buckets on both ranks with some closed by rank 0's
   timer, the sums. A CPU run, printed as one.
22. cycle: GPT-2 small and ResNet-50, in this process, at HOROVOD_CYCLE_TIME
   0 and 1 ms: buckets, timer-closed buckets and new signatures a step,
   tokens/s or images/s (median of repeats), the device's busy ms and
   share (torch.profiler). Printed, not checked.
23. train_elastic: ResNet-50 as in train (deterministic cuDNN), first 8
   steps without a fault, then the elastic path: launch counts zeroed, 8
   steps under hvd.elastic.run with TorchState(model, optimizer, step)
   committed after each; at step 4, after the optimizer step and before
   the commit, the training function raises HorovodInternalError, as a
   failed collective does; the counts read after. Checks: after the
   restore every parameter, buffer and momentum equals the commit bit for
   bit, and the uncommitted state of step 4 does not (the control); one
   re-init, a new NCCL group on cuda:0 and the state on the card; pack and
   unpack launches in every step before and after the reset; finite,
   falling loss; the final weights equal the run without the fault bit for
   bit. Reported: commit ms a step (median), the reset's abort, restore,
   init and sync ms, seconds from the fault to the first step after it,
   images/s with and without a commit each step (medians of repeats in
   turns), the commit copy's size and the peak of allocated memory.
24. launch_elastic: ``python -m horovod_tpu_torch.runner -np 1 --min-np 1
   --max-np 1 --host-discovery-script build/elastic/launch/discover.sh``
   on this script as ``--launched-worker elastic``: the same loop and
   fault in a worker of the elastic driver. Checks: exit code 0, the
   1-slot contract, train_elastic's checks but the comparison with the
   run without the fault, the re-init at the unchanged version 1 (after
   the wait for a new version, cut from 30 s to ELASTIC_WAIT_S, printed),
   the worker reaped.
25. launch_elastic_cpu_world: tests/test_elastic_failure.py's three
   scenarios through the elastic launcher with CPU (gloo) workers
   (``--launched-worker elastic_cpu``; NCCL refuses two ranks on one
   card), at once: a worker killed at step 3 of 6 (w == [12] * 4, worlds
   [2, 2, 2, 1, 1, 1]), a graceful removal (the survivor's pid and
   uncommitted attribute kept), a host added (scaled up in place). A CPU
   run, printed as one.

Phases 26-29 run after train_syncbn.

26. train_gpt_chunked: GPT-2 small on train_gpt's weights and batch through
   the chunked next-token loss (``optim.next_token_xent_chunked``, chunk
   128, over ``features_only`` states and ``model.head``) against the
   full-logits loss: step 1's loss and every gradient within
   GPT_CHUNK_LIMITS, which the labels not shifted and the -100 mask
   dropped must fail; the largest tensor kept for the backward (the full
   path's (B, L - 1, V) log-softmax; the chunked path less than one
   chunk's logits); then each path trained with AdamW from the same
   weights (12 + 12 + 12 flash launches a step): the peak of allocated
   memory (the chunked one lower), tokens/s, device ms a step, and the
   head's ms on the whole batch (the recompute's work).
27. train_powersgd: the same model under
   ``hvd.DistributedOptimizer(AdamW, compression=hvd.Compression.powersgd(4))``
   against the exact optimizer, POWERSGD_STEPS steps each from the same
   weights. Checks: JAX's compress-or-not rule on the Flax shapes
   compresses every 2-D leaf and no 1-D one (51 of 149); on one more step,
   per compressed leaf, M̂ + e_new = M + e_prev within fp32 rounding,
   which the identity without e_prev fails; P and Q buckets every step;
   finite, falling losses. Reported: the bucket kinds a step, the bytes a
   step by ``powersgd_wire_numbers``, tokens/s, device ms and device
   launches a step against exact, the final losses' distance.
28. train_hierarchical: ResNet-50 as in train in a fresh 1-rank world per
   strategy knob (HOROVOD_TORUS_ALLREDUCE, HOROVOD_HIERARCHICAL_ALLREDUCE,
   HOROVOD_HIERARCHICAL_DISPATCH with HOROVOD_WIRE_DTYPE_DCN=int8): each
   bucket's strategy in flush_stats (torus_qcross must run flat on one
   slice), a pack and an unpack launch per bucket, the reduced gradients
   bit-equal to the local ones; the world is flat again after.
29. hier_cpu_world: ``-np 4 -H localhost:2,127.0.0.1:2`` through the
   launcher with CPU (gloo) workers and HOROVOD_MESH_SLICES=2, the 2 x 2
   layout: torus and hierarchical bit-equal to the sums each rank computes,
   torus_qcross (int8 cross leg) within the two-leg bound, the tier bytes
   equal to ``wire.hierarchical_wire_bytes``, the hierarchical allgather in
   rank-major order. The launch also passes HIER_CONTROL_FLAGS (the
   hierarchical control plane, two KV shards, the order check, telemetry
   every 0.5 s): fused buckets on the hierarchical boundary stream
   bit-equal to the same tensors on a flat one (a new runtime), the
   boundary roles root, leader, leader, member, the member's root gets 0,
   every order-check round hierarchical with 1 get a round on a member
   and 2 on a leader, and the job view naming four healthy ranks. A CPU
   run, printed as one.

Phases 30-32 run after train_powersgd: A12's first half, in-step
collectives over a DeviceMesh (``ops/in_step.py``).

30. train_gpt_tp_sp: GPT-2 small (train_gpt's weights and batch) built
   with ``tp_axis="tp"`` and ``sp_axis="sp"`` inside a (dp, sp, tp) =
   (1, 1, 1) NCCL mesh, once with the ring (one causal hop through the
   flash kernels, combined exactly) and once with Ulysses (all-to-alls of
   one rank): step 1's loss and every gradient bit-equal to the no-axis
   model's, then each trained through ``parallel/dp.py::make_train_step``
   (AdamW in hvd.DistributedOptimizer on the dp axis's process set, the
   gradients summed over sp), beside the same loop with no mesh: 12 + 12 +
   12 flash launches and a pack and an unpack per bucket every step,
   tokens/s and whether the losses stay equal.
31. ring_flash: the flash ring's schedule (``parallel/sequence.py``'s
   ``ring_flash_forward``/``ring_flash_backward``, which the ring over a
   process group runs) for 4 virtual ranks in one process over an
   8,192-token sequence (batch 2, head dim 64, bf16, causal) at GPT-2
   small's attention (12 heads) and LLaMA-400M's (16 query heads over 8
   narrow kv heads): the output and dQ/dK/dV against plain fp32
   full-sequence attention on the card within the flash rounding bound of
   one full-sequence call with c raised by one (by two under GQA), which
   two controls must fail: hop 1 left out of the combine (the output) and
   each hop's backward against its own lse (dQ, dK and dV); rank r runs
   r + 1 hops, 10 launches of each kernel per case; the summed ring
   against one full-sequence call (CUDA events).
32. train_zero_fsdp (lines train_zero and train_fsdp): GPT-2 small at one
   rank through ``make_zero_train_step`` (AdamW on the flat shard) and
   ``make_fsdp_train_step`` (every leaf of 16384 elements or more sharded
   over the one rank, gathered by hooks) against the replicated AdamW:
   after one update every parameter within ZERO_FSDP_ULPS, each loss
   within ZERO_FSDP_LOSS_REL, and ZeRO's first update bit-equal to the
   replicated AdamW's with foreach forced on; tokens/s and the peak of
   allocated memory.
33. train_gpt_moe: GPT-2 small's widths with 8 experts in every second
   block (Switch: top-1, capacity factor 2.0; 361,304,064 parameters),
   bf16, flash, AdamW in hvd.DistributedOptimizer, 8 x 1024 tokens,
   through ``parallel/dp.py::make_train_step`` with the ``ep`` axis bound
   at size 1, beside the same weights with ``ep_axis=None`` and no mesh:
   losses bit-equal, finite and falling, 12 + 12 + 12 flash launches and
   a pack and an unpack per bucket every step; tokens/s, the peak, each
   MoE layer's forward split into router, dispatch, expert products and
   combine (CUDA events) and its share of dropped tokens.
34. train_composite: on a (dp, pp, tp) = (1, 1, 1) mesh,
   ``parallel/composite.py``'s CompositeGPT (GPT-2 small's widths, a
   shared 8-expert MoE FFN after the embedding, gpipe) and CompositeLlama
   (LLaMA-400M, GQA 16/8; gpipe and 1F1B, each with and without remat),
   4 microbatches of 2 x 1024, bf16, flash, AdamW: the first step's loss
   and gradients against the same modules run on the whole batch with no
   pipeline (COMPOSITE_LIMITS); 1F1B's first-step gradients against
   gpipe's (F1B_LIMITS); 1F1B's peak below gpipe's without remat; flash
   launches a step (12 or 24 layers x 4 microbatches; 1F1B adds a
   recomputed forward per microbatch); tokens/s and the peak of each.
35. pipeline_virtual: the pipeline schedules (``parallel/pp.py``'s stage
   functions) over S = 4 virtual stages in one process at GPT-2 small's
   width (12 blocks, 3 a stage), 8 microbatches of 2 x 1024, bf16, flash:
   each stage's output handed to the next where the ppermute would. GPipe
   and 1F1B outputs and gradients against the sequential stack, within
   VIRTUAL_LIMITS; M + S - 1 and M + 2S - 2 ticks; a control with one
   hop dropped that must fail the output bound by more than 10x.

Phases 36-41 run after pipeline_virtual: A14, the remaining models,
and A15's decode cache.

36. train_t5: T5-small (bench.py:615-640: vocab 32128, hidden 512, 6 + 6
   layers, 8 heads, GEGLU 1024, 70,664,704 parameters, bf16) on 16 x 512
   source and 512 target tokens from --seed, next-token loss in fp32,
   AdamW(1e-4) in hvd.DistributedOptimizer, remat off and then on from
   the same weights: finite, falling losses, bit-equal between the two, a
   lower peak with remat, a pack and an unpack per bucket every step (no
   flash: the relative bias keeps attention on the plain path). Reported:
   tokens/s, device ms a step by kind (torch.profiler) and the step's 18
   plain attentions timed apart at its shapes.
37-38. train_vgg16 and train_inception3: VGG-16 (classic head, 138,357,544
   parameters) on 64 x 224 x 224 and Inception V3 (aux head on, its loss
   added at 0.4; 27,161,264 parameters) on 64 x 299 x 299 images from
   --seed, 1000 classes, bf16, dropout 0, SGD with momentum 0.9 (lr 0.1,
   bench.py's; VGG-16 0.01, its paper's: it diverges at 0.1) in
   hvd.DistributedOptimizer: finite, falling losses, a pack and an unpack
   per bucket every step; images/s, device ms by kind, the peak.
39. train_lora: GPT-2 small (train_gpt's configuration and batch, flash)
   with rank-8 adapters on every attention and MLP kernel (48), AdamW(1e-3)
   over the adapters in hvd.DistributedOptimizer, merged functionally into
   the frozen base: the first loss equal to the base model's (b starts at
   zero), the base bit-unchanged after the steps, the bytes packed each
   step equal to lora_wire_numbers' adapter bytes (printed beside the full
   model's), 12 + 12 + 12 flash launches a step; tokens/s.
40. generate: bench.py:1196-1240's setting on GPT-2 small (flash; batch 8,
   a 32-token prompt, max_len 128): greedy generate, beam search (k = 4),
   sampled generate twice from one generator seed (bit-equal), greedy
   speculative decoding with the target as its own draft (gamma 4;
   bit-equal to greedy generate in ceil(96 / 5) = 20 blocks); then T5-small's
   greedy and beam (k = 4) re-forward decodes of 32 tokens over a 512-token
   source. Generated tokens/s of each; flash forward launches and no
   backward ones (flash_vs_plain holds the forward at the decodes' shapes).
41. generate_cached: the decode cache (A15's first half) at generate's
   settings, its models cut in depth (GEN_CACHED_*_LAYERS: 4 of GPT-2
   small's 12 layers and 4 of LLaMA-400M's 24; the widths stay). GPT-2
   small (bf16, capacity 1024): cached greedy, sampled
   twice from one generator seed (bit-equal), beam search (k = 4), greedy
   speculative decoding with the target as its own draft, prefill_prefix
   of a 16-token shared prefix then generate(prefix_state=...), a per-row
   batch at staggered positions; LLaMA-400M (capacity 4096) cached greedy
   with the bf16 and the int8 cache; T5-small cached greedy and beam
   decodes of 32 tokens over 512. Each route's feeding pattern,
   teacher-forced with the re-forward's tokens, gives logits within
   FORCED_C times the bf16 re-forward's distance from an fp32 re-forward
   of the same weights, which a cursor off by one and a cache hiding each
   query's newest row must fail; the int8 cache within 0.15 max|logit| of
   the bf16 cache (JAX's bound); no flash launch in a cached route; every
   feed one forward of s tokens on the cache. Printed: generated tokens/s
   beside the re-forward's, device ms and launches a decode step, cache
   bytes, the peak, each route's token agreement with the re-forward.

Phases 42-43 run after generate_cached: A15's second half, serving.

42. serve: the continuous-batching engine (``horovod_tpu_torch/serving``)
   on GPT-2 small (bf16, capacity 1024; 8 slots, prefill_chunk 64,
   max_len 1024) under 32 requests from --seed submitted up front (prompts
   of 16-512 tokens, budgets of 16-128; 8 sampled at temperature 0.8,
   top-k 50, top-p 0.95, a seed each; 2 greedy ones with an EOS taken from
   a first run), then LLaMA-400M (SERVE_LLAMA_LAYERS of its 24 layers)
   with the int8 cache through 4 slots (8 requests). Checks: every request completes with its budget or at its
   EOS; every greedy token within FORCED_C x the bf16 re-forward's
   distance of the largest fp32 re-forward logit (LLaMA int8: 0.15 x the
   row's max|logit|), which an engine feeding each row one position late
   and one installing into the neighbouring slot must fail; a repeat of
   the same submissions bit-equal; a mid-run kv_snapshot ->
   detach_to_host -> reset_runtime(kv=...) bit-equal to the undisturbed
   run, with no migrated request prefilled again; a mid-run ServingState
   commit, restore and reset losing no request and keeping every committed
   prefix; no flash and no scale launch in the engine's runs; the HTTP
   frontend (concurrent POSTs, /health, /debug/trace/<rid>) and the
   metrics endpoint (/metrics, /serving/health). Printed: tokens/s and
   steps/s beside cached generate at batch 8, TTFT and inter-token
   latency p50/p99 from the registry, host and device ms, busy share and
   launches a decode step, prefill tokens/s, install and migration ms and
   bytes, commit ms, cache bytes, the peak, agreement with batch-1
   generate.
43. launch_serving: ``hvdrun-torch -np 1 --serving --serving-port <free>
   python -m horovod_tpu_torch.serving`` with HOROVOD_SERVING_MODEL=gpt2
   on the card: four concurrent POSTs, /health, the metrics endpoint's
   /serving/health, /debug/trace/<rid>, then SIGTERM to the worker: the
   launcher exits 0, the worker is gone, its trace shard holds the four
   requests.

Phase 44 runs after launch_serving: A16's first half, the per-rank
observability planes.

44. observe: GPT-2 small at full width at train_gpt's settings (8 x 1024,
   bf16, flash, AdamW in hvd.DistributedOptimizer, fused buckets; the
   flash kernels first held against their plain versions at the path's
   shape within the rounding bound, the scale kernels by one step's
   reduced gradients bit-equal to the local ones), OBSERVE_ROUNDS rounds
   of OBSERVE_BLOCK_STEPS steps with every plane disarmed, then armed:
   the timeline (a file per armed block), the flight recorder, the step
   profiler with its watchdog (MFU against the H100 row, the step's FLOPs
   from FlopCounterMode plus the flash kernels' attention term, which it
   cannot see), goodput and metrics, the scrape endpoint serving. Checks:
   12 launches of each flash kernel a step and the scale kernels'; goodput
   conserved within 1% at every snapshot; every flight dispatch with its
   complete and the global seqs contiguous; the timeline valid JSON, opened
   by clock_sync, its collective spans equal to the buckets dispatched;
   one step record per optimizer step, each split into the attribution
   categories; MFU in (0, 1); the buckets' device times read from CUDA
   events; a capture of the last armed block's last steps whose trace
   names fa_fwd_mma_kernel and scale_copy_kernel; /debug/steps and
   /debug/flight served; a forced flight.dump("ondemand") read back by
   flight.analyze. Printed: tokens/s armed against disarmed, the
   attribution split, device against host collective ms, MFU.

Phase 45 runs after observe: A16's second half and A17's first half, the
cluster telemetry plane and the control plane it rides.

45. cluster: GPT-2 small at train_gpt's settings, in this process. A JSON
   chaos plan armed from the env (cluster_plan: a 200 ms delay on step
   3's first fusion flush, a 7 s hang on step 6's) over 8 steps on a
   runtime whose stall inspector warns after 1 s, run twice: exactly the
   two planned ledger lines, the same schedule both runs, each counted in
   chaos_injections_total; step 3 200 ms over the median step (less the
   others' spread) and its step record's fusion time at least 200 ms;
   step 6 at least 7 s; one stall warning a run with its flight dump; a
   finite, falling loss. Then rounds of a disarmed block and a block with
   a plan armed that never fires, tokens/s each. Then four telemetry
   agents in two slices over one in-process KVStoreServer on a fake
   clock, each beaconing this process's real digest: all healthy; the
   slice-1 leader stopped: dead, its slice re-led, the transition logged;
   /cluster/health, /cluster/steps and /cluster/metrics through the scrape
   endpoint and hvd.cluster_snapshot() equal to the agent's; top.gate
   passes the healthy view and refuses it stale. Printed: the host ms of
   one digest.collect and one tick, step 3's attribution, tokens/s
   disarmed against armed-idle.

Phases 46-47 run after launch_elastic_cpu_world: A17's second half, the
tuners that steer the fusion runtime and the soaks.

46. autotune: GPT-2 small at train_gpt's settings in fresh 1-rank worlds
   on the card, from a runtime detuned to AUTOTUNE_DETUNED bytes. Leg A,
   HOROVOD_AUTOTUNE alone (AUTOTUNE_ENV's small windows): the flush-window
   ParameterManager on the runtime, its knobs moved. Leg B, the autopilot
   (AUTOPILOT_ENV: 0.5 s epochs, the flush-window tuner knob set too):
   a prior written by `python -m horovod_tpu_torch.sim --pretrain` at the
   H100 row, then a run with it and a cold run, each until the controller
   froze and AUTOPILOT_TAIL_STEPS more (AUTOPILOT_MAX_STEPS at most).
   Checks: the controller a live thread, the flush-window tuner detached;
   the trail prior_loaded (cold: none), then tuner adopt/hold records;
   no "autopilot tick failed" warning; the threshold above the detuned
   start; fewer scale-pack launches a step in the last epoch than in the
   first, by torch.profiler's kernel names and by the wrapper's count;
   autopilot_decisions_total on the scrape and flight.analyze's
   analyze_autopilot over the ring each counting the trail; after
   hvd.shutdown() no controller; every step on cuda with every flash and
   scale kernel launched. Printed: tokens/s at the first and the last
   epoch and at the untuned 64 MB default, the final knobs, each tick's
   host ms, the epochs to the freeze with and without the prior.
47. soak_cpu_world: chaos/soak.py on the elastic launcher with CPU (gloo)
   workers, as launch_elastic_cpu_world runs them: run_soak at 3
   processes (a kill, a KV drop, a straggler; final weights equal to the
   clean run's, resets within the kill budget, the same ledger schedule
   on the same-seed rerun, the flight dumps naming the kill) and
   run_autopilot_soak at 3 (the controller names the permanent straggler,
   the driver arm removes its host, the survivors finish at world 2, the
   flight trail's remediation names its rank, host and cause).

The train phases run with the fusion runtime's cycle thread live (1 ms, the
default): each step's pack and unpack launches are held to the buckets that
closed in that step, by the timer, the threshold or synchronize. Each phase
starts after a collection, with the peak statistics reset; the allocated
memory at each start is printed, and a phase that builds its own models must
start below OWN_MODEL_START_GB, so every peak_mem_gb is its phase's own.

Then the kernels line, the card's name and power limit, and, last,
{"ok": true, "device": {...}}. Any failed check raises, and the script exits
non-zero.
"""

import argparse
import contextlib
import ctypes
import dataclasses
import functools
import gc
import json
import math
import os
import pathlib
import random
import signal
import statistics
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12        # dense bf16 tensor cores, same data sheet
FLASH_SOURCE = "horovod_tpu_torch/ops/kernels/csrc/flash_attention.cu"
FLASH_REPLACES = {
    "flash_fwd": "horovod_tpu/ops/pallas/flash_attention.py:125",
    "flash_bwd_dq": "horovod_tpu/ops/pallas/flash_attention.py:311",
    "flash_bwd_dkv": "horovod_tpu/ops/pallas/flash_attention.py:387",
}
# The flash kernels whose bf16/fp16 instances run on the tensor cores.
REDESIGNED = dict.fromkeys(
    ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"),
    "redesigned: bf16/fp16 products on the tensor cores (mma.sync)")
# Their entry points in the build log, in the order hvd_flash_mma_smem
# numbers them.
MMA_KERNELS = {"flash_fwd": "fa_fwd_mma_kernel",
               "flash_bwd_dkv": "fa_bwd_dkv_mma_kernel",
               "flash_bwd_dq": "fa_bwd_dq_mma_kernel"}
ADASUM_SOURCE = "horovod_tpu_torch/ops/kernels/csrc/adasum.cu"
ADASUM_REPLACES = "horovod_tpu/ops/pallas/kernels.py:76"
# Tolerance of the Adasum kernel against its plain version, by dtype, as a
# share of each segment's largest plain value: max |kernel - plain| /
# max |plain|. Both compute in fp32 and round once; they sum the dot product
# and the norms in another order, which moves a coefficient by ~1e-6: 1e-5
# in fp32 (and float64, read into fp32); in bf16 and fp16 it can flip the
# one rounding, so two ulps of the dtype at the segment's largest value.
ADASUM_TOL = {"float32": 1e-5, "float64": 1e-5, "bfloat16": 2 * 2.0 ** -7,
              "float16": 2 * 2.0 ** -10}
# Rank counts of the gathered-bucket check (K = 3 carries an odd one).
ADASUM_RANKS = (4, 3)

# TF32 keeps 10 explicit bits of the fp32 mantissa: unit roundoff 2^-11.
TF32_UNIT = 2.0 ** -11


def tf32_product_c(k):
    """c of the elementwise bound |y - a b| <= c 2^-11 (|a| |b|) of an fp32
    product of depth ``k`` run at TF32: each operand rounded to TF32 at
    worst by truncation (2^-10 each, 4 units for a term, 2^-9 units of
    second order) and ``k`` fp32 additions in any order (at most k 2^-24 of
    the sum of absolute terms: k 2^-13 units)."""
    return 4.0 + 2.0 ** -9 + (k + 1) * 2.0 ** -13


def tf32_ratio(y, a, b):
    """max |y - a b| / (2^-11 |a| |b|) over the elements of the product
    ``y`` of ``a`` (m, k) and ``b`` (k, n), both sides in float64: the
    product's error in TF32 units of its own scale."""
    a, b = a.double(), b.double()
    err = (y.double() - a @ b).abs_()
    scale = (a.abs() @ b.abs()).mul_(TF32_UNIT).clamp_min_(1e-300)
    return err.div_(scale).max().item()

# Tolerance of the fp32 flash kernels against their plain versions:
# |kernel - plain| <= atol + rtol * |plain|. Both compute in fp32 and round
# once, but sum in another order (the kernel rescales its running sum per
# 64-key tile), which moves the value by ~1e-6 relative: held at 1e-4. The
# bf16/fp16 kernels are held to fa.rounding_bounds instead.
FLASH_TOL = {"float32": (1e-5, 1e-4)}
SHORT = {"float32": "f32", "bfloat16": "bf16", "float16": "f16"}


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps=30, inner=1):
    """Median over ``reps`` of the device time between two events around
    ``inner`` back-to-back calls, per call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def phase_env(torch):
    from horovod_tpu_torch.ops.kernels import _build
    card = card_line()
    print(card, flush=True)
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True)
    emit({"phase": "env", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "nvcc": nvcc.stdout.strip().splitlines()[-1],
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    return card


def ptxas_rows(report, smem_bytes):
    """ptxas's registers and spills for the tensor-core flash kernels, by
    kernel, element type and head dim, beside their dynamic shared memory
    ``smem_bytes(which, d)`` (ptxas counts only static shared memory)."""
    import re
    rows = []
    for mangled, info in sorted(report.items()):
        for which, (name, entry) in enumerate(MMA_KERNELS.items()):
            m = re.search(entry + r"I(\w+?)Li(\d+)E", mangled)
            if m:
                d = int(m.group(2))
                rows.append({"kernel": name, "dtype": "bfloat16" if "bfloat"
                             in m.group(1) else "float16", "D": d,
                             "dynamic_smem_bytes": smem_bytes(which, d),
                             **info})
    return rows


def phase_build():
    from horovod_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    per_source = _build.build()
    seconds = time.perf_counter() - t0
    smem = _build.load("flash_attention").hvd_flash_mma_smem
    smem.argtypes, smem.restype = [ctypes.c_int] * 2, ctypes.c_int
    ptxas = ptxas_rows(_build.ptxas_report("flash_attention"), smem)
    emit({"phase": "build", "seconds": seconds, "per_source": per_source,
          "dir": str(_build.BUILD_DIR), "ptxas_tensor_core_flash": ptxas})
    n = len(MMA_KERNELS)
    check(len(ptxas) == n * 2 * 4, f"ptxas reports every tensor-core flash "
          f"instance ({n} kernels x 2 types x 4 head dims): {len(ptxas)}")

    def clean(r):
        return r.get("spill_stores", 0) == 0 == r.get("spill_loads", 0)
    check(all(clean(r) for r in ptxas if r["D"] == 64),
          "no spills in the D = 64 tensor-core flash kernels")
    check(all(clean(r) and r.get("stack_bytes", 0) == 0 for r in ptxas
              if r["kernel"] == "flash_bwd_dq"),
          "no spills and no stack in the dQ kernel at any head dim")


def phase_kernel_vs_plain(torch, shapes_by_path, dev, seed):
    """``shapes_by_path``: the gradient shapes of each main path; each
    path's list goes through one pack and one unpack launch per dtype."""
    from horovod_tpu_torch.ops.kernels import scale_buffers as sb
    edge = [(0,), (1,), (7,), (1023,), (100_003,), (3_000_001,)]
    gen = torch.Generator(device=dev).manual_seed(seed)
    max_err, pre, post = 0.0, 0.5, 1.0 / 3.0
    for dt, shapes in ((dt, s) for s in shapes_by_path.values()
                       for dt in sb.DTYPES):
        ts = [torch.randn(s, generator=gen, device=dev).to(dt)
              for s in shapes + edge]
        total = sum(t.numel() for t in ts)
        flat_k = torch.empty(total, dtype=dt, device=dev)
        flat_p = torch.empty_like(flat_k)
        sb.pack_scale(ts, flat_k, pre)
        torch.cuda.synchronize()
        sb.pack_scale_reference(ts, flat_p, pre)
        torch.cuda.synchronize()
        max_err = max(max_err, (flat_k.float() - flat_p.float()).abs().max()
                      .item())
        check(torch.equal(flat_k, flat_p), f"pack_scale {dt} bit-equal")
        out_k = [torch.empty_like(t) for t in ts]
        out_p = [torch.empty_like(t) for t in ts]
        sb.unpack_scale(flat_k, out_k, post)
        torch.cuda.synchronize()
        sb.unpack_scale_reference(flat_k, out_p, post)
        torch.cuda.synchronize()
        for a, b in zip(out_k, out_p):
            if a.numel():
                max_err = max(max_err,
                              (a.float() - b.float()).abs().max().item())
            check(torch.equal(a, b), f"unpack_scale {dt} bit-equal")
        del ts, flat_k, flat_p, out_k, out_p
    rank_major = rank_major_vs_plain(torch, shapes_by_path["vit_b16"], dev,
                                     gen, pre, post)
    max_err = max(max_err, rank_major.pop("max_abs_err"))
    emit({"phase": "kernel_vs_plain", "edge_tensors": len(edge),
          "rank_major": rank_major,
          "paths": {name: {"tensors": len(shapes),
                           "elements": sum(int(torch.Size(s).numel())
                                           for s in shapes),
                           "largest": max(int(torch.Size(s).numel())
                                          for s in shapes)}
                    for name, shapes in shapes_by_path.items()},
          "dtypes": [str(d) for d in sb.DTYPES], "prescale": pre,
          "postscale": post, "bit_equal": True, "max_abs_err": max_err})
    return max_err


def rank_major_vs_plain(torch, shapes, dev, gen, pre, post):
    """The tables of a grouped reducescatter over n ranks, as
    collective_ops lays them out (``rank_major_blocks``: block r of every
    tensor, then block r + 1), for n = 4 and 8 over ``shapes`` whose first
    dim divides by n: the pack's rows (the blocks) and the unpack's (one
    rank's outputs, (m/n, ...) each), launched directly, bit-equal to the
    plain version in fp32, bf16 and fp16."""
    from horovod_tpu_torch.ops.collective_ops import rank_major_blocks
    from horovod_tpu_torch.ops.kernels import scale_buffers as sb
    report, max_err = {}, 0.0
    for n in (4, 8):
        kept = [s for s in shapes if s[0] % n == 0]
        for dt in sb.DTYPES:
            ts = [torch.randn(s, generator=gen, device=dev).to(dt)
                  for s in kept]
            blocks = rank_major_blocks(ts, n)
            total = sum(t.numel() for t in ts)
            flat_k = torch.empty(total, dtype=dt, device=dev)
            flat_p = torch.empty_like(flat_k)
            p0 = sb.pack_launches
            sb.pack_scale(blocks, flat_k, pre)
            torch.cuda.synchronize()
            check(sb.pack_launches - p0 == -(-len(blocks) // sb._MAX_ROWS),
                  f"the rank-major pack at n = {n} launched")
            sb.pack_scale_reference(blocks, flat_p, pre)
            check(torch.equal(flat_k, flat_p),
                  f"rank-major pack, n = {n}, {dt}: bit-equal")
            outs_k = [torch.empty((t.shape[0] // n,) + t.shape[1:],
                                  dtype=dt, device=dev) for t in ts]
            outs_p = [torch.empty_like(o) for o in outs_k]
            mine = flat_k[:total // n]
            sb.unpack_scale(mine, outs_k, post)
            torch.cuda.synchronize()
            sb.unpack_scale_reference(mine, outs_p, post)
            check(all(torch.equal(a, b) for a, b in zip(outs_k, outs_p)),
                  f"rank-major unpack, n = {n}, {dt}: bit-equal")
            max_err = max([max_err, (flat_k.float() - flat_p.float()).abs()
                           .max().item()]
                          + [(a.float() - b.float()).abs().max().item()
                             for a, b in zip(outs_k, outs_p) if a.numel()])
        report[n] = {"tensors": len(kept), "left_out": len(shapes) - len(kept),
                     "blocks": n * len(kept),
                     "elements": sum(int(torch.Size(s).numel())
                                     for s in kept)}
    return {"shapes": "ViT-B/16's gradients", "by_ranks": report,
            "bit_equal": True, "max_abs_err": max_err,
            "note": "left_out: shapes whose first dim does not divide by n "
                    "(reducescatter refuses them)"}


def reduced_equals_local(torch, model, step):
    """Run ``step`` once with a tensor hook on every parameter that copies
    its local gradient before accumulation, and check that the reduced
    gradients the optimizer stepped with equal those copies bit for bit
    (Average over 1 rank is x1.0). Returns the step's loss."""
    local = {}
    hooks = [p.register_hook(
        lambda g, p=p: local.__setitem__(p, g.detach().clone()))
        for p in model.parameters()]
    try:
        loss = step()
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    check(len(local) == len(list(model.parameters())),
          "a local gradient for every parameter")
    check(all(torch.equal(p.grad, g) for p, g in local.items()),
          "reduced gradients equal the local ones bit for bit")
    return loss


def buckets_since(mark):
    """The fusion buckets closed since ``mark`` (a ``flush_stats()``
    reading), oldest first, as (trigger, signature), and how many of them
    the cycle timer closed and how many had a new signature."""
    from horovod_tpu_torch.ops import fusion
    rt = fusion.get_runtime()
    now = rt.flush_stats()
    n = now["buckets"] - mark["buckets"]
    check(n <= fusion._RECENT, f"{n} buckets in one reading")
    return rt.recent_buckets(n), [
        n, now["closed_by"]["cycle"] - mark["closed_by"]["cycle"],
        now["new_signatures"] - mark["new_signatures"]]


def scale_launches(buckets):
    """The pack (or unpack) launches of ``buckets``: one per bucket, one
    more per ``_MAX_ROWS`` tensors past the first ``_MAX_ROWS``."""
    from horovod_tpu_torch.ops.kernels import scale_buffers as sb
    return sum(-(-len(sig[-1]) // sb._MAX_ROWS) for _, sig in buckets)


def step_buckets_report(per_bucket_step, warmup):
    """Buckets, buckets the timer closed and new signatures of each step,
    and their means over the steps after warm-up."""
    timed = per_bucket_step[warmup:]
    return {"buckets_timer_new_signatures_per_step": per_bucket_step,
            "after_warmup_mean": {
                k: statistics.mean(s[i] for s in timed)
                for i, k in enumerate(("buckets", "timer_closed",
                                       "new_signatures"))}}


class KeptTableTally:
    """While active, counts for every launch of the scale kernels whether
    its rows (each tensor's pointer and numel) were those of an earlier
    launch: a hit for a table kept on the card per signature, else a build.
    The wrapper passes its table by value and keeps none; this measures
    what keeping them would have saved. Wraps ``sb.table_rows``."""

    def __init__(self, sb):
        self.sb, self.seen, self.builds, self.hits = sb, set(), 0, 0

    def __enter__(self):
        raw = self.raw = self.sb.table_rows

        def rows(tensors, numels):
            out = raw(tensors, numels)
            key = (tuple(out[0][0]), tuple(numels))
            if key in self.seen:
                self.hits += 1
            else:
                self.seen.add(key)
                self.builds += 1
            return out
        self.sb.table_rows = rows
        return self

    def __exit__(self, *exc):
        self.sb.table_rows = self.raw

    def counts(self):
        return (self.builds, self.hits)


def kept_table_report(per_step, warmup, col):
    """The would-be table builds and hits of each step (columns ``col`` and
    ``col + 1`` of ``per_step``), and their sums and hit share over the
    steps after warm-up."""
    timed = per_step[warmup:]
    builds = sum(s[col] for s in timed)
    hits = sum(s[col + 1] for s in timed)
    return {"kept_table_builds_hits_per_step": [s[col:col + 2]
                                                for s in per_step],
            "kept_table_after_warmup": {
                "builds": builds, "hits": hits,
                "hit_share": hits / max(builds + hits, 1)}}


def phase_train(torch, hvd, model, dev, args, card):
    import torch.nn.functional as F

    from horovod_tpu_torch.ops.fusion import get_runtime
    from horovod_tpu_torch.ops.kernels import scale_buffers as sb

    sb.reset_launch_counts()                 # the main path starts here
    hvd.init()
    check(hvd.size() == 1 and hvd.device() == dev,
          f"1-rank world on {dev}, got {hvd.size()} on {hvd.device()}")
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    opt = hvd.DistributedOptimizer(opt,
                                   named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    x = torch.randn((args.batch, 224, 224, 3), generator=gen, device=dev)
    y = torch.randint(0, 1000, (args.batch,), generator=gen, device=dev)

    def step():
        opt.zero_grad()
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        return loss.detach()

    tally = KeptTableTally(sb)

    def counts():
        return (sb.pack_launches, sb.unpack_launches) + tally.counts()

    # Warm-up; the last warm-up step also checks the reduction.
    losses, per_step, closed, per_bucket = [], [], [], []
    with tally:
        for i in range(args.warmup + args.steps):
            if i == args.warmup:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            c0, m0 = counts(), get_runtime().flush_stats()
            losses.append(reduced_equals_local(torch, model, step)
                          if i == args.warmup - 1 else step())
            per_step.append([b - a for a, b in zip(c0, counts())])
            got, row = buckets_since(m0)
            closed.append(got)
            per_bucket.append(row)
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"scale_pack": sb.pack_launches,
                "scale_unpack": sb.unpack_launches}   # the main path ends
    losses = [l.item() for l in losses]
    check(all(map(math.isfinite, losses)), f"finite losses {losses}")
    check(losses[-1] < losses[0], f"loss falls: {losses}")
    check(all(s[0] >= 2 and s[1] >= 2 for s in per_step),
          f">= 2 pack and unpack launches a step: {per_step}")
    check(all(s[0] == s[1] == scale_launches(c) for s, c in
              zip(per_step, closed)),
          f"a pack and an unpack launch per bucket (per 256 tensors) every "
          f"step, the timer's buckets too: {per_step}, {per_bucket}")
    buckets = [[n for _, n in sig[-1]] for _, sig in closed[-1]
               if sig[4] == str(torch.float32)]
    emit({"phase": "train", "model": "ResNet-50", "batch": args.batch,
          "image": [224, 224, 3], "dtype": "bfloat16", "param_dtype":
          "float32", "params": sum(p.numel() for p in model.parameters()),
          "warmup": args.warmup, "steps": args.steps, "losses": losses,
          "step_ms": 1e3 * elapsed / args.steps,
          "images_per_sec": args.batch * args.steps / elapsed,
          "launches_per_step": [s[:2] for s in per_step],
          "launches": launches,
          **kept_table_report(per_step, args.warmup, 2),
          **step_buckets_report(per_bucket, args.warmup),
          "cycle_time_ms": get_runtime()._cycle_s * 1e3,
          "fp32_buckets_last_step": [{"tensors": len(b), "elements": sum(b)}
                                     for b in buckets],
          "reduced_equals_local_bitwise": True,
          "fusion_threshold": get_runtime().threshold, "card": card})
    return launches, buckets


def phase_timing(torch, buckets, dev, seed):
    from horovod_tpu_torch.ops.kernels import scale_buffers as sb
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    rows, s = [], 1.0 / 3.0
    for numels in buckets:
        ts = [torch.randn(n, generator=gen, device=dev) for n in numels]
        outs = [torch.empty_like(t) for t in ts]
        flat = torch.empty(sum(numels), device=dev)
        nbytes = 2 * flat.numel() * flat.element_size() + 24 * len(ts)
        pack_rows, pack_bx = sb.table_rows(ts, numels)
        unpack_rows, unpack_bx = sb.table_rows(outs, numels)
        pack_tables = sb.launch_tables(pack_rows)
        unpack_tables = sb.launch_tables(unpack_rows)
        rows.append({
            "tensors": len(ts), "elements": flat.numel(),
            "bound_ms": 1e3 * nbytes / H100_BYTES_PER_S,
            "pack_ms": event_ms(lambda: sb._launch(
                "hvd_scale_pack", pack_tables, pack_bx, flat, s), inner=10),
            "pack_wrapper_ms": event_ms(lambda: sb.pack_scale(ts, flat, s)),
            "pack_plain_ms": event_ms(
                lambda: sb.pack_scale_reference(ts, flat, s)),
            "pack_library_ms": event_ms(
                lambda: torch.cat(ts, out=flat).mul_(s)),
            "unpack_ms": event_ms(lambda: sb._launch(
                "hvd_scale_unpack", unpack_tables, unpack_bx, flat, s),
                inner=10),
            "unpack_wrapper_ms": event_ms(
                lambda: sb.unpack_scale(flat, outs, s)),
            "unpack_plain_ms": event_ms(
                lambda: sb.unpack_scale_reference(flat, outs, s)),
            "unpack_library_ms": event_ms(
                lambda: torch._foreach_mul(list(flat.split(numels)), s)),
        })
    total = {k: sum(r[k] for r in rows) for k in rows[0]
             if k.endswith("_ms")}
    emit({"phase": "timing", "dtype": "float32", "per_bucket": rows,
          "per_step": total,
          "note": "ms: the kernel alone, 10 back-to-back launches over "
                  "prebuilt host tables (each launch copies its table into "
                  "its parameters); wrapper_ms: pack_scale/unpack_scale as "
                  "the runtime calls them, checks and table built each "
                  "call; library: torch.cat(out=).mul_ for pack, and for "
                  "unpack torch._foreach_mul over the buffer's slices, "
                  "which returns new tensors and does not write into the "
                  "gradients as unpack does"})
    return total


def segment_errors(torch, got, want, numels):
    """max |got - want| / max |want| over each non-empty segment, and the
    largest absolute difference."""
    rel, worst_abs, off = [], 0.0, 0
    for n in numels:
        if n:
            g = got[off:off + n].double()
            w = want[off:off + n].double()
            diff = (g - w).abs().max().item()
            worst_abs = max(worst_abs, diff)
            rel.append(diff / max(w.abs().max().item(), 1e-30))
        off += n
    return rel, worst_abs


def phase_adasum_vs_plain(torch, shapes, dev, seed):
    """The Adasum kernel against its plain version: ResNet-50's gradient
    shapes as one bucket of segments, each at its own scale, in every dtype;
    then edge cases, each as a bucket of one segment. Synchronises after
    every launch."""
    from horovod_tpu_torch.ops.kernels import adasum as ak
    gen = torch.Generator(device=dev).manual_seed(seed + 6)
    numels = [int(torch.Size(s).numel()) for s in shapes]
    rows, worst = [], 0.0
    for dt in ak.DTYPES:
        name = str(dt).split(".")[-1]
        table = ak.segment_table(numels)
        scale = torch.cat([torch.full((n,), 10.0 ** (i % 5 - 2), device=dev)
                           for i, n in enumerate(numels)])
        a, b = ((torch.randn(table.total, generator=gen, device=dev)
                 * scale).to(dt) for _ in range(2))
        got = torch.empty_like(a)
        ak.combine_segments(a, b, got, table)
        torch.cuda.synchronize()
        want = ak.combine_segments_reference(a, b, torch.empty_like(a),
                                             table)
        torch.cuda.synchronize()
        rel, err = segment_errors(torch, got, want, numels)
        worst = max(worst, err)
        rows.append({"case": "resnet50_gradients", "dtype": name,
                     "segments": len(numels), "elements": table.total,
                     "max_rel": max(rel), "max_abs_err": err,
                     "tolerance": ADASUM_TOL[name]})
        check(max(rel) <= ADASUM_TOL[name], f"adasum {name} on ResNet-50's "
              f"shapes: {max(rel)} beyond {ADASUM_TOL[name]}")
        del a, b, got, want, scale

    def pair(case, n):
        a = torch.randn(n, generator=gen, device=dev)
        b = torch.randn(n, generator=gen, device=dev)
        if case == "zero_a":
            a = torch.zeros_like(a)
        elif case == "b_is_a":
            b = a.clone()
        elif case == "b_is_2a":
            b = 2 * a
        elif case == "b_is_minus_a":
            b = -a
        elif case == "orthogonal":
            a[n // 2:] = 0
            b[:n // 2] = 0
        return a, b
    exact = {"zero_a": lambda a, b: b, "b_is_a": lambda a, b: a,
             "b_is_2a": lambda a, b: 1.5 * a,
             "b_is_minus_a": lambda a, b: torch.zeros_like(a),
             "orthogonal": lambda a, b: a + b}
    # A segment past 1024 blocks of 4096 elements grid-strides in the block.
    edge = [("random", 0), ("random", 1), ("random", 7), ("random", 4097),
            ("random", 100_003), ("random", 4_194_305)] + [
        (c, 300_001) for c in exact]
    for dt in ak.DTYPES:
        name = str(dt).split(".")[-1]
        for case, n in edge:
            a, b = (t.to(dt) for t in pair(case, n))
            table = ak.segment_table((n,))
            got = torch.empty_like(a)
            ak.combine_segments(a, b, got, table)
            torch.cuda.synchronize()
            want = ak.combine_segments_reference(a, b, torch.empty_like(a),
                                                 table)
            torch.cuda.synchronize()
            rel, err = segment_errors(torch, got, want, (n,))
            worst = max(worst, err)
            bit_exact = None
            if case in exact and dt == torch.float32:
                bit_exact = bool(torch.equal(got, exact[case](a, b)))
                check(bit_exact, f"adasum {case} is exact in fp32")
            rows.append({"case": case, "dtype": name, "segments": 1,
                         "elements": n, "max_rel": max(rel, default=0.0),
                         "max_abs_err": err, "tolerance": ADASUM_TOL[name],
                         "bit_exact": bit_exact})
            check(max(rel, default=0.0) <= ADASUM_TOL[name],
                  f"adasum {case} {name} n={n}: {rel} beyond "
                  f"{ADASUM_TOL[name]}")
    routes = []
    for dt in ak.DTYPES:
        name = str(dt).split(".")[-1]
        cap = ak.round_elems(dt, dev)
        # Past a round (the streaming route); a round filled exactly; three
        # just over half a round, which the schedule keeps within a round's
        # steps.
        numels = (cap + 1, 5, cap, cap // 2 + 1, 3, cap // 2 + 1,
                  cap // 2 + 1)
        table = ak.segment_table(numels)
        sched = ak.schedule(numels, ((0, 0),), 0, dt, dev)
        check(sched.stream == [0] and sched.steps >= 6,
              f"{name}: the routes case reaches both routes "
              f"(stream {sched.stream}, steps {sched.steps})")
        scale = torch.cat([torch.full((n,), 10.0 ** (i % 5 - 2), device=dev)
                           for i, n in enumerate(numels)])
        a, b = ((torch.randn(table.total, generator=gen, device=dev)
                 * scale).to(dt) for _ in range(2))
        got = torch.empty_like(a)
        before = (ak.launches, ak.stream_launches)
        ak.combine_segments(a, b, got, table)
        torch.cuda.synchronize()
        launched = (ak.launches - before[0], ak.stream_launches - before[1])
        check(launched == (1, 2), f"{name}: one level launch and two "
              f"streaming launches, got {launched}")
        for plain, want in (
                ("level_tile_order", ak.combine_level_reference(
                    a, b, torch.empty_like(a), sched)),
                ("whole_sums", ak.combine_segments_reference(
                    a, b, torch.empty_like(a), table))):
            torch.cuda.synchronize()
            rel, err = segment_errors(torch, got, want, numels)
            worst = max(worst, err)
            routes.append({"case": "both_routes", "dtype": name,
                           "plain": plain, "elements": table.total,
                           "round_elements": cap, "steps": sched.steps,
                           "max_rel": max(rel), "max_abs_err": err,
                           "tolerance": ADASUM_TOL[name]})
            check(max(rel) <= ADASUM_TOL[name], f"adasum both routes {name} "
                  f"against {plain}: {max(rel)} beyond {ADASUM_TOL[name]}")
        del a, b, got, want, scale
    emit({"phase": "adasum_vs_plain", "cases": len(rows) + len(routes),
          "rows": rows, "routes": routes, "max_abs_err": worst,
          "metric": "max_rel: max |kernel - plain| / max |plain| per "
                    "segment; bit_exact: fp32 cases with an exact answer; "
                    "routes: a bucket with a unit past a round (the "
                    "streaming route) and units the schedule keeps within "
                    "a round's steps, against the plain version in the "
                    "level kernel's tile order and the one with whole sums",
          "tolerance": ADASUM_TOL})
    return worst


def adasum_buckets(torch, hvd, closed):
    """The fp32 Adasum buckets among ``closed`` (one step's, from
    :func:`buckets_since`): [[(parameter name, numel), ...], ...]."""
    return [[(name.split(".", 1)[1], n) for name, n in sig[-1]]
            for _, sig in closed
            if sig[1] == int(hvd.Adasum) and sig[4] == str(torch.float32)]


def phase_train_adasum(torch, hvd, model, dev, args, card):
    """The Adasum main path: ResNet-50 with hvd.DistributedOptimizer(SGD,
    op=hvd.Adasum) on the 1-rank world hvd.init() made for ``train``."""
    import torch.nn.functional as F

    from horovod_tpu_torch.ops.fusion import get_runtime
    from horovod_tpu_torch.ops.kernels import adasum as ak
    from horovod_tpu_torch.ops.kernels import scale_buffers as sb

    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    x = torch.randn((args.batch, 224, 224, 3), generator=gen, device=dev)
    y = torch.randint(0, 1000, (args.batch,), generator=gen, device=dev)
    torch.cuda.synchronize()

    sb.reset_launch_counts()                 # the Adasum path starts here
    ak.reset_launch_counts()
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    opt = hvd.DistributedOptimizer(opt,
                                   named_parameters=model.named_parameters(),
                                   op=hvd.Adasum)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)

    tally = KeptTableTally(sb)

    def counts():
        return (sb.pack_launches, sb.unpack_launches,
                ak.launches + ak.stream_launches) \
            + tally.counts()

    def step():
        opt.zero_grad()
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        return loss.detach()

    losses, per_step, closed, per_bucket = [], [], [], []
    with tally:
        for i in range(args.warmup + args.steps):
            if i == args.warmup:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            c0, m0 = counts(), get_runtime().flush_stats()
            losses.append(reduced_equals_local(torch, model, step)
                          if i == args.warmup - 1 else step())
            per_step.append([b - a for a, b in zip(c0, counts())])
            got, row = buckets_since(m0)
            closed.append(got)
            per_bucket.append(row)
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(zip(("scale_pack", "scale_unpack", "adasum_combine"),
                        counts()))           # the Adasum path ends
    tables = kept_table_report(per_step, args.warmup, 3)
    per_step = [s[:3] for s in per_step]
    opt._remove_hooks()
    losses = [l.item() for l in losses]
    buckets = adasum_buckets(torch, hvd, closed[-1])
    check(all(map(math.isfinite, losses)), f"finite losses {losses}")
    check(losses[-1] < losses[0], f"loss falls: {losses}")
    check(buckets and all(
        s[0] == s[1] == scale_launches(c) and s[2] == 0
        for s, c in zip(per_step, closed)),
          f"a pack and an unpack launch per Adasum bucket (per 256 tensors) "
          f"and no combine (one rank) every step: {per_step}, {per_bucket}")
    emit({"phase": "train_adasum", "model": "ResNet-50", "op": "Adasum",
          "batch": args.batch, "warmup": args.warmup, "steps": args.steps,
          "losses": losses, "step_ms": 1e3 * elapsed / args.steps,
          "images_per_sec": args.batch * args.steps / elapsed,
          "launches_per_step": per_step,
          "launches_per_step_columns": list(launches), "launches": launches,
          **tables, **step_buckets_report(per_bucket, args.warmup),
          "fp32_buckets_last_step": [{"tensors": len(b),
                                      "elements": sum(n for _, n in b)}
                                     for b in buckets],
          "reduced_equals_local_bitwise": True,
          "note": "one rank: the gather leaves a tree of one leaf, so the "
                  "combine kernel does not run in this path; "
                  "adasum_gathered drives it on the path's buckets",
          "card": card})
    return launches, buckets


def phase_adasum_gathered(torch, model, buckets, dev, args):
    """The combine kernel through the route's own post-gather function at
    the path's shapes: ResNet-50's gradients for K batches from ``seed``
    (what K ranks would hold; --batch images each), packed in each
    bucket's layout and stacked as the all-gather leaves them, through
    ops.adasum.reduce_gathered, for
    each K of ADASUM_RANKS. Held against reduce_gathered_reference; a
    control with whole-bucket coefficients must fail the same limit."""
    import torch.nn.functional as F

    from horovod_tpu_torch.ops.adasum import reduce_gathered
    from horovod_tpu_torch.ops.kernels import adasum as ak

    params = dict(model.named_parameters())
    names = list(params)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 7)
    grads = []
    for _ in range(max(ADASUM_RANKS)):
        x = torch.randn((args.batch, 224, 224, 3), generator=gen, device=dev)
        y = torch.randint(0, 1000, (args.batch,), generator=gen, device=dev)
        loss = F.cross_entropy(model(x), y)
        # autograd.grad: the optimizer's gradient hooks do not fire.
        g = torch.autograd.grad(loss, [params[n] for n in names])
        grads.append(dict(zip(names, g)))
    limit = ADASUM_TOL["float32"]
    rows, total_launches, worst = [], 0, 0.0
    for k in ADASUM_RANKS:
        for bucket in buckets:
            numels = [n for _, n in bucket]
            gathered = torch.stack([
                torch.cat([grads[r][name].reshape(-1) for name, _ in bucket])
                for r in range(k)])
            want = ak.reduce_gathered_reference(gathered, numels)
            whole = ak.reduce_gathered_reference(gathered, [sum(numels)])
            torch.cuda.synchronize()
            ak.reset_launch_counts()
            got = reduce_gathered(gathered, numels)
            torch.cuda.synchronize()
            launches, streamed = ak.launches, ak.stream_launches
            total_launches += launches + streamed
            rel, err = segment_errors(torch, got, want, numels)
            ctl, _ = segment_errors(torch, whole, want, numels)
            worst = max(worst, err)
            levels = (k - 1).bit_length()
            rows.append({"ranks": k, "tensors": len(numels),
                         "elements": sum(numels), "launches": launches,
                         "stream_launches": streamed, "levels": levels,
                         "max_rel": max(rel), "max_abs_err": err,
                         "control_whole_bucket_max_rel": max(ctl)})
            check(launches == levels and streamed == 0,
                  f"ceil(log2 K) = {levels} level launches and no "
                  f"streaming one for K = {k}, got {launches} and "
                  f"{streamed}")
            check(max(rel) <= limit, f"reduce_gathered K = {k}: {max(rel)} "
                  f"beyond {limit}")
            # A bucket of one tensor has one coefficient pair either way.
            check(len(numels) == 1 or max(ctl) > limit,
                  f"the whole-bucket control K = {k} ({max(ctl)}) is "
                  f"rejected by the limit {limit}")
            del gathered, want, whole
        check(any(r["tensors"] > 1 and r["ranks"] == k for r in rows),
              f"a bucket of more than one tensor for the control, K = {k}")
    emit({"phase": "adasum_gathered", "rows": rows, "limit": limit,
          "max_abs_err": worst, "launches": total_launches,
          "metric": "max_rel: max |kernel - plain| / max |plain| per tensor "
                    "of the bucket; the control takes one coefficient pair "
                    "for the whole bucket and must exceed the limit"})
    return total_launches, worst


def phase_timing_adasum(torch, buckets, dev, seed):
    """One combine of two ranks' rows at the fp32 bucket shapes of the
    Adasum path (a tree level at K = 2): the level kernel alone, the
    wrapper, the plain version; summed over the buckets, beside the byte
    bound, with each bucket's steps, grid and shared memory."""
    from horovod_tpu_torch.ops.kernels import adasum as ak
    gen = torch.Generator(device=dev).manual_seed(seed + 8)
    rows = []
    for bucket in buckets:
        numels = [n for _, n in bucket]
        total = sum(numels)
        gathered = torch.randn(2, total, generator=gen, device=dev)
        flat = gathered.view(-1)
        sched = ak.schedule(numels, ak.level_pairs(2, 1), total,
                            torch.float32, dev)
        check(not sched.stream, "no ResNet-50 tensor is past a round")
        nbytes = 3 * total * gathered.element_size()
        rows.append({
            "tensors": len(numels), "elements": total,
            "steps": sched.steps, "grid": sched.grid,
            "tiles": len(sched.tiles),
            "empty_tiles": sched.tiles.count(None),
            "tile_elements": sched.tile,
            "dynamic_smem_bytes": ak.LEVEL_SMEM_BYTES,
            "bound_ms": 1e3 * nbytes / H100_BYTES_PER_S,
            "ms": event_ms(lambda: ak.launch_level(flat, flat, flat, sched),
                           inner=10),
            "wrapper_ms": event_ms(
                lambda: ak.combine_pairs(gathered, numels, 1)),
            "plain_ms": event_ms(lambda: ak.combine_level_reference(
                flat, flat, flat, sched), reps=5),
        })
        del gathered, flat
    total = {k: sum(r[k] for r in rows) for k in ("bound_ms", "ms",
                                                  "wrapper_ms", "plain_ms")}
    total["bound_share"] = total["bound_ms"] / total["ms"]
    emit({"phase": "timing_adasum", "dtype": "float32", "per_bucket": rows,
          "per_combine": total,
          "elements": sum(r["elements"] for r in rows),
          "library_ms": None,
          "note": "one combine of every gradient of the step (rows 0 and 1 "
                  "of a gathered bucket, in place); ms: the level kernel "
                  "alone, 10 cooperative launches back to back; "
                  "wrapper_ms: combine_pairs as reduce_gathered calls it; "
                  "plain_ms: combine_level_reference; bound: each input "
                  "and output byte once (3 N x 4 B) at 3.35 TB/s; library: "
                  "none, no single PyTorch call computes this combine"})
    return total


# The quantized wire and SyncBatchNorm: ResNet-50 over the int8/fp8
# block-scaled exchange, and with every BatchNorm synchronized.
WIRE_PAIRS = (("bfloat16", "float32"), ("float16", "float32"),
              ("float32", "bfloat16"), ("float32", "float16"))
WIRE_RUNS = ("", "int8", "fp8")          # exact, then the two formats
WIRE_CHECK_STEPS = 2                     # captured exchanges, then timed
# Sync BN against an fp32-activation copy, no further than plain
# BatchNorm's bf16 rounding leaves it: factor x plain's distance + floor.
SYNCBN_LIMITS = {"factor": 2.0, "update_rel_floor": 1e-2,
                 "loss_rel_floor": 1e-4, "stats_rel_floor": 1e-3}


def quantize_cases(torch, buckets, seed):
    """(name, fp32 CPU tensor of (blocks, BLOCK)) for each bucket total of
    the main path (padded to whole blocks, as the exchange pads at one
    rank), with an all-zero block and a block whose largest element is its
    last, and a tail shorter than one block."""
    from horovod_tpu_torch.ops import wire
    gen = torch.Generator().manual_seed(seed + 5)
    cases = []
    for i, numels in enumerate(buckets):
        total = sum(numels)
        # At least the three blocks the cases below write: the cycle timer
        # can close a bucket of one small tensor.
        blocks = max(-(-total // wire.BLOCK), 3)
        x = torch.randn(blocks * wire.BLOCK, generator=gen)
        x *= torch.exp(torch.randn(blocks, generator=gen) * 3) \
            .repeat_interleave(wire.BLOCK)
        x[total:] = 0.0
        x = x.view(blocks, wire.BLOCK)
        x[1] = 0.0
        x[2, -1] = 3.0 * x[2].abs().max()
        cases.append((f"bucket{i}", x))
    cases.append(("tail", torch.randn((3, 700), generator=gen)))
    return cases


def phase_wire_vs_cpu(torch, buckets, shapes, dev, seed):
    """The quantized wire's arithmetic on the card against the CPU, and the
    scale kernels' mixed-dtype form against their plain versions."""
    from horovod_tpu_torch.ops import wire
    from horovod_tpu_torch.ops.kernels import scale_buffers as sb
    quant = {}
    for name, x in quantize_cases(torch, buckets, seed):
        for w in ("int8", "fp8"):
            qc, sc = wire.quantize_blocks(x, w)
            qg, sg = wire.quantize_blocks(x.to(dev), w)
            dc, dg = wire.dequantize(qc, sc), wire.dequantize(qg, sg)
            # One row's dequantize added onto another, as the exchange sums.
            fc = wire._fma(dc, qc.flip(0), sc.flip(0))
            fg = wire._fma(dg, qg.flip(0), sg.flip(0))
            torch.cuda.synchronize()
            same = (torch.equal(qc.view(torch.uint8),
                                qg.cpu().view(torch.uint8))
                    and torch.equal(sc.view(torch.int32),
                                    sg.cpu().view(torch.int32))
                    and torch.equal(dc.view(torch.int32),
                                    dg.cpu().view(torch.int32))
                    and torch.equal(fc.view(torch.int32),
                                    fg.cpu().view(torch.int32)))
            check(same, f"quantize_blocks/dequantize/_fma {w} on the card "
                  f"bit-equal to the CPU on {name} {tuple(x.shape)}")
            quant[f"{name}/{w}"] = {"blocks": x.shape[0],
                                    "block": x.shape[1], "bit_equal": True}
    gen = torch.Generator(device=dev).manual_seed(seed + 6)
    pre, post = 0.5, 1.0 / 3.0
    mixed, max_err = {}, 0.0
    for a, b in WIRE_PAIRS:
        ta, tb = getattr(torch, a), getattr(torch, b)
        ts = [torch.randn(s, generator=gen, device=dev).to(ta)
              for s in shapes]
        numels = [t.numel() for t in ts]
        flat_k = torch.empty(sum(numels), dtype=tb, device=dev)
        flat_p = torch.empty_like(flat_k)
        p0 = sb.pack_launches
        sb.pack_scale(ts, flat_k, pre)
        torch.cuda.synchronize()
        check(sb.pack_launches - p0 == -(-len(ts) // sb._MAX_ROWS),
              f"the {a} -> {b} pack launched")
        sb.pack_scale_reference(ts, flat_p, pre)
        check(torch.equal(flat_k, flat_p), f"pack {a} -> {b} bit-equal")
        outs_k = [torch.empty_like(t) for t in ts]
        outs_p = [torch.empty_like(t) for t in ts]
        sb.unpack_scale(flat_k, outs_k, post)
        torch.cuda.synchronize()
        sb.unpack_scale_reference(flat_k, outs_p, post)
        check(all(torch.equal(x, y) for x, y in zip(outs_k, outs_p)),
              f"unpack {b} -> {a} bit-equal")
        nbytes = sum(numels) * (torch.empty((), dtype=ta).element_size()
                                + torch.empty((), dtype=tb).element_size()) \
            + 24 * len(ts)
        rows, bx = sb.table_rows(ts, numels)
        tables = sb.launch_tables(rows)
        urows, ubx = sb.table_rows(outs_k, numels)
        utables = sb.launch_tables(urows)
        mixed[f"{a}->{b}"] = {
            "tensors": len(ts), "elements": sum(numels),
            "bound_ms": 1e3 * nbytes / H100_BYTES_PER_S,
            "pack_ms": event_ms(lambda: sb._launch(
                "hvd_scale_pack", tables, bx, flat_k, pre, ta), inner=10),
            "pack_plain_ms": event_ms(
                lambda: sb.pack_scale_reference(ts, flat_p, pre)),
            "pack_library_ms": event_ms(
                lambda: torch.cat([t.view(-1) for t in ts],
                                  out=flat_p).mul_(pre)),
            "unpack_ms": event_ms(lambda: sb._launch(
                "hvd_scale_unpack", utables, ubx, flat_k, post, ta),
                inner=10),
            "unpack_plain_ms": event_ms(
                lambda: sb.unpack_scale_reference(flat_k, outs_p, post)),
            "unpack_library_ms": event_ms(
                lambda: torch._foreach_mul(list(flat_k.split(numels)),
                                           post))}
        max_err = max(max_err, (flat_k.float() - flat_p.float()).abs().max()
                      .item())
        del ts, flat_k, flat_p, outs_k, outs_p
    # A bucket that mixes fp32 and bf16 tensors in a bf16 buffer (the cast
    # wire): one launch per tensor dtype.
    ts = [torch.randn(s, generator=gen, device=dev).to(
        torch.bfloat16 if i % 3 == 0 else torch.float32)
        for i, s in enumerate(shapes)]
    flat_k = torch.empty(sum(t.numel() for t in ts), dtype=torch.bfloat16,
                         device=dev)
    flat_p = torch.empty_like(flat_k)
    p0 = sb.pack_launches
    sb.pack_scale(ts, flat_k, pre)
    torch.cuda.synchronize()
    check(sb.pack_launches - p0 == 2, "a two-dtype bucket: two launches")
    sb.pack_scale_reference(ts, flat_p, pre)
    check(torch.equal(flat_k, flat_p), "mixed bucket pack bit-equal")
    outs_k = [torch.empty_like(t) for t in ts]
    outs_p = [torch.empty_like(t) for t in ts]
    sb.unpack_scale(flat_k, outs_k, post)
    torch.cuda.synchronize()
    sb.unpack_scale_reference(flat_k, outs_p, post)
    check(all(torch.equal(x, y) for x, y in zip(outs_k, outs_p)),
          "mixed bucket unpack bit-equal")
    emit({"phase": "wire_vs_cpu", "quantize": quant,
          "mixed_dtype": mixed, "shapes": "ResNet-50's gradients",
          "prescale": pre, "postscale": post, "bit_equal": True,
          "max_abs_err": max_err,
          "note": "ms: the kernel alone, 10 launches back to back; plain: "
                  "pack_scale_reference/unpack_scale_reference; library: "
                  "torch.cat(out=).mul_ and torch._foreach_mul, as in "
                  "timing; bound: each byte of the tensors and the buffer "
                  "once at 3.35 TB/s"})
    return mixed, max_err


class ExchangeTap:
    """While active, wraps ``wire.block_scaled_allreduce``: times each call
    with CUDA events on its stream (the fusion side stream) and, while
    ``capture`` is set, keeps its input, residual, output and new
    residual."""

    def __init__(self, torch, wire):
        self.torch, self.wire, self.capture = torch, wire, False
        self.events, self.calls = [], []

    def __enter__(self):
        raw = self.raw = self.wire.block_scaled_allreduce
        torch = self.torch

        def tapped(x, residual=None, **kw):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out, new = raw(x, residual=residual, **kw)
            b.record()
            self.events.append((a, b))
            if self.capture:
                self.calls.append((x.clone(), None if residual is None
                                   else residual.clone(), out.clone(),
                                   None if new is None else new.clone(),
                                   kw["wire"]))
            return out, new
        self.wire.block_scaled_allreduce = tapped
        return self

    def __exit__(self, *exc):
        self.wire.block_scaled_allreduce = self.raw

    def device_ms(self):
        self.torch.cuda.synchronize()
        ms = sum(a.elapsed_time(b) for a, b in self.events)
        self.events = []
        return ms


def two_leg_bound(torch, x, label):
    """Per element of ``x`` (a bucket's flat fp32 buffer), the most the
    exchange may move it at one rank: the first leg's error and the
    second leg's, each at its block's maximum (int8: max/254 a leg; fp8:
    |x|/16 + max/256 a leg, the JAX tests' bound)."""
    from horovod_tpu_torch.ops import wire
    pad = (-x.numel()) % wire.BLOCK
    xb = torch.nn.functional.pad(x.double(), (0, pad)).view(-1, wire.BLOCK)
    m = xb.abs().amax(dim=1, keepdim=True)
    if label == "int8":
        e1 = m / 254 + 0 * xb
        e2 = (m + m / 254) / 254 + 0 * xb
    else:
        e1 = xb.abs() / 16 + m / 256
        e2 = (xb.abs() + e1) / 16 + (m + m / 16 + m / 256) / 256
    return (e1 + e2 + 1e-7 * m).reshape(-1)[:x.numel()]


def phase_train_wire(torch, hvd, dev, args, card, make_model):
    """ResNet-50 as in ``train``, on the same weights and batch, exact and
    then on HOROVOD_WIRE_DTYPE=int8 and fp8 with error feedback, each in a
    fresh 1-rank world."""
    import copy

    import torch.nn.functional as F

    from horovod_tpu_torch.ops import wire
    from horovod_tpu_torch.ops.fusion import get_runtime
    from horovod_tpu_torch.ops.kernels import scale_buffers as sb

    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    x = torch.randn((args.batch, 224, 224, 3), generator=gen, device=dev)
    y = torch.randint(0, 1000, (args.batch,), generator=gen, device=dev)
    model = make_model()
    init = copy.deepcopy(model.state_dict())
    names = {p: n for n, p in model.named_parameters()}
    report, first_grads = {}, None
    sb.reset_launch_counts()                 # the wire paths start here
    for label in WIRE_RUNS:
        hvd.shutdown()
        os.environ["HOROVOD_WIRE_DTYPE"] = label
        hvd.init()
        rt = get_runtime()
        check(rt.wire_dtype == label, f"the runtime's wire is {label!r}")
        model.load_state_dict(init)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            named_parameters=model.named_parameters())

        def step():
            opt.zero_grad()
            loss = F.cross_entropy(model(x), y)
            loss.backward()
            opt.step()
            return loss.detach()

        losses, per_step, stats, closed = [], [], [], []
        with ExchangeTap(torch, wire) as tap:
            for i in range(WIRE_CHECK_STEPS + args.warmup + args.steps):
                if i == WIRE_CHECK_STEPS + args.warmup:
                    torch.cuda.synchronize()
                    tap.device_ms()
                    t0 = time.perf_counter()
                tap.capture = i < WIRE_CHECK_STEPS
                c0, m0 = (sb.pack_launches, sb.unpack_launches), \
                    rt.flush_stats()
                if i == 0:
                    with deterministic_cudnn(torch):
                        losses.append(step())
                    torch.cuda.synchronize()
                    grads = [(names[p], p.grad.clone())
                             for p in model.parameters()]
                else:
                    losses.append(step())
                got, _ = buckets_since(m0)
                closed.append(got)
                m1 = rt.flush_stats()
                per_step.append([sb.pack_launches - c0[0],
                                 sb.unpack_launches - c0[1],
                                 len(got), m1["quantized"] - m0["quantized"],
                                 sum(sum(n for _, n in sig[-1]) >= wire.BLOCK
                                     and sig[5] == label for _, sig in got)])
                stats.append({k: m1["wire_bytes"].get(k, 0)
                              - m0["wire_bytes"].get(k, 0)
                              for k in m1["wire_bytes"]})
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            exchange_ms = tap.device_ms() / args.steps
            calls = tap.calls
        opt._remove_hooks()
        losses = [l.item() for l in losses]
        check(all(map(math.isfinite, losses)), f"{label or 'exact'}: finite "
              f"losses {losses}")
        check(all(s[0] == s[1] == s[2] for s in per_step),
              f"{label or 'exact'}: a pack and an unpack launch per bucket "
              f"every step: {per_step}")
        row = {"losses": losses, "step_ms": 1e3 * elapsed / args.steps,
               "images_per_sec": args.batch * args.steps / elapsed,
               "buckets_per_step": [s[2] for s in per_step],
               "wire_bytes_per_step": stats[-1]}
        if not label:
            first_grads = grads
            check(all(s[3] == 0 for s in per_step), "exact: no quantized "
                  f"bucket {per_step}")
            report["exact"] = row
            continue
        check(all(s[3] == s[4] for s in per_step) and sum(
            s[3] for s in per_step) > 0,
              f"{label}: every bucket of n x BLOCK or more elements, and "
              f"only those, quantized (flush_stats against the buckets; "
              f"columns: pack, unpack, buckets, quantized, eligible): "
              f"{per_step}")
        check(len(calls) == sum(s[3] for s in per_step[:WIRE_CHECK_STEPS]),
              f"{label}: one exchange per bucket ({len(calls)})")
        # Error feedback at one rank: out = x + r_prev - r_new, per bucket.
        ef_err = 0.0
        for xin, r, out, new, _ in calls:
            lhs = out.double()
            rhs = xin.double() + r.double() - new.double()
            tol = 2.0 ** -21 * (xin.double().abs() + r.double().abs()
                                + lhs.abs()) + 1e-30
            ef_err = max(ef_err, ((lhs - rhs).abs() / tol).max().item())
        check(ef_err <= 1.0, f"{label}: out = x + r_prev - r_new within fp32 "
              f"rounding in every bucket (worst share of the bound "
              f"{ef_err})")
        # Step 1 (deterministic cuDNN, zero residuals): the reduced
        # gradients against the exact run's, within the two-leg bound.
        now = dict(grads)
        ratio, compared, moved = 0.0, 0, 0
        first = calls[:per_step[0][3]]
        exact = dict(first_grads)
        quantized = [sig for _, sig in closed[0] if sig[5] == label and sum(
            n for _, n in sig[-1]) >= wire.BLOCK]
        for (xin, _, out, _, _), sig in zip(first, quantized):
            order = [n.split(".", 1)[1] for n, _ in sig[-1]]
            want = torch.cat([exact[n].reshape(-1) for n in order])
            check(torch.equal(xin, want), f"{label}: step 1's packed "
                  "gradients equal the exact run's")
            got_g = torch.cat([now[n].reshape(-1) for n in order])
            check(torch.equal(got_g, out), f"{label}: step 1's gradients "
                  "are the exchange's output")
            bound = two_leg_bound(torch, want, label)
            diff = (got_g.double() - want.double()).abs()
            # An all-zero block (the weights feeding a zero-scale BatchNorm
            # get zero gradients at step 1) has a zero bound: exact there.
            share = torch.where(bound > 0, diff / bound.clamp_min(1e-300),
                                torch.where(diff > 0, math.inf, 0.0))
            worst = share.max().item()
            check(not math.isnan(worst), f"{label}: a NaN share")
            ratio = max(ratio, worst)
            compared += want.numel()
            moved += int((got_g != want).sum())
        check(compared == sum(sum(n for _, n in sig[-1]) for sig in quantized)
              and len(quantized) == per_step[0][3] and moved > 0,
              f"{label}: step 1 compared on every quantized bucket "
              f"({compared} elements, {moved} moved by the wire)")
        check(ratio <= 1.0, f"{label}: step 1's averaged gradient within the "
              f"two-leg bound of the exact run's (worst share {ratio})")
        row.update({"exchange_device_ms_per_step": exchange_ms,
                    "ef_invariant_worst_share_of_fp32_bound": ef_err,
                    "step1_worst_share_of_two_leg_bound": ratio,
                    "step1_elements_compared_moved": [compared, moved],
                    "quantized_buckets_per_step": [s[3] for s in per_step]})
        report[label] = row
        del calls
    launches = {"scale_pack": sb.pack_launches,
                "scale_unpack": sb.unpack_launches}   # the wire paths end
    hvd.shutdown()
    os.environ.pop("HOROVOD_WIRE_DTYPE", None)
    hvd.init()
    check(get_runtime().wire_for() == "", "the world after the wire runs "
          f"is exact, not {get_runtime().wire_for()!r}")
    total = sum(p.numel() for p in model.parameters())
    emit({"phase": "train_wire", "model": "ResNet-50", "batch": args.batch,
          "warmup": args.warmup, "steps": args.steps, "runs": report,
          "parameters": total,
          "wire_bytes_formula": {
              "int8": wire.exchange_wire_bytes(total, 1),
              "exact_fp32": wire.allreduce_wire_bytes(4 * total, 4, 1, ""),
              "ratio": wire.exchange_wire_bytes(total, 1)
              / wire.allreduce_wire_bytes(4 * total, 4, 1, "")},
          "launches": launches,
          "note": "one rank: NCCL moves nothing across a link, so the "
                  "exchange's device ms are the quantize and dequantize "
                  "work; the byte saving (the JAX formulas, not a "
                  "measurement) shows only on N cards. Step 1 of each run "
                  "runs with deterministic cuDNN, the rest as in train.",
          "card": card})
    del model, init
    return launches


def sync_name(name):
    return name.replace("SyncBatchNorm_", "BatchNorm_")


def phase_train_syncbn(torch, hvd, dev, args, card, make_model):
    """ResNet-50 with every BatchNorm synchronized over the world, against
    the plain-BatchNorm ResNet-50 on the same weights and batch, both held
    to an fp32-activation copy: sync BN must be as close to it as plain
    BatchNorm's own bf16 rounding leaves plain BatchNorm."""
    import torch.nn.functional as F

    from horovod_tpu_torch.models import ResNet50
    from horovod_tpu_torch.ops import sync_batch_norm as sbn
    from horovod_tpu_torch.ops.kernels import scale_buffers as sb

    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    x = torch.randn((args.batch, 224, 224, 3), generator=gen, device=dev)
    y = torch.randint(0, 1000, (args.batch,), generator=gen, device=dev)
    plain = make_model()
    state = {sync_name(k): v for k, v in plain.state_dict().items()}

    def copy_of(**kw):
        m = ResNet50(num_classes=1000, **kw).to(dev).train()
        m.load_state_dict({k: state[sync_name(k)] for k in m.state_dict()})
        return m

    models = {"ref": copy_of(dtype=torch.float32), "plain": plain,
              "sync": copy_of(dtype=torch.bfloat16,
                              sync_batch_norm=hvd.global_process_set)}
    n_bn = sum(isinstance(m, sbn.SyncBatchNorm)
               for m in models["sync"].modules())
    runs = {}
    for name, model in models.items():
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            named_parameters=model.named_parameters())
        before = {sync_name(n): p.detach().clone()
                  for n, p in model.named_parameters()}

        def step():
            opt.zero_grad()
            loss = F.cross_entropy(model(x), y)
            loss.backward()
            opt.step()
            return loss.detach()

        with deterministic_cudnn(torch):
            loss0 = step().item()
        torch.cuda.synchronize()
        runs[name] = {
            "loss": loss0,
            "update": {sync_name(n): p.detach() - before[sync_name(n)]
                       for n, p in model.named_parameters()},
            "stats": {sync_name(n): b.detach().clone()
                      for n, b in model.named_buffers()
                      if "running_" in n}}
        if name == "ref":
            opt._remove_hooks()
            continue
        sb.reset_launch_counts()             # this path starts here
        sbn.launches = 0
        for i in range(args.warmup + args.steps):
            if i == args.warmup:
                torch.cuda.synchronize()
                c0 = sbn.launches
                t0 = time.perf_counter()
            step()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        runs[name].update({
            "images_per_sec": args.batch * args.steps / elapsed,
            "step_ms": 1e3 * elapsed / args.steps,
            "bn_collectives_per_step": (sbn.launches - c0) / args.steps,
            "launches": {"scale_pack": sb.pack_launches,
                         "scale_unpack": sb.unpack_launches}})
        opt._remove_hooks()
    ref = runs["ref"]

    def rel(a, b):
        return ((a.double() - b.double()).norm()
                / b.double().norm().clamp_min(1e-30)).item()

    dev_of = {m: {k: rel(runs[m]["update"][k], v)
                  for k, v in ref["update"].items() if v.abs().max() > 0}
              for m in ("plain", "sync")}
    stats_of = {m: {k: rel(runs[m]["stats"][k], v)
                    for k, v in ref["stats"].items()}
                for m in ("plain", "sync")}
    loss_of = {m: abs(runs[m]["loss"] - ref["loss"]) for m in ("plain",
                                                              "sync")}
    lim = SYNCBN_LIMITS
    keys = sorted(dev_of["sync"])
    whole = {m: rel(torch.cat([runs[m]["update"][k].reshape(-1)
                               for k in keys]),
                    torch.cat([ref["update"][k].reshape(-1) for k in keys]))
             for m in ("plain", "sync")}
    median = {m: statistics.median(dev_of[m].values())
              for m in ("plain", "sync")}
    worse = max(whole["sync"] / (lim["factor"] * whole["plain"]
                                 + lim["update_rel_floor"]),
                median["sync"] / (lim["factor"] * median["plain"]
                                  + lim["update_rel_floor"]))
    per_tensor = sorted(((dev_of["sync"][k] / max(dev_of["plain"][k],
                                                   1e-30), k)
                         for k in keys), reverse=True)
    stats_worse = max(stats_of["sync"][k]
                      / (lim["factor"] * stats_of["plain"][k]
                         + lim["stats_rel_floor"]) for k in stats_of["sync"])
    check(math.isfinite(runs["sync"]["loss"]) and loss_of["sync"]
          <= lim["factor"] * loss_of["plain"]
          + lim["loss_rel_floor"] * abs(ref["loss"]),
          f"sync BN step 1 loss {runs['sync']['loss']}, plain "
          f"{runs['plain']['loss']}, fp32 {ref['loss']}")
    check(worse <= 1.0, f"sync BN step 1 update, whole and the median "
          f"tensor's, no further from the fp32 copy's than plain "
          f"BatchNorm's (x{lim['factor']} + {lim['update_rel_floor']}): "
          f"whole {whole}, median {median}")
    check(stats_worse <= 1.0, f"sync BN running statistics after step 1: "
          f"worst share {stats_worse}")
    check(runs["sync"]["bn_collectives_per_step"] == 2 * n_bn,
          f"{n_bn} BatchNorms, a forward and a backward collective each a "
          f"step: {runs['sync']['bn_collectives_per_step']}")
    cos = min(torch.nn.functional.cosine_similarity(
        runs["sync"]["update"][k].double().reshape(1, -1),
        runs["plain"]["update"][k].double().reshape(1, -1)).item()
        for k in dev_of["sync"])
    emit({"phase": "train_syncbn", "model": "ResNet-50",
          "batch": args.batch, "sync_batchnorms": n_bn, "limits": lim,
          "losses_step1": {m: runs[m]["loss"] for m in runs},
          "update_rel_to_fp32": {
              m: {"whole": whole[m], "median": median[m],
                  "max": max(dev_of[m].values())} for m in dev_of},
          "worst_share_of_limit": worse,
          "tensors_most_above_plain": per_tensor[:3],
          "stats_worst_share_of_limit": stats_worse,
          "sync_vs_plain_update_cos_min": cos,
          "runs": {k: {kk: vv for kk, vv in v.items()
                       if kk not in ("update", "stats")}
                   for k, v in runs.items() if k != "ref"},
          "note": "one rank: the global statistics are the local ones; "
                  "step 1 of each model with deterministic cuDNN, held to "
                  "an fp32-activation copy (ref); images/s over the timed "
                  "steps (host-bound: each BatchNorm's collective is a "
                  "host round trip)",
          "card": card})
    del models, plain
    return runs["sync"]["launches"]


# The GPT main path: bench.py's GPT-2 small, 8 x 1024 tokens a step.
GPT_BATCH, GPT_SEQ, GPT_STEPS = 8, 1024, 8
GPT_HIDDEN, GPT_HEADS, GPT_LAYERS, GPT_VOCAB = 768, 12, 12, 50304
GPT_FFN = 3072
GPT_HEAD_DIM = GPT_HIDDEN // GPT_HEADS
# The attention shape every flash launch of that path sees.
MAIN_FLASH_CASE = ("bfloat16", GPT_BATCH * GPT_HEADS, GPT_SEQ, GPT_SEQ,
                   GPT_HEAD_DIM, True, None, None, None)


# The BERT path: bench.py's BERT-Large leg (bench.py:452-500), 32 x 128
# tokens a step, MLM + NSP, dropout off (deterministic), so flash engages.
BERT_BATCH, BERT_SEQ, BERT_STEPS = 32, 128, 8
BERT_PARAMS = 367_480_636           # 303 Flax leaves (jax.eval_shape)
# The LLaMA path: bench.py's LLaMA-400M leg (bench.py:596-611) at 1024
# positions, 8 x 1024 tokens a step, 16 query heads over 8 kv heads.
LLAMA_BATCH, LLAMA_SEQ, LLAMA_STEPS = 8, 1024, 8
LLAMA_PARAMS = 348_701_696          # 147 Flax leaves
# The attention shapes every flash launch of those paths sees.
BERT_FLASH_CASE = ("bfloat16", BERT_BATCH * 16, BERT_SEQ, BERT_SEQ, 64,
                   False, None, None, None)
LLAMA_FLASH_CASE = ("bfloat16", LLAMA_BATCH * 16, LLAMA_SEQ, LLAMA_SEQ, 64,
                    True, None, 16, 8)
# The ViT path: bench.py's ViT-B/16 leg (bench.py:643-675), 128 bf16 images
# of 224 x 224 x 3 a step: 14 x 14 = 196 patches (no cls token), so the
# flash kernels' last 64-key tile holds 4 keys.
VIT_BATCH, VIT_IMAGE, VIT_STEPS = 128, 224, 8
VIT_PARAMS = 86_566_120             # 152 Flax leaves (jax.eval_shape)
VIT_SEQ = (VIT_IMAGE // 16) ** 2
VIT_FLASH_CASE = ("bfloat16", VIT_BATCH * 12, VIT_SEQ, VIT_SEQ, 64, False,
                  None, None, None)
# The composite trainers' and the virtual pipeline's microbatches: 2 x 1024
# tokens, at GPT-2 small's 12 heads and LLaMA-400M's 16 over 8.
COMPOSITE_MB = 2
COMPOSITE_GPT_FLASH_CASE = ("bfloat16", COMPOSITE_MB * GPT_HEADS, GPT_SEQ,
                            GPT_SEQ, GPT_HEAD_DIM, True, None, None, None)
COMPOSITE_LLAMA_FLASH_CASE = ("bfloat16", COMPOSITE_MB * 16, LLAMA_SEQ,
                              LLAMA_SEQ, 64, True, None, 16, 8)
# The decodes on GPT-2 small (bench.py:1196-1240): each re-forward runs the
# whole buffer, max_len columns (B x k rows for the beams), and speculative
# decoding's max_len + gamma + 1, whose last 64-key tile holds 5 keys.
GEN_BATCH, GEN_PROMPT, GEN_LEN, GEN_GAMMA = 8, 32, 128, 4
GEN_BEAMS, GEN_TOP_K, T5_GEN_LEN = 4, 50, 32
GEN_FLASH_CASE = ("bfloat16", GEN_BATCH * GPT_HEADS, GEN_LEN, GEN_LEN,
                  GPT_HEAD_DIM, True, None, None, None)
BEAM_FLASH_CASE = ("bfloat16", GEN_BATCH * GEN_BEAMS * GPT_HEADS, GEN_LEN,
                   GEN_LEN, GPT_HEAD_DIM, True, None, None, None)
SPEC_WIDTH = GEN_LEN + GEN_GAMMA + 1
SPEC_FLASH_CASE = ("bfloat16", GEN_BATCH * GPT_HEADS, SPEC_WIDTH, SPEC_WIDTH,
                   GPT_HEAD_DIM, True, None, None, None)
PATH_FLASH_CASES = {"bert": BERT_FLASH_CASE, "llama": LLAMA_FLASH_CASE,
                    "composite_gpt": COMPOSITE_GPT_FLASH_CASE,
                    "composite_llama": COMPOSITE_LLAMA_FLASH_CASE,
                    "vit": VIT_FLASH_CASE, "generate": GEN_FLASH_CASE,
                    "beam_search": BEAM_FLASH_CASE,
                    "speculative": SPEC_FLASH_CASE}
# Repeats of the ViT step's timing (images/s is their median), steps each.
VIT_REPEATS, VIT_REPEAT_STEPS = 5, 5


def gpt_config(torch, use_flash):
    from horovod_tpu_torch.models import GPTConfig
    # bench.py's GPT-2 small: untied fp32 lm_head, 163,109,376 parameters.
    return GPTConfig(vocab_size=GPT_VOCAB, hidden_size=GPT_HIDDEN,
                     num_layers=GPT_LAYERS, num_heads=GPT_HEADS,
                     intermediate_size=GPT_FFN,
                     max_position_embeddings=GPT_SEQ, dtype=torch.bfloat16,
                     tp_axis=None, ep_axis=None, use_flash=use_flash)


def flash_cases():
    """(dtype name, BH, Lq, Lk, D, causal, kv_valid, heads, kv_heads)."""
    cases = []
    for dt in ("float32", "bfloat16", "float16"):
        for d in (16, 32, 64, 128):
            for causal in (True, False):
                cases.append((dt, 4, 197, 197, d, causal, None, None, None))
        cases += [(dt, 4, 128, 320, 64, True, None, None, None),
                  (dt, 4, 320, 128, 64, True, None, None, None),
                  (dt, 4, 320, 128, 32, False, None, None, None),
                  (dt, 4, 197, 300, 32, False, 250, None, None),
                  (dt, 4, 300, 300, 64, True, 250, None, None),
                  (dt, 24, 197, 197, 64, True, None, 12, 4),
                  # the main path's shape; fewer rows outside its dtype
                  MAIN_FLASH_CASE if dt == MAIN_FLASH_CASE[0] else
                  (dt, 24) + MAIN_FLASH_CASE[2:]]
    return cases + list(PATH_FLASH_CASES.values())


def phase_flash_vs_plain(torch, dev, seed):
    """Each flash kernel against its plain version on the card. fp32:
    FLASH_TOL against the plain versions; lse in every dtype within 1e-5
    relative. bf16/fp16 forward, dQ and dK/dV: the rounding bound against
    the plain versions that round P and dS where the kernels do; a plain
    version with the causal diagonal off by one goes through the same check
    and must fail it on every output."""
    from horovod_tpu_torch.ops.kernels import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    rows, worst, main_err, ratios, controls = [], {}, {}, {}, []
    path_err, key_controls = {}, []
    for case in flash_cases():
        dt, bh, lq, lk, d, causal, kv_valid, heads, kvh = case
        dtype = getattr(torch, dt)
        bkv = bh if heads is None else bh // heads * kvh
        q, do = (torch.randn(bh, lq, d, generator=gen, device=dev).to(dtype)
                 for _ in range(2))
        k, v = (torch.randn(bkv, lk, d, generator=gen, device=dev).to(dtype)
                for _ in range(2))
        sm = d ** -0.5
        o, lse = fa.fa_forward(q, k, v, causal, sm, kv_valid=kv_valid,
                               heads=heads, kv_heads=kvh)
        torch.cuda.synchronize()
        if heads is not None:      # the backward takes MHA shapes
            g, b = heads // kvh, bh // heads
            k = fa.gqa_repeat3(k, b, kvh, g).contiguous()
            v = fa.gqa_repeat3(v, b, kvh, g).contiguous()
        o_p, lse_p = fa.block_fwd_reference(q, k, v, causal, sm, None,
                                            kv_valid)
        grads = fa.fa_backward(q, k, v, o, lse, do, causal, sm,
                               kv_valid=kv_valid)
        torch.cuda.synchronize()
        ref = fa.block_bwd_reference(q, k, v, o, lse, do, causal, sm, None,
                                     kv_valid)
        errs, rounded = {}, dt != "float32"
        tol_checks = [("lse", lse, lse_p, (1e-4, 1e-5))]
        if not rounded:
            atol, rtol = FLASH_TOL[dt]
            tol_checks += [("flash_fwd", o, o_p, (atol, rtol)),
                           ("flash_bwd_dq", grads[0], ref[0], (atol, rtol)),
                           ("flash_bwd_dk", grads[1], ref[1], (atol, rtol)),
                           ("flash_bwd_dv", grads[2], ref[2], (atol, rtol))]
        for name, got, want, tol in tol_checks:
            diff = (got.float() - want.float()).abs()
            errs[name] = diff.max().item()
            bound = tol[0] + tol[1] * want.float().abs()
            check(bool((diff <= bound).all()),
                  f"{name} {case}: max abs err {errs[name]} beyond atol "
                  f"{tol[0]} + rtol {tol[1]}")
        ratio = {}
        if rounded:
            o_r, _ = fa.block_fwd_reference(q, k, v, causal, sm, None,
                                            kv_valid, round_p=dtype)
            dq_r, dk_r, dv_r = fa.block_bwd_reference(
                q, k, v, o, lse, do, causal, sm, None, kv_valid,
                round_p=dtype)
            plain = {"o": o_r, "dq": dq_r, "dk": dk_r, "dv": dv_r}
            bounds = fa.rounding_bounds(plain, q, k, v, causal, sm, None,
                                        kv_valid, o3=o, lse=lse, do3=do)
            for name, key, got in (("flash_fwd", "o", o),
                                   ("flash_bwd_dq", "dq", grads[0]),
                                   ("flash_bwd_dk", "dk", grads[1]),
                                   ("flash_bwd_dv", "dv", grads[2])):
                errs[name] = (got.float() - plain[key].float()).abs().max() \
                    .item()
                ratio[key] = fa.bound_ratio(got, plain[key], bounds[key])
                check(ratio[key] <= 1.0, f"{name} {case}: {ratio[key]} of "
                      f"the rounding bound")
            if causal and lq == lk:
                # The control: every row sees one key more than it may.
                o_c, _ = fa.block_fwd_reference(q, k, v, causal, sm, 1,
                                                kv_valid, round_p=dtype)
                grads_c = fa.block_bwd_reference(
                    q, k, v, o, lse, do, causal, sm, 1, kv_valid,
                    round_p=dtype)
                ctl = {key: fa.bound_ratio(got, plain[key], bounds[key])
                       for key, got in zip(("o", "dq", "dk", "dv"),
                                           (o_c,) + grads_c)}
                controls.append([SHORT[dt], bh, lq, d] + [
                    float(f"{ctl[key]:.3g}")
                    for key in ("o", "dq", "dk", "dv")])
                check(min(ctl.values()) > 1.0, f"the off-by-one diagonal "
                      f"control {case} {ctl} is rejected by the bound")
            elif case in (BERT_FLASH_CASE, VIT_FLASH_CASE):
                # The non-causal control: every row misses its last key (at
                # ViT's L = 196, a key of the 4-key ragged tile).
                o_c, _ = fa.block_fwd_reference(q, k, v, causal, sm, None,
                                                lk - 1, round_p=dtype)
                grads_c = fa.block_bwd_reference(
                    q, k, v, o, lse, do, causal, sm, None, lk - 1,
                    round_p=dtype)
                ctl = {key: fa.bound_ratio(got, plain[key], bounds[key])
                       for key, got in zip(("o", "dq", "dk", "dv"),
                                           (o_c,) + grads_c)}
                key_controls.append([SHORT[dt], bh, lq, d] + [
                    float(f"{ctl[key]:.3g}")
                    for key in ("o", "dq", "dk", "dv")])
                check(min(ctl.values()) > 1.0, f"the last-key-dropped "
                      f"control {case} {ctl} is rejected by the bound")
                check(case != VIT_FLASH_CASE or min(ctl.values()) >= 10.0,
                      f"the last-key-dropped control at ViT's shape {ctl} "
                      f"fails the bound by 10x or more")
            for key, r in ratio.items():
                ratios[key] = max(ratios.get(key, 0.0), r)
        if causal and lq - lk > 0:
            n = lq - lk           # rows that see no key at all
            check(bool((o[:, :n] == 0).all() and (grads[0][:, :n] == 0).all()),
                  f"fully masked rows are exact zeros {case}")
        errs["flash_bwd_dkv"] = max(errs.pop("flash_bwd_dk"),
                                    errs.pop("flash_bwd_dv"))
        for name, e in errs.items():
            worst[name] = max(worst.get(name, 0.0), e)
        if case == MAIN_FLASH_CASE:
            main_err = dict(errs, bound_ratio=ratio)
        for path, path_case in PATH_FLASH_CASES.items():
            if case == path_case:
                path_err[path] = dict(errs, bound_ratio=ratio)
        rows.append([SHORT[dt], bh, lq, lk, d, int(causal), kv_valid, heads,
                     kvh] + [float(f"{errs[n]:.3g}") for n in
                             ("flash_fwd", "lse", "flash_bwd_dq",
                              "flash_bwd_dkv")]
                    + [float(f"{ratio[key]:.3g}") if ratio else None
                       for key in ("o", "dq", "dk", "dv")])
    check(main_err, f"the main path's shape {MAIN_FLASH_CASE} was checked")
    check(controls, "the off-by-one control ran")
    check(len(path_err) == len(PATH_FLASH_CASES) and len(key_controls) == 2,
          f"every path's shape was checked, with its control: "
          f"{sorted(path_err)}")
    emit({"phase": "flash_vs_plain", "cases": len(rows),
          "columns": ["dtype", "BH", "Lq", "Lk", "D", "causal", "kv_valid",
                      "heads", "kv_heads", "err_o", "err_lse", "err_dq",
                      "err_dkv", "bound_ratio_o", "bound_ratio_dq",
                      "bound_ratio_dk", "bound_ratio_dv"],
          "rows": rows, "max_abs_err": worst, "main_shape_err": main_err,
          "path_shape_err": path_err,
          "tolerance": {k: {"atol": a, "rtol": r}
                        for k, (a, r) in FLASH_TOL.items()},
          "lse_tolerance": {"atol": 1e-4, "rtol": 1e-5},
          "rounding_bound": {
              "form": "|kernel - plain| <= 2 ulp(|plain|) + c (u |A||B| "
                      "+ eta n [+ f]); f for dQ alone: gamma (P scale "
                      "(|dO||V|^T + rowsum |dO||O|)) |K|, gamma = D "
                      "fp32_sum_unit, the fp32 error of dP - delta where "
                      "the two cancel",
              "c": fa.ROUNDING_C, "fp32_sum_unit": fa.FP32_SUM_UNIT,
              "u": {str(t).split(".")[-1]: u
                    for t, u in fa.UNIT_ROUNDOFF.items()},
              "eta": {str(t).split(".")[-1]: e
                      for t, e in fa.SUBNORMAL_HALF_STEP.items()},
              "worst_ratio": ratios},
          "worst_dq_ratio": ratios.get("dq"),
          "off_by_one_control": {"columns": ["dtype", "BH", "L", "D",
                                             "ratio_o", "ratio_dq",
                                             "ratio_dk", "ratio_dv"],
                                 "rows": controls, "rejected": True},
          "last_key_dropped_control": {
              "columns": ["dtype", "BH", "L", "D", "ratio_o", "ratio_dq",
                          "ratio_dk", "ratio_dv"],
              "rows": key_controls, "rejected": True,
              "note": "the non-causal BERT and ViT shapes: a plain version "
                      "whose rows miss their last key (kv_valid = L - 1; "
                      "at ViT's, the 10x it must fail by)"},
          "reason": "fp32, and lse: kernel and plain both compute in "
                    "fp32 and round once; they sum in another order (~1e-6 "
                    "relative in fp32), which can flip the final rounding: "
                    "1e-4 relative in fp32 (lse 1e-5). bf16/fp16 o, dQ, dK, "
                    "dV: the tensor-core kernels round P and dS to the "
                    "input type before the product; held to the plain "
                    "versions that round at the same points, within one "
                    "rounding of an operand on each side",
          "fully_masked_rows_exact_zero": True})
    return main_err, path_err


def next_token_loss(F, logits, ids):
    return F.cross_entropy(logits[:, :-1].float().flatten(0, 1),
                           ids[:, 1:].flatten())


def build_gpt(torch, dev, seed):
    from horovod_tpu_torch.models import GPT
    model = GPT(gpt_config(torch, use_flash=True),
                generator=torch.Generator().manual_seed(seed))
    model = model.to(dev).train()
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == 163_109_376, f"GPT-2 small (lm_head untied) has "
          f"163,109,376 parameters, this model {n_params}")
    return model


FLASH_COUNTS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
READINGS = {}          # readings a later phase prints beside its own
STEP_COUNTS = FLASH_COUNTS + ("scale_pack", "scale_unpack")
ADAMW = "AdamW(lr={lr}, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)"


def train_steps(torch, hvd, model, loss, args, steps, flash, lr=None,
                opt=None, exact=True):
    """A transformer path's steps. With ``lr``: the launch counts zeroed
    (the path starts here), then AdamW(lr) in hvd.DistributedOptimizer
    after broadcast_parameters and broadcast_optimizer_state; with ``opt``,
    that optimizer goes on, the counts zeroed first too. --warmup and
    ``steps`` timed steps of ``loss()``, the last warm-up step checking the
    reduction (``exact``: bit-equal to the local gradients; a lossy
    compression checks its own); the counts are read right after (the path
    ends). Checks: finite, falling loss; ``flash`` (forward, dQ, dK/dV)
    launches every step; a pack and an unpack launch per fusion bucket
    every step. Returns the optimizer and the run's readings (``closed``:
    each step's buckets, as ``buckets_since`` gives them)."""
    from horovod_tpu_torch.ops.fusion import get_runtime
    from horovod_tpu_torch.ops.kernels import flash_attention as fa
    from horovod_tpu_torch.ops.kernels import scale_buffers as sb

    fa.reset_launch_counts()              # the path starts here
    sb.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    if opt is None:
        opt = torch.optim.AdamW(model.parameters(), lr=lr,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)
        opt = hvd.DistributedOptimizer(
            opt, named_parameters=model.named_parameters())
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        hvd.broadcast_optimizer_state(opt, root_rank=0)

    tally = KeptTableTally(sb)

    def counts():
        return (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches,
                sb.pack_launches, sb.unpack_launches) + tally.counts()

    def step():
        opt.zero_grad()
        value = loss()
        value.backward()
        opt.step()
        return value.detach()

    losses, per_step, closed, per_bucket = [], [], [], []
    with tally:
        for i in range(args.warmup + steps):
            if i == args.warmup:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            c0, m0 = counts(), get_runtime().flush_stats()
            losses.append(reduced_equals_local(torch, model, step)
                          if exact and i == args.warmup - 1 else step())
            per_step.append([b - a for a, b in zip(c0, counts())])
            got, row = buckets_since(m0)
            closed.append(got)
            per_bucket.append(row)
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(zip(STEP_COUNTS, counts()))     # the path ends
    tables = kept_table_report(per_step, args.warmup, 5)
    per_step = [s[:5] for s in per_step]
    losses = [l.item() for l in losses]
    buckets = [[n for _, n in sig[-1]] for _, sig in closed[-1]]
    check(all(map(math.isfinite, losses)), f"finite losses {losses}")
    check(losses[-1] < losses[0], f"loss falls: {losses}")
    check(all(s[:3] == list(flash) for s in per_step),
          f"{flash} fwd, dQ and dK/dV flash launches a step: {per_step}")
    # Buckets the timer closed included: each step's pack and unpack
    # launches are those of the buckets that closed in it.
    check(all(r[0] > 0 and s[3] == s[4] == scale_launches(c)
              for s, r, c in zip(per_step, per_bucket, closed)),
          f"a pack and an unpack launch per bucket (per 256 tensors) every "
          f"step: {per_step}, {per_bucket}")
    return opt, {
        "warmup": args.warmup, "steps": steps, "losses": losses,
        "step_ms": 1e3 * elapsed / steps, "elapsed": elapsed,
        "launches_per_step": per_step,
        "launches_per_step_columns": list(launches), "launches": launches,
        **tables, **step_buckets_report(per_bucket, args.warmup),
        "cycle_time_ms": get_runtime()._cycle_s * 1e3,
        "fp32_buckets_last_step": [{"tensors": len(b), "elements": sum(b)}
                                   for b in buckets],
        "reduced_equals_local_bitwise": exact,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "closed": closed}


def phase_train_gpt(torch, hvd, model, dev, args, card):
    import torch.nn.functional as F

    cfg = model.config
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device=dev).manual_seed(args.seed + 4)
    ids = torch.randint(0, cfg.vocab_size, (GPT_BATCH, GPT_SEQ),
                        generator=gen, device=dev)
    _, run = train_steps(torch, hvd, model,
                         lambda: next_token_loss(F, model(ids), ids), args,
                         GPT_STEPS, (cfg.num_layers,) * 3, lr=1e-4)
    elapsed = run.pop("elapsed")
    run.pop("closed")
    READINGS["train_gpt"] = {
        "tokens_per_sec": GPT_BATCH * GPT_SEQ * GPT_STEPS / elapsed,
        "launches_per_step": run["launches_per_step"]}
    emit({"phase": "train_gpt", "model": "GPT-2 small", "params": n_params,
          "batch": GPT_BATCH, "seq": GPT_SEQ, "dtype": "bfloat16",
          "param_dtype": "float32", "optimizer": ADAMW.format(lr=1e-4),
          **run,
          "tokens_per_sec": GPT_BATCH * GPT_SEQ * GPT_STEPS / elapsed,
          "fp32_products": "DEFAULT precision: TF32 (lm_head, forward "
                           "and backward)",
          "matmul_allow_tf32_outside_the_products":
              torch.backends.cuda.matmul.allow_tf32,
          "card": card})
    return model, ids, run["launches"]


# Limits of one GPT step with flash attention against the same step on
# plain attention (bf16 activations: plain attention rounds its scores to
# bf16 and its normalised probabilities; the bf16 kernels keep scores in
# fp32 and round P, and dS, before a product). Each sits between the
# reading of that sound pair and the readings of two deliberately wrong
# controls, which these limits must reject (see gpt_flash_vs_plain). Read
# on an NVIDIA H100 80GB HBM3 at 700 W as (loss_rel, grad_rel, attn_cos),
# with all three kernels on the tensor cores (dQ rounding dS too): seed 0:
# flash 6.4e-7, 1.15e-2 (lm_head), 0.9999944; not causal 0.176, 1.15,
# 0.43; dK and dV swapped 6.4e-7, 1.41, 0.14 (the swap leaves the forward,
# so only the gradients reject it). Seed 1: flash 2.2e-5, 1.16e-2,
# 0.9999939; not causal 0.191, 1.31, 0.35; swapped 2.2e-5, 1.41, 0.15. The
# loss reading is not the kernels' rounding of P and dS: the same step
# through the plain flash versions reads 1.5e-5 (seed 0) and 1.4e-5 (seed
# 1) rounding them as the kernels do, 2.6e-5 and 8.2e-6 in fp32, so it
# moves with the weights and data more than with that rounding.
GPT_CMP_LIMITS = {"loss_rel": 1e-4, "grad_rel": 3e-2, "attn_cos_min": 0.9999}


def phase_flash_vs_plain_model(torch, model, ids, dev):
    """One forward and backward of the trained model with flash attention
    against a copy on plain attention: same weights, same batch, no
    optimizer (and no gradient hooks) on any copy. Compared: the loss, each
    parameter's gradient (relative error of the whole tensor) and the
    cosine of the attention weights' gradient alone. Two controls go
    through the same comparison and must fail it: flash attention that is
    not causal (a wrong forward), and dK and dV swapped in the backward (a
    wrong backward that leaves the loss and every per-tensor gradient norm
    as they were)."""
    import torch.nn.functional as F

    from horovod_tpu_torch.models import GPT
    from horovod_tpu_torch.ops.kernels import flash_attention as fa
    from horovod_tpu_torch.parallel.tp import TPSelfAttention

    def run(use_flash, causal=True, ctx=contextlib.nullcontext):
        with torch.device(dev):
            m = GPT(gpt_config(torch, use_flash))
        m.load_state_dict(model.state_dict())
        for mod in m.modules():
            if isinstance(mod, TPSelfAttention):
                mod.causal = causal
        with ctx():
            loss = next_token_loss(F, m(ids), ids)
            loss.backward()
        return loss.item(), {n: p.grad for n, p in m.named_parameters()}

    lp, gp = run(use_flash=False)
    attn = [n for n in gp if ".attention." in n]

    def reading(lf, gf, lp=lp, gp=gp):
        rel = {n: ((gf[n] - gp[n]).norm() / gp[n].norm().clamp_min(1e-30))
               .item() for n in gp}
        worst = max(rel, key=rel.get)
        cos = F.cosine_similarity(torch.cat([gf[n].flatten() for n in attn]),
                                  torch.cat([gp[n].flatten() for n in attn]),
                                  dim=0).item()
        return {"loss": lf, "loss_rel": abs(lf - lp) / abs(lp),
                "grad_rel": rel[worst], "grad_rel_worst": worst,
                "attn_cos": cos}

    def within(r):
        return (r["loss_rel"] <= GPT_CMP_LIMITS["loss_rel"]
                and r["grad_rel"] <= GPT_CMP_LIMITS["grad_rel"]
                and r["attn_cos"] >= GPT_CMP_LIMITS["attn_cos_min"])

    flash_run = run(use_flash=True)
    flash = reading(*flash_run)
    rounding_run = run(use_flash=True,
                       ctx=functools.partial(plain_flash, True))
    # Readings, not checks: where the difference to plain attention comes
    # from. The same step through the plain flash versions, rounding as the
    # kernels do and not, each against plain attention, and the kernels
    # against the rounding one.
    sources = {"plain_flash_rounding": reading(*rounding_run),
               "plain_flash_fp32": reading(*run(
                   use_flash=True, ctx=functools.partial(plain_flash, False))),
               "flash_vs_plain_flash_rounding": reading(*flash_run,
                                                        *rounding_run)}
    controls = {"not_causal": reading(*run(use_flash=True, causal=False)),
                "swapped_dkv": reading(*run(use_flash=True,
                                            ctx=swapped_dkv))}
    emit({"phase": "gpt_flash_vs_plain", "loss_plain": lp, "flash": flash,
          "controls": controls, "sources": sources,
          "limits": GPT_CMP_LIMITS,
          "attention_tensors": len(attn),
          "note": "grad_rel: |g_flash - g_plain| / |g_plain| of the worst "
                  "parameter; attn_cos: cosine of the attention weights' "
                  "gradients alone; each control must fall outside the "
                  "limits"})
    check(within(flash), f"flash vs plain attention on one GPT step "
          f"{flash} within {GPT_CMP_LIMITS}")
    for name, r in controls.items():
        check(not within(r), f"control {name} {r} is rejected by the "
              f"limits {GPT_CMP_LIMITS}")


@contextlib.contextmanager
def swapped_dkv():
    """fa_backward with dK and dV swapped: a wrong backward that leaves the
    loss and every per-tensor gradient norm as they were."""
    from horovod_tpu_torch.ops.kernels import flash_attention as fa
    raw = fa.fa_backward

    def wrong(*a, **kw):
        dq, dk, dv = raw(*a, **kw)
        return dq, dv, dk
    fa.fa_backward = wrong
    try:
        yield
    finally:
        fa.fa_backward = raw


@contextlib.contextmanager
def plain_flash(rounding):
    """fa_forward and fa_backward replaced by their plain versions on the
    card (K/V repeated to the query heads under grouped-query attention),
    which round P (and dS) to the inputs' dtype where the bf16 kernels do,
    or keep them in fp32: to tell the kernels' rounding from the rest of the
    difference to plain attention."""
    from horovod_tpu_torch.ops.kernels import flash_attention as fa
    raw = fa.fa_forward, fa.fa_backward

    def fwd(q, k, v, causal, scale, q_offset=None, kv_valid=None,
            heads=None, kv_heads=None):
        if heads is not None and heads != kv_heads:
            b, g = q.shape[0] // heads, heads // kv_heads
            k = fa.gqa_repeat3(k, b, kv_heads, g)
            v = fa.gqa_repeat3(v, b, kv_heads, g)
        return fa.block_fwd_reference(
            q, k, v, causal, scale, q_offset, kv_valid,
            round_p=q.dtype if rounding else None)

    def bwd(q, k, v, o, lse, do, causal, scale, q_offset=None,
            kv_valid=None):
        return fa.block_bwd_reference(
            q, k, v, o, lse, do, causal, scale, q_offset, kv_valid,
            round_p=q.dtype if rounding else None)
    fa.fa_forward, fa.fa_backward = fwd, bwd
    try:
        yield
    finally:
        fa.fa_forward, fa.fa_backward = raw


def grad_readings(torch, F, run, limits, controls):
    """``run(use_flash, control)`` -> (loss, {name: grad}) of one forward
    and backward of a fresh copy of the model, ``control`` None or one of
    ``controls``, a deliberately wrong flash run. The flash run against the
    plain one: the loss's relative difference, the worst parameter's
    |g_flash - g_plain| / |g_plain| and the cosine of the attention
    weights' gradients; each control must fall outside ``limits``, the
    flash run inside."""
    lp, gp = run(False, None)
    attn = [n for n in gp if ".attention." in n]

    def reading(lf, gf, lp=lp, gp=gp):
        rel = {n: ((gf[n] - gp[n]).norm() / gp[n].norm().clamp_min(1e-30))
               .item() for n in gp}
        worst = max(rel, key=rel.get)
        cos = F.cosine_similarity(torch.cat([gf[n].flatten() for n in attn]),
                                  torch.cat([gp[n].flatten() for n in attn]),
                                  dim=0).item()
        return {"loss": lf, "loss_rel": abs(lf - lp) / abs(lp),
                "grad_rel": rel[worst], "grad_rel_worst": worst,
                "attn_cos": cos}

    def within(r):
        return (r["loss_rel"] <= limits["loss_rel"]
                and r["grad_rel"] <= limits["grad_rel"]
                and r["attn_cos"] >= limits["attn_cos_min"])

    flash_run = run(True, None)
    flash = reading(*flash_run)
    ctl = {name: reading(*run(True, name)) for name in controls}
    # A reading, not a check: the kernels against their plain versions
    # rounding P and dS as they do, through the same step.
    source = reading(*flash_run, *run(True, "plain_flash"))
    out = {"loss_plain": lp, "flash": flash, "controls": ctl,
           "flash_vs_plain_flash_rounding": source,
           "limits": limits, "attention_tensors": len(attn),
           "within": within(flash),
           "controls_rejected": {n: not within(r) for n, r in ctl.items()}}
    return out, within


def check_readings(name, out, within):
    emit({"phase": name, **out,
          "note": "grad_rel: |g_flash - g_plain| / |g_plain| of the worst "
                  "parameter; attn_cos: cosine of the attention weights' "
                  "gradients alone; each control must fall outside the "
                  "limits"})
    check(within(out["flash"]), f"{name}: flash vs plain attention "
          f"{out['flash']} within {out['limits']}")
    for ctl, r in out["controls"].items():
        check(not within(r), f"{name}: control {ctl} {r} is rejected by "
              f"the limits {out['limits']}")


def bert_config(torch, use_flash, **kw):
    from horovod_tpu_torch.models import BertConfig
    return BertConfig.large(dtype=torch.bfloat16, use_flash=use_flash, **kw)


def llama_config(torch, use_flash, **kw):
    from horovod_tpu_torch.models import LlamaConfig
    return LlamaConfig.bench(max_position_embeddings=LLAMA_SEQ,
                             dtype=torch.bfloat16, use_flash=use_flash, **kw)


def build_on(torch, dev, make, seed):
    """``make(generator)`` built on ``dev``, its weights drawn there from
    ``seed``."""
    with torch.device(dev):
        return make(torch.Generator(device=dev).manual_seed(seed)).train()


def bert_loss(F, model, batch):
    """bench.py's pre-training loss: mean MLM plus mean NSP cross-entropy."""
    ids, labels, nsp = batch
    mlm, ns = model(ids)
    return F.cross_entropy(mlm.flatten(0, 1), labels.flatten()) \
        + F.cross_entropy(ns, nsp)


def phase_train_bert(torch, hvd, dev, args, card):
    """BERT-Large (MLM + NSP) at full width and depth, bf16, flash, on
    32 x 128 token ids, MLM and NSP labels from --seed; no padding mask,
    deterministic (dropout off). AdamW(lr=1e-5)."""
    import torch.nn.functional as F

    from horovod_tpu_torch.models import BertForPreTraining
    model = build_on(torch, dev, lambda g: BertForPreTraining(
        bert_config(torch, True), generator=g), args.seed)
    cfg = model.config
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == BERT_PARAMS, f"BERT-Large has {BERT_PARAMS:,} "
          f"parameters, this model {n_params}")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 6)
    batch = (torch.randint(0, cfg.vocab_size, (BERT_BATCH, BERT_SEQ),
                           generator=gen, device=dev),
             torch.randint(0, cfg.vocab_size, (BERT_BATCH, BERT_SEQ),
                           generator=gen, device=dev),
             torch.randint(0, 2, (BERT_BATCH,), generator=gen, device=dev))
    _, run = train_steps(torch, hvd, model,
                         lambda: bert_loss(F, model, batch), args,
                         BERT_STEPS, (cfg.num_layers,) * 3, lr=1e-5)
    elapsed = run.pop("elapsed")
    run.pop("closed")
    emit({"phase": "train_bert", "model": "BERT-Large (MLM + NSP)",
          "params": n_params, "batch": BERT_BATCH, "seq": BERT_SEQ,
          "dtype": "bfloat16", "param_dtype": "float32",
          "attention": "flash, non-causal; no padding mask, deterministic",
          "optimizer": ADAMW.format(lr=1e-5), **run,
          "sequences_per_sec": BERT_BATCH * BERT_STEPS / elapsed,
          "card": card})
    return model, batch, run["launches"]


# Limits of one step with flash attention against the same step on the
# model's plain attention path, for BERT-Large (bert.py's own plain path:
# bf16 score products, an fp32 softmax, probabilities rounded to bf16) and
# LLaMA-400M (plain attention with K/V repeated), at the weights the main
# path ends with. Like GPT_CMP_LIMITS, each sits between the readings of
# the sound pair and those of the controls, which must fall outside. Read
# on an NVIDIA H100 80GB HBM3 at 700 W as (loss_rel, grad_rel, attn_cos),
# seeds 0, 1 and 2. BERT: flash 4.8e-5 / 2.2e-5 / 8.2e-5, 0.025 / 0.021 /
# 0.019, >= 0.9998; causal flash 5.1e-4 / 3.2e-4 / 6.6e-4, 8.5-9.2,
# 0.89-0.97; dK and dV swapped 1.6-2.0, 0.18-0.21. LLaMA: flash 1.7e-4 /
# 4.6e-7 / 5.0e-4, 0.034-0.035, ~0.9999; not causal 1.7-1.9, 1.4,
# <= 0.012; dK and dV swapped 1.2, 0.11-0.12. The step through the plain
# flash versions rounding as the kernels do reads 3.4e-7 to 7.4e-5 in the
# loss and 0.021-0.030 in the worst gradient against the kernels: most of
# the loss's difference is plain attention's own rounding, and the
# gradients' is the propagation of bf16 rounding through 24 layers.
BERT_CMP_LIMITS = {"loss_rel": 3e-4, "grad_rel": 0.1, "attn_cos_min": 0.999}
LLAMA_CMP_LIMITS = {"loss_rel": 2e-3, "grad_rel": 0.1, "attn_cos_min": 0.999}


def phase_bert_flash_vs_plain(torch, model, batch, dev):
    """One forward and backward of the trained BERT with flash attention
    against a copy on bert.py's plain path (same weights, same batch, no
    optimizer); controls: flash with causal masking switched on, and dK
    and dV swapped in the backward."""
    import torch.nn.functional as F

    from horovod_tpu_torch.models import BertForPreTraining
    from horovod_tpu_torch.models import bert as bert_mod

    @contextlib.contextmanager
    def causal():
        raw = bert_mod.flash_attention
        bert_mod.flash_attention = lambda q, k, v, causal=False: raw(
            q, k, v, causal=True)
        try:
            yield
        finally:
            bert_mod.flash_attention = raw

    controls = {"causal": causal, "swapped_dkv": swapped_dkv}
    contexts = dict(controls, plain_flash=functools.partial(plain_flash,
                                                            True))

    def run(use_flash, control):
        with torch.device(dev):
            m = BertForPreTraining(bert_config(torch, use_flash))
        m.load_state_dict(model.state_dict())
        with contexts.get(control, contextlib.nullcontext)():
            loss = bert_loss(F, m, batch)
            loss.backward()
        return loss.item(), {n: p.grad for n, p in m.named_parameters()}

    check_readings("bert_flash_vs_plain", *grad_readings(
        torch, F, run, BERT_CMP_LIMITS, controls))


def phase_train_llama(torch, hvd, dev, args, card):
    """LLaMA-400M (bench.py's config at 1024 positions) at full width and
    depth, bf16, flash with grouped-query K/V, on 8 x 1024 token ids from
    --seed, next-token loss, AdamW(lr=1e-4). Then remat on the trained
    weights and batch: one step of a copy without and one with remat
    (gradients equal bit for bit, 24 more forward launches, peak memory of
    each), and the same model and optimizer trained on with remat."""
    import dataclasses

    import torch.nn.functional as F

    from horovod_tpu_torch.models import Llama
    from horovod_tpu_torch.ops.kernels import flash_attention as fa
    model = build_on(torch, dev, lambda g: Llama(
        llama_config(torch, True), generator=g), args.seed)
    cfg = model.config
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == LLAMA_PARAMS, f"LLaMA-400M at {LLAMA_SEQ} positions "
          f"has {LLAMA_PARAMS:,} parameters, this model {n_params}")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 7)
    ids = torch.randint(0, cfg.vocab_size, (LLAMA_BATCH, LLAMA_SEQ),
                        generator=gen, device=dev)
    layers = cfg.num_layers
    opt, run = train_steps(torch, hvd, model,
                           lambda: next_token_loss(F, model(ids), ids), args,
                           LLAMA_STEPS, (layers,) * 3, lr=1e-4)
    tokens = LLAMA_BATCH * LLAMA_SEQ
    elapsed = run.pop("elapsed")
    run.pop("closed")
    run["tokens_per_sec"] = tokens * LLAMA_STEPS / elapsed

    # Remat: one step of fresh copies on the trained weights, no optimizer.
    one = {}
    for remat in (False, True):
        with torch.device(dev):
            m = Llama(llama_config(torch, True, remat=remat))
        m.load_state_dict(model.state_dict())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fa.reset_launch_counts()
        next_token_loss(F, m(ids), ids).backward()
        torch.cuda.synchronize()
        one[remat] = {
            "launches": [fa.fwd_launches, fa.bwd_dq_launches,
                         fa.bwd_dkv_launches],
            "peak_mem_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
            "grads": {n: p.grad for n, p in m.named_parameters()}}
        del m
    off, on = one[False], one[True]
    check(off["launches"] == [layers] * 3, f"{layers} launches of each flash "
          f"kernel without remat: {off['launches']}")
    check(on["launches"] == [2 * layers, layers, layers],
          f"remat: {2 * layers} forward launches ({layers} recomputed), "
          f"{layers} dQ and {layers} dK/dV: {on['launches']}")
    unequal = [n for n in off["grads"]
               if not torch.equal(off["grads"][n], on["grads"][n])]
    check(not unequal, f"remat gradients equal those without, bit for bit: "
          f"{unequal[:5]}")
    check(on["peak_mem_gb"] < off["peak_mem_gb"],
          f"remat lowers the step's peak memory: {on['peak_mem_gb']} vs "
          f"{off['peak_mem_gb']} GB")
    del one, off["grads"], on["grads"]

    # The same model and optimizer trained on with remat; the weights of the
    # main path's end are kept for llama_flash_vs_plain.
    trained = {k: v.detach().clone() for k, v in model.state_dict().items()}
    model.config = dataclasses.replace(cfg, remat=True)
    _, remat_run = train_steps(torch, hvd, model,
                               lambda: next_token_loss(F, model(ids), ids),
                               args, LLAMA_STEPS,
                               (2 * layers, layers, layers), opt=opt)
    model.config = cfg
    remat_elapsed = remat_run.pop("elapsed")
    remat_run.pop("closed")
    remat_run["tokens_per_sec"] = tokens * LLAMA_STEPS / remat_elapsed
    gqa = gqa_copy_ms(torch, fa, dev, layers)
    emit({"phase": "train_llama", "model": "LLaMA-400M (bench config)",
          "params": n_params, "batch": LLAMA_BATCH, "seq": LLAMA_SEQ,
          "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
          "dtype": "bfloat16", "param_dtype": "float32",
          "attention": "flash, causal, grouped-query K/V",
          "optimizer": ADAMW.format(lr=1e-4), **run,
          "remat_one_step": {
              "launches_without": off["launches"],
              "launches_with": on["launches"],
              "grads_bit_equal": True,
              "peak_mem_gb_without": off["peak_mem_gb"],
              "peak_mem_gb_with": on["peak_mem_gb"],
              "peak_mem_note": "the step's peak of allocated memory above "
                               "what was allocated before it (the weights "
                               "of its copy and what earlier phases hold)"},
          "remat_training": {k: remat_run[k] for k in (
              "steps", "losses", "step_ms", "tokens_per_sec",
              "launches_per_step", "buckets_timer_new_signatures_per_step",
              "peak_mem_gb")},
          "gqa_backward_repeat_fold": gqa, "card": card})
    return trained, ids, run["launches"]


def gqa_copy_ms(torch, fa, dev, layers):
    """Device ms a step of the GQA backward's copies at the LLaMA path's
    shapes (unchecked): K and V repeated to the query heads, dK and dV
    group-summed back, for every layer; CUDA events, median of 10."""
    _, bh, L, _, d, _, _, h, kvh = LLAMA_FLASH_CASE
    b, g = bh // h, h // kvh
    gen = torch.Generator(device=dev).manual_seed(17)
    k, v = (torch.randn(b * kvh, L, d, generator=gen, device=dev)
            .bfloat16() for _ in range(2))
    dk, dv = (torch.randn(bh, L, d, generator=gen, device=dev).bfloat16()
              for _ in range(2))

    def copies():
        for _ in range(layers):
            fa.gqa_repeat3(k, b, kvh, g).contiguous()
            fa.gqa_repeat3(v, b, kvh, g).contiguous()
            fa.gqa_fold3(dk, b, kvh, g)
            fa.gqa_fold3(dv, b, kvh, g)
    nbytes = layers * 2 * (bh + b * kvh) * L * d * 2 * 2
    ms = event_ms(copies, reps=10)
    return {"ms_per_step": ms, "layers": layers, "group": g,
            "bytes_per_step": nbytes,
            "bytes_bound_ms": 1e3 * nbytes / H100_BYTES_PER_S,
            "note": "K and V repeated (gqa_repeat3 + contiguous) and dK, dV "
                    "folded (gqa_fold3) for every layer; bytes: each copy's "
                    "reads and writes once"}


def phase_llama_flash_vs_plain(torch, state, ids, dev):
    """One forward and backward of LLaMA at the weights ``state`` (the main
    path's, before remat trains on) with flash attention against a copy on
    plain attention with K/V repeated; controls: flash without causal
    masking, and dK and dV swapped in the backward."""
    import torch.nn.functional as F

    from horovod_tpu_torch.models import Llama
    from horovod_tpu_torch.parallel.tp import TPSelfAttention

    def run(use_flash, control):
        with torch.device(dev):
            m = Llama(llama_config(torch, use_flash))
        m.load_state_dict(state)
        for mod in m.modules():
            if isinstance(mod, TPSelfAttention):
                mod.causal = control != "not_causal"
        ctx = {"swapped_dkv": swapped_dkv,
               "plain_flash": functools.partial(plain_flash, True)}.get(
                   control, contextlib.nullcontext)
        with ctx():
            loss = next_token_loss(F, m(ids), ids)
            loss.backward()
        return loss.item(), {n: p.grad for n, p in m.named_parameters()}

    check_readings("llama_flash_vs_plain", *grad_readings(
        torch, F, run, LLAMA_CMP_LIMITS, ("not_causal", "swapped_dkv")))


def vit_config(torch, use_flash, **kw):
    from horovod_tpu_torch.models import ViTConfig
    return ViTConfig.base(dtype=torch.bfloat16, use_flash=use_flash, **kw)


def vit_loss(F, model, batch):
    images, labels = batch
    return F.cross_entropy(model(images), labels)


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_events(torch, step, steps):
    """torch.profiler over ``steps`` calls of ``step``: the device's kernels
    and copies, and the window's span in us."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    events = list(prof.events())
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    check(device, "torch.profiler recorded device time")
    return device, (max(e.time_range.end for e in events)
                    - min(e.time_range.start for e in events))


def device_ms(torch, step, steps=2, launches=False):
    """The device's busy ms a step under torch.profiler (the union of its
    kernels' and copies' intervals) and its busy share of the window; with
    ``launches``, also the device's kernels and copies a step."""
    device, span = device_events(torch, step, steps)
    busy = busy_us((e.time_range.start, e.time_range.end) for e in device)
    if launches:
        return busy / 1e3 / steps, busy / span, len(device) / steps
    return busy / 1e3 / steps, busy / span


def phase_train_vit(torch, hvd, dev, args, card):
    """ViT-B/16 at full width and depth, bf16, flash (non-causal, L = 196),
    on 128 bf16 images and labels from --seed, AdamW(lr=1e-4). Then remat
    on the trained weights and batch: one step of a copy without and one
    with (gradients equal bit for bit, 12 more forward launches, peak
    memory of each); then the model and optimizer timed on, with and
    without remat: images/s (the median of repeats), the device's busy ms
    a step (torch.profiler) and the peak of allocated memory."""
    import dataclasses

    import torch.nn.functional as F

    from horovod_tpu_torch.models import ViT
    from horovod_tpu_torch.ops.kernels import flash_attention as fa
    model = build_on(torch, dev, lambda g: ViT(vit_config(torch, True),
                                               generator=g), args.seed)
    cfg = model.config
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == VIT_PARAMS, f"ViT-B/16 has {VIT_PARAMS:,} parameters, "
          f"this model {n_params}")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 8)
    batch = (torch.randn((VIT_BATCH, VIT_IMAGE, VIT_IMAGE, 3), generator=gen,
                         device=dev).to(torch.bfloat16),
             torch.randint(0, cfg.num_classes, (VIT_BATCH,), generator=gen,
                           device=dev))
    layers = cfg.num_layers
    opt, run = train_steps(torch, hvd, model,
                           lambda: vit_loss(F, model, batch), args,
                           VIT_STEPS, (layers,) * 3, lr=1e-4)
    run["images_per_sec"] = VIT_BATCH * VIT_STEPS / run.pop("elapsed")
    run.pop("closed")
    trained = {k: v.detach().clone() for k, v in model.state_dict().items()}

    one = {}
    for remat in (False, True):
        with torch.device(dev):
            m = ViT(vit_config(torch, True, remat=remat))
        m.load_state_dict(trained)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fa.reset_launch_counts()
        vit_loss(F, m, batch).backward()
        torch.cuda.synchronize()
        one[remat] = {
            "launches": [fa.fwd_launches, fa.bwd_dq_launches,
                         fa.bwd_dkv_launches],
            "peak_mem_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
            "grads": {n: p.grad for n, p in m.named_parameters()}}
        del m
    off, on = one[False], one[True]
    check(off["launches"] == [layers] * 3, f"{layers} launches of each flash "
          f"kernel without remat: {off['launches']}")
    check(on["launches"] == [2 * layers, layers, layers],
          f"remat: {2 * layers} forward launches, {layers} dQ and {layers} "
          f"dK/dV: {on['launches']}")
    unequal = [n for n in off["grads"]
               if not torch.equal(off["grads"][n], on["grads"][n])]
    check(not unequal, f"remat gradients equal those without, bit for bit: "
          f"{unequal[:5]}")
    check(on["peak_mem_gb"] < off["peak_mem_gb"],
          f"remat lowers the step's peak memory: {on['peak_mem_gb']} vs "
          f"{off['peak_mem_gb']} GB")
    del one, off["grads"], on["grads"]

    def step():
        opt.zero_grad()
        vit_loss(F, model, batch).backward()
        opt.step()

    timed = {}
    for remat in (False, True):
        model.config = dataclasses.replace(cfg, remat=remat)
        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rates = []
        for _ in range(VIT_REPEATS):
            t0 = time.perf_counter()
            for _ in range(VIT_REPEAT_STEPS):
                step()
            torch.cuda.synchronize()
            rates.append(VIT_BATCH * VIT_REPEAT_STEPS
                         / (time.perf_counter() - t0))
        busy_ms, busy_share = device_ms(torch, step)
        q1, med, q3 = statistics.quantiles(rates, n=4)
        timed["remat" if remat else "no_remat"] = {
            "images_per_sec_median": statistics.median(rates),
            "images_per_sec_q1_q3": [q1, q3], "images_per_sec": rates,
            "device_busy_ms_per_step": busy_ms,
            "device_busy_share": busy_share,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    model.config = cfg
    emit({"phase": "train_vit", "model": "ViT-B/16", "params": n_params,
          "batch": VIT_BATCH, "image": [VIT_IMAGE, VIT_IMAGE, 3],
          "tokens": VIT_SEQ, "dtype": "bfloat16", "param_dtype": "float32",
          "attention": "flash, non-causal, L = 196 (the last key tile "
                       "holds 4 keys)",
          "optimizer": ADAMW.format(lr=1e-4), **run,
          "remat_one_step": {
              "launches_without": off["launches"],
              "launches_with": on["launches"], "grads_bit_equal": True,
              "peak_mem_gb_without": off["peak_mem_gb"],
              "peak_mem_gb_with": on["peak_mem_gb"],
              "peak_mem_note": "the step's peak of allocated memory above "
                               "what was allocated before it"},
          "timed": timed,
          "timed_note": f"{VIT_REPEATS} repeats of {VIT_REPEAT_STEPS} steps "
                        "of the trained model and optimizer (host clock to "
                        "a synchronize); device_busy: torch.profiler over 2 "
                        "steps, the union of the device's kernel and copy "
                        "intervals; peak: allocated memory over the "
                        "repeats, weights and optimizer state included",
          "card": card})
    return trained, batch, run["launches"]


# Limits of one ViT-B/16 step with flash attention against the same step on
# plain attention (plain_attention: fp32 scores' softmax, probabilities
# rounded to bf16), at the weights the main path ends with; like
# BERT_CMP_LIMITS they sit between the sound pair's readings and the
# controls' (flash masked causally; dK and dV swapped), which must fall
# outside. Read on an NVIDIA H100 80GB HBM3 at 700 W as (loss_rel,
# grad_rel, attn_cos), seeds 0, 1 and 2: flash 7.3e-5 / 4.6e-5 / 3.7e-5,
# 0.0071 / 0.0068 / 0.0071 (patch_embed), >= 0.999997; causal flash
# 2.42 / 2.17 / 3.17, 4.6 / 4.1 / 5.0, 0.50 / 0.58 / 0.48; dK and dV
# swapped 1.413-1.416, <= 0.146. The step through the plain flash versions
# rounding as the kernels do reads 9.0e-6 to 9.2e-5 in the loss and
# 0.0067-0.0069 in the worst gradient against the kernels.
VIT_CMP_LIMITS = {"loss_rel": 3e-4, "grad_rel": 0.05, "attn_cos_min": 0.9999}


def phase_vit_flash_vs_plain(torch, state, batch, dev):
    """One forward and backward of ViT-B/16 at the weights ``state`` with
    flash attention against a copy on plain attention (same weights, same
    batch, no optimizer); controls: flash masked causally, and dK and dV
    swapped in the backward."""
    import torch.nn.functional as F

    from horovod_tpu_torch.models import ViT
    from horovod_tpu_torch.parallel.tp import TPSelfAttention

    def run(use_flash, control):
        with torch.device(dev):
            m = ViT(vit_config(torch, use_flash))
        m.load_state_dict(state)
        for mod in m.modules():
            if isinstance(mod, TPSelfAttention):
                mod.causal = control == "causal"
        ctx = {"swapped_dkv": swapped_dkv,
               "plain_flash": functools.partial(plain_flash, True)}.get(
                   control, contextlib.nullcontext)
        with ctx():
            loss = vit_loss(F, m, batch)
            loss.backward()
        return loss.item(), {n: p.grad for n, p in m.named_parameters()}

    check_readings("vit_flash_vs_plain", *grad_readings(
        torch, F, run, VIT_CMP_LIMITS, ("causal", "swapped_dkv")))


def phase_collectives(torch, hvd, dev):
    """The rest of the collective surface at 1 rank over NCCL, on CUDA
    tensors in fp32 and bf16, each against what the JAX package's
    semantics give at n = 1, every tensor output on the card: ragged
    allgather (a 0-d tensor and a group too), alltoall with and without
    splits, reducescatter Sum and Average with a prescale and a postscale
    (the pack rounds x * prescale once, the unpack y * postscale / n once:
    bit-equal to that) and grouped (one pack and one unpack launch),
    allgather_object, sparse_allreduce_async and join(), which returns 0.
    Returns the scale kernels' launches."""
    from horovod_tpu_torch.ops.kernels import scale_buffers as sb
    gen = torch.Generator(device=dev).manual_seed(23)
    sb.reset_launch_counts()                # the collectives path starts
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn(6, 5, generator=gen, device=dev).to(dt)
        outs = {"allgather": hvd.allgather(x),
                "allgather_0d": hvd.allgather(x[0, 0]),
                "alltoall": hvd.alltoall(x)}
        out, received = hvd.alltoall(x, splits=[4])
        outs.update(alltoall_splits=out, received_splits=received)
        check(torch.equal(outs["allgather"], x)
              and torch.equal(outs["allgather_0d"], x[0, :1])
              and torch.equal(outs["alltoall"], x)
              and torch.equal(out, x[:4])
              and received.tolist() == [4] and received.dtype == torch.int64,
              f"allgather and alltoall at 1 rank, {dt}")
        group = [x, x[:2, :3].contiguous() * 2,
                 torch.randn(5, 7, generator=gen, device=dev).to(dt)]
        p0, u0 = sb.pack_launches, sb.unpack_launches
        for op, pre, post in ((hvd.Sum, 1.0, 1.0), (hvd.Average, 0.5, 3.0)):
            got = hvd.grouped_reducescatter(group, op=op, prescale_factor=pre,
                                            postscale_factor=post)
            want = [((t.float() * pre).to(dt).float() * post).to(dt)
                    for t in group]
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"grouped reducescatter {op} at 1 rank, {dt}: bit-equal "
                  f"to one rounding of x * prescale and of y * postscale")
            outs[f"reducescatter_{op.name.lower()}"] = got[0]
        check((sb.pack_launches - p0, sb.unpack_launches - u0) == (2, 2),
              f"one pack and one unpack launch per grouped reducescatter, "
              f"{dt}")
        ragged = [h.synchronize() for h in hvd.grouped_allgather_async(
            [x[:3], x[:0]])]
        check(torch.equal(ragged[0], x[:3]) and ragged[1].shape == (0, 5),
              f"grouped_allgather_async at 1 rank, {dt}")
        dense = torch.where(x.float() > 0.5, x.float(), 0.0)
        sparse = hvd.sparse_allreduce_async(dense.to_sparse_coo(), name="sp",
                                            op=hvd.Average)
        got = hvd.synchronize(sparse)
        check(got.is_sparse and torch.equal(got.coalesce().to_dense(), dense),
              f"sparse_allreduce_async at 1 rank, {dt}")
        outs["sparse"] = got
        check(all(t.is_cuda for t in outs.values()),
              f"every output on the card: "
              f"{[k for k, t in outs.items() if not t.is_cuda]}")
        rows[str(dt)] = sorted(outs)
    obj = {"rank": hvd.rank(), "x": [1, 2]}
    check(hvd.allgather_object(obj) == [obj], "allgather_object at 1 rank")
    joined = hvd.join()
    check(joined == 0, f"join() at 1 rank returns 0, got {joined}")
    launches = {"scale_pack": sb.pack_launches,
                "scale_unpack": sb.unpack_launches}   # the path ends
    emit({"phase": "collectives", "ranks": hvd.size(),
          "backend": "gloo" if hvd.gloo_enabled() else "nccl",
          "checked": rows, "allgather_object": True, "join": joined,
          "launches": launches,
          "note": "1 rank over NCCL: every result equals what the JAX "
                  "package's semantics give at n = 1; the grouped "
                  "reducescatter packs its tensors rank-major with the "
                  "prescale (one launch), reduce-scatters once and unpacks "
                  "with the postscale (one launch)"})
    return launches


def phase_precision(torch, dev, seed):
    """The lm_head's product at full shape (8192 x 768 -> 50304, fp32)
    through the port's Dense at DEFAULT precision, forward and both
    backward products, against float64: each within the TF32 bound
    c 2^-11 |a| |b| (c from the product's depth, printed), on positive
    inputs, where the bound is tight, and on signed ones; a bf16 product,
    the control, must fail the forward's bound. The same layer at
    "highest", and the TF32 flags before and after, show where TF32 ran.
    Then the times of DEFAULT and "highest", forward and forward+backward,
    in this call."""
    from horovod_tpu_torch.parallel.tp import Dense
    m, k, n = GPT_BATCH * GPT_SEQ, GPT_HIDDEN, GPT_VOCAB
    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    layer = Dense(k, n, use_bias=False).to(dev)
    rows = {}
    for data in ("positive", "signed"):
        draw = torch.rand if data == "positive" else torch.randn
        x = draw(m, k, generator=gen, device=dev)
        w = draw(n, k, generator=gen, device=dev) / k ** 0.5
        gy = draw(m, n, generator=gen, device=dev)
        with torch.no_grad():
            layer.weight.copy_(w)
        row = {}
        for p in (None, "highest"):
            layer.precision = p
            layer.weight.grad = None
            xg = x.clone().requires_grad_()
            y = layer(xg)
            y.backward(gy)
            torch.cuda.synchronize()
            check((torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32) == flags,
                  f"the TF32 flags are as they were after precision {p}")
            row[p or "default"] = {
                "forward": tf32_ratio(y, x, w.T),
                "grad_input": tf32_ratio(xg.grad, gy, w),
                "grad_weight": tf32_ratio(layer.weight.grad, gy.T, x)}
            del y, xg
        row["bf16_control_forward"] = tf32_ratio(
            (x.bfloat16() @ w.bfloat16().T).float(), x, w.T)
        rows[data] = row
        del x, w, gy
    c = {"forward": tf32_product_c(k), "grad_input": tf32_product_c(n),
         "grad_weight": tf32_product_c(m)}
    for data, row in rows.items():
        for what, limit in c.items():
            check(row["default"][what] <= limit, f"{data} {what} at DEFAULT "
                  f"({row['default'][what]}) within c = {limit}")
    check(rows["positive"]["bf16_control_forward"] > c["forward"],
          f"the bf16 control ({rows['positive']['bf16_control_forward']}) "
          f"fails the forward's bound c = {c['forward']}")
    check(rows["positive"]["default"]["forward"]
          > 4 * rows["positive"]["highest"]["forward"],
          "the DEFAULT forward carries TF32's error, not fp32's: "
          f"{rows['positive']}")
    x = torch.randn(m, k, generator=gen, device=dev)
    gy = torch.randn(m, n, generator=gen, device=dev)
    ms = {}
    for p in (None, "highest", None, "highest"):
        layer.precision = p
        xg = x.clone().requires_grad_()

        def fwd_bwd():
            layer(xg).backward(gy)
        key = p or "default"
        ms.setdefault(f"{key}_forward_ms", []).append(
            event_ms(lambda: layer(x), reps=10))
        ms.setdefault(f"{key}_forward_backward_ms", []).append(
            event_ms(fwd_bwd, reps=10))
    layer.precision = None
    flops = 2 * m * k * n
    emit({"phase": "precision", "shape": {"tokens": m, "hidden": k,
                                          "vocab": n},
          "ratio_units": "max |y - float64| / (2^-11 |a| |b|)",
          "c": c, "ratios": rows, "ms": ms,
          "default_forward_tflops": flops / min(ms["default_forward_ms"])
          / 1e9,
          "highest_forward_tflops": flops / min(ms["highest_forward_ms"])
          / 1e9,
          "flags_unchanged": True,
          "note": "c = 4 + 2^-9 + (k + 1) 2^-13: each operand rounded to "
                  "TF32 (truncated at worst), k fp32 additions in any "
                  "order; positive inputs make the bound tight, where the "
                  "bf16 control's rounding of its output (up to 8 units) "
                  "must exceed it; ms: CUDA events, median of 10, DEFAULT "
                  "and highest in turns"})
    return ms


def flash_work(bh, lq, lk, d, itemsize, causal=True, bh_kv=None):
    """Operations and bytes of each kernel, counting the visible (query,
    key) pairs only (all of them when not causal) and each input and output
    once; ``bh_kv`` the forward's narrow K/V rows under grouped-query
    attention (the backward kernels take them repeated to ``bh``)."""
    if causal:
        pairs = bh * sum(min(lk, max(0, i + lk - lq + 1)) for i in range(lq))
    else:
        pairs = bh * lq * lk
    t_q, t_k = bh * lq * d * itemsize, bh * lk * d * itemsize
    t_kv = (bh if bh_kv is None else bh_kv) * lk * d * itemsize
    row = bh * lq * 4                       # an fp32 value per query row
    return {"flash_fwd": (4 * d * pairs, t_q + 2 * t_kv + t_q + row),
            "flash_bwd_dq": (6 * d * pairs, 2 * t_q + 2 * t_k + 2 * row
                             + t_q),
            "flash_bwd_dkv": (8 * d * pairs, 2 * t_q + 2 * t_k + 2 * row
                              + 2 * t_k)}


def flash_timing(torch, dev, seed, b, h, kvh, L, d, causal):
    """Each flash kernel alone at (B, H over KVH, L, D), bf16, launched
    directly (no wrapper's host work between launches, which at BERT's
    short rows outlasts the kernel): the forward on the narrow K/V, the
    backward kernels on K/V repeated to the query heads, as the path calls
    them;
    their plain versions; scaled_dot_product_attention (enable_gqa where
    KVH < H), forward and backward alone, for timing only. Rows with the
    bound, and SDPA's times."""
    from horovod_tpu_torch.ops.kernels import flash_attention as fa
    bh, sm, dt = b * h, d ** -0.5, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(bh, L, d, generator=gen, device=dev).to(dt)
             for _ in range(2))
    k, v = (torch.randn(b * kvh, L, d, generator=gen, device=dev).to(dt)
            for _ in range(2))
    heads = (h, kvh) if kvh != h else (None, None)
    o, lse = fa.fa_forward(q, k, v, causal, sm, None, None, *heads)
    km, vm = ((fa.gqa_repeat3(t, b, kvh, h // kvh).contiguous()
               for t in (k, v)) if kvh != h else (k, v))
    delta = (do.float() * o.float()).sum(-1)
    dq, dk, dv = (torch.empty_like(t) for t in (q, km, vm))
    ptrs = (q.data_ptr(), km.data_ptr(), vm.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    common = (L, d, 0, L, int(causal), sm, 2)
    groups = (h, kvh) if kvh != h else (1, 1)
    ms = {
        "flash_fwd": event_ms(lambda: fa._launch(
            "hvd_flash_fwd", dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), bh, L, *common[:5], sm, *groups,
            2),
            reps=20, inner=5),
        "flash_bwd_dq": event_ms(lambda: fa._launch(
            "hvd_flash_bwd_dq", dev, *ptrs, dq.data_ptr(), bh, L, *common),
            reps=20, inner=5),
        "flash_bwd_dkv": event_ms(lambda: fa._launch(
            "hvd_flash_bwd_dkv", dev, *ptrs, dk.data_ptr(), dv.data_ptr(),
            bh, L, *common), reps=20, inner=5),
    }
    plain_fwd = event_ms(lambda: fa.block_fwd_reference(q, km, vm, causal,
                                                        sm), reps=10)
    plain_bwd = event_ms(lambda: fa.block_bwd_reference(
        q, km, vm, o, lse, do, causal, sm), reps=10)
    q4 = q.view(b, h, L, d).detach().requires_grad_()
    k4, v4 = (t.view(b, kvh, L, d).detach().requires_grad_() for t in (k, v))
    gqa = {"enable_gqa": True} if kvh != h else {}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_fwd = event_ms(lambda: sdpa(q4, k4, v4, is_causal=causal, **gqa),
                        reps=20, inner=5)
    out4 = sdpa(q4, k4, v4, is_causal=causal, **gqa)
    do4 = do.view(b, h, L, d)
    sdpa_bwd = event_ms(lambda: torch.autograd.grad(
        out4, (q4, k4, v4), do4, retain_graph=True), reps=20, inner=5)
    work = flash_work(bh, L, L, d, 2, causal, b * kvh)
    rows = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
        rows[name] = {
            "ms": ms[name], "flops": flops, "bytes": nbytes,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "plain_ms": plain_fwd if name == "flash_fwd" else plain_bwd,
            "library_ms": sdpa_fwd if name == "flash_fwd" else sdpa_bwd,
            "tflops": flops / ms[name] / 1e9,
            "bound_share": 1e3 * max(t_ops, t_bytes) / ms[name]}
        if name != "flash_fwd":
            rows[name]["plain_and_library_cover"] = (
                "dq, dk and dv in one call, the same time for flash_bwd_dq "
                "and flash_bwd_dkv")
    shape = {"BH": bh, "L": L, "D": d, "dtype": "bfloat16", "causal": causal}
    if kvh != h:
        shape.update(heads=h, kv_heads=kvh, BH_kv=b * kvh)
    return rows, {"shape": shape, "sdpa_fwd_ms": sdpa_fwd,
                  "sdpa_bwd_ms": sdpa_bwd,
                  "sdpa_fwd_bwd_ms": sdpa_fwd + sdpa_bwd,
                  "sdpa_fwd_tflops": work["flash_fwd"][0] / sdpa_fwd / 1e9,
                  "sdpa_bwd_tflops": (work["flash_bwd_dq"][0]
                                      + work["flash_bwd_dkv"][0])
                  / sdpa_bwd / 1e9}


def phase_timing_flash(torch, dev, seed):
    """The flash kernels timed at the GPT main path's shape (the kernels
    line's rows), then at every other path's shape (the decodes' included)."""
    d = MAIN_FLASH_CASE[4]
    rows, main = flash_timing(torch, dev, seed + 5, GPT_BATCH, GPT_HEADS,
                              GPT_HEADS, GPT_SEQ, d, True)
    paths = {}
    for path, (b, case) in (
            ("bert", (BERT_BATCH, BERT_FLASH_CASE)),
            ("llama", (LLAMA_BATCH, LLAMA_FLASH_CASE)),
            ("vit", (VIT_BATCH, VIT_FLASH_CASE)),
            ("composite_gpt", (COMPOSITE_MB, COMPOSITE_GPT_FLASH_CASE)),
            ("composite_llama", (COMPOSITE_MB, COMPOSITE_LLAMA_FLASH_CASE)),
            ("generate", (GEN_BATCH, GEN_FLASH_CASE)),
            ("beam_search", (GEN_BATCH * GEN_BEAMS, BEAM_FLASH_CASE)),
            ("speculative", (GEN_BATCH, SPEC_FLASH_CASE))):
        _, bh, L, _, d, causal, _, h, kvh = case
        h = h or bh // b
        path_rows, extra = flash_timing(torch, dev, seed + 5, b, h,
                                        kvh or h, L, d, causal)
        paths[path] = {**extra, "kernels": path_rows}
    emit({"phase": "timing_flash", **main, "kernels": rows, "paths": paths,
          "note": "ms: CUDA events, median of 20 runs of 5 back-to-back "
                  "launches, each kernel launched directly; tflops: the "
                  "visible pairs' "
                  "operations over ms; bound_share: bound_ms / ms; "
                  "plain_ms of both backward "
                  "kernels is the plain backward, which computes dq, dk and "
                  "dv together; library: scaled_dot_product_attention "
                  "(is_causal as the path; enable_gqa for LLaMA's grouped "
                  "K/V) forward, and its backward alone, timed here only; "
                  "ViT: L = 196, non-causal, the last key tile ragged; "
                  "composite_gpt, composite_llama: the composite "
                  "trainers' and pipeline_virtual's 2 x 1024 "
                  "microbatches; generate, beam_search, speculative: the "
                  "decodes' re-forwards (forward alone on that path)"})
    return rows, paths


def path_shapes(torch):
    """The parameter shapes of the BERT, LLaMA, ViT, T5, VGG-16 and
    Inception V3 paths' models and of the LoRA path's adapters, from copies
    on the meta device (no memory, no weights)."""
    from horovod_tpu_torch.models import (GPT, T5, VGG16, BertForPreTraining,
                                          InceptionV3, Llama, ViT, lora_init)
    with torch.device("meta"):
        models = {"bert_large": BertForPreTraining(bert_config(torch, True)),
                  "llama_400m": Llama(llama_config(torch, True)),
                  "vit_b16": ViT(vit_config(torch, True)),
                  "t5_small": T5(t5_config(torch)),
                  "vgg16": VGG16(num_classes=1000),
                  "inception_v3": InceptionV3(num_classes=1000,
                                              aux_logits=True),
                  "gpt2_small_lora": lora_init(
                      GPT(gpt_config(torch, use_flash=True)),
                      rank=LORA_RANK, targets=LORA_TARGETS)["adapters"]}
    return {name: [tuple(p.shape) for p in m.parameters()]
            for name, m in models.items()}


# ---------------------------------------------------------------------------
# The launcher and the cycle thread: launch, launch_cpu_world, cycle.
# ---------------------------------------------------------------------------

ROOT = pathlib.Path(__file__).resolve().parent
CONTRACT = ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
            "HOROVOD_LOCAL_SIZE", "HOROVOD_CROSS_RANK", "HOROVOD_CROSS_SIZE")
LAUNCH_TIMEOUT = 420                # seconds, the launched GPT worker's run
CPU_WORLD_TENSORS = 24
CYCLE_REPEATS, CYCLE_STEPS = 2, 5
# The launch phase's --chaos-plan: one delay on one step's first flush.
LAUNCH_CHAOS_PLAN = {"seed": 7, "faults": [
    {"site": "fusion.flush", "kind": "delay", "at_step": [3],
     "delay_ms": 50.0}]}
CYCLE_ORDER = (0.0, 1.0, 1.0, 0.0)  # ms, in turns: host speed drifts


def start_launcher(args, np_, kind, launcher=None, worker=(), flags=()):
    """``python -m horovod_tpu_torch.runner -np np_ -H localhost:np_
    --cycle-time-ms 1`` (``launcher`` in place of ``-np``/``-H``: the
    elastic flags; ``flags``: more launcher flags) on this script's
    ``--launched-worker kind`` with ``worker``'s extra arguments, in a
    session of its own."""
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner",
           *(launcher or ["-np", str(np_), "-H", f"localhost:{np_}"]),
           *flags,
           "--cycle-time-ms", "1", "--start-timeout", "120", sys.executable,
           str(ROOT / "chip_smoke.py"), "--launched-worker", kind,
           "--seed", str(args.seed), "--warmup", str(args.warmup),
           "--batch", str(args.batch), *worker]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    return subprocess.Popen(cmd, cwd=str(ROOT), env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)


def finish_launcher(proc, timeout, kind):
    """Wait for a :func:`start_launcher` process, killing its session whole
    past ``timeout``. Returns the exit code, the workers' JSON lines (the
    launcher prefixes each with its tag and ``<stdout>``) and the tail of
    the output."""
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise RuntimeError(f"chip_smoke check failed: hvdrun-torch ({kind}) "
                           f"ran past {timeout} s:\n{out[-4000:]}")
    lines = [json.loads(line[line.index("{"):]) for line in out.splitlines()
             if '{"phase": "launched_worker"' in line]
    return proc.returncode, lines, out[-4000:]


def run_launcher(args, np_, kind, timeout, launcher=None, flags=()):
    return finish_launcher(start_launcher(args, np_, kind, launcher,
                                          flags=flags), timeout, kind)


def gone(pid, wait_s=10.0):
    deadline = time.monotonic() + wait_s
    while time.monotonic() < deadline:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return True
        time.sleep(0.1)
    return False


def launched_worker(args):
    """``--launched-worker``: this script as a process hvdrun-torch
    started. ``gpt``: hvd.init() on the card, GPT-2 small trained as in
    train_gpt (the same checks) with the cycle timer on; ``fail``:
    hvd.init(), then exit 1; ``cpu_world``: hvd.init(device="cpu") and
    jittered async allreduces."""
    import torch
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops.fusion import get_runtime

    kind = args.launched_worker
    if kind == "cpu_world":
        return cpu_world_worker(torch, hvd, args)
    if kind == "elastic":
        return elastic_launched_worker(torch, hvd, args)
    if kind == "elastic_cpu":
        return elastic_cpu_worker(torch, hvd, args)
    if kind == "hier_cpu":
        return hier_cpu_worker(torch, hvd, args)
    hvd.init()
    contract = {k: os.environ[k] for k in CONTRACT}
    if kind == "fail":
        emit({"phase": "launched_worker", "kind": kind, "pid": os.getpid(),
              "contract": contract})
        sys.exit(1)
    dev = hvd.device()
    check(dev == torch.device("cuda", hvd.local_rank()),
          f"the launched worker runs on cuda:<local_rank>, got {dev}")
    model = build_gpt(torch, dev, args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 4)
    ids = torch.randint(0, model.config.vocab_size, (GPT_BATCH, GPT_SEQ),
                        generator=gen, device=dev)
    clock = iter(range(10 ** 6))

    def loss():
        # Each step advances the chaos plan's step clock (--chaos-plan).
        hvd.chaos.set_step(next(clock))
        return next_token_loss(F, model(ids), ids)

    _, run = train_steps(torch, hvd, model, loss, args, GPT_STEPS,
                         (model.config.num_layers,) * 3, lr=1e-4)
    elapsed = run.pop("elapsed")
    run.pop("closed")
    if os.environ.get("HOROVOD_FLIGHT_DIR"):
        # hvdrun-torch --flight-dir: this worker's ring, on demand.
        check(hvd.flight.dump("launched_worker") is not None,
              "the launched worker dumped its flight ring")
    emit({"phase": "launched_worker", "kind": kind, "pid": os.getpid(),
          "contract": contract, "device": str(dev),
          "cycle_time_ms": get_runtime()._cycle_s * 1e3,
          "tokens_per_sec": GPT_BATCH * GPT_SEQ * GPT_STEPS / elapsed,
          **run})
    hvd.shutdown()
    return 0


def cpu_world_worker(torch, hvd, args):
    """One rank of a 2-process gloo world: CPU_WORLD_TENSORS async
    allreduces, each after a seeded sleep (rank 1 up to 8 cycles, rank 0
    up to 4), then their values and the buckets this rank formed."""
    from horovod_tpu_torch.ops.fusion import get_runtime
    hvd.init(device="cpu")
    rank, rt = hvd.rank(), get_runtime()
    delays = random.Random(args.seed + rank)
    mark = rt.flush_stats()
    handles = []
    for i in range(CPU_WORLD_TENSORS):
        time.sleep(delays.uniform(0.0, 0.008 if rank == 1 else 0.004))
        dt = (torch.float32, torch.bfloat16)[i % 2]
        handles.append(hvd.allreduce_async(
            torch.full((3 + 7 * i,), float(rank + 1), dtype=dt),
            op=hvd.Sum, name=f"cpu_world.{i}"))
    values_ok = all(torch.equal(h.synchronize().float(),
                                torch.full((3 + 7 * i,), 3.0))
                    for i, h in enumerate(handles))
    closed, row = buckets_since(mark)
    emit({"phase": "launched_worker", "kind": "cpu_world", "rank": rank,
          "contract": {k: os.environ[k] for k in CONTRACT},
          "backend": "gloo" if hvd.gloo_enabled() else "nccl",
          "buckets": [[why, sig[4], [n for _, n in sig[-1]]]
                      for why, sig in closed],
          "buckets_timer_new_signatures": row, "values_ok": values_ok})
    hvd.shutdown()
    return 0


def phase_launch(torch, args, card):
    """The port's launcher on the card: ``-np 1`` on the GPT worker, and a
    worker that exits 1 as the control. Returns the worker's launches."""
    import tempfile
    gc.collect()
    torch.cuda.empty_cache()
    out = pathlib.Path(tempfile.mkdtemp(prefix="hvd_launch_planes_"))
    flags = ["--timeline-filename", str(out / "timeline.json"),
             "--goodput", "--goodput-dir", str(out / "goodput"),
             "--run-history-dir", str(out / "history"),
             "--flight-dir", str(out / "flight"),
             "--chaos-plan", json.dumps(LAUNCH_CHAOS_PLAN),
             "--chaos-ledger", str(out / "chaos")]
    rc, lines, log = run_launcher(args, 1, "gpt", LAUNCH_TIMEOUT,
                                  flags=flags)
    check(rc == 0 and len(lines) == 1,
          f"the launched GPT-2 small worker exits 0 (rc {rc}):\n{log}")
    planes = launched_planes(out)
    w = lines[0]
    check(w["contract"] == dict(zip(CONTRACT, "010101")),
          f"the worker got the launcher's 1-slot contract: {w['contract']}")
    check(w["device"] == "cuda:0", f"the worker ran on cuda:0: {w['device']}")
    check(all(w["launches"][k] > 0 for k in STEP_COUNTS),
          f"the worker launched every flash and both scale kernels: "
          f"{w['launches']}")
    timer = sum(r[1] for r in w["buckets_timer_new_signatures_per_step"])
    check(timer > 0, f"the cycle timer closed buckets in the worker: "
          f"{w['buckets_timer_new_signatures_per_step']}")
    check(w["losses"][-1] < w["losses"][0] and w[
          "reduced_equals_local_bitwise"], f"the worker's loss falls and its "
          f"reduced gradients equal the local ones: {w['losses']}")
    from horovod_tpu_torch.chaos import injector
    sched = injector.ledger_schedule(injector.read_ledger(str(out / "chaos")))
    spec = LAUNCH_CHAOS_PLAN["faults"][0]
    check(sched == [("worker", 0, spec["site"], spec["kind"], 0, 0,
                     spec["at_step"][0], None)],
          f"the worker's chaos ledger holds the planned line: {sched}")
    frc, flines, flog = run_launcher(args, 1, "fail", 180)
    check(frc == 1 and len(flines) == 1 and gone(flines[0]["pid"]),
          f"control: a worker that exits 1 fails the launch with 1 and is "
          f"reaped (rc {frc}):\n{flog}")
    emit({"phase": "launch", "command": "python -m horovod_tpu_torch.runner "
          "-np 1 -H localhost:1 --cycle-time-ms 1 python chip_smoke.py "
          "--launched-worker gpt", "worker": w,
          "timer_closed_buckets": timer,
          "control_fail": {"rc": frc, "worker_reaped": True},
          "planes": planes, "chaos_plan": LAUNCH_CHAOS_PLAN,
          "chaos_schedule": sched, "card": card})
    return w["launches"]


def launched_planes(out):
    """What the planes of a worker launched with --timeline-filename,
    --goodput --goodput-dir, --run-history-dir and --flight-dir left:
    each file, and ``python -m horovod_tpu_torch.goodput`` reading the
    run."""
    with open(out / "timeline.json") as f:
        tl = json.load(f)["traceEvents"]
    spans = sum(1 for e in tl if e.get("cat") == "ALLREDUCE")
    check(tl[0]["name"] == "clock_sync" and spans > 0,
          f"the worker's timeline opens with clock_sync and holds its "
          f"allreduce spans ({spans})")
    with open(out / "goodput" / "goodput_r00.json") as f:
        gp = json.load(f)
    check(gp["conservation_error"] <= 0.01 and gp["steps"] > 0,
          f"the worker's goodput summary is conserved: {gp}")
    dumps = sorted(p.name for p in (out / "flight").glob("flight_*.jsonl"))
    check(len(dumps) == 1, f"the worker's flight dump: {dumps}")
    rep = subprocess.run([sys.executable, "-m", "horovod_tpu_torch.goodput",
                          "--dir", str(out / "history")],
                         capture_output=True, text=True, timeout=60,
                         cwd=str(ROOT), env=dict(os.environ, PYTHONPATH=str(
                             ROOT)))
    check(rep.returncode == 0 and "[ended cleanly]" in rep.stdout
          and "productive_compute" in rep.stdout,
          f"python -m horovod_tpu_torch.goodput reads the run "
          f"(rc {rep.returncode}):\n{rep.stdout}{rep.stderr[-2000:]}")
    return {"timeline_allreduce_spans": spans,
            "goodput_ratio": gp["goodput_ratio"],
            "conservation_error": gp["conservation_error"],
            "flight_dump": dumps[0], "goodput_report": rep.stdout}


def phase_launch_cpu_world(args):
    """``-np 2`` through the launcher with workers on the CPU (gloo): NCCL
    refuses two ranks on one card, so this holds the per-slot env and the
    boundary protocol on this machine's Python and torch, not two GPUs."""
    rc, lines, log = run_launcher(args, 2, "cpu_world", 180)
    check(rc == 0 and len(lines) == 2, f"the 2-process CPU world exits 0 "
          f"(rc {rc}):\n{log}")
    by_rank = {w["rank"]: w for w in lines}
    check(sorted(by_rank) == [0, 1] and all(
        w["contract"] == dict(zip(CONTRACT, (str(r), "2", str(r), "2", "0",
                                             "1")))
        for r, w in by_rank.items()),
          f"each slot got its own contract: {[w['contract'] for w in lines]}")
    check(by_rank[0]["buckets"] == by_rank[1]["buckets"],
          "both ranks formed the same buckets")
    check(by_rank[0]["buckets_timer_new_signatures"][1] > 0,
          f"rank 0's timer closed buckets: {by_rank[0]['buckets']}")
    check(all(w["values_ok"] and w["backend"] == "gloo" for w in lines),
          "every value is the sum over the two ranks, over gloo")
    emit({"phase": "launch_cpu_world", "run_on": "CPU (gloo), not the card",
          "ranks": 2, "tensors": CPU_WORLD_TENSORS,
          "buckets": by_rank[0]["buckets"],
          "buckets_timer_new_signatures": by_rank[0][
              "buckets_timer_new_signatures"],
          "same_buckets_on_both_ranks": True})


def phase_cycle(torch, hvd, dev, args, card):
    """GPT-2 small and ResNet-50, in this process, at HOROVOD_CYCLE_TIME 0
    and 1 ms (the runtime's cycle set between runs, in the turns of
    CYCLE_ORDER): buckets a step, buckets the timer closed, new signatures
    a step, tokens/s or images/s as the median of CYCLE_REPEATS repeats of
    CYCLE_STEPS steps in each turn, and the device's busy ms a step and
    busy share (torch.profiler, 2 steps). Printed, not checked."""
    import torch.nn.functional as F

    from horovod_tpu_torch.models import ResNet50
    from horovod_tpu_torch.ops.fusion import get_runtime

    rt = get_runtime()
    cycle0 = rt._cycle_s * 1e3
    rows = []
    for name in ("gpt2_small", "resnet50"):
        gen = torch.Generator(device=dev).manual_seed(args.seed + 31)
        if name == "gpt2_small":
            model = build_gpt(torch, dev, args.seed + 31)
            ids = torch.randint(0, model.config.vocab_size,
                                (GPT_BATCH, GPT_SEQ), generator=gen,
                                device=dev)
            opt = torch.optim.AdamW(model.parameters(), lr=1e-4,
                                    weight_decay=1e-4)
            units, unit = GPT_BATCH * GPT_SEQ, "tokens_per_sec"

            def loss():
                return next_token_loss(F, model(ids), ids)
        else:
            model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                             generator=torch.Generator().manual_seed(
                                 args.seed + 31)).to(dev).train()
            x = torch.randn((args.batch, 224, 224, 3), generator=gen,
                            device=dev)
            y = torch.randint(0, 1000, (args.batch,), generator=gen,
                              device=dev)
            opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
            units, unit = args.batch, "images_per_sec"

            def loss():
                return F.cross_entropy(model(x), y)
        opt = hvd.DistributedOptimizer(
            opt, named_parameters=model.named_parameters())

        def step():
            opt.zero_grad()
            loss().backward()
            opt.step()

        by_ms = {ms: {"per": [], "rates": [], "busy": []}
                 for ms in CYCLE_ORDER}
        for ms in CYCLE_ORDER:
            rt.set_cycle_time_ms(ms)
            for _ in range(args.warmup):
                step()
            got = by_ms[ms]
            for _ in range(CYCLE_REPEATS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(CYCLE_STEPS):
                    m0 = rt.flush_stats()
                    step()
                    got["per"].append(buckets_since(m0)[1])
                torch.cuda.synchronize()
                got["rates"].append(units * CYCLE_STEPS
                                    / (time.perf_counter() - t0))
            got["busy"].append(device_ms(torch, step))
        for ms, got in by_ms.items():
            per = got["per"]
            rows.append({
                "model": name, "cycle_time_ms": ms,
                "buckets_per_step": statistics.mean(r[0] for r in per),
                "timer_closed_per_step": statistics.mean(r[1] for r in per),
                "new_signatures_per_step": statistics.mean(r[2] for r in per),
                "buckets_timer_new_signatures_per_step": per,
                unit: statistics.median(got["rates"]),
                f"{unit}_repeats": got["rates"],
                "device_busy_ms_per_step": [b for b, _ in got["busy"]],
                "device_busy_share": [s for _, s in got["busy"]]})
        opt._remove_hooks()
        del model, opt
        gc.collect()
    rt.set_cycle_time_ms(cycle0)
    emit({"phase": "cycle", "rows": rows, "order_ms": CYCLE_ORDER,
          "repeats_per_turn": CYCLE_REPEATS, "steps_per_repeat": CYCLE_STEPS,
          "checked": False, "card": card})
    return rows



# ---------------------------------------------------------------------------
# Elastic: ResNet-50 under hvd.elastic.run, a fault, and the membership
# changes through the launcher.
# ---------------------------------------------------------------------------

ELASTIC_STEPS, ELASTIC_FAULT = 8, 4   # the fault at step 4, after its update
ELASTIC_TURNS = (False, True, True, False)   # commit each step: off/on turns
ELASTIC_REPEATS, ELASTIC_REPEAT_STEPS = 2, 5
ELASTIC_LAUNCH_TIMEOUT = 300
# A failed worker's wait for a new membership version (JAX: 30 s).
ELASTIC_WAIT_S = 5.0
ELASTIC_CPU_SCENARIOS = ("kill", "remove", "add")


def elastic_model(torch, hvd, dev, args):
    """phase train's configuration: ResNet-50 from --seed, SGD(lr=0.1,
    momentum=0.9) in hvd.DistributedOptimizer, a fixed batch."""
    from horovod_tpu_torch.models import ResNet50
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                     generator=torch.Generator().manual_seed(args.seed))
    model = model.to(dev).train()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters())
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    x = torch.randn((args.batch, 224, 224, 3), generator=gen, device=dev)
    y = torch.randint(0, 1000, (args.batch,), generator=gen, device=dev)

    def step():
        import torch.nn.functional as F
        opt.zero_grad()
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        return loss.detach()
    return model, opt, step


def state_tensors(model_state, opt_state):
    """A model's and an optimizer's state_dict tensors, in one order."""
    per_param = [opt_state["state"][i] for i in sorted(opt_state["state"])]
    return list(model_state.values()) + [
        v for s in per_param for _, v in sorted(s.items())
        if hasattr(v, "data_ptr")]


def all_equal(torch, a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@contextlib.contextmanager
def deterministic_cudnn(torch):
    cudnn = torch.backends.cudnn
    saved = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = False, True
    try:
        yield
    finally:
        cudnn.benchmark, cudnn.deterministic = saved


def elastic_resnet(torch, hvd, dev, args):
    """ResNet-50 under hvd.elastic.run with TorchState(model, optimizer,
    step) committed after every step; at step ELASTIC_FAULT, after the
    optimizer step and before the commit, the training function raises
    HorovodInternalError, as a failed collective does. Timed by wrapping
    basics.shutdown/init, the state's restore/sync and the wait for a new
    version. Returns the readings, the optimizer and the state."""
    import torch.distributed as dist

    from horovod_tpu_torch.elastic import worker
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.elastic import attach_listener
    from horovod_tpu_torch.ops.kernels import scale_buffers as sb

    model, opt, step = elastic_model(torch, hvd, dev, args)
    state = attach_listener(hvd.TorchState(model, opt, step=0))
    spans, per_step, losses, commit_ms, seen = {}, [], {}, [], {}

    def timed(name, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                spans.setdefault(name, []).append(
                    (t0, time.perf_counter()))
        return call

    raw = (basics.shutdown, basics.init, worker.wait_for_version_change)
    basics.shutdown = timed("shutdown", raw[0])
    basics.init = timed("init", raw[1])
    # The wait for a new version, cut from JAX's 30 s to ELASTIC_WAIT_S:
    # under the launcher no version comes at one slot, so the whole wait
    # is the phase's idle time (outside a launch it returns at once).
    worker.wait_for_version_change = timed("wait", functools.partial(
        raw[2], timeout=ELASTIC_WAIT_S))
    state.restore = timed("restore", state.restore)
    state.sync = timed("sync", state.sync)

    def committed():
        return state_tensors(state._saved_model_state,
                             state._saved_optimizer_state)

    @hvd.elastic.run
    def train(state):
        if seen and "resumed" not in seen:
            seen["resumed"] = time.perf_counter()
            seen["restore_bit_equal"] = all_equal(
                torch, state_tensors(model.state_dict(), opt.state_dict()),
                committed())
            seen["group_replaced"] = \
                dist.distributed_c10d._get_default_group() is not seen["pg"]
            del seen["pg"]
        while state.step < ELASTIC_STEPS:
            c0 = (sb.pack_launches, sb.unpack_launches)
            loss = step()
            torch.cuda.synchronize()
            per_step.append([state.step, "resumed" in seen,
                             sb.pack_launches - c0[0],
                             sb.unpack_launches - c0[1]])
            if state.step == ELASTIC_FAULT and not seen:
                # The control: what the step changed is not in the commit.
                seen["uncommitted_differs"] = not all_equal(
                    torch, state_tensors(model.state_dict(),
                                         opt.state_dict()), committed())
                seen["pg"] = dist.distributed_c10d._get_default_group()
                seen["fault"] = time.perf_counter()
                raise hvd.HorovodInternalError(
                    f"chip_smoke: a failed collective at step {state.step}")
            if "resumed" in seen and "first_step" not in seen:
                seen["first_step"] = time.perf_counter()
            losses[state.step] = loss.item()
            state.step += 1
            t0 = time.perf_counter()
            state.commit()
            torch.cuda.synchronize()
            commit_ms.append(1e3 * (time.perf_counter() - t0))

    version0 = os.environ.get("HOROVOD_ELASTIC_INIT_VERSION")
    sb.reset_launch_counts()                     # the elastic path starts
    try:
        train(state)
    finally:
        basics.shutdown, basics.init, worker.wait_for_version_change = raw
    launches = {"scale_pack": sb.pack_launches,
                "scale_unpack": sb.unpack_launches}   # the path ends
    check("resumed" in seen, "the training function was entered again")
    first = {k: spans[k][0] for k in ("shutdown", "restore", "wait")}
    init, sync = spans["init"][-1], spans["sync"][-1]
    devices = {str(t.device) for t in state_tensors(model.state_dict(),
                                                    opt.state_dict())}
    st = basics._get_state()

    def ms(span):
        return 1e3 * (span[1] - span[0])
    return {
        "steps": ELASTIC_STEPS, "fault_step": ELASTIC_FAULT,
        "losses": [losses[i] for i in range(ELASTIC_STEPS)],
        "launches": launches,
        "launches_per_step": per_step,
        "launches_per_step_columns": ["step", "after_reset", "pack",
                                      "unpack"],
        "restore_bit_equal": seen["restore_bit_equal"],
        "uncommitted_differs": seen["uncommitted_differs"],
        "group_replaced": seen["group_replaced"],
        "inits": len(spans["init"]), "backend": st.backend,
        "device": str(hvd.device()), "state_devices": sorted(devices),
        "version_before": version0,
        "version_after": os.environ.get("HOROVOD_ELASTIC_INIT_VERSION"),
        "commit_ms": commit_ms,
        "commit_ms_median": statistics.median(commit_ms),
        "abort_ms": ms(first["shutdown"]), "restore_ms": ms(first["restore"]),
        "wait_for_version_s": first["wait"][1] - first["wait"][0],
        "init_ms": ms(init), "sync_ms": ms(sync),
        # abort/shutdown -> init -> sync, without the restore's copy and the
        # wait for a new version
        "reset_ms": ms(first["shutdown"]) + ms(init) + ms(sync),
        "fault_to_resume_s": seen["resumed"] - seen["fault"],
        "fault_to_first_step_s": seen["first_step"] - seen["fault"],
    }, opt, state, step


def check_elastic_run(run, where):
    check(run["restore_bit_equal"], f"{where}: after the restore every "
          "parameter, buffer and momentum equals the commit bit for bit")
    check(run["uncommitted_differs"], f"{where}: control: the uncommitted "
          "state of the fault step differs from the commit")
    check(run["group_replaced"] and run["inits"] == 1
          and run["backend"] == "nccl" and run["device"] == "cuda:0"
          and run["state_devices"] == ["cuda:0"],
          f"{where}: one re-init, a new NCCL group on cuda:0 and the state "
          f"on the card: {run['inits']} inits, {run['backend']} on "
          f"{run['device']}, state on {run['state_devices']}")
    before = [s for s in run["launches_per_step"] if not s[1]]
    after = [s for s in run["launches_per_step"] if s[1]]
    check(before and after and all(s[2] > 0 and s[3] > 0
                                   for s in before + after),
          f"{where}: pack and unpack launches in every step before and after "
          f"the reset: {run['launches_per_step']}")
    check(run["losses"][-1] < run["losses"][0] and all(
        map(math.isfinite, run["losses"])), f"{where}: finite, falling "
          f"loss: {run['losses']}")


def phase_train_elastic(torch, hvd, dev, args, card):
    """Elastic ResNet-50 in this process: the fault, the reset and its
    checks; the same steps without the fault from the same weights, held
    bit-equal (deterministic cuDNN); then images/s with and without a
    commit each step, in turns. Returns the path's launches."""
    from horovod_tpu_torch.ops.fusion import get_runtime
    gc.collect()
    torch.cuda.empty_cache()
    # What earlier phases left allocated: not this phase's.
    base = torch.cuda.memory_allocated()
    with deterministic_cudnn(torch):
        model, opt, step = elastic_model(torch, hvd, dev, args)
        for _ in range(ELASTIC_STEPS):
            step()
        reference = [t.clone() for t in state_tensors(model.state_dict(),
                                                      opt.state_dict())]
        opt._remove_hooks()
        del model, opt, step
        gc.collect()
        run, opt, state, step = elastic_resnet(torch, hvd, dev, args)
        resumed = state_tensors(state.model.state_dict(), opt.state_dict())
        same = [torch.equal(a, b) for a, b in zip(resumed, reference)]
        check(len(resumed) == len(reference) and all(same),
              f"the resumed run's weights equal the run without the fault "
              f"bit for bit: {same.count(False)} of {len(same)} tensors "
              f"differ")
    check_elastic_run(run, "train_elastic")
    del reference, resumed
    rates = {False: [], True: []}
    peak = {False: 0, True: 0}
    for commit in ELASTIC_TURNS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(ELASTIC_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(ELASTIC_REPEAT_STEPS):
                step()
                if commit:
                    state.commit()
            torch.cuda.synchronize()
            rates[commit].append(args.batch * ELASTIC_REPEAT_STEPS
                                 / (time.perf_counter() - t0))
        peak[commit] = max(peak[commit], torch.cuda.max_memory_allocated())
    copy_bytes = sum(t.numel() * t.element_size() for t in state_tensors(
        state._saved_model_state, state._saved_optimizer_state))
    opt._remove_hooks()
    emit({"phase": "train_elastic", "model": "ResNet-50", "batch": args.batch,
          "optimizer": "SGD(lr=0.1, momentum=0.9)",
          "fusion_threshold": get_runtime().threshold,
          "deterministic_cudnn": True, **run,
          "resumed_equals_uninterrupted_bitwise": True,
          "images_per_sec_no_commit": statistics.median(rates[False]),
          "images_per_sec_commit_each_step": statistics.median(rates[True]),
          "images_per_sec_repeats": {"no_commit": rates[False],
                                     "commit_each_step": rates[True]},
          "turns": ["commit" if c else "no_commit" for c in ELASTIC_TURNS],
          "commit_copy_gb": copy_bytes / 1e9,
          "peak_mem_gb_commit_each_step": (peak[True] - base) / 1e9,
          "peak_mem_gb_no_commit": (peak[False] - base) / 1e9,
          "peak_mem_note": "above what earlier phases left allocated "
                           f"({base / 1e9:.3f} GB); the commit copy is "
                           "held in both", "card": card})
    del opt, state, step
    gc.collect()
    return run["launches"]


def elastic_launched_worker(torch, hvd, args):
    """``--launched-worker elastic``: hvd.init() on the card under the
    elastic driver, the ResNet-50 elastic loop and its fault."""
    hvd.init()
    contract = {k: os.environ[k] for k in CONTRACT}
    dev = hvd.device()
    check(dev == torch.device("cuda", hvd.local_rank()),
          f"the launched worker runs on cuda:<local_rank>, got {dev}")
    with deterministic_cudnn(torch):
        run, opt, state, _ = elastic_resnet(torch, hvd, dev, args)
    emit({"phase": "launched_worker", "kind": "elastic", "pid": os.getpid(),
          "contract": contract, **run})
    hvd.shutdown()
    return 0


def elastic_cpu_worker(torch, hvd, args):
    """``--launched-worker elastic_cpu``: one CPU (gloo) worker of
    --elastic-scenario, tests/test_elastic_failure.py's scenarios: ``kill``
    (the second host's rank drops it from discovery and dies at step 3 of
    6), ``remove`` (a graceful removal at step 3: the survivor keeps its
    pid and an uncommitted attribute) and ``add`` (discovery grows to two
    hosts at step 3 of 8)."""
    from horovod_tpu_torch.elastic import attach_listener
    from horovod_tpu_torch.elastic.worker import (configured_version,
                                                  wait_for_version_change)
    hvd.init(device="cpu")
    scenario, script = args.elastic_scenario, args.discovery_script
    total = 8 if scenario == "add" else 6
    n = 4 if scenario == "kill" else 2
    state = attach_listener(hvd.TorchState(w=torch.zeros(n), step=0, pid0=0,
                                           uncommitted=0, worlds=[]))

    def discover(*hosts):
        with open(script, "w") as f:
            f.write("#!/bin/sh\n" + "".join(f"echo {h}\n" for h in hosts))

    @hvd.elastic.run
    def loop(state):
        while state.step < total:
            if state.step == 3 and scenario == "kill" and hvd.size() == 2 \
                    and hvd.rank() == 1:
                discover("localhost:1")
                os._exit(1)
            if state.step == 3 and scenario == "remove" and \
                    hvd.size() == 2 and state.pid0 == 0:
                state.pid0 = os.getpid()
                state.commit()
                state.uncommitted = 7        # not committed
                known = configured_version()
                if hvd.rank() == 1:
                    discover("localhost:1")
                wait_for_version_change(known, timeout=120)
                state.check_host_updates()
            if state.step == 3 and scenario == "add" and hvd.size() == 1:
                known = configured_version()
                discover("localhost:1", "127.0.0.1:1")
                check(wait_for_version_change(known, timeout=120) != known,
                      "the driver published the grown membership")
            contrib = torch.ones(n) * (hvd.rank() + 1 if scenario == "kill"
                                       else 1)
            state.w = state.w + hvd.allreduce(contrib, op=hvd.Sum)
            state.step += 1
            state.worlds.append(hvd.size())
            state.commit()
        return {"steps": state.step, "w": state.w.tolist(),
                "worlds": list(state.worlds), "pid0": state.pid0,
                "uncommitted": state.uncommitted, "size": hvd.size(),
                "rank": hvd.rank(), "backend": "gloo" if hvd.gloo_enabled()
                else "nccl"}

    emit({"phase": "launched_worker", "kind": "elastic_cpu",
          "scenario": scenario, "pid": os.getpid(), **loop(state)})
    hvd.shutdown()
    return 0


def discovery_script(name, *hosts):
    """A discovery script under build/elastic/ (ignored by git)."""
    d = ROOT / "build" / "elastic" / name
    d.mkdir(parents=True, exist_ok=True)
    path = d / "discover.sh"
    path.write_text("#!/bin/sh\n" + "".join(f"echo {h}\n" for h in hosts))
    path.chmod(0o755)
    return path


def elastic_flags(script, max_np):
    return ["--min-np", "1", "--max-np", str(max_np),
            "--host-discovery-script", str(script)]


def phase_launch_elastic(torch, args, card):
    """``hvdrun-torch -np 1 --min-np 1 --max-np 1 --host-discovery-script``
    on this script as ``--launched-worker elastic``: the ResNet-50 elastic
    loop and its fault in a worker the elastic driver started. Returns the
    worker's launches."""
    gc.collect()
    torch.cuda.empty_cache()
    script = discovery_script("launch", "localhost:1")
    t0 = time.perf_counter()
    rc, lines, log = run_launcher(
        args, 1, "elastic", ELASTIC_LAUNCH_TIMEOUT,
        launcher=["-np", "1"] + elastic_flags(script, 1))
    seconds = time.perf_counter() - t0
    check(rc == 0 and len(lines) == 1,
          f"the elastic ResNet-50 worker exits 0 (rc {rc}):\n{log}")
    w = lines[0]
    check(w["contract"] == dict(zip(CONTRACT, "010101")),
          f"the worker got the 1-slot contract: {w['contract']}")
    check_elastic_run(w, "launch_elastic")
    check(w["version_before"] == w["version_after"] == "1",
          f"the re-init was at the unchanged version 1: "
          f"{w['version_before']} -> {w['version_after']}")
    check(gone(w["pid"]), "the worker was reaped")
    emit({"phase": "launch_elastic", "command": "python -m "
          "horovod_tpu_torch.runner -np 1 --min-np 1 --max-np 1 "
          "--host-discovery-script build/elastic/launch/discover.sh python "
          "chip_smoke.py --launched-worker elastic", "seconds": seconds,
          "wait_for_version_s": w["wait_for_version_s"],
          "wait_note": "JAX's semantics: after a failure a worker waits "
                       "for a new membership version (30 s by default, "
                       f"{ELASTIC_WAIT_S} s here), then re-inits at the "
                       "unchanged one",
          "worker": w, "worker_reaped": True, "card": card})
    return w["launches"]


def phase_launch_elastic_cpu_world(args):
    """The membership changes through the elastic launcher, with CPU
    (gloo) workers: NCCL refuses two ranks on one card. The three
    scenarios run at once, each held to tests/test_elastic_failure.py's
    expected values."""
    procs = {}
    for name in ELASTIC_CPU_SCENARIOS:
        hosts = ("localhost:1",) if name == "add" \
            else ("localhost:1", "127.0.0.1:1")
        script = discovery_script(name, *hosts)
        procs[name] = start_launcher(
            args, 1, "elastic_cpu", launcher=elastic_flags(script, 2),
            worker=["--elastic-scenario", name, "--discovery-script",
                    str(script)])
    got = {name: finish_launcher(proc, ELASTIC_LAUNCH_TIMEOUT, "elastic_cpu")
           for name, proc in procs.items()}
    for name, (rc, lines, log) in got.items():
        want = 2 if name == "add" else 1
        check(rc == 0 and len(lines) == want and all(
            w["backend"] == "gloo" for w in lines),
              f"{name}: the launch exits 0 with {want} gloo worker(s) "
              f"reporting (rc {rc}):\n{log}")
    kill = got["kill"][1][0]
    check(kill["steps"] == 6 and kill["size"] == 1 and kill["w"] == [12.0] * 4
          and kill["worlds"] == [2, 2, 2, 1, 1, 1],
          f"kill: w == [12] * 4 and worlds [2, 2, 2, 1, 1, 1]: {kill}")
    rem = got["remove"][1][0]
    check(rem["steps"] == 6 and rem["size"] == 1 and rem["pid0"] == rem["pid"]
          and rem["uncommitted"] == 7 and rem["w"] == [9.0, 9.0]
          and rem["worlds"] == [2, 2, 2, 1, 1, 1],
          f"remove: the survivor keeps its pid and uncommitted state: {rem}")
    add = sorted(got["add"][1], key=lambda w: w["rank"])
    w0 = add[0]
    check([w["rank"] for w in add] == [0, 1] and all(
        w["steps"] == 8 and w["size"] == 2 and w["w"] == w0["w"]
        for w in add) and w0["worlds"][0] == 1 and w0["worlds"][-1] == 2
          and w0["worlds"].count(1) + 2 * w0["worlds"].count(2)
          == w0["w"][0], f"add: scaled up in place: {add}")
    emit({"phase": "launch_elastic_cpu_world",
          "run_on": "CPU (gloo), not the card",
          "scenarios": {name: lines for name, (_, lines, _) in got.items()}})


# The rest of A13 and A11's allreduce tiers on the card: the chunked
# next-token loss and PowerSGD on GPT-2 small, the tiers at one rank and in
# a 4-process CPU world.
GPT_CHUNK = 128          # bench.py:555-556's chunk of the chunked loss
# Limits of one GPT-2 small step through the chunked loss against the same
# step through full logits (loss_rel; grad_rel: |g_chunk - g_full| /
# |g_full| of the worst parameter). Two wrong controls must fall outside:
# the labels not shifted, and the -100 mask dropped (the last position
# trained on token 0). Read on an NVIDIA H100 80GB HBM3 at 700 W, seed 0,
# as (loss_rel, grad_rel): chunked 0.0, 9.8e-3 (pos_emb: the head's
# backward in other tiles moves fp32 roundings that the bf16 blocks'
# backward turns into bf16 flips); labels not shifted 3.2e-4, 0.93; mask
# dropped 8.2e-5, 0.10. grad_rel's limit is GPT_CMP_LIMITS' (flash against
# plain attention on the same model).
GPT_CHUNK_LIMITS = {"loss_rel": 2e-6, "grad_rel": 3e-2}
POWERSGD_RANK, POWERSGD_STEPS = 4, 10
# The three strategies at one rank, each in a fresh world under its knobs;
# torus_qcross on the one-slice layout must run flat (JAX's refusal).
HIER_RUNS = (("torus", {"HOROVOD_TORUS_ALLREDUCE": "1"}, "torus"),
             ("hierarchical", {"HOROVOD_HIERARCHICAL_ALLREDUCE": "1"},
              "hierarchical"),
             ("torus_qcross", {"HOROVOD_HIERARCHICAL_DISPATCH": "1",
                               "HOROVOD_WIRE_DTYPE_DCN": "int8"}, "flat"))
HIER_STEPS = 3
# hier_cpu_world: 2 "hosts" of 2 CPU ranks, HOROVOD_MESH_SLICES=2.
HIER_HOSTS = "localhost:2,127.0.0.1:2"
HIER_ENV = {"HOROVOD_MESH_SLICES": "2", "HOROVOD_WIRE_DTYPE_DCN": "int8",
            "HOROVOD_HIERARCHICAL_ALLGATHER": "1"}
HIER_BUCKET = (4500, 1500, 701)
# The control-plane leg of hier_cpu_world: the launcher's flags, and the
# fused tensors (elements, dtype) compared between the two boundary streams.
HIER_CONTROL_FLAGS = ("--control-plane", "hier", "--kv-shard-count", "2",
                      "--order-check", "--telemetry-interval", "0.5")
HIER_FUSED = ((700, "float32"), (1500, "float32"), (333, "bfloat16"),
              (2048, "float32"))


def grads_of(torch, model, loss_fn):
    """One forward and backward of ``loss_fn()``: its value and every
    parameter's gradient."""
    model.zero_grad(set_to_none=True)
    loss = loss_fn()
    loss.backward()
    torch.cuda.synchronize()
    return loss.item(), {n: p.grad.detach().clone()
                         for n, p in model.named_parameters()}


def rel_reading(lf, gf, lp, gp):
    rel = {n: ((gf[n] - gp[n]).norm() / gp[n].norm().clamp_min(1e-30))
           .item() for n in gp}
    worst = max(rel, key=rel.get)
    return {"loss": lf, "loss_rel": abs(lf - lp) / abs(lp),
            "grad_rel": rel[worst], "grad_rel_worst": worst}


def max_saved_numel(torch, fn):
    """``fn()`` under saved-tensor hooks: its value and the largest tensor
    (numel) autograd kept for the backward outside any checkpoint."""
    most = [0]

    def pack(t):
        most[0] = max(most[0], t.numel())
        # Detached: a saved output returned as it is would close a cycle
        # through the C++ graph (node -> tensor -> node), and the graph,
        # never differentiated here, would outlive the phase.
        return t.detach()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, most[0]


def chunked_loss(model, ids, labels):
    from horovod_tpu_torch.optim import next_token_xent_chunked
    return next_token_xent_chunked(model.head, model(ids, features_only=True),
                                   labels, chunk=GPT_CHUNK)


def gpt_batch(torch, model, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    return torch.randint(0, model.config.vocab_size, (GPT_BATCH, GPT_SEQ),
                         generator=gen, device=dev)


def phase_train_gpt_chunked(torch, hvd, dev, args, card):
    """GPT-2 small (train_gpt's weights and batch) through the chunked
    next-token loss against the full-logits one: step 1's loss and every
    gradient within GPT_CHUNK_LIMITS (controls: labels not shifted, the
    -100 mask dropped), the largest tensor kept for the backward (no
    (B, L, V) logits), then each trained GPT_STEPS steps with AdamW from
    the same weights: peak memory, tokens/s, device ms a step, and the
    recompute's ms (the head on the whole batch once more). Returns the
    chunked run's launches."""
    import copy

    import torch.nn.functional as F

    from horovod_tpu_torch.parallel.sequence import next_token_labels

    model = build_gpt(torch, dev, args.seed)
    cfg = model.config
    ids = gpt_batch(torch, model, dev, args.seed)
    labels = next_token_labels(ids)
    init = copy.deepcopy(model.state_dict())
    fns = {"full": lambda: next_token_loss(F, model(ids), ids),
           "chunked": lambda: chunked_loss(model, ids, labels)}
    lf, gf = grads_of(torch, model, fns["full"])
    readings = {"chunked": rel_reading(*grads_of(torch, model,
                                                 fns["chunked"]), lf, gf)}
    controls = {"labels_not_shifted": ids,
                "mask_dropped": labels.clamp_min(0)}
    for name, lab in controls.items():
        readings[name] = rel_reading(*grads_of(
            torch, model, lambda lab=lab: chunked_loss(model, ids, lab)),
            lf, gf)
    del gf
    model.zero_grad(set_to_none=True)

    def within(r):
        return (r["loss_rel"] <= GPT_CHUNK_LIMITS["loss_rel"]
                and r["grad_rel"] <= GPT_CHUNK_LIMITS["grad_rel"])
    check(within(readings["chunked"]), f"the chunked loss and gradients "
          f"within {GPT_CHUNK_LIMITS} of full logits: {readings['chunked']}")
    for name in controls:
        check(not within(readings[name]), f"control {name} "
              f"{readings[name]} is rejected by {GPT_CHUNK_LIMITS}")
    logits_numel = GPT_BATCH * GPT_SEQ * cfg.vocab_size
    saved = {}
    for name, fn in fns.items():
        out, saved[name] = max_saved_numel(torch, fn)
        del out
    check(saved["full"] >= GPT_BATCH * (GPT_SEQ - 1) * cfg.vocab_size
          and saved["chunked"] < logits_numel * GPT_CHUNK // GPT_SEQ,
          f"the full loss keeps its (B, L, V) log-softmax for the backward, "
          f"the chunked one nothing as large as one chunk's logits: {saved}")
    with torch.no_grad():
        h = model(ids, features_only=True)
        recompute_ms = event_ms(lambda: model.head(h), reps=10)
    del h
    runs, launches = {}, None
    for name, fn in fns.items():
        model.load_state_dict(init)
        gc.collect()
        torch.cuda.empty_cache()
        opt, run = train_steps(torch, hvd, model, fn, args, GPT_STEPS,
                               (cfg.num_layers,) * 3, lr=1e-4)
        run.pop("closed")
        run["tokens_per_sec"] = GPT_BATCH * GPT_SEQ * GPT_STEPS \
            / run.pop("elapsed")

        def step(fn=fn, opt=opt):
            opt.zero_grad()
            fn().backward()
            opt.step()
        run["device_ms_per_step"], run["device_busy_share"] = device_ms(
            torch, step)
        opt._remove_hooks()
        runs[name] = run
        launches = run["launches"]
    del opt
    saving = runs["full"]["peak_mem_gb"] - runs["chunked"]["peak_mem_gb"]
    check(saving > 0, f"the chunked loss lowers the peak of allocated "
          f"memory: {runs['full']['peak_mem_gb']} -> "
          f"{runs['chunked']['peak_mem_gb']} GB")
    emit({"phase": "train_gpt_chunked", "model": "GPT-2 small",
          "params": sum(p.numel() for p in model.parameters()),
          "batch": GPT_BATCH, "seq": GPT_SEQ, "vocab": cfg.vocab_size,
          "chunk": GPT_CHUNK, "optimizer": ADAMW.format(lr=1e-4),
          "step1": readings, "limits": GPT_CHUNK_LIMITS,
          "largest_saved_numel": saved, "logits_numel": logits_numel,
          "peak_mem_saving_gb": saving,
          "recompute_head_ms": recompute_ms,
          "device_ms_difference": runs["chunked"]["device_ms_per_step"]
          - runs["full"]["device_ms_per_step"],
          "runs": runs,
          "note": "full: bench.py's loss on (B, L, V) fp32 logits; chunked: "
                  "optim.next_token_xent_chunked over features_only states "
                  "and model.head, each chunk under checkpoint; "
                  "recompute_head_ms: the head (LayerNorm and the fp32 "
                  "lm_head product at DEFAULT precision) on the whole "
                  "batch once, the work the backward adds",
          "card": card})
    del model, init
    return launches


def bucket_kind(sig):
    kinds = {n.split(".")[1] if n.startswith("powersgd.") else "plain"
             for n, _ in sig[-1]}
    return "+".join(sorted(kinds))


def phase_train_powersgd(torch, hvd, dev, args, card):
    """GPT-2 small (train_gpt's weights and batch) under
    hvd.DistributedOptimizer(AdamW, compression=Compression.powersgd(4))
    against the exact optimizer, POWERSGD_STEPS steps each from the same
    weights, at one rank. Checks: JAX's compress-or-not rule on the Flax
    shapes compresses every 2-D leaf and no 1-D one; the per-leaf identity
    M̂ + e_new = M (gradient + e_prev) within fp32 rounding, which a
    control without e_prev fails; finite, falling losses. Reported: the P,
    Q and plain buckets a step with their launches, the bytes a step by
    powersgd_wire_numbers, tokens/s, device ms and device launches a step
    against exact (the extra: the products, the QRs), the final losses'
    distance. Returns the PowerSGD run's launches."""
    import copy

    import torch.nn.functional as F

    from horovod_tpu_torch.optim.powersgd import (powersgd_wire_numbers,
                                                  use_powersgd)
    from horovod_tpu_torch.parallel.tp import flax_view
    from horovod_tpu_torch.torch.optimizer import POWERSGD_ERR

    model = build_gpt(torch, dev, args.seed)
    cfg = model.config
    ids = gpt_batch(torch, model, dev, args.seed)
    init = copy.deepcopy(model.state_dict())
    named = dict(model.named_parameters())
    flax_shapes = {n: tuple(flax_view(p, p).shape) for n, p in named.items()}
    compressed = sorted(n for n, s in flax_shapes.items()
                        if use_powersgd(s, POWERSGD_RANK, 2.0))
    check(compressed == sorted(n for n, p in named.items() if p.dim() >= 2),
          f"JAX's rule on the Flax shapes compresses every 2-D kernel and "
          f"embedding and no 1-D leaf: {compressed}")
    wire, full = powersgd_wire_numbers(list(flax_shapes.values()),
                                       POWERSGD_RANK)

    def loss():
        return next_token_loss(F, model(ids), ids)

    runs, launches = {}, None
    for name in ("exact", "powersgd"):
        model.load_state_dict(init)
        gc.collect()
        torch.cuda.empty_cache()
        comp = hvd.Compression.powersgd(POWERSGD_RANK) \
            if name == "powersgd" else hvd.Compression.none
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-4,
                              betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=1e-4),
            named_parameters=model.named_parameters(), compression=comp)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        hvd.broadcast_optimizer_state(opt, root_rank=0)
        opt, run = train_steps(torch, hvd, model, loss, args,
                               POWERSGD_STEPS, (cfg.num_layers,) * 3,
                               opt=opt, exact=name == "exact")
        closed = run.pop("closed")
        run["tokens_per_sec"] = GPT_BATCH * GPT_SEQ * POWERSGD_STEPS \
            / run.pop("elapsed")
        run["bucket_kinds_per_step"] = [[bucket_kind(sig) for _, sig in c]
                                        for c in closed]

        def step(opt=opt):
            opt.zero_grad()
            loss().backward()
            opt.step()
        run["device_ms_per_step"], run["device_busy_share"], \
            run["device_launches_per_step"] = device_ms(torch, step,
                                                        launches=True)
        if name == "powersgd":
            # One more step: M̂ + e_new = M + e_prev per compressed leaf.
            prev = {p: opt.state[p][POWERSGD_ERR].clone()
                    for p in named.values() if POWERSGD_ERR in opt.state[p]}
            local = {}
            hooks = [p.register_hook(
                lambda g, p=p: local.__setitem__(p, g.detach().clone()))
                for p in named.values()]
            step()
            for hk in hooks:
                hk.remove()
            torch.cuda.synchronize()
            worst = control = 0.0
            for p, e_prev in prev.items():
                m = (flax_view(p, local[p]).float() + e_prev).double()
                m_hat = flax_view(p, p.grad).double()
                e_new = opt.state[p][POWERSGD_ERR].double()
                tol = 2.0 ** -22 * (m_hat.abs() + e_new.abs() + m.abs()) \
                    + 1e-30
                worst = max(worst, ((m_hat + e_new - m).abs() / tol)
                            .max().item())
                g = flax_view(p, local[p]).double()
                control = max(control, ((m_hat + e_new - g).abs() / tol)
                              .max().item())
            check(len(prev) == len(compressed) and worst <= 1.0 < control,
                  f"M̂ + e_new = M + e_prev within fp32 rounding on every "
                  f"compressed leaf (worst share {worst}); without e_prev "
                  f"the identity fails (worst share {control})")
            run["ef_identity_worst_share_of_fp32_bound"] = worst
            run["ef_control_without_e_prev_worst_share"] = control
        opt._remove_hooks()
        runs[name] = run
        launches = run["launches"]
    del opt
    extra = {k: runs["powersgd"][k] - runs["exact"][k]
             for k in ("device_ms_per_step", "device_launches_per_step")}
    kinds = runs["powersgd"]["bucket_kinds_per_step"]
    check(all(any("p" in k.split("+") for k in s)
              and any(k == "q" for k in s) for s in kinds),
          f"every step's P's and Q's ride fusion buckets: {kinds}")
    ex, ps = runs["exact"]["losses"], runs["powersgd"]["losses"]
    emit({"phase": "train_powersgd", "model": "GPT-2 small",
          "params": sum(p.numel() for p in model.parameters()),
          "batch": GPT_BATCH, "seq": GPT_SEQ, "rank": POWERSGD_RANK,
          "optimizer": ADAMW.format(lr=1e-4),
          "leaves": len(named), "compressed_leaves": len(compressed),
          "wire_bytes_per_step": {"powersgd": wire, "full": full,
                                  "ratio": wire / full,
                                  "note": "powersgd_wire_numbers over the "
                                          "Flax shapes (fp32); one rank "
                                          "moves nothing across a link"},
          "final_loss": {"exact": ex[-1], "powersgd": ps[-1],
                         "rel_distance": abs(ps[-1] - ex[-1]) / abs(ex[-1])},
          "tokens_per_sec": {k: r["tokens_per_sec"] for k, r in runs.items()},
          "device_ms_per_step": {k: r["device_ms_per_step"]
                                 for k, r in runs.items()},
          "extra_per_step": {**extra, "launches_per_compressed_leaf":
                             extra["device_launches_per_step"]
                             / len(compressed)},
          "runs": runs, "card": card})
    del model, init
    return launches


def phase_train_hierarchical(torch, hvd, dev, args, card, make_model):
    """ResNet-50 as in train, on the same weights and batch, in a fresh
    1-rank world per HIER_RUNS entry: torus and hierarchical run as a
    1 x 1 decomposition on NCCL subgroups of one rank, torus_qcross with
    an int8 cross wire must run flat (one slice). Checks: each bucket's
    strategy in flush_stats, a pack and an unpack launch per bucket, the
    reduced gradients bit-equal to the local ones, finite losses. Returns
    the launches of the three runs."""
    import copy

    import torch.nn.functional as F

    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.ops.fusion import get_runtime
    from horovod_tpu_torch.ops.kernels import scale_buffers as sb

    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    x = torch.randn((args.batch, 224, 224, 3), generator=gen, device=dev)
    y = torch.randint(0, 1000, (args.batch,), generator=gen, device=dev)
    model = make_model()
    init = copy.deepcopy(model.state_dict())
    report = {}
    sb.reset_launch_counts()                 # the tier paths start here
    for name, env, runs_as in HIER_RUNS:
        hvd.shutdown()
        os.environ.update(env)
        hvd.init()
        rt = get_runtime()
        topo = basics._get_state().topology
        check(rt.strategy == name, f"the runtime's strategy is {name}")
        model.load_state_dict(init)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            named_parameters=model.named_parameters())

        def step():
            opt.zero_grad()
            loss = F.cross_entropy(model(x), y)
            loss.backward()
            opt.step()
            return loss.detach()

        losses, per_step = [], []
        for i in range(args.warmup + HIER_STEPS):
            c0, m0 = (sb.pack_launches, sb.unpack_launches), rt.flush_stats()
            losses.append(reduced_equals_local(torch, model, step)
                          if i == args.warmup - 1 else step())
            got, _ = buckets_since(m0)
            m1 = rt.flush_stats()
            per_step.append({
                "pack": sb.pack_launches - c0[0],
                "unpack": sb.unpack_launches - c0[1],
                "buckets": len(got),
                "strategies": {k: v - m0["strategies"][k]
                               for k, v in m1["strategies"].items()
                               if v != m0["strategies"][k]},
                "tiers": {t: sum(v.values()) - sum(m0["tiers"][t].values())
                          for t, v in m1["tiers"].items()}})
        opt._remove_hooks()
        for k in env:
            os.environ.pop(k)
        losses = [v.item() for v in losses]
        check(all(map(math.isfinite, losses)), f"{name}: finite losses "
              f"{losses}")
        check(all(s["pack"] == s["unpack"] == s["buckets"] > 0
                  and s["strategies"] == {runs_as: s["buckets"]}
                  and s["tiers"] == {"local": 0, "cross": 0}
                  for s in per_step),
              f"{name}: every bucket runs {runs_as}, one pack and one "
              f"unpack launch each, no tier metered at one slice: "
              f"{per_step}")
        report[name] = {"knobs": env, "runs_as": runs_as,
                        "layout": {"slices": topo.num_slices,
                                   "node_shape": topo.node_shape(),
                                   "strategy_shape":
                                       topo.strategy_shape()},
                        "losses": losses, "per_step": per_step,
                        "reduced_equals_local_bitwise": True}
    launches = {"scale_pack": sb.pack_launches,
                "scale_unpack": sb.unpack_launches}   # the tier paths end
    hvd.shutdown()
    hvd.init()
    check(get_runtime().strategy == "flat", "the world after the tier runs "
          "is flat")
    emit({"phase": "train_hierarchical", "model": "ResNet-50",
          "batch": args.batch, "warmup": args.warmup, "steps": HIER_STEPS,
          "runs": report, "launches": launches,
          "note": "one rank: the local and cross subgroups hold rank 0 "
                  "alone, so each leg is a copy; this holds the strategy "
                  "choice, the refusal and the kernels' launches, not a "
                  "cross-node figure",
          "card": card})
    del model, init
    return launches


def hier_cpu_worker(torch, hvd, args):
    """One rank of the 2 x 2 CPU world (HIER_HOSTS, HIER_ENV): each strategy
    on a bucket of HIER_BUCKET elements a rank (Sum), the hierarchical
    allgather of ragged rows; every rank's rows come from --seed, so each
    rank computes the sums itself."""
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.ops import wire
    from horovod_tpu_torch.ops.fusion import get_runtime
    hvd.init(device="cpu")
    rank, rt = hvd.rank(), get_runtime()
    topo = basics._get_state().topology
    total = sum(HIER_BUCKET)
    rows = torch.randn((4, total),
                       generator=torch.Generator().manual_seed(args.seed + 40))
    node = [rows[0] + rows[1], rows[2] + rows[3]]        # the local sums
    want = node[0] + node[1]
    out = {"rank": rank, "layout": [topo.num_slices, topo.slice_size,
                                    list(topo.node_shape())]}
    for strategy in ("torus", "hierarchical", "torus_qcross"):
        rt.strategy = strategy
        with rt.cycle_paused():
            m0 = rt.flush_stats()
            got = torch.cat(hvd.grouped_allreduce(
                list(rows[rank].split(HIER_BUCKET)), op=hvd.Sum,
                name=f"hier.{strategy}"))
            m1 = rt.flush_stats()
        cross = "int8" if strategy == "torus_qcross" else ""
        h = wire.hierarchical_wire_bytes(total, 4, 2, 4, cross_wire=cross)
        tiers = {t: {d: n - m0["tiers"][t].get(d, 0) for d, n in v.items()
                     if n != m0["tiers"][t].get(d, 0)}
                 for t, v in m1["tiers"].items()}
        row = {"strategies": {k: v - m0["strategies"][k]
                              for k, v in m1["strategies"].items()
                              if v != m0["strategies"][k]},
               "tiers": tiers,
               "tiers_formula": {"local": {}, "cross": {}}
               if strategy == "hierarchical" else {
                   "local": {"float32": h["ici"]},
                   "cross": {h["cross_label"] or "float32": h["dcn"]}}}
        if cross:
            # The cross leg's two-leg bound at cross n = 2: each node's
            # quantization of its shard block, and the sum's requantization.
            pad = (-total) % 2
            shard = (total + pad) // 2
            sums = [torch.nn.functional.pad(s, (0, pad)).view(2, shard)
                    for s in node]
            blk = -(-shard // (2 * wire.BLOCK)) * 2 * wire.BLOCK
            ms = [torch.nn.functional.pad(s.abs(), (0, blk - shard))
                  .view(2, -1, wire.BLOCK).amax(dim=2) for s in sums]
            m = ms[0] + ms[1]
            bound = (m / 254 + m * (1 + 1 / 254) / 254).repeat_interleave(
                wire.BLOCK, dim=1)[:, :shard].reshape(-1)[:total]
            share = ((got.double() - want.double()).abs()
                     / (bound.double() + 1e-30)).max().item()
            row["two_leg_worst_share"] = share
            row["moved"] = int((got != want).sum())
        else:
            row["bit_equal"] = torch.equal(got, want)
        out[strategy] = row
    rt.strategy = "flat"
    ragged = [torch.full((k, 3), float(r)) for r, k in enumerate((1, 3, 0,
                                                                  2))]
    gathered = hvd.allgather(ragged[rank])
    out["allgather_rank_major"] = torch.equal(gathered, torch.cat(ragged))
    out["allgather_node_shape"] = list(topo.node_shape())
    out.update(hier_control_plane(torch, hvd, args, rank))
    emit({"phase": "launched_worker", "kind": "hier_cpu", **out})
    hvd.shutdown()
    return 0


def hier_fused(torch, hvd, seed, rank):
    """HIER_FUSED's tensors (from --seed and the rank) through one grouped
    async allreduce and one async allreduce each (Sum) on the runtime the
    knobs build: the values, the buckets and this rank's boundary role."""
    from horovod_tpu_torch.ops.fusion import get_runtime
    rt = get_runtime()
    gen = torch.Generator().manual_seed(seed + 50 + rank)
    ts = [torch.randn(n, generator=gen).to(getattr(torch, dt))
          for n, dt in HIER_FUSED]
    mark = len(rt.recent_buckets(4096))
    hs = hvd.grouped_allreduce_async(ts, op=hvd.Sum, name="cp.grouped")
    hs += [hvd.allreduce_async(t, op=hvd.Sum, name=f"cp.{i}")
           for i, t in enumerate(ts)]
    vals = [h.synchronize() for h in hs]
    buckets = [[why, sig[4], [n for _, n in sig[-1]]]
               for why, sig in rt.recent_buckets(4096)[mark:]]
    return vals, buckets, rt._cp_role


def hier_control_plane(torch, hvd, args, rank):
    """The control plane of a 2 x 2 world launched with
    HIER_CONTROL_FLAGS: fused buckets on the hierarchical boundary stream,
    then the same tensors on a flat one (a new runtime); the negotiation
    and boundary traffic of the hierarchical stretch (the order check's
    rounds among it); the telemetry plane's job view once every rank is in
    it."""
    from horovod_tpu_torch.common import basics, negotiation
    from horovod_tpu_torch.ops import fusion
    hier_vals, hier_buckets, role = hier_fused(torch, hvd, args.seed, rank)
    stats = negotiation.stats_snapshot()       # the hierarchical stretch
    os.environ["HOROVOD_CONTROL_PLANE"] = "flat"
    fusion.reset_runtime()
    flat_vals, flat_buckets, flat_role = hier_fused(torch, hvd, args.seed,
                                                    rank)
    deadline = time.monotonic() + 30
    view = hvd.cluster_snapshot()
    while time.monotonic() < deadline and (
            view.get("local_only") or view["counts"]["healthy"] != 4):
        time.sleep(0.2)
        view = hvd.cluster_snapshot()
    return {"control_plane": {
        "role": role, "flat_role": flat_role,
        "buckets_equal": hier_buckets == flat_buckets,
        "bit_equal": all(torch.equal(a, b)
                         for a, b in zip(hier_vals, flat_vals)),
        "buckets": hier_buckets, "stats": stats,
        "kv_shard_ports": os.environ.get("HOROVOD_KV_SHARD_PORTS", ""),
        "order_check": basics._get_state().config.order_check,
        "job_view": {k: view.get(k) for k in (
            "world", "num_slices", "leader", "counts", "local_only")}}}


def phase_hier_cpu_world(args):
    """``-np 4`` through the launcher on two "hosts" of 2 CPU (gloo) ranks
    with HOROVOD_MESH_SLICES=2: the 2 x 2 layout. Checks: torus and
    hierarchical bit-equal to the sums each rank computes, torus_qcross
    (int8 cross leg) within the two-leg bound, per-tier bytes equal to
    hierarchical_wire_bytes, the hierarchical allgather in rank-major
    order. A CPU run, printed as one."""
    saved = {k: os.environ.get(k) for k in HIER_ENV}
    os.environ.update(HIER_ENV)
    try:
        rc, lines, log = run_launcher(args, 4, "hier_cpu", 240, launcher=[
            "-np", "4", "-H", HIER_HOSTS], flags=HIER_CONTROL_FLAGS)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(rc == 0 and len(lines) == 4, f"the 4-process CPU world exits 0 "
          f"(rc {rc}):\n{log}")
    by_rank = {w["rank"]: w for w in lines}
    check(sorted(by_rank) == [0, 1, 2, 3] and all(
        w["layout"] == [2, 2, [2, 2]] for w in lines),
        f"a 2 x 2 layout on every rank: {[w['layout'] for w in lines]}")
    for w in lines:
        for strategy in ("torus", "hierarchical", "torus_qcross"):
            r = w[strategy]
            check(r["strategies"] == {strategy: 1}
                  and r["tiers"] == r["tiers_formula"],
                  f"rank {w['rank']} {strategy}: one bucket, the per-tier "
                  f"bytes of hierarchical_wire_bytes: {r}")
        check(w["torus"]["bit_equal"] and w["hierarchical"]["bit_equal"],
              f"rank {w['rank']}: torus and hierarchical bit-equal to the "
              f"sums")
        q = w["torus_qcross"]
        check(q["two_leg_worst_share"] <= 1.0 and q["moved"] > 0,
              f"rank {w['rank']}: torus_qcross within the int8 two-leg "
              f"bound, and lossy: {q}")
        check(w["allgather_rank_major"], f"rank {w['rank']}: the "
              f"hierarchical allgather in rank-major order")
        cp = w["control_plane"]
        st = cp["stats"]
        member = w["rank"] % 2 == 1          # slices [0, 1] and [2, 3]
        check(cp["bit_equal"] and cp["buckets_equal"] and cp["buckets"],
              f"rank {w['rank']}: the hierarchical boundary stream's "
              f"buckets bit-equal to the flat one's: {cp['buckets']}")
        check(st["rounds"] > 0 and st["hier_rounds"] == st["rounds"]
              and st["gets"] == st["rounds"] * (1 if member else 2),
              f"rank {w['rank']}: every order-check round hierarchical, "
              f"{'1 get' if member else '2 gets'} a round: {st}")
        check(cp["order_check"] and len(cp["kv_shard_ports"].split(",")) == 2,
              f"rank {w['rank']}: --order-check and two KV shards reached "
              f"the worker: {cp['kv_shard_ports']!r}")
        view = cp["job_view"]
        check(not view["local_only"] and view["world"] == 4
              and view["counts"]["healthy"] == 4,
              f"rank {w['rank']}: the job view names four healthy ranks: "
              f"{view}")
    roles = [by_rank[r]["control_plane"]["role"] for r in range(4)]
    check(roles == ["root", "leader", "leader", "member"],
          f"the boundary roles of the 2 x 2 layout: {roles}")
    member = by_rank[3]["control_plane"]["stats"]
    check(member["fusion_root_gets"] == 0 and member["fusion_slice_gets"] > 0,
          f"the member reads no root boundary: {member}")
    emit({"phase": "hier_cpu_world", "run_on": "CPU (gloo), not the card",
          "hosts": HIER_HOSTS, "env": HIER_ENV, "ranks": 4,
          "flags": HIER_CONTROL_FLAGS, "bucket": HIER_BUCKET,
          "control_plane": {r: by_rank[r]["control_plane"]["stats"]
                            for r in range(4)},
          "job_view": by_rank[0]["control_plane"]["job_view"],
          "rank0": by_rank[0]})


# ---------------------------------------------------------------------------
# A12's first half on the card: the mesh path, the flash ring, ZeRO and FSDP
# ---------------------------------------------------------------------------

# The (dp, sp, tp) mesh of train_gpt_tp_sp: one rank, every axis of size 1.
TP_SP_MESH = {"dp": 1, "sp": 1, "tp": 1}
# ring_flash: four virtual ranks over an 8,192-token sequence at GPT-2
# small's attention (12 heads) and LLaMA-400M's (16 query heads over 8 kv
# heads), head dim 64, batch 2, bf16, causal.
RING_N, RING_BATCH, RING_SEQ, RING_HEAD_DIM = 4, 2, 8192, 64
RING_CASES = {"gpt2_small": (12, 12), "llama_400m": (16, 8)}
# The ring's limit: the flash rounding bound (flash_attention.
# rounding_bounds, c = ROUNDING_C) of one full-sequence call, with c raised
# by one. The ring rounds each hop's o (and each hop's dQ, dK and dV) to
# bf16 before its fp32 sum, one more rounding of an operand whose size the
# bound's u |A| |B| term already bounds (sum_h w_h |o_h| <= |P| |V| / l,
# sum_h |dQ_h| <= |dS| |K|); the combine's own fp32 arithmetic is far below
# it. Rows of 64 keys' tiles mask as one call's do.
RING_C_EXTRA = 1.0
RING_REF_ROWS = 2         # rows of (BH, L, D) per chunk of the fp32 plain
ZERO_FSDP_STEPS = 3


def ring_bound_ratios(torch, fa, q3, k3, v3, got, extra, group=1,
                      do3=None, out3=None, lse=None):
    """max |got - plain| / bound over the elements of each output in
    ``got`` (full-sequence (BH, L, D) tensors; k3/v3 repeated to the query
    rows): the plain fp32 version on the card, and the rounding bound of
    one causal full-sequence call with c raised by ``extra``, in chunks of
    whole GQA groups. With ``group`` > 1, dK and dV are the narrow rows:
    the plain gradients and their bounds are summed over each group, as the
    hops fold theirs."""
    dt, scale = q3.dtype, q3.shape[-1] ** -0.5
    rows = max(RING_REF_ROWS, group)
    worst = dict.fromkeys(got, 0.0)
    for i in range(0, q3.shape[0], rows):
        sl = slice(i, i + rows)
        q, k, v = q3[sl], k3[sl], v3[sl]
        if "o" in got:
            plain = {"o": fa.block_fwd_reference(q, k, v, True, scale)[0]
                     .float()}
            bounds = fa.rounding_bounds(plain, q, k, v, True, scale)
        else:
            dq, dk, dv = fa.block_bwd_reference(
                q.float(), k.float(), v.float(), out3[sl].float(), lse[sl],
                do3[sl].float(), True, scale)
            plain = {"dq": dq, "dk": dk, "dv": dv}
            bounds = fa.rounding_bounds(plain, q, k, v, True, scale,
                                        o3=out3[sl], lse=lse[sl],
                                        do3=do3[sl])
        for name, b in bounds.items():
            two_ulp = 2 * fa.ulp(plain[name], dt)
            b = two_ulp + (b - two_ulp) * (fa.ROUNDING_C + extra) \
                / fa.ROUNDING_C
            want, have = plain[name], got[name][sl]
            if group > 1 and name in ("dk", "dv"):
                fold = (lambda t: t.reshape(-1, group, *t.shape[1:])
                        .sum(dim=1))
                want, b = fold(want), fold(b)
                have = got[name][i // group:(i + rows) // group]
            worst[name] = max(worst[name], fa.bound_ratio(have, want, b))
        del plain, bounds
    return worst


def phase_ring_flash(torch, dev, seed, card):
    """The flash ring's schedule (``sequence.ring_flash_forward``/
    ``_backward``, the functions the ring over a process group runs) for
    RING_N virtual ranks in one process (``sequence.rotate``), at GPT-2
    small's and LLaMA-400M's attention over RING_SEQ tokens: the output and
    dQ/dK/dV against the plain fp32 full-sequence attention on the card
    within the ring's bound; two controls must fail it: each rank's hop 1
    left out of the combine (the output), and each hop's backward against
    its own lse instead of the ring-wide one (dQ, dK and dV); each rank r
    runs r + 1 hops (10 launches of each kernel at n = 4, counted); the
    summed ring against one full-sequence call of the same causal work
    (CUDA events)."""
    from horovod_tpu_torch.ops.kernels import flash_attention as fa
    from horovod_tpu_torch.parallel import sequence as sq
    n, L, d = RING_N, RING_SEQ, RING_HEAD_DIM
    Ls, dt = L // n, torch.bfloat16
    ranks = list(range(n))
    out = {}
    launches = dict.fromkeys(FLASH_COUNTS, 0)
    for name, (h, kvh) in RING_CASES.items():
        gen = torch.Generator(device=dev).manual_seed(seed + 11)
        b = RING_BATCH
        q, do = (torch.randn(b * h, L, d, generator=gen, device=dev).to(dt)
                 for _ in range(2))
        k, v = (torch.randn(b * kvh, L, d, generator=gen, device=dev).to(dt)
                for _ in range(2))
        heads = (h, kvh) if kvh != h else (None, None)
        scale = d ** -0.5

        def shards(t):
            return [t[:, r * Ls:(r + 1) * Ls].contiguous() for r in range(n)]
        qs, ks, vs, dos = shards(q), shards(k), shards(v), shards(do)

        def forward(hop_forward=None):
            return sq.ring_flash_forward(qs, ks, vs, ranks, n, True, scale,
                                         sq.rotate, *heads,
                                         hop_forward=hop_forward)

        def backward(outs, hop_backward=None):
            grads = sq.ring_flash_backward(
                qs, ks, vs, [o for o, _ in outs], [lse for _, lse in outs],
                dos, ranks, n, True, scale, sq.rotate, *heads,
                hop_backward=hop_backward)
            return [[t.to(dt) for t in g] for g in grads]

        def drop_hop1(q3, k3, v3, diag, *rest):
            # Rank r's hop on rank r + 1's block, weighted 0 in the combine.
            o, lse = sq.ring_hop_forward(q3, k3, v3, diag, *rest)
            r = [t is q3 for t in qs].index(True)
            if k3 is ks[(r + 1) % n]:
                lse = torch.full_like(lse, -math.inf)
            return o, lse

        def own_lse(q3, k3, v3, o3, lse, do3, diag, scale, *h):
            own = sq.ring_hop_forward(q3, k3, v3, diag, scale, *h)[1]
            return sq.ring_hop_backward(q3, k3, v3, o3, own, do3, diag,
                                        scale, *h)
        fa.reset_launch_counts()
        outs, hops = forward()
        grads = backward(outs)
        torch.cuda.synchronize()
        counts = (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
        want = sum(r + 1 for r in range(n))
        check(hops == [r + 1 for r in range(n)] and counts == (want,) * 3,
              f"{name}: rank r runs r + 1 hops, {want} launches of each "
              f"flash kernel: hops {hops}, launches {counts}")
        for key, c in zip(FLASH_COUNTS, counts):
            launches[key] += c
        full = lambda ts: torch.cat(ts, dim=1)          # noqa: E731
        o_ring = full([o for o, _ in outs])
        lse_ring = full([l for _, l in outs])
        dq, dk, dv = (full(g) for g in grads)
        km, vm = k, v
        if kvh != h:
            km, vm = (fa.gqa_repeat3(t, b, kvh, h // kvh).contiguous()
                      for t in (k, v))
        # One more rounding of each hop's outputs to bf16; under GQA one
        # more again, the hop's bf16 fold of dK/dV over its group.
        extra, g = RING_C_EXTRA + (kvh != h), h // kvh
        ratios = ring_bound_ratios(torch, fa, q, km, vm, {"o": o_ring},
                                   extra, g)
        ratios.update(ring_bound_ratios(
            torch, fa, q, km, vm, {"dq": dq, "dk": dk, "dv": dv}, extra, g,
            do3=do, out3=o_ring, lse=lse_ring))
        bad, _ = forward(drop_hop1)
        control = ring_bound_ratios(torch, fa, q, km, vm,
                                    {"o": full([o for o, _ in bad])},
                                    extra, g)["o"]
        bad_grads = [full(t) for t in backward(outs, own_lse)]
        control_bwd = ring_bound_ratios(
            torch, fa, q, km, vm, dict(zip(("dq", "dk", "dv"), bad_grads)),
            extra, g, do3=do, out3=o_ring, lse=lse_ring)
        check(all(r <= 1.0 for r in ratios.values()),
              f"{name}: the ring within its bound: {ratios}")
        check(control > 1.0, f"{name}: the control leaving hop 1 out of "
              f"the combine fails the bound: {control}")
        check(all(r > 1.0 for r in control_bwd.values()),
              f"{name}: the control running each hop's backward against "
              f"its own lse fails the bound on dQ, dK and dV: {control_bwd}")
        ring_fwd_ms = event_ms(forward, reps=10)
        ring_bwd_ms = event_ms(lambda: backward(outs), reps=10)
        o1, lse1 = fa.fa_forward(q, k, v, True, scale, None, None, *heads)
        full_fwd_ms = event_ms(lambda: fa.fa_forward(
            q, k, v, True, scale, None, None, *heads), reps=10)
        full_bwd_ms = event_ms(lambda: fa.fa_backward(
            q, km, vm, o1, lse1, do, True, scale), reps=10)
        hop_ms = sum(event_ms(lambda r=r, s=s: sq.ring_hop_forward(
            qs[r], ks[(r + s) % n], vs[(r + s) % n], s == 0, scale, *heads),
            reps=10) for s in range(n) for r in range(n)
            if sq.ring_hop_plan(r, s, n, True)[0])
        out[name] = {
            "heads": h, "kv_heads": kvh, "batch": b, "seq": L, "shard": Ls,
            "head_dim": d, "hops_per_rank": hops,
            "launches": dict(zip(FLASH_COUNTS, counts)),
            "bound_ratio": ratios, "bound_c": fa.ROUNDING_C + extra,
            "control_drop_hop1_ratio": control,
            "control_own_lse_bwd_ratio": control_bwd,
            "ring_fwd_ms": ring_fwd_ms, "ring_bwd_ms": ring_bwd_ms,
            "ring_fwd_hop_kernels_ms": hop_ms,
            "full_fwd_ms": full_fwd_ms, "full_bwd_ms": full_bwd_ms,
            "fwd_ratio": ring_fwd_ms / full_fwd_ms,
            "bwd_ratio": ring_bwd_ms / full_bwd_ms}
        del q, k, v, do, qs, ks, vs, dos, outs, grads, bad, bad_grads, o1, \
            lse1
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "ring_flash", "virtual_ranks": n, "dtype": "bfloat16",
          "causal": True, "cases": out,
          "limit": "flash_attention.rounding_bounds of one full-sequence "
                   "causal call, c raised by one (each hop's outputs "
                   "rounded to bf16 before the fp32 sum) and by one more "
                   "under GQA (the hop's bf16 fold of dK/dV)",
          "note": "ring_fwd/bwd_ms: every virtual rank's hops and the "
                  "fp32 combine, one after another on one card (no "
                  "transfer); full_*_ms: one call over the whole sequence "
                  "(the backward on K/V repeated to the query heads)",
          "card": card})
    return launches


def step_counts(fa, sb):
    return (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches,
            sb.pack_launches, sb.unpack_launches)


def timed_steps(torch, fa, sb, step, steps, warmup):
    """``warmup`` + ``steps`` calls of ``step()`` (returning the loss):
    the losses, each step's (flash fwd, dQ, dK/dV, pack, unpack) launches,
    and the timed steps' seconds."""
    losses, per_step = [], []
    for i in range(warmup + steps):
        if i == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        c0 = step_counts(fa, sb)
        losses.append(step())
        per_step.append([b - a for a, b in zip(c0, step_counts(fa, sb))])
    torch.cuda.synchronize()
    return [l.item() for l in losses], per_step, time.perf_counter() - t0


def phase_train_gpt_tp_sp(torch, hvd, dev, args, card, gpt_run):
    """GPT-2 small (train_gpt's weights and batch) through
    ``parallel/dp.py::make_train_step`` on a (dp, sp, tp) = (1, 1, 1) NCCL
    mesh with ``tp_axis="tp"``, ``sp_axis="sp"``, once with the ring and
    once with Ulysses: step 1's loss and every gradient bit-equal to the
    no-axis model's (the row-parallel sums and the all-to-alls are copies,
    the ring's one causal hop combines exactly); then each trained with
    AdamW in ``hvd.DistributedOptimizer`` on the dp axis's process set,
    beside the same loop with no mesh: launches a step (12 + 12 + 12 flash,
    a pack and an unpack per bucket) and tokens/s."""
    import dataclasses

    import torch.nn.functional as F

    from horovod_tpu_torch.models import GPT
    from horovod_tpu_torch.ops import in_step
    from horovod_tpu_torch.ops.kernels import flash_attention as fa
    from horovod_tpu_torch.ops.kernels import scale_buffers as sb
    from horovod_tpu_torch.parallel import dp

    mesh = in_step.make_mesh(TP_SP_MESH)
    ref = build_gpt(torch, dev, args.seed)
    ids = gpt_batch(torch, ref, dev, args.seed)
    lf, gf = grads_of(torch, ref, lambda: next_token_loss(F, ref(ids), ids))
    init = {n: p.detach().clone() for n, p in ref.named_parameters()}
    del ref
    runs, launches = {}, dict.fromkeys(STEP_COUNTS, 0)
    for impl in ("none", "ring", "ulysses"):
        gc.collect()
        torch.cuda.empty_cache()
        cfg = gpt_config(torch, use_flash=True)
        bound = impl != "none"
        if bound:
            cfg = dataclasses.replace(cfg, tp_axis="tp", sp_axis="sp",
                                      sp_impl=impl)
        with (in_step.axes(mesh) if bound else contextlib.nullcontext()):
            model = GPT(cfg, generator=torch.Generator().manual_seed(
                args.seed)).to(dev).train()
        check(all(torch.equal(p, init[n])
                  for n, p in model.named_parameters()),
              f"{impl}: the same weights as train_gpt's")
        loss_fn = (lambda m, batch:                     # noqa: E731
                   next_token_loss(F, m(batch), batch))
        if bound:
            fa.reset_launch_counts()
            with in_step.axes(mesh):
                l1, g1 = grads_of(torch, model,
                                  lambda: loss_fn(model, ids))
            step1 = (fa.fwd_launches, fa.bwd_dq_launches,
                     fa.bwd_dkv_launches)
            check(l1 == lf and all(torch.equal(g1[n], gf[n]) for n in gf),
                  f"{impl}: step 1's loss and every gradient bit-equal to "
                  f"the no-axis model's: {l1} vs {lf}, differing "
                  f"{[n for n in gf if not torch.equal(g1[n], gf[n])][:5]}")
            check(step1 == (cfg.num_layers,) * 3,
                  f"{impl}: step 1 launched {step1} flash kernels")
            del g1
            model.zero_grad(set_to_none=True)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-4,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)
        opt = hvd.DistributedOptimizer(
            opt, named_parameters=model.named_parameters(),
            process_set=dp.axis_process_set(mesh, "dp"))
        state = dp.TrainState.create(model, opt)
        if bound:
            train = dp.make_train_step(loss_fn, opt, mesh, axis_name="dp",
                                       sum_axes=("sp",))

            def step():
                return train(state, ids)[1]
        else:
            def step():
                opt.zero_grad()
                value = loss_fn(model, ids)
                value.backward()
                opt.step()
                return value.detach()
        fa.reset_launch_counts()
        sb.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        losses, per_step, elapsed = timed_steps(torch, fa, sb, step,
                                                GPT_STEPS, args.warmup)
        opt._remove_hooks()
        check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
              f"{impl}: finite, falling losses {losses}")
        check(all(s[:3] == [cfg.num_layers] * 3 and s[3] == s[4] > 0
                  for s in per_step),
              f"{impl}: 12 + 12 + 12 flash launches and a pack and an "
              f"unpack per bucket every step: {per_step}")
        runs[impl] = {"losses": losses, "launches_per_step": per_step,
                      "tokens_per_sec": GPT_BATCH * GPT_SEQ * GPT_STEPS
                      / elapsed,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        if bound:
            for k, v in zip(STEP_COUNTS, step_counts(fa, sb)):
                launches[k] += v
        del model, opt, state, step
        train = None
    same = {impl: runs[impl]["losses"] == runs["none"]["losses"]
            for impl in ("ring", "ulysses")}
    emit({"phase": "train_gpt_tp_sp", "model": "GPT-2 small",
          "mesh": TP_SP_MESH, "batch": GPT_BATCH, "seq": GPT_SEQ,
          "optimizer": ADAMW.format(lr=1e-4),
          "step1_bit_equal_to_no_axis": True,
          "losses_equal_to_no_axis_run": same, "runs": runs,
          "train_gpt_tokens_per_sec": gpt_run.get("tokens_per_sec"),
          "train_gpt_launches_per_step": gpt_run.get("launches_per_step"),
          "note": "none: the same loop with no mesh in this phase; ring "
                  "and ulysses: make_train_step on the mesh (sp and tp "
                  "axes bound at size 1, every collective a copy)",
          "card": card})
    return launches


# train_zero/train_fsdp against the replicated AdamW, one H100: after one
# update every parameter within ZERO_FSDP_ULPS fp32 ulps (at the larger of
# the parameter's size before and after) of the replicated path's, and
# each step's loss within ZERO_FSDP_LOSS_REL. Not bit-equal: torch's AdamW
# takes its foreach implementation only when every parameter's type is
# Tensor or Parameter, so over the model's 149 tensors (FlaxKernel, a
# Parameter subclass, among them) it runs the single-tensor one, and over
# ZeRO's one flat vector the foreach one, which rounds some elements
# differently. The phase holds ZeRO bit-equal to the replicated AdamW with
# foreach forced on, which shows that cause. The limit: each side computes the update u = after - before
# * (1 - lr wd) with four roundings after the moments (the square root,
# the bias correction's division, the eps addition, the quotient), each
# within 1 ulp of |u| <= |before| + |after| <= 2 scale: 2 sides x 4 x 2 =
# 16 ulps of the scale. Read on an NVIDIA H100 80GB HBM3 at 700 W, seed 0:
# one update from bit-equal gradients and parameters left 128 of 149
# tensors apart, by at most 5 such ulps; over five steps the bf16
# activations carried that into the losses, 1.5e-5 relative at step 5.
ZERO_FSDP_ULPS = 16
ZERO_FSDP_LOSS_REL = 1e-4


def ulps_apart(torch, a, b, before):
    """max |a - b| in fp32 ulps of the larger of |b| and |before| (the
    parameter before the update): the update's roundings are within ulps
    of its operands, and an element that cancels to near zero keeps their
    error, not one of its own size."""
    scale = torch.maximum(b.abs(), before.abs())
    spacing = torch.nextafter(scale, torch.full_like(b, math.inf)) - scale
    return ((a - b).abs() / spacing).max().item()


def phase_train_zero_fsdp(torch, hvd, dev, args, card):
    """GPT-2 small at one NCCL rank from train_gpt's weights and batch: the
    replicated AdamW in hvd.DistributedOptimizer through
    ``make_train_step``, ZeRO-1 (``make_zero_train_step``, AdamW on the flat
    shard) and FSDP (``make_fsdp_train_step``, every leaf of 16384 elements
    or more sharded over one rank), one step, then --warmup - 1 and
    ZERO_FSDP_STEPS timed steps. Checks: after the first update every
    parameter of ZeRO and FSDP within ZERO_FSDP_ULPS of the replicated
    path's, each step's loss within ZERO_FSDP_LOSS_REL, and ZeRO's first
    update bit-equal to the replicated path's with AdamW's foreach
    implementation forced on (``foreach=True``, the one torch picks for
    ZeRO's flat vector); 12 + 12 + 12 flash launches a step. Reported: bit-equality, tokens/s and the peak of
    allocated memory of each (at n = 1 no saving is expected: ZeRO's shard
    and FSDP's shards are whole)."""
    import functools

    import torch.nn.functional as F

    from horovod_tpu_torch.ops import in_step
    from horovod_tpu_torch.ops.kernels import flash_attention as fa
    from horovod_tpu_torch.ops.kernels import scale_buffers as sb
    from horovod_tpu_torch.parallel import dp
    from horovod_tpu_torch.parallel import fsdp as tf

    mesh = in_step.make_mesh({"hvd": 1})
    tx = functools.partial(torch.optim.AdamW, lr=1e-4, betas=(0.9, 0.999),
                           eps=1e-8, weight_decay=1e-4)

    def loss_fn(m, batch):
        return next_token_loss(F, m(batch), batch)
    runs, first, launches = {}, {}, {}
    for kind in ("replicated", "replicated_foreach", "zero", "fsdp"):
        gc.collect()
        torch.cuda.empty_cache()
        model = build_gpt(torch, dev, args.seed)
        ids = gpt_batch(torch, model, dev, args.seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if kind.startswith("replicated"):
            opt = hvd.DistributedOptimizer(
                tx(model.parameters(), foreach=True) if kind.endswith(
                    "foreach") else tx(model.parameters()),
                named_parameters=model.named_parameters())
            state = dp.TrainState.create(model, opt)
            train = dp.make_train_step(loss_fn, opt, mesh)

            def step():
                return train(state, ids)[1]
        elif kind == "zero":
            state = dp.ZeroTrainState.create(model, tx, mesh)
            train = dp.make_zero_train_step(loss_fn, tx, mesh)

            def step():
                return train(state, ids)[1]
        else:
            init_fn, train = tf.make_fsdp_train_step(loss_fn, tx, mesh)
            fsdp, opt = init_fn(model)

            def step():
                return train(fsdp, opt, ids)[2]
        # Reference copies go to the host, out of the peaks measured.
        if kind == "replicated":
            before = {n: p.detach().cpu()
                      for n, p in model.named_parameters()}
        fa.reset_launch_counts()
        sb.reset_launch_counts()
        c0 = step_counts(fa, sb)
        loss1 = step().item()
        step1 = [b - a for a, b in zip(c0, step_counts(fa, sb))]
        first[kind] = {n: p.detach().cpu()
                       for n, p in model.named_parameters()}
        losses, per_step, elapsed = timed_steps(
            torch, fa, sb, step, ZERO_FSDP_STEPS, args.warmup - 1)
        losses, per_step = [loss1] + losses, [step1] + per_step
        if kind.startswith("replicated"):
            opt._remove_hooks()
        if kind == "fsdp":
            fsdp.remove()
        check(all(s[:3] == [GPT_LAYERS] * 3 for s in per_step),
              f"{kind}: 12 + 12 + 12 flash launches a step: {per_step}")
        launches[kind] = dict(zip(STEP_COUNTS, step_counts(fa, sb)))
        runs[kind] = {"losses": losses, "launches_per_step": per_step,
                      "tokens_per_sec": GPT_BATCH * GPT_SEQ
                      * ZERO_FSDP_STEPS / elapsed,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        del model, step
        state = opt = fsdp = train = None
    ref = first["replicated"]
    for kind in ("zero", "fsdp"):
        r, got = runs[kind], first[kind]
        r["step1_bit_equal"] = all(torch.equal(got[n], p)
                                   for n, p in ref.items())
        r["step1_tensors_differing"] = sum(not torch.equal(got[n], p)
                                           for n, p in ref.items())
        r["step1_max_ulps"] = max(ulps_apart(torch, got[n], p, before[n])
                                  for n, p in ref.items())
        r["step1_max_abs_diff"] = max((got[n] - p).abs().max().item()
                                      for n, p in ref.items())
        r["loss_rel"] = max(abs(a - b) / abs(b) for a, b in zip(
            r["losses"], runs["replicated"]["losses"]))
    foreach = first["replicated_foreach"]
    runs["zero"]["step1_bit_equal_to_foreach_adamw"] = all(
        torch.equal(first["zero"][n], p) for n, p in foreach.items())
    check(runs["zero"]["step1_bit_equal_to_foreach_adamw"],
          "ZeRO's first update bit-equal to the replicated AdamW's with "
          "foreach=True")
    check(all(runs[k]["step1_max_ulps"] <= ZERO_FSDP_ULPS
              and runs[k]["loss_rel"] <= ZERO_FSDP_LOSS_REL
              for k in ("zero", "fsdp")),
          f"after one update every parameter within {ZERO_FSDP_ULPS} ulps "
          f"of the replicated path's, each loss within {ZERO_FSDP_LOSS_REL}: "
          + ", ".join(f"{k} {runs[k]['step1_max_ulps']} ulps, "
                      f"{runs[k]['loss_rel']}" for k in ("zero", "fsdp")))
    for kind in ("zero", "fsdp"):
        emit({"phase": f"train_{kind}", "model": "GPT-2 small",
              "batch": GPT_BATCH, "seq": GPT_SEQ, "ranks": 1,
              "optimizer": ADAMW.format(lr=1e-4), "run": runs[kind],
              "replicated": runs["replicated"],
              "replicated_foreach": runs["replicated_foreach"],
              "limits": {"step1_ulps": ZERO_FSDP_ULPS,
                         "loss_rel": ZERO_FSDP_LOSS_REL},
              "note": "one rank: ZeRO's flat shard and FSDP's shards are "
                      "the whole vectors, so no memory saving is expected",
              "card": card})
    return launches["zero"], launches["fsdp"]


# ---------------------------------------------------------------------------
# A12's second half: MoE, the pipelines and the composite trainer.
# ---------------------------------------------------------------------------

# GPT-2 small's widths with 8 experts in every second block (Switch
# Transformer's layout: top-1, capacity factor 2.0, JAX's default), and the
# load-balancing loss at Switch's weight.
MOE_EXPERTS, MOE_CF, MOE_AUX = 8, 2.0, 0.01
GPT_MOE_PARAMS = 361_304_064
MOE_PHASES = ("start", "router", "dispatch", "experts", "combine")
# The composite trainers: 4 microbatches of COMPOSITE_MB x 1024 (GPT_BATCH
# x GPT_SEQ a step), COMPOSITE_STEPS timed steps after --warmup.
COMPOSITE_MICRO, COMPOSITE_STEPS = GPT_BATCH // COMPOSITE_MB, 4
# The composite's first step against the same modules on the whole batch
# with no pipeline: the blocks' bf16 products run at 2,048 rows a
# microbatch in the one and 8,192 in the other, so cuBLAS may round them
# otherwise (a bf16 rounding, 2^-8, of an activation here and there,
# carried through 12-24 blocks); the embedding, the MoE FFN (its route
# included) and the head see the same inputs either way. The limits: the
# loss within 2e-3 relative (half a bf16 rounding), each gradient within
# 0.05 of its norm (GPT_CMP_LIMITS's 3e-2 is two bf16 attention paths
# against each other).
COMPOSITE_LIMITS = {"loss_rel": 2e-3, "grad_rel": 5e-2}
# 1F1B against gpipe, first step, the same weights and batch: the same
# products in each microbatch; the head's TF32 products on a microbatch
# (2,048 rows) instead of the whole batch, and each parameter's gradient
# summed over the microbatches in the other order (fp32).
F1B_LIMITS = {"loss_rel": 1e-4, "grad_rel": 2e-2}
# pipeline_virtual: S stages of GPT-2 small's blocks, M microbatches of
# COMPOSITE_MB x GPT_SEQ tokens. Each stage runs the sequential stack's
# products on the same inputs, so outputs may differ by no rounding and
# gradients by the order of their M fp32 sums; the limits allow one bf16
# rounding of an output and twice the (M - 1) u sum_m |g_m| error bound of
# a sum of M terms, in any order.
VIRTUAL_STAGES, VIRTUAL_MICRO = 4, 8
VIRTUAL_LIMITS = {"out": "|y - y_seq| <= 2^-8 |y_seq|",
                  "grad": "|g - g_seq| <= 2 (M - 1) 2^-24 sum_m |g_m|"}


def moe_config(torch, ep_axis):
    import dataclasses
    return dataclasses.replace(gpt_config(torch, use_flash=True),
                               num_experts=MOE_EXPERTS, moe_k=1,
                               capacity_factor=MOE_CF, ep_axis=ep_axis)


def moe_loss(F, model, ids):
    """Next-token loss plus the MoE blocks' load-balancing losses."""
    return next_token_loss(F, model(ids), ids) + MOE_AUX * sum(model.moe_aux)


def moe_split(torch, model, ids):
    """One forward with a CUDA event at each MoE layer's marks: each
    layer's router, dispatch, expert-product and combine ms, and its share
    of dropped choices."""
    from horovod_tpu_torch.parallel.moe import MoEMlp
    marks = []
    layers = [m for m in model.modules() if isinstance(m, MoEMlp)]

    def hook(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append((name, e))
    for m in layers:
        m.phase_hook = hook
    try:
        with torch.no_grad():
            model(ids)
    finally:
        for m in layers:
            m.phase_hook = None
    torch.cuda.synchronize()
    n = len(MOE_PHASES)
    check(len(marks) == n * len(layers) and all(
        [k for k, _ in marks[i:i + n]] == list(MOE_PHASES)
        for i in range(0, len(marks), n)),
        f"the MoE layers marked their phases: {[k for k, _ in marks]}")
    tokens = ids.numel()
    out = []
    for i, moe in zip(range(0, len(marks), n), layers):
        ev = [e for _, e in marks[i:i + n]]
        out.append({**{MOE_PHASES[j + 1]: ev[j].elapsed_time(ev[j + 1])
                       for j in range(n - 1)},
                    "dropped_share": int(moe.last_dropped) / tokens})
    return out


def phase_train_gpt_moe(torch, hvd, dev, args, card):
    """GPT-2 small's widths with 8 experts in every second block, through
    ``make_train_step`` on a (dp, ep) = (1, 1) mesh with ``ep_axis="ep"``
    beside the same weights with ``ep_axis=None`` and no mesh: losses
    bit-equal, 12 + 12 + 12 flash launches and a pack and an unpack per
    bucket every step; tokens/s, the peak, the MoE layers' forward split
    and dropped shares."""
    import torch.nn.functional as F

    from horovod_tpu_torch.models import GPT
    from horovod_tpu_torch.ops import in_step
    from horovod_tpu_torch.ops.kernels import flash_attention as fa
    from horovod_tpu_torch.ops.kernels import scale_buffers as sb
    from horovod_tpu_torch.parallel import dp

    mesh = in_step.make_mesh({"dp": 1, "ep": 1})
    runs, init, ids, launches, split = {}, None, None, None, None
    for impl in ("none", "ep"):
        gc.collect()
        torch.cuda.empty_cache()
        bound = impl == "ep"
        cfg = moe_config(torch, "ep" if bound else None)
        with (in_step.axes(mesh) if bound else contextlib.nullcontext()):
            model = GPT(cfg, generator=torch.Generator().manual_seed(
                args.seed)).to(dev).train()
        n_params = sum(p.numel() for p in model.parameters())
        check(n_params == GPT_MOE_PARAMS, f"the MoE GPT has "
              f"{GPT_MOE_PARAMS:,} parameters, this model {n_params}")
        if init is None:
            init = {n: p.detach().clone() for n, p in model.named_parameters()}
            ids = gpt_batch(torch, model, dev, args.seed)
        else:
            check(all(torch.equal(p, init[n])
                      for n, p in model.named_parameters()),
                  f"{impl}: the same weights as the no-axis model's")
        opt = torch.optim.AdamW(model.parameters(), lr=1e-4,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)
        opt = hvd.DistributedOptimizer(
            opt, named_parameters=model.named_parameters(),
            process_set=dp.axis_process_set(mesh, "dp") if bound else None)
        if bound:
            state = dp.TrainState.create(model, opt)
            train = dp.make_train_step(
                lambda m, batch: moe_loss(F, m, batch), opt, mesh,
                axis_name="dp")

            def step():
                return train(state, ids)[1]
        else:
            def step():
                opt.zero_grad()
                value = moe_loss(F, model, ids)
                value.backward()
                opt.step()
                return value.detach()
        fa.reset_launch_counts()          # the path starts here
        sb.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        losses, per_step, elapsed = timed_steps(torch, fa, sb, step,
                                                GPT_STEPS, args.warmup)
        if bound:
            launches = dict(zip(STEP_COUNTS, step_counts(fa, sb)))
        peak = torch.cuda.max_memory_allocated() / 1e9
        opt._remove_hooks()
        check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
              f"{impl}: finite, falling losses {losses}")
        check(all(s[:3] == [cfg.num_layers] * 3 and s[3] == s[4] > 0
                  for s in per_step),
              f"{impl}: 12 + 12 + 12 flash launches and a pack and an "
              f"unpack per bucket every step: {per_step}")
        runs[impl] = {"losses": losses, "launches_per_step": per_step,
                      "tokens_per_sec": GPT_BATCH * GPT_SEQ * GPT_STEPS
                      / elapsed, "peak_mem_gb": peak}
        if bound:
            with in_step.axes(mesh):
                split = moe_split(torch, model, ids)
        del model, opt, step
        state = train = None
    check(runs["ep"]["losses"] == runs["none"]["losses"],
          f"the ep-bound losses bit-equal to the no-axis model's: "
          f"{runs['ep']['losses']} vs {runs['none']['losses']}")
    total = {k: sum(layer[k] for layer in split)
             for k in MOE_PHASES[1:]}
    emit({"phase": "train_gpt_moe", "model": "GPT-2 small MoE",
          "params": GPT_MOE_PARAMS, "experts": MOE_EXPERTS,
          "moe_layers": len(split), "k": 1, "capacity_factor": MOE_CF,
          "aux_weight": MOE_AUX, "batch": GPT_BATCH, "seq": GPT_SEQ,
          "optimizer": ADAMW.format(lr=1e-4), "mesh": {"dp": 1, "ep": 1},
          "losses_bit_equal_to_no_axis": True, "runs": runs,
          "moe_forward_ms_by_layer": split, "moe_forward_ms_total": total,
          "dropped_share_by_layer": [l["dropped_share"] for l in split],
          "note": "none: the same weights with ep_axis=None and no mesh; "
                  "ep: make_train_step on the mesh; moe_forward_ms: CUDA "
                  "events at the layer's marks in one forward (no "
                  "gradient recorded), after the training steps",
          "card": card})
    return launches


def composite_reference(torch, comp, ids):
    """The composite's modules on the whole batch with no pipeline and no
    microbatches, and a plain next-token loss (the trainer's own head loss
    is not used): its loss."""
    m = comp.model
    x = m.embed(ids)
    aux = None
    if m.moe is not None:
        h, aux = m.moe(x)
        x = x + h
    for block in m.stages:
        x = block(x)
    logits = m.head(x)[:, :-1].float()
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), ids[:, 1:].reshape(-1))
    return loss if aux is None else loss + comp.aux_weight * aux


def composite_grads(torch, comp, fn):
    """``fn()``'s loss and every parameter's gradient, copied."""
    loss = fn()
    torch.cuda.synchronize()
    return float(loss), {n: p.grad.detach().clone()
                         for n, p in comp.model.named_parameters()}


def composite_run(torch, fa, comp, ids, schedule, args, steps):
    """--warmup and ``steps`` timed steps: losses, flash launches a step,
    tokens/s and the peak of allocated memory (reset before the first)."""
    step = comp.make_train_step(schedule)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, per_step = [], []
    for i in range(args.warmup + steps):
        if i == args.warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        c0 = (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
        losses.append(step(ids))
        per_step.append([b - a for a, b in zip(c0, (
            fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches))])
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    losses = [float(v) for v in losses]
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"{schedule}: finite, falling losses {losses}")
    return {"losses": losses, "launches_per_step": per_step,
            "tokens_per_sec": ids.numel() * steps / elapsed,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def phase_train_composite(torch, dev, args, card):
    """CompositeGPT (GPT-2 small's widths with the shared 8-expert MoE FFN,
    gpipe) and CompositeLlama (LLaMA-400M, gpipe and 1F1B, each with and
    without remat) on a (1, 1, 1) mesh, 4 microbatches of 2 x 1024: the
    first step against the whole-batch modules, 1F1B's against gpipe's,
    1F1B's peak below gpipe's, flash launches a step; tokens/s and peaks."""
    import dataclasses
    import functools

    from horovod_tpu_torch.ops import in_step
    from horovod_tpu_torch.ops.kernels import flash_attention as fa
    from horovod_tpu_torch.parallel import (CompositeGPT, CompositeLlama,
                                            build_mesh3d)

    mesh = build_mesh3d(1, 1, 1)
    adamw = functools.partial(torch.optim.AdamW, lr=1e-4, betas=(0.9, 0.999),
                              eps=1e-8, weight_decay=1e-4)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 9)
    out, launches = {}, dict.fromkeys(FLASH_COUNTS, 0)
    families = (
        ("gpt", CompositeGPT, dataclasses.replace(
            gpt_config(torch, use_flash=True), num_experts=MOE_EXPERTS,
            capacity_factor=MOE_CF), ("gpipe",)),
        ("llama", CompositeLlama, llama_config(torch, True),
         ("gpipe", "1f1b")))
    for family, cls, cfg, schedules in families:
        ids = torch.randint(0, cfg.vocab_size, (GPT_BATCH, GPT_SEQ),
                            generator=gen, device=dev)

        def build(remat=False):
            gc.collect()
            torch.cuda.empty_cache()
            with torch.device(dev), in_step.axes(mesh):
                comp = cls(dataclasses.replace(cfg, remat=remat), mesh,
                           adamw, n_micro=COMPOSITE_MICRO)
            return comp.init(torch.Generator(device=dev).manual_seed(
                args.seed))

        comp = build()
        layers = cfg.num_layers
        fa.reset_launch_counts()
        first = {s: composite_grads(torch, comp, lambda s=s:
                                    comp.loss_and_grads(ids, s))
                 for s in schedules}
        counts = (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
        for p in comp.model.parameters():
            p.grad = None

        def whole():
            loss = composite_reference(torch, comp, ids)
            loss.backward()
            return loss.detach()
        ref = composite_grads(torch, comp, whole)
        readings = {"vs_whole_batch": rel_reading(*first["gpipe"], *ref)}
        r = readings["vs_whole_batch"]
        check(r["loss_rel"] <= COMPOSITE_LIMITS["loss_rel"]
              and r["grad_rel"] <= COMPOSITE_LIMITS["grad_rel"],
              f"{family}: the composite's first step against the "
              f"whole-batch modules {r} within {COMPOSITE_LIMITS}")
        if "1f1b" in first:
            r = readings["1f1b_vs_gpipe"] = rel_reading(*first["1f1b"],
                                                        *first["gpipe"])
            check(r["loss_rel"] <= F1B_LIMITS["loss_rel"]
                  and r["grad_rel"] <= F1B_LIMITS["grad_rel"],
                  f"{family}: 1F1B's first step against gpipe's {r} "
                  f"within {F1B_LIMITS}")
        mb = COMPOSITE_MICRO * layers
        want = {"gpipe": [mb] * 3, "1f1b": [2 * mb, mb, mb]}
        check(list(counts) == [sum(want[s][i] for s in schedules)
                               for i in range(3)],
              f"{family}: first steps launched {counts} flash kernels")
        del first, ref
        comp.model.zero_grad(set_to_none=True)
        runs = {}
        for schedule in schedules:
            for remat in (False, True):
                if remat or schedule != schedules[0]:
                    del comp
                    comp = build(remat)
                fa.reset_launch_counts()       # the path starts here
                run = composite_run(torch, fa, comp, ids, schedule, args,
                                    COMPOSITE_STEPS)
                for k, v in zip(FLASH_COUNTS, (fa.fwd_launches,
                                               fa.bwd_dq_launches,
                                               fa.bwd_dkv_launches)):
                    launches[k] += v
                step_want = list(want[schedule])
                if remat and schedule == "gpipe":
                    step_want[0] += mb           # the recomputed forward
                check(all(s == step_want for s in run["launches_per_step"]),
                      f"{family} {schedule} remat={remat}: {step_want} "
                      f"flash launches a step: {run['launches_per_step']}")
                runs[f"{schedule}{'_remat' if remat else ''}"] = run
        if "1f1b" in schedules:
            check(runs["1f1b"]["peak_mem_gb"] < runs["gpipe"]["peak_mem_gb"],
                  f"{family}: 1F1B's peak {runs['1f1b']['peak_mem_gb']} GB "
                  f"below gpipe's {runs['gpipe']['peak_mem_gb']} GB")
        out[family] = {"layers": layers, "params": sum(
            p.numel() for p in comp.model.parameters()),
            "readings": readings, "runs": runs}
        del comp
    emit({"phase": "train_composite", "mesh": {"dp": 1, "pp": 1, "tp": 1},
          "n_micro": COMPOSITE_MICRO, "microbatch": [GPT_BATCH //
                                                     COMPOSITE_MICRO,
                                                     GPT_SEQ],
          "optimizer": ADAMW.format(lr=1e-4), "steps": COMPOSITE_STEPS,
          "composite_limits": COMPOSITE_LIMITS, "f1b_limits": F1B_LIMITS,
          **out,
          "depth_cut": None,
          "note": "gpt: CompositeGPT with the shared 8-expert MoE FFN "
                  "(top-1, capacity 2.0, aux 0.01); llama: CompositeLlama "
                  "at full depth; vs_whole_batch: the first step's loss and "
                  "gradients against the same modules on the whole batch "
                  "with no pipeline; 1f1b_remat: 1F1B ignores remat (it "
                  "recomputes by construction)",
          "card": card})
    return launches


def phase_pipeline_virtual(torch, dev, args, card):
    """The schedules over S = 4 virtual stages of GPT-2 small's blocks (3
    a stage), 8 microbatches of 2 x 1024: GPipe and 1F1B outputs and
    gradients against the sequential stack, the tick counts, and a
    dropped-hop control."""
    from torch import nn

    from horovod_tpu_torch.ops.kernels import flash_attention as fa
    from horovod_tpu_torch.parallel import pp
    from horovod_tpu_torch.parallel.tp import TPTransformerBlock, reset_flax_

    S, M = VIRTUAL_STAGES, VIRTUAL_MICRO
    dt = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(args.seed + 11)
    with torch.device(dev):
        blocks = [TPTransformerBlock(GPT_HEADS, GPT_HIDDEN, GPT_FFN, dtype=dt,
                                     causal=True, use_flash=True,
                                     axis_name=None)
                  for _ in range(GPT_LAYERS)]
    for b in blocks:
        reset_flax_(b, gen)
    lps = GPT_LAYERS // S
    stages = [nn.ModuleList(blocks[s * lps:(s + 1) * lps]) for s in range(S)]
    params = [p for b in blocks for p in b.parameters()]
    mbs = torch.randn(M, COMPOSITE_MB, GPT_SEQ, GPT_HIDDEN, generator=gen,
                      device=dev).to(dt)
    tgt = torch.randn(M, COMPOSITE_MB, GPT_SEQ, GPT_HIDDEN, generator=gen,
                      device=dev).to(dt)

    def layer(block, h):
        return block(h)

    # The sequential stack, one microbatch at a time; the loss
    # sum_m <y_m, t_m> / M, so each output's gradient is t_m / M.
    ref_out, ref_g, abs_g = [], None, None
    for m in range(M):
        x = mbs[m]
        for b in blocks:
            x = b(x)
        g = torch.autograd.grad((x.float() * tgt[m].float()).sum() / M,
                                params)
        ref_out.append(x.detach())
        ref_g = list(g) if ref_g is None else [a + b for a, b in
                                               zip(ref_g, g)]
        abs_g = [t.abs() for t in g] if abs_g is None else [
            a + b.abs() for a, b in zip(abs_g, g)]
    ref_out = torch.stack(ref_out)
    g_out = (tgt.float() / M).to(dt)
    # Outputs: one bf16 rounding of each; gradients: any order of M fp32
    # sums, (M - 1) u of the sum of magnitudes.
    unit = 2.0 ** -24

    def out_ratio(out):
        bound = 2.0 ** -8 * ref_out.float().abs() + 2.0 ** -133
        return ((out.float() - ref_out.float()).abs() / bound).max().item()

    def grad_ratio(grads):
        return max(((a - b).abs() / (2 * (M - 1) * unit * c + 2.0 ** -149))
                   .max().item() for a, b, c in zip(grads, ref_g, abs_g))

    def stage_runs():
        return [pp.StageRun(layer, stages[s], s, S, mbs) for s in range(S)]

    def counts():
        return [fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches]

    readings = {}
    fa.reset_launch_counts()                   # the path starts here
    runs = stage_runs()
    ticks_f = pp.gpipe_forward(runs, pp.virtual_hop)
    out = torch.stack([runs[-1].outputs[m] for m in range(M)])
    ticks_b = pp.gpipe_backward(runs, pp.virtual_hop, [g_out] * S)
    grads = [g for r in runs for g in r.grads]
    readings["gpipe"] = {"ticks": ticks_f, "backward_ticks": ticks_b,
                         "out_ratio": out_ratio(out),
                         "grad_ratio": grad_ratio(grads),
                         "launches": counts()}
    del runs, grads
    c0 = counts()
    seen = []
    head = pp.Head(lambda hp, y, t: (seen.append(y.detach()) or
                                     (y.float() * t.float()).sum()),
                   [], tgt, M)
    runs = stage_runs()
    ticks = pp.run_1f1b(runs, pp.virtual_hop, [None] * (S - 1) + [head])
    grads = [g for r in runs for g in r.grads]
    readings["1f1b"] = {"ticks": ticks, "stash_slots": runs[0].ssize,
                        "out_ratio": out_ratio(torch.stack(seen)),
                        "grad_ratio": grad_ratio(grads),
                        "launches": [b - a for a, b in zip(c0, counts())]}
    launches = dict(zip(FLASH_COUNTS, counts()))    # the path ends
    del runs, grads, seen
    # The control: stage 2's input at tick 4 (microbatch 2) dropped.
    calls = []

    def dropping(sends, step):
        got = pp.virtual_hop(sends, step)
        calls.append(None)
        if len(calls) == 4:
            got[2] = torch.zeros_like(got[2])
        return got
    runs = stage_runs()
    pp.gpipe_forward(runs, dropping)
    control = out_ratio(torch.stack([runs[-1].outputs[m] for m in range(M)]))
    del runs
    n = GPT_LAYERS * M
    g, f = readings["gpipe"], readings["1f1b"]
    check(g["ticks"] == g["backward_ticks"] == M + S - 1
          and f["ticks"] == M + 2 * S - 2 and f["stash_slots"] == min(
              M, 2 * S - 1),
          f"M + S - 1 and M + 2S - 2 ticks: {g['ticks']}, {f['ticks']}")
    check(g["launches"] == [n, n, n] and f["launches"] == [2 * n, n, n],
          f"flash launches {g['launches']} (gpipe), {f['launches']} (1f1b)")
    for name in ("gpipe", "1f1b"):
        r = readings[name]
        check(r["out_ratio"] <= 1.0 and r["grad_ratio"] <= 1.0,
              f"{name}: outputs and gradients within VIRTUAL_LIMITS: {r}")
    check(control > 10.0, f"the dropped-hop control fails the output bound "
          f"by more than 10x: {control}")
    emit({"phase": "pipeline_virtual", "stages": S, "n_micro": M,
          "microbatch": [COMPOSITE_MB, GPT_SEQ], "blocks": GPT_LAYERS,
          "dtype": "bfloat16", **readings, "dropped_hop_control": control,
          "limits": VIRTUAL_LIMITS, "card": card})
    return launches


# ---------------------------------------------------------------------------
# A14, the remaining models: train_t5, train_vgg16, train_inception3,
# train_lora, generate.
# ---------------------------------------------------------------------------

T5_BATCH, T5_SEQ, T5_STEPS = 16, 512, 6     # bench.py:615-640's T5-small
T5_VOCAB = 32128
T5_PARAMS = 70_664_704
IMAGE_BATCH, IMAGE_STEPS = 64, 6            # bench.py:686-689's settings
# (name, image side, parameters, SGD learning rate). bench.py's 0.1 for
# both; VGG-16, which has no BatchNorm, diverges there from Flax's init
# (loss 6.9 at step 1, 62 at step 5, nan at step 8 on an H100), so it takes
# its paper's 0.01 (Simonyan and Zisserman 2014, section 3.1). The JAX
# model diverges there too (scripts/check_vgg_lr.py).
IMAGE_MODELS = {"vgg16": ("VGG-16", 224, 138_357_544, 0.01),
                "inception3": ("Inception V3", 299, 27_161_264, 0.1)}
INCEPTION_AUX_WEIGHT = 0.4      # the aux loss's weight in the Inception recipe
LORA_RANK, LORA_STEPS = 8, 6
LORA_TARGETS = r"layer_\d+/(attention|mlp)/"   # every attention and MLP kernel
# The phases that build their own models, and what may still be allocated
# when one starts (the fusion runtime's persistent buffers, ids and the like):
# every earlier phase's models and optimizer states are gone by then, so each
# phase's peak_mem_gb is its own.
OWN_MODEL_PHASES = ("train_bert", "train_llama", "train_vit",
                    "train_gpt_chunked", "train_powersgd", "train_gpt_tp_sp",
                    "ring_flash", "train_zero_fsdp", "train_gpt_moe",
                    "train_composite", "pipeline_virtual", "train_t5",
                    "train_vgg16", "train_inception3", "train_lora",
                    "generate", "generate_cached", "serve",
                    "launch_serving")
OWN_MODEL_START_GB = 1.0
# Device time by kind of kernel, matched on the kernel's name (lower case),
# first match wins: cuDNN's convolutions, whose names carry "gemm" too, are
# matched before the GEMMs. scripts/profile_torch_port.py uses this table.
KINDS = (
    ("flash_fwd", ("fa_fwd_kernel", "fa_fwd_mma_kernel")),
    ("flash_bwd_dq", ("fa_bwd_dq_kernel", "fa_bwd_dq_mma_kernel")),
    ("flash_bwd_dkv", ("fa_bwd_dkv_kernel", "fa_bwd_dkv_mma_kernel")),
    ("scale_pack_unpack", ("scale_copy_kernel",)),
    ("adasum_combine", ("adasum_level_kernel", "adasum_partials_kernel",
                        "adasum_apply_kernel")),
    ("nccl", ("nccl",)),
    ("norm", ("layer_norm", "layernorm", "rms")),
    ("cross_entropy", ("softmax", "nll_loss", "cross_entropy")),
    ("optimizer", ("adam", "sgd", "multi_tensor_apply", "foreach")),
    ("conv", ("conv", "implicit", "winograd", "fprop", "dgrad", "wgrad")),
    ("tf32_gemm", ("tf32", "s1688gemm")),
    ("fp32_gemm", ("sgemm", "f32f32", "gemm_f32", "_32x", "simt")),
    ("gemm", ("gemm", "cutlass", "xmma", "nvjet")),
    ("batch_norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
    ("pool", ("pool",)),
)


def kind_of(name):
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "elementwise_and_other"


def device_by_kind(torch, step, steps=2):
    """:func:`device_ms`'s busy ms a step and busy share, and the device's
    kernels' and copies' ms a step by kind (``KINDS``)."""
    device, span = device_events(torch, step, steps)
    busy = busy_us((e.time_range.start, e.time_range.end) for e in device)
    kinds = {}
    for e in device:
        k = kind_of(e.name)
        kinds[k] = kinds.get(k, 0.0) + e.time_range.elapsed_us() / 1e3 / steps
    return busy / 1e3 / steps, busy / span, dict(
        sorted(kinds.items(), key=lambda kv: -kv[1]))


def held_tensors(torch, n=12):
    """The ``n`` largest CUDA tensors the garbage collector can see, as
    (shape, dtype, GB), largest first: what still holds memory between
    phases (a tensor held only inside autograd's graph is not seen)."""
    seen = {}
    for o in gc.get_objects():
        try:
            if torch.is_tensor(o) and o.is_cuda:
                key = o.untyped_storage().data_ptr()
                gb = o.untyped_storage().nbytes() / 1e9
                if gb > seen.get(key, (0,))[0]:
                    seen[key] = (gb, list(o.shape), str(o.dtype))
        except Exception:  # noqa: BLE001 — a lazy or odd object: skip it
            continue
    return [[shape, dtype, gb] for gb, shape, dtype in
            sorted(seen.values(), key=lambda r: -r[0])[:n]]


def t5_config(torch, **kw):
    from horovod_tpu_torch.models import T5Config
    return T5Config(vocab_size=T5_VOCAB, hidden_size=512, num_layers=6,
                    num_heads=8, intermediate_size=1024,
                    dtype=torch.bfloat16, tp_axis=None, **kw)


def build_t5(torch, dev, seed, **kw):
    from horovod_tpu_torch.models import T5
    model = build_on(torch, dev, lambda g: T5(t5_config(torch, **kw),
                                              generator=g), seed)
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == T5_PARAMS, f"T5-small (6 + 6 layers, untied lm_head) "
          f"has {T5_PARAMS:,} parameters, this model {n_params}")
    return model


def t5_attention_ms(torch, dev):
    """The plain attention of one T5-small step, apart: forward and
    backward of each kind at the step's shapes (CUDA events, median), and
    the step's total (6 layers of each)."""
    from horovod_tpu_torch.parallel.tp import plain_attention
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def leaf(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=bf16
                           ).requires_grad_()
    q, k, v = (leaf(T5_BATCH, T5_SEQ, 8, 64) for _ in range(3))
    bias = leaf(8, T5_SEQ, T5_SEQ)
    grad = torch.randn(T5_BATCH, T5_SEQ, 8, 64, generator=gen, device=dev,
                       dtype=bf16)
    cases = {"encoder_self_bias": dict(bias=bias, causal=False),
             "decoder_self_bias_causal": dict(bias=bias, causal=True),
             "cross": dict()}
    ms = {name: event_ms(lambda kw=kw: torch.autograd.backward(
        plain_attention(q, k, v, bf16, **kw), grad), reps=10)
        for name, kw in cases.items()}
    return {"fwd_bwd_ms_by_kind": ms,
            "per_step_ms": 6 * sum(ms.values())}


def phase_train_t5(torch, hvd, dev, args, card):
    """T5-small at bench.py's widths, bf16, 16 x 512 -> 512 tokens from
    --seed, next-token loss in fp32, AdamW(1e-4) in hvd.DistributedOptimizer,
    remat off and then on from the same weights: finite, falling losses,
    bit-equal between the two, a lower peak with remat, a pack and an
    unpack per bucket every step; tokens/s, device ms by kind with the
    plain attention (relative bias) apart."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(args.seed + 15)
    src, tgt = (torch.randint(0, T5_VOCAB, (T5_BATCH, T5_SEQ),
                              generator=gen, device=dev) for _ in range(2))
    runs, launches, split = {}, None, None
    for remat in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        model = build_t5(torch, dev, args.seed, remat=remat)

        def loss(model=model):
            return next_token_loss(F, model(src, tgt), tgt)
        opt, run = train_steps(torch, hvd, model, loss, args, T5_STEPS,
                               (0, 0, 0), lr=1e-4)
        elapsed = run.pop("elapsed")
        run.pop("closed")
        run["tokens_per_sec"] = T5_BATCH * T5_SEQ * T5_STEPS / elapsed
        if not remat:
            launches = run["launches"]

            def step(model=model, opt=opt):
                opt.zero_grad()
                loss(model).backward()
                opt.step()
            busy, share, kinds = device_by_kind(torch, step)
            run.update(device_ms_per_step=busy, device_busy_share=share,
                       device_ms_by_kind_per_step=kinds)
        runs["remat" if remat else "no_remat"] = run
        del model, opt
    off, on = runs["no_remat"], runs["remat"]
    check(on["losses"] == off["losses"],
          f"remat's losses bit-equal: {on['losses']} vs {off['losses']}")
    check(on["peak_mem_gb"] < off["peak_mem_gb"],
          f"remat lowers the peak: {on['peak_mem_gb']} vs "
          f"{off['peak_mem_gb']} GB")
    attention = t5_attention_ms(torch, dev)
    attention["share_of_step_device_ms"] = (
        attention["per_step_ms"] / off["device_ms_per_step"])
    emit({"phase": "train_t5", "model": "T5-small", "params": T5_PARAMS,
          "layers_per_stack": 6, "batch": T5_BATCH, "source": T5_SEQ,
          "target": T5_SEQ, "dtype": "bfloat16",
          "optimizer": ADAMW.format(lr=1e-4), **runs,
          "remat_losses_bit_equal": True,
          "plain_attention_apart": attention,
          "note": "tokens: decoder tokens; plain_attention_apart: the "
                  "step's 18 plain attentions (6 encoder with the "
                  "relative bias, 6 decoder causal with it, 6 cross) "
                  "timed alone at its shapes, forward and backward",
          "card": card})
    return launches


def phase_train_image(torch, hvd, dev, args, card, which):
    """VGG-16 (224 x 224, classic head) or Inception V3 (299 x 299, the aux
    head on, its loss added at INCEPTION_AUX_WEIGHT), 1000 classes, bf16,
    dropout 0, 64 images and labels from --seed, SGD (IMAGE_MODELS' rate,
    momentum 0.9) in hvd.DistributedOptimizer: finite, falling losses, a
    pack and an unpack per bucket every step; images/s, device ms by kind,
    the peak."""
    import torch.nn.functional as F

    from horovod_tpu_torch.models import VGG16, InceptionV3
    name, side, n_want, lr = IMAGE_MODELS[which]
    if which == "vgg16":
        model = build_on(torch, dev, lambda g: VGG16(
            num_classes=1000, dtype=torch.bfloat16, dropout_rate=0.0,
            image_size=side, generator=g), args.seed)

        def loss():
            return F.cross_entropy(model(x), y)
    else:
        model = build_on(torch, dev, lambda g: InceptionV3(
            num_classes=1000, dtype=torch.bfloat16, aux_logits=True,
            dropout_rate=0.0, generator=g), args.seed)

        def loss():
            logits, aux = model(x)
            return F.cross_entropy(logits, y) + INCEPTION_AUX_WEIGHT * \
                F.cross_entropy(aux, y)
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == n_want, f"{name} has {n_want:,} parameters, this "
          f"model {n_params}")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 18)
    x = torch.randn((IMAGE_BATCH, side, side, 3), generator=gen, device=dev)
    y = torch.randint(0, 1000, (IMAGE_BATCH,), generator=gen, device=dev)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9),
        named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    opt, run = train_steps(torch, hvd, model, loss, args, IMAGE_STEPS,
                           (0, 0, 0), opt=opt)
    elapsed = run.pop("elapsed")
    run.pop("closed")

    def step():
        opt.zero_grad()
        loss().backward()
        opt.step()
    busy, share, kinds = device_by_kind(torch, step)
    emit({"phase": f"train_{which}", "model": name, "params": n_params,
          "batch": IMAGE_BATCH, "image": [side, side, 3],
          "dtype": "bfloat16", "param_dtype": "float32",
          "optimizer": f"SGD(lr={lr}, momentum=0.9)", "dropout_rate": 0.0,
          **({"aux_logits": True, "aux_weight": INCEPTION_AUX_WEIGHT}
             if which == "inception3" else {"classic_head": True}),
          **run, "images_per_sec": IMAGE_BATCH * IMAGE_STEPS / elapsed,
          "device_ms_per_step": busy, "device_busy_share": share,
          "device_ms_by_kind_per_step": kinds, "card": card})
    return run["launches"]


def phase_train_lora(torch, hvd, dev, args, card):
    """GPT-2 small (train_gpt's configuration, flash) with rank-8 adapters
    on every attention and MLP kernel, AdamW(1e-3) over the adapters in
    hvd.DistributedOptimizer, the base frozen: the first loss equal to the
    base model's, the base bit-unchanged after the steps, the bytes packed
    each step equal to lora_wire_numbers' adapter bytes, every flash kernel
    and both scale kernels launched; tokens/s."""
    import torch.nn.functional as F

    from horovod_tpu_torch.models import lora as L

    model = build_gpt(torch, dev, args.seed)
    ids = gpt_batch(torch, model, dev, args.seed)
    lora = L.lora_init(model, rank=LORA_RANK, targets=LORA_TARGETS,
                       rng=torch.Generator().manual_seed(args.seed + 16))
    adapters = lora["adapters"]
    check(len(adapters) == 4 * GPT_LAYERS,
          f"adapters on the 4 kernels of each block: {len(adapters)}")
    base = L.frozen_params(model)
    before = {n: t.clone() for n, t in base.items()}

    def loss_fn(params, batch):
        return next_token_loss(F, torch.func.functional_call(
            model, params, (batch,)), batch)
    adapter_loss = L.adapter_loss_fn(loss_fn, base, lora)
    with torch.no_grad():
        base_loss = next_token_loss(F, model(ids), ids).item()
    adapter_bytes, full_bytes = L.lora_wire_numbers(model, lora)
    opt, run = train_steps(torch, hvd, adapters,
                           lambda: adapter_loss(adapters, ids), args,
                           LORA_STEPS, (GPT_LAYERS,) * 3, lr=1e-3)
    elapsed = run.pop("elapsed")
    closed = run.pop("closed")
    packed = [sum(n * getattr(torch, sig[4].split(".")[-1]).itemsize
                  for _, sig in step for _, n in sig[-1])
              for step in closed]
    check(run["losses"][0] == base_loss,
          f"the first loss is the base model's (b starts at zero): "
          f"{run['losses'][0]} vs {base_loss}")
    check(all(torch.equal(p, before[n]) for n, p in model.named_parameters()),
          "the base parameters are bit-unchanged after the steps")
    check(all(b == adapter_bytes for b in packed),
          f"the bytes packed each step are the adapters': {packed} vs "
          f"{adapter_bytes}")
    emit({"phase": "train_lora", "model": "GPT-2 small + LoRA",
          "rank": LORA_RANK, "targets": LORA_TARGETS,
          "adapters": len(adapters),
          "adapter_params": sum(p.numel() for p in adapters.parameters()),
          "batch": GPT_BATCH, "seq": GPT_SEQ,
          "optimizer": ADAMW.format(lr=1e-3) + " over the adapters",
          **run, "base_loss": base_loss, "first_loss_is_base": True,
          "base_bit_unchanged": True, "packed_bytes_per_step": packed,
          "lora_wire_numbers": {"adapter_bytes": adapter_bytes,
                                "full_bytes": full_bytes,
                                "share": adapter_bytes / full_bytes},
          "tokens_per_sec": GPT_BATCH * GPT_SEQ * LORA_STEPS / elapsed,
          "card": card})
    return run["launches"]


def timed_call(torch, fn):
    """``fn()`` and its seconds, host clock to a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_generate(torch, dev, args, card):
    """bench.py's decoding setting on GPT-2 small (flash; batch 8, a 32-token
    prompt, max_len 128): greedy generate, beam search (k = 4), sampled
    generate twice from one generator seed (bit-equal streams), greedy
    speculative decoding with the target as its own draft (gamma 4:
    bit-equal to greedy generate in the minimal block count); then T5-small's
    greedy and beam re-forward decodes of 32 tokens over a 512-token
    source. Generated tokens/s of each; flash forward launches, no
    backward."""
    from horovod_tpu_torch.models import (beam_search, generate,
                                          speculative_generate,
                                          t5_beam_decode, t5_greedy_decode)
    from horovod_tpu_torch.ops.kernels import flash_attention as fa
    from horovod_tpu_torch.ops.kernels import scale_buffers as sb

    model = build_gpt(torch, dev, args.seed).eval()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 17)
    prompt = torch.randint(0, GPT_VOCAB, (GEN_BATCH, GEN_PROMPT),
                           generator=gen, device=dev)
    t5 = build_t5(torch, dev, args.seed).eval()
    src = torch.randint(0, T5_VOCAB, (GEN_BATCH, T5_SEQ), generator=gen,
                        device=dev)
    generate(model, prompt, GEN_PROMPT + 8)           # warm-up, unchecked
    fa.reset_launch_counts()                          # the path starts here
    sb.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    new = GEN_BATCH * (GEN_LEN - GEN_PROMPT)
    out, rates = {}, {}
    greedy, s = timed_call(torch, lambda: generate(model, prompt, GEN_LEN))
    rates["greedy"] = new / s
    (beams, scores), s = timed_call(torch, lambda: beam_search(
        model, prompt, GEN_LEN, num_beams=GEN_BEAMS))
    rates["beam_k4"] = new / s
    sampled = []
    for _ in range(2):
        g = torch.Generator(device=dev).manual_seed(args.seed + 19)
        toks, s = timed_call(torch, lambda g=g: generate(
            model, prompt, GEN_LEN, temperature=1.0, top_k=GEN_TOP_K, rng=g))
        sampled.append(toks)
        rates.setdefault("sampled", []).append(new / s)
    (spec, stats), s = timed_call(torch, lambda: speculative_generate(
        model, model, prompt, GEN_LEN, gamma=GEN_GAMMA, return_stats=True))
    rates["speculative_greedy"] = new / s
    t5_new = GEN_BATCH * (T5_GEN_LEN - 1)
    t5_greedy, s = timed_call(torch, lambda: t5_greedy_decode(
        t5, src, T5_GEN_LEN))
    rates["t5_greedy"] = t5_new / s
    (t5_beams, t5_scores), s = timed_call(torch, lambda: t5_beam_decode(
        t5, src, T5_GEN_LEN, num_beams=GEN_BEAMS))
    rates["t5_beam_k4"] = t5_new / s
    launches = dict(zip(STEP_COUNTS, step_counts(fa, sb)))   # the path ends
    blocks_min = math.ceil((GEN_LEN - GEN_PROMPT) / (GEN_GAMMA + 1))
    for name, toks in (("greedy", greedy), ("beam", beams),
                       ("sampled", sampled[0]), ("speculative", spec)):
        check(toks.shape == (GEN_BATCH, GEN_LEN) and torch.equal(
            toks[:, :GEN_PROMPT], prompt) and int(toks.min()) >= 0
            and int(toks.max()) < GPT_VOCAB,
            f"{name}: (B, max_len) tokens after the prompt")
    check(torch.equal(sampled[0], sampled[1]),
          "one generator seed, one sampled stream")
    check(not torch.equal(sampled[0], greedy),
          "the sampled stream is not the greedy one")
    check(torch.equal(spec, greedy),
          "greedy speculative decoding equals greedy generate")
    check(stats["blocks"] == blocks_min,
          f"a perfect draft's block count {blocks_min}: {stats}")
    check(bool(torch.isfinite(scores).all()) and bool(
        torch.isfinite(t5_scores).all()), "finite beam scores")
    for toks in (t5_greedy, t5_beams):
        check(toks.shape == (GEN_BATCH, T5_GEN_LEN)
              and bool((toks[:, 0] == 0).all()),
              "T5: (B, 32) tokens after bos")
    check(launches["flash_fwd"] > 0 and launches["flash_bwd_dq"] == 0
          and launches["flash_bwd_dkv"] == 0,
          f"flash forward launches and no backward: {launches}")
    READINGS["generate"] = rates
    emit({"phase": "generate", "model": "GPT-2 small; T5-small",
          "batch": GEN_BATCH, "prompt": GEN_PROMPT, "max_len": GEN_LEN,
          "gamma": GEN_GAMMA, "beams": GEN_BEAMS, "top_k": GEN_TOP_K,
          "t5_source": T5_SEQ, "t5_max_len": T5_GEN_LEN,
          "generated_tokens_per_sec": rates,
          "speculative_bit_equal_to_greedy": True,
          "speculative_blocks": stats["blocks"],
          "beam_scores_mean": float(scores.mean()),
          "sampled_streams_bit_equal": True, "launches": launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "note": "re-forward decoding: each generated token is one "
                  "forward of the whole buffer (the cached routes are "
                  "generate_cached's); tokens/s: generated tokens over "
                  "the host clock",
          "card": card})
    return launches


# The cached decodes (A15's first half): the generate phase's settings, a
# 16-token shared prefix, LLaMA-400M at its full 4096-position capacity.
GEN_PREFIX = 16
LLAMA_GEN_CAPACITY = 4096
# generate_cached's depth cut (the widths, the cache capacities and the
# decode settings stay): GPT-2 small at 4 of its 12 layers, LLaMA-400M at 4
# of its 24, so the whole script keeps its time as it grows.
GEN_CACHED_GPT_LAYERS, GEN_CACHED_LLAMA_LAYERS = 4, 4
GEN_CACHED_GPT_PARAMS, GEN_CACHED_LLAMA_PARAMS = 106_406_400, 112_731_136
# A cached route's teacher-forced logits must lie within FORCED_C times the
# bf16 re-forward's own distance from an fp32 re-forward of the same weights
# and tokens (max |difference| over every row, position and logit): two bf16
# routes that round at different points are each about that far from the
# fp32 result, so their distance is at most about twice it; C = 3 leaves
# room for the tail of a max over ~5e7 logits. A cursor off by one or a
# cache that hides each query's newest row must fail it.
FORCED_C = 3.0
INT8_REL = 0.15          # JAX's int8-cache bound: 0.15 x max|logit|


def feeds_of(module):
    """Every forward of ``module`` as (tokens fed, whether a cache was
    given); the handle removes the hook."""
    seen = []

    def hook(m, args, kwargs):
        if args[0] is not None:              # not T5's cross K/V projection
            seen.append((int(args[0].shape[1]), kwargs.get("cache")
                         is not None))
    return seen, module.register_forward_pre_hook(hook, with_kwargs=True)


def forced(torch, model, toks, spans, cache):
    """Teacher forcing: ``toks[:, a:b]`` through ``cache`` for each (a, b) of
    ``spans``, fp32 logits of the positions fed, concatenated."""
    return torch.cat([model(toks[:, a:b], pos=a, cache=cache).float()
                      for a, b in spans], dim=1)


def spans_of(P, L, step, start=0):
    """The feeds of a cached route over positions [start, L - 1): the prompt
    chunk [start, P - 1), then ``step`` tokens a feed."""
    out = [(start, P - 1)] if P - 1 > start else []
    out += [(a, min(a + step, L - 1)) for a in range(P - 1, L - 1, step)]
    return out


@contextlib.contextmanager
def newest_row_hidden():
    """The control of a cache that drops its last row: every cached query's
    newest visible position (its own row) masked out."""
    from horovod_tpu_torch.parallel import tp
    attend = tp._grouped_attend

    def hidden(qg, keys, vals, bias, invalid, dtype):
        valid = ~invalid
        newest = valid & (valid.long().cumsum(-1)
                          == valid.sum(-1, keepdim=True))
        return attend(qg, keys, vals, bias, invalid | newest, dtype)
    tp._grouped_attend = hidden
    try:
        yield
    finally:
        tp._grouped_attend = attend


def fp32_twin(torch, model, make):
    """``make(config)`` at fp32 activations on ``model``'s device, holding
    ``model``'s weights: the teacher-forced bound's reference."""
    with torch.device(next(model.parameters()).device):
        twin = make(dataclasses.replace(model.config, dtype=torch.float32))
    twin.load_state_dict(model.state_dict())
    return twin.eval()


def phase_generate_cached(torch, dev, args, card):
    """The cached decodes at the generate phase's settings (bench.py:
    1196-1240; batch 8, a 32-token prompt, max_len 128), one rank, weights
    from --seed. GPT-2 small (bf16, capacity 1024): cached greedy, sampled
    twice from one generator seed, beam search (k = 4), greedy speculative
    decoding with the target as its own draft (gamma 4), prefill_prefix of
    a 16-token shared prefix then generate(prefix_state=...), and a per-row
    batch at staggered positions (row b b steps late, parked at position 0:
    the serving pattern). LLaMA-400M (GQA 16/8, capacity 4096): cached
    greedy with the bf16 and the int8 cache. T5-small: cached greedy and
    beam decodes of 32 tokens over a 512-token source. GPT-2 small and
    LLaMA-400M run at GEN_CACHED_GPT_LAYERS and GEN_CACHED_LLAMA_LAYERS
    layers (a depth cut; the widths stay), so the re-forward tokens/s
    printed beside the cached ones comes from generate's full depth, and
    this phase's own re-forward device ms from its cut one.

    Checks: each route's feeding pattern, teacher-forced with the
    re-forward greedy tokens, gives logits within FORCED_C times the bf16
    re-forward's distance from an fp32 re-forward, which a cursor off by
    one and a cache hiding each query's newest row must fail; the int8
    cache within INT8_REL max|logit| of the bf16 cache; no flash launch in
    a cached route and every feed one forward of s tokens against the
    cache; the sampled streams bit-equal; shapes and prompts. Printed:
    generated tokens/s beside the re-forward's (the generate phase's, and
    LLaMA's here), device ms and kernel launches a decode step (profiled),
    cache bytes, the peak, and each route's token agreement with the
    re-forward stream."""
    from horovod_tpu_torch.models import (GPT, T5, Llama, LlamaConfig,
                                          beam_search, generate,
                                          init_decode_cache, prefill_prefix,
                                          rewind_cache, speculative_generate,
                                          t5_beam_decode, t5_greedy_decode)
    from horovod_tpu_torch.models import beam_reorder_cache
    from horovod_tpu_torch.ops.kernels import flash_attention as fa
    from horovod_tpu_torch.ops.kernels import scale_buffers as sb

    out = {"routes": {}, "teacher_forced": {}, "controls": {}}
    launches = dict.fromkeys(STEP_COUNTS, 0)     # the cached routes' sum

    def take(cached):
        """Ends a stretch of runs: its launch counts are added to the
        cached routes' sum where ``cached`` (else dropped: a re-forward
        run), and the counts zeroed, so the next stretch starts there."""
        got = (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches,
               sb.pack_launches, sb.unpack_launches)
        if cached:
            for k, v in zip(STEP_COUNTS, got):
                launches[k] += v
        fa.reset_launch_counts()
        sb.reset_launch_counts()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 23)
    P, L, B = GEN_PROMPT, GEN_LEN, GEN_BATCH
    new = B * (L - P)

    def agreement(toks, ref):
        same = toks[:, P:] == ref[:, P:]
        return float(same.float().mean())

    def route(name, fn, n_new=new):
        got, s = timed_call(torch, fn)
        out["routes"][name] = {"generated_tokens_per_sec": n_new / s}
        return got

    def within(name, got, ref, bound):
        err = float((got - ref).abs().max())
        out["teacher_forced"][name] = {"max_abs_err": err, "bound": bound,
                                       "ratio": err / bound}
        check(err <= bound, f"{name}: teacher-forced logits {err} within "
              f"{bound}")

    def fails(name, got, ref, bound):
        err = float((got - ref).abs().max())
        out["controls"][name] = {"max_abs_err": err, "ratio": err / bound}
        check(err > bound, f"control {name} fails the bound: {err} > {bound}")

    with torch.no_grad():
        # --- GPT-2 small, GEN_CACHED_GPT_LAYERS deep ----------------------
        model = GPT(dataclasses.replace(
            gpt_config(torch, use_flash=True),
            num_layers=GEN_CACHED_GPT_LAYERS),
            generator=torch.Generator().manual_seed(args.seed)).to(dev).eval()
        n_params = sum(p.numel() for p in model.parameters())
        check(n_params == GEN_CACHED_GPT_PARAMS, f"GPT-2 small at "
              f"{GEN_CACHED_GPT_LAYERS} layers has {GEN_CACHED_GPT_PARAMS:,} "
              f"parameters, this model {n_params}")
        prompt = torch.randint(0, GPT_VOCAB, (B, P), generator=gen,
                               device=dev)
        greedy = generate(model, prompt, L)            # the re-forward route
        ref = model(greedy).float()[:, :L - 1]
        twin = fp32_twin(torch, model, lambda c: GPT(c))
        bound = FORCED_C * float((twin(greedy).float()[:, :L - 1]
                                  - ref).abs().max())
        del twin
        out["bound_gpt2_small"] = bound
        generate(model, prompt, P + 8, use_cache=True)    # warm-up
        take(False)                                    # the path starts here
        torch.cuda.reset_peak_memory_stats()
        seen, hook = feeds_of(model)
        cached = route("greedy", lambda: generate(model, prompt, L,
                                                  use_cache=True))
        check(seen == [(P - 1, True)] + [(1, True)] * (L - P),
              f"greedy: one prompt chunk, then one token a feed: {seen[:4]}")
        out["routes"]["greedy"]["token_agreement"] = agreement(cached, greedy)
        sampled = []
        for i in range(2):
            g = torch.Generator(device=dev).manual_seed(args.seed + 19)
            sampled.append(route(f"sampled_{i}", lambda g=g: generate(
                model, prompt, L, temperature=1.0, top_k=GEN_TOP_K, rng=g,
                use_cache=True)))
        check(torch.equal(sampled[0], sampled[1]),
              "one generator seed, one cached sampled stream")
        seen.clear()
        beams, scores = route("beam_k4", lambda: beam_search(
            model, prompt, L, num_beams=GEN_BEAMS, use_cache=True))
        check(seen == [(P - 1, True)] + [(1, True)] * (L - P),
              f"beam: one prompt chunk at batch B, then one token a "
              f"hypothesis a feed: {seen[:4]}")
        check(bool(torch.isfinite(scores).all()), "finite beam scores")
        seen.clear()
        spec, stats = route("speculative_greedy", lambda: speculative_generate(
            model, model, prompt, L, gamma=GEN_GAMMA, use_cache=True,
            return_stats=True))
        # the target's own feeds: the prompt chunk, one chunk a block, and
        # as its own draft gamma single feeds and a re-feed of the block
        check(all(c for _, c in seen) and seen.count(
            (GEN_GAMMA + 1, True)) == 2 * stats["blocks"],
              f"speculative: cached feeds, one verify chunk a block: "
              f"{seen[:8]}")
        out["routes"]["speculative_greedy"].update(
            blocks=stats["blocks"],
            blocks_min=math.ceil((L - P) / (GEN_GAMMA + 1)),
            token_agreement=agreement(spec, greedy))
        state = prefill_prefix(model, prompt[:1, :GEN_PREFIX])
        shared = prompt.clone()
        shared[:, :GEN_PREFIX] = prompt[:1, :GEN_PREFIX]
        prefixed = route("prefix", lambda: generate(
            model, shared, L, use_cache=True, prefix_state=state))
        cold = generate(model, shared, L, use_cache=True)
        out["routes"]["prefix"]["token_agreement_with_cold"] = agreement(
            prefixed, cold)
        hook.remove()
        take(True)
        for name, toks in (("greedy", cached), ("beam", beams),
                           ("sampled", sampled[0]),
                           ("speculative", spec), ("prefix", prefixed)):
            check(toks.shape == (B, L) and int(toks.min()) >= 0
                  and int(toks.max()) < GPT_VOCAB and torch.equal(
                      toks[:, :P], shared if name == "prefix" else prompt),
                  f"{name}: (B, max_len) tokens after the prompt")
        # device ms and launches a decode step, cached and re-forward
        for name, fn in (("cached", lambda: generate(model, prompt, L,
                                                     use_cache=True)),
                         ("reforward", lambda: generate(model, prompt, L))):
            busy, share, n = device_ms(torch, fn, steps=1, launches=True)
            out[f"{name}_device_ms_per_step"] = busy / (L - P)
            out[f"{name}_launches_per_step"] = n / (L - P)
            out[f"{name}_device_busy_share"] = share
            take(name == "cached")
        # teacher forcing through each route's feeding pattern
        cache = init_decode_cache(model, B)
        within("greedy", forced(torch, model, greedy, spans_of(P, L, 1),
                                cache), ref, bound)
        cache = init_decode_cache(model, B)
        within("speculative", forced(
            torch, model, greedy, spans_of(P, L, GEN_GAMMA + 1), cache), ref,
            bound)
        pstate = prefill_prefix(model, greedy[:, :GEN_PREFIX])
        within("prefix", forced(torch, model, greedy, spans_of(
            P, L, 1, GEN_PREFIX), pstate["cache"]), ref[:, GEN_PREFIX:],
            bound)
        # beams: k copies of each row (any reorder within a batch row keeps
        # their histories), reordered by a random origin every step
        k = GEN_BEAMS
        cache = init_decode_cache(model, B)
        model(greedy[:, :P - 1], pos=0, cache=cache)
        cache = cache.map(lambda t: t.repeat_interleave(k, dim=0))
        toks_k = greedy.repeat_interleave(k, dim=0)
        worst = 0.0
        for t in range(P - 1, L - 1):
            lg = model(toks_k[:, t:t + 1], pos=t, cache=cache)[:, 0].float()
            worst = max(worst, float((lg - ref[:, t].repeat_interleave(
                k, dim=0)).abs().max()))
            origin = torch.argsort(torch.rand(B, k, generator=gen,
                                              device=dev), dim=1)
            beam_reorder_cache(cache, origin, B, k)
        # a reorder alone: every K/V row read and written once
        moved = 2 * cache.nbytes()
        out["beam_reorder"] = {
            "ms": event_ms(lambda: beam_reorder_cache(cache, origin, B, k),
                           reps=10),
            "bound_ms": moved / H100_BYTES_PER_S * 1e3, "bytes": moved,
            "rows": B * k}
        out["teacher_forced"]["beam"] = {"max_abs_err": worst,
                                         "bound": bound,
                                         "ratio": worst / bound}
        check(worst <= bound, f"beam: teacher-forced logits {worst} within "
              f"{bound}")
        # per-row positions, row b b steps late and parked at 0 meanwhile
        cache = init_decode_cache(model, B)
        rows = torch.arange(B, device=dev)
        per_row = torch.zeros_like(ref)
        for step in range(L - 1 + B - 1):
            pos = torch.clamp(step - rows, 0, L - 2)
            lg = model(greedy[rows, pos][:, None], pos=pos,
                       cache=cache)[:, 0].float()
            live = (step - rows >= 0) & (step - rows <= L - 2)
            per_row[rows[live], pos[live]] = lg[live]
        within("per_row_staggered", per_row, ref, bound)
        shared_cursor = forced(torch, model, greedy, spans_of(1, L, 1),
                               init_decode_cache(model, B))
        out["per_row_vs_shared_cursor_max_abs"] = float(
            (per_row - shared_cursor).abs().max())
        # the controls, on the greedy pattern
        cache = rewind_cache(init_decode_cache(model, B), 1)
        fails("cursor_off_by_one", forced(
            torch, model, greedy, spans_of(P, L, 1), cache), ref, bound)
        with newest_row_hidden():
            fails("newest_row_hidden", forced(
                torch, model, greedy, spans_of(P, L, 1),
                init_decode_cache(model, B)), ref, bound)
        take(True)
        out["gpt2_small_cache_bytes_bf16"] = init_decode_cache(
            model, B).nbytes()
        del model, cache, ref, per_row, shared_cursor, state, pstate
        gc.collect()

        # --- LLaMA-400M, GEN_CACHED_LLAMA_LAYERS deep ---------------------
        llama = build_on(torch, dev, lambda g: Llama(LlamaConfig.bench(
            num_layers=GEN_CACHED_LLAMA_LAYERS,
            max_position_embeddings=LLAMA_GEN_CAPACITY,
            dtype=torch.bfloat16, use_flash=True), generator=g), args.seed)
        llama.eval()
        n_params = sum(p.numel() for p in llama.parameters())
        check(n_params == GEN_CACHED_LLAMA_PARAMS, f"LLaMA-400M at "
              f"{GEN_CACHED_LLAMA_LAYERS} layers has "
              f"{GEN_CACHED_LLAMA_PARAMS:,} parameters, this model "
              f"{n_params}")
        lprompt = torch.randint(0, 32000, (B, P), generator=gen, device=dev)
        lgreedy = route("llama_reforward_greedy",
                        lambda: generate(llama, lprompt, L))
        lref = llama(lgreedy).float()[:, :L - 1]
        twin = fp32_twin(torch, llama, lambda c: Llama(c))
        lbound = FORCED_C * float((twin(lgreedy).float()[:, :L - 1]
                                   - lref).abs().max())
        del twin
        out["bound_llama_400m"] = lbound
        take(False)
        attns = [m for m in llama.modules() if hasattr(m, "kv_cache_int8")]
        forced_int8 = {}
        for int8 in (False, True):
            for m in attns:
                m.kv_cache_int8 = int8
            tag = "int8" if int8 else "bf16"
            out[f"llama_400m_cache_bytes_{tag}"] = init_decode_cache(
                llama, B).nbytes()
            seen, hook = feeds_of(llama)
            toks = route(f"llama_greedy_{tag}", lambda: generate(
                llama, lprompt, L, use_cache=True))
            hook.remove()
            check(seen == [(P - 1, True)] + [(1, True)] * (L - P),
                  f"LLaMA {tag}: cached feeds {seen[:4]}")
            out["routes"][f"llama_greedy_{tag}"]["token_agreement"] = \
                agreement(toks, lgreedy)
            forced_int8[int8] = forced(torch, llama, lgreedy,
                                       spans_of(P, L, 1),
                                       init_decode_cache(llama, B))
        for m in attns:
            m.kv_cache_int8 = False
        within("llama_bf16", forced_int8[False], lref, lbound)
        lim = INT8_REL * float(forced_int8[False].abs().max())
        err8 = float((forced_int8[True] - forced_int8[False]).abs().max())
        out["llama_int8_vs_bf16"] = {"max_abs_err": err8, "bound": lim}
        check(err8 < lim, f"int8 cache within {INT8_REL} max|logit| of the "
              f"bf16 cache: {err8} < {lim}")
        with newest_row_hidden():
            fails("llama_newest_row_hidden", forced(
                torch, llama, lgreedy, spans_of(P, L, 1),
                init_decode_cache(llama, B)), lref, lbound)
        out["llama_int8_over_bf16_bytes"] = (
            out["llama_400m_cache_bytes_int8"]
            / out["llama_400m_cache_bytes_bf16"])
        take(True)
        del llama, lref, forced_int8
        gc.collect()

        # --- T5-small -----------------------------------------------------
        t5 = build_t5(torch, dev, args.seed).eval()
        src = torch.randint(0, T5_VOCAB, (B, T5_SEQ), generator=gen,
                            device=dev)
        t5_ref_toks = t5_greedy_decode(t5, src, T5_GEN_LEN)
        memory = t5.encode(src)
        tref = t5.decode(t5_ref_toks, memory).float()[:, :T5_GEN_LEN - 1]
        twin = fp32_twin(torch, t5, lambda c: T5(c))
        tbound = FORCED_C * float((twin.decode(
            t5_ref_toks, twin.encode(src)).float()[:, :T5_GEN_LEN - 1]
            - tref).abs().max())
        del twin
        out["bound_t5_small"] = tbound
        take(False)
        t5_new = B * (T5_GEN_LEN - 1)
        seen, hook = feeds_of(t5.decoder)
        t5_toks = route("t5_greedy", lambda: t5_greedy_decode(
            t5, src, T5_GEN_LEN, use_cache=True), t5_new)
        check(seen == [(1, True)] * (T5_GEN_LEN - 1),
              f"T5: one token a feed: {seen[:4]}")
        seen.clear()
        t5_beams, t5_scores = route("t5_beam_k4", lambda: t5_beam_decode(
            t5, src, T5_GEN_LEN, num_beams=GEN_BEAMS, use_cache=True),
            t5_new)
        hook.remove()
        check(seen == [(1, True)] * (T5_GEN_LEN - 1)
              and bool(torch.isfinite(t5_scores).all()),
              f"T5 beam: one token a hypothesis a feed: {seen[:4]}")
        out["routes"]["t5_greedy"]["token_agreement"] = float(
            (t5_toks == t5_ref_toks).float().mean())
        for toks in (t5_toks, t5_beams):
            check(toks.shape == (B, T5_GEN_LEN)
                  and bool((toks[:, 0] == 0).all()),
                  "T5: (B, 32) tokens after bos")
        cross_kv = t5.project_cross_kv(memory)

        def t5_forced():
            cache = init_decode_cache(t5, B)
            return torch.cat([t5.decode(t5_ref_toks[:, t:t + 1], memory,
                                        pos=t, cross_kv=cross_kv,
                                        cache=cache).float()
                              for t in range(T5_GEN_LEN - 1)], dim=1)
        within("t5", t5_forced(), tref, tbound)
        with newest_row_hidden():
            fails("t5_newest_row_hidden", t5_forced(), tref, tbound)
        take(True)
        del t5, memory, cross_kv, tref
    check(all(launches[k] == 0 for k in FLASH_COUNTS),
          f"no flash launch inside a cached route: {launches}")
    reforward = READINGS.get("generate", {})
    emit({"phase": "generate_cached",
          "model": f"GPT-2 small ({GEN_CACHED_GPT_LAYERS} of 12 layers); "
                   f"LLaMA-400M ({GEN_CACHED_LLAMA_LAYERS} of 24 layers); "
                   f"T5-small", "batch": B,
          "prompt": P, "max_len": L, "gamma": GEN_GAMMA, "beams": GEN_BEAMS,
          "top_k": GEN_TOP_K, "shared_prefix": GEN_PREFIX,
          "capacity": {"gpt2_small": GPT_SEQ,
                       "llama_400m": LLAMA_GEN_CAPACITY,
                       "t5_small": 512},
          "t5_source": T5_SEQ, "t5_max_len": T5_GEN_LEN,
          "reforward_generated_tokens_per_sec": reforward,
          **out, "launches_in_cached_routes": launches,
          "sampled_streams_bit_equal": True,
          "bound": f"{FORCED_C} x max|bf16 re-forward - fp32 re-forward| "
                   f"logits of the same weights and tokens",
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "note": "tokens/s: generated tokens over the host clock; device "
                  "ms and launches a decode step (B tokens) under "
                  "torch.profiler over one whole decode",
          "card": card})
    return launches


# The serving engine (A15's second half): GPT-2 small at capacity 1024
# through 8 slots, chunked prefill of 64 (JAX's default), 32 requests
# submitted up front; LLaMA-400M with the int8 cache through 4 slots.
SERVE_SLOTS, SERVE_CHUNK, SERVE_MAX_LEN = 8, 64, 1024
SERVE_REQUESTS, SERVE_SAMPLED, SERVE_EOS = 32, 8, 2
SERVE_PROMPT, SERVE_NEW = (16, 512), (16, 128)
SERVE_SAMPLING = {"temperature": 0.8, "top_k": 50, "top_p": 0.95}
SERVE_DISRUPT_AT = 40        # engine steps before the migration / commit
SERVE_ROLLBACK_AFTER = 6     # steps past the commit before the restore
SERVE_AGREEMENT = 8          # greedy requests decoded again at batch 1
SERVE_STEADY_STEPS = 30      # decode steps of the steady-batch probe
LLAMA_SERVE_SLOTS, LLAMA_SERVE_REQUESTS = 4, 8
SERVE_LLAMA_LAYERS = 8       # serve's depth cut of LLaMA-400M (widths stay)
LLAMA_SERVE_PROMPT, LLAMA_SERVE_NEW = (16, 256), (16, 64)
LAUNCH_SERVING_TIMEOUT = 300  # seconds for the launched serving worker
# The launched worker's model and its device (a CPU rehearsal swaps them
# for gpt_tiny and ("--device", "cpu")).
LAUNCH_SERVING_MODEL, LAUNCH_SERVING_ARGS = "gpt2", ()
LAUNCH_SERVING_DEVICE = "cuda:0"


def serve_traffic(seed, vocab, n, n_sampled, prompt, new):
    """``n`` requests from ``seed``: prompt lengths in ``prompt`` and
    budgets in ``new`` (both inclusive), ``n_sampled`` of them sampled at
    SERVE_SAMPLING with a seed each, the rest greedy."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = rng.integers(prompt[0], prompt[1] + 1, n)
    news = rng.integers(new[0], new[1] + 1, n)
    sampled = set(rng.choice(n, n_sampled, replace=False).tolist())
    out = []
    for i in range(n):
        r = {"prompt": rng.integers(0, vocab, int(lens[i])).tolist(),
             "max_new": int(news[i])}
        if i in sampled:
            r.update(SERVE_SAMPLING, seed=int(rng.integers(0, 2 ** 31)))
        out.append(r)
    return out


def serve_run(torch, eng, traffic, after_step=None):
    """Every request of ``traffic`` submitted up front, the engine stepped
    until idle, ``after_step(step)`` after each step (the disruptions).
    Returns the requests, the seconds (host clock; each step ends in the
    logits' copy to the host) and the steps."""
    reqs = [eng.submit(**r) for r in traffic]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = 0
    while not eng.idle():
        eng.step()
        steps += 1
        if after_step is not None:
            after_step(steps)
    return reqs, time.perf_counter() - t0, steps


def check_served(reqs, traffic, what):
    """Every request done, its prompt first, then its whole budget or a
    stream ending at its first EOS."""
    for r, t in zip(reqs, traffic):
        gen, eos = r.committed, t.get("eos_id")
        check(r.done() and r.state == "done"
              and r.result(0)[:len(t["prompt"])] == t["prompt"],
              f"{what}: request {r.rid} done with its prompt first")
        early = eos is not None and eos in gen[:-1]
        check(not early and (len(gen) == t["max_new"]
                             or (eos is not None and gen[-1:] == [eos])),
              f"{what}: request {r.rid} has its whole budget "
              f"({len(gen)} of {t['max_new']}) or ends at its EOS {eos}")


def streams(reqs):
    return [r.result(0) for r in reqs]


def hist_quantiles(reg, name, qs=(0.5, 0.99)):
    """Quantiles of a registry histogram as the upper bounds of the buckets
    they fall in (what a Prometheus histogram_quantile reads at most)."""
    series = reg.snapshot()[name]["series"]
    if not series or not series[0]["count"]:
        return {}
    buckets, total = series[0]["buckets"], series[0]["count"]
    out = {}
    for q in qs:
        for le, n in buckets:
            if n >= q * total:
                out[f"p{round(q * 100)}_le_s"] = le
                break
    out["count"] = total
    out["mean_s"] = series[0]["sum"] / total
    return out


def forced_ratio(torch, model, twin, reqs, int8=False):
    """Teacher forcing of every greedy request: the fp32 twin's logits on
    its prompt and stream; each generated token's gap below its row's
    largest fp32 logit over the bound, the worst of them. The bound:
    FORCED_C x max|bf16 re-forward - fp32 re-forward| over the request's
    generated rows (``int8``: INT8_REL x the row's max|fp32 logit|, JAX's
    int8-cache limit)."""
    dev = next(model.parameters()).device
    worst, rows = 0.0, 0
    with torch.no_grad():
        for r in reqs:
            if r.temperature:
                continue
            seq, P = r.full_tokens(), len(r.prompt)
            ids = torch.tensor([seq[:-1]], device=dev)
            z = twin(ids).float()[0, P - 1:]
            tok = torch.tensor(seq[P:], device=dev)
            gap = z.max(-1).values - z.gather(1, tok[:, None])[:, 0]
            if int8:
                bound = INT8_REL * z.abs().max(-1).values
            else:
                bound = FORCED_C * (model(ids).float()[0, P - 1:]
                                    - z).abs().max()
            worst = max(worst, float((gap / bound).max()))
            rows += len(tok)
    return worst, rows


def serve_control(torch, model, traffic, how):
    """A short run of ``traffic`` through an engine with one program made
    wrong (``how``): every row fed one position late, or each admission
    installed into the neighbouring slot."""
    from horovod_tpu_torch.serving import ServingEngine
    eng = ServingEngine(model, num_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                        prefill_chunk=SERVE_CHUNK)
    if how == "late":
        right = eng._step_fn
        eng._step_fn = lambda m, c, toks, pos: right(m, c, toks, pos + 1)
    else:
        right = eng._install_fn
        eng._install_fn = lambda big, small, slot: right(
            big, small, (slot + 1) % SERVE_SLOTS)
    reqs, _, _ = serve_run(torch, eng, traffic)
    return reqs


def phase_serve(torch, dev, args, card):
    """The serving engine on GPT-2 small (bf16, capacity 1024; 8 slots,
    prefill_chunk 64, max_len 1024) under SERVE_REQUESTS requests from
    --seed, all submitted up front (prompts of 16-512 tokens, budgets of
    16-128; SERVE_SAMPLED sampled at temperature 0.8, top-k 50, top-p 0.95,
    a seed each; SERVE_EOS greedy ones with an EOS picked from a first run
    of the same traffic), then LLaMA-400M with the int8 cache (GQA 16/8)
    through 4 slots.

    Checks: every request completes with its whole budget or at its EOS;
    each greedy token within FORCED_C x the bf16 re-forward's distance of
    the largest logit of an fp32 re-forward of the prompt and the tokens
    before it, which an engine feeding each row one position late and one
    installing into the neighbouring slot must fail; a second run of the
    same submissions bit-equal; mid-run, kv_snapshot -> detach_to_host ->
    reset_runtime(kv=...) bit-equal to the undisturbed run with no prefill
    of a migrated request after it; mid-run, a ServingState commit, more
    steps, a restore and a reset: no request lost, none ahead of its
    commit, every committed prefix kept; no flash and no scale launch in
    the engine's runs; the frontend answers concurrent POSTs, /health and
    /debug/trace/<rid>, the metrics endpoint /metrics (the serving series)
    and /serving/health; LLaMA's int8 tokens within INT8_REL max|logit|.

    Printed: generated tokens/s and steps/s beside cached generate at batch
    8; TTFT and inter-token latency p50/p99 from the registry; host ms,
    device ms, busy share and launches a decode step; prefill tokens/s;
    install ms and bytes beside the byte bound; commit ms; kv_snapshot and
    restore ms and bytes; cache bytes (bf16, int8); the peak; token
    agreement with batch-1 generate(use_cache=True). Returns the launch
    counts of the engine's runs."""
    import threading
    from urllib import request as urlrequest

    import numpy as np

    from horovod_tpu_torch.metrics import instruments as ins
    from horovod_tpu_torch.metrics.server import MetricsServer
    from horovod_tpu_torch.models import (Llama, LlamaConfig, generate,
                                          init_decode_cache)
    from horovod_tpu_torch.models import GPT
    from horovod_tpu_torch.ops.kernels import flash_attention as fa
    from horovod_tpu_torch.ops.kernels import scale_buffers as sb
    from horovod_tpu_torch.serving import (Request, ServingEngine,
                                           ServingState, sample_token)
    from horovod_tpu_torch.serving.server import ServingFrontend

    out = {"runs": {}, "teacher_forced": {}, "controls": {},
           "peak_gb_by_part": {}}

    def part(name):
        """The peak of allocated memory since the last part, then reset."""
        out["peak_gb_by_part"][name] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()

    def counts():
        return dict(zip(STEP_COUNTS, (
            fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches,
            sb.pack_launches, sb.unpack_launches)))

    def engine(m, slots=SERVE_SLOTS, **kw):
        return ServingEngine(m, num_slots=slots, max_len=SERVE_MAX_LEN,
                             prefill_chunk=SERVE_CHUNK, **kw)

    def reading(name, reqs, seconds, steps):
        toks = sum(len(r.committed) for r in reqs)
        out["runs"][name] = {"generated_tokens": toks, "steps": steps,
                             "seconds": seconds,
                             "generated_tokens_per_sec": toks / seconds,
                             "steps_per_sec": steps / seconds}

    model = build_gpt(torch, dev, args.seed).eval()
    traffic = serve_traffic(args.seed + 31, GPT_VOCAB, SERVE_REQUESTS,
                            SERVE_SAMPLED, SERVE_PROMPT, SERVE_NEW)
    check(all(len(t["prompt"]) + t["max_new"] <= SERVE_MAX_LEN
              for t in traffic), "the traffic fits max_len")
    fa.reset_launch_counts()
    sb.reset_launch_counts()

    # Run 0 (warm-up, no EOS): two greedy requests take an EOS from it.
    reqs, s, n = serve_run(torch, engine(model), traffic)
    check_served(reqs, traffic, "run 0")
    reading("warmup_no_eos", reqs, s, n)
    greedy = [i for i, t in enumerate(traffic) if "temperature" not in t]
    for i in greedy[:SERVE_EOS]:
        gen = reqs[i].committed
        traffic[i]["eos_id"] = gen[len(gen) // 2]
    run0 = streams(reqs)

    # Run 1, the reference: TTFT and inter-token latency from the registry,
    # and each admission's prefill and install timed to a synchronize.
    ins.REGISTRY.reset()
    ref_eng = engine(model)
    prefill = {"seconds": 0.0, "tokens": 0}
    admit = ref_eng._prefill_into

    def timed_prefill(slot, req):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        admit(slot, req)
        torch.cuda.synchronize()
        prefill["seconds"] += time.perf_counter() - t0
        prefill["tokens"] += len(req.full_tokens()) - 1
    ref_eng._prefill_into = timed_prefill
    reqs1, s, n = serve_run(torch, ref_eng, traffic)
    out["prefill"] = {**prefill, "share_of_run": prefill["seconds"] / s,
                      "tokens_per_sec": prefill["tokens"]
                      / prefill["seconds"]}
    check_served(reqs1, traffic, "run 1")
    reading("reference", reqs1, s, n)
    ref = streams(reqs1)
    out["ttft"] = hist_quantiles(ins.REGISTRY, "serving_ttft_seconds")
    out["inter_token_latency"] = hist_quantiles(
        ins.REGISTRY, "serving_token_latency_seconds")
    ttft = sorted(r.t_first - r.t_submit for r in reqs1)
    out["ttft_exact_s"] = {"p50": ttft[len(ttft) // 2], "max": ttft[-1]}
    out["eos_requests"] = [
        {"eos_id": traffic[i]["eos_id"], "generated": len(reqs1[i].committed),
         "budget": traffic[i]["max_new"],
         "prefix_of_run0": run0[i][:len(ref[i])] == ref[i]}
        for i in greedy[:SERVE_EOS]]

    # Run 2: the same submissions, bit-equal.
    part("runs_0_1")
    reqs2, s, n = serve_run(torch, engine(model), traffic)
    reading("repeat", reqs2, s, n)
    check(streams(reqs2) == ref, "a second run of the same submissions is "
          "bit-equal, the sampled streams too")

    # Run 3: the KV migration mid-run.
    mig_eng = engine(model)
    mig = {}

    def migrate(step):
        if step != SERVE_DISRUPT_AT:
            return
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kv = mig_eng.kv_snapshot()
        t1 = time.perf_counter()
        mig_eng.detach_to_host()
        t2 = time.perf_counter()
        mig_eng.reset_runtime(kv=kv)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        moved = mig_eng._cache.nbytes()
        mig.update(rids={r.rid for r in mig_eng._sched.active().values()},
                   kv_snapshot_ms=(t1 - t0) * 1e3,
                   detach_ms=(t2 - t1) * 1e3, restore_ms=(t3 - t2) * 1e3,
                   bytes=moved, kv_snapshot_gb_per_s=moved / (t1 - t0) / 1e9,
                   restore_gb_per_s=moved / (t3 - t2) / 1e9)
        real = mig_eng._prefill_into
        mig["prefilled_after"] = []

        def counted(slot, req):
            mig["prefilled_after"].append(req.rid)
            return real(slot, req)
        mig_eng._prefill_into = counted
    reqs3, s, n = serve_run(torch, mig_eng, traffic, migrate)
    reading("migration", reqs3, s, n)
    check(mig.get("rids"), "the migration ran with requests in flight")
    check(streams(reqs3) == ref and all(r.requeues == 0 for r in reqs3),
          "migrated streams bit-equal to the undisturbed run, no requeue")
    check(not mig["rids"] & set(mig["prefilled_after"]),
          "no migrated request prefilled again after the migration")
    out["migration"] = {k: v for k, v in mig.items()
                        if k not in ("rids", "prefilled_after")}
    out["migration"]["in_flight"] = len(mig["rids"])

    # Run 4: commit, steps past it, restore, reset (re-prefill).
    rb_eng = engine(model)
    state = ServingState(rb_eng, step=0)
    rb = {}

    def rollback(step):
        if step == SERVE_DISRUPT_AT:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state.save()
            t1 = time.perf_counter()
            state.save()
            t2 = time.perf_counter()
            rb.update(first_commit_ms=(t1 - t0) * 1e3,
                      commit_ms=(t2 - t1) * 1e3,
                      committed={rs["rid"]: list(rs["committed"])
                                 for rs in state.reqs["active"]
                                 + state.reqs["queued"]})
        if step == SERVE_DISRUPT_AT + SERVE_ROLLBACK_AFTER:
            rb["at_restore"] = {r.rid for r in rb_eng._sched.active().values()}
            t0 = time.perf_counter()
            state.restore()
            torch.cuda.synchronize()
            rb["restore_ms"] = (time.perf_counter() - t0) * 1e3
            live = {r.rid: list(r.committed) for r in rb_eng._requests.values()}
            rb["kept_at_restore"] = all(
                live.get(rid) == c for rid, c in rb["committed"].items())
            state.reset()
    reqs4, s, n = serve_run(torch, rb_eng, traffic, rollback)
    check_served(reqs4, traffic, "rollback")
    reading("rollback", reqs4, s, n)
    check(rb.get("kept_at_restore"), "the restore put every request back at "
          "its committed tokens: none lost, none ahead")
    by_rid = {r.rid: r for r in reqs4}
    check(all(by_rid[rid].committed[:len(c)] == c
              for rid, c in rb["committed"].items()),
          "every committed prefix kept to the end")
    check(rb["at_restore"] and all(by_rid[rid].requeues >= 1
                                   for rid in rb["at_restore"]),
          "the requests in flight at the restore were requeued")
    out["rollback"] = {k: rb[k] for k in ("first_commit_ms", "commit_ms",
                                          "restore_ms")}
    out["rollback"]["in_flight"] = len(rb["at_restore"])
    out["rollback"]["token_agreement_with_reference"] = float(np.mean([
        np.mean([a == b for a, b in zip(x, y)])
        for x, y in zip(streams(reqs4), ref)]))
    del state
    part("runs_2_4")
    engine_launches = counts()
    check(all(v == 0 for v in engine_launches.values()),
          f"no flash and no scale launch in the engine's runs: "
          f"{engine_launches}")

    # Teacher forcing, then the two wrong controls on the first greedy
    # requests (budgets cut to 16).
    twin = fp32_twin(torch, model, lambda c: GPT(c))
    worst, rows = forced_ratio(torch, model, twin, reqs1)
    out["teacher_forced"]["gpt2_small"] = {"worst_ratio": worst,
                                           "tokens": rows}
    check(worst <= 1.0, f"every greedy token within the bound: worst "
          f"{worst} of it")
    ctl = [dict(traffic[i], max_new=16) for i in greedy[:SERVE_SLOTS]]
    for t in ctl:
        t.pop("eos_id", None)
    for how in ("late", "neighbour"):
        w, _ = forced_ratio(torch, model, twin,
                            serve_control(torch, model, ctl, how))
        out["controls"][how] = {"worst_ratio": w}
        check(w > 1.0, f"control {how} fails the bound: {w}")
    del twin
    gc.collect()
    part("teacher_forcing_and_controls")

    # Batch-1 cached generate on some greedy requests; cached generate at
    # batch 8 (the generate phases' setting) for tokens/s.
    same = []
    with torch.no_grad():
        for i in greedy[:SERVE_AGREEMENT]:
            t = traffic[i]
            g = generate(model, torch.tensor([t["prompt"]], device=dev),
                         len(t["prompt"]) + t["max_new"],
                         use_cache=True)[0].tolist()
            same.append(float(np.mean([a == b for a, b in zip(
                g[len(t["prompt"]):], ref[i][len(t["prompt"]):])])))
        gen8 = torch.randint(0, GPT_VOCAB, (GEN_BATCH, GEN_PROMPT),
                             generator=torch.Generator(device=dev).manual_seed(
                                 args.seed + 37), device=dev)
        generate(model, gen8, GEN_LEN, use_cache=True)
        _, s8 = timed_call(torch, lambda: generate(model, gen8, GEN_LEN,
                                                   use_cache=True))
    out["token_agreement_batch1_generate"] = {
        "requests": len(same), "mean": float(np.mean(same)),
        "identical": sum(x == 1.0 for x in same)}
    out["cached_generate_batch8_tokens_per_sec"] = \
        GEN_BATCH * (GEN_LEN - GEN_PROMPT) / s8
    out["engine_over_generate_batch8"] = (
        out["runs"]["reference"]["generated_tokens_per_sec"]
        / out["cached_generate_batch8_tokens_per_sec"])
    part("generate")

    # A steady batch: 8 requests admitted at once, then decode steps only:
    # a step's host time, and apart, its forward with the logits' copy and
    # the host sampling of its 8 rows.
    steady = engine(model)
    for i in range(SERVE_SLOTS):
        steady.submit(traffic[i]["prompt"][:64], max_new=SERVE_NEW[1],
                      **{k: traffic[i][k] for k in ("temperature", "top_k",
                                                    "top_p", "seed")
                         if k in traffic[i]})
    steady.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SERVE_STEADY_STEPS):
        steady.step()
    host_ms = (time.perf_counter() - t0) * 1e3 / SERVE_STEADY_STEPS
    feed = torch.from_numpy(np.stack([steady._tokens, steady._pos]).astype(
        np.int64)).to(dev)
    with torch.no_grad():
        t0 = time.perf_counter()
        for _ in range(SERVE_STEADY_STEPS):
            rows = steady._step_fn(model, steady._cache, feed[0],
                                   feed[1])[0].float().cpu().numpy()
        forward_ms = (time.perf_counter() - t0) * 1e3 / SERVE_STEADY_STEPS
    live = list(steady._sched.active().items())
    t0 = time.perf_counter()
    for _ in range(SERVE_STEADY_STEPS):
        for slot, r in live:
            sample_token(rows[slot], r.temperature, r.top_k, r.top_p, r.seed,
                         len(r.committed))
    sample_ms = (time.perf_counter() - t0) * 1e3 / SERVE_STEADY_STEPS
    row = np.random.default_rng(args.seed).standard_normal(
        GPT_VOCAB).astype(np.float32)
    for name, kw in (("greedy", {"temperature": 0.0, "top_k": 0,
                                 "top_p": 1.0}),
                     ("top_k_top_p", dict(SERVE_SAMPLING)),
                     ("top_p_only", {"temperature": 0.8, "top_k": 0,
                                     "top_p": 0.95})):
        t0 = time.perf_counter()
        for i in range(20):
            sample_token(row, kw["temperature"], kw["top_k"], kw["top_p"], 1,
                         i)
        out.setdefault("host_sample_ms_a_row", {})[name] = \
            (time.perf_counter() - t0) * 1e3 / 20
    # Install alone: the batch-1 template's rows into one slot.
    small_bytes = steady._small_zero.nbytes()
    out["install"] = {
        "ms": event_ms(lambda: steady._install_fn(steady._cache,
                                                  steady._small_zero, 0),
                       reps=20),
        "bytes": 2 * small_bytes,
        "bound_ms": 2 * small_bytes / H100_BYTES_PER_S * 1e3}
    out["cache_bytes_bf16"] = steady._cache.nbytes()
    out["decode_step"] = {
        "host_ms": host_ms, "forward_and_logits_copy_ms": forward_ms,
        "host_sampling_ms": sample_ms,
        "sampled_rows": sum(1 for _, r in live if r.temperature),
        "slots": SERVE_SLOTS}
    part("steady_probe")

    # The frontend, its drive thread, the metrics endpoint.
    fe_eng = engine(model)
    fe = ServingFrontend(fe_eng, port=0, addr="127.0.0.1",
                         request_timeout=120)
    srv = MetricsServer(port=0, addr="127.0.0.1")
    fe.start()
    srv.start()
    try:
        base = f"http://127.0.0.1:{fe.port}"

        def post(i, body):
            req = urlrequest.Request(
                base + "/generate", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urlrequest.urlopen(req, timeout=120) as resp:
                answers[i] = (resp.status, json.loads(resp.read()))
        bodies = [{"prompt": traffic[i]["prompt"][:32], "max_new": 16,
                   **({"temperature": 0.8, "top_k": 50, "top_p": 0.95,
                       "seed": 5} if i == 0 else {})}
                  for i in range(SERVE_SLOTS)]
        answers = [None] * len(bodies)
        threads = [threading.Thread(target=post, args=(i, b))
                   for i, b in enumerate(bodies)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(180)
        fe_s = time.perf_counter() - t0
        check(all(a is not None and a[0] == 200
                  and a[1]["tokens"][:len(b["prompt"])] == b["prompt"]
                  and len(a[1]["tokens"]) == len(b["prompt"]) + 16
                  for a, b in zip(answers, bodies)),
              f"the frontend answered every concurrent POST: {answers}")

        def get(url):
            with urlrequest.urlopen(url, timeout=30) as resp:
                return resp.status, resp.read()
        code, body = get(base + "/health")
        check(code == 200 and json.loads(body)["served"] == len(bodies),
              "GET /health")
        code, body = get(f"{base}/debug/trace/{answers[1][1]['rid']}")
        tree = json.loads(body)
        check(code == 200 and tree["done"] and [c["name"] for c in
                                                tree["children"]][:4]
              == ["submit", "queue", "prefill", "decode"],
              "GET /debug/trace/<rid>: the request's span tree")
        code, body = get(f"http://127.0.0.1:{srv.port}/metrics")
        check(code == 200 and b"horovod_serving_tokens_total" in body
              and b"horovod_serving_ttft_seconds_bucket" in body,
              "the metrics endpoint's /metrics carries the serving series")
        code, body = get(f"http://127.0.0.1:{srv.port}/serving/health")
        check(code == 200 and json.loads(body)["served"] == len(bodies),
              "the metrics endpoint serves /serving/health")
        check(fe.drive_errors == 0, "no drive-thread error")
        out["frontend"] = {"requests": len(bodies), "seconds": fe_s,
                           "trace_children": [c["name"] for c in
                                              tree["children"]]}
    finally:
        fe.stop()
        srv.stop()
    model_ref = model
    del fe, fe_eng, ref_eng, mig_eng, rb_eng, model
    gc.collect()
    part("frontend")

    # LLaMA-400M at SERVE_LLAMA_LAYERS of its 24 layers, the int8 cache, 4
    # slots.
    llama = build_on(torch, dev, lambda g: Llama(LlamaConfig.bench(
        num_layers=SERVE_LLAMA_LAYERS, dtype=torch.bfloat16, use_flash=True,
        kv_cache_int8=True), generator=g), args.seed).eval()
    ltraffic = serve_traffic(args.seed + 41, 32000, LLAMA_SERVE_REQUESTS, 0,
                             LLAMA_SERVE_PROMPT, LLAMA_SERVE_NEW)
    fa.reset_launch_counts()
    sb.reset_launch_counts()
    leng = ServingEngine(llama, num_slots=LLAMA_SERVE_SLOTS,
                         max_len=SERVE_MAX_LEN, prefill_chunk=SERVE_CHUNK)
    lreqs, s, n = serve_run(torch, leng, ltraffic)
    check_served(lreqs, ltraffic, "LLaMA int8")
    reading("llama_400m_int8", lreqs, s, n)
    llama_launches = counts()
    check(all(v == 0 for v in llama_launches.values()),
          f"no flash and no scale launch in LLaMA's engine run: "
          f"{llama_launches}")
    for k, v in llama_launches.items():
        engine_launches[k] += v
    out["cache_bytes_int8_llama_400m"] = leng._cache.nbytes()
    for m in llama.modules():
        if hasattr(m, "kv_cache_int8"):
            m.kv_cache_int8 = False
    out["cache_bytes_bf16_llama_400m"] = init_decode_cache(
        llama, LLAMA_SERVE_SLOTS).nbytes()
    ltwin = fp32_twin(torch, llama, lambda c: Llama(c))
    lworst, lrows = forced_ratio(torch, llama, ltwin, lreqs, int8=True)
    out["teacher_forced"]["llama_400m_int8"] = {"worst_ratio": lworst,
                                                "tokens": lrows}
    check(lworst <= 1.0, f"every LLaMA int8 token within {INT8_REL} "
          f"max|logit| of the fp32 re-forward's largest: worst {lworst}")
    del llama, ltwin, leng
    part("llama_400m_int8")
    # The steady batch's device time, last, so that no timed part runs
    # after a torch.profiler window; the forward timed again after it.
    busy, share, launches = device_ms(torch, steady.step, steps=10,
                                      launches=True)
    with torch.no_grad():
        t0 = time.perf_counter()
        for _ in range(SERVE_STEADY_STEPS):
            steady._step_fn(model_ref, steady._cache, feed[0],
                            feed[1])[0].float().cpu()
        after_ms = (time.perf_counter() - t0) * 1e3 / SERVE_STEADY_STEPS
    out["decode_step"].update(
        device_ms=busy, device_busy_share=share, launches=launches,
        forward_and_logits_copy_ms_after_profiler=after_ms)
    del steady, model_ref
    emit({"phase": "serve", "model": "GPT-2 small; LLaMA-400M (int8 cache)",
          "slots": SERVE_SLOTS, "prefill_chunk": SERVE_CHUNK,
          "max_len": SERVE_MAX_LEN, "requests": SERVE_REQUESTS,
          "sampled": SERVE_SAMPLED, "sampling": SERVE_SAMPLING,
          "prompt_tokens": SERVE_PROMPT, "new_tokens": SERVE_NEW,
          "llama_slots": LLAMA_SERVE_SLOTS,
          "llama_requests": LLAMA_SERVE_REQUESTS, **out,
          "launches_in_engine_runs": engine_launches,
          "bound": f"greedy: {FORCED_C} x max|bf16 re-forward - fp32 "
                   f"re-forward| logits of the request; int8: {INT8_REL} x "
                   f"the row's max|fp32 logit|",
          "peak_mem_gb": max(out["peak_gb_by_part"].values()),
          "note": "tokens/s: generated tokens over the host clock of a run "
                  "(every request submitted up front); TTFT and latency "
                  "quantiles: the registry bucket's upper bound",
          "card": card})
    return engine_launches


def phase_launch_serving(torch, args, card):
    """``hvdrun-torch -np 1 --serving --serving-port <free port>
    --serving-slots 4 python -m horovod_tpu_torch.serving`` with
    HOROVOD_SERVING_MODEL=gpt2 (fp32, 1024 positions, weights from the
    worker's fixed seed) on the card, HOROVOD_METRICS_PORT and
    HOROVOD_TRACE_DIR set: four concurrent POST /generate (one sampled),
    GET /health, the metrics endpoint's /serving/health and
    /debug/trace/<rid>, then SIGTERM to the worker. Checks: the answers
    (prompt, then the budget), the worker on cuda:0, the launcher's exit
    code 0 and the worker gone, the trace shard holding the four requests.
    Printed: the seconds to the first answer and the answers' tokens/s,
    and the greedy answers' agreement with batch-1 generate on the same
    model in this process."""
    import threading
    from urllib import request as urlrequest

    from horovod_tpu_torch.models import generate
    from horovod_tpu_torch.serving.__main__ import build_model

    port, mport = free_port(), free_port()
    trace_dir = ROOT / "build" / "launch_serving"
    trace_dir.mkdir(parents=True, exist_ok=True)
    shard = trace_dir / "trace_r0.json"
    if shard.exists():
        shard.unlink()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")]),
        HOROVOD_SERVING_MODEL=LAUNCH_SERVING_MODEL,
        HOROVOD_SERVING_MAX_LEN="1024",
        HOROVOD_TRACE_DIR=str(trace_dir), HOROVOD_METRICS_PORT=str(mport))
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "1",
           "-H", "localhost:1", "--serving", "--serving-port", str(port),
           "--serving-slots", "4", sys.executable, "-m",
           "horovod_tpu_torch.serving", *LAUNCH_SERVING_ARGS]
    t_start = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=str(ROOT), env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)
    lines, ready = [], threading.Event()
    started = {}

    def reader():
        for line in proc.stdout:
            lines.append(line)
            if f"# serving {LAUNCH_SERVING_MODEL} on :" in line \
                    and not ready.is_set():
                started["line"] = line.strip()
                started["pid"] = int(line.rsplit("pid=", 1)[1].split(")")[0])
                ready.set()
        ready.set()
    th = threading.Thread(target=reader, daemon=True)
    th.start()
    try:
        check(ready.wait(LAUNCH_SERVING_TIMEOUT) and "pid" in started,
              f"the serving worker started: {''.join(lines)[-3000:]}")
        pid = started["pid"]
        ready_s = time.perf_counter() - t_start
        check(f"on :{port} " in started["line"]
              and f"device={LAUNCH_SERVING_DEVICE}" in started["line"],
              f"the worker serves on its port, on {LAUNCH_SERVING_DEVICE}: "
              f"{started['line']}")
        import numpy as np
        rng = np.random.default_rng(args.seed + 43)
        bodies = [{"prompt": rng.integers(0, GPT_VOCAB, 32).tolist(),
                   "max_new": 16} for _ in range(4)]
        bodies[3].update(temperature=0.8, top_k=50, top_p=0.95, seed=9)
        answers = [None] * 4

        def post(i):
            req = urlrequest.Request(
                f"http://127.0.0.1:{port}/generate",
                data=json.dumps(bodies[i]).encode(),
                headers={"Content-Type": "application/json"})
            with urlrequest.urlopen(req, timeout=120) as resp:
                answers[i] = (resp.status, json.loads(resp.read()))
        t0 = time.perf_counter()
        posts = [threading.Thread(target=post, args=(i,)) for i in range(4)]
        for t in posts:
            t.start()
        for t in posts:
            t.join(150)
        answer_s = time.perf_counter() - t0
        check(all(a is not None and a[0] == 200
                  and a[1]["tokens"][:32] == b["prompt"]
                  and len(a[1]["tokens"]) == 48
                  for a, b in zip(answers, bodies)),
              f"four answers, each its prompt then 16 tokens: {answers}")

        def get(url):
            with urlrequest.urlopen(url, timeout=30) as resp:
                return resp.status, json.loads(resp.read())
        code, health = get(f"http://127.0.0.1:{port}/health")
        check(code == 200 and health["served"] == 4 and health["slots"] == 4,
              f"GET /health: {health}")
        code, mhealth = get(f"http://127.0.0.1:{mport}/serving/health")
        check(code == 200 and mhealth["served"] == 4,
              "the metrics endpoint's /serving/health")
        code, tree = get(f"http://127.0.0.1:{port}/debug/trace/"
                         f"{answers[0][1]['rid']}")
        check(code == 200 and tree["done"], "GET /debug/trace/<rid>")
        os.kill(pid, signal.SIGTERM)
        rc = proc.wait(60)
        th.join(10)
        check(rc == 0, f"the launcher exits 0 after the worker's SIGTERM: "
              f"{rc}\n{''.join(lines)[-3000:]}")
        check(gone(pid), "the worker is gone")
        dumped = json.loads(shard.read_text())
        # The engine's steps, marked for the step profiler, leave step
        # traces beside the requests' (kind "step"), as JAX's do.
        check(sorted(t["rid"] for t in dumped["traces"]
                     if t["kind"] == "request")
              == sorted(a[1]["rid"] for a in answers)
              and {t["kind"] for t in dumped["traces"]} <= {"request",
                                                            "step"},
              "the trace shard holds the four requests")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    dev = torch.device(LAUNCH_SERVING_DEVICE)
    model = build_model(LAUNCH_SERVING_MODEL, 1024, dev)
    same = []
    with torch.no_grad():
        for a, b in zip(answers[:3], bodies[:3]):
            g = generate(model, torch.tensor([b["prompt"]], device=dev), 48,
                         use_cache=True)[0].tolist()
            same.append(sum(x == y for x, y in zip(g[32:], a[1]["tokens"][
                32:])) / 16)
    del model
    emit({"phase": "launch_serving",
          "model": f"{LAUNCH_SERVING_MODEL} (fp32)",
          "worker": started["line"], "seconds_to_ready": ready_s,
          "answer_seconds": answer_s,
          "generated_tokens_per_sec": 4 * 16 / answer_s,
          "ttft_s": [a[1]["ttft_s"] for a in answers],
          "greedy_agreement_with_batch1_generate": same,
          "exit_code": rc, "trace_shard_requests": len(dumped["traces"]),
          "card": card})


OBSERVE_ROUNDS = 4          # rounds of (disarmed block, armed block)
OBSERVE_BLOCK_STEPS = 4     # optimizer steps a block
OBSERVE_CAPTURE_STEPS = 2   # steps of the last armed block under capture
OBSERVE_KERNELS = ("fa_fwd_mma_kernel", "scale_copy_kernel")


def arm_planes(on):
    """Every per-rank observability plane on or off (the timeline is
    started and stopped around each armed block apart)."""
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.flight import recorder
    from horovod_tpu_torch.goodput import ledger as goodput
    from horovod_tpu_torch.profile import ledger
    recorder.set_enabled(on)
    ledger.set_enabled(on)
    goodput.armed = on
    metrics.set_enabled(on)
    if on:
        ledger.reset_window()       # the disarmed block is no step window


def http_get(port, path):
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.status, r.read().decode()


def flash_main_case_vs_plain(torch, dev, seed):
    """The three flash kernels at the observe path's shape (GPT-2 small's
    attention: BH 96, L 1024, d 64, bf16, causal) against their plain
    versions rounding P and dS as the kernels do: each within the rounding
    bound. Returns each kernel's max abs error."""
    from horovod_tpu_torch.ops.kernels import flash_attention as fa
    dt, bh, lq, lk, d, causal = MAIN_FLASH_CASE[:6]
    dtype = getattr(torch, dt)
    gen = torch.Generator(device=dev).manual_seed(seed + 18)
    q, k, v, do = (torch.randn(bh, n, d, generator=gen, device=dev)
                   .to(dtype) for n in (lq, lk, lk, lq))
    sm = d ** -0.5
    o, lse = fa.fa_forward(q, k, v, causal, sm)
    dq, dk, dv = fa.fa_backward(q, k, v, o, lse, do, causal, sm)
    torch.cuda.synchronize()
    o_r, _ = fa.block_fwd_reference(q, k, v, causal, sm, None, None,
                                    round_p=dtype)
    dq_r, dk_r, dv_r = fa.block_bwd_reference(q, k, v, o, lse, do, causal,
                                              sm, None, None, round_p=dtype)
    plain = {"o": o_r, "dq": dq_r, "dk": dk_r, "dv": dv_r}
    bounds = fa.rounding_bounds(plain, q, k, v, causal, sm, None, None,
                                o3=o, lse=lse, do3=do)
    errs = {}
    for name, key, got in (("flash_fwd", "o", o), ("flash_bwd_dq", "dq", dq),
                           ("flash_bwd_dk", "dk", dk),
                           ("flash_bwd_dv", "dv", dv)):
        ratio = fa.bound_ratio(got, plain[key], bounds[key])
        check(ratio <= 1.0, f"observe: {name} at {MAIN_FLASH_CASE}: "
              f"{ratio} of the rounding bound")
        errs[name] = (got.float() - plain[key].float()).abs().max().item()
    return errs


def phase_observe(torch, hvd, dev, args, card):
    """A16's per-rank planes on GPT-2 small at full width (train_gpt's
    settings: 8 x 1024 tokens, bf16, flash, AdamW in
    hvd.DistributedOptimizer, fused buckets). OBSERVE_ROUNDS rounds of a
    disarmed then an armed block of OBSERVE_BLOCK_STEPS steps, every block
    timed from an idle card. Armed: the timeline (a file per block), the
    flight recorder, the step profiler with its watchdog and MFU (the step's
    FLOPs counted by FlopCounterMode plus the flash kernels' attention
    term, which it cannot see), goodput and metrics, with the scrape
    endpoint serving. Returns the path's launch counts."""
    import tempfile

    import torch.nn.functional as F

    from horovod_tpu_torch.flight import analyze
    from horovod_tpu_torch.flight import recorder
    from horovod_tpu_torch.goodput import ledger as goodput
    from horovod_tpu_torch.metrics import server as msrv
    from horovod_tpu_torch.ops.fusion import get_runtime
    from horovod_tpu_torch.ops.kernels import flash_attention as fa
    from horovod_tpu_torch.ops.kernels import scale_buffers as sb
    from horovod_tpu_torch.profile import capture, ledger, roofline

    work = tempfile.mkdtemp(prefix="hvd_observe_")
    capture.configure_window("", base_dir=work)     # captures go here
    flash_err = flash_main_case_vs_plain(torch, dev, args.seed)
    model = build_gpt(torch, dev, args.seed)
    cfg = model.config
    gen = torch.Generator(device=dev).manual_seed(args.seed + 4)
    ids = torch.randint(0, cfg.vocab_size, (GPT_BATCH, GPT_SEQ),
                        generator=gen, device=dev)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=1e-4),
        named_parameters=model.named_parameters())

    # Explicit step marks: an earlier phase's explicit marks (the serving
    # engine's, an elastic commit's) suppress the optimizer's auto marks
    # for the rest of the process, as JAX's recorder does. The ledger's
    # history is bounded (earlier phases filled it): a block's records are
    # those of its epoch, which arming opens.
    marks = [0]

    def mark():
        marks[0] += 1
        hvd.step_marker(marks[0])
        return marks[0]

    def step():
        opt.zero_grad()
        value = next_token_loss(F, model(ids), ids)
        value.backward()
        opt.step()
        mark()
        return value.detach()

    arm_planes(False)
    for _ in range(args.warmup):
        step()
    # The scale kernels held against the local gradients, as train_gpt.
    reduced_equals_local(torch, model, step)
    counted, _ = roofline.flops_of_step(step)
    check(counted, "FlopCounterMode counted the step")
    attn = cfg.num_layers * roofline.attention_flops(
        GPT_BATCH * GPT_HEADS, GPT_SEQ, GPT_SEQ, GPT_HEAD_DIM, causal=True)
    flops = counted + attn
    hvd.set_flops_per_step(flops)
    port = msrv.start_http_server(0, addr="127.0.0.1")
    torch.cuda.synchronize()
    fa.reset_launch_counts()                  # the path starts here
    sb.reset_launch_counts()
    rt = get_runtime()
    tokens = GPT_BATCH * GPT_SEQ * OBSERVE_BLOCK_STEPS
    # The last armed block runs its last steps under torch.profiler: its
    # tokens/s stands apart ("armed_capture").
    tps = {"disarmed": [], "armed": [], "armed_capture": []}
    blocks, snaps, device_s, device_buckets = [], [], 0.0, 0
    capture_dir = None
    for rnd in range(OBSERVE_ROUNDS):
        for on in (False, True):
            arm_planes(on)
            last = on and rnd == OBSERVE_ROUNDS - 1
            if on:
                tl_path = os.path.join(work, f"timeline_{rnd}.json")
                hvd.start_timeline(tl_path)
                i0 = recorder.get().appended()
                epoch = ledger.get()._epoch
                b0 = rt.flush_stats()["buckets"]
                mark()                        # opens the block's first window
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(OBSERVE_BLOCK_STEPS):
                if last and i == OBSERVE_BLOCK_STEPS - OBSERVE_CAPTURE_STEPS:
                    capture_dir = capture.start("observe")
                    check(capture_dir is not None, f"the capture started: "
                          f"{capture.last_refusal}")
                step()
                if on:
                    snaps.append(goodput.snapshot())
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            tps["armed_capture" if last else "armed" if on
                else "disarmed"].append(tokens / elapsed)
            if not on:
                continue
            if last:
                check(capture.stop() == capture_dir, "the capture stopped")
            # The blocks' last buckets, done by now: read without a wait.
            rest = ledger.get().harvest_device()
            buckets = rt.flush_stats()["buckets"] - b0
            hvd.stop_timeline()
            recs = [r for r in ledger.get().records()
                    if r["epoch"] == epoch]
            events = [e for e in recorder.events() if e["i"] >= i0]
            with open(tl_path) as f:
                tl = json.load(f)["traceEvents"]
            blocks.append({"records": recs, "events": events, "tl": tl,
                           "buckets": buckets})
            device_s += sum(r.get("device_collective_s", 0.0)
                            for r in recs) + sum(d[3] for d in rest)
            device_buckets += sum(r.get("device_buckets", 0)
                                  for r in recs) + len(rest)
            if rnd == 0:
                code_s, body_s = http_get(port, "/debug/steps?last=4")
                code_f, body_f = http_get(port, "/debug/flight")
    launches = {"flash_fwd": fa.fwd_launches,
                "flash_bwd_dq": fa.bwd_dq_launches,
                "flash_bwd_dkv": fa.bwd_dkv_launches,
                "scale_pack": sb.pack_launches,
                "scale_unpack": sb.unpack_launches}   # the path ends
    arm_planes(True)
    msrv.stop_http_server()
    steps_armed = OBSERVE_ROUNDS * OBSERVE_BLOCK_STEPS
    n_steps = OBSERVE_ROUNDS * OBSERVE_BLOCK_STEPS * 2
    check(all(launches[k] == cfg.num_layers * n_steps for k in FLASH_COUNTS)
          and launches["scale_pack"] > 0
          and launches["scale_pack"] == launches["scale_unpack"],
          f"observe: {cfg.num_layers} launches of each flash kernel a step "
          f"and both scale kernels: {launches}")
    # goodput: conserved at every snapshot
    worst = max(s["conservation_error"] for s in snaps)
    check(all(s.get("enabled") for s in snaps) and worst <= 0.01,
          f"goodput conserved within 1% at every snapshot (worst {worst})")
    # step records, flight pairs, timeline spans
    recs = [r for b in blocks for r in b["records"]]
    check(all(len(b["records"]) == OBSERVE_BLOCK_STEPS for b in blocks),
          f"one step record per optimizer step: "
          f"{[len(b['records']) for b in blocks]}")
    cats = set(ledger.CATEGORIES) | {"compute"}
    check(all(set(r["attribution"]) == cats for r in recs),
          "every record splits its wall into the attribution categories")
    mfus = [r.get("mfu") for r in recs]
    check(all(m is not None and 0.0 < m < 1.0 for m in mfus),
          f"MFU against the {recs[0].get('chip')} row in (0, 1): {mfus}")
    check(recs[0].get("chip") == "h100", f"the H100 row: {recs[0]['chip']}")
    seqs = []
    for b in blocks:
        disp = {(e.get("ps"), e.get("seq")) for e in b["events"]
                if e.get("kind") == "dispatch"}
        done = {(e.get("ps"), e.get("seq")) for e in b["events"]
                if e.get("kind") == "complete"}
        check(disp and disp == done, "every flight dispatch has its "
              "complete")
        seqs += sorted(s for ps, s in disp if ps == "global")
        tl = b["tl"]
        check(tl[0]["name"] == "clock_sync" and tl[0]["ph"] == "M",
              "the timeline opens with clock_sync")
        spans = [e for e in tl if e.get("cat") == "ALLREDUCE"
                 and e["name"].startswith("fused_allreduce")]
        execute = [e for e in tl if e.get("cat") == "execute"]
        check(len(spans) == b["buckets"] > 0, f"the timeline's collective "
              f"spans equal the buckets dispatched: {len(spans)} vs "
              f"{b['buckets']}")
        b["execute"] = len(execute)
    check(seqs == list(range(seqs[0], seqs[0] + len(seqs))),
          "the flight recorder's global seqs are contiguous over the blocks")
    check(device_buckets > 0, "the buckets' device times were read")
    # the capture
    trace_text = pathlib.Path(capture_dir, "trace.json").read_text()
    missing = [k for k in OBSERVE_KERNELS if k not in trace_text]
    check(not missing, f"the capture names {OBSERVE_KERNELS}: missing "
          f"{missing}")
    # the scrape endpoint
    steps_body = json.loads(body_s)
    check(code_s == 200 and steps_body["records"], "/debug/steps served "
          "the step records")
    flight_lines = body_f.splitlines()
    check(code_f == 200 and json.loads(flight_lines[0])["kind"] == "meta"
          and len(flight_lines) > 1, "/debug/flight served the ring")
    # a forced dump read back by the analyzer
    dump_dir = os.path.join(work, "flight")
    path = recorder.dump("ondemand", directory=dump_dir, force=True)
    check(path is not None, "flight.dump('ondemand') wrote a file")
    events, metas, marks = analyze.load_dir(dump_dir)
    report = analyze.analyze(events, metas, marks)
    check(report["ranks"] == [0] and metas[0]["reason"] == "ondemand"
          and not report["desync"]["global"]["desynced"],
          f"the analyzer read the dump: {report['desync']}")
    att_mean = {c: statistics.mean(r["attribution"][c] for r in recs)
                for c in sorted(cats)}
    wall_mean = statistics.mean(r["wall_s"] for r in recs)
    device_ms_bucket = 1e3 * device_s / max(device_buckets, 1)
    host_coll_ms = 1e3 * att_mean["collective"]
    buckets_step = sum(b["buckets"] for b in blocks) / steps_armed
    emit({"phase": "observe", "model": "GPT-2 small", "params": sum(
        p.numel() for p in model.parameters()), "batch": GPT_BATCH,
        "seq": GPT_SEQ, "dtype": "bfloat16",
        "optimizer": ADAMW.format(lr=1e-4),
        "rounds": OBSERVE_ROUNDS, "block_steps": OBSERVE_BLOCK_STEPS,
        "tokens_per_sec": {k: v for k, v in tps.items()},
        "tokens_per_sec_median": {k: statistics.median(v)
                                  for k, v in tps.items()},
        "armed_note": "armed: the armed blocks without the capture; "
                      "armed_capture: the last, whose last "
                      f"{OBSERVE_CAPTURE_STEPS} steps ran under "
                      "torch.profiler",
        "armed_over_disarmed": statistics.median(tps["armed"])
        / statistics.median(tps["disarmed"]),
        "step_wall_ms_mean": 1e3 * wall_mean,
        "attribution_ms_mean": {k: 1e3 * v for k, v in att_mean.items()},
        "attribution_share": {k: v / wall_mean for k, v in att_mean.items()},
        "buckets_per_step": buckets_step,
        "device_collective_ms_per_bucket": device_ms_bucket,
        "device_collective_ms_per_step": 1e3 * device_s / steps_armed,
        "host_collective_ms_per_step": host_coll_ms,
        "device_buckets_read": device_buckets,
        "flops_per_step": flops, "flops_counted": counted,
        "flops_attention_added": attn, "mfu": {
            "mean": statistics.mean(mfus), "min": min(mfus),
            "max": max(mfus)},
        "peak": roofline.chip_peaks(),
        "goodput": {"worst_conservation_error": worst,
                    "last": snaps[-1]},
        "flight": {"dispatches": len(seqs),
                   "dump": os.path.basename(path),
                   "analyzer_steps_marked":
                       report["steps"]["0"]["steps_marked"]},
        "timeline_spans_per_block": [b["buckets"] for b in blocks],
        "timeline_execute_spans_per_block": [b["execute"] for b in blocks],
        "capture": {"dir": os.path.basename(capture_dir),
                    "kernels": list(OBSERVE_KERNELS)},
        "launches": launches, "flash_max_abs_err": flash_err,
        "card": card})
    return launches


# ---------------------------------------------------------------------------
# A16's second half and A17's first half: the cluster telemetry plane and
# the control plane it rides (chaos, the stall inspector), in this process
# ---------------------------------------------------------------------------

CLUSTER_STEPS = 8              # steps of a chaos run, the step clock 0..7
CLUSTER_DELAY = (3, 200.0)     # (step, ms): a delay on fusion.flush
CLUSTER_HANG = (6, 7.0)        # (step, s): a hang on fusion.flush
CLUSTER_STALL_S = 1.0          # HOROVOD_STALL_CHECK_TIME_SECONDS in the runs
CLUSTER_ROUNDS, CLUSTER_BLOCK_STEPS = 4, 4   # disarmed / armed-idle blocks
CLUSTER_FLEET = (4, 2)         # telemetry agents, slices
CLUSTER_TIMED = 20             # calls timed of digest.collect and tick
# A plan armed whose triggers never fire: every flush and dispatch still
# evaluates them.
CLUSTER_IDLE_PLAN = {"seed": 0, "faults": [
    {"site": "fusion.flush", "kind": "delay", "at_step": [10 ** 9]},
    {"site": "collective.dispatch", "kind": "delay", "at": [10 ** 12]}]}


def cluster_plan(seed):
    """The cluster phase's JSON chaos plan: two faults on fusion.flush."""
    return {"seed": seed, "note": "chip_smoke cluster", "faults": [
        {"site": "fusion.flush", "kind": "delay",
         "at_step": [CLUSTER_DELAY[0]], "delay_ms": CLUSTER_DELAY[1]},
        {"site": "fusion.flush", "kind": "hang",
         "at_step": [CLUSTER_HANG[0]], "hang_s": CLUSTER_HANG[1]}]}


def flight_reasons(directory):
    """{dump file: its meta line's reason} of a flight directory."""
    out = {}
    for p in sorted(pathlib.Path(directory).glob("flight_*.jsonl")):
        with open(p) as f:
            out[p.name] = json.loads(f.readline()).get("reason")
    return out


def phase_cluster(torch, hvd, dev, args, card):
    """The cluster telemetry plane and the control plane on GPT-2 small at
    full width (train_gpt's settings: 8 x 1024, bf16, flash, AdamW in
    hvd.DistributedOptimizer, fused buckets), in this process.

    Chaos: a JSON plan (cluster_plan) armed as a worker arms one
    (HOROVOD_CHAOS_PLAN, _SEED, _LEDGER; install_from_env), a delay of
    CLUSTER_DELAY on the first fusion flush of step 3 and a hang of
    CLUSTER_HANG at step 6, over CLUSTER_STEPS steps on a runtime whose
    stall inspector warns after CLUSTER_STALL_S; run twice. Checks: exactly
    the two planned ledger lines, the same schedule both runs; each
    injection counted in chaos_injections_total; step 3's wall 200 ms above
    the median step (less the other steps' spread) and its step record's
    fusion time at least 200 ms; step 6 at least the hang; one
    stall_events_total{kind="warning"} a run, each with its flight dump;
    the loss finite and falling. Then CLUSTER_ROUNDS rounds of a disarmed
    block and a block with CLUSTER_IDLE_PLAN armed (triggers that never
    fire), tokens/s each.

    Telemetry: CLUSTER_FLEET agents over one in-process KVStoreServer in two
    slices on a fake clock, each beaconing this process's real digest.
    Checks: all healthy; after the slice-1 leader stops ticking it is dead,
    its slice re-elects a leader and the job view logs the transition;
    /cluster/health, /cluster/steps and /cluster/metrics through the scrape
    endpoint and hvd.cluster_snapshot() agree with the agent; top.gate
    passes the healthy view and refuses it stale. Reported: host ms of one
    digest.collect and one tick, the step profiler's attribution of step
    3, tokens/s disarmed against armed-idle. Returns the path's launch
    counts (the chaos runs and the blocks)."""
    import tempfile

    import torch.nn.functional as F

    from horovod_tpu_torch.chaos import ChaosPlan, injector
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.metrics import instruments
    from horovod_tpu_torch.metrics import server as msrv
    from horovod_tpu_torch.ops import fusion
    from horovod_tpu_torch.ops.kernels import flash_attention as fa
    from horovod_tpu_torch.ops.kernels import scale_buffers as sb
    from horovod_tpu_torch.profile import ledger
    from horovod_tpu_torch.runner.http_kv import KVStoreServer
    from horovod_tpu_torch.telemetry import aggregator, digest, top

    work = pathlib.Path(tempfile.mkdtemp(prefix="hvd_cluster_"))
    keys = ("HOROVOD_FLIGHT_DIR", "HOROVOD_CHAOS_PLAN", "HOROVOD_CHAOS_SEED",
            "HOROVOD_CHAOS_LEDGER")
    saved = {k: os.environ.get(k) for k in keys}
    cfg = basics._get_state().config
    stall0 = cfg.stall_check_time_seconds
    arm_planes(True)
    model = build_gpt(torch, dev, args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 4)
    ids = torch.randint(0, model.config.vocab_size, (GPT_BATCH, GPT_SEQ),
                        generator=gen, device=dev)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=1e-4),
        named_parameters=model.named_parameters())
    marks = [190000]

    def mark():
        marks[0] += 1
        hvd.step_marker(marks[0])
        return marks[0]

    def step():
        opt.zero_grad()
        value = next_token_loss(F, model(ids), ids)
        value.backward()
        opt.step()
        return value.detach()

    plan = cluster_plan(args.seed)
    sites = [(f["site"], f["kind"]) for f in plan["faults"]]

    def injections():
        return [instruments.CHAOS_INJECTIONS.labels(*s).get() for s in sites]

    def warnings():
        return instruments.STALL_EVENTS.labels("warning").get()

    def chaos_run(n):
        ledger_dir = work / f"ledger_{n}"
        os.environ.update({"HOROVOD_CHAOS_PLAN": json.dumps(plan),
                           "HOROVOD_CHAOS_SEED": str(args.seed),
                           "HOROVOD_CHAOS_LEDGER": str(ledger_dir)})
        injector.install_from_env()
        check(injector.armed, "the JSON plan armed from the env")
        inj0, warn0 = injections(), warnings()
        dumps0 = set(flight_reasons(work / "flight"))
        ledger.reset_window()
        epoch = ledger.get()._epoch
        mark()
        walls, losses, steps_of = [], [], []
        for i in range(CLUSTER_STEPS):
            injector.set_step(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(step())
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            steps_of.append(mark())
        injector.uninstall()
        entries = injector.read_ledger(str(ledger_dir))
        recs = {r["step"]: r for r in ledger.get().records()
                if r["epoch"] == epoch}
        dumps = {k: v for k, v in flight_reasons(work / "flight").items()
                 if k not in dumps0}
        return {"walls": walls, "losses": [v.item() for v in losses],
                "entries": entries,
                "schedule": injector.ledger_schedule(entries),
                "injections": [b - a for a, b in zip(inj0, injections())],
                "warnings": warnings() - warn0, "dumps": dumps,
                "records": [recs.get(s) for s in steps_of]}

    os.environ["HOROVOD_FLIGHT_DIR"] = str(work / "flight")
    try:
        step()                                 # warm-up, on the old runtime
        mark()
        cfg.stall_check_time_seconds = CLUSTER_STALL_S
        fusion.reset_runtime()                 # a runtime with the 1 s check
        check(fusion.get_runtime()._stall_inspector.warning_secs
              == CLUSTER_STALL_S, "the runtime's stall inspector at 1 s")
        step()
        torch.cuda.synchronize()
        fa.reset_launch_counts()               # the path starts here
        sb.reset_launch_counts()
        runs = [chaos_run(n) for n in range(2)]
        tokens = GPT_BATCH * GPT_SEQ * CLUSTER_BLOCK_STEPS
        tps = {"disarmed": [], "armed_idle": []}
        idle_calls = 0
        for _ in range(CLUSTER_ROUNDS):
            for armed in (False, True):
                if armed:
                    injector.install(ChaosPlan.from_dict(CLUSTER_IDLE_PLAN))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(CLUSTER_BLOCK_STEPS):
                    step()
                    mark()
                torch.cuda.synchronize()
                elapsed = time.perf_counter() - t0
                if armed:
                    st = injector.stats()
                    check(not st["fires"], f"the idle plan fired nothing: "
                          f"{st}")
                    idle_calls += sum(st["sites"].values())
                    injector.uninstall()
                tps["armed_idle" if armed else "disarmed"].append(
                    tokens / elapsed)
        launches = {"flash_fwd": fa.fwd_launches,
                    "flash_bwd_dq": fa.bwd_dq_launches,
                    "flash_bwd_dkv": fa.bwd_dkv_launches,
                    "scale_pack": sb.pack_launches,
                    "scale_unpack": sb.unpack_launches}   # the path ends
    finally:
        injector.uninstall()
        cfg.stall_check_time_seconds = stall0
        fusion.reset_runtime()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    n_steps = 2 * (CLUSTER_STEPS) + 2 * CLUSTER_ROUNDS * CLUSTER_BLOCK_STEPS
    check(all(launches[k] == model.config.num_layers * n_steps
              for k in FLASH_COUNTS) and launches["scale_pack"] > 0
          and launches["scale_pack"] == launches["scale_unpack"],
          f"cluster: {model.config.num_layers} launches of each flash "
          f"kernel a step and both scale kernels: {launches}")
    d_step, d_ms = CLUSTER_DELAY
    h_step, h_s = CLUSTER_HANG
    want = [("worker", 0, "fusion.flush", "delay", 0, 0, d_step, None),
            ("worker", 0, "fusion.flush", "hang", 1, 0, h_step, None)]
    for n, r in enumerate(runs):
        check(r["schedule"] == want, f"run {n}: exactly the planned ledger "
              f"lines: {r['entries']}")
        check(r["injections"] == [1, 1], f"run {n}: chaos_injections_total "
              f"counted each: {r['injections']}")
        walls = r["walls"]
        others = [w for i, w in enumerate(walls) if i not in (d_step, h_step)]
        med = statistics.median(walls)
        spread = max(others) - min(others)
        r["step3_over_median_s"] = walls[d_step] - med
        check(walls[d_step] - med >= d_ms / 1e3 - spread,
              f"run {n}: step {d_step} {walls[d_step]:.3f} s, {d_ms} ms "
              f"over the median {med:.3f} s (the others' spread "
              f"{spread:.3f} s)")
        rec = r["records"][d_step]
        check(rec is not None and rec["attribution"]["fusion"]
              >= d_ms / 1e3, f"run {n}: step {d_step}'s record books the "
              f"delay under fusion: {rec and rec['attribution']}")
        check(walls[h_step] >= h_s, f"run {n}: step {h_step} took the hang "
              f"({walls[h_step]:.2f} s)")
        check(r["warnings"] == 1 and list(r["dumps"].values())
              == ["stall_warning"], f"run {n}: one stall warning with its "
              f"flight dump: {r['warnings']}, {r['dumps']}")
        losses = r["losses"]
        check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
              f"run {n}: finite, falling loss {losses}")
    check(runs[0]["schedule"] == runs[1]["schedule"],
          "the same plan and seed give the same ledger schedule")

    # --- the telemetry plane: a fleet over one in-process KV store ---------
    world, slices = CLUSTER_FLEET
    kv = KVStoreServer(secret="")
    clock = [time.time()]
    agents = [aggregator.TelemetryAgent(
        kv, rank=r, world=world, num_slices=slices, interval=1.0, gen="0",
        include_metrics=True, time_fn=lambda: clock[0])
        for r in range(world)]
    port = msrv.start_http_server(0, addr="127.0.0.1")
    try:
        for _ in range(3):
            clock[0] += 1.0
            for a in agents:
                a.tick()
        healthy = agents[0].job_view()
        check(healthy is not None and healthy["counts"]["healthy"] == world
              and healthy["leader"] == 0, f"all {world} ranks healthy: "
              f"{healthy and healthy['counts']}")
        check(top.gate(healthy, now=clock[0])
              and not top.gate(healthy, now=clock[0] + 60),
              "top.gate passes the healthy view and refuses it stale")
        victim = agents[0].members[-1] + 1        # slice 1's leader
        for _ in range(5):
            clock[0] += 1.0
            for a in agents:
                if a.rank != victim:
                    a.tick()
        view = agents[0].job_view()
        s1 = view["slices"]["1"]
        events = [e for e in view["events"]
                  if e["rank"] == victim and e["to"] == "dead"]
        check(view["health"][str(victim)]["state"] == "dead"
              and s1["leader"] == victim + 1 and events
              and not top.gate(view, now=clock[0]),
              f"rank {victim} dead, slice 1 re-led, the transition logged: "
              f"{view['health']}, {s1}, {view['events']}")
        aggregator.set_agent(agents[0])
        code_h, body_h = http_get(port, "/cluster/health")
        code_s, body_s = http_get(port, "/cluster/steps")
        code_m, body_m = http_get(port, "/cluster/metrics")
        check(code_h == 200 and json.loads(body_h) == agents[0].job_view()
              == hvd.cluster_snapshot(), "/cluster/health and "
              "hvd.cluster_snapshot() serve the agent's view")
        check(code_s == 200 and json.loads(body_s)
              == aggregator.cluster_steps(), "/cluster/steps")
        check(code_m == 200 and body_m == aggregator.cluster_metrics_text()
              and 'slice="0"' in body_m and 'slice="1"' in body_m,
              "/cluster/metrics: each slice's merged series")
        collect_ms = []
        for _ in range(CLUSTER_TIMED):
            t0 = time.perf_counter()
            digest.collect(rank=0)
            collect_ms.append(1e3 * (time.perf_counter() - t0))
        tick_ms = []
        for _ in range(CLUSTER_TIMED):
            t0 = time.perf_counter()
            agents[0].tick()
            tick_ms.append(1e3 * (time.perf_counter() - t0))
        beacon = digest.collect(rank=0)
    finally:
        aggregator.set_agent(None)
        msrv.stop_http_server()
        kv.stop()
    att = runs[0]["records"][d_step]["attribution"]
    emit({"phase": "cluster", "model": "GPT-2 small", "batch": GPT_BATCH,
          "seq": GPT_SEQ, "dtype": "bfloat16",
          "optimizer": ADAMW.format(lr=1e-4), "plan": plan,
          "stall_check_time_seconds": CLUSTER_STALL_S,
          "runs": [{"step_wall_s": r["walls"], "losses": r["losses"],
                    "step3_over_median_s": r["step3_over_median_s"],
                    "schedule": r["schedule"], "stall_warnings": r["warnings"],
                    "stall_dumps": sorted(r["dumps"])} for r in runs],
          "step3_attribution_ms": {k: 1e3 * v for k, v in att.items()},
          "tokens_per_sec": tps,
          "tokens_per_sec_median": {k: statistics.median(v)
                                    for k, v in tps.items()},
          "armed_idle_over_disarmed": statistics.median(tps["armed_idle"])
          / statistics.median(tps["disarmed"]),
          "idle_plan_site_calls": idle_calls,
          "telemetry": {"world": world, "slices": slices,
                        "digest_collect_ms": statistics.median(collect_ms),
                        "tick_ms": statistics.median(tick_ms),
                        "tick_ms_max": max(tick_ms),
                        "digest_bytes": len(json.dumps(beacon)),
                        "leader_counters": agents[0].counters,
                        "dead_after_s": agents[0].thresholds["dead_after"],
                        "healthy_counts": healthy["counts"],
                        "after_death": view["counts"],
                        "events": view["events"]},
          "launches": launches, "card": card})
    return launches


# A17's second half: the tuners on GPT-2 small's path.
AUTOTUNE_DETUNED = 1 << 20      # bytes: the detuned runtime's threshold
AUTOTUNE_ENV = {"HOROVOD_FUSION_THRESHOLD": str(AUTOTUNE_DETUNED),
                "HOROVOD_AUTOTUNE": "1",
                "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "1",
                "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": "2",
                "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": "6"}
AUTOTUNE_A_STEPS = 6
AUTOPILOT_ENV = {"HOROVOD_FUSION_THRESHOLD": str(AUTOTUNE_DETUNED),
                 "HOROVOD_AUTOTUNE": "1",
                 "HOROVOD_AUTOPILOT": "1",
                 "HOROVOD_AUTOPILOT_INTERVAL": "0.5",
                 "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": "6",
                 # The ring holds every decision of a run (~300 events a
                 # step at 1 MB); each tick's local view copies it.
                 "HOROVOD_FLIGHT_CAPACITY": "32768"}
AUTOPILOT_MAX_STEPS = 200
AUTOPILOT_TAIL_STEPS = 6
AUTOTUNE_UNTUNED_STEPS = 6
AUTOTUNE_RATE_STEPS = 4         # steps timed for an epoch's tokens/s
SOAK_PROCS = 3


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def is_pack(name):
    """Whether a scale_copy_kernel launch is a pack (its kPack template
    argument), or None when the name carries no template arguments."""
    if "<" not in name:
        return None
    return name[name.find("<") + 1:name.rfind(">")].split(",")[-1].strip() \
        in ("true", "1")


def profiled_packs(torch, step):
    """One ``step`` under torch.profiler: the scale_copy_kernel pack
    launches by kernel name (half of them when the names carry no template
    arguments), and the wrapper's count over the same step."""
    from horovod_tpu_torch.ops.kernels import scale_buffers as sb
    p0 = sb.pack_launches
    device, _ = device_events(torch, step, 1)
    names = [e.name for e in device if "scale_copy_kernel" in e.name]
    flags = [is_pack(n) for n in names]
    packs = sum(1 for f in flags if f) if any(f is not None for f in flags) \
        else len(names) // 2
    return packs, sb.pack_launches - p0


def phase_autotune(torch, hvd, dev, args, card):
    """The flush-window autotuner and the autopilot on GPT-2 small (see
    the module docstring, phase 46). Returns the phase's launch counts."""
    import logging
    import tempfile

    import torch.nn.functional as F

    from horovod_tpu_torch.autopilot import controller as apc
    from horovod_tpu_torch.common import logging as hvd_logging
    from horovod_tpu_torch.flight import analyze as flight_analyze
    from horovod_tpu_torch.flight import recorder
    from horovod_tpu_torch.ops import fusion
    from horovod_tpu_torch.ops.kernels import flash_attention as fa
    from horovod_tpu_torch.ops.kernels import scale_buffers as sb
    from horovod_tpu_torch.sim.__main__ import main as sim_main

    work = pathlib.Path(tempfile.mkdtemp(prefix="hvd_autotune_"))
    prior = work / "prior.json"
    t0 = time.perf_counter()
    check(sim_main(["--pretrain", str(prior), "--world", "1", "--slices",
                    "1", "--chip", "h100"]) == 0 and prior.exists(),
          "the twin wrote the H100 prior")
    pretrain_s = time.perf_counter() - t0
    failed = []

    class Catch(logging.Handler):
        def emit(self, record):
            if "autopilot tick failed" in record.getMessage():
                failed.append(record.getMessage())

    catch = Catch()
    hvd_logging.get_logger().addHandler(catch)
    knob_keys = sorted(set(AUTOTUNE_ENV) | set(AUTOPILOT_ENV)
                       | {"HOROVOD_AUTOPILOT_PRIOR", "HOROVOD_METRICS_PORT"})
    saved = {k: os.environ.get(k) for k in knob_keys}

    def world(env):
        hvd.shutdown()
        for k in knob_keys:
            os.environ.pop(k, None)
        os.environ.update(env)
        hvd.init()
        check(hvd.device() == dev, f"the world runs on {dev}: "
              f"{hvd.device()}")

    model = build_gpt(torch, dev, args.seed)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    gen = torch.Generator(device=dev).manual_seed(args.seed + 20)
    ids = torch.randint(0, model.config.vocab_size, (GPT_BATCH, GPT_SEQ),
                        generator=gen, device=dev)
    tokens = GPT_BATCH * GPT_SEQ
    marks = [290000]
    fa.reset_launch_counts()              # the path starts here
    sb.reset_launch_counts()

    def make_opt():
        model.load_state_dict(init)
        return hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-4,
                              betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=1e-4),
            named_parameters=model.named_parameters())

    def step(opt):
        opt.zero_grad()
        value = next_token_loss(F, model(ids), ids)
        value.backward()
        opt.step()
        marks[0] += 1
        hvd.step_marker(marks[0])
        return value.detach()

    def timed(opt, n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses = [step(opt) for _ in range(n)]
        torch.cuda.synchronize()
        return tokens * n / (time.perf_counter() - t), losses

    def decisions_on_scrape(port):
        code, text = http_get(port, "/metrics")
        check(code == 200, f"/metrics answered {code}")
        return sum(float(line.rsplit(" ", 1)[1])
                   for line in text.splitlines()
                   if line.startswith("horovod_autopilot_decisions_total{"))

    report = {"prior": str(prior), "pretrain_s": pretrain_s,
              "prior_best": json.loads(prior.read_text())["best"]}
    try:
        # Leg A: the flush-window tuner alone.
        world(AUTOTUNE_ENV)
        check(apc.get_controller() is None, "no controller under autotune")
        rt = fusion.get_runtime()
        pm = rt._parameter_manager
        check(pm is not None, "process 0's runtime holds the tuner")
        start = (rt.threshold, rt._cycle_s * 1e3, rt.strategy)
        opt = make_opt()
        packs, knobs, losses = [], [], []
        for _ in range(AUTOTUNE_A_STEPS):
            p0 = sb.pack_launches
            losses.append(step(opt).item())
            packs.append(sb.pack_launches - p0)
            knobs.append((rt.threshold, round(rt._cycle_s * 1e3, 4),
                          rt.strategy))
        opt._remove_hooks()
        check(knobs[-1] != start, f"the tuner moved the knobs from {start}: "
              f"{knobs}")
        check(all(map(math.isfinite, losses)), f"finite losses {losses}")
        report["leg_a"] = {"start": start, "knobs_per_step": knobs,
                           "packs_per_step": packs, "frozen": not pm.tuning,
                           "samples": pm._samples,
                           "categoricals": pm.categoricals,
                           "losses": losses}

        # Leg B: the autopilot, with the twin's prior and cold.
        for label in ("prior", "cold"):
            mport = free_port()
            env = dict(AUTOPILOT_ENV, HOROVOD_METRICS_PORT=str(mport))
            if label == "prior":
                env["HOROVOD_AUTOPILOT_PRIOR"] = str(prior)
            world(env)
            ctrl = apc.get_controller()
            check(ctrl is not None and ctrl._thread is not None
                  and ctrl._thread.is_alive(),
                  "hvd.init armed the controller thread")
            # The first epoch's step at the detuned start, then the loop.
            ctrl.stop()
            rt = fusion.get_runtime()
            check(rt._parameter_manager is None and rt.threshold ==
                  AUTOTUNE_DETUNED, "the autopilot owns the knobs: no "
                  "flush-window tuner, the detuned threshold")
            opt = make_opt()
            step(opt)
            first_tps, _ = timed(opt, AUTOTUNE_RATE_STEPS)
            first_packs = profiled_packs(torch, lambda: step(opt))
            ticks = []
            inner = ctrl.tick

            def timed_tick(inner=inner, ticks=ticks):
                t = time.perf_counter()
                out = inner()
                ticks.append(1e3 * (time.perf_counter() - t))
                return out

            ctrl.tick = timed_tick
            scrape0 = decisions_on_scrape(mport)
            t_run = time.time()
            ctrl.start()
            check(ctrl._thread.is_alive(), "the controller thread runs")
            rows, tail = [], None
            for i in range(AUTOPILOT_MAX_STEPS):
                p0 = sb.pack_launches
                t = time.perf_counter()
                loss = step(opt)
                rows.append((ctrl.epoch, rt.threshold,
                             sb.pack_launches - p0))
                if tail is None and ctrl.frozen:
                    tail = i + AUTOPILOT_TAIL_STEPS
                if tail is not None and i >= tail:
                    break
            loss = loss.item()
            last_tps, _ = timed(opt, AUTOTUNE_RATE_STEPS)
            last_packs = profiled_packs(torch, lambda: step(opt))
            ctrl.stop()
            torch.cuda.synchronize()
            opt._remove_hooks()
            decisions = ctrl.decisions()
            outcomes = [(d["lever"], d["outcome"]) for d in decisions]
            tuner = [o for lv, o in outcomes if lv == "tuner"]
            check(not failed, f"no autopilot tick failed: {failed}")
            check(math.isfinite(loss), f"{label}: a finite loss {loss}")
            if label == "prior":
                check("prior_loaded" in tuner and any(
                    o in ("adopt", "hold")
                    for o in tuner[tuner.index("prior_loaded"):]),
                      f"prior: prior_loaded, then adopt/hold: {outcomes}")
            else:
                check("prior_loaded" not in tuner and any(
                    o in ("adopt", "hold") for o in tuner),
                      f"cold: adopt/hold records, no prior: {outcomes}")
            check(rt.threshold > AUTOTUNE_DETUNED,
                  f"{label}: the threshold rose from {AUTOTUNE_DETUNED}: "
                  f"{rt.threshold}")
            check(last_packs[0] < first_packs[0] and last_packs[1] <
                  first_packs[1] and first_packs[0] == first_packs[1],
                  f"{label}: fewer pack launches a step in the last epoch "
                  f"(profiler, wrapper) {last_packs} than in the first "
                  f"{first_packs}")
            on_scrape = decisions_on_scrape(mport) - scrape0
            ring = [e for e in recorder.get().events()
                    if (e.get("t") or 0.0) >= t_run]
            on_ring = flight_analyze.analyze_autopilot(ring)["decisions"]
            check(on_scrape == on_ring == len(decisions),
                  f"{label}: the scrape ({on_scrape}) and the ring "
                  f"({on_ring}) count the trail ({len(decisions)})")
            frozen = [d["epoch"] for d in decisions
                      if d["outcome"] == "frozen"]
            if label == "prior":
                check(frozen, f"prior: the controller froze: {outcomes}")
            report[label] = {
                "steps": len(rows), "epochs": ctrl.epoch,
                "epochs_to_freeze": frozen[0] if frozen else None,
                "tokens_per_sec_first_epoch": first_tps,
                "tokens_per_sec_last_epoch": last_tps,
                "scale_pack_per_step_first": {"profiler": first_packs[0],
                                              "wrapper": first_packs[1]},
                "scale_pack_per_step_last": {"profiler": last_packs[0],
                                             "wrapper": last_packs[1]},
                "final_knobs": {"threshold": rt.threshold,
                                "cycle_ms": rt._cycle_s * 1e3,
                                "strategy": rt.strategy,
                                "wire": rt.wire_dtype},
                "tick_host_ms": [round(t, 3) for t in ticks],
                "threshold_by_step": [r[1] for r in rows],
                "packs_by_step": [r[2] for r in rows],
                "outcomes": outcomes, "decisions_counted": on_scrape}
            hvd.shutdown()
            check(apc.get_controller() is None,
                  "hvd.shutdown() stopped the controller")
            hvd.init()
        # The untuned default (64 MB) for scale.
        world({})
        opt = make_opt()
        step(opt)
        report["untuned_64mb_tokens_per_sec"], _ = timed(
            opt, AUTOTUNE_UNTUNED_STEPS)
        opt._remove_hooks()
    finally:
        hvd_logging.get_logger().removeHandler(catch)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    launches = {"flash_fwd": fa.fwd_launches,
                "flash_bwd_dq": fa.bwd_dq_launches,
                "flash_bwd_dkv": fa.bwd_dkv_launches,
                "scale_pack": sb.pack_launches,
                "scale_unpack": sb.unpack_launches}
    check(all(p.device.type == "cuda" for p in model.parameters())
          and all(launches[k] > 0 for k in STEP_COUNTS),
          f"the tuned path ran on the card through every flash and scale "
          f"kernel: {launches}")
    emit({"phase": "autotune", **report, "launches": launches,
          "card": card})
    return launches


def phase_soak_cpu_world(args):
    """chaos/soak.py's run_soak and run_autopilot_soak at SOAK_PROCS CPU
    (gloo) processes on the elastic launcher (see the module docstring,
    phase 47); each run's invariants are asserted inside, and a failed
    worker fails the run."""
    import tempfile

    from horovod_tpu_torch.chaos import soak

    work = pathlib.Path(tempfile.mkdtemp(prefix="hvd_soak_"))
    t0 = time.perf_counter()
    ev = soak.run_soak(procs=SOAK_PROCS, steps=8, seed=123,
                       workdir=str(work / "soak"), reruns=1)
    soak_s = time.perf_counter() - t0
    chaos = ev["chaos_results"]
    check(ev["ledger_deterministic"] and ev["kill_budget"] == 1
          and all(r["final_world"] == SOAK_PROCS - 1 for r in chaos)
          and all(r["resets"] <= 1 for r in chaos),
          f"run_soak: one shrink, resets within the budget, the same "
          f"schedule on the rerun: {chaos}")
    t0 = time.perf_counter()
    ap = soak.run_autopilot_soak(procs=SOAK_PROCS,
                                 workdir=str(work / "autopilot"))
    ap_s = time.perf_counter() - t0
    rem = ap["remediations"][0]
    victim = SOAK_PROCS - 1
    check(rem["rank"] == victim and rem["cause"] == "straggler"
          and rem["host"] == f"127.0.0.{victim + 1}"
          and all(r["final_world"] == victim for r in ap["results"]),
          f"run_autopilot_soak: rank {victim}'s host removed for "
          f"straggling, the survivors at world {victim}: {ap['remediations']}")
    emit({"phase": "soak_cpu_world", "run_on": "CPU (gloo), not the card",
          "run_soak": {"seconds": soak_s, "clean_w": ev["clean_w"],
                       "kill_budget": ev["kill_budget"],
                       "ledger": ev["ledger"],
                       "final_worlds": [r["final_world"] for r in chaos],
                       "resets": [r["resets"] for r in chaos],
                       "killed_ranks": ev["flight_report"]["killed_ranks"]},
          "run_autopilot_soak": {"seconds": ap_s, "remediation": rem,
                                 "worlds": [r["worlds"]
                                            for r in ap["results"]]}})


class PhaseRunner:
    """``run(name, fn, *args)`` calls one phase and returns what it returns.
    Each phase's peak is its own: what earlier phases left is collected and
    the peak statistics reset first, and what is still allocated is
    recorded in ``start_gb`` (with the largest tensors the collector sees,
    where a phase that builds its own models starts holding too much). A
    phase's exception propagates, after the starts so far are printed."""

    def __init__(self, torch):
        self.torch, self.seconds, self.start_gb = torch, {}, {}

    def __call__(self, name, fn, *args):
        torch = self.torch
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        gb = self.start_gb[name] = torch.cuda.memory_allocated() / 1e9
        if name in OWN_MODEL_PHASES and gb >= OWN_MODEL_START_GB:
            emit({"phase": f"{name}_starts_holding", "allocated_gb": gb,
                  "largest_visible_tensors": held_tensors(torch)})
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except BaseException:
            emit({"phase": "allocated_gb_at_phase_start", **self.start_gb})
            raise
        self.seconds[name] = time.perf_counter() - t0
        return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--launched-worker",
                    choices=("gpt", "fail", "cpu_world", "elastic",
                             "elastic_cpu", "hier_cpu"),
                    help="run as a worker that hvdrun-torch started (the "
                         "launch phases)")
    ap.add_argument("--elastic-scenario", choices=ELASTIC_CPU_SCENARIOS,
                    help="--launched-worker elastic_cpu's scenario")
    ap.add_argument("--discovery-script",
                    help="--launched-worker elastic_cpu's discovery script, "
                         "which the scenario rewrites")
    args = ap.parse_args(argv)
    check(args.warmup >= 1 and args.steps >= 1, "--warmup and --steps >= 1")
    if args.launched_worker:
        return launched_worker(args)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run",
              file=sys.stderr)
        return 1
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import ResNet50

    dev = torch.device("cuda", 0)
    torch.backends.cudnn.benchmark = True
    run = PhaseRunner(torch)
    seconds, start_gb = run.seconds, run.start_gb

    def resnet50():
        m = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                     generator=torch.Generator().manual_seed(args.seed))
        return m.to(dev).train()

    card = run("env", phase_env, torch)
    run("build", phase_build)
    model = resnet50()
    gpt = build_gpt(torch, dev, args.seed)
    shapes = {name: [tuple(p.shape) for p in m.parameters()]
              for name, m in (("resnet50", model), ("gpt2_small", gpt))}
    shapes.update(path_shapes(torch))
    max_err = run("kernel_vs_plain", phase_kernel_vs_plain, torch, shapes,
                  dev, args.seed)
    launches, buckets = run("train", phase_train, torch, hvd, model, dev,
                            args, card)
    check(launches["scale_pack"] > 0 and launches["scale_unpack"] > 0,
          f"the main path launched both kernels: {launches}")
    total = run("timing", phase_timing, torch, buckets, dev, args.seed)
    del model
    flash_err, path_err = run("flash_vs_plain", phase_flash_vs_plain, torch,
                              dev, args.seed)
    gpt, ids, gpt_launches = run("train_gpt", phase_train_gpt, torch, hvd,
                                 gpt, dev, args, card)
    check(all(gpt_launches[k] > 0 for k in FLASH_REPLACES),
          f"the GPT path launched every flash kernel: {gpt_launches}")
    run("gpt_flash_vs_plain", phase_flash_vs_plain_model, torch, gpt, ids,
        dev)
    del gpt
    run("precision", phase_precision, torch, dev, args.seed)
    bert, batch, bert_launches = run("train_bert", phase_train_bert, torch,
                                     hvd, dev, args, card)
    run("bert_flash_vs_plain", phase_bert_flash_vs_plain, torch, bert, batch,
        dev)
    del bert, batch
    gc.collect()
    llama_state, ids, llama_launches = run("train_llama", phase_train_llama,
                                           torch, hvd, dev, args, card)
    run("llama_flash_vs_plain", phase_llama_flash_vs_plain, torch,
        llama_state, ids, dev)
    del llama_state, ids
    gc.collect()
    vit_state, vit_batch, vit_launches = run("train_vit", phase_train_vit,
                                             torch, hvd, dev, args, card)
    run("vit_flash_vs_plain", phase_vit_flash_vs_plain, torch, vit_state,
        vit_batch, dev)
    del vit_state, vit_batch
    gc.collect()
    coll_launches = run("collectives", phase_collectives, torch, hvd, dev)
    check(coll_launches["scale_pack"] > 0 and coll_launches["scale_unpack"]
          > 0, f"the collectives path launched both scale kernels: "
          f"{coll_launches}")
    launch_launches = run("launch", phase_launch, torch, args, card)
    run("launch_cpu_world", phase_launch_cpu_world, args)
    by_path = {"train_gpt": gpt_launches, "train_bert": bert_launches,
               "train_llama": llama_launches, "train_vit": vit_launches,
               "launch": launch_launches}
    check(all(n[k] > 0 for n in by_path.values() for k in STEP_COUNTS),
          f"every transformer path launched every flash and scale kernel: "
          f"{by_path}")
    flash_rows, flash_paths = run("timing_flash", phase_timing_flash, torch,
                                  dev, args.seed)
    adasum_err = run("adasum_vs_plain", phase_adasum_vs_plain, torch,
                     shapes["resnet50"], dev, args.seed)
    model = resnet50()
    ada_launches, ada_buckets = run("train_adasum", phase_train_adasum,
                                    torch, hvd, model, dev, args, card)
    check(ada_launches["scale_pack"] > 0 and ada_launches["scale_unpack"] > 0
          and ada_launches["adasum_combine"] == 0,
          f"the Adasum path launched both scale kernels and, on one rank, "
          f"no combine: {ada_launches}")
    gathered_launches, gathered_err = run(
        "adasum_gathered", phase_adasum_gathered, torch, model, ada_buckets,
        dev, args)
    check(gathered_launches > 0, "reduce_gathered launched the combine")
    ada_total = run("timing_adasum", phase_timing_adasum, torch, ada_buckets,
                    dev, args.seed)
    del model
    gc.collect()
    wire_mixed, wire_err = run("wire_vs_cpu", phase_wire_vs_cpu, torch,
                               buckets, shapes["resnet50"], dev, args.seed)
    wire_launches = run("train_wire", phase_train_wire, torch, hvd, dev, args,
                        card, resnet50)
    syncbn_launches = run("train_syncbn", phase_train_syncbn, torch, hvd,
                          dev, args, card, resnet50)
    gc.collect()
    chunked_launches = run("train_gpt_chunked", phase_train_gpt_chunked,
                           torch, hvd, dev, args, card)
    gc.collect()
    powersgd_launches = run("train_powersgd", phase_train_powersgd, torch,
                            hvd, dev, args, card)
    gc.collect()
    tp_sp_launches = run("train_gpt_tp_sp", phase_train_gpt_tp_sp, torch,
                         hvd, dev, args, card, READINGS.get("train_gpt", {}))
    gc.collect()
    ring_launches = run("ring_flash", phase_ring_flash, torch, dev,
                        args.seed, card)
    gc.collect()
    zero_launches, fsdp_launches = run("train_zero_fsdp",
                                       phase_train_zero_fsdp, torch, hvd,
                                       dev, args, card)
    gc.collect()
    moe_launches = run("train_gpt_moe", phase_train_gpt_moe, torch, hvd,
                       dev, args, card)
    gc.collect()
    composite_launches = run("train_composite", phase_train_composite,
                             torch, dev, args, card)
    gc.collect()
    virtual_launches = run("pipeline_virtual", phase_pipeline_virtual,
                           torch, dev, args, card)
    t5_launches = run("train_t5", phase_train_t5, torch, hvd, dev, args,
                      card)
    vgg_launches = run("train_vgg16", phase_train_image, torch, hvd, dev,
                       args, card, "vgg16")
    inception_launches = run("train_inception3", phase_train_image, torch,
                             hvd, dev, args, card, "inception3")
    lora_launches = run("train_lora", phase_train_lora, torch, hvd, dev,
                        args, card)
    generate_launches = run("generate", phase_generate, torch, dev, args,
                            card)
    gc.collect()
    cached_launches = run("generate_cached", phase_generate_cached, torch,
                          dev, args, card)
    gc.collect()
    serve_launches = run("serve", phase_serve, torch, dev, args, card)
    gc.collect()
    run("launch_serving", phase_launch_serving, torch, args, card)
    gc.collect()
    observe_launches = run("observe", phase_observe, torch, hvd, dev, args,
                           card)
    gc.collect()
    cluster_launches = run("cluster", phase_cluster, torch, hvd, dev, args,
                           card)
    gc.collect()
    hier_launches = run("train_hierarchical", phase_train_hierarchical,
                        torch, hvd, dev, args, card, resnet50)
    run("hier_cpu_world", phase_hier_cpu_world, args)
    gc.collect()
    run("cycle", phase_cycle, torch, hvd, dev, args, card)
    elastic_launches = run("train_elastic", phase_train_elastic, torch, hvd,
                           dev, args, card)
    launch_elastic_launches = run("launch_elastic", phase_launch_elastic,
                                  torch, args, card)
    run("launch_elastic_cpu_world", phase_launch_elastic_cpu_world, args)
    gc.collect()
    autotune_launches = run("autotune", phase_autotune, torch, hvd, dev,
                            args, card)
    run("soak_cpu_world", phase_soak_cpu_world, args)
    hvd.shutdown()
    emit({"phase": "seconds", **seconds})
    emit({"phase": "allocated_gb_at_phase_start", **start_gb})
    check(all(start_gb[p] < OWN_MODEL_START_GB for p in OWN_MODEL_PHASES),
          f"the phases that build their own models start with less than "
          f"{OWN_MODEL_START_GB} GB allocated: {start_gb}")
    source = "horovod_tpu_torch/ops/kernels/csrc/scale_buffers.cu"
    transformer_paths = ("train_gpt", "train_bert", "train_llama",
                         "train_vit", "launch", "train_gpt_chunked",
                         "train_powersgd", "train_gpt_tp_sp", "ring_flash",
                         "train_zero", "train_fsdp", "train_gpt_moe",
                         "train_composite", "pipeline_virtual", "train_lora",
                         "generate", "observe", "cluster", "autotune")
    replaces = "horovod_tpu/ops/pallas/kernels.py:43"
    by_path.update(train=launches, train_adasum=ada_launches,
                   collectives=coll_launches, train_elastic=elastic_launches,
                   launch_elastic=launch_elastic_launches,
                   train_wire=wire_launches, train_syncbn=syncbn_launches,
                   train_gpt_chunked=chunked_launches,
                   train_powersgd=powersgd_launches,
                   train_hierarchical=hier_launches,
                   train_gpt_tp_sp=tp_sp_launches, ring_flash=ring_launches,
                   train_zero=zero_launches, train_fsdp=fsdp_launches,
                   train_gpt_moe=moe_launches,
                   train_composite=composite_launches,
                   pipeline_virtual=virtual_launches,
                   train_t5=t5_launches, train_vgg16=vgg_launches,
                   train_inception3=inception_launches,
                   train_lora=lora_launches, generate=generate_launches,
                   observe=observe_launches, cluster=cluster_launches,
                   autotune=autotune_launches)
    scale_paths = ("train", "train_gpt", "train_bert", "train_llama",
                   "train_vit", "launch", "train_adasum", "collectives",
                   "train_elastic", "launch_elastic", "train_wire",
                   "train_syncbn", "train_gpt_chunked", "train_powersgd",
                   "train_hierarchical", "train_gpt_tp_sp", "train_gpt_moe",
                   "train_t5", "train_vgg16", "train_inception3",
                   "train_lora", "observe", "cluster", "autotune")
    check(all(by_path[p][k] > 0 for p in ("train_wire", "train_syncbn",
                                          "train_hierarchical")
              for k in ("scale_pack", "scale_unpack")),
          f"the wire, SyncBatchNorm and tier paths launched both scale "
          f"kernels: {wire_launches}, {syncbn_launches}, {hier_launches}")
    check(all(by_path[p][k] > 0 for p in ("train_zero", "train_fsdp",
                                          "ring_flash", "train_composite",
                                          "pipeline_virtual")
              for k in FLASH_COUNTS),
          f"the ZeRO, FSDP, ring, composite and virtual-pipeline paths "
          f"launched every flash kernel: {zero_launches}, {fsdp_launches}, "
          f"{ring_launches}, {composite_launches}, {virtual_launches}")
    check(all(by_path[p][k] > 0 for p in ("train_gpt_chunked",
                                          "train_powersgd",
                                          "train_gpt_tp_sp", "train_gpt_moe")
              for k in STEP_COUNTS),
          f"the chunked-loss, PowerSGD, mesh and MoE paths launched every "
          f"flash and scale kernel: {chunked_launches}, "
          f"{powersgd_launches}, {tp_sp_launches}, {moe_launches}")
    check(all(by_path[p][k] > 0 for p in ("train_t5", "train_vgg16",
                                          "train_inception3", "train_lora")
              for k in ("scale_pack", "scale_unpack")),
          f"the T5, VGG-16, Inception V3 and LoRA paths launched both scale "
          f"kernels: {t5_launches}, {vgg_launches}, {inception_launches}, "
          f"{lora_launches}")
    check(all(lora_launches[k] > 0 for k in FLASH_COUNTS)
          and generate_launches["flash_fwd"] > 0,
          f"the LoRA path launched every flash kernel and generate the "
          f"forward: {lora_launches}, {generate_launches}")
    kernels = [
        {"name": f"scale_{kind}", "route": "cuda", "source": source,
         "replaces": replaces,
         "launches": sum(by_path[p][f"scale_{kind}"] for p in scale_paths),
         "launches_by_path": {**{p: by_path[p][f"scale_{kind}"]
                                 for p in scale_paths},
                              "serve": serve_launches[f"scale_{kind}"]},
         "checked_vs_plain": True, "max_abs_err": max(max_err, wire_err),
         "ms": total[f"{kind}_ms"],
         "wrapper_ms": total[f"{kind}_wrapper_ms"],
         "plain_ms": total[f"{kind}_plain_ms"],
         "bound_ms": total["bound_ms"], "bound_by": "bytes",
         "library_ms": total[f"{kind}_library_ms"],
         "mixed_dtype": {pair: {"ms": r[f"{kind}_ms"],
                                "plain_ms": r[f"{kind}_plain_ms"],
                                "bound_ms": r["bound_ms"],
                                "library_ms": r[f"{kind}_library_ms"]}
                         for pair, r in wire_mixed.items()},
         "times_note": "ms, plain_ms, bound_ms and library_ms: the fp32 "
                       "buckets of train; mixed_dtype: ResNet-50's "
                       "gradients as one bucket, tensors -> buffer dtype "
                       "(wire_vs_cpu)"}
        for kind in ("pack", "unpack")]
    kernels += [
        {"name": name, "route": "cuda", "source": FLASH_SOURCE,
         "replaces": FLASH_REPLACES[name],
         "launches": sum(by_path[p][name] for p in transformer_paths),
         "launches_by_path": {
             **{p: by_path[p][name] for p in transformer_paths},
             "generate_cached": cached_launches[name],
             "serve": serve_launches[name]},
         **({"status": REDESIGNED[name]} if name in REDESIGNED else {}),
         "checked_vs_plain": True, "max_abs_err": flash_err[name],
         "max_abs_err_by_path": {p: e[name] for p, e in path_err.items()},
         "ms": row["ms"], "plain_ms": row["plain_ms"],
         "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
         "library_ms": row["library_ms"],
         **({"plain_and_library_cover": row["plain_and_library_cover"]}
            if "plain_and_library_cover" in row else {}),
         "times_note": "ms, plain_ms, bound_ms and library_ms at the GPT "
                       "path's shape; by_path: the other paths' shapes "
                       "(the decodes run the forward alone)",
         "by_path": {p: {k: r["kernels"][name][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
             for p, r in flash_paths.items()}}
        for name, row in flash_rows.items()]
    kernels.append(
        {"name": "adasum_combine", "route": "cuda", "source": ADASUM_SOURCE,
         "replaces": ADASUM_REPLACES, "launches": gathered_launches,
         "launches_by_path": {"train_adasum": ada_launches["adasum_combine"],
                              "adasum_gathered": gathered_launches},
         "status": "redesigned: one cooperative launch per tree level, a "
                   "and b read once; a streaming route (two launches) for "
                   "a tensor past a round",
         "checked_vs_plain": True,
         "max_abs_err": max(adasum_err, gathered_err),
         "ms": ada_total["ms"], "wrapper_ms": ada_total["wrapper_ms"],
         "plain_ms": ada_total["plain_ms"], "bound_ms": ada_total["bound_ms"],
         "bound_share": ada_total["bound_share"],
         "bound_by": "bytes", "library_ms": None,
         "library": "none: no single PyTorch call computes this combine",
         "note": "train_adasum runs one rank, a tree of one leaf: no "
                 "combine; adasum_gathered drives reduce_gathered, the "
                 "route's post-gather function, on the path's buckets"})
    emit({"kernels": kernels})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
