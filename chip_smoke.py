#!/usr/bin/env python3
"""Drive the PyTorch port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--layers N] [--seed S] [--profile] [--parent DIR]
    python3 chip_smoke.py --nan-guard-cost | --gemv-cost | --grouped-cost
    python3 chip_smoke.py --ragged-cost [--parent DIR]

Phases, each printing one JSON line; any failure exits non-zero:

1. the card's name and power limit, as nvidia-smi gives them;
2. the build of every CUDA kernel of the serving and training paths (one
   nvcc per source, all started together) with ptxas's registers and
   spills and the HGMMA count (cuobjdump) of each tensor-core kernel
   (flash and quantized), which must not be 0; then each kernel of the
   serving paths against its plain PyTorch version on the card at the
   serving shapes, with its time, the plain version's time, one PyTorch
   library call's time (a yardstick the port never calls) and the least
   time the card could take: ragged attention (its time also in a CUDA
   graph over pool copies used in turn, beside SDPA's, with the cluster
   size the kernel took and its share of the bound; with --parent DIR the
   parent commit's three ragged kernels, built from that checkout, are
   timed the same way in the same cases); the flash forward on its
   tensor-core kernel (bf16 at D 64 and 128, S 1000 tails, generate's
   prefill shape) and on its CUDA-core kernel (float32, and bf16 at D
   256), each case naming its route, rate and share of its bound; then
   quant_matmul (the decode projections at 8 slots and fp8 codes: the
   tensor-core GEMV, timed on weight copies used in turn so that the
   codes come from device memory, beside the CUDA-core GEMV on the same
   inputs; the head, float32 x: the CUDA-core GEMV; the 1024-row prefill
   gate_up and down products, int8 and fp8, and a 777-row one whose last
   m-tile is partial: the tensor-core product; float32 gate_up at 1024
   rows: the CUDA-core tile; each case names its route and rate), ragged
   attention over the int8 pool and the split-context partials (at
   serve_long's shapes, MHA and GQA, timed as the ragged cases, and with
   NaN past every window); the three ragged kernels at the warm
   prefill's shape (one prompt's 512 suffix rows after 512 cached tokens,
   one table, NaN wherever no row's window reaches; timed in a CUDA graph
   beside SDPA on the prompt's contiguous K/V);
3. PagedDecoder.serve at Llama-2-7B widths (bf16, random weights from a
   seeded torch.Generator) on 16 requests, with the reference's default
   loop (the one-chunk lookahead, every decode chunk a CUDA graph
   replay): every request gets its budget and the ragged kernel ran once
   per layer per decode step (each serve and generate phase also records
   the decoders' attention calls by route, `decoder_route_launches`, none
   of them "plain"); each serving phase prints decode ms per step and
   tokens/s, the loop's chunk dispatches, lookahead dispatches, uploads
   and drains (checked: uploads 6 x (drains + 1), a lookahead in every
   pipelined serve and none in a serial one, one graph replay per chunk),
   the graphs captured and the seconds spent capturing, and its peak
   memory; serve_serial: the same serve with pipeline=False, whose
   streams must equal serve's; chunk_graph: a captured paged chunk at
   full width replayed twice against the same chunk called eagerly on
   clones of its state and pools, in bf16 and with the int8 pool: tokens,
   state and every pool byte identical, and layers x 8 ragged launches
   counted a replay;
4. the same requests at 4 layers in float32, with the ragged kernel and
   with the dense-gather oracle, both through the pipelined loop: the
   token streams must be identical, and two of them must equal greedy
   generation through the full forward;
5. CachedDecoder.generate at full width, batch 4, 1024-token prompts: the
   prefill runs the flash-attention forward once per layer, every launch
   on the tensor-core kernel, then the fused greedy chunks as CUDA graphs
   (a first call captures, a second is timed and must give the same
   tokens); generate_sample: 64 new tokens sampled (temperature 0.8,
   top_k 50, top_p 0.9) from a seeded CUDA generator: the same seed
   reproduces the tokens, another seed changes them, and the per-token
   loop gives the fused chunks' tokens; tokens/s;
5b. serve_quant (and serve_quant_serial, pipeline=False, whose streams
   must equal serve_quant's): phase 3's requests with int8_blockwise
   weights and an int8 KV pool (quant_matmul 7 per layer plus the head, per decode step
   and per prefill: every prefill projection on the tensor-core product,
   every decode projection on the tensor-core GEMV, every head on the
   CUDA-core GEMV; the quantized ragged kernel once per layer per step);
   serve_long: 4 prompts of 3000-4000 tokens at max_len 4096 in 4 shards
   (the partials kernel once per layer per step); serve_prefix: the radix
   prefix cache at full width (16 requests sharing a 512-token system
   prompt plus 64-512 tokens of their own, budgets 32-64), served cold
   then warm by one cache-on engine: prefill seconds, p50 TTFT, decode ms
   a step, the cache's counts, prompt tokens computed, ragged launches of
   decode and of the warm prefill, peak memory; every block in use the
   cache's, at least 90 % of the warm prompts' whole blocks found, and the
   warm streams identical to the cold ones counted; then, in float32 at 4
   layers, the quantized ragged serve against the quantized dense one and
   2 and 4 shards against the unsharded serve, token for token;
   prefix_parity (float32, 4 layers, TF32 off): cache-off, cache-on cold
   and warm serves, a second conversational turn, the int8 pool and 4
   shards cold against warm, prefill_chunk 256 on a 1000-token prompt
   against one window, and a serve after every free block is NaN (no
   quarantine), token for token; quarantine: the reference's
   one-chunk-late fault plan (logits_poison on the first two coins) on
   serve with and without the lookahead, streams equal to the unpoisoned
   serial serve's with quarantines and replays, uploads and drains
   reported;
6. the training path's kernels checked and timed the same way at the
   training shapes (after the serving phases, so that those see the card
   as the serving slice left it): the flash forward at the train shape on
   its tensor-core kernel, the flash backward on its tensor-core
   pair (bf16 at D 64 and 128, S 1000 tails and the train shape) and on
   its CUDA-core pair (float32, and bf16 at D 256), each case naming its
   route and rate; then train: bench.py's one-chip
   training configuration (hidden 4096, FFN
   11008, 32 heads, vocab 32000, 4 layers, bf16, batch 6 x 2048, AdamW at
   lr 1e-4 with bf16 moments) through TrainStep, 2 warm-up and 10 timed
   steps: tokens/s, seconds per step, MFU, every step's loss and the peak
   memory. Every loss must be finite, the last below the first, and the
   flash forward and backward kernels must each have run once per layer
   per step, every one on the tensor cores;
7. train_parity: 3 steps of a narrow float32 Llama (2 layers, S 256) with
   the flash kernels and again with the plain attention: losses and the
   first step's gradients must agree, every forward and backward on the
   CUDA cores;
7b. GPT-2 124M pretraining (benchmarks/gpt2_dp.py on its chip): the flash
   forward and backward at its shape (bf16, BH 96, S 1024, D 64, causal)
   against their plain versions on the tensor cores, timed beside SDPA;
   train_gpt2: 12 layers, hidden 768, 12 heads of dim 64, vocab 50257,
   dropout 0.1 (masks from the model's CUDA generator), bf16, batch 8 x
   1024, AdamW at lr 1e-4 through TrainStep with CrossEntropyLoss on
   float32 logits, 2 warm-up and 10 timed steps: s per step, tokens/s,
   MFU, peak memory, losses finite and falling, 12 flash forwards and 12
   backwards a step, every one on the tensor cores and none on the plain
   route; train_gpt2_sched: the same model for 1 + 5 steps under
   ClipGradByGlobalNorm(1.0) and LinearWarmup over CosineAnnealingDecay
   (each step's optimizer must read the scheduled rate), s per step beside
   train_gpt2's; train_gpt2_parity: 2 layers at GPT-2 widths in float32,
   dropout 0, with the flash kernels (CUDA cores) and with the plain
   attention: losses and the first step's gradients must agree;
8. the card's L2 read rate (a probe kernel reading an L2-resident buffer
   over and over), then the MoE training path's kernels (the grouped
   forward, also as the input gradient against w^T read in place, the
   grouped weight gradient and the grouped int8/fp8 forward) at its
   shapes: 16,384 routes of a seeded, skewed routing with one empty
   expert, the up (768 -> 3072) and down (3072 -> 768) products, float32
   and bf16, and a case with NaN in every row that is not a route's (the
   weight gradient on both routes); each
   against its plain version, with its time, the plain time, per-expert
   torch.matmul as the library yardstick and the bound (TF32 peak for
   float32 inputs, bf16 peak for bf16). Every case names its route and
   gives the same bits on two launches. The float32/bf16 forward,
   input-gradient and weight-gradient cases must take the tensor cores
   ("wgmma"; float32 operands as three bf16 pieces each, with a second
   bound at six bf16 products, `bound_bf16x6_ms`, and a third,
   `bound_l2_ms`, at the L2 read rate for the tiles' reads), but
   `up_dx_f32_bm64` and `down_dx_f32_bm64` (groups of 64 rows,
   train_moe_quant_bm64's input gradients against w^T read in place; the
   first is its kernels-line row), which hold the CUDA-core kernel, and
   two weight-gradient cases on the CUDA-core kernel: `up_dw_f32_x_offset`
   (x 4 bytes off a 16-byte boundary) and `up_dw_f32_f3076` (an expert
   width of 3076, train_moe_f3076's shapes; its kernels-line row). The
   int8/fp8 cases must take the tensor cores too ("wgmma"; float32 x as
   three bf16 pieces, `bound_bf16x3_ms`), but two that hold the CUDA-core
   kernel: `up_int8_f32_bm64` (groups of 64 rows, the shapes at which
   train_moe_quant_bm64 launches it; its kernels-line row) and
   `up_int8_f32_bk96` (blocks of 96); with --parent DIR the parent
   commit's grouped forward, weight gradient and quantized kernel, built
   from that checkout, are checked and timed on the same inputs (parent,
   shipped, shipped, parent: `parent_ms`);
9. train_moe: the GPT-MoE of benchmarks/gpt_moe_ep.py at its chip widths
   (hidden 768, 6 layers, 8 experts top-2, 12 heads, vocab 50257;
   318,151,297 parameters), float32, grouped dispatch, AdamW at lr 1e-4,
   the benchmark's fixed batch of 8 x 1024 ids, 2 warm-up and 10 timed
   steps: tokens/s, seconds per step, MFU over activated flops, every
   loss, peak memory and routes per step. Losses finite and falling, the
   grouped forward kernel 4 x layers and the dw kernel 2 x layers times a
   step, every forward, input gradient and weight gradient on the tensor
   cores (`grouped_route_launches`, `grouped_dw_route_launches`), no
   route dropped, and each step's routes per expert in each layer
   (`expert_counts`); with --parent, again on the parent's grouped forward
   and weight gradient (train_moe_parent). train_moe_quant: the same with
   expert_quant="int8" (5 timed steps; the quantized kernel 2 x layers
   times a step and the input gradient and weight gradient as often,
   every launch on the tensor cores); with --parent, again on the
   parent's quantized and grouped kernels (train_moe_quant_parent);
   train_moe_quant_bm64: 3 steps with groups of 64 rows, every quantized
   launch and input gradient on the CUDA-core kernels (their launches on
   the kernels line), every weight gradient on the tensor cores;
   dw_order: the weight gradient on the group sizes of train_moe's and
   train_moe_quant's last steps, layer by layer, with the experts in the
   gates' order and largest group first, in turns (`tail_cost`,
   `step_tail_cost`: what ranking the blocks by group size would save);
   train_moe_f3076: 3 steps at an expert width of 3076 (not a multiple of
   8), every weight gradient on the CUDA-core kernel (its launches on the
   kernels line), every grouped forward too but the down projection's
   input gradient;
10. moe_parity: 3 float32 steps of a 2-layer full-width GPT-MoE, grouped
   against capacity dispatch with capacity_factor E / top_k (nothing
   drops): losses and the first step's gradients must agree;
   attention_fallback: flash_attention at head dim 96 in bf16 and 128 in
   float16, which no kernel takes, forward and backward on the counted
   plain route against the plain version in float32 (train, generate,
   varlen_attn and flashmask_attn each check that no attention call of
   theirs took the plain route);
11. the packed and masked attention kernels (varlen forward, dq + dk/dv;
   FlashMask forward, dq + dk/dv) against their plain versions in bf16:
   the packed batch of phase 12 (timed with the plain versions, SDPA with
   the boolean mask and, where torch has it, its varlen call, forward and
   backward), the same documents in float32 at phase 13's 4 heads (timed
   too), D 64 and 256 (D 256 timed too), a total of 1000, empty
   documents, unequal packs with an empty k document (keyless rows 0 with
   zero gradients), random start rows, and NaN in one document's q, k, v
   and dO (every other document's outputs and gradients bit for bit
   unchanged, the document's own all NaN); each forward and backward on
   the tensor cores in bf16 at D 64 and 128 and on the CUDA cores in
   float32 and at D 256, each case with its route, rate,
   share of its bound, live, visited and dense pair counts and the bound
   over live pairs (backward 2.5 x the forward's flops);
12. varlen_attn: flash_attn_unpadded on bench.py's one-chip batch packed
   (6 x 2048 = 12,288 tokens, 16 documents of rng.integers(64, 2049) from
   the seed, the last of a row cut to fit), [12288, 32, 128] bf16 leaves,
   causal, forward and backward through autograd, 2 warm-up and 10 timed
   passes: ms per pass, tokens/s, TFLOP/s over live pairs, peak memory,
   and one launch of each kernel per pass, every forward and backward on
   the tensor cores; flashmask_attn: the same with
   flash_attention_with_sparse_mask on [6, 2048, 32, 128] and the
   documents as [6, 1, 2048] start rows;
13. packed_parity: the two paths in float32 at 4 heads on the same
   documents (outputs and gradients), and FlashMask with start rows S
   against the dense flash kernels, every masked forward and backward on
   the CUDA cores;
14. the row-wise kernels (RMSNorm forward and backward, RoPE, the causal
   softmax forward and backward) against their plain versions, element by
   element to 2^-7 |ref| in bf16 (0 in float32) plus 1e-5 of the largest:
   at phase 15's shapes (timed with the plain versions and torch's
   rms_norm, softmax and _softmax_backward_data as yardsticks), h 5120,
   8192 and 12288, one row, bf16 and float32 x and w, dw the same bits over
   two runs, RoPE at B > 1 with S-row tables whose halves differ, a
   one-row table and D 256, the softmax at S 8192 and with NaN above the
   diagonal of x and of g (p and dx finite and unchanged);
15. rowwise_attn: the three incubate entry points at Llama-2-7B width on
   bench.py's batch, bf16: x [6, 2048, 4096] with a residual through
   fused_rms_norm, q/k/v projections to [6, 2048, 32, 128],
   fused_rotary_position_embedding (rotate-half), the [6, 32, 2048, 2048]
   scores through softmax_mask_fuse_upper_triangle, p v and a scalar loss,
   forward and backward, 2 warm-up and 10 timed passes: ms per pass,
   tokens/s, peak memory, and each kernel's launches (RMSNorm 1 + 1, RoPE
   4, softmax 1 + 1 a pass); rowwise_parity: the same pass in float32
   through the kernels and through their plain versions (loss, gradients
   of x, the residual, the norm weight and the projections);
16b. train_resnet50: benchmarks/resnet50_eager.py's configuration
   through the port's entry points (resnet50(num_classes=1000), float32
   with TF32 off, batch 64 x 3 x 224 x 224, Momentum(0.1, 0.9) under
   TrainStep, 2 warm-up and 10 timed steps, cuDNN's benchmark mode on):
   s per step, images/s, TFLOP/s over 3 x flops(net, [1, 3, 224, 224]) an
   image and its share of 67 TFLOP/s, peak memory, every loss (finite),
   the batch norms' buffers (moved, finite); two information lines, each
   on a fresh model: the same steps with TF32 allowed, and in
   channels_last memory format. resnet_parity: resnet18 at 64 x 64,
   batch 4, 2 Momentum steps on the card twice (bit for bit, cuDNN
   deterministic) and on the CPU, in float32 and float64 (see
   RESNET_PARITY_TOLS). This path has no kernel of the port's own: the
   reference runs it on XLA's convolutions, pools and batch norms;
16c. data, tensor and pipeline parallelism (one card: NCCL takes one
   rank a device, so NCCL runs at world 1 and the spawned phases run as
   gloo ranks on the card, whose CUDA collectives go through host memory;
   gloo's own send/recv abort on CUDA tensors, so the port's p2p stages
   them through pinned host buffers and counts them, p2p_host_staged):
   dist_collectives_nccl (init_parallel_env on NCCL through a TCPStore on
   127.0.0.1 and a free port; every collective on CUDA tensors against
   the world-1 result; compress="int8" and "bf16" against the port's CPU
   bodies; the int8 codec on the card against its CPU version, with the
   count of codes one apart); train_gpt2_dp (train_gpt2 through
   fleet.init(dp_degree=1), distributed_model, distributed_optimizer and
   TrainStep: losses equal train_gpt2's bit for bit, s/step beside the
   plain step's, timed in turns); train_mp1_nccl (train's configuration
   with tensor_parallel=True under fleet.init(mp_degree=1): losses equal
   train's bit for bit); train_mp1_quant_nccl (the same under
   matmul_quant "int8" and "fp8": every mp layer's forward on
   quant_matmul's wgmma route, 29 launches a step, the step-1 loss within
   2 % of train_mp1_nccl's and not equal to it, falling losses, s/step,
   tokens/s and MFU over 5 timed steps; quant_matmul at the step's four
   shapes, M 12,288, against its plain version, timed beside F.linear);
   train_semi_auto_nccl (BASELINE configuration 5
   at world 1: train's model, seed and batch through the auto-parallel
   API, ProcessMesh([[0]], ["dp", "mp"]), shard_layer with the
   reference's megatron shard_fn, shard_optimizer, shard_dataloader,
   to_static and DistModel: losses equal train's bit for bit, the wgmma
   flash pair a layer a step each way, s/step beside train's);
   dp2_gloo_on_card (GPT-2 124M, float32, dropout
   0, 4 + 4 rows of 8 x 1024, 3 steps exact and 3 with
   grad_compress="int8", against one process over the 8 rows: losses,
   step-1 gradients, parameters, replicas bit for bit after every step,
   wire bytes a step); mp2_gloo_on_card (Llama at Llama-2-7B widths, 2
   layers, float32, 2 x 512, mp 2, against the mp-1 model from the same
   full weights: losses, step-1 gradient shards, parameter shards, the
   replicated parameters bit for bit on both ranks);
   mp2_overlap_gloo_on_card (that world and model in five lanes:
   sequence_parallel; mp_overlap's column / row rings exact, bf16 and
   int8; sequence_parallel with the column_sp / row_sp rings; the exact
   lanes within 1e-5 of the mp-1 losses and by PARAM_FRAC's rule after
   step 3, the codec lanes' step-1 loss within 1e-4 of the exact ring
   lane's (1e-3 later) and more than 1e-6 from it; the bytes the rings posted a rank a step equal to
   the sum of overlap_wire_plan over the step's calls, 251,658,240 /
   125,829,120 / 63,897,600 for the three column / row lanes); train_pp1_nccl
   (train's configuration with pipeline_parallel=True under
   fleet.init(pp_degree=1): at pp_microbatches=1 losses equal train's bit
   for bit with train's flash launches a step, then the auto microbatch
   count, each s/step beside train's); pp2_gloo_on_card (two ranks, pp 2,
   float32, TF32 off: Llama at Llama-2-7B widths, 4 layers, 4 x 512, 4
   microbatches, 1F1B, and GPT-2 124M at virtual_pp_degree 2, 8 x 1024,
   4 microbatches, interleaved, each against one process at pp 1 over
   the same microbatches: Llama's losses and parameters after step 2 bit
   for bit, GPT's step-1 loss bit for bit and the rest within the
   tolerance its tied wte's summation order needs; s/step, stage-to-stage
   bytes, host-staged bytes and calls and each rank's receive wait a
   step); pp2mp2_gloo_on_card (four ranks, pp 2 x mp 2, bf16, the same
   7B-wide Llama: losses within 1e-2 of one process, every stage
   attention on the wgmma flash pair by route_launches);
   semi_auto_dp2mp2_gloo_on_card (configuration 5 across four ranks: the
   mesh [[0, 1], [2, 3]] as ["dp", "mp"], Llama at Llama-2-7B widths, 2
   layers, float32, TF32 off, 4 x 512 split 2 + 2 over dp by
   shard_dataloader, megatron placements over mp, 3 AdamW steps through
   DistModel, after a probe of DTensor's redistributions on CUDA tensors
   over gloo: losses within 1e-5 of one process on the whole batch,
   parameters after step 3 by PARAM_FRAC's rule, each rank's bytes of
   the split linears half of one process's, the CUDA-core flash pair a
   layer a step each way, s/step and peak memory a rank); then BASELINE
   configuration 4 on train_moe's GPT-MoE (full width and depth, float32,
   TF32 off, train_moe's batch and seed, 3 AdamW steps):
   train_moe_stage2_nccl (GroupShardedOptimizerStage2 through fleet at
   world 1 on NCCL in both lanes, and group_sharded_parallel at "os",
   "os_g" and "p_g_os": losses bit for bit with one process, and with
   train_moe's when it ran), ep2_gloo_on_card (two ranks, ep 2, 4 + 4
   rows: grouped with dispatch_compress None, "bf16" and "int8", and
   capacity; each rank's expert bytes half of one process's, every
   grouped launch on the wgmma route, the exchange's wire bytes a step
   equal to dispatch_wire_bytes), sharding2_gloo_on_card (two ranks,
   stages 1-3: each rank's moment, gradient and at-rest parameter bytes,
   its peak memory) and ep2sharding2_gloo_on_card (four ranks, ep 2 x
   sharding 2 at stage 2), each held to one process on the whole batch
   (1e-5 relative; the codecs 1e-4, and each codec lane more than 1e-6
   from the exact lane). A spawned world that does not end
   by its deadline fails the phase. `--dist-only` runs
   the train and train_gpt2 phases and this phase alone;
16. one line naming each kernel with its launches on the main path (the
   serve of phase 3 for the ragged kernel, the train of phase 6 and the
   generate of phase 5 for the flash forward's tensor-core kernel,
   train_parity for its CUDA-core kernel, the train of phase 6 for the
   flash backward's tensor-core pair and train_parity for its CUDA-core
   pair, each flash row with the auto-parallel phases' launches added
   (train_semi_auto_nccl's tensor-core pair, rank 0 of
   semi_auto_dp2mp2_gloo_on_card's CUDA-core pair), train_gpt2 for both
   at D 64, serve_quant
   for quant_matmul's two GEMVs and tensor-core product (and
   train_mp1_quant_nccl for that product at the training shapes, the
   check at its gate_up shape) and the quantized
   ragged kernel, serve_long for the partials, serve_prefix for the
   ragged kernel at the warm prefill's shape and prefix_parity for the
   other two there, train_moe for the grouped
   forward and the dw kernel on the tensor cores, train_moe_quant_bm64
   for the grouped forward on the CUDA cores, train_moe_f3076 for the dw
   kernel on the CUDA cores, train_moe_quant for the
   quantized grouped
   kernel on the tensor cores and train_moe_quant_bm64 for it on the CUDA
   cores, varlen_attn and flashmask_attn for the packed kernels on the
   tensor cores (both directions), packed_parity for both directions on
   the CUDA cores,
   rowwise_attn for the row-wise ones), error and times;
17. the card's name and power limit again, and the result line.

--nan-guard-cost, --gemv-cost, --grouped-cost and --ragged-cost only
build the kernels and time one part of a kernel against extra builds
without it (the masked kernels' NaN guard; the tensor-core GEMV's
products and its code reads; the grouped tensor-core ring's drain,
split, loads and products, in the forward and the weight gradient; the
ragged kernels' arithmetic and their loads, and their cluster size fixed
at 1, 2, 4 and 8), then exit.

With --profile, short full-width serves (plain, serve_quant's and
serve_long's engines), two train steps, two train_moe steps and three
passes of each packed-attention path and of rowwise_attn, two
train_gpt2 steps and two train_resnet50 steps (by group: cuDNN
convolution forward, data and weight gradients, batch norm,
element-wise, the optimizer, the rest), also run under
torch.profiler, and one more line for each gives the device time by
kernel (for a serve also every kernel of the port's own, whatever its
rank) and the device's idle share; a serve's line also gives its decode
steps' busy ms a step and idle share (the same prefills profiled alone,
at budget 1, are taken off the device time). With --parent too, serve_long's
profile runs again on the parent's partials kernel.

Tolerance of the kernel checks, element by element: |out - ref| <=
2^-7 |ref| + 1e-4. Kernel and plain version both compute in float32 from
the same bf16 inputs and round the output to bf16; their float32 values
differ in summation order only (about 1e-6), so the rounded outputs
differ by at most one bf16 ulp, which is at most 2^-7 of the value (the
tensor-core forward carries p into p.v as a bf16 hi + lo pair to stay
there). The float32 lse gets atol 1e-4, and so do float32 outputs. A
ragged case with a planted last token shows that a kernel which dropped
the inclusive end of the window would fail.
The backward's dq, dk and dv get the same 2^-7 |ref| and an atol of 1e-3
of each gradient's largest magnitude: there the float32 sums run over S
terms whose difference dp - delta cancels, so an element far below the
largest carries a summation-order error of about 1e-6 of the largest
(not of itself); a dropped 32-key tile would move a gradient by about
1e-2 of its largest element. Float32 gradients (the CUDA-core pair) get
rtol 0 and 1e-4 of the largest.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor-core peak
BF16_RTOL = 2.0 ** -7           # one bf16 ulp, relative to the value
BF16_ATOL = 1e-4
LSE_ATOL = 1e-4                 # float32 lse, summation order only
FWD_ATOL_F32 = 1e-4             # float32 o and lse: summation order only
GRAD_ATOL = 1e-3                # of the gradient's largest magnitude
# float32 gradients: summation order only, as the card tests' float32 rule
GRAD_ATOL_F32 = 1e-4
# the library yardstick may round p to bf16 before p.v; it is held to
# 2e-2 of the output's largest magnitude (at least 1)
LIB_TOL = 2e-2


_T_START = time.monotonic()


def emit(obj):
    """Print one record; a phase's record also carries the seconds since
    the script started (``script_s``), which time the phases."""
    if "phase" in obj:
        obj = {**obj, "script_s": time.monotonic() - _T_START}
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters, warmup=2):
    """Mean device time of fn over iters launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(torch, calls, reps=3):
    """Mean device time of one call in a CUDA graph of `calls` (closures,
    one launch each, warmed up first), the median of reps replays: the
    kernels back to back, without the host's time between launches, which
    is longer than a decode GEMV."""
    for call in calls[:2]:
        call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for call in calls:
            call()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / len(calls))
    del graph
    return statistics.median(times)


def bf16_err(out, ref, atol=BF16_ATOL, rtol=BF16_RTOL):
    """(max abs error, largest ratio of an element's error to its
    tolerance rtol * |ref| + atol)."""
    d = (out.float() - ref.float()).abs()
    lim = rtol * ref.float().abs() + atol
    return d.max().item(), (d / lim).max().item()


def lib_check(name, lib, ref):
    err = (lib.float() - ref.float()).abs().max().item()
    top = max(1.0, ref.float().abs().max().item())
    check(err <= LIB_TOL * top, f"{name}: library yardstick disagrees "
                                f"({err})")


def bound(bytes_moved, flops, peak_flops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


# the tensor-core kernels of each source, whose SASS must hold HGMMA (the
# masked forward, dq and dk/dv kernels are templates with a mask policy per
# source; the quantized ones with a code type, and the grouped one an x
# dtype too; the grouped float32/bf16 forward a dtype and a transpose, its
# weight gradient a dtype)
MASKED_WGMMA = ("masked_fwd_wgmma", "masked_dq_wgmma", "masked_dkv_wgmma")
WGMMA_KERNELS = {"flash_attention_fwd": ("flash_fwd_wgmma",),
                 "flash_attention_bwd": ("flash_bwd_dq_wgmma",
                                         "flash_bwd_dkv_wgmma"),
                 "flash_varlen": MASKED_WGMMA,
                 "flash_sparse_mask": MASKED_WGMMA,
                 "quant_matmul": ("qmm_wgmma",),
                 "quant_grouped_matmul": ("quant_grouped_wgmma",),
                 "grouped_matmul": ("grouped_wgmma", "grouped_dw_wgmma")}


def kernel_label(mangled):
    """A short label of a mangled kernel name: its own name, then the
    element type, integer arguments (head dim, code type, row tiles),
    bool arguments and mask policy where its template has them
    ("masked_dq_wgmma<128, SegmentMask>", "qmm_gemv_tc<0, 4>",
    "grouped_wgmma<float, true>")."""
    i = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while i < len(mangled) and mangled[i].isdigit():
        n = re.match(r"\d+", mangled[i:]).group()
        i += len(n)
        name = mangled[i:i + int(n)]
        i += int(n)
    rest = mangled[i:]
    args = [t for t, key in (("float", "If"), ("bf16", "I13__nv_bfloat16"))
            if rest.startswith(key)]
    args += re.findall(r"Li(\d+)E", rest)
    args += ["true" if b == "1" else "false"
             for b in re.findall(r"Lb([01])E", rest)]
    args += [m for m in ("SegmentMask", "StartRowMask") if m in rest]
    return f"{name}<{', '.join(args)}>" if args else name


def ptxas_kernels(log):
    """{kernel label: "N registers, S bytes spill stores, L bytes spill
    loads"} from nvcc's -Xptxas -v output."""
    out, fn, spill = {}, None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn, spill = kernel_label(m.group(1)), ""
            continue
        m = re.search(r"(\d+ bytes spill stores, \d+ bytes spill loads)",
                      line)
        if m and fn:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn] = f"{m.group(1)} registers, {spill}"
            fn = None
    return out


def hgmma_counts(so, kernels):
    """HGMMA instructions in each instance of the named kernels of a built
    library, keyed by `kernel_label` ("quant_grouped_wgmma<float, 0>")."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    out = subprocess.run([tool, "--dump-sass", str(so)],
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed on {so}: "
                               f"{out.stderr[-500:]}")
    counts, key = {}, None
    for line in out.stdout.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            key = (kernel_label(fn.group(1))
                   if any(k + "I" in fn.group(1) for k in kernels) else None)
            if key:
                counts[key] = 0
        elif key and "HGMMA" in line:
            counts[key] += 1
    return counts


def zero_flash_counts(*wrappers):
    """Set each flash wrapper's launch count and its counts by route to 0,
    just before a driven path."""
    for w in wrappers:
        w.launches = 0
        w.route_launches = dict.fromkeys(w.route_launches, 0)


# the attention functionals that count their calls by route ("kernel",
# "plain": `attention_route`)
ATTN_FUNCTIONALS = ("flash_attention", "flash_attn_unpadded",
                    "flash_attention_with_sparse_mask")


def zero_attention_routes():
    from paddle_tpu_torch.nn import functional as F
    for name in ATTN_FUNCTIONALS:
        fn = getattr(F, name)
        fn.route_launches = dict.fromkeys(fn.route_launches, 0)


def attention_routes_without_plain(phase):
    """Each functional's calls by route since `zero_attention_routes`,
    checked to hold no "plain" one: the main path runs where a kernel
    fits."""
    from paddle_tpu_torch.nn import functional as F
    counts = {name: dict(getattr(F, name).route_launches)
              for name in ATTN_FUNCTIONALS}
    check(all(c["plain"] == 0 for c in counts.values()),
          f"{phase}: an attention call took the plain route: {counts}")
    return counts


# -- phase 2: kernels against their plain versions -----------------------------

def zero_decoder_routes():
    """Set the decoders' attention counts by route to 0, just before a
    driven path."""
    from paddle_tpu_torch.models.decode import CachedDecoder
    from paddle_tpu_torch.models.paged_decode import PagedDecoder
    for cls in (CachedDecoder, PagedDecoder):
        cls.route_launches = dict.fromkeys(cls.route_launches, 0)


def decoder_routes_without_plain(phase):
    """The decoders' attention calls by route since `zero_decoder_routes`
    (CachedDecoder's prefill, PagedDecoder's decode attention), checked to
    hold no "plain" one: at Llama-2 widths every call fits a kernel."""
    from paddle_tpu_torch.models.decode import CachedDecoder
    from paddle_tpu_torch.models.paged_decode import PagedDecoder
    counts = {"prefill": dict(CachedDecoder.route_launches),
              "decode": dict(PagedDecoder.route_launches)}
    check(all(c["plain"] == 0 for c in counts.values()),
          f"{phase}: a decoder's attention took the plain route: {counts}")
    return counts


def ragged_graph_times(torch, stem, call, pools, live_bytes, variants=None,
                       rounds=1):
    """Device time of one ragged call in a CUDA graph (graph_ms) on copies
    of its pools used in turn, QMM_COLD_BYTES of live rows in all, so that
    every launch reads its rows from device memory as the serve does, under
    the shipped library of csrc/<stem>.cu and each of `variants` ({key:
    library}, swapped into _build._libs in turn, `rounds` times). Returns
    ({key: [ms a round]}, the number of pool copies)."""
    from paddle_tpu_torch.kernels import _build
    copies = max(2, math.ceil(QMM_COLD_BYTES / live_bytes))
    sets = [pools] + [tuple(t.clone() for t in pools)
                      for _ in range(copies - 1)]
    calls = [(lambda p=p: call(*p)) for p in sets * 4]
    libs = {"shipped": _build._libs[stem], **(variants or {})}
    ms = {k: [] for k in libs}
    try:
        for _ in range(rounds):
            for k, lib in libs.items():
                _build._libs[stem] = lib
                ms[k].append(graph_ms(torch, calls))
    finally:
        _build._libs[stem] = libs["shipped"]
    del sets, calls
    torch.cuda.empty_cache()
    return ms, copies


def ragged_record(rec, ms, copies, library_graph):
    """The graph timings of a ragged case into its record: graph_ms (the
    shipped kernel), each variant's median and rounds, bound_share."""
    shipped = ms.pop("shipped")
    rec.update({"graph_ms": statistics.median(shipped),
                "graph_ms_runs": shipped,
                "timing": "kernel_ms: CUDA events over 50 eager calls on one "
                          "pool; graph_ms: CUDA graph, pool copies in turn",
                "pool_copies": copies,
                "library_graph_ms": library_graph})
    rec["bound_share"] = rec["bound_ms"] / rec["graph_ms"]
    if ms:
        rec["variant_graph_ms"] = {k: statistics.median(v)
                                   for k, v in ms.items()}
        rec["variant_graph_ms_runs"] = ms


def sdpa_graph_ms(torch, q4, kw, vw, mask, scale):
    """SDPA on pre-gathered windows in a CUDA graph, on two copies of the
    windows used in turn (each larger than the L2)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    wins = [(kw, vw), (kw.clone(), vw.clone())]
    ms = graph_ms(torch, [(lambda k=k, v=v: sdpa(q4, k, v, attn_mask=mask,
                                                 scale=scale))
                          for k, v in wins * 4])
    del wins
    return ms


def ragged_case(torch, np, name, nh, nkv, seed, poison=False, plant=False,
                variants=None, rounds=1):
    """The ragged kernel at the serve's shapes (8 slots, hd 128, bs 64, 32
    blocks), bf16, against its plain version; two launches must agree bit
    for bit. Timed by events over eager calls (kernel_ms, as the first
    design was timed) and in a CUDA graph on pool copies (graph_ms, with the
    library's graph time and any variant libraries: see
    ragged_graph_times)."""
    from paddle_tpu_torch.kernels.ragged_paged_attention import (
        decode_cluster_size, ragged_hbm_bytes, ragged_paged_attention,
        ragged_paged_attention_plain)
    dev = torch.device("cuda")
    S, hd, bs, mb = 8, 128, 64, 32
    W = mb * bs
    rng = np.random.default_rng(seed)
    lens = rng.integers(127, W, S).astype(np.int32)         # 128..2048
    if plant:
        # the ragged extremes: a one-token window, block edges, the end
        lens = np.array([0, 1, 63, 64, 65, 127, 1000, W - 1], np.int32)
    nb = S * mb + 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    kp = torch.randn(nb, bs, nkv, hd, generator=gen, device=dev,
                     dtype=torch.bfloat16)
    vp = torch.randn(nb, bs, nkv, hd, generator=gen, device=dev,
                     dtype=torch.bfloat16)
    q = torch.randn(S, nh, hd, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    tables_np = (rng.permutation(nb - 1)[:S * mb] + 1).reshape(S, mb)
    tables_np = tables_np.astype(np.int32)
    tables = torch.as_tensor(tables_np, device=dev)
    seq = torch.as_tensor(lens, device=dev)
    scale = hd ** -0.5
    if plant:
        # the token at position seq_len (the inclusive end) gets a key
        # along its group's queries and a large value: it carries most of
        # each slot's softmax
        sl = torch.arange(S, device=dev)
        pos = seq.long()
        blk = tables.long()[sl, pos // bs]
        qg = q.float().reshape(S, nkv, nh // nkv, hd).mean(2)
        kp[blk, pos % bs] = (4 * qg).to(kp.dtype)
        vp[blk, pos % bs] = 4.0
    clean = None
    if poison:
        # every position past each seq_len is NaN and every table entry
        # past the live block is a garbage id
        clean = ragged_paged_attention(q, kp, vp, tables, seq, scale)
        pos = torch.arange(mb * bs, device=dev)
        dead = pos[None, :] > seq.long()[:, None]             # [S, W]
        rows = tables.long().repeat_interleave(bs, dim=1)     # [S, W]
        lanes = (pos % bs)[None, :].expand(S, -1)
        kp[rows[dead], lanes[dead]] = float("nan")
        vp[rows[dead], lanes[dead]] = float("nan")
        kp[0] = float("nan")
        vp[0] = float("nan")
        live_blk = torch.arange(mb, device=dev)[None, :] <= \
            (seq.long() // bs)[:, None]
        tables = torch.where(live_blk, tables, 1 << 30)
    out = ragged_paged_attention(q, kp, vp, tables, seq, scale)
    ref = ragged_paged_attention_plain(q, kp, vp, tables, seq, scale)
    again = ragged_paged_attention(q, kp, vp, tables, seq, scale)
    torch.cuda.synchronize()
    check(bool(torch.equal(out, again)), f"{name}: two launches differ")
    err, ratio = bf16_err(out, ref)
    check(math.isfinite(ratio) and ratio <= 1.0,
          f"{name}: kernel vs plain max abs err {err}, {ratio} x tolerance")
    if plant:
        # the case can see a dropped last token: without it every slot
        # with more than one token moves by far more than the tolerance
        drop = ragged_paged_attention_plain(
            q, kp, vp, tables, (seq - 1).clamp(min=0), scale)
        moved = min(bf16_err(drop[i], ref[i])[1] for i in range(1, S))
        check(moved > 10.0, f"{name}: dropping the last token moves the "
                            f"output by only {moved} x tolerance")
    if poison:
        check(bool(torch.isfinite(out).all()), f"{name}: NaN reached out")
        perr = (out.float() - clean.float()).abs().max().item()
        check(perr == 0.0, f"{name}: poisoned run differs from clean "
                           f"by {perr}")
    kernel_ms = cuda_ms(torch, lambda: ragged_paged_attention(
        q, kp, vp, tables, seq, scale), 50)
    plain_ms = cuda_ms(torch, lambda: ragged_paged_attention_plain(
        q, kp, vp, tables, seq, scale), 5, warmup=1)
    # yardstick: SDPA on each slot's window, pre-gathered (not timed) to
    # a contiguous [S, nh, W, hd] with a per-slot key mask
    safe_tabs = torch.where(tables < nb, tables, 0).long()
    kw = kp[safe_tabs].reshape(S, W, nkv, hd).nan_to_num()
    vw = vp[safe_tabs].reshape(S, W, nkv, hd).nan_to_num()
    kw = kw.repeat_interleave(nh // nkv, dim=2).transpose(1, 2).contiguous()
    vw = vw.repeat_interleave(nh // nkv, dim=2).transpose(1, 2).contiguous()
    mask = (torch.arange(W, device=dev)[None, :]
            <= seq.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_check(name, sdpa(q4, kw, vw, attn_mask=mask, scale=scale)[:, :, 0],
              ref)
    library_ms = cuda_ms(torch, lambda: sdpa(q4, kw, vw, attn_mask=mask,
                                             scale=scale), 20)
    library_graph = sdpa_graph_ms(torch, q4, kw, vw, mask, scale)
    del kw, vw
    itemsize = 2
    # the bytes the function needs: K and V of each token in the window
    # (the kernel loads no other), q in, o out, the live table entries and
    # seq_lens
    tokens = int((np.minimum(lens, W - 1).astype(np.int64) + 1).sum())
    bytes_moved = (2 * nkv * hd * itemsize * tokens
                   + 2 * q.numel() * itemsize
                   + 4 * int((lens // bs + 1).sum()) + 4 * S)
    flops = 4 * nh * hd * tokens
    bound_ms, bound_by = bound(bytes_moved, flops, BF16_FLOPS)
    ms, copies = ragged_graph_times(
        torch, "ragged_paged_attention",
        lambda k, v: ragged_paged_attention(q, k, v, tables, seq, scale),
        (kp, vp), bytes_moved, variants, rounds)
    rec = {"phase": "kernel_check", "kernel": "ragged_paged_attention",
           "case": name, "dtype": "bfloat16", "slots": S, "nh": nh,
           "nkv": nkv, "hd": hd, "block_size": bs,
           "seq_lens": [int(x) for x in lens], "max_abs_err": err,
           "err_over_tolerance": ratio, "rtol": BF16_RTOL,
           "atol": BF16_ATOL, "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library": "scaled_dot_product_attention on a pre-gathered "
                      "window", "bound_ms": bound_ms, "bound_by": bound_by,
           "bytes": bytes_moved, "flops": flops,
           # block-granular accounting of the JAX package's helper
           "ragged_hbm_bytes": ragged_hbm_bytes(lens, bs, nkv, hd,
                                                itemsize),
           "cluster_size": decode_cluster_size(S, nh, nkv, hd, q.dtype)}
    ragged_record(rec, ms, copies, library_graph)
    emit(rec)
    del kp, vp
    torch.cuda.empty_cache()
    return rec


def flash_case(torch, name, bh, s, d, causal, seed, dtype="bfloat16"):
    """The forward kernel against its plain version on the kernel
    flash_fwd_route picks: the tensor cores for bf16 at D 64 and 128, the
    CUDA cores for float32 and D 256. bf16 o is held to BF16_RTOL |ref| +
    BF16_ATOL and lse to LSE_ATOL; float32 o and lse to 1e-4 (the card
    tests' float32 rule)."""
    from paddle_tpu_torch.kernels.flash_attention import (
        _flash_bhsd, flash_attention_fwd_plain, flash_fwd_route)
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q, k, v = (torch.randn(bh, s, d, generator=gen, device=dev, dtype=dt)
               for _ in range(3))
    scale = d ** -0.5
    route = flash_fwd_route(dt, d, [t.data_ptr() for t in (q, k, v)])
    routed = _flash_bhsd.route_launches[route]
    o, lse = _flash_bhsd(q, k, v, causal, scale)
    check(_flash_bhsd.route_launches[route] == routed + 1,
          f"{name}: the forward did not take its {route} kernel")
    ro, rlse = flash_attention_fwd_plain(q, k, v, causal, scale)
    torch.cuda.synchronize()
    if dt == torch.bfloat16:
        rtol, atol, lse_atol = BF16_RTOL, BF16_ATOL, LSE_ATOL
    else:
        rtol, atol, lse_atol = 0.0, FWD_ATOL_F32, FWD_ATOL_F32
    err, ratio = bf16_err(o, ro, atol, rtol)
    lse_err = (lse - rlse).abs().max().item()
    check(ratio <= 1.0 and lse_err <= lse_atol,
          f"{name}: kernel vs plain o err {err} ({ratio} x tolerance), "
          f"lse err {lse_err}")
    kernel_ms = cuda_ms(torch, lambda: _flash_bhsd(q, k, v, causal, scale),
                        10)
    plain_ms = cuda_ms(torch, lambda: flash_attention_fwd_plain(
        q, k, v, causal, scale), 3, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = (x[None] for x in (q, k, v))
    lib_check(name, sdpa(q4, k4, v4, is_causal=causal, scale=scale)[0], ro)
    library_ms = cuda_ms(torch, lambda: sdpa(q4, k4, v4, is_causal=causal,
                                             scale=scale), 10)
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * bh * d * pairs
    bytes_moved = 4 * bh * s * d * q.element_size() + bh * s * 4
    # float32 inputs: full float32 (TF32 would round them), off the
    # tensor cores
    bound_ms, bound_by = bound(bytes_moved, flops, BF16_FLOPS
                               if dt == torch.bfloat16 else F32_FLOPS)
    rec = {"phase": "kernel_check", "kernel": "flash_attention_fwd",
           "case": name, "dtype": dtype, "route": route, "bh": bh, "s": s,
           "d": d, "causal": causal, "max_abs_err": err,
           "err_over_tolerance": ratio, "rtol": rtol,
           "atol": atol, "lse_max_abs_err": lse_err,
           "lse_atol": lse_atol, "kernel_ms": kernel_ms,
           "tflops": flops / kernel_ms / 1e9,
           "bound_share": bound_ms / kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library": "scaled_dot_product_attention", "bound_ms": bound_ms,
           "bound_by": bound_by, "bytes": bytes_moved, "flops": flops}
    emit(rec)
    return rec


def flash_bwd_case(torch, name, bh, s, d, causal, seed,
                   dtype="bfloat16"):
    """The backward kernels (dq, dk/dv) against their plain version on the
    forward kernel's o and lse, as training gives them, on the pair
    flash_bwd_route picks: the tensor cores for bf16 at D 64 and 128, the
    CUDA cores for float32 and D 256. bf16 gradients are held to
    BF16_RTOL |ref| + GRAD_ATOL max|ref|, float32 ones to GRAD_ATOL_F32
    max|ref|. The plain version needs several [BH, S, S] float32 tensors,
    so it runs in chunks of BH."""
    from paddle_tpu_torch.kernels.flash_attention import (
        _flash_bhsd, _flash_bhsd_bwd, flash_attention_bwd_plain,
        flash_bwd_route)
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q, k, v, do = (torch.randn(bh, s, d, generator=gen, device=dev,
                               dtype=dt) for _ in range(4))
    scale = d ** -0.5
    o, lse = _flash_bhsd(q, k, v, causal, scale)
    chunk = max(1, (1 << 28) // (s * s))

    def plain():
        parts = [flash_attention_bwd_plain(
            q[i:i + chunk], k[i:i + chunk], v[i:i + chunk], o[i:i + chunk],
            lse[i:i + chunk], do[i:i + chunk], causal, scale)
            for i in range(0, bh, chunk)]
        return [torch.cat(t) for t in zip(*parts)]

    route = flash_bwd_route(dt, d, [t.data_ptr() for t in (q, k, v, do)])
    routed = _flash_bhsd_bwd.route_launches[route]
    got = _flash_bhsd_bwd(q, k, v, o, lse, do, causal, scale)
    check(_flash_bhsd_bwd.route_launches[route] == routed + 1,
          f"{name}: the backward did not take its {route} pair")
    ref = plain()
    torch.cuda.synchronize()
    rtol = BF16_RTOL if dt == torch.bfloat16 else 0.0
    of_max = GRAD_ATOL if dt == torch.bfloat16 else GRAD_ATOL_F32
    errs, ratios, atols = {}, {}, {}
    for gname, g, r in zip(("dq", "dk", "dv"), got, ref):
        atols[gname] = of_max * r.float().abs().max().item()
        d_ = (g.float() - r.float()).abs()
        errs[gname] = d_.max().item()
        ratios[gname] = (d_ / (rtol * r.float().abs() + atols[gname])) \
            .max().item()
    ratio = max(ratios.values())
    check(math.isfinite(ratio) and ratio <= 1.0,
          f"{name}: backward kernel vs plain errors {errs}, "
          f"{ratios} x tolerance")
    kernel_ms = cuda_ms(torch, lambda: _flash_bhsd_bwd(
        q, k, v, o, lse, do, causal, scale), 10)
    plain_ms = cuda_ms(torch, plain, 2, warmup=1)
    # yardstick: the backward of SDPA's own forward on the same inputs
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = (x[None].detach().requires_grad_() for x in (q, k, v))
    o4 = sdpa(q4, k4, v4, is_causal=causal, scale=scale)
    do4 = do[None]
    lib = torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True)
    for gname, g, r in zip(("dq", "dk", "dv"), lib, ref):
        lib_check(f"{name} {gname}", g[0], r)
    library_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        o4, (q4, k4, v4), do4, retain_graph=True), 10)
    del o4, lib
    pairs = s * (s + 1) // 2 if causal else s * s
    # five S x S x D products (q k^T, dO v^T, p^T dO, ds k, ds^T q)
    flops = 10 * bh * d * pairs
    # q, k, v, o, dO read, dq, dk, dv written; lse and delta float32
    bytes_moved = 8 * bh * s * d * q.element_size() + 2 * bh * s * 4
    # float32 inputs: full float32 (TF32 would round them), off the
    # tensor cores
    bound_ms, bound_by = bound(bytes_moved, flops, BF16_FLOPS
                               if dt == torch.bfloat16 else F32_FLOPS)
    rec = {"phase": "kernel_check", "kernel": "flash_attention_bwd",
           "case": name, "dtype": dtype, "route": route, "bh": bh, "s": s,
           "d": d, "causal": causal, "max_abs_err": max(errs.values()),
           "max_abs_err_by_grad": errs, "err_over_tolerance": ratio,
           "rtol": rtol, "atol_by_grad": atols,
           "plain_chunk_bh": chunk, "kernel_ms": kernel_ms,
           "tflops": flops / kernel_ms / 1e9,
           "bound_share": bound_ms / kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library": "backward of scaled_dot_product_attention",
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bytes": bytes_moved, "flops": flops}
    emit(rec)
    del q, k, v, do, o, lse, got, ref
    torch.cuda.empty_cache()
    return rec


# -- phase 2b: the quantized and long-context serving kernels -------------------

QMM_ATOL = 1e-5                  # of the output's largest magnitude


# decode cases time the weight as the serve finds it, in device memory and
# not in the 50 MB L2: copies of codes and scales (and of F.linear's bf16
# weight) at least this large in all, used in turn
QMM_COLD_BYTES = 150e6


def qmm_case(torch, name, m, k, n, qdtype, x_dtype, seed):
    """quant_matmul at a serve shape: x [m, k] @ dequant(codes [n, k],
    scales [n, k / 128]).T. Kernel and plain version both accumulate in
    float32 (the plain version dequantizes and multiplies on cuBLAS in
    float32) and round to x's dtype: one bf16 ulp of the value, plus 1e-5
    of the largest output for the summation order over k (sums of k
    products of about unit size reach sqrt(k) ~ 100 while the order moves
    them by about sqrt(k) * 6e-8 * 50 = 3e-4; a dropped or wrongly scaled
    K-block moves an output by percents). The record names the kernel
    the wrapper routed the case to (gemv_tc, rows, wgmma or tiled) and its
    rate. Every case is timed by CUDA events over 20 eager calls on one
    weight (`eager_ms`); that is its `kernel_ms` above 32 rows. A decode
    case (m <= 32) takes less device time than the host spends on a call,
    so its `kernel_ms` is timed in a CUDA graph on copies of the weight
    used in turn, QMM_COLD_BYTES in all, so that every launch reads its
    codes from device memory as the serve does and the host's time
    between launches stays out; a bf16 one also times the CUDA-core GEMV
    ("rows") on the same inputs and copies beside it (`rows_ms`), and
    each kernel's launch without the wrapper by events over eager calls
    (`eager_launch_ms`); F.linear is timed in a graph too."""
    from paddle_tpu_torch.kernels.quant_matmul import (
        _launch, blockwise_weight_bytes, dequantize_weight_blockwise,
        quant_matmul, quant_matmul_plain, quantize_weight_blockwise)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    w = torch.randn(n, k, generator=gen, device=dev, dtype=torch.bfloat16)
    codes, scales = quantize_weight_blockwise(w, qdtype=qdtype)
    del w
    x = torch.randn(m, k, generator=gen, device=dev, dtype=x_dtype)
    before = dict(quant_matmul.route_launches)
    out = quant_matmul(x, codes, scales)
    route = [r for r, c in quant_matmul.route_launches.items()
             if c != before[r]]
    check(len(route) == 1, f"{name}: routes {route} for one call")
    route = route[0]
    ref = quant_matmul_plain(x, codes, scales)
    torch.cuda.synchronize()
    atol = QMM_ATOL * ref.float().abs().max().item()
    err, ratio = bf16_err(out, ref, atol)
    if x_dtype == torch.float32:      # no bf16 rounding of the output
        d = (out - ref).abs()
        ratio = (d / (1e-6 * ref.abs() + atol)).max().item()
    check(math.isfinite(ratio) and ratio <= 1.0,
          f"{name}: kernel vs plain max abs err {err}, {ratio} x tolerance")
    wbytes = blockwise_weight_bytes(k, n)[0]
    decode = m <= 32
    copies = (max(2, math.ceil(QMM_COLD_BYTES / wbytes)) if decode else 1)
    weights = [(codes, scales)] + [(codes.clone(), scales.clone())
                                   for _ in range(copies - 1)]
    xlib = x.to(torch.bfloat16)
    linear = torch.nn.functional.linear
    wlib = [dequantize_weight_blockwise(codes, scales).to(torch.bfloat16)]
    lib_check(name, linear(xlib, wlib[0]), ref)
    eager_ms = cuda_ms(torch, lambda: quant_matmul(x, codes, scales), 20)
    rows_ms = launch_ms = None
    if decode:
        # device time in a CUDA graph, each launch on the next weight copy
        wlib += [wlib[0].clone() for _ in range(
            max(1, math.ceil(QMM_COLD_BYTES / (2 * k * n))) - 1)]
        n_calls = 4 * copies
        kernel_ms = graph_ms(torch, [
            (lambda c=c, sc=sc: quant_matmul(x, c, sc))
            for c, sc in weights * 4])
        if x_dtype == torch.bfloat16:
            o = torch.empty_like(out)
            rows_ms = graph_ms(torch, [
                (lambda c=c, sc=sc: _launch("rows", x, c, sc, o))
                for c, sc in weights * 4])
            # each kernel's launch alone, eagerly on one weight: the larger
            # of the host's and the device's time a call, without the
            # wrapper's checks and counting
            launch_ms = {r: cuda_ms(torch, lambda r=r: _launch(
                r, x, codes, scales, o), 20) for r in ("gemv_tc", "rows")}
        library_ms = graph_ms(torch, [
            (lambda wl=wlib[i % len(wlib)]: linear(xlib, wl))
            for i in range(n_calls)])
    else:
        kernel_ms = eager_ms
        library_ms = cuda_ms(torch, lambda: linear(xlib, wlib[0]), 20)
    plain_ms = cuda_ms(torch, lambda: quant_matmul_plain(x, codes, scales),
                       3, warmup=1)
    del wlib, weights
    xsize = x.element_size()
    bytes_moved = wbytes + m * k * xsize + m * n * xsize
    flops = 2 * m * k * n
    # the card's peak for float32 operands is its TF32 one
    bound_ms, bound_by = bound(bytes_moved, flops, BF16_FLOPS
                               if x_dtype == torch.bfloat16 else TF32_FLOPS)
    rec = {"phase": "kernel_check", "kernel": "quant_matmul", "case": name,
           "route": route, "codes": qdtype,
           "x_dtype": str(x_dtype).split(".")[-1],
           "m": m, "k": k, "n": n, "block_k": k // scales.shape[1],
           "max_abs_err": err, "err_over_tolerance": ratio,
           "rtol": BF16_RTOL if x_dtype == torch.bfloat16 else 1e-6,
           "atol": atol, "kernel_ms": kernel_ms,
           "tflops": flops / kernel_ms * 1e-9, "plain_ms": plain_ms,
           "rows_ms": rows_ms, "eager_ms": eager_ms,
           "eager_launch_ms": launch_ms,
           "library_ms": library_ms,
           "library": "F.linear on the dequantized bf16 weight (bf16 x)",
           "timing": ("CUDA graph, weight copies in turn" if decode
                      else "CUDA events over eager calls"),
           "weight_copies": copies, "bound_ms": bound_ms,
           "bound_by": bound_by, "bound_share": bound_ms / kernel_ms,
           "bytes": bytes_moved, "flops": flops,
           "weight_bytes": wbytes, "weight_bytes_bf16": 2 * k * n}
    emit(rec)
    del x, codes, scales, out, ref
    torch.cuda.empty_cache()
    return rec


def build_variants(out, variants):
    """Extra builds of csrc sources for the cost modes, nvcc started for all
    at once, into the directory `out`. variants maps a key to (source stem,
    its module's _SIG, extra nvcc flags, edit): the stem names
    csrc/<stem>.cu, or is the path of a .cu elsewhere (a parent commit's
    source, its headers beside it); edit is None, (text, replacement) or
    a tuple of such pairs, each made once in a copy of the source. Returns {key: the library, bound as
    _build.load binds it}, ready to swap into _build._libs; each library
    carries its path (`so_path`) and nvcc's output (`build_log`)."""
    import ctypes
    from paddle_tpu_torch.kernels import _build
    os.makedirs(out, exist_ok=True)
    # every source is ready before any nvcc starts, so a missing edit
    # leaves no build running
    srcs = {}
    for key, (stem, _, flags, edit) in variants.items():
        tag = "-".join(map(str, key if isinstance(key, tuple) else (key,)))
        src = (stem if stem.endswith(".cu")
               else str(_build.CSRC / f"{stem}.cu"))
        name = os.path.basename(src)[:-3]
        if edit is not None:
            with open(src) as fh:
                text = fh.read()
            for old, new in ((edit,) if isinstance(edit[0], str) else edit):
                check(text.count(old) == 1,
                      f"build {tag}: its text is not in {name}.cu once")
                text = text.replace(old, new)
            src = os.path.join(out, f"{name}-{tag}.cu")
            with open(src, "w") as fh:
                fh.write(text)
        srcs[key] = (src, os.path.join(out, f"lib{name}-{tag}.so"))
    jobs = {key: (so, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, *variants[key][2], "-I",
         str(_build.CSRC), "-o", so, src],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE))
        for key, (src, so) in srcs.items()}
    errs = {key: proc.communicate()[1] for key, (_, proc) in jobs.items()}
    libs = {}
    for key, (so, proc) in jobs.items():
        err = errs[key]
        check(proc.returncode == 0, f"nvcc {key}: {err.decode()[-2000:]}")
        lib = ctypes.CDLL(so)
        for fn, argtypes in variants[key][1].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        lib.so_path, lib.build_log = so, err.decode()
        libs[key] = lib
    return libs


# --gemv-cost: copies of csrc/quant_matmul.cu, edited as they are read,
# that leave one part of the tensor-core GEMV out (its outputs are then
# wrong and unchecked): {build: (text in the source, its replacement)}
GEMV_COST_BUILDS = {
    # the whole-stage path's products: code words neither converted nor
    # multiplied (the ring's loads alone)
    "no_products": ("#pragma unroll\n      for (int j = 0; j < kGSteps; ++j)"
                    "\n        gemv_step<Q, MT>(part, w[j], xrows + 16 * j);"
                    "\n", ""),
    # every codes chunk zero-filled without a read of device memory (the
    # products, x and the scales alone)
    "no_code_reads": ("    const bool ok = ((sl.cok >> i) & 1) && ck;",
                      "    const bool ok = false;")}
GEMV_COST_CASES = (("qkvo_m8_k4096_n4096", 8, 4096, 4096, "int8"),
                   ("gate_up_m8_k4096_n11008", 8, 4096, 11008, "int8"),
                   ("down_m8_k11008_n4096", 8, 11008, 4096, "int8"),
                   ("fp8_gate_up_m8_k4096_n11008", 8, 4096, 11008, "fp8"),
                   ("gate_up_m32_k4096_n11008", 32, 4096, 11008, "int8"))


def gemv_cost(torch, seed):
    """--gemv-cost: what holds the tensor-core GEMV. quant_matmul.cu is
    built twice more into a directory of its own, from copies without the
    products and without the code reads (GEMV_COST_BUILDS); each decode
    case runs on every build in turn, three rounds, timed in a CUDA graph
    on weight copies as qmm_case times it. Prints one line: the median ms
    of each build and the case's bound."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import quant_matmul as qmm
    libs = {"shipped": _build.load("quant_matmul", qmm._SIG)}
    libs.update(build_variants(
        os.path.join(str(_build.BUILD_DIR), "gemv_cost"),
        {build: ("quant_matmul", qmm._SIG, (), edit)
         for build, edit in GEMV_COST_BUILDS.items()}))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rec = {"phase": "gemv_cost", "builds": list(libs)}
    try:
        for name, m, k, n, qd in GEMV_COST_CASES:
            w = torch.randn(n, k, generator=gen, device=dev,
                            dtype=torch.bfloat16)
            codes, scales = qmm.quantize_weight_blockwise(w, qdtype=qd)
            del w
            wbytes = qmm.blockwise_weight_bytes(k, n)[0]
            weights = [(codes, scales)] + [
                (codes.clone(), scales.clone()) for _ in
                range(max(2, math.ceil(QMM_COLD_BYTES / wbytes)) - 1)]
            x = torch.randn(m, k, generator=gen, device=dev,
                            dtype=torch.bfloat16)
            ms = {b: [] for b in libs}
            for _ in range(3):
                for b, lib in libs.items():
                    _build._libs["quant_matmul"] = lib
                    ms[b].append(graph_ms(torch, [
                        (lambda c=c, sc=sc: qmm.quant_matmul(x, c, sc))
                        for c, sc in weights * 4]))
            rec[name] = {"ms": {b: statistics.median(v)
                                for b, v in ms.items()},
                         "ms_runs": ms, "bound_ms": bound(
                             wbytes + 2 * m * k + 2 * m * n, 2 * m * k * n,
                             BF16_FLOPS)[0]}
            del weights, codes, scales
            torch.cuda.empty_cache()
    finally:
        _build._libs["quant_matmul"] = libs["shipped"]
    emit(rec)
    return rec


# --grouped-cost: copies of csrc/grouped_matmul.cu, edited as they are
# read, that leave one part of the tensor-core ring (`gw_mainloop`, shared
# by the forward and the weight gradient) out (but no_drain, their outputs
# are wrong and unchecked): {build: (text in the source, its replacement),
# or a tuple of such pairs}
GROUPED_COST_BUILDS = {
    # the products straight into the accumulator, no float32 partial: the
    # stores for stage kt + 1 wait for stage kt - 1's products instead
    "no_drain": (
        ("    gw_stage<F, P>(part, a, b, true);\n",
         "    gw_stage<F, P>(acc, a, b, false);\n"),
        ("      uint8_t* nx = smem",
         "      wg::wait<1>();\n      __syncthreads();\n"
         "      uint8_t* nx = smem"),
        ("    wg::wait<0>();\n    wg::fence_operand(part);\n#pragma unroll\n"
         "    for (int i = 0; i < 64; ++i) acc[i] += part[i];\n", ""),
        ("    if (more) __syncthreads();  // publishes stage kt + 1\n  }\n",
         "    if (more) __syncthreads();  // publishes stage kt + 1\n  }\n"
         "  wg::wait<0>();\n  wg::fence_operand(acc);\n")),
    # the registers' chunks folded into one sum instead of split and
    # stored into the panels (the loads and the products alone)
    "no_split": (
        "      gw_store(nx, oa, ra, bad);\n"
        "      gw_store(nx + L::kB, ob, rb, bad);\n",
        "      { const float* u = reinterpret_cast<const float*>(&ra);\n"
        "        const float* v = reinterpret_cast<const float*>(&rb);\n"
        "#pragma unroll\n"
        "        for (int i = 0; i < (int)(sizeof(ra) / 4); ++i)\n"
        "          bad += u[i] * v[i]; }\n"),
    # no loads past the first two stages (the split and the products)
    "no_loads": ("      if (kt + 2 < KT) load(kt + 2, ra, rb);\n", ""),
    # no products (the loads and the split)
    "no_products": ("    gw_stage<F, P>(part, a, b, true);\n", "")}
# (case, k, n, dtype, kind)
GROUPED_COST_CASES = (("up_fwd_f32", 768, 3072, "float32", "fwd"),
                      ("down_fwd_f32", 3072, 768, "float32", "fwd"),
                      ("up_dx_f32", 3072, 768, "float32", "dx"),
                      ("down_dx_f32", 768, 3072, "float32", "dx"),
                      ("up_fwd_bf16", 768, 3072, "bfloat16", "fwd"),
                      ("up_dw_f32", 768, 3072, "float32", "dw"),
                      ("down_dw_f32", 3072, 768, "float32", "dw"),
                      ("up_dw_bf16", 768, 3072, "bfloat16", "dw"))


def grouped_cost(torch, np, seed):
    """--grouped-cost: what holds the grouped tensor-core kernels.
    grouped_matmul.cu is built four times more into a directory of its
    own (GROUPED_COST_BUILDS); each MoE case (moe_routing's groups) runs
    on every build in turns, shipped first and then the builds in order
    and back, CUDA events over 10 launches each. The shipped and no_drain
    builds are held to the plain version (their share of the float32
    rule); the rest compute wrong outputs. Prints one line: each case's
    mean ms by build and the shares."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import grouped_matmul as gmm
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = {"shipped": _build.load("grouped_matmul", gmm._SIG)}
    libs.update(build_variants(
        os.path.join(str(_build.BUILD_DIR), "grouped_cost"),
        {build: ("grouped_matmul", gmm._SIG, (), edit)
         for build, edit in GROUPED_COST_BUILDS.items()}))
    md = moe_routing(torch, np, seed)[0]
    dev = torch.device("cuda")
    rec = {"phase": "grouped_cost", "builds": list(libs),
           "ptxas": {b: {k: v for k, v in ptxas_kernels(
               lib.build_log if b != "shipped"
               else _build.build_log("grouped_matmul")).items()
               if "wgmma" in k} for b, lib in libs.items()}}
    try:
        for name, k, n, dt, kind in GROUPED_COST_CASES:
            off, cnt = md["offsets"], md["counts"]
            tp = md["row_src"].shape[0]
            dtype = getattr(torch, dt)
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed + k + n)
            x = torch.randn(tp, k, generator=gen, device=dev, dtype=dtype)
            tr = kind == "dx"
            if kind == "dw":
                w = torch.randn(tp, n, generator=gen, device=dev,
                                dtype=dtype)         # dy
                ref = gmm._ref_dw(x, w, off, cnt, MOE_BM, MOE_E)
                rows = slice(None)
            else:
                w = torch.randn(*((MOE_E, n, k) if tr else (MOE_E, k, n)),
                                generator=gen, device=dev, dtype=dtype) \
                    * k ** -0.5
                ref = gmm._ref_fwd(x, w, None, off, cnt, MOE_BM, dtype,
                                   transpose_w=tr)
                rows = md["dest"].long()
            shares = {}
            calls = {}
            for b, lib in libs.items():
                def call(lib=lib):
                    _build._libs["grouped_matmul"] = lib
                    if kind == "dw":
                        return gmm.grouped_matmul_dw(x, w, off, cnt, MOE_BM,
                                                     MOE_E)
                    return gmm.grouped_matmul_fwd(x, w, None, off, cnt,
                                                  MOE_BM, transpose_w=tr)
                calls[b] = call
                if b in ("shipped", "no_drain"):
                    out = call()
                    torch.cuda.synchronize()
                    shares[b] = gmm_err(torch, out, ref, rows,
                                        dtype == torch.bfloat16)[1]
                    del out
            ms = {b: [] for b in libs}
            for b in list(libs) + list(libs)[::-1]:
                ms[b].append(cuda_ms(torch, calls[b], 10))
            rec[name] = {"ms": {b: statistics.mean(v)
                                for b, v in ms.items()},
                         "ms_runs": ms, "rule_share": shares,
                         "counts": cnt.tolist()}
            del x, w, ref
            torch.cuda.empty_cache()
    finally:
        _build._libs["grouped_matmul"] = libs["shipped"]
    emit(rec)
    return rec


# --ragged-cost: copies of the three ragged sources built with the decode
# body's cost switches (csrc/ragged_decode.cuh: PTT_RAGGED_COST 1 leaves
# out the arithmetic on the staged rows, 2 the copies into the ring; their
# outputs are wrong and unchecked) and with a fixed cluster size in place
# of the body's rule (PTT_RAGGED_CLUSTER)
RAGGED_COST_BUILDS = {"no_math": ("-DPTT_RAGGED_COST=1",),
                      "no_loads": ("-DPTT_RAGGED_COST=2",),
                      **{f"cluster{c}": (f"-DPTT_RAGGED_CLUSTER={c}",)
                         for c in (1, 2, 4, 8)}}
RAGGED_STEMS = ("ragged_paged_attention", "ragged_paged_attention_quant",
                "ragged_paged_attention_partials")


def ragged_fwd_sigs():
    """{stem: its launch entry's signature}: what a parent commit's
    library also has."""
    from paddle_tpu_torch.kernels import ragged_paged_attention as rpa
    return {stem: {f"{stem}_fwd": sig[f"{stem}_fwd"]}
            for stem, sig in zip(RAGGED_STEMS,
                                 (rpa._SIG, rpa._QSIG, rpa._PSIG))}


def parent_ragged_libs(parent):
    """The parent commit's three ragged libraries, built from its checkout
    at `parent` (its csrc beside them): {stem: library}."""
    from paddle_tpu_torch.kernels import _build
    csrc = os.path.join(parent, "paddle_tpu_torch", "csrc")
    return build_variants(
        os.path.join(str(_build.BUILD_DIR), "parent"),
        {stem: (os.path.join(csrc, f"{stem}.cu"), sig, (), None)
         for stem, sig in ragged_fwd_sigs().items()})


def ragged_cost(torch, np, parent=None):
    """--ragged-cost: what holds the three ragged kernels. Each source is
    built again per RAGGED_COST_BUILDS (and from the parent's checkout with
    --parent); the main cases (MHA and GQA, bf16 and int8 pools, and the
    4-shard partials) run on every build in turn, three rounds, timed in a
    CUDA graph on pool copies as ragged_case times them. Prints one line:
    each case's median ms by build, its bound and the shipped build's
    cluster size."""
    from paddle_tpu_torch.kernels import _build
    sigs = ragged_fwd_sigs()
    libs = build_variants(
        os.path.join(str(_build.BUILD_DIR), "ragged_cost"),
        {(stem, b): (stem, sigs[stem], flags, None)
         for stem in RAGGED_STEMS for b, flags in RAGGED_COST_BUILDS.items()})
    variants = {stem: {b: libs[(stem, b)] for b in RAGGED_COST_BUILDS}
                for stem in RAGGED_STEMS}
    if parent:
        for stem, lib in parent_ragged_libs(parent).items():
            variants[stem]["parent"] = lib
    rows, quant, partials = (variants[stem] for stem in RAGGED_STEMS)
    recs = [ragged_case(torch, np, "mha_32x32", 32, 32, 11, variants=rows,
                        rounds=3),
            ragged_case(torch, np, "gqa_32x8", 32, 8, 12, variants=rows,
                        rounds=3),
            ragged_quant_case(torch, np, "quant_mha_32x32", 32, 32, 21,
                              variants=quant, rounds=3),
            ragged_quant_case(torch, np, "quant_gqa_32x8", 32, 8, 22,
                              variants=quant, rounds=3),
            partials_case(torch, np, "shards4_s4_32x32_mb64", 32, 32, 25,
                          variants=partials, rounds=3),
            partials_case(torch, np, "shards4_s4_32x8_mb64", 32, 8, 26,
                          variants=partials, rounds=3)]
    rec = {"phase": "ragged_cost", "builds": ["shipped", *rows]}
    for r in recs:
        rec[f"{r['kernel']}:{r['case']}"] = {
            "ms": {"shipped": r["graph_ms"], **r["variant_graph_ms"]},
            "bound_ms": r["bound_ms"], "cluster_size": r["cluster_size"]}
    emit(rec)
    return rec


def ragged_quant_case(torch, np, name, nh, nkv, seed, poison=False,
                      plant=False, variants=None, rounds=1):
    """The quantized ragged kernel at the serve's shapes (8 slots, hd 128,
    bs 64, 32 blocks), pools quantized from bf16 draws with
    kv_quantize_rows, against its plain version; tolerance as the ragged
    case. poison: code 127 and NaN scales at every position past each
    seq_len (inside the live block too) and garbage table entries past
    it; the output must equal the clean run's, bit for bit. Two launches
    must agree bit for bit; timed as ragged_case times."""
    from paddle_tpu_torch.kernels.ragged_paged_attention import (
        decode_cluster_size, kv_dequantize_rows, kv_quantize_rows,
        ragged_paged_attention_quant, ragged_paged_attention_quant_plain)
    dev = torch.device("cuda")
    S, hd, bs, mb = 8, 128, 64, 32
    W = mb * bs
    rng = np.random.default_rng(seed)
    lens = rng.integers(127, W, S).astype(np.int32)
    if plant:
        lens = np.array([0, 1, 63, 64, 65, 127, 1000, W - 1], np.int32)
    nb = S * mb + 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    kc, ks = kv_quantize_rows(torch.randn(nb, bs, nkv, hd, generator=gen,
                                          device=dev, dtype=torch.bfloat16))
    vc, vs = kv_quantize_rows(torch.randn(nb, bs, nkv, hd, generator=gen,
                                          device=dev, dtype=torch.bfloat16))
    q = torch.randn(S, nh, hd, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    tables = torch.as_tensor((rng.permutation(nb - 1)[:S * mb] + 1)
                             .reshape(S, mb).astype(np.int32), device=dev)
    seq = torch.as_tensor(lens, device=dev)
    scale = hd ** -0.5
    if plant:
        # the token at seq_len: a key along its group's queries and a large
        # value, stored through the codec
        sl = torch.arange(S, device=dev)
        pos = seq.long()
        blk = tables.long()[sl, pos // bs]
        qg = q.float().reshape(S, nkv, nh // nkv, hd).mean(2)
        pk, pks = kv_quantize_rows(4 * qg)
        pv, pvs = kv_quantize_rows(torch.full_like(qg, 4.0))
        kc[blk, pos % bs], ks[blk, pos % bs] = pk, pks
        vc[blk, pos % bs], vs[blk, pos % bs] = pv, pvs
    def args():                    # tables is rebound by the poison
        return q, kc, ks, vc, vs, tables, seq

    clean = None
    if poison:
        clean = ragged_paged_attention_quant(*args(), scale)
        pos = torch.arange(W, device=dev)
        dead = pos[None, :] > seq.long()[:, None]
        rows = tables.long().repeat_interleave(bs, dim=1)
        lanes = (pos % bs)[None, :].expand(S, -1)
        for codes, scales in ((kc, ks), (vc, vs)):
            codes[rows[dead], lanes[dead]] = 127
            scales[rows[dead], lanes[dead]] = float("nan")
            codes[0] = 127
            scales[0] = float("nan")
        live_blk = torch.arange(mb, device=dev)[None, :] <= \
            (seq.long() // bs)[:, None]
        tables = torch.where(live_blk, tables, 1 << 30)
    out = ragged_paged_attention_quant(*args(), scale)
    ref = ragged_paged_attention_quant_plain(*args(), scale)
    again = ragged_paged_attention_quant(*args(), scale)
    torch.cuda.synchronize()
    check(bool(torch.equal(out, again)), f"{name}: two launches differ")
    err, ratio = bf16_err(out, ref)
    check(math.isfinite(ratio) and ratio <= 1.0,
          f"{name}: kernel vs plain max abs err {err}, {ratio} x tolerance")
    if plant:
        drop = ragged_paged_attention_quant_plain(
            q, kc, ks, vc, vs, tables, (seq - 1).clamp(min=0), scale)
        moved = min(bf16_err(drop[i], ref[i])[1] for i in range(1, S))
        check(moved > 10.0, f"{name}: dropping the last token moves the "
                            f"output by only {moved} x tolerance")
    if poison:
        check(bool(torch.isfinite(out).all()), f"{name}: NaN reached out")
        perr = (out.float() - clean.float()).abs().max().item()
        check(perr == 0.0, f"{name}: poisoned run differs from clean "
                           f"by {perr}")
    kernel_ms = cuda_ms(torch, lambda: ragged_paged_attention_quant(
        *args(), scale), 50)
    plain_ms = cuda_ms(torch, lambda: ragged_paged_attention_quant_plain(
        *args(), scale), 5, warmup=1)
    # yardstick: SDPA on each slot's dequantized window, pre-gathered (not
    # timed) to a contiguous bf16 [S, nh, W, hd] with a per-slot key mask
    safe = torch.where(tables < nb, tables, 0).long()
    kw = kv_dequantize_rows(kc[safe], ks[safe]).reshape(S, W, nkv, hd)
    vw = kv_dequantize_rows(vc[safe], vs[safe]).reshape(S, W, nkv, hd)
    kw, vw = (t.nan_to_num().to(torch.bfloat16)
              .repeat_interleave(nh // nkv, dim=2).transpose(1, 2)
              .contiguous() for t in (kw, vw))
    mask = (torch.arange(W, device=dev)[None, :]
            <= seq.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_check(name, sdpa(q4, kw, vw, attn_mask=mask, scale=scale)[:, :, 0],
              ref)
    library_ms = cuda_ms(torch, lambda: sdpa(q4, kw, vw, attn_mask=mask,
                                             scale=scale), 20)
    library_graph = sdpa_graph_ms(torch, q4, kw, vw, mask, scale)
    del kw, vw
    # per token: K and V codes of every kv head plus one float32 scale
    # each; then q in, o out, the live table entries and seq_lens
    tokens = int((np.minimum(lens, W - 1).astype(np.int64) + 1).sum())
    bytes_moved = (2 * (nkv * hd + 4) * tokens + 2 * q.numel() * 2
                   + 4 * int((lens // bs + 1).sum()) + 4 * S)
    flops = 4 * nh * hd * tokens
    bound_ms, bound_by = bound(bytes_moved, flops, BF16_FLOPS)
    ms, copies = ragged_graph_times(
        torch, "ragged_paged_attention_quant",
        lambda a, b, c, d: ragged_paged_attention_quant(
            q, a, b, c, d, tables, seq, scale),
        (kc, ks, vc, vs), bytes_moved, variants, rounds)
    rec = {"phase": "kernel_check", "kernel": "ragged_paged_attention_quant",
           "case": name, "dtype": "bfloat16 q, int8 pool", "slots": S,
           "nh": nh, "nkv": nkv, "hd": hd, "block_size": bs,
           "seq_lens": [int(x) for x in lens], "max_abs_err": err,
           "err_over_tolerance": ratio, "rtol": BF16_RTOL,
           "atol": BF16_ATOL, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms,
           "library": "scaled_dot_product_attention on a pre-gathered, "
                      "dequantized bf16 window",
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bytes": bytes_moved, "flops": flops,
           "cluster_size": decode_cluster_size(S, nh, nkv, hd, q.dtype,
                                               quant=True)}
    ragged_record(rec, ms, copies, library_graph)
    emit(rec)
    del kc, ks, vc, vs
    torch.cuda.empty_cache()
    return rec


def partials_case(torch, np, name, nh, nkv, seed, shards=4, poison=False,
                  variants=None, rounds=1):
    """The split-context partials kernel at serve_long's shapes: 4 slots,
    hd 128, bs 64, 64 blocks (4096 positions), 4 shards of 16 blocks, bf16;
    one slot of 100 tokens (three empty trailing shards), one at full span.
    Per-shard o and lse against the plain partials (float32 o atol 1e-4:
    order of the float32 sums over up to 1024 positions; lse atol 1e-4;
    an empty shard's o exactly 0 and its lse the plain version's), the
    merged result against the plain sharded version and the unsharded
    ragged kernel (one bf16 ulp, as the ragged case); two launches must
    agree bit for bit. poison: NaN at every position past each seq_len and
    garbage table entries past the live block; the partials must equal the
    clean run's bit for bit. Timed by events over eager calls (kernel_ms,
    the old series) and in a CUDA graph on pool copies (graph_ms, with
    SDPA's graph time and any variant libraries: see ragged_graph_times)."""
    from paddle_tpu_torch.kernels.ragged_paged_attention import (
        merge_partials, partials_cluster_size, ragged_paged_attention,
        ragged_paged_attention_partials,
        ragged_paged_attention_partials_plain)
    dev = torch.device("cuda")
    S, hd, bs, mb = 4, 128, 64, 64
    W = mb * bs
    rng = np.random.default_rng(seed)
    lens = np.array([100, W - 1, *rng.integers(1100, W - 1, S - 2)],
                    np.int32)
    nb = S * mb + 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    kp = torch.randn(nb, bs, nkv, hd, generator=gen, device=dev,
                     dtype=torch.bfloat16)
    vp = torch.randn(nb, bs, nkv, hd, generator=gen, device=dev,
                     dtype=torch.bfloat16)
    q = torch.randn(S, nh, hd, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    tables = torch.as_tensor((rng.permutation(nb - 1)[:S * mb] + 1)
                             .reshape(S, mb).astype(np.int32), device=dev)
    seq = torch.as_tensor(lens, device=dev)
    scale = hd ** -0.5
    clean = None
    if poison:
        clean = ragged_paged_attention_partials(q, kp, vp, tables, seq,
                                                shards, scale)
        pos = torch.arange(W, device=dev)
        dead = pos[None, :] > seq.long()[:, None]             # [S, W]
        rows = tables.long().repeat_interleave(bs, dim=1)     # [S, W]
        lanes = (pos % bs)[None, :].expand(S, -1)
        kp[rows[dead], lanes[dead]] = float("nan")
        vp[rows[dead], lanes[dead]] = float("nan")
        kp[0] = float("nan")
        vp[0] = float("nan")
        live_blk = torch.arange(mb, device=dev)[None, :] <= \
            (seq.long() // bs)[:, None]
        tables = torch.where(live_blk, tables, 1 << 30)
    o, lse = ragged_paged_attention_partials(q, kp, vp, tables, seq, shards,
                                             scale)
    o2, lse2 = ragged_paged_attention_partials(q, kp, vp, tables, seq,
                                               shards, scale)
    ro, rlse = ragged_paged_attention_partials_plain(q, kp, vp, tables, seq,
                                                     shards, scale)
    merged = merge_partials(o, lse, q.dtype)
    ref = merge_partials(ro, rlse, q.dtype)
    whole = ragged_paged_attention(q, kp, vp, tables, seq, scale)
    torch.cuda.synchronize()
    check(bool(torch.equal(o, o2) and torch.equal(lse, lse2)),
          f"{name}: two launches differ")
    if poison:
        check(bool(torch.isfinite(o).all() and torch.isfinite(lse).all()),
              f"{name}: NaN reached the partials")
        check(bool(torch.equal(o, clean[0]) and torch.equal(lse, clean[1])),
              f"{name}: poisoned run differs from clean")
    live = rlse > -1e29
    check(bool(torch.equal(live, lse > -1e29)),
          f"{name}: empty shards disagree")
    check(int((~live).sum()) >= 3 * nh, f"{name}: no empty shard")
    check(bool((o[~live] == 0).all()
               and torch.equal(lse[~live], rlse[~live])),
          f"{name}: an empty shard's o is not 0 or its lse not the plain "
          f"version's")
    o_err = (o - ro).abs().max().item()
    lse_err = (lse - rlse)[live].abs().max().item()
    err, ratio = bf16_err(merged, ref)
    werr, wratio = bf16_err(merged, whole)
    check(o_err <= FWD_ATOL_F32 and lse_err <= LSE_ATOL and ratio <= 1.0
          and wratio <= 1.0,
          f"{name}: o err {o_err}, lse err {lse_err}, merged vs plain "
          f"{ratio} x tolerance, vs unsharded kernel {wratio}")
    kernel_ms = cuda_ms(torch, lambda: ragged_paged_attention_partials(
        q, kp, vp, tables, seq, shards, scale), 50)
    sharded_ms = cuda_ms(torch, lambda: merge_partials(
        *ragged_paged_attention_partials(q, kp, vp, tables, seq, shards,
                                         scale), q.dtype), 50)
    ragged_ms = cuda_ms(torch, lambda: ragged_paged_attention(
        q, kp, vp, tables, seq, scale), 50)
    plain_ms = cuda_ms(torch, lambda: ragged_paged_attention_partials_plain(
        q, kp, vp, tables, seq, shards, scale), 3, warmup=1)
    # yardstick: SDPA on each slot's window, pre-gathered (not timed) to
    # a contiguous [S, nh, W, hd] with a per-slot key mask
    safe_tabs = torch.where(tables < nb, tables, 0).long()
    kw = kp[safe_tabs].reshape(S, W, nkv, hd).nan_to_num()
    vw = vp[safe_tabs].reshape(S, W, nkv, hd).nan_to_num()
    kw = kw.repeat_interleave(nh // nkv, dim=2).transpose(1, 2).contiguous()
    vw = vw.repeat_interleave(nh // nkv, dim=2).transpose(1, 2).contiguous()
    mask = (torch.arange(W, device=dev)[None, :]
            <= seq.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_check(name, sdpa(q4, kw, vw, attn_mask=mask, scale=scale)[:, :, 0],
              ref)
    library_ms = cuda_ms(torch, lambda: sdpa(q4, kw, vw, attn_mask=mask,
                                             scale=scale), 20)
    library_graph = sdpa_graph_ms(torch, q4, kw, vw, mask, scale)
    del kw, vw
    # K and V of every live token, q, the float32 partials (o and lse of
    # every shard) written once, the live table entries and seq_lens
    tokens = int((lens.astype(np.int64) + 1).sum())
    bytes_moved = (2 * nkv * hd * 2 * tokens + q.numel() * 2
                   + o.numel() * 4 + lse.numel() * 4
                   + 4 * int((lens // bs + 1).sum()) + 4 * S)
    flops = 4 * nh * hd * tokens
    bound_ms, bound_by = bound(bytes_moved, flops, BF16_FLOPS)
    ms, copies = ragged_graph_times(
        torch, "ragged_paged_attention_partials",
        lambda k, v: ragged_paged_attention_partials(q, k, v, tables, seq,
                                                     shards, scale),
        (kp, vp), bytes_moved, variants, rounds)
    rec = {"phase": "kernel_check", "kernel": "ragged_paged_attention_partials",
           "case": name, "dtype": "bfloat16", "slots": S, "nh": nh,
           "nkv": nkv, "hd": hd, "block_size": bs, "blocks_per_seq": mb,
           "shards": shards, "seq_lens": [int(x) for x in lens],
           "max_abs_err": max(o_err, err), "o_max_abs_err": o_err,
           "o_atol": FWD_ATOL_F32, "lse_max_abs_err": lse_err,
           "lse_atol": LSE_ATOL, "merged_err_over_tolerance": ratio,
           "merged_vs_unsharded_kernel_err_over_tolerance": wratio,
           "kernel_ms": kernel_ms, "sharded_with_merge_ms": sharded_ms,
           "unsharded_ragged_kernel_ms": ragged_ms, "plain_ms": plain_ms,
           "library_ms": library_ms,
           "library": "scaled_dot_product_attention on a pre-gathered "
                      "window", "bound_ms": bound_ms, "bound_by": bound_by,
           "bytes": bytes_moved, "flops": flops,
           "cluster_size": partials_cluster_size(S, nh, nkv, hd,
                                                 o.shape[0], q.dtype)}
    ragged_record(rec, ms, copies, library_graph)
    emit(rec)
    del kp, vp, o, ro, o2
    torch.cuda.empty_cache()
    return rec


# the warm prefill's shape: one prompt's suffix rows after its cached tokens
WARM_ROWS, WARM_CACHED = 512, 512
WARM_PLAIN_ROWS = 32             # rows per plain-version call ([32, 2048]
                                 # float32 windows: 2 GB)
WARM_STEMS = {"kernel": "ragged_paged_attention",
              "qkernel": "ragged_paged_attention_quant",
              "pkernel": "ragged_paged_attention_partials"}


def warm_kernel_case(torch, np, kind, seed, rows=WARM_ROWS,
                     cached=WARM_CACHED, shards=4):
    """A decode kernel at the warm prefill's shape: one prompt's `rows`
    suffix rows after `cached` cached tokens, row i at seq_len cached + i
    with the prompt's table, Llama-2-7B's 32 heads of 128, bs 64, a
    32-entry table (max_len 2048) whose entries past the prompt's blocks
    are 0, the trash block, as the engine's are. kind: "kernel" (bf16
    pool), "qkernel" (int8 pool, quantized from bf16 draws) or "pkernel"
    (bf16, `shards` shards: the partials, merged). Every pool position no
    row's window covers is NaN (the trash block and the blocks outside the
    table; int8: code 127 and a NaN scale); within a row's window the
    positions past its own length hold the later rows' finite K/V, which
    the plain version never reads, so a row that read them would leave
    the tolerance. Held against the plain version (run on
    WARM_PLAIN_ROWS rows at a time) by the ragged cases' rule, the
    partials' o and lse as partials_case holds them; two launches bit for
    bit. Timed by events (kernel_ms) and in a CUDA graph over pool copies
    (graph_ms) beside SDPA on the prompt's contiguous K/V with the same
    mask. The bound reads the prompt's K/V once, q once, and writes o
    once."""
    from paddle_tpu_torch.kernels import ragged_paged_attention as rpa
    dev = torch.device("cuda")
    nh = nkv = 32
    hd, bs, mb = 128, 64, 32
    total = cached + rows
    nblk = -(-total // bs)
    nb = 2 * nblk + 1
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    used = rng.permutation(nb - 1)[:nblk] + 1
    row = np.zeros(mb, np.int32)
    row[:nblk] = used
    tables = torch.as_tensor(np.tile(row, (rows, 1)), device=dev)
    lens = (cached + np.arange(rows)).astype(np.int32)
    seq = torch.as_tensor(lens, device=dev)
    dead = torch.as_tensor(np.setdiff1d(np.arange(nb), used), device=dev)
    q = torch.randn(rows, nh, hd, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    scale = hd ** -0.5
    draw = [torch.randn(nb, bs, nkv, hd, generator=gen, device=dev,
                        dtype=torch.bfloat16) for _ in range(2)]
    if kind == "qkernel":
        pools = []
        for x in draw:
            codes, scales = rpa.kv_quantize_rows(x)
            codes[dead], scales[dead] = 127, float("nan")
            pools += [codes, scales]

        def call(kc, ks, vc, vs, q=q, tables=tables, seq=seq):
            return rpa.ragged_paged_attention_quant(q, kc, ks, vc, vs,
                                                    tables, seq, scale)

        def plain(q, tables, seq):
            return rpa.ragged_paged_attention_quant_plain(q, *pools, tables,
                                                          seq, scale)

        def window(codes, scales):
            return rpa.kv_dequantize_rows(codes[used], scales[used])
    else:
        for x in draw:
            x[dead] = float("nan")
        pools = draw
        if kind == "pkernel":
            def call(kp, vp, q=q, tables=tables, seq=seq):
                return rpa.ragged_paged_attention_partials(
                    q, kp, vp, tables, seq, shards, scale)

            def plain(q, tables, seq):
                return rpa.ragged_paged_attention_partials_plain(
                    q, *pools, tables, seq, shards, scale)
        else:
            def call(kp, vp, q=q, tables=tables, seq=seq):
                return rpa.ragged_paged_attention(q, kp, vp, tables, seq,
                                                  scale)

            def plain(q, tables, seq):
                return rpa.ragged_paged_attention_plain(q, *pools, tables,
                                                        seq, scale)

        def window(p):
            return p[used]
    del draw

    def plain_all():
        parts = [plain(q[i:i + WARM_PLAIN_ROWS],
                       tables[i:i + WARM_PLAIN_ROWS],
                       seq[i:i + WARM_PLAIN_ROWS])
                 for i in range(0, rows, WARM_PLAIN_ROWS)]
        if kind == "pkernel":
            return (torch.cat([o for o, _ in parts], dim=1),
                    torch.cat([lse for _, lse in parts], dim=1))
        return torch.cat(parts)

    out = call(*pools)
    again = call(*pools)
    ref = plain_all()
    torch.cuda.synchronize()
    rec = {"phase": "kernel_check", "kernel": WARM_STEMS[kind],
           "case": f"warm_prefill_{kind}_rows{rows}_cached{cached}",
           "dtype": "bfloat16 q, int8 pool" if kind == "qkernel"
           else "bfloat16", "rows": rows, "cached_tokens": cached,
           "nh": nh, "nkv": nkv, "hd": hd, "block_size": bs,
           "blocks_per_seq": mb, "nan_outside_the_windows": True}
    if kind == "pkernel":
        o, lse = out
        check(bool(torch.equal(o, again[0]) and torch.equal(lse, again[1])),
              f"warm {kind}: two launches differ")
        ro, rlse = ref
        check(bool(torch.isfinite(o).all() and torch.isfinite(lse).all()),
              f"warm {kind}: NaN reached the partials")
        live = rlse > -1e29
        check(bool(torch.equal(live, lse > -1e29)
                   and (o[~live] == 0).all()),
              f"warm {kind}: empty shards disagree")
        o_err = (o - ro).abs().max().item()
        lse_err = (lse - rlse)[live].abs().max().item()
        merged = rpa.merge_partials(o, lse, q.dtype)
        err, ratio = bf16_err(merged, rpa.merge_partials(ro, rlse, q.dtype))
        check(o_err <= FWD_ATOL_F32 and lse_err <= LSE_ATOL
              and ratio <= 1.0,
              f"warm {kind}: o err {o_err}, lse err {lse_err}, merged "
              f"{ratio} x tolerance")
        rec.update({"shards": shards, "o_max_abs_err": o_err,
                    "lse_max_abs_err": lse_err,
                    "merged_err_over_tolerance": ratio})
        err = max(err, o_err)
        out_bytes = o.numel() * 4 + lse.numel() * 4
        ref_out = merged
    else:
        check(bool(torch.equal(out, again)), f"warm {kind}: two launches "
                                             f"differ")
        check(bool(torch.isfinite(out).all()), f"warm {kind}: NaN reached "
                                               f"out")
        err, ratio = bf16_err(out, ref)
        check(math.isfinite(ratio) and ratio <= 1.0,
              f"warm {kind}: kernel vs plain max abs err {err}, {ratio} x "
              f"tolerance")
        rec["err_over_tolerance"] = ratio
        out_bytes = out.numel() * 2
        ref_out = ref
    kernel_ms = cuda_ms(torch, lambda: call(*pools), 50)
    plain_ms = cuda_ms(torch, plain_all, 2, warmup=1)
    # yardstick: SDPA over the prompt's contiguous K/V (gathered, not
    # timed), row i masked to keys 0..cached + i
    if kind == "qkernel":
        kw = window(*pools[:2]).to(torch.bfloat16)
        vw = window(*pools[2:]).to(torch.bfloat16)
    else:
        kw, vw = window(pools[0]), window(pools[1])
    kw, vw = (t.reshape(1, nblk * bs, nkv, hd)[:, :total].transpose(1, 2)
              .contiguous() for t in (kw, vw))
    mask = (torch.arange(total, device=dev)[None, :]
            <= seq.long()[:, None])[None, None]
    q4 = q.transpose(0, 1)[None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_check(f"warm {kind}", sdpa(q4, kw, vw, attn_mask=mask,
                                   scale=scale)[0].transpose(0, 1), ref_out)
    library_ms = cuda_ms(torch, lambda: sdpa(q4, kw, vw, attn_mask=mask,
                                             scale=scale), 20)
    library_graph = sdpa_graph_ms(torch, q4, kw, vw, mask, scale)
    del kw, vw
    # the prompt's K and V once (codes and a float32 scale per row for the
    # int8 pool), q in, the output out, each row's live table entries and
    # its seq_len
    row_bytes = nkv * hd + 4 if kind == "qkernel" else nkv * hd * 2
    bytes_moved = (2 * row_bytes * total + q.numel() * 2 + out_bytes
                   + 4 * int((lens // bs + 1).sum()) + 4 * rows)
    flops = 4 * nh * hd * int((lens.astype(np.int64) + 1).sum())
    bound_ms, bound_by = bound(bytes_moved, flops, BF16_FLOPS)
    ms, copies = ragged_graph_times(torch, WARM_STEMS[kind], call,
                                    tuple(pools), bytes_moved)
    rec.update({"max_abs_err": err, "rtol": BF16_RTOL, "atol": BF16_ATOL,
                "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                "library_ms": library_ms,
                "library": "scaled_dot_product_attention on the prompt's "
                           "contiguous K/V" + (" (dequantized to bf16)"
                                               if kind == "qkernel" else ""),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bytes": bytes_moved, "flops": flops})
    ragged_record(rec, ms, copies, library_graph)
    emit(rec)
    del pools, out, again, ref
    torch.cuda.empty_cache()
    return rec


# -- phases 3-5: the serving path ----------------------------------------------

def make_requests(np, seed, n=16):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(128, 1025))
        budget = int(rng.integers(32, 65))
        prompt = [int(t) for t in rng.integers(0, 32000, plen)]
        reqs.append((f"req{i}", prompt, budget))
    return reqs


def build_model(torch, cfg, seed):
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return LlamaForCausalLM(cfg, device="cuda", generator=gen)


def serve_phase(torch, np, model, reqs, layers, pipeline=None):
    """PagedDecoder.serve at full width, with the reference's default loop
    (pipeline None: the one-chunk lookahead) as "serve", or the serial
    loop (pipeline False) as "serve_serial"; returns (record, streams)."""
    from paddle_tpu_torch.kernels.flash_attention import _flash_bhsd
    from paddle_tpu_torch.kernels.ragged_paged_attention import (
        ragged_paged_attention)
    from paddle_tpu_torch.models.paged_decode import PagedDecoder
    phase = "serve" if pipeline is None else "serve_serial"
    dec = PagedDecoder(model, max_len=2048, block_size=64, max_slots=8,
                       num_blocks=257)
    check(dec.use_ragged_kernel, "ragged kernel is off on the card")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ragged_paged_attention.launches = 0
    zero_flash_counts(_flash_bhsd)
    zero_decoder_routes()
    t0 = time.perf_counter()
    out = dec.serve(reqs, chunk=8, pipeline=pipeline)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ragged_paged_attention.launches
    dec_routes = decoder_routes_without_plain(phase)
    check(dec_routes["decode"]["kernel"] == launches,
          f"{phase}: decode attention calls {dec_routes} against ragged "
          f"launches {launches}")
    check_served(dec, out, reqs, model.config.vocab_size)
    steps = dec.serve_stats["decode_steps"]
    check(launches == layers * steps,
          f"ragged launches {launches} != layers {layers} x decode steps "
          f"{steps}")
    rec = serve_record(torch, phase, dec, reqs, layers, wall, {
        "tokens_per_s_end_to_end": sum(b for _, _, b in reqs) / wall,
        "ragged_launches": launches, "decoder_route_launches": dec_routes,
        "flash_launches": _flash_bhsd.launches})
    emit(rec)
    del dec
    torch.cuda.empty_cache()
    return rec, out


def pipeline_stats(dec, phase):
    """The pipelined loop's counters of one fresh engine's serve, checked:
    every decode chunk a CUDA graph replay, six uploads at the start and
    six after each drain, and a lookahead exactly when the loop had it."""
    st = dec.serve_stats
    graphs = dec._chunk_graphs
    rec = {"pipeline": "serial" if phase.endswith("_serial")
           else "lookahead",
           "decode_ms_per_step": 1e3 * st["decode_s"] / st["decode_steps"],
           "chunk_dispatches": dec.chunk_dispatches,
           "lookahead_dispatches": dec.lookahead_dispatches,
           "h2d_uploads": dec.h2d_uploads,
           "pipeline_drains": dec.pipeline_drains,
           "graph_replays": graphs.replays,
           "graphs_captured": st["graphs_captured"],
           "capture_s": st["capture_s"]}
    check(graphs.replays == dec.chunk_dispatches == st["chunks"],
          f"{phase}: {graphs.replays} graph replays for "
          f"{dec.chunk_dispatches} chunk dispatches")
    check(dec.h2d_uploads == 6 * (dec.pipeline_drains + 1),
          f"{phase}: {dec.h2d_uploads} uploads, {dec.pipeline_drains} "
          f"drains")
    if rec["pipeline"] == "serial":
        check(dec.lookahead_dispatches == 0,
              f"{phase}: a lookahead dispatch in the serial loop")
    else:
        check(dec.lookahead_dispatches >= 1,
              f"{phase}: no lookahead dispatch")
    return rec


def serve_record(torch, phase, dec, reqs, layers, wall, extra):
    """The serve figures every serving phase prints."""
    st = dec.serve_stats
    decode_tokens = sum(b for _, _, b in reqs) - len(reqs)
    ttft = sorted(st["first_token_s"].values())
    rec = {"phase": phase, "model": "llama_2_7b widths, random weights",
           "dtype": "bfloat16", "layers": layers, "layers_cut": layers != 32,
           "requests": len(reqs),
           "prompt_lens": [len(p) for _, p, _ in reqs],
           "budgets": [b for _, _, b in reqs], "chunk": 8,
           "max_len": dec.max_len, "max_slots": dec.max_slots,
           "block_size": dec.block_size, "num_blocks": dec.num_blocks,
           "wall_s": wall, "prefill_s": st["prefill_s"],
           "decode_s": st["decode_s"], "decode_steps": st["decode_steps"],
           "chunks": st["chunks"], "decode_tokens": decode_tokens,
           "decode_tokens_per_s": decode_tokens / st["decode_s"],
           "ttft_p50_s": statistics.median(ttft), "ttft_max_s": ttft[-1],
           "peak_blocks": dec.allocator.peak_in_use,
           **pipeline_stats(dec, phase),
           "weight_bytes": dec.weight_stream_bytes["quant"],
           "weight_bytes_bf16": dec.weight_stream_bytes["bf16eq"],
           "pool_bytes": dec.pool_bytes(),
           "pool_bytes_bf16": 2 * dec.n_layers * dec.num_blocks
           * dec.block_size * dec.nkv * dec.hd * 2,
           "peak_device_bytes": torch.cuda.max_memory_allocated()}
    rec.update(extra)
    return rec


def check_served(dec, out, reqs, vocab):
    for rid, prompt, budget in reqs:
        toks = out[rid]
        check(len(toks) == budget, f"{rid}: {len(toks)} tokens, budget "
                                   f"{budget}")
        check(all(0 <= t < vocab for t in toks),
              f"{rid}: token out of the vocabulary")
    check(dec.allocator.in_use == 0, "blocks leaked after serve")


def serve_quant_phase(torch, np, model, reqs, layers, pipeline=None):
    """The quantized serving deployment: block-scaled int8 weights and an
    int8 paged KV pool, at phase 3's widths and requests. Every
    projection and the head go through quant_matmul: 7 per layer plus the
    head, once per decode step and once per prefill (the prefill's head
    multiplies the last token only); decode attention through the
    quantized ragged kernel, once per layer per decode step. Each prompt's
    prefill bucket has at least 128 rows (block_size 64 doubled up to the
    prompt, prompts 128-1024 tokens), so its 7 projections a layer take
    the tensor-core product (bf16 x, M > 32); every decode step's 7
    projections a layer (8 slots, bf16) take the tensor-core GEMV; every
    head (float32 x) takes the CUDA-core GEMV, once per decode step and
    once per prefill. pipeline False runs the serial loop
    ("serve_quant_serial"); returns (record, streams)."""
    from paddle_tpu_torch.kernels.quant_matmul import quant_matmul
    from paddle_tpu_torch.kernels.ragged_paged_attention import (
        ragged_paged_attention, ragged_paged_attention_quant)
    from paddle_tpu_torch.models.paged_decode import PagedDecoder
    phase = "serve_quant" if pipeline is None else "serve_quant_serial"
    dec = PagedDecoder(model, max_len=2048, block_size=64, max_slots=8,
                       num_blocks=257, weight_quant="int8_blockwise",
                       kv_quant="int8")
    check(dec.use_ragged_kernel, "ragged kernel is off on the card")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    quant_matmul.launches = 0
    for r in quant_matmul.route_launches:
        quant_matmul.route_launches[r] = 0
    ragged_paged_attention_quant.launches = 0
    ragged_paged_attention.launches = 0
    zero_decoder_routes()
    t0 = time.perf_counter()
    out = dec.serve(reqs, chunk=8, pipeline=pipeline)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    qmm, rq = quant_matmul.launches, ragged_paged_attention_quant.launches
    dec_routes = decoder_routes_without_plain(phase)
    routes = dict(quant_matmul.route_launches)
    check_served(dec, out, reqs, model.config.vocab_size)
    steps = dec.serve_stats["decode_steps"]
    per_pass = 7 * layers + 1
    check(rq == layers * steps and ragged_paged_attention.launches == 0,
          f"quantized ragged launches {rq} != layers {layers} x decode "
          f"steps {steps} (unquantized: {ragged_paged_attention.launches})")
    check(qmm == per_pass * (steps + len(reqs)),
          f"quant_matmul launches {qmm} != (7 x {layers} + 1) x (decode "
          f"steps {steps} + prefills {len(reqs)})")
    check(routes["wgmma"] == 7 * layers * len(reqs)
          and routes["gemv_tc"] == 7 * layers * steps
          and routes["rows"] == steps + len(reqs) and routes["tiled"] == 0,
          f"quant_matmul routes {routes}: want wgmma = 7 x {layers} layers "
          f"x {len(reqs)} prefills (every prefill projection: _prefill_paged"
          f" runs _qkv's 3, wo and _mlp's 3 a layer on a bucket of >= 128 "
          f"bf16 rows), gemv_tc = 7 x {layers} layers x {steps} decode "
          f"steps, rows = {steps} decode steps + {len(reqs)} prefills (the "
          f"float32 head) and no tiled launch")
    rec = serve_record(torch, phase, dec, reqs, layers, wall, {
        "weight_quant": "int8_blockwise", "kv_quant": "int8",
        "requests_cut": False, "quant_matmul_launches": qmm,
        "quant_matmul_launches_rule": "(7 x layers + 1) x (decode steps + "
                                      "prefills)",
        "quant_matmul_route_launches": routes,
        "wgmma_launches_rule": "7 x layers x prefills",
        "gemv_tc_launches_rule": "7 x layers x decode steps",
        "rows_launches_rule": "decode steps + prefills",
        "ragged_quant_launches": rq, "decoder_route_launches": dec_routes})
    emit(rec)
    del dec
    torch.cuda.empty_cache()
    return rec, out


def make_long_requests(np, seed, n=4):
    rng = np.random.default_rng(seed + 7)
    return [(f"long{i}", [int(t) for t in rng.integers(
        0, 32000, int(rng.integers(3000, 4001)))], 32) for i in range(n)]


def serve_long_phase(torch, np, model, reqs, layers):
    """The long-context deployment: 4 prompts of 3000-4000 tokens at
    max_len 4096, decode attention as 4-shard split-context partials (one
    launch per layer per decode step, all shards in it)."""
    from paddle_tpu_torch.kernels.ragged_paged_attention import (
        ragged_paged_attention, ragged_paged_attention_partials)
    from paddle_tpu_torch.models.paged_decode import PagedDecoder
    dec = PagedDecoder(model, max_len=4096, block_size=64, max_slots=4,
                       num_blocks=257, attn_shards=4)
    check(dec.use_ragged_kernel, "ragged kernel is off on the card")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ragged_paged_attention_partials.launches = 0
    ragged_paged_attention.launches = 0
    zero_decoder_routes()
    t0 = time.perf_counter()
    out = dec.serve(reqs, chunk=8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pl = ragged_paged_attention_partials.launches
    dec_routes = decoder_routes_without_plain("serve_long")
    check_served(dec, out, reqs, model.config.vocab_size)
    steps = dec.serve_stats["decode_steps"]
    check(pl == layers * steps and ragged_paged_attention.launches == 0
          and dec.sharded_attn_calls == steps,
          f"partials launches {pl} != layers {layers} x decode steps "
          f"{steps} (unsharded {ragged_paged_attention.launches}, sharded "
          f"steps {dec.sharded_attn_calls})")
    rec = serve_record(torch, "serve_long", dec, reqs, layers, wall, {
        "attn_shards": dec.attn_shards, "partials_launches": pl,
        "partials_launches_rule": "layers x decode steps (one launch "
                                  "holds every shard)",
        "decoder_route_launches": dec_routes})
    emit(rec)
    del dec
    torch.cuda.empty_cache()
    return rec


def quant_shard_parity_phase(torch, np, reqs, seed):
    """Float32, 4 layers (phase 4's model): the quantized ragged serve
    against the quantized dense serve, and attn_shards 2 and 4 against
    the unsharded ragged serve; every stream must be identical."""
    from paddle_tpu_torch.models.llama import llama_2_7b
    from paddle_tpu_torch.models.paged_decode import PagedDecoder
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama_2_7b(num_hidden_layers=4, dtype="float32")
    model = build_model(torch, cfg, seed + 1)
    runs = {}
    for key, kw in (("quant_ragged", dict(kv_quant="int8")),
                    ("quant_dense", dict(kv_quant="int8",
                                         ragged_kernel=False)),
                    ("ragged", {}), ("shards2", dict(attn_shards=2)),
                    ("shards4", dict(attn_shards=4))):
        dec = PagedDecoder(model, max_len=2048, block_size=64, max_slots=8,
                           num_blocks=257, **kw)
        runs[key] = dec.serve(reqs, chunk=8)
        del dec
    same = {}
    for a, b in (("quant_ragged", "quant_dense"), ("shards2", "ragged"),
                 ("shards4", "ragged")):
        same[f"{a}_vs_{b}"] = sum(runs[a][rid] == runs[b][rid]
                                  for rid, _, _ in reqs)
    agree = sum(runs["quant_ragged"][rid] == runs["ragged"][rid]
                for rid, _, _ in reqs)
    check(all(v == len(reqs) for v in same.values()),
          f"parity: identical streams {same} of {len(reqs)}")
    rec = {"phase": "quant_shards_parity", "dtype": "float32", "layers": 4,
           "requests": len(reqs), "identical_streams": same,
           "int8_kv_vs_float32_kv_identical_streams": agree}
    emit(rec)
    del model
    torch.cuda.empty_cache()
    return rec


def make_prefix_requests(np, seed, n=16, system=512, own=(64, 513),
                         budgets=(32, 65), vocab=32000):
    """n requests that share one `system`-token system prompt, each with
    its own tokens (counts drawn from `own`) and budget."""
    rng = np.random.default_rng(seed)
    shared = [int(t) for t in rng.integers(0, vocab, system)]
    reqs = []
    for i in range(n):
        mine = [int(t) for t in rng.integers(0, vocab,
                                             int(rng.integers(*own)))]
        reqs.append((f"req{i}", shared + mine, int(rng.integers(*budgets))))
    return reqs


PREFIX_SYSTEM = 512              # serve_prefix's shared system prompt
PREFIX_STATS = ("hits", "misses", "tokens_saved", "blocks_shared",
                "cow_copies", "evicted_blocks")


def cache_serve(torch, dec, reqs, phase, counter, layers, vocab):
    """One serve of a cache-on engine, with its counts: the cache's stats
    and the engine's prefill counters over this serve, the decode steps,
    the launches of `counter` (the decode kernel of the engine's pools)
    split into decode steps and warm-prefill calls, and checks: every
    request gets its budget, every block in use is the cache's, every
    decode chunk is a graph replay, and the kernel ran once a layer per
    decode step and per prefill call."""
    st0 = dict(dec.prefix_cache.stats)
    calls0, computed0 = dec.prefill_device_calls, dec.prefill_tokens_computed
    chunks0, replays0 = dec.chunk_dispatches, dec._chunk_graphs.replays
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counter.launches = 0
    zero_decoder_routes()
    t0 = time.perf_counter()
    out = dec.serve(reqs, chunk=8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counter.launches
    routes = decoder_routes_without_plain(phase)
    sst = dec.serve_stats
    steps, calls = sst["decode_steps"], dec.prefill_device_calls - calls0
    for rid, _, budget in reqs:
        check(len(out[rid]) == budget and all(0 <= t < vocab
                                               for t in out[rid]),
              f"{phase}: {rid} got {len(out[rid])} tokens of {budget}")
    check(dec.allocator.in_use == dec.prefix_cache.held_blocks,
          f"{phase}: {dec.allocator.in_use} blocks in use, the cache holds "
          f"{dec.prefix_cache.held_blocks}")
    chunks = dec.chunk_dispatches - chunks0
    check(dec._chunk_graphs.replays - replays0 == chunks == sst["chunks"],
          f"{phase}: {dec._chunk_graphs.replays - replays0} graph replays "
          f"for {chunks} chunks")
    check(launches == layers * (steps + calls)
          and routes["decode"]["kernel"] == launches,
          f"{phase}: {launches} launches for {layers} layers x ({steps} "
          f"decode steps + {calls} prefill calls); routes {routes}")
    ttft = sorted(sst["first_token_s"].values())
    rec = {"phase": phase, "requests": len(reqs), "wall_s": wall,
           "prefill_s": sst["prefill_s"], "ttft_p50_s":
           statistics.median(ttft), "ttft_max_s": ttft[-1],
           "decode_s": sst["decode_s"], "decode_steps": steps,
           "decode_ms_per_step": 1e3 * sst["decode_s"] / steps,
           "chunks": chunks, "graph_replays": chunks,
           "graphs_captured": sst["graphs_captured"],
           "capture_s": sst["capture_s"],
           "prefix_cache": {k: dec.prefix_cache.stats[k] - st0[k]
                            for k in PREFIX_STATS},
           "prefill_device_calls": calls,
           "prefill_tokens_computed": dec.prefill_tokens_computed
           - computed0,
           "prompt_tokens": sum(len(p) for _, p, _ in reqs),
           "launches": {"kernel": counter.__name__, "total": launches,
                        "decode": layers * steps,
                        "warm_prefill": layers * calls},
           "held_blocks": dec.prefix_cache.held_blocks,
           "peak_blocks": dec.allocator.peak_in_use,
           "peak_device_bytes": torch.cuda.max_memory_allocated()}
    return out, rec


def serve_prefix_phase(torch, np, model, layers, seed):
    """The prefix cache at full width (bf16): 16 requests sharing a
    512-token system prompt, each with 64-512 tokens of its own and a
    budget of 32-64, served twice by one cache-on engine, cold then warm.
    Each serve's line: prefill seconds, p50 TTFT, decode ms a step, the
    cache's counts, the prompt tokens computed, the ragged launches of
    decode and of the warm prefill, peak memory (`cache_serve`). The warm
    serve must find at least 90 % of its prompts' whole blocks cached;
    the count of warm streams identical to the cold ones is reported (in
    bf16 a prefill of other row counts may round differently and tip a
    near tie; the float32 gate is prefix_parity)."""
    from paddle_tpu_torch.kernels.ragged_paged_attention import (
        ragged_paged_attention)
    from paddle_tpu_torch.models.paged_decode import PagedDecoder
    reqs = make_prefix_requests(np, seed, system=PREFIX_SYSTEM)
    dec = PagedDecoder(model, max_len=2048, block_size=64, max_slots=8,
                       num_blocks=257, prefix_cache=True)
    check(dec.use_ragged_kernel, "ragged kernel is off on the card")
    vocab = model.config.vocab_size
    streams, recs = {}, {}
    for run in ("cold", "warm"):
        streams[run], recs[run] = cache_serve(
            torch, dec, reqs, f"serve_prefix_{run}", ragged_paged_attention,
            layers, vocab)
    whole = sum(len(p) // 64 * 64 for _, p, _ in reqs)
    saved = recs["warm"]["prefix_cache"]["tokens_saved"]
    check(saved >= 0.9 * whole, f"serve_prefix_warm: {saved} tokens saved "
                                f"of {whole} in whole prompt blocks")
    same = sum(streams["warm"][rid] == streams["cold"][rid]
               for rid, _, _ in reqs)
    # how far each warm stream follows its cold one before they part
    common = []
    for rid, _, _ in reqs:
        a, b = streams["warm"][rid], streams["cold"][rid]
        n = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        common.append(n)
    for run in ("cold", "warm"):
        recs[run].update({
            "model": "llama_2_7b widths, random weights",
            "dtype": "bfloat16", "layers": layers, "layers_cut": layers != 32,
            "system_prompt_tokens": PREFIX_SYSTEM,
            "prompt_lens": [len(p) for _, p, _ in reqs],
            "budgets": [b for _, _, b in reqs], "chunk": 8,
            "max_len": dec.max_len, "max_slots": dec.max_slots,
            "block_size": dec.block_size, "num_blocks": dec.num_blocks})
    recs["warm"].update({"whole_prompt_block_tokens": whole,
                         "warm_streams_identical_to_cold": same,
                         "warm_cold_common_prefix_tokens": common,
                         "prefill_s_warm_over_cold":
                         recs["warm"]["prefill_s"] / recs["cold"]["prefill_s"],
                         "ttft_p50_warm_over_cold":
                         recs["warm"]["ttft_p50_s"]
                         / recs["cold"]["ttft_p50_s"]})
    for run in ("cold", "warm"):
        emit(recs[run])
    del dec
    torch.cuda.empty_cache()
    return recs


def prefix_parity_phase(torch, np, model, seed):
    """Float32 at full width, 4 layers, TF32 off: token-identical streams
    of cache-off, cache-on cold and cache-on warm serves (8 requests
    sharing a 512-token system prompt); a second turn of two of them
    (prompt + reply + 64 new tokens) against cache-off; cold against warm
    with an int8 pool and with 4 shards; prefill_chunk 256 on a
    1000-token prompt against the single-shot warm prefill; and a serve
    after every free block is poisoned with NaN against the cold streams.
    Records the int8 and sharded engines' kernel launches (decode and warm
    prefill), the kernels-line rows of those kernels at this shape."""
    from paddle_tpu_torch.kernels import ragged_paged_attention as rpa
    from paddle_tpu_torch.models.paged_decode import PagedDecoder
    reqs = make_prefix_requests(np, seed, n=8, own=(64, 257),
                                budgets=(16, 33))
    vocab = model.config.vocab_size
    layers = model.config.num_hidden_layers

    def engine(**kw):
        return PagedDecoder(model, max_len=2048, block_size=64, max_slots=8,
                            num_blocks=257, **kw)

    def same(a, b):
        return sum(a[rid] == b[rid] for rid in a)

    rec = {"phase": "prefix_parity", "dtype": "float32", "layers": layers,
           "requests": len(reqs), "identical_streams": {}}
    ident = rec["identical_streams"]
    off = engine()
    ref = off.serve(reqs, chunk=8)
    on = engine(prefix_cache=True)
    cold, rec["cold"] = cache_serve(torch, on, reqs, "prefix_parity_cold",
                                    rpa.ragged_paged_attention, layers,
                                    vocab)
    warm, rec["warm"] = cache_serve(torch, on, reqs, "prefix_parity_warm",
                                    rpa.ragged_paged_attention, layers,
                                    vocab)
    ident["cold_vs_off"] = same(cold, ref)
    ident["warm_vs_off"] = same(warm, ref)
    rng = np.random.default_rng(seed + 1)
    turn1 = [(f"{rid}:t1", p + ref[rid] + [int(t) for t in
                                          rng.integers(0, vocab, 64)], b)
             for rid, p, b in reqs[:2]]
    saved0 = on.prefix_cache.stats["tokens_saved"]
    t1_on = on.serve(turn1, chunk=8)
    ident["turn1_vs_off"] = same(t1_on, off.serve(turn1, chunk=8))
    rec["turn1_tokens_saved"] = on.prefix_cache.stats["tokens_saved"] - saved0
    check(rec["turn1_tokens_saved"] >= sum(
        len(p) + b - 64 for _, p, b in reqs[:2]),
        f"prefix_parity: turn 1 saved {rec['turn1_tokens_saved']} tokens")
    on.prefix_cache.evict(on.prefix_cache.held_blocks)
    free = [b for b in range(1, on.num_blocks)
            if on.allocator.refcount(b) == 0]
    check(len(free) == on.num_blocks - 1, "prefix_parity: blocks held after "
                                          "the cache was emptied")
    on.poison_blocks(free)
    q0 = on.quarantines
    ident["poisoned_vs_cold"] = same(on.serve(reqs, chunk=8), cold)
    # the kernels read no position past a row's length: not one poisoned
    # value reaches a logit (the dense route would read them as 0 x NaN)
    rec["poisoned_quarantines"] = on.quarantines - q0
    check(rec["poisoned_quarantines"] == 0,
          f"prefix_parity: {rec['poisoned_quarantines']} quarantines after "
          f"the free blocks were poisoned")
    del off, on
    for key, kw, counter in (
            ("int8", dict(kv_quant="int8"), rpa.ragged_paged_attention_quant),
            ("shards4", dict(attn_shards=4),
             rpa.ragged_paged_attention_partials)):
        dec = engine(prefix_cache=True, **kw)
        c, rc = cache_serve(torch, dec, reqs, f"prefix_parity_{key}_cold",
                            counter, layers, vocab)
        w, rw = cache_serve(torch, dec, reqs, f"prefix_parity_{key}_warm",
                            counter, layers, vocab)
        ident[f"{key}_warm_vs_cold"] = same(w, c)
        rec[key] = {"cold": rc, "warm": rw}
        del dec
    long = [("long", [int(t) for t in rng.integers(0, vocab, 1000)], 16)]
    chunked = engine(prefix_cache=True, prefill_chunk=256)
    single = engine(prefix_cache=True)
    ident["prefill_chunk256_vs_single"] = same(chunked.serve(long, chunk=8),
                                               single.serve(long, chunk=8))
    rec["prefill_chunk256_calls"] = chunked.prefill_device_calls
    check(chunked.prefill_device_calls == 4
          and single.prefill_device_calls == 1,
          f"prefix_parity: {chunked.prefill_device_calls} windows of 256 "
          f"for 1000 tokens")
    del chunked, single
    want = {k: 1 if k == "prefill_chunk256_vs_single"
            else 2 if k == "turn1_vs_off" else len(reqs) for k in ident}
    check(ident == want, f"prefix_parity: identical streams {ident} of "
                         f"{want}")
    emit(rec)
    torch.cuda.empty_cache()
    return rec


def quarantine_phase(torch, np, model, seed):
    """The fault plan of the reference's one-chunk-late test (logits_poison
    at p 1 on the first two coins) on the float32 4-layer model, on serve
    with the lookahead (pipeline None) and without (False): the streams
    must equal the unpoisoned serial serve's, with at least one quarantine
    and one replay, every decode chunk a graph replay. Reports uploads
    (the poison column's one-column upload among them) and drains."""
    from paddle_tpu_torch.models.paged_decode import PagedDecoder
    from paddle_tpu_torch.resilience import faults
    reqs = make_requests(np, seed, n=8)
    plan = {"seed": 7, "sites": {
        "logits_poison": {"p": 1.0, "window": [0, 2]}}}

    def engine():
        return PagedDecoder(model, max_len=2048, block_size=64, max_slots=8,
                            num_blocks=257)

    ref = engine().serve(reqs, chunk=8, pipeline=False)
    rec = {"phase": "quarantine", "dtype": "float32",
           "layers": model.config.num_hidden_layers, "requests": len(reqs),
           "plan": plan}
    for pipeline in (None, False):
        dec = engine()
        faults.install_plan(plan)
        try:
            out = dec.serve(reqs, chunk=8, pipeline=pipeline)
        finally:
            faults.clear()
        key = "lookahead" if pipeline is None else "serial"
        rec[key] = {c: getattr(dec, c) for c in (
            "quarantines", "replays", "replay_giveups", "h2d_uploads",
            "pipeline_drains", "chunk_dispatches", "lookahead_dispatches")}
        rec[key]["graph_replays"] = dec._chunk_graphs.replays
        rec[key]["identical_streams"] = sum(out[r] == ref[r]
                                            for r, _, _ in reqs)
        check(out == ref, f"quarantine ({key}): {rec[key]}")
        check(dec.quarantines >= 1 and dec.replays >= 1
              and dec._chunk_graphs.replays == dec.chunk_dispatches,
              f"quarantine ({key}): {rec[key]}")
        del dec
    emit(rec)
    torch.cuda.empty_cache()
    return rec


def prefix_phases(torch, np, seed):
    """prefix_parity and quarantine on one float32 model at Llama-2-7B
    widths, 4 layers, TF32 off."""
    from paddle_tpu_torch.models.llama import llama_2_7b
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = build_model(torch, llama_2_7b(num_hidden_layers=4,
                                          dtype="float32"), seed + 1)
    parity = prefix_parity_phase(torch, np, model, seed + 2)
    quarantine = quarantine_phase(torch, np, model, seed + 3)
    del model
    torch.cuda.empty_cache()
    return parity, quarantine


def profile_phase(torch, model, reqs, phase="profile", parent=None,
                  **engine_kw):
    """--profile only: a short serve at full width (8 requests, budgets
    cut to 16), run once plainly for its wall time and once under
    torch.profiler for the device time of each kernel. The device's idle
    share is 1 - (kernel time under the profiler) / (plain wall time):
    the profiler slows the host, not the kernels. engine_kw replaces the
    engine's configuration (serve_quant's, serve_long's); parent, a parent
    checkout whose libraries the caller swapped in, names its kernels."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.models.paged_decode import PagedDecoder
    PORT_KERNEL = port_kernel_pattern(parent)
    kw = dict(max_len=2048, block_size=64, max_slots=8, num_blocks=257)
    kw.update(engine_kw)
    dec = PagedDecoder(model, **kw)
    short = [(rid, p, 16) for rid, p, _ in reqs[:8]]
    dec.serve(short[:1], chunk=8)                        # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec.serve(short, chunk=8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = dict(dec.serve_stats)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dec.serve(short, chunk=8)
        torch.cuda.synchronize()
    rows, busy_s = device_kernel_rows(prof)
    # the same prefills alone (budget 1: no decode step), so that the
    # decode's own device time is the difference
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof_p:
        dec.serve([(rid, p, 1) for rid, p, _ in short], chunk=8)
        torch.cuda.synchronize()
    prefill_rows, prefill_busy_s = device_kernel_rows(prof_p)
    decode_busy_s = busy_s - prefill_busy_s
    measured = bool(rows and prefill_rows)
    rec = {"phase": phase, "engine": kw, "requests": len(short),
           "budget": 16, "wall_s": wall,
           "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
           "decode_steps": st["decode_steps"],
           "decode_ms_per_step": 1e3 * st["decode_s"] / st["decode_steps"],
           "device_busy_s": busy_s if rows else "not measured",
           "device_idle_share": 1 - busy_s / wall if rows
           else "not measured",
           "decode_busy_ms_per_step": 1e3 * decode_busy_s
           / st["decode_steps"] if measured else "not measured",
           "decode_idle_share": 1 - decode_busy_s / st["decode_s"]
           if measured else "not measured",
           "top_device_kernels": top_kernels(rows, busy_s, 12),
           # the port's own kernels, whatever their rank
           "port_kernels": top_kernels(
               [r for r in rows if PORT_KERNEL.search(r[1])], busy_s,
               len(rows))}
    emit(rec)
    del dec
    torch.cuda.empty_cache()
    return rec


def port_kernel_pattern(parent=None):
    """A pattern that finds the name of any of the port's CUDA kernels
    (every __global__ function in csrc/, and in a parent checkout's) in a
    profiler's kernel name."""
    from pathlib import Path
    from paddle_tpu_torch.kernels import _build
    decl = (r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*"
            r"\)\s*)?(\w+)\s*\(")
    dirs = [_build.CSRC] + ([Path(parent, "paddle_tpu_torch", "csrc")]
                            if parent else [])
    names = {n for d in dirs for f in d.glob("*.cu*")
             for n in re.findall(decl, f.read_text())}
    return re.compile(rf"\b({'|'.join(sorted(names))})\b")


def device_kernel_rows(prof):
    """[(device us, kernel name, calls)] of a torch.profiler run, largest
    first, and the device's busy seconds. Kernels only: an operator's row
    repeats the device time of the kernels it launched."""
    from torch.autograd import DeviceType
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, evt.key, evt.count))
    rows.sort(reverse=True)
    return rows, sum(r[0] for r in rows) / 1e6


def top_kernels(rows, busy_s, n):
    return [{"name": k[:200], "device_ms": us / 1e3, "calls": c,
             "share_of_device": us / 1e6 / busy_s} for us, k, c in rows[:n]]


def parity_phase(torch, np, reqs, seed):
    from paddle_tpu_torch.models.llama import llama_2_7b
    from paddle_tpu_torch.models.paged_decode import PagedDecoder
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama_2_7b(num_hidden_layers=4, dtype="float32")
    model = build_model(torch, cfg, seed + 1)
    streams, lookahead = {}, {}
    for ragged in (True, False):
        dec = PagedDecoder(model, max_len=2048, block_size=64, max_slots=8,
                           num_blocks=257, ragged_kernel=ragged)
        streams[ragged] = dec.serve(reqs, chunk=8)
        lookahead[ragged] = pipeline_stats(dec, "ragged_vs_dense")
        del dec
    same = sum(streams[True][rid] == streams[False][rid]
               for rid, _, _ in reqs)
    check(same == len(reqs), f"ragged vs dense: {len(reqs) - same} of "
                             f"{len(reqs)} streams differ")
    oracle = 0
    for rid, prompt, budget in reqs[:2]:
        ref = model.generate(torch.tensor([prompt]), max_new_tokens=budget)
        check(streams[True][rid] == ref[0, len(prompt):].tolist(),
              f"{rid}: serve differs from full-forward generate")
        oracle += 1
    rec = {"phase": "ragged_vs_dense", "dtype": "float32", "layers": 4,
           "requests": len(reqs), "identical_streams": same,
           "full_forward_oracle_streams": oracle,
           "pipeline": {"ragged": lookahead[True],
                        "dense": lookahead[False]}}
    emit(rec)
    del model
    torch.cuda.empty_cache()
    return rec


def generate_phase(torch, np, model, layers, seed):
    """CachedDecoder.generate at full width, greedy: the prefill, then the
    fused chunks (31 steps after the prefill's token: 16, 8, 4 and 2, each
    a CUDA graph, and one single step). The first call captures the
    graphs; the second is timed."""
    from paddle_tpu_torch.kernels.flash_attention import _flash_bhsd
    from paddle_tpu_torch.models.decode import CachedDecoder
    B, S0, N = 4, 1024, 32
    dec = CachedDecoder(model, max_len=S0 + N)
    ids = torch.as_tensor(np.random.default_rng(seed + 2).integers(
        0, 32000, (B, S0)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = dec.generate(ids, max_new_tokens=N)
    torch.cuda.synchronize()
    first_wall = time.perf_counter() - t0
    graphs = dec._gen_graphs
    replays0 = graphs.replays
    zero_flash_counts(_flash_bhsd)
    zero_attention_routes()
    zero_decoder_routes()
    t0 = time.perf_counter()
    out = dec.generate(ids, max_new_tokens=N)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _flash_bhsd.launches
    routes = dict(_flash_bhsd.route_launches)
    attn_routes = attention_routes_without_plain("generate")
    dec_routes = decoder_routes_without_plain("generate")
    check(dec_routes["prefill"]["kernel"] == launches,
          f"generate: prefill attention calls {dec_routes} against flash "
          f"launches {launches}")
    check(tuple(out.shape) == (B, S0 + N), f"generate shape {out.shape}")
    check(bool((out[:, :S0] == ids).all()), "generate changed the prompt")
    check(bool(((out >= 0) & (out < 32000)).all()), "token out of vocab")
    check(launches == layers * 1,
          f"flash launches {launches} != {layers} layers x 1 prefill")
    check(routes["wgmma"] == launches,
          f"every prefill forward runs on the tensor cores: {routes}")
    check(torch.equal(out, first), "generate: a replayed greedy call "
                                   "differs from the capturing one")
    check(graphs.captured == 4 and graphs.replays - replays0 == 4,
          f"generate: {graphs.captured} graphs, "
          f"{graphs.replays - replays0} replays in the timed call (want 4 "
          f"chunks: 16, 8, 4, 2)")
    rec = {"phase": "generate", "dtype": "bfloat16", "layers": layers,
           "batch": B, "prompt_len": S0, "new_tokens": N, "wall_s": wall,
           "tokens_per_s": B * N / wall, "first_call_wall_s": first_wall,
           "graphs_captured": graphs.captured,
           "capture_s": graphs.capture_s, "chunk_lengths": [16, 8, 4, 2],
           "flash_launches": launches,
           "flash_route_launches": routes,
           "attention_route_launches": attn_routes,
           "decoder_route_launches": dec_routes,
           "peak_device_bytes": torch.cuda.max_memory_allocated()}
    emit(rec)
    del dec
    torch.cuda.empty_cache()
    return rec


def generate_sample_phase(torch, np, model, layers, seed):
    """generate_sample: CachedDecoder.generate with do_sample at full
    width (batch 4, 1024-token prompts, 64 new tokens: chunks of 32, 16,
    8, 4 and 2 and one single step; temperature 0.8, top_k 50, top_p 0.9)
    from a seeded CUDA generator. The first call captures; the second,
    timed, must reproduce it under the same seed; another seed must give
    other tokens; and the per-token loop (CHUNK 1, no graph) must give the
    fused chunks' tokens under the same seed."""
    from paddle_tpu_torch.models.decode import CachedDecoder
    B, S0, N = 4, 1024, 64
    dec = CachedDecoder(model, max_len=S0 + N)
    ids = torch.as_tensor(np.random.default_rng(seed + 3).integers(
        0, 32000, (B, S0)))
    kw = dict(max_new_tokens=N, do_sample=True, temperature=0.8, top_k=50,
              top_p=0.9)

    def gen(s):
        g = torch.Generator(device="cuda")
        g.manual_seed(s)
        return g

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = dec.generate(ids, generator=gen(seed), **kw)
    torch.cuda.synchronize()
    first_wall = time.perf_counter() - t0
    graphs = dec._gen_graphs
    captured, capture_s = graphs.captured, graphs.capture_s
    t0 = time.perf_counter()
    again = dec.generate(ids, generator=gen(seed), **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    other = dec.generate(ids, generator=gen(seed + 1), **kw)
    check(torch.equal(again, first), "generate_sample: the same seed gave "
                                     "other tokens")
    check(not torch.equal(other[:, S0:], first[:, S0:]),
          "generate_sample: another seed gave the same tokens")
    check(captured == 5, f"generate_sample: {captured} graphs (want 32, 16,"
                         f" 8, 4, 2)")
    check(bool((first[:, :S0] == ids).all()), "generate changed the prompt")
    check(bool(((first >= 0) & (first < 32000)).all()), "token out of vocab")
    peak = torch.cuda.max_memory_allocated()
    dec.CHUNK = 1
    t0 = time.perf_counter()
    per_token = dec.generate(ids, generator=gen(seed), **kw)
    torch.cuda.synchronize()
    per_token_wall = time.perf_counter() - t0
    same = int((per_token == first).all(dim=1).sum())
    check(same == B, f"generate_sample: the per-token loop differs from the "
                     f"fused chunks in {B - same} of {B} rows")
    rec = {"phase": "generate_sample", "dtype": "bfloat16", "layers": layers,
           "batch": B, "prompt_len": S0, "new_tokens": N,
           "temperature": 0.8, "top_k": 50, "top_p": 0.9, "wall_s": wall,
           "tokens_per_s": B * N / wall, "first_call_wall_s": first_wall,
           "graphs_captured": captured, "capture_s": capture_s,
           "per_token_wall_s": per_token_wall,
           "per_token_tokens_per_s": B * N / per_token_wall,
           "same_seed_identical": True, "other_seed_differs": True,
           "per_token_identical_rows": same, "peak_device_bytes": peak}
    emit(rec)
    del dec
    torch.cuda.empty_cache()
    return rec


def chunk_graph_phase(torch, np, model, seed):
    """chunk_graph: at full width, a captured paged chunk (8 steps, 8
    slots: one not live, budgets that end inside the chunk, random pool
    contents) replayed twice, each time against `_paged_chunk_state`
    called eagerly on clones of the same state and pools: the tokens, the
    flags, the advanced state and every byte of the pools' blocks (all but
    the trash block) must be identical, in bf16 and with the int8 pool,
    and each replay must add layers x 8 to
    the ragged kernel's launch count (the capture and its warm-up add
    nothing)."""
    from paddle_tpu_torch.kernels.ragged_paged_attention import (
        ragged_paged_attention, ragged_paged_attention_quant)
    from paddle_tpu_torch.models.paged_decode import (PagedDecoder,
                                                     QuantizedPool)
    rng = np.random.default_rng(seed)
    layers = model.config.num_hidden_layers
    recs = {}
    for name, kw in (("bf16", {}), ("int8_pool", {"kv_quant": "int8"})):
        dec = PagedDecoder(model, max_len=2048, block_size=64, max_slots=8,
                           num_blocks=97, **kw)
        S, MB, n, per = dec.max_slots, dec.blocks_per_seq, 8, 12
        kpool, vpool = dec.serve_pools()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        for pool in (kpool, vpool):
            if isinstance(pool, QuantizedPool):
                pool.codes.copy_(torch.randint(
                    -127, 128, pool.codes.shape, generator=gen,
                    device="cuda", dtype=torch.int8))
                pool.scales.copy_(torch.rand(
                    pool.scales.shape, generator=gen, device="cuda")
                    * 0.02 + 1e-3)
            else:
                pool.normal_(generator=gen)
        tables = np.zeros((S, MB), np.int32)
        for i in range(S):
            tables[i, :per] = np.arange(1 + per * i, 1 + per * (i + 1))
        live = np.ones(S, bool)
        live[5] = False
        dec.upload_state(rng.integers(0, 32000, S).astype(np.int32),
                         rng.integers(64, per * 64 - 2 * n, S).astype(
                             np.int32), tables, live,
                         rng.integers(1, 2 * n, S).astype(np.int32),
                         np.zeros(S, bool))
        counter = (ragged_paged_attention_quant if kw
                   else ragged_paged_attention)

        def leaves(pool):
            # every block but the trash block 0, which inactive slots
            # write, no live slot reads, and the capture's warm-up (no
            # slot live) writes too
            return ([pool.codes[:, 1:], pool.scales[:, 1:]]
                    if isinstance(pool, QuantizedPool) else [pool[:, 1:]])

        def clone_pool(pool):
            if isinstance(pool, QuantizedPool):
                return QuantizedPool(pool.codes.clone(), pool.scales.clone())
            return pool.clone()

        identical = []
        moved = []
        for _ in range(2):
            st0 = [t.clone() for t in dec.decode_state()]
            kc, vc = clone_pool(kpool), clone_pool(vpool)
            torch.cuda.synchronize()
            before = counter.launches
            toks, bad = dec.dispatch_chunk_state(n)
            torch.cuda.synchronize()
            moved.append(counter.launches - before)
            got = [toks.clone(), bad.clone()] + [
                t.clone() for t in dec.decode_state()]
            ref = dec._paged_chunk_state(*st0, kc, vc, n)
            torch.cuda.synchronize()
            want = [ref[0], ref[1], ref[2], ref[3], st0[2], ref[4], ref[5],
                    st0[5]]
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            for a, b in zip(leaves(kpool) + leaves(vpool),
                            leaves(kc) + leaves(vc)):
                same = same and torch.equal(a.contiguous().view(torch.uint8),
                                            b.contiguous().view(torch.uint8))
            identical.append(same)
        check(all(identical), f"chunk_graph {name}: replay against eager "
                              f"{identical}")
        check(moved == [layers * n] * 2,
              f"chunk_graph {name}: launches per replay {moved}, want "
              f"{layers * n}")
        recs[name] = {"identical_replays": sum(identical),
                      "launches_per_replay": moved,
                      "graphs_captured": dec._chunk_graphs.captured,
                      "capture_s": dec._chunk_graphs.capture_s}
        del dec, kpool, vpool, kc, vc
        torch.cuda.empty_cache()
    rec = {"phase": "chunk_graph", "layers": layers, "steps": 8,
           "slots": 8, "cases": recs}
    emit(rec)
    return rec


# -- phases 6-7: the training path ---------------------------------------------

TRAIN_LAYERS = 4                 # bench.py's one-chip configuration
TRAIN_BATCH, TRAIN_SEQ = 6, 2048
TRAIN_WARMUP, TRAIN_TIMED = 2, 10


def train_config():
    from paddle_tpu_torch.models.llama import LlamaConfig
    return LlamaConfig(vocab_size=32000, hidden_size=4096,
                       intermediate_size=11008,
                       num_hidden_layers=TRAIN_LAYERS,
                       num_attention_heads=32, num_key_value_heads=32,
                       max_position_embeddings=2048, dtype="bfloat16",
                       recompute=False)


def make_train_step(torch, cfg, seed, lr=1e-4, moment_dtype="bfloat16"):
    from paddle_tpu_torch import (AdamW, LlamaPretrainingCriterion,
                                  TrainStep)
    model = build_model(torch, cfg, seed)
    crit = LlamaPretrainingCriterion(cfg)
    opt = AdamW(learning_rate=lr, parameters=model.parameters(),
                moment_dtype=moment_dtype)
    return model, TrainStep(model, lambda lo, la: crit(lo, la), opt)


def train_batch(torch, np, seed, vocab, batch, seq):
    rng = np.random.default_rng(seed)
    ids = torch.as_tensor(rng.integers(0, vocab, (batch, seq)),
                          device="cuda")
    labels = torch.as_tensor(rng.integers(0, vocab, (batch, seq)),
                             device="cuda")
    return ids, labels


def train_phase(torch, np, seed):
    from paddle_tpu_torch.kernels.flash_attention import (_flash_bhsd,
                                                          _flash_bhsd_bwd)
    from paddle_tpu_torch.observability import model_flops_per_token
    cfg = train_config()
    model, step = make_train_step(torch, cfg, seed)
    n_params = sum(p.numel() for p in model.parameters())
    ids, labels = train_batch(torch, np, seed + 3, cfg.vocab_size,
                              TRAIN_BATCH, TRAIN_SEQ)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_flash_counts(_flash_bhsd, _flash_bhsd_bwd)
    zero_attention_routes()
    losses = [step((ids,), (labels,)) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED):
        losses.append(step((ids,), (labels,)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = _flash_bhsd.launches, _flash_bhsd_bwd.launches
    fwd_routes = dict(_flash_bhsd.route_launches)
    routes = dict(_flash_bhsd_bwd.route_launches)
    attn_routes = attention_routes_without_plain("train")
    losses = [x.item() for x in losses]
    steps = TRAIN_WARMUP + TRAIN_TIMED
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    layers = cfg.num_hidden_layers
    check(fwd == layers * steps and bwd == layers * steps,
          f"flash launches fwd {fwd}, bwd {bwd} != {layers} layers x "
          f"{steps} steps")
    check(fwd_routes["wgmma"] == layers * steps,
          f"every train forward runs on the tensor cores: {fwd_routes}")
    check(routes["wgmma"] == layers * steps,
          f"every train backward runs on the tensor cores: {routes}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    tps = tokens * TRAIN_TIMED / wall
    flops_tok = model_flops_per_token(cfg, TRAIN_SEQ, n_params)
    rec = {"phase": "train", "model": "bench.py one-chip Llama, random "
                                      "weights",
           "dtype": cfg.dtype, "layers": cfg.num_hidden_layers,
           "hidden": cfg.hidden_size, "ffn": cfg.intermediate_size,
           "heads": cfg.num_attention_heads, "vocab": cfg.vocab_size,
           "params": n_params,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "optimizer": "AdamW lr 1e-4, bf16 moments",
           "warmup_steps": TRAIN_WARMUP, "timed_steps": TRAIN_TIMED,
           "wall_s": wall, "s_per_step": wall / TRAIN_TIMED,
           "tokens_per_s": tps, "model_flops_per_token": flops_tok,
           "mfu": flops_tok * tps / BF16_FLOPS, "losses": losses,
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "flash_fwd_launches": fwd, "flash_bwd_launches": bwd,
           "flash_fwd_route_launches": fwd_routes,
           "flash_bwd_route_launches": routes,
           "attention_route_launches": attn_routes}
    emit(rec)
    del model, step
    torch.cuda.empty_cache()
    return rec


def train_profile_phase(torch, np, seed, steps=2, phase="train_profile",
                        build=None):
    """--profile only: `steps` train steps at the train phase's shapes (or
    those `build(seed)` gives: model, step, ids, labels), run once plainly
    for their wall time and once under torch.profiler for the device time
    by kernel, grouped into the flash kernels, quant_matmul's, matrix
    products (cuBLAS/CUTLASS GEMMs) and the rest (element-wise,
    reductions, AdamW)."""
    from torch.profiler import ProfilerActivity, profile
    if build is None:
        cfg = train_config()
        model, step = make_train_step(torch, cfg, seed)
        ids, labels = train_batch(torch, np, seed + 3, cfg.vocab_size,
                                  TRAIN_BATCH, TRAIN_SEQ)
    else:
        model, step, ids, labels = build(seed)
    step((ids,), (labels,))                               # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step((ids,), (labels,))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step((ids,), (labels,))
        torch.cuda.synchronize()
    rows, busy_s = device_kernel_rows(prof)
    groups = {"flash_fwd": 0.0, "flash_bwd": 0.0, "quant_matmul": 0.0,
              "gemm": 0.0, "other": 0.0}
    for us, name, _ in rows:
        if "flash_fwd" in name:
            groups["flash_fwd"] += us / 1e6
        elif "flash_bwd" in name:
            groups["flash_bwd"] += us / 1e6
        elif "qmm_" in name:
            groups["quant_matmul"] += us / 1e6
        elif any(t in name.lower() for t in ("gemm", "nvjet", "cutlass",
                                             "xmma")):
            groups["gemm"] += us / 1e6
        else:
            groups["other"] += us / 1e6
    rec = {"phase": phase, "steps": steps, "wall_s": wall,
           "s_per_step": wall / steps,
           "device_busy_s": busy_s if rows else "not measured",
           "device_idle_share": 1 - busy_s / wall if rows
           else "not measured",
           "device_s_per_step_by_group": {
               k: v / steps for k, v in groups.items()},
           "top_device_kernels": top_kernels(rows, busy_s, 15)}
    emit(rec)
    del model, step
    torch.cuda.empty_cache()
    return rec


PARITY_STEPS = 3
PARITY_LOSS_RTOL = 1e-5          # float32, summation order only
PARITY_GRAD_ATOL = 1e-4          # of each gradient's largest magnitude


def train_parity_phase(torch, np, seed):
    """The flash kernels inside whole training steps against the plain
    attention (use_flash_attention=False, a config of the JAX package), in
    float32 on the card with TF32 off."""
    from paddle_tpu_torch.kernels.flash_attention import (_flash_bhsd,
                                                          _flash_bhsd_bwd)
    from paddle_tpu_torch.models.llama import LlamaConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ids, labels = train_batch(torch, np, seed + 4, 1024, 2, 256)
    runs = {}
    for flash in (True, False):
        cfg = LlamaConfig(vocab_size=1024, hidden_size=512,
                          intermediate_size=1024, num_hidden_layers=2,
                          num_attention_heads=4, num_key_value_heads=4,
                          max_position_embeddings=256, dtype="float32",
                          use_flash_attention=flash)
        model, step = make_train_step(torch, cfg, seed + 5,
                                      moment_dtype=None)
        zero_flash_counts(_flash_bhsd, _flash_bhsd_bwd)
        losses, grads = [], None
        for i in range(PARITY_STEPS):
            losses.append(step((ids,), (labels,)).item())
            if i == 0:
                grads = {k: p.grad.clone()
                         for k, p in model.named_parameters()}
        runs[flash] = (losses, grads, _flash_bhsd.launches,
                       _flash_bhsd_bwd.launches,
                       dict(_flash_bhsd.route_launches),
                       dict(_flash_bhsd_bwd.route_launches))
        del model, step
    (fl, fg, ff, fb, fwd_routes, routes), (pl_, pg, pf, pb, _, _) = \
        runs[True], runs[False]
    check(ff == fb == 2 * PARITY_STEPS and pf == pb == 0,
          f"flash launches: kernels run {ff}/{fb}, plain run {pf}/{pb}")
    check(fwd_routes["cuda_core"] == ff,
          f"float32 forwards run on the CUDA cores: {fwd_routes}")
    check(routes["cuda_core"] == fb,
          f"float32 backwards run on the CUDA cores: {routes}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(fl, pl_))
    grad_rel = max(((fg[k] - pg[k]).abs().max()
                    / pg[k].abs().max()).item() for k in pg)
    check(loss_rel <= PARITY_LOSS_RTOL and grad_rel <= PARITY_GRAD_ATOL,
          f"flash vs plain training: loss rel {loss_rel}, step-1 grad "
          f"{grad_rel} of the largest element")
    rec = {"phase": "train_parity", "dtype": "float32", "layers": 2,
           "hidden": 512, "heads": 4, "seq": 256, "batch": 2,
           "steps": PARITY_STEPS, "losses_flash": fl, "losses_plain": pl_,
           "max_loss_rel_diff": loss_rel, "loss_rtol": PARITY_LOSS_RTOL,
           "max_grad_diff_over_max": grad_rel,
           "grad_atol_of_max": PARITY_GRAD_ATOL,
           "flash_fwd_launches": ff, "flash_bwd_launches": fb,
           "flash_fwd_route_launches": fwd_routes,
           "flash_bwd_route_launches": routes}
    emit(rec)
    torch.cuda.empty_cache()
    return rec


# -- phase 7b: GPT-2 124M pretraining (benchmarks/gpt2_dp.py) -----------------

GPT2_BATCH, GPT2_SEQ = 8, 1024   # benchmarks/gpt2_dp.py:22 on its chip
GPT2_SCHED_STEPS = 5
GPT2_PARITY_LAYERS, GPT2_PARITY_BATCH = 2, 2


def gpt2_config(**overrides):
    """benchmarks/gpt2_dp.py:40-45 on its chip: GPT-2 124M at the GPT-2
    vocabulary of 50257 (not gpt2_124m's 50304), bf16, dropout 0.1."""
    from paddle_tpu_torch.models.gpt import gpt2_124m
    kw = dict(vocab_size=50257, dtype="bfloat16")
    kw.update(overrides)
    return gpt2_124m(**kw)


def gpt2_loss(logits, labels):
    """The benchmark's loss_fn: CrossEntropyLoss on the flattened float32
    logits."""
    from paddle_tpu_torch.nn import CrossEntropyLoss
    v = logits.shape[-1]
    return CrossEntropyLoss()(logits.reshape(-1, v).float(),
                              labels.reshape(-1))


def make_gpt2_step(torch, cfg, seed, lr=1e-4, **opt_kw):
    """The benchmark's model (built with no device: the card), AdamW and
    TrainStep; weights, then dropout masks, from a seeded CUDA
    generator."""
    from paddle_tpu_torch import AdamW, GPTForCausalLM, TrainStep
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    model = GPTForCausalLM(cfg, generator=gen)
    check(model.device.type == "cuda", f"GPTForCausalLM built on "
                                       f"{model.device}, not the card")
    opt = AdamW(learning_rate=lr, parameters=model.parameters(), **opt_kw)
    return model, TrainStep(model, gpt2_loss, opt)


def gpt2_batch(torch, np, seed, cfg, batch=GPT2_BATCH, seq=GPT2_SEQ):
    return train_batch(torch, np, seed, cfg.vocab_size, batch, seq)


def train_gpt2_phase(torch, np, seed, phase="train_gpt2", sched=False,
                     beside=None):
    """The benchmark's training: GPT-2 124M (12 layers, hidden 768, 12
    heads of dim 64, FFN 3072, vocab 50257, dropout 0.1, bf16), batch 8 x
    1024, AdamW at lr 1e-4 under TrainStep, 2 warm-up and 10 timed steps:
    s per step, tokens/s, MFU (the tied head counted once), peak memory,
    losses (finite and falling) and the flash launches by route: forward
    and backward each 12 x steps, all on the tensor cores, and no
    attention call on the plain route. With ``sched`` (train_gpt2_sched):
    1 warm-up and 5 timed steps under ClipGradByGlobalNorm(1.0) and
    LinearWarmup over CosineAnnealingDecay, stepped after each train step,
    checking that each step's optimizer read the scheduled rate."""
    from paddle_tpu_torch.kernels.flash_attention import (_flash_bhsd,
                                                          _flash_bhsd_bwd)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.observability import model_flops_per_token
    from paddle_tpu_torch.optimizer import lr as lr_mod
    cfg = gpt2_config()
    reads = []
    if sched:
        class ReadLog(lr_mod.LinearWarmup):
            """LinearWarmup that records every rate read from it."""

            def __call__(self):
                reads.append(super().__call__())
                return reads[-1]

        schedule = ReadLog(lr_mod.CosineAnnealingDecay(1e-4, T_max=10), 2,
                           1e-5, 1e-4)
        model, step = make_gpt2_step(torch, cfg, seed, lr=schedule,
                                     grad_clip=ClipGradByGlobalNorm(1.0))
        warmup, timed = 1, GPT2_SCHED_STEPS
    else:
        model, step = make_gpt2_step(torch, cfg, seed)
        warmup, timed = TRAIN_WARMUP, TRAIN_TIMED
    n_params = sum(p.numel() for p in model.parameters())
    ids, labels = gpt2_batch(torch, np, seed + 3, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_flash_counts(_flash_bhsd, _flash_bhsd_bwd)
    zero_attention_routes()
    losses, expected = [], []
    for i in range(warmup + timed):
        if i == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(step((ids,), (labels,)))
        if sched:
            expected.append(schedule.last_lr)
            schedule.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = _flash_bhsd.launches, _flash_bhsd_bwd.launches
    fwd_routes = dict(_flash_bhsd.route_launches)
    routes = dict(_flash_bhsd_bwd.route_launches)
    attn_routes = attention_routes_without_plain(phase)
    losses = [x.item() for x in losses]
    n = warmup + timed
    check(all(math.isfinite(x) for x in losses),
          f"{phase}: non-finite loss {losses}")
    layers = cfg.num_hidden_layers
    check(fwd == layers * n and bwd == layers * n,
          f"{phase}: flash launches fwd {fwd}, bwd {bwd} != {layers} "
          f"layers x {n} steps")
    check(fwd_routes["wgmma"] == fwd and routes["wgmma"] == bwd,
          f"{phase}: every GPT-2 attention runs on the tensor cores: "
          f"{fwd_routes}, {routes}")
    if sched:
        # one read per step, inside its optimizer step, of the rate the
        # schedule held then (warm-up, then the cosine)
        check(reads == expected and len(set(expected)) == warmup + timed,
              f"{phase}: the optimizer read {reads}, the schedule gave "
              f"{expected}")
    else:
        check(losses[-1] < losses[0], f"{phase}: the loss did not fall: "
                                      f"{losses}")
    tokens = GPT2_BATCH * GPT2_SEQ
    tps = tokens * timed / wall
    flops_tok = model_flops_per_token(cfg, GPT2_SEQ, n_params)
    rec = {"phase": phase, "model": "benchmarks/gpt2_dp.py GPT-2 124M, "
                                    "random weights",
           "dtype": cfg.dtype, "layers": layers, "hidden": cfg.hidden_size,
           "heads": cfg.num_attention_heads, "head_dim": cfg.head_dim,
           "ffn": cfg.intermediate_size, "vocab": cfg.vocab_size,
           "dropout": cfg.dropout, "params": n_params,
           "batch": GPT2_BATCH, "seq": GPT2_SEQ,
           "optimizer": ("AdamW, ClipGradByGlobalNorm(1.0), LinearWarmup "
                         "over CosineAnnealingDecay" if sched
                         else "AdamW lr 1e-4"),
           "warmup_steps": warmup, "timed_steps": timed,
           "wall_s": wall, "s_per_step": wall / timed,
           "tokens_per_s": tps, "model_flops_per_token": flops_tok,
           "mfu": flops_tok * tps / BF16_FLOPS, "losses": losses,
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "flash_fwd_launches": fwd, "flash_bwd_launches": bwd,
           "flash_fwd_route_launches": fwd_routes,
           "flash_bwd_route_launches": routes,
           "attention_route_launches": attn_routes}
    if sched:
        rec["lr_read_per_step"] = reads
        rec["train_gpt2_s_per_step"] = beside
    emit(rec)
    del model, step
    torch.cuda.empty_cache()
    return rec


def gpt2_profile_build(torch, np):
    def build(seed):
        cfg = gpt2_config()
        model, step = make_gpt2_step(torch, cfg, seed)
        ids, labels = gpt2_batch(torch, np, seed + 3, cfg)
        return model, step, ids, labels
    return build


def train_gpt2_parity_phase(torch, np, seed):
    """GPT-2 at its widths (hidden 768, 12 heads of dim 64, vocab 50257),
    2 layers, float32, dropout 0, batch 2 x 1024, TF32 off: 3 steps with
    the flash kernels (float32 takes their CUDA-core route) and again with
    the plain attention (use_flash_attention=False), from the same
    weights: losses to 1e-5 relative, the first step's gradients to 1e-4
    of each one's largest element (summation order only)."""
    from paddle_tpu_torch.kernels.flash_attention import (_flash_bhsd,
                                                          _flash_bhsd_bwd)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs = {}
    for flash in (True, False):
        cfg = gpt2_config(num_hidden_layers=GPT2_PARITY_LAYERS,
                          dtype="float32", dropout=0.0,
                          use_flash_attention=flash)
        ids, labels = gpt2_batch(torch, np, seed + 4, cfg,
                                 batch=GPT2_PARITY_BATCH)
        model, step = make_gpt2_step(torch, cfg, seed + 5)
        zero_flash_counts(_flash_bhsd, _flash_bhsd_bwd)
        losses, grads = [], None
        for i in range(PARITY_STEPS):
            losses.append(step((ids,), (labels,)).item())
            if i == 0:
                grads = {k: p.grad.clone()
                         for k, p in model.named_parameters()}
        runs[flash] = (losses, grads, _flash_bhsd.launches,
                       _flash_bhsd_bwd.launches,
                       dict(_flash_bhsd.route_launches),
                       dict(_flash_bhsd_bwd.route_launches))
        del model, step
    (fl, fg, ff, fb, fwd_routes, routes), (pl_, pg, pf, pb, _, _) = \
        runs[True], runs[False]
    n = GPT2_PARITY_LAYERS * PARITY_STEPS
    check(ff == fb == n and pf == pb == 0,
          f"train_gpt2_parity: flash launches: kernels run {ff}/{fb}, plain "
          f"run {pf}/{pb}")
    check(fwd_routes["cuda_core"] == ff and routes["cuda_core"] == fb,
          f"train_gpt2_parity: float32 runs on the CUDA cores: "
          f"{fwd_routes}, {routes}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(fl, pl_))
    grad_rel = max(((fg[k] - pg[k]).abs().max()
                    / pg[k].abs().max()).item() for k in pg)
    check(loss_rel <= PARITY_LOSS_RTOL and grad_rel <= PARITY_GRAD_ATOL,
          f"train_gpt2_parity: loss rel {loss_rel}, step-1 grad {grad_rel} "
          f"of the largest element")
    rec = {"phase": "train_gpt2_parity", "dtype": cfg.dtype,
           "layers": cfg.num_hidden_layers, "hidden": cfg.hidden_size,
           "heads": cfg.num_attention_heads, "head_dim": cfg.head_dim,
           "vocab": cfg.vocab_size, "seq": ids.shape[1],
           "batch": ids.shape[0], "steps": PARITY_STEPS,
           "losses_flash": fl, "losses_plain": pl_,
           "max_loss_rel_diff": loss_rel, "loss_rtol": PARITY_LOSS_RTOL,
           "max_grad_diff_over_max": grad_rel,
           "grad_atol_of_max": PARITY_GRAD_ATOL,
           "flash_fwd_launches": ff, "flash_bwd_launches": fb,
           "flash_fwd_route_launches": fwd_routes,
           "flash_bwd_route_launches": routes}
    emit(rec)
    torch.cuda.empty_cache()
    return rec


# -- phases 8-10: the MoE training path ----------------------------------------

TF32_FLOPS = 494.7e12            # H100 SXM dense TF32 tensor-core peak
MOE_E, MOE_H, MOE_F = 8, 768, 3072
MOE_F_ODD = 3076                 # train_moe_f3076's expert width (not % 8)
MOE_TOKENS, MOE_TOPK, MOE_BM = 8192, 2, 128
MOE_EMPTY = 5                    # the expert the check's routing never picks
# float32 rule: |out - ref| <= 1e-6 |ref| + 1e-5 max|ref|. Kernel and plain
# version multiply the same float32 values and differ in summation order
# only: over K <= 3072 products (or a group's <= 8192 rows for dw) of about
# unit size the sums reach ~100 while the order moves them by about
# sqrt(K) x 6e-8 x 50 = 2e-4 = 2e-6 of the largest; a dropped K step or
# row tile moves an output by percents. bf16 outputs: one bf16 ulp
# (2^-7 |ref|) plus the same atol.
GMM_RTOL_F32, GMM_ATOL_OF_MAX = 1e-6, 1e-5


def moe_routing(torch, np, seed, bm=MOE_BM):
    """16,384 routes (8192 tokens x top-2) over 8 experts, skewed, expert
    5 never picked: the grouped metadata on the card in groups aligned to
    bm rows, and the counts on the host (for the per-expert library
    yardstick only)."""
    from paddle_tpu_torch.kernels.grouped_matmul import grouped_metadata
    rng = np.random.default_rng(seed)
    p = np.array([0.26, 0.2, 0.15, 0.12, 0.1, 0.0, 0.1, 0.07])
    ids = rng.choice(MOE_E, MOE_TOKENS * MOE_TOPK, p=p).astype(np.int32)
    md = grouped_metadata(torch.as_tensor(ids, device="cuda"), MOE_E, bm)
    return md, np.bincount(ids, minlength=MOE_E)


def gmm_err(torch, out, ref, rows, bf16):
    """(max abs error on the routed rows, worst ratio to the rule)."""
    o, r = out.float()[rows], ref.float()[rows]
    atol = GMM_ATOL_OF_MAX * r.abs().max().item()
    rtol = BF16_RTOL if bf16 else GMM_RTOL_F32
    d = (o - r).abs()
    return d.max().item(), (d / (rtol * r.abs() + atol)).max().item()


# the L2 read probe: every thread reads float4s with ld.global.cg (cached
# in L2, never in L1), 4 in flight, grid-striding over the whole buffer once
# a pass, so that within a pass no two blocks read one address and no
# re-read can come from an SM's L1; the sum is kept live by a store that
# never happens
L2_PROBE_SRC = r"""
#include <cuda_runtime.h>

__global__ void l2_probe(const float4* __restrict__ buf, long long nvec,
                         int passes, float* out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  float s = 0.f;
  for (int p = 0; p < passes; ++p) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    for (; i + 3 * stride < nvec; i += 4 * stride) {
      const float4 a = __ldcg(buf + i), b = __ldcg(buf + i + stride);
      const float4 c = __ldcg(buf + i + 2 * stride);
      const float4 d = __ldcg(buf + i + 3 * stride);
      s += ((a.x + a.y) + (a.z + a.w)) + ((b.x + b.y) + (b.z + b.w))
           + ((c.x + c.y) + (c.z + c.w)) + ((d.x + d.y) + (d.z + d.w));
    }
    for (; i < nvec; i += stride) {
      const float4 a = __ldcg(buf + i);
      s += (a.x + a.y) + (a.z + a.w);
    }
  }
  if (s == 1.2345678e-30f) out[0] = s;
}

extern "C" int l2_probe_read(const void* buf, long long nvec, int passes,
                             void* out, int blocks, void* stream) {
  l2_probe<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float4*)buf, nvec, passes, (float*)out);
  return (int)cudaGetLastError();
}
"""
L2_PROBE_SIG = {"l2_probe_read": [ctypes.c_void_p, ctypes.c_longlong,
                                  ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_int, ctypes.c_void_p]}


def l2_read_rate(torch):
    """The card's L2 read rate, in bytes/s: the L2 probe (L2_PROBE_SRC,
    built here) reads an L2-resident float32 buffer of 8, 16 or 24 MB
    over and over, about 1 GiB a launch, 8 blocks of 256 threads an SM;
    the best of the three sizes. The same probe over 1 GiB, which cannot
    stay in L2, gives the device memory's rate beside it, as a check that
    the probe tells the two apart."""
    from paddle_tpu_torch.kernels import _build
    out_dir = os.path.join(str(_build.BUILD_DIR), "l2_probe")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "l2_probe.cu")
    with open(src, "w") as fh:
        fh.write(L2_PROBE_SRC)
    lib = build_variants(out_dir, {"probe": (src, L2_PROBE_SIG, (),
                                             None)})["probe"]
    dev = torch.device("cuda")
    blocks = 8 * torch.cuda.get_device_properties(dev).multi_processor_count
    sink = torch.zeros(1, device=dev)

    def rate(mb, passes):
        t = torch.randn(mb * 2 ** 18, device=dev)

        def read():
            rc = lib.l2_probe_read(
                t.data_ptr(), t.numel() // 4, passes, sink.data_ptr(),
                blocks, torch.cuda.current_stream().cuda_stream)
            check(rc == 0, f"the L2 probe failed ({rc})")
        ms = cuda_ms(torch, read, 20)
        del t
        return passes * mb * 2 ** 20 / ms * 1e3
    rates = {mb: rate(mb, 1024 // mb) for mb in (8, 16, 24)}
    dram = rate(1024, 1)
    best = max(rates.values())
    emit({"phase": "l2_read_rate", "tb_per_s": best / 1e12,
          "tb_per_s_by_mb": {mb: r / 1e12 for mb, r in rates.items()},
          "dram_tb_per_s": dram / 1e12,
          "method": "L2 probe: ld.global.cg float4 reads, grid-stride over "
                    "the buffer each pass (no address read twice in a "
                    "pass, none from L1), about 1 GiB a launch, 20 "
                    "launches (CUDA events); dram: one pass over 1 GiB"})
    torch.cuda.empty_cache()
    return best


def grouped_case(torch, np, name, kind, k, n, dtype, seed, md, counts,
                 block_k=None, parent=None, bm=MOE_BM, parent_gm=None,
                 l2_rate=None, x_offset=False):
    """One grouped kernel at the MoE path's shapes against its plain
    version: kind "fwd" (x [Tp, k] . w [E, k, n] + b), "dx" (dy [Tp, k] .
    w[e]^T with w [E, n, k], read in place), "dw" (x [Tp, k], dy [Tp, n]
    -> [E, k, n]) or "int8"/"fp8" (x . dequant(codes [E, n, k])^T, blocks
    of block_k). Every record names the route the wrapper took and checks
    two launches bit for bit; with the parent commit's library (`parent`
    for the quantized kernel, `parent_gm` for the float32/bf16 forward and
    weight gradient) its kernel is checked and timed on the same inputs,
    parent, shipped, shipped, parent. md's groups are aligned to bm rows.
    A float32 case on the tensor cores also gets the bound of its own work
    (three or six bf16 products a value) and, with `l2_rate`, the time its
    tiles' reads from L2 take at that rate. With x_offset, x is a view one
    element (4 bytes in float32) past a 16-byte boundary."""
    from paddle_tpu_torch.kernels import grouped_matmul as gmm
    from paddle_tpu_torch.kernels import quant_matmul as qmm
    from paddle_tpu_torch.kernels.grouped_matmul import (
        _ref_dw, _ref_fwd, grouped_matmul_dw, grouped_matmul_fwd)
    from paddle_tpu_torch.kernels.quant_matmul import (
        blockwise_weight_bytes, dequantize_weight_blockwise,
        quant_grouped_matmul, quant_grouped_matmul_plain,
        quantize_weight_blockwise)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    off, cnt = md["offsets"], md["counts"]
    tp = md["row_src"].shape[0]
    rows = md["dest"].long()
    x = torch.randn(tp, k, generator=gen, device=dev, dtype=dtype)
    if x_offset:
        x = torch.empty(tp * k + 1, device=dev, dtype=dtype)[1:] \
            .view(tp, k).copy_(x)
    routes = int(counts.sum())
    live = [e for e in range(MOE_E) if counts[e]]
    starts = np.concatenate([[0], np.cumsum(-(-counts // bm))[:-1]]) \
        * bm
    isz = x.element_size()
    if kind in ("fwd", "dx"):
        wshape = (MOE_E, k, n) if kind == "fwd" else (MOE_E, n, k)
        w = torch.randn(*wshape, generator=gen, device=dev, dtype=dtype) \
            * k ** -0.5
        b = torch.randn(MOE_E, n, generator=gen, device=dev, dtype=dtype) \
            if kind == "fwd" else None
        tr = kind == "dx"

        def kernel():
            return grouped_matmul_fwd(x, w, b, off, cnt, bm,
                                      transpose_w=tr)

        def parent_kernel():
            # the parent's C entry, on the route the shipped wrapper takes
            out = torch.empty(tp, n, device=dev, dtype=dtype)
            route = gmm.gm_route(dtype, k, n, bm, tr,
                                 (x.data_ptr(), w.data_ptr()))
            rc = parent_gm.grouped_matmul_fwd(
                x.data_ptr(), w.data_ptr(),
                b.data_ptr() if b is not None else None, out.data_ptr(),
                off.data_ptr(), cnt.data_ptr(), MOE_E, tp, k, n, bm,
                int(tr), gmm._DTYPE_CODE[dtype], gmm._GM_ROUTE_CODE[route],
                torch.cuda.current_stream().cuda_stream)
            check(rc == 0, f"{name}: the parent's kernel failed ({rc})")
            return out

        def plain():
            return _ref_fwd(x, w, b, off, cnt, bm, dtype,
                            transpose_w=tr)

        def library():
            out = torch.empty(tp, n, device=dev, dtype=dtype)
            for e in live:
                s, c = int(starts[e]), int(counts[e])
                we = w[e].t() if tr else w[e]
                out[s:s + c] = x[s:s + c] @ we if b is None else \
                    torch.addmm(b[e], x[s:s + c], we)
            return out
        wbytes = len(live) * k * n * isz + (len(live) * n * isz if b
                                             is not None else 0)
        bytes_moved = routes * k * isz + wbytes + routes * n * isz
    elif kind == "dw":
        dy = torch.randn(tp, n, generator=gen, device=dev, dtype=dtype)

        def kernel():
            return grouped_matmul_dw(x, dy, off, cnt, bm, MOE_E)

        def parent_kernel():
            # the parent's C entry: no route argument (its one dw kernel)
            out = torch.empty(MOE_E, k, n, device=dev, dtype=torch.float32)
            rc = parent_gm.grouped_matmul_dw(
                x.data_ptr(), dy.data_ptr(), out.data_ptr(), off.data_ptr(),
                cnt.data_ptr(), MOE_E, tp, k, n, gmm._DTYPE_CODE[dtype],
                torch.cuda.current_stream().cuda_stream)
            check(rc == 0, f"{name}: the parent's kernel failed ({rc})")
            return out

        def plain():
            return _ref_dw(x, dy, off, cnt, bm, MOE_E)

        def library():
            out = torch.zeros(MOE_E, k, n, device=dev, dtype=torch.float32)
            for e in live:
                s, c = int(starts[e]), int(counts[e])
                out[e] = (x[s:s + c].t() @ dy[s:s + c]).float()
            return out
        rows = slice(None)
        bytes_moved = routes * (k + n) * isz + MOE_E * k * n * 4
    else:
        w = torch.randn(MOE_E, n, k, generator=gen, device=dev) * k ** -0.5
        codes, scales = quantize_weight_blockwise(w, block_k, qdtype=kind)
        wdq = dequantize_weight_blockwise(codes, scales).to(dtype)
        del w

        def kernel():
            return quant_grouped_matmul(x, codes, scales, group_offsets=off,
                                        group_counts=cnt, bm=bm)

        def parent_kernel():
            # the parent's C entry, on the route the shipped wrapper takes
            out = torch.empty(tp, n, device=dev, dtype=dtype)
            kb = scales.shape[2]
            route = qmm.gq_route(dtype, k // kb, bm,
                                 (x.data_ptr(), codes.data_ptr()))
            rc = parent.quant_grouped_matmul_fwd(
                x.data_ptr(), codes.data_ptr(), scales.data_ptr(),
                out.data_ptr(), off.data_ptr(), cnt.data_ptr(), MOE_E, tp, k,
                n, kb, k // kb, bm, qmm._X_CODE[dtype],
                qmm._Q_CODE[codes.dtype], qmm._GQ_ROUTE_CODE[route],
                torch.cuda.current_stream().cuda_stream)
            check(rc == 0, f"{name}: the parent's kernel failed ({rc})")
            return out

        def plain():
            return quant_grouped_matmul_plain(x, codes, scales, off, cnt,
                                              bm)

        def library():
            out = torch.empty(tp, n, device=dev, dtype=dtype)
            for e in live:
                s, c = int(starts[e]), int(counts[e])
                out[s:s + c] = x[s:s + c] @ wdq[e].t()
            return out
        bytes_moved = routes * k * isz + len(live) * \
            blockwise_weight_bytes(k, n)[0] + routes * n * isz
    quant = kind in ("int8", "fp8")
    forward = kind != "dw"
    counted = quant_grouped_matmul if quant else \
        grouped_matmul_fwd if forward else grouped_matmul_dw
    before = dict(counted.route_launches)
    out = kernel()
    ref = plain()
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    err, ratio = gmm_err(torch, out, ref, rows, bf16)
    check(math.isfinite(ratio) and ratio <= 1.0,
          f"{name}: kernel vs plain max abs err {err}, {ratio} x tolerance")
    extra = {}
    if not quant:
        parent = parent_gm
    extra["route"] = next(r for r, c in counted.route_launches.items()
                          if c > before[r])
    if quant:
        extra["block_k"] = k // scales.shape[2]
    check(torch.equal(kernel()[rows], out[rows]),
          f"{name}: two launches differ")
    if parent is not None:
        pout = parent_kernel()
        perr, pratio = gmm_err(torch, pout, ref, rows, bf16)
        check(pratio <= 1.0, f"{name}: the parent's kernel is off "
                             f"({perr})")
        extra["parent_max_abs_err"] = perr
        del pout
    lib = library()
    lib_check(name, lib[rows], ref[rows])
    del out, ref, lib
    kernel_ms = cuda_ms(torch, kernel, 10)
    if parent is not None:
        # parent, shipped, shipped, parent: the same inputs in turns
        pm = [cuda_ms(torch, parent_kernel, 10)]
        km = [kernel_ms, cuda_ms(torch, kernel, 10)]
        pm.append(cuda_ms(torch, parent_kernel, 10))
        kernel_ms = statistics.mean(km)
        extra.update(parent_ms=statistics.mean(pm), parent_ms_runs=pm,
                     kernel_ms_runs=km,
                     speedup_over_parent=statistics.mean(pm) / kernel_ms)
    plain_ms = cuda_ms(torch, plain, 3, warmup=1)
    library_ms = cuda_ms(torch, library, 10)
    flops = 2 * routes * k * n
    peak = BF16_FLOPS if bf16 else TF32_FLOPS
    bound_ms, bound_by = bound(bytes_moved, flops, peak)
    extra["bound_share"] = bound_ms / kernel_ms
    if not bf16 and extra["route"] == "wgmma":
        # the tensor-core route's own work: three (x split, codes exact)
        # or six (x and w, or x and dy, split) bf16 products a value
        pieces = 3 if quant else 6
        bp = bound(bytes_moved, pieces * flops, BF16_FLOPS)[0]
        extra.update({f"bound_bf16x{pieces}_ms": bp,
                      f"bound_bf16x{pieces}_share": bp / kernel_ms,
                      "bf16_tflops_per_s": pieces * flops / kernel_ms / 1e9})
    if not quant and extra["route"] == "wgmma" and l2_rate:
        if forward:
            # each 128 x 128 tile reads its x tile and its weight tile whole
            tiles = int(sum(-(-int(c) // 128) for c in counts))
            l2_bytes = tiles * -(-n // 128) * 2 * 128 * k * isz
        else:
            # each 128 x 128 tile of dw[e] reads its group's rows of 128
            # columns of x and of dy
            l2_bytes = routes * -(-k // 128) * -(-n // 128) * 2 * 128 * isz
        extra.update(l2_bytes=l2_bytes, l2_tb_per_s=l2_rate / 1e12,
                     bound_l2_ms=l2_bytes / l2_rate * 1e3,
                     bound_l2_share=l2_bytes / l2_rate * 1e3 / kernel_ms)
    rec = {"phase": "kernel_check", "kernel": {
               "fwd": "grouped_matmul_fwd", "dx": "grouped_matmul_fwd",
               "dw": "grouped_matmul_dw"}.get(kind, "quant_grouped_matmul"),
           "case": name, "kind": kind, "dtype": str(dtype).split(".")[-1],
           "routes": routes, "rows": tp, "k": k, "n": n, "bm": bm,
           "x_byte_offset": x.data_ptr() % 16,
           "max_abs_err": err, "err_over_tolerance": ratio,
           "rtol": BF16_RTOL if bf16 else GMM_RTOL_F32,
           "atol_of_max": GMM_ATOL_OF_MAX, "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library": "torch.matmul per expert over its rows"
                      + (" (weights dequantized beforehand)"
                         if kind in ("int8", "fp8") else ""),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_peak": "bf16 989 TFLOP/s" if bf16
           else "TF32 494.7 TFLOP/s", "bytes": bytes_moved, "flops": flops,
           "tflops_per_s": flops / kernel_ms / 1e9, **extra}
    emit(rec)
    torch.cuda.empty_cache()
    return rec


def grouped_poison_case(torch, np, seed, md):
    """Every row that is not a route's (padding in a group's last tile,
    the dead tiles past the groups) NaN in x and dy: the routed rows of
    the forward, the input gradient and the quantized forward, and all
    of dw, must equal the clean run's bit for bit. dw runs twice, on x
    (the tensor cores) and on a copy of x 4 bytes off a 16-byte boundary
    (the CUDA cores)."""
    from paddle_tpu_torch.kernels.grouped_matmul import (grouped_matmul_dw,
                                                         grouped_matmul_fwd)
    from paddle_tpu_torch.kernels.quant_matmul import (
        quant_grouped_matmul, quantize_weight_blockwise)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    off, cnt = md["offsets"], md["counts"]
    tp = md["row_src"].shape[0]
    rows = md["dest"].long()
    k, n = MOE_H, MOE_F
    x = torch.randn(tp, k, generator=gen, device=dev)
    dy = torch.randn(tp, n, generator=gen, device=dev)
    xo = torch.empty(tp * k + 1, device=dev)[1:].view(tp, k).copy_(x)
    w = torch.randn(MOE_E, k, n, generator=gen, device=dev)
    b = torch.randn(MOE_E, n, generator=gen, device=dev)
    codes, scales = quantize_weight_blockwise(w.transpose(1, 2))

    def run():
        return (grouped_matmul_fwd(x, w, b, off, cnt, MOE_BM)[rows],
                grouped_matmul_fwd(dy, w, None, off, cnt, MOE_BM,
                                   transpose_w=True)[rows],
                grouped_matmul_dw(x, dy, off, cnt, MOE_BM, MOE_E),
                grouped_matmul_dw(xo, dy, off, cnt, MOE_BM, MOE_E),
                quant_grouped_matmul(x, codes, scales, group_offsets=off,
                                     group_counts=cnt, bm=MOE_BM)[rows])
    dw_routes = dict(grouped_matmul_dw.route_launches)
    clean = run()
    dead = ~md["row_valid"]
    x[dead] = float("nan")
    dy[dead] = float("nan")
    xo[dead] = float("nan")
    poisoned = run()
    torch.cuda.synchronize()
    dw_routes = {r: c - dw_routes[r]
                 for r, c in grouped_matmul_dw.route_launches.items()}
    check(dw_routes == {"cuda_core": 2, "wgmma": 2},
          f"grouped nan_poison: dw launches by route {dw_routes}")
    names = ("fwd", "dx", "dw", "dw_cuda_core", "int8")
    for nm, c, p in zip(names, clean, poisoned):
        check(torch.isfinite(p).all().item() and torch.equal(c, p),
              f"grouped nan_poison: {nm} read a padding or dead row")
    rec = {"phase": "kernel_check", "kernel": "grouped (all three)",
           "case": "nan_poison_dead_rows", "rows": tp,
           "poisoned_rows": int(dead.sum().item()),
           "identical_to_clean": list(names),
           "dw_route_launches": dw_routes}
    emit(rec)
    torch.cuda.empty_cache()
    return rec


def moe_model(torch, seed, **overrides):
    from paddle_tpu_torch.models.gpt_moe import MoEGPT, gpt_moe_config
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return MoEGPT(gpt_moe_config(**overrides), device="cuda", generator=gen)


def moe_routes_kept(torch, model, ids):
    """Run the model once without gradients, catching every MoE layer's
    routing: (routes placed in the grouped buffer, routes the gates
    produced, second routes the GShard gates zeroed at random). A placed
    route is one grouped_metadata gives a buffer row: with no capacity
    there is none to drop, and this counts that it is so."""
    from paddle_tpu_torch.kernels.grouped_matmul import grouped_metadata
    caught = []

    def hook(mod, inp, out):
        caught.append((mod.num_expert, out))
    hooks = [blk.moe.gate.register_forward_hook(hook)
             for blk in model.blocks]
    with torch.no_grad():
        model(ids)
    for h in hooks:
        h.remove()
    placed = produced = zeroed = 0
    for e, (val, idx) in caught:
        md = grouped_metadata(idx.reshape(-1), e, MOE_BM)
        placed += int(md["row_valid"].sum().item())
        produced += idx.numel()
        zeroed += int((val[:, 1] == 0).sum().item())
    return placed, produced, zeroed


def train_moe_phase(torch, np, seed, phase="train_moe", warmup=2, timed=10,
                    quant_route=None, parent_gq=None, extra=None,
                    grouped_route="wgmma", dw_route="wgmma", parent_gm=None,
                    **overrides):
    """The GPT-MoE of benchmarks/gpt_moe_ep.py at its chip widths (hidden
    768, 6 layers, 8 experts top-2, 12 heads, vocab 50257; float32,
    grouped dispatch) through TrainStep with AdamW at lr 1e-4, on the
    benchmark's fixed batch of 8 x 1024 random ids from the seed. With
    quant_route, every quantized grouped launch must have taken it; every
    grouped forward and input gradient must have taken grouped_route
    (None: any route), and every weight gradient dw_route. With parent_gq or parent_gm (a
    ParentGq or ParentGm swapped in by the caller), every such launch must
    have gone to the parent's kernel, and the record counts them as
    {"parent": n}. The record keeps each step's routes per expert in each
    layer (`expert_counts` [step][layer][expert], read from the gates'
    outputs after the last step)."""
    from paddle_tpu_torch import AdamW, TrainStep
    from paddle_tpu_torch.kernels.grouped_matmul import (grouped_matmul_dw,
                                                         grouped_matmul_fwd)
    from paddle_tpu_torch.kernels.quant_matmul import quant_grouped_matmul
    from paddle_tpu_torch.models.gpt_moe import moe_flops_per_token, \
        moe_loss
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = moe_model(torch, seed, dispatch_mode="grouped", **overrides)
    cfg = model.config
    step = TrainStep(model, moe_loss,
                     AdamW(learning_rate=1e-4,
                           parameters=model.parameters()))
    batch, seq = 8, 1024
    ids, labels = train_batch(torch, np, seed, cfg.vocab_size, batch, seq)
    n_params, n_active, flops_tok = moe_flops_per_token(model, seq)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    caught = []         # each gate call's expert ids, counted at the end
    hooks = [blk.moe.gate.register_forward_hook(
        lambda mod, inp, out: caught.append(out[1].detach()))
        for blk in model.blocks]
    zero_flash_counts(grouped_matmul_fwd, grouped_matmul_dw,
                      quant_grouped_matmul)
    if parent_gm is not None:
        parent_gm.calls = parent_gm.dw_calls = 0
    losses = [step((ids,), (labels,)) for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        losses.append(step((ids,), (labels,)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for h in hooks:
        h.remove()
    layers, experts = cfg.num_layers, cfg.num_experts
    steps = warmup + timed
    check(len(caught) == layers * steps,
          f"{phase}: {len(caught)} gate calls in {steps} steps of {layers} "
          f"layers")
    expert_counts = torch.stack([
        (c.reshape(-1, 1) == torch.arange(experts, device=c.device))
        .sum(0) for c in caught]).view(steps, layers, experts).tolist()
    del caught
    fwd, dw = grouped_matmul_fwd.launches, grouped_matmul_dw.launches
    qfwd = quant_grouped_matmul.launches
    qroutes = dict(quant_grouped_matmul.route_launches)
    groutes = dict(grouped_matmul_fwd.route_launches)
    dwroutes = dict(grouped_matmul_dw.route_launches)
    if parent_gm is not None:
        check(parent_gm.calls == fwd and parent_gm.dw_calls == dw,
              f"{phase}: {parent_gm.calls} and {parent_gm.dw_calls} calls "
              f"of the parent's grouped kernels, {fwd} grouped forward and "
              f"{dw} weight-gradient launches")
        groutes = {"parent": parent_gm.calls}
        dwroutes = {"parent": parent_gm.dw_calls}
    elif (grouped_route is not None and groutes[grouped_route] != fwd) \
            or dwroutes[dw_route] != dw:
        raise AssertionError(f"{phase}: grouped forward launches by route "
                             f"{groutes}, not all {grouped_route}; weight "
                             f"gradients {dwroutes}, not all {dw_route}")
    if parent_gq is not None:
        check(parent_gq.calls == qfwd,
              f"{phase}: {parent_gq.calls} calls of the parent's kernel, "
              f"{qfwd} quantized launches")
        qroutes = {"parent": parent_gq.calls}
    peak = torch.cuda.max_memory_allocated()
    losses = [x.item() for x in losses]
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    if cfg.expert_quant:
        want = (2 * layers * steps, 2 * layers * steps, 2 * layers * steps)
    else:
        want = (4 * layers * steps, 2 * layers * steps, 0)
    check((fwd, dw, qfwd) == want,
          f"grouped launches fwd {fwd}, dw {dw}, quantized {qfwd} != "
          f"{want} over {layers} layers x {steps} steps")
    if quant_route is not None:
        check(qroutes[quant_route] == qfwd,
              f"{phase}: quantized launches by route {qroutes}, not all "
              f"{quant_route}")
    placed, produced, zeroed = moe_routes_kept(torch, model, ids)
    check(placed == produced == layers * batch * seq * cfg.top_k,
          f"routes placed {placed} of {produced}: a route was dropped")
    tokens = batch * seq
    tps = tokens * timed / wall
    rec = {"phase": phase,
           "model": "benchmarks/gpt_moe_ep.py GPT-MoE at its chip widths, "
                    "random weights",
           "dtype": cfg.dtype, "dispatch": cfg.dispatch_mode,
           "expert_quant": cfg.expert_quant, "layers": layers,
           "hidden": cfg.hidden_size, "heads": cfg.num_heads,
           "experts": cfg.num_experts, "top_k": cfg.top_k,
           "d_hidden": cfg.d_hidden, "vocab": cfg.vocab_size,
           "params": n_params, "activated_params": n_active,
           "batch": batch, "seq": seq, "optimizer": "AdamW lr 1e-4",
           "warmup_steps": warmup, "timed_steps": timed,
           "wall_s": wall, "s_per_step": wall / timed, "tokens_per_s": tps,
           "model_flops_per_token": flops_tok,
           "mfu": flops_tok * tps / BF16_FLOPS, "losses": losses,
           "peak_device_bytes": peak,
           "routes_per_step": layers * tokens * cfg.top_k,
           "routes_dropped": produced - placed,
           "second_routes_zeroed_by_gshard_random_routing": zeroed,
           "grouped_fwd_launches": fwd, "grouped_dw_launches": dw,
           "grouped_route_launches": groutes,
           "grouped_dw_route_launches": dwroutes,
           "quant_grouped_launches": qfwd,
           "quant_grouped_route_launches": qroutes,
           "expert_counts": expert_counts, **(extra or {})}
    emit(rec)
    del model, step
    torch.cuda.empty_cache()
    return rec


def train_moe_profile_phase(torch, np, seed, steps=2):
    """--profile only: train_moe's steps once plainly for their wall time
    and once under torch.profiler, the device time grouped by kernel
    family and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import AdamW, TrainStep
    from paddle_tpu_torch.models.gpt_moe import moe_loss
    model = moe_model(torch, seed, dispatch_mode="grouped")
    step = TrainStep(model, moe_loss,
                     AdamW(learning_rate=1e-4,
                           parameters=model.parameters()))
    ids, labels = train_batch(torch, np, seed, model.config.vocab_size, 8,
                              1024)
    step((ids,), (labels,))                               # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step((ids,), (labels,))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step((ids,), (labels,))
        torch.cuda.synchronize()
    rows, busy_s = device_kernel_rows(prof)
    groups = {"grouped_fwd": 0.0, "grouped_dw": 0.0, "flash_fwd": 0.0,
              "flash_bwd": 0.0, "gemm": 0.0, "other": 0.0}
    for us, name, _ in rows:
        key = next((g for g in ("grouped_fwd", "grouped_dw", "flash_fwd",
                                "flash_bwd") if g in name), None)
        if "grouped_wgmma" in name:    # the grouped forward's tensor cores
            key = "grouped_fwd"
        if key is None:
            key = "gemm" if any(t in name.lower() for t in (
                "gemm", "nvjet", "cutlass", "xmma")) else "other"
        groups[key] += us / 1e6
    rec = {"phase": "train_moe_profile", "steps": steps, "wall_s": wall,
           "s_per_step": wall / steps,
           "device_busy_s": busy_s if rows else "not measured",
           "device_idle_share": 1 - busy_s / wall if rows
           else "not measured",
           "device_s_per_step_by_group": {
               k: v / steps for k, v in groups.items()},
           "top_device_kernels": top_kernels(rows, busy_s, 15)}
    emit(rec)
    del model, step
    torch.cuda.empty_cache()
    return rec


def moe_parity_phase(torch, np, seed):
    """Grouped against capacity dispatch inside whole training steps: 2
    layers at full width, float32 (TF32 off), random routing off and
    capacity_factor E / top_k, so that no route drops and both compute one
    function. The key projection's bias gradient is 0 in exact arithmetic
    (softmax removes a per-row constant): both runs give float noise
    there, held below 1e-5 of the layer's key-weight gradient (a bias
    gradient that was wrong would be of the weight gradient's order)."""
    from paddle_tpu_torch import AdamW, TrainStep
    from paddle_tpu_torch.kernels.grouped_matmul import grouped_matmul_fwd
    from paddle_tpu_torch.models.gpt_moe import moe_loss
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs = {}
    for mode in ("grouped", "capacity"):
        model = moe_model(torch, seed + 7, num_layers=2, dispatch_mode=mode,
                          random_routing=False,
                          capacity_factor=MOE_E / MOE_TOPK)
        ids, labels = train_batch(torch, np, seed + 6,
                                  model.config.vocab_size, 8, 1024)
        step = TrainStep(model, moe_loss,
                         AdamW(learning_rate=1e-4,
                               parameters=model.parameters()))
        grouped_matmul_fwd.launches = 0
        losses, grads = [], None
        for i in range(PARITY_STEPS):
            losses.append(step((ids,), (labels,)).item())
            if i == 0:
                grads = {k: p.grad.clone()
                         for k, p in model.named_parameters()}
        runs[mode] = (losses, grads, grouped_matmul_fwd.launches)
        del model, step
        torch.cuda.empty_cache()
    (gl, gg, gf), (cl, cg, cf) = runs["grouped"], runs["capacity"]
    check(gf == 4 * 2 * PARITY_STEPS and cf == 0,
          f"grouped launches: grouped run {gf}, capacity run {cf}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
    grad_rel, bias_rel = 0.0, 0.0
    for k, ref in cg.items():
        if k.endswith("k_proj.bias"):
            top = cg[k[:-4] + "weight"].abs().max()
            bias_rel = max(bias_rel, (gg[k].abs().max() / top).item(),
                           (ref.abs().max() / top).item())
            continue
        grad_rel = max(grad_rel, ((gg[k] - ref).abs().max()
                                  / ref.abs().max()).item())
    check(loss_rel <= PARITY_LOSS_RTOL and grad_rel <= PARITY_GRAD_ATOL
          and bias_rel <= 1e-5,
          f"grouped vs capacity training: loss rel {loss_rel}, step-1 grad "
          f"{grad_rel} of the largest element, k_proj.bias {bias_rel}")
    rec = {"phase": "moe_parity", "dtype": "float32", "layers": 2,
           "hidden": MOE_H, "experts": MOE_E, "batch": 8, "seq": 1024,
           "capacity_factor": MOE_E / MOE_TOPK, "steps": PARITY_STEPS,
           "losses_grouped": gl, "losses_capacity": cl,
           "max_loss_rel_diff": loss_rel, "loss_rtol": PARITY_LOSS_RTOL,
           "max_grad_diff_over_max": grad_rel,
           "grad_atol_of_max": PARITY_GRAD_ATOL,
           "k_proj_bias_grad_over_weight_grad": bias_rel,
           "grouped_fwd_launches": gf}
    emit(rec)
    torch.cuda.empty_cache()
    return rec


def moe_kernel_checks(torch, np, seed, parent=None, parent_gm=None,
                      l2_rate=None):
    """Phase 8: the three MoE kernels at train_moe's shapes. The forward,
    input-gradient and weight-gradient cases take the tensor-core route
    ("wgmma"), but
    `up_dx_f32_bm64` and `down_dx_f32_bm64` (groups of 64 rows, the
    input gradients that train_moe_quant_bm64 launches, against w^T read
    in place: `grouped_fwd<float, true>`), which hold the CUDA-core
    kernel. The quantized cases take the tensor-core route, but
    two that hold the CUDA-core kernel: groups of 64 rows at blocks of
    128, the shapes at which train_moe_quant_bm64 launches it, and blocks
    of 96 (not whole 64-deep stages). Two weight-gradient cases hold the
    CUDA-core dw: x 4 bytes off a 16-byte boundary, and an expert width
    of 3076 (train_moe_f3076's). With `parent` (the parent commit's
    quantized library) and `parent_gm` (its grouped library) each case
    is timed on the parent's kernel too. Returns the records the kernels
    line takes (the up projection's forward on the tensor cores, its
    input gradient in groups of 64 rows on the CUDA cores, its weight
    gradient on the tensor cores and, at width 3076, on the CUDA cores,
    the int8 up projection on the tensor cores and, in groups of 64 rows,
    on the CUDA cores)."""
    md, counts = moe_routing(torch, np, seed)
    md64, counts64 = moe_routing(torch, np, seed, bm=64)
    h, f = MOE_H, MOE_F
    f32, bf16 = torch.float32, torch.bfloat16
    recs = {}
    tc, cc = "wgmma", "cuda_core"
    for name, kind, k, n, dt, bk, bm, want in (
            ("up_fwd_f32", "fwd", h, f, f32, None, MOE_BM, tc),
            ("down_fwd_f32", "fwd", f, h, f32, None, MOE_BM, tc),
            ("up_dx_f32", "dx", f, h, f32, None, MOE_BM, tc),
            ("down_dx_f32", "dx", h, f, f32, None, MOE_BM, tc),
            ("up_dx_f32_bm64", "dx", f, h, f32, None, 64, cc),
            ("down_dx_f32_bm64", "dx", h, f, f32, None, 64, cc),
            ("up_dw_f32", "dw", h, f, f32, None, MOE_BM, tc),
            ("down_dw_f32", "dw", f, h, f32, None, MOE_BM, tc),
            ("up_fwd_bf16", "fwd", h, f, bf16, None, MOE_BM, tc),
            ("up_dw_bf16", "dw", h, f, bf16, None, MOE_BM, tc),
            ("up_int8_f32", "int8", h, f, f32, None, MOE_BM, tc),
            ("down_int8_f32", "int8", f, h, f32, None, MOE_BM, tc),
            ("up_fp8_f32", "fp8", h, f, f32, None, MOE_BM, tc),
            ("up_int8_bf16", "int8", h, f, bf16, None, MOE_BM, tc),
            ("up_int8_f32_bm64", "int8", h, f, f32, None, 64, cc),
            ("up_int8_f32_bk96", "int8", h, f, f32, 96, MOE_BM, cc),
            ("up_dw_f32_x_offset", "dw", h, f, f32, None, MOE_BM, cc),
            ("up_dw_f32_f3076", "dw", h, MOE_F_ODD, f32, None, MOE_BM, cc)):
        recs[name] = grouped_case(
            torch, np, name, kind, k, n, dt, seed + len(recs),
            *((md, counts) if bm == MOE_BM else (md64, counts64)),
            block_k=bk, parent=parent, bm=bm, parent_gm=parent_gm,
            l2_rate=l2_rate, x_offset=name.endswith("_x_offset"))
        check(recs[name]["route"] == want,
              f"{name}: routed to {recs[name]['route']}, not {want}")
    grouped_poison_case(torch, np, seed + 99, md)
    return (recs["up_fwd_f32"], recs["up_dx_f32_bm64"], recs["up_dw_f32"],
            recs["up_dw_f32_f3076"], recs["up_int8_f32"],
            recs["up_int8_f32_bm64"])


def dw_order_phase(torch, np, seed, expert_counts):
    """The weight gradient's tail on the group sizes the MoE phases' gates
    gave: expert_counts maps a phase to its last step's counts [layer]
    [expert]. For each layer, the tensor-core dw at the up (768 x 3072)
    and down (3072 x 768) shapes on a routing with the experts in the
    gates' order and on one with the same counts largest first (the
    order in which blocks ranked by their group's size would start), in
    turns (gate, largest first, largest first, gate; CUDA events over 10
    launches each), each held to the plain version by the float32 rule.
    `tail_cost` is the share by which the gates' order is slower, per
    launch and over a phase's step (`step_tail_cost`: the sums of its
    layers' up and down times)."""
    from paddle_tpu_torch.kernels.grouped_matmul import (
        _ref_dw, grouped_matmul_dw, grouped_metadata)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    before = dict(grouped_matmul_dw.route_launches)
    rec = {"phase": "dw_order", "dtype": "float32"}
    for phase, by_layer in expert_counts.items():
        layers = []
        for counts in by_layer:
            mds = {}
            for order, cs in (("gate", counts),
                              ("largest_first", sorted(counts,
                                                       reverse=True))):
                ids = rng.permutation(np.repeat(np.arange(MOE_E), cs))
                mds[order] = grouped_metadata(
                    torch.as_tensor(ids.astype(np.int32), device=dev),
                    MOE_E, MOE_BM)
            row = {"counts": counts}
            for shape, k, n in (("up", MOE_H, MOE_F),
                                ("down", MOE_F, MOE_H)):
                calls, shares = {}, {}
                for order, md in mds.items():
                    tp = md["row_src"].shape[0]
                    gen = torch.Generator(device=dev)
                    gen.manual_seed(seed + k)
                    x = torch.randn(tp, k, generator=gen, device=dev)
                    dy = torch.randn(tp, n, generator=gen, device=dev)
                    off, cnt = md["offsets"], md["counts"]

                    def call(x=x, dy=dy, off=off, cnt=cnt):
                        return grouped_matmul_dw(x, dy, off, cnt, MOE_BM,
                                                 MOE_E)
                    out, ref = call(), _ref_dw(x, dy, off, cnt, MOE_BM,
                                               MOE_E)
                    shares[order] = gmm_err(torch, out, ref, slice(None),
                                            False)[1]
                    check(shares[order] <= 1.0,
                          f"dw_order {phase} {shape} {order}: "
                          f"{shares[order]} x the float32 rule")
                    calls[order] = call
                    del out, ref
                runs = {"gate": [], "largest_first": []}
                for order in ("gate", "largest_first", "largest_first",
                              "gate"):
                    runs[order].append(cuda_ms(torch, calls[order], 10))
                ms = {o: statistics.mean(v) for o, v in runs.items()}
                row[shape] = {"gate_ms": ms["gate"],
                              "largest_first_ms": ms["largest_first"],
                              "ms_runs": runs, "rule_share": shares,
                              "tail_cost": ms["gate"]
                              / ms["largest_first"] - 1}
                del calls
                torch.cuda.empty_cache()
            layers.append(row)
        total = {o: sum(r[sh][f"{o}_ms"] for r in layers
                        for sh in ("up", "down"))
                 for o in ("gate", "largest_first")}
        rec[phase] = {"layers": layers,
                      "max_tail_cost": max(r[sh]["tail_cost"]
                                           for r in layers
                                           for sh in ("up", "down")),
                      "step_gate_ms": total["gate"],
                      "step_largest_first_ms": total["largest_first"],
                      "step_tail_cost": total["gate"]
                      / total["largest_first"] - 1}
    routes = {r: c - before[r]
              for r, c in grouped_matmul_dw.route_launches.items()}
    check(routes["cuda_core"] == 0 and routes["wgmma"] > 0,
          f"dw_order: dw launches by route {routes}")
    rec["dw_route_launches"] = routes
    emit(rec)
    return rec


# the parent commit's (cb1a8cf) quantized grouped library: its C entry
# takes the route, as the shipped one does
GQ_PARENT_SIG = {"quant_grouped_matmul_fwd":
                 [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                 + [ctypes.c_void_p]}


# the parent commit's (cb1a8cf) grouped library: its forward's C entry
# takes the route, as the shipped one does; its weight gradient's has no
# route argument (its one dw kernel)
GM_PARENT_SIG = {"grouped_matmul_fwd": [ctypes.c_void_p] * 6
                 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
                 "grouped_matmul_dw": [ctypes.c_void_p] * 5
                 + [ctypes.c_int] * 5 + [ctypes.c_void_p]}


def parent_quant_libs(parent):
    """csrc/quant_grouped_matmul.cu, quant_matmul.cu and grouped_matmul.cu
    of the parent's checkout at `parent`, built beside the shipped ones:
    {"gq": library, "qmm": library, "gm": library}."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import quant_matmul as qmm
    csrc = os.path.join(parent, "paddle_tpu_torch", "csrc")
    return build_variants(
        os.path.join(str(_build.BUILD_DIR), "parent_quant"),
        {"gq": (os.path.join(csrc, "quant_grouped_matmul.cu"),
                GQ_PARENT_SIG, (), None),
         "qmm": (os.path.join(csrc, "quant_matmul.cu"), qmm._SIG, (),
                 None),
         "gm": (os.path.join(csrc, "grouped_matmul.cu"), GM_PARENT_SIG, (),
                None)})


def qmm_wgmma_unchanged(shipped_so, shipped_log, parent):
    """qmm_wgmma's ptxas line and HGMMA count, shipped and parent (the
    helpers it shares with the grouped kernel live in wgmma.cuh): they
    must be equal."""
    rec = {}
    for who, so, log in (("shipped", shipped_so, shipped_log),
                         ("parent", parent.so_path, parent.build_log)):
        rec[who] = {"ptxas": {k: v for k, v in ptxas_kernels(log).items()
                              if k.startswith("qmm_wgmma")},
                    "hgmma": hgmma_counts(so, ("qmm_wgmma",))}
    check(rec["shipped"] == rec["parent"]
          and len(rec["parent"]["hgmma"]) == 2,
          f"qmm_wgmma changed against the parent: {rec}")
    emit({"phase": "qmm_wgmma_against_parent", **rec})
    return rec


class ParentGq:
    """The parent's quantized grouped library under the shipped wrapper,
    each call counted in `calls` (the wrapper's route counts name the
    shipped library's kernels)."""

    def __init__(self, lib):
        self.lib = lib
        self.calls = 0

    def quant_grouped_matmul_fwd(self, *args):
        self.calls += 1
        return self.lib.quant_grouped_matmul_fwd(*args)


class ParentGm:
    """The parent's grouped library under the shipped wrapper: the
    forward passes through (the parent's takes the route too) and the
    weight gradient's route argument is dropped (the parent has one dw
    kernel); each call is counted, the forward's in `calls` and the
    weight gradient's in `dw_calls`."""

    def __init__(self, lib):
        self.lib = lib
        self.calls = 0
        self.dw_calls = 0

    def grouped_matmul_fwd(self, *args):
        self.calls += 1
        return self.lib.grouped_matmul_fwd(*args)

    def grouped_matmul_dw(self, *args):
        self.dw_calls += 1
        return self.lib.grouped_matmul_dw(*args[:-2], args[-1])


def attention_fallback_check(torch, seed):
    """Head dim 96 in bf16 and 128 in float16, which no kernel takes,
    through flash_attention on the card: one "plain" route and no kernel
    launch, forward and backward under autograd, outputs and q, k, v
    gradients against the plain version in float32 on the same values
    (2^-7 |ref| + 1e-4 for outputs, 2^-7 |ref| + 1e-3 of the largest for
    gradients: both compute in float32 from the same values and
    cotangent, the entry rounds to its dtype)."""
    from paddle_tpu_torch.kernels.flash_attention import (_flash_bhsd,
                                                          _flash_bhsd_bwd)
    from paddle_tpu_torch.nn.functional import (flash_attention,
                                                scaled_dot_product_attention)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    cases = {}
    for name, d, dt in (("d96_bf16", 96, torch.bfloat16),
                        ("d128_float16", 128, torch.float16)):
        shape = (2, 1024, 16, d)
        q, k, v, g = (torch.randn(*shape, generator=gen, device="cuda")
                      .to(dt) for _ in range(4))
        g = g.float()          # one cotangent, exact in the entry's dtype
        leaves = [t.requires_grad_() for t in (q, k, v)]
        zero_flash_counts(_flash_bhsd, _flash_bhsd_bwd)
        zero_attention_routes()
        out, _ = flash_attention(*leaves, causal=True)
        (out.float() * g).sum().backward()
        routes = dict(flash_attention.route_launches)
        check(routes == {"kernel": 0, "plain": 1}
              and _flash_bhsd.launches == 0 and _flash_bhsd_bwd.launches == 0,
              f"attention_fallback {name}: routes {routes}, kernel launches "
              f"{_flash_bhsd.launches} + {_flash_bhsd_bwd.launches}")
        ref_leaves = [t.detach().float().requires_grad_() for t in leaves]
        ref = scaled_dot_product_attention(*ref_leaves, is_causal=True)
        (ref * g).sum().backward()
        torch.cuda.synchronize()
        err, ratio = bf16_err(out, ref)
        gerr = []
        for t, r in zip(leaves, ref_leaves):
            gerr.append(bf16_err(t.grad, r.grad,
                                 atol=GRAD_ATOL * r.grad.abs().max().item()))
        check(out.dtype == dt and ratio <= 1.0
              and all(x[1] <= 1.0 for x in gerr),
              f"attention_fallback {name}: output {err} ({ratio} x rule), "
              f"gradients {gerr}")
        cases[name] = {"d": d, "dtype": str(dt).split(".")[-1],
                       "shape": list(shape), "routes": routes,
                       "max_abs_err": err, "err_over_tolerance": ratio,
                       "grad_max_abs_err": [x[0] for x in gerr],
                       "grad_err_over_tolerance": [x[1] for x in gerr]}
        del q, k, v, g, leaves, ref_leaves, out, ref
    torch.cuda.empty_cache()
    rec = {"phase": "attention_fallback", "entry":
           "nn.functional.flash_attention, causal", "cases": cases}
    emit(rec)
    return rec


# -- phases 11-13: packed and masked attention ---------------------------------

PACK_ROWS, PACK_SEQ = 6, 2048      # bench.py's one-chip training batch
PACK_HEADS, PACK_D = 32, 128       # the Llama-2-7B attention widths
PACK_WARMUP, PACK_TIMED = 2, 10
PACK_PARITY_HEADS = 4
PACK_PARITY_ATOL = 1e-5            # float32 outputs, of the largest


def pack_documents(np, seed, rows=PACK_ROWS, seq=PACK_SEQ):
    """Document lengths filling `rows` rows of `seq` tokens each, as a
    packed training batch is built: rng.integers(64, seq + 1) each, the
    last of a row cut to fit (seed 0: 16 documents)."""
    rng = np.random.default_rng(seed)
    lens = []
    for _ in range(rows):
        left = seq
        while left > 0:
            n = min(int(rng.integers(64, seq + 1)), left)
            lens.append(n)
            left -= n
    return lens


def doc_start_rows(np, lens, rows, seq):
    """The same documents as FlashMask start rows [rows, seq]: column c of
    a document ending at row e of its batch row gets start e, so (causal)
    row r sees c iff c <= r < e."""
    out = np.empty((rows, seq), np.int32)
    r, off = 0, 0
    for n in lens:
        out[r, off:off + n] = off + n
        off += n
        if off == seq:
            r, off = r + 1, 0
    return out


def live_pairs(np, lq, lk, causal):
    """(q, k) pairs per head the segment mask keeps: documents pair up by
    index; causal compares positions inside a document."""
    lq, lk = np.asarray(lq, np.int64), np.asarray(lk, np.int64)
    if not causal:
        return int((lq * lk).sum())
    m = np.minimum(lq, lk)
    return int((m * (m + 1) // 2 + (lq - m) * lk).sum())


def varlen_library():
    """torch's own varlen attention call, where this torch has one (a
    yardstick only: the port never calls it)."""
    try:
        from torch.nn.attention.varlen import varlen_attn
    except ImportError:
        return None
    return varlen_attn


def _varlen_library_call(fn, q, k, v, cu, mx, causal, scale):
    import inspect
    params = inspect.signature(fn).parameters
    kw = {"scale": scale}
    if "is_causal" in params:
        kw["is_causal"] = causal
    else:
        kw["window_size"] = (-1, 0) if causal else (-1, -1)
    return fn(q, k, v, cu, cu, mx, mx, **kw)


def _varlen_library_bwd(torch, fn, q, k, v, do, cu, mx, causal, scale,
                        ref):
    """The backward of torch's varlen call where this torch differentiates
    it (a yardstick only): its time, and its largest gradient error
    against the plain backward; else the error it raises."""
    try:
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out = _varlen_library_call(fn, *leaves, cu, mx, causal, scale)
        out = out[0] if isinstance(out, tuple) else out
        grads = torch.autograd.grad(out, leaves, do, retain_graph=True)
        err = max((g.float() - r.float()).abs().max().item()
                  for g, r in zip(grads, ref))
        ms = cuda_ms(torch, lambda: torch.autograd.grad(
            out, leaves, do, retain_graph=True), 10)
        return {"bwd_ms": ms, "bwd_max_abs_err_vs_plain": err}
    except Exception as e:               # a yardstick, not part of the path
        return {"bwd_error": f"{type(e).__name__}: {e}"[:300]}


def _tols(torch, dt):
    """(o rtol, o atol, lse atol, gradient atol of the largest, peak rate)
    of a packed case: bf16 on the bf16 rules and the tensor-core peak,
    float32 to 1e-4 (summation order only) and the float32 peak."""
    if dt == torch.bfloat16:
        return BF16_RTOL, BF16_ATOL, LSE_ATOL, GRAD_ATOL, BF16_FLOPS
    return 0.0, FWD_ATOL_F32, FWD_ATOL_F32, GRAD_ATOL_F32, F32_FLOPS


def _grad_errs(got, ref, rtol=BF16_RTOL, of_max=GRAD_ATOL):
    errs, ratios = {}, {}
    for gname, g, r in zip(("dq", "dk", "dv"), got, ref):
        atol = of_max * r.float().abs().max().item()
        errs[gname], ratios[gname] = bf16_err(g, r, atol, rtol)
    return errs, ratios


def _sdpa_library(torch, name, q4, k4, v4, mask, scale, do4, ref_o, ref_g):
    """SDPA with a boolean mask on [B, H, S, D] copies (made outside the
    timing): forward and backward times, held to LIB_TOL of the plain
    versions' outputs and gradients."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = (x.detach().requires_grad_() for x in (q4, k4, v4))
    out = sdpa(q4, k4, v4, attn_mask=mask, scale=scale)
    lib_check(name, out, ref_o)
    grads = torch.autograd.grad(out, (q4, k4, v4), do4, retain_graph=True)
    for gname, g, r in zip(("dq", "dk", "dv"), grads, ref_g):
        lib_check(f"{name} {gname}", g, r)
    fwd_ms = cuda_ms(torch, lambda: sdpa(q4, k4, v4, attn_mask=mask,
                                         scale=scale), 10)
    bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        out, (q4, k4, v4), do4, retain_graph=True), 10)
    return fwd_ms, bwd_ms


def varlen_case(torch, np, name, lq, lk, h, d, causal, seed, poison=None,
                timed=False, dtype="bfloat16"):
    """Both varlen kernels (the forward; dq and dk/dv) on one packing in
    `dtype` against their plain versions, the backward on the kernel
    forward's o and lse as training gives them (tolerances: `_tols`).
    poison: the index of a document whose q, k, v and dO become NaN: every
    other document's outputs and gradients must equal the clean run's, and
    the poisoned document's must all be NaN. timed:
    also the plain versions' times and the library yardsticks. Each record
    names the route its kernels took. Returns (forward record, backward
    record)."""
    from paddle_tpu_torch.kernels.flash_varlen import (
        BQ, dkv_block, flash_varlen_bwd, flash_varlen_bwd_plain,
        flash_varlen_fwd, flash_varlen_fwd_plain, segments_from_cu,
        varlen_tile_ranges)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    bf = getattr(torch, dtype)
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 plain versions
    rtol, atol, lse_atol, of_max, peak = _tols(torch, bf)
    tq, tk = int(sum(lq)), int(sum(lk))
    q, do = (torch.randn(tq, h, d, generator=gen, device=dev, dtype=bf)
             for _ in range(2))
    k, v = (torch.randn(tk, h, d, generator=gen, device=dev, dtype=bf)
            for _ in range(2))
    cu_q = torch.as_tensor(np.cumsum([0] + list(lq)), dtype=torch.int32,
                           device=dev)
    cu_k = torch.as_tensor(np.cumsum([0] + list(lk)), dtype=torch.int32,
                           device=dev)
    sq, pq = segments_from_cu(cu_q, tq)
    sk, pk = segments_from_cu(cu_k, tk)
    scale = d ** -0.5
    seg = (sq, pq, sk, pk, causal, scale)
    routed = dict(flash_varlen_fwd.route_launches)
    o, lse = flash_varlen_fwd(q, k, v, *seg)
    route = next(r for r, n in flash_varlen_fwd.route_launches.items()
                 if n > routed[r])
    ro, rlse = flash_varlen_fwd_plain(q, k, v, *seg)
    routed = dict(flash_varlen_bwd.route_launches)
    got = flash_varlen_bwd(q, k, v, o, lse, do, *seg)
    bwd_route = next(r for r, n in flash_varlen_bwd.route_launches.items()
                     if n > routed[r])
    ref = flash_varlen_bwd_plain(q, k, v, o, lse, do, *seg)
    torch.cuda.synchronize()
    err, ratio = bf16_err(o, ro, atol, rtol)
    lse_err = (lse - rlse).abs().max().item()
    check(ratio <= 1.0 and lse_err <= lse_atol,
          f"{name}: varlen forward vs plain o err {err} ({ratio} x "
          f"tolerance), lse err {lse_err}")
    errs, ratios = _grad_errs(got, ref, rtol, of_max)
    gratio = max(ratios.values())
    check(math.isfinite(gratio) and gratio <= 1.0,
          f"{name}: varlen backward vs plain errors {errs}, {ratios} x "
          f"tolerance")
    cq, ck = np.cumsum([0] + list(lq)), np.cumsum([0] + list(lk))
    keyless = [i for i in range(len(lq)) if lq[i] and not lk[i]]
    for i in keyless:          # rows whose k document is empty: 0, dq 0
        rows = slice(int(cq[i]), int(cq[i + 1]))
        check(not o[rows].any() and not got[0][rows].any(),
              f"{name}: keyless rows of document {i} are not 0")
    if poison is not None:
        kq = torch.ones(tq, dtype=torch.bool, device=dev)
        kk = torch.ones(tk, dtype=torch.bool, device=dev)
        kq[int(cq[poison]):int(cq[poison + 1])] = False
        kk[int(ck[poison]):int(ck[poison + 1])] = False
        qp, kp, vp, dop = q.clone(), k.clone(), v.clone(), do.clone()
        for x, keep in ((qp, kq), (kp, kk), (vp, kk), (dop, kq)):
            x[~keep] = float("nan")
        po, plse = flash_varlen_fwd(qp, kp, vp, *seg)
        pg = flash_varlen_bwd(qp, kp, vp, po, plse, dop, *seg)
        torch.cuda.synchronize()
        for what, a, b, keep in (("o", po, o, kq), ("dq", pg[0], got[0], kq),
                                 ("dk", pg[1], got[1], kk),
                                 ("dv", pg[2], got[2], kk)):
            check(bool(torch.isfinite(a[keep]).all())
                  and torch.equal(a[keep], b[keep]),
                  f"{name}: NaN in document {poison} reached another "
                  f"document's {what}")
            check(bool(torch.isnan(a[~keep]).all()),
                  f"{name}: document {poison}'s {what} is not all NaN")
    kernel_ms = cuda_ms(torch, lambda: flash_varlen_fwd(q, k, v, *seg), 10)
    kernel_bwd_ms = cuda_ms(torch, lambda: flash_varlen_bwd(
        q, k, v, o, lse, do, *seg), 10)
    plain_ms = plain_bwd_ms = library_ms = library_bwd_ms = None
    varlen_lib = {}
    if timed:
        plain_ms = cuda_ms(torch, lambda: flash_varlen_fwd_plain(
            q, k, v, *seg), 2, warmup=1)
        plain_bwd_ms = cuda_ms(torch, lambda: flash_varlen_bwd_plain(
            q, k, v, o, lse, do, *seg), 2, warmup=1)
        # yardstick: SDPA over the whole pack with the block-diagonal
        # (causal) boolean mask, built outside the timing
        mask = sq[:, None] == sk[None, :]
        if causal:
            mask &= pq[:, None] >= pk[None, :]
        q4, k4, v4, do4 = (x.transpose(0, 1)[None].contiguous()
                           for x in (q, k, v, do))
        library_ms, library_bwd_ms = _sdpa_library(
            torch, name, q4, k4, v4, mask[None, None], scale, do4,
            ro.transpose(0, 1)[None],
            [g.transpose(0, 1)[None] for g in ref])
        del mask, q4, k4, v4, do4
        fn = varlen_library()
        if fn is None:
            varlen_lib = {"available": False}
        elif lq == lk:
            try:
                lo = _varlen_library_call(fn, q, k, v, cu_q,
                                          max(lq), causal, scale)
                lo = lo[0] if isinstance(lo, tuple) else lo
                varlen_lib = {
                    "available": True,
                    "max_abs_err_vs_plain":
                        (lo.float() - ro.float()).abs().max().item(),
                    "ms": cuda_ms(torch, lambda: _varlen_library_call(
                        fn, q, k, v, cu_q, max(lq), causal, scale),
                        10)}
            except Exception as e:       # a yardstick, not part of the path
                varlen_lib = {"available": True,
                              "error": f"{type(e).__name__}: {e}"[:300]}
            if "ms" in varlen_lib:
                varlen_lib.update(_varlen_library_bwd(
                    torch, fn, q, k, v, do, cu_q, max(lq), causal, scale,
                    ref))
    pairs = live_pairs(np, lq, lk, causal)
    rq = varlen_tile_ranges(sq, pq, sk, pk, BQ, causal, True)
    rk = varlen_tile_ranges(sk, pk, sq, pq, dkv_block(d), causal, False)
    rq_rows = torch.clamp(tq - torch.arange(rq.shape[0], device=dev) * BQ,
                          max=BQ)
    rk_rows = torch.clamp(tk - torch.arange(rk.shape[0], device=dev)
                          * dkv_block(d), max=dkv_block(d))
    visited_fwd = int((rq_rows * (rq[:, 1] - rq[:, 0]).clamp(min=0)).sum())
    visited_dkv = int((rk_rows * (rk[:, 1] - rk[:, 0]).clamp(min=0)).sum())
    isz = q.element_size()
    common = {"phase": "kernel_check", "case": name, "dtype": dtype,
              "heads": h, "d": d, "causal": causal, "total_q": tq,
              "total_k": tk, "docs_q": list(lq), "docs_k": list(lk),
              "live_pairs_per_head": pairs,
              "dense_pairs_per_head": tq * tk,
              "visited_pairs_per_head_fwd_dq": visited_fwd,
              "visited_pairs_per_head_dkv": visited_dkv,
              "fwd_wgmma_tiles_per_head": dict(zip(
                  ("wholly_live", "partial"),
                  varlen_fwd_tiles(np, sq, pq, sk, pk, causal, rq))),
              "keyless_docs": keyless, "nan_poisoned_doc": poison}
    flops = 4 * h * d * pairs
    seg_bytes = 8 * (tq + tk)
    fbytes = (2 * tq + 2 * tk) * h * d * isz + 4 * h * tq + seg_bytes
    bound_ms, bound_by = bound(fbytes, flops, peak)
    fwd = dict(common, kernel="flash_varlen_fwd", route=route,
               max_abs_err=err,
               err_over_tolerance=ratio, rtol=rtol, atol=atol,
               lse_max_abs_err=lse_err, lse_atol=lse_atol,
               kernel_ms=kernel_ms, plain_ms=plain_ms,
               library_ms=library_ms,
               library="scaled_dot_product_attention, block-diagonal "
                       "boolean mask over the pack",
               library_varlen_attn=varlen_lib, bound_ms=bound_ms,
               bound_by=bound_by, bound_share=bound_ms / kernel_ms,
               bytes=fbytes, flops=flops, tflops=flops / kernel_ms / 1e9)
    emit(fwd)
    flops = 10 * h * d * pairs            # 2.5 x the forward
    bbytes = (3 * tq + 2 * tk + tq + 2 * tk) * h * d * isz \
        + 8 * h * tq + seg_bytes
    bound_ms, bound_by = bound(bbytes, flops, peak)
    bwd = dict(common, kernel="flash_varlen_bwd", route=bwd_route,
               max_abs_err=max(errs.values()), max_abs_err_by_grad=errs,
               err_over_tolerance=gratio, rtol=rtol,
               grad_atol_of_max=of_max, kernel_ms=kernel_bwd_ms,
               plain_ms=plain_bwd_ms, library_ms=library_bwd_ms,
               library="backward of that SDPA call", bound_ms=bound_ms,
               bound_by=bound_by, bound_share=bound_ms / kernel_bwd_ms,
               bytes=bbytes, flops=flops,
               tflops=flops / kernel_bwd_ms / 1e9)
    emit(bwd)
    return fwd, bwd


def varlen_fwd_tiles(np, sq, pq, sk, pk, causal, rq):
    """The 64-key tiles the tensor-core forward visits for one head:
    (wholly live, others). A tile is wholly live when its 64 keys lie in
    the q tile's range and each is live for the tile's first and last rows
    (csrc/flash_masked.cuh); the others take the pair test and the NaN
    guard."""
    sq, pq, sk, pk = (x.cpu().numpy() for x in (sq, pq, sk, pk))
    full = part = 0
    for t, (lo, hi) in enumerate(rq.cpu().tolist()):
        rows = [t * 64, min(t * 64 + 64, len(sq)) - 1]
        for k0 in range(lo, hi, 64):
            cols = slice(k0, k0 + 64)
            ok = k0 + 64 <= hi and all(
                ((sq[r] == sk[cols])
                 & (pq[r] >= pk[cols] if causal else True)).all()
                for r in rows)
            full += ok
            part += not ok
    return full, part


def sparse_mask_fwd_tiles(torch, start, causal):
    """The same count for FlashMask, summed over the B*H heads: the
    64-key tiles up to the diagonal (causal) that the tile maxima do not
    skip, wholly live when each column's start is past the q tile's last
    row (and, causal, the tile lies below the diagonal)."""
    from paddle_tpu_torch.kernels.flash_sparse_mask import tile_max
    bh, s = start.shape
    n = -(-s // 64)
    st = torch.zeros(bh, n * 64, dtype=torch.int32, device=start.device)
    st[:, :s] = start
    st = st.reshape(bh, 1, n, 64)
    q0 = torch.arange(n, device=start.device) * 64
    q1 = (q0 + 64).clamp(max=s)
    col = torch.arange(n * 64, device=start.device).reshape(1, 1, n, 64)
    ok = (q1 - 1).reshape(1, n, 1, 1) < st
    if causal:
        ok &= q0.reshape(1, n, 1, 1) >= col
    hi = (q1 if causal else torch.full_like(q1, s)).reshape(1, n, 1)
    k0 = q0.reshape(1, 1, n)
    full = ok.all(-1) & (k0 + 64 <= hi)
    tm = tile_max(start)
    tm = torch.cat([tm, tm.new_zeros(bh, 2 * n - tm.shape[1])], 1)
    dead = q0.reshape(1, n, 1) >= tm.reshape(bh, 1, n, 2).amax(-1)
    visited = (k0 < hi) & ~dead
    return int((visited & full).sum()), int((visited & ~full).sum())


def sparse_mask_pairs(torch, start, causal):
    """(q, k) pairs FlashMask keeps, summed over the B*H heads: column c
    is seen by rows [c if causal else 0, min(start[c], S))."""
    s = start.shape[-1]
    lo = torch.arange(s, device=start.device) if causal else 0
    return int((start.long().clamp(max=s) - lo).clamp(min=0).sum())


def sparse_mask_visited(torch, start, causal):
    """Pairs the forward's tile loop visits, summed over heads: 64 rows
    times 32 columns for each key tile at or below the diagonal whose
    largest start is past the q tile's first row."""
    from paddle_tpu_torch.kernels.flash_sparse_mask import TILE, tile_max
    s = start.shape[-1]
    tm = tile_max(start)                                    # [BH, n32]
    q0 = torch.arange(0, s, 64, device=start.device)
    rows = (s - q0).clamp(max=64)
    k0 = torch.arange(tm.shape[1], device=start.device) * TILE
    live = q0[None, :, None] < tm[:, None, :]
    if causal:
        live &= k0[None, None, :] < (q0 + 64).clamp(max=s)[None, :, None]
    return int((live.long() * rows[None, :, None]).sum() * TILE)


def sparse_mask_case(torch, np, name, b, s, h, d, causal, start, seed,
                     poison=None, timed=False, dtype="bfloat16"):
    """Both FlashMask kernels on [b, s, h, d] `dtype` with start rows
    `start` (int32 on the card, [b, 1, s] shared by the heads or [b*h, s])
    against their plain versions (chunked over b*h; tolerances: `_tols`).
    poison: (batch row, first,
    end) rows whose q, k, v and dO become NaN: every other row's outputs and
    gradients must equal the clean run's, and the poisoned rows' must all
    be NaN. Each record names the route its kernels took. Returns
    (forward record, backward record)."""
    from paddle_tpu_torch.kernels.flash_sparse_mask import (
        flash_sparse_mask_bwd, flash_sparse_mask_bwd_plain,
        flash_sparse_mask_fwd, flash_sparse_mask_fwd_plain)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dt = getattr(torch, dtype)
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 plain versions
    rtol, atol, lse_atol, of_max, peak = _tols(torch, dt)
    q, k, v, do = (torch.randn(b, s, h, d, generator=gen, device=dev,
                               dtype=dt) for _ in range(4))
    shared = start.dim() == 3
    st = start.expand(b, h, s).reshape(b * h, s).contiguous() if shared \
        else start
    scale = d ** -0.5
    routed = dict(flash_sparse_mask_fwd.route_launches)
    o, lse = flash_sparse_mask_fwd(q, k, v, st, causal, scale)
    route = next(r for r, n in flash_sparse_mask_fwd.route_launches.items()
                 if n > routed[r])
    ro, rlse = flash_sparse_mask_fwd_plain(q, k, v, st, causal, scale)
    routed = dict(flash_sparse_mask_bwd.route_launches)
    got = flash_sparse_mask_bwd(q, k, v, o, lse, do, st, causal, scale)
    bwd_route = next(r for r, n in
                     flash_sparse_mask_bwd.route_launches.items()
                     if n > routed[r])
    ref = flash_sparse_mask_bwd_plain(q, k, v, o, lse, do, st, causal,
                                      scale)
    torch.cuda.synchronize()
    err, ratio = bf16_err(o, ro, atol, rtol)
    lse_err = (lse - rlse).abs().max().item()
    check(ratio <= 1.0 and lse_err <= lse_atol,
          f"{name}: FlashMask forward vs plain o err {err} ({ratio} x "
          f"tolerance), lse err {lse_err}")
    errs, ratios = _grad_errs(got, ref, rtol, of_max)
    gratio = max(ratios.values())
    check(math.isfinite(gratio) and gratio <= 1.0,
          f"{name}: FlashMask backward vs plain errors {errs}, {ratios} x "
          f"tolerance")
    if poison is not None:
        row, a, e = poison
        keep = torch.ones(b, s, dtype=torch.bool, device=dev)
        keep[row, a:e] = False
        qp, kp, vp, dop = q.clone(), k.clone(), v.clone(), do.clone()
        for x in (qp, kp, vp, dop):
            x[~keep] = float("nan")
        po, plse = flash_sparse_mask_fwd(qp, kp, vp, st, causal, scale)
        pg = flash_sparse_mask_bwd(qp, kp, vp, po, plse, dop, st, causal,
                                   scale)
        torch.cuda.synchronize()
        for what, x, y in (("o", po, o), ("dq", pg[0], got[0]),
                           ("dk", pg[1], got[1]), ("dv", pg[2], got[2])):
            check(bool(torch.isfinite(x[keep]).all())
                  and torch.equal(x[keep], y[keep]),
                  f"{name}: NaN in rows {a}:{e} of batch row {row} reached "
                  f"another document's {what}")
            check(bool(torch.isnan(x[~keep]).all()),
                  f"{name}: rows {a}:{e}'s {what} is not all NaN")
    kernel_ms = cuda_ms(torch, lambda: flash_sparse_mask_fwd(
        q, k, v, st, causal, scale), 10)
    kernel_bwd_ms = cuda_ms(torch, lambda: flash_sparse_mask_bwd(
        q, k, v, o, lse, do, st, causal, scale), 10)
    plain_ms = plain_bwd_ms = library_ms = library_bwd_ms = None
    if timed:
        plain_ms = cuda_ms(torch, lambda: flash_sparse_mask_fwd_plain(
            q, k, v, st, causal, scale), 2, warmup=1)
        plain_bwd_ms = cuda_ms(torch, lambda: flash_sparse_mask_bwd_plain(
            q, k, v, o, lse, do, st, causal, scale), 2, warmup=1)
        # yardstick: SDPA with the [b, 1, s, s] boolean mask (start rows
        # shared by the heads), built outside the timing
        rows = torch.arange(s, device=dev)[:, None]
        mask = rows < start.reshape(b, 1, 1, s)
        if causal:
            mask &= rows >= torch.arange(s, device=dev)[None, :]
        q4, k4, v4, do4 = (x.transpose(1, 2).contiguous()
                           for x in (q, k, v, do))
        library_ms, library_bwd_ms = _sdpa_library(
            torch, name, q4, k4, v4, mask, scale, do4, ro.transpose(1, 2),
            [g.transpose(1, 2) for g in ref])
        del mask, q4, k4, v4, do4
    pairs = sparse_mask_pairs(torch, st, causal)
    common = {"phase": "kernel_check", "case": name, "dtype": dtype,
              "b": b, "s": s, "heads": h, "d": d, "causal": causal,
              "start_shared_by_heads": shared,
              "live_pairs": pairs, "dense_pairs": b * h * s * s,
              "visited_pairs_fwd_dq": sparse_mask_visited(torch, st,
                                                          causal),
              "fwd_wgmma_tiles": dict(zip(
                  ("wholly_live", "partial"),
                  sparse_mask_fwd_tiles(torch, st, causal))),
              "nan_poisoned_columns": poison}
    isz = q.element_size()
    flops = 4 * d * pairs
    fbytes = 4 * b * s * h * d * isz + 8 * b * h * s
    bound_ms, bound_by = bound(fbytes, flops, peak)
    fwd = dict(common, kernel="flash_sparse_mask_fwd", route=route,
               max_abs_err=err,
               err_over_tolerance=ratio, rtol=rtol, atol=atol,
               lse_max_abs_err=lse_err, lse_atol=lse_atol,
               kernel_ms=kernel_ms, plain_ms=plain_ms,
               library_ms=library_ms,
               library="scaled_dot_product_attention, [b, 1, s, s] "
                       "boolean mask", bound_ms=bound_ms, bound_by=bound_by,
               bound_share=bound_ms / kernel_ms, bytes=fbytes, flops=flops,
               tflops=flops / kernel_ms / 1e9)
    emit(fwd)
    flops = 10 * d * pairs
    bbytes = 8 * b * s * h * d * isz + 12 * b * h * s
    bound_ms, bound_by = bound(bbytes, flops, peak)
    bwd = dict(common, kernel="flash_sparse_mask_bwd", route=bwd_route,
               max_abs_err=max(errs.values()), max_abs_err_by_grad=errs,
               err_over_tolerance=gratio, rtol=rtol,
               grad_atol_of_max=of_max, kernel_ms=kernel_bwd_ms,
               plain_ms=plain_bwd_ms, library_ms=library_bwd_ms,
               library="backward of that SDPA call", bound_ms=bound_ms,
               bound_by=bound_by, bound_share=bound_ms / kernel_bwd_ms,
               bytes=bbytes, flops=flops,
               tflops=flops / kernel_bwd_ms / 1e9)
    emit(bwd)
    return fwd, bwd


def packed_kernel_checks(torch, np, lens, seed):
    """Phase 11: the varlen and FlashMask kernels against their plain
    versions: the main packed shape (timed with its plain versions and
    yardsticks), float32 at packed_parity's shapes (timed: the CUDA-core
    forward's rows), D 64 and 256 (D 256 timed too), a total of 1000,
    empty documents, unequal packs with an empty k document, random start
    rows, and NaN isolation. Every bf16 forward and backward at D 64 and
    128 must have taken the tensor-core route, float32 and D 256 the CUDA
    cores. Returns the records of the main cases (forward, backward, both
    policies) and of the float32 cases (forward, backward, both
    policies)."""
    dev = torch.device("cuda")
    small = pack_documents(np, seed, rows=2)               # 4096 tokens
    recs = []
    vf, vb = varlen_case(torch, np, "main_pack_32x128_causal", lens, lens,
                         PACK_HEADS, PACK_D, True, seed, timed=True)
    recs += [vf, vb]
    for d in (64, 256):
        recs += varlen_case(torch, np, f"pack4096_h8_d{d}_causal", small,
                            small, 8, d, True, seed + d, timed=d == 256)
    for args in (("total1000_h8_d128_causal",
                  (1, 63, 64, 65, 300, 7, 500), (1, 63, 64, 65, 300, 7, 500),
                  8, 128, True, seed + 1),
                 ("empty_docs_h8_d128_causal", (700, 0, 333, 290, 0),
                  (700, 0, 333, 290, 0), 8, 128, True, seed + 2),
                 ("unequal_keyless_h8_d128_full", (300, 200, 250, 250),
                  (280, 0, 300, 120), 8, 128, False, seed + 3)):
        recs += varlen_case(torch, np, *args)
    recs += varlen_case(torch, np, "nan_doc2_h8_d128_causal", small, small,
                        8, 128, True, seed + 4, poison=2)
    # packed_parity's inputs: float32, 4 heads, on the CUDA cores
    vf32, vb32 = varlen_case(torch, np, "parity_pack_4x128_causal_f32",
                             lens, lens, PACK_PARITY_HEADS, PACK_D, True,
                             seed + 10, timed=True, dtype="float32")
    recs += [vf32, vb32]
    start = torch.as_tensor(doc_start_rows(np, lens, PACK_ROWS, PACK_SEQ),
                            device=dev)[:, None, :]            # [6, 1, S]
    mf, mb = sparse_mask_case(torch, np, "main_docs_6x2048x32x128_causal",
                              PACK_ROWS, PACK_SEQ, PACK_HEADS, PACK_D, True,
                              start, seed, timed=True)
    recs += [mf, mb]
    mf32, mb32 = sparse_mask_case(
        torch, np, "parity_docs_6x2048x4x128_causal_f32", PACK_ROWS,
        PACK_SEQ, PACK_PARITY_HEADS, PACK_D, True, start, seed + 11,
        timed=True, dtype="float32")
    recs += [mf32, mb32]
    rng = np.random.default_rng(seed + 5)
    for causal in (True, False):       # as tests/test_varlen_flash.py
        rs = torch.as_tensor(rng.integers(1, 2049, (2 * 8, 2048))
                             .astype(np.int32), device=dev)
        recs += sparse_mask_case(
            torch, np, f"random_start_2x2048x8x128_"
                       f"{'causal' if causal else 'full'}",
            2, 2048, 8, 128, causal, rs, seed + 6 + causal)
    docs1000 = (1, 63, 64, 65, 300, 7, 500)
    st1000 = torch.as_tensor(doc_start_rows(np, docs1000 * 2, 2, 1000),
                             device=dev)[:, None, :]
    for d in (64, 256):
        recs += sparse_mask_case(torch, np, f"docs_2x1000x4_d{d}_causal", 2,
                                 1000, 4, d, True, st1000, seed + d,
                                 timed=d == 256)
    recs += sparse_mask_case(torch, np, "nan_doc0_6x2048x8x128_causal",
                             PACK_ROWS, PACK_SEQ, 8, 128, True, start,
                             seed + 9, poison=(0, 0, lens[0]))
    for rec in recs:
        want = "cuda_core" if rec["d"] == 256 or rec["dtype"] == "float32" \
            else "wgmma"
        check(rec["route"] == want, f"{rec['case']}: {rec['kernel']} "
                                    f"routed to {rec['route']}")
    return vf, vb, mf, mb, vf32, vb32, mf32, mb32


NAN_GUARD_BUILDS = (1, 2, 0)      # the kernel's rule, every tile, none


def nan_guard_cost(torch, np, lens, seed):
    """--nan-guard-cost: the tensor-core masked kernels' NaN guard, timed.
    flash_varlen.cu and flash_sparse_mask.cu are built twice more, with the
    scan (V in the forward, K in dq, Q and dO in dk/dv) on every 64-row
    tile (-DPTT_NAN_GUARD=2) and on none (0), into a directory of their
    own; the main varlen and FlashMask forwards and backwards (bf16,
    [12288, 32, 128] and [6, 2048, 32, 128], causal) run on each build in
    turn, three rounds. On clean inputs every build gives the same bits,
    which is checked. Prints one line: the median ms of each build, the
    forward's tiles, and the scan's share of each kernel's time."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_sparse_mask as fsm
    from paddle_tpu_torch.kernels import flash_varlen as fv
    mods = {"flash_varlen": fv, "flash_sparse_mask": fsm}
    libs = {(src, 1): _build.load(src, mods[src]._SIG) for src in mods}
    libs.update(build_variants(
        os.path.join(str(_build.BUILD_DIR), "nan_guard"),
        {(src, g): (src, mods[src]._SIG, (f"-DPTT_NAN_GUARD={g}",), None)
         for src in mods for g in NAN_GUARD_BUILDS[1:]}))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    h, d, tokens = PACK_HEADS, PACK_D, sum(lens)
    q, k, v, do = (torch.randn(tokens, h, d, generator=gen, device=dev,
                               dtype=torch.bfloat16) for _ in range(4))
    cu = torch.as_tensor(np.cumsum([0] + list(lens)), dtype=torch.int32,
                         device=dev)
    sq, pq = fv.segments_from_cu(cu, tokens)
    seg = (sq, pq, sq, pq, True, d ** -0.5)
    start = torch.as_tensor(doc_start_rows(np, lens, PACK_ROWS, PACK_SEQ),
                            device=dev)[:, None, :]
    st = start.expand(PACK_ROWS, h, PACK_SEQ).reshape(-1, PACK_SEQ) \
        .contiguous()
    q4, k4, v4, do4 = (x.reshape(PACK_ROWS, PACK_SEQ, h, d)
                       for x in (q, k, v, do))
    o, lse = fv.flash_varlen_fwd(q, k, v, *seg)
    o4, lse4 = fsm.flash_sparse_mask_fwd(q4, k4, v4, st, True, d ** -0.5)
    runs = {("flash_varlen", "fwd"): lambda: fv.flash_varlen_fwd(
                q, k, v, *seg),
            ("flash_varlen", "bwd"): lambda: fv.flash_varlen_bwd(
                q, k, v, o, lse, do, *seg),
            ("flash_sparse_mask", "fwd"): lambda: fsm.flash_sparse_mask_fwd(
                q4, k4, v4, st, True, d ** -0.5),
            ("flash_sparse_mask", "bwd"): lambda: fsm.flash_sparse_mask_bwd(
                q4, k4, v4, o4, lse4, do4, st, True, d ** -0.5)}
    rq = fv.varlen_tile_ranges(sq, pq, sq, pq, fv.BQ, True, True)
    tiles = {"flash_varlen": [h * n for n in
                              varlen_fwd_tiles(np, sq, pq, sq, pq, True, rq)],
             "flash_sparse_mask": list(sparse_mask_fwd_tiles(torch, st,
                                                             True))}
    ms = {(key, g): [] for key in runs for g in NAN_GUARD_BUILDS}
    ref = {}
    try:
        for _ in range(3):
            for key, run in runs.items():
                for g in NAN_GUARD_BUILDS:
                    _build._libs[key[0]] = libs[key[0], g]
                    got = run()
                    ref.setdefault(key, got)
                    check(all(torch.equal(a, b)
                              for a, b in zip(got, ref[key])),
                          f"{key}: the build with PTT_NAN_GUARD={g} gives "
                          f"other bits on clean inputs")
                    ms[key, g].append(cuda_ms(torch, run, 10))
    finally:
        for src in mods:
            _build._libs[src] = libs[src, 1]
    rec = {"phase": "nan_guard_cost", "dtype": "bfloat16", "heads": h,
           "d": d, "tokens": tokens}
    for (src, way) in runs:
        med = {g: statistics.median(ms[(src, way), g])
               for g in NAN_GUARD_BUILDS}
        r = {"ms_partial_tiles": med[1], "ms_every_tile": med[2],
             "ms_no_scan": med[0],
             "ms_runs": {str(g): ms[(src, way), g]
                         for g in NAN_GUARD_BUILDS},
             "share_of_kernel": (med[1] - med[0]) / med[1]}
        if way == "fwd":
            full, part = tiles[src]
            # the run's extra time over the tiles scanned (all blocks at
            # once: wall time, not a block's time)
            r.update(tiles_wholly_live=full, tiles_partial=part,
                     wall_ns_per_tile_every_tile=(med[2] - med[0]) * 1e6
                     / (full + part),
                     wall_ns_per_tile_partial=(med[1] - med[0]) * 1e6 / part)
        rec[f"{src}_{way}"] = r
    emit(rec)
    return rec


def _leaves(torch, gen, shape, dtype):
    return [torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)
            .requires_grad_() for _ in range(3)]


def _packed_path(torch, phase, run, fwd_fn, bwd_fn, leaves, tokens, pairs,
                 extra):
    """The timed loop of a packed-attention path phase: PACK_WARMUP +
    PACK_TIMED forward and backward passes through autograd (gradients
    reset to None first, as a training step's zero_grad), one launch of
    each kernel per pass, every forward and backward on the tensor cores
    (bf16 at D 128)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_flash_counts(fwd_fn, bwd_fn)
    zero_attention_routes()

    def one():
        for t in leaves:
            t.grad = None
        return run()

    for _ in range(PACK_WARMUP):
        one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PACK_TIMED):
        out = one()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    passes = PACK_WARMUP + PACK_TIMED
    fl, bl = fwd_fn.launches, bwd_fn.launches
    routes = dict(fwd_fn.route_launches)
    bwd_routes = dict(bwd_fn.route_launches)
    attn_routes = attention_routes_without_plain(phase)
    check(fl == passes and bl == passes,
          f"{phase}: forward launches {fl}, backward {bl} != one each per "
          f"pass x {passes}")
    check(routes["wgmma"] == passes and bwd_routes["wgmma"] == passes,
          f"{phase}: forward routes {routes}, backward {bwd_routes}, not "
          f"all on the tensor cores")
    check(bool(torch.isfinite(out).all())
          and all(bool(torch.isfinite(t.grad).all()) for t in leaves),
          f"{phase}: non-finite output or gradient")
    flops = 14 * PACK_HEADS * PACK_D * pairs       # forward 4, backward 10
    rec = dict({"phase": phase, "dtype": "bfloat16", "heads": PACK_HEADS,
                "d": PACK_D, "tokens": tokens, "causal": True,
                "warmup_passes": PACK_WARMUP, "timed_passes": PACK_TIMED,
                "wall_s": wall, "ms_per_fwd_bwd": wall / PACK_TIMED * 1e3,
                "tokens_per_s": tokens * PACK_TIMED / wall,
                "live_pairs_per_head": pairs,
                "dense_causal_pairs_per_head": tokens * (tokens + 1) // 2,
                "tflops_live": flops * PACK_TIMED / wall / 1e12,
                "peak_device_bytes": torch.cuda.max_memory_allocated(),
                "fwd_launches": fl, "bwd_launches": bl,
                "fwd_route_launches": routes,
                "bwd_route_launches": bwd_routes,
                "attention_route_launches": attn_routes}, **extra)
    emit(rec)
    return rec


def packed_profile_phase(torch, phase, run, leaves, passes=3):
    """--profile only: `passes` forward+backward passes of a packed path,
    run once plainly for their wall time and once under torch.profiler for
    the device time of the forward, dq and dk/dv kernels and the rest
    (segments, ranges, delta, gradient buffers), and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    def one():
        for t in leaves:
            t.grad = None
        run()

    one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(passes):
        one()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(passes):
            one()
        torch.cuda.synchronize()
    rows, busy_s = device_kernel_rows(prof)
    groups = {"forward": 0.0, "dq": 0.0, "dkv": 0.0, "other": 0.0}
    calls = {"forward": 0, "dq": 0, "dkv": 0}
    for us, name, n in rows:
        key = ("forward" if "masked_fwd" in name else
               "dq" if "masked_dq" in name else
               "dkv" if "masked_dkv" in name else "other")
        groups[key] += us / 1e3
        if key in calls:
            calls[key] += n
    # the profiler may keep fewer launches than ran; then only the
    # per-launch times stand, and the busy and idle shares are not known
    whole = rows and all(n == passes for n in calls.values())
    rec = {"phase": phase, "passes": passes, "wall_s": wall,
           "ms_per_pass": wall / passes * 1e3,
           "kernel_launches_kept": calls,
           "device_ms_per_launch": {k: groups[k] / n if n else None
                                    for k, n in calls.items()},
           "device_busy_s": busy_s if whole else "not measured",
           "device_idle_share": 1 - busy_s / wall if whole
           else "not measured",
           "device_ms_per_pass_by_group": {
               k: v / passes for k, v in groups.items()} if whole
           else "not measured",
           "top_device_kernels": top_kernels(rows, busy_s, 8)
           if rows else []}
    emit(rec)
    return rec


def varlen_attn_phase(torch, np, lens, seed, profile=False):
    """Phase 12: flash_attn_unpadded on the packed batch ([12288, 32, 128]
    bf16 leaves, causal, one pack), forward and backward through
    autograd."""
    from paddle_tpu_torch.kernels.flash_varlen import (flash_varlen_bwd,
                                                       flash_varlen_fwd)
    from paddle_tpu_torch.nn.functional import flash_attn_unpadded
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    tokens = sum(lens)
    shape = (tokens, PACK_HEADS, PACK_D)
    q, k, v = _leaves(torch, gen, shape, torch.bfloat16)
    g = torch.randn(*shape, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    cu = torch.as_tensor(np.cumsum([0] + list(lens)), dtype=torch.int32,
                         device="cuda")
    mx = max(lens)

    def run():
        out = flash_attn_unpadded(q, k, v, cu, cu, mx, mx,
                                  PACK_D ** -0.5, causal=True)
        out.backward(g)
        return out

    rec = _packed_path(torch, "varlen_attn", run, flash_varlen_fwd,
                       flash_varlen_bwd, (q, k, v), tokens,
                       live_pairs(np, lens, lens, True),
                       {"entry": "nn.functional.flash_attn_unpadded",
                        "documents": list(lens)})
    if profile:
        packed_profile_phase(torch, "profile_varlen_attn", run, (q, k, v))
    del q, k, v, g
    torch.cuda.empty_cache()
    return rec


def flashmask_attn_phase(torch, np, lens, seed, profile=False):
    """Phase 12b: flash_attention_with_sparse_mask on [6, 2048, 32, 128]
    bf16 leaves, causal, the same documents as [6, 1, 2048] start rows."""
    from paddle_tpu_torch.kernels.flash_sparse_mask import (
        flash_sparse_mask_bwd, flash_sparse_mask_fwd)
    from paddle_tpu_torch.nn.functional import (
        flash_attention_with_sparse_mask)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    shape = (PACK_ROWS, PACK_SEQ, PACK_HEADS, PACK_D)
    q, k, v = _leaves(torch, gen, shape, torch.bfloat16)
    g = torch.randn(*shape, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    start = torch.as_tensor(doc_start_rows(np, lens, PACK_ROWS, PACK_SEQ),
                            device="cuda")[:, None, :]

    def run():
        out = flash_attention_with_sparse_mask(q, k, v, start,
                                               is_causal=True)
        out.backward(g)
        return out

    rec = _packed_path(torch, "flashmask_attn", run, flash_sparse_mask_fwd,
                       flash_sparse_mask_bwd, (q, k, v), sum(lens),
                       live_pairs(np, lens, lens, True),
                       {"entry": "nn.functional."
                                 "flash_attention_with_sparse_mask",
                        "start_rows": "[6, 1, 2048], documents"})
    if profile:
        packed_profile_phase(torch, "profile_flashmask_attn", run,
                             (q, k, v))
    del q, k, v, g
    torch.cuda.empty_cache()
    return rec


def packed_parity_phase(torch, np, lens, seed):
    """Phase 13: the varlen and FlashMask paths on the same documents
    through independent kernels, float32 at 4 heads (TF32 off): outputs
    and q, k, v gradients element by element after reshaping [12288, 4,
    128] <-> [6, 2048, 4, 128]. Then FlashMask with start rows S (masks
    nothing) and causal against the dense flash_attention kernels. Every
    masked forward and backward runs on the CUDA cores."""
    from paddle_tpu_torch.kernels.flash_attention import (_flash_bhsd,
                                                          _flash_bhsd_bwd)
    from paddle_tpu_torch.kernels.flash_sparse_mask import (
        flash_sparse_mask_bwd, flash_sparse_mask_fwd)
    from paddle_tpu_torch.kernels.flash_varlen import (flash_varlen_bwd,
                                                       flash_varlen_fwd)
    from paddle_tpu_torch.nn.functional import (
        flash_attention, flash_attention_with_sparse_mask,
        flash_attn_unpadded)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    h, d, tokens = PACK_PARITY_HEADS, PACK_D, sum(lens)
    base = [torch.randn(tokens, h, d, generator=gen, device="cuda")
            for _ in range(4)]
    cu = torch.as_tensor(np.cumsum([0] + list(lens)), dtype=torch.int32,
                         device="cuda")
    bshape = (PACK_ROWS, PACK_SEQ, h, d)
    zero_flash_counts(flash_varlen_fwd, flash_varlen_bwd,
                      flash_sparse_mask_fwd, flash_sparse_mask_bwd,
                      _flash_bhsd, _flash_bhsd_bwd)

    def grads_of(run, shape):
        leaves = [x.reshape(shape).clone().requires_grad_()
                  for x in base[:3]]
        out = run(*leaves)
        out.backward(base[3].reshape(shape))
        return [out.detach().reshape(tokens, h, d)] + \
            [t.grad.reshape(tokens, h, d) for t in leaves]

    def worst(a, b):
        return max(((x - y).abs().max() / y.abs().max()).item()
                   for x, y in zip(a, b))

    mx = max(lens)
    varlen = grads_of(lambda q, k, v: flash_attn_unpadded(
        q, k, v, cu, cu, mx, mx, d ** -0.5, causal=True), (tokens, h, d))
    start = torch.as_tensor(doc_start_rows(np, lens, PACK_ROWS, PACK_SEQ),
                            device="cuda")[:, None, :]
    mask = grads_of(lambda q, k, v: flash_attention_with_sparse_mask(
        q, k, v, start, is_causal=True), bshape)
    full = torch.full((PACK_SEQ,), PACK_SEQ, dtype=torch.int32,
                      device="cuda")
    nomask = grads_of(lambda q, k, v: flash_attention_with_sparse_mask(
        q, k, v, full, is_causal=True), bshape)
    dense = grads_of(lambda q, k, v: flash_attention(
        q, k, v, causal=True)[0], bshape)
    torch.cuda.synchronize()
    docs_out = (varlen[0] - mask[0]).abs().max().item() \
        / mask[0].abs().max().item()
    docs_grad = worst(varlen[1:], mask[1:])
    dense_out = (nomask[0] - dense[0]).abs().max().item() \
        / dense[0].abs().max().item()
    dense_grad = worst(nomask[1:], dense[1:])
    launches = {fn.__name__: fn.launches for fn in (
        flash_varlen_fwd, flash_varlen_bwd, flash_sparse_mask_fwd,
        flash_sparse_mask_bwd, _flash_bhsd, _flash_bhsd_bwd)}
    routes = {fn.__name__: dict(fn.route_launches)
              for fn in (flash_varlen_fwd, flash_varlen_bwd,
                         flash_sparse_mask_fwd, flash_sparse_mask_bwd)}
    check(list(launches.values()) == [1, 1, 2, 2, 1, 1],
          f"packed_parity launches {launches}")
    check(all(r["cuda_core"] == launches[name] and not r["wgmma"]
              for name, r in routes.items()),
          f"packed_parity: float32 masked kernels not all on the CUDA "
          f"cores: {routes}")
    check(docs_out <= PACK_PARITY_ATOL and docs_grad <= PARITY_GRAD_ATOL,
          f"varlen vs FlashMask on the same documents: output {docs_out}, "
          f"gradients {docs_grad} of the largest")
    check(dense_out <= PACK_PARITY_ATOL and dense_grad <= PARITY_GRAD_ATOL,
          f"FlashMask (no start row) vs dense flash: output {dense_out}, "
          f"gradients {dense_grad} of the largest")
    rec = {"phase": "packed_parity", "dtype": "float32", "heads": h, "d": d,
           "tokens": tokens, "documents": list(lens),
           "varlen_vs_flashmask_out_over_max": docs_out,
           "varlen_vs_flashmask_grad_over_max": docs_grad,
           "flashmask_nomask_vs_dense_out_over_max": dense_out,
           "flashmask_nomask_vs_dense_grad_over_max": dense_grad,
           "out_atol_of_max": PACK_PARITY_ATOL,
           "grad_atol_of_max": PARITY_GRAD_ATOL, "launches": launches,
           "route_launches": routes}
    emit(rec)
    del base, varlen, mask, nomask, dense
    torch.cuda.empty_cache()
    return rec


# -- the row-wise slice: RMSNorm, RoPE, the causal softmax ----------------------

ROW_BATCH, ROW_SEQ = 6, 2048         # bench.py's one-chip training batch
ROW_HIDDEN, ROW_HEADS, ROW_D = 4096, 32, 128      # Llama-2-7B widths
ROW_EPS = 1e-5
ROW_WARMUP, ROW_TIMED = 2, 10
ROW_ATOL = 1e-5                 # of the largest magnitude: summation order
ROW_PARITY_ATOL = 1e-3          # of each gradient's largest magnitude
F32_FLOPS = 67e12               # H100 SXM float32 outside the tensor cores


def _row_check(name, what, out, ref):
    """Check a row-wise kernel's output against its plain version element
    by element, to 2^-7 |ref| (one bf16 ulp; 0 in float32) + ROW_ATOL of
    the largest |ref| (both sides compute in float32 and round once).
    Returns (max abs error, largest ratio of an error to its
    tolerance)."""
    check(out.dtype == ref.dtype, f"{name}: {what} dtype {out.dtype} != "
                                  f"{ref.dtype}")
    d = (out.float() - ref.float()).abs()
    rtol = BF16_RTOL if str(ref.dtype) == "torch.bfloat16" else 0.0
    lim = rtol * ref.float().abs() + ROW_ATOL * ref.float().abs().max() \
        + 1e-30
    err, ratio = d.max().item(), (d / lim).max().item()
    check(math.isfinite(ratio) and ratio <= 1.0,
          f"{name}: {what} vs plain err {err} ({ratio} x tolerance)")
    return err, ratio


def rms_case(torch, name, n, h, dtype, wdtype, seed, timed=False):
    """Both RMSNorm kernels on x [n, h] against their plain versions (the
    backward from the plain forward's rstd), dw the same bits over two
    runs; timed: with the plain versions and torch's rms_norm (forward and
    its autograd backward) as the yardstick. Returns (forward record,
    backward record)."""
    from paddle_tpu_torch.kernels.rms_norm import (
        rms_norm_bwd, rms_norm_bwd_plain, rms_norm_fwd, rms_norm_fwd_plain)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randn(n, h, generator=gen, device=dev).to(dtype)
    g = torch.randn(n, h, generator=gen, device=dev).to(dtype)
    w = (1 + 0.3 * torch.randn(h, generator=gen, device=dev)).to(wdtype)
    out, rstd = rms_norm_fwd(x, w, ROW_EPS)
    ref, rref = rms_norm_fwd_plain(x, w, ROW_EPS)
    dx, dw = rms_norm_bwd(x, w, rref, g)
    dx2, dw2 = rms_norm_bwd(x, w, rref, g)
    rdx, rdw = rms_norm_bwd_plain(x, w, rref, g)
    torch.cuda.synchronize()
    err, ratio = _row_check(name, "out", out, ref)
    _row_check(name, "rstd", rstd, rref)
    dx_err, dx_ratio = _row_check(name, "dx", dx, rdx)
    dw_err, dw_ratio = _row_check(name, "dw", dw, rdw)
    check(torch.equal(dw, dw2) and torch.equal(dx, dx2),
          f"{name}: the backward is not the same bits on a second run")
    kernel_ms = cuda_ms(torch, lambda: rms_norm_fwd(x, w, ROW_EPS), 10)
    kernel_bwd_ms = cuda_ms(torch, lambda: rms_norm_bwd(x, w, rstd, g), 10)
    plain_ms = plain_bwd_ms = library_ms = library_bwd_ms = None
    if timed:
        plain_ms = cuda_ms(torch, lambda: rms_norm_fwd_plain(
            x, w, ROW_EPS), 3, warmup=1)
        plain_bwd_ms = cuda_ms(torch, lambda: rms_norm_bwd_plain(
            x, w, rstd, g), 3, warmup=1)
        xl = x.detach().clone().requires_grad_()
        wl = w.detach().to(dtype).requires_grad_()
        yl = torch.nn.functional.rms_norm(xl, (h,), wl, ROW_EPS)
        lib_check(f"{name} torch rms_norm", yl, ref)
        lib_check(f"{name} torch rms_norm backward",
                  torch.autograd.grad(yl, xl, g, retain_graph=True)[0], rdx)
        library_ms = cuda_ms(torch, lambda: torch.nn.functional.rms_norm(
            xl.detach(), (h,), wl.detach(), ROW_EPS), 10)
        library_bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(
            yl, (xl, wl), g, retain_graph=True), 10)
        del xl, wl, yl
    xs, ws = x.element_size(), w.element_size()
    common = {"phase": "kernel_check", "case": name, "n": n, "h": h,
              "dtype": str(dtype).split(".")[-1],
              "w_dtype": str(wdtype).split(".")[-1],
              "dw_same_bits_twice": True}
    fbytes = 2 * n * h * xs + h * ws + 4 * n
    flops = 4 * n * h
    bound_ms, bound_by = bound(fbytes, flops, F32_FLOPS)
    fwd = dict(common, kernel="rms_norm_fwd", max_abs_err=err,
               err_over_tolerance=ratio, kernel_ms=kernel_ms,
               plain_ms=plain_ms, library_ms=library_ms,
               library="torch.nn.functional.rms_norm (w in x's dtype)",
               bound_ms=bound_ms, bound_by=bound_by, bytes=fbytes,
               flops=flops, gbps=fbytes / kernel_ms / 1e6)
    emit(fwd)
    bbytes = 3 * n * h * xs + 2 * h * ws + 4 * n
    flops = 10 * n * h
    bound_ms, bound_by = bound(bbytes, flops, F32_FLOPS)
    bwd = dict(common, kernel="rms_norm_bwd", max_abs_err=max(dx_err, dw_err),
               err_over_tolerance=max(dx_ratio, dw_ratio),
               max_abs_err_by_grad={"dx": dx_err, "dw": dw_err},
               kernel_ms=kernel_bwd_ms, plain_ms=plain_bwd_ms,
               library_ms=library_bwd_ms,
               library="autograd backward of that rms_norm (dx, dw)",
               bound_ms=bound_ms, bound_by=bound_by, bytes=bbytes,
               flops=flops, gbps=bbytes / kernel_bwd_ms / 1e6)
    emit(bwd)
    del x, g, out, ref, dx, dx2, rdx
    torch.cuda.empty_cache()
    return fwd, bwd


def rope_case(torch, name, b, s, h, d, dtype, rows, seed, timed=False):
    """The RoPE kernel on x [b, s, h, d], both directions, against its plain
    version, with random float32 tables of `rows` rows (s, or 1) whose
    halves differ, so a wrong table row or half shows. The kernel rounds as
    the plain version does; whether the bits agree is recorded. Returns the
    record (times of the forward direction; the backward's beside it)."""
    from paddle_tpu_torch.kernels.fused_elementwise import rope, rope_plain
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randn(b, s, h, d, generator=gen, device=dev).to(dtype)
    cos, sin = (torch.randn(rows, d, generator=gen, device=dev)
                for _ in range(2))
    errs, same = {}, {}
    for backward in (False, True):
        got = rope(x, cos, sin, backward)
        ref = rope_plain(x, cos, sin, backward)
        torch.cuda.synchronize()
        key = "backward" if backward else "forward"
        errs[key] = _row_check(name, key, got, ref)
        same[key] = torch.equal(got, ref)
    kernel_ms = cuda_ms(torch, lambda: rope(x, cos, sin), 10)
    kernel_bwd_ms = cuda_ms(torch, lambda: rope(x, cos, sin, True), 10)
    plain_ms = None
    if timed:
        plain_ms = cuda_ms(torch, lambda: rope_plain(x, cos, sin), 3,
                           warmup=1)
    nbytes = 2 * x.numel() * x.element_size() + 2 * rows * d * 4
    flops = 3 * x.numel()
    bound_ms, bound_by = bound(nbytes, flops, F32_FLOPS)
    rec = {"phase": "kernel_check", "case": name, "kernel": "rope",
           "b": b, "s": s, "heads": h, "d": d, "table_rows": rows,
           "dtype": str(dtype).split(".")[-1],
           "max_abs_err": max(e[0] for e in errs.values()),
           "err_over_tolerance": max(e[1] for e in errs.values()),
           "same_bits_as_plain": same, "kernel_ms": kernel_ms,
           "kernel_bwd_ms": kernel_bwd_ms, "plain_ms": plain_ms,
           "library_ms": None, "library": "none (no single torch call)",
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           "flops": flops, "gbps": nbytes / kernel_ms / 1e6}
    emit(rec)
    del x
    torch.cuda.empty_cache()
    return rec


def softmax_case(torch, name, n, s, dtype, seed, poison=False, timed=False):
    """Both causal softmax kernels on [n, s, s] against their plain versions
    (the backward from the plain forward's p); poison: NaN above the
    diagonal of x and of g must leave p and dx finite and the same bits.
    timed: with the plain versions, torch.softmax over the whole
    (unmasked) row as the nearest single call for the forward, and
    torch._softmax_backward_data (p (g - sum p g)) for the backward.
    Returns (forward record, backward record)."""
    from paddle_tpu_torch.kernels.fused_elementwise import (
        causal_softmax_bwd, causal_softmax_bwd_plain, causal_softmax_fwd,
        causal_softmax_fwd_plain)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = (4 * torch.randn(n, s, s, generator=gen, device=dev)).to(dtype)
    g = torch.randn(n, s, s, generator=gen, device=dev).to(dtype)
    p = causal_softmax_fwd(x)
    rp = causal_softmax_fwd_plain(x)
    torch.cuda.synchronize()
    err, ratio = _row_check(name, "p", p, rp)
    dx = causal_softmax_bwd(rp, g)
    rdx = causal_softmax_bwd_plain(rp, g)
    torch.cuda.synchronize()
    bwd_err, bwd_ratio = _row_check(name, "dx", dx, rdx)
    del rdx
    upper = torch.ones(s, s, dtype=torch.bool, device=dev).triu(1)
    check(not p[:, upper].any() and not dx[:, upper].any(),
          f"{name}: a column above the diagonal is not 0")
    if poison:
        xp = x.clone()
        xp[:, upper] = float("nan")
        pp = causal_softmax_fwd(xp)
        del xp
        gp = g.clone()
        gp[:, upper] = float("nan")
        dxp = causal_softmax_bwd(rp, gp)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(pp).all()) and torch.equal(pp, p),
              f"{name}: NaN above the diagonal of x reached p")
        check(bool(torch.isfinite(dxp).all()) and torch.equal(dxp, dx),
              f"{name}: NaN above the diagonal of g reached dx")
        del pp, gp, dxp
    del rp
    torch.cuda.empty_cache()
    kernel_ms = cuda_ms(torch, lambda: causal_softmax_fwd(x), 10)
    kernel_bwd_ms = cuda_ms(torch, lambda: causal_softmax_bwd(p, g), 10)
    plain_ms = plain_bwd_ms = library_ms = library_bwd_ms = None
    if timed:
        plain_ms = cuda_ms(torch, lambda: causal_softmax_fwd_plain(x), 2,
                           warmup=1)
        plain_bwd_ms = cuda_ms(torch, lambda: causal_softmax_bwd_plain(
            p, g), 2, warmup=1)
        torch.cuda.empty_cache()
        lib_check(f"{name} torch._softmax_backward_data",
                  torch._softmax_backward_data(g, p, -1, dtype), dx)
        library_ms = cuda_ms(torch, lambda: torch.softmax(x, -1), 10)
        library_bwd_ms = cuda_ms(torch, lambda: torch._softmax_backward_data(
            g, p, -1, dtype), 10)
    isz = x.element_size()
    live = n * s * (s + 1) // 2
    common = {"phase": "kernel_check", "case": name, "n": n, "s": s,
              "dtype": str(dtype).split(".")[-1], "live_elements": live,
              "nan_poisoned_masked_half": poison}
    fbytes = live * isz + n * s * s * isz
    flops = 5 * live
    bound_ms, bound_by = bound(fbytes, flops, F32_FLOPS)
    fwd = dict(common, kernel="masked_softmax_fwd", max_abs_err=err,
               err_over_tolerance=ratio, kernel_ms=kernel_ms,
               plain_ms=plain_ms, library_ms=library_ms,
               library="torch.softmax over the whole row (no mask): the "
                       "nearest single call",
               bound_ms=bound_ms, bound_by=bound_by, bytes=fbytes,
               flops=flops, gbps=fbytes / kernel_ms / 1e6)
    emit(fwd)
    bbytes = 2 * live * isz + n * s * s * isz
    flops = 4 * live
    bound_ms, bound_by = bound(bbytes, flops, F32_FLOPS)
    bwd = dict(common, kernel="masked_softmax_bwd", max_abs_err=bwd_err,
               err_over_tolerance=bwd_ratio, kernel_ms=kernel_bwd_ms,
               plain_ms=plain_bwd_ms, library_ms=library_bwd_ms,
               library="torch._softmax_backward_data(g, p)",
               bound_ms=bound_ms, bound_by=bound_by, bytes=bbytes,
               flops=flops, gbps=bbytes / kernel_bwd_ms / 1e6)
    emit(bwd)
    del x, g, p, dx
    torch.cuda.empty_cache()
    return fwd, bwd


def rowwise_kernel_checks(torch, seed):
    """Phase 14: the five row-wise kernels against their plain versions at
    rowwise_attn's shapes (timed with the plain versions and the library
    yardsticks), and the edge cases: h 5120, 8192 and 12288 (32 columns a
    thread), one row of 128, bf16 and float32 x and w, RoPE at B > 1 with
    S-row tables, a one-row table and D 256, the softmax at S 8192 and with
    NaN above the diagonal of x and g. Returns the main records."""
    bf16, f32 = torch.bfloat16, torch.float32
    n = ROW_BATCH * ROW_SEQ
    rms_f, rms_b = rms_case(torch, "main_12288x4096_bf16_wf32", n,
                            ROW_HIDDEN, bf16, f32, seed, timed=True)
    for name, rows, h, dt, wdt in (
            ("h5120_bf16", 4096, 5120, bf16, bf16),
            ("h8192_f32", 4096, 8192, f32, f32),
            ("h8192_bf16_wf32", 4096, 8192, bf16, f32),
            ("h12288_f32_wbf16", 1024, 12288, f32, bf16),
            ("one_row_h128_f32", 1, 128, f32, f32)):
        rms_case(torch, name, rows, h, dt, wdt, seed + h + rows)
    rope_main = rope_case(torch, "main_6x2048x32x128_bf16_srow", ROW_BATCH,
                          ROW_SEQ, ROW_HEADS, ROW_D, bf16, ROW_SEQ, seed,
                          timed=True)
    for name, b, s, h, d, dt, rows in (
            ("b3_s256_h4_d128_f32_srow", 3, 256, 4, 128, f32, 256),
            ("b2_s512_h8_d256_bf16_srow", 2, 512, 8, 256, bf16, 512),
            ("b2_s512_h8_d128_f32_onerow", 2, 512, 8, 128, f32, 1)):
        rope_case(torch, name, b, s, h, d, dt, rows, seed + b * s + d)
    sm_f, sm_b = softmax_case(torch, "main_192x2048x2048_bf16",
                              ROW_BATCH * ROW_HEADS, ROW_SEQ, bf16, seed,
                              timed=True)
    for name, n_, s, dt, poison in (
            ("n8_s2048_f32", 8, 2048, f32, False),
            ("n1_s8192_f32", 1, 8192, f32, False),
            ("n2_s8192_bf16", 2, 8192, bf16, False),
            ("nan_masked_n8_s1024_bf16", 8, 1024, bf16, True),
            ("nan_masked_n4_s2048_f32", 4, 2048, f32, True),
            ("n64_s128_bf16", 64, 128, bf16, False)):
        softmax_case(torch, name, n_, s, dt, seed + n_ + s, poison)
    return rms_f, rms_b, rope_main, sm_f, sm_b


def _row_leaves(torch, seed, dtype):
    """x, residual [6, 2048, 4096], the norm weight (float32, ones plus
    noise) and the q, k, v projections [4096, 4096] (paddle's [in, out]),
    all leaves needing gradients, from a seeded generator."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    shape = (ROW_BATCH, ROW_SEQ, ROW_HIDDEN)
    x, r = (torch.randn(*shape, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    w = 1 + 0.1 * torch.randn(ROW_HIDDEN, generator=gen, device="cuda")
    proj = [(torch.randn(ROW_HIDDEN, ROW_HIDDEN, generator=gen,
                         device="cuda") * ROW_HIDDEN ** -0.5).to(dtype)
            for _ in range(3)]
    return [t.requires_grad_() for t in (x, r, w, *proj)]


def _row_tables(torch):
    import numpy as np
    from paddle_tpu_torch.models.llama import _rope_tables
    cos, sin = _rope_tables(ROW_D, ROW_SEQ, 10000.0)
    return (torch.from_numpy(np.ascontiguousarray(cos)).cuda(),
            torch.from_numpy(np.ascontiguousarray(sin)).cuda())


def _row_pass(torch, leaves, tables, gout, rms, rope2, softmax):
    """One forward and backward pass of the slice: x + residual -> RMSNorm
    -> q, k, v projections -> RoPE on q and k -> causal scores q k^T /
    sqrt(D) -> masked softmax -> p v -> sum(out * gout). rms, rope2 and
    softmax are the three row-wise steps (the entry points, or the plain
    versions). Returns the loss."""
    x, r, w, wq, wk, wv = leaves
    normed = rms(x, r, w)
    shape = (ROW_BATCH, ROW_SEQ, ROW_HEADS, ROW_D)
    q, k, v = (torch.matmul(normed, m).reshape(shape) for m in (wq, wk, wv))
    q, k = rope2(q, k, *tables)
    scores = torch.matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1)) \
        * ROW_D ** -0.5
    out = torch.matmul(softmax(scores), v.transpose(1, 2))
    loss = (out.float() * gout).sum()
    loss.backward()
    return loss.detach()


def _entry_steps():
    """The three row-wise steps through the port's public entry points."""
    from paddle_tpu_torch.incubate import softmax_mask_fuse_upper_triangle
    from paddle_tpu_torch.incubate.nn.functional import (
        fused_rms_norm, fused_rotary_position_embedding)

    def rms(x, r, w):
        return fused_rms_norm(x, w, None, ROW_EPS, residual=r)[0]

    def rope2(q, k, cos, sin):
        q, k, _ = fused_rotary_position_embedding(
            q, k, None, sin=sin, cos=cos, use_neox_rotary_style=False)
        return q, k

    return rms, rope2, softmax_mask_fuse_upper_triangle


def _plain_steps(torch):
    """The same steps through the kernels' plain versions (forward and
    backward), as autograd Functions: the pass the kernels are held to."""
    from paddle_tpu_torch.kernels import fused_elementwise as fe
    from paddle_tpu_torch.kernels import rms_norm as rn

    class Rms(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w):
            out, rstd = rn.rms_norm_fwd_plain(x, w, ROW_EPS)
            ctx.save_for_backward(x, w, rstd)
            return out

        @staticmethod
        def backward(ctx, g):
            return rn.rms_norm_bwd_plain(*ctx.saved_tensors, g)

    class Rope(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, cos, sin):
            ctx.save_for_backward(cos, sin)
            return fe.rope_plain(x, cos, sin)

        @staticmethod
        def backward(ctx, g):
            return fe.rope_plain(g, *ctx.saved_tensors, True), None, None

    class Softmax(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            p = fe.causal_softmax_fwd_plain(x)
            ctx.save_for_backward(p)
            return p

        @staticmethod
        def backward(ctx, g):
            return fe.causal_softmax_bwd_plain(*ctx.saved_tensors, g)

    def rms(x, r, w):
        s = x + r
        return Rms.apply(s.reshape(-1, s.shape[-1]), w).reshape(s.shape)

    def rope2(q, k, cos, sin):
        return Rope.apply(q, cos, sin), Rope.apply(k, cos, sin)

    def softmax(sc):
        return Softmax.apply(sc.reshape(-1, ROW_SEQ, ROW_SEQ)) \
            .reshape(sc.shape)

    return rms, rope2, softmax


def _row_kernels():
    from paddle_tpu_torch.kernels.fused_elementwise import (
        causal_softmax_bwd, causal_softmax_fwd, rope)
    from paddle_tpu_torch.kernels.rms_norm import rms_norm_bwd, rms_norm_fwd
    return {"rms_norm_fwd": rms_norm_fwd, "rms_norm_bwd": rms_norm_bwd,
            "rope": rope, "masked_softmax_fwd": causal_softmax_fwd,
            "masked_softmax_bwd": causal_softmax_bwd}


# launches of each kernel in one forward and backward pass: RMSNorm once
# each way, RoPE on q and k each way, the softmax once each way
ROW_LAUNCHES_PER_PASS = {"rms_norm_fwd": 1, "rms_norm_bwd": 1, "rope": 4,
                         "masked_softmax_fwd": 1, "masked_softmax_bwd": 1}


def rowwise_attn_phase(torch, seed, profile=False):
    """Phase 15: the three entry points at Llama-2-7B width on bench.py's
    batch, bf16: fused_rms_norm with a residual, q/k/v projections,
    fused_rotary_position_embedding (rotate-half, S-row tables),
    softmax_mask_fuse_upper_triangle on [6, 32, 2048, 2048] scores, p v,
    a scalar loss and the backward; ROW_WARMUP + ROW_TIMED passes with the
    gradients reset to None first. Every kernel launches its
    ROW_LAUNCHES_PER_PASS each pass."""
    leaves = _row_leaves(torch, seed, torch.bfloat16)
    tables = _row_tables(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 1)
    gout = torch.randn(ROW_BATCH, ROW_HEADS, ROW_SEQ, ROW_D, generator=gen,
                       device="cuda")
    steps = _entry_steps()
    kernels = _row_kernels()

    def one():
        for t in leaves:
            t.grad = None
        return _row_pass(torch, leaves, tables, gout, *steps)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    losses = [one() for _ in range(ROW_WARMUP)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ROW_TIMED):
        losses.append(one())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    passes = ROW_WARMUP + ROW_TIMED
    check(launches == {k: v * passes
                       for k, v in ROW_LAUNCHES_PER_PASS.items()},
          f"rowwise_attn: launches {launches} over {passes} passes, want "
          f"{ROW_LAUNCHES_PER_PASS} a pass")
    check(all(bool(torch.isfinite(t.grad).all()) for t in leaves)
          and all(math.isfinite(float(v)) for v in losses),
          "rowwise_attn: non-finite loss or gradient")
    tokens = ROW_BATCH * ROW_SEQ
    rec = {"phase": "rowwise_attn", "dtype": "bfloat16",
           "entries": ["incubate.nn.functional.fused_rms_norm",
                       "incubate.nn.functional."
                       "fused_rotary_position_embedding",
                       "incubate.softmax_mask_fuse_upper_triangle"],
           "batch": ROW_BATCH, "seq": ROW_SEQ, "hidden": ROW_HIDDEN,
           "heads": ROW_HEADS, "d": ROW_D, "tokens": tokens,
           "warmup_passes": ROW_WARMUP, "timed_passes": ROW_TIMED,
           "wall_s": wall, "ms_per_fwd_bwd": wall / ROW_TIMED * 1e3,
           "tokens_per_s": tokens * ROW_TIMED / wall,
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches, "loss_first": float(losses[0]),
           "loss_last": float(losses[-1])}
    emit(rec)
    if profile:
        rowwise_profile_phase(torch, one)
    del leaves, gout
    torch.cuda.empty_cache()
    return rec


def rowwise_profile_phase(torch, one, passes=3):
    """--profile only: `passes` rowwise_attn passes, once plainly for
    their wall time and once under torch.profiler: device time of the
    row-wise kernels, the GEMMs (cuBLAS's kernels on the H100 are named
    nvjet_*) and the rest, and the idle share."""
    from torch.profiler import ProfilerActivity, profile
    one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(passes):
        one()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(passes):
            one()
        torch.cuda.synchronize()
    rows, busy_s = device_kernel_rows(prof)
    groups = {"rms_norm": 0.0, "rope": 0.0, "causal_softmax": 0.0,
              "gemm": 0.0, "other": 0.0}
    for us, name, _ in rows:
        key = ("rms_norm" if "rms_" in name or "dw_reduce" in name else
               "rope" if "rope_kernel" in name else
               "causal_softmax" if "causal_softmax" in name else
               "gemm" if "gemm" in name.lower() or "nvjet" in name
               or "cutlass" in name else "other")
        groups[key] += us / 1e3
    rec = {"phase": "profile_rowwise_attn", "passes": passes,
           "wall_s": wall, "ms_per_pass": wall / passes * 1e3,
           "device_busy_s": busy_s if rows else "not measured",
           "device_idle_share": 1 - busy_s / wall if rows
           else "not measured",
           "device_ms_per_pass_by_group": {
               k: v / passes for k, v in groups.items()} if rows
           else "not measured",
           "top_device_kernels": top_kernels(rows, busy_s, 10)
           if rows else []}
    emit(rec)
    return rec


def rowwise_parity_phase(torch, seed):
    """Phase 16: the rowwise_attn pass at full width in float32 (TF32 off)
    through the entry points (kernels) and through the plain versions:
    the losses agree to PARITY_LOSS_RTOL and the gradients of x, the
    residual, the norm weight and the three projections to
    ROW_PARITY_ATOL of each gradient's largest."""
    torch.backends.cuda.matmul.allow_tf32 = False
    tables = _row_tables(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 1)
    gout = torch.randn(ROW_BATCH, ROW_HEADS, ROW_SEQ, ROW_D, generator=gen,
                       device="cuda")
    kernels = _row_kernels()
    runs = {}
    for kind in ("kernels", "plain"):
        for fn in kernels.values():
            fn.launches = 0
        leaves = _row_leaves(torch, seed, torch.float32)
        steps = _entry_steps() if kind == "kernels" else _plain_steps(torch)
        loss = _row_pass(torch, leaves, tables, gout, *steps)
        torch.cuda.synchronize()
        runs[kind] = (float(loss), [t.grad for t in leaves],
                      {k: fn.launches for k, fn in kernels.items()})
        del leaves
        torch.cuda.empty_cache()
    (kl, kg, klaunch), (pl, pg, plaunch) = runs["kernels"], runs["plain"]
    check(klaunch == ROW_LAUNCHES_PER_PASS and not any(plaunch.values()),
          f"rowwise_parity launches: kernels {klaunch}, plain {plaunch}")
    names = ("x", "residual", "norm_weight", "wq", "wk", "wv")
    errs = {n: ((a - b).abs().max() / b.abs().max()).item()
            for n, a, b in zip(names, kg, pg)}
    loss_rel = abs(kl - pl) / abs(pl)
    check(loss_rel <= PARITY_LOSS_RTOL, f"rowwise_parity: loss {kl} vs "
                                        f"plain {pl}")
    check(all(e <= ROW_PARITY_ATOL for e in errs.values()),
          f"rowwise_parity: gradients {errs} of the largest")
    rec = {"phase": "rowwise_parity", "dtype": "float32",
           "loss_kernels": kl, "loss_plain": pl, "loss_rel_err": loss_rel,
           "loss_rtol": PARITY_LOSS_RTOL, "grad_err_over_max": errs,
           "grad_atol_of_max": ROW_PARITY_ATOL, "launches": klaunch}
    emit(rec)
    del kg, pg, gout
    torch.cuda.empty_cache()
    return rec


# -- phase 17: ResNet-50 eager training (benchmarks/resnet50_eager.py) -------

RESNET_BATCH, RESNET_SIZE = 64, 224      # benchmarks/resnet50_eager.py:13-36
RESNET_CLASSES = 1000
# cuDNN's benchmark mode times the candidate algorithms of each
# convolution shape on its first call and keeps the fastest, as the
# reference's compiled step autotunes its convolutions; the warm-up steps
# take that cost
RESNET_CUDNN_BENCHMARK = True
RESNET_PARITY_STEPS = 2
# resnet_parity's limits, each of the largest magnitude of its array.
# float64, card against CPU: summation order only (measured 2e-8 on the
# first step of six batch seeds)
RESNET_PARITY_F64_TOL = 1e-6
# float32 with TF32 off, card against CPU, as the CPU tests hold the port
# to the JAX package (measured there up to 1.6e-5). They hold where the
# two devices' forwards put every ReLU input on the same side of 0 and
# pick the same max-pool window maxima. Where float32 rounding puts one
# ReLU input on the other side (seen: one input at 2e-7 of its tensor's
# largest, in 3 of 6 batch seeds), that element's gradient passes
# on one device and not on the other, and the velocities part by up to
# 4e-2 (tests/torch_resnet_cases.py has the same on the CPU against JAX):
# then every such straddle must lie within RESNET_STRADDLE_TOL of its
# tensor's largest, and only the losses are held to their limit
RESNET_PARITY_TOLS = {"losses": 1e-5, "buffers": 1e-4, "params": 1e-4,
                      "velocities": 1e-4}
RESNET_STRADDLE_TOL = 1e-5


def resnet_batch(torch, np, seed, batch, size, classes, device="cuda"):
    """The benchmark's images and labels from a seed."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((batch, 3, size, size),
                                            np.float32), device=device)
    y = torch.as_tensor(rng.integers(0, classes, (batch,)), device=device)
    return x, y


def make_resnet_step(torch, build, seed, classes, device="cuda", state=None):
    """build(num_classes=classes) on ``device`` from a seeded generator (or
    loaded with ``state``), Momentum(0.1, 0.9) and CrossEntropyLoss under
    TrainStep, as the benchmark builds its step."""
    from paddle_tpu_torch import Momentum, TrainStep, nn
    from paddle_tpu_torch import seed as make_generator
    model = build(num_classes=classes, device=device,
                  generator=make_generator(seed, device))
    if state is not None:
        model.load_state_dict(state)
    opt = Momentum(learning_rate=0.1, momentum=0.9,
                   parameters=model.parameters())
    return model, opt, TrainStep(model, nn.CrossEntropyLoss(), opt)


def _run_steps(torch, step, x, y, warmup, timed):
    """(losses, wall seconds of the timed steps)."""
    losses = []
    for i in range(warmup + timed):
        if i == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(step((x,), (y,)))
    torch.cuda.synchronize()
    return [v.item() for v in losses], time.perf_counter() - t0


class _Backends:
    """Set torch.backends' TF32 and cuDNN flags for a phase and put them
    back after it."""

    def __init__(self, torch, tf32, benchmark=False, deterministic=False):
        self.torch = torch
        self.want = (tf32, tf32, benchmark, deterministic)

    def _flags(self):
        b = self.torch.backends
        return (b.cuda.matmul, "allow_tf32"), (b.cudnn, "allow_tf32"), \
            (b.cudnn, "benchmark"), (b.cudnn, "deterministic")

    def __enter__(self):
        self.saved = [getattr(o, a) for o, a in self._flags()]
        for (o, a), v in zip(self._flags(), self.want):
            setattr(o, a, v)
        return self

    def __exit__(self, *exc):
        for (o, a), v in zip(self._flags(), self.saved):
            setattr(o, a, v)


def _resnet50_run(torch, np, seed, tf32, channels_last=False):
    """TRAIN_WARMUP + TRAIN_TIMED train_resnet50 steps on a fresh model
    from ``seed``: (model, losses, timed wall seconds, peak bytes, forward
    flops an image, the buffers as built)."""
    from paddle_tpu_torch import flops
    from paddle_tpu_torch.vision.models import resnet50
    with _Backends(torch, tf32=tf32, benchmark=RESNET_CUDNN_BENCHMARK):
        model, _, step = make_resnet_step(torch, resnet50, seed,
                                          RESNET_CLASSES)
        fwd_flops = flops(model, [1, 3, RESNET_SIZE, RESNET_SIZE])
        buffers0 = {k: b.clone() for k, b in model.named_buffers()}
        x, y = resnet_batch(torch, np, seed + 1, RESNET_BATCH, RESNET_SIZE,
                            RESNET_CLASSES)
        if channels_last:
            model.to(memory_format=torch.channels_last)
            x = x.contiguous(memory_format=torch.channels_last)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, wall = _run_steps(torch, step, x, y, TRAIN_WARMUP,
                                  TRAIN_TIMED)
        peak = torch.cuda.max_memory_allocated()
    return model, losses, wall, peak, fwd_flops, buffers0


def train_resnet50_phase(torch, np, seed):
    """Phase 17: benchmarks/resnet50_eager.py's configuration at full size
    through the port's entry points: resnet50(num_classes=1000), float32
    with TF32 off (the reference's "highest" precision), batch 64 x 3 x
    224 x 224 and labels from the seed, Momentum(0.1, 0.9) and
    CrossEntropyLoss under TrainStep, TRAIN_WARMUP + TRAIN_TIMED steps,
    cuDNN's benchmark mode on (RESNET_CUDNN_BENCHMARK). Prints s per step,
    images/s, TFLOP/s (3 x flops(net, [1, 3, 224, 224]) an image) and its
    share of F32_FLOPS, peak memory, every loss (finite) and the batch
    norms' buffers (moved, finite). Two more lines, information and not
    the configuration, each on a fresh model from the same seed: the same
    steps with TF32 allowed, and with the model and images in
    channels_last memory format (TF32 off)."""
    model, losses, wall, peak, fwd_flops, buffers0 = _resnet50_run(
        torch, np, seed, tf32=False)
    n_params = sum(p.numel() for p in model.parameters())
    check(all(math.isfinite(v) for v in losses),
          f"train_resnet50: non-finite loss {losses}")
    moved = sum(not torch.equal(b, buffers0[k])
                for k, b in model.named_buffers())
    check(moved == len(buffers0) and all(
        bool(torch.isfinite(b).all()) for b in model.buffers()),
        f"train_resnet50: {moved} of {len(buffers0)} batch-norm buffers "
        f"moved, or one is not finite")
    del model, buffers0
    torch.cuda.empty_cache()
    train_flops = 3 * fwd_flops * RESNET_BATCH

    def rates(w):
        s = w / TRAIN_TIMED
        return {"s_per_step": s, "images_per_s": RESNET_BATCH / s,
                "tflop_per_s": train_flops / s / 1e12,
                "share_of_f32_peak": train_flops / s / F32_FLOPS}

    rec = {"phase": "train_resnet50",
           "model": "benchmarks/resnet50_eager.py ResNet-50, random weights",
           "dtype": "float32", "tf32": False,
           "cudnn_benchmark": RESNET_CUDNN_BENCHMARK, "params": n_params,
           "batch": RESNET_BATCH, "image": [3, RESNET_SIZE, RESNET_SIZE],
           "classes": RESNET_CLASSES, "optimizer": "Momentum(0.1, 0.9)",
           "warmup_steps": TRAIN_WARMUP, "timed_steps": TRAIN_TIMED,
           "wall_s": wall, "flops_fwd_per_image": fwd_flops,
           "flops_per_step": train_flops, "f32_peak_flops": F32_FLOPS,
           **rates(wall), "losses": losses, "peak_device_bytes": peak,
           "bn_buffers_moved": moved}
    emit(rec)
    for phase, kw, note in (
            ("train_resnet50_tf32", dict(tf32=True),
             "TF32 allowed in cuDNN and cuBLAS; not the configuration, "
             "whose reference trains in float32"),
            ("train_resnet50_channels_last",
             dict(tf32=False, channels_last=True),
             "the model and images in channels_last memory format, TF32 "
             "off")):
        model, info_losses, info_wall, info_peak, _, _ = _resnet50_run(
            torch, np, seed, **kw)
        emit({"phase": phase, "information_only": True, "note": note,
              **rates(info_wall), "losses": info_losses,
              "peak_device_bytes": info_peak})
        del model
        torch.cuda.empty_cache()
    return rec


RESNET_PROFILE_GROUPS = ("conv_fwd", "conv_dgrad", "conv_wgrad",
                         "conv_bwd_unnamed", "batch_norm", "elementwise",
                         "optimizer", "other")


def _resnet_group(ops, kernel):
    """The group of a kernel launched under the CPU ops ``ops`` (innermost
    first: aten ops, autograd nodes and record_function labels)."""
    name = kernel.lower()
    if "resnet_optimizer" in ops:
        return "optimizer"
    if any("convolution_backward" in o or "ConvolutionBackward" in o
           for o in ops):
        return ("conv_wgrad" if "wgrad" in name else
                "conv_dgrad" if "dgrad" in name else "conv_bwd_unnamed")
    if any("convolution" in o for o in ops):
        return "conv_fwd"
    if any("batch_norm" in o or "BatchNorm" in o for o in ops):
        return "batch_norm"
    if any(o in ("aten::relu", "aten::threshold_backward", "aten::add")
           for o in ops):
        return "elementwise"
    return "other"


def train_resnet50_profile_phase(torch, np, seed, steps=2):
    """--profile only: train_resnet50's steps (TF32 off) under
    torch.profiler: device time by group (cuDNN convolution forward, data
    gradient and weight gradient by the kernels' names, batch norm,
    element-wise ReLU and residual adds, the optimizer under its own
    label, the rest), the device's idle share and the top kernels."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from paddle_tpu_torch.vision.models import resnet50
    with _Backends(torch, tf32=False, benchmark=RESNET_CUDNN_BENCHMARK):
        model, opt, step = make_resnet_step(torch, resnet50, seed,
                                            RESNET_CLASSES)
        x, y = resnet_batch(torch, np, seed + 1, RESNET_BATCH, RESNET_SIZE,
                            RESNET_CLASSES)
        apply = opt.step

        def labelled_step(*args, **kwargs):
            with record_function("resnet_optimizer"):
                return apply(*args, **kwargs)

        opt.step = labelled_step
        _, wall = _run_steps(torch, step, x, y, 1, steps)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step((x,), (y,))
            torch.cuda.synchronize()
    # the label's own range on the device timeline is not a kernel
    rows = [r for r in device_kernel_rows(prof)[0]
            if r[1] != "resnet_optimizer"]
    busy_s = sum(r[0] for r in rows) / 1e6
    groups = dict.fromkeys(RESNET_PROFILE_GROUPS, 0.0)
    for evt in prof.events():
        if not getattr(evt, "kernels", None):
            continue
        ops, node = [], evt
        while node is not None:
            ops.append(node.name)
            node = node.cpu_parent
        for k in evt.kernels:
            if k.name != "resnet_optimizer":
                groups[_resnet_group(ops, k.name)] += k.duration / 1e6
    attributed = sum(groups.values())
    rec = {"phase": "train_resnet50_profile", "steps": steps,
           "wall_s": wall, "s_per_step": wall / steps,
           "device_busy_s": busy_s if rows else "not measured",
           "device_idle_share": 1 - busy_s / wall if rows
           else "not measured",
           "device_s_per_step_by_group": {
               k: v / steps for k, v in groups.items()},
           "attributed_share_of_busy": attributed / busy_s if rows
           else "not measured",
           "top_device_kernels": top_kernels(rows, busy_s, 15)}
    emit(rec)
    del model, opt, step, x, y
    torch.cuda.empty_cache()
    return rec


def _record_branch_inputs(torch, model, seen):
    """Forward hooks that keep each ReLU's and the max pool's input (on
    the CPU), in call order."""
    from paddle_tpu_torch.nn import MaxPool2D, ReLU
    for name, m in model.named_modules():
        if isinstance(m, (ReLU, MaxPool2D)):
            m.register_forward_hook(
                lambda mod, inputs, out, name=name: seen.append(
                    (name, inputs[0].detach().cpu())))


def _straddles(torch, card_seen, cpu_seen):
    """Branch points where the two devices' float32 forwards part: ReLU
    inputs on opposite sides of 0, max-pool windows whose maxima differ.
    Returns [(where, how far from the branch, relative to the tensor's
    largest)]."""
    from paddle_tpu_torch.nn.functional.pooling import _max_pool_mask
    out = []
    for (name, a), (_, b) in zip(card_seen, cpu_seen):
        scale = b.abs().max().item()
        if name.endswith("maxpool"):
            ma = _max_pool_mask(a, 3, 2, 1, 2, False)
            mb = _max_pool_mask(b, 3, 2, 1, 2, False)
            win = torch.nn.functional.pad(b, [1, 1, 1, 1],
                                          value=-math.inf)
            top2 = win.unfold(2, 3, 2).unfold(3, 3, 2).flatten(-2) \
                .topk(2, dim=-1).values
            gap = (top2[..., 0] - top2[..., 1])[ma != mb]
            out += [(name, g / scale) for g in gap.tolist()]
        else:
            bad = (a > 0) != (b > 0)
            out += [(name, v / scale) for v in
                    torch.maximum(a.abs(), b.abs())[bad].tolist()]
    return out


def resnet_parity_phase(torch, np, seed):
    """resnet18(num_classes=10) at 64 x 64, batch 4, TF32 off and
    cudnn.deterministic: the same weights for RESNET_PARITY_STEPS
    Momentum(0.1, 0.9) steps on the card, again on the card, and on the
    CPU, in float32; then on the card and the CPU in float64. The two
    float32 card runs must agree bit for bit; float64 card against CPU,
    losses, batch-norm buffers, parameters and velocities within
    RESNET_PARITY_F64_TOL of each array's largest; float32 card against
    CPU within RESNET_PARITY_TOLS, or, where the devices' float32
    forwards straddle a ReLU's 0 or a max-pool tie (each straddle within
    RESNET_STRADDLE_TOL of its tensor's largest), in the losses."""
    from paddle_tpu_torch import seed as make_generator
    from paddle_tpu_torch.vision.models import resnet18
    state = resnet18(num_classes=10, device="cpu",
                     generator=make_generator(seed, "cpu")).state_dict()
    x, y = resnet_batch(torch, np, seed + 3, 4, 64, 10, device="cpu")

    def run(device, dtype=torch.float32, seen=None):
        model, opt, step = make_resnet_step(torch, resnet18, seed, 10,
                                            device=device, state=state)
        model.to(dtype)
        if seen is not None:
            _record_branch_inputs(torch, model, seen)
        losses = [step((x.to(device, dtype),), (y.to(device),)).item()
                  for _ in range(RESNET_PARITY_STEPS)]
        tensors = {k: v.detach().cpu().double()
                   for k, v in model.state_dict().items()}
        tensors.update({k: v.cpu().double()
                        for k, v in opt.state_dict().items()
                        if k.endswith("__velocity")})
        return losses, tensors

    def kind(k):
        return ("velocities" if k.endswith("__velocity") else "buffers"
                if k.endswith(("._mean", "._variance")) else "params")

    def errs(got, ref):
        e = dict.fromkeys(RESNET_PARITY_TOLS, 0.0)
        e["losses"] = max(abs(a - b) for a, b in zip(got[0], ref[0])) / \
            max(abs(b) for b in ref[0])
        for k, r in ref[1].items():
            e[kind(k)] = max(e[kind(k)], ((got[1][k] - r).abs().max()
                                          / r.abs().max()).item())
        return e

    card_seen, cpu_seen = [], []
    with _Backends(torch, tf32=False, deterministic=True):
        card = run("cuda", seen=card_seen)
        again = run("cuda")
        card64 = run("cuda", torch.float64)
    cpu = run("cpu", seen=cpu_seen)
    cpu64 = run("cpu", torch.float64)
    bitwise = card[0] == again[0] and all(
        torch.equal(v, again[1][k]) for k, v in card[1].items())
    check(bitwise, "resnet_parity: two card runs from one seed differ")
    check(len([k for k in card[1] if kind(k) == "velocities"]) == 62,
          "resnet_parity: a velocity per parameter")
    e64, e32 = errs(card64, cpu64), errs(card, cpu)
    check(all(v <= RESNET_PARITY_F64_TOL for v in e64.values()),
          f"resnet_parity: float64 card against CPU {e64}")
    straddles = _straddles(torch, card_seen, cpu_seen)
    check(all(d <= RESNET_STRADDLE_TOL for _, d in straddles),
          f"resnet_parity: the devices part away from a branch point: "
          f"{straddles}")
    held = ("losses",) if straddles else tuple(RESNET_PARITY_TOLS)
    check(all(e32[k] <= RESNET_PARITY_TOLS[k] for k in held),
          f"resnet_parity: float32 card against CPU {e32} with "
          f"{len(straddles)} straddles, limits {RESNET_PARITY_TOLS} on "
          f"{held}")
    rec = {"phase": "resnet_parity", "model": "resnet18(num_classes=10)",
           "dtype": "float32 and float64", "tf32": False,
           "cudnn_deterministic": True, "batch": 4, "image": [3, 64, 64],
           "steps": RESNET_PARITY_STEPS, "losses_card": card[0],
           "losses_cpu": cpu[0], "card_runs_bitwise_equal": bitwise,
           "f64_card_vs_cpu_err_of_max": e64,
           "f64_tolerance_of_max": RESNET_PARITY_F64_TOL,
           "f32_card_vs_cpu_err_of_max": e32,
           "f32_tolerance_of_max": RESNET_PARITY_TOLS, "f32_held": held,
           "straddles": [{"where": w, "from_branch_of_max": d}
                         for w, d in straddles],
           "straddle_tolerance_of_max": RESNET_STRADDLE_TOL}
    emit(rec)
    torch.cuda.empty_cache()
    return rec


# -- phase 16c: data and tensor parallelism on torch.distributed --------------

DIST_COMM_TIMEOUT_S = 300        # a rank's rendezvous and each collective
DIST_JOIN_TIMEOUT_S = 900        # a spawned world's join
DP2_STEPS = 3
DP2_LR = 1e-4
DP2_LOSS_RTOL = 1e-5             # float32, the sums ordered differently
DP2_GRAD_TOL = 1e-5              # of each tensor's largest magnitude
DP2_INT8_RTOL = 5e-3             # tests/test_quantized_collectives.py:479
# parameters after AdamW steps: every element within 2 lr a step, and
# all but PARAM_FRAC of all elements within GRAD_TOL of their tensor's
# largest (AdamW divides a gradient by its own root mean square, so an
# element whose gradient is near 0 moves by up to lr on rounding noise)
PARAM_FRAC = 1e-3
MP2_LAYERS, MP2_BATCH, MP2_SEQ, MP2_STEPS = 2, 2, 512, 3
# at lr 1e-4 the 7B-wide model learns the 1,024 tokens in one step (loss
# 11.2 -> 0.69 -> 0.00095), and a relative comparison of a loss near 0
# reads rounding; at 1e-5 the three losses stay of order 1
MP2_LR = 1e-5
MP2_TOL = 1e-5
# the gloo collectives the spawned phases run, probed on CUDA tensors
# first; send and recv go through the port's host staging (gloo's own
# read a CUDA pointer as host memory and abort)
GLOO_CUDA_OPS = ("all_reduce", "all_reduce_max", "broadcast",
                 "all_gather_into_tensor", "all_to_all_single_int8",
                 "all_to_all_single_float32", "reduce_scatter_tensor",
                 "all_gather_object", "send", "recv", "barrier")


def _world_of_one():
    """This process as rank 0 of a world of 1 on card 0 (no master: a
    TCPStore on 127.0.0.1 and a free port)."""
    os.environ.update({"PADDLE_TRAINER_ID": "0", "PADDLE_TRAINERS_NUM": "1",
                       "PADDLE_MASTER": "", "FLAGS_selected_gpus": "0",
                       "PADDLE_COMM_TIMEOUT": str(DIST_COMM_TIMEOUT_S)})


def _f32_no_tf32(torch):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _param_checksums(torch, params):
    """Two exact integers a parameter (the sum of its float bits, and the
    sum weighted by position mod 1009), for (name, parameter) pairs in
    name order: equal on two replicas that are equal bit for bit, and
    differing (but for a collision) otherwise."""
    out = []
    for _, p in sorted(params, key=lambda kv: kv[0]):
        bits = p.detach().reshape(-1).contiguous().view(torch.int32) \
            .to(torch.int64)
        w = torch.arange(bits.numel(), device=bits.device) % 1009 + 1
        out.append((int(bits.sum()), int((bits * w).sum())))
    return out


def _worst_over_max(torch, ref, got, shard=None):
    """(the largest |got - ref| over max |ref| of any tensor, its name);
    ``shard(name, full)`` slices a full reference to ``got``'s shard."""
    worst, worst_k = 0.0, None
    for k, g in got.items():
        r = ref[k] if shard is None else shard(k, ref[k])
        r = r.to(g.device) if g.is_cuda else r.cpu()
        e = float((g.to(r.device) - r).abs().max()) / \
            max(float(r.abs().max()), 1e-30)
        if e > worst:
            worst, worst_k = e, k
    return worst, worst_k


def _param_gap(torch, ref, got, step_bound, shard=None):
    """Parameters after AdamW steps against a reference run: the largest
    element gap (within 2 x step_bound, the farthest two runs can part),
    the share of all elements beyond GRAD_TOL of their tensor's largest
    (under PARAM_FRAC), and the worst tensor's gap over its largest."""
    far = total = 0
    gap = 0.0
    for k, g in got.items():
        r = ref[k] if shard is None else shard(k, ref[k])
        d = (g.to("cuda") - r.to("cuda")).abs()
        gap = max(gap, float(d.max()))
        far += int((d > DP2_GRAD_TOL * float(r.abs().max())).sum())
        total += d.numel()
    worst, worst_k = _worst_over_max(torch, ref, got, shard)
    return {"max_abs_gap": gap, "bound": 2 * step_bound,
            "share_beyond_tol": far / total, "share_limit": PARAM_FRAC,
            "worst_tensor_gap_over_max": worst, "worst_tensor": worst_k,
            "ok": gap <= 2 * step_bound * (1 + 1e-3)
            and far / total < PARAM_FRAC}


def dist_collectives_nccl_phase(torch, np, seed):
    """init_parallel_env() on NCCL at world 1 through a TCPStore on
    127.0.0.1 and a free port, then every collective of the API on CUDA
    tensors against the world-1 result, the compressed wires against the
    port's CPU bodies (the reference's one-rank result, which the CPU
    tests hold them to), and the int8 codec on the card against its CPU
    version."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import ReduceOp, collective as C
    _world_of_one()
    dist.init_parallel_env()
    check(dist.get_backend() == "NCCL" and dist.get_world_size() == 1,
          f"dist_collectives_nccl: backend {dist.get_backend()}")
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((37, 129)).astype(np.float32),
                        device="cuda")
    xi = torch.as_tensor(rng.integers(-99, 99, (64,)).astype(np.int32),
                         device="cuda")
    results = {}

    def same(name, got, want):
        ok = torch.equal(got, want)
        results[name] = ok
        check(ok, f"dist_collectives_nccl: {name} differs from the world-1 "
                  f"result")

    for op in ("SUM", "MAX", "MIN", "PROD", "AVG"):
        for src in (x, xi):
            t = src.clone()
            dist.all_reduce(t, op=getattr(ReduceOp, op))
            same(f"all_reduce_{op.lower()}_{str(src.dtype)[6:]}", t, src)
    parts = []
    dist.all_gather(parts, x)
    same("all_gather", torch.stack(parts), x[None])
    same("all_gather_axis", dist.all_gather(None, x, axis=1), x)
    out = torch.empty_like(x)
    dist.reduce_scatter(out, x.clone())
    same("reduce_scatter", out, x)
    t = x.clone()
    dist.reduce(t, dst=0)
    same("reduce", t, x)
    t = x.clone()
    dist.broadcast(t, src=0)
    same("broadcast", t, x)
    t = torch.empty_like(x)
    dist.scatter(t, [x], src=0)
    same("scatter", t, x)
    same("gather", dist.gather(x)[0], x)
    same("alltoall", dist.alltoall(x), x)
    same("alltoall_single", dist.alltoall_single(x), x)
    g = dist.new_group([0])
    t = x.clone()
    dist.all_reduce(t, group=g)
    same("new_group_all_reduce", t, x)
    t = x.clone()
    dist.all_reduce(t, op=ReduceOp.AVG, sync_op=False).wait()
    same("all_reduce_task", t, x)
    objs = []
    dist.all_gather_object(objs, {"seed": seed})
    box = [seed]
    dist.broadcast_object_list(box, src=0)
    got = []
    dist.scatter_object_list(got, ["a"], src=0)
    results["object_lists"] = objs == [{"seed": seed}] and box == [seed] \
        and got == ["a"]
    check(results["object_lists"], "dist_collectives_nccl: object lists")
    dist.barrier()
    # the compressed wires at one rank: the reference quantizes even
    # there; held to the port's CPU body (a one-rank local group)
    local = C.Group([0], None)
    wires = {}
    for comp in ("int8", "bf16"):
        t = x.clone()
        dist.all_reduce(t, compress=comp)
        cpu = x.cpu().clone()
        dist.all_reduce(cpu, group=local, compress=comp)
        o = torch.empty_like(x)
        dist.reduce_scatter(o, x.clone(), compress=comp)
        cpu_rs = torch.empty_like(cpu)
        dist.reduce_scatter(cpu_rs, x.cpu().clone(), group=local,
                            compress=comp)
        diff = (t.cpu() - cpu).abs()
        wires[comp] = {"all_reduce_unequal": int((diff > 0).sum()),
                       "all_reduce_max_abs_diff": float(diff.max()),
                       "reduce_scatter_unequal":
                           int((o.cpu() != cpu_rs).sum()),
                       "max_abs_err_vs_exact": float((t - x).abs().max())}
        check(not torch.equal(t, x), f"dist_collectives_nccl: "
                                     f"compress={comp} changed nothing")
    # the int8 codec on the card against its CPU version, on one input
    flat, _ = C._pad_flat(x, C.QUANT_BLOCK)
    qc, sc = C.quantize_blockwise_int8(flat)
    qh, sh = C.quantize_blockwise_int8(flat.cpu())
    code_diff = (qc.cpu().to(torch.int32) - qh.to(torch.int32)).abs()
    codec = {"codes": int(flat.numel()),
             "codes_unequal": int((code_diff > 0).sum()),
             "codes_max_diff": int(code_diff.max()),
             "scales_unequal": int((sc.cpu() != sh).sum())}
    check(codec["codes_max_diff"] <= 1 and codec["scales_unequal"] == 0,
          f"dist_collectives_nccl: the card's int8 codec: {codec}")
    # one rank's bf16 wire is one rounding, the same on both; an int8 code
    # one apart (a tie rounded apart) moves its element by one step
    check(wires["bf16"]["all_reduce_unequal"] == 0
          and wires["bf16"]["reduce_scatter_unequal"] == 0
          and wires["int8"]["all_reduce_unequal"]
          <= 2 * codec["codes_unequal"],
          f"dist_collectives_nccl: the compressed wires at one rank on the "
          f"card against the CPU bodies: {wires}")
    rec = {"phase": "dist_collectives_nccl", "card": card_line(),
           "backend": dist.get_backend(), "world_size": 1,
           "rendezvous": "TCPStore 127.0.0.1, a free port",
           "collectives_equal_world1": results,
           "compressed_world1_vs_cpu_body": wires,
           "int8_codec_card_vs_cpu": codec}
    emit(rec)
    return rec


def _fleet_init(torch, backend=None, grad_compress=None,
                dispatch_compress=None, knobs=None, **degrees):
    """fleet.init on the world (its backend as init_parallel_env chose,
    or ``backend``) with these degrees, the gradient-sync codec, the MoE
    dispatch's and the strategy's other ``knobs`` (a dict)."""
    from paddle_tpu_torch.distributed import fleet
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
                        **degrees}
    s.grad_compress = grad_compress
    s.dispatch_compress = dispatch_compress
    for k, v in (knobs or {}).items():
        setattr(s, k, v)
    fleet.init(is_collective=True, strategy=s, backend=backend)
    return fleet


def _gpt2_steps(torch, step, ids, labels):
    """TRAIN_WARMUP + TRAIN_TIMED steps: (losses, s per timed step)."""
    losses = [step((ids,), (labels,)) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED):
        losses.append(step((ids,), (labels,)))
    torch.cuda.synchronize()
    return [x.item() for x in losses], \
        (time.perf_counter() - t0) / TRAIN_TIMED


def train_gpt2_dp_phase(torch, np, seed, base):
    """train_gpt2's configuration through fleet.init(dp_degree=1),
    fleet.distributed_model, fleet.distributed_optimizer and TrainStep on
    NCCL at world 1: 2 warm-up and 10 timed steps whose losses must be
    train_gpt2's bit for bit (one rank: the sync is the identity, as the
    reference's trivial axis tags nothing). The plain TrainStep of
    train_gpt2 is timed the same way in turns (plain, fleet, plain):
    s/step, tokens/s and their ratio, the wrapper's cost."""
    from paddle_tpu_torch import AdamW, GPTForCausalLM, TrainStep
    from paddle_tpu_torch.kernels.flash_attention import (_flash_bhsd,
                                                          _flash_bhsd_bwd)
    fleet = _fleet_init(torch, dp_degree=1)
    cfg = gpt2_config()
    ids, labels = gpt2_batch(torch, np, seed + 3, cfg)
    plain_s = []
    for turn in ("plain", "fleet", "plain"):
        if turn == "plain":
            model, step = make_gpt2_step(torch, cfg, seed)
            plain_losses, s = _gpt2_steps(torch, step, ids, labels)
            plain_s.append(s)
            del model, step
            continue
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        model = fleet.distributed_model(GPTForCausalLM(cfg, generator=gen))
        opt = fleet.distributed_optimizer(
            AdamW(learning_rate=1e-4, parameters=model.parameters()))
        step = TrainStep(model, gpt2_loss, opt)
        torch.cuda.synchronize()
        zero_flash_counts(_flash_bhsd, _flash_bhsd_bwd)
        losses, s_step = _gpt2_steps(torch, step, ids, labels)
        fwd_routes = dict(_flash_bhsd.route_launches)
        bwd_routes = dict(_flash_bhsd_bwd.route_launches)
        wrapper = type(model).__name__
        hooks = len(model._grad_sync._handles)
        del model, step, opt
    torch.cuda.empty_cache()
    n = TRAIN_WARMUP + TRAIN_TIMED
    plain = sum(plain_s) / 2
    rec = {"phase": "train_gpt2_dp", "card": card_line(),
           "entry_points": ["fleet.init(dp_degree=1)",
                            "fleet.distributed_model",
                            "fleet.distributed_optimizer", "TrainStep"],
           "backend": "NCCL", "world_size": 1, "wrapper": wrapper,
           "grad_sync_hooks": hooks,
           "warmup_steps": TRAIN_WARMUP, "timed_steps": TRAIN_TIMED,
           "s_per_step": s_step,
           "tokens_per_s": GPT2_BATCH * GPT2_SEQ / s_step,
           "plain_s_per_step_before_after": plain_s,
           "plain_tokens_per_s": GPT2_BATCH * GPT2_SEQ / plain,
           "s_per_step_over_plain": s_step / plain,
           "train_gpt2_s_per_step": base["s_per_step"],
           "losses": losses,
           "losses_equal_train_gpt2": losses == base["losses"],
           "losses_equal_plain_in_turn": losses == plain_losses,
           "flash_fwd_route_launches": fwd_routes,
           "flash_bwd_route_launches": bwd_routes}
    emit(rec)
    check(wrapper == "DataParallel",
          f"train_gpt2_dp: fleet wrapped the model as {wrapper}")
    check(rec["losses_equal_train_gpt2"] and rec["losses_equal_plain_in_turn"],
          f"train_gpt2_dp: losses {losses} are not train_gpt2's "
          f"{base['losses']} bit for bit")
    check(fwd_routes["wgmma"] == cfg.num_hidden_layers * n
          and bwd_routes["wgmma"] == cfg.num_hidden_layers * n,
          f"train_gpt2_dp: flash launches {fwd_routes}, {bwd_routes}")
    return rec


def train_mp1_nccl_phase(torch, np, seed, base):
    """The train phase's configuration built with tensor_parallel=True
    under fleet.init(mp_degree=1) on NCCL (the mp layers at one rank, the
    criterion on ParallelCrossEntropy): its losses must be the train
    phase's bit for bit, its s/step is printed beside that phase's."""
    from paddle_tpu_torch import AdamW, LlamaPretrainingCriterion, TrainStep
    from paddle_tpu_torch.kernels.flash_attention import (_flash_bhsd,
                                                          _flash_bhsd_bwd)
    fleet = _fleet_init(torch, mp_degree=1)
    cfg = train_config()
    cfg.tensor_parallel = True
    model = fleet.distributed_model(build_model(torch, cfg, seed))
    crit = LlamaPretrainingCriterion(cfg)
    opt = fleet.distributed_optimizer(
        AdamW(learning_rate=1e-4, parameters=model.parameters(),
              moment_dtype="bfloat16"))
    step = TrainStep(model, lambda lo, la: crit(lo, la), opt)
    ids, labels = train_batch(torch, np, seed + 3, cfg.vocab_size,
                              TRAIN_BATCH, TRAIN_SEQ)
    torch.cuda.synchronize()
    zero_flash_counts(_flash_bhsd, _flash_bhsd_bwd)
    losses = [step((ids,), (labels,)) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED):
        losses.append(step((ids,), (labels,)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [x.item() for x in losses]
    fwd_routes = dict(_flash_bhsd.route_launches)
    bwd_routes = dict(_flash_bhsd_bwd.route_launches)
    n = TRAIN_WARMUP + TRAIN_TIMED
    check(losses == base["losses"],
          f"train_mp1_nccl: losses {losses} are not train's "
          f"{base['losses']} bit for bit")
    check(fwd_routes["wgmma"] == cfg.num_hidden_layers * n
          and bwd_routes["wgmma"] == cfg.num_hidden_layers * n,
          f"train_mp1_nccl: flash launches {fwd_routes}, {bwd_routes}")
    rec = {"phase": "train_mp1_nccl", "card": card_line(),
           "entry_points": ["fleet.init(mp_degree=1)",
                            "LlamaConfig(tensor_parallel=True)",
                            "fleet.distributed_model",
                            "fleet.distributed_optimizer", "TrainStep"],
           "backend": "NCCL", "world_size": 1,
           "layers": cfg.num_hidden_layers, "dtype": cfg.dtype,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "s_per_step": wall / TRAIN_TIMED,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ * TRAIN_TIMED / wall,
           "train_s_per_step": base["s_per_step"],
           "s_per_step_over_train": wall / TRAIN_TIMED / base["s_per_step"],
           "losses": losses, "losses_equal_train": True,
           "flash_fwd_route_launches": fwd_routes,
           "flash_bwd_route_launches": bwd_routes}
    emit(rec)
    del model, step, opt
    torch.cuda.empty_cache()
    return rec


# train_mp1_quant_nccl: train's configuration under matmul_quant, 2 warm-up
# and 5 timed steps a lane (train times 10: the cut saves script time)
QUANT_TRAIN_TIMED = 5
# the quantized forward moves the step-1 loss from the exact one by less
# than this (relative), and by something
QUANT_LOSS_RTOL = 2e-2
# the mp layers' products a step: q, k, v, o, gate, up, down a layer and
# the head; each forward runs quant_matmul once (the backward is float32)
QUANT_LINEARS_PER_LAYER = 7
# quant_matmul at the step's shapes: (name, K, N) for M = batch x seq
QUANT_TRAIN_SHAPES = (("qkvo", 4096, 4096), ("gate_up", 4096, 11008),
                      ("down", 11008, 4096), ("head", 4096, 32000))


def train_mp1_quant_nccl_phase(torch, np, seed, base):
    """train_mp1_nccl's configuration (train's Llama: 4 layers, hidden
    4096, batch 6 x 2048, bf16, AdamW with bf16 moments; fleet.init at
    world 1 on NCCL, tensor_parallel=True) under
    ``DistributedStrategy.matmul_quant`` "int8" and "fp8": every mp
    layer's forward runs quant_matmul on its weight quantized per block
    (7 a layer and the head a step, all on the wgmma route), the backward
    is float32 against the bf16 weights (the reference's straight-through
    estimator). Per lane: s/step, tokens/s and MFU over 5 timed steps
    after 2 warm-up ones; the step-1 loss within 2 % of train_mp1_nccl's
    on the same weights and batch, and not equal to it; the losses fall.
    Then quant_matmul at the step's four shapes (M 12,288; int8 codes,
    bf16 x) against its plain version, timed beside F.linear on the bf16
    weight. Returns the lanes and the gate_up check."""
    from paddle_tpu_torch import AdamW, LlamaPretrainingCriterion, TrainStep
    from paddle_tpu_torch.kernels.flash_attention import (_flash_bhsd,
                                                          _flash_bhsd_bwd)
    from paddle_tpu_torch.kernels.quant_matmul import (configure_matmul_quant,
                                                       quant_matmul)
    from paddle_tpu_torch.observability import model_flops_per_token
    cfg = train_config()
    cfg.tensor_parallel = True
    ids, labels = train_batch(torch, np, seed + 3, cfg.vocab_size,
                              TRAIN_BATCH, TRAIN_SEQ)
    layers = cfg.num_hidden_layers
    per_step = QUANT_LINEARS_PER_LAYER * layers + 1
    lanes = {}
    try:
        for qd in ("int8", "fp8"):
            fleet = _fleet_init(torch, mp_degree=1,
                                knobs={"matmul_quant": qd})
            model = fleet.distributed_model(build_model(torch, cfg, seed))
            n_params = sum(p.numel() for p in model.parameters())
            crit = LlamaPretrainingCriterion(cfg)
            opt = fleet.distributed_optimizer(
                AdamW(learning_rate=1e-4, parameters=model.parameters(),
                      moment_dtype="bfloat16"))
            step = TrainStep(model, lambda lo, la: crit(lo, la), opt)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            quant_matmul.launches = 0
            quant_matmul.route_launches = dict.fromkeys(
                quant_matmul.route_launches, 0)
            zero_flash_counts(_flash_bhsd, _flash_bhsd_bwd)
            losses = [step((ids,), (labels,)) for _ in range(TRAIN_WARMUP)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(QUANT_TRAIN_TIMED):
                losses.append(step((ids,), (labels,)))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            losses = [x.item() for x in losses]
            n = TRAIN_WARMUP + QUANT_TRAIN_TIMED
            routes = dict(quant_matmul.route_launches)
            tps = TRAIN_BATCH * TRAIN_SEQ * QUANT_TRAIN_TIMED / wall
            flops_tok = model_flops_per_token(cfg, TRAIN_SEQ, n_params)
            rel = abs(losses[0] - base["losses"][0]) / abs(base["losses"][0])
            lanes[qd] = {
                "s_per_step": wall / QUANT_TRAIN_TIMED, "tokens_per_s": tps,
                "mfu": flops_tok * tps / BF16_FLOPS,
                "train_mp1_nccl_s_per_step": base["s_per_step"],
                "losses": losses, "step1_loss_rel_gap_to_exact": rel,
                "quant_matmul_launches": quant_matmul.launches,
                "quant_matmul_route_launches": routes,
                "quant_matmul_launches_rule": f"(7 x {layers} layers + the "
                                              f"head) x {n} steps",
                "flash_fwd_route_launches": dict(_flash_bhsd.route_launches),
                "peak_device_bytes": torch.cuda.max_memory_allocated()}
            check(all(math.isfinite(x) for x in losses) and
                  losses[-1] < losses[0],
                  f"train_mp1_quant_nccl {qd}: losses {losses}")
            check(0 < rel <= QUANT_LOSS_RTOL,
                  f"train_mp1_quant_nccl {qd}: step-1 loss {losses[0]} vs "
                  f"the exact {base['losses'][0]} (rel {rel})")
            check(routes == {**dict.fromkeys(routes, 0),
                             "wgmma": per_step * n},
                  f"train_mp1_quant_nccl {qd}: quant_matmul routes {routes}, "
                  f"want {per_step * n} wgmma")
            check(_flash_bhsd.route_launches["wgmma"] == layers * n,
                  f"train_mp1_quant_nccl {qd}: flash launches "
                  f"{_flash_bhsd.route_launches}")
            del model, step, opt
            torch.cuda.empty_cache()
    finally:
        configure_matmul_quant("none")
    m = TRAIN_BATCH * TRAIN_SEQ
    checks = {name: qmm_case(torch, f"train_{name}_m{m}_k{k}_n{n}", m, k, n,
                             "int8", torch.bfloat16, m + k + n)
              for name, k, n in QUANT_TRAIN_SHAPES}
    for name, rec in checks.items():
        check(rec["route"] == "wgmma", f"train {name}: routed to "
                                       f"{rec['route']}")
    rec = {"phase": "train_mp1_quant_nccl", "card": card_line(),
           "entry_points": ["fleet.init(mp_degree=1, matmul_quant=...)",
                            "LlamaConfig(tensor_parallel=True)",
                            "fleet.distributed_model",
                            "fleet.distributed_optimizer", "TrainStep"],
           "backend": "NCCL", "world_size": 1, "layers": layers,
           "dtype": cfg.dtype, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "warmup_steps": TRAIN_WARMUP, "timed_steps": QUANT_TRAIN_TIMED,
           "timed_steps_note": "5, not train's 10: saves script time",
           "exact_step1_loss": base["losses"][0], "lanes": lanes,
           "kernel_checks": {k: {"kernel_ms": r["kernel_ms"],
                                 "bound_ms": r["bound_ms"],
                                 "library_ms": r["library_ms"],
                                 "plain_ms": r["plain_ms"],
                                 "max_abs_err": r["max_abs_err"]}
                             for k, r in checks.items()}}
    emit(rec)
    return {"lanes": lanes, "check": checks["gate_up"],
            "wgmma_launches": sum(l["quant_matmul_route_launches"]["wgmma"]
                                  for l in lanes.values())}


def quant_profile_build(torch, np, qd):
    """train_mp1_quant_nccl's model, step and batch under matmul_quant
    ``qd``, for train_profile_phase (the caller turns the knob off)."""
    from paddle_tpu_torch import AdamW, LlamaPretrainingCriterion, TrainStep

    def build(seed):
        cfg = train_config()
        cfg.tensor_parallel = True
        fleet = _fleet_init(torch, mp_degree=1, knobs={"matmul_quant": qd})
        model = fleet.distributed_model(build_model(torch, cfg, seed))
        crit = LlamaPretrainingCriterion(cfg)
        opt = fleet.distributed_optimizer(
            AdamW(learning_rate=1e-4, parameters=model.parameters(),
                  moment_dtype="bfloat16"))
        step = TrainStep(model, lambda lo, la: crit(lo, la), opt)
        ids, labels = train_batch(torch, np, seed + 3, cfg.vocab_size,
                                  TRAIN_BATCH, TRAIN_SEQ)
        return model, step, ids, labels
    return build


def _probe_gloo_cuda(torch, progress):
    """Each gloo collective the phase needs once on tiny CUDA tensors,
    noted in ``progress`` before it runs (an op that aborts the rank is
    named by the last note). A refusal raises, naming the op."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import ReduceOp
    x = torch.arange(8, dtype=torch.float32, device="cuda")
    me, n = dist.get_rank(), dist.get_world_size()
    box = {}
    calls = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_reduce_max": lambda: dist.all_reduce(x.clone(),
                                                  op=ReduceOp.MAX),
        "broadcast": lambda: dist.broadcast(x.clone(), src=0),
        "all_gather_into_tensor": lambda: dist.all_gather(None, x),
        "all_to_all_single_int8": lambda: dist.alltoall_single(
            x.to(torch.int8)),
        "all_to_all_single_float32": lambda: dist.alltoall_single(x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter(
            x.new_empty(8 // n), x.clone()),
        "all_gather_object": lambda: dist.all_gather_object([], 1),
        # a ring: each rank sends to the next and receives from the last
        "send": lambda: box.update(task=dist.isend(x, (me + 1) % n)),
        "recv": lambda: (dist.recv(torch.empty_like(x), (me - 1) % n),
                         box["task"].wait()),
        "barrier": lambda: dist.barrier()}
    for name in GLOO_CUDA_OPS:
        with open(progress, "a") as f:
            f.write(f"{name}\n")
        try:
            calls[name]()
            torch.cuda.synchronize()
        except Exception as e:
            raise RuntimeError(f"gloo refuses {name} on CUDA tensors: "
                               f"{e}") from e


def _rank_done(tmpdir, rank, result):
    import pickle
    with open(os.path.join(tmpdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def _rank_failed(tmpdir, rank):
    with open(os.path.join(tmpdir, f"rank{rank}.err"), "w") as f:
        f.write(traceback.format_exc())


def _spawn_world(fn, args, tmpdir, phase, n=2, deadline=DIST_JOIN_TIMEOUT_S):
    """``n`` ranks on cuda:0 over gloo; each rank's failure fails the
    phase, with its traceback (or the probed op it died in), and so does
    a world that has not ended within ``deadline`` seconds (its ranks are
    ended: a deadlocked schedule cannot hang the run)."""
    import pickle
    from paddle_tpu_torch.distributed import spawn
    from paddle_tpu_torch.distributed.misc import join_all
    procs = spawn(fn, args=(tmpdir,) + tuple(args), nprocs=n, join=False,
                  gpus=[0] * n, master=f"file://{tmpdir}/store")
    try:
        join_all(procs, deadline)
    except RuntimeError as e:
        why = []
        for r in range(n):
            for ext in ("err", "probe"):
                p = os.path.join(tmpdir, f"rank{r}.{ext}")
                if os.path.exists(p):
                    why.append(f"rank {r} {ext}: "
                               + open(p).read().strip()[-3000:])
        raise AssertionError(f"{phase}: {e}\n" + "\n".join(why)) from None
    out = []
    for r in range(n):
        with open(os.path.join(tmpdir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _dp2_rank(tmpdir, seed, ids, labels):
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    os.environ["PADDLE_COMM_TIMEOUT"] = str(DIST_COMM_TIMEOUT_S)
    try:
        import numpy as np
        import torch
        import paddle_tpu_torch.distributed as dist
        from paddle_tpu_torch import AdamW, GPTForCausalLM, TrainStep
        from paddle_tpu_torch.kernels.flash_attention import (
            _flash_bhsd, _flash_bhsd_bwd)
        dist.init_parallel_env(backend="gloo")
        _probe_gloo_cuda(torch, os.path.join(tmpdir, f"rank{rank}.probe"))
        _f32_no_tf32(torch)
        cfg = gpt2_config(dtype="float32", dropout=0.0)
        per = ids.shape[0] // 2
        x = torch.as_tensor(ids[rank * per:(rank + 1) * per], device="cuda")
        y = torch.as_tensor(labels[rank * per:(rank + 1) * per],
                            device="cuda")
        res = {}
        for compress in (None, "int8"):
            fleet = _fleet_init(torch, backend="gloo", grad_compress=compress,
                                dp_degree=2)
            gen = torch.Generator(device="cuda")
            gen.manual_seed(seed)
            model = fleet.distributed_model(GPTForCausalLM(cfg,
                                                           generator=gen))
            opt = fleet.distributed_optimizer(AdamW(
                learning_rate=DP2_LR, parameters=model.parameters()))
            step = TrainStep(model, gpt2_loss, opt)
            zero_flash_counts(_flash_bhsd, _flash_bhsd_bwd)
            losses, times, equal = [], [], []
            for i in range(DP2_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(step((x,), (y,)).item())
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                if i == 0 and rank == 0 and compress is None:
                    torch.save({k: p.grad.detach().cpu() for k, p in
                                model.named_parameters()},
                               os.path.join(tmpdir, "exact_grads1.pt"))
                sums = []
                dist.all_gather_object(sums, _param_checksums(
                    torch, model.named_parameters()))
                equal.append(sums[0] == sums[1])
            sched = step._grad_sync
            name = compress or "exact"
            res[name] = {
                "losses": losses, "step_s": times,
                "replicas_equal_each_step": equal,
                "buckets": len(sched.buckets),
                "bucket_mb": sched.bucket_mb,
                "bytes_per_step": sched.bytes_per_step,
                "wire_bytes_per_step": sched.wire_bytes_per_step,
                "counters": dict(sched.counters),
                "flash_fwd_route_launches": dict(_flash_bhsd.route_launches),
                "flash_bwd_route_launches":
                    dict(_flash_bhsd_bwd.route_launches)}
            if rank == 0 and compress is None:
                torch.save({k: p.detach().cpu() for k, p in
                            model.named_parameters()},
                           os.path.join(tmpdir, "exact_params.pt"))
            del model, step, opt
            torch.cuda.empty_cache()
        dist.barrier()
        _rank_done(tmpdir, rank, res)
        dist.destroy_process_group()
    except BaseException:
        _rank_failed(tmpdir, rank)
        raise


def dp2_gloo_on_card_phase(torch, np, seed, tmpdir):
    """Data parallelism in two ranks on cuda:0 over gloo (one card: NCCL
    takes one rank a device), with CUDA tensors: GPT-2 124M at full
    width in float32 with TF32 off and dropout 0, the global batch of 8 x
    1024 split 4 + 4, 3 steps with the exact sync and 3 with
    grad_compress="int8" (the default 32 MiB buckets), through fleet's
    entry points. Held against one process over the full batch on the
    card: every loss within 1e-5 relative; step 1's synced gradients
    within 1e-5 of each tensor's largest (the sync's exactness, before
    AdamW); the parameters after step 3 by PARAM_FRAC's rule, the worst
    tensor's gap printed; the replicas equal bit for bit after every
    step; int8 step 1 within 1e-6 of the exact run, steps 2-3 within 5e-3
    and not equal. The wire here is host memory (gloo copies CUDA
    tensors through it): its times are no NCCL figure."""
    from paddle_tpu_torch import AdamW, GPTForCausalLM, TrainStep
    _f32_no_tf32(torch)
    cfg = gpt2_config(dtype="float32", dropout=0.0)
    rng = np.random.default_rng(seed + 3)
    ids = rng.integers(0, cfg.vocab_size, (GPT2_BATCH, GPT2_SEQ))
    labels = rng.integers(0, cfg.vocab_size, (GPT2_BATCH, GPT2_SEQ))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    model = GPTForCausalLM(cfg, generator=gen)
    step = TrainStep(model, gpt2_loss, AdamW(
        learning_rate=DP2_LR, parameters=model.parameters()))
    x, y = (torch.as_tensor(a, device="cuda") for a in (ids, labels))
    one, one_s, grads1 = [], [], None
    for i in range(DP2_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one.append(step((x,), (y,)).item())
        torch.cuda.synchronize()
        one_s.append(time.perf_counter() - t0)
        if i == 0:
            grads1 = {k: p.grad.detach().clone()
                      for k, p in model.named_parameters()}
    ref = {k: p.detach() for k, p in model.named_parameters()}
    del step
    torch.cuda.empty_cache()
    ranks = _spawn_world(_dp2_rank, (seed, ids, labels), tmpdir,
                         "dp2_gloo_on_card")
    grad_worst = _worst_over_max(torch, grads1, torch.load(
        os.path.join(tmpdir, "exact_grads1.pt")))
    param_gap = _param_gap(torch, ref, torch.load(
        os.path.join(tmpdir, "exact_params.pt")), DP2_LR * DP2_STEPS)
    del model, ref, grads1
    torch.cuda.empty_cache()
    exact = [np.mean([r["exact"]["losses"][i] for r in ranks])
             for i in range(DP2_STEPS)]
    int8 = [np.mean([r["int8"]["losses"][i] for r in ranks])
            for i in range(DP2_STEPS)]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(exact, one))
    r0 = ranks[0]
    rec = {"phase": "dp2_gloo_on_card", "card": card_line(),
           "note": "two ranks on one card over gloo: the wire is host "
                   "memory, no NCCL figure",
           "model": "GPT-2 124M, float32, TF32 off, dropout 0",
           "global_batch": [GPT2_BATCH, GPT2_SEQ], "rank_batch":
           [GPT2_BATCH // 2, GPT2_SEQ], "steps": DP2_STEPS,
           "gloo_cuda_ops_probed": list(GLOO_CUDA_OPS),
           "one_process_losses": one, "one_process_step_s": one_s,
           "exact_losses_mean_of_ranks": exact,
           "int8_losses_mean_of_ranks": int8,
           "exact_loss_max_rel_diff": loss_rel,
           "step1_grad_worst_over_max": grad_worst[0],
           "step1_grad_worst_tensor": grad_worst[1],
           "params_after_step3": param_gap,
           "exact": {k: r0["exact"][k] for k in (
               "step_s", "buckets", "bucket_mb", "bytes_per_step",
               "wire_bytes_per_step", "counters",
               "flash_fwd_route_launches", "flash_bwd_route_launches")},
           "int8": {k: r0["int8"][k] for k in (
               "step_s", "buckets", "bucket_mb", "bytes_per_step",
               "wire_bytes_per_step", "counters")},
           "replicas_equal_each_step": {
               run: [r[run]["replicas_equal_each_step"] for r in ranks]
               for run in ("exact", "int8")}}
    emit(rec)
    check(loss_rel <= DP2_LOSS_RTOL, f"dp2_gloo_on_card: exact losses "
                                     f"{exact} vs one process {one}")
    check(grad_worst[0] <= DP2_GRAD_TOL,
          f"dp2_gloo_on_card: step 1's synced gradient of {grad_worst[1]} "
          f"off by {grad_worst[0]} of its largest")
    check(param_gap["ok"], f"dp2_gloo_on_card: parameters after step "
                           f"{DP2_STEPS}: {param_gap}")
    for r in ranks:
        for run in ("exact", "int8"):
            check(all(r[run]["replicas_equal_each_step"]),
                  f"dp2_gloo_on_card: {run} replicas differ")
    check(abs(int8[0] - exact[0]) <= 1e-6 * abs(exact[0]),
          f"dp2_gloo_on_card: int8 step 1 {int8[0]} vs {exact[0]}")
    for i in range(1, DP2_STEPS):
        check(abs(int8[i] - exact[i]) <= DP2_INT8_RTOL * abs(exact[i])
              and int8[i] != exact[i],
              f"dp2_gloo_on_card: int8 step {i + 1} {int8[i]} vs exact "
              f"{exact[i]}")
    return rec


def _mp2_config(tensor_parallel):
    from paddle_tpu_torch.models.llama import LlamaConfig
    return LlamaConfig(vocab_size=32000, hidden_size=4096,
                       intermediate_size=11008, num_hidden_layers=MP2_LAYERS,
                       num_attention_heads=32, num_key_value_heads=32,
                       max_position_embeddings=MP2_SEQ, dtype="float32",
                       tensor_parallel=tensor_parallel)


def _mp2_rank(tmpdir, seed, ids, labels, ref_losses):
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    os.environ["PADDLE_COMM_TIMEOUT"] = str(DIST_COMM_TIMEOUT_S)
    try:
        import torch
        import paddle_tpu_torch.distributed as dist
        from paddle_tpu_torch import (AdamW, LlamaPretrainingCriterion,
                                      TrainStep)
        from paddle_tpu_torch.convert import tp_shard
        from paddle_tpu_torch.kernels.flash_attention import (
            _flash_bhsd, _flash_bhsd_bwd)
        dist.init_parallel_env(backend="gloo")
        _probe_gloo_cuda(torch, os.path.join(tmpdir, f"rank{rank}.probe"))
        _f32_no_tf32(torch)
        fleet = _fleet_init(torch, mp_degree=2, backend="gloo")
        hcg = fleet.get_hybrid_communicate_group()
        cfg = _mp2_config(True)
        model = fleet.distributed_model(build_model(torch, cfg, seed))
        crit = LlamaPretrainingCriterion(cfg)
        opt = fleet.distributed_optimizer(AdamW(
            learning_rate=MP2_LR, parameters=model.parameters()))
        step = TrainStep(model, lambda lo, la: crit(lo, la), opt)
        x, y = (torch.as_tensor(a, device="cuda") for a in (ids, labels))
        zero_flash_counts(_flash_bhsd, _flash_bhsd_bwd)
        mr = hcg.get_model_parallel_rank()

        def shard(k, full):
            return tp_shard(k, full, mr, 2)
        losses, times = [], []
        for i in range(MP2_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(step((x,), (y,)).item())
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if i == 0:
                grad_worst = _worst_over_max(
                    torch, torch.load(os.path.join(tmpdir,
                                                   "mp1_grads1.pt"),
                                      mmap=True),
                    {k: p.grad for k, p in model.named_parameters()},
                    shard)
        param_gap = _param_gap(
            torch, torch.load(os.path.join(tmpdir, "mp1_params.pt"),
                              mmap=True),
            {k: p.detach() for k, p in model.named_parameters()},
            MP2_LR * MP2_STEPS, shard)
        sums = []
        dist.all_gather_object(sums, _param_checksums(
            torch, [(k, p) for k, p in model.named_parameters()
                    if not getattr(p, "mp_sharded", False)]))
        _rank_done(tmpdir, rank, {
            "mp_rank": mr, "losses": losses, "step_s": times,
            "step1_grad_worst": grad_worst, "params_after_step3": param_gap,
            "replicated_equal": sums[0] == sums[1],
            "flash_fwd_route_launches": dict(_flash_bhsd.route_launches),
            "flash_bwd_route_launches": dict(_flash_bhsd_bwd.route_launches),
            "params_per_rank": sum(p.numel() for p in model.parameters())})
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        _rank_failed(tmpdir, rank)
        raise


def mp2_gloo_on_card_phase(torch, np, seed, tmpdir):
    """Tensor parallelism in two ranks on cuda:0 over gloo: Llama at
    Llama-2-7B widths (hidden 4096, 32 heads of 128, FFN 11008, vocab
    32000), 2 layers, float32 with TF32 off, batch 2 x 512, AdamW at lr
    1e-5, 3 steps, with tensor_parallel=True under fleet.init(mp_degree=
    2). Held against one process running the same model at mp 1 from the
    same full weights (the ranks draw them whole from the same seed and
    keep their slices): every loss within 1e-5 relative, each rank's
    step-1 gradient shards within 1e-5 of their largest to the matching
    slices of the mp-1 gradients, its shards after step 3 against the
    matching slices of the mp-1 parameters by PARAM_FRAC's rule (the
    worst tensor's gap printed), and the parameters no rank shards equal
    on both ranks bit for bit."""
    from paddle_tpu_torch import AdamW, LlamaPretrainingCriterion, TrainStep
    _f32_no_tf32(torch)
    cfg = _mp2_config(False)
    rng = np.random.default_rng(seed + 3)
    ids = rng.integers(0, cfg.vocab_size, (MP2_BATCH, MP2_SEQ))
    labels = rng.integers(0, cfg.vocab_size, (MP2_BATCH, MP2_SEQ))
    model = build_model(torch, cfg, seed)
    crit = LlamaPretrainingCriterion(cfg)
    step = TrainStep(model, lambda lo, la: crit(lo, la), AdamW(
        learning_rate=MP2_LR, parameters=model.parameters()))
    x, y = (torch.as_tensor(a, device="cuda") for a in (ids, labels))
    one, one_s = [], []
    for i in range(MP2_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one.append(step((x,), (y,)).item())
        torch.cuda.synchronize()
        one_s.append(time.perf_counter() - t0)
        if i == 0:
            torch.save({k: p.grad.detach().cpu()
                        for k, p in model.named_parameters()},
                       os.path.join(tmpdir, "mp1_grads1.pt"))
    torch.save({k: p.detach().cpu() for k, p in model.named_parameters()},
               os.path.join(tmpdir, "mp1_params.pt"))
    n_params = sum(p.numel() for p in model.parameters())
    del model, step
    torch.cuda.empty_cache()
    ranks = _spawn_world(_mp2_rank, (seed, ids, labels, one), tmpdir,
                         "mp2_gloo_on_card")
    rec = {"phase": "mp2_gloo_on_card", "card": card_line(),
           "note": "two ranks on one card over gloo: the mp collectives "
                   "go through host memory, no NCCL figure",
           "model": "Llama, Llama-2-7B widths, float32, TF32 off",
           "layers": MP2_LAYERS, "batch": [MP2_BATCH, MP2_SEQ],
           "params_mp1": n_params,
           "params_per_rank": [r["params_per_rank"] for r in ranks],
           "lr": MP2_LR, "mp1_losses": one, "mp1_step_s": one_s,
           "rank_losses": [r["losses"] for r in ranks],
           "rank_step_s": [r["step_s"] for r in ranks],
           "step1_grad_worst_over_max": [r["step1_grad_worst"]
                                         for r in ranks],
           "params_after_step3": [r["params_after_step3"] for r in ranks],
           "flash_fwd_route_launches": ranks[0]["flash_fwd_route_launches"],
           "flash_bwd_route_launches": ranks[0]["flash_bwd_route_launches"],
           "replicated_equal_bit_for_bit": [r["replicated_equal"]
                                            for r in ranks]}
    emit(rec)
    for r in ranks:
        rel = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], one))
        check(rel <= MP2_TOL, f"mp2_gloo_on_card: mp rank {r['mp_rank']} "
                              f"losses {r['losses']} vs mp 1 {one}")
        check(r["step1_grad_worst"][0] <= MP2_TOL,
              f"mp2_gloo_on_card: step 1's gradient shard of "
              f"{r['step1_grad_worst'][1]} off by "
              f"{r['step1_grad_worst'][0]} of its largest")
        check(r["params_after_step3"]["ok"],
              f"mp2_gloo_on_card: mp rank {r['mp_rank']}'s shards after "
              f"step {MP2_STEPS}: {r['params_after_step3']}")
        check(r["replicated_equal"], "mp2_gloo_on_card: the replicated "
                                     "parameters differ between ranks")
        check(r["flash_fwd_route_launches"]["cuda_core"]
              == MP2_LAYERS * MP2_STEPS,
              f"mp2_gloo_on_card: flash launches "
              f"{r['flash_fwd_route_launches']}")
    return rec


# mp2_overlap_gloo_on_card's lanes: (sequence_parallel, mp_overlap,
# mp_activation_compress) in one spawned world, mp2_gloo_on_card's model,
# batch, lr and steps
MP2_OVERLAP_LANES = {"sp": (True, False, None),
                     "overlap": (False, True, None),
                     "overlap_bf16": (False, True, "bf16"),
                     "overlap_int8": (False, True, "int8"),
                     "sp_overlap": (True, True, None)}
MP2_OVERLAP_CHUNKS = 4
# the codec lanes against the exact ring lane, relative, at each of the
# three steps, and more than MOE_DIST_CODEC_FLOOR away at some step. Step
# 1 carries the forward wire's error alone, within 1e-4 (the MoE codec
# lanes' rule); the gap grows with training whichever wire carries the
# error: on an H100 80GB HBM3 at 700 W the int8 lane read 6.6e-6, 7.8e-5
# and 3.3e-4, and 6.6e-6, 8.7e-5 and 2.7e-4 with the backward rings on
# the exact wire. The limits of steps 2 and 3 lie between those readings
# and what the lane read with the backward rings' int8 codes truncated
# instead of rounded, 2.3e-4 and 4.1e-4 (PERF.md, PR 27)
MP2_CODEC_RTOLS = (1e-4, 1.4e-4, 3.7e-4)
# the rings' bytes a rank a step, as encoded, reckoned from the
# reference's overlap_wire_plan for mp2's 15 column / row calls of
# 2,097,152 values, 2 rings of 1 hop each
MP2_OVERLAP_WIRE = {"overlap": 251658240, "overlap_bf16": 125829120,
                    "overlap_int8": 63897600}


def _mp2_overlap_rank(tmpdir, one_dir, seed, ids, labels):
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    os.environ["PADDLE_COMM_TIMEOUT"] = str(DIST_COMM_TIMEOUT_S)
    try:
        import gc
        import torch
        import paddle_tpu_torch.distributed as dist
        from paddle_tpu_torch import (AdamW, LlamaPretrainingCriterion,
                                      TrainStep)
        from paddle_tpu_torch.convert import tp_shard
        from paddle_tpu_torch.distributed.fleet.meta_parallel import (
            collective_matmul as cm)
        from paddle_tpu_torch.kernels.flash_attention import (
            _flash_bhsd, _flash_bhsd_bwd)
        dist.init_parallel_env(backend="gloo")
        _probe_gloo_cuda(torch, os.path.join(tmpdir, f"rank{rank}.probe"))
        _f32_no_tf32(torch)
        x, y = (torch.as_tensor(a, device="cuda") for a in (ids, labels))
        ref = torch.load(os.path.join(one_dir, "mp1_params.pt"), mmap=True)
        out = {}
        for lane, (sp, overlap, comp) in MP2_OVERLAP_LANES.items():
            knobs = {"mp_overlap": overlap, "mp_activation_compress": comp,
                     "mp_overlap_chunks": MP2_OVERLAP_CHUNKS if overlap
                     else "auto"}
            fleet = _fleet_init(torch, mp_degree=2, backend="gloo",
                                knobs=knobs)
            mr = fleet.get_hybrid_communicate_group() \
                .get_model_parallel_rank()
            cfg = _mp2_config(True)
            cfg.sequence_parallel = sp
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            model = fleet.distributed_model(build_model(torch, cfg, seed))
            crit = LlamaPretrainingCriterion(cfg)
            opt = fleet.distributed_optimizer(AdamW(
                learning_rate=MP2_LR, parameters=model.parameters()))
            step = TrainStep(model, lambda lo, la: crit(lo, la), opt)
            zero_flash_counts(_flash_bhsd, _flash_bhsd_bwd)
            cm.reset_counters()
            losses, times = [], []
            for _ in range(MP2_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(step((x,), (y,)).item())
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            gap = _param_gap(
                torch, ref,
                {k: p.detach() for k, p in model.named_parameters()},
                MP2_LR * MP2_STEPS,
                lambda k, full, mr=mr: tp_shard(k, full, mr, 2))
            c = cm.counters
            out[lane] = {
                "mp_rank": mr, "losses": losses, "step_s": times,
                "params_after_step3": gap,
                "posted_wire_bytes_per_step": {
                    k: v // MP2_STEPS
                    for k, v in c["posted_wire_bytes"].items() if v},
                "plan_wire_bytes_per_step": {
                    k: v // MP2_STEPS for k, v in
                    c["paddle_tpu_mp_overlap_compressed_bytes_total"].items()
                    if v},
                "plan_logical_bytes_per_step": {
                    k: v // MP2_STEPS for k, v in
                    c["paddle_tpu_mp_overlap_bytes_total"].items() if v},
                "chunks": {k: v for k, v in
                           c["paddle_tpu_mp_overlap_chunks_total"].items()
                           if v},
                "flash_fwd_route_launches": dict(_flash_bhsd.route_launches),
                "peak_device_bytes": torch.cuda.max_memory_allocated()}
            del model, step, opt
            gc.collect()
            torch.cuda.empty_cache()
        _rank_done(tmpdir, rank, out)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        _rank_failed(tmpdir, rank)
        raise


def mp2_overlap_gloo_on_card_phase(torch, np, seed, tmpdir, one_dir, mp2):
    """mp2_gloo_on_card's world and configuration (two gloo ranks on
    cuda:0, Llama at Llama-2-7B widths, 2 layers, float32 with TF32 off,
    2 x 512, AdamW lr 1e-5, 3 steps) in five lanes of one spawned world:
    "sp" (sequence_parallel, the collectives whole), "overlap" (mp_overlap:
    the column / row permute rings, 4 chunks a hop, exact wire),
    "overlap_bf16", "overlap_int8" (mp_activation_compress) and
    "sp_overlap" (the column_sp / row_sp rings). The exact lanes are held
    to mp2_gloo_on_card's one process (``mp2``, whose parameters after
    step 3 lie in ``one_dir``): every loss within 1e-5 relative, the
    shards after step 3 by PARAM_FRAC's rule. The codec lanes are held to
    the "overlap" lane: the losses of steps 1-3 within 1e-4, 1.4e-4 and
    3.7e-4, and more than 1e-6 from it at some step. The
    bytes the rings posted a rank a step, as encoded, must equal the sum
    of overlap_wire_plan over the step's calls (the counters add each
    call's plan), and for the three column / row lanes the figures
    reckoned from the reference's plan. Gloo moves the wire through host
    memory, where a send waits for its block: the s/step are gloo's host
    wire, no NCCL figure, and show no overlap."""
    cfg = _mp2_config(False)
    rng = np.random.default_rng(seed + 3)
    ids = rng.integers(0, cfg.vocab_size, (MP2_BATCH, MP2_SEQ))
    labels = rng.integers(0, cfg.vocab_size, (MP2_BATCH, MP2_SEQ))
    ranks = _spawn_world(_mp2_overlap_rank, (one_dir, seed, ids, labels),
                         tmpdir, "mp2_overlap_gloo_on_card")
    one = mp2["mp1_losses"]
    lanes = {}
    for lane, (sp, overlap, comp) in MP2_OVERLAP_LANES.items():
        rs = [r[lane] for r in ranks]
        lanes[lane] = {
            "sequence_parallel": sp, "mp_overlap": overlap,
            "mp_activation_compress": comp,
            "losses": [r["losses"] for r in rs],
            "step_s": [r["step_s"] for r in rs],
            "posted_wire_bytes_per_step": [r["posted_wire_bytes_per_step"]
                                           for r in rs],
            "plan_wire_bytes_per_step": [r["plan_wire_bytes_per_step"]
                                         for r in rs],
            "plan_logical_bytes_per_step": rs[0]["plan_logical_bytes_per_step"],
            "chunks": rs[0]["chunks"],
            "params_after_step3": [r["params_after_step3"] for r in rs],
            "flash_fwd_route_launches": rs[0]["flash_fwd_route_launches"],
            "peak_device_bytes": [r["peak_device_bytes"] for r in rs]}
    exact = lanes["overlap"]["losses"][0]
    rec = {"phase": "mp2_overlap_gloo_on_card", "card": card_line(),
           "note": "two ranks on one card over gloo: the rings' hops and "
                   "the collectives go through host memory (a send copies "
                   "its block there first), so nothing overlaps; the s/step "
                   "are gloo's host wire, no NCCL figure",
           "model": "Llama, Llama-2-7B widths, float32, TF32 off",
           "layers": MP2_LAYERS, "batch": [MP2_BATCH, MP2_SEQ],
           "lr": MP2_LR, "steps": MP2_STEPS, "chunks": MP2_OVERLAP_CHUNKS,
           "mp1_losses": one, "mp1_step_s": mp2["mp1_step_s"],
           "reckoned_wire_bytes_per_step": MP2_OVERLAP_WIRE, "lanes": lanes}
    emit(rec)
    for lane, l in lanes.items():
        comp = l["mp_activation_compress"]
        for mr, losses in enumerate(l["losses"]):
            if comp is None:
                rel = max(abs(a - b) / abs(b) for a, b in zip(losses, one))
                check(rel <= MP2_TOL, f"mp2_overlap_gloo_on_card {lane}: "
                                      f"losses {losses} vs mp 1 {one}")
                check(l["params_after_step3"][mr]["ok"],
                      f"mp2_overlap_gloo_on_card {lane}: shards after step "
                      f"{MP2_STEPS}: {l['params_after_step3'][mr]}")
            else:
                gaps = [abs(a - b) / abs(b) for a, b in zip(losses, exact)]
                check(len(gaps) == len(MP2_CODEC_RTOLS)
                      and all(g <= t for g, t in zip(gaps, MP2_CODEC_RTOLS))
                      and max(gaps) > MOE_DIST_CODEC_FLOOR,
                      f"mp2_overlap_gloo_on_card {lane}: losses {losses} "
                      f"vs the exact ring lane {exact} (gaps {gaps})")
        check(l["flash_fwd_route_launches"]["cuda_core"]
              == MP2_LAYERS * MP2_STEPS,
              f"mp2_overlap_gloo_on_card {lane}: flash launches "
              f"{l['flash_fwd_route_launches']}")
        posted, plan = l["posted_wire_bytes_per_step"], \
            l["plan_wire_bytes_per_step"]
        check(posted == plan, f"mp2_overlap_gloo_on_card {lane}: posted "
                              f"{posted} vs the plan {plan}")
        if l["mp_overlap"]:
            kinds = {"column_sp", "row_sp", "column"} if l[
                "sequence_parallel"] else {"column", "row"}
            check(set(posted[0]) == kinds,
                  f"mp2_overlap_gloo_on_card {lane}: ring kinds "
                  f"{sorted(posted[0])}, want {sorted(kinds)}")
        else:
            check(posted[0] == {}, f"mp2_overlap_gloo_on_card {lane}: "
                                   f"rings posted {posted[0]}")
        if lane in MP2_OVERLAP_WIRE:
            check(all(sum(p.values()) == MP2_OVERLAP_WIRE[lane]
                      for p in posted),
                  f"mp2_overlap_gloo_on_card {lane}: {posted} a step, "
                  f"reckoned {MP2_OVERLAP_WIRE[lane]}")
    return rec


# -- phase 16c, pipeline parallelism -------------------------------------------

PP_STEPS = 2
PP2_BATCH, PP2_SEQ, PP2_MICRO = 4, 512, 4
PP2_LR = 1e-5                    # as mp2: the 7B-wide model's losses stay O(1)
PP2_GPT_LR = 1e-4
# GPT's tied wte: one process sums each microbatch's head and embedding
# gradients into one tensor in turn, the two stages sum their own and
# then the pair; past step 1 the float32 losses part by rounding
PP2_GPT_TOL = 1e-5
PP2MP2_LR = 1e-4
PP2MP2_TOL = 1e-2                # bf16: mp's partial sums round apart
PP_COMM_TIMEOUT_S = 120          # a deadlocked receive fails within this
PP_DEADLINE_S = 420              # a spawned pipeline world's join


def _pp_llama_config(dtype, **kw):
    from paddle_tpu_torch.models.llama import LlamaConfig
    return LlamaConfig(vocab_size=32000, hidden_size=4096,
                       intermediate_size=11008, num_hidden_layers=4,
                       num_attention_heads=32, num_key_value_heads=32,
                       max_position_embeddings=PP2_SEQ, dtype=dtype,
                       pipeline_parallel=True, pp_microbatches=PP2_MICRO,
                       **kw)


def _pp_gpt2_config():
    return gpt2_config(dtype="float32", dropout=0.0, pipeline_parallel=True,
                       virtual_pp_degree=2, pp_microbatches=PP2_MICRO)


def _pp_steps(torch, model, step, x, y, steps):
    """(losses, s per step, the schedule's stats per step, host-staged
    bytes and calls per step)."""
    from paddle_tpu_torch.distributed.collective import p2p_host_staged
    inner = getattr(model, "_layers", model)
    losses, times, stats, staged = [], [], [], []
    for _ in range(steps):
        before = dict(p2p_host_staged)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step((x,), (y,)).item())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        stats.append(dict(inner.last_pipeline_stats))
        staged.append({k: p2p_host_staged[k] - before[k] for k in before})
    return losses, times, stats, staged


def train_pp1_nccl_phase(torch, np, seed, base):
    """The train phase's configuration built with pipeline_parallel=True
    under fleet.init(pp_degree=1) on NCCL at world 1: the stage holds every
    layer and TrainStep runs the 1F1B list of one stage. At
    pp_microbatches=1 its losses must be train's bit for bit with train's
    flash launches a step; then at the auto count (the largest divisor
    of the batch <= 2 pp: 2 microbatches of 3 x 2048), every microbatch
    launching the pair. s/step of both beside train's."""
    from paddle_tpu_torch import AdamW, LlamaPretrainingCriterion, TrainStep
    from paddle_tpu_torch.kernels.flash_attention import (_flash_bhsd,
                                                          _flash_bhsd_bwd)
    fleet = _fleet_init(torch, pp_degree=1)
    n = TRAIN_WARMUP + TRAIN_TIMED
    runs = {}
    for name, micro in (("pp_microbatches_1", 1), ("auto", None)):
        cfg = train_config()
        cfg.pipeline_parallel = True
        cfg.pp_microbatches = micro
        inner = build_model(torch, cfg, seed)
        model = fleet.distributed_model(inner)
        crit = LlamaPretrainingCriterion(cfg)
        opt = fleet.distributed_optimizer(
            AdamW(learning_rate=1e-4, parameters=model.parameters(),
                  moment_dtype="bfloat16"))
        step = TrainStep(model, lambda lo, la: crit(lo, la), opt)
        ids, labels = train_batch(torch, np, seed + 3, cfg.vocab_size,
                                  TRAIN_BATCH, TRAIN_SEQ)
        torch.cuda.synchronize()
        zero_flash_counts(_flash_bhsd, _flash_bhsd_bwd)
        losses = [step((ids,), (labels,)) for _ in range(TRAIN_WARMUP)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TRAIN_TIMED):
            losses.append(step((ids,), (labels,)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[name] = {
            "microbatches": inner.last_pipeline_stats["microbatches"],
            "wrapper": type(model).__name__,
            "s_per_step": wall / TRAIN_TIMED,
            "s_per_step_over_train": wall / TRAIN_TIMED / base["s_per_step"],
            "losses": [x.item() for x in losses],
            "flash_fwd_route_launches": dict(_flash_bhsd.route_launches),
            "flash_bwd_route_launches": dict(_flash_bhsd_bwd.route_launches)}
        del inner, model, step, opt
        torch.cuda.empty_cache()
    rec = {"phase": "train_pp1_nccl", "card": card_line(),
           "entry_points": ["fleet.init(pp_degree=1)",
                            "LlamaConfig(pipeline_parallel=True)",
                            "fleet.distributed_model",
                            "fleet.distributed_optimizer", "TrainStep"],
           "backend": "NCCL", "world_size": 1, "layers": TRAIN_LAYERS,
           "dtype": "bfloat16", "batch": [TRAIN_BATCH, TRAIN_SEQ],
           "warmup_steps": TRAIN_WARMUP, "timed_steps": TRAIN_TIMED,
           "train_s_per_step": base["s_per_step"], "runs": runs}
    emit(rec)
    one, auto = runs["pp_microbatches_1"], runs["auto"]
    check(one["losses"] == base["losses"],
          f"train_pp1_nccl: losses {one['losses']} are not train's "
          f"{base['losses']} bit for bit")
    check(auto["microbatches"] == 2,
          f"train_pp1_nccl: the auto count gave {auto['microbatches']}")
    check(all(math.isfinite(x) for x in auto["losses"]),
          f"train_pp1_nccl: non-finite auto losses {auto['losses']}")
    for r in (one, auto):
        want = TRAIN_LAYERS * n * r["microbatches"]
        check(r["flash_fwd_route_launches"]["wgmma"] == want
              and r["flash_bwd_route_launches"]["wgmma"] == want,
              f"train_pp1_nccl: flash launches {r['flash_fwd_route_launches']}"
              f", {r['flash_bwd_route_launches']} (want {want} each)")
    return rec


def _pp_llama_run(torch, cfg, seed, x, y, lr, steps):
    from paddle_tpu_torch import AdamW, LlamaPretrainingCriterion, TrainStep
    model = build_model(torch, cfg, seed)
    crit = LlamaPretrainingCriterion(cfg)
    step = TrainStep(model, lambda lo, la: crit(lo, la),
                     AdamW(learning_rate=lr, parameters=model.parameters()))
    model.pipeline_timed = True
    return model, _pp_steps(torch, model, step, x, y, steps)


def _pp_gpt2_run(torch, seed, x, y, steps):
    from paddle_tpu_torch import AdamW, GPTForCausalLM, TrainStep
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    model = GPTForCausalLM(_pp_gpt2_config(), generator=gen)
    step = TrainStep(model, gpt2_loss,
                     AdamW(learning_rate=PP2_GPT_LR,
                           parameters=model.parameters()))
    model.pipeline_timed = True
    return model, _pp_steps(torch, model, step, x, y, steps)


def _pp_record(run):
    losses, times, stats, staged = run
    return {"losses": losses, "step_s": times, "stats": stats,
            "host_staged": staged}


def _pp2_rank(tmpdir, seed, data):
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    os.environ["PADDLE_COMM_TIMEOUT"] = str(PP_COMM_TIMEOUT_S)
    try:
        import pickle
        import torch
        import paddle_tpu_torch.distributed as dist
        from paddle_tpu_torch.kernels.flash_attention import (
            _flash_bhsd, _flash_bhsd_bwd)
        dist.init_parallel_env(backend="gloo")
        _probe_gloo_cuda(torch, os.path.join(tmpdir, f"rank{rank}.probe"))
        _f32_no_tf32(torch)
        _fleet_init(torch, backend="gloo", pp_degree=2)
        with open(os.path.join(tmpdir, "pp1_sums.pkl"), "rb") as f:
            ref_sums = pickle.load(f)
        res = {}
        for fam in ("llama", "gpt2"):
            x, y = (torch.as_tensor(a, device="cuda") for a in data[fam])
            zero_flash_counts(_flash_bhsd, _flash_bhsd_bwd)
            if fam == "llama":
                model, run = _pp_llama_run(torch, _pp_llama_config("float32"),
                                           seed, x, y, PP2_LR, PP_STEPS)
                bound = PP2_LR * PP_STEPS
            else:
                model, run = _pp_gpt2_run(torch, seed + 1, x, y, PP_STEPS)
                bound = PP2_GPT_LR * PP_STEPS
            named = dict(model.named_parameters())
            sums = dict(zip(sorted(named), _param_checksums(
                torch, named.items())))
            ref = torch.load(os.path.join(tmpdir, f"pp1_{fam}.pt"),
                             mmap=True)
            res[fam] = dict(
                _pp_record(run), stage=model._pp_stack()._stage,
                params_bit_for_bit=all(ref_sums[fam][k] == v
                                       for k, v in sums.items()),
                params_after=_param_gap(
                    torch, ref, {k: p.detach() for k, p in named.items()},
                    bound),
                tied=None if model._pp_tied() is None
                else _param_checksums(torch, [("t", model._pp_tied())]),
                params_per_rank=sum(p.numel() for p in named.values()),
                flash_fwd_route_launches=dict(_flash_bhsd.route_launches),
                flash_bwd_route_launches=dict(_flash_bhsd_bwd.route_launches))
            del model, ref
            torch.cuda.empty_cache()
        dist.barrier()
        _rank_done(tmpdir, rank, res)
        dist.destroy_process_group()
    except BaseException:
        _rank_failed(tmpdir, rank)
        raise


def pp2_gloo_on_card_phase(torch, np, seed, tmpdir):
    """Pipeline parallelism in two ranks on cuda:0 over gloo (one card:
    NCCL takes one rank a device), float32 with TF32 off: Llama at
    Llama-2-7B widths cut to 4 layers (depth only), batch 4 x 512, 4
    microbatches, 1F1B; then GPT-2 124M (benchmarks/gpt2_dp.py's widths,
    12 layers, dropout 0, tied wte) at virtual_pp_degree 2, batch 8 x
    1024, 4 microbatches, interleaved. Each rank draws
    the one-process weights from the seed and keeps its stage;
    stage-to-stage messages go through the port's host staging. Each is
    held to one process (pp 1, the same microbatches in the same order):
    Llama's losses and parameters after step 2 bit for bit; GPT's step-1
    loss bit for bit and later losses within 1e-5 relative (its tied
    wte's gradients add in another order), its parameters by
    PARAM_FRAC's rule. Printed: s/step, stage-to-stage bytes a step, the
    host-staged bytes and calls, and each rank's receive wait (its idle
    time between instructions, the device drained first)."""
    import pickle
    _f32_no_tf32(torch)
    _fleet_init(torch, pp_degree=1)
    rng = np.random.default_rng(seed + 3)
    lcfg = _pp_llama_config("float32")
    gcfg = _pp_gpt2_config()
    data = {"llama": (rng.integers(0, lcfg.vocab_size, (PP2_BATCH, PP2_SEQ)),
                      rng.integers(0, lcfg.vocab_size, (PP2_BATCH, PP2_SEQ))),
            "gpt2": (rng.integers(0, gcfg.vocab_size, (GPT2_BATCH, GPT2_SEQ)),
                     rng.integers(0, gcfg.vocab_size, (GPT2_BATCH, GPT2_SEQ)))}
    one, sums = {}, {}
    for fam in ("llama", "gpt2"):
        x, y = (torch.as_tensor(a, device="cuda") for a in data[fam])
        if fam == "llama":
            model, run = _pp_llama_run(torch, lcfg, seed, x, y, PP2_LR,
                                       PP_STEPS)
        else:
            model, run = _pp_gpt2_run(torch, seed + 1, x, y, PP_STEPS)
        one[fam] = dict(_pp_record(run),
                        params=sum(p.numel() for p in model.parameters()))
        named = dict(model.named_parameters())
        sums[fam] = dict(zip(sorted(named),
                             _param_checksums(torch, named.items())))
        torch.save({k: p.detach().cpu() for k, p in named.items()},
                   os.path.join(tmpdir, f"pp1_{fam}.pt"))
        del model, named
        torch.cuda.empty_cache()
    with open(os.path.join(tmpdir, "pp1_sums.pkl"), "wb") as f:
        pickle.dump(sums, f)
    ranks = _spawn_world(_pp2_rank, (seed, data), tmpdir,
                         "pp2_gloo_on_card", n=2, deadline=PP_DEADLINE_S)
    rec = {"phase": "pp2_gloo_on_card", "card": card_line(),
           "note": "two ranks on one card over gloo: stage-to-stage "
                   "messages through host memory, the ranks time-sliced "
                   "on the card; no NVLink figure",
           "steps": PP_STEPS, "dtype": "float32, TF32 off"}
    for fam, desc in (("llama", "Llama-2-7B widths, 4 layers, 4 x 512, "
                                "4 microbatches, 1F1B, lr 1e-5"),
                      ("gpt2", "GPT-2 124M, 12 layers, 8 x 1024, vpp 2, "
                               "4 microbatches, lr 1e-4")):
        rec[fam] = {
            "model": desc, "one_process": one[fam],
            "ranks": [dict(r[fam], params_after=r[fam]["params_after"])
                      for r in ranks],
            "s_per_step_over_one_process": [
                r[fam]["step_s"][-1] / one[fam]["step_s"][-1]
                for r in ranks]}
    emit(rec)
    for fam in ("llama", "gpt2"):
        want = one[fam]["losses"]
        for r in ranks:
            got = r[fam]["losses"]
            check(r[fam]["stats"][0]["p2p_bytes"] > 0,
                  f"pp2_gloo_on_card {fam}: stage {r[fam]['stage']} sent "
                  f"nothing")
            check(all(st["calls"] > 0 for st in r[fam]["host_staged"]),
                  f"pp2_gloo_on_card {fam}: no host-staged transfer")
            if fam == "llama":
                check(got == want, f"pp2_gloo_on_card llama: losses {got} "
                                   f"are not one process's {want} bit for bit")
                check(r[fam]["params_bit_for_bit"],
                      f"pp2_gloo_on_card llama: stage {r[fam]['stage']}'s "
                      f"parameters after step {PP_STEPS} differ from one "
                      f"process's: {r[fam]['params_after']}")
            else:
                check(got[0] == want[0], f"pp2_gloo_on_card gpt2: step-1 "
                                         f"loss {got[0]} is not {want[0]}")
                rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
                check(rel <= PP2_GPT_TOL, f"pp2_gloo_on_card gpt2: losses "
                                          f"{got} vs one process {want}")
                check(r[fam]["params_after"]["ok"],
                      f"pp2_gloo_on_card gpt2: stage {r[fam]['stage']}'s "
                      f"parameters: {r[fam]['params_after']}")
    check(ranks[0]["gpt2"]["tied"] == ranks[1]["gpt2"]["tied"],
          "pp2_gloo_on_card gpt2: the two stages' wte differ")
    return rec


def _pp2mp2_rank(tmpdir, seed, ids, labels):
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    os.environ["PADDLE_COMM_TIMEOUT"] = str(PP_COMM_TIMEOUT_S)
    try:
        import torch
        import paddle_tpu_torch.distributed as dist
        from paddle_tpu_torch.kernels.flash_attention import (
            _flash_bhsd, _flash_bhsd_bwd)
        dist.init_parallel_env(backend="gloo")
        _probe_gloo_cuda(torch, os.path.join(tmpdir, f"rank{rank}.probe"))
        fleet = _fleet_init(torch, backend="gloo", pp_degree=2, mp_degree=2)
        hcg = fleet.get_hybrid_communicate_group()
        x, y = (torch.as_tensor(a, device="cuda") for a in (ids, labels))
        zero_flash_counts(_flash_bhsd, _flash_bhsd_bwd)
        model, run = _pp_llama_run(
            torch, _pp_llama_config("bfloat16", tensor_parallel=True), seed,
            x, y, PP2MP2_LR, PP_STEPS)
        _rank_done(tmpdir, rank, dict(
            _pp_record(run), stage=hcg.get_stage_id(),
            mp_rank=hcg.get_model_parallel_rank(),
            params_per_rank=sum(p.numel() for p in model.parameters()),
            flash_fwd_route_launches=dict(_flash_bhsd.route_launches),
            flash_bwd_route_launches=dict(_flash_bhsd_bwd.route_launches)))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        _rank_failed(tmpdir, rank)
        raise


def pp2mp2_gloo_on_card_phase(torch, np, seed, tmpdir):
    """BASELINE configuration 3's mp x pp: four gloo ranks on cuda:0 (pp 2
    x mp 2), Llama at Llama-2-7B widths cut to 4 layers, bf16, batch 4 x
    512, 4 microbatches, AdamW lr 1e-4, 2 steps: every rank's losses
    within 1e-2 relative of one process running the same model at pp 1,
    mp 1 (bf16: the row-parallel partial sums round apart), and each
    stage's attention on the wgmma flash pair at D 128 (route_launches:
    2 layers x 4 microbatches a step, forward and backward, none on
    another route). s/step printed."""
    _fleet_init(torch, pp_degree=1)
    rng = np.random.default_rng(seed + 3)
    cfg = _pp_llama_config("bfloat16")
    ids = rng.integers(0, cfg.vocab_size, (PP2_BATCH, PP2_SEQ))
    labels = rng.integers(0, cfg.vocab_size, (PP2_BATCH, PP2_SEQ))
    x, y = (torch.as_tensor(a, device="cuda") for a in (ids, labels))
    model, run = _pp_llama_run(torch, cfg, seed, x, y, PP2MP2_LR, PP_STEPS)
    one = _pp_record(run)
    del model
    torch.cuda.empty_cache()
    ranks = _spawn_world(_pp2mp2_rank, (seed, ids, labels), tmpdir,
                         "pp2mp2_gloo_on_card", n=4, deadline=PP_DEADLINE_S)
    rec = {"phase": "pp2mp2_gloo_on_card", "card": card_line(),
           "note": "four ranks on one card over gloo: the mp all-reduces "
                   "and the stage-to-stage messages through host memory; "
                   "no NVLink figure",
           "model": "Llama, Llama-2-7B widths, 4 layers, bf16, 4 x 512, "
                    "4 microbatches, pp 2 x mp 2",
           "steps": PP_STEPS, "one_process": one, "ranks": ranks,
           "s_per_step_over_one_process": [
               r["step_s"][-1] / one["step_s"][-1] for r in ranks]}
    emit(rec)
    want_launches = 2 * PP2_MICRO * PP_STEPS
    for r in ranks:
        rel = max(abs(a - b) / abs(b) for a, b in zip(r["losses"],
                                                      one["losses"]))
        check(rel <= PP2MP2_TOL, f"pp2mp2_gloo_on_card: rank (stage "
                                 f"{r['stage']}, mp {r['mp_rank']}) losses "
                                 f"{r['losses']} vs one process "
                                 f"{one['losses']}")
        fwd, bwd = r["flash_fwd_route_launches"], r["flash_bwd_route_launches"]
        check(fwd.get("wgmma") == want_launches == sum(fwd.values())
              and bwd.get("wgmma") == want_launches == sum(bwd.values()),
              f"pp2mp2_gloo_on_card: flash launches {fwd}, {bwd} (want "
              f"{want_launches} wgmma each)")
    return rec


# -- configuration 4 across ranks: ZeRO stages and expert parallelism -------
MOE_DIST_STEPS = 3
MOE_DIST_LAYERS = 6              # train_moe's depth (the cut a limit allows)
MOE_DIST_LR = 1e-4               # train_moe's AdamW
MOE_DIST_BATCH, MOE_DIST_SEQ = 8, 1024
# float32 exact wires: the sums run in other orders (the gates draw their
# random numbers for the whole batch, so the routes are one process's)
MOE_DIST_LOSS_RTOL = 1e-5
# the codecs round every exchanged activation (bf16: 2^-9 relative; int8:
# blockmax / 254), twice a layer each way; the loss averages 8192 tokens,
# and the card showed 1.5e-5 (bf16) and 1.2e-5 (int8)
MOE_DIST_CODEC_RTOL = 1e-4
# a codec lane's losses must depart from the exact lane's by more than
# this (relative, at some step): a lane that skipped its codec would give
# the exact lane's losses bit for bit, and the exact lane sits 1e-7 from
# one process
MOE_DIST_CODEC_FLOOR = 1e-6
EP2_LANES = {"grouped": ("grouped", None), "grouped_bf16": ("grouped", "bf16"),
             "grouped_int8": ("grouped", "int8"),
             "capacity": ("capacity", None)}
ZERO_LEVELS = ("os", "os_g", "p_g_os")


def _moe_steps(torch, step, x, y, steps=MOE_DIST_STEPS):
    """(losses, s per step) of ``steps`` TrainStep calls, each timed to
    the card's end."""
    losses, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step((x,), (y,)).item())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return losses, times


def _grouped_launches(torch):
    from paddle_tpu_torch.kernels.grouped_matmul import (grouped_matmul_dw,
                                                         grouped_matmul_fwd)
    return {"fwd": grouped_matmul_fwd.launches,
            "dw": grouped_matmul_dw.launches,
            "fwd_routes": dict(grouped_matmul_fwd.route_launches),
            "dw_routes": dict(grouped_matmul_dw.route_launches)}


def _zero_grouped_counts():
    from paddle_tpu_torch.kernels.grouped_matmul import (grouped_matmul_dw,
                                                         grouped_matmul_fwd)
    zero_flash_counts(grouped_matmul_fwd, grouped_matmul_dw)


def _check_grouped_wgmma(phase, launches, layers, steps):
    """Every grouped launch of the path on the tensor cores: 4 forward-
    kernel launches (up, down and their input gradients) and 2 dw
    launches a layer a step."""
    fwd, dw = launches["fwd_routes"], launches["dw_routes"]
    check(launches["fwd"] == 4 * layers * steps == fwd.get("wgmma")
          and launches["dw"] == 2 * layers * steps == dw.get("wgmma"),
          f"{phase}: grouped launches {launches} (want {4 * layers * steps} "
          f"and {2 * layers * steps}, every one wgmma)")


def _moe_one_process(torch, np, seed, dispatch, layers=MOE_DIST_LAYERS):
    """train_moe's procedure (the GPT-MoE at full width, float32, TF32 off,
    AdamW lr 1e-4, the batch of 8 x 1024 ids from the seed) for
    MOE_DIST_STEPS steps on one process: the reference of the phases
    below."""
    from paddle_tpu_torch import AdamW, TrainStep
    from paddle_tpu_torch.models.gpt_moe import moe_loss
    _f32_no_tf32(torch)
    model = moe_model(torch, seed, dispatch_mode=dispatch, num_layers=layers)
    step = TrainStep(model, moe_loss, AdamW(learning_rate=MOE_DIST_LR,
                                            parameters=model.parameters()))
    x, y = train_batch(torch, np, seed, model.config.vocab_size,
                       MOE_DIST_BATCH, MOE_DIST_SEQ)
    torch.cuda.reset_peak_memory_stats()
    losses, times = _moe_steps(torch, step, x, y)
    rec = {"losses": losses, "step_s": times,
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "expert_bytes": sum(p.numel() * p.element_size()
                               for blk in model.blocks
                               for p in blk.moe.experts.parameters()),
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in model.parameters()),
           "layers": model.config.num_layers}
    del model, step
    torch.cuda.empty_cache()
    return rec


def train_moe_stage2_nccl_phase(torch, np, seed, base=None,
                                layers=MOE_DIST_LAYERS):
    """Configuration 4 as benchmarks/gpt_moe_ep.py:102-128 composes it, at
    world 1 on NCCL: train_moe's model, batch and AdamW, through
    fleet.init (every degree 1), distributed_model and distributed_optimizer
    over GroupShardedOptimizerStage2, under TrainStep, in both lanes
    (grouped, capacity); then group_sharded_parallel at "os", "os_g" and
    "p_g_os" (grouped). Each run's 3 losses equal one process's plain
    AdamW run bit for bit (and train_moe's first 3 when it ran), every
    grouped launch on the wgmma route. Returns the one-process runs (the
    gloo phases' references)."""
    from paddle_tpu_torch import AdamW, TrainStep
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        GroupShardedOptimizerStage2)
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.models.gpt_moe import moe_loss
    one = {lane: _moe_one_process(torch, np, seed, lane, layers)
           for lane in ("grouped", "capacity")}
    runs = {}
    for name in ("grouped", "capacity") + ZERO_LEVELS:
        lane = name if name in ("grouped", "capacity") else "grouped"
        fleet = _fleet_init(torch)
        model = moe_model(torch, seed, dispatch_mode=lane, num_layers=layers)
        x, y = train_batch(torch, np, seed, model.config.vocab_size,
                           MOE_DIST_BATCH, MOE_DIST_SEQ)
        opt = AdamW(learning_rate=MOE_DIST_LR, parameters=model.parameters())
        if name in ("grouped", "capacity"):
            wrapped = fleet.distributed_model(model)
            sopt = fleet.distributed_optimizer(
                GroupShardedOptimizerStage2(optim=opt))
        else:
            wrapped, sopt, _ = group_sharded_parallel(model, opt, name)
        step = TrainStep(wrapped, moe_loss, sopt)
        _zero_grouped_counts()
        losses, times = _moe_steps(torch, step, x, y)
        launches = _grouped_launches(torch)
        runs[name] = {"wrapper": type(wrapped).__name__,
                      "optimizer": type(step.opt).__name__,
                      "losses": losses, "step_s": times,
                      "one_process_step_s": one[lane]["step_s"],
                      "bit_for_bit": losses == one[lane]["losses"],
                      "grouped_launches": launches}
        if lane == "grouped":
            _check_grouped_wgmma(f"train_moe_stage2_nccl {name}", launches,
                                 layers, MOE_DIST_STEPS)
        del model, wrapped, step, opt, sopt
        torch.cuda.empty_cache()
    base_losses = base["losses"][:MOE_DIST_STEPS] \
        if base and base["layers"] == layers else None
    rec = {"phase": "train_moe_stage2_nccl", "card": card_line(),
           "backend": "NCCL", "world_size": 1,
           "model": "benchmarks/gpt_moe_ep.py GPT-MoE at its chip widths, "
                    "random weights, float32, TF32 off",
           "batch": [MOE_DIST_BATCH, MOE_DIST_SEQ], "steps": MOE_DIST_STEPS,
           "one_process": one, "train_moe_losses": base_losses,
           "runs": runs}
    emit(rec)
    for name, r in runs.items():
        check(r["bit_for_bit"], f"train_moe_stage2_nccl: {name} losses "
                                f"{r['losses']} differ from one process")
    if base_losses is not None:
        check(one["grouped"]["losses"] == base_losses,
              f"train_moe_stage2_nccl: one process {one['grouped']['losses']}"
              f" differs from train_moe {base_losses}")
    return one


def _moe_rank_start(tmpdir, rank):
    """A spawned rank of the MoE phases: gloo on cuda:0, the probe, TF32
    off; returns torch."""
    os.environ["PADDLE_COMM_TIMEOUT"] = str(DIST_COMM_TIMEOUT_S)
    import torch
    import paddle_tpu_torch.distributed as dist
    dist.init_parallel_env(backend="gloo")
    _probe_gloo_cuda(torch, os.path.join(tmpdir, f"rank{rank}.probe"))
    _f32_no_tf32(torch)
    return torch


def _rows(torch, a, part, n):
    per = a.shape[0] // n
    return torch.as_tensor(a[part * per:(part + 1) * per], device="cuda")


def _ep2_rank(tmpdir, seed, ids, labels, layers):
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    try:
        torch = _moe_rank_start(tmpdir, rank)
        import paddle_tpu_torch.distributed as dist
        from paddle_tpu_torch import AdamW, TrainStep
        from paddle_tpu_torch.incubate.distributed.models.moe.dispatch import (
            dispatch_wire_bytes, ep_all_to_all)
        from paddle_tpu_torch.models.gpt_moe import moe_loss
        x, y = _rows(torch, ids, rank, 2), _rows(torch, labels, rank, 2)
        res = {}
        for lane, (dispatch, compress) in EP2_LANES.items():
            fleet = _fleet_init(torch, backend="gloo", ep_degree=2,
                                dispatch_compress=compress)
            model = fleet.distributed_model(moe_model(
                torch, seed, dispatch_mode=dispatch, num_layers=layers))
            step = TrainStep(model, moe_loss, fleet.distributed_optimizer(
                AdamW(learning_rate=MOE_DIST_LR,
                      parameters=model.parameters())))
            _zero_grouped_counts()
            ep_all_to_all.counters.update(calls=0, wire_bytes=0)
            torch.cuda.reset_peak_memory_stats()
            losses, times = _moe_steps(torch, step, x, y)
            cap = x.numel() * 2                     # every local route
            res[lane] = {
                "losses": losses, "step_s": times,
                "peak_device_bytes": torch.cuda.max_memory_allocated(),
                "expert_bytes": sum(p.numel() * p.element_size()
                                    for p in model.parameters()
                                    if getattr(p, "expert", False)),
                "grouped_launches": _grouped_launches(torch),
                "exchange_calls_per_step":
                    ep_all_to_all.counters["calls"] / MOE_DIST_STEPS,
                "exchange_wire_bytes_per_step":
                    ep_all_to_all.counters["wire_bytes"] / MOE_DIST_STEPS,
                "dispatch_wire_bytes_per_step": 2 * layers *
                    dispatch_wire_bytes(2, cap, MOE_H, 4, compress)
                    if dispatch == "grouped" else 0,
                "layers": layers,
                "dense_sync_bytes_per_step": step._grad_sync.bytes_per_step}
            del model, step
            torch.cuda.empty_cache()
        dist.barrier()
        _rank_done(tmpdir, rank, res)
        dist.destroy_process_group()
    except BaseException:
        _rank_failed(tmpdir, rank)
        raise


def _loss_gaps(ranks, key, one, rtol):
    """The mean of the ranks' losses (each the mean over its rows: their
    mean is the batch's) against one process on the whole batch, each
    step's gap relative, and whether every gap is within ``rtol``."""
    mean = [sum(r[key]["losses"][i] for r in ranks) / len(ranks)
            for i in range(len(one["losses"]))]
    gaps = [abs(a - b) / abs(b) for a, b in zip(mean, one["losses"])]
    return {"losses_mean_of_ranks": mean,
            "one_process_losses": one["losses"],
            "one_process_step_s": one["step_s"], "rel_gaps": gaps,
            "loss_rtol": rtol, "ok": max(gaps) <= rtol}


def ep2_gloo_on_card_phase(torch, np, seed, tmpdir, one):
    """Expert parallelism in two gloo ranks on cuda:0 (ep 2, fleet.init
    and distributed_model: DataParallel over the data world, the experts'
    gradients summed over their replicas): train_moe's GPT-MoE at full
    width and depth (hidden 768, 12 heads, 8 experts of width 3072, vocab
    50257, 6 layers, float32, TF32 off), the batch of 8 x 1024 as 4 + 4
    rows, 3 steps in each lane: grouped with dispatch_compress None,
    "bf16" and "int8", and capacity. The mean of the ranks' losses against
    one process on the whole batch (exact lanes within 1e-5 relative, the
    codecs within 1e-4 and more than 1e-6 from the exact lane), each
    rank's expert bytes half of one process's,
    every grouped launch on the wgmma route, and the exchange's wire bytes
    a step (counted from the payload the codec encoded) equal to
    dispatch_wire_bytes' price. Gloo's CUDA collectives
    go through host memory and both ranks share the card: the times are
    printed as they are, no NVLink figure."""
    rng = np.random.default_rng(seed)
    vocab = 50257
    ids = rng.integers(0, vocab, (MOE_DIST_BATCH, MOE_DIST_SEQ))
    labels = rng.integers(0, vocab, (MOE_DIST_BATCH, MOE_DIST_SEQ))
    layers = one["grouped"]["layers"]
    ranks = _spawn_world(_ep2_rank, (seed, ids, labels, layers), tmpdir,
                         "ep2_gloo_on_card")
    lanes = {}
    for lane, (dispatch, compress) in EP2_LANES.items():
        lanes[lane] = {
            "dispatch": dispatch, "dispatch_compress": compress,
            **_loss_gaps(ranks, lane, one[dispatch],
                         MOE_DIST_CODEC_RTOL if compress
                         else MOE_DIST_LOSS_RTOL),
            "ranks": [r[lane] for r in ranks]}
    exact = lanes["grouped"]["losses_mean_of_ranks"]
    for lane, l in lanes.items():
        if l["dispatch_compress"]:
            l["departure_from_exact_lane"] = max(
                abs(a - b) / abs(b)
                for a, b in zip(l["losses_mean_of_ranks"], exact))
            l["departure_floor"] = MOE_DIST_CODEC_FLOOR
    rec = {"phase": "ep2_gloo_on_card", "card": card_line(),
           "note": "two ranks on one card over gloo: the exchange and the "
                   "gradient sync go through host memory; no NVLink figure",
           "model": f"train_moe's GPT-MoE, full width, {layers} layers, "
                    f"float32, TF32 off, ep 2",
           "global_batch": [MOE_DIST_BATCH, MOE_DIST_SEQ],
           "rank_batch": [MOE_DIST_BATCH // 2, MOE_DIST_SEQ],
           "steps": MOE_DIST_STEPS,
           "gloo_cuda_ops_probed": list(GLOO_CUDA_OPS), "lanes": lanes}
    emit(rec)
    for lane, l in lanes.items():
        check(l["ok"], f"ep2_gloo_on_card: {lane} losses "
                       f"{l['losses_mean_of_ranks']} vs one process "
                       f"{l['one_process_losses']}")
        if l["dispatch_compress"]:
            check(l["departure_from_exact_lane"] > MOE_DIST_CODEC_FLOOR,
                  f"ep2_gloo_on_card: {lane} departs "
                  f"{l['departure_from_exact_lane']} from the exact lane: "
                  f"its codec did not act")
        for r in l["ranks"]:
            check(2 * r["expert_bytes"] == one[l["dispatch"]]["expert_bytes"],
                  f"ep2_gloo_on_card: {lane} holds {r['expert_bytes']} "
                  f"expert bytes a rank")
            if l["dispatch"] == "grouped":
                _check_grouped_wgmma(f"ep2_gloo_on_card {lane}",
                                     r["grouped_launches"], r["layers"],
                                     MOE_DIST_STEPS)
                check(r["exchange_calls_per_step"] == 4 * r["layers"]
                      and r["exchange_wire_bytes_per_step"]
                      == r["dispatch_wire_bytes_per_step"],
                      f"ep2_gloo_on_card: {lane} exchange {r}")
    return rec


def _zero2_rank(tmpdir, seed, ids, labels, layers):
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    try:
        torch = _moe_rank_start(tmpdir, rank)
        import paddle_tpu_torch.distributed as dist
        from paddle_tpu_torch import AdamW, TrainStep
        from paddle_tpu_torch.distributed.fleet.meta_parallel.\
            sharding_optimizer import zero_state_bytes
        from paddle_tpu_torch.distributed.sharding import \
            group_sharded_parallel
        from paddle_tpu_torch.models.gpt_moe import moe_loss
        x, y = _rows(torch, ids, rank, 2), _rows(torch, labels, rank, 2)
        res = {}
        for level in ZERO_LEVELS:
            _fleet_init(torch, backend="gloo", sharding_degree=2)
            model = moe_model(torch, seed, dispatch_mode="grouped",
                              num_layers=layers)
            wrapped, sopt, _ = group_sharded_parallel(
                model, AdamW(learning_rate=MOE_DIST_LR,
                             parameters=model.parameters()), level)
            step = TrainStep(wrapped, moe_loss, sopt)
            _zero_grouped_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses, times = _moe_steps(torch, step, x, y)
            res[level] = {"losses": losses, "step_s": times,
                          "wrapper": type(wrapped).__name__,
                          "tensors": len(list(model.parameters())),
                          "state_bytes": zero_state_bytes(sopt, model),
                          "peak_device_bytes":
                              torch.cuda.max_memory_allocated(),
                          "grouped_launches": _grouped_launches(torch),
                          "layers": layers}
            del model, wrapped, step, sopt
            torch.cuda.empty_cache()
        dist.barrier()
        _rank_done(tmpdir, rank, res)
        dist.destroy_process_group()
    except BaseException:
        _rank_failed(tmpdir, rank)
        raise


def sharding2_gloo_on_card_phase(torch, np, seed, tmpdir, one):
    """ZeRO in two gloo ranks on cuda:0 (fleet.init(sharding_degree=2),
    group_sharded_parallel at "os", "os_g" and "p_g_os") on train_moe's
    GPT-MoE at full width and depth, 4 + 4 rows of the batch, 3 steps
    each: the mean of the ranks' losses against one process (1e-5
    relative), each rank's moment, gradient and at-rest parameter bytes
    (moments half of one process's at every stage, gradients half at
    stages 2 and 3, parameters half at stage 3, each to within a padded
    value a tensor), its peak device memory, every grouped launch on the
    wgmma route. Times as they are (gloo through host memory, one
    card)."""
    rng = np.random.default_rng(seed)
    vocab = 50257
    ids = rng.integers(0, vocab, (MOE_DIST_BATCH, MOE_DIST_SEQ))
    labels = rng.integers(0, vocab, (MOE_DIST_BATCH, MOE_DIST_SEQ))
    layers = one["grouped"]["layers"]
    ranks = _spawn_world(_zero2_rank, (seed, ids, labels, layers), tmpdir,
                         "sharding2_gloo_on_card")
    ref = one["grouped"]
    whole = ref["param_bytes"]
    levels = {}
    for level in ZERO_LEVELS:
        levels[level] = {**_loss_gaps(ranks, level, ref,
                                      MOE_DIST_LOSS_RTOL),
                         "ranks": [r[level] for r in ranks]}
    rec = {"phase": "sharding2_gloo_on_card", "card": card_line(),
           "note": "two ranks on one card over gloo: the reduce-scatters, "
                   "all-gathers and all-reduces go through host memory; no "
                   "NVLink figure",
           "model": f"train_moe's GPT-MoE, full width, {layers} layers, "
                    f"float32, TF32 off, sharding 2",
           "global_batch": [MOE_DIST_BATCH, MOE_DIST_SEQ],
           "steps": MOE_DIST_STEPS,
           "one_process": {"losses": ref["losses"],
                           "step_s": ref["step_s"],
                           "param_bytes": whole,
                           "moment_bytes": 2 * whole,
                           "peak_device_bytes": ref["peak_device_bytes"]},
           "levels": levels}
    emit(rec)
    for level, l in levels.items():
        check(l["ok"], f"sharding2_gloo_on_card: {level} losses "
                       f"{l['losses_mean_of_ranks']} vs one process "
                       f"{ref['losses']}")
        for r in l["ranks"]:
            b = r["state_bytes"]
            pad = 8 * r["tensors"]          # a padded value a tensor
            half = {"moments": abs(b["moments"] - whole) <= pad,
                    "grads": abs(b["grads"] - whole / 2) <= pad
                    if level != "os" else b["grads"] == whole,
                    "params": abs(b["params"] - whole / 2) <= pad
                    if level == "p_g_os" else b["params"] == whole}
            check(all(half.values()), f"sharding2_gloo_on_card: {level} "
                                      f"state bytes {b}: {half}")
            _check_grouped_wgmma(f"sharding2_gloo_on_card {level}",
                                 r["grouped_launches"], r["layers"],
                                 MOE_DIST_STEPS)
    return rec


def _ep2sh2_rank(tmpdir, seed, ids, labels, layers):
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    try:
        torch = _moe_rank_start(tmpdir, rank)
        import paddle_tpu_torch.distributed as dist
        from paddle_tpu_torch import AdamW, TrainStep
        from paddle_tpu_torch.distributed.fleet.meta_parallel import (
            GroupShardedOptimizerStage2)
        from paddle_tpu_torch.distributed.fleet.meta_parallel.\
            sharding_optimizer import zero_state_bytes
        from paddle_tpu_torch.models.gpt_moe import moe_loss
        fleet = _fleet_init(torch, backend="gloo", ep_degree=2,
                            sharding_degree=2)
        hcg = fleet.get_hybrid_communicate_group()
        part = hcg.get_data_world_group().rank
        x, y = _rows(torch, ids, part, 4), _rows(torch, labels, part, 4)
        model = moe_model(torch, seed, dispatch_mode="grouped",
                          num_layers=layers)
        opt = GroupShardedOptimizerStage2(optim=AdamW(
            learning_rate=MOE_DIST_LR, parameters=model.parameters()))
        step = TrainStep(model, moe_loss, opt)
        _zero_grouped_counts()
        torch.cuda.reset_peak_memory_stats()
        losses, times = _moe_steps(torch, step, x, y)
        res = {"cfg": {"losses": losses, "step_s": times,
                       "ep_rank": hcg.get_expert_parallel_rank(),
                       "sharding_rank": hcg.get_sharding_parallel_rank(),
                       "state_bytes": zero_state_bytes(opt, model),
                       "expert_bytes": sum(
                           p.numel() * p.element_size()
                           for p in model.parameters()
                           if getattr(p, "expert", False)),
                       "peak_device_bytes": torch.cuda.max_memory_allocated(),
                       "grouped_launches": _grouped_launches(torch),
                       "layers": layers}}
        dist.barrier()
        _rank_done(tmpdir, rank, res)
        dist.destroy_process_group()
    except BaseException:
        _rank_failed(tmpdir, rank)
        raise


def ep2sharding2_gloo_on_card_phase(torch, np, seed, tmpdir, one):
    """Configuration 4's composition in four gloo ranks on cuda:0:
    fleet.init(ep_degree=2, sharding_degree=2), train_moe's GPT-MoE at full
    width and depth built under it (each MoELayer takes fleet's ep group),
    GroupShardedOptimizerStage2 over AdamW under TrainStep
    (benchmarks/gpt_moe_ep.py:115-128), 2 rows of the batch a rank, 3
    steps: the mean of the ranks' losses against one process (1e-5
    relative), each rank's expert bytes half of one process's, every
    grouped launch on the wgmma route; state bytes and times as they are
    (gloo through host memory, four ranks time-sliced on one card)."""
    rng = np.random.default_rng(seed)
    vocab = 50257
    ids = rng.integers(0, vocab, (MOE_DIST_BATCH, MOE_DIST_SEQ))
    labels = rng.integers(0, vocab, (MOE_DIST_BATCH, MOE_DIST_SEQ))
    layers = one["grouped"]["layers"]
    ranks = _spawn_world(_ep2sh2_rank, (seed, ids, labels, layers), tmpdir,
                         "ep2sharding2_gloo_on_card", n=4)
    ref = one["grouped"]
    gaps = _loss_gaps(ranks, "cfg", ref, MOE_DIST_LOSS_RTOL)
    rec = {"phase": "ep2sharding2_gloo_on_card", "card": card_line(),
           "note": "four ranks on one card over gloo: the exchange, the "
                   "reduce-scatters and all-gathers through host memory; no "
                   "NVLink figure",
           "model": f"train_moe's GPT-MoE, full width, {layers} layers, "
                    f"float32, TF32 off, ep 2 x sharding 2, stage 2",
           "global_batch": [MOE_DIST_BATCH, MOE_DIST_SEQ],
           "rank_batch": [MOE_DIST_BATCH // 4, MOE_DIST_SEQ],
           "steps": MOE_DIST_STEPS, **gaps,
           "ranks": [r["cfg"] for r in ranks]}
    emit(rec)
    check(gaps["ok"], f"ep2sharding2_gloo_on_card: losses "
                      f"{gaps['losses_mean_of_ranks']} vs one process "
                      f"{ref['losses']}")
    for r in ranks:
        r = r["cfg"]
        check(2 * r["expert_bytes"] == ref["expert_bytes"],
              f"ep2sharding2_gloo_on_card: {r['expert_bytes']} expert bytes")
        _check_grouped_wgmma("ep2sharding2_gloo_on_card",
                             r["grouped_launches"], r["layers"],
                             MOE_DIST_STEPS)
    return rec


# -- phase 16c, auto-parallel (BASELINE configuration 5) -------------------------

SEMI_STEPS = 3
SEMI_BATCH = 4                   # split 2 + 2 over dp
SEMI_LOSS_RTOL = 1e-5            # float32, the sums ordered differently
# the DTensor collectives the auto-parallel ranks run, probed on CUDA
# tensors over gloo first (redistributions: s -> r all-gather, p -> r
# all-reduce, p -> s reduce-scatter, r -> s a local slice, s -> s'
# all-to-all). torch's functional all-gather ends a gloo rank with a
# segfault on CUDA tensors on the card's torch, so a gloo rank on the
# card routes it to c10d's all_gather_into_tensor
# (distributed/collective.py, counted by gloo_cuda_all_gathers)
DTENSOR_GLOO_OPS = ("shard_to_replicate", "partial_to_replicate",
                    "partial_to_shard", "replicate_to_shard",
                    "shard_to_shard", "full_tensor")


def megatron_shard_fn():
    """tests/test_semi_auto_llama.py's megatron shard_fn, verbatim (in
    Paddle's [in, out] layout: column Shard(1), row Shard(0))."""
    from paddle_tpu_torch.distributed.auto_parallel import (Replicate,
                                                            Shard,
                                                            shard_tensor)
    col = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
    row = ("o_proj", "down_proj")

    def fn(name, sublayer, pm):
        for pname, p in sublayer._parameters.items():
            if p is None:
                continue
            leaf = name.rsplit(".", 1)[-1]
            if p.ndim == 2 and leaf in col:
                shard_tensor(p, pm, [Replicate(), Shard(1)])
            elif p.ndim == 2 and leaf in row:
                shard_tensor(p, pm, [Replicate(), Shard(0)])
            else:
                shard_tensor(p, pm, [Replicate(), Replicate()])

    return fn


def _split_linear_bytes(model):
    """Bytes of the parameters split over a mesh axis (this rank's shards
    of a DTensor model; the same parameters whole in a dense one)."""
    from torch.distributed.tensor import DTensor
    total = 0
    for name, p in model.named_parameters():
        if isinstance(p, DTensor):
            if any(pl.is_shard() for pl in p.placements):
                total += p.to_local().numel() * p.element_size()
        elif name.endswith(("_proj.weight",)):
            total += p.numel() * p.element_size()
    return total


def train_semi_auto_nccl_phase(torch, np, seed, base):
    """BASELINE configuration 5 at world 1 on NCCL: the train phase's
    model (Llama-2-7B widths, TRAIN_LAYERS layers, bf16, its seed and
    batch, AdamW with bf16 moments built first) through the reference's
    calls: ProcessMesh([[0]], ["dp", "mp"]), shard_layer with the
    megatron shard_fn, shard_optimizer, shard_dataloader, to_static and
    DistModel. A mesh of one rank changes no arithmetic: the losses must
    be train's bit for bit, the wgmma flash pair launch a layer a step
    each way, and s/step is printed beside train's (DTensor's per-op
    sharding propagation runs on the host)."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import AdamW, LlamaPretrainingCriterion
    from paddle_tpu_torch.kernels.flash_attention import (_flash_bhsd,
                                                          _flash_bhsd_bwd)
    cfg = train_config()
    model = build_model(torch, cfg, seed)
    crit = LlamaPretrainingCriterion(cfg)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                moment_dtype="bfloat16")
    mesh = dist.ProcessMesh([[0]], dim_names=["dp", "mp"])
    dist.shard_layer(model, mesh, megatron_shard_fn())
    opt = dist.shard_optimizer(opt)
    ids, labels = train_batch(torch, np, seed + 3, cfg.vocab_size,
                              TRAIN_BATCH, TRAIN_SEQ)
    loader = dist.shard_dataloader([(ids, labels)], mesh, shard_dims="dp")
    dm, loader = dist.to_static(model, loader, lambda lo, la: crit(lo, la),
                                opt)
    (x, y), = list(loader)
    torch.cuda.synchronize()
    zero_flash_counts(_flash_bhsd, _flash_bhsd_bwd)
    zero_attention_routes()
    losses = [dm(x, y) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED):
        losses.append(dm(x, y))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [v.item() for v in losses]
    fwd_routes = dict(_flash_bhsd.route_launches)
    bwd_routes = dict(_flash_bhsd_bwd.route_launches)
    attn_routes = attention_routes_without_plain("train_semi_auto_nccl")
    n = TRAIN_WARMUP + TRAIN_TIMED
    want = cfg.num_hidden_layers * n
    rec = {"phase": "train_semi_auto_nccl", "card": card_line(),
           "entry_points": ["ProcessMesh", "shard_layer (megatron shard_fn)",
                            "shard_optimizer", "shard_dataloader",
                            "to_static", "DistModel"],
           "backend": "NCCL", "world_size": 1, "mesh": [[0]],
           "layers": cfg.num_hidden_layers, "dtype": cfg.dtype,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "s_per_step": wall / TRAIN_TIMED,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ * TRAIN_TIMED / wall,
           "train_s_per_step": base["s_per_step"],
           "s_per_step_over_train": wall / TRAIN_TIMED / base["s_per_step"],
           "losses": losses, "losses_equal_train": losses == base["losses"],
           "q_proj_placements": str(model.llama.layers[0].self_attn
                                    .q_proj.weight.placements),
           "flash_fwd_route_launches": fwd_routes,
           "flash_bwd_route_launches": bwd_routes,
           "attention_route_launches": attn_routes}
    emit(rec)
    check(losses == base["losses"],
          f"train_semi_auto_nccl: losses {losses} are not train's "
          f"{base['losses']} bit for bit")
    check(fwd_routes["wgmma"] == want == sum(fwd_routes.values())
          and bwd_routes["wgmma"] == want == sum(bwd_routes.values()),
          f"train_semi_auto_nccl: flash launches {fwd_routes}, "
          f"{bwd_routes} (want {want} wgmma each)")
    del model, dm, opt, loader
    torch.cuda.empty_cache()
    return rec


def _probe_dtensor_gloo(torch, progress):
    """Each DTensor redistribution the auto-parallel ranks run, once on
    tiny CUDA tensors over the 2 x 2 mesh, noted in ``progress`` before it
    runs; a refusal raises, naming it."""
    import paddle_tpu_torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = dist.ProcessMesh([[0, 1], [2, 3]], dim_names=["dp", "mp"])
    dm = mesh.device_mesh()
    x = torch.arange(32, dtype=torch.float32, device="cuda").reshape(4, 8)
    s = DTensor.from_local(x[:2, :4].contiguous(), dm, [Shard(0), Shard(1)],
                           run_check=False)
    p = DTensor.from_local(x.clone(), dm, [Partial(), Partial()],
                           run_check=False)
    r = DTensor.from_local(x.clone(), dm, [Replicate(), Replicate()],
                           run_check=False)
    calls = {
        "shard_to_replicate": lambda: s.redistribute(
            dm, [Replicate(), Replicate()]).to_local(),
        "partial_to_replicate": lambda: p.redistribute(
            dm, [Replicate(), Replicate()]).to_local(),
        "partial_to_shard": lambda: p.redistribute(
            dm, [Shard(0), Shard(1)]).to_local(),
        "replicate_to_shard": lambda: r.redistribute(
            dm, [Shard(0), Shard(1)]).to_local(),
        "shard_to_shard": lambda: s.redistribute(
            dm, [Shard(1), Shard(0)]).to_local(),
        "full_tensor": lambda: s.full_tensor()}
    for name in DTENSOR_GLOO_OPS:
        with open(progress, "a") as f:
            f.write(f"dtensor {name}\n")
        try:
            calls[name]()
            torch.cuda.synchronize()
        except Exception as e:
            raise RuntimeError(f"gloo refuses DTensor's {name} on CUDA "
                               f"tensors: {e}") from e


def _semi_auto_rank(tmpdir, seed, ids, labels):
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    os.environ["PADDLE_COMM_TIMEOUT"] = str(DIST_COMM_TIMEOUT_S)
    try:
        import torch
        import paddle_tpu_torch.distributed as dist
        from paddle_tpu_torch import AdamW, LlamaPretrainingCriterion
        from paddle_tpu_torch.kernels.flash_attention import (
            _flash_bhsd, _flash_bhsd_bwd)
        dist.init_parallel_env(backend="gloo")
        progress = os.path.join(tmpdir, f"rank{rank}.probe")
        _probe_gloo_cuda(torch, progress)
        _probe_dtensor_gloo(torch, progress)
        _f32_no_tf32(torch)
        cfg = _mp2_config(False)
        model = build_model(torch, cfg, seed)
        crit = LlamaPretrainingCriterion(cfg)
        opt = AdamW(learning_rate=MP2_LR, parameters=model.parameters())
        mesh = dist.ProcessMesh([[0, 1], [2, 3]], dim_names=["dp", "mp"])
        dist.shard_layer(model, mesh, megatron_shard_fn())
        opt = dist.shard_optimizer(opt)
        x, y = (torch.as_tensor(a, device="cuda") for a in (ids, labels))
        loader = dist.shard_dataloader([(x, y)] * SEMI_STEPS, mesh,
                                       shard_dims="dp")
        dm, loader = dist.to_static(model, loader,
                                    lambda lo, la: crit(lo, la), opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_flash_counts(_flash_bhsd, _flash_bhsd_bwd)
        losses, times, rows = [], [], []
        for bx, by in loader:
            rows.append(tuple(bx.to_local().shape))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(dm(bx, by).item())
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        from paddle_tpu_torch.distributed.collective import (
            gloo_cuda_all_gathers)
        train_gathers = dict(gloo_cuda_all_gathers)
        split_bytes = _split_linear_bytes(model)
        ref = torch.load(os.path.join(tmpdir, "one_params.pt"), mmap=True)
        got = {}
        for k, p in model.named_parameters():
            whole = dist.unshard_dtensor(p.detach())     # a collective
            if rank == 0:
                got[k] = whole
        gap = _param_gap(torch, ref, got, MP2_LR * SEMI_STEPS) \
            if rank == 0 else None
        _rank_done(tmpdir, rank, {
            "losses": losses, "step_s": times, "local_rows": rows,
            "params_after_step3": gap, "split_linear_bytes": split_bytes,
            "peak_device_bytes": peak,
            "rerouted_all_gathers_by_training": train_gathers,
            "q_proj_local_shape": list(model.llama.layers[0].self_attn
                                       .q_proj.weight.to_local().shape),
            "flash_fwd_route_launches": dict(_flash_bhsd.route_launches),
            "flash_bwd_route_launches": dict(_flash_bhsd_bwd.route_launches)})
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        _rank_failed(tmpdir, rank)
        raise


def semi_auto_dp2mp2_gloo_on_card_phase(torch, np, seed, tmpdir):
    """BASELINE configuration 5 across ranks: four gloo ranks on cuda:0 on
    the mesh [[0, 1], [2, 3]] named ["dp", "mp"], Llama at Llama-2-7B
    widths (hidden 4096, 32 heads of 128, FFN 11008, vocab 32000), 2
    layers, float32 with TF32 off, batch 4 x 512 split 2 + 2 over dp by
    shard_dataloader, the megatron shard_fn over mp, AdamW at lr 1e-5
    built before shard_layer, 3 steps through to_static / DistModel. Held
    against one process on the whole batch from the same full weights
    (every rank draws them whole from the seed and keeps its shards):
    every loss within 1e-5 relative, the parameters after step 3 (made
    whole by unshard_dtensor) by PARAM_FRAC's rule, each rank's bytes of
    the split linears half of one process's, and each rank's attention on
    the CUDA-core flash pair (float32), a layer a step each way. s/step
    and peak memory a rank are printed."""
    from paddle_tpu_torch import AdamW, LlamaPretrainingCriterion, TrainStep
    _f32_no_tf32(torch)
    cfg = _mp2_config(False)
    rng = np.random.default_rng(seed + 3)
    ids = rng.integers(0, cfg.vocab_size, (SEMI_BATCH, MP2_SEQ))
    labels = rng.integers(0, cfg.vocab_size, (SEMI_BATCH, MP2_SEQ))
    model = build_model(torch, cfg, seed)
    crit = LlamaPretrainingCriterion(cfg)
    step = TrainStep(model, lambda lo, la: crit(lo, la), AdamW(
        learning_rate=MP2_LR, parameters=model.parameters()))
    x, y = (torch.as_tensor(a, device="cuda") for a in (ids, labels))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    one, one_s = [], []
    for _ in range(SEMI_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one.append(step((x,), (y,)).item())
        torch.cuda.synchronize()
        one_s.append(time.perf_counter() - t0)
    one_peak = torch.cuda.max_memory_allocated()
    torch.save({k: p.detach().cpu() for k, p in model.named_parameters()},
               os.path.join(tmpdir, "one_params.pt"))
    one_bytes = _split_linear_bytes(model)
    del model, step
    torch.cuda.empty_cache()
    ranks = _spawn_world(_semi_auto_rank, (seed, ids, labels), tmpdir,
                         "semi_auto_dp2mp2_gloo_on_card", n=4)
    rec = {"phase": "semi_auto_dp2mp2_gloo_on_card", "card": card_line(),
           "note": "four ranks on one card over gloo: DTensor's "
                   "redistributions (the mp all-reduces, the dp gradient "
                   "all-reduce, the gathers) go through host memory; no "
                   "NVLink figure",
           "model": "Llama, Llama-2-7B widths, float32, TF32 off",
           "mesh": [[0, 1], [2, 3]], "dim_names": ["dp", "mp"],
           "layers": MP2_LAYERS, "global_batch": [SEMI_BATCH, MP2_SEQ],
           "lr": MP2_LR, "steps": SEMI_STEPS,
           "dtensor_gloo_ops_probed": list(DTENSOR_GLOO_OPS),
           "one_process_losses": one, "one_process_step_s": one_s,
           "one_process_peak_device_bytes": one_peak,
           "one_process_split_linear_bytes": one_bytes,
           "rank_losses": [r["losses"] for r in ranks],
           "rank_step_s": [r["step_s"] for r in ranks],
           "rank_s_per_step_over_one_process": [
               r["step_s"][-1] / one_s[-1] for r in ranks],
           "rank_peak_device_bytes": [r["peak_device_bytes"] for r in ranks],
           "rank_split_linear_bytes": [r["split_linear_bytes"]
                                       for r in ranks],
           "rank_local_rows": [r["local_rows"] for r in ranks],
           "rerouted_all_gathers_by_probe_and_training": [
               r["rerouted_all_gathers_by_training"] for r in ranks],
           "q_proj_local_shape": [r["q_proj_local_shape"] for r in ranks],
           "params_after_step3": ranks[0]["params_after_step3"],
           "flash_fwd_route_launches": [r["flash_fwd_route_launches"]
                                        for r in ranks],
           "flash_bwd_route_launches": [r["flash_bwd_route_launches"]
                                        for r in ranks]}
    emit(rec)
    want = MP2_LAYERS * SEMI_STEPS
    for rank, r in enumerate(ranks):
        rel = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], one))
        check(rel <= SEMI_LOSS_RTOL,
              f"semi_auto_dp2mp2_gloo_on_card: rank {rank} losses "
              f"{r['losses']} vs one process {one}")
        check(2 * r["split_linear_bytes"] == one_bytes,
              f"semi_auto_dp2mp2_gloo_on_card: rank {rank} holds "
              f"{r['split_linear_bytes']} bytes of the split linears, one "
              f"process {one_bytes}")
        check(all(rows == (SEMI_BATCH // 2, MP2_SEQ)
                  for rows in r["local_rows"]),
              f"semi_auto_dp2mp2_gloo_on_card: rank {rank} rows "
              f"{r['local_rows']}")
        fwd, bwd = r["flash_fwd_route_launches"], r["flash_bwd_route_launches"]
        check(fwd["cuda_core"] == want == sum(fwd.values())
              and bwd["cuda_core"] == want == sum(bwd.values()),
              f"semi_auto_dp2mp2_gloo_on_card: flash launches {fwd}, "
              f"{bwd} (want {want} cuda_core each)")
    check(ranks[0]["params_after_step3"]["ok"],
          f"semi_auto_dp2mp2_gloo_on_card: parameters after step "
          f"{SEMI_STEPS}: {ranks[0]['params_after_step3']}")
    return rec


def dist_phases(torch, np, seed, train, train_gpt2, train_moe=None,
                profile=False):
    """Phase 16c: the collectives on NCCL at world 1, train_gpt2 and train
    through fleet at one rank (bit for bit against those phases; train
    also pipelined at pp 1, and through the auto-parallel API on a mesh
    of one rank), then data, tensor, pipeline and auto parallelism in
    gloo ranks on the card; then configuration 4: the stage-2
    composition at world 1 on NCCL (bit for bit with one process, and
    with train_moe when it ran), expert parallelism, the ZeRO stages and
    both together in gloo ranks. Tensor parallelism also runs under
    matmul_quant at world 1 on NCCL and, in gloo ranks, under sequence
    parallelism and the collective-matmul rings; with ``profile`` one
    quantized train step is also profiled. Returns the auto-parallel
    phases' records (their flash launches join the kernels line) and the
    quantized train's (its quant_matmul launches join it)."""
    import tempfile
    dist_collectives_nccl_phase(torch, np, seed + 80)
    train_gpt2_dp_phase(torch, np, seed + 30, train_gpt2)
    mp1 = train_mp1_nccl_phase(torch, np, seed, train)
    quant = train_mp1_quant_nccl_phase(torch, np, seed, mp1)
    if profile:
        from paddle_tpu_torch.kernels.quant_matmul import (
            configure_matmul_quant)
        try:
            train_profile_phase(torch, np, seed,
                                phase="train_mp1_quant_profile",
                                build=quant_profile_build(torch, np, "int8"))
        finally:
            configure_matmul_quant("none")
    train_pp1_nccl_phase(torch, np, seed, train)
    semi = {"nccl": train_semi_auto_nccl_phase(torch, np, seed, train)}
    with tempfile.TemporaryDirectory() as tmp:
        dp2_gloo_on_card_phase(torch, np, seed + 81,
                               tempfile.mkdtemp(dir=tmp))
        mp2_dir = tempfile.mkdtemp(dir=tmp)
        mp2 = mp2_gloo_on_card_phase(torch, np, seed + 82, mp2_dir)
        mp2_overlap_gloo_on_card_phase(torch, np, seed + 82,
                                       tempfile.mkdtemp(dir=tmp), mp2_dir,
                                       mp2)
        pp2_gloo_on_card_phase(torch, np, seed + 83,
                               tempfile.mkdtemp(dir=tmp))
        pp2mp2_gloo_on_card_phase(torch, np, seed + 84,
                                  tempfile.mkdtemp(dir=tmp))
        semi["gloo"] = semi_auto_dp2mp2_gloo_on_card_phase(
            torch, np, seed + 85, tempfile.mkdtemp(dir=tmp))
    # configuration 4 on train_moe's seed and batch
    one = train_moe_stage2_nccl_phase(torch, np, seed + 41, train_moe)
    with tempfile.TemporaryDirectory() as tmp:
        ep2_gloo_on_card_phase(torch, np, seed + 41,
                               tempfile.mkdtemp(dir=tmp), one)
        sharding2_gloo_on_card_phase(torch, np, seed + 41,
                                     tempfile.mkdtemp(dir=tmp), one)
        ep2sharding2_gloo_on_card_phase(torch, np, seed + 41,
                                        tempfile.mkdtemp(dir=tmp), one)
    return semi, quant


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="decoder layers of the full-width model (depth "
                         "is the only thing a time limit may cut)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nan-guard-cost", action="store_true",
                    help="only build the kernels and time the tensor-core "
                         "masked kernels' NaN guard, forward and backward "
                         "(extra builds with the scan on every tile and on "
                         "none), then exit")
    ap.add_argument("--gemv-cost", action="store_true",
                    help="only build the kernels and time the tensor-core "
                         "GEMV without its products and without its code "
                         "reads (extra builds), then exit")
    ap.add_argument("--grouped-cost", action="store_true",
                    help="only build the kernels and time the grouped "
                         "tensor-core forward and weight gradient without "
                         "their drain, split, loads or products, and the "
                         "weight gradient with its blocks in expert order "
                         "(extra builds), then exit")
    ap.add_argument("--ragged-cost", action="store_true",
                    help="only build the kernels and time the three ragged "
                         "kernels without their arithmetic, without their "
                         "loads and at fixed cluster sizes (extra builds), "
                         "then exit")
    ap.add_argument("--parent", metavar="DIR",
                    help="a checkout of the parent commit: its three ragged "
                         "kernels and its grouped and quantized grouped "
                         "kernels are built and timed beside the shipped "
                         "ones, the same way, in the ragged, partials and "
                         "grouped cases, and train_moe and train_moe_quant "
                         "run again on its grouped and quantized kernels")
    ap.add_argument("--dist-only", action="store_true",
                    help="only build the flash and grouped kernels and run "
                         "the train and train_gpt2 phases (the bases of the "
                         "bit-for-bit checks) and the data-, tensor-, "
                         "pipeline-, auto-, sharding- and expert-parallel "
                         "phases, then exit")
    ap.add_argument("--profile", action="store_true",
                    help="also profile short full-width serves (plain, "
                         "quantized, long-context), train steps (plain "
                         "and under matmul_quant) and the "
                         "packed-attention passes with torch.profiler "
                         "(device time by kernel)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import numpy as np
        from paddle_tpu_torch.kernels import _build
        from paddle_tpu_torch.kernels.flash_attention import _flash_bhsd
        from paddle_tpu_torch.kernels.ragged_paged_attention import (
            ragged_paged_attention)
        from paddle_tpu_torch.models.llama import llama_2_7b
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2

    card = card_line()
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    sources = ("ragged_paged_attention", "flash_attention_fwd",
               "flash_attention_bwd", "quant_matmul",
               "ragged_paged_attention_quant",
               "ragged_paged_attention_partials", "grouped_matmul",
               "quant_grouped_matmul", "flash_varlen", "flash_sparse_mask",
               "rms_norm", "fused_elementwise")
    if args.dist_only:
        _build.build("flash_attention_fwd", "flash_attention_bwd",
                     "grouped_matmul", "quant_matmul")
        train = train_phase(torch, np, args.seed)
        train_gpt2 = train_gpt2_phase(torch, np, args.seed + 30)
        dist_phases(torch, np, args.seed, train, train_gpt2,
                    profile=args.profile)
        print(card_line(), flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    t0 = time.perf_counter()
    libs = _build.build(*sources)
    build_s = time.perf_counter() - t0
    ptxas = {name: ptxas_kernels(_build.build_log(name))
             for name in sources}
    hgmma = {}
    for name, kernels in WGMMA_KERNELS.items():
        hgmma.update(hgmma_counts(libs[name], kernels))
    # nine flash kernels (the masked forward, dq and dk/dv under two
    # policies) at D 64 and 128; qmm_wgmma for 2 code types; the grouped
    # quantized kernel for 2 x dtypes x 2 code types; the grouped forward
    # for 2 dtypes x 2 transposes and its weight gradient for 2 dtypes
    check(len(hgmma) == 30 and all(hgmma.values()),
          f"a kernel meant for the tensor cores has no HGMMA: {hgmma}")
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas,
          "hgmma": hgmma})
    if args.nan_guard_cost:
        nan_guard_cost(torch, np, pack_documents(np, args.seed),
                       args.seed + 50)
        print(card, flush=True)
        return 0
    if args.gemv_cost:
        gemv_cost(torch, args.seed + 70)
        print(card, flush=True)
        return 0
    if args.ragged_cost:
        ragged_cost(torch, np, args.parent)
        print(card, flush=True)
        return 0
    if args.grouped_cost:
        grouped_cost(torch, np, args.seed + 40)
        print(card, flush=True)
        return 0

    # with --parent, the parent commit's three ragged kernels are timed
    # beside the shipped ones in the main cases
    parent = ({stem: {"parent": lib} for stem, lib in
               parent_ragged_libs(args.parent).items()}
              if args.parent else dict.fromkeys(RAGGED_STEMS))
    ragged_main = ragged_case(torch, np, "mha_32x32", 32, 32, 11,
                              variants=parent["ragged_paged_attention"])
    ragged_case(torch, np, "gqa_32x8", 32, 8, 12,
                variants=parent["ragged_paged_attention"])
    ragged_case(torch, np, "nan_poison", 32, 32, 13, poison=True)
    ragged_case(torch, np, "last_token_gqa_32x8", 32, 8, 14, plant=True)
    # the forward: bf16 at D 64 and 128 on the tensor-core kernel, with
    # tails that no 64-tile divides (S 1000)
    fwd_wgmma = []
    for s in (1024, 2048):
        for d in (64, 128):
            for causal in (True, False):
                fwd_wgmma.append(flash_case(
                    torch, f"bh64_s{s}_d{d}_{'causal' if causal else 'full'}",
                    64, s, d, causal, s + d + causal))
    for causal in (True, False):
        fwd_wgmma.append(flash_case(
            torch, f"bh64_s1000_d128_{'causal' if causal else 'full'}", 64,
            1000, 128, causal, 33 + causal))
    # the shape CachedDecoder's prefill gives the kernel in phase 5
    fwd_wgmma.append(flash_case(
        torch, "generate_prefill_bh128_s1024_d128_causal", 128, 1024, 128,
        True, 7))
    # the CUDA-core kernel: float32 (train_parity's dtype) and bf16 at D 256
    fwd_f32 = flash_case(torch, "bh64_s1024_d128_causal_f32", 64, 1024, 128,
                         True, 43, dtype="float32")
    fwd_d256 = flash_case(torch, "bh16_s1024_d256_causal", 16, 1024, 256,
                          True, 44)
    for rec in fwd_wgmma:
        check(rec["route"] == "wgmma", f"{rec['case']}: routed to "
                                       f"{rec['route']}")
    for rec in (fwd_f32, fwd_d256):
        check(rec["route"] == "cuda_core", f"{rec['case']}: routed to "
                                           f"{rec['route']}")
    # the quantized and long-context serving kernels at serve_quant's and
    # serve_long's shapes: the decode projections (M = 8 slots) and fp8
    # codes on the tensor-core GEMV, the head (float32 x) on the CUDA-core
    # one; the prefill products (M 1024
    # gate_up and down, fp8 gate_up, a partial last m-tile at M 777) on
    # the tensor cores; float32 gate_up at M 1024 on the CUDA-core tile
    qmm_main = qmm_head = qmm_prefill = None
    for name, m, k, n, qd, xd in (
            ("decode_qkvo_m8_k4096_n4096", 8, 4096, 4096, "int8",
             torch.bfloat16),
            ("decode_gate_up_m8_k4096_n11008", 8, 4096, 11008, "int8",
             torch.bfloat16),
            ("decode_down_m8_k11008_n4096", 8, 11008, 4096, "int8",
             torch.bfloat16),
            ("decode_head_m8_k4096_n32000_f32", 8, 4096, 32000, "int8",
             torch.float32),
            ("prefill_gate_up_m1024_k4096_n11008", 1024, 4096, 11008,
             "int8", torch.bfloat16),
            ("prefill_down_m1024_k11008_n4096", 1024, 11008, 4096, "int8",
             torch.bfloat16),
            ("fp8_prefill_gate_up_m1024_k4096_n11008", 1024, 4096, 11008,
             "fp8", torch.bfloat16),
            # a partial m-tile at full width: the masked edge
            ("prefill_ragged_m777_k4096_n11008", 777, 4096, 11008, "int8",
             torch.bfloat16),
            # float32 x past the GEMV: the CUDA-core tile (the float32
            # engines' prefill)
            ("prefill_gate_up_m1024_k4096_n11008_f32", 1024, 4096, 11008,
             "int8", torch.float32),
            ("fp8_decode_gate_up_m8_k4096_n11008", 8, 4096, 11008, "fp8",
             torch.bfloat16)):
        rec = qmm_case(torch, name, m, k, n, qd, xd, m + k + n)
        if name.startswith("decode_gate_up"):
            qmm_main = rec
        if name.startswith("decode_head"):
            qmm_head = rec
        if name == "prefill_gate_up_m1024_k4096_n11008":
            qmm_prefill = rec
        bf16 = xd == torch.bfloat16
        check(rec["route"] == (("gemv_tc" if bf16 else "rows") if m <= 32
                               else "wgmma" if bf16 else "tiled"),
              f"{name}: routed to {rec['route']}")
    rquant_main = ragged_quant_case(
        torch, np, "quant_mha_32x32", 32, 32, 21,
        variants=parent["ragged_paged_attention_quant"])
    ragged_quant_case(torch, np, "quant_gqa_32x8", 32, 8, 22,
                      variants=parent["ragged_paged_attention_quant"])
    ragged_quant_case(torch, np, "quant_nan_poison", 32, 32, 23, poison=True)
    ragged_quant_case(torch, np, "quant_last_token_gqa_32x8", 32, 8, 24,
                      plant=True)
    partials_main = partials_case(
        torch, np, "shards4_s4_32x32_mb64", 32, 32, 25,
        variants=parent["ragged_paged_attention_partials"])
    partials_case(torch, np, "shards4_s4_32x8_mb64", 32, 8, 26,
                  variants=parent["ragged_paged_attention_partials"])
    partials_case(torch, np, "shards4_nan_poison", 32, 32, 27, poison=True)
    # the three at the warm prefill's shape (512 suffix rows after 512
    # cached tokens, one table), with NaN outside every row's window
    warm_main = {kind: warm_kernel_case(torch, np, kind, 28 + i)
                 for i, kind in enumerate(WARM_STEMS)}

    layers = args.layers
    reqs = make_requests(np, args.seed)
    model = build_model(torch, llama_2_7b(dtype="bfloat16",
                                          num_hidden_layers=layers),
                        args.seed)
    serve, served = serve_phase(torch, np, model, reqs, layers)
    _, served_serial = serve_phase(torch, np, model, reqs, layers,
                                   pipeline=False)
    check(served_serial == served, "serve_serial: the serial loop's "
                                   "streams differ from serve's")
    chunk_graph_phase(torch, np, model, args.seed + 4)
    gen = generate_phase(torch, np, model, layers, args.seed)
    generate_sample_phase(torch, np, model, layers, args.seed)
    if args.profile:
        profile_phase(torch, model, reqs)
    serve_quant, served_quant = serve_quant_phase(torch, np, model, reqs,
                                                  layers)
    _, served_quant_serial = serve_quant_phase(torch, np, model, reqs,
                                               layers, pipeline=False)
    check(served_quant_serial == served_quant,
          "serve_quant_serial: the serial loop's streams differ from "
          "serve_quant's")
    long_reqs = make_long_requests(np, args.seed)
    serve_long = serve_long_phase(torch, np, model, long_reqs, layers)
    serve_prefix = serve_prefix_phase(torch, np, model, layers,
                                      args.seed + 5)
    if args.profile:
        profile_phase(torch, model, reqs, "profile_serve_quant",
                      weight_quant="int8_blockwise", kv_quant="int8")
        long_kw = dict(max_len=4096, max_slots=4, attn_shards=4)
        profile_phase(torch, model, long_reqs, "profile_serve_long",
                      **long_kw)
        if args.parent:
            # the same serve on the parent's partials kernel
            stem = "ragged_paged_attention_partials"
            shipped = _build._libs[stem]
            _build._libs[stem] = parent[stem]["parent"]
            try:
                profile_phase(torch, model, long_reqs,
                              "profile_serve_long_parent_partials",
                              parent=args.parent, **long_kw)
            finally:
                _build._libs[stem] = shipped
    del model
    torch.cuda.empty_cache()
    parity_phase(torch, np, reqs, args.seed)
    quant_shard_parity_phase(torch, np, reqs, args.seed)
    prefix_parity, _ = prefix_phases(torch, np, args.seed)

    # the training path's kernel checks run after the serving phases, so
    # that those see the card as the serving slice left it
    # the shape the train phase gives the forward (batch 6 x 32 heads)
    fwd_main = flash_case(torch, "train_bh192_s2048_d128_causal", 192, 2048,
                          128, True, 8)
    check(fwd_main["route"] == "wgmma", f"the train-shape forward routed to "
                                        f"{fwd_main['route']}")
    # bf16 at D 64 and 128 on the tensor-core pair
    wgmma_cases = []
    for s in (1024, 2048):
        for d in (64, 128):
            for causal in (True, False):
                wgmma_cases.append(flash_bwd_case(
                    torch, f"bh64_s{s}_d{d}_{'causal' if causal else 'full'}",
                    64, s, d, causal, 3 * s + d + causal))
    for causal in (True, False):                # no tile divides 1000
        wgmma_cases.append(flash_bwd_case(
            torch, f"bh64_s1000_d128_{'causal' if causal else 'full'}",
            64, 1000, 128, causal, 31 + causal))
    # the shape the train phase gives the backward
    bwd_main = flash_bwd_case(torch, "train_bh192_s2048_d128_causal", 192,
                              2048, 128, True, 9)
    for rec in wgmma_cases + [bwd_main]:
        check(rec["route"] == "wgmma", f"{rec['case']}: routed to "
                                       f"{rec['route']}")
    # the CUDA-core pair: float32 (train_parity's dtype) and bf16 at D 256
    bwd_f32 = flash_bwd_case(torch, "bh64_s1024_d128_causal_f32", 64, 1024,
                             128, True, 41, dtype="float32")
    bwd_d256 = flash_bwd_case(torch, "bh16_s1024_d256_causal", 16, 1024,
                              256, True, 42)
    for rec in (bwd_f32, bwd_d256):
        check(rec["route"] == "cuda_core", f"{rec['case']}: routed to "
                                           f"{rec['route']}")
    train = train_phase(torch, np, args.seed)
    if args.profile:
        train_profile_phase(torch, np, args.seed)
    train_parity = train_parity_phase(torch, np, args.seed)

    # GPT-2 124M: the flash kernels at the shape its training gives them
    # (bf16, batch 8 x 12 heads, S 1024, D 64, causal) on the tensor cores,
    # then the benchmark's training, with clipping and a schedule, and
    # its float32 parity
    fwd_gpt2 = flash_case(torch, "gpt2_bh96_s1024_d64_causal", 96, 1024, 64,
                          True, 10)
    bwd_gpt2 = flash_bwd_case(torch, "gpt2_bh96_s1024_d64_causal", 96,
                              1024, 64, True, 11)
    for rec in (fwd_gpt2, bwd_gpt2):
        check(rec["route"] == "wgmma", f"{rec['kernel']} {rec['case']}: "
                                       f"routed to {rec['route']}")
    train_gpt2 = train_gpt2_phase(torch, np, args.seed + 30)
    if args.profile:
        train_profile_phase(torch, np, args.seed + 30,
                            phase="train_gpt2_profile",
                            build=gpt2_profile_build(torch, np))
    train_gpt2_phase(torch, np, args.seed + 30, phase="train_gpt2_sched",
                     sched=True, beside=train_gpt2["s_per_step"])
    train_gpt2_parity_phase(torch, np, args.seed + 31)

    # the MoE training path: its kernels at train_moe's shapes, then the
    # full-width GPT-MoE, its int8-expert lane and the dispatch parity
    gq_parent = gm_parent = None
    if args.parent:
        quant_parent = parent_quant_libs(args.parent)
        gq_parent, gm_parent = quant_parent["gq"], quant_parent["gm"]
        qmm_wgmma_unchanged(libs["quant_matmul"],
                            _build.build_log("quant_matmul"),
                            quant_parent["qmm"])
    l2_rate = l2_read_rate(torch)
    (gmm_main, gmm_cuda_core, dw_main, dw_cuda_core, qgmm_main,
     qgmm_cuda_core) = moe_kernel_checks(
        torch, np, args.seed + 40, parent=gq_parent, parent_gm=gm_parent,
        l2_rate=l2_rate)
    train_moe = train_moe_phase(torch, np, args.seed + 41)
    if gm_parent is not None:
        # the same phase on the parent's grouped forward and weight
        # gradient, swapped in
        stem = "grouped_matmul"
        shipped = _build._libs[stem]
        parent_gm = _build._libs[stem] = ParentGm(gm_parent)
        try:
            train_moe_phase(torch, np, args.seed + 41,
                            phase="train_moe_parent", parent_gm=parent_gm,
                            extra={"parent": args.parent})
        finally:
            _build._libs[stem] = shipped
    if args.profile:
        train_moe_profile_phase(torch, np, args.seed + 41)
    train_moe_quant = train_moe_phase(torch, np, args.seed + 41,
                                      phase="train_moe_quant", timed=5,
                                      quant_route="wgmma",
                                      expert_quant="int8")
    if gq_parent is not None:
        # the same phase on the parent's quantized kernel and grouped
        # kernels (the input and weight gradients), swapped in
        shipped = {stem: _build._libs[stem] for stem in
                   ("quant_grouped_matmul", "grouped_matmul")}
        parent_gq = _build._libs["quant_grouped_matmul"] = \
            ParentGq(gq_parent)
        parent_gm = _build._libs["grouped_matmul"] = ParentGm(gm_parent)
        try:
            train_moe_phase(torch, np, args.seed + 41,
                            phase="train_moe_quant_parent", timed=5,
                            parent_gq=parent_gq, parent_gm=parent_gm,
                            extra={"parent": args.parent},
                            expert_quant="int8")
        finally:
            _build._libs.update(shipped)
    dw_order_phase(torch, np, args.seed + 42,
                   {p["phase"]: p["expert_counts"][-1]
                    for p in (train_moe, train_moe_quant)})
    # groups of 64 rows: every quantized launch and every input gradient on
    # the CUDA-core kernels, every weight gradient on the tensor cores
    train_moe_quant_bm64 = train_moe_phase(
        torch, np, args.seed + 41, phase="train_moe_quant_bm64", warmup=1,
        timed=2, quant_route="cuda_core", grouped_route="cuda_core",
        expert_quant="int8", group_block=64)
    # an expert width off multiples of 8: every weight gradient on the
    # CUDA-core kernel (the forwards too, but the down projection's input
    # gradient, whose contraction is 768 wide)
    train_moe_f3076 = train_moe_phase(
        torch, np, args.seed + 41, phase="train_moe_f3076", warmup=1,
        timed=2, grouped_route=None, dw_route="cuda_core",
        d_hidden=MOE_F_ODD)
    odd_calls = train_moe_f3076["layers"] * 3     # layers x steps
    check(train_moe_f3076["grouped_route_launches"]
          == {"cuda_core": 3 * odd_calls, "wgmma": odd_calls},
          f"train_moe_f3076: grouped forward launches by route "
          f"{train_moe_f3076['grouped_route_launches']}")
    moe_parity_phase(torch, np, args.seed)
    attention_fallback_check(torch, args.seed + 45)

    # packed and masked attention: the kernels at the packed batch's
    # shapes, then the two entry points on it, then their parity
    lens = pack_documents(np, args.seed)
    (varlen_main, varlen_bwd_main, mask_main, mask_bwd_main, varlen_f32,
     varlen_bwd_f32, mask_f32, mask_bwd_f32) = packed_kernel_checks(
        torch, np, lens, args.seed + 50)
    varlen = varlen_attn_phase(torch, np, lens, args.seed + 51,
                               args.profile)
    flashmask = flashmask_attn_phase(torch, np, lens, args.seed + 51,
                                     args.profile)
    packed_parity = packed_parity_phase(torch, np, lens, args.seed + 52)

    # the row-wise slice: its kernels at rowwise_attn's shapes and the edge
    # cases, then the three entry points at full width, then their parity
    rms_main, rms_bwd_main, rope_main, sm_main, sm_bwd_main = \
        rowwise_kernel_checks(torch, args.seed + 60)
    rowwise = rowwise_attn_phase(torch, args.seed + 61, args.profile)
    rowwise_parity_phase(torch, args.seed + 61)

    # ResNet-50 eager training: no kernel of the port's own (the reference
    # runs it on XLA convolutions, pools and batch norms, no Pallas call)
    train_resnet50_phase(torch, np, args.seed + 70)
    if args.profile:
        train_resnet50_profile_phase(torch, np, args.seed + 70)
    resnet_parity_phase(torch, np, args.seed + 71)

    # data, tensor, pipeline and auto parallelism: NCCL at world 1, gloo
    # ranks on the card
    semi, quant = dist_phases(torch, np, args.seed, train, train_gpt2,
                              train_moe, args.profile)
    # the auto-parallel phases' attention: the wgmma pair at world 1 (bf16),
    # the CUDA-core pair on each gloo rank (float32; rank 0's count)
    semi_fwd = {"wgmma": semi["nccl"]["flash_fwd_route_launches"]["wgmma"],
                "cuda_core": semi["gloo"]["flash_fwd_route_launches"][0]
                ["cuda_core"]}
    semi_bwd = {"wgmma": semi["nccl"]["flash_bwd_route_launches"]["wgmma"],
                "cuda_core": semi["gloo"]["flash_bwd_route_launches"][0]
                ["cuda_core"]}

    kernels = []
    for name, route_src, replaces, rec, launches in (
            ("ragged_paged_attention",
             "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
             "paddle_tpu/kernels/pallas/ragged_paged_attention.py:170",
             ragged_main, serve["ragged_launches"]),
            ("flash_attention_fwd",
             "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
             "paddle_tpu/kernels/pallas/flash_attention.py:135",
             fwd_f32, train_parity["flash_fwd_route_launches"]["cuda_core"]
             + semi_fwd["cuda_core"]),
            ("flash_attention_fwd_wgmma",
             "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
             "paddle_tpu/kernels/pallas/flash_attention.py:135, :220",
             fwd_main, train["flash_fwd_route_launches"]["wgmma"]
             + gen["flash_route_launches"]["wgmma"] + semi_fwd["wgmma"]),
            ("flash_attention_fwd_wgmma_d64",
             "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
             "paddle_tpu/kernels/pallas/flash_attention.py:135",
             fwd_gpt2, train_gpt2["flash_fwd_route_launches"]["wgmma"]),
            ("flash_attention_bwd",
             "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
             "paddle_tpu/kernels/pallas/flash_attention.py:480",
             bwd_f32, train_parity["flash_bwd_route_launches"]["cuda_core"]
             + semi_bwd["cuda_core"]),
            ("flash_attention_bwd_wgmma",
             "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
             "paddle_tpu/kernels/pallas/flash_attention.py:480, :497",
             bwd_main, train["flash_bwd_route_launches"]["wgmma"]
             + semi_bwd["wgmma"]),
            ("flash_attention_bwd_wgmma_d64",
             "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
             "paddle_tpu/kernels/pallas/flash_attention.py:480, :497",
             bwd_gpt2, train_gpt2["flash_bwd_route_launches"]["wgmma"]),
            ("quant_matmul", "paddle_tpu_torch/csrc/quant_matmul.cu",
             "paddle_tpu/kernels/pallas/quant_matmul.py:177",
             qmm_head, serve_quant["quant_matmul_route_launches"]["rows"]),
            ("quant_matmul_gemv_tc", "paddle_tpu_torch/csrc/quant_matmul.cu",
             "paddle_tpu/kernels/pallas/quant_matmul.py:177",
             qmm_main,
             serve_quant["quant_matmul_route_launches"]["gemv_tc"]),
            ("quant_matmul_wgmma", "paddle_tpu_torch/csrc/quant_matmul.cu",
             "paddle_tpu/kernels/pallas/quant_matmul.py:177",
             qmm_prefill,
             serve_quant["quant_matmul_route_launches"]["wgmma"]),
            # the mp layers' quantized training products (train_mp1_quant_
            # nccl, both lanes), checked and timed at the step's gate_up
            ("quant_matmul_wgmma_train",
             "paddle_tpu_torch/csrc/quant_matmul.cu",
             "paddle_tpu/kernels/pallas/quant_matmul.py:177",
             quant["check"], quant["wgmma_launches"]),
            ("ragged_paged_attention_quant",
             "paddle_tpu_torch/csrc/ragged_paged_attention_quant.cu",
             "paddle_tpu/kernels/pallas/ragged_paged_attention.py:506",
             rquant_main, serve_quant["ragged_quant_launches"]),
            ("ragged_paged_attention_partials",
             "paddle_tpu_torch/csrc/ragged_paged_attention_partials.cu",
             "paddle_tpu/kernels/pallas/ragged_paged_attention.py:310",
             partials_main, serve_long["partials_launches"]),
            # the warm prefill's rows: serve_prefix (both serves) for the
            # bf16 pool, prefix_parity's int8 and sharded engines for the
            # other two
            ("ragged_paged_attention_warm",
             "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
             "paddle_tpu/kernels/pallas/ragged_paged_attention.py:170",
             warm_main["kernel"],
             sum(serve_prefix[r]["launches"]["warm_prefill"]
                 for r in ("cold", "warm"))),
            ("ragged_paged_attention_quant_warm",
             "paddle_tpu_torch/csrc/ragged_paged_attention_quant.cu",
             "paddle_tpu/kernels/pallas/ragged_paged_attention.py:506",
             warm_main["qkernel"],
             sum(prefix_parity["int8"][r]["launches"]["warm_prefill"]
                 for r in ("cold", "warm"))),
            ("ragged_paged_attention_partials_warm",
             "paddle_tpu_torch/csrc/ragged_paged_attention_partials.cu",
             "paddle_tpu/kernels/pallas/ragged_paged_attention.py:310",
             warm_main["pkernel"],
             sum(prefix_parity["shards4"][r]["launches"]["warm_prefill"]
                 for r in ("cold", "warm"))),
            ("grouped_matmul_fwd", "paddle_tpu_torch/csrc/grouped_matmul.cu",
             "paddle_tpu/kernels/pallas/grouped_matmul.py:226",
             gmm_cuda_core,
             train_moe_quant_bm64["grouped_route_launches"]["cuda_core"]),
            ("grouped_matmul_fwd_wgmma",
             "paddle_tpu_torch/csrc/grouped_matmul.cu",
             "paddle_tpu/kernels/pallas/grouped_matmul.py:226",
             gmm_main, train_moe["grouped_route_launches"]["wgmma"]),
            ("grouped_matmul_dw",
             "paddle_tpu_torch/csrc/grouped_matmul.cu",
             "paddle_tpu/kernels/pallas/grouped_matmul.py:287",
             dw_cuda_core,
             train_moe_f3076["grouped_dw_route_launches"]["cuda_core"]),
            ("grouped_matmul_dw_wgmma",
             "paddle_tpu_torch/csrc/grouped_matmul.cu",
             "paddle_tpu/kernels/pallas/grouped_matmul.py:287",
             dw_main, train_moe["grouped_dw_route_launches"]["wgmma"]),
            ("quant_grouped_matmul",
             "paddle_tpu_torch/csrc/quant_grouped_matmul.cu",
             "paddle_tpu/kernels/pallas/quant_matmul.py:263",
             qgmm_cuda_core,
             train_moe_quant_bm64["quant_grouped_route_launches"]
             ["cuda_core"]),
            ("quant_grouped_matmul_wgmma",
             "paddle_tpu_torch/csrc/quant_grouped_matmul.cu",
             "paddle_tpu/kernels/pallas/quant_matmul.py:263",
             qgmm_main,
             train_moe_quant["quant_grouped_route_launches"]["wgmma"]),
            ("flash_varlen_fwd", "paddle_tpu_torch/csrc/flash_varlen.cu",
             "paddle_tpu/kernels/pallas/flash_varlen.py:222",
             varlen_f32,
             packed_parity["route_launches"]["flash_varlen_fwd"]
             ["cuda_core"]),
            ("flash_varlen_fwd_wgmma",
             "paddle_tpu_torch/csrc/flash_varlen.cu",
             "paddle_tpu/kernels/pallas/flash_varlen.py:222",
             varlen_main, varlen["fwd_route_launches"]["wgmma"]),
            ("flash_varlen_bwd", "paddle_tpu_torch/csrc/flash_varlen.cu",
             "paddle_tpu/kernels/pallas/flash_varlen.py:284, :313",
             varlen_bwd_f32,
             packed_parity["route_launches"]["flash_varlen_bwd"]
             ["cuda_core"]),
            ("flash_varlen_bwd_wgmma",
             "paddle_tpu_torch/csrc/flash_varlen.cu",
             "paddle_tpu/kernels/pallas/flash_varlen.py:284, :313",
             varlen_bwd_main, varlen["bwd_route_launches"]["wgmma"]),
            ("flash_sparse_mask_fwd",
             "paddle_tpu_torch/csrc/flash_sparse_mask.cu",
             "paddle_tpu/kernels/pallas/flash_sparse_mask.py:185",
             mask_f32,
             packed_parity["route_launches"]["flash_sparse_mask_fwd"]
             ["cuda_core"]),
            ("flash_sparse_mask_fwd_wgmma",
             "paddle_tpu_torch/csrc/flash_sparse_mask.cu",
             "paddle_tpu/kernels/pallas/flash_sparse_mask.py:185",
             mask_main, flashmask["fwd_route_launches"]["wgmma"]),
            ("flash_sparse_mask_bwd",
             "paddle_tpu_torch/csrc/flash_sparse_mask.cu",
             "paddle_tpu/kernels/pallas/flash_sparse_mask.py:225, :245",
             mask_bwd_f32,
             packed_parity["route_launches"]["flash_sparse_mask_bwd"]
             ["cuda_core"]),
            ("flash_sparse_mask_bwd_wgmma",
             "paddle_tpu_torch/csrc/flash_sparse_mask.cu",
             "paddle_tpu/kernels/pallas/flash_sparse_mask.py:225, :245",
             mask_bwd_main, flashmask["bwd_route_launches"]["wgmma"]),
            ("rms_norm_fwd", "paddle_tpu_torch/csrc/rms_norm.cu",
             "paddle_tpu/kernels/pallas/rms_norm.py:59",
             rms_main, rowwise["launches"]["rms_norm_fwd"]),
            ("rms_norm_bwd", "paddle_tpu_torch/csrc/rms_norm.cu",
             "paddle_tpu/kernels/pallas/rms_norm.py:84",
             rms_bwd_main, rowwise["launches"]["rms_norm_bwd"]),
            ("rope", "paddle_tpu_torch/csrc/fused_elementwise.cu",
             "paddle_tpu/kernels/pallas/fused_elementwise.py:71",
             rope_main, rowwise["launches"]["rope"]),
            ("masked_softmax_fwd",
             "paddle_tpu_torch/csrc/fused_elementwise.cu",
             "paddle_tpu/kernels/pallas/fused_elementwise.py:154",
             sm_main, rowwise["launches"]["masked_softmax_fwd"]),
            ("masked_softmax_bwd",
             "paddle_tpu_torch/csrc/fused_elementwise.cu",
             "paddle_tpu/kernels/pallas/fused_elementwise.py:168",
             sm_bwd_main, rowwise["launches"]["masked_softmax_bwd"])):
        check(launches > 0, f"{name} never ran on the main path")
        # a kernel timed in a CUDA graph gives that time, and its library's
        kernels.append({"name": name, "route": "cuda", "source": route_src,
                        "replaces": replaces, "launches": launches,
                        "max_abs_err": rec["max_abs_err"],
                        "ms": rec.get("graph_ms", rec["kernel_ms"]),
                        "plain_ms": rec["plain_ms"],
                        "bound_ms": rec["bound_ms"],
                        "bound_by": rec["bound_by"],
                        "library_ms": rec.get("library_graph_ms",
                                              rec["library_ms"])})
    emit({"kernels": kernels})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
