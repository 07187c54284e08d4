#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Phases (any failure exits non-zero; nothing is caught and swallowed):

1. the card: CUDA present, ``nvidia-smi`` name and power limit;
2. build: every CUDA kernel of the port compiled from ``src/repro_torch/
   kernels/csrc`` by ``nvcc`` (one process per source, all in parallel);
3. kernels: each kernel's wrapper on the card at the full-width shapes of
   the serving paths (starcoder2-3b and codeqwen1.5-7b, M in {8, 256})
   against its plain PyTorch version on the same inputs — bit-exact for
   quantize_rows (f32 rows, and bf16 rows ``B1_BF16`` — decode rows and the
   KV write's rows of the head dim — equal to the f32 path too), int8_gemm,
   int4_gemm, the int8 dual_gemm_gated, dual_int4_gemm_gated and
   int_layernorm (the integer library's int32 form, and the models' fused
   norm -> quantize form at the three models' norms for 8, 256 and 4096
   bf16 rows and at D = 16384 past 2^24, each also equal to the chain of
   standalone kernels and timed beside it); within the stated tolerances for
   the bf16 dual_gemm_gated and the decode attention (empty slots, a window,
   an all-masked lane); the paged decode attention on scrambled arenas (int8
   and bf16 pages; shared, non-adjacent and null pages, slots cleared by
   copy-on-write, an idle lane that must be exactly zero) within the same
   tolerance, and bit for bit equal to the dense kernel on the same content
   laid out densely; int8_gemm at the W8A8 projections of both models for
   M in {8, 64, 256, 4096} (``I8_SHAPES``), each beside its ``none``
   epilogue, and its requant family at Table II's and a full-width shape;
   int4_gemm also at the W4A8 forwards' 4 x 1024 rows
   (codeqwen1.5-7b's q/o and mlp_down, zamba2-2.7b's in_proj, out_proj and
   shared GELU MLP; ``W4_SHAPES``); the three gated-MLP forms at
   codeqwen1.5-7b's [M, 4096] x 2 x [4096, 13440] for M in {8, 64, 256,
   4096} with SiLU and GELU (``GATED_ROWS``; dual_int4_gemm_gated also at
   groups 32 and 128 for M in {8, 256}; a ragged case of each form through
   the byte-load path; the bf16 form also bit-identical across two runs).
   Each is timed (CUDA events, L2 flushed
   before every launch) beside its plain version, a PyTorch library
   yardstick where one call computes the same function (``torch._int_mm``
   for the integer GEMMs, rows padded to 32 at M = 8, which it refuses; for
   int4_gemm on the unpacked int8 weight, without the group scales: not the
   same function; for the gated MLPs two ``_int_mm`` or two bf16
   ``torch.matmul``, without scales or activation: not the same function)
   and its bound: the larger of bytes / 3.35 TB/s and operations / peak rate
   (1979 TOP/s int8, 989 TFLOP/s bf16, 67 TFLOP/s f32 outside the tensor
   cores; H100 SXM data sheet).  The no-cache forward's kernels at B = 4,
   T = 1024: int8_flash_attention (``check_int8_attention``) at
   codeqwen1.5-7b's and starcoder2-3b's heads (integer probabilities
   bit-exact through its debug output, the f32 output within rtol 1e-5,
   atol 1e-6; the int32 form bit-exact), then at 4096 and 8192 causal keys
   (``check_streaming_attention``, the same checks, every launch counted as
   streaming); flash_attention (bf16, against SDPA's time too) and
   int_softmax (``check_int_softmax``, bit-exact, through ``ops.softmax_i8``)
   on [4096, 1024] int32 rows unmasked, with a causal mask, spread far past
   30*q_ln2, with the [T, T] mask broadcast over [4, T, T] (uncopied), as an
   int8 payload, and on [64, 2^17] rows (the long-row form); and the rest of
   the integer library (``check_int_library``, bit-exact): int_gelu
   [4096, 12288], int_silu [4096, 13440], requantize_i32 [4096, 4096],
   and int8_conv2d (``check_int8_conv2d``)
   at Table II's [1, 128, 128, 3] x [3, 3, 3, 8] (int32 and requantized), a
   3x3 conv [8, 56, 56, 64] x [3, 3, 64, 64], a first layer over RGB
   [8, 224, 224, 3] x [3, 3, 3, 64] (byte-loaded) and the ViT-B/16 patch
   embed [32, 14, 14, 768] x [1, 1, 768, 768]; ssd_scan at zamba2-2.7b's forward
   shape (``check_ssd_scan``: B = 4, T = 1024, 80 heads, P = N = 64; and
   the reduced model's P = 64, N = 16; y and the final state within
   rtol = atol = 3e-4 of the plain version evaluated in f64); the two
   no-cache attentions
   also at zamba2's head dim 80 (T = 1024 and 4096); and the
   decode kernels' multi-row form (``check_decode_rows``, dense and paged,
   G = 1 and G = 12): every row of a T = 256 launch bit-equal to a T = 1
   launch at its position with the same B; the expert-batched forms of
   int8_gemm, int4_gemm, dual_gemm_gated (int8 and bf16) and
   dual_int4_gemm_gated (``check_experts``: one launch over mixtral-8x7b's
   8 experts [4096 <-> 14336] and qwen2-moe-a2.7b's 60 [2048 <-> 1408], 4
   rows an expert and a bucket-256 step's G * C, each ``torch.equal`` to
   its plain version and to the unbatched kernel on each expert's rows,
   timed beside the loop of unbatched launches and two ``torch.bmm`` for
   bf16); and the decode kernels with mixtral's window (``check_window_
   decode``: G = 4, D = 128, window 4096, a wrapped 4352-slot ring and an
   arena capped at the window; the multi-row form row by row); and this
   slice's shapes (``check_gqa_xlstm``): both decode kernels at G = 6 and
   7 (internlm2-20b's 48 and yi-34b's 56 query heads over 8 KV heads of
   128; T = 1 and the T = 256 rows), int8_flash_attention at 48/8 and
   56/8 heads, int8_gemm at internlm2-20b's W8A8 projections and head
   (N = 92544), yi-34b's int8 head and down projection and xlstm-350m's
   N = 8 gate projection, the int8 dual_gemm_gated at [M, 6144] x 2
   [6144, 16384], int4_gemm at yi's W4A8 projections and the W4 gate
   projection, dual_int4_gemm_gated at [M, 7168] x 2 [7168, 20480], for
   M in {8, 256, 4096}, each ``torch.equal`` to its plain version; and the
   encoder-decoder and cross-attention shapes (``check_encdec_xattn``):
   quantize_rows on f32 rows (vision's stub features [12808, 8192],
   whisper's f32 encoder stream), the fused norm on f32 and bf16 rows,
   int8_flash_attention over whisper's encoder (T = 1500, head dim 64,
   causal) and vision's 64/8 heads, flash_attention at T = 448, head dim
   64, the dense decode kernel at G = 1, D = 64 and G = 8, D = 128 (T = 1
   and the T = 256 rows), int8_gemm at whisper's projections and vision's
   int8 down projection and head, int4_gemm at vision's projections and
   its cross K/V (M = 12808), dual_int4_gemm_gated at [M, 8192] x 2
   [8192, 28672]; and the launches of tensor-parallel serving
   (``check_tp_shapes``): codeqwen1.5-7b's W4A8 q projection and gated MLP
   column-sharded at tp 2 and 4 (N = 4096 / tp; [M, 4096] x 2 [4096,
   13440 / tp], 3360 columns at tp 4) and its o and down projections
   row-sharded (M / tp rows), starcoder2-3b's W8A8 q, kv and up+GELU
   projections at N / 2 and o and down at M / 2, for M in {8, 2048}; the
   decode kernels (dense and paged, T = 1 and 64) at 16 and 8 of codeqwen's
   32 heads and at one of starcoder's two KV heads (G = 12), their cache
   split sized for the full head count: every rank's launch ``torch.equal``
   to the matching slice of the unsharded launch and to (the decode
   kernels: within RTOL/ATOL of) its plain version, rank 0's timed (the
   GEMMs beside ``torch._int_mm`` of the shard's int8 or unpacked int4
   weights), and the bf16 gated MLP's tp 2 column shards of phase 9's bf16
   cell; and the kernel the port adds beyond the TPU's
   (``check_bf16_gemm``): bf16_gemm at codeqwen1.5-7b's q, k, v, o and
   down and starcoder2-3b's q+bias, kv+bias, o, up and down for M in {8,
   64, 256, 4096}, the product within ``DUAL_BF16_RTOL``/``ATOL`` of its
   plain version, the bias epilogue bit-equal to the product plus the
   bias, the same bits in two runs, every tiling its C entry takes
   ``torch.equal`` to the rule's launch, and every tp 2 and tp 4 column
   shard and block of M / tp rows ``torch.equal`` to its slice of the
   unsharded launch (C20's gate); a ragged K and N (whisper-small's
   vocabulary) equal to their zero-padded launch; timed beside
   ``torch.matmul``, with the host's microseconds a launch and each
   tiling's registers, spills and shared memory;
4. reduced: starcoder2-3b-reduced at w8a8 and codeqwen1.5-7b-reduced at
   w4a8, w8a8 and bf16, each with an int8 KV cache, the same packed steps on
   the CPU (plain versions) and on the card (kernels): the logits agree
   within ``REDUCED_TOL`` of their range, and with the CPU in the card's
   order (``forward(card_order=True)``: the cache rows through the decode
   kernels' plain versions) exactly at W8A8/W4A8 and within
   ``CARD_ORDER_TOL`` at bf16, at three seeds; zamba2-2.7b-reduced W8A8's
   forward with states (prefill through ssd_scan and the multi-row form,
   then t = 1 steps) the same way, within ``STATES_TOL`` of the card
   order; codeqwen1.5-7b-reduced w4a8 with a
   paged int8 arena the same, and its card logits equal the dense card
   logits bit for bit; mixtral-8x7b-reduced and qwen2-moe-a2.7b-reduced at
   W4A8 and W8A8 the same (mixtral past its ring's wrap), against the card
   order within ``MOE_ORDER_TOL`` (routing); internlm2-20b (W8A8) and
   yi-34b (W4A8) at G-preserving reduced configs (``reduced_config``: 12
   and 14 query heads over 2 KV heads) the same way, exact against the
   card order; xlstm-350m-reduced W8A8 (``check_xlstm_reduced``): its
   no-cache forward within ``XLSTM_NO_CACHE_TOL`` and its forward with
   states (t = 1 steps) within ``STATES_TOL`` of the CPU, at three seeds,
   with the launches of each forward counted (``xlstm_counts``);
   whisper-small-reduced W8A8 (``check_whisper_reduced``: ``encode`` and the
   cross K/V equal bit for bit, the decoder's steps and ``encdec_forward``
   within ``CROSS_ORDER_TOL``) and llama-3.2-vision-90b-reduced at W4A8
   and W8A8, gates nonzero (``check_vision_reduced``: the cross K/V exact,
   steps and the no-cache forward with ``kv_source`` within
   ``CROSS_ORDER_TOL``), three seeds each; then the reduced no-cache
   forward (starcoder at bf16 and w8a8, codeqwen and zamba2 at bf16, w8a8
   and w4a8) the same way, its
   attention kernel launched once per attention layer and ssd_scan once per
   Mamba-2 layer; and the integer-nonlinearity forward (a
   w8a8 config over float parameters: integer norms, attention and GELU or
   SiLU, float linears) of codeqwen and starcoder the same way, int_silu or
   int_gelu launched once per layer too;
5. serve, each path through ``ServingEngine`` with random weights from
   ``--seed`` PTQ'd by the port, an int8 KV cache, 8 lanes, max_seq 1024,
   token budget 256 and prompts of 16-256 tokens, greedy:
   full-width starcoder2-3b w8a8 (16 requests x 32 new tokens),
   full-width codeqwen1.5-7b w4a8 (16 x 32) and a
   short full-width codeqwen1.5-7b w8a8 drain (4 x 8).  The codeqwen w4a8
   parameters then serve three paged drains (``serve_paged``: the same
   schedule, which must give the dense drain's tokens; a shared 200-token
   prefix; a 66-page pool under pressure; every copy-on-write page and
   every swapped page held bit for bit on the card; the shared-prefix and
   pressure drains' tokens equal to the same requests served unshared and
   unpressured).  Launch counts are
   zeroed just before each drain and read just after; every kernel of that
   path must have launched.  One bucket-1 step of each dense path counts
   its launches (quantize_rows must launch 4 times a layer, before o_proj
   and down and for the k and v writes, int_layernorm's fused form twice a
   layer and once more) and its synchronizing calls (under
   ``torch.cuda.set_sync_debug_mode("warn")``); every profile counts all
   device kernels and the host's synchronizing runtime calls.  Then the
   rest of the engine, 0 token differences required in each: the
   codeqwen w4a8 parameters serve the first 8 requests (prompts cut to 128
   tokens, 16 new) packed, chunked and tokenwise, greedy (equal to each
   other and to phase 5's packed drain) and sampled (temperature 0.7, bit
   for bit across the schedules and after ``warmup()``), the sampled
   packed drain once more through ``run_stream`` with arrivals 0-2 s apart,
   and the 16 requests paged with ``spec_k`` 4; the starcoder w8a8
   parameters serve the 16 requests with ``spec_k`` 4, n-gram drafts and
   random ones (equal to the vanilla drain); the sampler is timed at
   8 x 92416 logits (``sampler_cost``); zamba2-2.7b w8a8 serves 8 requests
   of 16-64 tokens x 16 tokenwise (9 one-row int8_kv_decode_attention
   launches a step at head dim 80, no ssd_scan), 3 of them again alone
   (lane isolation), one step profiled; and zamba2-2.7b-reduced w8a8 is
   served on the card and on the CPU in the card's order (``STATES_TOL``).
   The MoE archs (``serve_moe``), built and quantized a block at a time:
   mixtral-8x7b W4A8 serves 8 requests x 16 new tokens dense, then paged
   (token differences reported, not required 0: pad rows feed the
   router), then one 4608-token request at max_seq 8192 on the 4352-slot
   ring (it wraps), on a cache that never wraps and paged with its live
   pages capped at the window (no pad rows; tokens against the unwrapped
   run's, apart only at a near-tie); qwen2-moe-a2.7b W8A8 serves the 8
   requests dense; a bucket-1 step of each launches one batched up/gate
   and one batched down a layer (and mixtral 32 windowed decode launches),
   and its ``lm_loss`` on 4 x 1024 tokens runs each batched form once a
   layer (phase 6's numbers, taken with the parameters at hand).
   internlm2-20b W8A8 and yi-34b W4A8 (``serve_gqa``), built and quantized
   a block at a time, serve 8 requests x 16 new tokens dense (internlm2
   then paged, 0 token differences required); a bucket-1 step launches
   the decode kernel once a layer (48, 60), and each ``lm_loss`` on
   4 x 1024 tokens runs int8_flash_attention once a layer, profiled.
   xlstm-350m W8A8 (``serve_xlstm``) serves 8 requests x 16 tokenwise,
   then 3 of them one at a time in lane 0 (isolation and reuse, 0
   differences), lane 0's reset held to ``init_block_state``; every
   forward launches int8_gemm once per quantized linear and no attention
   kernel; its ``lm_loss`` at bf16, W8A8 and W4A8 (``xlstm_loss``, the
   integer ones profiled on the device only).  whisper-small W8A8
   (``serve_whisper``): ``encode`` of 8 stub clips, 8 x 16 served with
   ``kv_source`` = that encoding (a ``paged=True`` engine falls back to
   dense), the same requests again on the reused lanes (0 differences), 12
   decode launches a bucket-1 step; its ``encdec_loss`` on 4 x (1500 frames,
   448 tokens) at bf16 and W8A8 (``whisper_loss``: 12 flash_attention or
   24 int8_flash_attention launches a forward); llama-3.2-vision-90b W4A8
   (``serve_vision``), built a block at a time: the engine projects 8 lanes'
   stub vision tokens once, 8 x 16, 80 decode launches a bucket-1 step,
   ``lm_loss`` on 4 x 1024 with ``kv_source``, profiled.  Each model is
   freed before the next;
6. the no-cache forward at full width and depth: codeqwen1.5-7b float
   parameters from ``--seed``, ``calibrate_ptq`` with the reference's grid
   (W4_GROUPS x W4_CLIPS for attn and mlp, 19 forwards of 2 x 128 tokens),
   then ``lm_loss`` on 4 x 1024 random tokens at bf16, w8a8 and w4a8 (each
   integer model quantized from the float one and freed; w4a8 also under
   torch.profiler) and the integer-nonlinearity forward ("w8a8-float"),
   then a w8a8 ``lm_loss`` on 1 x 4096 tokens; starcoder2-3b at bf16, w8a8
   and w8a8-float; the integer library's entry points at Table II's shapes
   and the ViT-B/16 patch embed (``int_library_entry``, equal to the CPU's);
   zamba2-2.7b (float parameters from ``--seed``, ``calibrate_ptq``, then
   ``lm_loss`` on 4 x 1024 tokens at bf16, w8a8 and w4a8, w4a8 profiled);
   and ``ops.softmax_i8`` on causal score rows.  Every forward must launch
   int8_flash_attention (integer) or flash_attention (bf16) exactly once per
   attention layer — every int8_flash_attention launch counted as
   streaming (its one form) — ssd_scan once per Mamba-2 layer (zamba2: 9 and
   45), and the w8a8-float forwards int_silu or int_gelu once per layer.  The
   bf16 and w4a8 forwards and the W8A8 ones of codeqwen, starcoder and
   zamba2 run once more under
   torch.profiler; each profile reports the device ms of the tensor-core
   GEMMs, flash_attention, both decode attentions, the norm and quantize
   kernels, int8_flash_attention and ssd_scan (``PROFILED_KERNELS``).
7. train (``train_phase``): B12 and the bf16 B4 under their
   ``torch.autograd.Function``s at the training shapes (B12 at
   starcoder2-3b's and codeqwen1.5-7b's heads, B 4, T 1024; B4 at [4096,
   4096] x 2 [4096, 13440], SiLU): the forward within each kernel's
   tolerance, the input gradients ``torch.equal`` to autograd of the plain
   version, forward + backward timed beside the plain version's and, as
   yardsticks only, SDPA's and two ``matmul``s'; one backward of the
   reduced starcoder2-3b and codeqwen1.5-7b on the card against the CPU in
   the card's order (``GRAD_REL_L2``, the CPU tests' bound) and the CPU's
   own ``_sdpa`` order (``REDUCED_TOL``); ``Trainer.run`` of full-width
   starcoder2-3b (30 layers) and codeqwen1.5-7b cut to 8 layers, remat on,
   8 steps of 4 x 1024 ``TokenPipeline`` tokens each: step ms, trained
   tok/s, peak GiB, every loss and gradient norm finite and the last loss
   below the first, 2 x n_layers B12 (and B4) launches a step and nothing
   else, one more step under the profiler (forward, backward and optimizer
   spans, the kernels' and the idle shares); a reduced checkpoint saved and
   restored on the card bit for bit;
8. train the other archs (``train_archs_phase``): ssd_scan and the
   expert-batched bf16 B4 under their Functions (the scan at zamba2-2.7b's
   B 4, T 1024; the experts at mixtral's and qwen2-moe's widths with the
   rows a 4 x 1024 forward dispatches), checked and timed as phase 7's; one
   backward of reduced zamba2-2.7b, mixtral-8x7b, qwen2-moe-a2.7b (seeds
   without a router near-tie), xlstm-350m, llama-3.2-vision-90b (with
   ``kv_source``) and whisper-small (its ``encdec_loss``) against the CPU
   as phase 7's; full-width training, bf16, remat, AdamW at ``TRAIN_LR``:
   zamba2-2.7b whole, mixtral-8x7b at 2 layers and qwen2-moe-a2.7b at 4
   (memory), 8 steps of 4 x 1024 tokens, whisper-small whole over 4 x
   (1500 stub frames, 448 tokens) through ``EncDecTrainer``, xlstm-350m
   whole over 4 x 256 tokens for 4 steps (time): every loss and gradient
   norm finite, the last loss below the first (xlstm's reported), every
   kernel of ``train_counts`` twice a step and nothing else, one step
   profiled;
9. serve tensor-parallel (``serve_tp``, ``dist/tp.py``): the cells of
   ``TP_CELLS``, each first served at tp 1 in this process, then by tp
   ranks spawned on this one card (``launch.mesh.run_ranks``; NCCL refuses
   two ranks on one card, so the group is gloo and every collective stages
   through host buffers), each rank building its shard a block at a time
   from ``--seed``.  codeqwen1.5-7b W4A8, 8 of its 32 layers (time), at tp
   2 and 4 on phase 5's first 8 requests, whole prompts, 16 new tokens,
   under the reference smoke's settings (``tp_settings``: greedy dense,
   greedy paged, sampled paged, ``spec_k`` 4 paged on a pressured 64-page
   pool at max_seq 512) at the barrier and the overlap boundary; the same
   model at tp 2 and 4 on 3
   lanes of 720-1000-token prompts at max_seq 1024, dense and paged at the
   overlap boundary (contexts over several decode chunks; 3 rows padded
   to 4); starcoder2-3b W8A8 at tp 2 on the 8 prompts cut to 32 tokens, 4
   new, the four settings (pressure: a 12-page pool at max_seq 128); and
   codeqwen1.5-7b bf16, all 32 layers, at tp 2, dense, on the W4A8
   cell's requests.  Every
   rank's tokens and every forward's logits equal rank 0's and tp 1's, 0
   differences, bf16 too (its float linears on bf16_gemm: ROADMAP C20);
   the
   pressure drains preempt, resume and swap; every kernel of the path
   launches in every rank.  Each drain logs its tok/s and TPOT p50 beside
   tp 1's (N ranks sharing one card: no speed meaning), peak GiB a rank,
   and the boundary ``tp_overlap="auto"`` resolves to.  Then
   ``launch/dryrun.py``'s rank cells on this card (``dist_cells``, gloo):
   GPipe (``dist.pipeline.pipeline_apply``) over 4 stages, every
   rank's outputs ``torch.equal`` to the unpipelined stack on the card,
   and the tp 2 serving cell at the overlap boundary with every summing
   collective refused;
10. the NX-CGRA fabric model (``cgra_phase``, ``core/``): the six Table II
   kernels of ``core.BUILDERS`` built, scheduled (``StaticScheduler``) and
   simulated (``Simulator``) on the CPU (plain versions) and on the card,
   whose payloads run int8_gemm's requant epilogue, int8_conv2d,
   requantize_i32, int_gelu and int_layernorm (each launched, counted),
   int_softmax once on the softmax kernel's inputs (equal to the softmax
   payload's output): every payload output, cycle count, energy and
   ``KernelMetrics`` field equal to the CPU's; Tables VI, V and II printed
   (outputs of the simulated 22 nm, 200 MHz fabric, not card
   measurements), the phase's wall on the card beside its name and power
   limit.

The last three lines of standard output are the kernels JSON (each kernel
timed at the M = 8 shape the main path, codeqwen1.5-7b w4a8, gives it, or
the path that runs it — the paged drains for the paged kernel, the
no-cache forwards for the three attention and softmax kernels and for
int_silu and int_gelu (at 4096 rows), the integer library path for
requantize_i32 and int8_conv2d (the patch embed), zamba2's no-cache
forwards for ssd_scan, codeqwen1.5-7b's bf16 ``lm_loss`` for bf16_gemm;
``by_path``
holds every path's shape, ``launches_by_path`` every path's count), the card's
``nvidia-smi`` name/power line and ``{"ok": true, "device": ...}``.  With
``--out PATH`` every case, the serving stats and the profiles are also
written to PATH as JSON.

Usage:  python3 chip_smoke.py [--seed 0] [--out results.json]

``--serve-only`` builds and then runs only the two dense drains of phase 5
with a bucket-256 step profiled too, and times a bucket-256 prefill's cache
attention both ways (``serve_only``); with ``--src DIR`` it drives another
tree of the port (say a parent commit's ``src`` unpacked under ``build/``),
so that two trees are compared in one call:

    python3 chip_smoke.py --serve-only --src build/parent/src

``--cal-only`` builds and then runs only phase 6's ``calibrate_ptq`` of
codeqwen1.5-7b and zamba2-2.7b, timed and then under the profiler
(``cal_only``); with ``--src DIR`` likewise on another tree.  ``--lm-only``
runs only codeqwen1.5-7b's, starcoder2-3b's and zamba2-2.7b's W8A8
``lm_loss`` on 4 x 1024 tokens, timed and then under the profiler
(``lm_only``), likewise.

``--train-only`` builds only flash_attention, dual_gemm_gated and ssd_scan
and runs only phases 7 and 8 (``train_phase``, ``train_archs_phase``),
printing their summary and no ok line.

``--tp-only`` builds and then runs only phase 3's ``check_tp_shapes`` and
phase 9 (``serve_tp``, ``dist_cells``), printing their summary and no ok
line.

``--cgra-only`` builds the six kernels of the CGRA payloads and runs only
phase 10, printing its tables and no ok line.

``--autotune-only`` builds the GEMMs and the decode kernels and runs only
the autotune phase (``autotune_phase``: ``kernels/autotune.py``'s
``measure`` into a temporary cache, every candidate held to its family's
gate, a fresh lookup returning the measured entry, measured against table
choices), printing them and no ok line; the whole run runs it after phase
3.

``--xlstm-only`` builds and then runs only xlstm-350m's tokenwise drains and
its ``lm_loss`` at bf16, W8A8 and W4A8 without the profiler
(``xlstm_only``), likewise with ``--src DIR``.

``--kernels flash_attention,int4_gemm`` (or ``experts``, ``window_decode``,
``gqa_xlstm``, ``encdec_xattn`` for the later slices' cases, ``dual_gemm_gated``,
``dual_int4_gemm_gated``, ``int8_gemm``, ``int8_kv_decode_attention``,
``paged_decode_attention``, ``quantize_rows``, ``int_layernorm``,
``int8_flash_attention``, ``ssd_scan``, ``int8_conv2d``, ``int_softmax``;
a tree
without the fused norm times only its chain) builds only those kernels (of
the tree
``--src`` names) and runs only their phase 3 cases, held against the
plain versions and timed, each case with the SHA-1 of its output's bytes
(``sha1=`` in its line and the ``sha1`` map of the JSON line); run it on
two trees in turns (parent, change, change, parent) to compare a kernel's
two versions, time and bits, in one call:

    python3 chip_smoke.py --kernels flash_attention,int4_gemm \
        --src build/parent/src
"""
from __future__ import annotations

import argparse
import collections
import copy
import dataclasses
import gc
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BPS = 3.35e12      # H100 SXM device memory
INT8_OPS = 1979e12     # dense int8 tensor-core peak
BF16_OPS = 989e12      # dense bf16 tensor-core peak
F32_OPS = 67e12        # f32 outside the tensor cores
# Phase 4 tolerance: |cpu - cuda| <= 10% of max|logit|.  Every integer kernel
# is bit-exact; the CPU decode step takes the reference's jnp branch (_sdpa,
# probabilities rounded to bf16 before P@V) where the card runs the kernel
# (f32 probabilities), so attention outputs differ by about one bf16 ulp, and
# each such difference can move an int8 activation level of the next integer
# GEMM (at bf16 the float GEMMs add their own rounding differences).
# Measured on an H100 at seed 0: up to 4.4% (starcoder2-3b w8a8), 7.8%
# (codeqwen1.5-7b w4a8), 4.8% (w8a8), 1.4% (bf16); the no-cache forward 0
# at every integer precision and 1.0-1.3% at bf16.  Beyond the bound, the
# greedy token must agree wherever the CPU top-2 margin is more than twice
# the largest difference.
REDUCED_TOL = 0.10
# Phase 4 limits against the CPU in the card's order (C8): the int8-cache
# rows through the decode kernels' plain versions (f32 probabilities, as the
# kernels).  At W8A8 and W4A8 the dense models' card logits must then EQUAL
# the CPU's bit for bit; at bf16 (float GEMMs round in other orders) they
# must lie within CARD_ORDER_TOL of the range, and for zamba2's W8A8
# forward with states (only the f32 scan and conv sum in another order)
# within STATES_TOL.  Measured on an H100 (80GB HBM3, 700 W) over seeds
# 0-2: 0 at every integer precision, up to 1.161% at codeqwen bf16, 4.0e-7
# for zamba2 w8a8 with states.
CARD_ORDER_TOL = 0.02
STATES_TOL = 1e-4
SEEDS = 3              # phase 4's card-order comparison: seeds seed..seed+2


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, ops: float, peak: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """Mean device time of ``fn`` with a cold L2 (a 64 MiB buffer is
    rewritten before each launch, outside the timed events).  A device-side
    sleep first lets the host queue every iteration ahead of the card, so
    the events time the kernels and not the Python launch overhead."""

    def __init__(self, device):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)

    def __call__(self, fn, iters: int = 10, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000 * iters)   # ~1 ms of cycles per iteration
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            pairs.append((e0, e1))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / iters


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def int_mm_ms(timer, x_q, *weights):
    """Time of ``torch._int_mm`` (cuBLAS int8 GEMM, int32 out) of x_q by
    each weight, with the rows zero-padded to 32 when M <= 16 (it refuses
    those); None where K or N is not a multiple of 8 (refused too)."""
    m, k = x_q.shape
    if k % 8 or weights[0].shape[1] % 8:
        return None
    if m <= 16:
        x_q = torch.cat([x_q, x_q.new_zeros(32 - m, k)])
    return timer(lambda: [torch._int_mm(x_q, w) for w in weights])


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def decode_work(kpos, qp, hq, hkv, d, window=0, slot_ids=None,
                pos_bytes=None, dense_rule=True) -> tuple[int, int]:
    """(bytes, operations) a decode attention must move and do on this run's
    data: key positions ``kpos`` (B, S), rows at ``qp`` (B, T), int8 K/V
    with f32 scales.  The positions once (``pos_bytes``, default 4 per key);
    K and V once for every slot valid for some row of its lane (distinct
    ``slot_ids`` where lanes share pages); under the dense rule a row with
    no valid key averages V, so V of every slot of its lane once more; q and
    the bf16 output once; 4 operations per (row, head, d, valid key)."""
    valid = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= qp[:, :, None])
    if window:
        valid &= kpos[:, None, :] > (qp[:, :, None] - window)
    used = valid.any(1)
    ids = (slot_ids if slot_ids is not None else
           torch.arange(kpos.numel(), device=kpos.device).reshape(kpos.shape))
    n_kv = torch.unique(ids[used]).numel()
    v_only = 0
    if dense_rule:
        dead_lane = (~valid.any(2)).any(1)
        v_only = int((dead_lane[:, None] & ~used).sum())
    nbytes = (n_kv * hkv * (2 * d + 8) + v_only * hkv * (d + 4)
              + (4 * kpos.numel() if pos_bytes is None else pos_bytes)
              + 4 * qp.numel() + 2 * 2 * qp.numel() * hq * d)
    return nbytes, 4 * hq * d * int(valid.sum())


def digest(t: torch.Tensor) -> str:
    """SHA-1 of a tensor's bytes on the host: two trees' outputs compared
    bit for bit across processes."""
    return hashlib.sha1(t.detach().contiguous().view(torch.uint8).cpu()
                        .numpy().tobytes()).hexdigest()


def case_recorder(cases: list, digests: bool = False):
    """``record(kernel, shape, err, exact, ms, plain_ms, lib_ms, bound,
    lib_note, out)``: appends one phase 3 case to ``cases`` and logs it;
    with ``digests``, also the SHA-1 of ``out``, the kernel's output."""
    def record(kernel, shape, err, exact, ms, plain_ms, lib_ms, b,
               lib_note=None, out=None):
        cases.append({"kernel": kernel, "shape": shape, "max_abs_err": err,
                      "exact": exact, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms, "library_note": lib_note,
                      "bound_ms": b[0], "bound_by": b[1]})
        if digests and out is not None:
            cases[-1]["sha1"] = digest(out)
        log(f"  {kernel:26s} {shape:44s} err={err:.3g} ms={ms:.4f} "
            f"plain={plain_ms:.4f} lib={lib_ms} bound={b[0]:.4f} ({b[1]})"
            + (f" [library: {lib_note}]" if lib_note else "")
            + (f" sha1={cases[-1]['sha1']}" if "sha1" in cases[-1] else ""))
        return cases[-1]
    return record


def randn_on(dev, gen):
    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale
    return randn


def check_kernels(dev, gen, timer) -> list[dict]:
    cases = []
    record, randn = case_recorder(cases), randn_on(dev, gen)
    check_quantize_rows(dev, gen, timer, record, randn)
    check_int_layernorm(dev, gen, timer, record, randn)
    check_int8_gemm(dev, gen, timer, record, randn)
    check_decode_attention(dev, gen, timer, record, randn)
    check_int4_gemm(dev, gen, timer, record, randn)
    check_dual_int4_gemm_gated(dev, gen, timer, record, randn)
    check_dual_gemm_gated(dev, gen, timer, record, randn)
    check_paged(dev, gen, timer, record, randn)
    check_int8_attention(dev, gen, timer, record, randn)
    check_no_cache(dev, gen, timer, record, randn)
    check_int_library(dev, gen, timer, record, randn)
    check_ssd_scan(dev, gen, timer, record, randn)
    check_decode_rows(dev, gen, timer, record, randn)
    check_experts(dev, gen, timer, record, randn)
    check_window_decode(dev, gen, timer, record, randn)
    check_gqa_xlstm(dev, gen, timer, record, randn)
    check_encdec_xattn(dev, gen, timer, record, randn)
    check_tp_shapes(dev, gen, timer, record, randn)
    check_bf16_gemm(dev, gen, timer, record, randn)
    return cases


# quantize_rows' phase 3 rows beyond the f32 activations: the bf16 rows the
# main path now hands it (o_proj's and down's inputs of both models, 8 decode
# rows and a bucket-256 step) and the KV write's rows of the head dim (8
# lanes x 32 kv heads or x 2 at 128, zamba2's 8 x 32 at 80)
B1_BF16 = ((8, 3072), (8, 4096), (8, 12288), (8, 13440), (256, 4096),
           (256, 128), (16, 128), (256, 80))


def bytes_of(outs) -> torch.Tensor:
    """The bytes of several outputs in one tensor, for one digest."""
    return torch.cat([t.contiguous().view(torch.uint8).flatten() for t in outs])


def check_quantize_rows(dev, gen, timer, record, randn) -> None:
    """B1 on the card, bit-exact against its plain version: f32 rows of
    starcoder2-3b's and codeqwen1.5-7b's activation widths (an all-zero
    row takes the 1e-8 floor), and bf16 rows (``B1_BF16``), which must also
    give the f32 path's bits.  Bound: each input byte read once, one int8
    an element and one f32 a row written."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.quantize import quantize_rows_ref
    no_lib = "no PyTorch call computes it"

    def same(what, got, *wants):
        torch.cuda.synchronize()
        for want in wants:
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"quantize_rows {what} differs")
        return got

    for dtype, shapes in ((torch.float32, [(m, d) for m in (8, 256)
                                           for d in (3072, 12288, 4096,
                                                     13440)]),
                          (torch.bfloat16, B1_BF16)):
        name = "f32" if dtype == torch.float32 else "bf16"
        for m, d in shapes:
            x = randn(m, d, scale=3.0).to(dtype)
            x[0] = 0.0                      # the 1e-8 floor
            wants = [quantize_rows_ref(x)]
            if dtype == torch.bfloat16:
                wants.append(ops.quant_rows(x.float()))
            got = same(f"[{m},{d}] {name}", ops.quant_rows(x), *wants)
            record("quantize_rows", f"[{m},{d}] {name}", 0.0, True,
                   timer(lambda: ops.quant_rows(x)),
                   timer(lambda: quantize_rows_ref(x)), None,
                   bound(m * d * (x.element_size() + 1) + m * 4, 3 * m * d,
                         F32_OPS), no_lib,
                   out=bytes_of(got))


# the models' norms at full width: (label, D, rms_only)
NORMS = (("starcoder", 3072, False), ("codeqwen", 4096, True),
         ("zamba2", 2560, True))
NORM_ROWS = (8, 256, 4096)


def norm_inputs(randn, m, d, rms, spike: bool = False):
    """bf16 residual-stream rows (an all-zero row, a row of negative mean;
    with ``spike``, the rows after those hold one value at column 77 and
    zeros, where gamma is largest, so that at D = 16384 the norm output
    passes 2^24) and a norm's integer constants (``layers.quantize_norm`` of
    random gamma and, for LayerNorm, beta)."""
    from repro_torch.models.layers import quantize_norm
    x = randn(m, d, scale=3.0)
    gamma = randn(d, scale=0.5) + 1.0
    if spike:
        x[2:] = 0.0
        x[2:, 77] = 5.0
        gamma[77] = 8.0
    x[0] = 0.0
    x[1] -= 4.0
    beta = None if rms else randn(d, scale=0.2)
    return x.to(torch.bfloat16), quantize_norm(gamma, beta)


def norm_chain(x, g_q, b_q, gb_s, rms):
    """The norm as the standalone kernels compute it: B1, B9 on the int32
    payload, the dequant, the cast, B1 again (``ops.quant_rows`` and
    ``ops.layernorm_i8``, in any tree of the port; the constant 2^-7 built
    outside, so that only device work is timed)."""
    from repro_torch.kernels import ops
    step = gb_s * 2.0 ** -7
    xq, _ = ops.quant_rows(x)
    out = ops.layernorm_i8(xq.to(torch.int32), g_q, b_q, rms_only=rms)
    h = (out.float() * step).to(x.dtype)
    hq, hs = ops.quant_rows(h)
    return h, hq, hs


def check_int_layernorm(dev, gen, timer, record, randn) -> None:
    """B9 on the card, bit-exact: the integer library's form on int32 rows
    (starcoder2-3b's LayerNorm and both models' RMSNorm widths, a row of
    negative mean), then the models' fused norm -> quantize form
    (``ops.norm_quant_rows``) at every norm of ``NORMS`` for ``NORM_ROWS``
    bf16 rows, ``torch.equal`` to its plain version and to the chain of
    standalone kernels (``norm_chain``), timed beside both and its bound
    (bf16 in and out, one int8 an element, one f32 a row, gamma and for
    LayerNorm beta once);
    and at D = 16384, where a lone spike's norm output passes 2^24.  A tree
    without the fused form (``--src`` of an older tree) times its chain."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.int_layernorm import int_layernorm_ref
    no_lib = "no PyTorch call computes it"
    fused = hasattr(ops, "norm_quant_rows")
    for m in (8, 256):
        for d, rms in ((3072, False), (3072, True), (4096, True)):
            x = torch.randint(-128, 128, (m, d), generator=gen, device=dev,
                              dtype=torch.int32)
            x[1] -= 100                       # a row with a negative mean
            g = torch.randint(-128, 128, (d,), generator=gen, device=dev,
                              dtype=torch.int32)
            b = torch.randint(-128, 128, (d,), generator=gen, device=dev,
                              dtype=torch.int32)
            out = ops.layernorm_i8(x, g, b, rms_only=rms)
            ref = int_layernorm_ref(x, g, b, rms_only=rms)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise AssertionError(f"int_layernorm [{m},{d}] rms={rms} "
                                     f"differs from its plain version")
            record("int_layernorm", f"[{m},{d}] {'rms' if rms else 'ln'}",
                   0.0, True, timer(lambda: ops.layernorm_i8(x, g, b, rms)),
                   timer(lambda: int_layernorm_ref(x, g, b, rms)), None,
                   bound(8 * m * d + 8 * d, 12 * m * d, F32_OPS), no_lib,
                   out=out)

    cases = [(label, m, d, rms) for label, d, rms in NORMS for m in NORM_ROWS]
    cases.append(("spike", 8, 16384, True))
    for label, m, d, rms in cases:
        x, (g_q, b_q, gb_s) = norm_inputs(randn, m, d, rms, label == "spike")
        kind = "rms" if rms else "ln"
        chain = norm_chain(x, g_q, b_q, gb_s, rms)
        torch.cuda.synchronize()
        # bf16 in and out and int8 out an element, one f32 a row, gamma
        # (and beta, which RMSNorm never reads) once, gb_s
        b = bound(m * d * 5 + m * 4 + (4 if rms else 8) * d + 4, 40 * m * d,
                  F32_OPS)
        chain_ms = timer(lambda: norm_chain(x, g_q, b_q, gb_s, rms))
        record("int_layernorm", f"chain {label} [{m},{d}] {kind} bf16", 0.0,
               True, chain_ms, chain_ms, None, b, "the chain of standalone "
               "kernels: B1, B9, dequant, cast, B1", out=bytes_of(chain))
        if not fused:
            continue
        from repro_torch.kernels.int_layernorm import int_layernorm_rows_ref
        got = ops.norm_quant_rows(x, g_q, b_q, gb_s, rms)
        plain = int_layernorm_rows_ref(x, g_q, b_q, gb_s, rms)
        torch.cuda.synchronize()
        for what, want in (("plain version", plain), ("chain", chain)):
            if not all(torch.equal(a, w) for a, w in zip(got, want)):
                raise AssertionError(f"int_layernorm fused {label} [{m},{d}] "
                                     f"differs from its {what}")
        c = record("int_layernorm", f"fused {label} [{m},{d}] {kind} bf16",
                   0.0, True,
                   timer(lambda: ops.norm_quant_rows(x, g_q, b_q, gb_s, rms)),
                   timer(lambda: int_layernorm_rows_ref(x, g_q, b_q, gb_s,
                                                        rms)),
                   None, b, no_lib, out=bytes_of(got))
        c["chain_ms"] = chain_ms
    if fused:
        check_norm_refusals(dev)


def check_norm_refusals(dev) -> None:
    """Rows the fused form cannot hold in registers (D not a multiple of
    16 bytes, past 2048 chunks, or off a 16-byte address) make it raise and
    launch nothing, while B1 on the same rows keeps its plain version's
    bits."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.quantize import quantize_rows_ref
    from repro_torch.models.layers import Norm
    for d, dtype, shift in ((100, torch.bfloat16, 0),
                            (16384 + 8, torch.bfloat16, 0),
                            (8192 + 4, torch.float32, 0),
                            (4096, torch.bfloat16, 1)):
        x = torch.ones(2 * d + shift, dtype=dtype, device=dev)[shift:]
        x = x.view(2, d)
        consts = [t.to(dev) for t in Norm(d, "rmsnorm").int_consts()]
        before = ops.launch_counts().get("int_layernorm", 0)
        try:
            ops.norm_quant_rows(x, *consts, True)
        except ValueError:
            pass
        else:
            raise AssertionError(f"int_layernorm fused form took {dtype} "
                                 f"rows of D = {d} (offset {shift})")
        if ops.launch_counts().get("int_layernorm", 0) != before:
            raise AssertionError("a refused fused norm counted a launch")
        got = ops.quant_rows(x)
        torch.cuda.synchronize()
        if not all(torch.equal(a, w) for a, w in zip(got,
                                                     quantize_rows_ref(x))):
            raise AssertionError(f"quantize_rows [2,{d}] offset {shift} "
                                 f"differs from its plain version")


# int8_gemm's phase 3 shapes (name, K, N, epilogue, bias, stream dtype,
# rows): the W8A8 projections of starcoder2-3b (q and kv with bias, o with
# the residual, the GELU up-projection, down) and codeqwen1.5-7b (q with
# bias, o with the residual, down, the f32 head) at one decode row per lane
# (M = 8), bucket-64 and -256 prefill steps and the no-cache forward's
# 4 x 1024 rows; starcoder's f32 head; a ragged case through the byte loads
GEMM_ROWS = (8, 64, 256, 4096)
I8_SHAPES = (("q_proj+bias", 3072, 3072, "scaled", True, torch.bfloat16,
              GEMM_ROWS),
             ("kv_proj+bias", 3072, 256, "scaled", True, torch.bfloat16,
              GEMM_ROWS),
             ("o_proj+residual", 3072, 3072, "scaled_add", False,
              torch.bfloat16, GEMM_ROWS),
             ("mlp_up+gelu", 3072, 12288, "scaled_gelu", False,
              torch.bfloat16, GEMM_ROWS),
             ("mlp_down", 12288, 3072, "scaled", False, torch.bfloat16,
              GEMM_ROWS),
             ("head_f32", 3072, 49152, "scaled", False, torch.float32,
              (8, 256)),
             ("codeqwen q_proj+bias", 4096, 4096, "scaled", True,
              torch.bfloat16, GEMM_ROWS),
             ("codeqwen o_proj+residual", 4096, 4096, "scaled_add", False,
              torch.bfloat16, GEMM_ROWS),
             ("codeqwen mlp_down", 13440, 4096, "scaled", False,
              torch.bfloat16, GEMM_ROWS),
             ("codeqwen head_f32", 4096, 92416, "scaled", False,
              torch.float32, GEMM_ROWS),
             ("ragged+bias", 100, 70, "scaled_add", True, torch.bfloat16,
              (5, 37)))
# the integer library's Table II shapes (the paper's benchmark: a 3x128x128
# image and 8 3x3x3 filters; a [32, 64] x [64, 32] GEMM) and full widths
TABLE2_CONV = (1, 128, 128, 3, 3, 3, 8)
TABLE2_GEMM = (32, 64, 32)


def check_int8_gemm(dev, gen, timer, record, randn, shapes=I8_SHAPES,
                    extras: bool = True) -> None:
    """Phase 3's int8_gemm cases, every one ``torch.equal`` to its plain
    version: the serving and scoring paths' projections (``I8_SHAPES``),
    each beside the ``none`` epilogue (the int32 sums) at the same shape,
    timed with ``torch._int_mm`` (rows padded to 32 at M <= 16: the same
    function as ``none``, not as the fused epilogues); then the requant
    family (requant, requant_gelu, requant_add: the integer-in,
    integer-out GEMM of Table II) at Table II's [32, 64] x [64, 32] and at
    starcoder2-3b's MLP up-projection over 4096 rows.  With ``extras``
    False only ``shapes``' fused cases run (no ``none`` twin, no requant
    family)."""
    from repro_torch.core.inumerics import compute_requant_params
    from repro_torch.kernels import ops
    from repro_torch.kernels.int8_gemm import (
        gemm_w8a8_ref, int8_gemm, int8_gemm_add_ref, int8_gemm_gelu_ref,
        int8_gemm_ref, int8_matmul_ref)
    from repro_torch.kernels.quantize import quantize_rows_ref
    from repro_torch.models.layers import GELU_INT_SCALE, quantize_weight

    def exact(what, out, ref):
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(
                f"int8_gemm {what}: {int((out != ref).sum())} of "
                f"{out.numel()} differ from the plain version (max |d| "
                f"{max_err(out, ref)})")

    for name, k, n, epi, has_bias, out_dtype, rows in shapes:
        wd = quantize_weight(randn(k, n, scale=k ** -0.5))
        w_q, w_s = wd["w_q"], wd["scale"]
        bias = randn(n, scale=0.1) if has_bias else None
        for m in rows:
            x_q, x_s = quantize_rows_ref(randn(m, k))
            res = (randn(m, n).to(out_dtype) if epi == "scaled_add" else None)
            gs = GELU_INT_SCALE if epi == "scaled_gelu" else None

            def run():
                return ops.gemm_w8a8(x_q, x_s, w_q, w_s, bias=bias,
                                     residual=res, gelu_scale=gs,
                                     out_dtype=out_dtype)

            def plain():
                return by_rows(lambda r0, r1: gemm_w8a8_ref(
                    x_q[r0:r1], x_s[r0:r1], w_q, w_s, bias=bias,
                    residual=None if res is None else res[r0:r1],
                    gelu_scale=gs, out_dtype=out_dtype), m)
            out = run()
            exact(f"{name} M={m}", out, plain())
            lib = int_mm_ms(timer, x_q, w_q)
            nbytes = (m * k + k * n + 4 * (m + n) + (4 * n if has_bias else 0)
                      + (res.numel() * res.element_size() if res is not None
                         else 0) + m * n * out.element_size())
            slow = m > PLAIN_ROWS
            record("int8_gemm", f"{name} [{m},{k}]x[{k},{n}] {epi}", 0.0, True,
                   timer(run), timer(plain, iters=3, warmup=1) if slow
                   else timer(plain), lib,
                   bound(nbytes, 2 * m * n * k, INT8_OPS),
                   "torch._int_mm, int32 out: not the same function", out)
            del out
            if not extras:
                continue
            # the int32 sums alone, the function torch._int_mm computes
            acc = int8_gemm(x_q, w_q)
            exact(f"{name} none M={m}", acc,
                  by_rows(lambda r0, r1: int8_matmul_ref(x_q[r0:r1], w_q), m))
            record("int8_gemm", f"{name} [{m},{k}]x[{k},{n}] none", 0.0, True,
                   timer(lambda: int8_gemm(x_q, w_q)),
                   timer(lambda: int8_matmul_ref(x_q, w_q), iters=3,
                         warmup=1) if slow
                   else timer(lambda: int8_matmul_ref(x_q, w_q)), lib,
                   bound(m * k + k * n + 4 * m * n, 2 * m * n * k, INT8_OPS),
                   "torch._int_mm: the same function", acc)
            del acc
        del w_q, w_s
        torch.cuda.empty_cache()
    if not extras:
        return

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int8)
    for m, k, n in (TABLE2_GEMM, (4096, 3072, 12288)):
        x, w, r = ints(-128, 128, m, k), ints(-128, 128, k, n), ints(
            -128, 128, m, n)
        rq = compute_requant_params(1 / (127 * k ** 0.5),
                                    acc_bound=k * 127 * 127)
        lib = int_mm_ms(timer, x, w)
        for epi, run, plain, extra in (
                ("requant", lambda: ops.gemm_i8(x, w, rq),
                 lambda: int8_gemm_ref(x, w, rq), 0),
                ("requant_gelu", lambda: ops.gemm_i8_gelu(x, w, GELU_INT_SCALE),
                 lambda: int8_gemm_gelu_ref(x, w, GELU_INT_SCALE), 0),
                ("requant_add", lambda: ops.gemm_i8_add(x, w, rq, r),
                 lambda: int8_gemm_add_ref(x, w, rq, r), m * n)):
            out = run()
            exact(f"{epi} [{m},{k}]x[{k},{n}]", out, plain())
            record("int8_gemm", f"[{m},{k}]x[{k},{n}] {epi}", 0.0, True,
                   timer(run), timer(plain, iters=3, warmup=1), lib,
                   bound(m * k + k * n + extra + m * n, 2 * m * n * k,
                         INT8_OPS), "torch._int_mm, int32 out: not the same "
                   "function", out)
        del x, w, r


DECODE_SHAPES = ((8, 1024, 24, 2, 128, (0, 100)), (8, 1024, 32, 32, 128, (0,)))


def check_decode_attention(dev, gen, timer, record, randn,
                           shapes=DECODE_SHAPES) -> None:
    """Phase 3's int8_kv_decode_attention cases at T = 1: starcoder2-3b's
    GQA (G = 12, without and with a window) and codeqwen1.5-7b's MHA
    (G = 1) over 8 lanes of 1024 slots, each lane filled to a random
    length and lane 3 idle (every slot masked: the mean of V), within
    RTOL/ATOL of the plain version, timed beside SDPA over K/V dequantized
    to bf16 ahead of time (not the same function)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.int8_kv_decode_attention import (
        ATOL, RTOL, int8_kv_decode_attention_ref)
    from repro_torch.models.attention import _quant_kv
    for bsz, s, hq, hkv, d, windows in shapes:
        k_q, k_s = _quant_kv(randn(bsz, s, hkv, d))
        v_q, v_s = _quant_kv(randn(bsz, s, hkv, d))
        fill = torch.randint(1, s + 1, (bsz,), generator=gen, device=dev)
        fill[3] = 0                          # an idle lane: every slot masked
        slot = torch.arange(s, device=dev)
        pos = torch.where(slot[None] < fill[:, None], slot[None],
                          -1).to(torch.int32)
        qpos = (fill - 1).to(torch.int32)
        q = randn(bsz, hq, d).to(torch.bfloat16)
        for window in windows:
            def run():
                return ops.decode_attention_int8kv(q, k_q, k_s, v_q, v_s, pos,
                                                   qpos, window=window)

            def plain():
                return int8_kv_decode_attention_ref(q, k_q, k_s, v_q, v_s,
                                                    pos, qpos, window=window)
            out, ref = run(), plain()
            torch.cuda.synchronize()
            if not torch.allclose(out.float(), ref.float(), rtol=RTOL,
                                  atol=ATOL):
                raise AssertionError(
                    f"decode attention Hq={hq} Hkv={hkv} window={window}: "
                    f"max |d| {max_err(out, ref)} beyond rtol={RTOL} "
                    f"atol={ATOL}")
            if not torch.isfinite(out).all():
                raise AssertionError("decode attention produced non-finite "
                                     "values")
            # yardstick: SDPA over K/V dequantized to bf16 ahead of time
            kd = (k_q.float() * k_s).to(torch.bfloat16).permute(0, 2, 1, 3)
            vd = (v_q.float() * v_s).to(torch.bfloat16).permute(0, 2, 1, 3)
            kd = kd.repeat_interleave(hq // hkv, 1).contiguous()
            vd = vd.repeat_interleave(hq // hkv, 1).contiguous()
            valid = (pos >= 0) & (pos <= qpos[:, None])
            if window:
                valid &= pos > (qpos[:, None] - window)
            mask = valid[:, None, None, :]
            q4 = q[:, :, None, :]
            lib = timer(lambda: torch.nn.functional.scaled_dot_product_attention(
                q4, kd, vd, attn_mask=mask))
            record("int8_kv_decode_attention",
                   f"B={bsz} S={s} Hq={hq} Hkv={hkv} D={d} window={window}",
                   max_err(out, ref), False, timer(run), timer(plain), lib,
                   bound(*decode_work(pos, qpos[:, None], hq, hkv, d, window),
                         F32_OPS), out=out)


# the no-cache forward's attention shapes: 4 sequences of 1024 tokens
NC_B, NC_T = 4, 1024
# (label, heads, kv heads, head dim) of codeqwen1.5-7b (MHA), starcoder2-3b
# (GQA) and zamba2-2.7b's shared attention (MHA at head dim 80)
NC_HEADS = (("codeqwen", 32, 32, 128), ("starcoder", 24, 2, 128),
            ("zamba2", 32, 32, 80))


def int_attention_inputs(randn, h, hkv, b=NC_B, t=NC_T, d=128):
    """int8 q/k/v and per-(token, head) V scales as ``_int_attention``
    makes them from bf16 activations (q, k at the static 1/16 scale), with a
    saturated query row against one aligned key: its scores spread far past
    30*q_ln2 below the row max."""
    from repro_torch.models.attention import ATTN_INT_SCALE, _quant_kv

    def static_int8(*shape):
        x = randn(*shape) / ATTN_INT_SCALE
        return torch.clamp(torch.round(x), -128, 127).to(torch.int8)
    q, k = static_int8(b, h, t, d), static_int8(b, hkv, t, d)
    q[0, 0, t * 7 // 10] = 127
    k[0, 0, t * 3 // 10] = 127
    v, v_s = _quant_kv(randn(b, t, hkv, d))
    return q, k, v.transpose(1, 2).contiguous(), v_s.transpose(1, 2).contiguous()


def check_int8_attention(dev, gen, timer, record, randn, heads=NC_HEADS,
                         streaming: bool = True, t: int = NC_T) -> None:
    """Phase 3 for int8_flash_attention at B = 4, T = 1024 (codeqwen1.5-7b's
    and starcoder2-3b's heads and zamba2-2.7b's head dim 80, ROADMAP C7),
    then at 4096 and 8192 keys (``check_streaming_attention``): the integer
    probabilities (the kernel's debug output) and the int32 form bit-exact,
    each recorded with its output (``--kernels`` digests them: equal to the
    parent tree's); the f32 output of the v_scale form within RTOL/ATOL,
    its max |d| reported.  Bounds: bytes over 3.35 TB/s against the
    operations — QK^T at the int8 rate and PV at the f32 rate (the int32
    form's PV at the int8 rate) — each pair counted once over the causal
    triangle."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.int8_flash_attention import (
        ATOL, RTOL, int8_attention_probs_ref, int8_flash_attention,
        int8_flash_attention_ref)
    from repro_torch.models.attention import int_score_scale
    b = NC_B
    pairs = t * (t + 1) // 2                        # causal (query, key) pairs
    for label, h, hkv, d in heads:
        sc = int_score_scale(d)
        q, k, v, v_s = int_attention_inputs(randn, h, hkv, t=t, d=d)
        p_out = torch.empty((b, h, t, t), dtype=torch.int8, device=dev)
        out = int8_flash_attention(q, k, v, sc, v_scale=v_s, p_out=p_out)
        probs = int8_attention_probs_ref(q, k, sc)
        torch.cuda.synchronize()
        what = f"int8_flash_attention {label} B={b} T={t} H={h} Hkv={hkv}"
        if not torch.equal(p_out.int(), probs):
            raise AssertionError(f"{what}: {int((p_out.int() != probs).sum())}"
                                 f" integer probabilities differ from the "
                                 f"plain version's")
        record("int8_flash_attention", f"probs {label} B={b} T={t} H={h} "
               f"Hkv={hkv} D={d}", 0.0, True, 0.0, 0.0, None, (0.0, "bytes"),
               "the debug output, not timed", p_out)
        del p_out, probs

        def run():
            return ops.attention_i8(q, k, v, sc, v_scale=v_s)

        def plain():
            return int8_flash_attention_ref(q, k, v, sc, v_scale=v_s)
        ref = plain()
        torch.cuda.synchronize()
        if not (torch.isfinite(out).all() and torch.allclose(
                out, ref, rtol=RTOL, atol=ATOL)):
            raise AssertionError(f"{what}: max |d| {max_err(out, ref)} beyond "
                                 f"rtol={RTOL} atol={ATOL}")
        qk_ops = 2 * b * h * pairs * d
        io = q.numel() + k.numel() + v.numel() + 4 * v_s.numel()
        record("int8_flash_attention", f"v_scale {label} B={b} T={t} H={h} "
               f"Hkv={hkv} D={d}", max_err(out, ref), False, timer(run),
               timer(plain, iters=3, warmup=1), None,
               bound(io + 4 * out.numel(),
                     qk_ops * F32_OPS / INT8_OPS + qk_ops, F32_OPS),
               None, out)
        del out, ref
        if label == "starcoder":
            continue

        def run32():
            return ops.attention_i8(q, k, v, sc)

        def plain32():
            return int8_flash_attention_ref(q, k, v, sc)
        out, ref = run32(), plain32()
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"int8_flash_attention int32 form {label}: "
                                 f"{int((out != ref).sum())} of {out.numel()} "
                                 f"differ from the plain version")
        record("int8_flash_attention", f"int32 {label} B={b} T={t} H={h} "
               f"Hkv={hkv} D={d}", 0.0, True, timer(run32),
               timer(plain32, iters=3, warmup=1), None,
               bound(q.numel() + k.numel() + v.numel() + 4 * out.numel(),
                     2 * qk_ops, INT8_OPS), None, out)
        del out, ref
    if streaming:
        check_streaming_attention(dev, gen, timer, record, randn)


def check_no_cache(dev, gen, timer, record, randn) -> None:
    """Phase 3 for the no-cache forward's other kernels at B = 4, T = 1024:
    flash_attention (``check_flash_attention``) at codeqwen1.5-7b's,
    starcoder2-3b's and zamba2-2.7b's heads, and int_softmax
    (``check_int_softmax``)."""
    check_flash_attention(dev, gen, timer, record, randn)
    check_int_softmax(dev, gen, timer, record, randn)


LONG_ROWS = (64, 2 ** 17)   # int_softmax's long-row form at its longest rows


def check_int_softmax(dev, gen, timer, record, randn) -> None:
    """int_softmax's phase 3 cases, each bit-exact against its plain
    version and timed through ``ops.softmax_i8`` as a user calls it: [4096,
    1024] int32 rows (B = 4 sequences of T = 1024 scores) without a mask,
    with a materialized causal mask, with rows spread far past 30*q_ln2, with
    the [T, T] keep mask broadcast over [4, T, T] as ``softmax_entry`` passes
    it, and as an int8 payload; then the long-row form at [64, 2^17].
    Bound: bytes (the payload, the mask once, the int8 out; about 15
    integer operations a value at the f32 rate)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.int_softmax import int_softmax_ref
    from repro_torch.models.attention import int_score_scale
    sc = int_score_scale(128)
    m, n = NC_B * NC_T, NC_T
    x = torch.randint(-3000, 3000, (m, n), generator=gen, device=dev,
                      dtype=torch.int32)
    wide = torch.randint(-2 ** 20, 2 ** 20, (m, n), generator=gen, device=dev,
                         dtype=torch.int32)
    wide[::7, 9] = 129032                     # a saturated score in each row
    x8 = torch.randint(-128, 128, (m, n), generator=gen, device=dev,
                       dtype=torch.int8)
    tri = torch.ones((n, n), dtype=torch.bool, device=dev).tril()
    keep = tri.repeat(NC_B, 1)                # causal rows of 4 sequences
    lr, ln = LONG_ROWS
    long = torch.randint(-3000, 3000, (lr, ln), generator=gen, device=dev,
                         dtype=torch.int32)
    # (name, x as the caller shapes it, its mask, the materialized [M, N]
    # mask of the plain version, scale, mask bytes the kernel must read)
    for name, xs, mask, full, scale, mask_bytes in (
            ("int32", x, None, None, sc, 0),
            ("int32 causal mask", x, keep, keep, sc, m * n),
            ("int32 wide spread", wide, None, None, sc, 0),
            ("int32 broadcast mask", x.view(NC_B, n, n), tri, keep, sc, n * n),
            ("int8", x8, None, None, 0.05, 0),
            ("int32 long rows", long, None, None, sc, 0)):
        rows, cols = xs.numel() // xs.shape[-1], xs.shape[-1]

        def run():
            return ops.softmax_i8(xs, scale, mask)

        def plain():
            return int_softmax_ref(xs.reshape(rows, cols), scale, full)
        out, ref = run(), plain()
        torch.cuda.synchronize()
        if not torch.equal(out.reshape(rows, cols), ref):
            raise AssertionError(f"int_softmax {name}: {int((out.reshape(rows, cols) != ref).sum())}"
                                 f" of {out.numel()} differ from the plain "
                                 f"version")
        record("int_softmax", f"[{rows},{cols}] {name}", 0.0, True, timer(run),
               timer(plain), None,
               bound(rows * cols * (xs.element_size() + 1) + mask_bytes,
                     15 * rows * cols, F32_OPS), out=out)


def check_flash_attention(dev, gen, timer, record, randn, heads=NC_HEADS,
                          t: int = NC_T) -> None:
    """Phase 3's flash_attention cases (bf16, causal, B = 4, T = 1024) at
    codeqwen1.5-7b's, starcoder2-3b's and zamba2-2.7b's heads: within
    RTOL/ATOL of the plain version, timed beside SDPA over K/V repeated to
    every head and the bound (bytes against both products at the bf16
    rate, each pair counted once over the causal triangle)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (
        ATOL as FA_ATOL, RTOL as FA_RTOL, flash_attention_ref)
    b = NC_B
    pairs = t * (t + 1) // 2                        # causal (query, key) pairs
    for label, h, hkv, d in heads:
        q = randn(b, h, t, d).to(torch.bfloat16)
        k = randn(b, hkv, t, d).to(torch.bfloat16)
        v = randn(b, hkv, t, d).to(torch.bfloat16)

        def run():
            return ops.attention(q, k, v)

        def plain():
            return flash_attention_ref(q, k, v)
        out, ref = run(), plain()
        torch.cuda.synchronize()
        if not (torch.isfinite(out).all() and torch.allclose(
                out.float(), ref.float(), rtol=FA_RTOL, atol=FA_ATOL)):
            raise AssertionError(f"flash_attention {label}: max |d| "
                                 f"{max_err(out, ref)} beyond rtol={FA_RTOL} "
                                 f"atol={FA_ATOL}")
        # yardstick: SDPA, causal, K/V repeated to every head beforehand
        kr = k.repeat_interleave(h // hkv, 1).contiguous()
        vr = v.repeat_interleave(h // hkv, 1).contiguous()
        lib = timer(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, kr, vr, is_causal=True))
        record("flash_attention", f"bf16 {label} B={b} T={t} H={h} Hkv={hkv} "
               f"D={d}", max_err(out, ref), False, timer(run),
               timer(plain, iters=3, warmup=1), lib,
               bound(2 * (q.numel() + k.numel() + v.numel() + out.numel()),
                     4 * b * h * pairs * d, BF16_OPS))
        del out, ref, kr, vr


# zamba2-2.7b's no-cache forward (phase 6): the Mamba-2 scan of 4 x 1024
# tokens (80 heads of P = 64, N = 64, chunk 128)
Z_B, Z_T, Z_H, Z_P, Z_N, Z_L = 4, 1024, 80, 64, 64, 128


def ssd_scan_work(b, t, h, p, n, chunk) -> tuple[int, int]:
    """(bytes, operations) the scan must move and do: x, dt, B, C and A read
    once, y and the final state written once; per (lane, chunk) C.B^T over
    the causal triangle, per (lane, head, chunk) the weights times x over
    the triangle, C times the state and the state update (2 per
    multiply-add)."""
    nbytes = 4 * (2 * b * t * h * p + b * t * h + 2 * b * t * n + h
                  + b * h * n * p)
    nc, tri = t // chunk, chunk * (chunk + 1) // 2
    ops = b * nc * 2 * tri * n + b * h * nc * (2 * tri * p + 4 * chunk * n * p)
    return nbytes, ops


def check_ssd_scan(dev, gen, timer, record, randn) -> None:
    """Phase 3 for ssd_scan at zamba2-2.7b's forward shape and at the
    reduced model's (P, N) = (64, 16) against its plain version evaluated
    in f64 (its arithmetic in its order): two f32 scans over 1024 steps,
    each within the tolerance of it, can differ from each other by more,
    at small outputs where large terms cancel: y and the final state within
    rtol = atol = 3e-4,
    with the model's A = -exp(log(linspace(1, 16, H))) and dt as softplus
    gives it; timed beside its bound (``ssd_scan_work``) and the plain
    version in f32."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import (ATOL, RTOL, ssd_scan_ref)
    # zamba2-2.7b's shape, then the reduced model's (P, N) = (64, 16)
    for b, t, h, p, n in ((Z_B, Z_T, Z_H, Z_P, Z_N), (4, 512, 2, 64, 16)):
        x = randn(b, t, h, p)
        dt = torch.nn.functional.softplus(randn(b, t, h) - 1.0)
        a = -torch.linspace(1.0, 16.0, h, device=dev)
        bm, cm = randn(b, t, n), randn(b, t, n)

        def run():
            return ops.ssd_scan(x, dt, a, bm, cm)

        def plain():
            return ssd_scan_ref(x, dt, a, bm, cm)
        y, st = run()
        yr, sr = (v.float() for v in ssd_scan_ref(
            *(v.double() for v in (x, dt, a, bm, cm))))
        torch.cuda.synchronize()
        for what, got, want in (("y", y, yr), ("final state", st, sr)):
            if not (torch.isfinite(got).all() and torch.allclose(
                    got, want, rtol=RTOL, atol=ATOL)):
                raise AssertionError(f"ssd_scan N={n} {what}: max |d| "
                                     f"{max_err(got, want)} beyond "
                                     f"rtol={RTOL} atol={ATOL}")
        nbytes, n_ops = ssd_scan_work(b, t, h, p, n, Z_L)
        record("ssd_scan", f"B={b} T={t} H={h} P={p} N={n} L={Z_L}",
               max(max_err(y, yr), max_err(st, sr)), False, timer(run),
               timer(plain, iters=3, warmup=1), None,
               bound(nbytes, n_ops, F32_OPS),
               "no PyTorch call computes the SSD scan", bytes_of([y, st]))


# the multi-row decode form (ROADMAP C3): a packed step of T rows per lane at
# the serving cells' widths (8 lanes, 1024 slots), each row against the
# cache up to its own position
ROWS_T = 256


def check_decode_rows(dev, gen, timer, record, randn,
                      forms=(False, True),
                      heads=((32, 32, 128), (24, 2, 128))) -> None:
    """Phase 3 for the decode kernels' multi-row form, dense and paged
    (``forms``: False dense, True paged), at codeqwen1.5-7b's heads (G = 1) and starcoder2-3b's (G = 12): every row
    of a T = 256 launch bit-equal to a T = 1 launch of the same kernel at
    that row's position with the same B (the contract: a lane's tokens do
    not depend on how its steps were batched), and the whole within
    RTOL/ATOL of the plain version.  Each lane's rows sit at the end of its
    filled span; lane 3's rows are idle (position -1)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.int8_kv_decode_attention import (
        ATOL, RTOL, int8_kv_decode_attention_rows_ref)
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention_rows_ref)
    from repro_torch.models.attention import _quant_kv
    tr = ROWS_T
    for paged in forms:
        for hq, hkv, d in heads:
            if paged:
                arena, ppos, pt, last = paged_arena(dev, gen, randn, hkv, d,
                                                    True)
                args = (arena["pk"], arena["pks"], arena["pv"], arena["pvs"],
                        ppos, pt)
                b = PAGED_B
                one, rows = ops.paged_attention_decode, ops.paged_attention_decode_rows
                plain_rows = paged_decode_attention_rows_ref
            else:
                b, s = 8, 1024
                k_q, k_s = _quant_kv(randn(b, s, hkv, d))
                v_q, v_s = _quant_kv(randn(b, s, hkv, d))
                fill = torch.randint(tr, s + 1, (b,), generator=gen, device=dev)
                fill[IDLE_LANE] = 0
                slot = torch.arange(s, device=dev)
                pos = torch.where(slot[None] < fill[:, None], slot[None],
                                  -1).to(torch.int32)
                last = (fill - 1).to(torch.int32)
                args = (k_q, k_s, v_q, v_s, pos)
                one, rows = ops.decode_attention_int8kv, ops.decode_attention_int8kv_rows
                plain_rows = int8_kv_decode_attention_rows_ref
            qp = (last[:, None] - torch.arange(tr - 1, -1, -1, device=dev,
                                               dtype=torch.int32)[None])
            qp = torch.where((last[:, None] >= 0) & (qp >= 0), qp,
                             -1).to(torch.int32).contiguous()
            q = randn(b, tr, hq, d).to(torch.bfloat16)
            out = rows(q, *args, qp)
            torch.cuda.synchronize()
            what = (f"{'paged' if paged else 'dense'} decode rows T={tr} "
                    f"Hq={hq} Hkv={hkv}")
            for i in range(tr):
                ref1 = one(q[:, i].contiguous(), *args, qp[:, i].contiguous())
                if not torch.equal(out[:, i], ref1):
                    raise AssertionError(
                        f"{what}: row {i} differs from a T = 1 launch at its "
                        f"position (max |d| {max_err(out[:, i], ref1)})")
            ref = plain_rows(q, *args, qp)
            torch.cuda.synchronize()
            live = qp >= 0
            if not (torch.isfinite(out).all() and torch.allclose(
                    out[live].float(), ref[live].float(), rtol=RTOL,
                    atol=ATOL)):
                raise AssertionError(f"{what}: max |d| {max_err(out, ref)} "
                                     f"beyond rtol={RTOL} atol={ATOL}")
            # this run's data: the slots some row of the lane needs, once
            if paged:
                ptc = pt.long()
                kpos = ppos[ptc].reshape(b, -1)
                work = decode_work(
                    kpos, qp, hq, hkv, d, slot_ids=(ptc[:, :, None] * PAGED_PS
                                                    + torch.arange(PAGED_PS, device=dev)
                                                    ).reshape(b, -1),
                    pos_bytes=4 * PAGED_PS * torch.unique(ptc[ptc > 0]).numel(),
                    dense_rule=False)
            else:
                kpos = args[4]
                work = decode_work(kpos, qp, hq, hkv, d)
            span = kpos.shape[1]
            record("paged_decode_attention" if paged
                   else "int8_kv_decode_attention",
                   f"rows T={tr} B={b} S={span} Hq={hq} Hkv={hkv} D={d}",
                   max_err(out[live], ref[live]), False,
                   timer(lambda: rows(q, *args, qp), iters=5),
                   timer(lambda: plain_rows(q, *args, qp), iters=1, warmup=0),
                   None, bound(*work, F32_OPS),
                   "bit-equal row by row to T = 1 launches", out)
            del out, ref
            torch.cuda.empty_cache()


# int8_flash_attention at long causal sequences: (B, T, H, Hkv, D) —
# codeqwen1.5-7b's heads at the 4096-token forward of phase 6, 8192 keys at
# fewer heads (the plain version holds several [B, H, T, T] int32 tensors),
# and zamba2-2.7b's at head dim 80; past 3328 keys, where the block form of
# PRs 14-20 gave way to its streaming form
STREAM_SHAPES = ((1, 4096, 32, 32, 128), (1, 8192, 4, 4, 128),
                 (1, 4096, 32, 32, 80))


def check_streaming_attention(dev, gen, timer, record, randn) -> None:
    """Phase 3 for int8_flash_attention past 3328 keys: every launch counted
    as streaming (the kernel's one form streams K three times at any key
    count; a tree of PRs 15-20 takes its streaming form here), the integer
    probabilities and the int32 form bit-exact (recorded with their
    outputs for ``--kernels``' digests), the f32 output within RTOL/ATOL.
    The bound counts QK^T once."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.kernels.int8_flash_attention import (
        ATOL, RTOL, int8_attention_probs_ref, int8_flash_attention,
        int8_flash_attention_ref, streams)
    from repro_torch.models.attention import int_score_scale
    for b, t, h, hkv, d in STREAM_SHAPES:
        sc = int_score_scale(d)
        if not streams(t, d):
            raise AssertionError(f"{t} keys should take the streaming form")
        q, k, v, v_s = int_attention_inputs(randn, h, hkv, b, t, d)
        what = f"int8_flash_attention streaming B={b} T={t} H={h} Hkv={hkv}"
        shape = f"B={b} T={t} H={h} Hkv={hkv} D={d}"
        before = LAUNCHES["int8_flash_attention.streaming"]
        p_out = torch.empty((b, h, t, t), dtype=torch.int8, device=dev)
        out = int8_flash_attention(q, k, v, sc, v_scale=v_s, p_out=p_out)
        probs = int8_attention_probs_ref(q, k, sc)
        torch.cuda.synchronize()
        if LAUNCHES["int8_flash_attention.streaming"] != before + 1:
            raise AssertionError(f"{what}: not launched in the streaming form")
        if not torch.equal(p_out.int(), probs):
            raise AssertionError(f"{what}: {int((p_out.int() != probs).sum())}"
                                 f" integer probabilities differ from the "
                                 f"plain version's")
        record("int8_flash_attention", f"streaming probs {shape}", 0.0, True,
               0.0, 0.0, None, (0.0, "bytes"), "the debug output, not timed",
               p_out)
        del p_out, probs

        def run():
            return ops.attention_i8(q, k, v, sc, v_scale=v_s)

        def plain():
            return int8_flash_attention_ref(q, k, v, sc, v_scale=v_s)
        ref = plain()
        torch.cuda.synchronize()
        if not (torch.isfinite(out).all() and torch.allclose(
                out, ref, rtol=RTOL, atol=ATOL)):
            raise AssertionError(f"{what}: max |d| {max_err(out, ref)} beyond "
                                 f"rtol={RTOL} atol={ATOL}")
        pairs = t * (t + 1) // 2
        qk_ops = 2 * b * h * pairs * d
        io = q.numel() + k.numel() + v.numel() + 4 * v_s.numel()
        record("int8_flash_attention", f"streaming v_scale {shape}",
               max_err(out, ref), False, timer(run, iters=5),
               timer(plain, iters=2, warmup=1), None,
               bound(io + 4 * out.numel(), qk_ops * F32_OPS / INT8_OPS + qk_ops,
                     F32_OPS), None, out)
        del out, ref
        out, ref = ops.attention_i8(q, k, v, sc), int8_flash_attention_ref(
            q, k, v, sc)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"{what} int32 form: {int((out != ref).sum())}"
                                 f" of {out.numel()} differ from the plain "
                                 f"version")
        record("int8_flash_attention", f"streaming int32 {shape}", 0.0, True,
               timer(lambda: ops.attention_i8(q, k, v, sc), iters=5), 0.0,
               None, bound(io - 4 * v_s.numel() + 4 * out.numel(), 2 * qk_ops,
                           INT8_OPS), "plain version not timed", out)
        del out, ref, q, k, v, v_s
        torch.cuda.empty_cache()


VIT_IMAGES, VIT_SIDE, VIT_PATCH, VIT_D = 32, 224, 16, 768


def check_int_library(dev, gen, timer, record, randn) -> None:
    """Phase 3 for the rest of the integer library, each bit-exact against
    its plain version: int_gelu at starcoder2-3b's d_ff and int_silu at
    codeqwen1.5-7b's (4096 rows of the int8-range payload
    ``layers.activation`` makes), requantize_i32 on int32 accumulators, and
    int8_conv2d (``check_int8_conv2d``).  No library yardstick for the
    elementwise kernels (no PyTorch call computes them: the integer
    GELU/SiLU and the requant are the port's own functions)."""
    from repro_torch.core.inumerics import compute_requant_params
    from repro_torch.kernels import ops
    from repro_torch.kernels.int_gelu import int_gelu_ref
    from repro_torch.kernels.int_silu import int_silu_ref
    from repro_torch.kernels.quantize import requantize_i32_ref
    from repro_torch.models.layers import GELU_INT_SCALE, SILU_INT_SCALE
    no_lib = "no PyTorch call computes it"

    def ints(lo, hi, *shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=dtype)

    def exact(kernel, what, run, plain):
        out, ref = run(), plain()
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"{kernel} {what}: {int((out != ref).sum())} "
                                 f"of {out.numel()} differ from the plain "
                                 f"version")
        return out

    # -- 11, 12. int_gelu, int_silu (the unfused MLP corners) -------------------
    for kernel, m, n, scale, fn, ref_fn, out_bytes in (
            ("int_gelu", 4096, 12288, GELU_INT_SCALE, ops.gelu_i8, int_gelu_ref,
             1),
            ("int_silu", 4096, 13440, SILU_INT_SCALE, ops.silu_i8, int_silu_ref,
             4)):
        x = ints(-128, 128, m, n)
        exact(kernel, f"[{m},{n}]", lambda: fn(x, scale),
              lambda: ref_fn(x, scale))
        record(kernel, f"[{m},{n}] int32", 0.0, True,
               timer(lambda: fn(x, scale)), timer(lambda: ref_fn(x, scale)),
               None, bound(m * n * (4 + out_bytes), 30 * m * n, F32_OPS),
               no_lib)
        del x

    # -- 14. requantize_i32 -----------------------------------------------------
    rq = compute_requant_params(1 / 400000, acc_bound=3072 * 127 * 127)
    x = ints(-3072 * 127 * 127, 3072 * 127 * 127, 4096, 4096)
    exact("requantize_i32", "[4096,4096]", lambda: ops.requant(x, rq),
          lambda: requantize_i32_ref(x, rq))
    record("requantize_i32", "[4096,4096] int32", 0.0, True,
           timer(lambda: ops.requant(x, rq)),
           timer(lambda: requantize_i32_ref(x, rq)), None,
           bound(4096 * 4096 * 5, 8 * 4096 * 4096, F32_OPS), no_lib)
    del x

    check_int8_conv2d(dev, gen, timer, record, randn)


FIRST_LAYER_CONV = (8, 224, 224, 3, 3, 3, 64)  # a vision model's first conv


def check_int8_conv2d(dev, gen, timer, record, randn) -> None:
    """int8_conv2d's phase 3 cases, each bit-exact against its plain
    version: Table II's shape (int32 and requantized), a 3x3 conv at
    vision-model widths ([8,56,56,64]x[3,3,64,64]), a first layer over RGB
    at full resolution ([8,224,224,3]x[3,3,3,64], byte-loaded: C = 3;
    101 MB of int32 out) and the ViT-B/16 patch embed (the operands
    ``frontend.conv_patch_embed_int8`` makes).  Library yardstick:
    ``torch._int_mm`` of the 1x1 conv as a matrix product (no bias: not the
    same function); none for the others (PyTorch has no int8 convolution on
    CUDA)."""
    from repro_torch.core.inumerics import compute_requant_params
    from repro_torch.kernels import ops
    from repro_torch.kernels.conv2d import int8_conv2d_ref
    from repro_torch.models.frontend import patch_embed_operands

    def ints(lo, hi, *shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=dtype)
    rq = compute_requant_params(0.01, acc_bound=27 * 127 * 127)
    img = randn(VIT_IMAGES, VIT_SIDE, VIT_SIDE, 3).clamp(-1, 1)
    xv, wv, _ = patch_embed_operands(gen, img, VIT_D, VIT_PATCH)
    del img
    convs = []
    for n_, h, wd, c, kh, kw, o in (TABLE2_CONV, (8, 56, 56, 64, 3, 3, 64),
                                    FIRST_LAYER_CONV):
        convs.append((ints(-128, 128, n_, h, wd, c, dtype=torch.int8),
                      ints(-128, 128, kh, kw, c, o, dtype=torch.int8),
                      ints(-2 ** 20, 2 ** 20, o), (rq, None)
                      if (n_, h, wd, c, kh, kw, o) == TABLE2_CONV else (None,)))
    convs.append((xv, wv, ints(-2 ** 20, 2 ** 20, VIT_D), (None,)))
    for x, w, b, params in convs:
        n_, h, wd, c = x.shape
        kh, kw, _, o = w.shape
        m = n_ * (h - kh + 1) * (wd - kw + 1)
        lib, note = None, "PyTorch has no int8 convolution on CUDA"
        if kh == kw == 1:
            lib = int_mm_ms(timer, x.reshape(-1, c), w.reshape(c, o))
            note = "torch._int_mm of the 1x1 conv, no bias: not the same function"
        for pp in params:
            def run():
                return ops.conv2d_i8(x, w, b, pp)

            def plain():
                return int8_conv2d_ref(x, w, b, pp)
            shape = (f"[{n_},{h},{wd},{c}]x[{kh},{kw},{c},{o}] "
                     + ("requant" if pp is not None else "int32"))
            out, ref = run(), plain()
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise AssertionError(
                    f"int8_conv2d {shape}: {int((out != ref).sum())} of "
                    f"{out.numel()} differ from the plain version")
            record("int8_conv2d", shape, 0.0, True, timer(run),
                   timer(plain, iters=3, warmup=1), lib,
                   bound(x.numel() + w.numel() + 4 * o
                         + m * o * (1 if pp is not None else 4),
                         2 * m * o * kh * kw * c, INT8_OPS), note, out=out)
            del out, ref


# the paged arena of the serving paths: 8 lanes, max_seq 1024 in 16-slot
# pages, the engine's default pool size (b + 2) * mp + 1
PAGED_B, PAGED_PS, PAGED_MP = 8, 16, 64
PAGED_POOL = (PAGED_B + 2) * PAGED_MP + 1
IDLE_LANE = 3


def paged_arena(dev, gen, randn, hkv, d, int8):
    """A scrambled arena: random payload in every page (stale slots hold
    data), each lane's pages drawn from a permutation of 1..n_pages-1 (never
    adjacent by construction), lane 1's first page shared with lane 0's,
    a hole (null entry) in lane 2's table, a slot run cleared as by
    copy-on-write in lane 4's last page, and an idle lane (qpos -1)."""
    from repro_torch.models.attention import _quant_kv
    b, ps, mp, n = PAGED_B, PAGED_PS, PAGED_MP, PAGED_POOL
    arena = {}
    for key in ("k", "v"):
        x = randn(n, ps, hkv, d)
        if int8:
            arena["p" + key], arena["p" + key + "s"] = _quant_kv(x)
        else:
            arena["p" + key], arena["p" + key + "s"] = x.to(torch.bfloat16), None
    fill = torch.randint(1, ps * mp + 1, (b,), generator=gen, device=dev)
    fill[0] = max(int(fill[0]), 2 * ps)
    fill[1] = max(int(fill[1]), 2 * ps)
    fill[IDLE_LANE] = 0
    perm = torch.randperm(n - 1, generator=gen, device=dev) + 1
    pt = torch.zeros((b, mp), dtype=torch.int32, device=dev)
    ppos = torch.full((n, ps), -1, dtype=torch.int32, device=dev)
    slot = torch.arange(ps, device=dev)
    used = 0
    for lane in range(b):
        for j in range(-(-int(fill[lane]) // ps)):
            if lane == 1 and j == 0:
                pt[1, 0] = pt[0, 0]           # the shared prefix page
                continue
            page = perm[used]
            used += 1
            pt[lane, j] = page
            pos = j * ps + slot
            ppos[page] = torch.where(pos < fill[lane], pos, -1).to(torch.int32)
    pt[2, 1] = 0                              # a null entry inside the span
    last = pt[4, (int(fill[4]) - 1) // ps]
    ppos[last, 5:] = -1                       # copy-on-write kept 5 slots
    qpos = (fill - 1).to(torch.int32)
    return arena, ppos, pt, qpos


def check_paged(dev, gen, timer, record, randn,
                heads=((32, 32, 128, True), (24, 2, 128, True),
                       (32, 32, 128, False))) -> None:
    """Phase 3 for paged_decode_attention: codeqwen's serving shape (G = 1,
    int8 and bf16 pages) and starcoder's (G = 12), each on a scrambled arena
    (``paged_arena``) without and with a window, against the plain version
    (``RTOL``/``ATOL``; the idle lane exactly zero) and, for int8 pages,
    against the dense kernel on the same content laid out densely: equal
    bit for bit on every live lane."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.int8_kv_decode_attention import ATOL, RTOL
    from repro_torch.kernels.paged_attention import paged_decode_attention_ref
    b, ps, mp = PAGED_B, PAGED_PS, PAGED_MP
    for hq, hkv, d, int8 in heads:
        arena, ppos, pt, qpos = paged_arena(dev, gen, randn, hkv, d, int8)
        pk, pks, pv, pvs = (arena[k] for k in ("pk", "pks", "pv", "pvs"))
        q = randn(b, hq, d).to(torch.bfloat16)
        ptc = pt.long()
        kpos = ppos[ptc].reshape(b, mp * ps)
        for window in (0, 100):
            def run():
                return ops.paged_attention_decode(q, pk, pks, pv, pvs, ppos,
                                                  pt, qpos, window=window)

            def plain():
                return paged_decode_attention_ref(q, pk, pks, pv, pvs, ppos,
                                                  pt, qpos, window=window)
            out, ref = run(), plain()
            torch.cuda.synchronize()
            what = (f"paged decode attention Hq={hq} Hkv={hkv} "
                    f"{'int8' if int8 else 'bf16'} window={window}")
            if not (torch.isfinite(out).all() and torch.allclose(
                    out.float(), ref.float(), rtol=RTOL, atol=ATOL)):
                raise AssertionError(f"{what}: max |d| {max_err(out, ref)} "
                                     f"beyond rtol={RTOL} atol={ATOL}")
            if not bool((out[IDLE_LANE] == 0).all()):
                raise AssertionError(f"{what}: the idle lane is not zero")
            valid = (kpos >= 0) & (kpos <= qpos[:, None])
            if window:
                valid &= kpos > (qpos[:, None] - window)
            live = valid.any(1)
            if int8:
                # the dense kernel over the same content laid out densely
                def view(a):
                    return a[ptc].reshape(b, mp * ps, hkv, -1).contiguous()
                dense = ops.decode_attention_int8kv(
                    q, view(pk), view(pks), view(pv), view(pvs),
                    kpos.contiguous(), qpos, window=window)
                torch.cuda.synchronize()
                if not torch.equal(out[live], dense[live]):
                    raise AssertionError(
                        f"{what}: paged and dense kernels differ on live "
                        f"lanes (max |d| {max_err(out[live], dense[live])})")
            # yardstick: SDPA over K/V gathered and dequantized to bf16 ahead
            # of time (not the same function: the gather and dequant are out)
            ones = torch.ones((), device=dev)
            kd = (pk[ptc].float() * (pks[ptc] if int8 else ones)).to(
                torch.bfloat16).reshape(b, mp * ps, hkv, d).permute(0, 2, 1, 3)
            vd = (pv[ptc].float() * (pvs[ptc] if int8 else ones)).to(
                torch.bfloat16).reshape(b, mp * ps, hkv, d).permute(0, 2, 1, 3)
            kd = kd.repeat_interleave(hq // hkv, 1).contiguous()
            vd = vd.repeat_interleave(hq // hkv, 1).contiguous()
            mask = valid[:, None, None, :]
            q4 = q[:, :, None, :]
            lib = timer(lambda: torch.nn.functional.scaled_dot_product_attention(
                q4, kd, vd, attn_mask=mask))
            # bytes this data needs: ppos of every distinct mapped page, the
            # payload and scales of every distinct valid slot, the table,
            # qpos, q and out
            pages = torch.unique(ptc[ptc > 0]).numel()
            vslots = torch.unique((ptc[:, :, None] * ps + torch.arange(
                ps, device=dev)).reshape(b, -1)[valid]).numel()
            per_slot = hkv * d * pk.element_size() * 2 + (8 * hkv if int8 else 0)
            nbytes = (pages * ps * 4 + vslots * per_slot + pt.numel() * 4
                      + 4 * b + 2 * 2 * b * hq * d)
            ops_n = 4 * hq * d * int(valid.sum())
            record("paged_decode_attention",
                   f"B={b} ps={ps} MP={mp} Hq={hq} Hkv={hkv} D={d} "
                   f"{'int8' if int8 else 'bf16'} window={window}",
                   max_err(out, ref), False, timer(run), timer(plain), lib,
                   bound(nbytes, ops_n, F32_OPS), out=out)


# int4_gemm's phase 3 shapes (name, K, N, epilogue, bias, group, rows): the
# codeqwen1.5-7b W4A8 projections at decode (M = 8), bucket-64 and -256
# prefill steps and the no-cache forward's 4 x 1024 rows; starcoder's GELU
# up-projection;
# zamba2-2.7b's W4A8 forward (the Mamba-2 in_proj to 10448 columns, a
# ragged 82nd tile of 80, and out_proj; the shared block's GELU MLP); a
# ragged case through the byte-load path; then codeqwen's projections at
# calibrate_ptq's other groups (W4_GROUPS: 32 and 128) at its 2 x 128 rows
# and at decode
W4_SHAPES = (("q_proj+bias", 4096, 4096, "scaled", True, 64,
              (8, 64, 256, 4096)),
             ("o_proj+residual", 4096, 4096, "scaled_add", False, 64,
              (8, 64, 256, 4096)),
             ("mlp_down", 13440, 4096, "scaled", False, 64,
              (8, 64, 256, 4096)),
             ("starcoder_mlp_up+gelu", 3072, 12288, "scaled_gelu", False, 64,
              (8, 256)),
             ("zamba2 in_proj", 2560, 10448, "scaled", False, 64, (4096,)),
             ("zamba2 out_proj", 5120, 2560, "scaled", False, 64, (4096,)),
             ("zamba2 mlp_up+gelu", 2560, 10240, "scaled_gelu", False, 64,
              (4096,)),
             ("zamba2 mlp_down", 10240, 2560, "scaled", False, 64, (4096,)),
             ("ragged+bias", 96, 70, "scaled_add", True, 32, (5, 37)),
             *((name, k, 4096, epi, has_bias, group, (8, 256))
               for group in (32, 128)
               for name, k, epi, has_bias in (
                   ("q_proj+bias", 4096, "scaled", True),
                   ("o_proj+residual", 4096, "scaled_add", False),
                   ("mlp_down", 13440, "scaled", False))))
PLAIN_ROWS = 512       # the plain GEMMs run by row blocks past this


def by_rows(fn, m: int):
    """``fn(r0, r1)`` over row blocks of PLAIN_ROWS, concatenated: the plain
    GEMMs at M = 4096, whose W4 group partials would not fit at once (the
    rows are independent)."""
    return torch.cat([fn(r, min(m, r + PLAIN_ROWS))
                      for r in range(0, m, PLAIN_ROWS)])


def check_int4_gemm(dev, gen, timer, record, randn,
                    shapes=W4_SHAPES) -> None:
    """Phase 3's int4_gemm cases (``W4_SHAPES``): bit-exact against the
    plain version (run by blocks of PLAIN_ROWS rows, which are independent,
    where M is larger: its [groups, M, N] partials would not fit), timed
    beside ``torch._int_mm`` on the unpacked weight (no group scales: not
    the same function) and the bound (bytes against the int8 rate)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.int8_gemm import gemm_w4a8_ref, unpack_int4_ref
    from repro_torch.kernels.quantize import quantize_rows_ref
    from repro_torch.models.layers import GELU_INT_SCALE, quantize_weight_w4
    for name, k, n, epi, has_bias, group, rows in shapes:
        wd = quantize_weight_w4(randn(k, n, scale=k ** -0.5), group=group)
        w4, qmul, w_s = wd["w4"], wd["qmul"], wd["scale"]
        w_unpacked = unpack_int4_ref(w4, k)     # the yardstick's int8 weight
        bias = randn(n, scale=0.1) if has_bias else None
        for m in rows:
            x_q, x_s = quantize_rows_ref(randn(m, k))
            res = (randn(m, n).to(torch.bfloat16) if epi == "scaled_add"
                   else None)
            gs = GELU_INT_SCALE if epi == "scaled_gelu" else None

            def run():
                return ops.gemm_w4a8(x_q, x_s, w4, qmul, w_s, bias=bias,
                                     residual=res, gelu_scale=gs)

            def plain():
                return by_rows(lambda r0, r1: gemm_w4a8_ref(
                    x_q[r0:r1], x_s[r0:r1], w4, qmul, w_s, bias=bias,
                    gelu_scale=gs,
                    residual=None if res is None else res[r0:r1]), m)
            out, ref = run(), plain()
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise AssertionError(
                    f"int4_gemm {name} M={m}: {int((out != ref).sum())} of "
                    f"{out.numel()} differ from the plain version (max |d| "
                    f"{max_err(out, ref)})")
            del ref
            nbytes = (m * k + k * n // 2 + (k // group) * n + 4 * (m + n)
                      + (4 * n if has_bias else 0)
                      + (2 * m * n if res is not None else 0)
                      + m * n * out.element_size())
            c = record("int4_gemm", f"{name} [{m},{k}]x[{k},{n}] {epi} "
                       f"g{group}", 0.0, True, timer(run),
                       timer(plain, iters=3, warmup=1) if m > PLAIN_ROWS
                       else timer(plain),
                       int_mm_ms(timer, x_q, w_unpacked),
                       bound(nbytes, 2 * m * n * k, INT8_OPS),
                       lib_note="_int_mm, unpacked weight, no group scales: "
                       "not the same function", out=out)
            if m <= 8 and w4.numel() % 4 == 0:
                # what this timer lets a plain read of the same nibbles
                # take (a reduction over them): the decode cases' ceiling
                flat = w4.reshape(-1).view(torch.int32)
                c["read_ms"] = timer(lambda: flat.amax())
                log(f"    a read of the {w4.numel()} weight bytes "
                    f"(torch amax): {c['read_ms']:.4f} ms")


# the gated MLP's phase 3 shapes: codeqwen1.5-7b's [M, 4096] x 2 x [4096,
# 13440] at decode (M = 8), bucket-64 and -256 steps and the no-cache
# forward's 4 x 1024 rows, SiLU and GELU; dual_int4_gemm_gated also at
# calibrate_ptq's other groups (W4_GROUPS: 32 and 128) at decode and at its
# 2 x 128 rows; a ragged case of each form through the byte-load path
GATED_K, GATED_N = 4096, 13440
GATED_ROWS = (8, 64, 256, 4096)
GATED_RAGGED = ((5, 96, 70), (37, 96, 70))   # (M, K, N), K % 16 and N % 16 != 0


def same(kernel, what, out, ref):
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError(
            f"{kernel} {what}: {int((out != ref).sum())} of {out.numel()} "
            f"differ from the plain version (max |d| {max_err(out, ref)})")


def check_dual_int4_gemm_gated(dev, gen, timer, record, randn,
                               cases=None) -> None:
    """Phase 3's dual_int4_gemm_gated cases: bit-exact against
    ``gated_mlp_w4a8_ref`` (by row blocks past PLAIN_ROWS), timed beside two
    ``torch._int_mm`` on the unpacked weights (no group scales, no
    activation: not the same function) and the bound (bytes or operations
    at the int8 rate)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.int8_gemm import (gated_mlp_w4a8_ref,
                                               unpack_int4_ref)
    from repro_torch.kernels.quantize import quantize_rows_ref
    from repro_torch.models.layers import (GELU_INT_SCALE, SILU_INT_SCALE,
                                           quantize_weight_w4)
    if cases is None:
        cases = [(GATED_K, GATED_N, 64, m, act) for m in GATED_ROWS
                 for act in ("silu", "gelu")]
        cases += [(GATED_K, GATED_N, g, m, "silu") for g in (32, 128)
                  for m in (8, 256)]
        cases += [(k, n, 32, m, "gelu") for m, k, n in GATED_RAGGED]
    weights = {}
    for k, n, group, m, act in cases:
        if (k, n, group) not in weights:
            weights.clear()              # one weight pair on the card at a time
            up, gate = (quantize_weight_w4(randn(k, n, scale=k ** -0.5),
                                           group=group) for _ in range(2))
            weights[(k, n, group)] = (
                (up["w4"], up["qmul"], up["scale"], gate["w4"], gate["qmul"],
                 gate["scale"]),
                unpack_int4_ref(up["w4"], k), unpack_int4_ref(gate["w4"], k))
        w_args, wu8, wg8 = weights[(k, n, group)]
        sc = SILU_INT_SCALE if act == "silu" else GELU_INT_SCALE
        x_q, x_s = quantize_rows_ref(randn(m, k))
        shape = f"[{m},{k}]x2[{k},{n}] {act} g{group}"

        def run():
            return ops.gated_mlp_w4a8(x_q, x_s, *w_args, act=act, act_scale=sc)

        def plain():
            return by_rows(lambda r0, r1: gated_mlp_w4a8_ref(
                x_q[r0:r1], x_s[r0:r1], *w_args, act=act, act_scale=sc), m)
        out = run()
        same("dual_int4_gemm_gated", shape, out, plain())
        nbytes = (m * k + 4 * m + 2 * m * n
                  + 2 * (k * n // 2 + (k // group) * n + 4 * n))
        record("dual_int4_gemm_gated", shape, 0.0, True, timer(run),
               timer(plain, iters=3, warmup=1) if m > PLAIN_ROWS
               else timer(plain), int_mm_ms(timer, x_q, wu8, wg8),
               bound(nbytes, 4 * m * n * k, INT8_OPS),
               lib_note="two _int_mm, unpacked weights, no group scales or "
               "activation: not the same function", out=out)


def check_dual_gemm_gated(dev, gen, timer, record, randn, cases=None,
                          bf16_form: bool = True) -> None:
    """Phase 3's dual_gemm_gated cases, both forms: the int8 form bit-exact
    against ``gated_mlp_w8a8_ref`` and timed beside two ``torch._int_mm``
    (int32 out, no scales or activation: not the same function); the bf16
    form within ``DUAL_BF16_RTOL``/``ATOL`` of ``gated_mlp_ref``, the same
    bits in two runs, timed beside two bf16 ``torch.matmul`` (no
    activation: not the same function).  ``cases`` (K, N, M, act) replace
    the default shapes; ``bf16_form`` False runs only the int8 form."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.int8_gemm import (
        DUAL_BF16_ATOL, DUAL_BF16_RTOL, gated_mlp_ref, gated_mlp_w8a8_ref)
    from repro_torch.kernels.quantize import quantize_rows_ref
    from repro_torch.models.layers import (GELU_INT_SCALE, SILU_INT_SCALE,
                                           quantize_weight)
    if cases is None:
        cases = [(GATED_K, GATED_N, m, act) for m in GATED_ROWS
                 for act in ("silu", "gelu")]
        cases += [(k, n, m, "gelu") for m, k, n in GATED_RAGGED]
    weights = {}
    for k, n, m, act in cases:
        if (k, n) not in weights:
            weights.clear()              # one weight set on the card at a time
            up, gate = (quantize_weight(randn(k, n, scale=k ** -0.5))
                        for _ in range(2))
            weights[(k, n)] = (
                (up["w_q"], up["scale"], gate["w_q"], gate["scale"]),
                *((randn(k, n, scale=k ** -0.5).to(torch.bfloat16)
                   for _ in range(2)) if bf16_form else (None, None)))
        w8_args, wu_f, wg_f = weights[(k, n)]
        sc = SILU_INT_SCALE if act == "silu" else GELU_INT_SCALE
        x_q, x_s = quantize_rows_ref(randn(m, k))
        shape = f"[{m},{k}]x2[{k},{n}] {act}"

        def run8():
            return ops.gated_mlp_w8a8(x_q, x_s, *w8_args, act=act,
                                      act_scale=sc)

        def plain8():
            return by_rows(lambda r0, r1: gated_mlp_w8a8_ref(
                x_q[r0:r1], x_s[r0:r1], *w8_args, act=act, act_scale=sc), m)
        out = run8()
        same("dual_gemm_gated", f"int8 {shape}", out, plain8())
        io = m * k + 4 * m + 2 * m * n
        record("dual_gemm_gated", f"int8 {shape}", 0.0, True, timer(run8),
               timer(plain8, iters=3, warmup=1) if m > PLAIN_ROWS
               else timer(plain8),
               int_mm_ms(timer, x_q, w8_args[0], w8_args[2]),
               bound(io + 2 * (k * n + 4 * n), 4 * m * n * k, INT8_OPS),
               lib_note="two _int_mm, int32 out, no scales or activation: "
               "not the same function", out=out)
        if not bf16_form:
            continue
        x_f = randn(m, k).to(torch.bfloat16)

        def runf():
            return ops.gated_mlp(x_f, wu_f, wg_f, act)

        def plainf():
            return by_rows(lambda r0, r1: gated_mlp_ref(x_f[r0:r1], wu_f,
                                                        wg_f, act), m)
        out, again, ref = runf(), runf(), plainf()
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        if not (torch.isfinite(out).all() and bool(
                (err <= DUAL_BF16_ATOL + DUAL_BF16_RTOL
                 * ref.float().abs()).all())):
            raise AssertionError(f"dual_gemm_gated bf16 {shape}: max |d| "
                                 f"{float(err.max())} beyond atol="
                                 f"{DUAL_BF16_ATOL} rtol={DUAL_BF16_RTOL}")
        if not torch.equal(out, again):
            raise AssertionError(f"dual_gemm_gated bf16 {shape}: two runs "
                                 f"on the same inputs differ")
        record("dual_gemm_gated", f"bf16 {shape}", float(err.max()), False,
               timer(runf), timer(plainf, iters=3, warmup=1)
               if m > PLAIN_ROWS else timer(plainf),
               timer(lambda: (x_f @ wu_f, x_f @ wg_f)),
               bound(2 * m * k + 4 * k * n + 2 * m * n, 4 * m * n * k,
                     BF16_OPS),
               lib_note="two torch.matmul, no activation: not the same "
               "function", out=out)


def check_dense_decode(dev, gen, timer, record, randn) -> None:
    """int8_kv_decode_attention's phase 3 cases: T = 1, then the T = 256
    multi-row form."""
    check_decode_attention(dev, gen, timer, record, randn)
    check_decode_rows(dev, gen, timer, record, randn, forms=(False,))


def check_paged_decode(dev, gen, timer, record, randn) -> None:
    """paged_decode_attention's phase 3 cases: T = 1 on scrambled arenas
    (against the dense kernel too), then the T = 256 multi-row form."""
    check_paged(dev, gen, timer, record, randn)
    check_decode_rows(dev, gen, timer, record, randn, forms=(True,))


# ---------------------------------------------------------------------------
# phase 3: the expert-batched GEMM forms and the windowed decode kernels
# ---------------------------------------------------------------------------

# the experts of the MoE paths: (label, arch, E, D, F, weight kinds); the
# up/gate forms at [E, rows, D] x 2 [E, D, F], the down forms at [E, rows, F]
# x [E, F, D]; W4 and W8 for both (mixtral serves W4A8, qwen2-moe W8A8) and
# the float up/gate form
EXPERT_SHAPES = (("mixtral", "mixtral-8x7b", 8, 4096, 14336),
                 ("qwen2-moe", "qwen2-moe-a2.7b", 60, 2048, 1408))
EXPERT_KINDS = ("w4", "w8", "bf16")
DECODE_LANES, PREFILL_TOKENS = 8, 8 * 256   # a bucket-1 step, a bucket-256 step


def expert_rows(arch: str, t: int) -> int:
    """Rows per expert, G * C, of a MoE layer over ``t`` tokens (the
    reference's group size and capacity)."""
    from repro_torch.configs import get_config
    from repro_torch.core.costmodel import moe_capacity
    from repro_torch.models.moe import _group_size
    cfg = get_config(arch)
    sg = _group_size(cfg, t)
    return t // sg * moe_capacity(sg, cfg.n_experts, cfg.n_experts_per_tok,
                                  cfg.capacity_factor)


def check_experts(dev, gen, timer, record, randn) -> None:
    """The expert-batched forms (one launch over every expert) at mixtral's
    and qwen2-moe's experts, rows per expert at decode (a bucket-1 step of 8
    lanes: C = 4) and at a bucket-256 step's G * C: each ``torch.equal`` to
    its plain version (the unbatched plain version per expert, by row
    blocks past PLAIN_ROWS) and to the unbatched kernel launched on each
    expert's rows (bf16: the same bits), one expert's rows all zero (empty
    capacity slots: scale-0 rows).  Timed beside a loop of the unbatched
    kernel over the experts (``loop_ms``) and the bound (every expert's
    weight bytes, or the operations); the bf16 form's library call is two
    ``torch.bmm`` (no activation: not the same function), the integer forms
    have no batched PyTorch call (``torch._int_mm`` is 2-D)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import int8_gemm as ig
    from repro_torch.kernels.quantize import quantize_rows_ref
    from repro_torch.models.layers import (SILU_INT_SCALE, quantize_weight,
                                           quantize_weight_w4)
    sc = SILU_INT_SCALE

    def rows_of(e, m, k):
        x = randn(e, m, k)
        x[-1] = 0                       # an expert whose slots are all empty
        q, s = quantize_rows_ref(x.reshape(-1, k))
        return q.reshape(e, m, k), s.reshape(e, m, 1)

    def plain_of(fn, m, n_rowwise=2):
        """``fn`` by row blocks: its first ``n_rowwise`` arguments (the
        rows and their scales) are cut, the weights passed whole."""
        return lambda *a: by_rows(lambda r0, r1: fn(
            *(t[r0:r1] if i < n_rowwise else t for i, t in enumerate(a))), m)

    for label, arch, e, d, f in EXPERT_SHAPES:
        rows = (expert_rows(arch, DECODE_LANES),
                expert_rows(arch, PREFILL_TOKENS))
        for kind in EXPERT_KINDS:
            if kind == "bf16":
                wu, wg = (randn(e, d, f, scale=d ** -0.5).to(torch.bfloat16)
                          for _ in range(2))
                up_args, w_bytes = (wu, wg), 2 * 2 * e * d * f
            elif kind == "w8":
                up_args = tuple(v for w in (quantize_weight(
                    randn(e, d, f, scale=d ** -0.5)) for _ in range(2))
                    for v in (w["w_q"], w["scale"]))
                dn = quantize_weight(randn(e, f, d, scale=f ** -0.5))
                dn_args, w_bytes = (dn["w_q"], dn["scale"]), 2 * e * d * f
            else:
                up_args = tuple(v for w in (quantize_weight_w4(
                    randn(e, d, f, scale=d ** -0.5)) for _ in range(2))
                    for v in (w["w4"], w["qmul"], w["scale"]))
                dn = quantize_weight_w4(randn(e, f, d, scale=f ** -0.5))
                dn_args = (dn["w4"], dn["qmul"], dn["scale"])
                w_bytes = 2 * (e * d * f // 2 + e * (d // 64) * f)
            for m in rows:
                shape = f"{label} E={e} [{m},{d}]x2[{d},{f}] silu"
                if kind == "bf16":
                    x = randn(e, m, d).to(torch.bfloat16)
                    x[-1] = 0

                    def run():
                        return ops.gated_mlp_experts(x, *up_args)

                    def loop():
                        return torch.stack([ops.gated_mlp(x[i], wu[i], wg[i])
                                            for i in range(e)])

                    def plain():
                        return ig.per_expert(plain_of(
                            ig.gated_mlp_ref, m, 1), x, wu, wg)
                    out, ref = run(), plain()
                    same("dual_gemm_gated", f"bf16 experts {shape} vs the "
                         f"unbatched kernel", out, loop())
                    err = (out.float() - ref.float()).abs()
                    if not bool((err <= ig.DUAL_BF16_ATOL + ig.DUAL_BF16_RTOL
                                 * ref.float().abs()).all()):
                        raise AssertionError(f"dual_gemm_gated bf16 experts "
                                             f"{shape}: max |d| "
                                             f"{float(err.max())}")
                    c = record("dual_gemm_gated", f"bf16 experts {shape}",
                               float(err.max()), False, timer(run),
                               timer(plain, iters=2, warmup=1),
                               timer(lambda: (torch.bmm(x, wu),
                                              torch.bmm(x, wg))),
                               bound(w_bytes + 2 * e * m * (d + f),
                                     4 * e * m * d * f, BF16_OPS),
                               lib_note="two torch.bmm, no activation: not "
                               "the same function", out=out)
                    c["loop_ms"] = timer(loop)
                    del out, ref
                    continue
                xq, xs = rows_of(e, m, d)
                gated = (ops.gated_mlp_w4a8_experts if kind == "w4"
                         else ops.gated_mlp_w8a8_experts)
                single = (ops.gated_mlp_w4a8 if kind == "w4"
                          else ops.gated_mlp_w8a8)
                ref_fn = (ig.gated_mlp_w4a8_ref if kind == "w4"
                          else ig.gated_mlp_w8a8_ref)
                name = ("dual_int4_gemm_gated" if kind == "w4"
                        else "dual_gemm_gated")

                def run():
                    return gated(xq, xs, *up_args, act_scale=sc)

                def loop():
                    return torch.stack([single(xq[i], xs[i], *(
                        a[i] for a in up_args), act_scale=sc)
                        for i in range(e)])

                def plain():
                    return ig.per_expert(plain_of(
                        lambda *a: ref_fn(*a, act_scale=sc), m),
                        xq, xs, *up_args)
                out = run()
                same(name, f"experts {shape}", out, plain())
                same(name, f"experts {shape} vs the unbatched kernel", out,
                     loop())
                what = f"{'int8 ' if kind == 'w8' else ''}experts {shape}" + (
                    " g64" if kind == "w4" else "")
                c = record(name, what, 0.0, True, timer(run),
                           timer(plain, iters=2, warmup=1), None,
                           bound(w_bytes + e * m * (d + 4 + 2 * f),
                                 4 * e * m * d * f, INT8_OPS),
                           lib_note="no batched PyTorch call: torch._int_mm "
                           "is 2-D", out=out)
                c["loop_ms"] = timer(loop)
                # the down projection on the hidden rows
                hq, hs = rows_of(e, m, f)
                down = (ops.gemm_w4a8_experts if kind == "w4"
                        else ops.gemm_w8a8_experts)
                down1 = ops.gemm_w4a8 if kind == "w4" else ops.gemm_w8a8
                dref = ig.gemm_w4a8_ref if kind == "w4" else ig.gemm_w8a8_ref
                dname = "int4_gemm" if kind == "w4" else "int8_gemm"

                def run_d():
                    return down(hq, hs, *dn_args)

                def loop_d():
                    return torch.stack([down1(hq[i], hs[i], *(
                        a[i] for a in dn_args)) for i in range(e)])

                def plain_d():
                    return ig.per_expert(plain_of(dref, m), hq, hs, *dn_args)
                out = run_d()
                same(dname, f"experts down {shape}", out, plain_d())
                same(dname, f"experts down {shape} vs the unbatched kernel",
                     out, loop_d())
                dn_bytes = (e * f * d // 2 + e * (f // 64) * d if kind == "w4"
                            else e * f * d) + 4 * e * d
                c = record(dname, f"experts down {label} E={e} "
                           f"[{m},{f}]x[{f},{d}] scaled"
                           + (" g64" if kind == "w4" else ""), 0.0, True,
                           timer(run_d), timer(plain_d, iters=2, warmup=1),
                           None, bound(dn_bytes + e * m * (f + 4 + 2 * d),
                                       2 * e * m * d * f, INT8_OPS),
                           lib_note="no batched PyTorch call: torch._int_mm "
                           "is 2-D", out=out)
                c["loop_ms"] = timer(loop_d)
                del out
            del up_args
            torch.cuda.empty_cache()


# mixtral-8x7b's decode attention: G = 4, D = 128, window 4096 over the
# dense ring of window + 256 slack slots and over the paged arena of
# max_seq 8192 with each lane's pages capped at the window
WIN_B, WIN_HQ, WIN_HKV, WIN_D, WINDOW = 8, 32, 8, 128, 4096
WIN_RING, WIN_MAX_SEQ, WIN_ROWS = 4096 + 256, 8192, 16
WIN_FRESH = 3000        # a lane whose ring has not wrapped yet


def check_window_decode(dev, gen, timer, record, randn) -> None:
    """int8_kv_decode_attention and paged_decode_attention with the window
    at mixtral's G = 4, D = 128: 8 lanes at positions 4400-8000 (the
    4352-slot ring has wrapped: slot = position % 4352) and one at 3000
    (not yet), within RTOL/ATOL of the plain versions; the multi-row form
    (16 rows a lane) bit-equal row by row to T = 1 launches; the paged
    arena holds the same keys in 16-slot pages with every page wholly
    behind the window unmapped (the engine's ``cap_window``)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.int8_kv_decode_attention import (
        ATOL, RTOL, int8_kv_decode_attention_ref)
    from repro_torch.kernels.paged_attention import paged_decode_attention_ref
    from repro_torch.models.attention import _quant_kv
    b, hq, hkv, d, s = WIN_B, WIN_HQ, WIN_HKV, WIN_D, WIN_RING
    qpos = torch.randint(4400, 8000, (b,), generator=gen, device=dev)
    qpos[5] = WIN_FRESH
    qpos = qpos.to(torch.int32)
    # ring slot j holds the latest position <= qpos congruent to j
    slot = torch.arange(s, device=dev)
    pos = qpos[:, None] - ((qpos[:, None] - slot[None]) % s)
    pos = torch.where(pos >= 0, pos, -1).to(torch.int32)
    k_q, k_s = _quant_kv(randn(b, s, hkv, d))
    v_q, v_s = _quant_kv(randn(b, s, hkv, d))
    q = randn(b, hq, d).to(torch.bfloat16)
    cache = (k_q, k_s, v_q, v_s, pos)

    def check(kernel, out, ref, what):
        torch.cuda.synchronize()
        if not (torch.isfinite(out).all() and torch.allclose(
                out.float(), ref.float(), rtol=RTOL, atol=ATOL)):
            raise AssertionError(f"{kernel} {what}: max |d| "
                                 f"{max_err(out, ref)} beyond rtol={RTOL} "
                                 f"atol={ATOL}")

    def run():
        return ops.decode_attention_int8kv(q, *cache, qpos, window=WINDOW)

    def plain():
        return int8_kv_decode_attention_ref(q, *cache, qpos, window=WINDOW)
    shape = (f"ring B={b} S={s} Hq={hq} Hkv={hkv} D={d} window={WINDOW}")
    out = run()
    check("int8_kv_decode_attention", out, plain(), shape)
    record("int8_kv_decode_attention", shape, max_err(out, plain()), False,
           timer(run), timer(plain),
           window_sdpa_ms(timer, q, k_q * k_s, v_q * v_s, pos, qpos),
           bound(*decode_work(pos, qpos[:, None], hq, hkv, d, WINDOW),
                 F32_OPS), lib_note=WINDOW_SDPA_NOTE, out=out)
    # the multi-row form: 16 rows a lane at qpos - 15 .. qpos
    rows = qpos[:, None] - torch.arange(WIN_ROWS - 1, -1, -1, device=dev,
                                        dtype=torch.int32)
    qr = randn(b, WIN_ROWS, hq, d).to(torch.bfloat16)
    multi = ops.decode_attention_int8kv_rows(qr, *cache, rows.contiguous(),
                                             window=WINDOW)
    for r in range(WIN_ROWS):
        one = ops.decode_attention_int8kv(qr[:, r].contiguous(), *cache,
                                          rows[:, r].contiguous(),
                                          window=WINDOW)
        same("int8_kv_decode_attention", f"{shape} row {r} of {WIN_ROWS}",
             multi[:, r], one)
    # the paged arena: the same keys in position order, pages behind the
    # window unmapped
    ps, mp = PAGED_PS, WIN_MAX_SEQ // PAGED_PS
    first = torch.clamp(qpos - WINDOW + 1, min=0) // ps   # first live page
    n_live = (qpos // ps - first + 1)
    n_pages = int(n_live.sum()) + 1
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    pt = torch.zeros((b, mp), dtype=torch.int32, device=dev)
    pk = torch.zeros((n_pages, ps, hkv, d), dtype=torch.int8, device=dev)
    pv, pks, pvs = torch.zeros_like(pk), None, None
    pks = torch.ones((n_pages, ps, hkv, 1), device=dev)
    pvs = torch.ones_like(pks)
    ppos = torch.full((n_pages, ps), -1, dtype=torch.int32, device=dev)
    used = 0
    for lane in range(b):
        for j in range(int(first[lane]), int(qpos[lane]) // ps + 1):
            page = perm[used]
            used += 1
            pt[lane, j] = page
            p = j * ps + torch.arange(ps, device=dev)
            live = (p <= qpos[lane]) & (p > qpos[lane] - s)
            src = p % s
            ppos[page] = torch.where(live, p, -1).to(torch.int32)
            pk[page], pv[page] = k_q[lane, src], v_q[lane, src]
            pks[page], pvs[page] = k_s[lane, src], v_s[lane, src]
    arena = (pk, pks, pv, pvs, ppos, pt)

    def run_p():
        return ops.paged_attention_decode(q, *arena, qpos, window=WINDOW)

    def plain_p():
        return paged_decode_attention_ref(q, *arena, qpos, window=WINDOW)
    pshape = (f"paged B={b} ps={ps} MP={mp} Hq={hq} Hkv={hkv} D={d} int8 "
              f"window={WINDOW} capped")
    out = run_p()
    check("paged_decode_attention", out, plain_p(), pshape)
    check("paged_decode_attention", out, run(), pshape + " vs the dense ring")
    slot_ids = pt.long()[:, :, None] * ps + torch.arange(ps, device=dev)
    kpos = ppos[pt.long()].reshape(b, mp * ps)
    ptc = pt.long()

    def gather(a, sc):
        return (a[ptc].float() * sc[ptc]).reshape(b, mp * ps, hkv, d)
    lib = window_sdpa_ms(timer, q, gather(pk, pks), gather(pv, pvs), kpos,
                         qpos)
    record("paged_decode_attention", pshape, max_err(out, plain_p()), False,
           timer(run_p), timer(plain_p), lib,
           bound(*decode_work(kpos, qpos[:, None], hq, hkv, d, WINDOW,
                              slot_ids=slot_ids.reshape(b, mp * ps),
                              pos_bytes=4 * ppos.numel() + 4 * pt.numel()),
                 F32_OPS), lib_note=WINDOW_SDPA_NOTE, out=out)


WINDOW_SDPA_NOTE = ("SDPA over K/V dequantized to bf16 ahead of time (the "
                    "paged arena gathered too), the window mask: not the "
                    "same function (the dequant and gather are out)")


def window_sdpa_ms(timer, q, k, v, pos, qpos) -> float:
    """``scaled_dot_product_attention`` of the decode rows q (B, Hq, D)
    over f32 K and V (B, S, Hkv, D), cast to bf16 and their heads repeated
    to Hq ahead of the timing, with the window's mask: slots of positions
    in (qpos - WINDOW, qpos]."""
    b, hq, d = q.shape
    g = hq // k.shape[2]
    kd, vd = (x.to(torch.bfloat16).permute(0, 2, 1, 3).repeat_interleave(
        g, 1).contiguous() for x in (k, v))
    mask = ((pos >= 0) & (pos <= qpos[:, None])
            & (pos > qpos[:, None] - WINDOW))[:, None, None, :]
    q4 = q[:, :, None, :]
    return timer(lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, kd, vd, attn_mask=mask))


# the kernels ``--kernels`` can time alone: each one's phase 3 cases and the
# sources they build (the paged cases hold the dense kernel beside it)
# ---------------------------------------------------------------------------
# phase 3: internlm2-20b's and yi-34b's GQA (G = 6 and 7) and projection
# widths, and xlstm-350m's N = 8 gate projection
# ---------------------------------------------------------------------------

# (label, query heads) of the two dense GQA models, each over 8 KV heads of
# 128: internlm2-20b G = 6, yi-34b G = 7 (the first odd G above 1)
GQA_HEADS = (("internlm2", 48), ("yi", 56))
GQA_HKV, GQA_D = 8, 128
GQA_ROWS = (8, 256, 4096)      # a bucket-1 step, a bucket-256 step, 4 x 1024
# internlm2-20b's W8A8 projections through int8_gemm (no qkv bias): q, kv
# (8 x 128 columns), o with the residual, down, the f32 head; yi-34b's int8
# head (the W4 policy keeps the head int8) and down projection (K = 20480 is
# past the W4 combine's headroom, so its PTQ keeps it int8: ROADMAP C14);
# xlstm-350m's mLSTM gate projection w_if [2048, 2 x 4 heads] at W8
I8_GQA = tuple((name, k, n, epi, False, dt, GQA_ROWS)
               for name, k, n, epi, dt in (
                   ("internlm2 q_proj", 6144, 6144, "scaled", torch.bfloat16),
                   ("internlm2 kv_proj", 6144, 1024, "scaled", torch.bfloat16),
                   ("internlm2 o_proj+residual", 6144, 6144, "scaled_add",
                    torch.bfloat16),
                   ("internlm2 mlp_down", 16384, 6144, "scaled",
                    torch.bfloat16),
                   ("internlm2 head_f32", 6144, 92544, "scaled",
                    torch.float32),
                   ("yi head_f32", 7168, 64000, "scaled", torch.float32),
                   ("yi mlp_down", 20480, 7168, "scaled", torch.bfloat16),
                   ("xlstm w_if", 2048, 8, "scaled", torch.bfloat16)))
# yi-34b's W4A8 projections at group 64, and xlstm's w_if at W4
W4_GQA = tuple((name, k, n, epi, False, 64, GQA_ROWS)
               for name, k, n, epi in (
                   ("yi q_proj", 7168, 7168, "scaled"),
                   ("yi kv_proj", 7168, 1024, "scaled"),
                   ("yi o_proj+residual", 7168, 7168, "scaled_add"),
                   ("xlstm w_if", 2048, 8, "scaled")))


def check_gqa_xlstm(dev, gen, timer, record, randn) -> None:
    """Phase 3 at the shapes of this slice's paths, each case against its
    plain version as the earlier cases are: the decode kernels at G = 6 and
    7 (8 lanes of 1024 slots, 8 KV heads of 128; T = 1 dense and on a
    scrambled paged arena, then the T = 256 multi-row form of both with
    every row bit-equal to a T = 1 launch); int8_flash_attention at
    B = 4, T = 1024 over 48/8 and 56/8 heads (integer probabilities and the
    int32 form bit-exact, the f32 output within rtol 1e-5); and
    ``torch.equal`` for the GEMMs at M in {8, 256, 4096}: int8_gemm at
    internlm2-20b's W8A8 projections and head (N = 92544), yi-34b's int8
    head (N = 64000) and int8 down projection (K = 20480, C14) and
    xlstm-350m's w_if (N = 8, narrower than any tile), the int8
    dual_gemm_gated at internlm2's [M, 6144] x 2 [6144, 16384], int4_gemm
    at yi's W4A8 q, kv and o projections (K = 7168, group 64) and w_if at
    W4, and dual_int4_gemm_gated at yi's [M, 7168] x 2 [7168, 20480]."""
    heads = [(h, GQA_HKV, GQA_D) for _, h in GQA_HEADS]
    check_decode_attention(dev, gen, timer, record, randn, shapes=[
        (8, 1024, h, hkv, d, (0,)) for h, hkv, d in heads])
    check_paged(dev, gen, timer, record, randn,
                heads=[(*x, True) for x in heads])
    check_decode_rows(dev, gen, timer, record, randn, heads=heads)
    check_int8_attention(dev, gen, timer, record, randn, heads=[
        (label, h, GQA_HKV, GQA_D) for label, h in GQA_HEADS],
        streaming=False)
    check_int8_gemm(dev, gen, timer, record, randn, shapes=I8_GQA,
                    extras=False)
    check_dual_gemm_gated(dev, gen, timer, record, randn, cases=[
        (6144, 16384, m, "silu") for m in GQA_ROWS], bf16_form=False)
    check_int4_gemm(dev, gen, timer, record, randn, shapes=W4_GQA)
    check_dual_int4_gemm_gated(dev, gen, timer, record, randn, cases=[
        (7168, 20480, 64, m, "silu") for m in GQA_ROWS])
    torch.cuda.empty_cache()


# whisper-small and llama-3.2-vision-90b (encoder-decoder and
# cross-attention): the encoder's no-cache attention over 4 x 1500 frames at
# head dim 64 (12 heads, causal: ROADMAP C16), the decoder's over 448 tokens
WH_T, WH_DEC_T, WH_H, WH_D = 1500, 448, 12, 64
WH_ENC_ROWS = NC_B * WH_T               # 4 clips of 1500 frames
WH_CROSS_ROWS = 8 * WH_T                # 8 lanes' cross K/V rows
VIS_TOKENS, VIS_D, VIS_FF = 1601, 8192, 28672
VIS_CROSS_ROWS = 8 * VIS_TOKENS         # 12808
# whisper-small's W8A8 projections (q, k, v and o are [768, 768]; the
# encoder's out-projection adds its f32 skip after the scaled epilogue);
# vision-90b's int8 down projection (K = 28672, past the W4 combine's
# headroom: C14) and int8 head
I8_XATTN = tuple((name, k, n, epi, False, dt, rows)
                 for name, k, n, epi, dt, rows in (
                     ("whisper q/k/v/o", 768, 768, "scaled", torch.bfloat16,
                      (8, WH_ENC_ROWS)),
                     ("whisper cross kv", 768, 768, "scaled", torch.bfloat16,
                      (WH_CROSS_ROWS,)),
                     ("whisper mlp_up+gelu", 768, 3072, "scaled_gelu",
                      torch.bfloat16, (8, WH_ENC_ROWS)),
                     ("whisper mlp_down", 3072, 768, "scaled", torch.bfloat16,
                      (8, WH_ENC_ROWS)),
                     ("vision mlp_down", VIS_FF, VIS_D, "scaled",
                      torch.bfloat16, (8, 256)),
                     ("vision head_f32", VIS_D, 128256, "scaled",
                      torch.float32, (8, 256))))
# vision-90b's W4A8 attention projections (group 64): q and o at decode and
# a bucket-256 step, k/v there and over the 8 lanes' 1601 vision tokens
W4_XATTN = tuple((name, k, n, epi, False, 64, rows)
                 for name, k, n, epi, rows in (
                     ("vision q_proj", VIS_D, VIS_D, "scaled", (8, 256)),
                     ("vision kv_proj", VIS_D, 1024, "scaled", (8, 256)),
                     ("vision cross kv", VIS_D, 1024, "scaled",
                      (VIS_CROSS_ROWS,)),
                     ("vision o_proj+residual", VIS_D, VIS_D, "scaled_add",
                      (8, 256))))
# the fused norm at whisper's LayerNorm (f32 encoder rows, bf16 decoder
# rows) and vision's RMSNorm: (label, D, rms_only, rows, dtype)
NORMS_XATTN = (("whisper enc", 768, False, WH_ENC_ROWS, torch.float32),
               ("whisper dec", 768, False, 8, torch.bfloat16),
               ("vision", VIS_D, True, 8, torch.bfloat16),
               ("vision", VIS_D, True, 256, torch.bfloat16))
# quantize_rows' new rows: vision's f32 stub features (the cross K/V
# projections' input) and whisper's f32 encoder stream
B1_XATTN = ((VIS_CROSS_ROWS, VIS_D, torch.float32),
            (WH_ENC_ROWS, 768, torch.float32), (8, 768, torch.bfloat16))


def check_encdec_xattn(dev, gen, timer, record, randn) -> None:
    """Phase 3 at the shapes of this slice's paths, each case against its
    plain version as the earlier cases are: int8_flash_attention over
    whisper's encoder (B = 4, T = 1500 — not a whole number of 64-row
    blocks — 12 heads of 64, causal; the integer probabilities and the int32
    form bit-exact, the f32 output within rtol 1e-5) and vision's 64/8
    heads; flash_attention over whisper's bf16 decoder (T = 448, head dim
    64, beside SDPA); the dense decode kernel at whisper's G = 1, D = 64 and
    vision's G = 8, D = 128 (T = 1 and the T = 256 rows); and
    ``torch.equal`` for quantize_rows on f32 rows (vision's stub features
    [12808, 8192], whisper's f32 encoder stream), the fused norm on f32
    and bf16 rows (``NORMS_XATTN``), int8_gemm at whisper's projections
    (``I8_XATTN``; the cross K/V over 8 x 1500 rows), vision's int8 down
    projection and head, int4_gemm at vision's projections and cross K/V
    (M = 12808, ``W4_XATTN``) and dual_int4_gemm_gated at vision's
    [M, 8192] x 2 [8192, 28672]."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.int_layernorm import int_layernorm_rows_ref
    from repro_torch.kernels.quantize import quantize_rows_ref
    from repro_torch.models.layers import quantize_norm
    no_lib = "no PyTorch call computes it"
    for m, d, dtype in B1_XATTN:
        x = randn(m, d, scale=0.02 if dtype == torch.float32 else 3.0
                  ).to(dtype)
        got, want = ops.quant_rows(x), quantize_rows_ref(x)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"quantize_rows [{m},{d}] {dtype} differs")
        name = "f32" if dtype == torch.float32 else "bf16"
        record("quantize_rows", f"[{m},{d}] {name}", 0.0, True,
               timer(lambda: ops.quant_rows(x)),
               timer(lambda: quantize_rows_ref(x)), None,
               bound(m * d * (x.element_size() + 1) + m * 4, 3 * m * d,
                     F32_OPS), no_lib, out=bytes_of(got))
        del x, got, want
    for label, d, rms, m, dtype in NORMS_XATTN:
        x = randn(m, d, scale=3.0).to(dtype)
        g_q, b_q, gb_s = quantize_norm(randn(d, scale=0.5) + 1.0,
                                       None if rms else randn(d, scale=0.2))
        got = ops.norm_quant_rows(x, g_q, b_q, gb_s, rms)
        plain = int_layernorm_rows_ref(x, g_q, b_q, gb_s, rms)
        torch.cuda.synchronize()
        if not all(torch.equal(a, w) for a, w in zip(got, plain)):
            raise AssertionError(f"int_layernorm fused {label} [{m},{d}] "
                                 f"{dtype} differs from its plain version")
        kind, es = "rms" if rms else "ln", x.element_size()
        record("int_layernorm", f"fused {label} [{m},{d}] {kind} "
               f"{'f32' if dtype == torch.float32 else 'bf16'}", 0.0, True,
               timer(lambda: ops.norm_quant_rows(x, g_q, b_q, gb_s, rms)),
               timer(lambda: int_layernorm_rows_ref(x, g_q, b_q, gb_s, rms)),
               None, bound(m * d * (2 * es + 1) + m * 4
                           + (4 if rms else 8) * d + 4, 40 * m * d, F32_OPS),
               no_lib, out=bytes_of(got))
    check_int8_attention(dev, gen, timer, record, randn, heads=[
        ("whisper", WH_H, WH_H, WH_D)], streaming=False, t=WH_T)
    check_int8_attention(dev, gen, timer, record, randn, heads=[
        ("vision", 64, 8, 128)], streaming=False)
    check_flash_attention(dev, gen, timer, record, randn, heads=[
        ("whisper", WH_H, WH_H, WH_D)], t=WH_DEC_T)
    heads = ((WH_H, WH_H, WH_D), (64, 8, 128))
    check_decode_attention(dev, gen, timer, record, randn, shapes=[
        (8, 1024, h, hkv, d, (0,)) for h, hkv, d in heads])
    check_decode_rows(dev, gen, timer, record, randn, forms=(False,),
                      heads=heads)
    check_int8_gemm(dev, gen, timer, record, randn, shapes=I8_XATTN,
                    extras=False)
    check_int4_gemm(dev, gen, timer, record, randn, shapes=W4_XATTN)
    check_dual_int4_gemm_gated(dev, gen, timer, record, randn, cases=[
        (VIS_D, VIS_FF, 64, m, "silu") for m in (8, 256)])
    torch.cuda.empty_cache()


# serving tensor parallelism's launches (``dist/tp.py``): a rank runs the
# column-parallel projections on N / tp columns, the row GEMMs (overlap) on
# M / tp rows and attention on its Hq / tp heads over Hkv / tp cache heads;
# each must equal the matching slice of the unsharded launch.  Rows: a
# bucket-1 step of 8 lanes and a bucket-256 step (2048 rows).
TP_ROWS = (8, 2048)
# (label, K, N, epilogue, bias, form, tps, sharded): codeqwen1.5-7b's W4A8
# projections (int4_gemm, group 64; the gated MLP dual_int4_gemm_gated) and
# starcoder2-3b's W8A8 (int8_gemm); "cols" split N, "rows" split M
TP_GEMMS = (
    ("codeqwen q_proj+bias", 4096, 4096, "scaled", True, "w4", (2, 4),
     "cols"),
    ("codeqwen gate+up", 4096, 13440, "silu", False, "dual_w4", (2, 4),
     "cols"),
    ("codeqwen o_proj+residual", 4096, 4096, "scaled_add", False, "w4",
     (2, 4), "rows"),
    ("codeqwen mlp_down", 13440, 4096, "scaled", False, "w4", (2, 4),
     "rows"),
    ("starcoder q_proj+bias", 3072, 3072, "scaled", True, "w8", (2,),
     "cols"),
    ("starcoder kv_proj+bias", 3072, 256, "scaled", True, "w8", (2,),
     "cols"),
    ("starcoder mlp_up+gelu", 3072, 12288, "scaled_gelu", False, "w8",
     (2,), "cols"),
    ("starcoder o_proj+residual", 3072, 3072, "scaled_add", False, "w8",
     (2,), "rows"),
    ("starcoder mlp_down", 12288, 3072, "scaled", False, "w8", (2,),
     "rows"))
# (label, Hq, Hkv, tps): the decode kernels at codeqwen's 32/32 heads
# (16 and 8 a rank, G = 1) and starcoder's 24/2 (12 over one KV head a
# rank, G = 12), T = 1 and a T = 64 rows launch, dense and paged
TP_HEADS = (("codeqwen", 32, 32, (2, 4)), ("starcoder", 24, 2, (2,)))
TP_DECODE_T = (1, 64)
# the bf16 gated MLP's column shards of phase 9's bf16 cell: codeqwen's
# [M, 4096] x 2 [4096, 13440 / tp]
TP_BF16_GATED = (("codeqwen bf16 gate+up", 4096, 13440, (2,)),)


def check_tp_shapes(dev, gen, timer, record, randn) -> None:
    """Phase 3 at the launches of tensor-parallel serving: every rank's
    launch of ``TP_GEMMS`` and ``TP_HEADS`` ``torch.equal`` to the matching
    column, row or head slice of the unsharded launch; the GEMMs also
    ``torch.equal`` to their plain versions, the decode kernels within
    RTOL/ATOL of theirs (with the cache split sized for the full head
    count, ``split_hkv``: with the rank's own count the split — and the
    bits — would change; that count of differing values is logged).  Rank
    0's launch is timed beside its plain version."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.int8_gemm import (
        DUAL_BF16_ATOL, DUAL_BF16_RTOL, gated_mlp_ref, gated_mlp_w4a8_ref,
        gemm_w4a8_ref, gemm_w8a8_ref, unpack_int4_ref)
    from repro_torch.kernels.int8_kv_decode_attention import (
        ATOL, RTOL, int8_kv_decode_attention_rows_ref)
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention_rows_ref)
    from repro_torch.kernels.quantize import quantize_rows_ref
    from repro_torch.models.attention import _quant_kv
    from repro_torch.models.layers import (GELU_INT_SCALE, SILU_INT_SCALE,
                                           quantize_weight,
                                           quantize_weight_w4)

    def sliced(what, out, want):
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(
                f"{what}: {int((out != want).sum())} of {out.numel()} differ "
                f"from the matching slice of the unsharded launch")

    def gemm(form, x_q, x_s, w, bias, res, epi):
        if form == "dual_w4":
            return ops.gated_mlp_w4a8(x_q, x_s, *w, act="silu",
                                      act_scale=SILU_INT_SCALE)
        gs = GELU_INT_SCALE if epi == "scaled_gelu" else None
        if form == "w4":
            return ops.gemm_w4a8(x_q, x_s, *w, bias=bias, residual=res,
                                 gelu_scale=gs)
        return ops.gemm_w8a8(x_q, x_s, *w, bias=bias, residual=res,
                             gelu_scale=gs)

    def plain(form, x_q, x_s, w, bias, res, epi):
        m = x_q.shape[0]
        if form == "dual_w4":
            return by_rows(lambda r0, r1: gated_mlp_w4a8_ref(
                x_q[r0:r1], x_s[r0:r1], *w, act="silu",
                act_scale=SILU_INT_SCALE), m)
        gs = GELU_INT_SCALE if epi == "scaled_gelu" else None
        ref = gemm_w4a8_ref if form == "w4" else gemm_w8a8_ref
        return by_rows(lambda r0, r1: ref(
            x_q[r0:r1], x_s[r0:r1], *w, bias=bias, gelu_scale=gs,
            residual=None if res is None else res[r0:r1]), m)

    for label, k, n, epi, has_bias, form, tps, split in TP_GEMMS:
        kernel = {"w4": "int4_gemm", "w8": "int8_gemm",
                  "dual_w4": "dual_int4_gemm_gated"}[form]
        if form == "w8":
            wd = quantize_weight(randn(k, n, scale=k ** -0.5))
            full_w = [(wd["w_q"], wd["scale"])]
        else:
            wds = [quantize_weight_w4(randn(k, n, scale=k ** -0.5))
                   for _ in range(2 if form == "dual_w4" else 1)]
            full_w = [(d["w4"], d["qmul"], d["scale"]) for d in wds]
        full_w = [t for ws in full_w for t in ws]
        bias = randn(n, scale=0.1) if has_bias else None
        for m in TP_ROWS:
            x_q, x_s = quantize_rows_ref(randn(m, k))
            res = (randn(m, n).to(torch.bfloat16) if epi == "scaled_add"
                   else None)
            whole = gemm(form, x_q, x_s, full_w, bias, res, epi)
            for tp in tps:
                for rank in range(tp):
                    if split == "cols":
                        nl = n // tp
                        cols = slice(rank * nl, (rank + 1) * nl)
                        args = (x_q, x_s, [w[..., cols].contiguous()
                                           for w in full_w],
                                None if bias is None else bias[cols], res,
                                epi)
                        want, shape = whole[:, cols], (
                            f"[{m},{k}]x{'2' if form == 'dual_w4' else ''}"
                            f"[{k},{nl}]")
                    else:
                        ml = m // tp
                        rows = slice(rank * ml, (rank + 1) * ml)
                        args = (x_q[rows], x_s[rows], full_w, bias,
                                None if res is None else res[rows], epi)
                        want, shape = whole[rows], f"[{ml},{k}]x[{k},{n}]"
                    out = gemm(form, *args)
                    what = f"tp{tp} rank {rank} {label} {shape}"
                    sliced(f"{kernel} {what}", out, want)
                    same(kernel, what, out, plain(form, *args))
                    if rank:
                        continue
                    ma, kb = args[0].shape[0], out.shape[1]
                    wbytes = sum(w.numel() * w.element_size() for w in args[2])
                    nbytes = (ma * k + 4 * ma + wbytes
                              + (4 * kb if bias is not None else 0)
                              + (2 * ma * kb if res is not None else 0)
                              + ma * kb * out.element_size())
                    n_ops = 2 * ma * kb * k * (2 if form == "dual_w4" else 1)
                    slow = ma > PLAIN_ROWS
                    # torch._int_mm of the shard's int8 weights (the W4
                    # streams unpacked): int32 out, no scales, epilogue or
                    # activation, as on the unsharded shapes
                    lib_w = ([args[2][0]] if form == "w8" else
                             [unpack_int4_ref(args[2][i], k)
                              for i in ((0, 3) if form == "dual_w4" else (0,))])
                    record(kernel, f"tp{tp} {label} {shape} {epi}"
                           + (" g64" if form != "w8" else ""), 0.0, True,
                           timer(lambda: gemm(form, *args)),
                           timer(lambda: plain(form, *args), iters=3,
                                 warmup=1) if slow
                           else timer(lambda: plain(form, *args)),
                           int_mm_ms(timer, args[0], *lib_w),
                           bound(nbytes, n_ops, INT8_OPS),
                           "equal to its slice of the unsharded launch; "
                           "library: _int_mm" + ("" if form == "w8" else
                                                 " on unpacked weights")
                           + ", int32 out, not the same function", out)
            del whole
        torch.cuda.empty_cache()

    for label, k, n, tps in TP_BF16_GATED:
        wu, wg = (randn(k, n, scale=k ** -0.5).to(torch.bfloat16)
                  for _ in range(2))
        for m in TP_ROWS:
            x = randn(m, k).to(torch.bfloat16)
            whole = ops.gated_mlp(x, wu, wg, "silu")
            for tp in tps:
                nl = n // tp
                for rank in range(tp):
                    cols = slice(rank * nl, (rank + 1) * nl)
                    su, sg = wu[:, cols].contiguous(), wg[:, cols].contiguous()
                    out = ops.gated_mlp(x, su, sg, "silu")
                    shape = f"[{m},{k}]x2[{k},{nl}] silu"
                    sliced(f"dual_gemm_gated tp{tp} rank {rank} {label} "
                           f"{shape}", out, whole[:, cols])
                    ref = by_rows(lambda r0, r1: gated_mlp_ref(
                        x[r0:r1], su, sg, "silu"), m)
                    err = (out.float() - ref.float()).abs()
                    if not bool((err <= DUAL_BF16_ATOL + DUAL_BF16_RTOL
                                 * ref.float().abs()).all()):
                        raise AssertionError(
                            f"dual_gemm_gated tp{tp} {label} {shape}: max "
                            f"|d| {float(err.max())} beyond the tolerance")
                    if rank:
                        continue
                    record("dual_gemm_gated", f"tp{tp} {label} {shape}",
                           float(err.max()), False,
                           timer(lambda: ops.gated_mlp(x, su, sg, "silu")),
                           timer(lambda: by_rows(lambda r0, r1: gated_mlp_ref(
                               x[r0:r1], su, sg, "silu"), m)),
                           timer(lambda: (x @ su, x @ sg)),
                           bound(2 * m * k + 4 * k * nl + 2 * m * nl,
                                 4 * m * nl * k, BF16_OPS),
                           "equal to its slice of the unsharded launch; "
                           "library: two torch.matmul, no activation: not "
                           "the same function", out)
            del whole
        del wu, wg
        torch.cuda.empty_cache()

    d = 128
    for label, hq, hkv, tps in TP_HEADS:
        for paged in (False, True):
            if paged:
                arena, ppos, pt, last = paged_arena(dev, gen, randn, hkv, d,
                                                    True)
                kv = [arena["pk"], arena["pks"], arena["pv"], arena["pvs"]]
                meta, b = (ppos, pt), PAGED_B
                rows_fn = ops.paged_attention_decode_rows
                plain_fn = paged_decode_attention_rows_ref
                kernel = "paged_decode_attention"
            else:
                b, s = 8, 1024
                k_q, k_s = _quant_kv(randn(b, s, hkv, d))
                v_q, v_s = _quant_kv(randn(b, s, hkv, d))
                fill = torch.randint(max(TP_DECODE_T), s + 1, (b,),
                                     generator=gen, device=dev)
                fill[IDLE_LANE] = 0
                slot = torch.arange(s, device=dev)
                pos = torch.where(slot[None] < fill[:, None], slot[None],
                                  -1).to(torch.int32)
                last = (fill - 1).to(torch.int32)
                kv, meta = [k_q, k_s, v_q, v_s], (pos,)
                rows_fn = ops.decode_attention_int8kv_rows
                plain_fn = int8_kv_decode_attention_rows_ref
                kernel = "int8_kv_decode_attention"
            for t in TP_DECODE_T:
                qp = (last[:, None] - torch.arange(t - 1, -1, -1, device=dev,
                                                   dtype=torch.int32)[None])
                qp = torch.where((last[:, None] >= 0) & (qp >= 0), qp,
                                 -1).to(torch.int32).contiguous()
                q = randn(b, t, hq, d).to(torch.bfloat16)
                whole = rows_fn(q, *kv, *meta, qp)
                for tp in tps:
                    gq, gk = hq // tp, hkv // tp
                    for rank in range(tp):
                        qs = q[:, :, rank * gq:(rank + 1) * gq].contiguous()
                        kvs = [x[:, :, rank * gk:(rank + 1) * gk].contiguous()
                               for x in kv]
                        out = rows_fn(qs, *kvs, *meta, qp, split_hkv=hkv)
                        want = whole[:, :, rank * gq:(rank + 1) * gq]
                        what = (f"tp{tp} rank {rank} {label} "
                                f"{'paged' if paged else 'dense'} T={t} "
                                f"Hq={gq} Hkv={gk}")
                        sliced(f"{kernel} {what}", out, want)
                        ref = plain_fn(qs, *kvs, *meta, qp)
                        live = qp >= 0
                        if not (torch.isfinite(out).all() and torch.allclose(
                                out[live].float(), ref[live].float(),
                                rtol=RTOL, atol=ATOL)):
                            raise AssertionError(
                                f"{kernel} {what}: max |d| "
                                f"{max_err(out, ref)} beyond rtol={RTOL} "
                                f"atol={ATOL}")
                        if rank:
                            continue
                        own = rows_fn(qs, *kvs, *meta, qp)
                        torch.cuda.synchronize()
                        log(f"    {what}: split for Hkv={hkv} (as "
                            f"unsharded); for its own Hkv={gk}, "
                            f"{int((own != want).sum())} of {own.numel()} "
                            f"values differ from the unsharded launch")
                        if paged:
                            ptc = pt.long()
                            work = decode_work(
                                ppos[ptc].reshape(b, -1), qp, gq, gk, d,
                                slot_ids=(ptc[:, :, None] * PAGED_PS
                                          + torch.arange(PAGED_PS, device=dev)
                                          ).reshape(b, -1),
                                pos_bytes=4 * PAGED_PS * torch.unique(
                                    ptc[ptc > 0]).numel(), dense_rule=False)
                        else:
                            work = decode_work(meta[0], qp, gq, gk, d)
                        record(kernel, f"tp{tp} {label} "
                               f"{'paged' if paged else 'dense'} rows T={t} "
                               f"B={b} Hq={gq} Hkv={gk} D={d} split_hkv={hkv}",
                               max_err(out[live], ref[live]), False,
                               timer(lambda: rows_fn(qs, *kvs, *meta, qp,
                                                     split_hkv=hkv)),
                               timer(lambda: plain_fn(qs, *kvs, *meta, qp),
                                     iters=1, warmup=0), None,
                               bound(*work, F32_OPS),
                               "equal to its head slice of the unsharded "
                               "launch", out)
                del whole
        torch.cuda.empty_cache()


# bf16_gemm's cases: the float linears of the bf16 models at full width,
# (model, label, K, N, bias, TP form): "cols" are column-sharded under
# serving TP (q, k, v, up), "rows" run on M / tp rows in the overlap form
# (o, down)
BF16_GEMMS = (
    ("codeqwen", "q", 4096, 4096, False, "cols"),
    ("codeqwen", "k", 4096, 4096, False, "cols"),
    ("codeqwen", "v", 4096, 4096, False, "cols"),
    ("codeqwen", "o", 4096, 4096, False, "rows"),
    ("codeqwen", "down", 13440, 4096, False, "rows"),
    ("starcoder", "q+bias", 3072, 3072, True, "cols"),
    ("starcoder", "kv+bias", 3072, 256, True, "cols"),
    ("starcoder", "o", 3072, 3072, False, "rows"),
    ("starcoder", "up", 3072, 12288, False, "cols"),
    ("starcoder", "down", 12288, 3072, False, "rows"))
BF16_TPS = (2, 4)
# shapes TMA cannot describe as they are: whisper-small's vocabulary (N) and
# a K that is not a multiple of 8; (label, K, N)
BF16_RAGGED = (("ragged N", 768, 51865), ("ragged K", 771, 768))
BF16_HOST_CALLS, BF16_HOST_ROUNDS = 400, 5


def check_bf16_gemm(dev, gen, timer, record, randn) -> None:
    """bf16_gemm (the port's float linear, ``ops.gemm_bf16``) at
    ``BF16_GEMMS`` for M in ``GEMM_ROWS``: the product within
    ``DUAL_BF16_RTOL``/``ATOL`` of its plain version (``bf16_gemm_ref``,
    cuBLAS on the card), the bias epilogue bit-equal to that product plus
    the bias in bf16 (a bias that cancels the product leaves the first
    rounding's error on a small output: no relative bound holds there),
    the same bits in two runs, every tiling the C entry takes
    (``autotune.bf16_gemm_candidates``) ``torch.equal`` to the table's launch, and —
    C20's gate — every tp 2 and tp 4 column shard (N / tp columns of the
    weight) and every row block (M / tp rows) ``torch.equal`` to its slice
    of the unsharded launch.  ``BF16_RAGGED``: a K or N that is not a
    multiple of 8 ``torch.equal`` to its slice of the zero-padded launch.
    Timed beside ``torch.matmul`` (the same function for the bias-free
    shapes; without the bias add otherwise) and the bound: bytes / 3.35
    TB/s or 2MNK / 989 TFLOP/s; rank 0's tp 2 shard launches timed too;
    the host's microseconds a launch (the least of ``BF16_HOST_ROUNDS``
    rounds of ``BF16_HOST_CALLS`` unsynchronized launches at codeqwen q,
    8 rows); each tiling's registers,
    spills and shared memory printed."""
    import torch.nn.functional as F

    from repro_torch.kernels import bf16_gemm as bg
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.int8_gemm import DUAL_BF16_ATOL, DUAL_BF16_RTOL
    bf = torch.bfloat16
    from repro_torch.kernels.autotune import bf16_gemm_candidates
    bf16_gemm_resources(build)

    def work(m, k, n, bias):
        return bound(2 * (m * k + k * n + m * n + (n if bias else 0)),
                     2 * m * n * k, BF16_OPS)

    def within_tol(got, ref, what):
        err = (got.float() - ref.float()).abs()
        if not (torch.isfinite(got).all() and bool(
                (err <= DUAL_BF16_ATOL + DUAL_BF16_RTOL
                 * ref.float().abs()).all())):
            raise AssertionError(f"bf16_gemm {what}: max |d| "
                                 f"{float(err.max())} beyond atol="
                                 f"{DUAL_BF16_ATOL} rtol={DUAL_BF16_RTOL}")
        return float(err.max())

    for model, label, k, n, has_bias, form in BF16_GEMMS:
        w = randn(k, n, scale=k ** -0.5).to(bf)
        b = randn(n, scale=0.1).to(bf) if has_bias else None
        for m in GEMM_ROWS:
            x = randn(m, k).to(bf)
            shape = f"{model} {label} [{m},{k}]x[{k},{n}]"
            prod, ref = ops.gemm_bf16(x, w), bg.bf16_gemm_ref(x, w)
            out, again = ops.gemm_bf16(x, w, b), ops.gemm_bf16(x, w, b)
            torch.cuda.synchronize()
            err = within_tol(prod, ref, shape)
            if b is not None and not torch.equal(out, prod + b):
                raise AssertionError(f"bf16_gemm {shape}: the bias epilogue "
                                     f"differs from the product + bias in "
                                     f"bf16")
            if not torch.equal(out, again):
                raise AssertionError(f"bf16_gemm {shape}: two runs on the "
                                     f"same inputs differ")
            for tl in bf16_gemm_candidates(m, k, n):
                got = bg._launch(x, w, b, tl)
                torch.cuda.synchronize()
                if not torch.equal(got, out):
                    raise AssertionError(
                        f"bf16_gemm {shape}: tiling {tl.bm}x{tl.bn}, "
                        f"{tl.stages} stages: {int((got != out).sum())} of "
                        f"{got.numel()} differ from the rule's tiling")
            # bias-free, the plain version is one torch.matmul: the library
            # call, timed once
            plain_ms = timer(lambda: bg.bf16_gemm_ref(x, w, b))
            case = record("bf16_gemm", shape, err, False,
                          timer(lambda: ops.gemm_bf16(x, w, b)), plain_ms,
                          plain_ms if b is None
                          else timer(lambda: torch.matmul(x, w)),
                          work(m, k, n, has_bias),
                          lib_note=None if b is None else "torch.matmul "
                          "without the bias add", out=out)
            if (model, label, m) == ("codeqwen", "q", GEMM_ROWS[0]):
                rounds = []
                for _ in range(BF16_HOST_ROUNDS):
                    for _ in range(8):
                        ops.gemm_bf16(x, w)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(BF16_HOST_CALLS):
                        ops.gemm_bf16(x, w)
                    rounds.append((time.perf_counter() - t0) * 1e6
                                  / BF16_HOST_CALLS)
                    torch.cuda.synchronize()
                case["host_us"] = min(rounds)
                log(f"  bf16_gemm {shape}: host {case['host_us']:.2f} us a "
                    f"launch (the least of {BF16_HOST_ROUNDS} rounds of "
                    f"{BF16_HOST_CALLS} unsynchronized launches: "
                    + ", ".join(f"{r:.2f}" for r in rounds) + ")")
            for tp in BF16_TPS:
                for rank in range(tp):
                    if form == "cols":
                        nl = n // tp
                        cols = slice(rank * nl, (rank + 1) * nl)
                        wr = w[:, cols].contiguous()
                        br = None if b is None else b[cols].contiguous()
                        xr, want = x, out[:, cols]
                        sh = f"[{m},{k}]x[{k},{nl}]"
                    else:
                        ml = max(m // tp, 1)
                        rows = slice(rank * ml, (rank + 1) * ml)
                        xr, wr, br, want = x[rows], w, b, out[rows]
                        sh = f"[{ml},{k}]x[{k},{n}]"
                    got = ops.gemm_bf16(xr, wr, br)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"bf16_gemm tp{tp} rank {rank} {model} {label} "
                            f"{sh}: {int((got != want).sum())} of "
                            f"{got.numel()} differ from the matching slice "
                            f"of the unsharded launch")
                    if rank or tp != BF16_TPS[0]:
                        continue
                    ma, kb = xr.shape[0], got.shape[1]
                    plain_ms = timer(lambda: bg.bf16_gemm_ref(xr, wr, br))
                    record("bf16_gemm", f"tp{tp} {model} {label} {sh}", 0.0,
                           True, timer(lambda: ops.gemm_bf16(xr, wr, br)),
                           plain_ms, plain_ms if br is None
                           else timer(lambda: torch.matmul(xr, wr)),
                           work(ma, k, kb, has_bias),
                           "equal to its slice of the unsharded launch", got)
        del w
        torch.cuda.empty_cache()
    for label, k, n in BF16_RAGGED:
        kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
        w = randn(k, n, scale=k ** -0.5).to(bf)
        b = randn(n, scale=0.1).to(bf)
        for m in (GEMM_ROWS[0], 256):
            x = randn(m, k).to(bf)
            shape = f"{label} [{m},{k}]x[{k},{n}]"
            out = ops.gemm_bf16(x, w, b)
            padded = ops.gemm_bf16(F.pad(x, (0, kp - k)),
                                   F.pad(w, (0, np_ - n, 0, kp - k)),
                                   F.pad(b, (0, np_ - n)))[:, :n]
            torch.cuda.synchronize()
            err = within_tol(ops.gemm_bf16(x, w), bg.bf16_gemm_ref(x, w),
                             shape)
            if not torch.equal(out, padded):
                raise AssertionError(
                    f"bf16_gemm {shape}: {int((out != padded).sum())} of "
                    f"{out.numel()} differ from the zero-padded launch "
                    f"[{m},{kp}]x[{kp},{np_}]")
            plain_ms = timer(lambda: bg.bf16_gemm_ref(x, w, b))
            record("bf16_gemm", shape, err, False,
                   timer(lambda: ops.gemm_bf16(x, w, b)), plain_ms,
                   timer(lambda: torch.matmul(x, w)), work(m, k, n, True),
                   "torch.matmul without the bias add; equal to the "
                   "zero-padded launch", out)
        del w
        torch.cuda.empty_cache()


def bf16_gemm_resources(build) -> None:
    """Print, for every tiling bf16_gemm's C entry takes, the registers
    and spills ``-Xptxas -v`` reported for its instantiation (where this
    process built the library) and the shared memory a block asks for."""
    import ctypes

    from repro_torch.kernels.autotune import BF16_GEMM_TILINGS
    ptxas = build.BUILD_LOG.get("bf16_gemm", {}).get("ptxas", "")
    lines = ptxas.splitlines()
    fn = build.entry("bf16_gemm", "repro_bf16_gemm_attrs",
                     [build.I] * 3 + [build.VP])
    for bm, bn, stages, x_rows in BF16_GEMM_TILINGS:
        attrs = (ctypes.c_int * 3)()
        build.check_rc(fn(bm, bn, stages, ctypes.addressof(attrs)),
                       "bf16_gemm attributes")
        tag = f"TileILi{bm}ELi{bn}ELi{stages}E"
        said = []
        for i, ln in enumerate(lines):
            if "Compiling entry" in ln and tag in ln:
                said = [x.strip() for x in lines[i + 1:i + 3]]
        log(f"  bf16_gemm tiling {bm}x{bn}, {stages} stages of {x_rows} x rows: "
            f"{attrs[0]} registers, {attrs[1]} bytes local (spills), "
            f"{attrs[2]} bytes dynamic shared memory"
            + (f" | ptxas: {' | '.join(said)}" if said else
               " | ptxas: built before this process"))


KERNEL_CASES = {"quantize_rows": (check_quantize_rows, ("quantize",)),
                "bf16_gemm": (check_bf16_gemm, ("bf16_gemm",)),
                "int_layernorm": (check_int_layernorm,
                                  ("int_layernorm", "quantize")),
                "flash_attention": (check_flash_attention,
                                    ("flash_attention",)),
                "int4_gemm": (check_int4_gemm, ("int4_gemm",)),
                "dual_gemm_gated": (check_dual_gemm_gated,
                                    ("dual_gemm_gated",)),
                "dual_int4_gemm_gated": (check_dual_int4_gemm_gated,
                                         ("dual_int4_gemm_gated",)),
                "int8_gemm": (check_int8_gemm, ("int8_gemm",)),
                "int8_kv_decode_attention": (check_dense_decode,
                                             ("int8_kv_decode_attention",)),
                "paged_decode_attention": (check_paged_decode,
                                           ("paged_decode_attention",
                                            "int8_kv_decode_attention")),
                "int8_flash_attention": (check_int8_attention,
                                         ("int8_flash_attention",)),
                "ssd_scan": (check_ssd_scan, ("ssd_scan",)),
                "int8_conv2d": (check_int8_conv2d, ("int8_conv2d",)),
                "int_softmax": (check_int_softmax, ("int_softmax",)),
                "experts": (check_experts, ("quantize", "int8_gemm",
                                            "int4_gemm", "dual_gemm_gated",
                                            "dual_int4_gemm_gated")),
                "window_decode": (check_window_decode,
                                  ("int8_kv_decode_attention",
                                   "paged_decode_attention")),
                "gqa_xlstm": (check_gqa_xlstm,
                              ("quantize", "int8_gemm", "int4_gemm",
                               "dual_gemm_gated", "dual_int4_gemm_gated",
                               "int8_kv_decode_attention",
                               "paged_decode_attention",
                               "int8_flash_attention")),
                "encdec_xattn": (check_encdec_xattn,
                                 ("quantize", "int_layernorm", "int8_gemm",
                                  "int4_gemm", "dual_int4_gemm_gated",
                                  "int8_kv_decode_attention",
                                  "int8_flash_attention",
                                  "flash_attention")),
                "tp_shapes": (check_tp_shapes,
                              ("int8_gemm", "int4_gemm", "dual_gemm_gated",
                               "dual_int4_gemm_gated",
                               "int8_kv_decode_attention",
                               "paged_decode_attention"))}


# ---------------------------------------------------------------------------
# phase 4: the reduced model, CPU plain versions vs CUDA kernels
# ---------------------------------------------------------------------------

# (arch, precision, kernels the reduced steps must launch on the card)
# (the fused norm counts as int_layernorm; every int8 KV write launches
# quantize_rows)
REDUCED_PATHS = (
    ("starcoder2-3b", "w8a8", ("int8_gemm", "int8_kv_decode_attention",
                               "int_layernorm", "quantize_rows")),
    ("codeqwen1.5-7b", "w4a8", ("int4_gemm", "dual_int4_gemm_gated",
                                "int8_kv_decode_attention", "int_layernorm",
                                "quantize_rows")),
    ("codeqwen1.5-7b", "w8a8", ("dual_gemm_gated", "int8_kv_decode_attention",
                                "int_layernorm", "quantize_rows")),
    ("codeqwen1.5-7b", "bf16", ("dual_gemm_gated", "int8_kv_decode_attention",
                                "quantize_rows")),
    # the MoE paths: the expert-batched forms (one launch a layer), mixtral's
    # decode kernels with the window
    ("mixtral-8x7b", "w4a8", ("int4_gemm.experts",
                              "dual_int4_gemm_gated.experts",
                              "int8_kv_decode_attention.window",
                              "int_layernorm", "quantize_rows")),
    ("mixtral-8x7b", "w8a8", ("int8_gemm.experts", "dual_gemm_gated.experts",
                              "int8_kv_decode_attention.window",
                              "int_layernorm", "quantize_rows")),
    ("qwen2-moe-a2.7b", "w8a8", ("int8_gemm.experts",
                                 "dual_gemm_gated.experts", "dual_gemm_gated",
                                 "int8_kv_decode_attention", "int_layernorm",
                                 "quantize_rows")),
    ("qwen2-moe-a2.7b", "w4a8", ("int4_gemm.experts",
                                 "dual_int4_gemm_gated.experts",
                                 "dual_int4_gemm_gated",
                                 "int8_kv_decode_attention", "int_layernorm",
                                 "quantize_rows")),
    # the dense GQA paths at their own G (``reduced_config``)
    ("internlm2-20b", "w8a8", ("int8_gemm", "dual_gemm_gated",
                               "int8_kv_decode_attention", "int_layernorm",
                               "quantize_rows")),
    ("yi-34b", "w4a8", ("int4_gemm", "dual_int4_gemm_gated",
                        "int8_kv_decode_attention", "int_layernorm",
                        "quantize_rows")),
)
# (query heads, KV heads) of the G-preserving reduced configs: ``reduced()``
# gives every arch 4 heads over at most 2 KV heads, so internlm2-20b (G = 6),
# yi-34b (G = 7) and llama-3.2-vision-90b (G = 8) keep their G over 2 KV
# heads of 16, and whisper-small stays multi-head (G = 1)
REDUCED_GQA = {"internlm2-20b": (12, 2), "yi-34b": (14, 2),
               "llama-3.2-vision-90b": (16, 2), "whisper-small": (4, 4)}


def reduced_config(arch: str, precision: str):
    """The reduced config of ``arch`` at ``precision``; G-preserving for the
    archs of ``REDUCED_GQA``."""
    from repro_torch.configs import get_config
    cfg = get_config(arch, precision=precision, reduced=True)
    if arch in REDUCED_GQA:
        h, hkv = REDUCED_GQA[arch]
        cfg = dataclasses.replace(cfg, n_heads=h, n_kv_heads=hkv)
    return cfg
# The MoE paths against the card-order CPU at W8A8/W4A8: every integer
# kernel is bit-exact, but the decode kernels agree with their plain
# versions only to a tolerance (C8's card order runs those plain versions),
# and the router and the shared gate are f32 products summed in the
# library's order; a last-bit difference that moves an int8 level or a
# bf16 routing weight can move a top-k choice and with it whole expert
# outputs.  Measured on an H100 (80GB HBM3, 700 W), three seeds: 0 for
# mixtral-reduced but 1.85% at W8A8 seed 2 (its ring wrapped), 2.9-4.0e-7
# for qwen2-moe-reduced.  Held to CARD_ORDER_TOL of the range.
MOE_ORDER_TOL = CARD_ORDER_TOL


def card_order_step(params, cfg, tokens, positions, states, last_idx):
    """``packed_step`` with the int8-cache attention in the card's order
    (``forward(card_order=True)``): on the CPU, each row through the decode
    kernels' plain versions (ROADMAP C8)."""
    from repro_torch.models import forward
    lg, states = forward(params, cfg, tokens, positions, states,
                         card_order=True)
    return lg[torch.arange(lg.shape[0]), last_idx], states


def check_reduced(dev, seed, arch: str, precision: str, must_launch,
                  main: bool = True) -> dict:
    """The reduced model's packed steps (a t = 16 step of mixed lengths,
    then t = 1 steps: 5, or 5 + the window for a windowed model, whose
    window-slot ring then wraps) on the CPU (plain versions, the reference's ``_sdpa``
    order), on the CPU in the card's order (``card_order_step``) and on the
    card (kernels; the t = 16 step through the decode kernel's multi-row
    form).  At every seed the card must equal the card-order CPU bit for bit
    at W8A8/W4A8 (a MoE model within ``MOE_ORDER_TOL``), and lie within
    ``CARD_ORDER_TOL`` of it at bf16; at the ``main`` seed a dense model
    must also lie within ``REDUCED_TOL`` of the ``_sdpa`` CPU, with greedy
    agreement where the margin is clear (a MoE model's difference there is
    logged: a bf16 rounding of an attention probability can flip a top-k
    choice, 40% of the logits' range at mixtral-reduced seed 0).  Returns
    the worst relative differences."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.models import init_params, init_states
    from repro_torch.quant import quantize_for
    from repro_torch.serve import packed_step

    cfg = reduced_config(arch, precision)
    cpu = quantize_for(init_params(cfg, seed=seed, device="cpu"), precision)
    gpu = copy.deepcopy(cpu).to(dev)
    lanes, t = 4, 16
    st_c = init_states(cfg, lanes, 64, int8_kv=True, device="cpu")
    st_o = init_states(cfg, lanes, 64, int8_kv=True, device="cpu")
    st_g = init_states(cfg, lanes, 64, int8_kv=True, device=dev)
    rng = np.random.default_rng(seed)
    lens = np.array([16, 9, 3, 12])
    tok = rng.integers(2, cfg.vocab_size, size=(lanes, t))
    pos = np.where(np.arange(t)[None] < lens[:, None], np.arange(t)[None], -1)
    last = lens - 1
    worst = {"sdpa": 0.0, "card_order": 0.0}
    before = ops.launch_counts(forms=True)
    rows_before = LAUNCHES["int8_kv_decode_attention.rows"]
    # a windowed model steps on until its ring (window slots) has wrapped
    n_steps = 6 + cfg.sliding_window
    for step in range(n_steps):
        args = [torch.from_numpy(a) for a in (tok.astype(np.int64),
                                              pos.astype(np.int32),
                                              last.astype(np.int64))]
        lc, _ = packed_step(cpu, cfg, args[0], args[1], st_c, args[2])
        lo, _ = card_order_step(cpu, cfg, args[0], args[1], st_o, args[2])
        lg, _ = packed_step(gpu, cfg, args[0].to(dev), args[1].to(dev), st_g,
                            args[2].to(dev))
        lg = lg.cpu()
        err = float((lc - lg).abs().max())
        rel = err / float(lc.abs().max())
        rel_o = float((lo - lg).abs().max()) / float(lo.abs().max())
        worst["sdpa"] = max(worst["sdpa"], rel)
        worst["card_order"] = max(worst["card_order"], rel_o)
        if step < 6 or step == n_steps - 1:
            log(f"  seed {seed} step {step} (T={tok.shape[1]}): max |cpu - "
                f"cuda| = {err:.4g} ({rel:.3%} of max|logit|); card order "
                f"{rel_o:.3%}")
        limit = (CARD_ORDER_TOL if precision == "bf16" else
                 MOE_ORDER_TOL if cfg.n_experts else 0.0)
        if not (torch.isfinite(lg).all() and rel_o <= limit):
            raise AssertionError(f"reduced {arch} {precision} seed {seed}: "
                                 f"CUDA logits differ from the card-order "
                                 f"CPU path by {rel_o:.3%} (> {limit:.1%})")
        if main and not cfg.n_experts:
            # (a MoE model's routing is discontinuous in the router's input:
            # the _sdpa order's bf16 probabilities can move a top-k choice
            # and with it whole expert outputs, so only the card order,
            # above, holds the MoE paths)
            if rel > REDUCED_TOL:
                raise AssertionError(f"reduced {arch} {precision}: CUDA "
                                     f"logits differ from the CPU plain path "
                                     f"by {rel:.3%} (> {REDUCED_TOL:.0%})")
            top2 = lc.topk(2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > 2 * err
            if not torch.equal(lc.argmax(-1)[clear], lg.argmax(-1)[clear]):
                raise AssertionError(f"reduced {arch} {precision}: greedy "
                                     f"tokens differ where the CPU margin is "
                                     f"clear")
        # next step: every lane decodes the CPU argmax (same tokens on all)
        nxt = lc.argmax(-1).numpy()
        tok = nxt[:, None]
        pos = (pos.max(1) + 1)[:, None]
        last = np.zeros(lanes, np.int64)
    if cfg.sliding_window and int(st_g[0]["kv"]["pos_ids"].max()) < \
            st_g[0]["kv"]["pos_ids"].shape[1]:
        raise AssertionError(f"reduced {arch}: the ring did not wrap")
    after = ops.launch_counts(forms=True)
    idle = [k for k in must_launch if after[k] <= before[k]]
    if LAUNCHES["int8_kv_decode_attention.rows"] <= rows_before:
        idle.append("int8_kv_decode_attention.rows")
    if idle:
        raise AssertionError(f"reduced {arch} {precision} steps did not reach "
                             f"{idle}")
    return worst


def check_reduced_paged(dev, seed) -> float:
    """codeqwen1.5-7b-reduced w4a8 with a paged int8 arena (4 lanes, 16-slot
    pages, a scrambled page table): the same packed steps as
    ``check_reduced`` on the CPU (plain versions), on the card paged
    (kernels, the paged decode kernel at T = 1) and on the card dense.  The
    paged card logits must equal the dense card logits bit for bit, and lie
    within ``REDUCED_TOL`` of the CPU's."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params, init_states
    from repro_torch.quant import quantize_for
    from repro_torch.serve import packed_step

    cfg = get_config("codeqwen1.5-7b", precision="w4a8", reduced=True)
    cpu = quantize_for(init_params(cfg, seed=seed, device="cpu"), "w4a8")
    gpu = copy.deepcopy(cpu).to(dev)
    lanes, t, max_seq, ps = 4, 16, 64, 16
    mp = max_seq // ps
    n_pages = (lanes + 2) * mp + 1
    perm = np.random.default_rng(seed).permutation(np.arange(1, n_pages))
    table = torch.from_numpy(perm[:lanes * mp].reshape(lanes, mp).astype(
        np.int32))
    st_c = init_states(cfg, lanes, max_seq, int8_kv=True, device="cpu",
                       paged_pages=n_pages, page_size=ps)
    st_p = init_states(cfg, lanes, max_seq, int8_kv=True, device=dev,
                       paged_pages=n_pages, page_size=ps)
    st_d = init_states(cfg, lanes, max_seq, int8_kv=True, device=dev)
    st_c[0]["kv"]["pt"].copy_(table)          # one table, shared by layers
    st_p[0]["kv"]["pt"].copy_(table)
    rng = np.random.default_rng(seed)
    lens = np.array([16, 9, 3, 12])
    tok = rng.integers(2, cfg.vocab_size, size=(lanes, t))
    pos = np.where(np.arange(t)[None] < lens[:, None], np.arange(t)[None], -1)
    last = lens - 1
    worst = 0.0
    before = ops.launch_counts()
    for step in range(6):
        args = [torch.from_numpy(a) for a in (tok.astype(np.int64),
                                              pos.astype(np.int32),
                                              last.astype(np.int64))]
        lc, _ = packed_step(cpu, cfg, args[0], args[1], st_c, args[2])
        on_dev = [a.to(dev) for a in args]
        lp, _ = packed_step(gpu, cfg, *on_dev[:2], st_p, on_dev[2])
        ld, _ = packed_step(gpu, cfg, *on_dev[:2], st_d, on_dev[2])
        torch.cuda.synchronize()
        if not torch.equal(lp, ld):
            raise AssertionError(f"reduced paged step {step}: paged logits "
                                 f"differ from dense on the card (max |d| "
                                 f"{max_err(lp, ld)})")
        lp = lp.cpu()
        err = float((lc - lp).abs().max())
        rel = err / float(lc.abs().max())
        worst = max(worst, rel)
        log(f"  paged step {step} (T={tok.shape[1]}): paged == dense on the "
            f"card; max |cpu - cuda| = {err:.4g} ({rel:.3%} of max|logit|)")
        if not (torch.isfinite(lp).all() and rel <= REDUCED_TOL):
            raise AssertionError(f"reduced paged codeqwen w4a8: CUDA logits "
                                 f"differ from the CPU plain path by "
                                 f"{rel:.3%} (> {REDUCED_TOL:.0%})")
        nxt = lc.argmax(-1).numpy()
        tok = nxt[:, None]
        pos = (pos.max(1) + 1)[:, None]
        last = np.zeros(lanes, np.int64)
    after = ops.launch_counts()
    if after["paged_decode_attention"] <= before["paged_decode_attention"]:
        raise AssertionError("reduced paged steps did not reach "
                             "paged_decode_attention")
    return worst


# (arch, precision) of the reduced no-cache forwards
REDUCED_NO_CACHE = (("starcoder2-3b", "bf16"), ("starcoder2-3b", "w8a8"),
                    ("codeqwen1.5-7b", "bf16"), ("codeqwen1.5-7b", "w8a8"),
                    ("codeqwen1.5-7b", "w4a8"), ("zamba2-2.7b", "bf16"),
                    ("zamba2-2.7b", "w8a8"), ("zamba2-2.7b", "w4a8"))


# (arch, its integer activation kernel) of the reduced integer-nonlinearity
# forwards over float weights (a w8a8 config, parameters left float)
REDUCED_MIXED = (("codeqwen1.5-7b", "int_silu"), ("starcoder2-3b", "int_gelu"))


def no_cache_kernel(precision: str) -> str:
    """The attention kernel of the no-cache forward at ``precision``."""
    return "flash_attention" if precision == "bf16" else "int8_flash_attention"


def check_reduced_no_cache(dev, seed, arch: str, precision: str,
                           act_kernel: str | None = None) -> float:
    """The reduced model's no-cache forward (4 sequences x 32 tokens) on the
    CPU (plain versions; the bf16 path takes ``_sdpa``, which rounds the
    probabilities to bf16 before P@V, C3) and on the card (kernels): logits
    within ``REDUCED_TOL`` of the range, greedy tokens equal where the CPU
    top-2 margin is more than twice the difference, and the attention
    kernel launched once per layer.  With ``act_kernel`` the parameters stay
    float under the integer ``precision`` (the integer-nonlinearity
    forward), and that activation kernel must launch once per layer too."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import forward, init_params
    from repro_torch.quant import quantize_for

    cfg = get_config(arch, precision=precision, reduced=True)
    cpu = init_params(cfg, seed=seed, device="cpu")
    if act_kernel is None:
        cpu = quantize_for(cpu, precision)
    gpu = copy.deepcopy(cpu).to(dev)
    tok = torch.from_numpy(np.random.default_rng(seed).integers(
        2, cfg.vocab_size, size=(4, 32)))
    lc, _ = forward(cpu, cfg, tok)
    ops.reset_launch_counts()
    lg, _ = forward(gpu, cfg, tok.to(dev))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    lg = lg.cpu()
    err = float((lc - lg).abs().max())
    rel = err / float(lc.abs().max())
    log(f"  no-cache forward (4 x 32): max |cpu - cuda| = {err:.4g} "
        f"({rel:.3%} of max|logit|), launches {counts}")
    if not (torch.isfinite(lg).all() and rel <= REDUCED_TOL):
        raise AssertionError(f"reduced {arch} {precision} no-cache: CUDA "
                             f"logits differ from the CPU plain path by "
                             f"{rel:.3%} (> {REDUCED_TOL:.0%})")
    top2 = lc.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * err
    if not torch.equal(lc.argmax(-1)[clear], lg.argmax(-1)[clear]):
        raise AssertionError(f"reduced {arch} {precision} no-cache: greedy "
                             f"tokens differ where the CPU margin is clear")
    n_attn, n_mamba = layer_counts(cfg)
    want = {no_cache_kernel(precision): n_attn, "ssd_scan": n_mamba}
    if act_kernel is not None:
        want[act_kernel] = cfg.n_layers
    for kernel, n in want.items():
        if counts[kernel] != n:
            raise AssertionError(f"reduced {arch} {precision} no-cache: "
                                 f"{kernel} launched {counts[kernel]} times, "
                                 f"want {n} (one per layer of its kind)")
    return rel


def check_reduced_states(dev, seed, main: bool = True) -> dict:
    """zamba2-2.7b-reduced at W8A8 with an int8 KV cache, the forward with
    states: a prefill of 16 tokens per lane (t > 1: the Mamba-2 scan through
    ssd_scan, the shared attention's rows through the decode kernel's
    multi-row form) then 4 single-token steps (the one-step state update,
    the decode kernel), each feeding the CPU's greedy token, on the CPU
    (plain versions; and in the card's order) and on the card.  The same
    limits as ``check_reduced`` (``REDUCED_TOL`` and greedy agreement at the
    ``main`` seed), and ``STATES_TOL`` against the card-order CPU."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.models import forward, init_params, init_states
    from repro_torch.quant import quantize_for

    cfg = get_config("zamba2-2.7b", precision="w8a8", reduced=True)
    cpu = quantize_for(init_params(cfg, seed=seed, device="cpu"), "w8a8")
    gpu = copy.deepcopy(cpu).to(dev)
    lanes, t = 4, 16
    sts = {k: init_states(cfg, lanes, 64, int8_kv=True,
                          device=dev if k == "gpu" else "cpu")
           for k in ("cpu", "order", "gpu")}
    tok = torch.from_numpy(np.random.default_rng(seed).integers(
        2, cfg.vocab_size, size=(lanes, t)))
    pos = torch.arange(t, dtype=torch.int32).expand(lanes, t)
    worst = {"sdpa": 0.0, "card_order": 0.0}
    ops.reset_launch_counts()
    rows_before = LAUNCHES["int8_kv_decode_attention.rows"]
    for step in range(5):
        lc, sts["cpu"] = forward(cpu, cfg, tok, pos, sts["cpu"])
        lo, sts["order"] = forward(cpu, cfg, tok, pos, sts["order"],
                                   card_order=True)
        lg, sts["gpu"] = forward(gpu, cfg, tok.to(dev), pos.to(dev),
                                 sts["gpu"])
        lc, lo, lg = lc[:, -1], lo[:, -1], lg[:, -1].cpu()
        err = float((lc - lg).abs().max())
        rel = err / float(lc.abs().max())
        rel_o = float((lo - lg).abs().max()) / float(lo.abs().max())
        worst["sdpa"] = max(worst["sdpa"], rel)
        worst["card_order"] = max(worst["card_order"], rel_o)
        log(f"  step {step} (T={tok.shape[1]}): max |cpu - cuda| = {err:.4g} "
            f"({rel:.3%} of max|logit|); card order {rel_o:.3%}")
        if not (torch.isfinite(lg).all() and rel_o <= STATES_TOL):
            raise AssertionError(f"reduced zamba2 w8a8 with states seed "
                                 f"{seed}: CUDA logits differ from the "
                                 f"card-order CPU by {rel_o:.3g} of the "
                                 f"range (> {STATES_TOL:g})")
        top2 = lc.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * err
        if main and not (rel <= REDUCED_TOL and torch.equal(
                lc.argmax(-1)[clear], lg.argmax(-1)[clear])):
            raise AssertionError(f"reduced zamba2 w8a8 with states: CUDA "
                                 f"logits differ from the CPU by {rel:.3%} "
                                 f"(> {REDUCED_TOL:.0%}), or greedy tokens "
                                 f"where the CPU margin is clear")
        tok = lc.argmax(-1)[:, None]
        pos = pos[:, -1:] + 1
    counts = ops.launch_counts()
    n_attn, n_mamba = layer_counts(cfg)
    if not (counts["ssd_scan"] == n_mamba
            and counts["int8_kv_decode_attention"] == 5 * n_attn
            and LAUNCHES["int8_kv_decode_attention.rows"] - rows_before
            == n_attn):
        raise AssertionError(f"reduced zamba2 with states: launches {counts}, "
                             f"{LAUNCHES['int8_kv_decode_attention.rows']} "
                             f"multi-row; want ssd_scan {n_mamba} (prefill), "
                             f"the decode kernel {n_attn} x 5 of which "
                             f"{n_attn} multi-row")
    return worst


# ---------------------------------------------------------------------------
# phase 5: full-width serving
# ---------------------------------------------------------------------------

COMMON = ("quantize_rows", "int8_gemm", "int_layernorm",
          "int8_kv_decode_attention")
# (label, arch, precision, requests, new tokens each, profiled, kernels that
# must launch on the drain, paged drains after the dense one)
SERVE_PATHS = (
    ("starcoder2-3b w8a8", "starcoder2-3b", "w8a8", 16, 32, True, COMMON,
     False),
    ("codeqwen1.5-7b w4a8", "codeqwen1.5-7b", "w4a8", 16, 32, True,
     COMMON + ("int4_gemm", "dual_int4_gemm_gated"), True),
    ("codeqwen1.5-7b w8a8", "codeqwen1.5-7b", "w8a8", 4, 8, False,
     COMMON + ("dual_gemm_gated",), False),
)
PAGED_LABEL = "codeqwen1.5-7b w4a8 paged"


SCFG = dict(batch_lanes=8, max_seq=1024, int8_kv=True, token_budget=256)


def dense_requests(cfg, seed, n_req, max_new) -> list:
    """``n_req`` prompts of 16-256 tokens, uniform from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_req):
        n = int(rng.integers(16, 257))
        out.append((rng.integers(2, cfg.vocab_size, size=n).tolist(), max_new))
    return out


MULTI_ROW = ("int8_kv_decode_attention.rows", "paged_decode_attention.rows")


def timed_drain(engine, waves, dev, cfg, must_launch=(),
                reset_peak: bool = True, offsets=None) -> tuple[dict, dict]:
    """Submit each wave of (prompt, max_new) and drain it before the next;
    with ``offsets`` (seconds, one per request of a single wave) the wave
    goes through ``run_stream`` at those arrival times instead.  Launch
    counts are zeroed just before the first submit and read just after the
    last drain (``multi_row``: the decode kernels' launches with more than
    one row).  Returns (result, tokens by request id)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.common import LAUNCHES
    if reset_peak:
        torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    rows0 = {k: LAUNCHES[k] for k in MULTI_ROW}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rid = 0
    if offsets is not None:
        (wave,) = waves
        _, rejected = engine.run_stream([
            (float(off), dict(prompt=prompt, max_new=max_new, request_id=i))
            for i, (off, (prompt, max_new)) in enumerate(zip(offsets, wave))])
        if rejected:
            raise AssertionError(f"run_stream rejected {rejected}")
        rid = len(wave)
    for wave in waves if offsets is None else ():
        for prompt, max_new in wave:
            engine.submit(prompt, max_new=max_new, request_id=rid)
            rid += 1
        engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts(forms=True)
    multi_row = {k: LAUNCHES[k] - rows0[k] for k in MULTI_ROW}
    done = engine.finished
    if len(done) != rid:
        raise AssertionError(f"{len(done)} of {rid} requests finished")
    for r in done:
        if not r["tokens"] or not all(0 <= t < cfg.vocab_size for t in r["tokens"]):
            raise AssertionError(f"request {r['id']}: bad tokens {r['tokens']}")
    missing = [k for k in must_launch if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {cfg.name} "
                             f"path: {missing}")
    st = engine.stats
    gen = sum(len(r["tokens"]) for r in done)
    res = {"requests": len(done), "generated_tokens": gen,
           "prompt_tokens": st["prompt_tokens"],
           "prompt_len_sum": sum(len(p) for w in waves for p, _ in w),
           "steps": st["steps"],
           "forwards_by_bucket": {str(k): v for k, v in
                                  sorted(st["forwards"].items())},
           "wall_s": wall, "generated_tok_per_s": gen / wall,
           "processed_tok_per_s": (gen + st["prompt_tokens"]) / wall,
           "launches": counts, "multi_row": multi_row,
           "metrics": engine.serving_metrics(),
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "summary": engine.stats_summary()}
    return res, {r["id"]: r["tokens"] for r in done}


def fresh_states(cfg, dev, paged: bool) -> list:
    """Fresh int8 caches of 8 lanes x 1024 slots: dense, or the paged
    arena with every lane's 64 logical pages mapped to distinct physical
    pages (512 of the 641), so that a decode step reads as many distinct
    bytes as the dense cache's."""
    from repro_torch.models import init_states
    if not paged:
        return init_states(cfg, 8, 1024, int8_kv=True, device=dev)
    st = init_states(cfg, 8, 1024, int8_kv=True, device=dev,
                     paged_pages=PAGED_POOL, page_size=PAGED_PS)
    st[0]["kv"]["pt"][:] = torch.arange(
        1, PAGED_B * PAGED_MP + 1, dtype=torch.int32,
        device=dev).reshape(PAGED_B, PAGED_MP)
    return st


def decode_step_launches(params, cfg, dev, paged: bool) -> tuple[dict, dict]:
    """One all-decode step (bucket 1, 8 lanes at position 0) on fresh caches
    (``fresh_states``): the launches of each kernel; the host's
    synchronizing calls in the step (``torch.cuda.set_sync_debug_mode
    ("warn")`` warns once for each: a copy to or from pageable host memory,
    ``nonzero``, a stream synchronize), counted by the Python line that made
    them; and finite logits of the expected shape."""
    import warnings

    from repro_torch.kernels import ops
    from repro_torch.models import forward
    st = fresh_states(cfg, dev, paged)
    tok = torch.full((8, 1), 5, device=dev)
    pos = torch.zeros((8, 1), dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    before = ops.launch_counts(forms=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            lg, _ = forward(params, cfg, tok, pos, st)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    after = ops.launch_counts(forms=True)
    syncs = collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    if tuple(lg.shape) != (8, 1, cfg.padded_vocab) or not torch.isfinite(lg).all():
        raise AssertionError(f"decode logits: shape {tuple(lg.shape)}, "
                             f"finite={bool(torch.isfinite(lg).all())}")
    return {k: after[k] - before[k] for k in after}, syncs


def serve_full(dev, seed, arch, precision, n_req, max_new, profiled,
               must_launch, paged: bool = False, buckets=(1, 64),
               extras: bool = False) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.quant import quantize_for
    from repro_torch.models import init_params
    from repro_torch.serve import ServeConfig, ServingEngine

    torch.cuda.reset_peak_memory_stats(dev)
    cfg = get_config(arch, precision=precision)
    t0 = time.perf_counter()
    params = quantize_for(init_params(cfg, seed=seed, device=dev), precision)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    after_ptq = torch.cuda.memory_allocated(dev) / 2 ** 30
    engine = ServingEngine(params, cfg, ServeConfig(**SCFG), device=dev)
    requests = dense_requests(cfg, seed, n_req, max_new)
    res, tokens = timed_drain(engine, [requests], dev, cfg, must_launch,
                              reset_peak=False)
    del engine
    per_step, syncs = decode_step_launches(params, cfg, dev, False)
    res.update(init_ptq_s=t_init, after_ptq_gib=after_ptq,
               launches_per_decode_step=per_step, syncs_per_decode_step=syncs)
    if profiled:
        res["profile"] = {f"bucket{t}": profile_step(params, cfg, dev, t)
                          for t in buckets}
    if paged:
        res["paged"] = serve_paged(dev, seed, cfg, params, requests, tokens,
                                   must_launch)
    if extras and (arch, precision) in EXTRA_DRAINS:
        res["extra"], info = EXTRA_DRAINS[(arch, precision)](
            dev, seed, cfg, params, requests, tokens, must_launch)
        res.update(info)
    return res


def count_diff(got: dict, want: dict) -> int:
    """Generated tokens of ``got`` that differ from ``want`` (position by
    position, plus any length difference)."""
    n = 0
    for rid, w in want.items():
        g = got[rid]
        n += sum(a != b for a, b in zip(g, w)) + abs(len(g) - len(w))
    return n


class ArenaChecks:
    """Card-side checks of the paged engine's in-place arena updates,
    installed on one engine, whatever its schedule: each copy-on-write page
    must equal its source on its ``keep`` slots (payload, scales,
    positions) with position -1 beyond them, and each resumed lane's pages
    must hold, bit for bit, what its pages held just before it was
    preempted (the swap to host memory and back)."""

    KEYS = ("pk", "pv", "pks", "pvs", "ppos")

    def __init__(self, eng):
        self.cow_pages = self.swap_pages = 0
        self._saved = {}
        copy, preempt, resume = (eng._copy_page, eng._preempt_lane,
                                 eng._try_resume)
        arenas = eng._arenas()

        def lane_pages(lane):
            js = [j for j in range(eng.pool.mp) if eng.pool.table[lane, j]]
            idx = torch.as_tensor(eng.pool.table[lane, js].astype(np.int64),
                                  device=eng.device)
            return js, [{k: kv[k][idx] for k in self.KEYS if k in kv}
                        for kv in arenas]

        def copy_page(src, dst, keep):
            copy(src, dst, keep)
            for kv in arenas:
                for k in self.KEYS:
                    if k in kv and not torch.equal(kv[k][dst, :keep],
                                                   kv[k][src, :keep]):
                        raise AssertionError(f"COW page {src} -> {dst}: "
                                             f"{k} differs on {keep} slots")
                if not (kv["ppos"][dst, keep:] == -1).all():
                    raise AssertionError(f"COW page {dst}: positions "
                                         f"beyond {keep} not cleared")
            self.cow_pages += 1

        def preempt_lane(lane):
            self._saved[id(eng.lane_request[lane])] = lane_pages(lane)
            preempt(lane)

        def try_resume(lane, req):
            if not resume(lane, req):
                return False
            js, before = self._saved.pop(id(req))
            now_js, after = lane_pages(lane)
            if now_js != js or any(not torch.equal(a[k], b[k])
                                   for a, b in zip(after, before) for k in a):
                raise AssertionError(f"lane {lane}: resumed pages differ "
                                     f"from the preempted lane's")
            self.swap_pages += len(js)
            return True

        eng._copy_page, eng._preempt_lane, eng._try_resume = (
            copy_page, preempt_lane, try_resume)


def serve_paged(dev, seed, cfg, params, requests, dense_tokens,
                must_launch) -> dict:
    """Three paged drains of the full-width model (int8 arena of 16-slot
    pages, the dense path's 8 lanes, max_seq 1024 and token budget 256),
    reusing its parameters:

    1. same-schedule: the dense drain's requests.  With no prefix hit the
       schedule is the dense one, so its tokens must equal the dense
       drain's exactly; its launches include paged_decode_attention and not
       int8_kv_decode_attention;
    2. shared prefix: one 200-token prefix + 16-64 unique tokens each, 32
       new tokens; request 0 alone first (its prompt registers), then the
       other 15 together.  prefix_hit_tokens >= 15 x 192, that many fewer
       prompt tokens fed, at least one copy-on-write;
    3. pressure: a 66-page pool (mp + 2), 8 requests of 200-256 prompt
       tokens x 16 new: preemptions, resumes, swap-out == swap-in pages.

    Every paged drain runs under ``ArenaChecks``, which hold the arena's
    in-place updates on the card whatever the schedule: each COW page
    against its source, each resumed lane's pages against what they held
    before it was preempted, bit for bit.

    Drains 2 and 3 change the batch composition (a lane's rows move
    between packed t > 1 steps and t == 1 steps); every int8-cache row runs
    the decode kernel's arithmetic at its position either way (the
    multi-row form, ROADMAP C3), so their tokens must equal those of a
    dense and an unpressured run of the same requests: 0 differences.
    ``pool.check()`` holds after each paged drain."""
    from repro_torch.serve import ServeConfig, ServingEngine
    paged_must = tuple(k for k in must_launch
                       if k != "int8_kv_decode_attention") + (
                           "paged_decode_attention",)
    out = {}

    def engine(**kw):
        return ServingEngine(params, cfg, ServeConfig(**{**SCFG, **kw}),
                             device=dev)

    def paged_drain(label, waves, **kw):
        eng = engine(paged=True, page_size=PAGED_PS, **kw)
        checks = ArenaChecks(eng)
        res, tok = timed_drain(eng, waves, dev, cfg, paged_must)
        eng.pool.check()
        res["pool"] = dict(eng.pool.stats, n_pages=eng.pool.n,
                           page_size=eng.pool.ps)
        res["checked_pages"] = {"cow": checks.cow_pages,
                                "swap": checks.swap_pages}
        out[label] = res
        return res, tok

    # 1. same schedule as the dense drain
    res, tok = paged_drain("same-schedule", [requests])
    if res["launches"]["int8_kv_decode_attention"]:
        raise AssertionError("the paged drain launched the dense decode "
                             "kernel")
    res["tokens_differ"] = count_diff(tok, dense_tokens)
    res["compared_with"] = "the dense drain"
    res["equal_required"] = res["pool"]["prefix_hit_tokens"] == 0
    if res["equal_required"] and res["tokens_differ"]:
        raise AssertionError(f"same-schedule paged drain: "
                             f"{res['tokens_differ']} tokens differ from "
                             f"the dense drain")
    res["launches_per_decode_step"], res["syncs_per_decode_step"] = (
        decode_step_launches(params, cfg, dev, True))
    res["profile"] = {"bucket1": profile_step(params, cfg, dev, 1, True)}

    # 2. shared prefix: request 0 registers, the other 15 share it
    rng = np.random.default_rng([seed, 2])
    prefix = rng.integers(2, cfg.vocab_size, size=200).tolist()
    shared = [(prefix + rng.integers(2, cfg.vocab_size, size=int(
        rng.integers(16, 65))).tolist(), 32) for _ in range(16)]
    waves = [shared[:1], shared[1:]]
    res, tok = paged_drain("shared-prefix", waves)
    need = 15 * (200 // PAGED_PS) * PAGED_PS
    fed_less = res["prompt_len_sum"] - res["prompt_tokens"]
    if not (res["pool"]["prefix_hit_tokens"] >= need and fed_less >= need
            and res["pool"]["cow_copies"] >= 1
            and res["checked_pages"]["cow"] == res["pool"]["cow_copies"]):
        raise AssertionError(f"shared-prefix drain: {res['pool']}, "
                             f"{fed_less} prompt tokens skipped (need "
                             f">= {need}, and a copy-on-write)")
    ref, ref_tok = timed_drain(engine(), waves, dev, cfg)
    res.update(tokens_differ=count_diff(tok, ref_tok),
               compared_with="the same waves served dense",
               equal_required=True, reference=ref)
    if res["tokens_differ"]:
        raise AssertionError(f"shared-prefix drain: {res['tokens_differ']} "
                             f"tokens differ from the same waves served "
                             f"dense")

    # 3. pressure: a pool of mp + 2 pages for 8 long prompts
    pressure = [(rng.integers(2, cfg.vocab_size, size=int(
        rng.integers(200, 257))).tolist(), 16) for _ in range(8)]
    res, tok = paged_drain("pressure", [pressure], pool_pages=PAGED_MP + 2)
    m = res["metrics"]
    if not (m["preemptions"] >= 1 and m["resumes"] >= 1
            and m["swap_out_pages"] == m["swap_in_pages"]
            == res["checked_pages"]["swap"] >= 1):
        raise AssertionError(f"pressure drain: {m}")
    ref, ref_tok = timed_drain(engine(paged=True, page_size=PAGED_PS),
                               [pressure], dev, cfg)
    res.update(tokens_differ=count_diff(tok, ref_tok),
               compared_with="the same requests on the default pool",
               equal_required=True, reference=ref)
    if res["tokens_differ"]:
        raise AssertionError(f"pressure drain: {res['tokens_differ']} tokens "
                             f"differ from the same requests on the default "
                             f"pool")
    return out


# ---------------------------------------------------------------------------
# phase 5, the rest of the engine: schedules, sampling, warmup, run_stream,
# self-speculation and zamba2-2.7b served tokenwise
# ---------------------------------------------------------------------------

# the schedule drains: phase 5's first SCHED_REQ requests, prompts cut to
# SCHED_CUT tokens, SCHED_NEW new tokens each
SCHED_REQ, SCHED_CUT, SCHED_NEW = 8, 128, 16
SCHEDULES = (("packed", {}),
             ("chunked", dict(token_budget=0, prefill_chunk=32)),
             ("tokenwise", dict(token_budget=0, prefill_chunk=0)))
TEMPERATURE = 0.7
SPEC_K = 4
STREAM_SPAN_S = 2.0    # run_stream's arrivals: offsets 0 .. 2 s
# the kernels whose launches per forward the chunked and tokenwise drains
# report (B1, B9, B3, B5, B6)
PER_FORWARD = ("quantize_rows", "int_layernorm", "int8_gemm", "int4_gemm",
               "dual_int4_gemm_gated")


def per_forward(res: dict) -> dict:
    """Launches of ``PER_FORWARD``'s kernels per forward of a drain."""
    n = sum(res["forwards_by_bucket"].values())
    return {k: res["launches"][k] / n for k in PER_FORWARD
            if res["launches"][k]}


def sampler_cost(dev, seed, vocab: int, lanes: int = 8) -> dict:
    """The sampler at ``lanes`` x ``vocab`` logits (codeqwen1.5-7b's
    padded vocabulary): device ms of ``_sample`` at temperature
    ``TEMPERATURE`` and greedy (CUDA events, cold L2), its device kernels
    per call (torch.profiler), the host ms of the key fold of a step
    (``_keys_at``: threefry on the CPU, then one copy to the card); its
    uniforms bit-equal to the CPU's, and its draws equal to the CPU's where
    the perturbed top-2 margin is clear."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import prng
    from repro_torch.serve.engine import _sample
    gen = torch.Generator(device=dev).manual_seed(seed)
    lg = torch.randn((lanes, vocab), generator=gen, device=dev) * 4
    keys_cpu = prng.fold_in(prng.prng_key(seed).expand(lanes, 2),
                            torch.arange(lanes))
    keys = keys_cpu.to(dev)
    u_dev = prng.uniform(keys, (vocab,), prng.F32_TINY, 1.0).cpu()
    u_cpu = prng.uniform(keys_cpu, (vocab,), prng.F32_TINY, 1.0)
    if not torch.equal(u_dev.view(torch.int32), u_cpu.view(torch.int32)):
        raise AssertionError("the card's threefry uniforms differ from the "
                             "CPU's")
    lg_cpu = lg.cpu()
    tok_dev, tok_cpu = _sample(lg, TEMPERATURE, keys).cpu(), _sample(
        lg_cpu, TEMPERATURE, keys_cpu)
    pert = lg_cpu / torch.tensor(TEMPERATURE) + prng.gumbel(keys_cpu,
                                                            (vocab,))
    top2 = pert.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-5
    if not torch.equal(tok_dev[clear], tok_cpu[clear]):
        raise AssertionError(f"sampled tokens: card {tok_dev.tolist()}, CPU "
                             f"{tok_cpu.tolist()}")
    timer = Timer(dev)
    ms = timer(lambda: _sample(lg, TEMPERATURE, keys))
    greedy_ms = timer(lambda: _sample(lg, 0.0, None))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _sample(lg, TEMPERATURE, keys)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof_s = profile_summary(prof, wall_ms)
    pos = np.arange(lanes) + 100
    t0 = time.perf_counter()
    for _ in range(20):
        prng.fold_in(keys_cpu, torch.from_numpy(pos)).to(dev)
    torch.cuda.synchronize()
    keys_ms = (time.perf_counter() - t0) * 1e3 / 20
    return {"shape": [lanes, vocab], "ms": ms, "greedy_ms": greedy_ms,
            "device_kernels": prof_s["device_kernels"],
            "device_busy_ms": prof_s["device_busy_ms"],
            "wall_ms": wall_ms, "keys_host_ms": keys_ms,
            "draws_compared": int(clear.sum())}


def serve_schedules(dev, seed, cfg, params, requests, dense_tokens,
                    must_launch) -> tuple[dict, dict]:
    """The rest of the engine on the full-width codeqwen1.5-7b w4a8
    parameters (dense int8 cache unless stated), phase 5's first
    ``SCHED_REQ`` requests with prompts cut to ``SCHED_CUT`` tokens and
    ``SCHED_NEW`` new tokens:

    1. greedy under packed, chunked (``prefill_chunk`` 32) and tokenwise:
       each request's tokens equal across the three, and equal to the
       first ``SCHED_NEW`` tokens of phase 5's packed drain wherever the
       prompt was not cut — 0 differences;
    2. sampled (temperature ``TEMPERATURE``, ``seed``) under the three
       schedules, and packed once more after ``warmup()``: all four bit
       for bit;
    3. ``run_stream``: the sampled packed drain replayed with arrivals 0 to
       ``STREAM_SPAN_S`` s apart, equal to the offline drain;
    4. self-speculation on the paged arena (``spec_k`` ``SPEC_K``, phase
       5's 16 requests): equal to the vanilla drain.

    Returns (drains, {"sampler": ``sampler_cost``})."""
    from repro_torch.serve import ServeConfig, ServingEngine
    cut = [(p[:SCHED_CUT], SCHED_NEW) for p, _ in requests[:SCHED_REQ]]
    out = {}

    def engine(**kw):
        return ServingEngine(params, cfg, ServeConfig(**{**SCFG, **kw}),
                             device=dev)

    def drain(label, eng, mode, **kw):
        res, tok = timed_drain(eng, [cut], dev, cfg, must_launch, **kw)
        if eng.mode != mode:
            raise AssertionError(f"{label}: mode {eng.mode}, not {mode}")
        res["mode"], res["per_forward"] = mode, per_forward(res)
        out[label] = res
        return res, tok

    greedy = {m: drain(f"greedy {m}", engine(**kw), m)[1]
              for m, kw in SCHEDULES}
    for m in ("chunked", "tokenwise"):
        out[f"greedy {m}"].update(
            tokens_differ=count_diff(greedy[m], greedy["packed"]),
            compared_with="the packed greedy drain", equal_required=True)
    uncut = [i for i, (p, _) in enumerate(requests[:SCHED_REQ])
             if len(p) <= SCHED_CUT]
    out["greedy packed"].update(
        tokens_differ=count_diff({i: greedy["packed"][i] for i in uncut},
                                 {i: dense_tokens[i][:SCHED_NEW]
                                  for i in uncut}),
        compared_with=f"the first {SCHED_NEW} tokens of phase 5's packed "
                      f"drain, requests {uncut} (prompts not cut)",
        equal_required=True)

    sampled = {}
    for m, kw in SCHEDULES:
        sampled[m] = drain(f"sampled {m}", engine(
            temperature=TEMPERATURE, seed=seed, **kw), m)[1]
    eng = engine(temperature=TEMPERATURE, seed=seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    if eng.stats["requests"] or eng.finished or eng._submitted:
        raise AssertionError("warmup left requests behind")
    res, sampled["warm"] = drain("sampled packed after warmup", eng,
                                 "packed")
    res["warmup_s"] = warm_s
    for m in ("chunked", "tokenwise", "warm"):
        label = ("sampled packed after warmup" if m == "warm"
                 else f"sampled {m}")
        out[label].update(
            tokens_differ=count_diff(sampled[m], sampled["packed"]),
            compared_with="the packed sampled drain", equal_required=True)

    offsets = np.sort(np.random.default_rng([seed, 4]).uniform(
        0.0, STREAM_SPAN_S, size=len(cut)))
    offsets[0] = 0.0
    res, tok = drain("sampled packed run_stream",
                     engine(temperature=TEMPERATURE, seed=seed), "packed",
                     offsets=offsets)
    res.update(offsets_s=offsets.tolist(),
               tokens_differ=count_diff(tok, sampled["packed"]),
               compared_with="the offline packed sampled drain",
               equal_required=True)

    eng = engine(paged=True, page_size=PAGED_PS, spec_k=SPEC_K)
    res, tok = timed_drain(eng, [requests], dev, cfg, tuple(
        k for k in must_launch if k != "int8_kv_decode_attention") + (
            "paged_decode_attention",))
    eng.pool.check()
    res.update(tokens_differ=count_diff(tok, dense_tokens),
               compared_with="phase 5's vanilla drain (dense, which the "
                             "same-schedule paged drain equals)",
               equal_required=True)
    out[f"paged spec_k={SPEC_K}"] = res
    for label, r in out.items():
        if r.get("tokens_differ"):
            raise AssertionError(f"{label}: {r['tokens_differ']} tokens "
                                 f"differ from {r['compared_with']}")
    return out, {"sampler": sampler_cost(dev, seed, cfg.padded_vocab)}


def serve_spec_dense(dev, seed, cfg, params, requests, dense_tokens,
                     must_launch) -> tuple[dict, dict]:
    """Self-speculation on the dense int8 cache (``spec_k`` ``SPEC_K``,
    phase 5's requests): with the n-gram proposer, and adversarial, with
    random tokens for drafts.  Both must give the vanilla drain's tokens —
    0 differences."""
    from repro_torch.serve import ServeConfig, ServingEngine
    out = {}
    for label, adversarial in ((f"spec_k={SPEC_K}", False),
                               (f"spec_k={SPEC_K} random drafts", True)):
        eng = ServingEngine(params, cfg, ServeConfig(**{**SCFG,
                                                        "spec_k": SPEC_K}),
                            device=dev)
        if adversarial:
            rng = np.random.default_rng([seed, 5])
            eng._draft_fn = lambda ctx, k: rng.integers(
                2, cfg.vocab_size, size=k).tolist()
        res, tok = timed_drain(eng, [requests], dev, cfg, must_launch)
        res.update(tokens_differ=count_diff(tok, dense_tokens),
                   compared_with="phase 5's vanilla drain",
                   equal_required=True)
        if res["tokens_differ"]:
            raise AssertionError(f"{label}: {res['tokens_differ']} tokens "
                                 f"differ from the vanilla drain")
        if not res["metrics"]["spec_drafted"]:
            raise AssertionError(f"{label}: nothing was drafted")
        out[label] = res
    return out, {}


EXTRA_DRAINS = {("codeqwen1.5-7b", "w4a8"): serve_schedules,
                ("starcoder2-3b", "w8a8"): serve_spec_dense}

# zamba2-2.7b w8a8 served tokenwise at full width
ZAMBA_REQ, ZAMBA_NEW, ZAMBA_PROMPT = 8, 16, (16, 64)
ZAMBA_ALONE = 3        # requests also drained alone (cut from 8 for time)
ZAMBA_HEAD_DIM = 80
ZAMBA_MUST = ("quantize_rows", "int_layernorm", "int8_gemm",
              "int8_kv_decode_attention")


def serve_zamba2(dev, seed) -> dict:
    """zamba2-2.7b w8a8 (random weights from ``seed``, the port's PTQ),
    int8 KV, 8 lanes, max_seq 1024: ``ZAMBA_REQ`` requests of
    ``ZAMBA_PROMPT`` prompt tokens x ``ZAMBA_NEW`` new, served tokenwise
    (the recurrent arch forces it).  Every step launches
    int8_kv_decode_attention once per attention layer (9, head dim 80) at
    one row, and no ssd_scan (the Mamba-2 blocks take the one-step update);
    the norm, quantize and GEMM kernels launch.  Lane isolation: the first
    ``ZAMBA_ALONE`` requests drained one at a time on the same engine give
    the tokens they got together — 0 differences."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.quant import quantize_for
    from repro_torch.serve import ServeConfig, ServingEngine
    cfg = get_config("zamba2-2.7b", precision="w8a8")
    t0 = time.perf_counter()
    params = quantize_for(init_params(cfg, seed=seed, device=dev), "w8a8")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    rng = np.random.default_rng([seed, 6])
    reqs = [(rng.integers(2, cfg.vocab_size, size=int(rng.integers(
        ZAMBA_PROMPT[0], ZAMBA_PROMPT[1] + 1))).tolist(), ZAMBA_NEW)
            for _ in range(ZAMBA_REQ)]
    n_attn, n_mamba = layer_counts(cfg)
    out = {}
    for label, waves in (("tokenwise", [reqs]),
                         ("tokenwise alone", [[r] for r in
                                              reqs[:ZAMBA_ALONE]])):
        eng = ServingEngine(params, cfg, ServeConfig(**SCFG), device=dev)
        res, tok = timed_drain(eng, waves, dev, cfg, ZAMBA_MUST)
        fwd = sum(res["forwards_by_bucket"].values())
        launches = res["launches"]
        if not (eng.mode == "tokenwise" and cfg.head_dim == ZAMBA_HEAD_DIM
                and set(res["forwards_by_bucket"]) == {"1"}
                and launches["int8_kv_decode_attention"] == n_attn * fwd
                and launches["ssd_scan"] == 0
                and res["multi_row"]["int8_kv_decode_attention.rows"] == 0):
            raise AssertionError(
                f"zamba2 {label}: mode {eng.mode}, {fwd} forwards "
                f"{res['forwards_by_bucket']}, launches {launches}, multi-row "
                f"{res['multi_row']}; want tokenwise, {n_attn} one-row "
                f"decode launches a step at head dim 80, no ssd_scan")
        res["decode_attention_per_step"] = launches[
            "int8_kv_decode_attention"] / fwd
        res["per_forward"] = {k: launches[k] / fwd for k in ZAMBA_MUST}
        out[label] = res
        if label == "tokenwise":
            together = tok
        else:
            res.update(tokens_differ=count_diff(tok, {
                i: together[i] for i in tok}),
                       compared_with="the same requests served together "
                                     "on 8 lanes", equal_required=True)
            if res["tokens_differ"]:
                raise AssertionError(f"zamba2 lane isolation: "
                                     f"{res['tokens_differ']} tokens differ")
    out["tokenwise"]["init_ptq_s"] = t_init
    # one tokenwise step (8 lanes, one token each) under the profiler: the
    # device's busy share of a step of 54 layers of glue
    out["tokenwise"]["profile"] = {"bucket1": profile_step(params, cfg, dev,
                                                           1)}
    return out


def serve_zamba2_reduced(dev, seed) -> dict:
    """zamba2-2.7b-reduced w8a8 served tokenwise (int8 KV, 4 lanes, max_seq
    64, 6 requests of 8-24 prompt tokens x 8 new) on the card and on the CPU
    in the card's order (``forward(card_order=True)``): every step's logits
    of the lanes in the plan within ``STATES_TOL`` of the range, and the
    same greedy token wherever the CPU's top-2 margin is clear (past a
    near-tie the two drains' contexts part, and the rest is not
    compared)."""
    import functools

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.quant import quantize_for
    from repro_torch.serve import ServeConfig, ServingEngine
    from repro_torch.serve import engine as engine_mod
    cfg = get_config("zamba2-2.7b", precision="w8a8", reduced=True)
    cpu = quantize_for(init_params(cfg, seed=seed, device="cpu"), "w8a8")
    gpu = copy.deepcopy(cpu).to(dev)
    rng = np.random.default_rng([seed, 7])
    reqs = [rng.integers(2, cfg.vocab_size, size=int(rng.integers(8, 25)))
            .tolist() for _ in range(6)]
    scfg = ServeConfig(batch_lanes=4, max_seq=64, int8_kv=True)
    runs = {}
    for where, params in (("cpu", cpu), ("gpu", gpu)):
        eng = ServingEngine(params, cfg, scfg, device=params.device)
        steps = []
        inner = eng._forward

        def record(*a, inner=inner, steps=steps):
            lg = inner(*a)
            steps.append((a[3].copy(), lg[:, -1].float().cpu()))
            return lg
        eng._forward = record
        for i, p in enumerate(reqs):
            eng.submit(p, max_new=8, request_id=i)
        forward = engine_mod.forward
        if where == "cpu":
            engine_mod.forward = functools.partial(forward, card_order=True)
        try:
            done = eng.run_until_drained()
        finally:
            engine_mod.forward = forward
        runs[where] = (steps, {r["id"]: r["tokens"] for r in done})
    worst, compared, near_tie = 0.0, 0, None
    for (mask, lc), (_, lg) in zip(runs["cpu"][0], runs["gpu"][0]):
        lc, lg = lc[torch.from_numpy(mask)], lg[torch.from_numpy(mask)]
        err = float((lc - lg).abs().max())
        rel = err / float(lc.abs().max())
        worst = max(worst, rel)
        if not (torch.isfinite(lg).all() and rel <= STATES_TOL):
            raise AssertionError(f"reduced zamba2 served: step {compared}, "
                                 f"card logits differ from the card-order "
                                 f"CPU by {rel:.3g} of the range")
        compared += 1
        top2 = lc.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * err
        same = lc.argmax(-1) == lg.argmax(-1)
        if not same[clear].all():
            raise AssertionError("reduced zamba2 served: greedy tokens "
                                 "differ where the CPU margin is clear")
        if not same.all():
            near_tie = compared
            break
    differ = count_diff(runs["gpu"][1], runs["cpu"][1])
    if near_tie is None and differ:
        raise AssertionError(f"reduced zamba2 served: {differ} tokens "
                             f"differ from the CPU's")
    return {"steps_compared": compared, "worst_rel": worst,
            "near_tie_at_step": near_tie, "tokens_differ": differ}


# ---------------------------------------------------------------------------
# phases 5 and 6 of the MoE archs: full-width serving and lm_loss
# ---------------------------------------------------------------------------

# (arch, precision) of the MoE paths: mixtral-8x7b at W4A8 (dense, paged,
# and the long prompt whose ring wraps), qwen2-moe-a2.7b at W8A8 (dense)
MOE_PATHS = (("mixtral-8x7b", "w4a8"), ("qwen2-moe-a2.7b", "w8a8"))
MOE_REQ, MOE_NEW = 8, 16
# past the 4352-slot ring, and a multiple of the largest bucket: a lane
# alone then fills every prefill step, so no pad row (whose attention
# output depends on the cache layout) reaches the router in any of the
# three runs
LONG_PROMPT, LONG_NEW = 18 * 256, 16
MOE_SCORE_B, MOE_SCORE_T = 4, 1024


def expert_forms(cfg) -> tuple[str, str]:
    """The up/gate and down expert-batched forms a MoE config launches."""
    if cfg.precision == "w4a8":
        return "dual_int4_gemm_gated.experts", "int4_gemm.experts"
    return "dual_gemm_gated.experts", "int8_gemm.experts"


def moe_must(cfg, paged: bool = False) -> tuple:
    """The kernels (and forms) a MoE serving drain, dense or paged, must
    launch."""
    attn = "paged_decode_attention" if paged else "int8_kv_decode_attention"
    out = ("quantize_rows", "int_layernorm", attn, *expert_forms(cfg))
    return out + ((f"{attn}.window",) if cfg.sliding_window else ())


def logit_recorder(engine) -> list:
    """Wrap ``engine._forward`` to keep lane 0's logits of every forward
    (on the host: one copy a step)."""
    seen, fwd = [], engine._forward

    def rec(*a, **k):
        lg = fwd(*a, **k)
        seen.append(lg[0, -1].float().cpu())
        return lg
    engine._forward = rec
    return seen


def near_tie_diff(got, want, lg_got, lg_want) -> dict:
    """Greedy tokens of one request against another run's: the first
    differing token, and whether the other run's top-2 margin at the
    forward that produced it is below twice the largest logit difference
    up to there (a near-tie the float order of the attention cannot
    decide)."""
    n_prefill = len(lg_want) - len(want) + 1
    diff = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                None)
    upto = len(lg_want) if diff is None else n_prefill + diff
    d = max(float((a - b).abs().max()) for a, b in
            zip(lg_got[:upto], lg_want[:upto]))
    first = next((j for j, (a, b) in enumerate(zip(lg_got, lg_want))
                  if not torch.equal(a, b)), None)
    res = {"first_diff": diff, "max_logit_diff": d,
           "first_forward_apart": first, "forwards": len(lg_want),
           "tokens_differ": sum(a != b for a, b in zip(got, want))
           + abs(len(got) - len(want))}
    if diff is not None:
        top = lg_want[upto - 1].topk(2).values
        res["margin"] = float(top[0] - top[1])
        if not res["margin"] < 2 * d:
            raise AssertionError(f"tokens differ at {diff} with a clear "
                                 f"margin {res['margin']:.4g} (logit diff "
                                 f"{d:.4g})")
    return res


def long_prompt_drains(params, cfg, dev, seed) -> dict:
    """One request of LONG_PROMPT tokens at max_seq 8192 (one lane, token
    budget 256): on the dense ring of window + 256 slots (it wraps), on a
    cache of 8192 slots that never wraps (window masking only) and paged
    with each lane's live pages capped at the window; the ring's and the
    paged run's greedy tokens against the unwrapped one's
    (``near_tie_diff``)."""
    from repro_torch.models import init_states
    from repro_torch.serve import ServeConfig, ServingEngine
    rng = np.random.default_rng(seed + 1)
    prompt = rng.integers(2, cfg.vocab_size, size=LONG_PROMPT).tolist()
    base = dict(batch_lanes=1, max_seq=WIN_MAX_SEQ, int8_kv=True,
                token_budget=256)
    out, logits, toks = {}, {}, {}
    for name, kw in (("ring", {}), ("unwrapped", {}), ("paged", {"paged":
                                                                 True})):
        eng = ServingEngine(params, cfg, ServeConfig(**base, **kw), device=dev)
        if name == "ring":
            if eng.states[0]["kv"]["k"].shape[1] != WIN_RING:
                raise AssertionError("mixtral's ring is not window + 256")
        if name == "unwrapped":
            eng.states = init_states(cfg, 1, WIN_MAX_SEQ, int8_kv=True,
                                     device=dev, window_slack=WIN_MAX_SEQ)
        logits[name] = logit_recorder(eng)
        res, tk = timed_drain(eng, [[(prompt, LONG_NEW)]], dev, cfg,
                              moe_must(cfg, eng.paged))
        toks[name] = tk[0]
        if name == "paged":
            res["pool_pages_peak"] = eng.pool.stats["pages_peak"]
            res["cap_window"] = eng._cap_window
        out[name] = res
        del eng
    for name in ("ring", "paged"):
        out[name]["vs_unwrapped"] = near_tie_diff(
            toks[name], toks["unwrapped"], logits[name], logits["unwrapped"])
    return out


def moe_layer_launches(cfg, per: dict) -> None:
    """A bucket-1 step of a MoE arch: one expert-batched up/gate and one
    down launch a layer, and (window) one decode launch a layer with it."""
    want = {**dict.fromkeys(expert_forms(cfg), cfg.n_layers),
            "int8_kv_decode_attention": cfg.n_layers,
            "int8_kv_decode_attention.window": (cfg.n_layers if
                                                cfg.sliding_window else 0)}
    if any(per[k] != v for k, v in want.items()):
        raise AssertionError(f"{cfg.name}: a bucket-1 step launched "
                             f"{ {k: per[k] for k in want} }, not {want}")


def moe_loss(params, cfg, dev, seed) -> dict:
    """``lm_loss`` on MOE_SCORE_B x MOE_SCORE_T random tokens: loss, wall,
    peak memory and launches (each expert-batched form once a layer; the
    integer no-cache attention once a layer where there is no window —
    mixtral's windowed layers run the reference's ``_sdpa``), then one
    forward under torch.profiler."""
    from repro_torch.kernels import ops
    from repro_torch.models import lm_loss
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(2, cfg.vocab_size, (MOE_SCORE_B, MOE_SCORE_T),
                           generator=gen, device=dev)
    labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)], 1)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    loss = float(lm_loss(params, cfg, tokens, labels))
    wall = time.perf_counter() - t0
    counts = ops.launch_counts(forms=True)
    if not (np.isfinite(loss) and loss > 0):
        raise AssertionError(f"{cfg.name} {cfg.precision} lm_loss = {loss}")
    want = {**dict.fromkeys(expert_forms(cfg), cfg.n_layers),
            "int8_flash_attention": 0 if cfg.sliding_window else cfg.n_layers}
    if any(counts[k] != v for k, v in want.items()):
        raise AssertionError(f"{cfg.name} lm_loss forward launched "
                             f"{ {k: counts[k] for k in want} }, not {want}")
    res = {"loss": loss, "wall_s": wall, "tokens": tokens.numel(),
           "tok_per_s": tokens.numel() / wall,
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "launches": counts,
           "rows_per_expert": expert_rows(cfg.name, tokens.numel())}
    res["profile"] = {f"forward {MOE_SCORE_B} x {MOE_SCORE_T}":
                      profile_no_cache(params, cfg, tokens)}
    return res


def serve_moe(dev, seed, arch: str, precision: str) -> dict:
    """Full-width ``arch`` at ``precision``, quantized a block at a time as
    it is built (``init_params(precision=...)``): MOE_REQ requests of 16-256
    tokens x MOE_NEW new through ``ServingEngine`` (8 lanes, int8 KV, token
    budget 256, max_seq 1024), a bucket-1 step's launches and a profile of
    it; for a windowed arch the same drain paged (tokens equal to the
    dense drain's) and ``long_prompt_drains``; then ``moe_loss``.  Returns
    {drain or "lm_loss": result}."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve import ServeConfig, ServingEngine
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the router and the shared gate "
                             "are f32 products, as in the reference")
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = get_config(arch, precision=precision)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device=dev, precision=precision)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    after_init = torch.cuda.memory_allocated(dev) / 2 ** 30
    init_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    requests = dense_requests(cfg, seed, MOE_REQ, MOE_NEW)
    engine = ServingEngine(params, cfg, ServeConfig(**SCFG), device=dev)
    res, tokens = timed_drain(engine, [requests], dev, cfg, moe_must(cfg))
    del engine
    per_step, syncs = decode_step_launches(params, cfg, dev, False)
    moe_layer_launches(cfg, per_step)
    res.update(init_ptq_s=t_init, after_ptq_gib=after_init,
               init_peak_gib=init_peak, launches_per_decode_step=per_step,
               syncs_per_decode_step=syncs,
               profile={"bucket1": profile_step(params, cfg, dev, 1)})
    out = {"dense": res}
    if cfg.sliding_window:
        eng = ServingEngine(params, cfg, ServeConfig(**SCFG, paged=True),
                            device=dev)
        pres, ptok = timed_drain(eng, [requests], dev, cfg,
                                 moe_must(cfg, paged=True))
        # not required equal: a pad row's attention output depends on the
        # cache layout (no valid key), and pads take capacity slots, so the
        # reference's own paged and dense drains of a MoE arch differ too
        # (ROADMAP C13); the long drains below, pad-free, hold the layouts
        pres.update(tokens_differ=count_diff(ptok, tokens),
                    compared_with="the dense drain (not required: pad rows "
                    "feed the router)", cap_window=eng._cap_window)
        del eng
        out["paged"] = pres
        out.update({f"long {k}": v for k, v in
                    long_prompt_drains(params, cfg, dev, seed).items()})
    out["lm_loss"] = moe_loss(params, cfg, dev, seed)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 4-6 of internlm2-20b, yi-34b and xlstm-350m
# ---------------------------------------------------------------------------

# xlstm-350m-reduced W8A8 against the port's CPU run: the no-cache forward
# (the chunked mLSTM and the sLSTM loop) equal bit for bit
# (XLSTM_NO_CACHE_TOL = 0), the forward with states (a prefill, then t = 1
# steps: the one-step updates) within STATES_TOL.  The integer kernels are
# bit-exact, and the f32 recurrences round each transcendental, reduction
# and product from f64 (``models/ssm.py``), so the card and the CPU agree
# (ROADMAP C15); before that, one device-dependent rounding moved an int8
# level of wo's activation (0.685% of the range at seed 1 on an H100).
XLSTM_NO_CACHE_TOL = 0.0


def xlstm_counts(cfg) -> dict:
    """The launches of one forward of an integer xlstm config: int8_gemm
    (int4_gemm at W4A8) once per quantized linear (w_gate, wq, wk, wv, w_if,
    wo of each mLSTM; w_in, wo of each sLSTM; the tied head is float),
    quantize_rows for u and wo's input of each mLSTM and wo's of each sLSTM
    (the norm hands its rows to w_gate and w_in), the fused norm once a
    block and once at the end, and no attention kernel."""
    n_m = cfg.block_kinds.count("mlstm")
    n_s = cfg.block_kinds.count("slstm")
    w4 = cfg.precision == "w4a8"
    return {"int4_gemm": (6 * n_m + 2 * n_s) * w4,
            "int8_gemm": (6 * n_m + 2 * n_s) * (not w4),
            "quantize_rows": 2 * n_m + n_s,
            "int_layernorm": cfg.n_layers + 1,
            "int8_kv_decode_attention": 0, "paged_decode_attention": 0,
            "int8_flash_attention": 0, "flash_attention": 0, "ssd_scan": 0}


def check_counts(what: str, got: dict, want: dict, per: int = 1) -> None:
    bad = {k: got[k] for k, v in want.items() if got[k] != v * per}
    if bad:
        raise AssertionError(f"{what}: launched {bad}, want "
                             f"{ {k: v * per for k, v in want.items()} }")


def check_xlstm_reduced(dev, seed) -> dict:
    """xlstm-350m-reduced at W8A8 on the CPU (plain versions) and on the
    card (kernels): the no-cache forward of 4 sequences x 32 tokens (the
    mLSTM padded to a chunk of 64) within ``XLSTM_NO_CACHE_TOL`` of the
    range, then a prefill of 16 tokens per lane and 4 single-token steps,
    each feeding the CPU's greedy token, within ``STATES_TOL``; the
    launches of each forward (``xlstm_counts``).  Returns the worst
    relative differences."""
    from repro_torch.kernels import ops
    from repro_torch.models import forward, init_params, init_states
    from repro_torch.quant import quantize_for

    cfg = reduced_config("xlstm-350m", "w8a8")
    cpu = quantize_for(init_params(cfg, seed=seed, device="cpu"), "w8a8")
    gpu = copy.deepcopy(cpu).to(dev)
    tok = torch.from_numpy(np.random.default_rng(seed).integers(
        2, cfg.vocab_size, size=(4, 32)))

    def rel(a, b):
        return float((a - b.cpu()).abs().max()) / float(a.abs().max())
    lc, _ = forward(cpu, cfg, tok)
    ops.reset_launch_counts()
    lg, _ = forward(gpu, cfg, tok.to(dev))
    torch.cuda.synchronize()
    check_counts("xlstm-reduced no-cache forward", ops.launch_counts(),
                 xlstm_counts(cfg))
    worst = {"no_cache": rel(lc, lg), "states": 0.0}
    log(f"  no-cache forward (4 x 32): {worst['no_cache']:.3g} of the range "
        f"(limit {XLSTM_NO_CACHE_TOL:g})")
    if not (torch.isfinite(lg).all()
            and worst["no_cache"] <= XLSTM_NO_CACHE_TOL):
        raise AssertionError(f"reduced xlstm w8a8 no-cache seed {seed}: "
                             f"card logits differ from the CPU's by "
                             f"{worst['no_cache']:.3g} of the range")
    sts = {k: init_states(cfg, 4, 64, device=dev if k == "gpu" else "cpu")
           for k in ("cpu", "gpu")}
    tok = tok[:, :16]
    pos = torch.arange(16, dtype=torch.int32).expand(4, 16)
    ops.reset_launch_counts()
    for step in range(5):
        lc, sts["cpu"] = forward(cpu, cfg, tok, pos, sts["cpu"])
        lg, sts["gpu"] = forward(gpu, cfg, tok.to(dev), pos.to(dev),
                                 sts["gpu"])
        r = rel(lc[:, -1], lg[:, -1])
        worst["states"] = max(worst["states"], r)
        log(f"  step {step} (T={tok.shape[1]}): {r:.3g} of the range")
        if not (torch.isfinite(lg).all() and r <= STATES_TOL):
            raise AssertionError(f"reduced xlstm w8a8 with states seed "
                                 f"{seed}: step {step} differs by {r:.3g} of "
                                 f"the range (> {STATES_TOL:g})")
        tok = lc[:, -1].argmax(-1)[:, None]
        pos = pos[:, -1:] + 1
    check_counts("xlstm-reduced forward with states", ops.launch_counts(),
                 xlstm_counts(cfg), per=5)
    return worst


# the dense GQA paths: (arch, precision, a paged drain after the dense one)
GQA_PATHS = (("internlm2-20b", "w8a8", True), ("yi-34b", "w4a8", False))
GQA_REQ, GQA_NEW = 8, 16
SCORE_B, SCORE_T = 4, 1024


def gqa_must(cfg, paged: bool = False) -> tuple:
    """The kernels a dense GQA drain must launch."""
    attn = "paged_decode_attention" if paged else "int8_kv_decode_attention"
    gemm = (("int4_gemm", "dual_int4_gemm_gated") if cfg.precision == "w4a8"
            else ("dual_gemm_gated",))
    return ("quantize_rows", "int_layernorm", "int8_gemm", attn, *gemm)


def dense_step_launches(cfg, per: dict, attn: str) -> None:
    """A bucket-1 step of a dense arch: the decode kernel once a layer (48
    for internlm2-20b, 60 for yi-34b), quantize_rows 4 times a layer and the
    fused norm twice a layer and once more."""
    check_counts(f"{cfg.name} bucket-1 step", per, {
        attn: cfg.n_layers, "quantize_rows": 4 * cfg.n_layers,
        "int_layernorm": 2 * cfg.n_layers + 1})


def score_tokens(cfg, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(2, cfg.vocab_size, (SCORE_B, SCORE_T),
                         generator=gen, device=dev)


def serve_gqa(dev, seed, arch: str, precision: str, paged: bool) -> dict:
    """Full-width ``arch`` at ``precision``, built and quantized a block at a
    time: GQA_REQ requests of 16-256 tokens x GQA_NEW new (8 lanes, int8 KV,
    token budget 256, max_seq 1024), a bucket-1 step's launches and a
    profile of it; with ``paged`` the same drain paged (0 token differences
    from the dense drain required) with its own step; then ``lm_loss`` on
    SCORE_B x SCORE_T tokens (int8_flash_attention once a layer), profiled.
    Returns {"dense", "paged", "lm_loss": result}."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve import ServeConfig, ServingEngine
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = get_config(arch, precision=precision)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device=dev, precision=precision)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    after_init = torch.cuda.memory_allocated(dev) / 2 ** 30
    init_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    requests = dense_requests(cfg, seed, GQA_REQ, GQA_NEW)
    engine = ServingEngine(params, cfg, ServeConfig(**SCFG), device=dev)
    res, tokens = timed_drain(engine, [requests], dev, cfg, gqa_must(cfg))
    del engine
    per_step, syncs = decode_step_launches(params, cfg, dev, False)
    dense_step_launches(cfg, per_step, "int8_kv_decode_attention")
    res.update(init_ptq_s=t_init, after_ptq_gib=after_init,
               init_peak_gib=init_peak, launches_per_decode_step=per_step,
               syncs_per_decode_step=syncs,
               profile={"bucket1": profile_step(params, cfg, dev, 1)})
    out = {"dense": res}
    if paged:
        eng = ServingEngine(params, cfg, ServeConfig(**SCFG, paged=True),
                            device=dev)
        pres, ptok = timed_drain(eng, [requests], dev, cfg,
                                 gqa_must(cfg, paged=True))
        del eng
        pres.update(tokens_differ=count_diff(ptok, tokens),
                    compared_with="the dense drain", equal_required=True)
        if pres["tokens_differ"]:
            raise AssertionError(f"{arch} paged: {pres['tokens_differ']} "
                                 f"tokens differ from the dense drain")
        per_p, syncs_p = decode_step_launches(params, cfg, dev, True)
        dense_step_launches(cfg, per_p, "paged_decode_attention")
        pres.update(launches_per_decode_step=per_p,
                    syncs_per_decode_step=syncs_p,
                    profile={"bucket1": profile_step(params, cfg, dev, 1,
                                                     paged=True)})
        out["paged"] = pres
    out["lm_loss"] = no_cache_loss(params, cfg, dev,
                                   score_tokens(cfg, dev, seed), True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# xlstm-350m w8a8 served tokenwise at full width
XLSTM_REQ, XLSTM_NEW, XLSTM_PROMPT, XLSTM_ALONE = 8, 16, (16, 64), 3


def serve_xlstm(dev, seed) -> dict:
    """xlstm-350m w8a8 (random weights from ``seed``, built and quantized a
    block at a time), 8 lanes, max_seq 1024: XLSTM_REQ requests of
    XLSTM_PROMPT prompt tokens x XLSTM_NEW new, served tokenwise (the
    recurrent arch forces it); then the first XLSTM_ALONE of them one at a
    time on one engine, each admitted into lane 0 after the one before has
    finished there (lane isolation and reuse: 0 differences required), and
    lane 0 reset once more and held equal to ``init_block_state``'s values
    (mLSTM m = -1e30, sLSTM n = 1).  Every forward launches
    ``xlstm_counts`` (no attention kernel); one step profiled."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.blocks import init_block_state
    from repro_torch.serve import ServeConfig, ServingEngine
    cfg = get_config("xlstm-350m", precision="w8a8")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device=dev, precision="w8a8")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    rng = np.random.default_rng([seed, 8])
    reqs = [(rng.integers(2, cfg.vocab_size, size=int(rng.integers(
        XLSTM_PROMPT[0], XLSTM_PROMPT[1] + 1))).tolist(), XLSTM_NEW)
            for _ in range(XLSTM_REQ)]
    per_fwd = xlstm_counts(cfg)
    out = {}
    for label, waves in (("tokenwise", [reqs]),
                         ("tokenwise alone", [[r] for r in
                                              reqs[:XLSTM_ALONE]])):
        eng = ServingEngine(params, cfg, ServeConfig(**SCFG), device=dev)
        lanes = []
        admit = eng._reset_lane

        def record(lane, admit=admit, lanes=lanes):
            lanes.append(lane)
            admit(lane)
        eng._reset_lane = record
        res, tok = timed_drain(eng, waves, dev, cfg,
                               ("quantize_rows", "int_layernorm",
                                "int8_gemm"))
        fwd = sum(res["forwards_by_bucket"].values())
        if not (eng.mode == "tokenwise"
                and set(res["forwards_by_bucket"]) == {"1"}):
            raise AssertionError(f"xlstm {label}: mode {eng.mode}, forwards "
                                 f"{res['forwards_by_bucket']}")
        check_counts(f"xlstm {label}", res["launches"], per_fwd, per=fwd)
        res["per_forward"] = {k: res["launches"][k] / fwd for k in per_fwd}
        out[label] = res
        if label == "tokenwise":
            together = tok
            continue
        if lanes != [0] * XLSTM_ALONE:
            raise AssertionError(f"xlstm alone: admitted into lanes {lanes}")
        res.update(tokens_differ=count_diff(tok, {i: together[i]
                                                  for i in tok}),
                   compared_with="the same requests served together on 8 "
                   "lanes (each alone in lane 0, reused)",
                   equal_required=True)
        if res["tokens_differ"]:
            raise AssertionError(f"xlstm lane isolation: "
                                 f"{res['tokens_differ']} tokens differ")
        admit(0)
        for kind, st in zip(cfg.block_kinds, eng.states):
            init = init_block_state(kind, cfg, 1, 1, True, torch.bfloat16,
                                    dev)
            if not all(torch.equal(st[k][0], v[0]) for k, v in init.items()):
                raise AssertionError(f"xlstm: lane 0's {kind} state is not "
                                     f"its init value after a reset")
        res["lane_reset"] = "lane 0 equal to init_block_state after a reset"
    per_step, syncs = decode_step_launches(params, cfg, dev, False)
    check_counts("xlstm bucket-1 step", per_step, per_fwd)
    out["tokenwise"].update(init_ptq_s=t_init,
                            launches_per_decode_step=per_step,
                            syncs_per_decode_step=syncs,
                            profile={"bucket1": profile_step(params, cfg,
                                                             dev, 1)})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def xlstm_loss(dev, seed, profiled: bool = True) -> dict:
    """xlstm-350m's ``lm_loss`` on SCORE_B x SCORE_T tokens at bf16 (float
    parameters from ``seed``), W8A8 and W4A8 (each quantized from the float
    model and freed); the integer forwards launch ``xlstm_counts`` and run
    once more under the profiler, tracing the device only: a forward
    launches ~123k kernels (the sLSTM loop), and the host's trace doubles
    the profile's cost (25 s against 53 s on an H100)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.quant import DEFAULT_W4_POLICY, quantized_copy
    base = get_config("xlstm-350m")
    params = init_params(base, seed=seed, device=dev)
    tokens = score_tokens(base, dev, seed)
    out = {}
    for prec in ("bf16", "w8a8", "w4a8"):
        cfg = dataclasses.replace(base, precision=prec)
        model = params if prec == "bf16" else quantized_copy(
            params, DEFAULT_W4_POLICY if prec == "w4a8" else None)
        res = no_cache_loss(model, cfg, dev, tokens,
                            profiled and prec != "bf16", host=False)
        if prec != "bf16":
            check_counts(f"xlstm {prec} lm_loss forward", res["launches"],
                         xlstm_counts(cfg))
        else:
            # no kernel of the TPU's; the float linears through bf16_gemm
            check_counts("xlstm bf16 lm_loss forward", res["launches"],
                         {**dict.fromkeys(ops.KERNELS, 0),
                          **train_counts(cfg, SCORE_T)})
        out[f"xlstm-350m {prec} lm_loss"] = res
        del model
        torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 4-6 of whisper-small and llama-3.2-vision-90b
# ---------------------------------------------------------------------------

WHISPER, VISION = "whisper-small", "llama-3.2-vision-90b"
# Phase 4's limit for the cross-attention archs against the card-order CPU:
# every integer kernel is bit-exact and the self-attention cache rows take
# the decode kernels' order on both sides, but cross-attention is f32 float
# glue (``_sdpa``, as the reference's XLA: no kernel), whose products the
# card's BLAS and the CPU's sum in other orders; its bf16 output can then
# move one int8 level of the next GEMM's input.
CROSS_ORDER_TOL = CARD_ORDER_TOL
# whisper's encoder is integer end to end (fused norm, int8_gemm,
# int8_flash_attention), so its output must equal the CPU's bit for bit
ENC_TOL = 0.0
# the cross layer's gates: zero at init makes the block the identity, so the
# reduced checks run with these
XATTN_GATES = (0.5, -0.7)


def gate_xattn(params):
    """Set every ``xattn`` block's gates to ``XATTN_GATES`` (in place)."""
    for blk in params.layers:
        if hasattr(blk, "gate_attn"):
            blk.gate_attn.fill_(XATTN_GATES[0])
            blk.gate_mlp.fill_(XATTN_GATES[1])
    return params


def rel_range(want, got) -> float:
    """max |want - got| over max |want| (``got`` may lie on the card)."""
    want = want.float().cpu()
    return (float((want - got.float().cpu()).abs().max())
            / max(float(want.abs().max()), 1e-30))


def same_cross_states(st_c, st_g, what: str) -> None:
    """The cross K/V the card precomputed equal the CPU's bit for bit."""
    for i, (a, b) in enumerate(zip(st_c, st_g)):
        for k in ("xk", "xv"):
            if a is not None and k in a and not torch.equal(a[k], b[k].cpu()):
                raise AssertionError(f"{what}: layer {i}'s {k} differs from "
                                     f"the CPU's")


def cross_steps(cpu, gpu, cfg, dev, seed, st_c, st_g, what: str) -> float:
    """``check_reduced``'s packed steps (a t = 16 step of mixed lengths, then
    5 t = 1 steps feeding the CPU's greedy tokens) on the CPU in the card's
    order and on the card, over states whose cross K/V are precomputed:
    within ``CROSS_ORDER_TOL`` of the range at every step; the dense decode
    kernel (and its multi-row form) launched.  Returns the worst."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.serve import packed_step
    rng = np.random.default_rng(seed)
    lens = np.array([16, 9, 3, 12])
    t = 16
    tok = rng.integers(2, cfg.vocab_size, size=(4, t))
    pos = np.where(np.arange(t)[None] < lens[:, None], np.arange(t)[None], -1)
    last = lens - 1
    worst = 0.0
    before = ops.launch_counts(forms=True)["int8_kv_decode_attention"]
    rows_before = LAUNCHES["int8_kv_decode_attention.rows"]
    for step in range(6):
        args = [torch.from_numpy(a) for a in (tok.astype(np.int64),
                                              pos.astype(np.int32),
                                              last.astype(np.int64))]
        lo, _ = card_order_step(cpu, cfg, args[0], args[1], st_c, args[2])
        lg, _ = packed_step(gpu, cfg, *(a.to(dev) for a in args[:2]), st_g,
                            args[2].to(dev))
        rel = rel_range(lo, lg)
        worst = max(worst, rel)
        log(f"  {what} step {step} (T={tok.shape[1]}): {rel:.3%} of the "
            f"range against the card order")
        if not (torch.isfinite(lg).all() and rel <= CROSS_ORDER_TOL):
            raise AssertionError(f"{what} step {step}: card logits differ "
                                 f"from the card-order CPU by {rel:.3%} (> "
                                 f"{CROSS_ORDER_TOL:.0%})")
        tok = lo.argmax(-1).numpy()[:, None]
        pos = (pos.max(1) + 1)[:, None]
        last = np.zeros(4, np.int64)
    if (ops.launch_counts(forms=True)["int8_kv_decode_attention"] <= before
            or LAUNCHES["int8_kv_decode_attention.rows"] <= rows_before):
        raise AssertionError(f"{what}: the decode kernel (and its multi-row "
                             f"form) did not launch")
    return worst


@torch.no_grad()
def check_whisper_reduced(dev, seed) -> dict:
    """whisper-small-reduced (multi-head, ``reduced_config``) at W8A8 on the
    CPU (plain versions) and on the card (kernels): ``encode`` of 4 stub
    clips equal bit for bit (``ENC_TOL``), int8_flash_attention once per
    encoder layer; the cross K/V precomputed from the CPU's encoder output
    equal on both; the decoder's packed steps over them (``cross_steps``);
    the no-cache ``encdec_forward`` within ``CROSS_ORDER_TOL``, the integer
    attention once per encoder and per decoder layer."""
    from repro_torch.kernels import ops
    from repro_torch.models import (encdec_forward, encode,
                                    init_encdec_params, init_states,
                                    precompute_cross_states)
    cfg = reduced_config(WHISPER, "w8a8")
    cpu = init_encdec_params(cfg, seed=seed, device="cpu", precision="w8a8")
    gpu = copy.deepcopy(cpu).to(dev)
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy((rng.normal(size=(
        4, cfg.n_audio_frames, cfg.d_model)) * 0.02).astype(np.float32))
    ec = encode(cpu, cfg, frames)
    ops.reset_launch_counts()
    eg = encode(gpu, cfg, frames.to(dev))
    torch.cuda.synchronize()
    check_counts("whisper-reduced encode", ops.launch_counts(),
                 {"int8_flash_attention": cfg.n_encoder_layers,
                  "flash_attention": 0})
    worst = {"encode": rel_range(ec, eg)}
    log(f"  seed {seed} encode (4 x {cfg.n_audio_frames}): "
        f"{worst['encode']:.3g} of the range (limit {ENC_TOL:g})")
    if not (torch.isfinite(eg).all() and worst["encode"] <= ENC_TOL):
        raise AssertionError(f"whisper-reduced encode seed {seed}: the card "
                             f"differs from the CPU by {worst['encode']:.3g}")
    st_c = precompute_cross_states(cpu.decoder, cfg, ec, init_states(
        cfg, 4, 64, int8_kv=True, device="cpu"))
    st_g = precompute_cross_states(gpu.decoder, cfg, ec.to(dev), init_states(
        cfg, 4, 64, int8_kv=True, device=dev))
    same_cross_states(st_c, st_g, "whisper-reduced cross states")
    worst["steps"] = cross_steps(cpu.decoder, gpu.decoder, cfg, dev, seed,
                                 st_c, st_g, f"whisper-reduced seed {seed}")
    tok = torch.from_numpy(rng.integers(2, cfg.vocab_size, size=(4, 32)))
    lc, _, _ = encdec_forward(cpu, cfg, frames, tok)
    ops.reset_launch_counts()
    lg, _, _ = encdec_forward(gpu, cfg, frames.to(dev), tok.to(dev))
    torch.cuda.synchronize()
    check_counts("whisper-reduced encdec_forward", ops.launch_counts(),
                 {"int8_flash_attention": cfg.n_encoder_layers + cfg.n_layers})
    worst["no_cache"] = rel_range(lc, lg)
    log(f"  seed {seed} encdec_forward (4 x 32): {worst['no_cache']:.3%} of "
        f"the range")
    if not (torch.isfinite(lg).all() and worst["no_cache"] <= CROSS_ORDER_TOL):
        raise AssertionError(f"whisper-reduced encdec_forward seed {seed}: "
                             f"{worst['no_cache']:.3%} of the range")
    return worst


def check_vision_reduced(dev, seed, precision: str) -> dict:
    """llama-3.2-vision-90b-reduced (G = 8, ``reduced_config``; the cross
    layer's gates at ``XATTN_GATES``) at ``precision`` on the CPU and on the
    card: the cross K/V of 4 lanes' stub features equal bit for bit; the
    packed steps over them (``cross_steps``); the no-cache forward with
    ``kv_source`` within ``CROSS_ORDER_TOL`` (int8_flash_attention once per
    ``attn`` layer, none for the cross layer)."""
    from repro_torch.kernels import ops
    from repro_torch.models import (forward, init_params, init_states,
                                    precompute_cross_states)
    from repro_torch.quant import quantize_for
    cfg = reduced_config(VISION, precision)
    cpu = gate_xattn(quantize_for(init_params(cfg, seed=seed, device="cpu"),
                                  precision))
    gpu = copy.deepcopy(cpu).to(dev)
    rng = np.random.default_rng(seed)
    src = torch.from_numpy((rng.normal(size=(
        4, cfg.n_vision_tokens, cfg.d_model)) * 0.02).astype(np.float32))
    st_c = precompute_cross_states(cpu, cfg, src, init_states(
        cfg, 4, 64, int8_kv=True, device="cpu"))
    st_g = precompute_cross_states(gpu, cfg, src.to(dev), init_states(
        cfg, 4, 64, int8_kv=True, device=dev))
    same_cross_states(st_c, st_g, f"vision-reduced {precision} cross states")
    what = f"vision-reduced {precision} seed {seed}"
    worst = {"steps": cross_steps(cpu, gpu, cfg, dev, seed, st_c, st_g, what)}
    tok = torch.from_numpy(rng.integers(2, cfg.vocab_size, size=(4, 32)))
    lc, _ = forward(cpu, cfg, tok, kv_source=src)
    ops.reset_launch_counts()
    lg, _ = forward(gpu, cfg, tok.to(dev), kv_source=src.to(dev))
    torch.cuda.synchronize()
    check_counts(f"{what} forward", ops.launch_counts(),
                 {"int8_flash_attention": layer_counts(cfg)[0]})
    worst["no_cache"] = rel_range(lc, lg)
    log(f"  {what} no-cache forward with kv_source (4 x 32): "
        f"{worst['no_cache']:.3%} of the range")
    if not (torch.isfinite(lg).all() and worst["no_cache"] <= CROSS_ORDER_TOL):
        raise AssertionError(f"{what} no-cache forward: "
                             f"{worst['no_cache']:.3%} of the range")
    return worst


# the cross archs' drains: 8 lanes (each its own clip or image) x 16 new
XATTN_REQ, XATTN_NEW = 8, 16
XATTN_MUST = ("quantize_rows", "int_layernorm", "int8_kv_decode_attention")


def xattn_step_launches(cfg, per: dict, norms_per_layer: int) -> None:
    """A bucket-1 step of a cross arch: the dense decode kernel once per
    self-attention layer (12 for whisper's ``dec`` layers, 80 for vision's
    ``attn`` layers), never the paged one, and the fused norm
    ``norms_per_layer`` times a layer and once more."""
    n_self = sum(k in ("attn", "dec") for k in cfg.block_kinds)
    check_counts(f"{cfg.name} bucket-1 step", per, {
        "int8_kv_decode_attention": n_self, "paged_decode_attention": 0,
        "int_layernorm": norms_per_layer * cfg.n_layers + 1})


@torch.no_grad()
def serve_whisper(dev, seed) -> dict:
    """whisper-small W8A8 at full width (random weights from ``seed``, built
    and quantized a block at a time): ``encode`` of 8 stub clips of 1500
    frames (int8_flash_attention once per encoder layer), then the decoder
    served with ``kv_source`` = that encoding, XATTN_REQ requests of 16-256
    tokens x XATTN_NEW new (8 lanes, int8 KV, token budget 256, max_seq
    1024; a ``paged=True`` engine would fall back to dense); then the same
    requests again on the same engine, every lane reused (its self-attention
    cache reset, its cross K/V kept): 0 token differences from the fresh
    engine's drain required; a bucket-1 step's launches (12 decode
    launches, no paged one, the fused norm 3 a layer + 1) and its profile."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import encode, init_encdec_params
    from repro_torch.models.frontend import audio_frames_stub
    from repro_torch.serve import ServeConfig, ServingEngine
    cfg = get_config(WHISPER, precision="w8a8")
    t0 = time.perf_counter()
    params = init_encdec_params(cfg, seed=seed, device=dev, precision="w8a8")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(seed)
    frames = audio_frames_stub(gen, 8, cfg.n_audio_frames, cfg.d_model, dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    enc = encode(params, cfg, frames)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    enc_launches = ops.launch_counts()
    check_counts("whisper encode", enc_launches,
                 {"int8_flash_attention": cfg.n_encoder_layers,
                  "flash_attention": 0})
    if not (torch.isfinite(enc).all() and enc.dtype == torch.float32):
        raise AssertionError(f"whisper encode: {enc.dtype}, finite="
                             f"{bool(torch.isfinite(enc).all())}")
    requests = dense_requests(cfg, seed, XATTN_REQ, XATTN_NEW)
    eng = ServingEngine(params.decoder, cfg, ServeConfig(**SCFG, paged=True),
                        device=dev, kv_source=enc)
    if eng.paged:
        raise AssertionError("whisper: a paged engine did not fall back")
    res, tokens = timed_drain(eng, [requests], dev, cfg,
                              XATTN_MUST + ("int8_gemm",))
    eng.finished.clear()
    eng.reset_stats()
    reuse, tok2 = timed_drain(eng, [requests], dev, cfg, XATTN_MUST)
    del eng
    reuse.update(tokens_differ=count_diff(tok2, tokens),
                 compared_with="the same requests on a fresh engine (every "
                 "lane reused)", equal_required=True)
    if reuse["tokens_differ"]:
        raise AssertionError(f"whisper lane reuse: {reuse['tokens_differ']} "
                             f"tokens differ from the fresh engine's")
    per_step, syncs = decode_step_launches(params.decoder, cfg, dev, False)
    xattn_step_launches(cfg, per_step, 3)
    res.update(init_ptq_s=t_init, encode_s=t_enc,
               encode_launches=enc_launches,
               launches_per_decode_step=per_step, syncs_per_decode_step=syncs,
               profile={"bucket1": profile_step(params.decoder, cfg, dev, 1)})
    del params, enc
    gc.collect()
    torch.cuda.empty_cache()
    return {"dense": res, "reused lanes": reuse}


def serve_vision(dev, seed) -> dict:
    """llama-3.2-vision-90b W4A8 at full width and depth (random weights
    from ``seed``, built and quantized a block at a time; the down
    projection int8, C14): 8 lanes' stub vision tokens (8 x 1601 x 8192
    f32), whose cross K/V the engine projects once (int4_gemm twice and
    quantize_rows once per cross layer); XATTN_REQ requests x XATTN_NEW new;
    a bucket-1 step's launches (80 decode launches, no paged one, the fused
    norm 2 a layer + 1) and its profile; then ``lm_loss`` on SCORE_B x
    SCORE_T tokens with ``kv_source`` (int8_flash_attention once per
    ``attn`` layer), profiled.  Memory after the build and at each peak is
    recorded."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.models.frontend import vision_tokens_stub
    from repro_torch.serve import ServeConfig, ServingEngine
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = get_config(VISION, precision="w4a8")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device=dev, precision="w4a8")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    after_init = torch.cuda.memory_allocated(dev) / 2 ** 30
    init_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    gen = torch.Generator(device=dev).manual_seed(seed)
    src = vision_tokens_stub(gen, 8, cfg.n_vision_tokens, cfg.d_model, dev)
    n_cross = cfg.block_kinds.count("xattn")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng = ServingEngine(params, cfg, ServeConfig(**SCFG), device=dev,
                        kv_source=src)
    torch.cuda.synchronize()
    t_cross = time.perf_counter() - t0
    cross_launches = ops.launch_counts()
    check_counts("vision cross K/V", cross_launches,
                 {"int4_gemm": 2 * n_cross, "quantize_rows": n_cross})
    requests = dense_requests(cfg, seed, XATTN_REQ, XATTN_NEW)
    res, _ = timed_drain(eng, [requests], dev, cfg,
                         XATTN_MUST + ("int8_gemm", "int4_gemm",
                                       "dual_int4_gemm_gated"),
                         reset_peak=False)
    del eng
    per_step, syncs = decode_step_launches(params, cfg, dev, False)
    xattn_step_launches(cfg, per_step, 2)
    res.update(init_ptq_s=t_init, after_ptq_gib=after_init,
               init_peak_gib=init_peak, cross_kv_s=t_cross,
               cross_kv_launches=cross_launches,
               launches_per_decode_step=per_step, syncs_per_decode_step=syncs,
               profile={"bucket1": profile_step(params, cfg, dev, 1)})
    torch.cuda.empty_cache()
    lm = no_cache_loss(params, cfg, dev, score_tokens(cfg, dev, seed), True,
                       kv_source=src[:SCORE_B])
    del params, src
    gc.collect()
    torch.cuda.empty_cache()
    return {"dense": res, "lm_loss": lm}


WH_SCORE_T = 448                         # whisper's decoder context


@torch.no_grad()
def whisper_loss(dev, seed) -> dict:
    """whisper-small's ``encdec_loss`` on 4 clips of 1500 stub frames and
    4 x WH_SCORE_T tokens, at bf16 (float parameters from ``seed``) and
    W8A8 (quantized from them): the W8A8 forward launches
    int8_flash_attention 24 times (12 encoder, 12 decoder layers), the bf16
    one flash_attention 12 times (the decoder; 1500 frames are not a
    multiple of 8, so the encoder takes ``_sdpa``, as the reference); each
    forward once more under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import encdec_forward, encdec_loss, init_encdec_params
    from repro_torch.models.frontend import audio_frames_stub
    from repro_torch.quant import quantized_copy
    base = get_config(WHISPER)
    params = init_encdec_params(base, seed=seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    frames = audio_frames_stub(gen, SCORE_B, base.n_audio_frames,
                               base.d_model, dev)
    tokens = torch.randint(2, base.vocab_size, (SCORE_B, WH_SCORE_T),
                           generator=gen, device=dev)
    labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)], 1)
    n = base.n_layers
    out = {}
    for prec, want in (("bf16", {"flash_attention": n,
                                 "int8_flash_attention": 0}),
                       ("w8a8", {"flash_attention": 0,
                                 "int8_flash_attention":
                                     base.n_encoder_layers + n})):
        cfg = dataclasses.replace(base, precision=prec)
        model = params if prec == "bf16" else quantized_copy(params)
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        loss = float(encdec_loss(model, cfg, frames, tokens, labels))
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        check_counts(f"whisper {prec} encdec_loss forward", counts, want)
        if not (np.isfinite(loss) and loss > 0):
            raise AssertionError(f"whisper {prec} encdec_loss = {loss}")
        with profile(activities=[ProfilerActivity.CUDA,
                                 ProfilerActivity.CPU]) as prof:
            t0 = time.perf_counter()
            encdec_forward(model, cfg, frames, tokens)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        out[f"{WHISPER} {prec} encdec_loss"] = {
            "loss": loss, "wall_s": wall, "tokens": tokens.numel(),
            "frames": SCORE_B * base.n_audio_frames,
            "tok_per_s": tokens.numel() / wall,
            "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "launches": counts,
            "profile": {f"forward {SCORE_B} x ({base.n_audio_frames} frames, "
                        f"{WH_SCORE_T} tokens)": profile_summary(prof,
                                                                 wall_ms)}}
        del model
        torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def profile_step(params, cfg, dev, t: int, paged: bool = False) -> dict:
    """Wall time and device kernel time of one packed forward of 8 lanes x
    ``t`` rows on fresh int8 caches, dense or paged (torch.profiler,
    CUPTI): the device's busy share of the step and the kernels that fill
    it."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import forward
    st = fresh_states(cfg, dev, paged)
    tok = torch.full((8, t), 7, device=dev)
    pos = torch.arange(t, dtype=torch.int32, device=dev).expand(8, t)
    forward(params, cfg, tok, pos, st)                     # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        forward(params, cfg, tok, pos, st)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    res = profile_summary(prof, wall_ms)
    res["key_averages"] = parsers_agree(prof, res)
    return res


def prefill_attention(dev, seed) -> dict:
    """The cache attention of one bucket-256 prefill step at the serving
    paths' widths (8 lanes of 1024 slots, each lane's first prompt of
    16-256 tokens from ``seed`` at positions 0.., pads at -1, the cache
    holding what the step wrote), at starcoder2-3b's heads and
    codeqwen1.5-7b's: device ms (CUDA events, cold L2) of the reference's
    t > 1 path (``_read_cache`` then ``_sdpa``) and, where the port has it,
    of the decode kernels' multi-row form."""
    from repro_torch.kernels import ops
    from repro_torch.models.attention import _quant_kv, _read_cache, _sdpa
    gen = torch.Generator(device=dev).manual_seed(seed)
    timer = Timer(dev)
    b, s, t, d = 8, 1024, 256, 128
    fill = torch.from_numpy(np.random.default_rng(seed).integers(
        16, t + 1, size=b)).to(dev)
    slot = torch.arange(s, device=dev)
    pos_ids = torch.where(slot[None] < fill[:, None], slot[None],
                          -1).to(torch.int32)
    qpos = pos_ids[:, :t].contiguous()
    res = {"fill": fill.tolist()}
    for label, hq, hkv in (("starcoder2-3b", 24, 2), ("codeqwen1.5-7b", 32, 32)):
        cache = {}
        cache["k"], cache["k_s"] = _quant_kv(
            torch.randn((b, s, hkv, d), generator=gen, device=dev))
        cache["v"], cache["v_s"] = _quant_kv(
            torch.randn((b, s, hkv, d), generator=gen, device=dev))
        cache["pos_ids"] = pos_ids
        q = torch.randn((b, t, hq, d), generator=gen,
                        device=dev).to(torch.bfloat16)
        scale = 1.0 / d ** 0.5

        def sdpa():
            kc, vc = _read_cache(cache, torch.bfloat16)
            return _sdpa(q, kc, vc, qpos, pos_ids, scale, torch.bfloat16,
                         causal=True, valid=pos_ids >= 0)
        row = {"sdpa_ms": timer(sdpa)}
        if hasattr(ops, "decode_attention_int8kv_rows"):
            row["rows_ms"] = timer(lambda: ops.decode_attention_int8kv_rows(
                q, cache["k"], cache["k_s"], cache["v"], cache["v_s"],
                pos_ids, qpos, scale=scale))
        res[label] = row
        log(f"  {label} bucket-256 prefill attention: " + ", ".join(
            f"{k} {v:.4f}" for k, v in row.items()))
    return res


def serve_only(dev, seed) -> dict:
    """The dense starcoder2-3b w8a8 and codeqwen1.5-7b w4a8 drains of phase
    5, each with a bucket-1, 64 and 256 step profiled, then
    ``prefill_attention``: what two trees of the port are compared on."""
    out = {}
    for (label, arch, precision, n_req, max_new, _, must,
         _) in SERVE_PATHS[:2]:
        log(f"[5/10] serve full-width {label} int8-KV: {n_req} requests x "
            f"{max_new} new tokens")
        srv = out[label] = serve_full(dev, seed, arch, precision, n_req,
                                      max_new, True, must,
                                      buckets=(1, 64, 256))
        gc.collect()
        torch.cuda.empty_cache()
        log_drain(srv)
        per, syncs = (srv["launches_per_decode_step"],
                      srv["syncs_per_decode_step"])
        log(f"  bucket-1 step: {sum(per.values())} launches {per}; "
            f"{sum(syncs.values())} synchronizing calls {dict(syncs)}")
        log_profile(srv)
    out["prefill attention"] = prefill_attention(dev, seed)
    return out


# ---------------------------------------------------------------------------
# phase 6: the full-width no-cache forward (lm_loss, calibrate_ptq)
# ---------------------------------------------------------------------------

# (arch, precisions of the lm_loss forwards, calibrate first); "w8a8-float"
# is the integer-nonlinearity forward: a w8a8 config over float parameters
# (arch, precisions of the lm_loss forwards, calibrate first, then a w8a8
# lm_loss on 1 x LONG_T tokens)
NO_CACHE_PATHS = (("codeqwen1.5-7b", ("bf16", "w8a8", "w4a8", "w8a8-float"),
                   True, True),
                  ("starcoder2-3b", ("bf16", "w8a8", "w8a8-float"), False,
                   False),
                  ("zamba2-2.7b", ("bf16", "w8a8", "w4a8"), True, False))


def layer_counts(cfg) -> tuple[int, int]:
    """(attention layers, Mamba-2 layers) of a config: the launches of the
    no-cache attention kernel and of ssd_scan per forward."""
    from repro_torch.models.blocks import ATTN_KINDS
    kinds = cfg.block_kinds
    return (sum(k in ATTN_KINDS for k in kinds),
            sum(k == "mamba2" for k in kinds))
ACT_KERNEL = dict(REDUCED_MIXED)
# the w8a8 forwards profiled beside every bf16 and w4a8 one
PROFILED_W8A8 = ("codeqwen1.5-7b", "starcoder2-3b", "zamba2-2.7b")
CAL_B, CAL_T = 2, 128                      # calibration set: 2 x 128 tokens
LONG_T = 4096          # one codeqwen w8a8 sequence past the block form's keys


def no_cache_loss(params, cfg, dev, tokens, profiled: bool,
                  act_kernel: str | None = None, host: bool = True,
                  kv_source=None) -> dict:
    """``lm_loss`` of one forward over ``tokens`` with next-token labels
    (the last position masked): the loss, wall time, tokens/s, peak memory
    and the launches of the forward (zeroed just before, read just after);
    the attention kernel must have launched exactly once per attention
    layer, each int8 launch counted as streaming where the tree's
    ``streams`` says so (every launch since PR 21's one form; in a tree of
    PRs 15-20 exactly when the sequence is past the block form's keys),
    ssd_scan once per Mamba-2 layer, and ``act_kernel`` once per layer where
    given.  With ``profiled``, a second forward under
    torch.profiler (``host`` False: the device only).  ``kv_source``: the
    features the cross layers attend to (their attention is ``_sdpa``, no
    kernel)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.kernels.int8_flash_attention import streams
    from repro_torch.models import lm_loss
    labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)], 1)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    # (the keyword only where given: a parent tree's lm_loss may lack it)
    cross = {} if kv_source is None else {"kv_source": kv_source}
    loss = float(lm_loss(params, cfg, tokens, labels, **cross))
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    streamed = LAUNCHES["int8_flash_attention.streaming"]
    kernel = no_cache_kernel(cfg.precision)
    other = ({"flash_attention", "int8_flash_attention"} - {kernel}).pop()
    if not (np.isfinite(loss) and loss > 0):
        raise AssertionError(f"{cfg.name} {cfg.precision} lm_loss = {loss}")
    n_attn, n_mamba = layer_counts(cfg)
    if counts[kernel] != n_attn or counts[other]:
        raise AssertionError(f"{cfg.name} {cfg.precision} lm_loss forward: "
                             f"{kernel} launched {counts[kernel]} times for "
                             f"{n_attn} attention layers ({other}: "
                             f"{counts[other]})")
    if counts["ssd_scan"] != n_mamba:
        raise AssertionError(f"{cfg.name} {cfg.precision} lm_loss forward: "
                             f"ssd_scan launched {counts['ssd_scan']} times "
                             f"for {n_mamba} Mamba-2 layers")
    want_streamed = (n_attn if kernel == "int8_flash_attention"
                     and streams(tokens.shape[1], cfg.head_dim) else 0)
    if streamed != want_streamed:
        raise AssertionError(f"{cfg.name} {cfg.precision} lm_loss forward: "
                             f"{streamed} streaming launches, want "
                             f"{want_streamed}")
    if act_kernel is not None and counts[act_kernel] != cfg.n_layers:
        raise AssertionError(f"{cfg.name} {cfg.precision} lm_loss forward: "
                             f"{act_kernel} launched {counts[act_kernel]} "
                             f"times for {cfg.n_layers} layers")
    res = {"loss": loss, "wall_s": wall, "tokens": tokens.numel(),
           "tok_per_s": tokens.numel() / wall,
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "launches": counts, "streaming_launches": streamed}
    if profiled:
        res["profile"] = {f"forward {tokens.shape[0]} x {tokens.shape[1]}":
                          profile_no_cache(params, cfg, tokens, host,
                                           kv_source)}
    return res


def profile_no_cache(params, cfg, tokens, host: bool = True,
                     kv_source=None) -> dict:
    """Wall time, device busy time and the kernels by device time of one
    no-cache forward under torch.profiler; ``host`` False traces the device
    only (no synchronizing calls counted)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import forward
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        forward(params, cfg, tokens,
                **({} if kv_source is None else {"kv_source": kv_source}))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    res = profile_summary(prof, wall_ms)
    if not host:
        res["sync_calls"] = None                   # not traced
    return res


def calibrate(params, cfg, dev, seed) -> dict:
    """``calibrate_ptq`` with the reference's default grid (W4_GROUPS x
    W4_CLIPS for the attn and mlp classes) over CAL_B x CAL_T calibration
    tokens from ``seed``: the chosen policy, every candidate's score, the
    wall time, and B11 launched once per attention layer (B16 once per
    Mamba-2 layer) on each of its 19 forwards."""
    from repro_torch.kernels import ops
    from repro_torch.models import forward
    from repro_torch.quant import W4_CLIPS, W4_GROUPS, calibrate_ptq
    cal = torch.from_numpy(np.random.default_rng([seed, 6]).integers(
        2, cfg.vocab_size, size=(CAL_B, CAL_T))).to(dev)
    qcfg = dataclasses.replace(cfg, precision="w4a8")

    def forward_logits(model):
        return forward(model, qcfg, cal)[0]
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    policy, report = calibrate_ptq(params, forward_logits)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    n_fwd = 1 + 2 * len(W4_GROUPS) * len(W4_CLIPS)
    n_attn, n_mamba = layer_counts(cfg)
    if (counts["int8_flash_attention"] != n_fwd * n_attn
            or counts["ssd_scan"] != n_fwd * n_mamba):
        raise AssertionError(f"calibrate_ptq: int8_flash_attention launched "
                             f"{counts['int8_flash_attention']} times and "
                             f"ssd_scan {counts['ssd_scan']} for {n_fwd} "
                             f"forwards of {n_attn} attention and {n_mamba} "
                             f"Mamba-2 layers")
    for cls in ("attn", "mlp"):
        if not all(np.isfinite(c["mse"]) for c in report[cls]["scores"]):
            raise AssertionError(f"calibrate_ptq {cls}: non-finite scores")
    return {"policy": policy, "report": report, "wall_s": wall,
            "forwards": n_fwd, "tokens": CAL_B * CAL_T,
            "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "launches": counts}


def cal_only(dev, seed) -> dict:
    """Phase 6's ``calibrate`` for each calibrated model (float parameters
    from ``seed`` at full width and depth), run twice: timed, then under
    torch.profiler (device busy ms, int4_gemm's share): what two trees of
    the port are compared on."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    out = {}
    for arch, _, calibrated, _ in NO_CACHE_PATHS:
        if not calibrated:
            continue
        cfg = get_config(arch)
        params = init_params(cfg, seed=seed, device=dev)
        res = out[f"{arch} calibrate_ptq"] = calibrate(params, cfg, dev, seed)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            calibrate(params, cfg, dev, seed)
            wall_ms = (time.perf_counter() - t0) * 1e3
        res["profile"] = {"calibrate_ptq": profile_summary(prof, wall_ms)}
        log(f"  {arch} calibrate_ptq in {res['wall_s']:.2f}s: policy "
            f"{res['policy']}")
        log_profile(res)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def xlstm_only(dev, seed) -> dict:
    """xlstm-350m's tokenwise W8A8 drains (``serve_xlstm``) and its
    ``lm_loss`` at bf16, W8A8 and W4A8 without the profiler: the host walls
    (TPOT, tokens/s, loss wall) two trees are compared on."""
    out = {f"xlstm-350m w8a8 {k}": v for k, v in serve_xlstm(dev, seed).items()}
    out.update(xlstm_loss(dev, seed, profiled=False))
    return out


def lm_only(dev, seed) -> dict:
    """Phase 6's W8A8 ``lm_loss`` of codeqwen1.5-7b, starcoder2-3b and
    zamba2-2.7b (NC_B x NC_T tokens), each timed and then profiled: the
    forwards where int8_gemm, int8_flash_attention and ssd_scan take their
    device time, what two trees are compared on."""
    out = {}
    for arch in ("codeqwen1.5-7b", "starcoder2-3b", "zamba2-2.7b"):
        out.update(no_cache_full(dev, seed, arch, ("w8a8",), False, False))
    return out


def no_cache_full(dev, seed, arch, precisions, calibrated, long_w8a8) -> dict:
    """Phase 6 for one model: float parameters from ``seed`` at full width
    and depth, then ``lm_loss`` on NC_B x NC_T random tokens at each
    precision (each integer model quantized from the float one and freed
    before the next; "w8a8-float" runs the w8a8 config over the float
    parameters) and, first, ``calibrate_ptq`` where ``calibrated``; with
    ``long_w8a8`` last a w8a8 ``lm_loss`` on 1 x LONG_T tokens, whose
    attention takes int8_flash_attention's streaming form.  Returns {path
    label: result}."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.quant import DEFAULT_W4_POLICY, quantized_copy
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    log(f"  float init {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.1f} GiB")
    tokens = torch.from_numpy(np.random.default_rng([seed, 5]).integers(
        2, cfg.vocab_size, size=(NC_B, NC_T))).to(dev)
    out = {}
    if calibrated:
        res = out[f"{arch} calibrate_ptq"] = calibrate(params, cfg, dev, seed)
        log(f"  calibrate_ptq ({res['forwards']} forwards of {CAL_B} x "
            f"{CAL_T} tokens) in {res['wall_s']:.1f}s, peak "
            f"{res['peak_mem_gib']:.1f} GiB: policy {res['policy']}")
        for cls in ("attn", "mlp"):
            log(f"    {cls}: " + ", ".join(
                f"g{c['group']}/c{c['clip']}={c['mse']:.4g}"
                for c in res["report"][cls]["scores"]))
    runs = [(precision, tokens) for precision in precisions]
    if long_w8a8:
        runs.append(("w8a8", torch.from_numpy(np.random.default_rng(
            [seed, 7]).integers(2, cfg.vocab_size, size=(1, LONG_T))).to(dev)))
    for precision, toks in runs:
        float_weights = precision in ("bf16", "w8a8-float")
        pcfg = dataclasses.replace(cfg, precision=precision.split("-")[0])
        model = (params if float_weights else quantized_copy(
            params, DEFAULT_W4_POLICY if precision == "w4a8" else None))
        label = f"{arch} {precision} lm_loss" + (
            f" {toks.shape[0]}x{toks.shape[1]}" if toks is not tokens else "")
        res = out[label] = no_cache_loss(
            model, pcfg, dev, toks, profiled=precision in ("w4a8", "bf16")
            or (precision == "w8a8" and arch in PROFILED_W8A8
                and toks is tokens),
            act_kernel=ACT_KERNEL[arch] if precision == "w8a8-float" else None)
        del model
        gc.collect()
        log(f"  lm_loss {precision} ({toks.shape[0]} x {toks.shape[1]}): "
            f"{res['loss']:.4f} in {res['wall_s']:.2f}s "
            f"({res['tok_per_s']:.0f} tok/s), peak "
            f"{res['peak_mem_gib']:.1f} GiB; launches {res['launches']}, "
            f"{res['streaming_launches']} in the streaming form")
        log_profile(res)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def softmax_entry(dev, seed) -> dict:
    """``ops.softmax_i8``, the integer softmax's public entry point, on the
    causal score rows of NC_B sequences x NC_T tokens of one head (int32 at
    the integer attention's score scale): launches counted around the call,
    probabilities in [0, 127] whose rows sum to 127 within rounding."""
    from repro_torch.kernels import ops
    from repro_torch.models.attention import int_score_scale
    gen = torch.Generator(device=dev).manual_seed(seed)
    sc = int_score_scale(128)
    x = torch.randint(-4000, 4000, (NC_B * NC_T, NC_T), generator=gen,
                      device=dev, dtype=torch.int32)
    keep = torch.ones((NC_T, NC_T), dtype=torch.bool, device=dev).tril()
    ops.reset_launch_counts()
    p = ops.softmax_i8(x.view(NC_B, NC_T, NC_T), sc, keep)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    rows = p.int().sum(-1)
    if not (counts["int_softmax"] == 1 and int(p.min()) >= 0
            and int((rows - 127).abs().max()) <= NC_T // 2):
        raise AssertionError(f"ops.softmax_i8: launches {counts}, row sums "
                             f"{int(rows.min())}..{int(rows.max())}")
    return {"launches": counts, "row_sum_range": [int(rows.min()),
                                                  int(rows.max())]}


def int_library_entry(dev, seed) -> dict:
    """The integer library's public entry points as a user calls them: the
    paper's Table II kernels — ``ops.conv2d_i8`` with a requant on one
    3x128x128 image and 8 3x3x3 filters, ``ops.gemm_i8`` (requant),
    ``gemm_i8_gelu`` and ``gemm_i8_add`` at [32, 64] x [64, 32], and
    ``ops.requant`` of the GEMM's int32 accumulator with ``gelu_i8`` and
    ``silu_i8`` of its int8 payload — and ``frontend.conv_patch_embed_int8`` (ViT-B/16: 32
    images of 224x224 into 768 channels), which must equal the same call on
    the CPU bit for bit.  Counts are zeroed just before and read just after;
    every one of the path's kernels must have launched, and each output
    equals its plain version on the same inputs."""
    from repro_torch.core.inumerics import compute_requant_params
    from repro_torch.kernels import ops
    from repro_torch.kernels.conv2d import int8_conv2d_ref
    from repro_torch.kernels.int8_gemm import (int8_gemm_add_ref,
                                               int8_gemm_gelu_ref,
                                               int8_gemm_ref, int8_matmul_ref)
    from repro_torch.kernels.int_gelu import int_gelu_ref
    from repro_torch.kernels.int_silu import int_silu_ref
    from repro_torch.kernels.quantize import requantize_i32_ref
    from repro_torch.models.frontend import conv_patch_embed_int8
    from repro_torch.models.layers import GELU_INT_SCALE, SILU_INT_SCALE
    gen = torch.Generator(device=dev).manual_seed(seed)

    def ints(lo, hi, *shape, dtype=torch.int8):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=dtype)
    n_, h, wd, c, kh, kw, o = TABLE2_CONV
    img, filt = ints(-128, 128, n_, h, wd, c), ints(-128, 128, kh, kw, c, o)
    bias = ints(-2 ** 16, 2 ** 16, o, dtype=torch.int32)
    crq = compute_requant_params(0.01, acc_bound=kh * kw * c * 127 * 127)
    m, k, n = TABLE2_GEMM
    x, w, r = ints(-128, 128, m, k), ints(-128, 128, k, n), ints(-128, 128, m, n)
    grq = compute_requant_params(1 / (127 * k ** 0.5), acc_bound=k * 127 * 127)
    cpu_gen = torch.Generator().manual_seed(seed)
    images = torch.rand((VIT_IMAGES, VIT_SIDE, VIT_SIDE, 3),
                        generator=cpu_gen) * 2 - 1
    weight = torch.randn((1, 1, VIT_PATCH * VIT_PATCH * 3, VIT_D),
                         generator=cpu_gen)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = {"conv2d_i8": ops.conv2d_i8(img, filt, bias, crq),
           "gemm_i8": ops.gemm_i8(x, w, grq),
           "gemm_i8_gelu": ops.gemm_i8_gelu(x, w, GELU_INT_SCALE),
           "gemm_i8_add": ops.gemm_i8_add(x, w, grq, r)}
    q = out["requant"] = ops.requant(ops.gemm_i8(x, w), grq)
    out.update(gelu_i8=ops.gelu_i8(q, GELU_INT_SCALE),
               silu_i8=ops.silu_i8(q, SILU_INT_SCALE))
    emb = conv_patch_embed_int8(None, images.to(dev), VIT_D, VIT_PATCH,
                                weight=weight)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    missing = [kn for kn in ("int8_conv2d", "int8_gemm", "requantize_i32",
                             "int_gelu", "int_silu") if counts[kn] == 0]
    if missing:
        raise AssertionError(f"integer library path: {missing} not launched")
    q_ref = requantize_i32_ref(int8_matmul_ref(x, w), grq)
    plain = {"conv2d_i8": int8_conv2d_ref(img, filt, bias, crq),
             "gemm_i8": int8_gemm_ref(x, w, grq),
             "gemm_i8_gelu": int8_gemm_gelu_ref(x, w, GELU_INT_SCALE),
             "gemm_i8_add": int8_gemm_add_ref(x, w, grq, r),
             "requant": q_ref, "gelu_i8": int_gelu_ref(q_ref, GELU_INT_SCALE),
             "silu_i8": int_silu_ref(q_ref, SILU_INT_SCALE)}
    for name, got in out.items():
        if not torch.equal(got, plain[name]):
            raise AssertionError(f"ops.{name}: differs from its plain version")
    emb_cpu = conv_patch_embed_int8(None, images, VIT_D, VIT_PATCH,
                                    weight=weight)
    if not (tuple(emb.shape) == (VIT_IMAGES, (VIT_SIDE // VIT_PATCH) ** 2,
                                 VIT_D) and torch.isfinite(emb).all()
            and torch.equal(emb.cpu(), emb_cpu)):
        raise AssertionError(f"conv_patch_embed_int8: shape "
                             f"{tuple(emb.shape)}, not equal to the CPU's "
                             f"(max |d| {max_err(emb.cpu(), emb_cpu)})")
    return {"launches": counts, "patch_embed_shape": list(emb.shape),
            "outputs": {k: list(v.shape) for k, v in out.items()}}


# kernels whose device ms every profile reports (summed over the CUDA
# functions whose names hold ``<kernel>_kernel``, or the pattern
# ``PROFILED_NAMES`` gives): those redesigned for Hopper — the tensor-core
# GEMMs, flash_attention, both decode attentions, the norm and quantize
# kernels, int8_flash_attention (``int8_attention_kernel``, and the
# ``int8_attention_stream_kernel`` of trees before PR 21: never
# flash_attention's) and ssd_scan (its four ``ssd_scan_*`` kernels, and the
# ``ssd_scan_kernel`` of trees before PR 21)
# ---------------------------------------------------------------------------
# phase 7: training (the bf16 path under autograd)
# ---------------------------------------------------------------------------

# B12 under its Function at the full-width training shapes (B = 4, T = 1024)
TRAIN_ATTN = (("starcoder", 24, 2, 128), ("codeqwen", 32, 32, 128))
# the per-leaf bound of the CPU tests (tests/test_torch_train.py GRAD_REL_L2)
GRAD_REL_L2 = 0.03
TRAIN_REDUCED = ("starcoder2-3b", "codeqwen1.5-7b")
TRAIN_B, TRAIN_T, TRAIN_STEPS = 4, 1024, 8
# (arch, layers kept, batch, tokens, steps, the last loss below the first):
# starcoder2-3b whole; codeqwen1.5-7b at full width cut to 8 layers (2.6 B
# parameters: f32 weights, gradients and two moments fit on one 80 GB card)
TRAIN_PATHS = (("starcoder2-3b", None, TRAIN_B, TRAIN_T, TRAIN_STEPS, True),
               ("codeqwen1.5-7b", 8, TRAIN_B, TRAIN_T, TRAIN_STEPS, True))
# the peak learning rate of the 8-step runs (warmup 2, cosine to 0.1x): at
# 3e-4 Adam's first sign-like steps throw a random full-width model's loss
# from ~11-12.5 to 21-28 and codeqwen-8L ended above its first loss (12.70
# against 12.52); at 3e-5 both still spike at step 1 and end 2.6-2.8 below
# it (scripts/train_lr_sweep.py; PERF.md §6)
TRAIN_LR = 3e-5


def train_kernels() -> tuple[str, ...]:
    """The kernels that launch inside an autograd Function
    (``common.GRAD_KERNELS``) by source and profiled name: the
    expert-batched bf16 B4 is dual_gemm_gated's source and kernel."""
    from repro_torch.kernels import common
    return tuple(dict.fromkeys(k.removesuffix("_experts")
                               for k in common.GRAD_KERNELS))


def grads_equal(kernel: str, what: str, got, want) -> None:
    for i, (a, b) in enumerate(zip(got, want)):
        if not torch.equal(a, b):
            raise AssertionError(
                f"{kernel} {what}: input {i}'s gradient differs from "
                f"autograd of the plain version by {max_err(a, b)}")


def fwd_bwd(fn, ins, dout):
    leaves = [x.detach().requires_grad_() for x in ins]
    return torch.autograd.grad(fn(*leaves), leaves, dout)


def train_case(timer, record, out_ms, kernel, label, run, plain, lib, ins,
               dout, tol, nbytes, nops, peak, note, want=None):
    """One kernel under its Function at a training shape: the forward
    within ``tol`` (rtol, atol) of ``want`` (default: the plain version's
    output), the input gradients (one upstream gradient ``dout``)
    ``torch.equal`` to autograd of the plain version; forward + backward
    timed beside the plain version's and the library's (``lib``, a
    yardstick only, never on the path; None: no PyTorch call computes it).
    Adds the case's forward, backward (forward + backward less forward)
    and plain backward ms to ``out_ms``."""
    out = run(*ins)
    ref = plain(*ins) if want is None else want
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    if not (torch.isfinite(out).all() and bool(
            (err <= tol[1] + tol[0] * ref.float().abs()).all())):
        raise AssertionError(f"{kernel} {label}: forward beyond rtol="
                             f"{tol[0]} atol={tol[1]}")
    del out, ref
    grads_equal(kernel, label, fwd_bwd(run, ins, dout),
                fwd_bwd(plain, ins, dout))
    fwd = timer(lambda: run(*ins))
    ms = timer(lambda: fwd_bwd(run, ins, dout), iters=5, warmup=1)
    plain_ms = timer(lambda: fwd_bwd(plain, ins, dout), iters=3, warmup=1)
    plain_fwd = timer(lambda: plain(*ins), iters=3, warmup=1)
    lib_ms = (None if lib is None else
              timer(lambda: fwd_bwd(lib, ins, dout), iters=5, warmup=1))
    record(kernel, f"train fwd+bwd {label}", float(err.max()), False, ms,
           plain_ms, lib_ms, bound(nbytes, nops, peak), lib_note=note)
    out_ms[f"{kernel} {label}"] = {
        "forward_ms": fwd, "backward_ms": ms - fwd,
        "plain_backward_ms": plain_ms - plain_fwd}
    log(f"    forward {fwd:.4f} ms, backward (plain version's autograd) "
        f"{ms - fwd:.4f} ms; the plain forward + backward's backward "
        f"{plain_ms - plain_fwd:.4f} ms")


def check_train_kernels(dev, gen, timer, record, randn) -> dict:
    """B12 and the bf16 B4 under their ``torch.autograd.Function``s at the
    training shapes (``train_case``), with SDPA's and two
    ``torch.matmul``'s forward + backward as yardsticks.  Bound: each
    input, output and gradient byte once; operations: the forward's two
    products and the backward's four (12 x pairs x D per head for
    attention, 12 M N K for the gated MLP) at the bf16 rate.  Returns each
    case's forward, backward and plain backward ms."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (
        ATOL as FA_ATOL, RTOL as FA_RTOL, flash_attention_ref)
    from repro_torch.kernels.int8_gemm import (
        DUAL_BF16_ATOL, DUAL_BF16_RTOL, gated_mlp_ref)
    out_ms = {}
    b, t = TRAIN_B, TRAIN_T
    pairs = t * (t + 1) // 2
    for label, h, hkv, d in TRAIN_ATTN:
        ins = [randn(b, n, t, d).to(torch.bfloat16) for n in (h, hkv, hkv)]
        dout = randn(b, h, t, d).to(torch.bfloat16)

        def sdpa(q, k, v, g=h // hkv):
            return torch.nn.functional.scaled_dot_product_attention(
                q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1),
                is_causal=True)
        size = sum(x.numel() for x in ins) + dout.numel()
        train_case(timer, record, out_ms, "flash_attention",
                   f"{label} B={b} T={t} H={h} Hkv={hkv} D={d}",
                   lambda q, k, v: ops.attention(q, k, v),
                   lambda q, k, v: flash_attention_ref(q, k, v), sdpa, ins,
                   dout, (FA_RTOL, FA_ATOL), 2 * 2 * size,
                   12 * b * h * pairs * d, BF16_OPS,
                   "SDPA forward + backward over K/V repeated to every "
                   "head (the plain version's gradients, not the port's)")
        del ins, dout
    m, k, n = TRAIN_B * TRAIN_T, GATED_K, GATED_N
    ins = [randn(m, k).to(torch.bfloat16)] + [
        randn(k, n, scale=k ** -0.5).to(torch.bfloat16) for _ in range(2)]
    dout = randn(m, n).to(torch.bfloat16)
    train_case(timer, record, out_ms, "dual_gemm_gated",
               f"bf16 [{m},{k}]x2[{k},{n}] silu",
               lambda x, u, g: ops.gated_mlp(x, u, g, "silu"),
               lambda x, u, g: gated_mlp_ref(x, u, g, "silu"),
               lambda x, u, g: x @ u + x @ g, ins, dout,
               (DUAL_BF16_RTOL, DUAL_BF16_ATOL),
               2 * (2 * m * k + 4 * k * n + 2 * m * n), 12 * m * n * k,
               BF16_OPS, "two torch.matmul forward + backward, no "
               "activation: not the same function")
    return out_ms


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / a.norm().clamp(min=1e-30))


# bf16_gemm launches a block of each kind runs outside its MLP: q, k, v and
# o of each attention (a ``dec`` layer's self and cross), Mamba-2's in_proj
# and out_proj, the mLSTM's w_gate, wq, wk, wv, w_if and wo (its w_up is
# an f64-rounded matmul), the sLSTM's w_in and wo
KIND_LINEARS = {"mamba2": 2, "mlstm": 6, "slstm": 2, "dec": 8}


def train_counts(cfg, t: int, enc_t: int = 0) -> dict:
    """The launches of one bf16 no-cache forward of ``cfg`` over ``t``
    tokens (an encoder over ``enc_t`` frames): flash_attention once per
    causal self-attention layer without a window whose rows are a multiple
    of 8 (attention's rule; cross-attention and windows take ``_sdpa``),
    ssd_scan once per Mamba-2 layer, the bf16 dual_gemm_gated once per
    gated MLP (the SwiGLU lineage) and once per MoE layer's experts (the
    expert-batched form, ``.experts`` too); bf16_gemm once per float
    linear (``KIND_LINEARS``, and an MLP's down projection, and its up
    projection where it is not gated; a MoE layer's shared expert; the
    experts' down projection is a batched matmul and the heads are f32);
    nothing else."""
    gated = cfg.activation == "silu"
    mlp_linears = 1 if gated else 2
    want = collections.Counter()
    for kind in cfg.block_kinds + ("enc",) * cfg.n_encoder_layers:
        rows = enc_t if kind == "enc" else t
        want["flash_attention"] += (kind in ("attn", "moe", "shared_attn",
                                             "dec", "enc") and rows % 8 == 0)
        want["ssd_scan"] += kind == "mamba2"
        want["bf16_gemm"] += KIND_LINEARS.get(kind, 4)
        if kind in ("moe", "moe_swa"):
            want["dual_gemm_gated.experts"] += 1
            shared = gated and cfg.n_shared_experts > 0
            want["dual_gemm_gated"] += 1 + shared
            want["bf16_gemm"] += mlp_linears * shared
        elif kind not in ("mamba2", "mlstm", "slstm"):
            want["dual_gemm_gated"] += gated
            want["bf16_gemm"] += mlp_linears
    return {k: int(v) for k, v in want.items() if v}


def check_launches(what: str, got: dict, want: dict, per: int = 1) -> None:
    """``got`` (``ops.launch_counts(forms=True)``) holds ``want`` x
    ``per`` and no other launch."""
    want = {k: v * per for k, v in want.items()}
    if any(got[k] != want.get(k, 0) for k in got):
        raise AssertionError(f"{what}: launches "
                             f"{ {k: v for k, v in got.items() if v} }, "
                             f"want {want} and nothing else")


def routing(run):
    """``run()`` under a recorder of the MoE routing: (the smallest gap
    between any token's k-th and (k+1)-th router probabilities over every
    MoE layer, inf without one; every layer's choices and kept flags, on
    the host)."""
    from repro_torch.models import moe as tmoe
    gaps, choices, route = [], [], tmoe._route

    def recording(probs, k, capacity):
        top = torch.sort(probs.detach(), dim=-1, descending=True).values
        gaps.append(float((top[..., k - 1] - top[..., k]).min()))
        out = route(probs, k, capacity)
        choices.extend(t.cpu() for t in out[:3])
        return out
    tmoe._route = recording
    try:
        run()
    finally:
        tmoe._route = route
    return min(gaps, default=float("inf")), choices


# a bf16 router near-tie (ROADMAP C12): a gap below this between a token's
# k-th and (k+1)-th router probabilities flips its top-k on a rounding
NEAR_TIE = 1e-3
MOE_SEEDS = 8          # seeds tried for a reduced MoE model without one
RED_B, RED_T, RED_FRAMES, RED_VIS = 2, 32, 60, 16


def reduced_train_loss(m, cfg, tok, lab, feats, order: bool):
    """The loss a training step differentiates: ``lm_loss`` (with
    ``kv_source`` for a VLM), or whisper's ``encdec_loss`` written out as
    ``encode`` then the decoder's ``forward`` (the same ops), so that
    ``card_order`` reaches the decoder."""
    from repro_torch.models import encode, forward, xent_loss
    kv = feats
    if cfg.is_encoder_decoder:
        kv, m = encode(m, cfg, feats), m.decoder
    lg, _ = forward(m, cfg, tok, card_order=order, kv_source=kv)
    return xent_loss(lg, lab)


def reduced_tree(cfg, seed: int):
    """The reference-layout tree of a reduced model from ``seed`` (made
    on the CPU; a VLM's gates at ``XATTN_GATES``, one value per element of
    the stream, RED_B x RED_T x d: the same loss, whose gate gradients are
    the terms that a scalar gate's gradient sums — a sum that bf16 rounding
    decides at these inputs, as tests/test_torch_train_archs.py finds) and
    its inputs: tokens, labels and the stub features (whisper's frames,
    ``RED_FRAMES``: not a multiple of 8, so the encoder takes ``_sdpa`` on
    both devices, as 1500 frames do; vision's ``RED_VIS`` tokens) at the
    stubs' scale."""
    from repro_torch.convert import to_reference
    from repro_torch.models import init_encdec_params, init_params
    if cfg.is_encoder_decoder:
        m = init_encdec_params(cfg, seed=seed, device="cpu")
    else:
        m = init_params(cfg, seed=seed, device="cpu")
        if cfg.family == "vlm":
            with torch.no_grad():
                gate_xattn(m)
    rng = np.random.default_rng(seed)
    tok, lab = (torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                              (RED_B, RED_T)))
                for _ in range(2))
    n = (RED_FRAMES if cfg.is_encoder_decoder else
         RED_VIS if cfg.family == "vlm" else 0)
    feats = (torch.from_numpy((rng.normal(size=(RED_B, n, cfg.d_model))
                               * 0.02).astype(np.float32)) if n else None)
    tree = to_reference(m, cfg)
    for per in tree["periods"] if cfg.family == "vlm" else ():
        for k in ("gate_attn", "gate_mlp"):
            if k in per:
                g = per[k].reshape(-1, 1, 1, 1)
                per[k] = np.broadcast_to(
                    g, (len(g), RED_B, RED_T, cfg.d_model)).copy()
    return tree, (tok, lab, feats)


def check_train_reduced(dev, seed, archs=TRAIN_REDUCED) -> dict:
    """One backward of each reduced arch's training loss
    (``reduced_train_loss``, 2 x 32 tokens) from one weight set (made on
    the CPU, converted to the reference's layout and back onto each
    device): on the card (the kernels under their Functions, one launch a
    layer: reduced configs have remat off; ``train_counts``) against the
    CPU in the card's order (``card_order``: the no-cache attention through
    flash_attention's plain version) — the loss within ``CARD_ORDER_TOL``
    (relative), every leaf's gradient within the CPU tests'
    ``GRAD_REL_L2`` (relative L2) — and against the CPU's own path
    (``_sdpa``, probabilities rounded to bf16 before P@V: C3) within phase
    4's ``REDUCED_TOL``, as phase 4 holds logits (both reported).  A MoE
    arch takes the first seed from ``seed`` whose routing has no near-tie
    (``NEAR_TIE``, C12) on the card or the CPU, and says which and the
    gaps of each seed it tried; there the card must make the CPU's choices
    (a flip moves the capacity order of every later token): a flip without
    a near-tie fails."""
    from repro_torch.configs import get_config
    from repro_torch.convert import from_reference
    from repro_torch.kernels import ops
    res = {}
    for arch in archs:
        cfg = get_config(arch, reduced=True)
        gaps = {}                  # seed: the least gaps, card and CPU
        for s in range(seed, seed + (MOE_SEEDS if cfg.n_experts else 1)):
            tree, (tok, lab, feats) = reduced_tree(cfg, s)
            if not cfg.n_experts:
                break
            (gap_c, cpu), (gap_g, card) = (routing(
                lambda: reduced_train_loss(
                    from_reference(tree, cfg, where), cfg, tok.to(where),
                    lab.to(where), feats, order))
                for where, order in (("cpu", True), (dev, False)))
            gaps[s] = [gap_g, gap_c]
            log(f"  {arch}-reduced seed {s}: the least top-k gap "
                f"{gap_g:.6f} on the card, {gap_c:.6f} on the CPU")
            if min(gap_c, gap_g) < NEAR_TIE:
                continue
            if not all(torch.equal(a, b) for a, b in zip(cpu, card)):
                raise AssertionError(
                    f"{arch}-reduced seed {s}: the card's routing differs "
                    f"from the CPU's with no near-tie (least gaps {gap_g} "
                    f"and {gap_c}, NEAR_TIE {NEAR_TIE})")
            break
        else:
            raise AssertionError(f"{arch}-reduced: a router near-tie at "
                                 f"every seed {seed}..{s}")
        out = {}
        for name, where, order in (("cpu", "cpu", False),
                                   ("order", "cpu", True),
                                   ("card", dev, False)):
            m = from_reference(tree, cfg, where)
            for p in m.parameters():
                p.requires_grad_(p.is_floating_point())
            named = {k: p for k, p in m.named_parameters()
                     if p.requires_grad}
            ops.reset_launch_counts()
            loss = reduced_train_loss(
                m, cfg, tok.to(where), lab.to(where),
                None if feats is None else feats.to(where), order)
            grads = torch.autograd.grad(loss, list(named.values()))
            out[name] = (float(loss.detach()), dict(zip(named, grads)),
                         ops.launch_counts(forms=True))
        want = train_counts(cfg, RED_T, RED_FRAMES)
        check_launches(f"{arch}-reduced backward", out["card"][2], want)
        lg_ = out["card"][0]
        r = res[arch] = {"seed": s, "router_gaps": gaps, "loss_card": lg_,
                         "launches": want}
        card = out["card"][1]
        for name, limit in (("order", GRAD_REL_L2), ("cpu", REDUCED_TOL)):
            lc, gc_, _ = out[name]
            worst = max((rel_l2(g, card[k2]), k2) for k2, g in gc_.items())
            log(f"  {arch}-reduced (seed {s}) vs the CPU"
                f"{' in the card order' if name == 'order' else ''}: loss "
                f"{lc:.6f} / card {lg_:.6f}; worst leaf gradient {worst[1]} "
                f"at {worst[0]:.4f} relative L2 (limit {limit})")
            if not (np.isfinite(lg_)
                    and abs(lg_ - lc) <= CARD_ORDER_TOL * abs(lc)):
                raise AssertionError(f"{arch}-reduced loss: card {lg_} vs "
                                     f"{name} {lc}")
            if not worst[0] <= limit:
                raise AssertionError(f"{arch}-reduced gradient of {worst[1]}:"
                                     f" {worst[0]:.4f} relative L2 from the "
                                     f"{name} CPU run's")
            r.update({f"loss_{name}": lc, f"worst_leaf_{name}": worst[1],
                      f"worst_rel_l2_{name}": worst[0]})
        log(f"  launches {want}")
    return res


def profile_train_step(tr, batch, loss_fn) -> dict:
    """One more step of ``tr`` written out as the trainer runs it (the
    loss ``loss_fn(tr.params, batch)``, ``torch.autograd.grad``, the
    in-place AdamW) under torch.profiler, the device's events only (the
    host's would multiply an xlstm step's ~400k kernels' events; no
    synchronizing calls counted), CUDA events between the three: each phase's device span, the
    Functions' kernel time (half of it the remat recompute in the
    backward), the device's busy and idle shares of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.convert import reference_ndims
    from repro_torch.train.optimizer import adamw_update
    named = tr.named
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ev[0].record()
        loss = loss_fn(tr.params, batch)
        ev[1].record()
        grads = torch.autograd.grad(loss, list(named.values()))
        ev[2].record()
        _, tr.opt_state, _ = adamw_update(
            tr.train_cfg.optimizer, named, dict(zip(named, grads)),
            tr.opt_state, reference_ndims(tr.params, tr.cfg))
        ev[3].record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    del grads
    t0 = time.perf_counter()
    res = profile_summary(prof, wall)
    res["summary_s"] = time.perf_counter() - t0
    res["sync_calls"] = None                       # not traced
    fwd, bwd, opt = (ev[i].elapsed_time(ev[i + 1]) for i in range(3))
    kern = sum(res["kernel_ms"][k] for k in train_kernels())
    res.update(forward_ms=fwd, backward_ms=bwd, optimizer_ms=opt,
               shares={"kernels_forward": kern / 2 / wall,
                       "kernels_recompute": kern / 2 / wall,
                       "backward_less_kernels": (bwd - kern / 2) / wall,
                       "optimizer": opt / wall,
                       "idle": 1 - res["device_busy_ms"] / wall})
    return res


class EncDecTrainer:
    """The trainer's step over ``encdec_loss``, written out for whisper
    (the reference's trainer takes ``lm_loss`` only): a ``TokenPipeline``
    batch on the card with stub frames from ``seed``, ``value_and_grad``,
    then the in-place AdamW; ``Trainer``'s attributes and ``run``'s
    history, so that ``train_full`` and ``profile_train_step`` drive
    both."""

    def __init__(self, cfg, train_cfg, params, dev, seed: int):
        from repro_torch.convert import reference_ndims
        from repro_torch.train.optimizer import init_opt_state
        from repro_torch.train.trainer import trained_params
        for p in params.parameters():
            if p.is_floating_point():
                p.requires_grad_(True)
        self.cfg, self.train_cfg, self.params, self.dev = (cfg, train_cfg,
                                                           params, dev)
        self.named = trained_params(params)
        self.opt_state = init_opt_state(self.named)
        self.ndims = reference_ndims(params, cfg)
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.step = 0

    def loss_fn(self, params, batch):
        from repro_torch.models import encdec_loss
        return encdec_loss(params, self.cfg, batch["frames"],
                           batch["tokens"], batch["labels"])

    def batch(self, host: dict) -> dict:
        from repro_torch.models.frontend import audio_frames_stub
        from repro_torch.train.trainer import to_device
        b = to_device(host, self.dev)
        b["frames"] = audio_frames_stub(
            self.gen, b["tokens"].shape[0], self.cfg.n_audio_frames,
            self.cfg.d_model, self.dev)
        return b

    def run(self, data, n_steps: int, log_fn=print) -> list[dict]:
        from repro_torch.train.optimizer import adamw_update
        from repro_torch.train.trainer import value_and_grad
        hist = []
        for _ in range(n_steps):
            batch = self.batch(next(data))
            t0 = time.time()
            loss, grads = value_and_grad(self.loss_fn, self.params,
                                         self.named, batch)
            _, self.opt_state, met = adamw_update(
                self.train_cfg.optimizer, self.named, grads, self.opt_state,
                self.ndims)
            met = {k: float(v) for k, v in dict(met, loss=loss).items()}
            met.update(step=self.step, dt=time.time() - t0)
            log_fn(f"step {self.step:5d} loss {met['loss']:.4f} gnorm "
                   f"{met['grad_norm']:.3f} {met['dt'] * 1e3:.0f} ms")
            hist.append(met)
            self.step += 1
        return hist


def train_full(dev, seed, arch: str, n_layers, b: int = TRAIN_B,
               t: int = TRAIN_T, steps: int = TRAIN_STEPS,
               falls: bool = True, profiled: bool = True) -> dict:
    """``Trainer.run`` of ``arch`` at full width (``n_layers`` cut where
    given; whisper: ``EncDecTrainer`` over ``encdec_loss``, its frames
    ``n_audio_frames``), remat on, on ``TokenPipeline`` batches of b x t,
    AdamW(lr TRAIN_LR, warmup 2, ``steps`` total), ``steps`` steps one
    ``run`` call each (the launch counts zeroed before and read after
    each): every loss and gradient norm finite, the last loss below the
    first (where ``falls``), every kernel of ``train_counts`` launched
    twice a step — the forward and the remat recompute; the backward
    launches none — and nothing else; then (``profiled``) one step under
    the profiler (``profile_train_step``)."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline, batch_for_step
    from repro_torch.kernels import ops
    from repro_torch.models import init_encdec_params, init_params
    from repro_torch.train import AdamWConfig, TrainConfig, Trainer
    from repro_torch.train.trainer import make_loss_fn, to_device
    cfg = get_config(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if not cfg.remat:
        raise AssertionError(f"{arch}: remat is off")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=TRAIN_LR, warmup_steps=2,
                                             total_steps=steps),
                       log_every=1, checkpoint_every=10 ** 9)
    if cfg.is_encoder_decoder:
        params = init_encdec_params(cfg, seed=seed, device=dev)
        tr = EncDecTrainer(cfg, tcfg, params, dev, seed)
        loss_fn, host_batch = tr.loss_fn, tr.batch
    else:
        params = init_params(cfg, seed=seed, device=dev)
        tr = Trainer(cfg, tcfg, params, device=dev)
        loss_fn = make_loss_fn(cfg, tcfg)
        host_batch = lambda h: to_device(h, dev)         # noqa: E731
    n_params = sum(p.numel() for p in params.parameters())
    init_s = time.perf_counter() - t0
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=t, global_batch=b,
                      seed=seed)
    data = TokenPipeline(dcfg)
    hist = []
    try:
        for _ in range(steps):
            ops.reset_launch_counts()
            h = tr.run(data, 1, log_fn=lambda s: log("    " + s))[-1]
            hist.append(dict(h, launches=ops.launch_counts(forms=True)))
    finally:
        data.close()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    want = train_counts(cfg, t, cfg.n_audio_frames)
    for s in hist:
        check_launches(f"{arch} train step {s['step']}", s["launches"], want,
                       per=2)
    losses = [s["loss"] for s in hist]
    if not (all(np.isfinite(losses)) and all(
            np.isfinite(s["grad_norm"]) for s in hist)
            and (losses[-1] < losses[0] or not falls)):
        raise AssertionError(f"{arch} training: losses {losses}, grad norms "
                             f"{[s['grad_norm'] for s in hist]}")
    step_ms = float(np.median([s["dt"] for s in hist[2:]])) * 1e3
    profile = profile_train_step(
        tr, host_batch(batch_for_step(dcfg, steps)), loss_fn) if profiled \
        else None
    res = {"n_layers": cfg.n_layers, "params": n_params, "init_s": init_s,
           "batch": [b, t], "losses": losses,
           "grad_norms": [s["grad_norm"] for s in hist],
           "step_ms_all": [s["dt"] * 1e3 for s in hist],
           "step_ms": step_ms, "tok_per_s": b * t / step_ms * 1e3,
           "peak_mem_gib": peak, "launches_per_step": {
               k: 2 * v for k, v in want.items()},
           "launches": {k: sum(s["launches"][k] for s in hist)
                        for k in hist[0]["launches"]},
           "profile": {"train step": profile}}
    del tr, params
    return res


def check_train_ckpt(dev, seed) -> dict:
    """A reduced codeqwen trained 2 steps on the card, saved, restored onto
    the card: parameters and both moments bit-equal."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import init_params
    from repro_torch.train import (AdamWConfig, CheckpointManager,
                                   TrainConfig, Trainer)
    cfg = get_config("codeqwen1.5-7b", reduced=True)
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d)
        tr = Trainer(cfg, TrainConfig(optimizer=AdamWConfig(
            lr=1e-3, warmup_steps=1, total_steps=4), log_every=1000),
            init_params(cfg, seed=seed, device=dev), ckpt_manager=ck,
            device=dev)
        data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                        global_batch=4, seed=seed))
        tr.run(data, 2, log_fn=lambda s: None)
        data.close()
        named, opt, meta = ck.restore(ck.latest_step(), tr.named,
                                      tr.opt_state, device=dev)
    for k, p in tr.named.items():
        if not (named[k].device == p.device and torch.equal(named[k], p)
                and torch.equal(opt.mu[k], tr.opt_state.mu[k])
                and torch.equal(opt.nu[k], tr.opt_state.nu[k])):
            raise AssertionError(f"checkpoint restore on the card: {k} "
                                 f"differs")
    if int(opt.step) != 2 or meta["step"] != 2:
        raise AssertionError(f"checkpoint restore: step {int(opt.step)}")
    return {"arrays": 3 * len(named), "step": meta["step"]}


def train_paths(dev, seed, paths, phase: str) -> dict:
    """``train_full`` of each (arch, layers kept, batch, tokens, steps,
    the loss must fall) in ``paths``, logged; each model freed before the
    next."""
    out = {}
    for arch, n_layers, b, t, steps, falls in paths:
        label = f"{arch}{'' if n_layers is None else f' {n_layers}L'} train"
        log(f"[{phase}] {label}: full width, {steps} steps of {b} x {t} "
            f"tokens, remat on")
        t0 = time.perf_counter()
        r = out[label] = train_full(dev, seed, arch, n_layers, b, t, steps,
                                    falls)
        gc.collect()
        torch.cuda.empty_cache()
        r["wall_s"] = time.perf_counter() - t0
        p = r["profile"]["train step"]
        log(f"  {r['wall_s']:.1f}s in all; {r['params'] / 1e9:.2f} B "
            f"parameters, init {r['init_s']:.1f}s;"
            f" step {r['step_ms']:.1f} ms (median of steps 3-{steps}), "
            f"{r['tok_per_s']:.0f} trained tok/s, peak {r['peak_mem_gib']:.1f}"
            f" GiB; losses {[round(x, 4) for x in r['losses']]}; launches a "
            f"step {r['launches_per_step']}")
        log(f"  profiled step: forward {p['forward_ms']:.1f} ms, backward "
            f"{p['backward_ms']:.1f} ms, optimizer {p['optimizer_ms']:.1f} ms"
            f" (the trace summarised in {p['summary_s']:.1f}s); shares "
            + ", ".join(f"{k} {v:.1%}" for k, v in p["shares"].items()))
        log_profile(r)
    return out


def train_phase(dev, gen, timer, seed, cases: list) -> dict:
    """Phase 7: the kernels under autograd (their cases appended to
    ``cases``), the reduced card-vs-CPU backward, the full-width training
    runs and the checkpoint on the card."""
    log("[7/10] B12 and the bf16 B4 under autograd at the training shapes")
    kern = check_train_kernels(dev, gen, timer, case_recorder(cases),
                               randn_on(dev, gen))
    torch.cuda.empty_cache()
    log("[7/10] reduced loss.backward: card (kernels) vs CPU (plain)")
    reduced = check_train_reduced(dev, seed)
    paths = train_paths(dev, seed, TRAIN_PATHS, "7/8")
    log("[7/10] checkpoint save + restore on the card (reduced codeqwen)")
    ckpt = check_train_ckpt(dev, seed)
    log(f"  {ckpt['arrays']} arrays bit-equal after restore at step "
        f"{ckpt['step']}")
    return {"kernels": kern, "reduced": reduced, "paths": paths,
            "checkpoint": ckpt}


# ---------------------------------------------------------------------------
# phase 8: training the other archs (ssd_scan and the expert-batched bf16
# dual_gemm_gated under autograd too)
# ---------------------------------------------------------------------------

TRAIN_REDUCED_ARCHS = ("zamba2-2.7b", "mixtral-8x7b", "qwen2-moe-a2.7b",
                       "xlstm-350m", "llama-3.2-vision-90b", "whisper-small")
# (arch, layers kept, batch, tokens, steps, the last loss below the first):
# zamba2-2.7b, whisper-small (4 x 1500 stub frames) and xlstm-350m whole;
# mixtral-8x7b at 2 of 32 layers and qwen2-moe-a2.7b at 4 of 24 (memory: f32
# weights, gradients and two moments, 16 B a parameter, of ~3.17 B and
# ~2.59 B parameters take ~51 and ~41 GB of the card); xlstm at 4 x 256
# tokens and 4 steps, its losses reported (time: its sLSTM loop, ~7 s a
# bf16 4 x 1024 forward)
TRAIN_ARCH_PATHS = (
    ("zamba2-2.7b", None, TRAIN_B, TRAIN_T, TRAIN_STEPS, True),
    ("mixtral-8x7b", 2, TRAIN_B, TRAIN_T, TRAIN_STEPS, True),
    ("qwen2-moe-a2.7b", 4, TRAIN_B, TRAIN_T, TRAIN_STEPS, True),
    ("whisper-small", None, TRAIN_B, 448, TRAIN_STEPS, True),
    ("xlstm-350m", None, TRAIN_B, 256, 4, False))


def check_train_kernels_archs(dev, gen, timer, record, randn) -> dict:
    """ssd_scan and the expert-batched bf16 B4 under their Functions
    (``train_case``): the scan at zamba2-2.7b's training shape (its y, the
    final state unused as in training; forward within the kernel's
    tolerance of the plain version evaluated in f64, as phase 3), the
    experts at mixtral's and qwen2-moe's widths with the rows per expert a
    4 x 1024 training forward dispatches (``expert_rows``).  Bound: each
    input, output and gradient byte once; operations: the forward's and
    the backward's (twice the forward's: the scan's ``ssd_scan_work`` at
    the f32 rate; 12 E M N K at the bf16 rate).  Yardsticks: none for the
    scan (no PyTorch call computes it), two ``torch.bmm`` forward +
    backward for the experts."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.int8_gemm import (
        DUAL_BF16_ATOL, DUAL_BF16_RTOL, gated_mlp_ref, per_expert)
    from repro_torch.kernels.ssd_scan import ATOL, RTOL, ssd_scan_ref
    out_ms = {}
    b, t, h, p, n = Z_B, Z_T, Z_H, Z_P, Z_N
    ins = [randn(b, t, h, p), torch.nn.functional.softplus(randn(b, t, h)
                                                           - 1.0),
           -torch.linspace(1.0, 16.0, h, device=dev), randn(b, t, n),
           randn(b, t, n)]
    dout = randn(b, t, h, p)
    want = ssd_scan_ref(*(v.double() for v in ins))[0].float()
    _, nops = ssd_scan_work(b, t, h, p, n, Z_L)
    size = sum(v.numel() for v in ins)
    train_case(timer, record, out_ms, "ssd_scan",
               f"y B={b} T={t} H={h} P={p} N={n} L={Z_L}",
               lambda *a: ops.ssd_scan(*a)[0],
               lambda *a: ssd_scan_ref(*a)[0], None, ins, dout, (RTOL, ATOL),
               4 * 2 * (size + dout.numel()), 3 * nops, F32_OPS,
               "no PyTorch call computes the SSD scan", want=want)
    del ins, dout, want
    for label, arch, e, k, nn in EXPERT_SHAPES:
        m = expert_rows(arch, TRAIN_B * TRAIN_T)
        ins = [randn(e, m, k).to(torch.bfloat16)] + [
            randn(e, k, nn, scale=k ** -0.5).to(torch.bfloat16)
            for _ in range(2)]
        dout = randn(e, m, nn).to(torch.bfloat16)
        train_case(timer, record, out_ms, "dual_gemm_gated",
                   f"bf16 experts {label} E={e} [{m},{k}]x2[{k},{nn}] silu",
                   lambda x, u, g: ops.gated_mlp_experts(x, u, g, "silu"),
                   lambda x, u, g: per_expert(
                       lambda *a: gated_mlp_ref(*a, "silu"), x, u, g),
                   lambda x, u, g: torch.bmm(x, u) + torch.bmm(x, g), ins,
                   dout, (DUAL_BF16_RTOL, DUAL_BF16_ATOL),
                   2 * e * (2 * m * k + 4 * k * nn + 2 * m * nn),
                   12 * e * m * nn * k, BF16_OPS,
                   "two torch.bmm forward + backward, no activation: not "
                   "the same function")
        del ins, dout
    return out_ms


def train_archs_phase(dev, gen, timer, seed, cases: list) -> dict:
    """Phase 8: ssd_scan and the expert-batched bf16 B4 under autograd
    (their cases appended to ``cases``), the other archs' reduced
    card-vs-CPU backward and their full-width training runs."""
    t0 = time.perf_counter()
    log("[8/10] ssd_scan and the expert-batched bf16 B4 under autograd at "
        "the training shapes")
    kern = check_train_kernels_archs(dev, gen, timer, case_recorder(cases),
                                     randn_on(dev, gen))
    torch.cuda.empty_cache()
    log(f"[8/10] reduced backward of zamba2, mixtral, qwen2-moe, xlstm, "
        f"vision (kv_source) and whisper (encdec_loss): card (kernels) vs "
        f"CPU (plain); {time.perf_counter() - t0:.1f}s so far")
    reduced = check_train_reduced(dev, seed, TRAIN_REDUCED_ARCHS)
    log(f"  {time.perf_counter() - t0:.1f}s so far")
    paths = train_paths(dev, seed, TRAIN_ARCH_PATHS, "8/8")
    seconds = time.perf_counter() - t0
    log(f"[8/10] phase 8 in {seconds:.1f}s")
    return {"kernels": kern, "reduced": reduced, "paths": paths,
            "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 9: tensor-parallel serving (dist/tp.py), every rank on this card
# ---------------------------------------------------------------------------

def tp_settings(pressure: dict) -> tuple:
    """scripts/tp_equiv_smoke.py's settings at full width: (label,
    ServeConfig overrides, stats that must be > 0); ``pressure``: the
    pressure drain's max_seq and pool."""
    return (("dense", {}, ()),
            ("paged", dict(paged=True, page_size=PAGED_PS), ()),
            ("sampled paged", dict(paged=True, page_size=PAGED_PS,
                                   temperature=TEMPERATURE), ()),
            (f"spec_k={SPEC_K} paged pressure",
             dict(paged=True, page_size=PAGED_PS, spec_k=SPEC_K, **pressure),
             ("preemptions", "resumes", "swap_in_pages")))


# phase 5's depth: its first TP_REQ requests, whole prompts (16-256 tokens),
# TP_NEW new tokens each.  They hold 76 pages of 16 slots at once: the
# pressure drain's 64-page pool preempts and swaps
TP_REQ, TP_NEW = 8, 16
TP_PRESSURE = dict(max_seq=512, pool_pages=64)
# the long cell: TP_LONG_LANES lanes, a multiple of neither 2 nor 4, so the
# overlap boundary's pad rows run on the card (decode rows 3 -> 4), with
# prompts of TP_LONG_PROMPT tokens at max_seq 1024.  The full head count
# (3 x 32 blocks) splits a lane's cache in chunks of 352 keys, a rank's own
# (3 x 16, 3 x 8) would in 192 or 96: every context spans 3 chunks, and a
# rank that split by its own count would sum in another order
TP_LONG_LANES, TP_LONG_PROMPT = 3, (720, 1000)
# starcoder2-3b's cell: prompts cut to TP_CUT tokens, TP_SHORT_NEW new (time:
# N ranks sharing one card pay 2-5 ms a collective, 60-121 collectives a
# step), the pressure drain on a 12-page pool for 8 lanes of up to 36
TP_CUT, TP_SHORT_NEW = 32, 4
TP_PRESSURE_SHORT = dict(max_seq=128, pool_pages=12)
# one packed prefill step's logits, compared with tp 1's: 8 lanes x the
# prompts' first TP_STEP_T tokens
TP_STEP_T = 16
# codeqwen1.5-7b W4A8's TP cells serve 8 of its 32 layers (time: whole, they
# took ~435 s on an H100 host whose gloo all-gather of a decode row block
# takes 2-6 ms, scripts/tp_transport_probe.py; every layer has the same
# shapes, so 8 run every sharded launch the 32 do)
TP_LAYERS = 8
# the cells: the model (``layers``: a depth cut), the tp values, whether
# tokens and logits must equal tp 1's (every cell: bf16 too, its float
# linears on bf16_gemm, whose sums keep one order at any M or N: ROADMAP
# C20), the requests ("deep", "long" or "short"), ServeConfig overrides,
# the settings, the boundaries and whether a packed step's logits are
# compared.  NCCL refuses two ranks on one card, so the ranks share it over
# gloo (each collective staged through host buffers)
TP_CELLS = (
    dict(name=f"codeqwen1.5-7b-{TP_LAYERS}L w4a8", arch="codeqwen1.5-7b",
         precision="w4a8", layers=TP_LAYERS, tps=(2, 4), exact=True,
         requests="deep", settings=tp_settings(TP_PRESSURE)),
    dict(name=f"codeqwen1.5-7b-{TP_LAYERS}L w4a8 long", arch="codeqwen1.5-7b",
         precision="w4a8", layers=TP_LAYERS, tps=(2, 4), exact=True,
         requests="long", scfg=dict(batch_lanes=TP_LONG_LANES),
         settings=tp_settings(TP_PRESSURE)[:2], boundaries=("overlap",),
         step=False),
    dict(name="starcoder2-3b w8a8", arch="starcoder2-3b", precision="w8a8",
         tps=(2,), exact=True, requests="short",
         settings=tp_settings(TP_PRESSURE_SHORT)),
    dict(name="codeqwen1.5-7b bf16", arch="codeqwen1.5-7b", precision="bf16",
         tps=(2,), exact=True, requests="deep",
         settings=tp_settings(TP_PRESSURE)[:1]))
TP_KEEP = ("generated_tokens", "steps", "wall_s", "generated_tok_per_s",
           "peak_mem_gib", "launches", "metrics", "forwards_by_bucket")


def tp_config(cell: dict):
    """A cell's model config, cut to its ``layers`` where it has them."""
    from repro_torch.configs import get_config
    cfg = get_config(cell["arch"], precision=cell["precision"])
    if cell.get("layers"):
        cfg = dataclasses.replace(cfg, n_layers=cell["layers"])
    return cfg


def tp_requests(cfg, seed, kind: str) -> list:
    """A cell's (prompt, max_new) requests (``TP_CELLS``)."""
    if kind == "deep":
        return dense_requests(cfg, seed, TP_REQ, TP_NEW)
    if kind == "short":
        return [(p[:TP_CUT], TP_SHORT_NEW)
                for p, _ in dense_requests(cfg, seed, TP_REQ, TP_NEW)]
    rng = np.random.default_rng(seed + 1)
    return [(rng.integers(2, cfg.vocab_size, size=int(rng.integers(
        *TP_LONG_PROMPT))).tolist(), TP_NEW) for _ in range(TP_LONG_LANES)]


def tp_must(precision: str, paged: bool) -> tuple:
    """The kernels a TP drain must launch (in every rank)."""
    must = {"w4a8": COMMON + ("int4_gemm", "dual_int4_gemm_gated"),
            "w8a8": COMMON,
            "bf16": ("quantize_rows", "int8_kv_decode_attention",
                     "dual_gemm_gated", "bf16_gemm")}[precision]
    if paged:
        must = tuple(k for k in must if k != "int8_kv_decode_attention") + (
            "paged_decode_attention",)
    # (the kernels of the tree driven: an older tree, compared in turns by
    # scripts/bf16_walls.py, predates bf16_gemm)
    from repro_torch.kernels import ops
    return tuple(k for k in must if k in ops.KERNELS)


def forward_digests(engine) -> list:
    """Wrap ``engine._forward`` to keep, for every forward of a drain, a
    digest of the logits it returns for the lanes it ran: tp N's are held
    against tp 1's forward by forward."""
    seen, fwd = [], engine._forward

    def rec(tok, pos, last_idx, mask, *a):
        lg = fwd(tok, pos, last_idx, mask, *a)
        seen.append(digest(lg[torch.from_numpy(mask).to(lg.device)]))
        return lg
    engine._forward = rec
    return seen


def tp_drain(params, cfg, dev, cell: dict, kw: dict, mesh=None,
             **tp) -> tuple[dict, dict, list]:
    """One drain of a cell's requests under ``kw`` (``tp``: the TP fields
    of the ServeConfig), as phase 5's are (launches zeroed just before,
    read just after; every kernel of the path must launch).  Returns the
    result, the tokens and the forwards' logit digests."""
    from repro_torch.serve import ServeConfig, ServingEngine
    eng = ServingEngine(params, cfg, ServeConfig(
        **{**SCFG, **cell.get("scfg", {}), **kw}, seed=cell["seed"], **tp),
        device=dev, mesh=mesh)
    seen = forward_digests(eng)
    res, tok = timed_drain(eng, [cell["reqs"]], dev, cfg, tp_must(
        cfg.precision, kw.get("paged", False)))
    return res, tok, seen


def tp_step_logits(params, cfg, dev, requests, mesh=None, **tp) -> np.ndarray:
    """Each lane's last-row logits (8, V) of one packed prefill step on a
    fresh dense engine (``tp``: its TP fields): lane l feeds request l's
    first ``TP_STEP_T`` tokens."""
    from repro_torch.serve import ServeConfig, ServingEngine
    engine = ServingEngine(params, cfg, ServeConfig(**SCFG, **tp),
                           device=dev, mesh=mesh)
    tok = np.array([p[:TP_STEP_T] for p, _ in
                    requests[:engine.scfg.batch_lanes]], np.int32)
    pos = np.tile(np.arange(TP_STEP_T, dtype=np.int32), (len(tok), 1))
    lg = engine._forward(tok, pos, np.full(len(tok), TP_STEP_T - 1),
                         np.ones(len(tok), bool), True, 1)
    return lg[:, 0].float().cpu().numpy()


def tp_cell(rank: int, tp: int, mesh, dev, seed: int, cell: dict) -> dict:
    """One cell on one rank: its shard built and quantized a block at a
    time, then every setting at each of the cell's boundaries
    (``tp_drain``).  Returns the drains' numbers, tokens and logit digests,
    what ``tp_overlap="auto"`` resolves to and a step's logits."""
    from repro_torch.models import init_params
    from repro_torch.serve import ServeConfig, ServingEngine
    cfg = tp_config(cell)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device=dev,
                         precision=cell["precision"], shard=(rank, tp))
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0,
           "after_init_gib": torch.cuda.memory_allocated(dev) / 2 ** 30}
    for boundary in cell.get("boundaries", ("barrier", "overlap")):
        for label, kw, _ in cell["settings"]:
            res, tok, seen = tp_drain(params, cfg, dev, cell, kw, mesh=mesh,
                                      tp=tp, tp_overlap=boundary)
            out[f"{boundary} {label}"] = {
                "tokens": tok, "digests": seen,
                **{k: res[k] for k in TP_KEEP}}
    out["auto"] = ServingEngine(params, cfg, ServeConfig(**SCFG, tp=tp),
                                device=dev, mesh=mesh).tp_overlap_resolved
    if cell.get("step", True):
        out["logits"] = {b: tp_step_logits(params, cfg, dev, cell["reqs"],
                                           mesh=mesh, tp=tp, tp_overlap=b)
                         for b in ("barrier", "overlap")}
    return out


def tp_rank(rank: int, port: int, device: str, tp: int, seed: int,
            cells: list) -> dict:
    """One rank of a gloo TP group on ``device`` (a spawned process): every
    cell of ``cells`` in turn (``tp_cell``), each model freed before the
    next.  Returns the cells' results by name."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # a rank's host work is one thread's; the card's ranks share the cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // tp))
    from repro_torch.launch.mesh import make_tp_mesh
    dev = torch.device(device)
    torch.cuda.set_device(dev)
    mesh = make_tp_mesh(tp, "gloo", rank=rank, port=port, device=dev)
    out = {}
    for cell in cells:
        out[cell["name"]] = tp_cell(rank, tp, mesh, dev, seed, cell)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def differ_at(got: list, want: list) -> tuple[int, int | None]:
    """(forwards whose logit digests differ, the first of them) of two
    drains' ``forward_digests``; a different count differs throughout."""
    if len(got) != len(want):
        return max(len(got), len(want)), 0
    bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    return len(bad), (bad[0] if bad else None)


def tp_compare(tp: int, cell: dict, got: list, out: dict,
               logits: dict) -> None:
    """Hold the ranks' results ``got`` of one cell against tp 1's (in
    ``cell``) and each other, log them, and record them in ``out`` (drains)
    and ``logits``."""
    name, exact = cell["name"], cell["exact"]
    log(f"  {name} tp {tp}: each rank built its shard in "
        f"{max(g['init_s'] for g in got):.1f}s, "
        f"{max(g['after_init_gib'] for g in got):.1f} GiB; "
        f"tp_overlap='auto' resolves to {got[0]['auto']}")
    for boundary in cell.get("boundaries", ("barrier", "overlap")):
        if "logits" in cell:
            w = cell["logits"]
            mine = [g["logits"][boundary] for g in got]
            n = max(int((x != w).sum()) for x in mine)
            d = max(float(np.abs(x - w).max()) for x in mine)
            logits[f"{name} tp{tp} {boundary}"] = {
                "differ": n, "max_abs": d, "of": w.size}
            log(f"  tp {tp} {boundary} step logits: {n} of {w.size} differ "
                f"from tp 1's (max |d| {d:.4g})")
            if exact and n:
                raise AssertionError(f"{name} tp {tp} {boundary}: a step's "
                                     f"logits differ from tp 1's")
        for label, _, require in cell["settings"]:
            key = f"{boundary} {label}"
            drains = [g[key] for g in got]
            c = drains[0]
            across = max(count_diff(x["tokens"], c["tokens"]) for x in drains)
            across += max(differ_at(x["digests"], c["digests"])[0]
                          for x in drains)
            differ = count_diff(c["tokens"], cell["tp1"][label]["tokens"])
            fwd, first = differ_at(c["digests"], cell["tp1"][label]["digests"])
            low = [s for s in require if c["metrics"][s] <= 0]
            rec = {k: v for k, v in c.items() if k not in ("tokens",
                                                           "digests")}
            rec.update(tokens_differ=differ, ranks_differ=across,
                       forwards=len(c["digests"]), forwards_differ=fwd,
                       first_forward_apart=first,
                       compared_with=f"the tp 1 {label} drain",
                       equal_required=exact, boundary=boundary,
                       auto=got[0]["auto"],
                       peak_gib_a_rank=max(x["peak_mem_gib"] for x in drains),
                       rank_init_s=[g["init_s"] for g in got],
                       tp1=out[f"{name} tp1 {label}"]["generated_tok_per_s"])
            out[f"{name} tp{tp} {key}"] = rec
            m = c["metrics"]
            log(f"  tp {tp} {key}: {differ} of {c['generated_tokens']} "
                f"generated tokens and {fwd} of {len(c['digests'])} "
                f"forwards' logits differ from tp 1 ({across} across "
                f"ranks); {c['generated_tok_per_s']:.1f} tok/s, TPOT p50 "
                f"{m['tpot_p50_ms']:.2f} ms ({tp} ranks sharing one card), "
                f"{c['steps']} steps in {c['wall_s']:.1f}s, peak "
                f"{rec['peak_gib_a_rank']:.1f} GiB a rank"
                + (f"; preempt {m['preemptions']} swap "
                   f"{m['swap_out_pages']}/{m['swap_in_pages']} spec "
                   f"{m['spec_accepted']}/{m['spec_drafted']}"
                   if require else ""))
            if across or low or (exact and (differ or fwd)):
                raise AssertionError(
                    f"{name} tp {tp} {key}: {differ} tokens and {fwd} "
                    f"forwards differ from tp 1, {across} across ranks, "
                    f"{low} = 0")


def serve_tp(dev, seed) -> dict:
    """Phase 9: each cell of ``TP_CELLS`` served at tp 1 in this process,
    then, for each tp, one group of tp ranks spawned on this card
    (``launch.mesh.run_ranks``, gloo) serving every cell of that tp in turn:
    the cell's settings at its boundaries.  Every rank's tokens and
    forwards' logits must equal rank 0's and, where the cell says so, tp
    1's (0 differences); the pressure drains
    must preempt, resume and swap at tp 1 and at tp N; one packed step's
    logits must equal tp 1's in those cells.  Returns {"drains": every
    drain by cell, "step_logits": the logits differences}."""
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import init_params
    out, logits, cells = {}, {}, []
    for spec in TP_CELLS:
        cell = dict(spec)
        name, precision = cell["name"], cell["precision"]
        cfg = tp_config(cell)
        cell["reqs"] = tp_requests(cfg, seed, cell["requests"])
        cell["seed"] = seed
        params = init_params(cfg, seed=seed, device=dev, precision=precision)
        cell["tp1"] = {}
        for label, kw, require in cell["settings"]:
            res, tok, seen = tp_drain(params, cfg, dev, cell, kw)
            low = [s for s in require if res["metrics"][s] <= 0]
            if low:
                raise AssertionError(f"{name} tp 1 {label}: {low} = 0")
            cell["tp1"][label] = {"tokens": tok, "digests": seen}
            out[f"{name} tp1 {label}"] = res
            log(f"  {name} tp 1 {label}: {res['generated_tok_per_s']:.1f} "
                f"tok/s, TPOT p50 {res['metrics']['tpot_p50_ms']:.2f} ms, "
                f"{res['steps']} steps in {res['wall_s']:.1f}s, peak "
                f"{res['peak_mem_gib']:.1f} GiB")
        if cell.get("step", True):
            cell["logits"] = tp_step_logits(params, cfg, dev, cell["reqs"])
        cells.append(cell)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    for tp in sorted({tp for c in cells for tp in c["tps"]}):
        mine = [c for c in cells if tp in c["tps"]]
        t0 = time.perf_counter()
        ranks = run_ranks(tp_rank, tp, str(dev), tp, seed, [
            {k: v for k, v in c.items() if k not in ("tp1", "logits")}
            for c in mine])
        log(f"  tp {tp}: {tp} ranks served {len(mine)} cells in "
            f"{time.perf_counter() - t0:.1f}s")
        for cell in mine:
            tp_compare(tp, cell, [r[cell["name"]] for r in ranks], out,
                       logits)
    return {"drains": out, "step_logits": logits}


# launch/dryrun.py's GPipe cell on this card: (stages, microbatches) of 8
# tanh layers at d_model 512, microbatches of 4 (the reference's cell)
PIPELINE_CELLS = ((4, 8),)


def dist_cells(dev) -> dict:
    """Phase 9's cells of ``launch/dryrun.py`` with every rank on this card
    (gloo, each transfer staged through host buffers): ``pipeline_apply``
    over ``PIPELINE_CELLS`` (every rank's outputs ``torch.equal`` to its own
    unpipelined stack of the same layers on the card, a microbatch at a
    time, and to rank 0's), then ``run_tp_serve_cell`` at the overlap
    boundary (every summing collective refused in the ranks, all-to-alls
    and all-gathers counted, the ranks' tokens equal)."""
    from repro_torch.launch import dryrun
    out = {}
    for stages, micro in PIPELINE_CELLS:
        t0 = time.perf_counter()
        rec = dryrun.run_pipeline_cell(stages, micro, device=str(dev))
        if not rec["ranks_equal_unpipelined"] or set(rec["devices"]) != {
                str(dev)}:
            raise AssertionError(f"pipeline {stages} stages: {rec}")
        rec["wall_s"] = time.perf_counter() - t0
        out[f"pipeline {stages}x{micro}"] = rec
        log(f"  GPipe {stages} stages x {micro} microbatches on "
            f"{rec['devices']}: every rank torch.equal to the unpipelined "
            f"stack, bubble {rec['bubble_fraction']:.4f}, "
            f"{rec['wall_s']:.1f}s")
    t0 = time.perf_counter()
    rec = dryrun.run_tp_serve_cell("overlap", device=str(dev))
    rec["wall_s"] = time.perf_counter() - t0
    out["tp_serve overlap"] = rec
    log(f"  dry-run tp-serve tp 2 overlap on {rec['devices']}: collectives "
        f"{rec['collective_counts']}, {rec['wall_s']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# phase 10: the NX-CGRA fabric model (core/), its payloads on the card
# ---------------------------------------------------------------------------

# the kernels the six Table II payloads run (sftmx's phases are torch ops;
# int_softmax computes its function on its inputs) and their sources
CGRA_KERNELS = ("int8_gemm", "int8_conv2d", "requantize_i32", "int_gelu",
                "int_layernorm", "int_softmax")
CGRA_SOURCES = ("int8_gemm", "int8_conv2d", "requantize", "int_gelu",
                "int_layernorm", "int_softmax")
# the paper's Table VI metrics of ``KernelMetrics`` (benchmarks/cgra_tables.py)
CGRA_FIELDS = ("mops", "gops_mm2", "tops_w", "tops_w_mm2")


def cgra_run(device) -> dict:
    """Each Table II kernel of ``core.BUILDERS`` built on ``device`` (its
    payloads there: the CUDA kernels on the card, their plain versions on
    the CPU), scheduled and simulated: name -> (KernelInstance, the inputs,
    SimResult, KernelMetrics, functional pass's host seconds)."""
    from repro_torch.core import (BUILDERS, Simulator, StaticScheduler,
                                  metrics_from_sim)
    out = {}
    for name, builder in BUILDERS.items():
        ki = builder(device=device)
        env_in = dict(ki.env)
        prog = StaticScheduler().schedule(ki.tasks, name=name,
                                          context_phases=ki.context_phases)
        t0 = time.perf_counter()
        res = Simulator().run(prog, ki.env)
        if device != "cpu":
            torch.cuda.synchronize()
        out[name] = (ki, env_in, res, metrics_from_sim(name, res,
                                                       ki.useful_ops),
                     time.perf_counter() - t0)
    return out


def cgra_phase(dev, smi: str) -> dict:
    """Phase 10: the six Table II kernels of the fabric model built on the
    CPU (plain versions) and on the card (the payloads through int8_gemm's
    requant epilogue, int8_conv2d, requantize_i32, int_gelu and
    int_layernorm; counts zeroed just before, read just after, int_softmax
    run once on the softmax kernel's inputs inside the same window), each
    scheduled and simulated: every payload output ``torch.equal`` to the
    CPU's, int_softmax's output equal to the softmax payload's, cycles,
    segment cycles, op histogram, core busy, energy and every
    ``KernelMetrics`` field equal (``==``).  Prints Tables VI, V and II
    with ``benchmarks/cgra_tables.py``'s arithmetic (written out here):
    outputs of the simulated 22 nm, 200 MHz fabric, not card measurements.
    The wall is the card's."""
    from repro_torch.configs.edge_models import EDGE_MODELS
    from repro_torch.core import PAPER_TABLE_VI, area_table
    from repro_torch.core.kernel_library import SFTMX_SCALE
    from repro_torch.kernels import ops
    t_all = time.perf_counter()
    cpu = cgra_run("cpu")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    card = cgra_run(dev)
    s_in = card["sftmx"][1]
    b13 = ops.softmax_i8(s_in["scores"], SFTMX_SCALE, s_in["mask"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts(forms=True)
    low = [k for k in CGRA_KERNELS if k != "int_softmax" and launches[k] <= 0]
    if low or launches["int_softmax"] != 1:
        raise AssertionError(f"cgra: launches {launches}: {low} never ran, "
                             f"or int_softmax not once")
    if not torch.equal(b13.to(torch.int32), card["sftmx"][2].env["out"]):
        raise AssertionError("cgra sftmx: int_softmax's output differs from "
                             "the softmax payload's")
    rows = {}
    for name in cpu:
        ki_c, _, res_c, m_c, _ = cpu[name]
        _, _, res_g, m_g, secs = card[name]
        for key, v in res_c.env.items():
            g = res_g.env[key]
            same_v = (torch.equal(g.cpu(), v) if isinstance(v, torch.Tensor)
                      else g == v)
            if not same_v:
                raise AssertionError(f"cgra {name}: env[{key!r}] on the card "
                                     f"differs from the CPU's")
        for f in ("cycles", "context_cycles", "segment_cycles", "energy_j",
                  "op_hist", "core_busy"):
            if getattr(res_g, f) != getattr(res_c, f):
                raise AssertionError(f"cgra {name}: {f} differs from the "
                                     f"CPU's")
        if dataclasses.astuple(m_g) != dataclasses.astuple(m_c):
            raise AssertionError(f"cgra {name}: metrics differ from the CPU's")
        rows[name] = {"cycles": res_g.cycles, "exec_cycles": m_g.exec_cycles,
                      "energy_j": res_g.energy_j,
                      "power_mw": m_g.power_mw, "utilization": m_g.utilization,
                      **{f: getattr(m_g, f) for f in CGRA_FIELDS},
                      "paper": dict(zip(CGRA_FIELDS, PAPER_TABLE_VI[name])),
                      "card_functional_s": secs,
                      "out_shape": list(res_g.env[ki_c.out_key].shape)}
    log(f"  {len(rows)} kernels: payload outputs, cycles, energy and metrics "
        f"equal on the card and the CPU; launches "
        f"{ {k: launches[k] for k in CGRA_KERNELS} }; card wall {wall:.3f}s "
        f"on {smi}")
    log("  Table VI (simulated 22 nm FD-SOI fabric at 200 MHz, the model's "
        "outputs, not card measurements): ours vs the paper")
    log(f"  {'kernel':7s} {'MOPS':>8s} {'paper':>7s} {'ratio':>6s} "
        f"{'GOPS/mm2':>9s} {'paper':>7s} {'TOPS/W':>7s} {'paper':>6s} "
        f"{'TW/mm2':>7s} {'paper':>6s}")
    for name, r in rows.items():
        p = PAPER_TABLE_VI[name]
        log(f"  {name:7s} {r['mops']:8.0f} {p[0]:7.0f} {r['mops'] / p[0]:6.2f} "
            f"{r['gops_mm2']:9.2f} {p[1]:7.2f} {r['tops_w']:7.3f} {p[2]:6.2f} "
            f"{r['tops_w_mm2']:7.2f} {p[3]:6.2f}")
    log("  Table V: area breakdown (um^2)")
    for comp, um2, pct in area_table():
        log(f"  {comp:18s} {um2:10,.0f}  {pct:5.2f}%")
    eff = {}
    for model, comp in EDGE_MODELS.items():
        share = {k: v / 100.0 for k, v in comp.items() if v > 0}
        denom = sum(s / rows[k]["mops"] for k, s in share.items())
        eff[model] = sum(share.values()) / denom if denom else 0.0
    log("  Table II: kernel composition x simulated kernel throughput, "
        "effective MOPS: " + ", ".join(f"{k} {v:.0f}" for k, v in eff.items()))
    return {"kernels": rows, "table_ii_eff_mops": eff,
            "table_v": [list(r) for r in area_table()], "wall_s": wall,
            "phase_s": time.perf_counter() - t_all,
            "launches": launches, "card": smi}


# ---------------------------------------------------------------------------
# the autotune phase: kernels/autotune.py's measured cache on the card
# ---------------------------------------------------------------------------

# two served shapes a family — a decode step's 8 rows and the no-cache
# forward's 4096 — as (family, label, K, N, W4 group): codeqwen1.5-7b's
# down projection and gated MLP, its q projection for bf16_gemm
AUTOTUNE_GEMMS = (("gemm_blocks", "codeqwen mlp_down", 13440, 4096, 0),
                  ("gated_mlp_blocks int8", "codeqwen gate+up", 4096, 13440,
                   0),
                  ("gated_mlp_blocks bf16", "codeqwen gate+up", 4096, 13440,
                   0),
                  ("gemm_w4a8_blocks", "codeqwen mlp_down", 13440, 4096, 64),
                  ("gatedmlp_w4a8_blocks", "codeqwen gate+up", 4096, 13440,
                   64),
                  ("bf16_gemm_blocks", "codeqwen q", 4096, 4096, 0))
AUTOTUNE_ROWS = (8, 4096)
# the decode split at codeqwen1.5-7b's heads (G = 1) and starcoder2-3b's
# (G = 12): 8 lanes of 1024 slots, D = 128; rows launches of 64, tp 2
AUTOTUNE_DECODE = (("codeqwen", 32, 32), ("starcoder", 24, 2))
AUTOTUNE_ROWS_T, AUTOTUNE_TP = 64, 2
AUTOTUNE_SOURCES = ("int8_gemm", "int4_gemm", "dual_gemm_gated",
                    "dual_int4_gemm_gated", "bf16_gemm",
                    "int8_kv_decode_attention", "paged_decode_attention",
                    "quantize")


class forcing:
    """Within the block, ``autotune.<name>`` returns ``value`` whatever it is
    asked: a launch takes that tiling (the gate and the timer of each
    candidate)."""

    def __init__(self, at, name: str, value):
        self.at, self.name, self.value = at, name, value

    def __enter__(self):
        self.saved = getattr(self.at, self.name)
        setattr(self.at, self.name, lambda *a, **k: self.value)

    def __exit__(self, *exc):
        setattr(self.at, self.name, self.saved)


def _autotune_gemm(at, family, k, n, g, m, randn, n_sm):
    """(chooser, key, candidates, run(tiling) -> out) of one GEMM family at
    [m, k] x [k, n]."""
    from repro_torch.kernels import bf16_gemm as bg
    from repro_torch.kernels import ops
    from repro_torch.kernels.quantize import quantize_rows_ref
    from repro_torch.models.layers import (SILU_INT_SCALE, quantize_weight,
                                           quantize_weight_w4)
    bf = torch.bfloat16
    x_q, x_s = quantize_rows_ref(randn(m, k))
    name = family.split()[0]                 # the chooser a launch asks
    if family == "bf16_gemm_blocks":
        x, w = randn(m, k).to(bf), randn(k, n, scale=k ** -0.5).to(bf)
        return (lambda: at.bf16_gemm_blocks(m, k, n, n_sm),
                at.bf16_gemm_key(m, k, n, n_sm),
                at.bf16_gemm_candidates(m, k, n),
                lambda t: bg._launch(x, w, None, t))
    if family == "gemm_blocks":
        wd = quantize_weight(randn(k, n, scale=k ** -0.5))
        kind, streams, key = "w8", 1, at.mma_key("gemm", m, k, n, "int8",
                                                 n_sm)
        choose = lambda: at.gemm_blocks(m, k, n, n_sm)
        fn = lambda: ops.gemm_w8a8(x_q, x_s, wd["w_q"], wd["scale"])
    elif family == "gemm_w4a8_blocks":
        wd = quantize_weight_w4(randn(k, n, scale=k ** -0.5), group=g)
        kind, streams = "w4", 1
        key = at.mma_key("gemm_w4a8", m, k, n, f"g{g}", n_sm)
        choose = lambda: at.gemm_w4a8_blocks(m, k, n, g, n_sm)
        fn = lambda: ops.gemm_w4a8(x_q, x_s, wd["w4"], wd["qmul"],
                                   wd["scale"])
    elif family == "gatedmlp_w4a8_blocks":
        up, gate = (quantize_weight_w4(randn(k, n, scale=k ** -0.5), group=g)
                    for _ in range(2))
        kind, streams = "w4", 2
        key = at.mma_key("gatedmlp_w4a8", m, k, n, f"g{g}", n_sm)
        choose = lambda: at.gatedmlp_w4a8_blocks(m, k, n, g, n_sm)
        fn = lambda: ops.gated_mlp_w4a8(
            x_q, x_s, up["w4"], up["qmul"], up["scale"], gate["w4"],
            gate["qmul"], gate["scale"], act="silu",
            act_scale=SILU_INT_SCALE)
    elif family == "gated_mlp_blocks int8":
        up, gate = (quantize_weight(randn(k, n, scale=k ** -0.5))
                    for _ in range(2))
        kind, streams = "w8", 2
        key = at.mma_key("gatedmlp", m, k, n, "int8", n_sm)
        choose = lambda: at.gated_mlp_blocks(m, k, n, "int8", n_sm)
        fn = lambda: ops.gated_mlp_w8a8(
            x_q, x_s, up["w_q"], up["scale"], gate["w_q"], gate["scale"],
            act="silu", act_scale=SILU_INT_SCALE)
    else:
        x = randn(m, k).to(bf)
        wu, wg = (randn(k, n, scale=k ** -0.5).to(bf) for _ in range(2))
        kind, streams = "bf16", 2
        key = at.mma_key("gatedmlp", m, k, n, "bf16", n_sm)
        choose = lambda: at.gated_mlp_blocks(m, k, n, "bf16", n_sm)
        fn = lambda: ops.gated_mlp(x, wu, wg)

    def run(t):
        with forcing(at, name, t):
            return fn()
    return (choose, key, at.mma_candidates(kind, streams, m, k, n, n_sm, g),
            run)


def _decode_gate(at, ops, cand, q, qr, qp_rows, dense, paged, hq, hkv,
                 what):
    """Under ``cand`` (None: the chooser's), the decode forms agree: every
    row of a T = 64 launch equals a T = 1 launch at its position, the paged
    kernel over the same keys equals the dense one, and each tp rank's
    head shard (its split sized for the full Hkv) equals its slice of the
    unsharded launch.  Returns the T = 1 output."""
    def go():
        one = ops.decode_attention_int8kv(q, *dense)
        rows = ops.decode_attention_int8kv_rows(qr, *dense[:-1], qp_rows)
        for i in range(qr.shape[1]):
            same("int8_kv_decode_attention", f"{what} row {i}", rows[:, i],
                 ops.decode_attention_int8kv(qr[:, i].contiguous(),
                                             *dense[:-1],
                                             qp_rows[:, i].contiguous()))
        same("paged_decode_attention", f"{what} paged vs dense",
             ops.paged_attention_decode(q, *paged), one)
        gq, gk = hq // AUTOTUNE_TP, hkv // AUTOTUNE_TP
        k_q, k_s, v_q, v_s, pos, qpos = dense
        for r in range(AUTOTUNE_TP):
            hs, ks = slice(r * gq, (r + 1) * gq), slice(r * gk, (r + 1) * gk)
            part = ops.decode_attention_int8kv_rows(
                q[:, None, hs].contiguous(), k_q[:, :, ks].contiguous(),
                k_s[:, :, ks].contiguous(), v_q[:, :, ks].contiguous(),
                v_s[:, :, ks].contiguous(), pos, qpos[:, None].contiguous(),
                split_hkv=hkv)[:, 0]
            same("int8_kv_decode_attention", f"{what} tp rank {r}", part,
                 one[:, hs])
        return one
    if cand is None:
        return go()
    with forcing(at, "decode_blocks", cand):
        return go()


def autotune_phase(dev, gen, timer, randn) -> dict:
    """``autotune.measure`` on the card into a temporary cache (never the
    repo's ``.autotune/``): for each family at ``AUTOTUNE_GEMMS`` x
    ``AUTOTUNE_ROWS`` (the decode split at ``AUTOTUNE_DECODE``), every
    candidate held to the gates — the integer forms ``torch.equal`` to the
    table's launch, the bf16 forms too and with K never split, and under
    each decode split the rows, paged and tp forms equal to the T = 1
    dense launch — then timed (CUDA events, cold L2), the fastest recorded,
    a fresh lookup (the cache re-read from its file) returning it, and each
    family's measured choice and time printed beside the table's.  The
    cache is dropped and the environment restored after."""
    import shutil
    import tempfile

    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import ops
    from repro_torch.models.attention import _quant_kv
    t0 = time.perf_counter()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    saved = os.environ.get("REPRO_AUTOTUNE_CACHE")
    tmp = tempfile.mkdtemp(prefix="autotune-")
    os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(tmp, "measured.json")
    at.reset_measured_cache()
    out = {}

    def report(label, table, best, table_us, best_us, n_cands):
        out[label] = {"table": list(table), "table_us": table_us,
                      "measured": list(best), "measured_us": best_us,
                      "candidates": n_cands}
        log(f"  autotune {label}: table {tuple(table)} {table_us:.1f} us, "
            f"measured {tuple(best)} {best_us:.1f} us ({n_cands} "
            f"candidates)")
    try:
        for family, label, k, n, g in AUTOTUNE_GEMMS:
            for m in AUTOTUNE_ROWS:
                choose, key, cands, run = _autotune_gemm(
                    at, family, k, n, g, m, randn, n_sm)
                table = choose()
                want = run(table)
                width = 4
                for c in cands:
                    if "bf16" in family and c.k_len != k:
                        raise AssertionError(f"{family}: a candidate splits "
                                             f"K ({c})")
                    same(family, f"{label} [{m},{k}]x[{k},{n}] {tuple(c)}",
                         run(c), want)
                by = {tuple(c)[:width]: c for c in cands}
                us = {}

                def time_us(blocks):
                    us[blocks] = timer(lambda: run(by[blocks]), iters=5) * 1e3
                    return us[blocks]
                best = at.measure(key, list(by), time_us)
                at.reset_measured_cache()
                if tuple(choose())[:width] != best:
                    raise AssertionError(f"{family} [{m},{k}]x[{k},{n}]: a "
                                         f"fresh lookup does not return the "
                                         f"measured {best}")
                report(f"{family} {label} [{m},{k}]x[{k},{n}]"
                       + (f" g{g}" if g else ""), tuple(table)[:width], best,
                       us[tuple(table)[:width]], us[best], len(cands))
                del want
                torch.cuda.empty_cache()
        b, s, d, ps = 8, 1024, 128, PAGED_PS
        for label, hq, hkv in AUTOTUNE_DECODE:
            k_q, k_s = _quant_kv(randn(b, s, hkv, d))
            v_q, v_s = _quant_kv(randn(b, s, hkv, d))
            fill = torch.randint(AUTOTUNE_ROWS_T, s + 1, (b,), generator=gen,
                                 device=dev)
            slot = torch.arange(s, device=dev)
            pos = torch.where(slot[None] < fill[:, None], slot[None],
                              -1).to(torch.int32)
            qpos = (fill - 1).to(torch.int32)
            dense = (k_q, k_s, v_q, v_s, pos, qpos)
            # the same keys in pages: lane l's page j is page l * mp + j + 1
            mp = s // ps
            pt = (torch.arange(b * mp, device=dev, dtype=torch.int32)
                  .reshape(b, mp) + 1)

            def pages(a):
                return torch.cat([torch.zeros_like(a[:1, :ps]),
                                  a.reshape(b * mp, ps, *a.shape[2:])])
            ppos = torch.cat([torch.full((1, ps), -1, dtype=torch.int32,
                                         device=dev), pos.reshape(b * mp, ps)])
            paged = tuple(x.contiguous() for x in (
                pages(k_q), pages(k_s), pages(v_q), pages(v_s), ppos, pt,
                qpos))
            q = randn(b, hq, d).to(torch.bfloat16)
            qp_rows = (qpos[:, None] - torch.arange(
                AUTOTUNE_ROWS_T - 1, -1, -1, device=dev,
                dtype=torch.int32)[None]).contiguous()
            qr = randn(b, AUTOTUNE_ROWS_T, hq, d).to(torch.bfloat16)
            what = f"decode {label} B={b} S={s} Hq={hq} Hkv={hkv}"
            g_ = hq // hkv
            key = at.decode_key(b * hkv, s, d, g_, n_sm)
            cands = at.decode_candidates(b * hkv, s, n_sm)
            table = at.decode_blocks(b * hkv, s, d, g_, n_sm)
            for c in cands:
                _decode_gate(at, ops, c, q, qr, qp_rows, dense, paged, hq,
                             hkv, f"{what} split {c}")
            us = {}

            def time_us(c):
                with forcing(at, "decode_blocks", c):
                    us[c] = timer(lambda: ops.decode_attention_int8kv(
                        q, *dense), iters=5) * 1e3
                return us[c]
            best = at.measure(key, cands, time_us)
            at.reset_measured_cache()
            if at.decode_blocks(b * hkv, s, d, g_, n_sm) != best:
                raise AssertionError(f"{what}: a fresh lookup does not "
                                     f"return the measured {best}")
            # the measured entry, read by every form through the chooser
            _decode_gate(at, ops, None, q, qr, qp_rows, dense, paged, hq, hkv,
                         f"{what} measured split {best}")
            report(what, table, best, us[table], us[best], len(cands))
    finally:
        if saved is None:
            os.environ.pop("REPRO_AUTOTUNE_CACHE", None)
        else:
            os.environ["REPRO_AUTOTUNE_CACHE"] = saved
        at.reset_measured_cache()
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    log(f"  autotune phase: {wall:.1f} s")
    return {"families": out, "wall_s": wall}


PROFILED_KERNELS = ("int4_gemm", "flash_attention", "dual_gemm_gated",
                    "dual_int4_gemm_gated", "int8_gemm",
                    "int8_kv_decode_attention", "paged_decode_attention",
                    "quantize_rows", "int_layernorm", "int8_flash_attention",
                    "ssd_scan", "bf16_gemm")
PROFILED_NAMES = {"int8_flash_attention": "int8_attention_",
                  "ssd_scan": "ssd_scan_"}
# the host's CUDA runtime calls that wait for the card (a pageable copy is
# ``cudaMemcpyAsync`` then ``cudaStreamSynchronize``)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


def profile_summary(prof, wall_ms: float) -> dict:
    """Device ms by kernel name, the device's busy share of ``wall_ms``, the
    device ms of each of ``PROFILED_KERNELS``, the count of device kernels
    (every kernel, PyTorch's own too; copies and fills not counted) and the
    host's synchronizing runtime calls (``SYNC_CALLS``).  Read from the
    trace's raw events (``kineto_results``, an attribute torch does not
    document: its absence raises): ``key_averages`` first builds a Python
    event tree, ~0.2 ms an event on the card's host (77 s for an xlstm
    training step's 404k kernels), and sums the same durations by name
    (``profile_step`` holds the two parsers equal on each trace it
    takes)."""
    raw = getattr(prof.profiler, "kineto_results", None)
    if raw is None:
        raise RuntimeError(f"torch {torch.__version__}'s profiler has no "
                           f"kineto_results: profile_summary cannot read "
                           f"the trace's raw events")
    by_name = collections.defaultdict(float)
    kernels = syncs = 0
    for e in raw.events():
        name = e.name()
        if "CUDA" not in str(e.device_type()):
            syncs += name in SYNC_CALLS
            continue                     # host ops: their kernels are listed
        if not name.startswith(("Memcpy", "Memset")):
            kernels += 1
        by_name[name] += e.duration_ns() / 1e6
    by_name = {k: v for k, v in by_name.items() if v > 0}
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "busy_share": busy / wall_ms if wall_ms else 0.0,
            "device_kernels": kernels, "sync_calls": syncs,
            "top_kernels_ms": dict(top),
            "kernel_ms": {k: sum(v for name, v in by_name.items()
                                 if PROFILED_NAMES.get(k, f"{k}_kernel")
                                 in name)
                          for k in PROFILED_KERNELS}}


def key_averages_summary(prof) -> dict:
    """``profile_summary``'s counts read through ``key_averages`` (torch's
    public parser): device kernels, synchronizing calls, busy ms and the
    device ms of each of ``PROFILED_KERNELS``."""
    by_name = collections.defaultdict(float)
    kernels = syncs = 0
    for e in prof.key_averages():
        if "CUDA" not in str(e.device_type):
            syncs += e.count if e.key in SYNC_CALLS else 0
            continue
        if not e.key.startswith(("Memcpy", "Memset")):
            kernels += e.count
        by_name[e.key] += e.self_device_time_total / 1e3
    return {"device_kernels": kernels, "sync_calls": syncs,
            "device_busy_ms": sum(by_name.values()),
            "kernel_ms": {k: sum(v for name, v in by_name.items()
                                 if PROFILED_NAMES.get(k, f"{k}_kernel")
                                 in name)
                          for k in PROFILED_KERNELS}}


def parsers_agree(prof, res: dict) -> dict:
    """``key_averages_summary`` of the trace ``res`` was read from: the same
    kernel and synchronizing-call counts, busy ms and kernel ms within
    1e-6 relative (1e-6 ms absolute), else raises."""
    ka = key_averages_summary(prof)
    pairs = [(ka["device_busy_ms"], res["device_busy_ms"])] + [
        (ka["kernel_ms"][k], res["kernel_ms"][k]) for k in PROFILED_KERNELS]
    if not (ka["device_kernels"] == res["device_kernels"]
            and ka["sync_calls"] == res["sync_calls"]
            and all(abs(a - b) <= 1e-6 * abs(a) + 1e-6 for a, b in pairs)):
        raise AssertionError(f"the trace's raw events ({res['device_kernels']}"
                             f" kernels, {res['sync_calls']} syncs, "
                             f"{res['device_busy_ms']} ms) differ from "
                             f"key_averages ({ka['device_kernels']}, "
                             f"{ka['sync_calls']}, {ka['device_busy_ms']})")
    return ka


def log_drain(d: dict) -> None:
    m = d["metrics"]
    log(f"  {d['requests']} requests, {d['generated_tokens']} generated + "
        f"{d['prompt_tokens']} prompt tokens fed (of {d['prompt_len_sum']}) in "
        f"{d['wall_s']:.2f}s: {d['generated_tok_per_s']:.1f} generated tok/s, "
        f"{d['processed_tok_per_s']:.1f} processed tok/s, {d['steps']} steps, "
        f"buckets {d['forwards_by_bucket']}, TPOT p50/p99 "
        f"{m['tpot_p50_ms']:.2f}/{m['tpot_p99_ms']:.2f} ms, TTFT p50/p99 "
        f"{m['ttft_p50_ms']:.1f}/{m['ttft_p99_ms']:.1f} ms, peak "
        f"{d['peak_mem_gib']:.1f} GiB")
    log(f"  launches on the path: {d['launches']}")
    log(f"  {d['summary']}")


def log_extra(d: dict) -> None:
    """The lines the engine's newer drains add to ``log_drain``'s."""
    if "tokens_differ" in d:
        log(f"    {d['tokens_differ']} generated tokens differ from "
            f"{d['compared_with']} (required 0)")
    m = d["metrics"]
    if m["spec_drafted"]:
        log(f"    speculation: {m['spec_accepted']} of {m['spec_drafted']} "
            f"drafts accepted ({m['spec_accept_rate']:.1%}), verify buckets "
            f"{d['forwards_by_bucket']}, multi-row launches {d['multi_row']}")
    for key in ("per_forward", "warmup_s", "offsets_s", "init_ptq_s"):
        if key in d:
            log(f"    {key}: {d[key]}")


def log_profile(d: dict) -> None:
    for name, p in d.get("profile", {}).items():
        log(f"  profile {name}: wall {p['wall_ms']:.2f} ms, "
            f"device busy {p['device_busy_ms']:.2f} ms "
            f"({p['busy_share']:.1%}), {p.get('device_kernels')} device "
            f"kernels, {p.get('sync_calls')} synchronizing calls; "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in
                        p.get("kernel_ms", {}).items() if v)
            + "; top " + ", ".join(f"{k[:40]}={v:.2f}" for k, v in
                                   list(p["top_kernels_ms"].items())[:4]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the detailed results to this JSON file")
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the source tree of the port to drive (default: "
                    "this checkout's; another tree is compared with it)")
    ap.add_argument("--serve-only", action="store_true",
                    help="build, then only the dense starcoder2-3b w8a8 and "
                    "codeqwen1.5-7b w4a8 drains with bucket-1/64/256 "
                    "profiles and a bucket-256 prefill's cache attention "
                    "(serve_only); prints their summary and no ok line")
    ap.add_argument("--cal-only", action="store_true",
                    help="build, then only codeqwen1.5-7b's and zamba2-2.7b's "
                    "calibrate_ptq, timed and then profiled (cal_only); "
                    "prints their summary and no ok line")
    ap.add_argument("--lm-only", action="store_true",
                    help="build, then only codeqwen1.5-7b's and "
                    "starcoder2-3b's W8A8 lm_loss, timed and profiled "
                    "(lm_only); prints their summary and no ok line")
    ap.add_argument("--xlstm-only", action="store_true",
                    help="build, then only xlstm-350m's tokenwise W8A8 drains "
                    "and its lm_loss at bf16/w8a8/w4a8 (xlstm_only); prints "
                    "their walls and no ok line")
    ap.add_argument("--train-only", action="store_true",
                    help="build only flash_attention, dual_gemm_gated and "
                    "ssd_scan, then run only phases 7 and 8 (training; "
                    "train_phase, train_archs_phase); prints their summary "
                    "and no ok line")
    ap.add_argument("--tp-only", action="store_true",
                    help="build, then only phase 3's tensor-parallel "
                    "launches (check_tp_shapes) and phase 9 (serve_tp: "
                    "the TP drains, ranks spawned on this card); prints "
                    "their summary and no ok line")
    ap.add_argument("--cgra-only", action="store_true",
                    help="build only int8_gemm, int8_conv2d, requantize_i32, "
                    "int_gelu, int_layernorm and int_softmax, then run only "
                    "phase 10 (the NX-CGRA fabric model, cgra_phase); "
                    "prints its tables and no ok line")
    ap.add_argument("--autotune-only", action="store_true",
                    help="build only the GEMMs and the decode kernels, then "
                    "run only the autotune phase (autotune_phase: the "
                    "measured cache on the card, in a temporary file); "
                    "prints each family's choices and no ok line")
    ap.add_argument("--kernels", default=None,
                    help="comma-separated kernels among "
                    f"{', '.join(KERNEL_CASES)}: build only these from --src "
                    "and run only their phase 3 cases, held against the plain "
                    "versions and timed; prints the cases and no ok line")
    args = ap.parse_args()
    only = args.kernels.split(",") if args.kernels else None
    if only and not set(only) <= set(KERNEL_CASES):
        ap.error(f"--kernels takes {', '.join(KERNEL_CASES)}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — the port's kernels run only on the "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    # f32 matmuls and convolutions of the plain versions in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[1/10] card: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    built = build.build_all(*([sorted({src for name in only
                                       for src in KERNEL_CASES[name][1]})]
                               if only else [train_kernels()] if args.train_only
                               else [CGRA_SOURCES] if args.cgra_only
                               else [AUTOTUNE_SOURCES] if args.autotune_only
                               else []))
    log(f"[2/10] built {len(built)} kernels in {time.perf_counter() - t0:.1f}s")
    for name, info in sorted(built.items()):
        regs = [ln.strip() for ln in info["ptxas"].splitlines()
                if "registers" in ln or "Compiling entry" in ln
                or "spill" in ln]
        log(f"  {name}: {info['seconds']:.1f}s; " + " | ".join(regs))

    if args.cgra_only:
        log("[10/10] the NX-CGRA fabric model: the six Table II kernels on the "
            "card and the CPU")
        res = cgra_phase(dev, smi)
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps({"card": smi, "cgra": res},
                                           indent=1))
        print(json.dumps({"cgra_only": {
            name: {f: r[f] for f in ("cycles", "energy_j") + CGRA_FIELDS}
            for name, r in res["kernels"].items()},
            "table_ii_eff_mops": res["table_ii_eff_mops"],
            "launches": {k: res["launches"][k] for k in CGRA_KERNELS},
            "wall_s": res["wall_s"]}))
        print(smi)
        return 0

    if args.autotune_only:
        log("[3/10] autotune: the measured cache on the card")
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        res = autotune_phase(dev, gen, Timer(dev), randn_on(dev, gen))
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps({"card": smi, "autotune": res},
                                           indent=1))
        print(json.dumps({"autotune_only": {
            label: {k: r[k] for k in ("table", "table_us", "measured",
                                      "measured_us")}
            for label, r in res["families"].items()},
            "wall_s": res["wall_s"]}))
        print(smi)
        return 0

    if args.train_only:
        cases, timer = [], Timer(dev)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        res = train_phase(dev, gen, timer, args.seed, cases)
        res8 = train_archs_phase(dev, gen, timer, args.seed, cases)
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps({"card": smi, "cases": cases,
                                            "train": res,
                                            "train_archs": res8}, indent=1))
        print(json.dumps({"train_only": {
            label: {k: r[k] for k in ("step_ms", "tok_per_s", "peak_mem_gib",
                                      "losses")}
            for label, r in {**res["paths"], **res8["paths"]}.items()},
            "kernels": {**res["kernels"], **res8["kernels"]}}))
        print(smi)
        return 0

    if only:
        log(f"[3/10] {', '.join(only)} vs plain versions on the card "
            f"({args.src})")
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        cases, timer = [], Timer(dev)
        for name in only:
            KERNEL_CASES[name][0](dev, gen, timer,
                                  case_recorder(cases, digests=True),
                                  randn_on(dev, gen))
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps({"card": smi, "src": str(
                args.src), "cases": cases}, indent=1))
        print(json.dumps({"src": str(args.src), "cases": {
            f"{c['kernel']} {c['shape']}": c["ms"] for c in cases},
            "sha1": {f"{c['kernel']} {c['shape']}": c["sha1"]
                     for c in cases if "sha1" in c}}))
        print(smi)
        return 0

    if args.tp_only:
        log("[3/10] tensor-parallel launches vs the unsharded launch and the "
            "plain versions")
        cases, timer = [], Timer(dev)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        check_tp_shapes(dev, gen, timer, case_recorder(cases),
                        randn_on(dev, gen))
        torch.cuda.empty_cache()
        log("[9/10] tensor-parallel serving: ranks spawned on this card")
        res = serve_tp(dev, args.seed)
        res["dist_cells"] = dist_cells(dev)
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps({"card": smi, "cases": cases,
                                            "serve_tp": res}, indent=1))
        print(json.dumps({"tp_only": {
            label: {k: r[k] for k in ("tokens_differ", "ranks_differ",
                                      "generated_tok_per_s", "tp1",
                                      "peak_gib_a_rank")}
            for label, r in res["drains"].items() if "ranks_differ" in r},
            "step_logits": res["step_logits"],
            "pipeline": {k: r["ranks_equal_unpipelined"]
                         for k, r in res["dist_cells"].items()
                         if k.startswith("pipeline")},
            "cases": {f"{c['kernel']} {c['shape']}": c["ms"]
                      for c in cases}}))
        print(smi)
        return 0

    if args.serve_only:
        res = serve_only(dev, args.seed)
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps({"card": smi, "src": str(
                args.src), "serve": res}, indent=1))
        print(json.dumps({"serve_only": {
            label: ({k: r["metrics"][k] for k in ("ttft_p50_ms", "tpot_p50_ms")}
                    | {"tok_s": r["generated_tok_per_s"],
                       "bucket1_launches": sum(
                           r["launches_per_decode_step"].values()),
                       "bucket1_syncs": r["syncs_per_decode_step"],
                       "bucket1_device_kernels":
                           r["profile"]["bucket1"]["device_kernels"],
                       "profile": {k: (v["wall_ms"], v["device_busy_ms"],
                                       v["device_kernels"], v["sync_calls"])
                                   for k, v in r["profile"].items()}}
                    if "metrics" in r else r)
            for label, r in res.items()}}))
        print(smi)
        return 0

    if args.lm_only:
        res = lm_only(dev, args.seed)
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps({"card": smi, "src": str(
                args.src), "no_cache": res}, indent=1))
        print(json.dumps({"lm_only": {
            label: {"wall_s": r["wall_s"], "loss": r["loss"], "profile": {
                k: (v["wall_ms"], v["device_busy_ms"], v["kernel_ms"])
                for k, v in r.get("profile", {}).items()}}
            for label, r in res.items()}}))
        print(smi)
        return 0

    if args.xlstm_only:
        res = xlstm_only(dev, args.seed)
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps({"card": smi, "src": str(
                args.src), "xlstm": res}, indent=1))
        print(json.dumps({"xlstm_only": {
            label: ({"tpot_p50_ms": r["metrics"]["tpot_p50_ms"],
                     "tok_s": r["generated_tok_per_s"], "wall_s": r["wall_s"]}
                    if "metrics" in r else {"wall_s": r["wall_s"],
                                            "loss": r["loss"]})
            for label, r in res.items()}}))
        print(smi)
        return 0

    if args.cal_only:
        res = cal_only(dev, args.seed)
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps({"card": smi, "src": str(
                args.src), "calibrate": res}, indent=1))
        print(json.dumps({"cal_only": {
            label: {"wall_s": r["wall_s"], "profile": {
                k: (v["wall_ms"], v["device_busy_ms"], v["kernel_ms"])
                for k, v in r["profile"].items()}}
            for label, r in res.items()}}))
        print(smi)
        return 0

    log("[3/10] kernels vs plain versions on the card")
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    cases = check_kernels(dev, gen, Timer(dev))
    torch.cuda.empty_cache()
    log(f"[3/10] phase 3 in {time.perf_counter() - t_phase:.1f}s")
    log("[3/10] autotune: the measured cache on the card (a temporary file)")
    tuned = autotune_phase(dev, gen, Timer(dev), randn_on(dev, gen))
    t_phase = time.perf_counter()

    worst = {}
    for arch, precision, must in REDUCED_PATHS:
        log(f"[4/10] {arch}-reduced {precision} int8-KV: CPU plain (and in "
            f"the card's order, seeds {args.seed}..{args.seed + SEEDS - 1}) "
            f"vs CUDA kernels")
        for k in range(SEEDS):
            worst[f"{arch} {precision} seed {args.seed + k}"] = check_reduced(
                dev, args.seed + k, arch, precision, must, main=k == 0)
    log("[4/10] zamba2-2.7b-reduced w8a8 int8-KV forward with states "
        "(prefill through ssd_scan and the multi-row decode form, then "
        "t = 1 steps): CPU plain vs CUDA kernels")
    for k in range(SEEDS):
        worst[f"zamba2-2.7b w8a8 states seed {args.seed + k}"] = (
            check_reduced_states(dev, args.seed + k, main=k == 0))
    log("[4/10] xlstm-350m-reduced w8a8: no-cache forward, then forward with "
        "states (t = 1 steps): CPU plain vs CUDA kernels")
    for k in range(SEEDS):
        for key, v in check_xlstm_reduced(dev, args.seed + k).items():
            worst[f"xlstm-350m w8a8 {key} seed {args.seed + k}"] = v
    log("[4/10] whisper-small-reduced w8a8: encode, cross states, decoder "
        "steps and encdec_forward: CPU plain (card order) vs CUDA kernels")
    for k in range(SEEDS):
        for key, v in check_whisper_reduced(dev, args.seed + k).items():
            worst[f"whisper-small w8a8 {key} seed {args.seed + k}"] = v
    for precision in ("w4a8", "w8a8"):
        log(f"[4/10] llama-3.2-vision-90b-reduced {precision} (gates "
            f"{XATTN_GATES}): cross states, steps and the no-cache forward "
            f"with kv_source: CPU plain (card order) vs CUDA kernels")
        for k in range(SEEDS):
            for key, v in check_vision_reduced(dev, args.seed + k,
                                               precision).items():
                worst[f"{VISION} {precision} {key} seed {args.seed + k}"] = v
    log("[4/10] codeqwen1.5-7b-reduced w4a8 paged int8 arena: CPU plain vs "
        "CUDA kernels, paged vs dense on the card")
    worst["codeqwen1.5-7b w4a8 paged"] = check_reduced_paged(dev, args.seed)
    for arch, precision in REDUCED_NO_CACHE:
        log(f"[4/10] {arch}-reduced {precision} no-cache forward: CPU plain vs "
            f"CUDA kernels")
        worst[f"{arch} {precision} no-cache"] = check_reduced_no_cache(
            dev, args.seed, arch, precision)
    for arch, act in REDUCED_MIXED:
        log(f"[4/10] {arch}-reduced w8a8 over float weights (integer norms, "
            f"attention and {act}) no-cache forward: CPU plain vs CUDA "
            f"kernels")
        worst[f"{arch} w8a8-float no-cache"] = check_reduced_no_cache(
            dev, args.seed, arch, "w8a8", act)

    log(f"[4/10] phase 4 in {time.perf_counter() - t_phase:.1f}s")
    t_phase = time.perf_counter()
    served = {}
    for (label, arch, precision, n_req, max_new, profiled, must,
         paged) in SERVE_PATHS:
        log(f"[5/10] serve full-width {label} int8-KV: {n_req} requests x "
            f"{max_new} new tokens" + (", then three paged drains" if paged
                                       else ""))
        srv = served[label] = serve_full(dev, args.seed, arch, precision, n_req,
                                         max_new, profiled, must, paged,
                                         extras=True)
        gc.collect()                  # free this model before the next
        torch.cuda.empty_cache()
        log_drain(srv)
        log(f"  init+PTQ {srv['init_ptq_s']:.1f}s, {srv['after_ptq_gib']:.1f} "
            f"GiB after PTQ")
        per = srv["launches_per_decode_step"]
        syncs = srv["syncs_per_decode_step"]
        log(f"  launches per bucket-1 step: {sum(per.values())} {per}; "
            f"{sum(syncs.values())} synchronizing calls {dict(syncs)}")
        # each quantization once: B1 before o_proj and down and for the k
        # and v writes, the fused norm twice a layer and once at the end
        n_layers = get_config(arch, precision=precision).n_layers
        want = {"quantize_rows": 4 * n_layers,
                "int_layernorm": 2 * n_layers + 1}
        if any(per[k] != v for k, v in want.items()):
            raise AssertionError(f"{label}: a bucket-1 step launched "
                                 f"{ {k: per[k] for k in want} }, not {want}")
        log_profile(srv)
        for name, drain in srv.pop("paged", {}).items():
            # each paged drain is a path of its own in the kernels line
            served[f"{PAGED_LABEL} {name}"] = drain
            log(f"  paged drain {name}:")
            log_drain(drain)
            log(f"    {drain['tokens_differ']} generated tokens differ from "
                f"{drain['compared_with']}"
                + (" (required 0)" if drain.get("equal_required") else ""))
            log(f"    pages held bit for bit on the card: "
                f"{drain['checked_pages']}")
            if "launches_per_decode_step" in drain:
                per = drain["launches_per_decode_step"]
                dense = srv["launches_per_decode_step"]
                log(f"    launches per bucket-1 step: paged "
                    f"{sum(per.values())} {per} | dense {sum(dense.values())}"
                    f"; {sum(drain['syncs_per_decode_step'].values())} "
                    f"synchronizing calls")
            log_profile(drain)
            if "reference" in drain:
                log("    reference run:")
                log_drain(drain["reference"])
        for name, drain in srv.pop("extra", {}).items():
            served[f"{label} {name}"] = drain
            log(f"  {name} drain:")
            log_drain(drain)
            log_extra(drain)
        if "sampler" in srv:
            sm = srv["sampler"]
            log(f"  sampler at {sm['shape']} (temperature {TEMPERATURE}): "
                f"{sm['ms']:.4f} ms device (greedy argmax {sm['greedy_ms']:.4f}"
                f"), {sm['device_kernels']} device kernels a step "
                f"({sm['device_busy_ms']:.4f} ms busy of {sm['wall_ms']:.2f} "
                f"ms wall), key fold {sm['keys_host_ms']:.3f} ms host; "
                f"{sm['draws_compared']} draws equal to the CPU's")

    log(f"[5/10] serve full-width zamba2-2.7b w8a8 int8-KV tokenwise: "
        f"{ZAMBA_REQ} requests x {ZAMBA_NEW} new tokens together, "
        f"{ZAMBA_ALONE} of them one at a time")
    for name, drain in serve_zamba2(dev, args.seed).items():
        served[f"zamba2-2.7b w8a8 {name}"] = drain
        log(f"  {name} drain:")
        log_drain(drain)
        log_extra(drain)
        log_profile(drain)
    gc.collect()
    torch.cuda.empty_cache()
    log("[5/10] zamba2-2.7b-reduced w8a8 served tokenwise: card vs the CPU "
        "in the card's order")
    zred = serve_zamba2_reduced(dev, args.seed)
    log(f"  {zred['steps_compared']} steps compared, worst "
        f"{zred['worst_rel']:.3g} of the range (limit {STATES_TOL:g}); "
        f"near-tie at step {zred['near_tie_at_step']}; "
        f"{zred['tokens_differ']} tokens differ")

    no_cache = {}
    for arch, precision in MOE_PATHS:
        log(f"[5/10] serve full-width {arch} {precision} int8-KV (built and "
            f"quantized a block at a time): {MOE_REQ} requests x {MOE_NEW} "
            f"new tokens" + (", then paged, then one request of "
                             f"{LONG_PROMPT} tokens on the ring, unwrapped "
                             f"and paged" if arch == "mixtral-8x7b" else ""))
        res = serve_moe(dev, args.seed, arch, precision)
        dense = res["dense"]
        log(f"  init+PTQ {dense['init_ptq_s']:.1f}s, "
            f"{dense['after_ptq_gib']:.1f} GiB after, peak "
            f"{dense['init_peak_gib']:.1f} GiB while building")
        for name, drain in res.items():
            if name == "lm_loss":
                continue
            label = f"{arch} {precision}" + ("" if name == "dense"
                                             else f" {name}")
            served[label] = drain
            log(f"  {name} drain:")
            log_drain(drain)
            if "vs_unwrapped" in drain:
                log(f"    vs the unwrapped cache: {drain['vs_unwrapped']}")
            if "tokens_differ" in drain:
                log(f"    {drain['tokens_differ']} tokens differ from "
                    f"{drain['compared_with']}")
            log_profile(drain)
        per = dense["launches_per_decode_step"]
        log(f"  launches per bucket-1 step: "
            f"{sum(per[k] for k in ops.KERNELS)} {per}; "
            f"{sum(dense['syncs_per_decode_step'].values())} synchronizing "
            f"calls")
        lm = no_cache[f"{arch} {precision} lm_loss"] = res["lm_loss"]
        log(f"[6/10] full-width {arch} {precision} lm_loss on {MOE_SCORE_B} x "
            f"{MOE_SCORE_T} tokens: {lm['loss']:.4f} in {lm['wall_s']:.2f}s "
            f"({lm['tok_per_s']:.0f} tok/s), peak {lm['peak_mem_gib']:.1f} "
            f"GiB, {lm['rows_per_expert']} rows per expert; launches "
            f"{lm['launches']}")
        log_profile(lm)
    for arch, precision, paged in GQA_PATHS:
        log(f"[5/10] serve full-width {arch} {precision} int8-KV (built and "
            f"quantized a block at a time): {GQA_REQ} requests x {GQA_NEW} "
            f"new tokens" + (", then paged" if paged else ""))
        res = serve_gqa(dev, args.seed, arch, precision, paged)
        dense = res["dense"]
        log(f"  init+PTQ {dense['init_ptq_s']:.1f}s, "
            f"{dense['after_ptq_gib']:.1f} GiB after, peak "
            f"{dense['init_peak_gib']:.1f} GiB while building")
        for name in ("dense", "paged"):
            if name not in res:
                continue
            drain = served[f"{arch} {precision}" + (
                "" if name == "dense" else " paged")] = res[name]
            log(f"  {name} drain:")
            log_drain(drain)
            log_extra(drain)
            per = drain["launches_per_decode_step"]
            log(f"  launches per bucket-1 step: "
                f"{sum(per[k] for k in ops.KERNELS)} {per}; "
                f"{sum(drain['syncs_per_decode_step'].values())} "
                f"synchronizing calls")
            log_profile(drain)
        lm = no_cache[f"{arch} {precision} lm_loss"] = res["lm_loss"]
        log(f"[6/10] full-width {arch} {precision} lm_loss on {SCORE_B} x "
            f"{SCORE_T} tokens: {lm['loss']:.4f} in {lm['wall_s']:.2f}s "
            f"({lm['tok_per_s']:.0f} tok/s), peak {lm['peak_mem_gib']:.1f} "
            f"GiB; launches {lm['launches']}")
        log_profile(lm)
    log(f"[5/10] serve full-width xlstm-350m w8a8 tokenwise: {XLSTM_REQ} "
        f"requests x {XLSTM_NEW} new tokens together, {XLSTM_ALONE} of them "
        f"one at a time in lane 0")
    for name, drain in serve_xlstm(dev, args.seed).items():
        served[f"xlstm-350m w8a8 {name}"] = drain
        log(f"  {name} drain:")
        log_drain(drain)
        log_extra(drain)
        log_profile(drain)
    log(f"[6/10] full-width xlstm-350m lm_loss on {SCORE_B} x {SCORE_T} "
        f"tokens at bf16, w8a8 and w4a8")
    for label, lm in xlstm_loss(dev, args.seed).items():
        no_cache[label] = lm
        log(f"  {label}: {lm['loss']:.4f} in {lm['wall_s']:.2f}s "
            f"({lm['tok_per_s']:.0f} tok/s), peak {lm['peak_mem_gib']:.1f} "
            f"GiB; launches {lm['launches']}")
        log_profile(lm)
    log(f"[5/10] serve full-width {WHISPER} w8a8 int8-KV: encode 8 clips, "
        f"then {XATTN_REQ} requests x {XATTN_NEW} new tokens with kv_source, "
        f"then again on the reused lanes")
    for name, drain in serve_whisper(dev, args.seed).items():
        served[f"{WHISPER} w8a8" + ("" if name == "dense" else f" {name}")] = (
            drain)
        log(f"  {name} drain:")
        log_drain(drain)
        log_extra(drain)
        if "launches_per_decode_step" in drain:
            per = drain["launches_per_decode_step"]
            log(f"  encode {drain['encode_s']:.3f}s; launches per bucket-1 "
                f"step: {sum(per[k] for k in ops.KERNELS)} {per}")
        log_profile(drain)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[6/10] full-width {WHISPER} encdec_loss on {SCORE_B} x (1500 frames, "
        f"{WH_SCORE_T} tokens) at bf16 and w8a8")
    for label, lm in whisper_loss(dev, args.seed).items():
        no_cache[label] = lm
        log(f"  {label}: {lm['loss']:.4f} in {lm['wall_s']:.2f}s, peak "
            f"{lm['peak_mem_gib']:.1f} GiB; launches {lm['launches']}")
        log_profile(lm)
    log(f"[5/10] serve full-width {VISION} w4a8 int8-KV (built and quantized "
        f"a block at a time): cross K/V of 8 lanes' vision tokens, "
        f"{XATTN_REQ} requests x {XATTN_NEW} new tokens")
    res = serve_vision(dev, args.seed)
    drain = served[f"{VISION} w4a8"] = res["dense"]
    log(f"  init+PTQ {drain['init_ptq_s']:.1f}s, {drain['after_ptq_gib']:.1f} "
        f"GiB after, peak {drain['init_peak_gib']:.1f} GiB while building; "
        f"cross K/V {drain['cross_kv_s']:.3f}s")
    log_drain(drain)
    log_extra(drain)
    per = drain["launches_per_decode_step"]
    log(f"  launches per bucket-1 step: {sum(per[k] for k in ops.KERNELS)} "
        f"{per}; {sum(drain['syncs_per_decode_step'].values())} "
        f"synchronizing calls")
    log_profile(drain)
    lm = no_cache[f"{VISION} w4a8 lm_loss"] = res["lm_loss"]
    log(f"[6/10] full-width {VISION} w4a8 lm_loss with kv_source on {SCORE_B} "
        f"x {SCORE_T} tokens: {lm['loss']:.4f} in {lm['wall_s']:.2f}s "
        f"({lm['tok_per_s']:.0f} tok/s), peak {lm['peak_mem_gib']:.1f} GiB; "
        f"launches {lm['launches']}")
    log_profile(lm)
    for arch, precisions, calibrated, long_w8a8 in NO_CACHE_PATHS:
        log(f"[6/10] full-width {arch} no-cache forward: lm_loss on {NC_B} x "
            f"{NC_T} tokens at {', '.join(precisions)}"
            + (", after calibrate_ptq" if calibrated else ""))
        no_cache.update(no_cache_full(dev, args.seed, arch, precisions,
                                      calibrated, long_w8a8))
    log("[6/10] the integer library's entry points (Table II shapes) and "
        "the ViT-B/16 patch embed")
    no_cache["integer library"] = int_library_entry(dev, args.seed)
    log(f"  launches {no_cache['integer library']['launches']}; patch embed "
        f"{no_cache['integer library']['patch_embed_shape']} equal to the "
        f"CPU's")
    log("[6/10] ops.softmax_i8 on causal score rows")
    no_cache["ops.softmax_i8"] = softmax_entry(dev, args.seed)
    log(f"  launches {no_cache['ops.softmax_i8']['launches']}, row sums "
        f"{no_cache['ops.softmax_i8']['row_sum_range']}")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[6/10] phases 5 and 6 in {time.perf_counter() - t_phase:.1f}s")
    t_phase = time.perf_counter()
    train = train_phase(dev, gen, Timer(dev), args.seed, cases)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[7/10] phase 7 in {time.perf_counter() - t_phase:.1f}s")
    train8 = train_archs_phase(dev, gen, Timer(dev), args.seed, cases)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[9/10] tensor-parallel serving (codeqwen1.5-7b-{TP_LAYERS}L w4a8 at "
        f"tp 2 and 4, also on {TP_LONG_LANES} long lanes, starcoder2-3b w8a8 "
        f"at tp 2, codeqwen1.5-7b bf16 at tp 2): ranks spawned on this card, "
        f"gloo")
    t_tp = time.perf_counter()
    tp_served = serve_tp(dev, args.seed)
    log("[9/10] launch/dryrun.py's GPipe and tp-serve cells on this card")
    tp_served["dist_cells"] = dist_cells(dev)
    log(f"[9/10] phase 9 in {time.perf_counter() - t_tp:.1f}s")
    log("[10/10] the NX-CGRA fabric model: the six Table II kernels on the "
        "card and the CPU")
    cgra = cgra_phase(dev, smi)

    # the M = 8 (decode) case of each kernel at the shape each path gives it;
    # a kernel's headline is the slice's main path (codeqwen1.5-7b w4a8) where
    # it runs there, else the path that runs it
    sc, cq4, cq8 = (label for label, *_ in SERVE_PATHS)
    cq4p = f"{PAGED_LABEL} same-schedule"
    headline_by_path = {
        sc: {"quantize_rows": "[8,3072] bf16",
             "int8_gemm": "mlp_up+gelu [8,3072]x[3072,12288] scaled_gelu",
             "int_layernorm": "fused starcoder [8,3072] ln bf16",
             "int8_kv_decode_attention":
                 "B=8 S=1024 Hq=24 Hkv=2 D=128 window=0"},
        cq4: {"quantize_rows": "[8,4096] bf16",
              "int8_gemm":
                  "codeqwen head_f32 [8,4096]x[4096,92416] scaled",
              "int_layernorm": "fused codeqwen [8,4096] rms bf16",
              "int8_kv_decode_attention":
                  "B=8 S=1024 Hq=32 Hkv=32 D=128 window=0",
              "int4_gemm": "mlp_down [8,13440]x[13440,4096] scaled g64",
              "dual_int4_gemm_gated": "[8,4096]x2[4096,13440] silu g64"},
        cq4p: {"quantize_rows": "[8,4096] bf16",
               "int8_gemm":
                   "codeqwen head_f32 [8,4096]x[4096,92416] scaled",
               "int_layernorm": "fused codeqwen [8,4096] rms bf16",
               "int4_gemm": "mlp_down [8,13440]x[13440,4096] scaled g64",
               "dual_int4_gemm_gated": "[8,4096]x2[4096,13440] silu g64",
               "paged_decode_attention":
                   "B=8 ps=16 MP=64 Hq=32 Hkv=32 D=128 int8 window=0"},
        cq8: {"quantize_rows": "[8,4096] bf16",
              "int8_gemm": "codeqwen mlp_down [8,13440]x[13440,4096] scaled",
              "int_layernorm": "fused codeqwen [8,4096] rms bf16",
              "int8_kv_decode_attention":
                  "B=8 S=1024 Hq=32 Hkv=32 D=128 window=0",
              "dual_gemm_gated": "int8 [8,4096]x2[4096,13440] silu"},
        # the no-cache paths' attention at B = 4, T = 1024 (phase 6)
        "codeqwen1.5-7b w4a8 lm_loss": {"int8_flash_attention":
            "v_scale codeqwen B=4 T=1024 H=32 Hkv=32 D=128",
            "int4_gemm": "mlp_down [4096,13440]x[13440,4096] scaled g64",
            "dual_int4_gemm_gated": "[4096,4096]x2[4096,13440] silu g64"},
        # calibrate_ptq's 2 x 128 rows (its candidates at groups 32 to 128)
        "codeqwen1.5-7b calibrate_ptq": {
            "int4_gemm": "mlp_down [256,13440]x[13440,4096] scaled g32",
            "dual_int4_gemm_gated": "[256,4096]x2[4096,13440] silu g32"},
        "codeqwen1.5-7b w8a8 lm_loss": {"int8_flash_attention":
            "v_scale codeqwen B=4 T=1024 H=32 Hkv=32 D=128",
            "dual_gemm_gated": "int8 [4096,4096]x2[4096,13440] silu",
            "int8_gemm":
                "codeqwen q_proj+bias [4096,4096]x[4096,4096] scaled"},
        "starcoder2-3b w8a8 lm_loss": {"int8_flash_attention":
            "v_scale starcoder B=4 T=1024 H=24 Hkv=2 D=128",
            "int8_gemm": "mlp_up+gelu [4096,3072]x[3072,12288] scaled_gelu"},
        "starcoder2-3b bf16 lm_loss": {"flash_attention":
            "bf16 starcoder B=4 T=1024 H=24 Hkv=2 D=128"},
        "ops.softmax_i8": {"int_softmax": "[4096,1024] int32 causal mask"},
        # the integer-nonlinearity forwards: their activation at 4096 rows
        "codeqwen1.5-7b w8a8-float lm_loss": {
            "int_silu": "[4096,13440] int32",
            "int8_flash_attention":
                "v_scale codeqwen B=4 T=1024 H=32 Hkv=32 D=128"},
        "starcoder2-3b w8a8-float lm_loss": {
            "int_gelu": "[4096,12288] int32",
            "int8_flash_attention":
                "v_scale starcoder B=4 T=1024 H=24 Hkv=2 D=128"},
        f"codeqwen1.5-7b w8a8 lm_loss 1x{LONG_T}": {"int8_flash_attention":
            f"streaming v_scale B=1 T={LONG_T} H=32 Hkv=32 D=128",
            "dual_gemm_gated": "int8 [4096,4096]x2[4096,13440] silu"},
        # zamba2-2.7b's no-cache forwards: the scan and the shared
        # attention at head dim 80
        **{f"zamba2-2.7b {prec} lm_loss": {
            "ssd_scan": f"B={Z_B} T={Z_T} H={Z_H} P={Z_P} N={Z_N} L={Z_L}",
            **({"flash_attention": "bf16 zamba2 B=4 T=1024 H=32 Hkv=32 D=80"}
               if prec == "bf16" else {"int8_flash_attention":
                                       "v_scale zamba2 B=4 T=1024 H=32 "
                                       "Hkv=32 D=80"}),
            **({"int4_gemm": "zamba2 in_proj [4096,2560]x[2560,10448] "
                             "scaled g64"} if prec == "w4a8" else {})}
           for prec in ("bf16", "w8a8", "w4a8")},
        # the MoE paths: the expert-batched forms at decode rows (C = 4),
        # mixtral's windowed decode over the wrapped ring and the capped
        # arena
        "mixtral-8x7b w4a8": {
            "int4_gemm": "experts down mixtral E=8 [4,14336]x[14336,4096] "
                         "scaled g64",
            "dual_int4_gemm_gated":
                "experts mixtral E=8 [4,4096]x2[4096,14336] silu g64",
            "int8_kv_decode_attention":
                f"ring B={WIN_B} S={WIN_RING} Hq={WIN_HQ} Hkv={WIN_HKV} "
                f"D={WIN_D} window={WINDOW}"},
        "mixtral-8x7b w4a8 long paged": {
            "paged_decode_attention":
                f"paged B={WIN_B} ps={PAGED_PS} MP={WIN_MAX_SEQ // PAGED_PS} "
                f"Hq={WIN_HQ} Hkv={WIN_HKV} D={WIN_D} int8 window={WINDOW} "
                f"capped"},
        "qwen2-moe-a2.7b w8a8": {
            "int8_gemm": "experts down qwen2-moe E=60 [4,1408]x[1408,2048] "
                         "scaled",
            "dual_gemm_gated":
                "int8 experts qwen2-moe E=60 [4,2048]x2[2048,1408] silu"},
        # the dense GQA paths (G = 6 and 7) and xlstm's N = 8 gate
        "internlm2-20b w8a8": {
            "int8_kv_decode_attention":
                f"B=8 S=1024 Hq=48 Hkv={GQA_HKV} D={GQA_D} window=0",
            "int8_gemm":
                "internlm2 head_f32 [8,6144]x[6144,92544] scaled",
            "dual_gemm_gated": "int8 [8,6144]x2[6144,16384] silu"},
        "internlm2-20b w8a8 paged": {
            "paged_decode_attention":
                f"B=8 ps=16 MP=64 Hq=48 Hkv={GQA_HKV} D={GQA_D} int8 "
                f"window=0"},
        "yi-34b w4a8": {
            "int8_kv_decode_attention":
                f"B=8 S=1024 Hq=56 Hkv={GQA_HKV} D={GQA_D} window=0",
            "int8_gemm": "yi head_f32 [8,7168]x[7168,64000] scaled",
            "int4_gemm": "yi o_proj+residual [8,7168]x[7168,7168] "
                         "scaled_add g64",
            "dual_int4_gemm_gated": "[8,7168]x2[7168,20480] silu g64"},
        "internlm2-20b w8a8 lm_loss": {"int8_flash_attention":
            f"v_scale internlm2 B=4 T=1024 H=48 Hkv={GQA_HKV} D={GQA_D}"},
        "yi-34b w4a8 lm_loss": {"int8_flash_attention":
            f"v_scale yi B=4 T=1024 H=56 Hkv={GQA_HKV} D={GQA_D}"},
        "xlstm-350m w8a8 lm_loss": {
            "int8_gemm": "xlstm w_if [4096,2048]x[2048,8] scaled"},
        "xlstm-350m w4a8 lm_loss": {
            "int4_gemm": "xlstm w_if [4096,2048]x[2048,8] scaled g64"},
        # whisper-small (G = 1, D = 64) and llama-3.2-vision-90b (G = 8)
        f"{WHISPER} w8a8": {
            "int8_kv_decode_attention":
                f"B=8 S=1024 Hq={WH_H} Hkv={WH_H} D={WH_D} window=0",
            "int8_gemm": "whisper q/k/v/o [8,768]x[768,768] scaled",
            "int_layernorm": "fused whisper dec [8,768] ln bf16",
            "quantize_rows": "[8,768] bf16"},
        f"{WHISPER} w8a8 encdec_loss": {
            "int8_flash_attention":
                f"v_scale whisper B=4 T={WH_T} H={WH_H} Hkv={WH_H} D={WH_D}",
            "int8_gemm": f"whisper mlp_up+gelu [{WH_ENC_ROWS},768]x[768,3072]"
                         f" scaled_gelu",
            "int_layernorm": f"fused whisper enc [{WH_ENC_ROWS},768] ln f32",
            "quantize_rows": f"[{WH_ENC_ROWS},768] f32"},
        f"{WHISPER} bf16 encdec_loss": {
            "flash_attention":
                f"bf16 whisper B=4 T={WH_DEC_T} H={WH_H} Hkv={WH_H} D={WH_D}"},
        f"{VISION} w4a8": {
            "int8_kv_decode_attention":
                "B=8 S=1024 Hq=64 Hkv=8 D=128 window=0",
            "int4_gemm": f"vision cross kv [{VIS_CROSS_ROWS},{VIS_D}]x"
                         f"[{VIS_D},1024] scaled g64",
            "dual_int4_gemm_gated": f"[8,{VIS_D}]x2[{VIS_D},{VIS_FF}] silu "
                                    f"g64",
            "int8_gemm": f"vision mlp_down [8,{VIS_FF}]x[{VIS_FF},{VIS_D}] "
                         f"scaled",
            "int_layernorm": f"fused vision [8,{VIS_D}] rms bf16",
            "quantize_rows": f"[{VIS_CROSS_ROWS},{VIS_D}] f32"},
        f"{VISION} w4a8 lm_loss": {
            "int8_flash_attention": "v_scale vision B=4 T=1024 H=64 Hkv=8 "
                                    "D=128"},
        # the Table II entry points and the patch embed
        "integer library": {
            "int8_conv2d": "[32,14,14,768]x[1,1,768,768] int32",
            "int8_gemm": "[32,64]x[64,32] requant",
            "requantize_i32": "[4096,4096] int32"},
        # the bf16 float linears (bf16_gemm): the scoring forward's q
        # projection, a decode step's
        "codeqwen1.5-7b bf16 lm_loss": {
            "flash_attention": "bf16 codeqwen B=4 T=1024 H=32 Hkv=32 D=128",
            "dual_gemm_gated": "bf16 [4096,4096]x2[4096,13440] silu",
            "bf16_gemm": "codeqwen q [4096,4096]x[4096,4096]"},
        "codeqwen1.5-7b bf16 tp1 dense": {
            "bf16_gemm": "codeqwen k [8,4096]x[4096,4096]"}}
    csrc, tpu = "src/repro_torch/kernels/csrc/", "src/repro/kernels/"
    sources = {"quantize_rows": ("quantize.cu", "quantize.py:41"),
               "int8_gemm": ("int8_gemm.cu", "int8_gemm.py:127"),
               "int_layernorm": ("int_layernorm.cu", "int_layernorm.py:56"),
               "int8_kv_decode_attention": ("int8_kv_decode_attention.cu",
                                            "int8_kv_decode_attention.py:72"),
               "dual_gemm_gated": ("dual_gemm_gated.cu", "int8_gemm.py:280"),
               "int4_gemm": ("int4_gemm.cu", "int8_gemm.py:433"),
               "dual_int4_gemm_gated": ("dual_int4_gemm_gated.cu",
                                        "int8_gemm.py:568"),
               "paged_decode_attention": ("paged_decode_attention.cu",
                                          "paged_attention.py:94"),
               "int_softmax": ("int_softmax.cu", "int_softmax.py:53"),
               "int8_flash_attention": ("int8_flash_attention.cu",
                                        "int8_flash_attention.py:155"),
               "flash_attention": ("flash_attention.cu",
                                   "flash_attention.py:74"),
               "int_gelu": ("int_gelu.cu", "int_gelu.py:61"),
               "int_silu": ("int_silu.cu", "int_silu.py:48"),
               "requantize_i32": ("requantize.cu", "quantize.py:111"),
               "int8_conv2d": ("int8_conv2d.cu", "conv2d.py:51"),
               "ssd_scan": ("ssd_scan.cu", "ssd_scan.py:70"),
               "bf16_gemm": ("bf16_gemm.cu", None)}
    # the kernel the port adds beyond the TPU's replaces XLA's float dot
    added = {"bf16_gemm": "none: XLA's dot of the reference's float linear "
                          "(src/repro/models/layers.py linear)"}
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_note")

    def case(name, shape):
        return next(c for c in cases if c["kernel"] == name
                    and c["shape"] == shape)
    kernels = []
    paths = {**served, **no_cache, **train["paths"], **train8["paths"],
             **tp_served["drains"], "cgra": cgra}
    for name in ops.KERNELS:
        by_path = {label: res["launches"][name]
                   for label, res in paths.items()}
        at_path = {label: {"shape": shapes[name],
                           **{k: case(name, shapes[name])[k] for k in keys}}
                   for label, shapes in headline_by_path.items()
                   if name in shapes}
        c = at_path[cq4] if cq4 in at_path else next(iter(at_path.values()))
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + sources[name][0],
            "replaces": added.get(name) or tpu + sources[name][1],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(x["max_abs_err"] for x in cases
                               if x["kernel"] == name),
            **{k: c[k] for k in keys}, "shape": c["shape"],
            "by_path": at_path, "status": "ok"})
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({
            "card": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "build": {k: v["seconds"] for k, v in built.items()},
            "cases": cases, "reduced_worst_rel": worst, "serve": served,
            "no_cache": no_cache, "zamba2_reduced_served": zred,
            "train": train, "train_archs": train8, "serve_tp": tp_served,
            "cgra": cgra, "autotune": tuned,
            "kernels": kernels, "total_s": time.perf_counter() - t_start},
            indent=1))
    log(f"done in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
