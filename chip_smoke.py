#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: ``python3 chip_smoke.py`` from the
root of a checkout, on a machine with one NVIDIA H100.

1. Builds the eight CUDA kernels from the six sources in
   ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a (one nvcc per
   source, all started together).  ptxas must report no spills and a
   0-byte stack frame (the VM march: ``TILE_STACK``'s 32 bytes) for the
   hash encode, the four register-tiled kernels (density MLP, color MLP,
   fused field, fused march), the VM march, the volume render and the
   four flash-attention instantiations (bf16 and fp32, each at the
   head-dim bounds 128 and 256), whose registers it prints; the density,
   march and volume-render launchers must ask for the shared memory their
   wrappers reckon, and the flash-attention launcher must use the
   wrapper's tiles, shared memory, grid and key tiles at head_dim 64, 128
   and 256.
2. Runs each kernel against its plain PyTorch version on the card, at the
   main path's shapes: the hash encode, density and color MLPs and the
   fused field (both chains in one kernel, also held bit for bit against
   the density -> color kernel pair) on the Phase-I probe samples of an
   800x800 frame (25,600 rays x 192), and the fused march on the frame's
   157 blocks of 4,096 rays with budgets drawn across the whole ladder
   (plain, density-only and per-ray exit, each held on all 157 blocks),
   then once more at a ragged shape
   (blocks of 1,000 rays, group 3, budgets below the chunk, per-ray exit).
   The density MLP, color MLP, fused field and fused march must match
   their plain versions at max abs error 0 (the color chains' plain
   versions emulate fmaf; the MLPs' run in chunks of ``PLAIN_ROWS``
   rows), the march's chunk counters with them; the color MLP also on a
   ragged, unaligned slice.  The hash encode at max abs error 0, on the
   Phase-I rows and on one decoupled chunk's rows (65,536 rays x 192),
   timed as the median of ``TIME_ROUNDS`` rounds of ``TIME_REPS``
   launches with the L2 warm and after a ``FLUSH_BYTES`` flush, with the
   card's clocks and power sampled beside; the distinct 32-B sectors its
   warps' gathers touch are reckoned for its level-group mapping and the
   point-major one it replaced.
3. Renders the frame end to end at the paper's config
   (``configs/ingp_asdr.py`` CONFIG): the kernel path with
   ``march_backend="fused"`` (its launch counts are read from this run),
   the kernel field with the reference march, and the plain-torch field;
   then times the fused march alone on the frame's own blocks and budgets
   (with and without color), beside the bound of the work they needed.
   The count maps of the kernel and plain paths may differ in at most
   0.1 % of pixels, and their PSNRs against the plain fixed-192 render of
   the same view by at most 0.1 dB.
4. Renders the §4.3 decoupled frame of the same view
   (``decouple.render_decoupled`` through the kernel field, in ray
   chunks; a second run under ``torch.profiler`` gives each kernel's
   device time and the device's idle share), then composites its kept
   samples with one ``volume_render`` launch over the whole frame
   (640,000 rays x 192 samples, 96 anchors),
   held against the plain version bit for bit and against
   render_decoupled's image (rtol 1e-4 / atol 1e-5), then at the
   ``RAGGED_RENDERS`` shapes (rays off the warp, samples off the chunk,
   one anchor, group 3; also one float off 16-B alignment), bit for bit.
   Prints the PSNR and SSIM of the decoupled frame and of the naive
   half-sample frame against the fixed-192 render.
5. Runs flash attention at gemma2-27b's attention widths (B 1, S 8,192,
   32 query heads over 16 KV heads, head_dim 128) for its local layer
   (window 4096, softcap 50), its global layer (softcap 50) and the global
   layer without softcap, in fp32 against the plain version (rtol 2e-4 /
   atol 2e-5), and the local layer and the global layer without softcap
   in bf16 (rtol 1e-2 / atol 8e-3, and the error's norm at most 3e-3 of
   the output's), the bf16 bounds on the tensor cores and on the
   special-function units; times ``scaled_dot_product_attention`` on both
   no-softcap settings; then at ``RAGGED_SEQ`` tokens, head_dim 64, H / KV
   1 and 8, in both dtypes, global and windowed with the softcap.  Then
   at head_dim 256, gemma3-12b's widths (B 1, S ``WIDE_SEQ`` 4,608, 16
   query heads over 8 KV heads, no softcap): its local layer (window
   1,024) and its global layer in fp32 and in bf16, each at ``ATTN_TOL``
   with its bound and SDPA's time (a window mask for the local layer);
   then the ragged shapes at head_dim 256 (H / KV 16 / 8 and 8 / 1).  The
   kernel's JSON row is ``[lm]``'s, at the main path's shapes.

6. ``[train]``: trains the paper-width NGP (``CONFIG.model``) on the card
   with ``core/train.py: train_ngp`` on the lego scene: ``TRAIN_STEPS``
   steps of 4,096 rays x 48 samples from 24 views of 200x200, lr 5e-3 on
   the cosine schedule, autograd through the plain field; prints the
   median ms a step after the first ``TRAIN_WARM_STEPS`` (each step ends
   in a synchronize, as the loss is read every step), the loss at the
   first and last step and the peak memory, and fails unless the loss
   falls below ``TRAIN_LOSS_GATE`` of its first value with every trained
   tensor finite; runs ``TRAIN_PROFILE_STEPS`` more steps under
   ``torch.profiler`` (device time by kernel, kernels launched, idle
   share).  Then renders the trained scene at the 800x800 view:
   the analytic ground truth (512 samples), the fixed-192 frame through
   the kernel field built from the trained field (chunks of 32,768 rays)
   and the two-phase frame (kernel field, fused march), each timed on
   the host clock around a synchronised second run; prints both PSNRs
   against ground truth, the ASDR frame's against fixed-192, the gap, the
   count histogram and budgets, the samples spent (Phase II plus the
   probe) against 640,000 x 192, and the fixed-192 / ASDR time ratio
   beside the paper's software-only GPU figure (Fig. 24, AS 1.84x), and
   by count rung the share of pixels, of the ASDR frame's squared error
   and of its excess over fixed-192's.  The
   same frame on the plain field may differ from the kernel path's in at
   most 0.1 % of count-map pixels and 0.1 dB of PSNR against ground
   truth.

7. ``[reuse]``: ASDR's cross-frame data reuse on the trained field:
   ``render_asdr_image_cached`` over ``TRAJ_POSES`` 800x800 poses (theta
   0.9 + 0.01 k, phi 0.55) through the kernel field with the fused march
   and all tiers (warped probe maps, warped radiance, a shared
   ``SceneBlockCache``).  Per frame: ms, rays marched, the reuse flags,
   the warp's valid share, block hits and misses, samples processed and
   reused, PSNR against a fresh ``render_asdr_image`` of the pose and
   against the analytic ground truth; then the trajectory's ms beside the
   same poses rendered fresh.  Gates: (a) frame 0, all tiers cold, equals
   ``render_asdr_image`` bit for bit, image and count map; (b) the plain
   field's trajectory has the same flags, rays marched and count maps
   within 0.1 % and PSNRs against ground truth within 0.1 dB; (c) the
   trajectory with a ``Tracer`` installed gives the same frames and stats
   bit for bit, the reuse spans, and an export ``tools/check_trace.py``
   passes; (d) a replay with radiance reuse off on the same block store
   hits every block left resident and gives each frame the first pass
   marched whole back bit for bit.

8. ``[serve]``: the render serving engine (``serve.RenderServingEngine``)
   over two scenes at the paper's widths, both through the kernel field
   and the fused march: the trained lego field and the random field of
   phases 2-4.  Three viewers, closed loop, 24 requests enqueued k-major
   (viewers 0 and 1 on lego, viewer 2 on the random field, each at the
   ``[reuse]`` orbit's first ``SERVE_POSES`` poses); the engine at the
   reference's defaults (slots 4, blocks of 16 a batch, prefetch 2) with
   every reuse tier on and a 32 MiB block store.  Readings a run (host
   clock, synchronised): wall ms and frames/s, latency and admission
   stall p50/p99, a round's march ms p50/p99, batches and the pad-block
   fraction, rays marched, reused probe and radiance fractions, block
   hit rate, the store's resident bytes and evictions, the weight-pack
   LRU's hits, misses and size, launches; the same requests one by one
   through ``render_asdr_image``; runs with two worker streams, two
   batches in flight and blocks of 64 a batch; the full configuration
   with Stage A inline and on two worker streams under ``torch.profiler``.
   Gates, each fatal: (a) with every tier off and no prefetch, each
   request's image, samples and probe samples equal
   ``render_asdr_image``'s bit for bit; (b) frames and
   ``DETERMINISTIC_COUNTERS`` bit-identical at prefetch 0, prefetch 2 and
   two worker streams, and with every tier off at two batches in flight
   (with the tiers on, batches in flight move when frames finish and so
   what later admissions find cached, in the reference too: printed, not
   gated); (c) traced with worker streams, the same frames and counters,
   an export ``tools/check_trace.py`` passes, ``executor.run`` on
   ``serve-stage-a`` lanes, dispatch and collect batch ids matching; (d)
   viewer 0 alone on the plain field: equal flags and rays marched,
   samples within 0.1 %, PSNR against ground truth within 0.1 dB; (e)
   with the block store alone, a second viewer replaying the first's
   ``SERVE_REPLAY_POSES`` poses marches nothing and gets its frames bit
   for bit; (f) the full configuration with Stage A placed by a
   ``DeviceExecutor`` (``devices`` > 0): on ``cuda:1`` .. where the host
   has them, else on the engine's own card through the
   ``executor._available_devices`` hook, and then every Stage A runs on a
   replica of its field built on the card (``core.fields.Replicas``: the
   tables, resources and packed weights copied); frames and counters
   bit-identical to the prefetch-2 run, the placements and replicas
   printed; (g) two such engine replicas over one ``ShardedSceneCache``
   (``SERVE_FLEET_SHARDS`` shards of ``SERVE_FLEET_STORE_BYTES``), the
   second replaying the first's ``SERVE_REPLAY_POSES`` poses of all
   three viewers with every other tier off: each frame bit-equal to a
   plain sync engine's, the second replica's block hits above 0, every
   shard within its budget.

9. ``[lm]``: gemma2-27b (``configs/gemma2_27b.py`` CONFIG, 46 layers,
   d_model 4,608, 32 heads over 16 KV x 128, d_ff 36,864, vocab 256,000)
   served at full width through ``lm.build`` and
   ``ServingEngine.generate`` (slots ``LM_SLOTS``, greedy, ``max_seq``
   ``LM_MAX_SEQ``), its weights drawn on the card from
   ``PRNGKey(LM_INIT_SEED)`` through ``repro_torch.prng`` and stored once
   in bf16, its prefill self-attention on the flash kernel.  The
   ``LM_WAVES``: four 512-token prompts (linear caches) and one of 4,608
   tokens, past the 4,096 window (ring caches on the local layers), 32
   new tokens each.  Readings: the init's seconds, prefill ms a wave,
   decode ms a step, tokens/s, peak memory; wave A once more sampled at
   temperature 1.0; the share of greedy tokens the plain build (on
   ``flash_attention_plain``) agrees on, not gated; the longest wave under
   ``torch.profiler`` (device time by kernel, flash attention's share,
   the idle share); flash attention's ms at both waves' shapes, local and
   global, beside its bound, the plain version's and SDPA's (without the
   softcap, which SDPA lacks).  Gates, each fatal: (a) fp32 at full
   width with ``LM_GATE_LAYERS`` layers (one local, one global), the
   kernel build against the plain build on the same weights: every
   prefill's logits within ``LM_GATE_ATOL``, every greedy token equal,
   each decode step of the 4,608-token prompt within ``LM_GATE_ATOL`` of
   a full forward over the prompt and the tokens so far; (b) the bf16
   main run: flash attention launched 46 x 2 times, every token in
   [0, vocab) and every logit finite, and layers 0 and 1's prefill
   attention on the longest wave held against ``flash_attention_plain``
   on the q/k/v they had, at ``ATTN_TOL["bf16"]``.  Then gemma3-12b
   (``configs/gemma3_12b.py`` CONFIG: 48 layers, d_model 3,840, 16 heads
   over 8 KV x 256, five local layers of window 1,024 to one global, qk
   norm, d_ff 15,360, vocab 262,144; 11.8e9 parameters) the same way on
   the same waves, its head_dim 256 on the flash kernel: gate (a) at
   ``WIDE_GATE_LAYERS`` (6: layer 5 global), gate (b) 48 x 2 launches,
   without the sampled and profiled runs.

10. ``[moe]``: deepseek-moe-16b (``configs/deepseek_moe_16b.py`` CONFIG,
   28 layers, d_model 2,048, 16 heads x 128, 64 routed experts top-6 and
   2 shared of d_ff 1,408, vocab 102,400; 16.88e9 parameters stored in
   bf16) served the same way (``run_lm``) on ``FAMILY_WAVES``: four
   512-token prompts (groups of 512, capacity 60) and one of 4,096 (four
   groups of 1,024, capacity 120; the reference refuses 4,608), 32 new
   tokens each, ``max_seq`` ``FAMILY_MAX_SEQ``.  Readings as ``[lm]``'s,
   and the top-6 choices wave B's prefill dropped for capacity over its
   layers.  Gate (a) at 2 layers also records each routing call's top-k
   experts in both builds (``RouteLog``): logits and tokens are held on
   every request whose experts are the same in both, and it fails if more
   than ``MAX_FLIP_SHARE`` of routed token-layers flipped; its decode
   check runs at capacity factor 8 with one routing group a sequence,
   asserted drop-free.  Gate (b): 56 flash launches.

11. ``[ssm]``: mamba2-780m (48 attention-free SSD layers, d_model 1,536,
   48 heads x 64, state 128) and hymba-1.5b (32 layers of parallel
   attention, 25 heads over 5 x 64 with a 1,024 window but for layers 0,
   16 and 31, and SSD heads of state 16), each as ``[moe]`` without the
   sampled and profiled runs; gate (a) at 2 and 4 layers (hymba's four
   hold a local layer), where the decode check puts the SSM state's
   hand-off (``prefill`` -> ``ssm_step``) on the card; gate (b): 0 and 64
   flash launches, and hymba's wave B decodes its local layers through
   the ring.  Each new phase prints the memory still allocated at its
   start.

12. ``[vlm]``: paligemma-3b (18 layers, d_model 2,048, 8 heads over 1 KV
   x 256, vocab 257,216; ~2.5e9 parameters in bf16) through ``lm.build``
   -> ``api.prefill_fn`` / ``api.decode_fn`` (the serving engine, as the
   reference's, passes no ``img_embeds``): ``VLM_RUN`` 4 requests of 256
   numpy-seeded image embeddings (bf16) and 512 text tokens, 32 new tokens
   each, greedy, decode positions after the prefix.  Readings: init,
   prefill ms, decode ms a step, tokens/s, peak memory.  Gates, fatal:
   fp32 at ``NEW_FAMILY_GATE_LAYERS`` layers, prefill of all but the last
   token then one decode step against the full forward's last logits
   within ``LM_GATE_ATOL``; the main run launches no flash kernel (the
   prefix mask sends every layer's prefill to ``attend_chunked``, as the
   reference's), tokens in range, logits finite.

13. ``[encdec]``: whisper-medium (24 + 24 layers, d_model 1,024, 16 x 64,
   1,500 encoder frames; ~0.79e9 parameters) through ``lm.build``:
   ``api.prefill_fn`` on ``ENCDEC_RUN`` 4 requests of numpy-seeded frames
   (bf16) and 64-token prompts (the encoder, ``decode_train`` with its
   causal self-attention on the flash kernel, the cross K/V), then as the
   reference's own test serves it: ``encdec.init_cache`` with the cross
   K/V, the prompt decoded one token at a time from position 0, then 32
   new tokens, greedy.  Readings as ``[vlm]``'s.  Gates, fatal: fp32 at 2
   + 2 layers, the token-by-token decode's last logits against
   ``decode_train``'s within ``LM_GATE_ATOL``; 24 flash launches in the
   main run, tokens in range, logits finite.

14. ``[lmtrain]``: LM training on the training route (``lm.build(cfg,
   "full", attention=attention.attend_causal)``: the reference's
   ``attend_chunked``, which autograd runs through; the flash kernel has
   no backward and the reference's training reaches no Pallas kernel).
   Gate (e): ``ops.flash_attention`` on a CUDA input that requires grad,
   and a loss on the kernel route, raise.  Gate (a): fp32 with TF32 off,
   hymba-1.5b at 4 layers (a local layer among them) and whisper-medium
   at 2 + 2, full width, 2 x 256 tokens: the card's loss and gradients
   (``train/step.make_loss_and_grads``) against the CPU port's on the
   same params and tokens, the loss within rtol 1e-5, each gradient leaf
   within 1e-3 of its own max abs, and no leaf zero on the card where the
   CPU's is not.  Gate (b), the main runs through
   ``launch/train.train_loop`` at full width and depth, float32 masters
   and bf16 compute: mamba2-780m at the launcher's defaults (8 x 128, 50
   steps, lr 3e-4, warmup 5), then one async checkpoint of (values,
   opt_state) to a temporary directory, removed afterwards; hymba-1.5b
   at 4 x 1,024, 20 steps.  Every loss finite, the last at least 0.5
   below the first (``tests/test_train.py:42-54``), the trainer on
   ``attend_causal``, no kernel launched.  Readings beside the card's
   name and power limit: init s, ms a step (median after 3 warm steps),
   tokens/s, peak GB, the checkpoint's hand-off and write ms and GB, and
   5 more steps under ``torch.profiler`` (device time, idle share).  Gate
   (c): ``train_loop`` with a failure injected at step 9 (one restart
   from the latest checkpoint, every 4 steps) against an uninterrupted
   run, mamba2-780m at full width cut to 4 layers, 12 steps: the losses
   of steps 10-11 within rtol 1e-4 (``tests/test_train.py:73-95``).
   Gate (d): hymba-1.5b's loss and gradients at 1 x 1,024 with remat
   None, "full" and "dots": equal losses; each one's ms and peak memory.

15. ``[dryrun]``: the dry-run tools reduced to the card
   (``launch/dryrun.py``), through its entry point: ``dryrun.main --all
   --mesh both`` writes the analytic record of every cell on the single-
   and multi-pod meshes (10 archs x 4 shapes, long_500k skipped outside
   ``LONG_OK``, and the three ingp-asdr cells), then ``--all --mesh card``
   every cell's record on the card, one line each (per-device argument
   GB, compute and memory terms, bottleneck), all under
   ``chiprun_out/dryrun_torch``; an error record is fatal.  The card mesh
   measures each cell whose reckoning fits ``dryrun.CARD_BYTES`` (once
   warm, three times timed, peak memory, launches a call), from ``SEED``:
   ``asdr_render`` on the main path's 800x800 frame (643,072 padded rays,
   the kernel field's Phase-I counts) and ``render_serve``'s pooled march
   on 64 of its sorted blocks, both on the kernel field (``hash_encode``,
   ``density_mlp``, ``color_mlp``), and the decode_32k and long_500k
   cells of mamba2-780m and hymba-1.5b; ``asdr_train`` reckons more.
   Then one LM prefill cell on the flash kernel: the prefill_32k cell
   with the smallest reckoning at one row among ``DRYRUN_LM_FAMILIES`` (no
   prefill_32k cell fits the card whole), cut to the most rows up to
   ``DRYRUN_MAX_ROWS`` that fit.  Gates, fatal: (a) every measured
   cell's outputs finite; (b) asdr_render's rgb and acc on its first
   ``DRYRUN_GATE_BLOCKS`` sorted blocks, and each pooled block's march,
   against the plain field's ``_march_block`` on the same block within
   RTOL / ATOL, chunks and ray_chunks exact, and the LM cell's prefill
   once more with layers 0 and 1 recorded, each layer's kernel output on
   the last row against ``flash_attention_plain`` over all its keys at
   ATTN_TOL["bf16"]; (c) the LM cell's analytic bound over its measured
   time at most ``DRYRUN_MAX_SHARE``; (d) the three field kernels launch
   in each render cell, the flash kernel once a layer a call in the LM
   cell, and the kernels line lists all eight kernels.

16. ``[vm]``: the VM march (``kernels/vm_march.py``) on its main path's
   shapes: a TensoRF VM-192 field (``configs/tensorf_vm.py`` CONFIG, the
   300^3 grid; ``init_tensorf`` from ``SEED`` with the density tensors
   times ``VM_GAIN``) through ``ops.tensorf_field_fns``, one 800x800
   ``render_asdr_image`` at CAMERA with every launch count set to 0 just
   before: exactly one ``vm_march`` launch and the frame's count map on
   more than one rung.  Then the kernel and ``vm_march_plain`` on that
   frame's sorted blocks (its 157 blocks of 4,096 rays over the card's
   cooperative CTAs, a grid barrier a chunk step): rows bit-equal, chunk
   counters and per-block anchors exact, the chunk counters the frame's,
   and the anchors the frame counted (``ops.vm_anchor_count()``) and
   those ``bench/metrics/_work_vm.py`` reckons from the counters; its
   kernel row's bound is ``_work_vm.march_cost``'s operations and bytes.
   The frame's Phase I gives short budgets to the rays that saturate
   early, so none of its blocks can exit early; the same blocks once more
   at the full budget, where blocks must exit early across CTAs, are
   held bit for bit against the plain version too.

Each phase's entry points run once with every launch count set to 0 just
before, and the run fails unless each kernel of that path launched (for
``[train]``, the two trained frames together; for ``[reuse]``, the
trajectory; for ``[serve]``, the main run; for ``[lm]``, ``[moe]`` and
``[ssm]``, the main run's ``generate``, with exactly one flash launch a
layer with attention a wave; mamba2-780m launches none; for ``[vlm]`` and
``[encdec]`` their main runs: none, and one a decoder layer; for
``[lmtrain]`` the two training runs: none; for ``[dryrun]`` the measured
render cells and the LM cell).  The JSON row of flash attention carries
the sum of the LM main runs' launches and the ``[dryrun]`` LM cell's.

Phases 2-5 use random weights, drawn with numpy from ``SEED`` in the
reference layout: Glorot-uniform MLPs and hash tables
uniform(-TABLE_SCALE, TABLE_SCALE).  TABLE_SCALE = 30 makes the density
chain's logits large, so the frame holds several rungs of the count
ladder and most Phase-II blocks saturate before their budget (both
asserted): the adaptive path and the early-exit path both run.

Print lines start with ``[build]``, ``[kernel]``, ``[frame]``,
``[decoupled]``, ``[attention]``, ``[train]``, ``[reuse]``, ``[serve]``,
``[lm]``, ``[moe]``, ``[ssm]``, ``[vlm]``, ``[encdec]``, ``[lmtrain]``,
``[dryrun]`` and ``[vm]``.  Prints one
``{"kernels": [...]}`` line, the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``.  Exits non-zero,
printing no result, without a CUDA device or outside a checkout.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 8
TABLE_SCALE = 30.0
CAMERA = dict(theta=0.9, phi=0.55)
RTOL, ATOL = 1e-4, 1e-5
# Flash attention against its plain version: rtol, atol and a limit on
# ||got - want|| / ||want||.  bf16 is held at 2-3x its error on the card
# (max 3.9e-3, one bf16 step of the output; norm 0.8-1.0e-3); the norm
# limit catches a few keys lost or added across the late rows, whose
# outputs are ~0.02.
ATTN_TOL = {"fp32": (2e-4, 2e-5, None), "bf16": (1e-2, 8e-3, 3e-3)}
MAX_COUNT_DIFF = 1e-3         # share of count-map pixels
MAX_PSNR_DIFF = 0.1           # dB
# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3,
# and the dense bf16 tensor cores (stated beside attention's bound).
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
PEAK_BF16_TC = 989e12
# The special-function units (exp2, reciprocal): 16 results a clock per SM
# (CUDA C++ Programming Guide, arithmetic instruction throughput, compute
# capability 9.0) on 132 SMs at the 1,980 MHz boost clock (data sheet).
PEAK_SFU = 16 * 132 * 1.98e9
FRAME_KERNELS = ("hash_encode", "density_mlp", "color_mlp", "fused_march")
# The [train] phase: the paper-width NGP trained on the card on the lego
# scene (24 views of 200x200, 4,096 rays x 48 samples a batch, lr 5e-3 on
# the cosine schedule), then rendered at CAMERA.  A step is bound by the
# host's launches (~4,800 kernels, the device idle ~80 % of the time) and
# took 63-97 ms on an H100, so 800 steps stay within ~80 s of training.
# The phase fails unless the loss falls below TRAIN_LOSS_GATE of its
# first value (the reference's own gate, tests/test_ngp_train.py).
TRAIN_STEPS = 800
TRAIN = dict(scene="lego", steps=TRAIN_STEPS, batch_rays=4096, n_samples=48,
             lr=5e-3, n_views=24, view_hw=(200, 200), seed=0, log_every=1)
TRAIN_LOSS_GATE = 0.4
TRAIN_WARM_STEPS = 10          # steps left out of the median step time
TRAIN_PROFILE_STEPS = 20       # steps under torch.profiler after training
GT_RAYS_PER_CALL = 1 << 14     # ground truth: 512 analytic samples a ray
# The paper's software-only GPU figure for adaptive sampling alone (Fig.
# 24, "AS"): a reading to print beside the card's ratio, not a target.
PAPER_AS_SPEEDUP = 1.84
# The [reuse] phase: ASDR's cross-frame data reuse over a camera trajectory
# on the trained field: TRAJ_POSES poses at theta 0.9 + TRAJ_STEP k, phi
# 0.55, 0.57 degrees and ~0.010 of eye travel a step.  Frames 1-3 warp
# frame 0's radiance (under RadianceReuseConfig's 2 degrees / 0.04),
# frame 4 is past it and marches afresh on a warped probe (under the
# probe's 4 degrees / 0.08), and the probe's refresh_every = 8 re-probes
# at frame 9.  The plain field's trajectory (gate (b)) takes most of the
# phase, ~2.5 s a full frame; all TRAJ_POSES of it fit the phase's ~60 s.
TRAJ_POSES = 12
TRAJ_STEP = 0.01
REUSE_FLAGS = ("probe_reused", "probe_skipped", "radiance_reused")
REUSE_SPANS = ("probe.plan", "probe.execute", "probe.commit",
               "warp.count_map", "warp.image", "radiance.plan",
               "radiance.commit", "scenecache.store")
DECOUPLED_KERNELS = ("hash_encode", "density_mlp", "color_mlp",
                     "volume_render")
DECOUPLED_RAYS_PER_CALL = 1 << 16
# The fma-emulating plain versions of the tile kernels run in row chunks:
# one float64 temporary of a 4,915,200 x 128 layer step would be 5 GB.
PLAIN_ROWS = 1 << 20
# The kernels ptxas must give a 0-byte stack frame and no spills (the
# hash encode's instantiations, the register-tiled chains, the volume
# render and the flash-attention instantiations), with their sources;
# each flash-attention kernel must report both head-dim bounds'
# instantiations (TILE_INSTANCES), each with its registers.
TILE_KERNELS = {"hash_encode_kernel": "hash_encode",
                "color_mlp_kernel": "fused_mlp",
                "fused_field_kernel": "fused_mlp",
                "density_mlp_kernel": "fused_mlp",
                "fused_march_kernel": "fused_march",
                "volume_render_kernel": "volume_render",
                "vm_march_kernel": "vm_march",
                "flash_attention_bf16_kernel": "flash_attention",
                "flash_attention_f32_kernel": "flash_attention"}
# Stack frames allowed in place of 0 bytes, with why: the VM march's sinf
# and cosf (the PE of its features, as torch.sin and torch.cos compute it
# in its plain version) keep the library's slow argument reduction for
# |x| > 105,615, whose 28-B array lives in local memory and is touched by
# such arguments only.
TILE_STACK = {"vm_march_kernel": 32}
TILE_INSTANCES = {"flash_attention_bf16_kernel": ("<128>", "<256>"),
                  "flash_attention_f32_kernel": ("<128>", "<256>")}
# The ragged march: blocks of a size that is not a multiple of 32, group
# 3, budgets below the chunk among them, per-ray exit.
RAGGED_B, RAGGED_GROUP = 1000, 3
RAGGED_BUDGETS = (7, 20, 31, 12, 96, 192, 5, 48, 24, 33, 65, 100)
# The [vm] phase's field: TensoRF's 0.1 randn init with the density planes
# and lines times VM_GAIN, so the density feature (a sum of 48 products of
# two such values) has a spread of ~15 about 0 and a quarter of the cube
# is denser than softplus(0) x 75: a ray through it saturates within a
# chunk or two, one that misses it does not, and Phase I's counts take
# several rungs.
VM_GAIN = 20.0
# Ragged attention: a length that is a multiple of neither query tile and
# a window whose first key falls mid-tile.
RAGGED_SEQ, RAGGED_WINDOW = 333, 100
# Ragged volume render (R, S, A, group): rays off the warp's 32, samples
# off the chunk (S % 4 != 0 and == 0), one anchor or a group's worth.
RAGGED_RENDERS = ((1005, 50, 1, 3), (1005, 50, 17, 3), (1005, 52, 18, 3))
ATTN_SEQ = 8192
# Flash attention at head_dim 256: gemma3-12b's widths (H 16 over KV 8) over
# [lm]'s longest wave, 4,608 tokens.
WIDE_SEQ = 4608
# fp32 operations of one sample of the volume render: sigma*delta, two
# negations and two exps, 1 - e, the weight, the running sum, acc and the
# lerp offset (10), then per channel the lerp (3) and the weighted add (2).
VOLUME_RENDER_FLOP = 10 + 3 * 5
# The hash encode's timing: the median of TIME_ROUNDS rounds of TIME_REPS
# launches, warm, and each launch after FLUSH_BYTES written (the tables
# cold in L2, as a decoupled chunk's launch finds them after the color
# MLP); nvidia-smi samples the card every SMI_MS ms beside the window.
TIME_ROUNDS, TIME_REPS = 5, 10
FLUSH_BYTES = 256 << 20
SMI_QUERY = "clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu"
SMI_MS = 100
# fp32 operations of one trilinear encode of one point at one level:
# 3 scales + 3 fracs, then per corner 2 weight products and F
# multiply-adds (F = 2).
ENCODE_FLOP = 6 + 8 * (2 + 2 * 2)


def bound(flop: float, nbytes: float, peak: float = PEAK_FP32):
    """(ms, "operations" or "bytes"): the larger of ``flop`` at ``peak``
    and ``nbytes`` at the memory rate."""
    t_ops, t_bytes = flop / peak, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def timed(fn, dev, reps: int):
    """(result, ms per call): CUDA events around ``reps`` calls after one
    warm-up call on the card; the host clock on the CPU."""
    import torch
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize(dev)
        return out, start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return out, 1e3 * (time.perf_counter() - t0) / reps


def timed_rounds(fn, dev, flush=None, rounds=TIME_ROUNDS, reps=TIME_REPS):
    """ms per call of each of ``rounds`` rounds of ``reps`` calls after a
    warm-up call: CUDA events around each round's calls, or, where a
    ``flush`` tensor is given, around each call alone, after ``flush`` is
    overwritten (outside the events) so each call finds the L2 cold.  The
    host clock on the CPU."""
    import torch
    fn()
    out = []
    for _ in range(rounds):
        if dev.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            out.append(1e3 * (time.perf_counter() - t0) / reps)
            continue
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(reps if flush is not None else 1)]
        torch.cuda.synchronize(dev)
        if flush is None:
            ev[0][0].record()
            for _ in range(reps):
                fn()
            ev[0][1].record()
        else:
            for start, end in ev:
                flush.zero_()
                start.record()
                fn()
                end.record()
        torch.cuda.synchronize(dev)
        out.append(sum(a.elapsed_time(b) for a, b in ev) / reps)
    return out


def spread(ms):
    """'median (min-max over n rounds)' of per-round times."""
    s = sorted(ms)
    return (f"{s[len(s) // 2]:.3f} ({s[0]:.3f}-{s[-1]:.3f} over {len(s)} "
            f"rounds)")


class SmiSampler:
    """nvidia-smi sampling the card's clocks, power and temperature every
    SMI_MS ms while the ``with`` block runs (nothing off the card)."""

    def __init__(self, dev):
        self.dev, self.rows = dev, []

    def __enter__(self):
        import threading
        if self.dev.type != "cuda":
            return self
        self.proc = subprocess.Popen(
            ["nvidia-smi", "-i", "0", f"--query-gpu={SMI_QUERY}",
             "--format=csv,noheader,nounits", "-lms", str(SMI_MS)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.reader = threading.Thread(target=lambda: self.rows.extend(
            [float(x) for x in line.split(",")] for line in self.proc.stdout
            if line.count(",") == 4), daemon=True)
        self.reader.start()
        return self

    def wait_for_samples(self, n=2, limit_s=5.0):
        """Block until ``n`` samples came in (at most ``limit_s``)."""
        t0 = time.perf_counter()
        while (self.dev.type == "cuda" and len(self.rows) < n
               and time.perf_counter() - t0 < limit_s):
            time.sleep(0.01)

    def __exit__(self, *exc):
        if self.dev.type == "cuda":
            self.proc.terminate()
            self.proc.wait()
            self.reader.join()

    def summary(self) -> str:
        if not self.rows:
            return "card not sampled"
        cols = list(zip(*self.rows))
        rng = [f"{min(c):g}-{max(c):g}" for c in cols]
        return (f"{len(self.rows)} nvidia-smi samples: SM clock {rng[0]} MHz, "
                f"memory clock {rng[1]} MHz, power draw {rng[2]} W of "
                f"{rng[3]} W limit, {rng[4]} C")


def max_err(got, want, rtol=RTOL, atol=ATOL):
    """(max abs error, within rtol/atol), compared in fp32."""
    import torch
    got, want = got.float(), want.float()
    err = float(torch.max(torch.abs(got - want))) if got.numel() else 0.0
    return err, bool(torch.allclose(got, want, rtol=rtol, atol=atol))


def rel_norm_err(got, want) -> float:
    """||got - want|| / ||want||, in fp32."""
    import torch
    got, want = got.float(), want.float()
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


def in_chunks(fn, *rows, rest=(), step=PLAIN_ROWS):
    """fn(*chunk of each of ``rows``, *rest), concatenated over row chunks
    of at most ``step``."""
    import torch
    return torch.cat([fn(*(r[s:s + step] for r in rows), *rest)
                      for s in range(0, rows[0].shape[0], step)])


def check(name, got, want, ms, plain_ms, flop, nbytes, library_ms=None,
          rtol=RTOL, atol=ATOL, exact=False, peak=PEAK_FP32, rel=None):
    """Print one kernel's reading, fail on disagreement (any at all where
    ``exact``; a relative norm of the error above ``rel`` where given),
    return it."""
    err, ok = max_err(got, want, rtol, atol)
    ok = ok and (err == 0.0 or not exact)
    rel_txt = ""
    if rel is not None:
        r = rel_norm_err(got, want)
        ok = ok and r <= rel
        rel_txt = f" rel_norm_err={r:.3e} (limit {rel})"
    b_ms, b_by = bound(flop, nbytes, peak)
    print(f"[kernel] {name}: max_abs_err={err:.3e}{rel_txt} ms={ms:.3f} "
          f"plain_ms={plain_ms:.3f} bound_ms={b_ms:.3f} ({b_by}) "
          f"library_ms={library_ms}", flush=True)
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version "
                             f"(max abs err {err})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}


def kernel_row(name, src, replaces, *args, **kw):
    """The JSON row of one kernel (launches filled in from its path)."""
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": 0, **check(name, *args, **kw)}


def march_reckoning(runs, budgets, res, acfg, fl_d, with_color):
    """The work one fused-march run needed, from its chunk counters: the
    valid samples of each chunk each ray ran and their anchors, and the
    operations and bytes of its bound.  ``runs`` (nb, B) holds the chunks
    each ray ran (its block's, where rays do not exit on their own),
    ``budgets`` (nb,).  Returns (samples, anchors, flop, nbytes)."""
    import numpy as np
    from repro_torch.kernels import fused_march as FMA

    runs, bud = np.asarray(runs), np.asarray(budgets).astype(np.int64)
    nb, B = runs.shape
    C = acfg.chunk
    samples = anchors = 0
    for ci in range(int(runs.max(initial=0))):
        v = np.clip(bud - ci * C, 0, C)
        live = (runs > ci).sum(axis=1)
        samples += int((live * v).sum())
        anchors += int((live * -(-v // acfg.group)).sum())
    L = res.tables.shape[0]
    flop = samples * (L * ENCODE_FLOP + fl_d["density_flops"])
    if with_color:
        flop += anchors * fl_d["color_flops"]
    sh_dim = res.net.sh_dim if with_color else 0
    nbytes = 4 * (nb * B * (2 * 3 + FMA.OUT_W + sh_dim) + nb
                  + res.tables.numel() + res.density[0].numel()
                  + res.color[0].numel())
    return samples, anchors, flop, nbytes


def path_launches(names, fn):
    """``fn()`` with every launch count set to 0 just before; fails unless
    each kernel of ``names`` launched in it.  Returns (what fn returned,
    {name: launches})."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    out = fn()
    counts = ops.launch_counts()
    for name in names:
        if counts[name] <= 0:
            raise AssertionError(f"{name} was never launched on its path")
    return out, {name: counts[name] for name in names}


def check_march_ragged(o, d, res, net, common, dev):
    """The march once more, held bit for bit against its plain version, at
    shapes the frame does not give it: RAGGED_B rays a block (not a
    multiple of 32), group RAGGED_GROUP, budgets below the chunk among
    RAGGED_BUDGETS, per-ray exit; at the frame's chunk and at the largest
    (where a CTA holds two warp groups, not three)."""
    import torch
    from repro_torch.core import mlp as mlp_lib
    from repro_torch.kernels import fused_march as FMA

    nb, B = len(RAGGED_BUDGETS), RAGGED_B
    oo, dd = o[:nb * B].contiguous(), d[:nb * B].contiguous()
    sh = mlp_lib.sh_encode(dd, net.sh_degree).contiguous()
    budgets = torch.tensor(RAGGED_BUDGETS, dtype=torch.int32, device=dev)
    wd, dims_d = res.density
    wc, dims_c = res.color
    args = (oo, dd, sh, budgets, res.meta, res.tables, wd, dims_d, wc, dims_c)
    for chunk in (common["chunk"], FMA.MAX_CHUNK):
        kw = dict(common, block_size=B, chunk=chunk, group=RAGGED_GROUP,
                  with_color=True, per_ray_exit=True)
        out = FMA.fused_march(*args, **kw)
        err, _ = max_err(out, FMA.fused_march_plain(*args, **kw))
        groups = FMA.warp_groups(dims_d, dims_c, sh.shape[1], chunk,
                                 res.tables.shape[0])
        print(f"[kernel] fused_march on {nb} blocks of {B} rays, group "
              f"{RAGGED_GROUP}, chunk {chunk} ({groups} warp groups a CTA), "
              f"budgets {list(RAGGED_BUDGETS)}, per-ray exit: "
              f"max_abs_err={err:.3e}; block chunks "
              f"{out.reshape(nb, B, 8)[:, 0, 5].int().tolist()}", flush=True)
        if err != 0.0:
            raise AssertionError("fused_march differs from its plain version "
                                 f"at the ragged shape, chunk {chunk}")


def check_smem(bundle, attn, wide):
    """The shared memory the density, march and volume-render launchers
    ask for at ``bundle``'s widths (the decoupled frame's, and the ragged
    renders') equals the wrappers' reckoning (which the first two check
    against SMEM_LIMIT before a launch); the flash-attention launcher's
    tiles, shared memory and grid at head_dim 64 (the ragged shapes), at
    ``attn``'s (128) and at ``wide``'s (256), and the key tiles its kernels
    load for each query tile, are the wrapper's."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_march as FMA
    from repro_torch.kernels import fused_mlp as FM
    from repro_torch.kernels import volume_render as VR

    net, acfg = bundle.model.net, bundle.asdr
    dims_d, dims_c = tuple(net.density_sizes()), tuple(net.color_sizes())
    L = bundle.model.grid.n_levels
    pairs = [("density_mlp", FM.density_launch_smem(dims_d),
              FM.density_smem_bytes(dims_d))]
    for S, chunk in ((net.sh_dim, acfg.chunk), (0, acfg.chunk),
                     (net.sh_dim, FMA.MAX_CHUNK)):
        pairs.append((f"fused_march S={S} chunk {chunk}",
                      FMA.launch_smem(dims_d, dims_c, S, chunk, L),
                      FMA.smem_bytes(dims_d, dims_c, S, chunk, L)))
    ns, gr = bundle.asdr.ns_full, bundle.asdr.group
    for S, A, g in ((ns, -(-ns // gr), gr),) + tuple(
            r[1:] for r in RAGGED_RENDERS):
        pairs.append((f"volume_render S={S} A={A} group {g}",
                      VR.volume_render_launch_smem(S, A, g),
                      VR.volume_render_smem_bytes(S, A, g)))
    attn_cases = ((64, RAGGED_SEQ, attn.n_heads, (0, RAGGED_WINDOW)),
                  (attn.head_dim, ATTN_SEQ, attn.n_heads, (0, attn.window)),
                  (wide.head_dim, WIDE_SEQ, wide.n_heads, (0, wide.window)),
                  (wide.head_dim, RAGGED_SEQ, wide.n_heads,
                   (0, RAGGED_WINDOW)))
    for dt in (torch.float32, torch.bfloat16):
        for Dh, S, H, windows in attn_cases:
            got = FA.launch_config(Dh, 1, S, H, dt)
            want = (*FA.tiles(Dh, dt), FA.smem_bytes(Dh, dt),
                    *FA.grid(1, S, H, Dh, dt))
            print(f"[build] flash_attention {dt} head_dim {Dh} S {S}: the "
                  f"launcher's (query rows, keys, shared memory, grid) "
                  f"{got}, the wrapper's {want}", flush=True)
            if got != want or got[2] > FM.SMEM_LIMIT:
                raise AssertionError(f"flash_attention {dt}: launch "
                                     f"configuration {got}, reckoned {want}")
            qb = FA.tiles(Dh, dt)[0]
            for w in windows:
                bad = [q0 for q0 in range(0, S, qb)
                       if FA.launched_key_tiles(q0, S, w, Dh, dt)
                       != FA.key_tiles(q0, S, w, Dh, dt)]
                print(f"[build] flash_attention {dt} head_dim {Dh} S {S} "
                      f"window {w}: the kernel's key tiles differ from the "
                      f"wrapper's at {len(bad)} of {-(-S // qb)} query "
                      f"tiles", flush=True)
                if bad:
                    raise AssertionError(
                        f"flash_attention {dt} head_dim {Dh}: the kernel "
                        f"loads other key tiles at query tiles {bad}")
    for name, got, want in pairs:
        print(f"[build] {name}: the launcher asks for {got} B of shared "
              f"memory, the wrapper reckons {want} B (limit "
              f"{FM.SMEM_LIMIT} B)", flush=True)
        if got != want or got > FM.SMEM_LIMIT:
            raise AssertionError(f"{name}: shared memory {got} B, reckoned "
                                 f"{want} B")


def check_hash_encode(pts, o, d, meta, tables, acfg, dev):
    """The hash encode bit for bit against its plain version on the Phase-I
    rows ``pts`` and on one decoupled chunk's rows (the first
    DECOUPLED_RAYS_PER_CALL rays of the frame x ns_full), each timed warm
    and cold with the card sampled beside; on the Phase-I rows also the
    sector reckoning of both mappings.  Returns the Phase-I encoding and
    the kernel's row (Phase-I rows, warm)."""
    import torch
    from repro_torch.core import scene
    from repro_torch.kernels import hash_encode as HE

    L, T, F = tables.shape
    step = DECOUPLED_RAYS_PER_CALL
    chunk, _, _ = scene.sample_points(o[:step], d[:step], acfg.ns_full)
    chunk = chunk.reshape(-1, 3).contiguous()
    flush = torch.empty(FLUSH_BYTES // 4, device=dev)
    enc_phase1 = row = None
    for tag, x in (("Phase-I rows", pts), ("decoupled chunk rows", chunk)):
        n = x.shape[0]

        def kern():
            return HE.hash_encode(x, meta, tables)

        enc = kern()
        enc_p, plain_ms = timed(lambda: HE.hash_encode_plain(x, meta, tables),
                                dev, 1)
        with SmiSampler(dev) as smi:
            smi.wait_for_samples()
            warm = timed_rounds(kern, dev)
            cold = timed_rounds(kern, dev, flush=flush)
        print(f"[kernel] hash_encode on the {tag} ({n} points x {L} levels): "
              f"warm {spread(warm)} ms, cold (after a {FLUSH_BYTES >> 20} MiB "
              f"flush) {spread(cold)} ms; {smi.summary()}", flush=True)
        args = (enc, enc_p, sorted(warm)[len(warm) // 2], plain_ms)
        kw = dict(flop=n * L * ENCODE_FLOP,
                  nbytes=4 * (n * 3 + n * L * F + tables.numel()
                              + meta.numel()), exact=True)
        del enc_p
        if row is not None:
            check(f"hash_encode on the {tag}", *args, **kw)
            continue
        row = kernel_row("hash_encode", "hash_encode.cu",
                         "src/repro/kernels/hash_encode.py:94", *args, **kw)
        enc_phase1 = enc
        # the bound counts each table byte once; the gathers touch these
        # distinct sectors, each warp's counted once
        for mapping, name in (("level", "level groups (this kernel)"),
                              ("point", "point-major (the kernel it replaced)")):
            sec = HE.warp_sectors(x, meta, F, mapping)
            tot = int(sec.sum())
            print(f"[kernel] hash_encode on the {tag}, {name}: its warps' "
                  f"gathers touch {tot} distinct 32-B sectors ({tot / n:.2f} "
                  f"a point; by level "
                  f"{[round(v / n, 2) for v in sec.tolist()]}), "
                  f"{1e3 * 32 * tot / PEAK_BYTES:.3f} ms at the memory rate "
                  f"were none in L2", flush=True)
    del flush, chunk
    return enc_phase1, row


def check_kernels(field, bundle, cam, dev, reps=3):
    """Each kernel against its plain version at the main path's shapes.
    Returns the kernel rows of the JSON line (launches filled in later)
    and the fused field's launches on its path."""
    import numpy as np
    import torch
    from repro_torch.core import mlp as mlp_lib
    from repro_torch.core import pipeline, scene
    from repro_torch.kernels import fused_march as FMA
    from repro_torch.kernels import fused_mlp as FM
    from repro_torch.kernels import hash_encode as HE
    from repro_torch.kernels import ops

    acfg, net = bundle.asdr, bundle.model.net
    rows = []
    o, d = scene.camera_rays(cam, device=dev)
    st = acfg.probe_stride
    jj, ii = torch.meshgrid(torch.arange(0, cam.height, st, device=dev),
                            torch.arange(0, cam.width, st, device=dev),
                            indexing="ij")
    probe = (jj * cam.width + ii).reshape(-1)
    pts, _, _ = scene.sample_points(o[probe], d[probe], acfg.ns_full)
    pts = pts.reshape(-1, 3).contiguous()
    dirs = torch.repeat_interleave(d[probe], acfg.ns_full, dim=0)
    n = pts.shape[0]
    res = ops.FusedMarchResources(field)
    meta, tables = res.meta, res.tables
    L, T, F = tables.shape

    def row(*args, **kw):
        rows.append(kernel_row(*args, **kw))

    # ---- hash encode on the Phase-I samples, then a decoupled chunk's
    enc, he_row = check_hash_encode(pts, o, d, meta, tables, acfg, dev)
    rows.append(he_row)

    # ---- density MLP on the same rows
    wd, dims_d = res.density
    ws_d = FM.unpack_chain(wd, dims_d)

    def density_matmul():
        h = torch.relu(enc @ ws_d[0])
        for w in ws_d[1:-1]:
            h = torch.relu(h @ w)
        out = h @ ws_d[-1]
        return torch.cat([FM.trunc_exp_plain(out[:, :1]), out[:, 1:]], 1)

    dout, ms = timed(lambda: FM.density_mlp(enc, wd, dims_d), dev, reps)
    dout_p, plain_ms = timed(lambda: FM.density_mlp_plain(enc, wd, dims_d),
                             dev, 1)
    _, lib_ms = timed(density_matmul, dev, reps)
    fl_d = mlp_lib.flops_per_sample(net)
    row("density_mlp", "fused_mlp.cu", "src/repro/kernels/fused_mlp.py:131",
        dout, dout_p, ms, plain_ms, flop=n * fl_d["density_flops"],
        nbytes=4 * (enc.numel() + dout.numel() + wd.numel()),
        library_ms=lib_ms, exact=True)
    del dout_p

    # ---- color MLP on the same rows: [geo, SH(dir)]
    sh = mlp_lib.sh_encode(dirs, net.sh_degree).contiguous()
    cin = torch.cat([dout[:, 1:], sh], dim=-1).contiguous()
    wc, dims_c = res.color
    ws_c = FM.unpack_chain(wc, dims_c)

    def color_matmul():
        h = cin
        for w in ws_c[:-1]:
            h = torch.relu(h @ w)
        return torch.sigmoid(h @ ws_c[-1])

    rgb, ms = timed(lambda: FM.color_mlp(cin, wc, dims_c), dev, reps)
    rgb_p, plain_ms = timed(lambda: in_chunks(
        FM.color_mlp_plain, cin, rest=(wc, dims_c)), dev, 1)
    _, lib_ms = timed(color_matmul, dev, reps)
    row("color_mlp", "fused_mlp.cu", "src/repro/kernels/fused_mlp.py:145",
        rgb, rgb_p, ms, plain_ms, flop=n * fl_d["color_flops"],
        nbytes=4 * (cin.numel() + rgb.numel() + wc.numel()),
        library_ms=lib_ms, exact=True)
    del rgb_p
    # a ragged tile and an input that is not 16-B aligned (the wrapper
    # copies it): rows 3 .. 3 + 64k + 37
    tail = cin[3:3 + 64 * 1601 + 37]
    err_t, _ = max_err(FM.color_mlp(tail, wc, dims_c),
                       FM.color_mlp_plain(tail, wc, dims_c))
    print(f"[kernel] color_mlp on {tail.shape[0]} rows from row 3: "
          f"max_abs_err={err_t:.3e}", flush=True)
    if err_t != 0.0:
        raise AssertionError("color_mlp differs from its plain version on a "
                             "ragged, unaligned input")
    del cin, tail

    # ---- fused field on the same rows: its entry point once, then the
    # kernel against its plain version and, bit for bit, against the
    # density -> color kernel pair above
    (sig_f, rgb_f, geo_f), ff_launches = path_launches(
        ("fused_field",), lambda: ops.fused_field(enc, dirs, res, net))
    pair_exact = (torch.equal(sig_f, dout[:, 0]) and torch.equal(rgb_f, rgb)
                  and torch.equal(geo_f, dout[:, 1:]))
    print(f"[kernel] fused_field: bit-equal to the density_mlp -> color_mlp "
          f"kernel pair: {pair_exact}", flush=True)
    if not pair_exact:
        raise AssertionError("fused_field differs from the density_mlp -> "
                             "color_mlp kernel pair")
    del sig_f, rgb_f, geo_f

    def fused_matmul():
        dm = density_matmul()
        h = torch.cat([dm[:, 1:], sh], 1)
        for w in ws_c[:-1]:
            h = torch.relu(h @ w)
        return torch.cat([dm[:, :1], torch.sigmoid(h @ ws_c[-1]), dm[:, 1:]],
                         1)

    ff, ms = timed(lambda: FM.fused_field(enc, sh, wd, dims_d, wc, dims_c),
                   dev, reps)
    ff_p, plain_ms = timed(lambda: in_chunks(
        FM.fused_field_plain, enc, sh, rest=(wd, dims_d, wc, dims_c)), dev, 1)
    _, lib_ms = timed(fused_matmul, dev, reps)
    row("fused_field", "fused_mlp.cu", "src/repro/kernels/fused_mlp.py:116",
        ff, ff_p, ms, plain_ms,
        flop=n * (fl_d["density_flops"] + fl_d["color_flops"]),
        nbytes=4 * (enc.numel() + sh.numel() + ff.numel() + wd.numel()
                    + wc.numel()),
        library_ms=lib_ms, exact=True)
    del ff, ff_p, enc, sh, rgb, dout, pts, dirs

    # ---- fused march on the frame's blocks, budgets across the ladder
    B, C = acfg.block_size, acfg.chunk
    R = cam.height * cam.width
    counts = torch.zeros((R,), dtype=torch.int32, device=dev)
    o_p, d_p, _, _, _ = pipeline.pad_rays_to_blocks(acfg, o, d, counts)
    nb = o_p.shape[0] // B
    ladder = sorted(set(acfg.candidates) | {acfg.ns_full})
    rng = np.random.default_rng(SEED)
    bud = np.concatenate([ladder, rng.choice(ladder, nb - len(ladder))])
    budgets = torch.from_numpy(bud.astype(np.int32)).to(dev)
    sh = mlp_lib.sh_encode(d_p, net.sh_degree).contiguous()
    common = dict(block_size=B, chunk=C, group=acfg.group, near=ops.NEAR32,
                  far=ops.FAR32, log_eps_t=ops.LOG_EPS_T32,
                  early_term=acfg.early_termination,
                  white_background=acfg.white_background)
    args = (o_p.contiguous(), d_p.contiguous())
    variants = [("", dict(with_color=True, per_ray_exit=False)),
                (" density_only", dict(with_color=False, per_ray_exit=False)),
                (" per_ray_early_exit", dict(with_color=True, per_ray_exit=True))]
    for tag, kw in variants:
        shv = sh if kw["with_color"] else None
        # every variant against the plain version on all the frame's blocks
        def kern():
            return FMA.fused_march(*args, shv, budgets, meta, tables, wd,
                                   dims_d, wc, dims_c, **common, **kw)

        def plain():
            return FMA.fused_march_plain(*args, shv, budgets, meta, tables,
                                         wd, dims_d, wc, dims_c, **common,
                                         **kw)

        out, ms = timed(kern, dev, reps)
        out_p, plain_ms = timed(plain, dev, 1)
        exact_c = torch.equal(out[:, 5:7], out_p[:, 5:7])
        print(f"[kernel] fused_march{tag}: counters exact={exact_c} (plain on "
              f"all {nb} blocks); block chunks "
              f"{out.reshape(nb, B, 8)[:, 0, 5].int().tolist()}", flush=True)
        if not exact_c:
            raise AssertionError(f"fused_march{tag}: chunk counters differ "
                                 "from the plain version")
        # work this run's data needs: valid samples of the chunks each
        # block ran (per live ray with per-ray exit), color on their anchors
        counters = out.reshape(nb, B, 8).cpu().numpy()
        runs = counters[:, :, 6 if kw["per_ray_exit"] else 5]
        samples, anchors, flop, nbytes = march_reckoning(
            runs, bud, res, acfg, fl_d, kw["with_color"])
        work = f"{samples} samples" + (f", {anchors} anchors with color"
                                       if kw["with_color"] else "")
        print(f"[kernel] fused_march{tag}: {work}", flush=True)
        if tag:
            check(f"fused_march{tag}", out, out_p, ms, plain_ms, flop, nbytes,
                  exact=True)
        else:
            row("fused_march", "fused_march.cu",
                "src/repro/kernels/fused_march.py:329", out, out_p, ms,
                plain_ms, flop, nbytes, exact=True)
        del out, out_p
    check_march_ragged(o, d, res, net, common, dev)
    return rows, ff_launches


def run_vm(dev, reps=3):
    """``[vm]``: the VM march at its main path's shapes (module docstring,
    16).  Returns its kernel row and its launches on the frame's path."""
    import numpy as np
    import torch
    from bench.metrics import _work_vm
    from repro_torch import prng
    from repro_torch.configs import tensorf_vm
    from repro_torch.core import scene, tensorf
    from repro_torch.kernels import ops
    from repro_torch.kernels import vm_march as VM

    bundle = tensorf_vm.CONFIG
    acfg = bundle.asdr
    cfg = json.loads((ROOT / "bench" / "configs" / "tensorf-vm.json")
                     .read_text())
    params = tensorf.init_tensorf(bundle.model, prng.PRNGKey(SEED),
                                  device=dev)
    for g in ("density_plane", "density_line"):
        params[g] = [t * VM_GAIN for t in params[g]]
    fns = ops.tensorf_field_fns(tensorf.TensoRFField(bundle.model, params))
    cam = scene.look_at_camera(*bundle.image_hw, **CAMERA)
    (img, st, ms_frame), launches = path_launches(
        ("vm_march",), lambda: render_frame(fns, acfg, cam, dev))
    frame_anchors = ops.vm_anchor_count()
    _, _, ms_frame2 = render_frame(fns, acfg, cam, dev)
    budgets = st["budgets"].cpu().numpy()
    chunks = st["chunks_per_block"].cpu().numpy()
    early = int((chunks < -(-budgets // acfg.chunk)).sum())
    rungs = np.unique(st["counts"].cpu().numpy())
    print(f"[vm] {bundle.name} frame, {cam.height}x{cam.width}: "
          f"{ms_frame:.1f} ms (first run), "
          f"{ms_frame2:.1f} ms (second); launches {launches}; count rungs "
          f"{rungs.tolist()}; {len(budgets)} blocks, {early} exit early; "
          f"chunks per block {chunks.tolist()}; {frame_anchors} ray-anchors",
          flush=True)
    if launches["vm_march"] != 1:
        raise AssertionError(f"[vm] the frame launched vm_march "
                             f"{launches['vm_march']} times, not once")
    if len(rungs) < 2:
        raise AssertionError("[vm] the frame holds one rung of the ladder")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("[vm] non-finite frame")

    o_s, d_s, bud = frame_blocks(fns, acfg, cam, dev)
    tb = fns.fused
    o = o_s.reshape(-1, 3).contiguous()
    d = d_s.reshape(-1, 3).contiguous()
    view = VM.view_features(d, tb.view_pe).contiguous()
    kw = dict(block_size=acfg.block_size, chunk=acfg.chunk, group=acfg.group,
              near=ops.NEAR32, far=ops.FAR32, log_eps_t=ops.LOG_EPS_T32,
              early_term=acfg.early_termination,
              white_background=acfg.white_background, with_color=True,
              per_ray_exit=acfg.per_ray_early_exit)
    nb = bud.shape[0]

    def against_plain(budgets, tag, reps_k):
        (out, anc), ms = timed(
            lambda: VM.vm_march(o, d, view, budgets, tb, **kw), dev, reps_k)
        (out_p, anc_p), plain_ms = host_ms(
            lambda: VM.vm_march_plain(o, d, view, budgets, tb, **kw), dev)
        blk = out.reshape(nb, acfg.block_size, VM.OUT_W)[:, 0, 5].int()
        counters = (torch.equal(out[:, 5:7], out_p[:, 5:7])
                    and torch.equal(anc, anc_p))
        full = -(-budgets // acfg.chunk)
        early = int((blk < full).sum())
        print(f"[vm] vm_march on the frame's {nb} blocks, {tag}: counters "
              f"and per-block anchors exact={counters}; rows equal="
              f"{torch.equal(out, out_p)}; {early} blocks exit early; "
              f"{int(anc.sum())} ray-anchors; {ms:.3f} ms, plain "
              f"{plain_ms:.1f} ms", flush=True)
        if not counters:
            raise AssertionError(f"[vm] {tag}: vm_march's counters differ "
                                 "from the plain version's")
        return out, out_p, anc, blk, early, ms, plain_ms

    out, out_p, anc, blk, _, ms, plain_ms = against_plain(
        bud, "the frame's budgets", reps)
    same_frame = (torch.equal(bud, st["budgets"])
                  and torch.equal(blk, st["chunks_per_block"]))
    samples, anchors = _work_vm.march_counts(
        bud.tolist(), blk.tolist(), acfg.block_size, acfg.chunk, acfg.group)
    print(f"[vm] budgets and chunks as in the frame: {same_frame}; {samples} "
          f"samples, {int(anc.sum())} ray-anchors (the frame's "
          f"{frame_anchors}, reckoned {anchors})", flush=True)
    if not same_frame or not (int(anc.sum()) == frame_anchors == anchors):
        raise AssertionError("[vm] the march run alone is not the frame's")
    f_out, f_out_p, _, _, early, _, _ = against_plain(
        torch.full_like(bud, acfg.ns_full), "the full budget", 1)
    if not torch.equal(f_out, f_out_p) or early < 1:
        raise AssertionError(f"[vm] the full budget: rows differ from the "
                             f"plain version's or no block exits early "
                             f"({early})")
    del f_out, f_out_p
    flop, nbytes = _work_vm.march_cost(cfg, nb, samples, anchors)
    row = kernel_row("vm_march", "vm_march.cu",
                     "none (the JAX package has no VM field)", out, out_p,
                     ms, plain_ms, flop, nbytes, exact=True)
    return row, launches


def sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host_ms(fn, dev):
    """(result, ms): host clock around one call that ends in a
    synchronize."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, 1e3 * (time.perf_counter() - t0)


def render_frame(fns, acfg, cam, dev):
    """(image, stats, ms) of one render_asdr_image call, host clock around
    work that ends in a synchronize."""
    from repro_torch.core import pipeline

    (img, st), ms = host_ms(
        lambda: pipeline.render_asdr_image(fns, acfg, cam, device=dev), dev)
    return img, st, ms


def frame_blocks(fns, acfg, cam, dev):
    """The blocks render_asdr_image marches in Phase II: Phase I's counts,
    padded and sorted into blocks by budget.  Returns (o, d, budgets)."""
    from repro_torch.core import pipeline, scene
    o, d = scene.camera_rays(cam, device=dev)
    probe = pipeline.probe_phase(fns, acfg, cam,
                                 return_opacity=acfg.sort_by_opacity,
                                 device=dev)
    opacity = probe[2] if acfg.sort_by_opacity else None
    o, d, counts, opacity, _ = pipeline.pad_rays_to_blocks(acfg, o, d,
                                                           probe[0], opacity)
    order, budgets = pipeline.block_sort(acfg, counts, opacity)
    B = acfg.block_size
    return o[order].reshape(-1, B, 3), d[order].reshape(-1, B, 3), budgets


def time_frame_march(fns, acfg, cam, stats, dev, reps=3):
    """The fused march alone on the frame's own blocks and budgets, with
    and without color, each beside the bound of the work its chunk
    counters say it needed; its chunk counts must be the frame's."""
    import torch
    from repro_torch.core import mlp as mlp_lib
    from repro_torch.kernels import ops

    o_s, d_s, budgets = frame_blocks(fns, acfg, cam, dev)
    fl_d = mlp_lib.flops_per_sample(fns.fused.net)

    def march(density_only):
        return ops.fused_march_blocks(fns.fused, acfg, o_s, d_s, budgets,
                                      density_only=density_only)

    out, ms = timed(lambda: march(False), dev, reps)
    out_d, ms_density = timed(lambda: march(True), dev, reps)
    same = (torch.equal(budgets, stats["budgets"])
            and torch.equal(out[3], stats["chunks_per_block"]))
    print(f"[frame] fused march alone on the frame's {budgets.shape[0]} "
          f"blocks (budgets from Phase I): {ms:.3f} ms, density only "
          f"{ms_density:.3f} ms; budgets and chunks as in the frame: {same}",
          flush=True)
    for tag, o_m, t_ms, color in (("with color", out, ms, True),
                                  ("density only", out_d, ms_density, False)):
        runs = (o_m[4] if acfg.per_ray_early_exit
                else o_m[3][:, None].expand(o_m[4].shape))
        samples, anchors, flop, nbytes = march_reckoning(
            runs.cpu().numpy(), budgets.cpu().numpy(), fns.fused, acfg, fl_d,
            color)
        b_ms, b_by = bound(flop, nbytes)
        print(f"[frame] fused march alone, {tag}: {samples} samples "
              f"(those within the budgets; the frame counts whole chunks, "
              f"{stats['samples_processed']})"
              f"{f', {anchors} anchors with color' if color else ''}; "
              f"{t_ms:.3f} ms against a bound of {b_ms:.3f} ms ({b_by}, "
              f"{100 * b_ms / t_ms:.0f} % of it)", flush=True)
    if not same:
        raise AssertionError("the frame's march, run alone, ran other chunks")


def fixed_reference(fns, cam, ns, dev, rays_per_call=1 << 15):
    import torch
    from repro_torch.core import pipeline, scene
    o, d = scene.camera_rays(cam, device=dev)
    rgb = torch.cat([pipeline.render_fixed_fns(fns, o[s:s + rays_per_call],
                                               d[s:s + rays_per_call], ns)[0]
                     for s in range(0, o.shape[0], rays_per_call)])
    return rgb.reshape(cam.height, cam.width, 3)


def run_frames(field, bundle, cam, dev):
    """The main path end to end; returns the launch counts of the fused
    frame and the plain fixed-``ns_full`` render of the view."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import model, pipeline, rendering
    from repro_torch.kernels import ops

    fns_k = ops.field_fns(field)
    fns_p = model.field_fns(field)
    fused = dataclasses.replace(bundle.asdr, march_backend="fused")
    reference = dataclasses.replace(bundle.asdr, march_backend="reference")

    (img_k, st_k, ms_k), launches = path_launches(
        FRAME_KERNELS, lambda: render_frame(fns_k, fused, cam, dev))
    print(f"[frame] kernel path, fused march: {ms_k:.1f} ms (first run); "
          f"launches {launches}", flush=True)
    _, _, ms_k2 = render_frame(fns_k, fused, cam, dev)
    _, ms_probe = host_ms(
        lambda: pipeline.probe_phase(fns_k, fused, cam, device=dev), dev)
    img_r, st_r, ms_r = render_frame(fns_k, reference, cam, dev)
    img_p, st_p, ms_p = render_frame(fns_p, reference, cam, dev)
    print(f"[frame] kernel path, fused march (second run): {ms_k2:.1f} ms, "
          f"of which Phase I alone {ms_probe:.1f} ms; kernel field, "
          f"reference march: {ms_r:.1f} ms; plain field, reference march: "
          f"{ms_p:.1f} ms", flush=True)
    time_frame_march(fns_k, fused, cam, st_k, dev)

    counts = st_k["counts"]
    vals, nums = torch.unique(counts, return_counts=True)
    hist = dict(zip(vals.tolist(), nums.tolist()))
    budgets = st_k["budgets"].cpu().numpy()
    chunks = st_k["chunks_per_block"].cpu().numpy()
    full = -(-budgets // bundle.asdr.chunk)
    early = int((chunks < full).sum())
    print(f"[frame] count histogram {hist}", flush=True)
    print(f"[frame] budgets {np.unique(budgets, return_counts=True)[0].tolist()}"
          f" x {np.unique(budgets, return_counts=True)[1].tolist()}; "
          f"chunks per block {chunks.tolist()}; {early} of {len(chunks)} "
          f"blocks exit early; samples {st_k['samples_processed']} of "
          f"{st_k['baseline_samples']}", flush=True)
    if len(hist) < 2:
        raise AssertionError("the count map holds a single ladder value")
    if early < 1:
        raise AssertionError("no Phase-II block exited early")

    diff = float((st_k["counts"] != st_p["counts"]).float().mean())
    diff_r = float((st_r["counts"] != st_p["counts"]).float().mean())
    ref = fixed_reference(fns_p, cam, bundle.asdr.ns_full, dev)
    p_k = float(rendering.psnr(img_k, ref))
    p_r = float(rendering.psnr(img_r, ref))
    p_p = float(rendering.psnr(img_p, ref))
    chunks_eq = bool(torch.equal(st_k["chunks_per_block"],
                                 st_r["chunks_per_block"]))
    print(f"[frame] count-map share differing from the plain path: kernel "
          f"{diff:.3e}, reference march {diff_r:.3e}; PSNR vs plain "
          f"fixed-{bundle.asdr.ns_full}: fused {p_k:.4f} dB, reference march "
          f"{p_r:.4f} dB, plain {p_p:.4f} dB; fused and reference chunks "
          f"equal: {chunks_eq}", flush=True)
    if not (all(math.isfinite(x) for x in (p_k, p_r, p_p))
            and bool(torch.isfinite(img_k).all())
            and tuple(img_k.shape) == (cam.height, cam.width, 3)):
        raise AssertionError("non-finite or misshapen frame")
    if diff > MAX_COUNT_DIFF or diff_r > MAX_COUNT_DIFF:
        raise AssertionError(f"count maps differ in {diff:.3e} / {diff_r:.3e}"
                             f" of pixels (limit {MAX_COUNT_DIFF})")
    if abs(p_k - p_p) > MAX_PSNR_DIFF or abs(p_r - p_p) > MAX_PSNR_DIFF:
        raise AssertionError(f"PSNR gap {p_k - p_p:.4f} / {p_r - p_p:.4f} dB "
                             f"(limit {MAX_PSNR_DIFF})")
    return launches, ref


def stream_overlap(prof, kernel):
    """How the launches of ``kernel`` shared the card with work on other
    streams, from the profiler's device events: (its launches, their ms,
    the other streams' events, their ms, the ms of those events inside a
    launch of ``kernel``, how many of them overlap one)."""
    import numpy as np
    from torch.autograd import DeviceType

    evs = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() != DeviceType.CPU]
    mine = [e for e in evs if kernel in e.name()]
    streams = {e.device_resource_id() for e in mine}
    other = [e for e in evs if e.device_resource_id() not in streams]
    start = np.array([e.start_ns() for e in other], np.float64)
    end = start + np.array([e.duration_ns() for e in other], np.float64)
    inside, n = 0.0, 0
    for e in mine:
        ov = np.clip(np.minimum(end, e.start_ns() + e.duration_ns())
                     - np.maximum(start, e.start_ns()), 0.0, None)
        inside += float(ov.sum())
        n += int((ov > 0).sum())
    return (len(mine), sum(e.duration_ns() for e in mine) / 1e6, len(other),
            float((end - start).sum()) / 1e6, inside / 1e6, n)


def report_device_time(what, fn, dev, top=6, share_of="hash_encode_kernel",
                       overlap_of=None):
    """One more call of ``fn`` under torch.profiler: its device time by
    kernel, the share of the kernels named ``share_of``, the kernels
    launched and the device's idle share of the call's wall time ("not
    measured" where the profiler sees no device time); with
    ``overlap_of``, how that kernel's launches overlapped the device work
    of other streams (``stream_overlap``).  On the card it traces the
    device's activity alone: every reading here is of device events, and
    tracing the host's ops too slows the call and takes minutes to sum
    over an LM wave's ~200,000 launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA if dev.type == "cuda"
            else ProfilerActivity.CPU]
    sync(dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync(dev)
        wall = 1e3 * (time.perf_counter() - t0)
    by_name = {}           # the kernels' own events, not the host ops'
    n_kernels = 0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CPU and evt.self_device_time_total:
            by_name[evt.key] = evt.self_device_time_total / 1e3
            n_kernels += evt.count
    busy = sum(by_name.values())
    if busy == 0:
        print(f"{what} under torch.profiler ({wall:.1f} ms): device time not "
              f"measured (the profiler recorded none)", flush=True)
        return
    part = sum(v for k, v in by_name.items() if share_of in k)
    heavy = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    print(f"{what} under torch.profiler: {wall:.1f} ms wall, {busy:.1f} ms on "
          f"the device (idle share {1 - busy / wall:.3f}), {n_kernels} "
          f"kernels; {share_of} {part:.1f} ms ({part / busy:.3f} of device "
          f"time); heaviest {[(k[:60], round(v, 3)) for k, v in heavy]}",
          flush=True)
    if overlap_of is not None:
        n, ms, n_o, ms_o, inside, n_in = stream_overlap(prof, overlap_of)
        print(f"{what}: {n} {overlap_of} launches, {ms:.1f} ms on the "
              f"device; {n_o} device events on other streams, {ms_o:.1f} "
              f"ms, of which {inside:.1f} ms ({n_in} events) ran inside a "
              f"{overlap_of} launch", flush=True)


def ground_truth(scene_field, cam, dev):
    """The analytic scene's 512-sample render of ``cam``, in ray chunks."""
    import torch
    from repro_torch.core import scene
    o, d = scene.camera_rays(cam, device=dev)
    step = GT_RAYS_PER_CALL
    rgb = torch.cat([scene.render_reference(scene_field, o[s:s + step],
                                            d[s:s + step])[0]
                     for s in range(0, o.shape[0], step)])
    return rgb.reshape(cam.height, cam.width, 3)


def profile_train_steps(cfg, model_cfg, field, scene_field, dev):
    """``TRAIN_PROFILE_STEPS`` more steps from the trained weights, on one
    batch drawn from the training views' rays (its duplicate corners set
    the gather backward's time), under torch.profiler: the step's device
    time by kernel, kernels launched and idle share."""
    from repro_torch import optim, prng
    from repro_torch.core import train

    o, d, ref = train._make_view_rays(cfg, scene_field, dev)
    _, idx, jitter = train.batch_draws(prng.PRNGKey(cfg.seed), cfg,
                                       o.shape[0], dev)
    opt = optim.AdamWConfig(lr=cfg.lr, b2=0.99, eps=1e-15)
    step = train.make_train_step(cfg, model_cfg, opt)
    state = {"params": field.params()}
    state["opt"] = optim.adamw_init(state["params"], opt)

    def steps():
        for _ in range(TRAIN_PROFILE_STEPS):
            state["params"], state["opt"], _ = step(
                state["params"], state["opt"], o[idx], d[idx], ref[idx],
                jitter, cfg.lr)

    report_device_time(f"[train] {TRAIN_PROFILE_STEPS} steps", steps, dev,
                       share_of="indexing_backward")


def error_by_count(counts, img, fixed, gt) -> dict:
    """{count: (share of pixels, share of the frame's squared error against
    ground truth, share of its excess over fixed-192's)} of a frame."""
    import torch
    err = ((img - gt) ** 2).sum(-1).reshape(-1)
    excess = err - ((fixed - gt) ** 2).sum(-1).reshape(-1)
    out = {}
    for c in torch.unique(counts).tolist():
        m = counts == c
        out[c] = tuple(round(float(x), 4) for x in (
            m.float().mean(), err[m].sum() / err.sum(),
            excess[m].sum() / excess.sum()))
    return out


def run_train(bundle, cam, dev, train_kw=TRAIN):
    """Train the bundle's NGP on the card, then render the trained scene at
    ``cam``: fixed-``ns_full`` and the two-phase frame through the kernel
    field (built from the trained field: it packs the MLP weights when
    built), held against the plain field's two-phase frame; the trained
    frames' launches must show every kernel of FRAME_KERNELS."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import model, rendering, train
    from repro_torch.kernels import ops

    cfg = train.NGPTrainConfig(**train_kw)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    (field, _, scene_field, hist), wall = host_ms(
        lambda: train.train_ngp(cfg, bundle.model, device=dev, verbose=False),
        dev)
    peak = (torch.cuda.max_memory_allocated(dev) / 2**30
            if dev.type == "cuda" else float("nan"))
    step_ms = 1e3 * np.diff([0.0] + [h[2] for h in hist])
    first, last = hist[0][1], hist[-1][1]
    print(f"[train] {cfg.steps} steps of {cfg.batch_rays} rays x "
          f"{cfg.n_samples} samples on {cfg.n_views} views of "
          f"{cfg.view_hw[0]}x{cfg.view_hw[1]} ({cfg.scene}): "
          f"{np.median(step_ms[TRAIN_WARM_STEPS:]):.2f} ms a step (median "
          f"after the first {TRAIN_WARM_STEPS}; first step "
          f"{step_ms[0]:.1f} ms), {hist[-1][2]:.1f} s of steps, "
          f"{wall / 1e3:.1f} s with the views; loss {first:.5f} -> "
          f"{last:.5f} ({last / first:.3f}x); peak memory {peak:.2f} GiB",
          flush=True)
    finite = all(bool(torch.isfinite(b).all()) for b in field.buffers())
    if not (last < TRAIN_LOSS_GATE * first and finite):
        raise AssertionError(f"training: loss {first} -> {last} (gate "
                             f"{TRAIN_LOSS_GATE}x), finite weights {finite}")
    profile_train_steps(cfg, bundle.model, field, scene_field, dev)

    acfg = dataclasses.replace(bundle.asdr, march_backend="fused")
    ns, H, W = acfg.ns_full, cam.height, cam.width
    gt = ground_truth(scene_field, cam, dev)
    fns_k = ops.field_fns(field)
    fns_p = model.field_fns(field)

    def frames():
        return (fixed_reference(fns_k, cam, ns, dev),
                render_frame(fns_k, acfg, cam, dev))

    (fixed, (img_k, st_k, ms_k1)), launches = path_launches(FRAME_KERNELS,
                                                            frames)
    _, ms_fixed = host_ms(lambda: fixed_reference(fns_k, cam, ns, dev), dev)
    _, _, ms_k = render_frame(fns_k, acfg, cam, dev)
    img_p, st_p, ms_p = render_frame(fns_p, acfg, cam, dev)
    p_fixed = float(rendering.psnr(fixed, gt))
    p_k = float(rendering.psnr(img_k, gt))
    p_p = float(rendering.psnr(img_p, gt))
    p_kf = float(rendering.psnr(img_k, fixed))
    print(f"[train] trained frame {H}x{W}: fixed-{ns} through the kernel "
          f"field (chunks of 32,768 rays) {ms_fixed:.1f} ms, PSNR "
          f"{p_fixed:.4f} dB vs ground truth (512 samples); ASDR (kernel "
          f"field, fused march) {ms_k:.1f} ms (first run {ms_k1:.1f}), PSNR "
          f"{p_k:.4f} dB vs ground truth, {p_kf:.4f} dB vs fixed-{ns}; "
          f"gap to fixed-{ns} {p_fixed - p_k:.4f} dB (the paper: ~0.1); "
          f"launches {launches}", flush=True)
    vals, nums = torch.unique(st_k["counts"], return_counts=True)
    budgets = st_k["budgets"].cpu().numpy()
    bv, bn = np.unique(budgets, return_counts=True)
    chunks = st_k["chunks_per_block"].cpu().numpy()
    early = int((chunks < -(-budgets // acfg.chunk)).sum())
    spent = st_k["samples_processed"] + st_k["probe_samples"]
    base = H * W * ns
    print(f"[train] count histogram {dict(zip(vals.tolist(), nums.tolist()))}"
          f"; budgets {bv.tolist()} x {bn.tolist()}; {early} of "
          f"{len(chunks)} blocks exit early; samples {st_k['samples_processed']}"
          f" + probe {st_k['probe_samples']} = {spent} of {H * W} x {ns} = "
          f"{base} ({spent / base:.4f}); fixed-{ns} / ASDR frame time "
          f"{ms_fixed / ms_k:.3f}x (the paper's software-only GPU figure, "
          f"Fig. 24 AS: {PAPER_AS_SPEEDUP}x)", flush=True)
    print(f"[train] by count: {error_by_count(st_k['counts'], img_k, fixed, gt)}",
          flush=True)
    diff = float((st_k["counts"] != st_p["counts"]).float().mean())
    print(f"[train] plain field, same frame: {ms_p:.1f} ms, PSNR {p_p:.4f} "
          f"dB vs ground truth; count-map share differing from the kernel "
          f"path {diff:.3e}; PSNR gap {p_k - p_p:.4f} dB", flush=True)
    if not (all(math.isfinite(x) for x in (p_fixed, p_k, p_p, p_kf))
            and bool(torch.isfinite(img_k).all())
            and bool(torch.isfinite(fixed).all())
            and tuple(img_k.shape) == tuple(fixed.shape) == (H, W, 3)):
        raise AssertionError("non-finite or misshapen trained frame")
    if diff > MAX_COUNT_DIFF:
        raise AssertionError(f"trained count maps differ in {diff:.3e} of "
                             f"pixels (limit {MAX_COUNT_DIFF})")
    if abs(p_k - p_p) > MAX_PSNR_DIFF:
        raise AssertionError(f"trained PSNR gap {p_k - p_p:.4f} dB (limit "
                             f"{MAX_PSNR_DIFF})")
    return field, scene_field


def reuse_trajectory(fns, acfg, cams, fc, dev):
    """[(image, stats, ms)] of render_asdr_image_cached over ``cams`` with
    the reuse state ``fc``, host clock around each synchronised call."""
    from repro_torch import framecache

    return [(*out, ms) for out, ms in (
        host_ms(lambda: framecache.render_asdr_image_cached(
            fns, acfg, cam, fc, device=dev), dev) for cam in cams)]


def reuse_cache():
    """All three reuse tiers at their defaults, the scene-space block tier
    a fresh SceneBlockCache at its default budget."""
    from repro_torch import framecache, scenecache
    return framecache.make_frame_cache(
        scene_cache=scenecache.SceneBlockCache(), scene_id="lego")


def same_stats(a, b) -> bool:
    import torch
    return a.keys() == b.keys() and all(
        torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
        else a[k] == b[k] for k in a)


def replay_hits(store, fns, acfg, cams, dev):
    """Gate (d): the trajectory again with radiance reuse off on ``store``,
    every lookup logged as (key resident after the first pass, resident
    just before the lookup, hit).  Returns (frames, log)."""
    from repro_torch import framecache

    first, log, lookup = set(store._entries), [], store.lookup

    def logged(key, count_miss=True):
        before = key in store._entries
        out = lookup(key, count_miss)
        log.append((key in first, before, out is not None))
        return out

    store.lookup = logged
    try:
        frames = reuse_trajectory(fns, acfg, cams, framecache.make_frame_cache(
            radiance_cfg=None, scene_cache=store, scene_id="lego"), dev)
    finally:
        del store.lookup
    return frames, log


def reuse_host_costs(fns, acfg, cam, cfg, dev):
    """The host's share of a frame the block store misses, on the frame's
    own blocks: the sorted rays' copy to the host, their block keys, and
    the march outputs' copy to the host and stores (ms each)."""
    from repro_torch.kernels import ops
    from repro_torch.scenecache import SceneBlockCache, block_keys

    o_s, d_s, budgets = frame_blocks(fns, acfg, cam, dev)
    host, ms_copy = host_ms(lambda: [t.cpu().numpy()
                                     for t in (o_s, d_s, budgets)], dev)
    keys, ms_keys = host_ms(lambda: block_keys(cfg, "lego", acfg, *host), dev)
    out = ops.fused_march_blocks(fns.fused, acfg, o_s, d_s, budgets)
    store = SceneBlockCache(cfg)

    def stores():
        rgb, acc, dep, ch = (t.cpu().numpy() for t in out[:4])
        for j, (k, cell) in enumerate(keys):
            store.store(k, cell, rgb[j], acc[j], dep[j], int(ch[j]))

    _, ms_store = host_ms(stores, dev)
    print(f"[reuse] host work of a missed frame ({len(keys)} blocks): rays "
          f"to the host {ms_copy:.1f} ms, block keys {ms_keys:.1f} ms, "
          f"outputs to the host and stores {ms_store:.1f} ms", flush=True)


def run_reuse(field, scene_field, bundle, dev, hw, poses=TRAJ_POSES):
    """The cross-frame reuse path on the trained field: the trajectory
    through the kernel field (fused march) with all tiers, each frame
    against a fresh render_asdr_image of its pose and the analytic ground
    truth, then gates (a)-(d).  Returns the trajectory's launches."""
    import dataclasses
    import json
    import torch
    from repro_torch import obs
    from repro_torch.core import model, rendering, scene
    from repro_torch.kernels import ops
    sys.path.insert(0, str(ROOT / "tools"))
    import check_trace

    t0 = time.perf_counter()
    acfg = dataclasses.replace(bundle.asdr, march_backend="fused")
    cams = [scene.look_at_camera(hw[0], hw[1], theta=CAMERA["theta"]
                                 + TRAJ_STEP * k, phi=CAMERA["phi"])
            for k in range(poses)]
    fns_k, fns_p = ops.field_fns(field), model.field_fns(field)
    fc = reuse_cache()
    traj, launches = path_launches(FRAME_KERNELS, lambda: reuse_trajectory(
        fns_k, acfg, cams, fc, dev))
    fresh = [render_frame(fns_k, acfg, cam, dev) for cam in cams]
    gts = [ground_truth(scene_field, cam, dev) for cam in cams]
    print(f"[reuse] {poses} poses of {hw[0]}x{hw[1]} at theta "
          f"{CAMERA['theta']} + {TRAJ_STEP} k, phi {CAMERA['phi']}, kernel "
          f"field, fused march, all tiers (SceneBlockCache budget "
          f"{fc.scene.cfg.byte_budget >> 20} MiB); launches {launches}",
          flush=True)
    for k, ((img, st, ms), (f_img, _, f_ms), gt) in enumerate(
            zip(traj, fresh, gts)):
        print(f"[reuse] frame {k}: {ms:.1f} ms (fresh {f_ms:.1f}); rays "
              f"marched {st['rays_marched']} of {st['rays_total']}; "
              f"{', '.join(f'{f} {st[f]}' for f in REUSE_FLAGS)}; warp valid "
              f"{st['warp_valid_fraction']:.4f}; scene blocks "
              f"{st['scene_block_hits']} hit / {st['scene_block_misses']} "
              f"missed; samples processed {st['samples_processed']}, reused "
              f"{st['samples_reused']}, probe {st['probe_samples']}; PSNR vs "
              f"fresh {float(rendering.psnr(img, f_img)):.4f} dB, vs ground "
              f"truth {float(rendering.psnr(img, gt)):.4f} dB (fresh "
              f"{float(rendering.psnr(f_img, gt)):.4f})", flush=True)
    total, total_f = sum(t[2] for t in traj), sum(f[2] for f in fresh)
    print(f"[reuse] trajectory {total:.1f} ms against {total_f:.1f} ms "
          f"rendered fresh ({total_f / total:.3f}x); rays marched "
          f"{sum(t[1]['rays_marched'] for t in traj)} of "
          f"{sum(t[1]['rays_total'] for t in traj)}; scene cache "
          f"{fc.scene.stats()}", flush=True)
    reuse_host_costs(fns_k, acfg, cams[0], fc.scene.cfg, dev)
    if not all(bool(torch.isfinite(t[0]).all())
               and tuple(t[0].shape) == (hw[0], hw[1], 3) for t in traj):
        raise AssertionError("[reuse]: non-finite or misshapen frame")
    a_ok = (torch.equal(traj[0][0], fresh[0][0])
            and torch.equal(traj[0][1]["counts"], fresh[0][1]["counts"]))
    print(f"[reuse] gate (a): frame 0, all tiers cold, bit-equal to "
          f"render_asdr_image (image and count map): {a_ok}", flush=True)
    if not a_ok:
        raise AssertionError("[reuse] gate (a): the cold frame differs from "
                             "render_asdr_image")

    # (b) the plain field's trajectory against the kernel field's
    plain = reuse_trajectory(fns_p, acfg, cams, reuse_cache(), dev)
    worst = [0.0, 0.0, 0.0]
    flags_eq = True
    for (img, st, _), (img_p, st_p, _), gt in zip(traj, plain, gts):
        flags_eq &= all(st[f] == st_p[f] for f in REUSE_FLAGS)
        worst[0] = max(worst[0], abs(st["rays_marched"] - st_p["rays_marched"])
                       / st["rays_total"])
        if st["counts"] is not None and st_p["counts"] is not None:
            worst[1] = max(worst[1], float(
                (st["counts"] != st_p["counts"]).float().mean()))
        worst[2] = max(worst[2], abs(float(rendering.psnr(img, gt))
                                     - float(rendering.psnr(img_p, gt))))
    print(f"[reuse] gate (b): plain field, same trajectory "
          f"({sum(t[2] for t in plain):.1f} ms): flags equal {flags_eq}; "
          f"worst rays-marched gap {worst[0]:.3e} of the rays, count-map "
          f"share {worst[1]:.3e}, PSNR gap vs ground truth {worst[2]:.4f} "
          f"dB", flush=True)
    if not (flags_eq and worst[0] <= MAX_COUNT_DIFF
            and worst[1] <= MAX_COUNT_DIFF and worst[2] <= MAX_PSNR_DIFF):
        raise AssertionError("[reuse] gate (b): the plain field's trajectory "
                             "differs from the kernel field's")
    del plain

    # (c) the same trajectory with a tracer installed
    tracer = obs.Tracer(obs.TraceConfig())
    obs.install(tracer)
    try:
        traced = reuse_trajectory(fns_k, acfg, cams, reuse_cache(), dev)
    finally:
        obs.uninstall(tracer)
    tracer.drain()
    c_ok = all(torch.equal(a[0], b[0]) and same_stats(a[1], b[1])
               for a, b in zip(traj, traced))
    by_name = {}
    for sp in tracer.spans:
        n, ms = by_name.get(sp.name, (0, 0.0))
        by_name[sp.name] = (n + 1, ms + sp.dur_ms)
    export = json.loads(json.dumps(obs.export.chrome_trace(
        tracer.spans, tracer.export_origin(), tracer.dropped), default=str))
    bad = check_trace.validate(export)
    missing = [n for n in REUSE_SPANS if n not in by_name]
    print(f"[reuse] gate (c): traced trajectory bit-identical (frames and "
          f"stats) {c_ok} ({sum(t[2] for t in traced):.1f} ms); spans "
          f"{ {n: (c, round(ms, 1)) for n, (c, ms) in by_name.items()} }; "
          f"{len(export['traceEvents'])} events exported, "
          f"{len(bad)} schema findings; missing spans {missing}", flush=True)
    if not c_ok or bad or missing:
        raise AssertionError(f"[reuse] gate (c): traced run differs "
                             f"({not c_ok}), export {bad[:3]}, missing "
                             f"spans {missing}")
    del traced

    # (d) replay without radiance reuse on the same block store
    replay, log = replay_hits(fc.scene, fns_k, acfg, cams, dev)
    kept = sum(1 for first, before, _ in log if first and before)
    hits = sum(1 for _, _, hit in log if hit)
    whole = [k for k, t in enumerate(traj)
             if t[1]["rays_marched"] == t[1]["rays_total"]]
    back = [k for k in whole if torch.equal(replay[k][0], traj[k][0])
            and torch.equal(replay[k][1]["counts"], traj[k][1]["counts"])]
    d_ok = (all(before == hit for _, before, hit in log) and kept > 0
            and hits == sum(r[1]["scene_block_hits"] for r in replay)
            and back == whole)
    print(f"[reuse] gate (d): replay without radiance reuse "
          f"({sum(r[2] for r in replay):.1f} ms; per frame "
          f"{[round(r[2], 1) for r in replay]} ms, block hits "
          f"{[r[1]['scene_block_hits'] for r in replay]}): {len(log)} "
          f"lookups, {hits} hits, {kept} of them blocks the first pass left "
          f"resident; every resident block hit: "
          f"{all(b == h for _, b, h in log)}; whole-march frames {whole} "
          f"bit-equal: {back}", flush=True)
    if not d_ok:
        raise AssertionError("[reuse] gate (d): the replay missed a resident "
                             "block or changed a frame")
    print(f"[reuse] phase {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# The [serve] phase: the render serving engine over two scenes at the
# paper's widths, both through the kernel field and the fused march: the
# trained lego field of [train] and the random field of phases 2-4.  Three
# viewers, closed loop, enqueued k-major as the launcher interleaves
# scenes: viewers 0 and 1 on lego and viewer 2 on the random field, each
# at [reuse]'s first SERVE_POSES poses.  The engine at the reference's
# defaults (slots 4, blocks of 16 a batch, prefetch 2) with every reuse
# tier at its defaults and a 32 MiB block store.
SERVE_POSES = 8
SERVE_VIEWERS = ("lego", "lego", "random")
SERVE_STORE_BYTES = 32 << 20
SERVE_REPLAY_POSES = 4          # gate (e): two viewers replay these
SERVE_WIDE_BATCH = 64           # one extra reading, blocks of 64 a batch
SERVE_FLEET_STORE_BYTES = 256 << 20   # gate (g): holds every frame's blocks
SERVE_FLEET_SHARDS = 4
SERVE_FLAGS = ("probe_reused", "probe_skipped", "radiance_reused")
SERVE_READINGS = (
    "latency_ms_p50", "latency_ms_p99", "admit_stall_ms_p50",
    "admit_stall_ms_p99", "march_ms_p50", "march_ms_p99", "batches",
    "pad_block_fraction", "rays_marched_fraction", "reused_probe_fraction",
    "reused_radiance_fraction", "scene_block_hit_rate", "misprepares",
    "pack_cache_hits", "pack_cache_misses", "pack_cache_size")


def serve_cams(hw, poses=SERVE_POSES):
    from repro_torch.core import scene
    return [scene.look_at_camera(hw[0], hw[1], theta=CAMERA["theta"]
                                 + TRAJ_STEP * k, phi=CAMERA["phi"])
            for k in range(poses)]


def serve_requests(cams, viewers=SERVE_VIEWERS):
    """The k-major traffic: request 3k + v is viewer v at pose k."""
    from repro_torch.serve import RenderRequest
    return [RenderRequest(rid=len(viewers) * k + v, scene=s, cam=cam)
            for k, cam in enumerate(cams) for v, s in enumerate(viewers)]


def serve_config(full=True, **kw):
    """The engine's configuration: the reference's defaults with every
    reuse tier on (``full``), or with every tier off (the identity
    configuration of gate (a))."""
    from repro_torch import framecache, scenecache
    from repro_torch.serve import RenderServeConfig
    tiers = dict(reuse=framecache.ProbeReuseConfig(),
                 radiance=framecache.RadianceReuseConfig(),
                 scenecache=scenecache.SceneCacheConfig(
                     byte_budget=SERVE_STORE_BYTES)) if full else dict(
        reuse=None, radiance=None, scenecache=None, prefetch=0)
    return RenderServeConfig(**{**tiers, **kw})


def timed_calls(module, name, log):
    """Replace ``module.name`` by a wrapper that appends each call's host
    seconds to ``log``; returns the function that restores it."""
    real = getattr(module, name)

    def wrapper(*args, **kw):
        t = time.perf_counter()
        out = real(*args, **kw)
        log.append(time.perf_counter() - t)
        return out

    setattr(module, name, wrapper)
    return lambda: setattr(module, name, real)


def serve_run(fields, acfg, rcfg, reqs, dev, trace=False):
    """One engine over ``fields`` serving ``reqs`` closed loop, host clock
    around the synchronised call.  Returns ({rid: request}, engine_stats,
    wall ms, the tracer's (spans, export origin) or None)."""
    import dataclasses
    from repro_torch import obs
    from repro_torch.serve import RenderServingEngine

    if trace:
        rcfg = dataclasses.replace(rcfg, trace=obs.TraceConfig())
    eng = RenderServingEngine(fields, acfg, rcfg, device=dev)
    try:
        done, ms = host_ms(lambda: eng.render(reqs), dev)
        spans = None
        if eng.tracer is not None:
            eng.tracer.drain()
            spans = (list(eng.tracer.spans), eng.tracer.export_origin())
        return {r.rid: r for r in done}, eng.engine_stats(), ms, spans
    finally:
        eng.close()


def stage_a_cards(dev):
    """(cards, one_card, restore): the secondary cards a DeviceExecutor
    places Stage A on — ``cuda:1`` .. where the host has them, else the
    engine's own card through the ``executor._available_devices`` hook —
    and the function that restores the hook."""
    from repro_torch.serve import executor as executor_lib
    real = executor_lib._available_devices
    cards = real()[1:]
    if cards:
        return cards, False, lambda: None
    card = executor_lib.indexed(dev)
    executor_lib._available_devices = lambda: [card, card]
    return [card], True, lambda: setattr(executor_lib,
                                         "_available_devices", real)


def placed_serve(fields, acfg, rcfg, reqs, dev, one_card, scenecache=None):
    """``serve_run`` through a DeviceExecutor (``rcfg.devices`` > 0), each
    Stage A's placement recorded.  On one card every Stage A runs on a
    replica of its field built there: the engine's own card would use the
    fields themselves, so the replicas' home is named off the card.
    Returns ({rid: request}, engine_stats, wall ms, [(placement, current
    card)] of each prepare, {(scene, card): replica})."""
    import threading
    import torch
    from repro_torch.serve import RenderServingEngine, admission
    from repro_torch.serve import executor as executor_lib

    seen, lock = [], threading.Lock()
    real = admission.prepare

    def recording(engine, req):
        with lock:
            seen.append((executor_lib.placement(),
                         torch.cuda.current_device()
                         if torch.cuda.is_available() else None))
        return real(engine, req)

    eng = RenderServingEngine(fields, acfg, rcfg, device=dev,
                              scenecache=scenecache)
    if not isinstance(eng.executor, executor_lib.DeviceExecutor):
        raise AssertionError(f"[serve] devices={rcfg.devices} gave a "
                             f"{type(eng.executor).__name__}")
    if one_card:
        eng.replicas.device = torch.device("meta")
    admission.prepare = recording
    try:
        done, ms = host_ms(lambda: eng.render(reqs), dev)
        return ({r.rid: r for r in done}, eng.engine_stats(), ms, seen,
                dict(eng.replicas.built))
    finally:
        admission.prepare = real
        eng.close()


def placements(seen) -> dict:
    """{placement card (or "engine thread"): prepares} of a placed run."""
    out = {}
    for placed, current in seen:
        tag = (f"{placed} (current cuda:{current})" if placed is not None
               else "engine thread, unplaced")
        out[tag] = out.get(tag, 0) + 1
    return out


def serve_reading(tag, done, st, ms):
    sc = st.get("scenecache") or {}
    print(f"[serve] {tag}: {len(done)} frames in {ms:.1f} ms "
          f"({1e3 * len(done) / ms:.2f} frames/s); "
          + "; ".join(f"{k} {st[k]:.4g}" if isinstance(st[k], float)
                      else f"{k} {st[k]}" for k in SERVE_READINGS)
          + f"; blocks marched {st['blocks_marched']}, scene block hits "
          f"{st['scene_block_hits']}; store resident "
          f"{sc.get('resident_bytes', 0)} B, evictions "
          f"{sc.get('evictions', 0)}; batches a round "
          f"{st['batches_per_round']}", flush=True)


def same_serving(a, b, st_a, st_b) -> bool:
    """Frames bit for bit and the deterministic counters equal."""
    import numpy as np
    from repro_torch.serve.stats import DETERMINISTIC_COUNTERS
    return (a.keys() == b.keys()
            and all(np.array_equal(a[r].image, b[r].image) for r in a)
            and all(st_a[c] == st_b[c] for c in DETERMINISTIC_COUNTERS))


def run_serve(field_t, scene_t, field_r, bundle, dev, hw):
    """The render serving engine through the kernel path: the traffic's
    readings, the same requests one by one through render_asdr_image, then
    gates (a)-(g).  Returns the serve run's launches."""
    import dataclasses
    import json
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.core import model, pipeline, rendering
    from repro_torch.serve.stats import DETERMINISTIC_COUNTERS
    from repro_torch.kernels import ops
    from repro_torch.scenecache import key as scenecache_key
    sys.path.insert(0, str(ROOT / "tools"))
    import check_trace

    t0 = time.perf_counter()
    acfg = dataclasses.replace(bundle.asdr, march_backend="fused")
    fields = {"lego": ops.field_fns(field_t), "random": ops.field_fns(field_r)}
    cams = serve_cams(hw)
    B, R = acfg.block_size, hw[0] * hw[1]
    full = serve_config()

    # the main path: the full configuration at the reference's defaults,
    # the host's block keys timed (they run on the engine thread)
    key_s = []
    restore = timed_calls(scenecache_key, "block_keys", key_s)
    try:
        (done, st, ms, _), launches = path_launches(
            FRAME_KERNELS, lambda: serve_run(fields, acfg, full,
                                             serve_requests(cams), dev))
    finally:
        restore()
    print(f"[serve] {len(SERVE_VIEWERS)} viewers {SERVE_VIEWERS} x "
          f"{SERVE_POSES} poses of {hw[0]}x{hw[1]} (theta {CAMERA['theta']} "
          f"+ {TRAJ_STEP} k, phi {CAMERA['phi']}), k-major, kernel field, "
          f"fused march; slots {full.slots}, blocks of {full.blocks_per_batch}"
          f" a batch ({full.blocks_per_batch * B} rays), prefetch "
          f"{full.prefetch}; all tiers, store {SERVE_STORE_BYTES >> 20} MiB; "
          f"launches {launches}", flush=True)
    serve_reading("full, prefetch 2", done, st, ms)
    print(f"[serve] host block keys: {1e3 * sum(key_s):.1f} ms in "
          f"{len(key_s)} calls ({sum(key_s) / ms * 1e3:.3f} of the wall)",
          flush=True)
    for rid, r in sorted(done.items()):
        s = r.stats
        print(f"[serve] request {rid} ({r.scene}, pose {rid // 3}): latency "
              f"{1e3 * r.latency_s:.1f} ms, stall "
              f"{1e3 * s['admit_stall_s']:.1f} ms; rays marched "
              f"{s['rays_marched']}; "
              f"{', '.join(f'{f} {s[f]}' for f in SERVE_FLAGS)}; block hits "
              f"{s['scene_block_hits']}; samples {s['samples_processed']} + "
              f"probe {s['probe_samples']}, reused {s['samples_reused']}",
              flush=True)
    if not all(np.isfinite(r.image).all() and r.image.shape == (*hw, 3)
               for r in done.values()):
        raise AssertionError("[serve]: non-finite or misshapen frame")

    # the same requests one by one through render_asdr_image
    reqs = serve_requests(cams)
    single, ms_single = {}, 0.0
    for r in reqs:
        (img, st1), ms1 = host_ms(lambda: pipeline.render_asdr_image(
            fields[r.scene], acfg, r.cam, device=dev), dev)
        single[r.rid] = (img.cpu().numpy(), st1["samples_processed"],
                         st1["probe_samples"])
        ms_single += ms1
    print(f"[serve] the same {len(reqs)} requests one by one through "
          f"render_asdr_image: {ms_single:.1f} ms ({ms_single / ms:.3f}x the "
          f"engine's wall); the frame's march alone on 157 blocks took "
          f"~95 ms (PERF.md §5), a pooled batch's march here p50 "
          f"{st['march_ms_p50']:.1f} ms", flush=True)

    # (a) identity: every tier off, no prefetch
    ident, st_i, ms_i, _ = serve_run(fields, acfg, serve_config(False),
                                     serve_requests(cams), dev)
    serve_reading("identity (tiers off, prefetch 0)", ident, st_i, ms_i)
    a_bad = [rid for rid, r in ident.items()
             if not (np.array_equal(r.image, single[rid][0])
                     and r.stats["samples_processed"] == single[rid][1]
                     and r.stats["probe_samples"] == single[rid][2])]
    print(f"[serve] gate (a): every request bit-equal to render_asdr_image "
          f"(image, samples, probe samples): {not a_bad}", flush=True)
    if a_bad:
        raise AssertionError(f"[serve] gate (a): requests {a_bad} differ "
                             f"from render_asdr_image")

    # (b) executor invariance
    runs = {"prefetch 0": serve_run(fields, acfg, dataclasses.replace(
        full, prefetch=0), serve_requests(cams), dev),
        "prefetch 2, workers 2": serve_run(fields, acfg, dataclasses.replace(
            full, workers=2), serve_requests(cams), dev)}
    for tag, (d, s, m, _) in runs.items():
        serve_reading(f"full, {tag}", d, s, m)
    inflight_i = serve_run(fields, acfg, serve_config(False, inflight_batches=2),
                           serve_requests(cams), dev)
    serve_reading("identity, inflight 2", *inflight_i[:3])
    inflight_f = serve_run(fields, acfg, dataclasses.replace(
        full, inflight_batches=2), serve_requests(cams), dev)
    serve_reading("full, inflight 2", *inflight_f[:3])
    b_ok = {tag: same_serving(done, d, st, s)
            for tag, (d, s, _, _) in runs.items()}
    b_ok["identity, inflight 2"] = same_serving(ident, inflight_i[0], st_i,
                                                inflight_i[1])
    f_same = same_serving(done, inflight_f[0], st, inflight_f[1])
    print(f"[serve] gate (b): bit-identical frames and counters against the "
          f"prefetch-2 run {b_ok}; full configuration at inflight 2 (moves "
          f"when frames finish, so what later admissions find cached; not "
          f"gated): same {f_same}, counters "
          f"{ {c: inflight_f[1][c] for c in DETERMINISTIC_COUNTERS} }",
          flush=True)
    if not all(b_ok.values()):
        raise AssertionError(f"[serve] gate (b): {b_ok}")
    wide = serve_run(fields, acfg, dataclasses.replace(
        full, blocks_per_batch=SERVE_WIDE_BATCH), serve_requests(cams), dev)
    serve_reading(f"full, blocks of {SERVE_WIDE_BATCH} a batch", *wide[:3])
    plain_w = runs["prefetch 2, workers 2"]
    del runs, inflight_i, inflight_f, wide

    # (c) tracing, with the worker streams on
    traced = serve_run(fields, acfg, dataclasses.replace(full, workers=2),
                       serve_requests(cams), dev, trace=True)
    spans, origin = traced[3]
    export = json.loads(json.dumps(obs.export.chrome_trace(
        spans, origin, 0), default=str))
    bad = check_trace.validate(export)
    lanes = {s.lane for s in spans if s.name == "executor.run"}
    disp = {s.attrs["batch"]: s.attrs["reqs"] for s in spans
            if s.name == "pool.dispatch"}
    coll = {s.attrs["batch"]: s.attrs["reqs"] for s in spans
            if s.name == "pool.collect"}
    c_ok = (same_serving(plain_w[0], traced[0], plain_w[1], traced[1])
            and not bad and lanes and all(l.startswith("serve-stage-a")
                                          for l in lanes)
            and disp and disp == coll)
    by_name = {}
    for sp in spans:
        n, t = by_name.get(sp.name, (0, 0.0))
        by_name[sp.name] = (n + 1, t + sp.dur_ms)
    print(f"[serve] gate (c): traced run (workers 2, {traced[2]:.1f} ms) "
          f"bit-identical to the untraced ({plain_w[2]:.1f} ms): "
          f"{same_serving(plain_w[0], traced[0], plain_w[1], traced[1])}; "
          f"{len(export['traceEvents'])} events, {len(bad)} schema findings; "
          f"executor.run lanes {sorted(lanes)}; {len(disp)} dispatch / "
          f"{len(coll)} collect batch ids matching: {disp == coll}; spans "
          f"{ {n: (c, round(t, 1)) for n, (c, t) in sorted(by_name.items())} }",
          flush=True)
    if not c_ok:
        raise AssertionError(f"[serve] gate (c): findings {bad[:3]}, lanes "
                             f"{lanes}, batches matching {disp == coll}")
    del plain_w, traced, spans, export

    # (d) viewer 0 alone on the plain field against the kernel field
    v0 = serve_requests(cams, viewers=("lego",))
    kern = serve_run({"lego": fields["lego"]}, acfg, full, v0, dev)
    plain = serve_run({"lego": model.field_fns(field_t)}, acfg, full,
                      serve_requests(cams, viewers=("lego",)), dev)
    gts = [ground_truth(scene_t, cam, dev) for cam in cams]
    worst, flags_eq = [0.0, 0.0, 0.0], True
    for k, gt in enumerate(gts):
        a, b = kern[0][k], plain[0][k]
        flags_eq &= all(a.stats[f] == b.stats[f] for f in SERVE_FLAGS)
        worst[0] = max(worst[0], abs(a.stats["rays_marched"]
                                     - b.stats["rays_marched"]) / R)
        worst[1] = max(worst[1], abs(a.stats["samples_processed"]
                                     - b.stats["samples_processed"])
                       / max(a.stats["samples_processed"], 1))
        worst[2] = max(worst[2], abs(
            float(rendering.psnr(torch.from_numpy(a.image).to(dev), gt))
            - float(rendering.psnr(torch.from_numpy(b.image).to(dev), gt))))
    print(f"[serve] gate (d): viewer 0 alone, kernel field {kern[2]:.1f} ms, "
          f"plain field {plain[2]:.1f} ms: flags equal {flags_eq}; worst "
          f"rays-marched gap {worst[0]:.3e} of the rays, samples gap "
          f"{worst[1]:.3e}, PSNR gap vs ground truth {worst[2]:.4f} dB",
          flush=True)
    if not (flags_eq and worst[0] == 0.0
            and worst[1] <= MAX_COUNT_DIFF and worst[2] <= MAX_PSNR_DIFF):
        raise AssertionError("[serve] gate (d): the plain field's requests "
                             "differ from the kernel field's")
    del kern, plain, gts

    # (e) two viewers replay the same lego poses through the block store
    store_only = serve_config(reuse=None, radiance=None)
    rp = serve_cams(hw, SERVE_REPLAY_POSES)
    alone, st_alone, _, _ = serve_run({"lego": fields["lego"]}, acfg,
                                      store_only, serve_requests(
                                          rp, viewers=("lego",)), dev)
    both, st_both, ms_both, _ = serve_run(
        {"lego": fields["lego"]}, acfg, store_only,
        serve_requests(rp, viewers=("lego", "lego")), dev)
    n_blocks = -(-R // B)
    second = [both[2 * k + 1] for k in range(SERVE_REPLAY_POSES)]
    first = [both[2 * k] for k in range(SERVE_REPLAY_POSES)]
    e_ok = (all(s.stats["scene_block_hits"] == n_blocks
                and s.stats["samples_processed"] == 0 for s in second)
            and st_both["blocks_marched"] == st_alone["blocks_marched"]
            and all(np.array_equal(f.image, s.image)
                    for f, s in zip(first, second)))
    serve_reading("store only, two viewers", both, st_both, ms_both)
    print(f"[serve] gate (e): the second viewer's {SERVE_REPLAY_POSES} "
          f"frames: block hits {[s.stats['scene_block_hits'] for s in second]}"
          f" of {n_blocks}, samples {[s.stats['samples_processed'] for s in second]}"
          f"; blocks marched {st_both['blocks_marched']} against "
          f"{st_alone['blocks_marched']} for the first viewer alone; frames "
          f"bit-equal to the first viewer's: "
          f"{all(np.array_equal(f.image, s.image) for f, s in zip(first, second))}",
          flush=True)
    if not e_ok:
        raise AssertionError("[serve] gate (e): the second viewer marched or "
                             "its frames differ")
    del alone, both

    run_serve_fleet(fields, acfg, full, (done, st), cams, dev, hw)

    # device time by kernel, Stage A inline and on two worker streams
    for workers in (0, 2):
        report_device_time(
            f"[serve] full, workers {workers}", lambda: serve_run(
                fields, acfg, dataclasses.replace(full, workers=workers),
                serve_requests(cams), dev), dev, share_of="fused_march",
            overlap_of="fused_march")
    print(f"[serve] phase {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def run_serve_fleet(fields, acfg, full, ref, cams, dev, hw):
    """[serve]'s gates (f) and (g): the full configuration's traffic with
    Stage A placed by a DeviceExecutor against ``ref`` (the prefetch-2
    run's frames and stats), then two placed engine replicas over one
    ShardedSceneCache against a plain sync engine."""
    import dataclasses
    import numpy as np
    done, st = ref

    # (f) Stage A placed by a DeviceExecutor, on replicas of the fields
    cards, one_card, restore = stage_a_cards(dev)
    try:
        f_cfg = dataclasses.replace(full, devices=len(cards))
        (f_done, f_st, f_ms, seen, built), f_launches = path_launches(
            FRAME_KERNELS, lambda: placed_serve(
                fields, acfg, f_cfg, serve_requests(cams), dev, one_card))
        serve_reading(f"full, Stage A placed on {[str(c) for c in cards]}",
                      f_done, f_st, f_ms)
        copies = {f"{sc} on {c}": r.fused is not None and (
            r.fused.tables.data_ptr() != fields[sc].fused.tables.data_ptr())
            for (sc, c), r in built.items()}
        f_same = same_serving(done, f_done, st, f_st)
        print(f"[serve] gate (f): {len(seen)} Stage A runs, "
              f"{sum(p is not None for p, _ in seen)} placed: "
              f"{placements(seen)}; replicas built (own copy of the tables): "
              f"{copies}; launches {f_launches}; bit-identical frames and "
              f"counters against the prefetch-2 run: {f_same}"
              + (" (one card: placed on the engine's own card, no copy "
                 "between cards)" if one_card else ""), flush=True)
        if not (f_same and any(p is not None for p, _ in seen)
                and all(p is None or p in cards for p, _ in seen)
                and (not one_card or (len(built) == len(fields)
                                      and all(copies.values())))):
            raise AssertionError("[serve] gate (f): the placed run differs "
                                 "or placed nothing")
        del f_done, seen, built

        # (g) two engine replicas over one ShardedSceneCache
        from repro_torch.scenecache import SceneCacheConfig, ShardedSceneCache

        def replica_requests(k):
            reqs = serve_requests(serve_cams(hw, SERVE_REPLAY_POSES))
            for r in reqs:
                r.rid += 100 * k
            return reqs

        g_reqs = replica_requests(0)
        plain_g, _, plain_ms, _ = serve_run(fields, acfg, serve_config(
            False), g_reqs, dev)
        shared = ShardedSceneCache(SceneCacheConfig(
            byte_budget=SERVE_FLEET_STORE_BYTES), shards=SERVE_FLEET_SHARDS)
        g_cfg = serve_config(False, prefetch=2, devices=len(cards))
        try:
            reps, g_launches = path_launches(FRAME_KERNELS, lambda: [
                placed_serve(fields, acfg, g_cfg, replica_requests(k), dev,
                             one_card, scenecache=shared)
                for k in range(2)])
            sst = shared.stats()
        finally:
            shared.close()
        g_equal = all(np.array_equal(r.image, plain_g[rid % 100].image)
                      for rep in reps for rid, r in rep[0].items())
        hits = [rep[1]["scene_block_hits"] for rep in reps]
        within = all(b <= sst["per_shard_budget"]
                     for b in sst["per_shard_resident_bytes"])
        for k, rep in enumerate(reps):
            serve_reading(f"fleet replica {k}", *rep[:3])
        print(f"[serve] gate (g): two replicas ({len(g_reqs)} requests "
              f"each, Stage A placed on {[str(c) for c in cards]}) over one "
              f"ShardedSceneCache of {SERVE_FLEET_SHARDS} shards: every frame "
              f"bit-equal to a plain sync engine's ({plain_ms:.1f} ms): "
              f"{g_equal}; block hits by replica {hits}; per-shard bytes "
              f"{sst['per_shard_resident_bytes']} against "
              f"{sst['per_shard_budget']} each; evictions "
              f"{sst['evictions']}; launches {g_launches}", flush=True)
        if not (g_equal and hits[1] > 0 and within):
            raise AssertionError(f"[serve] gate (g): frames equal {g_equal},"
                                 f" hits {hits}, within budget {within}")
        del reps, plain_g
    finally:
        restore()


def run_decoupled(field, bundle, cam, ref, dev, reps=3):
    """The §4.3 decoupled frame through the kernel field in ray chunks,
    then one volume_render launch on its kept samples.  Returns the
    volume_render row and its launches on the path."""
    import torch
    from repro_torch.core import decouple, rendering, scene
    from repro_torch.kernels import ops
    from repro_torch.kernels import volume_render as VR

    acfg = bundle.asdr
    S, g, wb = acfg.ns_full, acfg.group, acfg.white_background
    H, W = cam.height, cam.width
    R, step = H * W, DECOUPLED_RAYS_PER_CALL
    fns = ops.field_fns(field)
    o, d = scene.camera_rays(cam, device=dev)

    def frame():
        parts = [decouple.render_decoupled(fns, o[s:s + step], d[s:s + step],
                                           S, group=g, white_background=wb,
                                           keep_samples=True)
                 for s in range(0, R, step)]
        rgb = torch.cat([p[0] for p in parts])
        kept = [torch.cat([p[1][k] for p in parts])
                for k in ("sigmas", "anchor_colors", "deltas")]
        del parts
        vr_rgb, _ = ops.volume_render(*kept, g, white_background=wb)
        return rgb, kept, vr_rgb

    sync(dev)
    t0 = time.perf_counter()
    (rgb, (sig, anch, dl), vr_rgb), launches = path_launches(
        DECOUPLED_KERNELS, frame)
    sync(dev)
    ms_frame = 1e3 * (time.perf_counter() - t0)
    A = anch.shape[1]
    print(f"[decoupled] frame (render_decoupled in chunks of {step} rays, "
          f"then volume_render on R={R} S={S} A={A}): {ms_frame:.1f} ms; "
          f"launches {launches}", flush=True)
    report_device_time("[decoupled] frame", frame, dev)

    err_f, ok_f = max_err(vr_rgb, rgb)
    print(f"[decoupled] volume_render rgb vs render_decoupled rgb: "
          f"max_abs_err={err_f:.3e}", flush=True)
    if not ok_f:
        raise AssertionError(f"volume_render's frame differs from "
                             f"render_decoupled's (max abs err {err_f})")
    out, ms = timed(lambda: VR.volume_render(sig, dl, anch, g), dev, reps)
    out_p, plain_ms = timed(lambda: VR.volume_render_plain(sig, dl, anch, g),
                            dev, 1)
    print(f"[decoupled] volume_render bit-equal to its plain version: "
          f"{torch.equal(out, out_p)}", flush=True)
    row = kernel_row("volume_render", "volume_render.cu",
                     "src/repro/kernels/volume_render.py:75", out, out_p, ms,
                     plain_ms, flop=VOLUME_RENDER_FLOP * R * S,
                     nbytes=4 * (2 * R * S + 3 * R * A + 4 * R), exact=True)
    del out, out_p, sig, anch, dl, vr_rgb
    check_volume_render_ragged(dev)

    naive = torch.cat([decouple.render_naive_reduced(
        fns, o[s:s + step], d[s:s + step], S, factor=2)
        for s in range(0, R, step)])
    saved = decouple.mlp_flops_saved(bundle.model, S, g)
    for tag, img in ((f"decoupled group {g}", rgb), (f"naive {S // 2} samples",
                                                     naive)):
        img = img.reshape(H, W, 3)
        p, q = float(rendering.psnr(img, ref)), float(rendering.ssim(img, ref))
        print(f"[decoupled] {tag} vs plain fixed-{S}: PSNR {p:.4f} dB, "
              f"SSIM {q:.5f}", flush=True)
        if not (math.isfinite(p) and math.isfinite(q)
                and bool(torch.isfinite(img).all())):
            raise AssertionError(f"{tag}: non-finite frame")
    print(f"[decoupled] MLP FLOPs saved by decoupling (analytic): "
          f"{saved['reduction_fraction']:.4f}", flush=True)
    return row, {"volume_render": launches["volume_render"]}


# The [lm] phase: gemma2-27b (configs/gemma2_27b.py CONFIG) served at full
# width through lm.build -> ServingEngine.generate, prefill attention on the
# flash kernel.  Random weights from PRNGKey(LM_INIT_SEED), stored once in
# the config's bf16 (54.5 GB; the reference casts its fp32 masters to bf16
# at every use).  Two waves of prompts drawn with numpy from SEED: wave A,
# 4 prompts of 512 tokens (inside the 4,096 window: every cache linear);
# wave B, one prompt of 4,608 tokens, past the window (its local layers
# decode through a 4,096-slot ring).  LM_MAX_SEQ holds wave B's prompt
# and new tokens, plus the reference launcher's 8 spare slots.
LM_WAVES = ((4, 512, 32), (1, 4608, 32))   # (requests, prompt, max_new)
LM_SLOTS = 4
LM_MAX_SEQ = 4608 + 32 + 8
LM_INIT_SEED = 0
LM_SAMPLE_SEED = 0                 # the temperature-1.0 run of wave A
# Gate (a): fp32 at full width, depth cut, the kernel build against the
# plain build on the same weights (gemma2-27b: one local, one global layer).
LM_GATE_LAYERS = 2
LM_GATE_ATOL = 1e-3
LM_REPS = 20                       # CUDA-event repeats of the attention
# The [moe] and [ssm] phases: deepseek-moe-16b (28 MoE layers of 64 experts
# top-6 + 2 shared, d_model 2,048, MHA 16 x 128), then mamba2-780m (48
# attention-free SSD layers) and hymba-1.5b (32 layers of parallel
# attention, GQA 25 / 5 x 64, window 1,024 but the first, middle and last
# layers global, and SSD heads), each at full width and depth in bf16
# through lm.build -> ServingEngine.generate, the same way as [lm].  Wave
# B's 4,096 tokens are four MoE groups of 1,024 (the reference asserts
# that the group size divides the tokens: 4,608 is refused); hymba's
# passes its 1,024 window, so its local layers decode through the ring.
FAMILY_WAVES = ((4, 512, 32), (1, 4096, 32))
FAMILY_MAX_SEQ = 4096 + 32 + 8
FAMILIES = (("deepseek_moe_16b", "[moe]"), ("mamba2_780m", "[ssm]"),
            ("hymba_1_5b", "[ssm]"))
# Gate (a)'s depth: hymba needs 4 layers for a local one (its ends_global
# pattern makes layers 0, n // 2 and n - 1 global: 3 layers are all global).
FAMILY_GATE_LAYERS = {"deepseek-moe-16b": 2, "mamba2-780m": 2,
                      "hymba-1.5b": 4}
# Gate (a)'s decode-against-forward check on a MoE runs without drops, as
# the reference's own (tests/test_models.py:50-76): capacity factor 8, and
# one routing group a sequence (the forward over 4,096 + s tokens is no
# multiple of 1,024; without drops the output does not depend on the
# grouping, which the check asserts by counting drops).
GATE_CAPACITY = 8.0
MAX_FLIP_SHARE = 1e-3              # routed token-layers whose experts differ
# gemma3-12b in [lm]: gate (a) at 6 layers, five local (window 1,024) and
# layer 5 global, its 5:1 pattern's first period.
WIDE_GATE_LAYERS = 6
# The [vlm] phase: paligemma-3b served at full width and depth through
# api.prefill_fn / api.decode_fn (the engine passes no img_embeds, as the
# reference's): requests of an image prefix of 256 numpy-seeded embeddings
# and a prompt of 512 tokens, 32 new tokens each, greedy; gate at 2 layers
# in fp32.  The [encdec] phase: whisper-medium (24 + 24 layers) on 1,500
# frames a request, a prompt of 64 tokens decoded one at a time from
# position 0 over the cross K/V (the reference's serving flow: prefill_fn
# hands over no self-KV cache), then 32 new; gate at 2 + 2 layers in fp32.
VLM_RUN = (4, 512, 32)             # (requests, prompt, new tokens)
ENCDEC_RUN = (4, 64, 32)
NEW_FAMILY_GATE_LAYERS = 2


def lm_requests(cfg, waves, seed=SEED):
    """The waves' requests, prompts drawn with numpy from ``seed``."""
    import numpy as np
    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(seed)
    reqs = []
    for n, plen, new in waves:
        for _ in range(n):
            reqs.append(Request(rid=len(reqs), max_new=new, prompt=rng.integers(
                0, cfg.vocab, size=plen).astype(np.int32)))
    return reqs


def engine_waves(reqs):
    """The requests as the engine groups them: by prompt length, in slots
    of LM_SLOTS."""
    by_len = {}
    for r in reqs:
        by_len.setdefault(len(r.prompt), []).append(r)
    return [rs[s:s + LM_SLOTS] for _, rs in sorted(by_len.items())
            for s in range(0, len(rs), LM_SLOTS)]


def fresh(reqs):
    import dataclasses
    return [dataclasses.replace(r, out=None, latency_s=0.0) for r in reqs]


def lm_engine(api, values, dev, max_seq, temperature=0.0, seed=0,
              engine_cls=None):
    from repro_torch.serve.engine import ServeConfig, ServingEngine
    return (engine_cls or ServingEngine)(api, values, ServeConfig(
        max_seq=max_seq, slots=LM_SLOTS, temperature=temperature, seed=seed),
        device=dev)


def lm_tokens(done):
    return {r.rid: r.out for r in done}


def instrumented(api, dev, log):
    """``api`` whose prefill and decode are timed on the host clock around
    a synchronize (appended to ``log`` as ("prefill" | "decode", ms, batch,
    tokens)) and whose logits are checked finite."""
    import dataclasses
    import torch

    def wrap(fn, kind):
        def call(*a, **kw):
            sync(dev)
            t0 = time.perf_counter()
            logits, caches = fn(*a, **kw)
            sync(dev)
            log.append((kind, 1e3 * (time.perf_counter() - t0),
                        logits.shape[0], logits.shape[1]))
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"non-finite logits in {kind}")
            return logits, caches
        return call

    return dataclasses.replace(api, prefill_fn=wrap(api.prefill_fn, "prefill"),
                               decode_fn=wrap(api.decode_fn, "decode"))


def attention_layers(cfg) -> int:
    return 0 if cfg.family == "ssm" else cfg.n_layers


class RouteLog:
    """While open, ``ffn.moe_apply`` and ``ffn._route`` are wrapped: each
    routing call appends (B, S, its sorted top-k expert indices (B, S, k)
    on the host, the top-k choices dropped for capacity) to ``calls``.
    What the model computes does not change."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        import torch
        from repro_torch.models import ffn

        self._orig = moe_apply, route = ffn.moe_apply, ffn._route
        shapes = []

        def recording_apply(p, x, cfg, act="silu"):
            shapes.append(tuple(x.shape[:2]))
            try:
                return moe_apply(p, x, cfg, act)
            finally:
                shapes.pop()

        def recording_route(logits, k, capacity):
            dispatch, combine = route(logits, k, capacity)
            B, S = shapes[-1]
            _, idx = ffn.top_k(ffn.softmax_f32(logits), k)
            idx = torch.sort(idx, dim=-1).values.reshape(B, S, k).cpu()
            kept = float(dispatch.sum())
            self.calls.append((B, S, idx, k * B * S - round(kept)))
            return dispatch, combine

        ffn.moe_apply, ffn._route = recording_apply, recording_route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import ffn
        ffn.moe_apply, ffn._route = self._orig

    def drops(self) -> int:
        return sum(c[3] for c in self.calls)


def compare_routes(calls_a, calls_b, rows: int):
    """Two builds' routing calls, in order, on the same ``rows`` requests:
    (bool list, a row whose expert set differed at some token; flipped
    token-layers; routed token-layers).  A row counts its flips up to its
    first flipping call: later calls see other inputs."""
    import numpy as np
    assert len(calls_a) == len(calls_b)
    flipped = np.zeros(rows, bool)
    n_flip = n_routed = 0
    for (B, S, ia, _), (_, _, ib, _) in zip(calls_a, calls_b):
        diff = (ia != ib).any(-1).numpy()                 # (B, S)
        live = ~flipped[:B]
        n_flip += int(diff[live].sum())
        n_routed += int(live.sum()) * S
        flipped[:B] |= diff.any(-1)
    return list(flipped), n_flip, n_routed


def lm_gate_a(cfg, waves, max_seq, dev, layers, tag):
    """Gate (a): fp32, ``layers`` layers at full width; the kernel build
    against the plain build on the same weights, wave by wave: prefill
    logits within LM_GATE_ATOL and greedy tokens equal on every request
    whose routing (a MoE's top-k experts at every token and layer, held by
    ``RouteLog``) is the same in both builds; at most MAX_FLIP_SHARE of
    routed token-layers flipped; then ``decode_against_forward``."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import lm

    gcfg = dataclasses.replace(cfg, n_layers=layers, dtype="float32")
    kern = lm.build(gcfg, device=dev)
    plain = lm.build(gcfg, device=dev, attention=FA.flash_attention_plain)
    values = kern.init(prng.PRNGKey(LM_INIT_SEED))
    reqs = lm_requests(gcfg, waves)
    worst, same, flips, routed, held = 0.0, True, 0, 0, 0
    for wave in engine_waves(reqs):
        toks = {"tokens": torch.from_numpy(np.stack([r.prompt
                                                     for r in wave]))}
        with RouteLog() as rk:
            lk, _ = kern.prefill_fn(values, toks, max_seq=max_seq)
        with RouteLog() as rp:
            lp, _ = plain.prefill_fn(values, toks, max_seq=max_seq)
        keep = [not f for f in compare_routes(rk.calls, rp.calls,
                                              len(wave))[0]]
        err = float((lk[keep] - lp[keep]).abs().max()) if any(keep) else 0.0
        worst = max(worst, err)
        print(f"{tag} gate (a): prefill of {tuple(toks['tokens'].shape)} "
              f"tokens, fp32, {layers} layers: kernel vs plain build "
              f"max_abs_err={err:.3e} on {sum(keep)} of {len(wave)} "
              f"requests{'' if all(keep) else ' (the others routed apart)'}",
              flush=True)
        del lk, lp
        with RouteLog() as rk:
            got = lm_tokens(lm_engine(kern, values, dev, max_seq).generate(
                fresh(wave)))
        with RouteLog() as rp:
            want = lm_tokens(lm_engine(plain, values, dev, max_seq).generate(
                fresh(wave)))
        flipped, n_f, n_r = compare_routes(rk.calls, rp.calls, len(wave))
        flips, routed = flips + n_f, routed + n_r
        for r, f in zip(wave, flipped):
            if not f:
                held += 1
                same = same and bool((got[r.rid] == want[r.rid]).all())
    share = flips / routed if routed else 0.0
    print(f"{tag} gate (a): greedy tokens, kernel vs plain build: "
          f"{'all equal' if same else 'DIFFER'} over {held} of {len(reqs)} "
          f"requests; routing flips in the engine runs: {flips} of {routed} "
          f"routed token-layers ({share:.2e}, limit {MAX_FLIP_SHARE})",
          flush=True)
    dec = decode_against_forward(gcfg, values, reqs, max_seq, dev, tag)
    if (worst > LM_GATE_ATOL or dec > LM_GATE_ATOL or not same
            or share > MAX_FLIP_SHARE):
        raise AssertionError(f"{tag} gate (a) failed")
    return worst, dec


def decode_against_forward(gcfg, values, reqs, max_seq, dev, tag):
    """Each decode step of the longest wave's first request (ring caches
    on local layers, the SSM state handed over by prefill) against a full
    forward over its prompt and the tokens so far, on the kernel route;
    a MoE without drops (GATE_CAPACITY, one routing group a sequence,
    asserted drop-free) and a step skipped where the step's experts differ
    from the forward's last token's.  Returns the max abs error."""
    import dataclasses
    import torch
    from repro_torch.models import lm, transformer
    from repro_torch.serve.engine import ServingEngine

    moe = gcfg.family == "moe"
    ccfg = dataclasses.replace(gcfg, capacity_factor=GATE_CAPACITY,
                               moe_group_size=1 << 30) if moe else gcfg
    api = lm.build(ccfg, device=dev)
    attend = lm._route(ccfg, None, api.device)[0]
    seen = []

    class Recording(ServingEngine):
        """The engine, keeping the logits each token is drawn from."""

        def _sample(self, logits, key):
            seen.append(logits.detach().clone())
            return super()._sample(logits, key)

    plen = max(len(r.prompt) for r in reqs)
    req = [r for r in reqs if len(r.prompt) == plen][0]
    with RouteLog() as rd:
        out = lm_engine(api, values, dev, max_seq, engine_cls=Recording
                        ).generate(fresh([req]))[0].out
    seq = list(req.prompt) + list(out)
    L = ccfg.n_layers if moe else 0
    dec, skipped, drops = 0.0, 0, rd.drops()
    for s in range(1, req.max_new):
        with RouteLog() as rf:
            full, _ = transformer.forward(values, ccfg, torch.tensor(
                [seq[:plen + s]], device=dev), attend)
        drops += rf.drops()
        step = rd.calls[L * s:L * (s + 1)]
        if any(not torch.equal(a[2][0, 0], b[2][0, -1])
               for a, b in zip(step, rf.calls)):
            skipped += 1
            continue
        dec = max(dec, float((seen[s][0] - full[0, -1]).abs().max()))
        del full
    print(f"{tag} gate (a): {req.max_new - 1 - skipped} of {req.max_new - 1} "
          f"decode steps of the {plen}-token prompt against a full forward "
          f"(skipped where the step's experts differ from the forward's: "
          f"{skipped}{f'; capacity factor {GATE_CAPACITY}, one group a sequence, {drops} drops' if moe else ''}): "
          f"max_abs_err={dec:.3e} (limit {LM_GATE_ATOL})", flush=True)
    if drops or skipped > (req.max_new - 1) // 2:
        raise AssertionError(f"{tag} gate (a): decode against forward "
                             f"({drops} drops, {skipped} steps skipped)")
    return dec


def lm_attention_readings(cfg, waves, dev, reps=LM_REPS, tag="[lm]",
                          json_row=True):
    """Flash attention at the waves' prefill shapes (bf16, B x S x H over
    KV x Dh), local (where the config has a window) and global, each beside
    its bound and the plain version; SDPA on the same shapes without the
    softcap (SDPA has no tanh softcap; the local shapes take a
    sliding-window mask).  Returns the JSON row of the longest wave's
    global layer where ``json_row``."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as FA

    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    rng = np.random.default_rng(SEED)
    row = None
    settings = ([("local", cfg.window)] if cfg.window else []) + [("global", 0)]
    for n, S, _ in waves:
        B = min(n, LM_SLOTS)
        x = [torch.from_numpy(rng.standard_normal(sh, dtype=np.float32)).to(
            dev, torch.bfloat16) for sh in ((B, S, H, Dh), (B, S, KV, Dh),
                                            (B, S, KV, Dh))]
        for kind, w in settings:
            c = cfg.attn_softcap
            out, ms = timed(lambda: FA.flash_attention(*x, window=w,
                                                       softcap=c), dev, reps)
            want, plain_ms = timed(lambda: FA.flash_attention_plain(*x, w, c),
                                   dev, 1)
            _, lib_ms = sdpa_ms(x, w, dev, reps)
            pairs = B * H * sum(min(i + 1, w or S) for i in range(S))
            flop = 4 * Dh * pairs
            nbytes = 2 * 2 * (x[0].numel() + x[1].numel())
            rtol, atol, rel = ATTN_TOL["bf16"]
            name = f"flash_attention {tag} B {B} S {S} {kind}"
            args = (out, want, ms, plain_ms, flop, nbytes)
            kw = dict(library_ms=lib_ms, rtol=rtol, atol=atol,
                      peak=PEAK_BF16_TC, rel=rel)
            if (json_row and kind == "global"
                    and S == max(s for _, s, _ in waves)):
                res = row = kernel_row(
                    "flash_attention", "flash_attention.cu",
                    "src/repro/kernels/flash_attention.py:86", *args, **kw)
            else:
                res = check(name, *args, **kw)
            print(f"{tag} {name} (window {w}, softcap {c}, bf16): {ms:.3f} "
                  f"ms, bound {res['bound_ms']:.3f} ms ({res['bound_by']}"
                  f"{attention_bounds(torch.bfloat16, flop, pairs, c)}); "
                  f"SDPA without the softcap (it has none"
                  f"{', a window mask' if w and w < S else ', causal'}) "
                  f"{lib_ms:.3f} ms", flush=True)
            del out, want
    return row


def attention_recorder(n=2):
    """(attention, seen): the kernel route ``ops.flash_attention``, keeping
    its first ``n`` calls' (q, k, v, window, softcap, out) in ``seen``."""
    from repro_torch.kernels import ops

    seen = []

    def recording(q, k, v, window, softcap):
        out = ops.flash_attention(q, k, v, window, softcap)
        if len(seen) < n:
            seen.append((q, k, v, window, softcap, out))
        return out

    return recording, seen


def check_recorded(tag, seen, want, what):
    """Hold each recorded layer's kernel output against
    ``flash_attention_plain`` on its own q/k/v at ATTN_TOL["bf16"]; fail
    unless ``want`` layers were recorded and all agree."""
    from repro_torch.kernels import flash_attention as FA

    rtol, atol, rel = ATTN_TOL["bf16"]
    ok = len(seen) >= want
    for l, (q, k, v, w, c, out) in enumerate(seen):
        ref = FA.flash_attention_plain(q, k, v, w, c)
        err, close = max_err(out, ref, rtol, atol)
        r = rel_norm_err(out, ref)
        ok = ok and close and r <= rel
        print(f"{tag} layer {l} (window {w}) {what} on its own q/k/v "
              f"{tuple(q.shape)} {q.dtype}, kernel vs plain: "
              f"max_abs_err={err:.3e} rel_norm_err={r:.3e} (rtol {rtol}, "
              f"atol {atol}, norm {rel})", flush=True)
    if not ok:
        raise AssertionError(f"{tag} a layer's {what} disagrees with the "
                             f"plain version")


def lm_layer_attention(cfg, values, reqs, max_seq, dev, tag="[lm]"):
    """Gate (b)'s attention check: the longest wave's prefill once more
    with the kernel route recording layers 0's and 1's q, k, v; each
    layer's kernel output held against ``flash_attention_plain`` on them at
    ATTN_TOL["bf16"].  Returns the top-k choices that prefill dropped for
    capacity, over its layers (0 without MoE)."""
    import numpy as np
    import torch
    from repro_torch.models import lm

    recording, seen = attention_recorder()
    api = lm.build(cfg, device=dev, attention=recording)
    plen = max(len(r.prompt) for r in reqs)
    toks = np.stack([r.prompt for r in reqs if len(r.prompt) == plen])
    with RouteLog() as routes:
        logits, caches = api.prefill_fn(values, {"tokens": torch.from_numpy(
            toks[:LM_SLOTS])}, max_seq=max_seq)
    del logits, caches
    check_recorded(f"{tag} gate (b):", seen, min(2, attention_layers(cfg)),
                   "prefill attention")
    return routes.drops()


def free_card(dev, tag):
    """Collect garbage and empty the allocator's cache; print what stays
    allocated (a new phase's start)."""
    import gc
    import torch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        print(f"{tag} allocated at the phase's start: "
              f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB", flush=True)


def run_lm(cfg, dev, waves=LM_WAVES, max_seq=LM_MAX_SEQ, reps=LM_REPS,
           tag="[lm]", gate_layers=LM_GATE_LAYERS, json_row=True,
           extras=True):
    """An LM phase at ``cfg``: gate (a), the bf16 main run through
    ``lm.build`` -> ``ServingEngine.generate`` (its readings and gate (b)),
    and, with ``extras``, the sampled run of wave A and the profiler's view
    of the longest wave; the plain build's tokens and the attention
    readings where the config has attention.  Returns the flash-attention
    JSON row (``json_row``) and its launches in the main run."""
    import numpy as np
    import torch
    from repro_torch import prng
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.models import lm, transformer
    from repro_torch.models.params import tree_leaves

    t_phase = time.perf_counter()

    def stamp(what):
        print(f"{tag} {cfg.name}: {what} at {time.perf_counter() - t_phase:.1f}"
              f" s into the phase", flush=True)

    free_card(dev, tag)
    lm_gate_a(cfg, waves, max_seq, dev, gate_layers, tag)
    stamp("gate (a) done")
    free_card(dev, tag)
    api = lm.build(cfg, device=dev)
    dtype = transformer.compute_dtype(cfg)
    values, init_ms = host_ms(lambda: api.init(prng.PRNGKey(LM_INIT_SEED),
                                               dtype=dtype), dev)
    n_par = sum(v.numel() for v in tree_leaves(values))
    width = (f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV x "
             f"{cfg.resolved_head_dim}" if attention_layers(cfg) else
             "no attention")
    if cfg.family == "moe":
        width += (f", {cfg.n_experts} experts top-{cfg.top_k} + "
                  f"{cfg.n_shared_experts} shared of d_ff {cfg.moe_d_ff}")
    elif cfg.family in ("ssm", "hybrid"):
        width += (f", SSD {cfg.ssm_heads} heads x {cfg.ssm_head_dim}, state "
                  f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}")
    print(f"{tag} {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{width}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; {n_par} parameters "
          f"(param_count {cfg.param_count()}) in {cfg.dtype}; init "
          f"{init_ms / 1e3:.1f} s (prng.normal in fp32 on the device, cast "
          f"once); attention route {api.attention}", flush=True)
    reqs = lm_requests(cfg, waves)
    log = []
    eng = lm_engine(instrumented(api, dev, log), values, dev, max_seq)
    attends = attention_layers(cfg) > 0
    sync(dev)
    t0 = time.perf_counter()
    done, _ = path_launches(("flash_attention",) if attends else (),
                            lambda: eng.generate(fresh(reqs)))
    n_launch = ops.launch_counts()["flash_attention"]
    sync(dev)
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda"
            else float("nan"))
    tokens = sum(len(r.out) for r in done)
    for kind, ms, b, s in (e for e in log if e[0] == "prefill"):
        print(f"{tag} prefill of {b} x {s} tokens: {ms:.1f} ms", flush=True)
    dec = [e for e in log if e[0] == "decode"]
    for b in sorted({e[2] for e in dec}):
        d = [e[1] for e in dec if e[2] == b]
        print(f"{tag} decode, batch {b}: {len(d)} steps, median "
              f"{float(np.median(d)):.2f} ms a step (min {min(d):.2f}, max "
              f"{max(d):.2f})", flush=True)
    print(f"{tag} main run: {len(done)} requests, {tokens} tokens in "
          f"{wall:.2f} s ({tokens / wall:.1f} tokens/s); peak memory "
          f"{peak:.2f} GB; flash_attention launched {n_launch} times",
          flush=True)
    want_launch = attention_layers(cfg) * len(engine_waves(reqs))
    in_range = all(((r.out >= 0) & (r.out < cfg.vocab)).all() for r in done)
    print(f"{tag} gate (b): {n_launch} flash launches (want {want_launch}), "
          f"tokens in [0, vocab) {in_range}, every logit finite", flush=True)
    if n_launch != want_launch or not in_range:
        raise AssertionError(f"{tag} gate (b) failed")
    stamp("main run done")
    drops = lm_layer_attention(cfg, values, reqs, max_seq, dev, tag)
    if cfg.family == "moe":
        plen = max(len(r.prompt) for r in reqs)
        print(f"{tag} the longest wave's prefill ({plen} tokens, groups of "
              f"{min(cfg.moe_group_size, plen)}): {drops} of "
              f"{cfg.top_k * plen * cfg.n_layers} top-{cfg.top_k} choices "
              f"dropped for capacity over its {cfg.n_layers} layers",
              flush=True)
    greedy = lm_tokens(done)
    long_req = [r for r in reqs if len(r.prompt) == max(w[1] for w in waves)]
    if extras:
        wave_a = [r for r in reqs if len(r.prompt) == waves[0][1]]
        sampled = lm_engine(api, values, dev, max_seq, temperature=1.0,
                            seed=LM_SAMPLE_SEED).generate(fresh(wave_a))
        print(f"{tag} wave A sampled at temperature 1.0, seed "
              f"{LM_SAMPLE_SEED}: first tokens "
              f"{[int(r.out[0]) for r in sampled]}, share equal to greedy "
              f"{np.mean([(r.out == greedy[r.rid]).mean() for r in sampled]):.3f}",
              flush=True)
        if not all(((r.out >= 0) & (r.out < cfg.vocab)).all()
                   for r in sampled):
            raise AssertionError(f"{tag} a sampled token is out of range")
        stamp("sampled run done")
        report_device_time(f"{tag} the longest wave (prefill + decode)",
                           lambda: lm_engine(api, values, dev, max_seq)
                           .generate(fresh(long_req[:LM_SLOTS])),
                           dev, top=8, share_of="flash_attention")
        stamp("profiled run done")
    if attends:
        plain = lm.build(cfg, device=dev, attention=FA.flash_attention_plain)
        got_p = lm_tokens(lm_engine(plain, values, dev, max_seq).generate(
            fresh(reqs)))
        share = np.mean([(greedy[i] == got_p[i]).mean() for i in greedy])
        print(f"{tag} bf16 greedy tokens, kernel build vs plain build: share "
              f"equal {share:.3f} (not gated: the builds round P alike but "
              f"sum in other orders, and a near tie flips a token)",
              flush=True)
    del values, eng
    stamp("plain build's run done")
    free_card(dev, tag)
    row = (lm_attention_readings(cfg, waves, dev, reps, tag, json_row)
           if attends else None)
    print(f"{tag} phase {cfg.name} {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return row, n_launch


def run_families(dev, families=FAMILIES, waves=FAMILY_WAVES,
                 max_seq=FAMILY_MAX_SEQ, reps=LM_REPS, smoke=False):
    """The [moe] and [ssm] phases: each family config through ``run_lm``
    (``smoke``: the configs' SMOKE, for a CPU rehearsal).  Returns each
    main run's flash launches by config name."""
    import repro_torch.configs as configs
    launches = {}
    for arch, tag in families:
        cfg = (configs.get_smoke if smoke else configs.get)(arch)
        layers = FAMILY_GATE_LAYERS.get(cfg.name, min(4, cfg.n_layers))
        _, launches[cfg.name] = run_lm(
            cfg, dev, waves, max_seq, reps, tag=tag, gate_layers=layers,
            json_row=False, extras=cfg.family == "moe")
    return launches


def generate_greedy(step, first_logits, new, dev):
    """Greedy tokens: the first from ``first_logits`` (B, V), then
    ``new - 1`` more, each from ``step(tok, s)``'s logits (B, 1, V), every
    call timed on the host clock around a synchronize.  Returns (tokens
    (B, new) on the host, the steps' ms)."""
    import torch
    tok = torch.argmax(first_logits, dim=-1)[:, None]
    outs, ms = [tok], []
    for s in range(new - 1):
        logits, t_ms = host_ms(lambda: step(tok, s), dev)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("non-finite logits in a decode step")
        tok = torch.argmax(logits[:, 0], dim=-1)[:, None]
        outs.append(tok)
        ms.append(t_ms)
    return torch.cat(outs, dim=1).cpu().numpy(), ms


def new_family_readings(tag, cfg, n_par, init_ms, pre_ms, dec_ms, gen, wall,
                        n_launch, dev):
    """Print a [vlm] / [encdec] main run's readings; fail unless every token
    is in [0, vocab)."""
    import numpy as np
    import torch
    peak = (torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda"
            else float("nan"))
    in_range = bool(((gen >= 0) & (gen < cfg.vocab)).all())
    print(f"{tag} {cfg.name}: {n_par} parameters (param_count "
          f"{cfg.param_count()}) in {cfg.dtype}, init {init_ms / 1e3:.1f} s; "
          f"prefill {pre_ms:.1f} ms; decode, batch {gen.shape[0]}: "
          f"{len(dec_ms)} steps, median {float(np.median(dec_ms)):.2f} ms a "
          f"step (min {min(dec_ms):.2f}, max {max(dec_ms):.2f}); "
          f"{gen.size} new tokens in {wall:.2f} s ({gen.size / wall:.1f} "
          f"tokens/s); peak memory {peak:.2f} GB; flash_attention launched "
          f"{n_launch} times; tokens in [0, vocab) {in_range}; first tokens "
          f"{gen[:, 0].tolist()}", flush=True)
    if not in_range:
        raise AssertionError(f"{tag} a token is out of range")


def run_vlm(dev, run=VLM_RUN, smoke=False):
    """[vlm]: paligemma-3b (``smoke``: its SMOKE) through ``lm.build`` ->
    ``api.prefill_fn`` / ``api.decode_fn``: numpy-seeded ``img_embeds``
    (bf16 on the card) before each prompt, then greedy decode at positions
    after the prefix.  Gate, fatal: fp32 at NEW_FAMILY_GATE_LAYERS layers,
    prefill of the prompt but its last token then one decode step against
    the full forward's last logits, within LM_GATE_ATOL.  The prefix mask
    sends every layer's prefill attention to ``attend_chunked``, as in the
    reference: the main run launches no flash kernel, which it asserts.
    Returns that run's flash launches (0)."""
    import dataclasses
    import numpy as np
    import torch
    import repro_torch.configs as configs
    from repro_torch import prng
    from repro_torch.kernels import ops
    from repro_torch.models import lm, transformer
    from repro_torch.models.params import tree_leaves

    tag, t_phase = "[vlm]", time.perf_counter()
    free_card(dev, tag)
    cfg = (configs.get_smoke if smoke else configs.get)("paligemma_3b")
    n, prompt, new = run
    P = cfg.prefix_tokens
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (n, prompt)).astype(
        np.int32)).to(dev)
    img = torch.from_numpy(rng.standard_normal(
        (n, P, cfg.d_model), dtype=np.float32)).to(dev)

    gcfg = dataclasses.replace(cfg, n_layers=min(NEW_FAMILY_GATE_LAYERS,
                                                 cfg.n_layers), dtype="float32")
    gapi = lm.build(gcfg, device=dev)
    gv = gapi.init(prng.PRNGKey(LM_INIT_SEED))
    attend = lm._route(gcfg, None, gapi.device)[0]
    full, _ = transformer.forward(gv, gcfg, toks[:2], attend,
                                  img_embeds=img[:2])
    _, caches = gapi.prefill_fn(gv, {"tokens": toks[:2, :-1],
                                     "img_embeds": img[:2]},
                                max_seq=P + prompt)
    step, _ = gapi.decode_fn(gv, caches, toks[:2, -1:], P + prompt - 1)
    err = float((step[:, 0] - full[:, -1]).abs().max())
    print(f"{tag} gate: fp32, {gcfg.n_layers} layers, 2 x ({P} + {prompt}) "
          f"tokens: prefill of all but the last token, then one decode step at "
          f"position {P + prompt - 1}, against the full forward's last "
          f"logits: max_abs_err={err:.3e} (limit {LM_GATE_ATOL})", flush=True)
    if not err <= LM_GATE_ATOL:
        raise AssertionError(f"{tag} gate failed")
    del gv, full, caches, step
    free_card(dev, tag)

    api = lm.build(cfg, device=dev)
    dtype = transformer.compute_dtype(cfg)
    values, init_ms = host_ms(lambda: api.init(prng.PRNGKey(LM_INIT_SEED),
                                               dtype=dtype), dev)
    n_par = sum(v.numel() for v in tree_leaves(values))
    batch = {"tokens": toks, "img_embeds": img.to(dtype)}
    ops.reset_launch_counts()
    sync(dev)
    t0 = time.perf_counter()
    (logits, caches), pre_ms = host_ms(lambda: api.prefill_fn(
        values, batch, max_seq=P + prompt + new), dev)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{tag} non-finite prefill logits")
    first = logits[:, -1]
    del logits

    def step_fn(tok, s):
        nonlocal caches
        logits, caches = api.decode_fn(values, caches, tok, P + prompt + s)
        return logits

    gen, dec_ms = generate_greedy(step_fn, first, new, dev)
    sync(dev)
    wall = time.perf_counter() - t0
    n_launch = ops.launch_counts()["flash_attention"]
    new_family_readings(tag, cfg, n_par, init_ms, pre_ms, dec_ms, gen, wall,
                        n_launch, dev)
    if n_launch:
        raise AssertionError(f"{tag} the prefix-masked prefill launched the "
                             f"flash kernel {n_launch} times")
    del values, caches
    print(f"{tag} phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return n_launch


def encdec_prompt_decode(api, values, cfg, toks, cross, dtype, seq, dev):
    """The prompts ``toks`` decoded one token at a time from position 0
    over a fresh ``encdec`` cache of ``seq`` slots holding ``cross`` (the
    cross K/V).  Returns the last step's logits (B, 1, V)."""
    from repro_torch.models import encdec

    cache = encdec.init_cache(cfg, toks.shape[0], seq, dtype, dev)._replace(
        cross_k=cross[0], cross_v=cross[1])
    for s in range(toks.shape[1]):
        lg, cache = api.decode_fn(values, cache, toks[:, s:s + 1], s)
    return lg


def run_encdec(dev, run=ENCDEC_RUN, smoke=False):
    """[encdec]: whisper-medium (``smoke``: its SMOKE) through ``lm.build``:
    ``api.prefill_fn`` on numpy-seeded frames and the prompts (the encoder,
    ``decode_train`` with its causal self-attention on the flash kernel,
    the cross K/V), then as the reference's own test serves it:
    ``encdec.init_cache``, the cross K/V, the prompt decoded one token at a
    time from position 0, then the new tokens, greedy.  Gate, fatal: fp32
    at NEW_FAMILY_GATE_LAYERS encoder and decoder layers, the token-by-token
    decode's last logits against ``decode_train``'s, within LM_GATE_ATOL.
    The main run must launch the flash kernel once a decoder layer, and
    decoder layers 0's and 1's self-attention, recorded in that run, must
    agree with ``flash_attention_plain`` on their own q/k/v at
    ATTN_TOL["bf16"].  Readings, not gated: the prompt decode's last logits
    against ``prefill_fn``'s, and a bf16 plain build's ``prefill_fn``
    logits (same weights, same batch) against the kernel build's and
    against the prompt decode's; then in fp32 at full depth, the prompt
    decode's, a plain build's and the kernel build's on frames scaled by
    1 + 2^-20 against the kernel build's ``prefill_fn``.  Returns the main
    run's launches."""
    import dataclasses
    import numpy as np
    import torch
    import repro_torch.configs as configs
    from repro_torch import prng
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.models import encdec, lm, transformer
    from repro_torch.models.params import tree_leaves

    tag, t_phase = "[encdec]", time.perf_counter()
    free_card(dev, tag)
    cfg = (configs.get_smoke if smoke else configs.get)("whisper_medium")
    n, prompt, new = run
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (n, prompt)).astype(
        np.int32)).to(dev)
    frames = torch.from_numpy(rng.standard_normal(
        (n, cfg.encoder_seq, cfg.d_model), dtype=np.float32)).to(dev)

    layers = min(NEW_FAMILY_GATE_LAYERS, cfg.n_layers)
    gcfg = dataclasses.replace(cfg, n_layers=layers, encoder_layers=layers,
                               dtype="float32")
    gapi = lm.build(gcfg, device=dev)
    gv = gapi.init(prng.PRNGKey(LM_INIT_SEED))
    (full, (_, ck, cv)), launches = path_launches(
        ("flash_attention",), lambda: gapi.prefill_fn(
            gv, {"tokens": toks[:2], "frames": frames[:2]}))
    lg = encdec_prompt_decode(gapi, gv, gcfg, toks[:2], (ck, cv),
                              torch.float32, prompt, dev)
    err = float((lg[:, 0] - full[:, -1]).abs().max())
    print(f"{tag} gate: fp32, {layers} + {layers} layers, 2 x {prompt} "
          f"tokens over {cfg.encoder_seq} frames: the token-by-token decode's "
          f"last logits against decode_train's: max_abs_err={err:.3e} (limit "
          f"{LM_GATE_ATOL}); decode_train launched flash_attention "
          f"{launches['flash_attention']} times", flush=True)
    if not err <= LM_GATE_ATOL or launches["flash_attention"] != layers:
        raise AssertionError(f"{tag} gate failed")
    del gv, full, ck, cv, lg
    free_card(dev, tag)

    recording, seen = attention_recorder()
    api = lm.build(cfg, device=dev, attention=recording)
    dtype = transformer.compute_dtype(cfg)
    values, init_ms = host_ms(lambda: api.init(prng.PRNGKey(LM_INIT_SEED),
                                               dtype=dtype), dev)
    n_par = sum(v.numel() for v in tree_leaves(values))
    batch = {"tokens": toks, "frames": frames.to(dtype)}
    ops.reset_launch_counts()
    sync(dev)
    t0 = time.perf_counter()
    (logits, (_, ck, cv)), pre_ms = host_ms(lambda: api.prefill_fn(values,
                                                                   batch), dev)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{tag} non-finite prefill logits")
    cache = encdec.init_cache(cfg, n, prompt + new, dtype, dev)._replace(
        cross_k=ck, cross_v=cv)
    del ck, cv

    def step_fn(tok, s):
        nonlocal cache
        logits, cache = api.decode_fn(values, cache, tok, s)
        return logits

    # the prompt, token by token from position 0 (teacher forced)
    prompt_ms = []
    for s in range(prompt):
        lg, ms = host_ms(lambda: step_fn(toks[:, s:s + 1], s), dev)
        prompt_ms.append(ms)
    last = lg[:, 0, :cfg.vocab]
    gen, dec_ms = generate_greedy(lambda tok, s: step_fn(tok, prompt + s),
                                  lg[:, 0], new, dev)
    sync(dev)
    wall = time.perf_counter() - t0
    n_launch = ops.launch_counts()["flash_attention"]
    new_family_readings(tag, cfg, n_par, init_ms, pre_ms, dec_ms, gen, wall,
                        n_launch, dev)
    if n_launch != cfg.n_layers:
        raise AssertionError(f"{tag} {n_launch} flash launches, want "
                             f"{cfg.n_layers} (one a decoder layer)")
    check_recorded(tag, seen, min(2, cfg.n_layers),
                   "decode_train self-attention")
    del seen, cache

    # the prompt decode against prefill_fn, and a plain build's prefill_fn
    plain = lm.build(cfg, device=dev, attention=FA.flash_attention_plain)
    plogits, _ = plain.prefill_fn(values, batch)
    kern, plogits = logits[..., :cfg.vocab], plogits[..., :cfg.vocab]
    errs = [float((a - b).abs().max()) for a, b in (
        (last, kern[:, -1]), (last, plogits[:, -1]), (kern, plogits),
        (kern[:, -1], plogits[:, -1]))]
    print(f"{tag} the prompt's {prompt} decode steps: median "
          f"{float(np.median(prompt_ms)):.2f} ms a step.  Logits in bf16, "
          f"not gated (largest magnitude {float(kern.abs().max()):.1f}): "
          f"the prompt decode's last against prefill_fn's last max_abs_err="
          f"{errs[0]:.3e}, against the plain build's {errs[1]:.3e}; the "
          f"plain build's prefill_fn against the kernel build's, all "
          f"{prompt} positions {errs[2]:.3e}, the last {errs[3]:.3e}",
          flush=True)
    del values, logits, plogits, kern

    # the same at full depth in fp32, without bf16's rounding: the prompt
    # decode, a plain build, and frames scaled by 1 + 2^-20, each against
    # the kernel build's prefill_fn (how far the model carries a rounding)
    fcfg = dataclasses.replace(cfg, dtype="float32")
    fapi = lm.build(fcfg, device=dev)
    fv = fapi.init(prng.PRNGKey(LM_INIT_SEED))
    V = cfg.vocab
    flogits, (_, ck, cv) = fapi.prefill_fn(fv, {"tokens": toks,
                                                "frames": frames})
    lg = encdec_prompt_decode(fapi, fv, fcfg, toks, (ck, cv), torch.float32,
                              prompt, dev)
    fplain = lm.build(fcfg, device=dev, attention=FA.flash_attention_plain)
    others = (lg[:, 0], fplain.prefill_fn(fv, {"tokens": toks,
                                               "frames": frames})[0][:, -1],
              fapi.prefill_fn(fv, {"tokens": toks, "frames": frames * (
                  1 + 2.0 ** -20)})[0][:, -1])
    errs = [float((o[..., :V] - flogits[:, -1, :V]).abs().max())
            for o in others]
    print(f"{tag} fp32, {cfg.encoder_layers} + {cfg.n_layers} layers, "
          f"{n} x {prompt} tokens, not gated (largest logit magnitude "
          f"{float(flogits[..., :V].abs().max()):.1f}): against prefill_fn's "
          f"last logits, the prompt decode's max_abs_err={errs[0]:.3e}, the "
          f"plain build's {errs[1]:.3e}, prefill_fn's on the frames x "
          f"(1 + 2^-20) {errs[2]:.3e}", flush=True)
    del fv, flogits, ck, cv, lg, others
    print(f"{tag} phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return n_launch


# ------------------------------------------------------------------ [lmtrain]
# (arch, batch, seq, steps, lr, warmup): the launcher's defaults for
# mamba2-780m (warmup steps // 10), hymba-1.5b at 4 x 1,024
LMTRAIN_MAIN = (("mamba2_780m", 8, 128, 50, 3e-4, 5),
                ("hymba_1_5b", 4, 1024, 20, 3e-4, 2))
LMTRAIN_REMAT = "full"             # the launcher's, without --smoke
LMTRAIN_LOSS_DROP = 0.5            # tests/test_train.py:42-54
LMTRAIN_WARM_STEPS = 3             # left out of the median step time
LMTRAIN_PROFILE_STEPS = 5
# gate (a): (arch, depth cut, (batch, seq)), fp32, card against CPU
LMTRAIN_GATE = (("hymba_1_5b", dict(n_layers=4), (2, 256)),
                ("whisper_medium", dict(n_layers=2, encoder_layers=2),
                 (2, 256)))
LMTRAIN_GATE_RTOL = 1e-5           # the loss
LMTRAIN_GATE_GRAD = 1e-3           # a gradient leaf, of its own max abs
# whisper-medium's loss: a 2^-20 change of its frames moves it 2.1e-5
LMTRAIN_ENCDEC_RTOL = 1e-4
# gate (c): mamba2-780m cut to 4 layers, the reference test's schedule
LMTRAIN_RESTART = dict(arch="mamba2_780m", n_layers=4, steps=12, batch=8,
                       seq=128, fail_at_step=9, ckpt_every=4, lr=1e-3,
                       warmup=1)
LMTRAIN_RESTART_RTOL = 1e-4        # tests/test_train.py:73-95
LMTRAIN_REMAT_RUN = ("hymba_1_5b", 1, 1024)   # gate (d)


def card_label(dev) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if dev.type != "cuda":
        return "cpu (no card)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def train_api(cfg, dev, remat=LMTRAIN_REMAT):
    from repro_torch.models import attention, lm
    return lm.build(cfg, remat_policy=remat, attention=attention.attend_causal,
                    device=dev)


def train_batch(cfg, batch, seq, dev, seed=SEED):
    """{"tokens"} from ``TokenPipeline`` step 0 (and numpy-seeded float32
    frames for the encoder-decoder) on ``dev``."""
    import numpy as np
    import torch
    from repro_torch.data import TokenPipeline

    b = {"tokens": TokenPipeline(vocab=cfg.vocab, batch=batch, seq_len=seq,
                                 seed=seed, device=dev).batch_at(0)}
    if cfg.family == "encdec":
        rng = np.random.default_rng(seed)
        b["frames"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.encoder_seq, cfg.d_model), dtype=np.float32)).to(dev)
    return b


def grad_errors(got, want):
    """[(max abs error / max abs, norm of the error / norm)] of each pair of
    gradient leaves; raises unless every leaf is finite."""
    import math
    import torch
    out = []
    for a, b in zip(got, want):
        if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
            raise AssertionError("[lmtrain] a gradient is not finite")
        scale, err = float(b.abs().max()), float((a - b).abs().max())
        norm, err_n = float(b.norm()), float((a - b).norm())
        out.append((err / scale if scale else math.inf if err else 0.0,
                    err_n / norm if norm else math.inf if err_n else 0.0))
    return out


def lmtrain_gate_a(dev, gates, label, tag="[lmtrain]", smoke=False):
    """Gate (a): fp32 (TF32 off), full width, depth cut: the card's loss
    and gradients against the CPU port's at the same params (drawn on the
    card, copied) and tokens.  Every leaf finite and none zero on the card
    where the CPU's is not.  Beside each, the CPU's own change when its
    input (the embedding table; the encoder-decoder's frames) is scaled by
    1 + 2^-20, the floor any float32 rounding can reach.  A decoder: the
    loss within LMTRAIN_GATE_RTOL and each gradient leaf within
    LMTRAIN_GATE_GRAD of its own max abs.  The encoder-decoder at the
    reference's init is chaotic (that 2^-20 moves every gradient leaf by
    ~10 % of its norm, ROADMAP §3): its loss within LMTRAIN_ENCDEC_RTOL,
    its gradients printed, not gated."""
    import dataclasses
    import torch
    import repro_torch.configs as configs
    from repro_torch import prng
    from repro_torch.optim import tree_leaves, tree_map
    from repro_torch.train.step import make_loss_and_grads

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError(f"{tag} gate (a) needs TF32 off")
    cpu = torch.device("cpu")
    for arch, cut, (B, S) in gates:
        cfg = dataclasses.replace(
            (configs.get_smoke if smoke else configs.get)(arch),
            dtype="float32", **({} if smoke else cut))
        encdec = cfg.family == "encdec"
        t0 = time.perf_counter()
        api_d, api_h = train_api(cfg, dev, None), train_api(cfg, cpu, None)
        values = api_d.init(prng.PRNGKey(LM_INIT_SEED))
        batch = train_batch(cfg, B, S, dev)
        loss_d, g_d = make_loss_and_grads(api_d.loss_fn, 1)(values, batch)
        g_d = [g.cpu() for g in tree_leaves(g_d)]
        values = tree_map(lambda v: v.cpu(), values)
        batch = {k: v.cpu() for k, v in batch.items()}
        cpu_fn = make_loss_and_grads(api_h.loss_fn, 1)
        loss_h, g_h = cpu_fn(values, batch)
        g_h = tree_leaves(g_h)
        nudge = 1 + 2.0 ** -20
        if encdec:
            loss_p, g_p = cpu_fn(values, dict(batch,
                                              frames=batch["frames"] * nudge))
        else:
            loss_p, g_p = cpu_fn(dict(values, embed=values["embed"] * nudge),
                                 batch)
        loss_d, loss_h, loss_p = float(loss_d), float(loss_h), float(loss_p)
        errs = grad_errors(g_d, g_h)
        floor = grad_errors(tree_leaves(g_p), g_h)
        dead = sum(int(float(b.abs().max()) > 0 and float(a.abs().max()) == 0)
                   for a, b in zip(g_d, g_h))
        worst, worst_n = max(e for e, _ in errs), max(n for _, n in errs)
        rel = abs(loss_d - loss_h) / abs(loss_h)
        limit = LMTRAIN_ENCDEC_RTOL if encdec else LMTRAIN_GATE_RTOL
        print(f"{tag} gate (a): {cfg.name} fp32, {cfg.n_layers} layers"
              f"{f' + {cfg.encoder_layers} encoder layers' if encdec else ''}"
              f", {B} x {S} tokens on attend_causal: loss card {loss_d:.7f} / "
              f"cpu {loss_h:.7f} (rel {rel:.2e}, limit {limit}); {len(g_d)} "
              f"gradient leaves, worst max_abs_err / max_abs {worst:.3e} "
              f"(limit {'none' if encdec else LMTRAIN_GATE_GRAD}), worst "
              f"||err|| / ||grad|| {worst_n:.3e}; the CPU's own change with "
              f"its {'frames' if encdec else 'embedding'} x (1 + 2^-20): loss "
              f"{abs(loss_p - loss_h) / abs(loss_h):.2e}, gradients "
              f"{max(e for e, _ in floor):.3e} / "
              f"{max(n for _, n in floor):.3e}; leaves zero on the card only "
              f"{dead}; {time.perf_counter() - t0:.1f} s; {label}", flush=True)
        if rel > limit or dead or (not encdec and worst > LMTRAIN_GATE_GRAD):
            raise AssertionError(f"{tag} gate (a) failed for {cfg.name}")
        del values, g_d, g_h, g_p
        free_card(dev, tag)


def lmtrain_main_run(cfg, batch, seq, steps, lr, warmup, dev, label,
                     tag="[lmtrain]", save=False):
    """Gate (b) for one config: ``launch/train.train_loop`` in the config's
    dtype at the launcher's remat, every launch count 0 before it and
    after; every loss finite and the last at least LMTRAIN_LOSS_DROP below
    the first; the API on ``attend_causal``.  Readings: init s, ms a step
    (median after LMTRAIN_WARM_STEPS), tokens/s, peak GB; with ``save``
    one async checkpoint of (values, opt_state) to a temporary directory,
    removed afterwards (hand-off and write ms, GB); then
    LMTRAIN_PROFILE_STEPS steps under torch.profiler.  Returns the main
    run's flash launches (0)."""
    import dataclasses
    import math
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train_loop
    from repro_torch.optim import tree_leaves
    from repro_torch.train.step import TrainConfig, make_train_step

    free_card(dev, tag)
    api = train_api(cfg, dev)
    if api.attention != "attend_causal":
        raise AssertionError(f"{tag} the trainer is on {api.attention}")
    init_s = []

    def timed_init(key):
        sync(dev)
        t0 = time.perf_counter()
        out = api.init(key)
        sync(dev)
        init_s.append(time.perf_counter() - t0)
        return out

    tcfg = TrainConfig(lr=lr, warmup_steps=warmup, total_steps=steps)
    timings = []
    ops.reset_launch_counts()
    values, opt, losses = train_loop(
        dataclasses.replace(api, init=timed_init), tcfg, steps, batch, seq,
        verbose=False, timings=timings)
    launched = {k: v for k, v in ops.launch_counts().items() if v}
    peak = (torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda"
            else float("nan"))
    ls = [l for _, l in losses]
    step_ms = [1e3 * s for _, s in timings[LMTRAIN_WARM_STEPS:]]
    med = float(np.median(step_ms))
    n_par = sum(v.numel() for v in tree_leaves(values))
    print(f"{tag} {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_par} parameters (param_count {cfg.param_count()}), float32 "
          f"masters, compute {cfg.dtype}, remat {LMTRAIN_REMAT!r}, route "
          f"{api.attention}; {steps} steps of {batch} x {seq} tokens, lr {lr} "
          f"warmup {warmup}: init {init_s[0]:.1f} s; step median {med:.1f} ms "
          f"(min {min(step_ms):.1f}, max {max(step_ms):.1f}, after "
          f"{LMTRAIN_WARM_STEPS} warm; first {1e3 * timings[0][1]:.1f} ms); "
          f"{batch * seq / med * 1e3:.0f} tokens/s; peak {peak:.2f} GB; loss "
          f"{ls[0]:.4f} -> {ls[-1]:.4f} (every 10th: "
          f"{[round(l, 4) for l in ls[::10]]}); kernels launched "
          f"{launched or 'none'}; {label}", flush=True)
    if not all(math.isfinite(l) for l in ls):
        raise AssertionError(f"{tag} {cfg.name}: a loss is not finite")
    if not ls[-1] <= ls[0] - LMTRAIN_LOSS_DROP:
        raise AssertionError(f"{tag} {cfg.name}: the loss fell "
                             f"{ls[0] - ls[-1]:.4f}, less than "
                             f"{LMTRAIN_LOSS_DROP}")
    if launched:
        raise AssertionError(f"{tag} the training path launched {launched}")
    if save:
        root = Path(tempfile.mkdtemp(prefix="lmtrain_ckpt_"))
        try:
            mgr = CheckpointManager(root, keep=1)
            sync(dev)
            t0 = time.perf_counter()
            mgr.save(steps - 1, (values, opt))
            back_ms = 1e3 * (time.perf_counter() - t0)
            mgr.wait()
            gb = sum(p.stat().st_size for p in root.rglob("*.npy")) / 1e9
            print(f"{tag} {cfg.name}: one async checkpoint of (values, "
                  f"opt_state), {gb:.2f} GB: hand-off {back_ms:.0f} ms "
                  f"(host copy {1e3 * mgr.last_handoff_s:.0f} ms), write "
                  f"{1e3 * mgr.last_write_s:.0f} ms on the writer thread; "
                  f"{label}", flush=True)
        finally:
            shutil.rmtree(root, ignore_errors=True)
    step_fn, _ = make_train_step(api.loss_fn, tcfg)
    pipe = TokenPipeline(vocab=cfg.vocab, batch=batch, seq_len=seq,
                         device=dev)

    def more_steps():
        nonlocal values, opt
        for i in range(steps, steps + LMTRAIN_PROFILE_STEPS):
            values, opt, m = step_fn(values, opt, {"tokens": pipe.batch_at(i)},
                                     i)
            float(m["loss"])

    report_device_time(f"{tag} {cfg.name}: {LMTRAIN_PROFILE_STEPS} more "
                       f"steps ({label})", more_steps, dev,
                       share_of="flash_attention")
    del values, opt
    return launched.get("flash_attention", 0)


def lmtrain_restart(dev, label, tag="[lmtrain]", smoke=False,
                    run=LMTRAIN_RESTART):
    """Gate (c): ``train_loop`` with an injected failure at
    ``fail_at_step`` (one restart: the params drawn again, the latest
    checkpoint restored) against an uninterrupted run, both checkpointing
    every ``ckpt_every`` steps to temporary directories; the losses of
    the steps after the failure within LMTRAIN_RESTART_RTOL."""
    import dataclasses
    import shutil
    import tempfile
    import numpy as np
    import repro_torch.configs as configs
    from repro_torch.launch.train import train_loop
    from repro_torch.train.step import TrainConfig

    free_card(dev, tag)
    r = dict(run)
    cfg = (configs.get_smoke if smoke else configs.get)(r["arch"])
    if not smoke:
        cfg = dataclasses.replace(cfg, n_layers=r["n_layers"])
    api = train_api(cfg, dev)
    tcfg = TrainConfig(lr=r["lr"], warmup_steps=r["warmup"],
                       total_steps=r["steps"])
    root = Path(tempfile.mkdtemp(prefix="lmtrain_restart_"))
    try:
        t0 = time.perf_counter()
        _, _, fail = train_loop(
            api, tcfg, r["steps"], r["batch"], r["seq"], ckpt_dir=root / "a",
            ckpt_every=r["ckpt_every"], max_restarts=1,
            fail_at_step=r["fail_at_step"], verbose=False)
        t1 = time.perf_counter()
        _, _, ok = train_loop(
            api, tcfg, r["steps"], r["batch"], r["seq"], ckpt_dir=root / "b",
            ckpt_every=r["ckpt_every"], verbose=False)
        t2 = time.perf_counter()
        gb = sum(p.stat().st_size for p in (root / "b").rglob("*.npy")) / 1e9
    finally:
        shutil.rmtree(root, ignore_errors=True)
    d_fail, d_ok = dict(fail), dict(ok)
    after = range(r["fail_at_step"] + 1, r["steps"])
    errs = [abs(d_fail[s] - d_ok[s]) / abs(d_ok[s]) for s in after]
    print(f"{tag} gate (c): {cfg.name} at {cfg.n_layers} layers, "
          f"{r['steps']} steps of {r['batch']} x {r['seq']}, checkpoints "
          f"every {r['ckpt_every']} ({gb:.2f} GB kept of the uninterrupted "
          f"run): failure injected at step {r['fail_at_step']}, restarted "
          f"from the latest checkpoint; losses of steps {list(after)} "
          f"{[round(d_fail[s], 6) for s in after]} against "
          f"{[round(d_ok[s], 6) for s in after]}, rel err "
          f"{max(errs):.2e} (limit {LMTRAIN_RESTART_RTOL}); runs "
          f"{t1 - t0:.1f} s and {t2 - t1:.1f} s; {label}", flush=True)
    if sorted(d_fail) != list(range(r["steps"])) or max(errs) > \
            LMTRAIN_RESTART_RTOL or not np.isfinite(list(d_fail.values())).all():
        raise AssertionError(f"{tag} gate (c) failed")


def lmtrain_remat(dev, label, tag="[lmtrain]", smoke=False,
                  run=LMTRAIN_REMAT_RUN):
    """Gate (d): one step's loss and gradients (the step's forward and
    backward) of hymba-1.5b with remat None, "full" and "dots" on the same
    params and tokens, each policy twice (the first call warms the
    shapes): the losses equal; the second call's ms and the peak memory
    printed, and whether every gradient leaf's float64 sum equals None's."""
    import repro_torch.configs as configs
    import torch
    from repro_torch import prng
    from repro_torch.optim import tree_leaves
    from repro_torch.train.step import make_loss_and_grads

    free_card(dev, tag)
    arch, B, S = run
    cfg = (configs.get_smoke if smoke else configs.get)(arch)
    values = train_api(cfg, dev).init(prng.PRNGKey(LM_INIT_SEED))
    batch = train_batch(cfg, B, S, dev)
    base = (torch.cuda.memory_allocated(dev) / 1e9 if dev.type == "cuda"
            else float("nan"))
    losses, sums0 = {}, None
    for policy in (None, "full", "dots"):
        fn = make_loss_and_grads(train_api(cfg, dev, policy).loss_fn, 1)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(2):
            (loss, grads), ms = host_ms(lambda: fn(values, batch), dev)
            sums = [float(g.double().sum()) for g in tree_leaves(grads)]
            del grads
        peak = (torch.cuda.max_memory_allocated(dev) / 1e9
                if dev.type == "cuda" else float("nan"))
        sums0 = sums0 or sums
        losses[policy] = float(loss)
        print(f"{tag} gate (d): {cfg.name} {B} x {S}, remat {policy!r}: loss "
              f"{float(loss):.7f}, forward and backward {ms:.1f} ms (second "
              f"call), peak {peak:.2f} GB ({base:.2f} GB of params before "
              f"it); gradient leaves' sums equal None's: {sums == sums0}; "
              f"{label}", flush=True)
    if len(set(losses.values())) != 1:
        raise AssertionError(f"{tag} gate (d): the losses differ: {losses}")
    del values


def lmtrain_guard(dev, tag="[lmtrain]"):
    """Gate (e): the flash kernel's wrapper refuses CUDA inputs that
    require grad, and so does a loss through the kernel route; on the CPU
    the route runs its plain version, which differentiates."""
    import repro_torch.configs as configs
    import torch
    from repro_torch import prng
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.train.step import make_loss_and_grads

    q = torch.randn((1, 64, 4, 64), device=dev, requires_grad=True)
    kv = torch.randn((1, 64, 2, 64), device=dev)
    scfg = configs.get_smoke("hymba_1_5b")
    kern = lm.build(scfg, device=dev)            # the kernel route
    grads_fn = make_loss_and_grads(kern.loss_fn, 1)
    svals = kern.init(prng.PRNGKey(0))
    sbatch = train_batch(scfg, 2, 32, dev)
    refused = []
    for what, fn in (
            ("ops.flash_attention", lambda: ops.flash_attention(q, kv, kv)),
            ("the kernel route's loss", lambda: grads_fn(svals, sbatch))):
        try:
            fn()
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
            refused.append(what)
    with torch.no_grad():
        ops.flash_attention(q, kv, kv)
    print(f"{tag} gate (e): refused with a tensor that requires grad: "
          f"{refused}; under no_grad the kernel runs", flush=True)
    if dev.type == "cuda" and len(refused) != 2:
        raise AssertionError(f"{tag} gate (e): only {refused} refused")


def run_lmtrain(dev, main=LMTRAIN_MAIN, gates=LMTRAIN_GATE,
                restart=LMTRAIN_RESTART, remat_run=LMTRAIN_REMAT_RUN,
                smoke=False):
    """[lmtrain]: LM training on the training route (``attend_causal``):
    gate (e), gate (a), the main runs (gate (b)), gate (c) and gate (d)
    (``smoke``: each config's SMOKE, for a CPU rehearsal).  Returns the
    main runs' flash launches (none: the route launches no kernel)."""
    import repro_torch.configs as configs

    tag, t_phase = "[lmtrain]", time.perf_counter()
    label = card_label(dev)
    print(f"{tag} on {label}", flush=True)
    lmtrain_guard(dev)
    lmtrain_gate_a(dev, gates, label, smoke=smoke)
    launches = {}
    for i, (arch, batch, seq, steps, lr, warmup) in enumerate(main):
        cfg = (configs.get_smoke if smoke else configs.get)(arch)
        launches[f"{cfg.name} training"] = lmtrain_main_run(
            cfg, batch, seq, steps, lr, warmup, dev, label, save=i == 0)
    lmtrain_restart(dev, label, smoke=smoke, run=restart)
    lmtrain_remat(dev, label, smoke=smoke, run=remat_run)
    free_card(dev, tag)
    print(f"{tag} phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def attention_bounds(dtype, flop, pairs, softcap):
    """The bf16 settings' second bound: the special-function units, one
    exp2 a pair and, with the softcap, tanhf's exp2 and reciprocal."""
    import torch
    if dtype != torch.bfloat16:
        return ""
    sfu = pairs * (3 if softcap else 1)
    return (f"; bound on the dense bf16 tensor cores "
            f"{1e3 * flop / PEAK_BF16_TC:.3f} ms, on the special-function "
            f"units {1e3 * sfu / PEAK_SFU:.3f} ms ({sfu / 1e9:.2f} G ops)")


def check_volume_render_ragged(dev):
    """volume_render bit for bit against its plain version at the
    RAGGED_RENDERS shapes, with aligned inputs and with sigma and the
    anchors one float off 16-B alignment (the kernel's 4-B copies)."""
    import numpy as np
    import torch
    from repro_torch.kernels import volume_render as VR

    rng = np.random.default_rng(SEED)

    def shifted(t):     # the same values, one float past a 16-B boundary
        flat = torch.empty(t.numel() + 1, device=dev)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)

    for R, S, A, g in RAGGED_RENDERS:
        sig, dl = (torch.from_numpy(rng.uniform(0, hi, (R, S)).astype(
            np.float32)).to(dev) for hi in (8.0, 0.05))
        anch = torch.from_numpy(rng.uniform(size=(R, A, 3)).astype(
            np.float32)).to(dev)
        want = VR.volume_render_plain(sig, dl, anch, g)
        same = [torch.equal(VR.volume_render(*x, g), want)
                for x in ((sig, dl, anch), (shifted(sig), dl, shifted(anch)))]
        print(f"[decoupled] volume_render on R={R} S={S} A={A} group {g}, "
              f"aligned / shifted inputs: bit-equal {same}", flush=True)
        if not all(same):
            raise AssertionError("volume_render differs from its plain "
                                 "version at a ragged shape")


def run_attention(cfg, seq, dev, wide=False, reps=3):
    """Flash attention at ``cfg``'s attention widths on one sequence of
    ``seq`` tokens.  For gemma2-27b: the local layer, the global layer and
    the global layer without softcap (the library's case) in fp32, the
    local layer and the global layer without softcap in bf16, then the
    ragged shapes at head_dim 64.  For the head_dim-256 config (``wide``:
    gemma3-12b, no softcap): the local and the global layer in fp32 and in
    bf16, then the ragged shapes at its head_dim and heads.  Each setting
    is held to the plain version at ATTN_TOL and printed with its bound
    and, where it has no softcap (SDPA has none), SDPA's time (a window
    mask where the window is shorter than the sequence).  Returns the
    kernel's launches over the settings (the JSON row is the [lm]
    phase's, at the main path's shapes)."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as FA

    B, S, H, KV, Dh = 1, seq, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    f32, b16 = torch.float32, torch.bfloat16
    win, cap = cfg.window, cfg.attn_softcap
    if wide:
        settings = [(f"head_dim {Dh} {kind} {name}", dt, w, cap)
                    for name, dt in (("fp32", f32), ("bf16", b16))
                    for kind, w in (("local", win), ("global", 0))]
    else:
        settings = [("local", f32, win, cap), ("global", f32, 0, cap),
                    ("global no softcap", f32, 0, 0.0),
                    ("local bf16", b16, win, cap),
                    ("global no softcap bf16", b16, 0, 0.0)]
    rng = np.random.default_rng(SEED)
    x32 = tuple(torch.from_numpy(rng.standard_normal(sh, dtype=np.float32))
                .to(dev) for sh in ((B, S, H, Dh), (B, S, KV, Dh),
                                    (B, S, KV, Dh)))
    xs = {torch.float32: x32,
          torch.bfloat16: tuple(t.to(torch.bfloat16) for t in x32)}
    outs, launches = path_launches(("flash_attention",), lambda: [
        FA.flash_attention(*xs[dt], window=w, softcap=c)
        for _, dt, w, c in settings])
    for (tag, dt, w, c), out in zip(settings, outs):
        x = xs[dt]
        rtol, atol, rel = ATTN_TOL["bf16" if dt == torch.bfloat16 else "fp32"]
        _, ms = timed(lambda: FA.flash_attention(*x, window=w, softcap=c), dev,
                      reps)
        want, plain_ms = timed(lambda: FA.flash_attention_plain(*x, w, c),
                               dev, 1)
        lib_ms = None
        if not c:
            lib, lib_ms = sdpa_ms(x, w, dev, reps)
            print(f"[attention] {tag}: scaled_dot_product_attention "
                  f"({'a window mask' if w and w < S else 'causal'}) "
                  f"{lib_ms:.3f} ms, max_abs_err against the kernel "
                  f"{max_err(lib, out)[0]:.3e}", flush=True)
            del lib
        pairs = B * H * sum(min(i + 1, w or S) for i in range(S))
        flop = 4 * Dh * pairs
        nbytes = x[0].element_size() * 2 * (x[0].numel() + x[1].numel())
        print(f"[attention] {tag} (S {S}, H {H} / KV {KV}, head_dim {Dh}, "
              f"window {w}, softcap {c}, {dt}): {pairs} causal pairs, "
              f"{flop / 1e9:.1f} GFLOP{attention_bounds(dt, flop, pairs, c)}",
              flush=True)
        peak = PEAK_BF16_TC if dt == torch.bfloat16 else PEAK_FP32
        check(f"flash_attention {tag}", out, want, ms, plain_ms, flop, nbytes,
              library_ms=lib_ms, rtol=rtol, atol=atol, peak=peak, rel=rel)
        del want
    del outs
    if wide:
        check_attention_ragged(dev, Dh, ((H, KV), (8, 1)))
    else:
        check_attention_ragged(dev)
    return launches


def sdpa_ms(x, w, dev, reps):
    """(output (B, S, H, Dh), ms) of ``scaled_dot_product_attention`` on
    q, k, v ``x`` (GQA), causal, with a sliding-window mask where ``w`` is
    shorter than the sequence; timed here, used nowhere in the port."""
    import torch
    import torch.nn.functional as F

    S = x[0].shape[1]
    qt, kt, vt = (t.transpose(1, 2) for t in x)
    mask = None
    if w and w < S:
        i = torch.arange(S, device=dev)
        mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < w)
    out, ms = timed(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=mask is None, enable_gqa=True),
        dev, reps)
    return out.transpose(1, 2), ms


def check_attention_ragged(dev, Dh=64, heads=((8, 8), (8, 1))):
    """Flash attention at shapes the attention phase does not give it:
    RAGGED_SEQ tokens (a multiple of neither query tile), head_dim ``Dh``,
    the (H, KV) of ``heads``, global and with a window that starts
    mid-tile and the softcap, in both dtypes, against the plain version."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as FA

    rng = np.random.default_rng(SEED)
    for H, KV in heads:
        shapes = ((2, RAGGED_SEQ, H, Dh), (2, RAGGED_SEQ, KV, Dh),
                  (2, RAGGED_SEQ, KV, Dh))
        x32 = [torch.from_numpy(rng.standard_normal(sh, dtype=np.float32))
               .to(dev) for sh in shapes]
        for x in (x32, [t.to(torch.bfloat16) for t in x32]):
            dt = "bf16" if x[0].dtype == torch.bfloat16 else "fp32"
            for w, c in ((0, 0.0), (RAGGED_WINDOW, 30.0)):
                got = FA.flash_attention(*x, window=w, softcap=c)
                want = FA.flash_attention_plain(*x, w, c)
                rtol, atol, rel = ATTN_TOL[dt]
                err, ok = max_err(got, want, rtol, atol)
                r = rel_norm_err(got, want)
                ok = ok and (rel is None or r <= rel)
                print(f"[attention] ragged: S {RAGGED_SEQ}, H {H}, KV {KV}, "
                      f"head_dim {Dh}, {dt}, window {w}, softcap {c}: "
                      f"max_abs_err={err:.3e} rel_norm_err={r:.3e}",
                      flush=True)
                if not ok:
                    raise AssertionError("flash_attention disagrees with its "
                                         "plain version at a ragged shape")


# The [dryrun] phase: the dry-run tools (``launch/dryrun.py``) reduced to
# the card.  Records of every cell through the tool's entry point: analytic
# on the single- and multi-pod meshes; on the card mesh, each cell whose
# reckoning fits is also measured (the ingp-asdr render cells on the main
# path's frame, the decode cells of mamba2-780m and hymba-1.5b).  Then one
# LM prefill cell on the flash kernel, cut to a few rows.
DRYRUN_OUT = ROOT / "chiprun_out" / "dryrun_torch"
DRYRUN_GATE_BLOCKS = 2           # asdr_render's sorted blocks held to plain
# the LM cell's rows at most: hymba-1.5b's prefill_32k at 4 rows reckons
# 39.2 GB but held 68 GB after a call on an H100 80GB HBM3 (700 W), too
# near the card's 80 GB for the gate's second, recording prefill
DRYRUN_MAX_ROWS = 2
DRYRUN_MAX_SHARE = 1.05          # above it the count is wrong, not the card
DRYRUN_RENDER_KERNELS = ("hash_encode", "density_mlp", "color_mlp")
# prefill families that run the flash kernel at a context their
# architecture takes: not the SSM (no attention), nor the VLM (its prefix
# mask goes through attend_chunked), nor the encoder-decoder (whisper's
# decoder context is bounded; 32k decoder tokens are no user's traffic)
DRYRUN_LM_FAMILIES = ("dense", "moe", "hybrid")


def dryrun_measured(tag, rec):
    m = rec["measured"]
    peak = "n/a" if m["peak_bytes"] is None else f"{m['peak_bytes'] / 1e9:.2f}"
    print(f"[dryrun] {tag}: {m['ms']:.1f} ms (runs {m['ms_runs']}), peak "
          f"{peak} GB (reckoned {rec['reckoned_bytes'] / 1e9:.1f}), "
          f"arguments {m['argument_bytes'] / 1e9:.3f} GB, launches a call "
          f"{m['launches']}, bound {m['bound_ms']} ms, roofline share "
          f"{m['roofline_share']}, outputs finite {m['finite']}", flush=True)


def dryrun_records(out_dir):
    """Every cell's record through ``dryrun.main``: ``--all --mesh both``,
    then ``--all --mesh card`` (the cells that fit measured, from
    ``SEED``); fails on an error record, and on a measured cell with a
    non-finite output (gate (a)) or a render cell that launched no field
    kernel (gate (d)).  Returns the card mesh's records by cell and the
    render kernels' launches in that run."""
    from repro_torch.launch import asdr_steps, dryrun

    dryrun.main(["--all", "--mesh", "both", "--out", str(out_dir)])
    _, launches = path_launches(DRYRUN_RENDER_KERNELS, lambda: dryrun.main(
        ["--all", "--mesh", "card", "--seed", str(SEED), "--out",
         str(out_dir)]))
    errors = sorted(p.name for p in out_dir.glob("*.error.json"))
    if errors:
        raise AssertionError(f"[dryrun] error records: {errors}")
    card = {}
    for p in sorted(out_dir.glob("*_card.json")):
        rec = json.loads(p.read_text())
        if not rec.get("skipped"):
            card[p.stem.removesuffix("_card")] = rec
    print(f"[dryrun] {len(list(out_dir.glob('*.json')))} records in "
          f"{out_dir}; render kernels' launches {launches}", flush=True)
    for tag, rec in card.items():
        if rec["measured"] is None:
            continue
        dryrun_measured(tag, rec)
        if not rec["measured"]["finite"]:
            raise AssertionError(f"[dryrun] gate (a): {tag}'s output is "
                                 "not finite")
        missing = [k for k in DRYRUN_RENDER_KERNELS
                   if not rec["measured"]["launches"].get(k)]
        if rec["arch"] == "ingp-asdr" and missing:
            raise AssertionError(f"[dryrun] gate (d): {tag} launched no "
                                 f"{missing}")
    for tag in ("ingp-asdr_asdr_render", "ingp-asdr_render_serve"):
        if card[tag]["measured"] is None:
            raise AssertionError(f"[dryrun] {tag} was not measured: "
                                 f"{card[tag].get('not_measured')}")
    t = card["ingp-asdr_asdr_train"]
    print(f"[dryrun] asdr_train ({t['rays']} rays x "
          f"{asdr_steps.TRAIN_SAMPLES} samples): reckoned "
          f"{t['reckoned_bytes'] / 1e9:.1f} GB against "
          f"{dryrun.CARD_BYTES / 1e9:.0f}: "
          + (t["not_measured"] if t["measured"] is None
             else f"measured {t['measured']['ms']:.1f} ms"), flush=True)
    return launches


def same_march(tag, got, want):
    """rgb and acc within RTOL / ATOL, chunks and ray_chunks exact, of a
    march's outputs (rgb, acc, ..., chunks, ray_chunks)."""
    import torch
    e_rgb, ok_rgb = max_err(got[0], want[0])
    e_acc, ok_acc = max_err(got[1], want[1])
    chunks = bool(torch.equal(got[3], want[3]))
    rays = bool(torch.equal(got[4], want[4]))
    print(f"[dryrun] gate (b) {tag}: max_abs_err rgb {e_rgb:.3e} acc "
          f"{e_acc:.3e}; chunks equal {chunks}, ray_chunks equal {rays} "
          f"({int((got[4] != want[4]).sum())} rays differ)", flush=True)
    if not (ok_rgb and ok_acc and chunks and rays):
        raise AssertionError(f"[dryrun] gate (b): {tag} differs from the "
                             "plain field")


def dryrun_render_gate(dev):
    """Gate (b): the card mesh's render steps once more on the inputs the
    tool measured them on (``dryrun.asdr_inputs`` at ``SEED``): asdr_render's
    first sorted blocks and each pooled block's march against the plain
    field on the same block."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.core import model, pipeline
    from repro_torch.launch import asdr_steps, dryrun
    from repro_torch.launch import render_serve as rs

    bundle = configs.get("ingp-asdr")
    mesh = dryrun.make_mesh("card")
    step_r, args, _ = asdr_steps.build_render_cell(bundle, mesh)
    step_p, _, _ = rs.build_pooled_march_cell(bundle, mesh)
    p, o, d, counts = dryrun.asdr_inputs(bundle, "asdr_render", args, SEED,
                                         dev)
    po, pd, pb = rs.pooled_blocks(bundle, o, d, counts)
    rgb, acc, stats = step_r(p, o, d, counts)
    out_p = step_p(p, po, pd, pb)
    print(f"[dryrun] ingp-asdr render cells: {o.shape[0]} padded rays "
          f"({asdr_steps.RENDER_HW[0]}x{asdr_steps.RENDER_HW[1]}), "
          f"{po.shape[0]} pooled blocks of {po.shape[1]}", flush=True)

    fns_p = model.field_fns(model.NGPField.from_params(bundle.model, p))
    acfg = dataclasses.replace(bundle.asdr, block_size=asdr_steps.RENDER_BLOCK)
    n, B = DRYRUN_GATE_BLOCKS, acfg.block_size
    order, budgets = pipeline.block_sort(acfg, counts)
    idx = order[:n * B].long()
    want = pipeline._march_block(fns_p, acfg, o[idx].reshape(n, B, 3),
                                 d[idx].reshape(n, B, 3), budgets[:n])
    same_march(f"asdr_render, first {n} sorted blocks (budgets "
               f"{budgets[:n].tolist()})",
               (rgb[idx].reshape(n, B, 3), acc[idx].reshape(n, B), None,
                stats["chunks_per_block"][:n],
                stats["ray_chunks_per_block"][:n]), want)
    want = [pipeline._march_block(fns_p, acfg, po[i:i + 1], pd[i:i + 1],
                                  pb[i:i + 1]) for i in range(po.shape[0])]
    same_march(f"render_serve, each of {po.shape[0]} pooled blocks "
               f"(budgets {sorted(set(pb.tolist()))})", out_p,
               tuple(torch.cat(w) for w in zip(*want)))


def dryrun_lm(dev, out_dir):
    """The LM prefill cell on the flash kernel: the prefill_32k cell whose
    reckoning at one row is smallest among DRYRUN_LM_FAMILIES, cut to the
    most rows (up to DRYRUN_MAX_ROWS) that fit; gates (a), (c), (d), then
    (b): the prefill once more with layers 0 and 1 recorded, each layer's
    kernel output on the last row held against ``flash_attention_plain``
    over all its keys."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.models import lm

    shape = dryrun.SHAPES["prefill_32k"]

    def reckon(arch, rows):
        cell = dataclasses.replace(shape, global_batch=rows)
        return dryrun.reckon_bytes(dryrun.lm_record(arch, cell, "card")[0])

    archs = [a for a in configs.list_archs()
             if configs.get(a).family in DRYRUN_LM_FAMILIES]
    one = {a: reckon(a, 1) for a in archs}
    print("[dryrun] prefill_32k reckoned on the card at one row (GB): "
          + ", ".join(f"{a} {v / 1e9:.1f}" for a, v in one.items()),
          flush=True)
    arch = min(one, key=one.get)
    rows = max(r for r in range(1, DRYRUN_MAX_ROWS + 1)
               if reckon(arch, r) <= dryrun.CARD_BYTES)
    print(f"[dryrun] LM cell: {arch} prefill_32k at {rows} of "
          f"{shape.global_batch} rows ({rows} x {shape.seq_len} tokens), "
          f"reckoned {reckon(arch, rows) / 1e9:.1f} GB", flush=True)
    (rec, out), launches = path_launches(
        ("flash_attention",), lambda: dryrun.card_cell(
            arch, "prefill_32k", rows=rows, seed=SEED, device=dev))
    write_record(out_dir, f"{arch}_prefill_32k_card_rows{rows}", rec)
    dryrun_measured(f"{arch} prefill_32k x {rows}", rec)
    logits = out[0]
    print(f"[dryrun] logits {tuple(logits.shape)} {logits.dtype}", flush=True)
    del out, logits
    m = rec["measured"]
    cfg = configs.get(arch)
    want = attention_layers(cfg)
    if not m["finite"]:
        raise AssertionError("[dryrun] gate (a): non-finite prefill output")
    if m["launches"].get("flash_attention") != want:
        raise AssertionError(f"[dryrun] gate (d): {m['launches']} flash "
                             f"launches a call, not {want}")
    if not m["roofline_share"] <= DRYRUN_MAX_SHARE:
        raise AssertionError(f"[dryrun] gate (c): roofline share "
                             f"{m['roofline_share']} > {DRYRUN_MAX_SHARE}")

    free_card(dev, "[dryrun]")
    cell = dataclasses.replace(shape, global_batch=rows)
    _, _, args, _ = dryrun.lm_record(arch, cell, "card", device=dev)
    values, batch = dryrun.lm_inputs(cfg, cell, args, SEED, dev)
    recording, seen = attention_recorder()
    api = lm.build(cfg, device=dev, attention=recording)
    api.prefill_fn(values, batch)        # its logits and caches dropped
    last = [(q[-1:], k[-1:], v[-1:], w, c, o[-1:])
            for q, k, v, w, c, o in seen]
    del values, batch, seen
    check_recorded(f"[dryrun] gate (b): {arch} prefill_32k row {rows - 1}",
                   last, min(2, want), f"attention over {shape.seq_len} keys")
    return launches


def write_record(out_dir, tag, rec):
    (out_dir / f"{tag}.json").write_text(json.dumps(rec, indent=1))


def run_dryrun(dev, out_dir=DRYRUN_OUT):
    """The [dryrun] phase; returns its launch counts."""
    import shutil

    t0 = time.perf_counter()
    free_card(dev, "[dryrun]")
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    launches = dryrun_records(out_dir)
    dryrun_render_gate(dev)
    free_card(dev, "[dryrun]")
    launches.update(dryrun_lm(dev, out_dir))
    print(f"[dryrun] {card_label(dev)}; phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def run(dev, bundle, hw, attn, seq, wide, wide_seq, reps=3, train_kw=TRAIN,
        lm_waves=LM_WAVES, lm_max_seq=LM_MAX_SEQ, family_kw=None,
        new_kw=None, lmtrain_kw=None):
    """Phases 2-15 on ``dev`` at ``bundle``, image size ``hw``, the LM
    configs ``attn`` and ``wide`` (their attention widths for phase 5, over
    ``seq`` and ``wide_seq`` tokens; the whole models for ``[lm]``, on
    ``lm_waves``), training ``train_kw``, then the ``[moe]`` and ``[ssm]``
    phases (``run_families(**family_kw)``), ``[vlm]`` and ``[encdec]``
    (``run_vlm`` / ``run_encdec(dev, **new_kw)``), ``[lmtrain]``
    (``run_lmtrain(dev, **lmtrain_kw)``), ``[dryrun]`` (``run_dryrun``);
    returns the kernel rows of the JSON line."""
    from repro_torch import params
    from repro_torch.core import scene

    field = params.from_jax_params(
        params.random_params(bundle.model, SEED, TABLE_SCALE), bundle.model,
        device=dev)
    cam = scene.look_at_camera(hw[0], hw[1], **CAMERA)
    rows, launches = check_kernels(field, bundle, cam, dev, reps)
    frame_launches, ref = run_frames(field, bundle, cam, dev)
    vr_row, vr_launches = run_decoupled(field, bundle, cam, ref, dev, reps)
    run_attention(attn, seq, dev, reps=reps)
    run_attention(wide, wide_seq, dev, wide=True, reps=reps)
    field_t, scene_t = run_train(bundle, cam, dev, train_kw)
    run_reuse(field_t, scene_t, bundle, dev, hw)
    run_serve(field_t, scene_t, field, bundle, dev, hw)
    del field, field_t, scene_t
    fa_row, fa_launches = run_lm(attn, dev, lm_waves, lm_max_seq)
    lm_launches = {attn.name: fa_launches}
    _, lm_launches[wide.name] = run_lm(
        wide, dev, lm_waves, lm_max_seq,
        gate_layers=min(WIDE_GATE_LAYERS, wide.n_layers), json_row=False,
        extras=False)
    lm_launches.update(run_families(dev, **(family_kw or {})))
    lm_launches["paligemma-3b"] = run_vlm(dev, **(new_kw or {}))
    lm_launches["whisper-medium"] = run_encdec(dev, **(new_kw or {}))
    print(f"[lm] flash_attention launches in the LM main runs: "
          f"{lm_launches}", flush=True)
    train_launches = run_lmtrain(dev, **(lmtrain_kw or {}))
    print(f"[lmtrain] flash_attention launches in the training main runs: "
          f"{train_launches}", flush=True)
    dry_launches = run_dryrun(dev)
    print(f"[dryrun] launches in the phase's measured runs: {dry_launches}",
          flush=True)
    vm_row, vm_launches = run_vm(dev, reps)
    rows += [vr_row, fa_row, vm_row]
    launches.update(**frame_launches, **vr_launches, **vm_launches,
                    flash_attention=sum(lm_launches.values())
                    + dry_launches["flash_attention"])
    names = {r["name"] for r in rows}
    if len(names) != 8:
        raise AssertionError(f"[dryrun] gate (d): the kernels line lists "
                             f"{sorted(names)}")
    for r in rows:
        r["launches"] = launches[r["name"]]
    return rows


def ptxas_lines(log):
    """[(kernel, line)] of ptxas -v's stack-frame / spill and register
    lines, each with the kernel it belongs to."""
    out, fn = [], "?"
    for line in log.splitlines():
        line = line.strip()
        if "Function properties for" in line:
            fn = line.split("Function properties for")[-1].strip()
        elif "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line
        elif "registers" in line or "spill" in line:
            out.append((fn, line.replace("ptxas info    : ", "")))
    return out


def template_args(fn: str, kernel: str) -> str:
    """The integer template arguments of a mangled kernel name, as
    "<a, b>" ("" for a kernel that is no template):
    ``..._kernelILi256EEEv...`` -> "<256>"."""
    import re
    m = re.match(r"I((?:Li-?\d+E)+)E", fn.split(kernel, 1)[1])
    if m is None:
        return ""
    return "<" + ", ".join(re.findall(r"Li(-?\d+)E", m.group(1))) + ">"


def check_ptxas(built) -> dict:
    """Phase 1's gate on ``_build.build_all()``'s logs: no spills and a
    0-byte stack frame (``TILE_STACK``'s where it names the kernel) for
    each of ``TILE_KERNELS`` (and each of ``TILE_INSTANCES``) that was
    built; returns their registers."""
    checked, registers = set(), {}
    for name, info in built.items():
        for fn, line in ptxas_lines(info["ptxas"]):
            print(f"[build] {name} {fn}: {line}", flush=True)
            kernel = next((k for k in TILE_KERNELS if k in fn), None)
            if kernel is None:
                continue
            label = kernel + template_args(fn, kernel)
            if line.startswith("Used "):
                registers[label] = int(line.split()[1])
            if "stack frame" in line:
                if not line.startswith(f"{TILE_STACK.get(kernel, 0)} bytes "
                                       "stack frame, 0 bytes spill stores, "
                                       "0 bytes spill loads"):
                    raise AssertionError(f"{fn}: ptxas reports {line}")
                checked.add(kernel)
                checked.add(label)
    missing = [k for k, src in TILE_KERNELS.items()
               if src in built and k not in checked]
    missing += [k + a for k, args in TILE_INSTANCES.items()
                if TILE_KERNELS[k] in built for a in args
                if k + a not in checked]
    if missing:
        raise AssertionError(f"ptxas reported nothing for {missing}")
    print(f"[build] stack frames 0 bytes (allowed: {TILE_STACK}), no spills; "
          f"registers {registers}", flush=True)
    return registers


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import gemma2_27b, gemma3_12b, ingp_asdr
    from repro_torch.kernels import _build

    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"[build] {time.perf_counter() - t0:.1f} s for {sorted(built)}",
          flush=True)
    check_ptxas(built)
    dev = torch.device("cuda")
    bundle = ingp_asdr.CONFIG
    check_smem(bundle, gemma2_27b.CONFIG, gemma3_12b.CONFIG)
    rows = run(dev, bundle, bundle.image_hw, gemma2_27b.CONFIG, ATTN_SEQ,
               gemma3_12b.CONFIG, WIDE_SEQ)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card_label(dev), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
