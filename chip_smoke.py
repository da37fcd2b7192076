#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repo root; needs one CUDA card

Phases (any failure exits nonzero and prints no result line):

  1. device  — the card's name and power limit (``nvidia-smi``), the torch
               and CUDA versions; TF32 off for matmuls and convolutions.
  2. build   — every hand-written kernel of the port, compiled from the
               sources in this checkout (one ``nvcc`` per source, all started
               together), with ``-Xptxas -v``: registers, shared memory,
               spills and build seconds.
  3. kernels — graft_select against its plain PyTorch twin on the card, at
               the training paths' widths (d 2304, 4096, 1600, 5120, 1536 and
               6144, where the basis takes global memory) and on
               degenerate inputs (exact equality where the arithmetic is the
               same, a stated tolerance where only the summation order
               differs), then timed with CUDA events and by the profiler's
               device time against the twin and its bound at d 2304, 4096
               and 6144; its global-W plan
               at V 1024×64 against the twin; every pair of W plan and basis
               plan (shared or global) that fits bit-equal to the pair the
               wrapper picks; the batched kernel's rows bit-equal to the
               single kernel; fast_maxvol at (K,R,rank) (16,8,8),
               (256,32,32), (1024,64,64), (2048,256,256) and
               projection_sweep at (d,R) (2304,8), (1024,32), (16384,64)
               against their plain versions and bit-equal to the fused
               kernel's pivots and errors; each timed.
  4. flash   — the flash-attention forward, dQ and dK/dV kernels against
               their plain versions at the slice's selection shape (576
               streams) and its subset's at rank 2 and 8 (72 and 288
               streams), minicpm at 4096 tokens, gemma2-27b's attention
               (window 4096, softcap 50, GQA 2, S 8192), stablelm's Dh 160
               with GQA 4, the smoke Dh 12 in f32, window 0, bidirectional
               and Dh 16 in bf16 with GQA 2, qwen3-moe's GQA 16 at Dh 128
               (64 heads over 4), qwen1.5-32b's 40 heads at Dh 128, hymba's GQA 5 (25 heads over 5, Dh 64) at
               S 256 and with its window 1024 at S 2048 (bf16 runs on the tensor cores,
               float32 on the float32 cores); bounded vs exhaustive KV loops
               and two runs on the same inputs bit-equal; each timed against
               its plain version, its bound and, where it computes the same
               function, PyTorch's scaled_dot_product_attention, with the
               ratios to SDPA and to the bound (every row also in
               ``build/chip_smoke_flash.json``).
  5. optim   — the optimizer step's kernels on minicpm-2b's leaves at full
               depth (2.725 B params): grad_norm (A) against its plain
               version at rtol 1e-6, reruns bit-equal; optimizer_update (B)
               bit-equal to its plain version over 3 steps for AdamW, SGD and
               Lion, bf16 and float32 params, float32 and bf16 state, given
               A's clip factor (in batches of leaves that fit twice); then A
               and B timed on the slice's dtypes by CUDA events and profiler
               device time beside their bounds, their plain versions and
               torch.nn.utils.get_total_norm / torch.optim.AdamW(fused=True)
               (with float32 moments, B's function, on float32 copies of the
               params and grads — the kernels line's library time — and with
               moments in the params' dtype, bf16).
  6. slice   — the training path through the user entry point
               (``repro_torch.api.Trainer``) on minicpm-2b at full width and
               depth: 6 steps, GRAFT refresh every 2 steps through the
               kernel, attention ``auto``, which must resolve to flash. The
               kernels' launch counts are zeroed just before and read just
               after; each must equal what the path reckons
               (``repro_torch.analysis.launch_audit``, the reckoning this
               script and the analysis battery share; 0 for the
               selection kernels the training path does not run; those are
               counted where phase engine drives them; grad_norm one a step,
               optimizer_update one a step per dtype group).
  7. engine  — the multi-batch selection engine on the slice's trained
               params: a 4-microbatch stack (16 × 256 each, ``SyntheticLM.
               microbatch_stack``) through ``selection_inputs`` (flash) and
               ``select_multi_batch`` (GRAFT, ``use_pallas``): exactly one
               batched launch, bit-equal to a loop of ``select_batch`` (4
               single launches), pivots and ranks equal to the plain chain;
               the ``kernels/ops`` chain fast_maxvol → gather →
               projection_sweep on the same stack, bit-equal to the fused
               kernel; all three timed, and again at the selection
               benchmark's shape B=8, K=256, R=32, d=1024, rank 32.
  8. samplers — the selection breadth on the slice's trained params at full
               width (d 2304, K 16, R 8), one 16 × 256 batch: every feature
               source (svd, sketch_svd, pca_sketch, pooled_raw, ica; V up to
               column sign within 1e-4 of max|V|) and the probe and
               logit_embed grad sources (G within 1e-5 of max|G|, logit_embed's
               peak memory) against the CPU on the same inputs; the eight
               samplers through ``select_batch`` against the CPU (pivots
               equal, CRAIG's up to an exact tie of its gains; weights
               bit-equal, GradMatch's within rtol 1e-4; errors within 1e-5);
               streaming_graft over 4 refreshes with its carry (one
               graft_select launch a refresh, the carry against the CPU's,
               ``fd_update`` timed); each timed by CUDA events. Then the
               Trainer at 8 layers, 6 steps: streaming_graft (3 graft_select
               launches, the carry's count 3) and ``graft.overlap`` (which
               runs the sequential step) beside the sequential step from the
               same seed: losses, ranks, pivots and flash launches equal,
               steady step times.
  9. profile — where a steady step's time goes: the selection refresh, the
               subset forward/backward, grad norm and the AdamW update timed
               apart with CUDA events on the trained state, and the top
               kernels of one whole step by device time (torch.profiler).
 10. depth8  — the same slice with depth cut to 8 layers, same seed, one
               call: dense attention beside flash (dense, flash, flash,
               dense), steady step times; remat full beside dots under flash
               (full, dots, dots, full): exact launch counts, steady step
               times, peak memory, the GEMM kernels of a profiled refresh
               step (fewer under dots) and the losses (bit-equal); the
               baseline step (GRAFT off, batch 16) with train.microbatches 1
               beside 4 (1, 4, 4, 1): the step-0 losses (rtol 1e-5), the
               later losses (rtol 1e-3), steady step times and peak memory.
 11. rwkv    — the RWKV6 recurrence's forward and backward kernels against
               their plain versions: the JAX kernel test's four shapes, the
               rwkv6-7b selection forward (BH 1024 = 16 × 64 heads, T 256,
               D 64), the subset's forward and backward at rank 8 (BH 512)
               and at rank 2 (BH 128), again with decays down to 0, a long
               context (BH 64, T 4096), a T that is not a multiple of the
               time tile and D 256, which the model never uses; reruns
               bit-equal, the no-grad forward equal to the one that saves
               states, ``ops.rwkv_scan`` equal for every chunk. Each timed
               against its plain version and its bound (no single PyTorch
               call computes it); the kernels line takes the forward at BH
               1024 and the backward at BH 128.
 12. rwkv_slice — ``Trainer`` on rwkv6-7b at full width with depth cut to
               16 of 32 layers: 6 steps, the slice's GRAFT settings, exact
               launch counts (rwkv_scan 16 × (6·2 + 3), its backward 16 × 6,
               graft_select 3, flash 0), peak memory; then the profile of
               phase 9 on its trained state.
 13. families — Trainer at full width, 6 steps at the slice's GRAFT
               settings from seed 0: qwen3-moe-235b-a22b (moe: 128 experts
               top-8, GQA 16) at 2 of 94 layers with bf16 moments,
               hymba-1.5b (hybrid: attention ∥ SSM heads, GQA 5, window
               1024) at full depth, qwen1.5-32b (dense, QKV bias, d 5120) at
               4 of 64 layers: exact launch counts (flash forward 3·L +
               6·2·L, dQ and dK/dV 6·L, graft_select 3, grad_norm 6,
               optimizer_update 6 a dtype group), finite losses, ranks in
               rset, steady step time and peak memory; for hymba the profile
               of phase 9 and the SSM loop's calls of one refresh step run
               alone (launches, device time).
 14. classify — the classification task through Trainer at full width, 6
               steps at the slice's GRAFT settings, batch 16, eval every 2
               steps: musicgen-medium (audio frames, 48 layers, d 1536) on
               synthetic_classification at 4 frames (attention dense) and at
               64 frames of 3072 features (flash), internvl2-26b (vision
               patches, d 6144, 8 of 48 layers) on 32 × 32 synthetic_vision
               (S 65, dense): exact launch counts (the eval forwards
               included), finite losses, ranks in rset, eval_acc in [0, 1],
               steady step time and peak memory.
 15. serve   — ``launch/serve.py`` at the JAX defaults (4 slots, 8 requests
               of 8 tokens, 16 new tokens, max_seq 128, seed 0) at full width:
               minicpm-2b, rwkv6-7b and hymba-1.5b at full depth,
               qwen3-moe-235b-a22b at 2 of 94 layers (dropless decode over
               128 experts): all requests done, reruns equal, no kernel of
               the port launched, tokens/s, the prefill and one decode tick
               by CUDA events and one tick under the profiler, peak memory;
               then minicpm-2b at 8 layers, prefill 8 tokens and 16 decode
               steps against the teacher-forced forward.
 16. check   — the same path at smoke size on the card against the port's
               CPU run (which the CPU tests hold against the JAX package):
               minicpm and gemma2 (seq 32, so that its window of 16 bites)
               under flash attention, rwkv6-7b through the RWKV kernels,
               qwen1.5-32b, qwen3-moe, kimi-k2 (its dense first block) and
               hymba (seq 32: window 16) under flash;
               then minicpm under every other sampler (random, loss_topk,
               full, el2n, gradmatch, craig, glister, streaming_graft) and
               with sketch_svd or ica features, logit_embed or full grads.
               Per-step losses rtol 1e-4, ranks and pivots equal; one
               grad_norm and one optimizer_update per dtype group a step.
               For each of those selection cases one refresh is also run
               alone and counted: one flash forward a layer, and under full
               grads one flash dQ and dK/dV a layer for each example.
               Then musicgen-smoke on synthetic_classification (8 frames,
               flash) and internvl2-smoke on synthetic_vision (dense): losses,
               ranks, pivots and the eval against the CPU; and each family's
               smoke config decoding (prefill 8 tokens, then one step a token
               to max_seq; gemma2 at 32, so that its window bites) against
               the CPU, with no kernel launched.
 17. shell   — the Trainer shell at minicpm-2b's full width with depth cut
               to 2 layers (~405 M params, ~4 GB a checkpoint): an
               uninterrupted 6-step run with eval every 2 steps and a JSONL
               stream, then one that stops at step 3 with a checkpoint under
               ``build/`` and ``Trainer.from_checkpoint`` to step 6; the
               restored state bit-equal to the saved one, the resumed losses
               within rtol 1e-5 of the uninterrupted run's (PyTorch's own
               backward kernels may sum in another order), the JSONL rows
               with the JAX row keys, eval_loss and an mfu against the
               H100's 989 TFLOP/s; checkpoint bytes and save and restore
               seconds. Free disk is checked first; the directory is deleted.
 18. chaos   — the chaos harness (``repro_torch.resilience``) on the card.
               graft_select and fast_maxvol on V holding NaN (a NaN column,
               scattered NaNs, all NaN) at K 16 / R 8 (the warp routine) and
               K 40 and 64 / R 16 (the block routine): pivots equal to the
               twin's, distinct, in [0, K). (a) The five scenarios of
               ``python -m repro_torch.resilience`` at the reference's cell
               (smoke minicpm, 20 steps) with ``graft.use_pallas``: each
               scenario's bars, and graft_select and flash launches equal to
               what its dispatched steps reckon (one JSONL row a dispatched
               step, replays included). (b) nan_rollback at minicpm-2b's full
               width, 2 of 40 layers: 12 steps, a checkpoint every 4, step 10
               (a refresh step under refresh every 2) poisoned; one rollback
               to step 8, the uninjected resume from step 8 bit-equal, the
               poisoned JSONL row null with ``nonfinite_keys``, exact
               launches; device->host, write and restore seconds of each
               ~4 GB checkpoint. (c) A 3 s stall of step 2's DeviceClock
               event under a 0.3 s watchdog at the same width:
               ``device_stalled``, the run not blocked, the stalled window's
               rows on the dispatch clock. Free disk is checked first.

 19. analysis — the analysis battery (``python -m repro_torch.analysis``,
               ``repro_torch.analysis.runner``) on the card: (a) at the JAX
               probe shapes (the fused and streaming refresh at K 256, d 1024,
               R 32; the 2-layer flash probe model; the runtime probe, smoke
               minicpm); (b) at full width: the refresh contracts at
               minicpm-2b's K 16 / R 8 / d 2304 and at d 4096, the attention
               contract (B 4 × S 256) and the runtime probe on minicpm-2b's
               widths with depth cut to 2 of 40 layers (phase shell's cut).
               Every section's audited launches must equal torch.profiler's
               count of the CUDA kernels by name, no plain version may run,
               and every sum of the shared-memory estimator must equal the C
               library's (flash at every head dim in both types, the refresh
               plans at d 1536-6144, fast_maxvol, projection_sweep, the RWKV
               backward); any error finding fails the phase. Then the probe's
               steady step at the same width, 32 steps a run, with
               train.audit off, on, on, off, twice: what the audit costs a
               step.


 20. backend — data-parallel training through the execution backend
               (``repro_torch.backend``): (a) world size 1 over NCCL in this
               process, minicpm-2b at full width, 8 of 40 layers (phase
               depth8's cut), 6 steps, refresh every 2, in turns local,
               NCCL, NCCL, local: losses and every refresh's pivots bit-equal
               to the local backend's, every run's launches equal to the
               reckoning, the steady steps (the backend's cost); (b) two
               gloo ranks sharing the
               card, each a ``python -m repro_torch.backend --worker``
               subprocess (the Trainer under ``launch_audit.recording()``,
               its counts, losses, grad norms, pivots and a digest of its
               final parameters printed as JSON), minicpm-2b at full width,
               2 of 40 layers (phase shell's cut), 6 steps: each rank's
               launches equal to the one-rank reckoning (graft_select 3,
               grad_norm 6, optimizer_update 6 a dtype group, flash as
               reckoned), pivots equal across the ranks at every refresh,
               final parameters bit-equal across the ranks, finite losses,
               every step's loss and grad norm within rtol 3e-3 of a 1-rank
               run in the same call; the per-step relative differences and
               the gradient reduce's seconds printed.
 21. sharded — the sharded selection engine and the GPipe executor on a
               port ``Mesh`` (``repro_torch.backend.mesh``): (a) world size 1
               over NCCL in this process, a (1, 1) ("data", "model") mesh,
               every sampler at minicpm-2b's refresh shape (K 16, R 8, d
               2304): bit-equal to ``select_batch`` (state and carry; random
               draws from its shard's generator), one graft_select launch for
               graft and streaming_graft, none else, each timed beside
               select_batch; (b) two gloo ranks sharing the card, a ("data",)
               mesh, one refresh's inputs of minicpm-2b at full width and 8 of
               40 layers, batch 32 x 256 (V (32, 8), G (2304, 32)), 16 rows a
               rank, every sampler with ``use_pallas``, two calls (the second
               timed): each rank's launches
               as ``launch_audit.expected_sharded_launches`` reckons, the
               ranks' states bit-equal, pivots and rank equal to the per-shard
               pieces run in this process (each shard's selection on the card,
               the collectives' arithmetic on the host), floats within rtol
               1e-5; (c) ``pipeline_forward`` on two gloo ranks, a ("pod",)
               mesh, 4 of minicpm-2b's first 8 blocks a stage at full width,
               4 microbatches of (2, 256, 2304) bf16: bit-equal to the 8
               blocks run here one microbatch at a time, 20 flash forwards a
               rank ((S + M - 1) x 4), the bubble, tick and point-to-point
               times printed. (b) and (c) are one fleet of ``python -m
               repro_torch.backend --worker --job`` ranks.

 22. dryrun  — the dry run (``python -m repro_torch.launch.dryrun``): the
               slice's configuration (minicpm-2b, full depth, 16 × 256) and
               rwkv_slice's (rwkv6-7b, 16 layers) each traced once on fake
               cuda:0 tensors and run once for real through ``Trainer`` (one
               refresh step): the predicted peak within 10 % of
               ``max_memory_allocated`` (and printed beside phases slice's and
               rwkv_slice's 6-step peaks), the fake step's aten FLOPs equal
               to ``FlopCounterMode`` over the real one, the fake launches
               equal to the real ones and to ``expected_launches`` for one
               step. Then every supported (arch × shape × variant) cell on one
               device and on one device of the production mesh (16, 16),
               the required ones first (the slice's and rwkv_slice's
               train_4k cells, and the dense archs' decode_32k cells on the
               pod under ``default``, which must trace sharded and fit 80
               GB), then the others cheapest first, 7 at once in worker
               processes until the phase's 90 s: fits, peak GB, TFLOPs, collective bytes and
               trace seconds a cell, a line for each cell left out for time
               (all rows in ``build/chip_smoke_dryrun.json``).
 23. fsdp    — parameter sharding under JAX's ``fsdp`` preset (ZeRO-3): (a)
               the dry run's ``fsdp`` train_4k graft cells of the non-MoE
               archs on one device of the (16, 16) pod, fake cuda:0 tensors,
               4 worker processes until the phase's budget, minicpm-2b and
               qwen1.5-32b first (each must trace and fit 80 GB): peak, fit,
               TFLOPs and collective bytes by op a cell, a line for each
               cell left out; (b) the dry run's prediction for (c)'s mesh
               and configuration, one device of (2, 2); (c) four gloo ranks
               sharing the card on a (2, 2) ("data", "model") mesh, one fleet
               of ``python -m repro_torch.backend --worker --job`` ranks:
               minicpm-2b at full width, 2 of 40 layers, the slice's GRAFT
               settings (batch 16 × 256, rset [2,4,8], a refresh every 2), 2
               steps from seed 0, each rank its 4 rows: losses and every
               step's grad norm within rtol 3e-3 of the same configuration
               run in this process, ranks and pivots equal, each leaf of
               step 0's gradient (AdamW's first moment, gathered) within
               2e-2 (relative Frobenius norm) of the same step computed
               here with its subset split into the ranks' 4 parts, the
               gathered final parameters within 3e-3 of this process's (the
               whole set); each rank's resident
               parameters and moments exactly its shards' bytes, its
               ``max_memory_allocated`` over the steps within 10 % of (b),
               its launches as ``expected_launches(sharded=True)`` reckons.
 24. tp      — JAX's ``default`` preset on the dense family (the sequence,
               the attention queries, the MLP hidden and the vocabulary over
               ``"model"``): (a) the dry run's ``default`` train_4k graft
               cells of minicpm-2b, qwen1.5-32b (required; each must trace
               and fit 80 GB), stablelm-12b and gemma2-27b on one device of
               the (16, 16) pod, 4 worker processes until the phase's
               budget: peak, fit, TFLOPs and collective bytes by op, a line
               for each cell left out; (b) the dry run's prediction for (c);
               (c) four gloo ranks sharing the card on a (2, 2) ("data",
               "model") mesh, phase fsdp's run under ``default``: minicpm-2b
               at full width (vocabulary 122753: the logits stay whole over
               "model"), 2 layers, 2 steps (a refresh and a subset step),
               each rank its 8 rows' 128 of the 256 positions; held to the same run in this process as phase
               fsdp holds its fleet (step 0's gradient against the subset
               split into its 2 row parts), each rank's peak within 10 % of
               (b), its launches as ``expected_launches(sharded=True)``
               reckons, each flash launch with its rank's query offset; (d)
               the flash kernels with a query offset against their plain
               versions (halves and sixteenths of a sequence, a window, a
               softcap, GQA 2, Dh 64 and 128, bf16 and float32), the slices'
               forward and dQ bit-equal to the rows of the whole sequence's
               launch where a slice is whole tiles, and the offset kernels
               timed at the slice's 576-stream shape beside the whole one.
 25. serve_tp — sharded prefill and decode (no kernel of the port on this
               path): (a) the dry run's decode_32k cells on one device of
               the (16, 16) pod under ``fsdp`` (the dense archs,
               musicgen-medium and internvl2-26b; the dense archs'
               ``default`` decode cells are phase dryrun's) and under
               ``default`` (rwkv6-7b, hymba-1.5b, musicgen-medium,
               internvl2-26b), required to trace sharded and fit 80 GB,
               then their prefill_32k cells under ``default`` (the dense
               archs) and ``fsdp``, cheapest first, each with its shape's
               rules (decode_32k's cache positions over "model"), 4 worker
               processes until the phase's 60 s; the prefill_32k cells of
               hymba-1.5b and rwkv6-7b are left out for time (their
               prefills loop over tokens in Python); (b)
               the dry run's prediction for (c), the prefill and a tick of
               one device on the (2, 2) mesh; (c) four gloo ranks sharing
               the card, minicpm-2b at full width, 2 layers, bf16, under
               ``default`` with decode_32k's rules: a prefill of 4 × 512
               tokens into 1024 positions and 16 decode ticks fed this
               process's greedy tokens, each rank its 2 rows and 512 of the
               positions, the split-KV combine over "model": every tick's
               greedy tokens equal to the same run in this process's but
               where its bf16 logits tie within the logits' bar (the token
               taken then lies within the bar of its greedy one), the
               logits within 2^-7 of its largest, each rank's peak within
               10 % of (b), its resident cache exactly its slice's; tick ms
               and tokens/s beside this process's.
 26. moe_ep  — expert parallelism: qwen3-moe-235b-a22b at full width, 2
               layers, one refresh step on two gloo ranks sharing the card
               on a (1, 2) mesh, (a) under ``default`` with AdamW and (b)
               under ``fsdp`` with Adafactor, each held to the same run in
               this process, to the dry run's peak, to its shards' bytes and
               to the reckoned launches.
 27. tp_families — JAX's ``default`` preset on the ssm, audio, vlm and
               hybrid families: rwkv6-7b (float32), musicgen-medium and
               internvl2-26b at full width, 2 layers, 8 rows, and
               hymba-1.5b, 4 rows × 1280 positions (the local layer's
               window of 1024 cuts in at rank 1's query offset 640; its 25
               SSM heads do not divide 2, so each rank runs them whole on
               the gathered sequence), one refresh step on two gloo ranks
               sharing the card on a (1, 2) mesh; internvl2-26b's 768
               positions put its 256 patches and 128 tokens on rank 0;
               rwkv6-7b's ranks run the time mix on their 32 of 64 heads.
               Each rank held to the same run in this process (losses and
               grad norms at 3e-3, ranks and pivots equal, step 0's first
               moment a leaf at 2e-2, the final parameters at 3e-3), its
               peak within 10 % of the dry run's, its resident state
               exactly its shards, its launches as reckoned. The same
               launch then serves the four archs under ``default`` with
               decode_32k's rules (full width, 2 layers, 4 rows: a prompt
               of 64 tokens, of 64 frames, or of 256 patches and 64 tokens
               straddling rank 1's positions, then 6 ticks fed this
               process's greedy tokens): greedy tokens equal but at a bf16
               tie, logits within 2^-7 of their largest, each rank's
               resident cache exactly its part (the K/V positions, the
               RWKV state's heads over "model"; hymba's SSM state whole),
               its peak within 10 % of the dry run's. Then #8 and #8b at
               one rank's 256 and 128 streams against their plain
               versions, timed.

It prints a ``{"kernels": [...]}`` line (all eleven kernels), the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.
"""
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet) for the roofline bound
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

SLICE_OVERRIDES = [
    "model.smoke=false", 'model.overrides={"attn_backend": "auto"}',
    "graft.use_pallas=true", "graft.rset=[2,4,8]", "graft.eps=0.25",
    "graft.refresh_every=2", "train.batch=16", "train.seq=256",
    "train.steps=6", "train.log_every=1",
]

FLASH_REPLACES = {"flash_forward": "src/repro/kernels/flash_attention.py:210",
                  "flash_dq": "src/repro/kernels/flash_attention.py:232",
                  "flash_dkv": "src/repro/kernels/flash_attention.py:232"}

# (name, B, H, Hkv, S, Dh, dtype, causal, window, softcap). "slice" is the
# selection forward's 16 × 36 streams; "subset" and "subset_r8" the subset's
# forward and backward, r × 36 streams at the ranks phase slice reports (2
# and 8); "musicgen_64f" the selection forward of phase classify's run (b),
# 16 × 24 streams of 64 frames, one tile of the sequence
FLASH_SHAPES = [
    ("slice", 16, 36, 36, 256, 64, "bfloat16", True, None, None),
    ("subset", 2, 36, 36, 256, 64, "bfloat16", True, None, None),
    ("subset_r8", 8, 36, 36, 256, 64, "bfloat16", True, None, None),
    ("minicpm_4096", 1, 36, 36, 4096, 64, "bfloat16", True, None, None),
    ("gemma2_27b", 1, 32, 16, 8192, 128, "bfloat16", True, 4096, 50.0),
    ("stablelm_12b", 1, 32, 8, 2048, 160, "bfloat16", True, None, None),
    ("smoke_f32", 8, 6, 6, 16, 12, "float32", True, None, None),
    ("window0", 2, 4, 4, 128, 32, "float32", True, 0, None),
    ("bidirectional", 2, 16, 16, 1024, 64, "bfloat16", False, None, None),
    ("dh16_bf16_gqa2", 8, 6, 3, 256, 16, "bfloat16", True, None, None),
    ("qwen3_moe_gqa16", 16, 64, 4, 256, 128, "bfloat16", True, None, None),
    ("qwen15_32b", 16, 40, 40, 256, 128, "bfloat16", True, None, None),
    ("hymba_gqa5", 16, 25, 5, 256, 64, "bfloat16", True, None, None),
    ("hymba_window", 4, 25, 5, 2048, 64, "bfloat16", True, 1024, None),
    ("musicgen_64f", 16, 24, 24, 64, 64, "bfloat16", True, None, None),
]


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def cuda_time_ms(fn, iters: int, warmup: int = 5) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(ctx):
    import torch
    ctx["smi"] = nvidia_smi_line()
    print(ctx["smi"])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")


def phase_build(ctx):
    from repro_torch.kernels import build
    names = sorted(f[:-3] for f in os.listdir(build.CSRC) if f.endswith(".cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        built = list(pool.map(build.load, names))
    print(f"built {names} in {time.perf_counter() - t0:.2f} s (wall, in parallel)")
    for b in built:
        print(f"[{b.name}] nvcc {b.build_s:.2f} s -> {os.path.relpath(b.path, ROOT)}")
        entry = None
        for line in b.ptxas_log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = _kernel_instance(m.group(1))
            elif entry and ("registers" in line or "spill" in line):
                print(f"[{b.name}] {entry}: {line.strip()}")


def _kernel_instance(mangled: str) -> str:
    """A readable name for a flash template instance in the ptxas log: the
    float32-core kernels by (NC, TILE), the tensor-core ones by their padded
    head dim."""
    t = re.search(r"(flash_(?:fwd|dq|dkv)_kernel)ILi(\d+)ELi(\d+)", mangled)
    if t:
        return f"{t.group(1)}<f32, NC={t.group(2)}, TILE={t.group(3)}>"
    t = re.search(r"(flash_(?:fwd|dq|dkv)_mma_kernel)ILi(\d+)EE", mangled)
    return f"{t.group(1)}<bf16, DP={t.group(2)}>" if t else mangled[:60]


def _graft_inputs(kind, K, R, d, rank, dev, seed=0):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    V = rng.normal(size=(K, R)).astype(np.float32)
    if kind == "rank_deficient":            # duplicate rows and a zero column
        V[K // 2:] = V[:K - K // 2]
        V[:, R // 2] = 0.0
    elif kind == "ties":
        V = rng.choice([-2.0, -1.0, 1.0, 2.0], size=(K, R)).astype(np.float32)
    G = rng.normal(size=(d, K)).astype(np.float32)
    gb = G.mean(axis=1).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (V, G, gb)] + [rank]


def _bound(nbytes, flops, peak=F32_FLOP_PER_S):
    """Least time on an H100: bytes over HBM bandwidth vs operations over
    the peak of their type (float32 on the CUDA cores unless given),
    whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), \
        nbytes, flops


def _cost_bound(cost, peak=F32_FLOP_PER_S):
    """``_bound`` of a kernel module's cost function's (operations, bytes):
    the one reckoning of each kernel's work, which the dry run sums too."""
    flops, nbytes = cost
    return _bound(nbytes, flops, peak)


def _graft_bound(K, R, d, rank, B=1):
    """The refresh (B of them): its inputs read once and its outputs written
    once, vs its operations (``kernels/graft_select.py`` ``cost``)."""
    from repro_torch.kernels import graft_select as gs
    return _cost_bound(gs.cost(K, R, d, rank, B))


def _entry(name, replaces, launches, err, ms, plain_ms, bound, device_ms=None):
    """A kernels-line entry for a kernel of graft_select.cu: no single
    PyTorch call computes any of them, so there is no library time. The
    refresh's entries also carry the profiler's device time."""
    entry = {"name": name, "route": "cuda", "source": "src/repro_torch/csrc/graft_select.cu",
             "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
             "library_ms": None}
    if device_ms is not None:
        entry["device_ms"] = device_ms
    return entry


def _device_times(fn, match):
    """(CUDA-event ms, profiler device ms) per call of ``fn``, the device
    time summed over the kernels whose names hold ``match``
    (``tools/flash_ab.py``'s ``times``)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from flash_ab import times
    return times(fn, cuda_time_ms, match=match, max_iters=500)


def phase_kernels(ctx):
    import numpy as np
    import torch
    from repro_torch.kernels.graft_select import graft_select, graft_select_reference
    dev = torch.device("cuda")
    # the training paths' widths: minicpm-2b's d 2304, rwkv6-7b's and
    # qwen3-moe's 4096, hymba-1.5b's 1600, qwen1.5-32b's 5120, musicgen's
    # 1536 and internvl2-26b's 6144 (where the basis no longer fits beside
    # the pivot columns and takes the global plan)
    cases = [("slice", 16, 8, 2304, 8), ("rwkv", 16, 8, 4096, 8), ("hymba", 16, 8, 1600, 8),
             ("qwen15", 16, 8, 5120, 8), ("musicgen", 16, 8, 1536, 8),
             ("internvl2", 16, 8, 6144, 8), ("wide", 256, 64, 4096, 64),
             ("square", 16, 16, 2304, 16), ("rank_deficient", 64, 8, 2304, 6),
             ("ties", 12, 6, 512, 6)]
    err_atol, lv_rtol = 1e-5, 1e-5
    for kind, K, R, d, rank in cases:
        args = _graft_inputs(kind, K, R, d, rank, dev)
        got = graft_select(*args)
        torch.cuda.synchronize()
        want = graft_select_reference(*args)
        piv_eq = torch.equal(got[0].long(), want[0].long())
        gsel_eq = torch.equal(got[3], want[3])
        err_d = (got[1] - want[1]).abs().max().item()
        lv_d = abs(got[2].item() - want[2].item())
        lv_ok = lv_d <= lv_rtol * abs(want[2].item()) + 1e-7
        ok = piv_eq and gsel_eq and err_d <= err_atol and lv_ok
        print(f"[graft_select] {kind} K={K} R={R} d={d} rank={rank}: pivots "
              f"{'equal' if piv_eq else 'DIFFER'}, G_sel {'equal' if gsel_eq else 'DIFFERS'}, "
              f"max|errors diff| {err_d:.3g} (atol {err_atol}), |logvol diff| {lv_d:.3g} "
              f"(rtol {lv_rtol}; sums in another order) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"graft_select disagrees with its twin on {kind}")
        if kind == "slice":
            ctx["graft_max_abs_err"] = max(err_d, lv_d)
    # time at the training paths' shapes: minicpm-2b's d 2304 (the kernels
    # line), rwkv6-7b's d 4096 and internvl2-26b's d 6144 (global basis)
    for K, R, d, rank in ((16, 8, 2304, 8), (16, 8, 4096, 8), (16, 8, 6144, 8)):
        args = _graft_inputs("slice", K, R, d, rank, dev, seed=1)
        ms = cuda_time_ms(lambda: graft_select(*args), iters=500, warmup=20)
        _, device_ms = _device_times(lambda: graft_select(*args), "graft_select")
        plain_ms = cuda_time_ms(lambda: graft_select_reference(*args), iters=50, warmup=5)
        bound_ms, bound_by, nbytes, flops = _graft_bound(K, R, d, rank)
        print(f"[graft_select] K={K} R={R} d={d} rank={rank}: kernel {ms:.4f} ms "
              f"(events), {device_ms:.4f} ms (profiler device time), twin {plain_ms:.4f} ms, "
              f"bound {bound_ms:.6f} ms by {bound_by} ({nbytes} bytes, {flops} flop); "
              f"{device_ms / bound_ms:.0f}x the bound by device time", flush=True)
        if d == 2304:
            ctx["kernels"] = {"graft_select": _entry(
                "graft_select", "src/repro/kernels/graft_select.py:137", None,
                ctx["graft_max_abs_err"], ms, plain_ms, (bound_ms, bound_by), device_ms)}
    _kernels_wide_and_global(dev)
    _kernels_standalone(ctx, dev)


def _random_refresh(K, R, d, dev, B=None, seed=0):
    """Seeded V, G, ḡ on the card, with a leading B when given."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    lead = () if B is None else (B,)
    V = rng.normal(size=lead + (K, R)).astype(np.float32)
    G = rng.normal(size=lead + (d, K)).astype(np.float32)
    gb = G.mean(axis=-1).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (V, G, gb)]


def _refresh_diff(got, want):
    """(pivots equal, G_sel equal, max|errors diff|, |logvol diff|)."""
    import torch
    return (torch.equal(got[0].long(), want[0].long()), torch.equal(got[3], want[3]),
            (got[1] - want[1]).abs().max().item(),
            (got[2] - want[2]).abs().max().item())


def _all_equal(a, b):
    import torch
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _kernels_wide_and_global(dev):
    """graft_select at the wide shape and on the global-W plan; the batched
    kernel's rows against the single kernel."""
    import torch
    from repro_torch.analysis import smem
    from repro_torch.kernels import graft_select as gs
    for K, R, d, rank in ((256, 64, 4096, 64), (1024, 64, 1024, 64)):
        args = _random_refresh(K, R, d, dev, seed=2) + [rank]
        plan = gs.choose_plan(K, R, rank)
        got = gs.graft_select(*args)
        torch.cuda.synchronize()
        piv_eq, gsel_eq, err_d, lv_d = _refresh_diff(got, gs.graft_select_reference(*args))
        lv_ok = lv_d <= 1e-5 * abs(got[2].item()) + 1e-7
        ok = piv_eq and gsel_eq and err_d <= 1e-5 and lv_ok
        ms = _time_auto(lambda: gs.graft_select(*args), max_iters=200)
        plain_ms = _time_auto(lambda: gs.graft_select_reference(*args))
        b_ms, b_by, nbytes, flops = _graft_bound(K, R, d, rank)
        print(f"[graft_select] {plan} plan K={K} R={R} d={d} rank={rank}: pivots "
              f"{'equal' if piv_eq else 'DIFFER'}, G_sel {'equal' if gsel_eq else 'DIFFERS'}, "
              f"max|errors diff| {err_d:.3g} (atol 1e-05), |logvol diff| {lv_d:.3g} "
              f"(rtol 1e-05) -> {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.6f} ms by {b_by} ({nbytes} bytes, "
              f"{flops} flop); {ms / b_ms:.0f}x the bound", flush=True)
        if not ok:
            raise AssertionError(f"graft_select disagrees with its twin at K={K} R={R}")
    # every pair of W plan (MaxVol's working set) and basis plan (Qᵀ and ĝ)
    # that fits the block, against the pair the wrapper picks
    for K, R, d, rank in ((16, 8, 2304, 8), (16, 8, 4096, 8), (16, 8, 6144, 8),
                          (256, 64, 4096, 64), (64, 8, 2304, 6)):
        args = _random_refresh(K, R, d, dev, seed=3) + [rank]
        want = gs.graft_select(*args)
        pairs = [(p, q) for p in gs.PLANS for q in gs.PLANS
                 if smem.graft_select_smem(K, R, d, rank, p, q).fits]
        same = {pq: _all_equal(gs.graft_select(*args, plan=pq[0], basis=pq[1]), want)
                for pq in pairs}
        t = {pq: _time_auto(lambda pq=pq: gs.graft_select(*args, plan=pq[0], basis=pq[1]),
                            max_iters=500) for pq in pairs}
        print(f"[graft_select] K={K} R={R} d={d} rank={rank}: picks W plan "
              f"{gs.choose_plan(K, R, rank)}, basis plan "
              f"{gs.choose_basis(K, R, d, rank, gs.choose_plan(K, R, rank))}; "
              + ", ".join(f"W {p} / basis {q} {'bit-equal' if same[(p, q)] else 'DIFFERS'} "
                          f"{t[(p, q)]:.4f} ms" for p, q in pairs)
              + " (pivots, errors, logvol, G_sel)", flush=True)
        if not all(same.values()):
            raise AssertionError("graft_select's plans disagree")
    for B, K, R, d, rank in ((4, 16, 8, 2304, 8), (4, 16, 8, 4096, 8), (8, 256, 32, 1024, 32)):
        Vs, Gs, gbs = _random_refresh(K, R, d, dev, B=B, seed=4)
        got = gs.graft_select_batched(Vs, Gs, gbs, rank)
        rows = all(_all_equal([t[b] for t in got], gs.graft_select(Vs[b], Gs[b], gbs[b], rank))
                   for b in range(B))
        print(f"[graft_select_batched] B={B} K={K} R={R} d={d} rank={rank}: every row "
              f"{'bit-equal to' if rows else 'DIFFERS from'} the single kernel", flush=True)
        if not rows:
            raise AssertionError("the batched kernel disagrees with the single kernel")


def _kernels_standalone(ctx, dev):
    """fast_maxvol and projection_sweep against their plain versions and
    the fused kernel, each timed against its bound."""
    import torch
    from repro_torch.analysis import smem
    from repro_torch.core import maxvol as maxvol_lib
    from repro_torch.core import projection as proj_lib
    from repro_torch.kernels import fast_maxvol as fm
    from repro_torch.kernels import graft_select as gs
    from repro_torch.kernels import projection_sweep as ps
    for K, R, rank in ((16, 8, 8), (256, 32, 32), (1024, 64, 64), (2048, 256, 256)):
        V, G, gb = _random_refresh(K, R, 64, dev, seed=K)
        piv, lv = fm.fast_maxvol(V, rank)
        piv_r, lv_r = maxvol_lib.fast_maxvol(V, rank)
        fused = gs.graft_select(V, G, gb, rank)
        torch.cuda.synchronize()
        lv_d = abs(lv.item() - lv_r.item())
        ok = (torch.equal(piv.long(), piv_r.long()) and torch.equal(piv, fused[0])
              and torch.equal(lv, fused[2]) and lv_d <= 1e-5 * abs(lv_r.item()) + 1e-7)
        ms = _time_auto(lambda: fm.fast_maxvol(V, rank), max_iters=500)
        plain_ms = _time_auto(lambda: maxvol_lib.fast_maxvol(V, rank))
        bound = _cost_bound(fm.cost(K, R, rank))
        print(f"[fast_maxvol] {gs.choose_plan(K, R, rank)} plan K={K} R={R} rank={rank}: "
              f"pivots {'equal' if ok else 'DIFFER or'} to the plain version's and "
              f"graft_select's, logvol bit-equal to graft_select's, |logvol diff| vs plain "
              f"{lv_d:.3g} (rtol 1e-05) -> {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound[0]:.6f} ms by {bound[1]} "
              f"({bound[2]} bytes, {bound[3]} flop); {ms / bound[0]:.0f}x the bound", flush=True)
        if not ok:
            raise AssertionError(f"fast_maxvol disagrees at K={K} R={R} rank={rank}")
        if (K, R, rank) == (16, 8, 8):
            ctx["kernels"]["fast_maxvol"] = _entry(
                "fast_maxvol", "src/repro/kernels/fast_maxvol.py:55", None, lv_d,
                ms, plain_ms, bound)
    for d, R in ((2304, 8), (1024, 32), (16384, 64)):
        V, G, gb = _random_refresh(R, R, d, dev, seed=d)
        # G_sel from the fused kernel where its 12 MB guard admits the shape
        fits = smem.fused_select_vmem(R, R, d, R).fits
        fused = gs.graft_select(V, G, gb, R) if fits else None
        G_sel = fused[3] if fits else G
        err = ps.projection_sweep(G_sel, gb)
        err_r = proj_lib.prefix_projection_errors(G_sel, gb)
        torch.cuda.synchronize()
        err_d = (err - err_r).abs().max().item()
        same = torch.equal(err, fused[1]) if fits else None
        plans_eq = torch.equal(ps.projection_sweep(G_sel, gb, plan="global"), err)
        ok = err_d <= 1e-5 and same is not False and plans_eq
        ms = _time_auto(lambda: ps.projection_sweep(G_sel, gb), max_iters=500)
        plain_ms = _time_auto(lambda: proj_lib.prefix_projection_errors(G_sel, gb))
        bound = _cost_bound(ps.cost(d, R))
        vs_fused = ("bit-equal to the fused kernel's" if same else "DIFFER from the fused kernel's"
                    ) if fits else "(the fused kernel's 12 MB guard refuses this shape)"
        print(f"[projection_sweep] d={d} R={R}: max|errors diff| vs plain {err_d:.3g} "
              f"(atol 1e-05), errors {vs_fused}, global-scratch plan "
              f"{'bit-equal' if plans_eq else 'DIFFERS'} -> {'ok' if ok else 'FAIL'}; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound[0]:.6f} ms by {bound[1]} "
              f"({bound[2]} bytes, {bound[3]} flop); {ms / bound[0]:.0f}x the bound", flush=True)
        if not ok:
            raise AssertionError(f"projection_sweep disagrees at d={d} R={R}")
        if (d, R) == (2304, 8):
            ctx["kernels"]["projection_sweep"] = _entry(
                "projection_sweep", "src/repro/kernels/projection_sweep.py:50", None,
                err_d, ms, plain_ms, bound)


def _flash_inputs(B, H, Hkv, S, Dh, dtype, seed=0):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)

    def rnd(n):
        return torch.randn((n, S, Dh), generator=g, device="cuda").to(dt)
    return rnd(B * H), rnd(B * Hkv), rnd(B * Hkv), rnd(B * H)


def _flash_bound(kind, B, H, Hkv, S, Dh, dtype, causal, window):
    """Least time on an H100 (``kernels/flash_attention.py`` ``cost``):
    operations on the unmasked pairs at the peak of the input type, vs each
    input read and each output written once over HBM."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    peak = BF16_FLOP_PER_S if dtype == "bfloat16" else F32_FLOP_PER_S
    return _cost_bound(fa.cost(kind, B * H, B * Hkv, S, S, Dh, getattr(torch, dtype), causal,
                               window), peak)


def _flash_plain(fn, q, k, v, do, lse, delta, group, opts):
    """The plain version over chunks of kv streams (≤ 1 GB of f32 scores
    each), so the dense reference fits beside the inputs at S = 8192."""
    import torch
    BHkv, S = k.shape[0], k.shape[1]
    per = max(1, (1 << 30) // (group * q.shape[1] * S * 4))
    outs = []
    for c in range(0, BHkv, per):
        qs = slice(c * group, (c + per) * group)
        args = (q[qs], k[c:c + per], v[c:c + per])
        if do is not None:
            args += (do[qs], lse[qs], delta[qs])
        outs.append(fn(*args, group=group, **opts))
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def _time_auto(fn, budget_ms=300.0, max_iters=50):
    """CUDA-event time of fn, with the iteration count sized to the budget."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    return cuda_time_ms(fn, iters=int(min(max_iters, max(2, budget_ms / once))), warmup=1)


def phase_flash(ctx):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    rows = []
    for name, B, H, Hkv, S, Dh, dtype, causal, window, softcap in FLASH_SHAPES:
        group = H // Hkv
        q, k, v, do = _flash_inputs(B, H, Hkv, S, Dh, dtype)
        opts = dict(causal=causal, window=window, softcap=softcap)
        kw = dict(opts, group=group)

        def run(bound_loop=True):
            o, lse = fa.flash_forward(q, k, v, bound_loop=bound_loop, **kw)
            delta = (o.float() * do.float()).sum(-1)
            dq = fa.flash_dq(q, k, v, do, lse, delta, bound_loop=bound_loop, **kw)
            dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, bound_loop=bound_loop, **kw)
            torch.cuda.synchronize()
            return o, lse, delta, dq, dk, dv

        got = run()
        same = all(torch.equal(a, b) for a, b in zip(got, run()))
        bounded = all(torch.equal(a, b) for a, b in zip(got, run(bound_loop=False)))
        o, lse, delta, dq, dk, dv = got
        o_r, lse_r = _flash_plain(fa.flash_forward_reference, q, k, v, None, None, None,
                                  group, opts)
        dq_r = _flash_plain(fa.flash_dq_reference, q, k, v, do, lse, delta, group, opts)
        dk_r, dv_r = _flash_plain(fa.flash_dkv_reference, q, k, v, do, lse, delta,
                                  group, opts)
        torch.cuda.synchronize()
        # tolerance: float32 sums of up to S products in another order (f32:
        # 1e-4 of the largest value). bf16: 2^-7 of the largest value, one bf16
        # ulp there. The tensor-core forward and dK/dV round P (and dS) to bf16
        # once before their products, which adds at most 2^-9 sum_j p_j |v_j|
        # to o before its own rounding, and far less for random inputs; dQ
        # takes dS into dS.K as bf16 hi + lo (~16 bits), then rounds dQ once
        errs, ok = {}, same and bounded
        for what, a, b in (("o", o, o_r), ("dq", dq, dq_r), ("dk", dk, dk_r),
                           ("dv", dv, dv_r)):
            scale = b.float().abs().max().item()
            tol = 2.0 ** -7 * scale if dtype == "bfloat16" else 1e-4 * scale + 1e-6
            errs[what] = (a.float() - b.float()).abs().max().item()
            ok = ok and errs[what] <= tol and a.dtype == b.dtype
        fin = torch.isfinite(lse_r)
        ok = ok and torch.equal(fin, torch.isfinite(lse))
        errs["lse"] = (lse[fin] - lse_r[fin]).abs().max().item() if bool(fin.any()) else 0.0
        ok = ok and errs["lse"] <= 1e-4
        if window == 0:         # every row fully masked: exactly 0, lse +inf
            ok = ok and all(torch.equal(t, torch.zeros_like(t)) for t in (o, dq, dk, dv)) \
                and bool(torch.all(torch.isinf(lse) & (lse > 0)))
        print(f"[flash] {name}: B={B} H={H} Hkv={Hkv} S={S} Dh={Dh} {dtype} causal={causal} "
              f"window={window} softcap={softcap}: max|diff| "
              + ", ".join(f"{k_} {e:.3g}" for k_, e in errs.items())
              + f"; reruns {'bit-equal' if same else 'DIFFER'}, bounded vs exhaustive "
              f"{'bit-equal' if bounded else 'DIFFER'} -> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"flash kernels disagree with their plain versions on {name}")
        del o_r, lse_r, dq_r, dk_r, dv_r, got
        # times
        t = {"fwd": _time_auto(lambda: fa.flash_forward(q, k, v, **kw)),
             "dq": _time_auto(lambda: fa.flash_dq(q, k, v, do, lse, delta, **kw)),
             "dkv": _time_auto(lambda: fa.flash_dkv(q, k, v, do, lse, delta, **kw))}
        plain = {"fwd": _time_auto(lambda: _flash_plain(
                     fa.flash_forward_reference, q, k, v, None, None, None, group, opts)),
                 "dq": _time_auto(lambda: _flash_plain(
                     fa.flash_dq_reference, q, k, v, do, lse, delta, group, opts)),
                 "dkv": _time_auto(lambda: _flash_plain(
                     fa.flash_dkv_reference, q, k, v, do, lse, delta, group, opts))}
        lib = {"fwd": None, "bwd": None}
        if window is None and softcap is None:
            # scaled_dot_product_attention computes the same function; its one
            # backward call gives dQ, dK and dV together
            q4, k4, v4 = (x.view(B, -1, S, Dh).detach().requires_grad_() for x in (q, k, v))
            sdpa = dict(is_causal=causal, enable_gqa=group > 1, scale=Dh ** -0.5)
            lib["fwd"] = _time_auto(lambda: F.scaled_dot_product_attention(q4, k4, v4, **sdpa))
            o4 = F.scaled_dot_product_attention(q4, k4, v4, **sdpa)
            do4 = do.view(B, H, S, Dh)
            lib["bwd"] = _time_auto(lambda: torch.autograd.grad(
                o4, (q4, k4, v4), do4, retain_graph=True))
            del o4
        bounds = {kind: _flash_bound(kind, B, H, Hkv, S, Dh, dtype, causal, window)
                  for kind in t}
        for kind in t:
            b_ms, b_by, nbytes, flops = bounds[kind]
            lib_ms = lib["fwd"] if kind == "fwd" else lib["bwd"]
            vs_lib = "" if lib_ms is None else f", {t[kind] / lib_ms:.2f}x SDPA"
            print(f"[flash] {name} {kind}: kernel {t[kind]:.4f} ms, plain {plain[kind]:.4f} ms, "
                  f"library {'none' if lib_ms is None else f'{lib_ms:.4f} ms'}"
                  f"{' (SDPA backward: dQ, dK, dV in one call)' if lib_ms is not None and kind != 'fwd' else ''}, "
                  f"bound {b_ms:.4f} ms by {b_by} ({nbytes} bytes, {flops} flop); "
                  f"{t[kind] / b_ms:.1f}x the bound{vs_lib}", flush=True)
            rows.append({"shape": name, "kind": kind, "ms": t[kind], "plain_ms": plain[kind],
                         "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by})
        if lib["bwd"] is not None:
            print(f"[flash] {name} dq+dkv: {t['dq'] + t['dkv']:.4f} ms, "
                  f"{(t['dq'] + t['dkv']) / lib['bwd']:.2f}x SDPA backward", flush=True)
        if name == "slice":
            for kind, key in (("fwd", "flash_forward"), ("dq", "flash_dq"), ("dkv", "flash_dkv")):
                err = {"fwd": max(errs["o"], errs["lse"]), "dq": errs["dq"],
                       "dkv": max(errs["dk"], errs["dv"])}[kind]
                ctx["kernels"][key] = {
                    "name": key, "route": "cuda",
                    "source": "src/repro_torch/csrc/flash_attention.cu",
                    "replaces": FLASH_REPLACES[key], "launches": None,
                    "max_abs_err": err, "ms": t[kind], "plain_ms": plain[kind],
                    "bound_ms": bounds[kind][0], "bound_by": bounds[kind][1],
                    "library_ms": lib["fwd"] if kind == "fwd" else lib["bwd"]}
        del q, k, v, do, o, lse, delta, dq, dk, dv
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke_flash.json"), "w") as f:
        json.dump({"device": ctx["smi"], "rows": rows}, f, indent=1)


def _kernel_counters():
    """(name, holder, attribute) of every kernel's launch count: the
    registry of ``repro_torch.analysis.launch_audit``."""
    from repro_torch.analysis import launch_audit
    return launch_audit.kernel_counters()


def _zero_counts():
    from repro_torch.analysis import launch_audit
    launch_audit.zero_counts()


def _read_counts():
    from repro_torch.analysis import launch_audit
    return launch_audit.read_counts()


def _optim_groups(params):
    from repro_torch.analysis import launch_audit
    return launch_audit.optim_groups(params)


def _expected_launches(mcfg, cfg, groups, flash=True):
    """What the run reckons: ``launch_audit.expected_launches``, the one
    reckoning the audit and this script share."""
    from repro_torch.analysis import launch_audit
    return launch_audit.expected_launches(mcfg, cfg, groups, flash=flash)


def phase_slice(ctx):
    import numpy as np
    import torch
    from repro_torch.api import ExperimentConfig, Trainer
    cfg = ExperimentConfig().apply_overrides(SLICE_OVERRIDES)
    mcfg = cfg.model.build()
    n_params = (mcfg.vocab_size * mcfg.d_model + mcfg.d_model + mcfg.num_layers * (
        2 * mcfg.d_model + 4 * mcfg.d_model * mcfg.num_heads * mcfg.head_dim
        + 3 * mcfg.d_model * mcfg.d_ff))
    state_gb = n_params * (2 + 2 + 4 + 4) / 1e9   # bf16 params + grads, f32 m + v
    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    print(f"[slice] minicpm-2b full width: {mcfg.num_layers} layers, d_model "
          f"{mcfg.d_model}, {mcfg.num_heads} heads x {mcfg.head_dim}, d_ff {mcfg.d_ff}, "
          f"vocab {mcfg.vocab_size}, {mcfg.param_dtype} params, remat={mcfg.remat}, "
          f"attn_backend={mcfg.attn_backend}; {n_params / 1e9:.3f} B params -> "
          f"params+grads+AdamW state ~{state_gb:.1f} GB of {total_gb:.1f} GB; depth not cut")
    from repro_torch.models.layers import resolve_attn_backend
    backend = resolve_attn_backend(mcfg, cfg.train.seq, cfg.train.seq, torch.device("cuda"))
    print(f"[slice] attn_backend={mcfg.attn_backend} resolves to {backend} on the card")
    assert backend == "flash", f"auto resolved to {backend}, not flash"
    torch.cuda.reset_peak_memory_stats()
    trainer = ctx["trainer"] = Trainer(cfg)
    _zero_counts()
    t0 = time.perf_counter()
    report = trainer.fit()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ctx.setdefault("peaks", {})["slice"] = torch.cuda.max_memory_allocated()
    hist = report["history"]
    for i, row in enumerate(hist):
        print(f"[slice] step {i}: loss {row['loss']:.6f} rank {row['rank']} "
              f"proj_error {row['proj_error']:.4f} alignment {row['alignment']:.4f} "
              f"grad_norm {row['grad_norm']:.4f} step {row['step_time_s'] * 1e3:.1f} ms")
    print(f"[slice] fit wall {wall:.2f} s, peak memory allocated {peak_gb:.2f} GB, "
          f"kernel launches {launches}, config_hash {report['config_hash']}")
    expected = _expected_launches(mcfg, cfg, _optim_groups(trainer.state["params"]))
    print(f"[slice] expected launches {expected}")
    assert all(np.isfinite(r["loss"]) and r["healthy"] == 1.0 for r in hist), \
        "non-finite loss or a vetoed step"
    assert all(int(r["rank"]) in cfg.graft.rset for r in hist), "rank outside rset"
    assert launches == expected, f"launches {launches}, expected {expected}"
    for name in ("graft_select", "flash_forward", "flash_dq", "flash_dkv", "grad_norm",
                 "optimizer_update"):
        assert launches[name] > 0, f"kernel {name} was never launched on the main path"
        ctx["kernels"][name]["launches"] = launches[name]
    steady = [r["step_time_s"] for r in hist[1:]]
    print(f"[slice] steady step time (steps 1-5) mean {np.mean(steady) * 1e3:.1f} ms; "
          f"refresh steps {[r['step_time_s'] * 1e3 for r in hist[2::2]]} ms")


def _engine_compare(cfg, Vs, Gs, gbs, scores, step, what):
    """The engine's three routes on one stack: one batched launch, a loop
    of select_batch (one single launch per lane), and the plain chain.
    Asserts the launch counts and the agreements; returns the batched
    state and the launch counts of its call."""
    import dataclasses
    import torch
    from repro_torch.selection import engine
    B = Vs.shape[0]
    _zero_counts()
    multi, carry = engine.select_multi_batch(cfg, "graft", Vs, Gs, gbs, scores=scores,
                                             step=step)
    torch.cuda.synchronize()
    counts = _read_counts()
    assert carry == {}, f"graft carries nothing, got {carry}"
    assert counts == dict({k: 0 for k in counts}, graft_select_batched=1), \
        f"{what}: select_multi_batch launched {counts}, expected one batched launch"
    _zero_counts()
    singles = [engine.select_batch(cfg, "graft", Vs[b], Gs[b], gbs[b], scores=scores[b],
                                   step=step)[0] for b in range(B)]
    torch.cuda.synchronize()
    loop_counts = _read_counts()
    assert loop_counts == dict({k: 0 for k in counts}, graft_select=B), loop_counts
    loop_eq = all(torch.equal(getattr(multi, f)[b], getattr(singles[b], f))
                  for b in range(B) for f in multi._fields)
    plain, _ = engine.select_multi_batch(dataclasses.replace(cfg, use_pallas=False), "graft",
                                         Vs, Gs, gbs, scores=scores, step=step)
    torch.cuda.synchronize()
    piv_eq = torch.equal(multi.pivots, plain.pivots) and torch.equal(multi.rank, plain.rank)
    err_d = max((multi.last_error - plain.last_error).abs().max().item(),
                (multi.alignment - plain.alignment).abs().max().item())
    print(f"[engine] {what}: select_multi_batch launched {counts['graft_select_batched']} "
          f"batched kernel; the select_batch loop {loop_counts['graft_select']} single "
          f"launches, every field {'bit-equal' if loop_eq else 'DIFFERS'}; plain chain "
          f"pivots and ranks {'equal' if piv_eq else 'DIFFER'}, max|last_error, alignment "
          f"diff| {err_d:.3g} (atol 1e-05); ranks {multi.rank.tolist()}", flush=True)
    assert loop_eq, f"{what}: the batched path differs from the select_batch loop"
    assert piv_eq and err_d <= 1e-5, f"{what}: the batched path differs from the plain chain"
    return multi, counts


def _engine_times(cfg, Vs, Gs, gbs, scores, step, what):
    """Device times of the batched launch, B single launches and the plain
    chain (kernel level), and of the engine call on both routes."""
    import dataclasses
    from repro_torch.kernels import graft_select as gs
    from repro_torch.selection import engine
    B, r = Vs.shape[0], cfg.r_max
    plain_cfg = dataclasses.replace(cfg, use_pallas=False)
    t = {"batched": _time_auto(lambda: gs.graft_select_batched(Vs, Gs, gbs, r), max_iters=500),
         "batched_device": _device_times(lambda: gs.graft_select_batched(Vs, Gs, gbs, r),
                                         "graft_select")[1],
         "singles": _time_auto(lambda: [gs.graft_select(Vs[b], Gs[b], gbs[b], r)
                                        for b in range(B)], max_iters=500),
         "plain": _time_auto(lambda: gs.graft_select_batched_reference(Vs, Gs, gbs, r)),
         "engine": _time_auto(lambda: engine.select_multi_batch(
             cfg, "graft", Vs, Gs, gbs, scores=scores, step=step), max_iters=200),
         "engine_plain": _time_auto(lambda: engine.select_multi_batch(
             plain_cfg, "graft", Vs, Gs, gbs, scores=scores, step=step))}
    K, R, d = Vs.shape[1], Vs.shape[2], Gs.shape[1]
    bound = _graft_bound(K, R, d, r, B=B)
    print(f"[engine] {what} B={B} K={K} R={R} d={d} rank={r}: one batched launch "
          f"{t['batched']:.4f} ms (events), {t['batched_device']:.4f} ms (profiler device "
          f"time), {B} single launches {t['singles']:.4f} ms, plain chain "
          f"{t['plain']:.4f} ms; select_multi_batch with the epilogue {t['engine']:.4f} ms "
          f"(use_pallas) vs {t['engine_plain']:.4f} ms (plain); bound {bound[0]:.6f} ms by "
          f"{bound[1]} ({bound[2]} bytes, {bound[3]} flop); batched "
          f"{t['batched'] / bound[0]:.0f}x the bound", flush=True)
    return t, bound


def phase_engine(ctx):
    """The multi-batch selection engine at full width on the trained params."""
    import numpy as np
    import torch
    from repro_torch.kernels import graft_select as gs
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as steps_lib
    from repro_torch.selection import GraftConfig
    tr = ctx["trainer"]
    mcfg, tcfg = tr.mcfg, tr.tcfg
    cfg, B, step = tcfg.graft, 4, 6
    stack = tr.data.microbatch_stack(step=step, num_micro=B)
    _zero_counts()
    with torch.no_grad():
        per = [steps_lib.selection_inputs(mcfg, tcfg, tr.state["model"], {
            k: torch.from_numpy(np.ascontiguousarray(v[b])).to("cuda")
            for k, v in stack.items()}) for b in range(B)]
    torch.cuda.synchronize()
    sel_counts = _read_counts()
    Vs, Gs, gbs, scores = (torch.stack(x).contiguous() for x in zip(*per))
    print(f"[engine] microbatch_stack(step={step}, num_micro={B}): tokens "
          f"{stack['tokens'].shape}; selection inputs V {tuple(Vs.shape)}, G "
          f"{tuple(Gs.shape)}, g_bar {tuple(gbs.shape)}, scores {tuple(scores.shape)}; "
          f"flash forwards {sel_counts['flash_forward']} ({B} x {mcfg.num_layers} layers)",
          flush=True)
    assert Vs.shape == (B, tr.config.train.batch, cfg.r_max) and Gs.shape[2] == Vs.shape[1]
    assert sel_counts["flash_forward"] == B * mcfg.num_layers, sel_counts
    assert all(bool(torch.isfinite(x).all()) for x in (Vs, Gs, gbs, scores))
    multi, path_counts = _engine_compare(cfg, Vs, Gs, gbs, scores, step, "slice stack")
    # the same stack through kernels/ops: MaxVol, gather, sweep
    r = cfg.r_max
    fused = gs.graft_select_batched(Vs, Gs, gbs, r)
    _zero_counts()
    chain = []
    for b in range(B):
        piv, lv = ops.fast_maxvol_with_logvol(Vs[b], r)
        err = ops.projection_sweep(Gs[b].index_select(1, piv), gbs[b])
        chain.append((piv, err, lv))
    torch.cuda.synchronize()
    ops_counts = _read_counts()
    assert ops_counts == dict({k: 0 for k in ops_counts}, fast_maxvol=B, projection_sweep=B), \
        f"the ops chain launched {ops_counts}"
    chain_eq = all(torch.equal(piv, fused[0][b]) and torch.equal(err, fused[1][b])
                   and torch.equal(lv, fused[2][b]) for b, (piv, err, lv) in enumerate(chain))
    chain_eq = chain_eq and torch.equal(fused[0], multi.pivots)
    print(f"[engine] kernels/ops chain fast_maxvol -> gather -> projection_sweep on the "
          f"stack: {ops_counts['fast_maxvol']} + {ops_counts['projection_sweep']} launches; "
          f"pivots, logvol and errors {'bit-equal' if chain_eq else 'DIFFER'} to the batched "
          f"kernel's", flush=True)
    assert chain_eq, "the ops chain differs from the fused kernel"
    launches = {"graft_select_batched": path_counts["graft_select_batched"],
                "fast_maxvol": ops_counts["fast_maxvol"],
                "projection_sweep": ops_counts["projection_sweep"]}
    for name, n in launches.items():
        assert n > 0, f"kernel {name} was never launched on its path"
    ctx["kernels"]["fast_maxvol"]["launches"] = launches["fast_maxvol"]
    ctx["kernels"]["projection_sweep"]["launches"] = launches["projection_sweep"]
    want = gs.graft_select_batched_reference(Vs, Gs, gbs, r)
    piv_eq, gsel_eq, err_d, lv_d = _refresh_diff(fused, want)
    assert piv_eq and gsel_eq and err_d <= 1e-5, "batched kernel vs its plain version"
    t, bound = _engine_times(cfg, Vs, Gs, gbs, scores, step, "slice stack")
    ctx["kernels"]["graft_select_batched"] = _entry(
        "graft_select_batched", "src/repro/kernels/graft_select.py:175",
        launches["graft_select_batched"],
        max(err_d, lv_d), t["batched"], t["plain"], bound, t["batched_device"])
    # the selection benchmark's shape (benchmarks/bench_selection_overhead.py)
    bcfg = GraftConfig(rset=(8, 16, 32), eps=0.25, use_pallas=True)
    Vs, Gs, gbs = _random_refresh(256, 32, 1024, "cuda", B=8, seed=5)
    scores = torch.zeros(8, 256, device="cuda")
    _engine_compare(bcfg, Vs, Gs, gbs, scores, 0, "benchmark shape")
    _engine_times(bcfg, Vs, Gs, gbs, scores, 0, "benchmark shape")
    unfused = _time_auto(lambda: [ops.projection_sweep(
        Gs[b].index_select(1, ops.fast_maxvol(Vs[b], 32)), gbs[b]) for b in range(8)],
        max_iters=200)
    print(f"[engine] benchmark shape: the unfused ops chain (fast_maxvol, gather, "
          f"projection_sweep) for the 8 refreshes {unfused:.4f} ms", flush=True)


# the samplers phase's batches: the slice's stream past its 6 training steps
SAMPLER_STEP = 6
# the slice at 8 of 40 layers (phase depth8's cut), attention auto → flash
DEPTH8_OVERRIDES = [o for o in SLICE_OVERRIDES if not o.startswith("model.overrides")] + [
    'model.overrides={"attn_backend": "auto", "num_layers": 8}', "train.log_every=0"]


def _max_rel(got, want) -> float:
    """max|got − want| over max|want|, in float64 on the host."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    scale = want.abs().max().item()
    diff = (got - want).abs().max().item()
    return diff / scale if scale else diff


def _max_rel_up_to_sign(got, want) -> float:
    """``_max_rel`` after flipping each column of ``got`` to ``want``'s sign
    (eigenvector signs are the eigensolver's choice)."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    signs = (got * want).sum(0).sign()
    signs[signs == 0] = 1.0
    return _max_rel(got * signs, want)


def _craig_first_tie(G, pivots):
    """The first pick of CRAIG's greedy (after pick 0, whose gains are all
    +inf) at which the best two float64 gains tie to 1e-6, or None."""
    import numpy as np
    G = G.detach().double().cpu().numpy()
    n = np.linalg.norm(G, axis=0) + 1e-12
    S = (G.T @ G) / (n[:, None] * n[None, :])
    best = np.full(S.shape[0], -np.inf)
    for j, p in enumerate(pivots):
        gain = np.sum(np.maximum(S - best[:, None], 0.0), axis=0)
        gain[list(pivots[:j])] = -np.inf
        top = np.sort(gain[np.isfinite(gain)])[::-1]
        if j and len(top) > 1 and top[0] - top[1] <= 1e-6 * abs(top[0]):
            return j
        best = np.maximum(best, S[:, p])
    return None


def _pivots_agree(name, G, got, want):
    """Pivots equal; for CRAIG, equal up to its first exact tie of gains
    (two mutually nearest columns tie in exact arithmetic and float32
    rounding picks one, ROADMAP C), after which they may part. Returns a
    note for the log."""
    got, want = got.tolist(), want.tolist()
    if got == want:
        return "equal"
    tie = _craig_first_tie(G, want) if name == "craig" else None
    assert tie is not None and got[:tie] == want[:tie], \
        f"{name}: pivots {got} on the card, {want} on the CPU"
    return f"equal up to the exact tie of gains at pick {tie}"


def _selection_parts(mcfg, tcfg, model, batch):
    """What ``selection_inputs`` feeds the sources, for one batch: the
    pooled hiddens and the probe positions' logits, labels, hiddens, mask."""
    import torch
    from repro_torch.models import model as model_lib
    with torch.no_grad():
        h, mask = model_lib.forward_hiddens(mcfg, model, batch)
        stride = max(1, h.shape[1] // tcfg.probe_positions) if tcfg.probe_positions else 1
        hp, lp, mp = h[:, ::stride], batch["labels"][:, ::stride], mask[:, ::stride].float()
        logits = model_lib.logits_from_hiddens(mcfg, model, hp)
        pooled = torch.sum(h.float() * mask[..., None], dim=1) / \
            torch.clamp(torch.sum(mask, dim=1), min=1.0)[:, None]
    return pooled, logits, lp, hp, mp


def _state_agree(name, got, want, G):
    """One refresh's state on the card against the CPU's: pivots (CRAIG up
    to a tie), rank and step equal; weights bit-equal (GradMatch's rtol
    1e-4: a float32 solve); last_error and alignment within 1e-5 relative
    (+1e-6 absolute). Returns the log note."""
    import torch
    note = _pivots_agree(name, G, got.pivots, want.pivots)
    if note != "equal":
        return note
    assert int(got.rank) == int(want.rank) and int(got.step) == int(want.step), name
    gw, ww = got.weights.cpu(), want.weights
    if name in ("gradmatch", "streaming_graft"):
        assert torch.allclose(gw, ww, rtol=1e-4 if name == "gradmatch" else 1e-5, atol=1e-6), \
            f"{name}: weights {gw.tolist()} vs {ww.tolist()}"
    else:
        assert torch.equal(gw, ww), f"{name}: weights {gw.tolist()} vs {ww.tolist()}"
    for f in ("last_error", "alignment"):
        a, b = float(getattr(got, f)), float(getattr(want, f))
        assert abs(a - b) <= 1e-5 * abs(b) + 1e-6, f"{name}: {f} {a} vs {b}"
    return note


def phase_samplers(ctx):
    """The seven baselines, GRAFT, streaming over 4 refreshes, the five
    feature sources and two grad sources on the slice's trained params at
    full width, each against the CPU on the same inputs and timed; then the
    streaming and overlapped Trainer at 8 layers."""
    import numpy as np
    import torch
    from repro_torch.launch import steps as steps_lib
    from repro_torch.selection import engine, registry, sources, streaming
    tr = ctx["trainer"]
    mcfg, tcfg = tr.mcfg, tr.tcfg
    cfg, r, model = tcfg.graft, tcfg.graft.r_max, tr.state["model"]
    batches = [{k: torch.from_numpy(v).to("cuda") for k, v in tr.data.batch_at(
        SAMPLER_STEP + i).items()} for i in range(4)]
    pooled, logits, lp, hp, mp = _selection_parts(mcfg, tcfg, model, batches[0])
    print(f"[samplers] one {tuple(batches[0]['tokens'].shape)} batch of the trained minicpm-2b "
          f"(step {SAMPLER_STEP}): pooled hiddens {tuple(pooled.shape)}, probe logits "
          f"{tuple(logits.shape)}; rank {r}", flush=True)
    with torch.no_grad():
        for name in sources.available_features():
            fx = sources.resolve_features(name)
            V, V_cpu = fx(pooled, r), fx(pooled.cpu(), r)
            err = _max_rel_up_to_sign(V, V_cpu)
            ms = _time_auto(lambda: fx(pooled, r), max_iters=200)
            print(f"[samplers] features {name}: V {tuple(V.shape)}, max|V - V_cpu| (up to "
                  f"column sign) / max|V_cpu| {err:.3g} (limit 1e-4); {ms:.4f} ms", flush=True)
            assert V.shape == (pooled.shape[0], r) and bool(torch.isfinite(V).all())
            assert err <= 1e-4, f"features {name} differ from the CPU's"
        host_params = {k: v.detach().cpu() for k, v in model.tree().items() if k != "blocks"}
        for name in ("probe", "logit_embed"):
            src = sources.resolve_grad_source(name)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            G = src(sources.GradSourceInputs(logits, lp, hp, mcfg=mcfg, params=model.tree(),
                                             mask=mp))
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 1e9
            G_cpu = src(sources.GradSourceInputs(logits.cpu(), lp.cpu(), hp.cpu(), mcfg=mcfg,
                                                 params=host_params, mask=mp.cpu()))
            err = _max_rel(G, G_cpu)
            ms = _time_auto(lambda: src(sources.GradSourceInputs(
                logits, lp, hp, mcfg=mcfg, params=model.tree(), mask=mp)), max_iters=50)
            print(f"[samplers] grad source {name}: G {tuple(G.shape)}, max|G - G_cpu| / "
                  f"max|G_cpu| {err:.3g} (limit 1e-5); {ms:.4f} ms; peak memory above the "
                  f"inputs {peak:.3f} GB (the logits themselves {logits.numel() * 4 / 1e9:.3f} "
                  f"GB)", flush=True)
            assert bool(torch.isfinite(G).all()) and err <= 1e-5, f"grad source {name}"
        del logits, hp, G, G_cpu
        per = [steps_lib.selection_inputs(mcfg, tcfg, model, b) for b in batches]
        V, G, gb, scores = per[0]
        host = [x.cpu() for x in per[0]]
        for name in registry.available():
            if name == "streaming_graft":
                continue
            st, _ = engine.select_batch(cfg, name, V, G, gb, scores=scores, step=SAMPLER_STEP)
            want, _ = engine.select_batch(cfg, name, *host[:3], scores=host[3],
                                          step=SAMPLER_STEP)
            note = _state_agree(name, st, want, host[1])
            ms = _time_auto(lambda: engine.select_batch(cfg, name, V, G, gb, scores=scores,
                                                        step=SAMPLER_STEP), max_iters=200)
            print(f"[samplers] {name}: pivots {st.pivots.tolist()} ({note} to the CPU's), rank "
                  f"{int(st.rank)}, last_error {float(st.last_error):.6f}, alignment "
                  f"{float(st.alignment):.6f}; select_batch {ms:.4f} ms (d {G.shape[0]})",
                  flush=True)
        carry, carry_cpu, states = None, None, []
        _zero_counts()
        for i, (V, G, gb, sc) in enumerate(per):
            st, carry = engine.select_batch(cfg, "streaming_graft", V, G, gb, scores=sc,
                                            carry=carry, step=SAMPLER_STEP + i)
            states.append(st)
        torch.cuda.synchronize()
        launches = _read_counts()["graft_select"]
        for i, (st, x) in enumerate(zip(states, per)):
            want, carry_cpu = engine.select_batch(cfg, "streaming_graft",
                                                  *(t.cpu() for t in x[:3]), scores=x[3].cpu(),
                                                  carry=carry_cpu, step=SAMPLER_STEP + i)
            note = _state_agree("streaming_graft", st, want, x[1].cpu())
            print(f"[samplers] streaming_graft refresh {i + 1}: pivots {st.pivots.tolist()} "
                  f"({note}), rank {int(st.rank)}, weights {[round(w, 5) for w in st.weights.tolist()]}",
                  flush=True)
        sk, sk_cpu = carry.sketch.double().cpu(), carry_cpu.sketch.double()
        carry_err = {"sketch^T sketch": _max_rel(sk.T @ sk, sk_cpu.T @ sk_cpu),
                     "g_ema": _max_rel(carry.g_ema, carry_cpu.g_ema),
                     "agreement": abs(float(carry.agreement) - float(carry_cpu.agreement))}
        nbytes = sum(t.numel() * t.element_size() for t in carry)
        fd_ms = _time_auto(lambda: streaming.fd_update(cfg, carry.sketch, per[0][1]))
        refresh_ms = _time_auto(lambda: engine.select_batch(
            cfg, "streaming_graft", *per[0][:3], scores=per[0][3], carry=carry,
            step=SAMPLER_STEP + 4), max_iters=200)
        print(f"[samplers] streaming_graft: {launches} graft_select launches for 4 refreshes; "
              f"carry {nbytes} B (L {cfg.sketch_rows} x d {carry.g_ema.numel()}), count "
              f"{float(carry.count)}; vs the CPU {carry_err} (limit 1e-5 each); a refresh "
              f"{refresh_ms:.4f} ms, its fd_update {fd_ms:.4f} ms", flush=True)
        assert launches == 4, f"streaming launched graft_select {launches} times for 4 refreshes"
        assert float(carry.count) == float(carry_cpu.count) == 4.0
        assert all(v <= 1e-5 for v in carry_err.values()), carry_err
        assert all(bool(torch.isfinite(t).all()) for t in carry)
    _samplers_trainer_runs()


def _samplers_trainer_runs():
    """The streaming Trainer, and ``graft.overlap`` beside the sequential
    Trainer, at minicpm-2b's full width, 8 layers, 6 steps each."""
    import numpy as np
    import torch
    from repro_torch.api import Callback, ExperimentConfig, Trainer
    from repro_torch.selection import streaming

    class PivotRecorder(Callback):
        priority = 95

        def __init__(self):
            self.pivots = []

        def on_step_end(self, trainer, step, metrics):
            self.pivots.append(trainer.state["graft"].pivots.tolist())

    _zero_counts()
    trainer = Trainer(ExperimentConfig().apply_overrides(
        DEPTH8_OVERRIDES + ["train.sampler=streaming_graft"]))
    report = trainer.fit()
    counts = _read_counts()
    carry = trainer.state["sampler_carry"]
    hist = report["history"]
    print(f"[samplers] Trainer streaming_graft, 8 layers, 6 steps: losses "
          f"{[round(row['loss'], 5) for row in hist]}, ranks {[int(row['rank']) for row in hist]}; "
          f"graft_select launches {counts['graft_select']}; carry count {float(carry.count)}, "
          f"agreement {float(carry.agreement):.6f}; steady step "
          f"{np.mean([row['step_time_s'] for row in hist[1:]]) * 1e3:.1f} ms", flush=True)
    assert isinstance(carry, streaming.SketchCarry) and float(carry.count) == 3.0
    assert counts["graft_select"] == 3, counts
    assert all(bool(torch.isfinite(t).all()) for t in carry)
    assert all(np.isfinite(row["loss"]) and row["healthy"] == 1.0 for row in hist)
    del trainer, report, carry
    gc.collect()
    torch.cuda.empty_cache()
    runs = []
    for overlap in (False, True):
        rec = PivotRecorder()
        _zero_counts()
        report = Trainer(ExperimentConfig().apply_overrides(
            DEPTH8_OVERRIDES + [f"graft.overlap={str(overlap).lower()}"]),
            callbacks=[rec]).fit()
        counts = _read_counts()
        hist = report["history"]
        runs.append({"overlap": overlap, "losses": [row["loss"] for row in hist],
                     "ranks": [int(row["rank"]) for row in hist], "pivots": rec.pivots,
                     "flash": (counts["flash_forward"], counts["flash_dq"], counts["flash_dkv"]),
                     "steady_ms": float(np.mean([row["step_time_s"] for row in hist[1:]])) * 1e3,
                     "steps_ms": [round(row["step_time_s"] * 1e3, 1) for row in hist]})
        del report
        gc.collect()
        torch.cuda.empty_cache()
    first = runs[0]
    for run in runs:
        same = all(run[k] == first[k] for k in ("losses", "ranks", "pivots", "flash"))
        print(f"[samplers] Trainer overlap={run['overlap']}: step ms {run['steps_ms']}, steady "
              f"(steps 1-5) {run['steady_ms']:.1f} ms; flash launches {run['flash']}; losses, "
              f"ranks, pivots {'bit-equal to' if same else 'DIFFER from'} the first sequential "
              f"run's", flush=True)
        assert same, f"overlap={run['overlap']} differs from the sequential run"
    print(f"[samplers] steady step: sequential {runs[0]['steady_ms']:.1f} ms, graft.overlap "
          f"{runs[1]['steady_ms']:.1f} ms (the same step function, launch.steps.make_run_step)")


def phase_profile(ctx):
    _profile(ctx["trainer"], "profile")


# substrings of the port's own kernels' names, for their share of a profiled step
PORT_KERNEL_NAMES = ("rwkv_fwd", "rwkv_bwd", "flash_fwd", "flash_dq", "flash_dkv",
                     "fused_norm_kernel", "norm_finish_kernel", "fused_update_kernel",
                     "graft_select_kernel", "fast_maxvol_kernel", "projection_sweep_kernel")


def _profile(tr, tag):
    """Parts of a step timed apart on a trained state, then one whole step
    under torch.profiler: its kernels by device time."""
    import torch
    from repro_torch.launch import steps as steps_lib
    from repro_torch.optim import make_optimizer
    mcfg, tcfg, state = tr.mcfg, tr.tcfg, tr.state
    K, S = tr.config.train.batch, tr.config.train.seq
    batch = tr.backend.shard_batch(tr.data.batch_at(tcfg.graft.refresh_every * 10))
    refresh = steps_lib.make_selection_refresh(mcfg, tcfg)
    opt = make_optimizer(tcfg.optimizer)
    out = {}

    def timed(name, fn, reps=3):
        out[name] = cuda_time_ms(fn, iters=reps, warmup=1)
        return fn()

    graft_state, _ = timed(f"selection refresh (forward K={K}, features, kernel)",
                           lambda: refresh(state["model"].tree(), batch, {}, 0))
    grads = timed(f"subset forward+backward ({int(graft_state.rank)} x {S} tokens, "
                  f"remat={mcfg.remat})",
                  lambda: torch.autograd.grad(
                      steps_lib.subset_loss(mcfg, state, batch, graft_state),
                      state["params"]), reps=2)
    clipped, _ = timed("global-norm clip", lambda: opt.preprocess(grads))
    timed("AdamW update (in place)",
          lambda: opt.update(state["params"], clipped, state["opt"], 6), reps=1)
    del grads, clipped
    for name, ms in out.items():
        print(f"[{tag}] {name}: {ms:.1f} ms device")
    step_fn = steps_lib.make_train_step(mcfg, tcfg)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0)

    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    total_ms = sum(dev_us(e) for e in events) / 1e3
    if not events or total_ms <= 0:
        print(f"[{tag}] one step {wall_ms:.1f} ms wall; device time not measured "
              "(the profiler saw no CUDA kernels)")
        return
    print(f"[{tag}] one {'refresh' if state['step'] % tcfg.graft.refresh_every == 1 else 'subset'} "
          f"step under the profiler: {wall_ms:.1f} ms wall, {total_ms:.1f} ms of kernels "
          f"(device busy {100 * total_ms / wall_ms:.0f}% of the wall), "
          f"{sum(e.count for e in events)} kernel launches")
    for e in sorted(events, key=lambda e: -dev_us(e))[:12]:
        print(f"[{tag}]   {dev_us(e) / 1e3:8.2f} ms  x{e.count:<5d} {e.key[:110]}")
    own = [e for e in events if any(n in e.key for n in PORT_KERNEL_NAMES)]
    for e in sorted(own, key=lambda e: -dev_us(e)):
        print(f"[{tag}]   the port's kernel {dev_us(e) / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:80]}")


GEMM_KERNEL_NAMES = ("gemm", "nvjet", "cutlass")    # cuBLAS's Hopper GEMMs are nvjet_*
def _cuda_kernels(fn):
    """The CUDA kernels of one call of fn by torch.profiler (its
    key_averages events on the device) and the call's wall ms:
    ``launch_audit.cuda_kernel_events``."""
    from repro_torch.analysis import launch_audit
    return launch_audit.cuda_kernel_events(fn)


def _device_us(e):
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def _gemm_launches(fn):
    """(GEMM kernels, every kernel) of one call of fn, counted by
    torch.profiler: kernels whose names are cuBLAS's or CUTLASS's GEMMs."""
    cuda, _ = _cuda_kernels(fn)
    gemm = sum(e.count for e in cuda if any(n in e.key.lower() for n in GEMM_KERNEL_NAMES))
    return gemm, sum(e.count for e in cuda)


def _depth8_run(extra, tag):
    """One 6-step Trainer run of the slice at 8 layers: (losses, steady step
    ms, peak GB, launch counts, trainer)."""
    import numpy as np
    import torch
    from repro_torch.api import ExperimentConfig, Trainer
    cfg = ExperimentConfig().apply_overrides(
        [o for o in SLICE_OVERRIDES if not o.startswith("model.overrides")] + extra
        + ["train.log_every=0"])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    trainer = Trainer(cfg)
    report = trainer.fit()
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    hist = report["history"]
    assert all(np.isfinite(r["loss"]) for r in hist), f"{tag}: non-finite loss"
    times = [r["step_time_s"] * 1e3 for r in hist]
    steady = float(np.mean(times[1:]))
    print(f"[depth8] {tag}: step ms {[round(x, 1) for x in times]}; steady (steps 1-5) mean "
          f"{steady:.1f} ms; peak {peak:.2f} GB; losses {[r['loss'] for r in hist]}", flush=True)
    return [r["loss"] for r in hist], steady, peak, counts, trainer


def phase_depth8(ctx):
    """The slice at 8 layers, same seed, one call: dense vs flash attention
    (dense, flash, flash, dense), then remat full vs dots under flash (full,
    dots, dots, full) with a profiled refresh step's GEMM launches and the
    losses compared; then the baseline step (GRAFT off, batch 16) with
    train.microbatches 1 vs 4 (1, 4, 4, 1)."""
    import numpy as np
    import torch
    ctx.pop("trainer", None)           # the full-depth state: free its ~46 GB
    steady = {"dense": [], "auto": []}
    for backend in ("dense", "auto", "auto", "dense"):
        _, ms, _, counts, tr = _depth8_run(
            [f'model.overrides={{"attn_backend": "{backend}", "num_layers": 8}}'], f"attn {backend}")
        assert (counts["flash_forward"] > 0) == (backend == "auto"), f"{backend}: launches {counts}"
        steady[backend].append(ms)
        del tr
    print(f"[depth8] steady step mean over both runs: dense {np.mean(steady['dense']):.1f} ms, "
          f"flash {np.mean(steady['auto']):.1f} ms")

    remat = {"full": [], "dots": []}
    for mode in ("full", "dots", "dots", "full"):
        losses, ms, peak, counts, tr = _depth8_run(
            [f'model.overrides={{"num_layers": 8, "remat": "{mode}"}}'], f"remat {mode}")
        want = _expected_launches(tr.mcfg, tr.config, _optim_groups(tr.state["params"]))
        assert counts == want, f"remat {mode}: launches {counts}, expected {want}"
        if not remat[mode]:
            from repro_torch.launch import steps as steps_lib
            step_fn = steps_lib.make_train_step(tr.mcfg, tr.tcfg)
            batch = tr.backend.shard_batch(tr.data.batch_at(tr.tcfg.graft.refresh_every * 10))
            tr.state["step"] = 0                       # a refresh step
            gemm, total = _gemm_launches(lambda: step_fn(tr.state, batch))
            print(f"[depth8] remat {mode}: one refresh step launched {gemm} GEMM kernels "
                  f"of {total} kernels", flush=True)
        else:
            gemm = remat[mode][0][3]
        remat[mode].append((losses, ms, peak, gemm))
        del tr
    lf, ld = remat["full"][0][0], remat["dots"][0][0]
    diff = max(abs(a - b) for a, b in zip(lf, ld))
    print(f"[depth8] remat full vs dots: steady step mean full "
          f"{np.mean([r[1] for r in remat['full']]):.1f} ms, dots "
          f"{np.mean([r[1] for r in remat['dots']]):.1f} ms; peak full "
          f"{max(r[2] for r in remat['full']):.2f} GB, dots {max(r[2] for r in remat['dots']):.2f} GB; "
          f"GEMM launches in a refresh step full {remat['full'][0][3]}, dots "
          f"{remat['dots'][0][3]}; losses {'bit-equal' if lf == ld else f'differ by at most {diff:.3g}'}")
    assert remat["dots"][0][3] < remat["full"][0][3], "dots re-ran the forward GEMMs"
    # dots keeps the products that full recomputes from the same inputs by
    # the same kernels, so every loss is the same float
    assert lf == ld, f"remat dots losses differ from full's by up to {diff:.3g}"

    acc = {1: [], 4: []}
    for n in (1, 4, 4, 1):
        losses, ms, peak, counts, tr = _depth8_run(
            ['model.overrides={"num_layers": 8}', "graft=none", f"train.microbatches={n}"],
            f"baseline microbatches={n}")
        assert counts["flash_dq"] == 8 * 6 * n and counts["graft_select"] == 0, counts
        acc[n].append((losses, ms, peak))
        del tr
    l1, l4 = acc[1][0][0], acc[4][0][0]
    rel = max(abs(a - b) / abs(b) for a, b in zip(l4[1:], l1[1:]))
    print(f"[depth8] accumulation: step-0 loss microbatches=1 {l1[0]!r}, =4 {l4[0]!r} "
          f"(rel diff {abs(l4[0] - l1[0]) / abs(l1[0]):.3g}); later losses' largest relative "
          f"difference {rel:.3g}; steady step mean 1: {np.mean([r[1] for r in acc[1]]):.1f} ms, "
          f"4: {np.mean([r[1] for r in acc[4]]):.1f} ms; peak 1: "
          f"{max(r[2] for r in acc[1]):.2f} GB, 4: {max(r[2] for r in acc[4]):.2f} GB")
    # step 0 takes the same params: the four microbatch means' mean is the
    # whole batch's up to float32 rounding (a quarter batch alone is ~1e-3
    # off). Later steps train on gradients summed in bf16, one rounding per
    # microbatch, so their losses drift apart by far less than 1e-3
    assert abs(l4[0] - l1[0]) <= 1e-5 * abs(l1[0]), \
        f"step-0 loss of 4 microbatches differs by {abs(l4[0] - l1[0]) / abs(l1[0]):.3g}"
    assert rel <= 1e-3, f"later losses of 4 microbatches differ by up to {rel:.3g} relative"


# (name, BH, T, D, w_low): the JAX kernel test's shapes, rwkv6-7b's
# selection forward (16 sequences × 64 heads), its subset forward and
# backward at rank 8 (8 × 64) and at rank 2 (2 × 64, the rank phase
# rwkv_slice picks), the rank-2 shape again with w in [0, 0.59) (decays down
# to 0), a long context, a T that is not a multiple of the time tile, and a
# D the model never uses; w uniform in [w_low, w_low + 0.59)
RWKV_SHAPES = [
    ("jax_1x32x16", 1, 32, 16, 0.4), ("jax_4x64x32", 4, 64, 32, 0.4),
    ("jax_2x128x64", 2, 128, 64, 0.4), ("jax_3x96x48", 3, 96, 48, 0.4),
    ("selection", 1024, 256, 64, 0.4), ("subset", 512, 256, 64, 0.4),
    ("subset_r2", 128, 256, 64, 0.4), ("subset_w0", 128, 256, 64, 0.0),
    ("long_context", 64, 4096, 64, 0.4), ("ragged_T", 64, 250, 64, 0.4),
    ("D256", 16, 256, 256, 0.4),
]
RWKV_REPLACES = {
    "rwkv_scan": "src/repro/kernels/rwkv_scan.py:49",
    "rwkv_scan_backward": "src/repro/kernels/rwkv_scan.py:49 (its gradient: the JAX "
                          "package differentiates lax.scan, src/repro/models/ssm.py:86)"}


def _rwkv_inputs(BH, T, D, seed=0, w_low=0.4):
    """The JAX kernel test's distributions, drawn on the card: w uniform in
    [w_low, w_low + 0.59)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale
    w = w_low + 0.59 * torch.rand((BH, T, D), generator=g, device="cuda")
    return (rnd(BH, T, D, scale=0.3), rnd(BH, T, D, scale=0.3), rnd(BH, T, D, scale=0.3),
            w, rnd(BH, D, scale=0.1), rnd(BH, T, D))


def _rwkv_bound(kind, BH, T, D):
    """Least time on an H100 for the function, not for this design
    (``kernels/rwkv_scan.py`` ``cost``: each input read and each output
    written once, float32 operations per state element per step)."""
    from repro_torch.kernels import rwkv_scan as rs
    return _cost_bound(rs.cost(kind, BH, T, D))


def _rwkv_case(name, BH, T, D, w_low, tag="rwkv"):
    """One shape: the forward (with and without its tile states) and the
    backward against their plain versions, reruns bit-equal,
    ``ops.rwkv_scan`` chunk-invariant, then each timed beside its plain
    version and its bound → (max|diff| by output, kernel ms, plain ms,
    bounds) by kind."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv_scan as rw
    r, k, v, w, u, do = _rwkv_inputs(BH, T, D, w_low=w_low)
    o, states = rw.rwkv_scan_forward(r, k, v, w, u, save_states=True)
    grads = rw.rwkv_scan_backward(r, k, v, w, u, do, states)
    o_ng, none = rw.rwkv_scan_forward(r, k, v, w, u)
    o2, states2 = rw.rwkv_scan_forward(r, k, v, w, u, save_states=True)
    grads2 = rw.rwkv_scan_backward(r, k, v, w, u, do, states2)
    torch.cuda.synchronize()
    same = none is None and torch.equal(o, o_ng) and torch.equal(o, o2) and \
        torch.equal(states, states2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))
    want = rw.rwkv_scan_reference(r, k, v, w, u)
    want_g = rw.rwkv_scan_backward_reference(r, k, v, w, u, do)
    torch.cuda.synchronize()
    # tolerance: float32 sums in another order — over D for the output
    # (1e-5 of its largest value), over D and T for the gradients (1e-4)
    errs, ok = {}, same
    for what, a, b in zip(("o", "dr", "dk", "dv", "dw", "du"), (o,) + grads,
                          (want,) + want_g):
        errs[what] = (a - b).abs().max().item()
        scale = b.abs().max().item()
        ok = ok and errs[what] <= (1e-5 if what == "o" else 1e-4) * scale + 1e-6
    chunks = ""
    if T % 64 == 0:
        outs = [ops.rwkv_scan(r, k, v, w, u, chunk=c) for c in (16, 32, 64)]
        inv = all(torch.equal(x, o) for x in outs)
        ok = ok and inv
        chunks = f", ops.rwkv_scan chunk 16/32/64 {'bit-equal' if inv else 'DIFFER'}"
    print(f"[{tag}] {name}: BH={BH} T={T} D={D}: max|diff| "
          + ", ".join(f"{k_} {e:.3g}" for k_, e in errs.items())
          + f"; reruns and the no-grad forward {'bit-equal' if same else 'DIFFER'}"
          f"{chunks} -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"rwkv kernels disagree with their plain versions on {name}")
    del want, want_g, o2, states2, grads2, o_ng
    t = {"fwd": _time_auto(lambda: rw.rwkv_scan_forward(r, k, v, w, u)),
         "fwd_states": _time_auto(lambda: rw.rwkv_scan_forward(r, k, v, w, u,
                                                               save_states=True)),
         "bwd": _time_auto(lambda: rw.rwkv_scan_backward(r, k, v, w, u, do, states))}
    plain = {"fwd": _time_auto(lambda: rw.rwkv_scan_reference(r, k, v, w, u), max_iters=5),
             "bwd": _time_auto(lambda: rw.rwkv_scan_backward_reference(
                 r, k, v, w, u, do), max_iters=5)}
    plain["fwd_states"] = plain["fwd"]
    bounds = {"fwd": _rwkv_bound("fwd", BH, T, D),
              "fwd_states": _rwkv_bound("fwd", BH, T, D),
              "bwd": _rwkv_bound("bwd", BH, T, D)}
    for kind in t:
        b_ms, b_by, nbytes, flops = bounds[kind]
        print(f"[{tag}] {name} {kind}: kernel {t[kind]:.4f} ms, plain {plain[kind]:.4f} ms, "
              f"library none, bound {b_ms:.4f} ms by {b_by} ({nbytes} bytes, {flops} flop); "
              f"{t[kind] / b_ms:.1f}x the bound", flush=True)
    del r, k, v, w, u, do, o, states, grads
    torch.cuda.empty_cache()
    return errs, t, plain, bounds


def phase_rwkv(ctx):
    for name, BH, T, D, w_low in RWKV_SHAPES:
        errs, t, plain, bounds = _rwkv_case(name, BH, T, D, w_low)
        # the kernels line: the forward at the selection forward's shape, the
        # backward at the subset's at rank 2 (where each runs on the path)
        for key, shape, kind, err in (("rwkv_scan", "selection", "fwd", errs["o"]),
                                      ("rwkv_scan_backward", "subset_r2", "bwd",
                                       max(errs[x] for x in ("dr", "dk", "dv", "dw", "du")))):
            if name == shape:
                ctx["kernels"][key] = {
                    "name": key, "route": "cuda", "source": "src/repro_torch/csrc/rwkv_scan.cu",
                    "replaces": RWKV_REPLACES[key], "launches": None, "max_abs_err": err,
                    "ms": t[kind], "plain_ms": plain[kind], "bound_ms": bounds[kind][0],
                    "bound_by": bounds[kind][1], "library_ms": None}


RWKV_LAYERS = 16


def _rwkv_slice_overrides():
    """The slice's GRAFT settings on rwkv6-7b at full width, RWKV_LAYERS deep."""
    return ([o for o in SLICE_OVERRIDES if not o.startswith("model.overrides")]
            + ["model.arch=rwkv6-7b", f'model.overrides={{"num_layers": {RWKV_LAYERS}}}'])


def phase_rwkv_slice(ctx):
    """rwkv6-7b at full width, depth cut to RWKV_LAYERS, through Trainer."""
    import numpy as np
    import torch
    from repro_torch.api import ExperimentConfig, Trainer
    from repro_torch.models import ssm
    ctx.pop("trainer", None)           # minicpm's state: the two do not fit together
    gc.collect()
    torch.cuda.empty_cache()
    cfg = ExperimentConfig().apply_overrides(_rwkv_slice_overrides())
    mcfg = cfg.model.build()
    per_layer = 2 * mcfg.d_model + sum(      # ln1, ln2, time mix, channel mix
        int(np.prod(s)) for shapes in (ssm.rwkv_time_shapes(mcfg, mcfg.dtype),
                                       ssm.rwkv_channel_shapes(mcfg, mcfg.dtype))
        for s, _ in shapes.values())
    head = mcfg.vocab_size * mcfg.d_model * (1 if mcfg.tie_embeddings else 2)
    n_params = head + mcfg.d_model + mcfg.num_layers * per_layer
    full = head + mcfg.d_model + 32 * per_layer
    print(f"[rwkv_slice] rwkv6-7b full width: d_model {mcfg.d_model}, {mcfg.num_heads} heads x "
          f"{mcfg.d_model // mcfg.num_heads}, d_ff {mcfg.d_ff}, vocab {mcfg.vocab_size}, "
          f"untied head, lora rank {ssm.lora_rank(mcfg)}, {mcfg.param_dtype} params, "
          f"remat={mcfg.remat}; depth cut to {mcfg.num_layers} of 32 layers: "
          f"{n_params / 1e9:.3f} B params (32 layers: {full / 1e9:.3f} B) -> bf16 params + "
          f"grads + f32 AdamW moments ~{n_params * 12 / 1e9:.1f} GB (32 layers: "
          f"~{full * 12 / 1e9:.1f} GB)", flush=True)
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg)
    _zero_counts()
    t0 = time.perf_counter()
    report = trainer.fit()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ctx.setdefault("peaks", {})["rwkv_slice"] = torch.cuda.max_memory_allocated()
    hist = report["history"]
    for i, row in enumerate(hist):
        print(f"[rwkv_slice] step {i}: loss {row['loss']:.6f} rank {row['rank']} "
              f"proj_error {row['proj_error']:.4f} grad_norm {row['grad_norm']:.4f} "
              f"step {row['step_time_s'] * 1e3:.1f} ms")
    expected = _expected_launches(mcfg, cfg, _optim_groups(trainer.state["params"]))
    print(f"[rwkv_slice] fit wall {wall:.2f} s, {report['num_params']} params, peak memory "
          f"allocated {peak_gb:.2f} GB, kernel launches {launches}", flush=True)
    print(f"[rwkv_slice] expected launches {expected}")
    assert report["num_params"] == n_params, (report["num_params"], n_params)
    assert all(np.isfinite(r["loss"]) and r["healthy"] == 1.0 for r in hist), \
        "non-finite loss or a vetoed step"
    assert all(int(r["rank"]) in cfg.graft.rset for r in hist), "rank outside rset"
    assert launches == expected, f"launches {launches}, expected {expected}"
    for name in ("rwkv_scan", "rwkv_scan_backward"):
        assert launches[name] > 0, f"kernel {name} was never launched on the main path"
        ctx["kernels"][name]["launches"] = launches[name]
    steady = [r["step_time_s"] for r in hist[1:]]
    print(f"[rwkv_slice] steady step time (steps 1-5) mean {np.mean(steady) * 1e3:.1f} ms; "
          f"refresh steps {[round(r['step_time_s'] * 1e3, 1) for r in hist[2::2]]} ms")
    _profile(trainer, "rwkv_slice")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()


# (arch, depth or None for full depth, extra overrides): the slice's GRAFT
# settings at full width
FAMILY_RUNS = [
    ("qwen3-moe-235b-a22b", 2, ["optimizer.state_dtype=bfloat16"]),
    ("hymba-1.5b", None, []),
    ("qwen1.5-32b", 4, []),
]


def _ssm_share(tr, batch):
    """The SSM heads' part of one refresh step on the trained hymba state:
    the same calls the step makes (the selection forward over the batch, and
    for the subset its forward, the remat recompute and the backward), run
    alone through ``ssm_heads`` on one layer's weights at the step's shapes
    and profiled: (launches, device ms) for all layers."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import ssm
    mcfg, state = tr.mcfg, tr.state
    p = state["model"].blocks[1].tree()["ssm"]
    K, S = batch["tokens"].shape
    rank = int(state["graft"].rank)
    g = torch.Generator(device="cuda").manual_seed(0)
    h_sel = torch.randn((K, S, mcfg.d_model), generator=g, device="cuda").to(mcfg.dtype)
    h_sub = h_sel[:rank].clone().requires_grad_()

    def one_layer():
        with torch.no_grad():
            ssm.ssm_heads(mcfg, p, h_sel)
        with torch.no_grad():                              # the remat forward
            ssm.ssm_heads(mcfg, p, h_sub)
        out, _ = ssm.ssm_heads(mcfg, p, h_sub)              # the recompute + backward
        torch.autograd.grad(out, [h_sub] + list(p.values()), torch.ones_like(out))

    one_layer()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        one_layer()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    dev_us = sum(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
                 for e in events)
    wall = cuda_time_ms(one_layer, iters=2, warmup=0)
    L = mcfg.num_layers
    return L * sum(e.count for e in events), L * dev_us / 1e3, L * wall


def phase_families(ctx):
    """The moe, hybrid and QKV-bias dense families through Trainer at full
    width, 6 steps each at the slice's GRAFT settings from seed 0: exact
    launch counts (flash forward 3·L + 6·2·L, dQ and dK/dV 6·L, graft_select
    3, one grad_norm a step, one optimizer_update a dtype group a step),
    finite losses, ranks in rset, steady step time and peak memory; the
    hybrid's SSM loop's share of a refresh step."""
    import numpy as np
    import torch
    from repro_torch.api import ExperimentConfig, Trainer
    ctx.pop("trainer", None)
    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    for arch, layers, extra in FAMILY_RUNS:
        gc.collect()
        torch.cuda.empty_cache()
        ov = {"attn_backend": "auto"} | ({"num_layers": layers} if layers else {})
        cfg = ExperimentConfig().apply_overrides(
            [o for o in SLICE_OVERRIDES if not o.startswith("model.overrides")]
            + [f"model.arch={arch}", f"model.overrides={json.dumps(ov)}"] + extra)
        mcfg = cfg.model.build()
        sdt = cfg.optimizer.state_dtype
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer(cfg)
        _zero_counts()
        t0 = time.perf_counter()
        report = tr.fit()
        wall = time.perf_counter() - t0
        launches = _read_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        n = report["num_params"]
        state_gb = n * (2 + 2 + 2 * (2 if sdt == "bfloat16" else 4)) / 1e9
        hist = report["history"]
        print(f"[families] {arch}: {mcfg.family}, d_model {mcfg.d_model}, {mcfg.num_heads} heads "
              f"over {mcfg.num_kv_heads} KV x {mcfg.head_dim}, d_ff {mcfg.d_ff}, vocab "
              f"{mcfg.vocab_size}, experts {mcfg.num_experts} top-{mcfg.num_experts_per_tok}, "
              f"ssm_state {mcfg.ssm_state}, window {mcfg.sliding_window}, qkv_bias "
              f"{mcfg.qkv_bias}; {mcfg.num_layers} layers "
              f"({'full depth' if layers is None else 'depth cut'}), {n} params, {sdt} moments "
              f"-> bf16 params + grads + moments ~{state_gb:.1f} GB of {total_gb:.1f} GB; "
              f"peak allocated {peak:.2f} GB; fit wall {wall:.1f} s", flush=True)
        for i, r in enumerate(hist):
            print(f"[families] {arch} step {i}: loss {r['loss']:.6f} rank {r['rank']} "
                  f"grad_norm {r['grad_norm']:.4f} step {r['step_time_s'] * 1e3:.1f} ms")
        expected = _expected_launches(mcfg, cfg, _optim_groups(tr.state["params"]))
        print(f"[families] {arch}: launches {launches}, expected {expected}")
        assert all(np.isfinite(r["loss"]) and r["healthy"] == 1.0 for r in hist), \
            f"{arch}: non-finite loss or a vetoed step"
        assert all(int(r["rank"]) in cfg.graft.rset for r in hist), f"{arch}: rank outside rset"
        assert launches == expected, f"{arch}: launches {launches}, expected {expected}"
        steady = [r["step_time_s"] * 1e3 for r in hist[1:]]
        print(f"[families] {arch}: steady step time (steps 1-5) mean {np.mean(steady):.1f} ms; "
              f"refresh steps {[round(r['step_time_s'] * 1e3, 1) for r in hist[2::2]]} ms")
        if mcfg.family == "hybrid":
            batch = tr.backend.shard_batch(tr.data.batch_at(tr.tcfg.graft.refresh_every * 10))
            _profile(tr, f"families {arch}")
            n_l, dev_ms, ev_ms = _ssm_share(tr, batch)
            print(f"[families] {arch}: the SSM loop's calls of one refresh step run alone "
                  f"(rank {int(tr.state['graft'].rank)}): {n_l} kernel launches, {dev_ms:.1f} ms "
                  f"of kernels, {ev_ms:.1f} ms by CUDA events; the steady step is "
                  f"{np.mean(steady):.1f} ms", flush=True)
        del tr, report
    gc.collect()
    torch.cuda.empty_cache()


# (tag, arch, depth or None for full depth, extra overrides): the
# classification task at full width with the slice's GRAFT settings
CLASSIFY_RUNS = [
    ("a", "musicgen-medium", None, ["data.source=synthetic_classification",
                                    "data.imbalance=1.0", "data.label_noise=0.1",
                                    "data.num_classes=10"]),
    ("b", "musicgen-medium", None, ["data.source=synthetic_classification",
                                    "data.imbalance=1.0", "data.label_noise=0.1",
                                    "data.num_classes=10", "data.frames=64",
                                    "data.feature_dim=3072"]),
    ("c", "internvl2-26b", 8, ["data.source=synthetic_vision", "data.image_size=32"]),
]


def _seq_len(mcfg, batch):
    """The model's sequence length for a batch of its frontend."""
    if "patch_embeds" in batch:
        return batch["patch_embeds"].shape[1] + batch["tokens"].shape[1]
    if "frame_embeds" in batch:
        return batch["frame_embeds"].shape[1]
    return batch["tokens"].shape[1]


def phase_classify(ctx):
    """The classification task through Trainer at full width: musicgen-medium
    (audio frames) at full depth on synthetic_classification at 4 frames
    (attention resolves to dense) and at 64 frames of CIFAR's 3072 features
    (flash), internvl2-26b (vision patches) at 8 of 48 layers on
    synthetic_vision at 32 × 32 (64 patches and the query token, dense): 6
    steps at the slice's GRAFT settings, batch 16, eval every 2 steps; exact
    launch counts, finite losses, ranks in rset, eval_acc in [0, 1], steady
    step time and peak memory."""
    import numpy as np
    import torch
    from repro_torch.api import ExperimentConfig, Trainer
    from repro_torch.models.layers import resolve_attn_backend
    ctx.pop("trainer", None)
    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    for tag, arch, layers, extra in CLASSIFY_RUNS:
        gc.collect()
        torch.cuda.empty_cache()
        ov = {"attn_backend": "auto"} | ({"num_layers": layers} if layers else {})
        cfg = ExperimentConfig().apply_overrides(
            [o for o in SLICE_OVERRIDES if not o.startswith("model.overrides")]
            + [extra[0], f"model.arch={arch}", f"model.overrides={json.dumps(ov)}"]
            + extra[1:] + ["train.eval_every=2"])
        mcfg, _, data = cfg.build()
        S = _seq_len(mcfg, data.batch_at(0))
        backend = resolve_attn_backend(mcfg, S, S, torch.device("cuda"))
        want_backend = "flash" if tag == "b" else "dense"
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer(cfg)
        _zero_counts()
        t0 = time.perf_counter()
        report = tr.fit()
        wall = time.perf_counter() - t0
        launches = _read_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        n = report["num_params"]
        hist = report["history"]
        print(f"[classify] ({tag}) {arch}: {mcfg.family}, frontend {mcfg.frontend}, d_model "
              f"{mcfg.d_model}, {mcfg.num_heads} heads over {mcfg.num_kv_heads} KV x "
              f"{mcfg.head_dim}, d_ff {mcfg.d_ff} {mcfg.mlp_activation}, {mcfg.num_layers} "
              f"layers ({'full depth' if layers is None else 'depth cut'}), vocab "
              f"{mcfg.vocab_size} (the classes); {cfg.data.__class__.__name__} "
              f"{json.dumps(dataclasses.asdict(cfg.data))}; S {S}, attention resolves to "
              f"{backend}; {n} params -> bf16 params + grads + f32 moments "
              f"~{n * 12 / 1e9:.1f} GB of {total_gb:.1f} GB; peak allocated {peak:.2f} GB; "
              f"fit wall {wall:.1f} s", flush=True)
        for i, r in enumerate(hist):
            ev = (f" eval_loss {r['eval_loss']:.5f} eval_acc {r['eval_acc']:.4f}"
                  if "eval_acc" in r else "")
            print(f"[classify] ({tag}) step {i}: loss {r['loss']:.6f} rank {r['rank']} "
                  f"grad_norm {r['grad_norm']:.4f} step {r['step_time_s'] * 1e3:.1f} ms{ev}")
        expected = _expected_launches(mcfg, cfg, _optim_groups(tr.state["params"]),
                                      flash=backend == "flash")
        print(f"[classify] ({tag}) {arch}: launches {launches}, expected {expected}")
        assert backend == want_backend, f"({tag}) attention resolved to {backend}"
        assert all(np.isfinite(r["loss"]) and r["healthy"] == 1.0 for r in hist), \
            f"({tag}) non-finite loss or a vetoed step"
        assert all(int(r["rank"]) in cfg.graft.rset for r in hist), f"({tag}) rank outside rset"
        evals = [r for r in hist if "eval_acc" in r]
        assert len(evals) == 3 and all(0.0 <= r["eval_acc"] <= 1.0 and np.isfinite(r["eval_loss"])
                                       for r in evals), f"({tag}) eval rows {evals}"
        assert launches == expected, f"({tag}) launches {launches}, expected {expected}"
        for name in ("graft_select", "grad_norm", "optimizer_update"):
            assert launches[name] > 0, f"({tag}) kernel {name} was never launched"
        steady = [r["step_time_s"] * 1e3 for r in hist[1:]]
        print(f"[classify] ({tag}) {arch}: steady step time (steps 1-5) mean "
              f"{np.mean(steady):.1f} ms; refresh steps "
              f"{[round(r['step_time_s'] * 1e3, 1) for r in hist[2::2]]} ms; eval_acc "
              f"{[round(r['eval_acc'], 4) for r in evals]}", flush=True)
        del tr, report
    gc.collect()
    torch.cuda.empty_cache()


# (arch, depth or None for full depth): serve at the JAX defaults, full width
SERVE_MODELS = [("minicpm-2b", None), ("rwkv6-7b", None), ("hymba-1.5b", None),
                ("qwen3-moe-235b-a22b", 2)]
SERVE_ARGS = dict(slots=4, requests=8, max_new_tokens=16, max_seq=128, seed=0)


def phase_serve(ctx):
    """``serve`` at the JAX defaults (4 slots, 8 requests of 8 tokens, 16 new
    tokens, max_seq 128, seed 0) at full width for minicpm-2b, rwkv6-7b and
    hymba-1.5b at full depth and qwen3-moe at 2 of 94 layers (the one-token
    steps dropless over 128 experts), bf16 weights from seed 0: every request
    done, a second run's tokens equal, no kernel of the port launched, the
    warmed second run's tokens/s,
    the prefill and one decode tick by CUDA events, peak memory. Then
    minicpm-2b at 8 layers: prefill 8 tokens and 16 decode steps against
    the teacher-forced forward on the card."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models import decode as decode_lib
    from repro_torch.models import model as model_lib
    ctx.pop("trainer", None)
    for arch, layers in SERVE_MODELS:
        gc.collect()
        torch.cuda.empty_cache()
        mcfg = configs.get_config(arch, **({"num_layers": layers} if layers else {}))
        model = model_lib.init_params(mcfg, torch.Generator(device="cuda").manual_seed(0),
                                      "cuda")
        n = sum(p.numel() for p in model.parameters())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        reports = [serve_lib.serve_model(mcfg, model, **SERVE_ARGS) for _ in range(2)]
        counts = _read_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        params = model.tree()
        rng = np.random.default_rng(0)
        toks = torch.from_numpy(rng.integers(2, mcfg.vocab_size, (SERVE_ARGS["slots"], 8))
                                .astype(np.int32)).cuda()
        batch = {"tokens": toks, "labels": toks}
        prefill_ms = cuda_time_ms(lambda: decode_lib.prefill(mcfg, params, batch, 128),
                                  iters=3, warmup=1)
        live = {"cache": decode_lib.prefill(mcfg, params, batch, 128)[1]}

        def tick():                 # a decode step consumes its cache: thread it
            _, live["cache"] = decode_lib.decode_step(mcfg, params, live["cache"], toks[:, :1])

        # 2 + 10 + 1 ticks from index 8 stay inside max_seq 128
        tick_ms = cuda_time_ms(tick, iters=10, warmup=2)
        events, tick_wall = _cuda_kernels(tick)
        tick_dev = sum(_device_us(e) for e in events) / 1e3
        r = reports[1]              # the second, warmed run
        print(f"[serve] {arch}: {mcfg.family}, {mcfg.num_layers} layers "
              f"({'full depth' if layers is None else 'depth cut'}), d_model {mcfg.d_model}, "
              f"{n} bf16 params ({n * 2 / 1e9:.2f} GB); requests {r['requests']}, decode ticks "
              f"{r['decode_ticks']}, new tokens {r['total_new_tokens']}, wall {r['wall_s']} s, "
              f"{r['tokens_per_s']} tokens/s (warmed run; the first, with its warm-up, "
              f"{reports[0]['tokens_per_s']}); "
              f"prefill ({SERVE_ARGS['slots']} x 8 tokens) {prefill_ms:.2f} ms, one decode tick "
              f"{tick_ms:.2f} ms (CUDA events); one profiled tick: {tick_wall:.2f} ms wall "
              f"under the profiler, {tick_dev:.2f} ms of kernels (device busy "
              f"{100 * tick_dev / tick_ms:.0f}% of the CUDA-event tick), "
              f"{sum(e.count for e in events)} kernel launches; peak allocated {peak:.2f} GB; "
              f"the port's kernel launches {counts}", flush=True)
        assert r["requests"] == SERVE_ARGS["requests"]
        assert sorted(x["request_id"] for x in r["results"]) == list(range(SERVE_ARGS["requests"]))
        assert all(1 <= len(x["tokens"]) <= SERVE_ARGS["max_new_tokens"] for x in r["results"])
        assert [x["tokens"] for x in reports[0]["results"]] == \
            [x["tokens"] for x in r["results"]], f"{arch}: reruns disagree"
        assert not any(counts.values()), f"{arch}: serve launched a kernel: {counts}"
        del model, params, live, tick, reports
    gc.collect()
    torch.cuda.empty_cache()
    mcfg = configs.get_config("minicpm-2b", num_layers=8)
    model = model_lib.init_params(mcfg, torch.Generator(device="cuda").manual_seed(1), "cuda")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, mcfg.vocab_size, (4, 24))
                            .astype(np.int32)).cuda()
    with torch.no_grad():
        h, _ = model_lib.forward_hiddens(mcfg, model, {"tokens": toks, "labels": toks})
        ref = model_lib.logits_from_hiddens(mcfg, model, h)[:, 7:].float()
    lg, cache = decode_lib.prefill(mcfg, model, {"tokens": toks[:, :8], "labels": toks[:, :8]}, 24)
    outs = [lg[:, 0]]
    for t in range(8, 24):
        lg, cache = decode_lib.decode_step(mcfg, model, cache, toks[:, t:t + 1])
        outs.append(lg[:, 0])
    dec = torch.stack(outs, dim=1).float()
    err, scale = float((dec - ref).abs().max()), float(ref.abs().max())
    bound = 0.02 * max(scale, 1.0) + 1e-3
    print(f"[serve] minicpm-2b full width, 8 layers: prefill 8 + 16 decode steps against the "
          f"teacher-forced forward (flash): max|diff| {err:.4g}, max|logit| {scale:.4g}, bound "
          f"{bound:.4g} -> {'ok' if err < bound else 'FAIL'}", flush=True)
    assert err < bound, "decode disagrees with teacher forcing"
    del model, cache
    gc.collect()
    torch.cuda.empty_cache()


# the minicpm smoke runs phase check adds: every sampler besides graft, and
# the feature and grad sources whose arithmetic is new in the port
CHECK_SELECTION = ["train.sampler=" + s for s in (
    "random", "loss_topk", "full", "el2n", "gradmatch", "craig", "glister",
    "streaming_graft")] + ["graft.feature_mode=sketch_svd", "graft.feature_mode=ica",
                           "graft.grad_mode=logit_embed", "graft.grad_mode=full"]


def _check_refresh_launches(mcfg, tcfg, state, batch, extra):
    """One selection refresh alone, counted: its forward runs the flash
    kernel once per layer, and under ``grad_mode=full`` each example's
    backward runs flash dQ and dK/dV once per layer (the training step's
    own launches are not in these counts)."""
    import torch
    from repro_torch.launch import steps as steps_lib
    refresh = steps_lib.make_selection_refresh(mcfg, tcfg)
    _zero_counts()
    refresh(state["model"].tree(), batch, state.get("sampler_carry", {}), 0)
    torch.cuda.synchronize()
    counts = _read_counts()
    L, K = mcfg.num_layers, batch["tokens"].shape[0]
    full = extra == "graft.grad_mode=full"
    want_bwd = K * L if full else 0
    print(f"[check] {extra}: one refresh alone launched flash forward "
          f"{counts['flash_forward']}, dq {counts['flash_dq']}, dkv {counts['flash_dkv']}")
    assert (counts["flash_forward"] >= L * (K + 1)) if full else \
        (counts["flash_forward"] == L), f"{extra}: refresh launches {counts}"
    assert counts["flash_dq"] == counts["flash_dkv"] == want_bwd, \
        f"{extra}: refresh launches {counts}, want {want_bwd} backward launches"


def phase_check(ctx):
    import torch
    from repro_torch.api import ExperimentConfig
    from repro_torch.launch import steps as steps_lib
    base = ['model.overrides={"param_dtype": "float32", "attn_backend": "flash"}',
            "train.steps=4", "train.batch=8", "graft.rset=[2,4]",
            "graft.refresh_every=2", "graft.use_pallas=true"]
    cases = [(arch, seq, None) for arch, seq in (
        ("minicpm-2b", 16), ("gemma2-27b", 32), ("rwkv6-7b", 16), ("qwen1.5-32b", 16),
        ("qwen3-moe-235b-a22b", 16), ("kimi-k2-1t-a32b", 16), ("hymba-1.5b", 32))]
    cases += [("minicpm-2b", 16, extra) for extra in CHECK_SELECTION]
    for arch, seq, extra in cases:
        cfg = ExperimentConfig().apply_overrides(
            [f"model.arch={arch}", f"train.seq={seq}"] + base + ([extra] if extra else []))
        runs = {}
        for dev in ("cuda", "cpu"):
            mcfg, tcfg, data = cfg.build()
            gen = torch.Generator(device="cpu").manual_seed(0)
            model_cpu = steps_lib.init_train_state(mcfg, tcfg, gen, 8)["model"]
            state = steps_lib.state_for_model(mcfg, tcfg, model_cpu.to(dev), 8)
            step_fn = steps_lib.make_train_step(mcfg, tcfg)
            rows = []
            _zero_counts()
            for s in range(cfg.train.steps):
                batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(s).items()}
                state, m = step_fn(state, batch)
                rows.append((m["loss"].item(), int(m["rank"]),
                             state["graft"].pivots.cpu().tolist()))
            counts = _read_counts()
            kernel = "rwkv_scan" if mcfg.family == "ssm" else "flash_forward"
            assert (counts[kernel] > 0) == (dev == "cuda"), f"{dev}: {counts}"
            steps = cfg.train.steps if dev == "cuda" else 0
            optim = {"grad_norm": steps,
                     "optimizer_update": steps * _optim_groups(state["params"])}
            assert {k: counts[k] for k in optim} == optim, f"{dev}: {counts}, want {optim}"
            if extra and dev == "cuda":
                _check_refresh_launches(mcfg, tcfg, state, batch, extra)
            runs[dev] = rows
        if extra:
            print(f"[check] {arch} seq {seq} under flash with {extra}")
        elif mcfg.family == "ssm":
            print(f"[check] {arch} seq {seq} through the RWKV kernels ({mcfg.num_heads} heads "
                  f"x {mcfg.d_model // mcfg.num_heads})")
        else:
            print(f"[check] {arch} ({mcfg.family}) seq {seq} under flash (window "
                  f"{mcfg.sliding_window}, softcap {mcfg.attn_logit_softcap}, GQA "
                  f"{mcfg.num_heads // mcfg.num_kv_heads}, head_dim {mcfg.head_dim}, qkv_bias "
                  f"{mcfg.qkv_bias}, experts {mcfg.num_experts}, first_k_dense "
                  f"{mcfg.first_k_dense}, ssm_state {mcfg.ssm_state})")
        for (lg, rg, pg), (lc, rc, pc) in zip(runs["cuda"], runs["cpu"]):
            print(f"[check] loss gpu {lg:.7f} cpu {lc:.7f}; rank {rg}/{rc}; pivots {pg}/{pc}")
            assert abs(lg - lc) <= 1e-4 * abs(lc) and rg == rc and pg == pc, \
                "GPU run disagrees with the CPU run"
    _check_classify(base)
    _check_decode()


def _check_classify(base):
    """musicgen-smoke on synthetic_classification (8 frames, so that flash
    runs) and internvl2-smoke on synthetic_vision (17 positions: no flash
    tile fits, dense) on the card against the CPU: per-step losses rtol
    1e-4, ranks and pivots equal, then the held-out eval (loss rtol 1e-4,
    eval_acc equal)."""
    import torch
    from repro_torch.api import ExperimentConfig
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.evaluate import make_eval_fn_for
    from repro_torch.models.layers import resolve_attn_backend
    for arch, source, extra in (("musicgen-medium", "synthetic_classification",
                                 ["data.frames=8"]),
                                ("internvl2-26b", "synthetic_vision", [])):
        cfg = ExperimentConfig().apply_overrides(
            [f"data.source={source}", f"model.arch={arch}"] + base + extra)
        runs = {}
        for dev in ("cuda", "cpu"):
            mcfg, tcfg, data = cfg.build()
            gen = torch.Generator(device="cpu").manual_seed(0)
            model_cpu = steps_lib.init_train_state(mcfg, tcfg, gen, 8)["model"]
            state = steps_lib.state_for_model(mcfg, tcfg, model_cpu.to(dev), 8)
            step_fn = steps_lib.make_train_step(mcfg, tcfg)
            rows = []
            _zero_counts()
            for s in range(cfg.train.steps):
                batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(s).items()}
                state, m = step_fn(state, batch)
                rows.append((m["loss"].item(), int(m["rank"]),
                             state["graft"].pivots.cpu().tolist()))
            counts = _read_counts()
            S = _seq_len(mcfg, data.batch_at(0))
            flash = resolve_attn_backend(mcfg, S, S, torch.device("cuda")) == "flash"
            on_card = dev == "cuda"
            assert (counts["graft_select"] > 0) == on_card and \
                (counts["flash_forward"] > 0) == (on_card and flash), f"{dev}: {counts}"
            ev = make_eval_fn_for(cfg, mcfg, device=dev)(state["model"])
            runs[dev] = (rows, ev)
        print(f"[check] {arch} ({mcfg.family}, {mcfg.frontend}) on {source}, S {S}, "
              f"{'flash' if flash else 'dense'} attention; eval gpu {runs['cuda'][1]} cpu "
              f"{runs['cpu'][1]}")
        for (lg, rg, pg), (lc, rc, pc) in zip(runs["cuda"][0], runs["cpu"][0]):
            print(f"[check] loss gpu {lg:.7f} cpu {lc:.7f}; rank {rg}/{rc}; pivots {pg}/{pc}")
            assert abs(lg - lc) <= 1e-4 * abs(lc) and rg == rc and pg == pc, \
                "GPU run disagrees with the CPU run"
        (eg, ec) = runs["cuda"][1], runs["cpu"][1]
        assert abs(eg["eval_loss"] - ec["eval_loss"]) <= 1e-4 * abs(ec["eval_loss"]) and \
            eg["eval_acc"] == ec["eval_acc"], "GPU eval disagrees with the CPU eval"


# (arch, max_seq): each family's smoke config; gemma2 at 32 so that its
# window of 16 bites
CHECK_DECODE = [("minicpm-2b", 24), ("stablelm-12b", 24), ("gemma2-27b", 32),
                ("qwen1.5-32b", 24), ("rwkv6-7b", 24), ("hymba-1.5b", 24),
                ("qwen3-moe-235b-a22b", 24), ("kimi-k2-1t-a32b", 24)]


def _check_decode():
    """prefill (8 tokens) and every decode step to max_seq of each family's
    smoke config, float32, on the card against the CPU: logits within rtol
    1e-4 and 1e-5 of their largest value; no kernel launched on the card."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import decode as decode_lib
    from repro_torch.models import model as model_lib
    for arch, max_seq in CHECK_DECODE:
        mcfg = get_smoke_config(arch, param_dtype="float32")
        model = model_lib.init_params(mcfg, torch.Generator().manual_seed(0))
        toks = np.random.default_rng(1).integers(0, mcfg.vocab_size, (2, max_seq)).astype(np.int32)
        logits = {}
        for dev in ("cuda", "cpu"):
            m = model.to(dev)
            t = torch.from_numpy(toks).to(dev)
            _zero_counts()
            lg, cache = decode_lib.prefill(mcfg, m, {"tokens": t[:, :8], "labels": t[:, :8]},
                                           max_seq)
            outs = [lg]
            for i in range(8, max_seq):
                lg, cache = decode_lib.decode_step(mcfg, m, cache, t[:, i:i + 1])
                outs.append(lg)
            logits[dev] = torch.cat(outs, 1).cpu()
            counts = _read_counts()
            assert not any(counts.values()), f"{arch} on {dev}: decode launched {counts}"
        diff = float((logits["cuda"] - logits["cpu"]).abs().max())
        scale = float(logits["cpu"].abs().max())
        ok = bool(((logits["cuda"] - logits["cpu"]).abs()
                   <= 1e-4 * logits["cpu"].abs() + 1e-5 * scale).all())
        print(f"[check] decode {arch} max_seq {max_seq}: prefill + {max_seq - 8} steps, "
              f"max|gpu - cpu| {diff:.3g} of max|logit| {scale:.3g} -> {'ok' if ok else 'FAIL'}")
        assert ok, f"{arch}: card decode disagrees with the CPU"


# ---------------------------------------------------------------------------
# the optimizer step: kernel A (global norm and clip factor), kernel B (update)
# ---------------------------------------------------------------------------

OPTIM_REPLACES = {
    "grad_norm": "no TPU kernel: src/repro/optim/optimizers.py:43-52 (global_norm, "
                 "clip_by_global_norm, jitted by XLA)",
    "optimizer_update": "no TPU kernel: src/repro/optim/optimizers.py:83-107 (AdamW; SGD "
                        ":117-133, Lion :143-161, jitted by XLA)"}
# bytes of device memory one batch of leaves may take in the bit-equality
# check (two copies of p, m, v and the gradients)
OPTIM_CHECK_BYTES = 36e9


def _minicpm_leaves():
    """(shape, dtype) of every parameter of minicpm-2b at full depth, from
    the port's model on the meta device (nothing allocated)."""
    from repro_torch.api import ExperimentConfig
    from repro_torch.models.model import Model
    mcfg = ExperimentConfig().apply_overrides(SLICE_OVERRIDES).model.build()
    return mcfg, [(tuple(p.shape), p.dtype) for p in Model(mcfg, device="meta").parameters()]


def _randn(shapes, dtype, seed, scale, positive=False):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for shape, dt in shapes:
        x = torch.randn(shape, generator=g, device="cuda", dtype=torch.float32) * scale
        out.append((x.abs() if positive else x).to(dtype or dt))
    return out


def _hyper(step):
    import numpy as np
    from repro_torch.kernels import fused_optim as fo
    t = np.float32(step + 1)
    return fo.Hyper(lr=3e-4, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.01,
                    momentum=0.9, bc1=float(np.float32(1) - np.float32(0.9) ** t),
                    bc2=float(np.float32(1) - np.float32(0.95) ** t))


def _optim_bit_equal(shapes, rule, pdt, sdt):
    """Three steps of kernel B and of its plain version from the same state
    on every leaf, in batches of leaves that fit; returns the largest
    |difference| of p, m, v (0.0 when bit-equal)."""
    import torch
    from repro_torch.kernels import fused_optim as fo
    per = 2 * (pdt.itemsize + sdt.itemsize * (2 if rule == "adamw" else 1)) + pdt.itemsize
    batches, cur, used = [], [], 0.0
    for shape, _ in shapes:
        n = 1
        for d in shape:
            n *= d
        if cur and used + n * per > OPTIM_CHECK_BYTES:
            batches.append(cur)
            cur, used = [], 0.0
        cur.append((shape, pdt))
        used += n * per
    batches.append(cur)
    worst = 0.0
    for bi, batch in enumerate(batches):
        p = _randn(batch, pdt, 100 + bi, 0.02)
        m = _randn(batch, sdt, 200 + bi, 1e-3)
        v = _randn(batch, sdt, 300 + bi, 1e-6, positive=True) if rule == "adamw" else None
        twin = [[t.clone() for t in x] if x is not None else None for x in (p, m, v)]
        for step in range(3):
            g = _randn(batch, pdt, 400 + 10 * bi + step, 1e-3)
            _, scale = fo.grad_norm(g, 1.0)
            fo.optimizer_update(rule, p, g, m, v, _hyper(step), scale)
            fo.update_reference(rule, twin[0], g, twin[1], twin[2], _hyper(step), scale)
            del g
        torch.cuda.synchronize()
        for got, want in zip((p, m, v), twin):
            for a, b in zip(got or [], want or []):
                if not torch.equal(a, b):
                    worst = max(worst, (a.float() - b.float()).abs().max().item())
        del p, m, v, twin
        torch.cuda.empty_cache()
    return worst, len(batches)


def phase_optim(ctx):
    """Kernels A and B on minicpm-2b's leaves at full depth: A against its
    plain version (rtol 1e-6) with reruns bit-equal, B bit-equal to its plain
    version for every rule, state dtype and param dtype over 3 steps, then
    both timed on the slice's dtypes beside their bounds, their plain
    versions and one PyTorch call each."""
    import torch
    from repro_torch.kernels import fused_optim as fo
    mcfg, shapes = _minicpm_leaves()
    n = sum(int(torch.Size(s).numel()) for s, _ in shapes)
    print(f"[optim] minicpm-2b full depth: {len(shapes)} leaves, {n} params "
          f"({sum(1 for _, d in shapes if d == torch.bfloat16)} bf16, the rest float32)",
          flush=True)
    grads = _randn(shapes, None, 1, 1e-3)
    norm, scale = fo.grad_norm(grads, 1.0)
    again = fo.grad_norm(grads, 1.0)
    want_norm, want_scale = fo.grad_norm_reference(grads, 1.0)
    torch.cuda.synchronize()
    err = abs(norm.item() - want_norm.item())
    rerun_eq = torch.equal(norm, again[0]) and torch.equal(scale, again[1])
    scale_err = abs(scale.item() - want_scale.item())
    print(f"[optim] grad_norm {norm.item():.9g} vs plain {want_norm.item():.9g}: |diff| "
          f"{err:.3g} (rtol 1e-6: float32 sums in another order); scale {scale.item():.9g} "
          f"vs {want_scale.item():.9g}; rerun {'bit-equal' if rerun_eq else 'DIFFERS'}",
          flush=True)
    assert err <= 1e-6 * want_norm.item() and rerun_eq, "grad_norm vs its plain version"
    assert scale_err <= 1e-6 * want_scale.item(), "clip factor vs the plain version's"
    del grads, again
    torch.cuda.empty_cache()
    update_err = 0.0
    for rule in ("adamw", "sgd", "lion"):
        for pdt in (torch.bfloat16, torch.float32):
            for sdt in (torch.float32, torch.bfloat16):
                t0 = time.perf_counter()
                worst, nb = _optim_bit_equal(shapes, rule, pdt, sdt)
                print(f"[optim] {rule} params {str(pdt)[6:]} state {str(sdt)[6:]}: p, m, v "
                      f"after 3 steps {'bit-equal' if worst == 0.0 else f'DIFFER by {worst:.3g}'}"
                      f" to the plain version ({nb} batch(es) of leaves, "
                      f"{time.perf_counter() - t0:.1f} s)", flush=True)
                assert worst == 0.0, f"optimizer_update {rule} {pdt} {sdt} vs plain"
                update_err = max(update_err, worst)
    _optim_times(ctx, shapes, err, update_err)


def _optim_times(ctx, shapes, norm_err, update_err):
    """The slice's optimizer step (bf16 matrices, float32 norms, float32
    moments, AdamW) timed by CUDA events and profiler device time."""
    import torch
    from repro_torch.kernels import fused_optim as fo
    p = _randn(shapes, None, 11, 0.02)
    g = _randn(shapes, None, 12, 1e-3)
    m = _randn(shapes, torch.float32, 13, 1e-3)
    v = _randn(shapes, torch.float32, 14, 1e-6, positive=True)
    _, scale = fo.grad_norm(g, 1.0)
    hp = _hyper(5)
    n = sum(t.numel() for t in p)
    t = {}
    t["A"], t["A_device"] = _device_times(lambda: fo.grad_norm(g, 1.0), "norm_")
    t["A_plain"] = _time_auto(lambda: fo.grad_norm_reference(g, 1.0))
    get_total_norm = getattr(torch.nn.utils, "get_total_norm", None)
    t["A_library"] = _time_auto(lambda: get_total_norm(g, 2.0, foreach=True)) \
        if get_total_norm is not None else None
    t["B"], t["B_device"] = _device_times(
        lambda: fo.optimizer_update("adamw", p, g, m, v, hp, scale), "fused_update_kernel")
    t["B_plain"] = _time_auto(lambda: fo.update_reference("adamw", p, g, m, v, hp, scale),
                              max_iters=5)
    for rule in ("sgd", "lion"):
        t[rule] = _time_auto(lambda: fo.optimizer_update(rule, p, g, m, None, hp, scale),
                             max_iters=50)
    del m, v
    torch.cuda.empty_cache()
    # the library's fused AdamW keeps its moments in the params' dtype and
    # decays weights in another order: a time only
    leaves = [torch.nn.Parameter(x) for x in p]
    for leaf, gx in zip(leaves, g):
        leaf.grad = gx
    lib = torch.optim.AdamW(leaves, lr=3e-4, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.01,
                            fused=True)
    t["B_library"] = _time_auto(lib.step, max_iters=20)
    del lib, leaves
    torch.cuda.empty_cache()
    # the same function as B: float32 moments. PyTorch keeps AdamW's moments
    # in the params' dtype, so its params (and grads) are float32 copies
    leaves = [torch.nn.Parameter(x.float()) for x in p]
    for leaf, gx in zip(leaves, g):
        leaf.grad = gx.float()
    lib = torch.optim.AdamW(leaves, lr=3e-4, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.01,
                            fused=True)
    t["B_library_f32"] = _time_auto(lib.step, max_iters=20)
    lib_f32_bytes = 28 * n          # p, m, v read and written, g read: all float32
    del lib, leaves
    torch.cuda.empty_cache()
    a_bound = _cost_bound(fo.norm_cost([(x.numel(), x.dtype) for x in g]))
    b_bound = _cost_bound(fo.update_cost("adamw", [(x.numel(), x.dtype, torch.float32) for x in p]))
    print(f"[optim] {ctx['smi']}", flush=True)
    print(f"[optim] grad_norm (A) over {n} params: {t['A']:.4f} ms (events), "
          f"{t['A_device']:.4f} ms (profiler device time); plain {t['A_plain']:.4f} ms; "
          f"torch.nn.utils.get_total_norm(foreach) {t['A_library']} ms; bound {a_bound[0]:.4f} "
          f"ms by {a_bound[1]} ({a_bound[2]} bytes, {a_bound[3]} flop); "
          f"{t['A_device'] / a_bound[0]:.2f}x the bound", flush=True)
    print(f"[optim] optimizer_update (B) AdamW, 2 launches (bf16 and float32 params), float32 "
          f"moments: {t['B']:.4f} ms (events), {t['B_device']:.4f} ms (profiler device time); "
          f"plain {t['B_plain']:.4f} ms; torch.optim.AdamW(fused=True) {t['B_library']:.4f} ms; "
          f"bound {b_bound[0]:.4f} ms by {b_bound[1]} ({b_bound[2]} bytes, {b_bound[3]} flop); "
          f"{t['B_device'] / b_bound[0]:.2f}x the bound; SGD {t['sgd']:.4f} ms, Lion "
          f"{t['lion']:.4f} ms (events)", flush=True)
    print(f"[optim] torch.optim.AdamW(fused=True) with float32 moments (B's function; its "
          f"params and grads float32 copies, as PyTorch keeps the moments in the params' "
          f"dtype): {t['B_library_f32']:.4f} ms (events); it moves {lib_f32_bytes} bytes "
          f"(bound {lib_f32_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms) where B moves "
          f"{b_bound[2]}; the bf16-moment call above {t['B_library']:.4f} ms", flush=True)
    src = "src/repro_torch/csrc/fused_optim.cu"
    ctx["kernels"]["grad_norm"] = {
        "name": "grad_norm", "route": "cuda", "source": src,
        "replaces": OPTIM_REPLACES["grad_norm"], "launches": None, "max_abs_err": norm_err,
        "ms": t["A"], "plain_ms": t["A_plain"], "bound_ms": a_bound[0],
        "bound_by": a_bound[1], "library_ms": t["A_library"], "device_ms": t["A_device"]}
    ctx["kernels"]["optimizer_update"] = {
        "name": "optimizer_update", "route": "cuda", "source": src,
        "replaces": OPTIM_REPLACES["optimizer_update"], "launches": None, "max_abs_err": update_err,
        "ms": t["B"], "plain_ms": t["B_plain"], "bound_ms": b_bound[0],
        "bound_by": b_bound[1], "library_ms": t["B_library_f32"], "device_ms": t["B_device"],
        "library_bf16_moments_ms": t["B_library"]}
    del p, g
    gc.collect()
    torch.cuda.empty_cache()


# the JAX package's JSONL row keys on a GRAFT step with the sentinel
JSONL_KEYS = {"step", "time", "tokens_seen", "step_time_s", "tokens_per_s", "mfu",
              "mfu_source", "host_overhead_s", "loss", "grad_norm", "lr", "rank",
              "proj_error", "alignment", "healthy", "bad_streak"}
SHELL_LAYERS = 2


def phase_shell(ctx):
    """The Trainer shell at minicpm-2b's full width, depth cut to
    SHELL_LAYERS: an uninterrupted 6-step run, then a run that stops at
    step 3 with a checkpoint and its resume to step 6; restored state
    bit-equal to the saved one, resumed losses against the uninterrupted
    run's, the JSONL rows' keys, eval and mfu."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.api import ExperimentConfig, Trainer
    from repro_torch.api.callbacks import Callback
    from repro_torch.checkpoint import (CheckpointManager, load_train_state, train_state_spec,
                                        train_state_to_host)
    from repro_torch.launch.metrics import PEAK_FLOPS_PER_CHIP, read_metrics, train_step_flops
    ctx.pop("trainer", None)
    gc.collect()
    torch.cuda.empty_cache()
    work = os.path.join(ROOT, "build", "chip_smoke_shell")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ck = os.path.join(work, "ckpt")
    base = ([o for o in SLICE_OVERRIDES if not o.startswith("model.overrides")]
            + [f'model.overrides={{"attn_backend": "auto", "num_layers": {SHELL_LAYERS}}}',
               "train.eval_every=2", "train.checkpoint_every=3", "train.log_every=0"])
    try:
        full_cfg = ExperimentConfig().apply_overrides(
            base + [f"train.metrics_path={work}/full.jsonl"])
        full = Trainer(full_cfg)
        rep_full = full.fit()
        spec = train_state_spec(full.state)
        ckpt_bytes = sum(int(np.prod(s)) * d.itemsize for s, d in spec.values())
        free = shutil.disk_usage(work).free
        print(f"[shell] minicpm-2b full width, {SHELL_LAYERS} of 40 layers: {full.num_params} "
              f"params; a checkpoint holds {ckpt_bytes} bytes; {free} bytes free on disk",
              flush=True)
        if free < 3 * ckpt_bytes:
            raise RuntimeError(f"phase shell needs ~{3 * ckpt_bytes} bytes of disk under "
                               f"{work} (two checkpoints kept and one more written), has {free}")

        class Snapshot(Callback):
            priority = 95          # after the checkpointer's restore

            def on_train_start(self, trainer):
                self.host = train_state_to_host(trainer.state)

        stop_cfg = ExperimentConfig().apply_overrides(
            base + ["train.stop_after=3", f"train.checkpoint_dir={ck}",
                    f"train.metrics_path={work}/resumed.jsonl"])
        stopped = Trainer(stop_cfg)
        rep_stop = stopped.fit()
        saved = train_state_to_host(stopped.state)
        t0 = time.perf_counter()
        flat = train_state_to_host(stopped.state)
        t_host = time.perf_counter() - t0
        t0 = time.perf_counter()
        CheckpointManager(os.path.join(work, "timed"), async_save=False).save(3, flat)
        t_write = time.perf_counter() - t0
        shutil.rmtree(os.path.join(work, "timed"))
        del flat
        t0 = time.perf_counter()
        _, flat, _ = CheckpointManager(ck).restore_latest_good(spec)
        t_read = time.perf_counter() - t0
        t0 = time.perf_counter()
        load_train_state(stopped.state, flat)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        del flat
        snap = Snapshot()
        resumed = Trainer.from_checkpoint(ck, callbacks=[snap])
        rep_res = resumed.fit()
        same = set(snap.host) == set(saved) and all(
            torch.equal(snap.host[k], saved[k]) for k in saved)
        print(f"[shell] {ctx['smi']}", flush=True)
        print(f"[shell] checkpoint {ckpt_bytes} bytes: device->host copy {t_host:.3f} s, "
              f"write {t_write:.3f} s (sync); restore: read + verify {t_read:.3f} s, load "
              f"onto the card {t_load:.3f} s; the resumed run's restored state "
              f"{'bit-equal' if same else 'DIFFERS from'} the saved one", flush=True)
        assert same, "restored state differs from the saved one"
        assert rep_stop["stopped"] == "stop_after" and resumed.start_step == 3
        want = [r["loss"] for r in rep_full["history"]]
        got = [r["loss"] for r in rep_stop["history"]] + [r["loss"] for r in rep_res["history"]]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        print(f"[shell] losses uninterrupted {want}; stopped + resumed {got}; max rel diff "
              f"{rel:.3g} (rtol 1e-5); {'bit-equal' if got == want else 'not bit-equal'}; "
              f"config_hash {rep_full['config_hash']} / {rep_res['config_hash']}", flush=True)
        assert len(got) == 6 and rel <= 1e-5, "resumed losses differ from the uninterrupted run"
        assert rep_full["config_hash"] == rep_res["config_hash"]
        rows = read_metrics(f"{work}/full.jsonl")
        flops = train_step_flops(full.num_params, 16 * 256, remat=True, mcfg=full.mcfg, seq=256)
        for r in rows:
            missing = JSONL_KEYS - set(r) - ({"host_overhead_s"} if r["step"] == 0 else set())
            assert not missing, f"row {r['step']} lacks {missing}"
            assert ("eval_loss" in r) == (r["step"] % 2 == 1), r
            if r.get("mfu_source") == "device":
                assert abs(r["mfu"] - flops / (r["device_step_time_s"] * PEAK_FLOPS_PER_CHIP)) \
                    <= 1e-9 * r["mfu"]
        print(f"[shell] JSONL: {len(rows)} rows with the JAX row keys; eval_loss "
              f"{[round(r['eval_loss'], 5) for r in rows if 'eval_loss' in r]}; mfu against "
              f"{PEAK_FLOPS_PER_CHIP:.3g} FLOP/s {[(r['mfu_source'], round(r['mfu'], 4)) for r in rows]}",
              flush=True)
        assert [r["step"] for r in rows] == list(range(6))
        assert any(r["mfu_source"] == "device" for r in rows), "no device-timed row"
        resumed_rows = read_metrics(f"{work}/resumed.jsonl")
        assert [r["step"] for r in resumed_rows] == list(range(6)), resumed_rows
    finally:
        shutil.rmtree(work, ignore_errors=True)



# the NaN cases of Fast MaxVol's order, on the warp routine (K 16, R 8) and
# the block routine (K 40 and 64, R 16)
NAN_SHAPES = [(16, 8), (40, 16), (64, 16)]


def _nan_v(case, K, R, seed=0):
    import numpy as np
    V = np.random.default_rng(seed).standard_normal((K, R)).astype(np.float32)
    if case == "nan_column":
        V[:, 0] = np.nan
    elif case == "scattered":
        V[[3, K - 5], 2] = np.nan
    else:
        V[:] = np.nan
    return V


def _chaos_nan_order(dev):
    """graft_select and fast_maxvol on V holding NaN: pivots equal to the
    twin's, distinct and in [0, K) (launches made to compare, not counted)."""
    import torch
    from repro_torch.core import maxvol as maxvol_lib
    from repro_torch.kernels.fast_maxvol import fast_maxvol
    from repro_torch.kernels.graft_select import graft_select
    for K, R in NAN_SHAPES:
        for case in ("nan_column", "scattered", "all_nan"):
            V = torch.from_numpy(_nan_v(case, K, R)).to(dev)
            G = torch.randn(2304, K, generator=torch.Generator().manual_seed(K)).to(dev)
            want = maxvol_lib.fast_maxvol(V, R)[0].long()
            piv, _, _, G_sel = graft_select(V, G, G.mean(dim=1), R)
            piv2, _ = fast_maxvol(V, R)
            torch.cuda.synchronize()
            got = piv.long().cpu().tolist()
            ok = (torch.equal(piv.long(), want) and torch.equal(piv2, piv)
                  and all(0 <= i < K for i in got) and len(set(got)) == R
                  and torch.equal(G_sel, G[:, piv.long()]))
            print(f"[chaos] NaN order K={K} R={R} {case} ({'warp' if K <= 32 and R <= 8 else 'block'} "
                  f"routine): graft_select pivots {got}, twin {want.cpu().tolist()}, fast_maxvol "
                  f"{'equal' if torch.equal(piv2, piv) else 'DIFFERS'} -> {'ok' if ok else 'FAIL'}",
                  flush=True)
            assert ok, f"MaxVol's NaN order differs from the twin's at K={K} R={R} {case}"


def _chaos_reckon(mcfg, steps, refresh_every, flash):
    """Launches that the dispatched ``steps`` reckon:
    ``launch_audit.dispatched_launches``."""
    from repro_torch.analysis import launch_audit
    return launch_audit.dispatched_launches(mcfg, steps, refresh_every, flash)


def _chaos_scenario(work, scenario, extra, **kw):
    """Run one matrix scenario with the counts zeroed just before and read
    just after; returns (result, rows, launches, wall seconds)."""
    import shutil
    import torch
    from repro_torch.launch.metrics import read_metrics
    td = os.path.join(work, scenario.__name__)
    shutil.rmtree(td, ignore_errors=True)
    os.makedirs(td)
    _zero_counts()
    t0 = time.perf_counter()
    result = scenario(td, *extra, device=torch.device("cuda"), **kw)
    wall = time.perf_counter() - t0
    launches = _read_counts()
    rows = read_metrics(os.path.join(td, "metrics.jsonl"))
    shutil.rmtree(td, ignore_errors=True)
    return result, rows, launches, wall


def phase_chaos(ctx):
    """The chaos harness on the card: MaxVol's NaN order against the twin;
    the matrix's five scenarios at the reference's cell through the refresh
    kernel; nan_rollback at minicpm-2b's full width (2 of 40 layers, flash)
    with its save and restore seconds; a stalled DeviceClock event at the
    same width."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.api import ExperimentConfig, Trainer
    from repro_torch.backend import base as backend_base
    from repro_torch.checkpoint import checkpoint as ck_lib
    from repro_torch.launch.metrics import read_metrics
    from repro_torch.models.layers import resolve_attn_backend
    from repro_torch.resilience import __main__ as matrix
    ctx.pop("trainer", None)
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    _chaos_nan_order(dev)
    work = os.path.join(ROOT, "build", "chip_smoke_chaos")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        # (a) the reference's cell, GRAFT through graft_select
        cell = matrix._cell(work, "graft.use_pallas=true")
        mcfg = cell.model.build()
        flash = resolve_attn_backend(mcfg, cell.train.seq, cell.train.seq, dev) == "flash"
        for scenario in matrix.SCENARIOS:
            result, rows, launches, wall = _chaos_scenario(
                work, scenario, ["graft.use_pallas=true"])
            steps = [r["step"] for r in rows]
            want = _chaos_reckon(mcfg, steps, cell.graft.refresh_every, flash)
            got = {k: launches[k] for k in want}
            print(f"[chaos] (a) {matrix.scenario_name(scenario)}: {result}; {len(steps)} steps "
                  f"dispatched, {want['graft_select']} of them refreshes; launches {got}, "
                  f"reckoned {want}; {wall:.2f} s", flush=True)
            assert got == want, f"{scenario.__name__}: launches {got}, reckoned {want}"
            assert launches["graft_select"] > 0

        # (b) nan_rollback at full width, 2 layers: 12 steps, a checkpoint
        # every 4, the poisoned step 10 a refresh step
        base = ([o for o in SLICE_OVERRIDES if not o.startswith(("model.overrides",
                                                                  "train.steps",
                                                                  "train.log_every"))]
                + [f'model.overrides={{"attn_backend": "auto", "num_layers": {SHELL_LAYERS}}}',
                   "train.log_every=0"])
        wide = base + ["train.steps=12", "train.checkpoint_every=4", "graft.refresh_every=2"]
        cfg = matrix._cell(work, *wide)
        mcfg = cfg.model.build()
        assert resolve_attn_backend(mcfg, cfg.train.seq, cfg.train.seq, dev) == "flash"
        from repro_torch.models.model import Model
        with torch.device("meta"):                  # shapes and dtypes, no memory
            params = list(Model(mcfg).parameters())
        n_params = sum(p.numel() for p in params)
        # the params in their dtype, AdamW's float32 moments
        ckpt_bytes = sum(p.numel() * (p.element_size() + 8) for p in params)
        free = shutil.disk_usage(work).free
        print(f"[chaos] (b) minicpm-2b full width, {SHELL_LAYERS} of 40 layers: {n_params} "
              f"params, ~{ckpt_bytes} bytes a checkpoint, {free} bytes free", flush=True)
        if free < 6 * ckpt_bytes:
            raise RuntimeError(f"phase chaos needs ~{6 * ckpt_bytes} bytes of disk under {work} "
                               f"(two checkpoints kept, one in flight, the twin's copy and "
                               f"its save), has {free}")
        timed = {"to_host": [], "write": [], "restore": []}

        def timer(fn, key):
            def wrapped(*a, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    timed[key].append(time.perf_counter() - t0)
            return wrapped

        # the checkpoint's device->host copy is the backend's to_host
        saved = (backend_base.Backend.to_host, ck_lib.CheckpointManager._write,
                 ck_lib.CheckpointManager.restore_latest_good)
        backend_base.Backend.to_host = timer(saved[0], "to_host")
        ck_lib.CheckpointManager._write = timer(saved[1], "write")
        ck_lib.CheckpointManager.restore_latest_good = timer(saved[2], "restore")
        try:
            result, rows, launches, wall = _chaos_scenario(
                work, matrix.scenario_nan_rollback, wide, nan_step=10)
        finally:
            (backend_base.Backend.to_host, ck_lib.CheckpointManager._write,
             ck_lib.CheckpointManager.restore_latest_good) = saved
        steps = [r["step"] for r in rows]
        want = _chaos_reckon(mcfg, steps, 2, True)
        want["grad_norm"] = len(steps)
        # a vetoed step launches grad_norm but no update
        want["optimizer_update"] = _optim_groups(params) * sum(
            1 for r in rows if r["healthy"] == 1.0)
        got = {k: launches[k] for k in want}
        poisoned = [r for r in rows if r["step"] == 10 and r.get("loss") is None]
        print(f"[chaos] (b) nan_rollback: {result}; steps dispatched {steps}; the poisoned row "
              f"{poisoned[0] if poisoned else None}", flush=True)
        print(f"[chaos] (b) launches {got}, reckoned {want}; {wall:.2f} s", flush=True)
        print(f"[chaos] (b) {ctx.get('smi', '')}: checkpoint ~{ckpt_bytes} bytes; device->host "
              f"copies {[round(t, 3) for t in timed['to_host']]} s, writes (writer thread) "
              f"{[round(t, 3) for t in timed['write']]} s, restores (read + verify) "
              f"{[round(t, 3) for t in timed['restore']]} s", flush=True)
        assert result["rolled_back_to"] == 8, result
        assert poisoned and "loss" in poisoned[0]["nonfinite_keys"]
        assert got == want, f"launches {got}, reckoned {want}"

        # (c) a stalled DeviceClock event at the same width
        plan = json.dumps([{"kind": "stall", "step": 2, "seconds": 3.0}])
        path = os.path.join(work, "stall.jsonl")
        stall_cfg = ExperimentConfig().apply_overrides(
            base + ["train.steps=6", "train.metrics_flush_every=2", f"train.metrics_path={path}",
                    "train.device_timeout_s=0.3", f"train.fault_plan={plan}"])
        t0 = time.perf_counter()
        report = Trainer(stall_cfg).fit()
        wall = time.perf_counter() - t0
        rows = read_metrics(path)
        sources = [(r["step"], r.get("mfu_source")) for r in rows]
        print(f"[chaos] (c) stall 3 s at step 2, watchdog 0.3 s: device_stalled "
              f"{report['host_loop'].get('device_stalled')}, fit {wall:.2f} s, step times "
              f"{[round(r['step_time_s'], 4) for r in rows]} s, mfu sources {sources}", flush=True)
        assert report["host_loop"].get("device_stalled") is True
        assert wall < 60, f"the stalled run took {wall:.1f} s"
        assert any(st >= 2 and src == "dispatch" for st, src in sources), sources
        assert all(np.isfinite(r["loss"]) for r in rows)
    finally:
        shutil.rmtree(work, ignore_errors=True)

ANALYSIS_WIDE = [f'model.overrides={{"attn_backend": "auto", "num_layers": {SHELL_LAYERS}}}',
                 "model.smoke=false"]
# the audit's cost: the probe without its checkpoints, steps enough for a
# steady mean, train.audit off and on in turns (off, on, on, off, twice)
ANALYSIS_TIMING = ["train.steps=32", "train.checkpoint_dir=null", "train.log_every=0"]
ANALYSIS_TURNS = (False, True, True, False) * 2


def _analysis_report(tag, report, t0):
    """Print a battery's errors and its launch, sync and library notes
    (the whole report goes to build/chip_smoke_analysis_<tag>.json)."""
    keep = ("JX003", "JX001", "SY001", "SP001")
    for f in report:
        if f.severity != "info" or f.rule in keep or "C library" in f.message:
            print(f"[analysis] ({tag}) {f.format()}", flush=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", f"chip_smoke_analysis_{tag}.json"), "w") as f:
        f.write(report.to_json())
    errors = len(report.errors)
    print(f"[analysis] ({tag}) {len(report)} findings, {errors} error(s), "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    assert report.ok, f"({tag}) the battery found {errors} error(s)"


def phase_analysis(ctx):
    """The analysis battery (``python -m repro_torch.analysis``) on the
    card: (a) at the JAX probe shapes; (b) at full width — the refresh
    contracts at minicpm-2b's K 16 / R 8 / d 2304 and at d 4096, the
    attention contract and the runtime probe on minicpm-2b's widths at 2 of
    40 layers. Every launching section is held to the profiler's count of
    the CUDA kernels by name, and every sum of the shared-memory estimator
    to the C library's. Then the probe's steady step with train.audit off
    and on in turns at the same width."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.analysis import runner
    from repro_torch.api import ExperimentConfig
    ctx.pop("trainer", None)
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    _analysis_report("probe", runner.run_all(device="cuda"), t0)

    t0 = time.perf_counter()
    mcfg = ExperimentConfig().apply_overrides(ANALYSIS_WIDE).model.build()
    print(f"[analysis] (wide) minicpm-2b full width, {mcfg.num_layers} of 40 layers: d_model "
          f"{mcfg.d_model}, {mcfg.num_heads} heads x {mcfg.head_dim}, vocab "
          f"{mcfg.vocab_size}, {mcfg.param_dtype}", flush=True)
    report = runner.run_battery(
        dev, selections=((16, 2304, 8, (2, 4, 8)), (16, 4096, 8, (2, 4, 8))),
        attn_mcfg=dataclasses.replace(mcfg, attn_backend="flash"), attn_batch=4,
        attn_seq=256, overrides=ANALYSIS_WIDE)
    _analysis_report("wide", report, t0)

    t0 = time.perf_counter()
    steady = {False: [], True: []}
    for audit in ANALYSIS_TURNS:
        gc.collect()
        torch.cuda.empty_cache()
        _, run, rep = runner.run_probe(
            ANALYSIS_WIDE + ANALYSIS_TIMING + [f"train.audit={str(audit).lower()}"], dev)
        assert rep.ok and run is not None, rep.format()
        ms = [r["step_time_s"] * 1e3 for r in run["history"][1:]]
        steady[audit].append(float(np.mean(ms)))
        print(f"[analysis] train.audit={audit}: steady step (steps 1-{len(ms)}) mean "
              f"{np.mean(ms):.3f} ms, median {np.median(ms):.3f} ms"
              + (f"; {run['audit']['sync_events']} sanctioned syncs" if audit else ""),
              flush=True)
    off, on = np.mean(steady[False]), np.mean(steady[True])
    spread = max(np.ptp(steady[False]), np.ptp(steady[True]))
    print(f"[analysis] {ctx.get('smi', '')}: train.audit costs {on - off:.3f} ms a step "
          f"({on:.3f} on, {off:.3f} off; the runs of one setting spread {spread:.3f} ms; "
          f"off {steady[False]}, on {steady[True]}); {time.perf_counter() - t0:.1f} s",
          flush=True)


BACKEND_LAYERS = 8            # (a): phase depth8's cut
BACKEND_STEPS = ["train.steps=6", "train.log_every=0"]


def _backend_overrides(layers):
    return ([o for o in SLICE_OVERRIDES if not o.startswith("model.overrides")]
            + [f'model.overrides={{"attn_backend": "auto", "num_layers": {layers}}}']
            + BACKEND_STEPS)


def _backend_check(tag, res):
    """A run's losses finite and its launches the reckoning."""
    import numpy as np
    want = res["launches_expected"]
    got = {k: res["launches"].get(k, 0) for k in want}
    print(f"[backend] {tag}: losses {[res['losses'][k] for k in sorted(res['losses'], key=int)]}"
          f"; step ms {[round(x * 1e3, 1) for x in res['step_s']]}; launches {got}", flush=True)
    assert all(np.isfinite(v) for v in res["losses"].values()), f"{tag}: non-finite loss"
    assert got == want, f"{tag}: launches {got}, reckoned {want}"
    for name in ("graft_select", "flash_forward", "flash_dq", "flash_dkv", "grad_norm",
                 "optimizer_update"):
        assert got[name] > 0, f"{tag}: {name} never launched"


def phase_backend(ctx):
    """Data-parallel training through the backend: (a) world size 1 over
    NCCL in process, bit-equal to the local backend; (b) two gloo ranks on
    the one card as subprocesses, held to the one-rank reckoning, to each
    other and to a 1-rank run."""
    import numpy as np
    import torch
    from repro_torch.backend import fleet
    ctx.pop("trainer", None)
    gc.collect()
    torch.cuda.empty_cache()

    # (a) world size 1 over NCCL beside the local backend, same call, in
    # turns local, NCCL, NCCL, local
    base = _backend_overrides(BACKEND_LAYERS)
    runs = {"local": [], "nccl": []}
    for kind in ("local", "nccl", "nccl", "local"):
        extra = fleet.backend_overrides(1, 0, fleet.free_port()) if kind == "nccl" else []
        res = fleet.run_worker(base + extra)
        _backend_check(f"(a) {kind}, {BACKEND_LAYERS} layers", res)
        assert kind == "local" or res["collectives"] == "nccl", \
            f"world size 1 on one card ran {res['collectives']}"
        runs[kind].append(res)
        gc.collect()
        torch.cuda.empty_cache()
    first = runs["local"][0]
    for res in runs["local"][1:] + runs["nccl"]:
        assert res["losses"] == first["losses"], "world size 1 losses differ from local"
        assert res["pivots"] == first["pivots"] and res["ranks"] == first["ranks"], \
            "world size 1 pivots or ranks differ from local"
        assert res["params_sha256"] == first["params_sha256"], \
            "world size 1 ends with other parameters than local"
    steady = {k: [float(np.mean(r["step_s"][1:])) * 1e3 for r in v] for k, v in runs.items()}
    print(f"[backend] (a) {ctx.get('smi', '')}: losses, final parameters and pivots of "
          f"{len(first['pivots'])} refreshes bit-equal in all four runs; steady step (steps 1-5) local "
          f"{[round(x, 3) for x in steady['local']]} ms, NCCL world 1 "
          f"{[round(x, 3) for x in steady['nccl']]} ms (means {np.mean(steady['local']):.3f} / "
          f"{np.mean(steady['nccl']):.3f}); the grad reduce's host ms a step "
          f"{[round(x * 1e3, 3) for x in runs['nccl'][-1]['reduce_s']]}", flush=True)
    del runs, first
    gc.collect()
    torch.cuda.empty_cache()

    # (b) two gloo ranks sharing the card, beside a 1-rank run
    base = _backend_overrides(SHELL_LAYERS)
    ref = fleet.run_worker(base)
    _backend_check(f"(b) 1 rank, {SHELL_LAYERS} layers", ref)
    gc.collect()
    torch.cuda.empty_cache()
    port = fleet.free_port()
    t0 = time.perf_counter()
    runs = fleet.launch([fleet.worker_command(base + fleet.backend_overrides(2, r, port))
                         for r in (0, 1)], timeout=400)
    wall = time.perf_counter() - t0
    ranks = [r.last_json() for r in runs]
    for r in ranks:
        assert r["collectives"] == "gloo", f"two ranks on one card ran {r['collectives']}"
        _backend_check(f"(b) rank {r['process_index']} of 2 ({r['collectives']})", r)
        assert r["launches_expected"]["graft_select"] == 3 and \
            r["launches_expected"]["grad_norm"] == 6
    assert ranks[0]["pivots"] == ranks[1]["pivots"], \
        f"ranks disagree on pivots: {ranks[0]['pivots']} vs {ranks[1]['pivots']}"
    assert ranks[0]["losses"] == ranks[1]["losses"], "ranks disagree on the reduced losses"
    assert ranks[0]["params_sha256"] == ranks[1]["params_sha256"], \
        "the ranks end with different parameters"
    steps = sorted(ref["losses"], key=int)
    rel = {key: [abs(ranks[0][key][k] - ref[key][k]) / abs(ref[key][k]) for k in steps]
           for key in ("losses", "grad_norms")}
    print(f"[backend] (b) {ctx.get('smi', '')}: fleet wall {wall:.1f} s; final parameters "
          f"bit-equal across the ranks; per-step relative difference to the 1-rank run: loss "
          f"{[f'{x:.3g}' for x in rel['losses']]}, grad norm "
          f"{[f'{x:.3g}' for x in rel['grad_norms']]}; pivots at the first "
          f"refresh {'equal' if ranks[0]['pivots']['0'] == ref['pivots']['0'] else 'differ'} "
          f"({ranks[0]['pivots']['0']} vs {ref['pivots']['0']}); steady step (steps 1-5) "
          f"rank 0 {np.mean(ranks[0]['step_s'][1:]) * 1e3:.3f} ms, 1 rank "
          f"{np.mean(ref['step_s'][1:]) * 1e3:.3f} ms; the grad reduce (gloo, through host "
          f"memory) a step: rank 0 {[round(x * 1e3, 1) for x in ranks[0]['reduce_s']]} ms, "
          f"rank 1 {[round(x * 1e3, 1) for x in ranks[1]['reduce_s']]} ms", flush=True)
    for key, gaps in rel.items():
        worst = int(np.argmax(gaps))
        assert gaps[worst] <= 3e-3, (f"step {steps[worst]}: fleet {key} "
                                     f"{ranks[0][key][steps[worst]]} vs 1 rank "
                                     f"{ref[key][steps[worst]]}")


SHARDED_LAYERS = 8            # (b), (c): phase depth8's cut
SHARDED_BATCH = 32            # (b): 16 rows a rank
PIPE_PER_STAGE, PIPE_MICRO, PIPE_MB = 4, 4, 2


def _sharded_inputs():
    """One refresh's selection inputs of minicpm-2b at full width, 8 of 40
    layers, batch 32 × 256 (random weights from seed 0, the batch of step
    0): V (32, 8), G (2304, 32), scores (32,)."""
    import torch
    from repro_torch.api import ExperimentConfig
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import model as model_lib
    cfg = ExperimentConfig().apply_overrides(
        _backend_overrides(SHARDED_LAYERS) + [f"train.batch={SHARDED_BATCH}"])
    mcfg, tcfg, data = cfg.build()
    model = model_lib.init_params(mcfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in data.batch_at(0).items()}
    _zero_counts()
    with torch.no_grad():
        V, G, _, scores = steps_lib.selection_inputs(mcfg, tcfg, model, batch)
    torch.cuda.synchronize()
    fwd = _read_counts()["flash_forward"]
    assert fwd == SHARDED_LAYERS, f"selection forward launched {fwd} flash forwards"
    del model
    return tcfg.graft, V.contiguous(), G.contiguous(), scores.contiguous()


def _sharded_reference(cfg, name, V, G, scores, n):
    """The sharded engine's global state (and carry) for ``n`` shards of one
    batch at step 0, from its per-shard pieces: each shard's selection on
    the card (``pivot_and_sweep`` for GRAFT, the sampler against the global
    ḡ otherwise), the collectives' arithmetic on the host."""
    import torch
    from repro_torch.core import projection as proj_lib
    from repro_torch.selection import SelectionInputs, get_sampler
    from repro_torch.selection import graft as graft_lib
    from repro_torch.selection.base import shard_generator
    k = V.shape[0] // n
    rows = [(V[s * k:(s + 1) * k], G[:, s * k:(s + 1) * k], scores[s * k:(s + 1) * k])
            for s in range(n)]
    g_bar = sum(torch.mean(g, dim=1).cpu() for _, g, _ in rows) / n
    if name == "graft":
        parts = [graft_lib.pivot_and_sweep(cfg, v, g, g_bar.cuda()) for v, g, _ in rows]
        rank, err = proj_lib.select_rank(sum(e.cpu() for _, e, _ in parts) / n,
                                         cfg.rset, cfg.eps)
        active = (torch.arange(cfg.r_max) < rank).to(torch.float32)
        w = active / torch.clamp(n * active.sum(), min=1.0)
        g_sub = sum(gs.cpu().to(torch.float32) @ w for _, _, gs in parts)
        state = {"pivots": torch.cat([p.cpu().to(torch.int32) + s * k
                                      for s, (p, _, _) in enumerate(parts)]),
                 "weights": w.repeat(n), "rank": rank, "last_error": err,
                 "alignment": proj_lib.cosine_alignment(g_sub, g_bar)}
        return state, {}
    smp = get_sampler(name)
    out = [smp.select(cfg, SelectionInputs(v, g, g_bar.cuda(), sc,
                                           shard_generator(0, s) if smp.needs_key else None),
                      None, 0) for s, (v, g, sc) in enumerate(rows)]
    sts = [st for st, _ in out]
    state = {"pivots": torch.cat([st.pivots.cpu().to(torch.int32) + s * k
                                  for s, st in enumerate(sts)]),
             "weights": torch.cat([st.weights.cpu() / n for st in sts]),
             "rank": max(st.rank.cpu() for st in sts),
             "last_error": sum(st.last_error.cpu() for st in sts) / n,
             "alignment": sum(st.alignment.cpu() for st in sts) / n}
    carry = out[0][1]
    if not isinstance(carry, dict):
        carry = {f: sum(getattr(c, f).cpu() for _, c in out) / n for f in carry._fields}
    return state, carry


def _sharded_agree(tag, got, want):
    """Pivots and rank equal, the float fields and carry leaves within rtol
    1e-5 (atol 1e-6 of each leaf's largest entry); the largest relative gap."""
    import torch
    assert torch.equal(got["pivots"].cpu(), want["pivots"]), \
        f"{tag}: pivots {got['pivots'].tolist()} vs {want['pivots'].tolist()}"
    assert int(got["rank"]) == int(want["rank"]), f"{tag}: rank {got['rank']} vs {want['rank']}"
    worst = 0.0
    for f in ("weights", "last_error", "alignment"):
        a, b = got[f].cpu().to(torch.float32), torch.as_tensor(want[f], dtype=torch.float32)
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-6), f"{tag}: {f} {a} vs {b}"
        worst = max(worst, float(((a - b).abs() / b.abs().clamp(min=1e-12)).max()))
    for f, b in want.get("carry", {}).items():
        a = got["carry"][f].cpu()
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max()) + 1e-12), \
            f"{tag}: carry {f} differs by {float((a - b).abs().max())}"
    return worst


def phase_sharded(ctx):
    """The sharded selection engine and the GPipe executor on a port Mesh:
    (a) world size 1 over NCCL in process, every sampler bit-equal to
    select_batch; (b) two gloo ranks on the one card, each with its half of
    a full-width refresh's rows, held to the one-rank reckoning, to each
    other and to the per-shard pieces run here; (c) the pipeline on two
    gloo ranks, 4 minicpm-2b blocks a stage, bit-equal to the 8 blocks run
    here."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.analysis import launch_audit
    from repro_torch.backend import (MultiProcessBackend, MultiProcessBackendConfig, fleet,
                                     make_mesh)
    from repro_torch.distributed.pipeline import pipeline_bubble_fraction
    from repro_torch.selection import available, engine
    ctx.pop("trainer", None)
    gc.collect()
    torch.cuda.empty_cache()
    smi = ctx.get("smi", "")
    t0 = time.perf_counter()
    cfg, V, G, scores = _sharded_inputs()
    names = list(available())
    print(f"[sharded] inputs of minicpm-2b at {SHARDED_LAYERS} layers, batch "
          f"{SHARDED_BATCH} x 256: V {tuple(V.shape)}, G {tuple(G.shape)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # (a) world size 1 over NCCL on a (1, 1) ("data", "model") mesh, at the
    # refresh shape K 16, R 8, d 2304 (the first 16 rows)
    Va, Ga, sa = V[:16].contiguous(), G[:, :16].contiguous(), scores[:16].contiguous()
    backend = MultiProcessBackend(MultiProcessBackendConfig(
        coordinator=f"127.0.0.1:{fleet.free_port()}", num_processes=1, process_id=0))
    backend.device()
    backend.setup()
    try:
        assert backend.collectives == "nccl", f"world size 1 ran {backend.collectives}"
        mesh = make_mesh((1, 1), ("data", "model"), backend)
        times = {}
        for name in names:
            _zero_counts()
            got, carry = engine.select_sharded(cfg, mesh, Va, Ga, sampler=name, scores=sa)
            torch.cuda.synchronize()
            counts = {k: v for k, v in _read_counts().items() if v}
            want_counts = {k: v for k, v in launch_audit.expected_sharded_launches(
                cfg, name).items() if v}
            assert counts == want_counts, f"(a) {name}: launches {counts}, reckoned {want_counts}"
            want, wcarry = engine.select_batch(cfg, name, Va, Ga, Ga.mean(dim=1), scores=sa)
            if name == "random":              # its shard draws from the shard's generator
                piv = got.pivots.cpu()
                assert int(piv.min()) >= 0 and int(piv.max()) < 16 and \
                    abs(float(got.weights.sum()) - 1.0) < 1e-5, f"(a) random: {got}"
            else:
                for f in want._fields:
                    assert torch.equal(getattr(got, f), getattr(want, f)), f"(a) {name}: {f}"
                for a, b in zip(tuple(carry), tuple(wcarry)):
                    assert torch.equal(a, b), f"(a) {name}: carry"
            times[name] = (
                cuda_time_ms(lambda: engine.select_sharded(cfg, mesh, Va, Ga, sampler=name,
                                                           scores=sa), 20),
                cuda_time_ms(lambda: engine.select_batch(cfg, name, Va, Ga, Ga.mean(dim=1),
                                                         scores=sa), 20))
        print(f"[sharded] (a) {smi}: NCCL world 1, (1, 1) mesh: every sampler but random "
              f"bit-equal to select_batch, state and carry; graft_select launches 1 for graft "
              f"and streaming_graft, 0 else; ms (select_sharded / select_batch, events): "
              + ", ".join(f"{k} {a:.3f} / {b:.3f}" for k, (a, b) in times.items()), flush=True)
    finally:
        backend.teardown()

    # (b) and (c): one fleet of two gloo ranks sharing the card
    x = torch.randn((PIPE_MICRO, PIPE_MB, 256, 2304),
                    generator=torch.Generator(device="cuda").manual_seed(1), device="cuda",
                    dtype=torch.float32).to(torch.bfloat16)
    job = [{"kind": "sharded", "mesh": ((2,), ("data",)), "samplers": names,
            "gcfg": dataclasses.asdict(cfg), "inputs": [(V.cpu(), G.cpu(), scores.cpu())] * 2},
           {"kind": "pipeline", "mesh": ((2,), ("pod",)), "axis": "pod", "layer": "blocks",
            "arch": "minicpm-2b", "layers": SHARDED_LAYERS, "per_stage": PIPE_PER_STAGE,
            "seed": 0, "x": x.cpu()}]
    job[0]["gcfg"]["rset"] = tuple(job[0]["gcfg"]["rset"])
    work = tempfile.mkdtemp(prefix="sharded.", dir=os.path.join(ROOT, "build"))
    torch.save(job, os.path.join(work, "job.pt"))
    port = fleet.free_port()
    t1 = time.perf_counter()
    ranks = fleet.launch([fleet.mesh_worker_command(
        os.path.join(work, "job.pt"), os.path.join(work, "out"),
        fleet.backend_overrides(2, r, port)) for r in (0, 1)], timeout=300)
    wall = time.perf_counter() - t1
    res = [torch.load(r.last_json()["path"], weights_only=True) for r in ranks]
    assert [r["collectives"] for r in res] == ["gloo", "gloo"], [r["collectives"] for r in res]

    # (b) the sharded engine: launches, the ranks against each other and
    # against the per-shard pieces
    gaps, ms = {}, {}
    for name in names:
        key = f"{name}/0"
        calls = [r["tasks"][0]["calls"][key] for r in res]
        want_counts = {k: v for k, v in launch_audit.expected_sharded_launches(
            cfg, name).items() if v}
        for rank, call in enumerate(calls):
            assert call["counters"] == want_counts, \
                f"(b) {name} rank {rank}: launches {call['counters']}, reckoned {want_counts}"
        for f, v in calls[0]["state"].items():
            assert torch.equal(calls[1]["state"][f], v), f"(b) {name}: the ranks differ in {f}"
        want, wcarry = _sharded_reference(cfg, name, V, G, scores, 2)
        gaps[name] = _sharded_agree(f"(b) {name}", {**calls[0]["state"], "carry": calls[0]["carry"]},
                                    {**want, "carry": wcarry})
        # the second call, on the same rows, is the steady one
        ms[name] = [round(r["tasks"][0]["calls"][f"{name}/1"]["seconds"] * 1e3, 3) for r in res]
        for rank, r in enumerate(res):
            assert r["tasks"][0]["calls"][f"{name}/1"]["counters"] == want_counts, \
                f"(b) {name} rank {rank}: launches of the second call"
    print(f"[sharded] (b) {smi}: 2 gloo ranks on one card, 16 rows each of V {tuple(V.shape)}: "
          f"fleet wall {wall:.1f} s; states bit-equal across the ranks; pivots and rank equal "
          f"to the per-shard pieces, the largest relative gap of weights, error and alignment "
          + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items())
          + "; host ms of a second call (rank 0, rank 1): "
          + ", ".join(f"{k} {v}" for k, v in ms.items()), flush=True)

    # (c) the pipeline against the 8 blocks run here one microbatch at a time
    pipe = [r["tasks"][1] for r in res]
    assert torch.equal(pipe[0]["y"], pipe[1]["y"]), "(c) the ranks return different outputs"
    ticks = 2 + PIPE_MICRO - 1
    for rank, p in enumerate(pipe):
        flash = p["counters"].get("flash_forward", 0)
        assert flash == ticks * PIPE_PER_STAGE, \
            f"(c) rank {rank}: {flash} flash forwards, reckoned {ticks * PIPE_PER_STAGE}"
    _, _, blocks, mcfg = fleet.block_stages("minicpm-2b", SHARDED_LAYERS, PIPE_PER_STAGE, 0,
                                            torch.device("cuda"), 256)
    from repro_torch.models import model as model_lib
    positions = torch.arange(256, dtype=torch.int32, device="cuda").expand(PIPE_MB, 256)
    with torch.no_grad():
        ref = []
        for m in range(PIPE_MICRO):
            h = x[m]
            for blk in blocks:
                h, _ = model_lib._apply_block(mcfg, blk, h, positions, False)
            ref.append(h)
        ref = torch.stack(ref).cpu()
    y = pipe[0]["y"]
    assert torch.isfinite(y.float()).all(), "(c) non-finite outputs"
    gap = float((y.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    print(f"[sharded] (c) {smi}: pipeline of 2 stages x {PIPE_PER_STAGE} minicpm-2b blocks, "
          f"M {PIPE_MICRO} microbatches of {tuple(x.shape[1:])} bf16: "
          f"{'bit-equal' if torch.equal(y, ref) else f'max gap {gap:.3g} of max {scale:.3g}'} "
          f"to the 8 blocks run here; flash forwards a rank "
          f"{[p['counters'].get('flash_forward', 0) for p in pipe]} ({ticks} ticks x "
          f"{PIPE_PER_STAGE}); bubble {pipeline_bubble_fraction(2, PIPE_MICRO)}; tick ms "
          f"rank 0 {[round(t * 1e3, 2) for t in pipe[0]['tick_s']]}, rank 1 "
          f"{[round(t * 1e3, 2) for t in pipe[1]['tick_s']]}; point-to-point host ms rank 0 "
          f"{[round(t * 1e3, 2) for t in pipe[0]['p2p_s']]}, rank 1 "
          f"{[round(t * 1e3, 2) for t in pipe[1]['p2p_s']]}; forward "
          f"{[round(p['seconds'] * 1e3, 1) for p in pipe]} ms", flush=True)
    assert torch.equal(y, ref), f"(c) pipeline output differs from the sequential blocks by {gap}"
    shutil.rmtree(work, ignore_errors=True)


DRYRUN_BUDGET_S = 90.0       # the whole phase, the two real steps included
DRYRUN_JOBS = 7              # cells traced at once (the host has 8 cores)
DRYRUN_PEAK_RTOL = 0.10
# the cells that must trace in the phase: the slice's and rwkv_slice's
# configurations at train_4k, both variants, on one device and on the pod;
# then the dense archs' decode_32k cells on the pod, whose cache splits its
# positions over "model" under ``default`` and must fit one device
DRYRUN_DECODE_REQUIRED = tuple((arch, "decode_32k", "serve", "single") for arch in
                               ("minicpm-2b", "qwen1.5-32b", "stablelm-12b", "gemma2-27b"))
DRYRUN_REQUIRED = tuple((arch, "train_4k", v, m) for m in ("one", "single")
                        for arch in ("minicpm-2b", "rwkv6-7b")
                        for v in ("graft", "baseline")) + DRYRUN_DECODE_REQUIRED


def _dryrun_against_a_real_step(tag, overrides):
    """One step of ``overrides`` (a refresh step) on fake cuda:0 tensors,
    then the same step for real through ``Trainer``: predicted peak vs
    ``max_memory_allocated`` (this 1-step fit's, and the 6-step phase's
    when it ran), aten FLOPs vs ``FlopCounterMode`` over the real step, and
    launches vs ``launch_audit.expected_launches`` for one step."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.api import ExperimentConfig, Trainer
    from repro_torch.launch import dryrun, specs
    cfg = ExperimentConfig().apply_overrides(list(overrides) + ["train.steps=1"])
    mcfg = cfg.model.build()
    t0 = time.perf_counter()
    cell = specs.experiment_cell(cfg)
    assert cell.device.type == "cuda" and not cell.as_card, (cell.device, cell.as_card)
    res = dryrun.trace(cell)
    trace_s = time.perf_counter() - t0
    del cell
    fake = {k: row["launches"] for k, row in res["kernels"].items()}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    with FlopCounterMode(display=False) as counter:
        trainer = Trainer(cfg)
        trainer.fit()
    real_peak = torch.cuda.max_memory_allocated()
    real = {k: v for k, v in _read_counts().items() if v}
    expected = {k: v for k, v in _expected_launches(
        mcfg, cfg, _optim_groups(trainer.state["params"])).items() if v}
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    pred = res["memory"]["peak_bytes"]
    rel = (pred - real_peak) / real_peak
    print(f"[dryrun] {tag}: traced in {trace_s:.1f} s on fake cuda:0 tensors; predicted peak "
          f"{pred / 1e9:.3f} GB (args {res['memory']['argument_size_in_bytes'] / 1e9:.3f} GB) vs "
          f"max_memory_allocated {real_peak / 1e9:.3f} GB over the 1-step fit ({rel:+.2%}; "
          f"rtol {DRYRUN_PEAK_RTOL})", flush=True)
    return res, real_peak, counter.get_total_flops(), fake, real, expected


def phase_dryrun(ctx):
    """The dry run (``repro_torch.launch.dryrun``) held to the card: the
    slice's and rwkv_slice's configurations traced on fake cuda:0 tensors
    against their real steps (peak within 10 %, aten FLOPs equal, launches
    as reckoned), then every supported cell on one device and on one device
    of the production mesh (16, 16) in a pool of worker processes until the
    phase's budget: ``DRYRUN_REQUIRED`` first, each of which must trace
    (the dense decode_32k cells sharded and fitting), then the others
    cheapest first; a cell left out for time is named."""
    import torch
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    rows = {"device": ctx.get("smi"), "checks": {}, "cells": [], "left_out": []}
    for tag, overrides in (("slice", SLICE_OVERRIDES), ("rwkv_slice", _rwkv_slice_overrides())):
        res, real_peak, real_flops, fake, real, expected = \
            _dryrun_against_a_real_step(tag, overrides)
        pred = res["memory"]["peak_bytes"]
        phase_peak = ctx.get("peaks", {}).get(tag)
        if phase_peak:
            print(f"[dryrun] {tag}: phase {tag}'s 6-step fit peaked at {phase_peak / 1e9:.3f} GB "
                  f"({(pred - phase_peak) / phase_peak:+.2%})", flush=True)
        print(f"[dryrun] {tag}: aten FLOPs fake {res['aten_flops']:.0f} vs FlopCounterMode over "
              f"the real step {real_flops:.0f}; kernel FLOPs {res['kernel_flops']:.0f}, "
              f"bytes {res['bytes_accessed']:.0f}", flush=True)
        print(f"[dryrun] {tag}: launches fake {fake}, real {real}, expected {expected}",
              flush=True)
        rows["checks"][tag] = {"predicted_peak": pred, "real_peak": real_peak,
                               "phase_peak": phase_peak, "aten_flops": res["aten_flops"],
                               "real_flops": real_flops, "kernel_flops": res["kernel_flops"],
                               "bytes": res["bytes_accessed"], "launches": fake}
        assert abs(pred - real_peak) <= DRYRUN_PEAK_RTOL * real_peak, f"{tag}: peak"
        assert res["aten_flops"] == real_flops, f"{tag}: aten FLOPs"
        assert fake == expected == real, f"{tag}: launches"
    rest = [c + (m,) for m in ("one", "single") for c in dryrun.cells()]
    assert set(DRYRUN_REQUIRED) <= set(rest), "a required cell is not a supported cell"
    todo = list(DRYRUN_REQUIRED) + dryrun.sweep_order([c for c in rest
                                                       if c not in DRYRUN_REQUIRED])
    left_s = DRYRUN_BUDGET_S - (time.perf_counter() - t0)
    results, left = dryrun.sweep(todo, DRYRUN_JOBS, max(left_s, 0.0), device="cuda:0")
    print(f"[dryrun] {torch.cuda.get_device_name(0)}, {ctx.get('smi')}: {len(results)} of "
          f"{len(todo)} cells traced in {DRYRUN_JOBS} worker processes", flush=True)
    for res in results:
        print(f"[dryrun] {dryrun.summary(res)}", flush=True)
    for arch, shape, v, mesh_kind in left:
        print(f"[dryrun] LEFT OUT {arch} {shape} {mesh_kind} {v}: past the phase's "
              f"{DRYRUN_BUDGET_S:.0f} s budget", flush=True)
    rows["cells"], rows["left_out"] = results, left
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke_dryrun.json"), "w") as f:
        json.dump(rows, f, indent=1)
    failed = [r for r in results if not r.get("ok")]
    for r in failed:
        print(r["error"], file=sys.stderr)
    assert not failed, f"{len(failed)} cells failed"
    traced = {(r["arch"], r["shape"], r["variant"], r["mesh"]) for r in results}
    missing = [c for c in DRYRUN_REQUIRED if c not in traced]
    assert not missing, f"required cells not traced in the budget: {missing}"
    by_cell = {(r["arch"], r["shape"], r["variant"], r["mesh"]): r for r in results}
    for cell in DRYRUN_DECODE_REQUIRED:
        res = by_cell[cell]
        assert res["state"] == "sharded", (cell, res["state"])
        assert res["full"]["memory"]["fits"], (
            f"{cell}: peak {res['full']['memory']['peak_bytes'] / 1e9:.1f} GB")


FSDP_BUDGET_S = 60.0          # (a)'s pool of dry-run cells, which runs beside (b) and (c)
FSDP_JOBS = 4                 # (a)'s workers: the host's other 4 cores run (c)'s ranks
FSDP_REQUIRED = ("minicpm-2b", "qwen1.5-32b")
FSDP_LAYERS = 2               # (c): phase shell's cut
# a refresh step and a subset step (cut, with the pools' budgets, to keep
# the script within its time beside phase tp_families)
FSDP_STEPS = 2
# each leaf of step 0's gradient (relative Frobenius norm) against the
# same step split as the ranks split it, in one process: the two differ
# in the order gloo sums the parts and the bfloat16 rounding of the
# clipped gradient (a few ulps, 2^-8 each, at most); a wrong gradient (a
# scale, a rank's rows missing, a shard misplaced) is off by a quarter or
# more
FSDP_M0_RTOL = 2e-2
FSDP_MESH = ((2, 2), ("data", "model"))
FSDP_OVERRIDES = ([o for o in SLICE_OVERRIDES if not o.startswith(("model.overrides",
                                                                    "train.steps"))]
                  + [f'model.overrides={{"attn_backend": "auto", "num_layers": {FSDP_LAYERS}}}',
                     f"train.steps={FSDP_STEPS}", "train.log_every=0"])


def _fsdp_sweep(box, preset="fsdp", archs=None, required=None):
    """(a), run in a thread: ``preset``'s train_4k graft cells of ``archs``
    (the non-MoE archs) on the (16, 16) pod, the ``required`` ones
    (``FSDP_REQUIRED``) first; ``box`` gets (results, cells left out) or
    the error."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    required = FSDP_REQUIRED if required is None else required
    try:
        if archs is None:
            archs = [a for a in configs.CANONICAL_IDS if configs.get_config(a).family != "moe"]
        rest = dryrun.sweep_order([(a, "train_4k", "graft", "single") for a in archs
                                   if a not in required])
        todo = [(a, "train_4k", "graft", "single") for a in required] + rest
        box["cells"] = dryrun.sweep(todo, FSDP_JOBS, FSDP_BUDGET_S, device="cuda:0",
                                    rules_preset=preset)
    except BaseException as e:                      # noqa: BLE001 — raised by _fsdp_cells
        box["error"] = e


def _fsdp_cells(box, smi, preset="fsdp", required=None):
    """(a)'s results: printed, the required cells held to trace and fit."""
    from repro_torch.launch import dryrun
    tag = {"fsdp": "fsdp", "default": "tp"}[preset]
    required = FSDP_REQUIRED if required is None else required
    if "error" in box:
        raise box["error"]
    results, left = box["cells"]
    for res in results:
        print(f"[{tag}] {dryrun.summary(res)}", flush=True)
        if res.get("ok"):
            coll = res["full"]["collectives"]
            print(f"[{tag}] {smi}: {res['arch']} {preset}: state {res['state']}, peak "
                  f"{res['full']['memory']['peak_bytes'] / 1e9:.3f} GB (fits 80 GB: "
                  f"{res['full']['memory']['fits']}), {res['full']['flops'] / 1e12:.2f} TFLOP, "
                  f"args {res['argument_bytes_per_device'] / 1e9:.3f} GB a device, collective "
                  f"bytes { {k: v for k, v in coll['bytes_by_op'].items() if v} }, counts "
                  f"{ {k: v for k, v in coll['count_by_op'].items() if v} }, kernel launches "
                  f"{ {k: r['launches'] for k, r in res['full']['kernels'].items()} }",
                  flush=True)
        else:
            print(res["error"], file=sys.stderr)
    for arch, shape, v, mesh_kind in left:
        print(f"[{tag}] LEFT OUT {arch} {shape} {mesh_kind} {v} {preset}: past the phase's "
              f"{FSDP_BUDGET_S:.0f} s budget", flush=True)
    print(f"[{tag}] (a) {smi}: {len(results)} {preset} cells traced in {FSDP_JOBS} worker "
          f"processes", flush=True)
    by_arch = {r["arch"]: r for r in results}
    for arch in required:
        res = by_arch.get(arch)
        assert res is not None, f"{arch}'s {preset} cell not traced in the budget"
        assert res.get("ok"), f"{arch}'s {preset} cell failed"
        assert res["state"] == "sharded", res["state"]
        assert res["full"]["memory"]["fits"], (
            f"{arch}'s {preset} cell peaks at "
            f"{res['full']['memory']['peak_bytes'] / 1e9:.1f} GB")
    failed = [r["arch"] for r in results if not r.get("ok")]
    assert not failed, f"{preset} cells failed: {failed}"


def _fsdp_prediction(cfg, preset="fsdp"):
    """(b): one device's refresh step of the (2, 2) fleet on fake cuda:0
    tensors: 4 rows under fsdp (the batch over both axes), 8 under default
    (over data, each rank half of the positions)."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(*FSDP_MESH)
    backend = dryrun.RecordingBackend(mesh.size)
    cell = specs.experiment_cell(cfg, mesh=dryrun.RecordingMesh(mesh, backend),
                                 rules=dict(sh.DEFAULT_RULES, **specs.RULE_PRESETS[preset]),
                                 backend=backend)
    assert cell.device.type == "cuda" and not cell.as_card
    assert cell.batch == {"fsdp": 4, "default": 8}[preset], cell.batch
    return dryrun.trace(cell, backend)


def _tree_paths(tree, prefix=""):
    """The '/'-joined path of each leaf of nested dicts and lists, in
    ``models.model._leaves``' order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _tree_paths(v, f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in _tree_paths(v, f"{prefix}{i}/")]
    return [prefix.rstrip("/")]


def _fsdp_reference(mcfg, tcfg, batches, seed, parts=None, n_steps=None, max_leaf_bytes=None):
    """(c)'s configuration in this process, unsharded: losses, grad norms,
    ranks, pivots, step 0's first moment as the fleet computes it
    (``m0``, ``_split_first_moment``; with ``parts`` 1 the state's own;
    none under Adafactor) and the final parameters (on the host), over
    ``n_steps`` steps (``FSDP_STEPS``); each leaf cut to its leading rows
    over ``max_leaf_bytes`` (``models/model.py`` ``values_tree``)."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import model as model_lib
    gen = torch.Generator(device="cuda").manual_seed(seed)
    state = steps.state_for_model(mcfg, tcfg, model_lib.init_params(mcfg, gen, "cuda"),
                                  batches[0]["labels"].shape[0])
    # the unsplit step's first moment is the state's own (no copy of the
    # weights: a MoE layer's would not fit beside the state)
    init = [p.detach().clone() for p in state["params"]] if parts != 1 else None
    fn = steps.make_train_step(mcfg, tcfg)
    out = {"losses": [], "grad_norms": [], "ranks": [], "pivots": {}}
    for i in range(n_steps or FSDP_STEPS):
        batch = {k: v.to("cuda") for k, v in batches[i % len(batches)].items()}
        state, m = fn(state, batch)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        out["ranks"].append(int(m["rank"]))
        if i == 0:
            if "m" in state["opt"] and parts == 1:
                out["m0"] = model_lib._map_tree(
                    lambda t: t.detach().to("cpu", copy=True),
                    model_lib.values_tree(state["model"], state["opt"]["m"], max_leaf_bytes))
            elif "m" in state["opt"]:
                out["m0"] = _split_first_moment(mcfg, tcfg, init, batch, state["graft"],
                                                parts or math.prod(FSDP_MESH[0]))
            del init
        if i % tcfg.graft.refresh_every == 0:
            out["pivots"][i] = state["graft"].pivots.tolist()
    out["params"] = model_lib._map_tree(
        lambda t: t.detach().to("cpu", copy=True),
        model_lib.values_tree(state["model"], list(state["model"].parameters()), max_leaf_bytes))
    return out


def _split_first_moment(mcfg, tcfg, init, batch, graft_state, parts):
    """Step 0's first moment ``(1 - beta1) · clip · grad`` in this process,
    computed as the fleet's ranks compute it but with no mesh: the same
    weights, batch and selected subset, the subset's rows split into
    ``parts`` in rank order, each part's gradient in the model's dtype, the
    parts summed in rank order, the clip from the sum's norm (host tensors
    in the parameter tree's layout). The split matters: on an H100,
    final_norm's gradient from 4 parts lies 0.137 from float32's, from the
    whole subset 0.014, whether the parts are summed in bfloat16 or in
    float32 (``tools/fsdp_split_gaps.py``)."""
    import types
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import model as model_lib
    model = model_lib.Model(mcfg, "cuda")
    params = list(model.parameters())
    with torch.no_grad():
        for p, q in zip(params, init):
            p.copy_(q)
    total = None
    for r in range(parts):
        rows = types.SimpleNamespace(process_index=r, process_count=parts,
                                     all_gather_rows=lambda x: x)
        loss = steps.subset_loss(mcfg, {"model": model}, batch, graft_state, rows)
        grads = steps.param_grads(loss, params)
        total = list(grads) if total is None else [a + g for a, g in zip(total, grads)]
    norm = float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in total)))
    opt = tcfg.optimizer
    clip = min(1.0, opt.clip_norm / (norm + 1e-9)) if opt.clip_norm else 1.0
    return model_lib.values_tree(model, [((1 - opt.beta1) * clip * g.float()).cpu()
                                         for g in total])


def phase_fsdp(ctx):
    """Parameter sharding under the fsdp preset: (a) the dry run's fsdp
    train_4k cells on the (16, 16) pod; (b) its prediction for (c); (c) four
    gloo ranks sharing the card on a (2, 2) mesh, minicpm-2b at full width
    and 2 layers, held to the same configuration in this process, to (b)'s
    peak, to exact resident bytes and to the reckoned launches. (a) runs in
    a thread beside (b) and (c): its workers trace on the host's cores while
    the ranks wait on gloo."""
    import torch
    ctx.pop("trainer", None)
    gc.collect()
    torch.cuda.empty_cache()
    smi = ctx.get("smi", "")
    box = {}
    sweep = threading.Thread(target=_fsdp_sweep, args=(box,))
    sweep.start()
    try:
        _fsdp_fleet(smi)
    finally:
        sweep.join()
    _fsdp_cells(box, smi)


def _fsdp_fleet(smi, preset="fsdp"):
    """(b) and (c), under ``preset``: "fsdp" (phase fsdp: each rank 4 of the
    16 rows) or "default" (phase tp: each rank 8 rows' half of the
    positions)."""
    import tempfile
    import torch
    from repro_torch import configs
    from repro_torch.api import ExperimentConfig
    from repro_torch.backend import fleet
    from repro_torch.models import model as model_lib
    cfg = ExperimentConfig().apply_overrides(FSDP_OVERRIDES)
    mcfg, tcfg, data = cfg.build()
    model_over = {"attn_backend": "auto", "num_layers": FSDP_LAYERS}
    assert mcfg == configs.get_config("minicpm-2b", **model_over), "the fleet's config differs"
    t1 = time.perf_counter()
    tag = {"fsdp": "fsdp", "default": "tp"}[preset]
    pred = _fsdp_prediction(cfg, preset)
    print(f"[{tag}] (b) the (2, 2) fleet's device, traced in {time.perf_counter() - t1:.1f} s: "
          f"peak {pred['memory']['peak_bytes'] / 1e9:.3f} GB, args "
          f"{pred['memory']['argument_size_in_bytes'] / 1e9:.3f} GB, collectives "
          f"{ {k: v for k, v in pred['collectives']['bytes_by_op'].items() if v} }, launches "
          f"{ {k: r['launches'] for k, r in pred['kernels'].items()} }", flush=True)

    batches = [{k: torch.from_numpy(v) for k, v in data.batch_at(i).items()}
               for i in range(FSDP_STEPS)]
    t1 = time.perf_counter()
    # the subset's rows split as the fleet splits them: over both axes
    # under fsdp, over data alone under default
    parts = {"fsdp": 4, "default": 2}[preset]
    ref = _fsdp_reference(mcfg, tcfg, batches, seed=0, parts=parts)
    ref_s = time.perf_counter() - t1
    gc.collect()
    torch.cuda.empty_cache()
    t_cfg = dataclasses.asdict(tcfg)
    task = {"kind": {"fsdp": "fsdp", "default": "tp"}[preset], "mesh": FSDP_MESH, "arch": "minicpm-2b", "model": model_over,
            "seed": 0, "steps": FSDP_STEPS, "batches": batches,
            "tcfg": {k: v for k, v in t_cfg.items()}}
    work = tempfile.mkdtemp(prefix=f"{tag}.", dir=os.path.join(ROOT, "build"))
    try:
        torch.save([task], os.path.join(work, "job.pt"))
        port = fleet.free_port()
        t1 = time.perf_counter()
        runs = fleet.launch([fleet.mesh_worker_command(
            os.path.join(work, "job.pt"), os.path.join(work, "out"),
            fleet.backend_overrides(4, r, port)) for r in range(4)], timeout=400)
        wall = time.perf_counter() - t1
        summaries = [r.last_json() for r in runs]
        ranks = [torch.load(s["path"], weights_only=True) for s in summaries]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    pred_peak = pred["memory"]["peak_bytes"]
    for r in ranks:
        assert r["collectives"] == "gloo" and r["device"].startswith("cuda"), \
            (r["collectives"], r["device"])
        got = r["tasks"][0]
        rel_peak = (pred_peak - got["peak_bytes"]) / got["peak_bytes"]
        want = {k: v for k, v in got["launches_expected"].items() if v}
        print(f"[{tag}] (c) {smi}: rank {r['rank']}: losses {got['losses']}, ranks {got['ranks']}, "
              f"step ms {[round(x * 1e3, 1) for x in got['step_s']]}, resident "
              f"{got['resident_bytes']} B (shards {got['shard_bytes']} B), max_memory_allocated "
              f"{got['peak_bytes'] / 1e9:.3f} GB (prediction {rel_peak:+.2%}), launches "
              f"{got['launches']}, layout {got['layout']}", flush=True)
        assert got["resident_bytes"] == got["shard_bytes"], "resident state is not its shards"
        assert abs(pred_peak - got["peak_bytes"]) <= DRYRUN_PEAK_RTOL * got["peak_bytes"], \
            f"rank {r['rank']}: peak {got['peak_bytes']} vs predicted {pred_peak}"
        assert got["launches"] == want, f"rank {r['rank']}: launches {got['launches']} vs {want}"
        if preset == "default":     # the sequence and the MLP over "model", the logits whole
            assert got["layout"] == {"seq": ["model"], "mlp": ["model"], "vocab": []}, \
                got["layout"]
        for name in ("graft_select", "flash_forward", "flash_dq", "flash_dkv", "grad_norm",
                     "optimizer_update"):
            assert want.get(name), f"{name} is not on the sharded path"
        assert got["ranks"] == ref["ranks"], (got["ranks"], ref["ranks"])
        assert {int(k): v for k, v in got["pivots"].items()} == ref["pivots"], \
            (got["pivots"], ref["pivots"])
        rel = [abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])]
        assert max(rel) <= 3e-3, f"rank {r['rank']}: losses {got['losses']} vs {ref['losses']}"
        rel = [abs(a - b) / abs(b) for a, b in zip(got["grad_norms"], ref["grad_norms"])]
        assert max(rel) <= 3e-3, \
            f"rank {r['rank']}: grad norms {got['grad_norms']} vs {ref['grad_norms']}"
    # step 0's gradient leaf by leaf, through AdamW's first moment (0.1 times
    # the clipped gradient; AdamW's update hides a gradient's scale, and a
    # small leaf, a norm scale, barely moves the global norm), against the
    # same split computed in this process; then the gathered final
    # parameters as a whole (AdamW moves an element by about lr whatever
    # its gradient's size, so a near-0 gradient's rounding can flip a step:
    # the zero-initialised norm scales show it most)
    gaps, _ = _leaf_gaps(ranks[0]["tasks"][0]["m0"], ref["m0"])
    _, whole = _leaf_gaps(ranks[0]["tasks"][0]["params"], ref["params"])
    rel_norm = [abs(a - b) / abs(b) for a, b in zip(ranks[0]["tasks"][0]["grad_norms"],
                                                     ref["grad_norms"])]
    furthest = sorted(gaps, key=gaps.get, reverse=True)
    print(f"[{tag}] (c) {smi}: fleet wall {wall:.1f} s "
          f"(the one-process run {ref_s:.1f} s); losses {ref['losses']} in one process; "
          f"pivots {ref['pivots']} equal; grad norm relative "
          f"{[f'{x:.3g}' for x in rel_norm]}; step 0's first moment vs its split in one "
          f"process, the leaves furthest apart {[(p, round(gaps[p], 6)) for p in furthest[:6]]} "
          f"(bar {FSDP_M0_RTOL}); gathered final parameters {whole:.3g} relative to one "
          f"process in all", flush=True)
    bad = [(p, gaps[p]) for p in furthest if not gaps[p] <= FSDP_M0_RTOL]
    assert not bad, f"step 0's gradients differ from their split in one process: {bad}"
    assert whole <= 3e-3, f"final parameters differ by {whole:.3g}"


TP_REQUIRED = ("minicpm-2b", "qwen1.5-32b")
TP_ARCHS = ("minicpm-2b", "qwen1.5-32b", "stablelm-12b", "gemma2-27b")
# (d): (name, B, H, Hkv, T, Dh, dtype, window, softcap, parts): each q
# stream's T positions cut into ``parts`` slices, each run with its query
# offset against the whole K/V. "slice" is phase flash's 576 streams
TP_OFFSET_SHAPES = [
    ("slice", 16, 36, 36, 256, 64, "bfloat16", None, None, 2),
    ("slice", 16, 36, 36, 256, 64, "bfloat16", None, None, 16),
    ("minicpm_4096", 1, 36, 36, 4096, 64, "bfloat16", None, None, 16),
    ("gemma2_27b", 1, 32, 16, 8192, 128, "bfloat16", 4096, 50.0, 2),
    ("gemma2_27b", 1, 32, 16, 8192, 128, "bfloat16", 4096, 50.0, 16),
    ("f32_gqa2_window", 2, 8, 4, 512, 64, "float32", 128, 30.0, 2),
    ("f32_gqa2_window", 2, 8, 4, 512, 64, "float32", 128, 30.0, 16),
    ("f32_dh128", 1, 4, 4, 1024, 128, "float32", None, None, 16),
]
# the forward and dQ kernels' q tile (bf16 64 rows; float32 64, or 32 above
# Dh 128): a slice of whole tiles walks the same KV tiles as the whole
# sequence's launch does for those rows, so its rows are bit-equal
TP_TILE_ROWS = 64


def _offset_check(name, B, H, Hkv, T, Dh, dtype, window, softcap, parts, smi):
    """(d) for one shape: each slice's forward, dQ and dK/dV against the
    plain versions with the same offset (phase flash's tolerances), the
    forward and dQ rows against the whole sequence's launch."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    group = H // Hkv
    q, k, v, do = _flash_inputs(B, H, Hkv, T, Dh, dtype, seed=5)
    kw = dict(causal=True, window=window, softcap=softcap, group=group)
    o, lse = fa.flash_forward(q, k, v, **kw)
    delta = (o.float() * do.float()).sum(-1)
    dq = fa.flash_dq(q, k, v, do, lse, delta, **kw)
    n = T // parts
    errs = {"o": 0.0, "lse": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0}
    rows_equal = True
    for i in range(parts):
        rows = slice(i * n, (i + 1) * n)
        qi, doi = q[:, rows].contiguous(), do[:, rows].contiguous()
        opt = dict(kw, q_offset=i * n)
        oi, lsei = fa.flash_forward(qi, k, v, **opt)
        di = (oi.float() * doi.float()).sum(-1)
        dqi = fa.flash_dq(qi, k, v, doi, lsei, di, **opt)
        dki, dvi = fa.flash_dkv(qi, k, v, doi, lsei, di, **opt)
        plain = {key: val for key, val in opt.items() if key != "group"}
        ref_o, ref_lse = _flash_plain(fa.flash_forward_reference, qi, k, v, None, None, None,
                                      group, plain)
        ref_dq = _flash_plain(fa.flash_dq_reference, qi, k, v, doi, lsei, di, group, plain)
        ref_dk, ref_dv = _flash_plain(fa.flash_dkv_reference, qi, k, v, doi, lsei, di, group,
                                      plain)
        for what, a, b in (("o", oi, ref_o), ("dq", dqi, ref_dq), ("dk", dki, ref_dk),
                           ("dv", dvi, ref_dv)):
            scale = b.float().abs().max().item()
            tol = 2.0 ** -7 * scale if dtype == "bfloat16" else 1e-4 * scale + 1e-6
            err = (a.float() - b.float()).abs().max().item()
            errs[what] = max(errs[what], err)
            assert err <= tol and a.dtype == b.dtype, \
                f"{name} parts {parts} slice {i}: {what} differs by {err:.3g} (tol {tol:.3g})"
        fin = torch.isfinite(ref_lse)
        assert torch.equal(fin, torch.isfinite(lsei))
        errs["lse"] = max(errs["lse"], (lsei[fin] - ref_lse[fin]).abs().max().item())
        assert errs["lse"] <= 1e-4, f"{name} slice {i}: lse differs by {errs['lse']:.3g}"
        if n % TP_TILE_ROWS == 0:
            rows_equal = rows_equal and torch.equal(oi, o[:, rows]) and \
                torch.equal(lsei, lse[:, rows]) and torch.equal(dqi, dq[:, rows])
        del oi, lsei, dqi, dki, dvi, ref_o, ref_lse, ref_dq, ref_dk, ref_dv
    print(f"[tp] (d) {smi}: {name} B={B} H={H} Hkv={Hkv} T={T} Dh={Dh} {dtype} "
          f"window={window} softcap={softcap}, {parts} slices of {n} positions: max|diff| vs "
          f"the plain versions " + ", ".join(f"{key} {e:.3g}" for key, e in errs.items())
          + (f"; forward and dQ rows bit-equal to the whole sequence's launch: {rows_equal}"
             if n % TP_TILE_ROWS == 0 else "") + " -> ok", flush=True)
    assert rows_equal, f"{name}: a slice's rows differ from the whole sequence's launch"
    times = None
    if name == "slice" and parts == 2:
        times = _offset_times(q, k, v, do, kw, parts, smi)
    del q, k, v, do, o, lse, delta, dq
    torch.cuda.empty_cache()
    return times


def _offset_times(q, k, v, do, kw, parts, smi):
    """The kernels on each slice (its query offset) beside the whole
    sequence, CUDA events, each beside its bound (``cost`` counts the pairs
    the offset leaves)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    BH, T, Dh = q.shape
    n = T // parts
    peak = BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else F32_FLOP_PER_S
    out = []
    for label, start, rows in [("whole", 0, T)] + [(f"slice {i}", i * n, n)
                                                   for i in range(parts)]:
        qi, doi = q[:, start:start + rows].contiguous(), do[:, start:start + rows].contiguous()
        opt = dict(kw, q_offset=start)
        oi, lsei = fa.flash_forward(qi, k, v, **opt)
        di = (oi.float() * doi.float()).sum(-1)
        t = {"fwd": _time_auto(lambda: fa.flash_forward(qi, k, v, **opt)),
             "dq": _time_auto(lambda: fa.flash_dq(qi, k, v, doi, lsei, di, **opt)),
             "dkv": _time_auto(lambda: fa.flash_dkv(qi, k, v, doi, lsei, di, **opt))}
        for kind, ms in t.items():
            b_ms, b_by, nbytes, flops = _cost_bound(fa.cost(
                kind, BH, k.shape[0], rows, T, Dh, q.dtype, True, kw["window"], start), peak)
            print(f"[tp] (d) {smi}: slice shape {label} (Sq {rows}, q_offset {start}) {kind}: "
                  f"kernel {ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} ({nbytes} bytes, "
                  f"{flops} flop), {ms / b_ms:.1f}x the bound", flush=True)
            out.append({"slice": label, "q_offset": start, "Sq": rows, "kind": kind, "ms": ms,
                        "bound_ms": b_ms, "bound_by": b_by})
    return out


def phase_tp(ctx):
    """JAX's ``default`` preset on the dense family: (a) the dry run's
    default train_4k cells on the (16, 16) pod in a thread, beside (b) its
    prediction for (c) and (c) four gloo ranks sharing the card under the
    preset, held to one process; then (d) the flash kernels' query offset
    against their plain versions, and timed."""
    import torch
    ctx.pop("trainer", None)
    gc.collect()
    torch.cuda.empty_cache()
    smi = ctx.get("smi", "")
    box = {}
    sweep = threading.Thread(target=_fsdp_sweep, args=(box, "default", TP_ARCHS, TP_REQUIRED))
    sweep.start()
    try:
        _fsdp_fleet(smi, preset="default")
    finally:
        sweep.join()
    _fsdp_cells(box, smi, preset="default", required=TP_REQUIRED)
    rows = []
    for shape in TP_OFFSET_SHAPES:
        rows += _offset_check(*shape, smi) or []
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke_tp.json"), "w") as f:
        json.dump({"device": smi, "offset_times": rows}, f, indent=1)


MOE_EP_ARCH = "qwen3-moe-235b-a22b"
MOE_EP_LAYERS = 2             # phase families' cut
MOE_EP_STEPS = 1              # a refresh step: the selection forward and the subset's step
# two gloo ranks on a (1, 2) mesh: the experts split over "model" and no
# expert weight crosses gloo (a (2, 2) mesh would gather 4.8 GB a layer
# through host memory)
MOE_EP_MESH = ((1, 2), ("data", "model"))
# (tag, preset, overrides): (a) the default preset under AdamW with
# bfloat16 moments at phase families' batch; (b) fsdp under Adafactor at 6
# × 256 tokens (3 groups of 512) and a subset of 2 rows (1 group): neither
# count of groups divides over "model", so the experts split there too.
# A constant learning rate, so that the one step's update moves the
# parameters (the warmup's is 0 at step 0)
MOE_EP_TASKS = (("a", "default", ["optimizer.state_dtype=bfloat16",
                                  "optimizer.schedule=constant"]),
                ("b", "fsdp", ["optimizer.name=adafactor", "optimizer.schedule=constant",
                               "train.batch=6", "graft.rset=[1,2]"]))
# a leaf larger than this is reported, by rank 0 and by the one process,
# as its leading rows of at most this size (rank 0's shard's, cut the same
# way): gathered whole, the experts (1.6 GB a leaf), the embedding and
# lm_head would cross gloo and the host's disk for each check
MOE_EP_LEAF_BYTES = 64 << 20


def _moe_ep_config(extra):
    from repro_torch.api import ExperimentConfig
    over = {"attn_backend": "auto", "num_layers": MOE_EP_LAYERS}
    return ExperimentConfig().apply_overrides(
        [o for o in SLICE_OVERRIDES if not o.startswith(("model.overrides", "train.steps"))]
        + [f"model.arch={MOE_EP_ARCH}", f"model.overrides={json.dumps(over)}",
           f"train.steps={MOE_EP_STEPS}", "train.log_every=0"] + extra)


def _moe_ep_prediction(cfg, preset):
    """One rank's refresh step of the (1, 2) fleet on fake cuda:0 tensors."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(*MOE_EP_MESH)
    backend = dryrun.RecordingBackend(mesh.size)
    cell = specs.experiment_cell(cfg, mesh=dryrun.RecordingMesh(mesh, backend),
                                 rules=dict(sh.DEFAULT_RULES, **specs.RULE_PRESETS[preset]),
                                 backend=backend)
    return dryrun.trace(cell, backend)


def _leading_block(want, got):
    """Each leaf of ``want`` cut to ``got``'s leaf's shape from index 0 on
    every dim: rank 0's shard's block where the fleet reported one."""
    from repro_torch.models import model as model_lib
    return model_lib._zip_tree(lambda w, g: w[tuple(slice(0, n) for n in g.shape)], want, got)


def phase_moe_ep(ctx):
    """Expert parallelism: qwen3-moe-235b-a22b at full width, 2 layers, on
    two gloo ranks sharing the card on a (1, 2) ("data", "model") mesh, two
    tasks in one launch: (a) the default preset under AdamW with bfloat16
    moments, (b) fsdp under Adafactor at a batch whose groups do not divide
    over "model". Each is first run in this process (then freed), and
    traced by the dry run on fake cuda:0 tensors while the fleet runs; each
    rank is held to the one process (losses and grad norms at 3e-3, ranks and pivots equal;
    (a)'s step-0 first moment leaf by leaf, the router and the norms
    first, at ``FSDP_M0_RTOL``; the final parameters as a whole at 3e-3),
    to the prediction's peak (``DRYRUN_PEAK_RTOL``), to its shards'
    resident bytes, to ``expected_launches`` and to the regime its MoE
    forwards report (the experts over "model")."""
    import tempfile
    import torch
    from repro_torch import configs
    from repro_torch.backend import fleet
    ctx.pop("trainer", None)
    smi = ctx.get("smi", "")
    jobs, refs, preds, cfgs = [], {}, {}, {}
    for tag, preset, extra in MOE_EP_TASKS:
        gc.collect()
        torch.cuda.empty_cache()
        cfgs[tag] = cfg = _moe_ep_config(extra)
        mcfg, tcfg, data = cfg.build()
        batches = [{k: torch.from_numpy(v) for k, v in data.batch_at(i).items()}
                   for i in range(MOE_EP_STEPS)]
        t1 = time.perf_counter()
        refs[tag] = _fsdp_reference(mcfg, tcfg, batches, seed=0, parts=1,
                                    n_steps=MOE_EP_STEPS, max_leaf_bytes=MOE_EP_LEAF_BYTES)
        print(f"[moe_ep] ({tag}) {preset}, {tcfg.optimizer.name} ({cfg.optimizer.state_dtype} "
              f"state), {cfg.train.batch} x {cfg.train.seq}, rset {list(tcfg.graft.rset)}: "
              f"one process {time.perf_counter() - t1:.1f} s, losses {refs[tag]['losses']}, "
              f"grad norms {refs[tag]['grad_norms']}", flush=True)
        model_over = {"attn_backend": "auto", "num_layers": MOE_EP_LAYERS}
        assert mcfg == configs.get_config(MOE_EP_ARCH, **model_over), "the fleet's config differs"
        jobs.append({"kind": "tp", "preset": preset, "mesh": MOE_EP_MESH, "arch": MOE_EP_ARCH,
                     "model": model_over, "seed": 0, "steps": MOE_EP_STEPS,
                     "batches": batches, "max_leaf_bytes": MOE_EP_LEAF_BYTES,
                     "tcfg": dataclasses.asdict(tcfg)})
    gc.collect()
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="moe_ep.", dir=os.path.join(ROOT, "build"))
    box = {}

    def run_fleet():
        try:
            port = fleet.free_port()
            t1 = time.perf_counter()
            runs = fleet.launch([fleet.mesh_worker_command(
                os.path.join(work, "job.pt"), os.path.join(work, "out"),
                fleet.backend_overrides(2, r, port)) for r in range(2)], timeout=300)
            box["wall"] = time.perf_counter() - t1
            box["ranks"] = [torch.load(r.last_json()["path"], weights_only=True) for r in runs]
        except BaseException as e:                  # noqa: BLE001 — raised below
            box["error"] = e

    try:
        torch.save(jobs, os.path.join(work, "job.pt"))
        thread = threading.Thread(target=run_fleet)
        thread.start()
        try:
            for tag, preset, _ in MOE_EP_TASKS:     # the ranks' prediction, beside them
                t1 = time.perf_counter()
                preds[tag] = _moe_ep_prediction(cfgs[tag], preset)
                print(f"[moe_ep] ({tag}) prediction traced in {time.perf_counter() - t1:.1f} s: "
                      f"peak {preds[tag]['memory']['peak_bytes'] / 1e9:.3f} GB a rank, args "
                      f"{preds[tag]['memory']['argument_size_in_bytes'] / 1e9:.3f} GB, "
                      f"collectives { {k: v for k, v in preds[tag]['collectives']['bytes_by_op'].items() if v} }",
                      flush=True)
        finally:
            thread.join()
        if "error" in box:
            raise box["error"]
        wall, ranks = box["wall"], box["ranks"]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"[moe_ep] {smi}: the fleet's two tasks in {wall:.1f} s of wall", flush=True)
    for i, (tag, preset, _) in enumerate(MOE_EP_TASKS):
        ref, pred_peak = refs[tag], preds[tag]["memory"]["peak_bytes"]
        for r in ranks:
            assert r["collectives"] == "gloo" and r["device"].startswith("cuda")
            got = r["tasks"][i]
            want = {k: v for k, v in got["launches_expected"].items() if v}
            rel_peak = (pred_peak - got["peak_bytes"]) / got["peak_bytes"]
            print(f"[moe_ep] ({tag}) {smi}: rank {r['rank']}: losses {got['losses']}, grad "
                  f"norms {got['grad_norms']}, ranks {got['ranks']}, step ms "
                  f"{[round(x * 1e3, 1) for x in got['step_s']]}, resident "
                  f"{got['resident_bytes']} B (shards {got['shard_bytes']} B), "
                  f"max_memory_allocated {got['peak_bytes'] / 1e9:.3f} GB (prediction "
                  f"{rel_peak:+.2%}), launches {got['launches']}, layout {got['layout']}, "
                  f"moe {got['moe']}", flush=True)
            assert got["resident_bytes"] == got["shard_bytes"], "resident state is not its shards"
            assert abs(pred_peak - got["peak_bytes"]) <= DRYRUN_PEAK_RTOL * got["peak_bytes"], \
                f"({tag}) rank {r['rank']}: peak {got['peak_bytes']} vs predicted {pred_peak}"
            assert got["launches"] == want, f"({tag}) launches {got['launches']} vs {want}"
            for name in ("graft_select", "flash_forward", "flash_dq", "flash_dkv", "grad_norm"):
                assert want.get(name), f"{name} is not on the expert-parallel path"
            assert got["moe"] and all(e == ["model"] for _, _, e in got["moe"]), got["moe"]
            assert got["ranks"] == ref["ranks"], (got["ranks"], ref["ranks"])
            assert {int(k): v for k, v in got["pivots"].items()} == ref["pivots"]
            for key in ("losses", "grad_norms"):
                rel = max(abs(a - b) / abs(b) for a, b in zip(got[key], ref[key]))
                assert rel <= 3e-3, f"({tag}) rank {r['rank']}: {key} {got[key]} vs {ref[key]}"
        got0 = ranks[0]["tasks"][i]
        _, whole = _leaf_gaps(got0["params"], _leading_block(ref["params"], got0["params"]))
        line = f"[moe_ep] ({tag}) {smi}: final parameters {whole:.3g} relative to one process"
        if got0.get("m0") is not None:
            gaps, _ = _leaf_gaps(got0["m0"], _leading_block(ref["m0"], got0["m0"]))
            first = sorted(gaps, key=lambda p: ("router" not in p, "ln" not in p
                                                and "norm" not in p, p))
            line += (f"; step 0's first moment vs one process, the router and the norms "
                     f"first: {[(p, round(gaps[p], 6)) for p in first]} (bar {FSDP_M0_RTOL})")
            bad = [(p, gaps[p]) for p in first if not gaps[p] <= FSDP_M0_RTOL]
            assert not bad, f"({tag}) step 0's gradients differ from one process: {bad}"
        print(line, flush=True)
        assert whole <= 3e-3, f"({tag}) final parameters differ by {whole:.3g}"


TPF_LAYERS = 2                # phase families' cut
TPF_STEPS = 1                 # a refresh step: the selection forward and the subset's step
TPF_MESH = ((1, 2), ("data", "model"))
# (arch, rows, positions, model overrides): internvl2-26b's 768 positions
# are its 256 patches and 512 tokens, so that rank 0's 384 hold the patches
# and 128 tokens; rwkv6-7b's 64 heads give each rank 32. rwkv6-7b runs in
# float32: its bfloat16 gradient at random weights lies far from float32's
# in one process alone (the phase prints how far), so two bfloat16 runs
# that round apart cannot be held at 3e-3. hymba-1.5b's 1280 positions
# pass its window of 1024, which cuts in at rank 1's query offset 640 on
# the local layer; its 25 SSM heads do not divide 2 (the pod's branch:
# each rank runs them whole on the gathered sequence)
TPF_RUNS = (("rwkv6-7b", 8, 512, {"param_dtype": "float32"}), ("musicgen-medium", 8, 512, {}),
            ("internvl2-26b", 8, 768, {}), ("hymba-1.5b", 4, 1280, {}))
TPF_OVERRIDES = ["graft.rset=[2,4]", "optimizer.schedule=constant"]
# the RWKV kernels at one rank's streams of the rwkv6-7b task: its rows'
# 32 heads in the selection forward (8 rows), in the subset's step (rset's
# largest, 4)
TPF_RWKV_SHAPES = (("rank_selection", 8 * 32, 512, 64, 0.4),
                   ("rank_subset", 4 * 32, 512, 64, 0.4))
# the serve tasks of the same launch, under ``default`` with decode_32k's
# rules (the cache's positions over "model"): (arch, prompt positions,
# model overrides) at TPF_LAYERS, TPF_SERVE_ROWS rows, then TPF_SERVE_TICKS
# ticks into a cache of the prompt and 64 positions; internvl2-26b's 320
# are its 256 patches and 64 tokens, rank 1's 160 straddling them
TPF_SERVE = (("rwkv6-7b", 64, {"param_dtype": "float32"}), ("hymba-1.5b", 64, {}),
             ("musicgen-medium", 64, {}), ("internvl2-26b", 320, {}))
TPF_SERVE_ROWS, TPF_SERVE_TICKS = 4, 6
TPF_FLEET_TIMEOUT_S = 600


def _tpf_config(arch, rows, seq, extra):
    from repro_torch.api import ExperimentConfig
    over = dict({"attn_backend": "auto", "num_layers": TPF_LAYERS}, **extra)
    return ExperimentConfig().apply_overrides(
        [o for o in SLICE_OVERRIDES if not o.startswith(("model.overrides", "train.steps"))]
        + [f"model.arch={arch}", f"model.overrides={json.dumps(over)}",
           f"train.steps={TPF_STEPS}", "train.log_every=0", f"train.batch={rows}",
           f"train.seq={seq}"] + TPF_OVERRIDES)


def _tpf_batch(mcfg, rows, seq, seed):
    """A batch of the model's input (``specs.batch_specs``' layout) from a
    seeded generator: frames, or patches and tokens, or tokens; labels."""
    import torch
    from repro_torch.launch import specs
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, s in specs.batch_specs(mcfg, rows, seq).items():
        if s.dtype.is_floating_point:
            out[k] = torch.randn(s.shape, generator=g).to(s.dtype)
        else:
            out[k] = torch.randint(0, mcfg.vocab_size, s.shape, generator=g, dtype=s.dtype)
    return out


def _tpf_prediction(cfg, mcfg, rows, seq):
    """One rank's refresh step of the (1, 2) fleet on fake cuda:0 tensors."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(*TPF_MESH)
    backend = dryrun.RecordingBackend(mesh.size)
    cell = specs.experiment_cell(cfg, mesh=dryrun.RecordingMesh(mesh, backend),
                                 rules=dict(sh.DEFAULT_RULES, **specs.RULE_PRESETS["default"]),
                                 backend=backend, batch=specs.batch_specs(mcfg, rows, seq))
    return dryrun.trace(cell, backend)


def phase_tp_families(ctx):
    """JAX's ``default`` preset on the ssm, audio, vlm and hybrid families:
    rwkv6-7b (in float32, beside one bfloat16 run in this process),
    musicgen-medium, internvl2-26b and hymba-1.5b at full width and 2
    layers, one refresh step each, on two gloo ranks sharing the card on a
    (1, 2) ("data", "model") mesh, the four serve tasks (``TPF_SERVE``) and
    the four train tasks in one launch. Each is first run in this process (then
    freed), and traced by the dry run on fake cuda:0 tensors while the
    fleet runs; each rank is held to the one process (losses and grad norms
    at 3e-3, ranks and pivots equal; step 0's first moment leaf by leaf at
    ``FSDP_M0_RTOL``; the final parameters as a whole at 3e-3), to the
    prediction's peak (``DRYRUN_PEAK_RTOL``), to its shards' resident
    bytes, to ``expected_launches``, to its layout (the sequence and d_ff
    over "model") and, for rwkv6-7b, to its heads of the time mix; each
    serve task as phase serve_tp holds its own (``_serve_checks``).
    Then the RWKV kernels at one rank's streams against their plain
    versions, timed."""
    import tempfile
    import torch
    from repro_torch import configs
    from repro_torch.backend import fleet
    ctx.pop("trainer", None)
    smi = ctx.get("smi", "")
    jobs, refs, preds, cfgs = [], {}, {}, {}
    for arch, rows, seq, extra in TPF_RUNS:
        gc.collect()
        torch.cuda.empty_cache()
        cfgs[arch] = cfg = _tpf_config(arch, rows, seq, extra)
        mcfg, tcfg, _ = cfg.build()
        model_over = dict({"attn_backend": "auto", "num_layers": TPF_LAYERS}, **extra)
        assert mcfg == configs.get_config(arch, **model_over), "the fleet's config differs"
        batches = [_tpf_batch(mcfg, rows, seq, seed=i) for i in range(TPF_STEPS)]
        t1 = time.perf_counter()
        refs[arch] = _fsdp_reference(mcfg, tcfg, batches, seed=0, parts=1, n_steps=TPF_STEPS,
                                     max_leaf_bytes=MOE_EP_LEAF_BYTES)
        print(f"[tp_families] {arch} ({mcfg.param_dtype}): {rows} x {seq} "
              f"({', '.join(batches[0])}), rset {list(tcfg.graft.rset)}: one process "
              f"{time.perf_counter() - t1:.1f} s, losses {refs[arch]['losses']}, grad norms "
              f"{refs[arch]['grad_norms']}", flush=True)
        if extra.get("param_dtype") == "float32":   # the same run in bfloat16, beside it
            bf16 = _tpf_config(arch, rows, seq, {k: v for k, v in extra.items()
                                                 if k != "param_dtype"})
            m16, t16, _ = bf16.build()
            half = _fsdp_reference(m16, t16, batches, seed=0, parts=1, n_steps=TPF_STEPS,
                                   max_leaf_bytes=MOE_EP_LEAF_BYTES)
            gaps, whole = _leaf_gaps(_leading_block(half["m0"], refs[arch]["m0"]),
                                     refs[arch]["m0"])
            print(f"[tp_families] {arch} {smi}: one process in bfloat16 against float32 from "
                  f"the same draws: losses {half['losses']}, grad norms "
                  f"{half['grad_norms']} (relative "
                  f"{abs(half['grad_norms'][0] / refs[arch]['grad_norms'][0] - 1):.3g}), "
                  f"ranks {half['ranks']}, step 0's first moment {whole:.3g} apart in all, "
                  f"the leaves furthest apart "
                  f"{[(p, round(gaps[p], 4)) for p in sorted(gaps, key=gaps.get)[-4:]]}",
                  flush=True)
            del half
        jobs.append({"kind": "tp", "preset": "default", "mesh": TPF_MESH, "arch": arch,
                     "model": model_over, "seed": 0, "steps": TPF_STEPS, "batches": batches,
                     "max_leaf_bytes": MOE_EP_LEAF_BYTES, "tcfg": dataclasses.asdict(tcfg)})
    serve, serve_jobs = {}, []
    for arch, plen, extra in TPF_SERVE:
        gc.collect()
        torch.cuda.empty_cache()
        model_over = dict({"num_layers": TPF_LAYERS}, **extra)
        mcfg = configs.get_config(arch, **model_over)
        prompts = _tpf_batch(mcfg, TPF_SERVE_ROWS, plen, seed=7)
        max_seq = plen + 64
        t1 = time.perf_counter()
        ref = _serve_reference(mcfg, prompts, max_seq, TPF_SERVE_TICKS)
        print(f"[tp_families] serve {arch} ({mcfg.param_dtype}): {TPF_SERVE_ROWS} x {plen} "
              f"({', '.join(prompts)}) into {max_seq}, {TPF_SERVE_TICKS} ticks: one process "
              f"{time.perf_counter() - t1:.1f} s", flush=True)
        serve[arch] = {"mcfg": mcfg, "plen": plen, "max_seq": max_seq, "ref": ref,
                       "task": len(serve_jobs)}
        serve_jobs.append({"kind": "serve", "mesh": TPF_MESH, "arch": arch, "model": model_over,
                     "seed": 0, "shape": "decode_32k", "preset": "default", "batch": prompts,
                     "max_seq": max_seq, "ticks": TPF_SERVE_TICKS,
                     "feed": ref["tokens"][:TPF_SERVE_TICKS]})
    # the serve tasks first: a rank's process keeps each thread's cuBLAS
    # workspace, and a train task's backward thread would leave one that a
    # serve task (no backward) does not reckon
    jobs = serve_jobs + jobs
    gc.collect()
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="tp_families.", dir=os.path.join(ROOT, "build"))
    box = {}

    def run_fleet():
        try:
            port = fleet.free_port()
            t1 = time.perf_counter()
            runs = fleet.launch([fleet.mesh_worker_command(
                os.path.join(work, "job.pt"), os.path.join(work, "out"),
                fleet.backend_overrides(2, r, port)) for r in range(2)],
                timeout=TPF_FLEET_TIMEOUT_S)
            box["wall"] = time.perf_counter() - t1
            box["ranks"] = [torch.load(r.last_json()["path"], weights_only=True) for r in runs]
        except BaseException as e:                  # noqa: BLE001 — raised below
            box["error"] = e

    try:
        torch.save(jobs, os.path.join(work, "job.pt"))
        thread = threading.Thread(target=run_fleet)
        thread.start()
        try:
            for arch, rows, seq, _ in TPF_RUNS:     # the ranks' prediction, beside them
                t1 = time.perf_counter()
                preds[arch] = _tpf_prediction(cfgs[arch], cfgs[arch].build()[0], rows, seq)
                print(f"[tp_families] {arch} prediction traced in "
                      f"{time.perf_counter() - t1:.1f} s: peak "
                      f"{preds[arch]['memory']['peak_bytes'] / 1e9:.3f} GB a rank, args "
                      f"{preds[arch]['memory']['argument_size_in_bytes'] / 1e9:.3f} GB, "
                      f"collectives { {k: v for k, v in preds[arch]['collectives']['bytes_by_op'].items() if v} }, "
                      f"kernels { {k: r['launches'] for k, r in preds[arch]['kernels'].items()} }",
                      flush=True)
            for arch, task in serve.items():
                t1 = time.perf_counter()
                task["pred"], task["part"] = _serve_prediction(
                    task["mcfg"], TPF_MESH, TPF_SERVE_ROWS, task["plen"], task["max_seq"],
                    f"[tp_families] serve {arch}")
                print(f"[tp_families] serve {arch} prediction traced in "
                      f"{time.perf_counter() - t1:.1f} s: its cache {task['part']} B", flush=True)
        finally:
            thread.join()
        if "error" in box:
            raise box["error"]
        wall, ranks = box["wall"], box["ranks"]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"[tp_families] {smi}: the fleet's {len(TPF_SERVE)} serve and {len(TPF_RUNS)} train "
          f"tasks in {wall:.1f} s of wall", flush=True)
    failures = []
    for i, (arch, rows, seq, _) in enumerate(TPF_RUNS):
        ref, pred_peak = refs[arch], preds[arch]["memory"]["peak_bytes"]
        mcfg = cfgs[arch].build()[0]
        kernels = (("rwkv_scan", "rwkv_scan_backward") if mcfg.family == "ssm"
                   else ("flash_forward", "flash_dq", "flash_dkv"))
        vocab = ["model"] if mcfg.vocab_size % 2 == 0 else []
        for r in ranks:
            got = r["tasks"][len(serve_jobs) + i]
            want = {k: v for k, v in got["launches_expected"].items() if v}
            rel_peak = (pred_peak - got["peak_bytes"]) / got["peak_bytes"]
            rel = {key: max(abs(a - b) / abs(b) for a, b in zip(got[key], ref[key]))
                   for key in ("losses", "grad_norms")}
            print(f"[tp_families] {arch} {smi}: rank {r['rank']}: losses {got['losses']}, grad "
                  f"norms {got['grad_norms']} (relative to one process {rel}), ranks "
                  f"{got['ranks']}, step ms {[round(x * 1e3, 1) for x in got['step_s']]}, "
                  f"resident {got['resident_bytes']} B (shards {got['shard_bytes']} B), "
                  f"max_memory_allocated {got['peak_bytes'] / 1e9:.3f} GB (prediction "
                  f"{rel_peak:+.2%}), launches {got['launches']}, layout {got['layout']}, "
                  f"heads {got['heads']}", flush=True)
            H = mcfg.num_heads // 2
            checks = [
                (r["collectives"] == "gloo" and r["device"].startswith("cuda"),
                 (r["collectives"], r["device"])),
                (got["resident_bytes"] == got["shard_bytes"], "resident state is not its shards"),
                (abs(pred_peak - got["peak_bytes"]) <= DRYRUN_PEAK_RTOL * got["peak_bytes"],
                 f"peak {got['peak_bytes']} vs predicted {pred_peak}"),
                (got["launches"] == want, f"launches {got['launches']} vs {want}"),
                (all(want.get(n) for n in ("graft_select", "grad_norm", "optimizer_update")
                     + kernels), f"a kernel is not on the sharded path: {want}"),
                (got["layout"] == {"seq": ["model"], "mlp": ["model"], "vocab": vocab},
                 got["layout"]),
                # rwkv6-7b's 64 heads split; hymba-1.5b's 25 do not
                (got["heads"] == ([[r["rank"] * H, r["rank"] * H + H]]
                                  if mcfg.family == "ssm" else []), got["heads"]),
                (got["ranks"] == ref["ranks"], (got["ranks"], ref["ranks"])),
                ({int(k): v for k, v in got["pivots"].items()} == ref["pivots"], "pivots"),
                (rel["losses"] <= 3e-3 and rel["grad_norms"] <= 3e-3,
                 f"losses / grad norms {rel} relative to one process")]
            failures += [f"{arch} rank {r['rank']}: {what}" for ok, what in checks if not ok]
        got0 = ranks[0]["tasks"][len(serve_jobs) + i]
        _, whole = _leaf_gaps(got0["params"], _leading_block(ref["params"], got0["params"]))
        gaps, _ = _leaf_gaps(got0["m0"], _leading_block(ref["m0"], got0["m0"]))
        furthest = sorted(gaps, key=gaps.get, reverse=True)
        print(f"[tp_families] {arch} {smi}: final parameters {whole:.3g} relative to one "
              f"process; step 0's first moment vs one process, the leaves furthest apart "
              f"{[(p, round(gaps[p], 6)) for p in furthest[:6]]} (bar {FSDP_M0_RTOL})",
              flush=True)
        bad = [(p, gaps[p]) for p in furthest if not gaps[p] <= FSDP_M0_RTOL]
        if bad:
            failures.append(f"{arch}: step 0's gradients differ from one process: {bad}")
        if not whole <= 3e-3:
            failures.append(f"{arch}: final parameters differ by {whole:.3g}")
    for arch, task in serve.items():
        failures += _serve_checks(f"[tp_families] serve {arch}", task["mcfg"], task["ref"],
                                  task["pred"], task["part"], ranks, task["task"], smi)
    assert not failures, failures
    for name, BH, T, D, w_low in TPF_RWKV_SHAPES:
        _rwkv_case(name, BH, T, D, w_low, tag="tp_families")


# (a)'s pool, beside (b) and (c): 30 s of it for the other families'
# decode cells, so that they leave the prefill cells 60 s
SERVE_TP_BUDGET_S = 90.0
SERVE_TP_JOBS = 4
# (a)'s archs under ``fsdp``; the dense ones' ``default`` decode_32k cells
# are phase dryrun's (``DRYRUN_DECODE_REQUIRED``)
SERVE_TP_ARCHS = TP_ARCHS + ("musicgen-medium", "internvl2-26b")
# (a)'s archs under ``default``: the other families' decode_32k cells
SERVE_TP_DEFAULT_ARCHS = ("rwkv6-7b", "hymba-1.5b", "musicgen-medium", "internvl2-26b")
# (a)'s prefill_32k cells after the decode ones: phase dryrun's budget
# reaches none of them. The first, a sharded prefill under ``default`` at
# the pod's size, is required; then the frontends' ``default`` cells, then
# the rest cheapest first
SERVE_TP_PREFILLS = (("minicpm-2b", "default"), ("minicpm-2b", "fsdp"),
                     ("musicgen-medium", "default"), ("internvl2-26b", "default"),
                     ("stablelm-12b", "default"), ("gemma2-27b", "default"),
                     ("qwen1.5-32b", "default")) + tuple(
    (arch, "fsdp") for arch in ("stablelm-12b", "internvl2-26b", "musicgen-medium",
                                "gemma2-27b", "qwen1.5-32b"))
SERVE_TP_LAYERS = 2           # (c): phase shell's cut
SERVE_TP_ROWS, SERVE_TP_PROMPT, SERVE_TP_MAX_SEQ, SERVE_TP_TICKS = 4, 512, 1024, 16
# a sharded serve run's logits against one process's, as a share of the
# largest, by the model's parameter dtype: a bf16 ulp at |logit| 2-4 for
# bfloat16, the CPU serve tests' 1e-4 for float32
SERVE_LOGIT_TOL = {"bfloat16": 2.0 ** -7, "float32": 1e-4}


def _serve_tp_sweep(box):
    """(a), run in a thread: the ``fsdp`` decode_32k cells first, then the
    other families' ``default`` ones, then the prefill_32k ones of both
    presets; ``box`` gets (results, left out) or the error."""
    from repro_torch.launch import dryrun
    try:
        todo = ([(arch, "decode_32k", "serve", "single", "fsdp") for arch in SERVE_TP_ARCHS]
                + [(arch, "decode_32k", "serve", "single", "default")
                   for arch in SERVE_TP_DEFAULT_ARCHS]
                + [(arch, "prefill_32k", "serve", "single", preset)
                   for arch, preset in SERVE_TP_PREFILLS])
        box["cells"] = dryrun.sweep(todo, SERVE_TP_JOBS, SERVE_TP_BUDGET_S, device="cuda:0")
    except BaseException as e:                      # noqa: BLE001 — raised by _serve_tp_cells
        box["error"] = e


def _serve_tp_cells(box, smi):
    """(a)'s results printed; the decode cells and the first prefill cell
    held to trace sharded and fit."""
    from repro_torch.launch import dryrun
    if "error" in box:
        raise box["error"]
    results, left = box["cells"]
    for res in results:
        print(f"[serve_tp] {dryrun.summary(res)}", flush=True)
        if res.get("ok"):
            mem, coll = res["full"]["memory"], res["full"]["collectives"]
            print(f"[serve_tp] (a) {smi}: {res['arch']} {res['shape']} {res['rules_preset']}: "
                  f"state {res['state']}, {res['local_batch']} rows a device, peak "
                  f"{mem['peak_bytes'] / 1e9:.3f} GB (fits 80 GB: {mem['fits']}), args "
                  f"{res['argument_bytes_per_device'] / 1e9:.3f} GB, "
                  f"{res['full']['flops'] / 1e12:.3f} TFLOP, collective bytes "
                  f"{ {k: v for k, v in coll['bytes_by_op'].items() if v} }, counts "
                  f"{ {k: v for k, v in coll['count_by_op'].items() if v} }", flush=True)
        else:
            print(res["error"], file=sys.stderr)
    for cell in left:
        print(f"[serve_tp] LEFT OUT {' '.join(cell)}: past the phase's "
              f"{SERVE_TP_BUDGET_S:.0f} s budget", flush=True)
    print(f"[serve_tp] (a) {smi}: {len(results)} cells traced in {SERVE_TP_JOBS} worker "
          f"processes; left out for time as well: the prefill_32k cells of hymba-1.5b and "
          f"rwkv6-7b (their PyTorch loops over tokens)", flush=True)
    failed = [(r["arch"], r["shape"], r.get("rules_preset")) for r in results if not r.get("ok")]
    assert not failed, f"serve cells failed: {failed}"
    by_cell = {(r["arch"], r["shape"], r["rules_preset"]): r for r in results}
    first_arch, first_preset = SERVE_TP_PREFILLS[0]
    for arch, shape, preset in ([(a, "decode_32k", "fsdp") for a in SERVE_TP_ARCHS]
                                + [(a, "decode_32k", "default") for a in SERVE_TP_DEFAULT_ARCHS]
                                + [(first_arch, "prefill_32k", first_preset)]):
        res = by_cell.get((arch, shape, preset))
        assert res is not None, f"{arch}'s {shape} {preset} cell not traced in the budget"
        assert res["state"] == "sharded", (arch, shape, preset, res["state"])
        assert res["full"]["memory"]["fits"], (
            f"{arch}'s {shape} {preset} cell peaks at "
            f"{res['full']['memory']['peak_bytes'] / 1e9:.1f} GB")


def _serve_rules():
    """``default`` with decode_32k's rules: the cache's positions over "model"."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import specs
    return dict(sh.DEFAULT_RULES, **specs.SHAPE_RULES["decode_32k"],
                **specs.RULE_PRESETS["default"])


def _serve_prediction(mcfg, mesh_spec, rows, plen, max_seq, tag):
    """One device's prefill and decode tick of a serve fleet of ``rows``
    prompts of ``plen`` positions into ``max_seq``, on fake cuda:0 tensors
    on the ``mesh_spec`` mesh under ``_serve_rules()`` → (the larger peak,
    the bytes of the device's cache: its part of every leaf by
    ``CACHE_LOGICAL``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import decode as decode_lib
    from repro_torch.models import model as model_lib
    rules = _serve_rules()
    shape, names = mesh_spec
    peaks = {}
    for kind in ("prefill", "decode"):
        backend = dryrun.RecordingBackend(math.prod(shape))
        mesh = dryrun.RecordingMesh(make_mesh(*mesh_spec), backend)
        fake_mode = FakeTensorMode()
        with fake_mode, sh.sharding_rules(mesh, rules):
            params = model_lib.shard_model(model_lib.Model(mcfg, "cuda:0"), mesh, rules)
        cell = specs.serve_cell(mcfg, kind, rows, max_seq, params, seq=plen, mesh=mesh,
                                rules=rules, fake_mode=fake_mode, device="cuda:0", as_card=False,
                                batch=rows // shape[names.index("data")])
        res = dryrun.trace(cell, backend)
        peaks[kind] = res["memory"]["peak_bytes"]
        print(f"{tag} {kind} of the {shape} fleet's device on fake cuda:0 tensors: peak "
              f"{peaks[kind] / 1e9:.4f} GB, args "
              f"{res['memory']['argument_size_in_bytes'] / 1e9:.4f} GB, collectives "
              f"{ {k: v for k, v in res['collectives']['count_by_op'].items() if v} }",
              flush=True)
    with sh.sharding_rules(make_mesh(*mesh_spec), rules):
        cache = decode_lib.init_cache(mcfg, rows, max_seq, "meta")
    part = sum(t.numel() * t.element_size() for layer in cache["layers"]
               for t in model_lib._leaves(layer))
    return max(peaks.values()), part


def _serve_reference(mcfg, prompts, max_seq, ticks):
    """A serve fleet's run in this process, on the card, unsharded: greedy
    tokens (the whole batch, a column a tick), logits (host float32), tick
    seconds, the least top-2 logit gap."""
    import torch
    from repro_torch.models import decode as decode_lib
    from repro_torch.models import model as model_lib
    model = model_lib.init_params(mcfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    logits, cache = decode_lib.prefill(mcfg, model, {k: v.cuda() for k, v in prompts.items()},
                                       max_seq)
    out = {"logits": [logits.float().cpu()], "tokens": [], "tick_s": []}
    cur = logits[:, 0].argmax(-1).to(torch.int32)[:, None]
    for _ in range(ticks):
        out["tokens"].append(cur.cpu())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = decode_lib.decode_step(mcfg, model, cache, cur)
        torch.cuda.synchronize()
        out["tick_s"].append(time.perf_counter() - t0)
        out["logits"].append(logits.float().cpu())
        cur = logits[:, 0].argmax(-1).to(torch.int32)[:, None]
    out["tokens"].append(cur.cpu())
    top2 = [lg[:, 0].topk(2, dim=-1).values for lg in out["logits"]]
    out["min_gap"] = min(float((v[:, 0] - v[:, 1]).min()) for v in top2)
    del model, cache
    return out


def _serve_checks(tag, mcfg, ref, pred, part, ranks, task, smi):
    """A serve fleet's ranks (task ``task`` of each) against this process's
    run (``_serve_reference``): the failures. Each rank on gloo and the
    card, its rows over "data" and positions over "model"; its logits
    within ``SERVE_LOGIT_TOL`` of the largest for the model's dtype, its
    greedy tokens this process's except where this process's logits tie
    within that bar; its resident cache exactly ``part``; its peak within
    ``DRYRUN_PEAK_RTOL`` of ``pred``."""
    import torch
    scale = max(float(lg.abs().max()) for lg in ref["logits"])
    bar = SERVE_LOGIT_TOL[mcfg.param_dtype] * scale
    rows = ref["logits"][0].shape[0]
    ref_tick = sum(ref["tick_s"]) / len(ref["tick_s"])
    print(f"{tag} {smi}: this process: {len(ref['tick_s'])} ticks of {ref_tick * 1e3:.2f} ms "
          f"on average ({rows / ref_tick:.1f} tokens/s), max|logit| {scale:.4g}, the least "
          f"top-2 logit gap {ref['min_gap']:.4g}", flush=True)
    failures = []
    for r in ranks:
        got = r["tasks"][task]
        lay = got["layout"]
        r0, r1 = lay["rows"]
        err = max(float((a - b[r0:r1]).abs().max()) for a, b in zip(got["logits"], ref["logits"]))
        # the ranks' greedy tokens are the whole batch's (gathered each tick)
        same = [torch.equal(a, b) for a, b in zip(got["tokens"], ref["tokens"])]
        # where a tick's tokens differ: each differing row's token against
        # this process's logits at that tick, how far below its greedy one
        below = [float(lg[i, 0, b[i, 0]] - lg[i, 0, a[i, 0]])
                 for a, b, lg in zip(got["tokens"], ref["tokens"], ref["logits"])
                 for i in range(a.shape[0]) if a[i, 0] != b[i, 0]]
        tick = sum(got["tick_s"]) / len(got["tick_s"])
        rel_peak = (pred - got["peak_bytes"]) / got["peak_bytes"]
        print(f"{tag} {smi}: rank {r['rank']}: layout {lay}, prefill "
              f"{got['prefill_s'] * 1e3:.1f} ms, tick {tick * 1e3:.1f} ms on average "
              f"({rows / tick:.2f} tokens/s for the fleet), ticks ms "
              f"{[round(x * 1e3, 1) for x in got['tick_s']]}, greedy tokens equal at "
              f"{sum(same)} of {len(same)} ticks (elsewhere the tokens taken lie {below} below "
              f"this process's greedy ones in its logits), max|logit diff| {err:.4g} (bar "
              f"{bar:.4g}, {1 - err / bar:.1%} to spare), resident cache "
              f"{got['resident_bytes']} B (its part {part} B), max_memory_allocated "
              f"{got['peak_bytes'] / 1e9:.4f} GB (prediction {rel_peak:+.2%})", flush=True)
        checks = [
            (r["collectives"] == "gloo" and r["device"].startswith("cuda"),
             (r["collectives"], r["device"])),
            (lay["batch_axes"] == ["data"] and lay["seq_axes"] == ["model"], lay),
            # bf16 logits over a large vocabulary tie (this process's least
            # top-2 gap is 0 on an H100): a token may differ only where one
            # bf16 ulp decides the argmax
            (all(x <= bar for x in below),
             f"greedy tokens differ at ticks {[i for i, ok in enumerate(same) if not ok]}, "
             f"{below} below"),
            (err <= bar, f"logits differ by {err}"),
            (got["resident_bytes"] == part, (got["resident_bytes"], part)),
            (abs(pred - got["peak_bytes"]) <= DRYRUN_PEAK_RTOL * got["peak_bytes"],
             f"peak {got['peak_bytes']} vs predicted {pred}")]
        failures += [f"{tag} rank {r['rank']}: {what}" for ok, what in checks if not ok]
    return failures


def phase_serve_tp(ctx):
    """Sharded serving: (a) the dry run's decode_32k cells under ``fsdp``
    (and the other families' under ``default``) and prefill_32k cells
    under both presets (minicpm-2b's under ``default`` required) on the
    (16, 16) pod in a thread, beside
    (b) the prediction for (c) and (c) four gloo ranks sharing the card
    under ``default`` with decode_32k's rules (the split-KV combine), held
    to the same run in this process."""
    import torch
    ctx.pop("trainer", None)
    gc.collect()
    torch.cuda.empty_cache()
    smi = ctx.get("smi", "")
    box = {}
    sweep = threading.Thread(target=_serve_tp_sweep, args=(box,))
    sweep.start()
    try:
        _serve_tp_fleet(smi)
    finally:
        sweep.join()
    _serve_tp_cells(box, smi)


def _serve_tp_fleet(smi):
    """(b) and (c)."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.backend import fleet
    mcfg = configs.get_config("minicpm-2b", num_layers=SERVE_TP_LAYERS)
    t1 = time.perf_counter()
    # the device's cache is its 2 rows and 512 positions of the K/V
    pred, part = _serve_prediction(mcfg, FSDP_MESH, SERVE_TP_ROWS, SERVE_TP_PROMPT,
                                   SERVE_TP_MAX_SEQ, "[serve_tp] (b)")
    print(f"[serve_tp] (b) traced in {time.perf_counter() - t1:.1f} s", flush=True)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, mcfg.vocab_size, (SERVE_TP_ROWS, SERVE_TP_PROMPT)).astype(np.int32))
    prompts = {"tokens": toks, "labels": toks}
    ref = _serve_reference(mcfg, prompts, SERVE_TP_MAX_SEQ, SERVE_TP_TICKS)
    gc.collect()
    torch.cuda.empty_cache()
    task = {"kind": "serve", "mesh": FSDP_MESH, "arch": "minicpm-2b",
            "model": {"num_layers": SERVE_TP_LAYERS}, "seed": 0, "shape": "decode_32k",
            "preset": "default", "batch": prompts, "max_seq": SERVE_TP_MAX_SEQ,
            "ticks": SERVE_TP_TICKS, "feed": ref["tokens"][:SERVE_TP_TICKS]}
    work = tempfile.mkdtemp(prefix="serve_tp.", dir=os.path.join(ROOT, "build"))
    try:
        torch.save([task], os.path.join(work, "job.pt"))
        port = fleet.free_port()
        t1 = time.perf_counter()
        runs = fleet.launch([fleet.mesh_worker_command(
            os.path.join(work, "job.pt"), os.path.join(work, "out"),
            fleet.backend_overrides(4, r, port)) for r in range(4)], timeout=400)
        wall = time.perf_counter() - t1
        ranks = [torch.load(r.last_json()["path"], weights_only=True) for r in runs]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    failures = _serve_checks("[serve_tp] (c)", mcfg, ref, pred, part, ranks, 0, smi)
    print(f"[serve_tp] (c) {smi}: fleet wall {wall:.1f} s", flush=True)
    assert not failures, failures


def _leaf_gaps(got, want):
    """Each leaf's relative Frobenius gap ``|got - want| / |want|`` (float32)
    by path, and the whole tree's."""
    import torch
    from repro_torch.models import model as model_lib
    diff2 = ref2 = 0.0
    leaves = {}
    for path, g, w in zip(_tree_paths(got), model_lib._leaves(got), model_lib._leaves(want)):
        assert g.shape == w.shape, (path, g.shape, w.shape)
        g, w = g.to(torch.float32), w.to(torch.float32)
        d = float(torch.linalg.vector_norm(g - w))
        n = float(torch.linalg.vector_norm(w))
        diff2, ref2 = diff2 + d * d, ref2 + n * n
        leaves[path] = d / max(n, 1e-30)
    return leaves, (diff2 / ref2) ** 0.5


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs an NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"cannot import repro_torch next to {__file__}: {e}", file=sys.stderr)
        return 2
    ctx = {}
    failed = []
    for name, fn in (("device", phase_device), ("build", phase_build),
                     ("kernels", phase_kernels), ("flash", phase_flash),
                     ("optim", phase_optim), ("slice", phase_slice), ("engine", phase_engine),
                     ("samplers", phase_samplers), ("profile", phase_profile), ("depth8", phase_depth8),
                     ("rwkv", phase_rwkv), ("rwkv_slice", phase_rwkv_slice),
                     ("families", phase_families), ("classify", phase_classify),
                     ("serve", phase_serve), ("check", phase_check),
                     ("shell", phase_shell), ("chaos", phase_chaos),
                     ("analysis", phase_analysis), ("backend", phase_backend),
                     ("sharded", phase_sharded), ("dryrun", phase_dryrun),
                     ("fsdp", phase_fsdp), ("tp", phase_tp), ("serve_tp", phase_serve_tp),
                     ("moe_ep", phase_moe_ep), ("tp_families", phase_tp_families)):
        print(f"=== phase {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn(ctx)
        except Exception:                          # noqa: BLE001 — report, go on
            traceback.print_exc()
            failed.append(name)
        print(f"=== phase {name} {'FAILED' if name in failed else 'ok'} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if name in ("device", "build") and failed:
            break
    kernels = list(ctx.get("kernels", {}).values())
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    unrun = [k.get("name") for k in kernels
             if any(f not in k for f in keys) or not k["launches"]]
    if not failed and (len(kernels) != len(_kernel_counters()) or unrun):
        print(f"chip_smoke: kernels without a full entry or a launch on their path: "
              f"{unrun or [k.get('name') for k in kernels]}", file=sys.stderr)
        failed.append("kernels line")
    if failed:
        print(f"chip_smoke: phases failed: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
