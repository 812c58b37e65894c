#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. Build every kernel from ``csrc/`` (one ``nvcc`` per source, all started
   together) and hold each wrapper against its plain PyTorch version on the
   card:
   * flash attention over the kernel test shapes x {float32, bfloat16}
     (tolerance 2e-4 / 2e-2, plus a per-row relative L2 limit), over bf16
     shapes at the wgmma + TMA kernel's edges (ragged 128-row tiles, one q
     row, the 32 B and 64 B swizzles, hymba-1.5b's prefill with its odd
     group of 5, kimi-k2's with 64 heads in groups of 8, whisper-tiny's
     non-causal encoder over 1500 frames (a ragged last kv tile in every q
     tile) and its decoder's 224-token prompt, the prefills of
     phi4-mini-3.8b (G = 3), internvl2-2b (G = 2), starcoder2-15b (G = 12)
     and granite-20b (one K/V head, G = 48), an input off TMA's 16-byte
     alignment, and V = identity so that O reads back P), and at
     qwen2.5-3b's serving prefill geometry, where two planted faults must
     be rejected (at every model's prefill too, with "causal mask applied"
     for "non-causal" at whisper's encoder); the f32 scalar kernel is timed
     there too, and the other models' prefills are timed beside SDPA on K/V
     repeated over the group (non-causal for the encoder); then the contract
     past the models' head dims and dtype (``check_flash_contract``): head
     dims 72, 80, 96, 112, 160, 256, 300, 320, 384 and 512 x {float32,
     bfloat16, float16} x causal / non-causal at 300 rows, V = identity at
     80, 96, 256, 300 and 512, and the prefills of ``FA_CONTRACT`` (phi-2's
     hd 80, Phi-3-mini's 96, Gemma-2-2B's 256, qwen2.5-3b's in float16
     (tolerance 5e-3 / 2.5e-3), hd 112 padded to 128 at qwen's heads, the
     first three in float32, and the wide kernel at Gemma-2-2B's heads with
     hd 300, 320, 384 and 512 in all three dtypes) on the model's views
     (uncopied) and on contiguous inputs, causal and non-causal, with both
     faults planted each way, every launch and pad counted, timed beside
     SDPA (naming the backend that served it) with the wrapper's host cost;
     and deepseek-v2-lite's MLA prefill (``FA_MLA``, ``check_flash_mla``):
     q . k at 192 with v's 128 zero-padded to it, padded to the hd-256
     instance, at YaRN's softmax scale, held and faulted the same way;
     and the sliding window (``check_flash_window``): hymba-1.5b's windowed
     prefill in its benchmark cell (``FA_WINDOW``) in bf16 against the plain
     windowed version and against ``chunked_attention`` (the path it
     replaces), one launch and one window counted, with "window ignored"
     and the last kv tile skipped planted, timed beside the causal kernel
     at the same shape, ``chunked_attention`` and SDPA with the band as a
     mask; the same in float16, in float32 and on the wide kernel at one
     shape each (``FA_WINDOW_CONTRACT``), windows at and below a tile over a
     ragged 1000 rows (``FA_WINDOW_EDGES``), and windows of at least S equal
     to the causal kernel bit for bit;
   * the SSD scan over the kernel test shapes x {float32, bfloat16}
     (tolerance 5e-4 / 3e-2 on y and the final state, plus a per-step
     relative L2 limit on y), over bf16 shapes at the tensor-core kernel's
     edges (ragged S, S below one chunk, B/C per head, hymba-1.5b's prefill
     at N = 16, x off a 16-byte boundary, so that both of its load modes
     run; head-broadcast B and C are the model's views of one conv
     output), and at mamba2-130m's serving prefill geometry, where three
     planted faults must be rejected; timed there by both methods, with
     the wrapper's host cost, the f32 kernel and batch 8 beside it, and
     timed at hymba's prefill; then the contract past 128 and bf16
     (``check_ssd_contract``): (N, chunk) of ``SSD_CONTRACT_SWEEP`` in three
     dtypes at 300 steps, and mamba2-130m's prefill at chunk 256 (equal bit
     for bit to chunk 128: its two sub-chunks), at N = 256 (two state tiles
     and the tile sum, counted) and in float16 (the f32 kernel; tolerance
     5e-3 / 2.5e-3), the first two in float32 and all three together in
     float16, and at chunk 512 and N = 320 and 384 in all three dtypes, on
     the model's views and on B/C per head, the three faults planted, timed
     with the wrapper's host cost; the f32 kernel at chunk 512 is held to a
     float64 run of the plain version, no further than 1.25x the plain
     chunked form in f32 at that chunk (``ssd_f64_check``);
   * the tensor fingerprint, where tokens must be equal, not close: the
     kernel gives every pinned JAX token of ``FP_GOLDEN``, equals the plain
     version over byte lengths that straddle word and block edges and the
     TMA route's stage and ring edges, up to 64 MiB, at byte offsets 0
     (the TMA route) and 1-3, 4, 8 and 12 (the register-ring route), and
     sees a one-bit flip at the first byte, the last byte and a block
     boundary of a 1 GiB buffer.
   Times the flash and SSD kernels, their plain versions and, where one
   exists, one PyTorch library call at the serving geometry for the
   ``kernels`` line.
2. Model checks, for qwen2.5-3b, mamba2-130m, hymba-1.5b, kimi-k2,
   deepseek-v2-lite, whisper-tiny, and then phi4-mini-3.8b, internvl2-2b,
   starcoder2-15b and granite-20b (``DENSE_ARCHS``, at full width and
   depth; starcoder2 and granite with bf16 params, ``CONFIG_CUTS``;
   internvl2's forward with 256 image positions' patch embeddings, each
   printing its params' size and peak memory and the inputs the K1 wrapper
   copied): the smoke config on the card against the same weights
   on the CPU (prefill and decode logits); the full-width bf16 model
   through the kernels, block by block no further from an f32-compute run
   than the reference path is (the planted faults must fail this check
   too; qwen2.5-3b once more with float16 compute, 36 K1 launches on the
   f16 instance, and mamba2-130m once more at mamba_ssm's chunk of 256, 24
   K2 launches); then a breakdown of the serving decode step (host time, device
   kernel time, bound).  hymba's run is a 2048-token prefill (32 flash
   launches, 29 of them windowed, and 32 SSD launches, exactly) and decode
   steps that write past the end of
   its local layers' 1024-slot rings, checked also at every decode step's
   logits and in every ring, where a planted ring write that stops at the
   last slot must fail. kimi-k2 runs at full width cut to 2 layers (its
   dense layer and one MoE layer of 384 experts) with bf16 params
   (``CONFIG_CUTS``): its forward's prompt attention takes K1 at G = 8
   (exactly 2 launches), both K1 faults must fail the block check, the MoE
   layers' EP form at ep = 1 with nothing dropped (capacity factor 48) is
   held to the dense form, and each path prints how many tokens chose other
   experts than the f32 run; the init's and a serving prefill's peak memory
   are printed.  deepseek-v2-lite runs at full width and depth with bf16
   params: a 1024-token prefill into the latent cache (routed experts), then
   decode steps, held to the expanded cache-free forward (block by block,
   then every decode step's logits): once with MLA's prefill in the
   absorbed form, where a latent cache written one slot late must fail and
   no kernel may launch, and once on the serving path, MLA's prefill on K1
   (27 launches), also held to the absorbed run, where both K1 faults must
   fail.  The MoE checks pin
   every run's routing to the f32 run's (``RouterPin``) and print the
   free-routing ratios beside.  On the card ``transformer.decode_step``
   replays captured CUDA graphs (``decode_graph``), which replay the code
   that was captured: every run with a fault or a router patched in keeps
   its decode steps eager (``eager_decode``), and hymba's and deepseek's
   runs through graphs are held bit for bit to the same runs eager.
   whisper-tiny runs at full width, nothing
   cut, through ``whisper.prefill``/``decode_step``: 4 requests of 1500
   frames and a 224-token prompt (K1 exactly 8 launches: 4 encoder layers
   non-causal, 4 decoder layers' prompts causal), then decode steps, held
   block by block over the encoder output and the prefill's hidden states
   and at every decode step's logits; the encoder's attention run causal,
   the last kv tile skipped and a prefill that leaves the cross K/V
   buffers zero must fail.  The fingerprint's path runs on qwen2.5-3b's
   full-width f32 parameters: every leaf fingerprinted twice by the kernel
   (the tokens must agree), each leaf no larger than the embedding and one
   (36, 2048, 11008) MLP stack held to the plain version, and the kernel
   timed at the largest leaf and the embedding (with the measured cycles a
   chain step).
3. Serve: ``repro_torch.launch.serve`` at full qwen2.5-3b, mamba2-130m,
   hymba-1.5b, kimi-k2, deepseek-v2-lite, phi4-mini-3.8b, internvl2-2b,
   starcoder2-15b and granite-20b width (hymba with prompts of 2048
   tokens; kimi, deepseek, starcoder2 and granite with ``CONFIG_CUTS``,
   applied through a spy on the serve module's ``get_config``), behind
   ``Session``/``ModelServer``;
   then whisper-tiny, which the serve driver refuses as the JAX one serves
   none of its requests, in a loop over ``whisper.prefill``/``decode_step``
   (8 requests of 1500 frames and a 224-token prompt, batches of 4, 32
   tokens each).  Launch counts are set to 0 just before each serve and
   read just after; each kernel of the path must have launched exactly
   ``SERVE_LAUNCHES`` times a prefill, and no other (the fingerprint runs on
   no serve path).
4. Train (no kernel: the training path runs the plain attention and SSD
   under autograd, as the JAX package does):
   a. ``repro_torch.launch.train`` at full mamba2-130m width (batch 8, seq
      256, 30 steps, a sharded-store checkpoint every 10): finite losses,
      three checkpoints kept; tokens/s, step ms, peak memory, save seconds
      and bytes;
   b. a second run on the same run dir to step 40: it resumes from step 30
      with the state ``restore()`` gives, bit for bit, ends with a step-40
      checkpoint, and the evicted checkpoints' keys are gone;
   c. one train step of mamba2-130m, f32 compute, on the card and on the
      CPU from the same weights and batch: loss and grad norm within 1e-4,
      every leaf's first moment within 1e-4 relative L2; then bf16 compute
      on the card, its loss within 2e-2 of the f32 loss; then the same
      card-against-CPU step at the smoke config of every other decoder-only
      arch (``TRAIN_CHECK_ARCHS``: qwen2.5-3b, hymba-1.5b, kimi-k2,
      deepseek-v2-lite, phi4-mini-3.8b, internvl2-2b with patch embeddings,
      starcoder2-15b, granite-20b); the MoE archs' card steps run free and
      with routing pinned to the CPU's, and the pinned one is held when a
      token's experts differ;
   d. five steps on one repeated batch: the loss must fall by 1 %, and a
      planted fault (the optimizer's lr forced to 0) must fail that check;
   e. qwen2.5-3b at full width, all 36 layers, ``remat="full"``, batch 2,
      seq 1024, three steps: finite losses and grad norms, no kernel
      launched; one step that slices each layer out of the stacks one at a
      time (the loop before ``unbind``) for comparison; a step with
      ``attention_impl="pallas"`` must raise and leave the state alone;
   f. ``serve --run-dir`` on run b's checkpoint: the params it loads equal
      the run's final params bit for bit, every request is served, and
      ``ssd_scan`` launches as often as in the fresh serve;
   g. whisper-tiny's train step (``make_train_step``; the JAX train driver
      makes no frame embeddings): the smoke config on the card against the
      CPU within 1e-4, then full width (f32 params, batch 8 x 448 target
      tokens x 1500 frames, reference attention) for three steps, and five
      steps on one batch whose loss must fall (not with lr forced to 0).
5. The distribution layer (no kernel):
   a. compression at qwen2.5-3b's full width: ``quantize_int8`` gives every
      pinned digest of ``COMPRESS_GOLDEN`` (the JAX function's) and the
      CPU's q and scales on the embedding, bit for bit; ``quantize_tree``
      over the f32 tree is timed beside its byte bound; 20 steps of error
      feedback on a fixed gradient converge as the reference's test asks
      (with the residual dropped they must not); the delta codec through
      the port's Store: payload at most 0.26 of the f32 bytes, decode
      within half a scale;
   b. the op counter: qwen2.5-3b's prefill (B=4, S=1024, bf16 compute,
      reference attention) and mamba2-130m's decode step, counted under
      ``FakeTensorMode`` and on the card, must agree op for op (names and
      shapes); the fake state's bytes within 1 % of the allocator's growth;
      the measured time beside the counted FLOPs and bytes at peak;
   c. the dry-run CLI, four subprocesses started at the phase's start:
      qwen2.5-3b decode_32k on 256 fake ranks, deepseek-v2-lite
      prefill_32k on 512 (with an all-to-all), and the decode_32k cells of
      mamba2-130m and hymba-1.5b, whose decode steps leave the layers in
      their FSDP shards and move the tokens: all exit 0 on the card's
      torch, each printing its FLOPs, collective bytes and trace seconds
      beside the committed artifact's;
   d. ``repro_torch.launch.train --production`` at one rank raises,
      naming the 256 ranks it needs;
   e. ``repro_torch.launch.roofline`` prices every committed dry-run cell
      beside the reference's (``chiprun_out/roofline.md``, with the card's
      name and power limit), and each step 5b measured takes at least 0.95
      of the larger of the compute and memory terms that its counted FLOPs
      and bytes give at the module's rates.
6. The examples, as a user runs them on the card:
   ``examples/serve_batched_torch.py`` (a lazy checkpoint restore, 8
   requests through ``Session.serve``), ``examples/train_lm_torch.py``
   (the train driver, 200 steps, the loss must fall),
   ``examples/quickstart_torch.py`` (its sums and products equal numpy's)
   and ``examples/active_learning_torch.py`` (the surrogate a tensor on the
   card, proxied through the store; the same candidates and scores as the
   same loop on the CPU).

7. The data plane (``phase_data_plane``): a 16 MB bfloat16 tensor on the
   card and on the host, and the same values in float32, through
   ``serialize``/``deserialize``: an ``nd`` leaf of token "bfloat16" whose
   buffer is the host tensor's bytes (its own memory on the CPU), decoded
   as a CPU ``torch.bfloat16`` tensor equal bit for bit; host microseconds
   beside ``pickle_serializer``'s; through a shared-memory ``ResultStore``,
   copies per byte equal to float32's at the same bytes, decoded over the
   store's mapping.

Each part prints its own seconds and the run's so far.  The last lines
are the ``kernels`` JSON object (launches summed over the serve paths), the
card's name and power limit, and ``{"ok": true, "device": {...}}``.  Needs the repository's
``src/`` beside this file and a CUDA device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 CUDA cores, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# (B, H, KV, Sq, Skv, hd, causal): the kernel test shapes of the JAX package
FA_SHAPES = [
    (1, 4, 4, 64, 64, 32, True),
    (1, 4, 2, 64, 64, 32, True),
    (2, 8, 1, 96, 96, 64, True),
    (1, 4, 4, 33, 33, 16, True),
    (1, 2, 2, 128, 256, 64, False),
    (1, 2, 1, 8, 512, 128, False),
    (1, 16, 4, 160, 160, 128, True),
]
# Kernel against plain version: elementwise |out - ref| <= tol + tol * |ref|
# (the JAX kernel sweep's tolerances), and for every query row the relative
# L2 error over (B, H, hd) within ROW_REL_TOL, so that a fault confined to a
# few late rows, whose outputs are small, cannot hide under the first limit.
# float16's limits are a quarter of bfloat16's: its 10-bit mantissa rounds P
# and the output 8x finer than bfloat16's 7 bits, the same products else
TOL = {"float32": 2e-4, "bfloat16": 2e-2, "float16": 5e-3}
ROW_REL_TOL = {"float32": 1e-4, "bfloat16": 1e-2, "float16": 2.5e-3}
# hymba-1.5b's serving prefill in its three global layers: 25 q heads in 5
# groups of 5 (an odd group), hd 64, built as the model's strided views
FA_HYMBA = (4, 25, 5, 2048, 2048, 64, True)
# kimi-k2's serving prefill: 64 q heads in 8 groups of 8, hd 128
FA_KIMI = (4, 64, 8, 1024, 1024, 128, True)
# whisper-tiny's serving prefill: the encoder's 1500 frames, non-causal, so
# every q tile meets a ragged last kv tile of 92 keys (1500 = 11 * 128 + 92);
# the decoder's 224-token prompt, causal; 6 heads of 64, G = 1
FA_WHISPER_ENC = (4, 6, 6, 1500, 1500, 64, False)
FA_WHISPER_DEC = (4, 6, 6, 224, 224, 64, True)
# the serving prefills of the other dense archs, hd 128: phi4-mini-3.8b's 24
# q heads in groups of 3, internvl2-2b's 16 in groups of 2, starcoder2-15b's
# 48 in groups of 12, and granite-20b's 48 on one K/V head (MQA, G = 48),
# whose K/V views have a head dim of length 1
FA_PHI4 = (4, 24, 8, 1024, 1024, 128, True)
FA_INTERNVL2 = (4, 16, 8, 1024, 1024, 128, True)
FA_STARCODER2 = (4, 48, 4, 1024, 1024, 128, True)
FA_GRANITE = (4, 48, 1, 1024, 1024, 128, True)
# bf16 shapes at the wgmma + TMA kernel's edges, beside the sweep above:
# Sq and Skv off its 128-row tiles, one q row against many keys, the 32 B
# and 64 B swizzles (hd 16, 32), and the models' prefills; the first and the
# prefills are built as the model's strided views
FA_BF16_EDGES = [
    (2, 16, 2, 1000, 1000, 128, True),
    (1, 8, 1, 1, 1024, 128, False),
    (1, 4, 4, 300, 300, 16, True),
    (1, 4, 2, 300, 300, 32, True),
    FA_HYMBA,
    FA_KIMI,
    FA_WHISPER_ENC,
    FA_WHISPER_DEC,
    FA_PHI4,
    FA_INTERNVL2,
    FA_STARCODER2,
    FA_GRANITE,
]
# prefills of FA_BF16_EDGES, where the planted faults must be rejected too,
# timed beside SDPA, by the name of their model
FA_PREFILLS = {FA_HYMBA: "hymba", FA_KIMI: "kimi", FA_WHISPER_ENC: "whisper_encoder",
               FA_WHISPER_DEC: "whisper_decoder", FA_PHI4: "phi4", FA_INTERNVL2: "internvl2",
               FA_STARCODER2: "starcoder2", FA_GRANITE: "granite"}
FAULT_TILE = 128  # keys per K/V tile of the 16-bit kernel (64 at hd 256: kKeys)
# K1's contract past the models above (``kernel.HEAD_DIMS``, ``kernel_route``):
# public models' prefills at head dims 80, 96 and 256, qwen2.5-3b's in
# float16, a head dim the wrapper pads (112 -> 128) at qwen's heads, and the
# first three in float32.  (B, H, KV, S, hd) and dtype; each runs on the
# model's views causal (timed, faults planted) and non-causal (faults) and
# on contiguous inputs both ways
FA_CONTRACT = {
    "phi-2 hd 80": ((4, 32, 32, 1024, 80), torch.bfloat16),
    "phi-3-mini hd 96": ((4, 32, 32, 1024, 96), torch.bfloat16),
    "gemma-2-2b hd 256": ((4, 8, 4, 1024, 256), torch.bfloat16),
    "qwen2.5-3b float16": ((4, 16, 2, 1024, 128), torch.float16),
    "qwen heads hd 112, padded to 128": ((4, 16, 2, 1024, 112), torch.bfloat16),
    "phi-2 hd 80 float32": ((4, 32, 32, 1024, 80), torch.float32),
    "phi-3-mini hd 96 float32": ((4, 32, 32, 1024, 96), torch.float32),
    "gemma-2-2b hd 256 float32": ((4, 8, 4, 1024, 256), torch.float32),
    # past 256, the wide kernel (``fa_fwd_wide``) at Gemma-2-2B's heads: head
    # dims 320, 384 and 512 and a ragged 300, in every dtype
    **{f"gemma-2-2b heads hd {hd} {str(dtype).split('.')[-1]}": ((4, 8, 4, 1024, hd), dtype)
       for hd in (300, 320, 384, 512)
       for dtype in (torch.bfloat16, torch.float16, torch.float32)},
}
# deepseek-v2-lite's serving prefill on K1 (``attention._mla_flash``): 16
# heads, each its own K/V head, q . k at nope 128 + rope 64 = 192, v's 128
# zero-padded to 192 by the model, the wrapper's pad to the hd-256 instance,
# and YaRN's softmax scale, 192 ** -0.5 * (0.1 * 0.707 * ln 40 + 1) ** 2 (the
# published config's factor 40 and mscale_all_dim 0.707):
# (B, H, KV, S, hd, v's width, scale)
FA_MLA = (4, 16, 16, 1024, 192, 128, 192 ** -0.5 * (0.1 * 0.707 * math.log(40) + 1) ** 2)
# hymba-1.5b's windowed prefill as its benchmark cell runs it (hymba-longdoc-
# closed: batch 8, prompts of 4096, four times its window of 1024 keys; 25 q
# heads in 5 groups, hd 64) on the band kernel: (B, H, KV, S, hd, window)
FA_WINDOW = (8, 25, 5, 4096, 64, 1024)
# the window in the other dtypes and on the wide kernel, one shape each:
# (B, H, KV, S, hd, window) and dtype
FA_WINDOW_CONTRACT = {
    "hymba windowed float16": (FA_WINDOW, torch.float16),
    "hymba windowed float32": ((2, 25, 5, 2048, 64, 1024), torch.float32),
    "gemma-2-2b heads hd 320 windowed": ((2, 8, 4, 2048, 320, 512), torch.bfloat16),
}
# windows at and below the kernel's 128-key tile (64 at hd 256), where whole
# tiles are skipped and a row's first tile holds none of its keys, over a
# ragged 1000 rows: (B, H, KV, S, hd, window), bf16
FA_WINDOW_EDGES = [(1, 10, 2, 1000, 64, w) for w in (1, 17, 64, 100, 128, 129, 300)] + [
    (1, 8, 4, 1000, 256, 40), (1, 8, 4, 1000, 256, 64), (1, 16, 2, 1000, 128, 200),
    (2, 6, 6, 1000, 80, 150)]
# every head dim the wrapper takes past the old four (instances, pads and
# the wide kernel) x {float32, bfloat16, float16} x causal / non-causal, at
# a ragged 300 rows
FA_CONTRACT_HDS = (72, 80, 96, 112, 160, 256, 300, 320, 384, 512)
# Full-width bf16 forward: over every block of FORWARD_BLOCK tokens, the
# flash path's relative L2 distance from an f32-compute forward is at most
# FORWARD_NOISE times the reference path's
FORWARD_BLOCK = 32
FORWARD_NOISE = 1.25
# Planted faults each check must reject: a kernel that ignores the causal
# mask, and one that skips the last kv tile of the sequence; at a non-causal
# call, one that applies the causal mask in place of the first
FAULTS = ("non-causal", "last kv tile skipped")
NON_CAUSAL_FAULTS = ("causal mask applied", "last kv tile skipped")
# ... and at a call with a sliding window, one that ignores the window
WINDOW_FAULTS = ("window ignored", "last kv tile skipped")
SERVE_ARGS = ["--arch", "qwen2.5-3b", "--batch", "4", "--prompt-len", "1024",
              "--gen", "32", "--requests", "8", "--device", "cuda"]
# Serve paths: each kernel's launches a prefill, exactly; any other kernel 0
SERVE_LAUNCHES = {
    "qwen2.5-3b": {"flash_attention": 36},                # every layer's prompt attention
    "mamba2-130m": {"ssd_scan": 24},                      # every layer's SSD scan
    "hymba-1.5b": {"flash_attention": 32, "ssd_scan": 32},  # every layer, 29 windowed
    "kimi-k2-1t-a32b": {"flash_attention": 2},            # both layers' prompt attention
    "deepseek-v2-lite-16b": {"flash_attention": 27},      # every layer's MLA prefill
    "whisper-tiny": {"flash_attention": 8},               # 4 encoder + 4 decoder layers
    "phi4-mini-3.8b": {"flash_attention": 32},            # every layer's prompt attention
    "internvl2-2b": {"flash_attention": 24},
    "starcoder2-15b": {"flash_attention": 40},
    "granite-20b": {"flash_attention": 52},
}

# (B, S, H, P, N, chunk): the SSD kernel test shapes of the JAX package
SSD_SHAPES = [
    (1, 64, 2, 16, 8, 16),
    (2, 100, 3, 32, 16, 32),
    (1, 256, 1, 64, 128, 128),
    (1, 33, 2, 16, 16, 64),
    (2, 128, 4, 64, 16, 32),
]
# SSD kernel against the sequential recurrence: elementwise on y and on the
# final state (the JAX sweep's tolerances), and for every time step the
# relative L2 error of y over (B, H, P), so that a fault confined to a few
# steps (a chunk boundary, the first steps) cannot hide under the first limit
# float16 runs the f32 kernel on widened inputs, so only y's rounding to
# float16 differs from float32's contract: a quarter of bfloat16's limits
SSD_TOL = {"float32": 5e-4, "bfloat16": 3e-2, "float16": 5e-3}
SSD_STEP_REL_TOL = {"float32": 1e-4, "bfloat16": 1e-2, "float16": 2.5e-3}
SSD_CHUNK = 128  # mamba2-130m's chunk: the model check's block of tokens
# hymba-1.5b's serving prefill: 25 heads, N = 16 (the kernel stages 128 state
# columns, so seven eighths of them are zero padding), B and C broadcast
SSD_HYMBA = (4, 2048, 25, 64, 16, True)
# bf16 shapes at the tensor-core kernel's edges, at mamba2-130m's width
# (B, S, H, P, N, B/C head-broadcast): ragged S, S below one chunk, and B/C
# not broadcast; then hymba's prefill
SSD_BF16_EDGES = [
    (2, 1000, 24, 64, 128, True),
    (4, 37, 24, 64, 128, True),
    (2, 256, 24, 64, 128, False),
    SSD_HYMBA,
]
# K2's contract past the models above (``kernel.sub_chunks``,
# ``state_tiles``): mamba2-130m's prefill at mamba_ssm's default chunk of
# 256, at a state of 256 columns (two tiles and the tile sum), and in
# float16, then the first two and all three together in the other dtypes;
# past 256, a chunk of 512 (four sub-chunks) and states of 320 and 384
# columns (three tiles), each in every dtype.  ((B, S, H, P, N), chunk,
# dtype); each runs on the model's head-broadcast B and C (timed, faults
# planted) and on B and C per head
MAMBA_UPSTREAM_CHUNK = 256  # mamba_ssm's Mamba2 default chunk_size
SSD_CONTRACT = {
    "mamba2-130m chunk 256": ((4, 1024, 24, 64, 128), 256, torch.bfloat16),
    "mamba2-130m N = 256": ((4, 1024, 24, 64, 256), 128, torch.bfloat16),
    "mamba2-130m float16": ((4, 1024, 24, 64, 128), 128, torch.float16),
    "mamba2-130m chunk 256 float32": ((4, 1024, 24, 64, 128), 256, torch.float32),
    "mamba2-130m N = 256 float32": ((4, 1024, 24, 64, 256), 128, torch.float32),
    "mamba2-130m chunk 256, N = 256, float16": ((4, 1024, 24, 64, 256), 256, torch.float16),
    **{f"mamba2-130m {what} {str(dtype).split('.')[-1]}": ((4, 1024, 24, 64, N), chunk, dtype)
       for what, N, chunk in (("chunk 512", 128, 512), ("N = 320", 320, 128),
                              ("N = 384", 384, 128))
       for dtype in (torch.bfloat16, torch.float32, torch.float16)},
}
# (N, chunk) at a ragged 300 steps in every dtype: a ragged second state tile
# (200), two tiles, the sub-chunks at ragged lengths, and past 256
SSD_CONTRACT_SWEEP = [(128, 256), (200, 128), (200, 256), (256, 128), (256, 256),
                      (128, 512), (320, 128), (384, 512)]
# the f32 kernel at a chunk of 512 against a float64 run of the plain
# version: no further from it than F64_NOISE times the plain chunked form in
# f32 at that chunk (``rounding.chunked``: the JAX kernel's arithmetic at
# the call's chunk).  The sequential f32 recurrence is several times closer
# to the float64 run than any chunked form, the JAX kernel's included
# (scripts/ssd_chunk_error.py), so it bounds no chunked kernel; its distance
# and the chunked form's at the kernel's 128-row sub-chunks are printed beside
SSD_F64_CASE = "mamba2-130m chunk 512 float32"
F64_NOISE = 1.25
# Planted faults the SSD checks must reject (each built from wrapper calls)
SSD_FAULTS = ("state not carried across chunks", "initial state ignored",
              "final state dropped")
MAMBA_SERVE_ARGS = ["--arch", "mamba2-130m", "--batch", "4", "--prompt-len", "1024",
                    "--gen", "32", "--requests", "8", "--device", "cuda"]
# hymba-1.5b: a prompt of twice its window (1024), so the window changes the
# prefill and the local layers' rings keep only the prompt's tail; the
# decode writes past the rings' end
HYMBA_PROMPT = 2048
HYMBA_SERVE_ARGS = ["--arch", "hymba-1.5b", "--batch", "4", "--prompt-len", str(HYMBA_PROMPT),
                    "--gen", "32", "--requests", "8", "--device", "cuda"]
HYMBA_STEPS = 8  # decode steps of the full-width model check, after a 2048-token prefill
# Planted in the full-width hymba run, each with the check that must see it
HYMBA_FAULTS = {"non-causal": "forward", "state not carried across chunks": "forward",
                "ring write stops at the last slot": "ring"}
# Config cuts at full width, for the archs whose f32 params do not fit one
# card beside what the checks run.  kimi-k2: 61 layers cut to 2 (the leading
# dense layer and one MoE layer, whose 384 experts alone are 16.9e9
# parameters) and bf16 params: 19,967,675,392 params with the norms' scales,
# 39.9 GB, where an f32 tree would be 79.9 GB.  deepseek-v2-lite (62.8 GB
# f32), starcoder2-15b (63.8 GB f32) and granite-20b (112.7 GB f32): all
# their layers, bf16 params
CONFIG_CUTS = {"kimi-k2-1t-a32b": {"num_layers": 2, "param_dtype": torch.bfloat16},
               "deepseek-v2-lite-16b": {"param_dtype": torch.bfloat16},
               "starcoder2-15b": {"param_dtype": torch.bfloat16},
               "granite-20b": {"param_dtype": torch.bfloat16}}
KIMI_SERVE_ARGS = ["--arch", "kimi-k2-1t-a32b", "--batch", "4", "--prompt-len", "1024",
                   "--gen", "32", "--requests", "8", "--device", "cuda"]
DEEPSEEK_SERVE_ARGS = ["--arch", "deepseek-v2-lite-16b", "--batch", "4", "--prompt-len",
                       "1024", "--gen", "32", "--requests", "8", "--device", "cuda"]
# the dense archs beside qwen2.5-3b, served and checked at full width and depth
DENSE_ARCHS = ("phi4-mini-3.8b", "internvl2-2b", "starcoder2-15b", "granite-20b")
DENSE_SERVE_ARGS = {arch: ["--arch", arch, "--batch", "4", "--prompt-len", "1024", "--gen",
                           "32", "--requests", "8", "--device", "cuda"] for arch in DENSE_ARCHS}
# the EP form at ep = 1 against the dense form at kimi's width: at S = 1024
# this factor makes the capacity ceil(1024 * 8 / 384 * 48) = 1024 = N, so
# no token is dropped
EP_CAPACITY_FACTOR = 48
DEEPSEEK_STEPS = 4  # decode steps of the full-width check, after a 1024-token prefill
# planted in deepseek's absorbed run; the prefill check must see it
LATENT_FAULT = "latent cache written one slot late"
# whisper-tiny at full width, nothing cut: B requests of the encoder's 1500
# frames and a 224-token prompt (whisper conditions on at most half its
# 448-token context of previous text), WHISPER_STEPS decode steps in the
# model check, WHISPER_GEN greedy tokens a request in the serve loop
WHISPER_BATCH = 4
WHISPER_PROMPT = 224
WHISPER_STEPS = 8
WHISPER_GEN = 32
# Planted in the full-width whisper run, each with the check that must see it
WHISPER_FAULTS = {"encoder attention run causal": "encoder",
                  "last kv tile skipped": "encoder",
                  "prefill leaves init_cache's zeros in the cross K/V": "decode"}
# its train step at full width: batch, target tokens, steps
WHISPER_TRAIN = (8, 448, 3)
# Phase 4: the train driver at full mamba2-130m width (the JAX driver's own
# default arch, batch and seq), then a restart to RESTART_STEPS
TRAIN_ARGS = ["--arch", "mamba2-130m", "--batch", "8", "--seq", "256", "--steps", "30",
              "--ckpt-every", "10", "--log-every", "1", "--connector", "sharded",
              "--device", "cuda"]
RESTART_STEPS = 40
# One step on the card against the CPU, f32 compute: loss and grad norm
# (relative), every leaf's first moment (relative L2); bf16 compute's loss
# against the f32 loss (relative)
TRAIN_RTOL = 1e-4
MOMENT_REL_L2 = 1e-4
# 4c's other archs, one step each at the smoke config, card against CPU:
# every decoder family (dense with its variants, VLM, hybrid, MoE with MLA)
TRAIN_CHECK_ARCHS = ("qwen2.5-3b", "hymba-1.5b", "kimi-k2-1t-a32b", "deepseek-v2-lite-16b",
                     "phi4-mini-3.8b", "internvl2-2b", "starcoder2-15b", "granite-20b")
TRAIN_CHECK_BATCH = (2, 64)  # past hymba's smoke window of 16
BF16_LOSS_REL = 2e-2
LOSS_FALL = 0.01  # five steps on one batch must cut the loss by at least 1 %
# qwen2.5-3b at full width: batch, seq, steps
DENSE_TRAIN = (2, 1024, 3)

# Fingerprint inputs made with numpy from a seed (``fp_golden_array``), each
# with the token the JAX package gives it
# (``repro.kernels.fingerprint.ops.fingerprint_token`` on the CPU; the tests
# regenerate every entry against JAX and the port).  (kind, shape, seed,
# token): kind is a numpy dtype, "bfloat16" (values stored as their bits) or
# "float32.T" (a transposed, non-contiguous float32 array).  The 64-bit
# kinds are narrowed to 32 bits before hashing, as JAX narrows them.
FP_GOLDEN = [
    ("uint8", (1,), 0, "f0f3fb00a8105be0"),
    ("uint8", (64,), 1, "13ef863a5afd1781"),
    ("uint8", (4095,), 2, "638b75fad1af73c4"),
    ("uint8", (4096,), 3, "3e1aa25841c3e8c4"),
    ("uint8", (4097,), 4, "80b09d92ecb09e39"),
    ("uint8", (100_000,), 5, "978ab9718a4bbdb1"),
    ("uint8", (2**20 + 3,), 6, "e794d481e7f63811"),
    ("float32", (257, 33), 7, "70fe580bbb449dee"),
    ("float16", (3, 1001), 8, "d22634507b29eb5d"),
    ("bfloat16", (2049,), 9, "20b3e36f89a9a777"),
    ("int32", (1000,), 10, "d14baab1d14566bc"),
    ("float32.T", (64, 100), 11, "fdde963718449c2a"),
    ("float64", (1000,), 12, "5a04968bc3a7ff96"),
    ("int64", (1000,), 13, "59cf30aaace3fd17"),
]
# The TMA route's stage and ring in blocks of 4096 B (TMA_ROWS and
# TMA_ROWS * TMA_STAGES in the kernel's kernel.py; check_fingerprint holds them)
FP_STAGE_BLOCKS = 2048
FP_RING_BLOCKS = 3 * 2048
# Byte lengths of the kernel-against-plain sweep: word and block edges, the
# register ring's 64 blocks, 4k+1 and 4k+3, one TMA stage and one TMA ring of
# blocks (each -1, +0 and +1 block, and +1 byte), and up to 64 MiB
FP_LENGTHS = [1, 2, 3, 4, 5, 7, 63, 64, 65, 4093, 4095, 4096, 4097, 4099, 8191, 8192, 8193,
              4 * 12_345 + 1, 4 * 12_345 + 3, 64 * 4096 - 1, 64 * 4096, 64 * 4096 + 1,
              129 * 4096 + 5,
              *(4096 * (blocks + d) for blocks in (FP_STAGE_BLOCKS, FP_RING_BLOCKS)
                for d in (-1, 0, 1)),
              4096 * FP_STAGE_BLOCKS + 1, 4096 * FP_RING_BLOCKS + 1,
              2**20 + 3, 2**24 + 1, 2**26 - 1, 2**26]
# byte offsets of the sweep's views: 0 takes the TMA route (a 16-byte-aligned
# start); 1-3 (off a word) and 4, 8, 12 (on a word, off 16 bytes) the
# register-ring route
FP_OFFSETS = (0, 1, 2, 3, 4, 8, 12)
FP_FLIP_BYTES = 1 << 30  # the bit-flip buffer
# H100 SXM: 132 SMs x 64 INT32 lanes (Hopper white paper) at the 1.98 GHz
# boost clock, one operation a lane a cycle
PEAK_INT32_OPS = 132 * 64 * 1.98e9
# cycles of one dependent step of a lane's chain, IMAD then LOP3, as the
# kernel runs it on the H100: the TMA route's layout comparison
# (kernels/fingerprint/bench.py) reads 10.5 with its tallest stages, of which
# a few hundred cycles a stage are not the chain's; the leaves' lines print
# the measured cycles
FP_CHAIN_CYCLES = 10


# phase 5: pinned digests (sha256 of q's then the scales' bytes, first 16 hex
# digits) of the JAX package's quantize_int8 on ``compress_golden_array``'s
# inputs; tests/test_torch_compression.py regenerates them against both
COMPRESS_GOLDEN = [
    ("normal", 1, 0, "781ced082650a63f"),
    ("normal", 255, 1, "79a3040e1ffdf481"),
    ("normal", 4097, 2, "21379aa24f10568a"),
    ("normal", 1048576, 3, "50aef41f4394593c"),
    ("ties", 1000, 4, "3074a6d3e8deebbc"),
    ("ties", 65536, 5, "6859f24ac0279a85"),
    ("mixed", 1000, 6, "6fbd5a7b9e2851f4"),
    ("mixed", 100003, 7, "eb9dcd346f5bb86a"),
]
COMPRESS_STEPS = 20          # error-feedback steps on one fixed gradient
CODEC_PAYLOAD_SHARE = 0.26   # the codec's payload at most this share of the f32 bytes
# the dry-run CLI on the card's host: (arch, shape, mesh, ranks, must show an all-to-all)
DRYRUN_CELLS = [("qwen2.5-3b", "decode_32k", "single", 256, False),
                ("deepseek-v2-lite-16b", "prefill_32k", "multi", 512, True),
                ("mamba2-130m", "decode_32k", "single", 256, False),
                ("hymba-1.5b", "decode_32k", "single", 256, False)]
DRYRUN_OUT = ROOT / "chiprun_out" / "dryrun_torch"  # the card's cells; the committed stay
ROOFLINE_FLOOR = 0.95        # a measured step at least this share of its roofline bound
DRYRUN_TIMEOUT = 600
ARG_BYTES_TOL = 0.01         # predicted argument bytes against the allocator's growth
PHASE5_SECONDS = 120
# phase 7: the data plane's tensor, 16 MB in bfloat16, and the calls each
# host time is the mean of
DATA_PLANE_SHAPE = (4096, 2048)
DATA_PLANE_CALLS = 10
# the active-learning example on the card against the CPU: the same f32
# products summed in another order, so the scores' rounding is absolute
EXAMPLE_SCORE_RTOL, EXAMPLE_SCORE_ATOL = 1e-5, 1e-5


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def gpu_query(fields: str, units: bool = True) -> str:
    fmt = "csv,noheader" + ("" if units else ",nounits")
    res = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", f"--format={fmt}"],
        capture_output=True, text=True, timeout=60,
    )
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def gpu_name_and_limit() -> str:
    return gpu_query("name,power.limit")


def time_ms(fn, iters: int = 20, warmup: int = 3, card_only: bool = False) -> float:
    """Event time per call of ``fn`` over ``iters`` calls issued back to
    back: a call shorter than its host cost is timed at the host's rate.
    With ``card_only`` the card first sleeps about 25 ms while the host
    enqueues the calls, so the events time the card's work alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if card_only:
        torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(out, ref, dname: str) -> tuple[float, float, bool, bool]:
    """Max abs error and worst per-row relative L2 error of (B, H, Sq, hd)
    outputs, and whether each is within its limit."""
    out, ref = out.float(), ref.float()
    diff = out - ref
    err = diff.abs().max().item()
    within = bool((diff.abs() <= TOL[dname] + TOL[dname] * ref.abs()).all())
    rows = lambda t: t.movedim(2, 0).reshape(t.shape[2], -1)  # noqa: E731
    row_rel = (rows(diff).norm(dim=1) / rows(ref).norm(dim=1).clamp_min(1e-30)).max().item()
    return err, row_rel, within, row_rel <= ROW_REL_TOL[dname]


def plant_fault(flash, fault: str, q_axis: int):
    """``flash(q, k, v, causal=...)`` with a fault planted: the causal mask
    (and any window) ignored, the causal mask applied to every call, the
    window ignored, or the last kv tile skipped (its rows then see only the
    keys before it, window or none).  ``q_axis`` is the sequence axis of q,
    k and v; other keywords (``scale``, ``window``) pass through."""

    def faulty(q, k, v, *, causal, **kw):
        unmasked = {key: val for key, val in kw.items() if key != "window"}
        if fault == "non-causal":
            return flash(q, k, v, causal=False, **unmasked)
        if fault == "causal mask applied":
            return flash(q, k, v, causal=True, **kw)
        if fault == "window ignored":
            return flash(q, k, v, causal=causal, **unmasked)
        t = q.shape[q_axis] - FAULT_TILE
        head = lambda x, a, b: x.narrow(q_axis, a, b - a)  # noqa: E731
        out = flash(q, k, v, causal=causal, **kw).clone()
        tail = flash(head(q, t, q.shape[q_axis]), head(k, 0, t), head(v, 0, t), causal=False,
                     **unmasked)
        head(out, t, q.shape[q_axis]).copy_(tail)
        return out

    return faulty


def build_kernels() -> None:
    """Build every kernel library, one ``nvcc`` per source, all at once."""
    from repro_torch.kernels.fingerprint import kernel as fp_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel

    def timed_build(mod):
        t0 = time.perf_counter()
        return mod.build(), time.perf_counter() - t0

    mods = {"flash_attention": fa_kernel, "ssd_scan": ssd_kernel, "fingerprint": fp_kernel}
    with ThreadPoolExecutor(len(mods)) as pool:
        futures = {name: pool.submit(timed_build, mod) for name, mod in mods.items()}
    for name, mod in mods.items():
        lib, secs = futures[name].result()  # a failed build raises here
        print(f"[build] {lib.name} in {secs:.1f}s")
        for line in mod.build_log.splitlines():
            if "Used" in line or "spill" in line or "entry function" in line:
                print(f"[ptxas] {name}: {line.strip()}")


def phase_kernels(gen) -> list[dict]:
    build_kernels()
    return [check_flash(gen), check_ssd(gen), check_fingerprint(gen)]


def check_flash(gen) -> dict:
    from repro_torch.kernels.flash_attention.kernel import tma_ready
    from repro_torch.kernels.flash_attention.ops import flash_attention_gqa
    from repro_torch.kernels.flash_attention.ref import attention_ref

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def model_views(B, H, KV, Sq, Skv, hd, dtype):
        """q, k and v as the model hands them to the kernel: views of
        (B, S, KV, G, hd) and (B, S, KV, hd), permuted and transposed."""
        q = randn(B, Sq, KV, H // KV, hd, dtype=dtype).permute(0, 2, 3, 1, 4)
        k = randn(B, Skv, KV, hd, dtype=dtype).transpose(1, 2)
        v = randn(B, Skv, KV, hd, dtype=dtype).transpose(1, 2)
        return q.reshape(B, H, Sq, hd), k, v

    def contiguous(B, H, KV, Sq, Skv, hd, dtype):
        return (randn(B, H, Sq, hd, dtype=dtype), randn(B, KV, Skv, hd, dtype=dtype),
                randn(B, KV, Skv, hd, dtype=dtype))

    def held(label, dname, q, k, v, causal, scale=None):
        """The kernel against the plain version, within TOL and ROW_REL_TOL;
        returns the max abs error and the plain version's output."""
        out = flash_attention_gqa(q, k, v, causal=causal, scale=scale)
        torch.cuda.synchronize()
        ref = attention_ref(q, k, v, causal=causal, scale=scale)
        torch.cuda.synchronize()
        if out.shape != ref.shape or out.dtype != ref.dtype:
            fail(f"flash {label} {dname}: {out.shape}/{out.dtype} vs {ref.shape}/{ref.dtype}")
        err, row_rel, *oks = compare(out, ref, dname)
        print(f"[flash] {dname} {label} max_abs_err {err:.3e} (tol {TOL[dname]}) "
              f"row rel_l2 {row_rel:.3e} (tol {ROW_REL_TOL[dname]})")
        if not all(oks):
            fail(f"flash {label} {dname}: kernel disagrees with the plain version")
        return err, ref

    def faults_rejected(q, k, v, causal, ref, dname="bfloat16", scale=None):
        """Each planted fault of a causal (FAULTS) or non-causal
        (NON_CAUSAL_FAULTS) call must fail ``compare``."""
        for fault in FAULTS if causal else NON_CAUSAL_FAULTS:
            bad = plant_fault(flash_attention_gqa, fault, 2)(q, k, v, causal=causal, scale=scale)
            b_err, b_row, b_within, b_row_ok = compare(bad, ref, dname)
            verdict = lambda ok: "passed" if ok else "rejected"  # noqa: E731
            print(f"[flash] planted fault '{fault}': max_abs_err {b_err:.3e} "
                  f"({verdict(b_within)}) row rel_l2 {b_row:.3e} ({verdict(b_row_ok)})")
            if b_within and b_row_ok:
                fail(f"the kernel check does not see the planted fault '{fault}'")

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for shape in FA_SHAPES:
            held(shape, dname, *contiguous(*shape[:6], dtype), shape[6])
    bf16 = torch.bfloat16
    prefills = {}
    for i, shape in enumerate(FA_BF16_EDGES):
        make = model_views if i == 0 or shape in FA_PREFILLS else contiguous
        qkv = make(*shape[:6], bf16)
        err, ref = held(shape, "bfloat16", *qkv, shape[6])
        if shape in FA_PREFILLS:
            name = FA_PREFILLS[shape]
            if not all(tma_ready(t) for t in qkv):
                fail(f"{name}'s strided views would be copied before the kernel")
            faults_rejected(*qkv, shape[6], ref)
            t = prefills[name] = {"shape": shape, "max_abs_err": err,
                                  **flash_times(*qkv, causal=shape[6])}
            print(f"[flash] {name} prefill {shape}: kernel {t['ms']:.4f} ms | card only "
                  f"{t['card_ms']:.4f} ms | plain {t['plain_ms']:.4f} ms | sdpa "
                  f"{t['library_ms']:.4f} ms (card only {t['card_library_ms']:.4f} ms) | "
                  f"bound {t['bound_ms']:.4f} ms ({t['flops']:.4e} FLOP, {t['bytes']} B)")
        del qkv, ref
    # a base 2 bytes off a 16-byte boundary: TMA cannot read it, so the
    # wrapper copies it to a contiguous tensor first
    B, H, KV, S, hd = 1, 4, 2, 256, 64
    q = randn(B * H * S * hd + 1, dtype=bf16)[1:].view(B, H, S, hd)
    k, v = contiguous(B, H, KV, S, S, hd, bf16)[1:]
    if tma_ready(q):
        fail("a q 2 bytes off a 16-byte boundary passes as TMA-ready")
    held(f"{(B, H, KV, S, S, hd, True)} q off a 16-byte boundary", "bfloat16", q, k, v, True)
    # P read back: with V the identity (Skv = hd), O is the normalised P
    # itself, so a fault in P's register layout shows row by row
    B, H, KV, S, hd = 1, 4, 2, 128, 128
    q, k, _ = contiguous(B, H, KV, S, S, hd, bf16)
    eye = torch.eye(hd, device="cuda", dtype=bf16).expand(B, KV, hd, hd)
    held(f"{(B, H, KV, S, S, hd, False)} V = identity", "bfloat16", q * 3, k, eye, False)

    # qwen2.5-3b serving prefill: q/k/v reach the kernel as the model's
    # transposed views of (B, S, KV, G, hd) and (B, S, KV, hd)
    B, H, KV, S, hd = 4, 16, 2, 1024, 128
    G = H // KV
    q, k, v = model_views(B, H, KV, S, S, hd, bf16)
    if not all(tma_ready(t) for t in (q, k, v)):
        fail("the model's strided views would be copied before the kernel")
    out = flash_attention_gqa(q, k, v, causal=True)
    torch.cuda.synchronize()
    ref = attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    err, row_rel, *oks = compare(out, ref, "bfloat16")
    print(f"[flash] prefill bf16 (B={B}, H={H}, KV={KV}, S={S}, hd={hd}, causal) "
          f"max_abs_err {err:.3e} (tol {TOL['bfloat16']}) "
          f"row rel_l2 {row_rel:.3e} (tol {ROW_REL_TOL['bfloat16']})")
    if not all(oks):
        fail("flash prefill geometry: kernel disagrees with the plain version")
    faults_rejected(q, k, v, True, ref)

    times = flash_times(q, k, v)
    k_rep = k.repeat_interleave(G, dim=1)
    v_rep = v.repeat_interleave(G, dim=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_err = (sdpa(q, k_rep, v_rep, is_causal=True).float() - ref.float()).abs().max().item()
    print(f"[flash] sdpa yardstick max_abs_err vs plain {lib_err:.3e}")
    del k_rep, v_rep
    q32, k32, v32 = (t.float() for t in (q, k, v))
    f32_ms = time_ms(lambda: flash_attention_gqa(q32, k32, v32, causal=True))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):  # the host's cost of a call: checks, tensor maps, launch
        flash_attention_gqa(q, k, v, causal=True)
    host_us = (time.perf_counter() - t0) * 1e4
    torch.cuda.synchronize()
    print(f"[flash] prefill: kernel {times['ms']:.4f} ms | plain {times['plain_ms']:.4f} ms | "
          f"sdpa {times['library_ms']:.4f} ms | bound {times['bound_ms']:.4f} ms "
          f"({times['flops']:.4e} FLOP, {times['bytes']} B) | f32 scalar kernel {f32_ms:.4f} ms"
          f" | wrapper host time {host_us:.1f} us a call | card only (card slept first): kernel "
          f"{times['card_ms']:.4f} ms, sdpa {times['card_library_ms']:.4f} ms")
    del q, k, v, ref, q32, k32, v32
    contract = check_flash_contract(contiguous, model_views, held, faults_rejected)
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:105",
        "launches": 0,
        "max_abs_err": err,
        **{key: times[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        **prefills,
        "contract": contract,
    }


def check_flash_contract(contiguous, model_views, held, faults_rejected) -> dict:
    """K1 past the models' head dims and dtype (``check_flash``'s helpers):
    every head dim of FA_CONTRACT_HDS in three dtypes at a ragged length,
    V = identity at the new instances, then each FA_CONTRACT prefill on the
    model's views (TMA-ready, uncopied; the launch and any pad counted)
    causal and non-causal with the planted faults, on contiguous inputs
    both ways, and timed as the prefills are, with the wrapper's host cost
    and, for a padded head dim, the pad's own time."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.kernel import kernel_inputs, kernel_route

    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        dname = str(dtype).split(".")[-1]
        for hd in FA_CONTRACT_HDS:
            for causal in (True, False):
                shape = (2, 8, 2, 300, 300, hd, causal)
                held(shape, dname, *contiguous(*shape[:6], dtype), causal)
        if dtype != torch.float32:
            # P read back through each new V layout, and through the wide kernel
            for hd in (80, 96, 256, 300, 512):
                q, k, _ = contiguous(1, 4, 2, 128, hd, hd, dtype)
                eye = torch.eye(hd, device="cuda", dtype=dtype).expand(1, 2, hd, hd)
                held(f"{(1, 4, 2, 128, hd, hd, False)} V = identity", dname, q * 3, k, eye, False)
    contract = {}
    for name, ((B, H, KV, S, hd), dtype) in FA_CONTRACT.items():
        dname = str(dtype).split(".")[-1]
        kernel, width, padded = kernel_route(hd, dtype)
        qkv = model_views(B, H, KV, S, S, hd, dtype)
        if any(x is not y for x, y in zip(kernel_inputs(*qkv), qkv)):
            fail(f"{name}: the model's strided views would be copied before the kernel")
        n0, pads0 = _counter(fa_ops.LAUNCHES), _counter(fa_ops.PADS)
        err, ref = held(f"{name} {(B, H, KV, S, hd)} model views causal", dname, *qkv, True)
        n, pads = _counter(fa_ops.LAUNCHES) - n0, _counter(fa_ops.PADS) - pads0
        if (n, pads) != (1, int(padded)):
            fail(f"{name}: {n} launches and {pads} pads for one call (padded: {padded})")
        faults_rejected(*qkv, True, ref, dname)
        _, ref = held(f"{name} {(B, H, KV, S, hd)} model views non-causal", dname, *qkv, False)
        faults_rejected(*qkv, False, ref, dname)
        del ref
        for causal in (True, False):
            held(f"{name} {(B, H, KV, S, hd)} contiguous {'causal' if causal else 'non-causal'}",
                 dname, *contiguous(B, H, KV, S, S, hd, dtype), causal)
        t = contract[name] = {"shape": (B, H, KV, S, S, hd, True), "dtype": dname,
                              "kernel": kernel, "instance_hd": width, "padded": padded,
                              "max_abs_err": err, **flash_times(*qkv, causal=True),
                              "host_us": wrapper_host_us(lambda: fa_ops.flash_attention_gqa(*qkv)),
                              "sdpa_backend": sdpa_backend(*qkv, causal=True)}
        pad = ""
        if padded:
            t["pad_ms"] = time_ms(lambda: [torch.nn.functional.pad(x, (0, width - hd))
                                           for x in qkv])
            pad = f" | the pad of q, k and v alone {t['pad_ms']:.4f} ms"
        print(f"[flash] {name} ({kernel} at hd {width}): kernel {t['ms']:.4f} ms | card only "
              f"{t['card_ms']:.4f} ms | plain {t['plain_ms']:.4f} ms | sdpa "
              f"{t['library_ms']:.4f} ms (card only {t['card_library_ms']:.4f} ms; served by "
              f"{t['sdpa_backend']}) | bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['flops']:.4e} FLOP, {t['bytes']} B) | "
              f"wrapper host time {t['host_us']:.1f} us a call{pad}")
        del qkv
    contract["deepseek-v2-lite MLA"] = check_flash_mla(model_views, held, faults_rejected)
    contract.update(check_flash_window(contiguous, model_views))
    return contract


def check_flash_mla(model_views, held, faults_rejected) -> dict:
    """K1 at deepseek-v2-lite's MLA prefill (FA_MLA), as ``attention._mla_flash``
    calls it: the model's views of q and k, v's columns past its width zero,
    YaRN's scale passed; one launch and one pad (to the hd-256 instance) a
    call, held to the plain version at that scale causal and non-causal
    with the planted faults, v's zero columns zero in the output, and timed
    as the prefills are (the bound counts v at the padded 192)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.kernel import kernel_route

    B, H, KV, S, hd, dv, scale = FA_MLA
    bf16 = torch.bfloat16
    name = f"deepseek-v2-lite MLA {(B, H, KV, S, hd)} v {dv} scale {scale:.7f}"
    kernel, width, padded = kernel_route(hd, bf16)
    if (width, padded) != (256, True):
        fail(f"{name}: routed to hd {width}, padded {padded}; expected the pad to 256")
    q, k, v = model_views(B, H, KV, S, S, hd, bf16)
    v = torch.nn.functional.pad(v.transpose(1, 2)[..., :dv], (0, hd - dv)).transpose(1, 2)
    n0, pads0 = _counter(fa_ops.LAUNCHES), _counter(fa_ops.PADS)
    err, ref = held(f"{name} model views causal", "bfloat16", q, k, v, True, scale=scale)
    n, pads = _counter(fa_ops.LAUNCHES) - n0, _counter(fa_ops.PADS) - pads0
    if (n, pads) != (1, 1):
        fail(f"{name}: {n} launches and {pads} pads for one call")
    if bool(fa_ops.flash_attention_gqa(q, k, v, causal=True, scale=scale)[..., dv:].any()):
        fail(f"{name}: the output's columns past v's {dv} are not zero")
    faults_rejected(q, k, v, True, ref, "bfloat16", scale=scale)
    _, ref = held(f"{name} model views non-causal", "bfloat16", q, k, v, False, scale=scale)
    faults_rejected(q, k, v, False, ref, "bfloat16", scale=scale)
    del ref
    t = {"shape": (B, H, KV, S, S, hd, True), "v_width": dv, "scale": scale, "dtype": "bfloat16",
         "kernel": kernel, "instance_hd": width, "padded": padded, "max_abs_err": err,
         **flash_times(q, k, v, causal=True),
         "host_us": wrapper_host_us(lambda: fa_ops.flash_attention_gqa(q, k, v, scale=scale))}
    print(f"[flash] {name} ({kernel} at hd {width}): kernel {t['ms']:.4f} ms | card only "
          f"{t['card_ms']:.4f} ms | plain {t['plain_ms']:.4f} ms | sdpa {t['library_ms']:.4f} ms | "
          f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}: {t['flops']:.4e} FLOP, {t['bytes']} B) "
          f"| wrapper host time {t['host_us']:.1f} us a call")
    return t


def check_flash_window(contiguous, model_views) -> dict:
    """K1 with a sliding window (``fa_fwd_band``, ``window`` > 0).  At
    hymba's windowed prefill (FA_WINDOW), on the model's views: against the
    plain windowed version and against ``attention.chunked_attention`` (the
    path the band kernel replaces) within the bf16 limits, one launch and
    one window counted, WINDOW_FAULTS rejected, and timed; then
    FA_WINDOW_CONTRACT, FA_WINDOW_EDGES, and windows of at least S, which
    must equal the causal kernel bit for bit.  The plain version runs one
    batch row at a time: at FA_WINDOW its scores are 1.7 GB a row."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models.attention import chunked_attention

    flash = fa_ops.flash_attention_gqa

    def plain(q, k, v, window):
        return torch.cat([attention_ref(q[b:b + 1], k[b:b + 1], v[b:b + 1], causal=True,
                                        window=window) for b in range(q.shape[0])])

    def chunked(q, k, v, window):
        """``chunked_attention`` on the model's layout, back in (B, H, S, hd)."""
        B, H, S, hd = q.shape
        KV = k.shape[1]
        q5 = q.reshape(B, KV, H // KV, S, hd).permute(0, 3, 1, 2, 4)
        out = chunked_attention(q5, k.transpose(1, 2), v.transpose(1, 2), causal=True,
                                window=window, chunk=1024)
        return out.permute(0, 2, 3, 1, 4).reshape(B, H, S, hd)

    def held(label, dname, q, k, v, window, against=plain):
        out = flash(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        ref = against(q, k, v, window)
        torch.cuda.synchronize()
        if out.shape != ref.shape or out.dtype != ref.dtype:
            fail(f"flash {label} {dname}: {out.shape}/{out.dtype} vs {ref.shape}/{ref.dtype}")
        err, row_rel, *oks = compare(out, ref, dname)
        print(f"[flash] {dname} {label} window {window} against {against.__name__}: max_abs_err "
              f"{err:.3e} (tol {TOL[dname]}) row rel_l2 {row_rel:.3e} (tol {ROW_REL_TOL[dname]})")
        if not all(oks):
            fail(f"flash {label} window {window} {dname}: kernel disagrees with {against.__name__}")
        return err, ref

    B, H, KV, S, hd, window = FA_WINDOW
    bf16 = torch.bfloat16
    label = f"hymba windowed prefill {(B, H, KV, S, hd)}"
    qkv = model_views(B, H, KV, S, S, hd, bf16)
    n0, w0 = _counter(fa_ops.LAUNCHES), _counter(fa_ops.WINDOWS)
    err, ref = held(label, "bfloat16", *qkv, window)
    n, w = _counter(fa_ops.LAUNCHES) - n0, _counter(fa_ops.WINDOWS) - w0
    if (n, w) != (1, 1):
        fail(f"{label}: {n} launches and {w} windows for one call")
    chunked_err, _ = held(label, "bfloat16", *qkv, window, against=chunked)
    for fault in WINDOW_FAULTS:
        bad = plant_fault(flash, fault, 2)(*qkv, causal=True, window=window)
        b_err, b_row, b_within, b_row_ok = compare(bad, ref, "bfloat16")
        verdict = lambda ok: "passed" if ok else "rejected"  # noqa: E731
        print(f"[flash] planted fault '{fault}' at window {window}: max_abs_err {b_err:.3e} "
              f"({verdict(b_within)}) row rel_l2 {b_row:.3e} ({verdict(b_row_ok)})")
        if b_within and b_row_ok:
            fail(f"the window check does not see the planted fault '{fault}'")
        del bad
    del ref
    t = {"shape": FA_WINDOW, "dtype": "bfloat16", "max_abs_err": err,
         "max_abs_err_vs_chunked": chunked_err, **window_times(*qkv, window, chunked),
         "host_us": wrapper_host_us(lambda: flash(*qkv, causal=True, window=window))}
    print(f"[flash] {label} window {window} (fa_fwd_band): kernel {t['ms']:.4f} ms | card only "
          f"{t['card_ms']:.4f} ms | the causal kernel at this shape, card only "
          f"{t['card_causal_ms']:.4f} ms | chunked_attention {t['chunked_ms']:.4f} ms | sdpa with "
          f"the band as a mask {t['library_ms']:.4f} ms (card only "
          f"{t['card_library_ms']:.4f} ms) | "
          f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}: {t['flops']:.4e} FLOP, {t['bytes']} B) "
          f"| wrapper host time {t['host_us']:.1f} us a call")
    del qkv
    results = {"hymba windowed": t}
    for name, ((B, H, KV, S, hd, window), dtype) in FA_WINDOW_CONTRACT.items():
        dname = str(dtype).split(".")[-1]
        qkv = model_views(B, H, KV, S, S, hd, dtype)
        err, _ = held(f"{name} {(B, H, KV, S, hd)}", dname, *qkv, window)
        results[name] = {"shape": (B, H, KV, S, hd, window), "dtype": dname, "max_abs_err": err,
                         "card_ms": time_ms(lambda: flash(*qkv, causal=True, window=window),
                                            card_only=True)}
        print(f"[flash] {name}: card only {results[name]['card_ms']:.4f} ms")
        del qkv
    for B, H, KV, S, hd, window in FA_WINDOW_EDGES:
        held(f"{(B, H, KV, S, hd)} contiguous", "bfloat16",
             *contiguous(B, H, KV, S, S, hd, bf16), window)
    for B, H, KV, S, hd, window in ((2, 25, 5, 1000, 64, 1000), (2, 25, 5, 1000, 64, 4096),
                                    (1, 8, 4, 300, 256, 300)):
        qkv = contiguous(B, H, KV, S, S, hd, bf16)
        same = torch.equal(flash(*qkv, causal=True, window=window), flash(*qkv, causal=True))
        print(f"[flash] {(B, H, KV, S, hd)} window {window} >= S equals the causal kernel bit "
              f"for bit: {same}")
        if not same:
            fail(f"a window of {window} over {S} rows differs from the causal kernel")
    return results


def window_times(q, k, v, window: int, chunked) -> dict:
    """The windowed call's times: the kernel, then card only beside the
    causal kernel at the same shape (what the band skips), ``chunked``
    (``chunked_attention``, the path it replaces) and SDPA on K/V repeated
    over the group with the band as a boolean mask, card only too; the bound
    counts the (query, key) pairs inside the band (``chipbench.work``'s
    ``causal_pairs``)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_gqa

    B, H, S, hd = q.shape
    G = H // k.shape[1]
    kernel = lambda: flash_attention_gqa(q, k, v, causal=True, window=window)  # noqa: E731
    pos = torch.arange(S, device=q.device)
    band = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < window)
    k_rep = k.repeat_interleave(G, dim=1)
    v_rep = v.repeat_interleave(G, dim=1)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q, k_rep, v_rep, attn_mask=band)
    w = min(window, S)
    pairs = w * (w + 1) // 2 + (S - w) * w  # (q, k) pairs per (b, h)
    flops = 4 * hd * pairs * B * H
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    t_ops = flops / PEAK_FLOPS[str(q.dtype).split(".")[-1]] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return {
        "ms": time_ms(kernel),
        "card_ms": time_ms(kernel, card_only=True),
        "card_causal_ms": time_ms(lambda: flash_attention_gqa(q, k, v, causal=True),
                                  card_only=True),
        "chunked_ms": time_ms(lambda: chunked(q, k, v, window), iters=3, warmup=1),
        "library_ms": time_ms(sdpa),
        "card_library_ms": time_ms(sdpa, card_only=True),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "flops": flops,
        "bytes": nbytes,
    }


def sdpa_backend(q, k, v, causal: bool) -> str:
    """The backend SDPA dispatches these inputs to (K/V repeated over the
    group, as ``flash_times`` calls it): the first of PyTorch's priority
    order that takes them."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    G = q.shape[1] // k.shape[1]
    k, v = (t.repeat_interleave(G, dim=1) for t in (k, v))
    order = getattr(torch._C, "_get_sdp_priority_order", lambda: [1, 2, 0])()
    for code in order:
        backend = SDPBackend(code)
        try:
            with sdpa_kernel(backend), warnings.catch_warnings():
                warnings.simplefilter("ignore")  # each refusal warns its reason
                torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=causal)
        except RuntimeError:
            continue
        return backend.name
    return "none"


def wrapper_host_us(fn, calls: int = 100) -> float:
    """The host's microseconds a call of ``fn`` over ``calls`` calls
    (checks, routing, launch; the card runs behind)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def flash_times(q, k, v, causal: bool = True) -> dict:
    """A prefill's times: the kernel, the plain version and SDPA on K/V
    repeated over the group (the yardstick), the kernel and SDPA again with
    the card slept first (card only), and the bound with its FLOP and
    bytes.  A causal call (Sq = Skv) counts the pairs k <= q, a non-causal
    one all Sq * Skv."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_gqa
    from repro_torch.kernels.flash_attention.ref import attention_ref

    B, H, Sq, hd = q.shape
    Skv = k.shape[2]
    G = H // k.shape[1]
    kernel = lambda: flash_attention_gqa(q, k, v, causal=causal)  # noqa: E731
    k_rep = k.repeat_interleave(G, dim=1)
    v_rep = v.repeat_interleave(G, dim=1)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q, k_rep, v_rep, is_causal=causal)
    pairs = Sq * (Sq + 1) // 2 if causal else Sq * Skv  # (q, k) pairs per (b, h)
    flops = 4 * hd * pairs * B * H  # Q K^T and P V, 2 FLOPs per multiply-add
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()  # q, k, v, out
    t_ops = flops / PEAK_FLOPS[str(q.dtype).split(".")[-1]] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return {
        "ms": time_ms(kernel),
        "plain_ms": time_ms(lambda: attention_ref(q, k, v, causal=causal)),
        "library_ms": time_ms(sdpa),
        "card_ms": time_ms(kernel, card_only=True),
        "card_library_ms": time_ms(sdpa, card_only=True),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "flops": flops,
        "bytes": nbytes,
    }


def ssd_plain(x, a, b, c, s0):
    """The plain version on the wrapper's (B, S, H, ...) layout: the
    sequential recurrence of ``ref.ssd_scan_ref`` over (B*H, S, ...)."""
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    B, S, H, P = x.shape
    flat = lambda t: t.transpose(1, 2).reshape(B * H, S, *t.shape[3:])  # noqa: E731
    y, sf = ssd_scan_ref(flat(x), flat(a), flat(b), flat(c), s0.reshape(B * H, P, -1))
    return y.reshape(B, H, S, P).transpose(1, 2), sf.reshape(s0.shape)


def plant_ssd_fault(scan, fault: str):
    """``scan`` (the ``ssd_scan`` signature) with a fault planted, built from
    calls of ``scan`` itself: each chunk scanned alone from the initial
    state, zeros in place of the initial state, or zeros returned as the
    final state."""

    def faulty(x, a, b, c, initial_state=None, *, chunk=128):
        if fault == "initial state ignored":
            return scan(x, a, b, c, chunk=chunk)
        y, state = scan(x, a, b, c, initial_state, chunk=chunk)
        if fault == "final state dropped":
            return y, torch.zeros_like(state)
        S = x.shape[1]
        Q = min(chunk, max(8, 1 << (S - 1).bit_length()))
        ys = []
        for t in range(0, S, Q):
            part = lambda v: v[:, t:t + Q]  # noqa: E731
            yk, state = scan(part(x), part(a), part(b), part(c), initial_state, chunk=chunk)
            ys.append(yk)
        return torch.cat(ys, dim=1), state

    return faulty


def compare_ssd(y, state, y_ref, s_ref, dname: str) -> tuple[float, float, bool, bool]:
    """Max abs error over y and the final state, the worst per-step relative
    L2 error of y (B, S, H, P), and whether each is within its limit."""
    tol = SSD_TOL[dname]
    dy = y.float() - y_ref.float()
    ds = state.float() - s_ref.float()
    err = max(dy.abs().max().item(), ds.abs().max().item())
    within = bool((dy.abs() <= tol + tol * y_ref.float().abs()).all()
                  and (ds.abs() <= tol + tol * s_ref.float().abs()).all())
    steps = lambda t: t.float().transpose(0, 1).reshape(t.shape[1], -1)  # noqa: E731
    step_rel = (steps(dy).norm(dim=1) / steps(y_ref).norm(dim=1).clamp_min(1e-30)).max().item()
    return err, step_rel, within, step_rel <= SSD_STEP_REL_TOL[dname]


def check_ssd(gen) -> dict:
    from repro_torch.kernels.ssd_scan.kernel import kernel_route
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    def inputs(B, S, H, P, N, dtype, shared_bc=False):
        """Scaled as the JAX sweep scales them; with ``shared_bc`` B and C
        are one group broadcast over heads, as the model passes them: column
        slices of one (B, S, H*P + 2N) conv output, behind its x columns."""
        randn = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
        x = (randn(B, S, H, P) * 0.5).to(dtype)
        a = (-randn(B, S, H).abs() * 0.3).to(dtype)
        if shared_bc:
            conv = (randn(B, S, H * P + 2 * N) * 0.5).to(dtype)
            b, c = (conv[:, :, None, H * P + i * N:H * P + (i + 1) * N].expand(B, S, H, N)
                    for i in (0, 1))
        else:
            b = (randn(B, S, H, N) * 0.5).to(dtype)
            c = (randn(B, S, H, N) * 0.5).to(dtype)
        s0 = randn(B, H, P, N) * 0.2
        return x, a, b, c, s0

    def report(label, dname, res, route=""):
        err, step_rel, *_ = res
        print(f"[ssd] {label} {dname} max_abs_err {err:.3e} (tol {SSD_TOL[dname]}) "
              f"step rel_l2 {step_rel:.3e} (tol {SSD_STEP_REL_TOL[dname]}){route}")

    routes = {}

    def held(label, dname, x, a, b, c, s0, chunk):
        """The kernel against the plain version, within SSD_TOL and
        SSD_STEP_REL_TOL; returns the max abs error."""
        route = kernel_route(x, b, c)
        routes[route] = routes.get(route, 0) + 1
        y, sf = ssd_scan(x, a, b, c, s0, chunk=chunk)
        torch.cuda.synchronize()
        y_ref, s_ref = ssd_plain(x, a, b, c, s0)
        if y.shape != y_ref.shape or y.dtype != x.dtype or sf.dtype != torch.float32:
            fail(f"ssd {label} {dname}: {y.shape}/{y.dtype}/{sf.dtype}")
        res = compare_ssd(y, sf, y_ref, s_ref, dname)
        report(label, dname, res, f" | {route[0]} kernel, {route[1]} loads")
        if not all(res[2:]):
            fail(f"ssd {label} {dname}: kernel disagrees with the plain version")
        return res[0]

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for shape in SSD_SHAPES:
            B, S, H, P, N, chunk = shape
            held(shape, dname, *inputs(B, S, H, P, N, dtype), chunk)
    for shape in SSD_BF16_EDGES:
        B, S, H, P, N, shared = shape
        args = inputs(B, S, H, P, N, torch.bfloat16, shared_bc=shared)
        err = held((B, S, H, P, N, SSD_CHUNK, "shared B/C" if shared else "B/C per head"),
                   "bfloat16", *args, SSD_CHUNK)
        if shape == SSD_HYMBA:
            route = kernel_route(args[0], args[2], args[3])
            if route != ("tensor-core", "cp.async16"):
                fail(f"hymba's prefill views take the {route} route")
            hymba = {"shape": shape, "max_abs_err": err, "route": list(route),
                     **ssd_times(*args, SSD_CHUNK)}
            print(f"[ssd] hymba prefill {shape} ({route[0]} kernel, {route[1]} loads): kernel "
                  f"{hymba['ms']:.4f} ms | card only {hymba['card_ms']:.4f} ms | plain "
                  f"{hymba['plain_ms']:.4f} ms | library none | bound {hymba['bound_ms']:.4f} ms "
                  f"({hymba['flops']:.4e} FLOP, {hymba['bytes']} B)")
        del args
    # x 2 bytes off a 16-byte boundary: the tensor-core kernel loads it element
    # by element, in place
    x, a, b, c, s0 = inputs(2, 300, 4, 64, 64, torch.bfloat16)
    x = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(x.shape)
    held((2, 300, 4, 64, 64, SSD_CHUNK, "x off a 16-byte boundary"), "bfloat16", x, a, b, c, s0,
         SSD_CHUNK)
    want = {("scalar", "elementwise"), ("tensor-core", "cp.async16"),
            ("tensor-core", "elementwise")}
    if set(routes) != want:
        fail(f"the SSD checks took the routes {routes}, not all of {want}")
    print(f"[ssd] routes taken (kernel, loads): {routes}")

    # mamba2-130m serving prefill: batch 4 of 1024 steps, 24 heads, B and C
    # head-broadcast views (head stride 0), as apply_mamba passes them
    B, S, H, P, N = 4, 1024, 24, 64, 128
    dtype = torch.bfloat16
    x, a, b, c, s0 = inputs(B, S, H, P, N, dtype, shared_bc=True)
    assert b.stride(2) == 0 and c.stride(2) == 0
    y, sf = ssd_scan(x, a, b, c, s0, chunk=SSD_CHUNK)
    torch.cuda.synchronize()
    y_ref, s_ref = ssd_plain(x, a, b, c, s0)
    torch.cuda.synchronize()
    res = compare_ssd(y, sf, y_ref, s_ref, "bfloat16")
    err = res[0]
    report(f"prefill (B={B}, S={S}, H={H}, P={P}, N={N}, chunk {SSD_CHUNK}, shared B/C)",
           "bfloat16", res)
    if not all(res[2:]):
        fail("ssd prefill geometry: kernel disagrees with the plain version")
    ssd_faults_rejected((x, a, b, c, s0), SSD_CHUNK, y_ref, s_ref, "bfloat16")

    scan = lambda: ssd_scan(x, a, b, c, s0, chunk=SSD_CHUNK)  # noqa: E731
    times = ssd_times(x, a, b, c, s0, SSD_CHUNK)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):  # the host's cost of a call: checks, routing, launch
        scan()
    host_us = (time.perf_counter() - t0) * 1e4
    torch.cuda.synchronize()
    x32, b32, c32 = x.float(), b.float(), c.float()
    f32_ms = time_ms(lambda: ssd_scan(x32, a, b32, c32, s0, chunk=SSD_CHUNK))
    # batch 8: 192 streams, more than the 132 SMs at one CTA an SM (a second wave)
    x8, a8, b8, c8, s08 = inputs(2 * B, S, H, P, N, dtype, shared_bc=True)
    card8_ms = time_ms(lambda: ssd_scan(x8, a8, b8, c8, s08, chunk=SSD_CHUNK), card_only=True)
    del x8, a8, b8, c8, s08, x32, b32, c32
    card_ms = times["card_ms"]
    contract = check_ssd_contract(inputs, held)
    print(f"[ssd] prefill: kernel {times['ms']:.4f} ms | plain {times['plain_ms']:.4f} ms | "
          f"library none | bound {times['bound_ms']:.4f} ms ({times['flops']:.4e} FLOP, "
          f"{times['bytes']} B) | card only (card slept first) {card_ms:.4f} ms | wrapper host "
          f"time {host_us:.1f} us a call | f32 scalar kernel {f32_ms:.4f} ms | batch {2 * B} "
          f"card only {card8_ms:.4f} ms ({card8_ms / card_ms:.2f}x batch {B})")
    return {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:96",
        "launches": 0,
        "max_abs_err": err,
        **{key: times[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "hymba": hymba,
        "contract": contract,
    }


def ssd_faults_rejected(args, chunk: int, y_ref, s_ref, dname: str, label: str = "") -> None:
    """Each of SSD_FAULTS, planted in ``ssd_scan`` on ``args`` (x, a, b, c,
    s0), must fail ``compare_ssd`` against the plain version's y and state."""
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    for fault in SSD_FAULTS:
        bad_y, bad_s = plant_ssd_fault(ssd_scan, fault)(*args, chunk=chunk)
        b_err, b_step, b_within, b_step_ok = compare_ssd(bad_y, bad_s, y_ref, s_ref, dname)
        verdict = lambda ok: "passed" if ok else "rejected"  # noqa: E731
        print(f"[ssd] {label}planted fault '{fault}': max_abs_err {b_err:.3e} "
              f"({verdict(b_within)}) step rel_l2 {b_step:.3e} ({verdict(b_step_ok)})")
        if b_within and b_step_ok:
            fail(f"the kernel check does not see the planted fault '{fault}'")


def check_ssd_contract(inputs, held) -> dict:
    """K2 past the models' chunk, state width and dtype (``check_ssd``'s
    helpers): SSD_CONTRACT_SWEEP in three dtypes at a ragged length, then
    each SSD_CONTRACT prefill on the model's head-broadcast B and C (the
    launch and any tile sum counted; a chunk of 256 equal bit for bit to
    its two sub-chunks of 128, the same call at chunk 128) with the planted
    faults, on B and C per head, and timed as the prefill is."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.kernel import kernel_route, state_tiles, sub_chunks

    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        dname = str(dtype).split(".")[-1]
        for N, chunk in SSD_CONTRACT_SWEEP:
            held((2, 300, 4, 64, N, chunk), dname, *inputs(2, 300, 4, 64, N, dtype), chunk)
    contract = {}
    for name, ((B, S, H, P, N), chunk, dtype) in SSD_CONTRACT.items():
        dname = str(dtype).split(".")[-1]
        x, a, b, c, s0 = inputs(B, S, H, P, N, dtype, shared_bc=True)
        route, tiles = kernel_route(x, b, c), state_tiles(N)
        n0, sums0 = _counter(ssd_ops.LAUNCHES), _counter(ssd_ops.TILE_SUMS)
        err = held((B, S, H, P, N, chunk, f"{name}, shared B/C"), dname, x, a, b, c, s0, chunk)
        n, sums = _counter(ssd_ops.LAUNCHES) - n0, _counter(ssd_ops.TILE_SUMS) - sums0
        if (n, sums) != (1, int(tiles > 1)):
            fail(f"{name}: {n} launches and {sums} tile sums for one call ({tiles} tiles)")
        if chunk > SSD_CHUNK:
            y, sf = ssd_ops.ssd_scan(x, a, b, c, s0, chunk=chunk)
            y128, s128 = ssd_ops.ssd_scan(x, a, b, c, s0, chunk=SSD_CHUNK)
            same = torch.equal(y, y128) and torch.equal(sf, s128)
            print(f"[ssd] {name}: chunk {chunk} runs as {sub_chunks(chunk)[0]} sub-chunks of "
                  f"{sub_chunks(chunk)[1]} rows, equal to the chunk-{SSD_CHUNK} call bit for bit: "
                  f"{same}")
            if not same:
                fail(f"{name}: chunk {chunk} is not its sub-chunks of {sub_chunks(chunk)[1]}")
            del y, sf, y128, s128
        y_ref, s_ref = ssd_plain(x, a, b, c, s0)
        ssd_faults_rejected((x, a, b, c, s0), chunk, y_ref, s_ref, dname, f"{name} ")
        del y_ref, s_ref
        f64 = ssd_f64_check(x, a, b, c, s0, chunk) if name == SSD_F64_CASE else None
        held((B, S, H, P, N, chunk, f"{name}, B/C per head"), dname,
             *inputs(B, S, H, P, N, dtype), chunk)
        scan = lambda: ssd_ops.ssd_scan(x, a, b, c, s0, chunk=chunk)  # noqa: E731
        t = contract[name] = {"shape": (B, S, H, P, N), "chunk": chunk, "dtype": dname,
                              "route": list(route), "state_tiles": tiles, "max_abs_err": err,
                              **ssd_times(x, a, b, c, s0, chunk),
                              "host_us": wrapper_host_us(scan)}
        if f64:
            t["float64"] = f64
        print(f"[ssd] {name} {(B, S, H, P, N)} chunk {chunk} ({route[0]} kernel, {tiles} state "
              f"tile{'s' if tiles > 1 else ''}): kernel {t['ms']:.4f} ms | card only "
              f"{t['card_ms']:.4f} ms | plain {t['plain_ms']:.4f} ms | library none | bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['flops']:.4e} FLOP, {t['bytes']} B) | "
              f"wrapper host time {t['host_us']:.1f} us a call")
        del x, a, b, c, s0
    return contract


def ssd_f64_check(x, a, b, c, s0, chunk: int) -> dict:
    """The f32 kernel at ``chunk`` against a float64 run of the plain
    version, beside the plain version's own f32 runs: the sequential
    recurrence, and the chunked form (``rounding.chunked``, unrounded) at
    the sub-chunk the kernel runs and at ``chunk``.  Distance: the relative
    L2 error over y and the final state (max abs printed beside).  The
    kernel must be no further than F64_NOISE times the chunked form at
    ``chunk``, the JAX kernel's arithmetic."""
    from repro_torch.kernels.ssd_scan.kernel import sub_chunks
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.rounding import CONFIGS, chunked

    y64, s64 = ssd_plain(*(t.double() for t in (x, a, b, c, s0)))
    ref = torch.cat([y64.reshape(-1), s64.reshape(-1)])

    def dist(y, s):
        d = torch.cat([y.double().reshape(-1), s.double().reshape(-1)]) - ref
        return {"rel_l2": (d.norm() / ref.norm()).item(), "max_abs": d.abs().max().item()}

    exact = CONFIGS["exact"]
    sub = sub_chunks(chunk)[1]
    runs = {"kernel": dist(*ssd_scan(x, a, b, c, s0, chunk=chunk)),
            "plain sequential": dist(*ssd_plain(x, a, b, c, s0))}
    for q in (sub, chunk):
        runs[f"plain chunked {q}"] = dist(*chunked(x, a, b, c, s0, *exact, chunk=q,
                                                   round_y=exact[0]))
    for label, d in runs.items():
        print(f"[ssd] float64 run against the f32 {label} at chunk {chunk}: rel_l2 "
              f"{d['rel_l2']:.4e} max_abs {d['max_abs']:.4e}")
    ratios = {label: runs["kernel"]["rel_l2"] / d["rel_l2"] for label, d in runs.items()
              if label != "kernel"}
    ratio = ratios[f"plain chunked {chunk}"]
    print(f"[ssd] kernel / plain chunked {chunk}: {ratio:.3f} (limit {F64_NOISE}); beside it, "
          + ", ".join(f"kernel / {label} {r:.3f}" for label, r in ratios.items()
                      if label != f"plain chunked {chunk}"))
    if ratio > F64_NOISE:
        fail(f"ssd chunk {chunk} float32: the kernel is {ratio:.3f}x as far from the float64 run "
             f"as the plain chunked form at chunk {chunk}")
    return {**runs, "ratios": ratios}


def ssd_times(x, a, b, c, s0, chunk: int) -> dict:
    """A prefill scan's times at ``chunk``: the kernel, with the card slept
    first (card only), and the plain version; the bound with its FLOP and
    bytes, the FLOP those of the chunks the kernel runs (a chunk over 128
    rows as its sub-chunks)."""
    from repro_torch.kernels.ssd_scan.kernel import sub_chunks
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    B, S, H, P = x.shape
    N = b.shape[-1]
    scan = lambda: ssd_scan(x, a, b, c, s0, chunk=chunk)  # noqa: E731
    Q = sub_chunks(chunk)[1]
    n_chunks = -(-S // Q)
    # per chunk: C B^T, its product with X, C S^T and the state update
    flops = (2 * Q * Q * N + 2 * Q * Q * P + 2 * Q * N * P + 2 * P * Q * N) * n_chunks * B * H
    el = x.element_size()
    # x and y, a (f32), B and C once per batch row (head stride 0), s0 and
    # the final state (f32)
    nbytes = 2 * B * S * H * P * el + B * S * H * 4 + 2 * B * S * N * el + 2 * B * H * P * N * 4
    t_ops = flops / PEAK_FLOPS[str(x.dtype).split(".")[-1]] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return {
        "ms": time_ms(scan),
        "card_ms": time_ms(scan, card_only=True),
        "plain_ms": time_ms(lambda: ssd_plain(x, a, b, c, s0), iters=3, warmup=1),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "flops": flops,
        "bytes": nbytes,
    }


def fp_golden_array(kind: str, shape: tuple, seed: int) -> np.ndarray:
    """The numpy input of an ``FP_GOLDEN`` entry."""
    rng = np.random.default_rng(seed)
    if kind == "uint8":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    if kind == "int32":
        return rng.integers(-2**31, 2**31, shape, dtype=np.int32)
    if kind == "int64":  # values beyond 32 bits: narrowing keeps the low 32
        return rng.integers(-2**62, 2**62, shape, dtype=np.int64)
    vals = rng.normal(size=shape) * 100
    if kind == "float64":
        vals[:3] = (1e300, -1e300, 1e-300)  # narrowed to inf, -inf and 0
        return vals
    if kind == "bfloat16":  # bf16 values by truncation, as their bits
        return (vals.astype(np.float32).view(np.uint32) >> 16).astype(np.uint16)
    if kind == "float32.T":
        return vals.astype(np.float32).T
    return vals.astype(kind)


def fp_golden_tensor(kind: str, shape: tuple, seed: int, device) -> torch.Tensor:
    """The same input as a tensor on ``device``: bf16 for "bfloat16", and a
    transposed view for "float32.T"."""
    arr = fp_golden_array(kind, shape, seed)
    if kind == "float32.T":
        return torch.from_numpy(np.ascontiguousarray(arr.T)).to(device).T
    t = torch.from_numpy(arr).to(device)
    return t.view(torch.bfloat16) if kind == "bfloat16" else t


def check_fingerprint(gen) -> dict:
    """Token equality, not closeness: the kernel against the pinned JAX
    tokens, against the plain version on the sweep, and under bit flips."""
    from repro_torch.kernels.fingerprint import kernel as fp_kernel
    from repro_torch.kernels.fingerprint import ops as fp_ops
    from repro_torch.kernels.fingerprint.ops import format_token as fp_token
    from repro_torch.kernels.fingerprint.ref import fingerprint_ref

    if (FP_STAGE_BLOCKS, FP_RING_BLOCKS) != (fp_kernel.TMA_ROWS,
                                             fp_kernel.TMA_ROWS * fp_kernel.TMA_STAGES):
        fail("FP_STAGE_BLOCKS / FP_RING_BLOCKS do not match the kernel's TMA ring")
    for kind, shape, seed, want in FP_GOLDEN:
        t = fp_golden_tensor(kind, shape, seed, "cuda")
        got = fp_ops.fingerprint_token(t)
        from_numpy = fp_ops.fingerprint_token(fp_golden_array(kind, shape, seed))
        if got != want or from_numpy != want:
            fail(f"fingerprint {kind}{shape}: kernel {got} (from numpy {from_numpy}), JAX {want}")
    print(f"[fingerprint] {len(FP_GOLDEN)} pinned JAX tokens reproduced by the kernel")

    buf = torch.randint(0, 256, (FP_LENGTHS[-1] + 8,), dtype=torch.uint8, device="cuda",
                        generator=gen)
    n_cases, routes = 0, {"tma": 0, "ring": 0}
    for n in FP_LENGTHS:
        for off in FP_OFFSETS:
            view = buf[off:off + n]
            route = fp_kernel.route(view)
            if route != ("tma" if off % 16 == 0 else "ring"):
                fail(f"a view at byte offset {off} takes the {route} route")
            got = fp_token(fp_ops.fingerprint(view))
            want = fp_token(fingerprint_ref(view))
            if got != want:
                fail(f"fingerprint of {n} bytes at offset {off} ({route} route): kernel {got}, "
                     f"plain {want}")
            n_cases += 1
            routes[route] += 1
    if not all(routes.values()):
        fail(f"the sweep did not launch both routes: {routes}")
    # a 16-bit view at an odd element starts 2 bytes off a word boundary
    halves = buf[:2 * 4097].view(torch.float16)[1:]
    if fp_token(fp_ops.fingerprint(halves)) != fp_token(fingerprint_ref(fp_ops.as_bytes(halves))):
        fail("fingerprint of a float16 view at an odd element: kernel and plain differ")
    print(f"[fingerprint] kernel equals the plain version on {n_cases + 1} inputs "
          f"({len(FP_LENGTHS)} lengths of 1 B to {FP_LENGTHS[-1]} B x offsets {FP_OFFSETS}, "
          f"one float16 view) | routes: TMA {routes['tma']}, register ring {routes['ring'] + 1}")
    del buf

    big = torch.randint(0, 256, (FP_FLIP_BYTES,), dtype=torch.uint8, device="cuda",
                        generator=gen)
    base = fp_token(fp_ops.fingerprint(big))
    twin = big.clone()
    if fp_token(fp_ops.fingerprint(twin)) != base:
        fail("fingerprint of an unchanged clone differs")
    mid = FP_FLIP_BYTES // 2  # a block boundary
    for pos in (0, FP_FLIP_BYTES - 1, mid - 1, mid):
        twin[pos:pos + 1].bitwise_xor_(1)
        flipped = fp_token(fp_ops.fingerprint(twin))
        twin[pos:pos + 1].bitwise_xor_(1)
        if flipped == base:
            fail(f"a bit flip at byte {pos} of {FP_FLIP_BYTES} leaves the token {base}")
    if fp_token(fp_ops.fingerprint(twin)) != base:
        fail("fingerprint after undoing the flips differs")
    ms = time_ms(lambda: fp_ops.fingerprint(big), iters=5, warmup=1)
    print(f"[fingerprint] {FP_FLIP_BYTES:,} B buffer: token {base}; a one-bit flip at bytes 0, "
          f"{FP_FLIP_BYTES - 1}, {mid - 1} and {mid} changes it; the clone keeps it | kernel "
          f"{ms:.4f} ms ({FP_FLIP_BYTES / ms / 1e6:.1f} GB/s)")
    del big, twin
    torch.cuda.empty_cache()
    return {
        "name": "fingerprint",
        "route": "cuda",
        "source": "src/repro_torch/kernels/fingerprint/csrc/fingerprint.cu",
        "replaces": "src/repro/kernels/fingerprint/kernel.py:45",
        "launches": 0,
        "max_abs_err": 0.0,
        "ms": None,
        "plain_ms": None,
        "bound_ms": None,
        "bound_by": "bytes",
        "library_ms": None,
    }


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def events_ms(fn) -> tuple[object, float]:
    """``fn()`` once, and its time on the card's clock."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def fingerprint_leaves(params, fp: dict) -> dict:
    """The fingerprint's path: every leaf of the full-width f32 parameter
    tree through the kernel, twice; leaves no larger than the embedding and
    one MLP stack against the plain version.  Fills ``fp``'s numbers for the
    ``kernels`` line and returns the timings of both timed leaves."""
    from repro_torch.kernels.fingerprint import kernel as fp_kernel
    from repro_torch.kernels.fingerprint import ops as fp_ops
    from repro_torch.kernels.fingerprint.ops import format_token as fp_token
    from repro_torch.kernels.fingerprint.ref import fingerprint_ref

    leaves = dict(_named_leaves(params))
    nbytes = {name: t.numel() * t.element_size() for name, t in leaves.items()}
    total = sum(nbytes.values())
    _reset_counters(fp_ops.LAUNCHES)  # counts of this path only
    tokens, pass_ms = {}, []
    for _ in range(2):
        out, ms = events_ms(lambda: {name: fp_ops.fingerprint(t) for name, t in leaves.items()})
        pass_ms.append(ms)
        for name, h in out.items():
            tokens.setdefault(name, []).append(fp_token(h))
    launches = _counter(fp_ops.LAUNCHES)
    if launches != 2 * len(leaves):
        fail(f"fingerprint launched {launches} times for 2 x {len(leaves)} leaves")
    unstable = [name for name, (a, b) in tokens.items() if a != b]
    if unstable:
        fail(f"fingerprint of {unstable} differs between two passes")

    emb = "/embedding/embed"
    largest = max(nbytes, key=nbytes.get)
    held = list(dict.fromkeys([n for n in nbytes if nbytes[n] <= nbytes[emb]] + [largest]))
    plain_ms = {}
    for name in held:
        t = leaves[name]
        h, plain_ms[name] = events_ms(lambda: fingerprint_ref(fp_ops.as_bytes(t)))
        if fp_token(h) != tokens[name][0]:
            fail(f"fingerprint of {name}: kernel {tokens[name][0]}, plain {fp_token(h)}")
    print(f"[fingerprint] qwen2.5-3b f32 tree: {len(leaves)} leaves, {total:,} B, largest "
          f"{largest} {nbytes[largest]:,} B | kernel launches {launches} (2 passes), "
          f"{pass_ms[0]:.3f} / {pass_ms[1]:.3f} ms a pass | tokens equal in both passes; "
          f"equal to the plain version on {len(held)} leaves "
          f"({sum(nbytes[n] for n in held):,} B, plain {sum(plain_ms.values()) / 1e3:.1f} s)")
    detail = {"tree": {"leaves": len(leaves), "bytes": total, "pass_ms": pass_ms,
                       "launches": launches}}

    clock_mhz = gpu_query("clocks.max.sm", units=False)
    clock = float(clock_mhz) * 1e6 if clock_mhz.replace(".", "").isdigit() else 1.98e9
    for name in dict.fromkeys((largest, emb)):
        t = leaves[name]
        n = nbytes[name]
        ms = time_ms(lambda: fp_ops.fingerprint(t), iters=5, warmup=1)
        read_ms = time_ms(lambda: t.view(torch.int32).sum(), iters=5, warmup=1)
        t_bytes = n / PEAK_BYTES * 1e3
        t_ops = 0.75 * n / PEAK_INT32_OPS * 1e3  # add, multiply, xor per 4-byte word
        blocks = -(-n // 4096)
        chain = blocks * FP_CHAIN_CYCLES / clock * 1e3
        cycles = ms * 1e-3 * clock / blocks  # measured cycles a chain step
        route = fp_kernel.route(fp_ops.as_bytes(t))
        print(f"[fingerprint] {name} {tuple(t.shape)} {n:,} B ({route} route): kernel {ms:.4f} ms "
              f"({n / ms / 1e6:.1f} GB/s) | plain {plain_ms[name]:.1f} ms | read yardstick "
              f"int32 sum {read_ms:.4f} ms | byte bound {t_bytes:.4f} ms (operations "
              f"{t_ops:.4f} ms) | chain estimate {chain:.4f} ms ({blocks:,} steps x "
              f"{FP_CHAIN_CYCLES} cycles at {clock / 1e6:.0f} MHz) | measured {cycles:.2f} "
              f"cycles a chain step")
        if name == largest:
            fp.update(launches=launches, ms=ms, plain_ms=plain_ms[name],
                      bound_ms=max(t_bytes, t_ops),
                      bound_by="operations" if t_ops > t_bytes else "bytes")
        detail[name] = {"bytes": n, "ms": ms, "plain_ms": plain_ms[name], "read_ms": read_ms,
                        "bound_ms": t_bytes, "chain_ms": chain, "cycles_per_step": cycles}
    return detail


def smoke_check(tx, arch: str) -> None:
    """The smoke config in f32: the card (kernels) against the CPU reference,
    prefill and 4 decode steps, logits within 1e-3.  An encoder-decoder arch
    (``tx`` is ``models.whisper``) also takes frame embeddings, and its
    prompt leaves room in the decoder's position table."""
    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config(arch)
    pcfg = cfg.replace(attention_impl="pallas")
    params_cpu = tx.init_params(cfg, torch.Generator().manual_seed(0))
    params_gpu = _to(params_cpu, "cuda")
    S = cfg.max_target_len - 8 if cfg.is_encdec else 40
    toks = torch.randint(0, cfg.vocab_size, (2, S), generator=torch.Generator().manual_seed(1))
    enc = ((torch.randn((2, cfg.encoder_seq, cfg.d_model),
                        generator=torch.Generator().manual_seed(2)),) if cfg.is_encdec else ())
    worst = 0.0
    with torch.inference_mode():
        caches = {d: tx.init_cache(cfg, 2, S + 8, *(f.shape[1] for f in enc), device=d)
                  for d in ("cpu", "cuda")}
        lc, caches["cpu"] = tx.prefill(cfg, params_cpu, toks, *enc, caches["cpu"])
        lg, caches["cuda"] = tx.prefill(pcfg, params_gpu, toks.cuda(), *(f.cuda() for f in enc),
                                        caches["cuda"])
        for i in range(4):
            worst = max(worst, (lg.cpu() - lc).abs().max().item())
            tok = lc[:, -1:].argmax(-1)
            pos = torch.full((2, 1), S + i, dtype=torch.int64)
            lc, caches["cpu"] = tx.decode_step(cfg, params_cpu, caches["cpu"], tok, pos)
            lg, caches["cuda"] = tx.decode_step(pcfg, params_gpu, caches["cuda"], tok.cuda(),
                                                pos.cuda())
        worst = max(worst, (lg.cpu() - lc).abs().max().item())
    print(f"[model] {arch} smoke f32 prefill+decode logits, card vs CPU: max_abs_err "
          f"{worst:.3e} (tol 1e-3)")
    if not worst <= 1e-3:
        fail(f"{arch} smoke model on the card disagrees with the CPU")


def rel(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def block_rel(a, b, block: int) -> torch.Tensor:
    """Relative L2 error over each block of ``block`` tokens of (B, S, d);
    the last block holds what is left when ``block`` does not divide S."""
    pairs = zip(a.float().split(block, dim=1), b.float().split(block, dim=1))
    return torch.stack([(x - y).norm() / y.norm() for x, y in pairs])


def forward_check(tx, cfg, params, toks, label: str, **fwd) -> dict:
    """A dense arch's full-width bf16 forward through K1 (B=1) against the
    reference path: block by block no further from an f32-compute forward
    than the reference path is (FORWARD_NOISE), both FAULTS planted and
    rejected, K1 launched once a layer.  Counts the inputs the wrapper
    copies before the kernel (none when the model's views are TMA-ready).
    ``fwd`` goes to ``tx.forward`` (internvl2's patch embeddings)."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import attention

    real_flash, real_inputs = attention._flash, fa_kernel.kernel_inputs
    copies = []

    def counted_inputs(q, k, v):
        out = real_inputs(q, k, v)
        copies.append(sum(a is not b for a, b in zip((q, k, v), out)))
        return out

    pcfg = cfg.replace(attention_impl="pallas")
    with torch.inference_mode():
        ref, _, _ = tx.forward(cfg.replace(attention_impl="reference"), params, toks, **fwd)
        exact, _, _ = tx.forward(cfg.replace(compute_dtype=torch.float32), params, toks, **fwd)
        n0 = _counter(fa_ops.LAUNCHES)
        fa_kernel.kernel_inputs = counted_inputs
        try:
            out, _, _ = tx.forward(pcfg, params, toks, **fwd)
            torch.cuda.synchronize()
        finally:
            fa_kernel.kernel_inputs = real_inputs
        n = _counter(fa_ops.LAUNCHES) - n0
        planted = {}
        for fault in FAULTS:
            attention._flash = plant_fault(real_flash, fault, 1)
            try:
                planted[fault], _, _ = tx.forward(pcfg, params, toks, **fwd)
            finally:
                attention._flash = real_flash

    # Through dozens of random-weight layers the bf16 rounding noise itself
    # is a few 1e-2 of relative L2, so the flash path is held to the
    # reference path's own distance from the f32 forward, block by block
    noise = block_rel(ref, exact, FORWARD_BLOCK)
    ratio = (block_rel(out, exact, FORWARD_BLOCK) / noise).max().item()
    err = (out.float() - ref.float()).abs().max().item()
    B, S = toks.shape
    print(f"[model] {label} full-width forward (B={B}, S={S}), {str(cfg.compute_dtype)[6:]}: "
          f"flash vs reference "
          f"max_abs_err {err:.3e} rel_l2 {rel(out, ref):.3e} | against the f32-compute forward: "
          f"reference rel_l2 {rel(ref, exact):.3e} (blocks {noise.min().item():.3e}-"
          f"{noise.max().item():.3e}), flash rel_l2 {rel(out, exact):.3e}, worst block ratio "
          f"{ratio:.3f} (tol {FORWARD_NOISE}) | flash launches {n} | kernel inputs copied "
          f"before the kernel {sum(copies)} of {3 * len(copies)}")
    if out.shape != (B, S, cfg.d_model) or not bool(torch.isfinite(out).all()):
        fail(f"{label} full-width forward: wrong shape or non-finite values")
    faults = {}
    for fault, bad in planted.items():
        b_ratio = faults[fault] = (block_rel(bad, exact, FORWARD_BLOCK) / noise).max().item()
        print(f"[model] planted fault '{fault}': rel_l2 vs f32 forward {rel(bad, exact):.3e}, "
              f"worst block ratio {b_ratio:.3f} -> {'PASSED' if b_ratio <= FORWARD_NOISE else 'rejected'}")
        if b_ratio <= FORWARD_NOISE:
            fail(f"the {label} forward check does not see the planted fault '{fault}'")
    if n != cfg.num_layers or ratio > FORWARD_NOISE:
        fail(f"{label} full-width forward: flash path disagrees with the reference")
    return {"flash_launches": n, "worst_block_ratio": ratio, "fault_ratios": faults,
            "inputs_copied": sum(copies)}


def phase_model(fp: dict) -> tuple[dict, dict]:
    """qwen2.5-3b's model checks and decode breakdown, then the fingerprint's
    path on the same full-width parameters (filling ``fp``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tx

    smoke_check(tx, "qwen2.5-3b")

    # full width, bf16 compute: flash forward against the chunked reference
    cfg = get_config("qwen2.5-3b")
    t0 = time.perf_counter()
    params = tx.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[model] qwen2.5-3b full width: {n_params:,} params "
          f"({n_params * 4 / 1e9:.2f} GB f32) made in {time.perf_counter() - t0:.1f}s")
    toks = torch.randint(0, cfg.vocab_size, (1, 1024), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    forward_check(tx, cfg, params, toks, "qwen2.5-3b")
    # float16 compute, a dtype the config takes: K1's f16 instance at hd 128
    float16 = forward_check(tx, cfg.replace(compute_dtype=torch.float16), params, toks,
                            "qwen2.5-3b float16")
    decode = decode_breakdown(tx, cfg, params)
    decode["float16_forward"] = float16
    fp_detail = fingerprint_leaves(params, fp)
    del params
    torch.cuda.empty_cache()
    return decode, fp_detail


def phase_model_mamba() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import ssm
    from repro_torch.models import transformer as tx

    real_scan = ssm.ssd_scan
    smoke_check(tx, "mamba2-130m")

    # full width, bf16 compute: the kernel's prefill against ssd_chunked
    cfg = get_config("mamba2-130m")
    params = tx.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[model] mamba2-130m full width: {n_params:,} params ({n_params * 4 / 1e9:.2f} GB f32)")
    S, steps = 1024, 4
    gen = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (1, S), device="cuda", generator=gen)
    fed = torch.randint(0, cfg.vocab_size, (1, steps), device="cuda", generator=gen)

    def run(c):
        """Hidden states (1, S, d) of the prefill and the logits (1, steps, V)
        of the decode steps after it, all runs fed the same tokens."""
        cache = tx.init_cache(c, 1, S + steps, device="cuda")
        hidden, cache, _ = tx.forward(c, params, toks, cache=cache, ctx=tx.RunCtx(prefill=True))
        logits = []
        for i in range(steps):
            pos = torch.full((1, 1), S + i, dtype=torch.int64, device="cuda")
            lg, cache = tx.decode_step(c, params, cache, fed[:, i:i + 1], pos)
            logits.append(lg[:, -1])
        return hidden, torch.stack(logits, dim=1)

    def kernel_path_check(c) -> dict:
        """The kernel path at config ``c`` against its reference path, both
        planted faults rejected, one launch a layer."""
        chunk = c.ssm.chunk
        pcfg = c.replace(attention_impl="pallas")
        with torch.inference_mode():
            ref = run(c.replace(attention_impl="reference"))
            exact = run(c.replace(compute_dtype=torch.float32))
            n0 = _counter(ssd_ops.LAUNCHES)
            out = run(pcfg)
            torch.cuda.synchronize()
            n = _counter(ssd_ops.LAUNCHES) - n0
            planted = {}
            with eager_decode("a planted fault"):
                for fault in ("state not carried across chunks", "final state dropped"):
                    ssm.ssd_scan = plant_ssd_fault(real_scan, fault)
                    try:
                        planted[fault] = run(pcfg)
                    finally:
                        ssm.ssd_scan = real_scan

        def step_rel(a, b):
            """Relative L2 error of the logits of each decode step."""
            return ((a.float() - b.float()).norm(dim=-1) / b.float().norm(dim=-1))[0]

        # The kernel path is held to the reference path's own distance from
        # the f32-compute run: over every block of SSD_CHUNK tokens (prefill
        # hidden states) and at every decode step (logits)
        fwd_noise = block_rel(ref[0], exact[0], SSD_CHUNK)
        dec_noise = step_rel(ref[1], exact[1])

        def ratios(run_out):
            return ((block_rel(run_out[0], exact[0], SSD_CHUNK) / fwd_noise).max().item(),
                    (step_rel(run_out[1], exact[1]) / dec_noise).max().item())

        fwd_ratio, dec_ratio = ratios(out)
        print(f"[model] full-width prefill (B=1, S={S}) + {steps} decode steps, bf16, chunk "
              f"{chunk}: against the f32-compute run, reference rel_l2 "
              f"{rel(ref[0], exact[0]):.3e} (blocks {fwd_noise.min().item():.3e}-"
              f"{fwd_noise.max().item():.3e}, decode {dec_noise.min().item():.3e}-"
              f"{dec_noise.max().item():.3e}), kernel rel_l2 {rel(out[0], exact[0]):.3e} | worst "
              f"block ratio {fwd_ratio:.3f}, worst decode ratio {dec_ratio:.3f} (tol "
              f"{FORWARD_NOISE}) | ssd_scan launches {n}")
        if out[0].shape != (1, S, c.d_model) or out[1].shape != (1, steps, c.vocab_size):
            fail("full-width mamba run: wrong shapes")
        if not (bool(torch.isfinite(out[0]).all()) and bool(torch.isfinite(out[1]).all())):
            fail("full-width mamba run: non-finite values")
        checks = {"state not carried across chunks": "forward", "final state dropped": "decode"}
        faults = {}
        for fault, bad in planted.items():
            b_fwd, b_dec = ratios(bad)
            b_ratio = faults[fault] = b_fwd if checks[fault] == "forward" else b_dec
            print(f"[model] planted fault '{fault}': worst block ratio {b_fwd:.3f}, worst decode "
                  f"ratio {b_dec:.3f} -> {checks[fault]} check "
                  f"{'PASSED' if b_ratio <= FORWARD_NOISE else 'rejected'}")
            if b_ratio <= FORWARD_NOISE:
                fail(f"the {checks[fault]} check does not see the planted fault '{fault}'")
        if n != c.num_layers or fwd_ratio > FORWARD_NOISE or dec_ratio > FORWARD_NOISE:
            fail(f"full-width mamba run, chunk {chunk}: kernel path disagrees with the reference")
        return {"chunk": chunk, "ssd_launches": n, "worst_block_ratio": fwd_ratio,
                "worst_decode_ratio": dec_ratio, "fault_ratios": faults}

    kernel_path_check(cfg)
    # mamba_ssm's default chunk: the kernel runs each as two sub-chunks
    upstream = kernel_path_check(
        cfg.replace(ssm=dataclasses.replace(cfg.ssm, chunk=MAMBA_UPSTREAM_CHUNK)))
    decode = decode_breakdown(tx, cfg, params)
    decode["chunk_256_forward"] = upstream
    del params
    torch.cuda.empty_cache()
    return decode


@contextlib.contextmanager
def eager_decode(why: str):
    """``transformer.decode_step`` eager inside.  A decode graph replays the
    kernels it captured, not the Python that enqueued them
    (``decode_graph``), so a run with a fault or a router patched in must
    neither replay a graph captured before the patch nor capture one."""
    from repro_torch.models import decode_graph

    real = decode_graph.eager_reason
    decode_graph.eager_reason = lambda *args: why
    try:
        yield
    finally:
        decode_graph.eager_reason = real


def graph_modes() -> dict[str, int]:
    """How many decode steps ran eagerly, captured and replayed so far."""
    return {m: _counter(f"decode_graph.{m}") for m in ("eager", "capture", "replay")}


def check_graph_run(label: str, graphed, eager, modes: dict[str, int]) -> dict:
    """A run whose decode steps took ``modes`` (counter deltas), at least
    one of them a replay, equal bit for bit to the same run eager."""
    same = all(torch.equal(a, b) for a, b in zip(graphed, eager, strict=True))
    print(f"[model] {label}: the run through decode graphs (steps {modes}) against the same run "
          f"eager: {'equal bit for bit' if same else 'DIFFERENT'}")
    if not modes["replay"]:
        fail(f"{label}: no decode step replayed a graph")
    if not same:
        fail(f"{label}: the decode graphs' run differs from the eager run")
    return {"modes": modes, "equal": same}


def plant_ring_fault(update):
    """``update`` (``attention._update_kv_cache``) with a fault planted in
    its ring mode: the write slot stops at the ring's last slot instead of
    wrapping to slot 0, as a write clamped into the buffer would; the
    length still counts every token."""

    def faulty(cache, k_new, v_new, positions, window, aligned=False):
        if window == 0:
            return update(cache, k_new, v_new, positions, window, aligned)
        size, n = cache["k"].shape[1], k_new.shape[1]
        length = cache["length"].clone()
        cache["length"].clamp_(max=size - n)
        out = update(cache, k_new, v_new, positions, window, aligned)
        cache["length"].copy_(length + n)
        return out

    return faulty


def phase_model_hymba() -> dict:
    """hymba-1.5b's model checks: the smoke config on the card against the
    CPU, then full width in bf16 (a 2048-token prefill, whose local layers
    keep the prompt's last 1024 keys in their rings, and HYMBA_STEPS decode
    steps that write past the rings' end) held to the reference path's own
    distance from an f32-compute run, with three planted faults (their runs
    eager), and the kernel path's run through decode graphs held bit for bit
    to the same run eager; then the decode breakdown."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import attention, ssm
    from repro_torch.models import transformer as tx

    smoke_check(tx, "hymba-1.5b")
    cfg = get_config("hymba-1.5b")
    t0 = time.perf_counter()
    params = tx.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[model] hymba-1.5b full width: {n_params:,} params "
          f"({n_params * 4 / 1e9:.2f} GB f32) made in {time.perf_counter() - t0:.1f}s")
    S, steps = HYMBA_PROMPT, HYMBA_STEPS
    local = [g.name for g in tx.layer_groups(cfg) if g.window]
    gen = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (1, S), device="cuda", generator=gen)
    fed = torch.randint(0, cfg.vocab_size, (1, steps), device="cuda", generator=gen)

    def run(c):
        """Hidden states (1, S, d) of the prefill, the logits (1, steps, V)
        of the decode steps after it, and the local layers' rings after the
        decode, (layers, size, KV, 2 hd) with k and v side by side."""
        cache = tx.init_cache(c, 1, S + steps, device="cuda")
        hidden, cache, _ = tx.forward(c, params, toks, cache=cache, ctx=tx.RunCtx(prefill=True))
        logits = []
        for i in range(steps):
            pos = torch.full((1, 1), S + i, dtype=torch.int64, device="cuda")
            lg, cache = tx.decode_step(c, params, cache, fed[:, i:i + 1], pos)
            logits.append(lg[:, -1])
        rings = [cache[g]["attn"] for g in local]
        if not all(bool(r["length"].eq(S + steps).all()) for r in rings):
            fail("hymba: a ring's length is not the tokens it has seen")
        rings = torch.cat([torch.cat([r["k"], r["v"]], dim=-1)[:, 0] for r in rings])
        return hidden, torch.stack(logits, dim=1), rings

    pcfg = cfg.replace(attention_impl="pallas")
    # (module, function, its faulty stand-in) for each fault of HYMBA_FAULTS
    faulty = {
        "non-causal": (attention, "_flash", plant_fault(attention._flash, "non-causal", 1)),
        "state not carried across chunks": (
            ssm, "ssd_scan", plant_ssd_fault(ssm.ssd_scan, "state not carried across chunks")),
        "ring write stops at the last slot": (
            attention, "_update_kv_cache", plant_ring_fault(attention._update_kv_cache)),
    }
    with torch.inference_mode():
        ref = run(cfg.replace(attention_impl="reference"))
        exact = run(cfg.replace(compute_dtype=torch.float32))
        n0 = {"flash_attention": _counter(fa_ops.LAUNCHES), "ssd_scan": _counter(ssd_ops.LAUNCHES)}
        w0 = _counter(fa_ops.WINDOWS)
        modes0 = graph_modes()
        out = run(pcfg)
        torch.cuda.synchronize()
        modes = {m: k - modes0[m] for m, k in graph_modes().items()}
        n = {"flash_attention": _counter(fa_ops.LAUNCHES) - n0["flash_attention"],
             "ssd_scan": _counter(ssd_ops.LAUNCHES) - n0["ssd_scan"]}
        windowed = _counter(fa_ops.WINDOWS) - w0
        planted = {}
        with eager_decode("a planted fault"):
            for fault in HYMBA_FAULTS:
                module, name, stand_in = faulty[fault]
                real = getattr(module, name)
                setattr(module, name, stand_in)
                try:
                    planted[fault] = run(pcfg)
                finally:
                    setattr(module, name, real)
            graphs = check_graph_run("hymba full width", out, run(pcfg), modes)

    def step_rel(a, b):
        """Relative L2 error of the logits of each decode step."""
        return ((a.float() - b.float()).norm(dim=-1) / b.float().norm(dim=-1))[0]

    def layer_rel(a, b):
        """Relative L2 error of each local layer's ring."""
        return (a.float() - b.float()).flatten(1).norm(dim=1) / b.float().flatten(1).norm(dim=1)

    # Held to the reference path's own distance from the f32-compute run:
    # over every block of one chunk (prefill hidden states), at every decode
    # step (logits) and in every local layer's ring after the decode
    noise = {"forward": block_rel(ref[0], exact[0], SSD_CHUNK),
             "decode": step_rel(ref[1], exact[1]), "ring": layer_rel(ref[2], exact[2])}

    def ratios(run_out):
        return {"forward": (block_rel(run_out[0], exact[0], SSD_CHUNK) / noise["forward"]).max().item(),
                "decode": (step_rel(run_out[1], exact[1]) / noise["decode"]).max().item(),
                "ring": (layer_rel(run_out[2], exact[2]) / noise["ring"]).max().item()}

    got = ratios(out)
    span = lambda t: f"{t.min().item():.3e}-{t.max().item():.3e}"  # noqa: E731
    print(f"[model] hymba full-width prefill (B=1, S={S}) + {steps} decode steps through the "
          f"rings' wrap, bf16: against the f32-compute run, reference rel_l2 "
          f"{rel(ref[0], exact[0]):.3e} (blocks {span(noise['forward'])}, decode "
          f"{span(noise['decode'])}, rings {span(noise['ring'])}), kernel path rel_l2 "
          f"{rel(out[0], exact[0]):.3e} | worst ratios: block {got['forward']:.3f}, decode "
          f"{got['decode']:.3f}, ring {got['ring']:.3f} (tol {FORWARD_NOISE}) | launches {n}, "
          f"{windowed} of them windowed")
    if (out[0].shape != (1, S, cfg.d_model) or out[1].shape != (1, steps, cfg.vocab_size)
            or out[2].shape != (cfg.num_layers - len(cfg.global_layers), cfg.sliding_window,
                                cfg.num_kv_heads, 2 * cfg.head_dim)):
        fail(f"full-width hymba run: wrong shapes {[tuple(t.shape) for t in out]}")
    if not all(bool(torch.isfinite(t).all()) for t in out):
        fail("full-width hymba run: non-finite values")
    for fault, check in HYMBA_FAULTS.items():
        bad = ratios(planted[fault])
        print(f"[model] planted fault '{fault}': worst ratios block {bad['forward']:.3f}, decode "
              f"{bad['decode']:.3f}, ring {bad['ring']:.3f} -> {check} check "
              f"{'PASSED' if bad[check] <= FORWARD_NOISE else 'rejected'}")
        if bad[check] <= FORWARD_NOISE:
            fail(f"the {check} check does not see the planted fault '{fault}'")
    if n != SERVE_LAUNCHES["hymba-1.5b"]:
        fail(f"full-width hymba run launched {n}, not {SERVE_LAUNCHES['hymba-1.5b']}")
    if windowed != cfg.num_layers - len(cfg.global_layers):
        fail(f"full-width hymba run: {windowed} windowed K1 launches, not one a local layer")
    if max(got.values()) > FORWARD_NOISE:
        fail("full-width hymba run: kernel path disagrees with the reference")
    del ref, exact, out, planted
    decode = decode_breakdown(tx, cfg, params, PL=S)
    decode["decode_graphs"] = graphs
    del params
    torch.cuda.empty_cache()
    return decode


def cut_config(arch: str):
    """The full config of ``arch`` with its ``CONFIG_CUTS`` applied."""
    from repro_torch.configs import get_config

    return get_config(arch).replace(**CONFIG_CUTS.get(arch, {}))


def init_full_params(tx, cfg, label: str):
    """Random full-width params on the card; prints their size and the
    init's peak memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tx.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    n = sum(t.numel() for t in _leaves(params))
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"[model] {label}: {n:,} params ({nbytes / 1e9:.2f} GB, {cfg.num_layers} layers) made "
          f"in {time.perf_counter() - t0:.1f}s, init peak memory {peak:,} B")
    return params, {"params": n, "param_bytes": nbytes, "init_peak_bytes": peak}


class RouterPin:
    """A stand-in for ``moe._router`` in the MoE model checks.

    Each call's own top-k ids are recorded under ``label``.  With ``pin``
    set, every token is routed to the experts the f32-compute run (label
    "f32", recorded first) chose at the same layer (its rows ``rows``),
    weighted by this run's own router probabilities renormalised over them.
    Top-k routing is discontinuous: bf16 noise moves a token whose k-th and
    (k+1)-th logits nearly tie to another expert set (some 11 % of kimi's
    tokens), and such a token's hidden state then differs by a whole
    expert's output.  Pinned, two runs differ only by their rounding, so a
    block ratio measures the attention path and not where ties fell; the
    free-routing ratio and the moved tokens are printed beside it.
    """

    def __init__(self, moe, n_layers: int):
        self.real, self.n_layers = moe._router, n_layers
        self.picks: dict[str, list] = {}
        self.label, self.pin, self.rows = "f32", False, slice(None)

    def __call__(self, cfg, p, x2):
        probs, top_i, top_w = self.real(cfg, p, x2)
        calls = self.picks.setdefault(self.label, [])
        layer = len(calls) % self.n_layers
        calls.append(top_i)
        if self.pin:
            top_i = self.picks["f32"][layer][self.rows].to(probs.device)
            top_w = probs.gather(-1, top_i)
            if cfg.moe.norm_topk_prob:
                top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
        return probs, top_i, top_w

    def moved(self, label: str) -> int:
        """Token-layer pairs of ``label``'s first calls (one forward over the
        f32 run's tokens) whose own expert set differs from the f32 run's."""
        sort = lambda t: t.sort(dim=-1).values  # noqa: E731
        return sum(int((sort(a) != sort(b[:a.shape[0]].to(a.device))).any(dim=-1).sum())
                   for a, b in zip(self.picks[label][:self.n_layers], self.picks["f32"]))


def phase_model_kimi() -> dict:
    """kimi-k2 at full width (CONFIG_CUTS): the smoke config on the card
    against the CPU, then a bf16 forward (B=1, S=1024) whose prompt
    attention runs K1 at G = 8, held to the reference path's distance from
    an f32-compute forward block by block with routing pinned to the f32
    run's (``RouterPin``), with both planted K1 faults; the EP form at
    ep = 1 (nothing dropped) against the dense form; the ratio with free
    routing and how many tokens each path routes to other experts than the
    f32 run; then the decode breakdown."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import attention, moe
    from repro_torch.models import transformer as tx

    arch = "kimi-k2-1t-a32b"
    real_flash = attention._flash
    smoke_check(tx, arch)
    cfg = cut_config(arch)
    params, sizes = init_full_params(tx, cfg, "kimi-k2 full width")
    S = 1024
    capacity = math.ceil(S * cfg.moe.top_k / cfg.moe.num_experts * EP_CAPACITY_FACTOR)
    if capacity != S:
        fail(f"EP capacity {capacity} at factor {EP_CAPACITY_FACTOR} is not N = {S}")
    toks = torch.randint(0, cfg.vocab_size, (1, S), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    router = RouterPin(moe, cfg.num_layers - cfg.moe.first_dense)

    def run(label, c, ctx=tx.RunCtx(), pin=True):
        router.label, router.pin = label, pin
        hidden, _, _ = tx.forward(c, params, toks, ctx=ctx)
        return hidden

    pcfg = cfg.replace(attention_impl="pallas")
    rcfg = cfg.replace(attention_impl="reference")
    ep_cfg = cfg.replace(moe_impl="ep", moe=dataclasses.replace(
        cfg.moe, capacity_factor=EP_CAPACITY_FACTOR))
    taken = []
    real_ep = moe.apply_moe_ep
    moe._router = router
    moe.apply_moe_ep = lambda *a, **kw: taken.append("ep") or real_ep(*a, **kw)
    try:
        with torch.inference_mode():
            exact = run("f32", cfg.replace(compute_dtype=torch.float32), pin=False)
            free = {"reference": run("reference", rcfg, pin=False),
                    "flash": run("flash", pcfg, pin=False)}
            ref = run("reference pinned", rcfg)
            n0 = _counter(fa_ops.LAUNCHES)
            out = run("flash pinned", pcfg)
            torch.cuda.synchronize()
            n = _counter(fa_ops.LAUNCHES) - n0
            planted = {}
            for fault in FAULTS:
                attention._flash = plant_fault(real_flash, fault, 1)
                try:
                    planted[fault] = run(fault, pcfg)
                finally:
                    attention._flash = real_flash
            ep = run("ep", ep_cfg, tx.RunCtx(mesh=moe.ExpertWorld()))
    finally:
        moe._router, moe.apply_moe_ep = router.real, real_ep

    noise = block_rel(ref, exact, FORWARD_BLOCK)
    ratio = lambda t, nz=noise: (block_rel(t, exact, FORWARD_BLOCK) / nz).max().item()  # noqa: E731
    free_ratio = ratio(free["flash"], block_rel(free["reference"], exact, FORWARD_BLOCK))
    moved = {k: router.moved(k) for k in ("reference", "flash")}
    res = {**sizes, "flash_launches": n, "worst_block_ratio": ratio(out),
           "free_routing_worst_block_ratio": free_ratio, "ep_worst_block_ratio": ratio(ep),
           "ep_vs_dense_rel_l2": rel(ep, ref), "tokens_routed_otherwise": moved}
    print(f"[model] kimi full-width forward (B=1, S={S}), bf16, routing pinned to the f32 run's: "
          f"against the f32-compute forward, reference rel_l2 {rel(ref, exact):.3e} (blocks "
          f"{noise.min().item():.3e}-{noise.max().item():.3e}), flash rel_l2 "
          f"{rel(out, exact):.3e}, worst block ratio {res['worst_block_ratio']:.3f} (tol "
          f"{FORWARD_NOISE}) | flash launches {n}")
    print(f"[model] kimi with free routing: reference rel_l2 {rel(free['reference'], exact):.3e}, "
          f"flash rel_l2 {rel(free['flash'], exact):.3e}, worst block ratio {free_ratio:.3f} "
          f"(reported, not held) | tokens (of {S}) whose {cfg.moe.top_k} experts differ from "
          f"the f32 run's: {moved}")
    print(f"[model] kimi EP form at ep = 1 (capacity factor {EP_CAPACITY_FACTOR}, capacity "
          f"{capacity} = N) against the dense form: rel_l2 {res['ep_vs_dense_rel_l2']:.3e}, "
          f"worst block ratio against the f32 forward {res['ep_worst_block_ratio']:.3f} "
          f"(tol {FORWARD_NOISE})")
    if out.shape != (1, S, cfg.d_model) or not all(
            bool(torch.isfinite(t).all()) for t in (out, ep, free["flash"])):
        fail("full-width kimi forward: wrong shape or non-finite values")
    for fault, bad in planted.items():
        b_ratio = ratio(bad)
        print(f"[model] planted fault '{fault}': worst block ratio {b_ratio:.3f} -> "
              f"{'PASSED' if b_ratio <= FORWARD_NOISE else 'rejected'}")
        if b_ratio <= FORWARD_NOISE:
            fail(f"the kimi forward check does not see the planted fault '{fault}'")
    if n != SERVE_LAUNCHES[arch]["flash_attention"]:
        fail(f"full-width kimi forward launched flash {n} times, not "
             f"{SERVE_LAUNCHES[arch]['flash_attention']}")
    if res["worst_block_ratio"] > FORWARD_NOISE:
        fail("full-width kimi forward: flash path disagrees with the reference")
    if taken != ["ep"] or res["ep_worst_block_ratio"] > FORWARD_NOISE:
        fail("full-width kimi: the EP form disagrees with the dense form")
    del ref, exact, out, planted, ep, free
    res["decode"] = decode_breakdown(tx, cfg, params)
    del params
    torch.cuda.empty_cache()
    return res


def plant_latent_fault(update):
    """``update`` (``attention._update_latent_cache``) with a fault planted:
    every token's latent written one slot late; the length counts as before."""

    def faulty(cache, c, k_rope):
        cache["length"].add_(1)
        out = update(cache, c, k_rope)
        cache["length"].sub_(1)
        return out[0], out[1], out[2], out[3] - 1, out[4] - 1

    return faulty


def phase_model_deepseek() -> dict:
    """deepseek-v2-lite at full width and depth (CONFIG_CUTS): the smoke config
    on the card against the CPU; then in bf16 a 1024-token prefill into the
    latent cache (its MoE layers in the routed form) and DEEPSEEK_STEPS
    decode steps, held to the expanded cache-free forward over the same
    tokens, each measured from the f32-compute expanded forward: block by
    block (prefill hidden states) and step by step (logits), with routing
    pinned to the f32 run's (``RouterPin``; the free-routing ratios are
    printed), all of these with eager decode steps.  Twice: with the
    reference impl (MLA's prefill in the absorbed form; no kernel launches,
    and a planted latent-cache fault), and with ``pallas``, the serving
    path (MLA's prefill on K1: ``SERVE_LAUNCHES`` launches, each layer's
    attention with v padded to q . k's 192, the kernel padding 192 to 256),
    held also to the reference-impl run's distance from the f32 forward, as
    kimi's flash path is, with both planted K1 faults.  Then the absorbed
    run through decode graphs, routing freely with the router unpatched,
    held bit for bit to the free-routing run eager; then the decode
    breakdown."""
    from repro_torch.models import attention, moe
    from repro_torch.models import transformer as tx
    from repro_torch.models.layers import logits_matmul

    arch = "deepseek-v2-lite-16b"
    smoke_check(tx, arch)
    cfg = cut_config(arch)
    params, sizes = init_full_params(tx, cfg, "deepseek-v2-lite full width and depth")
    S, steps = 1024, DEEPSEEK_STEPS
    toks = torch.randint(0, cfg.vocab_size, (1, S + steps), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    n_moe = cfg.num_layers - cfg.moe.first_dense
    router = RouterPin(moe, n_moe)

    def expanded(c, label, pin=True):
        """The cache-free forward over S + steps tokens: hidden states of the
        first S, logits at the positions the decode steps predict from."""
        router.label, router.pin, router.rows = label, pin, slice(None)
        hidden, _, _ = tx.forward(c, params, toks)
        return hidden[:, :S], logits_matmul(c, params["embedding"], hidden[:, S:]).float()

    def absorbed(c, label, pin=True):
        """Prefill S tokens into the latent cache, then decode the rest."""
        router.label, router.pin, router.rows = label, pin, slice(0, S)
        cache = tx.init_cache(c, 1, S + steps, device="cuda")
        hidden, cache, _ = tx.forward(c, params, toks[:, :S], cache=cache,
                                      ctx=tx.RunCtx(prefill=True))
        logits = []
        for i in range(steps):
            router.rows = slice(S + i, S + i + 1)
            pos = torch.full((1, 1), S + i, dtype=torch.int64, device="cuda")
            lg, cache = tx.decode_step(c, params, cache, toks[:, S + i:S + i + 1], pos)
            logits.append(lg[:, -1].float())
        if not bool(cache["moe"]["length"].eq(S + steps).all()):
            fail("deepseek: the latent cache's length is not the tokens it has seen")
        return hidden, torch.stack(logits, dim=1)

    counters = _kernel_counters()

    def launched(c, label):
        """``absorbed(c, label)`` and the kernel launches it made."""
        n0 = {k: _counter(ops.LAUNCHES) for k, ops in counters.items()}
        got = absorbed(c, label)
        torch.cuda.synchronize()
        return got, {k: _counter(ops.LAUNCHES) - n0[k] for k, ops in counters.items()}

    # the absorbed prefill is the reference impl's; with "pallas" (the zoo's
    # and the serving path's) a prefill's MLA takes K1
    acfg = cfg.replace(attention_impl="reference")
    pcfg = cfg.replace(attention_impl="pallas")
    real_update, real_flash = attention._update_latent_cache, attention._flash
    moe._router = router
    try:
        with torch.inference_mode(), eager_decode("the router is patched"):
            exact = expanded(cfg.replace(compute_dtype=torch.float32), "f32", pin=False)
            free = (expanded(cfg, "expanded", pin=False), absorbed(acfg, "absorbed", pin=False))
            ref = expanded(cfg, "expanded pinned")
            out, n = launched(acfg, "absorbed pinned")
            flash, n_flash = launched(pcfg, "flash pinned")
            attention._update_latent_cache = plant_latent_fault(real_update)
            try:
                bad = absorbed(acfg, LATENT_FAULT)
            finally:
                attention._update_latent_cache = real_update
            planted = {}
            for fault in FAULTS:
                attention._flash = plant_fault(real_flash, fault, 1)
                try:
                    planted[fault] = absorbed(pcfg, fault)
                finally:
                    attention._flash = real_flash
    finally:
        moe._router = router.real
    # free routing with the router as it is: the decode graphs' run against
    # the eager run made with RouterPin recording (it changes nothing unpinned)
    with torch.inference_mode():
        modes0 = graph_modes()
        graphed = absorbed(acfg, "graphs", pin=False)
        torch.cuda.synchronize()
        modes = {m: k - modes0[m] for m, k in graph_modes().items()}
    graphs = check_graph_run("deepseek full width", graphed, free[1], modes)
    del graphed

    def step_rel(a, b):
        return ((a - b).norm(dim=-1) / b.norm(dim=-1))[0]

    def noise_of(run_out):
        return {"forward": block_rel(run_out[0], exact[0], FORWARD_BLOCK),
                "decode": step_rel(run_out[1], exact[1])}

    def ratios(run_out, noise):
        mine = noise_of(run_out)
        return {k: (mine[k] / noise[k]).max().item() for k in mine}

    noise = noise_of(ref)
    got, worse = ratios(out, noise), ratios(bad, noise)
    # K1's run from the expanded run's distance, and from the reference-impl
    # run's (the same path but MLA's prefill attention)
    ref_noise = noise_of(out)
    got_flash = {"expanded": ratios(flash, noise), "reference": ratios(flash, ref_noise)}
    flash_faults = {f: ratios(b, ref_noise) for f, b in planted.items()}
    free_got = ratios(free[1], noise_of(free[0]))
    moved = {k: router.moved(k) for k in ("expanded", "absorbed")}
    span = lambda t: f"{t.min().item():.3e}-{t.max().item():.3e}"  # noqa: E731
    print(f"[model] deepseek full-width prefill (B=1, S={S}, absorbed MLA) + {steps} decode steps, "
          f"bf16, routing pinned to the f32 run's: against the f32-compute expanded forward, "
          f"expanded rel_l2 {rel(ref[0], exact[0]):.3e} (blocks {span(noise['forward'])}, decode "
          f"{span(noise['decode'])}), absorbed rel_l2 {rel(out[0], exact[0]):.3e} | worst "
          f"ratios: block {got['forward']:.3f}, decode {got['decode']:.3f} (tol "
          f"{FORWARD_NOISE}) | launches {n}")
    print(f"[model] deepseek with free routing: expanded rel_l2 {rel(free[0][0], exact[0]):.3e}, "
          f"absorbed rel_l2 {rel(free[1][0], exact[0]):.3e}, worst ratios block "
          f"{free_got['forward']:.3f}, decode {free_got['decode']:.3f} (reported, not held) | "
          f"prefill token-layer routings (of {n_moe} x {S}) unlike the f32 run's: {moved}")
    print(f"[model] planted fault '{LATENT_FAULT}': worst ratios block {worse['forward']:.3f}, "
          f"decode {worse['decode']:.3f} -> forward check "
          f"{'PASSED' if worse['forward'] <= FORWARD_NOISE else 'rejected'}")
    print(f"[model] deepseek serving prefill (MLA on K1, routed experts) + {steps} decode steps, "
          f"routing pinned: rel_l2 {rel(flash[0], exact[0]):.3e} from the f32 forward, "
          f"{rel(flash[0], out[0]):.3e} from the reference-impl run | worst ratios against the "
          f"expanded run's noise: block {got_flash['expanded']['forward']:.3f}, decode "
          f"{got_flash['expanded']['decode']:.3f}; against the reference-impl run's: block "
          f"{got_flash['reference']['forward']:.3f}, decode "
          f"{got_flash['reference']['decode']:.3f} (tol {FORWARD_NOISE}) | launches {n_flash}")
    for fault, b_ratio in flash_faults.items():
        print(f"[model] planted K1 fault '{fault}': worst block ratio {b_ratio['forward']:.3f} -> "
              f"{'PASSED' if b_ratio['forward'] <= FORWARD_NOISE else 'rejected'}")
    if out[0].shape != (1, S, cfg.d_model) or out[1].shape != (1, steps, cfg.vocab_size):
        fail(f"full-width deepseek run: wrong shapes {[tuple(t.shape) for t in out]}")
    if not all(bool(torch.isfinite(t).all()) for t in out):
        fail("full-width deepseek run: non-finite values")
    if worse["forward"] <= FORWARD_NOISE:
        fail(f"the deepseek check does not see the planted fault '{LATENT_FAULT}'")
    if any(n.values()):
        fail(f"deepseek's reference-impl path launched kernels: {n}")
    if max(got.values()) > FORWARD_NOISE:
        fail("full-width deepseek run: the absorbed form disagrees with the expanded form")
    want = {k: SERVE_LAUNCHES[arch].get(k, 0) for k in counters}
    if n_flash != want:
        fail(f"deepseek's serving prefill launched {n_flash}, not {want}")
    if not all(bool(torch.isfinite(t).all()) for t in flash):
        fail("full-width deepseek serving prefill: non-finite values")
    if max(max(r.values()) for r in got_flash.values()) > FORWARD_NOISE:
        fail("full-width deepseek run: MLA's prefill on K1 disagrees with the reference impl")
    for fault, b_ratio in flash_faults.items():
        if b_ratio["forward"] <= FORWARD_NOISE:
            fail(f"the deepseek K1 check does not see the planted fault '{fault}'")
    del ref, exact, out, bad, free, flash, planted
    res = {**sizes, "worst_block_ratio": got["forward"], "worst_decode_ratio": got["decode"],
           "free_routing_ratios": free_got, "routings_moved": moved, "fault_ratios": worse,
           "launches": n, "flash_ratios": got_flash, "flash_launches": n_flash,
           "flash_fault_ratios": flash_faults, "decode_graphs": graphs,
           "decode": decode_breakdown(tx, cfg, params)}
    del params
    torch.cuda.empty_cache()
    return res


def phase_model_dense(arch: str) -> dict:
    """One of DENSE_ARCHS at full width and depth (``CONFIG_CUTS``: bf16
    params for starcoder2-15b and granite-20b): the smoke config on the card
    against the CPU, ``forward_check`` at B=1, S=1024 (internvl2-2b's forward
    also takes its image positions' patch embeddings, from seed 0, so that
    they run through the kernel), the params' size and the peak memory,
    then the decode breakdown."""
    from repro_torch.models import transformer as tx

    smoke_check(tx, arch)
    cfg = cut_config(arch)
    params, sizes = init_full_params(tx, cfg, f"{arch} full width and depth")
    S = 1024
    toks = torch.randint(0, cfg.vocab_size, (1, S), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    fwd = {}
    if cfg.family == "vlm":
        fwd["patch_embeds"] = torch.randn((1, cfg.num_image_tokens, cfg.d_model), device="cuda",
                                          generator=torch.Generator(device="cuda").manual_seed(0))
    res = {**sizes, **forward_check(tx, cfg, params, toks, arch, **fwd)}
    torch.cuda.synchronize()
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    inputs = "".join(f" | {name} {tuple(t.shape)}" for name, t in fwd.items())
    print(f"[model] {arch}: peak memory of the init and the forward checks "
          f"{res['peak_bytes']:,} B of {torch.cuda.get_device_properties(0).total_memory:,} B"
          f"{inputs}")
    res["decode"] = decode_breakdown(tx, cfg, params)
    del params
    torch.cuda.empty_cache()
    return res


def plant_cross_fault(decode_forward):
    """``decode_forward`` (``whisper.decode_forward``) with a fault planted:
    a prefill that attends with the encoder output's cross K/V but leaves
    ``init_cache``'s zeros in the cache's cross buffers."""

    def faulty(cfg, params, tokens, enc_out, **kw):
        x, cache = decode_forward(cfg, params, tokens, enc_out, **kw)
        if enc_out is not None and cache is not None:
            cache["cross_k"].zero_()
            cache["cross_v"].zero_()
        return x, cache

    return faulty


def phase_model_whisper() -> dict:
    """whisper-tiny's model checks: the smoke config on the card against the
    CPU, then full width in bf16 (WHISPER_BATCH requests of 1500 frames and
    a WHISPER_PROMPT-token prompt through ``whisper.prefill``, then
    WHISPER_STEPS decode steps), held to the reference path's own distance
    from an f32-compute run over every block of FORWARD_BLOCK positions of
    the encoder output and of the prefill's hidden states and at every
    decode step's logits, with three planted faults; K1 must launch once a
    layer; then the decode breakdown."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import attention
    from repro_torch.models import whisper as wh

    arch = "whisper-tiny"
    gpu = gpu_name_and_limit()
    print(f"[model] whisper-tiny on {gpu}")
    smoke_check(wh, arch)
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = wh.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[model] whisper-tiny full width: {n_params:,} params ({n_params * 4 / 1e9:.3f} GB "
          f"f32) made in {time.perf_counter() - t0:.1f}s")
    B, S, steps, T = WHISPER_BATCH, WHISPER_PROMPT, WHISPER_STEPS, cfg.encoder_seq
    gen = torch.Generator(device="cuda").manual_seed(1)
    frames = torch.randn((B, T, cfg.d_model), device="cuda", generator=gen)
    toks = torch.randint(0, cfg.vocab_size, (B, S), device="cuda", generator=gen)
    fed = torch.randint(0, cfg.vocab_size, (B, steps), device="cuda", generator=gen)

    def run(c):
        """The encoder output (B, T, d) and the decoder's hidden states
        (B, S, d) of ``whisper.prefill``, caught on their way out, and the
        logits (B, steps, V) of the decode steps after it; every run is fed
        the same frames and tokens."""
        inner = {"encode": wh.encode, "decode_forward": wh.decode_forward}
        seen = []

        def catching(name):
            def fn(*args, **kw):
                out = inner[name](*args, **kw)
                seen.append(out if name == "encode" else out[0])
                return out
            return fn

        wh.encode, wh.decode_forward = catching("encode"), catching("decode_forward")
        try:
            cache = wh.init_cache(c, B, S + steps, T, device="cuda")
            _, cache = wh.prefill(c, params, toks, frames, cache)
            enc_out, hidden = seen
            logits = []
            for i in range(steps):
                pos = torch.full((B, 1), S + i, dtype=torch.int64, device="cuda")
                lg, cache = wh.decode_step(c, params, cache, fed[:, i:i + 1], pos)
                logits.append(lg[:, -1])
        finally:
            wh.encode, wh.decode_forward = inner["encode"], inner["decode_forward"]
        return enc_out, hidden, torch.stack(logits, dim=1)

    pcfg = cfg.replace(attention_impl="pallas")
    # (module, function, its faulty stand-in) for each fault of WHISPER_FAULTS
    faulty = {
        "encoder attention run causal": (
            attention, "_flash", plant_fault(attention._flash, "causal mask applied", 1)),
        "last kv tile skipped": (
            attention, "_flash", plant_fault(attention._flash, "last kv tile skipped", 1)),
        "prefill leaves init_cache's zeros in the cross K/V": (
            wh, "decode_forward", plant_cross_fault(wh.decode_forward)),
    }
    with torch.inference_mode():
        ref = run(cfg.replace(attention_impl="reference"))
        exact = run(cfg.replace(compute_dtype=torch.float32))
        n0 = _counter(fa_ops.LAUNCHES)
        out = run(pcfg)
        torch.cuda.synchronize()
        n = _counter(fa_ops.LAUNCHES) - n0
        planted = {}
        for fault in WHISPER_FAULTS:
            module, name, stand_in = faulty[fault]
            real = getattr(module, name)
            setattr(module, name, stand_in)
            try:
                planted[fault] = run(pcfg)
            finally:
                setattr(module, name, real)

    def step_rel(a, b):
        """Relative L2 error of each decode step's logits, over the batch."""
        return (a.float() - b.float()).norm(dim=(0, 2)) / b.float().norm(dim=(0, 2))

    noise = {"encoder": block_rel(ref[0], exact[0], FORWARD_BLOCK),
             "prefill": block_rel(ref[1], exact[1], FORWARD_BLOCK),
             "decode": step_rel(ref[2], exact[2])}

    def ratios(run_out):
        return {"encoder": (block_rel(run_out[0], exact[0], FORWARD_BLOCK)
                            / noise["encoder"]).max().item(),
                "prefill": (block_rel(run_out[1], exact[1], FORWARD_BLOCK)
                            / noise["prefill"]).max().item(),
                "decode": (step_rel(run_out[2], exact[2]) / noise["decode"]).max().item()}

    got = ratios(out)
    span = lambda t: f"{t.min().item():.3e}-{t.max().item():.3e}"  # noqa: E731
    print(f"[model] whisper full width (B={B}, {T} frames, prompt {S}) + {steps} decode steps, "
          f"bf16: against the f32-compute run, reference rel_l2 encoder "
          f"{rel(ref[0], exact[0]):.3e} (blocks {span(noise['encoder'])}), prefill "
          f"{rel(ref[1], exact[1]):.3e} (blocks {span(noise['prefill'])}), decode "
          f"{span(noise['decode'])}; kernel path rel_l2 encoder {rel(out[0], exact[0]):.3e}, "
          f"prefill {rel(out[1], exact[1]):.3e} | worst ratios: encoder block "
          f"{got['encoder']:.3f}, prefill block {got['prefill']:.3f}, decode "
          f"{got['decode']:.3f} (tol {FORWARD_NOISE}) | flash launches {n}")
    if (out[0].shape != (B, T, cfg.d_model) or out[1].shape != (B, S, cfg.d_model)
            or out[2].shape != (B, steps, cfg.vocab_size)):
        fail(f"full-width whisper run: wrong shapes {[tuple(t.shape) for t in out]}")
    if not all(bool(torch.isfinite(t).all()) for t in out):
        fail("full-width whisper run: non-finite values")
    worse = {}
    for fault, check in WHISPER_FAULTS.items():
        bad = worse[fault] = ratios(planted[fault])
        print(f"[model] planted fault '{fault}': worst ratios encoder block {bad['encoder']:.3f}, "
              f"prefill block {bad['prefill']:.3f}, decode {bad['decode']:.3f} -> {check} "
              f"check {'PASSED' if bad[check] <= FORWARD_NOISE else 'rejected'}")
        if bad[check] <= FORWARD_NOISE:
            fail(f"the {check} check does not see the planted fault '{fault}'")
    if n != SERVE_LAUNCHES[arch]["flash_attention"]:
        fail(f"full-width whisper run launched flash {n} times, not "
             f"{SERVE_LAUNCHES[arch]['flash_attention']}")
    if max(got.values()) > FORWARD_NOISE:
        fail("full-width whisper run: kernel path disagrees with the reference")
    del ref, exact, out, planted
    res = {"params": n_params, "ratios": got, "fault_ratios": worse, "flash_launches": n,
           "decode": decode_breakdown(wh, cfg, params, PL=S, frames=frames), "gpu": gpu}
    del params
    torch.cuda.empty_cache()
    return res


def phase_serve_whisper() -> dict:
    """whisper-tiny served through ``whisper.prefill``/``decode_step`` (the
    serve driver refuses an encoder-decoder arch, as the JAX driver serves
    none of its requests): 8 requests, each of 1500 frames
    and a WHISPER_PROMPT-token prompt, all there at the start, in batches of
    WHISPER_BATCH, WHISPER_GEN greedy tokens each.  Launch counts are set to
    0 just before and read just after: K1 exactly SERVE_LAUNCHES times a
    prefill, no other kernel."""
    from repro_torch.configs import get_config
    from repro_torch.models import whisper as wh

    arch = "whisper-tiny"
    cfg = get_config(arch, attention_impl="pallas")
    params = wh.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    B, PL, G, n_req = WHISPER_BATCH, WHISPER_PROMPT, WHISPER_GEN, 8
    gen = torch.Generator(device="cuda").manual_seed(3)
    frames = torch.randn((n_req, cfg.encoder_seq, cfg.d_model), device="cuda", generator=gen)
    prompts = torch.randint(0, cfg.vocab_size, (n_req, PL), device="cuda", generator=gen)
    counters = _kernel_counters()
    torch.cuda.synchronize()
    for ops in counters.values():
        _reset_counters(ops.LAUNCHES)  # counts of this path only
    prefill_s = decode_s = 0.0
    prefills, outs, latency_ms = 0, [], []
    t_start = time.perf_counter()
    with torch.inference_mode():
        for b0 in range(0, n_req, B):
            cache = wh.init_cache(cfg, B, PL + G + 1, cfg.encoder_seq, device="cuda")
            t0 = time.perf_counter()
            logits, cache = wh.prefill(cfg, params, prompts[b0:b0 + B], frames[b0:b0 + B], cache)
            torch.cuda.synchronize()
            prefill_s += time.perf_counter() - t0
            prefills += 1
            tok = logits[:, -1:].argmax(-1)
            toks = [tok]
            t0 = time.perf_counter()
            for i in range(G - 1):
                pos = torch.full((B, 1), PL + i, dtype=torch.int64, device="cuda")
                logits, cache = wh.decode_step(cfg, params, cache, tok, pos)
                tok = logits[:, -1:].argmax(-1)
                toks.append(tok)
            torch.cuda.synchronize()
            decode_s += time.perf_counter() - t0
            outs.extend(torch.cat(toks, dim=1).cpu().numpy())
            latency_ms += [(time.perf_counter() - t_start) * 1e3] * B
    launches = {name: _counter(ops.LAUNCHES) for name, ops in counters.items()}
    res = {"launches": launches, "prefill_s": prefill_s,
           "decode_tok_s": n_req * (G - 1) / decode_s, "prefills": prefills,
           "latency_p50_ms": float(np.percentile(latency_ms, 50)),
           "latency_p99_ms": float(np.percentile(latency_ms, 99))}
    print(f"[serve] {arch}: {n_req} requests, {prefills} batches of {B} ({cfg.encoder_seq} "
          f"frames, prompt {PL}, {G} tokens) | prefill {prefill_s:.4f}s | decode "
          f"{res['decode_tok_s']:.2f} tok/s | latency p50 {res['latency_p50_ms']:.2f} ms p99 "
          f"{res['latency_p99_ms']:.2f} ms | launches {launches} | {gpu_name_and_limit()}")
    check_served(arch, outs, G, cfg.vocab_size, launches, prefills)
    del params
    torch.cuda.empty_cache()
    return res


def phase_serve_cut(argv: list[str]) -> dict:
    """``phase_serve`` of an arch with its ``CONFIG_CUTS`` applied through a
    spy on the serve module's ``get_config``."""
    from repro_torch.launch import serve as serve_mod

    real = serve_mod.get_config
    serve_mod.get_config = lambda arch, **kw: real(arch, **kw).replace(**CONFIG_CUTS[arch])
    try:
        return phase_serve(argv)
    finally:
        serve_mod.get_config = real


def _cache_step_bytes(cache) -> int:
    """Bytes a decode step moves in the cache: every buffer read once, and an
    SSM layer's conv tail and state written back whole."""
    return sum(t.numel() * t.element_size() * (2 if name.endswith(("/conv", "/state")) else 1)
               for name, t in _named_leaves(cache))


def decode_breakdown(tx, cfg, params, PL: int = 1024, frames=None) -> dict:
    """Serving decode step at batch 4 after a PL-token prefill, outside the
    server: host time per step, device kernel time per step from the
    profiler, and the step's bound from the bytes it must move; and the
    peak memory of the prefill.  With ``frames`` (4, T, d) the model is the
    encoder-decoder (``tx`` is ``models.whisper``): its prefill encodes
    them, the cache holds their cross K/V, and the bound leaves out the
    encoder, which a decode step does not run, and the position tables,
    which it only gathers."""
    B, steps = 4, 8
    pcfg = cfg.replace(attention_impl="pallas")
    toks = torch.randint(0, cfg.vocab_size, (B, PL), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(2))
    enc = () if frames is None else (frames,)
    with torch.inference_mode():
        cache = tx.init_cache(cfg, B, PL + 2 * steps + 8, *(f.shape[1] for f in enc),
                              device="cuda")
        cache_bytes = _cache_step_bytes(cache)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        logits, cache = tx.prefill(pcfg, params, toks, *enc, cache)
        torch.cuda.synchronize()
        prefill_peak = torch.cuda.max_memory_allocated()
        tok = logits[:, -1:].argmax(-1)
        pos = [PL]

        def step():
            nonlocal tok, cache
            p = torch.full((B, 1), pos[0], dtype=torch.int64, device="cuda")
            lg, cache = tx.decode_step(pcfg, params, cache, tok, p)
            tok = lg[:, -1:].argmax(-1)
            pos[0] += 1

        step()
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) is not None and "CUDA" in str(e.device_type)]
    dev_us = sum(e.self_device_time_total for e in kernels) / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    # bytes a step must move as the port runs it: every matrix is read and,
    # unless it is kept in the compute dtype (bf16), cast (written) and read
    # again; vectors read once; the cache.  An untied embedding table is only
    # gathered (B rows, left out); a tied one is read whole by the logits.
    skip = () if frames is None else ("/encoder/", "/enc_pos", "/dec_pos", "/enc_norm/")
    weights = [t for path, t in _named_leaves(params)
               if (path != "/embedding/embed" or "unembed" not in params["embedding"])
               and not path.startswith(skip)]
    n_mat = sum(t.numel() for t in weights if t.dim() >= 2)
    step_bytes = cache_bytes + sum(
        t.numel() * (t.element_size() + (4 if t.dim() >= 2 and t.dtype != cfg.compute_dtype
                                          else 0)) for t in weights)
    # bf16 weights kept on the card, read once
    bf16_bytes = cache_bytes + n_mat * 2 + sum(
        t.numel() * t.element_size() for t in weights if t.dim() < 2)
    res = {
        "prefill_peak_bytes": prefill_peak,
        "host_ms_per_step": host_ms,
        "device_ms_per_step": dev_us / 1e3 if dev_us else None,
        "bound_ms_as_run": step_bytes / PEAK_BYTES * 1e3,
        "bound_ms_bf16_weights": bf16_bytes / PEAK_BYTES * 1e3,
        "top_kernels": [(e.key[:80], e.self_device_time_total / steps / 1e3) for e in top],
    }
    busy = f"{res['device_ms_per_step']:.3f} ms" if dev_us else "not measured"
    print(f"[decode] B={B} after S={PL}: {host_ms:.3f} ms/step on the host clock | device "
          f"kernels {busy}/step | bound as run {res['bound_ms_as_run']:.3f} ms "
          f"({step_bytes / 1e9:.2f} GB, of it cache {cache_bytes / 1e9:.3f} GB), with bf16 weights "
          f"{res['bound_ms_bf16_weights']:.3f} ms | the B={B} prefill's peak memory "
          f"{prefill_peak:,} B")
    for name, ms in res["top_kernels"]:
        print(f"[decode]   {ms:.4f} ms/step  {name}")
    return res


def _leaves(tree):
    return (t for _, t in _named_leaves(tree))


def _to(tree, device):
    """A copy of ``tree`` on ``device``."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device, copy=True)


def check_served(arch: str, outs: list, gen: int, vocab: int, launches: dict,
                 prefills: int) -> None:
    """8 generations of ``gen`` tokens within the vocabulary, and each
    kernel launched exactly ``SERVE_LAUNCHES[arch]`` times a prefill."""
    if len(outs) != 8:
        fail(f"served {len(outs)}/8 requests")
    for o in outs:
        if o.shape != (gen,) or o.min() < 0 or o.max() >= vocab:
            fail(f"bad generation {o}")
    want = {name: SERVE_LAUNCHES[arch].get(name, 0) * prefills for name in launches}
    if launches != want or prefills == 0:
        fail(f"{arch} serve launched {launches} in {prefills} prefills, not {want}")


def phase_serve(argv: list[str]) -> dict:
    """Serve 8 requests of ``argv``'s arch; each kernel of its path must
    launch exactly ``SERVE_LAUNCHES[arch][kernel]`` times a prefill, and no
    other kernel at all."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import parse_args, serve

    counters = _kernel_counters()
    args = parse_args(argv)
    cfg = get_config(args.arch)
    for ops in counters.values():
        _reset_counters(ops.LAUNCHES)  # counts of this path only
    res = serve(args)
    launches = {name: _counter(ops.LAUNCHES) for name, ops in counters.items()}
    sstats = res["server"]
    print(f"[serve] {args.arch}: {res['requests']} requests, {sstats['batches']} batches, "
          f"{res['prefills']} prefills | prefill {res['prefill_s']:.4f}s | "
          f"decode {res['decode_tok_s']:.2f} tok/s | latency p50 {sstats['latency_p50_ms']:.2f} ms "
          f"p99 {sstats['latency_p99_ms']:.2f} ms | launches {launches}")
    check_served(args.arch, res["outputs"], args.gen, cfg.vocab_size, launches, res["prefills"])
    return {"launches": launches, **{k: res[k] for k in ("prefill_s", "decode_tok_s", "prefills")},
            "latency_p50_ms": sstats["latency_p50_ms"], "latency_p99_ms": sstats["latency_p99_ms"]}


# -- phase 4: training -----------------------------------------------------------------


class _Tee:
    """Standard output that is also kept, to read the driver's lines."""

    def __init__(self, stream):
        self.stream, self.lines = stream, []

    def write(self, text):
        self.lines.append(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()


def _counter(name: str) -> int:
    """A counter of the port's tracer (``repro_torch.runtime.trace``)."""
    from repro_torch.runtime import trace

    return trace.counter(name)


def _reset_counters(*names: str) -> None:
    from repro_torch.runtime import trace

    trace.reset_counts(*names)


def _kernel_counters() -> dict:
    """Each kernel's wrapper module, whose ``LAUNCHES`` names its counter."""
    from repro_torch.kernels.fingerprint import ops as fp_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    return {"flash_attention": fa_ops, "ssd_scan": ssd_ops, "fingerprint": fp_ops}


def _host_copy(tree) -> list:
    """(path, numpy copy) of every leaf, in the checkpoint's leaf order."""
    from repro_torch import bridge

    return [(path, np.array(bridge.to_numpy(t) if isinstance(t, torch.Tensor) else t))
            for path, t in bridge.flatten(tree)]


def _run_store(run_dir: str, arch: str):
    from repro_torch.api import ConnectorSpec, StoreConfig
    from repro_torch.train.checkpoint import CheckpointManager

    store = StoreConfig(f"train-{arch}", ConnectorSpec(
        "sharded", store_dir=f"{run_dir}/objects", num_shards=8)).build(register=True)
    return store, CheckpointManager(store, f"{run_dir}/ckpt_index.json")


def train_driver(run_dir: str) -> dict:
    """4a: the train driver at full mamba2-130m width."""
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.launch.train import parse_args, train
    from repro_torch.models import transformer as tx
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    args = parse_args(TRAIN_ARGS + ["--run-dir", run_dir])
    cfg = get_config(args.arch)
    # a checkpoint holds f32 params, m and v, and the int32 step
    n_params = sum(t.numel() for _, t in bridge.flatten(
        tx.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))))
    reckoned = 3 * 4 * n_params + 4
    counters = _kernel_counters()
    for ops in counters.values():
        _reset_counters(ops.LAUNCHES)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train(args)
    secs = time.perf_counter() - t0
    launches = {name: _counter(ops.LAUNCHES) for name, ops in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    log = out["log"]
    losses = [e["loss"] for e in log]
    if len(log) != args.steps or not all(np.isfinite(losses)):
        fail(f"train driver: {len(log)} logged steps, losses {losses}")
    if any(launches.values()):
        fail(f"the training path launched kernels: {launches}")
    step_s = [e["seconds_since_last_log"] for e in log if e["step"] >= 1]  # all but the first
    med_ms = float(np.median(step_s)) * 1e3
    tok_s = len(step_s) * args.batch * args.seq / sum(step_s)
    index = json.loads((Path(run_dir) / "ckpt_index.json").read_text())
    cps = index["checkpoints"]
    if [m["step"] for m in cps] != [10, 20, 30] or len(cps) != args.keep_checkpoints:
        fail(f"train driver kept checkpoints {[m['step'] for m in cps]}")
    if any(m["nbytes"] != reckoned for m in cps):
        fail(f"checkpoints of {[m['nbytes'] for m in cps]} B, reckoned {reckoned} B")
    print(f"[train] {args.arch} driver, batch {args.batch} x seq {args.seq}, {args.steps} steps "
          f"in {secs:.2f}s: loss {losses[0]:.4f} -> {losses[-1]:.4f} | steps 1-{args.steps - 1}: "
          f"median {med_ms:.3f} ms/step, {tok_s:,.0f} tokens/s (whole run "
          f"{log[-1]['tokens_per_s']:,.0f}) | peak memory {peak:,} B | launches {launches}")
    # a save's snapshot (a host copy) lands in the step logged after it
    after_save = {e["step"]: e["seconds_since_last_log"] * 1e3 for e in log
                  if e["step"] - 1 in (10, 20)}
    for m in cps:
        print(f"[train]   checkpoint step {m['step']}: {m['nbytes']:,} B (reckoned 3 x 4 B x "
              f"{n_params:,} params + 4 B) in {len(m['keys'])} leaves, saved in "
              f"{m['save_seconds']:.3f}s off the step path")
    print(f"[train]   steps that follow a save (its snapshot is on the step path): "
          f"{', '.join(f'step {k} {v:.1f} ms' for k, v in after_save.items())}")
    state = init_train_state(cfg, torch.Generator(device="cuda").manual_seed(0))
    tokens = _token_batch(cfg, args.batch, args.seq, 0).cuda()
    breakdown, _ = step_breakdown(f"{args.arch} batch {args.batch} x seq {args.seq}",
                                  make_train_step(cfg, AdamWConfig()), state,
                                  {"tokens": tokens}, 3)
    del state
    return {"seconds": secs, "losses": losses, "median_step_ms": med_ms, "tokens_per_s": tok_s,
            "step_ms": [x * 1e3 for x in step_s], "peak_bytes": peak, "launches": launches,
            "checkpoints": [{k: m[k] for k in ("step", "nbytes", "save_seconds")} for m in cps],
            "after_save_ms": after_save, "params": n_params, "ckpt_nbytes": reckoned,
            "breakdown": breakdown}


def step_breakdown(label: str, step, state, batch: dict, steps: int) -> tuple[dict, dict]:
    """A train step outside the driver: host time a step, device kernel
    time a step from the profiler, the idle share, and the top kernels;
    returns them and the state after the steps."""
    from torch.profiler import ProfilerActivity, profile

    state, _ = step(state, batch)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) is not None and "CUDA" in str(e.device_type)]
    dev_ms = sum(e.self_device_time_total for e in kernels) / steps / 1e3
    n_kernels = sum(e.count for e in kernels) / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    res = {"host_ms_per_step": host_ms, "device_ms_per_step": dev_ms or None,
           "kernels_per_step": n_kernels,
           "top_kernels": [(e.key[:80], e.self_device_time_total / steps / 1e3) for e in top]}
    idle = f"{100 * (1 - dev_ms / host_ms):.1f} %" if dev_ms else "not measured"
    print(f"[train] step breakdown, {label}: {host_ms:.3f} ms/step on the host clock | device "
          f"kernels {dev_ms:.3f} ms/step ({n_kernels:,.0f} kernels) | device idle {idle}")
    for name, ms in res["top_kernels"]:
        print(f"[train]   {ms:.4f} ms/step  {name}")
    return res, state


def train_restart(run_dir: str) -> dict:
    """4b: a second run on the same run dir resumes from step 30."""
    from repro_torch import bridge
    from repro_torch.core.connectors.base import Key
    from repro_torch.launch import train as train_mod

    store, ckpt = _run_store(run_dir, "mamba2-130m")
    t0 = time.perf_counter()
    step, saved = ckpt.restore()
    restore_s = time.perf_counter() - t0
    saved = bridge.flatten(saved)
    evicted = [m["keys"] for m in ckpt._index["checkpoints"] if m["step"] < step]
    seen = {}
    real = train_mod.make_train_step

    def spy(cfg, opt_cfg, ctx):
        fn = real(cfg, opt_cfg, ctx)

        def step_fn(state, batch):
            if "state" not in seen:  # a copy: the step updates the state in place
                seen["state"] = _host_copy(state)
            return fn(state, batch)

        return step_fn

    argv = list(TRAIN_ARGS)
    argv[argv.index("--steps") + 1] = str(RESTART_STEPS)
    tee = _Tee(sys.stdout)
    train_mod.make_train_step = spy
    sys.stdout = tee
    try:
        t0 = time.perf_counter()
        out = train_mod.train(train_mod.parse_args(argv + ["--run-dir", run_dir]))
        secs = time.perf_counter() - t0
    finally:
        sys.stdout = tee.stream
        train_mod.make_train_step = real
    if f"[restore] resumed from step {step}\n" not in "".join(tee.lines) or step != 30:
        fail(f"the restarted run did not print '[restore] resumed from step 30' (latest {step})")
    got = seen["state"]
    if [p for p, _ in got] != [p for p, _ in saved]:
        fail("the restarted run's state has other leaves than the checkpoint")
    differ = [p for (p, a), (_, b) in zip(got, saved)
              if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(a, b)]
    if differ:
        fail(f"the restarted run did not start from the checkpoint: {differ}")
    cps = json.loads((Path(run_dir) / "ckpt_index.json").read_text())["checkpoints"]
    steps = [m["step"] for m in cps]
    if steps[-1] != RESTART_STEPS or len(steps) != 3:
        fail(f"the restarted run kept checkpoints {steps}")
    alive = [store.exists(Key(k["object_id"], k["size"], k["tag"])) for ks in evicted for k in ks]
    if not evicted or any(alive):
        fail(f"evicted checkpoints' keys: {sum(alive)} of {len(alive)} still in the store")
    losses = [e["loss"] for e in out["log"]]
    if [e["step"] for e in out["log"]] != list(range(step, RESTART_STEPS)) or \
            not all(np.isfinite(losses)):
        fail(f"the restarted run logged {[e['step'] for e in out['log']]}, losses {losses}")
    print(f"[train] restart: resumed from step {step} with the checkpoint's {len(got)} leaves "
          f"bit for bit, steps {step}-{RESTART_STEPS - 1} in {secs:.2f}s, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} | checkpoints now {steps}; the "
          f"{len(alive)} keys of the {len(evicted)} evicted ones are gone from the store | "
          f"eager restore of the step-{step} checkpoint ({sum(a.nbytes for _, a in saved):,} B "
          f"to host memory) {restore_s:.3f}s")
    return {"seconds": secs, "resumed_from": step, "checkpoints": steps, "losses": losses,
            "evicted_keys": len(alive), "restore_seconds": restore_s}


def _token_batch(cfg, batch: int, seq: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32))


def card_against_cpu(label: str, cfg, batch: dict, router: RouterPin | None = None) -> dict:
    """One train step from the same state (seed 0) and batch on the CPU and
    on the card: loss and grad norm within TRAIN_RTOL (relative), every
    leaf's first moment within MOMENT_REL_L2 (relative L2).  With a
    ``RouterPin`` installed (an MoE arch) the CPU's step records its routing
    as "f32" and the card steps twice from the same state, once routing
    freely and once pinned to the CPU's experts; the free step is held when
    every token chose the CPU's experts, else the pinned one (a top-k tie
    that fell the other way moves a token by a whole expert's output), and
    both are printed."""
    from repro_torch import bridge
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    state_cpu = init_train_state(cfg, torch.Generator().manual_seed(0))
    runs = ("card",) if router is None else ("card", "card pinned")
    states = {run: _to(state_cpu, "cuda") for run in runs}
    step = make_train_step(cfg, AdamWConfig())

    def timed_step(run, state, b):
        if router is not None:
            router.label, router.pin = run, run == "card pinned"
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        loss, gn = float(metrics["loss"]), float(metrics["grad_norm"])
        return state, loss, gn, time.perf_counter() - t0

    state_cpu, loss_c, gn_c, cpu_s = timed_step("f32", state_cpu, batch)
    res = {}
    for run in runs:
        state, loss_g, gn_g, gpu_s = timed_step(run, states.pop(run), _to(batch, "cuda"))
        worst = max(rel(a.cpu(), b) for (_, a), (_, b) in zip(
            bridge.flatten(state["opt"]["m"]), bridge.flatten(state_cpu["opt"]["m"])))
        del state
        ok = (abs(loss_g / loss_c - 1) <= TRAIN_RTOL and abs(gn_g / gn_c - 1) <= TRAIN_RTOL
              and worst <= MOMENT_REL_L2)
        res[run] = {"loss_card": loss_g, "loss_cpu": loss_c, "grad_norm_card": gn_g,
                    "grad_norm_cpu": gn_c, "m_rel_l2": worst, "within": ok}
        pinned = ", routing pinned to the CPU's" if run == "card pinned" else ""
        print(f"[train] {label}, f32 compute{pinned}: loss card {loss_g:.7f} CPU {loss_c:.7f} "
              f"(rel {abs(loss_g / loss_c - 1):.2e}, tol {TRAIN_RTOL}) | grad_norm card "
              f"{gn_g:.7f} CPU {gn_c:.7f} (rel {abs(gn_g / gn_c - 1):.2e}) | worst leaf's m "
              f"rel_l2 {worst:.2e} (tol {MOMENT_REL_L2}) | step {gpu_s:.3f}s card (first), "
              f"{cpu_s:.3f}s CPU")
    held = "card"
    if router is not None:
        moved = router.moved("card")
        held = "card" if moved == 0 else "card pinned"
        print(f"[train] {label}: token-layer pairs routed to other experts on the card than on "
              f"the CPU {moved}; held: the {held} step")
        res["card"]["moved"] = moved
    if not res[held]["within"]:
        fail(f"{label}: the train step on the card disagrees with the CPU")
    return res["card"] if router is None else {**res[held], "held": held, "runs": res}


def train_card_vs_cpu() -> dict:
    """4c: one step on the card against the same step on the CPU, then the
    bf16-compute step's loss against the f32 loss."""
    from repro_torch.configs import get_config
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    cfg = get_config("mamba2-130m").replace(compute_dtype=torch.float32)
    tokens = _token_batch(cfg, 2, 256, 4)
    res = card_against_cpu("mamba2-130m one step, batch 2 x seq 256", cfg, {"tokens": tokens})
    state_bf16 = _to(init_train_state(cfg, torch.Generator().manual_seed(0)), "cuda")
    _, mb = make_train_step(cfg.replace(compute_dtype=torch.bfloat16), AdamWConfig())(
        state_bf16, {"tokens": tokens.cuda()})
    loss_b = float(mb["loss"])
    ratio = loss_b / res["loss_card"]
    print(f"[train] mamba2-130m the same step in bf16 compute: loss {loss_b:.7f}, bf16 / f32 "
          f"{ratio:.6f} (tol {BF16_LOSS_REL})")
    if not abs(ratio - 1) <= BF16_LOSS_REL:
        fail("the bf16-compute train step's loss is too far from the f32 loss")
    return {**res, "loss_bf16": loss_b, "bf16_over_f32": ratio}


def train_archs_card_vs_cpu() -> dict:
    """4c for every decoder family: one step of each TRAIN_CHECK_ARCHS
    arch's smoke config, f32 compute, card against CPU (``card_against_cpu``;
    the MoE archs with a ``RouterPin``).  internvl2-2b's batch carries patch
    embeddings, which neither train driver's data makes."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe

    B, S = TRAIN_CHECK_BATCH
    out = {}
    for i, arch in enumerate(TRAIN_CHECK_ARCHS):
        cfg = get_smoke_config(arch).replace(compute_dtype=torch.float32)
        batch = {"tokens": _token_batch(cfg, B, S, 20 + i)}
        if cfg.family == "vlm":
            rng = np.random.default_rng(40 + i)
            batch["patch_embeds"] = torch.from_numpy(rng.normal(
                size=(B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32))
        router = RouterPin(moe, cfg.num_layers - cfg.moe.first_dense) \
            if cfg.family == "moe" else None
        if router is not None:
            moe._router = router
        try:
            out[arch] = card_against_cpu(f"{arch} smoke, one step, batch {B} x seq {S}", cfg,
                                         batch, router)
        finally:
            if router is not None:
                moe._router = router.real
    return out


def loss_falls(label: str, cfg, batch: dict) -> dict:
    """Five steps on one repeated batch must cut the loss by LOSS_FALL; the
    same check must reject a planted fault (the optimizer's lr forced to 0)."""
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    def losses_of(lr: float) -> list[float]:
        state = init_train_state(cfg, torch.Generator(device="cuda").manual_seed(1))
        step = make_train_step(cfg, AdamWConfig(lr=lr, warmup_steps=0))
        out = []
        for _ in range(5):
            state, metrics = step(state, batch)
            out.append(float(metrics["loss"]))
        return out

    falls = lambda ls: ls[-1] < (1 - LOSS_FALL) * ls[0]  # noqa: E731
    losses, planted = losses_of(3e-3), losses_of(0.0)
    print(f"[train] {label} 5 steps on one batch (lr 3e-3): losses "
          f"{', '.join(f'{x:.4f}' for x in losses)} -> {'falls' if falls(losses) else 'FLAT'} | "
          f"planted fault 'lr forced to 0': {', '.join(f'{x:.4f}' for x in planted)} -> "
          f"{'PASSED' if falls(planted) else 'rejected'}")
    if not falls(losses):
        fail(f"{label}: the loss does not fall over five steps on one batch")
    if falls(planted):
        fail(f"{label}: the loss check does not see the planted fault 'lr forced to 0'")
    return {"losses": losses, "planted_lr0": planted}


def train_loss_falls() -> dict:
    """4d: ``loss_falls`` at full mamba2-130m width, batch 2 x seq 256."""
    from repro_torch.configs import get_config

    cfg = get_config("mamba2-130m")
    return loss_falls("mamba2-130m", cfg, {"tokens": _token_batch(cfg, 2, 256, 5).cuda()})


def _sliced_run_group(cfg, group, gparams, x, positions, gcache, ctx):
    """The layer loop before ``unbind``: each layer indexed out of the stacks."""
    from repro_torch.models import transformer as tx

    apply = tx._remat_wrap(cfg, tx._apply_layer) if torch.is_grad_enabled() else tx._apply_layer
    for i in range(group.count):
        lp = tx._tree_map(lambda t: t[i], gparams)
        x, _ = apply(cfg, group, lp, x, positions, None, ctx)  # dense layers: no aux
    return x, None


def train_dense() -> dict:
    """4e: qwen2.5-3b at full width, full remat; no kernel on the training
    steps; the sliced loop for comparison; a pallas step must raise."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tx
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    B, S, steps = DENSE_TRAIN
    cfg = get_config("qwen2.5-3b").replace(remat="full")
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    state_bytes = torch.cuda.memory_allocated()
    tokens = torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(3))
    counters = _kernel_counters()
    for ops in counters.values():
        _reset_counters(ops.LAUNCHES)
    step = make_train_step(cfg, AdamWConfig())

    def timed(n):
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            nonlocal state
            state, metrics = step(state, {"tokens": tokens})
            loss, gn = float(metrics["loss"]), float(metrics["grad_norm"])
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0, loss, gn))
        return out

    runs = timed(steps)
    peak = torch.cuda.max_memory_allocated()
    launches = {name: _counter(ops.LAUNCHES) for name, ops in counters.items()}
    breakdown, state = step_breakdown(f"qwen2.5-3b remat full, batch {B} x seq {S}", step,
                                      state, {"tokens": tokens}, 1)
    real = tx._run_group
    torch.cuda.reset_peak_memory_stats()
    tx._run_group = _sliced_run_group
    try:  # the same measurement as the breakdown above, on the old loop
        sliced, state = step_breakdown(
            "the same, each layer indexed out of the stacks (the loop before unbind)", step,
            state, {"tokens": tokens}, 1)
    finally:
        tx._run_group = real
    sliced_peak = torch.cuda.max_memory_allocated()
    done = int(state["opt"]["step"])
    before = state["params"]["final_norm"]["scale"].clone()
    try:
        make_train_step(cfg.replace(attention_impl="pallas"), AdamWConfig())(
            state, {"tokens": tokens})
    except RuntimeError as exc:
        raised = str(exc)
    else:
        fail("a pallas train step on the card did not raise")
    untouched = (int(state["opt"]["step"]) == done
                 and torch.equal(state["params"]["final_norm"]["scale"], before))
    pallas_launches = {name: _counter(ops.LAUNCHES) for name, ops in counters.items()}
    step_s = [r[0] for r in runs]
    med = float(np.median(step_s[1:]))
    print(f"[train] qwen2.5-3b full width, remat full, batch {B} x seq {S}: state "
          f"{state_bytes:,} B (params + m + v) | steps "
          f"{', '.join(f'{r[0] * 1e3:.1f}' for r in runs)} ms, losses "
          f"{', '.join(f'{r[1]:.4f}' for r in runs)}, grad_norm "
          f"{', '.join(f'{r[2]:.4f}' for r in runs)} | all but the first: median "
          f"{med * 1e3:.1f} ms, "
          f"{B * S / med:,.0f} tokens/s | peak memory {peak:,} B | launches {launches}")
    ms = lambda v: f"{v:.1f} ms" if v else "not measured"  # noqa: E731
    print(f"[train]   the loop before unbind against unbind: host "
          f"{ms(sliced['host_ms_per_step'])} / {ms(breakdown['host_ms_per_step'])}, device "
          f"{ms(sliced['device_ms_per_step'])} / {ms(breakdown['device_ms_per_step'])} a "
          f"step; peak memory {sliced_peak:,} / {peak:,} B | pallas step: raised "
          f"'{raised}', state untouched {untouched}, launches {pallas_launches}")
    if not all(np.isfinite([r[1] for r in runs] + [r[2] for r in runs])):
        fail("qwen2.5-3b training: non-finite loss or grad norm")
    if any(launches.values()) or any(pallas_launches.values()):
        fail(f"qwen2.5-3b training launched kernels: {launches} / {pallas_launches}")
    if "no backward" not in raised or not untouched:
        fail("the pallas train step did not refuse cleanly")
    del state, before
    torch.cuda.empty_cache()
    return {"state_bytes": state_bytes, "step_ms": [x * 1e3 for x in step_s],
            "median_step_ms": med * 1e3, "tokens_per_s": B * S / med,
            "losses": [r[1] for r in runs], "grad_norms": [r[2] for r in runs],
            "peak_bytes": peak, "sliced": sliced, "sliced_peak_bytes": sliced_peak,
            "launches": launches, "breakdown": breakdown}


def _whisper_batch(cfg, batch: int, seq: int, seed: int, device) -> dict:
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    frames = rng.normal(size=(batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return {"tokens": torch.from_numpy(tokens).to(device),
            "frame_embeds": torch.from_numpy(frames).to(device)}


def train_whisper() -> dict:
    """4g: whisper-tiny's train step (the JAX train driver makes no frame
    embeddings, so the step is driven directly).  The smoke config in f32 on
    the card against the CPU (loss, grad norm, every leaf's first moment,
    within TRAIN_RTOL / MOMENT_REL_L2); then full width with f32 params,
    bf16 compute and reference attention (K1 has no backward) at
    WHISPER_TRAIN: finite losses and grad norms, median step, tokens/s,
    peak memory, a step breakdown, no kernel launched; five steps on one
    batch must cut the loss, and must not with the lr forced to 0."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    arch = "whisper-tiny"
    cfg = get_smoke_config(arch)
    res = {"card_vs_cpu": card_against_cpu(
        "whisper-tiny smoke, one step", cfg,
        _whisper_batch(cfg, 4, cfg.max_target_len - 8, 6, "cpu"))}

    B, S, steps = WHISPER_TRAIN
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, torch.Generator(device="cuda").manual_seed(0))
    batch = _whisper_batch(cfg, B, S, 7, "cuda")
    counters = _kernel_counters()
    for ops in counters.values():
        _reset_counters(ops.LAUNCHES)
    step = make_train_step(cfg, AdamWConfig())
    runs = []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss, gn = float(metrics["loss"]), float(metrics["grad_norm"])
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, loss, gn))
    peak = torch.cuda.max_memory_allocated()
    launches = {name: _counter(ops.LAUNCHES) for name, ops in counters.items()}
    breakdown, state = step_breakdown(f"whisper-tiny, batch {B} x {S} tokens x "
                                      f"{cfg.encoder_seq} frames", step, state, batch, 1)
    med = float(np.median([r[0] for r in runs]))
    print(f"[train] whisper-tiny full width, batch {B} x {S} tokens x {cfg.encoder_seq} frames: "
          f"steps {', '.join(f'{r[0] * 1e3:.1f}' for r in runs)} ms, losses "
          f"{', '.join(f'{r[1]:.4f}' for r in runs)}, grad_norm "
          f"{', '.join(f'{r[2]:.4f}' for r in runs)} | median {med * 1e3:.1f} ms, "
          f"{B * S / med:,.0f} target tokens/s | peak memory {peak:,} B | launches {launches} | "
          f"{gpu_name_and_limit()}")
    if not all(np.isfinite([r[1] for r in runs] + [r[2] for r in runs])):
        fail("whisper training: non-finite loss or grad norm")
    if any(launches.values()):
        fail(f"whisper training launched kernels: {launches}")
    del state, batch
    torch.cuda.empty_cache()

    falls = loss_falls(f"whisper-tiny (batch 2 x {S})", cfg, _whisper_batch(cfg, 2, S, 8, "cuda"))
    torch.cuda.empty_cache()
    return {**res, "step_ms": [r[0] * 1e3 for r in runs], "median_step_ms": med * 1e3,
            "tokens_per_s": B * S / med, "losses": [r[1] for r in runs],
            "grad_norms": [r[2] for r in runs], "peak_bytes": peak, "launches": launches,
            "breakdown": breakdown, "loss_falls": falls}


def serve_run_dir(run_dir: str, fresh_ssd_launches: int) -> dict:
    """4f: serve the restarted run's checkpoint."""
    from repro_torch.launch import serve as serve_mod

    _, ckpt = _run_store(run_dir, "mamba2-130m")
    step, saved = ckpt.restore()
    want = _host_copy(saved["params"])
    loaded = {}
    real = serve_mod._load_params

    def spy(args, cfg, device):
        loaded["params"] = real(args, cfg, device)
        return loaded["params"]

    serve_mod._load_params = spy
    try:
        res = phase_serve(MAMBA_SERVE_ARGS + ["--run-dir", run_dir])
    finally:
        serve_mod._load_params = real
    got = _host_copy(loaded["params"])
    equal = [p for p, _ in got] == [p for p, _ in want] and all(
        a.dtype == b.dtype and np.array_equal(a, b) for (_, a), (_, b) in zip(got, want))
    n = res["launches"]["ssd_scan"]
    print(f"[train] serve --run-dir: step-{step} params ({len(got)} leaves) equal to the run's "
          f"final params bit for bit: {equal} | ssd_scan launches {n} (fresh serve "
          f"{fresh_ssd_launches})")
    if step != RESTART_STEPS or not equal:
        fail(f"serve --run-dir loaded other params than the step-{RESTART_STEPS} checkpoint's")
    if n != fresh_ssd_launches:
        fail(f"serve --run-dir launched ssd_scan {n} times, the fresh serve {fresh_ssd_launches}")
    return {**res, "step": step}


def phase_train(gpu: str, fresh_ssd_launches: int) -> dict:
    import tempfile

    print(f"[phase 4] training on {gpu}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as run_dir:
        out = {"driver": train_driver(run_dir)}
        torch.cuda.empty_cache()
        out["restart"] = train_restart(run_dir)
        torch.cuda.empty_cache()
        out["card_vs_cpu"] = train_card_vs_cpu()
        out["card_vs_cpu_archs"] = train_archs_card_vs_cpu()
        torch.cuda.empty_cache()
        out["loss_falls"] = train_loss_falls()
        torch.cuda.empty_cache()
        out["dense"] = train_dense()
        out["serve_run_dir"] = serve_run_dir(run_dir, fresh_ssd_launches)
        torch.cuda.empty_cache()
    out["whisper"] = train_whisper()
    return {**out, "gpu": gpu}


# -- phase 5: the distribution layer ------------------------------------------------------

def compress_golden_array(kind: str, n: int, seed: int) -> np.ndarray:
    """The numpy input of a ``COMPRESS_GOLDEN`` entry: normal values over a
    random scale, exact ties ``(k + 0.5) * scale`` (every block's max pinned
    at ``127 * scale``), or a zero block, a constant block and normal values."""
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return (rng.normal(size=n) * 10.0 ** rng.uniform(-4, 2)).astype(np.float32)
    if kind == "ties":
        x = ((rng.integers(-126, 126, n) + 0.5) * np.float32(0.0123)).astype(np.float32)
        x[::256] = np.float32(0.0123) * 127
        return x
    x = np.zeros(n, np.float32)
    x[256:512] = -2.75
    x[512:] = rng.normal(size=n - 512).astype(np.float32)
    return x


def compress_digest(q, scales) -> str:
    q, scales = (t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
                 for t in (q, scales))
    import hashlib

    return hashlib.sha256(q.tobytes() + scales.tobytes()).hexdigest()[:16]


def start_dryruns() -> list:
    """``DRYRUN_CELLS`` through the dry-run CLI, one subprocess each, started
    together; they run on the host beside phases 5a and 5b."""
    import os

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    runs = []
    for arch, shape, mesh, ranks, a2a in DRYRUN_CELLS:
        log = open(out_dir / f"dryrun_{arch}__{shape}__{mesh}.log", "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
             "--shape", shape, "--mesh", mesh, "--force", "--out", str(DRYRUN_OUT)],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
        runs.append(((arch, shape, mesh, ranks, a2a), proc, log, time.perf_counter()))
    return runs


def finish_dryruns(runs) -> dict:
    """Waits for ``start_dryruns``'s processes (killing any still running at
    the limit) and checks their artifacts; each cell's counts print beside
    the committed artifact's (as traced when they were committed)."""
    from repro_torch.launch.dryrun import ARTIFACTS

    out = {}
    for (arch, shape, mesh, ranks, a2a), proc, log, t0 in runs:
        try:
            rc = proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "timeout"
        log.close()
        secs = time.perf_counter() - t0
        name = f"{arch}__{shape}__{mesh}"
        if rc != 0:
            for other in runs:
                if other[1].poll() is None:
                    other[1].kill()
            fail(f"dry-run {name}: exit {rc} (chiprun_out/dryrun_{name}.log)")
        res = json.loads((DRYRUN_OUT / f"{name}.json").read_text())
        committed = json.loads((ARTIFACTS / f"{name}.json").read_text())
        coll = res["collectives"]
        if res["devices"] != ranks:
            fail(f"dry-run {name}: {res['devices']} devices, need {ranks}")
        if a2a and not coll["all-to-all"] > 0:
            fail(f"dry-run {name}: no all-to-all (the EP exchange)")
        mem = res["memory_analysis"]
        print(f"[dryrun] {name}: exit 0 in {secs:.1f}s (trace {res['trace_seconds']}s), "
              f"{res['devices']} ranks, {res['cost_analysis']['flops']:.4e} FLOP a device, "
              f"arguments {mem['argument_size_in_bytes']:,} B, temp {mem['temp_size_in_bytes']:,} B; "
              + ", ".join(f"{k} {v:,.0f} B" for k, v in coll.items() if k != "count" and v)
              + f" ({coll['count']:.0f} collectives)")
        total = res["hlo_analysis"]["collectives"]["total"]
        was = committed["hlo_analysis"]
        print(f"[dryrun] {name} on torch {torch.__version__}: {res['hlo_analysis']['flops']:.4e} "
              f"FLOP, {total:,.0f} collective B, trace {res['trace_seconds']}s; committed "
              f"artifact: {was['flops']:.4e} FLOP, {was['collectives']['total']:,.0f} B")
        out[name] = {"seconds": secs, "devices": res["devices"],
                     "trace_seconds": res["trace_seconds"], "collectives": coll,
                     "collective_bytes": total, "flops": res["hlo_analysis"]["flops"],
                     "committed_flops": was["flops"],
                     "committed_collective_bytes": was["collectives"]["total"],
                     "memory_analysis": mem, "cost_analysis": res["cost_analysis"]}
    return out


def phase_compress(gpu: str) -> dict:
    """5a: int8 compression at qwen2.5-3b's full width on the card."""
    from repro_torch.api import ConnectorSpec, StoreConfig
    from repro_torch.configs import get_config
    from repro_torch.distributed.compression import (
        CompressedDeltaCodec, compress_with_feedback, dequantize_int8, init_error_feedback,
        payload_nbytes, quantize_int8, quantize_tree)
    from repro_torch.models import transformer as tx

    for kind, n, seed, want in COMPRESS_GOLDEN:
        q, sc = quantize_int8(torch.from_numpy(compress_golden_array(kind, n, seed)).cuda())
        if compress_digest(q, sc) != want:
            fail(f"compress {kind}[{n}]: digest {compress_digest(q, sc)}, JAX {want}")
    print(f"[compress] {len(COMPRESS_GOLDEN)} pinned JAX digests reproduced on the card")

    cfg = get_config("qwen2.5-3b")
    params = tx.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    leaves = list(_leaves(params))
    n_elem = sum(t.numel() for t in leaves)
    f32_bytes = sum(t.numel() * t.element_size() for t in leaves)

    emb = params["embedding"]["embed"]
    qg, sg = quantize_int8(emb)
    qc, sc = quantize_int8(emb.cpu())
    if not (torch.equal(qg.cpu(), qc) and torch.equal(sg.cpu().view(torch.int32),
                                                       sc.view(torch.int32))):
        fail("compress: the card's q or scales differ from the CPU's on the embedding")
    del qg, sg, qc, sc

    ms = time_ms(lambda: quantize_tree(params), iters=3, warmup=1)
    need = n_elem * (4 + 1 + 4 / 256)
    bound = need / PEAK_BYTES * 1e3
    print(f"[compress] quantize_tree over {n_elem:,} f32 elements ({f32_bytes:,} B): "
          f"{ms:.4f} ms, {need / ms / 1e6:.1f} GB/s of the {need / 1e9:.3f} GB it needs; "
          f"bound {bound:.4f} ms by bytes ({ms / bound:.2f}x) | {gpu}")

    # error feedback on a fixed gradient (one MLP slab scaled down), and with
    # the residual dropped (a planted fault): the mean of 20 dequantized steps
    g = params["layers"]["mlp"]["w_gate"][0].reshape(-1)[: 1 << 22] * 1e-3

    def mean_error(keep_residual: bool) -> float:
        residual = init_error_feedback({"g": g})
        acc = torch.zeros_like(g, dtype=torch.float64)
        for _ in range(COMPRESS_STEPS):
            qt, new = compress_with_feedback({"g": g}, residual)
            residual = new if keep_residual else init_error_feedback({"g": g})
            acc += dequantize_int8(*qt["g"][:2], tuple(g.shape)).double()
        return float((acc / COMPRESS_STEPS - g.double()).abs().max())

    nq, ns = quantize_int8(g)
    naive = float((dequantize_int8(nq, ns, tuple(g.shape)) - g).abs().max())
    ef, dropped = mean_error(True), mean_error(False)
    print(f"[compress] error feedback, {COMPRESS_STEPS} steps on {g.numel():,} values: mean "
          f"error {ef:.3e} against {naive:.3e} memoryless; residual dropped {dropped:.3e}")
    if not ef < naive / 3:
        fail(f"compress: error feedback did not converge ({ef:.3e} vs {naive:.3e} / 3)")
    if dropped < naive / 3:
        fail("compress: the dropped-residual fault passed the convergence check")

    # the delta codec through the port's Store: the embedding and the
    # attention leaves, stepped by a small delta
    sub = {"embedding": params["embedding"], "attn": params["layers"]["attn"]}
    gen = torch.Generator(device="cuda").manual_seed(1)
    stepped = {k: {n: t + 1e-3 * torch.randn(t.shape, generator=gen, device="cuda")
                   for n, t in tree.items()} for k, tree in sub.items()}
    codec = CompressedDeltaCodec(sub)
    store = StoreConfig("chip-codec", ConnectorSpec("memory", segment="chip-codec")).build(
        register=True)
    t0 = time.perf_counter()
    payload = codec.encode(stepped)
    back = codec.decode(store.proxy(payload))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    sub_bytes = sum(t.numel() * 4 for t in _leaves(sub))
    share = payload_nbytes(payload) / sub_bytes
    worst = 0.0
    for k, tree in stepped.items():
        for n, want in tree.items():
            _, scales, _, _ = payload[k][n]
            half = 0.5 * torch.from_numpy(scales).cuda().repeat_interleave(256)[: want.numel()]
            err = (back[k][n].reshape(-1) - want.reshape(-1)).abs()
            worst = max(worst, float((err / half.clamp_min(1e-30)).max()))
    store.close()
    print(f"[compress] codec through the Store: {payload_nbytes(payload):,} B for "
          f"{sub_bytes:,} B of f32 ({share:.4f}), worst error {worst:.4f} of half a scale "
          f"({secs:.1f}s)")
    if share > CODEC_PAYLOAD_SHARE:
        fail(f"compress: codec payload {share:.4f} of the f32 bytes > {CODEC_PAYLOAD_SHARE}")
    if worst > 1.0 + 1e-3:
        fail(f"compress: codec decode off by {worst:.4f} of half a scale")
    return {"elements": n_elem, "f32_bytes": f32_bytes, "quantize_tree_ms": ms,
            "quantize_bound_ms": bound, "gb_per_s": need / ms / 1e6, "ef_mean_error": ef,
            "memoryless_error": naive, "dropped_residual_error": dropped,
            "codec_share": share, "codec_worst_half_scales": worst}


def count_step(build, step, *, fake: bool):
    """``build(device)`` -> (args of ``step``, bytes built); then ``step``
    under an op counter.  ``fake``: inside ``FakeTensorMode``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.op_analysis import OpCounter
    from repro_torch.models import layers

    layers._rope_freqs.cache_clear()  # a cached table is made once per mode
    mode = FakeTensorMode(allow_non_fake_inputs=True) if fake else contextlib.nullcontext()
    with mode:
        args = build()
        counter = OpCounter(log=True)
        with counter, torch.no_grad():
            step(*args)
    layers._rope_freqs.cache_clear()
    return counter, args


def phase_counter(gpu: str) -> dict:
    """5b: the op counter's count of a step against the same step on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tx

    out = {}
    qwen = get_config("qwen2.5-3b", attention_impl="reference")
    mamba = get_config("mamba2-130m", attention_impl="reference")
    B, S = 4, 1024
    cases = {
        "qwen2.5-3b prefill (B=4, S=1024)": (
            qwen,
            lambda cfg: (tx.init_params(cfg, torch.Generator(device="cuda").manual_seed(0)),
                         torch.zeros((B, S), dtype=torch.int64, device="cuda"),
                         tx.init_cache(cfg, B, S + 8, device="cuda")),
            lambda cfg: lambda p, t, c: tx.prefill(cfg, p, t, c, tx.RunCtx(decode=True))),
        "mamba2-130m decode step (B=4)": (
            mamba,
            lambda cfg: (tx.init_params(cfg, torch.Generator(device="cuda").manual_seed(0)),
                         tx.init_cache(cfg, B, S + 8, device="cuda"),
                         torch.zeros((B, 1), dtype=torch.int64, device="cuda"),
                         torch.full((B, 1), S, dtype=torch.int64, device="cuda")),
            lambda cfg: lambda p, c, t, pos: tx.decode_step(cfg, p, c, t, pos,
                                                            tx.RunCtx(decode=True))),
    }
    for label, (cfg, build, make_step) in cases.items():
        step = make_step(cfg)
        fake, fargs = count_step(lambda: build(cfg), step, fake=True)
        predicted = sum(t.numel() * t.element_size() for a in fargs
                        for t in (_leaves(a) if isinstance(a, dict) else [a]))
        del fargs
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        real, args = count_step(lambda: build(cfg), step, fake=False)
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated() - before
        if real.log != fake.log:
            i = next(i for i, (a, b) in enumerate(zip(real.log, fake.log)) if a != b) \
                if any(a != b for a, b in zip(real.log, fake.log)) else min(len(real.log),
                                                                           len(fake.log))
            fail(f"counter, {label}: the card's op {i} of {len(real.log)} differs from the "
                 f"fake count's ({len(fake.log)}): "
                 f"{real.log[i] if i < len(real.log) else None} vs "
                 f"{fake.log[i] if i < len(fake.log) else None}")
        if real.flops != fake.flops or real.bytes != fake.bytes:
            fail(f"counter, {label}: flops/bytes differ")
        # the step's own time, off the counter
        with torch.no_grad():
            times = []
            for _ in range(3):
                if "prefill" in label:  # a fresh cache: the prefill fills an empty one
                    args = (*args[:2], tx.init_cache(cfg, B, S + 8, device="cuda"))
                _, t = events_ms(lambda: step(*args))
                times.append(t)
        ms = min(times)
        flop_ms = fake.flops / PEAK_FLOPS["bfloat16"] * 1e3
        byte_ms = fake.bytes / PEAK_BYTES * 1e3
        # argument bytes: what the state occupies (the inputs of a decode
        # step are a few bytes); the growth counts the allocator's rounding
        if abs(grown - predicted) > ARG_BYTES_TOL * predicted:
            fail(f"counter, {label}: predicted {predicted:,} argument bytes, the card "
                 f"grew by {grown:,}")
        print(f"[counter] {label}: {len(fake.log):,} ops equal on the card and under "
              f"FakeTensorMode; {fake.flops:.4e} FLOP ({flop_ms:.4f} ms at 989 TF/s), "
              f"{fake.bytes:.4e} B counted ({byte_ms:.4f} ms at 3.35 TB/s), "
              f"{fake.transcendental_elems:.4e} transcendental elements; measured "
              f"{ms:.4f} ms (min of {[round(t, 4) for t in times]}); arguments "
              f"{predicted:,} B predicted, {grown:,} B allocated | {gpu}")
        out[label] = {"ops": len(fake.log), "flops": fake.flops, "bytes": fake.bytes,
                      "flop_ms": flop_ms, "byte_ms": byte_ms, "measured_ms": ms,
                      "times_ms": times, "argument_bytes": predicted, "allocated": grown}
        del args
        torch.cuda.empty_cache()
    return out


def phase_distribution(gpu: str) -> dict:
    """Phase 5: the distribution layer.  The dry-run CLI's cells (5c) run as
    subprocesses beside compression (5a) and the counter (5b)."""
    runs = start_dryruns()
    try:
        t0 = time.perf_counter()
        compress = phase_compress(gpu)
        torch.cuda.empty_cache()
        print(f"[phase 5a] {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        counted = phase_counter(gpu)
        print(f"[phase 5b] {time.perf_counter() - t0:.1f}s")
    except BaseException:
        for _, proc, _, _ in runs:
            proc.kill()
        raise
    t0 = time.perf_counter()
    dryruns = finish_dryruns(runs)
    print(f"[phase 5c] waited {time.perf_counter() - t0:.1f}s for the dry-run cells")

    # 5d: the production mesh at one rank raises with the ranks it needs
    import tempfile

    from repro_torch.launch import train as train_mod

    with tempfile.TemporaryDirectory() as tmp:
        try:
            train_mod.train(train_mod.parse_args(["--smoke", "--production", "--run-dir", tmp]))
        except ValueError as exc:
            if "needs 256 ranks" not in str(exc):
                fail(f"train --production: {exc}")
            print(f"[phase 5d] train --production at one rank: {exc}")
        else:
            fail("train --production ran at one rank")
    return {"compress": compress, "counter": counted, "dryrun": dryruns,
            "roofline": phase_roofline(gpu, counted)}


def phase_roofline(gpu: str, counted: dict) -> dict:
    """5e: ``repro_torch.launch.roofline`` over the committed dry-run
    artifacts (the port's beside the reference's), then the roofline held
    to the card: each step 5b measured must take at least ``ROOFLINE_FLOOR``
    of the larger of the compute and memory terms its counted FLOPs and
    bytes give at the module's rates, or the rates are wrong."""
    import os

    from repro_torch.launch import roofline

    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.roofline", "--markdown"],
                         cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    if res.returncode != 0:
        fail(f"roofline: exit {res.returncode}: {res.stderr[-2000:]}")
    rows = roofline.table()
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "roofline.md").write_text(f"{gpu}\n{res.stdout}")
    slower = [r for r in rows if r.get("verdict") == "reference faster"]
    print(f"[roofline] {len(rows)} cells priced (chiprun_out/roofline.md), "
          f"{sum('ref' in r for r in rows)} beside the reference's; "
          f"{len(slower)} where the reference's compute + collective time is the smaller "
          f"by more than 1.25x: {[(r['arch'], r['shape'], r['mesh']) for r in slower]} | {gpu}")
    print(f"[roofline] {res.stdout.splitlines()[0]}")
    print(roofline.SUMMARY_HEADER)
    print("\n".join(roofline.summary_rows(rows)))
    checks = {}
    for label, c in counted.items():
        bound_ms = roofline.bound_seconds(c["flops"], c["bytes"]) * 1e3
        share = c["measured_ms"] / bound_ms
        print(f"[roofline] {label}: measured {c['measured_ms']:.4f} ms, bound "
              f"{bound_ms:.4f} ms (compute {c['flops'] / roofline.PEAK_FLOPS * 1e3:.4f}, memory "
              f"{c['bytes'] / roofline.HBM_BW * 1e3:.4f}): {share:.2f}x | {gpu}")
        if share < ROOFLINE_FLOOR:
            fail(f"roofline: {label} measured {c['measured_ms']:.4f} ms, under "
                 f"{ROOFLINE_FLOOR} of its {bound_ms:.4f} ms bound: the rates are wrong")
        checks[label] = {"measured_ms": c["measured_ms"], "bound_ms": bound_ms, "share": share}
    return {"cells": len(rows), "reference_faster": [
        (r["arch"], r["shape"], r["mesh"]) for r in slower], "checks": checks}


def phase_data_plane() -> dict:
    """Phase 7: a 16 MB bfloat16 tensor on the zero-copy data path, on the
    card and on the host, beside the same values in float32 and beside
    ``pickle_serializer``: the header token, the buffer's bytes (the CPU
    tensor's own memory), the decoded dtype, device and bits, and, through
    a shared-memory store, copies per byte equal to float32's at the same
    bytes with the decoded tensor over the store's mapping."""
    import msgpack

    from repro_torch.core.serialize import (CopyCounter, deserialize, pickle_serializer,
                                            serialize)
    from repro_torch.runtime.transfer import ResultStore

    gen = torch.Generator(device="cuda").manual_seed(7)
    bf_cuda = torch.randn(DATA_PLANE_SHAPE, generator=gen, device="cuda").to(torch.bfloat16)
    bf_cpu = bf_cuda.cpu()
    f32_cuda = bf_cuda.float()
    f32_cpu = f32_cuda.cpu()
    raw = lambda t: t.reshape(-1).view(torch.uint8).numpy()  # noqa: E731

    def mean_us(fn, calls: int = DATA_PLANE_CALLS) -> float:
        fn()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        return (time.perf_counter() - t0) * 1e6 / calls

    times = {}
    for label, t, host in (("bfloat16 cpu", bf_cpu, bf_cpu), ("bfloat16 cuda", bf_cuda, bf_cpu),
                           ("float32 cpu", f32_cpu, f32_cpu), ("float32 cuda", f32_cuda, f32_cpu)):
        so = serialize(t)
        header = msgpack.unpackb(so.header)
        leaf = header["leaves"][0]
        token = "bfloat16" if t.dtype == torch.bfloat16 else "<f4"
        if (header["kind"], leaf["k"], leaf["dt"], leaf["sh"], len(so.buffers)) != (
                "tree", "nd", token, list(t.shape), 1):
            fail(f"data plane {label}: header {header['kind']} {leaf} with {len(so.buffers)} "
                 f"buffers, not one 'nd' leaf of {token}")
        buf = np.frombuffer(so.buffers[0], np.uint8)
        if not np.array_equal(buf, raw(host)):
            fail(f"data plane {label}: the buffer's bytes are not the tensor's")
        if t.device.type == "cpu" and buf.ctypes.data != t.data_ptr():
            fail(f"data plane {label}: the buffer is a copy, not the tensor's memory")
        back = deserialize(so.frames())
        if t.dtype == torch.bfloat16:
            ok = (isinstance(back, torch.Tensor) and back.dtype == torch.bfloat16
                  and back.device.type == "cpu" and np.array_equal(raw(back), raw(host)))
        else:
            ok = isinstance(back, np.ndarray) and np.array_equal(back, host.numpy())
        if not ok:
            fail(f"data plane {label}: decoded {type(back).__name__} "
                 f"{getattr(back, 'dtype', '')} is not the tensor bit for bit")
        pk = pickle_serializer(t)
        times[label] = {
            "token": token, "nbytes": buf.nbytes,
            "serialize_us": mean_us(lambda: serialize(t)),
            "deserialize_us": mean_us(lambda: deserialize(so.frames())),
            "pickle_serialize_us": mean_us(lambda: pickle_serializer(t)),
            "pickle_deserialize_us": mean_us(lambda: deserialize(pk.frames())),
        }
        r = times[label]
        print(f"[data plane] {label} {tuple(t.shape)} ({r['nbytes']} B, token {token!r}, decodes "
              f"as a CPU {type(back).__name__}): serialize {r['serialize_us']:.1f} us, "
              f"deserialize {r['deserialize_us']:.1f} us | pickle_serializer "
              f"{r['pickle_serialize_us']:.1f} us, its deserialize "
              f"{r['pickle_deserialize_us']:.1f} us")
        del so, back, pk

    # through a shared-memory store: publish, fetch by reference, decode
    name = f"dp{time.time_ns() % 10**8}"
    rs = ResultStore({"name": name, "connector": {"connector_type": "shm", "prefix": name},
                      "serializer": "default", "cache_size": 0})
    copies = {}
    try:
        half = f32_cpu[:, :DATA_PLANE_SHAPE[1] // 2].contiguous()  # bf_cpu's bytes in float32
        for label, t in (("bfloat16", bf_cpu), ("float32", half)):
            so = serialize(t)
            ref = rs.publish(label, so)
            cc = CopyCounter()
            bundle = rs.fetch(ref, so.nbytes, copies=cc)
            back = deserialize(bundle)
            addr = back.data_ptr() if isinstance(back, torch.Tensor) else back.ctypes.data
            spans = [(np.frombuffer(f, np.uint8).ctypes.data, f.nbytes) for f in bundle.frames]
            mapped = any(lo <= addr < lo + n for lo, n in spans)
            same = np.array_equal(raw(back) if isinstance(back, torch.Tensor)
                                  else back.reshape(-1).view(np.uint8), raw(t))
            snap = cc.snapshot()
            copies[label] = {**snap, "decoded_over_the_mapping": mapped}
            print(f"[data plane] shm store {label} ({so.nbytes} B): copies_per_byte "
                  f"{snap['copies_per_byte']} ({snap['bytes_copied']} of {snap['bytes_moved']} B "
                  f"moved copied), decoded over the store's mapping: {mapped}, bits equal: {same}")
            if not (mapped and same):
                fail(f"data plane {label}: the shm fetch did not decode in place, bit for bit")
            del back, bundle
            rs.evict(ref)
    finally:
        rs.close()
    if copies["bfloat16"]["copies_per_byte"] != copies["float32"]["copies_per_byte"]:
        fail(f"data plane: bfloat16 copies {copies['bfloat16']['copies_per_byte']} per byte, "
             f"float32 {copies['float32']['copies_per_byte']}")
    return {"times": times, "copies": copies}


def phase_examples() -> dict:
    """Phase 6: the four examples, as a user runs them, on the card.  The
    quickstart's sums and products are held to numpy's on the host; the
    active-learning loop runs on the CPU too, and the card must select the
    same candidates with the same scores (EXAMPLE_SCORE_RTOL / _ATOL)."""
    import importlib.util

    out = {}
    for name in ("serve_batched_torch", "train_lm_torch", "quickstart_torch",
                 "active_learning_torch"):
        spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        t0 = time.perf_counter()
        res = mod.main([])
        secs = time.perf_counter() - t0
        if name in ("quickstart_torch", "active_learning_torch") and res["device"] != "cuda":
            fail(f"{name} ran on {res['device']}, not the card")
        if name == "serve_batched_torch":
            if len(res["outputs"]) != mod.REQUESTS:
                fail(f"{name}: served {len(res['outputs'])}/{mod.REQUESTS} requests")
            if next(iter(res["params"]["embedding"].values())).device.type != "cuda":
                fail(f"{name}: the restored params are not on the card")
            out[name] = {"seconds": secs, "requests": len(res["outputs"]),
                         "batches": res["server"]["batches"]}
        elif name == "train_lm_torch":
            out[name] = {"seconds": secs, "first_loss": res["log"][0]["loss"],
                         "last_loss": res["log"][-1]["loss"], "steps": len(res["log"])}
        elif name == "quickstart_torch":
            data = np.random.default_rng(0).normal(size=(512, 512))
            grams = [x @ x.T for x in (data, data * 2)]
            gram_err = max(float(np.abs(c[3] - g).max() / np.abs(g).max())
                           for c, g in zip(res["c"], grams))
            sum_err = max(abs(res[k] / float(data.sum()) - 1) for k in ("a", "b"))
            out[name] = {"seconds": secs, "sum": res["a"], "sum_rel_err": sum_err,
                         "gram_rel_err": gram_err, "store_bytes": res["store_bytes"],
                         "scheduler_bytes": res["scheduler_bytes"]}
            if sum_err > 1e-12 or gram_err > 1e-12 or not all(
                    c[1] and c[2] == (512, 512) for c in res["c"]) or len(res["c"]) != 2:
                fail(f"{name}: the card's results are not numpy's: {out[name]}")
        else:
            t1 = time.perf_counter()
            cpu = mod.main(["--device", "cpu"])
            cpu_secs = time.perf_counter() - t1
            scores = lambda r: np.asarray(r["baseline"]["scores"])  # noqa: E731
            score_err = float(np.abs(scores(res) - scores(cpu)).max())
            same = res["baseline"]["selected"] == cpu["baseline"]["selected"]
            close = np.allclose(scores(res), scores(cpu), rtol=EXAMPLE_SCORE_RTOL,
                                atol=EXAMPLE_SCORE_ATOL)
            out[name] = {
                "seconds": secs, "cpu_seconds": cpu_secs, "selected": res["baseline"]["selected"],
                "same_selection_as_cpu": same, "max_score_err_vs_cpu": score_err,
                **{f"{run}_{key}": res[run][key] for run in ("baseline", "proxied")
                   for key in ("seconds", "scheduler_bytes")}}
            if not (same and close):
                fail(f"{name}: the card's loop is not the CPU's: {out[name]}")
        print(f"[examples] {name}: {out[name]}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})", file=sys.stderr)
        return 3
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    marks = [t0]

    def done(label: str) -> float:
        """Print a part's seconds and the run's so far; returns the part's."""
        gc.collect()  # a model's tens of GB must be gone before the next arch's
        torch.cuda.empty_cache()
        marks.append(time.perf_counter())
        secs = marks[-1] - marks[-2]
        print(f"[{label}] ok ({secs:.1f}s; {marks[-1] - t0:.1f}s in all)")
        return secs

    gen = torch.Generator(device="cuda").manual_seed(0)
    fa, ssd, fp = phase_kernels(gen)
    done("phase 1 kernels")
    prefill_kernels = {"hymba": {"flash_attention": fa.pop("hymba"), "ssd_scan": ssd.pop("hymba")},
                       "kimi": {"flash_attention": fa.pop("kimi")},
                       "whisper": {"flash_attention": {"encoder": fa.pop("whisper_encoder"),
                                                       "decoder": fa.pop("whisper_decoder")}},
                       **{name: {"flash_attention": fa.pop(name)}
                          for name in ("phi4", "internvl2", "starcoder2", "granite")}}
    qwen_decode, fp_detail = phase_model(fp)
    done("phase 2 qwen2.5-3b and the fingerprint's path")
    decode = {"qwen2.5-3b": qwen_decode, "mamba2-130m": phase_model_mamba()}
    done("phase 2 mamba2-130m")
    decode["hymba-1.5b"] = phase_model_hymba()
    done("phase 2 hymba-1.5b")
    moe_models = {"kimi-k2-1t-a32b": phase_model_kimi()}
    done("phase 2 kimi-k2")
    moe_models["deepseek-v2-lite-16b"] = phase_model_deepseek()
    done("phase 2 deepseek-v2-lite")
    whisper = phase_model_whisper()
    done("phase 2 whisper-tiny")
    dense_models = {}
    for arch in DENSE_ARCHS:
        dense_models[arch] = phase_model_dense(arch)
        done(f"phase 2 {arch}")
    served = {}
    for argv in (SERVE_ARGS, MAMBA_SERVE_ARGS, HYMBA_SERVE_ARGS, KIMI_SERVE_ARGS,
                 DEEPSEEK_SERVE_ARGS, *DENSE_SERVE_ARGS.values()):
        arch = argv[argv.index("--arch") + 1]
        served[arch] = (phase_serve_cut if arch in CONFIG_CUTS else phase_serve)(argv)
        done(f"phase 3 {arch} serve")
    served["whisper-tiny"] = phase_serve_whisper()
    done("phase 3 whisper-tiny serve")
    # every serve path's launches: every attention arch's flash, mamba's and
    # hymba's ssd_scan
    for entry in (fa, ssd):
        entry["launches"] = sum(res["launches"][entry["name"]] for res in served.values())

    gpu = gpu_name_and_limit()
    trained = phase_train(gpu, served["mamba2-130m"]["launches"]["ssd_scan"])
    trained["seconds"] = done("phase 4 train")
    distribution = phase_distribution(gpu)
    distribution["seconds"] = done("phase 5 distribution")
    examples = phase_examples()
    examples["seconds"] = done("phase 6 examples")
    data_plane = phase_data_plane()
    data_plane["seconds"] = done("phase 7 data plane")

    result = {"kernels": [fa, ssd, fp]}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {**result, "serve": served, "decode": decode, "moe_models": moe_models,
         "dense_models": dense_models, "whisper": whisper,
         "fingerprint": fp_detail, "prefill_kernels": prefill_kernels, "train": trained,
         "distribution": distribution, "examples": examples, "data_plane": data_plane,
         "gpu": gpu}, indent=1))
    print(json.dumps(result))
    print(gpu)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
