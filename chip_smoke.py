#!/usr/bin/env python3
"""Drive radzero_torch once on one NVIDIA GPU: zero-shot serving, training, a checkpoint.

    python3 chip_smoke.py [--seed 0] [--profile]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
Phases, in order; any failure exits non-zero:

1. device: require CUDA; print the card (nvidia-smi), CUDA and nvcc versions;
2. build the kernels from radzero_torch/ops/csrc with nvcc (sm_90a); ptxas
   must report no spills for the Hopper kernels of K2 / K13 (forward), K7 /
   K14 (backward), the GEMM of K1 / K3 / K4 / K6 / K8 / K9 / K11 / K12
   (gemm_sm90_kernel, all 17 instantiations: K1 / K3 / K4's epilogues, the
   chains' on W and on W^T read K-major, the dW product, K12's second phase,
   K5 / K10's second phase, K11's dq product), K12's first phase
   (vlc_dtn_phase1_sm90_kernel, whose epilogue also writes K11's dtau)
   and K5 / K10's (vlc_scores_sm90_kernel), the short-sentence K15 /
   K16 kernels, nor for the chains' row passes and two-level reduce
   (ln_rows_kernel, ln_bwd_rows_kernel, scale_colsum_kernel,
   reduce_chunks_kernel);
3. each kernel against its plain PyTorch twin, in fp32 with TF32 off and in
   bf16, with CUDA-event timings (one call a sample, the host's launch
   included; K1-K3, K7, K13-K16 also by torch.profiler, which asserts the
   device kernels by name: in bf16 row_layernorm_kernel with one (K1) or
   three (K3) gemm_sm90_kernel, gemm_f32_kernel in fp32, and the host's
   microseconds a call of K1 / K3 / K4 at 128 rows; bf16 K4 on three
   gemm_sm90_kernel and two row passes; bf16 K5 and K10 on their five Hopper
   stages (rownorm_kernel, vlc_scores_sm90_kernel, vlc_exp_rows_kernel,
   gemm_sm90_kernel<8, 4>, vlc_logits_kernel), each stage's time, a second call's
   bits, K10's statistics against their twin, and a yardstick of their two
   products on cuBLAS, fp32 K5 / K10 on vlcabs_kernel<float> / rownorm_kernel
   and vlc_pass1_kernel<float, .>; K11 and K12 from the statistics of a
   K10 call, never vlc_pass1_kernel, bf16 K12 on its two Hopper phases with a
   yardstick of its four products on cuBLAS, bf16 K11 on K12's first phase,
   its product over dc (gemm_sm90_kernel<5, 4>) and the reduce, never
   vlc_dq_kernel, with a yardstick of its three products on cuBLAS, and the
   backward as the training step runs it (vlcabs_train_bwd: the shared
   stages once) by kernel, K11's own launches' device time, a second
   call's bits; K6 / K8 / K9 in bf16 on their
   gemm_sm90_kernel instantiations, row passes and reduces alone (no other
   GEMM, no transpose_kernel), with their device time and each stage's;
   fwd_sm90_kernel, and
   bwd_dq_sm90_kernel with bwd_dkdv_sm90_kernel, in bf16,
   flash_bias_fwd_small_kernel and
   flash_bias_bwd_small_kernel with the reduce for K15 / K16 in bf16 at 512
   x 32 (the grid is printed), the kernels of flash_attention.cu in fp32 and
   for K15 / K16 in bf16 at 64 x 256, and gives their device time alone, and
   for K15 / K16 in bf16 at every text shape also the host's time a call; the
   lse the bf16 forward writes for the backward against its twin), library
   yardsticks where one PyTorch call computes the same function (K2 / K13 at
   8 and 64 images, K15 with bias + mask as attn_mask, the backward alone of
   K7 / K14 and of K16 with its bias a leaf, with their device times; for the GEMM
   kernels K1, K3, K4, K6, K8 and K9 the cuBLAS products alone (K8 / K9 all
   nine of the chain), which no one call fuses with their LN, GELU or
   residual, for K1, K3, K6, K8, K9 also by device time beside the
   kernels'): K1
   fused_preattn, K2 flash_attention_packed, K3 fused_postattn and K5 vlcabs_fused at the
   serving shapes (8 images x 1370 tokens x 768, 12 heads, 14 prompts);
   K1-K3 again at the training step's 64 images (87 680 rows); K4
   fused_mpnet_post at 896 rows (14 prompts x 64 tokens) and at 16 384 (512
   sentences x 32); K10-K12, the VL-CABS training kernels, at 512 sentences
   x 64 images x 1370 tokens x 768 (value, dq, dt, dtau; K10 also with the
   statistics it writes under autograd); K6
   fused_preattn_bwd, K7 flash_attention_packed_bwd and K8
   fused_postattn_bwd at 64 images and at 2 (2740 rows, no multiple of a
   tile), K9 fused_mpnet_post_bwd at 16 384 rows and at 1370, every
   gradient they return; K13 flash_attention at 8 and 64 images x 1370 x 12 x
   64, at L = 1408 with kv_len = 1370 and at 1 x 4097 tokens, K14
   flash_attention_bwd at 64 images, at 2 and at 4097 tokens, K15
   flash_attention_bias and K16 flash_attention_bias_bwd at 512 sentences x
   32 tokens, 14 x 64, 64 x 256 and 8 x 37 with real lengths drawn per
   sentence (dq, dk, dv, d bias; a second backward of K6-K9, K14 and K16
   gives the same bits);
4. serving: full-width RadZero (ViT-B/14 at 518, 2 align layers, MPNet
   12 x 768 with the default fuse_post=True) from seeded random weights in
   bf16 behind ServingEngine(max_batch=8, channels=1); 20 grayscale
   requests; checks of the answers and of the kernel launch counts, the
   kernel path against the eager reference path, requests/s with p50/p99
   latency of that burst and of five repeats on the warm engine, and the
   card's idle share over one more burst (torch.profiler);
4a. the HTTP server: EngineServer on 127.0.0.1 over ServingEngine(
   max_batch=8, channels=1, host_backend="pil": this card's host has no
   libjpeg headers, so the native decoder is not built there, printed on a
   line of its own); 16 client threads post 16 seeded grayscale JPEGs of
   about 3000 x 2500 (quality 95) at once: every answer bit-equal to the
   engine's own Future for the same bytes (both in batches [8, 8]),
   /healthz and /prompt_sets, maps=full on a smaller JPEG at its own size,
   launch counts per batch; requests/s with p50/p99 over HTTP and four
   repeats, and the host ms an image of the decode -> grey -> resize by PIL
   beside the native library's where it is built;
4b. export: export_zero_shot at 8 images x 14 prompts x 64 tokens,
   from_uint8, channels=1, bf16 into a temporary directory, loaded by
   load_zero_shot in a fresh python3 (imports radzero_torch, nothing of this
   process): logits and maps bit-equal to compute_logits on the same inputs
   and weights, torch.profiler naming K1-K5's device kernels (ROUTES) with
   the eager call's softmax launches and no upload from host memory, the
   launch counters and the registered ops' calls as the eager call's;
   ServingEngine.from_bundle there answers 16 requests with the live
   engine's probabilities, bit for bit; export seconds, bundle bytes, cold
   start to first answer, the host's ms a run beside compute_logits', the
   runner's host ms under 0-100 more frames of the caller's stack (none
   above 3 x the median; the program as torch.export.load gives it printed
   beside it), warm requests/s beside the live engine; then the same for the
   fused_tower=False / TextConfig(attn_impl="flash") bundle (K13 and K15 from
   a program; full depth, printed), without the engine;
5. scoring through ZeroShotScorer(fused_tower=False) with
   TextConfig(attn_impl="flash"): 16 seeded images at batch 8 x the 14
   prompts in bf16 with maps (the tower on K13, the align layers on K1-K3,
   MPNet on K15 and K4, K5), launch counts per batch and images/s, and the
   host stages of one batch each alone (the resize and normalise of an image
   by PIL and with use_native=True where the native library is built, the
   batch on the scorer's 8 threads, the pinned upload, the card's ms, the
   readback) beside the scorer's wall time a batch; the same in fp32 against
   compute_logits(eager=True) with the repo's gate; and model_inference on
   one PNG in a temporary directory;
5a. the eval harness: Inference(cls=[OpenI, PadChest, ChestXray14, Chexpert,
   ChestXDet10], det=[ChestXDet10, MS-CXR], seg=[SIIM, RSNA]) on
   ZeroShotScorer(batch_size=64, fp32) at the flagship configuration, over a
   synthetic eval root in a temporary directory (32 studies a dataset:
   grayscale PNGs of 2000-3000 px, SIIM as 1024 x 1024 8-bit DICOMs); no task
   None and no logged error, every metric finite and in [0, 1], MS-CXR 1.0,
   32 x P similarities a CSV, the launches of the 9 batches, a second run's
   result.json files byte-identical, Chexpert's similarities against
   compute_logits(eager=True) with the repo's gate, every upsampled map on
   the card against the CPU within 1e-5 (grounding points equal but for
   near-ties); seconds and images/s a task with the host's stages outside
   the scorer, the card's time a batch, and neither pandas nor sklearn
   loaded (a child process reports whether pandas, sklearn and yaml import
   on this host);
6. training: the same weights as fp32 masters, tower frozen (K1-K3 without
   a tape), at the defaults AlignConfig() / TextConfig() /
   LossConfig(train_impl="fused"): align layers on K1-K3 with the backward
   kernels K6-K8, every MPNet layer on K4 with K9, the loss on K10-K12; 6
   AdamW steps in bf16 on one seeded batch of 64 images x 512 sentences,
   with checks of the losses, the gradient norm and the launch counts per
   step, and images/s of the warm steps; then 3 steps of the eager-layer
   configuration (attn_impl="xla", fuse_post=False) beside it, step time
   and peak memory of both; then 3 steps with attn_impl="flash" in the align
   layers (K13 / K14) and the text tower (K15 / K16); then loss and every
   gradient leaf of all three against the all-eager path on an fp32 batch of
   2 images; the remat legs (phase_remat): the default step under remat with
   the align layers at remat_policy "save_attn" and at None, its loss and
   every gradient leaf bit-equal to the step without it in bf16 at 64 x 512
   and in fp32 at 2 images, its launches (the default step's plus K1 2 and K4
   12, or K1-K3 2 each and K4 12), peak memory, median step and the card's
   idle share beside the step without remat; the LoRA leg (phase_lora): r 8,
   alpha 32 on attn/q and attn/v of the three towers, the merged forward at
   init bit-equal to the base one, the adapter gradients with the tower
   trainable through them (its 12 layers on K1-K3 / K6-K8) against the
   all-eager route in fp32 at 2 images x 16 sentences under the per-leaf
   gate, a bf16 second backward at 8 x 64 with the same bits, and the adapter
   file round trip;
7. the trainer: a synthetic MIMIC-CXR split (320 train / 64 eval grayscale
   PNGs of 1200 x 1000, 1-12 finding sentences each drawn with repeats from
   a pool) in a temporary directory, read through load_datasets and the
   threaded TrainLoader (batch 64, PackSpec(8, 64, (16, 32)), PIL on 8
   threads) into RadZeroTrainer at the defaults in bf16 with the same
   weights: run A, 3 epochs with save_total_limit=2, early_stopping_
   patience=2, logging_steps=1 (15 steps, 3 epoch records, finite losses,
   each step's launches those of phase 6's default step, the surviving
   checkpoints by the pruning rule, the trainable tree after
   load_best_model_at_end equal to the best checkpoint's file, predict with
   a compute_logits step bit-equal to compute_logits on the batch); the
   same run stopped by a raising callback at the first step record of
   epoch 3 (its steps bit-equal to run A's) and resumed with True by a
   fresh trainer (steps 11-15, the last checkpoint and the final weights
   bit-equal to run A's); TowerCache("device") over the same run (epoch 1
   misses every batch, later epochs hit every one and run no tower, every
   loss bit-equal to run A's); and, as a finding, one step of a batch
   packed with dedup_slots=320 twice from the same state (same bits?) and
   its time beside the plain layout's; with train_samples_per_second by
   epoch beside phase 6's bare step, the host stages of an epoch (the
   loader's queue, pinning and upload, the step's enqueue, the wait for the
   losses), the card's idle share over one epoch, eval, save and restore
   seconds and bytes;
8. the real-checkpoint path: a synthetic flagship snapshot from --seed in the
   exact HF layout (model.safetensors in HF names through to_hf_state_dict, a
   37 x 37 position table, a 30527-entry vocab.txt in all-mpnet-base-v2's
   layout holding the words and ## pieces of phase 4's prompts, a
   preprocessor_config.json) in a temporary directory; python -m
   radzero_torch.tools.convert_checkpoint on it, load_converted (bit-equal to
   the written tree, pretrain_img_size 518 from the table), the WordPiece ids
   of the 14 prompts equal to CHEXPERT_IDS with no unk, python -m
   radzero_torch.eval.server --ckpt in the background answering 4 CXR-size
   JPEGs bit-equal to an engine's in this process on the loaded tree (its
   launches counted), stopped; K1-K3 against their twins at the token
   filter's 685 tokens in fp32 and bf16; compute_logits on the loaded weights
   and the branches cls_alignment, global_alignment, the linear and mlp
   adapters and the token filter (ratio 0.5, layer 6) each against the eager
   route in fp32 and bf16 (the token filter's bf16 eager route runs the kernel
   route's kept rows; the share of rows the routes keep alike is printed);
   write, convert, load and cold-start seconds and the snapshot's bytes;
9. the training entry point: python -m radzero_torch.cli.run --add_cfg_list
   radzero <overlay> --train true --inference true --no_report in a fresh
   process, then radzero_torch.cli.run.main in this one into a second output
   directory, the flagship preset unchanged (batch 64, bf16,
   gradient_checkpointing, buckets [16, 32]) but for the overlay: phase 7's
   synthetic MIMIC split, a Chexpert / MS-CXR / RSNA eval root of 16
   studies of 2000-3000 px, phase 8's vocab.txt, 1 epoch, logging_steps 1;
   both exit 0 with output.log, the snapshot, checkpoint-5, log_history
   steps 1-5 and the three result.json files, log_history's losses and each
   result.json bit-equal between the runs; samples/s of the epoch, images/s
   a task, cold start to the first step record and the phase's seconds; and
   a third fresh process (chip_smoke.py --cold-probe, training only) with
   timers on its imports, the CUDA context, the kernel library's load, the
   epoch's first batch and each step, and cProfile over its first step,
   which take the fresh process's slower epoch apart.

--profile also prints the kernels of one training step by device time
(torch.profiler; the 40 longest, K15 / K16's by name, and the fixed-order
reduces' launches and time). A line with {"kernels": [...]} reports every kernel
(with its launches on each path and, for the serving kernels, the radzero:: op
it is registered as); the
line before the last is the card's name and power limit; the last is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
B, L, D, H, F, N = 8, 1370, 768, 12, 3072, 14
M_TEXT = N * 64                       # K4 in serving: 14 prompts x 64 tokens
TB, TN, T_LEN = 64, 512, 32           # training: images, sentences, tokens per sentence
M_RAGGED = 1370                       # K9 at a row count that is no multiple of any tile
L_PAD, L_LONG = 1408, 4097            # K13 / K14: a lane-padded tower (kv_len 1370), a long one
PEAK_FLOPS = {"bf16": 989e12}         # H100 SXM dense bf16, operations per second
PEAK_BYTES = 3.35e12                  # H100 SXM device memory, bytes per second
K11_SLOTS = TB * TN // 64 * -(-L // 128)  # phase 1's work items: K11's dtau slots
HOPPER_FWD = "fwd_sm90_kernel"        # K2 / K13 in bf16 (csrc/flash_fwd_sm90.cu)
HOPPER_BWD = ("bwd_dq_sm90_kernel", "bwd_dkdv_sm90_kernel")  # K7 / K14 in bf16 (flash_bwd_sm90.cu)
GEMM_SM90 = "gemm_sm90_kernel"        # bf16 products of K1, K3-K6, K8-K12 (gemm_sm90.cu)
GEMM_SM90_INSTANCES = 17              # its <epilogue, operand layout> pairs (gemm_sm90.cu)
VLC_PHASE1 = "vlc_dtn_phase1_sm90_kernel"  # K12's first phase in bf16, K11's too (vlcabs_sm90.cu)
VLC_SCORES = "vlc_scores_sm90_kernel"  # K5 / K10's first phase in bf16 (csrc/vlcabs_sm90.cu)
LN_PASS = "row_layernorm_kernel"      # K1 / K3's LayerNorm in bf16, once per row (fused_layer.cu)
# K15 / K16 in bf16 at L <= 64 (flash_bias_small.cu)
SMALL_BIAS = ("flash_bias_fwd_small_kernel", "flash_bias_bwd_small_kernel")
REDUCE = "reduce_parts_kernel"        # the fixed-order reduce, one level (fused_layer_bwd.cu)
REDUCE1 = "reduce_chunks_kernel"      # the first level of the two-level reduce (fused_layer_bwd.cu)
# the chains' row passes in bf16 at D = 768 (fused_layer_bwd.cu): a warp holds a row as 3
# chunks of 8 columns a lane; the LayerNorm backward holds 2 or 4 column sums
LN_ROWS, LN_BWD = "ln_rows_kernel<__nv_bfloat16, ", "ln_bwd_rows_kernel<__nv_bfloat16, "
COLSUM = "scale_colsum_kernel<__nv_bfloat16, "  # then whether it sums g * m
ROW_PASSES = ("ln_rows_kernel", "ln_bwd_rows_kernel", "scale_colsum_kernel", REDUCE1)


def _sm90(epi, mode):  # an instantiation of gemm_sm90_kernel<epilogue of gemm.cuh, layout>
    return f"{GEMM_SM90}<{epi}, {mode}>"


# the device kernels of one call, by dtype (csrc/flash_attention.cu in fp32); K15 /
# K16 by dtype and length: "bf16" at L <= 64, "bf16 L>64" on the tiled kernels; K1 /
# K3 by dtype (fp32 on gemm_f32_kernel<LN prologue, epilogue>); K6 / K8 / K9 in bf16
# (their order in the chain; fused_layer_bwd.cu's row passes and reduces). A
# gemm_sm90_kernel's arguments are the epilogue of gemm.cuh (0 bias, 1 o-proj, 2 fc1,
# 3 fc2; 4 u = x + ., 5 v = y32 + ., 6 proj and y, 7 h1 and gelu(h1), 8 fp32, 9 the
# GELU derivative) and the operand layout (0 A . W, 1 G . W^T with W read as stored,
# 2 the row-split dW = A^T . G, 3 K12's dtn[b] = [dc; e]^T [qn; dg], 4 K5 / K10's g[b] =
# e[b] tn[b]); K4 in bf16 (K9's forward chain); K5 / K10 in bf16 (the tokens' row
# pass, phase 1, the row pass into e, phase 2, the logits; csrc/vlcabs_sm90.cu), in
# fp32 their kernels of vlcabs_fused.cu / vlcabs_train.cu; K11 / K12 after the
# forward's statistics (csrc/vlcabs_train.cu's row passes, then in bf16 K12's first
# Hopper phase, K11's product over its dc, <5, 4>, and reduce, K12's second phase; in
# fp32 K11's dq kernel and reduce, K12's tiled kernel); "K11+K12" the backward as the
# autograd function runs it, the shared stages once (vlcabs_train_bwd)
VT_ROWS = ("rownorm_kernel", "vlc_bwd_rows_kernel")
K11_OWN = (_sm90(5, 4), "vlc_reduce_kernel")  # bf16 K11's own launches after phase 1
VL_FWD = ("rownorm_kernel", VLC_SCORES, "vlc_exp_rows_kernel", _sm90(8, 4), "vlc_logits_kernel")
ROUTES = {"K1": {"bf16": (LN_PASS, _sm90(0, 0)), "fp32": ("gemm_f32_kernel<true, 0>",)},
          "K5": {"bf16": VL_FWD, "fp32": ("vlcabs_kernel<float>",)},
          "K10": {"bf16": VL_FWD, "fp32": ("rownorm_kernel", "vlc_pass1_kernel<float, ")},
          "K4": {"bf16": (_sm90(4, 0), LN_ROWS + "float, 3>", _sm90(2, 0), _sm90(5, 0), LN_PASS)},
          "K11": {"bf16": VT_ROWS + (VLC_PHASE1,) + K11_OWN,
                  "fp32": VT_ROWS + ("vlc_dq_kernel<float>", "vlc_reduce_kernel")},
          "K12": {"bf16": VT_ROWS + (VLC_PHASE1, _sm90(0, 3)),
                  "fp32": VT_ROWS + ("vlc_dtn_kernel<float>",)},
          "K11+K12": {"bf16": VT_ROWS + (VLC_PHASE1,) + K11_OWN + (_sm90(0, 3),),
                      "fp32": VT_ROWS + ("vlc_dq_kernel<float>", "vlc_reduce_kernel",
                                         "vlc_dtn_kernel<float>")},
          "K3": {"bf16": (_sm90(1, 0), LN_PASS, _sm90(2, 0), _sm90(3, 0)),
                 "fp32": ("gemm_f32_kernel<false, 1>", "gemm_f32_kernel<true, 2>",
                          "gemm_f32_kernel<false, 3>")},
          "fwd": {"bf16": (HOPPER_FWD,), "fp32": ("fwd_kernel<float",)},
          "bwd": {"bf16": HOPPER_BWD,
                  "fp32": ("bwd_stats_kernel<float", "bwd_dkdv_kernel<float",
                           "bwd_dq_kernel<float")},
          "bias_fwd": {"bf16": SMALL_BIAS[:1], "bf16 L>64": ("fwd_kernel<__nv_bfloat16",),
                       "fp32": ("fwd_kernel<float",)},
          "bias_bwd": {"bf16": (SMALL_BIAS[1], REDUCE),
                       "bf16 L>64": ("bwd_stats_kernel<__nv_bfloat16", "bwd_dkdv_kernel<__nv",
                                     "bwd_dq_kernel<__nv", "bwd_dbias_kernel<__nv", REDUCE),
                       "fp32": ("bwd_stats_kernel<float", "bwd_dkdv_kernel<float",
                                "bwd_dq_kernel<float", "bwd_dbias_kernel<float", REDUCE)},
          "K6": {"bf16": (LN_ROWS + "__nv_bfloat16, 3>", _sm90(8, 2), _sm90(8, 1),
                          COLSUM + "false>", LN_BWD + "__nv_bfloat16, float, 3, 2>", REDUCE1,
                          REDUCE)},
          "K8": {"bf16": (_sm90(6, 0), LN_ROWS + "float, 3>", _sm90(7, 0), _sm90(8, 0),
                          COLSUM + "true>", _sm90(8, 2), _sm90(9, 1), _sm90(8, 1),
                          LN_BWD + "float, float, 3, 4>", _sm90(0, 1), REDUCE1, REDUCE)},
          "K9": {"bf16": (_sm90(4, 0), LN_ROWS + "float, 3>", _sm90(7, 0), _sm90(5, 0),
                          LN_BWD + "float, __nv_bfloat16, 3, 4>", _sm90(8, 2), _sm90(9, 1),
                          _sm90(5, 1), LN_BWD + "float, float, 3, 4>", _sm90(0, 1), REDUCE1,
                          REDUCE)}}
CHEXPERT = [
    "No Finding", "Enlarged Cardiomediastinum", "Cardiomegaly", "Lung Opacity",
    "Lung Lesion", "Edema", "Consolidation", "Pneumonia", "Atelectasis",
    "Pneumothorax", "Pleural Effusion", "Pleural Other", "Fracture", "Support Devices",
]
# tolerance per (kernel output, dtype): |kernel - plain| <= atol + rtol * |plain|.
# fp32: the JAX suite's parity tolerances. bf16: both sides round at the same
# points, but their fp32 sums run in another order, so a value near a bf16
# rounding boundary may round either way: up to 2 bf16 ulps (2^-7) relative at
# the output, plus such flips in the operands (LN output, softmax weights,
# normalised tokens) carried through the next product, < 2e-3 absolute here.
# K1, K3 and K4 end in a product whose left operand the kernel itself rounded
# (K1 the LN output, K3 and K4 the GELU output), over many rows: a rounded
# operand of size up to 8 (K1) or 4 (K3, K4) that falls the other way is off
# by one bf16 ulp, 2^-5 or 2^-6, and meets a weight of up to 0.1 (times ls2
# <= 1.4 in K3), so one flip moves an output entry by up to 3e-3 (K1) or
# 2e-3 (K3, K4) whatever the entry's own size, and a row of 768 or 3072
# operands may hold a few. Their bf16 atol is stated as a share of the
# largest |reference| entry (flag "scaled"): 2^-9 for K1 (|qkv| <= 3.4) and
# 2^-10 for K3 and K4 (|out| <= 7.5), each about 6e-3, two to three of the
# largest flips; the smoke passes with any --seed, not with one draw.
# K4 in fp32: the JAX suite's 2e-5; its twin and kernel use the exact erf,
# the TPU kernel a rational erf <= 1.5e-7 away. K10 value and K11/K12
# gradients in fp32: the JAX suite's rtol 1e-5 / atol 1e-6 and rtol 1e-4 /
# atol 1e-5. The gradients are sums over 64 images x 1370 tokens (dq, dtau)
# or 512 sentences (dt) of products of rounded factors, so in bf16 a rounding
# flip moves an entry by a share of the largest entry, not of itself: their
# bf16 atol is 2^-7 of the largest |reference| entry (flag "scaled").
# K6-K9 return gradients. fp32: the JAX suite's gradient tolerance, 2e-4 (5e-4
# for the MPNet chain), taken of the largest |reference| entry of each output.
# bf16: kernel and twin round the same factors (LN output, GELU output, dm,
# dh1, dproj; p, dO, dS) at the same points, but their fp32 sums run in
# another order, so a factor near a rounding boundary falls either way: one
# bf16 ulp, 2^-8 of that factor. Every output entry is a sum over hundreds to
# tens of thousands of such products (rows for the parameter gradients,
# columns or keys for dx, da and d qkv), so one flipped factor moves an entry
# by a share of the output's largest entry whatever the entry's own size, a
# row or column holds a few of them, and the entry's own final rounding may
# flip too (2^-8 of itself): 2^-7 of the largest |reference| entry plus 2^-7
# relative, as for K11 / K12.
# K13-K16. fp32: the JAX suite's (tests/test_flash_attention.py): rtol 1e-4 /
# atol 1e-5 for the forward, 2e-5 with the bias, rtol 1e-4 / atol 1e-4 for the
# gradients; a 1370- or 4097-key sum in another order stays a decade inside
# them. bf16: K13 rounds the softmax weights before P.V as K2 does, so K2's
# tolerance. K15 runs over 2 to 256 real keys of unit variance, where one
# softmax weight p can be near 1: a weight that rounds the other way in kernel
# and twin is off by one bf16 ulp of itself, 2^-8 p, and moves the output by
# 2^-8 p |v| whatever the output's own size, so its atol is 2^-9 of the largest
# |reference| entry (flag "scaled"; about 9e-3 at |ref| <= 4.5), about one such
# flip at p = 1/2. K2's fixed atol of 2e-3 was K15's at first and does not hold
# for every draw: with --seed 1 one entry of 12.6 M at 512 x 32 is 2.1e-3 off at
# |ref| 0.004, with --seed 2 one at 64 x 256 is 2.4e-3 off at |ref| 0.05 (103-104%
# of that tolerance), each a sum of cancelling terms that holds such a flip; the
# kernel was not changed for it (fp32 errors <= 1.4e-6). The share of K2's
# tolerance that each run's worst entry takes is printed beside. K14 and K16 round P, dO and dS as K7 does, so K7's (a share
# of the largest |reference| entry of each gradient). d(bias) is an fp32 sum of
# unrounded dS on both sides and only its order differs. K7 / K14 in bf16 run
# the Hopper kernels, which take delta as rowsum(dO O) over the forward's bf16
# output (FlashAttention-2's identity) where the TPU kernel and the twin take
# rowsum(dP P) with P unrounded: the same sum reassociated, off by the
# rounding of P before P.V and of O, ~2^-9 of |delta|, far below dS's own
# bf16 rounding; the tolerance is unchanged. The lse the bf16 forward writes
# (m + log2 l, fp32 from the same bf16 operands, sums in another order, ex2 to
# 2 ulp) is held to 1e-4 + 1e-5 relative: the order of 64 fp32 products moves
# a score by <= 64 2^-24 sum|q k| sl2, under 4e-5 at |q k| sums <= 50.
BWD_OUTPUTS = {
    "K14": ("dq", "dk", "dv"),
    "K16": ("dq", "dk", "dv", "dbias"),
    "K6": ("dx", "dln_s", "dln_b", "dw", "db"),
    "K7": ("dq", "dk", "dv"),
    "K8": ("dx", "da", "dwo", "dbo", "dls1", "dln_s", "dln_b", "dw1", "db1", "dw2", "db2",
           "dls2"),
    "K9": ("dx", "da", "dwo", "dbo", "dlnsa", "dlnba", "dw1", "db1", "dw2", "db2", "dlnso",
           "dlnbo"),
}
TOL = {
    ("K6", "fp32"): (2e-4, 0.0, "scaled"), ("K7", "fp32"): (2e-4, 0.0, "scaled"),
    ("K8", "fp32"): (2e-4, 0.0, "scaled"), ("K9", "fp32"): (5e-4, 0.0, "scaled"),
    ("K1", "fp32"): (2e-5, 2e-5), ("K2", "fp32"): (1e-4, 1e-4),
    ("K3", "fp32"): (2e-5, 2e-5), ("K5 logits", "fp32"): (1e-5, 1e-4),
    ("K5 maps", "fp32"): (1e-4, 1e-4),
    ("K4", "fp32"): (2e-5, 2e-5), ("K4 16384", "fp32"): (2e-5, 2e-5),
    ("K1 train", "fp32"): (2e-5, 2e-5), ("K2 train", "fp32"): (1e-4, 1e-4),
    ("K3 train", "fp32"): (2e-5, 2e-5),
    ("K10 logits", "fp32"): (1e-6, 1e-5), ("K11 dq", "fp32"): (1e-5, 1e-4),
    ("K11 dtau", "fp32"): (1e-5, 1e-4), ("K12 dt", "fp32"): (1e-5, 1e-4),
    ("K13", "fp32"): (1e-5, 1e-4), ("K15", "fp32"): (2e-5, 1e-4),
    ("K14", "fp32"): (1e-4, 1e-4), ("K16", "fp32"): (1e-4, 1e-4),
}
for _k in ("K2", "K2 train", "K5 logits", "K5 maps", "K10 logits", "K13"):
    TOL[(_k, "bf16")] = (2e-3, 2.0**-7)
TOL[("K15", "bf16")] = (2.0**-9, 2.0**-7, "scaled")
for _k in ("K1", "K1 train"):
    TOL[(_k, "bf16")] = (2.0**-9, 2.0**-7, "scaled")
for _k in ("K3", "K3 train", "K4", "K4 16384"):
    TOL[(_k, "bf16")] = (2.0**-10, 2.0**-7, "scaled")
for _k in ("K11 dq", "K11 dtau", "K12 dt", "K6", "K7", "K8", "K9", "K14", "K16"):
    TOL[(_k, "bf16")] = (2.0**-7, 2.0**-7, "scaled")
TOL[("lse", "bf16")] = (1e-4, 1e-5)
# K10's statistics against their twin (vlcabs_train_stats_plain): the row max is
# the largest s, an fp32 sum of the same products in another order, at |s| up to
# 1 / tau; g = e . tn sums 1370 products of e rounded, so a flip of e moves an
# entry by a share of the largest entry (as K11 / K12's sums), which bf16 K10
# holds to 2^-7 as its gradients; fp32 at the card tests' 1e-4
TOL[("K10 rowmax", "bf16")] = (2e-3, 2.0**-7)
TOL[("K10 g", "bf16")] = (2.0**-7, 2.0**-7, "scaled")
TOL[("K10 rowmax", "fp32")] = (1e-4, 1e-4)
TOL[("K10 g", "fp32")] = (1e-4, 1e-4, "scaled")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def compare(name, dtype_name, out, ref, tol=None, quiet=False):
    """``tol`` names the TOL entry when it is not ``name``; ``quiet`` prints
    nothing and returns (max_abs_err, worst share of the tolerance)."""
    import torch

    out, ref = out.float(), ref.float()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        fail(f"{name} {dtype_name}: shape {tuple(out.shape)} vs {tuple(ref.shape)} or non-finite")
    err = (out - ref).abs()
    rel = (err / ref.abs().clamp_min(1e-6)).max().item()
    atol, rtol, *scaled = TOL[(tol or name, dtype_name)]
    if scaled:
        atol *= ref.abs().max().item()
    used = (err / (atol + rtol * ref.abs())).max().item()  # worst share of the tolerance
    ok = used <= 1.0
    if quiet and ok:
        return err.max().item(), used
    print(f"  {name:10s} {dtype_name}: max_abs_err {err.max().item():.3e}  max_rel_err "
          f"{rel:.3e}  (atol {atol:.3g}, rtol {rtol:.3g}; |ref| <= {ref.abs().max().item():.3g}; "
          f"worst entry at {100 * used:.0f}% of its tolerance) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name} {dtype_name} kernel disagrees with its plain twin")
    return err.max().item()


def device_kernels(fn, calls=5, tries=3):
    """{device kernel name: its device ms a call} over ``calls`` calls of ``fn``
    under torch.profiler. A session that recorded no device activity at all
    (CUPTI now and then delivers none, though the calls ran) is profiled
    again, up to ``tries`` sessions; what a session does record is returned
    as it is."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(tries):
        torch.cuda.synchronize()  # no earlier launch still in flight when the session opens
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ran = {e.key: e.self_device_time_total / 1e3 / calls
               for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
        if ran:
            break
        print(f"  torch.profiler recorded no device kernel in session {attempt + 1} of {tries}")
    return ran


def check_route(k, dname, fn, way="fwd", detail=False):
    """A call of K1 (way "K1"), K3 ("K3"), K4 ("K4"), K5 ("K5"), K10 ("K10"),
    K2 / K13 ("fwd"), K7 / K14 ("bwd"), K15 ("bias_fwd"), K16 ("bias_bwd"),
    K6 / K8 / K9 ("K6", "K8", "K9"), K11 / K12 ("K11", "K12") or the two at
    once ("K11+K12") runs exactly
    the device kernels of ROUTES: in bf16 row_layernorm_kernel and
    gemm_sm90_kernel, the five stages of the VL-CABS forward (never
    vlcabs_kernel or vlc_pass1_kernel in bf16), fwd_sm90_kernel, or
    bwd_dq_sm90_kernel and bwd_dkdv_sm90_kernel (never bwd_stats_kernel), the
    kernels of flash_bias_small.cu at L <= 64, the chains' gemm_sm90_kernel
    instantiations with their row passes and reduces (never wgrad_bf16_kernel
    or transpose_kernel), or the VL-CABS backward's row passes with K12's
    first phase, K11's product and reduce and K12's second phase in bf16
    (never vlc_pass1_kernel or vlc_dq_kernel) -> their device ms a call
    (no host time), with ``detail`` also {kernel name: its device ms a call}."""
    ran = device_kernels(fn)
    want = ROUTES[way][dname]
    if len(ran) != len(want) or not all(any(w in name for name in ran) for w in want):
        fail(f"{k} {dname}: expected the device kernels {want}, ran {list(ran)}")
    ms = sum(ran.values())
    names = ", ".join(f"{name[:48]}... {t:.4f}" for name, t in ran.items())
    print(f"  {k:10s} {dname}: torch.profiler: {names}; {ms:.4f} ms a call on the device")
    return (ms, ran) if detail else ms


def vl_stage_times(k, qn, tokens, tau, ran):
    """Each stage of bf16 K5 / K10 (``k``) alone by CUDA events (a stage
    wrapper's call a sample, its allocations included) beside its device time
    in ``ran``, the route's profiler session of the whole call -> {stage:
    {"ms", "device_ms"}}."""
    from radzero_torch.ops import vlcabs_fused as vf

    tau, l, maps = tau.reshape(1), tokens.shape[1], k == "K5"
    tn = vf.vlcabs_rownorm(tokens)
    s, tmax = vf.vlcabs_fwd_scores(qn, tn, tau)
    e = vf.vlcabs_fwd_rows(s, tmax, l, maps=maps)[0]
    g = vf.vlcabs_fwd_g(e, tn, qn.shape[0])
    calls = {"rownorm": (lambda: vf.vlcabs_rownorm(tokens), "rownorm_kernel"),
             "phase 1": (lambda: vf.vlcabs_fwd_scores(qn, tn, tau), VLC_SCORES),
             "row pass": (lambda: vf.vlcabs_fwd_rows(s, tmax, l, maps=maps),
                          "vlc_exp_rows_kernel"),
             "phase 2": (lambda: vf.vlcabs_fwd_g(e, tn, qn.shape[0]), _sm90(8, 4)),
             "logits": (lambda: vf.vlcabs_logits(qn, g), "vlc_logits_kernel")}
    out = {name: {"ms": median_ms(fn, reps=10),
                  "device_ms": next(t for n, t in ran.items() if kernel in n)}
           for name, (fn, kernel) in calls.items()}
    print(f"  {k:10s} bf16 stages, events (device) ms: " + ", ".join(
        f"{name} {v['ms']:.4f} ({v['device_ms']:.4f})" for name, v in out.items()))
    return out


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def shared_backward(dname, qn, tokens, tau, dz, stats):
    """The VL-CABS backward as the autograd function runs it on the card
    (vlcabs_train_bwd: the tokens' and the backward's row passes and, in
    bf16, K12's first phase once for K11 and K12) against the whole twins
    at K11's and K12's tolerances, its device kernels by name and time
    (torch.profiler), a second call's bits, CUDA-event and plain times ->
    the row of "K11+K12", with "own_ms": the device ms of K11's own launches
    (its product over dc and the reduce; bf16)."""
    import torch
    from radzero_torch.ops import vlcabs_fused as vf

    bwd = lambda: vf.vlcabs_train_bwd(qn, tokens, tau, dz, stats=stats)  # noqa: E731
    plain = lambda: vf.vlcabs_train_backward_plain(qn, tokens, tau, dz)  # noqa: E731
    dq, dtn, dtau = bwd()
    ref = plain()
    torch.cuda.synchronize()
    err = max(compare("K11+K12 dq", dname, dq, ref[0], tol="K11 dq"),
              compare("K11+K12 dt", dname, vf._rownorm_vjp(dtn, tokens), ref[1], tol="K12 dt"),
              compare("K11+K12 dtau", dname, dtau, ref[2], tol="K11 dtau"))
    again = bwd()
    if not all(torch.equal(a, b) for a, b in zip((dq, dtn, dtau), again)):
        fail(f"K11+K12 {dname}: a second backward gives other bits")
    del dq, dtn, dtau, ref, again
    dev_ms, ran = check_route("K11+K12", dname, bwd, "K11+K12", detail=True)
    own = sum(t for name, t in ran.items() if any(k in name for k in K11_OWN))
    ms, plain_ms = median_ms(bwd, reps=10), median_ms(plain, reps=10)
    print(f"  K11+K12    {dname}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms (median of 10); "
          f"K11's own launches {own:.4f} ms on the device")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "device_ms": dev_ms,
            "library_ms": None, "own_ms": own,
            "kernels_device_ms": {name[:60]: t for name, t in ran.items()}}


def device_idle(fn):
    """One call of ``fn`` under torch.profiler (device activity only) -> (the
    card's busy ms: the sum of its kernels' times, the wall ms of the call up to
    a synchronize), or None when the session recorded no device kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    return (busy, wall) if busy > 0 else None


def host_us(fn, n=200):
    """Host microseconds a call of ``fn`` (the enqueue; the card runs behind)."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def sdpa_backward_ms(q, k, v, g, bias=None, neg=None):
    """The yardstick of an attention backward: F.scaled_dot_product_attention's
    backward alone on (B, H, L, 64) operands, its forward run once outside the
    timed call; with ``bias`` (H, L, L) a leaf broadcast over the batch beside
    the key mask ``neg`` (B, L), so the time includes autograd's sum of the
    broadcast. -> (CUDA-event ms, device ms by torch.profiler); (None, None),
    with the reason printed, where no backend computes it."""
    import torch
    import torch.nn.functional as Fn

    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    mask = None
    if bias is not None:
        leaves.append(bias.detach().requires_grad_(True))
        mask = (leaves[3][None] + neg[:, None, None, :]).to(q.dtype)
    try:
        out = Fn.scaled_dot_product_attention(*leaves[:3], attn_mask=mask)
        call = lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)  # noqa: E731
        return median_ms(call, reps=5, warmup=1), sum(device_kernels(call, calls=3).values())
    except RuntimeError as err:
        print(f"  no library backward: {str(err).splitlines()[0][:200]}")
        return None, None


def median_ms(fn, reps=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def layer_inputs(k, dtype, gen, m):
    """The operands of K1, K3 or K4 (``k``) at m rows."""
    import torch

    def rn(*shape, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std + mean).to(dtype)

    if k == "K1":
        return (rn(m, D), rn(D, std=0.1, mean=1.0), rn(D, std=0.1), rn(D, 3 * D, std=0.02),
                rn(3 * D, std=0.02))
    if k == "K4":
        return (rn(m, D), rn(m, D), rn(D, D, std=0.02), rn(D, std=0.02),
                rn(D, std=0.1, mean=1.0), rn(D, std=0.1), rn(D, F, std=0.02), rn(F, std=0.02),
                rn(F, D, std=0.02), rn(D, std=0.02), rn(D, std=0.1, mean=1.0), rn(D, std=0.1))
    return (rn(m, D), rn(m, D), rn(D, D, std=0.02), rn(D, std=0.02), rn(D, std=0.1, mean=1.0),
            rn(D, std=0.1, mean=1.0), rn(D, std=0.1), rn(D, F, std=0.02), rn(F, std=0.02),
            rn(F, D, std=0.02), rn(D, std=0.02), rn(D, std=0.1, mean=1.0))


def kernel_inputs(dtype, gen):
    import torch

    def rn(*shape, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std + mean).to(dtype)

    def unit(n):
        q = torch.randn((n, D), generator=gen, device="cuda")
        return (q / q.norm(dim=-1, keepdim=True)).to(dtype)

    return {
        "K1": layer_inputs("K1", dtype, gen, B * L),
        "K2": (rn(B, L, 3 * D),),
        "K3": layer_inputs("K3", dtype, gen, B * L),
        "K5": (unit(N), rn(B, L, D), torch.tensor(0.07, device="cuda")),
        # the frozen tower of the training step: the same kernels at 64 images
        "K1 train": layer_inputs("K1", dtype, gen, TB * L),
        "K2 train": (rn(TB, L, 3 * D),),
        "K3 train": layer_inputs("K3", dtype, gen, TB * L),
        "K4": layer_inputs("K4", dtype, gen, M_TEXT),
        "K4 16384": layer_inputs("K4", dtype, gen, TN * T_LEN),
        # qn, tokens, tau, cotangent: the training step's VL-CABS operands
        "train": (unit(TN), rn(TB, L, D), torch.tensor([0.07], device="cuda"),
                  torch.randn((TN, TB), generator=gen, device="cuda")),
    }


def bounds(dtype_bytes=2):
    """Least time the card could take, per kernel, from the shapes above: the
    larger of bytes / memory rate (each input read once, each output written
    once) and operations / peak bf16 rate -> {key: (bound_ms, bound_by)}."""
    e = dtype_bytes
    vl = TB * TN * L * D  # one VL-CABS product is 2 * vl operations
    stat = TB * TN * (D + 1) * 4  # the forward's g and row max, fp32

    def tower(b):  # K1-K3 at b images -> (operations, bytes) each
        m = b * L
        return ((2 * m * D * 3 * D, (m * D + D * 3 * D + 3 * D + 2 * D + m * 3 * D) * e),
                (4 * b * H * L * L * (D // H), (b * L * 3 * D + b * L * D) * e),
                (2 * m * D * (D + 2 * F), (3 * m * D + D * D + 2 * D * F + 6 * D + F) * e))

    work = dict(zip(("K1", "K2", "K3"), tower(B)))
    work.update(zip(("K1 train", "K2 train", "K3 train"), tower(TB)))
    work |= {  # key: (operations, bytes)
        "K4": (2 * M_TEXT * D * (D + 2 * F),
               (3 * M_TEXT * D + D * D + 2 * D * F + 6 * D + F) * e),
        "K4 16384": (2 * TN * T_LEN * D * (D + 2 * F),
                     (3 * TN * T_LEN * D + D * D + 2 * D * F + 6 * D + F) * e),
        "K5": (4 * B * N * L * D, (B * L * D + N * D) * e + (B * N * L + N * B) * 4),
        # K10: s and g. K12 reads the forward's statistics, g (B, N, D) and the row
        # max (B, N) in fp32: s, de, dc^T.qn, e^T.dg
        "K10": (4 * vl, (TB * L * D + TN * D) * e + TN * TB * 4),
        "K12": (8 * vl, (2 * TB * L * D + TN * D) * e + TN * TB * 4 + stat),
        # K11's own launches in bf16, after K12's first phase (which computes its S,
        # dE and dc and writes its dtau slots): dq = sum_b (dz ghat + dc tn); reads dc
        # (B, N, L), tn, dz ghat (B, N, D) fp32 and the slots, writes dq and dtau
        "K11": (2 * vl, (TB * TN * L + TB * L * D + TN * D) * e + TB * TN * D * 4
                + K11_SLOTS * 4 + 4),
        # the whole backward from the statistics, K11 and K12 (vlcabs_train_bwd): s,
        # de, dc.tn, dc^T.qn, e^T.dg; reads tokens, queries, statistics, dz; writes
        # dq, dtn, dtau
        "K11+K12": (10 * vl, (2 * TB * L * D + 2 * TN * D) * e + TN * TB * 4 + stat + 4),
        # K12's contract before the statistics: pass 1 (s, g) again
        "K12 old": (10 * vl, (2 * TB * L * D + TN * D) * e + TN * TB * 4),
    }
    for tag, b in (("", TB), (" 2img", 2)):  # K6-K8 at b images: operations, bytes
        m = b * L
        work |= {
            # dh = g W^T and dW = h^T g; reads x, g, W, writes dx, dW, db, dln
            "K6" + tag: (4 * m * D * 3 * D, (2 * m * D + m * 3 * D + 2 * D * 3 * D + 3 * D + 4 * D) * e),
            # S, dP, dV, dQ, dK per head; reads qkv, dout, out and lse, writes d qkv
            "K7" + tag: (10 * b * H * L * L * (D // H),
                         (2 * b * L * 3 * D + 2 * b * L * D) * e + b * H * L * 4),
            # the three forward products again and two backward products for each
            "K8" + tag: (6 * m * D * (D + 2 * F),
                         (5 * m * D + 2 * (D * D + 2 * D * F) + 2 * (6 * D + F)) * e),
        }
    for tag, m in (("", TN * T_LEN), (" 1370", M_RAGGED)):
        work["K9" + tag] = (6 * m * D * (D + 2 * F),
                            (5 * m * D + 2 * (D * D + 2 * D * F) + 2 * (6 * D + F)) * e)
    out = {}
    for k, (ops, nbytes) in work.items():
        t_ops, t_bytes = ops / PEAK_FLOPS["bf16"] * 1e3, nbytes / PEAK_BYTES * 1e3
        out[k] = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
    return out


def check_no_spills(log):
    """ptxas must report no spills for the Hopper kernels (the forward of
    K2 / K13, the two of the K7 / K14 backward, every instantiation of the
    GEMM of K1 / K3-K6 / K8-K10 / K12, the first phases of K12 and of K5 /
    K10), the short-sentence K15 / K16 kernels, and every instantiation of
    the chains' row passes and of the two-level reduce's first level."""
    if not log:
        print("  ptxas: no report in this process (the library was built before)")
        return
    lines = log.splitlines()
    for name in (HOPPER_FWD, *HOPPER_BWD, GEMM_SM90, VLC_PHASE1, VLC_SCORES, *SMALL_BIAS,
                 *ROW_PASSES):
        at = [i for i, line in enumerate(lines) if "Compiling entry" in line and name in line]
        if not at:
            fail(f"ptxas reported no {name}")
        if name == GEMM_SM90 and len(at) != GEMM_SM90_INSTANCES:
            fail(f"ptxas reported {len(at)} instantiations of {name}, not {GEMM_SM90_INSTANCES}")
        for i in at:
            report = " ".join(lines[i + 1:i + 4])
            if "0 bytes spill stores, 0 bytes spill loads" not in report:
                fail(f"{name} spills: {report}")
    print(f"  {', '.join((HOPPER_FWD, *HOPPER_BWD))} (K2 / K13, K7 / K14 in bf16), "
          f"{GEMM_SM90} (bf16: {GEMM_SM90_INSTANCES} instantiations; K1 / K3 / K4's four "
          f"epilogues, the chains' seven on W and on W^T read K-major, the dW product, "
          f"K12's and K5 / K10's second phases), {VLC_PHASE1} (K12's first phase), "
          f"{VLC_SCORES} (K5 / K10's first phase), "
          f"{', '.join(SMALL_BIAS)} (K15 / K16 in bf16 at L <= 64), "
          f"{', '.join(ROW_PASSES)} (the chains' row passes and two-level reduce): no spills")


def phase_kernels(seed):
    """Kernel vs plain twin at the main paths' shapes; returns rows for the JSON."""
    import torch
    import torch.nn.functional as Fn
    from radzero_torch.ops import fused_layer as fl
    from radzero_torch.ops import vlcabs_fused as vf

    pairs = {
        "K1": (fl.fused_preattn, fl.fused_preattn_plain, {}),
        "K2": (fl.flash_attention_packed, fl.flash_attention_packed_plain, {"n_heads": H}),
        "K3": (fl.fused_postattn, fl.fused_postattn_plain, {}),
        "K1 train": (fl.fused_preattn, fl.fused_preattn_plain, {}),
        "K2 train": (fl.flash_attention_packed, fl.flash_attention_packed_plain, {"n_heads": H}),
        "K3 train": (fl.fused_postattn, fl.fused_postattn_plain, {}),
        "K4": (fl.fused_mpnet_post, fl.fused_mpnet_post_plain, {}),
        "K4 16384": (fl.fused_mpnet_post, fl.fused_mpnet_post_plain, {}),
        "K5": (vf.vlcabs_fused, vf.vlcabs_fused_plain, {}),
    }
    train_pairs = {
        "K10": (vf.vlcabs_train_forward, vf.vlcabs_train_forward_plain),
        "K11": (vf.vlcabs_train_bwd_dq, vf.vlcabs_train_bwd_dq_plain),
        "K12": (vf.vlcabs_train_bwd_dtn, vf.vlcabs_train_bwd_dtn_plain),
    }
    rows, k5_host = {}, {}
    for dtype, dname in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        inputs = kernel_inputs(dtype, gen)
        print(f"kernels vs plain twins, {dname}:")
        for k, (kern, plain, kw) in pairs.items():
            args = inputs[k]
            out, ref = kern(*args, **kw), plain(*args, **kw)
            torch.cuda.synchronize()
            if k == "K5":
                err = max(compare("K5 logits", dname, out[0], ref[0]),
                          compare("K5 maps", dname, out[1], ref[1]))
            else:
                err = compare(k, dname, out, ref)
            del out, ref
            reps = 10 if k.endswith(" train") else 20
            ms = median_ms(lambda: kern(*args, **kw), reps=reps)
            plain_ms = median_ms(lambda: plain(*args, **kw), reps=reps)
            print(f"  {k:10s} {dname}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms "
                  f"(median of {reps})")
            if k[:2] in ("K1", "K2", "K3") or (k[:2] == "K4" and dname == "bf16"):
                dev_ms = check_route(k, dname, lambda: kern(*args, **kw),  # kernels by name
                                     "fwd" if k[:2] == "K2" else k[:2])
            if k == "K5":  # its kernels by name, each stage's time, a second call's bits
                dev_ms, ran = check_route(k, dname, lambda: kern(*args), k, detail=True)
                if not all(torch.equal(a, b) for a, b in zip(kern(*args), kern(*args))):
                    fail(f"K5 {dname}: a second call gives other bits")
                k5_host[dname] = host_us(lambda: kern(*args))
                print(f"  K5         {dname}: host time a call {k5_host[dname]:.1f} us")
                if dname == "bf16":
                    k5_stages = vl_stage_times(k, *args, ran)
            if k == "K2 train" and dname == "bf16":  # the row statistic K7 reads, against its twin
                _, lse = fl.flash_attention_packed_lse(args[0], H)
                ref_lse = torch.cat([fl.flash_attention_packed_lse_plain(args[0][i:i + 8], H)[1]
                                     for i in range(0, TB, 8)])
                lse_err = compare("K2 lse", dname, lse, ref_lse, tol="lse")
                del lse, ref_lse
            if dname != "bf16":
                continue
            if k.endswith(" train"):  # beside the serving shape's numbers of the same kernel
                rows[k[:2]].update(max_abs_err_training=err, ms_training=ms,
                                   plain_ms_training=plain_ms)
            else:
                rows[k] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                           "library_ms": None}
            if k in ("K1", "K2", "K3", "K4", "K5"):
                rows[k]["device_ms"] = dev_ms
            if k == "K5":
                rows[k].update(stages=k5_stages, host_us_bf16=k5_host["bf16"],
                               host_us_fp32=k5_host["fp32"])
            elif k == "K4 16384":
                rows["K4"]["device_ms_16384"] = dev_ms
            elif k in ("K1 train", "K2 train", "K3 train"):
                rows[k[:2]]["device_ms_training"] = dev_ms
            if k == "K2 train":
                rows["K2"]["max_abs_err_lse_training"] = lse_err

        # K10-K12 through the autograd function, as the training step runs them
        qn, tokens, tau, dz = inputs["train"]
        leaves = [x.clone().requires_grad_(True) for x in (qn, tokens, tau)]
        logits = vf.vlcabs_fused_train(*leaves)
        grads = torch.autograd.grad(logits, leaves, dz)
        ref_logits = vf.vlcabs_train_forward_plain(qn, tokens, tau)
        ref_grads = vf.vlcabs_train_backward_plain(qn, tokens, tau, dz)
        torch.cuda.synchronize()
        errs = {"K10": compare("K10 logits", dname, logits.detach(), ref_logits),
                "K11": compare("K11 dq", dname, grads[0], ref_grads[0]),
                "K12": compare("K12 dt", dname, grads[1], ref_grads[1])}
        dtau_err = compare("K11 dtau", dname, grads[2], ref_grads[2])
        del leaves, logits, grads, ref_logits, ref_grads
        # K11 and K12 alone read the statistics that a K10 call writes under autograd
        _, stats = vf.vlcabs_train_forward(qn, tokens, tau, with_stats=True)
        stats_ms = median_ms(lambda: vf.vlcabs_train_forward(qn, tokens, tau, with_stats=True),
                             reps=10)
        print(f"  K10        {dname}: with the statistics (row max, g) {stats_ms:.4f} ms "
              f"(median of 10)")
        # K10's kernels by name, its statistics against their twin, a second call's bits
        fwd = lambda: vf.vlcabs_train_forward(qn, tokens, tau, with_stats=True)  # noqa: E731
        k10_ms, ran = check_route("K10", dname, fwd, "K10", detail=True)
        again = fwd()
        if not (torch.equal(again[0], vf.vlcabs_train_forward(qn, tokens, tau))
                and all(torch.equal(a, b) for a, b in zip(again[1], stats))):
            fail(f"K10 {dname}: a second call gives other bits")
        ref_m, ref_g = vf.vlcabs_train_stats_plain(qn, tokens, tau)
        stats_err = max(compare("K10 rowmax", dname, stats[0], ref_m),
                        compare("K10 g", dname, stats[1], ref_g))
        del again, ref_m, ref_g
        if dname == "bf16":
            k10_stages = vl_stage_times("K10", qn, tokens, tau, ran)
        for k, (kern, plain) in train_pairs.items():
            args = (qn, tokens, tau) + ((dz,) if k != "K10" else ())
            kw = {"stats": stats} if k != "K10" else {}
            ms = median_ms(lambda: kern(*args, **kw), reps=10)
            plain_ms = median_ms(lambda: plain(*args), reps=10)
            print(f"  {k:10s} {dname}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms (median of 10)")
            dev_ms = k10_ms if k == "K10" else None
            if k != "K10":  # the device kernels that ran, by name; a second call's bits
                dev_ms = check_route(k, dname, lambda: kern(*args, **kw), k)
                first, again = kern(*args, **kw), kern(*args, **kw)
                if not all(torch.equal(a, b) for a, b in zip(_outputs(first), _outputs(again))):
                    fail(f"{k} {dname}: a second backward gives other bits")
                del first, again
            if dname == "bf16":
                rows[k] = {"max_abs_err": errs[k], "ms": ms, "plain_ms": plain_ms,
                           "library_ms": None}
                if dev_ms is not None:
                    rows[k]["device_ms"] = dev_ms
        joint = shared_backward(dname, qn, tokens, tau, dz, stats)
        if dname == "bf16":
            rows["K10"].update(ms_with_stats=stats_ms, max_abs_err_stats=stats_err,
                               stages=k10_stages)
            rows["K11"].update(max_abs_err_dtau=dtau_err, device_ms_own=joint.pop("own_ms"))
            rows["K11+K12"] = joint
            # K2's yardstick, timed here and called nowhere in the port: one
            # library attention call on the unpacked heads of the same input,
            # at 8 images and at the training step's 64
            for key, tag, b in (("K2", "", B), ("K2 train", "_training", TB)):
                q, k_, v = (inputs[key][0][..., i * D:(i + 1) * D].reshape(b, L, H, D // H)
                            .transpose(1, 2) for i in range(3))
                lib = median_ms(lambda: Fn.scaled_dot_product_attention(q, k_, v))
                lib_dev = sum(device_kernels(
                    lambda: Fn.scaled_dot_product_attention(q, k_, v)).values())
                rows["K2"].update({f"library_ms{tag}": lib, f"library_device_ms{tag}": lib_dev})
                print(f"  {key:10s} yardstick: F.scaled_dot_product_attention {lib:.4f} ms "
                      f"(median of 20), {lib_dev:.4f} ms a call on the device")
                del q, k_, v
            # the host's share of a call at 1 x 128 tokens: the bf16 wrapper takes three
            # TMA tensor maps (encoded once, then kept), the fp32 one none
            small = torch.randn((1, 128, 3 * D), generator=gen, device="cuda")
            small16 = small.to(torch.bfloat16)
            us = {name: host_us(lambda: fl.flash_attention_packed(t, H))
                  for name, t in (("bf16", small16), ("fp32", small))}
            rows["K2"].update(host_us_bf16=us["bf16"], host_us_fp32=us["fp32"])
            print(f"  K2 host time a call at 1 x 128: bf16 {us['bf16']:.1f} us (three tensor maps), "
                  f"fp32 {us['fp32']:.1f} us")
            del small, small16
            # K1 / K3 / K4 at 128 rows: in bf16 each product takes tensor maps of A, W
            # and the output (and of the residual in K3 / K4's o-proj and fc2; encoded
            # once and then kept, csrc/sm90.cuh) and the wrapper allocates the LN scratch
            small_gen = torch.Generator(device="cuda").manual_seed(seed)
            for k, maps in (("K1", 3), ("K3", 11), ("K4", 11)):
                kern = pairs[k][0]
                small = {name: layer_inputs(k, dt, small_gen, 128)
                         for name, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32))}
                us = {name: host_us(lambda: kern(*ops)) for name, ops in small.items()}
                rows[k].update(host_us_bf16=us["bf16"], host_us_fp32=us["fp32"])
                print(f"  {k} host time a call at 128 rows: bf16 {us['bf16']:.1f} us ({maps} "
                      f"tensor maps), fp32 {us['fp32']:.1f} us")
                del small
        del inputs, qn, tokens, dz, stats
        torch.cuda.empty_cache()
        backward_kernels(dtype, dname, gen, rows)
        attention_kernels(dtype, dname, gen, rows)
    cublas_products(rows)
    for k, (bound_ms, bound_by) in bounds().items():
        if k.endswith((" 2img", " 1370")):
            rows[k[:2]].update(bound_ms_small=bound_ms)
            ms = rows[k[:2]]["ms_small"]
        elif k.endswith(" train"):
            rows[k[:2]].update(bound_ms_training=bound_ms)
            ms = rows[k[:2]]["ms_training"]
        elif k.endswith(" old"):  # K12's bound before the forward's statistics
            rows[k[:3]].update(bound_ms_old_contract=bound_ms)
            ms = rows[k[:3]]["ms"]
        elif k == "K4 16384":  # the training step's text rows, beside K4's serving shape
            ms = rows[k]["ms"]
            rows["K4"].update(bound_ms_16384=bound_ms, ms_16384=ms)
        elif k == "K11":  # its own launches, after the phase 1 it shares with K12
            rows[k].update(bound_ms=bound_ms, bound_by=bound_by)
            ms = rows[k]["device_ms_own"]
        else:
            rows[k].update(bound_ms=bound_ms, bound_by=bound_by)
            ms = rows[k]["ms"]
        print(f"  {k:8s} bound {bound_ms:.4f} ms by {bound_by}: kernel at "
              f"{100 * bound_ms / ms:.1f}% of it (bf16{', own launches, device' if k == 'K11' else ''})")
    return rows


def cublas_products(rows):
    """The yardsticks of the GEMM kernels, for which no one PyTorch call
    computes the fused function: each bf16 product of K1 (qkv), K3 and K4
    (o-proj, fc1, fc2), of K6 (dX, dW), of K8 and K9 (all nine: the forward
    recompute, dX and dW of o-proj, fc1 and fc2), of K12 (s, dE, dc^T qn
    and e^T dg over 64 images), of K11 (s, dE, dc tn) and of the two
    together (the five), and of K5 / K10 (s and g, at 8 x 14 and 64 x 512),
    as one cuBLAS call on operands of the same shapes (F.linear, torch.mm of
    a^T g for a dW, torch.matmul / torch.bmm for K5, K10-K12),
    timed alone, without the LN, GELU, residual, column sums, exponentials
    or row passes the kernels fuse; called nowhere in the port ->
    rows[k]["cublas_products_ms.."]; for K1, K3, K4 at 16 384 rows, K5, K6,
    K8-K12 also their device time by torch.profiler beside the
    kernel's -> rows[k]["cublas_products_device_ms.."]."""
    import torch
    import torch.nn.functional as Fn

    gen = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)

    device = {}  # product name: its device ms a call, for K1 and K3

    def dx(m, k, n, name=None):  # (m, k) @ (k, n): a forward product or a dX = g W^T
        a, w = rn(m, k), rn(n, k)
        if name is not None:
            device[name] = sum(device_kernels(lambda: Fn.linear(a, w)).values())
        return median_ms(lambda: Fn.linear(a, w), reps=10)

    def dw(m, k, n, name=None):  # (k, m) @ (m, n): a dW = a^T g over m rows
        a, g = rn(m, k), rn(m, n)
        if name is not None:
            device[name] = sum(device_kernels(lambda: torch.mm(a.t(), g)).values())
        return median_ms(lambda: torch.mm(a.t(), g), reps=10)

    def post(m, timed=False):  # o-proj, fc1, fc2
        return {name: dx(m, k, n, name if timed else None)
                for name, k, n in (("o-proj", D, D), ("fc1", D, F), ("fc2", F, D))}

    def timed(calls):  # {name: call} -> {name: events ms}, device ms into `device`
        times = {}
        for name, call in calls.items():
            device[name] = sum(device_kernels(call).values())
            times[name] = median_ms(call, reps=10)
        return times

    def vl_backward(*names):  # the named per-image products of K11 and K12
        qn, tn, dg = rn(TN, D), rn(TB, L, D), rn(TB, TN, D)
        sc = rn(TB, TN, L)  # dc or e, bf16
        calls = {"s": lambda: torch.matmul(qn, tn.transpose(1, 2)),
                 "dE": lambda: torch.bmm(dg, tn.transpose(1, 2)),
                 "dc tn": lambda: torch.bmm(sc, tn),
                 "dc^T qn": lambda: torch.matmul(sc.transpose(1, 2), qn),
                 "e^T dg": lambda: torch.bmm(sc.transpose(1, 2), dg)}
        return timed({name: calls[name] for name in names})

    def vl_fwd(b, n):  # K5 / K10's two per-image products: s = qn tn^T, g = e tn
        qn, tn, e = rn(n, D), rn(b, L, D), rn(b, n, L)
        return timed({"s": lambda: torch.matmul(qn, tn.transpose(1, 2)),
                      "g": lambda: torch.bmm(e, tn)})

    def chain(m):  # o-proj, fc1, fc2 again, then the dX and dW of fc2, fc1 and o-proj
        return post(m, timed=True) | {
            name: fn(m, k, n, name) for name, fn, k, n in (
                ("dX fc2", dx, D, F), ("dX fc1", dx, F, D), ("dX o-proj", dx, D, D),
                ("dW fc2", dw, F, D), ("dW fc1", dw, D, F), ("dW o-proj", dw, D, D))}

    cases = {  # (kernel, suffix of its row's keys, the kernel's row): the products
        ("K1", "", "K1"): lambda: {"qkv": dx(B * L, D, 3 * D, "qkv")},
        ("K1", "_training", "K1"): lambda: {"qkv": dx(TB * L, D, 3 * D, "qkv")},
        ("K3", "", "K3"): lambda: post(B * L, timed=True),
        ("K3", "_training", "K3"): lambda: post(TB * L, timed=True),
        ("K4", "", "K4"): lambda: post(M_TEXT),
        ("K4", "_16384", "K4 16384"): lambda: post(TN * T_LEN, timed=True),
        ("K6", "", "K6"): lambda: {"dX": dx(TB * L, 3 * D, D, "dX"),
                                   "dW": dw(TB * L, D, 3 * D, "dW")},
        ("K8", "", "K8"): lambda: chain(TB * L),
        ("K9", "", "K9"): lambda: chain(TN * T_LEN),
        ("K12", "", "K12"): lambda: vl_backward("s", "dE", "dc^T qn", "e^T dg"),
        ("K11", "", "K11"): lambda: vl_backward("s", "dE", "dc tn"),
        ("K11+K12", "", "K11+K12"): lambda: vl_backward("s", "dE", "dc tn", "dc^T qn",
                                                        "e^T dg"),
        ("K5", "", "K5"): lambda: vl_fwd(B, N),
        ("K10", "", "K10"): lambda: vl_fwd(TB, TN),
    }
    print("cuBLAS products alone (no LN, GELU or residual), bf16, one call each, median of 10:")
    for (k, sfx, row), make in cases.items():
        device.clear()
        times = make()
        total = sum(times.values())
        rows[k][f"cublas_products_ms{sfx}"] = total
        kernel = rows[row]["ms" + ("" if row != k else sfx)]
        parts = ", ".join(f"{name} {ms:.4f}" for name, ms in times.items())
        print(f"  {k + sfx:12s} {parts}: {total:.4f} ms in all; the kernel {kernel:.4f} ms")
        if device:  # device time, products against the kernel's chain
            dev = sum(device.values())
            rows[k][f"cublas_products_device_ms{sfx}"] = dev
            kernel_dev = rows[k]["device_ms" + sfx]
            print(f"  {'':12s} on the device: products {dev:.4f} ms, the kernel {kernel_dev:.4f} "
                  f"ms ({kernel_dev / dev:.2f}x)")
        torch.cuda.empty_cache()


def backward_kernels(dtype, dname, gen, rows):
    """K6-K9 against their plain twins at the training step's shapes (64
    images, 16 384 text rows) and at 2 images / 1370 rows; fills ``rows``
    from the bf16 run."""
    import torch
    from radzero_torch.ops import fused_layer as fl

    def rn(*shape, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std + mean).to(dtype)

    def k6(m):
        return (rn(m, D), rn(D, std=0.1, mean=1.0), rn(D, std=0.1), rn(D, 3 * D, std=0.02),
                rn(3 * D, std=0.02), rn(m, 3 * D))

    def k8(m):
        return (rn(m, D), rn(m, D), rn(D, D, std=0.02), rn(D, std=0.02), rn(D, std=0.1, mean=1.0),
                rn(D, std=0.1, mean=1.0), rn(D, std=0.1), rn(D, F, std=0.02), rn(F, std=0.02),
                rn(F, D, std=0.02), rn(D, std=0.02), rn(D, std=0.1, mean=1.0), rn(m, D))

    def k9(m):
        return (rn(m, D), rn(m, D), rn(D, D, std=0.02), rn(D, std=0.02),
                rn(D, std=0.1, mean=1.0), rn(D, std=0.1), rn(D, F, std=0.02), rn(F, std=0.02),
                rn(F, D, std=0.02), rn(D, std=0.02), rn(D, std=0.1, mean=1.0), rn(D, std=0.1),
                rn(m, D))

    def k7_inputs(b):  # qkv, dout, and in bf16 the forward's out and lse, which K7 reads
        qkv = rn(b, L, 3 * D)
        stats = fl.flash_attention_packed_lse(qkv, H) if dname == "bf16" else (None, None)
        return (qkv, rn(b, L, D), *stats)

    def k7(qkv, dout, out, lse):
        return fl.flash_attention_packed_bwd(qkv, H, dout, out=out, lse=lse)

    def k7_plain(qkv, dout, out, lse):  # the twin holds (images, 12, 1370, 1370) fp32: 8 at a time
        return torch.cat([fl.flash_attention_packed_bwd_plain(qkv[i:i + 8], H, dout[i:i + 8])
                          for i in range(0, qkv.shape[0], 8)])

    def thirds(t):
        return tuple(t[..., i * D:(i + 1) * D] for i in range(3))

    cases = {  # key: (make inputs, kernel, plain twin, outputs as a tuple)
        "K6": (lambda: k6(TB * L), fl.fused_preattn_bwd, fl.fused_preattn_bwd_plain, tuple),
        "K6 2img": (lambda: k6(2 * L), fl.fused_preattn_bwd, fl.fused_preattn_bwd_plain, tuple),
        "K7": (lambda: k7_inputs(TB), k7, k7_plain, thirds),
        "K7 2img": (lambda: k7_inputs(2), k7, k7_plain, thirds),
        "K8": (lambda: k8(TB * L), fl.fused_postattn_bwd, fl.fused_postattn_bwd_plain, tuple),
        "K8 2img": (lambda: k8(2 * L), fl.fused_postattn_bwd, fl.fused_postattn_bwd_plain, tuple),
        "K9": (lambda: k9(TN * T_LEN), fl.fused_mpnet_post_bwd, fl.fused_mpnet_post_bwd_plain,
               tuple),
        "K9 1370": (lambda: k9(M_RAGGED), fl.fused_mpnet_post_bwd,
                    fl.fused_mpnet_post_bwd_plain, tuple),
    }
    for k, (make, kern, plain, split) in cases.items():
        args = make()
        out, ref = split(kern(*args)), split(plain(*args))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(out, split(kern(*args)))):
            fail(f"{k} {dname}: a second backward gives other bits")
        worst = [compare(f"{k} {name}", dname, a, b, tol=k[:2], quiet=True)
                 for name, a, b in zip(BWD_OUTPUTS[k[:2]], out, ref)]
        scale = max(b.float().abs().max().item() for b in ref)
        i = max(range(len(worst)), key=lambda j: worst[j][1])
        del out, ref
        small = " " in k
        reps = 10 if small else 5
        ms = median_ms(lambda: kern(*args), reps=reps, warmup=1)
        plain_ms = median_ms(lambda: plain(*args), reps=3, warmup=1)
        err = max(w[0] for w in worst)
        lib = lib_dev = dev_ms = stages = None
        if k == "K7":  # the device kernels that ran, by name
            dev_ms = check_route(k, dname, lambda: kern(*args), "bwd")
        if k in ("K6", "K8", "K9") and dname == "bf16":  # its kernels by name, each stage's time
            dev_ms, ran = check_route(k, dname, lambda: kern(*args), k, detail=True)
            stages = {name.removeprefix("void ").replace("(anonymous namespace)::", "")
                      .split("(")[0]: t for name, t in ran.items()}
            print(f"  {k:10s} {dname} stages, device ms a call (all launches of a kernel): "
                  + ", ".join(f"{name} {t:.4f}" for name, t in stages.items()))
        if k == "K7" and dname == "bf16":  # the yardstick, called nowhere in the port
            heads = [t.reshape(TB, L, H, D // H).transpose(1, 2) for t in (*thirds(args[0]),
                                                                           args[1])]
            lib, lib_dev = sdpa_backward_ms(*heads)
            del heads
        print(f"  {k:10s} {dname}: {len(worst)} gradients, max_abs_err {err:.3e} (largest "
              f"|ref| {scale:.3g}); worst {BWD_OUTPUTS[k[:2]][i]} at {100 * worst[i][1]:.0f}% "
              f"of its tolerance; kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
              f"{'' if lib is None else f'  library backward {lib:.4f} ms'}"
              f"{'' if lib_dev is None else f' ({lib_dev:.4f} ms on the device)'}"
              f"{'' if dev_ms is None else f'; {dev_ms:.4f} ms of device time'}; a second "
              f"backward gave the same bits ok")
        if dname == "bf16":
            if small:
                rows[k[:2]].update(max_abs_err_small=err, ms_small=ms, plain_ms_small=plain_ms)
            else:
                rows[k] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                           "library_ms": lib}
                if k == "K7":
                    rows[k].update(device_ms=dev_ms, library_device_ms=lib_dev)
                elif dev_ms is not None:
                    rows[k].update(device_ms=dev_ms, stages_device_ms=stages)
        del args
        torch.cuda.empty_cache()


def attention_kernels(dtype, dname, gen, rows):
    """K13-K16 against their plain twins: K13 / K14 at the tower's shapes (8
    images as the scorer batches them, 64 and 2 as the flash training step
    and its fp32 check do), at a lane-padded length with kv_len and at 4097
    tokens; K15 / K16 at the text shapes, real lengths drawn per sentence.
    Fills ``rows`` from the bf16 run, the bound of each case beside its time."""
    import torch
    import torch.nn.functional as Fn
    from radzero_torch.ops import flash_attention as fa

    hd, e = D // H, 2  # the bounds are the bf16 run's: 2 bytes an element

    def rn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std).to(dtype)

    def by_images(fn):  # the twins hold (images, 12, L, L) fp32: 8 images at a time
        def run(*ops, **kw):
            parts = [fn(*(t[i:i + 8] for t in ops), **kw) for i in range(0, ops[0].shape[0], 8)]
            if isinstance(parts[0], tuple):
                return tuple(torch.cat(col) for col in zip(*parts))
            return torch.cat(parts)
        return run

    def record(k, tag, worst, ms, plain_ms, ops, nbytes, library_ms=None):
        err, used = worst  # the largest error, the worst share of the tolerance
        t_ops, t_bytes = ops / PEAK_FLOPS["bf16"] * 1e3, nbytes / PEAK_BYTES * 1e3
        bound_ms, by = max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
        lib = "" if library_ms is None else f"  library {library_ms:.4f} ms"
        print(f"  {k + ' ' + tag:14s} {dname}: max_abs_err {err:.3e} (worst entry at "
              f"{100 * used:.0f}% of its tolerance)  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
              f"{lib}  bound {bound_ms:.4f} ms by {by} ok")
        if dname != "bf16":
            return
        if not tag:
            rows[k] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": by}
        else:
            rows[k].update({f"max_abs_err_{tag}": err, f"ms_{tag}": ms,
                            f"plain_ms_{tag}": plain_ms, f"bound_ms_{tag}": bound_ms})
            if library_ms is not None:
                rows[k][f"library_ms_{tag}"] = library_ms

    def gradients(k, kern, plain, args, kw):
        """The backward kernel twice against its twin -> (largest error, worst share)."""
        out, again, ref = kern(*args, **kw), kern(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(out, again)):
            fail(f"{k} {dname}: a second backward gives other bits")
        worst = [compare(f"{k} {name}", dname, a, b, tol=k, quiet=True)
                 for name, a, b in zip(BWD_OUTPUTS[k], out, ref)]
        return max(w[0] for w in worst), max(w[1] for w in worst)

    def timed(kern, plain, args, kw, big):
        reps, warm = (5, 1) if big else (20, 3)
        return (median_ms(lambda: kern(*args, **kw), reps=reps, warmup=warm),
                median_ms(lambda: plain(*args, **kw), reps=3 if big else reps, warmup=1))

    # images, tokens, kv_len, q / k / v as views of one packed product, the tags of K13 and K14
    for b, l, kv, packed, tag13, tag14 in (
            (B, L, None, True, "", None), (TB, L, None, True, "64img", ""),
            (2, L, None, True, None, "2img"), (B, L_PAD, L, False, "kv_len", "kv_len"),
            (1, L_LONG, None, False, "4097", "4097")):
        if packed:
            qkv = rn(b, l, 3 * D)
            q, k_, v = (qkv[..., i * D:(i + 1) * D].reshape(b, l, H, hd) for i in range(3))
        else:
            q, k_, v = (rn(b, l, H, hd) for _ in range(3))
        kw, big = {"kv_len": kv}, b * l * l > 5e7
        score_ops, tensor = b * H * l * (kv or l) * hd, b * l * D * e
        if tag13 is not None:
            plain = by_images(fa.flash_attention_plain)
            out, ref = fa.flash_attention(q, k_, v, **kw), plain(q, k_, v, **kw)
            torch.cuda.synchronize()
            err = compare(f"K13 {tag13}", dname, out, ref, tol="K13", quiet=True)
            del out, ref
            ms, plain_ms = timed(fa.flash_attention, plain, (q, k_, v), kw, big)
            lib = None
            if tag13 in ("", "64img"):  # the device kernel that ran, by name
                dev_ms = check_route(f"K13 {tag13}", dname, lambda: fa.flash_attention(q, k_, v))
                if dname == "bf16":  # the yardstick, called nowhere in the port
                    qh, kh, vh = (t.transpose(1, 2) for t in (q, k_, v))
                    lib = median_ms(lambda: Fn.scaled_dot_product_attention(qh, kh, vh))
                    lib_dev = sum(device_kernels(
                        lambda: Fn.scaled_dot_product_attention(qh, kh, vh)).values())
                    print(f"  K13 {tag13:9s} yardstick: F.scaled_dot_product_attention "
                          f"{lib:.4f} ms, {lib_dev:.4f} ms a call on the device")
                    del qh, kh, vh
            record("K13", tag13, err, ms, plain_ms, 4 * score_ops, 4 * tensor, lib)
            sfx = f"_{tag13}" if tag13 else ""
            if tag13 in ("", "64img") and dname == "bf16":
                rows["K13"].update({f"device_ms{sfx}": dev_ms, f"library_device_ms{sfx}": lib_dev})
            if dname == "bf16":  # the row statistic the bf16 backward reads, against its twin
                _, lse = fa.flash_attention_lse(q, k_, v, **kw)
                ref_lse = by_images(lambda *t, **a: fa.flash_attention_lse_plain(*t, **a)[1])(
                    q, k_, v, **kw)
                lse_err, used = compare(f"K13 lse {tag13}", dname, lse, ref_lse, tol="lse",
                                        quiet=True)
                print(f"  K13 lse {tag13:6s} bf16: max_abs_err {lse_err:.3e} (worst entry at "
                      f"{100 * used:.0f}% of its tolerance) ok")
                rows["K13"][f"max_abs_err_lse{sfx}"] = lse_err
                del lse, ref_lse
        if tag14 is not None:
            g = rn(b, l, H, hd)
            if dname == "bf16":  # the forward's output and row statistic, which K14 reads
                kw = {**kw, **dict(zip(("out", "lse"), fa.flash_attention_lse(q, k_, v, **kw)))}
            plain = by_images(fa.flash_attention_bwd_plain)
            err = gradients("K14", fa.flash_attention_bwd, plain, (q, k_, v, g), kw)
            ms, plain_ms = timed(fa.flash_attention_bwd, plain, (q, k_, v, g), kw, big)
            lib = lib_dev = dev_ms = None
            if not tag14:  # the device kernels that ran, by name
                dev_ms = check_route("K14", dname, lambda: fa.flash_attention_bwd(q, k_, v, g, **kw),
                                     "bwd")
            if not tag14 and dname == "bf16":  # the yardstick, called nowhere in the port
                lib, lib_dev = sdpa_backward_ms(*(t.transpose(1, 2) for t in (q, k_, v, g)))
            # reads q, k, v, g, the forward's out and lse; writes dq, dk, dv
            record("K14", tag14, err, ms, plain_ms, 10 * score_ops,
                   8 * tensor + b * H * l * 4, lib)
            if not tag14 and dname == "bf16":
                rows["K14"].update(device_ms=dev_ms, library_device_ms=lib_dev)
            del g, kw
        del q, k_, v
        torch.cuda.empty_cache()

    # sentences x tokens: the training step's, the serving prompts', a long text, a ragged one
    for s_, l, tag in ((TN, T_LEN, ""), (N, 64, "14x64"), (64, 256, "64x256"), (8, 37, "8x37")):
        q, k_, v, g = (rn(s_, l, H, hd) for _ in range(4))
        bias = (torch.randn((H, l, l), generator=gen, device="cuda") * 0.5)
        lengths = torch.randint(2, l + 1, (s_,), generator=gen, device="cuda")
        mask = (torch.arange(l, device="cuda")[None] < lengths[:, None]).float()
        neg = (1.0 - mask) * torch.finfo(dtype).min
        score_ops, tensor = s_ * H * l * l * hd, s_ * l * D * e
        extra = H * l * l * 4 + s_ * l * 4  # bias and mask, fp32
        args = (q, k_, v, bias, neg)
        if not tag and dname == "bf16":
            h_, chunks = fa.bias_grid(q)
            print(f"  K15 / K16 {s_} x {l} bf16: flash_bias_small.cu grid ({h_}, {chunks}), "
                  f"{h_ * chunks} blocks of {2 if l <= 32 else 4} warps, "
                  f"{-(-s_ // chunks)} sentences a block")
        out, ref = fa.flash_attention_bias(*args), fa.flash_attention_bias_plain(*args)
        torch.cuda.synchronize()
        err = compare(f"K15 {tag}", dname, out, ref, tol="K15", quiet=True)
        if dname == "bf16":  # the same errors under K2's fixed atol, which K15 is not held to
            a2, r2 = TOL[("K2", "bf16")]
            share = ((out.float() - ref.float()).abs() / (a2 + r2 * ref.float().abs())).max()
            print(f"  K15 {tag:10s} bf16: under K2's atol {a2:g} the worst entry is at "
                  f"{100 * share.item():.0f}% of its tolerance (not held to it)")
        del out, ref
        ms, plain_ms = timed(fa.flash_attention_bias, fa.flash_attention_bias_plain, args, {},
                             False)
        # the device kernels that ran, by name: at 512 x 32, and at 64 x 256 in bf16
        # (the tiled kernels past 64 tokens); in bf16 the device time and the host's
        # time (the wrapper's enqueue) a call at every shape
        route = dname if not tag else "bf16 L>64" if tag == "64x256" and dname == "bf16" else None
        sfx = f"_{tag}" if tag else ""

        def on_device(k, fn, way):
            if route is not None:
                dev_ms = check_route(f"{k} {tag}", route, fn, way)
            else:
                dev_ms = sum(device_kernels(fn).values())
                print(f"  {k + ' ' + tag:14s} {dname}: {dev_ms:.4f} ms a call on the device")
            if dname == "bf16":
                us = host_us(fn)
                print(f"  {k + ' ' + tag:14s} {dname}: host time a call {us:.1f} us")
                rows[k].update({f"device_ms{sfx}": dev_ms, f"host_us{sfx}": us})

        lib = lib_dev = None
        if not tag and dname == "bf16":  # the mask is summed before the timed call
            qh, kh, vh = (t.transpose(1, 2) for t in (q, k_, v))
            both = (bias[None] + neg[:, None, None, :]).to(dtype)
            call = lambda: Fn.scaled_dot_product_attention(qh, kh, vh, attn_mask=both)  # noqa: E731
            lib, lib_dev = median_ms(call), sum(device_kernels(call).values())
            print(f"  K15 {tag:10s} yardstick: F.scaled_dot_product_attention with attn_mask "
                  f"{lib:.4f} ms, {lib_dev:.4f} ms a call on the device")
            del both, call
        record("K15", tag, err, ms, plain_ms, 4 * score_ops, 4 * tensor + extra, lib)
        if route is not None or dname == "bf16":
            on_device("K15", lambda: fa.flash_attention_bias(*args), "bias_fwd")
        if not tag and dname == "bf16":
            rows["K15"]["library_device_ms"] = lib_dev
        args = (q, k_, v, bias, neg, g)
        err = gradients("K16", fa.flash_attention_bias_bwd, fa.flash_attention_bias_bwd_plain,
                        args, {})
        ms, plain_ms = timed(fa.flash_attention_bias_bwd, fa.flash_attention_bias_bwd_plain,
                             args, {}, False)
        lib = lib_dev = None
        if not tag and dname == "bf16":  # the yardstick: d(bias) includes the batch sum
            lib, lib_dev = sdpa_backward_ms(*(t.transpose(1, 2) for t in (q, k_, v, g)),
                                            bias=bias, neg=neg)
            print(f"  K16 {tag:10s} yardstick: the backward alone of that call "
                  f"{'none' if lib is None else f'{lib:.4f} ms, {lib_dev:.4f} ms on the device'}")
        record("K16", tag, err, ms, plain_ms, 10 * score_ops,
               7 * tensor + extra + H * l * l * 4, lib)
        if route is not None or dname == "bf16":
            on_device("K16", lambda: fa.flash_attention_bias_bwd(*args), "bias_bwd")
        if not tag and dname == "bf16":
            rows["K16"]["library_device_ms"] = lib_dev
        del q, k_, v, g, args
        torch.cuda.empty_cache()


def phase_slice(seed, card):
    import numpy as np
    import torch
    from radzero_torch.data.tokenizer import WhitespaceHashTokenizer
    from radzero_torch.eval.serving import ServingEngine
    from radzero_torch.models.configuration import (
        AlignConfig, LossConfig, RadZeroConfig, TextConfig, ViTConfig,
    )
    from radzero_torch.models.radzero import compute_logits, init_radzero
    from radzero_torch.ops.layers import normalize_pixels

    cfg = RadZeroConfig(vision=ViTConfig(), text=TextConfig(), align=AlignConfig(),
                        loss=LossConfig())
    # the reference path: eager layers, eager VL-CABS and the eager MPNet chain
    cfg_eager = dataclasses.replace(cfg, text=TextConfig(fuse_post=False))
    n_layers = cfg.vision.num_hidden_layers + cfg.align.num_hidden_layers
    t0 = time.perf_counter()
    params = init_radzero(torch.Generator(device="cuda").manual_seed(seed), cfg)
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"slice: full-width RadZero, {n_params / 1e6:.1f} M parameters from seed {seed} "
          f"({time.perf_counter() - t0:.2f} s), {n_layers} DINOv2-style layers")

    tok = WhitespaceHashTokenizer(vocab_size=cfg.text.vocab_size, max_length=64)
    prompts = [f"There is {c}" for c in CHEXPERT]
    engine = ServingEngine(params, cfg, tok, device="cuda", max_batch=8, channels=1,
                           max_delay_ms=20.0)
    try:
        engine.register_prompt_set("chexpert", prompts)
        t0 = time.perf_counter()
        engine.warmup()
        print(f"  warmup batch of 8: {time.perf_counter() - t0:.3f} s")

        rng = np.random.default_rng(seed)
        images = rng.integers(0, 256, (20, 518, 518), dtype=np.uint8)
        want = ["patch" if i % 2 == 0 else "none" for i in range(20)]

        def burst():
            """Submit the 20 requests at once -> (answers, sorted latencies ms)."""
            done, answered = [0.0] * 20, threading.Semaphore(0)

            def on_done(_f, i):
                done[i] = time.perf_counter()
                answered.release()

            t_sub = time.perf_counter()
            futs = []
            for i in range(20):
                futs.append(engine.submit(images[i], "chexpert", want_maps=want[i]))
                futs[-1].add_done_callback(lambda f, i=i: on_done(f, i))
            if not all(answered.acquire(timeout=600) for _ in range(20)):
                fail("requests not answered within 600 s")
            return [f.result() for f in futs], sorted((d - t_sub) * 1e3 for d in done)

        reset_counters()
        engine.batch_sizes.clear()
        results, lat = burst()
        launches = read_counters()
        batches = list(engine.batch_sizes)
        # the same burst again on the warm engine: the spread of the metric
        repeats = [burst()[1] for _ in range(5)]
        idle = device_idle(burst)
    finally:
        engine.close()

    for i, r in enumerate(results):
        p = r["probs"]
        if p.shape != (N,) or not np.all(np.isfinite(p)) or not np.all((p > 0) & (p < 1)):
            fail(f"request {i}: probs {p}")
        m = r["similarity_maps"]
        if want[i] == "patch" and (m is None or m.shape != (N, 37, 37) or not np.all(np.isfinite(m))):
            fail(f"request {i}: maps {None if m is None else m.shape}")
        if want[i] == "none" and m is not None:
            fail(f"request {i}: maps returned though none were asked for")
    nb = len(batches)
    # per batch: 14 DINOv2-style layers, one text-tower forward of 12 MPNet
    # layers (K4 once per layer), one VL-CABS; no training kernel
    expect = expected(fused_preattn=n_layers * nb, flash_attention_packed=n_layers * nb,
                      fused_postattn=n_layers * nb,
                      fused_mpnet_post=cfg.text.num_hidden_layers * nb, vlcabs_fused=nb)
    print(f"  20 requests answered in batches {batches}; launches {launches}")
    if batches != [8, 8, 4] or launches != expect:
        fail(f"expected batches [8, 8, 4] and launches {expect}")

    def stats(lat):  # -> requests/s, p50, p99 of one burst
        return (20e3 / lat[-1], lat[len(lat) // 2],
                lat[min(len(lat) - 1, math.ceil(0.99 * len(lat)) - 1)])

    rps, p50, p99 = stats(lat)
    print(f"  serving: {rps:.3f} requests/s, latency p50 {p50:.1f} ms p99 {p99:.1f} ms "
          f"(20 requests submitted at once, max_batch 8, bf16, fuse_post=True) on {card}")
    rep = [stats(r) for r in repeats]
    med = [sorted(col)[len(col) // 2] for col in zip(*rep)]
    print(f"  serving, the burst 5 times more: requests/s {[round(r[0], 1) for r in rep]}; "
          f"median {med[0]:.3f} requests/s, p50 {med[1]:.1f} ms, p99 {med[2]:.1f} ms")
    if idle is None:
        print("  serving, one more burst under torch.profiler: no device kernel recorded")
    else:
        print(f"  serving, one more burst under torch.profiler: the card busy {idle[0]:.2f} of "
              f"{idle[1]:.2f} ms, idle share {100 * (1 - idle[0] / idle[1]):.1f}% (the "
              f"profiler's own cost on the host included)")

    # the kernel path against the eager reference path on the first batch
    ids, mask = (torch.as_tensor(a, dtype=torch.long, device="cuda") for a in tok(prompts))
    u8 = torch.as_tensor(images[:8, :, :, None], device="cuda").expand(8, 518, 518, 3)
    probs = np.stack([r["probs"] for r in results[:8]])
    with torch.inference_mode():
        for dtype, pv_n, ptree in ((torch.bfloat16, 8, engine.params), (torch.float32, 2, params)):
            pv = normalize_pixels(u8[:pv_n], engine.image_spec.mean, engine.image_spec.std,
                                  dtype=dtype)
            kern = compute_logits(ptree, cfg, pv, ids, mask, dtype=dtype)
            ref = compute_logits(ptree, cfg_eager, pv, ids, mask, dtype=dtype, eager=True)
            lk, lr = kern["logits"].float(), ref["logits"].float()
            sk, sr = kern["similarity_scores"].float(), ref["similarity_scores"].float()
            lerr = (lk - lr).abs().max().item()
            mae = (sk - sr).abs().mean().item()
            name = "bf16" if dtype == torch.bfloat16 else "fp32"
            print(f"  kernel path vs eager path, {name}, {pv_n} images: logits max_abs_err "
                  f"{lerr:.3e} (|logit| <= {lr.abs().max().item():.3f}), map MAE {mae:.3e}, "
                  f"map max_abs_err {(sk - sr).abs().max().item():.3e}")
            if dtype == torch.bfloat16:
                same = np.abs(probs - torch.sigmoid(lk).cpu().numpy()).max()
                print(f"  engine probs vs sigmoid(kernel-path logits): max_abs_err {same:.3e}")
                # bf16: the eager path rounds at more points (o-proj, fc1,
                # residual adds, MPNet's LayerNorm inputs) than the fused
                # kernels, across 14 + 12 layers
                if same > 1e-5 or lerr > 0.25 or mae > 0.05:
                    fail("bf16 slice disagrees with the eager path or the engine output")
            else:
                # the repo's compute_logits gate (tests/test_radzero_model.py)
                close = torch.allclose(lk, lr, rtol=1e-3, atol=2e-4)
                if not close or mae >= 1e-3:
                    fail("fp32 slice disagrees with the eager path")
    return launches, params


# the card's host has no libjpeg headers (/usr/include/jpeglib.h), so the native
# decoder (native/preproc.cpp) cannot be built there: the server phase decodes
# with PIL, chosen here and printed (ROADMAP.md); the CPU tests hold the native path
SERVER_BACKEND = "pil"
CXR_HW = (3000, 2500)                 # (height, width) of a CXR-archive study


def cxr_jpegs(seed, n):
    """``n`` grayscale JPEGs at CXR-archive sizes (about 3000 x 2500, quality 95):
    a smooth random field with pixel noise, from ``seed``."""
    import io

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h, w = CXR_HW[0] - 8 * i, CXR_HW[1] + 8 * i
        low = Image.fromarray(rng.integers(0, 256, (48, 40), dtype=np.uint8), "L")
        arr = np.asarray(low.resize((w, h), Image.Resampling.BICUBIC), np.int16)
        arr = np.clip(arr + rng.integers(-6, 7, (h, w), dtype=np.int16), 0, 255)
        buf = io.BytesIO()
        Image.fromarray(arr.astype(np.uint8), "L").save(buf, "JPEG", quality=95)
        out.append(buf.getvalue())
    return out


def host_decode_ms(jpegs, size):
    """Host ms an image of the serving decode -> grey -> bicubic resize to
    ``size``, one thread: PIL (the engine's "pil" path) and the native
    library where it is built -> (pil_ms, native_ms or None, why not)."""
    import io

    import numpy as np
    from PIL import Image
    from radzero_torch.data import native

    def pil(data):
        im = Image.open(io.BytesIO(data)).convert("L")
        return np.asarray(im.resize((size, size), Image.Resampling.BICUBIC), np.uint8)

    def ms(fn):
        fn(jpegs[0])
        t0 = time.perf_counter()
        for data in jpegs:
            fn(data)
        return (time.perf_counter() - t0) / len(jpegs) * 1e3

    if not native.available():
        why = (native.build_log.strip().splitlines() or ["no compiler"])[0]
        return ms(pil), None, why[:160]
    return ms(pil), ms(lambda d: native.decode_resize_gray_u8(d, size, size)), ""


def burst_stats(lat, n):  # -> requests/s, p50, p99 of one burst of n
    return (n * 1e3 / lat[-1], lat[len(lat) // 2],
            lat[min(len(lat) - 1, math.ceil(0.99 * len(lat)) - 1)])


def phase_server(seed, card, params):
    """4a: EngineServer on 127.0.0.1 over ServingEngine(max_batch=8, channels=1,
    host_backend=SERVER_BACKEND); 16 client threads post 16 CXR-size grayscale
    JPEGs at once. Every answer must be the engine's own Future result for the
    same bytes, bit for bit; returns the launches of the first HTTP burst."""
    import concurrent.futures as cf
    import io
    import urllib.request

    import numpy as np
    from PIL import Image
    from radzero_torch.data.tokenizer import WhitespaceHashTokenizer
    from radzero_torch.eval.server import EngineServer
    from radzero_torch.eval.serving import ServingEngine
    from radzero_torch.models.configuration import RadZeroConfig

    cfg = RadZeroConfig()
    n_layers = cfg.vision.num_hidden_layers + cfg.align.num_hidden_layers
    tok = WhitespaceHashTokenizer(vocab_size=cfg.text.vocab_size, max_length=64)
    prompts = [f"There is {c}" for c in CHEXPERT]
    print(f"server: host_backend={SERVER_BACKEND!r} (chosen: this card's host has no libjpeg "
          "headers, /usr/include/jpeglib.h, so the native decoder is not built here)")
    t0 = time.perf_counter()
    jpegs = cxr_jpegs(seed + 5, 16)
    rng = np.random.default_rng(seed + 6)
    buf = io.BytesIO()  # one smaller study for maps=full (a 14 x 3000 x 2500 map is ~1.5 GB of JSON)
    Image.fromarray(rng.integers(0, 256, (320, 256), dtype=np.uint8), "L").save(buf, "JPEG",
                                                                              quality=95)
    small = buf.getvalue()
    print(f"  16 grayscale JPEGs of about {CXR_HW[0]} x {CXR_HW[1]}, quality 95, "
          f"{sum(map(len, jpegs)) / 16 / 2**20:.2f} MiB each on average, made in "
          f"{time.perf_counter() - t0:.2f} s from seed {seed + 5}")
    pil_ms, native_ms, why = host_decode_ms(jpegs, cfg.vision.img_size)
    print(f"  host decode -> grey -> resize to 518, one thread: PIL {pil_ms:.2f} ms an image; "
          + (f"native {native_ms:.2f} ms an image" if native_ms is not None
             else f"native not available on this host ({why})") + f" on {card}")

    want = ["patch" if i % 2 == 0 else "none" for i in range(16)]
    engine = ServingEngine(params, cfg, tok, device="cuda", max_batch=8, channels=1,
                           max_delay_ms=2000.0, host_backend=SERVER_BACKEND)
    try:
        with EngineServer(engine, {"chexpert": prompts}) as server:
            engine.warmup()
            base = f"http://127.0.0.1:{server.start(host='127.0.0.1')}"

            def get(path):
                with urllib.request.urlopen(base + path, timeout=60) as resp:
                    return json.loads(resp.read())

            def post(data, maps):
                req = urllib.request.Request(
                    f"{base}/predict?prompt_set=chexpert&maps={maps}", data=data,
                    headers={"Content-Type": "image/jpeg"})
                with urllib.request.urlopen(req, timeout=600) as resp:
                    return json.loads(resp.read())

            health, sets = get("/healthz"), get("/prompt_sets")
            if health != {"status": "ok", "prompt_sets": ["chexpert"]} or sets != {
                    "chexpert": prompts}:
                fail(f"server: /healthz {health}, /prompt_sets {sets}")
            # the engine's own answers for the same bytes: one burst, batches [8, 8]
            engine.batch_sizes.clear()
            futs = [engine.submit(j, "chexpert", want_maps=w) for j, w in zip(jpegs, want)]
            direct = [f.result(timeout=600) for f in futs]
            if engine.batch_sizes != [8, 8]:
                fail(f"server: the direct burst ran batches {engine.batch_sizes}, not [8, 8]")

            def burst():
                """16 client threads post at once -> (answers, sorted latencies ms)."""
                gate = threading.Barrier(17)

                def client(i):
                    gate.wait()
                    out = post(jpegs[i], want[i])
                    return out, time.perf_counter()

                with cf.ThreadPoolExecutor(16) as pool:
                    futs = [pool.submit(client, i) for i in range(16)]
                    gate.wait()
                    t_go = time.perf_counter()
                    res = [f.result(timeout=600) for f in futs]
                return [r[0] for r in res], sorted((r[1] - t_go) * 1e3 for r in res)

            engine.batch_sizes.clear()
            reset_counters()
            answers, lat = burst()
            launches = read_counters()
            batches = list(engine.batch_sizes)
            repeats = [burst()[1] for _ in range(4)]
            full = post(small, "full")
            full_direct = engine.submit(small, "chexpert", want_maps="full").result(timeout=600)
    finally:
        engine.close()

    if batches != [8, 8]:
        fail(f"server: the HTTP burst ran batches {batches}, not [8, 8]")
    for i, (a, d) in enumerate(zip(answers, direct)):
        if a["prompts"] != prompts or not np.array_equal(np.asarray(a["probs"], np.float32),
                                                         d["probs"]):
            fail(f"server: request {i}: HTTP probs differ from the engine's Future")
        if (a["similarity_maps"] is None) != (d["similarity_maps"] is None) or (
                d["similarity_maps"] is not None and not np.array_equal(
                    np.asarray(a["similarity_maps"], np.float32), d["similarity_maps"])):
            fail(f"server: request {i}: HTTP maps differ from the engine's Future")
        if want[i] == "patch" and d["similarity_maps"].shape != (N, 37, 37):
            fail(f"server: request {i}: maps {d['similarity_maps'].shape}")
    full_maps = np.asarray(full["similarity_maps"], np.float32)
    if full_maps.shape != (N, 320, 256) or not np.array_equal(full_maps,
                                                              full_direct["similarity_maps"]):
        fail(f"server: maps=full {full_maps.shape} against the JPEG's 320 x 256, or not the "
             "engine's Future")
    expect = expected(fused_preattn=n_layers * 2, flash_attention_packed=n_layers * 2,
                      fused_postattn=n_layers * 2,
                      fused_mpnet_post=cfg.text.num_hidden_layers * 2, vlcabs_fused=2)
    print(f"  16 HTTP requests answered in batches {batches}, each bit-equal to the engine's "
          f"Future for the same bytes; maps=full {full_maps.shape} on a 320 x 256 JPEG; "
          f"launches {launches}")
    if launches != expect:
        fail(f"server: expected launches {expect}")
    rps, p50, p99 = burst_stats(lat, 16)
    print(f"  HTTP: {rps:.3f} requests/s, latency p50 {p50:.1f} ms p99 {p99:.1f} ms (16 clients "
          f"at once, {SERVER_BACKEND} decode of {CXR_HW[0]} x {CXR_HW[1]} JPEGs, max_batch 8, "
          f"bf16) on {card}")
    rep = [burst_stats(r, 16) for r in repeats]
    print(f"  HTTP, the burst 4 times more: requests/s {[round(r[0], 2) for r in rep]}, p50 ms "
          f"{[round(r[1], 1) for r in rep]}, p99 ms {[round(r[2], 1) for r in rep]}")
    return launches


# run by phase_export in a fresh python3: imports radzero_torch and nothing of
# the exporting process; argv: start time, bundle dir, io dir, whether to serve
COLD_START = r'''
import json, sys, time
t_start, bundle, io_dir, serve = float(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4] == "1"
sys.path.insert(0, sys.argv[5])
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from radzero_torch.eval.export import load_zero_shot
from radzero_torch.ops import flash_attention as fa, fused_layer as fl, registry, vlcabs_fused as vf

WRAPPERS = (fl.fused_preattn, fl.flash_attention_packed, fl.fused_postattn, fl.fused_mpnet_post,
            vf.vlcabs_fused, fl.fused_preattn_bwd, fl.flash_attention_packed_bwd,
            fl.fused_postattn_bwd, fl.fused_mpnet_post_bwd, vf.vlcabs_train_forward,
            vf.vlcabs_train_bwd_dq, vf.vlcabs_train_bwd_dtn, fa.flash_attention,
            fa.flash_attention_bwd, fa.flash_attention_bias, fa.flash_attention_bias_bwd)
t0 = time.time()
runner, meta = load_zero_shot(bundle)
t_load = time.time() - t0
inp = torch.load(f"{io_dir}/inputs.pt")
pv, ids, mask = (inp[k].cuda() for k in ("pixels", "ids", "mask"))
for w in WRAPPERS:
    w.launches = 0
registry.reset_calls()
logits, scores = runner(pv, ids, mask)
logits, scores = logits.cpu(), scores.cpu()
t_first = time.time() - t_start
launches = {w.__name__: w.launches for w in WRAPPERS}
calls = dict(registry.calls)
torch.save({"logits": logits, "scores": scores}, f"{io_dir}/program.pt")
host_ms, wall_ms = [], []
for _ in range(10):  # the host's ms to enqueue one run and its wall ms, before any profiler session
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner(pv, ids, mask)
    host_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    wall_ms.append((time.perf_counter() - t0) * 1e3)


def at_depth(n, f):
    """f() under n more frames of ~25 words each: 100 of them span CPython's
    16 KiB data-stack chunk, so a sweep over 0-100 meets every place where a
    frame can land in its chunk"""
    a0 = a1 = a2 = a3 = a4 = a5 = a6 = a7 = a8 = a9 = n  # noqa: F841  the frame's size
    return f() if n == 0 else at_depth(n - 1, f)


def depth_ms(fn):
    fn(pv, ids, mask)
    ts = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(pv, ids, mask)
        ts.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return sorted(ts)[2]


depth = None
if serve:  # the runner, and the program as torch.export.load gives it, by the caller's depth
    as_loaded = torch.export.load(f"{bundle}/zero_shot.pt2").module()

    def loaded(*a):
        with torch.inference_mode():
            return as_loaded(*a)

    depth = {name: [at_depth(n, lambda: depth_ms(fn)) for n in range(101)]
             for name, fn in (("runner", runner), ("as_loaded", loaded))}
    del as_loaded
kernels = {}
for _ in range(3):  # a session now and then records no device kernel
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        runner(pv, ids, mask)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    device_ms = sorted(((e.key[:60], e.self_device_time_total / 1e3) for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA), key=lambda t: -t[1])
    if kernels:
        break
out = {"load_s": t_load, "cold_start_s": t_first, "launches": launches, "calls": calls,
       "kernels": kernels, "meta": meta, "host_ms": sorted(host_ms)[5],
       "wall_ms": sorted(wall_ms)[5], "host_all_ms": host_ms,
       "device_ms": device_ms[:8], "device_total_ms": sum(t for _, t in device_ms),
       "depth_ms": depth}
if serve:
    from radzero_torch.data.tokenizer import WhitespaceHashTokenizer
    from radzero_torch.eval.serving import ServingEngine
    images = inp["images"].numpy()
    tok = WhitespaceHashTokenizer(vocab_size=meta["vocab_size"], max_length=meta["max_tokens"])
    with ServingEngine.from_bundle(bundle, tok, max_delay_ms=2000.0, host_backend="pil") as eng:
        eng.register_prompt_set("chexpert", json.loads(sys.argv[6]))
        eng.warmup()
        eng.batch_sizes.clear()
        seconds, probs = [], None
        for _ in range(6):
            t0 = time.perf_counter()
            futs = [eng.submit(im, "chexpert") for im in images]
            res = [f.result(timeout=600) for f in futs]
            seconds.append(time.perf_counter() - t0)
            probs = probs if probs is not None else [r["probs"].tolist() for r in res]
        out.update(probs=probs, burst_s=seconds, batches=eng.batch_sizes[:2])
print("COLD_START " + json.dumps(out))
'''


def program_kernels_check(label, program, eager):
    """The device kernels of one program run (``program``, {name: launches})
    against one eager compute_logits (``eager``): every device kernel of K1-K5,
    K13 and K15 that the eager call runs (their ROUTES names in bf16; the
    launches themselves are the wrappers' counts, which a session of the
    profiler now and then undercounts), the same softmax launches (the
    attention twins' mark) and no upload from host memory. Other library
    kernels may differ (the graph lays out a few copies and the patch
    embedding's product otherwise); they are printed."""
    ours = [n for way in ("K1", "K3", "K4", "K5", "fwd") for n in ROUTES[way]["bf16"]]
    ours.append(SMALL_BIAS[0])
    for pat in ours:
        if any(pat in n for n in eager) and not any(pat in n for n in program):
            fail(f"export {label}: the program never ran {pat}; eager "
                 f"{ {n: c for n, c in eager.items() if pat in n} }")

    if any("Memcpy HtoD" in n for n in program):
        fail(f"export {label}: a program run uploads from host memory: "
             f"{[n for n in program if 'Memcpy HtoD' in n]}")

    def softmax(kernels):
        return sum(c for n, c in kernels.items() if "softmax" in n.lower())

    if softmax(program) != softmax(eager):
        fail(f"export {label}: softmax launches {softmax(program)} in the program, "
             f"{softmax(eager)} in the eager call")
    named = {pat: sum(c for n, c in program.items() if pat in n) for pat in ours}
    print(f"  {label}: torch.profiler, the program's kernels by name (launches a run) "
          f"{ {k[:32]: v for k, v in named.items() if v} }, softmax x{softmax(program)} as "
          f"the eager call's; {sum(program.values())} launches in all against "
          f"{sum(eager.values())}")
    for name in sorted(set(program) | set(eager)):
        if program.get(name, 0) != eager.get(name, 0):
            print(f"    other: program x{program.get(name, 0)}, eager x{eager.get(name, 0)}: "
                  f"{name[:140]}")


def stack_depth_check(ms, card):
    """The loaded program's host ms a run under 0-100 more frames of the
    caller's stack: load_zero_shot's runner (its forward starts a data-stack
    chunk of its own) must not depend on the depth; the program as
    torch.export.load gives it is printed beside it."""
    for name in ("runner", "as_loaded"):
        t = sorted(ms[name])
        slow = [n for n, v in enumerate(ms[name]) if v > 3 * t[50]]
        print(f"  {name}: host ms a run by the caller's stack depth 0-100: min {t[0]:.2f}, "
              f"median {t[50]:.2f}, max {t[-1]:.2f}; above 3 x the median at depths {slow} "
              f"on {card}")
        if name == "runner" and slow:
            fail(f"export: the runner's host time depends on the caller's stack depth: "
                 f"{[round(v, 1) for v in ms[name]]}")


def phase_export(seed, card, params, live_probs_fn):
    """4b: export_zero_shot at 8 x 14 x 64, from_uint8, channels=1, bf16, loaded
    by load_zero_shot in a fresh python3 (bit-equal to compute_logits, K1-K5 by
    name, the eager call's launch counts), ServingEngine.from_bundle there
    against the live engine; then the fused_tower=False / TextConfig(attn_impl=
    "flash") bundle (K13 and K15 from a program). Returns the launches of one
    program run of each bundle, summed."""
    import os
    import tempfile

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from radzero_torch.eval.export import export_zero_shot
    from radzero_torch.eval.serving import ImageSpec, serving_params
    from radzero_torch.models.configuration import RadZeroConfig, TextConfig
    from radzero_torch.models.radzero import compute_logits
    from radzero_torch.ops.layers import normalize_pixels

    prompts = [f"There is {c}" for c in CHEXPERT]
    rng = np.random.default_rng(seed + 7)
    images = rng.integers(0, 256, (16, 518, 518, 1), dtype=np.uint8)
    spec = ImageSpec()
    total = None
    bundles = (("default bundle (fused_tower=True)", RadZeroConfig(), True, True),
               ('flash bundle (fused_tower=False, TextConfig(attn_impl="flash"))',
                RadZeroConfig(text=TextConfig(attn_impl="flash")), False, False))
    for label, cfg, fused, serve in bundles:
        from radzero_torch.data.tokenizer import WhitespaceHashTokenizer

        tok = WhitespaceHashTokenizer(vocab_size=cfg.text.vocab_size, max_length=64)
        ids, mask = (torch.as_tensor(a, dtype=torch.long) for a in tok(prompts))
        print(f"export: {label}, depth {cfg.vision.num_hidden_layers} tower + "
              f"{cfg.align.num_hidden_layers} align + {cfg.text.num_hidden_layers} text layers, "
              "8 x 14 prompts x 64 tokens, from_uint8, channels=1, bf16")
        with tempfile.TemporaryDirectory() as tmp:
            bundle, io_dir = os.path.join(tmp, "bundle"), tmp
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            export_zero_shot(params, cfg, bundle, batch_size=8, n_prompts=N, max_tokens=64,
                             dtype=torch.bfloat16, from_uint8=True, channels=1,
                             fused_tower=fused, device="cuda")
            export_s = time.perf_counter() - t0
            nbytes = sum(os.path.getsize(os.path.join(bundle, f)) for f in os.listdir(bundle))
            torch.save({"pixels": torch.from_numpy(images[:8]), "ids": ids, "mask": mask,
                        "images": torch.from_numpy(images)}, os.path.join(io_dir, "inputs.pt"))
            t_start = time.time()
            proc = subprocess.run(
                [sys.executable, "-c", COLD_START, repr(t_start), bundle, io_dir,
                 "1" if serve else "0", str(REPO), json.dumps(prompts)],
                capture_output=True, text=True, timeout=300, cwd=str(REPO))
            lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("COLD_START ")]
            if proc.returncode != 0 or not lines:
                fail(f"export {label}: the fresh process failed ({proc.returncode}):\n"
                     f"{proc.stderr[-3000:]}")
            child = json.loads(lines[-1][len("COLD_START "):])
            program = torch.load(os.path.join(io_dir, "program.pt"))

        # the eager call on the same inputs and weights, in this process
        p = serving_params(params, cfg, torch.bfloat16, torch.device("cuda"), 518)
        pv8 = torch.from_numpy(images[:8]).cuda()
        dids, dmask = ids.cuda(), mask.cuda()

        def eager():
            with torch.inference_mode():
                pv = normalize_pixels(pv8.expand(8, 518, 518, 3), spec.mean, spec.std,
                                      dtype=torch.bfloat16)
                return compute_logits(p, cfg, pv, dids, dmask, dtype=torch.bfloat16,
                                      fused_towers=fused)

        reset_counters()
        ref = eager()
        eager_launches = read_counters()
        host_ms, wall_ms = [], []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eager()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            wall_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            eager()
            torch.cuda.synchronize()
        eager_kernels = {e.key: e.count for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA}
        eager_dev = sorted(((e.key[:60], e.self_device_time_total / 1e3)
                            for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                           key=lambda t: -t[1])
        print(f"  device ms of one run (torch.profiler): program {child['device_total_ms']:.2f} "
              f"{[(k, round(t, 2)) for k, t in child['device_ms']]}; eager "
              f"{sum(t for _, t in eager_dev):.2f} {[(k, round(t, 2)) for k, t in eager_dev[:8]]}")
        del p
        same = (torch.equal(program["logits"], ref["logits"].cpu())
                and torch.equal(program["scores"], ref["similarity_scores"].cpu()))
        err = (program["logits"].float() - ref["logits"].float().cpu()).abs().max().item()
        print(f"  export {export_s:.2f} s, bundle {nbytes / 2**20:.1f} MiB; fresh process: "
              f"load_zero_shot {child['load_s']:.2f} s, cold start to first answer "
              f"{child['cold_start_s']:.2f} s (process start, imports, load, kernels' library, "
              f"first run); logits and maps against compute_logits bf16: "
              f"{'bit-equal' if same else f'DIFFER (logits max_abs_err {err:.3e})'}")
        if not same:
            fail(f"export {label}: the loaded program is not bit-equal to compute_logits")
        print(f"  launches of one program run {child['launches']}; registry op calls "
              f"{child['calls']}")
        if child["launches"] != eager_launches:
            fail(f"export {label}: launches {child['launches']}, eager {eager_launches}")
        if any(child["calls"][k] != v for k, v in eager_launches.items() if k in child["calls"]):
            fail(f"export {label}: op calls {child['calls']} against launches {eager_launches}")
        if not child["kernels"] or not eager_kernels:
            fail(f"export {label}: torch.profiler recorded no device kernel")
        program_kernels_check(label.split(" (")[0], child["kernels"], eager_kernels)
        print(f"  the program's host ms a run, 10 runs: "
              f"{[round(t, 1) for t in child['host_all_ms']]}")
        if child["depth_ms"]:
            stack_depth_check(child["depth_ms"], card)
        print(f"  one run of 8 x 14, median of 10: the host enqueues the program in "
              f"{child['host_ms']:.2f} ms (wall {child['wall_ms']:.2f} ms), compute_logits in "
              f"{sorted(host_ms)[5]:.2f} ms (wall {sorted(wall_ms)[5]:.2f} ms) on {card}")
        if serve:
            live_probs, live_s = live_probs_fn(images)
            cold = np.asarray(child["probs"], np.float32)
            if child["batches"] != [8, 8] or not np.array_equal(cold, live_probs):
                fail(f"export: from_bundle probs (batches {child['batches']}) differ from the "
                     f"live engine's: max_abs_err {np.abs(cold - live_probs).max():.3e}")
            b_s, l_s = sorted(child["burst_s"])[3], sorted(live_s)[3]
            print(f"  ServingEngine.from_bundle: 16 requests in batches [8, 8] with the live "
                  f"engine's probabilities, bit for bit; warm {16 / b_s:.2f} requests/s against "
                  f"the live engine's {16 / l_s:.2f} (median of 6 bursts of 16 518 x 518 grey "
                  f"arrays each) on {card}")
        total = child["launches"] if total is None else {
            k: v + child["launches"][k] for k, v in total.items()}
    return total


def live_engine_probs(params, images):
    """The live engine's answers to ``images`` at the bundle's settings (max_batch 8,
    channels=1, bf16) and the seconds of 6 bursts of them."""
    import numpy as np
    from radzero_torch.data.tokenizer import WhitespaceHashTokenizer
    from radzero_torch.eval.serving import ServingEngine
    from radzero_torch.models.configuration import RadZeroConfig

    cfg = RadZeroConfig()
    tok = WhitespaceHashTokenizer(vocab_size=cfg.text.vocab_size, max_length=64)
    with ServingEngine(params, cfg, tok, device="cuda", max_batch=8, channels=1,
                       max_delay_ms=2000.0, host_backend="pil") as eng:
        eng.register_prompt_set("chexpert", [f"There is {c}" for c in CHEXPERT])
        eng.warmup()
        eng.batch_sizes.clear()
        seconds, probs = [], None
        for _ in range(6):
            t0 = time.perf_counter()
            res = [f.result(timeout=600) for f in
                   [eng.submit(im, "chexpert") for im in images]]
            seconds.append(time.perf_counter() - t0)
            probs = probs if probs is not None else np.stack([r["probs"] for r in res])
        if eng.batch_sizes[:2] != [8, 8]:
            fail(f"export: the live engine ran batches {eng.batch_sizes[:2]}, not [8, 8]")
    return probs, seconds


def phase_scorer(seed, card, params):
    """The attn_impl="flash" serving path through ZeroShotScorer and
    model_inference; returns the launches of the bf16 scoring run."""
    import tempfile

    import numpy as np
    import torch
    from PIL import Image
    from radzero_torch.data.processing import BlipStyleImageProcessor
    from radzero_torch.data.tokenizer import WhitespaceHashTokenizer
    from radzero_torch.eval.api import model_inference
    from radzero_torch.eval.scorer import ZeroShotScorer
    from radzero_torch.models.configuration import RadZeroConfig, TextConfig
    from radzero_torch.models.radzero import compute_logits

    cfg = RadZeroConfig(text=TextConfig(attn_impl="flash"))
    # the reference path: eager layers, eager attention and chain, eager VL-CABS
    cfg_eager = RadZeroConfig(text=TextConfig(fuse_post=False))
    tok = WhitespaceHashTokenizer(vocab_size=cfg.text.vocab_size, max_length=64)
    proc = BlipStyleImageProcessor(size=cfg.vision.img_size)
    prompts = [f"There is {c}" for c in CHEXPERT]
    rng = np.random.default_rng(seed + 3)
    # 16 grayscale studies at other sizes than the model's: the host resize does real work
    images = [rng.integers(0, 256, (640 + 16 * i, 600), dtype=np.uint8) for i in range(16)]
    n_tower, n_align = cfg.vision.num_hidden_layers, cfg.align.num_hidden_layers
    n_text = cfg.text.num_hidden_layers

    def load(im):
        return im

    print('scorer: ZeroShotScorer(fused_tower=False), ViTConfig.attn_impl="flash", '
          'TextConfig(attn_impl="flash"), 16 images at batch 8 x 14 prompts with maps')
    scorer = ZeroShotScorer(params, cfg, proc, tok, batch_size=8, dtype=torch.bfloat16,
                            fused_tower=False)
    scorer.score(images[:8], load, prompts, need_scores=True)  # warm: allocators, cuBLAS
    runs = []
    for _ in range(3):
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, maps = scorer.score(images, load, prompts, need_scores=True)
        runs.append(time.perf_counter() - t0)
        launches = read_counters()
    n_patches = (cfg.vision.img_size // cfg.vision.patch_size) ** 2
    if logits.shape != (16, N) or maps.shape != (16, N, n_patches):
        fail(f"scorer: shapes {logits.shape}, {maps.shape}")
    if not (np.isfinite(logits).all() and np.isfinite(maps).all()):
        fail("scorer: non-finite logits or maps")
    nb = 2
    expect = expected(flash_attention=n_tower * nb, fused_preattn=n_align * nb,
                      flash_attention_packed=n_align * nb, fused_postattn=n_align * nb,
                      flash_attention_bias=n_text * nb, fused_mpnet_post=n_text * nb,
                      vlcabs_fused=nb)
    print(f"  launches of one run (2 batches) {launches}")
    if launches != expect:
        fail(f"scorer: expected launches {expect}")
    # the card's share of a batch: the flash path and the fused K1-K3 path in turns
    pv = torch.as_tensor(proc(images[:8])["pixel_values"]).to("cuda", torch.bfloat16)
    ids, mask = scorer.encode_prompts(prompts)
    with torch.inference_mode():
        device_ms = [median_ms(lambda: compute_logits(scorer.params, cfg, pv, ids, mask,
                                                      dtype=torch.bfloat16, fused_towers=fused),
                               reps=10) for fused in (False, True, True, False)]
    print(f"  one batch of 8 x 14 on the card: {device_ms[0]:.2f} / {device_ms[3]:.2f} ms with "
          f"fused_towers=False (K13, cuBLAS products), {device_ms[1]:.2f} / {device_ms[2]:.2f} "
          f"ms with fused_towers=True (K1-K3)")
    del pv
    med = sorted(runs)[1]
    print(f"  scorer: {16 / med:.2f} images/s, median {med:.4f} s of 3 runs of 16 images "
          f"({[round(r, 4) for r in runs]} s; bf16, batch 8, host resize on 8 threads) on {card}")
    scorer_host_stages(scorer, proc, images, prompts, med / 2, device_ms[0], card)
    del scorer

    # fp32 (the scorer turns TF32 off itself) against the eager path, the repo's gate
    scorer = ZeroShotScorer(params, cfg, proc, tok, batch_size=2, dtype=torch.float32,
                            fused_tower=False)
    logits, maps = scorer.score(images[:2], load, prompts, need_scores=True)
    pv = torch.as_tensor(proc(images[:2])["pixel_values"], device="cuda")
    ids, mask = (torch.as_tensor(a, dtype=torch.long, device="cuda") for a in tok(prompts))
    with torch.inference_mode():
        ref = compute_logits(params, cfg_eager, pv, ids, mask, dtype=torch.float32, eager=True)
    lr, sr = ref["logits"].cpu(), ref["similarity_scores"].cpu()
    lk, sk = torch.from_numpy(logits), torch.from_numpy(maps)
    mae = (sk - sr).abs().mean().item()
    print(f"  scorer vs eager path, fp32, 2 images: logits max_abs_err "
          f"{(lk - lr).abs().max().item():.3e} (|logit| <= {lr.abs().max().item():.3f}), map MAE "
          f"{mae:.3e}, map max_abs_err {(sk - sr).abs().max().item():.3e}")
    if not torch.allclose(lk, lr, rtol=1e-3, atol=2e-4) or mae >= 1e-3:
        fail("scorer: the fp32 flash path disagrees with the eager path")
    del scorer

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "study.png")
        Image.fromarray(images[0]).save(path)  # one 8-bit grayscale PNG
        t0 = time.perf_counter()
        prob, smap = model_inference(path, prompts[:3], tok, proc, (params, cfg))
        seconds = time.perf_counter() - t0
    h, w = images[0].shape[:2]
    if prob.shape != (3,) or smap.shape != (3, h, w):
        fail(f"model_inference: shapes {prob.shape}, {smap.shape}")
    if not (np.all((prob > 0) & (prob < 1)) and np.all((smap >= 0) & (smap <= 1))):
        fail("model_inference: probabilities or maps outside [0, 1]")
    close = np.abs(prob - 1.0 / (1.0 + np.exp(-logits[0, :3]))).max()
    print(f"  model_inference on one {w} x {h} PNG, 3 texts, fp32: probs {np.round(prob, 4)}, "
          f"map {smap.shape}, {seconds:.3f} s; against the scorer's logits {close:.3e}")
    if close > 1e-4:
        fail("model_inference disagrees with the scorer on the same image")
    return launches


EVAL_N = 32                       # studies a dataset, one scorer batch (64 doubles the phase)
EVAL_CLS = ["OpenI", "PadChest", "ChestXray14", "Chexpert", "ChestXDet10"]
EVAL_DET = ["ChestXDet10", "MS-CXR"]
EVAL_SEG = ["SIIM", "RSNA"]


def host_packages():
    """Whether pandas, scikit-learn and PyYAML import on this host (the JAX
    CLI reads them; the port's harness needs none), tried in a child process
    so that this one never loads them."""
    code = ("import importlib\n"
            "for m in ('pandas', 'sklearn', 'yaml'):\n"
            "    try:\n"
            "        print(m, getattr(importlib.import_module(m), '__version__', 'yes'))\n"
            "    except Exception as e:\n"
            "        print(m, 'no (' + type(e).__name__ + ')')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120).stdout.split("\n")
    return ", ".join(line for line in out if line)


class _Timers:
    """Seconds spent in wrapped functions, by name; ``main_only``: on the
    main thread only (the scorer's loader threads also open images)."""

    def __init__(self):
        self.s = {}
        self.patched = []

    def timed(self, fn, key, main_only=False):
        def timed(*a, **kw):
            if main_only and threading.current_thread() is not threading.main_thread():
                return fn(*a, **kw)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.s[key] = self.s.get(key, 0.0) + time.perf_counter() - t0
        return timed

    def wrap(self, owner, name, key, main_only=False):
        self.patched.append((owner, name, getattr(owner, name)))
        setattr(owner, name, self.timed(getattr(owner, name), key, main_only))

    def restore(self):
        for owner, name, fn in reversed(self.patched):
            setattr(owner, name, fn)
        self.patched = []


def run_eval_suite(scorer, root, out_dir, upsample_log):
    """Inference over every dataset on ``scorer``: (results, seconds by task
    and stage, logged errors); ``upsample_log`` gathers each upsample's
    (caller, scores, size, geometry, card output, seconds)."""
    import logging

    import numpy as np
    import torch
    from radzero_torch.eval import geometry, grounding, segmentation
    from radzero_torch.eval.inference import Inference
    from radzero_torch.eval.mergers import MERGERS

    timers = _Timers()
    upsample = geometry.upsample_similarity_map

    def recorder(caller):
        def recorded(scores, size, geometry_name="resize", *, device="cuda"):
            t0 = time.perf_counter()
            out = upsample(scores, size, geometry_name, device=device)
            seconds = time.perf_counter() - t0
            if torch.device(device).type != "cuda":
                fail(f"eval: an upsample ran on {device}, not on the scorer's card")
            upsample_log.append((caller, np.array(scores), tuple(size), geometry_name, out,
                                 seconds))
            timers.s["upsample"] = timers.s.get("upsample", 0.0) + seconds
            return out
        return recorded

    errors = []
    handler = logging.Handler(logging.ERROR)
    handler.emit = lambda record: errors.append(record.getMessage())
    log = logging.getLogger("radzero_torch")
    mergers = dict(MERGERS)
    for name, (rel, fn) in mergers.items():
        MERGERS[name] = (rel, timers.timed(fn, "metrics"))
    for mod in (geometry, segmentation):  # grounding_point calls geometry's
        timers.patched.append((mod, "upsample_similarity_map", upsample))
        mod.upsample_similarity_map = recorder(mod.__name__.rsplit(".", 1)[1])
    timers.wrap(scorer, "score", "score")
    timers.wrap(scorer, "score_paired", "score")
    timers.wrap(grounding, "grounding_point", "point")
    timers.wrap(segmentation, "_finish_metrics", "metrics")
    for mod in (grounding, segmentation):
        timers.wrap(mod, "load_eval_image", "probe", main_only=True)
    log.addHandler(handler)
    results, stages = {}, {}
    inf = Inference(EVAL_CLS, EVAL_DET, EVAL_SEG, root, batch_size=scorer.batch_size)
    try:
        for task in ("classification", "grounding", "segmentation"):
            timers.s.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results[task] = getattr(inf, task)(scorer, str(Path(out_dir) / task))
            torch.cuda.synchronize()
            stages[task] = dict(timers.s, total=time.perf_counter() - t0)
    finally:
        log.removeHandler(handler)
        timers.restore()
        MERGERS.update(mergers)
    return results, stages, errors


def _metric_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _metric_leaves(v, path + (k,))
    else:
        yield "/".join(path), tree


def phase_eval(seed, card, params):
    """The zero-shot eval harness through Inference on the card, as the JAX
    CLI's --inference branch runs it (fp32, batch 64); returns the launches
    of its first run."""
    import tempfile

    import numpy as np
    import torch
    from radzero_torch.data.processing import BlipStyleImageProcessor
    from radzero_torch.data.tokenizer import WhitespaceHashTokenizer
    from radzero_torch.eval import _table
    from radzero_torch.eval.classification import _image_loader
    from radzero_torch.eval.geometry import upsample_similarity_map
    from radzero_torch.eval.registry import get_infer_dirs
    from radzero_torch.eval.scorer import ZeroShotScorer
    from radzero_torch.models.configuration import RadZeroConfig, TextConfig
    from radzero_torch.models.radzero import compute_logits
    from radzero_torch.tools import synthetic_eval_data as sd

    t_phase = time.perf_counter()
    cfg = RadZeroConfig()
    cfg_eager = RadZeroConfig(text=TextConfig(fuse_post=False))
    tok = WhitespaceHashTokenizer(vocab_size=cfg.text.vocab_size, max_length=64)
    proc = BlipStyleImageProcessor(size=cfg.vision.img_size)
    scorer = ZeroShotScorer(params, cfg, proc, tok, device="cuda", batch_size=64,
                            dtype=torch.float32)
    with tempfile.TemporaryDirectory() as tmp:
        root = str(Path(tmp) / "data")
        t0 = time.perf_counter()
        sizes = sd.chest_sizes(EVAL_N, seed)
        sd.build_all(root, n=EVAL_N, seed=seed, sizes=sizes, siim_size=sd.SIIM_SIZE,
                     compress_level=1, threads=8)
        print(f"eval: Inference(cls={EVAL_CLS}, det={EVAL_DET}, seg={EVAL_SEG}) on "
              f"ZeroShotScorer(batch_size=64, fp32, fused towers), {EVAL_N} studies a "
              f"dataset: grayscale PNGs of {min(min(s) for s in sizes)}-"
              f"{max(max(s) for s in sizes)} px, SIIM 1024 x 1024 8-bit DICOMs; data "
              f"written in {time.perf_counter() - t0:.2f} s")
        runs = []
        for k in range(2):
            log = []
            reset_counters()
            results, stages, errors = run_eval_suite(scorer, root, Path(tmp) / f"run{k}", log)
            launches = read_counters()
            if k:
                log.clear()  # the first run's maps are checked below
            runs.append((results, stages, errors, launches, log))
            if errors:
                fail(f"eval: the harness logged errors: {errors}")
            bad = [t for t, r in results.items() if r is None]
            if bad:
                fail(f"eval: tasks returned None: {bad}")
        results, stages, _, launches, log = runs[0]
        n_text, n_tower = cfg.text.num_hidden_layers, cfg.vision.num_hidden_layers
        nb = len(EVAL_CLS) + len(EVAL_DET) + len(EVAL_SEG)  # one batch of 64 a dataset
        layers = n_tower + cfg.align.num_hidden_layers
        expect = expected(fused_preattn=layers * nb, flash_attention_packed=layers * nb,
                          fused_postattn=layers * nb, fused_mpnet_post=n_text * nb,
                          vlcabs_fused=nb)
        print(f"  launches of one suite ({nb} batches of {EVAL_N}): {launches}")
        for _, _, _, lc, _ in runs:
            if lc != expect:
                fail(f"eval: expected launches {expect}, got {lc}")

        # metrics: finite, in [0, 1]; MS-CXR's whole-image boxes point right
        for task, tree in results.items():
            for key, v in _metric_leaves(tree):
                if not (isinstance(v, float) and math.isfinite(v) and 0.0 <= v <= 1.0):
                    fail(f"eval: {task} {key} = {v!r}")
        if results["grounding"]["MS-CXR"] != 1.0:
            fail(f"eval: MS-CXR accuracy {results['grounding']['MS-CXR']} with boxes that "
                 "cover the images")
        print(f"  results: {json.dumps(results)}")
        out0, out1 = Path(tmp) / "run0", Path(tmp) / "run1"
        for task in results:
            a = (out0 / task / "result.json").read_bytes()
            if a != (out1 / task / "result.json").read_bytes():
                fail(f"eval: a second run wrote another {task}/result.json")
        csv_same = True
        prompts = {}
        for name in EVAL_CLS:
            text = json.loads(Path(get_infer_dirs(root)[name]["text_path"]).read_text())
            prompts[name] = [text[str(i)][0] for i in range(len(text))]
            table = _table.read_csv(str(out0 / "classification" / f"{name}.csv"))
            sims = table.values(table.columns)
            if sims.shape != (EVAL_N, len(prompts[name])) or not np.isfinite(sims).all():
                fail(f"eval: {name}.csv holds {sims.shape}, want ({EVAL_N}, "
                     f"{len(prompts[name])}) finite values")
            csv_same &= ((out0 / "classification" / f"{name}.csv").read_bytes()
                         == (out1 / "classification" / f"{name}.csv").read_bytes())
        print(f"  the second run's result.json files are byte-identical; its similarity "
              f"CSVs {'too' if csv_same else 'NOT'}")

        # time by task and stage, both runs
        n_img = {"classification": EVAL_N * len(EVAL_CLS),
                 "grounding": EVAL_N * len(EVAL_DET), "segmentation": EVAL_N * len(EVAL_SEG)}
        for k, (_, st, _, _, _) in enumerate(runs):
            for task, t in st.items():
                score, probe = t.get("score", 0.0), t.get("probe", 0.0)
                up = t.get("upsample", 0.0)
                metrics = t.get("metrics", 0.0) + t.get("point", 0.0) - (
                    up if task == "grounding" else 0.0)
                rest = t["total"] - score - probe - up - metrics
                print(f"  run {k + 1} {task}: {t['total']:.3f} s, {n_img[task]} images, "
                      f"{n_img[task] / t['total']:.2f} images/s; scorer.score "
                      f"{score:.3f} s; outside it {t['total'] - score:.3f} s "
                      f"({100 * (1 - score / t['total']):.1f}%): size probing "
                      f"{probe:.3f}, upsample + readback {up:.3f}, metrics {metrics:.3f}, "
                      f"the rest (tables, masks, sigmoid, files) {rest:.3f} on {card}")

        # the kernel path against the eager path, fp32, on Chexpert's images
        items = _table.read_csv(get_infer_dirs(root)["Chexpert"]["image_path"])["Path"].tolist()
        logits = _table.read_csv(str(out0 / "classification" / "Chexpert.csv"))
        logits = torch.from_numpy(logits.values(logits.columns).astype(np.float32))
        _, maps = scorer.score(items, _image_loader(root), prompts["Chexpert"],
                               need_scores=True)
        ids, mask = (torch.as_tensor(a, dtype=torch.long, device="cuda")
                     for a in tok(prompts["Chexpert"]))
        load = _image_loader(root)
        pv = torch.as_tensor(np.stack([proc(load(it))["pixel_values"][0] for it in items]),
                             device="cuda")
        ref_l, ref_s = [], []
        with torch.inference_mode():
            for start in range(0, len(items), 16):
                ref = compute_logits(params, cfg_eager, pv[start:start + 16], ids, mask,
                                     dtype=torch.float32, eager=True)
                ref_l.append(ref["logits"].cpu())
                ref_s.append(ref["similarity_scores"].cpu())
            card_ms = median_ms(lambda: compute_logits(scorer.params, cfg, pv, ids, mask,
                                                       dtype=torch.float32), reps=3, warmup=1)
        del pv
        print(f"  the card's time for one batch of {len(items)} x {len(ids)} prompts, fp32 "
              f"(K1-K5, CUDA events): {card_ms:.1f} ms on {card}")
        lr, sr, sk = torch.cat(ref_l), torch.cat(ref_s), torch.from_numpy(maps)
        mae = (sk - sr).abs().mean().item()
        print(f"  Chexpert.csv against compute_logits(eager=True), fp32, {len(items)} "
              f"images: logits max_abs_err {(logits - lr).abs().max().item():.3e} "
              f"(|logit| <= {lr.abs().max().item():.3f}), map MAE {mae:.3e}")
        if not torch.allclose(logits, lr, rtol=1e-3, atol=2e-4) or mae >= 1e-3:
            fail("eval: the harness's similarities disagree with the eager path")

        # every map the first run upsampled on the card, against the CPU
        worst, near_ties, n_points, card_s, cpu_s = 0.0, 0, 0, [], []
        for caller, scores, size, geometry_name, out, seconds in log:
            t0 = time.perf_counter()
            cpu = upsample_similarity_map(scores, size, geometry_name, device="cpu")
            cpu_s.append(time.perf_counter() - t0)
            card_s.append(seconds)
            worst = max(worst, float(np.abs(out - cpu).max()))
            if caller == "geometry":  # through grounding_point
                n_points += 1
                i_card, i_cpu = int(np.argmax(out)), int(np.argmax(cpu))
                if i_card != i_cpu:
                    if cpu.ravel()[i_cpu] - cpu.ravel()[i_card] > 1e-5:
                        fail(f"eval: a grounding point moved by more than a near-tie "
                             f"({size})")
                    near_ties += 1
        pixels = sum(int(np.prod(entry[2])) for entry in log)
        print(f"  upsample: {len(log)} maps ({pixels / 1e6:.1f} M pixels), card against "
              f"CPU max_abs_err {worst:.3e}; {n_points} grounding points, {near_ties} moved "
              f"within a near-tie (top two values within 1e-5); a map on the card "
              f"{1e3 * sorted(card_s)[len(card_s) // 2]:.2f} ms median "
              f"(readback included), on the CPU {1e3 * sorted(cpu_s)[len(cpu_s) // 2]:.2f} "
              f"ms median ({torch.get_num_threads()} threads) on {card}")
        if worst > 1e-5:
            fail("eval: the card's upsample disagrees with the CPU's")
        del runs, log
    del scorer
    for m in ("pandas", "sklearn"):
        if m in sys.modules:
            fail(f"eval: the harness imported {m}")
    print(f"  eval phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def scorer_host_stages(scorer, proc, images, prompts, batch_s, card_ms, card):
    """The host stages of one scorer batch of 8, each alone: the resize and
    normalise of an image on one thread (PIL, and use_native=True where the
    native library is built), the same for the batch on the scorer's 8
    threads, the pinned upload of its pixels, the readback of its logits and
    maps; beside the card's ms for the batch and the scorer's wall time a
    batch (``batch_s``). The scorer's images are decoded arrays: it decodes
    nothing (the server phase times the JPEG decode)."""
    import concurrent.futures as cf

    import numpy as np
    import torch
    from radzero_torch.data import native
    from radzero_torch.data.processing import BlipStyleImageProcessor

    def per_image_ms(p):
        p(images[0])
        t0 = time.perf_counter()
        for im in images:
            p(im)
        return (time.perf_counter() - t0) / len(images) * 1e3

    def median_s(fn, reps=10):
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return sorted(times)[reps // 2]

    pil_ms = per_image_ms(proc)
    if native.available():
        fast = BlipStyleImageProcessor(size=proc.size, use_native=True)
        nat = f"use_native=True {per_image_ms(fast):.2f} ms an image"
    else:
        nat = "use_native=True not measured: the native library is not built on this host"
    with cf.ThreadPoolExecutor(scorer.num_threads) as pool:
        resize_s = median_s(lambda: np.stack(list(pool.map(
            lambda im: proc(im)["pixel_values"][0], images[:8]))), reps=5)
    pixels = np.stack([proc(im)["pixel_values"][0] for im in images[:8]])
    upload_s = median_s(lambda: scorer._upload(pixels))
    ids, mask = scorer.encode_prompts(prompts)
    with torch.inference_mode():
        out = scorer._run(pixels, ids, mask, True)[0]
    dev = [torch.empty(t.shape, device="cuda") for t in out]
    host = [torch.empty(t.shape, pin_memory=True) for t in out]

    def readback():
        for h, t in zip(host, dev):
            h.copy_(t, non_blocking=True)

    read_s = median_s(readback)
    stages = resize_s * 1e3 + upload_s * 1e3 + card_ms + read_s * 1e3
    print(f"  scorer host stages, one batch of 8 (fp32 pixels, 14 prompts, maps) on {card}: "
          f"resize + normalise an image on one thread: PIL {pil_ms:.2f} ms, {nat}; the batch "
          f"on {scorer.num_threads} threads {resize_s * 1e3:.2f} ms; pinned upload of "
          f"{pixels.nbytes / 2**20:.1f} MiB {upload_s * 1e3:.2f} ms; the card "
          f"{card_ms:.2f} ms; readback of {sum(h.numel() * 4 for h in host) / 2**10:.0f} KiB "
          f"{read_s * 1e3:.3f} ms; sum {stages:.2f} ms against {batch_s * 1e3:.2f} ms a batch "
          f"of the scorer's run (host share {100 * (1 - card_ms / (batch_s * 1e3)):.1f}%)")


def _counters():
    from radzero_torch.ops import flash_attention as fa
    from radzero_torch.ops import fused_layer as fl
    from radzero_torch.ops import vlcabs_fused as vf

    return (fl.fused_preattn, fl.flash_attention_packed, fl.fused_postattn, fl.fused_mpnet_post,
            vf.vlcabs_fused, fl.fused_preattn_bwd, fl.flash_attention_packed_bwd,
            fl.fused_postattn_bwd, fl.fused_mpnet_post_bwd, vf.vlcabs_train_forward,
            vf.vlcabs_train_bwd_dq, vf.vlcabs_train_bwd_dtn, fa.flash_attention,
            fa.flash_attention_bwd, fa.flash_attention_bias, fa.flash_attention_bias_bwd)


def reset_counters():
    for c in _counters():
        c.launches = 0


def read_counters():
    return {c.__name__: c.launches for c in _counters()}


def expected(**launches):
    """The launch counts a path must show: 0 for every kernel but those named."""
    return {c.__name__: 0 for c in _counters()} | launches


def train_batch(seed, n_images, n_sentences, vocab_size, pixel_dtype):
    """One seeded batch on the card: 518 x 518 images, n_sentences / n_images
    sentences each of 6..32 tokens in T_LEN slots (<s> ... </s>, pad 1)."""
    import numpy as np
    import torch
    from radzero_torch.eval.serving import ImageSpec
    from radzero_torch.ops.layers import normalize_pixels

    rng = np.random.default_rng(seed + 1)
    u8 = torch.as_tensor(rng.integers(0, 256, (n_images, 518, 518, 1), dtype=np.uint8),
                         device="cuda").expand(n_images, 518, 518, 3)
    ids = np.full((n_sentences, T_LEN), 1, np.int64)
    mask = np.zeros((n_sentences, T_LEN), np.int64)
    for i in range(n_sentences):
        k = int(rng.integers(6, T_LEN + 1))
        ids[i, :k] = rng.integers(3, vocab_size, k)
        ids[i, 0], ids[i, k - 1] = 0, 2
        mask[i, :k] = 1
    spec = ImageSpec()
    return {
        "pixel_values": normalize_pixels(u8, spec.mean, spec.std, dtype=pixel_dtype),
        "input_ids": torch.as_tensor(ids, device="cuda"),
        "attention_mask": torch.as_tensor(mask, device="cuda"),
        "group_map": torch.arange(n_images, device="cuda").repeat_interleave(
            n_sentences // n_images),
        "row_mask": torch.ones(n_sentences, device="cuda"),
    }


def phase_training(seed, card, params, profile):
    """AdamW steps at full width through make_train_step: 6 at the default
    configuration (every layer on its kernels), 3 at the eager-layer one, 3
    with attn_impl="flash"; returns the launches of one default step and of
    one flash step."""
    import torch
    from radzero_torch.models.configuration import (
        AlignConfig, LossConfig, RadZeroConfig, TextConfig, ViTConfig,
    )
    from radzero_torch.train.optim import build_optimizer, partition_params, tree_leaves
    from radzero_torch.train.step import make_train_step

    # the JAX package's own defaults: attn_impl="fused_vjp", fuse_post=True
    cfg = RadZeroConfig(vision=ViTConfig(), align=AlignConfig(), text=TextConfig(),
                        loss=LossConfig(train_impl="fused"))
    # eager align layers and eager MPNet chain under autograd, the loss on K10-K12
    cfg_eager_layers = dataclasses.replace(cfg, align=AlignConfig(attn_impl="xla"),
                                           text=TextConfig(fuse_post=False))
    cfg_flash = dataclasses.replace(cfg, align=AlignConfig(attn_impl="flash"),
                                    text=TextConfig(attn_impl="flash"))
    modules = ("align_transformer", "text_model", "loss_fns")
    n_images, n_sentences = TB, TN

    def run(c, steps, profile_it=False):
        # fresh fp32 masters each time: the step updates them in place
        trainable, frozen = partition_params(params, modules)
        trainable = _clone(trainable)
        opt, _ = build_optimizer(learning_rate=1e-4, warmup_steps=1, total_steps=6)
        state = opt.init(trainable)
        step = make_train_step(c, opt, dtype=torch.bfloat16)
        batch = train_batch(seed, n_images, n_sentences, c.text.vocab_size, torch.bfloat16)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        history, seconds, per_step = [], [], []
        for _ in range(steps):
            reset_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainable, state, losses = step(trainable, frozen, state, batch)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            per_step.append(read_counters())
            history.append({k: v.item() for k, v in losses.items()})
        peak = torch.cuda.max_memory_allocated()
        if profile_it:
            profile_step(lambda: step(trainable, frozen, state, batch))
        return history, seconds, per_step, peak

    def report(label, history, seconds, per_step, peak, expect):
        print(f"  {label}: peak memory {peak / 2**30:.2f} GiB")
        for i, (h, sec) in enumerate(zip(history, seconds)):
            print(f"    step {i}: loss {h['loss']:.5f}  grad_norm {h['grad_norm']:.4f}  {sec:.3f} s")
        print(f"    launches per step {per_step[-1]}")
        if any(c != expect for c in per_step):
            fail(f"{label}: expected launches per step {expect}, got {per_step}")
        for h in history:
            if not all(math.isfinite(v) for v in h.values()) or h["grad_norm"] <= 0.0:
                fail(f"{label}: non-finite loss or a dead gradient: {h}")
        warm = sorted(seconds[1:])
        med = warm[len(warm) // 2]
        print(f"    {n_images / med:.2f} images/s ({n_sentences / med:.1f} sentences/s), median "
              f"step {med:.4f} s of steps 1-{len(seconds) - 1} (step 0 {seconds[0]:.3f} s) "
              f"on {card}")
        return med

    n_train = sum(t.numel() for t in tree_leaves(partition_params(params, modules)[0]))
    print(f"training: {n_images} images x {n_sentences} sentences x {T_LEN} tokens, bf16 compute, "
          f"fp32 masters, {n_train / 1e6:.1f} M trainable parameters (align, text, loss; tower "
          f"frozen), lr 1e-4 after 1 warmup step")
    n_tower, n_align = cfg.vision.num_hidden_layers, cfg.align.num_hidden_layers
    n_text = cfg.text.num_hidden_layers
    loss_kernels = {"vlcabs_train_forward": 1, "vlcabs_train_bwd_dq": 1,
                    "vlcabs_train_bwd_dtn": 1}
    expect = expected(fused_preattn=n_tower + n_align, flash_attention_packed=n_tower + n_align,
                      fused_postattn=n_tower + n_align, fused_mpnet_post=n_text,
                      fused_preattn_bwd=n_align, flash_attention_packed_bwd=n_align,
                      fused_postattn_bwd=n_align, fused_mpnet_post_bwd=n_text, **loss_kernels)
    history, seconds, per_step, peak = run(cfg, 6, profile_it=profile)
    med = report('defaults (attn_impl="fused_vjp", fuse_post=True: K1-K4, K6-K12)', history,
                 seconds, per_step, peak, expect)
    if not history[-1]["loss"] < history[1]["loss"]:
        fail(f"training: loss did not fall: {[h['loss'] for h in history]}")
    training = per_step[-1]

    expect_eager = expected(fused_preattn=n_tower, flash_attention_packed=n_tower,
                            fused_postattn=n_tower, **loss_kernels)
    h2, s2, p2, peak2 = run(cfg_eager_layers, 3)
    med2 = report('eager layers (attn_impl="xla", fuse_post=False: K1-K3, K10-K12)', h2, s2, p2,
                  peak2, expect_eager)
    print(f"  training: {n_images / med:.2f} images/s, median step {med:.4f} s, peak "
          f"{peak / 2**30:.2f} GiB at the defaults; {n_images / med2:.2f} images/s, {med2:.4f} s, "
          f"{peak2 / 2**30:.2f} GiB with eager layers, on {card}")
    # attn_impl="flash": the align layers' attention on K13 / K14 between eager
    # ops, MPNet's on K15 / K16; the frozen tower stays on K1-K3
    expect_flash = expected(fused_preattn=n_tower, flash_attention_packed=n_tower,
                            fused_postattn=n_tower, flash_attention=n_align,
                            flash_attention_bwd=n_align, flash_attention_bias=n_text,
                            flash_attention_bias_bwd=n_text, fused_mpnet_post=n_text,
                            fused_mpnet_post_bwd=n_text, **loss_kernels)
    h3, s3, p3, peak3 = run(cfg_flash, 3, profile_it=profile)
    med3 = report('flash (attn_impl="flash" in align and text: K1-K4, K9-K16)', h3, s3, p3, peak3,
                  expect_flash)
    print(f"  training, attn_impl=\"flash\": {n_images / med3:.2f} images/s, median step "
          f"{med3:.4f} s, peak {peak3 / 2**30:.2f} GiB, on {card}")
    for name, h in (("eager-layer", h2), ("flash", h3)):
        if abs(h[0]["loss"] - history[0]["loss"]) > 0.02 * abs(history[0]["loss"]):
            fail(f"training: step-0 losses of the default and the {name} configuration "
                 f"differ: {history[0]['loss']} vs {h[0]['loss']}")

    # fp32, 2 images x 16 sentences: the all-kernel path, the eager-layer path and
    # the flash path against the all-eager path (eager layers, chain and VL-CABS)
    batch = train_batch(seed + 7, 2, 16, cfg.text.vocab_size, torch.float32)
    legs = {"kernels": cfg, "eager layers": cfg_eager_layers, "flash": cfg_flash,
            "eager": dataclasses.replace(cfg_eager_layers, loss=LossConfig(train_impl="xla"))}
    got = {}
    for name, c in legs.items():
        loss, grads = _grads(params, modules, c, batch, torch.float32)
        got[name] = (loss.item(), grads)
    lx, gx = got["eager"]
    for name in ("kernels", "eager layers", "flash"):
        lf, gf = got[name]
        # per leaf: |path - eager| <= 2e-4 of the leaf's largest |gradient| + 1e-7:
        # the JAX suite holds the fused layers' gradients to 2e-4; here the fp32
        # sums run over 1370 tokens x 768 in another order on the two sides
        worst = max(((a - b).abs().max() / (b.abs().max() + 1e-30)).item()
                    for a, b in zip(gf, gx) if b.abs().max() > 1e-7)
        print(f"  fp32, 2 images: loss {name} {lf:.7f} vs eager {lx:.7f}; worst gradient "
              f"leaf error {worst:.3e} of its largest entry, over {len(gf)} leaves")
        if abs(lf - lx) > 1e-5 * abs(lx) + 1e-6:
            fail(f"training: the loss of the {name} path disagrees with the eager loss")
        for a, b in zip(gf, gx):
            if not bool(((a - b).abs() <= 2e-4 * b.abs().max() + 1e-7).all()):
                fail(f"training: a gradient of the {name} path disagrees with the eager path")
    return training, p3[-1], med


MIMIC_POOL = [  # finding sentences of 3-22 words; a few dominate, as in MIMIC-CXR reports
    "No pleural effusion.", "No pneumothorax.", "The lungs are clear.",
    "Heart size is normal.", "No focal consolidation.", "Mediastinal contours are normal.",
    "Mild cardiomegaly is present.", "There is a small left pleural effusion.",
    "Bibasilar atelectasis is seen.", "No acute osseous abnormality.",
    "There is mild pulmonary vascular congestion without frank interstitial edema.",
    "A right internal jugular central venous catheter terminates in the mid superior vena cava.",
    "Patchy opacity at the left lung base may reflect atelectasis though infection cannot "
    "be excluded in the appropriate clinical setting.",
    "Endotracheal tube terminates approximately four centimeters above the carina.",
    "Degenerative changes of the thoracic spine.", "Calcified granuloma in the right upper lobe.",
    "Moderate right pleural effusion with adjacent compressive atelectasis.",
    "Hyperinflated lungs consistent with chronic obstructive pulmonary disease.",
    "Median sternotomy wires are intact.", "Nasogastric tube courses below the diaphragm.",
    "There is no evidence of free air beneath the diaphragm.",
    "Increased interstitial markings bilaterally.", "Stable appearance of the chest.",
    "Elevation of the right hemidiaphragm.", "Left retrocardiac opacity.",
    "Small bilateral pleural effusions are present with bibasilar opacities likely "
    "representing atelectasis although superimposed pneumonia is not excluded.",
    "Aortic knob calcification.", "Surgical clips in the right upper quadrant.",
    "The cardiomediastinal silhouette is within normal limits.",
    "Low lung volumes accentuate the bronchovascular markings.",
    "Pacemaker leads terminate in the right atrium and right ventricle.",
    "No displaced rib fractures are identified.", "Pulmonary edema has improved.",
    "Right upper lobe consolidation concerning for pneumonia.",
    "Tortuous thoracic aorta.", "Biapical pleural thickening.",
]
MIMIC_HW = (1200, 1000)  # (height, width) of a synthetic study: a CXR's proportions


def mimic_split(root, seed, n_train, n_eval):
    """A synthetic MIMIC-CXR split where load_datasets reads one:
    MIMIC-CXR/{train, eval}.json and MIMIC-CXR/images/<dicom_id>, grayscale
    PNGs of MIMIC_HW (smooth random fields); each study has 1-12 finding
    sentences drawn with repeats from MIMIC_POOL (Zipf-like weights), so
    the packer subsamples (8 a study) and dedup finds repeats. -> the
    dataset config for load_datasets."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed + 16)
    images = Path(root) / "MIMIC-CXR" / "images"
    images.mkdir(parents=True)
    weights = 1.0 / np.arange(1, len(MIMIC_POOL) + 1)
    weights /= weights.sum()

    def rows(prefix, n):
        return [{"dicom_id": f"{prefix}_{i:04d}.png", "view_position": ("PA", "AP")[i % 2],
                 "key_phrases": [MIMIC_POOL[j] for j in rng.choice(
                     len(MIMIC_POOL), int(rng.integers(1, 13)), p=weights)]}
                for i in range(n)]

    splits = {"train": rows("tr", n_train), "eval": rows("ev", n_eval)}
    names = [r["dicom_id"] for rs in splits.values() for r in rs]
    seeds = rng.integers(0, 2**31, len(names))
    h, w = MIMIC_HW

    def write(job):
        name, s = job
        field = np.random.default_rng(int(s)).integers(0, 256, (h // 40, w // 40), dtype=np.uint8)
        Image.fromarray(field, mode="L").resize((w, h), Image.BILINEAR).save(
            images / name, compress_level=1)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, zip(names, seeds)))
    for split, rs in splits.items():
        with open(Path(root) / "MIMIC-CXR" / f"{split}.json", "w") as f:
            json.dump(rs, f)
    return {"data_root": str(root), "train": ["mimic_train"], "eval": ["mimic_eval"],
            "mimic_train": "MIMIC-CXR/train.json", "mimic_eval": "MIMIC-CXR/eval.json",
            "use_frontal_view_only": True}


def ckpt_survivors(saves, bests, limit):
    """The checkpoints save_total_limit leaves after each save at steps
    ``saves`` with the best after it ``bests``: the just-saved one and the
    best always, then the newest others up to ``limit``."""
    alive = []
    for s, b in zip(saves, bests):
        alive.append(s)
        keep = [s] + ([b] if b is not None and b != s and b in alive else [])
        for p in reversed(alive):
            if len(keep) >= limit:
                break
            if p not in keep:
                keep.append(p)
        alive = [p for p in alive if p in keep]
    return alive


class _Stop(Exception):
    """Raised by a metrics callback to stop a training run where a kill would."""


def phase_trainer(seed, card, params, bare_step_s):
    """RadZeroTrainer at full width on a synthetic MIMIC-CXR split read
    through load_datasets and the threaded TrainLoader: run A (3 epochs,
    eval, best selection, pruning, load_best_model_at_end, predict), a run
    stopped at epoch 3 and resumed, the device tower cache, and one dedup
    step twice; returns the launches of one trainer step."""
    import tempfile

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from radzero_torch.data.mimic import load_datasets
    from radzero_torch.data.pipeline import (
        PackSpec, TrainLoader, pack_batch, pil_image_loader, to_device,
    )
    from radzero_torch.data.processing import build_image_processor
    from radzero_torch.data.tokenizer import WhitespaceHashTokenizer
    from radzero_torch.models.configuration import (
        AlignConfig, LossConfig, RadZeroConfig, TextConfig, ViTConfig,
    )
    from radzero_torch.models.radzero import compute_logits
    from radzero_torch.train import trainer as trainer_mod
    from radzero_torch.train.checkpoint import STATE_FILE, list_checkpoints, load_trainer_state
    from radzero_torch.train.optim import tree_leaves
    from radzero_torch.train.step import make_train_step
    from radzero_torch.train.tower_cache import TowerCache

    t_phase = time.perf_counter()
    cfg = RadZeroConfig(vision=ViTConfig(), align=AlignConfig(), text=TextConfig(),
                        loss=LossConfig(train_impl="fused"))
    n_tower, n_align = cfg.vision.num_hidden_layers, cfg.align.num_hidden_layers
    n_text = cfg.text.num_hidden_layers
    rest = dict(fused_mpnet_post=n_text, fused_preattn_bwd=n_align,
                flash_attention_packed_bwd=n_align, fused_postattn_bwd=n_align,
                fused_mpnet_post_bwd=n_text, vlcabs_train_forward=1, vlcabs_train_bwd_dq=1,
                vlcabs_train_bwd_dtn=1)
    expect_step = expected(fused_preattn=n_tower + n_align,
                           flash_attention_packed=n_tower + n_align,
                           fused_postattn=n_tower + n_align, **rest)
    expect_cached = expected(fused_preattn=n_align, flash_attention_packed=n_align,
                             fused_postattn=n_align, **rest)
    expect_tower = expected(fused_preattn=n_tower, flash_attention_packed=n_tower,
                            fused_postattn=n_tower)
    tok = WhitespaceHashTokenizer(cfg.text.vocab_size, 64)
    image_loader = pil_image_loader(build_image_processor(
        {"model_type": cfg.vision.model_type, "img_size": cfg.vision.img_size}))
    spec = PackSpec(max_sentences_per_image=8, max_text_tokens=64, text_length_buckets=(16, 32))
    batch_size = 64

    # host stages and launches, by (run, epoch): timed around the trainer's own
    # calls from here, not inside the library
    stages, now = {}, {"rec": None, "eval": False, "epoch": False}
    profiled = {}

    class TimedLoader(TrainLoader):
        label, profile_epoch = None, None

        def __iter__(self):
            key = (self.label, self.epoch)
            rec = stages.setdefault(key, {k: [] for k in (
                "wait", "put", "step", "read", "tower", "counts", "tower_counts")})
            now["rec"], now["epoch"] = rec, True
            prof = None
            if self.epoch == self.profile_epoch:
                from torch.profiler import ProfilerActivity, profile

                torch.cuda.synchronize()  # no earlier launch in flight when the session opens
                prof = profile(activities=[ProfilerActivity.CUDA])
                prof.__enter__()
                t0 = time.perf_counter()
            it = super().__iter__()
            while True:
                t1 = time.perf_counter()
                try:
                    b = next(it)
                except StopIteration:
                    break
                rec["wait"].append(time.perf_counter() - t1)
                yield b
            now["epoch"] = False  # later uploads are eval's or predict's
            if prof is not None:
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                prof.__exit__(None, None, None)
                ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
                copy = sum(e.self_device_time_total for e in ev if "Memcpy" in e.key) / 1e6
                busy = sum(e.self_device_time_total for e in ev if "Memcpy" not in e.key) / 1e6
                profiled[key] = (busy, copy, wall)

    def loaders(label, records, eval_records, with_indices=False, profile_epoch=None):
        train = TimedLoader(records, image_loader, tok, batch_size, spec, seed=seed,
                            num_threads=8, with_indices=with_indices)
        train.label, train.profile_epoch = label, profile_epoch
        return train, TrainLoader(eval_records, image_loader, tok, batch_size, spec,
                                  shuffle=False, num_threads=8)

    def instrument(t):
        put, step, evaluate, tower = t._put_batch, t.train_step, t.evaluate, t._tower_fn

        def timed_put(b):
            t0 = time.perf_counter()
            out = put(b)
            if now["epoch"]:
                now["rec"]["put"].append(time.perf_counter() - t0)
            return out

        def timed_step(*a):
            reset_counters()
            t0 = time.perf_counter()
            out = step(*a)
            now["rec"]["step"].append(time.perf_counter() - t0)
            now["rec"]["counts"].append(read_counters())
            return out

        def timed_eval():
            now["eval"] = True
            t0 = time.perf_counter()
            try:
                return evaluate()
            finally:
                now["eval"] = False
                evals.append(time.perf_counter() - t0)

        def timed_tower(*a):
            reset_counters()
            t0 = time.perf_counter()
            out = tower(*a)
            now["rec"]["tower"].append(time.perf_counter() - t0)
            now["rec"]["tower_counts"].append(read_counters())
            return out

        t._put_batch, t.train_step, t.evaluate = timed_put, timed_step, timed_eval
        if tower is not None:
            t._tower_fn = timed_tower
        return t

    read, save, restore = trainer_mod._read, trainer_mod.save_checkpoint, trainer_mod.restore_checkpoint
    saves, restores, evals = [], [], []

    def timed_read(losses):
        t0 = time.perf_counter()
        out = read(losses)
        if not now["eval"]:
            now["rec"]["read"].append(time.perf_counter() - t0)
        return out

    def timed_save(output_dir, step, *a, **k):
        t0 = time.perf_counter()
        path = save(output_dir, step, *a, **k)
        saves.append((time.perf_counter() - t0, Path(path, STATE_FILE).stat().st_size))
        return path

    def timed_restore(path, target):
        t0 = time.perf_counter()
        out = restore(path, target)
        torch.cuda.synchronize()
        restores.append((time.perf_counter() - t0, Path(path, STATE_FILE).stat().st_size))
        return out

    def steps_of(history):
        return [r for r in history if "loss" in r]

    def state_file(path):
        return torch.load(Path(path, STATE_FILE), map_location="cpu", weights_only=True,
                          mmap=True)

    def same_leaves(a, b):
        la, lb = list(tree_leaves(a)), list(tree_leaves(b))
        return len(la) == len(lb) and all(
            torch.equal(x.cpu(), y.cpu()) if isinstance(x, torch.Tensor) else x == y
            for x, y in zip(la, lb))

    trainer_mod._read, trainer_mod.save_checkpoint = timed_read, timed_save
    trainer_mod.restore_checkpoint = timed_restore
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            data = load_datasets(mimic_split(Path(tmp) / "data", seed, 320, 64))
            train_recs, eval_recs = data["train"], data["eval"]
            print(f"trainer: synthetic MIMIC-CXR split ({len(train_recs)} train / "
                  f"{len(eval_recs)} eval studies, grayscale PNGs of {MIMIC_HW[0]} x "
                  f"{MIMIC_HW[1]}, 1-12 sentences each from {len(MIMIC_POOL)}) written and "
                  f"read through load_datasets in {time.perf_counter() - t0:.2f} s; "
                  f"TrainLoader(batch {batch_size}, {spec}, 8 threads, pil_image_loader)")
            args = dict(learning_rate=1e-4, num_train_epochs=3, warmup_steps=2,
                        logging_steps=1, save_total_limit=2, early_stopping_patience=2,
                        bf16=True, seed=seed)
            per_epoch = len(train_recs) // batch_size

            # ---- run A: 3 epochs, eval, selection, pruning, best at end, predict
            out_a = Path(tmp) / "run_a"
            ta = instrument(trainer_mod.RadZeroTrainer(
                cfg, trainer_mod.TrainerArgs(output_dir=str(out_a), **args),
                *loaders("A", train_recs, eval_recs), params=params,
                device="cuda"))
            state = ta.train()
            hist_a = state.log_history
            steps_a = steps_of(hist_a)
            epochs_a = [r for r in hist_a if "train_samples_per_second" in r]
            print(f"  run A: {state.step} steps, {len(epochs_a)} epochs, best "
                  f"{Path(state.best_checkpoint).name}, eval_loss "
                  f"{[round(r['eval_loss'], 6) for r in epochs_a]}")
            for r in steps_a:
                print(f"    step {r['step']:2d} epoch {r['epoch']}: loss {r['loss']:.6f} t2i "
                      f"{r['t2i_loss']:.6f} grad_norm {r['grad_norm']:.4f} lr {r['lr']:.3e}")
            if state.step != 3 * per_epoch or len(steps_a) != 3 * per_epoch or len(epochs_a) != 3:
                fail(f"trainer: run A took {state.step} steps, logged {len(steps_a)} steps and "
                     f"{len(epochs_a)} epochs; expected {3 * per_epoch}, {3 * per_epoch}, 3")
            if not all(math.isfinite(v) for r in hist_a for v in r.values()
                       if isinstance(v, float)):
                fail("trainer: a non-finite loss or metric in run A")
            counts_a = [c for e in range(3) for c in stages[("A", e)]["counts"]]
            if any(c != expect_step for c in counts_a):
                fail(f"trainer: run A's launches a step {counts_a} differ from the default "
                     f"step's {expect_step}")
            saved_steps = [r["step"] for r in epochs_a]
            bests, best, best_metric = [], None, None
            for r in epochs_a:
                if best_metric is None or r["eval_loss"] < best_metric:
                    best, best_metric = r["step"], r["eval_loss"]
                bests.append(best)
            want = [f"checkpoint-{s}" for s in sorted(ckpt_survivors(saved_steps, bests, 2))]
            got = [Path(p).name for p in list_checkpoints(str(out_a))]
            print(f"  run A: checkpoints {got} (the pruning rule: {want}); best "
                  f"checkpoint-{best}")
            if got != want or Path(state.best_checkpoint).name != f"checkpoint-{best}":
                fail("trainer: the surviving or best checkpoints break the save_total_limit rule")
            if not same_leaves(ta.trainable, state_file(state.best_checkpoint)["trainable"]):
                fail("trainer: after load_best_model_at_end the trainable tree is not the best "
                     "checkpoint's")
            final_a = {k: v for k, v in state_file(Path(out_a, f"checkpoint-{state.step}")).items()}

            def logits_step(p, b):
                return compute_logits(p, cfg, b["pixel_values"], b["input_ids"],
                                      b["attention_mask"], dtype=torch.bfloat16)

            reset_counters()
            pred = ta.predict(ta.eval_loader, logits_step)
            predict_counts = read_counters()
            batch = next(iter(ta.eval_loader))
            with torch.no_grad():
                ref = logits_step(ta.params, to_device(batch, "cuda"))
            same = all(np.array_equal(pred[k], ref[k].float().cpu().numpy())
                       for k in ("logits", "similarity_scores"))
            print(f"  predict(compute_logits) over the eval loader: logits "
                  f"{pred['logits'].shape}, maps {pred['similarity_scores'].shape}, bit-equal to "
                  f"compute_logits on the same batch: {same}; vlcabs_fused launches "
                  f"{predict_counts['vlcabs_fused']}")
            if not same or predict_counts["vlcabs_fused"] != len(pred["logits"]) // batch_size:
                fail("trainer: predict with a compute_logits step disagrees with compute_logits")
            a_trainable = [x.cpu() for x in tree_leaves(ta.trainable)]
            del ta, pred, ref
            torch.cuda.empty_cache()

            # ---- a run stopped at the first step record of epoch 3, then resumed
            def stop(rec):
                if "loss" in rec and rec["epoch"] == 2:
                    raise _Stop

            out_b = Path(tmp) / "run_b"
            tb = instrument(trainer_mod.RadZeroTrainer(
                cfg, trainer_mod.TrainerArgs(output_dir=str(out_b), **args),
                *loaders("B", train_recs, eval_recs, profile_epoch=1), params=params,
                device="cuda", metrics_callback=stop))
            try:
                tb.train()
                fail("trainer: the stopping callback never fired")
            except _Stop:
                pass
            steps_b = steps_of(tb.state.log_history)
            del tb
            torch.cuda.empty_cache()
            last_b = [Path(p).name for p in list_checkpoints(str(out_b))]
            tc = instrument(trainer_mod.RadZeroTrainer(
                cfg, trainer_mod.TrainerArgs(output_dir=str(out_b), **args),
                *loaders("C", train_recs, eval_recs), params=params, device="cuda"))
            state_c = tc.train(resume_from_checkpoint=True)
            steps_c = steps_of(state_c.log_history)
            k = 2 * per_epoch
            same_b = steps_b == steps_a[:k + 1]
            same_c = steps_c == steps_a[k:]
            final_c = state_file(Path(out_b, f"checkpoint-{state_c.step}"))
            same_state = same_leaves(final_a, final_c)
            same_best = same_leaves(a_trainable, tc.trainable)
            print(f"  stopped at step {steps_b[-1]['step']} by a raising callback (checkpoints "
                  f"left: {last_b}); resumed with True from {last_b[-1]}: steps "
                  f"{[r['step'] for r in steps_c]}; two runs' steps 1-{k + 1} bit-equal: "
                  f"{same_b}; resumed steps {k + 1}-{3 * per_epoch} equal run A's: {same_c}; "
                  f"checkpoint-{state_c.step} (weights and AdamW state) equal: {same_state}; "
                  f"the final trainable tree (after load_best_model_at_end) equal: {same_best}")
            if not (same_b and same_c and same_state and same_best):
                fail("trainer: a resumed run does not give an uninterrupted run's bits")
            del tc
            torch.cuda.empty_cache()

            # ---- the device tower cache: the same run with the tower once per record
            cache = TowerCache("device", n_records=len(train_recs))
            td = instrument(trainer_mod.RadZeroTrainer(
                cfg, trainer_mod.TrainerArgs(output_dir=str(Path(tmp) / "run_cache"), **args),
                *loaders("cache", train_recs, eval_recs, with_indices=True), params=params,
                device="cuda", tower_cache=cache))
            state_d = td.train()
            hist_d = state_d.log_history
            counts_d = [c for e in range(3) for c in stages[("cache", e)]["counts"]]
            towers = [len(stages[("cache", e)]["tower_counts"]) for e in range(3)]
            same_d = steps_of(hist_d) == steps_a
            same_eval = ([r["eval_loss"] for r in hist_d if "eval_loss" in r]
                         == [r["eval_loss"] for r in epochs_a])
            print(f"  tower cache (device, {cache.nbytes / 2**30:.2f} GiB for {len(train_recs)} "
                  f"records): {cache.stats()}, tower calls by epoch {towers}; steps and eval "
                  f"losses bit-equal to run A's: {same_d} / {same_eval}")
            if (cache.misses, cache.hits) != (per_epoch, 2 * per_epoch) or towers != [per_epoch, 0, 0]:
                fail("trainer: the tower cache did not miss every batch of epoch 1 and hit every "
                     "later one")
            if any(c != expect_tower for c in stages[("cache", 0)]["tower_counts"]):
                fail("trainer: the cache's tower ran other launches than the step's tower")
            if any(c != expect_cached for c in counts_d):
                fail(f"trainer: cached steps launched {counts_d}, expected {expect_cached}")
            if not (same_d and same_eval):
                fail("trainer: cached epochs do not compute what uncached ones do")

            # ---- dedup: one step of a row_gather batch, twice from the same state
            recs = train_recs[:batch_size]
            imgs = np.stack([image_loader(r) for r in recs])
            dspec = dataclasses.replace(spec, dedup_slots=320)
            packed = [pack_batch(recs, imgs, tok, s, np.random.default_rng(seed))
                      for s in (dspec, dspec, spec)]
            step = make_train_step(td.cfg, td.optimizer, dtype=torch.bfloat16,
                                   device=td.device)  # untimed
            outs, times = [], {"dedup": [], "plain": []}
            for i, b in enumerate(packed + packed[1:] * 2):
                kind = "plain" if "row_gather" not in b else "dedup"
                dev_b = to_device(b, "cuda")
                tr, opt = _clone(td.trainable), _clone_state(td.opt_state)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr, opt, losses = step(tr, td.frozen, opt, dev_b)
                torch.cuda.synchronize()
                times[kind].append(time.perf_counter() - t0)
                if i < 2:
                    outs.append(([x.clone() for x in tree_leaves(tr)],
                                 {k: v.item() for k, v in losses.items()}))
                del tr, opt
            n_diff = sum(not torch.equal(x, y) for x, y in zip(outs[0][0], outs[1][0]))
            u = packed[0]["input_ids"].shape[0]
            med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
            print(f"  dedup (finding, not a gate): a batch of {batch_size} x "
                  f"{len(packed[2]['row_mask'])} slots ({int(packed[2]['row_mask'].sum())} "
                  f"sentences, {len(np.unique(packed[0]['row_gather']))} unique) as "
                  f"{u} rows + row_gather; two steps from the same state give the same bits: "
                  f"{n_diff == 0} (losses {outs[0][1]['loss']!r} / {outs[1][1]['loss']!r}, "
                  f"{n_diff} of {len(outs[0][0])} updated leaves differ); step "
                  f"{med['dedup'] * 1e3:.1f} ms (median of {len(times['dedup'])}) against the "
                  f"plain layout's {med['plain'] * 1e3:.1f} ms, on {card}")

            # the step's host enqueue alone, then beside the loader's decode pool
            def enqueue_ms(n=3):
                dev_b, out = to_device(packed[2], "cuda"), []
                for _ in range(n):
                    tr, opt = _clone(td.trainable), _clone_state(td.opt_state)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step(tr, td.frozen, opt, dev_b)
                    out.append((time.perf_counter() - t0) * 1e3)
                    torch.cuda.synchronize()
                    del tr, opt
                return out

            alone = enqueue_ms()
            bg = TrainLoader(train_recs, image_loader, tok, batch_size, spec, seed=seed,
                             num_threads=8)
            drain = threading.Thread(target=lambda: [None for _ in bg])
            drain.start()
            time.sleep(1.0)  # the pool is decoding
            beside = enqueue_ms()
            drain.join()
            print(f"  the step's host enqueue (plain layout, no loss read): "
                  f"{[round(v, 1) for v in alone]} ms alone, {[round(v, 1) for v in beside]} ms "
                  f"while a TrainLoader decodes on its 8 threads, on {card}")
            del td, cache
            torch.cuda.empty_cache()
    finally:
        trainer_mod._read, trainer_mod.save_checkpoint = read, save
        trainer_mod.restore_checkpoint = restore

    # ---- what the phase measured
    def rate(history):
        return [r["train_samples_per_second"] for r in history if "train_samples_per_second" in r]

    print(f"  train_samples_per_second by epoch: run A {rate(hist_a)}, "
          f"resumed {rate(state_c.log_history)}, tower cache {rate(hist_d)}; the bare step "
          f"{batch_size / bare_step_s:.2f} images/s (phase 6, median step {bare_step_s:.4f} s), "
          f"on {card}")
    for label, history in (("A", hist_a), ("cache", hist_d)):
        st = stages[(label, 2)]
        n = len(st["step"])
        epoch_s = batch_size * n / rate(history)[2]
        print(f"  host stages of run {label}'s epoch 3 ({n} steps, {epoch_s:.3f} s): waiting on "
              f"the loader's queue {sum(st['wait']):.3f} s (max {max(st['wait']):.3f}), pinning and "
              f"upload {sum(st['put']):.3f} s ({sum(st['put']) / n * 1e3:.1f} ms a batch), the "
              f"step's enqueue {sum(st['step']):.3f} s ({sum(st['step']) / n * 1e3:.1f} ms), "
              f"waiting on the card for the losses {sum(st['read']):.3f} s")
    for key, (busy, copy, wall) in profiled.items():
        print(f"  the card over run {key[0]}'s epoch {key[1] + 1} (torch.profiler): kernels "
              f"{busy:.3f} s, copies {copy:.3f} s, of {wall:.3f} s: idle {100 * (1 - busy / wall):.1f}%")
    step_a = [batch_size / r for r in rate(hist_a)]
    step_d = [batch_size / r for r in rate(hist_d)]
    print(f"  seconds a step by epoch ({batch_size} / samples/s): run A {[round(s, 4) for s in step_a]}, "
          f"tower cache {[round(s, 4) for s in step_d]} (epochs 2-3 cached)")
    print(f"  eval: {len(evals)} calls of {[round(s, 3) for s in evals]} s "
          f"({len(eval_recs)} studies each)")
    print(f"  saves: {len(saves)}, {[(round(s, 3), b) for s, b in saves]} (s, bytes); restores: "
          f"{[(round(s, 3), b) for s, b in restores]}")
    print(f"  trainer phase {time.perf_counter() - t_phase:.1f} s, on {card}")
    return stages[("A", 2)]["counts"][-1]


# phase 8, the real-checkpoint path: a synthetic flagship snapshot in the exact HF layout.
# Its vocab.txt has all-mpnet-base-v2's layout (<s> <pad> </s> <unk>, BERT's [PAD] and
# [unused0-98], [UNK] at 104, [CLS] [SEP] [MASK], ..., <mask> last: 30527 entries) and holds
# the words of phase 4's prompts, each of 9 letters or more split into a 5-letter head and a
# ## tail, so WordPiece splits and shares pieces
CKPT_VOCAB_SIZE = 30527
# the WordPiece ids of phase 4's 14 prompts on that vocabulary, pad stripped
# (tests/test_torch_wordpiece.py holds the port's and the JAX package's tokenizers to them)
CHEXPERT_IDS = [
    [0, 132, 121, 124, 119, 2], [0, 132, 121, 118, 110, 111, 2], [0, 132, 121, 110, 112, 2],
    [0, 132, 121, 123, 125, 2], [0, 132, 121, 123, 122, 2], [0, 132, 121, 116, 2],
    [0, 132, 121, 113, 114, 2], [0, 132, 121, 128, 129, 2], [0, 132, 121, 108, 109, 2],
    [0, 132, 121, 128, 130, 2], [0, 132, 121, 127, 117, 2], [0, 132, 121, 127, 126, 2],
    [0, 132, 121, 120, 2], [0, 132, 121, 131, 115, 2],
]
FILTER_RATIO, FILTER_LAYER = 0.5, 6   # the token filter the branch checks run


def checkpoint_vocab(prompts):
    """The lines of the snapshot's vocab.txt (see CKPT_VOCAB_SIZE)."""
    pieces = []
    for w in sorted({w for p in prompts for w in p.lower().split()}):
        for p in ((w[:5], "##" + w[5:]) if len(w) >= 9 else (w,)):
            if p not in pieces:
                pieces.append(p)
    head = (["<s>", "<pad>", "</s>", "<unk>", "[PAD]"] + [f"[unused{i}]" for i in range(99)]
            + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"])
    fill = CKPT_VOCAB_SIZE - 1 - len(head) - len(pieces)
    return head + pieces + [f"[unused{99 + i}]" for i in range(fill)] + ["<mask>"]


def logits_gate(label, dname, kern, ref):
    """compute_logits' kernel route against its eager route. fp32 (TF32 off): the repo's
    gate (tests/test_radzero_model.py), logits rtol 1e-3 / atol 2e-4 and map MAE < 1e-3.
    bf16: phase 4's gate, logits within 0.25 and map MAE within 0.05, set at the radzero
    logits' and maps' scale (|x| <= 1 / 0.07 = 14.3); a bf16 error grows with the values,
    so where max|ref| exceeds 14.3 (the alignment branches' unscaled dot products) the
    gate grows with it."""
    import torch

    lk, lr = kern["logits"].float(), ref["logits"].float()
    if set(kern) != set(ref) or lk.shape != lr.shape or not torch.isfinite(lk).all():
        fail(f"{label} {dname}: outputs {sorted(kern)} {tuple(lk.shape)} vs {sorted(ref)}")
    lerr, lmax = (lk - lr).abs().max().item(), lr.abs().max().item()
    ok = (torch.allclose(lk, lr, rtol=1e-3, atol=2e-4) if dname == "fp32"
          else lerr <= 0.25 * max(1.0, lmax / 14.3))
    line = f"logits max_abs_err {lerr:.3e} (|logit| <= {lmax:.3f})"
    if "similarity_scores" in ref:
        sk, sr = kern["similarity_scores"].float(), ref["similarity_scores"].float()
        mae, smax = (sk - sr).abs().mean().item(), sr.abs().max().item()
        ok = ok and (mae < 1e-3 if dname == "fp32" else mae <= 0.05 * max(1.0, smax / 14.3))
        line += f", map MAE {mae:.3e} (|map| <= {smax:.3f})"
    print(f"  {label:16s} {dname}: {line} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{label} {dname}: the kernel route disagrees with the eager route")


def phase_checkpoint(seed, card):
    """8: the real-checkpoint path at full width. A flagship snapshot from ``seed`` (LN,
    LayerScale and bias leaves moved off their init; a 37 x 37 position table) written in
    HF names through to_hf_state_dict and the port's safetensors writer, with a vocab.txt
    and a preprocessor_config.json; converted by ``python -m
    radzero_torch.tools.convert_checkpoint``; loaded by load_converted (bit-equal to the
    written tree); served by ``python -m radzero_torch.eval.server --ckpt`` in the
    background, whose answers to 4 CXR-size JPEGs must be bit-equal to an engine's in this
    process on the loaded tree (with the WordPiece ids pinned in CHEXPERT_IDS). Then K1-K3
    against their twins at the token filter's length, compute_logits on the loaded weights
    against the eager route, and the branches (cls_alignment, global_alignment, the linear
    and mlp adapters, the token filter) each against the eager route in fp32 and bf16.
    Returns the launches of the in-process engine's 4 requests."""
    import os
    import socket
    import tempfile
    import urllib.error
    import urllib.request

    import numpy as np
    import torch
    from radzero_torch.data.tokenizer import WordPieceTokenizer, load_tokenizer
    from radzero_torch.eval.serving import ImageSpec, ServingEngine, cast_params
    from radzero_torch.models import vit
    from radzero_torch.models.align import build_align_adapter
    from radzero_torch.models.configuration import AlignConfig, RadZeroConfig, ViTConfig
    from radzero_torch.models.convert import to_hf_state_dict
    from radzero_torch.models.radzero import compute_logits, init_radzero
    from radzero_torch.ops import fused_layer as fl
    from radzero_torch.ops.layers import normalize_pixels
    from radzero_torch.tools.run_real_checkpoint import build_processor, load_converted
    from radzero_torch.utils.safetensors_io import save_file

    t_phase = time.perf_counter()
    prompts = [f"There is {c}" for c in CHEXPERT]
    cfg = RadZeroConfig(vision=ViTConfig(pretrain_img_size=518))
    gen = torch.Generator(device="cuda").manual_seed(seed + 40)
    params = init_radzero(gen, cfg)
    for path, leaf in _keyed_paths(params):
        if path.rsplit("/", 1)[-1] in ("scale", "bias", "ls1", "ls2"):
            leaf.add_(0.1 * torch.randn(leaf.shape, generator=gen, device="cuda"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)

    with tempfile.TemporaryDirectory(prefix="rz_ckpt_") as tmp:
        snap, conv = os.path.join(tmp, "snapshot"), os.path.join(tmp, "converted")
        os.makedirs(snap)
        t0 = time.perf_counter()
        sd = to_hf_state_dict(params, cfg)
        n_tensors = len(sd)
        save_file(sd, os.path.join(snap, "model.safetensors"), metadata={"format": "pt"})
        del sd
        with open(os.path.join(snap, "vocab.txt"), "w", encoding="utf-8") as f:
            f.write("\n".join(checkpoint_vocab(prompts)) + "\n")
        with open(os.path.join(snap, "preprocessor_config.json"), "w") as f:
            json.dump({"image_mean": [0.48145466, 0.4578275, 0.40821073],
                       "image_std": [0.26862954, 0.26130258, 0.27577711],
                       "size": {"height": 518, "width": 518}, "resample": 3}, f)
        write_s = time.perf_counter() - t0
        snap_bytes = os.path.getsize(os.path.join(snap, "model.safetensors"))

        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "radzero_torch.tools.convert_checkpoint", "--src", snap,
             "--dst", conv, "--kind", "radzero"],
            cwd=str(REPO), env=env, capture_output=True, text=True, timeout=300)
        convert_s = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"convert_checkpoint exited {proc.returncode}: {proc.stderr[-2000:]}")
        t0 = time.perf_counter()
        loaded, lcfg = load_converted(conv)
        load_s = time.perf_counter() - t0
        print(f"checkpoint: snapshot of {snap_bytes} bytes (model.safetensors, "
              f"{n_tensors} tensors in HF names) written in {write_s:.2f} s; "
              f"converted in {convert_s:.2f} s ({proc.stdout.strip()}; a fresh python3), "
              f"loaded in {load_s:.2f} s on {card}")
        # the loaded tree is the written one, bit for bit
        want, got = dict(_keyed_paths(params)), dict(_keyed_paths(loaded))
        if sorted(want) != sorted(got):
            fail(f"loaded tree's leaves differ: {sorted(set(want) ^ set(got))[:5]}")
        bad = [p for p in want if got[p].dtype != torch.float32
               or not torch.equal(want[p].cpu(), got[p])]
        if bad or lcfg.vision.pretrain_img_size != 518:
            fail(f"loaded tree differs from the written one at {bad[:5]} or pretrain_img_size "
                 f"{lcfg.vision.pretrain_img_size} != 518")
        print(f"  loaded tree bit-equal to the written one ({len(want)} leaves); "
              f"pretrain_img_size {lcfg.vision.pretrain_img_size} from the position table")

        tok = load_tokenizer(conv, max_length=64)
        ids_np, mask_np = tok(prompts)
        got_ids = [ids_np[i][mask_np[i] == 1].tolist() for i in range(len(prompts))]
        if not isinstance(tok, WordPieceTokenizer) or got_ids != CHEXPERT_IDS \
                or (ids_np == tok.unk_id).any():
            fail(f"WordPiece ids of the 14 prompts: {type(tok).__name__} {got_ids}")
        print(f"  WordPiece ids of the 14 prompts (vocab.txt of {CKPT_VOCAB_SIZE} entries, "
              f"unk {tok.unk_id} absent) equal CHEXPERT_IDS")

        # the server in the background, and an engine here on the loaded tree
        proc_cfg = build_processor(conv)
        spec = ImageSpec(size=proc_cfg.size, mean=tuple(proc_cfg.mean), std=tuple(proc_cfg.std))
        with open(os.path.join(tmp, "prompts.json"), "w") as f:
            json.dump({"chexpert": prompts}, f)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        base = f"http://127.0.0.1:{port}"
        jpegs = cxr_jpegs(seed + 41, 4)
        log_path = os.path.join(tmp, "server.log")
        t0 = time.perf_counter()
        with open(log_path, "w") as log:
            server = subprocess.Popen(
                [sys.executable, "-m", "radzero_torch.eval.server", "--ckpt", conv,
                 "--prompts_json", os.path.join(tmp, "prompts.json"), "--host", "127.0.0.1",
                 "--port", str(port)], cwd=str(REPO), env=env, stdout=log,
                stderr=subprocess.STDOUT)
        try:
            def server_log():
                with open(log_path) as f:
                    return f.read()[-3000:]

            while True:
                if server.poll() is not None:
                    fail(f"the --ckpt server exited {server.returncode}: {server_log()}")
                try:
                    with urllib.request.urlopen(f"{base}/healthz", timeout=10) as resp:
                        health = json.loads(resp.read())
                    break
                except (urllib.error.URLError, ConnectionError):
                    if time.perf_counter() - t0 > 300:
                        fail(f"the --ckpt server never answered /healthz: {server_log()}")
                    time.sleep(0.25)
            cold_s = time.perf_counter() - t0
            answers = []
            for data in jpegs:
                req = urllib.request.Request(f"{base}/predict?prompt_set=chexpert&maps=patch",
                                             data=data, headers={"Content-Type": "image/jpeg"})
                with urllib.request.urlopen(req, timeout=300) as resp:
                    answers.append(json.loads(resp.read()))
        finally:
            server.terminate()
            try:
                server.wait(timeout=60)
            except subprocess.TimeoutExpired:
                server.kill()
                server.wait(timeout=60)
        print(f"  python -m radzero_torch.eval.server --ckpt: cold start to /healthz "
              f"{cold_s:.2f} s (load, kernels, warmup batch of 32), {health}; 4 requests "
              f"answered, stopped on {card}")

        engine = ServingEngine(loaded, lcfg, tok, device="cuda", max_batch=32,
                               dtype=torch.bfloat16, channels=1, image_spec=spec)
        try:
            engine.register_prompt_set("chexpert", prompts)
            engine.warmup()
            reset_counters()
            local = [engine.submit(d, "chexpert", want_maps="patch").result(timeout=300)
                     for d in jpegs]
            launches = read_counters()
        finally:
            engine.close()
    n_layers = cfg.vision.num_hidden_layers + cfg.align.num_hidden_layers
    expect = expected(fused_preattn=4 * n_layers, flash_attention_packed=4 * n_layers,
                      fused_postattn=4 * n_layers,
                      fused_mpnet_post=4 * cfg.text.num_hidden_layers, vlcabs_fused=4)
    if launches != expect:
        fail(f"checkpoint engine launches {launches}, expected {expect}")
    for i, (http, mine) in enumerate(zip(answers, local)):
        p = np.asarray(http["probs"], np.float32)
        m = np.asarray(http["similarity_maps"], np.float32)
        if p.shape != (N,) or m.shape != (N, 37, 37) or not np.isfinite(m).all() \
                or not np.array_equal(p, mine["probs"]) \
                or not np.array_equal(m, mine["similarity_maps"]):
            fail(f"request {i}: the --ckpt server's answer is not the engine's, bit for bit")
    print(f"  HTTP answers bit-equal to the engine's on the loaded tree (4 requests, probs "
          f"and 14 x 37 x 37 maps); the engine's launches {launches}")

    # K1-K3 at the token filter's length against their twins: row and tile tails
    lf = 1 + round((L - 1) * (1 - FILTER_RATIO))
    for dtype, dname in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        g = torch.Generator(device="cuda").manual_seed(seed + 42)
        qkv = (torch.randn((B, lf, 3 * D), generator=g, device="cuda")).to(dtype)
        for k, kern, plain, args, kw in (
                ("K1", fl.fused_preattn, fl.fused_preattn_plain,
                 layer_inputs("K1", dtype, g, B * lf), {}),
                ("K2", fl.flash_attention_packed, fl.flash_attention_packed_plain, (qkv,),
                 {"n_heads": H}),
                ("K3", fl.fused_postattn, fl.fused_postattn_plain,
                 layer_inputs("K3", dtype, g, B * lf), {})):
            compare(f"{k} L={lf}", dname, kern(*args, **kw), plain(*args, **kw), tol=k)

    # compute_logits on the loaded tree, and the branches, against the eager route
    dev = cast_params(loaded, torch.float32, "cuda")
    ids, mask = (torch.as_tensor(a, dtype=torch.long, device="cuda") for a in (ids_np, mask_np))
    rng = np.random.default_rng(seed + 43)
    u8 = torch.as_tensor(rng.integers(0, 256, (4, 518, 518, 1), dtype=np.uint8),
                         device="cuda").expand(4, 518, 518, 3)
    g = torch.Generator(device="cuda").manual_seed(seed + 44)
    proj = {"kernel": torch.randn((D, 2 * D), generator=g, device="cuda") * 0.02,
            "bias": torch.zeros(2 * D, device="cuda")}
    filtered = dataclasses.replace(lcfg.vision, token_filter_ratio=FILTER_RATIO,
                                   token_filter_layer=FILTER_LAYER)
    branches = {
        "radzero": (dev, lcfg),
        "cls_alignment": (dev, dataclasses.replace(lcfg, compute_logits_type="cls_alignment")),
        "global_alignment": ({**dev, "text_projector": proj}, dataclasses.replace(
            lcfg, compute_logits_type="global_alignment",
            text=dataclasses.replace(lcfg.text, use_text_projection=True))),
        "token_filter": (dev, dataclasses.replace(lcfg, vision=filtered)),
    }
    for t in ("linear", "mlp"):
        acfg = AlignConfig(model_type=t)
        branches[t] = ({**dev, "align_transformer": build_align_adapter(t)[0](g, acfg)},
                       dataclasses.replace(lcfg, align=acfg))
    orig_indices = vit.token_filter_indices
    agree = []
    with torch.inference_mode():
        for name, (tree, bcfg) in branches.items():
            eager_cfg = dataclasses.replace(bcfg, text=dataclasses.replace(bcfg.text,
                                                                           fuse_post=False))
            for dtype, dname, nb in ((torch.float32, "fp32", 2), (torch.bfloat16, "bf16", 4)):
                ptree = cast_params(tree, dtype, "cuda")
                pv = normalize_pixels(u8[:nb], spec.mean, spec.std, dtype=dtype)
                seen = []

                def record(x, p, c):
                    seen.append(orig_indices(x, p, c))
                    return seen[-1]

                def forced(x, p, c):  # the kernel route's rows, into the eager route
                    seen.append(orig_indices(x, p, c))
                    return seen[0]

                try:
                    vit.token_filter_indices = record
                    kern = compute_logits(ptree, bcfg, pv, ids, mask, dtype=dtype)
                    vit.token_filter_indices = forced if dname == "bf16" else record
                    ref = compute_logits(ptree, eager_cfg, pv, ids, mask, dtype=dtype,
                                         eager=True)
                finally:
                    vit.token_filter_indices = orig_indices
                if name == "token_filter":
                    share = (seen[0][:, 1:, None] == seen[1][:, None, 1:]).any(-1).float()
                    agree.append(f"{dname} {100 * share.mean().item():.2f}%")
                    keep = lf - 1
                    if seen[0].shape != (nb, 1 + keep) or (dname == "fp32" and not torch.equal(
                            seen[0], seen[1])):
                        fail(f"token filter {dname}: kept rows {tuple(seen[0].shape)}, or the "
                             "routes keep other rows in fp32")
                logits_gate(name, dname, kern, ref)
    print(f"  token filter (ratio {FILTER_RATIO}, layer {FILTER_LAYER}, {lf} tokens after "
          f"it): kept rows the routes share {', '.join(agree)} (bf16: the eager route ran "
          "the kernel route's rows)")
    print(f"  phase 8 (checkpoint) {time.perf_counter() - t_phase:.1f} s on {card}")
    return launches


def _grads(params, modules, c, batch, dtype, *, remat=False, stop=True):
    """(loss, every gradient leaf of the ``modules`` subtree) of forward_train."""
    import torch
    from radzero_torch.models.radzero import forward_train
    from radzero_torch.train.optim import merge_params, partition_params, tree_leaves

    trainable, frozen = partition_params(params, modules)
    leaves = tree_leaves(trainable)
    for p in leaves:
        p.requires_grad_(True)
    try:
        out = forward_train(merge_params(trainable, frozen), c, batch, dtype=dtype, remat=remat,
                            stop_vision_gradient=stop)
        grads = torch.autograd.grad(out["losses"]["loss"], leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return out["losses"]["loss"].detach(), [torch.zeros_like(p) if g is None else g
                                            for p, g in zip(leaves, grads)]


def _same_bits(label, a, b):
    import torch

    (la, ga), (lb, gb) = a, b
    same = torch.equal(la, lb) and len(ga) == len(gb) and all(
        torch.equal(x, y) for x, y in zip(ga, gb))
    print(f"  {label}: loss {lb.item():.7f}, {len(gb)} gradient leaves, "
          f"{'bit-equal' if same else 'DIFFERENT'}")
    if not same:
        fail(f"{label}: the loss or a gradient leaf differs from the step without remat")


def phase_remat(seed, card, params):
    """6, remat legs: the default step under remat (TrainerArgs.gradient_checkpointing)
    with the align layers at remat_policy "save_attn" (the default) and at None, beside the
    step without it, at 64 images x 512 sentences x 32 tokens in bf16: the loss and every
    gradient leaf bit-equal, the launches (the default step's plus K1 2 and K4 12 under
    save_attn; K1-K3 2 each and K4 12 under None), peak memory, the median step and the
    card's idle share; the same bit check on phase 6's fp32 batch of 2 images. Returns the
    launches of one save_attn remat step."""
    import torch
    from radzero_torch.models.configuration import (
        AlignConfig, LossConfig, RadZeroConfig, TextConfig, ViTConfig,
    )
    from radzero_torch.train.optim import build_optimizer, partition_params
    from radzero_torch.train.step import make_train_step

    t_phase = time.perf_counter()
    cfg = RadZeroConfig(vision=ViTConfig(), align=AlignConfig(), text=TextConfig(),
                        loss=LossConfig(train_impl="fused"))
    cfg_none = dataclasses.replace(cfg, align=dataclasses.replace(cfg.align, remat_policy=None))
    modules = ("align_transformer", "text_model", "loss_fns")
    n_tower, n_align = cfg.vision.num_hidden_layers, cfg.align.num_hidden_layers
    n_text = cfg.text.num_hidden_layers
    base = dict(fused_preattn=n_tower + n_align, flash_attention_packed=n_tower + n_align,
                fused_postattn=n_tower + n_align, fused_mpnet_post=n_text,
                fused_preattn_bwd=n_align, flash_attention_packed_bwd=n_align,
                fused_postattn_bwd=n_align, fused_mpnet_post_bwd=n_text,
                vlcabs_train_forward=1, vlcabs_train_bwd_dq=1, vlcabs_train_bwd_dtn=1)

    def plus(**more):
        return expected(**{k: v + more.get(k, 0) for k, v in base.items()})

    legs = [("no remat", cfg, False, plus()),
            ('remat, align "save_attn"', cfg, True,
             plus(fused_preattn=n_align, fused_mpnet_post=n_text)),
            ("remat, align None", cfg_none, True,
             plus(fused_preattn=n_align, flash_attention_packed=n_align,
                  fused_postattn=n_align, fused_mpnet_post=n_text))]
    print(f"remat (phase 6): {TB} images x {TN} sentences x {T_LEN} tokens, bf16, the tower "
          "frozen; the align layers' policy, MPNet's full per-layer recompute")

    batch = train_batch(seed, TB, TN, cfg.text.vocab_size, torch.bfloat16)
    ref = _grads(params, modules, cfg, batch, torch.bfloat16)
    for label, c, remat, _ in legs[1:]:
        _same_bits(f"bf16, {TB} images, {label}", ref,
                   _grads(params, modules, c, batch, torch.bfloat16, remat=remat))
    del ref
    small = train_batch(seed + 7, 2, 16, cfg.text.vocab_size, torch.float32)
    ref = _grads(params, modules, cfg, small, torch.float32)
    for label, c, remat, _ in legs[1:]:
        _same_bits(f"fp32, 2 images, {label}", ref,
                   _grads(params, modules, c, small, torch.float32, remat=remat))
    del ref

    rows, remat_step = [], None
    for label, c, remat, expect in legs:
        trainable, frozen = partition_params(params, modules)
        trainable = _clone(trainable)
        opt, _ = build_optimizer(learning_rate=1e-4, warmup_steps=1, total_steps=6)
        state = opt.init(trainable)
        step = make_train_step(c, opt, dtype=torch.bfloat16, remat=remat)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        seconds, per_step = [], []
        for _ in range(4):
            reset_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainable, state, losses = step(trainable, frozen, state, batch)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            per_step.append(read_counters())
            if not all(math.isfinite(v.item()) for v in losses.values()):
                fail(f"remat {label}: non-finite losses {losses}")
        peak = torch.cuda.max_memory_allocated()
        if any(p != expect for p in per_step):
            fail(f"remat {label}: expected launches per step {expect}, got {per_step[-1]}")
        idle = device_idle(lambda: step(trainable, frozen, state, batch))
        med = sorted(seconds[1:])[len(seconds[1:]) // 2]
        share = "not recorded" if idle is None else f"{100 * (1 - idle[0] / idle[1]):.1f}%"
        rows.append((label, peak, med, share))
        print(f"  {label}: peak {peak / 2**30:.2f} GiB, median step {med:.4f} s of steps 1-3 "
              f"({TB / med:.2f} images/s), card idle {share} of a step"
              + ("" if idle is None else f" (busy {idle[0]:.1f} of {idle[1]:.1f} ms)"))
        if label.startswith('remat, align "save'):
            remat_step = per_step[-1]
        del trainable, state, step
    (_, p0, s0, _), *others = rows
    for label, p, s, _ in others:
        print(f"  {label} against no remat: peak {p / 2**30:.2f} vs {p0 / 2**30:.2f} GiB "
              f"({(p0 - p) / 2**30:+.2f} GiB saved), step {s:.4f} vs {s0:.4f} s "
              f"({100 * (s / s0 - 1):+.1f}%), on {card}")
        if p >= p0:
            fail(f"remat {label}: peak memory {p} not below the step without remat {p0}")
    print(f"  remat legs {time.perf_counter() - t_phase:.1f} s")
    return remat_step


LORA_TARGETS = ["attn/q", "attn/v"]  # tests/test_lora.py's


def phase_lora(seed, card, params):
    """6, the LoRA leg at full width: r 8, alpha 32 on attn/q and attn/v of the three
    towers (radzero_torch/train/lora.py). At init the merged forward is bit-equal to the
    base one (B = 0); with B drawn off zero, the adapter gradients through the kernels (the
    tower trainable through its adapters: its 12 layers on K1-K3 / K6-K8, the align layers,
    K4 / K9, K10-K12) against the all-eager route in fp32 at 2 images x 16 sentences, under
    phase 6's per-leaf gate; in bf16 at 8 images x 64 sentences a finite loss and a second
    backward with the same bits; save_adapter / load_adapter with the same bits."""
    import tempfile

    import torch
    from radzero_torch.models.configuration import (
        AlignConfig, LossConfig, RadZeroConfig, TextConfig, ViTConfig,
    )
    from radzero_torch.models.radzero import forward_train
    from radzero_torch.models.vit import vit_forward
    from radzero_torch.train.lora import (
        init_lora, load_adapter, lora_trainable, merge_lora, save_adapter, with_trainable,
    )

    t_phase = time.perf_counter()
    cfg = RadZeroConfig(vision=ViTConfig(), align=AlignConfig(), text=TextConfig(),
                        loss=LossConfig(train_impl="fused"))
    cfg_eager = dataclasses.replace(cfg, align=AlignConfig(attn_impl="xla"),
                                    text=TextConfig(fuse_post=False),
                                    loss=LossConfig(train_impl="xla"))
    gen = torch.Generator(device="cuda").manual_seed(seed + 50)
    lora = init_lora(gen, params, LORA_TARGETS, r=8, alpha=32)
    n_ad = sum(t.numel() for ab in lora["adapters"].values() for t in ab.values())
    print(f"lora (phase 6): r 8, alpha 32 on {LORA_TARGETS} of every tower: "
          f"{len(lora['adapters'])} adapters, {n_ad / 1e6:.2f} M parameters")

    batch8 = train_batch(seed + 9, 8, 64, cfg.text.vocab_size, torch.bfloat16)
    with torch.no_grad():
        a = forward_train(params, cfg, batch8, dtype=torch.bfloat16)
        b = forward_train(merge_lora(params, lora), cfg, batch8, dtype=torch.bfloat16)
    same = (torch.equal(a["losses"]["loss"], b["losses"]["loss"])
            and torch.equal(a["vision_tokens"], b["vision_tokens"]))
    print(f"  at init, bf16, 8 images: merged loss {b['losses']['loss'].item():.7f} vs base "
          f"{a['losses']['loss'].item():.7f}, vision tokens {'bit-equal' if same else 'DIFFER'}")
    if not same:
        fail("lora: the merged forward at init differs from the base forward")
    del a, b
    for ab in lora["adapters"].values():  # B off zero: A's gradient is not zero either
        ab["b"].copy_(0.01 * torch.randn(ab["b"].shape, generator=gen, device="cuda"))

    def adapter_grads(loss_of):
        tr = lora_trainable(lora)
        leaves = [t for ab in tr["adapters"].values() for t in (ab["a"], ab["b"])]
        for t in leaves:
            t.requires_grad_(True)
        try:
            loss = loss_of(merge_lora(params, with_trainable(lora, tr)))
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for t in leaves:
                t.requires_grad_(False)
        return loss.detach(), list(grads)

    small = train_batch(seed + 7, 2, 16, cfg.text.vocab_size, torch.float32)
    reset_counters()
    lk, gk = adapter_grads(lambda p: forward_train(p, cfg, small)["losses"]["loss"])
    counts = read_counters()
    n_tower, n_align = cfg.vision.num_hidden_layers, cfg.align.num_hidden_layers
    want = {"fused_preattn_bwd": n_tower + n_align,
            "flash_attention_packed_bwd": n_tower + n_align,
            "fused_postattn_bwd": n_tower + n_align,
            "fused_mpnet_post_bwd": cfg.text.num_hidden_layers, "vlcabs_train_bwd_dq": 1,
            "vlcabs_train_bwd_dtn": 1}
    print(f"  fp32 kernel route's backward launches: "
          f"{ {k: counts[k] for k in want} }")
    if any(counts[k] != v for k, v in want.items()):
        fail(f"lora: the kernel route's backward launches {counts}, expected {want}")

    def eager_loss(p):
        tokens = vit_forward(p["vision_model"], cfg.vision, small["pixel_values"], impl="eager")
        return forward_train(p, cfg_eager, {**small, "tower_tokens": tokens})["losses"]["loss"]

    le, ge = adapter_grads(eager_loss)
    names = [f"{k.split('/')[0]} {k.split('/')[-2]}.{n}"
             for k in lora["adapters"] for n in ("a", "b")]
    worst = {}
    for name, x, y in zip(names, gk, ge):
        share = ((x - y).abs().max() / (2e-4 * y.abs().max() + 1e-7)).item()
        worst[name.split()[0]] = max(worst.get(name.split()[0], 0.0), share)
        if share > 1.0 or not bool(torch.isfinite(x).all()):
            fail(f"lora: adapter gradient {name} of the kernel route disagrees with the eager "
                 f"route ({100 * share:.0f}% of the gate)")
    print(f"  fp32, 2 images: loss kernels {lk.item():.7f} vs eager {le.item():.7f}; worst "
          f"adapter gradient entry by tower, share of the gate 2e-4 max|g| + 1e-7: "
          + ", ".join(f"{k} {100 * v:.1f}%" for k, v in worst.items()))
    if abs(lk.item() - le.item()) > 1e-5 * abs(le.item()) + 1e-6:
        fail("lora: the kernel route's loss disagrees with the eager route's")

    def bf16_loss(p):
        return forward_train(p, cfg, batch8, dtype=torch.bfloat16)["losses"]["loss"]

    first, second = adapter_grads(bf16_loss), adapter_grads(bf16_loss)
    same = torch.equal(first[0], second[0]) and all(
        torch.equal(x, y) for x, y in zip(first[1], second[1]))
    print(f"  bf16, 8 images: loss {first[0].item():.5f}, a second backward "
          f"{'bit-equal' if same else 'DIFFERENT'}")
    if not math.isfinite(first[0].item()) or not same:
        fail("lora: bf16 loss not finite, or a second backward gave other bits")
    with tempfile.TemporaryDirectory() as tmp:
        save_adapter(lora, tmp)
        back = load_adapter(tmp, init_lora(gen, params, LORA_TARGETS, r=8, alpha=32))
    same = (back["r"], back["alpha"]) == (8, 32) and all(
        torch.equal(back["adapters"][k][n], ab[n])
        for k, ab in lora["adapters"].items() for n in ("a", "b"))
    print(f"  save_adapter / load_adapter: {'bit-equal' if same else 'DIFFERENT'}; lora leg "
          f"{time.perf_counter() - t_phase:.1f} s on {card}")
    if not same:
        fail("lora: the adapter round trip changed a bit")


CLI_EVAL_N = 16  # studies of each eval dataset in phase 9 (one scorer batch)
# K1-K12: the training steps (remat), the epoch's eval and the fp32 scorer's K5
PATH_CLI = ("fused_preattn", "flash_attention_packed", "fused_postattn", "fused_mpnet_post",
            "vlcabs_fused", "fused_preattn_bwd", "flash_attention_packed_bwd",
            "fused_postattn_bwd", "fused_mpnet_post_bwd", "vlcabs_train_forward",
            "vlcabs_train_bwd_dq", "vlcabs_train_bwd_dtn")


def _log_rows(out_dir):
    """-> (the loss fields of every log_history.jsonl record with a step, in order; the
    steps of the step records; the epoch record)."""
    rows = [json.loads(line) for line in (out_dir / "log_history.jsonl").read_text().splitlines()]
    losses = [{k: v for k, v in r.items() if "loss" in k or k in ("step", "epoch", "grad_norm")}
              for r in rows if "step" in r]
    epochs = [r for r in rows if "train_samples_per_second" in r]
    steps = [r["step"] for r in rows if "loss" in r and "train_samples_per_second" not in r]
    return losses, steps, epochs[0] if epochs else {}


def _first_step_profile(prof, new_modules) -> dict:
    """cProfile's view of the first training step on the main thread: the seconds inside
    imports, the modules it imported first, and the 12 functions of most own time (a
    call into C, a kernel's launch included, counts as its caller's own time; the
    backward runs on autograd's device thread, so it shows as run_backward's)."""
    import pstats

    st = pstats.Stats(prof).stats
    imports = sum(v[3] for k, v in st.items() if k[2] == "_find_and_load")
    top = sorted(st.items(), key=lambda kv: kv[1][2], reverse=True)[:12]
    return {
        "imports_s": imports,
        "new_modules": len(new_modules),
        "new_packages": sorted({m.split(".")[0] + ("." + m.split(".")[1] if "." in m else "")
                                for m in new_modules})[:20],
        "top_own_s": [[k[2] if k[0] == "~" else f"{Path(k[0]).name}:{k[2]}", v[2]]
                      for k, v in top],
    }


def cold_probe(argv) -> int:
    """``chip_smoke.py --cold-probe <cli arguments>``: radzero_torch.cli.run.main in a fresh
    process, with timers on what such a process pays that the in-process run does not: its
    imports, the CUDA context (made here before main), the kernel library's load, the
    epoch's first batch and each training step (synchronized after it). Prints one JSON
    line of seconds."""
    import cProfile

    t_start = time.perf_counter()
    sys.path.insert(0, str(REPO))
    import torch
    from radzero_torch.cli import run as cli
    from radzero_torch.ops import _build
    from radzero_torch.train import trainer as trainer_mod

    import_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    cuda_s = time.perf_counter() - t0
    spans = {"steps": []}
    load, train, make = _build.load, trainer_mod.RadZeroTrainer.train, trainer_mod.make_train_step

    def timed_load():
        if _build._lib is not None:
            return load()
        t = time.perf_counter()
        try:
            return load()
        finally:
            spans["load"] = (t, time.perf_counter())

    def timed_train(self, *a, **kw):
        spans["train"] = time.perf_counter()
        return train(self, *a, **kw)

    def timed_make(*a, **kw):
        step = make(*a, **kw)

        def timed(*sa):
            first = not spans["steps"]
            prof, before = cProfile.Profile(), set(sys.modules)
            t = time.perf_counter()
            if first:
                prof.enable()
            out = step(*sa)
            torch.cuda.synchronize()
            if first:
                prof.disable()
            spans["steps"].append((t, time.perf_counter()))
            if first:
                spans["profile"] = _first_step_profile(prof, set(sys.modules) - before)
            return out
        return timed

    _build.load, trainer_mod.RadZeroTrainer.train = timed_load, timed_train
    trainer_mod.make_train_step = timed_make
    rc = cli.main(argv)
    t_train, steps = spans.get("train"), spans["steps"]
    load_span = spans.get("load")
    print(json.dumps({
        "rc": rc, "import_s": import_s, "cuda_init_s": cuda_s, "first_step": spans.get("profile"),
        "to_train_s": None if t_train is None else t_train - t_start,
        "kernel_load_s": None if load_span is None else load_span[1] - load_span[0],
        "kernel_load_in_epoch": bool(load_span and t_train and load_span[0] >= t_train),
        "first_batch_s": steps[0][0] - t_train if steps and t_train else None,
        "steps_s": [b - a for a, b in steps],
        "gaps_s": [b[0] - a[1] for a, b in zip(steps, steps[1:])],
    }))
    return 0 if rc == 0 else 1


def phase_cli(seed, card):
    """9, the flagship training entry point: ``python -m radzero_torch.cli.run
    --add_cfg_list radzero <overlay> --train true --inference true --no_report`` in a fresh
    process, then radzero_torch.cli.run.main in this one into a second output directory.
    The overlay points at phase 7's synthetic MIMIC split (320 / 64 PNGs of 1200 x 1000),
    phase 5a's synthetic eval sets (Chexpert, MS-CXR, RSNA; CLI_EVAL_N studies of
    2000-3000 px), phase 8's vocab.txt, and sets num_train_epochs 1 and logging_steps 1;
    the preset is otherwise the flagship's (batch 64, bf16, gradient_checkpointing, buckets
    [16, 32]). Gates: both exit cleanly; the run files and checkpoint-5; log_history's
    losses and each result.json bit-equal between the runs. Returns the launches of the
    in-process run."""
    import logging
    import os
    import tempfile

    import yaml
    from radzero_torch.cli import run as cli
    from radzero_torch.eval import inference as inference_mod
    from radzero_torch.tools import synthetic_eval_data as sd

    t_phase = time.perf_counter()
    tasks = ("classification", "grounding", "segmentation")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        root = tmp / "data"
        t0 = time.perf_counter()
        dataset = mimic_split(root, seed, 320, 64)
        sizes = sd.chest_sizes(CLI_EVAL_N, seed)
        sd.build_images(str(root), n=CLI_EVAL_N, seed=seed, sizes=sizes, compress_level=1,
                        threads=8)
        sd.build_chexpert(str(root), n=CLI_EVAL_N)
        sd.build_mscxr(str(root), n=CLI_EVAL_N, sizes=sizes)
        sd.build_rsna(str(root), n=CLI_EVAL_N, scale=max(1, min(w for _, w in sizes) // 60))
        vocab = tmp / "vocab.txt"
        vocab.write_text("\n".join(checkpoint_vocab([f"There is {c}" for c in CHEXPERT])) + "\n")
        overlay = tmp / "overlay.yaml"
        overlay.write_text(yaml.safe_dump({
            "experiment": {"output_root_dir": str(tmp / "out"), "name": "cli_process"},
            "dataset": dataset,
            "train": {"num_train_epochs": 1, "logging_steps": 1},
            "inference": {"cls_dataset": ["Chexpert"], "det_dataset": ["MS-CXR"],
                          "seg_dataset": ["RSNA"]},
            "model": {"model_config": {"text_config": {
                "pretrained_tokenizer_name_or_path": str(vocab)}}},
        }))
        print(f"cli (phase 9): python -m radzero_torch.cli.run --add_cfg_list radzero "
              f"<overlay> --train true --inference true --no_report; data written in "
              f"{time.perf_counter() - t0:.1f} s")
        argv = ["--add_cfg_list", "radzero", str(overlay), "--train", "true",
                "--inference", "true", "--no_report"]
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = str(REPO)
        out = tmp / "out" / "pt" / "anonymous"
        history = out / "cli_process" / "log_history.jsonl"
        t0 = time.perf_counter()
        with open(tmp / "cli.log", "w") as log:
            proc = subprocess.Popen([sys.executable, "-m", "radzero_torch.cli.run", *argv],
                                    cwd=str(REPO), env=env, stdout=log, stderr=subprocess.STDOUT)
            cold = None
            try:
                while proc.poll() is None:
                    if cold is None and history.exists() and '"step"' in history.read_text():
                        cold = time.perf_counter() - t0
                    if time.perf_counter() - t0 > 400:
                        proc.kill()
                        break
                    time.sleep(0.05)
            finally:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
        run1_s = time.perf_counter() - t0
        if proc.returncode != 0:
            print((tmp / "cli.log").read_text()[-4000:], file=sys.stderr)
            fail(f"cli: python -m radzero_torch.cli.run exited with {proc.returncode}")
        # the fresh process's epoch, taken apart: the same run with timers (cold_probe)
        probe = subprocess.run(
            [sys.executable, str(REPO / "chip_smoke.py"), "--cold-probe", *argv, "--name",
             "cli_probe", "--inference", "false"],
            cwd=str(REPO), env=env, capture_output=True, text=True, timeout=400)
        if probe.returncode != 0:
            print(probe.stdout[-4000:] + probe.stderr[-4000:], file=sys.stderr)
            fail(f"cli: the cold-start probe exited with {probe.returncode}")
        cold_parts = json.loads(probe.stdout.strip().splitlines()[-1])
        probe_epoch = _log_rows(out / "cli_probe")[2]

        timers = {}
        originals = {t: getattr(inference_mod.Inference, t) for t in tasks}

        def timed(task):
            def call(*a, **kw):
                t1 = time.perf_counter()
                try:
                    return originals[task](*a, **kw)
                finally:
                    timers[task] = time.perf_counter() - t1
            return call

        logger = logging.getLogger("radzero_torch")
        handlers, levels = list(logger.handlers), [h.level for h in logger.handlers]
        for h in handlers:  # the run's log goes to its output.log, not to this output
            h.setLevel(logging.WARNING)
        for t in tasks:
            setattr(inference_mod.Inference, t, timed(t))
        try:
            reset_counters()
            t0 = time.perf_counter()
            rc = cli.main(argv + ["--name", "cli_in_process"])
            run2_s = time.perf_counter() - t0
            launches = read_counters()
        finally:
            for t in tasks:
                setattr(inference_mod.Inference, t, originals[t])
            for h, lv in zip(handlers, levels):
                h.setLevel(lv)
            for h in logger.handlers[len(handlers):]:
                logger.removeHandler(h)
                h.close()
        if rc != 0:
            fail(f"cli: main returned {rc}")
        idle = [n for n in PATH_CLI if launches[n] == 0]
        if idle:
            fail(f"cli: the in-process run launched no {idle}")

        runs = {}
        for name in ("cli_process", "cli_in_process"):
            d = out / name
            missing = [p for p in ("output.log", "snapshot/git_diff.patch",
                                   "snapshot/last_commit.json", "snapshot/config.yaml",
                                   "checkpoint-5", "log_history.jsonl")
                       + tuple(f"inference/{t}/result.json" for t in tasks)
                       if not (d / p).exists()]
            if missing:
                fail(f"cli: {name} wrote no {missing}")
            losses, steps, epoch = _log_rows(d)
            if steps != [1, 2, 3, 4, 5] or "eval_loss" not in epoch:
                fail(f"cli: {name}'s step records are {steps}, its epoch record {epoch}")
            runs[name] = (losses, {t: (d / "inference" / t / "result.json").read_bytes()
                                   for t in tasks}, epoch)
        (l1, r1, e1), (l2, r2, e2) = runs["cli_process"], runs["cli_in_process"]
        if l1 != l2:
            fail(f"cli: the runs' log_history losses differ: {l1} vs {l2}")
        diff = [t for t in tasks if r1[t] != r2[t]]
        if diff:
            fail(f"cli: result.json of {diff} differs between the runs")
        results = {t: json.loads(r1[t]) for t in tasks}
    print(f"  both runs exit 0 with output.log, the snapshot, checkpoint-5 and log_history "
          f"steps 1-5; log_history losses ({len(l1)} records) and the 3 result.json files "
          f"bit-equal between the runs; step 5 loss "
          f"{next(r['loss'] for r in l1 if r['step'] == 5 and 'loss' in r):.5f}, "
          f"eval_loss {e1['eval_loss']:.5f}")
    print(f"  results: {json.dumps(results)}")
    print(f"  epoch: {e1['train_samples_per_second']:.2f} samples/s (fresh process), "
          f"{e2['train_samples_per_second']:.2f} (in process), 5 steps of 64; cold start to "
          f"the first step record {'not seen' if cold is None else f'{cold:.1f} s'}; run 1 "
          f"{run1_s:.1f} s, run 2 {run2_s:.1f} s")
    cp = cold_parts
    steps = cp["steps_s"]
    later = sorted(steps[1:])[len(steps[1:]) // 2] if len(steps) > 1 else float("nan")
    load_s = cp["kernel_load_s"]
    print(f"  cold-start probe (a third fresh process, each step synchronized): imports "
          f"{cp['import_s']:.2f} s, CUDA context {cp['cuda_init_s']:.2f} s, main to the "
          f"epoch {cp['to_train_s'] - cp['import_s'] - cp['cuda_init_s']:.2f} s (before the "
          f"epoch); kernel library load "
          f"{'none' if load_s is None else f'{load_s:.3f} s'} "
          f"({'in' if cp['kernel_load_in_epoch'] else 'before'} the epoch); in the epoch: "
          f"the first batch {cp['first_batch_s']:.2f} s, the first step {steps[0]:.2f} s "
          f"against a median {later:.3f} s of steps 2-{len(steps)}, loader waits between "
          f"steps {sum(cp['gaps_s']):.2f} s; its epoch "
          f"{probe_epoch['train_samples_per_second']:.2f} samples/s")
    fs = cp["first_step"]
    print(f"  the probe's first step on the host's main thread (cProfile on, which slows it): "
          f"imports {fs['imports_s']:.2f} s, {fs['new_modules']} modules imported first "
          f"({', '.join(fs['new_packages'])}); own time: "
          + ", ".join(f"{name} {t:.3f} s" for name, t in fs["top_own_s"]))
    print("  eval (in process, fp32, batch 64): " + ", ".join(
        f"{t} {CLI_EVAL_N / timers[t]:.2f} images/s ({timers[t]:.2f} s)" for t in tasks))
    print(f"  launches of the in-process run: {launches}")
    print(f"  phase 9 (cli) {time.perf_counter() - t_phase:.1f} s on {card}")
    return launches


def _keyed_paths(tree, prefix=""):
    """(path, leaf) of a dict / list tree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _keyed_paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _keyed_paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _clone_state(state):
    return {k: _clone(v) if isinstance(v, (list, dict)) else v for k, v in state.items()}


def profile_step(fn):
    """One call of ``fn`` under torch.profiler: device time by kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda k: -k[1])
    total = sum(k[1] for k in kernels)
    names = {"vt": "VL-CABS kernels K10-K12 but their GEMM phases (rz::vt::*)",
             "fa": "attention kernels K2, K7, K13-K16 (rz::fa::*)",
             "bw": "row passes and reduces of K6, K8, K9 (rz::bw::*)",
             "rz": "the GEMMs: K1, K3, K4 and every product of K6, K8, K9, the second "
                   "phases of K10 and K12, K11's dq product (rz::gemm_*, rz::row_layernorm)",
             "torch": "torch ops (everything else)"}
    groups = {v: 0.0 for v in names.values()}
    for name, ms, _ in kernels:
        key = ("vt" if "rz::vt::" in name else "fa" if "rz::fa::" in name
               else "bw" if "rz::bw::" in name
               else "rz" if "rz::" in name else "torch")
        groups[names[key]] += ms
    print(f"  profile of one training step: {total:.1f} ms of device time in "
          f"{sum(k[2] for k in kernels)} kernel launches")
    for key, ms in groups.items():
        print(f"    {ms:8.2f} ms {100 * ms / total:5.1f}%  {key}")
    reduces = [(ms, count) for name, ms, count in kernels if REDUCE in name or REDUCE1 in name]
    print(f"    fixed-order reduces ({REDUCE}, {REDUCE1}): {sum(c for _, c in reduces)} launches, "
          f"{sum(ms for ms, _ in reduces):.2f} ms")
    # the 40 longest, and K15 / K16's kernels by name wherever they rank
    named = [k for k in kernels[40:] if any(n in k[0] for n in SMALL_BIAS)]
    for name, ms, count in kernels[:40] + named:
        print(f"    {ms:8.2f} ms {100 * ms / total:5.1f}%  x{count:<4d} {name[:150]}")


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    if sys.argv[1:2] == ["--cold-probe"]:
        return cold_probe(sys.argv[2:])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also print one training step's kernels by device time")
    args = ap.parse_args()
    if not (REPO / "radzero_torch" / "ops" / "csrc").is_dir():
        print("FAIL: radzero_torch is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    from radzero_torch.ops import _build

    nvcc = _build.find_nvcc()
    nvcc_v = "none" if nvcc is None else subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True).stdout.strip().splitlines()[-1]
    print(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"nvcc {nvcc_v}; {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    print(f"host packages (the JAX CLI reads them; the port needs none): {host_packages()}")

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    nvcc_s = ("no nvcc run: built before from these sources" if _build.build_seconds is None
              else f"nvcc {_build.build_seconds:.2f} s")
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s ({nvcc_s})")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas {line.strip()}")
    check_no_spills(_build.build_log)

    rows = phase_kernels(args.seed)
    serving, params = phase_slice(args.seed, card)
    server = phase_server(args.seed, card, params)
    exported = phase_export(args.seed, card, params, lambda imgs: live_engine_probs(params, imgs))
    scoring = phase_scorer(args.seed, card, params)
    evaluation = phase_eval(args.seed, card, params)
    training, flash_step, bare_step_s = phase_training(args.seed, card, params, args.profile)
    remat_step = phase_remat(args.seed, card, params)
    phase_lora(args.seed, card, params)
    trainer_step = phase_trainer(args.seed, card, params, bare_step_s)
    checkpoint = phase_checkpoint(args.seed, card)
    cli = phase_cli(args.seed, card)

    meta = {
        "K1": ("fused_preattn", "radzero_torch/ops/csrc/gemm_sm90.cu",
               "radzero_tpu/ops/fused_layer.py:92"),
        "K2": ("flash_attention_packed", "radzero_torch/ops/csrc/flash_fwd_sm90.cu",
               "radzero_tpu/ops/fused_layer.py:175"),
        "K3": ("fused_postattn", "radzero_torch/ops/csrc/gemm_sm90.cu",
               "radzero_tpu/ops/fused_layer.py:913"),
        "K4": ("fused_mpnet_post", "radzero_torch/ops/csrc/gemm_sm90.cu",
               "radzero_tpu/ops/fused_layer.py:760"),
        "K5": ("vlcabs_fused", "radzero_torch/ops/csrc/vlcabs_sm90.cu",
               "radzero_tpu/ops/pallas_vlcabs.py:115"),
        "K6": ("fused_preattn_bwd", "radzero_torch/ops/csrc/gemm_sm90.cu",
               "radzero_tpu/ops/fused_layer.py:390"),
        "K7": ("flash_attention_packed_bwd", "radzero_torch/ops/csrc/flash_bwd_sm90.cu",
               "radzero_tpu/ops/fused_layer.py:281"),
        "K8": ("fused_postattn_bwd", "radzero_torch/ops/csrc/gemm_sm90.cu",
               "radzero_tpu/ops/fused_layer.py:568"),
        "K9": ("fused_mpnet_post_bwd", "radzero_torch/ops/csrc/gemm_sm90.cu",
               "radzero_tpu/ops/fused_layer.py:820"),
        "K10": ("vlcabs_train_forward", "radzero_torch/ops/csrc/vlcabs_sm90.cu",
                "radzero_tpu/ops/pallas_vlcabs.py:310"),
        "K11": ("vlcabs_train_bwd_dq", "radzero_torch/ops/csrc/vlcabs_train.cu",
                "radzero_tpu/ops/pallas_vlcabs.py:381"),
        "K12": ("vlcabs_train_bwd_dtn", "radzero_torch/ops/csrc/vlcabs_sm90.cu",
                "radzero_tpu/ops/pallas_vlcabs.py:403"),
        "K13": ("flash_attention", "radzero_torch/ops/csrc/flash_fwd_sm90.cu",
                "radzero_tpu/ops/flash_attention.py:122"),
        "K14": ("flash_attention_bwd", "radzero_torch/ops/csrc/flash_bwd_sm90.cu",
                "radzero_tpu/ops/flash_attention.py:214"),
        "K15": ("flash_attention_bias", "radzero_torch/ops/csrc/flash_bias_small.cu",
                "radzero_tpu/ops/flash_attention.py:333"),
        "K16": ("flash_attention_bias_bwd", "radzero_torch/ops/csrc/flash_bias_small.cu",
                "radzero_tpu/ops/flash_attention.py:470"),
    }
    # launches: the serving burst's count, the HTTP burst's, one run of each exported
    # program, the scorer run's, the eval suite's, one default training step's, one
    # flash training step's, one remat step's (align "save_attn"), one trainer step's,
    # the converted checkpoint's 4 requests and the in-process CLI run's; each path was
    # driven with every count at 0 and read right after
    from radzero_torch.ops import registry

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "registered_op": f"radzero::{name}" if name in registry.calls else None,
         "launches": serving[name] + server[name] + exported[name] + scoring[name]
         + evaluation[name] + training[name] + flash_step[name] + remat_step[name]
         + trainer_step[name] + checkpoint[name] + cli[name],
         "launches_serving": serving[name], "launches_server": server[name],
         "launches_export": exported[name], "launches_scorer": scoring[name],
         "launches_eval": evaluation[name],
         "launches_training_step": training[name],
         "launches_flash_training_step": flash_step[name],
         "launches_remat_step": remat_step[name],
         "launches_trainer_step": trainer_step[name],
         "launches_checkpoint": checkpoint[name], "launches_cli": cli[name], **rows[k]}
        for k, (name, src, rep) in meta.items()
    ]
    k11 = next(k for k in kernels if k["name"] == "vlcabs_train_bwd_dq")
    k11["backward_k11_k12"] = rows["K11+K12"]  # vlcabs_train_bwd: K11 and K12 at once
    idle = [k["name"] for k in kernels if k["launches"] == 0]
    if idle:
        fail(f"kernels never launched on a main path: {idle}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
