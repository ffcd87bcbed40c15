#!/usr/bin/env python3
"""Smoke run of bpbreid_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout and
drives the port's paths once at full width: BPBReID with an HRNet-W32
backbone at 384x128, five parts (five_v), GWAP, 512-d after-pooling
reduction, 751 classes, bf16, seeded random weights. The serving path
runs the fused attention-pool kernel (K2, ``use_pallas_pooling``,
multires off), with ``bn_apply`` in every eval-mode BN; the train step
runs the default multires pooling with the BN kernels in every
train-mode BN (forward ``bn_stats`` = K3a and ``bn_apply``, backward
``bn_grad_stats`` = K3b and ``bn_dx``); the
BasicBlock-chain kernel (K1), which no model path calls, runs on the
serving model's 26 HRNet branch chains (bf16: an implicit-GEMM conv on
the tensor cores, two launches a block); retrieval runs at Market-1501
and Market-1501 + 500k distractors scale. Phases:

1. build every kernel (one nvcc per source, started together), and count
   the tensor-core instructions (HMMA) in K1's SASS;
2. each kernel against its plain PyTorch version on the card, at the
   main-path shapes and at ragged shapes, with timings (CUDA events:
   eager, and for K2, the reported K3 input and K1 also the device time
   of the kernel and of its library call from a CUDA graph of 20 calls;
   K2 at f32 and at bf16, the dtype the models hand it);
3. the serving run: eval_preprocess -> model -> test embeddings ->
   normalize -> part-based distance -> CMC/mAP over seeded query and
   gallery batches of 64, with the kernels' launch counts (one bn_apply
   for each eval-mode BN of a step), the forward's throughput and a
   torch.profiler breakdown of three eval steps;
   3b. forward hooks capture the input and output of the serving model's
   26 branch chains on one query batch; each chain, folded
   (``fold_basicblock_chain``), goes through K1 and is held against the
   chain's output, with K1's launch count (208: 2 a block);
4. the same weights on the plain pooling path and on the default
   multires path, held against phase 3;
   8a. phase 3's ``evaluate`` above ``device_ranking_threshold`` (forced
   to 1: the query-chunked device path) against its host path, on the
   same features;
5. the same port model in f32 on the card and on the CPU at a small
   input (TF32 off), and K1 on that model's 9 branch chains;
6. the train run: ``engine.forward_backward`` (augment -> train-mode
   forward -> GiLt + BPA -> backward -> Adam) on a batch of 16
   identities x 4 instances, 3 warm-up and 10 timed steps with fresh
   augmentation draws and the BN kernels' launch counts (two forward and
   two backward for each train-mode BN); then 20 steps on the one batch
   with one set of draws, whose loss must fall; and a torch.profiler
   breakdown of three steps;
   6b. the BN kernels at each distinct BN input of the train step
   (recorded by forward hooks in phase 6), with their launches a step,
   bounds and library calls, and the whole BN forward and backward
   against ``F.batch_norm``;
7. one small f32 train step on the card and on the CPU (TF32 off):
   loss, gradients, updated parameters and BN statistics;
8. large-gallery retrieval on seeded features ``[N, 6, 512]`` with
   planted identities, made on the card: (b) 3,368 queries against
   19,732 gallery images, the chunked path (threshold 1) against the
   host ranking, per-part table on; (c) the same queries against 515,913
   gallery images (496,181 distractors), the chunked path on its own,
   its first chunk's counting ranker against the full sort, with the
   seconds, the seconds per chunk and the peak memory;
9. the train/test CLI, ``scripts.main.main(argv)`` in-process, with the
   Market-1501 train config (HRNet-W32, 384x128, five_v, bf16, batch 64)
   on a registered synthetic dataset of 16 identities x 3 cameras x 4
   images of 128x64, which the loader upsamples (3 steps an epoch, 192
   query and 384 gallery images); every launch count is set to 0 just
   before each run and read just after:
   (a) two epochs and the final test with a checkpoint, the config as
   shipped (``test.visrank`` on): every step launches the BN kernels
   phase 6 counts (and as many as forward hooks count train-mode BNs),
   the eval batches one bn_apply per eval-mode BN; the ranking grids (10
   queries x top 10) decode with the port's ``read_image`` to (topk+1) x
   (P+1) cells with a ``tEXt`` title each, and their attention maps'
   ``eval_step`` launched one bn_apply per eval-mode BN of its two padded
   batches a figure; the first prefetched batch equals the loader's host
   batch bit for bit and the first loss equals ``forward_backward`` on it
   (1e-5 relative); (b)-(d) run without visrank;
   (b) a test-only run from (a)'s checkpoint gives (a)'s CMC and mAP
   (1e-6); (c) a test-only run through K2 (fused pooling, multires off)
   launches it once per eval batch and no train-mode BN kernel; (d) one
   epoch and the final test on a ResNet-50 backbone, finite losses and
   the BN launches of its train-mode BNs;
10. the inference path, with the Market-1501 test config
   (``configs/bpbreid/bpbreid_market1501_test.yaml``: HRNet-W32,
   384x128, five_v, bf16, batch 64) and the serving pooling (K2):
   (a) a torchreid-format file of a seeded model with 751 classes
   (``module.`` prefixes, ``num_batches_tracked``, a ``state_dict``
   wrapper, plain ``epoch`` / ``rank1`` / ``config``) as
   ``model.load_weights`` of a test-only CLI run on phase 9's set: every
   tensor but the identity classifiers (16 classes here) equals the
   file's, the discarded keys are those classifiers, and CMC and mAP
   equal an in-process test of the source model (1e-6); an HRNet
   ImageNet-format file (the backbone, a fake ``classifier.*`` head)
   loads every backbone tensor at a training start with
   ``model.pretrained``; (b) the ``FeatureExtractor`` on 3 batches of 64
   arrays of mixed sizes (80x40 to 400x150): equal to ``eval_step`` on
   the resized batch (1e-6), one ``bn_apply`` per eval-mode BN and one
   K2 launch a batch, images/s by CUDA events; (c) ``--inference-enabled``
   on 192 PNG crops written by the script's own encoder: the saved
   arrays have their shapes and equal the extractor's outputs (1e-6);
   (d) ``test.rerank`` and ``test.save_features``: CMC and mAP equal
   ``re_ranking`` on the CPU copy of the distance matrices recomputed
   from ``features.npz`` (1e-6), which holds the engine's features, and
   the writer's statistics equal float64 CPU reductions (1e-5);
11. the PCB path: (a) ``configs/bpbreid/pcb_market1501_train.yaml`` as
   shipped (six horizontal stripes, no pixel classifier, the
   materialized 1920-channel map, HRNet-W32 at full depth, 384x128, bf16,
   batch 64, visrank on) through ``scripts.main.main`` on phase 9's set,
   two epochs and the test: the BN launches of every step against the
   model's kernel-backed BNs (those of streams that feed no loss get no
   backward), K2 never, the ranking grids checked as in 9a; (b) BoT
   (``build_model('bot')``: one stripe) at full width, a train step and
   an eval batch with their BN launches; (c) amsgrad, rmsprop and radam
   on the PCB model's gradients of one card step: the card's update
   against the same update on the CPU copy (within 1e-6 of the update's
   size beyond one float32 ulp of the parameter), the second step's
   kernel launches (torch.profiler), and 20 steps on one batch whose last 3
   losses average below the first 3; (d) the ``after_pooling_with_dropout``
   model: eval mode bit-equal to the model without dropout, the same
   generator seed the same mask, kept entries doubled, a kept share of
   0.5 +- 0.02 at 512 dimensions;
12. calibrated int8 eval (``test.int8``, JAX's defaults) on the serving
   model: (a) ``conv_s8`` bit-equal to its plain version at every
   distinct int8 conv shape of a batch and at ragged ones (Cin 3 and 40,
   Co 5 and 130, odd H and W, stride 2; bf16 and f32 with a bias), and
   ``quantize_s8`` bit-equal (per-tensor and per-channel, NCHW and
   channels-last), with their times (eager, and device: CUDA graphs),
   bounds and library calls (``F.conv2d`` bf16; ``torch._int_mm`` beside a 1x1
   conv), and a per-shape table: for each ``conv_s8`` and
   ``quantize_s8`` call shape of an int8 step (recorded on one more
   step), its launches a step, eager and device ms, bound, cuDNN's bf16
   conv and ``torch._int_mm`` (1x1), the sums launches x ms beside the
   profiler's device time a step (``int8_bench.py`` prints the same
   table without the model, for two checkouts in one call); (b)
   calibration on 4 batches, then an int8 eval step launches one
   ``conv_s8`` per quantized PConv (counted from the model before the
   run), ``quantize_s8``, one ``bn_apply`` per eval-mode BN and one K2,
   and runs 3 cuDNN convs (the float stem and the pixel classifier); a
   profile of three int8 and three bf16 steps; the int8 step's time
   against the bf16 step's (CUDA events, interleaved), peak memory, the
   ``bn_foreg`` cosine to bf16 (min at least 0.99) and the ``parts``
   visibility agreement; (c) a small f32 int8 model on the card against
   the CPU on the CPU's calibration (batch norms that normalize exactly):
   embeddings within 1e-3, the s8 values of the branch outputs counted;
   (d) a ``FeatureExtractor`` batch over the calibrated engine equal to
   its int8 ``eval_step``, and the test CLI with ``test.int8 True`` beside
   its bf16 test;
13. Torchreid's global-embedding engines (``engine/image/``) through
   ``scripts.main.main`` on a registered synthetic set of 32 identities
   at 256x128 (one epoch of 5-6 steps of 64, then the test on 384 query
   and 768 gallery images), bf16, seeded weights, every launch count set
   to 0 just before each run and read just after: (a) ``osnet_x1_0``
   with torchreid's OSNet recipe (softmax, label smoothing, amsgrad at
   0.0015, cosine, random flip, classifier-only epochs); (b)
   ``resnet50_ibn_a`` with batch-hard triplet (margin 0.3) + CE on 16
   ids x 4. Each: the step ms (host clock between step entries) and
   images/s, the BN launches of every step and of the eval batches
   against the model's ``FastBatchNorm`` count (and forward hooks), 20
   steps on one batch whose loss must fall, a profile of three steps
   (busy share, the depthwise convs' kernels), the depthwise convs of a
   step timed alone, and one f32 step at 4 ids x 4 on the card against
   the CPU (TF32 off; phase 7's tolerances); (c) the flagship BPBReID
   config on ``fastreid_resnet_ibn_nl`` at 384x128, batch 64: one eval
   batch through K2 (fused pooling, multires off), K2 held against its
   plain version on the ``[64, 2048, 24, 8]`` map it was given and timed,
   then one train step, each with its launches and IBN copies; (d) each
   distinct BN input of (a) and (b)'s train step against the plain
   versions, with times against the byte bound and ``F.batch_norm``, as
   phase 6b.

14. the video path and the last data options, every launch count set
   to 0 just before each run and read just after: (a) ``data.type video``
   through ``scripts.main.main`` with torchreid's documented video recipe
   (``resnet50``, softmax, 15 frames sampled evenly, 3 tracklets a batch:
   45 frames a step, random sampler, random flip, adam 0.0003) on a
   registered synthetic set of 16 identities x 2 cameras, tracklets of 24
   frames at 256x128, bf16: one epoch (10 steps) and the test (22 padded
   batches of 3 tracklets), the step ms (host clock between step
   entries) and frames/s, the BN launches of every step and of the eval
   batches against the model's ``FastBatchNorm`` count (53), 20 steps on
   one batch whose loss must fall, a profile of three steps (busy
   share), one f32 step of 4 tracklets x 4 frames on the card against
   the CPU (phase 7's tolerances), then 3 ``VideoTripletEngine`` steps on
   batches of 2 identities x 2 tracklets with their BN launches, and the
   BN kernels held against their plain versions (as phase 2 holds them)
   and timed at each distinct BN input of the softmax and the triplet
   step (45 and 60 frames), as phase 13d; (b) the
   shipped ``configs/bpbreid/bpbreid_occ_duke_train.yaml`` with
   ``masks.dir isp_6_parts`` and ``data.transforms ['rc', 're', 'ro']``
   (HRNet-W32, 384x128, batch 64) on a fabricated Occluded-Duke tree whose
   mask files carry their own background channel: two train steps and
   the test with the BN launches of every step against the model's
   kernel-backed BNs, the channels of the first batch's masks on disk
   (6) and after the mask chain on the card (7: JAX's second
   background), the ``ro`` transform's host ms a batch of 64, then
   a test-only run through K2 (fused pooling, multires off), one K2 a
   test batch; (c) BPBReID on ``resnet50`` with ``dim_reduce
   before_and_after_pooling``, f32 at 256x128: one eval batch (1e-3) and
   one train step (phase 7's tolerances) on the card against the CPU;
   (d) a test-only CLI run (``resnet50``, softmax engine) on a fabricated,
   extracted CUHK03 tree (labeled, new protocol): one ``bn_apply`` per
   ``FastBatchNorm`` a batch, mAP and rank-1 finite, and the BN kernels
   held against their plain versions and timed at each distinct BN input
   of the first eval batch.
15. the rest of the model zoo (PCB, PVPM, the legacy Torchreid zoo,
   HACNN), every launch count set to 0 just before each run and read
   just after: (a) each of the 35 registry names beside the ones above
   built on the card (``build_model``, bf16, seeded weights) and one eval
   batch at its input size (256x128, MuDeep's fixed size; HACNN's fixed
   160x64; PVPM with pose maps at 64x32), 64 images: one ``bn_apply`` for each
   FastBatchNorm call and no other kernel (PCB's ``conv5`` and PVPM's
   ``em`` heads are train-only, HACNN's ``local_conv<b>`` runs once a
   region), finite outputs, the batch's ms; (b) the image engines through
   ``scripts.main.main`` on phase 13's set: ``pcb_p6`` with the softmax
   engine at 384x128 (16 ids x 4, the label-smoothed CE averaged over the
   six strips) and ``hacnn`` with the triplet engine at 160x64 (both
   heads): the step ms (host clock between step entries) and images/s,
   the BN launches of every step and eval batch against the model's
   FastBatchNorm calls, mAP and rank-1 finite, 20 steps on one batch
   whose loss must fall, a profile of three steps, one f32 step at 4 ids
   x 4 on the card against the CPU (TF32 off, PCB's dropout masks fixed,
   HACNN's hard attention moved off the pixel centres, images of varied
   contrast and brightness; phase 7's tolerances); (c) one bf16 train step of 16 ids x 4 for the first
   constructor of every other module (PVPM's ``pose_p4s`` at 384x128 with
   pose maps, at the module level; the others through the softmax engine
   at 256x128) with its BN launches, and the flagship BPBReID config on
   ``nasnetamobile`` (a 1056-channel map, no multiple of 512): one eval
   batch through K2, held against its plain version at ``[64, 1056, 12,
   4]`` and timed against its bound and the library call, then a train
   step; (d) the four BN kernels against their plain versions (at the
   BN's own eps: 1e-3 for InceptionV4, Inception-ResNet-V2 and NASNet) at
   every distinct BN input of (b)'s and (c)'s steps, the largest four
   timed as phase 6b.
16. the debug and test figures, the native ranker and the tools, every
   launch count set to 0 just before each run and read just after: (a)
   the flagship train config through ``scripts.main.main`` on phase 9's
   crops with a fourth camera (16 ids x 4 cameras x 4 images): one epoch
   of 4 steps with ``train.batch_debug_freq 2`` and the test with
   ``test.vis_embedding_projection``: the step ms, each debug forward's
   ms and launches (one ``bn_apply`` per eval-mode BN, no K2 under
   multires), the steps' BN launches without it (phase 6's), the test's,
   and the figures (4 feature maps, the triplet grid, the projection,
   the two barplots, whose ``tEXt`` values are the writer's statistics);
   then a test-only run from its checkpoint through K2 (one K2 a test
   batch) and one debug forward on that engine with one feature map
   (one K2, one ``bn_apply`` per eval-mode BN, the model back in train
   mode); (b) phase 8b's host
   distance matrix (3,368 x 19,732) ranked by the native C++ ranker and
   by the numpy path: CMC and mAP within 1e-6, their seconds beside 8b's
   host path (which the native ranker now runs); (c) (a)'s model saved as
   a torchreid ``.pth`` holding its test's rank-1 and mAP and its config,
   then ``tools.reproduce.main`` with ``--max-delta 1e-6``: exit code 0;
   (d) ``compute_model_complexity`` of the flagship at 384x128 (its
   parameters all read by the eval forward), ``tools/profile_summary.py``
   on a Chrome trace of 3 train steps within 1 % of the profiler's own
   CUDA total, and a two-trial ``GridSearch`` on the resnet18 smoke config
   through ``HyperParameterOptimizer`` (one epoch each, its
   ``hpo_results.json``).

17. data parallelism on ``torch.distributed`` (``parallel/``), every
   launch and collective count set to 0 just before each run and read
   just after: (a) ``bn_apply_sums`` (the cross-rank batch norm's forward
   from all-reduced sums: the epilogue and the normalize in one launch)
   on the summed sums of two equal slices with the global count, and
   ``bn_dx`` with the global count, against their plain versions at each
   distinct BN input of phase 6's step (the same bits over two calls),
   and ``bn_apply_sums`` timed beside ``bn_apply`` alone on the same
   input, its bound and SyncBatchNorm's two library calls; (b) three
   flagship train steps (HRNet-W32, 384x128, five_v, bf16, batch 64)
   through ``distribute_engine`` on a one-rank NCCL process group
   (``bn_stats`` sums, ``all_reduce``, ``bn_apply_sums``; backward
   ``bn_grad_stats``'s sums twice, ``all_reduce`` of the copy in place,
   ``bn_dx`` with the count) against the one-process steps on the same
   batch and draws (step 1's loss, gradients and state at phase 7's
   tolerances), bit-equality reported, the third step of each run
   profiled (device kernels, busy share);
   (c) 2 gloo ranks on ``cuda:0`` (NCCL refuses two ranks on one GPU),
   spawned: 2 x 32 images against the one-process 64-image step (the
   loss), 20 steps on the one batch at phase 7's depth (the flagship's
   width) whose loss falls, the ranks' parameters and BN statistics
   bit-equal (sha256) after the full-depth step and after the 20, each
   rank's BN launches (``bn_apply_sums``, no plain ``bn_apply`` and no
   ``bn_finalize``) and
   ``all_reduce`` calls a step, and phase 7's
   small f32 step held to phase 7's tolerances against the one-process
   step; (d) in the same ranks, Market-1501-size features (phase 8b's
   recipe, 3,368 queries, a gallery of 19,733 padded to 19,734):
   ``sharded_bp_distance`` and ``sharded_cmc_map`` against the
   one-process distances (1e-5 relative) and ``cmc_map`` (1e-6), and the
   engine's ``evaluate`` under the mesh. A failed collective or a rank
   that dies fails the run.

18. grouped dispatch through CUDA graphs (``engine/graphs.py``), every
   launch count set to 0 just before 18a and read just after 18b:
   (a) the flagship train config (HRNet-W32, 384x128, five_v, bf16,
   batch 64, capturable Adam): k = 8 steps through
   ``forward_backward_multi`` (an eager step, a capture and its replay,
   six replays) against 8 eager steps from the same state, run twice,
   all with cuDNN's deterministic algorithms:
   the losses, parameters, BN running statistics, Adam's state and the
   generator's state bit-equal wherever the two eager runs are, else
   within phase 7's tolerances or 4 times the eager runs' own
   difference; 24 steps on one batch through a graph without
   augmentation whose loss falls; the step ms of graph and eager
   (median of 3 groups of 8) and, from ``torch.profiler``, the device
   kernels, the host's kernel-launch calls and ``cudaGraphLaunch`` calls
   a step and the busy share (8 graph steps, 3 eager ones); (b) the serving config (K2): 10 batches of
   64 (the last half padding) through grouped eval
   (``batches_per_dispatch`` 8: a group of 8, a trailing group of 2)
   against per-batch eval, float and int8: features, visibility and
   pixel accuracy bit-equal, and the images/s of each; (c)
   ``tools/bench_train.py`` at its defaults with ``--iters 5``, its
   record printed.

Any failed check exits non-zero and prints no result. On success the
last lines are the GPU's name and power limit (nvidia-smi), the
throughput line, the CLI line (phase 9), the inference line (phase 10),
the PCB line (phase 11), the int8 line (phase 12), the global line
(phase 13), the video line (phase 14), the zoo line (phase 15), the
figures line (phase 16), the dp line (phase 17), the graphs line
(phase 18), the kernels line
(launches: the BN kernels' in run 9a, phase 10, phase 11a-b, phase 13,
phase 14, phase 15, phase 16, phase 17b and phase 18
(``bn_apply_sums``: 17b alone), K2's in run
9c, phase 10, phase 13c, phase 14b, phase 15c, phase 16a and phase 18b,
each replay of a CUDA graph counting the launches its capture made,
K1's in phase 3b, ``conv_s8`` and ``quantize_s8``'s in phase 12's int8
step, extractor batch and CLI test) and the result line
``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``. Needs one CUDA card.
"""
import collections
import json
import os
import re
import statistics
import struct
import subprocess
import sys
import time
import types
import zlib

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {'float32': 67e12, 'bfloat16': 989e12}   # f32 SIMT, bf16 TC
BATCH = 64
HEIGHT, WIDTH = 384, 128
N_QUERY_BATCHES, N_GALLERY_BATCHES = 2, 4
N_IDS = 48
SEED = 0
# train batch: identities x instances
TRAIN_IDS, TRAIN_INSTANCES = 16, 4
TRAIN_WARMUP, TRAIN_TIMED, TRAIN_LEARN = 3, 10, 20
LR, WEIGHT_DECAY = 3.5e-4, 5e-4
# K3 at the train path's BN inputs: ([shape], channel_dim), NCHW maps
# (stem, layer1 Bottleneck output, the four HRNet branches) and the
# feature-last BNs (BNNeck [64, 512], parts dim-reduce [64*5, 512])
K3_MAIN_SHAPES = [((BATCH, 64, 192, 64), 1), ((BATCH, 256, 96, 32), 1),
                  ((BATCH, 32, 96, 32), 1), ((BATCH, 64, 48, 16), 1),
                  ((BATCH, 128, 24, 8), 1), ((BATCH, 256, 12, 4), 1),
                  ((BATCH, 512), -1), ((5 * BATCH, 512), -1)]
# odd C, odd H*W, A = 1, a tiny feature-last
K3_RAGGED_SHAPES = [((3, 33, 7, 5), 1), ((1, 32, 96, 32), 1),
                    ((2, 5, 13, 1), 1), ((7, 3), -1)]
# the row of the kernels line: the largest BN input of the step
K3_REPORT = ((BATCH, 256, 96, 32), 'torch.bfloat16')
K3_SOURCE = 'bpbreid_tpu_torch/ops/cuda/bn_stats.cu'
# K1 at HRNet-W32's branch chains at 384x128 (4 BasicBlocks each) and
# ragged maps: ((N, H, W, C), blocks)
K1_MAIN_SHAPES = [((BATCH, 96, 32, 32), 4), ((BATCH, 48, 16, 64), 4),
                  ((BATCH, 24, 8, 128), 4), ((BATCH, 12, 4, 256), 4)]
K1_RAGGED_SHAPES = [((1, 5, 3, 8), 1), ((2, 1, 1, 32), 2),
                    ((2, 2, 1, 32), 3), ((3, 7, 5, 33), 2)]
K1_REPORT = ((BATCH, 96, 32, 32), 'torch.bfloat16')
K1_SOURCE = 'bpbreid_tpu_torch/ops/cuda/conv_chain.cu'
K1_REPLACES = 'bpbreid_tpu/ops/pallas/conv_chain.py:86'
# HRNet-W32 has 2 + 4 x 3 + 3 x 4 branch chains (models/hrnet.py)
HRNET_W32_CHAINS = 26
# phase 8: Market-1501 test split (3,368 queries, 19,732 gallery images,
# 750 identities) and Market-1501 + 500k distractors (515,913 gallery)
MARKET_QUERY, MARKET_GALLERY, MARKET_IDS = 3368, 19732, 750
MARKET_500K_GALLERY = 515913
BN_KERNELS = ('bn_stats', 'bn_apply', 'bn_grad_stats', 'bn_dx')
# the CUDA kernels of bn_stats.cu, for the profiles' BN device time
BN_KERNEL_SYMBOLS = ('reduce_rows_kernel', 'reduce_cols_kernel',
                     'ewise_rows_kernel', 'ewise_cols_kernel')
# K3 alone: the reductions of bn_stats and bn_grad_stats
K3_KERNEL_SYMBOLS = BN_KERNEL_SYMBOLS[:2]
# the kernels of conv_s8.cu, for the profiles' int8 device time
INT8_KERNEL_SYMBOLS = {'conv_s8': ('conv_s8_kernel',),
                       'quantize_s8': ('quantize_nchw_kernel',
                                       'quantize_nhwc_kernel')}
# bn_apply and bn_dx take the elementwise code that XLA fused around the
# sums on the TPU (bpbreid_tpu/models/common.py)
K3_REPLACES = {
    'bn_stats': 'experiments/pallas_bn_v2.py:55 (K3a)',
    'bn_apply': 'experiments/pallas_bn_v2.py:55 (K3a, second pass; '
                'bpbreid_tpu/models/common.py:191)',
    'bn_grad_stats': 'experiments/pallas_bn_bench.py:82 (K3b)',
    'bn_dx': 'experiments/pallas_bn_bench.py:82 (K3b, second pass; '
             'bpbreid_tpu/models/common.py:211)'}


def log(*args):
    print(*args, flush=True)


def gpu_name_and_power_limit():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sass_count(library, opcode):
    """Instructions of ``opcode`` in a built library's SASS (cuobjdump,
    from the CUDA toolkit); None where cuobjdump is missing."""
    for tool in ('cuobjdump', '/usr/local/cuda/bin/cuobjdump'):
        try:
            out = subprocess.run([tool, '-sass', str(library)],
                                 capture_output=True, text=True, timeout=120,
                                 check=True).stdout
        except FileNotFoundError:
            continue
        return len(re.findall(r'\b{}\b'.format(opcode), out))
    return None


def time_ms(fn, torch, warmup=3, iters=10, repeats=5):
    """Median over ``repeats`` of the mean time of ``iters`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def attention_pool_library(features, logits):
    """The nearest stock PyTorch calls for K2: softmax, bmm, sum, amax."""
    import torch
    n, d = features.shape[:2]
    k1 = logits.shape[1]
    probs = torch.softmax(logits.reshape(n, k1, -1).float(), dim=1)
    num = torch.bmm(probs.to(features.dtype),
                    features.reshape(n, d, -1).transpose(1, 2))
    return num, probs.sum(dim=-1), probs.amax(dim=-1)


def attention_pool_bound_ms(features, logits):
    n, d, h, w = features.shape
    k1 = logits.shape[1]
    nbytes = (features.numel() * features.element_size()
              + logits.numel() * logits.element_size()
              + (n * k1 * d + 2 * n * k1) * 4)
    flops = 2.0 * n * h * w * d * k1
    peak = PEAK_FLOPS[str(features.dtype).replace('torch.', '')]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                 else 'operations')


def phase_kernels(torch):
    """K2 against its plain version at the main-path and ragged shapes."""
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    # (N, D, H, W, K+1, feature dtype); logits are bf16 as on the path
    shapes = [(BATCH, 1920, 96, 32, 6, torch.float32),
              (BATCH, 1920, 96, 32, 6, torch.bfloat16),
              (2, 40, 7, 1, 3, torch.float32),
              (3, 100, 96, 32, 37, torch.bfloat16),
              (2, 1920, 7, 1, 6, torch.bfloat16),
              (4, 40, 96, 32, 37, torch.float32),
              (1, 100, 13, 11, 64, torch.float32),
              # K+1 = 64 in sub-chunks of pixels, and in chunks of channels
              (2, 500, 96, 32, 64, torch.bfloat16),
              (132, 500, 8, 8, 64, torch.bfloat16)]
    # f32 sums over up to 3072 pixels in another order than the plain
    # version: tolerance relative to the largest output magnitude
    rows, failures = [], []
    for n, d, h, w, k1, dt in shapes:
        feats = torch.randn(n, d, h, w, device='cuda', generator=gen).to(dt)
        logits = (3 * torch.randn(n, k1, h, w, device='cuda',
                                  generator=gen)).to(torch.bfloat16)
        row, failed = k2_row(torch, feats, logits,
                             timed=(h * w, d) == (96 * 32, 1920))
        failures += failed
        log('K2', json.dumps(row))
        rows.append(row)
        del feats, logits
    if failures:
        raise AssertionError('\n'.join(failures))
    return rows


def k2_row(torch, feats, logits, timed=True):
    """K2 against its plain version on ``feats``, ``logits`` (f32 sums
    over the pixels in another order: 2e-5 of the largest output
    magnitude), with its times, the plain version's and the library
    call's (CUDA events: eager, and ``device_ms`` from a CUDA graph of 20
    calls) and its bound when ``timed``. Returns the row and the failed
    checks."""
    from bpbreid_tpu_torch.ops.cuda.pooling import (attention_pool_reference,
                                                    fused_attention_pool)
    rtol = 2e-5
    got = fused_attention_pool(feats, logits)
    torch.cuda.synchronize()
    want = attention_pool_reference(feats, logits)
    errs, failures = [], []
    for name, a, b in zip(('num', 'den', 'vismax'), got, want):
        err = (a - b).abs().max().item()
        tol = rtol * b.abs().max().item() + 1e-6
        errs.append(err)
        if not (err <= tol) or not torch.isfinite(a).all():
            failures.append('K2 {} at {}: err {} > tol {}'.format(
                name, tuple(feats.shape) + (logits.shape[1],
                                            str(feats.dtype)), err, tol))
    row = {'shape': list(feats.shape) + [logits.shape[1]],
           'dtype': str(feats.dtype), 'max_abs_err': max(errs),
           'errs': errs}
    if timed:
        row['ms'] = time_ms(lambda: fused_attention_pool(feats, logits),
                            torch)
        row['plain_ms'] = time_ms(
            lambda: attention_pool_reference(feats, logits), torch)
        row['library_ms'] = time_ms(
            lambda: attention_pool_library(feats, logits), torch)
        row['device_ms'] = graph_ms(
            torch, lambda: fused_attention_pool(feats, logits))
        row['library_device_ms'] = graph_ms(
            torch, lambda: attention_pool_library(feats, logits))
        row['bound_ms'], row['bound_by'] = attention_pool_bound_ms(
            feats, logits)
    return row, failures


def _nc(x, cd):
    """``x`` in the ``[N, C, ...]`` layout that torch's batch-norm calls
    read (feature-last ``[..., C]`` as ``[M, C]``)."""
    return x if cd == 1 else x.view(-1, x.shape[-1])


def _bn_operands(torch, x, dy, cd, gen, eps=1e-5):
    """Weight, bias and running statistics for one BN input, and the
    statistics and backward sums that the later kernels read, from the
    kernels themselves (``eps``: the BN's own)."""
    from bpbreid_tpu_torch.ops.cuda.batchnorm import (bn_grad_stats,
                                                      bn_stats, channel_view)
    a, c, b = channel_view(x.shape, cd)
    o = {'a': a, 'c': c, 'b': b,
         'w': 1 + 0.2 * torch.randn(c, device='cuda', generator=gen),
         'bias': 0.3 * torch.randn(c, device='cuda', generator=gen),
         'rm': 0.1 * torch.randn(c, device='cuda', generator=gen),
         'rv': 0.5 + torch.rand(c, device='cuda', generator=gen)}
    o['eps'] = eps
    o['st'] = bn_stats(x, o['w'], eps, cd, sums=True)
    o['g'] = bn_grad_stats(dy, x, o['st'][0], o['st'][2], cd)
    return o


def _bn_calls(torch, x, dy, cd, o):
    """Per BN kernel: (kernel call, plain call, the one PyTorch call that
    computes the same function, bytes it must move, f32 operations)."""
    from bpbreid_tpu_torch.ops.cuda.batchnorm import (
        bn_apply, bn_apply_reference, bn_dx, bn_dx_reference, bn_grad_stats,
        bn_grad_stats_reference, bn_stats, bn_stats_reference)
    mean, _, rstd, scale = o['st'][:4]
    sum_dy, sum_dy_xhat = o['g']
    w, bias, c, n = o['w'], o['bias'], o['c'], x.numel()
    rm, rv = o['rm'].clone(), o['rv'].clone()
    nx, ndy = n * x.element_size(), n * dy.element_size()
    xl, dyl = _nc(x, cd), _nc(dy, cd)
    count = torch.full((1,), o['a'] * o['b'], dtype=torch.int32,
                       device='cuda')
    sum_dy_xmu = sum_dy_xhat / rstd
    return {
        'bn_stats': (
            lambda: bn_stats(x, w, 1e-5, cd, rm, rv),
            lambda: bn_stats_reference(x, w, 1e-5, cd, rm, rv),
            lambda: torch.batch_norm_stats(xl, 1e-5),
            nx + 9 * c * 4, 3.0 * n),
        'bn_apply': (
            lambda: bn_apply(x, mean, rstd, w, bias, cd),
            lambda: bn_apply_reference(x, mean, rstd, w, bias, cd),
            lambda: torch.batch_norm_elemt(xl, w, bias, mean, rstd, 1e-5),
            2 * nx + 4 * c * 4, 3.0 * n),
        'bn_grad_stats': (
            lambda: bn_grad_stats(dy, x, mean, rstd, cd),
            lambda: bn_grad_stats_reference(dy, x, mean, rstd, cd),
            lambda: torch.batch_norm_backward_reduce(dyl, xl, mean, rstd,
                                                     None, True, False,
                                                     False),
            nx + ndy + 4 * c * 4, 5.0 * n),
        'bn_dx': (
            lambda: bn_dx(dy, x, mean, rstd, scale, sum_dy, sum_dy_xhat, cd),
            lambda: bn_dx_reference(dy, x, mean, rstd, scale, sum_dy,
                                    sum_dy_xhat, cd),
            lambda: torch.batch_norm_backward_elemt(
                dyl, xl, mean, rstd, w, sum_dy, sum_dy_xmu, count),
            2 * nx + ndy + 5 * c * 4, 6.0 * n)}


def _k3_bound_ms(nbytes, flops):
    """Bytes over the memory rate against f32 operations over the f32
    rate (BN runs outside the tensor cores)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS['float32'] * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                 else 'operations')


def _time_bn_calls(torch, calls, plain=True, iters=5, device=False):
    """``{kernel}_ms``, ``_plain_ms``, ``_library_ms``, ``_bound_ms`` and
    ``_bound_by`` of each BN kernel (CUDA events), with ``device`` also
    ``_device_ms`` and ``_library_device_ms`` (a CUDA graph of 20 calls).
    ``_library_ms`` is null where torch's call refuses the operands'
    types."""
    t = lambda fn: time_ms(fn, torch, warmup=2, iters=iters,  # noqa: E731
                           repeats=3)
    row = {}
    for name, (kernel, ref, lib, nbytes, flops) in calls.items():
        row[name + '_ms'] = t(kernel)
        if plain:
            row[name + '_plain_ms'] = t(ref)
        if device:
            row[name + '_device_ms'] = graph_ms(torch, kernel)
        try:
            row[name + '_library_ms'] = t(lib)
            if device:
                row[name + '_library_device_ms'] = graph_ms(torch, lib)
        except RuntimeError as e:
            row[name + '_library_ms'] = None
            row[name + '_library_error'] = str(e).splitlines()[0][:200]
            if device:
                row[name + '_library_device_ms'] = None
        row[name + '_bound_ms'], row[name + '_bound_by'] = _k3_bound_ms(
            nbytes, flops)
    return row


def graph_ms(torch, fn, calls=20):
    """Device time per call of ``fn``, from a CUDA graph of ``calls``
    calls: launches back to back, no host time between them. ``fn`` may
    be a list of functions, called in turn (each on its own inputs, so
    that they are not in L2 when it runs again)."""
    fns = fn if isinstance(fn, list) else [fn]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fns[i % len(fns)]()
    return time_ms(graph.replay, torch, warmup=1, iters=3, repeats=3) / calls


L2_FLUSH_BYTES = 128e6             # more than the H100's 50 MB L2


def cold_copies(nbytes):
    """Input copies to cycle through so that a call's inputs left L2
    (at least ``L2_FLUSH_BYTES`` of other inputs between two uses)."""
    return min(20, 1 + int(-(-L2_FLUSH_BYTES // max(nbytes, 1))))


def _k3_errors(torch, got, want, scales):
    """Largest |kernel - plain| and whether every channel is within
    1e-5 of its sum of magnitudes (the kernel sums in f64, the plain
    version in f32)."""
    err, ok = 0.0, True
    for a, b, sc in zip(got, want, scales):
        d = (a - b).abs()
        err = max(err, d.max().item())
        ok = ok and bool((d <= 1e-5 * sc + 1e-6).all()) \
            and bool(torch.isfinite(a).all())
    return err, ok


def _ew_errors(torch, got, want, terms):
    """bn_apply and bn_dx against their plain versions on the same
    constants: within one ulp of the output type plus 1e-6 of the
    magnitude of the terms summed (f32 alone: 1e-6 of the terms)."""
    ulp = 2.0 ** -7 if got.dtype == torch.bfloat16 else 0.0
    d = (got.float() - want.float()).abs()
    ok = bool((d <= ulp * want.float().abs() + 1e-6 * terms + 1e-30).all())
    return d.max().item(), ok and got.dtype == want.dtype \
        and bool(torch.isfinite(got.float()).all())


def _check_bn_kernels(torch, x, dy, cd, o):
    """The four BN kernels against their plain versions at one input:
    errors, and the names of the checks that failed. bn_stats: the sums,
    then the epilogue and the running update against the plain epilogue
    on the kernel's own sums (1e-6 relative); two calls of each
    reduction give the same bits."""
    from bpbreid_tpu_torch.ops.cuda.batchnorm import (
        bn_apply, bn_apply_reference, bn_dx, bn_dx_reference,
        bn_finalize_reference, bn_grad_stats, bn_grad_stats_reference,
        bn_stats, bn_stats_reference)
    a, c, b, w, bias = o['a'], o['c'], o['b'], o['w'], o['bias']
    m, eps = a * b, o.get('eps', 1e-5)
    st, (sum_dy, sum_dy_xhat) = o['st'], o['g']
    mean, _, rstd, scale = st[:4]
    x3, dy3 = x.reshape(a, c, b).float(), dy.reshape(a, c, b).float()
    errs, failed = {}, []
    err, ok = _k3_errors(torch, st[4:], bn_stats_reference(
        x, w, eps, cd, sums=True)[4:], (x3.abs().sum((0, 2)),
                                        (x3 * x3).sum((0, 2))))
    rm_k, rv_k, rm_p, rv_p = (v.clone() for v in (o['rm'], o['rv'],
                                                  o['rm'], o['rv']))
    again = bn_stats(x, w, eps, cd, rm_k, rv_k, sums=True)
    want = bn_finalize_reference(st[4], st[5], m, w, eps, rm_p, rv_p)
    epi = 0.0
    for g, v in zip(again[:4] + (rm_k, rv_k), want + (rm_p, rv_p)):
        d = (g - v).abs()
        epi = max(epi, d.max().item())
        ok = ok and bool((d <= 1e-6 * v.abs() + 1e-7).all())
    errs['bn_stats_max_abs_err'], errs['bn_stats_epilogue_err'] = err, epi
    bits = all(torch.equal(p, q) for p, q in zip(st, again))
    if not ok:
        failed.append('bn_stats')

    y = bn_apply(x, mean, rstd, w, bias, cd)
    terms = ((x3 - mean.view(1, c, 1)).abs() * scale.abs().view(1, c, 1)
             + bias.abs().view(1, c, 1)).view(x.shape)
    errs['bn_apply_max_abs_err'], ok = _ew_errors(
        torch, y, bn_apply_reference(x, mean, rstd, w, bias, cd), terms)
    if not ok:
        failed.append('bn_apply')

    xhat = (x3 - mean.view(1, c, 1)) * rstd.view(1, c, 1)
    errs['bn_grad_stats_max_abs_err'], ok = _k3_errors(
        torch, o['g'], bn_grad_stats_reference(dy, x, mean, rstd, cd),
        (dy3.abs().sum((0, 2)), (dy3 * xhat).abs().sum((0, 2))))
    bits = bits and all(torch.equal(p, q) for p, q in zip(
        o['g'], bn_grad_stats(dy, x, mean, rstd, cd)))
    if not ok:
        failed.append('bn_grad_stats')

    dx = bn_dx(dy, x, mean, rstd, scale, sum_dy, sum_dy_xhat, cd)
    terms = scale.abs().view(1, c, 1) * (
        dy3.abs() + (sum_dy.abs() / m).view(1, c, 1)
        + (xhat * sum_dy_xhat.view(1, c, 1)).abs() / m)
    errs['bn_dx_max_abs_err'], ok = _ew_errors(
        torch, dx, bn_dx_reference(dy, x, mean, rstd, scale, sum_dy,
                                   sum_dy_xhat, cd), terms.view(x.shape))
    if not ok:
        failed.append('bn_dx')
    errs['bits_identical_over_two_calls'] = bits
    if not bits:
        failed.append('bits differ between two calls')
    return errs, failed


def phase_k3(torch):
    """The BN kernels (bn_stats = K3a, bn_apply, bn_grad_stats = K3b,
    bn_dx) against their plain versions, at the train path's BN inputs
    in bf16 and f32 and at ragged shapes; times at the main-path
    shapes."""
    gen = torch.Generator(device='cuda').manual_seed(SEED + 1)
    rows, failures = [], []
    cases = [(sh, cd, dt, True) for sh, cd in K3_MAIN_SHAPES
             for dt in (torch.bfloat16, torch.float32)]
    cases += [(sh, cd, torch.float32, False) for sh, cd in K3_RAGGED_SHAPES]
    cases += [(sh, cd, torch.bfloat16, False) for sh, cd in K3_RAGGED_SHAPES]
    for shape, cd, dt, timed in cases:
        x = (0.5 + torch.randn(shape, device='cuda', generator=gen)).to(dt)
        dy = torch.randn(shape, device='cuda', generator=gen).to(dt)
        o = _bn_operands(torch, x, dy, cd, gen)
        torch.cuda.synchronize()
        errs, failed = _check_bn_kernels(torch, x, dy, cd, o)
        torch.cuda.synchronize()
        row = {'shape': list(shape), 'channel_dim': cd, 'dtype': str(dt),
               'view': [o['a'], o['c'], o['b']], **errs}
        failures += ['{} at {} {}'.format(f, shape, dt) for f in failed]
        if timed:
            row.update(_time_bn_calls(
                torch, _bn_calls(torch, x, dy, cd, o),
                device=(tuple(shape), str(dt)) == K3_REPORT))
        log('K3', json.dumps(row))
        rows.append(row)
        del x, dy, o
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError('\n'.join(failures))
    return rows


def _k1_inputs(torch, gen, shape, blocks, dtype):
    n, h, w, c = shape
    x = torch.randn(shape, device='cuda', generator=gen).to(dtype)
    weights = torch.randn((2 * blocks, 3, 3, c, c), device='cuda',
                          generator=gen) / (3.0 * c ** 0.5)
    scales = 1.0 + 0.1 * torch.randn((2 * blocks, c), device='cuda',
                                     generator=gen)
    biases = 0.1 * torch.randn((2 * blocks, c), device='cuda', generator=gen)
    return x, weights, scales, biases


def _k1_error(torch, got, want, want_f32):
    """Errors of a K1 output against its plain version of the input's type
    (``want``) and against the f32 contract (``want_f32``), and whether
    they are inside the tolerance. f32: sums in another order, 1e-4 of the
    largest |output|. bf16: against the bf16 plain version, 2 bf16 ulps of
    each value plus 3e-3 of the largest (f32 sums in another order move
    some bf16 y1 and block-input values by one ulp, which the later blocks
    carry: 1.1-1.5e-3 measured); against the f32 contract, rel. L2 1e-2
    (bf16 operands)."""
    got, want, want_f32 = got.float(), want.float(), want_f32.float()
    err = (got - want).abs()
    scale = want.abs().max().item()
    finite = bool(torch.isfinite(got).all())
    if want_f32 is want:
        return {'max_abs_err': err.max().item()}, \
            finite and err.max().item() <= 1e-4 * scale + 1e-6
    over = (err - 2 * 2.0 ** -7 * want.abs()).clamp(min=0).max().item()
    rel_l2 = ((got - want_f32).norm() / want_f32.norm()).item()
    errs = {'max_abs_err': err.max().item(),
            'beyond_2ulp_share_of_max': over / max(scale, 1e-30),
            'max_abs_err_f32_contract': (got - want_f32).abs().max().item(),
            'rel_l2_f32_contract': rel_l2}
    return errs, finite and over <= 3e-3 * scale + 1e-6 and rel_l2 <= 1e-2


def conv_chain_library(torch, x, weights, scales, biases):
    """The same chain as eager cuDNN: ``F.conv2d`` on channels_last maps
    in the input's type, then the folded affine, ReLU and residual.
    ``x`` is NCHW channels_last, ``weights`` a list of OIHW kernels in
    ``x.dtype``."""
    import torch.nn.functional as F
    s, b = scales[:, None, :, None, None], biases[:, None, :, None, None]
    for i in range(len(weights) // 2):
        y = torch.relu(F.conv2d(x, weights[2 * i], padding=1) * s[2 * i]
                       + b[2 * i])
        y = F.conv2d(y, weights[2 * i + 1], padding=1)
        x = torch.relu(x + (y * s[2 * i + 1] + b[2 * i + 1]))
    return x


def conv_chain_bound_ms(x, weights):
    """Operations over the peak for x's type (bf16 on the tensor cores,
    f32 on the CUDA cores) against x read once, the output, the weights
    (f32) and the affine written or read once."""
    n, h, w, c = x.shape
    flops = 2.0 * n * h * w * 9 * c * c * weights.shape[0]
    nbytes = 2 * x.numel() * x.element_size() + weights.numel() * 4 \
        + 2 * weights.shape[0] * c * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(x.dtype).replace('torch.', '')] * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                 else 'operations')


def phase_k1(torch):
    """K1 against its plain versions at the main-path and ragged shapes,
    f32 and bf16; times of the main-path shapes."""
    from bpbreid_tpu_torch.ops.conv_chain import (
        basicblock_chain_bf16_reference, basicblock_chain_reference,
        fused_basicblock_chain)
    gen = torch.Generator(device='cuda').manual_seed(SEED + 4)
    cases = [(sh, bl, dt, True) for sh, bl in K1_MAIN_SHAPES
             for dt in (torch.bfloat16, torch.float32)]
    cases += [(sh, bl, dt, False) for sh, bl in K1_RAGGED_SHAPES
              for dt in (torch.float32, torch.bfloat16)]
    rows, failures = [], []
    for shape, blocks, dt, timed in cases:
        x, w, s, b = _k1_inputs(torch, gen, shape, blocks, dt)
        plain = basicblock_chain_bf16_reference if dt == torch.bfloat16 \
            else basicblock_chain_reference
        got = fused_basicblock_chain(x, w, s, b)
        torch.cuda.synchronize()
        want_f32 = basicblock_chain_reference(x, w, s, b)
        want = want_f32 if plain is basicblock_chain_reference \
            else plain(x, w, s, b)
        errs, ok = _k1_error(torch, got, want, want_f32)
        row = {'shape': list(shape), 'blocks': blocks, 'dtype': str(dt),
               **errs}
        if not ok:
            failures.append('K1 at {} {} x{}: {}'.format(
                shape, dt, blocks, errs))
        if timed:
            t = lambda fn: time_ms(fn, torch, warmup=2, iters=5,  # noqa: E731
                                   repeats=3)
            row['ms'] = t(lambda: fused_basicblock_chain(x, w, s, b))
            row['plain_ms'] = t(lambda: plain(x, w, s, b))
            x_cl = x.permute(0, 3, 1, 2)            # channels_last NCHW
            w_lib = [wi.contiguous(memory_format=torch.channels_last)
                     for wi in w.permute(0, 4, 3, 1, 2).to(dt)]
            s_l, b_l = s.to(dt), b.to(dt)
            row['library_ms'] = t(lambda: conv_chain_library(
                torch, x_cl, w_lib, s_l, b_l))
            if (tuple(shape), str(dt)) == K1_REPORT:
                row['device_ms'] = graph_ms(
                    torch, lambda: fused_basicblock_chain(x, w, s, b))
                row['library_device_ms'] = graph_ms(
                    torch, lambda: conv_chain_library(torch, x_cl, w_lib,
                                                      s_l, b_l))
            row['bound_ms'], row['bound_by'] = conv_chain_bound_ms(x, w)
            row['tflop_per_s'] = 2.0 * x.numel() * 9 * shape[3] \
                * 2 * blocks / row['ms'] / 1e9
            row['bound_share'] = row['bound_ms'] / row['ms']
            del x_cl, w_lib
        log('K1', json.dumps(row))
        rows.append(row)
        del x, w, s, b, got, want, want_f32
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError('\n'.join(failures))
    return rows


def _branch_chains(torch, model):
    """The BasicBlock ResLayers of every HighResolutionModule's branches."""
    from bpbreid_tpu_torch.models.hrnet import HighResolutionModule
    return [(name + '.branches.{}'.format(i), branch)
            for name, mod in model.named_modules()
            if isinstance(mod, HighResolutionModule)
            for i, branch in enumerate(mod.branches)]


def k1_on_model_chains(torch, model, inputs, rtol):
    """Forward hooks capture the input and output of every branch chain
    of ``model(*inputs)``; then fold each chain and run it through K1 on the
    captured input. Returns the rows, the wrapper calls and the launch
    count of the K1 run (counts reset just before it): one a block in
    f32, two in bf16."""
    from bpbreid_tpu_torch.ops.conv_chain import (fold_basicblock_chain,
                                                  fused_basicblock_chain)
    from bpbreid_tpu_torch.ops.cuda.build import (launch_counts,
                                                  reset_launch_counts)
    chains = _branch_chains(torch, model)
    captured, hooks = {}, []
    for name, branch in chains:
        hooks.append(branch.register_forward_hook(
            lambda mod, inp, out, name=name: captured.__setitem__(
                name, (inp[0].detach(), out.detach()))))
    try:
        with torch.inference_mode():
            model(*inputs)
    finally:
        for h in hooks:
            h.remove()
    folded = {name: fold_basicblock_chain(branch) for name, branch in chains}
    torch.cuda.synchronize()
    rows, failures = [], []
    reset_launch_counts()
    for name, _ in chains:
        inp, out = captured[name]
        got = fused_basicblock_chain(inp.permute(0, 2, 3, 1).contiguous(),
                                     *folded[name])
        err = relative_errors(got.permute(0, 3, 1, 2), out).max().item()
        rows.append({'chain': name, 'shape': list(inp.shape),
                     'dtype': str(inp.dtype), 'max_rel_err': err})
        if not err <= rtol:
            failures.append('K1 on {}: rel err {} > {}'.format(name, err,
                                                              rtol))
    torch.cuda.synchronize()
    launches = launch_counts.get('conv_chain', 0)
    per_block = 2 if rows and rows[0]['dtype'] == str(torch.bfloat16) else 1
    per_call = per_block * sum(w.shape[0] // 2 for w, _, _ in folded.values())
    if launches != per_call or len(chains) == 0:
        failures.append('K1 launches {} != {} a block x blocks of {} chains'
                        .format(launches, per_block, len(chains)))
    if failures:
        raise AssertionError('; '.join(failures))
    return rows, len(chains), launches


def phase_k1_serving(torch, model, engine, query, results):
    """K1 on the 26 branch chains of the bf16 serving model, one query
    batch; rel. L2 3e-2 per sample (the model rounds each conv's input and
    output, each BN and each residual to bf16, K1 its conv operands and y1
    only), as phase 4."""
    from bpbreid_tpu_torch.data.augment import eval_preprocess
    imgs = torch.as_tensor(query[0]['image'], device='cuda')
    masks = torch.as_tensor(query[0]['mask'], device='cuda')
    x, m = eval_preprocess(imgs, masks, mask_kwargs=engine.mask_kwargs)
    rows, calls, launches = k1_on_model_chains(torch, model, (x, m), 3e-2)
    if calls != HRNET_W32_CHAINS:
        raise AssertionError('{} branch chains, expected {}'.format(
            calls, HRNET_W32_CHAINS))
    out = {'calls': calls, 'launches': launches,
           'max_rel_err': max(r['max_rel_err'] for r in rows)}
    log('K1 on serving chains', json.dumps(out))
    results['k1_serving_chains'] = {**out, 'rows': rows}
    return launches


def make_batches(n_batches, rng, base_images, camid_offset):
    """Seeded uint8 images (identity template + noise), 36-channel
    confidence fields at 1/8 of the image grid, pids and camids."""
    batches = []
    for b in range(n_batches):
        idx = b * BATCH + np.arange(BATCH)
        pids = idx % N_IDS
        noise = rng.integers(-12, 13, size=(BATCH, HEIGHT, WIDTH, 3))
        imgs = np.clip(base_images[pids].astype(np.int32) + noise, 0, 255)
        batches.append({
            'image': imgs.astype(np.uint8),
            'mask': rng.uniform(size=(BATCH, HEIGHT // 8, WIDTH // 8, 36))
                    .astype(np.float32),
            'pid': pids.astype(np.int64),
            'camid': (camid_offset + (idx // N_IDS) % 5).astype(np.int64),
        })
    return batches


def serving_config():
    from bpbreid_tpu_torch.config import get_default_config
    from bpbreid_tpu_torch.ops.masks import compute_parts_num_and_names
    cfg = get_default_config()
    cfg.data.height, cfg.data.width = HEIGHT, WIDTH
    cfg.model.compute_dtype = 'bfloat16'
    cfg.model.bpbreid.backbone = 'hrnet32'
    cfg.model.bpbreid.masks.preprocess = 'five_v'
    cfg.model.bpbreid.test_embeddings = ['bn_foreg', 'parts']
    cfg.model.bpbreid.use_pallas_pooling = True
    cfg.model.bpbreid.multires_pooling = False
    cfg.test.batch_size = BATCH
    compute_parts_num_and_names(cfg)
    return cfg


def profile_steps(torch, step, steps=3, symbols=None):
    """Device time by kernel over ``steps`` calls of ``step``
    (torch.profiler): the device's busy share of the host-clock window
    and the kernels that take the most time, and with ``symbols`` (name
    -> substrings of kernel names) the device time of those kernels.
    Kernels run on one stream, so their summed durations are the busy
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        # device-side ranges of record_function annotations (the
        # optimizer's step, zero_grad) are not kernels
        if e.device_type == DeviceType.CUDA \
                and not getattr(e, 'is_user_annotation', False):
            ms, calls = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3,
                               calls + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    host = sorted(prof.key_averages(), key=lambda k: -k.self_cpu_time_total)
    def device_ms(symbols):
        return sum(ms for name, (ms, _) in by_name.items()
                   if any(k in name for k in symbols))
    return {'steps': steps, 'wall_ms': wall_ms,
            'device_busy_ms': busy_ms if by_name else 'not measured',
            'busy_share': busy_ms / wall_ms if by_name else 'not measured',
            'bn_kernels_device_ms': (device_ms(BN_KERNEL_SYMBOLS)
                                     if by_name else 'not measured'),
            'k3_device_ms': (device_ms(K3_KERNEL_SYMBOLS) if by_name
                             else 'not measured'),
            'int8_device_ms': ({k: device_ms(v) for k, v in
                                INT8_KERNEL_SYMBOLS.items()} if by_name
                               else 'not measured'),
            'symbol_device_ms': ({k: device_ms(v) for k, v in
                                 (symbols or {}).items()} if by_name
                                else 'not measured'),
            'device_kernel_launches': sum(c for _, c in by_name.values()),
            'top_kernels': [{'name': name[:100], 'ms': ms, 'calls': calls}
                            for name, (ms, calls) in top],
            'top_host_ops': [{'name': k.key[:80],
                              'self_cpu_ms': k.self_cpu_time_total / 1e3,
                              'calls': k.count} for k in host[:12]]}


def relative_errors(a, b):
    """Per-sample relative L2 error of [N, ...] tensors (f32)."""
    a, b = a.float().flatten(1), b.float().flatten(1)
    return ((a - b).norm(dim=1) / b.norm(dim=1).clamp(min=1e-12))


def phase_serving(torch, results):
    """The full-width eval + retrieval run with K2 on the path."""
    from bpbreid_tpu_torch.data.augment import eval_preprocess, \
        mask_chain_kwargs
    from bpbreid_tpu_torch.engine.part_based import ImagePartBasedEngine
    from bpbreid_tpu_torch.models import build_model
    from bpbreid_tpu_torch.models.common import FastBatchNorm
    from bpbreid_tpu_torch.ops.cuda.build import (launch_counts,
                                                  reset_launch_counts)
    cfg = serving_config()
    model = build_model('bpbreid', 751, config=cfg, device='cuda', seed=SEED)
    engine = ImagePartBasedEngine.from_config(cfg, model,
                                              mask_chain_kwargs(cfg),
                                              device='cuda')
    rng = np.random.default_rng(SEED)
    base = rng.integers(0, 256, size=(N_IDS, HEIGHT, WIDTH, 3))
    query = make_batches(N_QUERY_BATCHES, rng, base, 0)
    gallery = make_batches(N_GALLERY_BATCHES, rng, base, 1)

    # warm-up batch (cuDNN plans, allocator), outside the counted run
    engine.eval_step(torch.as_tensor(query[0]['image'], device='cuda'),
                     torch.as_tensor(query[0]['mask'], device='cuda'))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launch_counts()
    t0 = time.perf_counter()
    out = engine.evaluate(query, gallery, normalize_feature=True)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = dict(launch_counts)
    n_batches = N_QUERY_BATCHES + N_GALLERY_BATCHES
    if launches.get('attention_pool', 0) < 1:
        raise AssertionError('the serving run launched no attention_pool '
                             'kernel: {}'.format(launches))

    cmc, mAP, acc = out['cmc'], out['mAP'], out['pixel_accuracy']
    checks = []
    if not (np.isfinite(mAP) and 0.0 <= mAP <= 1.0):
        checks.append('mAP {} not in [0, 1]'.format(mAP))
    if not (np.all(np.isfinite(cmc)) and cmc.shape == (50,)):
        checks.append('bad CMC {}'.format(cmc))
    if not 0.0 <= acc <= 1.0:
        checks.append('pixel accuracy {} not in [0, 1]'.format(acc))
    n_q, n_g = N_QUERY_BATCHES * BATCH, N_GALLERY_BATCHES * BATCH
    if out['distmat'].shape != (n_q, n_g) \
            or not np.all(np.isfinite(out['distmat'])):
        checks.append('bad distance matrix {}'.format(out['distmat'].shape))

    # embeddings of the first query batch, kept for phase 4
    imgs = torch.as_tensor(query[0]['image'], device='cuda')
    masks = torch.as_tensor(query[0]['mask'], device='cuda')
    feats, vis = engine.eval_step(imgs, masks)[:2]
    if tuple(feats.shape) != (BATCH, 6, 512) or not torch.isfinite(
            feats.float()).all():
        checks.append('bad features {} {}'.format(tuple(feats.shape),
                                                  feats.dtype))
    if checks:
        raise AssertionError('; '.join(checks))

    # every eval-mode BN of a step is one bn_apply launch, and nothing
    # else of the BN kernels runs
    calls = []
    hooks = [mod.register_forward_hook(lambda *_: calls.append(1))
             for mod in model.modules() if isinstance(mod, FastBatchNorm)]
    reset_launch_counts()
    try:
        engine.eval_step(imgs, masks)
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    eval_bn = {k: launch_counts.get(k, 0) for k in BN_KERNELS}
    if eval_bn != {'bn_stats': 0, 'bn_apply': len(calls),
                   'bn_grad_stats': 0, 'bn_dx': 0} or not calls:
        raise AssertionError('eval step: {} BN calls, BN launches {}'.format(
            len(calls), eval_bn))

    # throughput of the model forward alone at batch 64 (CUDA events)
    x, m = eval_preprocess(imgs, masks, mask_kwargs=engine.mask_kwargs)
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(x, m), torch, warmup=2, iters=5,
                         repeats=3)
        step_ms = time_ms(lambda: engine.eval_step(imgs, masks), torch,
                          warmup=1, iters=5, repeats=3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    serving = {'batch': BATCH, 'dtype': 'bfloat16',
               'forward_ms_per_batch': fwd_ms,
               'forward_images_per_s': BATCH / fwd_ms * 1e3,
               'eval_step_ms_per_batch': step_ms,
               'eval_step_images_per_s': BATCH / step_ms * 1e3,
               'retrieval_s': eval_s,
               'retrieval_images': n_q + n_g,
               'n_batches': n_batches,
               'eval_bn_calls_per_step': len(calls),
               'peak_memory_gb': peak_gb,
               'mAP': mAP, 'rank1': float(cmc[0]),
               'pixel_accuracy': acc}
    log('serving', json.dumps(serving))
    results['serving'] = serving
    profile_out = profile_steps(torch,
                                lambda: engine.eval_step(imgs, masks))
    log('profile', json.dumps({k: v for k, v in profile_out.items()
                               if not k.startswith('top_')}))
    for row in profile_out['top_kernels'][:6]:
        log('  {:9.3f} ms {:5d} calls  {}'.format(row['ms'], row['calls'],
                                                  row['name']))
    results['profile'] = profile_out
    results['launches'] = launches
    return model, engine, query, gallery, feats, vis, mAP


def phase_paths(torch, model, engine, query, feats, vis, mAP_fused,
                results):
    """Same weights on the plain pooling and the multires paths."""
    imgs = torch.as_tensor(query[0]['image'], device='cuda')
    masks = torch.as_tensor(query[0]['mask'], device='cuda')
    # bf16 compute: the paths round at different places (the plain path
    # pools bf16 softmax probabilities, the multires path bf16-rounded
    # transposed masks and folded f32 logits), so embeddings agree to a
    # few bf16 ulps through the dim-reduce layers
    emb_rtol = 3e-2
    out, failures = {}, []
    for path, pallas, multires in (('plain', False, False),
                                   ('multires', False, True)):
        model.use_pallas_pooling, model.multires = pallas, multires
        f, v = engine.eval_step(imgs, masks)[:2]
        err = relative_errors(f, feats).max().item()
        vis_agree = (v == vis).float().mean().item()
        entry = {'max_rel_err': err, 'visibility_agreement': vis_agree}
        if not err <= emb_rtol:
            failures.append('{} path embeddings rel err {} > {}'.format(
                path, err, emb_rtol))
        # identical logits on the plain path: visibility must match
        # exactly; the multires logits are computed in another order
        # and a near-tie argmax may flip
        need = 1.0 if path == 'plain' else 0.98
        if vis_agree < need:
            failures.append('{} path visibility agreement {} < {}'.format(
                path, vis_agree, need))
        out[path] = entry
    model.use_pallas_pooling, model.multires = True, False
    log('paths', json.dumps(out))
    results['paths'] = out
    if failures:
        raise AssertionError('; '.join(failures))


def phase_small_reference(torch, results):
    """Port model in f32 on the card vs on the CPU, small input."""
    from bpbreid_tpu_torch.config import get_default_config
    from bpbreid_tpu_torch.models import build_model
    cfg = get_default_config()
    cfg.model.compute_dtype = 'float32'
    cfg.model.bpbreid.backbone = 'hrnet32'
    cfg.model.bpbreid.masks.parts_num = 5
    cfg.model.bpbreid.dim_reduce_output = 64
    cfg.model.bpbreid.use_pallas_pooling = True
    cfg.model.bpbreid.multires_pooling = False
    stages = {'stage2': (1, 2, (2, 2), (32, 64)),
              'stage3': (1, 3, (2, 2, 2), (32, 64, 128)),
              'stage4': (1, 4, (2, 2, 2, 2), (32, 64, 128, 256))}
    x = torch.from_numpy(np.random.default_rng(SEED).normal(
        size=(2, 3, 64, 32)).astype(np.float32))
    outs = {}
    for device in ('cuda', 'cpu'):
        model = build_model('bpbreid', 7, config=cfg, device=device,
                            seed=SEED, backbone_stages=stages)
        with torch.inference_mode():
            emb = model(x.to(device))[0]
        outs[device] = {k: v.float().cpu() for k, v in emb.items()}
        if device == 'cuda':
            # K1 on this model's 9 branch chains of 2 blocks, f32
            rows, calls, launches = k1_on_model_chains(
                torch, model, (x.to(device),), 1e-4)
            k1 = {'calls': calls, 'launches': launches,
                  'max_rel_err': max(r['max_rel_err'] for r in rows)}
            log('K1 on small f32 chains', json.dumps(k1))
            results['k1_small_f32_chains'] = k1
    err = max((outs['cuda'][k] - outs['cpu'][k]).abs().max().item()
              for k in outs['cpu'])
    log('small_f32_card_vs_cpu max_abs_err', err)
    results['small_f32_card_vs_cpu_max_abs_err'] = err
    # f32 throughout (TF32 off); sums in other orders than the CPU's
    if not err <= 1e-3:
        raise AssertionError('card vs CPU f32 embeddings differ by {}'
                             .format(err))


def _cached_features(engine):
    """Make ``engine.feature_extraction`` compute each loader's features
    once, so two ``evaluate`` calls rank the same features."""
    cache, extract = {}, engine.feature_extraction

    def cached(loader):
        if id(loader) not in cache:
            cache[id(loader)] = extract(loader)
        return cache[id(loader)]
    engine.feature_extraction = cached


def _compare_evals(got, want, what, ssmd_tol=1e-4):
    """CMC and mAP within 1e-5, SSMD within ``ssmd_tol``, per-part rows
    (percent) within 1e-3 (1e-5 of 1)."""
    checks = []
    n = min(len(got['cmc']), len(want['cmc']))
    cmc_err = float(np.abs(got['cmc'][:n] - want['cmc'][:n]).max())
    map_err = abs(got['mAP'] - want['mAP'])
    ssmd_err = abs(got['ssmd'] - want['ssmd'])
    if not (cmc_err <= 1e-5 and map_err <= 1e-5):
        checks.append('{}: CMC err {} mAP err {}'.format(what, cmc_err,
                                                         map_err))
    if not ssmd_err <= ssmd_tol:
        checks.append('{}: SSMD {} vs {}'.format(what, got['ssmd'],
                                                 want['ssmd']))
    part_err = 0.0
    if got['parts_ranking'] is not None:
        part_err = float(np.abs(
            np.array([r[1:] for r in got['parts_ranking']])
            - np.array([r[1:] for r in want['parts_ranking']])).max())
        if not part_err <= 1e-3:
            checks.append('{}: per-part rows differ by {} %'.format(
                what, part_err))
    if checks:
        raise AssertionError('; '.join(checks))
    return {'cmc_err': cmc_err, 'map_err': map_err, 'ssmd_err': ssmd_err,
            'part_rows_err_percent': part_err}


def phase_large_gallery_serving(torch, engine, query, gallery, results):
    """Phase 8a: the serving engine's ``evaluate`` above
    ``device_ranking_threshold`` (forced to 1) against its host path, on
    the same features."""
    _cached_features(engine)
    host = engine.evaluate(query, gallery, normalize_feature=True)
    engine.device_ranking_threshold = 1
    try:
        dev = engine.evaluate(query, gallery, normalize_feature=True)
    finally:
        engine.device_ranking_threshold = int(2e8)
    out = _compare_evals(dev, host, 'serving chunked vs host')
    out.update(mAP=dev['mAP'], rank1=float(dev['cmc'][0]), ssmd=dev['ssmd'])
    log('phase 8a', json.dumps(out))
    results['large_gallery'] = {'serving_chunked_vs_host': out}


def _synthetic_features(torch, gen, pids, centers, noise=3.0,
                        chunk=1 << 16, device='cuda'):
    """``[len(pids), K, D]`` f32 features, L2-normalized per part: the
    identity's center plus Gaussian noise; pids without a center (>=
    len(centers)) are noise alone. Made on the card, in chunks."""
    n = len(pids)
    k, d = centers.shape[1:]
    out = torch.empty((n, k, d), device=device)
    for s in range(0, n, chunk):
        p = pids[s:s + chunk]
        f = noise * torch.randn((len(p), k, d), device=device, generator=gen)
        has = p < len(centers)
        f[has] += centers[p[has]]
        out[s:s + chunk] = f / f.norm(dim=-1, keepdim=True)
        del f
    return out


def _synthetic_split(torch, gen, pids, centers, device='cuda'):
    """(features, visibility [N, K] f32 with about 20 % of the part
    streams invisible, pids, camids) of one split."""
    feats = _synthetic_features(torch, gen, pids, centers, device=device)
    vis = torch.rand((len(pids), centers.shape[1]), device=device,
                     generator=gen) > 0.2
    vis[:, 0] = True                     # the foreground stream
    camids = torch.randint(0, 6, (len(pids),), device=device, generator=gen)
    return feats, vis.float(), pids.cpu().numpy(), camids.cpu().numpy()


def phase_large_gallery(torch, results):
    """Phase 8b and 8c: Market-1501-sized and Market-1501 + 500k retrieval
    on seeded features [N, 6, 512] with planted identities."""
    from bpbreid_tpu_torch.engine.part_based import ImagePartBasedEngine
    from bpbreid_tpu_torch.metrics.distance import \
        compute_distance_matrix_using_bp_features
    from bpbreid_tpu_torch.ops.ranking import cmc_map, cmc_map_counting
    gen = torch.Generator(device='cuda').manual_seed(SEED + 5)
    k, d = 6, 512
    centers = torch.randn((2 * MARKET_IDS, k, d), device='cuda',
                          generator=gen)
    q_pids = torch.arange(MARKET_QUERY, device='cuda') % MARKET_IDS
    # half of the gallery's identities are the queries', half are not
    g_pids = torch.randint(0, 2 * MARKET_IDS, (MARKET_GALLERY,),
                           device='cuda', generator=gen)
    query = _synthetic_split(torch, gen, q_pids, centers)
    gallery = _synthetic_split(torch, gen, g_pids, centers)
    engine = ImagePartBasedEngine(
        torch.nn.Identity(), device='cuda', detailed_ranking=True,
        parts_names=['head', 'torso', 'arms', 'legs', 'feet'])
    splits = {'query': query + (0.0,), 'gallery': gallery + (0.0,)}
    engine.feature_extraction = splits.__getitem__
    out = {}

    # 8b: Market-1501 size, chunked (threshold 1) vs host ranking
    t0 = time.perf_counter()
    host = engine.evaluate('query', 'gallery', normalize_feature=False)
    host_s = time.perf_counter() - t0
    engine.device_ranking_threshold = 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev = engine.evaluate('query', 'gallery', normalize_feature=False)
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    engine.device_ranking_threshold = int(2e8)
    # SSMD: the chunked path sums the pair moments in f32 (as JAX), and
    # std = sqrt(E[d^2] - E[d]^2) cancels: unit 512-d features put the
    # negative-pair variance near 1e-4 of E[d^2], so f32 rounding moves
    # the SSMD by about 1e-3 of itself; 1e-2 of it is the tolerance
    out['market1501'] = {
        'queries': MARKET_QUERY, 'gallery': MARKET_GALLERY,
        'host_path_s': host_s, 'chunked_path_s': dev_s,
        'mAP': dev['mAP'], 'rank1': float(dev['cmc'][0]),
        'ssmd': dev['ssmd'], 'host_ssmd': host['ssmd'],
        **_compare_evals(dev, host, 'market1501',
                         ssmd_tol=1e-2 * abs(host['ssmd']))}
    log('phase 8b', json.dumps(out['market1501']))
    # phase 16b ranks this host distance matrix again
    ranking_inputs = (host['distmat'], query[2], gallery[2], query[3],
                      gallery[3])
    del host, dev

    # 8c: + 496,181 distractors, whose pids no query has
    n_big = MARKET_500K_GALLERY
    big_pids = torch.cat([g_pids, 10 ** 6 + torch.arange(
        n_big - MARKET_GALLERY, device='cuda')])
    gf = torch.empty((n_big, k, d), device='cuda')
    gf[:MARKET_GALLERY] = gallery[0]
    gf[MARKET_GALLERY:] = _synthetic_features(torch, gen,
                                              big_pids[MARKET_GALLERY:],
                                              centers)
    gv = torch.cat([gallery[1], (torch.rand(
        (n_big - MARKET_GALLERY, k), device='cuda', generator=gen) > 0.2)
        .float()])
    gv[:, 0] = 1.0
    g_camids = np.concatenate([gallery[3], torch.randint(
        0, 6, (n_big - MARKET_GALLERY,), device='cuda',
        generator=gen).cpu().numpy()])
    splits['gallery'] = (gf, gv, big_pids.cpu().numpy(), g_camids, 0.0)
    del gallery
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    big = engine.evaluate('query', 'gallery', normalize_feature=False)
    torch.cuda.synchronize()
    big_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    chunk = max(16, min(MARKET_QUERY, (2 << 30) // (4 * k * n_big)))
    n_chunks = -(-MARKET_QUERY // chunk)

    # the first chunk: the counting ranker against the full sort
    qf, qv = query[0][:chunk], query[1][:chunk].bool()
    t0 = time.perf_counter()
    d_c, _ = compute_distance_matrix_using_bp_features(
        qf, gf, qv, gv.bool(), engine.dist_combine_strat,
        engine.batch_size_pairwise_dist_matrix)
    torch.cuda.synchronize()
    dist_s = time.perf_counter() - t0
    args = (q_pids[:chunk], torch.as_tensor(big_pids, device='cuda'),
            torch.as_tensor(query[3][:chunk], device='cuda'),
            torch.as_tensor(g_camids, device='cuda'))
    t0 = time.perf_counter()
    counted = cmc_map_counting(d_c, *args, max_rank=50)
    torch.cuda.synchronize()
    count_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    full = cmc_map(d_c, *args, max_rank=50)
    torch.cuda.synchronize()
    sort_s = time.perf_counter() - t0
    cmc_err = (counted[0] - full[0]).abs().max().item()
    map_err = abs(counted[1].item() - full[1].item())
    out['market1501_500k'] = {
        'queries': MARKET_QUERY, 'gallery': n_big,
        'gallery_gb': gf.numel() * 4 / 1e9, 'chunk_queries': chunk,
        'chunks': n_chunks, 'whole_s': big_s, 's_per_chunk': big_s / n_chunks,
        'peak_memory_gb': peak_gb, 'mAP': big['mAP'],
        'rank1': float(big['cmc'][0]), 'ssmd': big['ssmd'],
        'parts_ranking': big['parts_ranking'],
        'first_chunk': {'distance_s': dist_s, 'counting_s': count_s,
                        'full_sort_s': sort_s, 'cmc_err': cmc_err,
                        'map_err': map_err,
                        'overflow': int(counted[3]),
                        'n_valid': [int(counted[2]), int(full[2])]}}
    log('phase 8c', json.dumps(out['market1501_500k']))
    results['large_gallery'].update(out)
    checks = []
    if not (cmc_err <= 1e-6 and map_err <= 1e-6
            and int(counted[2]) == int(full[2]) and int(counted[3]) == 0):
        checks.append('first chunk: counting vs full sort: {}'.format(
            out['market1501_500k']['first_chunk']))
    m = out['market1501']['mAP']
    if not (np.isfinite(big['mAP']) and 0.0 <= big['mAP'] <= m + 1e-6):
        checks.append('500k mAP {} not in [0, {}] (distractors cannot '
                      'raise it)'.format(big['mAP'], m))
    if checks:
        raise AssertionError('; '.join(checks))
    del gf, gv, d_c, splits, engine
    torch.cuda.empty_cache()
    return ranking_inputs


def train_config(height=HEIGHT, width=WIDTH, dtype='bfloat16',
                 dim_reduce_output=512):
    """The JAX train recipe (bpbreid_tpu/tools/bench_train.py): five_v,
    transforms rf rc re, GWAP with multires pooling, no K2."""
    from bpbreid_tpu_torch.config import get_default_config
    from bpbreid_tpu_torch.ops.masks import compute_parts_num_and_names
    cfg = get_default_config()
    cfg.data.height, cfg.data.width = height, width
    cfg.data.transforms = ['rf', 'rc', 're']
    cfg.model.compute_dtype = dtype
    cfg.model.bpbreid.backbone = 'hrnet32'
    cfg.model.bpbreid.masks.preprocess = 'five_v'
    cfg.model.bpbreid.dim_reduce_output = dim_reduce_output
    cfg.train.batch_size = BATCH
    compute_parts_num_and_names(cfg)
    return cfg


def train_engine(torch, cfg, num_classes, device, **model_kwargs):
    from bpbreid_tpu_torch.data.augment import mask_chain_kwargs
    from bpbreid_tpu_torch.engine.part_based import ImagePartBasedEngine
    from bpbreid_tpu_torch.models import build_model
    from bpbreid_tpu_torch.optim import build_optimizer
    model = build_model('bpbreid', num_classes, config=cfg, device=device,
                        seed=SEED, **model_kwargs)
    optimizer = build_optimizer(model, optim='adam', lr=LR,
                                weight_decay=WEIGHT_DECAY)
    return model, ImagePartBasedEngine.from_config(
        cfg, model, mask_chain_kwargs(cfg), device=device,
        optimizer=optimizer)


def make_train_batch(rng, n_ids, n_inst, height, width, device,
                     varied=False):
    """Identity x instance batch: a template per identity plus noise,
    confidence fields at 1/8 of the image grid. ``varied``: each image
    also gets its own contrast (x0.25-1 about mid-grey) and brightness
    (+-64), so that statistics taken over the batch of pooled vectors
    (HACNN's channel attention) are not near-degenerate."""
    import torch
    pids = np.repeat(np.arange(n_ids), n_inst)
    base = rng.integers(0, 256, size=(n_ids, height, width, 3))
    noise = rng.integers(-20, 21, size=(len(pids), height, width, 3))
    imgs = base[pids] + noise
    masks = rng.uniform(size=(len(pids), height // 8, width // 8, 36)) \
        .astype(np.float32)
    if varied:
        contrast = rng.uniform(0.25, 1.0, size=(len(pids), 1, 1, 1))
        brightness = rng.uniform(-64.0, 64.0, size=(len(pids), 1, 1, 1))
        imgs = 128 + contrast * (imgs - 128) + brightness
    imgs = np.clip(imgs, 0, 255).astype(np.uint8)
    return {'image': torch.as_tensor(imgs, device=device),
            'mask': torch.as_tensor(masks, device=device),
            'pid': torch.as_tensor(pids, device=device)}


def phase_train(torch, results):
    """The full-width train run (see the module docstring, phase 6)."""
    from bpbreid_tpu_torch.data.augment import sample_train_draws
    from bpbreid_tpu_torch.models.common import FastBatchNorm
    from bpbreid_tpu_torch.ops.cuda.build import (launch_counts,
                                                  reset_launch_counts)
    cfg = train_config()
    model, engine = train_engine(torch, cfg, 751, 'cuda')
    batch = make_train_batch(np.random.default_rng(SEED + 2), TRAIN_IDS,
                             TRAIN_INSTANCES, HEIGHT, WIDTH, 'cuda')
    # train-mode BNs whose sums go through K3: all but the pixel
    # classifier's, whose multires statistics are virtual. The losses
    # read no background stream and no per-part id score (GiLt: id on
    # global/foreground/concat, triplet on parts), so autograd runs no
    # backward for those streams' BNs
    bn = [n for n, mod in model.named_modules()
          if isinstance(mod, FastBatchNorm) and n != 'pixel_classifier.bn']
    no_grad = [n for n in bn if n.startswith((
        'background_after_pooling_dim_reduce',
        'background_identity_classifier', 'parts_identity_classifier'))]
    losses, step_ms = [], []

    def step(draws=None):
        t0 = time.perf_counter()
        loss, _ = engine.forward_backward(batch, draws)
        losses.append(loss.item())          # waits for the step
        return (time.perf_counter() - t0) * 1e3

    # the first warm-up step records every K3-backed BN's input
    inputs = {}

    def record(name):
        def hook(mod, inp):
            inputs.setdefault(name, (tuple(inp[0].shape), inp[0].dtype,
                                     mod.channel_dim))
        return hook
    modules = dict(model.named_modules())
    hooks = [modules[n].register_forward_pre_hook(record(n)) for n in bn]
    try:
        step()
    finally:
        for h in hooks:
            h.remove()
    for _ in range(TRAIN_WARMUP - 1):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    for _ in range(TRAIN_TIMED):
        step_ms.append(step())
    launches = dict(launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # learning: the one batch with one set of draws, repeated (fresh
    # draws at 16 x 4 move the loss by more than 20 steps lower it)
    draws = sample_train_draws(engine.generator, BATCH, HEIGHT, WIDTH,
                               cfg.data.transforms)
    timed_losses, losses = losses, []
    for _ in range(TRAIN_LEARN):
        step(draws)
    per_step = {k: v / TRAIN_TIMED for k, v in launches.items()}
    median_ms = statistics.median(step_ms)
    train = {'batch': BATCH, 'ids_x_instances': [TRAIN_IDS, TRAIN_INSTANCES],
             'dtype': 'bfloat16', 'step_ms_median': median_ms,
             'step_ms': step_ms, 'images_per_s': BATCH / median_ms * 1e3,
             'peak_memory_gb': peak_gb, 'losses': timed_losses,
             'learning_losses': losses,
             'bn_launches_per_step': per_step,
             'bn_modules_through_k3': len(bn),
             'bn_modules_without_backward': len(no_grad)}
    log('train', json.dumps({k: v for k, v in train.items()
                             if k not in ('losses', 'learning_losses',
                                          'step_ms')}))
    log('train losses', ' '.join('{:.4f}'.format(v) for v in timed_losses))
    log('learning losses', ' '.join('{:.4f}'.format(v) for v in losses))
    checks = []
    # two launches forward and two backward for each train-mode BN
    for name, want in (('bn_stats', len(bn)), ('bn_apply', len(bn)),
                       ('bn_grad_stats', len(bn) - len(no_grad)),
                       ('bn_dx', len(bn) - len(no_grad))):
        if per_step.get(name) != want:
            checks.append('{} launches per step {} != {}'.format(
                name, per_step.get(name), want))
    if not all(np.isfinite(timed_losses + losses)):
        checks.append('non-finite loss {} {}'.format(timed_losses, losses))
    if not np.mean(losses[-3:]) < np.mean(losses[:3]):
        checks.append('loss did not fall over {} steps: {}'.format(
            TRAIN_LEARN, losses))
    if checks:
        raise AssertionError('; '.join(checks))
    profile_out = profile_steps(torch, lambda: engine.forward_backward(batch))
    log('train profile', json.dumps({k: v for k, v in profile_out.items()
                                     if not k.startswith('top_')}))
    for row in profile_out['top_kernels']:
        log('  {:9.3f} ms {:5d} calls  {}'.format(row['ms'], row['calls'],
                                                  row['name']))
    log('  host, self time:')
    for row in profile_out['top_host_ops'][:8]:
        log('  {:9.3f} ms {:5d} calls  {}'.format(
            row['self_cpu_ms'], row['calls'], row['name']))
    train['profile'] = profile_out
    results['train'] = train
    results['train_launches'] = launches
    # the step's distinct BN inputs: (shape, dtype, channel_dim) ->
    # [forward calls, backward calls] a step
    shapes = {}
    for name, key in inputs.items():
        counts = shapes.setdefault(key, [0, 0])
        counts[0] += 1
        counts[1] += name not in no_grad
    del model, engine, batch
    torch.cuda.empty_cache()
    return sorted(shapes.items(), key=lambda kv: -np.prod(kv[0][0]))


def _whole_bn_ms(torch, x, dy, cd):
    """Train-mode BN forward alone and forward + backward (x, weight and
    bias gradients): the port's ``FastBatchNorm`` against
    ``F.batch_norm(training=True)`` with autograd, the library
    yardstick (the port never calls it)."""
    import torch.nn.functional as F
    from bpbreid_tpu_torch.models.common import FastBatchNorm
    c = x.shape[cd]
    bn = FastBatchNorm(c, channel_dim=cd, dtype=x.dtype).cuda().train()
    with torch.no_grad():
        bn.weight.fill_(1.0)
        bn.bias.zero_()
    xg = x.detach().requires_grad_(True)
    params = (xg, bn.weight, bn.bias)
    w = torch.ones(c, device='cuda', requires_grad=True)
    b = torch.zeros(c, device='cuda', requires_grad=True)
    rm, rv = torch.zeros(c, device='cuda'), torch.ones(c, device='cuda')
    x2, dy2 = _nc(xg, cd), _nc(dy, cd)

    def lib():
        return F.batch_norm(x2, rm, rv, w, b, True, 0.1, 1e-5)

    t = lambda fn: time_ms(fn, torch, warmup=2, iters=5,  # noqa: E731
                           repeats=3)
    with torch.no_grad():
        out = {'bn_fwd_ms': t(lambda: bn(xg)),
               'library_bn_fwd_ms': t(lib)}
    out['bn_fwd_bwd_ms'] = t(lambda: torch.autograd.grad(bn(xg), params, dy))
    out['library_bn_fwd_bwd_ms'] = t(lambda: torch.autograd.grad(
        lib(), (xg, w, b), dy2))
    return out


def phase_k3_step_shapes(torch, shapes, results,
                         result_key='k3_step_shapes', check=False):
    """The BN kernels at each distinct BN input of a train step (the
    shapes that forward hooks recorded: phase 6's, or with ``check``
    phase 13's, whose kernels are first held against their plain
    versions as phase 2 holds them), with their launches a step: times
    (CUDA events over back-to-back calls, which at the small shapes is
    the host's rate; and the device time from a CUDA graph) against
    their bounds and library calls, and the whole BN against
    ``F.batch_norm``. Per step: launches x ms, launches x bound and
    launches x (ms - bound), for K3 (bn_stats, bn_grad_stats) and for
    all four kernels."""
    gen = torch.Generator(device='cuda').manual_seed(SEED + 6)
    rows, failures = [], []
    for (shape, dt, cd), (n_fwd, n_bwd) in shapes:
        x = (0.5 + torch.randn(shape, device='cuda', generator=gen)).to(dt)
        dy = torch.randn(shape, device='cuda', generator=gen).to(dt)
        o = _bn_operands(torch, x, dy, cd, gen)
        row = {'shape': list(shape), 'dtype': str(dt), 'channel_dim': cd,
               'view': [o['a'], o['c'], o['b']], 'fwd_launches': n_fwd,
               'bwd_launches': n_bwd}
        if check:
            torch.cuda.synchronize()
            errs, failed = _check_bn_kernels(torch, x, dy, cd, o)
            row.update(errs)
            failures += ['{} at {} {}'.format(f, shape, dt) for f in failed]
        calls = _bn_calls(torch, x, dy, cd, o)
        row.update(_time_bn_calls(torch, calls, plain=False, iters=10))
        for name, (kernel, *_) in calls.items():
            row[name + '_graph_ms'] = graph_ms(torch, kernel)
        row.update(_whole_bn_ms(torch, x, dy, cd))
        log('K3 step shape', json.dumps(row))
        rows.append(row)
        del x, dy, o
    torch.cuda.empty_cache()

    def per_step(names, key):
        return sum(r[('fwd' if n in ('bn_stats', 'bn_apply') else 'bwd')
                     + '_launches'] * r[n + key] for r in rows for n in names)
    summary = {'shapes': len(rows),
               'fwd_bn_calls': sum(r['fwd_launches'] for r in rows),
               'bwd_bn_calls': sum(r['bwd_launches'] for r in rows)}
    for what, names in (('k3', ('bn_stats', 'bn_grad_stats')),
                        ('bn_kernels', BN_KERNELS)):
        ms, bound = per_step(names, '_ms'), per_step(names, '_bound_ms')
        summary.update({what + '_ms_per_step': ms,
                        what + '_bound_ms_per_step': bound,
                        what + '_lost_ms_per_step': ms - bound,
                        what + '_graph_ms_per_step': per_step(names,
                                                              '_graph_ms')})
    nf = lambda r: r['fwd_launches'] - r['bwd_launches']  # noqa: E731
    summary['bn_fwd_bwd_ms_per_step'] = sum(
        r['bwd_launches'] * r['bn_fwd_bwd_ms'] + nf(r) * r['bn_fwd_ms']
        for r in rows)
    summary['library_bn_fwd_bwd_ms_per_step'] = sum(
        r['bwd_launches'] * r['library_bn_fwd_bwd_ms']
        + nf(r) * r['library_bn_fwd_ms'] for r in rows)
    log('K3 step summary', json.dumps(summary))
    results[result_key] = {'rows': rows, 'summary': summary}
    if failures:
        raise AssertionError('\n'.join(failures))


def compare_train_steps(card, cpu, zero_in_exact=()):
    """One f32 train step on the card against the same on the CPU (each a
    dict of the loss, the parameters before, the gradients and the state
    after; Adam at ``LR``, ``WEIGHT_DECAY``): the summary and the failed
    checks, at phase 7's tolerances. Gradients whose names end in one of
    ``zero_in_exact`` are zero in exact arithmetic (the bias of a conv or
    Dense ahead of a train-mode BN): there both sides must stay below
    1e-5, float noise, and their ratio is not compared."""
    checks = []
    loss_rel = abs(card['loss'] - cpu['loss']) / abs(cpu['loss'])
    if not loss_rel <= 1e-5:
        checks.append('loss {} vs {}'.format(card['loss'], cpu['loss']))
    num = den = 0.0
    worst_grad = worst_zero = 0.0
    for k, g in cpu['grads'].items():
        if zero_in_exact and k.endswith(tuple(zero_in_exact)):
            worst_zero = max(worst_zero, g.abs().max().item(),
                             card['grads'][k].abs().max().item())
            continue
        d = card['grads'][k] - g
        num += float((d.double() ** 2).sum())
        den += float((g.double() ** 2).sum())
        scale = g.abs().max().item()
        if scale > 1e-6:
            worst_grad = max(worst_grad, d.abs().max().item() / scale)
    grad_rel_l2 = (num / den) ** 0.5
    if not (grad_rel_l2 <= 4e-2 and worst_grad <= 0.3):
        checks.append('gradients differ: rel L2 {}, worst tensor {}'.format(
            grad_rel_l2, worst_grad))
    worst_param = worst_bn = 0.0
    for k, w in cpu['state'].items():
        got = card['state'][k]
        diff = (got - w).abs()
        if k.endswith(('running_mean', 'running_var')):
            worst_bn = max(worst_bn, diff.max().item()
                           / (1 + w.abs().max().item()))
            continue
        if k not in cpu['grads']:
            continue
        p0 = cpu['before'][k]
        u = [(g + WEIGHT_DECAY * p0) / ((g + WEIGHT_DECAY * p0).abs() + 1e-8)
             for g in (card['grads'][k], cpu['grads'][k])]
        worst_param = max(worst_param, (diff - LR * (u[0] - u[1]).abs())
                          .abs().max().item())
    if not worst_bn <= 1e-4:
        checks.append('BN running statistics differ by {}'.format(worst_bn))
    if not worst_param <= 1e-6:
        checks.append('parameters differ from the Adam update by {}'
                      .format(worst_param))
    if not worst_zero <= 1e-5:
        checks.append('gradients zero in exact arithmetic reach {}'.format(
            worst_zero))
    summary = {'loss_card': card['loss'], 'loss_cpu': cpu['loss'],
               'grad_rel_l2': grad_rel_l2, 'grad_worst_tensor': worst_grad,
               'bn_stats_worst': worst_bn, 'param_worst': worst_param}
    if zero_in_exact:
        summary['zero_in_exact_grad_max'] = worst_zero
    return summary, checks


def phase_small_train_reference(torch, results):
    """One f32 train step of a depth-reduced model, 64x32, batch 8 (2
    identities x 4 instances), on the card and on the CPU, with the same
    weights and augmentation draws (TF32 off).

    At batch 8 the train-mode gradient is ill-conditioned: BN over as
    few as 16 values per channel, so the order of the f32 sums moves it
    by a few per cent (tests/test_torch_train_step.py measures the noise
    floor). Tolerances: loss 1e-5 relative; gradients 4e-2 relative L2
    over all parameters and per tensor 0.3 of its largest entry; BN
    statistics 1e-4 of their scale; parameters exactly Adam's first
    update from each side's gradient, lr * g / (|g| + eps), to 1e-6."""
    from bpbreid_tpu_torch.data.augment import sample_train_draws
    cfg = train_config(64, 32, 'float32', 64)
    stages = {'stage2': (1, 2, (2, 2), (32, 64)),
              'stage3': (1, 3, (2, 2, 2), (32, 64, 128)),
              'stage4': (1, 4, (2, 2, 2, 2), (32, 64, 128, 256))}
    cpu_batch = make_train_batch(np.random.default_rng(SEED + 3), 2, 4, 64,
                                 32, 'cpu')
    draws = sample_train_draws(torch.Generator().manual_seed(SEED), 8, 64,
                               32, cfg.data.transforms)
    out = {}
    for device in ('cuda', 'cpu'):
        model, engine = train_engine(torch, cfg, 7, device,
                                     backbone_stages=stages)
        before = {k: v.detach().cpu().clone()
                  for k, v in model.named_parameters()}
        dev_draws = {k: (None if v is None else
                         tuple(t.to(device) for t in v)
                         if isinstance(v, tuple) else v.to(device))
                     for k, v in draws.items()}
        loss, _ = engine.forward_backward(
            {k: v.to(device) for k, v in cpu_batch.items()}, draws=dev_draws)
        out[device] = {
            'loss': loss.item(), 'before': before,
            'grads': {k: v.grad.detach().cpu().clone()
                      for k, v in model.named_parameters()},
            'state': {k: v.detach().cpu().clone()
                      for k, v in model.state_dict().items()}}
    small, checks = compare_train_steps(out['cuda'], out['cpu'])
    log('small_f32_train_card_vs_cpu', json.dumps(small))
    results['small_train_card_vs_cpu'] = small
    if checks:
        raise AssertionError('; '.join(checks))


# phase 9: the CLI (scripts/main.py) on synthetic data at Market-1501's
# crop size: 16 identities x 3 cameras x 4 images a camera at 128x64,
# which the loader upsamples to 384x128 (fields 16x8 -> 48x16): 192 train
# images (3 steps of 16 ids x 4 an epoch), 192 query, 384 gallery
CLI_DATASET = 'smoke_market_crops'
CLI_IDS, CLI_CAMS, CLI_IMGS = 16, 3, 4
CLI_SRC_HW = (128, 64)
CLI_CONFIG = 'configs/bpbreid/bpbreid_market1501_train.yaml'
CLI_EPOCHS = 2
# checkpoints of a full-width model (hundreds of MB with Adam's moments)
# go to a gitignored directory, deleted at the end of the phase, not to
# chiprun_out/, which is kept for small result files
CLI_SAVE_DIR = os.path.join('_scratch', 'chip_smoke_cli')
CLI_EVAL_BATCHES = 3 + 6            # query, gallery at batch 64


def register_cli_dataset(name=CLI_DATASET, cams=CLI_CAMS):
    """A ``SyntheticDataset`` with the counts and crop size above (and
    ``cams`` cameras), in the port's registry under ``name`` (the
    dataset's own constructor arguments)."""
    from bpbreid_tpu_torch.data.datasets import (get_image_dataset,
                                                 register_image_dataset)
    from bpbreid_tpu_torch.data.datasets.image_datasets import \
        SyntheticDataset

    class SmokeMarketCrops(SyntheticDataset):
        dataset_dir = name

        def __init__(self, **kwargs):
            super().__init__(num_pids=CLI_IDS, num_cams=cams,
                             imgs_per_pid_cam=CLI_IMGS, height=CLI_SRC_HW[0],
                             width=CLI_SRC_HW[1], seed=SEED, **kwargs)
    try:
        get_image_dataset(name)
    except ValueError:
        register_image_dataset(name, SmokeMarketCrops)


def cli_argv(job_id, *opts, config=CLI_CONFIG, dataset=CLI_DATASET):
    """The CLI's argv: a train config as shipped (the Market-1501 one by
    default: HRNet-W32, 384x128, five_v, bf16, batch 64, visrank on) on
    the smoke dataset."""
    return (['--config-file', config, '--save_dir', CLI_SAVE_DIR,
             '--job-id', str(job_id),
             'data.sources', "['{}']".format(dataset),
             'data.targets', "['{}']".format(dataset),
             'train.eval_freq', '-1'] + list(opts))


class CliRecorder:
    """Wraps ``forward_backward``, ``forward_backward_multi``,
    ``save_model`` and (the part-based engine's) ``_visrank`` of the
    engine class ``cls`` (the part-based engine by default) for one CLI
    run: each step's host entry time (a group's once, with its step
    count), loss tensor and BN launches (a group's per step), the
    train-mode FastBatchNorm calls of each step (forward hooks, set on
    the first step) and the first step's BN inputs (shape, dtype,
    channel_dim -> calls), the first batch as the prefetch put it on the
    card, the checkpoint's path and write seconds, and the ranking grids'
    files, seconds and launches (the ``eval_step`` run again for their
    attention maps). The hooks' counts are replayed with the CUDA graphs'
    launch counts (``engine.graphs.replayed_counter``): a replay runs the
    calls its capture recorded. Reads nothing back from the card during
    the steps."""

    def __init__(self, torch, cls=None):
        from bpbreid_tpu_torch.engine.part_based import ImagePartBasedEngine
        self.torch, self.cls = torch, cls or ImagePartBasedEngine
        self.fb = self.cls.forward_backward
        self.fb_multi = self.cls.forward_backward_multi
        self.save = self.cls.save_model
        self.visrank = getattr(self.cls, '_visrank', None)
        self.entries, self.losses, self.launches = [], [], []
        self.entry_steps = []
        self.bn_calls = {'train': 0, 'eval': 0}
        self.train_bn_calls = []
        self.first_step_inputs = []
        self.first_batch = self.checkpoint = self.save_s = None
        self.visrank_paths, self.visrank_s, self.visrank_launches = [], 0.0, {}

    def _hook(self, mod, inp):
        self.bn_calls['train' if mod.training else 'eval'] += 1
        if mod.training and len(self.entries) == 1 \
                and not self.torch.cuda.is_current_stream_capturing():
            self.first_step_inputs.append((tuple(inp[0].shape), inp[0].dtype,
                                           mod.channel_dim))

    @property
    def bn_inputs(self):
        """The first step's BN inputs (shape, dtype, channel_dim ->
        calls): the first Python run's calls of the hooks."""
        n = self.train_bn_calls[0] if self.train_bn_calls else 0
        return collections.Counter(self.first_step_inputs[:n])

    def step_intervals_ms(self):
        """Host ms between step entries, a group's interval split over
        its steps."""
        return [(b - a) * 1e3 / n
                for a, b, n in zip(self.entries, self.entries[1:],
                                   self.entry_steps)
                for _ in range(n)]

    def _first(self, engine, batch, step):
        from bpbreid_tpu_torch.models.common import FastBatchNorm
        if self.first_batch is None:
            for m in engine.model.modules():
                if isinstance(m, FastBatchNorm):
                    m.register_forward_pre_hook(self._hook)
            self.first_batch = {
                k: (batch[k] if step is None else batch[k][step]).cpu().clone()
                for k in ('image', 'mask', 'pid') if batch.get(k) is not None}

    def __enter__(self):
        from bpbreid_tpu_torch.engine.graphs import replayed_counter
        from bpbreid_tpu_torch.ops.cuda.build import launch_counts
        rec = self
        self._replayed = replayed_counter(self.bn_calls)
        self._replayed.__enter__()

        def forward_backward(engine, batch, draws=None):
            rec._first(engine, batch, None)
            rec.entries.append(time.perf_counter())
            rec.entry_steps.append(1)
            before = dict(launch_counts)
            calls = rec.bn_calls['train']
            loss, summary = rec.fb(engine, batch, draws)
            rec.launches.append({k: launch_counts[k] - before.get(k, 0)
                                 for k in BN_KERNELS})
            rec.train_bn_calls.append(rec.bn_calls['train'] - calls)
            rec.losses.append(loss)
            return loss, summary

        def forward_backward_multi(engine, batch, draws=None):
            k = batch['image'].shape[0]
            rec._first(engine, batch, 0)
            rec.entries.append(time.perf_counter())
            rec.entry_steps.append(k)
            before = dict(launch_counts)
            calls = rec.bn_calls['train']
            losses, summary = rec.fb_multi(engine, batch, draws)
            per_step = {n: (launch_counts[n] - before.get(n, 0)) / k
                        for n in BN_KERNELS}
            rec.launches += [{n: int(v) if v == int(v) else v
                              for n, v in per_step.items()}
                             for _ in range(k)]
            calls = (rec.bn_calls['train'] - calls) / k
            rec.train_bn_calls += [int(calls) if calls == int(calls)
                                   else calls] * k
            rec.losses += list(losses.unbind(0))
            return losses, summary

        def save_model(engine, *args, **kwargs):
            rec.torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = rec.save(engine, *args, **kwargs)
            if path is not None:
                rec.checkpoint, rec.save_s = path, time.perf_counter() - t0
            return path

        def visrank(engine, *args, **kwargs):
            rec.torch.cuda.synchronize()
            before = dict(launch_counts)
            t0 = time.perf_counter()
            paths = rec.visrank(engine, *args, **kwargs)
            rec.torch.cuda.synchronize()
            rec.visrank_s += time.perf_counter() - t0
            rec.visrank_paths += paths
            for k, v in launch_counts.items():
                rec.visrank_launches[k] = (rec.visrank_launches.get(k, 0)
                                           + v - before.get(k, 0))
            return paths

        self.cls.forward_backward = forward_backward
        self.cls.forward_backward_multi = forward_backward_multi
        self.cls.save_model = save_model
        if self.visrank is not None:
            self.cls._visrank = visrank
        return self

    def __exit__(self, *exc):
        self.cls.forward_backward, self.cls.save_model = self.fb, self.save
        self.cls.forward_backward_multi = self.fb_multi
        self._replayed.__exit__(*exc)
        if self.visrank is not None:
            self.cls._visrank = self.visrank
        return False


def drive_cli(torch, what, argv, cls=None):
    """``scripts.main.main(argv)`` with every launch count set to 0 just
    before and read just after, the engine class ``cls`` (the part-based
    engine by default) recorded. Returns the engine, ``(cmc, mAP, ssmd,
    pixel accuracy)``, the counts, the recorder and the wall seconds."""
    from bpbreid_tpu_torch.data.datasets import clear_dataset_cache
    from bpbreid_tpu_torch.ops.cuda.build import (launch_counts,
                                                  reset_launch_counts)
    from bpbreid_tpu_torch.scripts.main import main as cli_main
    clear_dataset_cache()
    with CliRecorder(torch, cls) as rec:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        engine, result = cli_main(argv)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = {k: v for k, v in launch_counts.items()}
    log('  {}: {:.1f} s, launches {}'.format(what, wall_s, counts))
    return engine, result, counts, rec, wall_s


# the modules of each stream's embeddings (its after-pooling reduction)
# and of its identity scores (its BNNeck), by loss-weight key
STREAM_MODULES = {'globl': ('global_after_pooling_dim_reduce',
                            'global_identity_classifier'),
                  'foreg': ('foreground_after_pooling_dim_reduce',
                            'foreground_identity_classifier'),
                  'conct': ('parts_after_pooling_dim_reduce',
                            'concat_parts_identity_classifier'),
                  'parts': ('parts_after_pooling_dim_reduce',
                            'parts_identity_classifier')}


def _bn_split(model, weights):
    """Phase 6's split of a model's FastBatchNorms: those that run the
    BN kernels in train mode (all but the pixel classifier's, whose
    statistics are plain ops) and those of them that get no backward:
    the head modules of streams that feed no loss under the GiLt
    ``weights`` (a triplet term reads a stream's embeddings, an identity
    term its BNNeck scores; the background stream feeds none)."""
    from bpbreid_tpu_torch.models.common import FastBatchNorm
    bn = [n for n, mod in model.named_modules()
          if isinstance(mod, FastBatchNorm) and n != 'pixel_classifier.bn']
    heads = {m for mods in STREAM_MODULES.values() for m in mods}
    heads |= {'background_after_pooling_dim_reduce',
              'background_identity_classifier'}
    fed = set()
    for key, (reduce, neck) in STREAM_MODULES.items():
        if weights[key]['tr'] > 0 or weights[key]['id'] > 0:
            fed.add(reduce)
        if weights[key]['id'] > 0:
            fed.add(neck)
    no_grad = [n for n in bn if n.split('.')[0] in heads - fed]
    return bn, no_grad


def _step_launch_checks(rec, bn, no_grad, what):
    """Every train step launches two forward BN kernels for each
    train-mode BN call (forward hooks) and two backward ones for each
    that gets a gradient."""
    want = {'bn_stats': len(bn), 'bn_apply': len(bn),
            'bn_grad_stats': len(bn) - len(no_grad),
            'bn_dx': len(bn) - len(no_grad)}
    bad = ['{}: BN launches a step {} != {}'.format(what, c, want)
           for c in rec.launches if c != want][:1]
    bad += ['{}: {} train-mode BN calls a step by hooks, {} kernel-backed '
            'BNs'.format(what, n, len(bn))
            for n in set(rec.train_bn_calls) if n != len(bn)]
    return want, bad


def phase_cli(torch, results):
    """Phase 9 (see the module docstring). Returns the phase's numbers
    and the launch counts of 9a (BN kernels) and 9c (K2)."""
    import shutil
    from bpbreid_tpu_torch.data.datasets import clear_dataset_cache
    from bpbreid_tpu_torch.scripts.main import build_model_engine
    from bpbreid_tpu_torch.utils.checkpoint import load_checkpoint
    t_phase = time.perf_counter()
    register_cli_dataset()
    shutil.rmtree(CLI_SAVE_DIR, ignore_errors=True)
    out, checks = {}, []
    steps_per_epoch = CLI_IDS * CLI_CAMS * CLI_IMGS // BATCH
    phase6 = results['train']

    # 9a: two epochs of training, the final test, a checkpoint
    engine, (cmc, mAP, _, _), counts_a, rec, wall_a = drive_cli(
        torch, '9a train', cli_argv(91, 'train.max_epoch', str(CLI_EPOCHS),
                        'model.save_model_flag', 'True'))
    losses = [float(v) for v in rec.losses]
    bn, no_grad = _bn_split(engine.model, engine.losses_weights)
    want, bad = _step_launch_checks(rec, bn, no_grad, '9a')
    checks += bad
    if want != {k: phase6['bn_launches_per_step'][k] for k in BN_KERNELS}:
        checks.append('9a: BN launches a step {} differ from phase 6 {}'
                      .format(want, phase6['bn_launches_per_step']))
    steps = len(losses)
    eval_apply = counts_a.get('bn_apply', 0) - steps * want['bn_apply']
    vis_apply = rec.visrank_launches.get('bn_apply', 0)
    if steps != CLI_EPOCHS * steps_per_epoch:
        checks.append('9a: {} steps'.format(steps))
    if eval_apply != rec.bn_calls['eval'] \
            or eval_apply - vis_apply != CLI_EVAL_BATCHES * len(bn):
        checks.append('9a: eval bn_apply {} ({} in visrank) != {} eval-mode '
                      'BN calls, {} x {} + visrank'.format(
                          eval_apply, vis_apply, rec.bn_calls['eval'],
                          CLI_EVAL_BATCHES, len(bn)))
    checks += _visrank_checks(rec, engine, bn, '9a')
    if not all(np.isfinite(losses)):
        checks.append('9a: non-finite loss {}'.format(losses))
    intervals = rec.step_intervals_ms()
    step_ms = statistics.median(intervals)
    data_ms = engine.writer.data_loading_timer.meter.avg * 1e3
    ckpt, save_s = rec.checkpoint, rec.save_s
    if ckpt is None:
        raise AssertionError('9a: the run wrote no checkpoint')
    t0 = time.perf_counter()
    load_checkpoint(ckpt)
    read_s = time.perf_counter() - t0
    # the first step against forward_backward on the loader's first
    # host batch, with a fresh engine of the same config: the same
    # seeded weights and generator, so the same draws
    cfg, first_loss, first_dev = engine.config, losses[0], rec.first_batch
    rec_paths, rec_visrank_s = rec.visrank_paths, rec.visrank_s
    del engine, rec
    torch.cuda.empty_cache()
    clear_dataset_cache()
    direct, _ = build_model_engine(cfg)
    host = next(iter(direct.datamanager.train_loader))
    batch_equal = all(torch.equal(first_dev[k], torch.as_tensor(host[k]))
                      for k in ('image', 'mask', 'pid'))
    if not batch_equal:
        checks.append('9a: the first prefetched batch differs from the host '
                      'batch')
    direct_loss = float(direct.forward_backward(host)[0])
    first_rel = abs(first_loss - direct_loss) / abs(direct_loss)
    if not first_rel <= 1e-5:
        checks.append('9a: first loss {} vs forward_backward {} ({:.2e})'
                      .format(first_loss, direct_loss, first_rel))
    del direct
    torch.cuda.empty_cache()
    out['9a'] = {
        'steps': steps, 'losses': losses, 'step_ms_median': step_ms,
        'step_ms': intervals, 'data_time_ms': data_ms,
        'images_per_s': BATCH / step_ms * 1e3,
        'phase6_step_ms_median': phase6['step_ms_median'],
        'cli_over_phase6_step': step_ms / phase6['step_ms_median'],
        'rank1': float(cmc[0]), 'mAP': float(mAP),
        'bn_launches_per_step': want, 'eval_bn_apply': eval_apply,
        'visrank_figures': len(rec_paths), 'visrank_s': rec_visrank_s,
        'visrank_bn_apply': vis_apply,
        'launches': counts_a, 'first_loss_rel_err': first_rel,
        'first_batch_bit_equal': batch_equal,
        'checkpoint_mb': os.path.getsize(ckpt) / 1e6,
        'checkpoint_write_s': save_s, 'checkpoint_read_s': read_s,
        'wall_s': wall_a}

    # 9b: test only from 9a's checkpoint
    engine, (cmc_b, mAP_b, _, _), counts_b, rec, wall_b = drive_cli(
        torch, '9b test from the checkpoint', cli_argv(92, 'test.evaluate', 'True',
                        'model.load_weights', ckpt, 'test.visrank', 'False'))
    d_cmc = float(np.abs(np.asarray(cmc_b) - np.asarray(cmc)).max())
    d_map = abs(float(mAP_b) - float(mAP))
    if rec.losses or not (d_cmc <= 1e-6 and d_map <= 1e-6):
        checks.append('9b: CMC {} / mAP {} off 9a by {}, {}'.format(
            cmc_b[:1], mAP_b, d_cmc, d_map))
    if counts_b.get('bn_apply') != CLI_EVAL_BATCHES * len(bn) \
            or counts_b.get('bn_stats', 0):
        checks.append('9b: BN launches {}'.format(counts_b))
    out['9b'] = {'cmc_max_abs_diff': d_cmc, 'mAP_abs_diff': d_map,
                 'launches': counts_b, 'wall_s': wall_b}
    del engine, rec
    torch.cuda.empty_cache()

    # 9c: test only through K2 (materialized map, fused pooling)
    engine, _, counts_c, rec, wall_c = drive_cli(
        torch, '9c test through K2', cli_argv(93, 'test.evaluate', 'True', 'test.visrank', 'False',
                        'model.bpbreid.use_pallas_pooling', 'True',
                        'model.bpbreid.multires_pooling', 'False'))
    want_c = {'attention_pool': CLI_EVAL_BATCHES,
              'bn_apply': CLI_EVAL_BATCHES * len(bn)}
    got_c = {k: v for k, v in counts_c.items() if v}
    if got_c != want_c:
        checks.append('9c: launches {} != {}'.format(got_c, want_c))
    out['9c'] = {'launches': counts_c, 'wall_s': wall_c}
    del engine, rec
    torch.cuda.empty_cache()

    # 9d: the ResNet-50 backbone, one epoch and the final test
    engine, (cmc_d, mAP_d, _, _), counts_d, rec, wall_d = drive_cli(
        torch, '9d resnet50', cli_argv(94, 'train.max_epoch', '1', 'test.visrank', 'False',
                        'model.bpbreid.backbone', 'resnet50'))
    losses_d = [float(v) for v in rec.losses]
    bn_d, no_grad_d = _bn_split(engine.model, engine.losses_weights)
    want_d, bad = _step_launch_checks(rec, bn_d, no_grad_d, '9d')
    checks += bad
    if len(losses_d) != steps_per_epoch or not all(np.isfinite(losses_d)):
        checks.append('9d: losses {}'.format(losses_d))
    d_ms = statistics.median(rec.step_intervals_ms())
    out['9d'] = {'steps': len(losses_d), 'losses': losses_d,
                 'step_ms_median': d_ms,
                 'bn_launches_per_step': want_d,
                 'train_mode_bn_calls_by_hooks': rec.train_bn_calls,
                 'launches': counts_d,
                 'rank1': float(cmc_d[0]), 'mAP': float(mAP_d),
                 'wall_s': wall_d}
    del engine, rec
    torch.cuda.empty_cache()
    shutil.rmtree(CLI_SAVE_DIR, ignore_errors=True)
    out['phase_s'] = time.perf_counter() - t_phase
    results['cli'] = out
    if checks:
        raise AssertionError('; '.join(checks))
    return counts_a, counts_c


def _streams(engine):
    """Columns of a ranking grid after the image: the test embedding
    streams (a part-wise key counts its parts)."""
    k = engine.model.parts_num
    return sum(k if key in ('parts', 'bn_parts') else 1
               for key in engine.test_embeddings)


def _visrank_checks(rec, engine, bn, what):
    """The run's ranking grids: one per selected query (``visrank_count``
    of them), each decoding with the port's ``read_image`` to ``(topk+1)
    x (P+1)`` cells, with a ``tEXt`` title for every cell and the
    suptitle; the recompute of their attention maps launched one
    ``bn_apply`` per eval-mode BN of its two padded batches (query,
    gallery) per figure."""
    from bpbreid_tpu_torch.data.datasets.dataset import (read_image,
                                                         read_png_text)
    from bpbreid_tpu_torch.utils.visualization.rankings import (
        BORDER, GRID_SPACING, THUMB_HW)
    cfg = engine.config.test
    rows, cols = cfg.visrank_topk + 1, _streams(engine) + 1
    shape = (rows * (THUMB_HW[0] + 2 * BORDER) + (rows - 1) * GRID_SPACING,
             cols * (THUMB_HW[1] + 2 * BORDER) + (cols - 1) * GRID_SPACING,
             3)
    titles = {'r{}c{}'.format(r, c) for r in range(rows)
              for c in range(cols)} | {'suptitle'}
    paths, bad = rec.visrank_paths, []
    if len(paths) != max(cfg.visrank_count, len(cfg.visrank_q_idx_list)):
        bad.append('{}: {} ranking grids'.format(what, len(paths)))
    for path in paths:
        img, text = read_image(path), read_png_text(path)
        if img.shape != shape or not titles <= set(text):
            bad.append('{}: {} is {} with {} titles, not {} with {}'.format(
                what, os.path.basename(path), img.shape, len(text), shape,
                len(titles)))
    want = {'bn_apply': 2 * len(paths) * len(bn)}
    got = {k: v for k, v in rec.visrank_launches.items() if v}
    if got != want:
        bad.append('{}: visrank launches {} != {}'.format(what, got, want))
    return bad[:3]


# phase 11: the PCB config as shipped (horizontal stripes, HRNet-W32 at
# full depth, 384x128, bf16, batch 64, visrank on) through the CLI on
# phase 9's set, the BoT model, the optax-rule optimizers on the PCB
# model's gradients, and the after-pooling dropout
PCB_CONFIG = 'configs/bpbreid/pcb_market1501_train.yaml'
OPTIMS = ('amsgrad', 'rmsprop', 'radam')
OPT_LEARN_STEPS = 20


def phase_pcb(torch, results):
    """Phase 11 (see the module docstring). Returns the launch counts of
    11a (the CLI run) and 11b (BoT's step and eval batch)."""
    import copy
    import shutil
    from bpbreid_tpu_torch.config import optimizer_kwargs
    from bpbreid_tpu_torch.data.augment import sample_train_draws
    from bpbreid_tpu_torch.engine.part_based import ImagePartBasedEngine
    from bpbreid_tpu_torch.models import build_model
    from bpbreid_tpu_torch.ops.cuda.build import (launch_counts,
                                                  reset_launch_counts)
    from bpbreid_tpu_torch.optim import build_optimizer
    t_phase = time.perf_counter()
    register_cli_dataset()
    shutil.rmtree(CLI_SAVE_DIR, ignore_errors=True)
    out, checks = {}, []
    steps_per_epoch = CLI_IDS * CLI_CAMS * CLI_IMGS // BATCH

    # 11a: the PCB config through the CLI: two epochs, the test, visrank
    engine, (cmc, mAP, _, _), counts_a, rec, wall_a = drive_cli(
        torch, '11a pcb', cli_argv(111, 'train.max_epoch', str(CLI_EPOCHS),
                                   config=PCB_CONFIG))
    model = engine.model
    if not model.horizontal_stripes or hasattr(model, 'pixel_classifier') \
            or model.parts_num != 6 or model.dtype != torch.bfloat16:
        checks.append('11a: not the bf16 six-stripe model')
    losses = [float(v) for v in rec.losses]
    bn, no_grad = _bn_split(model, engine.losses_weights)
    want, bad = _step_launch_checks(rec, bn, no_grad, '11a')
    checks += bad
    vis_apply = rec.visrank_launches.get('bn_apply', 0)
    eval_apply = counts_a.get('bn_apply', 0) - len(losses) * want['bn_apply']
    if len(losses) != CLI_EPOCHS * steps_per_epoch \
            or not all(np.isfinite(losses)):
        checks.append('11a: losses {}'.format(losses))
    if counts_a.get('attention_pool', 0):
        checks.append('11a: K2 launched {} times under stripes'.format(
            counts_a['attention_pool']))
    if eval_apply != rec.bn_calls['eval'] \
            or eval_apply - vis_apply != CLI_EVAL_BATCHES * len(bn):
        checks.append('11a: eval bn_apply {} ({} in visrank) for {} '
                      'eval-mode BN calls'.format(eval_apply, vis_apply,
                                                  rec.bn_calls['eval']))
    checks += _visrank_checks(rec, engine, bn, '11a')
    step_ms = statistics.median(rec.step_intervals_ms())
    out['11a'] = {'steps': len(losses), 'losses': losses,
                  'step_ms_median': step_ms,
                  'images_per_s': BATCH / step_ms * 1e3,
                  'rank1': float(cmc[0]), 'mAP': float(mAP),
                  'bn_modules': len(bn), 'bn_no_backward': len(no_grad),
                  'bn_launches_per_step': want,
                  'eval_bn_apply': eval_apply - vis_apply,
                  'visrank_figures': len(rec.visrank_paths),
                  'visrank_s': rec.visrank_s, 'visrank_bn_apply': vis_apply,
                  'launches': counts_a, 'wall_s': wall_a}
    cfg = engine.config
    host = next(iter(engine.datamanager.train_loader))
    batch = {k: torch.as_tensor(host[k]).cuda() for k in ('image', 'pid')}
    del rec

    # 11b: BoT (one stripe, no attention) at full width: a train step and
    # an eval batch
    num_classes = engine.datamanager.num_train_pids
    cfg_b = copy.deepcopy(cfg)
    bot = build_model('bot', num_classes, config=cfg_b, device='cuda',
                      seed=SEED)
    bot_engine = ImagePartBasedEngine.from_config(
        cfg_b, bot, device='cuda',
        optimizer=build_optimizer(bot, **optimizer_kwargs(cfg_b)))
    bn_b, no_grad_b = _bn_split(bot, bot_engine.losses_weights)
    torch.cuda.synchronize()
    reset_launch_counts()
    loss_b = float(bot_engine.forward_backward(batch)[0])
    train_b = {k: v for k, v in launch_counts.items() if v}
    reset_launch_counts()
    feats_b = bot_engine.eval_step(batch['image'])[0]
    torch.cuda.synchronize()
    eval_b = {k: v for k, v in launch_counts.items() if v}
    want_b = {'bn_stats': len(bn_b), 'bn_apply': len(bn_b),
              'bn_grad_stats': len(bn_b) - len(no_grad_b),
              'bn_dx': len(bn_b) - len(no_grad_b)}
    if bot.parts_num != 1 or train_b != want_b \
            or eval_b != {'bn_apply': len(bn_b)} or not np.isfinite(loss_b) \
            or not bool(torch.isfinite(feats_b.float()).all()):
        checks.append('11b: parts {}, train launches {} (want {}), eval {} '
                      '(want {} bn_apply), loss {}'.format(
                          bot.parts_num, train_b, want_b, eval_b, len(bn_b),
                          loss_b))
    out['11b'] = {'loss': loss_b, 'train_launches': train_b,
                  'eval_launches': eval_b, 'bn_modules': len(bn_b),
                  'features_shape': list(feats_b.shape)}
    counts_b = {k: train_b.get(k, 0) + eval_b.get(k, 0)
                for k in set(train_b) | set(eval_b)}
    del bot, bot_engine, feats_b
    torch.cuda.empty_cache()

    # 11c: amsgrad, rmsprop, radam on the PCB model's gradients
    draws = sample_train_draws(engine.generator, BATCH, HEIGHT, WIDTH,
                               engine.transforms, **engine.cj)
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    cpu_model = build_model(cfg.model.name, num_classes,
                            config=copy.deepcopy(cfg), device='cpu')
    params = dict(model.named_parameters())
    cpu_params = dict(cpu_model.named_parameters())
    eps32 = float(np.finfo(np.float32).eps)
    out['11c'] = {}
    for optim in OPTIMS:
        model.load_state_dict(state0)
        kw = dict(optimizer_kwargs(cfg), optim=optim)
        opt = engine.optimizer = build_optimizer(model, **kw)
        real_step, prof, calls = opt.step, {}, []

        def step(opt=opt, real_step=real_step, prof=prof, calls=calls):
            # the second step is profiled: the first also allocates the
            # state, one fill per tensor
            calls.append(1)
            if len(calls) < 2:
                return real_step()
            opt.step = real_step
            prof.update(profile_steps(torch, real_step, steps=1))
        opt.step = step
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        losses = [float(engine.forward_backward(batch, draws)[0])]
        # the same update on the CPU, from the same parameters and
        # gradients
        cpu_model.load_state_dict({k: v.cpu() for k, v in state0.items()})
        for n, p in cpu_params.items():
            p.grad = params[n].grad.cpu()
        build_optimizer(cpu_model, **kw).step()
        worst, moved = 0.0, 0.0
        for n, p in params.items():
            ref = cpu_params[n].detach()
            delta = (ref - before[n].cpu()).abs().max().item()
            moved = max(moved, delta)
            err = (p.detach().cpu() - ref).abs()
            excess = (err - eps32 * ref.abs()).max().item()
            worst = max(worst, excess / max(delta, 1e-30))
        for _ in range(OPT_LEARN_STEPS - 1):
            losses.append(float(engine.forward_backward(batch, draws)[0]))
        learned = np.mean(losses[-3:]) < np.mean(losses[:3])
        if not worst <= 1e-6 or not learned:
            checks.append('11c {}: card vs CPU update error {:.2e} of the '
                          'update (beyond one ulp), losses {:.3f} -> {:.3f}'
                          .format(optim, worst, losses[0], losses[-1]))
        out['11c'][optim] = {
            'update_rel_err_beyond_ulp': worst, 'update_max_abs': moved,
            'step_device_kernel_launches': prof.get('device_kernel_launches'),
            'step_device_ms': prof.get('device_busy_ms'),
            'losses': losses}
    del cpu_model, cpu_params, params, state0
    engine.optimizer = None
    del engine, model
    torch.cuda.empty_cache()

    # 11d: the after_pooling_with_dropout model on the card
    cfg_d = train_config()
    cfg_d.model.bpbreid.dim_reduce = 'after_pooling_with_dropout'
    drop = build_model('bpbreid', 751, config=cfg_d, device='cuda',
                       seed=SEED)
    plain = build_model('bpbreid', 751, config=train_config(), device='cuda',
                        seed=SEED)
    plain.load_state_dict(drop.state_dict())
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    x = torch.randn(BATCH, 3, HEIGHT, WIDTH, device='cuda', generator=gen)
    with torch.no_grad():
        a, b = drop(x)[0], plain(x)[0]
        eval_equal = all(torch.equal(a[k], b[k]) for k in a)
        red = drop.global_after_pooling_dim_reduce.train()
        feats = torch.randn(BATCH, red.layers[0].weight.shape[1],
                            device='cuda', generator=gen).to(torch.bfloat16)
        ref = plain.global_after_pooling_dim_reduce.train()
        masks = []
        for _ in range(2):
            red.layers[3].generator = torch.Generator(
                device='cuda').manual_seed(SEED)
            masks.append(red(feats))
        undropped = ref(feats)
    kept = masks[0] != 0
    positive = undropped > 0
    share = float((kept & positive).sum()) / float(positive.sum())
    same = torch.equal(masks[0], masks[1])
    scaled = torch.equal(masks[0][kept], 2 * undropped[kept])
    if not (eval_equal and same and scaled and abs(share - 0.5) <= 0.02):
        checks.append('11d: eval equal {}, same mask {}, kept x2 {}, kept '
                      'share {:.4f}'.format(eval_equal, same, scaled, share))
    out['11d'] = {'eval_bit_equal': eval_equal, 'same_seed_same_mask': same,
                  'kept_scaled_by_2': scaled, 'kept_share': share,
                  'dims': int(undropped.shape[-1])}
    del drop, plain, red, ref
    torch.cuda.empty_cache()
    shutil.rmtree(CLI_SAVE_DIR, ignore_errors=True)
    out['phase_s'] = time.perf_counter() - t_phase
    results['pcb'] = out
    if checks:
        raise AssertionError('; '.join(checks))
    return counts_a, counts_b


# phase 10: the inference path. A torchreid file of a seeded full-width
# model (751 classes, Market-1501's training identities) through the test
# CLI, the HRNet ImageNet file through a training start, the
# FeatureExtractor on crops of mixed sizes, --inference-enabled on a
# folder of PNG crops, and the test options rerank and save_features; the
# files go to CLI_SAVE_DIR and are deleted at the end
INF_CONFIG = 'configs/bpbreid/bpbreid_market1501_test.yaml'
INF_CLASSES = 751
INF_BATCHES = 3                     # FeatureExtractor batches of 64
INF_MIN_HW, INF_MAX_HW = (80, 40), (400, 150)
INF_PNGS = 192
INF_CHUNK = 50                      # extract_reid_features' chunk size
BACKBONE = 'backbone_appearance_feature_extractor.'


def write_png(path, img):
    """A few-line PNG encoder: 8-bit RGB, row filter 0, zlib."""
    h, w, _ = img.shape
    raw = b''.join(b'\x00' + img[y].tobytes() for y in range(h))

    def chunk(kind, body):
        return (struct.pack('>I', len(body)) + kind + body
                + struct.pack('>I', zlib.crc32(kind + body)))
    with open(path, 'wb') as f:
        f.write(b'\x89PNG\r\n\x1a\n'
                + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 2, 0, 0, 0))
                + chunk(b'IDAT', zlib.compress(raw)) + chunk(b'IEND', b''))


def mixed_crops(rng, n):
    """``n`` seeded RGB uint8 crops from 80x40 to 400x150."""
    hs = rng.integers(INF_MIN_HW[0], INF_MAX_HW[0] + 1, n)
    ws = rng.integers(INF_MIN_HW[1], INF_MAX_HW[1] + 1, n)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for h, w in zip(hs, ws)]


def inference_argv(job_id, *opts, flags=()):
    """The test CLI's argv: the Market-1501 test config (HRNet-W32,
    384x128, five_v, test embeddings bn_foreg + parts, batch 64) in bf16
    with the serving pooling (K2), on the smoke dataset."""
    return (['--config-file', INF_CONFIG, '--save_dir', CLI_SAVE_DIR,
             '--job-id', str(job_id)] + list(flags)
            + ['data.sources', "['{}']".format(CLI_DATASET),
               'data.targets', "['{}']".format(CLI_DATASET),
               'model.compute_dtype', 'bfloat16',
               'model.bpbreid.use_pallas_pooling', 'True',
               'model.bpbreid.multires_pooling', 'False'] + list(opts))


class Recorder:
    """Wraps ``module.name`` for a run: each call's return value and its
    seconds (ending in a synchronize)."""

    def __init__(self, torch, module, name):
        self.torch, self.module, self.name = torch, module, name
        self.fn, self.values, self.seconds = getattr(module, name), [], []

    def __enter__(self):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            value = self.fn(*args, **kwargs)
            self.torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            self.values.append(value)
            return value
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)
        return False


def _max_diff(a, b):
    return float((a.float() - b.float()).abs().max())


def _qg_stats_f64(d, bp, q_vis, g_vis):
    """The writer's statistics in numpy float64 on the CPU."""
    d, bp = d.cpu().double().numpy(), bp.cpu().double().numpy()
    valid = d != -1
    out = {'qg_dist_mean': d[valid].mean(), 'qg_dist_std': d[valid].std(),
           'qg_invalid_frac': (~valid).mean(),
           'qg_uncomparable_queries_frac': (~valid.any(axis=1)).mean(),
           'q_vis_mean': q_vis.double().mean().item(),
           'g_vis_mean': g_vis.double().mean().item()}
    ok = bp != -1
    cnt = np.maximum(ok.sum(axis=(1, 2)), 1)
    mu = np.where(ok, bp, 0).sum(axis=(1, 2)) / cnt
    out['part_pair_availability'] = ok.mean(axis=(1, 2))
    out['part_dist_mean'] = mu
    out['part_dist_std'] = np.sqrt(np.where(
        ok, (bp - mu[:, None, None]) ** 2, 0).sum(axis=(1, 2)) / cnt)
    out['q_part_visibility'] = q_vis.double().mean(0).cpu().numpy()
    out['g_part_visibility'] = g_vis.double().mean(0).cpu().numpy()
    return out


def torchreid_state_dict(torch, state_dict):
    """A port state dict as torchreid's ``DataParallel`` checkpoints hold
    it: ``module.`` keys and a ``num_batches_tracked`` for each BN."""
    sd = {'module.' + k: v for k, v in state_dict.items()}
    for k in state_dict:
        if k.endswith('.running_mean'):
            sd['module.' + k[:-len('running_mean')] + 'num_batches_tracked'] \
                = torch.tensor(0)
    return sd


def _add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def phase_inference(torch, results):
    """Phase 10 (see the module docstring). Returns the launch counts of
    its runs, summed."""
    import shutil
    import types
    from bpbreid_tpu_torch.engine import part_based
    from bpbreid_tpu_torch.engine.part_based import (ImagePartBasedEngine,
                                                     normalize)
    from bpbreid_tpu_torch.metrics.distance import \
        compute_distance_matrix_using_bp_features
    from bpbreid_tpu_torch.metrics.rank import evaluate_rank
    from bpbreid_tpu_torch.models import build_model
    from bpbreid_tpu_torch.models.common import FastBatchNorm
    from bpbreid_tpu_torch.ops.cuda.build import (launch_counts,
                                                  reset_launch_counts)
    from bpbreid_tpu_torch.scripts import main as cli
    from bpbreid_tpu_torch.tools import FeatureExtractor
    from bpbreid_tpu_torch.utils.rerank import re_ranking
    t_phase = time.perf_counter()
    register_cli_dataset()
    shutil.rmtree(CLI_SAVE_DIR, ignore_errors=True)
    os.makedirs(os.path.join(CLI_SAVE_DIR, 'imagenet'))
    out, checks, total = {}, [], {}
    n_bn = results['serving']['eval_bn_calls_per_step']
    eval_counts = {'bn_apply': CLI_EVAL_BATCHES * n_bn,
                   'attention_pool': CLI_EVAL_BATCHES}

    # 10a: a torchreid file and an HRNet ImageNet file of a seeded model
    src = build_model('bpbreid', INF_CLASSES, config=serving_config(),
                      device='cuda', seed=SEED + 10)
    src_sd = {k: v.detach().cpu() for k, v in src.state_dict().items()}
    sd = torchreid_state_dict(torch, src_sd)
    pth = os.path.join(CLI_SAVE_DIR, 'bpbreid_market1501_hrnet32_seeded.pth')
    torch.save({'state_dict': sd, 'epoch': 120, 'rank1': 0.0,
                'config': {'model': {'bpbreid': {
                    'test_embeddings': ['bn_foreg', 'parts'],
                    'dim_reduce_output': 512}}}}, pth)
    del sd
    with Recorder(torch, cli, 'load_pretrained_weights') as loads:
        engine, (cmc, mAP, _, _), counts, rec, wall_a = drive_cli(
            torch, '10a test from a torchreid file',
            inference_argv(101, 'model.load_weights', pth))
    _add_counts(total, counts)
    matched, discarded = loads.values[0]
    got_sd = engine.model.state_dict()
    want_discarded = sorted(k for k, v in got_sd.items()
                            if v.shape != src_sd[k].shape)
    if sorted(discarded) != want_discarded or not discarded or not all(
            'identity_classifier' in k and 'classifier.' in k
            for k in discarded):
        checks.append('10a: discarded {}'.format(discarded))
    unequal = [k for k, v in got_sd.items() if k not in discarded
               and not torch.equal(v.cpu(), src_sd[k].to(v.dtype))]
    if unequal or rec.losses:
        checks.append('10a: tensors unlike the file {}'.format(unequal[:5]))
    if {k: v for k, v in counts.items() if v} != eval_counts:
        checks.append('10a: launches {} != {}'.format(counts, eval_counts))
    name, loaders = next(iter(engine.datamanager.test_loader.items()))
    ref = ImagePartBasedEngine.from_config(
        engine.config, src, datamanager=engine.datamanager, device='cuda')
    ref_cmc, ref_map, _, _ = ref._evaluate(
        0, dataset_name=name, query_loader=loaders['query'],
        gallery_loader=loaders['gallery'],
        normalize_feature=engine.config.test.normalize_feature,
        dist_metric=engine.config.test.dist_metric)
    d_cmc = float(np.abs(np.asarray(cmc) - np.asarray(ref_cmc)).max())
    d_map = abs(float(mAP) - float(ref_map))
    if not (d_cmc <= 1e-6 and d_map <= 1e-6):
        checks.append('10a: CMC / mAP off the source model by {}, {}'.format(
            d_cmc, d_map))
    out['10a'] = {'matched': len(matched), 'discarded': discarded,
                  'rank1': float(cmc[0]), 'mAP': float(mAP),
                  'cmc_max_abs_diff': d_cmc, 'mAP_abs_diff': d_map,
                  'launches': counts, 'wall_s': wall_a,
                  'file_mb': os.path.getsize(pth) / 1e6}
    del engine, ref, rec
    torch.cuda.empty_cache()

    # the HRNet ImageNet file through a training start (model.pretrained)
    imagenet = {k[len(BACKBONE):]: v for k, v in src_sd.items()
                if k.startswith(BACKBONE)}
    gen = torch.Generator().manual_seed(SEED)
    imagenet['classifier.weight'] = torch.randn(1000, 2048, generator=gen)
    imagenet['classifier.bias'] = torch.zeros(1000)
    inet_dir = os.path.join(CLI_SAVE_DIR, 'imagenet')
    torch.save(imagenet, os.path.join(inet_dir,
                                      'hrnetv2_w32_imagenet_pretrained.pth'))
    with Recorder(torch, cli, 'maybe_load_hrnet_imagenet') as inet:
        cfg_t = cli.build_config(types.SimpleNamespace(
            save_dir=CLI_SAVE_DIR, job_id=102, opts=[
                'data.sources', "['{}']".format(CLI_DATASET),
                'data.targets', "['{}']".format(CLI_DATASET),
                'test.visrank', 'False', 'model.pretrained', 'True',
                'model.bpbreid.hrnet_pretrained_path', inet_dir]),
            CLI_CONFIG)
        engine, _ = cli.build_model_engine(cfg_t)
    i_matched, _ = inet.values[0]
    got_sd = engine.model.state_dict()
    backbone_keys = sorted(k for k in got_sd if k.startswith(BACKBONE))
    if sorted(i_matched) != backbone_keys or any(
            not torch.equal(got_sd[k].cpu(), src_sd[k])
            for k in backbone_keys):
        checks.append('10a: ImageNet load matched {} of {} backbone tensors'
                      .format(len(i_matched), len(backbone_keys)))
    out['10a']['imagenet_matched'] = len(i_matched)
    out['10a']['backbone_tensors'] = len(backbone_keys)
    del engine, src, imagenet
    torch.cuda.empty_cache()

    # 10b: the FeatureExtractor, serving configuration, mixed-size arrays
    cfg = serving_config()
    fe = FeatureExtractor(cfg, model_path=pth, device='cuda',
                          num_classes=INF_CLASSES)
    fe_engine = ImagePartBasedEngine.from_config(cfg, fe.model, device='cuda')
    rng = np.random.default_rng(SEED + 10)
    calls = []
    hooks = [m.register_forward_pre_hook(lambda *_: calls.append(1))
             for m in fe.model.modules() if isinstance(m, FastBatchNorm)]
    fe(mixed_crops(rng, BATCH))            # warm-up, outside the counts
    torch.cuda.synchronize()
    per_batch, errs, batch_ms = [], [], []
    for _ in range(INF_BATCHES):
        crops = mixed_crops(rng, BATCH)
        calls.clear()
        reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outputs = fe(crops)
        end.record()
        torch.cuda.synchronize()
        batch_ms.append(start.elapsed_time(end))
        counts = {k: v for k, v in launch_counts.items() if v}
        _add_counts(total, counts)
        per_batch.append(counts)
        if counts != {'bn_apply': len(calls), 'attention_pool': 1} \
                or len(calls) != n_bn:
            checks.append('10b: launches {} for {} BN calls (phase 3: {})'
                          .format(counts, len(calls), n_bn))
        feats, vis = fe_engine.extract_test_embeddings(outputs)[:2]
        prepared = torch.as_tensor(fe._prepare(crops), device='cuda')
        want_f, want_v = fe_engine.eval_step(prepared)[:2]
        errs.append(_max_diff(feats, want_f))
        if not (errs[-1] <= 1e-6 and torch.equal(vis, want_v)
                and tuple(feats.shape) == (BATCH, 6, 512)):
            checks.append('10b: FeatureExtractor vs eval_step: {} {}'.format(
                tuple(feats.shape), errs[-1]))
    for h in hooks:
        h.remove()
    fwd_ms = time_ms(lambda: fe(prepared.cpu().numpy()), torch, warmup=1,
                     iters=3, repeats=3)
    out['10b'] = {
        'batches': INF_BATCHES, 'launches_per_batch': per_batch,
        'max_abs_err_vs_eval_step': max(errs),
        'mixed_arrays_ms_per_batch': statistics.median(batch_ms),
        'mixed_arrays_images_per_s': BATCH / statistics.median(batch_ms)
        * 1e3,
        'resized_batch_ms': fwd_ms,
        'resized_batch_images_per_s': BATCH / fwd_ms * 1e3,
        'phase3_forward_images_per_s':
            results['serving']['forward_images_per_s']}
    del fe_engine

    # 10c: --inference-enabled on a folder of PNG crops
    folder = os.path.join(CLI_SAVE_DIR, 'crops')
    os.makedirs(folder)
    paths = []
    for i, img in enumerate(mixed_crops(rng, INF_PNGS)):
        paths.append(os.path.join(folder, 'crop_{:03d}.png'.format(i)))
        write_png(paths[-1], img)
    with Recorder(torch, cli, 'extract_reid_features') as extract:
        engine, _, counts, rec, wall_c = drive_cli(
            torch, '10c --inference-enabled',
            inference_argv(103, 'model.load_weights', pth,
                           'inference.input_folder', folder,
                           flags=['--inference-enabled']))
    _add_counts(total, counts)
    n_chunks = -(-INF_PNGS // INF_CHUNK)
    want_c = {'bn_apply': (CLI_EVAL_BATCHES + n_chunks) * n_bn,
              'attention_pool': CLI_EVAL_BATCHES + n_chunks}
    if {k: v for k, v in counts.items() if v} != want_c:
        checks.append('10c: launches {} != {}'.format(counts, want_c))
    save = os.path.join(CLI_SAVE_DIR, '103')
    files = {k: np.load(os.path.join(save, '{}_crops.npy'.format(k)))
             for k in ('embeddings', 'visibility_scores', 'parts_masks')}
    with open(os.path.join(save, 'image_list_crops.txt')) as f:
        listed = f.read().split('\n')
    want_f, want_v, want_m = [], [], []
    for i in range(0, INF_PNGS, INF_CHUNK):
        o = fe(paths[i:i + INF_CHUNK])
        f_, v_ = engine.extract_test_embeddings(o)[:2]
        want_f.append(f_.float().cpu())
        want_v.append(v_.cpu())
        want_m.append(o[5]['parts'].permute(0, 2, 3, 1).float().cpu())
    want = {'embeddings': torch.cat(want_f),
            'visibility_scores': torch.cat(want_v),
            'parts_masks': torch.cat(want_m)}
    c_errs = {k: _max_diff(torch.from_numpy(files[k]), want[k])
              for k in files}
    shapes = {k: list(v.shape) for k, v in files.items()}
    if listed != paths or shapes['embeddings'] != [INF_PNGS, 6, 512] \
            or shapes['visibility_scores'] != [INF_PNGS, 6] \
            or shapes['parts_masks'][0] != INF_PNGS \
            or not all(e <= 1e-6 for e in c_errs.values()):
        checks.append('10c: files {} errors {}'.format(shapes, c_errs))
    out['10c'] = {'images': INF_PNGS, 'shapes': shapes,
                  'max_abs_err_vs_feature_extractor': c_errs,
                  'extract_s': extract.seconds[0], 'launches': counts,
                  'wall_s': wall_c}
    del engine, rec, fe
    torch.cuda.empty_cache()

    # 10d: test.rerank and test.save_features on the synthetic target
    with Recorder(torch, part_based, 're_ranking') as rr:
        engine, (cmc, mAP, _, _), counts, rec, wall_d = drive_cli(
            torch, '10d rerank + save_features',
            inference_argv(104, 'model.load_weights', pth, 'test.rerank',
                           'True', 'test.save_features', 'True'))
    _add_counts(total, counts)
    if {k: v for k, v in counts.items() if v} != eval_counts:
        checks.append('10d: launches {} != {}'.format(counts, eval_counts))
    npz = np.load(os.path.join(engine.config.data.save_dir,
                               'features_{}'.format(CLI_DATASET),
                               'features.npz'))
    loaders = engine.datamanager.test_loader[CLI_DATASET]
    feat = {}
    for side in ('q', 'g'):
        f_, v_, p_, c_, _ = engine.feature_extraction(
            loaders['query' if side == 'q' else 'gallery'])
        feat[side] = (normalize(f_), v_)
        if not (_max_diff(torch.from_numpy(npz[side + 'f']), feat[side][0]
                          .cpu()) <= 1e-6
                and np.array_equal(npz[side + '_vis'], v_.cpu().numpy())
                and np.array_equal(npz[side + '_pids'], p_)
                and np.array_equal(npz[side + '_camids'], c_)):
            checks.append('10d: features.npz differs from the engine\'s '
                          '{} features'.format(side))
    qf, gf = (torch.from_numpy(npz[k]).cuda() for k in ('qf', 'gf'))
    qv, gv = (torch.from_numpy(npz[k]).cuda() for k in ('q_vis', 'g_vis'))
    dist = {}
    for key, a, b, va, vb in (('qg', qf, gf, qv, gv), ('qq', qf, qf, qv, qv),
                              ('gg', gf, gf, gv, gv)):
        dist[key] = compute_distance_matrix_using_bp_features(
            a, b, va.bool(), vb.bool(), 'mean', 500)
    t0 = time.perf_counter()
    reranked = re_ranking(*(dist[k][0].cpu().numpy()
                            for k in ('qg', 'qq', 'gg')))
    cpu_rerank_s = time.perf_counter() - t0
    ranked = evaluate_rank(reranked, npz['q_pids'], npz['g_pids'],
                           npz['q_camids'], npz['g_camids'])
    r_cmc = float(np.abs(np.asarray(cmc)[:len(ranked['cmc'])]
                         - ranked['cmc']).max())
    r_map = abs(float(mAP) - float(ranked['mAP']))
    if not (r_cmc <= 1e-6 and r_map <= 1e-6):
        checks.append('10d: rerank CMC / mAP off the CPU re_ranking by {}, '
                      '{}'.format(r_cmc, r_map))
    want = _qg_stats_f64(dist['qg'][0], dist['qg'][1], qv, gv)
    got = engine.writer.qg_stats
    s_err = max(float(np.abs(np.asarray(got[k]) - np.asarray(v)).max())
                for k, v in want.items())
    if sorted(got) != sorted(want) or not s_err <= 1e-5:
        checks.append('10d: qg_stats off the f64 CPU reductions by {}'
                      .format(s_err))
    out['10d'] = {'rank1': float(cmc[0]), 'mAP': float(mAP),
                  'cmc_err_vs_cpu_rerank': r_cmc,
                  'mAP_err_vs_cpu_rerank': r_map,
                  'qg_stats_max_err': s_err,
                  'engine_rerank_s': rr.seconds[0],
                  'cpu_rerank_s': cpu_rerank_s,
                  'queries': len(npz['q_pids']),
                  'gallery': len(npz['g_pids']),
                  'launches': counts, 'wall_s': wall_d}
    del engine, rec, dist
    torch.cuda.empty_cache()
    shutil.rmtree(CLI_SAVE_DIR, ignore_errors=True)
    out['launches'] = total
    out['phase_s'] = time.perf_counter() - t_phase
    results['inference'] = out
    if checks:
        raise AssertionError('; '.join(checks))
    return total



# phase 12: calibrated int8 eval (ops/quant.py, conv_s8.cu) at full width:
# the serving model (HRNet-W32, 384x128, bf16, batch 64, K2) with
# cfg.test.int8 and its defaults (99.9th percentile over 4 batches, the
# float stem, shared points, per-tensor scales)
INT8_CALIB_BATCHES = 4
INT8_SOURCE = 'bpbreid_tpu_torch/ops/cuda/conv_s8.cu'
INT8_REPLACES = {
    'conv_s8': 'no TPU kernel (XLA compiled it): bpbreid_tpu/ops/quant.py:327 '
               'quant_conv',
    'quantize_s8': 'no TPU kernel (XLA compiled it): '
                   'bpbreid_tpu/ops/quant.py:288 quantize_static'}
PEAK_INT8_OPS = 1979e12            # H100 SXM dense int8 tensor cores
# the hot branch conv: [64, 32, 96, 32] 3x3 32 -> 32; the layer1 1x1
# 256 -> 64 (the torch._int_mm yardstick); the layer1 output quantize
INT8_CONV_REPORT = (BATCH, 32, 96, 32, 32, 3, 1)
INT8_MM_REPORT = (BATCH, 256, 96, 32, 64, 1, 1)
INT8_QUANT_REPORT = (BATCH, 256, 96, 32)
# ragged conv_s8 cases: (N, Cin, H, W, Co, kernel, stride)
INT8_RAGGED = [(2, 3, 17, 9, 64, 3, 2), (3, 40, 7, 5, 5, 3, 1),
               (2, 64, 13, 11, 130, 1, 2), (1, 96, 6, 4, 72, 3, 2)]
# cudnn convs an int8 eval step may run: the 2 float stem convs (the
# default int8_skip_patterns) and the pixel classifier's 1x1 conv (a flax
# nn.Conv in JAX, float there too)
INT8_FLOAT_CONVS = 3
INT8_MIN_COSINE = 0.99             # tests/test_quant.py:178-189


def _s8_conv_case(torch, gen, shape):
    from bpbreid_tpu_torch.ops.cuda.conv_s8 import (pack_weight_s8,
                                                    padded_channels)
    n, cin, h, w, co, k, _ = shape
    cp = padded_channels(cin)
    xq = torch.zeros(n, h, w, cp, dtype=torch.int8, device='cuda')
    xq[..., :cin] = torch.randint(-127, 128, (n, h, w, cin), device='cuda',
                                  generator=gen).to(torch.int8)
    wq = torch.randint(-127, 128, (co, cin, k, k), device='cuda',
                       generator=gen).to(torch.int8)
    sw = torch.rand(co, device='cuda', generator=gen) * 1e-3
    return xq, pack_weight_s8(wq, cp), sw, wq


def conv_s8_bound_ms(shape):
    n, cin, h, w, co, k, stride = shape
    ho, wo = (h + 2 * (k // 2) - k) // stride + 1, \
        (w + 2 * (k // 2) - k) // stride + 1
    cp = -(-cin // 32) * 32
    nbytes = n * h * w * cp + co * k * k * cp + 4 * co + 2 * n * co * ho * wo
    ops = 2.0 * n * ho * wo * co * k * k * cin
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT8_OPS * 1e3
    return max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


def _int8_kernel_checks(torch, conv_shapes):
    """(a): conv_s8 bit-equal to its plain version at every distinct int8
    conv shape of the serving batch and the ragged ones (bf16 output, and
    f32 with a bias at the ragged ones); quantize_s8 bit-equal, per-tensor
    and per-channel, NCHW and channels-last. Then the report rows' times."""
    from bpbreid_tpu_torch.ops.cuda.conv_s8 import (conv_s8,
                                                    conv_s8_reference,
                                                    quantize_s8,
                                                    quantize_s8_reference)
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    failures, n_cases = [], 0
    cases = [(s, torch.bfloat16, False) for s in sorted(conv_shapes)]
    cases += [(s, dt, True) for s in INT8_RAGGED
              for dt in (torch.bfloat16, torch.float32)]
    for shape, dt, with_bias in cases:
        xq, w, sw, _ = _s8_conv_case(torch, gen, shape)
        bias = torch.randn(shape[4], device='cuda', generator=gen) \
            if with_bias else None
        k, stride = shape[5], shape[6]
        got = conv_s8(xq, w, sw, bias, k, stride, k // 2, shape[1],
                      out_dtype=dt)
        torch.cuda.synchronize()
        want = conv_s8_reference(xq, w, sw, bias, k, stride, k // 2,
                                 shape[1], out_dtype=dt)
        n_cases += 1
        if not torch.equal(got, want):
            failures.append('conv_s8 at {} {}: max diff {}'.format(
                shape, dt, _max_diff(got, want)))
        del xq, w, got, want
    for shape in (INT8_QUANT_REPORT, (BATCH, 32, 96, 32), (3, 5, 7, 9),
                  (2, 70, 13, 1)):
        for dt in (torch.bfloat16, torch.float32):
            x = (3 * torch.randn(*shape, device='cuda', generator=gen)).to(dt)
            for per_channel in (False, True):
                scale = torch.rand(shape[1] if per_channel else 1,
                                   device='cuda', generator=gen) * 0.05 + 0.01
                want = quantize_s8_reference(x, scale)
                for xin in (x, x.contiguous(
                        memory_format=torch.channels_last)):
                    n_cases += 1
                    if not torch.equal(quantize_s8(xin, scale), want):
                        failures.append('quantize_s8 at {} {} {}'.format(
                            shape, dt, 'per-channel' if per_channel
                            else 'per-tensor'))
            del x
    if failures:
        raise AssertionError('12a: ' + '; '.join(failures[:10]))

    rows = {}
    xq, w, sw, wq = _s8_conv_case(torch, gen, INT8_CONV_REPORT)
    n, cin, h, wd, co, k, stride = INT8_CONV_REPORT
    xb = torch.randn(n, cin, h, wd, device='cuda', generator=gen) \
        .to(torch.bfloat16)
    wb = wq.to(torch.bfloat16)
    row = {'shape': list(INT8_CONV_REPORT), 'max_abs_err': 0.0,
           'distinct_conv_shapes': len(conv_shapes), 'cases': n_cases}
    # ms and library_ms: eager calls (CUDA events), as every kernel of the
    # kernels line; device_ms and library_device_ms beside them (CUDA
    # graphs: no host time between launches)
    def call():
        return conv_s8(xq, w, sw, None, k, stride, k // 2, cin)

    def library():
        return torch.nn.functional.conv2d(xb, wb, None, stride, k // 2)
    row['ms'] = time_ms(call, torch)
    row['device_ms'] = graph_ms(torch, call)
    row['plain_ms'] = time_ms(lambda: conv_s8_reference(
        xq, w, sw, None, k, stride, k // 2, cin), torch, warmup=1, iters=2,
        repeats=3)
    row['library_ms'] = time_ms(library, torch)
    row['library_device_ms'] = graph_ms(torch, library)
    row['bound_ms'], row['bound_by'] = conv_s8_bound_ms(INT8_CONV_REPORT)
    rows['conv_s8'] = row
    del xq, w, xb, wb
    # a 1x1 stride-1 conv against torch._int_mm on its [N*H*W, Cin] x
    # [Cin, Co] matrix, the same int32 function
    xq, w, sw, wq = _s8_conv_case(torch, gen, INT8_MM_REPORT)
    n, cin, h, wd, co, k, stride = INT8_MM_REPORT
    a = xq.view(-1, cin)
    b = wq.view(co, cin).t()
    rows['int_mm'] = {
        'shape': list(INT8_MM_REPORT),
        'conv_s8_ms': time_ms(lambda: conv_s8(xq, w, sw, None, 1, 1, 0,
                                              cin), torch),
        'int_mm_ms': time_ms(lambda: torch._int_mm(a, b), torch),
        'conv_s8_device_ms': graph_ms(torch, lambda: conv_s8(
            xq, w, sw, None, 1, 1, 0, cin)),
        'int_mm_device_ms': graph_ms(torch, lambda: torch._int_mm(a, b)),
        'bound_ms': conv_s8_bound_ms(INT8_MM_REPORT)[0]}
    del xq, w, a, b
    x = torch.randn(*INT8_QUANT_REPORT, device='cuda', generator=gen) \
        .to(torch.bfloat16)
    scale = torch.full((1,), 0.02, device='cuda')
    nbytes = x.numel() * 2 + x.numel()
    rows['quantize_s8'] = {
        'shape': list(INT8_QUANT_REPORT), 'max_abs_err': 0.0,
        'ms': time_ms(lambda: quantize_s8(x, scale), torch),
        'device_ms': graph_ms(torch, lambda: quantize_s8(x, scale)),
        'plain_ms': time_ms(lambda: quantize_s8_reference(x, scale), torch),
        'bound_ms': nbytes / HBM_BYTES_PER_S * 1e3, 'bound_by': 'bytes',
        # no one PyTorch call writes the padded NHWC s8 copy
        # (torch.quantize_per_tensor clips to -128 and keeps NCHW)
        'library_ms': None, 'library_device_ms': None}
    del x
    log('12a', json.dumps({k: v for k, v in rows.items()}))
    return rows


def _record_int8_calls(torch, step):
    """The ``conv_s8`` and ``quantize_s8`` calls of one ``step``, counted
    by key: conv (N, Cin, H, W, Co, k, stride, padding, groups, out
    dtype, bias), quantize (N, C, H, W, dtype, layout, per-channel)."""
    import bpbreid_tpu_torch.ops.quant as quant
    conv_calls, quant_calls = collections.Counter(), collections.Counter()
    conv, quantize = quant.conv_s8, quant.quantize_s8

    def rec_conv(xq, w, sw, bias=None, kernel_size=1, stride=1, padding=0,
                 channels=None, groups=1, out_dtype=torch.bfloat16):
        n, h, wd, cp = xq.shape
        conv_calls[(n, channels or cp, h, wd, w.shape[0], kernel_size,
                    stride, padding, groups, str(out_dtype)[6:],
                    bias is not None)] += 1
        return conv(xq, w, sw, bias, kernel_size, stride, padding, channels,
                    groups, out_dtype)

    def rec_quant(x, scale):
        layout = 'nhwc' if (not x.is_contiguous() and x.is_contiguous(
            memory_format=torch.channels_last)) else 'nchw'
        quant_calls[tuple(x.shape) + (str(x.dtype)[6:], layout,
                                      scale.numel() > 1)] += 1
        return quantize(x, scale)
    quant.conv_s8, quant.quantize_s8 = rec_conv, rec_quant
    try:
        step()
        torch.cuda.synchronize()
    finally:
        quant.conv_s8, quant.quantize_s8 = conv, quantize
    return conv_calls, quant_calls


def serving_step_int8_calls():
    """The int8 serving step's ``conv_s8`` and ``quantize_s8`` calls
    (``ops/cuda/conv_s8.py SERVING_STEP_CONVS`` and
    ``SERVING_STEP_QUANTS``), keyed as ``_record_int8_calls`` keys them."""
    from bpbreid_tpu_torch.ops.cuda.conv_s8 import (SERVING_STEP_CONVS,
                                                    SERVING_STEP_QUANTS)
    conv_calls = collections.Counter(
        {key + (1, 'bfloat16', False): n
         for key, n in SERVING_STEP_CONVS.items()})
    quant_calls = collections.Counter(
        {key[:4] + ('bfloat16', key[4], False): n
         for key, n in SERVING_STEP_QUANTS.items()})
    return conv_calls, quant_calls


def quantize_s8_bound_ms(shape, dtype_bytes):
    n, c, h, w = shape
    nbytes = n * c * h * w * dtype_bytes + n * h * w * (-(-c // 32) * 32)
    return nbytes / HBM_BYTES_PER_S * 1e3


def _int8_shape_table(torch, conv_calls, quant_calls, prof=None):
    """Phase 12a's per-shape table: for each ``conv_s8`` call shape of an
    int8 step, its launches a step, the kernel's ms over back-to-back
    eager calls (CUDA events, ``time_ms``: the host's launch cost shows at
    small shapes), its device ms (``graph_ms``: a CUDA graph of 20
    calls, inputs warm in L2) and its device ms with inputs out of L2 (the
    graph cycling through copies, as in a step where the input was
    written long before), its bound, cuDNN's bf16 ``F.conv2d`` device ms at the same
    shape and, for a 1x1 stride-1 conv, ``torch._int_mm``'s on the
    ``[N*H*W, Cin] x [Cin, Co]`` view; the same for each ``quantize_s8``
    call shape and layout; the sums of launches x ms, launches x device
    ms and launches x bound, beside the profiler's device time a step
    (``prof``, ``profile_steps``' result, where given)."""
    import torch.nn.functional as F
    from bpbreid_tpu_torch.ops.cuda.conv_s8 import conv_s8, quantize_s8
    gen = torch.Generator(device='cuda').manual_seed(SEED + 1)
    conv_rows, quant_rows = [], []
    for key, launches in sorted(conv_calls.items()):
        n, cin, h, wd, co, k, stride, pad, groups, dt, has_bias = key
        shape = (n, cin, h, wd, co, k, stride)
        xq, w, sw, wq = _s8_conv_case(torch, gen, shape)
        bias = torch.randn(co, device='cuda', generator=gen) \
            if has_bias else None
        out_dtype = getattr(torch, dt)
        row = {'shape': list(shape), 'padding': pad, 'out_dtype': dt,
               'bias': has_bias, 'launches': launches}
        def call(x=xq):
            return conv_s8(x, w, sw, bias, k, stride, pad, cin,
                           out_dtype=out_dtype)
        row['ms'] = time_ms(call, torch)
        row['device_ms'] = graph_ms(torch, call)
        copies = [xq.clone() for _ in range(cold_copies(xq.nbytes))]
        row['cold_ms'] = graph_ms(torch, [lambda x=x: call(x)
                                          for x in copies])
        del copies
        row['bound_ms'], row['bound_by'] = conv_s8_bound_ms(shape)
        xb = torch.randn(n, cin, h, wd, device='cuda', generator=gen) \
            .to(torch.bfloat16)
        wb = wq.to(torch.bfloat16)
        row['cudnn_bf16_ms'] = graph_ms(torch, lambda: F.conv2d(
            xb, wb, None, stride, pad))
        row['int_mm_ms'] = None
        if k == 1 and stride == 1 and cin == xq.shape[-1] and co % 8 == 0:
            a, b = xq.view(-1, cin), wq.view(co, cin).t()
            row['int_mm_ms'] = graph_ms(torch, lambda: torch._int_mm(a, b))
        conv_rows.append(row)
        log('12a conv_s8 {} x{}: {:.4f} ms device ({:.4f} inputs out of '
            'L2, {:.4f} eager), bound {:.4f} ms ({}), cuDNN bf16 {:.4f} '
            'ms{}'.format(
                shape, launches, row['device_ms'], row['cold_ms'], row['ms'],
                row['bound_ms'], row['bound_by'], row['cudnn_bf16_ms'],
                '' if row['int_mm_ms'] is None else
                ', _int_mm {:.4f} ms'.format(row['int_mm_ms'])))
        del xq, w, xb, wb
    for key, launches in sorted(quant_calls.items()):
        n, c, h, wd, dt, layout, per_channel = key
        dtype = getattr(torch, dt)
        fmt = (torch.channels_last if layout == 'nhwc'
               else torch.contiguous_format)
        # a ReLU's output (about half zeros), as most quantized
        # activations of the step
        x = torch.relu(3 * torch.randn(n, c, h, wd, device='cuda',
                                       generator=gen)).to(dtype).contiguous(
            memory_format=fmt)
        scale = torch.rand(c if per_channel else 1, device='cuda',
                           generator=gen) * 0.05 + 0.01
        # N(0, 1) values, no zeros (the kernels line's input), beside it
        xn = torch.randn(n, c, h, wd, device='cuda', generator=gen).to(
            dtype).contiguous(memory_format=fmt)
        row = {'shape': [n, c, h, wd], 'dtype': dt, 'layout': layout,
               'per_channel': per_channel, 'launches': launches,
               'ms': time_ms(lambda: quantize_s8(x, scale), torch),
               'device_ms': graph_ms(torch, lambda: quantize_s8(x, scale)),
               'normal_device_ms': graph_ms(torch,
                                            lambda: quantize_s8(xn, scale)),
               'cold_ms': graph_ms(torch, [
                   lambda xc=xc: quantize_s8(xc, scale) for xc in
                   [x.clone(memory_format=torch.preserve_format)
                    for _ in range(cold_copies(x.nbytes))]]),
               'bound_ms': quantize_s8_bound_ms((n, c, h, wd),
                                                x.element_size()),
               'bound_by': 'bytes'}
        quant_rows.append(row)
        log('12a quantize_s8 {} {} {} x{}: {:.4f} ms device ({:.4f} inputs '
            'out of L2, {:.4f} eager, {:.4f} on N(0, 1) values), bound '
            '{:.4f} ms'.format(row['shape'], dt, layout, launches,
                               row['device_ms'], row['cold_ms'], row['ms'],
                               row['normal_device_ms'], row['bound_ms']))
        del x, xn
    dev = prof['int8_device_ms'] if prof else None
    out = {'conv_s8': conv_rows, 'quantize_s8': quant_rows}
    for name, rows in list(out.items()):
        out[name + '_sums'] = {
            'launches': sum(r['launches'] for r in rows),
            'shapes': len(rows),
            'launches_x_ms': sum(r['launches'] * r['ms'] for r in rows),
            'launches_x_device_ms': sum(r['launches'] * r['device_ms']
                                        for r in rows),
            'launches_x_cold_ms': sum(r['launches'] * r['cold_ms']
                                      for r in rows),
            'launches_x_bound_ms': sum(r['launches'] * r['bound_ms']
                                       for r in rows),
            'profiler_device_ms_per_step': (
                dev[name] / prof['steps'] if isinstance(dev, dict)
                else 'not measured')}
        log('12a', name, json.dumps(out[name + '_sums']))
    return out


def _exact_bn(torch, model):
    """Every batch norm of ``model`` normalizing exactly in f32 (mean 0,
    bias 0, ``var + eps == 1``): its output is then the same on the card
    and on the CPU, so the int8 graphs see the same values."""
    from bpbreid_tpu_torch.models.common import FastBatchNorm
    var = float(np.float32(np.float32(1.0) - np.float32(1e-5)))
    gen = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FastBatchNorm):
                m.running_mean.zero_()
                m.running_var.fill_(var)
                if m.bias is not None:
                    m.bias.zero_()
                m.weight.copy_(1.0 + 0.2 * torch.randn(
                    m.weight.shape, generator=gen).to(m.weight.device))


def _int8_card_vs_cpu(torch):
    """(c): a small f32 int8 model (SMALL depth, all convs int8) on the
    card against the same model on the CPU (plain versions), on the CPU's
    calibration and exact batch norms: embeddings and the share of s8
    values that differ in the branch outputs."""
    from bpbreid_tpu_torch.config import get_default_config
    from bpbreid_tpu_torch.models import build_model
    from bpbreid_tpu_torch.ops.quant import int8_calibration, int8_inference
    cfg = get_default_config()
    cfg.model.compute_dtype = 'float32'
    cfg.model.bpbreid.backbone = 'hrnet32'
    cfg.model.bpbreid.masks.parts_num = 5
    cfg.model.bpbreid.dim_reduce_output = 64
    cfg.model.bpbreid.use_pallas_pooling = True
    cfg.model.bpbreid.multires_pooling = False
    stages = {'stage2': (1, 2, (2, 2), (32, 64)),
              'stage3': (1, 3, (2, 2, 2), (32, 64, 128)),
              'stage4': (1, 4, (2, 2, 2, 2), (32, 64, 128, 256))}
    x = torch.from_numpy(np.random.default_rng(SEED).normal(
        size=(2, 3, 64, 32)).astype(np.float32))
    outs, branch, amax = {}, {}, {}
    for device in ('cpu', 'cuda'):
        model = build_model('bpbreid', 7, config=cfg, device=device,
                            seed=SEED, backbone_stages=stages)
        _exact_bn(torch, model)
        if device == 'cpu':
            with torch.inference_mode(), int8_calibration(99.9):
                model(x)
            amax = {(n, k): b.clone() for n, m in model.named_modules()
                    for k, b in m._buffers.items() if 'amax' in k}
        else:
            for (n, k), b in amax.items():
                model.get_submodule(n).register_buffer(
                    k, b.to(device), persistent=False)
        caps = {}
        hooks = [m.register_forward_hook(
            lambda mod, _, out, name=name: caps.__setitem__(name, out))
            for name, m in model.named_modules()
            if name.rsplit('.', 2)[-2:-1] == ['branches']]
        with torch.inference_mode(), int8_inference(skip_patterns=()):
            outs[device] = model(x.to(device))[0]['bn_foreg'].float().cpu()
        for h in hooks:
            h.remove()
        branch[device] = {k: v.q.cpu() for k, v in caps.items()}
    n_diff = sum(int((branch['cuda'][k] != v).sum())
                 for k, v in branch['cpu'].items())
    n_all = sum(v.numel() for v in branch['cpu'].values())
    err = float((outs['cuda'] - outs['cpu']).norm() / outs['cpu'].norm())
    out = {'bn_foreg_rel_err': err, 's8_differ': n_diff, 's8_values': n_all,
           's8_differ_share': n_diff / max(n_all, 1)}
    log('12c', json.dumps(out))
    if not (err <= 1e-3 and n_all):
        raise AssertionError('12c: card vs CPU int8 embeddings rel. err {}'
                             .format(err))
    return out


def phase_int8(torch, results):
    """Phase 12 (see the module docstring). Returns the launch counts of
    its main-path runs (the counted int8 eval step and the CLI's int8
    test)."""
    from bpbreid_tpu_torch.data.augment import mask_chain_kwargs
    from bpbreid_tpu_torch.engine.part_based import ImagePartBasedEngine
    from bpbreid_tpu_torch.models import build_model
    from bpbreid_tpu_torch.models.common import FastBatchNorm, PConv
    from bpbreid_tpu_torch.ops.cuda.build import (launch_counts,
                                                  reset_launch_counts)
    from bpbreid_tpu_torch.tools import FeatureExtractor
    t_phase = time.perf_counter()
    out, checks, path_counts = {}, [], {}
    cfg = serving_config()
    cfg.test.int8 = True
    cfg.test.int8_calib_batches = INT8_CALIB_BATCHES
    model = build_model('bpbreid', 751, config=cfg, device='cuda', seed=SEED)
    engine = ImagePartBasedEngine.from_config(cfg, model,
                                              mask_chain_kwargs(cfg),
                                              device='cuda')
    rng = np.random.default_rng(SEED + 12)
    base = rng.integers(0, 256, size=(N_IDS, HEIGHT, WIDTH, 3))
    batches = make_batches(INT8_CALIB_BATCHES, rng, base, 0)
    skip = tuple(cfg.test.int8_skip_patterns)
    # the prediction, from the model: one conv_s8 a quantized PConv
    pconvs = [m for m in model.modules() if isinstance(m, PConv)]
    n_int8 = sum(1 for m in pconvs if m.quant
                 and not any(p in m.quant_path for p in skip))
    out['predicted_conv_s8'] = n_int8

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opts = engine.int8_quant_opts(batches)
    torch.cuda.synchronize()
    out['calibration_s'] = time.perf_counter() - t0
    out['amax_buffers'] = sum(1 for m in model.modules()
                              for k in m._buffers if 'amax' in k)
    imgs = torch.as_tensor(batches[0]['image'], device='cuda')
    masks = torch.as_tensor(batches[0]['mask'], device='cuda')
    # warm-up: fills the weight caches (one quantize of each conv's
    # weights, outside the counted run)
    engine.eval_step(imgs, masks, opts)
    bn_calls = []
    hooks = [m.register_forward_pre_hook(lambda *_: bn_calls.append(1))
             for m in model.modules() if isinstance(m, FastBatchNorm)]
    torch.cuda.synchronize()
    reset_launch_counts()
    feats8, vis8 = engine.eval_step(imgs, masks, opts)[:2]
    torch.cuda.synchronize()
    step_counts = dict(launch_counts)
    for h in hooks:
        h.remove()
    _add_counts(path_counts, step_counts)
    n_bn = out['eval_bn_calls_per_step'] = len(bn_calls)
    out['launches_per_step'] = step_counts
    log('12b launches an int8 eval step', json.dumps(step_counts),
        'predicted conv_s8', n_int8)
    if step_counts.get('conv_s8', 0) != n_int8:
        checks.append('conv_s8 launches {} != {} quantized PConvs'.format(
            step_counts.get('conv_s8', 0), n_int8))
    if step_counts.get('bn_apply', 0) != n_bn:
        checks.append('bn_apply launches {} != {} BNs'.format(
            step_counts.get('bn_apply', 0), n_bn))
    if step_counts.get('attention_pool', 0) != 1:
        checks.append('attention_pool launches {} != 1'.format(
            step_counts.get('attention_pool', 0)))
    if not step_counts.get('quantize_s8', 0):
        checks.append('no quantize_s8 launch')
    # the int8 kernels' calls of one more step, by shape (not counted)
    conv_calls, quant_calls = _record_int8_calls(
        torch, lambda: engine.eval_step(imgs, masks, opts))
    shapes = {key[:7] for key in conv_calls}
    if sum(conv_calls.values()) != n_int8:
        checks.append('{} conv_s8 calls recorded, {} launched'.format(
            sum(conv_calls.values()), n_int8))
    if (conv_calls, quant_calls) != serving_step_int8_calls():
        checks.append('the step\'s int8 calls differ from SERVING_STEP_CONVS '
                      'and SERVING_STEP_QUANTS')
    # the convs that reach cuDNN (profiler op names)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.eval_step(imgs, masks, opts)
        torch.cuda.synchronize()
    n_cudnn = sum(e.count for e in prof.key_averages()
                  if e.key == 'aten::cudnn_convolution')
    out['cudnn_convs_per_step'] = n_cudnn
    if n_cudnn != INT8_FLOAT_CONVS:
        checks.append('{} cuDNN convs in an int8 step, expected {}'.format(
            n_cudnn, INT8_FLOAT_CONVS))

    # device time by kernel, int8 and bf16 steps (torch.profiler)
    for what, o in (('int8', opts), ('bf16', None)):
        prof_out = profile_steps(torch,
                                 lambda: engine.eval_step(imgs, masks, o))
        out['profile_' + what] = prof_out
        log('12b profile', what, json.dumps(
            {k: v for k, v in prof_out.items() if not k.startswith('top_')}))
        for row in prof_out['top_kernels'][:5]:
            log('  {:9.3f} ms {:5d} calls  {}'.format(row['ms'], row['calls'],
                                                      row['name']))
    # the bf16 step on the same batch: embeddings and time
    featsf, visf = engine.eval_step(imgs, masks)[:2]
    a, b = feats8[:, 0].float(), featsf[:, 0].float()
    cos = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1)).clamp(min=1e-12)
    out['bn_foreg_cosine_min'] = cos.min().item()
    out['bn_foreg_cosine_mean'] = cos.mean().item()
    out['parts_visibility_agreement'] = \
        (vis8[:, 1:] == visf[:, 1:]).float().mean().item()
    if not out['bn_foreg_cosine_min'] >= INT8_MIN_COSINE:
        checks.append('int8 vs bf16 bn_foreg min cosine {} < {}'.format(
            out['bn_foreg_cosine_min'], INT8_MIN_COSINE))
    torch.cuda.reset_peak_memory_stats()
    ms = {}
    for what in ('bf16', 'int8', 'int8', 'bf16'):
        o = opts if what == 'int8' else None
        t = time_ms(lambda: engine.eval_step(imgs, masks, o), torch,
                    warmup=1, iters=3, repeats=3)
        ms.setdefault(what, []).append(t)
    out['eval_step_ms'] = {k: statistics.median(v) for k, v in ms.items()}
    out['images_per_s'] = {k: BATCH / v * 1e3
                           for k, v in out['eval_step_ms'].items()}
    out['peak_memory_gb'] = torch.cuda.max_memory_allocated() / 1e9
    log('12b', json.dumps({k: out[k] for k in (
        'calibration_s', 'eval_step_ms', 'images_per_s',
        'bn_foreg_cosine_min', 'bn_foreg_cosine_mean',
        'parts_visibility_agreement', 'cudnn_convs_per_step',
        'peak_memory_gb')}))

    # (d) the extractor over the calibrated engine: its batch equals the
    # engine's int8 eval_step on the same resized batch (no masks)
    extractor = FeatureExtractor(cfg, engine=engine, verbose=False)
    reset_launch_counts()
    emb = extractor(batches[1]['image'])[0]
    torch.cuda.synchronize()
    _add_counts(path_counts, dict(launch_counts))
    step = engine.eval_step(torch.as_tensor(batches[1]['image'],
                                            device='cuda'), None, opts)[0]
    out['extractor_vs_eval_step'] = max(
        _max_diff(emb['bn_foreg'], step[:, 0]),
        _max_diff(emb['parts'], step[:, 1:]))
    if out['extractor_vs_eval_step'] != 0.0:
        checks.append('extractor int8 batch differs from eval_step by {}'
                      .format(out['extractor_vs_eval_step']))
    del engine, model, extractor
    torch.cuda.empty_cache()

    # (d) the CLI: the test config with test.int8 True, and in bf16, on
    # phase 9's set, the same seeded weights
    register_cli_dataset()
    cli = {}
    for what, opts_ in (('int8', ('test.int8', 'True')), ('bf16', ())):
        eng, res, counts, _rec, wall = drive_cli(
            torch, '12d CLI test ' + what, inference_argv(
                120 + len(cli), 'model.load_weights', '',
                'model.load_config', 'False', *opts_))
        cli[what] = {'mAP': float(res[1]), 'rank1': float(res[0][0]),
                     'wall_s': wall, 'launches': counts}
        if what == 'int8':
            _add_counts(path_counts, counts)
            if not eng.int8_calibrated or not counts.get('conv_s8'):
                checks.append('the CLI int8 test launched no conv_s8')
        if not (np.isfinite(res[1]) and 0.0 <= res[1] <= 1.0):
            checks.append('CLI {} mAP {}'.format(what, res[1]))
        del eng
        torch.cuda.empty_cache()
    out['cli'] = cli
    out['card_vs_cpu'] = _int8_card_vs_cpu(torch)
    out['kernels'] = _int8_kernel_checks(torch, shapes)
    out['per_shape'] = _int8_shape_table(torch, conv_calls, quant_calls,
                                         out['profile_int8'])
    out['phase_s'] = time.perf_counter() - t_phase
    results['int8'] = out
    if checks:
        raise AssertionError('phase 12: ' + '; '.join(checks))
    return path_counts


# phase 13: Torchreid's global-embedding engines (engine/image/) at full
# width through the CLI, on a registered synthetic set of 32 identities x
# 3 cameras x 4 images of 128x64 a camera, which the loader upsamples to
# 256x128: 384 train images (an epoch of 6 steps of 64 with the random
# sampler, 5 with the identity sampler), 384 query and 768 gallery images
# (18 eval batches of 64)
GLOBAL_DATASET = 'smoke_global_crops'
GLOBAL_IDS = 32
GLOBAL_HW = (256, 128)
GLOBAL_EVAL_BATCHES = 6 + 12
# (a) torchreid's OSNet recipe (configs/im_osnet_x1_0_softmax_256x128_
# amsgrad_cosine.yaml in KaiyangZhou/deep-person-reid): random flip,
# label-smoothed CE, amsgrad at 0.0015 with a cosine schedule, only the
# classifier open in the first 10 epochs, a random sampler, unnormalized
# euclidean distances
OSNET_RECIPE = ('model.name', 'osnet_x1_0', 'loss.name', 'softmax',
                'loss.softmax.label_smooth', 'True',
                'data.transforms', "['random_flip']",
                'train.optim', 'amsgrad', 'train.lr', '0.0015',
                'train.lr_scheduler', 'cosine', 'train.fixbase_epoch', '10',
                'train.open_layers', "['classifier']",
                'sampler.train_sampler', 'RandomSampler',
                'test.normalize_feature', 'False',
                'test.dist_metric', 'euclidean')
# (b) ResNet50-IBN-a with batch-hard triplet (margin 0.3) + CE, 16 ids x 4
IBN_TRIPLET = ('model.name', 'resnet50_ibn_a', 'loss.name', 'triplet',
               'loss.triplet.margin', '0.3', 'loss.triplet.weight_t', '1.0',
               'loss.triplet.weight_x', '1.0',
               'data.transforms', "['random_flip', 'random_crop']",
               'sampler.train_sampler', 'RandomIdentitySampler',
               'sampler.num_instances', '4')
# (c) the flagship BPBReID config on the fastreid IBN + non-local trunk
FLAGSHIP_BACKBONE = 'fastreid_resnet_ibn_nl'
# kernel names of depthwise convolutions in the profiles (PyTorch's own
# depthwise kernels and cuDNN's grouped ones)
DEPTHWISE_SYMBOLS = {'depthwise': ('depthwise', 'Depthwise', 'dwconv',
                                   'grouped')}


def register_global_dataset():
    """A ``SyntheticDataset`` with the counts and crop size above, in the
    port's registry."""
    from bpbreid_tpu_torch.data.datasets import (get_image_dataset,
                                                 register_image_dataset)
    from bpbreid_tpu_torch.data.datasets.image_datasets import \
        SyntheticDataset

    class SmokeGlobalCrops(SyntheticDataset):
        dataset_dir = GLOBAL_DATASET

        def __init__(self, **kwargs):
            super().__init__(num_pids=GLOBAL_IDS, num_cams=CLI_CAMS,
                             imgs_per_pid_cam=CLI_IMGS,
                             height=CLI_SRC_HW[0], width=CLI_SRC_HW[1],
                             seed=SEED + 13, **kwargs)
    try:
        get_image_dataset(GLOBAL_DATASET)
    except ValueError:
        register_image_dataset(GLOBAL_DATASET, SmokeGlobalCrops)


def global_argv(job_id, *opts):
    """The CLI's argv for a zoo model at 256x128, bf16, batch 64, one
    epoch and the final test on the set above."""
    return (['--save_dir', CLI_SAVE_DIR, '--job-id', str(job_id),
             'data.sources', "['{}']".format(GLOBAL_DATASET),
             'data.targets', "['{}']".format(GLOBAL_DATASET),
             'data.height', str(GLOBAL_HW[0]),
             'data.width', str(GLOBAL_HW[1]),
             'model.compute_dtype', 'bfloat16', 'model.pretrained', 'False',
             'train.batch_size', str(BATCH), 'train.max_epoch', '1',
             'train.eval_freq', '-1', 'test.batch_size', str(BATCH),
             'test.visrank', 'False'] + list(opts))


def _depthwise_ms(torch, engine, batch):
    """The train step's depthwise convolutions (``groups`` = channels,
    cuDNN through ``F.conv2d``): their inputs captured on one step, then
    their forward, and forward + backward, timed alone (CUDA events)."""
    import torch.nn.functional as F
    from bpbreid_tpu_torch.models.common import PConv
    convs = [m for m in engine.model.modules() if isinstance(m, PConv)
             and m.groups > 1 and m.groups == m.weight.shape[0]]
    if not convs:
        return None
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, inp: seen.append((mod, inp[0].detach())))
        for m in convs]
    try:
        engine.forward_backward(batch)
    finally:
        for h in hooks:
            h.remove()
    cases = []
    for mod, x in seen:
        w = mod.weight.detach().to(mod.dtype).requires_grad_(True)
        xg = x.to(mod.dtype).requires_grad_(True)
        args = (mod.stride, mod.padding, 1, mod.groups)
        dy = torch.randn_like(F.conv2d(xg.detach(), w.detach(), None, *args))
        cases.append((xg, w, args, dy))

    def fwd():
        with torch.no_grad():
            for xg, w, args, _ in cases:
                F.conv2d(xg, w, None, *args)

    def fwd_bwd():
        for xg, w, args, dy in cases:
            torch.autograd.grad(F.conv2d(xg, w, None, *args), (xg, w), dy)
    out = {'calls_per_step': len(cases),
           'shapes': sorted({tuple(c[0].shape) for c in cases}),
           'fwd_ms_per_step': time_ms(fwd, torch, warmup=1, iters=3,
                                      repeats=3),
           'fwd_bwd_ms_per_step': time_ms(fwd_bwd, torch, warmup=1, iters=3,
                                          repeats=3)}
    del cases, seen
    return out


def _global_card_vs_cpu(torch, name, loss, hw=GLOBAL_HW, varied=False,
                        prepare=None, zero_in_exact=()):
    """One f32 train step of ``name`` at ``hw`` on 4 identities x 4 on the
    card and on the CPU (TF32 off), the same seeded weights and batch
    (``make_train_batch``, ``varied`` as there), no augmentation, Adam:
    ``compare_train_steps``. ``prepare(model)`` runs on each side's model
    after it is built."""
    from bpbreid_tpu_torch.data.augment import IMAGENET_MEAN, IMAGENET_STD
    from bpbreid_tpu_torch.engine.image import (ImageSoftmaxEngine,
                                               ImageTripletEngine)
    from bpbreid_tpu_torch.models import build_model
    from bpbreid_tpu_torch.optim import build_optimizer
    cls = ImageTripletEngine if loss == 'triplet' else ImageSoftmaxEngine
    dm = types.SimpleNamespace(transforms=(), norm_mean=IMAGENET_MEAN,
                               norm_std=IMAGENET_STD)
    cpu_batch = make_train_batch(np.random.default_rng(SEED + 13), 4, 4,
                                 *hw, 'cpu', varied=varied)
    out = {}
    for device in ('cuda', 'cpu'):
        model = build_model(name, 10, loss=loss, device=device, seed=SEED,
                            dtype=torch.float32)
        if prepare:
            prepare(model)
        engine = cls(dm, model, build_optimizer(
            model, optim='adam', lr=LR, weight_decay=WEIGHT_DECAY),
            device=device)
        before = {k: v.detach().cpu().clone()
                  for k, v in model.named_parameters()}
        loss_t, _ = engine.forward_backward(
            {k: cpu_batch[k].to(device) for k in ('image', 'pid')})
        out[device] = {
            'loss': loss_t.item(), 'before': before,
            'grads': {k: v.grad.detach().cpu().clone()
                      for k, v in model.named_parameters()},
            'state': {k: v.detach().cpu().clone()
                      for k, v in model.state_dict().items()}}
        del model, engine
    return compare_train_steps(out['cuda'], out['cpu'], zero_in_exact)


def _global_run(torch, what, job_id, opts, cls, name, loss):
    """One CLI run of a global-embedding engine (see the module
    docstring, phase 13a-b): its numbers, its launch counts, its first
    step's BN inputs and the failed checks."""
    from bpbreid_tpu_torch.data.augment import sample_train_draws
    from bpbreid_tpu_torch.models.common import FastBatchNorm
    engine, (cmc, mAP, _, _), counts, rec, wall = drive_cli(
        torch, what, global_argv(job_id, *opts), cls=cls)
    checks = []
    n_bn = sum(isinstance(m, FastBatchNorm) for m in engine.model.modules())
    want = {k: n_bn for k in BN_KERNELS}
    checks += ['{}: BN launches a step {} != {} FastBatchNorms'.format(
        what, c, n_bn) for c in rec.launches if c != want][:1]
    checks += ['{}: {} train-mode BN calls a step by hooks, {} '
               'FastBatchNorms'.format(what, n, n_bn)
               for n in set(rec.train_bn_calls) if n != n_bn]
    losses = [float(v) for v in rec.losses]
    steps = len(losses)
    # the identity sampler's length is an upper bound (torchreid's): an
    # epoch ends when fewer identities than a batch holds are left
    if not 3 <= steps <= len(engine.datamanager.train_loader) \
            or not all(np.isfinite(losses)):
        checks.append('{}: {} steps, losses {}'.format(what, steps, losses))
    eval_apply = counts.get('bn_apply', 0) - steps * n_bn
    if not (eval_apply == rec.bn_calls['eval']
            == GLOBAL_EVAL_BATCHES * n_bn):
        checks.append('{}: eval bn_apply {} for {} eval-mode BN calls, {} '
                      'x {} FastBatchNorms'.format(
                          what, eval_apply, rec.bn_calls['eval'],
                          GLOBAL_EVAL_BATCHES, n_bn))
    if counts.get('attention_pool', 0) or not 0.0 <= float(mAP) <= 1.0:
        checks.append('{}: K2 launches {}, mAP {}'.format(
            what, counts.get('attention_pool', 0), mAP))
    intervals = rec.step_intervals_ms()
    step_ms = statistics.median(intervals)
    # learning: 20 steps on one batch with one set of draws, every layer
    # open (the recipe's run had only the classifier open)
    engine.set_freeze_base(False)
    batch = make_train_batch(np.random.default_rng(SEED + 14), TRAIN_IDS,
                             TRAIN_INSTANCES, *GLOBAL_HW, 'cuda')
    batch = {k: batch[k] for k in ('image', 'pid')}
    draws = sample_train_draws(engine.generator, BATCH, *GLOBAL_HW,
                               engine.transforms, **engine.cj)
    learn = [float(engine.forward_backward(batch, draws)[0])
             for _ in range(TRAIN_LEARN)]
    if not (all(np.isfinite(learn))
            and np.mean(learn[-3:]) < np.mean(learn[:3])):
        checks.append('{}: loss did not fall over {} steps: {}'.format(
            what, TRAIN_LEARN, learn))
    profile = profile_steps(torch, lambda: engine.forward_backward(batch),
                            symbols=DEPTHWISE_SYMBOLS)
    depthwise = _depthwise_ms(torch, engine, batch)
    del engine, batch
    torch.cuda.empty_cache()
    small, bad = _global_card_vs_cpu(torch, name, loss)
    checks += ['{} card vs CPU: {}'.format(what, b) for b in bad]
    out = {'model': name, 'loss': loss, 'steps': steps, 'losses': losses,
           'step_ms_median': step_ms, 'step_ms': intervals,
           'images_per_s': BATCH / step_ms * 1e3,
           'fastbatchnorm_modules': n_bn,
           'bn_launches_per_step': rec.launches[0] if rec.launches else {},
           'eval_bn_apply_per_batch': eval_apply / GLOBAL_EVAL_BATCHES,
           'rank1': float(cmc[0]), 'mAP': float(mAP),
           'learning_losses': learn, 'card_vs_cpu': small,
           'profile': {k: v for k, v in profile.items()
                       if k != 'top_host_ops'},
           'depthwise': depthwise, 'launches': counts, 'wall_s': wall}
    log('13 {}'.format(what), json.dumps({
        k: v for k, v in out.items()
        if k not in ('losses', 'step_ms', 'learning_losses', 'profile')}))
    for row in profile['top_kernels'][:8]:
        log('  {:9.3f} ms {:5d} calls  {}'.format(row['ms'], row['calls'],
                                                  row['name']))
    shapes = {key: [n, n] for key, n in rec.bn_inputs.items()}
    return out, counts, shapes, checks


def _flagship_on_fastreid(torch, checks, backbone=FLAGSHIP_BACKBONE,
                          tag='13c'):
    """Phase 13c: the flagship BPBReID config on the fastreid IBN +
    non-local trunk at 384x128, batch 64, bf16: one eval batch through K2
    (fused pooling, multires off) with K2 held against its plain version
    on the 2048-channel map it was given, then one train step (the
    materialized pooling). Counts set to 0 before each and read after.
    Phase 15c runs it on another ``backbone`` (``tag`` names it in the
    checks): the map is then the backbone's ``feature_dim`` wide, at its
    own stride, and no IBN layer is counted."""
    import bpbreid_tpu_torch.models.bpbreid as bpbreid_module
    from bpbreid_tpu_torch.data.augment import mask_chain_kwargs
    from bpbreid_tpu_torch.engine.part_based import ImagePartBasedEngine
    from bpbreid_tpu_torch.models import build_model
    from bpbreid_tpu_torch.models.common import FastBatchNorm
    from bpbreid_tpu_torch.models.resnet_fastreid import IBNLayer
    from bpbreid_tpu_torch.ops.cuda.build import (launch_counts,
                                                  reset_launch_counts)
    from bpbreid_tpu_torch.optim import build_optimizer
    cfg = serving_config()
    cfg.model.bpbreid.backbone = backbone
    model = build_model('bpbreid', 751, config=cfg, device='cuda', seed=SEED)
    trunk = model.backbone_appearance_feature_extractor
    engine = ImagePartBasedEngine.from_config(
        cfg, model, mask_chain_kwargs(cfg), device='cuda',
        optimizer=build_optimizer(model, optim='adam', lr=LR,
                                  weight_decay=WEIGHT_DECAY))
    batch = make_train_batch(np.random.default_rng(SEED + 15), TRAIN_IDS,
                             TRAIN_INSTANCES, HEIGHT, WIDTH, 'cuda')
    calls = {'train': 0, 'eval': 0}

    def hook(mod, inp):
        calls['train' if mod.training else 'eval'] += 1
    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, FastBatchNorm)]
    ibn = [m for m in model.modules() if isinstance(m, IBNLayer)]
    k2, seen = bpbreid_module.fused_attention_pool, []

    def capture(feats, logits, *args, **kwargs):
        seen.append((feats.clone(), logits.clone()))
        return k2(feats, logits, *args, **kwargs)
    bpbreid_module.fused_attention_pool = capture
    try:
        torch.cuda.synchronize()
        copies = sum(m.copies for m in ibn)
        reset_launch_counts()
        feats = engine.eval_step(batch['image'], batch['mask'])[0]
        torch.cuda.synchronize()
        eval_counts = dict(launch_counts)
        eval_copies = sum(m.copies for m in ibn) - copies
    finally:
        bpbreid_module.fused_attention_pool = k2
    want = {'attention_pool': 1, 'bn_apply': calls['eval']}
    if {k: v for k, v in eval_counts.items() if v} != want \
            or not torch.isfinite(feats.float()).all():
        checks.append('{} eval: launches {} != {}'.format(tag, eval_counts,
                                                          want))
    stride = 16 if backbone == FLAGSHIP_BACKBONE else 32
    if len(seen) != 1 or tuple(seen[0][0].shape) != (
            BATCH, trunk.feature_dim, HEIGHT // stride, WIDTH // stride):
        checks.append('{}: K2 inputs {}'.format(
            tag, [tuple(f.shape) for f, _ in seen]))
        if not seen:
            return {}, dict(eval_counts)
    k2_out, failed = k2_row(torch, *seen[0])
    checks += ['{}: {}'.format(tag, f) for f in failed]
    log('{} K2'.format(tag), json.dumps(k2_out))
    del seen
    # one train step: K2 has no backward, the materialized map trains
    model.use_pallas_pooling = False
    bn, no_grad = _bn_split(model, engine.losses_weights)
    calls['train'] = 0
    torch.cuda.synchronize()
    copies = sum(m.copies for m in ibn)
    reset_launch_counts()
    loss, _ = engine.forward_backward(batch)
    loss = loss.item()
    train_counts = dict(launch_counts)
    train_copies = sum(m.copies for m in ibn) - copies
    for h in hooks:
        h.remove()
    want = {'bn_stats': len(bn), 'bn_apply': len(bn),
            'bn_grad_stats': len(bn) - len(no_grad),
            'bn_dx': len(bn) - len(no_grad)}
    got = {k: train_counts.get(k, 0) for k in BN_KERNELS}
    if got != want or calls['train'] != len(bn) or not np.isfinite(loss) \
            or train_counts.get('attention_pool', 0):
        checks.append('{} train: launches {} != {} ({} BN calls by hooks, '
                      'loss {})'.format(tag, train_counts, want,
                                        calls['train'], loss))
    if not eval_copies == train_copies == len(ibn):
        checks.append('{}: IBN copies {} (eval), {} (train) for {} '
                      'IBNLayers'.format(tag, eval_copies, train_copies,
                                         len(ibn)))
    out = {'backbone': backbone, 'k2': k2_out,
           'eval_launches': eval_counts, 'train_launches': train_counts,
           'train_bn_want': want, 'train_loss': loss,
           'ibn_layers': len(ibn), 'ibn_copies_eval': eval_copies,
           'ibn_copies_train': train_copies}
    log(tag, json.dumps({k: v for k, v in out.items() if k != 'k2'}))
    del model, engine, batch, feats
    torch.cuda.empty_cache()
    counts = dict(eval_counts)
    for k, v in train_counts.items():
        counts[k] = counts.get(k, 0) + v
    return out, counts


def phase_global(torch, results):
    """Phase 13 (see the module docstring). Returns the launch counts of
    its runs, each counted from 0."""
    import shutil
    from bpbreid_tpu_torch.engine.image import (ImageSoftmaxEngine,
                                               ImageTripletEngine)
    t_phase = time.perf_counter()
    register_global_dataset()
    shutil.rmtree(CLI_SAVE_DIR, ignore_errors=True)
    out, checks, launches = {}, [], {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    out['13a'], counts, shapes_a, bad = _global_run(
        torch, 'osnet softmax', 131, OSNET_RECIPE, ImageSoftmaxEngine,
        'osnet_x1_0', 'softmax')
    add(counts)
    checks += bad
    out['13b'], counts, shapes_b, bad = _global_run(
        torch, 'resnet50_ibn_a triplet', 132, IBN_TRIPLET,
        ImageTripletEngine, 'resnet50_ibn_a', 'triplet')
    add(counts)
    checks += bad
    shutil.rmtree(CLI_SAVE_DIR, ignore_errors=True)
    out['13c'], counts = _flagship_on_fastreid(torch, checks)
    add(counts)
    for what, shapes in (('osnet', shapes_a), ('ibn', shapes_b)):
        try:
            phase_k3_step_shapes(
                torch, sorted(shapes.items(),
                              key=lambda kv: -np.prod(kv[0][0])),
                out, result_key='13d_' + what, check=True)
        except AssertionError as e:
            checks.append('13d {}: {}'.format(what, e))
    out['phase_s'] = time.perf_counter() - t_phase
    results['global'] = out
    if checks:
        raise AssertionError('phase 13: ' + '; '.join(checks))
    return launches


# phase 14: the video path (data/video.py, engine/video/) through the CLI
# on a registered synthetic tracklet set of 16 identities x 2 cameras, one
# tracklet of 24 frames at 256x128 a camera in each split: 32 train
# tracklets (10 steps of 3 with the random sampler), 32 query and 32
# gallery tracklets (11 padded eval batches of 3 each)
VIDEO_DATASET = 'smoke_video_tracklets'
VIDEO_IDS, VIDEO_CAMS, VIDEO_FRAMES = 16, 2, 24
VIDEO_HW = (256, 128)
VIDEO_SEQ, VIDEO_BATCH = 15, 3
VIDEO_EVAL_BATCHES = 2 * 11
# torchreid's documented video recipe (its user guide's VideoDataManager
# example, KaiyangZhou/deep-person-reid docs/user_guide.rst): resnet50,
# softmax, 15 frames sampled evenly a tracklet, 3 tracklets a batch (45
# frames a step), the random sampler, random flip, adam at 0.0003, the
# frame embeddings averaged
VIDEO_RECIPE = ('data.type', 'video', 'model.name', 'resnet50',
                'loss.name', 'softmax', 'video.seq_len', str(VIDEO_SEQ),
                'video.sample_method', 'evenly',
                'video.pooling_method', 'avg',
                'train.batch_size', str(VIDEO_BATCH),
                'test.batch_size', str(VIDEO_BATCH),
                'train.optim', 'adam', 'train.lr', '0.0003',
                'sampler.train_sampler', 'RandomSampler',
                'data.transforms', "['random_flip']")
VIDEO_TRIPLET_STEPS = 3
# (b) the shipped Occluded-Duke train config with ISP masks (their own
# background channel) and the random occlusion, HRNet-W32 at 384x128 on
# a fabricated tree: 32 identities x 4 train images (2 steps of 16 x 4),
# 32 query and 64 gallery images (one eval batch of 64 each), PNG bytes
# under the dataset's .jpg names (the card's machine has no JPEG
# decoder), fields of 6 channels at 48x16
OCC_CONFIG = 'configs/bpbreid/bpbreid_occ_duke_train.yaml'
OCC_IDS, OCC_IMGS = 32, 4
OCC_SRC_HW = (128, 64)
OCC_PARTS = 5
OCC_EVAL_BATCHES = 2
# (d) an extracted CUHK03 tree (labeled images, the new protocol): 16
# train identities x 4 images, 20 test identities with one query (view 1)
# and two gallery images (view 2) each
CUHK03_TRAIN_IDS, CUHK03_TEST_IDS = 16, 20
CUHK03_EVAL_BATCHES = 2
DATA_DIR = os.path.join('_scratch', 'chip_smoke_data')


def register_video_dataset():
    """A ``SyntheticVideoDataset`` with the counts and frame size above,
    in the port's video registry."""
    from bpbreid_tpu_torch.data.video import (SyntheticVideoDataset,
                                              register_video_dataset as reg)

    class SmokeVideoTracklets(SyntheticVideoDataset):
        def __init__(self, seed=0, **kwargs):
            super().__init__(num_pids=VIDEO_IDS, num_cams=VIDEO_CAMS,
                             tracklet_len=VIDEO_FRAMES, height=VIDEO_HW[0],
                             width=VIDEO_HW[1], seed=SEED + 20, **kwargs)
    reg(VIDEO_DATASET, SmokeVideoTracklets)


def video_argv(job_id, *opts):
    return (['--save_dir', CLI_SAVE_DIR, '--job-id', str(job_id),
             'data.sources', "['{}']".format(VIDEO_DATASET),
             'data.targets', "['{}']".format(VIDEO_DATASET),
             'data.height', str(VIDEO_HW[0]), 'data.width', str(VIDEO_HW[1]),
             'model.compute_dtype', 'bfloat16', 'model.pretrained', 'False',
             'train.max_epoch', '1', 'train.eval_freq', '-1',
             'test.visrank', 'False'] + list(opts))


def _fastbatchnorms(model):
    from bpbreid_tpu_torch.models.common import FastBatchNorm
    return sum(isinstance(m, FastBatchNorm) for m in model.modules())


def _video_card_vs_cpu(torch):
    """One f32 ``VideoSoftmaxEngine`` step of resnet50 on 4 tracklets of 4
    frames at 256x128 (2 identities), card and CPU (TF32 off), the same
    seeded weights and batch, no augmentation: ``compare_train_steps``."""
    from bpbreid_tpu_torch.data.augment import IMAGENET_MEAN, IMAGENET_STD
    from bpbreid_tpu_torch.engine.video import VideoSoftmaxEngine
    from bpbreid_tpu_torch.models import build_model
    from bpbreid_tpu_torch.optim import build_optimizer
    dm = types.SimpleNamespace(transforms=(), norm_mean=IMAGENET_MEAN,
                               norm_std=IMAGENET_STD)
    rng = np.random.default_rng(SEED + 21)
    batch = {'image': torch.as_tensor(rng.integers(
                 0, 256, (4, 4) + VIDEO_HW + (3,), dtype=np.uint8)),
             'pid': torch.as_tensor(np.repeat(np.arange(2), 2))}
    out = {}
    for device in ('cuda', 'cpu'):
        model = build_model('resnet50', 10, loss='softmax', device=device,
                            seed=SEED, dtype=torch.float32)
        engine = VideoSoftmaxEngine(dm, model, build_optimizer(
            model, optim='adam', lr=LR, weight_decay=WEIGHT_DECAY),
            device=device)
        before = {k: v.detach().cpu().clone()
                  for k, v in model.named_parameters()}
        loss, _ = engine.forward_backward(
            {k: v.to(device) for k, v in batch.items()})
        out[device] = {
            'loss': loss.item(), 'before': before,
            'grads': {k: v.grad.detach().cpu().clone()
                      for k, v in model.named_parameters()},
            'state': {k: v.detach().cpu().clone()
                      for k, v in model.state_dict().items()}}
        del model, engine
    return compare_train_steps(out['cuda'], out['cpu'])


def _video_triplet_steps(torch, checks):
    """``VideoTripletEngine`` steps (resnet50, bf16, batch-hard triplet +
    CE) on batches of 4 tracklets (2 identities x 2, 60 frames), each
    counted from 0: the BN kernels once per FastBatchNorm a step."""
    from bpbreid_tpu_torch.data.video import VideoDataManager
    from bpbreid_tpu_torch.engine.engine import device_prefetch
    from bpbreid_tpu_torch.engine.video import VideoTripletEngine
    from bpbreid_tpu_torch.models import build_model
    from bpbreid_tpu_torch.ops.cuda.build import (launch_counts,
                                                  reset_launch_counts)
    from bpbreid_tpu_torch.optim import build_optimizer
    dm = VideoDataManager(sources=[VIDEO_DATASET], height=VIDEO_HW[0],
                          width=VIDEO_HW[1], transforms=['random_flip'],
                          batch_size_train=4, batch_size_test=4, workers=4,
                          num_instances=2,
                          train_sampler='RandomIdentitySampler',
                          seq_len=VIDEO_SEQ)
    model = build_model('resnet50', dm.num_train_pids, loss='triplet',
                        device='cuda', seed=SEED, dtype=torch.bfloat16)
    engine = VideoTripletEngine(dm, model, build_optimizer(
        model, optim='adam', lr=3e-4), device='cuda')
    n_bn = _fastbatchnorms(model)
    losses, per_step, total, shapes = [], [], {}, {}
    for i, batch in enumerate(device_prefetch(dm.train_loader, 'cuda')):
        if i == VIDEO_TRIPLET_STEPS:
            break
        torch.cuda.synchronize()
        reset_launch_counts()
        with bn_inputs(model) as inputs:
            loss, summary = engine.forward_backward(batch)
        if i == 0:
            shapes = {key: [n, n] for key, n in inputs.items()}
        losses.append(loss.item())
        per_step.append({k: launch_counts[k] for k in BN_KERNELS})
        for k, v in launch_counts.items():
            total[k] = total.get(k, 0) + v
    if any(c != {k: n_bn for k in BN_KERNELS} for c in per_step) \
            or not np.isfinite(losses).all() or len(losses) < 3:
        checks.append('14a triplet: launches {} for {} FastBatchNorms, '
                      'losses {}'.format(per_step, n_bn, losses))
    del model, engine
    return {'steps': len(losses), 'losses': losses,
            'frames_per_step': 4 * VIDEO_SEQ,
            'bn_launches_per_step': per_step[0] if per_step else {},
            'fastbatchnorm_modules': n_bn}, total, shapes


def bn_inputs(model, with_eps=False):
    """A context that counts the inputs of ``model``'s FastBatchNorms
    (shape, dtype, channel_dim -> calls; ``with_eps``: and the BN's eps)
    while it is open: forward hooks, removed when it closes."""
    import contextlib
    from bpbreid_tpu_torch.models.common import FastBatchNorm

    @contextlib.contextmanager
    def hooked():
        inputs = collections.Counter()

        def hook(mod, inp):
            key = (tuple(inp[0].shape), inp[0].dtype, mod.channel_dim)
            inputs[key + ((mod.eps,) if with_eps else ())] += 1
        hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
                 if isinstance(m, FastBatchNorm)]
        try:
            yield inputs
        finally:
            for h in hooks:
                h.remove()
    return hooked()


def check_k3_at(torch, what, shapes, results, result_key, checks):
    """``phase_k3_step_shapes`` with ``check`` on ``shapes`` (``(shape,
    dtype, channel_dim) -> [forward, backward calls]``), largest first:
    each BN kernel held against its plain version at a path's own BN
    inputs, and timed. A failure goes to ``checks``."""
    try:
        phase_k3_step_shapes(
            torch, sorted(shapes.items(), key=lambda kv: -np.prod(kv[0][0])),
            results, result_key=result_key, check=True)
    except AssertionError as e:
        checks.append('{}: {}'.format(what, e))


def _phase_video(torch, checks):
    """Phase 14a (see the module docstring)."""
    from bpbreid_tpu_torch.data.augment import sample_train_draws
    from bpbreid_tpu_torch.engine.video import VideoSoftmaxEngine
    register_video_dataset()
    engine, (cmc, mAP, _, _), counts, rec, wall = drive_cli(
        torch, '14a video softmax', video_argv(141, *VIDEO_RECIPE),
        cls=VideoSoftmaxEngine)
    n_bn = _fastbatchnorms(engine.model)
    steps = len(rec.losses)
    losses = [float(v) for v in rec.losses]
    if steps != VIDEO_IDS * VIDEO_CAMS // VIDEO_BATCH \
            or not all(np.isfinite(losses)):
        checks.append('14a: {} steps, losses {}'.format(steps, losses))
    checks += ['14a: BN launches a step {} != {} FastBatchNorms'.format(
        c, n_bn) for c in rec.launches
        if c != {k: n_bn for k in BN_KERNELS}][:1]
    eval_apply = counts.get('bn_apply', 0) - steps * n_bn
    if not (eval_apply == rec.bn_calls['eval']
            == VIDEO_EVAL_BATCHES * n_bn):
        checks.append('14a: eval bn_apply {} for {} eval-mode BN calls, {} '
                      'x {}'.format(eval_apply, rec.bn_calls['eval'],
                                    VIDEO_EVAL_BATCHES, n_bn))
    if counts.get('attention_pool', 0) or not (
            np.isfinite(float(mAP)) and np.isfinite(float(cmc[0]))):
        checks.append('14a: K2 {}, mAP {}, rank-1 {}'.format(
            counts.get('attention_pool', 0), mAP, cmc[0]))
    intervals = rec.step_intervals_ms()
    step_ms = statistics.median(intervals)
    frames = VIDEO_BATCH * VIDEO_SEQ
    batch = {k: rec.first_batch[k].to('cuda') for k in ('image', 'pid')}
    draws = sample_train_draws(engine.generator, frames, *VIDEO_HW,
                               engine.transforms, **engine.cj)
    learn = [float(engine.forward_backward(batch, draws)[0])
             for _ in range(TRAIN_LEARN)]
    if not (all(np.isfinite(learn))
            and np.mean(learn[-3:]) < np.mean(learn[:3])):
        checks.append('14a: loss did not fall over {} steps: {}'.format(
            TRAIN_LEARN, learn))
    profile = profile_steps(torch, lambda: engine.forward_backward(batch))
    del engine, batch
    torch.cuda.empty_cache()
    small, bad = _video_card_vs_cpu(torch)
    checks += ['14a card vs CPU: ' + b for b in bad]
    triplet, triplet_counts, triplet_shapes = _video_triplet_steps(
        torch, checks)
    k3 = {}
    check_k3_at(torch, '14a softmax K3', {
        key: [n, n] for key, n in rec.bn_inputs.items()}, k3, 'softmax',
        checks)
    check_k3_at(torch, '14a triplet K3', triplet_shapes, k3, 'triplet',
                checks)
    out = {'model': 'resnet50', 'steps': steps, 'losses': losses,
           'frames_per_step': frames, 'step_ms_median': step_ms,
           'step_ms': intervals, 'frames_per_s': frames / step_ms * 1e3,
           'fastbatchnorm_modules': n_bn,
           'bn_launches_per_step': rec.launches[0] if rec.launches else {},
           'eval_bn_apply_per_batch': eval_apply / VIDEO_EVAL_BATCHES,
           'rank1': float(cmc[0]), 'mAP': float(mAP),
           'learning_losses': learn, 'card_vs_cpu': small,
           'busy_share': profile['busy_share'],
           'device_busy_ms': profile['device_busy_ms'],
           'profile': {k: v for k, v in profile.items()
                       if k != 'top_host_ops'},
           'triplet': triplet, 'k3': k3, 'launches': counts,
           'wall_s': wall}
    log('14a', json.dumps({k: v for k, v in out.items()
                           if k not in ('losses', 'step_ms', 'profile',
                                        'learning_losses', 'k3')}))
    for row in profile['top_kernels'][:6]:
        log('  {:9.3f} ms {:5d} calls  {}'.format(row['ms'], row['calls'],
                                                  row['name']))
    totals = dict(counts)
    for k, v in triplet_counts.items():
        totals[k] = totals.get(k, 0) + v
    return out, totals


def make_occluded_duke_tree(root):
    """The fabricated Occluded-Duke tree of (b): seeded RGB crops and
    6-channel ISP fields (background first, the channels summing to 1) at
    each image's ``isp_6_parts`` path."""
    rng = np.random.default_rng(SEED + 22)
    base = os.path.join(root, 'Occluded_Duke')
    layout = {'bounding_box_train': [(pid, i % 8 + 1) for pid in
                                     range(1, OCC_IDS + 1)
                                     for i in range(OCC_IMGS)],
              'query': [(1000 + pid, 1) for pid in range(OCC_IDS)],
              'bounding_box_test': [(1000 + pid, cam) for pid in
                                    range(OCC_IDS) for cam in (2, 3)]}
    for sub, items in layout.items():
        os.makedirs(os.path.join(base, sub))
        os.makedirs(os.path.join(base, 'masks', 'isp_6_parts', sub))
        for j, (pid, cam) in enumerate(items):
            name = '{:04d}_c{}_f{:07d}'.format(pid, cam, j)
            write_png(os.path.join(base, sub, name + '.jpg'),
                      rng.integers(0, 256, OCC_SRC_HW + (3,),
                                   dtype=np.uint8))
            fields = rng.gamma(0.3, size=(OCC_PARTS + 1, HEIGHT // 8,
                                          WIDTH // 8)).astype(np.float32)
            np.save(os.path.join(base, 'masks', 'isp_6_parts', sub,
                                 name + '.jpg.confidence_fields.npy'),
                    fields / fields.sum(axis=0, keepdims=True))


def _ro_batch_ms(transform):
    """The random occlusion's host ms on a batch of 64 crops at 384x128
    (median of 5 batches; the loader runs it on one thread)."""
    rng = np.random.default_rng(SEED + 23)
    imgs = rng.integers(0, 256, (BATCH, HEIGHT, WIDTH, 3), dtype=np.uint8)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        for img in imgs:
            transform(img)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _phase_occluded(torch, checks):
    """Phase 14b (see the module docstring)."""
    import shutil
    from bpbreid_tpu_torch.data.augment import train_augment
    from bpbreid_tpu_torch.data.datasets import clear_dataset_cache
    root = os.path.join(DATA_DIR, 'occluded')
    shutil.rmtree(root, ignore_errors=True)
    make_occluded_duke_tree(root)
    opts = ['--config-file', OCC_CONFIG, '--root', root,
            '--save_dir', CLI_SAVE_DIR, 'model.bpbreid.masks.dir',
            'isp_6_parts', 'data.transforms', "['rc', 're', 'ro']",
            'model.pretrained', 'False', 'train.max_epoch', '1',
            'train.eval_freq', '-1']
    engine, (cmc, mAP, _, _), counts, rec, wall = drive_cli(
        torch, '14b occluded train', ['--job-id', '142'] + opts)
    model = engine.model
    bn, no_grad = _bn_split(model, engine.losses_weights)
    want, bad = _step_launch_checks(rec, bn, no_grad, '14b')
    checks += bad
    losses = [float(v) for v in rec.losses]
    first_mask = rec.first_batch.get('mask')
    mask_channels = None if first_mask is None else first_mask.shape[-1]
    if len(losses) != OCC_IDS * OCC_IMGS // BATCH \
            or not all(np.isfinite(losses)) \
            or model.parts_num != OCC_PARTS or mask_channels != OCC_PARTS + 1:
        checks.append('14b: losses {}, parts {}, mask channels {}'.format(
            losses, model.parts_num, mask_channels))
    if counts.get('attention_pool', 0) or not np.isfinite(float(mAP)):
        checks.append('14b: K2 in training {}, mAP {}'.format(
            counts.get('attention_pool', 0), mAP))
    chain_channels = None
    if first_mask is not None:
        chain_channels = train_augment(
            rec.first_batch['image'].to('cuda'), first_mask.to('cuda'), {},
            mask_kwargs=engine.mask_kwargs)[1].shape[1]
    # JAX's chain adds a second background ahead of the file's own
    # (ROADMAP, "The JAX package at fault"), and the port's does the same
    if chain_channels != OCC_PARTS + 2:
        checks.append('14b: {} mask channels after the chain'.format(
            chain_channels))
    ro = engine.datamanager.train_loader.host_transform
    ro_ms = _ro_batch_ms(ro)
    del engine, model
    torch.cuda.empty_cache()
    clear_dataset_cache()
    k2_engine, (k2_cmc, k2_mAP, _, _), k2_counts, k2_rec, k2_wall = \
        drive_cli(torch, '14b occluded test through K2',
                  ['--job-id', '143'] + opts + [
                      'test.evaluate', 'True',
                      'model.bpbreid.use_pallas_pooling', 'True',
                      'model.bpbreid.multires_pooling', 'False'])
    # a test-only run calls no forward_backward, so no hooks count its
    # BN calls: one bn_apply for each kernel-backed BN of (b)'s model
    want_k2 = {'attention_pool': OCC_EVAL_BATCHES,
               'bn_apply': OCC_EVAL_BATCHES * len(bn)}
    if {k: v for k, v in k2_counts.items() if v} != want_k2 \
            or not np.isfinite(float(k2_mAP)):
        checks.append('14b K2 test: launches {} != {}, mAP {}'.format(
            k2_counts, want_k2, k2_mAP))
    del k2_engine
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    out = {'config': OCC_CONFIG, 'steps': len(losses), 'losses': losses,
           'step_ms_median': statistics.median(
               rec.step_intervals_ms()) if len(losses) > 1
           else None,
           'mask_channels_on_disk': mask_channels,
           'mask_channels_after_chain': chain_channels,
           'bn_launches_per_step': rec.launches[0] if rec.launches else {},
           'bn_want_per_step': want, 'ro_host_ms_per_batch': ro_ms,
           'rank1': float(cmc[0]), 'mAP': float(mAP),
           'k2_per_test_batch': k2_counts.get('attention_pool', 0)
           / OCC_EVAL_BATCHES,
           'k2_test_bn_apply_per_batch': k2_counts.get('bn_apply', 0)
           / OCC_EVAL_BATCHES,
           'k2_test_rank1': float(k2_cmc[0]), 'k2_test_mAP': float(k2_mAP),
           'launches': counts, 'k2_launches': k2_counts,
           'wall_s': wall, 'k2_wall_s': k2_wall}
    log('14b', json.dumps({k: v for k, v in out.items() if k != 'losses'}))
    totals = dict(counts)
    for k, v in k2_counts.items():
        totals[k] = totals.get(k, 0) + v
    return out, totals


def _phase_before_and_after(torch, checks):
    """Phase 14c: BPBReID on resnet50 with ``dim_reduce
    before_and_after_pooling`` (2048 -> 1024 channels before pooling, 512
    after), f32 at 256x128: one eval batch (embeddings 1e-3, phase 5) and
    one train step (phase 7's tolerances, ``compare_train_steps``; the
    biases of the reductions' conv and Dense, ahead of train-mode BNs,
    have a zero gradient in exact arithmetic, which both sides must hold
    to float noise) of 2 identities x 4 on the card and on the CPU, TF32
    off. Returns its launches on the card, counted from 0."""
    from bpbreid_tpu_torch.data.augment import sample_train_draws
    from bpbreid_tpu_torch.ops.cuda.build import (launch_counts,
                                                  reset_launch_counts)
    h, w = VIDEO_HW
    cfg = train_config(h, w, 'float32')
    cfg.model.bpbreid.backbone = 'resnet50'
    cfg.model.bpbreid.dim_reduce = 'before_and_after_pooling'
    cpu_batch = make_train_batch(np.random.default_rng(SEED + 24), 2, 4, h,
                                 w, 'cpu')
    draws = sample_train_draws(torch.Generator().manual_seed(SEED), 8, h, w,
                               cfg.data.transforms)
    out, feats, counts = {}, {}, {}
    for device in ('cuda', 'cpu'):
        model, engine = train_engine(torch, cfg, 7, device)
        batch = {k: v.to(device) for k, v in cpu_batch.items()}
        if device == 'cuda':
            torch.cuda.synchronize()
            reset_launch_counts()
        feats[device] = engine.eval_step(batch['image'],
                                         batch['mask'])[0].float().cpu()
        before = {k: v.detach().cpu().clone()
                  for k, v in model.named_parameters()}
        dev_draws = {k: (None if v is None else
                         tuple(t.to(device) for t in v)
                         if isinstance(v, tuple) else v.to(device))
                     for k, v in draws.items()}
        loss, _ = engine.forward_backward(batch, draws=dev_draws)
        out[device] = {
            'loss': loss.item(), 'before': before,
            'grads': {k: v.grad.detach().cpu().clone()
                      for k, v in model.named_parameters()},
            'state': {k: v.detach().cpu().clone()
                      for k, v in model.state_dict().items()}}
        if device == 'cuda':
            torch.cuda.synchronize()
            counts = dict(launch_counts)
            reduce_shape = tuple(
                model.before_pooling_dim_reduce.layers[0].weight.shape)
        del model, engine
    torch.cuda.empty_cache()
    small, bad = compare_train_steps(
        out['cuda'], out['cpu'], zero_in_exact=('_dim_reduce.layers.0.bias',))
    checks += ['14c train card vs CPU: ' + b for b in bad]
    emb_err = (feats['cuda'] - feats['cpu']).abs().max().item() \
        / feats['cpu'].abs().max().item()
    if not emb_err <= 1e-3 or reduce_shape[:2] != (1024, 2048) \
            or feats['cpu'].shape[-1] != 512:
        checks.append('14c: embeddings {} apart, before-pooling conv {}, '
                      'width {}'.format(emb_err, reduce_shape,
                                        feats['cpu'].shape[-1]))
    result = {'backbone': 'resnet50', 'before_pooling_conv': reduce_shape,
              'embedding_rel_err': emb_err, 'train_card_vs_cpu': small,
              'launches': counts}
    log('14c', json.dumps(result))
    return result, counts


def make_cuhk03_tree(root):
    """An extracted CUHK03 tree (``splits_new_labeled.json`` and the
    labeled PNGs, named as the extraction names them)."""
    rng = np.random.default_rng(SEED + 25)
    base = os.path.join(root, 'cuhk03')
    img_dir = os.path.join(base, 'images_labeled')
    os.makedirs(img_dir)
    split = {'train': [], 'query': [], 'gallery': []}
    for pid in range(1, CUHK03_TRAIN_IDS + CUHK03_TEST_IDS + 1):
        test = pid > CUHK03_TRAIN_IDS
        for view, img in ((1, 1), (1, 2), (2, 6), (2, 7)):
            if test and (view, img) == (1, 2):
                continue
            name = '1_{:03d}_{}_{:02d}.png'.format(pid, view, img)
            path = os.path.abspath(os.path.join(img_dir, name))
            write_png(path, rng.integers(0, 256, CLI_SRC_HW + (3,),
                                         dtype=np.uint8))
            if not test:
                split['train'].append([path, pid - 1, view - 1])
            else:
                split['query' if view == 1 else 'gallery'].append(
                    [path, pid, view - 1])
    with open(os.path.join(base, 'splits_new_labeled.json'), 'w') as f:
        json.dump([split], f)


def _phase_cuhk03(torch, checks):
    """Phase 14d: a test-only CLI run (resnet50, softmax engine, bf16,
    256x128) on the extracted CUHK03 tree, labeled, new protocol."""
    import shutil
    from bpbreid_tpu_torch.engine.image import ImageSoftmaxEngine
    root = os.path.join(DATA_DIR, 'cuhk03')
    shutil.rmtree(root, ignore_errors=True)
    make_cuhk03_tree(root)
    step, seen = ImageSoftmaxEngine.eval_step, []

    def eval_step(engine, *args, **kwargs):
        # the first eval batch's BN inputs, the CLI's model hooked
        if seen:
            return step(engine, *args, **kwargs)
        with bn_inputs(engine.model) as inputs:
            feats = step(engine, *args, **kwargs)
        seen.append(dict(inputs))
        return feats
    ImageSoftmaxEngine.eval_step = eval_step
    try:
        engine, (cmc, mAP, _, _), counts, rec, wall = drive_cli(
            torch, '14d cuhk03 test', [
                '--root', root, '--save_dir', CLI_SAVE_DIR, '--job-id', '144',
                'data.sources', "['cuhk03']", 'data.targets', "['cuhk03']",
                'cuhk03.labeled_images', 'True',
                'cuhk03.classic_split', 'False',
                'data.height', str(VIDEO_HW[0]),
                'data.width', str(VIDEO_HW[1]),
                'model.name', 'resnet50', 'loss.name', 'softmax',
                'model.compute_dtype', 'bfloat16', 'model.pretrained', 'False',
                'test.evaluate', 'True', 'test.batch_size', str(BATCH),
                'test.visrank', 'False'], cls=ImageSoftmaxEngine)
    finally:
        ImageSoftmaxEngine.eval_step = step
    n_bn = _fastbatchnorms(engine.model)
    ds = engine.datamanager.test_dataset['cuhk03']
    sizes = (len(ds['query'].query), len(ds['gallery'].gallery))
    want = {'bn_apply': CUHK03_EVAL_BATCHES * n_bn}
    if {k: v for k, v in counts.items() if v} != want \
            or sizes != (CUHK03_TEST_IDS, 2 * CUHK03_TEST_IDS) \
            or not (np.isfinite(float(mAP)) and np.isfinite(float(cmc[0]))):
        checks.append('14d: launches {} != {}, query/gallery {}, mAP {}, '
                      'rank-1 {}'.format(counts, want, sizes, mAP, cmc[0]))
    del engine
    shutil.rmtree(root, ignore_errors=True)
    inputs = seen[0] if seen else {}
    out = {'query_gallery': sizes, 'rank1': float(cmc[0]),
           'mAP': float(mAP), 'launches': counts, 'wall_s': wall,
           'eval_bn_inputs': [[list(shape), str(dt), n] for (shape, dt, _), n
                              in inputs.items()]}
    log('14d', json.dumps(out))
    if sum(inputs.values()) != n_bn:
        checks.append('14d: first eval batch BN inputs {} for {} '
                      'FastBatchNorms'.format(out['eval_bn_inputs'], n_bn))
    # an eval batch launches bn_apply alone: the rows' per-step counts
    # (bn_stats and bn_apply forward, the two others backward) stay 0
    check_k3_at(torch, '14d K3', {key: [0, 0] for key in inputs}, out, 'k3',
                checks)
    return out, counts


def phase_video_and_options(torch, results):
    """Phase 14 (see the module docstring). Returns the launch counts of
    its runs, each counted from 0."""
    import shutil
    t_phase = time.perf_counter()
    shutil.rmtree(CLI_SAVE_DIR, ignore_errors=True)
    out, checks, launches = {}, [], {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    for key, run in (('14a', _phase_video), ('14b', _phase_occluded),
                     ('14c', _phase_before_and_after),
                     ('14d', _phase_cuhk03)):
        out[key], counts = run(torch, checks)
        add(counts)
        shutil.rmtree(CLI_SAVE_DIR, ignore_errors=True)
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    out['phase_s'] = time.perf_counter() - t_phase
    results['video'] = out
    if checks:
        raise AssertionError('phase 14: ' + '; '.join(checks))
    return launches


# phase 15: the rest of the model zoo (models/pcb.py, pvpm.py and the
# legacy Torchreid zoo) on the card. (a) every new registry name, bf16,
# seeded weights, one eval batch at its input size; (b) the CLI's image
# engines on the global set with PCB (softmax, deep supervision over its
# six strips) and HACNN (triplet, both heads); (c) one train step of the
# first constructor of each other module, and BPBReID on NASNet's
# 1056-channel map through K2; (d) the BN kernels at every distinct BN
# input of (b)'s and (c)'s steps
ZOO_MODULES = (
    ('pcb', ('pcb_p4', 'pcb_p6')),
    ('pvpm', ('pose_p4', 'pose_p6', 'pose_p4s', 'pose_p6s')),
    ('senet', ('se_resnet50', 'se_resnet50_fc512', 'se_resnet101',
               'se_resnet152', 'se_resnext50_32x4d', 'se_resnext101_32x4d',
               'senet154')),
    ('densenet', ('densenet121', 'densenet169', 'densenet201', 'densenet161',
                  'densenet121_fc512')),
    ('mobilenetv2', ('mobilenetv2_x1_0', 'mobilenetv2_x1_4')),
    ('shufflenet', ('shufflenet',)),
    ('shufflenetv2', ('shufflenet_v2_x0_5', 'shufflenet_v2_x1_0',
                      'shufflenet_v2_x1_5', 'shufflenet_v2_x2_0')),
    ('squeezenet', ('squeezenet1_0', 'squeezenet1_1',
                    'squeezenet1_0_fc512')),
    ('mlfn', ('mlfn',)), ('xception', ('xception',)),
    ('inceptionv4', ('inceptionv4',)),
    ('inceptionresnetv2', ('inceptionresnetv2',)),
    ('nasnet', ('nasnetamobile',)), ('mudeep', ('mudeep',)),
    ('hacnn', ('hacnn',)))
# (a)'s input: 256x128 (MuDeep's fixed size), HACNN's fixed 160x64
ZOO_HW = (256, 128)
HACNN_HW = (160, 64)
POSE_CHANNELS = 56
# (b): PCB with torchreid's PCB recipe at 384x128 (softmax over the six
# strips, 16 ids x 4), HACNN with triplet + CE at its 160x64
PCB_RUN = ('model.name', 'pcb_p6', 'loss.name', 'softmax',
           'data.height', str(HEIGHT), 'data.width', str(WIDTH),
           'sampler.train_sampler', 'RandomIdentitySampler',
           'sampler.num_instances', '4',
           'data.transforms', "['random_flip']")
HACNN_RUN = ('model.name', 'hacnn', 'loss.name', 'triplet',
             'loss.triplet.margin', '0.3', 'loss.triplet.weight_t', '1.0',
             'loss.triplet.weight_x', '1.0',
             'data.height', str(HACNN_HW[0]), 'data.width', str(HACNN_HW[1]),
             'sampler.train_sampler', 'RandomIdentitySampler',
             'sampler.num_instances', '4',
             'data.transforms', "['random_flip']")
# (c): the first constructor of every module (b) does not train; PVPM's
# with the part-score regression at 384x128 with pose maps at 96x32
ZOO_STEP_MODELS = ('pose_p4s', 'se_resnet50', 'densenet121',
                   'mobilenetv2_x1_0', 'shufflenet', 'shufflenet_v2_x0_5',
                   'squeezenet1_0', 'mlfn', 'xception', 'inceptionv4',
                   'inceptionresnetv2', 'nasnetamobile', 'mudeep')
ZOO_BPBREID_BACKBONE = 'nasnetamobile'
# (d): the BN inputs timed (the largest ones); every one is checked
ZOO_K3_TIMED = 4


def _expected_bn_calls(model, train):
    """FastBatchNorm calls in one forward of ``model``: one a module, but
    HACNN runs each ``local_conv<b>`` once for each of its four regions,
    and PCB's ``conv5`` and PVPM's ``em`` heads run in train mode only."""
    from bpbreid_tpu_torch.models.common import FastBatchNorm
    kind = type(model).__name__
    n = 0
    for name, mod in model.named_modules():
        if not isinstance(mod, FastBatchNorm):
            continue
        if not train and ((kind == 'PCBModel' and name.startswith('conv5'))
                          or (kind == 'PoseGuidedAttResnet'
                              and name.startswith('em.'))):
            continue
        n += 4 if kind == 'HACNN' and name.startswith('local_conv') else 1
    return n


def _zoo_inputs(torch, name, n, gen, hw=None):
    """``n`` seeded images at the model's input size (and PVPM's pose
    maps at 4x its trunk's map), on the card."""
    h, w = hw or (HACNN_HW if name == 'hacnn' else ZOO_HW)
    x = torch.randn(n, 3, h, w, device='cuda', generator=gen)
    if not name.startswith('pose_'):
        return (x,)
    return x, torch.rand(n, POSE_CHANNELS, h // 4, w // 4, device='cuda',
                         generator=gen)


def _leaves(out):
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _leaves(o)]
    return [out]


def _zoo_eval(torch, checks):
    """15a: each new registry name built on the card (``build_model``,
    bf16, seeded weights), one eval batch (counts set to 0 just before
    and read just after): one ``bn_apply`` for each FastBatchNorm call
    and no other kernel, finite outputs; then the batch's ms (CUDA
    events) and the build seconds."""
    from bpbreid_tpu_torch.models import build_model
    from bpbreid_tpu_torch.ops.cuda.build import (launch_counts,
                                                  reset_launch_counts)
    gen = torch.Generator(device='cuda').manual_seed(SEED + 15)
    rows, launches = [], {}
    for module, names in ZOO_MODULES:
        for name in names:
            t0 = time.perf_counter()
            model = build_model(name, 751, loss='softmax', device='cuda',
                                seed=SEED, dtype=torch.bfloat16)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            inputs = _zoo_inputs(torch, name, BATCH, gen)
            with bn_inputs(model) as calls, torch.inference_mode():
                torch.cuda.synchronize()
                reset_launch_counts()
                out = model(*inputs)
                torch.cuda.synchronize()
                counts = {k: v for k, v in launch_counts.items() if v}
            n_calls = sum(calls.values())
            want = _expected_bn_calls(model, train=False)
            finite = all(torch.isfinite(t.float()).all().item()
                         for t in _leaves(out))
            if counts != ({'bn_apply': want} if want else {}) \
                    or n_calls != want or not finite:
                checks.append('15a {}: launches {} for {} FastBatchNorm '
                              'calls ({} expected), finite {}'.format(
                                  name, counts, n_calls, want, finite))
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
            with torch.inference_mode():
                ms = time_ms(lambda: model(*inputs), torch, warmup=1,
                             iters=3, repeats=1)
            rows.append({'module': module, 'name': name, 'batch': BATCH,
                         'input': list(inputs[0].shape[2:]),
                         'output': [list(t.shape) for t in _leaves(out)],
                         'fastbatchnorm_modules': _fastbatchnorms(model),
                         'bn_calls': n_calls, 'launches': counts,
                         'ms': ms, 'images_per_s': BATCH / ms * 1e3,
                         'build_s': build_s,
                         'parameters': sum(p.numel()
                                           for p in model.parameters())})
            log('15a', json.dumps(rows[-1]))
            del model, inputs, out
            torch.cuda.empty_cache()
    return rows, launches


def _fixed_dropout(torch, model):
    """Make ``model``'s dropouts keep the entries of a mask drawn on the
    CPU from the seed, on any device (the card's and the CPU's generators
    draw other bits)."""
    from bpbreid_tpu_torch.models.common import GeneratorDropout
    for mod in model.modules():
        if isinstance(mod, GeneratorDropout):
            def forward(x, rate=mod.rate):
                keep = torch.rand(x.shape, generator=torch.Generator()
                                  .manual_seed(SEED)) < 1.0 - rate
                return torch.where(keep.to(x.device), x / (1.0 - rate),
                                   torch.zeros_like(x))
            mod.forward = forward


def _zoo_card_vs_cpu_prep(torch, model):
    """15b's card-vs-CPU model: the dropout masks fixed
    (``_fixed_dropout``); HACNN's hard attention moved off the pixel
    centres. torchreid's hard attention starts at x-translations of 0
    exactly, which put every grid point on a pixel centre, where the
    bilinear sample's derivative in x jumps: the card and the CPU then take
    other one-sided derivatives. Seeded offsets of 0.01 move the grid off
    them."""
    _fixed_dropout(torch, model)
    if type(model).__name__ != 'HACNN':
        return
    with torch.no_grad():
        for b in range(1, 4):
            bias = getattr(model, 'ha{}'.format(b)).hard_attn.fc.bias
            bias.add_(0.01 * torch.randn(
                8, generator=torch.Generator().manual_seed(b)).to(
                bias.device))


def _zoo_cli(torch, what, job_id, opts, cls, name, loss, hw, small_hw,
             checks):
    """15b: one CLI run of an image engine on a model with several heads
    (phase 13's set and measures): the step ms (host clock between step
    entries) and images/s; each step launches the four BN kernels once
    per FastBatchNorm call (hooks, and the model's count), the eval
    batches one ``bn_apply`` a call; the test's mAP and rank-1 finite;
    20 steps on one batch whose loss falls; a profile of three steps; one
    f32 step at 4 ids x 4 of ``small_hw`` on the card against the CPU
    (TF32 off, ``_zoo_card_vs_cpu_prep``, images of varied contrast and
    brightness; phase 7's tolerances)."""
    from bpbreid_tpu_torch.data.augment import sample_train_draws
    engine, (cmc, mAP, _, _), counts, rec, wall = drive_cli(
        torch, what, global_argv(job_id, *opts), cls=cls)
    model = engine.model
    n_train = _expected_bn_calls(model, train=True)
    n_eval = _expected_bn_calls(model, train=False)
    want = {k: n_train for k in BN_KERNELS}
    checks += ['15b {}: BN launches a step {} != {}'.format(what, c, want)
               for c in rec.launches if c != want][:1]
    checks += ['15b {}: {} train-mode BN calls a step by hooks, {} '
               'expected'.format(what, n, n_train)
               for n in set(rec.train_bn_calls) if n != n_train]
    losses = [float(v) for v in rec.losses]
    steps = len(losses)
    if not 3 <= steps <= len(engine.datamanager.train_loader) \
            or not all(np.isfinite(losses)):
        checks.append('15b {}: {} steps, losses {}'.format(what, steps,
                                                           losses))
    eval_apply = counts.get('bn_apply', 0) - steps * n_train
    if not eval_apply == rec.bn_calls['eval'] == GLOBAL_EVAL_BATCHES * n_eval:
        checks.append('15b {}: eval bn_apply {} for {} eval-mode BN calls, '
                      '{} x {}'.format(what, eval_apply,
                                       rec.bn_calls['eval'],
                                       GLOBAL_EVAL_BATCHES, n_eval))
    if counts.get('attention_pool', 0) or not 0.0 <= float(mAP) <= 1.0 \
            or not np.isfinite(float(cmc[0])):
        checks.append('15b {}: K2 launches {}, mAP {}, rank-1 {}'.format(
            what, counts.get('attention_pool', 0), mAP, cmc[0]))
    intervals = rec.step_intervals_ms()
    step_ms = statistics.median(intervals)
    batch = make_train_batch(np.random.default_rng(SEED + 16), TRAIN_IDS,
                             TRAIN_INSTANCES, *hw, 'cuda')
    batch = {k: batch[k] for k in ('image', 'pid')}
    draws = sample_train_draws(engine.generator, BATCH, *hw,
                               engine.transforms, **engine.cj)
    learn = [float(engine.forward_backward(batch, draws)[0])
             for _ in range(TRAIN_LEARN)]
    if not (all(np.isfinite(learn))
            and np.mean(learn[-3:]) < np.mean(learn[:3])):
        checks.append('15b {}: loss did not fall over {} steps: {}'.format(
            what, TRAIN_LEARN, learn))
    profile = profile_steps(torch, lambda: engine.forward_backward(batch))
    shapes = {key: [n, n] for key, n in rec.bn_inputs.items()}
    n_modules = _fastbatchnorms(model)
    del engine, batch, model
    torch.cuda.empty_cache()
    # on images of varied contrast and brightness: HACNN's channel
    # attention batch-normalizes 16 pooled vectors, near-degenerate on
    # near-alike images; the biases of convs and Denses ahead of
    # train-mode BNs (HACNN's conv blocks and embedding heads) are zero
    # in exact arithmetic
    small, bad = _global_card_vs_cpu(
        torch, name, loss, small_hw, varied=True,
        prepare=lambda m: _zoo_card_vs_cpu_prep(torch, m),
        zero_in_exact=('conv.bias', 'fc_global.0.bias', 'fc_local.0.bias'))
    checks += ['15b {} card vs CPU: {}'.format(what, b) for b in bad]
    row = {'model': name, 'loss': loss, 'steps': steps, 'losses': losses,
           'step_ms_median': step_ms, 'step_ms': intervals,
           'images_per_s': BATCH / step_ms * 1e3,
           'fastbatchnorm_modules': n_modules,
           'bn_calls_per_step': n_train, 'eval_bn_calls_per_batch': n_eval,
           'bn_launches_per_step': rec.launches[0] if rec.launches else {},
           'eval_bn_apply_per_batch': eval_apply / GLOBAL_EVAL_BATCHES,
           'rank1': float(cmc[0]), 'mAP': float(mAP),
           'learning_losses': learn, 'card_vs_cpu': small,
           'profile': {k: v for k, v in profile.items()
                       if k != 'top_host_ops'},
           'launches': counts, 'wall_s': wall}
    log('15b {}'.format(what), json.dumps({
        k: v for k, v in row.items()
        if k not in ('losses', 'step_ms', 'learning_losses', 'profile')}))
    return row, counts, shapes


def _zoo_steps(torch, checks):
    """15c: one bf16 train step of each ``ZOO_STEP_MODELS`` model on 16
    ids x 4 (counts set to 0 just before and read just after): through
    the softmax engine (augmentation, label-smoothed CE, Adam), PVPM at
    the module level (its part scores' CE, averaged; pose maps given),
    each launching the four BN kernels once per FastBatchNorm call whose
    output reaches the loss (PVPM's part-score BN does not: no
    backward); the BN inputs of each step."""
    import torch.nn.functional as F
    from bpbreid_tpu_torch.data.augment import IMAGENET_MEAN, IMAGENET_STD
    from bpbreid_tpu_torch.engine.image import ImageSoftmaxEngine
    from bpbreid_tpu_torch.models import build_model
    from bpbreid_tpu_torch.ops.cuda.build import (launch_counts,
                                                  reset_launch_counts)
    from bpbreid_tpu_torch.optim import build_optimizer
    dm = types.SimpleNamespace(transforms=('random_flip',),
                               norm_mean=IMAGENET_MEAN, norm_std=IMAGENET_STD)
    gen = torch.Generator(device='cuda').manual_seed(SEED + 18)
    rows, launches, shapes = [], {}, collections.Counter()
    for name in ZOO_STEP_MODELS:
        hw = (HEIGHT, WIDTH) if name.startswith('pose_') else ZOO_HW
        model = build_model(name, 751, loss='softmax', device='cuda',
                            seed=SEED, dtype=torch.bfloat16)
        n_train = _expected_bn_calls(model, train=True)
        no_grad = 1 if name == 'pose_p4s' else 0
        if name.startswith('pose_'):
            x, pose = _zoo_inputs(torch, name, BATCH, gen, hw)
            pids = torch.arange(BATCH, device='cuda') // TRAIN_INSTANCES
            opt = build_optimizer(model, optim='adam', lr=LR,
                                  weight_decay=WEIGHT_DECAY)

            def step():
                model.train()
                ys = model(x, pose)[0]
                loss = sum(F.cross_entropy(y.float(), pids)
                           for y in ys) / len(ys)
                opt.zero_grad()
                loss.backward()
                opt.step()
                return loss.detach()
        else:
            engine = ImageSoftmaxEngine(dm, model, build_optimizer(
                model, optim='adam', lr=LR, weight_decay=WEIGHT_DECAY),
                device='cuda')
            batch = make_train_batch(np.random.default_rng(SEED + 19),
                                     TRAIN_IDS, TRAIN_INSTANCES, *hw, 'cuda')
            batch = {k: batch[k] for k in ('image', 'pid')}

            def step():
                return engine.forward_backward(batch)[0]
        with bn_inputs(model, with_eps=True) as calls:
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            loss = float(step())
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            counts = {k: v for k, v in launch_counts.items() if v}
        n_calls = sum(calls.values())
        want = {k: n_train - (no_grad if k in ('bn_grad_stats', 'bn_dx')
                              else 0) for k in BN_KERNELS} if n_train else {}
        got = {k: counts.get(k, 0) for k in want}
        if got != want or n_calls != n_train or not np.isfinite(loss) \
                or set(counts) - set(BN_KERNELS):
            checks.append('15c {}: launches {} != {} ({} BN calls by '
                          'hooks), loss {}'.format(name, counts, want,
                                                   n_calls, loss))
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        for key, v in calls.items():
            shapes[key] += v
        rows.append({'name': name, 'input': list(hw), 'batch': BATCH,
                     'fastbatchnorm_modules': _fastbatchnorms(model),
                     'bn_calls': n_calls, 'launches': counts, 'loss': loss,
                     'first_step_ms': wall_ms})
        log('15c', json.dumps(rows[-1]))
        del model, step
        torch.cuda.empty_cache()
    return rows, launches, shapes


def _zoo_k3(torch, shapes, results, checks):
    """15d: the four BN kernels against their plain versions (as phase 2
    holds them, at the BN's own eps) at every distinct BN input of 15b's
    and 15c's steps; the ``ZOO_K3_TIMED`` largest timed as phase 6b.
    Returns the worst error of each kernel."""
    gen = torch.Generator(device='cuda').manual_seed(SEED + 20)
    worst, failures = {}, []
    for (shape, dt, cd, eps) in sorted(shapes, key=lambda k: -np.prod(k[0])):
        x = (0.5 + torch.randn(shape, device='cuda', generator=gen)).to(dt)
        dy = torch.randn(shape, device='cuda', generator=gen).to(dt)
        errs, failed = _check_bn_kernels(
            torch, x, dy, cd, _bn_operands(torch, x, dy, cd, gen, eps))
        failures += ['{} at {} {} eps {}'.format(f, shape, dt, eps)
                     for f in failed]
        for k, v in errs.items():
            if k.endswith('err'):
                worst[k] = max(worst.get(k, 0.0), v)
        del x, dy
    timed = sorted(((k[:3], [v, v]) for k, v in shapes.items()),
                   key=lambda kv: -np.prod(kv[0][0]))[:ZOO_K3_TIMED]
    phase_k3_step_shapes(torch, timed, results, result_key='15d_timed')
    if failures:
        checks.append('15d: ' + '; '.join(failures[:10]))
    return {'shapes': len(shapes), 'worst': worst,
            'failures': len(failures)}


def phase_zoo(torch, results):
    """Phase 15 (see the module docstring). Returns the launch counts of
    its runs, each counted from 0."""
    import shutil
    from bpbreid_tpu_torch.engine.image import (ImageSoftmaxEngine,
                                               ImageTripletEngine)
    t_phase = time.perf_counter()
    out, checks, launches = {}, [], {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    out['15a'], counts = _zoo_eval(torch, checks)
    add(counts)
    out['15a_s'] = time.perf_counter() - t_phase
    register_global_dataset()
    shutil.rmtree(CLI_SAVE_DIR, ignore_errors=True)
    k3_shapes = collections.Counter()
    for key, job_id, opts, cls, name, loss, hw, small_hw in (
            ('pcb', 151, PCB_RUN, ImageSoftmaxEngine, 'pcb_p6', 'softmax',
             (HEIGHT, WIDTH), (128, 64)),
            ('hacnn', 152, HACNN_RUN, ImageTripletEngine, 'hacnn', 'triplet',
             HACNN_HW, HACNN_HW)):
        out['15b_' + key], counts, shapes = _zoo_cli(
            torch, '{} {}'.format(name, loss), job_id, opts, cls, name,
            loss, hw, small_hw, checks)
        add(counts)
        for (shape, dt, cd), n in shapes.items():
            k3_shapes[(shape, dt, cd, 1e-5)] += n[0]
    shutil.rmtree(CLI_SAVE_DIR, ignore_errors=True)
    out['15b_s'] = time.perf_counter() - t_phase - out['15a_s']
    out['15c'], counts, shapes = _zoo_steps(torch, checks)
    add(counts)
    for key, n in shapes.items():
        k3_shapes[key] += n
    out['15c_bpbreid'], counts = _flagship_on_fastreid(
        torch, checks, backbone=ZOO_BPBREID_BACKBONE, tag='15c')
    add(counts)
    t_d = time.perf_counter()
    out['15c_s'] = t_d - t_phase - out['15a_s'] - out['15b_s']
    out['15d'] = _zoo_k3(torch, k3_shapes, out, checks)
    out['15d_s'] = time.perf_counter() - t_d
    out['phase_s'] = time.perf_counter() - t_phase
    results['zoo'] = out
    if checks:
        raise AssertionError('phase 15: ' + '; '.join(checks))
    return launches


# phase 16: the debug and test figures, the native ranker and the tools.
# (a) the flagship train config through the CLI on phase 9's crops with a
# fourth camera (16 ids x 4 cameras x 4 images: one epoch of 4 steps of
# 64, then 256 query and 512 gallery images, 12 eval batches), with
# train.batch_debug_freq 2 (the debug figures at global steps 0 and 2) and
# test.vis_embedding_projection; then a test-only run from its checkpoint
# through K2 (fused pooling, multires off) and the debug forward of one
# train batch on that engine
DEBUG_DATASET = 'smoke_market_crops_4cams'
DEBUG_CAMS = 4
DEBUG_STEPS = CLI_IDS * DEBUG_CAMS * CLI_IMGS // BATCH
DEBUG_EVAL_BATCHES = 4 + 8
DEBUG_FREQ = 2
PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
# (d) the HPO search's base: the resnet18 smoke config, one epoch, two
# learning rates
HPO_CONFIG = 'configs/bpbreid/bpbreid_synthetic_smoke.yaml'
HPO_SPACE = {'train.lr': [0.00035, 0.0007]}


class DebugRecorder:
    """Wraps the part-based engine's ``_debug_visualize_batch`` for a run:
    each call's global step, milliseconds (host clock between two
    synchronizes), kernel launches and figure paths."""

    def __init__(self, torch):
        from bpbreid_tpu_torch.engine.part_based import ImagePartBasedEngine
        self.torch, self.cls = torch, ImagePartBasedEngine
        self.fn, self.calls = self.cls._debug_visualize_batch, []

    def __enter__(self):
        from bpbreid_tpu_torch.ops.cuda.build import launch_counts
        rec = self

        def wrapped(engine, batch, max_samples=4):
            rec.torch.cuda.synchronize()
            before, t0 = dict(launch_counts), time.perf_counter()
            paths = rec.fn(engine, batch, max_samples)
            rec.torch.cuda.synchronize()
            rec.calls.append({
                'step': engine.engine_state.global_step,
                'ms': (time.perf_counter() - t0) * 1e3, 'paths': paths,
                'launches': {k: v - before.get(k, 0)
                             for k, v in launch_counts.items()
                             if v - before.get(k, 0)}})
            return paths
        self.cls._debug_visualize_batch = wrapped
        return self

    def __exit__(self, *exc):
        self.cls._debug_visualize_batch = self.fn
        return False


def _png_text(path, keys, what, checks):
    """The ``tEXt`` chunks of a figure, checked: the file is a PNG that
    ``read_image`` decodes and holds the ``keys``."""
    from bpbreid_tpu_torch.data.datasets.dataset import (read_image,
                                                         read_png_text)
    if not os.path.isfile(path):
        checks.append('{}: no file {}'.format(what, path))
        return {}
    with open(path, 'rb') as f:
        signature = f.read(8)
    text = read_png_text(path)
    shape = read_image(path).shape
    if signature != PNG_SIGNATURE or not set(keys) <= set(text) \
            or len(shape) != 3 or shape[2] != 3:
        checks.append('{}: {} is no PNG with {} ({}, {})'.format(
            what, path, keys, sorted(text), shape))
    return text


def _figure_checks(engine, dataset, checks):
    """The figures of 16a's run under its save dir: 4 feature maps, the
    triplet grid, the embedding projection and the two barplots, whose
    values are the writer's statistics. Returns the file counts."""
    import glob
    save = engine.config.data.save_dir
    maps = sorted(glob.glob(os.path.join(save, 'debug_feature_maps',
                                         '*.png')))
    if [os.path.basename(p) for p in maps] != \
            ['featuremap_{}.png'.format(i) for i in range(4)]:
        checks.append('16a: feature maps {}'.format(maps))
    for p in maps:
        _png_text(p, ('r0c0', 'r0c1'), '16a feature map', checks)
    trip = _png_text(os.path.join(save, 'debug_triplets', 'triplets.png'),
                     ('r0c0', 'r0c1', 'r0c2'), '16a triplets', checks)
    if trip and not (trip['r0c0'].startswith('anchor ')
                     and trip['r0c1'].startswith('pos d=')
                     and trip['r0c2'].startswith('neg d=')):
        checks.append('16a: triplet titles {}'.format(trip))
    proj = _png_text(os.path.join(save, 'embeddings_' + dataset,
                                  'embeddings_{}.png'.format(dataset)),
                     ('title', 'legend'), '16a projection', checks)
    figures = os.path.join(save, 'figures')
    pairs = _png_text(os.path.join(
        figures, 'Query-gallery body part pairs availability barplot_0.png'),
        ('title', 'values'), '16a pairs barplot', checks)
    vis = _png_text(os.path.join(
        figures, 'Query-gallery body part availability barplot_0.png'),
        ('title', 'query', 'gallery'), '16a visibility barplot', checks)
    stats = engine.writer.qg_stats
    for text, key, stat in ((pairs, 'values', 'part_pair_availability'),
                            (vis, 'query', 'q_part_visibility'),
                            (vis, 'gallery', 'g_part_visibility')):
        if text and [float(v) for v in text[key].split()] != \
                [float(v) for v in stats[stat]]:
            checks.append('16a: barplot {} != qg_stats {}'.format(key, stat))
    return {'feature_maps': len(maps), 'triplets': int(bool(trip)),
            'projection': int(bool(proj)),
            'barplots': len(os.listdir(figures))
            if os.path.isdir(figures) else 0}


def _save_torchreid_file(torch, engine, path, cmc, mAP):
    """The engine's model as a torchreid checkpoint: its state dict as
    torchreid writes it, the test's ``rank1`` and ``mAP`` and the model
    config."""
    sd = torchreid_state_dict(torch, {
        k: v.detach().cpu() for k, v in engine.model.state_dict().items()})
    torch.save({'state_dict': sd, 'epoch': 1, 'rank1': float(cmc[0]),
                'mAP': float(mAP), 'config': {'model': {
                    'bpbreid': engine.config.to_dict()['model']['bpbreid']}}},
               path)


def _profile_total(torch, engine, batches):
    """A Chrome trace of ``forward_backward`` on the last 3 of
    ``batches`` after a warm-up step on the first (the debug figures
    off), summed by ``tools/profile_summary.py``, against the profiler's
    own CUDA total (the self device time of its CUDA events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from bpbreid_tpu_torch.tools import profile_summary
    engine.config.train.batch_debug_freq = 0
    engine.forward_backward(batches[0])              # warm-up
    batches = batches[-3:]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for batch in batches:
            engine.forward_backward(batch)
        torch.cuda.synchronize()
    trace = os.path.join(CLI_SAVE_DIR, 'phase16_train_steps.json')
    prof.export_chrome_trace(trace)
    rows, cats, total_ns, label = profile_summary.summarize(trace, top=8)
    own_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and not getattr(e, 'is_user_annotation', False))
    return {'steps': len(batches), 'label': label,
            'summary_ms': total_ns / 1e6, 'profiler_cuda_ms': own_us / 1e3,
            'rel_diff': abs(total_ns / 1e3 - own_us) / max(own_us, 1e-9),
            'categories_ms': {k: v / 1e6 for k, v in cats.most_common()},
            'top_kernels': [{'name': n[:90], 'ms': ns / 1e6, 'count': c}
                            for n, ns, c in rows],
            'trace_mb': os.path.getsize(trace) / 1e6}


def phase_figures_and_tools(torch, results, ranking_inputs):
    """Phase 16 (see the module docstring). ``ranking_inputs`` are phase
    8b's host distance matrix and ids. Returns the launch counts of its
    runs, each counted from 0."""
    import shutil
    import types
    from bpbreid_tpu_torch.data.datasets import clear_dataset_cache
    from bpbreid_tpu_torch.hyperparameter import (GridSearch,
                                                  HyperParameterOptimizer)
    from bpbreid_tpu_torch.metrics.rank import evaluate_rank
    from bpbreid_tpu_torch.native import rank as native_rank
    from bpbreid_tpu_torch.ops.cuda.build import (launch_counts,
                                                  reset_launch_counts)
    from bpbreid_tpu_torch.scripts.main import build_config
    from bpbreid_tpu_torch.tools import reproduce
    from bpbreid_tpu_torch.utils.model_complexity import \
        compute_model_complexity
    t_phase = time.perf_counter()
    register_cli_dataset(DEBUG_DATASET, DEBUG_CAMS)
    shutil.rmtree(CLI_SAVE_DIR, ignore_errors=True)
    out, checks, launches = {}, [], {}

    # 16a: train with the debug figures, test with the projection
    with DebugRecorder(torch) as dbg:
        engine, (cmc, mAP, _, _), counts, rec, wall = drive_cli(
            torch, '16a train, debug figures, projection', cli_argv(
                161, 'train.max_epoch', '1',
                'train.batch_debug_freq', str(DEBUG_FREQ),
                'test.vis_embedding_projection', 'True',
                'test.visrank', 'False', 'model.save_model_flag', 'True',
                dataset=DEBUG_DATASET))
    _add_counts(launches, counts)
    bn, no_grad = _bn_split(engine.model, engine.losses_weights)
    for call in dbg.calls:          # the steps' own launches
        for k in BN_KERNELS:
            rec.launches[call['step']][k] -= call['launches'].get(k, 0)
    want, bad = _step_launch_checks(rec, bn, no_grad, '16a')
    checks += bad
    steps = len(rec.losses)
    debug_want = {'bn_apply': len(bn)}
    if steps != DEBUG_STEPS or [c['step'] for c in dbg.calls] != \
            list(range(0, DEBUG_STEPS, DEBUG_FREQ)):
        checks.append('16a: {} steps, debug at {}'.format(
            steps, [c['step'] for c in dbg.calls]))
    if any(c['launches'] != debug_want or len(c['paths']) != 5
           for c in dbg.calls):
        checks.append('16a: debug forwards {} != {} and 5 figures'.format(
            [(c['launches'], len(c['paths'])) for c in dbg.calls],
            debug_want))
    eval_apply = counts.get('bn_apply', 0) - steps * want['bn_apply'] \
        - sum(c['launches'].get('bn_apply', 0) for c in dbg.calls)
    if eval_apply != DEBUG_EVAL_BATCHES * len(bn) \
            or counts.get('attention_pool', 0):
        checks.append('16a: test launches {} bn_apply (want {} x {}), K2 {}'
                      .format(eval_apply, DEBUG_EVAL_BATCHES, len(bn),
                              counts.get('attention_pool', 0)))
    losses = [float(v) for v in rec.losses]
    if not all(np.isfinite(losses)) or not np.isfinite(float(mAP)):
        checks.append('16a: losses {} mAP {}'.format(losses, mAP))
    figures = _figure_checks(engine, DEBUG_DATASET, checks)
    if figures != {'feature_maps': 4, 'triplets': 1, 'projection': 1,
                   'barplots': 2}:
        checks.append('16a: figures {}'.format(figures))
    intervals = rec.step_intervals_ms()
    debug_ms = [c['ms'] for c in dbg.calls]
    # the intervals less the debug figures drawn inside their step
    own = [ms - sum(c['ms'] for c in dbg.calls if c['step'] == i)
           for i, ms in enumerate(intervals)]
    ckpt = rec.checkpoint
    out['16a'] = {
        'steps': steps, 'losses': losses,
        'step_ms_median': statistics.median(own), 'step_ms': own,
        'step_ms_with_figures': intervals, 'debug_forward_ms': debug_ms,
        'debug_forward_launches': [c['launches'] for c in dbg.calls],
        'bn_launches_per_step': want, 'eval_bn_apply': eval_apply,
        'rank1': float(cmc[0]), 'mAP': float(mAP), 'figures': figures,
        'launches': counts, 'wall_s': wall}
    if ckpt is None:
        raise AssertionError('16a: the run wrote no checkpoint')

    # 16a, through K2: a test-only run from the checkpoint, then the debug
    # forward of one train batch on its engine
    engine2, (cmc2, mAP2, _, _), counts2, rec2, wall2 = drive_cli(
        torch, '16a test through K2, projection', cli_argv(
            162, 'test.evaluate', 'True', 'test.visrank', 'False',
            'model.load_weights', ckpt,
            'model.bpbreid.use_pallas_pooling', 'True',
            'model.bpbreid.multires_pooling', 'False',
            'test.vis_embedding_projection', 'True', dataset=DEBUG_DATASET))
    _add_counts(launches, counts2)
    want2 = {'attention_pool': DEBUG_EVAL_BATCHES,
             'bn_apply': DEBUG_EVAL_BATCHES * len(bn)}
    if {k: v for k, v in counts2.items() if v} != want2:
        checks.append('16a K2 test: launches {} != {}'.format(counts2, want2))
    _png_text(os.path.join(engine2.config.data.save_dir,
                           'embeddings_' + DEBUG_DATASET,
                           'embeddings_{}.png'.format(DEBUG_DATASET)),
              ('title', 'legend'), '16a K2 projection', checks)
    # (one feature map: the launches are the whole batch's forward; the
    # host's PCA takes about 2.5 s a sample beside an H100)
    batch = next(iter(engine2.datamanager.train_loader))
    engine2.model.train()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    paths = engine2._debug_visualize_batch(batch, max_samples=1)
    torch.cuda.synchronize()
    k2_debug_ms = (time.perf_counter() - t0) * 1e3
    k2_debug = {k: v for k, v in launch_counts.items() if v}
    _add_counts(launches, k2_debug)
    want_k2 = {'attention_pool': 1, 'bn_apply': len(bn)}
    if k2_debug != want_k2 or len(paths) != 2 or not engine2.model.training:
        checks.append('16a K2 debug forward: {} != {}, {} figures, train '
                      'mode {}'.format(k2_debug, want_k2, len(paths),
                                       engine2.model.training))
    out['16a_k2'] = {'test_launches': counts2, 'rank1': float(cmc2[0]),
                     'mAP': float(mAP2), 'debug_forward_ms': k2_debug_ms,
                     'debug_forward_launches': k2_debug, 'wall_s': wall2}
    del engine2, rec2, batch
    torch.cuda.empty_cache()
    out['16a_s'] = time.perf_counter() - t_phase

    # 16b: the native ranker on phase 8b's host distance matrix
    t_b = time.perf_counter()
    distmat, q_pids, g_pids, q_camids, g_camids = ranking_inputs
    t0 = time.perf_counter()
    native_rank.load()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nat = evaluate_rank(distmat, q_pids, g_pids, q_camids, g_camids)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = evaluate_rank(distmat, q_pids, g_pids, q_camids, g_camids,
                          use_native=False)
    numpy_s = time.perf_counter() - t0
    cmc_err = float(np.abs(nat['cmc'] - plain['cmc']).max())
    map_err = abs(nat['mAP'] - plain['mAP'])
    if not (cmc_err <= 1e-6 and map_err <= 1e-6):
        checks.append('16b: native vs numpy CMC {} mAP {}'.format(cmc_err,
                                                                  map_err))
    out['16b'] = {'shape': list(distmat.shape), 'build_s': build_s,
                  'native_s': native_s, 'numpy_s': numpy_s,
                  'native_speedup': numpy_s / native_s,
                  'cmc_max_abs_err': cmc_err, 'mAP_abs_err': map_err,
                  'threads': os.cpu_count(),
                  'phase8b_host_path_s':
                      results['large_gallery']['market1501']['host_path_s']}
    log('phase 16b', json.dumps(out['16b']))
    out['16b_s'] = time.perf_counter() - t_b

    # 16c: reproduce 16a's test from a torchreid file of its model
    t_c = time.perf_counter()
    pth = os.path.join(CLI_SAVE_DIR, 'bpbreid_16a.pth')
    _save_torchreid_file(torch, engine, pth, cmc, mAP)
    json_out = os.path.join(CLI_SAVE_DIR, 'reproduce.json')
    clear_dataset_cache()
    torch.cuda.synchronize()
    reset_launch_counts()
    rc = reproduce.main([
        '--checkpoint', pth, '--root', '', '--dataset', DEBUG_DATASET,
        '--config-file', CLI_CONFIG, '--save_dir',
        os.path.join(CLI_SAVE_DIR, 'reproduce'), '--max-delta', '1e-6',
        '--json-out', json_out, 'test.visrank', 'False'])
    torch.cuda.synchronize()
    counts_c = {k: v for k, v in launch_counts.items() if v}
    _add_counts(launches, counts_c)
    with open(json_out) as f:
        repro = json.load(f)
    if rc != 0 or not (abs(repro['delta_mAP']) <= 1e-6
                       and abs(repro['delta_rank1']) <= 1e-6):
        checks.append('16c: reproduce exit {} deltas {} {}'.format(
            rc, repro['delta_mAP'], repro['delta_rank1']))
    if counts_c != {'bn_apply': DEBUG_EVAL_BATCHES * len(bn)}:
        checks.append('16c: launches {}'.format(counts_c))
    out['16c'] = {'exit_code': rc, 'delta_mAP': repro['delta_mAP'],
                  'delta_rank1': repro['delta_rank1'],
                  'stored': repro['stored'], 'launches': counts_c,
                  'seconds': time.perf_counter() - t_c}

    # 16d: model complexity, the profile summary, the HPO search
    t_d = time.perf_counter()
    t0 = time.perf_counter()
    params, flops = compute_model_complexity(engine.model, engine.config)
    complexity_s = time.perf_counter() - t0
    all_params = sum(p.numel() for p in engine.model.parameters())
    if params != all_params or not flops > 0:
        checks.append('16d: params {} (all {}), flops {}'.format(
            params, all_params, flops))
    batches = list(engine.datamanager.train_loader)[:4]
    prof = _profile_total(torch, engine, batches)
    if not prof['rel_diff'] <= 0.01 or not prof['label'].startswith('device'):
        checks.append('16d: profile summary {} ms vs the profiler {} ms'
                      .format(prof['summary_ms'], prof['profiler_cuda_ms']))
    del engine, rec, batches
    torch.cuda.empty_cache()
    clear_dataset_cache()
    base = build_config(types.SimpleNamespace(
        save_dir=os.path.join(CLI_SAVE_DIR, 'hpo'), job_id=1,
        opts=['train.max_epoch', '1']), HPO_CONFIG)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    best = HyperParameterOptimizer(base, GridSearch(HPO_SPACE)).optimize()
    torch.cuda.synchronize()
    hpo_s = time.perf_counter() - t0
    counts_d = {k: v for k, v in launch_counts.items() if v}
    _add_counts(launches, counts_d)
    with open(os.path.join(base.data.save_dir, 'hpo_results.json')) as f:
        hpo = json.load(f)
    rank1s = [r['metrics']['rank1'] for r in hpo['results']]
    if len(rank1s) != 2 or not all(np.isfinite(rank1s)) \
            or hpo['best'] != best or not counts_d.get('bn_stats'):
        checks.append('16d: HPO {} launches {}'.format(hpo, counts_d))
    out['16d'] = {'params': params, 'flops': flops,
                  'complexity_s': complexity_s, 'profile': prof,
                  'hpo_rank1': rank1s, 'hpo_best': best['overrides'],
                  'hpo_s': hpo_s, 'hpo_launches': counts_d}
    out['16d_s'] = time.perf_counter() - t_d
    shutil.rmtree(CLI_SAVE_DIR, ignore_errors=True)
    out['launches'] = launches
    out['phase_s'] = time.perf_counter() - t_phase
    results['figures'] = out
    if checks:
        raise AssertionError('phase 16: ' + '; '.join(checks))
    return launches



# phase 17: data parallelism (parallel/) on the one card. NCCL refuses two
# ranks on one GPU, so NCCL runs at world size 1 in this process (17b) and
# the 2-rank checks run as 2 gloo ranks on cuda:0, spawned (17c, 17d)
DP_LEARN = 20
DP_SAVE_DIR = os.path.join('_scratch', 'chip_smoke_dp')
# phase 7's depth-reduced HRNet-W32
DP_SMALL_STAGES = {'stage2': (1, 2, (2, 2), (32, 64)),
                   'stage3': (1, 3, (2, 2, 2), (32, 64, 128)),
                   'stage4': (1, 4, (2, 2, 2, 2), (32, 64, 128, 256))}
BN_APPLY_SUMS_REPLACES = ('experiments/pallas_bn_v2.py:55 (K3a: its '
                          'epilogue on sums all-reduced across ranks and its '
                          'second pass; bpbreid_tpu/models/common.py:191)')


def _dp_spec(device='cuda', backend='nccl', height=HEIGHT, width=WIDTH,
             ids=TRAIN_IDS, instances=TRAIN_INSTANCES, stages=None,
             market=(MARKET_QUERY, MARKET_GALLERY + 1, MARKET_IDS),
             learn=DP_LEARN):
    """What phase 17 runs at: the flagship train step (``stages`` None:
    HRNet-W32 at full depth) and Market-1501's query and gallery counts,
    the gallery made odd so that 2 ranks pad it."""
    return {'device': device, 'backend': backend, 'height': height,
            'width': width, 'ids': ids, 'instances': instances,
            'stages': stages, 'market': market, 'learn': learn}


def _to(tree, device):
    """The tensors of a tree of dicts, lists and tuples on ``device``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device)


def state_digest(model):
    """sha256 of the bytes of every parameter and buffer, in order."""
    import hashlib

    import torch
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().reshape(-1)
                 .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _dp_engine(torch, spec, small=False, stages=None):
    """The flagship train engine of ``spec`` (bf16; ``stages``: another
    depth at the same width), or with ``small`` phase 7's f32 model at
    64x32; seeded weights."""
    if small:
        cfg = train_config(64, 32, 'float32', 64)
        return cfg, train_engine(torch, cfg, 7, spec['device'],
                                 backbone_stages=DP_SMALL_STAGES)
    cfg = train_config(spec['height'], spec['width'])
    stages = stages or spec['stages']
    kwargs = {'backbone_stages': stages} if stages else {}
    return cfg, train_engine(torch, cfg, 751, spec['device'], **kwargs)


def _dp_batches(torch, spec):
    """The full-width batch with three steps' draws and the learning draws,
    and the small f32 batch with its draws (phase 7's recipe); on the
    CPU, to cross to the ranks."""
    from bpbreid_tpu_torch.data.augment import sample_train_draws
    cfg = train_config(spec['height'], spec['width'])
    n = spec['ids'] * spec['instances']
    gen = torch.Generator(device=spec['device']).manual_seed(SEED + 17)
    draw = lambda k, h, w: _to(sample_train_draws(  # noqa: E731
        gen, k, h, w, cfg.data.transforms), 'cpu')
    return {
        'batch': make_train_batch(np.random.default_rng(SEED + 2),
                                  spec['ids'], spec['instances'],
                                  spec['height'], spec['width'], 'cpu'),
        'draws': [draw(n, spec['height'], spec['width']) for _ in range(3)],
        'learn_draws': draw(n, spec['height'], spec['width']),
        'small_batch': make_train_batch(np.random.default_rng(SEED + 3), 2,
                                        4, 64, 32, 'cpu'),
        'small_draws': draw(8, 64, 32)}


def _bn_names(torch, model):
    """The model's kernel-backed train-mode BNs (all but the pixel
    classifier's, whose statistics are virtual) and those whose streams
    feed no loss (no backward), as phase 6 counts them."""
    from bpbreid_tpu_torch.models.common import FastBatchNorm
    bn = [n for n, mod in model.named_modules()
          if isinstance(mod, FastBatchNorm) and n != 'pixel_classifier.bn']
    no_grad = [n for n in bn if n.startswith((
        'background_after_pooling_dim_reduce',
        'background_identity_classifier', 'parts_identity_classifier'))]
    return bn, no_grad


def _small_step(torch, engine, model, p, device):
    """One f32 step of phase 7's model on the small batch: the record
    ``compare_train_steps`` reads."""
    before = {k: v.detach().cpu().clone()
              for k, v in model.named_parameters()}
    loss, _ = engine.forward_backward(_to(p['small_batch'], device),
                                      draws=_to(p['small_draws'], device))
    return {'loss': loss.item(), 'before': before,
            'grads': {k: v.grad.detach().cpu().clone()
                      for k, v in model.named_parameters()},
            'state': {k: v.detach().cpu().clone()
                      for k, v in model.state_dict().items()}}


def _dp_bn_kernels(torch, bn_shapes):
    """17a: ``bn_apply_sums`` (the cross-rank BN's forward from all-reduced
    sums) on the sums of two ranks' equal slices with the global count,
    and ``bn_dx`` with the global count, against their plain versions at
    each distinct BN input of the train step (phase 6): the statistics
    and the running update to 1e-6 relative of ``bn_finalize_reference``,
    ``y`` to one ulp of its type plus 1e-6 of its terms of
    ``bn_apply_reference`` on those statistics, ``bn_dx`` one ulp plus
    1e-6 of its terms, each the same bits over two calls; then
    ``bn_apply_sums``'s times at the reported input beside ``bn_apply``'s
    alone on the same input (eager, CUDA events; device, a CUDA graph of
    20 calls), its plain version's, SyncBatchNorm's two library calls
    after its gather (``batch_norm_gather_stats_with_counts``,
    ``batch_norm_elemt``) and its bound."""
    from bpbreid_tpu_torch.ops.cuda.batchnorm import (
        bn_apply, bn_apply_reference, bn_apply_sums, bn_apply_sums_reference,
        bn_dx, bn_dx_reference, bn_finalize_reference)
    gen = torch.Generator(device='cuda').manual_seed(SEED + 17)
    rows, failures, timed = [], [], None
    for (shape, dt, cd), _calls in bn_shapes:
        x = (0.5 + torch.randn(shape, device='cuda', generator=gen)).to(dt)
        dy = torch.randn(shape, device='cuda', generator=gen).to(dt)
        o = _bn_operands(torch, x, dy, cd, gen)
        a, c, b, w, bias = o['a'], o['c'], o['b'], o['w'], o['bias']
        m = 2 * a * b
        sums = torch.stack(o['st'][4:]) * 2
        runs = []
        for _ in range(2):
            rm, rv = o['rm'].clone(), o['rv'].clone()
            y, stats = bn_apply_sums(x, sums, m, w, bias, 1e-5, cd,
                                     running_mean=rm, running_var=rv)
            runs.append((y,) + stats + (rm, rv))
        rm, rv = o['rm'].clone(), o['rv'].clone()
        want = bn_finalize_reference(sums[0], sums[1], m, w, 1e-5, rm, rv) \
            + (rm, rv)
        fin_err, ok = 0.0, True
        for g, g2, v in zip(runs[0][1:], runs[1][1:], want):
            d = (g - v).abs()
            fin_err = max(fin_err, d.max().item())
            ok = ok and bool((d <= 1e-6 * v.abs() + 1e-7).all()) \
                and torch.equal(g, g2)
        mean, rstd, scale = want[0], want[2], want[3]
        x3 = x.reshape(a, c, b).float()
        terms = ((x3 - mean.view(1, c, 1)).abs() * scale.abs().view(1, c, 1)
                 + bias.abs().view(1, c, 1))
        y_err, y_ok = _ew_errors(torch, runs[0][0], bn_apply_reference(
            x, mean, rstd, w, bias, cd), terms.view(x.shape))
        if not (ok and y_ok and torch.equal(runs[0][0], runs[1][0])):
            failures.append('bn_apply_sums at {} {}'.format(shape, dt))
        mean, _, rstd, scale = runs[0][1:5]
        sum_dy, sum_dy_xhat = (t * 2 for t in o['g'])
        got = [bn_dx(dy, x, mean, rstd, scale, sum_dy, sum_dy_xhat, cd, m)
               for _ in range(2)]
        xhat = (x3 - mean.view(1, c, 1)) * rstd.view(1, c, 1)
        terms = scale.abs().view(1, c, 1) * (
            dy.reshape(a, c, b).float().abs()
            + (sum_dy.abs() / m).view(1, c, 1)
            + (xhat * sum_dy_xhat.view(1, c, 1)).abs() / m)
        dx_err, ok = _ew_errors(torch, got[0], bn_dx_reference(
            dy, x, mean, rstd, scale, sum_dy, sum_dy_xhat, cd, m=m),
            terms.view(x.shape))
        if not (ok and torch.equal(got[0], got[1])):
            failures.append('bn_dx with a count at {} {}'.format(shape, dt))
        row = {'shape': list(shape), 'dtype': str(dt), 'channel_dim': cd,
               'bn_apply_sums_stats_err': fin_err,
               'bn_apply_sums_max_abs_err': y_err,
               'bn_dx_count_max_abs_err': dx_err}
        rows.append(row)
        del dy, x3, xhat, terms, got, runs
        if timed is None or (tuple(shape), str(dt)) == K3_REPORT:
            timed = (row, x, cd, sums, m, o)
        del x
    row, x, cd, sums, m, o = timed
    c, w, bias = o['c'], o['w'], o['bias']
    rm, rv = o['rm'].clone(), o['rv'].clone()
    mean, rstd = o['st'][0], o['st'][2]
    t = lambda fn: time_ms(fn, torch, warmup=3, iters=20,  # noqa: E731
                           repeats=5)
    fused = lambda: bn_apply_sums(x, sums, m, w, bias, 1e-5, cd,  # noqa: E731
                                  running_mean=rm, running_var=rv)
    alone = lambda: bn_apply(x, mean, rstd, w, bias, cd)  # noqa: E731
    row['bn_apply_sums_ms'] = t(fused)
    row['bn_apply_ms'] = t(alone)
    row['bn_apply_sums_device_ms'] = graph_ms(torch, fused)
    row['bn_apply_device_ms'] = graph_ms(torch, alone)
    row['bn_apply_sums_plain_ms'] = t(lambda: bn_apply_sums_reference(
        x, sums, m, w, bias, 1e-5, cd, None, rm, rv))
    # SyncBatchNorm's forward once its ranks' means and inverse deviations
    # are gathered: the statistics with the counts, then the normalize
    mean2, invstd2 = (v.expand(2, c).contiguous() for v in (mean, rstd))
    counts = torch.full((2,), float(m // 2), device='cuda')
    xl = _nc(x, cd)

    def sync_bn():
        mu, inv = torch.batch_norm_gather_stats_with_counts(
            xl, mean2, invstd2, rm, rv, 0.1, 1e-5, counts)
        return torch.batch_norm_elemt(xl, w, bias, mu, inv, 1e-5)
    try:
        row['library_two_calls_ms'] = t(sync_bn)
        row['library_two_calls_device_ms'] = graph_ms(torch, sync_bn)
    except RuntimeError as e:
        row['library_two_calls_ms'] = None
        row['library_two_calls_device_ms'] = None
        row['library_two_calls_error'] = str(e).splitlines()[0][:200]
    # x read and y written once; the sums, weight, bias and running
    # statistics read (6C) and the statistics and running statistics
    # written (6C); 3 f32 operations an element and about 12 a channel
    row['bn_apply_sums_bound_ms'], row['bn_apply_sums_bound_by'] = \
        _k3_bound_ms(2 * x.numel() * x.element_size() + 12 * c * 4,
                     3.0 * x.numel() + 12.0 * c)
    log('17a', json.dumps(row))
    if failures:
        raise AssertionError('\n'.join(failures))
    return {'rows': rows, 'timed': row,
            'bn_apply_sums_worst_err': max(r['bn_apply_sums_max_abs_err']
                                           for r in rows),
            'bn_apply_sums_stats_worst_err': max(
                r['bn_apply_sums_stats_err'] for r in rows),
            'bn_dx_count_worst_err': max(r['bn_dx_count_max_abs_err']
                                         for r in rows)}


def _dp_world1(torch, spec, p):
    """17b: three flagship train steps through ``distribute_engine`` on a
    one-rank process group (NCCL on the card): ``bn_stats`` (sums) ->
    ``all_reduce`` -> ``bn_apply_sums`` forward, ``bn_grad_stats`` (the
    sums twice) -> ``all_reduce`` of the copy in place -> ``bn_dx`` with
    the count backward, held against the one-process steps on the same
    batch and draws: losses 1e-5 relative, step 1's gradients and the
    state after it at phase 7's tolerances (``compare_train_steps``);
    whether the states after the steps are bit-equal is reported. Steps 1
    and 2 are timed (host clock), step 3 runs under torch.profiler (its
    device kernels and busy share) in both runs. Returns the record and
    the kernel launches of the distributed steps."""
    import torch.distributed as dist
    from bpbreid_tpu_torch.ops.cuda.build import (launch_counts,
                                                  reset_launch_counts)
    from bpbreid_tpu_torch.parallel import distribute_engine
    from bpbreid_tpu_torch.parallel.mesh import (collective_counts,
                                                 init_process_group,
                                                 reset_collective_counts)
    device = spec['device']
    batch = _to(p['batch'], device)
    out, states, first = {}, {}, {}
    os.makedirs(DP_SAVE_DIR, exist_ok=True)
    rendezvous = os.path.join(DP_SAVE_DIR, 'rendezvous_world1')
    if os.path.exists(rendezvous):
        os.remove(rendezvous)
    mesh = None
    for name in ('one_process', 'world1'):
        _cfg, (model, engine) = _dp_engine(torch, spec)
        if name == 'world1':
            mesh = init_process_group(0, 1, 'file://' + os.path.abspath(
                rendezvous), spec['backend'], device)
            distribute_engine(engine, mesh)
        bn, no_grad = _bn_names(torch, model)
        reset_launch_counts()
        reset_collective_counts()
        losses, step_ms, prof = [], [], None
        before = {k: v.detach().cpu().clone()
                  for k, v in model.named_parameters()}
        for i, d in enumerate(p['draws']):
            def step(d=d):
                losses.append(engine.forward_backward(
                    batch, _to(d, device))[0].item())
            if i == len(p['draws']) - 1 and device == 'cuda':
                prof = profile_steps(torch, step, steps=1)
            else:
                t0 = time.perf_counter()
                step()
                step_ms.append((time.perf_counter() - t0) * 1e3)
            if len(losses) == 1:
                # what compare_train_steps reads of step 1
                first[name] = {
                    'loss': losses[0], 'before': before,
                    'grads': {k: v.grad.detach().cpu().clone()
                              for k, v in model.named_parameters()},
                    'state': {k: v.detach().cpu().clone()
                              for k, v in model.state_dict().items()}}
        out[name] = {'losses': losses, 'launches': dict(launch_counts),
                     'collectives': dict(collective_counts),
                     'step_ms': step_ms, 'profile': prof and {
                         k: prof[k] for k in ('wall_ms', 'device_busy_ms',
                                              'busy_share',
                                              'device_kernel_launches')}}
        states[name] = {k: v.detach().clone()
                        for k, v in model.state_dict().items()}
        del model, engine
    try:
        diff = max((states['world1'][k].float()
                    - v.float()).abs().max().item()
                   for k, v in states['one_process'].items())
        bit_equal = all(torch.equal(states['world1'][k], v)
                        for k, v in states['one_process'].items())
    finally:
        dist.destroy_process_group()
    del states
    step1, checks = compare_train_steps(first['world1'],
                                        first['one_process'])
    del first
    if device == 'cuda':
        torch.cuda.empty_cache()
    rec = {'backend': mesh.backend, 'steps': len(p['draws']),
           'losses_one_process': out['one_process']['losses'],
           'losses_world1': out['world1']['losses'],
           'state_max_abs_diff': diff, 'bit_equal': bit_equal,
           'step1_vs_one_process': {
               k.replace('card', 'world1').replace('cpu', 'one_process'): v
               for k, v in step1.items()},
           'launches': out['world1']['launches'],
           'collectives': out['world1']['collectives'],
           'step_ms_one_process': out['one_process']['step_ms'],
           'step_ms_world1': out['world1']['step_ms'],
           'profiled_step_one_process': out['one_process']['profile'],
           'profiled_step_world1': out['world1']['profile'],
           'bn_modules': len(bn), 'bn_without_backward': len(no_grad)}
    log('17b', json.dumps(rec))
    checks = ['step 1: ' + c for c in checks]
    for a, b in zip(rec['losses_world1'], rec['losses_one_process']):
        if not abs(a - b) <= 1e-5 * abs(b):
            checks.append('losses {} vs {}'.format(a, b))
    steps = rec['steps'] if device == 'cuda' else 0    # CPU: no launch
    # one bn_stats and one bn_apply_sums a BN call, no plain bn_apply: two
    # launches forward, two backward
    for k, want in (('bn_stats', len(bn)), ('bn_apply_sums', len(bn)),
                    ('bn_apply', 0),
                    ('bn_grad_stats', len(bn) - len(no_grad)),
                    ('bn_dx', len(bn) - len(no_grad))):
        if rec['launches'].get(k, 0) != want * steps:
            checks.append('{} launches {} != {}'.format(
                k, rec['launches'].get(k, 0), want * steps))
    if checks:
        raise AssertionError('17b: ' + '; '.join(checks))
    return rec


def _dp_rank(rank, world, init_method, payload_path, out_dir):
    """One spawned rank of 17c and 17d: gloo on the spec's device."""
    import torch
    import torch.distributed as dist
    from bpbreid_tpu_torch.parallel.mesh import init_process_group
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    p = torch.load(payload_path, weights_only=False)
    spec = p['spec']
    if spec['device'] == 'cpu':
        torch.set_num_threads(2)
    mesh = init_process_group(rank, world, init_method, 'gloo',
                              spec['device'])
    try:
        out = {'17c': _dp_rank_train(torch, mesh, spec, p),
               '17d': _dp_rank_retrieval(torch, mesh, spec)}
        torch.save(out, os.path.join(out_dir, 'rank{}.pt'.format(rank)))
    finally:
        dist.destroy_process_group()


def _dp_rank_train(torch, mesh, spec, p):
    """17c on one rank: the flagship step on its half of the global batch
    (launches and collectives of that step) and the digest of the state
    after it; 20 steps on the one batch at phase 7's depth (the flagship's
    width, batch and dtype) and the digest after them; phase 7's small
    f32 step."""
    from bpbreid_tpu_torch.ops.cuda.build import (launch_counts,
                                                  reset_launch_counts)
    from bpbreid_tpu_torch.parallel import distribute_engine
    from bpbreid_tpu_torch.parallel.mesh import (collective_counts,
                                                 reset_collective_counts)
    device = spec['device']
    _cfg, (model, engine) = _dp_engine(torch, spec)
    distribute_engine(engine, mesh)
    bn, no_grad = _bn_names(torch, model)
    batch = _to(p['batch'], device)
    sync = torch.cuda.synchronize if device == 'cuda' else (lambda: None)
    reset_launch_counts()
    reset_collective_counts()
    loss = engine.forward_backward(batch, _to(p['draws'][0], device))[0]
    out = {'loss': loss.item(), 'launches': dict(launch_counts),
           'collectives': dict(collective_counts), 'bn_modules': len(bn),
           'bn_without_backward': len(no_grad),
           'digest_step': state_digest(model)}
    del model, engine
    # the learning check at phase 7's depth: a full-depth step on 2 gloo
    # ranks on one card takes about 2 s (the gradient's all_reduce goes
    # through the host)
    _cfg, (model, engine) = _dp_engine(torch, spec, stages=DP_SMALL_STAGES)
    distribute_engine(engine, mesh)
    learn, step_ms = [], []
    learn_draws = _to(p['learn_draws'], device)
    for _ in range(spec['learn']):
        sync()
        t0 = time.perf_counter()
        learn.append(engine.forward_backward(batch, learn_draws)[0].item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    out.update(learning_losses=learn, step_ms_median=statistics.median(
        step_ms), digest=state_digest(model))
    del model, engine
    _cfg, (model, engine) = _dp_engine(torch, spec, small=True)
    distribute_engine(engine, mesh)
    out['small'] = _small_step(torch, engine, model, p, device)
    return out


def _dp_rank_retrieval(torch, mesh, spec):
    """17d on one rank: Market-1501-size features (phase 8b's recipe, the
    gallery one image larger: odd), boolean visibility; the sharded
    distances and CMC/mAP against the one-process path on this rank, and
    the engine's ``evaluate`` under the mesh (its gallery-sharded
    branch, then the host ranking)."""
    from bpbreid_tpu_torch.engine.part_based import ImagePartBasedEngine
    from bpbreid_tpu_torch.metrics.distance import \
        compute_distance_matrix_using_bp_features
    from bpbreid_tpu_torch.ops.ranking import cmc_map
    from bpbreid_tpu_torch.parallel import (sharded_bp_distance,
                                            sharded_cmc_map)
    device = spec['device']
    sync = torch.cuda.synchronize if device == 'cuda' else (lambda: None)
    nq, ng, n_ids = spec['market']
    gen = torch.Generator(device=device).manual_seed(SEED + 18)
    k, d = 6, 512
    centers = torch.randn((2 * n_ids, k, d), device=device, generator=gen)
    q_pids = torch.arange(nq, device=device) % n_ids
    g_pids = torch.randint(0, 2 * n_ids, (ng,), device=device,
                           generator=gen)
    query = _synthetic_split(torch, gen, q_pids, centers, device)
    gallery = _synthetic_split(torch, gen, g_pids, centers, device)
    qf, qv, qp, qc = query
    gf, gv, gp, gc = gallery
    qv, gv = qv.bool(), gv.bool()
    sync()
    t0 = time.perf_counter()
    dmat, bp, n_gal = sharded_bp_distance(mesh, qf, gf, qv, gv)
    sync()
    out = {'queries': nq, 'gallery': ng, 'padded_gallery': dmat.shape[1],
           'distance_s': time.perf_counter() - t0}
    d_ref, bp_ref = compute_distance_matrix_using_bp_features(
        qf, gf, qv, gv, 'mean', 500)
    out['distance_rel_err'] = ((dmat[:, :n_gal] - d_ref).abs().max()
                               / d_ref.abs().max()).item()
    out['part_distance_rel_err'] = ((bp[..., :n_gal] - bp_ref).abs().max()
                                    / bp_ref.abs().max()).item()
    del bp, bp_ref
    t0 = time.perf_counter()
    cmc, mAP, n_valid = sharded_cmc_map(mesh, dmat, qp, gp, qc, gc,
                                        n_gallery=n_gal, max_rank=50)
    out['cmc_s'] = time.perf_counter() - t0
    want = cmc_map(d_ref, qp, gp, qc, gc, max_rank=50)
    out.update(mAP=mAP, rank1=float(cmc[0]), n_valid=n_valid,
               cmc_err=float(np.abs(cmc - want[0].cpu().numpy()).max()),
               map_err=abs(mAP - float(want[1])),
               n_valid_want=int(want[2]))
    del dmat, d_ref
    engine = ImagePartBasedEngine(torch.nn.Identity(), device=device)
    splits = {'query': query + (0.0,), 'gallery': gallery + (0.0,)}
    engine.feature_extraction = splits.__getitem__
    engine.mesh = mesh
    t0 = time.perf_counter()
    res = engine.evaluate('query', 'gallery', normalize_feature=False)
    out['engine_evaluate_s'] = time.perf_counter() - t0
    out['engine_cmc_err'] = float(np.abs(res['cmc'][:50]
                                         - want[0].cpu().numpy()).max())
    out['engine_map_err'] = abs(res['mAP'] - float(want[1]))
    return out


def _dp_spawned(torch, spec, p, one_loss):
    """17c and 17d: 2 gloo ranks on the spec's device (spawned), against
    the one-process steps: the 64-image bf16 step's loss ``one_loss``
    (17b's first one-process step on the same batch and draws; 2e-2
    relative: each rank's bf16 convolutions run at 32 images), 20 steps
    on the one batch at phase 7's depth whose loss falls, the ranks'
    parameters and BN statistics bit-equal after the full-depth step and
    after the 20, the small f32 step at phase 7's tolerances, and
    each rank's BN launches a step (one ``bn_stats`` and one
    ``bn_apply_sums`` for each kernel-backed BN and no plain
    ``bn_apply``, one ``bn_grad_stats`` and ``bn_dx`` for each with a
    backward);
    17d's distances to 1e-5 relative and CMC/mAP to 1e-6."""
    import torch.multiprocessing as mp
    device = spec['device']
    _cfg, (model, engine) = _dp_engine(torch, spec, small=True)
    one_small = _small_step(torch, engine, model, p, device)
    del model, engine
    if device == 'cuda':
        torch.cuda.empty_cache()
    out_dir = os.path.join(DP_SAVE_DIR, 'ranks')
    os.makedirs(out_dir, exist_ok=True)
    payload_path = os.path.join(out_dir, 'payload.pt')
    torch.save(dict(p, spec=spec), payload_path)
    rendezvous = os.path.abspath(os.path.join(out_dir, 'rendezvous'))
    if os.path.exists(rendezvous):
        os.remove(rendezvous)
    t0 = time.perf_counter()
    # a rank that fails (or a failed collective) raises here
    mp.start_processes(_dp_rank, args=(2, 'file://' + rendezvous,
                                       payload_path, out_dir),
                       nprocs=2, join=True, start_method='spawn')
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out_dir, 'rank{}.pt'.format(r)),
                        weights_only=False) for r in range(2)]
    r0 = ranks[0]['17c']
    small, checks = compare_train_steps(r0['small'], one_small)
    bn, no_grad = r0['bn_modules'], r0['bn_without_backward']
    rec = {'ranks': 2, 'backend': 'gloo', 'device': device,
           'images_per_rank': len(p['batch']['pid']) // 2,
           'loss_ranks': [r['17c']['loss'] for r in ranks],
           'loss_one_process': one_loss,
           'loss_rel_diff': abs(r0['loss'] - one_loss) / abs(one_loss),
           'learning_losses': r0['learning_losses'],
           'step_ms_median': [r['17c']['step_ms_median'] for r in ranks],
           'digests_equal': [ranks[0]['17c'][k] == ranks[1]['17c'][k]
                             for k in ('digest_step', 'digest')],
           'launches_per_step': [r['17c']['launches'] for r in ranks],
           'collectives_per_step': [r['17c']['collectives'] for r in ranks],
           'bn_modules': bn, 'bn_without_backward': no_grad,
           'small_f32_vs_one_process': {
               k.replace('card', 'ranks').replace('cpu', 'one_process'): v
               for k, v in small.items()},
           'spawn_s': spawn_s}
    log('17c', json.dumps(rec))
    checks = ['small f32 step: ' + c for c in checks]
    if len(set(rec['loss_ranks'])) != 1:
        checks.append('the ranks\' losses differ: {}'.format(
            rec['loss_ranks']))
    if not rec['loss_rel_diff'] <= 2e-2:
        checks.append('loss {} vs one process {}'.format(r0['loss'],
                                                         one_loss))
    learn = rec['learning_losses']
    if not (all(np.isfinite(learn))
            and np.mean(learn[-3:]) < np.mean(learn[:3])):
        checks.append('loss did not fall: {}'.format(learn))
    if not all(rec['digests_equal']):
        checks.append('the ranks\' parameters or BN statistics differ: {}'
                      .format(rec['digests_equal']))
    on_card = device == 'cuda'          # the CPU runs the plain versions
    for r, launches in enumerate(rec['launches_per_step']):
        for k, want in (('bn_stats', bn), ('bn_apply_sums', bn),
                        ('bn_apply', 0), ('bn_grad_stats', bn - no_grad),
                        ('bn_dx', bn - no_grad)):
            if launches.get(k, 0) != want * on_card:
                checks.append('rank {}: {} launches {} != {}'.format(
                    r, k, launches.get(k, 0), want))
        reduces = rec['collectives_per_step'][r].get('all_reduce', 0)
        if reduces < bn + (bn - no_grad) + 1:
            checks.append('rank {}: {} all_reduce a step'.format(r, reduces))
    ret = {'ranks': [r['17d'] for r in ranks]}
    for r, x in enumerate(ret['ranks']):
        for key, tol in (('distance_rel_err', 1e-5),
                         ('part_distance_rel_err', 1e-5), ('cmc_err', 1e-6),
                         ('map_err', 1e-6), ('engine_cmc_err', 1e-6),
                         ('engine_map_err', 1e-6)):
            if not x[key] <= tol:
                checks.append('17d rank {}: {} {}'.format(r, key, x[key]))
        if x['n_valid'] != x['n_valid_want'] or x['padded_gallery'] \
                != x['gallery'] + 1:
            checks.append('17d rank {}: {}'.format(r, x))
    log('17d', json.dumps(ret))
    if checks:
        raise AssertionError('17c/17d: ' + '; '.join(checks))
    return rec, ret


def phase_data_parallel(torch, results, bn_shapes, spec=None):
    """Phase 17: data parallelism on ``torch.distributed`` (see the module
    docstring). Returns 17b's kernel launches (the distributed steps)."""
    import shutil
    spec = spec or _dp_spec()
    t0 = time.perf_counter()
    out = {'17a': _dp_bn_kernels(torch, bn_shapes)} if bn_shapes else {}
    p = _dp_batches(torch, spec)
    try:
        out['17b'] = _dp_world1(torch, spec, p)
        out['17c'], out['17d'] = _dp_spawned(
            torch, spec, p, out['17b']['losses_one_process'][0])
    finally:
        shutil.rmtree(DP_SAVE_DIR, ignore_errors=True)
    out['phase_s'] = time.perf_counter() - t0
    results['data_parallel'] = out
    return out['17b']['launches']


# phase 18: grouped dispatch through CUDA graphs (engine/graphs.py):
# train.steps_per_dispatch and test.batches_per_dispatch at full width
GRAPH_K = 8
GRAPH_LEARN_GROUPS = 3            # 24 learning steps through the graph
GRAPH_EVAL_BATCHES = 10           # a group of 8, then 2 and 6 padding


def _graph_snapshot(engine):
    import copy
    return ({k: v.clone() for k, v in engine.model.state_dict().items()},
            copy.deepcopy(engine.optimizer.state_dict()),
            engine.generator.get_state())


def _graph_restore(engine, snap):
    """``snap`` back into the engine. The optimizer gets a copy: its
    ``load_state_dict`` keeps the given tensors when their device and
    dtype fit, and the steps would then write into the snapshot."""
    import copy
    from bpbreid_tpu_torch.utils.checkpoint import load_optimizer_state
    engine.model.load_state_dict(snap[0])
    load_optimizer_state(engine.optimizer, copy.deepcopy(snap[1]))
    engine.generator.set_state(snap[2])


def _graph_state(engine):
    """Parameters, buffers (BN running statistics) and Adam's state."""
    out = {'param.' + n: p.detach().clone()
           for n, p in engine.model.named_parameters()}
    out.update({'buffer.' + n: b.clone()
                for n, b in engine.model.named_buffers()})
    for i, p in enumerate(engine.model.parameters()):
        for k, v in engine.optimizer.state[p].items():
            out['adam.{}.{}'.format(i, k)] = v.clone()
    return out


def _graph_vs_eager(torch, graph, eager_a, eager_b):
    """Each quantity of the graph run against the first eager run:
    bit-equal where the two eager runs are; else within phase 7's
    tolerances (the loss 1e-5 relative, BN statistics 1e-4 of 1 + their
    scale, parameters 2 k lr: the most k Adam steps can move an entry
    apart) or within 4 times the two eager runs' own difference."""
    counts = {'bit_equal': 0, 'eager_differs': 0}
    worst, checks = {}, []
    for name, a in eager_a.items():
        b, g = eager_b[name], graph[name]
        if torch.equal(a, b):
            counts['bit_equal'] += 1
            if not torch.equal(g, a):
                checks.append('{}: the eager runs are bit-equal, the graph '
                              'run is not'.format(name))
            continue
        counts['eager_differs'] += 1
        d = (g.double() - a.double()).abs().max().item()
        spread = (b.double() - a.double()).abs().max().item()
        if name == 'loss':
            bound = 1e-5 * a.double().abs().max().item()
        elif name.endswith(('running_mean', 'running_var')):
            bound = 1e-4 * (1 + a.double().abs().max().item())
        elif name.startswith('param.'):
            bound = 2 * GRAPH_K * LR
        else:
            bound = 0.0
        bound = max(bound, 4 * spread)
        kind = name.split('.')[0] if '.' in name else name
        worst[kind] = max(worst.get(kind, 0.0), d / bound if bound else 0.0)
        if d > bound:
            checks.append('{}: graph vs eager {} > {} (eager vs eager '
                          '{})'.format(name, d, bound, spread))
    return counts, worst, checks[:5]


def _host_launch_profile(torch, fn, steps):
    """torch.profiler over ``fn()``: device kernels, the host's kernel
    launch calls and graph launches per step, and the device's busy
    share of the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, kernels = 0.0, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA \
                and not getattr(e, 'is_user_annotation', False):
            busy_ms += e.time_range.elapsed_us() / 1e3
            kernels += 1
    host = {k.key: k.count for k in prof.key_averages()}
    launch_api = sum(v for k, v in host.items()
                     if k.startswith(('cudaLaunchKernel', 'cuLaunchKernel')))
    return {'steps': steps, 'wall_ms': wall_ms,
            'device_kernels_per_step': kernels / steps if kernels
            else 'not measured',
            'kernel_launch_calls_per_step': launch_api / steps,
            'graph_launches_per_step': host.get('cudaGraphLaunch', 0) / steps,
            'busy_share': busy_ms / wall_ms if kernels else 'not measured'}


def _phase_graph_train(torch, checks):
    """18a: the flagship train config, k = 8 steps through the graph
    against 8 eager steps from the same state (twice), then learning
    through the graph and the step times."""
    cfg = train_config()
    cfg.train.steps_per_dispatch = GRAPH_K
    model, engine = train_engine(torch, cfg, 751, 'cuda')
    if not engine.train_graphs:
        raise AssertionError('18a: the engine does not take the graph path')
    rng = np.random.default_rng(SEED + 18)
    batches = [make_train_batch(rng, TRAIN_IDS, TRAIN_INSTANCES, HEIGHT,
                                WIDTH, 'cuda') for _ in range(GRAPH_K)]
    stacked = {k: torch.stack([b[k] for b in batches])
               for k in ('image', 'mask', 'pid')}
    # cuDNN's deterministic algorithms for the comparison (its default
    # backward algorithms sum with atomics: two eager runs would differ)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    # one eager step first: the optimizer's state exists in the snapshot
    engine.forward_backward(batches[0])
    snap = _graph_snapshot(engine)
    eager = []
    for _ in range(2):
        _graph_restore(engine, snap)
        losses = torch.stack([engine.forward_backward(b)[0]
                              for b in batches])
        torch.cuda.synchronize()
        state = _graph_state(engine)
        state['loss'] = losses
        state['generator'] = engine.generator.get_state()
        eager.append(state)
    _graph_restore(engine, snap)
    losses, summary = engine.forward_backward_multi(stacked)
    torch.cuda.synchronize()
    graph = _graph_state(engine)
    graph['loss'] = losses
    graph['generator'] = engine.generator.get_state()
    g = engine._train_graph
    calls = (g.eager_steps, g.captures, g.replays)
    if calls != (1, 1, GRAPH_K - 1):
        checks.append('18a: eager, capture, replay calls {}'.format(calls))
    torch.backends.cudnn.deterministic = deterministic
    engine._train_graph = None
    counts, worst, bad = _graph_vs_eager(torch, graph, *eager)
    checks += ['18a ' + b for b in bad]
    leaves = [v for grp in summary.values() for v in grp.values()]
    if not all(tuple(v.shape) == (GRAPH_K,) for v in leaves):
        checks.append('18a: summary leaves are not [k]')

    # learning: one batch repeated through a graph of the step without
    # augmentation (fresh draws at 16 x 4 move the loss by more than 20
    # steps lower it, phase 6), then the graph of the recipe again
    one = {k: v[:1].expand(GRAPH_K, *v.shape[1:]).contiguous()
           for k, v in stacked.items()}
    transforms, engine.transforms = engine.transforms, ()
    engine._train_graph = None
    learn = torch.cat([engine.forward_backward_multi(one)[0]
                       for _ in range(GRAPH_LEARN_GROUPS)]).tolist()
    engine.transforms, engine._train_graph = transforms, None
    if not (all(np.isfinite(learn)) and np.mean(learn[-4:])
            < np.mean(learn[:4])):
        checks.append('18a: the graph steps do not learn: {}'.format(learn))
    engine.forward_backward_multi(stacked)      # eager step and capture

    # step ms: median of 3 groups of k, graph and eager, same batches
    def group_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / GRAPH_K
    graph_ms = [group_ms(lambda: engine.forward_backward_multi(stacked))
                for _ in range(3)]
    eager_ms = [group_ms(lambda: [engine.forward_backward(b)
                                  for b in batches]) for _ in range(3)]
    prof_graph = _host_launch_profile(
        torch, lambda: engine.forward_backward_multi(stacked), GRAPH_K)
    prof_eager = _host_launch_profile(
        torch, lambda: [engine.forward_backward(b) for b in batches[:3]], 3)
    out = {'calls_eager_capture_replay': calls,
           'cudnn_deterministic_in_comparison': True,
           'vs_eager': counts, 'worst_over_bound': worst,
           'loss_graph': graph['loss'].tolist(),
           'loss_eager': eager[0]['loss'].tolist(),
           'learning_losses': learn,
           'graph_step_ms_median': statistics.median(graph_ms),
           'eager_step_ms_median': statistics.median(eager_ms),
           'graph_step_ms': graph_ms, 'eager_step_ms': eager_ms,
           'graph_images_per_s': BATCH * 1e3 / statistics.median(graph_ms),
           'eager_images_per_s': BATCH * 1e3 / statistics.median(eager_ms),
           'profile_graph': prof_graph, 'profile_eager': prof_eager}
    log('18a', json.dumps({k: v for k, v in out.items()
                           if k not in ('learning_losses',)}))
    del engine, model, snap, eager, graph
    torch.cuda.empty_cache()
    return out


def _phase_graph_eval(torch, checks):
    """18b: grouped eval (8 batches a group, a trailing group of 2)
    through the eval graph against per-batch eval, float and int8, on
    the serving config (K2)."""
    from bpbreid_tpu_torch.data.augment import mask_chain_kwargs
    from bpbreid_tpu_torch.engine.part_based import ImagePartBasedEngine
    from bpbreid_tpu_torch.models import build_model
    cfg = serving_config()
    cfg.test.batches_per_dispatch = GRAPH_K
    model = build_model('bpbreid', 751, config=cfg, device='cuda', seed=SEED)
    engine = ImagePartBasedEngine.from_config(cfg, model,
                                              mask_chain_kwargs(cfg),
                                              device='cuda')
    rng = np.random.default_rng(SEED + 19)
    base = rng.integers(0, 256, size=(N_IDS, HEIGHT, WIDTH, 3))
    batches = make_batches(GRAPH_EVAL_BATCHES, rng, base, 0)
    for b in batches:
        b['valid'] = np.ones(BATCH, bool)
    batches[-1]['valid'][BATCH // 2:] = False      # a padded last batch
    out = {}
    for mode in ('float', 'int8'):
        cfg.test.int8 = mode == 'int8'
        engine.int8_quant_opts(batches)            # calibrates int8 once
        runs = {}
        for k in (GRAPH_K, 1, GRAPH_K):
            cfg.test.batches_per_dispatch = k
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = engine.feature_extraction(batches)
            torch.cuda.synchronize()
            runs.setdefault(k, []).append(
                (res, time.perf_counter() - t0))
        grouped, single = runs[GRAPH_K][-1][0], runs[1][0][0]
        equal = (torch.equal(grouped[0], single[0])
                 and torch.equal(grouped[1], single[1])
                 and grouped[4] == single[4])
        if not equal:
            checks.append('18b {}: grouped eval differs from per-batch: '
                          'features {}, visibility {}'.format(
                              mode, (grouped[0].float() - single[0].float())
                              .abs().max().item(),
                              (grouped[1] - single[1]).abs().max().item()))
        n = int(sum(b['valid'].sum() for b in batches))
        if grouped[0].shape[0] != n:
            checks.append('18b {}: {} rows for {} valid'.format(
                mode, grouped[0].shape[0], n))
        g = engine._eval_graph
        out[mode] = {'bit_equal': equal, 'images': n,
                     'grouped_images_per_s': n / runs[GRAPH_K][-1][1],
                     'per_batch_images_per_s': n / runs[1][0][1],
                     'first_grouped_s': runs[GRAPH_K][0][1],
                     'graph_calls': [g.eager_steps, g.captures, g.replays]}
    log('18b', json.dumps(out))
    del engine, model
    torch.cuda.empty_cache()
    return out


def _phase_bench_train(torch):
    """18c: tools/bench_train.py at its defaults, five timed loops."""
    from bpbreid_tpu_torch.tools import bench_train
    record = bench_train.main(['--iters', '5'])
    torch.cuda.empty_cache()
    return record


def phase_graphs(torch, results):
    """Phase 18 (see the module docstring). Returns the launch counts of
    18a and 18b."""
    from bpbreid_tpu_torch.ops.cuda.build import (launch_counts,
                                                  reset_launch_counts)
    t_phase = time.perf_counter()
    checks, out, part_s = [], {}, {}
    torch.cuda.synchronize()
    reset_launch_counts()
    for key, run in (('18a', _phase_graph_train),
                     ('18b', _phase_graph_eval)):
        t0 = time.perf_counter()
        out[key] = run(torch, checks)
        part_s[key] = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = dict(launch_counts)
    out['launches'] = launches
    t0 = time.perf_counter()
    out['18c'] = _phase_bench_train(torch)
    part_s['18c'] = time.perf_counter() - t0
    out['part_s'] = part_s
    out['phase_s'] = time.perf_counter() - t_phase
    results['graphs'] = out
    if checks:
        raise AssertionError('; '.join(checks))
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 1
    from bpbreid_tpu_torch.ops.cuda.build import build_kernels, library_path
    # f32 convolutions and matmuls in full f32 on the card
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_script = time.perf_counter()
    gpu = gpu_name_and_power_limit()
    log('gpu:', gpu, '| torch', torch.__version__, 'cuda', torch.version.cuda)
    results = {'gpu': gpu, 'torch': torch.__version__}

    t0 = time.perf_counter()
    build_logs = build_kernels()
    results['build_s'] = time.perf_counter() - t0
    log('phase 1: kernels built in {:.1f} s'.format(results['build_s']))
    os.makedirs('chiprun_out', exist_ok=True)
    with open('chiprun_out/chip_smoke_build.log', 'w') as f:
        for name, text in build_logs.items():
            f.write('== {}\n{}\n'.format(name, text))
    results['k1_sass_hmma'] = sass_count(library_path('conv_chain'), 'HMMA')
    log('K1 SASS: {} HMMA instructions'.format(results['k1_sass_hmma']))

    log('phase 2: kernels vs plain versions')
    k2_rows = phase_kernels(torch)
    results['k2'] = k2_rows
    k3_rows = phase_k3(torch)
    results['k3'] = k3_rows
    k1_rows = phase_k1(torch)
    results['k1'] = k1_rows
    log('phase 3: serving run')
    model, engine, query, gallery, feats, vis, mAP = phase_serving(torch,
                                                                   results)
    log('phase 3b: K1 on the serving model\'s branch chains')
    k1_launches = phase_k1_serving(torch, model, engine, query, results)
    log('phase 4: plain pooling and multires paths')
    phase_paths(torch, model, engine, query, feats, vis, mAP, results)
    log('phase 8a: serving evaluate, chunked vs host')
    phase_large_gallery_serving(torch, engine, query, gallery, results)
    log('phase 5: small f32 model, card vs CPU')
    phase_small_reference(torch, results)
    del model, engine, query, gallery, feats, vis
    torch.cuda.empty_cache()
    log('phase 6: train run')
    bn_shapes = phase_train(torch, results)
    log('phase 6b: K3 at the train step\'s BN inputs')
    phase_k3_step_shapes(torch, bn_shapes, results)
    log('phase 7: small f32 train step, card vs CPU')
    phase_small_train_reference(torch, results)
    log('phase 8b, 8c: Market-1501 and Market-1501 + 500k retrieval')
    ranking_inputs = phase_large_gallery(torch, results)
    log('phase 9: the train/test CLI (scripts/main.py)')
    cli_launches, k2_cli_launches = phase_cli(torch, results)
    log('phase 10: the inference path (torchreid weights, '
        'FeatureExtractor, --inference-enabled, rerank, save_features)')
    inference_launches = phase_inference(torch, results)
    log('phase 11: PCB config through the CLI, BoT, amsgrad / rmsprop / '
        'radam, the dropout dim-reduce')
    pcb_launches, bot_launches = phase_pcb(torch, results)
    log('phase 12: calibrated int8 eval (conv_s8, quantize_s8)')
    int8_launches = phase_int8(torch, results)
    log('phase 13: the softmax and triplet engines (OSNet, ResNet50-IBN-a) '
        'and BPBReID on the fastreid IBN + non-local trunk')
    global_launches = phase_global(torch, results)
    log('phase 14: the video path, the occluded BPBReID options '
        '(background-channel masks, ro), before_and_after_pooling, CUHK03')
    video_launches = phase_video_and_options(torch, results)
    log('phase 15: the rest of the model zoo (PCB, PVPM, the legacy '
        'Torchreid zoo, HACNN)')
    zoo_launches = phase_zoo(torch, results)
    log('phase 16: the debug and test figures, the native ranker, '
        'reproduce, model complexity, the profile summary, the HPO search')
    figures_launches = phase_figures_and_tools(torch, results,
                                               ranking_inputs)
    del ranking_inputs
    log('phase 17: data parallelism (parallel/): bn_apply_sums and bn_dx '
        'with a count, NCCL at world size 1, 2 gloo ranks on the card')
    dp_launches = phase_data_parallel(torch, results, bn_shapes)
    log('phase 18: grouped dispatch through CUDA graphs '
        '(forward_backward_multi, grouped eval, tools/bench_train.py)')
    graph_launches = phase_graphs(torch, results)
    # the launches of phases 10, 11, 13, 14, 15, 16 and 17b (each its own
    # path, counted from 0)
    path_launches = {}
    for counts in (inference_launches, pcb_launches, bot_launches,
                   global_launches, video_launches, zoo_launches,
                   figures_launches, dp_launches, graph_launches):
        for k, v in counts.items():
            path_launches[k] = path_launches.get(k, 0) + v

    # the main path's shape at bf16, the dtype every model hands K2; the
    # f32 row beside it
    main_row, f32_row = k2_rows[1], k2_rows[0]
    kernels = [{
        'name': 'attention_pool', 'route': 'cuda',
        'source': 'bpbreid_tpu_torch/ops/cuda/attention_pool.cu',
        'replaces': 'bpbreid_tpu/ops/pallas/pooling.py:47',
        'launches': k2_cli_launches.get('attention_pool', 0)
                    + path_launches.get('attention_pool', 0),
        'max_abs_err': max(r['max_abs_err'] for r in k2_rows),
        'ms': main_row['ms'], 'plain_ms': main_row['plain_ms'],
        'bound_ms': main_row['bound_ms'], 'bound_by': main_row['bound_by'],
        'library_ms': main_row['library_ms'],
        'device_ms': main_row['device_ms'],
        'library_device_ms': main_row['library_device_ms'],
        'dtype': main_row['dtype'],
        'f32': {k: f32_row[k] for k in ('ms', 'device_ms', 'bound_ms',
                                        'library_ms', 'library_device_ms')},
    }]
    k3_row = next(r for r in k3_rows
                  if (tuple(r['shape']), r['dtype']) == K3_REPORT)
    for name in BN_KERNELS:
        kernels.append({
            'name': name, 'route': 'cuda', 'source': K3_SOURCE,
            'replaces': K3_REPLACES[name],
            'launches': cli_launches.get(name, 0)
                        + path_launches.get(name, 0),
            'max_abs_err': k3_row[name + '_max_abs_err'],
            'ms': k3_row[name + '_ms'], 'plain_ms': k3_row[name + '_plain_ms'],
            'bound_ms': k3_row[name + '_bound_ms'],
            'bound_by': k3_row[name + '_bound_by'],
            'library_ms': k3_row[name + '_library_ms'],
            'device_ms': k3_row[name + '_device_ms'],
            'library_device_ms': k3_row[name + '_library_device_ms']})
    dp = results['data_parallel']
    fin = dp['17a']['timed']
    # no one PyTorch call finalizes sums and normalizes: SyncBatchNorm's
    # two calls stand beside it
    kernels.append({
        'name': 'bn_apply_sums', 'route': 'cuda', 'source': K3_SOURCE,
        'replaces': BN_APPLY_SUMS_REPLACES,
        'launches': dp_launches.get('bn_apply_sums', 0),
        'max_abs_err': dp['17a']['bn_apply_sums_worst_err'],
        'stats_max_abs_err': dp['17a']['bn_apply_sums_stats_worst_err'],
        'ms': fin['bn_apply_sums_ms'],
        'plain_ms': fin['bn_apply_sums_plain_ms'],
        'bound_ms': fin['bn_apply_sums_bound_ms'],
        'bound_by': fin['bn_apply_sums_bound_by'],
        'library_ms': None,
        'device_ms': fin['bn_apply_sums_device_ms'],
        'bn_apply_ms': fin['bn_apply_ms'],
        'bn_apply_device_ms': fin['bn_apply_device_ms'],
        'library_two_calls_ms': fin['library_two_calls_ms'],
        'library_two_calls_device_ms': fin['library_two_calls_device_ms']})
    k1_row = next(r for r in k1_rows
                  if (tuple(r['shape']), r['dtype']) == K1_REPORT)
    kernels.append({
        'name': 'conv_chain', 'route': 'cuda', 'source': K1_SOURCE,
        'replaces': K1_REPLACES, 'launches': k1_launches,
        'max_abs_err': k1_row['max_abs_err'], 'ms': k1_row['ms'],
        'plain_ms': k1_row['plain_ms'], 'bound_ms': k1_row['bound_ms'],
        'bound_by': k1_row['bound_by'], 'library_ms': k1_row['library_ms'],
        'device_ms': k1_row['device_ms'],
        'library_device_ms': k1_row['library_device_ms']})
    for name in ('conv_s8', 'quantize_s8'):
        row = results['int8']['kernels'][name]
        kernels.append({
            'name': name, 'route': 'cuda', 'source': INT8_SOURCE,
            'replaces': INT8_REPLACES[name],
            'launches': int8_launches.get(name, 0),
            'max_abs_err': row['max_abs_err'], 'ms': row['ms'],
            'plain_ms': row['plain_ms'], 'bound_ms': row['bound_ms'],
            'bound_by': row['bound_by'], 'library_ms': row['library_ms'],
            'device_ms': row['device_ms'],
            'library_device_ms': row['library_device_ms']})
    results['kernels'] = kernels
    results['script_s'] = time.perf_counter() - t_script
    unlaunched = [k['name'] for k in kernels if not k['launches']]
    if unlaunched:
        raise AssertionError('no launch on the path: {}'.format(unlaunched))
    with open('chiprun_out/chip_smoke.json', 'w') as f:
        json.dump(results, f, indent=1)
    s, t = results['serving'], results['train']
    log(gpu)
    log('script: {:.1f} s, kernels built in {:.1f} s'.format(
        results['script_s'], results['build_s']))
    log('throughput: {:.1f} images/s forward (batch {}, bf16), retrieval '
        '{:.3f} s for {} images; train step {:.1f} ms ({:.1f} images/s), '
        'on {}'.format(s['forward_images_per_s'], BATCH, s['retrieval_s'],
                       s['retrieval_images'], t['step_ms_median'],
                       t['images_per_s'], gpu))
    a, d = results['cli']['9a'], results['cli']['9d']
    log('cli', json.dumps({
        'steps': a['steps'], 'step_ms_median': a['step_ms_median'],
        'data_time_ms': a['data_time_ms'], 'images_per_s': a['images_per_s'],
        'phase6_step_ms_median': a['phase6_step_ms_median'],
        'cli_over_phase6_step': a['cli_over_phase6_step'],
        'mAP': a['mAP'], 'rank1': a['rank1'],
        'visrank_figures': a['visrank_figures'], 'visrank_s': a['visrank_s'],
        'checkpoint_mb': a['checkpoint_mb'],
        'checkpoint_write_s': a['checkpoint_write_s'],
        'checkpoint_read_s': a['checkpoint_read_s'],
        'wall_s': {k: v['wall_s'] for k, v in results['cli'].items()
                   if k != 'phase_s'},
        'phase_s': results['cli']['phase_s'],
        'resnet50_step_ms_median': d['step_ms_median'], 'gpu': gpu}))
    inf = results['inference']
    log('inference', json.dumps({
        'torchreid_file_matched': inf['10a']['matched'],
        'torchreid_file_discarded': len(inf['10a']['discarded']),
        'test_rank1': inf['10a']['rank1'], 'test_mAP': inf['10a']['mAP'],
        'imagenet_matched': inf['10a']['imagenet_matched'],
        'feature_extractor_images_per_s':
            inf['10b']['mixed_arrays_images_per_s'],
        'feature_extractor_resized_images_per_s':
            inf['10b']['resized_batch_images_per_s'],
        'phase3_forward_images_per_s':
            inf['10b']['phase3_forward_images_per_s'],
        'inference_enabled_extract_s': inf['10c']['extract_s'],
        'inference_enabled_images': inf['10c']['images'],
        'rerank_s': inf['10d']['engine_rerank_s'],
        'rerank_rank1': inf['10d']['rank1'], 'rerank_mAP': inf['10d']['mAP'],
        'launches': inf['launches'], 'phase_s': inf['phase_s'],
        'gpu': gpu}))
    p = results['pcb']
    log('pcb', json.dumps({
        'steps': p['11a']['steps'], 'step_ms_median': p['11a']['step_ms_median'],
        'images_per_s': p['11a']['images_per_s'], 'mAP': p['11a']['mAP'],
        'rank1': p['11a']['rank1'],
        'bn_launches_per_step': p['11a']['bn_launches_per_step'],
        'attention_pool_launches':
            p['11a']['launches'].get('attention_pool', 0),
        'visrank_figures': p['11a']['visrank_figures'],
        'visrank_s': p['11a']['visrank_s'],
        'visrank_bn_apply': p['11a']['visrank_bn_apply'],
        'bot_train_launches': p['11b']['train_launches'],
        'bot_eval_launches': p['11b']['eval_launches'],
        'optimizers': {k: {'update_rel_err_beyond_ulp':
                           v['update_rel_err_beyond_ulp'],
                           'step_device_kernel_launches':
                           v['step_device_kernel_launches'],
                           'first_loss': v['losses'][0],
                           'last_loss': v['losses'][-1]}
                       for k, v in p['11c'].items()},
        'dropout_kept_share': p['11d']['kept_share'],
        'phase_s': p['phase_s'], 'gpu': gpu}))
    q = results['int8']
    log('int8', json.dumps({
        'conv_s8_per_step': q['launches_per_step'].get('conv_s8', 0),
        'predicted_conv_s8': q['predicted_conv_s8'],
        'quantize_s8_per_step': q['launches_per_step'].get('quantize_s8', 0),
        'bn_apply_per_step': q['launches_per_step'].get('bn_apply', 0),
        'cudnn_convs_per_step': q['cudnn_convs_per_step'],
        'calibration_s': q['calibration_s'],
        'eval_step_ms': q['eval_step_ms'], 'images_per_s': q['images_per_s'],
        'peak_memory_gb': q['peak_memory_gb'],
        'bn_foreg_cosine_min': q['bn_foreg_cosine_min'],
        'bn_foreg_cosine_mean': q['bn_foreg_cosine_mean'],
        'parts_visibility_agreement': q['parts_visibility_agreement'],
        'card_vs_cpu': q['card_vs_cpu'],
        'cli': {k: {'mAP': v['mAP'], 'rank1': v['rank1']}
                for k, v in q['cli'].items()},
        'int_mm': q['kernels']['int_mm'],
        'per_step': {k: q['per_shape'][k + '_sums']
                     for k in ('conv_s8', 'quantize_s8')},
        'phase_s': q['phase_s'],
        'gpu': gpu}))
    g = results['global']
    log('global', json.dumps({
        **{k: {'model': g[k]['model'], 'loss': g[k]['loss'],
               'steps': g[k]['steps'],
               'step_ms_median': g[k]['step_ms_median'],
               'images_per_s': g[k]['images_per_s'],
               'fastbatchnorm_modules': g[k]['fastbatchnorm_modules'],
               'bn_launches_per_step': g[k]['bn_launches_per_step'],
               'eval_bn_apply_per_batch': g[k]['eval_bn_apply_per_batch'],
               'mAP': g[k]['mAP'], 'rank1': g[k]['rank1'],
               'learning_first_last': [g[k]['learning_losses'][0],
                                       g[k]['learning_losses'][-1]],
               'card_vs_cpu': g[k]['card_vs_cpu'],
               'busy_share': g[k]['profile']['busy_share'],
               'device_busy_ms': g[k]['profile']['device_busy_ms'],
               'depthwise': g[k]['depthwise'],
               'depthwise_kernels_device_ms':
                   g[k]['profile']['symbol_device_ms']}
           for k in ('13a', '13b')},
        '13c': {'k2_ms': g['13c']['k2']['ms'],
                'k2_plain_ms': g['13c']['k2']['plain_ms'],
                'k2_library_ms': g['13c']['k2']['library_ms'],
                'k2_bound_ms': g['13c']['k2']['bound_ms'],
                'k2_max_abs_err': g['13c']['k2']['max_abs_err'],
                'eval_launches': g['13c']['eval_launches'],
                'train_launches': g['13c']['train_launches'],
                'ibn_copies_train': g['13c']['ibn_copies_train']},
        '13d': {k: g['13d_' + k]['summary'] for k in ('osnet', 'ibn')},
        'phase_s': g['phase_s'], 'gpu': gpu}))
    v = results['video']

    def worst(k3):
        # the largest error of each BN kernel over a path's BN inputs
        return {key: max(r[key] for r in k3['rows'])
                for key in k3['rows'][0] if key.endswith('max_abs_err')}
    log('video', json.dumps({
        '14a': {k: v['14a'][k] for k in (
            'model', 'steps', 'frames_per_step', 'step_ms_median',
            'frames_per_s', 'fastbatchnorm_modules', 'bn_launches_per_step',
            'eval_bn_apply_per_batch', 'busy_share', 'device_busy_ms',
            'mAP', 'rank1', 'card_vs_cpu')},
        '14a_learning_first_last': [v['14a']['learning_losses'][0],
                                    v['14a']['learning_losses'][-1]],
        '14a_triplet': {k: v['14a']['triplet'][k] for k in (
            'steps', 'bn_launches_per_step', 'fastbatchnorm_modules')},
        '14a_k3_worst_err': {k: worst(v['14a']['k3'][k])
                             for k in ('softmax', 'triplet')},
        '14b': {k: v['14b'][k] for k in (
            'steps', 'mask_channels_on_disk', 'mask_channels_after_chain',
            'bn_launches_per_step',
            'bn_want_per_step', 'ro_host_ms_per_batch', 'k2_per_test_batch',
            'k2_test_bn_apply_per_batch', 'mAP', 'rank1')},
        '14c': {k: v['14c'][k] for k in (
            'before_pooling_conv', 'embedding_rel_err',
            'train_card_vs_cpu')},
        '14d': {k: v['14d'][k] for k in ('query_gallery', 'mAP', 'rank1',
                                         'launches')},
        '14d_k3_worst_err': worst(v['14d']['k3']),
        'phase_s': v['phase_s'], 'gpu': gpu}))
    z = results['zoo']
    log('zoo', json.dumps({
        '15a': {'models': len(z['15a']),
                'eval_ms': {r['name']: round(r['ms'], 3) for r in z['15a']},
                'bn_apply': sum(r['launches'].get('bn_apply', 0)
                                for r in z['15a']),
                'build_s': sum(r['build_s'] for r in z['15a']),
                'phase_s': z['15a_s']},
        **{k: {key: z[k][key] for key in (
            'model', 'loss', 'steps', 'step_ms_median', 'images_per_s',
            'fastbatchnorm_modules', 'bn_calls_per_step',
            'bn_launches_per_step', 'eval_bn_apply_per_batch', 'mAP',
            'rank1', 'card_vs_cpu')} for k in ('15b_pcb', '15b_hacnn')},
        '15b_learning_first_last': {
            k: [z[k]['learning_losses'][0], z[k]['learning_losses'][-1]]
            for k in ('15b_pcb', '15b_hacnn')},
        '15b_busy_share': {k: z[k]['profile']['busy_share']
                           for k in ('15b_pcb', '15b_hacnn')},
        '15c': {r['name']: r['launches'] for r in z['15c']},
        '15c_bpbreid': {
            'backbone': z['15c_bpbreid'].get('backbone'),
            'k2': {key: z['15c_bpbreid'].get('k2', {}).get(key) for key in (
                'shape', 'ms', 'plain_ms', 'library_ms', 'bound_ms',
                'max_abs_err')},
            'eval_launches': z['15c_bpbreid'].get('eval_launches'),
            'train_launches': z['15c_bpbreid'].get('train_launches')},
        '15d': z['15d'],
        'seconds': {k: z[k + '_s'] for k in ('15a', '15b', '15c', '15d')},
        'phase_s': z['phase_s'], 'gpu': gpu}))
    fg = results['figures']
    log('figures', json.dumps({
        '16a': {k: fg['16a'][k] for k in (
            'steps', 'step_ms_median', 'debug_forward_ms',
            'debug_forward_launches', 'bn_launches_per_step',
            'eval_bn_apply', 'figures', 'mAP', 'rank1', 'wall_s')},
        '16a_k2': {k: fg['16a_k2'][k] for k in (
            'test_launches', 'debug_forward_ms', 'debug_forward_launches')},
        '16b': fg['16b'],
        '16c': {k: fg['16c'][k] for k in (
            'exit_code', 'delta_mAP', 'delta_rank1', 'seconds')},
        '16d': {'params': fg['16d']['params'], 'flops': fg['16d']['flops'],
                'profile_summary_ms': fg['16d']['profile']['summary_ms'],
                'profiler_cuda_ms': fg['16d']['profile']['profiler_cuda_ms'],
                'profile_rel_diff': fg['16d']['profile']['rel_diff'],
                'categories_ms': fg['16d']['profile']['categories_ms'],
                'hpo_rank1': fg['16d']['hpo_rank1'],
                'hpo_s': fg['16d']['hpo_s']},
        'seconds': {k: fg[k + '_s'] for k in ('16a', '16b', '16d')},
        'phase_s': fg['phase_s'], 'gpu': gpu}))
    c, dd = dp['17c'], dp['17d']['ranks']
    log('dp', json.dumps({
        '17a': {k: dp['17a'][k] for k in ('bn_apply_sums_worst_err',
                                          'bn_apply_sums_stats_worst_err',
                                          'bn_dx_count_worst_err')},
        '17a_shapes': len(dp['17a']['rows']),
        '17a_timed': {k: v for k, v in fin.items() if k.endswith(
            ('_ms', '_bound_by'))},
        '17b': {k: dp['17b'][k] for k in (
            'backend', 'losses_world1', 'losses_one_process', 'bit_equal',
            'state_max_abs_diff', 'step1_vs_one_process', 'collectives',
            'step_ms_one_process', 'step_ms_world1',
            'profiled_step_one_process', 'profiled_step_world1')},
        '17b_launches_per_step': {k: v / dp['17b']['steps']
                                  for k, v in dp['17b']['launches'].items()},
        '17c': {k: c[k] for k in (
            'loss_ranks', 'loss_one_process', 'loss_rel_diff',
            'digests_equal', 'step_ms_median', 'launches_per_step',
            'collectives_per_step', 'bn_modules', 'bn_without_backward',
            'small_f32_vs_one_process', 'spawn_s')},
        '17c_learning_first_last': [c['learning_losses'][0],
                                    c['learning_losses'][-1]],
        '17d': {k: [r[k] for r in dd] for k in (
            'distance_rel_err', 'part_distance_rel_err', 'cmc_err',
            'map_err', 'engine_cmc_err', 'engine_map_err', 'distance_s',
            'cmc_s', 'engine_evaluate_s')},
        '17d_gallery': [dd[0]['gallery'], dd[0]['padded_gallery']],
        '17d_mAP_rank1': [dd[0]['mAP'], dd[0]['rank1']],
        'phase_s': dp['phase_s'], 'gpu': gpu}))
    gr = results['graphs']
    log('graphs', json.dumps({
        '18a': {k: gr['18a'][k] for k in (
            'calls_eager_capture_replay', 'vs_eager', 'worst_over_bound',
            'graph_step_ms_median', 'eager_step_ms_median',
            'graph_images_per_s', 'eager_images_per_s')},
        '18a_learning_first_last': [gr['18a']['learning_losses'][0],
                                    gr['18a']['learning_losses'][-1]],
        '18a_profile': {run: {k: gr['18a'][run][k] for k in (
            'device_kernels_per_step', 'kernel_launch_calls_per_step',
            'graph_launches_per_step', 'busy_share')}
            for run in ('profile_graph', 'profile_eager')},
        '18b': gr['18b'], '18c': gr['18c'], 'launches': gr['launches'],
        'part_s': gr['part_s'], 'phase_s': gr['phase_s'], 'gpu': gpu}))
    log(json.dumps({'kernels': kernels}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
