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
   main-path shapes and at ragged shapes, with timings (CUDA events);
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
   (a) two epochs and the final test with a checkpoint: every step
   launches the BN kernels phase 6 counts (and as many as forward hooks
   count train-mode BNs), the eval batches one bn_apply per eval-mode BN;
   the first prefetched batch equals the loader's host batch bit for bit
   and the first loss equals ``forward_backward`` on it (1e-5 relative);
   (b) a test-only run from (a)'s checkpoint gives (a)'s CMC and mAP
   (1e-6); (c) a test-only run through K2 (fused pooling, multires off)
   launches it once per eval batch and no train-mode BN kernel; (d) one
   epoch and the final test on a ResNet-50 backbone, finite losses and
   the BN launches of its train-mode BNs.

Any failed check exits non-zero and prints no result. On success the
last lines are the GPU's name and power limit (nvidia-smi), the
throughput line, the CLI line (phase 9), the kernels line (launches: the
BN kernels' in run 9a, K2's in run 9c, K1's in phase 3b) and the result
line
``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``. Needs one CUDA card.
"""
import json
import os
import re
import statistics
import subprocess
import sys
import time

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
    from bpbreid_tpu_torch.ops.cuda.pooling import (attention_pool_reference,
                                                    fused_attention_pool)
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    # (N, D, H, W, K+1, feature dtype); logits are bf16 as on the path
    shapes = [(BATCH, 1920, 96, 32, 6, torch.float32),
              (BATCH, 1920, 96, 32, 6, torch.bfloat16),
              (2, 40, 7, 1, 3, torch.float32),
              (3, 100, 96, 32, 37, torch.bfloat16),
              (2, 1920, 7, 1, 6, torch.bfloat16),
              (4, 40, 96, 32, 37, torch.float32),
              (1, 100, 13, 11, 64, torch.float32)]
    # f32 sums over up to 3072 pixels in another order than the plain
    # version: tolerance relative to the largest output magnitude
    rtol = 2e-5
    rows, failures = [], []
    for n, d, h, w, k1, dt in shapes:
        feats = torch.randn(n, d, h, w, device='cuda', generator=gen).to(dt)
        logits = (3 * torch.randn(n, k1, h, w, device='cuda',
                                  generator=gen)).to(torch.bfloat16)
        got = fused_attention_pool(feats, logits)
        torch.cuda.synchronize()
        want = attention_pool_reference(feats, logits)
        errs = []
        for name, a, b in zip(('num', 'den', 'vismax'), got, want):
            err = (a - b).abs().max().item()
            tol = rtol * b.abs().max().item() + 1e-6
            errs.append(err)
            if not (err <= tol) or not torch.isfinite(a).all():
                failures.append('K2 {} at {}: err {} > tol {}'.format(
                    name, (n, d, h, w, k1, str(dt)), err, tol))
        row = {'shape': [n, d, h, w, k1], 'dtype': str(dt),
               'max_abs_err': max(errs), 'errs': errs}
        if (h * w, d) == (96 * 32, 1920):
            row['ms'] = time_ms(lambda: fused_attention_pool(feats, logits),
                                torch)
            row['plain_ms'] = time_ms(
                lambda: attention_pool_reference(feats, logits), torch)
            row['library_ms'] = time_ms(
                lambda: attention_pool_library(feats, logits), torch)
            row['bound_ms'], row['bound_by'] = attention_pool_bound_ms(
                feats, logits)
        log('K2', json.dumps(row))
        rows.append(row)
        del feats, logits, got, want
    if failures:
        raise AssertionError('\n'.join(failures))
    return rows


def _nc(x, cd):
    """``x`` in the ``[N, C, ...]`` layout that torch's batch-norm calls
    read (feature-last ``[..., C]`` as ``[M, C]``)."""
    return x if cd == 1 else x.view(-1, x.shape[-1])


def _bn_operands(torch, x, dy, cd, gen):
    """Weight, bias and running statistics for one BN input, and the
    statistics and backward sums that the later kernels read, from the
    kernels themselves."""
    from bpbreid_tpu_torch.ops.cuda.batchnorm import (bn_grad_stats,
                                                      bn_stats, channel_view)
    a, c, b = channel_view(x.shape, cd)
    o = {'a': a, 'c': c, 'b': b,
         'w': 1 + 0.2 * torch.randn(c, device='cuda', generator=gen),
         'bias': 0.3 * torch.randn(c, device='cuda', generator=gen),
         'rm': 0.1 * torch.randn(c, device='cuda', generator=gen),
         'rv': 0.5 + torch.rand(c, device='cuda', generator=gen)}
    o['st'] = bn_stats(x, o['w'], 1e-5, cd, sums=True)
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


def _time_bn_calls(torch, calls, plain=True, iters=5):
    """``{kernel}_ms``, ``_plain_ms``, ``_library_ms``, ``_bound_ms`` and
    ``_bound_by`` of each BN kernel (CUDA events). ``_library_ms`` is null
    where torch's call refuses the operands' types."""
    t = lambda fn: time_ms(fn, torch, warmup=2, iters=iters,  # noqa: E731
                           repeats=3)
    row = {}
    for name, (kernel, ref, lib, nbytes, flops) in calls.items():
        row[name + '_ms'] = t(kernel)
        if plain:
            row[name + '_plain_ms'] = t(ref)
        try:
            row[name + '_library_ms'] = t(lib)
        except RuntimeError as e:
            row[name + '_library_ms'] = None
            row[name + '_library_error'] = str(e).splitlines()[0][:200]
        row[name + '_bound_ms'], row[name + '_bound_by'] = _k3_bound_ms(
            nbytes, flops)
    return row


def graph_ms(torch, fn, calls=20):
    """Device time per call of ``fn``, from a CUDA graph of ``calls``
    calls: launches back to back, no host time between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_ms(graph.replay, torch, warmup=1, iters=3, repeats=3) / calls


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
    m = a * b
    st, (sum_dy, sum_dy_xhat) = o['st'], o['g']
    mean, _, rstd, scale = st[:4]
    x3, dy3 = x.reshape(a, c, b).float(), dy.reshape(a, c, b).float()
    errs, failed = {}, []
    err, ok = _k3_errors(torch, st[4:], bn_stats_reference(
        x, w, 1e-5, cd, sums=True)[4:], (x3.abs().sum((0, 2)),
                                         (x3 * x3).sum((0, 2))))
    rm_k, rv_k, rm_p, rv_p = (v.clone() for v in (o['rm'], o['rv'],
                                                  o['rm'], o['rv']))
    again = bn_stats(x, w, 1e-5, cd, rm_k, rv_k, sums=True)
    want = bn_finalize_reference(st[4], st[5], m, w, 1e-5, rm_p, rv_p)
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
            row.update(_time_bn_calls(torch, _bn_calls(torch, x, dy, cd, o)))
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


def profile_steps(torch, step, steps=3):
    """Device time by kernel over ``steps`` calls of ``step``
    (torch.profiler): the device's busy share of the host-clock window
    and the kernels that take the most time. Kernels run on one stream,
    so their summed durations are the busy time."""
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
                        chunk=1 << 16):
    """``[len(pids), K, D]`` f32 features, L2-normalized per part: the
    identity's center plus Gaussian noise; pids without a center (>=
    len(centers)) are noise alone. Made on the card, in chunks."""
    n = len(pids)
    k, d = centers.shape[1:]
    out = torch.empty((n, k, d), device='cuda')
    for s in range(0, n, chunk):
        p = pids[s:s + chunk]
        f = noise * torch.randn((len(p), k, d), device='cuda', generator=gen)
        has = p < len(centers)
        f[has] += centers[p[has]]
        out[s:s + chunk] = f / f.norm(dim=-1, keepdim=True)
        del f
    return out


def _synthetic_split(torch, gen, pids, centers):
    """(features, visibility [N, K] f32 with about 20 % of the part
    streams invisible, pids, camids) of one split."""
    feats = _synthetic_features(torch, gen, pids, centers)
    vis = torch.rand((len(pids), centers.shape[1]), device='cuda',
                     generator=gen) > 0.2
    vis[:, 0] = True                     # the foreground stream
    camids = torch.randint(0, 6, (len(pids),), device='cuda', generator=gen)
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


def make_train_batch(rng, n_ids, n_inst, height, width, device):
    """Identity x instance batch: a template per identity plus noise,
    confidence fields at 1/8 of the image grid."""
    import torch
    pids = np.repeat(np.arange(n_ids), n_inst)
    base = rng.integers(0, 256, size=(n_ids, height, width, 3))
    noise = rng.integers(-20, 21, size=(len(pids), height, width, 3))
    imgs = np.clip(base[pids] + noise, 0, 255).astype(np.uint8)
    masks = rng.uniform(size=(len(pids), height // 8, width // 8, 36)) \
        .astype(np.float32)
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


def phase_k3_step_shapes(torch, shapes, results):
    """The BN kernels at each distinct BN input of the train step (the
    shapes that phase 6's forward hooks recorded), with their launches a
    step: times (CUDA events over back-to-back calls, which at the small
    shapes is the host's rate; and the device time from a CUDA graph)
    against their bounds and library calls, and the whole BN against
    ``F.batch_norm``. Per step: launches x ms, launches x bound
    and launches x (ms - bound), for K3 (bn_stats, bn_grad_stats) and for
    all four kernels."""
    gen = torch.Generator(device='cuda').manual_seed(SEED + 6)
    rows = []
    for (shape, dt, cd), (n_fwd, n_bwd) in shapes:
        x = (0.5 + torch.randn(shape, device='cuda', generator=gen)).to(dt)
        dy = torch.randn(shape, device='cuda', generator=gen).to(dt)
        o = _bn_operands(torch, x, dy, cd, gen)
        row = {'shape': list(shape), 'dtype': str(dt), 'channel_dim': cd,
               'view': [o['a'], o['c'], o['b']], 'fwd_launches': n_fwd,
               'bwd_launches': n_bwd}
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
    results['k3_step_shapes'] = {'rows': rows, 'summary': summary}


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
    card, cpu = out['cuda'], out['cpu']
    checks = []
    loss_rel = abs(card['loss'] - cpu['loss']) / abs(cpu['loss'])
    if not loss_rel <= 1e-5:
        checks.append('loss {} vs {}'.format(card['loss'], cpu['loss']))
    num = den = 0.0
    worst_grad = 0.0
    for k, g in cpu['grads'].items():
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
    small = {'loss_card': card['loss'], 'loss_cpu': cpu['loss'],
             'grad_rel_l2': grad_rel_l2, 'grad_worst_tensor': worst_grad,
             'bn_stats_worst': worst_bn, 'param_worst': worst_param}
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


def register_cli_dataset():
    """A ``SyntheticDataset`` with the counts and crop size above, in the
    port's registry (the dataset's own constructor arguments)."""
    from bpbreid_tpu_torch.data.datasets import (get_image_dataset,
                                                 register_image_dataset)
    from bpbreid_tpu_torch.data.datasets.image_datasets import \
        SyntheticDataset

    class SmokeMarketCrops(SyntheticDataset):
        dataset_dir = CLI_DATASET

        def __init__(self, **kwargs):
            super().__init__(num_pids=CLI_IDS, num_cams=CLI_CAMS,
                             imgs_per_pid_cam=CLI_IMGS, height=CLI_SRC_HW[0],
                             width=CLI_SRC_HW[1], seed=SEED, **kwargs)
    try:
        get_image_dataset(CLI_DATASET)
    except ValueError:
        register_image_dataset(CLI_DATASET, SmokeMarketCrops)


def cli_argv(job_id, *opts):
    """The CLI's argv: the Market-1501 train config (HRNet-W32, 384x128,
    five_v, bf16, batch 64) on the smoke dataset, without visrank."""
    return (['--config-file', CLI_CONFIG, '--save_dir', CLI_SAVE_DIR,
             '--job-id', str(job_id),
             'data.sources', "['{}']".format(CLI_DATASET),
             'data.targets', "['{}']".format(CLI_DATASET),
             'test.visrank', 'False', 'train.eval_freq', '-1']
            + list(opts))


class CliRecorder:
    """Wraps ``ImagePartBasedEngine.forward_backward`` and ``save_model``
    for one CLI run: each step's host entry time, loss tensor and BN
    launches, the train-mode FastBatchNorm calls of each step (forward
    hooks, set on the first step), the first batch as the prefetch put
    it on the card, and the checkpoint's path and write seconds. Reads
    nothing back from the card during the steps."""

    def __init__(self, torch):
        from bpbreid_tpu_torch.engine.part_based import ImagePartBasedEngine
        self.torch, self.cls = torch, ImagePartBasedEngine
        self.fb = ImagePartBasedEngine.forward_backward
        self.save = ImagePartBasedEngine.save_model
        self.entries, self.losses, self.launches = [], [], []
        self.bn_calls = {'train': 0, 'eval': 0}
        self.train_bn_calls = []
        self.first_batch = self.checkpoint = self.save_s = None

    def _hook(self, mod, inp):
        self.bn_calls['train' if mod.training else 'eval'] += 1

    def __enter__(self):
        from bpbreid_tpu_torch.models.common import FastBatchNorm
        from bpbreid_tpu_torch.ops.cuda.build import launch_counts
        rec = self

        def forward_backward(engine, batch, draws=None):
            if rec.first_batch is None:
                for m in engine.model.modules():
                    if isinstance(m, FastBatchNorm):
                        m.register_forward_pre_hook(rec._hook)
                rec.first_batch = {k: batch[k].cpu().clone()
                                   for k in ('image', 'mask', 'pid')}
            rec.entries.append(time.perf_counter())
            before = dict(launch_counts)
            calls = rec.bn_calls['train']
            loss, summary = rec.fb(engine, batch, draws)
            rec.launches.append({k: launch_counts[k] - before.get(k, 0)
                                 for k in BN_KERNELS})
            rec.train_bn_calls.append(rec.bn_calls['train'] - calls)
            rec.losses.append(loss)
            return loss, summary

        def save_model(engine, *args, **kwargs):
            rec.torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = rec.save(engine, *args, **kwargs)
            if path is not None:
                rec.checkpoint, rec.save_s = path, time.perf_counter() - t0
            return path

        self.cls.forward_backward = forward_backward
        self.cls.save_model = save_model
        return self

    def __exit__(self, *exc):
        self.cls.forward_backward, self.cls.save_model = self.fb, self.save
        return False


def drive_cli(torch, what, argv):
    """``scripts.main.main(argv)`` with every launch count set to 0 just
    before and read just after. Returns the engine, ``(cmc, mAP, ssmd,
    pixel accuracy)``, the counts, the recorder and the wall seconds."""
    from bpbreid_tpu_torch.data.datasets import clear_dataset_cache
    from bpbreid_tpu_torch.ops.cuda.build import (launch_counts,
                                                  reset_launch_counts)
    from bpbreid_tpu_torch.scripts.main import main as cli_main
    clear_dataset_cache()
    with CliRecorder(torch) as rec:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        engine, result = cli_main(argv)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = {k: v for k, v in launch_counts.items()}
    log('  {}: {:.1f} s, launches {}'.format(what, wall_s, counts))
    return engine, result, counts, rec, wall_s


def _bn_split(model):
    """Phase 6's split of a model's FastBatchNorms: those that run the
    BN kernels in train mode (all but the pixel classifier's, whose
    statistics are plain ops) and those of them whose stream feeds no
    loss (no backward)."""
    from bpbreid_tpu_torch.models.common import FastBatchNorm
    bn = [n for n, mod in model.named_modules()
          if isinstance(mod, FastBatchNorm) and n != 'pixel_classifier.bn']
    no_grad = [n for n in bn if n.startswith((
        'background_after_pooling_dim_reduce',
        'background_identity_classifier', 'parts_identity_classifier'))]
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
    bn, no_grad = _bn_split(engine.model)
    want, bad = _step_launch_checks(rec, bn, no_grad, '9a')
    checks += bad
    if want != {k: phase6['bn_launches_per_step'][k] for k in BN_KERNELS}:
        checks.append('9a: BN launches a step {} differ from phase 6 {}'
                      .format(want, phase6['bn_launches_per_step']))
    steps = len(losses)
    eval_apply = counts_a.get('bn_apply', 0) - steps * want['bn_apply']
    if steps != CLI_EPOCHS * steps_per_epoch:
        checks.append('9a: {} steps'.format(steps))
    if eval_apply != rec.bn_calls['eval'] \
            or eval_apply != CLI_EVAL_BATCHES * len(bn):
        checks.append('9a: eval bn_apply {} != {} eval-mode BN calls, {} x '
                      '{}'.format(eval_apply, rec.bn_calls['eval'],
                                  CLI_EVAL_BATCHES, len(bn)))
    if not all(np.isfinite(losses)):
        checks.append('9a: non-finite loss {}'.format(losses))
    intervals = (np.diff(rec.entries) * 1e3).tolist()
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
        'launches': counts_a, 'first_loss_rel_err': first_rel,
        'first_batch_bit_equal': batch_equal,
        'checkpoint_mb': os.path.getsize(ckpt) / 1e6,
        'checkpoint_write_s': save_s, 'checkpoint_read_s': read_s,
        'wall_s': wall_a}

    # 9b: test only from 9a's checkpoint
    engine, (cmc_b, mAP_b, _, _), counts_b, rec, wall_b = drive_cli(
        torch, '9b test from the checkpoint', cli_argv(92, 'test.evaluate', 'True',
                        'model.load_weights', ckpt))
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
        torch, '9c test through K2', cli_argv(93, 'test.evaluate', 'True',
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
        torch, '9d resnet50', cli_argv(94, 'train.max_epoch', '1',
                        'model.bpbreid.backbone', 'resnet50'))
    losses_d = [float(v) for v in rec.losses]
    bn_d, no_grad_d = _bn_split(engine.model)
    want_d, bad = _step_launch_checks(rec, bn_d, no_grad_d, '9d')
    checks += bad
    if len(losses_d) != steps_per_epoch or not all(np.isfinite(losses_d)):
        checks.append('9d: losses {}'.format(losses_d))
    d_ms = statistics.median((np.diff(rec.entries) * 1e3).tolist())
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


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 1
    from bpbreid_tpu_torch.ops.cuda.build import build_kernels, library_path
    # f32 convolutions and matmuls in full f32 on the card
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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
    phase_large_gallery(torch, results)
    log('phase 9: the train/test CLI (scripts/main.py)')
    cli_launches, k2_cli_launches = phase_cli(torch, results)

    main_row = k2_rows[0]       # main-path shape and dtypes
    kernels = [{
        'name': 'attention_pool', 'route': 'cuda',
        'source': 'bpbreid_tpu_torch/ops/cuda/attention_pool.cu',
        'replaces': 'bpbreid_tpu/ops/pallas/pooling.py:47',
        'launches': k2_cli_launches.get('attention_pool', 0),
        'max_abs_err': main_row['max_abs_err'],
        'ms': main_row['ms'], 'plain_ms': main_row['plain_ms'],
        'bound_ms': main_row['bound_ms'], 'bound_by': main_row['bound_by'],
        'library_ms': main_row['library_ms'],
    }]
    k3_row = next(r for r in k3_rows
                  if (tuple(r['shape']), r['dtype']) == K3_REPORT)
    for name in BN_KERNELS:
        kernels.append({
            'name': name, 'route': 'cuda', 'source': K3_SOURCE,
            'replaces': K3_REPLACES[name],
            'launches': cli_launches.get(name, 0),
            'max_abs_err': k3_row[name + '_max_abs_err'],
            'ms': k3_row[name + '_ms'], 'plain_ms': k3_row[name + '_plain_ms'],
            'bound_ms': k3_row[name + '_bound_ms'],
            'bound_by': k3_row[name + '_bound_by'],
            'library_ms': k3_row[name + '_library_ms']})
    k1_row = next(r for r in k1_rows
                  if (tuple(r['shape']), r['dtype']) == K1_REPORT)
    kernels.append({
        'name': 'conv_chain', 'route': 'cuda', 'source': K1_SOURCE,
        'replaces': K1_REPLACES, 'launches': k1_launches,
        'max_abs_err': k1_row['max_abs_err'], 'ms': k1_row['ms'],
        'plain_ms': k1_row['plain_ms'], 'bound_ms': k1_row['bound_ms'],
        'bound_by': k1_row['bound_by'], 'library_ms': k1_row['library_ms']})
    results['kernels'] = kernels
    unlaunched = [k['name'] for k in kernels if not k['launches']]
    if unlaunched:
        raise AssertionError('no launch on the path: {}'.format(unlaunched))
    with open('chiprun_out/chip_smoke.json', 'w') as f:
        json.dump(results, f, indent=1)
    s, t = results['serving'], results['train']
    log(gpu)
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
        'checkpoint_mb': a['checkpoint_mb'],
        'checkpoint_write_s': a['checkpoint_write_s'],
        'checkpoint_read_s': a['checkpoint_read_s'],
        'wall_s': {k: v['wall_s'] for k, v in results['cli'].items()
                   if k != 'phase_s'},
        'phase_s': results['cli']['phase_s'],
        'resnet50_step_ms_median': d['step_ms_median'], 'gpu': gpu}))
    log(json.dumps({'kernels': kernels}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
