#!/usr/bin/env python3
"""Times K1's bf16 path (the BasicBlock chain on the tensor cores) on one
NVIDIA GPU at HRNet-W32's four branch-chain shapes.

    python3 k1_bench.py

For each shape ``[64, H, W, C]`` with 4 blocks: the wrapper
``fused_basicblock_chain`` (weight repack, scratch allocation and the 8
launches), the kernel alone (the 8 launches through the C entry point on
prepared operands) at the CTA tile the planner picks and at the other
tiles the source instantiates, and the same chain as eager bf16 cuDNN
(``chip_smoke.conv_chain_library``). CUDA events, median of 5 repeats of
20 calls. Then a torch.profiler trace of 3 wrapper calls: device time of
the conv1 and the conv2 launches (they alternate) and of the wrapper's
other kernels (weight repack, padding), per call. Prints one JSON line
per measurement and writes them all to ``chiprun_out/k1_bench.json``.
Needs one CUDA card; exits 1 without one.
"""
import json
import os
import sys

import chip_smoke as cs

TILES = ((128, 64), (64, 64), (128, 32), (64, 32))
PROFILED_CALLS = 3


def profile_split(torch, call):
    """Device ms per call of the conv1 and conv2 launches and of the other
    kernels, from a torch.profiler trace of ``PROFILED_CALLS`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_CALLS):
            call()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and not getattr(e, 'is_user_annotation', False)),
                     key=lambda e: e.time_range.start)
    convs = [e for e in kernels if 'conv3x3_mma_kernel' in e.name]
    if not convs:
        return {'profile': 'not measured'}

    def ms(events):
        return sum(e.time_range.elapsed_us() for e in events) / 1e3 \
            / PROFILED_CALLS
    return {'conv1_ms': ms(convs[0::2]), 'conv2_ms': ms(convs[1::2]),
            'other_kernels_ms': ms(e for e in kernels
                                   if 'conv3x3_mma_kernel' not in e.name),
            'other_kernels': sorted({e.name[:60] for e in kernels
                                     if 'conv3x3_mma_kernel' not in e.name})}


def main():
    import torch
    if not torch.cuda.is_available():
        print('k1_bench: CUDA is not available', file=sys.stderr)
        return 1
    from bpbreid_tpu_torch.ops import conv_chain as cc
    from bpbreid_tpu_torch.ops.cuda.build import load_kernel
    gpu = cs.gpu_name_and_power_limit()
    lib, fn = load_kernel('conv_chain_bf16')
    gen = torch.Generator(device='cuda').manual_seed(cs.SEED + 4)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []

    def emit(row):
        row['gpu'] = gpu
        print(json.dumps(row), flush=True)
        rows.append(row)

    def t(call):
        return cs.time_ms(call, torch, warmup=3, iters=20, repeats=5)

    for shape, blocks in cs.K1_MAIN_SHAPES:
        n, h, w, c = shape
        gflop = 2.0 * n * h * w * 9 * c * c * 2 * blocks / 1e9
        x, wt, s, b = cs._k1_inputs(torch, gen, shape, blocks,
                                    torch.bfloat16)
        plan = cc.plan_mma_tiles(n * h * w, c, c)
        ms = t(lambda: cc.fused_basicblock_chain(x, wt, s, b))
        emit({'shape': list(shape), 'what': 'wrapper', 'tile': list(plan),
              'ms': ms, 'tflop_per_s': gflop / ms,
              **profile_split(torch, lambda: cc.fused_basicblock_chain(
                  x, wt, s, b))})
        x_cl = x.permute(0, 3, 1, 2)
        w_lib = [wi.contiguous(memory_format=torch.channels_last)
                 for wi in wt.permute(0, 4, 3, 1, 2).to(x.dtype)]
        s_l, b_l = s.to(x.dtype), b.to(x.dtype)
        ms = t(lambda: cs.conv_chain_library(torch, x_cl, w_lib, s_l, b_l))
        emit({'shape': list(shape), 'what': 'library', 'ms': ms,
              'tflop_per_s': gflop / ms})
        # the wrapper's operands, made once (C is a multiple of 16 here)
        wq = cc.repack_weights_bf16(wt, c, c)
        sp, bp = s.contiguous(), b.contiguous()
        out, y1, abuf = (torch.empty_like(x) for _ in range(3))
        sbuf = torch.empty(x.shape, dtype=torch.float32, device='cuda')
        want = cc.fused_basicblock_chain(x, wt, s, b)
        for bm, bn in TILES:
            if bn > 32 and c <= 32:
                continue
            kc = plan[2]

            def call():
                code = fn(x.data_ptr(), x.data_ptr(), out.data_ptr(),
                          y1.data_ptr(), abuf.data_ptr(), sbuf.data_ptr(),
                          wq.data_ptr(), sp.data_ptr(), bp.data_ptr(), n, h,
                          w, c, c, c, blocks, bm, bn, kc, stream)
                if code != 0:
                    raise RuntimeError('conv_chain_bf16 failed: {}'.format(
                        lib.bpbreid_cuda_error_string(code).decode()))
            call()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                # the tile changes no sum: each output is one thread's
                # k-loop in the same order
                raise AssertionError('tile {} differs from the planner\'s'
                                     .format((bm, bn, kc)))
            ms = t(call)
            emit({'shape': list(shape), 'what': 'kernel',
                  'tile': [bm, bn, kc], 'planned': (bm, bn) == plan[:2],
                  'ms': ms, 'tflop_per_s': gflop / ms})
        del x, wt, s, b, x_cl, w_lib, wq, out, y1, abuf, sbuf, want
        torch.cuda.empty_cache()
    os.makedirs('chiprun_out', exist_ok=True)
    with open('chiprun_out/k1_bench.json', 'w') as f:
        json.dump(rows, f, indent=1)
    print(gpu)
    return 0


if __name__ == '__main__':
    sys.exit(main())
