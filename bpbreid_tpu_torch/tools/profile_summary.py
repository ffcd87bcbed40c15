"""Kernel-level summary of a ``torch.profiler`` trace (the port's
counterpart of bpbreid_tpu/tools/profile_summary.py, which reads JAX's
xplane files).

Point it at the Chrome trace JSON that
``torch.profiler.profile(...).export_chrome_trace`` (or the port's
``utils.writer.ProfilerTrace``) wrote, or at a directory holding one (the
newest ``*.json`` under it). It sums the time of each kernel name and
rolls the names up by category, so "where does the step time go" is
answerable without TensorBoard:

- a trace with device activity: the device's events (``cat`` ``kernel``,
  ``gpu_memcpy``, ``gpu_memset``). Their sum is the profiler's own CUDA
  total (``key_averages``' self device time of the CUDA events);
- a CPU-only trace: the ``cpu_op`` events, each counted for its self
  time (its duration less that of the ops nested in it on its thread),
  whose sum is ``key_averages``' self CPU time.

Categories: batch norm (the port's ``bn_stats.cu`` kernels, cuDNN's),
attention pool (K2), layout copy (NCHW <-> NHWC), convolution (cuDNN,
``conv_s8``, ``conv_chain``), matmul (gemm, cutlass), reduce,
elementwise, memcpy/memset, other.

It then lists the host's spans (``user_annotation`` events: the port's
``utils/tracing.py`` spans, such as ``engine.forward_backward_multi``,
``graph.replay`` or ``prefetch.wait``) by name, with their summed
duration and count.

Usage:
  python -m bpbreid_tpu_torch.tools.profile_summary <trace.json or dir> \\
      [--top 30]
"""
import argparse
import collections
import glob
import json
import os.path as osp
import re

__all__ = ['find_trace', 'categorize', 'summarize', 'span_totals',
           'main']

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')

# device kernel names, lower case: the first pattern that matches wins
# (the BN kernels' reductions before 'reduce', implicit-GEMM convolutions
# before 'gemm')
_KERNEL_CATEGORIES = (
    ('batch norm', re.compile(r'reduce_rows_kernel|reduce_cols_kernel|'
                              r'ewise_rows_kernel|ewise_cols_kernel|'
                              r'batch_?norm|bn_fw|bn_bw')),
    ('attention pool', re.compile(r'attention_pool')),
    ('layout copy', re.compile(r'nchwtonhwc|nhwctonchw|transpose')),
    ('convolution', re.compile(r'conv|fprop|dgrad|wgrad|implicit_gemm|'
                               r'winograd|cudnn|basicblock_kernel')),
    ('matmul', re.compile(r'gemm|gemv|cutlass|cublas|matmul')),
    ('reduce', re.compile(r'reduce|softmax|norm')),
    ('elementwise', re.compile(r'elementwise|vectorized|unrolled|quantize|'
                               r'pointwise')),
)

# CPU ops by their aten name without the namespace and a trailing '_'
_OP_CATEGORIES = {
    'batch norm': {'batch_norm', 'native_batch_norm', 'cudnn_batch_norm',
                   '_batch_norm_impl_index', 'native_batch_norm_backward',
                   '_native_batch_norm_legit_no_training'},
    'layout copy': {'permute', 'transpose', 'contiguous', 't'},
    'convolution': {'conv2d', 'convolution', '_convolution',
                    'mkldnn_convolution', 'convolution_backward',
                    'cudnn_convolution', 'thnn_conv2d'},
    'matmul': {'mm', 'addmm', 'bmm', 'matmul', 'linear', 'einsum', 'baddbmm'},
    'reduce': {'sum', 'mean', 'max', 'min', 'amax', 'amin', 'norm',
               'softmax', '_softmax', 'log_softmax', '_log_softmax', 'argmax',
               'cumsum', 'var', 'std'},
    'elementwise': {'add', 'sub', 'mul', 'div', 'relu', 'sigmoid', 'exp',
                    'log', 'clamp', 'clamp_min', 'where', 'sqrt', 'rsqrt',
                    'fill', 'zero', 'neg', 'pow', 'abs', 'threshold',
                    'threshold_backward', 'copy', 'to', '_to_copy'},
}


def find_trace(path):
    """A trace file, or the newest ``*.json`` under a directory."""
    if osp.isfile(path):
        return path
    hits = sorted(glob.glob(osp.join(path, '**', '*.json'), recursive=True),
                  key=osp.getmtime)
    if not hits:
        raise FileNotFoundError(
            'no *.json trace under {!r}: pass the file written by '
            'export_chrome_trace (or ProfilerTrace)'.format(path))
    return hits[-1]


def categorize(name, cat='kernel'):
    """The category of one event's ``name`` (``cat``: its trace
    category)."""
    if cat in ('gpu_memcpy', 'gpu_memset'):
        return 'memcpy/memset'
    low = name.lower()
    if cat == 'cpu_op':
        base = low.split('::')[-1].rstrip('_')
        if 'batchnorm' in base.replace('_', ''):   # the port's BN Functions
            return 'batch norm'
        for category, names in _OP_CATEGORIES.items():
            if base in names:
                return category
        return 'other'
    for category, pattern in _KERNEL_CATEGORIES:
        if pattern.search(low):
            return category
    return 'other'


def _self_times(events):
    """``{index: self time}`` of nested ``X`` events, per thread: an
    event's duration less those of the events directly inside it."""
    out = {}
    by_thread = collections.defaultdict(list)
    for i, e in enumerate(events):
        by_thread[(e.get('pid'), e.get('tid'))].append(i)
    for idxs in by_thread.values():
        idxs.sort(key=lambda i: (events[i]['ts'], -events[i]['dur']))
        stack = []                       # (index, end)
        for i in idxs:
            e = events[i]
            while stack and stack[-1][1] <= e['ts']:
                stack.pop()
            out[i] = e['dur']
            if stack:
                out[stack[-1][0]] -= e['dur']
            stack.append((i, e['ts'] + e['dur']))
    return out


def summarize(trace_path, top=30):
    """Return ``(rows, cat_totals, total_ns, label)``: ``rows`` are
    ``(name, total_ns, count)`` sorted by time descending (the first
    ``top``), ``cat_totals`` a Counter of category -> ns, ``total_ns``
    the summed time and ``label`` what was summed (device kernels or CPU
    ops' self time)."""
    with open(trace_path) as f:
        trace = json.load(f)
    events = trace['traceEvents'] if isinstance(trace, dict) else trace
    complete = [e for e in events if e.get('ph') == 'X' and 'dur' in e]
    device = [e for e in complete if e.get('cat') in DEVICE_CATS]
    if device:
        picked, label = device, 'device kernels, memcpy and memset'
        times = {i: e['dur'] for i, e in enumerate(picked)}
    else:
        picked = [e for e in complete if e.get('cat') == 'cpu_op']
        if not picked:
            raise RuntimeError('trace has no device events and no cpu_op '
                               'events: ' + trace_path)
        label = 'CPU ops, self time'
        times = _self_times(picked)
    per_name = collections.Counter()
    counts = collections.Counter()
    cat_of = {}
    for i, e in enumerate(picked):
        ns = int(round(times[i] * 1000))
        per_name[e['name']] += ns
        counts[e['name']] += 1
        cat_of[e['name']] = categorize(e['name'], e.get('cat'))
    cats = collections.Counter()
    for name, ns in per_name.items():
        cats[cat_of[name]] += ns
    rows = [(name, ns, counts[name]) for name, ns in per_name.most_common()]
    return rows[:top], cats, sum(per_name.values()), label


def span_totals(trace_path):
    """``[(name, total_ns, count)]`` of the trace's spans
    (``user_annotation`` events), longest total first."""
    with open(trace_path) as f:
        trace = json.load(f)
    events = trace['traceEvents'] if isinstance(trace, dict) else trace
    per_name, counts = collections.Counter(), collections.Counter()
    for e in events:
        if e.get('ph') == 'X' and e.get('cat') == 'user_annotation':
            per_name[e['name']] += int(round(e.get('dur', 0) * 1000))
            counts[e['name']] += 1
    return [(name, ns, counts[name]) for name, ns in per_name.most_common()]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('path', help='trace .json file or a directory')
    parser.add_argument('--top', type=int, default=30)
    args = parser.parse_args(argv)

    trace = find_trace(args.path)
    rows, cats, total_ns, label = summarize(trace, top=args.top)
    print('trace: {} ({})   total event time: {:.3f} ms'.format(
        trace, label, total_ns / 1e6))
    print('\n-- category rollup --')
    for cat, ns in cats.most_common():
        print('{:<20} {:>10.3f} ms  {:>5.1f}%'.format(
            cat, ns / 1e6, 100.0 * ns / max(total_ns, 1)))
    print('\n-- top {} kernels by time --'.format(len(rows)))
    print('{:<64} {:>10} {:>7}'.format('kernel', 'ms', 'count'))
    for name, ns, count in rows:
        print('{:<64} {:>10.3f} {:>7}'.format(name[:64], ns / 1e6, count))
    spans = span_totals(trace)
    if spans:
        print('\n-- spans --')
        print('{:<64} {:>10} {:>7}'.format('span', 'ms', 'count'))
        for name, ns, count in spans:
            print('{:<64} {:>10.3f} {:>7}'.format(name[:64], ns / 1e6,
                                                  count))


if __name__ == '__main__':
    main()
