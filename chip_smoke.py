"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each:
  build    builds every CUDA source of the port (one nvcc each, in parallel)
  kernel   each fused EdgeConv variant against its plain PyTorch version at
           the attention model's shapes: (64, 2000, 3) -> 150 (conv0, small
           C) and (64, 2000, 150) -> 150 (conv1, wide C), k = 5, folded
           weights from a seeded torch.Generator with non-trivial BatchNorm
           statistics. Neighbour-id agreement (1.0 for small C; for wide C
           at least 0.99, every disagreement a near tie), the output against
           the plain MLP tail on the kernel's own neighbours and against the
           whole plain layer where the ids agree, the kernel's and the plain
           version's times (CUDA events, median of 20 after warm-up)
  serving  build_model at the published att.yaml widths (seeded init),
           build_serving_fn on a (64, 2000, 3) batch: output shapes and
           finiteness, 2 kernel launches per forward (conv0 + conv1), batch
           time and clouds/s, and a 2-cloud batch against the same model's
           plain path on the CPU
Then the card's name and power limit, the kernels line, and as the last line
{"ok": true, "device": {...}}. Any failed check exits non-zero.

Tolerances: the edge MLP truncates activations to bf16 and the kernel sums
in another order than cuBLAS, so one flipped truncation moves an activation
by up to 2^-8 of itself; outputs are held to 1e-2 of their largest
magnitude, 1e-4 on average.
"""
import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the published attention model (configs/att.yaml), its data layout and
# standardization statistics
ATT_DATA_CONFIG = {
    'element_size': 4, 'rotation_size': 4, 'translation_size': 3,
    'max_panel_len': 14, 'max_pattern_len': 23, 'max_num_stitches': 24,
    'explicit_stitch_tags': False,
    'standardize': {
        'f_scale': [16.351303100585938, 30.945703506469727, 9.60141944885254],
        'f_shift': [0.037076108157634735, -28.06070327758789, 1.0775548219680786],
        'gt_shift': {
            'outlines': [0, 0, 0.1489, 0.0564],
            'rotations': [-0.7071, -0.9239, -1, 0],
            'translations': [-55.255, -20.001, -17.087],
            'stitch_tags': [-59.991, -78.124, -52.956],
        },
        'gt_scale': {
            'outlines': [25.268, 31.299, 0.2677, 0.2352],
            'rotations': [1.7071, 1.9239, 1.7071, 1],
            'translations': [109.589, 98.279, 37.847],
            'stitch_tags': [119.983, 156.038, 105.926],
        },
    },
}
ATT_NN_CONFIG = {
    'panel_encoding_size': 250, 'panel_hidden_size': 250, 'panel_n_layers': 3,
    'pattern_encoding_size': 250, 'pattern_hidden_size': 250, 'pattern_n_layers': 2,
    'EConv_hidden': 200, 'EConv_feature': 150, 'EConv_hidden_depth': 2,
    'k_neighbors': 5, 'conv_depth': 2, 'skip_connections': True,
    'global_pool': 'mean', 'local_attention': True,
}
BATCH, POINTS, K = 64, 2000, 5
OUT_MAX_REL, OUT_MEAN_REL = 1e-2, 1e-4
WIDE_ID_AGREEMENT = 0.99
NEAR_TIE_REL = 2.0 ** -10          # 4 quantization buckets of the packed distance
NORM_ULPS = 2.0 ** -18             # 32 f32 ulps of the squared norms
SERVE_CALLS = 11

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 CUDA cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

KERNEL_SOURCE = 'garment_pattern_estimation_torch/ops/csrc/fused_edgeconv.cu'
REPLACES = 'garment_pattern_estimation_tpu/ops/edgeconv.py:126'


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(message):
    print(f'chip_smoke: FAILED: {message}', file=sys.stderr, flush=True)
    sys.exit(1)


def check(condition, message):
    if not condition:
        fail(message)


def cuda_ms(fn, warmup=3, runs=20):
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def random_folded(gen, c, widths, device):
    """fold_mlp_bn of a seeded Dense/BN stack with non-trivial statistics."""
    import torch
    from garment_pattern_estimation_torch.ops.edgeconv import fold_mlp_bn

    layers = []
    for fan_in, fan_out in zip([2 * c, *widths[:-1]], widths):
        layers.append((
            torch.randn(fan_out, fan_in, generator=gen) / fan_in ** 0.5,
            torch.randn(fan_out, generator=gen) * 0.1,
            torch.rand(fan_out, generator=gen) + 0.5,
            torch.randn(fan_out, generator=gen) * 0.1,
            torch.randn(fan_out, generator=gen) * 0.1,
            torch.rand(fan_out, generator=gen) * 1.5 + 0.5))
    folded, (a, d) = fold_mlp_bn(layers)
    return [(w.to(device), b.to(device)) for w, b in folded], (a.to(device), d.to(device))


def bound(B, N, C, k, widths):
    """Least time (ms) on the card for one layer, and what bounds it. Bytes:
    x read once, the output written once, the bf16 weights, biases and
    affine. Operations: the distances (small C: sub, mul, add per dimension
    in f32; wide C: three bf16 split products) and the edge MLP (bf16
    products, f32 accumulation); the selection's integer compares are not
    counted."""
    dims = [2 * C, *widths]
    mlp_flops = 2.0 * B * N * k * sum(i * o for i, o in zip(dims[:-1], dims[1:]))
    if C <= 16:
        f32_flops, bf16_flops = 3.0 * B * N * N * C, mlp_flops
    else:
        f32_flops, bf16_flops = 0.0, 3 * 2.0 * B * N * N * C + mlp_flops
    n_bytes = 4.0 * B * N * (C + widths[-1]) \
        + sum(2 * i * o + 4 * o for i, o in zip(dims[:-1], dims[1:])) + 8 * widths[-1]
    ops_ms = (f32_flops / PEAK_F32_FLOPS + bf16_flops / PEAK_BF16_FLOPS) * 1e3
    bytes_ms = n_bytes / PEAK_BYTES * 1e3
    return (ops_ms, 'operations') if ops_ms >= bytes_ms else (bytes_ms, 'bytes')


def check_kernel(name, x, folded, widths):
    """Kernel against the plain version on the same inputs; returns the
    kernel's output and its line of the kernels list (launches filled in
    later)."""
    import torch
    from garment_pattern_estimation_torch.ops import edgeconv

    B, N, C = x.shape
    small = C <= edgeconv.SMALL_C_MAX
    out, idx = edgeconv.fused_edgeconv(x, folded, K, return_idx=True)
    torch.cuda.synchronize()
    ref_idx, x_lp = edgeconv.edgeconv_select(x, K)
    agree_rows = (idx == ref_idx).all(dim=-1)
    id_share = (idx == ref_idx).float().mean().item()

    # disagreements must be near ties: the exactly recomputed distances of
    # the two neighbour sets differ by a few quantization buckets plus the
    # rounding of q_norm + k_norm - 2 * cross (a few ulps of the norms)
    worst_tie = 0.0
    rows = (~agree_rows).nonzero()
    if rows.numel():
        xb = x.double()[rows[:, 0]]                               # (R, N, C)
        q = xb[torch.arange(len(rows)), rows[:, 1]]               # (R, C)

        def dists(ids):
            nbr = torch.gather(xb, 1, ids[rows[:, 0], rows[:, 1]][:, :, None]
                               .expand(-1, -1, C))
            norms = (nbr ** 2).sum(-1).amax(-1) + (q ** 2).sum(-1)
            return ((nbr - q[:, None]) ** 2).sum(-1).sort(dim=-1).values, norms

        (d_kernel, n_kernel), (d_plain, n_plain) = dists(idx), dists(ref_idx)
        allowed = NEAR_TIE_REL * d_plain \
            + NORM_ULPS * torch.maximum(n_kernel, n_plain)[:, None]
        worst_tie = ((d_kernel - d_plain).abs() / allowed).max().item()

    tail = edgeconv.edgeconv_mlp_max(x, idx, x_lp, folded)
    full = edgeconv.edgeconv_mlp_max(x, ref_idx, x_lp, folded)
    scale = tail.abs().max().item()
    diff = (out - tail).abs()
    diff_agree = (out - full).abs()[agree_rows]
    line = {
        'phase': 'kernel', 'name': name, 'shape': [B, N, C], 'k': K,
        'mlp': [2 * C, *widths], 'id_agreement': id_share,
        'id_disagreeing_rows': int(rows.shape[0]), 'near_tie_ratio': worst_tie,
        'max_abs_err': diff.max().item(), 'max_rel_err': diff.max().item() / scale,
        'mean_rel_err': diff.mean().item() / scale,
        'max_rel_err_vs_full_plain': diff_agree.max().item() / scale,
    }
    line['ms'] = cuda_ms(lambda: edgeconv.fused_edgeconv(x, folded, K))
    line['plain_ms'] = cuda_ms(lambda: edgeconv.fused_edgeconv_reference(x, folded, K))
    line['bound_ms'], line['bound_by'] = bound(B, N, C, K, widths)
    line['library_ms'] = None       # no single PyTorch call computes this layer
    emit(line)
    if small:
        check(id_share == 1.0, f'{name}: neighbour ids agree on {id_share}, not all')
    else:
        check(id_share >= WIDE_ID_AGREEMENT,
              f'{name}: neighbour ids agree on {id_share} < {WIDE_ID_AGREEMENT}')
        check(worst_tie <= 1.0,
              f'{name}: a disagreeing neighbour is {worst_tie} x the near-tie bound away')
    check(line['max_rel_err'] <= OUT_MAX_REL and line['mean_rel_err'] <= OUT_MEAN_REL,
          f'{name}: output off the plain tail: {line}')
    check(line['max_rel_err_vs_full_plain'] <= OUT_MAX_REL,
          f'{name}: output off the plain layer: {line}')

    return out, {
        'name': name, 'route': 'cuda', 'source': KERNEL_SOURCE, 'replaces': REPLACES,
        'launches': None, 'max_abs_err': line['max_abs_err'], 'ms': line['ms'],
        'plain_ms': line['plain_ms'], 'bound_ms': line['bound_ms'],
        'bound_by': line['bound_by'], 'library_ms': None}


def serve_phase():
    import torch
    from garment_pattern_estimation_torch.experiment import build_serving_fn
    from garment_pattern_estimation_torch.models import build_model
    from garment_pattern_estimation_torch.ops import edgeconv

    model = build_model('GarmentSegmentPattern3D', ATT_DATA_CONFIG, ATT_NN_CONFIG, seed=0)
    serve = build_serving_fn(model, ATT_DATA_CONFIG)
    std = ATT_DATA_CONFIG['standardize']
    gen = torch.Generator().manual_seed(1)
    points = (torch.randn(BATCH, POINTS, 3, generator=gen) * torch.tensor(std['f_scale'])
              + torch.tensor(std['f_shift'])).cuda()

    edgeconv.reset_launches()
    times = []
    for _ in range(SERVE_CALLS):
        torch.cuda.synchronize()
        start = time.perf_counter()
        preds = serve(points)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    launches = dict(edgeconv.launches)
    check(launches == {'small_c': SERVE_CALLS, 'wide_c': SERVE_CALLS},
          f'serving: launches {launches}, expected {SERVE_CALLS} of each variant '
          f'({2 * SERVE_CALLS} for {SERVE_CALLS} forwards)')

    P, L = ATT_DATA_CONFIG['max_pattern_len'], ATT_DATA_CONFIG['max_panel_len']
    shapes = {'outlines': (BATCH, P, L, 4), 'rotations': (BATCH, P, 4),
              'translations': (BATCH, P, 3), 'stitch_tags': (BATCH, P, L, 3),
              'free_edges_mask': (BATCH, P, L), 'att_weights': (BATCH, POINTS, P)}
    check(sorted(preds) == sorted(shapes), f'serving: output keys {sorted(preds)}')
    for key, shape in shapes.items():
        check(tuple(preds[key].shape) == shape,
              f'serving: {key} has shape {tuple(preds[key].shape)}, expected {shape}')
        check(bool(torch.isfinite(preds[key]).all()), f'serving: {key} is not finite')

    # a 2-cloud batch against the plain path of the same weights on the CPU
    cpu_model = copy.copy(model)
    cpu_model.module = copy.deepcopy(model.module).cpu()
    small = points[:2]
    on_card = serve(small)
    on_cpu = build_serving_fn(cpu_model, ATT_DATA_CONFIG)(small.cpu())
    ref_err = {}
    for key in shapes:
        ref, got = on_cpu[key], on_card[key].cpu()
        diff = (got - ref).abs()
        scale = ref.abs().max().item()
        if key == 'att_weights':
            # a point whose wide-C neighbours differ by a near tie routes
            # differently: hold 99% of the points to the bound
            off = (diff.amax(dim=-1) > OUT_MAX_REL * scale).float().mean().item()
            ref_err[key] = off
            check(off <= 0.01, f'serving: {off} of the points off the CPU path')
        else:
            ref_err[key] = diff.max().item() / scale
            check(ref_err[key] <= OUT_MAX_REL,
                  f'serving: {key} off the CPU path by {ref_err[key]} of its scale')

    # the first call pays one-time set-up (allocator, cuBLAS handles)
    q1, batch_ms, q3 = statistics.quantiles(times[1:], n=4)
    emit({'phase': 'serving', 'batch': [BATCH, POINTS, 3], 'calls': SERVE_CALLS,
          'launches': launches, 'first_call_ms': times[0], 'batch_ms': batch_ms,
          'batch_ms_quartiles': [q1, q3],
          'clouds_per_s': BATCH / batch_ms * 1e3,
          'vs_cpu_plain': ref_err})
    return launches, serve, points


def profile_phase(serve, points):
    """One serving forward under torch.profiler: device time by kernel and
    the device's idle share of the forward's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    serve(points)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        serve(points)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if getattr(e, 'device_time_total', 0) > 0 and not e.key.startswith('aten::')
            and not e.key.startswith('cuda')]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    emit({'phase': 'profile', 'wall_ms': wall_ms, 'device_kernel_ms': device_ms,
          'idle_share': max(0.0, 1.0 - device_ms / wall_ms),
          'top': [{'kernel': k[:80], 'ms': ms, 'count': n} for k, ms, n in rows[:10]]})


def main():
    import torch
    if not torch.cuda.is_available():
        fail('no CUDA device')
    sys.path.insert(0, str(ROOT))
    from garment_pattern_estimation_torch.ops import _build

    report = _build.build_all()
    emit({'phase': 'build', 'seconds': {n: r['seconds'] for n, r in report.items()},
          'ptxas': {n: [ln for ln in r['log'].splitlines()
                        if 'registers' in ln or 'spill' in ln][:6]
                    for n, r in report.items()}})

    gen = torch.Generator().manual_seed(0)
    widths = [ATT_NN_CONFIG['EConv_hidden']] * ATT_NN_CONFIG['EConv_hidden_depth'] \
        + [ATT_NN_CONFIG['EConv_feature']]
    x0 = torch.randn(BATCH, POINTS, 3, generator=gen).cuda()
    conv0 = random_folded(gen, 3, widths, 'cuda')
    conv1 = random_folded(gen, widths[-1], widths, 'cuda')
    # conv1's input is conv0's output, as in the model
    x1, small_line = check_kernel('fused_edgeconv_small_c', x0, conv0, widths)
    _, wide_line = check_kernel('fused_edgeconv_wide_c', x1.contiguous(), conv1, widths)

    launches, serve, points = serve_phase()
    profile_phase(serve, points)
    small_line['launches'] = launches['small_c']
    wide_line['launches'] = launches['wide_c']

    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit({'kernels': [small_line, wide_line]})
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})


if __name__ == '__main__':
    main()
