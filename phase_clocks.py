"""Where a fused EdgeConv launch spends its time, phase by phase, on the card.

    python3 phase_clocks.py

Builds `ops/csrc/fused_edgeconv.cu` once more with -DPHASE_CLOCKS (thread 0
of every block adds the clock64() cycles of each phase, behind a barrier,
to device counters) into the gitignored build directory, points the
`fused_edgeconv` wrapper at it, and runs the fused layer once at each of
chip_smoke.py's kernel shapes (rows 4-7: (64, 2000, 3) and (64, 2000, 150),
(128, 10000, 3) and (128, 10000, 150), k = 5, the att widths, the same
seeds). Prints one JSON line per row: the layer's ms (CUDA events, one
run, both launches where it takes two), and the cycles of the selection,
of building the edge rows and of each MLP layer (summed over the 16-query
slices), in all and per block of the launch that runs the phase, with each
phase's share of the sum, then the card's name and power limit. Row 7
takes two launches: select_stream's blocks of 128 query rows, then the
edge MLP's of 16. The counters add a barrier per phase, so the
instrumented launch runs somewhat slower than chip_smoke.py's.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ('selection', 'edge_rows', 'layer0', 'layer1', 'layer2')


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit('phase_clocks: no CUDA device')
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from garment_pattern_estimation_torch.ops import _build, edgeconv

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / 'libfused_edgeconv_phase_clocks.so'
    built = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, '-DPHASE_CLOCKS', '-o', str(out),
                            str(_build.SOURCES['fused_edgeconv'])], capture_output=True, text=True)
    if built.returncode:
        sys.exit(f'phase_clocks: nvcc failed:\n{built.stdout}{built.stderr}')
    lib = ctypes.CDLL(str(out))
    lib.fused_edgeconv_phase_clocks.restype = ctypes.c_int
    lib.fused_edgeconv_phase_clocks.argtypes = [ctypes.c_void_p]
    _build._LIBS['fused_edgeconv'] = lib
    counters = (ctypes.c_ulonglong * 8)()

    widths = [cs.ATT_NN_CONFIG['EConv_hidden']] * cs.ATT_NN_CONFIG['EConv_hidden_depth'] \
        + [cs.ATT_NN_CONFIG['EConv_feature']]
    gen = torch.Generator().manual_seed(0)                  # chip_smoke.py's att_kernels
    a0 = torch.randn(cs.BATCH, cs.POINTS, 3, generator=gen).cuda()
    a_conv0 = cs.random_folded(gen, 3, widths, 'cuda')
    a_conv1 = cs.random_folded(gen, widths[-1], widths, 'cuda')
    gen = torch.Generator().manual_seed(7)                  # and its stress_kernels
    s0 = torch.randn(cs.STRESS_BATCH, cs.STRESS_POINTS, 3, generator=gen).cuda()
    s_conv0 = cs.random_folded(gen, 3, widths, 'cuda')
    s_conv1 = cs.random_folded(gen, widths[-1], widths, 'cuda')
    a1 = edgeconv.fused_edgeconv(a0, a_conv0, cs.K)
    s1 = edgeconv.fused_edgeconv(s0, s_conv0, cs.K)
    # query rows per block of the selection and of the edge MLP
    rows = (('fused_edgeconv_small_c', a0, a_conv0, (128, 128)),
            ('fused_edgeconv_wide_c', a1, a_conv1, (16, 16)),
            ('fused_edgeconv_small_c_tiled', s0, s_conv0, (128, 128)),
            ('fused_edgeconv_wide_c_tiled', s1, s_conv1, (128, 16)))
    for name, x, folded, query_rows in rows:
        edgeconv.fused_edgeconv(x, folded, cs.K)            # warm up
        torch.cuda.synchronize()
        check = lib.fused_edgeconv_phase_clocks(counters)   # clears the counters
        ms = cs.cuda_ms(lambda: edgeconv.fused_edgeconv(x, folded, cs.K), 0, 1)
        torch.cuda.synchronize()
        check |= lib.fused_edgeconv_phase_clocks(counters)
        if check:
            sys.exit(f'phase_clocks: reading the counters failed with CUDA error {check}')
        blocks = [-(-x.shape[1] // rows_) * x.shape[0] for rows_ in query_rows]
        total = sum(counters[i] for i in range(len(PHASES)))
        print(json.dumps({'name': name, 'shape': list(x.shape), 'k': cs.K, 'ms': ms,
                          'blocks': {'selection': blocks[0], 'mlp': blocks[1]},
                          'query_rows_per_block': {'selection': query_rows[0],
                                                   'mlp': query_rows[1]},
                          'cycles': {p: counters[i] for i, p in enumerate(PHASES)},
                          'cycles_per_block': {p: counters[i] / blocks[i > 0]
                                               for i, p in enumerate(PHASES)},
                          'share': {p: counters[i] / total for i, p in enumerate(PHASES)}}),
              flush=True)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)


if __name__ == '__main__':
    main()
