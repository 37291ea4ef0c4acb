"""Alternating A/B of the att training step's (or serving batch's) wall
time between two checkouts of the PyTorch port, on one NVIDIA GPU.

    python3 train_step_ab.py ROOT_A ROOT_B [--rounds 3] [--steps 40] [--serving [--bf16]]

Each round runs A, B, B, A, each in a process of its own that imports that
checkout's chip_smoke.py and port: build_model at the published att.yaml
widths (seed 0), Trainer with the att.yaml optimizer and schedule, and
`--steps` Trainer.train_step calls on chip_smoke's seeded (30, 2000, 3)
training batch, each timed on the host clock between two synchronizes.
With `--serving`, `--steps` calls of `build_serving_fn` on chip_smoke's
seeded (64, 2000, 3) serving batch instead (`--bf16`: att_bf16.yaml's
mode). Prints one JSON line per run (median and quartiles of the calls
after the first, peak device memory) and last a JSON line with each
checkout's run medians. Exits non-zero without a card or when a run fails.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def run_one(root, steps, serving=False, bf16=False):
    """`steps` att training steps (or serving calls) through the checkout
    at `root`; prints their times as one JSON line."""
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        sys.exit('train_step_ab: no CUDA device')
    import chip_smoke as cs
    from garment_pattern_estimation_torch.models import build_model
    from garment_pattern_estimation_torch.ops import _build
    from garment_pattern_estimation_torch.train import Trainer

    _build.build_all()
    if serving:
        from garment_pattern_estimation_torch.experiment import build_serving_fn
        model = build_model('GarmentSegmentPattern3D', cs.ATT_DATA_CONFIG,
                            cs.ATT_BF16_NN_CONFIG if bf16 else cs.ATT_NN_CONFIG, seed=0)
        serve = build_serving_fn(model, cs.ATT_DATA_CONFIG)
        points = cs.physical_points(1, cs.BATCH, cs.POINTS)

        def step():
            serve(points)
    else:
        model = build_model('GarmentSegmentPattern3D', cs.ATT_DATA_CONFIG, cs.ATT_NN_CONFIG,
                            cs.ATT_LOSS_CONFIG, seed=0)
        trainer = Trainer(cs.ATT_TRAINER)
        trainer.make_optimizer(model, steps_per_epoch=steps)
        batch = cs.training_batch(torch.Generator().manual_seed(4), cs.TRAIN_BATCH, 'cuda')
        states = torch.Generator(device='cuda').manual_seed(cs.ATT_TRAINER['random_seed'])

        def step():
            trainer.train_step(model, batch, epoch=0, generator=states)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    q1, median, q3 = statistics.quantiles(times[1:], n=4)
    print(json.dumps({'root': str(root), 'steps': steps, 'step_ms': median,
                      'step_ms_quartiles': [q1, q3], 'first_step_ms': times[0],
                      'step_times_ms': times,
                      'peak_memory_gb': torch.cuda.max_memory_allocated() / 1e9}),
          flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('roots', nargs='*', type=Path)
    parser.add_argument('--rounds', type=int, default=3)
    parser.add_argument('--steps', type=int, default=40)
    parser.add_argument('--serving', action='store_true')
    parser.add_argument('--bf16', action='store_true')
    parser.add_argument('--child', type=Path, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child is not None:
        run_one(args.child.resolve(), args.steps, args.serving, args.bf16)
        return
    if len(args.roots) != 2:
        parser.error('give two checkouts, ROOT_A and ROOT_B')
    a, b = (r.resolve() for r in args.roots)
    medians = {str(a): [], str(b): []}
    for _ in range(args.rounds):
        for root in (a, b, b, a):
            out = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), '--child', str(root),
                 '--steps', str(args.steps)] + (['--serving'] if args.serving else [])
                + (['--bf16'] if args.bf16 else []),
                cwd=root, capture_output=True, text=True)
            if out.returncode != 0:
                sys.exit(f'train_step_ab: the run of {root} failed:\n{out.stderr[-4000:]}')
            line = json.loads(out.stdout.strip().splitlines()[-1])
            print(json.dumps(line), flush=True)
            medians[str(root)].append(line['step_ms'])
    print(json.dumps({'order': 'A B B A per round', 'A': str(a), 'B': str(b),
                      'timed': ('serving_bf16' if args.bf16 else 'serving') if args.serving
                      else 'train_step',
                      'step_ms_medians': medians}), flush=True)


if __name__ == '__main__':
    main()
