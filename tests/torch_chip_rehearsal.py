"""A CPU rehearsal of chip_smoke.py's parallel phases: gloo ranks on the CPU
in place of NCCL ranks on cards.

    python tests/torch_chip_rehearsal.py points [--cards 4] [--points 200]
        [--cases att,gpool] [--meshes '[{"data": 1, "points": 4}]']
        [--moments64 '{"pointnet": [{"data": 1, "points": 2}]}']
    python tests/torch_chip_rehearsal.py ring [--cards 4]
    python tests/torch_chip_rehearsal.py fit [--cards 2]

`points` runs `points_sharded_phase`, `ring` runs `parallel_ring_phase`
and `fit` runs `parallel_fit_phase` (the last two in a world-1 gloo group;
`fit`'s ms per step beside a fit run's is not read), as if `--cards` cards
were visible: each spawned
rank, and this process, sees the CPU as its card (`Tensor.cuda` and
`Module.cuda` return the CPU tensor, the models and trainers resolve their
device to the CPU, `torch.cuda.synchronize` and `set_device` do nothing,
`cuda_ms` times on the host clock), the kernels' wrappers take their plain
versions, and the clouds have `--points` points.
The launch counts are not checked (the plain versions launch nothing) and
the probe's card check accepts the CPU; `--moments64` puts its cases and
meshes in place of POINTS_MOMENTS64's; the fit cell's clouds have
`--points` points too; every other check of the phase runs
as on the card. Each phase line is printed whole. A rehearsal finds faults
of the mesh logic before a multi-card call; its numbers are the CPU's.
"""
import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def patch(cards, points, cases=None, meshes=None, moments64=None):
    """chip_smoke.py's phases on the CPU, as on `cards` cards."""
    torch.set_num_threads(1)
    torch.cuda.device_count = lambda: cards
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.set_device = lambda *a, **k: None
    torch.Tensor.cuda = lambda self, *a, **k: self
    torch.nn.Module.cuda = lambda self, *a, **k: self
    cs._rank_card = lambda backend: torch.device('cpu')
    from garment_pattern_estimation_torch.models import registry
    from garment_pattern_estimation_torch.train import trainer

    def cpu_device(device=None):
        return torch.device('cpu')

    registry.resolve_device = trainer.resolve_device = cpu_device

    def host_ms(fn, warmup=3, runs=20):
        for _ in range(warmup):
            fn()
        start = time.perf_counter()
        for _ in range(runs):
            fn()
        return (time.perf_counter() - start) / runs * 1e3

    cs.cuda_ms = host_ms
    cs.POINTS = points
    if cases:
        cs.POINTS_CASES = {k: v for k, v in cs.POINTS_CASES.items() if k in cases}
    if meshes:
        cs.POINTS_MESHES_4 = tuple(meshes)
    if moments64 is not None:
        cs.POINTS_MOMENTS64 = moments64
    steps, model, folded = cs._points_steps, cs._points_model, cs.random_folded
    cs._points_steps = lambda device, *a, **k: steps(torch.device('cpu'), *a, **k)
    cs._points_model = lambda case, device: model(case, 'cpu')
    cs.random_folded = lambda gen, c, widths, device: folded(gen, c, widths, 'cpu')
    cs.POINTS_STEP_LAUNCHES = {case: {} for case in cs.POINTS_CASES}
    check = cs.check
    cs.check = lambda cond, message: check(
        cond or 'of a card tensor gave cpu' in message or 'parallel_fit: launches' in message,
        message)
    read_records = cs.read_records

    def records_or_none(experiment):
        try:
            return read_records(experiment)
        except FileNotFoundError:                # no fit run: its ms per step is not read
            return [], [{'train_time': float('nan')}]

    cs.read_records = records_or_none
    cs.emit = lambda obj: print(json.dumps(obj), flush=True)
    from garment_pattern_estimation_torch.parallel import dryrun
    spawn = dryrun.__dict__.setdefault('_spawn', dryrun.spawn)

    def gloo_spawn(fn, n, *args, backend='gloo'):
        return spawn(_rank, n, fn.__name__, (cards, points, cases, meshes, moments64), *args,
                     backend='gloo')

    dryrun.spawn = gloo_spawn


def _rank(name, settings, *args):
    """A spawned rank: the patches, then chip_smoke's `name`(*args)."""
    patch(*settings)
    getattr(cs, name)(*args)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('phase', choices=('points', 'ring', 'fit'))
    parser.add_argument('--cards', type=int, default=4)
    parser.add_argument('--points', type=int, default=200)
    parser.add_argument('--cases', default=None, help='comma-separated POINTS_CASES keys')
    parser.add_argument('--meshes', default=None, help='a JSON list of meshes for 4+ cards')
    parser.add_argument('--moments64', default=None,
                        help='a JSON object: the meshes of each case held with f64 BatchNorm '
                             'moments, in place of POINTS_MOMENTS64')
    args = parser.parse_args()
    patch(args.cards, args.points, args.cases and args.cases.split(','),
          args.meshes and json.loads(args.meshes),
          args.moments64 and json.loads(args.moments64))
    with tempfile.TemporaryDirectory() as out:
        start = time.perf_counter()
        if args.phase == 'points':
            cs.points_sharded_phase(Path(out))
        else:
            dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{cs._free_port()}',
                                    rank=0, world_size=1)
            try:
                if args.phase == 'ring':
                    cs.parallel_ring_phase(Path(out))
                else:
                    cs.parallel_fit_phase(Path(out) / 'experiments', 'none')
            finally:
                dist.destroy_process_group()
        print(f'{args.phase}: {time.perf_counter() - start:.1f} s', flush=True)


if __name__ == '__main__':
    os.environ.setdefault('OMP_NUM_THREADS', '1')
    main()
