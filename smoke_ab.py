"""Same-card A/B of two checkouts' chip_smoke.py, for a kernel change.

    python3 smoke_ab.py _checkout/parent _checkout/final

Runs each tree's chip_smoke.py in the order A, B, B, A, a process per run
(each builds its own kernels), keeps every run's standard output under
chiprun_out/smoke_ab/, and prints one JSON line per run: its exit code,
each kernel's ms, bound_ms and launches from the kernels line, and the
end-to-end numbers (att serving batch ms, att training step ms, stress
serving batch ms and peak GB, stress training step ms and peak GB, the
fit phases' seconds where the tree has them), and the tiled layers' selection / edge-MLP split where the run prints one. Then
the card's name and power limit. Exits non-zero if any run failed.
"""
import json
import subprocess
import sys
from pathlib import Path

ORDER = (0, 1, 1, 0)
END_TO_END = {'serving': ('batch_ms',), 'training': ('step_ms',),
              'stress_serving': ('batch_ms', 'peak_memory_gb'),
              'stress_training': ('step_ms', 'peak_memory_gb'),
              'fit': ('fit_s',), 'fit_bf16': ('fit_s',)}


def summary(stdout):
    """The kernels line and the end-to-end numbers of one chip_smoke.py run."""
    out = {}
    for line in stdout.splitlines():
        if not line.startswith('{'):
            continue
        record = json.loads(line)
        if 'kernels' in record:
            out['kernels'] = {k['name']: {'ms': k['ms'], 'bound_ms': k['bound_ms'],
                                          'launches': k['launches']}
                              for k in record['kernels']}
        phase = record.get('phase')
        if phase == 'split':
            out['split'] = {name: {'selection_ms': v['selection_ms'], 'mlp_ms': v['mlp_ms']}
                            for name, v in record.items() if isinstance(v, dict)}
        if phase in END_TO_END:
            out.update({f'{phase}.{key}': record[key] for key in END_TO_END[phase]})
    return out


def main():
    trees = [Path(t).resolve() for t in sys.argv[1:3]]
    if len(trees) != 2 or not all((t / 'chip_smoke.py').exists() for t in trees):
        sys.exit('usage: smoke_ab.py TREE_A TREE_B (each holding chip_smoke.py)')
    out_dir = Path('chiprun_out/smoke_ab')
    out_dir.mkdir(parents=True, exist_ok=True)
    failed = False
    for run, which in enumerate(ORDER):
        proc = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=trees[which],
                              capture_output=True, text=True, timeout=1100)
        (out_dir / f'run{run}_{"AB"[which]}.txt').write_text(proc.stdout + proc.stderr)
        failed |= proc.returncode != 0
        print(json.dumps({'run': run, 'tree': "AB"[which], 'path': str(trees[which]),
                          'rc': proc.returncode, **summary(proc.stdout)}), flush=True)
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    sys.exit(1 if failed else 0)


if __name__ == '__main__':
    main()
