"""Registers and spills of two checkouts' CUDA kernels, instance by instance.

    python3 ptxas_ab.py _checkout/parent .

Builds every CUDA source of both trees at once (each tree's own
`ops/_build.py`, into its own `_build/`; `nvcc -Xptxas -v`), then prints one
JSON line per tree with each library's build seconds, and one line that
compares them: how many instances of tree A tree B has with the same
[registers, spill store bytes, spill load bytes], the instances whose usage
differs, and tree B's instances that tree A lacks with their usage. Needs
nvcc (the card's machine); exits non-zero if an instance of A changed or is
missing in B.
"""
import importlib.util
import json
import sys
import threading
from pathlib import Path

from chip_smoke import ptxas_usage


def build(tree, reports):
    """Every library of the checkout at `tree`, built by its own _build.py."""
    spec = importlib.util.spec_from_file_location(
        f'_build_{len(reports)}', Path(tree) / 'garment_pattern_estimation_torch/ops/_build.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    reports[tree] = module.build_all()


def main():
    trees = sys.argv[1:3]
    if len(trees) != 2:
        sys.exit(__doc__)
    reports = {}
    threads = [threading.Thread(target=build, args=(tree, reports)) for tree in trees]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    usage = {}
    for tree in trees:
        if tree not in reports:
            sys.exit(f'ptxas_ab: the build of {tree} failed')
        usage[tree] = {lib: ptxas_usage(r['log']) for lib, r in reports[tree].items()}
        print(json.dumps({'tree': tree, 'build_seconds': {
            lib: r['seconds'] for lib, r in reports[tree].items()}}), flush=True)
    a, b = (usage[tree] for tree in trees)
    same, changed, added = 0, {}, {}
    for lib, instances in a.items():
        for name, use in instances.items():
            if b.get(lib, {}).get(name) == use:
                same += 1
            else:
                changed[f'{lib}:{name}'] = [use, b.get(lib, {}).get(name)]
    for lib, instances in b.items():
        added.update({f'{lib}:{name}': use for name, use in instances.items()
                      if name not in a.get(lib, {})})
    print(json.dumps({'instances_a': sum(len(i) for i in a.values()), 'same_in_b': same,
                      'changed': changed, 'added_in_b': added}), flush=True)
    sys.exit(1 if changed else 0)


if __name__ == '__main__':
    main()
