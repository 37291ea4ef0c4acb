"""The numbers that decide `correct`, each a gap between what the program
produced and what the reference works out, held to a limit of its own
(limits/<cell>.json).

Serving: for each output key, the widest gap over the checked clouds as a
share of the reference's largest magnitude in that key; for the attention
weights, one row per point, also the 99th percentile over the points.

Training, after the first steps: the widest relative gap of a step's loss;
and, by the worst leaf, the gap between the program's norm and the
reference's, of the first gradient as Adam got it, of each parameter's
change over the steps, and of each BatchNorm running statistic's change,
each against the larger of that leaf's reference norm and the median
leaf's. A parameter whose reference gradient is under a thousandth of the
median leaf's (a bias under a normalization, moved by round-off alone)
is left out of the change.
"""
from __future__ import annotations

import statistics

import torch

NEGLIGIBLE_GRADIENT = 1e-3


def output_gaps(program, reference, points=None):
    """{key: max |program - reference| / max |reference|} over the keys of
    `reference`, inf where the program lacks a key or is not finite; and
    for a key per point (its second axis `points` long), `key.p99`: the
    99th percentile over the points of each point's widest gap, on the same
    scale, which a near tie in a few points' neighbour choices does not
    move."""
    gaps = {}
    for key, ref in reference.items():
        got = program.get(key)
        if got is None or got.shape != ref.shape or not bool(torch.isfinite(got).all()):
            gaps[key] = float('inf')
            if points is not None and ref.dim() >= 3 and ref.shape[1] == points:
                gaps[f'{key}.p99'] = float('inf')
            continue
        scale = ref.abs().max().clamp_min(1e-30)
        diff = (got.float() - ref.float()).abs()
        gaps[key] = float(diff.max() / scale)
        if points is not None and ref.dim() >= 3 and ref.shape[1] == points:
            per_point = diff.reshape(ref.shape[0] * points, -1).amax(-1)
            gaps[f'{key}.p99'] = float(torch.quantile(per_point.double(), 0.99) / scale)
    return gaps


def norm_gaps(program, reference, names=None):
    """{name: |‖program‖ - ‖reference‖| / max(‖reference‖, median ‖reference‖)}
    over `names` (default every reference leaf)."""
    names = list(reference if names is None else names)
    norms = {n: float(reference[n].double().norm()) for n in reference}
    floor = statistics.median(norms.values())
    return {n: abs(float(program[n].double().norm()) - norms[n]) / max(norms[n], floor, 1e-30)
            for n in names}


def training_numbers(program, reference, initial):
    """The training cell's numbers. `program` and `reference` each hold
    'losses', 'grad1' (the first step's gradient by parameter), 'params'
    and 'buffers' (after the steps); `initial` the weights before them.
    Each of grad, change and running is given by its worst leaf and, as
    `<name>.median`, by its median leaf; `loss1` is the first step's."""
    losses = [abs(p - r) / max(abs(r), 1e-30)
              for p, r in zip(program['losses'], reference['losses'], strict=True)]
    if not all(x == x for x in program['losses']):
        losses = [float('inf')] * len(losses)
    grad_norms = {n: float(g.double().norm()) for n, g in reference['grad1'].items()}
    floor = statistics.median(grad_norms.values())
    moved = [n for n, g in grad_norms.items() if g >= NEGLIGIBLE_GRADIENT * floor]

    def change(state, key):
        return {n: state[key][n].double() - initial[n].double() for n in state[key]}

    gaps = {'grad': norm_gaps(program['grad1'], reference['grad1']),
            'change': norm_gaps(change(program, 'params'), change(reference, 'params'), moved),
            'running': norm_gaps(change(program, 'buffers'), change(reference, 'buffers'))}
    numbers = {'loss': max(losses), 'loss1': losses[0]}
    for name, by_leaf in gaps.items():
        numbers[name] = max(by_leaf.values())
        numbers[f'{name}.median'] = statistics.median(by_leaf.values())
    return numbers


def judge(numbers, limits):
    """(correct, {name: {'value', 'limit'}}) over the limited numbers: each
    at or under its limit; a limit whose number is missing fails."""
    checks = {name: {'value': numbers.get(name, float('inf')), 'limit': limit}
              for name, limit in limits.items()}
    return all(c['value'] <= c['limit'] for c in checks.values()), checks
