"""The plain reference against the port's CPU path (its kernels' plain
versions) at a small size, and the control against the reference."""
import json

import pytest
import torch

from benchmark import common, traffic
from benchmark.reference import compare, model as reference

MESHES = 'parity_run/data_big/*/*/*_sim.obj'


def config(name):
    return json.loads((common.HERE / 'configs' / f'{name}.json').read_text())


@pytest.mark.parametrize('name', ['att', 'baseline'])
def test_served_forward_matches_the_port(name):
    from garment_pattern_estimation_torch.experiment import build_serving_fn
    from garment_pattern_estimation_torch.models import build_model

    cfg = config(name)
    weights = reference.make_weights(cfg, 21, 'cpu')
    model = build_model(cfg['model'], cfg['data'], cfg['NN'], cfg['loss'], device='cpu')
    model.module.load_state_dict(weights, strict=True)
    model.module.eval()
    clouds, _ = traffic.MeshBank(MESHES, 'cpu').sample(3, 300, torch.Generator().manual_seed(2))
    got = build_serving_fn(model, cfg['data'])(clouds)
    expected = reference.Reference(cfg, weights).serve(clouds)
    assert sorted(got) == sorted(expected)
    gaps = compare.output_gaps(got, expected)
    for key, gap in gaps.items():
        assert gap < (3e-2 if key == 'att_weights' else 1e-3), (key, gap)
    control = compare.output_gaps(reference.Reference(cfg, weights, lowered=True).serve(clouds),
                                  expected)
    assert max(control[k] for k in gaps if k != 'att_weights') > 3e-3


def test_training_steps_match_the_port():
    from garment_pattern_estimation_torch.models import build_model
    from garment_pattern_estimation_torch.train.trainer import Trainer

    cfg = config('att')
    weights = reference.make_weights(cfg, 7, 'cpu')
    pool = traffic.training_pool({'meshes': MESHES, 'pool_batches': 3, 'batch': 4,
                                  'points': 256}, cfg['data'], 11, 'cpu')
    model = build_model(cfg['model'], cfg['data'], cfg['NN'], cfg['loss'], device='cpu')
    model.module.load_state_dict(weights, strict=True)
    trainer = Trainer(cfg['trainer'], device='cpu')
    optimizer = trainer.make_optimizer(model, 600)
    params = dict(model.module.named_parameters())
    program = {'losses': []}
    for step in range(3):
        loss, _ = trainer.train_step(model, pool[step], 0,
                                     torch.Generator().manual_seed(100 + step))
        program['losses'].append(loss.item())
        if step == 0:
            program['grad1'] = {n: optimizer.state[p]['exp_avg'] / 0.1 for n, p in params.items()}
    program['params'] = {n: p.detach().clone() for n, p in params.items()}
    program['buffers'] = {n: b.clone() for n, b in model.module.named_buffers()
                          if n.endswith(('running_mean', 'running_var'))}
    lrs = [reference.onecycle_lr(i, 350 * 600, 0.002) for i in range(3)]

    def ref(lowered):
        gens = [torch.Generator().manual_seed(100 + i) for i in range(3)]
        return reference.train_steps(cfg, weights, pool[:3], gens, lrs, lowered=lowered)

    expected = ref(False)
    numbers = compare.training_numbers(program, expected, weights)
    assert numbers['loss'] < 1e-3 and numbers['grad'] < 1e-2 and numbers['running'] < 1e-3
    control = compare.training_numbers(ref(True), expected, weights)
    assert control['grad'] > 3 * numbers['grad']


def test_onecycle_lr_ends():
    assert reference.onecycle_lr(0, 100, 1.0) == pytest.approx(1 / 25)
    assert reference.onecycle_lr(30, 100, 1.0) == pytest.approx(1.0)
    assert reference.onecycle_lr(100, 100, 1.0) == pytest.approx(1 / 25 / 1e4)


def test_rounding_helpers():
    x = torch.tensor([1.0 + 2 ** -12, 1.0 + 2 ** -9, -3.0 - 2 ** -20])
    assert reference.round_tf32(x).tolist() == [1.0, 1.0 + 2 ** -9, -3.0]
    assert reference.truncate_bf16(torch.tensor([1.0 + 2 ** -8 - 2 ** -20])).item() == 1.0
    assert torch.allclose(reference.fp8(torch.tensor([448.0, 1.0])), torch.tensor([448.0, 1.0]))
