"""The port's copy of the torch reference replica
(garment_pattern_estimation_torch/experiment/torch_reference.py) against the
JAX package's (garment_pattern_estimation_tpu/experiment/torch_reference.py),
the batches both parity CLIs materialize, and `--torch_cross_check` of both
CLIs, on the CPU.

Bars, with the gaps measured here:
  * the replica copy equals the JAX package's bit for bit: the weights
    `torch.manual_seed` draws, the forwards of the three models, every
    recipe loss term, and two epochs of `train_reference_torch` /
    `train_reference_stitch_torch` (loss histories and final state dicts)
    (measured: equal);
  * the port CLI's materialized training and validation batches equal the
    JAX CLI's bitwise, epoch after epoch (measured: equal);
  * `--torch_cross_check` on tests/test_parity_check.py's fixture:
    `torch_replica_metrics` within rtol 1e-6 of the JAX CLI's (measured: at
    most 5.0e-8 relative, one f32 rounding of the two metric stacks on the
    same replica predictions); every `torch:` row, the port's serving
    forward against the replica's as the JAX CLI holds its own, within the
    CLI's 1% (measured: 1.0e-4; the fused layer truncates its edge MLP's
    inputs to bf16); every `torch_f32:` row, the port's f32 forward, within
    1e-6 (measured: 1.3e-7); `_f32_metrics` keeps off the fused layer and
    `unfused_eval` restores the serving route after an error;
  * the `torch:` rows hold the forward the JAX CLI holds on a TPU: the JAX
    CLI with its fused layer (`fused_edgeconv_reference`, the kernel's
    numerics, tests/torch_serving_gap_witness.py) reads the port's serving
    metrics within rtol 1e-6 (measured: at most 7.1e-8; its gaps to the
    replica are the port's serving gaps, 1.0e-4 on rotation_l2);
  * a port checkpoint (no `feature_extractor.lin`) loads into the replica,
    the missing head's names printed, and any other missing entry raises.
"""
import contextlib
import json

import numpy as np
import pytest
import torch

from garment_pattern_estimation_torch.cli import parity_check as pt_parity
from garment_pattern_estimation_torch.experiment import torch_reference as pt_ref
from garment_pattern_estimation_tpu.experiment import torch_reference as jx_ref
from test_parity_check import parity_env  # noqa: F401  (the shared fixture)
from torch_serving_gap_witness import jax_fused_forward

REPLICA_RTOL = 1e-6
F32_FORWARD_REL = 1e-6
SERVING_RTOL = 1e-6

_SHAPE_KW = dict(max_pattern_len=5, max_panel_len=4, element_size=4, panel_encoding_size=12,
                 panel_hidden_size=12, panel_n_layers=2, econv_hidden=10,
                 econv_hidden_depth=2, econv_feature=9, k_neighbors=4, conv_depth=2,
                 skip_connections=True)
_MODELS = {
    'att': ('TorchGarmentSegmentPattern3D', _SHAPE_KW),
    'baseline': ('TorchGarmentFullPattern3D',
                 dict(_SHAPE_KW, pattern_encoding_size=10, pattern_hidden_size=10,
                      pattern_n_layers=2)),
    'stitch': ('TorchStitchOnEdge3DPairs', dict(pair_feature_len=16, hidden=12, n_layers=2)),
}


def _pair(name, seed=3):
    """The same replica from both packages, each built after
    torch.manual_seed(seed), as the CLIs build their inits."""
    cls, kwargs = _MODELS[name]
    out = []
    for module in (jx_ref, pt_ref):
        torch.manual_seed(seed)
        out.append(getattr(module, cls)(**kwargs))
    return out


def _shape_batch(rng, B=3, N=24, P=5, L=4, S=6):
    num_edges = rng.integers(2, L + 1, size=(B, P))
    return {'features': rng.normal(size=(B, N, 3)).astype(np.float32),
            'ground_truth': {
                'outlines': rng.normal(size=(B, P, L, 4)).astype(np.float32),
                'rotations': rng.normal(size=(B, P, 4)).astype(np.float32),
                'translations': rng.normal(size=(B, P, 3)).astype(np.float32),
                'num_edges': num_edges,
                'stitches': rng.integers(0, P * L, size=(B, 2, S)),
                'num_stitches': rng.integers(1, S + 1, size=(B,)),
                'free_edges_mask': rng.integers(0, 2, size=(B, P, L)).astype(bool)}}


def _stitch_batch(rng, B=3, pairs=10):
    return {'features': rng.normal(size=(B, pairs, 16)).astype(np.float32),
            'ground_truth': rng.integers(0, 2, size=(B, pairs)).astype(np.float32)}


def _assert_states_equal(a, b):
    assert list(a.state_dict()) == list(b.state_dict())
    for key, value in a.state_dict().items():
        assert torch.equal(value, b.state_dict()[key]), key


@pytest.mark.parametrize('name', sorted(_MODELS))
def test_replica_forwards_equal_the_jax_packages(name):
    jx, pt = _pair(name)
    _assert_states_equal(jx, pt)
    jx_ref.randomize_reference_weights(jx, seed=5)
    pt_ref.randomize_reference_weights(pt, seed=5)
    _assert_states_equal(jx, pt)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(_stitch_batch(rng)['features'] if name == 'stitch'
                         else _shape_batch(rng)['features'])
    for train in (False, True):
        jx.train(train)
        pt.train(train)
        with torch.no_grad():
            a, b = jx(x), pt(x)
        if name == 'stitch':
            assert torch.equal(a, b)
        else:
            assert list(a) == list(b)
            assert all(torch.equal(a[k], b[k]) for k in a), train


@pytest.mark.parametrize('hardnet', [False, True])
def test_recipe_losses_equal_the_jax_packages(hardnet):
    jx, pt = _pair('att')
    batch = _shape_batch(np.random.default_rng(1))
    with torch.no_grad():
        preds = pt(torch.from_numpy(batch['features']))
    pad = torch.tensor([0.1, -0.2, 0.0, 0.0])
    for with_stitches in (False, True):
        full_jx, terms_jx = jx_ref.torch_composed_loss(
            preds, jx_ref._torch_gt(batch['ground_truth']), pad, 0.7,
            with_stitches=with_stitches, stitch_margin=0.3, use_hardnet=hardnet)
        full_pt, terms_pt = pt_ref.torch_composed_loss(
            preds, pt_ref._torch_gt(batch['ground_truth'], torch.device('cpu')), pad, 0.7,
            with_stitches=with_stitches, stitch_margin=0.3, use_hardnet=hardnet)
        assert torch.equal(full_jx, full_pt)
        assert list(terms_jx) == list(terms_pt)
        assert all(torch.equal(terms_jx[k], terms_pt[k]) for k in terms_jx)


@pytest.mark.parametrize('name', ['att', 'baseline', 'stitch'])
def test_two_epochs_of_training_equal_the_jax_packages(name):
    """The recipe's loop, its best-validation restore included: loss
    histories and final state dicts bit for bit. The baseline trains
    through the stitch terms' epoch."""
    rng = np.random.default_rng(2)
    make = _stitch_batch if name == 'stitch' else _shape_batch
    epochs = [[make(rng) for _ in range(2)] for _ in range(2)]
    valid = [make(rng)]

    def schedule(step):
        return 1e-3 * (1 + step)

    histories = []
    models = _pair(name)
    for module, model in zip((jx_ref, pt_ref), models):
        if name == 'stitch':
            histories.append(module.train_reference_stitch_torch(
                model, epochs, schedule, valid_batches=valid))
        else:
            histories.append(module.train_reference_torch(
                model, epochs, schedule, np.array([0.1, -0.2, 0.0, 0.0], np.float32),
                loop_weight=0.5, valid_batches=valid,
                epoch_with_stitches=1 if name == 'baseline' else None))
    assert len(histories[0]) == 4
    assert histories[0] == histories[1]
    _assert_states_equal(*models)


def test_materialized_batches_equal_the_jax_clis(parity_env):  # noqa: F811
    """Three epochs of the training loader and the validation loader, as
    `_train_cross_check` materializes them: the same arrays, bitwise."""
    import argparse

    from garment_pattern_estimation_tpu.cli import parity_check as jx_parity

    _, data, shape_yaml, _, _, _ = parity_env
    args = argparse.Namespace(shape_config=str(shape_yaml), dataset_root=str(data),
                              max_datapoints=None, shape_pth='')
    jx_wrapper = jx_parity._build_shape_stack(args, load_checkpoint=False)[2]
    pt_wrapper = pt_parity._build_shape_stack(args, torch.device('cpu'),
                                              load_checkpoint=False)[2]
    for section in ('train',) * 3 + ('validation',):
        jx_batches = [b for b in getattr(jx_wrapper.loaders, section)]
        pt_batches = [pt_parity._host_batch(b) for b in getattr(pt_wrapper.loaders, section)]
        assert len(jx_batches) == len(pt_batches) > 0
        for theirs, ours in zip(jx_batches, pt_batches):
            assert np.array_equal(np.asarray(theirs['features'], np.float32), ours['features'])
            assert set(theirs['ground_truth']) == set(ours['ground_truth'])
            for key, value in theirs['ground_truth'].items():
                value = np.asarray(value)
                assert value.dtype == ours['ground_truth'][key].dtype, key
                assert np.array_equal(value, ours['ground_truth'][key]), key


@pytest.fixture(scope='module')
def cross_check_reports(parity_env, tmp_path_factory):  # noqa: F811
    from garment_pattern_estimation_tpu.cli import parity_check as jx_parity

    _, data, shape_yaml, shape_pth, _, _ = parity_env
    args = ['--dataset_root', str(data), '--shape_config', str(shape_yaml),
            '--shape_pth', str(shape_pth), '--torch_cross_check']
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, main, extra, context in (
                ('jax', jx_parity.main, [], contextlib.nullcontext),
                ('jax_fused', jx_parity.main, [], jax_fused_forward),
                ('port', pt_parity.main, ['--device', 'cpu'], contextlib.nullcontext)):
            work = tmp_path_factory.mktemp(f'cross_{name}')
            mp.chdir(work)
            with context():
                assert main(args + extra + ['--output', str(work / 'report.json')]) == 0
            out[name] = json.loads((work / 'report.json').read_text())
    return out


def _rows(report, label):
    return {c['metric'].split(':', 1)[1]: c for c in report['comparisons']
            if c['metric'].split(':', 1)[0] == label}


def test_torch_cross_check_matches_the_jax_cli(cross_check_reports):
    jax, port = cross_check_reports['jax'], cross_check_reports['port']
    assert set(port) == set(jax)
    assert set(port['torch_replica_metrics']) == set(jax['torch_replica_metrics']) \
        == set(pt_parity.SHAPE_METRICS)
    for key, value in jax['torch_replica_metrics'].items():
        assert port['torch_replica_metrics'][key] == pytest.approx(value, rel=REPLICA_RTOL,
                                                                   abs=1e-12), key
    for label in ('torch', 'torch_f32'):
        rows = _rows(port, label)
        assert set(rows) == set(pt_parity.SHAPE_METRICS)
        assert all(c['pass'] and c['bar'] == 0.01 for c in rows.values())
    # the serving forward is the port's `shape_metrics`, as the JAX CLI's
    # `torch:` rows read its own
    assert all(c['ours'] == port['shape_metrics'][k] for k, c in _rows(port, 'torch').items())
    # the port's f32 forward against the replica's: the same neighbours and
    # f32 arithmetic in another order
    assert all(c['delta'] <= F32_FORWARD_REL for c in _rows(port, 'torch_f32').values())


def test_torch_rows_hold_the_jax_clis_served_forward(cross_check_reports):
    """The JAX CLI with its fused layer (the forward a TPU serves and
    holds in its `torch:` rows) and the port's `torch:` rows: the same
    forward's metrics against the same replica's."""
    jax, port = cross_check_reports['jax_fused'], cross_check_reports['port']
    theirs, ours = _rows(jax, 'torch'), _rows(port, 'torch')
    assert set(theirs) == set(ours) == set(pt_parity.SHAPE_METRICS)
    for key, row in theirs.items():
        assert ours[key]['ours'] == pytest.approx(row['ours'], rel=SERVING_RTOL, abs=1e-12), key
        assert ours[key]['reference'] == pytest.approx(row['reference'], rel=REPLICA_RTOL,
                                                       abs=1e-12), key


def test_f32_metrics_keep_off_the_fused_layer(parity_env, monkeypatch):  # noqa: F811
    """`_f32_metrics` evaluates every EdgeConv layer without the fused
    layer (its bf16 edge-MLP inputs) and leaves `unfused_eval` off after;
    the serving forward (`eval_metrics`) takes the fused layer."""
    import argparse

    from garment_pattern_estimation_torch.models import blocks

    _, data, shape_yaml, shape_pth, _, _ = parity_env
    args = argparse.Namespace(shape_config=str(shape_yaml), dataset_root=str(data),
                              max_datapoints=None, shape_pth=str(shape_pth))
    _, _, wrapper, model, state = pt_parity._build_shape_stack(args, torch.device('cpu'))
    fused = []
    plain = blocks.fused_edgeconv

    def counted(*a, **kw):
        fused.append(1)
        return plain(*a, **kw)
    monkeypatch.setattr(blocks, 'fused_edgeconv', counted)
    f32 = pt_parity._f32_metrics(model, state, wrapper)
    assert not fused
    assert not blocks.UNFUSED_EVAL.get()
    serving = pt_parity.eval_metrics(model, state, wrapper, 'test')
    assert fused
    assert set(f32) == set(serving)


def test_unfused_eval_restores_after_an_error():
    """Inside `unfused_eval` an eval EdgeConv takes the knn_gather route;
    after the block, an exception included, the fused layer again."""
    from garment_pattern_estimation_torch.models import blocks

    torch.manual_seed(0)
    layer = blocks.EdgeConv(3, [8, 6], k=4).eval()
    x = torch.randn(2, 32, 3)
    with torch.no_grad():
        fused = layer(x)
        with pytest.raises(RuntimeError):
            with blocks.unfused_eval():
                unfused = layer(x)
                assert blocks.UNFUSED_EVAL.get()
                raise RuntimeError('inside the block')
        assert not blocks.UNFUSED_EVAL.get()
        assert torch.equal(layer(x), fused)
        assert torch.equal(layer(x, unfused=True), unfused)
        assert not torch.equal(unfused, fused)


def test_replica_loads_a_port_checkpoint(parity_env, capsys):  # noqa: F811
    """The port's state dict has no global-pool head; the replica takes it
    strictly but for that head, whose names are printed; another missing
    entry raises."""
    _, _, _, shape_pth, _, _ = parity_env
    from garment_pattern_estimation_torch.experiment import load_checkpoint_any

    state = load_checkpoint_any(shape_pth)['model']
    port_state = {k: v for k, v in state.items() if not k.startswith('feature_extractor.lin.')}
    replica = pt_ref.TorchGarmentSegmentPattern3D(
        max_pattern_len=9, max_panel_len=6, element_size=4, panel_encoding_size=16,
        panel_hidden_size=16, panel_n_layers=1, econv_hidden=12, econv_hidden_depth=1,
        econv_feature=10, k_neighbors=5, conv_depth=1, skip_connections=True)
    pt_parity._load_replica(replica, port_state)
    assert 'feature_extractor.lin.weight' in capsys.readouterr().out
    for key, value in port_state.items():
        assert torch.equal(replica.state_dict()[key], value), key
    del port_state['panel_dec_lin.bias']
    with pytest.raises(RuntimeError, match='panel_dec_lin.bias'):
        pt_parity._load_replica(replica, port_state)
