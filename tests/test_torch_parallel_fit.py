"""`cli.train` under 2 gloo ranks, as `torchrun --nproc_per_node=2` starts
it, against one process; the `trainer.mesh` checks of `Trainer.fit`; and
`parallel.dryrun.dryrun_multichip(2)`.

The tiny attention model on the synthetic root (batch 4, one epoch, zero
LSTM states): the training batches divide over 2 ranks and the validation
batch of 3 is padded to 4, which an eval step with running statistics and
zero states does not see. The first epoch's validation loss is held within
1e-4 relative of one process's, the bar parity_run/multichip_train_demo.py
holds the JAX trainer to (f32 sums of the ranks' shares in another order,
through 2 Adam steps).
"""
import json
import os
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_parallel_ranks as ranks
from garment_pattern_estimation_torch import data as pt_data
from garment_pattern_estimation_torch.cli import train as train_cli
from garment_pattern_estimation_torch.experiment import ExperimentWrappper
from garment_pattern_estimation_torch.models import build_model
from garment_pattern_estimation_torch.parallel.dryrun import dryrun_multichip
from garment_pattern_estimation_torch.train import Trainer

torch.set_num_threads(1)

def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _workdir(root, workdir, mesh):
    return ranks.cli_workdir(root, workdir, mesh) + ['--device', 'cpu']


@pytest.fixture(scope='module')
def cli_runs(synthetic_dataset_root, tmp_path_factory):
    """The train CLI in one process, then under 2 gloo ranks."""
    work = tmp_path_factory.mktemp('dp_cli')
    argv = _workdir(synthetic_dataset_root, work / 'one', None)
    cwd = os.getcwd()
    os.chdir(work / 'one')
    try:
        train_cli.main(argv)
    finally:
        os.chdir(cwd)
    argv = _workdir(synthetic_dataset_root, work / 'two', {'data': 2})
    mp.start_processes(ranks.cli_rank, args=(2, _free_port(), argv, str(work / 'two')),
                       nprocs=2, start_method='spawn', join=True)
    return ranks.cli_run_files(work / 'one'), ranks.cli_run_files(work / 'two')


def test_cli_two_ranks_match_one_process(cli_runs):
    (one, _), (two, _) = cli_runs
    valid_one, steps_one = ranks.cli_losses(one)
    valid_two, steps_two = ranks.cli_losses(two)
    assert len(valid_one) == len(valid_two) == 1 and len(steps_two) == len(steps_one) == 2
    np.testing.assert_allclose(valid_two, valid_one, rtol=1e-4)
    np.testing.assert_allclose(steps_two[0], steps_one[0], rtol=1e-5)


def test_cli_first_rank_alone_writes(cli_runs):
    """One run directory with the same files as the one-process run's, each
    record written once, and the final evaluation's keys."""
    (one, files_one), (two, files_two) = cli_runs
    assert files_two == files_one
    assert (two / 'finished.marker').exists()
    summary = json.loads((two / 'summary.json').read_text())
    assert {'valid_on_best.full_loss', 'test_on_best.full_loss'} <= set(summary)
    assert json.loads((two / 'config.json').read_text())['trainer']['mesh'] == {'data': 2}


def test_cli_points_sharded_fit_matches_one_process(cli_runs, synthetic_dataset_root,
                                                    tmp_path):
    """`Trainer.fit` through the CLI under 2 gloo ranks at
    `trainer.mesh: {data: 1, points: 2}` (each rank 30 of every cloud's 60
    points): both steps' losses within rtol 2e-5 of the one-process run's
    (the bar of tests/test_multichip.py:204), the same files written once,
    and the validation loss within 1e-3 relative of one process's: the
    sharded eval runs the ring and the f32 edge MLP, the one-process eval
    the fused layer's bf16 one, and the two differ by 2.85e-4 here."""
    (one, files_one), _ = cli_runs
    argv = _workdir(synthetic_dataset_root, tmp_path / 'points', {'data': 1, 'points': 2})
    mp.start_processes(ranks.cli_rank, args=(2, _free_port(), argv, str(tmp_path / 'points')),
                       nprocs=2, start_method='spawn', join=True)
    run, files = ranks.cli_run_files(tmp_path / 'points')
    valid_one, steps_one = ranks.cli_losses(one)
    valid, steps = ranks.cli_losses(run)
    assert files == files_one and len(steps) == len(steps_one) == 2
    np.testing.assert_allclose(steps, steps_one, rtol=2e-5)
    assert len(valid) == 1
    np.testing.assert_allclose(valid, valid_one, rtol=1e-3)
    assert json.loads((run / 'config.json').read_text())['trainer']['mesh'] == \
        {'data': 1, 'points': 2}


def test_cli_points_sharded_fit_logs_whole_attention_weights(synthetic_dataset_root,
                                                             tmp_path):
    """`trainer.with_visualization` under `trainer.mesh: {data: 1, points:
    2}`: every rank runs the images' forward on its 30 points of each
    cloud, the attention weights are gathered over the points ranks, and
    the first rank writes each one's weights for the whole 60-point cloud,
    one sparsemax row per point (each sums to 1)."""
    argv = ranks.cli_workdir(synthetic_dataset_root, tmp_path / 'viz', {'data': 1, 'points': 2},
                             trainer={'with_visualization': True}) + ['--device', 'cpu']
    mp.start_processes(ranks.cli_rank, args=(2, _free_port(), argv, str(tmp_path / 'viz')),
                       nprocs=2, start_method='spawn', join=True)
    run, _ = ranks.cli_run_files(tmp_path / 'viz')
    weights = sorted((run / 'intermediate_preds').rglob('*_att_weights.txt'))
    assert len(weights) == len(ranks.CLI_FOLDERS)
    for path in weights:
        att = np.loadtxt(path)
        assert att.shape[0] == ranks.CLI_CONFIG['dataset']['mesh_samples']
        np.testing.assert_allclose(att.sum(axis=1), 1.0, rtol=1e-5)


@pytest.mark.parametrize('mesh,error,match', [
    ({'data': 1, 'points': 2}, ValueError, 'torchrun --standalone --nproc_per_node=2'),
    ({'data': 2}, ValueError, 'torchrun --standalone --nproc_per_node=2'),
], ids=['points', 'data_not_world'])
def test_fit_refuses_meshes_it_cannot_run(synthetic_dataset_root, tmp_path, mesh, error, match):
    """`trainer.mesh.points > 1` without its d p processes raises instead of
    training on one card, and so does a `data` other than the number of
    processes; no run starts."""
    dataset = pt_data.Garment3DPatternFullDataset(
        synthetic_dataset_root, {'data_folders': ranks.CLI_FOLDERS, 'mesh_samples': 60},
        gt_caching=True, feature_caching=True)
    experiment = ExperimentWrappper({'experiment': {'project_name': 'p', 'run_name': 'r'}},
                                    output_root=tmp_path)
    trainer = Trainer(dict(ranks.CLI_CONFIG['trainer'], mesh=mesh), experiment, dataset,
                      dict(ranks.CLI_CONFIG['data_split']), device='cpu')
    model = build_model('GarmentSegmentPattern3D', dataset.config, ranks.CLI_CONFIG['NN'],
                        device='cpu')
    with pytest.raises(error, match=match):
        trainer.fit(model)
    assert experiment.run_id is None and not any(tmp_path.iterdir())


def test_dryrun_multichip_two_ranks(capfd):
    dryrun_multichip(2, device='cpu')
    assert 'dryrun_multichip::ok' in capfd.readouterr().out


def test_dryrun_multichip_refuses_missing_cards():
    """Without device='cpu' the dry run wants one card per rank: one rank
    more than the host has cards raises rather than move to the CPU."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_multichip(cards + 1)
