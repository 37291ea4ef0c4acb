"""Full-pipeline evaluation on the test set (seen or unseen garment types),
on the card unless `--device cpu` is given:

    python -m garment_pattern_estimation_torch.cli.on_test_set \
        -sh configs/att.yaml -st configs/stitch_model.yaml --predict

The port's counterpart of garment_pattern_estimation_tpu/cli/on_test_set.py,
flag for flag. Evaluates the shape model, optionally saves its predictions,
then evaluates the stitch model on those predictions (exhaustive edge pairs,
batch 1); `--pred_path` reuses saved predictions, `--unseen` switches to the
unseen garment-type folders, `--correct_panels` re-evaluates stitches only
on patterns with the correct number of panels.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from .common import load_yaml, make_experiment, system_properties
from ..device import resolve_device
from ..train import eval_metrics, make_predict_fn


def get_values_from_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('-sh', '--shape_config', type=str, default='./configs/att.yaml')
    parser.add_argument('-p', '--predict', action='store_true')
    parser.add_argument('-u', '--unseen', action='store_true')
    parser.add_argument('-st', '--stitch_config', type=str, default='')
    parser.add_argument('--pred_path', type=str, default='')
    parser.add_argument('-corr', '--correct_panels', action='store_true')
    parser.add_argument('--filetag', type=str, default='sim',
                        help="mesh variant to evaluate on ('sim' or 'scan')")
    parser.add_argument('--point_noise', type=float, default=0.0,
                        help='sampling noise width for the eval pass')
    parser.add_argument('--system', type=str, default='./system.json')
    parser.add_argument('--device', help="torch device (default: 'cuda'; 'cpu' runs "
                        'the plain PyTorch path)', type=str, default=None)
    args = parser.parse_args(argv)
    shape_config = load_yaml(args.shape_config)
    stitch_config = load_yaml(args.stitch_config) if args.stitch_config else None
    print(f'Command line args: {args}')
    return shape_config, stitch_config, args


def main(argv=None):
    shape_config, stitch_config, args = get_values_from_args(argv)
    system_info = system_properties(args.system)
    device = resolve_device(args.device)
    tag = 'unseen' if args.unseen else 'test'
    if args.filetag != 'sim':
        tag = f'{tag}_{args.filetag}'   # e.g. test_scan: keeps the sim statistics

    shape_prediction_path = None
    if not args.pred_path:
        shape_experiment = make_experiment(shape_config, system_info)
        if not shape_experiment.is_finished():
            print('Warning::Evaluating unfinished experiment')
        data_root = Path(system_info['datasets_path'])
        if args.unseen and (data_root / 'test').exists():
            data_root = data_root / 'test'
        eval_overrides = {'obj_filetag': args.filetag, 'point_noise_w': args.point_noise}
        # runs trained before `unseen_data_folders` existed in their config
        # take the folder list from the eval yaml
        unseen_folders = shape_config.get('dataset', {}).get('unseen_data_folders')
        if args.unseen and unseen_folders:
            eval_overrides['unseen_data_folders'] = unseen_folders
        shape_dataset, shape_wrapper = shape_experiment.load_dataset(
            data_root, eval_overrides, unseen=args.unseen)
        shape_model, shape_state = shape_experiment.load_model(shape_dataset.config,
                                                               device=device)

        section = 'full' if args.unseen else 'test'
        test_metrics = eval_metrics(shape_model, shape_state, shape_wrapper, section)
        test_breakdown = eval_metrics(shape_model, shape_state, shape_wrapper,
                                      f'{section}_per_data_folder')
        shape_experiment.add_statistic(f'{tag}_on_best', test_metrics, log=f'{tag} metrics')
        shape_experiment.add_statistic(tag, test_breakdown, log=f'{tag} metrics per dataset')

        if args.predict or stitch_config:
            predict_fn = make_predict_fn(shape_model, shape_state)
            shape_prediction_path = shape_experiment.prediction(
                Path(system_info['output']), predict_fn, shape_wrapper,
                nick=f'{tag}_pred', sections=[section])

    if stitch_config:
        subfolder = 'full' if args.unseen else 'test'
        in_datapath = Path(args.pred_path) / subfolder if args.pred_path \
            else Path(shape_prediction_path) / subfolder

        stitch_experiment = make_experiment(stitch_config, system_info)
        if not stitch_experiment.is_finished():
            print('Warning::Evaluating unfinished experiment')
        stitch_overrides = {}
        if args.unseen:
            # prediction folders keep the original dataset names, so the
            # unseen list is shared between the stages
            stitch_unseen = stitch_config.get('dataset', {}).get('unseen_data_folders') \
                or shape_config.get('dataset', {}).get('unseen_data_folders')
            if stitch_unseen:
                stitch_overrides['unseen_data_folders'] = stitch_unseen
        stitch_dataset, stitch_wrapper = stitch_experiment.load_dataset(
            in_datapath, stitch_overrides or None, unseen=args.unseen,
            batch_size=1, load_all=True)
        stitch_dataset.config.update(random_pairs_mode=False)  # all pairs at eval
        stitch_dataset._drop_cache()
        stitch_model, stitch_state = stitch_experiment.load_model(stitch_dataset.config,
                                                                  device=device)

        loss = eval_metrics(stitch_model, stitch_state, stitch_wrapper, 'full')
        breakdown = eval_metrics(stitch_model, stitch_state, stitch_wrapper,
                                 'full_per_data_folder')
        stitch_experiment.add_statistic(f'{tag}_preds_full', loss, log='Stitch metrics')
        stitch_experiment.add_statistic(f'{tag}_preds', breakdown,
                                        log='Stitch metrics per dataset')

        if args.predict:
            predict_logits = make_predict_fn(stitch_model, stitch_state, bucket_pairs=True)
            stitch_experiment.prediction(
                Path(system_info['output']), predict_logits, stitch_wrapper,
                nick=f'{tag}_pred', sections=['full'], model=predict_logits)

        if args.correct_panels:
            from ..data import DatasetWrapper, GarmentStitchPairsDataset
            corr_dataset = GarmentStitchPairsDataset(
                in_datapath, stitch_dataset.config, gt_caching=True,
                feature_caching=True, filter_correct_n_panels=True)
            corr_wrapper = DatasetWrapper(corr_dataset, batch_size=1)
            corr_metrics = eval_metrics(stitch_model, stitch_state, corr_wrapper, 'full')
            corr_breakdown = eval_metrics(stitch_model, stitch_state, corr_wrapper,
                                          'full_per_data_folder')
            stitch_experiment.add_statistic(f'{tag}_corr_full', corr_metrics,
                                            log='Metrics on correct patterns')
            stitch_experiment.add_statistic(f'{tag}_corr', corr_breakdown,
                                            log='Metrics on correct patterns per dataset')


if __name__ == '__main__':
    main()
