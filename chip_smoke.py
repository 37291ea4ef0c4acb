"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --stitch_pairs_seed S    # stitch_pipeline on a printed pair draw
    CUDA_VISIBLE_DEVICES=0,1,2,3 python3 chip_smoke.py --parallel_only   # multi-card host

With no arguments it needs one card, and runs every phase below; with more
cards visible the parallel phases take them (see parallel_fit,
parallel_ring, points_sharded). `--parallel_only` runs the build, the att
f32 fit and the parallel phases alone.

Phases, one JSON line each:
  build    builds every CUDA source of the port (one nvcc each, in parallel)
  kernel   each single-tile fused EdgeConv variant against its plain PyTorch
           version at the attention model's shapes: (64, 2000, 3) -> 150
           (conv0, small C) and (64, 2000, 150) -> 150 (conv1, wide C), k = 5, folded
           weights from a seeded torch.Generator with non-trivial BatchNorm
           statistics. Neighbour-id agreement (1.0 for small C; for wide C
           at least 0.99, every disagreement a near tie), the output against
           the plain MLP tail on the kernel's own neighbours and against the
           whole plain layer where the ids agree, the kernel's and the plain
           version's times (CUDA events, median of 20 after warm-up)
  knn_gather  the knn_gather forward at (30, 2000, 3) and (30, 2000, 150)
           and its backward at (30, 2000, 150), k = 5, the training step's
           shapes, against the plain PyTorch versions: ids as above, gathered
           rows bitwise equal where the ids agree, dx within 1e-5 of its
           largest magnitude of the plain index_add_ on the kernel's ids
           (summed in f64: CUDA's f32 index_add_ sums in a changing order),
           two backward runs bitwise equal and equal to the ordered sum
           (`knn_gather_backward_ordered`); kernel, plain and library
           (one index_add_, backward only) times, the backward's two
           kernels' device ms apart (torch.profiler)
  knn_gather_bwd_sweep  the backward at N in {1, 31, 32, 33, 2048}, k in
           {1, 2, 3, 5, 8, 9, 16}, C in {3, 24, 150, 256}, both chunk counts,
           and on hub ids
           (one point in every query's slots >= 1): repeatable, ordered,
           within 1e-5 of the plain version summed in f64
  kernel_k10, knn_gather_k10  the kernels at k = 10 (the one instance for
           k = 9..16) at the pool10 variant's shapes, each against its plain
           version with the bars above: rows 4-5 at (64, 2000, 3) 64-64-32,
           (64, 200, 32) 128 x 3 and (64, 20, 128) 256 x 3; row 2 at (64,
           2000, 32) and (64, 200, 128), and DynamicGraphPool on the card
           given the kernel's ids against its plain version on the CPU (the
           same kept ids, values within 1e-5); row 1 on (4, 10000, 3); row 8
           at (30, 2000, 3), rows 8-9 at (30, 200, 32) and (30, 20, 128)
  serving  build_model at the published att.yaml widths (seeded init),
           build_serving_fn on a (64, 2000, 3) batch: output shapes and
           finiteness, 2 kernel launches per forward (conv0 + conv1), batch
           time and clouds/s, and a 2-cloud batch against the same model's
           plain path on the CPU
  training build_model with the att.yaml loss on the card, Trainer with the
           att.yaml optimizer and schedule (Adam, the one-cycle warm-up's
           first steps), TRAIN_STEPS steps on one seeded (30, 2000, 3) batch
           with ground truth in the dataset's shapes: finite losses, the
           last below the first, exactly 1 + 1 + 1 knn_gather launches and
           no fused launch per step, median step time and clouds/s, one
           eval_step through the fused kernel (2 launches), and a 2-cloud
           step against the CPU plain path from the same weights: loss
           within 1e-3 relative, the whole gradient within 1e-2 of its norm
           and each parameter's within 5e-2 of its norm. Near-tie wide-C
           ids, ReLU and sparsemax boundaries make the gradient itself
           jumpy, most of all element by element, so the bars are on norms;
           the phase measures the floor, the CPU path against itself on the
           cloud perturbed by 1e-7 relative, and prints it beside the card's
           gap
  knn      the standalone kNN entry `ops.knn.knn` on the stress batch
           (128, 10000, 3), k = 5: one call as a user makes it (its launch
           count), then its ids on the first 4 clouds against the plain
           version (all equal), kernel, plain and library (torch.cdist +
           torch.topk, two calls whose ties differ) times
  kernel   the column-tiled fused EdgeConv variants at the stress shapes,
           (128, 10000, 3) -> 150 and (128, 10000, 150) -> 150 (conv1 on
           conv0's output), the kernel on the whole batch, checked as above
           on its first 4 clouds
  split    each tiled layer's ms split into selection and edge MLP: row
           6's selection is the knn phase's kernel (the same select_small_c
           instantiation), row 7's its own first launch (`fused_edgeconv_select`,
           select_stream on Hopper's TMA and wgmma), whose ids must equal the
           layer's
  integer_clouds  the streaming wide selection (select_stream) on clouds of
           integer coordinates in [-8, 8], where every product and partial
           sum is exact: the tiled fused layer's ids (C = 150) and the
           wide-D kNN's (D = 150) at k = 5 and 16 on (4, 10000, 150) and
           (3, 4099, 150) (a ragged query block and key tile) equal the
           plain version's bit for bit
  stress_serving  build_serving_fn at the att widths on a (128, 10000, 3)
           batch: shapes and finiteness, exactly 1 + 1 tiled launches and no
           single-tile launch per forward, batch time, clouds/s and peak
           device memory, and a 1-cloud batch against the CPU plain path
  knn_wide the wide-D kNN entry `ops.knn.knn` on the stress conv0 output
           (128, 10000, 150), k = 5, the chunked training's conv1 kNN: one
           call as a user makes it (its launch count), its ids on the first
           4 clouds against the plain version (at least WIDE_ID_AGREEMENT
           equal, every disagreement a near tie of the exact distances),
           kernel, plain and library (torch.cdist + torch.topk) times
  stress_training  build_model + Trainer with the att loss and optimizer on
           a seeded (128, 10000, 3) batch with ground truth in the dataset's
           shapes, STRESS_TRAIN_STEPS steps through the chunked EdgeConv
           sweeps: finite losses, the last below the first, exactly 1 knn +
           1 knn_wide launch and no knn_gather or fused launch per step,
           median step time, clouds/s and peak device memory; then a 1-cloud
           step with chunking forced (chunks of 2048, the last one padded)
           against the CPU plain path from the same weights, with the
           training phase's loss and norm bars and the CPU's own 1e-7 noise
           floor beside it
  profile  one serving forward, one training step, one stress forward and
           one stress training step under torch.profiler: device time by
           kernel and by class of kernel (the port's kernels, matrix
           products, reductions, index gathers and scatters, elementwise
           passes, copies) and the device's idle share
The bf16 mixed-precision mode (configs/att_bf16.yaml, `compute_dtype:
bfloat16`) has phases of its own, at the same widths and shapes:
  kernel_bf16      rows 4-7 with mlp_dtype=bfloat16 (wide rows gathered as
           their top truncation chunk), checked as `kernel` above (the tiled
           ones on the stress shapes, on their first CHUNK clouds)
  knn_gather_bf16  the knn_gather forward at value_chunks=1 on (30, 2000, 3)
           and (30, 2000, 150), and its single-chunk backward ('bwd_hi',
           slots >= 1 truncated to bf16) on (30, 2000, 150) with cotangents
           that are not bf16-valued: the knn_gather bars above, and the
           truncation must move dx
  serving_bf16 / stress_serving_bf16  the served bf16 model, checked as the
           f32 phases, with the same bars
  training_bf16  as `training`, with 1 + 1 forward and 1 'bwd_hi' knn_gather
           launch per step; the 2-cloud step's loss bar as in f32, its
           gradient bars the larger of the f32 bars and twice the CPU's own
           order floor: the CPU path against itself with the two clouds in
           the other batch order (the same math, each sum in another
           order), which in bf16 alone moves the gradient by about as much
           as the card does (compare_step_cpu)
  stress_training_bf16  as `stress_training` in 'fused_final', then one
           'streamed' step (its ms and peak memory); the forced-chunk step
           against the CPU on 2 clouds, with training_bf16's bars
  profile  the four profiles above, of the bf16 model
Then Trainer.fit over a dataset (ROADMAP queue A item 1):
  fit      parity_run/data_big (3 folders x 100 garments, 2000 points,
           padded to 23 x 14), batch 30, split 10 / 10 per type, att.yaml's
           model, loss, Adam and one-cycle, standardization from the
           training split: FIT_EPOCHS epochs, then a second Trainer resumes
           for one more. Per epoch: wall s, the batch loop's ms per step,
           the median host ms of a step, the share spent waiting on the
           loader, train and validation loss; ms per step of train_step on
           a batch on the card, on a host batch, and over the loader
           without and with its prefetch thread. Checks: finite losses, the
           mean train loss falls, exact launches of rows 4-5 (one each per
           validation batch) and 8-9 (one each per step), fit's first step
           against Trainer.train_step on the same batch from the same
           weights (1e-6 relative), 'best' and 'latest' load back, the
           resumed run continues the step count and the schedule
  fit_bf16 the same model in the bf16 mode with f32_tail_epochs 1 over
           FIT_EPOCHS epochs: the tail on at the last epoch ('bwd' launches
           there, 'bwd_hi' before), finite losses
The baseline model GarmentFullPattern3D (configs/lstm_stitch_tags.yaml,
f32: global encoder, a 2-layer pattern LSTM unrolling 23 panel encodings,
the 3-layer panel LSTM; its loss with panel-order and loop-origin matching,
the stitch-tag loss, free-edge classification and stitch precision/recall)
at its published widths, seeded weights, between the bf16 phases and fit:
  serving_lstm  build_serving_fn on the (64, 2000, 3) batch of seed 1, as
           `serving`: 2 fused launches per forward, batch ms (median after
           the first call), clouds/s, peak memory, a 2-cloud batch against
           the CPU plain path at the serving bars
  training_lstm  one (30, 2000, 3) batch of seed 4 whose GT adds the
           dataset's stitches, stitch counts, free-edge and empty-panel
           masks (empty panels with zero placements: their order-matching
           distances tie exactly): LSTM_TRAIN_STEPS steps at epoch 0, then
           LSTM_TRAIN_STEPS at epoch 40 (the stitch phase): 1 + 1 + 1
           knn_gather launches per step, median ms of each phase and their
           difference (the stitch terms and the 161-step stitch decode of
           the quality metrics), the loss alone in each phase, one eval_step
           through the fused kernel, the stitch terms present only at epoch
           40, and a 2-cloud step against the CPU plain path in each phase
           at the training phase's bars
  profile  the epoch-40 training step of the baseline
  fit_lstm `fit` of the baseline on the same data and split, its loss
           section with `epoch_with_stitches` cut from 40 to 1 so that the
           stitch phase and its 'best' reset are reached within the
           FIT_EPOCHS epochs, then 1 resumed epoch: epoch s, ms per step,
           the mean train loss per epoch (the shape terms must fall) and the
           training steps' stitch recall
The alternative encoders and decoders (ROADMAP queue A item 7), after
training_lstm: the baseline with each variant's NN keys (ENCODER_VARIANTS)
at full width:
  encoders_decoders  per variant (pool10: EdgeConvPoolingFeatures at k 10,
           GRU panel and double-reverse LSTM pattern decoders; gpool: graph
           pooling; aggr_mean, aggr_add; pointnet: PointNet++ and MLP
           decoders) SERVE_CALLS served batches (batch ms, clouds/s, peak
           memory, exactly VARIANT_LAUNCHES' launches per forward, by shape
           too), a 2-cloud batch against the CPU plain path, one profiled
           serving call, VARIANT_STEPS training steps (step ms, the launches
           per step, finite losses) and a step against the CPU plain path
           on the card's kNN, pool, ReLU and max choices (pointnet: 4
           clouds, gradient bars scaled to the CPU's own 1e-7 noise
           floor); then the attention model with pool10's encoder,
           served once (its attention weights over the 20 pooled points),
           and farthest_point_sampling alone at pointnet's (64, 2000, 3):
           host ms, device ms and kernel launches per call
The on-device sampling mode (dataset.on_device_sampling,
preprocess/device_sampling.py), after encoders_decoders:
  device_sampling  the sampling stage on 64 meshes of bench.py's
           construction (4096 vertices, 8192 faces; labels drawn after
           them), 2000 points, point_noise_w 0.01, against its CPU core on
           the same draws: face ids equal but within 1e-6 of the total area
           of a step of the cumulative areas or the two devices' own gap on
           the steps (count printed), points within 1e-5 of the mesh extent
           where the ids agree, snap ids equal but near ties of the f64
           distances (count printed), labels equal there; the stage's ms
           with and without the snap (CUDA events, median of 20) and peak
           memory
  mesh_to_prediction, mesh_to_prediction_bf16  make_predict_fn with the
           sampler on those meshes, att at the published widths (f32, bf16):
           shapes and finiteness, exactly 1 + 1 fused launches per call, no
           snap; ms per batch (median after the first of 11), clouds/s, peak
           memory, and the forward alone on one of the stage's clouds
after fit_lstm, data parallelism over torch.distributed (parallel/), each
line with `ranks`, R = torch.cuda.device_count() (one card: a world-1 NCCL
group over a TCP store on 127.0.0.1, in this process; more: R NCCL ranks
spawned, one card each, and the world-1 group still serves parallel_ring
below four cards):
  parallel_fit  `Trainer.fit` of the att f32 fit cell (the same data, split,
           seed, weights and schedule) with trainer.mesh {data: R}, stopped
           after its first epoch's validation. R = 1: every step's loss
           against the fit run's epoch 0 (the first within 1e-5 relative),
           the validation loss within 1e-4 relative. R >= 2: against one
           process on the batches padded to R, whose steps take the ranks'
           kNN choices (each of the first step's held to the plain
           version): the first step's gradient within 1e-5 of its norm,
           the first 4 steps' losses within 1e-5 relative and the
           validation loss within 1e-4, or twice the largest gap one
           process's run on the same choices takes when its clouds are
           scaled by 1 + 1e-7 noise (three draws) where that is larger:
           R ranks sum each statistic and gradient in another order. Rows
           8-9 once per step and rows 4-5 once per validation batch as in
           fit, ms per step beside fit's epoch 0 (the collectives' cost at
           this R)
  parallel_ring  the ring over P = 4 shards of (8, 2000, 3) and (8, 2000,
           150) clouds (four or more cards: `ring_knn_gather` on 4 NCCL
           ranks, a shard and a card each; fewer: `parallel.ring._ring_merge`
           driven over the shards in ring order on one card): ids
           against `knn_gather_reference` on the whole cloud (at least 99%
           equal, every difference within one 21-bit bucket of the exact
           distance plus 2^-15 of the squared norms: the plain version ranks
           per-dimension sums for small C and split bf16 products for wide
           C, the ring the f32 norm expansion, as JAX's does), rows equal to
           the gathered cloud; `sharded_encoder_step` over the 4 ranks or
           the world-1 group (att's two EdgeConv layers, 8 x 2000 points)
           within 2e-4 of scale
           of the same layers unsharded in plain f32, the JAX ring tests'
           bar (the fused kernels round the edge MLP to bf16: their gap is
           printed)
and then:
  fit_on_device  `fit` as the att f32 fit with on_device_sampling at the
           default caps (8192 / 16384) and trainer.profile {start_step: 2,
           num_steps: 2}: finite losses, a new cloud every step and one per
           epoch for validation (seeds and draws agree), exact launches of
           rows 4-5 and 8-9, no snap, checkpoints load back, the window's
           Chrome trace names rows 8-9's kernels; per epoch the batch loop's
           ms per step and loader-wait share beside the host-sampled fit's
Then the two-stage pipeline of configs/stitch_model.yaml on the att f32
fit run:
  stitch_pipeline  (0) the run resumed to STITCH_SHAPE_EPOCHS epochs (on
           the 3-epoch run no predicted pattern keeps its stitches): 1 + 1
           fused launches per validation batch, 1 + 1 + 1 knn_gather
           launches per step; (1) the run's dataset and best model rebuilt, every
           split section predicted (1 + 1 fused launches per batch of 30)
           and saved as predicted specs, the sections merged: s, garments/s,
           patterns written and skipped; (2) GarmentStitchPairsDataset on the
           merged root (stitch_model.yaml's dataset section with
           FIT_FOLDERS, FIT_SPLIT and no parameter filter): garments kept,
           pairs per batch (30 x 400), set-up s; (3) the stitch model at its
           published widths (16 -> 200 x 3 -> 1): the eval forward of a
           (30, 400, 16) batch and Trainer.train_step (ms, pairs/s, peak
           memory), and the first step on STITCH_CPU_GARMENTS garments
           (pairs drawn from a printed seed, `pairs_seed`) against the same
           step in float64 on the CPU: loss within 1e-5 relative and
           gradient within 1e-4 of its norm, or twice the largest gap of
           the CPU f32 step over every order of the garments where that is
           larger; the direct gap to the CPU f32 step, each BatchNorm's
           cancellation E[x^2] / (var + eps), the logit column's batch
           variance and share of zeros printed; (4) Trainer.fit for
           FIT_EPOCHS epochs
           at batch 30 and one resumed: epoch s, ms per step, loader-wait
           share, the mean training loss must fall, the validation
           section's pair accuracy and stitch recall; (5) eval_metrics on
           the test section in the exhaustive mode (every cross-panel pair
           at batch 1, padded to power-of-two buckets and masked): ms per
           pattern and the buckets met; the stitches written back through
           save_prediction_batch with the bucketed predict function, whose
           logits must equal the unpadded forward's to 1e-6 of their scale
k above 16 (fault C5: the capacity instances K = 32, 64, 128 of every
kernel, for k = 17..128), after the k = 10 phases:
  k_range  each of rows 1-9 at k in K_RANGE (17, 20, 32, 64, 128) at one
           shape each (k_range_kernels), against its plain version with the
           k = 5 bars; their times, bounds and library calls
  kernel_k20, knn_gather_k20  rows 1-9 at k = 20 at the shapes of the k =
           20 main path below (k20_kernels; the stress rows on the whole
           batch, checked on its first CHUNK clouds)
and, after the f32 and bf16 phases, att with NN.k_neighbors set to 20 in
memory (DGCNN's published k), each on its own counts:
  serving_k20, serving_k20_bf16  as `serving`: 1 + 1 fused launches per
           forward (rows 4-5), batch ms, a 2-cloud batch against the CPU
  stress_k20  the 128 x 10,000 batch served STRESS_CALLS times (1 + 1
           tiled launches per forward, rows 6-7; 1 cloud against the CPU),
           then K20_STRESS_STEPS chunked training steps (1 knn + 1 knn_wide
           launch per step, rows 1-3): ms and peak memory
  train_k20  as `training`: 1 + 1 + 1 knn_gather launches per step (rows
           8-9), the 2-cloud step against the CPU at the att step's bars
Every shape the JAX package takes (faults C6, C7), after kernel_k20:
  wide_shapes  rows 2, 4-5 and 8-9 at the shapes of att with one NN key
           changed (WIDE_VARIANTS: EConv_feature 300, EConv_hidden 512,
           EConv_hidden_depth 4), each against its plain version with the
           k = 5 bars (wide_shape_kernels)
  k_large  rows 4-9 at k = 129 and 200 (the selection of all N keys, then
           the edge MLP or the rows) at the k = 200 paths' shapes (rows 4-5
           at serving's 64 clouds, the plain version 16 at a time), rows
           6-7 at (4, 10000, C) at k = 200, with the k = 5 bars
           (k_large_kernels)
and, after train_k20, each on its own counts:
  serving_<variant>, train_<variant>  att at each WIDE_VARIANTS width as
           `serving` (WIDE_SERVE_CALLS batches; conv1 at C = 300 through
           knn_gather in eval, as the JAX models route it) and `training`
           (WIDE_TRAIN_STEPS steps; the 2-cloud step's gradient bars the
           larger of the f32 bars and twice the CPU's own 1e-7 noise floor)
  serving_k200, train_k200  att at k = 200: (64, 2000, 3) served, and
           steps on a (6, 2000, 3) batch (at 7 clouds the layers would take
           the chunked sweeps, whose standalone kNN stops at 128, as the JAX
           package's does)
and, after parallel_ring:
  points_sharded  trainer.mesh {data: d, points: p} on (4, 2000, 3) at
           full width: att, att with max pools, att with the segmentation
           term, the baseline with pool10's, gpool's and pointnet's
           encoders, and att with pointnet's (POINTS_CASES), each mesh an
           entry of `meshes` with its backend and cards: {1, 2} as two gloo
           ranks on one card, or as NCCL ranks on two or three cards; with
           four or more also {2, 2} and {1, 4} (NCCL, a card a rank);
           against one process, both steps' losses within rtol 2e-5 and
           the first gradient within 1e-5 of its norm, or twice one
           process's order floor where larger (the clouds in reverse order,
           and scaled by 1 + 1e-7 noise; pool10 also 1e-6); the baseline
           with pointnet's encoder with its BatchNorm moments in f64, and
           with pool10's on {2, 2} (POINTS_MOMENTS64),
           pointnet's first step also in f64 within 1e-9 (POINTS_EXACT); the one process takes the ring's neighbours and
           the kNN and graph-pool choices of each data slice's first points
           rank (StepChoices), each of both steps' held to the plain
           version; each rank's launches of rows 2 and 8-9 per step as
           POINTS_STEP_LAUNCHES
           says; conv1's ring ids against knn_gather's kernel, differences
           near ties. A probe ring shift of a card tensor runs first on
           each mesh; its failure, as a training rank's, fails the script
           (the probe's error printed in the mesh's entry)
and, after stitch_pipeline:
  parity_check  the port's cli/parity_check.py on the att f32 fit run's best
           checkpoint over parity_run/data_big/ (its test split): a first
           pass writes the report, a second pass with --expected from it
           must exit 0 with every row passing; rows 4-5's launches per pass
  parity_train  the CLI's replica modes on the same data and widths, each
           pass on its own counts: (a) --torch_cross_check on that
           checkpoint (the torch reference replica's cdist + topk forward
           against the port's serving forward, each torch: row within its
           recorded fault-C9 gap, C9_SERVING_GAPS, and against the port's f32
           forward, every torch_f32: row within 1%; the forwards' ms on a
           test batch); (b) --torch_train_cross_check (3 epochs, one
           noise seed, one port seed) and --stitch_train_cross_check
           (STITCH_NN, one noise seed): rc 0 by the CLI's rule, each port
           arm's first-step loss within 1e-3 of the replica's, each arm's
           seconds, ms per step and launches (the port's shape arms rows 8-9
           once per step and rows 4-5 once per eval batch, every other arm
           none); (c) --resume on (b)'s shape report: no arm, no launch, an
           equal report
Then the evaluation, prediction and export entry points, each through the
port's CLI as a user calls it (a system file and one config per run,
naming the att f32 fit run resumed by stitch_pipeline and its stitch run):
  visualization  fit's att f32 fit again with trainer.with_visualization on
           (as att.yaml ships it): one predicted garment per data folder saved
           into intermediate_preds/ after each epoch and logged as
           'pred_img::<file>', rendered where matplotlib imports (a missing
           matplotlib only warns): whether it imports, the keys logged and the
           PNGs that exist, epoch s beside the flag-off fit's, the image
           logging's s, the launches (rows 4-5 once more per epoch)
  on_test_set  `cli.on_test_set -sh -st --predict --correct_panels`: each
           stage's s (shape eval on the test section, whole and by folder;
           its predictions; the stitch eval on them, every cross-panel pair
           at batch 1; the write-back; the eval on patterns with the right
           panel count), the shape and stitch metrics, garments/s predicted,
           ms per pattern of the stitch eval, the launches; fails if a stage
           yields no pattern
  predict_per_example  `cli.predict_per_example -sh -st -dir` on CLI_CLOUDS
           .obj meshes and CLI_CLOUDS .txt clouds of the dataset: garments/s,
           patterns saved with stitches, one launch of rows 4-5 each
  export_serving  `cli.export_serving` of the trained att model at (64,
           2000) in f32 and bf16 and at (128, 10000) in f32 (rows 6-7): export
           and load s, MB, first and median warm call against
           build_serving_fn's, exactly one launch of each fused layer per call
           through the registered operator, outputs against build_serving_fn
           (bitwise equal expected, the gap printed), a CPU input refused
Each of rows 4, 5, 8 and 9 in the kernels line carries `launches_fit`, its
launches in the f32 or bf16 fit, and the f32 entries `launches_lstm` and
`launches_fit_lstm`, the baseline's serving or training and its fit; the
f32 entries of rows 4, 5, 8 and 9 carry `launches_stitch_pipeline`, their
launches in the pipeline (the shape stage's resumed training and its
predictions). The f32 entries of rows 4-7 carry `launches_visualization`,
`launches_on_test_set`, `launches_predict_per_example` and `launches_export`
(the f32 artifacts' calls), the bf16 entries of rows 4-7 `launches_export`
(the bf16 artifact's). The k = 10 entries carry the pool10 variant's
launches at their shape (serving; rows 2, 4, 5 also `launches_training`);
row 1's is on no path of the slice (`on_main_path` false, 0 launches).
The f32 entries of rows 2, 4, 5, 8 and 9 carry `launches_variants`, the
other variants' launches of their kernel at k = 5. The entries of rows 4-5
(f32 and bf16) carry `launches_mesh_to_prediction`, and the f32 entries of
rows 4, 5, 8 and 9 `launches_fit_on_device`, and the f32 entries of rows 4-5
`launches_parity_check`, and the f32 entries of rows 4, 5, 8 and 9
`launches_parallel_fit` and `launches_parity_train`. The k = 20 entries
(rows 4, 5, 6, 7, 1, 2, 8 small and wide C, 9) carry the k = 20 main
path's launches (rows 4-5 also `launches_serving_k20_bf16`); the k = 128
entries, from k_range, are on no path (`on_main_path` false, 0 launches).
The wide_shapes entries carry their variant and the launches of its
serving and training phases (row 8 at C = 300 also `launches_serving`; row
2 at D = 300 is on no path); the k_large entries at k = 200 of rows 4-5 and 8-9 the launches of
serving_k200 and train_k200, the others none (`on_main_path` false).
Then each phase's seconds, the card's name and power limit, the kernels
line (each bf16-mode kernel an entry of its own, its launches from the bf16
phases), and as the last line {"ok": true, "device": {...}}. Any failed
check exits non-zero. The build line gives each kernel instantiation's registers
and spill bytes from `nvcc -Xptxas -v` (`k16`: the k = 9..16 instances';
`k_capacity`: the K = 32, 64, 128 instances'; `k_capacity_csr`: row 9's
large-k CSR build) and, where the toolkit has
cuobjdump, its count of tensor-core instructions in the SASS (HMMA, and
HGMMA for wgmma): the wide selections (the streaming ones on wgmma) and
every fused_edgeconv_kernel instantiation with k > 1 (the edge MLP) must
have some, and no k = 5 instantiation may spill. In the kernels line a kNN kernel's
max_abs_err is the largest gap between the exact distances of its
neighbours and of the plain version's (0 where every id agrees); bound_ms
counts each distance once per unordered pair (`pairs`); bound_share is
bound_ms / ms.

The plain versions rank all N x N pairs of a cloud at once, so at the
stress shape (a (128, 10^4, 10^4) ranking is about 100 GB) they run on
CHUNK clouds at a time: their checks use the first CHUNK clouds, their
times the whole batch chunk by chunk.

Tolerances: the edge MLP truncates activations to bf16 and the kernel sums
in another order than cuBLAS, so one flipped truncation moves an activation
by up to 2^-8 of itself; outputs are held to 1e-2 of their largest
magnitude, 1e-4 on average.

A train step against the CPU plain path (compare_step_cpu) holds its
discrete choices and its arithmetic apart. The card's step records each
choice with its input: the kNN ids of every knn_gather and kNN call and the
clusters each DynamicGraphPool keeps. Each choice is held against the plain
version on that same input (small-C ids equal, every other differing id or
kept cluster a near tie), and the CPU step then takes the card's
choices, so that its loss and gradient bars see the arithmetic alone. A
near tie that rounding flips otherwise moves a model's loss by a step: on
pool10, whose 20- and 200-point kNN graphs are full of near ties, 1e-6
noise in the weights moves the CPU path's loss by 3e-3 about once in three
draws. The sampling choices of PointNet++ (farthest points, ball query) are
not recorded; its step keeps the noise-floor bars. The encoder variants'
steps also record which inputs each ReLU passes and which entries win each
max, and the CPU step takes those too (`StepChoices`' `kinks`): one ReLU
input within rounding of 0 whose channel pool10's global max pool routes
whole moved that step by more than its 1e-2 bar.
"""
import argparse
import contextlib
import copy
import itertools
import json
import math
import os
import random
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# the replica modes of the parity CLI (parity_train) allocate a 67 GiB
# buffer a step; the caching allocator reads this before the first card
# allocation, and on fixed segments a second replica ran out of memory
os.environ.setdefault('PYTORCH_CUDA_ALLOC_CONF', 'expandable_segments:True')

# the published attention model (configs/att.yaml), its data layout and
# standardization statistics, copied at full precision (the YAML may not be
# readable where this runs: no PyYAML is required)
ATT_DATA_CONFIG = {
    'element_size': 4, 'rotation_size': 4, 'translation_size': 3,
    'max_panel_len': 14, 'max_pattern_len': 23, 'max_num_stitches': 24,
    'explicit_stitch_tags': False,
    'standardize': {
        'f_scale': [16.351303100585938, 30.945703506469727, 9.60141944885254],
        'f_shift': [0.037076108157634735, -28.06070327758789, 1.0775548219680786],
        'gt_scale': {
            'outlines': [25.267892837524418, 31.298505783081055, 0.2677369713783264,
                         0.2352069765329361],
            'rotations': [1.7071068286895752, 1.9238795042037964, 1.7071068286895752, 1],
            'stitch_tags': [119.98278045654295, 156.0384521484375, 105.92605590820312],
            'translations': [109.58930206298828, 98.27909088134766, 37.84679412841797],
        },
        'gt_shift': {
            'outlines': [0, 0, 0.14890235662460327, 0.05642016604542732],
            'rotations': [-0.7071067690849304, -0.9238795042037964, -1, 0],
            'stitch_tags': [-59.99139022827149, -78.12358856201172, -52.95616912841797],
            'translations': [-55.255470275878906, -20.001333236694336, -17.086795806884766],
        },
    },
}
ATT_NN_CONFIG = {
    'panel_encoding_size': 250, 'panel_hidden_size': 250, 'panel_n_layers': 3,
    'pattern_encoding_size': 250, 'pattern_hidden_size': 250, 'pattern_n_layers': 2,
    'EConv_hidden': 200, 'EConv_feature': 150, 'EConv_hidden_depth': 2,
    'k_neighbors': 5, 'conv_depth': 2, 'skip_connections': True,
    'global_pool': 'mean', 'local_attention': True, 'lstm_init': 'kaiming_normal_',
}
ATT_LOSS_CONFIG = {
    'loss_components': ['shape', 'loop', 'rotation', 'translation'],
    'quality_components': ['shape', 'discrete', 'rotation', 'translation'],
    'stitch_tags_margin': 0.3, 'stitch_hardnet_version': False,
    'loop_loss_weight': 1.0, 'segm_loss_weight': 0.05, 'epoch_with_stitches': 40,
    'panel_origin_invariant_loss': False, 'panel_order_inariant_loss': False,
    'epoch_with_order_matching': 0, 'order_by': 'shape_translation',
}
# configs/att_bf16.yaml: att.yaml's model in the bf16 mixed-precision mode
ATT_BF16_NN_CONFIG = dict(ATT_NN_CONFIG, compute_dtype='bfloat16')
# configs/lstm_stitch_tags.yaml: the baseline GarmentFullPattern3D, its NN
# and loss sections (same data layout and standardization as att.yaml)
LSTM_MODEL = 'GarmentFullPattern3D'
LSTM_NN_CONFIG = {
    'feature_extractor': 'EdgeConvFeatures', 'conv_depth': 2, 'k_neighbors': 5,
    'EConv_hidden': 200, 'EConv_hidden_depth': 2, 'EConv_feature': 150, 'EConv_aggr': 'max',
    'global_pool': 'mean', 'skip_connections': True, 'panel_decoder': 'LSTMDecoderModule',
    'panel_encoding_size': 250, 'panel_hidden_size': 250, 'panel_n_layers': 3,
    'lstm_init': 'kaiming_normal_', 'pattern_decoder': 'LSTMDecoderModule',
    'pattern_encoding_size': 250, 'pattern_hidden_size': 250, 'pattern_n_layers': 2,
    'stitch_tag_dim': 3,
}
LSTM_LOSS_CONFIG = {
    'loss_components': ['shape', 'loop', 'rotation', 'translation', 'stitch', 'free_class'],
    'quality_components': ['shape', 'discrete', 'rotation', 'translation', 'stitch',
                           'free_class'],
    'stitch_tags_margin': 0.3, 'stitch_hardnet_version': False, 'loop_loss_weight': 1.0,
    'epoch_with_stitches': 40, 'panel_origin_invariant_loss': True,
    'panel_order_inariant_loss': True, 'epoch_with_order_matching': 0,
    'order_by': 'shape_translation',
}
LSTM_TRAIN_STEPS = 3                # per loss phase: epoch 0, then epoch 40
LSTM_STITCH_EPOCH = LSTM_LOSS_CONFIG['epoch_with_stitches']
ATT_TRAINER = {
    'batch_size': 30, 'epochs': 350, 'random_seed': 916143406, 'learning_rate': 0.002,
    'optimizer': 'Adam', 'weight_decay': 0, 'lr_scheduling': {'mode': '1cyclic'},
}
BATCH, POINTS, K = 64, 2000, 5
K_WIDE = 10                         # EdgeConvPoolingFeatures' k (the pool10 variant)
K_DGCNN = 20                        # DGCNN's published k (WangYueFt/dgcnn --k 20)
K_RANGE = (17, K_DGCNN, 32, 64, 128)    # the k_range phase: each capacity instance
K20_STRESS_STEPS = 2
# the widths the card refused before (fault C6): att.yaml with one NN key
# changed each; conv1 at EConv_feature 300 takes 300 channels
WIDE_VARIANTS = {'_feature300': {'EConv_feature': 300}, '_hidden512': {'EConv_hidden': 512},
                 '_depth4': {'EConv_hidden_depth': 4}}
WIDE_SERVE_CALLS, WIDE_TRAIN_STEPS = 5, 3
K_LARGE = 200                       # 128 < k <= N (fault C7): the selection of all N keys
K_LARGE_RANGE = (129, K_LARGE)
# the largest batch whose k = 200 layers stay off the chunked sweeps (B N k
# 200 4 bytes <= 2 GB), which rank through the standalone kNN (k <= 128)
K_LARGE_TRAIN_BATCH = 6
K_LARGE_PLAIN_CHUNK = 16            # clouds a call of the plain fused layer takes at k > 128
POINTS_MESH = {'data': 1, 'points': 2}
# points_sharded's meshes by the cards visible: {1, 2} on one card (two gloo
# ranks) and on two or three (NCCL, a card each); four or more add {2, 2}
# and {1, 4} (NCCL)
POINTS_MESHES_4 = ({'data': 1, 'points': 2}, {'data': 2, 'points': 2}, {'data': 1, 'points': 4})
POINTS_STEPS = 2
TRAIN_BATCH = ATT_TRAINER['batch_size']
TRAIN_STEPS = 6
DX_MAX_REL = 1e-5
TRAIN_LOSS_REL, TRAIN_GRAD_REL, TRAIN_PARAM_GRAD_REL = 1e-3, 1e-2, 5e-2
OUT_MAX_REL, OUT_MEAN_REL = 1e-2, 1e-4
ORDER_FLOOR_FACTOR = 2.0           # bf16 gradient bars: this many times the CPU's order floor
PARALLEL_FIT_HELD_STEPS = 4       # parallel_fit at R >= 2: these first steps' losses held
PARALLEL_FIT_FLOOR_SEEDS = (5, 6, 7)   # its floors: the largest over these 1e-7 noise draws
WIDE_ID_AGREEMENT = 0.99
NEAR_TIE_REL = 2.0 ** -10          # 4 quantization buckets of the packed distance
NORM_ULPS = 2.0 ** -18             # 32 f32 ulps of the squared norms
POOL_TIE_REL = 1e-5                # kept clusters may differ within this of the fitness scale
# a ReLU side or a max's winner that the CPU would choose otherwise than the
# card may differ within this of the largest magnitude of its call's input
# (pointnet's decoder BatchNorms over 4 rows moved ReLU inputs by up to 3.7e-4
# of it under f64 moments on the CPU; a faulty kernel moves them by their scale)
KINK_TIE_REL = 1e-2
SERVE_CALLS = 11
STRESS_BATCH, STRESS_POINTS = 128, 10000    # the JAX package's stress configuration
STRESS_CALLS = 5
STRESS_TRAIN_STEPS = 4
FORCED_CHUNK = 2048                         # 10000 points: 5 chunks, the last padded
CHUNK = 4

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 CUDA cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

KERNEL_SOURCE = 'garment_pattern_estimation_torch/ops/csrc/fused_edgeconv.cu'
REPLACES = 'garment_pattern_estimation_tpu/ops/edgeconv.py:126'
GATHER_SOURCE = 'garment_pattern_estimation_torch/ops/csrc/knn_gather.cu'
GATHER_FWD_REPLACES = 'garment_pattern_estimation_tpu/ops/knn_gather.py:55'
GATHER_BWD_REPLACES = 'garment_pattern_estimation_tpu/ops/knn_gather.py:127'
TILED_REPLACES = {'small_c': 'garment_pattern_estimation_tpu/ops/edgeconv.py:246',
                  'wide_c': 'garment_pattern_estimation_tpu/ops/edgeconv.py:313'}
KNN_SOURCE = 'garment_pattern_estimation_torch/ops/csrc/knn.cu'
KNN_REPLACES = 'garment_pattern_estimation_tpu/ops/knn.py:257'
KNN_WIDE_SOURCE = 'garment_pattern_estimation_torch/ops/csrc/knn_wide.cu'
KNN_WIDE_REPLACES = ('garment_pattern_estimation_tpu/ops/knn.py:314, '
                     'garment_pattern_estimation_tpu/ops/knn.py:360')
# The baseline of lstm_stitch_tags.yaml with each variant's NN keys: the
# alternative encoders and decoders of the JAX registries, full widths,
# depth not cut (ROADMAP queue A item 7)
ENCODER_VARIANTS = {
    'pool10': {'feature_extractor': 'EdgeConvPoolingFeatures', 'k_neighbors': K_WIDE,
               'panel_decoder': 'GRUDecoderModule',
               'pattern_decoder': 'LSTMDoubleReverseDecoderModule'},
    'gpool': {'graph_pooling': True, 'skip_connections': False},
    'aggr_mean': {'EConv_aggr': 'mean'},
    'aggr_add': {'EConv_aggr': 'add'},
    'pointnet': {'feature_extractor': 'PointNetPlusPlus', 'panel_decoder': 'MLPDecoder',
                 'pattern_decoder': 'MLPDecoder'},
}
VARIANT_STEPS = 3
# the CPU step check of pointnet: its MLP decoders normalize over the batch
# rows, and on 2 clouds the CPU path alone moves the loss by 22% and the
# gradient by 2.2 times its norm under 1e-7 input noise (4 clouds: 2.7e-5
# and 2.6%), so it compares 4 clouds with the gradient bars scaled to that
# floor (compare_step_cpu's noise_floor)
VARIANT_STEP_CLOUDS = {'pointnet': 4}
# kernel launches of each variant per serving forward and per training step
# (the first layer's input, the cloud, takes no gradient: no backward there)
_GATHER_STEP = {'knn_gather_fwd_small_c': 1, 'knn_gather_fwd_wide_c': 1, 'knn_gather_bwd': 1}
# points_sharded's cases: (model, NN section, loss section, stitched GT), each
# at full width with zero LSTM states; att's segmentation term reads seeded
# labels. pool10, gpool and pointnet are the baseline with their
# ENCODER_VARIANTS keys; att_pointnet is the attention model with pointnet's
# encoder and MLP panel decoder (the attention pool over the ranks' centroids)
_ATT_ZERO = dict(ATT_NN_CONFIG, lstm_init='zeros')
POINTS_CASES = {
    'att': ('GarmentSegmentPattern3D', _ATT_ZERO, ATT_LOSS_CONFIG, False),
    'att_max': ('GarmentSegmentPattern3D',
                dict(_ATT_ZERO, local_attention=False, global_pool='max'), ATT_LOSS_CONFIG, False),
    'att_segmentation': ('GarmentSegmentPattern3D', _ATT_ZERO, dict(
        ATT_LOSS_CONFIG, loss_components=ATT_LOSS_CONFIG['loss_components'] + ['segmentation']),
        False),
    **{name: (LSTM_MODEL, dict(LSTM_NN_CONFIG, lstm_init='zeros', **ENCODER_VARIANTS[name]),
              LSTM_LOSS_CONFIG, True) for name in ('pool10', 'gpool', 'pointnet')},
    'att_pointnet': ('GarmentSegmentPattern3D',
                     dict(_ATT_ZERO, **{k: v for k, v in ENCODER_VARIANTS['pointnet'].items()
                                        if k != 'pattern_decoder'}), ATT_LOSS_CONFIG, False),
}
# the cases whose f32 step the BatchNorm moments' rounding sets, where
# E[x^2] - E[x]^2 in f32 (as the JAX MLP takes it) cancels to a few % of the
# variance and the step follows that rounding, by the meshes where it does:
# the baseline with PointNet++ and MLP decoders on every mesh (its MLP
# pattern decoder normalizes the 4 clouds' near-equal encodings), the
# baseline with pool10's encoder on {2, 2}, where each data slice's
# BatchNorms take the moments of its half of the batch's few pooled points
# over the data ranks (tests/torch_chip_rehearsal.py, 200 points, plain
# f32: pool10's step losses 1.99e-2 off one process at {2, 2} against a
# bar of 1.62e-2; 3.8e-4 at {1, 2} and 2.5e-3 at {1, 4}, bars 1.6e-2).
# On those meshes their steps are held with the moments in f64
# (`_moments64`), on the others in plain f32; POINTS_EXACT's whole first
# step also in f64 (`_float64`, the plain PyTorch path) within
# POINTS_F64_BAR or twice its order floor
POINTS_MOMENTS64 = {'pointnet': POINTS_MESHES_4, 'pool10': ({'data': 2, 'points': 2},)}
POINTS_EXACT = ('pointnet',)
POINTS_F64_BAR = 1e-9
# the input-noise scales of each case's noise floors: 1e-7, and 1e-6 for
# pool10, whose ring-run conv1 (cuBLAS sums, plain PyTorch) differs from the
# one process's knn_gather kernel (MMA sums) by more than 1e-7 noise moves
# it: on an H100 at 700 W pool10's gradient read 3.49e-4 of its norm off
# one process against floors of 6.4e-5 (reversed clouds) and 8.6e-5 (1e-7
# noise), and 7.3e-4 under 1e-6 noise; every other case's gap sat under
# twice its reversed-clouds and 1e-7 floors
POINTS_NOISE = {'pool10': (1e-7, 1e-6)}
# each rank's kernel launches per points-sharded step: the ring launches
# none; after the first graph pool's gather, each later pool's kNN (row 2)
# and layer's knn_gather forward and backward (rows 8-9), as one process
POINTS_STEP_LAUNCHES = {
    'att': {}, 'att_max': {}, 'att_segmentation': {}, 'pointnet': {}, 'att_pointnet': {},
    'gpool': {'knn_wide': 2, 'knn_gather_fwd_wide_c': 1, 'knn_gather_bwd': 1},
    'pool10': {'knn_wide': 2, 'knn_gather_fwd_wide_c': 2, 'knn_gather_bwd': 2},
}
VARIANT_LAUNCHES = {
    'pool10': ({'fused_small_c': 1, 'fused_wide_c': 2, 'knn_wide': 2},
               {'knn_gather_fwd_small_c': 1, 'knn_gather_fwd_wide_c': 2, 'knn_gather_bwd': 2,
                'knn_wide': 2}),
    'gpool': ({'fused_small_c': 1, 'fused_wide_c': 1, 'knn_wide': 2},
              dict(_GATHER_STEP, knn_wide=2)),
    'aggr_mean': ({'knn_gather_fwd_small_c': 1, 'knn_gather_fwd_wide_c': 1}, _GATHER_STEP),
    'aggr_add': ({'knn_gather_fwd_small_c': 1, 'knn_gather_fwd_wide_c': 1}, _GATHER_STEP),
    'pointnet': ({}, {}),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(message):
    print(f'chip_smoke: FAILED: {message}', file=sys.stderr, flush=True)
    sys.exit(1)


def check(condition, message):
    if not condition:
        fail(message)


def cuda_ms(fn, warmup=3, runs=20):
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def random_folded(gen, c, widths, device):
    """fold_mlp_bn of a seeded Dense/BN stack with non-trivial statistics."""
    import torch
    from garment_pattern_estimation_torch.ops.edgeconv import fold_mlp_bn

    layers = []
    for fan_in, fan_out in zip([2 * c, *widths[:-1]], widths):
        layers.append((
            torch.randn(fan_out, fan_in, generator=gen) / fan_in ** 0.5,
            torch.randn(fan_out, generator=gen) * 0.1,
            torch.rand(fan_out, generator=gen) + 0.5,
            torch.randn(fan_out, generator=gen) * 0.1,
            torch.randn(fan_out, generator=gen) * 0.1,
            torch.rand(fan_out, generator=gen) * 1.5 + 0.5))
    folded, (a, d) = fold_mlp_bn(layers)
    return [(w.to(device), b.to(device)) for w, b in folded], (a.to(device), d.to(device))


def pairs(B, N):
    """Unordered pairs of distinct points in B clouds of N. Every distance
    the kernels compute is symmetric: (x_i - x_j)^2 summed per dimension,
    and the split products of (j, i) are those of (i, j) with the two
    mixed terms of each pair swapped (hi_j lo_i is lo_i hi_j). A schedule
    that computes each unordered pair's products once and sums them in each
    direction's order does the work of B N (N - 1) / 2 pairs, not B N^2."""
    return B * N * (N - 1) / 2.0


def bound(B, N, C, k, widths):
    """Least time (ms) on the card for one layer, and what bounds it. Bytes:
    x read once, the output written once, the bf16 weights, biases and
    affine. Operations: the distances over `pairs` (small C: sub, mul, add
    per dimension in f32; wide C: three bf16 split products) and the edge
    MLP (bf16 products, f32 accumulation); the selection's integer compares
    are not counted."""
    dims = [2 * C, *widths]
    mlp_flops = 2.0 * B * N * k * sum(i * o for i, o in zip(dims[:-1], dims[1:]))
    if C <= 16:
        f32_flops, bf16_flops = 3.0 * pairs(B, N) * C, mlp_flops
    else:
        f32_flops, bf16_flops = 0.0, 3 * 2.0 * pairs(B, N) * C + mlp_flops
    n_bytes = 4.0 * B * N * (C + widths[-1]) \
        + sum(2 * i * o + 4 * o for i, o in zip(dims[:-1], dims[1:])) + 8 * widths[-1]
    ops_ms = (f32_flops / PEAK_F32_FLOPS + bf16_flops / PEAK_BF16_FLOPS) * 1e3
    bytes_ms = n_bytes / PEAK_BYTES * 1e3
    return (ops_ms, 'operations') if ops_ms >= bytes_ms else (bytes_ms, 'bytes')


def ranked_sq_dists(q, nbr):
    """f64 squared distances of the queries q (R, C) to their neighbours
    nbr (R, k, C), as the selection of C ranks them: exact for C <= 16; for
    wider C the 2-term split formula q_norm + k_norm - 2 (hi.hi + hi.lo +
    lo.hi) of the bf16 truncation chunks, which omits lo.lo and so sits up
    to about 2^-15 of the norms above the exact distance (the self distance
    of a 10-norm row reads about 3e-4, not 0)."""
    import torch

    if q.shape[-1] <= 16:
        return ((nbr - q[:, None]) ** 2).sum(-1)

    def split(v):
        v32 = v.float()
        hi = (v32.view(torch.int32) & ~0xFFFF).view(torch.float32)
        lo = ((v32 - hi).view(torch.int32) & ~0xFFFF).view(torch.float32)
        return hi.double(), lo.double()

    (qh, ql), (kh, kl) = split(q), split(nbr)
    cross = (kh * qh[:, None]).sum(-1) + (kl * qh[:, None]).sum(-1) \
        + (kh * ql[:, None]).sum(-1)
    return (q ** 2).sum(-1)[:, None] + (nbr ** 2).sum(-1) - 2.0 * cross


def near_tie_ratio(x, idx, ref_idx, quantized=True):
    """Worst ratio, over the rows whose ids differ from the plain version's,
    of the distance gap to the near-tie bound, the number of such rows, and
    the largest distance gap itself (the ids' error in the units they are
    ranked by); 0, 0, 0 when all rows agree.

    Disagreements must be near ties: the two neighbour sets' distances,
    recomputed in f64 as the selection ranks them (`ranked_sq_dists`: the
    exact distance, or the 2-term split formula for the quantized wide-C
    ranking), differ by a few quantization buckets (none for the wide-D
    kNN, which ranks exact values) plus the rounding of q_norm + k_norm -
    2 * cross (a few ulps of the norms). Only the differing rows' own
    points are gathered."""
    import torch

    rows = (~(idx == ref_idx).all(dim=-1)).nonzero()
    if not rows.numel():
        return 0.0, 0, 0.0
    b, n = rows[:, 0], rows[:, 1]
    q = x[b, n].double()                                      # (R, C)

    def dists(ids):
        nbr = x[b[:, None], ids[b, n].long()].double()        # (R, k, C)
        norms = (nbr ** 2).sum(-1).amax(-1) + (q ** 2).sum(-1)
        d = ranked_sq_dists(q, nbr) if quantized else ((nbr - q[:, None]) ** 2).sum(-1)
        return d.sort(dim=-1).values, norms

    (d_kernel, n_kernel), (d_plain, n_plain) = dists(idx), dists(ref_idx)
    allowed = NEAR_TIE_REL * quantized * d_plain \
        + NORM_ULPS * torch.maximum(n_kernel, n_plain)[:, None]
    gap = (d_kernel - d_plain).abs()
    return (gap / allowed).max().item(), int(rows.shape[0]), gap.max().item()


def check_ids(name, x, idx, ref_idx, quantized=True):
    """Small C: every id equals the plain version's; wide C: at least 99%,
    every disagreement a near tie. Returns (share of equal ids, rows that
    differ, worst near-tie ratio, largest distance gap)."""
    id_share = (idx == ref_idx).float().mean().item()
    worst_tie, n_rows, gap = near_tie_ratio(x, idx, ref_idx, quantized)
    if x.shape[-1] <= 16:
        check(id_share == 1.0, f'{name}: neighbour ids agree on {id_share}, not all')
    else:
        check(id_share >= WIDE_ID_AGREEMENT,
              f'{name}: neighbour ids agree on {id_share} < {WIDE_ID_AGREEMENT}')
        check(worst_tie <= 1.0,
              f'{name}: a disagreeing neighbour is {worst_tie} x the near-tie bound away')
    return id_share, n_rows, worst_tie, gap


def chunked(fn, x, chunk):
    """fn on x chunk clouds at a time, the results concatenated."""
    import torch
    if chunk >= x.shape[0]:
        return fn(x)
    return torch.cat([fn(x[i:i + chunk]) for i in range(0, x.shape[0], chunk)])


def check_kernel(name, x, folded, widths, *, tile_variant=False, bf16=False, k=K,
                 phase=None, timing=None, plain_chunk=None):
    """Kernel against the plain version on the same inputs at k neighbours;
    returns the kernel's output and its line of the kernels list (launches
    filled in later). The single-tile variants are checked and timed on the
    whole batch at once; the tiled ones (stress shapes) checked on the first
    CHUNK clouds, their plain version timed on the whole batch CHUNK clouds
    at a time, and fewer timed runs (each call takes most of a second).
    `plain_chunk`: the plain version runs on that many clouds at a time, in
    the check and in its timing, where the whole batch's edge rows would not
    fit the card (the kernel still runs on the whole batch). `bf16`: the
    bf16 compute mode (`mlp_dtype=torch.bfloat16`, wide rows gathered as
    their top truncation chunk), on both sides. `phase` names the printed
    line's phase; `timing` (warm-up, runs) sets the kernel's and the plain
    version's timed calls."""
    import torch
    from garment_pattern_estimation_torch.ops import edgeconv

    B, N, C = x.shape
    mlp_dtype = torch.bfloat16 if bf16 else torch.float32
    out, idx = edgeconv.fused_edgeconv(x, folded, k, mlp_dtype=mlp_dtype, return_idx=True)
    torch.cuda.synchronize()
    check_clouds = CHUNK if tile_variant else B
    step = plain_chunk or check_clouds
    xc, out_c, idx_c = x[:check_clouds], out[:check_clouds], idx[:check_clouds]
    ref_idx = chunked(lambda xs: edgeconv.edgeconv_select(xs, k, mlp_dtype)[0], xc, step)
    agree_rows = (idx_c == ref_idx).all(dim=-1)
    id_share, n_rows, worst_tie, _ = check_ids(name, xc, idx_c, ref_idx)

    def plain_tails(i):
        """The plain edge MLP and max on clouds i.. i + step, over the
        kernel's ids (the tail) and over the plain selection's (full)."""
        xs = xc[i:i + step]
        x_lp = edgeconv.gathered_rows(xs.float(), 2 if mlp_dtype == torch.float32 else 1)
        return (edgeconv.edgeconv_mlp_max(xs, idx_c[i:i + step], x_lp, folded),
                edgeconv.edgeconv_mlp_max(xs, ref_idx[i:i + step], x_lp, folded))

    tail, full = (torch.cat(parts) for parts in zip(*map(plain_tails,
                                                         range(0, check_clouds, step))))
    del ref_idx
    scale = tail.abs().max().item()
    diff = (out_c - tail).abs()
    diff_agree = (out_c - full).abs()[agree_rows]
    line = {
        'phase': phase or ('kernel_bf16' if bf16 else 'kernel') + ('' if k == K else f'_k{k}'),
        'name': name, 'shape': [B, N, C],
        'checked_clouds': check_clouds, 'k': k, 'mlp': [2 * C, *widths],
        'mlp_dtype': str(mlp_dtype), 'id_agreement': id_share,
        'id_disagreeing_rows': n_rows, 'near_tie_ratio': worst_tie,
        'max_abs_err': diff.max().item(), 'max_rel_err': diff.max().item() / scale,
        'mean_rel_err': diff.mean().item() / scale,
        'max_rel_err_vs_full_plain': diff_agree.max().item() / scale,
    }
    del tail, full, diff, diff_agree
    warmup, runs = timing or ((1, 5) if tile_variant else (3, 20))
    line['ms'] = cuda_ms(lambda: edgeconv.fused_edgeconv(x, folded, k, mlp_dtype=mlp_dtype),
                         warmup, runs)
    line['plain_ms'] = cuda_ms(lambda: chunked(
        lambda xs: edgeconv.fused_edgeconv_reference(xs, folded, k, mlp_dtype), x,
        step), warmup, 3 if tile_variant else runs)
    line['plain_chunk'] = step
    line['bound_ms'], line['bound_by'] = bound(B, N, C, k, widths)
    line['library_ms'] = None       # no single PyTorch call computes this layer
    emit(line)
    check(line['max_rel_err'] <= OUT_MAX_REL and line['mean_rel_err'] <= OUT_MEAN_REL,
          f'{name}: output off the plain tail: {line}')
    check(line['max_rel_err_vs_full_plain'] <= OUT_MAX_REL,
          f'{name}: output off the plain layer: {line}')

    variant = 'small_c' if C <= 16 else 'wide_c'
    return out, {
        'name': name, 'route': 'cuda', 'source': KERNEL_SOURCE,
        'replaces': TILED_REPLACES[variant] if tile_variant else REPLACES, 'k': k,
        'launches': None, 'max_abs_err': line['max_abs_err'], 'ms': line['ms'],
        'plain_ms': line['plain_ms'], 'bound_ms': line['bound_ms'],
        'bound_by': line['bound_by'], 'library_ms': None}


def knn_bound(B, N, D, k):
    """Least time (ms) on the card for the kNN ids and what bounds it:
    the points read once and the int32 ids written once; the distances'
    sub, mul and add per dimension in f32 over `pairs` (selection compares
    not counted)."""
    ops_ms = 3.0 * D * pairs(B, N) / PEAK_F32_FLOPS * 1e3
    bytes_ms = 4.0 * B * N * (D + k) / PEAK_BYTES * 1e3
    return (ops_ms, 'operations') if ops_ms >= bytes_ms else (bytes_ms, 'bytes')


def knn_phase(points):
    """The standalone kNN entry on the stress batch; returns its line of
    the kernels list."""
    import torch
    from garment_pattern_estimation_torch.ops import knn, launches_by_variant

    B, N, D = points.shape
    knn.launches_by_shape.clear()
    ids = knn.knn(points, K)                      # the entry, as a user calls it
    torch.cuda.synchronize()
    launches = launches_by_variant(knn)['knn']
    check(launches == 1, f'knn: the entry launched {launches} kernels, expected 1')
    check(tuple(ids.shape) == (B, N, K), f'knn: ids of shape {tuple(ids.shape)}')
    ref = knn.knn_reference(points[:CHUNK], K)
    agreement = (ids[:CHUNK] == ref).float().mean().item()
    _, _, id_err = near_tie_ratio(points[:CHUNK], ids[:CHUNK], ref)
    del ref
    line = {'name': 'knn', 'route': 'cuda', 'source': KNN_SOURCE, 'replaces': KNN_REPLACES,
            'k': K, 'launches': launches, 'max_abs_err': id_err,
            'ms': cuda_ms(lambda: knn.knn(points, K), 2, 10),
            'plain_ms': cuda_ms(lambda: chunked(lambda xs: knn.knn_reference(xs, K),
                                                points, CHUNK), 1, 3),
            # torch.cdist + torch.topk: two calls, and their ties and
            # rounding differ from the ranking's
            'library_ms': cuda_ms(lambda: chunked(
                lambda xs: torch.topk(torch.cdist(xs, xs), K, largest=False).indices,
                points, CHUNK), 1, 3)}
    line['bound_ms'], line['bound_by'] = knn_bound(B, N, D, K)
    emit({'phase': 'knn', 'shape': [B, N, D], 'k': K, 'checked_clouds': CHUNK,
          'id_agreement': agreement, 'plain_chunk': CHUNK, **line})
    check(agreement == 1.0, f'knn: ids agree with the plain version on {agreement}, not all')
    return line


def knn_wide_bound(B, N, D, k):
    """Least time (ms) on the card for the wide-D kNN ids and what bounds
    it: the points read once and the int32 ids written once; the six bf16
    split products over `pairs`, 6 x 2 D operations each at the bf16
    tensor-core peak (selection compares not counted)."""
    ops_ms = 6 * 2.0 * pairs(B, N) * D / PEAK_BF16_FLOPS * 1e3
    bytes_ms = 4.0 * B * N * (D + k) / PEAK_BYTES * 1e3
    return (ops_ms, 'operations') if ops_ms >= bytes_ms else (bytes_ms, 'bytes')


def knn_wide_phase(points):
    """The wide-D kNN entry on the stress conv1 input; returns its line of
    the kernels list (launches filled in by the stress training phase)."""
    import torch
    from garment_pattern_estimation_torch.ops import knn, launches_by_variant

    B, N, D = points.shape
    knn.launches_by_shape.clear()
    ids = knn.knn(points, K)                      # the entry, as a user calls it
    torch.cuda.synchronize()
    per_call = launches_by_variant(knn)
    check(per_call == {'knn': 0, 'knn_wide': 1},
          f'knn_wide: the entry launched {per_call}, expected one wide-D kernel')
    check(tuple(ids.shape) == (B, N, K), f'knn_wide: ids of shape {tuple(ids.shape)}')
    xc, ids_c = points[:CHUNK], ids[:CHUNK]
    ref = knn.knn_reference(xc, K)
    id_share, n_rows, worst_tie, id_err = check_ids('knn_wide', xc, ids_c, ref,
                                                    quantized=False)
    check(torch.equal(ids_c[..., 0], ref[..., 0]), 'knn_wide: slot 0 is not the query')
    del ref, ids, ids_c
    line = {'name': 'knn_wide', 'route': 'cuda', 'source': KNN_WIDE_SOURCE,
            'replaces': KNN_WIDE_REPLACES, 'k': K, 'launches': None, 'max_abs_err': id_err,
            'ms': cuda_ms(lambda: knn.knn(points, K), 1, 5),
            'plain_ms': cuda_ms(lambda: chunked(lambda xs: knn.knn_reference(xs, K),
                                                points, CHUNK), 1, 3),
            # torch.cdist + torch.topk: two calls, other rounding and ties
            'library_ms': cuda_ms(lambda: chunked(
                lambda xs: torch.topk(torch.cdist(xs, xs), K, largest=False).indices,
                points, CHUNK), 1, 3)}
    line['bound_ms'], line['bound_by'] = knn_wide_bound(B, N, D, K)
    emit({'phase': 'knn_wide', 'shape': [B, N, D], 'k': K, 'checked_clouds': CHUNK,
          'launches_per_call': per_call['knn_wide'], 'id_agreement': id_share,
          'id_disagreeing_rows': n_rows, 'near_tie_ratio': worst_tie,
          'plain_chunk': CHUNK, **line})
    return line


def gather_bound(B, N, C, k, backward):
    """Least time (ms) on the card for knn_gather and what bounds it.
    Forward: x read once, the (B, k, N, C) rows and the (B, N, k) ids
    written once; the distances over `pairs` (small C: sub, mul, add per
    dimension in f32; wide C: three bf16 split products). Backward: the rows'
    cotangents and the ids read once, dx written once; its (k-1) B N C f32
    additions. Selection compares are not counted."""
    if backward:
        n_bytes = 4.0 * (B * k * N * C + B * N * k + B * N * C)
        f32_flops, bf16_flops = 1.0 * B * (k - 1) * N * C, 0.0
    else:
        n_bytes = 4.0 * (B * N * C + B * k * N * C + B * N * k)
        if C <= 16:
            f32_flops, bf16_flops = 3.0 * pairs(B, N) * C, 0.0
        else:
            f32_flops, bf16_flops = 0.0, 3 * 2.0 * pairs(B, N) * C
    ops_ms = (f32_flops / PEAK_F32_FLOPS + bf16_flops / PEAK_BF16_FLOPS) * 1e3
    bytes_ms = n_bytes / PEAK_BYTES * 1e3
    return (ops_ms, 'operations') if ops_ms >= bytes_ms else (bytes_ms, 'bytes')


def check_knn_gather(x, backward, value_chunks=2, k=K, phase_name=None, timing=(3, 20)):
    """The knn_gather forward (and, if asked, backward) kernels against the
    plain versions on x at k neighbours, at `value_chunks` (1: the bf16
    compute mode, wide rows gathered and slots >= 1 scattered as their top
    bf16 truncation chunk); returns their lines of the kernels list. Names
    at k != K end in `_k{k}_c{C}`; `phase_name` names the printed lines' phase,
    `timing` (warm-up, runs) sets the timed calls."""
    import torch
    from garment_pattern_estimation_torch.ops import knn_gather as kg
    from garment_pattern_estimation_torch.ops.knn import truncate_bf16

    B, N, C = x.shape
    variant = 'small_c' if C <= 16 else 'wide_c'
    suffix, phase = ('', 'knn_gather') if value_chunks == 2 else ('_bf16', 'knn_gather_bf16')
    k_suffix = '' if k == K else f'_k{k}'
    phase = phase_name or phase + k_suffix
    c_suffix = '' if k == K and C in (3, 150) else f'_c{C}'
    name = f'knn_gather_fwd_{variant}{suffix}{k_suffix}{c_suffix}'
    nbr, idx = kg.knn_gather_fwd(x, k, value_chunks)
    torch.cuda.synchronize()
    ref_nbr, ref_idx = kg.knn_gather_reference(x, k, value_chunks)
    id_share, n_rows, worst_tie, _ = check_ids(name, x, idx, ref_idx)
    agree = (idx == ref_idx).transpose(1, 2)                  # (B, k, N)
    fwd_err = (nbr[agree] - ref_nbr[agree]).abs().max().item()
    fwd = {'name': name, 'route': 'cuda', 'source': GATHER_SOURCE,
           'replaces': GATHER_FWD_REPLACES, 'k': k, 'launches': None, 'max_abs_err': fwd_err,
           'ms': cuda_ms(lambda: kg.knn_gather_fwd(x, k, value_chunks), *timing),
           'plain_ms': cuda_ms(lambda: kg.knn_gather_reference(x, k, value_chunks), *timing),
           'library_ms': None}      # no single PyTorch call selects and gathers
    fwd['bound_ms'], fwd['bound_by'] = gather_bound(B, N, C, k, backward=False)
    emit({'phase': phase, 'shape': [B, N, C], 'k': k, 'value_chunks': value_chunks,
          'id_agreement': id_share, 'id_disagreeing_rows': n_rows,
          'near_tie_ratio': worst_tie, **fwd})
    check(fwd_err == 0.0, f'{name}: gathered rows differ where the ids agree')
    if not backward:
        return [fwd]

    name = ('knn_gather_bwd' if value_chunks == 2 else 'knn_gather_bwd_hi') + k_suffix + c_suffix
    gen = torch.Generator(device=x.device).manual_seed(3)
    # standard normal cotangents: not bf16-valued, so value_chunks=1 truncates
    g = torch.randn(B, k, N, C, generator=gen, device=x.device)
    dx = kg.knn_gather_bwd(idx, g, value_chunks)
    dx_again = kg.knn_gather_bwd(idx, g, value_chunks)
    ref_dx = kg.knn_gather_backward_reference(idx, g, value_chunks, torch.float64)
    torch.cuda.synchronize()
    bwd_err = (dx.double() - ref_dx).abs().max().item()
    scale = ref_dx.abs().max().item()
    flat = (idx.transpose(1, 2).long()
            + (torch.arange(B, device=x.device) * N)[:, None, None]).reshape(-1)
    rows = g.clone()
    if value_chunks == 1:
        rows[:, 1:] = truncate_bf16(rows[:, 1:])
    rows, buffer = rows.reshape(-1, C), torch.zeros(B * N, C, device=x.device)
    bwd = {'name': name, 'route': 'cuda', 'source': GATHER_SOURCE,
           'replaces': GATHER_BWD_REPLACES, 'k': k, 'launches': None, 'max_abs_err': bwd_err,
           'ms': cuda_ms(lambda: kg.knn_gather_bwd(idx, g, value_chunks), *timing),
           'plain_ms': cuda_ms(lambda: kg.knn_gather_backward_reference(idx, g, value_chunks),
                               *timing),
           # one index_add_ of every slot's rows (slots >= 1 truncated first
           # at value_chunks=1) computes the same dx
           'library_ms': cuda_ms(lambda: buffer.index_add_(0, flat, rows), *timing)}
    bwd['bound_ms'], bwd['bound_by'] = gather_bound(B, N, C, k, backward=True)
    deterministic = bool(torch.equal(dx, dx_again))
    ordered = bool(torch.equal(dx, kg.knn_gather_backward_ordered(idx, g, value_chunks)))
    bwd['split_ms'] = kernel_split(lambda: kg.knn_gather_bwd(idx, g, value_chunks),
                                   ('csr_kernel', 'sum_kernel'))
    emit({'phase': phase, 'shape': [B, N, C], 'k': k, 'value_chunks': value_chunks,
          'max_rel_err': bwd_err / scale, 'bitwise_repeatable': deterministic,
          'bitwise_ordered': ordered, **bwd})
    check(bwd_err <= DX_MAX_REL * scale, f'{name}: dx off the plain version by '
          f'{bwd_err / scale} of its scale')
    check(deterministic, f'{name}: two runs on the same inputs differ')
    check(ordered, f'{name}: dx differs from the ordered sum (slot 0, then ascending entry)')
    if value_chunks == 1:
        full = kg.knn_gather_backward_reference(idx, g, 2, torch.float64)
        check((full - ref_dx).abs().max().item() > DX_MAX_REL * scale,
              f'{name}: the cotangents did not exercise the truncation')
    return [fwd, bwd]


def kernel_split(fn, names, calls=20):
    """Device ms per call of each kernel whose name holds one of `names`,
    from torch.profiler over `calls` calls of fn after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {name: 0.0 for name in names}
    for event in prof.key_averages():
        for name in names:
            if name in event.key:
                split[name] += event.device_time_total / 1e3 / calls
    return split


def gather_backward_sweep():
    """Row 9 (the knn_gather backward: CSR of the transposed graph, then
    one gathered sum per target) at N in {1, 31, 32, 33, 2048}, k in {1, 2,
    3, 5, 8, 9, 16},
    C in {3, 24, 150, 256} and both chunk counts on ids drawn from all N
    points, and on hub ids (one point named by every query in every slot
    >= 1, so its list holds all N (k-1) entries; at N = 2048 and k >= 9 the
    lists are filled in the scratch, not in shared memory): two runs
    bitwise equal, bitwise equal to the ordered sum, within DX_MAX_REL of
    the largest magnitude of the plain version summed in f64 (a hub's
    30720-term f32 sum in the atomic order of CUDA's index_add_ is itself
    off by up to about 1e-5 of it, by a different amount in every run)."""
    import torch
    from garment_pattern_estimation_torch.ops import knn_gather as kg

    gen = torch.Generator(device='cuda').manual_seed(11)
    # k: each exact instance's ends and the K = 16 instance's (cut from
    # every k of 1..16 to keep the script within half its time limit)
    cases = [(2, n, k, c, v, False) for n in (1, 31, 32, 33, 2048) for k in (1, 2, 3, 5, 8, 9, 16)
             if k <= n for c in (3, 24, 150, 256) for v in (1, 2)]
    cases += [(TRAIN_BATCH, POINTS, K, 150, v, True) for v in (1, 2)]
    cases += [(2, 2048, 8, 256, 2, True), (2, 33, 8, 3, 1, True), (2, 2048, 16, 24, 2, True),
              (TRAIN_BATCH, POINTS, K_WIDE, 3, 2, True)]
    worst = 0.0
    for B, N, k, C, value_chunks, hub in cases:
        if hub:
            idx = torch.full((B, N, k), N // 3, device='cuda', dtype=torch.int64)
        else:
            idx = torch.randint(0, N, (B, N, k), generator=gen, device='cuda')
        idx[:, :, 0] = torch.arange(N, device='cuda')
        g = torch.randn(B, k, N, C, generator=gen, device='cuda')
        dx = kg.knn_gather_bwd(idx, g, value_chunks)
        dx_again = kg.knn_gather_bwd(idx, g, value_chunks)
        ref = kg.knn_gather_backward_reference(idx, g, value_chunks, torch.float64)
        name = f'knn_gather_bwd_sweep: B={B} N={N} k={k} C={C} chunks={value_chunks} hub={hub}'
        check(torch.equal(dx, dx_again), f'{name}: two runs differ')
        check(torch.equal(dx, kg.knn_gather_backward_ordered(idx, g, value_chunks)),
              f'{name}: dx differs from the ordered sum')
        err = (dx.double() - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)
        check(err <= DX_MAX_REL, f'{name}: dx off the plain version by {err} of its scale')
        worst = max(worst, err)
    emit({'phase': 'knn_gather_bwd_sweep', 'cases': len(cases),
          'hub_cases': sum(c[-1] for c in cases), 'max_rel_err': worst,
          'bitwise_repeatable': True, 'bitwise_ordered': True})


FIT_FOLDERS = ['tee_synth_300', 'skirt_synth_300', 'jumpsuit_synth_300']
FIT_SPLIT = {'valid_per_type': 10, 'test_per_type': 10, 'random_seed': 10, 'type': 'count'}
FIT_EPOCHS = 2
FIT_LSTM_STITCH_EPOCH = 1      # lstm_stitch_tags.yaml's 40, cut so the stitch phase is reached
SHAPE_TERMS = ('pattern_loss', 'loop_loss', 'rotation_loss', 'translation_loss')


def fit_dataset(**extra):
    """Garment3DPatternFullDataset on parity_run/data_big/ (3 folders x 100
    garments) at 2000 points, padded to att.yaml's 23 panels x 14 edges and
    24 stitches (its data_big panel classes would set 11 panel slots and cut
    the decoder below the published width); `extra` joins the config."""
    from garment_pattern_estimation_torch.data import Garment3DPatternFullDataset

    root = ROOT / 'parity_run' / 'data_big'
    config = {'data_folders': FIT_FOLDERS, 'mesh_samples': POINTS,
              'max_pattern_len': ATT_DATA_CONFIG['max_pattern_len'],
              'max_panel_len': ATT_DATA_CONFIG['max_panel_len'],
              'max_num_stitches': ATT_DATA_CONFIG['max_num_stitches'], **extra}
    return Garment3DPatternFullDataset(root, config, gt_caching=True, feature_caching=True)


def read_records(experiment):
    """(step records, epoch records) of a run's metrics.jsonl."""
    lines = (experiment.run_dir() / 'metrics.jsonl').read_text().splitlines()
    records = [json.loads(line) for line in lines]
    return ([r for r in records if 'batch' in r], [r for r in records if 'valid_loss' in r])


def phase_launches():
    """The fused layer's and knn_gather's launch counts, one dict."""
    from garment_pattern_estimation_torch.ops import edgeconv, knn_gather, launches_by_variant
    return {**{f'fused_{k}': v for k, v in launches_by_variant(edgeconv).items()},
            **{f'knn_gather_{k}': v for k, v in launches_by_variant(knn_gather).items()}}


def reset_launches():
    from garment_pattern_estimation_torch.ops import edgeconv, knn_gather
    edgeconv.launches_by_shape.clear()
    knn_gather.launches_by_shape.clear()


def fit_phase(out_dir, variant=''):
    """Trainer.fit over parity_run/data_big at the published widths, batch
    30, split 10 / 10 per type (seed 10), Adam, one-cycle, standardization
    from the training split, of the model of `variant` (VARIANTS). att f32
    (''): FIT_EPOCHS epochs, then a second Trainer resumes the run from
    'latest' for one more; fit's first step against Trainer.train_step on
    the same batch from the same weights; 'best' and 'latest' load back;
    where a step's host time goes. '_bf16' (att_bf16.yaml's mode):
    FIT_EPOCHS epochs with f32_tail_epochs 1, the tail on at the last epoch.
    '_lstm' (lstm_stitch_tags.yaml, `epoch_with_stitches` cut to
    FIT_LSTM_STITCH_EPOCH): as att f32 less the host-time breakdown; the
    stitch phase's structure change makes its first epoch 'best'. Returns
    the launches of the first fit (rows 4-5: one per validation batch each;
    rows 8-9: one per training step each) and the run's id."""
    import torch
    from garment_pattern_estimation_torch.experiment import ExperimentWrappper
    from garment_pattern_estimation_torch.models import build_model
    from garment_pattern_estimation_torch.train import Trainer, cosine_onecycle_schedule

    phase = 'fit' + variant
    bf16, lstm = variant == '_bf16', variant == '_lstm'
    model_name, nn_section, loss_section = VARIANTS[variant]
    if lstm:
        loss_section = dict(loss_section, epoch_with_stitches=FIT_LSTM_STITCH_EPOCH)
    setup = dict(ATT_TRAINER, epochs=FIT_EPOCHS)
    if bf16:
        setup['f32_tail_epochs'] = 1
    start = time.perf_counter()
    dataset = fit_dataset()
    experiment = ExperimentWrappper({'experiment': {'project_name': 'chip_smoke',
                                                    'run_name': phase}},
                                    output_root=out_dir)
    trainer = Trainer(setup, experiment, dataset, dict(FIT_SPLIT))
    setup_s = time.perf_counter() - start
    model = build_model(model_name, dataset.config, nn_section, loss_section, seed=0)
    initial = {k: v.clone() for k, v in model.module.state_dict().items()}

    reset_launches()
    start = time.perf_counter()
    trainer.fit(model)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - start
    launches = phase_launches()
    steps, epochs = read_records(experiment)
    spe = len(trainer.datawrapper.loaders.train)
    n_valid = len(trainer.datawrapper.loaders.validation)
    check([r['epoch'] for r in epochs] == list(range(FIT_EPOCHS)),
          f'{phase}: epochs {[r["epoch"] for r in epochs]}')
    check(len(steps) == FIT_EPOCHS * spe, f'{phase}: {len(steps)} steps, not {FIT_EPOCHS} x {spe}')
    check(all(math.isfinite(r['loss']) for r in steps)
          and all(math.isfinite(r['valid_loss']) for r in epochs), f'{phase}: a loss is not finite')
    means = [statistics.mean(r['loss'] for r in steps if r['epoch'] == e)
             for e in range(FIT_EPOCHS)]
    if lstm:
        # the stitch terms join at epoch 1: the terms of both phases must fall
        shape_means = [statistics.mean(sum(r[k] for k in SHAPE_TERMS) for r in steps
                                       if r['epoch'] == e) for e in range(FIT_EPOCHS)]
        check(shape_means[1] < shape_means[0],
              f'{phase}: mean shape loss did not fall: {shape_means}')
        check(all('stitch_recall' in r for r in steps if r['epoch'] >= FIT_LSTM_STITCH_EPOCH)
              and not any('stitch_recall' in r for r in steps
                          if r['epoch'] < FIT_LSTM_STITCH_EPOCH),
              f'{phase}: the stitch terms are not where the phase puts them')
    else:
        check(means[1] < means[0], f'{phase}: mean train loss did not fall: {means}')
    if bf16:
        modes = [r['compute_dtype'] for r in epochs]
        check(modes == ['bfloat16'] * (FIT_EPOCHS - 1) + ['float32'],
              f'{phase}: the f32 tail did not switch on at epoch {FIT_EPOCHS - 1}: {modes}')
        gathers = {'knn_gather_fwd_small_c': FIT_EPOCHS * spe,
                   'knn_gather_fwd_wide_c': FIT_EPOCHS * spe,
                   'knn_gather_bwd': spe, 'knn_gather_bwd_hi': (FIT_EPOCHS - 1) * spe}
    else:
        gathers = {'knn_gather_fwd_small_c': FIT_EPOCHS * spe,
                   'knn_gather_fwd_wide_c': FIT_EPOCHS * spe,
                   'knn_gather_bwd': FIT_EPOCHS * spe, 'knn_gather_bwd_hi': 0}
    expected = {'fused_small_c': FIT_EPOCHS * n_valid, 'fused_wide_c': FIT_EPOCHS * n_valid,
                'fused_small_c_tiled': 0, 'fused_wide_c_tiled': 0, **gathers}
    check(launches == expected, f'{phase}: launches {launches}, expected {expected}')

    def epoch_mean(records, epoch, key):
        values = [r[key] for r in records if r['epoch'] == epoch and key in r]
        return statistics.mean(values) if values else None

    line = {'phase': phase, 'model': model_name, 'garments': len(dataset),
            'batch': setup['batch_size'], 'points': POINTS,
            'pattern': [dataset.config['max_pattern_len'], dataset.config['max_panel_len']],
            'steps_per_epoch': spe, 'valid_batches': n_valid, 'setup_s': setup_s,
            'fit_s': fit_s, 'launches': launches, 'per_epoch': [{
                'epoch': r['epoch'], 'compute_dtype': r['compute_dtype'],
                'epoch_s': r['epoch_time'], 'train_loop_ms_per_step': r['train_time'] / spe * 1e3,
                'loader_wait_share': r['data_time'] / r['epoch_time'],
                'median_host_step_ms': statistics.median(
                    s['step_time'] for s in steps if s['epoch'] == r['epoch']) * 1e3,
                'train_loss': means[r['epoch']], 'valid_loss': r['valid_loss'],
                'train_stitch_recall': epoch_mean(steps, r['epoch'], 'stitch_recall')}
                for r in epochs]}
    if lstm:
        line['epoch_with_stitches'] = f'{FIT_LSTM_STITCH_EPOCH} (lstm_stitch_tags.yaml: 40)'
        best = experiment.get_checkpoint_file('best')
        check(best['epoch'] == FIT_LSTM_STITCH_EPOCH,
              f'{phase}: best holds epoch {best["epoch"]}, not the stitch phase\'s first')
    if bf16:
        emit(line)
        return launches, experiment.run_id

    # fit's first step against train_step on the same batch, same weights
    # a new wrapper of the same dataset: a fresh sampler, the stored statistics
    probe = Trainer(setup, dataset=dataset, data_split=dict(FIT_SPLIT))
    probe.init_randomizer()
    twin = build_model(model_name, dataset.config, nn_section, loss_section, seed=0)
    twin.module.load_state_dict(initial)
    probe.make_optimizer(twin, spe)
    batch = next(iter(probe.datawrapper.loaders.train))
    first, _ = probe.train_step(twin, batch, 0, probe._generator(1))
    first_gap = abs(first.item() - steps[0]['loss']) / abs(steps[0]['loss'])
    check(first_gap <= 1e-6, f'{phase}: fit step 0 loss {steps[0]["loss"]} against '
          f'train_step {first.item()} ({first_gap} relative)')

    # where the att step's host time goes: train_step on a batch already on
    # the card, on the same batch from the host, and over the training
    # loader without and with its prefetch thread (ms per step,
    # synchronized once per epoch of steps)
    def per_step(batches):
        torch.cuda.synchronize()
        begin, n = time.perf_counter(), 0
        for item in batches:
            probe.train_step(twin, item, 0, probe._generator(1))
            n += 1
        torch.cuda.synchronize()
        return (time.perf_counter() - begin) / n * 1e3

    breakdown = None
    if not lstm:
        on_card = {'features': batch['features'].cuda(),
                   'ground_truth': {k: v.cuda() for k, v in batch['ground_truth'].items()}}
        loader = probe.datawrapper.loaders.train
        loader.pin_memory = True
        per_step([on_card] * 2)
        breakdown = {'train_step_on_card_batch': per_step([on_card] * spe),
                     'train_step_host_batch': per_step([batch] * spe)}
        for prefetch in (0, 1):
            loader.prefetch = prefetch
            breakdown[f'loader_loop_prefetch_{prefetch}'] = per_step(loader)

    # the checkpoints load back
    for alias in ('best', 'latest'):
        state = experiment.get_checkpoint_file(alias, map_location='cuda')
        twin.module.load_state_dict(state['model'])
        probe.optimizer.load_state_dict(state['optimizer'])
    latest = experiment.get_checkpoint_file('latest')
    check(latest['epoch'] == FIT_EPOCHS - 1 and latest['step'] == FIT_EPOCHS * spe,
          f'{phase}: latest holds epoch {latest["epoch"]}, step {latest["step"]}')

    # a second Trainer resumes the run for one more epoch
    resumed_exp = ExperimentWrappper({'experiment': {'project_name': 'chip_smoke',
                                                     'run_name': phase,
                                                     'run_id': experiment.run_id}},
                                     output_root=out_dir)
    resumed = Trainer(dict(setup, epochs=FIT_EPOCHS + 1), resumed_exp, dataset,
                      dict(FIT_SPLIT))
    again = build_model(model_name, dataset.config, nn_section, loss_section, seed=1)
    start = time.perf_counter()
    resumed.fit(again)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - start
    steps2, epochs2 = read_records(resumed_exp)
    new_steps = [r for r in steps2 if r['epoch'] == FIT_EPOCHS]
    schedule = cosine_onecycle_schedule(max((FIT_EPOCHS + 1) * spe, 4),
                                        float(setup['learning_rate']))
    check(resumed_exp.resumed and [r['epoch'] for r in epochs2][-1] == FIT_EPOCHS,
          f'{phase}: the resumed run did not train epoch {FIT_EPOCHS}')
    check([r['step'] for r in new_steps] == list(range(FIT_EPOCHS * spe, (FIT_EPOCHS + 1) * spe)),
          f'{phase}: resumed steps {[r["step"] for r in new_steps]}')
    check(all(abs(r['learning_rate'] - schedule(r['step'])) <= 1e-6 * schedule(r['step'])
              for r in new_steps), f'{phase}: the resumed run did not continue the schedule')
    check(all(math.isfinite(r['loss']) for r in new_steps), f'{phase}: resumed loss not finite')
    line.update(first_step_vs_train_step=first_gap, resume_s=resume_s,
                resumed_epoch={'train_loss': statistics.mean(r['loss'] for r in new_steps),
                               'valid_loss': epochs2[-1]['valid_loss'],
                               'epoch_s': epochs2[-1]['epoch_time'],
                               'train_stitch_recall': epoch_mean(new_steps, FIT_EPOCHS,
                                                                 'stitch_recall'),
                               'first_step': new_steps[0]['step'],
                               'learning_rates': [new_steps[0]['learning_rate'],
                                                  new_steps[-1]['learning_rate']]})
    if breakdown is not None:
        line['step_ms_breakdown'] = breakdown
    emit(line)
    return launches, experiment.run_id


PARALLEL_RING_SHARDS = 4
PARALLEL_RING_SHAPES = ((8, 2000, 3), (8, 2000, 150))
RING_BUCKET_REL = 2.0 ** -12      # one bucket of the 21-bit ranking class
RING_NORM_REL = 2.0 ** -15        # the two distance formulas' rounding, of the squared norms


class _EpochDone(Exception):
    """Stops `fit` once its first epoch's record is logged."""


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _parallel_fit_run(out_dir, ranks, perturb=None, pad=None, record=False, replay=None,
                      perturb_seed=5):
    """Trainer.fit of the att f32 fit cell over a data mesh of `ranks`
    ranks in the process group that exists, stopped after the first
    epoch's record; `perturb` scales every cloud by 1 + perturb * a normal
    draw of `perturb_seed`; `pad` pads every batch to a multiple of `pad` rows (the
    last sample repeated) and cuts the predictions to the real batch before
    the loss, as a mesh of `pad` ranks does. `record`: the training
    steps' knn_gather choices are kept (`StepChoices`); `replay` (such
    records of the whole batches): the steps take them. Returns (launches,
    steps per epoch, validation batches, fit s, step records, epoch record,
    the first step's gradient as it enters the optimizer, the steps'
    choices or None): the records read back on the first rank, None on the
    others; the gradient flat on the host."""
    import torch
    from garment_pattern_estimation_torch.experiment import ExperimentWrappper
    from garment_pattern_estimation_torch.models import build_model
    from garment_pattern_estimation_torch.parallel import is_first_rank
    from garment_pattern_estimation_torch.parallel.mesh import pad_batch_to_multiple
    from garment_pattern_estimation_torch.train import Trainer
    from torch.optim.optimizer import register_optimizer_step_pre_hook

    model_name, nn_section, loss_section = VARIANTS['']
    dataset = fit_dataset()
    experiment = ExperimentWrappper({'experiment': {'project_name': 'chip_smoke',
                                                    'run_name': 'parallel_fit'}},
                                    output_root=out_dir)
    # the fit phase's schedule: FIT_EPOCHS epochs, of which the first runs
    setup = dict(ATT_TRAINER, epochs=FIT_EPOCHS, mesh={'data': ranks})
    trainer = Trainer(setup, experiment, dataset, dict(FIT_SPLIT))
    model = build_model(model_name, dataset.config, nn_section, loss_section, seed=0)
    log = experiment.log

    def log_then_stop(record, step=None):
        log(record, step)
        if 'valid_loss' in record:
            raise _EpochDone

    experiment.log = log_then_stop
    if perturb:
        place, gen = trainer._place, torch.Generator().manual_seed(perturb_seed)

        def perturbed(batch):
            features, gt = place(batch)
            noise = torch.randn(features.shape, generator=gen).to(features.device)
            return features * (1 + perturb * noise), gt

        trainer._place = perturbed
    if pad:
        trainer._pad = lambda batch: pad_batch_to_multiple(
            {'features': batch['features'], 'ground_truth': batch['ground_truth']}, pad)
    first_grad = []
    choices = StepChoices(model.module)
    if replay is not None:
        choices.records = list(replay)

    def keep_first_gradient(optimizer, args, kwargs):
        if not first_grad:
            first_grad.append(torch.cat([p.grad.reshape(-1) for g in optimizer.param_groups
                                         for p in g['params'] if p.grad is not None]).cpu())

    hook = register_optimizer_step_pre_hook(keep_first_gradient)
    reset_launches()
    start = time.perf_counter()
    try:
        with choices.record() if record else \
                choices.replay(passthrough=True) if replay is not None \
                else contextlib.nullcontext():
            trainer.fit(model)
        fail('parallel_fit: fit ended before its first epoch record')
    except _EpochDone:
        torch.cuda.synchronize()
    finally:
        hook.remove()
    fit_s = time.perf_counter() - start
    records = read_records(experiment) if is_first_rank() else (None, None)
    return (phase_launches(), len(trainer.datawrapper.loaders.train),
            len(trainer.datawrapper.loaders.validation), fit_s, *records, first_grad[0],
            choices.records if record else None)


def _parallel_fit_rank(out_dir, ranks, result_path):
    """`_parallel_fit_run` on a spawned rank, its steps' choices recorded;
    the first rank writes the result, the gradient and every rank's choices
    joined along the batch (the one process's calls on the whole padded
    batches) beside it, as tensor files."""
    import torch
    import torch.distributed as dist
    from garment_pattern_estimation_torch.parallel import is_first_rank

    *result, grad, choices = _parallel_fit_run(out_dir, ranks, record=True)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, choices)
    if is_first_rank():
        Path(result_path).write_text(json.dumps(result))
        torch.save(grad, result_path + '.grad.pt')
        torch.save([_joined_record(parts) for parts in zip(*every)],
                   result_path + '.choices.pt')


def _relative_gaps(steps, ref_steps):
    return [abs(r['loss'] - f['loss']) / abs(f['loss']) for r, f in zip(steps, ref_steps)]


def parallel_fit_phase(runs_dir, fit_run_id):
    """trainer.mesh {data: R} over the att f32 fit cell's first epoch. R = 1
    runs in this process's world-1 group against the fit run: its losses
    are bitwise fit's. R >= 2 spawns R NCCL ranks, records their kNN
    choices, and holds them against one process on the same padded batches
    (`pad`; the duplicates enter the BatchNorm statistics and the LSTM
    states' std, as in the JAX step) that takes those choices: the first
    step's gradient, the first PARALLEL_FIT_HELD_STEPS steps' losses and
    the validation loss, each within its bar or ORDER_FLOOR_FACTOR times
    its floor (PARALLEL_FIT_FLOOR_SEEDS). Checks the launches and returns
    rank 0's."""
    import torch
    from garment_pattern_estimation_torch.experiment import ExperimentWrappper
    from garment_pattern_estimation_torch.parallel.dryrun import spawn

    ranks = torch.cuda.device_count()
    line = {'phase': 'parallel_fit', 'ranks': ranks, 'backend': 'nccl', 'mesh': {'data': ranks}}
    if ranks == 1:
        launches, spe, n_valid, fit_s, steps, epochs, *_ = _parallel_fit_run(runs_dir, 1)
        ref_steps, ref_epochs = read_records(ExperimentWrappper(
            {'experiment': {'project_name': 'chip_smoke', 'run_name': 'fit',
                            'run_id': fit_run_id}}, output_root=runs_dir))
        ref_steps = [r for r in ref_steps if r['epoch'] == 0]
        held, step_bar, valid_bar = 1, 1e-5, 1e-4
    else:
        result_path = runs_dir / 'parallel_fit.json'
        spawn(_parallel_fit_rank, ranks, runs_dir, ranks, str(result_path), backend='nccl')
        launches, spe, n_valid, fit_s, steps, epochs = json.loads(result_path.read_text())
        grad = torch.load(str(result_path) + '.grad.pt')
        records = torch.load(str(result_path) + '.choices.pt')
        # the first step's choices held to the plain version (each step
        # makes one per EdgeConv layer)
        held_to_plain = StepChoices(torch.nn.Module())
        held_to_plain.records = records[:len(records) // spe]
        choice_lines = held_to_plain.check('parallel_fit', torch.nn.Module())
        # the reference: one process on the batches padded to R, its steps
        # on the ranks' neighbours (near ties of a layer's kNN on features
        # that differ in their last bits would flip, and a flip moves the
        # gradient by a share of its norm); R ranks sum each statistic and
        # gradient in another order, and through ReLU and sparsemax
        # boundaries and Adam's steps that moves the run as much as
        # perturbing the clouds by 1e-7 does: each bar is the larger of
        # its own and ORDER_FLOOR_FACTOR times that floor, one process's
        # perturbed run (on the same neighbours) against the reference
        *_, ref_steps, ref_epochs, ref_grad, _ = _parallel_fit_run(runs_dir, 1, pad=ranks,
                                                                   replay=records)
        held = PARALLEL_FIT_HELD_STEPS
        draws = []
        for seed in PARALLEL_FIT_FLOOR_SEEDS:
            *_, floor_steps, floor_epochs, floor_grad, _ = _parallel_fit_run(
                runs_dir, 1, perturb=1e-7, pad=ranks, replay=records, perturb_seed=seed)
            draws.append({
                'grad': ((floor_grad - ref_grad).norm() / ref_grad.norm()).item(),
                'step_loss': max(_relative_gaps(floor_steps, ref_steps)[:held]),
                'valid': abs(floor_epochs[0]['valid_loss'] - ref_epochs[0]['valid_loss'])
                / abs(ref_epochs[0]['valid_loss'])})
        floors = {k: max(d[k] for d in draws) for k in draws[0]}
        grad_gap = ((grad - ref_grad).norm() / ref_grad.norm()).item()
        grad_bar = max(1e-5, ORDER_FLOOR_FACTOR * floors['grad'])
        step_bar = max(1e-5, ORDER_FLOOR_FACTOR * floors['step_loss'])
        valid_bar = max(1e-4, ORDER_FLOOR_FACTOR * floors['valid'])
        line.update(grad_gap=grad_gap, grad_bar=grad_bar, floors_1e7=floors,
                    floor_draws=draws, choices=choice_lines)
        check(grad_gap <= grad_bar,
              f'parallel_fit: the first step\'s gradient {grad_gap} of its norm off one '
              f'process\'s (bar {grad_bar})')
    check(len(steps) == len(ref_steps) == spe and len(epochs) == 1,
          f'parallel_fit: {len(steps)} steps and {len(epochs)} epochs against the reference\'s '
          f'{len(ref_steps)} steps of epoch 0')
    check(all(math.isfinite(r['loss']) for r in steps)
          and math.isfinite(epochs[0]['valid_loss']), 'parallel_fit: a loss is not finite')
    gaps = _relative_gaps(steps, ref_steps)
    ref_valid = ref_epochs[0]['valid_loss']
    valid_gap = abs(epochs[0]['valid_loss'] - ref_valid) / abs(ref_valid)
    check(max(gaps[:held]) <= step_bar,
          f'parallel_fit: step losses {gaps[:held]} relative off the reference\'s '
          f'(bar {step_bar})')
    check(valid_gap <= valid_bar,
          f'parallel_fit: validation loss {valid_gap} relative off the reference\'s '
          f'(bar {valid_bar})')
    expected = {'fused_small_c': n_valid, 'fused_wide_c': n_valid, 'fused_small_c_tiled': 0,
                'fused_wide_c_tiled': 0, 'knn_gather_fwd_small_c': spe,
                'knn_gather_fwd_wide_c': spe, 'knn_gather_bwd': spe, 'knn_gather_bwd_hi': 0}
    check(launches == expected, f'parallel_fit: launches {launches}, expected {expected}')
    fit_steps, fit_epochs = read_records(ExperimentWrappper(
        {'experiment': {'project_name': 'chip_smoke', 'run_name': 'fit', 'run_id': fit_run_id}},
        output_root=runs_dir))
    line.update(steps=spe, valid_batches=n_valid, fit_s=fit_s,
                reference='fit' if ranks == 1 else f'one process, batches padded to {ranks}',
                step_loss_gaps=gaps, held_steps=held, valid_loss=epochs[0]['valid_loss'],
                reference_valid_loss=ref_valid, valid_gap=valid_gap, valid_bar=valid_bar,
                ms_per_step=epochs[0]['train_time'] / spe * 1e3,
                fit_ms_per_step=fit_epochs[0]['train_time'] / spe * 1e3, launches=launches)
    emit(line)
    return launches


def ring_near_ties(x, idx, ref_idx):
    """(share of equal ids, rows that differ, worst ratio of a distance gap
    to its bound): over the differing rows, the exact f64 distances of the
    two id sets, sorted, may differ by one 21-bit bucket of the distance
    plus RING_NORM_REL of the squared norms."""
    share = (idx == ref_idx).float().mean().item()
    rows = (~(idx == ref_idx).all(dim=-1)).nonzero()
    if not rows.numel():
        return share, 0, 0.0
    b, n = rows[:, 0], rows[:, 1]
    q = x[b, n].double()

    def dists(ids):
        nbr = x[b[:, None], ids[b, n].long()].double()
        return ((nbr - q[:, None]) ** 2).sum(-1).sort(dim=-1).values, \
            (nbr ** 2).sum(-1).amax(-1) + (q ** 2).sum(-1)

    (d_ring, n_ring), (d_ref, n_ref) = dists(idx), dists(ref_idx)
    allowed = RING_BUCKET_REL * d_ref + RING_NORM_REL * n_ring.maximum(n_ref)[:, None]
    return share, int(rows.shape[0]), ((d_ring - d_ref).abs() / allowed).max().item()


def _ring_inputs():
    """parallel_ring's seeded inputs on the host: a cloud of each
    PARALLEL_RING_SHAPES shape, att's two EdgeConv layers (random MLP
    states, eval mode) and their (8, POINTS, 3) cloud."""
    import torch
    from garment_pattern_estimation_torch.models.blocks import EdgeConv
    from garment_pattern_estimation_torch.parallel.dryrun import _random_mlp_state

    gen = torch.Generator().manual_seed(12)
    clouds = [torch.randn(*shape, generator=gen) for shape in PARALLEL_RING_SHAPES]
    widths = variant_widths('')
    layers = [EdgeConv(3, widths, k=K), EdgeConv(widths[-1], widths, k=K)]
    for layer in layers:
        layer.nn.load_state_dict(_random_mlp_state(layer.nn, gen))
        layer.eval()
    return clouds, layers, torch.randn(8, POINTS, 3, generator=gen)


def _ring_in_process(x):
    """The ring over PARALLEL_RING_SHARDS shards of `x`, driven in this
    process: each query shard's merge fed its keys in ring order."""
    import torch
    from garment_pattern_estimation_torch.parallel.ring import (_ring_init, _ring_merge,
                                                                _ring_output)

    shards = PARALLEL_RING_SHARDS
    S = x.shape[1] // shards
    nbrs, ids = [], []
    for me in range(shards):
        q = x[:, me * S:(me + 1) * S]
        acc = _ring_init(q, K, shards)
        for step in range(shards):
            src = (me - step) % shards
            acc = _ring_merge(q, x[:, src * S:(src + 1) * S], src, acc, me)
        nbr, idx = _ring_output(q, acc, me)
        nbrs.append(nbr)
        ids.append(idx)
    return torch.cat(nbrs, dim=1), torch.cat(ids, dim=1)


def _ring_rank(result_path):
    """parallel_ring on a spawned NCCL rank of a world of
    PARALLEL_RING_SHARDS ranks, one shard each: `ring_knn_gather` of each
    cloud (its ms) and `sharded_encoder_step`; the first rank writes the
    whole clouds' neighbours, ids, ms, features and pool."""
    import torch
    import torch.distributed as dist
    from garment_pattern_estimation_torch.parallel.collectives import all_gather_rows
    from garment_pattern_estimation_torch.parallel.ring import (
        make_points_mesh, ring_knn_gather, sharded_encoder_step)

    rank, shards = dist.get_rank(), dist.get_world_size()
    clouds, layers, x = _ring_inputs()
    result = {'merge': []}

    def joined(t):
        """Every rank's (B, S, ...) shard, whole (B, N, ...) clouds."""
        return all_gather_rows(t.transpose(0, 1).contiguous()).transpose(0, 1).cpu()

    for cloud in clouds:
        S = cloud.shape[1] // shards
        local = cloud[:, rank * S:(rank + 1) * S].cuda()
        nbr, idx = ring_knn_gather(local, K)
        ms = cuda_ms(lambda: ring_knn_gather(local, K), 1, 5)
        result['merge'].append((joined(nbr), joined(idx), ms))
    with torch.no_grad():
        h, pooled = sharded_encoder_step(make_points_mesh(), [l.nn.cuda() for l in layers],
                                         x.cuda(), K)
    result['encoder'] = (joined(h), pooled.cpu())
    if rank == 0:
        torch.save(result, result_path)


def parallel_ring_phase(out_dir):
    """The ring's merge over P = PARALLEL_RING_SHARDS shards against the
    plain kNN + gather on the whole cloud, and the sharded encoder against
    the unsharded layers: with fewer than P cards the merge driven over the
    P shards on one card and the encoder over the world-1 group; with P or
    more, P NCCL ranks, a card and a shard each (`ring_knn_gather`,
    `sharded_encoder_step` over a points mesh of P)."""
    import torch
    import torch.distributed as dist
    from garment_pattern_estimation_torch.ops.knn_gather import knn_gather_reference
    from garment_pattern_estimation_torch.parallel.dryrun import _edgeconv_plain, spawn
    from garment_pattern_estimation_torch.parallel.ring import (make_points_mesh,
                                                                sharded_encoder_step)

    shards = PARALLEL_RING_SHARDS
    spawned = torch.cuda.device_count() >= shards
    clouds, layers, x = _ring_inputs()
    line = {'phase': 'parallel_ring', 'shards': shards, 'k': K, 'merge': [],
            'ranks': shards if spawned else dist.get_world_size(), 'backend': 'nccl',
            'cards': shards if spawned else 1}
    if spawned:
        result_path = out_dir / 'parallel_ring.pt'
        spawn(_ring_rank, shards, str(result_path), backend='nccl')
        result = torch.load(result_path)
        runs = [(nbr.cuda(), idx.cuda(), ms) for nbr, idx, ms in result['merge']]
    else:
        runs = []
        for cloud in clouds:
            cloud = cloud.cuda()
            nbr, idx = _ring_in_process(cloud)
            runs.append((nbr, idx, cuda_ms(lambda: _ring_in_process(cloud), 1, 5)))
    for cloud, (nbr, idx, ms) in zip(clouds, runs):
        x_card = cloud.cuda()
        B, N, C = x_card.shape
        _, ref_idx = knn_gather_reference(x_card, K)
        share, rows, worst = ring_near_ties(x_card, idx, ref_idx)
        name = f'parallel_ring {(B, N, C)}'
        check(share >= WIDE_ID_AGREEMENT, f'{name}: ids agree on {share}')
        check(worst <= 1.0, f'{name}: a differing neighbour is {worst} x the near-tie bound')
        flat = idx + (torch.arange(B, device=x_card.device) * N)[:, None, None]
        check(torch.equal(nbr, x_card.reshape(B * N, C)[flat]),
              f'{name}: rows are not the cloud\'s')
        line['merge'].append({'shape': [B, N, C], 'id_share': share, 'rows_differ': rows,
                              'worst_tie_ratio': worst, 'ms': ms,
                              'plain_ms': cuda_ms(lambda: knn_gather_reference(x_card, K), 1,
                                                  5)})

    for layer in layers:
        layer.cuda()
    x = x.cuda()
    with torch.no_grad():
        if spawned:
            h, pooled = (t.cuda() for t in result['encoder'])
        else:
            h, pooled = sharded_encoder_step(make_points_mesh(), [l.nn for l in layers], x, K)
        ref = _edgeconv_plain(layers[1].nn, _edgeconv_plain(layers[0].nn, x, K), K)
        fused = layers[1](layers[0](x))
    scale = max(ref.abs().max().item(), 1.0)
    h_gap = (h - ref).abs().max().item() / scale
    pool_gap = (pooled - ref.mean(dim=1)).abs().max().item() / scale
    check(h_gap <= 2e-4 and pool_gap <= 2e-4,
          f'parallel_ring: sharded encoder {h_gap}, pool {pool_gap} of scale off the layers')
    line['encoder'] = {'shape': list(x.shape), 'widths': variant_widths(''),
                       'features_gap': h_gap, 'pool_gap': pool_gap,
                       'fused_kernels_gap': (fused - ref).abs().max().item() / scale,
                       'fused_kernels_mean_gap': (fused - ref).abs().mean().item() / scale}
    emit(line)


class World1Group:
    """A world-1 NCCL process group over a TCP store on 127.0.0.1 for the
    `with` block, on card 0."""

    def __enter__(self):
        import torch
        import torch.distributed as dist
        torch.cuda.set_device(0)
        dist.init_process_group('nccl', init_method=f'tcp://127.0.0.1:{_free_port()}',
                                rank=0, world_size=1)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        dist.destroy_process_group()


# the on-device sampling stage (dataset.on_device_sampling) at bench.py's
# mesh -> prediction shape (bench.py:232-273): 64 meshes of 4096 vertices
# and 8192 faces, 2000 points, point_noise_w 0.01, bench.py's statistics
MESH_V_CAP, MESH_F_CAP = 4096, 8192
MESH_NOISE_W = 0.01
MESH_STATS = {'f_shift': [0.037, -28.06, 1.078], 'f_scale': [16.35, 30.95, 9.60]}
MESH_BOUNDARY_REL = 1e-6          # face ids may differ this near a step, of the total area
MESH_POINT_REL = 1e-5             # of the mesh's extent
MESH_TIE_REL = 1e-5               # snap ids may differ where the f64 distances tie this close
FIT_PROFILE = {'start_step': 2, 'num_steps': 2}
# rows 8-9's kernels, which the trace of fit_on_device's window must name
FIT_TRACE_KERNELS = ('knn_gather_fwd_kernel', 'knn_gather_csr_kernel', 'knn_gather_sum_kernel')


def mesh_batch():
    """bench.py:254-258's meshes: default_rng(0), vertices normal x 20, faces
    drawn over all vertices (every vertex real); then per-vertex labels in
    0..22 from the same generator (bench.py's are zeros, which no label check
    could tell apart). Host tensors."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    verts = rng.normal(size=(BATCH, MESH_V_CAP, 3)).astype(np.float32) * 20.0
    faces = rng.integers(0, MESH_V_CAP, size=(BATCH, MESH_F_CAP, 3)).astype(np.int32)
    labels = rng.integers(0, ATT_DATA_CONFIG['max_pattern_len'], size=(BATCH, MESH_V_CAP))
    return {'verts': torch.from_numpy(verts), 'faces': torch.from_numpy(faces),
            'n_verts': torch.full((BATCH,), MESH_V_CAP, dtype=torch.int32),
            'vert_labels': torch.from_numpy(labels.astype(np.int32))}


def mesh_data_config():
    """att.yaml's data layout with bench.py's sampling settings."""
    return dict(ATT_DATA_CONFIG, mesh_samples=POINTS, point_noise_w=MESH_NOISE_W,
                standardize=dict(ATT_DATA_CONFIG['standardize'], **MESH_STATS))


class SnapCounter:
    """Counts the calls of device_sampling.snap_to_vertices while entered."""

    def __enter__(self):
        from garment_pattern_estimation_torch.preprocess import device_sampling as ds
        self.calls, self._snap = 0, ds.snap_to_vertices

        def counted(*args, **kwargs):
            self.calls += 1
            return self._snap(*args, **kwargs)
        ds.snap_to_vertices = counted
        return self

    def __exit__(self, *exc):
        from garment_pattern_estimation_torch.preprocess import device_sampling as ds
        ds.snap_to_vertices = self._snap


def device_sampling_phase():
    """The sampling stage on the card against its CPU core with the same
    draws (a seeded CPU generator): face ids equal but for draws within
    MESH_BOUNDARY_REL of the total area of a step of the cumulative areas
    (the card's scan rounds otherwise; their count printed), points within
    MESH_POINT_REL of the mesh extent where the ids agree, snap ids equal
    but for near ties of the f64 distances (count printed), labels equal
    where the snap ids agree; then the stage's ms with and without the snap
    (CUDA events, median of 20) and its peak memory."""
    import torch
    from garment_pattern_estimation_torch.preprocess import device_sampling as ds

    phase = 'device_sampling'
    host = mesh_batch()
    mesh = {k: v.cuda() for k, v in host.items()}
    sampler = ds.make_batch_sampler(mesh_data_config())
    draws = sampler.draws(torch.Generator().manual_seed(0), BATCH, 'cpu')
    card_draws = [d.cuda() for d in draws]
    pts, ids = ds.sample_surface_from_draws(mesh['verts'], mesh['faces'], *card_draws,
                                            MESH_NOISE_W)
    ref_pts, ref_ids = ds.sample_surface_from_draws(host['verts'], host['faces'], *draws,
                                                    MESH_NOISE_W)
    valid = torch.ones(BATCH, MESH_V_CAP, dtype=torch.bool)
    snap = ds.snap_to_vertices(pts, mesh['verts'], valid.cuda()).cpu()
    ref_snap = ds.snap_to_vertices(ref_pts, host['verts'], valid)
    std, labels = sampler.from_draws(mesh, *card_draws)
    ref_std, ref_labels = sampler.from_draws(host, *draws)
    pts, ids, std, labels = pts.cpu(), ids.cpu(), std.cpu(), labels.cpu()

    same = ids == ref_ids
    cdf = torch.cumsum(ds.face_areas(host['verts'], host['faces']), -1).double()
    card_cdf = torch.cumsum(ds.face_areas(mesh['verts'], mesh['faces']), -1).cpu().double()
    total = cdf[:, -1]
    # a draw lands on another face only within MESH_BOUNDARY_REL of a step,
    # or within the devices' own disagreement on the steps and the total
    slack = (card_cdf - cdf).abs().amax(1) + (card_cdf[:, -1] - total).abs()
    allowance = torch.maximum(slack, MESH_BOUNDARY_REL * total)
    for b, n in (~same).nonzero().tolist():
        gap = float((cdf[b] - float(draws[0][b, n]) * total[b]).abs().min())
        check(gap <= float(allowance[b]),
              f'{phase}: face id of point ({b}, {n}) differs {gap / float(total[b])} of the '
              'total area from a step')
    extent = (host['verts'].amax(1) - host['verts'].amin(1)).amax(1)
    point_gap = float(((pts - ref_pts).abs().amax(-1) / extent[:, None])[same].max())
    check(point_gap <= MESH_POINT_REL, f'{phase}: points {point_gap} of the extent apart')
    scale = torch.tensor(MESH_STATS['f_scale'])
    std_gap = float((((std - ref_std).abs() * scale).amax(-1) / extent[:, None])[same].max())
    check(std_gap <= MESH_POINT_REL, f'{phase}: standardized points {std_gap} apart')
    differ = ((snap != ref_snap) & same).nonzero().tolist()
    for b, n in differ:
        p = ref_pts[b, n].double()
        d = [float(((host['verts'][b, i].double() - p) ** 2).sum())
             for i in (int(ref_snap[b, n]), int(snap[b, n]))]
        check(abs(d[1] - d[0]) <= MESH_TIE_REL * max(d[0], 1e-30),
              f'{phase}: snap of ({b}, {n}) differs beyond a near tie: {d}')
    agree = same & (snap == ref_snap)
    check(bool((labels == ref_labels)[agree].all()), f'{phase}: labels differ')
    check(labels.dtype == torch.int32 and bool((labels >= 0).all()),
          f'{phase}: labels {labels.dtype}, min {int(labels.min())}')

    gen = torch.Generator(device='cuda').manual_seed(1)
    times, peaks = {}, {}
    for key, with_labels in (('with_snap', True), ('without_snap', False)):
        times[key] = cuda_ms(lambda: sampler(gen, mesh, labels=with_labels))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        sampler(gen, mesh, labels=with_labels)
        torch.cuda.synchronize()
        peaks[key] = (torch.cuda.max_memory_allocated() - base) / 1e9
    emit({'phase': phase, 'meshes': [BATCH, MESH_V_CAP, MESH_F_CAP], 'points': POINTS,
          'point_noise_w': MESH_NOISE_W, 'face_id_boundary_draws': int((~same).sum()),
          'max_cdf_slack_of_total': float((slack / total).max()),
          'snap_near_ties': len(differ), 'max_point_gap_of_extent': point_gap,
          'max_std_gap_of_extent': std_gap, 'ms': times, 'peak_memory_gb': peaks,
          'snap_chunk_bytes': ds.SNAP_CHUNK_BYTES})


def mesh_to_prediction_phase(bf16=False):
    """make_predict_fn with the sampler on the card-resident mesh batch of
    device_sampling (att at the published widths, seeded weights, f32 or the
    bf16 mode): SERVE_CALLS calls, outputs shaped and finite, exactly 1 + 1
    fused launches per call and no snap; ms per batch (median after the
    first call), clouds/s, peak memory, and the forward alone on one of the
    stage's clouds the same way, so the sampler's share shows. Returns the
    launches."""
    import torch
    from garment_pattern_estimation_torch.models import build_model
    from garment_pattern_estimation_torch.ops import edgeconv, knn_gather, launches_by_variant
    from garment_pattern_estimation_torch.preprocess import device_sampling as ds
    from garment_pattern_estimation_torch.train import make_predict_fn

    suffix = '_bf16' if bf16 else ''
    phase = 'mesh_to_prediction' + suffix
    model_name, nn_section, _ = VARIANTS[suffix]
    config = mesh_data_config()
    model = build_model(model_name, config, nn_section, seed=0)
    sampler = ds.make_batch_sampler(config)
    mesh = {k: v.cuda() for k, v in mesh_batch().items()}
    predict = make_predict_fn(model, device_sampler=sampler)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with SnapCounter() as snaps:
        preds, times = timed_calls(lambda: predict(mesh), SERVE_CALLS)
    launches = launches_by_variant(edgeconv)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = {'small_c': SERVE_CALLS, 'wide_c': SERVE_CALLS,
                'small_c_tiled': 0, 'wide_c_tiled': 0}
    check(launches == expected, f'{phase}: launches {launches}, expected {expected}')
    check(not any(launches_by_variant(knn_gather).values()),
          f'{phase}: knn_gather launched {launches_by_variant(knn_gather)}')
    check(snaps.calls == 0, f'{phase}: the snap ran {snaps.calls} times')
    check_outputs(phase, {k: torch.from_numpy(v) for k, v in preds.items()}, BATCH, POINTS)

    points, _ = sampler(torch.Generator(device='cuda').manual_seed(2), mesh, labels=False)
    forward = make_predict_fn(model)
    _, forward_times = timed_calls(lambda: forward(points), SERVE_CALLS)
    q1, batch_ms, q3 = statistics.quantiles(times[1:], n=4)
    forward_ms = statistics.median(forward_times[1:])
    emit({'phase': phase, 'model': model_name, 'compute_dtype': model.config['compute_dtype'],
          'meshes': [BATCH, MESH_V_CAP, MESH_F_CAP], 'points': POINTS, 'calls': SERVE_CALLS,
          'launches': launches, 'snap_calls': snaps.calls, 'first_call_ms': times[0],
          'batch_ms': batch_ms, 'batch_ms_quartiles': [q1, q3],
          'clouds_per_s': BATCH / batch_ms * 1e3, 'peak_memory_gb': peak_gb,
          'forward_alone_ms': forward_ms, 'sampler_share': 1.0 - forward_ms / batch_ms})
    return launches


def fit_on_device_phase(out_dir, fit_run_id):
    """Trainer.fit as the `fit` phase (att f32, parity_run/data_big, batch 30,
    FIT_EPOCHS epochs) with dataset.on_device_sampling at the default caps
    (8192 vertices, 16384 faces) and trainer.profile FIT_PROFILE: finite
    losses; every training step draws another cloud and validation one per
    epoch (seeds and draws agree); exact launches of rows 4-5 (one each per
    validation batch) and 8-9 (one each per step); no snap (att.yaml's loss
    reads no labels); 'best' and 'latest' load back; the profiler's trace
    exists and names rows 8-9's kernels. Per epoch: ms per step in the batch
    loop and the loader-wait share, beside the host-sampled fit run's.
    Returns the launches."""
    import torch
    from garment_pattern_estimation_torch.experiment import ExperimentWrappper
    from garment_pattern_estimation_torch.models import build_model
    from garment_pattern_estimation_torch.preprocess import device_sampling as ds
    from garment_pattern_estimation_torch.train import Trainer

    phase = 'fit_on_device'
    model_name, nn_section, loss_section = VARIANTS['']
    setup = dict(ATT_TRAINER, epochs=FIT_EPOCHS, profile=FIT_PROFILE)
    start = time.perf_counter()
    dataset = fit_dataset(on_device_sampling=True)
    experiment = ExperimentWrappper({'experiment': {'project_name': 'chip_smoke',
                                                    'run_name': phase}},
                                    output_root=out_dir)
    trainer = Trainer(setup, experiment, dataset, dict(FIT_SPLIT))
    setup_s = time.perf_counter() - start
    model = build_model(model_name, dataset.config, nn_section, loss_section, seed=0)

    seen = []
    draws = ds.BatchSampler.draws

    def recorded(self, generator, batch, device):
        out = draws(self, generator, batch, device)
        seen.append((generator.initial_seed(), out[0][0, :16].clone()))
        return out
    ds.BatchSampler.draws = recorded
    reset_launches()
    try:
        with SnapCounter() as snaps:
            start = time.perf_counter()
            trainer.fit(model)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - start
    finally:
        ds.BatchSampler.draws = draws
    launches = phase_launches()
    steps, epochs = read_records(experiment)
    spe = len(trainer.datawrapper.loaders.train)
    n_valid = len(trainer.datawrapper.loaders.validation)
    check([r['epoch'] for r in epochs] == list(range(FIT_EPOCHS)),
          f'{phase}: epochs {[r["epoch"] for r in epochs]}')
    check(len(steps) == FIT_EPOCHS * spe, f'{phase}: {len(steps)} steps')
    check(all(math.isfinite(r['loss']) for r in steps)
          and all(math.isfinite(r['valid_loss']) for r in epochs), f'{phase}: a loss is not finite')
    expected = {'fused_small_c': FIT_EPOCHS * n_valid, 'fused_wide_c': FIT_EPOCHS * n_valid,
                'fused_small_c_tiled': 0, 'fused_wide_c_tiled': 0,
                'knn_gather_fwd_small_c': FIT_EPOCHS * spe,
                'knn_gather_fwd_wide_c': FIT_EPOCHS * spe,
                'knn_gather_bwd': FIT_EPOCHS * spe, 'knn_gather_bwd_hi': 0}
    check(launches == expected, f'{phase}: launches {launches}, expected {expected}')
    check(snaps.calls == 0, f'{phase}: the snap ran {snaps.calls} times')
    seeds = [s for s, _ in seen]
    check(len(seen) == FIT_EPOCHS * (spe + n_valid)
          and len(set(seeds)) == FIT_EPOCHS * (spe + 1),
          f'{phase}: {len(seen)} draws from {len(set(seeds))} streams')
    for (s0, d0), (s1, d1) in zip(seen, seen[1:]):
        check((s0 == s1) == bool(torch.equal(d0, d1)),
              f'{phase}: draws of streams {s0} and {s1} do not follow their seeds')

    twin = build_model(model_name, dataset.config, nn_section, loss_section, seed=1)
    for alias in ('best', 'latest'):
        state = experiment.get_checkpoint_file(alias, map_location='cuda')
        twin.module.load_state_dict(state['model'])
        trainer.optimizer.load_state_dict(state['optimizer'])
    trace = experiment.run_dir() / 'profile' / (
        f'steps_{FIT_PROFILE["start_step"]}-'
        f'{FIT_PROFILE["start_step"] + FIT_PROFILE["num_steps"]}.pt.trace.json')
    check(trace.exists(), f'{phase}: no profiler trace {trace.name}')
    names = {e.get('name', '') for e in json.loads(trace.read_text())['traceEvents']}
    traced = {kernel: any(kernel in n for n in names) for kernel in FIT_TRACE_KERNELS}
    check(all(traced.values()), f'{phase}: the trace lacks kernels: {traced}')

    host_exp = ExperimentWrappper({'experiment': {'project_name': 'chip_smoke',
                                                  'run_name': 'fit', 'run_id': fit_run_id}},
                                  output_root=out_dir)
    host_steps, host_epochs = read_records(host_exp)

    def per_epoch(records, step_records):
        return [{'epoch': r['epoch'], 'epoch_s': r['epoch_time'],
                 'train_loop_ms_per_step': r['train_time'] / spe * 1e3,
                 'loader_wait_share': r['data_time'] / r['epoch_time'],
                 'median_host_step_ms': statistics.median(
                     s['step_time'] for s in step_records if s['epoch'] == r['epoch']) * 1e3,
                 'train_loss': statistics.mean(s['loss'] for s in step_records
                                               if s['epoch'] == r['epoch']),
                 'valid_loss': r['valid_loss']}
                for r in records if r['epoch'] < FIT_EPOCHS]

    emit({'phase': phase, 'model': model_name, 'garments': len(dataset),
          'batch': setup['batch_size'], 'points': POINTS,
          'caps': [dataset.config['mesh_vertex_cap'], dataset.config['mesh_face_cap']],
          'steps_per_epoch': spe, 'valid_batches': n_valid, 'setup_s': setup_s,
          'fit_s': fit_s, 'launches': launches, 'snap_calls': snaps.calls,
          'draw_streams': len(set(seeds)), 'profile': {'window': FIT_PROFILE,
                                                       'trace_mb': trace.stat().st_size / 1e6,
                                                       'kernels_traced': traced},
          'per_epoch': per_epoch(epochs, steps),
          'host_sampled_fit_per_epoch': per_epoch(host_epochs, host_steps)})
    return launches


# configs/stitch_model.yaml, its dataset, NN and trainer sections (copied:
# the YAML may not be readable where this runs; the NN section less its
# `pre-trained` path, a file outside the repository; the parameter filter
# the port's copy of the file the YAML names);
# tests/test_torch_stitch_pipeline.py holds them equal to the file
STITCH_DATASET = {
    'class': 'GarmentStitchPairsDataset',
    'data_folders': ['dress_sleeveless_2550', 'jumpsuit_sleeveless_2000', 'skirt_8_panels_1000',
                     'wb_pants_straight_1500', 'skirt_2_panels_1200', 'jacket_2200',
                     'tee_sleeveless_1800', 'wb_dress_sleeveless_2600', 'jacket_hood_2700',
                     'pants_straight_sides_1000', 'tee_2300', 'skirt_4_panels_1600'],
    'unseen_data_folders': ['jacket_hood_sleeveless_150', 'skirt_waistband_150', 'tee_hood_150',
                            'jacket_sleeveless_150', 'dress_150', 'jumpsuit_150',
                            'wb_jumpsuit_sleeveless_150'],
    'old_experiment': {'project_name': 'Garments-Reconstruction',
                       'run_name': 'NeuralTailor-Train', 'run_id': None, 'stats': False,
                       'predictions': True},
    'random_pairs_mode': True, 'stitched_edge_pairs_num': 200,
    'non_stitched_edge_pairs_num': 200, 'shuffle_pairs': True, 'shuffle_pairs_order': True,
    'max_datapoints_per_type': 5000,
    'filter_by_params': './garment_pattern_estimation_torch/data_configs/param_filter.json',
}
STITCH_NN = {'model': 'StitchOnEdge3DPairs', 'stitch_hidden_size': 200, 'stitch_mlp_n_layers': 3,
             'loss': {'loss_components': ['edge_pair_class'],
                      'quality_components': ['edge_pair_class', 'edge_pair_stitch_recall']}}
STITCH_TRAINER = {'batch_size': 30, 'epochs': 400, 'random_seed': 300, 'learning_rate': 0.002,
                  'optimizer': 'Adam', 'weight_decay': 0, 'lr_scheduling': {'mode': '1cyclic'},
                  'early_stopping': {'window': 0.0001, 'patience': 50},
                  'with_visualization': False}
# the att f32 fit run is resumed to this many epochs before its predictions:
# after 3 epochs no predicted pattern keeps its stitches (a GT stitch needs
# both panels' slots predicted, and a slot whose edges all stay within 1.5 cm
# is dropped); PERF.md counts the patterns that keep them after each number
# of epochs, and step (1) fails if one of them keeps none
STITCH_SHAPE_EPOCHS = 24
STITCH_STEP_CALLS = 8
STITCH_CPU_GARMENTS = 4
# the first stitch step on the card is held to the same step in float64 on
# the CPU: its gaps to f64 within these bars or ORDER_FLOOR_FACTOR times the
# largest gap of the CPU f32 step over every order of the garments. The
# step's BatchNorm variances are E[x^2] - E[x]^2 in f32 (as the JAX MLP's):
# where a batch's rows differ little against their mean (each garment's
# stitched pairs repeat its few stitches) the rounding of that difference
# moves the whole gradient (tests/test_torch_stitch_conditioning.py: up to
# 9e-3 of its norm on the CPU alone)
STITCH_LOSS_REL = 1e-5
STITCH_GRAD_REL = 1e-4
STITCH_BUCKET_ABS = 1e-6


def _stitch_first_step(data_config, setup, initial, garments, device, steps_per_epoch,
                       f64=False, record=None):
    """The stitch model's first Trainer.train_step from the weights
    `initial` on `garments` on `device` (in float64 throughout with `f64`):
    (loss, {name: gradient on the host}). `record` (a list) gets each
    BatchNorm's worst E[x^2] / (var + eps) over its channels
    ('cancellation'), and the last one's batch variance and share of
    zeros in its ReLU'd input column."""
    import torch
    from garment_pattern_estimation_torch.models import build_model
    from garment_pattern_estimation_torch.models.blocks import MLP
    from garment_pattern_estimation_torch.train import Trainer

    twin = build_model('StitchOnEdge3DPairs', data_config, STITCH_NN, STITCH_NN['loss'],
                       device=device, seed=0)
    twin.module.load_state_dict(initial)
    stepper = Trainer(setup, device=device)
    stepper.make_optimizer(twin, steps_per_epoch)
    features = garments['features']
    if f64:
        twin.module.double()
        features = features.double()
    real = MLP._moments

    def moments(self, x):
        mean, var = real(self, x)
        sq = (x.double() ** 2).mean(dim=tuple(range(x.dim() - 1)))
        record.append({'cancellation': (sq / (var.double() + self.eps)).max().item(),
                       'var': var.double().max().item(),
                       'zero_share': (x == 0).double().mean().item()})
        return mean, var

    if record is not None:
        MLP._moments = moments
    try:
        with _float64(f64):
            loss, _ = stepper.train_step(twin, {'features': features,
                                                'ground_truth': garments['ground_truth']}, 0)
    finally:
        MLP._moments = real
    return loss.item(), {n: p.grad.detach().cpu().double()
                         for n, p in twin.module.named_parameters()}


def _stitch_gaps(run, ref):
    """(relative loss gap, the gradient's relative L2 gap) of a
    `_stitch_first_step` result to `ref`'s."""
    return (abs(run[0] - ref[0]) / abs(ref[0]),
            gradient_gap(run[1], ref[1])['grad_rel_l2'])


def stitch_order_floors(step, garments, exact, orders=None):
    """The largest (loss, gradient) gaps to `exact` of `step` (a function of
    a batch) on `garments` in each of `orders` (every order of the
    garments: the same sums in other orders)."""
    orders = orders or list(itertools.permutations(range(len(garments['features']))))
    gaps = [_stitch_gaps(step({k: v[list(order)] for k, v in garments.items()}), exact)
            for order in orders]
    return [max(g[i] for g in gaps) for i in (0, 1)]


def stitch_bars(floors):
    """The stitch check's (loss, gradient) bars from `stitch_order_floors`:
    STITCH_LOSS_REL and STITCH_GRAD_REL, or ORDER_FLOOR_FACTOR times the
    floor where that is larger."""
    return [max(fixed, ORDER_FLOOR_FACTOR * floor)
            for fixed, floor in zip((STITCH_LOSS_REL, STITCH_GRAD_REL), floors)]


def stitch_step_check(data_config, setup, initial, garments, steps_per_epoch):
    """The stitch model's first step on `garments` on the card against the
    same step in float64 on the CPU, from the weights `initial`: (the
    step's line, the direct gaps to the CPU f32 step). Held (`held`): the
    card's loss and gradient gaps to f64 within STITCH_LOSS_REL and
    STITCH_GRAD_REL, or ORDER_FLOOR_FACTOR times the largest such gap of
    the CPU f32 step over every order of the garments where that is
    larger. The line also gives the CPU f32 step's gaps in the batch's
    order, the card's worst parameter against f64, each BatchNorm's
    cancellation E[x^2] / (var + eps) and the logit column's batch
    variance and share of zeros on the card."""
    def step(device, batch=garments, f64=False, record=None):
        return _stitch_first_step(data_config, setup, initial, batch, device, steps_per_epoch,
                                  f64, record)

    record = []
    card, cpu, exact = step('cuda', record=record), step('cpu'), step('cpu', f64=True)
    card_gaps, cpu_gaps = _stitch_gaps(card, exact), _stitch_gaps(cpu, exact)
    floors = stitch_order_floors(lambda batch: step('cpu', batch), garments, exact)
    bars = stitch_bars(floors)
    line = {
        'card_to_f64': {'loss_rel': card_gaps[0], 'grad_rel_l2': card_gaps[1]},
        'cpu_to_f64': {'loss_rel': cpu_gaps[0], 'grad_rel_l2': cpu_gaps[1]},
        'cpu_orders_to_f64_max': {'loss_rel': floors[0], 'grad_rel_l2': floors[1]},
        'bars': {'loss_rel': bars[0], 'grad_rel_l2': bars[1]},
        'held': card_gaps[0] <= bars[0] and card_gaps[1] <= bars[1],
        'card_worst_param_to_f64': gradient_gap(card[1], exact[1])['worst_param'],
        'logit_bn_batch_var': record[-1]['var'],
        'logit_relu_zero_share': record[-1]['zero_share'],
        'moments_cancellation': [r['cancellation'] for r in record]}
    return line, {'loss_rel': abs(card[0] - cpu[0]) / abs(cpu[0]),
                  **gradient_gap(card[1], cpu[1])}


def stitch_pipeline_phase(out_dir, shape_run_id, pairs_seed=None):
    """The two-stage pipeline of configs/stitch_model.yaml on the att f32
    run that `fit` finished (`shape_run_id` under `out_dir`): (0) the run
    resumed from 'latest' to STITCH_SHAPE_EPOCHS epochs (Trainer.fit), then
    five steps: (1) the run's dataset and best model rebuilt (`load_dataset`,
    `load_model`), every split section predicted (`make_predict_fn`) and
    saved (`prediction`), the sections merged (`merge_repos`), exactly one
    launch of rows 4 and 5 per predicted batch; (2) GarmentStitchPairsDataset
    on the merged root with stitch_model.yaml's dataset section, only the
    data folders, the split (FIT_SPLIT) and the parameter filter (none)
    changed, the pairs drawn from a printed seed (`pairs_seed`, a
    replayed draw; fresh entropy where None); (3) the eval forward of a (30, 400,
    16) batch and Trainer.train_step (ms, pairs/s, peak memory), and the
    first step on STITCH_CPU_GARMENTS garments against the same step in
    float64 on the CPU from the same weights: the card's loss within
    STITCH_LOSS_REL relative of the f64 loss and its gradient within
    STITCH_GRAD_REL of the f64 gradient's norm, or ORDER_FLOOR_FACTOR
    times the largest such gap of the CPU f32 step over every order of
    the garments where that is larger (the step's own conditioning); (4) Trainer.fit for FIT_EPOCHS epochs at
    the published widths and batch 30, then one resumed epoch: the mean
    training loss must fall, the validation section's pair accuracy and
    stitch recall from `eval_metrics`; (5) `eval_metrics` on the test
    section in the exhaustive mode (every cross-panel pair, batch 1, padded
    to power-of-two buckets and masked) and the stitches written back
    through `save_prediction_batch` with the bucketed predict function,
    whose logits must equal the unpadded forward's to STITCH_BUCKET_ABS of
    their scale. Returns the phase's launches: rows 4-5 once per validation
    batch of step (0) and once per predicted batch of step (1), rows 8-9
    once per training step of step (0); steps (2)-(5) launch none."""
    import torch
    from garment_pattern_estimation_torch.cli.common import merge_repos
    from garment_pattern_estimation_torch.data import DatasetWrapper, GarmentStitchPairsDataset
    from garment_pattern_estimation_torch.experiment import ExperimentWrappper
    from garment_pattern_estimation_torch.models import build_model
    from garment_pattern_estimation_torch.train import Trainer, eval_metrics, make_predict_fn
    from garment_pattern_estimation_torch.train.eval_utils import _bucket_size

    line = {'phase': 'stitch_pipeline', 'shape_run': f'fit_{shape_run_id}'}
    sections = ['train', 'validation', 'test']

    # (0) the shape stage trained on: the att f32 run resumed
    start = time.perf_counter()
    resumed_shape = ExperimentWrappper({'experiment': {'project_name': 'chip_smoke',
                                                       'run_name': 'fit',
                                                       'run_id': shape_run_id}},
                                       output_root=out_dir)
    shape_trainer = Trainer(dict(ATT_TRAINER, epochs=STITCH_SHAPE_EPOCHS), resumed_shape,
                            fit_dataset(), dict(FIT_SPLIT))
    reset_launches()
    model_name, nn_section, loss_section = VARIANTS['']
    shape_trainer.fit(build_model(model_name, shape_trainer.datawrapper.dataset.config,
                                  nn_section, loss_section, seed=0))
    torch.cuda.synchronize()
    _, shape_epochs = read_records(resumed_shape)
    check([r['epoch'] for r in shape_epochs] == list(range(STITCH_SHAPE_EPOCHS))
          and all(math.isfinite(r['valid_loss']) for r in shape_epochs),
          f'stitch_pipeline: the shape run\'s epochs {[r["epoch"] for r in shape_epochs]}')

    # rows 4-5 once per validation batch, rows 8-9 once per step
    resumed = STITCH_SHAPE_EPOCHS - FIT_EPOCHS - 1
    steps = resumed * len(shape_trainer.datawrapper.loaders.train)
    valid = resumed * len(shape_trainer.datawrapper.loaders.validation)
    shape_launches = phase_launches()
    expected = {'fused_small_c': valid, 'fused_wide_c': valid, 'fused_small_c_tiled': 0,
                'fused_wide_c_tiled': 0, 'knn_gather_fwd_small_c': steps,
                'knn_gather_fwd_wide_c': steps, 'knn_gather_bwd': steps, 'knn_gather_bwd_hi': 0}
    check(shape_launches == expected,
          f'stitch_pipeline: shape-stage launches {shape_launches}, expected {expected}')
    line['shape_stage'] = {
        'resumed_epochs': [FIT_EPOCHS + 1, STITCH_SHAPE_EPOCHS - 1],
        'resume_s': time.perf_counter() - start,
        'valid_loss': [shape_epochs[FIT_EPOCHS]['valid_loss'], shape_epochs[-1]['valid_loss']],
        'launches': shape_launches}

    # (1) shape predictions
    start = time.perf_counter()
    shape_exp = ExperimentWrappper({'experiment': {'project_name': 'chip_smoke',
                                                   'run_name': 'fit', 'run_id': shape_run_id}},
                                   output_root=out_dir)
    shape_dataset, shape_wrapper = shape_exp.load_dataset(ROOT / 'parity_run' / 'data_big')
    shape_model, shape_state = shape_exp.load_model(shape_dataset.config)
    load_s = time.perf_counter() - start
    predict = make_predict_fn(shape_model, shape_state)
    batches = sum(len(shape_wrapper.get_loader(s)) for s in sections)
    garments = len(shape_wrapper.get_loader('train')) * shape_wrapper.batch_size \
        + len(shape_wrapper.validation) + len(shape_wrapper.test)
    start = time.perf_counter()
    pred_path = shape_exp.prediction(out_dir, predict, shape_wrapper, nick='',
                                     sections=sections)
    predict_s = time.perf_counter() - start
    launches = {k: v - shape_launches[k] for k, v in phase_launches().items()}
    expected = {k: batches if k in ('fused_small_c', 'fused_wide_c') else 0 for k in launches}
    check(launches == expected, f'stitch_pipeline: prediction launches {launches}, '
          f'expected {expected} ({batches} batches)')
    merged = merge_repos(pred_path, sections)
    written = sorted(merged.glob('*/*/*_predicted__specification.json'))
    check(len(written) > 0, 'stitch_pipeline: no predicted pattern was written')
    with_stitches = sum(bool(json.loads(f.read_text())['pattern']['stitches'])
                        for f in written)
    check(with_stitches == len(written),
          f'stitch_pipeline: {len(written) - with_stitches} of {len(written)} predicted '
          f'patterns keep no stitch (the shape stage is under-trained)')
    line['predictions'] = {
        'garments': garments, 'batches': batches, 'load_s': load_s, 'predict_save_s': predict_s,
        'garments_per_s': garments / predict_s, 'written': len(written),
        'skipped': garments - len(written), 'with_stitches': with_stitches,
        'launches': launches, 'merge_s': time.perf_counter() - start - predict_s}

    # (2) the stitch dataset on the merged root
    start = time.perf_counter()
    if pairs_seed is None:
        pairs_seed = random.SystemRandom().randrange(2 ** 31)
    line['pairs_seed'] = pairs_seed
    data_config = dict(STITCH_DATASET, data_folders=FIT_FOLDERS, filter_by_params=None,
                       pairs_seed=pairs_seed)
    dataset = GarmentStitchPairsDataset(merged, data_config, gt_caching=True,
                                        feature_caching=True)
    setup = dict(STITCH_TRAINER, epochs=FIT_EPOCHS)
    experiment = ExperimentWrappper({'experiment': {'project_name': 'chip_smoke',
                                                    'run_name': 'stitch'}}, output_root=out_dir)
    trainer = Trainer(setup, experiment, dataset, dict(FIT_SPLIT))
    trainer.datawrapper.loaders.train.prefetch = 0
    batch = next(iter(trainer.datawrapper.loaders.train))
    pairs_per_batch = batch['features'].shape[0] * batch['features'].shape[1]
    check(tuple(batch['features'].shape) == (setup['batch_size'], 400, 16)
          and tuple(batch['ground_truth'].shape) == (setup['batch_size'], 400)
          and batch['ground_truth'].dtype == torch.bool,
          f'stitch_pipeline: batch {tuple(batch["features"].shape)}')
    line['dataset'] = {'garments_kept': len(dataset),
                       'split': [len(trainer.datawrapper.training),
                                 len(trainer.datawrapper.validation),
                                 len(trainer.datawrapper.test or [])],
                       'pairs_per_batch': pairs_per_batch,
                       'setup_s': time.perf_counter() - start}

    # (3) the eval forward and the training step at the published widths
    model = build_model('StitchOnEdge3DPairs', dataset.config, STITCH_NN, STITCH_NN['loss'],
                        seed=0)
    initial = {k: v.clone() for k, v in model.module.state_dict().items()}
    on_card = {'features': batch['features'].cuda(), 'ground_truth': batch['ground_truth'].cuda()}
    model.module.eval()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        forward_ms = cuda_ms(lambda: model.module(on_card['features']))
    forward_peak = torch.cuda.max_memory_allocated() / 1e9
    probe = Trainer(setup)
    probe.make_optimizer(model, len(trainer.datawrapper.loaders.train))
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(STITCH_STEP_CALLS):
        out, ms = timed_calls(lambda: probe.train_step(model, on_card, 0), 1)
        losses.append(out[0].item())
        times.append(ms[0])
    step_ms = statistics.median(times[1:])
    check(all(math.isfinite(v) for v in losses), f'stitch_pipeline: step losses {losses}')
    line['forward_and_step'] = {
        'forward_ms': forward_ms, 'forward_pairs_per_s': pairs_per_batch / forward_ms * 1e3,
        'forward_peak_memory_gb': forward_peak, 'step_ms': step_ms,
        'step_ms_first': times[0], 'step_pairs_per_s': pairs_per_batch / step_ms * 1e3,
        'step_peak_memory_gb': torch.cuda.max_memory_allocated() / 1e9,
        'step_losses': [losses[0], losses[-1]]}

    # the first step on a few garments against its f64 witness on the CPU
    small = {'features': batch['features'][:STITCH_CPU_GARMENTS],
             'ground_truth': batch['ground_truth'][:STITCH_CPU_GARMENTS]}
    first_step, gaps = stitch_step_check(dataset.config, setup, initial, small,
                                         len(trainer.datawrapper.loaders.train))
    line['forward_and_step']['vs_cpu_plain'] = gaps
    line['forward_and_step']['first_step'] = first_step
    if not first_step['held']:
        emit(line)
        fail(f'stitch_pipeline: the {STITCH_CPU_GARMENTS}-garment step of pairs_seed '
             f'{pairs_seed} is off its f64 witness beyond the CPU f32 steps\' floor: '
             f'{first_step}')

    # (4) fit, then one resumed epoch
    model = build_model('StitchOnEdge3DPairs', dataset.config, STITCH_NN, STITCH_NN['loss'],
                        seed=0)
    start = time.perf_counter()
    trainer.fit(model)
    resumed_exp = ExperimentWrappper({'experiment': {'project_name': 'chip_smoke',
                                                     'run_name': 'stitch',
                                                     'run_id': experiment.run_id}},
                                     output_root=out_dir)
    resumed = Trainer(dict(setup, epochs=FIT_EPOCHS + 1), resumed_exp, dataset, dict(FIT_SPLIT))
    resumed.fit(model)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - start
    steps, epochs = read_records(resumed_exp)
    spe = len(trainer.datawrapper.loaders.train)
    check([r['epoch'] for r in epochs] == list(range(FIT_EPOCHS + 1))
          and len(steps) == (FIT_EPOCHS + 1) * spe,
          f'stitch_pipeline: epochs {[r["epoch"] for r in epochs]}, {len(steps)} steps')
    means = [statistics.mean(r['loss'] for r in steps if r['epoch'] == e)
             for e in range(FIT_EPOCHS + 1)]
    check(all(math.isfinite(m) for m in means) and means[-1] < means[0],
          f'stitch_pipeline: mean train loss did not fall: {means}')
    best = resumed_exp.get_best_model(map_location='cuda')['model']
    valid = eval_metrics(model, best, resumed.datawrapper, 'validation')
    line['fit'] = {'fit_s': fit_s, 'steps_per_epoch': spe, 'per_epoch': [{
        'epoch': r['epoch'], 'epoch_s': r['epoch_time'],
        'train_loop_ms_per_step': r['train_time'] / spe * 1e3,
        'loader_wait_share': r['data_time'] / r['epoch_time'], 'train_loss': means[r['epoch']],
        'valid_loss': r['valid_loss']} for r in epochs],
        'valid_edge_pair_class_acc': valid['edge_pair_class_acc'],
        'valid_stitch_recall': valid['stitch_recall']}

    # (5) exhaustive eval and stitch write-back on the test section
    dataset.config['random_pairs_mode'] = False
    dataset._drop_cache()
    exhaustive = DatasetWrapper(dataset, known_split=dict(FIT_SPLIT), batch_size=1)
    test_ids = exhaustive.test.indices
    torch.cuda.synchronize()
    start = time.perf_counter()
    test_metrics = eval_metrics(model, best, exhaustive, 'test')
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - start) / len(test_ids) * 1e3
    counts = [dataset[i]['features'].shape[0] for i in test_ids]
    predict_logits = make_predict_fn(model, best, bucket_pairs=True)
    pairs = dataset[test_ids[0]]['features']
    bucketed = predict_logits(pairs)
    with torch.no_grad():
        plain = model.module.eval()(torch.from_numpy(pairs).cuda()).cpu().numpy()
    bucket_gap = float(abs(bucketed - plain).max())
    check(bucket_gap <= STITCH_BUCKET_ABS * max(1.0, float(abs(plain).max())),
          f'stitch_pipeline: bucketed logits off the unpadded forward by {bucket_gap}')
    start = time.perf_counter()
    stitch_path = resumed_exp.prediction(out_dir, predict_logits, exhaustive, nick='stitch_pred',
                                         sections=['test'], model=predict_logits)
    write_s = time.perf_counter() - start
    specs = sorted(stitch_path.glob('test/*/*/*_predicted__specification.json'))
    stitches = [len(json.loads(f.read_text())['pattern']['stitches']) for f in specs]
    check(len(specs) > 0, 'stitch_pipeline: no pattern was written back')
    line['exhaustive'] = {
        'test_patterns': len(test_ids), 'pairs_per_pattern': [min(counts), max(counts)],
        'buckets': sorted({_bucket_size(n) for n in counts}), 'eval_ms_per_pattern': eval_ms,
        'test_metrics': test_metrics, 'bucketed_vs_unpadded_max_abs': bucket_gap,
        'written': len(specs), 'write_ms_per_pattern': write_s / len(test_ids) * 1e3,
        'stitches_per_pattern': [min(stitches), statistics.mean(stitches), max(stitches)]}
    launches = phase_launches()
    check(launches == {k: shape_launches[k] + line['predictions']['launches'][k]
                       for k in launches},
          f'stitch_pipeline: the stitch stages launched {launches}')
    line['launches'] = launches
    emit(line)
    return launches, resumed_exp.run_id


# The evaluation, prediction and export entry points on the att f32 fit run
# (resumed to STITCH_SHAPE_EPOCHS epochs by stitch_pipeline) and the stitch
# run, through the port's CLIs as a user calls them
CLI_CLOUDS = 16                  # .obj and as many .txt clouds for predict_per_example
EXPORT_CALLS = 11
EXPORTS = (('f32', BATCH, POINTS, False), ('bf16', BATCH, POINTS, True),
           ('f32_stress', STRESS_BATCH, STRESS_POINTS, False))


def cli_files(out_dir, shape_run_id, stitch_run_id):
    """The system file and the two run configs the CLIs read: the data root
    of `fit`, the output root `out_dir` (whose `experiments/` holds the
    runs), each config naming its run."""
    system = out_dir / 'system.json'
    system.write_text(json.dumps({'datasets_path': str(ROOT / 'parity_run' / 'data_big'),
                                  'output': str(out_dir)}))
    configs = {}
    for name, run_name, run_id in (('shape', 'fit', shape_run_id),
                                   ('stitch', 'stitch', stitch_run_id)):
        configs[name] = out_dir / f'{name}.yaml'     # JSON is YAML
        configs[name].write_text(json.dumps({'experiment': {
            'project_name': 'chip_smoke', 'run_name': run_name, 'run_id': run_id}}))
    return system, configs


def visualization_phase(runs_dir, fit_run_id):
    """`fit`'s att f32 fit (FIT_EPOCHS epochs, same data, split, widths and
    seed) with `with_visualization` on, as att.yaml ships it: after each
    epoch `_log_an_image` predicts the first validation garment of each
    data folder (one batch) and saves it into `intermediate_preds/`,
    rendered where matplotlib imports (a failed render only warns). Checks
    the launches (rows 4-5 once per validation batch and once per epoch
    for the images, rows 8-9 once per step), len(FIT_FOLDERS) logged
    'pred_img::' keys per epoch, the predicted specs on disk, and a PNG for
    every key where matplotlib imports, none where it does not. Prints the
    epoch seconds beside the flag-off fit's and the image logging's own
    seconds. Returns the launches."""
    import importlib.util
    import torch
    from garment_pattern_estimation_torch.experiment import ExperimentWrappper
    from garment_pattern_estimation_torch.models import build_model
    from garment_pattern_estimation_torch.train import Trainer

    has_matplotlib = importlib.util.find_spec('matplotlib') is not None
    dataset = fit_dataset()
    experiment = ExperimentWrappper({'experiment': {'project_name': 'chip_smoke',
                                                    'run_name': 'visualization'}},
                                    output_root=runs_dir)
    trainer = Trainer(dict(ATT_TRAINER, epochs=FIT_EPOCHS), experiment, dataset,
                      dict(FIT_SPLIT), with_visualization=True)
    log_image, image_s = trainer._log_an_image, []

    def timed_log_image(*args):
        torch.cuda.synchronize()
        start = time.perf_counter()
        log_image(*args)
        torch.cuda.synchronize()
        image_s.append(time.perf_counter() - start)

    trainer._log_an_image = timed_log_image
    model_name, nn_section, loss_section = VARIANTS['']
    model = build_model(model_name, dataset.config, nn_section, loss_section, seed=0)
    reset_launches()
    start = time.perf_counter()
    trainer.fit(model)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - start
    launches = phase_launches()

    spe = len(trainer.datawrapper.loaders.train)
    n_valid = len(trainer.datawrapper.loaders.validation)
    n_image = len(trainer.datawrapper.loaders.valid_single_per_data)
    steps = FIT_EPOCHS * spe
    expected = {'fused_small_c': FIT_EPOCHS * (n_valid + n_image),
                'fused_wide_c': FIT_EPOCHS * (n_valid + n_image), 'fused_small_c_tiled': 0,
                'fused_wide_c_tiled': 0, 'knn_gather_fwd_small_c': steps,
                'knn_gather_fwd_wide_c': steps, 'knn_gather_bwd': steps, 'knn_gather_bwd_hi': 0}
    check(launches == expected, f'visualization: launches {launches}, expected {expected}')
    records = [json.loads(line) for line in
               (experiment.run_dir() / 'metrics.jsonl').read_text().splitlines()]
    images = [(r['epoch'], Path(r[k])) for r in records for k in r if k.startswith('pred_img::')]
    per_epoch = [sum(1 for e, _ in images if e == epoch) for epoch in range(FIT_EPOCHS)]
    check(per_epoch == [len(FIT_FOLDERS)] * FIT_EPOCHS,
          f'visualization: pred_img keys per epoch {per_epoch}')
    preds = experiment.run_dir() / 'intermediate_preds'
    specs = sorted(preds.glob('*/*/*_predicted__specification.json'))
    check(len(specs) == len(FIT_FOLDERS), f'visualization: {len(specs)} predicted specs')
    pngs = sum(path.is_file() for _, path in images)
    check(pngs == (len(images) if has_matplotlib else 0),
          f'visualization: {pngs} of {len(images)} logged images exist, matplotlib '
          f'{"imports" if has_matplotlib else "is missing"}')
    _, epochs = read_records(experiment)
    flag_off = ExperimentWrappper({'experiment': {'project_name': 'chip_smoke',
                                                  'run_name': 'fit', 'run_id': fit_run_id}},
                                  output_root=runs_dir)
    _, off_epochs = read_records(flag_off)
    emit({'phase': 'visualization', 'matplotlib_imports': has_matplotlib,
          'pred_img_keys': len(images), 'pngs_existing': pngs,
          'svgs_existing': len(list(preds.glob('*/*/*_predicted__pattern.svg'))),
          'fit_s': fit_s, 'epoch_s': [r['epoch_time'] for r in epochs],
          'image_logging_s': image_s,
          'epoch_s_flag_off': [r['epoch_time'] for r in off_epochs if r['epoch'] < FIT_EPOCHS],
          'image_batches_per_epoch': n_image, 'launches': launches})
    return launches


def timed_stages(stages, fn, describe):
    """`fn` with each call's wall seconds (synchronized) and
    `describe(args, kwargs)` appended to `stages`."""
    import torch

    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        stages.append(dict(describe(args, kwargs), s=time.perf_counter() - start))
        return out
    return wrapper


def section_batches(wrapper, section):
    loader = wrapper.get_loader(section)
    return sum(len(v) for v in loader.values()) if isinstance(loader, dict) else len(loader)


def on_test_set_phase(out_dir, system, configs):
    """`cli.on_test_set -sh <shape run> -st <stitch run> --predict
    --correct_panels`: the shape run's test section evaluated (whole and by
    data folder) and predicted, the stitch run evaluated on those
    predictions (every cross-panel pair, batch 1, whole and by folder), its
    stitches written back, and the patterns with the right number of panels
    evaluated again. Prints each stage's seconds, the shape and stitch
    metrics, garments/s predicted, ms per pattern of the stitch eval and the
    launches (rows 4-5 once per shape batch evaluated or predicted; the
    stitch model is plain GEMMs). Fails if a stage yields no pattern.
    Returns the launches."""
    import garment_pattern_estimation_torch.cli.on_test_set as cli
    from garment_pattern_estimation_torch.experiment import ExperimentWrappper

    stages = []
    eval_metrics, prediction = cli.eval_metrics, ExperimentWrappper.prediction
    cli.eval_metrics = timed_stages(stages, eval_metrics, lambda a, kw: {
        'stage': 'eval', 'model': a[0].name, 'section': a[3],
        'batches': section_batches(a[2], a[3])})
    ExperimentWrappper.prediction = timed_stages(stages, prediction, lambda a, kw: {
        'stage': 'predict', 'run': a[0].run_name, 'sections': kw['sections'],
        'batches': sum(section_batches(a[3], s) for s in kw['sections'])})
    reset_launches()
    start = time.perf_counter()
    try:
        cli.main(['-sh', str(configs['shape']), '-st', str(configs['stitch']), '--predict',
                  '--correct_panels', '--system', str(system)])
    finally:
        cli.eval_metrics, ExperimentWrappper.prediction = eval_metrics, prediction
    total_s = time.perf_counter() - start
    launches = phase_launches()

    order = [(s['stage'], s.get('section') or s.get('sections')) for s in stages]
    check(order == [('eval', 'test'), ('eval', 'test_per_data_folder'), ('predict', ['test']),
                    ('eval', 'full'), ('eval', 'full_per_data_folder'),
                    ('predict', ['full']), ('eval', 'full'),
                    ('eval', 'full_per_data_folder')],
          f'on_test_set: stages {order}')
    shape_batches = sum(s['batches'] for s in stages[:3])
    expected = {k: shape_batches if k in ('fused_small_c', 'fused_wide_c') else 0
                for k in launches}
    check(launches == expected, f'on_test_set: launches {launches}, expected {expected}')
    predicted = sorted(out_dir.glob('nn_test_pred_*/test/*/*/*_predicted__specification.json'))
    written = sorted(out_dir.glob('nn_test_pred_*/full/*/*/*_predicted__specification.json'))
    stitch_patterns, corr_patterns = stages[3]['batches'], stages[6]['batches']
    check(predicted and stitch_patterns and written and corr_patterns,
          f'on_test_set: a stage yielded no pattern: {len(predicted)} predicted, '
          f'{stitch_patterns} stitch-evaluated, {len(written)} written back, '
          f'{corr_patterns} with the right panel count')
    summaries = {}
    for name in ('shape', 'stitch'):
        run = ExperimentWrappper(json.loads(configs[name].read_text()),
                                 output_root=out_dir / 'experiments')
        summaries[name] = run.summary
    shape_metrics = summaries['shape']['test_on_best']
    stitch_metrics = summaries['stitch']['test_preds_full']
    check(all(v is None or math.isfinite(v) for v in
              [*shape_metrics.values(), *stitch_metrics.values()]),
          f'on_test_set: metrics not finite: {shape_metrics} {stitch_metrics}')
    emit({'phase': 'on_test_set', 'total_s': total_s, 'stages': stages,
          'shape_test_metrics': shape_metrics, 'stitch_test_metrics': stitch_metrics,
          'stitch_correct_panels_metrics': summaries['stitch']['test_corr_full'],
          'garments_predicted': len(predicted),
          'garments_per_s_predicted': len(predicted) / stages[2]['s'],
          'stitch_eval_patterns': stitch_patterns,
          'stitch_eval_ms_per_pattern': stages[3]['s'] / stitch_patterns * 1e3,
          'written_back': len(written), 'correct_panel_patterns': corr_patterns,
          'launches': launches})
    return launches


def predict_per_example_phase(out_dir, system, configs):
    """`cli.predict_per_example -sh <shape run> -st <stitch run> -dir <dir>`
    on CLI_CLOUDS `.obj` meshes of parity_run/data_big (sampled by the CLI)
    and CLI_CLOUDS `.txt` clouds of POINTS + 100 points sampled from other
    meshes (the CLI resamples them to POINTS): one batch through the shape
    model (rows 4-5 once each), every saved pattern's edge pairs through the
    stitch model. Prints garments/s and the launches. Returns the
    launches."""
    import numpy as np
    import torch
    import garment_pattern_estimation_torch.cli.predict_per_example as cli
    from garment_pattern_estimation_torch.preprocess import mesh as mesh_ops

    inputs = out_dir / 'clouds'
    inputs.mkdir()
    meshes = sorted((ROOT / 'parity_run' / 'data_big').glob('*/*/*_sim.obj'))
    meshes = meshes[::len(meshes) // (2 * CLI_CLOUDS)][:2 * CLI_CLOUDS]
    for i, mesh in enumerate(meshes):
        if i % 2:
            verts, faces = mesh_ops.read_triangle_mesh(str(mesh))
            np.savetxt(inputs / f'{mesh.stem}_cloud.txt',
                       mesh_ops.sample_mesh_points(POINTS + 100, verts, faces, seed=i))
        else:
            (inputs / mesh.name).write_bytes(mesh.read_bytes())
    reset_launches()
    start = time.perf_counter()
    saved = cli.main(['-sh', str(configs['shape']), '-st', str(configs['stitch']),
                      '-dir', str(inputs), '--system', str(system)])
    torch.cuda.synchronize()
    total_s = time.perf_counter() - start
    launches = phase_launches()
    expected = {k: 1 if k in ('fused_small_c', 'fused_wide_c') else 0 for k in launches}
    check(launches == expected, f'predict_per_example: launches {launches}, expected {expected}')
    shapes = sorted(Path(saved).glob('shape/*/*_specification.json'))
    stitched = sorted(Path(saved).glob('with_stitches/*/*_specification.json'))
    check(len(shapes) > 0 and len(stitched) == len(shapes),
          f'predict_per_example: {len(shapes)} shapes, {len(stitched)} with stitches saved '
          f'of {2 * CLI_CLOUDS} clouds')
    emit({'phase': 'predict_per_example', 'clouds': {'obj': CLI_CLOUDS, 'txt': CLI_CLOUDS},
          'total_s': total_s, 'garments_per_s': 2 * CLI_CLOUDS / total_s,
          'shapes_saved': len(shapes), 'with_stitches_saved': len(stitched),
          'stitches': sum(len(json.loads(f.read_text())['pattern']['stitches'])
                          for f in stitched),
          'launches': launches})
    return launches


def export_serving_phase(out_dir, system, configs):
    """`cli.export_serving -c <shape run>` of the trained att model at
    (64, 2000) in f32 and bf16 and at (128, 10000) in f32 (rows 6-7): each
    artifact (torch.export program + manifest) exported, loaded by
    `load_serving_artifact`, called once and EXPORT_CALLS times more
    (exactly one launch of each fused variant per call, the operator
    `gpe_torch::fused_edgeconv` launching the kernel), its outputs against
    `build_serving_fn` of the same checkpoint on the same batch (bitwise
    equal expected: the program runs the eager path's operators; held to
    OUT_MAX_REL of each output's scale, the gap printed), the median warm
    call against the eager pipeline's, and a CPU input refused. Returns
    {artifact: launches of its calls}."""
    import statistics as stats
    import torch
    import garment_pattern_estimation_torch.cli.export_serving as cli
    from garment_pattern_estimation_torch.experiment import (ExperimentWrappper,
                                                             build_serving_fn,
                                                             load_serving_artifact)

    run = ExperimentWrappper(json.loads(configs['shape'].read_text()),
                             output_root=out_dir / 'experiments')
    _, _, data_config = run.data_info()
    results = {}
    for name, batch, points, bf16 in EXPORTS:
        target = out_dir / f'artifact_{name}'
        start = time.perf_counter()
        manifest = cli.main(['-c', str(configs['shape']), '-o', str(target), '-b', str(batch),
                             '-n', str(points), '--system', str(system)]
                            + (['--bf16'] if bf16 else []))
        export_s = time.perf_counter() - start
        start = time.perf_counter()
        served = load_serving_artifact(target)
        load_s = time.perf_counter() - start
        x = physical_points(11, batch, points)

        reset_launches()
        out, first = timed_calls(lambda: served(x), 1)
        _, warm = timed_calls(lambda: served(x), EXPORT_CALLS)
        launches = phase_launches()
        calls = EXPORT_CALLS + 1
        tiled = '_tiled' if points > 2048 else ''
        expected = {k: calls if k in (f'fused_small_c{tiled}', f'fused_wide_c{tiled}') else 0
                    for k in launches}
        check(launches == expected,
              f'export_serving {name}: launches {launches}, expected {expected}')
        check_outputs(f'export_serving {name}', out, batch, points)

        model, _ = run.load_model(data_config,
                                  nn_overrides={'compute_dtype': 'bfloat16'} if bf16 else None)
        serve = build_serving_fn(model, data_config)
        ref, eager = timed_calls(lambda: serve(x), EXPORT_CALLS)
        gaps = {}
        for key, value in ref.items():
            gaps[key] = (out[key] - value).abs().max().item()
            scale = value.abs().max().item()
            check(gaps[key] <= OUT_MAX_REL * scale,
                  f'export_serving {name}: {key} off build_serving_fn by {gaps[key]}')
        refused = None
        try:
            served(x.cpu())
        except ValueError as err:
            refused = str(err)
        check(refused is not None, f'export_serving {name}: a CPU input was not refused')
        results[name] = launches
        emit({'phase': 'export_serving', 'artifact': name, 'batch': [batch, points, 3],
              'compute_dtype': manifest['compute_dtype'], 'platforms': manifest['platforms'],
              'export_s': export_s, 'load_s': load_s, 'mb': manifest['blob_bytes'] / 1e6,
              'first_call_ms': first[0], 'warm_ms': stats.median(warm),
              'warm_ms_quartiles': [stats.quantiles(warm, n=4)[0],
                                    stats.quantiles(warm, n=4)[2]],
              'eager_ms': stats.median(eager), 'bitwise_equal': all(g == 0 for g in gaps.values()),
              'max_abs_gap': gaps, 'launches_per_call': {k: v / calls for k, v in launches.items()},
              'cpu_input_refused': refused})
        del served, model, serve, out, ref
        torch.cuda.empty_cache()
    return results



def check_outputs(name, preds, batch, points, attention=True):
    """The serving outputs' keys, shapes and finiteness; `attention`: the
    attention model's, with its attention weights."""
    import torch

    P, L = ATT_DATA_CONFIG['max_pattern_len'], ATT_DATA_CONFIG['max_panel_len']
    shapes = {'outlines': (batch, P, L, 4), 'rotations': (batch, P, 4),
              'translations': (batch, P, 3), 'stitch_tags': (batch, P, L, 3),
              'free_edges_mask': (batch, P, L)}
    if attention:
        shapes['att_weights'] = (batch, points, P)
    check(sorted(preds) == sorted(shapes), f'{name}: output keys {sorted(preds)}')
    for key, shape in shapes.items():
        check(tuple(preds[key].shape) == shape,
              f'{name}: {key} has shape {tuple(preds[key].shape)}, expected {shape}')
        check(bool(torch.isfinite(preds[key]).all()), f'{name}: {key} is not finite')


def compare_cpu(name, model, serve, small):
    """`serve` on the card against the same weights' plain path on the CPU,
    on the clouds `small`; returns each key's gap."""
    from garment_pattern_estimation_torch.experiment import build_serving_fn

    cpu_model = copy.copy(model)
    cpu_model.module = copy.deepcopy(model.module).cpu()
    on_card = serve(small)
    on_cpu = build_serving_fn(cpu_model, ATT_DATA_CONFIG)(small.cpu())
    ref_err = {}
    for key, ref in on_cpu.items():
        diff = (on_card[key].cpu() - ref).abs()
        scale = ref.abs().max().item()
        if key == 'att_weights':
            # a point whose wide-C neighbours differ by a near tie routes
            # differently: hold 99% of the points to the bound
            off = (diff.amax(dim=-1) > OUT_MAX_REL * scale).float().mean().item()
            ref_err[key] = off
            check(off <= 0.01, f'{name}: {off} of the points off the CPU path')
        else:
            ref_err[key] = diff.max().item() / scale
            check(ref_err[key] <= OUT_MAX_REL,
                  f'{name}: {key} off the CPU path by {ref_err[key]} of its scale')
    return ref_err


def physical_points(seed, batch, points):
    """A standard normal cloud scaled by the published standardization."""
    import torch
    std = ATT_DATA_CONFIG['standardize']
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(batch, points, 3, generator=gen) * torch.tensor(std['f_scale'])
            + torch.tensor(std['f_shift'])).cuda()


def timed_calls(fn, calls):
    """Host-clock ms of each call, each ending in a synchronize."""
    import torch
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return out, times


# the served and fitted models by phase suffix: (model, NN section, loss section);
# '_k20': att.yaml's model with NN.k_neighbors set to DGCNN's 20 in memory
VARIANTS = {'': ('GarmentSegmentPattern3D', ATT_NN_CONFIG, ATT_LOSS_CONFIG),
            '_bf16': ('GarmentSegmentPattern3D', ATT_BF16_NN_CONFIG, ATT_LOSS_CONFIG),
            '_lstm': (LSTM_MODEL, LSTM_NN_CONFIG, LSTM_LOSS_CONFIG),
            '_k20': ('GarmentSegmentPattern3D', dict(ATT_NN_CONFIG, k_neighbors=K_DGCNN),
                     ATT_LOSS_CONFIG),
            '_k20_bf16': ('GarmentSegmentPattern3D',
                          dict(ATT_BF16_NN_CONFIG, k_neighbors=K_DGCNN), ATT_LOSS_CONFIG),
            '_k200': ('GarmentSegmentPattern3D', dict(ATT_NN_CONFIG, k_neighbors=K_LARGE),
                      ATT_LOSS_CONFIG),
            **{variant: ('GarmentSegmentPattern3D', dict(ATT_NN_CONFIG, **change),
                         ATT_LOSS_CONFIG) for variant, change in WIDE_VARIANTS.items()}}


def eval_launches(nn_section, calls):
    """The fused and knn_gather launches of `calls` att eval forwards: conv0
    (C = 3) fused; conv1 (C = EConv_feature) fused up to C = 256, through
    knn_gather's wide forward beyond (fused_edgeconv_supported, as the JAX
    models route it)."""
    wide = nn_section['EConv_feature'] <= 256
    return ({'small_c': calls, 'wide_c': calls if wide else 0, 'small_c_tiled': 0,
             'wide_c_tiled': 0},
            {'fwd_small_c': 0, 'fwd_wide_c': 0 if wide else calls, 'bwd': 0, 'bwd_hi': 0})


def serve_phase(variant='', calls=SERVE_CALLS):
    """Serving of att (`variant` ''), of att in the bf16 mode (att_bf16.yaml,
    '_bf16'), of the baseline (lstm_stitch_tags.yaml, '_lstm') or of att at
    k = 20 ('_k20', '_k20_bf16'): SERVE_CALLS forwards of a (64, 2000, 3)
    batch. Returns the launches, the model, the serving function and the
    batch."""
    import torch
    from garment_pattern_estimation_torch.experiment import build_serving_fn
    from garment_pattern_estimation_torch.models import build_model
    from garment_pattern_estimation_torch.ops import edgeconv, knn_gather, launches_by_variant

    phase = 'serving' + variant
    model_name, nn_section, _ = VARIANTS[variant]
    model = build_model(model_name, ATT_DATA_CONFIG, nn_section, seed=0)
    serve = build_serving_fn(model, ATT_DATA_CONFIG)
    points = physical_points(1, BATCH, POINTS)

    torch.cuda.reset_peak_memory_stats()
    edgeconv.launches_by_shape.clear()
    knn_gather.launches_by_shape.clear()
    preds, times = timed_calls(lambda: serve(points), calls)
    launches = launches_by_variant(edgeconv)
    gather_launches = launches_by_variant(knn_gather)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected, expected_gather = eval_launches(nn_section, calls)
    check(launches == expected,
          f'{phase}: launches {launches}, expected {expected} for {calls} forwards')
    check(gather_launches == expected_gather,
          f'{phase}: knn_gather launched {gather_launches} in eval, expected {expected_gather}')
    check_outputs(phase, preds, BATCH, POINTS, attention=variant != '_lstm')
    # a 2-cloud batch against the plain path of the same weights on the CPU
    ref_err = compare_cpu(phase, model, serve, points[:2])

    # the first call pays one-time set-up (allocator, cuBLAS handles)
    q1, batch_ms, q3 = statistics.quantiles(times[1:], n=4)
    emit({'phase': phase, 'model': model_name, 'batch': [BATCH, POINTS, 3],
          'calls': calls, 'compute_dtype': model.config['compute_dtype'],
          'k_neighbors': nn_section['k_neighbors'], 'econv': [
              nn_section['EConv_hidden'], nn_section['EConv_hidden_depth'],
              nn_section['EConv_feature']],
          'launches': launches, 'launches_per_forward': {
              k: v / calls for k, v in launches.items()},
          'knn_gather_launches': gather_launches,
          'launches_by_shape': {' '.join(map(str, key)): n
                                for key, n in edgeconv.launches_by_shape.items()},
          'first_call_ms': times[0], 'batch_ms': batch_ms,
          'batch_ms_quartiles': [q1, q3],
          'clouds_per_s': BATCH / batch_ms * 1e3, 'peak_memory_gb': peak_gb,
          'vs_cpu_plain': ref_err})
    launches.update({'knn_gather_' + key: n for key, n in gather_launches.items()})
    return launches, model, serve, points


def stress_serving_phase(model, serve, bf16=False, phase=None):
    """The same served model on the stress batch: every EdgeConv layer
    through the column-tiled kernels. Returns the launches and the batch."""
    import torch
    from garment_pattern_estimation_torch.ops import edgeconv, launches_by_variant

    phase = phase or ('stress_serving_bf16' if bf16 else 'stress_serving')
    points = physical_points(6, STRESS_BATCH, STRESS_POINTS)
    torch.cuda.reset_peak_memory_stats()
    edgeconv.launches_by_shape.clear()
    preds, times = timed_calls(lambda: serve(points), STRESS_CALLS)
    launches = launches_by_variant(edgeconv)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = {'small_c': 0, 'wide_c': 0,
                'small_c_tiled': STRESS_CALLS, 'wide_c_tiled': STRESS_CALLS}
    check(launches == expected,
          f'{phase}: launches {launches}, expected {STRESS_CALLS} of each '
          f'tiled variant and no single-tile launch')
    check_outputs(phase, preds, STRESS_BATCH, STRESS_POINTS)
    del preds
    ref_err = compare_cpu(phase, model, serve, points[:1])

    batch_ms = statistics.median(times[1:])
    emit({'phase': phase, 'batch': [STRESS_BATCH, STRESS_POINTS, 3],
          'compute_dtype': model.config['compute_dtype'],
          'k_neighbors': model.config['k_neighbors'],
          'calls': STRESS_CALLS, 'launches': launches, 'launches_per_forward': {
              k: v / STRESS_CALLS for k, v in launches.items()},
          'call_ms': times, 'first_call_ms': times[0], 'batch_ms': batch_ms,
          'clouds_per_s': STRESS_BATCH / batch_ms * 1e3,
          'peak_memory_gb': peak_gb, 'vs_cpu_plain_1_cloud': ref_err})
    return launches, points


def training_batch(gen, batch, device, points=None, stitched=False):
    """A standardized (batch, points (default POINTS), 3) cloud and ground
    truth in the dataset's shapes: 2-12 panels of 3-14 edges, the pad
    vector beyond them. `stitched` (the baseline's loss): empty panels get
    zero placements, so padded panels tie exactly in the order matching,
    and the GT gains the dataset's stitch keys: 4-24 stitches between edges
    inside the loops (ids zero past each count), the free-edge mask they
    leave and the empty-panel mask."""
    import torch
    from garment_pattern_estimation_torch.losses.components import eval_pad_vector

    P, L = ATT_DATA_CONFIG['max_pattern_len'], ATT_DATA_CONFIG['max_panel_len']
    std = ATT_DATA_CONFIG['standardize']
    pad = eval_pad_vector({'shift': std['gt_shift']['outlines'],
                           'scale': std['gt_scale']['outlines']})
    num_panels = torch.randint(2, 13, (batch,), generator=gen)
    num_edges = torch.where(torch.arange(P)[None] < num_panels[:, None],
                            torch.randint(3, L + 1, (batch, P), generator=gen), 0)
    outlines = torch.randn(batch, P, L, 4, generator=gen) * 0.5
    outlines = torch.where((torch.arange(L)[None, None] < num_edges[..., None])[..., None],
                           outlines, pad)
    gt = {'outlines': outlines,
          'rotations': torch.randn(batch, P, 4, generator=gen) * 0.5,
          'translations': torch.randn(batch, P, 3, generator=gen) * 0.5,
          'num_edges': num_edges.int(), 'num_panels': num_panels.int()}
    if stitched:
        exists = (torch.arange(P)[None] < num_panels[:, None])[..., None]
        gt['rotations'] = torch.where(exists, gt['rotations'], 0.0)
        gt['translations'] = torch.where(exists, gt['translations'], 0.0)
        S = ATT_DATA_CONFIG['max_num_stitches']
        stitches = torch.zeros(batch, 2, S, dtype=torch.long)
        num_stitches = torch.randint(4, S + 1, (batch,), generator=gen)
        free = torch.ones(batch, P * L, dtype=torch.bool)
        edge_ids = torch.arange(P * L).reshape(P, L)
        for b in range(batch):
            edges = edge_ids[torch.arange(L)[None] < num_edges[b][:, None]]
            n = min(int(num_stitches[b]), len(edges) // 2)
            chosen = edges[torch.randperm(len(edges), generator=gen)[:2 * n]]
            stitches[b, :, :n] = chosen.reshape(2, n)
            free[b, chosen] = False
            num_stitches[b] = n
        gt.update(stitches=stitches, num_stitches=num_stitches,
                  free_edges_mask=free.reshape(batch, P, L), empty_panels_mask=num_edges == 0)
    return {'features': torch.randn(batch, points or POINTS, 3, generator=gen).to(device),
            'ground_truth': {k: v.to(device) for k, v in gt.items()}}


def step_gradients(model, batch, epoch=0):
    """Loss and parameter gradients of one train-mode forward + backward
    with zero LSTM states at the loss phase of `epoch`, on the module's
    device; no update."""
    model.module.train()
    model.module.zero_grad(set_to_none=True)
    preds = model.module(batch['features'])
    loss, _, _ = model.loss(preds, batch['ground_truth'], epoch=epoch)
    loss.backward()
    return loss.item(), {n: p.grad.detach().cpu() for n, p in model.module.named_parameters()}


def gradient_gap(grads, ref):
    """How far `grads` is from `ref`: the whole gradient's relative L2 gap,
    the worst parameter's relative L2 gap and its name, and the worst
    parameter's largest element gap relative to its largest element."""
    diff = sum(((grads[n] - g) ** 2).sum() for n, g in ref.items()).sqrt()
    norm = sum((g ** 2).sum() for g in ref.values()).sqrt()
    worst = max((((grads[n] - g).norm() / g.norm()).item(), n) for n, g in ref.items())
    max_rel = max(((grads[n] - g).abs().max() / g.abs().max()).item() for n, g in ref.items())
    return {'grad_rel_l2': (diff / norm).item(), 'worst_param_rel_l2': worst[0],
            'worst_param': worst[1], 'worst_element_rel': max_rel}


class StepChoices:
    """The discrete choices of a train-mode forward, recorded on the card
    and replayed on the CPU (see the module docstring). Within `record()`
    the model's knn_gather, kNN and DynamicGraphPool calls run as they are
    and each choice is kept with its input, in call order; `check(name,
    cpu_module)` holds each against the plain version on that input on the
    CPU; within `replay()` the same calls take the recorded choices in the
    same order, the plain arithmetic on them: knn_gather's rows and its
    backward (`knn_gather_backward_reference`), the pool's clusters,
    fitness and gating.

    `kinks`: every `torch.relu` and `torch.amax` of the step (nn.ReLU and
    F.relu call the former) is a choice too: which inputs the ReLU passes,
    and which entries win each max (all of an exact tie). A ReLU input
    within rounding of 0, or two entries of a max within rounding of each
    other, can fall either way on the card and on the CPU, and one such
    entry that a global max pool routes a whole channel's cotangent
    through moves the step's gradient by a percent (pool10's 20-point
    stage). The replay holds each choice that the CPU would make otherwise
    within KINK_TIE_REL of its call's scale (`kink_lines`)."""

    def __init__(self, module, kinks=False):
        self.names = {id(m): n for n, m in module.named_modules()}
        self.records = []
        self.kinks = [] if kinks else None

    @contextlib.contextmanager
    def _patched(self, gather, search, pool, relu=None, amax=None):
        import torch
        from garment_pattern_estimation_torch.models import blocks

        saved = (blocks.knn_gather, blocks.knn_search, blocks.DynamicGraphPool.pool,
                 torch.relu, torch.amax)
        blocks.knn_gather, blocks.knn_search, blocks.DynamicGraphPool.pool = gather, search, pool
        if self.kinks is not None:
            torch.relu, torch.amax = relu, amax
        try:
            yield
        finally:
            (blocks.knn_gather, blocks.knn_search, blocks.DynamicGraphPool.pool,
             torch.relu, torch.amax) = saved

    def record(self):
        import torch
        from garment_pattern_estimation_torch.models import blocks
        gather, search, pool = blocks.knn_gather, blocks.knn_search, blocks.DynamicGraphPool.pool
        relu, amax = torch.relu, torch.amax
        records, names, kinks = self.records, self.names, self.kinks

        def recorded_relu(x):
            kinks.append(('relu', x.shape, (x > 0).cpu()))
            return relu(x)

        def recorded_amax(x, dim=(), keepdim=False):
            kinks.append(('max', x.shape, (x == amax(x, dim=dim, keepdim=True)).cpu()))
            return amax(x, dim=dim, keepdim=keepdim)

        def recorded_gather(x, k, value_chunks=2):
            neighbours, ids = gather(x, k, value_chunks)
            records.append(('knn_gather', x.detach().cpu(), k, value_chunks, ids.cpu()))
            return neighbours, ids

        def recorded_search(x, k):
            ids = search(x, k)
            records.append(('knn', x.detach().cpu(), k, None, ids.cpu()))
            return ids

        def recorded_pool(module, x, idx):
            out, top = pool(module, x, idx)
            weights = {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}
            records.append(('pool', x.detach().cpu(), idx.cpu(), (names[id(module)], weights),
                            top.cpu()))
            return out, top
        return self._patched(recorded_gather, recorded_search, recorded_pool,
                             recorded_relu, recorded_amax)

    def check(self, name, cpu_module):
        """Each recorded choice against the plain version on its recorded
        input (a pool's with its recorded weights, a later step's being
        Adam's update of the first's; `cpu_module`'s are overwritten):
        small-C ids all equal, every wide-C id that differs a near
        tie (`near_tie_ratio`), every kept cluster that differs within
        POOL_TIE_REL of the fitness scale of the cutoff. The share of equal
        ids is reported, not held: the kernel checks hold it at 99% on
        thousands of rows, and a step's 20-point cloud of pooled clusters
        has 400 ids, where one row's near tie moves it by 0.25% a slot.
        Returns a line per choice, after checking them all."""
        import torch
        from garment_pattern_estimation_torch.ops import edgeconv, knn

        modules = dict(cpu_module.named_modules())
        lines, bad = [], []
        for kind, x, a, b, choice in self.records:
            with torch.no_grad():
                if kind == 'pool':            # the pool's weights at its call
                    pool = modules[b[0]]
                    pool.load_state_dict(b[1])
                    cluster, fitness = pool.clusters(x, a)
                    keep = choice.shape[1]
                    ref = torch.sort(fitness, dim=1, descending=True, stable=True).indices[:, :keep]
                    cutoff = fitness.gather(1, ref[:, -1:])
                    kept, ref_kept = (torch.zeros_like(fitness, dtype=torch.bool).scatter_(
                        1, t, True) for t in (choice, ref))
                    differ = kept != ref_kept
                    tie = (fitness - cutoff).abs() <= POOL_TIE_REL * fitness.abs().max()
                    line = {'kind': kind, 'shape': list(x.shape),
                            'kept_differ': int(differ.sum()),
                            'kept_differ_off_tie': int((differ & ~tie).sum())}
                    ok = line['kept_differ_off_tie'] == 0
                else:
                    quantized = kind == 'knn_gather'
                    ref = edgeconv.edgeconv_select(
                        x, a, torch.float32 if b == 2 else torch.bfloat16)[0] \
                        if quantized else knn.knn_reference(x, a)
                    share = (choice == ref).float().mean().item()
                    worst_tie, n_rows, _ = near_tie_ratio(x, choice, ref, quantized)
                    line = {'kind': kind, 'shape': list(x.shape), 'k': a, 'id_share': share,
                            'rows_differ': n_rows, 'worst_near_tie': worst_tie}
                    ok = share == 1.0 if x.shape[-1] <= 16 else worst_tie <= 1.0
            lines.append(line)
            if not ok:
                bad.append(len(lines) - 1)
        check(not bad, f'{name}: the card step\'s choices {bad} are off the plain version: {lines}')
        return lines

    @contextlib.contextmanager
    def replay(self, passthrough=False):
        """`passthrough`: a call that is not the next recorded one (its kind
        and input shape) runs as it is, and takes no record (a run whose
        first layer took another route)."""
        import torch
        from garment_pattern_estimation_torch.ops import edgeconv
        from garment_pattern_estimation_torch.ops.knn_gather import knn_gather_backward_reference
        from garment_pattern_estimation_torch.models import blocks
        pending = list(self.records)
        real = blocks.knn_gather, blocks.knn_search, blocks.DynamicGraphPool.pool
        relu, amax = torch.relu, torch.amax
        kinks = list(self.kinks or ())
        self.kink_lines = {kind: {'calls': 0, 'differ': 0, 'worst_rel': 0.0}
                           for kind in ('relu', 'max')}

        def next_is(kind, x):
            return bool(pending) and pending[0][0] == kind and pending[0][1].shape == x.shape

        def take(kind, x):
            check(next_is(kind, x),
                  f'replay: a {kind} call on {list(x.shape)} where the card made '
                  f'{pending[0][:1] if pending else "no more"}')
            return pending.pop(0)

        class GatherOnIds(torch.autograd.Function):
            """knn_gather's plain forward and backward on given ids."""

            @staticmethod
            def forward(ctx, x, ids, value_chunks):
                B, N, C = x.shape
                rows = edgeconv.gathered_rows(x.float(), value_chunks)
                flat = ids.transpose(1, 2) + (torch.arange(B, device=x.device) * N)[:, None, None]
                neighbours = rows.reshape(B * N, C)[flat.reshape(-1)].reshape(B, -1, N, C)
                neighbours[:, 0] = x.float()
                ctx.save_for_backward(ids)
                ctx.value_chunks = value_chunks
                return neighbours

            @staticmethod
            def backward(ctx, g):
                (ids,) = ctx.saved_tensors
                return knn_gather_backward_reference(ids, g, ctx.value_chunks), None, None

        def replayed_gather(x, k, value_chunks=2):
            if passthrough and not next_is('knn_gather', x):
                return real[0](x, k, value_chunks)
            ids = take('knn_gather', x)[4].to(x.device)
            return GatherOnIds.apply(x, ids, value_chunks), ids

        def replayed_search(x, k):
            if passthrough and not next_is('knn', x):
                return real[1](x, k)
            return take('knn', x)[4].to(x.device)

        def replayed_pool(module, x, idx):
            if passthrough and not next_is('pool', x):
                return real[2](module, x, idx)
            top = take('pool', x)[4].to(x.device)
            cluster, fitness = module.clusters(x, idx)
            return module.select(cluster, fitness, top), top

        def kink(kind, x):
            check(bool(kinks) and kinks[0][:2] == (kind, x.shape),
                  f'replay: a {kind} on {list(x.shape)} where the card made '
                  f'{kinks[0][:2] if kinks else "no more"}')
            return kinks.pop(0)[2].to(x.device)

        def tally(kind, x, differ, off):
            line = self.kink_lines[kind]
            line['calls'] += 1
            line['differ'] += int(differ.sum())
            if differ.any():
                scale = x.abs().max().clamp_min(torch.finfo(x.dtype).tiny)
                line['worst_rel'] = max(line['worst_rel'], (off[differ].max() / scale).item())

        def replayed_relu(x):
            passes = kink('relu', x)
            with torch.no_grad():
                tally('relu', x, passes != (x > 0), x.abs())
            return torch.where(passes, x, torch.zeros((), dtype=x.dtype, device=x.device))

        def replayed_amax(x, dim=(), keepdim=False):
            wins = kink('max', x)
            masked = torch.where(wins, x, torch.full((), -math.inf, dtype=x.dtype,
                                                     device=x.device))
            with torch.no_grad():
                own, took = (amax(t, dim=dim, keepdim=True) for t in (x, masked))
                tally('max', x, ((own != took) & wins), (own - took).expand_as(x))
            return amax(masked, dim=dim, keepdim=keepdim)

        with self._patched(replayed_gather, replayed_search, replayed_pool,
                           replayed_relu, replayed_amax):
            yield
        check(not pending, f'replay: {len(pending)} recorded choices were not taken')
        check(not kinks, f'replay: {len(kinks)} recorded ReLU and max choices were not taken')
        for kind, line in self.kink_lines.items():
            check(line['worst_rel'] <= KINK_TIE_REL,
                  f'replay: a {kind} choice of the card is off the CPU\'s by more than a '
                  f'tie: {self.kink_lines}')


def compare_step_cpu(name, model, batch, clouds, configure=None, order_floor=False,
                     epoch=0, noise_floor=False, kinks=False):
    """Loss and gradients of one train-mode step on the first `clouds`
    clouds on the card against the plain path of the same weights on the
    CPU, at the loss phase of `epoch`, held to the loss and norm bars;
    beside them the floor, the CPU path against itself on the cloud
    perturbed by 1e-7. `configure` (a function of the module) sets both
    copies up first. The CPU step takes the card step's discrete choices,
    each first held against the plain version on the card's input
    (`StepChoices`); the floors' steps make their own.

    `order_floor` (the bf16 mode, clouds >= 2): the CPU path also runs on
    the same clouds in reverse batch order, the same math summed in another
    order, and the gradient bars become the larger of the f32 bars and
    ORDER_FLOOR_FACTOR times that gap. The bf16 mode rounds every product
    and its cotangents to 8 bits, and gradients that are small differences
    of large bf16 terms (conv0's first layer, the biases before a BN) move
    by tens of percent with the order of a sum alone.

    `noise_floor` (a model whose gradient moves under 1e-7 input noise by
    more than the f32 bars): the gradient bars become the larger of the f32
    bars and ORDER_FLOOR_FACTOR times that floor.

    `kinks`: the CPU step also takes the card's ReLU and max choices
    (`StepChoices`), each that the CPU would make otherwise held within
    KINK_TIE_REL of its call's scale; their counts are in the line."""
    import torch

    small = {'features': batch['features'][:clouds],
             'ground_truth': {k: v[:clouds] for k, v in batch['ground_truth'].items()}}
    card_model = copy.copy(model)
    card_model.module = copy.deepcopy(model.module)
    cpu_model = copy.copy(model)
    cpu_model.module = copy.deepcopy(model.module).cpu()
    for m in (card_model, cpu_model):
        if configure is not None:
            configure(m.module)
    choices = StepChoices(card_model.module, kinks)
    with choices.record():
        card_loss, card_grads = step_gradients(card_model, small, epoch)
    choice_lines = choices.check(name, cpu_model.module)
    cpu_small = {'features': small['features'].cpu(),
                 'ground_truth': {k: v.cpu() for k, v in small['ground_truth'].items()}}
    with choices.replay():
        cpu_loss, cpu_grads = step_gradients(cpu_model, cpu_small, epoch)
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    gaps = {'loss_rel': loss_rel, **gradient_gap(card_grads, cpu_grads),
            'choices': choice_lines, **({'kinks': choices.kink_lines} if kinks else {})}
    noisy = cpu_small['features'] * (1 + 1e-7 * torch.randn(
        cpu_small['features'].shape, generator=torch.Generator().manual_seed(5)))
    _, noisy_grads = step_gradients(cpu_model, dict(cpu_small, features=noisy), epoch)
    gaps['cpu_1e-7_noise'] = gradient_gap(noisy_grads, cpu_grads)
    grad_bar, param_bar = TRAIN_GRAD_REL, TRAIN_PARAM_GRAD_REL
    if order_floor:
        flipped = {'features': cpu_small['features'].flip(0),
                   'ground_truth': {k: v.flip(0) for k, v in cpu_small['ground_truth'].items()}}
        _, flipped_grads = step_gradients(cpu_model, flipped, epoch)
        floor = gaps['cpu_cloud_order'] = gradient_gap(flipped_grads, cpu_grads)
        grad_bar = max(grad_bar, ORDER_FLOOR_FACTOR * floor['grad_rel_l2'])
        param_bar = max(param_bar, ORDER_FLOOR_FACTOR * floor['worst_param_rel_l2'])
    if noise_floor:
        floor = gaps['cpu_1e-7_noise']
        grad_bar = max(grad_bar, ORDER_FLOOR_FACTOR * floor['grad_rel_l2'])
        param_bar = max(param_bar, ORDER_FLOOR_FACTOR * floor['worst_param_rel_l2'])
    gaps['bars'] = {'grad_rel_l2': grad_bar, 'worst_param_rel_l2': param_bar}
    check(loss_rel <= TRAIN_LOSS_REL,
          f'{name}: {clouds}-cloud loss off the CPU path by {loss_rel}')
    check(gaps['grad_rel_l2'] <= grad_bar and gaps['worst_param_rel_l2'] <= param_bar,
          f'{name}: gradients off the CPU path: {gaps}')
    return gaps


def train_phase(bf16=False, variant=None, phase=None, batch_size=TRAIN_BATCH,
                steps=TRAIN_STEPS, noise_floor=False):
    """att training, f32 or the bf16 mode (or the model of `variant`):
    `steps` steps on one (batch_size, 2000, 3) batch (30: att.yaml's).
    The bf16 mode gathers and scatters one value chunk (knn_gather's
    'bwd_hi' backward). `noise_floor`: the 2-cloud step's gradient bars
    are the larger of the f32 bars and twice the CPU's own 1e-7 noise
    floor (compare_step_cpu). Returns the launches and a function that
    takes one more step."""
    import torch
    from garment_pattern_estimation_torch.models import build_model
    from garment_pattern_estimation_torch.ops import edgeconv, knn_gather, launches_by_variant
    from garment_pattern_estimation_torch.train import Trainer

    phase = phase or ('training_bf16' if bf16 else 'training')
    per_step_expected = {'fwd_small_c': 1, 'fwd_wide_c': 1, 'bwd': 0 if bf16 else 1,
                         'bwd_hi': 1 if bf16 else 0}
    model_name, nn_section, loss_section = VARIANTS[
        variant if variant is not None else '_bf16' if bf16 else '']
    model = build_model(model_name, ATT_DATA_CONFIG, nn_section, loss_section, seed=0)
    trainer = Trainer(ATT_TRAINER)
    trainer.make_optimizer(model, steps_per_epoch=steps)
    batch = training_batch(torch.Generator().manual_seed(4), batch_size, 'cuda')
    states = torch.Generator(device='cuda').manual_seed(ATT_TRAINER['random_seed'])

    torch.cuda.reset_peak_memory_stats()
    edgeconv.launches_by_shape.clear()
    knn_gather.launches_by_shape.clear()
    losses, times = [], []
    for step in range(steps):
        before = launches_by_variant(knn_gather)
        torch.cuda.synchronize()
        start = time.perf_counter()
        loss, terms = trainer.train_step(model, batch, epoch=0, generator=states)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
        losses.append(loss.item())
        per_step = {key: launches_by_variant(knn_gather)[key] - before[key] for key in before}
        check(per_step == per_step_expected,
              f'{phase}: step {step} launched {per_step}, expected {per_step_expected}')
    launches = launches_by_variant(knn_gather)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(not any(launches_by_variant(edgeconv).values()),
          f'{phase}: the fused eval kernel launched {launches_by_variant(edgeconv)} in train mode')
    check(all(math.isfinite(v) for v in losses), f'{phase}: losses {losses}')
    check(losses[-1] < losses[0], f'{phase}: the loss did not fall: {losses}')
    check(all(p.dtype == torch.float32 for p in model.module.parameters()),
          f'{phase}: a parameter is not f32')

    edgeconv.launches_by_shape.clear()
    knn_gather.launches_by_shape.clear()
    eval_loss, _ = trainer.eval_step(model, batch, epoch=0)
    torch.cuda.synchronize()
    expected, expected_gather = eval_launches(nn_section, 1)
    fused, gathered = launches_by_variant(edgeconv), launches_by_variant(knn_gather)
    check(fused == expected and gathered == expected_gather,
          f'{phase}: eval_step launched {fused} and {gathered}, '
          f'expected {expected} and {expected_gather}')
    check(math.isfinite(eval_loss.item()), f'{phase}: eval loss {eval_loss.item()}')

    # a 2-cloud step against the plain path of the same weights on the CPU
    gaps = compare_step_cpu(phase, model, batch, 2, order_floor=bf16, noise_floor=noise_floor)

    q1, step_ms, q3 = statistics.quantiles(times[1:], n=4)
    emit({'phase': phase, 'batch': [batch_size, POINTS, 3], 'steps': steps,
          'compute_dtype': model.config['compute_dtype'],
          'k_neighbors': nn_section['k_neighbors'],
          'launches': launches, 'losses': losses,
          # a corr_* metric is NaN when no pattern's panel count is right
          'terms_last_step': {k: v.item() if math.isfinite(v.item()) else None
                              for k, v in terms.items()},
          'step_times_ms': times, 'step_ms': step_ms, 'step_ms_quartiles': [q1, q3],
          'clouds_per_s': batch_size / step_ms * 1e3,
          'eval_loss': eval_loss.item(), 'eval_launches': launches_by_variant(edgeconv),
          'vs_cpu_plain': gaps, 'peak_memory_gb': peak_gb})
    return launches, lambda: trainer.train_step(model, batch, epoch=0, generator=states)


def train_lstm_phase():
    """The baseline's training (lstm_stitch_tags.yaml, f32): on one (30,
    2000, 3) batch with the dataset's stitch GT, LSTM_TRAIN_STEPS Adam
    steps at epoch 0 (panel-order and loop-origin matching, no stitch
    terms), then LSTM_TRAIN_STEPS at LSTM_STITCH_EPOCH (the stitch-tag loss,
    free-edge classification, stitch precision/recall over E // 2 = 161
    decode steps). Each phase: 1 + 1 + 1 knn_gather launches per step, no
    fused launch, finite losses, a 2-cloud step against the CPU plain path;
    beside the steps, the loss alone at each phase (host clock, synchronized).
    Returns the launches and a function that takes one more epoch-40 step."""
    import torch
    from garment_pattern_estimation_torch.models import build_model
    from garment_pattern_estimation_torch.ops import edgeconv, knn_gather, launches_by_variant
    from garment_pattern_estimation_torch.train import Trainer

    phase = 'training_lstm'
    per_step_expected = {'fwd_small_c': 1, 'fwd_wide_c': 1, 'bwd': 1, 'bwd_hi': 0}
    model = build_model(LSTM_MODEL, ATT_DATA_CONFIG, LSTM_NN_CONFIG, LSTM_LOSS_CONFIG, seed=0)
    trainer = Trainer(ATT_TRAINER)
    trainer.make_optimizer(model, steps_per_epoch=2 * LSTM_TRAIN_STEPS)
    batch = training_batch(torch.Generator().manual_seed(4), TRAIN_BATCH, 'cuda', stitched=True)
    states = torch.Generator(device='cuda').manual_seed(ATT_TRAINER['random_seed'])

    torch.cuda.reset_peak_memory_stats()
    edgeconv.launches_by_shape.clear()
    knn_gather.launches_by_shape.clear()
    runs = {}
    for epoch in (0, LSTM_STITCH_EPOCH):
        losses, times = [], []
        for step in range(LSTM_TRAIN_STEPS):
            before = launches_by_variant(knn_gather)
            torch.cuda.synchronize()
            start = time.perf_counter()
            loss, terms = trainer.train_step(model, batch, epoch=epoch, generator=states)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - start) * 1e3)
            losses.append(loss.item())
            per_step = {key: launches_by_variant(knn_gather)[key] - before[key] for key in before}
            check(per_step == per_step_expected,
                  f'{phase}: epoch {epoch} step {step} launched {per_step}, '
                  f'expected {per_step_expected}')
        runs[epoch] = {'losses': losses, 'step_times_ms': times,
                       'step_ms': statistics.median(times[1:]),
                       'terms_last_step': {k: v.item() if math.isfinite(v.item()) else None
                                           for k, v in terms.items()}}
    launches = launches_by_variant(knn_gather)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(not any(launches_by_variant(edgeconv).values()),
          f'{phase}: the fused eval kernel launched {launches_by_variant(edgeconv)} in train mode')
    check(all(math.isfinite(v) for r in runs.values() for v in r['losses']),
          f'{phase}: losses {[r["losses"] for r in runs.values()]}')
    check(runs[0]['losses'][-1] < runs[0]['losses'][0],
          f'{phase}: the epoch-0 loss did not fall: {runs[0]["losses"]}')
    stitch_terms = {'stitch_similarity_loss', 'stitch_neg_loss', 'free_edges_loss',
                    'stitch_recall'}
    check(stitch_terms <= set(runs[LSTM_STITCH_EPOCH]['terms_last_step'])
          and not stitch_terms & set(runs[0]['terms_last_step']),
          f'{phase}: stitch terms at epoch 0 / {LSTM_STITCH_EPOCH}: '
          f'{sorted(runs[0]["terms_last_step"])} / '
          f'{sorted(runs[LSTM_STITCH_EPOCH]["terms_last_step"])}')

    # the loss alone (matchings, terms, quality metrics) on this batch's
    # predictions, each phase
    with torch.no_grad():
        model.module.eval()
        preds = model.module(batch['features'])
    loss_ms = {}
    for epoch in (0, LSTM_STITCH_EPOCH):
        _, times = timed_calls(lambda: model.loss(preds, batch['ground_truth'], epoch=epoch), 4)
        loss_ms[epoch] = statistics.median(times[1:])

    edgeconv.launches_by_shape.clear()
    knn_gather.launches_by_shape.clear()
    eval_loss, _ = trainer.eval_step(model, batch, epoch=LSTM_STITCH_EPOCH)
    torch.cuda.synchronize()
    check(launches_by_variant(edgeconv) == {'small_c': 1, 'wide_c': 1, 'small_c_tiled': 0,
                                'wide_c_tiled': 0},
          f'{phase}: eval_step launched {launches_by_variant(edgeconv)}, expected 1 + 1 fused')
    check(math.isfinite(eval_loss.item()), f'{phase}: eval loss {eval_loss.item()}')

    # a 2-cloud step against the plain path of the same weights on the CPU,
    # in each loss phase
    gaps = {epoch: compare_step_cpu(f'{phase} epoch {epoch}', model, batch, 2, epoch=epoch)
            for epoch in (0, LSTM_STITCH_EPOCH)}
    emit({'phase': phase, 'model': LSTM_MODEL, 'batch': [TRAIN_BATCH, POINTS, 3],
          'steps_per_phase': LSTM_TRAIN_STEPS, 'launches': launches,
          'epoch_0': runs[0], f'epoch_{LSTM_STITCH_EPOCH}': runs[LSTM_STITCH_EPOCH],
          'stitch_phase_adds_ms': runs[LSTM_STITCH_EPOCH]['step_ms'] - runs[0]['step_ms'],
          'loss_alone_ms': {f'epoch_{e}': ms for e, ms in loss_ms.items()},
          'clouds_per_s': {f'epoch_{e}': TRAIN_BATCH / r['step_ms'] * 1e3
                           for e, r in runs.items()},
          'eval_loss': eval_loss.item(), 'peak_memory_gb': peak_gb,
          'vs_cpu_plain': {f'epoch_{e}': g for e, g in gaps.items()}})
    return launches, lambda: trainer.train_step(model, batch, epoch=LSTM_STITCH_EPOCH,
                                                generator=states)


def all_launches():
    """Every kernel wrapper's launch counts, one dict: fused_*, knn,
    knn_wide, knn_gather_*."""
    from garment_pattern_estimation_torch.ops import edgeconv, knn, knn_gather, launches_by_variant
    return {**{f'fused_{k}': v for k, v in launches_by_variant(edgeconv).items()},
            **launches_by_variant(knn),
            **{f'knn_gather_{k}': v for k, v in launches_by_variant(knn_gather).items()}}


def shape_launches():
    """Every wrapper's launches by shape: {'counter N C k': launches}."""
    from garment_pattern_estimation_torch.ops import edgeconv, knn, knn_gather
    out = {}
    for prefix, counter in (('fused_', edgeconv.launches_by_shape), ('', knn.launches_by_shape),
                            ('knn_gather_', knn_gather.launches_by_shape)):
        for (variant, N, C, k), n in counter.items():
            out[f'{prefix}{variant} {N} {C} {k}'] = n
    return out


def reset_all_launches():
    from garment_pattern_estimation_torch.ops import edgeconv, knn, knn_gather
    for module in (edgeconv, knn, knn_gather):
        module.launches_by_shape.clear()


def nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def fps_line(points):
    """farthest_point_sampling (plain PyTorch, M - 1 steps with no host
    sync) at PointNet++'s shape: host ms per call (synchronized, median of
    3 after one), device ms and its kernel launches per call
    (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from garment_pattern_estimation_torch.models.blocks import farthest_point_sampling

    M = int(0.2 * points.shape[1])
    _, times = timed_calls(lambda: farthest_point_sampling(points, M), 4)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        farthest_point_sampling(points, M)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    return {'shape': list(points.shape), 'samples': M, 'host_ms': statistics.median(times[1:]),
            'device_ms': sum(e.self_device_time_total for e in events) / 1e3,
            'kernel_launches': sum(e.count for e in events)}


def variant_phase(name):
    """The baseline with ENCODER_VARIANTS[name] at full width: SERVE_CALLS
    forwards of the (64, 2000, 3) batch of seed 1 (batch ms, clouds/s,
    peak memory, the launches of each kernel per forward, exactly as
    VARIANT_LAUNCHES says), a 2-cloud batch against the CPU plain path,
    one profiled serving call, VARIANT_STEPS Adam steps at epoch 0 on the
    stitched (30, 2000, 3) batch of seed 4 (step ms, launches per step as
    VARIANT_LAUNCHES says, finite losses; they need not fall: Adam's first
    steps move every weight by about the learning rate, which moves the
    outputs of wide layers, the MLP decoders' 5750 most of all, by more than
    three steps learn), and a 2-cloud step against the CPU plain path at the
    training phase's bars (pointnet: VARIANT_STEP_CLOUDS), the CPU step
    taking the card's kNN, pool, ReLU and max choices. Returns the
    launches by shape of serving and of training."""
    import torch
    from garment_pattern_estimation_torch.experiment import build_serving_fn
    from garment_pattern_estimation_torch.models import build_model
    from garment_pattern_estimation_torch.train import Trainer

    phase = f'encoders_decoders {name}'
    per_forward, per_step = VARIANT_LAUNCHES[name]
    nn_config = dict(LSTM_NN_CONFIG, **ENCODER_VARIANTS[name])
    model = build_model(LSTM_MODEL, ATT_DATA_CONFIG, nn_config, LSTM_LOSS_CONFIG, seed=0)
    serve = build_serving_fn(model, ATT_DATA_CONFIG)
    points = physical_points(1, BATCH, POINTS)

    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    preds, times = timed_calls(lambda: serve(points), SERVE_CALLS)
    serving, serving_shapes = nonzero(all_launches()), shape_launches()
    serve_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = {k: v * SERVE_CALLS for k, v in per_forward.items()}
    check(serving == expected, f'{phase}: serving launched {serving}, expected {expected}')
    check_outputs(phase, preds, BATCH, POINTS, attention=False)
    del preds
    serve_err = compare_cpu(phase, model, serve, points[:2])
    profile_phase(f'serving_{name}', lambda: serve(points))

    trainer = Trainer(ATT_TRAINER)
    trainer.make_optimizer(model, steps_per_epoch=VARIANT_STEPS)
    batch = training_batch(torch.Generator().manual_seed(4), TRAIN_BATCH, 'cuda', stitched=True)
    states = torch.Generator(device='cuda').manual_seed(ATT_TRAINER['random_seed'])
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    losses, step_times = [], []
    for step in range(VARIANT_STEPS):
        before = all_launches()
        torch.cuda.synchronize()
        start = time.perf_counter()
        loss, _ = trainer.train_step(model, batch, epoch=0, generator=states)
        torch.cuda.synchronize()
        step_times.append((time.perf_counter() - start) * 1e3)
        losses.append(loss.item())
        launched = nonzero({k: v - before[k] for k, v in all_launches().items()})
        check(launched == per_step,
              f'{phase}: step {step} launched {launched}, expected {per_step}')
    training, training_shapes = nonzero(all_launches()), shape_launches()
    train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(math.isfinite(v) for v in losses), f'{phase}: losses {losses}')
    gaps = compare_step_cpu(phase, model, batch, VARIANT_STEP_CLOUDS.get(name, 2),
                            noise_floor=name in VARIANT_STEP_CLOUDS, kinks=True)

    batch_ms = statistics.median(times[1:])
    step_ms = statistics.median(step_times[1:])
    emit({'phase': 'encoders_decoders', 'variant': name, 'model': LSTM_MODEL,
          'nn_overrides': ENCODER_VARIANTS[name], 'batch': [BATCH, POINTS, 3],
          'serving': {'calls': SERVE_CALLS, 'first_call_ms': times[0], 'batch_ms': batch_ms,
                      'clouds_per_s': BATCH / batch_ms * 1e3, 'peak_memory_gb': serve_peak_gb,
                      'launches': serving, 'launches_by_shape': serving_shapes,
                      'vs_cpu_plain': serve_err},
          'training': {'batch': [TRAIN_BATCH, POINTS, 3], 'steps': VARIANT_STEPS,
                       'losses': losses, 'step_times_ms': step_times, 'step_ms': step_ms,
                       'clouds_per_s': TRAIN_BATCH / step_ms * 1e3,
                       'peak_memory_gb': train_peak_gb, 'launches': training,
                       'launches_by_shape': training_shapes, 'vs_cpu_plain': gaps},
          'kernel_launches': sum(serving.values()) + sum(training.values())})
    return serving_shapes, training_shapes


def attention_pool10_phase():
    """The attention model with pool10's encoder and panel decoder on the
    att widths: one served (64, 2000, 3) batch, whose attention weights
    cover the encoder's 20 pooled points, and its launches."""
    import torch
    from garment_pattern_estimation_torch.experiment import build_serving_fn
    from garment_pattern_estimation_torch.models import build_model

    overrides = {k: v for k, v in ENCODER_VARIANTS['pool10'].items() if k != 'pattern_decoder'}
    model = build_model('GarmentSegmentPattern3D', ATT_DATA_CONFIG,
                        dict(ATT_NN_CONFIG, **overrides), seed=0)
    serve = build_serving_fn(model, ATT_DATA_CONFIG)
    points = physical_points(1, BATCH, POINTS)
    serve(points)
    reset_all_launches()
    preds, times = timed_calls(lambda: serve(points), 1)
    launches = nonzero(all_launches())
    expected = VARIANT_LAUNCHES['pool10'][0]
    check(launches == expected, f'attention pool10: launched {launches}, expected {expected}')
    pooled = math.ceil(0.1 * math.ceil(0.1 * POINTS))
    check_outputs('attention pool10', preds, BATCH, pooled)
    emit({'phase': 'encoders_decoders', 'variant': 'attention_pool10',
          'model': 'GarmentSegmentPattern3D', 'nn_overrides': overrides,
          'batch': [BATCH, POINTS, 3], 'att_weights': list(preds['att_weights'].shape),
          'batch_ms': times[0], 'launches': launches})


def knn_k_line(name, points, k, quantized, phase='kernel_k10', chunk=None):
    """The standalone kNN entry at k on `points` against the plain version
    (small D: every id; wide D: the wide envelope of `check_ids`); its line
    of the kernels list (launches filled in later) and the ids. `chunk`:
    the plain versions run, and the ids are checked, that many clouds at a
    time (the first chunk checked), as the stress phases do."""
    import torch
    from garment_pattern_estimation_torch.ops import knn

    B, N, D = points.shape
    chunk = chunk or B
    ids = knn.knn(points, k)
    torch.cuda.synchronize()
    ref = knn.knn_reference(points[:chunk], k)
    id_share, n_rows, worst_tie, id_err = check_ids(name, points[:chunk], ids[:chunk], ref,
                                                    quantized=quantized)
    check(torch.equal(ids[:chunk, :, 0], ref[..., 0]), f'{name}: slot 0 is not the query')
    del ref
    wide = D > 16
    line = {'name': name, 'route': 'cuda', 'source': KNN_WIDE_SOURCE if wide else KNN_SOURCE,
            'replaces': KNN_WIDE_REPLACES if wide else KNN_REPLACES, 'k': k,
            'launches': None, 'max_abs_err': id_err,
            'ms': cuda_ms(lambda: knn.knn(points, k)),
            'plain_ms': cuda_ms(lambda: chunked(lambda xs: knn.knn_reference(xs, k), points,
                                                chunk), 1, 5 if chunk == B else 3),
            # torch.cdist + torch.topk: two calls, other rounding and ties
            'library_ms': cuda_ms(lambda: chunked(lambda xs: torch.topk(
                torch.cdist(xs, xs), k, largest=False).indices, points, chunk),
                1, 5 if chunk == B else 3)}
    line['bound_ms'], line['bound_by'] = (knn_wide_bound if wide else knn_bound)(B, N, D, k)
    emit({'phase': phase, 'shape': [B, N, D], 'checked_clouds': chunk, 'id_agreement': id_share,
          'id_disagreeing_rows': n_rows, 'near_tie_ratio': worst_tie, **line})
    return line, ids


def pool_on_card(x, ids):
    """DynamicGraphPool (pool10's pool1: 32 wide, k 10, ratio 0.1) on the
    card against its plain version on the CPU given the same ids: the same
    kept ids, the same order where fitness values differ, values within
    1e-5 of their scale."""
    import torch
    from garment_pattern_estimation_torch.models.blocks import DynamicGraphPool

    torch.manual_seed(13)
    pool = DynamicGraphPool(x.shape[-1], k=K_WIDE, pool_ratio=0.1)
    card_pool = copy.deepcopy(pool).cuda()
    with torch.no_grad():
        out, kept = card_pool.pool(x, ids)
        ref, ref_kept = pool.pool(x.cpu(), ids.cpu())
    kept, out = kept.cpu(), out.cpu()
    same = torch.equal(kept.sort(1).values, ref_kept.sort(1).values)
    order, ref_order = kept.argsort(1), ref_kept.argsort(1)
    err = (out.gather(1, order[..., None].expand_as(out))
           - ref.gather(1, ref_order[..., None].expand_as(ref))).abs().max().item()
    scale = ref.abs().max().item()
    line = {'phase': 'kernel_k10', 'name': 'dynamic_graph_pool_on_kernel_ids',
            'shape': list(x.shape), 'kept': kept.shape[1], 'same_kept_ids': same,
            'same_order': bool(torch.equal(kept, ref_kept)), 'max_rel_err': err / scale}
    emit(line)
    check(same and err <= 1e-5 * scale, f'pool on the card off its plain version: {line}')


def wide_k_kernels():
    """The kernels at k = K_WIDE at pool10's shapes, each against its plain
    version: rows 4-5 at conv1 (64, 2000, 3) 64-64-32, conv2 (64, 200, 32)
    128 x 3, conv3 (64, 20, 128) 256 x 3; row 2 at the pools' (64, 2000,
    32) and (64, 200, 128), with the pool itself on the kernel's ids; row 1
    on a (4, 10000, 3) cloud; row 8 at training's (30, 2000, 3), rows 8-9 at
    (30, 200, 32) and (30, 20, 128) (the layers whose input takes a
    gradient). Returns the kernels-line entries by key."""
    import torch

    gen = torch.Generator().manual_seed(12)
    x0 = torch.randn(BATCH, POINTS, 3, generator=gen).cuda()
    lines = {}
    x1, lines['fused_small_c'] = check_kernel('fused_edgeconv_small_c_k10', x0, random_folded(
        gen, 3, [64, 64, 32], 'cuda'), [64, 64, 32], k=K_WIDE)
    lines['knn_wide_2000'], ids = knn_k_line('knn_wide_k10', x1, K_WIDE, quantized=False)
    pool_on_card(x1, ids)
    x2 = x1[:, :POINTS // 10].contiguous()            # pool1 keeps 200 of 2000
    x3, lines['fused_wide_c_200'] = check_kernel('fused_edgeconv_wide_c_k10', x2, random_folded(
        gen, 32, [128] * 3, 'cuda'), [128] * 3, k=K_WIDE)
    lines['knn_wide_200'], _ = knn_k_line('knn_wide_k10_c128', x3, K_WIDE, quantized=False)
    _, lines['fused_wide_c_20'] = check_kernel(
        'fused_edgeconv_wide_c_k10_c128', x3[:, :POINTS // 100].contiguous(),
        random_folded(gen, 128, [256] * 3, 'cuda'), [256] * 3, k=K_WIDE)
    lines['knn'], _ = knn_k_line('knn_k10', torch.randn(CHUNK, STRESS_POINTS, 3,
                                                         generator=gen).cuda(), K_WIDE, True)
    gathers = check_knn_gather(x0[:TRAIN_BATCH].contiguous(), False, k=K_WIDE) \
        + check_knn_gather(x2[:TRAIN_BATCH].contiguous(), True, k=K_WIDE) \
        + check_knn_gather(x3[:TRAIN_BATCH, :POINTS // 100].contiguous(), True, k=K_WIDE)
    lines.update(zip(('gather_fwd_small_c', 'gather_fwd_wide_c_200', 'gather_bwd_200',
                      'gather_fwd_wide_c_20', 'gather_bwd_20'), gathers))
    return lines


def k_range_kernels(widths):
    """Each of rows 1-9 at every k of K_RANGE (the capacity instances K =
    32, 64, 128 and k = 17, 20 within K = 32), at one shape each, against
    its plain version with the bars of the k = 5 phases: rows 4-5 at (16,
    2000, 3) and (16, 2000, 150), rows 6-7 (the column-tiled variants) at
    (4, 10000, 3) and (4, 10000, 150), all at att.yaml's widths; row 1 at
    (4, 10000, 3); rows 2-3 at (8, 2000, 150); rows 8-9 at (16, 2000, 3)
    and (16, 2000, 150). Returns {(row, k): line}
    (row 8's wide-C forward under 8.5)."""
    import torch
    from garment_pattern_estimation_torch.ops import edgeconv

    gen = torch.Generator().manual_seed(14)
    x0 = torch.randn(16, POINTS, 3, generator=gen).cuda()
    s0 = torch.randn(CHUNK, STRESS_POINTS, 3, generator=gen).cuda()
    conv0 = random_folded(gen, 3, widths, 'cuda')
    conv1 = random_folded(gen, widths[-1], widths, 'cuda')
    timing = (1, 5)
    lines = {}
    # conv1's inputs: conv0's outputs at k = 5, as in the model
    x1, s1 = (edgeconv.fused_edgeconv(x, conv0, K).contiguous() for x in (x0, s0))
    for k in K_RANGE:
        _, lines[4, k] = check_kernel(f'fused_edgeconv_small_c_k{k}', x0, conv0, widths, k=k,
                                      phase='k_range', timing=timing)
        _, lines[5, k] = check_kernel(f'fused_edgeconv_wide_c_k{k}', x1, conv1, widths, k=k,
                                      phase='k_range', timing=timing)
        _, lines[6, k] = check_kernel(f'fused_edgeconv_small_c_tiled_k{k}', s0, conv0, widths,
                                      k=k, tile_variant=True, phase='k_range', timing=timing)
        _, lines[7, k] = check_kernel(f'fused_edgeconv_wide_c_tiled_k{k}', s1, conv1, widths,
                                      k=k, tile_variant=True, phase='k_range', timing=timing)
        lines[1, k], _ = knn_k_line(f'knn_k{k}', s0, k, True, phase='k_range')
        lines[2, k], _ = knn_k_line(f'knn_wide_k{k}', x1[:8].contiguous(), k, False,
                                    phase='k_range')
        (lines[8, k],) = check_knn_gather(x0, False, k=k, phase_name='k_range',
                                          timing=timing)
        lines[8.5, k], lines[9, k] = check_knn_gather(x1, True, k=k, phase_name='k_range',
                                                      timing=timing)
    for line in lines.values():
        line['launches'] = 0            # set from the main path for k = 20
    return lines


def k20_kernels(widths):
    """The kernels at k = 20 at the shapes of the k = 20 main path, each
    against its plain version: rows 4-5 at serving's (64, 2000, 3) and (64,
    2000, 150), rows 8-9 at training's (30, 2000, 3) and (30, 2000, 150),
    rows 6-7 and 1-3 at the stress batch (128, 10000, C), checked on its
    first CHUNK clouds. Returns {row: line} (row 8's wide-C forward under
    8.5)."""
    import torch

    gen = torch.Generator().manual_seed(20)
    x0 = torch.randn(BATCH, POINTS, 3, generator=gen).cuda()
    conv0 = random_folded(gen, 3, widths, 'cuda')
    conv1 = random_folded(gen, widths[-1], widths, 'cuda')
    k, lines = K_DGCNN, {}
    x1, lines[4] = check_kernel('fused_edgeconv_small_c_k20', x0, conv0, widths, k=k)
    x1 = x1.contiguous()
    _, lines[5] = check_kernel('fused_edgeconv_wide_c_k20', x1, conv1, widths, k=k)
    (lines[8],) = check_knn_gather(x0[:TRAIN_BATCH].contiguous(), False, k=k)
    lines[8.5], lines[9] = check_knn_gather(x1[:TRAIN_BATCH].contiguous(), True, k=k)
    del x0, x1
    s0 = torch.randn(STRESS_BATCH, STRESS_POINTS, 3, generator=gen).cuda()
    lines[1], _ = knn_k_line('knn_k20_stress', s0, k, True, phase='kernel_k20', chunk=CHUNK)
    s1, lines[6] = check_kernel('fused_edgeconv_small_c_tiled_k20', s0, conv0, widths, k=k,
                                tile_variant=True)
    s1 = s1.contiguous()
    _, lines[7] = check_kernel('fused_edgeconv_wide_c_tiled_k20', s1, conv1, widths, k=k,
                               tile_variant=True)
    lines[2], _ = knn_k_line('knn_wide_k20_stress', s1, k, False, phase='kernel_k20',
                             chunk=CHUNK)
    return lines


def variant_widths(variant):
    """The edge-MLP widths of att's EdgeConv layers in `variant`."""
    nn_section = VARIANTS[variant][1]
    return [nn_section['EConv_hidden']] * nn_section['EConv_hidden_depth'] \
        + [nn_section['EConv_feature']]


def wide_shape_kernels():
    """Rows 2, 4-5 and 8-9 at the shapes of the WIDE_VARIANTS main paths,
    each against its plain version with the k = 5 bars: rows 4-5 at
    serving's (64, 2000, 3) and (64, 2000, 150) for '_hidden512' (6 -> 512
    -> 512 -> 150: 5 slots of 520-column edge rows fit one launch) and
    '_depth4' (five layers); for '_feature300' row 4 at (64, 2000, 3) -> 300
    and conv1's (30, 2000, 300) through rows 8-9 (C past 256: the model's
    conv1 takes knn_gather in eval too), and row 2 at (8, 2000, 300) (on no
    path: 2000-point layers rank through knn_gather). Returns {(variant,
    row): line} (row 8's wide-C forward under 8.5)."""
    import torch

    gen = torch.Generator().manual_seed(16)
    x0 = torch.randn(BATCH, POINTS, 3, generator=gen).cuda()
    lines = {}
    for variant in WIDE_VARIANTS:
        widths = variant_widths(variant)
        conv0 = random_folded(gen, 3, widths, 'cuda')
        x1, lines[variant, 4] = check_kernel(f'fused_edgeconv_small_c{variant}', x0, conv0,
                                             widths, phase='wide_shapes')
        x1 = x1.contiguous()
        if widths[-1] <= 256:
            conv1 = random_folded(gen, widths[-1], widths, 'cuda')
            _, lines[variant, 5] = check_kernel(f'fused_edgeconv_wide_c{variant}', x1, conv1,
                                                widths, phase='wide_shapes')
        else:
            lines[variant, 8.5], lines[variant, 9] = check_knn_gather(
                x1[:TRAIN_BATCH].contiguous(), True, phase_name='wide_shapes')
            lines[variant, 2], _ = knn_k_line(f'knn_wide_d{widths[-1]}', x1[:8].contiguous(),
                                              K, False, phase='wide_shapes')
            lines[variant, 2]['launches'], lines[variant, 2]['on_main_path'] = 0, False
    for (variant, _), line in lines.items():
        line['variant'] = variant
    return lines


def k_large_kernels(widths):
    """Rows 4-9 at k = 129 and 200 (the selection of all N keys, then the
    edge MLP or the rows), each against its plain version with the k = 5
    bars: rows 4-5 at serving_k200's (64, 2000, 3) and (64, 2000, 150), the
    plain version 16 clouds at a time (the whole batch's edge rows would
    hold about 30 GB), rows 8-9 at the k = 200 training step's (6, 2000, 3)
    and (6, 2000, 150), att.yaml's widths; rows 6-7 at (4, 10000, 3) and
    (4, 10000, 150) at k = 200 (on no path). Returns {(row, k): line} (row
    8's wide-C forward under 8.5)."""
    import torch
    from garment_pattern_estimation_torch.ops import edgeconv

    gen = torch.Generator().manual_seed(15)
    x0 = torch.randn(BATCH, POINTS, 3, generator=gen).cuda()
    conv0 = random_folded(gen, 3, widths, 'cuda')
    conv1 = random_folded(gen, widths[-1], widths, 'cuda')
    timing, lines = (1, 5), {}
    x1 = edgeconv.fused_edgeconv(x0, conv0, K).contiguous()
    for k in K_LARGE_RANGE:
        _, lines[4, k] = check_kernel(f'fused_edgeconv_small_c_k{k}', x0, conv0, widths, k=k,
                                      phase='k_large', timing=timing,
                                      plain_chunk=K_LARGE_PLAIN_CHUNK)
        _, lines[5, k] = check_kernel(f'fused_edgeconv_wide_c_k{k}', x1, conv1, widths, k=k,
                                      phase='k_large', timing=timing,
                                      plain_chunk=K_LARGE_PLAIN_CHUNK)
        (lines[8, k],) = check_knn_gather(x0[:K_LARGE_TRAIN_BATCH].contiguous(), False, k=k,
                                          phase_name='k_large', timing=timing)
        lines[8.5, k], lines[9, k] = check_knn_gather(
            x1[:K_LARGE_TRAIN_BATCH].contiguous(), True, k=k, phase_name='k_large',
            timing=timing)
    del x0, x1
    s0 = torch.randn(CHUNK, STRESS_POINTS, 3, generator=gen).cuda()
    s1, lines[6, K_LARGE] = check_kernel(f'fused_edgeconv_small_c_tiled_k{K_LARGE}', s0, conv0,
                                         widths, k=K_LARGE, tile_variant=True, phase='k_large',
                                         timing=(1, 3))
    _, lines[7, K_LARGE] = check_kernel(f'fused_edgeconv_wide_c_tiled_k{K_LARGE}',
                                        s1.contiguous(), conv1, widths, k=K_LARGE,
                                        tile_variant=True, phase='k_large', timing=(1, 3))
    for line in lines.values():
        line['launches'] = 0            # set from the main path for k = 200 (rows 4-5, 8-9)
    return lines


def _points_model(case, device):
    """POINTS_CASES[case]'s model at full width from seed 0 (zero LSTM
    states, so a step does not depend on the clouds' order) on `device`."""
    from garment_pattern_estimation_torch.models import build_model

    model_name, nn_section, loss_section, _ = POINTS_CASES[case]
    return build_model(model_name, ATT_DATA_CONFIG, nn_section, loss_section, device=device,
                       seed=0)


def _points_batch(case, device):
    """The (4, 2000, 3) batch of seed 4 (stitched for the baseline's
    loss), with labels of seed 6 where the loss reads a segmentation term."""
    import torch

    _, _, loss_section, stitched = POINTS_CASES[case]
    batch = training_batch(torch.Generator().manual_seed(4), 4, device, stitched=stitched)
    if 'segmentation' in loss_section['loss_components']:
        batch['ground_truth']['segmentation'] = torch.randint(
            0, ATT_DATA_CONFIG['max_pattern_len'], (4, POINTS),
            generator=torch.Generator().manual_seed(6)).to(device)
    return batch


@contextlib.contextmanager
def _float64(on):
    """With `on`, float64 throughout: the default dtype, and
    `Tensor.float()`, which the port's f32 upcasts call, gives float64 (a
    plain-PyTorch path only: the kernels take f32)."""
    import torch

    if not on:
        yield
        return
    saved = torch.Tensor.float, torch.get_default_dtype()
    torch.Tensor.float = torch.Tensor.double
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.Tensor.float = saved[0]
        torch.set_default_dtype(saved[1])


@contextlib.contextmanager
def _moments64(on):
    """With `on`, every MLP's BatchNorm moments (`MLP._moments`: the means,
    over the mesh under a data shard, and E[x^2] - E[x]^2) in float64 and
    then cast to f32; the rest of the step as it is."""
    from garment_pattern_estimation_torch.models.blocks import MLP

    if not on:
        yield
        return
    real = MLP._moments

    def moments(self, x):
        with _float64(True):
            mean, var = real(self, x.double())
        return mean.float(), var.float()

    MLP._moments = moments
    try:
        yield
    finally:
        MLP._moments = real


@contextlib.contextmanager
def _ring_recorded(calls, choices):
    """Within the block each `parallel.ring.ring_knn_gather` call (a
    points-sharded EdgeConv layer's) appends (its input shard, k, its ids)
    to `calls`, on the host, and a placeholder ('ring', its index) to
    `choices.records` where `choices` is given."""
    from garment_pattern_estimation_torch.parallel import ring

    real = ring.ring_knn_gather

    def recorded(x, k, group=None, ranking='norm'):
        neighbours, ids = real(x, k, group, ranking)
        if choices is not None:
            choices.records.append(('ring', len(calls)))
        calls.append((x.detach().cpu(), k, ids.cpu()))
        return neighbours, ids

    ring.ring_knn_gather = recorded
    try:
        yield
    finally:
        ring.ring_knn_gather = real


def _whole_ring_calls(calls, mesh):
    """This step's ring calls (`_ring_recorded`) of every rank, those of
    this rank's data slice joined along the points: per call the record
    of the one process's knn_gather call on the whole clouds, ('knn_gather',
    input, k, 2 (the f32 rows the points cases train on), ids). Every rank
    must call it."""
    import torch
    import torch.distributed as dist

    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, calls)
    first = dist.get_rank() // mesh['points'] * mesh['points']
    return [('knn_gather', torch.cat([c[0] for c in parts], dim=1), parts[0][1], 2,
             torch.cat([c[2] for c in parts], dim=1))
            for parts in zip(*every[first:first + mesh['points']])]


def _points_steps(device, mesh, case, flip=False, perturb=None, record=False, replay=None,
                  f64=False, moments64=False, keep_ring=False):
    """POINTS_STEPS training steps of `case` on its batch, its clouds in
    reverse order with `flip` and scaled by 1 + perturb * a seeded normal
    draw with `perturb`, over `mesh` (trainer.mesh) in the process group
    that exists, or in one process (mesh None); with `f64` the weights,
    the batch and the steps in float64 (`_float64`), with `moments64` the
    BatchNorm moments (`_moments64`). `record`: the steps'
    kNN, knn_gather and graph-pool choices are kept (`StepChoices`), each
    step's apart; `keep_ring` (every rank of a mesh passes it): the ring
    layers' choices too, each the knn_gather record of the one process's
    call on the whole clouds of this rank's data slice
    (`_whole_ring_calls`), in call order; `replay` (such records): the
    steps take them where the calls match
    (`StepChoices.replay(passthrough=True)`). Returns (the losses, the
    first step's gradient flat on the host in float64, the records by step
    or None)."""
    import torch
    from garment_pattern_estimation_torch.train import Trainer

    model = _points_model(case, device)           # the f32 weights, then cast
    if f64:
        model.module.double()
    trainer = Trainer(dict(ATT_TRAINER, mesh=mesh), device=device)
    trainer.make_optimizer(model, steps_per_epoch=POINTS_STEPS)
    if mesh is not None:
        trainer.use_mesh(model, trainer.mesh_from_setup())
    batch = _points_batch(case, device)
    if flip:
        batch = {'features': batch['features'].flip(0),
                 'ground_truth': {k: v.flip(0) for k, v in batch['ground_truth'].items()}}
    if perturb:
        noise = torch.randn(batch['features'].shape, generator=torch.Generator().manual_seed(5))
        batch = dict(batch, features=batch['features'] * (1 + perturb * noise.to(device)))
    if f64:
        batch = {'features': batch['features'].double(),
                 'ground_truth': {k: v.double() if v.dtype == torch.float32 else v
                                  for k, v in batch['ground_truth'].items()}}
    replayed = None
    if replay is not None:
        replayed = StepChoices(model.module)
        replayed.records = [r for step in replay for r in step]
    losses, grad, records = [], None, [] if record else None
    with replayed.replay(passthrough=True) if replayed else contextlib.nullcontext(), \
            _float64(f64), _moments64(moments64):
        for step in range(POINTS_STEPS):
            choices = StepChoices(model.module)
            states = torch.Generator(device=device).manual_seed(100 + step)
            ring_calls = []
            with choices.record() if record else contextlib.nullcontext(), \
                    _ring_recorded(ring_calls, choices if record else None) if keep_ring \
                    else contextlib.nullcontext():
                loss, _ = trainer.train_step(model, batch, epoch=0, generator=states)
            losses.append(loss.item())
            if keep_ring:
                whole = _whole_ring_calls(ring_calls, mesh)
                if record:
                    choices.records = [whole[r[1]] if r[0] == 'ring' else r
                                       for r in choices.records]
            if record:
                records.append(choices.records)
            if grad is None:
                grad = torch.cat([p.grad.reshape(-1) for p in model.module.parameters()
                                  if p.grad is not None]).cpu().double()
    return losses, grad, records


def _rank_card(backend):
    """This spawned rank's card: rank r's under NCCL, card 0 under gloo
    (both ranks on one card), made the current one."""
    import torch
    import torch.distributed as dist

    device = torch.device('cuda', dist.get_rank() if backend == 'nccl' else 0)
    torch.cuda.set_device(device)
    return device


def _ring_shift_probe(backend, result_path):
    """One `ring_shift` of a card tensor over the spawned ranks: the first
    rank writes the device and the values it received (the last rank's)."""
    import torch
    import torch.distributed as dist
    from garment_pattern_estimation_torch.parallel.collectives import ring_shift

    got = ring_shift(torch.full((4,), float(dist.get_rank()), device=_rank_card(backend)))
    if dist.get_rank() == 0:
        Path(result_path).write_text(json.dumps([got.device.type, got.tolist()]))


def _points_rank(backend, out_dir, mesh):
    """Every POINTS_CASES case through `_points_steps` over `mesh` on a
    spawned rank (with the BatchNorm moments in f64 where POINTS_MOMENTS64
    names the case and the mesh), the first points rank of each data slice
    recording its choices: the first rank writes each case's losses,
    gradient and every rank's kernel launches in those steps
    (`points_<case>.json`, `.grad.pt`), each data slice's first points rank
    its choices (`.choices.<data rank>.pt`), and the first rank
    POINTS_EXACT's steps in f64 (`.f64.pt`)."""
    import torch
    import torch.distributed as dist

    device = _rank_card(backend)
    rank = dist.get_rank()
    recorder = rank % mesh['points'] == 0
    for case in POINTS_CASES:
        reset_all_launches()
        losses, grad, records = _points_steps(
            device, mesh, case, record=recorder, keep_ring=True,
            moments64=mesh in POINTS_MOMENTS64.get(case, ()))
        torch.cuda.synchronize()
        launches = [None] * dist.get_world_size()
        dist.all_gather_object(launches, nonzero(all_launches()))
        if case in POINTS_EXACT:
            f64_run = _points_steps(device, mesh, case, f64=True)[:2]
        path = Path(out_dir) / f'points_{case}'
        if recorder:
            torch.save(records, f'{path}.choices.{rank // mesh["points"]}.pt')
        if rank == 0:
            path.with_suffix('.json').write_text(json.dumps({'losses': losses,
                                                             'launches': launches}))
            torch.save(grad, str(path) + '.grad.pt')
            if case in POINTS_EXACT:
                torch.save(f64_run, str(path) + '.f64.pt')


def _merged_choices(path, data):
    """The choices of a case's steps over every data slice (`_points_rank`'s
    `.choices.<d>.pt`), each record's tensors joined along the batch in data
    rank order: the one process's calls on the whole batch. Per step."""
    import torch

    slices = [torch.load(f'{path}.choices.{d}.pt') for d in range(data)]
    return [[_joined_record(r) for r in zip(*steps)] for steps in zip(*slices)]


def _joined_record(parts):
    """One `StepChoices` record from each data slice, as the one process's
    on the whole batch: its tensors joined along the batch, the rest (k,
    the value chunks, a pool's name and weights) alike on every slice."""
    import torch

    return tuple(torch.cat(f) if isinstance(f[0], torch.Tensor) else f[0] for f in zip(*parts))


def _ring_against_knn_gather(gen):
    """The neighbours of the points-sharded conv1 against one process's:
    att's conv0 (random weights, the fused layer) on a (4, 2000, 3) cloud
    gives conv1's (4, 2000, 150) input; the ring's 'kernel' ranking, its two
    shards driven in one process (plain PyTorch, cuBLAS sums), against
    knn_gather's kernel (MMA sums) at k = 5. Differences must be near ties,
    as the kernels' wide ids against their plain versions. Returns (share
    of equal ids, rows that differ, worst near-tie ratio)."""
    import torch
    from garment_pattern_estimation_torch.ops import edgeconv, knn_gather
    from garment_pattern_estimation_torch.parallel.ring import (_ring_init, _ring_merge,
                                                                _ring_output)

    widths = variant_widths('')
    x0 = torch.randn(4, POINTS, 3, generator=gen).cuda()
    x = edgeconv.fused_edgeconv(x0, random_folded(gen, 3, widths, 'cuda'), K).contiguous()
    shards, S = POINTS_MESH['points'], POINTS // POINTS_MESH['points']
    ids = []
    for me in range(shards):
        q = x[:, me * S:(me + 1) * S]
        acc = _ring_init(q, K, shards)
        for step in range(shards):
            src = (me - step) % shards
            acc = _ring_merge(q, x[:, src * S:(src + 1) * S], src, acc, me, ranking='kernel')
        ids.append(_ring_output(q, acc, me)[1])
    _, kernel_ids = knn_gather.knn_gather_fwd(x, K)
    share, rows, worst, _ = check_ids('points_sharded ring', x, torch.cat(ids, dim=1),
                                      kernel_ids.long())
    return share, rows, worst


def _step_gaps(run, ref, steps=POINTS_STEPS):
    """(the largest relative gap of `run`'s first `steps` losses to `ref`'s,
    the gap of its first-step gradient over the norm of `ref`'s); a run is
    (losses, gradient), as `_points_steps` returns them."""
    return (max(abs(a - b) / abs(b) for a, b in zip(run[0][:steps], ref[0])),
            ((run[1] - ref[1]).norm() / ref[1].norm()).item())


def points_sharded_phase(out_dir):
    """trainer.mesh {data: d, points: p} on the card: d p ranks, each
    holding 1 / p of its data slice's clouds' points, for each POINTS_CASES
    case at full width, against one process on the same batch. The meshes
    by the cards visible: one card, {1, 2} as two gloo ranks on it (gloo's
    ring shift staged through the host); two or three, {1, 2} as NCCL
    ranks, a card each; four or more, {1, 2}, {2, 2} and {1, 4}
    (POINTS_MESHES_4), NCCL ranks, a card each. The cases: att (the ring EdgeConv, the mean
    pool summed over the points ranks), att with `max` pools (the
    all-reduce max) and with the segmentation term (the mean over every
    rank's points), the baseline with pool10's and gpool's encoders (the
    first graph pool gathers its input, the rest runs on whole clouds), the
    baseline with pointnet's (PointNet++ gathers the positions and splits
    the centroids; its global max pool is the all-reduce max) and att with
    pointnet's encoder (the attention pool over every rank's centroids).

    Each mesh first runs a probe: one ring shift of a card tensor over its
    ranks. Its failure fails the script, its error printed on the phase's
    line; so does a training rank's.

    Each case: POINTS_STEPS steps. The first points rank of each data
    slice records its kNN, knn_gather and graph-pool choices, and the ring
    layers' neighbours joined over the points ranks (`_whole_ring_calls`),
    all joined over the slices (`_merged_choices`); each of every step's is
    held against the plain version on its input (`StepChoices.check`), and
    the one-process steps take them (near ties of a kNN on clouds whose
    features differ in their last bits would flip: a flip moves pool10's
    loss by 1e-3, and, after the first Adam step, att's second loss by
    1e-4 on four ranks in a CPU rehearsal at 200 points).
    Bars: the losses within rtol 2e-5 and the gradient within 1e-5 of its
    norm (the CPU tests' bars), or ORDER_FLOOR_FACTOR times the order floor
    of each where that is larger: the largest gap of one process against
    itself, on the clouds in reverse order (the shapes' cuBLAS and atomic
    sum orders) and on the clouds scaled by 1 + 1e-7 noise (POINTS_NOISE:
    also 1e-6 for pool10, whose ring-run conv1 rounds otherwise than the
    one process's kernel). The noise floors take the first rank's choices
    too, as the one process does: they measure how far rounding moves the
    step at fixed choices (noise flips near ties of the pools' kNN
    otherwise, and a flip moves the gradient by tens of % of its norm, a
    bar that would hide a rank's dropped share). The cases and meshes of
    POINTS_MOMENTS64 are held with their BatchNorm moments in f64, and
    POINTS_EXACT's first step in f64 within POINTS_F64_BAR (see
    POINTS_MOMENTS64). A gradient counted p times, or a rank's share dropped, is off by about its whole norm. Each
    rank's launches are POINTS_STEP_LAUNCHES' per step: the ring launches
    none, the stages after a gather what one process launches for them."""
    import torch
    from garment_pattern_estimation_torch.parallel.dryrun import spawn

    start = time.perf_counter()
    cards = torch.cuda.device_count()
    backend = 'nccl' if cards >= 2 else 'gloo'
    meshes = POINTS_MESHES_4 if cards >= 4 else (POINTS_MESH,)
    line = {'phase': 'points_sharded', 'batch': [4, POINTS, 3], 'steps': POINTS_STEPS,
            'widths': variant_widths(''), 'meshes': []}
    card = torch.device('cuda', 0)
    memo = {}

    def one_process(case, replay=None, **options):
        """`_points_steps` of `case` in this process on the card; a run that
        takes no recorded choice is the same for every mesh."""
        if replay is not None and any(map(len, replay)):
            return _points_steps(card, None, case, replay=replay, **options)[:2]
        key = (case, tuple(sorted(options.items())))
        if key not in memo:
            memo[key] = _points_steps(card, None, case, **options)[:2]
        return memo[key]

    failed = []
    for mesh in meshes:
        ranks = mesh['data'] * mesh['points']
        entry = {'mesh': mesh, 'backend': backend, 'cards': ranks if backend == 'nccl' else 1}
        line['meshes'].append(entry)
        mesh_dir = out_dir / f'points_{mesh["data"]}x{mesh["points"]}'
        mesh_dir.mkdir()
        probe_path = mesh_dir / 'probe.json'
        try:
            spawn(_ring_shift_probe, ranks, backend, str(probe_path), backend=backend)
        except Exception as err:
            entry['probe_error'] = f'{type(err).__name__}: {err}'[:2000]
            emit(line)
            raise
        device_type, received = json.loads(probe_path.read_text())
        check(device_type == 'cuda' and received == [float(ranks - 1)] * 4,
              f'points_sharded {mesh}: ring_shift of a card tensor gave {device_type} '
              f'{received}')
        ranks_start = time.perf_counter()
        spawn(_points_rank, ranks, backend, str(mesh_dir), mesh, backend=backend)
        entry['ranks_s'] = time.perf_counter() - ranks_start
        entry['cases'] = {}
        for case in POINTS_CASES:
            failed += _points_case(case, mesh, mesh_dir / f'points_{case}', one_process,
                                   entry['cases'])
    share, rows, worst = _ring_against_knn_gather(torch.Generator().manual_seed(17))
    line.update(seconds=time.perf_counter() - start,
                conv1_ring_vs_knn_gather={'id_share': share, 'rows_differ': rows,
                                          'worst_tie_ratio': worst})
    emit(line)
    check(not failed, f'points_sharded: {failed}')


def _points_case(case, mesh, path, one_process, cases):
    """`case`'s run over `mesh` (`_points_rank`'s files at `path`) against
    one process (`one_process(case, replay, **_points_steps options)`), its
    entry put in `cases`. Returns the checks that failed."""
    import torch

    card = torch.device('cuda', 0)
    failed = []
    result = json.loads(path.with_suffix('.json').read_text())
    losses, launches = result['losses'], result['launches']
    grad = torch.load(str(path) + '.grad.pt')
    records = _merged_choices(path, mesh['data'])
    choices = StepChoices(_points_model(case, card).module)
    choices.records = [r for step in records for r in step]
    choice_lines = choices.check(f'points_sharded {mesh} {case}',
                                 _points_model(case, 'cpu').module)
    moments64 = mesh in POINTS_MOMENTS64.get(case, ())
    entry = {'moments64': moments64}
    if case in POINTS_EXACT:
        # the f64 first step (its loss and gradient: the second loss follows
        # Adam's update of gradients that are 0 in exact arithmetic, a bias
        # before a BatchNorm, lr-sized with the rounding's sign, in f64 too)
        # within POINTS_F64_BAR or twice its order floor (the clouds
        # reversed)
        f64_run = torch.load(str(path) + '.f64.pt')
        f64 = one_process(case, f64=True)
        f64_gaps = _step_gaps(f64_run, f64, steps=1)
        f64_floors = _step_gaps(one_process(case, flip=True, f64=True), f64, steps=1)
        f64_bars = [max(POINTS_F64_BAR, ORDER_FLOOR_FACTOR * f) for f in f64_floors]
        entry['f64'] = {'losses': f64_run[0], 'reference_losses': f64[0],
                        'gaps': f64_gaps, 'floors': f64_floors, 'bars': f64_bars}
        for name, gap, bar in zip(('loss', 'gradient'), f64_gaps, f64_bars):
            if gap > bar:
                failed.append(f'{mesh} {case}: f64 first step {name} {gap} off one process '
                              f'(bar {bar})')
    ref = one_process(case, replay=records, moments64=moments64)
    floors = {'flip': one_process(case, flip=True, moments64=moments64),
              **{f'noise_{scale:g}': one_process(case, replay=records, perturb=scale,
                                                 moments64=moments64)
                 for scale in POINTS_NOISE.get(case, (1e-7,))}}
    entry.update(losses=losses, reference_losses=ref[0],
                 floors={k: _step_gaps(v, ref) for k, v in floors.items()})
    loss_gap, grad_gap = _step_gaps((losses, grad), ref)
    loss_floor, grad_floor = (max(v) for v in zip(*entry['floors'].values()))
    loss_bar = max(2e-5, ORDER_FLOOR_FACTOR * loss_floor)
    grad_bar = max(1e-5, ORDER_FLOOR_FACTOR * grad_floor)
    expected = {k: v * POINTS_STEPS for k, v in POINTS_STEP_LAUNCHES[case].items()}
    cases[case] = dict(entry, loss_gap=loss_gap, grad_gap=grad_gap, loss_bar=loss_bar,
                       grad_bar=grad_bar, launches_per_rank=launches,
                       expected_launches_per_rank=expected, choices=choice_lines,
                       replayed=sum(map(len, records)))
    if loss_gap > loss_bar:
        failed.append(f'{mesh} {case}: step losses {loss_gap} off one process (bar {loss_bar})')
    if grad_gap > grad_bar:
        failed.append(f'{mesh} {case}: first-step gradient {grad_gap} of its norm off one '
                      f'process (bar {grad_bar})')
    if any(rank != expected for rank in launches):
        failed.append(f'{mesh} {case}: the ranks launched {launches}, expected {expected} each')
    return failed


def fit_checkpoint(out_dir, fit_run_id):
    """The best checkpoint of the att f32 fit run `fit_run_id`."""
    from garment_pattern_estimation_torch.experiment import ExperimentWrappper

    run = ExperimentWrappper({'experiment': {
        'project_name': 'chip_smoke', 'run_name': 'fit', 'run_id': fit_run_id}},
        output_root=out_dir / 'experiments')
    aliases = json.loads((run.checkpoint_dir() / 'aliases.json').read_text())
    return run.checkpoint_dir() / f'checkpoint_{aliases["best"]}.pt'


def parity_shape_config(out_dir):
    """The parity CLI's shape config (JSON is YAML): the fit cell's data
    and split, att.yaml's model and loss, its batch and learning rate."""
    config = out_dir / 'parity_shape.yaml'
    config.write_text(json.dumps({
        'dataset': {'class': 'Garment3DPatternFullDataset', 'data_folders': FIT_FOLDERS,
                    'mesh_samples': POINTS,
                    'max_pattern_len': ATT_DATA_CONFIG['max_pattern_len'],
                    'max_panel_len': ATT_DATA_CONFIG['max_panel_len'],
                    'max_num_stitches': ATT_DATA_CONFIG['max_num_stitches']},
        'data_split': FIT_SPLIT, 'NN': dict(ATT_NN_CONFIG, loss=ATT_LOSS_CONFIG),
        'trainer': {'batch_size': ATT_TRAINER['batch_size'],
                    'learning_rate': ATT_TRAINER['learning_rate']}}))
    return config


def parity_check_phase(out_dir, fit_run_id):
    """The port's parity CLI (cli/parity_check.py) on the att f32 fit run's
    best checkpoint over parity_run/data_big/ (its split, 30 test
    garments): a first pass writes the report; a second pass with
    `--expected` from the first pass's shape metrics must exit 0. Returns
    the launches of each pass (rows 4-5: one each per test batch)."""
    from garment_pattern_estimation_torch.cli import parity_check

    checkpoint = fit_checkpoint(out_dir, fit_run_id)
    args = ['--dataset_root', str(ROOT / 'parity_run' / 'data_big'),
            '--shape_config', str(parity_shape_config(out_dir)), '--shape_pth', str(checkpoint)]
    passes = []
    for name, extra in (('first', []),
                        ('expected', ['--expected', str(out_dir / 'parity_expected.json')])):
        reset_launches()
        start = time.perf_counter()
        rc = parity_check.main(args + ['--output', str(out_dir / f'parity_{name}.json')]
                               + extra)
        seconds = time.perf_counter() - start
        report = json.loads((out_dir / f'parity_{name}.json').read_text())
        passes.append({'pass': name, 'rc': rc, 'seconds': seconds, 'launches': phase_launches(),
                       'comparisons': report.get('comparisons')})
        check(rc == 0, f'parity_check: the {name} pass exited {rc}')
        if name == 'first':
            metrics = report['shape_metrics']
            check(sorted(metrics) == sorted(parity_check.SHAPE_METRICS)
                  and all(math.isfinite(v) for v in metrics.values()),
                  f'parity_check: shape metrics {metrics}')
            (out_dir / 'parity_expected.json').write_text(json.dumps(metrics))
    check(all(c['pass'] for c in passes[1]['comparisons']) and len(passes[1]['comparisons'])
          == len(parity_check.SHAPE_METRICS), f'parity_check: {passes[1]}')
    for one in passes:
        check(one['launches']['fused_small_c'] > 0 and one['launches']['fused_wide_c'] > 0,
              f'parity_check: the {one["pass"]} pass launched {one["launches"]}')
    emit({'phase': 'parity_check', 'checkpoint': checkpoint.name, 'shape_metrics': metrics,
          'passes': passes})
    return [one['launches'] for one in passes]


# the parity CLI's replica modes (parity_train): the epochs of each training
# campaign, and the bar on the port arm's first-step loss against the
# replica's (the same init and batch: only near-tie kNN choices and rounding
# differ)
PARITY_TRAIN_EPOCHS = 3
PARITY_FIRST_STEP_REL = 1e-3
# fault C9 (ROADMAP.md): the serving forward's relative gaps to the replica
# on the fit run's 30 test garments as recorded on an H100 (the fused
# layer's bf16 edge-MLP inputs), rounded up at the third digit; the
# `torch:` rows may not exceed them
C9_SERVING_GAPS = {'panel_shape_l2': 0.00399, 'num_panels_accuracy': 0.0385,
                   'num_edges_accuracy': 0.0218, 'rotation_l2': 0.0141,
                   'translation_l2': 0.00789}
# the parity CLI's functions that train or evaluate one arm: the port's
# (rows 8-9 per step, rows 4-5 per eval batch) and the replica's (none)
PARITY_ARMS = {'_train_port': 'port_train', 'eval_metrics': 'port_eval',
               'train_reference_torch': 'torch_train',
               'train_reference_stitch_torch': 'torch_train',
               '_torch_eval_metrics': 'torch_eval', '_torch_eval_stitch_metrics': 'torch_eval'}


@contextlib.contextmanager
def parity_arms(calls, captured):
    """The parity CLI's arm functions (PARITY_ARMS) wrapped: each call
    appends to `calls` its arm, wall seconds (synchronized), launches
    (all_launches' differences) and, for a training arm, its steps and ms
    per step, and for the port's, the launches its steps and validation
    passes must make; `captured` keeps each function's last arguments."""
    import torch
    from garment_pattern_estimation_torch.cli import parity_check
    from garment_pattern_estimation_torch.models.blocks import UNFUSED_EVAL

    originals = {name: getattr(parity_check, name) for name in PARITY_ARMS}

    def wrap(name, fn):
        def run(*args, **kwargs):
            unfused = UNFUSED_EVAL.get()
            torch.cuda.synchronize()
            before = all_launches()
            start = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            after = all_launches()
            entry = {'arm': PARITY_ARMS[name], 'seconds': seconds,
                     'launches': {k: after[k] - before[k] for k in after
                                  if after[k] != before[k]}}
            if PARITY_ARMS[name].endswith('_train'):
                entry.update(steps=len(out), ms_per_step=1000 * seconds / len(out))
            if name == '_train_port':
                epoch_batches, valid_batches = args[2], args[3]
                entry['valid_batches'] = len(epoch_batches) * len(valid_batches)
            elif name == 'eval_metrics':
                # the serving forward, or the f32 one (`_f32_metrics`:
                # every EdgeConv layer off the fused layer)
                entry.update(model=args[0].name, batches=len(args[2].get_loader(args[3])),
                             f32=unfused)
            captured[name] = args
            calls.append(entry)
            return out
        return run

    for name, fn in originals.items():
        setattr(parity_check, name, wrap(name, fn))
    try:
        yield
    finally:
        for name, fn in originals.items():
            setattr(parity_check, name, fn)


def check_parity_arms(calls, shape):
    """Each port arm of the shape model launched knn_gather forward (small
    and wide C) and backward once per step and the fused layer (small and
    wide C) once per validation or test batch (its f32 evaluation the
    knn_gather forward instead), and nothing else; the replica arms and the
    stitch model's arms launched nothing."""
    for entry in calls:
        launches = entry['launches']
        if shape and entry['arm'] == 'port_train':
            expected = {'knn_gather_fwd_small_c': entry['steps'],
                        'knn_gather_fwd_wide_c': entry['steps'],
                        'knn_gather_bwd': entry['steps'],
                        'fused_small_c': entry['valid_batches'],
                        'fused_wide_c': entry['valid_batches']}
        elif shape and entry['arm'] == 'port_eval':
            kernel = 'knn_gather_fwd' if entry['f32'] else 'fused'
            expected = {f'{kernel}_small_c': entry['batches'],
                        f'{kernel}_wide_c': entry['batches']}
        else:
            expected = {}
        check(launches == expected,
              f'parity_train: the {entry["arm"]} arm launched {launches}, expected {expected}')


def parity_train_phase(out_dir, fit_run_id):
    """The parity CLI's replica modes (cli/parity_check.py) on the fit
    cell's data (parity_run/data_big/, its split, att.yaml's widths, batch
    30, lr 0.002, att.yaml's loss), each pass on its own counts:
    (a) `--torch_cross_check` on the att f32 fit run's best checkpoint: the
    replica's forward (`cdist` + `topk`) on the 30 test garments against
    the port's serving forward (rows 4-5), each `torch:` row within its
    recorded C9 gap (C9_SERVING_GAPS; the rows past the CLI's 1% make its rc
    1, and only they may fail), and against the port's f32 forward (row 8's
    forward, f32 edge MLPs), every `torch_f32:` row within the CLI's 1%;
    the three forwards' ms on a test batch; (b) `--torch_train_cross_check` for
    PARITY_TRAIN_EPOCHS epochs with one noise seed and one port seed, then
    `--stitch_train_cross_check` with STITCH_NN and one noise seed: rc 0 by
    the CLI's rule (each row within max(1%, the noise floor)), the port
    arm's first-step loss within PARITY_FIRST_STEP_REL of the replica's,
    each arm's launches (`check_parity_arms`), seconds and ms per step; (c)
    `--resume` on (b)'s shape report trains nothing: no arm runs, no
    launch, and the report it writes equals (b)'s. Returns the launches of
    (a) and (b)."""
    import shutil

    import torch
    from garment_pattern_estimation_torch.cli import parity_check
    from garment_pattern_estimation_torch.models.blocks import unfused_eval
    from garment_pattern_estimation_torch.ops import knn

    data = str(ROOT / 'parity_run' / 'data_big')
    shape_args = ['--dataset_root', data, '--shape_config', str(parity_shape_config(out_dir))]
    stitch_config = out_dir / 'parity_stitch.yaml'          # JSON is YAML
    stitch_config.write_text(json.dumps({
        'dataset': dict(STITCH_DATASET, data_folders=FIT_FOLDERS, filter_by_params=None),
        'data_split': FIT_SPLIT, 'NN': STITCH_NN,
        'trainer': {k: STITCH_TRAINER[k] for k in ('batch_size', 'learning_rate')}}))
    train_args = ['--train_epochs', str(PARITY_TRAIN_EPOCHS), '--noise_floor',
                  '--noise_seeds', '1']
    passes = {
        'cross_check': shape_args + ['--shape_pth', str(fit_checkpoint(out_dir, fit_run_id)),
                                     '--torch_cross_check'],
        'train': shape_args + ['--torch_train_cross_check', '--port_seeds', '1'] + train_args,
        'stitch_train': ['--dataset_root', data, '--stitch_config', str(stitch_config),
                         '--stitch_train_cross_check'] + train_args,
    }
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    line = {'phase': 'parity_train', 'card': card_name_and_power()}
    total = {}
    captured = {}
    for name, args in passes.items():
        calls = []
        output = out_dir / f'parity_{name}.json'
        reset_launches()
        knn.launches_by_shape.clear()
        start = time.perf_counter()
        with parity_arms(calls, captured):
            rc = parity_check.main(args + ['--output', str(output)])
        seconds = time.perf_counter() - start
        launches = all_launches()
        report = json.loads(output.read_text())
        for key, value in launches.items():
            total[key] = total.get(key, 0) + value
        line[name] = {'rc': rc, 'seconds': seconds, 'launches': launches, 'arms': calls,
                      'comparisons': report.get('comparisons')}
        check_parity_arms(calls, shape=name != 'stitch_train')
        if name == 'cross_check':
            rows = {c['metric']: c for c in report['comparisons']}
            serving = {k: rows.get(f'torch:{k}') for k in parity_check.SHAPE_METRICS}
            f32 = {k: rows.get(f'torch_f32:{k}') for k in parity_check.SHAPE_METRICS}
            line[name]['serving_vs_replica'] = {k: c and c['delta'] for k, c in serving.items()}
            line[name]['f32_vs_replica'] = {k: c and c['delta'] for k, c in f32.items()}
            failed = sorted(n for n, c in rows.items() if not c['pass'])
            check(len(rows) == 2 * len(parity_check.SHAPE_METRICS)
                  and all(c and c['pass'] and c['bar'] == 0.01 for c in f32.values())
                  and all(c and c['delta'] <= C9_SERVING_GAPS[k] for k, c in serving.items())
                  and rc == (1 if failed else 0)
                  and all(n.startswith('torch:') for n in failed),
                  f'parity_train: cross_check rc {rc}, rows {rows} (serving bars '
                  f'{C9_SERVING_GAPS})')
            check(sorted(entry.get('f32') for entry in calls if entry['arm'] == 'port_eval')
                  == [False, True], f'parity_train: cross_check evaluations {calls}')
            # the three forwards on the pass's first test batch, the
            # checkpoint's weights loaded (the port's by eval_metrics, the
            # replica's by the CLI's strict load)
            replica, wrapper, model = captured['_torch_eval_metrics']
            batch = next(iter(wrapper.get_loader('test')))['features'].float().cuda()
            with torch.no_grad():
                forward_ms = {'batch': list(batch.shape),
                              'port': cuda_ms(lambda: model.module(batch), warmup=2, runs=10)}
                with unfused_eval():
                    forward_ms['port_f32'] = cuda_ms(lambda: model.module(batch), warmup=2,
                                                     runs=10)
                forward_ms['replica'] = cuda_ms(lambda: replica(batch), warmup=2, runs=10)
            line[name]['forward_ms'] = forward_ms
            del replica, wrapper, model, batch
            captured.clear()
        else:
            check(rc == 0, f'parity_train: the {name} pass exited {rc}: {line[name]}')
            key = 'train_loss_first_step' if name == 'train' else 'stitch_train_loss_first_step'
            first = report[key]
            gap = abs(first['ours'] - first['torch']) / abs(first['torch'])
            line[name]['first_step_loss'] = dict(first, gap=gap)
            check(gap <= PARITY_FIRST_STEP_REL,
                  f'parity_train: {name} first-step loss {first} ({gap} > '
                  f'{PARITY_FIRST_STEP_REL})')
            line[name]['noise_floor'] = report.get('torch_noise_floor',
                                                   report.get('torch_stitch_noise_floor'))
            captured.clear()
    line['peak_memory_gb'] = torch.cuda.max_memory_allocated() / 1e9

    # (c) the shape campaign resumed from its own report: nothing to train
    resumed = out_dir / 'parity_resume.json'
    shutil.copy(out_dir / 'parity_train.json', resumed)
    calls = []
    reset_launches()
    knn.launches_by_shape.clear()
    start = time.perf_counter()
    with parity_arms(calls, captured):
        rc = parity_check.main(passes['train'] + ['--resume', '--output', str(resumed)])
    launches = {k: v for k, v in all_launches().items() if v}
    same = json.loads(resumed.read_text()) == json.loads((out_dir / 'parity_train.json')
                                                         .read_text())
    line['resume'] = {'rc': rc, 'seconds': time.perf_counter() - start, 'launches': launches,
                      'arms': calls, 'report_equal': same}
    check(rc == 0 and not calls and not launches and same,
          f'parity_train: --resume trained or changed something: {line["resume"]}')
    emit(line)
    return total


def encoders_decoders(seconds, k10_lines, k5_lines):
    """The variant phases, the attention model with pool10, then FPS alone
    at pointnet's serving shape (`fps_line`). Each
    variant sets the counts to 0 before its serving and its training and
    reads them after: the k = K_WIDE entries of `k10_lines` take pool10's
    launches by shape (row 1's is on no path of the slice: the pools rank
    32-wide features); each (kernels-line entry, counter, 0 serving or 1
    training) of `k5_lines` gets `launches_variants`, the other variants'
    launches of that counter at k = K."""
    variant_launches = {}
    for name in ENCODER_VARIANTS:
        variant_launches[name] = timed(seconds, f'encoders_decoders_{name}', variant_phase, name)
    timed(seconds, 'encoders_decoders_attention_pool10', attention_pool10_phase)
    emit({'phase': 'encoders_decoders', 'variant': 'fps',
          **fps_line(physical_points(1, BATCH, POINTS))})
    pool10_serving, pool10_training = variant_launches['pool10']
    for key, counter in (('fused_small_c', f'fused_small_c {POINTS} 3 {K_WIDE}'),
                         ('fused_wide_c_200', f'fused_wide_c {POINTS // 10} 32 {K_WIDE}'),
                         ('fused_wide_c_20', f'fused_wide_c {POINTS // 100} 128 {K_WIDE}'),
                         ('knn_wide_2000', f'knn_wide {POINTS} 32 {K_WIDE}'),
                         ('knn_wide_200', f'knn_wide {POINTS // 10} 128 {K_WIDE}')):
        k10_lines[key]['launches'] = pool10_serving.get(counter, 0)
        k10_lines[key]['launches_training'] = pool10_training.get(counter, 0)
    for key, counter in (
            ('gather_fwd_small_c', f'knn_gather_fwd_small_c {POINTS} 3 {K_WIDE}'),
            ('gather_fwd_wide_c_200', f'knn_gather_fwd_wide_c {POINTS // 10} 32 {K_WIDE}'),
            ('gather_bwd_200', f'knn_gather_bwd {POINTS // 10} 32 {K_WIDE}'),
            ('gather_fwd_wide_c_20', f'knn_gather_fwd_wide_c {POINTS // 100} 128 {K_WIDE}'),
            ('gather_bwd_20', f'knn_gather_bwd {POINTS // 100} 128 {K_WIDE}')):
        k10_lines[key]['launches'] = pool10_training.get(counter, 0)
    k10_lines['knn']['launches'] = 0
    k10_lines['knn']['on_main_path'] = False
    for key, line in k10_lines.items():
        check(key == 'knn' or line['launches'] > 0,
              f'encoders_decoders: {line["name"]} was not launched on pool10\'s path')
    for line, counter, which in k5_lines:
        line['launches_variants'] = {
            name: sum(n for key, n in counts[which].items()
                      if key.split()[0] == counter and key.split()[-1] == str(K))
            for name, counts in variant_launches.items() if name != 'pool10'}


def stress_train_phase(bf16=False, variant=None, steps=STRESS_TRAIN_STEPS, cpu_check=True,
                       phase=None):
    """Training at the stress configuration, f32 or the bf16 mode (or the
    model of `variant`): `steps` steps, every EdgeConv layer through the
    chunked sweeps ('fused_final'), conv0's kNN through the small-D kernel
    and conv1's through the wide-D one. The bf16 mode then takes one
    'streamed' step, as the JAX bench tries both schedules. `cpu_check`:
    the forced-chunk step against the CPU plain path. Returns the launches
    and a function that takes one more ('fused_final') step."""
    import torch
    from garment_pattern_estimation_torch.models import build_model
    from garment_pattern_estimation_torch.ops import edgeconv, knn, knn_gather, launches_by_variant
    from garment_pattern_estimation_torch.ops.edgeconv_train import _default_chunk
    from garment_pattern_estimation_torch.train import Trainer

    phase = phase or ('stress_training_bf16' if bf16 else 'stress_training')
    model_name, nn_section, loss_section = VARIANTS[
        variant if variant is not None else '_bf16' if bf16 else '']
    model = build_model(model_name, ATT_DATA_CONFIG, nn_section, loss_section, seed=0)
    trainer = Trainer(ATT_TRAINER)
    trainer.make_optimizer(model, steps_per_epoch=steps)
    batch = training_batch(torch.Generator().manual_seed(8), STRESS_BATCH, 'cuda',
                           STRESS_POINTS)
    states = torch.Generator(device='cuda').manual_seed(ATT_TRAINER['random_seed'])
    convs = model.module.feature_extractor.conv_layers
    check(all(conv.chunked(STRESS_BATCH, STRESS_POINTS, w)
              for conv, w in zip(convs, (3, ATT_NN_CONFIG['EConv_feature']))),
          f'{phase}: the auto rule does not chunk the stress batch')

    def step_once():
        before = launches_by_variant(knn)
        torch.cuda.synchronize()
        start = time.perf_counter()
        loss, terms = trainer.train_step(model, batch, epoch=0, generator=states)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - start) * 1e3
        per_step = {key: launches_by_variant(knn)[key] - before[key] for key in before}
        check(per_step == {'knn': 1, 'knn_wide': 1},
              f'{phase}: a step launched {per_step}, expected 1 + 1')
        return loss.item(), terms, ms

    torch.cuda.reset_peak_memory_stats()
    for counter in (edgeconv, knn, knn_gather):
        counter.launches_by_shape.clear()
    losses, times = [], []
    for _ in range(steps):
        loss, terms, ms = step_once()
        losses.append(loss)
        times.append(ms)
    launches = launches_by_variant(knn)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    streamed = {}
    if bf16:
        # one step in the 'streamed' schedule (its layer-(L-2) buffer kept)
        for conv in convs:
            conv.train_mode = 'streamed'
        torch.cuda.reset_peak_memory_stats()
        loss, _, ms = step_once()
        streamed = {'streamed_step_ms': ms, 'streamed_loss': loss,
                    'streamed_peak_memory_gb': torch.cuda.max_memory_allocated() / 1e9}
        losses.append(loss)
        for conv in convs:
            conv.train_mode = 'fused_final'
    check(not any(launches_by_variant(knn_gather).values()),
          f'{phase}: knn_gather launched {launches_by_variant(knn_gather)}')
    check(not any(launches_by_variant(edgeconv).values()),
          f'{phase}: the fused eval kernel launched {launches_by_variant(edgeconv)}')
    check(all(math.isfinite(v) for v in losses), f'{phase}: losses {losses}')
    check(losses[-1] < losses[0], f'{phase}: the loss did not fall: {losses}')

    def forced(module):
        for conv in module.feature_extractor.conv_layers:
            conv.train_chunked, conv.train_chunk_size = True, FORCED_CHUNK

    # bf16: 2 clouds, so the CPU's order floor can swap them
    clouds = 2 if bf16 else 1
    gaps = compare_step_cpu(phase, model, batch, clouds, forced, order_floor=bf16) \
        if cpu_check else None
    step_ms = statistics.median(times[1:])
    emit({'phase': phase, 'batch': [STRESS_BATCH, STRESS_POINTS, 3],
          'compute_dtype': model.config['compute_dtype'],
          'k_neighbors': nn_section['k_neighbors'],
          'steps': steps, 'train_mode': convs[0].train_mode,
          'chunk': _default_chunk(STRESS_BATCH, STRESS_POINTS, nn_section['k_neighbors'], max(
              ATT_NN_CONFIG['EConv_hidden'], ATT_NN_CONFIG['EConv_feature'])),
          'launches': launches,
          'losses': losses,
          'terms_last_step': {k: v.item() if math.isfinite(v.item()) else None
                              for k, v in terms.items()},
          'step_times_ms': times, 'step_ms': step_ms,
          'clouds_per_s': STRESS_BATCH / step_ms * 1e3, 'peak_memory_gb': peak_gb,
          **streamed, f'vs_cpu_plain_{clouds}_cloud_forced_chunks': gaps})
    return launches, lambda: trainer.train_step(model, batch, epoch=0, generator=states)


def profile_phase(name, fn):
    """One call of `fn` under torch.profiler: device time by kernel (the
    events on the card; host-side ranges such as autograd nodes, which
    carry their kernels' time, are left out) and the device's idle share of
    the call's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    # a later profiler session in one process can lose the first kernel it
    # sees (the stress step's small-D kNN went missing, a marker kernel in
    # front of it did not always help): a warm-up cycle traces one call and
    # drops it, the active cycle traces the call that is reported
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
        prof.step()
    # the schedule's ProfilerStep* range and the port's spans (gpe.*) are
    # annotations on the card, not kernels: their time spans the kernels
    # they hold
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not e.key.startswith(('ProfilerStep', 'gpe.'))]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    by_class = {}
    for key, ms, _ in rows:
        kind = kernel_class(key)
        by_class[kind] = by_class.get(kind, 0.0) + ms
    emit({'phase': 'profile', 'of': name, 'wall_ms': wall_ms, 'device_kernel_ms': device_ms,
          'idle_share': max(0.0, 1.0 - device_ms / wall_ms), 'by_class_ms': by_class,
          'kernel_rows': len(rows),
          'top': [{'kernel': k[:160], 'ms': ms, 'count': n} for k, ms, n in rows[:16]]})


def kernel_class(key):
    """The class of a device kernel by its name: each of the port's own
    kernels by name, else matrix products, reductions, index gathers and
    scatters, elementwise passes, copies and fills, other."""
    for own in ('split_rows_kernel', 'knn_wide_stream_kernel', 'knn_wide_kernel', 'knn_kernel',
                'fused_edgeconv_stream_kernel', 'fused_edgeconv_mlp_kernel',
                'fused_edgeconv_kernel', 'knn_gather'):
        if own in key:
            return own
    lowered = key.lower()
    for kind, marks in (('gemm', ('gemm', 'gemv')),
                        ('index_gather_scatter', ('indexfunc', 'indexselect', 'scatter_gather')),
                        ('reduce', ('reduce_kernel',)), ('elementwise', ('elementwise',)),
                        ('copy_fill', ('memcpy', 'memset', 'copy', 'fill'))):
        if any(mark in lowered for mark in marks):
            return kind
    return 'other'


def stress_kernels(widths):
    """The standalone kNN, the two column-tiled fused variants (f32, then
    the bf16 mode) and the wide-D kNN on a seeded stress batch (conv1 and
    the wide-D kNN on conv0's output); returns their lines of the kernels
    list."""
    import torch

    gen = torch.Generator().manual_seed(7)
    x0 = torch.randn(STRESS_BATCH, STRESS_POINTS, 3, generator=gen).cuda()
    conv0 = random_folded(gen, 3, widths, 'cuda')
    conv1 = random_folded(gen, widths[-1], widths, 'cuda')
    knn_line = knn_phase(x0)
    x1, small_line = check_kernel('fused_edgeconv_small_c_tiled', x0, conv0, widths,
                                  tile_variant=True)
    _, wide_line = check_kernel('fused_edgeconv_wide_c_tiled', x1, conv1, widths,
                                tile_variant=True)
    x1_bf16, small_bf16 = check_kernel('fused_edgeconv_small_c_tiled_bf16', x0, conv0,
                                       widths, tile_variant=True, bf16=True)
    _, wide_bf16 = check_kernel('fused_edgeconv_wide_c_tiled_bf16', x1_bf16, conv1, widths,
                                tile_variant=True, bf16=True)
    del x1_bf16
    knn_wide_line = knn_wide_phase(x1)
    split_phase(x1, conv1, knn_line, small_line, wide_line)
    return knn_line, small_line, wide_line, knn_wide_line, small_bf16, wide_bf16


def split_phase(x1, folded, knn_line, small_line, wide_line):
    """Each tiled layer's time split into its selection and its edge MLP.
    Row 6's selection is the standalone kNN's kernel at the same shape (the
    same select_small_c instantiation); row 7's is the layer's own first
    launch (`fused_edgeconv_select`: the split pass and select_stream),
    whose ids must equal the layer's. The edge MLP is the rest of the
    layer's time."""
    import ctypes
    import torch
    from garment_pattern_estimation_torch.ops import _build, edgeconv, knn

    B, N, C = x1.shape
    lib = _build.load_library('fused_edgeconv')
    fn = lib.fused_edgeconv_select
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_size_t] + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    scratch = torch.empty(knn.scratch_bytes(lib, 'fused_edgeconv', B, N, C), device=x1.device,
                          dtype=torch.uint8)
    idx = torch.empty(B, N, K, device=x1.device, dtype=torch.int32)

    def select():
        err = fn(x1.data_ptr(), idx.data_ptr(), scratch.data_ptr(), scratch.numel(), B, N, C,
                 K, torch.cuda.current_stream().cuda_stream)
        check(err == 0, f'split: fused_edgeconv_select failed with CUDA error {err}')

    select()
    clouds = slice(0, CHUNK)
    _, fused_idx = edgeconv.fused_edgeconv(x1[clouds], folded, K,
                                           return_idx=True)
    torch.cuda.synchronize()
    check(torch.equal(idx[clouds].long(), fused_idx),
          'split: the selection-only ids differ from the fused kernel\'s')
    wide_select_ms = cuda_ms(select, 1, 5)
    line = {'phase': 'split',
            'fused_edgeconv_small_c_tiled': {
                'ms': small_line['ms'], 'selection_ms': knn_line['ms'],
                'mlp_ms': small_line['ms'] - knn_line['ms'],
                'selection_from': 'knn (the same select_small_c instantiation)'},
            'fused_edgeconv_wide_c_tiled': {
                'ms': wide_line['ms'], 'selection_ms': wide_select_ms,
                'mlp_ms': wide_line['ms'] - wide_select_ms,
                'selection_from': 'fused_edgeconv_select (split pass included)'}}
    emit(line)
    return line


def integer_cloud_phase():
    """The streaming wide selection's ids against the plain version's on
    integer clouds (every product and sum exact, so no near tie exists):
    the tiled fused layer and the wide-D kNN, k = 5 and 16, at (4, 10000,
    150) and (3, 4099, 150); all must be equal."""
    import torch
    from garment_pattern_estimation_torch.ops import edgeconv, knn

    gen = torch.Generator().manual_seed(11)
    line = {'phase': 'integer_clouds', 'coordinates': [-8, 8], 'checks': []}
    for B, N in ((4, STRESS_POINTS), (3, 4099)):
        x = torch.randint(-8, 9, (B, N, 150), generator=gen).float().cuda()
        folded = random_folded(gen, 150, [200, 200, 150], 'cuda')
        for k in (5, 16):
            _, idx = edgeconv.fused_edgeconv(x, folded, k, return_idx=True)
            ref = edgeconv.edgeconv_select(x, k)[0]
            fused_equal = torch.equal(idx, ref)
            ids = knn.knn(x, k)
            knn_equal = torch.equal(ids, knn.knn_reference(x, k))
            line['checks'].append({'shape': [B, N, 150], 'k': k, 'fused_ids_equal': fused_equal,
                                   'knn_wide_ids_equal': knn_equal})
            check(fused_equal, f'integer_clouds: fused ids differ from the plain version\'s at '
                               f'{(B, N, 150)}, k = {k}')
            check(knn_equal, f'integer_clouds: knn_wide ids differ from the plain version\'s at '
                             f'{(B, N, 150)}, k = {k}')
        del x
    emit(line)
    return line


def kernel_name(mangled):
    """`name<template arguments>` of a mangled kernel whose name ends in
    'kernel' (the shortest such name whose length precedes it), else the
    mangled name."""
    for end in (m.end() for m in re.finditer('kernel', mangled)):
        for length in range(len('kernel'), end):
            start = end - length
            if mangled[:start].endswith(str(length)):
                args = re.match(r'I((?:L[ib]\d+E)+)E', mangled[end:])
                return mangled[start:end] + (
                    '<' + ','.join(re.findall(r'L[ib](\d+)E', args.group(1))) + '>'
                    if args else '')
    return mangled


def template_args(name):
    """The integer template arguments of `kernel<a,b,...>`, [] if none."""
    args = re.search(r'<([\d,]*)>$', name)
    return [int(a) for a in args.group(1).split(',')] if args and args.group(1) else []


def ptxas_usage(log):
    """{kernel<template arguments>: [registers, spill store bytes, spill
    load bytes]} for every entry function in an `nvcc -Xptxas -v` log."""
    usage, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = kernel_name(entry.group(1))
            usage[name] = [None, 0, 0]
        elif name is not None and 'spill stores' in line:
            stores, loads = re.findall(r'(\d+) bytes spill', line)
            usage[name][1:] = [int(stores), int(loads)]
        elif name is not None and 'registers' in line:
            usage[name][0] = int(re.search(r'Used (\d+) registers', line).group(1))
    return usage


def sass_hmma(path):
    """{kernel: tensor-core instructions (HMMA, and HGMMA: wgmma)} in the
    SASS of the library at `path` (kernels with none left out), or None
    where the toolkit has no cuobjdump."""
    tool = Path('/usr/local/cuda/bin/cuobjdump')
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), '-sass', path], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        function = re.search(r'Function : (\S+)', line)
        if function:
            name = kernel_name(function.group(1))
        elif name is not None and ('HMMA' in line or 'HGMMA' in line):
            counts[name] = counts.get(name, 0) + 1
    return counts


def card_name_and_power():
    """The first card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def timed(seconds, name, fn, *args):
    """fn(*args), its wall seconds recorded under `name`."""
    start = time.perf_counter()
    out = fn(*args)
    seconds[name] = time.perf_counter() - start
    return out


def parse_args(argv):
    parser = argparse.ArgumentParser(description='Chip smoke test of the PyTorch + CUDA port.')
    parser.add_argument('--parallel_only', action='store_true',
                        help='the build, the att f32 fit and the parallel phases alone '
                             '(parallel_fit, parallel_ring, points_sharded), on the cards '
                             'visible: a multi-card host\'s run')
    parser.add_argument('--stitch_pairs_seed', type=int, default=None,
                        help='stitch_pipeline\'s pair draw (the pairs_seed its line printed) '
                             'in place of fresh entropy')
    return parser.parse_args(argv)


def parallel_phases(seconds, out_dir, fit_run_id):
    """The parallel phases, each on the cards visible: parallel_fit (against
    the att f32 fit run `fit_run_id`) and parallel_ring in the world-1
    group, then points_sharded. Returns parallel_fit's launches."""
    with World1Group():
        launches = timed(seconds, 'parallel_fit', parallel_fit_phase, out_dir / 'experiments',
                         fit_run_id)
        timed(seconds, 'parallel_ring', parallel_ring_phase, out_dir)
    timed(seconds, 'points_sharded', points_sharded_phase, out_dir)
    return launches


def main():
    args = parse_args(sys.argv[1:])
    import torch
    if not torch.cuda.is_available():
        fail('no CUDA device')
    sys.path.insert(0, str(ROOT))
    from garment_pattern_estimation_torch.ops import _build

    seconds = {}
    report = timed(seconds, 'build', _build.build_all)
    hmma = {n: sass_hmma(r['path']) for n, r in report.items()}
    ptxas = {n: ptxas_usage(r['log']) for n, r in report.items()}
    emit({'phase': 'build', 'seconds': {n: r['seconds'] for n, r in report.items()},
          'ptxas': ptxas, 'sass_hmma': hmma,
          # [registers, spill store bytes, spill load bytes] of the k = 16
          # instance and of the capacity instances K = 32, 64, 128
          'k16': {f'{lib}:{n}': u for lib, usage in ptxas.items() for n, u in usage.items()
                  if template_args(n)[:1] == [16]},
          'k_capacity': {f'{lib}:{n}': u for lib, usage in ptxas.items()
                         for n, u in usage.items() if template_args(n)[:1] in ([32], [64], [128])},
          'k_capacity_csr': {n: u for n, u in ptxas['knn_gather'].items()
                             if n.startswith('knn_gather_csr_large_kernel')}})
    for lib, kernel in (('knn_wide', 'knn_wide_kernel<5>'),
                        ('knn_gather', 'knn_gather_fwd_kernel<5,0,0>'),
                        ('knn_wide', 'knn_wide_stream_kernel<5>'),
                        ('fused_edgeconv', 'fused_edgeconv_stream_kernel<5>')):
        check(hmma[lib] is None or hmma[lib].get(kernel, 0) > 0,
              f'build: no HMMA instruction in {kernel}')
    fused = [n for n in ptxas['fused_edgeconv'] if n.startswith('fused_edgeconv_kernel<')]
    # k = 1..8 and the k = 9..16 instance: 34 small-C (k x key dims x
    # tiling), 18 wide-C and 9 selection-only; the capacity instances K =
    # 32, 64, 128 (one per tiling): 6 small-C, 3 wide-C, 3 selection-only;
    # the small-C selections alone of the two-launch layers (K = 1, 16, 32,
    # 64, 128): 12, and the wide-C K = 1 one untiled
    check(len(fused) == 86, f'build: {len(fused)} fused_edgeconv_kernel instantiations, not 86')
    if hmma['fused_edgeconv'] is not None:
        # the edge MLP (and the wide selections) on tensor cores in every
        # instantiation that selects neighbours, but a small-C selection
        # alone (template arguments K, small C, tiled, key dims, MLP)
        without = [n for n in ptxas['fused_edgeconv']
                   if (n.startswith('fused_edgeconv_kernel<') and template_args(n)[0] > 1
                       and template_args(n)[1:5:3] != [1, 0])
                   or n.startswith(('fused_edgeconv_mlp_kernel<',
                                    'fused_edgeconv_select_kernel<'))
                   if not hmma['fused_edgeconv'].get(n, 0)]
        check(not without, f'build: no HMMA instruction in {without}')
    spilled = [f'{lib}:{n}' for lib, usage in ptxas.items() for n, (_, stores, loads)
               in usage.items() if template_args(n)[:1] == [5] and (stores or loads)]
    check(not spilled, f'build: k = 5 instantiations spill registers: {spilled}')
    if args.parallel_only:
        # fit (parallel_fit's reference) and the parallel phases alone
        with tempfile.TemporaryDirectory(
                dir=ROOT / 'garment_pattern_estimation_torch' / '_build') as out_dir:
            out_dir = Path(out_dir)
            _, fit_run_id = timed(seconds, 'fit', fit_phase, out_dir / 'experiments', '')
            parallel_phases(seconds, out_dir, fit_run_id)
        emit({'phase_seconds': seconds})
        print(card_name_and_power(), flush=True)
        emit({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                     'count': torch.cuda.device_count()}})
        return

    def att_kernels(bf16):
        gen = torch.Generator().manual_seed(0)
        x0 = torch.randn(BATCH, POINTS, 3, generator=gen).cuda()
        conv0 = random_folded(gen, 3, widths, 'cuda')
        conv1 = random_folded(gen, widths[-1], widths, 'cuda')
        suffix = '_bf16' if bf16 else ''
        # conv1's input is conv0's output, as in the model
        x1, small_line = check_kernel('fused_edgeconv_small_c' + suffix, x0, conv0, widths,
                                      bf16=bf16)
        _, wide_line = check_kernel('fused_edgeconv_wide_c' + suffix, x1.contiguous(), conv1,
                                    widths, bf16=bf16)
        # the training step's shapes: its batch of 30, conv1 on conv0's features
        value_chunks = 1 if bf16 else 2
        gather_lines = check_knn_gather(x0[:TRAIN_BATCH].contiguous(), False, value_chunks) \
            + check_knn_gather(x1[:TRAIN_BATCH].contiguous(), True, value_chunks)
        return small_line, wide_line, gather_lines

    def launch_key(name):
        """The launch counter of a knn_gather line."""
        return name[len('knn_gather_'):].removesuffix('_bf16')

    widths = [ATT_NN_CONFIG['EConv_hidden']] * ATT_NN_CONFIG['EConv_hidden_depth'] \
        + [ATT_NN_CONFIG['EConv_feature']]
    small_line, wide_line, gather_lines = timed(seconds, 'kernel+knn_gather', att_kernels,
                                                False)
    small_bf16, wide_bf16, gather_bf16 = timed(seconds, 'kernel_bf16+knn_gather_bf16',
                                               att_kernels, True)
    timed(seconds, 'knn_gather_bwd_sweep', gather_backward_sweep)
    k10_lines = timed(seconds, 'kernel_k10+knn_gather_k10', wide_k_kernels)
    k_range_lines = timed(seconds, 'k_range', k_range_kernels, widths)
    k20_lines = timed(seconds, 'kernel_k20', k20_kernels, widths)
    wide_lines = timed(seconds, 'wide_shapes_kernels', wide_shape_kernels)
    k_large_lines = timed(seconds, 'k_large_kernels', k_large_kernels, widths)
    knn_line, small_tiled_line, wide_tiled_line, knn_wide_line, small_tiled_bf16, \
        wide_tiled_bf16 = timed(seconds, 'knn+kernel_tiled(+bf16)+knn_wide', stress_kernels,
                                widths)
    timed(seconds, 'integer_clouds', integer_cloud_phase)

    # each end-to-end phase sets the counts to 0 just before its runs and
    # reads them just after: the launches of each kernels-line entry come
    # from the phase of its mode
    for bf16, (small, wide, small_tiled, wide_tiled, gathers) in (
            (False, (small_line, wide_line, small_tiled_line, wide_tiled_line, gather_lines)),
            (True, (small_bf16, wide_bf16, small_tiled_bf16, wide_tiled_bf16, gather_bf16))):
        suffix = '_bf16' if bf16 else ''
        launches, model, serve, points = timed(seconds, 'serving' + suffix, serve_phase, suffix)
        small['launches'] = launches['small_c']
        wide['launches'] = launches['wide_c']
        stress_launches, stress_points = timed(seconds, 'stress_serving' + suffix,
                                               stress_serving_phase, model, serve, bf16)
        small_tiled['launches'] = stress_launches['small_c_tiled']
        wide_tiled['launches'] = stress_launches['wide_c_tiled']
        train_launches, train_step = timed(seconds, 'training' + suffix, train_phase, bf16)
        for line in gathers:
            line['launches'] = train_launches[launch_key(line['name'])]
        timed(seconds, 'profile_serving' + suffix, profile_phase, 'serving' + suffix,
              lambda: serve(points))
        timed(seconds, 'profile_training_step' + suffix, profile_phase,
              'training_step' + suffix, train_step)
        timed(seconds, 'profile_stress_serving' + suffix, profile_phase,
              'stress_serving' + suffix, lambda: serve(stress_points))
        del model, serve, stress_points, train_step
        # the main path of the standalone kNN kernels: one launch each per step
        stress_train_launches, stress_train_step = timed(
            seconds, 'stress_training' + suffix, stress_train_phase, bf16)
        if not bf16:
            knn_line['launches'] = stress_train_launches['knn']
            knn_wide_line['launches'] = stress_train_launches['knn_wide']
        timed(seconds, 'profile_stress_training_step' + suffix, profile_phase,
              'stress_training_step' + suffix, stress_train_step)
        del stress_train_step

    # att at DGCNN's k = 20: serving, the stress batch, training, each on
    # its own counts, set to 0 just before and read just after
    launches, model, serve, points = timed(seconds, 'serving_k20', serve_phase, '_k20')
    k20_lines[4]['launches'], k20_lines[5]['launches'] = launches['small_c'], launches['wide_c']
    stress_launches, stress_points = timed(seconds, 'stress_k20_serving', stress_serving_phase,
                                           model, serve, False, 'stress_k20')
    k20_lines[6]['launches'] = stress_launches['small_c_tiled']
    k20_lines[7]['launches'] = stress_launches['wide_c_tiled']
    del model, serve, points, stress_points
    launches, model, serve, points = timed(seconds, 'serving_k20_bf16', serve_phase,
                                           '_k20_bf16')
    k20_lines[4]['launches_serving_k20_bf16'] = launches['small_c']
    k20_lines[5]['launches_serving_k20_bf16'] = launches['wide_c']
    del model, serve, points
    train_launches, _ = timed(seconds, 'train_k20', train_phase, False, '_k20', 'train_k20')
    for row, key in ((8, 'fwd_small_c'), (8.5, 'fwd_wide_c'), (9, 'bwd')):
        k20_lines[row]['launches'] = train_launches[key]
    stress_train_launches, _ = timed(seconds, 'stress_k20_training', stress_train_phase, False,
                                     '_k20', K20_STRESS_STEPS, False, 'stress_k20')
    k20_lines[1]['launches'] = stress_train_launches['knn']
    k20_lines[2]['launches'] = stress_train_launches['knn_wide']
    for line in k20_lines.values():
        check(line['launches'] > 0, f'k = 20 path: {line["name"]} was not launched')
    for k in K_RANGE:
        if k != K_DGCNN:
            for row in (1, 2, 4, 5, 6, 7, 8, 8.5, 9):
                k_range_lines[row, k]['on_main_path'] = False

    # att at the widths of WIDE_VARIANTS and at k = 200, each on its own
    # counts: WIDE_SERVE_CALLS served (64, 2000, 3) batches and
    # WIDE_TRAIN_STEPS training steps
    for variant in WIDE_VARIANTS:
        launches, model, serve, points = timed(seconds, 'serving' + variant, serve_phase,
                                               variant, WIDE_SERVE_CALLS)
        del model, serve, points
        # the deeper and wider MLPs' gradients move more under 1e-7 input
        # noise than att's (depth 4: 0.021 of their norm on the CPU)
        train_launches, _ = timed(seconds, 'train' + variant, train_phase, False, variant,
                                  'train' + variant, TRAIN_BATCH, WIDE_TRAIN_STEPS, True)
        wide_lines[variant, 4]['launches'] = launches['small_c']
        if (variant, 5) in wide_lines:
            wide_lines[variant, 5]['launches'] = launches['wide_c']
        else:
            wide_lines[variant, 8.5]['launches'] = train_launches['fwd_wide_c']
            wide_lines[variant, 8.5]['launches_serving'] = launches['knn_gather_fwd_wide_c']
            wide_lines[variant, 9]['launches'] = train_launches['bwd']
    launches, model, serve, points = timed(seconds, 'serving_k200', serve_phase, '_k200',
                                           WIDE_SERVE_CALLS)
    del model, serve, points
    k_large_lines[4, K_LARGE]['launches'] = launches['small_c']
    k_large_lines[5, K_LARGE]['launches'] = launches['wide_c']
    train_launches, _ = timed(seconds, 'train_k200', train_phase, False, '_k200', 'train_k200',
                              K_LARGE_TRAIN_BATCH, WIDE_TRAIN_STEPS, True)
    for row, key in ((8, 'fwd_small_c'), (8.5, 'fwd_wide_c'), (9, 'bwd')):
        k_large_lines[row, K_LARGE]['launches'] = train_launches[key]
    for (row, k), line in k_large_lines.items():
        line['on_main_path'] = k == K_LARGE and row not in (6, 7)
    for line in [*wide_lines.values(), *k_large_lines.values()]:
        check(not line.get('on_main_path', True) or line['launches'] > 0,
              f'wide_shapes / k_large path: {line["name"]} was not launched')

    # the baseline GarmentFullPattern3D (lstm_stitch_tags.yaml, f32): the
    # launches of rows 4-5 and 8-9 on its own serving and training paths
    launches, model, serve, points = timed(seconds, 'serving_lstm', serve_phase, '_lstm')
    small_line['launches_lstm'] = launches['small_c']
    wide_line['launches_lstm'] = launches['wide_c']
    del model, serve, points
    lstm_launches, lstm_step = timed(seconds, 'training_lstm', train_lstm_phase)
    for line in gather_lines:
        line['launches_lstm'] = lstm_launches[launch_key(line['name'])]

    # the alternative encoders and decoders, each variant on its own counts
    encoders_decoders(seconds, k10_lines, [
        (small_line, 'fused_small_c', 0), (wide_line, 'fused_wide_c', 0),
        (knn_wide_line, 'knn_wide', 0),
        *((g, 'knn_gather_' + launch_key(g['name']), 1) for g in gather_lines)])
    timed(seconds, 'profile_training_step_lstm', profile_phase, 'training_step_lstm',
          lstm_step)
    del lstm_step

    # the on-device sampling stage, then mesh -> prediction through it
    timed(seconds, 'device_sampling', device_sampling_phase)
    for bf16, (small, wide) in ((False, (small_line, wide_line)),
                                (True, (small_bf16, wide_bf16))):
        suffix = '_bf16' if bf16 else ''
        mesh_launches = timed(seconds, 'mesh_to_prediction' + suffix,
                              mesh_to_prediction_phase, bf16)
        small['launches_mesh_to_prediction'] = mesh_launches['small_c']
        wide['launches_mesh_to_prediction'] = mesh_launches['wide_c']

    # Trainer.fit over the dataset, then the stitch pipeline on the att f32
    # run, then the evaluation, prediction and export CLIs on its runs: their
    # own launch counts, set to 0 just before each and read just after
    with tempfile.TemporaryDirectory(dir=ROOT / 'garment_pattern_estimation_torch' / '_build') \
            as out_dir:
        out_dir = Path(out_dir)
        runs_dir = out_dir / 'experiments'          # the CLIs' tracker root under out_dir
        run_ids = {}
        for variant, key, (small, wide, gathers) in (
                ('', 'launches_fit', (small_line, wide_line, gather_lines)),
                ('_bf16', 'launches_fit', (small_bf16, wide_bf16, gather_bf16)),
                ('_lstm', 'launches_fit_lstm', (small_line, wide_line, gather_lines))):
            fit_launches, run_ids[variant] = timed(seconds, 'fit' + variant, fit_phase,
                                                   runs_dir, variant)
            small[key] = fit_launches['fused_small_c']
            wide[key] = fit_launches['fused_wide_c']
            for line in gathers:
                line[key] = fit_launches['knn_gather_' + launch_key(line['name'])]
        # data parallelism: the att fit cell over a data mesh of the cards,
        # the ring, points sharding; each on its own counts
        parallel_launches = parallel_phases(seconds, out_dir, run_ids[''])
        small_line['launches_parallel_fit'] = parallel_launches['fused_small_c']
        wide_line['launches_parallel_fit'] = parallel_launches['fused_wide_c']
        for line in gather_lines:
            line['launches_parallel_fit'] = \
                parallel_launches['knn_gather_' + launch_key(line['name'])]
        # on-device sampling through fit, beside the host-sampled fit run
        ods_launches = timed(seconds, 'fit_on_device', fit_on_device_phase, runs_dir,
                             run_ids[''])
        small_line['launches_fit_on_device'] = ods_launches['fused_small_c']
        wide_line['launches_fit_on_device'] = ods_launches['fused_wide_c']
        for line in gather_lines:
            line['launches_fit_on_device'] = ods_launches['knn_gather_' + launch_key(line['name'])]
        stitch_launches, stitch_run_id = timed(seconds, 'stitch_pipeline',
                                               stitch_pipeline_phase, runs_dir, run_ids[''],
                                               args.stitch_pairs_seed)
        small_line['launches_stitch_pipeline'] = stitch_launches['fused_small_c']
        wide_line['launches_stitch_pipeline'] = stitch_launches['fused_wide_c']
        for line in gather_lines:
            line['launches_stitch_pipeline'] = \
                stitch_launches['knn_gather_' + launch_key(line['name'])]
        parity_launches = timed(seconds, 'parity_check', parity_check_phase, out_dir,
                                run_ids[''])
        small_line['launches_parity_check'] = sum(p['fused_small_c'] for p in parity_launches)
        wide_line['launches_parity_check'] = sum(p['fused_wide_c'] for p in parity_launches)
        # the replica modes: their own counts, the port arms' launches
        parity_train_launches = timed(seconds, 'parity_train', parity_train_phase, out_dir,
                                      run_ids[''])
        small_line['launches_parity_train'] = parity_train_launches['fused_small_c']
        wide_line['launches_parity_train'] = parity_train_launches['fused_wide_c']
        for line in gather_lines:
            line['launches_parity_train'] = \
                parity_train_launches['knn_gather_' + launch_key(line['name'])]

        rows = {'fused_small_c': small_line, 'fused_wide_c': wide_line,
                'fused_small_c_tiled': small_tiled_line, 'fused_wide_c_tiled': wide_tiled_line}
        bf16_rows = {'fused_small_c': small_bf16, 'fused_wide_c': wide_bf16,
                     'fused_small_c_tiled': small_tiled_bf16,
                     'fused_wide_c_tiled': wide_tiled_bf16}
        viz_launches = timed(seconds, 'visualization', visualization_phase, runs_dir,
                             run_ids[''])
        system, configs = cli_files(out_dir, run_ids[''], stitch_run_id)
        test_launches = timed(seconds, 'on_test_set', on_test_set_phase, out_dir, system,
                              configs)
        example_launches = timed(seconds, 'predict_per_example', predict_per_example_phase,
                                 out_dir, system, configs)
        export_launches = timed(seconds, 'export_serving', export_serving_phase, out_dir,
                                system, configs)
        for key, line in rows.items():
            line['launches_visualization'] = viz_launches[key]
            line['launches_on_test_set'] = test_launches[key]
            line['launches_predict_per_example'] = example_launches[key]
            line['launches_export'] = export_launches['f32'][key] \
                + export_launches['f32_stress'][key]
            bf16_rows[key]['launches_export'] = export_launches['bf16'][key]
    emit({'phase_seconds': seconds})

    print(card_name_and_power(), flush=True)
    kernels = [small_line, wide_line, small_tiled_line, wide_tiled_line, knn_line,
               knn_wide_line, *gather_lines, small_bf16, wide_bf16, small_tiled_bf16,
               wide_tiled_bf16, *gather_bf16, *k10_lines.values(),
               *(k20_lines[row] for row in (4, 5, 6, 7, 1, 2, 8, 8.5, 9)),
               *(k_range_lines[row, 128] for row in (4, 5, 6, 7, 1, 2, 8, 8.5, 9)),
               *wide_lines.values(), *k_large_lines.values()]
    for line in kernels:
        line['bound_share'] = line['bound_ms'] / line['ms']
    emit({'kernels': kernels})
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})


if __name__ == '__main__':
    main()
