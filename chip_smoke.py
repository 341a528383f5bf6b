#!/usr/bin/env python3
"""Drives the PyTorch port's serving, eval, training and sparse embedding
training paths, its K-step dispatch, its training pipeline, its ELWC
path (serialized protos through the native loader, and serving requests),
its evaluation and serving artifact (the whole metric suite, the eval
step as a CUDA graph, query-id and TREC-run evaluation, ``export_predictor``
/ ``load_predictor``), the whole loss zoo and multi-task training, the
other scorers, the transformer encoder family, distribution over rank
processes that it starts, and the example programs, on one CUDA card.

    python3 chip_smoke.py [--profile]
    python3 chip_smoke.py --anchor-seeds N
    python3 chip_smoke.py --scorers-only
    python3 chip_smoke.py --encoder-only
    python3 chip_smoke.py --dist-only
    python3 chip_smoke.py --examples-only

Phases (any failure exits non-zero before the last line is printed):

1. device: requires CUDA, prints the card's name and power limit;
2. build: compiles the five kernel sources of
   ``ranking_tpu_torch/ops/cuda/csrc`` side by side (the sort, the fused
   masked-BN tower's forward and its backward, the fused pairwise sums, the
   row scatter); prints the HGMMA (``wgmma``) instructions of the two fused
   tower libraries, which must not be 0, and their registers and spills;
3. kernel vs plain: the CUDA sort against ``sorted_values_and_ranks_reference``
   on the card, required bitwise equal (ranks and sorted values), at the
   flagship shape (B=128, L=200, K=2, topn 1/5/10/200), with score ties,
   an all-invalid row and -inf scores, L=37, L at the top of the kernel's
   domain, B=1, and B=1,024 lists of tied labels with K = 1 (phase 21's
   Gumbel ideal-DCG sort); and at L = 1, 31, 32, 33, 257 with K = 1 and 3 and topn
   1 and L, with ties, -0.0 beside +0.0, -inf scores and an all-invalid
   row (the edges of the kernel's keys and of its threads per item). Then
   the five fused masked-BN functions (``ops/cuda/fused_bn.py``) against
   their plain versions at the flagship widths 136-1024-512-256, in
   float32 and bfloat16, at N=25600 and N=700
   with a ragged mask, at N=700 with an all-ones and an all-zero mask, and
   at the tile edges of ``FUSED_EDGE_CASES`` (tolerances at ``FUSED_TOL``:
   these are sums over up to 25600 rows in another order, so bitwise
   equality is not expected; two calls on the same inputs must be bitwise
   equal), and the whole
   ``fused_bn_mlp`` (outputs, means, vars, all gradients) against autograd
   through ``reference_bn_mlp`` on the card and in float64 on the CPU.
   Then the fused pairwise sums (``ops/cuda/pairwise.py``), forward and
   backward, against their plain versions: the three loss types x the five
   lambda modes at B=128, L=200 with ragged lists, graded labels and item
   weights, and the edges listed at ``_pairwise_cases``, among them ranks
   that are not whole numbers in [1, L] (the kernels' per-pair formula), a
   list of one item, lists at the edges of the host's row tiles, the
   longest list with discount tables and the shortest without, and phase
   21's B = 1,024 Gumbel-sampled lists of L = 200 (one row tile a list)
   under the Yeti DCG weight and three other recipes (the count of
   non-zero pair weights must be equal, the sums and ``dlogits`` within
   ``PAIR_TOL`` of the output's largest value); and the whole
   ``PairwiseLogisticLoss`` with the NDCG lambda weight against autograd
   through the ``[B, L, L]`` path on the card and against float64 on the
   CPU. Then the row scatter (``ops/cuda/rows.py``, rows 9-10) against its
   plain versions, bitwise on the whole tables: a [3M, 128] float32 table
   at K=51200 with invalid slots and ids < 0 and >= V at n = 1, 2, 3; D=20
   and D=64 float32 and D=20 bfloat16; all slots invalid; K=1; K=51203;
   K=V=4099 at D=37; rows that no valid slot names keep their bits; the
   multi wrapper's ValueErrors;
4. main path: the flagship model (RankingModel(DNNScorer(1024-512-256),
   'log1p') over 136 float features, random weights and running
   statistics from a seeded ``torch.Generator``) answers
   ``Predictor.score_batch`` requests at B=1/7/128, L=200, checked against a
   float64 CPU recompute (rtol 1e-4, atol 1e-4 of the largest score; TF32
   off), then ``evaluate_dataset`` runs NDCG@1/5/10/full + MRR over flat-fed
   flagship batches through the graphed eval step (one eager step, one
   capture, 3 replays); the sort kernel's launches in this phase are
   counted, as the wrapper counts them (the eager step and the capture) and
   on the card by ``torch.profiler`` (the eager step and the replays), which
   must equal the eager step's plus the capture's times the replays;
5. eval checks: the same evaluation with the plain sort on the card agrees
   within 1e-6, and ``make_eval_step(num_valid_rows=...)`` on a batch padded
   with ``pad_to`` equals the unpadded batch's metrics within 1e-6;
6. times after warm-up: the kernel, its plain version and ``torch.sort`` +
   ``gather`` per call, as device time (CUDA events around replays of a
   CUDA graph of 20 calls) and as eager time (CUDA events around 100
   calls, host overhead included); the eval step, its forward and a B=128
   serve request (median host clock around a synchronize);
7. training main path: the flagship model in train mode (dropout 0,
   ``input_grad=False``, batch norm, float32, 'log1p'), ``softmax_loss``, Adam
   1e-3, 8 steps of ``make_train_step`` on a repeated flat-fed batch. The
   first step's loss, gradients and running statistics are held against
   the same step with the plain versions forced on the card; the loss must
   be finite at every step and lower after 8; the launches per step must be
   3 / 1 / 2 / 0 / 0 for the five functions; the trained model is then
   evaluated through the eval path;
8. second path: a one-hidden-layer tower (136 -> 1024) whose input needs a
   gradient, one forward and backward at N=25600: ``dx0`` and ``dW0``
   against the plain versions, one launch each of the two first-layer
   functions;
9. times of the fused functions (device time from CUDA graph replays, each
   beside its plain version, its bound on the tensor cores and on the
   float32 pipes, and its bare products through ``torch.mm``) and of a
   train step (host clock and CUDA events), beside the same step with the
   fused switch off;
10. LambdaRank training main path: the same model and step with
   ``pairwise_logistic_loss`` and the NDCG lambda weight, 8 steps with no
   generator. The first step is held against the plain versions as in
   phase 7; launches per step must be 1 / 1 for the two pairwise functions,
   3 / 1 / 2 / 0 / 0 for the fused BN functions and 1 for the sort kernel
   (the ideal DCG). Then one step each of ``pairwise_hinge_loss`` with
   the label-difference weight, ``pairwise_soft_zero_one_loss`` with none,
   and ``pairwise_logistic_loss`` with the V2 NDCG weight at topn 10 and a
   seeded generator (shuffled rank ties); the trained model is evaluated;
11. long lists: one train step at B=16, L=1024 without batch norm, with the
   pairwise kernels and with the switch off: gradients compared, peak
   device memory of each;
12. times of the pairwise functions at B128xL200 and B16xL1024 for no
   lambda weight and for the NDCG weight (device time from CUDA graph
   replays, beside the plain version and the bound), and of the LambdaRank
   train step with the pairwise switch on and off;
13. sparse main path, recipe A: ``RankingModel(EmbeddingDNNScorer(256-128))``
   over two [3M, 128] float32 tables (random, from the seed), B=128 lists
   of L=50 documents of T=8 token ids (ragged lists, 1/8 of the token slots
   padding, ids uniform over the vocabulary), fed flat; ``softmax_loss``,
   ``LazyAdam(1e-3)`` for the tables and ``adam(1e-3)`` for
   the tower; 8 steps of ``make_sparse_train_step`` on a repeated batch.
   The first step's ``update_rows`` is applied to two clones of the state,
   kernel and plain scatter, bitwise; the whole first step is held against
   a twin's step through the plain scatter (slot ids, flags and touched
   rows equal, the rest within ``SPARSE_TOL``); rows no step touched keep
   their bits in the tables and moments; the loss is
   finite and lower after 8 steps; row 10 launches exactly twice a step
   (n=3), row 9 never, no other kernel; peak device memory;
14. recipe B: the same with ``LazyAdagrad`` and the port's ``adagrad``
   (held against its float64 recomputation on the card), 4 steps, row 10
   twice a step with n=2;
15. times: rows 9-10 at the flagship table and K=51200 (device time from
   CUDA graph replays, beside the plain version, one ``index_copy_`` a
   table and the bound; row 9 and ``index_copy_`` also in 5 alternating
   repetitions, with the median ratio), the sparse step with the rows
   switch on and off, and ``compact_unique``;
16. K steps a dispatch (``make_multi_step``: one train step captured in a
   CUDA graph and replayed, K = 10) for the softmax, LambdaRank and sparse
   recipe A steps at their full shapes, and for the softmax step under a
   warmup + linear-decay schedule with global-norm clipping and under a
   constant rate with clipping that is scaled by 0.1 between two
   dispatches (the plateau hook): after a first dispatch (warm-up and
   capture), 10 replays on the state and 10 eager steps on a copy of it
   must be bitwise equal (parameters, buffers, moments, step tensors, the
   rate and count, tables and their moments, per-step losses), or, where
   two eager runs already differ, within ``SPARSE_TOL``; the rate must have
   moved (schedule) or be the scaled one (plateau), and the clip must have
   bound the gradients. For the three plain recipes the port's kernels
   that one replay runs (``torch.profiler``'s names) must equal one eager
   step's, and the launches recorded at capture the per-step counts above;
   ms a step by CUDA events with and without the graph, host ms a
   dispatch, the device's idle share;
17. the pipeline: MSLR-shaped LIBSVM files written from the seed
   (``PIPE_*``), parsed by the native parser, and
   ``SimplePipeline.train_and_validate`` on the flagship model at
   B128xL200 with ``steps_per_execution`` 10 for 2 epochs of 50 steps,
   then a new pipeline resumed from its checkpoint to 3 (``resume_dataset``)
   under ``torch.profiler``: one capture a run, each wrapper's own kernel
   on the card in the resumed run as often as its eager calls plus its
   captured launches times the replays (of the train graph and of the
   eval step's graph), finite metrics,
   ``metrics.jsonl``, event files, checkpoints and ``export/latest``, whose
   params reload into a ``Predictor`` that scores bitwise as the trained
   model; steady-state lists/s (CUDA events around the first run's
   dispatches that only replay, per epoch window and over the dispatches
   alone) beside the whole first run's, the eval's ms through the graphed
   step and through the eager step it captured, in the same run (equal
   metrics; one call each, then medians of 5 interleaved; the timed evals
   must replay without a capture), and (median of 5,
   apart: the validation feed, the graphed steps on batches already on the
   card, the device's time) and the parser's MB/s;
18. the ELWC path: ELWC TFRecords of the flagship shape written from the
   seed with the port's encoder (1,280 train lists in 4 files, 256
   validation lists); the native decoder held bit for bit against the
   plain parser (``data/proto.py``) on 64 records, their list sizes, 64
   tf.Examples and 64 token records hashed and through a vocabulary, and
   against the arrays the writer drew; the loader's own lists/s (no
   device) decoding, building and reading the epoch cache;
   ``SimplePipeline.train_and_validate`` over ``SimpleDatasetBuilder``
   (``engine='native_loader'``) on the flagship recipe at K = 10: run D, one
   epoch of 50 steps with the epoch cache off (every batch decoded), and
   run C, 2 epochs with the cache on, each timed as in phase 17; run C
   resumed to 3 epochs through the builder's ``skip_batches`` under
   ``torch.profiler`` (one capture, rows 1-4 on the card as their wrappers
   recorded, finite metrics, every output); ``Predictor.from_export`` of
   the export: ``predict`` on 128 ELWCs of 20-200 documents -> [128, 256]
   equal to ``score_batch`` within phase 4's tolerance, ``regress`` on 128
   tf.Examples equal to ``predict`` on the same documents as lists of one,
   and the parse ms and device ms of a B=128 request; and phase 13's
   sparse workload fed as ELWC of hashed string tokens through the same
   builder, 20 steps with ``lazy_adam`` at K = 10, row 10 counted on the
   card;
19. evaluation and the serving artifact, on the flagship model and phase
   4's batches: (a) the reference's whole suite (``_suite_fns``: the 13
   keys, the diversity metrics over synthetic subtopics of the labels) and
   the validation loss through ``make_eval_step`` and ``GraphedEvalStep``
   over the 4 batches and a fifth padded one (``num_valid_rows`` 100),
   twice: graphed == eager bit for bit (states, ``val_loss``, logits); the
   eager card metrics == the plain path on the CPU on the same logits
   (``METRIC_TOL``); row 1 on the card in one replay (``torch.profiler``)
   == what the capture recorded == an eager step's launches; how many of
   the suite's sorts take the kernel; the step's device ms, operations,
   host ms and idle share, eager and graphed. (b) ``evaluate_dataset``
   with a query id (two lists a query, one split across each pair of
   batches), 12 aggregated metrics and a predictions CSV: the card ==
   the plain path on the same logits (metrics to ``METRIC_TOL``, CSV rows
   equal), and the CPU forward's CSV == the card's (ids and labels equal,
   scores to phase 4's tolerance; its metrics checked too when it orders
   every list as the card). (c) ``trec.evaluate_run`` over qrels of 2,000
   queries of 20-200 judged documents and a run that drops and adds
   documents, written from the seed: card == CPU to ``METRIC_TOL``; ms a
   query. (d) ``export_predictor`` of the flagship model on the CPU,
   float32 and int8, buckets 1 and 256; ``load_predictor(device='cuda')``
   in a fresh process that cannot import ``ranking_tpu_torch.models``
   serves 128 ELWCs of 20-200 documents: float32 == the live
   ``Predictor.predict`` within phase 4's tolerance, int8 within
   ``INT8_TOL`` of float32, a list's top document changed only where two
   float scores are within ``INT8_SWAP_GAP`` of the largest, in at most
   ``INT8_MAX_SWAPS`` lists,
   ``regress`` == ``predict`` on lists of one; ``params.npz`` sizes,
   parse ms and device ms of the request;
20. with ``--profile`` only: every kernel's registers and spills from
   ``ptxas -v``, and ``torch.profiler``'s device time, operation count and
   busiest kernels of one eval step, one B=128 serve request and one train
   step of each loss and of the sparse step;
21. the rest of the loss zoo and multi-task training (run after phase 19):
   (a) for softmax and each of the 20 other keys (``ZOO_KEYS``; heads of
   ``ZOO_HEADS`` units, binary click labels for ``ZOO_BINARY``), the
   flagship train step (phase 7's recipe, fused tower, Adam 1e-3): the
   loss and its logit gradient on the card against a float64 recompute on
   the CPU of the same logits (``ZOO_VALUE_TOL``, ``ZOO_GRAD_TOL``), the
   first step against the same step with rows 1-8 switched off (as phases
   7 and 10; a step outside OP_TOL is held, with rows 1 and 7-8 alone, and
   against float64 steps of each float32 step's own ReLU gates and loss
   gradient to ``ANCHOR_TOL``), then K = 10 graph replays timed by CUDA
   events, with the
   peak device memory and the launches a step that the capture recorded;
   row 1 on the card by ``torch.profiler`` in one step of
   ``ZOO_SORT_KEYS`` (equal to the wrapper's count and the capture's);
   (b) 10 replays == 10 eager steps bit for bit for Gumbel approx NDCG and
   ListMLE with a CUDA generator and approx NDCG without one; (c) over
   ELWC files in phase 18's shape that also carry a click a document,
   ``SimplePipeline.train_and_validate`` with ``loss='approx_ndcg_loss'``
   (the scale-invariant recipe), one epoch at K = 10: lists/s over the
   replay-only window, then a second run under ``torch.profiler`` whose
   kernels on the card equal the wrappers' eager calls plus captured x
   replays; (d) ``MultiTaskPipeline`` over ``MultiLabelDatasetBuilder``
   with ``MultiTaskScorer(('relevance', 'click'), body=DNNScorer(
   1024-512-256, output_units=2))``, softmax and sigmoid cross-entropy
   weighted 1 and 0.3, one epoch at K = 10: one capture, the
   ``task/ndcg@k`` suite, and the pipeline's graphed eval == the eager
   step it wraps bit for bit, its history == the eager results.

22. the other scorers at their examples' widths (GAM, groupwise, DIN),
   ``Bilinear`` and the dense-gradient lazy update, then the fused rows'
   and rows 7-8's times at their shapes;
23. the transformer encoder family at the repo's BERT-base profile
   (benchmarks/encoder_profile.py:27-30: vocabulary 30,522, hidden 768, 4
   layers, 12 heads, mlp 3,072; 512 positions, 2 segment types, dropout
   0.1) in ``EncoderScorer``, B = 8 lists x L = 8 documents x T = 128
   tokens, softmax, Adam 1e-3, float32: (a) the eval forward against a
   float64 recompute on the CPU (phase 4's tolerance), the first step at
   dropout 0 against the same step in float64 (loss and every gradient to
   ``ANCHOR_TOL``), 10 graph replays == 10 eager steps bitwise at dropout
   0.1 with a CUDA generator, ms a step graph and eager, TFLOP/s; (b)
   ``remat=True`` == ``remat=False`` bitwise over two steps, the peak
   memory of each; (c) the sparse token step (``LazyAdam`` on
   ``token_embed/embedding``) against the dense-gradient lazy step within
   ``SPARSE_TOL``, untouched rows kept, row 10 once a step eager and in
   the graph, and row 10 against its plain version bitwise at [30522,
   768] x 3 on the step's own ids, with its time, bound and
   ``index_copy_``'s; (d) ``SimplePipeline.train_and_validate`` over ELWC
   files in TFRBertDataLoader's format (640 train, 128 validation lists),
   one epoch of 80 steps at K = 10: one capture, lists/s over the
   replay-only window, then its graphed eval == the eager step bitwise
   under ``torch.profiler``, whose row 1 on the card equals the wrapper's
   record; (e) the trained model exported on the CPU,
   float32 and int8, served on the card: float32 == the live
   ``Predictor.predict`` at phase 4's tolerance, int8 within ``INT8_TOL``;
   (f) ``warm_start_from`` of a second seed's flax-path parameters,
   overlaid bitwise, and ``strict=True`` refusing an unused entry.

24. distribution (``parallel/``), each sub-phase from counts of 0: (a) a
   world of one over NCCL in this process at the flagship: the distributed
   step (every collective called) == phase 7's one-card step bitwise over
   3 steps, 10 graph replays with the NCCL collectives captured == 10
   eager steps bitwise, and the graphed eval step with its gather == the
   eager one; then two rank processes (``_dist_rank``), which share the one
   card over gloo (NCCL refuses two ranks on one card; where the machine
   shows two cards, 24b also runs over NCCL across them): (b) ``data=2``
   at the flagship, 64 + 64 rows, 3 steps (the third with unequal valid
   counts on the ranks), each step held against the one-card step from
   the rank's own state (``_hold_data_parallel``), and the eval of a
   padded batch; (c) the sparse step's two 3M x 128 tables over
   ``model=2``: untouched rows bitwise on each rank, touched rows and
   moments within ``SPARSE_TOL`` of the one-card step, row 10 on each
   rank's shard; (d) the list-sharded pairwise loss at B16 x L4096 against
   rows 7-8 on one card (``LS_LOSS_TOL``, ``PAIR_TOL``), each rank's peak
   memory beside the one card's; (e) phase 23's BERT-base profile over
   ``model=2`` under ``ENCODER_TP_RULES``, one step at dropout 0.1 against
   the one-card step (``ANCHOR_TOL`` of each gradient's largest entry);
   (f) the ELWC CLI (``ranking_tpu_torch/examples/ranking_elwc_pipeline.py``)
   on the two ranks with ``--mesh_model=2``: its checkpoint restores on one
   card bitwise its export, which scores as the live model (``SPARSE_TOL``).
   Times here are a correctness run's over gloo, not the card's
   collectives'.

25. the example programs (``ranking_tpu_torch/examples/``), each through
   its ``main`` as a user runs it, counts from 0: (a) ``ranking_libsvm``
   over phase 17's LIBSVM files at 136 -> 1024-512-256, B128 x L200,
   ``--dropout=0 --lambda_ndcg``, 20 steps and one evaluation: rows 2-4
   3 / 1 / 2, rows 5-6 0, rows 7-8 1 / 1 and row 1 the same count each step,
   row 1 alone in the evaluation, by the wrappers and again by
   ``torch.profiler`` in a second run; the first step against rows 1-8
   through their plain versions (``_hold_first_step``); the export reloaded
   scores as the live model bitwise; ms a step by CUDA events; then 10 steps
   each at the CLI's defaults, ``--scorer=gam`` and ``--group_size=2`` (the
   tower unfused at dropout 0.5). (b) ``trec_eval`` over phase 19's TREC
   files == ``trec.evaluate_run``, row 1 launched. (c) the ELWC CLI at its
   defaults over phase 18's token records, then ``serve_predict`` over its
   export with ``--artifact_path --quantize=int8``: the CSV's scores ==
   ``Predictor.predict`` at phase 4's tolerance, the int8 artifact within
   ``INT8_TOL``. (d) ``antique_din`` at its defaults and with ``--dasalc``
   and (e) ``multitask_ranking`` at its defaults over phase 22's DIN
   records: finite metrics, one capture a run, the graphed eval == eager
   (``_hold_graphed_eval``), the ``task/ndcg@k`` suite. (f)
   ``encoder_ranking`` at phase 23's BERT-base profile with ``--remat``,
   then ``--warm_start_dir`` of its export (the warm-started model == the
   export, bitwise) and ``--optimizer=lazy_adam`` (the dense-gradient lazy
   update, as the JAX pipeline takes it: the position table is a lazy table
   that no batch feature names).
   (g) ``unbiased_two_tower`` as the JAX package's test runs it (1,500
   queries, 400 steps, ``--list_size=15 --eta=1.5``): debiased true NDCG@5
   above the naive one by ``EX_DEBIAS_MARGIN``. Files under
   ``.scratch/chip_smoke_examples`` (deleted after).

With ``--anchor-seeds N`` the script builds the kernels (phases 1-2) and
then only runs phase 21a's first-step checks of every key, each with the
float64 steps of ``_hold_first_step``'s anchor whether or not it is needed,
for the default run's models and batches and N - 1 other seeds, and prints
one ``{"anchor_sweep": ...}`` line of the readings (also written to
``chiprun_out/anchor_sweep.json``). It exits non-zero if a
check failed on any seed.

With ``--scorers-only`` it builds the kernels and runs only phase 22 and
its timings, and prints (and writes to ``chiprun_out/scorers.json``) one
``{"scorers": ...}`` line; with ``--encoder-only`` the same for phase 23
(``chiprun_out/encoder.json``, one ``{"encoder": ...}`` line), and with
``--dist-only`` for phase 24 (``chiprun_out/dist.json``, ``{"dist": ...}``)
and ``--examples-only`` for phase 25 (``chiprun_out/examples.json``,
``{"examples": ...}``).

The log, its ``{"timings": ...}`` line and the ``{"kernels": [...]}`` line
also go to ``chiprun_out/chip_smoke.log``. Prints a ``{"timings": ...}``
line, the card line, a ``{"kernels": [...]}`` line (each kernel also with
its launches in phases 17, 18, 21, 22, 23, 24 and 25, as its wrapper counts them
and on the card in the profiled runs, and per replay of phase 16's
graphs), and last ``{"ok": true, "device": {...}}``.
"""

import contextlib
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from unittest import mock

SEED = 0
B, L, F = 128, 200, 136           # bench.py's MSLR-WEB30K flagship shape
HIDDEN = (1024, 512, 256)
EVAL_BATCHES = 4
# HBM rate of an H100 SXM (NVIDIA data sheet), for the kernel's bound.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12             # float32 outside the tensor cores
# TF32 on the tensor cores (NVIDIA data sheet, dense). A float32-accurate
# product takes three TF32 passes (split TF32), so the least time of the
# fused tower's products is their operations over a third of that rate.
TF32_OPS_PER_S = 495e12
SPLIT_TF32_OPS_PER_S = TF32_OPS_PER_S / 3
N_ROWS = B * L                    # 25600 documents in a flagship batch
TRAIN_STEPS = 8
# Largest |kernel - plain| allowed, as a share of the largest |plain| value
# of the same output. float32: both sides sum the same float32 products in
# another order (up to 25600 rows, 1024 terms). bfloat16: outputs stored as
# bf16 may differ by one bf16 ulp of the largest value (2^-8, rounded up to
# 2^-7); float32 sums of bf16-rounded operands see an operand rounded the
# other way now and then.
FUSED_TOL = {'float32': {'stored': 1e-5, 'summed': 1e-5},
             'bfloat16': {'stored': 2.0 ** -7, 'summed': 2e-3}}
# The whole op against autograd through another formulation of the same
# function: a handful of ReLU gates whose pre-activation is within rounding
# of 0 open on one side only, and each moves a gradient entry by one row's
# whole contribution. So the error is held in the Frobenius norm, and the
# largest single entry only loosely.
OP_TOL_NORM, OP_TOL_MAX = 2e-3, 5e-2
# A float32 first step against the float64 step of its own ReLU gates and
# loss gradient (``_hold_first_step``'s anchor), in the norm and at the
# largest entry: no gate differs, so only rounding remains, that of the
# fused functions held to FUSED_TOL (1e-5) each, chained over three
# layers forward and back; ten times FUSED_TOL. 63 readings (21 keys, 3
# seeds) measured 8.5e-6 at most on an H100.
ANCHOR_TOL = 1e-4
# The fused pairwise sums against their plain versions: the count of
# non-zero pair weights exactly; the two float sums and dlogits as a share
# of the output's largest value (float32 sums of up to L^2 terms in another
# order). The 46 cases of phase 3 measured 3.7e-7 at most on an H100.
PAIR_TOL = 2e-6
# Special-function results (exp, log, reciprocal) a second: 16 a clock a
# multiprocessor against 128 float32 lanes of 2 operations (NVIDIA's table
# of arithmetic instruction throughput for compute capability 9.0), so 1/16
# of the float32 rate.
SFU_OPS_PER_S = F32_OPS_PER_S / 16
LONG_B, LONG_L = 16, 1024         # benchmarks/pairwise_sweep.py: B * L = 16384
# The sparse step: benchmarks/sparse_op_profile.py:51-84 and PARITY.md:204,
# EmbeddingDNNScorer(256-128) over two 3M x 128 tables at B128 x L50 x T8.
SPARSE_B, SPARSE_L, SPARSE_T, SPARSE_MIN_LEN = 128, 50, 8, 20
SPARSE_VOCAB, SPARSE_DIM, SPARSE_HIDDEN = 3_000_000, 128, (256, 128)
SPARSE_STEPS = {'A': 8, 'B': 4}
ROWS_K = 51_200                   # rows a flagship scatter writes
# The sparse step with the kernel against the same step through the plain
# scatter, as a share of the largest value: the two steps differ only in
# which code copies the rows, but the slabs' backward may add a row's
# token contributions in another order from run to run.
SPARSE_TOL = 1e-5


def _fail(msg):
  raise SystemExit(f'chip_smoke: FAILED: {msg}')


_START = time.perf_counter()


# The run's log is also written to chiprun_out/chip_smoke.log: the end of
# the standard output alone does not hold a whole run's lines.
_LOG_FILE = None


def _log(msg):
  """A line of the run's log, after the seconds since the script started."""
  line = f'[{time.perf_counter() - _START:7.1f} s] {msg}'
  print(line, flush=True)
  if _LOG_FILE is not None:
    _LOG_FILE.write(line + '\n')
    _LOG_FILE.flush()


def _card_line():
  out = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, timeout=60, check=True).stdout
  return out.strip().splitlines()[0]


def _sass_count(path, opcode):
  """How many instructions of `opcode` the machine code of a built library
  holds (``cuobjdump -sass``, beside the ``nvcc`` that built it)."""
  import os
  from ranking_tpu_torch.ops.cuda import build
  tool = os.path.join(os.path.dirname(build.nvcc_path()), 'cuobjdump')
  sass = subprocess.run([tool, '-sass', path], capture_output=True,
                        text=True, timeout=300, check=True).stdout
  return sum(line.split()[1].startswith(opcode) for line in sass.splitlines()
             if '*/' in line and len(line.split()) > 1
             and line.split()[0].startswith('/*'))


def _ptxas_summary(path):
  """Registers and spills of each kernel of a built library, from the
  ``ptxas -v`` lines that the build keeps beside it."""
  with open(path + '.log') as f:
    lines = [line.strip() for line in f]
  regs = [line.split('Used ')[1].split(' registers')[0] for line in lines
          if 'Used' in line and 'registers' in line]
  spills = [line for line in lines if 'spill' in line
            and not line.startswith('0 bytes stack frame, 0 bytes spill')]
  return (f'{len(regs)} kernels, registers {"/".join(regs)}; '
          + ('; '.join(spills) if spills else 'no spills'))


def _event_ms(fn, iters, warmup=10):
  """Mean device time of one call, by CUDA events around ``iters`` calls."""
  import torch
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  stop = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(iters):
    fn()
  stop.record()
  torch.cuda.synchronize()
  return start.elapsed_time(stop) / iters


def _graph_ms(fn, calls=20, replays=20):
  """Device time of one call, free of host overhead: ``calls`` calls are
  captured in one CUDA graph, whose replays are timed by CUDA events."""
  import torch
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):  # capture wants its warm-up off the default stream
    for _ in range(3):
      fn()
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    for _ in range(calls):
      fn()
  return _event_ms(graph.replay, replays, warmup=2) / calls


def _profile(fn, calls=10):
  """Device work of one call of ``fn`` under ``torch.profiler``: its device
  time (kernels and copies, which run one after another on the one stream)
  and operation count, and the device time of each kernel name."""
  import collections
  import torch
  from torch.profiler import ProfilerActivity, profile
  for _ in range(3):
    fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    for _ in range(calls):
      fn()
    torch.cuda.synchronize()
  # Kernels and copies only: a user annotation (the optimizer's
  # `Optimizer.step#...` range) is placed on the device track too, over
  # the kernels it encloses, and would count them twice.
  device = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, 'is_user_annotation', False)]
  if not device:
    _fail('the profiler saw no device operation')
  per_name = collections.defaultdict(float)
  for e in device:  # names cut to 90 characters: C++ signatures run long
    per_name[e.name[:90]] += e.time_range.elapsed_us() / calls / 1e3
  # Host time by operation, the ten largest by self time a call.
  host = sorted(((e.key, e.self_cpu_time_total / calls / 1e3)
                 for e in prof.key_averages()), key=lambda kv: -kv[1])
  return {'device_ms': sum(per_name.values()),
          'device_ops': len(device) / calls,
          'by_name_ms': dict(sorted(per_name.items(), key=lambda kv: -kv[1])),
          'host_self_ms': dict(host[:10])}


def _host_ms(fn, iters, warmup=5):
  """Median host time of one call ending in a synchronize."""
  import torch
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  times = []
  for _ in range(iters):
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
  return statistics.median(times)


def _sort_case(gen, b, l, k, kind):
  """'random', 'ties', 'special' (an all-invalid row, -inf scores) or
  'edges' (all of them, and -0.0 beside +0.0)."""
  import torch
  if kind in ('ties', 'edges'):
    scores = torch.randint(-3, 4, (b, l), generator=gen).float()
  else:
    scores = torch.randn(b, l, generator=gen)
  mask = torch.rand(b, l, generator=gen) > 0.3
  if kind in ('special', 'edges'):
    mask[0] = False
    scores[1, :5] = -math.inf
    mask[1, :3] = True
  if kind == 'edges':
    scores[:, ::2] = torch.where(scores[:, ::2] == 0, -0.0, scores[:, ::2])
  values = torch.randn(b, l, k, generator=gen)
  return scores, mask, values


def _graded_labels(gen, b, l, min_len):
  """Ragged lists of graded 0-4 labels skewed to 0; -1 pads."""
  import torch
  lengths = torch.randint(min_len, l + 1, (b,), generator=gen)
  valid = torch.arange(l)[None, :] < lengths[:, None]
  grades = torch.multinomial(torch.tensor([.5, .3, .15, .04, .01]), b * l,
                             replacement=True, generator=gen).reshape(b, l)
  return torch.where(valid, grades.float(), -1.0), valid


def _make_batch(gen, b, *, min_len=20, l=L):
  """A flagship-shaped host batch: 136 heavy-tailed float features,
  graded 0-4 labels skewed to 0, ragged list lengths."""
  import torch
  from ranking_tpu_torch.data import batch as batch_lib
  labels, valid = _graded_labels(gen, b, l, min_len)
  features = torch.exp(2.0 * torch.randn(b, l, F, generator=gen))
  features *= torch.where(torch.rand(b, l, F, generator=gen) < 0.1, -1.0, 1.0)
  return batch_lib.RankingBatch(context={}, examples={'features': features},
                                labels=labels, mask=valid)


def _flagship_model(gen):
  import torch
  from ranking_tpu_torch.models import scorers
  model = scorers.RankingModel(
      scorers.DNNScorer(HIDDEN, in_features=F, generator=gen),
      transform_name='log1p')
  with torch.no_grad():  # non-trivial BN parameters and running statistics
    for bn in model.scorer.tower.bn:
      n = bn.num_features
      bn.weight.copy_(1.0 + 0.1 * torch.randn(n, generator=gen))
      bn.bias.copy_(0.1 * torch.randn(n, generator=gen))
      bn.running_mean.copy_(0.5 * torch.randn(n, generator=gen))
      bn.running_var.copy_(torch.rand(n, generator=gen) * 1.5 + 0.5)
  return model


def _scores_f64(model, batch):
  """Float64 CPU recompute of the flagship model's eval forward."""
  import torch
  import torch.nn.functional as nnf
  from ranking_tpu_torch.models import layers
  tower = model.scorer.tower
  d = lambda t: t.detach().to('cpu', torch.float64)  # noqa: E731
  x = d(batch.examples['features'])
  h = (torch.sign(x) * torch.log1p(torch.abs(x))).reshape(-1, F)
  for layer, bn in zip(tower.dense[:-1], tower.bn):
    h = nnf.linear(h, d(layer.weight), d(layer.bias))
    h = ((h - d(bn.running_mean)) / torch.sqrt(d(bn.running_var) + bn.eps)
         * d(bn.weight) + d(bn.bias))
    h = torch.relu(h)
  h = nnf.linear(h, d(tower.dense[-1].weight), d(tower.dense[-1].bias))
  return torch.where(batch.mask, h.reshape(batch.mask.shape),
                     layers.PADDING_LOGIT)


def _metric_fns():
  from ranking_tpu_torch.ops import metric_registry
  fns = dict(metric_registry.default_metric_fns())
  fns['metric/mrr'] = metric_registry.make_ranking_metric_fn(
      metric_registry.RankingMetricKey.MRR)
  return fns


def _rel_err(got, want):
  """(largest |got - want|, that as a share of the largest |want|)."""
  import torch
  got, want = got.to(torch.float32), want.to(torch.float32)
  if got.shape != want.shape:
    _fail(f'shape {tuple(got.shape)} != {tuple(want.shape)}')
  err = (got - want).abs().nan_to_num(nan=math.inf).max().item()
  return err, err / max(want.abs().max().item(), 1e-30)


def _fused_case(gen, n, mask_kind, act, dims=(F,) + HIDDEN):
  """Inputs of every fused function at one tower shape: a seeded tower and
  batch, the hidden activations and folds of a forward chain (through the
  plain versions) and random cotangents of the right scale."""
  import torch
  from ranking_tpu_torch.ops.cuda import fused_bn
  dev = torch.device('cuda')
  rnd = lambda *shape, scale=1.0: (  # noqa: E731
      torch.randn(*shape, generator=gen) * scale).to(dev)
  x = rnd(n, dims[0])
  mask = {'ragged': (torch.rand(n, generator=gen) > 0.3).float(),
          'ones': torch.ones(n), 'zeros': torch.zeros(n)}[mask_kind].to(dev)
  count = mask.sum().clamp(min=1.0)
  layers = []
  h, relu_in = x, False
  s_in = torch.ones(dims[0], device=dev)
  t_in = torch.zeros(dims[0], device=dev)
  with fused_bn.plain_versions():
    for f_in, f_out in zip(dims[:-1], dims[1:]):
      w = rnd(f_out, f_in, scale=f_in ** -0.5)
      b, gamma, beta = rnd(f_out, scale=.1), 1 + rnd(f_out, scale=.1), \
          rnd(f_out, scale=.1)
      y, col_sum, col_ssq = fused_bn.layer_forward(
          h, mask, s_in, t_in, w.t(), b, relu_in=relu_in, act_dtype=act)
      fold = fused_bn._bn_fold(col_sum, col_ssq, gamma, beta, count, 1e-5)
      g = rnd(n, f_out).to(act)
      s1, s2 = fused_bn.bwd_stats(g, y, fold[3], fold[4])
      _, _, c1, c2, _ = fused_bn._layer_consts(fold, s1, s2, col_sum, count)
      layers.append(dict(x_in=h, s_in=s_in, t_in=t_in, relu_in=relu_in, w=w,
                         b=b, y=y, s=fold[3], t=fold[4], g=g, c1=c1, c2=c2))
      h, s_in, t_in, relu_in = y, fold[3], fold[4], True
  return dict(x=x, mask=mask, layers=layers, act=act)


def _fused_calls(case, w_contiguous=False):
  """{row name: [(shape label, fn)]}: every call a train step makes of rows
  2-4 at this case's shapes, and the calls of rows 5 and 6 at layer 0's.
  W goes in as the tower passes it (the parameter's transposed view) or,
  with ``w_contiguous``, as a contiguous [F_in, F_out] copy."""
  from ranking_tpu_torch.ops.cuda import fused_bn
  x, mask, act = case['x'], case['mask'], case['act']
  ls = [dict(l, w=l['w'].t().contiguous().t()) if w_contiguous else l
        for l in case['layers']]
  top = len(ls) - 1

  def label(l):
    return f"{ls[l]['w'].shape[1]}->{ls[l]['w'].shape[0]}"

  def fwd(l):
    a = ls[l]
    return lambda: fused_bn.layer_forward(
        a['x_in'], mask, a['s_in'], a['t_in'], a['w'].t(), a['b'],
        relu_in=a['relu_in'], act_dtype=act)

  def mats(l, fold):
    a = ls[l]
    return lambda: fused_bn.bwd_mats(
        a['g'], a['y'], mask, a['s'], a['t'], a['c1'], a['c2'], a['x_in'],
        a['s_in'], a['t_in'], a['w'].t(), relu_in=True, emit_prev_stats=True,
        x0=x if fold else None, emit_dx=not fold)

  a0, at = ls[0], ls[top]
  return {
      'layer_forward': [(label(l), fwd(l)) for l in range(len(ls))],
      'bwd_stats': [(str(at['y'].shape[1]), lambda: fused_bn.bwd_stats(
          at['g'], at['y'], at['s'], at['t']))],
      'bwd_mats': [(label(l) + (' +fold' if l == 1 else ''), mats(l, l == 1))
                   for l in range(top, 0, -1)],
      'bwd_dx_only': [(label(0), lambda: fused_bn.bwd_dx_only(
          a0['g'], a0['y'], mask, a0['s'], a0['t'], a0['c1'], a0['c2'],
          a0['w'].t()))],
      'bwd_dw_only': [(label(0), lambda: fused_bn.bwd_dw_only(
          a0['g'], a0['y'], mask, a0['s'], a0['t'], a0['c1'], a0['c2'],
          a0['x_in'], a0['s_in'], a0['t_in'], relu_in=False))],
  }


def _fused_bounds(n=N_ROWS, dims=(F,) + HIDDEN):
  """{row name: [(bound_ms, bound_by, f32_pipe_ms)]} for the float32 calls
  of ``_fused_calls``: each input read once and each output written once
  over the HBM rate, against the products' operations over the rate of
  float32-accurate work on the tensor cores (three TF32 passes); beside it
  the larger of bytes and the same operations over the float32 pipes. Row
  3 does no product: its operations count at the float32 rate."""
  size = 4  # bytes of a stored activation

  def bound(byte_count, op_count, rate=SPLIT_TF32_OPS_PER_S):
    bytes_ms = byte_count / HBM_BYTES_PER_S * 1e3
    ms, by = max((bytes_ms, 'bytes'), (op_count / rate * 1e3, 'operations'))
    return ms, by, max(bytes_ms, op_count / F32_OPS_PER_S * 1e3)

  f0 = dims[0]
  out = {'layer_forward': [], 'bwd_mats': []}
  for f_in, f_out in zip(dims[:-1], dims[1:]):
    out['layer_forward'].append(bound(
        n * f_in * size + n * 4 + 4 * (2 * f_in + f_in * f_out + f_out)
        + n * f_out * size + 8 * f_out, 2 * n * f_in * f_out))
  top = len(dims) - 2
  f_top = dims[-1]
  out['bwd_stats'] = [bound(2 * n * f_top * size + 16 * f_top,
                            4 * n * f_top, F32_OPS_PER_S)]
  for l in range(top, 0, -1):
    f_in, f_out = dims[l], dims[l + 1]
    fold = l == 1
    byte_count = (2 * n * f_out * size + n * 4 + 16 * f_out
                  + n * f_in * size + 8 * f_in + 4 * f_in * f_out  # inputs
                  + 4 * f_in * f_out + 8 * f_in)                   # dW, s1, s2
    op_count = 4 * n * f_in * f_out
    if fold:
      byte_count += n * f0 * 4 + 2 * 4 * f0 * f_in   # x0 in; A, B out
      op_count += 4 * n * f0 * f_in
    else:
      byte_count += n * f_in * size                  # dx out
    out['bwd_mats'].append(bound(byte_count, op_count))
  f1 = dims[1]
  out['bwd_dx_only'] = [bound(2 * n * f1 * size + n * 4 + 16 * f1
                              + 4 * f0 * f1 + n * f0 * 4, 2 * n * f0 * f1)]
  out['bwd_dw_only'] = [bound(2 * n * f1 * size + n * 4 + 16 * f1
                              + n * f0 * 4 + 8 * f0 + 4 * f0 * f1,
                              2 * n * f0 * f1)]
  return out


# Phase 3's tower shapes beyond the flagship's: N off the 128-row tile
# (25601, 700, 6401), an output of 264 (two tiles and 8) and of 8,
# unaligned widths (129, 130: rows not 16-byte aligned; 129 columns take
# the 136-wide tile; 100), an input of 272, and W as a contiguous
# [F_in, F_out] as well as the parameter's transposed view. (label, N,
# dims, W contiguous)
FUSED_EDGE_CASES = (
    ('N=25601 136-264-8', 25601, (136, 264, 8), False),
    ('N=700 129-130-136-8', 700, (129, 130, 136, 8), False),
    ('N=700 136-264-8, W contiguous', 700, (136, 264, 8), True),
    (f'N={N_ROWS} flagship, W contiguous', N_ROWS, (F,) + HIDDEN, True),
    # Phase 22's towers: the groupwise scorer's (g = 2 windows of F
    # features, 272 wide, over the flagship's rows) and DIN's (the
    # attention's 100 wide), each also at an unaligned N.
    (f'N={N_ROWS} groupwise 272-256-128-64', N_ROWS, (2 * F, 256, 128, 64),
     False),
    ('N=25601 groupwise 272-256-128-64', 25601, (2 * F, 256, 128, 64),
     False),
    (f'N={N_ROWS} DIN 100-512-256-128', N_ROWS, (100, 512, 256, 128),
     False),
    ('N=6401 DIN 100-512-256-128', 6401, (100, 512, 256, 128), False))


def _check_fused_kernels(gen):
  """Phase 3b: each fused function against its plain version, and two
  calls on the same inputs bitwise equal. Returns {row name: {'float32':
  (max abs, max rel), 'bfloat16': ...}}."""
  import torch
  from ranking_tpu_torch.ops.cuda import fused_bn
  # Which outputs are stored in the activation type (the rest are float32
  # sums).
  stored = {'layer_forward': (0,), 'bwd_stats': (), 'bwd_mats': (0,),
            'bwd_dx_only': (), 'bwd_dw_only': ()}
  worst = {}
  edge_gen = torch.Generator().manual_seed(SEED + 2)
  for act in (torch.float32, torch.bfloat16):
    name = str(act).split('.')[-1]
    # The edge cases draw from their own generator, so that they leave the
    # inputs of every later phase as they were without them.
    cases = [(f'N={n}, {mask_kind} mask', gen, n, mask_kind, (F,) + HIDDEN,
              False)
             for n, mask_kind in ((N_ROWS, 'ragged'), (700, 'ragged'),
                                  (700, 'ones'), (700, 'zeros'))]
    cases += [(label, edge_gen, n, 'ragged', dims, w_contiguous)
              for label, n, dims, w_contiguous in FUSED_EDGE_CASES]
    for label, case_gen, n, mask_kind, dims, w_contiguous in cases:
      case = _fused_case(case_gen, n, mask_kind, act, dims)
      for row, calls in _fused_calls(case, w_contiguous).items():
        for shape, fn in calls:
          got = fn()
          again = fn()
          with fused_bn.plain_versions():
            want = fn()
          torch.cuda.synchronize()
          got, again, want = ((o,) if isinstance(o, torch.Tensor) else o
                              for o in (got, again, want))
          for i, (g, a, w) in enumerate(zip(got, again, want)):
            if (g is None) != (w is None):
              _fail(f'{row} {shape}: output {i} missing on one side')
            if g is None:
              continue
            if not torch.equal(g, a):
              _fail(f'{row} {shape} {name} {label}: output {i} differs '
                    'between two calls on the same inputs')
            err, rel = _rel_err(g, w)
            tol = FUSED_TOL[name]['stored' if i in stored[row] else 'summed']
            if not rel <= tol:
              _fail(f'{row} {shape} {name} {label}: output {i} differs from '
                    f'the plain version by {err} ({rel:.3g} of its largest '
                    f'value; allowed {tol:.3g})')
            old = worst.setdefault(row, {}).get(name, (0.0, 0.0))
            worst[row][name] = (max(old[0], err), max(old[1], rel))
      _log(f'kernel vs plain: fused BN rows 2-6, {name}, {label}: within '
           'tolerance, two calls bitwise equal')
  return worst


def _check_fused_op(gen):
  """Phase 3c: fused_bn_mlp at the flagship shape against autograd through
  reference_bn_mlp, on the card in float32 and on the CPU in float64."""
  import torch
  from ranking_tpu_torch.ops.cuda import fused_bn
  dev = torch.device('cuda')
  dims = (F,) + HIDDEN
  x = torch.randn(N_ROWS, F, generator=gen)
  mask = (torch.rand(N_ROWS, generator=gen) > 0.3).float()
  cot = torch.randn(N_ROWS, HIDDEN[-1], generator=gen)
  params = [[torch.randn(o, i, generator=gen) * i ** -0.5
             for i, o in zip(dims[:-1], dims[1:])],
            [0.1 * torch.randn(o, generator=gen) for o in HIDDEN],
            [1 + 0.1 * torch.randn(o, generator=gen) for o in HIDDEN],
            [0.1 * torch.randn(o, generator=gen) for o in HIDDEN]]

  def run(fn, device, dtype):
    leaves = [[p.to(device, dtype).requires_grad_() for p in group]
              for group in params]
    xd = x.to(device, dtype).requires_grad_()
    out, means, vars_ = fn(xd, mask.to(device), *leaves)
    flat = [xd] + [p for group in leaves for p in group]
    grads = torch.autograd.grad((out * cot.to(device, dtype)).sum(), flat)
    return [t.detach().to('cpu', torch.float64)
            for t in (out, *means, *vars_, *grads)]

  got = run(lambda *a: fused_bn.fused_bn_mlp(*a, input_grad=True), dev,
            torch.float32)
  refs = {
      'autograd on the card': run(
          lambda xd, m, *p: fused_bn.reference_bn_mlp(xd, *p, mask=m), dev,
          torch.float32),
      'float64 on the CPU': run(
          lambda xd, m, *p: fused_bn.reference_bn_mlp(xd, *p, mask=m), 'cpu',
          torch.float64)}
  n_fwd = 1 + 2 * len(HIDDEN)
  for name, want in refs.items():
    worst_fwd = worst_norm = worst_max = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
      scale = max(w.abs().max().item(), 1e-30)
      err = (g - w).abs().max().item() / scale
      if i < n_fwd:
        worst_fwd = max(worst_fwd, err)
        continue
      if scale < 1e-2:  # bias gradients: exactly 0 in theory, noise here
        if (g - w).abs().max().item() > 1e-2:
          _fail(f'fused op vs {name}: a zero gradient is off by more than '
                '1e-2')
        continue
      worst_norm = max(worst_norm, ((g - w).norm() / w.norm()).item())
      worst_max = max(worst_max, err)
    if not (worst_fwd <= 1e-4 and worst_norm <= OP_TOL_NORM
            and worst_max <= OP_TOL_MAX):
      _fail(f'fused op vs {name}: outputs off by {worst_fwd:.3g} (allowed '
            f'1e-4), gradients by {worst_norm:.3g} in norm (allowed '
            f'{OP_TOL_NORM}) and {worst_max:.3g} at most (allowed '
            f'{OP_TOL_MAX})')
    _log(f'fused op vs {name}: outputs within {worst_fwd:.3g}, gradients '
         f'within {worst_norm:.3g} in norm, {worst_max:.3g} at most')


def _train_model(gen, hidden=HIDDEN, use_batch_norm=True, output_units=1):
  from ranking_tpu_torch.models import scorers
  return scorers.RankingModel(
      scorers.DNNScorer(hidden, in_features=F, dropout=0.0, input_grad=False,
                        use_batch_norm=use_batch_norm, generator=gen,
                        output_units=output_units),
      transform_name='log1p')


def _launch_counts():
  from ranking_tpu_torch.ops.cuda import fused_bn
  return [fn.launches for fn in fused_bn.KERNEL_WRAPPERS]


def _snapshot_first_step(state):
  grads = {k: p.grad.clone() for k, p in state.model.named_parameters()}
  stats = {k: v.clone() for k, v in state.model.state_dict().items()
           if 'running' in k}
  return grads, stats


def _all_launch_counts():
  """Launches of every kernel wrapper: the sort, rows 2-6, rows 7-8."""
  from ranking_tpu_torch.ops.cuda import pairwise
  from ranking_tpu_torch.ops.cuda import sort as cuda_sort
  return ([cuda_sort.sorted_values_and_ranks.launches] + _launch_counts()
          + [fn.launches for fn in pairwise.KERNEL_WRAPPERS])


def _reset_all_launches():
  from ranking_tpu_torch.ops.cuda import fused_bn
  from ranking_tpu_torch.ops.cuda import pairwise
  from ranking_tpu_torch.ops.cuda import rows
  from ranking_tpu_torch.ops.cuda import sort as cuda_sort
  for module in (fused_bn, pairwise, rows):
    module.reset_launches()
  cuda_sort.sorted_values_and_ranks.launches = 0


def _zero_in_theory(model, shift_invariant):
  """Names of the parameters whose gradient is zero in theory: the biases
  in front of a batch norm (the norm takes the batch mean out), and with
  ``shift_invariant`` (a loss that adding one number to every logit does
  not change) the output bias of a one-logit head."""
  tower = model.scorer.tower
  dense = [f'scorer.tower.dense.{i}.bias' for i in range(len(tower.dense))]
  names = set(dense[:-1]) if tower.bn else set()
  if shift_invariant and tower.dense[-1].out_features == 1:
    names.add(dense[-1])
  return names


def _zero_tol(model, loss_fn, batch, generator=None):
  """The rounding bound of a gradient that is zero in theory: a float32
  sum over the N_ROWS rows of terms of about the largest logit gradient,
  N_ROWS * 2^-23 of it (at least 1e-6). The logit gradient from a
  train-mode forward of a copy of ``model`` through the plain versions
  (drawing from ``generator`` where the model draws)."""
  import contextlib
  import copy
  from ranking_tpu_torch.ops.cuda import fused_bn
  from ranking_tpu_torch.ops.cuda import pairwise
  from ranking_tpu_torch.train import steps
  model = copy.deepcopy(model).to('cuda')
  b = steps.restore_flat_examples(batch.to('cuda'))
  with contextlib.ExitStack() as stack:
    stack.enter_context(fused_bn.plain_versions())
    stack.enter_context(pairwise.plain_versions())
    extra = {} if generator is None else {'generator': generator}
    logits = model(b.context, b.examples, b.mask, training=True,
                   **extra).detach()
    logits.requires_grad_()
    loss_fn(b.labels, logits).backward()
  return max(1e-6, N_ROWS * 2.0 ** -23 * logits.grad.abs().max().item())


def _grad_errors(grads, want, zero_names, zero_tol):
  """(worst relative error in the Frobenius norm over the parameters, the
  parameter, worst entry as a share of its parameter's largest, the
  parameter) of ``grads`` against ``want``. A parameter of ``zero_names``
  is zero in theory: both sides must be within ``zero_tol`` of 0 (else the
  third value is inf). Every other parameter is held relatively; one whose
  ``want`` is exactly 0 must be exactly 0."""
  worst_norm = worst_max = 0.0
  worst_name = worst_max_name = None
  for k, w in want.items():
    g = grads[k].to(w.dtype)
    if k in zero_names:
      if max(g.abs().max().item(), w.abs().max().item()) > zero_tol:
        return worst_norm, f'{k} (zero in theory)', math.inf, k
      continue
    scale = w.abs().max().item()
    if scale == 0.0:
      if g.abs().max().item() != 0.0:
        return worst_norm, f'{k} (exactly 0)', math.inf, k
      continue
    norm = ((g - w).norm() / w.norm()).item()
    if norm > worst_norm:
      worst_name = f'{k} (largest entry {scale:.3g})'
    worst_norm = max(worst_norm, norm)
    entry = (g - w).abs().max().item() / scale
    if entry > worst_max:
      worst_max_name = k
    worst_max = max(worst_max, entry)
  return worst_norm, worst_name, worst_max, worst_max_name


def _plain_step(step, model, batch, plain_sort, plain_pairwise=True,
                record=False):
  """The first step from ``model`` with the tower's kernels (rows 2-6)
  switched to their plain versions, and rows 7-8 unless not
  ``plain_pairwise``, and row 1 with ``plain_sort``. Returns (metrics,
  gradients, running statistics, launches of rows 1 and 7-8, and with
  ``record`` what ``_recording_tower`` recorded, else None)."""
  import contextlib
  from ranking_tpu_torch.ops.cuda import fused_bn
  from ranking_tpu_torch.ops.cuda import pairwise
  from ranking_tpu_torch.train import state as state_lib
  from ranking_tpu_torch.utils import list_ops
  state = state_lib.create_train_state(model, state_lib.adam(1e-3),
                                       device='cuda')
  before = _all_launch_counts()
  with contextlib.ExitStack() as stack:
    stack.enter_context(fused_bn.plain_versions())
    if plain_pairwise:
      stack.enter_context(pairwise.plain_versions())
    if plain_sort:
      stack.enter_context(mock.patch.object(list_ops, '_kernel_sort_ok',
                                            return_value=False))
    rec = (stack.enter_context(_recording_tower(state.model)) if record
           else None)
    state, metrics = step(state, batch)
  launched = [a - b for a, b in zip(_all_launch_counts(), before)]
  tower, others = launched[1:6], launched[:1] + launched[6:]
  if any(tower) or (plain_sort and others[0]) or (plain_pairwise
                                                  and any(others[1:])):
    _fail(f'a plain-version step launched a kernel: {launched}')
  grads = {k: p.grad for k, p in state.model.named_parameters()}
  stats = {k: v for k, v in state.model.state_dict().items()
           if 'running' in k}
  return metrics, grads, stats, others, rec


def _hold_first_step(what, step, twin, batch, first_loss, first_grads,
                     first_stats, plain_sort=False, zero_names=(),
                     zero_tol=1e-6, anchor=None, first_record=None,
                     force_anchor=False):
  """The same first step through the plain versions of rows 2-8 (and of
  row 1 with ``plain_sort``), on the card, from ``twin``, a copy of the
  untrained model: loss, gradients and running statistics against the
  kernels' step. The gradients of ``zero_names`` are zero in theory and
  held to ``zero_tol`` absolute; the largest entry to ``OP_TOL_MAX``.

  A gradient outside ``OP_TOL_NORM`` is settled by ``anchor`` (a function
  of a step's record giving ``_first_step_f64``), with ``first_record``
  the kernels' step's: the two float32 steps differ where a unit's
  pre-activation is within rounding of 0 and the two forwards set its ReLU
  gate differently, each such unit moving its gradients by one row's whole
  term, and the logits and the loss's gradient then differ a little too.
  So the step with only the tower's kernels switched off (rows 1 and 7-8
  on) must be within OP_TOL of the plain versions' step, and each float32
  step within ``ANCHOR_TOL`` of the float64 step of its own gates and loss
  gradient. ``force_anchor`` applies these checks to a step within OP_TOL
  as well. Returns the readings."""
  import copy
  use_anchor = anchor is not None
  rest_twin = copy.deepcopy(twin) if use_anchor else None
  twin_metrics, plain_grads, plain_stats, _, plain_record = _plain_step(
      step, twin, batch, plain_sort, record=use_anchor)
  loss_err = abs(twin_metrics['loss'].item() - first_loss)
  if loss_err > 1e-5 * abs(first_loss):
    _fail(f'{what}: first loss {first_loss} vs plain versions '
          f'{twin_metrics["loss"].item()}')
  worst_norm, worst_name, worst_max, max_name = _grad_errors(
      first_grads, plain_grads, zero_names, zero_tol)
  if worst_max == math.inf:
    _fail(f'{what}: gradient {worst_name} off by more than {zero_tol:.3g}')
  if worst_max > OP_TOL_MAX:
    _fail(f'{what}: first-step gradients differ from the plain versions '
          f'by {worst_max:.3g} of the largest entry in {max_name} (allowed '
          f'{OP_TOL_MAX})')
  out = {'norm': worst_norm, 'norm_param': worst_name, 'max': worst_max,
         'max_param': max_name}
  anchored = ''
  if worst_norm > OP_TOL_NORM and not use_anchor:
    _fail(f'{what}: first-step gradients differ from the plain versions '
          f'by {worst_norm:.3g} in norm (worst {worst_name}), '
          f'{worst_max:.3g} at most')
  if use_anchor and (worst_norm > OP_TOL_NORM or force_anchor):
    _, rest_grads, _, rest_launches, _ = _plain_step(
        step, rest_twin, batch, False, plain_pairwise=False)
    rest = _grad_errors(rest_grads, plain_grads, zero_names, zero_tol)
    if rest[0] > OP_TOL_NORM or rest[2] > OP_TOL_MAX:
      _fail(f'{what}: with only the tower switched off (launches of rows 1 '
            f'and 7-8: {rest_launches}) the first step differs from the '
            f'plain versions by {rest[0]:.3g} in norm ({rest[1]}), '
            f'{rest[2]:.3g} at most ({rest[3]})')
    kern = _grad_errors(first_grads, anchor(first_record), zero_names,
                        zero_tol)
    plain = _grad_errors(plain_grads, anchor(plain_record), zero_names,
                         zero_tol)
    flips = sum(int((g != p).sum().item()) for g, p in zip(
        first_record['gates'], plain_record['gates']))
    out.update(rest_norm=rest[0], rest_max=rest[2],
               rest_launches=rest_launches, gates_differ=flips,
               kernels_f64_norm=kern[0], kernels_f64_max=kern[2],
               kernels_f64_param=kern[1], plain_f64_norm=plain[0],
               plain_f64_max=plain[2], plain_f64_param=plain[1])
    for side, e in (('kernels\'', kern), ('plain versions\'', plain)):
      if e[0] > ANCHOR_TOL or e[2] > ANCHOR_TOL:
        _fail(f'{what}: first-step gradients differ from the plain versions '
              f'by {worst_norm:.3g} in norm (worst {worst_name}); the '
              f'{side} step is off from the float64 step of its own ReLU '
              f'gates and loss gradient by {e[0]:.3g} in norm ({e[1]}), '
              f'{e[2]:.3g} at most ({e[3]}); the two forwards differ in '
              f'{flips} gates')
    why = 'beyond OP_TOL_NORM' if worst_norm > OP_TOL_NORM else 'forced'
    anchored = (f' ({why}: rows 1 and 7-8 alone ({rest_launches} '
                f'launches) within {rest[0]:.3g} in norm and {rest[2]:.3g} '
                f'at most; the two forwards differ in {flips} ReLU gates; '
                f'against float64 of the same gates and loss gradient: '
                f'kernels {kern[0]:.3g} in norm ({kern[1]}), {kern[2]:.3g} '
                f'at most, plain {plain[0]:.3g} ({plain[1]}), '
                f'{plain[2]:.3g})')
  stat_err = 0.0
  for k, v in plain_stats.items():
    stat_err = max(stat_err, _rel_err(first_stats[k], v)[1])
  if stat_err > 1e-5:
    _fail(f'{what}: running statistics differ from the plain versions by '
          f'{stat_err:.3g}')
  _log(f'{what}: first step vs plain versions on the card: loss within '
       f'{loss_err:.3g}, gradients within {worst_norm:.3g} in norm '
       f'({worst_name}) and {worst_max:.3g} at most ({max_name}){anchored}, '
       f'running statistics within {stat_err:.3g}')
  return out


def _train_main_path(gen, eval_batches, fns):
  """Phase 7. Returns (launch counts of the run, trained state, step fn,
  batch)."""
  import copy
  import torch
  from ranking_tpu_torch.data import dataset
  from ranking_tpu_torch.ops import loss_registry
  from ranking_tpu_torch.ops.cuda import fused_bn
  from ranking_tpu_torch.pipeline import serving
  from ranking_tpu_torch.train import state as state_lib
  from ranking_tpu_torch.train import steps
  model = _train_model(gen)
  twin = copy.deepcopy(model)
  batch = dataset.flatten_examples(_make_batch(gen, B))
  loss_fn = loss_registry.make_loss_fn('softmax_loss')
  step = steps.make_train_step(loss_fn, device='cuda')

  # The main path: counts start at 0 here.
  fused_bn.reset_launches()
  state = state_lib.create_train_state(model, state_lib.adam(1e-3),
                                       device='cuda')
  losses = []
  first_grads = None
  for i in range(TRAIN_STEPS):
    state, metrics = step(state, batch)
    losses.append(metrics['loss'].item())
    if i == 0:
      first_grads, first_stats = _snapshot_first_step(state)
  trained_eval = serving.evaluate_dataset(state.model, None, eval_batches,
                                          metric_fns=fns, device='cuda')
  counts = _launch_counts()
  torch.cuda.synchronize()

  if not all(math.isfinite(v) for v in losses):
    _fail(f'train: a loss is not finite: {losses}')
  if not losses[-1] < losses[0]:
    _fail(f'train: the loss did not fall in {TRAIN_STEPS} steps on a '
          f'repeated batch: {losses}')
  per_step = [c / TRAIN_STEPS for c in counts]
  if per_step != [3, 1, 2, 0, 0]:
    _fail(f'train: launches per step {per_step} != [3, 1, 2, 0, 0] for '
          f'rows 2-6')
  for name, value in trained_eval.items():
    if not 0.0 <= value <= 1.0:
      _fail(f'eval of the trained model: {name} = {value} outside [0, 1]')
  _log(f'train: {TRAIN_STEPS} steps at B={B}, L={L}, F={F}, loss '
       f'{losses[0]:.6f} -> {losses[-1]:.6f}; launches per step {per_step}; '
       'trained model eval: '
       + ', '.join(f'{k} {v:.4f}' for k, v in trained_eval.items()))

  # softmax: a shift of every logit leaves the loss as it is.
  _hold_first_step('train', step, twin, batch, losses[0], first_grads,
                   first_stats, zero_names=_zero_in_theory(twin, True),
                   zero_tol=_zero_tol(twin, loss_fn, batch))
  return counts, state, step, batch


def _second_path(gen):
  """Phase 8: rows 5 and 6 through the Function. Returns their launches
  and largest errors."""
  import torch
  from ranking_tpu_torch.ops.cuda import fused_bn
  dev = torch.device('cuda')
  f1 = HIDDEN[0]
  x = torch.randn(N_ROWS, F, generator=gen).to(dev)
  mask = (torch.rand(N_ROWS, generator=gen) > 0.3).to(dev)
  cot = torch.randn(N_ROWS, f1, generator=gen).to(dev)
  params = [(torch.randn(f1, F, generator=gen) * F ** -0.5).to(dev),
            (0.1 * torch.randn(f1, generator=gen)).to(dev),
            (1 + 0.1 * torch.randn(f1, generator=gen)).to(dev),
            (0.1 * torch.randn(f1, generator=gen)).to(dev)]

  def run():
    xd = x.clone().requires_grad_()
    leaves = [p.clone().requires_grad_() for p in params]
    out, _, _ = fused_bn.fused_bn_mlp(xd, mask, *([p] for p in leaves),
                                      input_grad=True)
    return torch.autograd.grad((out * cot).sum(), [xd, leaves[0]])

  fused_bn.reset_launches()
  dx0, dw0 = run()
  counts = _launch_counts()
  with fused_bn.plain_versions():
    want_dx0, want_dw0 = run()
  torch.cuda.synchronize()
  if counts != [1, 1, 0, 1, 1]:
    _fail(f'second path: launches {counts} != [1, 1, 0, 1, 1] for rows 2-6')
  errs = {'bwd_dx_only': _rel_err(dx0, want_dx0),
          'bwd_dw_only': _rel_err(dw0, want_dw0)}
  for name, (err, rel) in errs.items():
    # The forward's y differs in its last bits between the two runs, so a
    # gate may flip: the whole-op tolerance applies, not the kernel's.
    if rel > OP_TOL_MAX:
      _fail(f'second path: {name} off by {err} ({rel:.3g} of its largest)')
  _log(f'second path: one-layer tower {F}->{f1} with an input gradient: '
       + ', '.join(f'{k} within {v[1]:.3g}' for k, v in errs.items())
       + f'; launches {counts}')
  return {'bwd_dx_only': counts[3], 'bwd_dw_only': counts[4]}


def _mm_calls(case):
  """{row name: [(shape label, fn)]}: the bare matrix products of each call
  of ``_fused_calls`` (rows 2, 4-6) as cuBLAS SGEMMs through ``torch.mm``
  (TF32 off), on inputs of the same shapes: a yardstick of the product
  engine, not the same function (no fold, no dy rebuild, no statistics)."""
  import torch
  x, ls = case['x'], case['layers']
  top = len(ls) - 1
  n = x.shape[0]
  dev = x.device

  def rnd(*shape):
    return torch.randn(*shape, device=dev)

  def label(l):
    return f"{ls[l]['w'].shape[1]}->{ls[l]['w'].shape[0]}"

  def fwd(l):
    h, w = rnd(n, ls[l]['w'].shape[1]), ls[l]['w']
    return lambda: torch.mm(h, w.t())

  def mats(l, fold):
    w = ls[l]['w']
    f_out, f_in = w.shape
    dy, z = rnd(n, f_out), rnd(n, f_in)
    prods = [lambda: torch.mm(dy, w), lambda: torch.mm(z.t(), dy)]
    if fold:
      x0 = rnd(n, x.shape[1])
      prods += [lambda: torch.mm(x0.t(), z), lambda: torch.mm(x0.t(), z)]
    return lambda: [p() for p in prods]

  w0 = ls[0]['w']
  dy0, x0 = rnd(n, w0.shape[0]), rnd(n, w0.shape[1])
  return {
      'layer_forward': [(label(l), fwd(l)) for l in range(len(ls))],
      'bwd_mats': [(label(l) + (' +fold' if l == 1 else ''), mats(l, l == 1))
                   for l in range(top, 0, -1)],
      'bwd_dx_only': [(label(0), lambda: torch.mm(dy0, w0))],
      'bwd_dw_only': [(label(0), lambda: torch.mm(x0.t(), dy0))],
  }


def _time_fused(gen, n=N_ROWS, dims=(F,) + HIDDEN):
  """Phase 9a: {row name: {'ms', 'plain_ms', 'ms_by_shape', ...}} at the
  flagship shapes (or at ``n`` rows of the tower ``dims``), float32; device
  time per call from CUDA graph replays, beside the plain version, the
  bound (tensor cores and float32 pipes) and the bare products through
  ``torch.mm``."""
  import torch
  from ranking_tpu_torch.ops.cuda import fused_bn
  case = _fused_case(gen, n, 'ragged', torch.float32, dims)
  bounds = _fused_bounds(n, dims)
  mm_calls = _mm_calls(case)
  out = {}
  for row, calls in _fused_calls(case).items():
    by_shape, plain_by_shape = {}, {}
    for shape, fn in calls:
      by_shape[shape] = _graph_ms(fn, calls=5, replays=10)
      with fused_bn.plain_versions():
        plain_by_shape[shape] = _graph_ms(fn, calls=5, replays=10)
    mm_by_shape = {shape: _graph_ms(fn, calls=5, replays=10)
                   for shape, fn in mm_calls.get(row, [])}
    out[row] = {'ms': sum(by_shape.values()),
                'plain_ms': sum(plain_by_shape.values()),
                'bound_ms': sum(b[0] for b in bounds[row]),
                'bound_by': max(bounds[row])[1],  # of the largest call
                'bound_ms_f32_pipe': sum(b[2] for b in bounds[row]),
                'mm_ms': sum(mm_by_shape.values()) if mm_by_shape else None,
                'ms_by_shape': by_shape, 'plain_ms_by_shape': plain_by_shape,
                'bound_ms_by_shape': dict(zip(by_shape,
                                              (b[0] for b in bounds[row]))),
                'bound_ms_f32_pipe_by_shape': dict(zip(
                    by_shape, (b[2] for b in bounds[row]))),
                'mm_ms_by_shape': mm_by_shape}
    _log(f'fused {row} (N={n}): ' + ', '.join(
        f'{k} {v:.4f} ms (plain {plain_by_shape[k]:.4f}, bound '
        f'{out[row]["bound_ms_by_shape"][k]:.4f}, f32-pipe bound '
        f'{out[row]["bound_ms_f32_pipe_by_shape"][k]:.4f}'
        + (f', torch.mm {mm_by_shape[k]:.4f}' if k in mm_by_shape else '')
        + ')' for k, v in by_shape.items()))
  return out


def _time_train_step(state, step, batch, switch_module, prefix='train'):
  """Phases 9b and 12b: a train step's host and device time with the
  kernels of ``switch_module`` on (fused) and switched off (unfused)."""
  import torch
  dev_batch = batch.to(torch.device('cuda'))
  fn = lambda: step(state, dev_batch)  # noqa: E731
  out = {}
  for name, switch in (('fused', None), ('unfused', False)):
    switch_module.set_enabled(switch)
    try:
      out[f'{prefix}_step_{name}_host_ms'] = _host_ms(fn, 20)
      out[f'{prefix}_step_{name}_device_ms'] = _event_ms(fn, 20, warmup=3)
    finally:
      switch_module.set_enabled(None)
  out[f'{prefix}_lists_per_s'] = B / out[f'{prefix}_step_fused_host_ms'] * 1e3
  return out, fn


# --- rows 7 and 8: the fused pairwise sums -----------------------------------


def _pairwise_inputs(gen, b, l, *, min_len=None, topn=None, integer_logits=False):
  """Operands of the fused pairwise sums as the dispatcher makes them for a
  ragged graded batch with item weights: gains 2^l - 1, the logits' own
  ranks, scale = L / maxDCG (capped at ``topn``). On the card."""
  import torch
  from ranking_tpu_torch.ops import sorting
  dev = torch.device('cuda')
  labels, valid = _graded_labels(gen, b, l, min_len or max(1, l // 10))
  logits = torch.randn(b, l, generator=gen) * 2
  if integer_logits:   # tied logits, and pairs at exactly d == 1
    logits = torch.round(logits)
  weights = torch.where(valid, torch.rand(b, l, generator=gen) + 0.1, 0.0)
  ct = torch.randn(b, 3, generator=gen)
  labels, valid, logits, weights, ct = (
      t.to(dev) for t in (labels, valid, logits, weights, ct))
  clean = torch.where(valid, labels, 0.0)
  ranks = sorting.compute_ranks(logits, valid).to(torch.float32)
  scale = float(l) * sorting.inverse_max_dcg(clean, topn=topn)[:, 0]
  return dict(labels=labels, logits=logits, mask=valid.to(torch.float32),
              norm_w=weights, gain=torch.pow(2.0, clean) - 1.0, ranks=ranks,
              scale=scale, ct=ct)


_PAIR_OPERANDS = ('labels', 'logits', 'mask', 'norm_w', 'gain', 'ranks',
                  'scale')


def _pairwise_cases(gen):
  """(name, operands, static arguments) of every kernel-vs-plain case."""
  import torch
  from ranking_tpu_torch.ops.cuda import pairwise as pw
  losses = {'logistic': pw.LOSS_LOGISTIC, 'hinge': pw.LOSS_HINGE,
            'soft01': pw.LOSS_SOFT_ZERO_ONE}
  modes = {'none': pw.LAMBDA_NONE, 'labeldiff': pw.LAMBDA_LABELDIFF,
           'v2': pw.LAMBDA_DCG_V2, 'v1': pw.LAMBDA_DCG_V1,
           'yeti': pw.LAMBDA_DCG_V2_NEIGHBOR}
  kinds = {'log2': pw.DISCOUNT_LOG2_INVERSE, 'inverse': pw.DISCOUNT_INVERSE,
           'log1p': pw.DISCOUNT_LOG1P_INVERSE}
  dcg = ('v2', 'v1', 'yeti')

  def static(loss, mode, kind='log1p', topn=None, smooth=0.0, l=L):
    return (losses[loss], modes[mode], kinds[kind],
            float(topn or l), smooth)

  cases = []
  flagship = _pairwise_inputs(gen, B, L)
  for loss in losses:
    for mode in modes:
      cases.append((f'B{B} L{L} {loss} {mode}', flagship, static(loss, mode)))
  small = _pairwise_inputs(gen, 5, 11, min_len=3)
  for mode in modes:
    cases.append((f'B5 L11 logistic {mode}', small,
                  static('logistic', mode, l=11)))
  for l in (1, 2):
    tiny = _pairwise_inputs(gen, 3, l, min_len=1)
    cases.append((f'B3 L{l} hinge v1', tiny, static('hinge', 'v1', l=l)))
  # A list with no valid item, and one whose labels are all equal: no
  # pair, so three zeros and a zero gradient (checked in the caller).
  empty = _pairwise_inputs(gen, 4, 50)
  empty['mask'][0] = 0.0
  empty['labels'][0] = -1.0
  empty['norm_w'][0] = 0.0
  empty['labels'][1] = torch.where(empty['mask'][1] > 0, 2.0, -1.0)
  for mode in ('none', 'v1'):
    cases.append((f'no-pair lists logistic {mode}', empty,
                  static('logistic', mode, l=50)))
  # Tied logits, and hinge pairs at exactly d == 1.
  ties = _pairwise_inputs(gen, B, L, integer_logits=True)
  for loss in losses:
    cases.append((f'integer logits {loss} v2', ties, static(loss, 'v2')))
  cases.append(('integer logits hinge none', ties, static('hinge', 'none')))
  top10 = _pairwise_inputs(gen, B, L, topn=10)
  for mode in dcg:
    cases.append((f'topn 10 logistic {mode}', top10,
                  static('logistic', mode, topn=10)))
  cases.append(('topn 10 smooth 0.25 soft01 v1', top10,
                static('soft01', 'v1', topn=10, smooth=0.25)))
  cases.append(('smooth 1.0 logistic v1', flagship,
                static('logistic', 'v1', smooth=1.0)))
  for kind in ('log2', 'inverse'):
    for mode in dcg:
      cases.append((f'discount {kind} logistic {mode} topn 7', flagship,
                    static('logistic', mode, kind=kind, topn=7)))
  for b, l in ((LONG_B, LONG_L), (4, 2048)):
    long_lists = _pairwise_inputs(gen, b, l)
    for loss, mode in (('logistic', 'v1'), ('hinge', 'none'),
                       ('soft01', 'yeti')):
      cases.append((f'B{b} L{l} {loss} {mode}', long_lists,
                    static(loss, mode, l=l)))
  top = _pairwise_inputs(gen, 1, pw.MAX_LIST_SIZE)
  cases.append((f'top of the domain L{pw.MAX_LIST_SIZE} logistic v1', top,
                static('logistic', 'v1', l=pw.MAX_LIST_SIZE)))
  # The edges of the kernels' staging, tables and tiles, from a generator
  # of their own, so that later phases keep their inputs.
  edge = torch.Generator().manual_seed(SEED + 2)
  # Ranks that are not whole numbers in [1, L] send a list to the per-pair
  # formula: a few halves in every third list, one rank above L in the
  # next; the third of each three keeps the tables.
  odd = _pairwise_inputs(edge, B, L)
  half = (torch.rand(B, L, generator=edge) < 0.05).to(odd['ranks'].device)
  odd['ranks'][0::3] += torch.where(half[0::3], 0.5, 0.0)
  odd['ranks'][1::3, 7] = L + 3.0
  for mode in dcg:
    cases.append((f'fractional ranks and ranks > L logistic {mode} topn 10',
                  odd, static('logistic', mode, topn=10)))
  one = _pairwise_inputs(edge, 1, 1, min_len=1)
  for loss, mode in (('logistic', 'v1'), ('hinge', 'none')):
    cases.append((f'no-pair list of one item {loss} {mode}', one,
                  static(loss, mode, l=1)))
  # Row tiles under the host's rule: every item valid, so that a tile's
  # share is exactly ceil(L / tiles); L = 33, and the flagship's share
  # times the tiles, one short and one over.
  tiles = pw._tiles(B, L)
  share = -(-L // tiles)
  for l in (33, tiles * share - 1, tiles * share + 1):
    full = _pairwise_inputs(edge, B, l, min_len=l)
    for loss, mode in (('logistic', 'v1'), ('soft01', 'none')):
      cases.append((f'tile edge B{B} L{l} all valid {loss} {mode}', full,
                    static(loss, mode, l=l)))
  # The largest list with tables, and the smallest without.
  for l in (pw.MAX_TABLE_LIST_SIZE, pw.MAX_TABLE_LIST_SIZE + 1):
    cases.append((f'tables edge L{l} logistic v2', _pairwise_inputs(edge, 1, l),
                  static('logistic', 'v2', l=l)))
  # yeti_logistic_loss (phase 21): the B x 8 Gumbel-sampled lists, where
  # the host gives a list fewer row tiles than the flagship's; the Yeti
  # DCG weight is not normalized (scale = L) and takes the log2 discount.
  sampled = _pairwise_inputs(edge, B * 8, L)
  sampled['scale'] = torch.full_like(sampled['scale'], float(L))
  tiles = pw._tiles(B * 8, L)
  for loss, mode, kind in (('logistic', 'yeti', 'log2'),
                           ('logistic', 'v2', 'log1p'),
                           ('hinge', 'none', 'log1p'),
                           ('soft01', 'v1', 'log1p')):
    cases.append((f'B{B * 8} L{L} ({tiles} row tile a list) {loss} {mode} '
                  f'{kind}', sampled, static(loss, mode, kind=kind)))
  return cases


def _check_pairwise_kernels(gen):
  """Phase 3d: rows 7 and 8 against their plain versions. Returns
  {wrapper name: (largest abs error, largest share)}."""
  import torch
  from ranking_tpu_torch.ops.cuda import pairwise as pw
  worst = {'pairwise_sums_forward': (0.0, 0.0),
           'pairwise_sums_backward': (0.0, 0.0)}
  cases = _pairwise_cases(gen)
  for name, d, static in cases:
    ops = [d[k] for k in _PAIR_OPERANDS]
    got = pw.pairwise_sums_forward(*ops, *static)
    got_grad = pw.pairwise_sums_backward(*ops, *static, d['ct'])
    with pw.plain_versions():
      want = pw.pairwise_sums_forward(*ops, *static)
      want_grad = pw.pairwise_sums_backward(*ops, *static, d['ct'])
    torch.cuda.synchronize()
    if not torch.equal(got[:, 2], want[:, 2]):
      _fail(f'pairwise {name}: count of non-zero pair weights differs: '
            f'{got[:, 2].tolist()[:8]} vs {want[:, 2].tolist()[:8]}')
    if not torch.isfinite(want).all() or not torch.isfinite(want_grad).all():
      _fail(f'pairwise {name}: the plain version is not finite')
    for row, pairs in (
        ('pairwise_sums_forward', ((got[:, 0], want[:, 0]),
                                   (got[:, 1], want[:, 1]))),
        ('pairwise_sums_backward', ((got_grad, want_grad),))):
      for g, w in pairs:
        err, rel = _rel_err(g, w)
        if w.abs().max().item() == 0.0:
          rel = 0.0 if err == 0.0 else math.inf
        if not rel <= PAIR_TOL:
          _fail(f'pairwise {name}: {row} differs from the plain version by '
                f'{err} ({rel:.3g} of its largest value; allowed {PAIR_TOL})')
        worst[row] = (max(worst[row][0], err), max(worst[row][1], rel))
    if name.startswith('no-pair'):
      if got[:2].abs().max().item() != 0 or got_grad[:2].abs().max().item() != 0:
        _fail(f'pairwise {name}: a list with no pair has a non-zero output')
  _log(f'kernel vs plain: pairwise rows 7-8, {len(cases)} cases: count '
       'equal, ' + ', '.join(f'{k} within {v[1]:.3g}'
                             for k, v in worst.items()))
  return worst


def _check_pairwise_op(gen):
  """Phase 3e: the whole loss with the kernels against autograd through the
  plain [B, L, L] path on the card, and against float64 on the CPU."""
  import torch
  from ranking_tpu_torch.ops import lambda_weights as lw
  from ranking_tpu_torch.ops import losses
  from ranking_tpu_torch.ops import sorting
  from ranking_tpu_torch.ops.cuda import pairwise as pw
  d = _pairwise_inputs(gen, B, L)
  labels, logits, weights = d['labels'], d['logits'], d['norm_w']
  loss = losses.PairwiseLogisticLoss(
      lambda_weight=lw.create_ndcg_lambda_weight())

  def run():
    s = logits.clone().requires_grad_()
    value = loss(labels, s, weights=weights)
    value.backward()
    return value.detach(), s.grad

  pw.reset_launches()
  got = run()
  if [fn.launches for fn in pw.KERNEL_WRAPPERS] != [1, 1]:
    _fail('the pairwise loss did not launch rows 7 and 8 once each')
  pw.set_enabled(False)
  try:
    plain = run()
  finally:
    pw.set_enabled(None)
  # Float64 on the CPU: the same operands (the ranks are those of the
  # float32 logits) through the plain sums, differentiated by autograd.
  f64 = lambda t: t.detach().to('cpu', torch.float64)  # noqa: E731
  clean = torch.where(labels >= 0, labels, 0.0)
  ideal = torch.sort(f64(clean), dim=1, descending=True).values
  discount = 1.0 / torch.log1p(torch.arange(1, L + 1, dtype=torch.float64))
  ideal_dcg = ((torch.pow(2.0, ideal) - 1.0) * discount).sum(1)
  scale = torch.where(ideal_dcg > 0, L / ideal_dcg, 0.0)
  s64 = f64(logits).requires_grad_()
  ranks = sorting.compute_ranks(logits, labels >= 0)
  sums = pw.pairwise_sums_reference(
      f64(labels), s64, f64(d['mask']), f64(weights),
      torch.pow(2.0, f64(clean)) - 1.0, f64(ranks), scale, pw.LOSS_LOGISTIC,
      pw.LAMBDA_DCG_V1, pw.DISCOUNT_LOG1P_INVERSE, float(L), 0.0)
  value64 = sums[:, 0].sum() / sums[:, 2].sum()
  value64.backward()
  torch.cuda.synchronize()
  for name, (want_value, want_grad) in (
      ('autograd through the plain path on the card', plain),
      ('float64 on the CPU', (value64.detach(), s64.grad))):
    value_err = abs(got[0].item() - want_value.item()) / abs(want_value.item())
    _, grad_rel = _rel_err(got[1].cpu(), want_grad.cpu())
    if not (value_err <= PAIR_TOL and grad_rel <= PAIR_TOL):
      _fail(f'pairwise loss vs {name}: value off by {value_err:.3g}, '
            f'dlogits by {grad_rel:.3g} of the largest (allowed {PAIR_TOL})')
    _log(f'pairwise loss vs {name}: value within {value_err:.3g}, dlogits '
         f'within {grad_rel:.3g}')


def _lambdarank_main_path(gen, eval_batches, fns):
  """Phase 10. Returns (launch counts [sort, rows 2-6, rows 7-8] of the 8
  steps, trained state, step fn, batch)."""
  import copy
  import torch
  from ranking_tpu_torch.data import dataset
  from ranking_tpu_torch.ops import lambda_weights as lw
  from ranking_tpu_torch.ops import loss_registry
  from ranking_tpu_torch.ops.cuda import fused_bn
  from ranking_tpu_torch.ops.cuda import pairwise
  from ranking_tpu_torch.ops.cuda import sort as cuda_sort
  from ranking_tpu_torch.pipeline import serving
  from ranking_tpu_torch.train import state as state_lib
  from ranking_tpu_torch.train import steps
  model = _train_model(gen)
  twin = copy.deepcopy(model)
  batch = dataset.flatten_examples(_make_batch(gen, B))
  loss_fn = loss_registry.make_loss_fn(
      'pairwise_logistic_loss', lambda_weight=lw.create_ndcg_lambda_weight())
  step = steps.make_train_step(loss_fn, device='cuda')

  # The main path of this slice: every count starts at 0 here.
  fused_bn.reset_launches()
  pairwise.reset_launches()
  cuda_sort.sorted_values_and_ranks.launches = 0
  state = state_lib.create_train_state(model, state_lib.adam(1e-3),
                                       device='cuda')
  losses = []
  for i in range(TRAIN_STEPS):
    state, metrics = step(state, batch)
    losses.append(metrics['loss'].item())
    if i == 0:
      first_grads, first_stats = _snapshot_first_step(state)
  counts = _all_launch_counts()
  # The other pairwise recipes, one step each on the trained state; the
  # last with a seeded generator, which shuffles rank ties.
  others = {
      'pairwise_hinge_loss + label diff': (
          dict(loss_keys='pairwise_hinge_loss',
               lambda_weight=lw.LabelDiffLambdaWeight()), None),
      'pairwise_soft_zero_one_loss': (
          dict(loss_keys='pairwise_soft_zero_one_loss'), None),
      'pairwise_logistic_loss + ndcg v2 top 10, shuffled ties': (
          dict(loss_keys='pairwise_logistic_loss',
               lambda_weight=lw.create_ndcg_lambda_weight_v2(topn=10)),
          torch.Generator(device='cuda').manual_seed(SEED)),
  }
  other_losses = {}
  for name, (config, generator) in others.items():
    before = [fn.launches for fn in pairwise.KERNEL_WRAPPERS]
    other_step = steps.make_train_step(loss_registry.make_loss_fn(**config),
                                       device='cuda')
    state, metrics = other_step(state, batch, generator)
    other_losses[name] = metrics['loss'].item()
    if [fn.launches for fn in pairwise.KERNEL_WRAPPERS] != [
        n + 1 for n in before]:
      _fail(f'lambdarank: a step of {name} did not launch rows 7 and 8 once')
  trained_eval = serving.evaluate_dataset(state.model, None, eval_batches,
                                          metric_fns=fns, device='cuda')
  torch.cuda.synchronize()

  if not all(math.isfinite(v) for v in losses + list(other_losses.values())):
    _fail(f'lambdarank: a loss is not finite: {losses} {other_losses}')
  if not losses[-1] < losses[0]:
    _fail(f'lambdarank: the loss did not fall in {TRAIN_STEPS} steps on a '
          f'repeated batch: {losses}')
  per_step = [c / TRAIN_STEPS for c in counts]
  if per_step != [1, 3, 1, 2, 0, 0, 1, 1]:
    _fail(f'lambdarank: launches per step {per_step} != [1, 3, 1, 2, 0, 0, 1, '
          '1] for the sort, rows 2-6 and rows 7-8')
  for name, value in trained_eval.items():
    if not 0.0 <= value <= 1.0:
      _fail(f'eval of the lambdarank model: {name} = {value} outside [0, 1]')
  _log(f'lambdarank: {TRAIN_STEPS} steps of pairwise_logistic_loss + ndcg at '
       f'B={B}, L={L}, F={F}, loss {losses[0]:.6f} -> {losses[-1]:.6f}; '
       f'launches per step {per_step} (sort, rows 2-6, rows 7-8); then '
       + ', '.join(f'{k} {v:.6f}' for k, v in other_losses.items())
       + '; trained model eval: '
       + ', '.join(f'{k} {v:.4f}' for k, v in trained_eval.items()))
  # Pairwise logistic: a function of logit differences only.
  _hold_first_step('lambdarank', step, twin, batch, losses[0], first_grads,
                   first_stats, zero_names=_zero_in_theory(twin, True),
                   zero_tol=_zero_tol(twin, loss_fn, batch))
  return counts, state, step, batch


def _long_list_step(gen):
  """Phase 11: one train step at B=16, L=1024 without batch norm, with the
  pairwise kernels and with the switch off. Returns peak device memory."""
  import copy
  import torch
  from ranking_tpu_torch.data import dataset
  from ranking_tpu_torch.ops import lambda_weights as lw
  from ranking_tpu_torch.ops import loss_registry
  from ranking_tpu_torch.ops.cuda import pairwise
  from ranking_tpu_torch.train import state as state_lib
  from ranking_tpu_torch.train import steps
  model = _train_model(gen, use_batch_norm=False)
  batch = dataset.flatten_examples(
      _make_batch(gen, LONG_B, min_len=LONG_L // 10, l=LONG_L)).to(
          torch.device('cuda'))
  step = steps.make_train_step(loss_registry.make_loss_fn(
      'pairwise_logistic_loss', lambda_weight=lw.create_ndcg_lambda_weight()),
                               device='cuda')
  out = {}
  for name, switch in (('kernel', None), ('plain_path', False)):
    state = state_lib.create_train_state(copy.deepcopy(model),
                                         state_lib.adam(1e-3), device='cuda')
    pairwise.set_enabled(switch)
    pairwise.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    try:
      state, metrics = step(state, batch)
    finally:
      pairwise.set_enabled(None)
    torch.cuda.synchronize()
    launches = [fn.launches for fn in pairwise.KERNEL_WRAPPERS]
    if launches != ([1, 1] if switch is None else [0, 0]):
      _fail(f'long lists, {name}: rows 7-8 launched {launches}')
    out[name] = dict(
        loss=metrics['loss'].item(),
        grads={k: p.grad.clone() for k, p in state.model.named_parameters()},
        peak_mb=(torch.cuda.max_memory_allocated() - base) / 2 ** 20)
  loss_err = abs(out['kernel']['loss'] - out['plain_path']['loss']) / abs(
      out['plain_path']['loss'])
  worst = 0.0
  for k, w in out['plain_path']['grads'].items():
    g = out['kernel']['grads'][k]
    if w.abs().max().item() < 1e-6:
      # Zero in theory: a pairwise loss does not move with a shift of all
      # logits, so the output bias gets rounding noise on both sides.
      if (g - w).abs().max().item() > 1e-6:
        _fail(f'long lists: zero gradient {k} off by more than 1e-6')
      continue
    worst = max(worst, ((g - w).norm() / w.norm()).item())
  if not (math.isfinite(out['kernel']['loss']) and loss_err <= 1e-5
          and worst <= 1e-5):
    _fail(f'long lists: kernel step vs the [B, L, L] path: loss off by '
          f'{loss_err:.3g} (allowed 1e-5), gradients by {worst:.3g} in norm '
          '(allowed 1e-5)')
  _log(f'long lists: train step at B={LONG_B}, L={LONG_L} without batch norm: '
       f'loss within {loss_err:.3g} and gradients within {worst:.3g} in norm '
       f'of the [B, L, L] path; peak device memory above the resident state '
       f"{out['kernel']['peak_mb']:.1f} MiB with the kernels, "
       f"{out['plain_path']['peak_mb']:.1f} MiB without")
  return {'long_list_step_kernel_peak_mib': out['kernel']['peak_mb'],
          'long_list_step_plain_path_peak_mib': out['plain_path']['peak_mb']}


# Work that the function needs for one preference pair (l_i > l_j, both
# items unmasked): (float operations, special-function results). Ranks are
# whole numbers in [1, L], so the discount terms of a DCG weight
# (|D(k) - D(k + 1)|, 1 / (1 - D(r)), the capped D(r)) count as reads of an
# L-entry table: the weight is the gain difference and the products of its
# factors, with no special function. The loss needs exp and log (logistic),
# exp and a reciprocal (soft zero-one, and both sigmoid gradients) or
# neither (hinge); each counts one special-function result. The backward
# needs l'(d) once per preference pair, added to one item and taken from the
# other. Every one of the L^2 ordered pairs costs one label compare besides.
# csrc/pairwise.cu spends more than this (its branch-free loops weigh every
# pair of unmasked items and evaluate its loss, and the backward visits a
# pair from both rows): the bound is the function's, not that kernel's.
_PAIR_WORK = {
    'weight': {'none': (1, 0), 'labeldiff': (3, 0), 'v2': (4, 0),
               'v1': (6, 0), 'yeti': (4, 0)},
    'forward': {'logistic': (9, 2), 'hinge': (4, 0), 'soft01': (5, 2)},
    'backward': {'logistic': (5, 2), 'hinge': (4, 0), 'soft01': (7, 2)},
}


def _pairwise_bounds(d, loss, mode, backward):
  """(bound_ms, bound_by) of one call on the operands ``d``: the bytes
  (each input that the mode reads once, the output written once) over the
  HBM rate against this data's operations over the float32 rate and its
  special-function results over that unit's rate."""
  b, l = d['labels'].shape
  lab, m = d['labels'], d['mask'] > 0
  pref = ((lab[:, :, None] > lab[:, None, :]) & m[:, :, None]
          & m[:, None, :]).sum().item()
  flops, sfu = (x + y for x, y in zip(
      _PAIR_WORK['weight'][mode],
      _PAIR_WORK['backward' if backward else 'forward'][loss]))
  # labels, logits, mask, item weights; gain, ranks and scale in a DCG mode.
  words_in = 6 * b * l + b if mode in ('v2', 'v1', 'yeti') else 4 * b * l
  byte_count = (words_in + (b * l + b * 3 if backward else b * 3)) * 4
  op_count = b * l * l + pref * flops
  return max((byte_count / HBM_BYTES_PER_S * 1e3, 'bytes'),
             (op_count / F32_OPS_PER_S * 1e3, 'operations'),
             (pref * sfu / SFU_OPS_PER_S * 1e3, 'operations'))


def _time_pairwise(gen, shapes=((B, L), (LONG_B, LONG_L)),
                   lambda_modes=('none', 'v1')):
  """Phase 12a: {wrapper name: {case: {'ms', 'plain_ms', 'bound_ms',
  'bound_by'}}}; device time per call from CUDA graph replays."""
  from ranking_tpu_torch.ops.cuda import pairwise as pw
  modes = {k: v for k, v in (('none', pw.LAMBDA_NONE),
                             ('v1', pw.LAMBDA_DCG_V1)) if k in lambda_modes}
  out = {'pairwise_sums_forward': {}, 'pairwise_sums_backward': {}}
  for b, l in shapes:
    d = _pairwise_inputs(gen, b, l)
    ops = [d[k] for k in _PAIR_OPERANDS]
    for mode, mode_id in modes.items():
      static = (pw.LOSS_LOGISTIC, mode_id, pw.DISCOUNT_LOG1P_INVERSE,
                float(l), 0.0)
      calls = {
          'pairwise_sums_forward':
              lambda: pw.pairwise_sums_forward(*ops, *static),
          'pairwise_sums_backward':
              lambda: pw.pairwise_sums_backward(*ops, *static, d['ct'])}
      for row, fn in calls.items():
        ms = _graph_ms(fn, calls=5, replays=10)
        with pw.plain_versions():
          plain_ms = _graph_ms(fn, calls=5, replays=10)
        bound_ms, bound_by = _pairwise_bounds(
            d, 'logistic', mode, row.endswith('backward'))
        out[row][f'B{b}xL{l} logistic {mode}'] = {
            'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
            'bound_by': bound_by}
  return out


# --- rows 9 and 10: the row scatter, and the sparse embedding step -----------


def _rows_case(gen, v, d, k, n, dtype, kind='mixed'):
  """n tables [V, D] and n slabs [K, D] on the card, ids unique among the
  slots (K <= V), flags: 1/8 of the slots invalid, and a few valid slots
  with ids < 0 or >= V, unless ``kind`` is 'all_valid' or 'all_invalid';
  'int64' adds int64 ids that an int32 cast would wrap into the table."""
  import torch
  dev = torch.device('cuda')
  tables = [torch.randn(v, d, device=dev, generator=gen).to(dtype)
            for _ in range(n)]
  updates = [torch.randn(k, d, device=dev, generator=gen).to(dtype)
             for _ in range(n)]
  ids = torch.randperm(v, device=dev, generator=gen)[:k].to(torch.int32)
  valid = torch.rand(k, device=dev, generator=gen) >= 0.125
  if kind == 'all_valid':
    valid[:] = True
  elif kind == 'all_invalid':
    valid[:] = False
  elif k >= 8:
    ids[:4] = torch.tensor([-1, -7, v, v + 12345], dtype=torch.int32,
                           device=dev)
    valid[:4] = True
  if kind == 'int64':
    ids = ids.to(torch.int64)
    ids[4:7] = torch.tensor([2 ** 32 + 5, 2 ** 31, -(2 ** 32) + 9],
                            device=dev)
    valid[4:7] = True
  return tables, updates, ids, valid


def _check_rows_kernels():
  """Phase 3f: rows 9 and 10 against their plain versions, bitwise on the
  whole tables, and every row no valid slot names keeps its bits. Returns
  (cases run, launches of rows 9 and 10 in this phase, largest |kernel -
  plain|)."""
  import torch
  from ranking_tpu_torch.ops.cuda import rows
  gen = torch.Generator(device='cuda').manual_seed(SEED)
  f32, bf16 = torch.float32, torch.bfloat16
  cases = [(f'flagship [{SPARSE_VOCAB}, {SPARSE_DIM}] K={ROWS_K} n={n}',
            SPARSE_VOCAB, SPARSE_DIM, ROWS_K, n, f32, 'mixed')
           for n in (1, 2, 3)]
  for n in (1, 3):
    cases += [(f'D=20 float32 n={n}', SPARSE_VOCAB, 20, ROWS_K, n, f32,
               'mixed'),
              (f'D=64 float32 n={n}', SPARSE_VOCAB, 64, ROWS_K, n, f32,
               'mixed'),
              (f'D=20 bfloat16 n={n}', SPARSE_VOCAB, 20, ROWS_K, n, bf16,
               'mixed')]
  cases += [('all slots invalid n=3', 100_000, SPARSE_DIM, 4096, 3, f32,
             'all_invalid'),
            ('K=1 n=2', 1000, SPARSE_DIM, 1, 2, f32, 'all_valid'),
            ('K=51203 D=128 bfloat16 n=2', 200_000, SPARSE_DIM, 51_203, 2,
             bf16, 'mixed'),
            ('K=V=4099 D=37 float32 n=3', 4099, 37, 4099, 3, f32, 'mixed'),
            ('int64 ids >= 2^31 n=1', 100_000, SPARSE_DIM, 4096, 1, f32,
             'int64'),
            ('int64 ids >= 2^31 n=3', 100_000, 20, 4096, 3, bf16, 'int64')]
  rows.reset_launches()
  max_abs_err = 0.0
  for name, v, d, k, n, dtype, kind in cases:
    tables, updates, ids, valid = _rows_case(gen, v, d, k, n, dtype, kind)
    before = [t.clone() for t in tables]
    want = [t.clone() for t in tables]
    with rows.plain_versions():
      rows.scatter_rows_multi(want, ids, valid, updates)
    got = rows.scatter_rows_multi(tables, ids, valid, updates)
    torch.cuda.synchronize()
    written = torch.zeros(v, dtype=torch.bool, device='cuda')
    ok = valid & (ids >= 0) & (ids < v)
    written[ids[ok].long()] = True
    for g, w, b, t in zip(got, want, before, tables):
      if g is not t:
        _fail(f'rows {name}: the kernel did not write in place')
      err = (g.float() - w.float()).abs().max().item()
      max_abs_err = max(max_abs_err, err)
      if not torch.equal(g, w):
        _fail(f'rows {name}: kernel != plain version (max |diff| {err})')
      if not torch.equal(g[~written], b[~written]):
        _fail(f'rows {name}: a row that no valid slot names changed')
    del tables, updates, before, want, got
  # A table of three dims: the sparse step's router hands the kernel a
  # [V, a*b] view of its storage, one launch for the three buffers.
  from ranking_tpu_torch.train import sparse as sparse_lib
  tables, updates, ids, valid = _rows_case(gen, 100_000, 40, 4096, 3, f32)
  tables = [t.view(100_000, 4, 10) for t in tables]
  updates = [u.view(4096, 4, 10) for u in updates]
  want = [t.clone() for t in tables]
  sparse_lib._scatter_rows_multi_auto(want, ids, valid, updates, False)
  before = rows.scatter_rows_multi.launches
  sparse_lib._scatter_rows_multi_auto(tables, ids, valid, updates, True)
  torch.cuda.synchronize()
  if rows.scatter_rows_multi.launches != before + 1:
    _fail('rows: a [V, 4, 10] table did not go through one launch of row 10')
  if not all(torch.equal(t, w) for t, w in zip(tables, want)):
    _fail('rows: a [V, 4, 10] table: kernel != plain version')
  cases.append(('[100000, 4, 10] tables through the router n=3',))
  del tables, updates, want
  launches = [fn.launches for fn in rows.KERNEL_WRAPPERS]
  # The multi wrapper's checks.
  t = [torch.zeros(10, 4, device='cuda') for _ in range(2)]
  u = [torch.zeros(3, 4, device='cuda') for _ in range(2)]
  ids = torch.arange(3, device='cuda')
  ok = torch.ones(3, dtype=torch.bool, device='cuda')
  for what, args in (
      ('equally many', (t, ids, ok, u[:1])),
      ('share shape/dtype', ([t[0], t[1].to(bf16)], ids, ok, u)),
      ('update slabs must share shape',
       (t, ids, ok, [u[0], torch.zeros(4, 4, device='cuda')])),
      ('ids/valid must be shape', (t, ids[:2], ok, u))):
    try:
      rows.scatter_rows_multi(*args)
    except ValueError as e:
      if what not in str(e):
        _fail(f'rows: scatter_rows_multi raised {e!r}, expected {what!r}')
    else:
      _fail(f'rows: scatter_rows_multi took operands it must refuse ({what})')
  torch.cuda.empty_cache()
  _log(f'kernel vs plain: rows 9-10, {len(cases)} cases bitwise equal on '
       f'the whole tables, untouched rows unchanged; launches {launches}; '
       'the multi wrapper refuses 4 kinds of mismatched operands')
  return len(cases), launches, max_abs_err


def _sparse_batch(gen):
  """B128 lists of L50 documents, 8 token ids each from the 3M vocabulary
  (1/8 of the slots padding, -1), a query of 8 ids; 20 to 50 valid
  documents a list, graded 0-4 labels, -1 on padded documents. Fed flat."""
  import torch
  from ranking_tpu_torch.data import batch as batch_lib
  from ranking_tpu_torch.data import dataset
  b, l, t = SPARSE_B, SPARSE_L, SPARSE_T
  labels, valid = _graded_labels(gen, b, l, SPARSE_MIN_LEN)

  def tokens(*shape):
    ids = torch.randint(0, SPARSE_VOCAB, shape, generator=gen,
                        dtype=torch.int32)
    return torch.where(torch.rand(shape, generator=gen) < 0.125, -1, ids)

  return dataset.flatten_examples(batch_lib.RankingBatch(
      context={'query_tokens': tokens(b, t)},
      examples={'document_tokens': tokens(b, l, t)},
      labels=labels, mask=valid))


def _sparse_model(gen):
  from ranking_tpu_torch.models import scorers
  return scorers.RankingModel(scorers.EmbeddingDNNScorer(
      SPARSE_HIDDEN, vocab_sizes={'query_tokens': SPARSE_VOCAB,
                                  'document_tokens': SPARSE_VOCAB},
      embedding_dim=SPARSE_DIM, dropout=0.0, use_batch_norm=False,
      generator=gen))


def _recording_updates(cls, record):
  """Inside, ``cls.update_rows`` appends its ``row_grads`` and
  ``row_params`` to ``record`` before it runs."""
  original = cls.update_rows

  def update_rows(self, row_grads, state, params, row_params=None):
    record.append((dict(row_grads), dict(row_params)))
    return original(self, row_grads, state, params, row_params)

  return mock.patch.object(cls, 'update_rows', update_rows)


def _touched_mask(row_grads, path):
  import torch
  uids, g, filled = row_grads[path]
  touched = filled & (g.abs().sum(dim=1) > 0)
  mask = torch.zeros(SPARSE_VOCAB, dtype=torch.bool, device=uids.device)
  mask[uids[touched].long()] = True
  return mask


def _sparse_tensors(state):
  """{name: tensor} of a sparse state's tables and moments."""
  from ranking_tpu_torch.train import sparse as sparse_lib
  tables = {p: t for p, t in sparse_lib.named_paths(state.model).items()
            if state.sparse_tx.matches(p)}
  out = {f'{p} table': t.detach() for p, t in tables.items()}
  for p in tables:
    out.update({f'{p} {k}': v for k, v in state.sparse_opt_state[p].items()})
  return out


def _hold_isolated_update(what, sparse_tx, state, row_grads, row_params):
  """update_rows on two clones of ``state``'s tables and moments with the
  same slab gradients: the kernel, then the plain versions, bitwise."""
  import torch
  from ranking_tpu_torch.ops.cuda import rows
  from ranking_tpu_torch.train import sparse as sparse_lib
  results = []
  for plain in (False, True):
    tables = {p: t.detach().clone()
              for p, t in sparse_lib.named_paths(state.model).items()
              if sparse_tx.matches(p)}
    opt = {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict)
               else v.clone()) for k, v in state.sparse_opt_state.items()}
    before = [fn.launches for fn in rows.KERNEL_WRAPPERS]
    with rows.plain_versions() if plain else contextlib.nullcontext():
      sparse_tx.update_rows(row_grads, opt, tables, row_params=row_params)
    launched = [a - b for a, b in zip(
        [fn.launches for fn in rows.KERNEL_WRAPPERS], before)]
    if launched != ([0, 0] if plain else [0, len(tables)]):
      _fail(f'{what}: the isolated update launched rows 9-10 {launched}')
    results.append((tables, opt))
  (kt, ko), (pt, po) = results
  for p in kt:
    if not torch.equal(kt[p], pt[p]):
      _fail(f'{what}: isolated update of {p}: kernel != plain scatter')
    for n in ko[p]:
      if not torch.equal(ko[p][n], po[p][n]):
        _fail(f'{what}: isolated update of {p} {n}: kernel != plain scatter')
  _log(f'{what}: the first step\'s update_rows on two clones of the state, '
       'kernel vs plain scatter: tables and moments bitwise equal')


def _sparse_path(gen, recipe):
  """Phases 13 (recipe 'A': LazyAdam + adam) and 14 ('B': LazyAdagrad +
  adagrad): the sparse step at full width. Returns (launch counts of rows
  9-10 and of every other kernel over the run, state, step fn, batch,
  numbers)."""
  import copy
  import torch
  from ranking_tpu_torch.ops import loss_registry
  from ranking_tpu_torch.ops.cuda import rows
  from ranking_tpu_torch.train import sparse as sparse_lib
  from ranking_tpu_torch.train import state as state_lib
  from ranking_tpu_torch.train import steps
  lazy_adam = recipe == 'A'
  num_steps = SPARSE_STEPS[recipe]
  if lazy_adam:
    tx_cls = sparse_lib.LazyAdam
    make_tx = lambda: (state_lib.adam(1e-3),  # noqa: E731
                       sparse_lib.LazyAdam(1e-3))
  else:
    tx_cls = sparse_lib.LazyAdagrad
    make_tx = lambda: (state_lib.adagrad(1e-3),  # noqa: E731
                       sparse_lib.LazyAdagrad(1e-3))
  what = f'sparse recipe {recipe}'
  t0 = time.perf_counter()
  model = _sparse_model(gen)
  twin = copy.deepcopy(model)
  batch = _sparse_batch(gen)
  efs = sparse_lib.derive_embed_features(
      sparse_lib.named_paths(model), batch.context,
      steps.restore_flat_examples(batch).examples)
  step = steps.make_sparse_train_step(
      loss_registry.make_loss_fn('softmax_loss'), efs, device='cuda')
  dense_tx, sparse_tx = make_tx()
  state = state_lib.create_train_state(model, dense_tx, device='cuda',
                                       sparse_tx=sparse_tx)
  dense_tx, sparse_tx = make_tx()
  twin_state = state_lib.create_train_state(twin, dense_tx, device='cuda',
                                            sparse_tx=sparse_tx)
  torch.cuda.synchronize()
  setup_s = time.perf_counter() - t0
  paths = sorted(ef.param_path for ef in efs)

  # The first step through the plain scatter, on the twin.
  twin_record = []
  with rows.plain_versions(), _recording_updates(tx_cls, twin_record):
    twin_state, twin_metrics = step(twin_state, batch)
  twin_grads = {k: p.grad for k, p in twin_state.model.named_parameters()
                if p.grad is not None}
  # The same slab gradients through update_rows, kernel vs plain.
  _hold_isolated_update(what, state.sparse_tx, state, *twin_record[0])
  dense_before = {k: p.detach().clone()
                  for k, p in state.model.named_parameters()
                  if not state.sparse_tx.matches(k.replace('.', '/'))}

  # The main path of this slice: every count starts at 0 here.
  record = []
  losses = []
  first = {}
  _reset_all_launches()
  peak_mib = 0.0
  with _recording_updates(tx_cls, record):
    for i in range(num_steps):
      torch.cuda.synchronize()
      torch.cuda.reset_peak_memory_stats()
      before_step = torch.cuda.memory_allocated()
      state, metrics = step(state, batch)
      losses.append(metrics['loss'].item())
      peak_mib = max(peak_mib, (torch.cuda.max_memory_allocated()
                                - before_step) / 2 ** 20)
      if i == 0:
        first = _hold_sparse_first_step(what, state, twin_state, metrics,
                                        twin_metrics, record[0],
                                        twin_record[0], twin_grads, paths)
        if not lazy_adam:
          first['adagrad_f64_err_ulps'] = _hold_adagrad_f64(
              state, dense_before, 1e-3)
  launches = [fn.launches for fn in rows.KERNEL_WRAPPERS]
  others = _all_launch_counts()
  torch.cuda.synchronize()

  if not all(math.isfinite(v) for v in losses):
    _fail(f'{what}: a loss is not finite: {losses}')
  if not losses[-1] < losses[0]:
    _fail(f'{what}: the loss did not fall in {num_steps} steps on a repeated '
          f'batch: {losses}')
  n_bufs = 3 if lazy_adam else 2
  if launches != [0, 2 * num_steps]:
    _fail(f'{what}: rows 9-10 launched {launches} in {num_steps} steps, '
          f'expected [0, {2 * num_steps}] (one n={n_bufs} launch per table '
          'per step)')
  if any(others):
    _fail(f'{what}: another kernel launched {others}')
  if int(state.sparse_opt_state['count']) != num_steps:
    _fail(f'{what}: count {int(state.sparse_opt_state["count"])} after '
          f'{num_steps} steps')
  # The lazy contract after every step: a row that no step touched keeps
  # its bits in the table and its moments (the twin's plain step left its
  # own untouched rows alone, and the moments started at a constant).
  ours, theirs = _sparse_tensors(state), _sparse_tensors(twin_state)
  start = {'m': 0.0, 'v': 0.0, 'acc': 0.1}
  for p in paths:
    never = torch.ones(SPARSE_VOCAB, dtype=torch.bool, device='cuda')
    for grads, _ in record:
      never &= ~_touched_mask(grads, p)
    for name, t in ours.items():
      if not name.startswith(p + ' '):
        continue
      kind = name.split(' ')[-1]
      if kind == 'table':
        if not torch.equal(t[never], theirs[name][never]):
          _fail(f'{what}: an untouched row of {p} changed')
      elif not bool((t[never] == start[kind]).all()):
        _fail(f'{what}: an untouched row of {p} {kind} changed')
    first[f'untouched_rows {p}'] = int(never.sum())
  _log(f'{what}: {num_steps} steps at B={SPARSE_B}, L={SPARSE_L}, '
       f'T={SPARSE_T}, two [{SPARSE_VOCAB}, {SPARSE_DIM}] tables, loss '
       f'{losses[0]:.6f} -> {losses[-1]:.6f}; rows 9-10 launches {launches} '
       f'({launches[1] // num_steps} per step, n={n_bufs}); '
       f'untouched rows bit for bit; a step peaks {peak_mib:.1f} MiB of '
       f'device memory above what it starts with; set-up {setup_s:.1f} s')
  del twin_state, twin, ours, theirs
  torch.cuda.empty_cache()
  first.update(step_peak_mib=peak_mib, losses=losses, setup_s=setup_s)
  return launches, state, step, batch, first


def _hold_sparse_first_step(what, state, twin_state, metrics, twin_metrics,
                            rec, twin_rec, twin_grads, paths):
  """The kernel step's first step against the twin's plain-scatter step:
  slot ids, slot flags and the touched-row set equal; the loss, the
  gradients (dense and slab) and the tables and moments after the step
  within SPARSE_TOL of the largest value; dense gradients zero in theory
  within 1e-6."""
  import torch
  errs = {'loss': abs(metrics['loss'].item() - twin_metrics['loss'].item())
          / abs(twin_metrics['loss'].item())}
  (grads, _), (twin_grads_rows, _) = rec, twin_rec
  worst_grad = 0.0
  for p in paths:
    (u, g, f), (tu, tg, tf) = grads[p], twin_grads_rows[p]
    if not (torch.equal(u, tu) and torch.equal(f, tf)):
      _fail(f'{what}: slot ids or flags of {p} differ from the plain step')
    if not torch.equal(_touched_mask(grads, p), _touched_mask(twin_grads_rows,
                                                              p)):
      _fail(f'{what}: the touched rows of {p} differ from the plain step')
    worst_grad = max(worst_grad, _rel_err(g, tg)[1])
  for k, p in state.model.named_parameters():
    if p.grad is None:
      continue
    g, w = p.grad, twin_grads[k]
    if w.abs().max().item() < 1e-6:
      if (g - w).abs().max().item() > 1e-6:
        _fail(f'{what}: zero gradient {k} off by more than 1e-6')
      continue
    worst_grad = max(worst_grad, _rel_err(g, w)[1])
  errs['gradients'] = worst_grad
  ours, theirs = _sparse_tensors(state), _sparse_tensors(twin_state)
  errs['tables_and_moments'] = max(_rel_err(ours[k], theirs[k])[1]
                                   for k in ours)
  twin_params = dict(twin_state.model.named_parameters())
  errs['dense_parameters'] = max(
      _rel_err(p.detach(), twin_params[k].detach())[1]
      for k, p in state.model.named_parameters() if p.grad is not None)
  bad = {k: v for k, v in errs.items() if not v <= SPARSE_TOL}
  if bad:
    _fail(f'{what}: first step vs the plain-scatter step off by {bad} '
          f'(allowed {SPARSE_TOL})')
  _log(f'{what}: first step vs the plain-scatter step on the card: slot ids, '
       'flags and touched rows equal; ' + ', '.join(
           f'{k} within {v:.3g}' for k, v in errs.items()))
  return {f'first_step_err_{k}': v for k, v in errs.items()}


def _hold_adagrad_f64(state, before, lr):
  """The port's adagrad against its float64 recomputation on the card: one
  step from a fresh accumulator of 0.1, eps 1e-7. Returns the largest error
  in float32 ulps of the largest parameter."""
  import torch
  worst = 0.0
  for k, p in state.model.named_parameters():
    if k not in before:
      continue
    g = p.grad.to(torch.float64)
    acc = 0.1 + g * g
    want = before[k].to(torch.float64) - lr * g * torch.rsqrt(acc + 1e-7)
    ulp = torch.finfo(torch.float32).eps * want.abs().max().item()
    worst = max(worst, (p.detach().to(torch.float64) - want).abs().max()
                .item() / ulp)
  if worst > 4.0:
    _fail(f'adagrad vs float64 on the card: off by {worst:.3g} ulps of the '
          'largest parameter (allowed 4)')
  _log(f'adagrad vs float64 on the card: within {worst:.3g} ulps of the '
       'largest parameter')
  return worst


def _rows_bound(n, valid_rows, d, k, elem=4):
  """(bound_ms, 'bytes'): n tables' rows read from the slabs and written to
  the tables, plus the id stream (int32 ids, one flag byte), over HBM. A
  copy does no arithmetic."""
  return ((n * valid_rows * d * elem * 2 + k * 5) / HBM_BYTES_PER_S * 1e3,
          'bytes')


def _time_rows():
  """Phase 15a: rows 9 and 10 at the flagship table, K=51200, every slot
  valid: {case: {'ms', 'plain_ms', 'library_ms', 'bound_ms', 'bound_by'}}.
  Device time from CUDA graph replays for the kernel and the library call
  (one index_copy_ a table); the plain version synchronises to pick its
  slots, so it is timed eagerly by CUDA events."""
  import torch
  from ranking_tpu_torch.ops.cuda import rows
  gen = torch.Generator(device='cuda').manual_seed(SEED + 1)
  tables, updates, ids, valid = _rows_case(
      gen, SPARSE_VOCAB, SPARSE_DIM, ROWS_K, 3, torch.float32, 'all_valid')
  ids64 = ids.long()
  out = {}
  for n in (1, 2, 3):
    t, u = tables[:n], updates[:n]
    call = lambda: rows.scatter_rows_multi(t, ids, valid, u)  # noqa: E731

    def library():
      for table, rows_in in zip(t, u):
        table.index_copy_(0, ids64, rows_in)

    ms = _graph_ms(call, calls=10, replays=10)
    with rows.plain_versions():
      plain_ms = _event_ms(call, 10, warmup=2)
    library_ms = _graph_ms(library, calls=10, replays=10)
    bound_ms, bound_by = _rows_bound(n, ROWS_K, SPARSE_DIM, ROWS_K)
    out[f'n={n}'] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
    if n == 1:
      # Row 9 against index_copy_ in turns (kernel, library, library,
      # kernel, ...): one reading of each is within the spread of the other.
      pairs = []
      for rep in range(5):
        order = (call, library) if rep % 2 == 0 else (library, call)
        times = {fn: _graph_ms(fn, calls=10, replays=10) for fn in order}
        pairs.append((times[call], times[library]))
      ratio = statistics.median(k / lib for k, lib in pairs)
      out['n=1'].update(parity_pairs=pairs, parity_median_ratio=ratio)
      _log('row 9 vs index_copy_, 5 alternating repetitions (kernel ms, '
           'library ms): ' + ', '.join(f'({k:.5f}, {lib:.5f})'
                                       for k, lib in pairs)
           + f'; median kernel / library {ratio:.4f}')
  del tables, updates
  torch.cuda.empty_cache()
  return out


def _time_compact_unique(batch):
  """Phase 15b: device ms of the step's two compact_unique calls (the
  document table's 51200 ids and the query table's 1024)."""
  import torch
  from ranking_tpu_torch.train import sparse as sparse_lib
  dev_batch = batch.to(torch.device('cuda'))
  flats = [dev_batch.examples['document_tokens'].reshape(-1),
           dev_batch.context['query_tokens'].reshape(-1)]
  return _graph_ms(lambda: [sparse_lib.compact_unique(f) for f in flats],
                   calls=10, replays=10)


# --- phase 16: K steps a dispatch, one captured step replayed ----------------

KSTEPS = 10                       # steps a dispatch, the pipeline's default
# The pipeline phase: MSLR-WEB30K-shaped LIBSVM files written from the seed
# (every row lists all 136 features; 20 to 200 documents a list, labels
# 0-4). MSLR-WEB30K Fold1 trains on 18,919 queries; 1,280 train and 256
# validation lists keep the files near 180 and 36 MB and the phase inside
# the script's time limit: a cut of scale, not of shape.
PIPE_TRAIN_LISTS, PIPE_VALID_LISTS = 1280, 256
PIPE_MIN_DOCS = 20
PIPE_EPOCHS, PIPE_RESUMED_EPOCHS = 2, 3
# An epoch is five passes over the train lists (the stream repeats), so
# that each epoch makes 5 dispatches: after the first run's warm-up and
# capture, 9 dispatches that only replay, the steady-state window.
PIPE_STEPS_PER_EPOCH = 5 * (PIPE_TRAIN_LISTS // B)


def _state_tensors(state):
  """Every tensor a train step changes, by name: parameters and buffers,
  the dense optimizer's moments, step tensors, rate and count, and the
  lazy-row optimizer's moments and count."""
  import torch
  out = {f'model/{k}': v for k, v in state.model.state_dict().items()}
  names = {id(p): k for k, p in state.model.named_parameters()}
  for p, st in state.optimizer.state.items():
    for k, v in st.items():
      if torch.is_tensor(v):
        out[f'optimizer/{names[id(p)]}/{k}'] = v
  out['optimizer/lr'] = state.optimizer.lr
  out['optimizer/count'] = state.optimizer.count
  for path, v in (state.sparse_opt_state or {}).items():
    for k, t in (v.items() if isinstance(v, dict) else [('', v)]):
      out[f'sparse/{path}/{k}'] = t
  return out


def _state_diff(a, b):
  """(names that differ, largest |a - b| as a share of the largest |b|)."""
  ta, tb = _state_tensors(a), _state_tensors(b)
  if set(ta) != set(tb):
    _fail(f'state structures differ: {sorted(set(ta) ^ set(tb))}')
  differ = [k for k in ta if not ta[k].equal(tb[k])]
  worst = max((_rel_err(ta[k].float(), tb[k].float())[1] for k in differ),
              default=0.0)
  return differ, worst


def _kernel_counts(fn):
  """How often each of the port's kernels ran on the card during one call
  of ``fn``, by name, from ``torch.profiler``'s device events."""
  import collections
  import torch
  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    # A device operation and a wait before ``fn``: a run once lost the
    # first kernels of a graph replay, as if the tracing had not yet
    # started on the card when the replay began.
    torch.ones(1, device='cuda').add_(1)
    torch.cuda.synchronize()
    fn()
    torch.cuda.synchronize()
  counts = collections.Counter(
      k for e in prof.events()
      if e.device_type == torch.autograd.DeviceType.CUDA
      and not getattr(e, 'is_user_annotation', False)
      for k in _PORT_KERNELS if re.search(rf'\b{k}\b', e.name))
  return dict(counts)


# The __global__ functions of ranking_tpu_torch/ops/cuda/csrc.
_PORT_KERNELS = ('rank_sort_kernel', 'layer_forward_kernel',
                 'split_weight_kernel', 'reduce_partials_kernel',
                 'bwd_stats_kernel', 'bwd_dx_kernel', 'over_rows_kernel',
                 'pairwise_fwd_kernel', 'pairwise_finalize_kernel',
                 'pairwise_bwd_kernel', 'scatter_rows_kernel')


def _kstep_recipes(gen):
  """(name, make_state, step fn, 2 x KSTEPS flat host batches, per-step
  wrapper launches, whether the step takes a generator, a hook applied to
  the state between the first dispatch and the held one, whether the
  recipe is timed) of the three train steps at their full shapes, then
  the softmax step under the optimizer hooks that one graph must serve: a
  warmup + linear-decay schedule with global-norm clipping (from
  ``PipelineHparams``, as the pipeline builds it), and a constant rate
  with clipping whose rate tensor is scaled by 0.1 between the two
  dispatches (the plateau hook). The LambdaRank step draws its rank-tie
  shuffles from a CUDA generator, as the pipeline's steps do."""
  import copy
  import torch
  from ranking_tpu_torch.data import dataset
  from ranking_tpu_torch.ops import lambda_weights as lw
  from ranking_tpu_torch.ops import loss_registry
  from ranking_tpu_torch.pipeline import hparams as hparams_lib
  from ranking_tpu_torch.train import sparse as sparse_lib
  from ranking_tpu_torch.train import state as state_lib
  from ranking_tpu_torch.train import steps
  fused = {'layer_forward': 3, 'bwd_stats': 1, 'bwd_mats': 2}
  for name, loss in (('softmax', 'softmax_loss'),
                     ('lambdarank', 'pairwise_logistic_loss')):
    extra = {} if name == 'softmax' else {
        'lambda_weight': lw.create_ndcg_lambda_weight()}
    step = steps.make_train_step(loss_registry.make_loss_fn(loss, **extra),
                                 device='cuda')
    batches = [dataset.flatten_examples(_make_batch(gen, B))
               for _ in range(2 * KSTEPS)]
    model = _train_model(gen)
    make = lambda model=model: state_lib.create_train_state(  # noqa: E731
        model, state_lib.adam(1e-3), device='cuda')
    launches = dict(fused) if name == 'softmax' else dict(
        fused, pairwise_sums_forward=1, pairwise_sums_backward=1,
        sorted_values_and_ranks=1)
    yield (name, make, step, batches, launches, name == 'lambdarank', None,
           True)
  batches = [_sparse_batch(gen) for _ in range(2 * KSTEPS)]
  model = _sparse_model(gen)
  efs = sparse_lib.derive_embed_features(
      sparse_lib.named_paths(model), batches[0].context,
      steps.restore_flat_examples(batches[0]).examples)
  step = steps.make_sparse_train_step(
      loss_registry.make_loss_fn('softmax_loss'), efs, device='cuda')
  make = lambda: state_lib.create_train_state(  # noqa: E731
      model, state_lib.adam(1e-3), device='cuda',
      sparse_tx=sparse_lib.LazyAdam(1e-3))
  yield ('sparse_a', make, step, batches, {'scatter_rows_multi': 2}, False,
         None, True)
  del batches, model, efs
  # The hooks' recipes draw from a generator of their own, so that the
  # pipeline phase keeps its inputs.
  hooks_gen = torch.Generator().manual_seed(SEED + 3)
  step = steps.make_train_step(loss_registry.make_loss_fn('softmax_loss'),
                               device='cuda')
  batches = [dataset.flatten_examples(_make_batch(hooks_gen, B))
             for _ in range(2 * KSTEPS)]
  model = _train_model(hooks_gen)
  for name, kw, between in (
      ('softmax_schedule_clip',
       dict(lr_schedule='linear_decay', warmup_steps=5,
            num_epochs=1, steps_per_epoch=3 * KSTEPS), None),
      ('softmax_plateau_clip', {}, lambda state: state.optimizer.lr.mul_(0.1))):
    hp = hparams_lib.PipelineHparams(
        model_dir='unused', validation_steps=1, learning_rate=1e-3,
        loss='softmax_loss', gradient_clip_norm=1.0,
        **dict(dict(num_epochs=1, steps_per_epoch=1), **kw))
    make = lambda model=model, hp=hp: state_lib.create_train_state(  # noqa: E731
        copy.deepcopy(model), hparams_lib.optimizer_from_hparams(hp),
        device='cuda')
    yield name, make, step, batches, fused, False, between, False


def _kstep_phase(gen):
  """Phase 16: K = 10 steps a dispatch through ``make_multi_step``, one
  captured step replayed, for the softmax, LambdaRank and sparse (recipe
  A) steps at their full shapes, and for the softmax step under a
  warmup + linear-decay schedule with clipping and under a constant rate
  with clipping scaled by 0.1 between dispatches. A first dispatch warms
  up and captures (then a recipe's hook acts on the state); a copy of the
  state then takes 10 eager steps while the state takes 10 replays on the
  same batches, and the two must be bitwise equal (every parameter,
  buffer, moment, step tensor, rate, table and count, and the per-step
  losses), unless two eager runs already differ (a step with atomics),
  where the graph is held within the recipe's tolerance. The LambdaRank
  step reads a CUDA generator registered with its graph; each eager copy
  starts from a copy of the generator's state. For the three timed steps
  the port's kernels that one replay runs, by ``torch.profiler``'s names,
  must equal those of one eager step, and the wrappers' launches recorded
  at capture must equal the per-step counts of phases 7, 10 and 13. Times:
  ms a step by CUDA events around whole dispatches, graph and eager; host
  ms a dispatch; the device's idle share within a dispatch."""
  import copy
  import torch
  from ranking_tpu_torch.train import steps
  out = {}
  for (name, make, step, batches, launches, random, between,
       timed) in _kstep_recipes(gen):
    warm = steps.stack_batches(batches[:KSTEPS]).to('cuda')
    run = steps.stack_batches(batches[KSTEPS:]).to('cuda')
    state = make()
    rng = (torch.Generator(device='cuda').manual_seed(SEED) if random
           else None)

    def rng_copy():
      if rng is None:
        return None
      out = torch.Generator(device='cuda')
      out.set_state(rng.get_state())
      return out

    graphed = steps.make_multi_step(step, device='cuda')
    eager = steps.make_multi_step(step, device='cuda', eager=True)
    state, _ = graphed(state, warm, rng)
    if graphed.captures != 1 or graphed.replays != KSTEPS - graphed.warmup:
      _fail(f'{name}: {graphed.captures} captures and {graphed.replays} '
            f'replays in the first dispatch')
    if graphed.captured_launches != launches:
      _fail(f'{name}: launches recorded at capture '
            f'{graphed.captured_launches} != per-step {launches}')
    lr_before = state.optimizer.lr.clone()
    if between is not None:
      between(state)
    twins = [copy.deepcopy(state), copy.deepcopy(state)]
    twin_rngs = [rng_copy(), rng_copy()]
    torch.cuda.synchronize()
    state, graph_metrics = graphed(state, run, rng)
    if graphed.captures != 1:
      _fail(f'{name}: the second dispatch captured again')
    twins[0], eager_metrics = eager(twins[0], run, twin_rngs[0])
    twins[1], _ = eager(twins[1], run, twin_rngs[1])
    torch.cuda.synchronize()
    repeats = not _state_diff(twins[0], twins[1])[0]
    differ, worst = _state_diff(state, twins[0])
    losses_equal = torch.equal(graph_metrics['loss'], eager_metrics['loss'])
    tol = 0.0 if repeats else SPARSE_TOL
    if (repeats and (differ or not losses_equal)) or worst > tol:
      _fail(f'{name}: {KSTEPS} replays vs {KSTEPS} eager steps: '
            f'{len(differ)} tensors differ ({differ[:4]}), worst '
            f'{worst:.3g}, losses equal {losses_equal}; two eager runs '
            f'repeat each other: {repeats}')
    if not timed:
      # The hooks must have acted: the rate moved (the schedule) or is the
      # scaled one (the plateau hook), and the clip bound the eager twin's
      # last gradients (their global norm is the clip norm).
      opt = state.optimizer
      lr_now = opt.lr.item()
      if between is None:
        if lr_now == lr_before.item():
          _fail(f'{name}: the scheduled rate did not move ({lr_now})')
      elif not torch.equal(opt.lr, lr_before * 0.1):
        _fail(f'{name}: rate {lr_now} after the plateau hook, not '
              f'{(lr_before * 0.1).item()}')
      grads = [p.grad for p in twins[0].model.parameters()
               if p.grad is not None]
      norm = torch.sqrt(sum(torch.sum(g * g) for g in grads)).item()
      if abs(norm - opt.clip_norm) > 1e-4 * opt.clip_norm:
        _fail(f'{name}: the last eager step\'s clipped global norm is '
              f'{norm}, not the clip norm {opt.clip_norm}')
      out[name] = {'bitwise': repeats, 'max_rel_diff': worst,
                   'lr_first_dispatch_end': lr_before.item(),
                   'lr_end': lr_now, 'clipped_global_norm': norm}
      _log(f'K-step {name}: {KSTEPS} replays == {KSTEPS} eager steps '
           + ('bitwise' if repeats else f'within {worst:.3g}')
           + f'; rate {lr_before.item():.6g} -> {lr_now:.6g}'
           + (' (scaled by 0.1 between the dispatches)' if between else '')
           + f'; clipped global norm {norm:.6f}')
      del state, twins, graphed, eager, warm, run
      torch.cuda.empty_cache()
      continue
    twins.pop()
    # Kernels a replay runs against kernels an eager step runs.
    one = steps.stack_batches(batches[:1]).to('cuda')
    replay_counts = _kernel_counts(lambda: graphed(state, one, rng))
    eager_counts = _kernel_counts(lambda: eager(twins[0], one,
                                                twin_rngs[0]))
    if not eager_counts or replay_counts != eager_counts:
      _fail(f'{name}: kernels of one replay {replay_counts} != one eager '
            f'step {eager_counts}')
    graph_fn = lambda: graphed(state, run, rng)  # noqa: E731
    eager_fn = lambda: eager(twins[0], run, twin_rngs[0])  # noqa: E731
    t = {'graph_ms_per_step': _event_ms(graph_fn, 3, warmup=1) / KSTEPS,
         'eager_ms_per_step': _event_ms(eager_fn, 3, warmup=1) / KSTEPS}
    for kind, fn in (('graph', graph_fn), ('eager', eager_fn)):
      host = []
      for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
      torch.cuda.synchronize()
      wall = _host_ms(fn, 3, warmup=1)
      device = _profile(fn, calls=1)['device_ms']
      t[f'{kind}_host_ms_per_dispatch'] = statistics.median(host)
      t[f'{kind}_wall_ms_per_dispatch'] = wall
      t[f'{kind}_device_ms_per_dispatch'] = device
      t[f'{kind}_device_idle_share'] = 1.0 - device / wall
    t.update(bitwise=repeats, max_rel_diff=worst,
             kernels_per_replay=replay_counts,
             launches_per_step=graphed.captured_launches)
    out[name] = t
    _log(f'K-step {name}: {KSTEPS} replays == {KSTEPS} eager steps '
         + ('bitwise' if repeats else f'within {worst:.3g} (two eager runs '
            'differ: atomics)')
         + f'; kernels per replay == per eager step {replay_counts}; '
         f'ms a step {t["graph_ms_per_step"]:.4f} graph, '
         f'{t["eager_ms_per_step"]:.4f} eager; host ms a dispatch '
         f'{t["graph_host_ms_per_dispatch"]:.3f} / '
         f'{t["eager_host_ms_per_dispatch"]:.3f}; idle share '
         f'{t["graph_device_idle_share"]:.3f} / '
         f'{t["eager_device_idle_share"]:.3f}')
    del state, twins, graphed, eager, warm, run, one
    torch.cuda.empty_cache()
  return out


# --- phase 17: the pipeline end to end ----------------------------------------


def _count_records(path):
  """Records in a TFRecord file (8-byte length, 4-byte length CRC, the
  payload, 4-byte payload CRC)."""
  import struct
  n = 0
  with open(path, 'rb') as f:
    while True:
      header = f.read(12)
      if len(header) < 12:
        return n
      f.seek(struct.unpack('<Q', header[:8])[0] + 4, 1)
      n += 1


# The __global__ function that each kernel wrapper launches once a call
# (its other kernels are shared with other wrappers).
_ENTRY_KERNEL = {
    'sorted_values_and_ranks': 'rank_sort_kernel',
    'layer_forward': 'layer_forward_kernel', 'bwd_stats': 'bwd_stats_kernel',
    'bwd_mats': 'bwd_dx_kernel', 'bwd_dx_only': 'bwd_dx_kernel',
    'bwd_dw_only': 'over_rows_kernel',
    'pairwise_sums_forward': 'pairwise_fwd_kernel',
    'pairwise_sums_backward': 'pairwise_bwd_kernel',
    'scatter_rows': 'scatter_rows_kernel',
    'scatter_rows_multi': 'scatter_rows_kernel'}


class _TimedDispatches:
  """Wraps a pipeline's ``GraphedSteps``: CUDA events around each dispatch
  that only replays (no warm-up step, no capture), kept with the step it
  started at and its lists."""

  def __init__(self, inner):
    self.inner, self.spans = inner, []

  def __getattr__(self, name):
    return getattr(self.inner, name)

  def __call__(self, state, batch, generator=None):
    import torch
    first, replays = state.step, self.inner.replays
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = self.inner(state, batch, generator)
    end.record()
    steps, lists = batch.mask.shape[:2]
    if self.inner.replays - replays == steps:
      self.spans.append((first, steps * lists, start, end))
    return out


def _steady_state(spans, steps_per_epoch):
  """lists/s of the replay-only dispatches: over each epoch's window (from
  its first such dispatch's start to its last one's end on the card, the
  host feed between them included) and over the dispatches alone."""
  windows = {}
  for first, lists, start, end in spans:
    windows.setdefault(first // steps_per_epoch, []).append(
        (lists, start, end))
  per_window = []
  for epoch, items in sorted(windows.items()):
    lists = sum(n for n, _, _ in items)
    ms = items[0][1].elapsed_time(items[-1][2])
    per_window.append({'epoch': epoch + 1, 'dispatches': len(items),
                       'lists': lists, 'ms': ms,
                       'lists_per_s': lists / ms * 1e3})
  lists = sum(w['lists'] for w in per_window)
  dispatch_ms = [start.elapsed_time(end) for _, _, start, end in spans]
  return {'windows': per_window,
          'loop_lists_per_s': lists / sum(w['ms'] for w in per_window) * 1e3,
          'dispatch_ms': dispatch_ms,
          'dispatch_lists_per_s': lists / sum(dispatch_ms) * 1e3}


def _card_launches(what, before, between, after, multi_step,
                   device_counts, eval_step):
  """Each wrapper's own kernel on the card in a profiled run (the counts
  from ``between`` to ``after``, ``device_counts`` its device events)
  against what the wrappers recorded in it: their eager calls, what
  ``multi_step``'s capture recorded times its replays, and what each of
  ``eval_step``'s captures recorded times its replays (all of them in the
  profiled run). Returns (wrapper launches from ``before`` to ``after``,
  each wrapper's kernel launches on the card in the profiled run)."""
  wrappers = {n: after[n] - before[n] for n in after}
  measured = {}
  eval_captured = eval_step.captured_launches()
  eval_replayed = eval_step.replayed_launches()
  for name, kernel in _ENTRY_KERNEL.items():
    recorded = after[name] - between[name]
    expected = (recorded + multi_step.captured_launches.get(name, 0) * (
        multi_step.replays - 1) + eval_replayed.get(name, 0)
                - eval_captured.get(name, 0))
    sharing = [n for n, k in _ENTRY_KERNEL.items()
               if k == kernel and n != name and wrappers[n]]
    got = device_counts.get(kernel, 0) if wrappers[name] else 0
    if wrappers[name] and sharing:
      _fail(f'{what}: {name} and {sharing} both ran; {kernel} cannot be '
            'told apart')
    if got != expected:
      _fail(f'{what}: {kernel} ran {got} times in the profiled run; the '
            f'wrapper {name} recorded {recorded} calls, the train graph '
            f'replayed {multi_step.replays} times and the eval graphs '
            f'{eval_step.replays}: {expected}')
    measured[name] = got
  return wrappers, measured


def _pipeline_phase(gen):
  """Phase 17: ``SimplePipeline.train_and_validate`` over LIBSVM files on
  the card: 2 epochs, timed (steady-state lists/s from CUDA events around
  the dispatches that only replay), then a new pipeline resumed from the
  checkpoint to 3 epochs under ``torch.profiler``, whose device events
  count the port's kernels that ran. Returns (numbers, wrapper launches in
  both runs, each wrapper's kernel launches on the card in the resumed
  run)."""
  import os
  import shutil
  import torch
  from ranking_tpu_torch.data import dataset
  from ranking_tpu_torch.data import libsvm
  from ranking_tpu_torch.data import native
  from ranking_tpu_torch.pipeline import hparams as hparams_lib
  from ranking_tpu_torch.pipeline import pipeline as pipeline_lib
  from ranking_tpu_torch.pipeline import serving
  from ranking_tpu_torch.train import checkpoint
  from ranking_tpu_torch.train import steps
  root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      '.scratch', 'chip_smoke_pipeline')
  shutil.rmtree(root, ignore_errors=True)
  os.makedirs(root)
  out = {}
  try:
    paths = {}
    t0 = time.perf_counter()
    for split, lists, seed in (('train', PIPE_TRAIN_LISTS, SEED + 7),
                               ('vali', PIPE_VALID_LISTS, SEED + 8)):
      paths[split] = os.path.join(root, f'{split}.txt')
      libsvm.write_random_lists(paths[split], lists, F, PIPE_MIN_DOCS, L,
                                seed=seed)
    out['write_s'] = time.perf_counter() - t0
    out['file_mb'] = {k: os.path.getsize(p) / 1e6 for k, p in paths.items()}
    parses = native.parses
    t0 = time.perf_counter()
    builder = pipeline_lib.LibSVMDatasetBuilder(
        paths['train'], paths['vali'], L, F, B, seed=SEED)
    out['parse_s'] = time.perf_counter() - t0
    if native.parses != parses + 2:
      _fail('the LIBSVM files were not parsed by the native parser')
    out['parse_mb_per_s'] = sum(out['file_mb'].values()) / out['parse_s']
    _log(f'pipeline: wrote {PIPE_TRAIN_LISTS} + {PIPE_VALID_LISTS} lists '
         f'({out["file_mb"]["train"]:.1f} + {out["file_mb"]["vali"]:.1f} MB) '
         f'in {out["write_s"]:.2f} s (cut of scale: MSLR-WEB30K Fold1 trains '
         f'on 18,919 queries); native parse {out["parse_s"]:.2f} s, '
         f'{out["parse_mb_per_s"]:.1f} MB/s')
    steps_per_epoch = PIPE_STEPS_PER_EPOCH

    def hparams(epochs):
      return hparams_lib.PipelineHparams(
          model_dir=os.path.join(root, 'model'), num_epochs=epochs,
          steps_per_epoch=steps_per_epoch, validation_steps=10 ** 6,
          learning_rate=1e-3, loss='softmax_loss',
          steps_per_execution=KSTEPS, resume_dataset=True)

    timed = []
    make_multi_step = steps.make_multi_step

    def make_timed(*args, **kwargs):
      timed.append(_TimedDispatches(make_multi_step(*args, **kwargs)))
      return timed[-1]

    before = steps.kernel_launch_counts()
    t0 = time.perf_counter()
    pipe = pipeline_lib.SimplePipeline(_train_model(gen), builder,
                                       hparams(PIPE_EPOCHS), device='cuda')
    with mock.patch.object(steps, 'make_multi_step', make_timed):
      history = pipe.train_and_validate()
    out['first_run_s'] = time.perf_counter() - t0
    if pipe._multi_step is not timed[0]:
      _fail('pipeline: the timed K-step dispatch was not the one that ran')
    steady = _steady_state(timed[0].spans, steps_per_epoch)
    resumed = pipeline_lib.SimplePipeline(
        _train_model(gen), builder, hparams(PIPE_RESUMED_EPOCHS),
        device='cuda')
    between = steps.kernel_launch_counts()
    result = {}
    t0 = time.perf_counter()
    device_counts = _kernel_counts(
        lambda: result.update(history=resumed.train_and_validate()))
    out['resumed_run_s'] = time.perf_counter() - t0  # under the profiler
    resumed_history = result['history']
    after = steps.kernel_launch_counts()
    runs = (pipe._multi_step, resumed._multi_step)
    for run, epochs in zip(runs, (PIPE_EPOCHS,
                                  PIPE_RESUMED_EPOCHS - PIPE_EPOCHS)):
      if (run.captures != 1
          or run.replays != epochs * steps_per_epoch - run.warmup):
        _fail(f'pipeline: {run.captures} captures, {run.replays} replays '
              f'in {epochs} epochs')
    steady_replays = sum(n for _, n, _, _ in timed[0].spans) // B
    if steady_replays != PIPE_EPOCHS * steps_per_epoch - KSTEPS:
      _fail(f'pipeline: {steady_replays} steps in replay-only dispatches')
    wrappers, measured = _card_launches('pipeline', before, between, after,
                                        resumed._multi_step, device_counts,
                                        resumed._eval_step)
    state = resumed.final_state
    if state.step != PIPE_RESUMED_EPOCHS * steps_per_epoch:
      _fail(f'pipeline: resumed to step {state.step}')
    for h in (history, resumed_history):
      if not all(math.isfinite(v) for v in h.values()):
        _fail(f'pipeline: a metric is not finite: {h}')
    model_dir = os.path.join(root, 'model')
    with open(os.path.join(model_dir, 'metrics.jsonl')) as f:
      logged = [json.loads(line) for line in f]
    if [r['step'] for r in logged] != [
        (e + 1) * steps_per_epoch for e in range(PIPE_RESUMED_EPOCHS)]:
      _fail(f'pipeline: metrics.jsonl steps {[r["step"] for r in logged]}')
    # Two runs' event records: a header each and one record an epoch (two
    # writers opened in the same second share a file, as TF's do).
    tb_dir = os.path.join(model_dir, 'tensorboard')
    events = sum(_count_records(os.path.join(tb_dir, name))
                 for name in os.listdir(tb_dir))
    ckpts = sorted(os.listdir(os.path.join(model_dir, 'checkpoints')))
    latest = os.path.join(model_dir, 'export', 'latest')
    if (events != 2 + PIPE_RESUMED_EPOCHS
        or f'ckpt_{state.step}.pt' not in ckpts
        or not os.path.exists(os.path.join(latest, 'params.pt'))):
      _fail(f'pipeline: outputs missing: {events} event records, '
            f'checkpoints {ckpts}, export '
            f'{os.listdir(os.path.dirname(latest))}')
    exported = serving.Predictor(
        _train_model(gen), state_dict=checkpoint.load_params(latest),
        device='cuda')
    trained = serving.Predictor(state.model, device='cuda')
    probe = next(iter(builder.valid_batches()))
    if not (exported.score_batch(probe) == trained.score_batch(probe)).all():
      _fail('pipeline: the exported params score differently')
    graphed = resumed._eval_step
    eager = graphed.eval_step  # the step the graphs captured
    eval_batches = -(-PIPE_VALID_LISTS // B)
    captures, replays = graphed.captures, graphed.replays
    t0 = time.perf_counter()
    graphed_metrics = resumed._run_eval(state)
    torch.cuda.synchronize()
    out['eval_ms'] = (time.perf_counter() - t0) * 1e3

    def eager_eval():
      with mock.patch.object(resumed, '_eval_step', eager):
        return resumed._run_eval(state)

    # The same eval through the eager step, in the same run: its one-call
    # time, then both medians of 5, interleaved.
    t0 = time.perf_counter()
    eager_metrics = eager_eval()
    torch.cuda.synchronize()
    out['eager_eval_ms'] = (time.perf_counter() - t0) * 1e3
    if eager_metrics != graphed_metrics:
      _fail(f'pipeline: the graphed eval {graphed_metrics} != the eager '
            f'eval {eager_metrics}')
    medians = {'graphed': [], 'eager': []}
    for _ in range(5):
      for name, fn in (('graphed', lambda: resumed._run_eval(state)),
                       ('eager', eager_eval)):
        medians[name].append(_host_ms(fn, 1, warmup=0))
    out['eval_median_ms'] = statistics.median(medians['graphed'])
    out['eager_eval_median_ms'] = statistics.median(medians['eager'])
    out['eval_ms_each'] = medians
    if (graphed.captures != captures
        or graphed.replays != replays + 6 * eval_batches):
      _fail(f'pipeline: the timed evals captured {graphed.captures - captures}'
            f' graphs and replayed {graphed.replays - replays} times, not '
            f'{6 * eval_batches} replays alone')
    if resumed._eval_step is not graphed:
      _fail('pipeline: the eager yardstick left its step in the pipeline')
    # Where an eval's time goes: the validation feed alone (lists gathered
    # on the host, page-locked, copied), the graphed steps alone on batches
    # already on the card (the metrics' readout included), and the
    # device's own time in an eval.
    def feed():
      return list(dataset.prefetch_to_device(
          builder.valid_batches(), 'cuda', flat_examples=True))

    fed = feed()

    def graphed_steps():
      s = steps.init_metric_states(resumed.metric_fns, with_loss=True,
                                   device='cuda')
      for b in fed:
        s, _ = resumed._eval_step(state.model, b, s,
                                  num_valid_rows=b.batch_size)
      torch.stack(list(steps.metric_results(s).values())).cpu()

    out['eval_feed_ms'] = _host_ms(feed, 5, warmup=1)
    out['eval_steps_ms'] = _host_ms(graphed_steps, 5, warmup=1)
    prof = _profile(lambda: resumed._run_eval(state), calls=3)
    out['eval_device_ms'] = prof['device_ms']
    out['eval_device_ops'] = prof['device_ops']
    out.update(history=history, resumed_history=resumed_history,
               lists_per_s=history['examples_per_sec'],
               steady=steady, checkpoints=ckpts,
               wrapper_launches=wrappers,
               device_launches_resumed_run=device_counts,
               launches_recorded_at_capture=[r.captured_launches
                                             for r in runs])
    windows = ', '.join(f'{w["lists_per_s"]:.1f}' for w in steady['windows'])
    _log(f'pipeline: {PIPE_EPOCHS} epochs of {steps_per_epoch} steps at '
         f'B={B}, L={L}, {KSTEPS} steps a dispatch, then resumed to '
         f'{PIPE_RESUMED_EPOCHS} (under the profiler): one capture a run, '
         f'{runs[0].replays} and {runs[1].replays} replays; loss '
         f'{history["loss"]:.4f} -> {resumed_history["loss"]:.4f}, ndcg@10 '
         f'{resumed_history["ndcg@10"]:.4f}; steady state (replay-only '
         f'dispatches, events) {steady["loop_lists_per_s"]:.1f} lists/s '
         f'over the loop (windows {windows}), '
         f'{steady["dispatch_lists_per_s"]:.1f} over the dispatches alone; '
         f'whole first run {out["lists_per_s"]:.1f} lists/s; eval of '
         f'{PIPE_VALID_LISTS} lists {out["eval_ms"]:.1f} ms graphed, '
         f'{out["eager_eval_ms"]:.1f} ms through the eager step (medians of 5,'
         f' interleaved: graphed {out["eval_median_ms"]:.1f}, eager '
         f'{out["eager_eval_median_ms"]:.1f}; equal metrics; no capture in the '
         f'timed evals;'
         f' the feed alone '
         f'{out["eval_feed_ms"]:.1f}, the graphed steps alone '
         f'{out["eval_steps_ms"]:.1f}, the device '
         f'{out["eval_device_ms"]:.2f} ms over '
         f'{out["eval_device_ops"]:.0f} operations); kernels on the '
         f'card in the resumed run {device_counts}; exported params reload '
         'and score equal')
    return out, wrappers, measured
  finally:
    shutil.rmtree(root, ignore_errors=True)


# --- phase 18: the ELWC path: serialized protos, the loader, serving --------

# The flagship recipe written as ELWC, the shape of the repo's corpus
# writer (benchmarks/e2e_common.py:157-171): documents of 136 float
# features and an int64 relevance 0-4, no context, 20 to 200 documents a
# list; 1,280 train lists in 4 files and 256 validation lists, the cut of
# scale of phase 17.
ELWC_TRAIN_FILES = 4
ELWC_PROBE = 64                   # records held decoder against plain
# The sparse token run: phase 13's workload fed as ELWC of string tokens
# hashed into the 3M rows; one dispatch of 10 steps, to keep the script
# within its time.
TOKEN_LISTS, TOKEN_STEPS = 640, KSTEPS
LOADER_PASSES = 7                 # timed passes of each loader rate


def _parsed_equal(a, b):
  """ParsedLists equal bit for bit, dtypes included."""
  import numpy as np
  if sorted(a.context) != sorted(b.context) or sorted(a.examples) != sorted(
      b.examples):
    return False
  pairs = [(a.context[k], b.context[k]) for k in a.context] + [
      (a.examples[k], b.examples[k]) for k in a.examples] + [
          (a.sizes, b.sizes), (a.mask, b.mask)]
  return all(x.dtype == y.dtype and x.shape == y.shape and np.array_equal(
      x.view(np.uint32) if x.dtype == np.float32 else x,
      y.view(np.uint32) if y.dtype == np.float32 else y) for x, y in pairs)


def _elwc_specs():
  from ranking_tpu_torch.data import parsers
  return {}, {'float_features': parsers.FixedLenFeature((F,), 'float32', 0.0),
              'relevance': parsers.FixedLenFeature((), 'int64', 0)}


def _token_specs(vocab=None):
  from ranking_tpu_torch.data import parsers
  tokens = (parsers.VarLenFeature('string', max_len=SPARSE_T, vocab=vocab)
            if vocab is not None else parsers.VarLenFeature(
                'string', max_len=SPARSE_T, hash_buckets=SPARSE_VOCAB))
  return ({'query_tokens': tokens},
          {'document_tokens': tokens,
           'relevance': parsers.FixedLenFeature((), 'int64', 0)})


def _token_records(seed, lists):
  """ELWC lists of 20 to 50 documents, each 1 to 8 string tokens drawn from
  10M words (hashed into the 3M rows), a query of 1 to 8, labels 0-4."""
  import numpy as np
  from ranking_tpu_torch.data import proto
  rng = np.random.RandomState(seed)

  def words():
    return [f'w{i}' for i in rng.randint(0, 10_000_000,
                                         size=rng.randint(1, SPARSE_T + 1))]

  return [proto.make_elwc({'query_tokens': words()}, [
      {'document_tokens': words(), 'relevance': [int(rng.randint(0, 5))]}
      for _ in range(rng.randint(SPARSE_MIN_LEN, SPARSE_L + 1))])
      for _ in range(lists)]


def _check_decoder(train_path, drawn):
  """Step 2: the native decoder against the plain parser on the card's
  host, bit for bit: 64 records of a train file, their list sizes, 64
  pointwise tf.Examples, and 64 token records under hashing and under a
  vocabulary; and the decoded arrays against what the writer drew."""
  import numpy as np
  from ranking_tpu_torch.data import native
  from ranking_tpu_torch.data import parsers
  from ranking_tpu_torch.data import proto
  from ranking_tpu_torch.data import tfrecord
  records = tfrecord.read_all_records(train_path, verify=True,
                                      limit=ELWC_PROBE)
  if native.read_tfrecord_payloads(train_path)[:ELWC_PROBE] != records:
    _fail('elwc: the native TFRecord scan read other payloads')
  context, example = _elwc_specs()
  x, labels, counts = drawn
  fast = parsers.parse(records, context, example, L)
  plain = parsers.parse(records, context, example, L, use_native=False)
  if not _parsed_equal(fast, plain):
    _fail('elwc: native decode != plain parser on the train records')
  if not np.array_equal(parsers.elwc_list_sizes(records),
                        parsers._elwc_list_sizes_py(records)):
    _fail('elwc: native list sizes != the plain walk')
  start = 0
  for i in range(ELWC_PROBE):
    n = counts[i]
    if (fast.sizes[i] != n
        or not np.array_equal(fast.examples['float_features'][i, :n],
                              x[start:start + n])
        or not np.array_equal(fast.examples['relevance'][i, :n],
                              labels[start:start + n])
        or fast.examples['float_features'][i, n:].any()):
      _fail(f'elwc: record {i} decodes to other values than were written')
    start += n
  pointwise = [proto.make_example({'float_features': x[d],
                                   'relevance': labels[d:d + 1]})
               for d in range(ELWC_PROBE)]
  if not _parsed_equal(
      parsers.parse(pointwise, context, example, 1, data_format='tf_example'),
      parsers.parse(pointwise, context, example, 1, data_format='tf_example',
                    use_native=False)):
    _fail('elwc: native decode != plain parser on tf.Examples')
  tokens = _token_records(SEED + 30, ELWC_PROBE)
  vocab = parsers.Vocabulary([f'w{i}' for i in range(0, 10_000_000, 997)],
                             num_oov_buckets=5)
  for name, specs in (('hashed', _token_specs()),
                      ('vocabulary', _token_specs(vocab))):
    if not _parsed_equal(parsers.parse(tokens, *specs, SPARSE_L),
                         parsers.parse(tokens, *specs, SPARSE_L,
                                       use_native=False)):
      _fail(f'elwc: native decode != plain parser on {name} tokens')
  _log(f'elwc: native decoder == plain parser bit for bit on {ELWC_PROBE} '
       f'train records (list sizes too), {ELWC_PROBE} tf.Examples and '
       f'{ELWC_PROBE} token records hashed and through a vocabulary; the '
       'decoded arrays are what the writer drew')


def _loader_rates(pattern, cache_dir):
  """lists/s of the native loader alone (no device), each over
  LOADER_PASSES passes of the train files: decoding with the cache off and
  reading a complete cache (each after a pass of warm-up), and building
  the cache (a fresh spill each pass, its scan included). Returns each
  rate's median, least and most, and the loader's decode threads; fails
  unless each stream's cache state is the one it measures."""
  import shutil
  from ranking_tpu_torch.data import dataset
  context, example = _elwc_specs()
  per_pass = PIPE_TRAIN_LISTS // B

  def passes(epochs, cache, state):
    t0 = time.perf_counter()
    stream = dataset.native_ranking_dataset(
        pattern, B, context_feature_spec=context,
        example_feature_spec=example, list_size=L, epochs=epochs,
        seed=SEED, cache_dir=cache)
    if stream.loader.cache_state != state:
      _fail(f'elwc loader: cache {stream.loader.cache_state}, not {state}')
    marks = [t0]
    batches = 0
    for batches, _ in enumerate(stream, start=1):
      if batches % per_pass == 0:
        marks.append(time.perf_counter())
    if batches != epochs * per_pass:
      _fail(f'elwc loader: a stream of {epochs} passes (cache {state}) '
            f'ended after {batches} batches, not {epochs * per_pass}')
    rates = [per_pass * B / (b - a) for a, b in zip(marks, marks[1:])]
    return rates, stream.loader.num_threads

  decode, threads = passes(1 + LOADER_PASSES, None, 'off')
  build = []
  for _ in range(LOADER_PASSES):
    shutil.rmtree(cache_dir, ignore_errors=True)
    build += passes(1, cache_dir, 'build')[0]
  read, _ = passes(1 + LOADER_PASSES, cache_dir, 'read')
  return {name: {'median': statistics.median(r), 'min': min(r),
                 'max': max(r), 'passes': len(r)}
          for name, r in (('decode', decode[1:]), ('cache_build', build),
                          ('cache_read', read[1:]))}, threads


def _elwc_phase(gen):
  """Phase 18: the ELWC path on the card. Writes ELWC TFRecords from the
  seed, holds the native decoder against the plain parser, trains the
  flagship recipe through ``SimpleDatasetBuilder`` (the native loader)
  and ``SimplePipeline.train_and_validate`` (run D: one epoch with the
  epoch cache off, so that every dispatch's batches are decoded; run C: two
  epochs with the cache on, whose dispatches after the first read it; a
  resume of C to 3 epochs through the builder's ``skip_batches``, under
  ``torch.profiler``), serves the export through ``Predictor.predict`` and
  ``regress``, and runs the sparse token workload through the same
  builder. Returns (numbers, wrapper launches of the flagship runs, kernel
  launches on the card in the resume, wrapper launches of the token run,
  its kernel launches on the card)."""
  import os
  import shutil
  import numpy as np
  import torch
  from ranking_tpu_torch.data import batch as batch_lib
  from ranking_tpu_torch.data import native
  from ranking_tpu_torch.data import parsers
  from ranking_tpu_torch.data import proto
  from ranking_tpu_torch.data import tfrecord
  from ranking_tpu_torch.models import layers
  from ranking_tpu_torch.pipeline import hparams as hparams_lib
  from ranking_tpu_torch.pipeline import pipeline as pipeline_lib
  from ranking_tpu_torch.pipeline import serving
  from ranking_tpu_torch.train import steps
  root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      '.scratch', 'chip_smoke_elwc')
  shutil.rmtree(root, ignore_errors=True)
  os.makedirs(root)
  out = {}
  try:
    # Step 1: the files.
    t0 = time.perf_counter()
    per_file = PIPE_TRAIN_LISTS // ELWC_TRAIN_FILES
    drawn = [proto.write_random_elwc(
        os.path.join(root, f'train-{i}.tfrecord'), per_file, F,
        PIPE_MIN_DOCS, L, seed=SEED + 20 + i)
        for i in range(ELWC_TRAIN_FILES)]
    proto.write_random_elwc(os.path.join(root, 'vali.tfrecord'),
                            PIPE_VALID_LISTS, F, PIPE_MIN_DOCS, L,
                            seed=SEED + 25)
    out['write_s'] = time.perf_counter() - t0
    train_pattern = os.path.join(root, 'train-*.tfrecord')
    sizes = {name: os.path.getsize(os.path.join(root, name)) / 1e6
             for name in sorted(os.listdir(root))}
    out['file_mb'] = {'train': sum(v for k, v in sizes.items()
                                   if k.startswith('train')),
                      'vali': sizes['vali.tfrecord']}
    docs = sum(int(d[2].sum()) for d in drawn)
    _log(f'elwc: wrote {PIPE_TRAIN_LISTS} train lists in '
         f'{ELWC_TRAIN_FILES} files ({out["file_mb"]["train"]:.1f} MB, '
         f'{docs} documents, {out["file_mb"]["train"] * 1e6 / docs:.0f} '
         f'bytes a document) and {PIPE_VALID_LISTS} validation lists '
         f'({out["file_mb"]["vali"]:.1f} MB) in {out["write_s"]:.2f} s')

    # Step 2: the native decoder against the plain parser.
    _check_decoder(os.path.join(root, 'train-0.tfrecord'), drawn[0])
    out['loader_lists_per_s'], out['loader_threads'] = _loader_rates(
        train_pattern, os.path.join(root, 'loader_cache'))
    out['host_cpus'] = os.cpu_count()
    _log(f'elwc: the loader alone (no device), lists/s over '
         f'{LOADER_PASSES} passes of {PIPE_TRAIN_LISTS} lists, median '
         f'(least-most): ' + ', '.join(
             f'{k} {v["median"]:.0f} ({v["min"]:.0f}-{v["max"]:.0f})'
             for k, v in out['loader_lists_per_s'].items())
         + f'; {out["loader_threads"]} decode threads on '
         f'{out["host_cpus"]} host CPUs')

    # Step 3: the flagship recipe through the builder and the pipeline.
    context, example = _elwc_specs()

    def builder(cache):
      return pipeline_lib.SimpleDatasetBuilder(
          context, example, hparams_lib.DatasetHparams(
              train_input_pattern=train_pattern,
              valid_input_pattern=os.path.join(root, 'vali.tfrecord'),
              train_batch_size=B, valid_batch_size=B, list_size=L,
              dataset_engine='native_loader', dataset_cache=cache),
          seed=SEED)

    def hparams(model_dir, epochs):
      return hparams_lib.PipelineHparams(
          model_dir=os.path.join(root, model_dir), num_epochs=epochs,
          steps_per_epoch=PIPE_STEPS_PER_EPOCH, validation_steps=10 ** 6,
          learning_rate=1e-3, loss='softmax_loss',
          steps_per_execution=KSTEPS, resume_dataset=True)

    timed = []
    make_multi_step = steps.make_multi_step

    def make_timed(*args, **kwargs):
      timed.append(_TimedDispatches(make_multi_step(*args, **kwargs)))
      return timed[-1]

    runs, steady = {}, {}
    cache_dir = os.path.join(root, 'cache')
    _reset_all_launches()
    before = steps.kernel_launch_counts()
    for name, cache, epochs in (('decode', None, 1),
                                ('cache', cache_dir, PIPE_EPOCHS)):
      pipe = pipeline_lib.SimplePipeline(
          _train_model(gen), builder(cache), hparams(f'model_{name}', epochs),
          device='cuda')
      t0 = time.perf_counter()
      with mock.patch.object(steps, 'make_multi_step', make_timed):
        history = pipe.train_and_validate()
      out[f'{name}_run_s'] = time.perf_counter() - t0
      if pipe._multi_step is not timed[-1]:
        _fail('elwc: the timed K-step dispatch was not the one that ran')
      if pipe.dataset_builder.engine != {'train': 'native_loader',
                                         'valid': 'native_loader'}:
        _fail(f'elwc: engines {pipe.dataset_builder.engine}')
      # Run D decodes every batch; run C builds the train cache, and its
      # second epoch's validation reads the cache the first one built.
      caches = {k: v['cache'] for k, v in pipe.dataset_builder.loader.items()}
      want = ({'train': 'off', 'valid': 'off'} if cache is None
              else {'train': 'build', 'valid': 'read'})
      if caches != want:
        _fail(f'elwc {name} run: loader caches {caches}, not {want}')
      run = pipe._multi_step
      if (run.captures != 1
          or run.replays != epochs * PIPE_STEPS_PER_EPOCH - run.warmup):
        _fail(f'elwc {name} run: {run.captures} captures, {run.replays} '
              f'replays in {epochs} epochs')
      if not all(math.isfinite(v) for v in history.values()):
        _fail(f'elwc {name} run: a metric is not finite: {history}')
      runs[name] = (pipe, history)
      steady[name] = _steady_state(timed[-1].spans, PIPE_STEPS_PER_EPOCH)
    out['pipeline_loader'] = {
        name: dict(pipe.dataset_builder.loader)
        for name, (pipe, _) in runs.items()}

    # Step 4: resume run C to 3 epochs, fast-forwarded by skip_batches.
    skips = []
    resumed_builder = builder(cache_dir)
    train_batches = resumed_builder.train_batches

    def recording(skip_batches=0):
      skips.append(skip_batches)
      return train_batches(skip_batches)

    resumed_builder.train_batches = recording
    resumed = pipeline_lib.SimplePipeline(
        _train_model(gen), resumed_builder,
        hparams('model_cache', PIPE_RESUMED_EPOCHS), device='cuda')
    between = steps.kernel_launch_counts()
    result = {}
    t0 = time.perf_counter()
    device_counts = _kernel_counts(
        lambda: result.update(history=resumed.train_and_validate()))
    out['resumed_run_s'] = time.perf_counter() - t0
    after = steps.kernel_launch_counts()
    resumed_history = result['history']
    done = PIPE_EPOCHS * PIPE_STEPS_PER_EPOCH
    if skips != [0, done]:
      _fail(f'elwc: the resume asked the builder for skip_batches {skips}, '
            f'not [0, {done}]')
    run = resumed._multi_step
    if (run.captures != 1 or resumed.final_state.step
        != PIPE_RESUMED_EPOCHS * PIPE_STEPS_PER_EPOCH):
      _fail(f'elwc resume: {run.captures} captures, step '
            f'{resumed.final_state.step}')
    if not all(math.isfinite(v) for v in resumed_history.values()):
      _fail(f'elwc resume: a metric is not finite: {resumed_history}')
    caches = {k: v['cache']
              for k, v in resumed.dataset_builder.loader.items()}
    if caches != {'train': 'read', 'valid': 'read'}:
      _fail(f'elwc resume: loader caches {caches}, not read')
    wrappers, measured = _card_launches('elwc', before, between, after, run,
                                        device_counts, resumed._eval_step)
    model_dir = os.path.join(root, 'model_cache')
    with open(os.path.join(model_dir, 'metrics.jsonl')) as f:
      logged = [json.loads(line)['step'] for line in f]
    tb_dir = os.path.join(model_dir, 'tensorboard')
    events = sum(_count_records(os.path.join(tb_dir, name))
                 for name in os.listdir(tb_dir))
    latest = os.path.join(model_dir, 'export', 'latest')
    ckpts = sorted(os.listdir(os.path.join(model_dir, 'checkpoints')))
    if (logged != [(e + 1) * PIPE_STEPS_PER_EPOCH
                   for e in range(PIPE_RESUMED_EPOCHS)]
        or events != 2 + PIPE_RESUMED_EPOCHS
        or f'ckpt_{resumed.final_state.step}.pt' not in ckpts
        or not os.path.exists(os.path.join(latest, 'params.pt'))):
      _fail(f'elwc: outputs missing: steps {logged}, {events} event '
            f'records, checkpoints {ckpts}')
    for name in ('decode', 'cache'):
      windows = ', '.join(f'epoch {w["epoch"]} {w["lists_per_s"]:.1f}'
                          for w in steady[name]['windows'])
      _log(f'elwc run {"D" if name == "decode" else "C"} (epoch cache '
           f'{"off" if name == "decode" else "on"}): steady state '
           f'(replay-only dispatches, events) {windows} lists/s over the '
           f'loop, {steady[name]["dispatch_lists_per_s"]:.1f} over the '
           f'dispatches alone; whole run '
           f'{runs[name][1]["examples_per_sec"]:.1f} lists/s')
    _log(f'elwc: resumed run C to {PIPE_RESUMED_EPOCHS} epochs through '
         f'skip_batches={done} (one capture, under the profiler): loss '
         f'{runs["cache"][1]["loss"]:.4f} -> {resumed_history["loss"]:.4f}, '
         f'ndcg@10 {resumed_history["ndcg@10"]:.4f}; kernels on the card '
         f'{device_counts}; engines {resumed.dataset_builder.engine}; '
         f'loaders (decode threads, cache) of run D '
         f'{out["pipeline_loader"]["decode"]}, run C '
         f'{out["pipeline_loader"]["cache"]}, the resume '
         f'{resumed.dataset_builder.loader}; parsers '
         f'{dict(parsers.parser_runs)}')
    out.update(steady=steady, skips=skips, wrapper_launches=wrappers,
               device_launches_resumed_run=device_counts,
               history={k: h for k, (_, h) in runs.items()},
               resumed_history=resumed_history,
               engines=runs['cache'][0].dataset_builder.engine,
               parser_runs=dict(parsers.parser_runs))

    # Step 5: serving the export.
    predictor = serving.Predictor.from_export(
        _train_model(gen), latest, context, example,
        label_feature_name='relevance', device='cuda')
    x, labels, counts = proto.random_lists(B - 1, F, PIPE_MIN_DOCS, L,
                                           seed=SEED + 26)
    x_top, labels_top, _ = proto.random_lists(1, F, L, L, seed=SEED + 27)
    x = np.concatenate([x_top, x])
    labels = np.concatenate([labels_top, labels])
    counts = np.concatenate([[L], counts])
    starts = np.concatenate([[0], np.cumsum(counts)])
    lists = [[{'float_features': x[d], 'relevance': labels[d:d + 1]}
              for d in range(starts[i], starts[i + 1])] for i in range(B)]
    request = [proto.make_elwc({}, docs) for docs in lists]
    bucket = parsers.bucket_list_size(L)
    scores = predictor.predict(request)
    if scores.shape != (B, bucket):
      _fail(f'predict: scores {scores.shape}, not {(B, bucket)}')
    features = np.zeros((B, bucket, F), np.float32)
    mask = np.arange(bucket)[None, :] < counts[:, None]
    features[mask] = x
    batch = batch_lib.batch_from_labels(
        np.where(mask, 0.0, -1.0).astype(np.float32),
        examples={'float_features': features}, mask=mask)
    want = predictor.score_batch(batch)
    scale = np.abs(want[mask]).max()
    predict_err = float(np.abs(scores[mask] - want[mask]).max())
    if (not np.allclose(scores[mask], want[mask], rtol=1e-4,
                        atol=1e-4 * scale)
        or not (scores[~mask] == np.float32(layers.PADDING_LOGIT)).all()):
      _fail(f'predict != score_batch: max |diff| {predict_err} (largest '
            f'score {scale}), or a padded slot is not log(1e-10)')
    pointwise = [proto.make_example(docs[0]) for docs in lists]
    singles = [proto.make_elwc({}, docs[:1]) for docs in lists]
    regressed = predictor.regress(pointwise)
    as_lists = predictor.predict(singles)
    regress_err = float(np.abs(regressed - as_lists[:, 0]).max())
    if (regressed.shape != (B,) or as_lists.shape != (B, 1)
        or not np.allclose(regressed, as_lists[:, 0], rtol=1e-4,
                           atol=1e-4 * np.abs(as_lists).max())):
      _fail(f'regress != predict on single-document lists: max |diff| '
            f'{regress_err}')
    parse_ms, run_ms, device_ms, predict_ms = [], [], [], []
    for _ in range(7):
      t0 = time.perf_counter()
      parsed = parsers.parse(request, context, predictor.example_feature_spec,
                             bucket)
      t1 = time.perf_counter()
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
      predictor._run(parsed)
      end.record()
      torch.cuda.synchronize()
      t2 = time.perf_counter()
      predictor.predict(request)
      t3 = time.perf_counter()
      parse_ms.append((t1 - t0) * 1e3)
      run_ms.append((t2 - t1) * 1e3)
      device_ms.append(start.elapsed_time(end))
      predict_ms.append((t3 - t2) * 1e3)
    out['serve'] = {
        'request_lists': B, 'bucket': bucket,
        'documents': int(counts.sum()),
        'predict_max_abs_diff_vs_score_batch': predict_err,
        'regress_max_abs_diff_vs_predict': regress_err,
        'parse_ms': statistics.median(parse_ms[2:]),
        'run_ms': statistics.median(run_ms[2:]),
        'device_ms': statistics.median(device_ms[2:]),
        'predict_ms': statistics.median(predict_ms[2:])}
    _log(f'elwc serve: predict on {B} ELWCs ({int(counts.sum())} documents) '
         f'-> {scores.shape}, == score_batch within {predict_err:.3g} '
         f'(largest score {scale:.3g}), padded slots log(1e-10); regress on '
         f'{B} tf.Examples == predict on single-document lists within '
         f'{regress_err:.3g}; B={B} request: parse '
         f'{out["serve"]["parse_ms"]:.3f} ms on the host, then '
         f'{out["serve"]["device_ms"]:.3f} ms by events on the card '
         f'({out["serve"]["run_ms"]:.3f} ms of host time) from the '
         f'page-locked copy to the scores on the host; whole predict '
         f'{out["serve"]["predict_ms"]:.3f} ms')

    # Step 6: the sparse token workload through the same builder.
    tfrecord.write_records(os.path.join(root, 'tokens-train.tfrecord'),
                           _token_records(SEED + 31, TOKEN_LISTS))
    tfrecord.write_records(os.path.join(root, 'tokens-vali.tfrecord'),
                           _token_records(SEED + 32, SPARSE_B))
    token_builder = pipeline_lib.SimpleDatasetBuilder(
        *_token_specs(), hparams_lib.DatasetHparams(
            train_input_pattern=os.path.join(root, 'tokens-train.tfrecord'),
            valid_input_pattern=os.path.join(root, 'tokens-vali.tfrecord'),
            train_batch_size=SPARSE_B, valid_batch_size=SPARSE_B,
            list_size=SPARSE_L, dataset_engine='native_loader'), seed=SEED)
    token_pipe = pipeline_lib.SimplePipeline(
        _sparse_model(gen), token_builder, hparams_lib.PipelineHparams(
            model_dir=os.path.join(root, 'model_tokens'), num_epochs=1,
            steps_per_epoch=TOKEN_STEPS, validation_steps=1,
            learning_rate=1e-3, loss='softmax_loss', optimizer='lazy_adam',
            steps_per_execution=KSTEPS), device='cuda')
    _reset_all_launches()
    token_before = steps.kernel_launch_counts()
    result = {}
    token_device = _kernel_counts(
        lambda: result.update(history=token_pipe.train_and_validate()))
    token_after = steps.kernel_launch_counts()
    run = token_pipe._multi_step
    if run.captures != 1 or token_pipe.final_state.step != TOKEN_STEPS:
      _fail(f'elwc tokens: {run.captures} captures, step '
            f'{token_pipe.final_state.step}')
    if not all(math.isfinite(v) for v in result['history'].values()):
      _fail(f'elwc tokens: a metric is not finite: {result["history"]}')
    token_wrappers, token_measured = _card_launches(
        'elwc tokens', token_before, token_before, token_after, run,
        token_device, token_pipe._eval_step)
    out['tokens'] = {'history': result['history'],
                     'wrapper_launches': token_wrappers,
                     'device_launches': token_device}
    _log(f'elwc tokens: EmbeddingDNNScorer(256-128) over two '
         f'{SPARSE_VOCAB} x {SPARSE_DIM} tables, lazy_adam, '
         f'{TOKEN_STEPS} steps of B={SPARSE_B} lists of up to {SPARSE_L} '
         f'documents, hashed string tokens through the native loader: '
         f'loss {result["history"]["loss"]:.4f}; kernels on the card '
         f'{token_device}')
    del token_pipe, token_builder
    torch.cuda.empty_cache()
    return out, wrappers, measured, token_wrappers, token_measured
  finally:
    shutil.rmtree(root, ignore_errors=True)


# --- phase 19: evaluation and the serving artifact ---------------------------

SUBTOPICS = 3                     # synthetic subtopics of the diversity metrics
TREC_QUERIES = 2000               # the TREC run: 20-200 judged documents each
TREC_SPEC = ('ndcg@1,ndcg@5,ndcg@10,ndcg,dcg@10,mrr,mrr@10:rel>=3,map,'
             'precision@10,recall@10,hits@1,arp,ordered_pair_accuracy,bpref,'
             'pwa')
EXPORT_BUCKETS = (1, 256)
# An int8 artifact's scores against the float one's, as a share of the float
# scores' largest magnitude: the JAX package's bound
# (tests/test_pipeline.py:912-950). Its test also wants the same argmax in
# each of its few short lists; over 128 lists of up to 200 documents some
# top two are closer than the int8 error, so a list may change its top
# document only where the two float scores are within INT8_SWAP_GAP of the
# float scores' largest magnitude (a third of INT8_TOL), and at most
# INT8_MAX_SWAPS of the 128 lists (1 in 16) may change it.
INT8_TOL = 0.03
INT8_SWAP_GAP = 0.01
INT8_MAX_SWAPS = 8
# Metrics of two paths on the same scores: 1e-6, and 1e-6 of the value for
# the metrics that run past 1 (DCG, ARP), where float32 sums in another
# order differ by a few ulps and an absolute 1e-6 is finer than the format.
METRIC_TOL = 1e-6


def _subtopics(labels):
  """Synthetic ``[B, L, S]`` subtopic labels of graded labels: a document
  of grade g covers subtopics 1..g (of 3); padding stays -1."""
  import torch
  grades = torch.arange(1, SUBTOPICS + 1, dtype=torch.float32,
                        device=labels.device)
  covered = (labels[..., None] >= grades).to(torch.float32)
  return torch.where(labels[..., None] >= 0, covered, -1.0)


def _suite_fns():
  """The reference's whole suite, the 13 keys: NDCG and DCG at 1/5/10/all,
  MRR, ARP, precision@5, recall@10, MAP, hits@1, OPA, BPref, PWA@5, and
  alpha-DCG@10 and precision-IA@5 over ``_subtopics`` of the labels."""
  from ranking_tpu_torch.ops import metric_registry as registry
  keys = registry.RankingMetricKey
  fns = {}
  for topn in (1, 5, 10, None):
    tag = f'@{topn}' if topn else ''
    fns[f'ndcg{tag}'] = registry.make_ranking_metric_fn(keys.NDCG, topn=topn)
    fns[f'dcg{tag}'] = registry.make_ranking_metric_fn(keys.DCG, topn=topn)
  for name, key, topn in (
      ('mrr', keys.MRR, None), ('arp', keys.ARP, None),
      ('precision@5', keys.PRECISION, 5), ('recall@10', keys.RECALL, 10),
      ('map', keys.MAP, None), ('hits@1', keys.HITS, 1),
      ('opa', keys.ORDERED_PAIR_ACCURACY, None), ('bpref', keys.BPREF, None),
      ('pwa@5', keys.PWA, 5)):
    fns[name] = registry.make_ranking_metric_fn(key, topn=topn)
  for name, key, topn in (('alpha_dcg@10', keys.ALPHA_DCG, 10),
                          ('precision_ia@5', keys.PRECISION_IA, 5)):
    fn = registry.make_ranking_metric_fn(key, topn=topn)
    fns[name] = (lambda labels, logits, features=None, fn=fn:
                 fn(_subtopics(labels), logits))
  if len(keys.all_keys()) != 13:
    _fail(f'the registry lists {len(keys.all_keys())} metric keys, not 13')
  return fns


# The aggregated metrics of the query-id evaluation: every key that scores
# graded labels (the diversity metrics need subtopics).
_AGG_SPECS = {'ndcg@5': ('ndcg', 5), 'ndcg': ('ndcg', None),
              'dcg@10': ('dcg', 10), 'mrr': ('mrr', None),
              'arp': ('arp', None), 'precision@5': ('precision', 5),
              'recall@10': ('recall', 10), 'map': ('map', None),
              'hits@1': ('hits', 1), 'opa': ('ordered_pair_accuracy', None),
              'bpref': ('bpref', None), 'pwa': ('pwa', 5)}


class _FixedLogits:
  """A stand-in model that returns given logits, one tensor a call, in
  order: the plain path scores the card's logits."""

  def __init__(self, logits):
    self.logits = list(logits)

  def __call__(self, context, examples, mask, training=False):
    return self.logits.pop(0)

  def to(self, device):
    self.logits = [t.to(device) for t in self.logits]
    return self


def _metrics_close(what, got, want):
  """got == want within METRIC_TOL (+ METRIC_TOL of the value); returns the
  largest |difference|."""
  if sorted(got) != sorted(want):
    _fail(f'{what}: metric names {sorted(got)} != {sorted(want)}')
  worst = 0.0
  for name in want:
    diff = abs(got[name] - want[name])
    worst = max(worst, diff)
    if not diff <= METRIC_TOL + METRIC_TOL * abs(want[name]):
      _fail(f'{what}: {name} {got[name]} vs {want[name]}')
  return worst


def _read_rows(path):
  import csv
  with open(path) as f:
    return list(csv.reader(f))


def _suite_and_graph(model, eval_batches, gen):
  """Phase 19a: the whole suite and the validation loss, eager against
  graphed, bit for bit; eager on the card against the plain path on the
  CPU on the same logits; the profiler's sort launches of one replay; the
  two steps' device and host times. Returns (numbers, the eager logits of
  ``eval_batches``)."""
  import torch
  from ranking_tpu_torch.data import dataset
  from ranking_tpu_torch.ops import loss_registry
  from ranking_tpu_torch.ops.cuda import sort as cuda_sort
  from ranking_tpu_torch.train import steps
  fns = _suite_fns()
  loss_fn = loss_registry.make_loss_fn('softmax_loss')
  tail = dataset.flatten_examples(_make_batch(gen, 100).pad_to(B))
  batches = [(b.to('cuda'), None) for b in eval_batches] + [
      (tail.to('cuda'), 100)]
  eager = steps.make_eval_step(fns, loss_fn=loss_fn, device='cuda')
  graphed = steps.GraphedEvalStep(eager, 'cuda')

  # Which of the suite's sorts take the kernel (2-D float channels) and
  # which the plain path (3-D subtopics, boolean or integer channels).
  sorts = cuda_sort.sorted_values_and_ranks.launches
  with mock.patch.object(cuda_sort, 'sort_order',
                         wraps=cuda_sort.sort_order) as plain_sorts:
    eager(model, batches[0][0],
          steps.init_metric_states(fns, True, device='cuda'))
    torch.cuda.synchronize()
  kernel_sorts = cuda_sort.sorted_values_and_ranks.launches - sorts
  plain = plain_sorts.call_count

  eager_logits = []
  for run in range(2):  # the second pass starts again from zeroed states
    es = steps.init_metric_states(fns, with_loss=True, device='cuda')
    gs = steps.init_metric_states(fns, with_loss=True, device='cuda')
    for i, (batch, rows) in enumerate(batches):
      es, el = eager(model, batch, es, num_valid_rows=rows)
      gs, gl = graphed(model, batch, gs, num_valid_rows=rows)
      if run == 0 and i < len(eval_batches):
        eager_logits.append(el)
      if not torch.equal(el, gl):
        _fail(f'graphed eval: logits of batch {i} differ from eager')
      for name in es:
        if not (torch.equal(es[name].total, gs[name].total)
                and torch.equal(es[name].count, gs[name].count)):
          _fail(f'graphed eval: {name} after batch {i} (pass {run}) '
                f'{gs[name].total.item()}/{gs[name].count.item()} != eager '
                f'{es[name].total.item()}/{es[name].count.item()}')
  checked = graphed.replays
  if graphed.captures != 1 or checked != 2 * len(batches) - 1:
    _fail(f'graphed eval: {graphed.captures} captures, {checked} replays')
  card = {k: v.item() for k, v in steps.metric_results(es).items()}

  # The plain path: the same eval step on the CPU over the card's logits.
  cpu_step = steps.make_eval_step(fns, loss_fn=loss_fn, device='cpu')
  cs = steps.init_metric_states(fns, with_loss=True, device='cpu')
  logits = eager_logits + [eager(
      model, batches[-1][0],
      steps.init_metric_states(fns, True, device='cuda'),
      num_valid_rows=100)[1]]
  for (batch, rows), lg in zip(batches, logits):
    cs, _ = cpu_step(_FixedLogits([lg.cpu()]), batch.to('cpu'), cs,
                     num_valid_rows=rows)
  plain_worst = _metrics_close(
      'eval suite, card vs the plain path on the CPU', card,
      {k: v.item() for k, v in steps.metric_results(cs).items()})

  # Row 1 on the card in one replay == what the wrapper counted at capture.
  captured = graphed.captured_launches().get('sorted_values_and_ranks', 0)
  replay = _kernel_counts(lambda: graphed(model, batches[1][0], gs))
  if replay.get('rank_sort_kernel', 0) != captured or captured != kernel_sorts:
    _fail(f'graphed eval: {replay.get("rank_sort_kernel", 0)} sort kernels '
          f'on the card in a replay; the capture recorded {captured}, an '
          f'eager step launches {kernel_sorts}')

  times = {}
  dev_batch = batches[1][0]
  held = {'eager': es, 'graphed': gs}

  def loop_step(name, step):
    def call():  # as an eval loop calls it: states in, states out
      held[name], _ = step(model, dev_batch, held[name])
    return call

  for name, fn in (('eager', loop_step('eager', eager)),
                   ('graphed', loop_step('graphed', graphed))):
    prof = _profile(fn)
    host = _host_ms(fn, 30)
    times[name] = {'device_ms': prof['device_ms'],
                   'device_ops': prof['device_ops'], 'host_ms': host,
                   'device_idle_share': 1.0 - prof['device_ms'] / host}
  out = {'metrics': len(fns), 'kernel_sorts': kernel_sorts,
         'plain_sorts': plain, 'replays': checked,
         'captured_sort_launches': captured,
         'max_abs_diff_vs_plain_cpu': plain_worst, 'times': times,
         'values': card}
  _log(f'eval suite: {len(fns)} metrics of the 13 keys + val_loss over '
       f'{len(batches)} batches (the last padded, num_valid_rows=100), '
       f'twice: graphed == eager bit for bit (states, val_loss, logits; 1 '
       f'capture, {checked} replays); card == plain path on the CPU '
       f'on the same logits within {plain_worst:.3g}; sorts of a step: '
       f'{kernel_sorts} through the kernel, {plain} on the plain path '
       f'(3-D, boolean or integer channels); a replay runs '
       f'{replay.get("rank_sort_kernel", 0)} sort kernels, as captured. '
       f'Step at B{B}xL{L}: ' + '; '.join(
           f'{k} device {v["device_ms"]:.3f} ms over {v["device_ops"]:.0f} '
           f'operations, host {v["host_ms"]:.3f} ms, idle '
           f'{100 * v["device_idle_share"]:.1f}%' for k, v in times.items()))
  return out, eager_logits


def _query_id_eval(model, eval_batches, card_logits, root):
  """Phase 19b: ``evaluate_dataset`` with a query id (consecutive lists
  share a query, also across batches) and a predictions CSV, on the card
  and on the CPU."""
  import copy
  import numpy as np
  import torch
  from ranking_tpu_torch.pipeline import serving
  from ranking_tpu_torch.train import steps
  fns = {k: v for k, v in _suite_fns().items()
         if k in ('ndcg@5', 'ndcg', 'mrr', 'map', 'opa', 'pwa@5')}
  batches = []
  for i, batch in enumerate(eval_batches):
    qid = (i * B + torch.arange(B) + 1) // 2
    batches.append(batch.replace(context={'qid': qid[:, None]}))
  paths = {k: os.path.join(root, f'{k}.csv') for k in ('card', 'plain',
                                                       'cpu')}
  t0 = time.perf_counter()
  card = serving.evaluate_dataset(
      model, None, batches, metric_fns=fns, query_id_feature='qid',
      aggregated_metrics=_AGG_SPECS, predictions_csv=paths['card'],
      device='cuda')
  card_s = time.perf_counter() - t0
  plain = serving.evaluate_dataset(
      _FixedLogits([t.cpu() for t in card_logits]), None, batches,
      metric_fns=fns, query_id_feature='qid', aggregated_metrics=_AGG_SPECS,
      predictions_csv=paths['plain'], device='cpu')
  worst = _metrics_close('query-id eval, card vs the plain path', card, plain)
  rows = {k: _read_rows(p) for k, p in paths.items() if k != 'cpu'}
  if rows['card'] != rows['plain']:
    _fail('query-id eval: the card\'s CSV differs from the plain path\'s on '
          'the same logits')
  cpu_model = copy.deepcopy(model).to('cpu')
  cpu = serving.evaluate_dataset(
      cpu_model, None, batches, metric_fns=fns,
      query_id_feature='qid', aggregated_metrics=_AGG_SPECS,
      predictions_csv=paths['cpu'], device='cpu')
  rows['cpu'] = _read_rows(paths['cpu'])
  a = np.asarray(rows['card'][1:], np.float64)
  c = np.asarray(rows['cpu'][1:], np.float64)
  scale = np.abs(c[:, 2]).max()
  score_err = float(np.abs(a[:, 2] - c[:, 2]).max())
  if (rows['card'][0] != rows['cpu'][0] or a.shape != c.shape
      or not np.array_equal(a[:, :2], c[:, :2])
      or not np.allclose(a[:, 2], c[:, 2], rtol=1e-4, atol=1e-4 * scale)):
    _fail(f'query-id eval: CSV rows of the card and of the CPU forward '
          f'differ (scores max |diff| {score_err}, largest {scale})')
  # Where the CPU forward orders every list as the card does, its metrics
  # must agree too; float32 rounding of near-tied scores may swap a pair.
  with torch.no_grad():
    cpu_logits = [cpu_model(r.context, r.examples, r.mask) for r in (
        steps.restore_flat_examples(b) for b in eval_batches)]
  swapped = sum(
      int((torch.sort(g.cpu(), dim=1, descending=True, stable=True).indices
           != torch.sort(h, dim=1, descending=True,
                         stable=True).indices).any(1).sum())
      for g, h in zip(card_logits, cpu_logits))
  cpu_worst = max(abs(card[k] - cpu[k]) for k in card)
  if not swapped:
    _metrics_close('query-id eval, card vs the CPU forward', card, cpu)
  queries = len({r[0] for r in rows['card'][1:]})
  out = {'queries': queries, 'rows': len(rows['card']) - 1,
         'max_abs_diff_vs_plain': worst, 'csv_score_max_abs_diff_vs_cpu':
         score_err, 'lists_ordered_differently_on_cpu': swapped,
         'max_abs_diff_vs_cpu_forward': cpu_worst, 'card_s': card_s,
         'values': card}
  _log(f'query-id eval: {len(batches)} x {B} lists, {queries} queries (2 '
       f'lists each, one split across each pair of batches), '
       f'{len(_AGG_SPECS)} aggregated metrics + {len(fns)} streamed: card == '
       f'the plain path on the same logits within {worst:.3g}, CSV rows '
       f'equal; the CPU forward: CSV scores within {score_err:.3g} (largest '
       f'{scale:.3g}), {swapped} lists ordered differently, metrics within '
       f'{cpu_worst:.3g}' + (' (checked)' if not swapped else
                             ' (reported, not checked)'))
  return out


def _write_trec_files(root):
  """qrels of TREC_QUERIES queries of 20-200 judged documents (graded 0-4)
  and a run that drops a tenth of them and adds up to 10 unjudged ones,
  scores rounded to 6 decimals, from the seed."""
  import numpy as np
  rng = np.random.RandomState(SEED + 41)
  qrels, run = os.path.join(root, 'qrels.txt'), os.path.join(root, 'run.txt')
  with open(qrels, 'w') as fq, open(run, 'w') as fr:
    for q in range(TREC_QUERIES):
      n = rng.randint(PIPE_MIN_DOCS, L + 1)
      grades = rng.choice(5, size=n, p=[.5, .3, .15, .04, .01])
      fq.writelines(f'q{q} 0 d{q}_{i} {g}\n' for i, g in enumerate(grades))
      kept = np.flatnonzero(rng.rand(n) > 0.1)
      docs = [f'd{q}_{i}' for i in kept] + [
          f'u{q}_{i}' for i in range(rng.randint(0, 11))]
      scores = np.round(rng.randn(len(docs)) + 0.5 * np.concatenate(
          [grades[kept], np.zeros(len(docs) - len(kept))]), 6)
      order = np.argsort(-scores, kind='stable')
      fr.writelines(f'q{q} Q0 {docs[i]} {r} {scores[i]:.6f} smoke\n'
                    for r, i in enumerate(order, 1))
  return qrels, run


def _trec_eval(root):
  """Phase 19c: ``trec.evaluate_run`` on the card and on the CPU."""
  from ranking_tpu_torch.data import trec
  qrels, run = _write_trec_files(root)
  out, results = {}, {}
  for where, device in (('card', 'cuda'), ('cpu', 'cpu')):
    t0 = time.perf_counter()
    results[where] = trec.evaluate_run(qrels, run, TREC_SPEC, batch_size=B,
                                       device=device)
    out[f'{where}_ms_per_query'] = ((time.perf_counter() - t0) * 1e3
                                    / TREC_QUERIES)
  worst = _metrics_close('TREC run, card vs CPU', results['card'],
                         results['cpu'])
  out.update(metrics=len(results['card']), max_abs_diff=worst,
             values=results['card'])
  _log(f'trec: {TREC_QUERIES} queries of 20-200 judged documents, a run '
       f'that drops a tenth and adds unjudged ones; {len(results["card"])} '
       f'metrics, card == CPU within {worst:.3g}; '
       f'{out["card_ms_per_query"]:.4f} ms a query on the card, '
       f'{out["cpu_ms_per_query"]:.4f} on the CPU (host clock, file reads '
       'included)')
  return out


_SERVE_DRIVER = """
import json, statistics, sys, time
sys.modules['ranking_tpu_torch.models'] = None   # importing it raises
import numpy as np, torch
from ranking_tpu_torch.data import parsers, tfrecord
from ranking_tpu_torch.pipeline import export
request = list(tfrecord.read_records({request!r}))
singles = list(tfrecord.read_records({singles!r}))
pointwise = list(tfrecord.read_records({pointwise!r}))
out = {{}}
for name, path in {paths!r}.items():
  lp = export.load_predictor(path, device='cuda')
  scores = lp.predict(request)
  reg, pred1 = lp.regress(pointwise), lp.predict(singles)
  bucket = lp._bucket_for(int(parsers.elwc_list_sizes(request).max()))
  parse_ms, device_ms, predict_ms = [], [], []
  for _ in range(7):
    t0 = time.perf_counter()
    parsed = parsers.parse(request, lp.context_feature_spec,
                           lp.example_feature_spec, bucket)
    t1 = time.perf_counter()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    lp._run(parsed, bucket)
    end.record()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    lp.predict(request)
    predict_ms.append((time.perf_counter() - t2) * 1e3)
    parse_ms.append((t1 - t0) * 1e3)
    device_ms.append(start.elapsed_time(end))
  np.savez({root!r} + f'/{{name}}_scores.npz', scores=scores, reg=reg,
           pred1=pred1)
  out[name] = {{'parse_ms': statistics.median(parse_ms[2:]),
               'device_ms': statistics.median(device_ms[2:]),
               'predict_ms': statistics.median(predict_ms[2:]),
               'variables_on': str(next(iter(
                   torch.utils._pytree.tree_leaves(lp.variables))).device)}}
blocked = sorted(m for m, mod in sys.modules.items() if mod is not None
                 and m.startswith('ranking_tpu_torch.models'))
out['models_imported'] = blocked
print(json.dumps(out))
"""


def _export_phase(model, root):
  """Phase 19d: ``export_predictor`` of the flagship model on the CPU,
  float32 and int8, served on the card by ``load_predictor`` in a fresh
  process that cannot import ``ranking_tpu_torch.models``."""
  import copy
  import numpy as np
  from ranking_tpu_torch.data import batch as batch_lib
  from ranking_tpu_torch.data import proto, tfrecord
  from ranking_tpu_torch.models import layers
  from ranking_tpu_torch.pipeline import export, serving
  context, example = _elwc_specs()
  cpu_model = copy.deepcopy(model).to('cpu')
  sample = batch_lib.batch_from_labels(
      np.zeros((2, EXPORT_BUCKETS[-1]), np.float32),
      examples={'float_features': np.zeros((2, EXPORT_BUCKETS[-1], F),
                                           np.float32)})
  paths, export_s, sizes = {}, {}, {}
  for name, quantize in (('float32', None), ('int8', 'int8')):
    paths[name] = os.path.join(root, f'artifact_{name}')
    t0 = time.perf_counter()
    export.export_predictor(cpu_model, None, context, example, paths[name],
                            sample, list_size_buckets=EXPORT_BUCKETS,
                            label_feature_name='relevance',
                            quantize=quantize)
    export_s[name] = time.perf_counter() - t0
    sizes[name] = os.path.getsize(os.path.join(paths[name], 'params.npz'))
    with open(os.path.join(paths[name], 'manifest.json')) as f:
      if 'devices' in json.load(f):
        _fail(f'export {name}: the program names a device')
  # One list at L, so that the live Predictor's bucket is the artifact's.
  x, labels, counts = proto.random_lists(B - 1, F, PIPE_MIN_DOCS, L,
                                         seed=SEED + 43)
  x_top, labels_top, _ = proto.random_lists(1, F, L, L, seed=SEED + 44)
  x = np.concatenate([x_top, x])
  labels = np.concatenate([labels_top, labels])
  counts = np.concatenate([[L], counts])
  starts = np.concatenate([[0], np.cumsum(counts)])
  lists = [[{'float_features': x[d], 'relevance': labels[d:d + 1]}
            for d in range(starts[i], starts[i + 1])] for i in range(B)]
  files = {'request': [proto.make_elwc({}, docs) for docs in lists],
           'singles': [proto.make_elwc({}, docs[:1]) for docs in lists],
           'pointwise': [proto.make_example(docs[0]) for docs in lists]}
  for k, records in files.items():
    tfrecord.write_records(os.path.join(root, f'{k}.tfrecord'), records)
  driver = _SERVE_DRIVER.format(
      root=root, paths=paths,
      **{k: os.path.join(root, f'{k}.tfrecord') for k in files})
  proc = subprocess.run([sys.executable, '-c', driver], capture_output=True,
                        text=True, timeout=600,
                        cwd=os.path.dirname(os.path.abspath(__file__)))
  if proc.returncode != 0:
    _fail(f'export: serving the artifact failed:\n{proc.stderr[-3000:]}')
  served = json.loads(proc.stdout.strip().splitlines()[-1])
  if served.pop('models_imported'):
    _fail('export: the serving process imported ranking_tpu_torch.models')
  live = serving.Predictor(model, None, context, example,
                           label_feature_name='relevance', device='cuda')
  want = live.predict(files['request'])
  got = {name: np.load(os.path.join(root, f'{name}_scores.npz'))
         for name in paths}
  mask = np.arange(want.shape[1])[None, :] < counts[:, None]
  scale = float(np.abs(want[mask]).max())
  f32, q8 = got['float32']['scores'], got['int8']['scores']
  float_err = float(np.abs(f32[mask] - want[mask]).max())
  if (f32.shape != want.shape
      or not np.allclose(f32[mask], want[mask], rtol=1e-4, atol=1e-4 * scale)
      or not (f32[~mask] == np.float32(layers.PADDING_LOGIT)).all()):
    _fail(f'export: the float artifact\'s predict != the live Predictor\'s '
          f'(max |diff| {float_err}, largest {scale})')
  int8_err = float(np.abs(q8[mask] - f32[mask]).max())
  fscale = float(np.abs(f32[mask]).max())
  # The top document of each list: where int8 picks another one, the two
  # must be a near-tie of the float scores (INT8_SWAP_GAP), in at most
  # INT8_MAX_SWAPS lists; the gaps are reported.
  top_f = np.argmax(np.where(mask, f32, -np.inf), axis=1)
  top_q = np.argmax(np.where(mask, q8, -np.inf), axis=1)
  rows = np.arange(B)
  gaps = (f32[rows, top_f] - f32[rows, top_q])[top_f != top_q]
  if (int8_err > INT8_TOL * fscale or (gaps > INT8_SWAP_GAP * fscale).any()
      or len(gaps) > INT8_MAX_SWAPS):
    _fail(f'export: int8 scores {int8_err} from the float ones (bound '
          f'{INT8_TOL * fscale}); top documents swapped in {len(gaps)} lists '
          f'(at most {INT8_MAX_SWAPS}) at float gaps {gaps.tolist()} (bound '
          f'{INT8_SWAP_GAP * fscale})')
  regress_err = {}
  for name, z in got.items():
    regress_err[name] = float(np.abs(z['reg'] - z['pred1'][:, 0]).max())
    if not np.allclose(z['reg'], z['pred1'][:, 0], rtol=1e-4,
                       atol=1e-4 * np.abs(z['pred1']).max()):
      _fail(f'export {name}: regress != predict on lists of one '
            f'({regress_err[name]})')
  out = {'export_s': export_s, 'params_npz_bytes': sizes,
         'float_max_abs_diff_vs_live': float_err,
         'int8_max_abs_diff_vs_float': int8_err, 'float_largest': fscale,
         'int8_top_swaps_float_gaps': gaps.tolist(),
         'regress_max_abs_diff_vs_predict': regress_err,
         'documents': int(counts.sum()), 'served': served}
  _log(f'export: the flagship model exported on the CPU (buckets '
       f'{EXPORT_BUCKETS}; float32 {export_s["float32"]:.2f} s, int8 '
       f'{export_s["int8"]:.2f} s), params.npz {sizes["float32"]} / '
       f'{sizes["int8"]} bytes; served on the card by a process that cannot '
       f'import ranking_tpu_torch.models: {B} ELWCs ({int(counts.sum())} '
       f'documents), float32 == live Predictor.predict within {float_err:.3g}'
       f' (largest {scale:.3g}), int8 within {int8_err:.3g} of float32 '
       f'(bound {INT8_TOL * fscale:.3g}), the same top document in '
       f'{B - len(gaps)} of {B} lists (the others, at most '
       f'{INT8_MAX_SWAPS}, swap a near-tie, float gaps '
       f'{[round(float(g), 6) for g in gaps]}, bound '
       f'{INT8_SWAP_GAP * fscale:.3g}); '
       f'regress == predict on lists of one within '
       f'{max(regress_err.values()):.3g}; request: ' + '; '.join(
           f'{k} parse {v["parse_ms"]:.3f} ms, device {v["device_ms"]:.3f} '
           f'ms by events, predict {v["predict_ms"]:.3f} ms'
           for k, v in served.items()))
  return out


def _eval_phase(gen, model, eval_batches):
  """Phase 19: evaluation and the serving artifact on the card."""
  import shutil
  import torch
  root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      '.scratch', 'chip_smoke_eval')
  shutil.rmtree(root, ignore_errors=True)
  os.makedirs(root)
  try:
    suite, card_logits = _suite_and_graph(model, eval_batches, gen)
    query_ids = _query_id_eval(model, eval_batches, card_logits, root)
    trec_numbers = _trec_eval(root)
    exported = _export_phase(model, root)
    torch.cuda.empty_cache()
    return {'suite': suite, 'query_ids': query_ids, 'trec': trec_numbers,
            'export': exported}
  finally:
    shutil.rmtree(root, ignore_errors=True)


# --- phase 21: the rest of the loss zoo and multi-task training ---------------

# The 20 keys beyond the softmax and four pairwise keys of phases 7-12.
ZOO_KEYS = (
    'yeti_logistic_loss', 'circle_loss', 'calibrated_softmax_loss',
    'poly_one_softmax_loss', 'unique_softmax_loss',
    'sigmoid_cross_entropy_loss', 'mean_squared_loss', 'list_mle_loss',
    'approx_ndcg_loss', 'approx_mrr_loss', 'gumbel_approx_ndcg_loss',
    'neural_sort_cross_entropy_loss', 'gumbel_neural_sort_cross_entropy_loss',
    'neural_sort_ndcg_loss', 'gumbel_neural_sort_ndcg_loss', 'ordinal_loss',
    'multi_class_loss', 'click_em_loss', 'mixture_em_loss',
    'coupled_rankdistil_loss')
# (output units, loss params) of the heads that are not one logit, and the
# keys trained on binary click labels (benchmarks/keras_extras_quality.py:
# 66-77); graded labels 0-4 for the rest.
ZOO_HEADS = {'ordinal_loss': (4, {'ordinal_size': 4}),
             'multi_class_loss': (5, {'num_classes': 5, 'from_logits': True}),
             'click_em_loss': (2, {}), 'mixture_em_loss': (3, {})}
ZOO_BINARY = ('click_em_loss', 'mixture_em_loss')
# Row 1's launches a train step, counted on the card by torch.profiler.
ZOO_SORT_KEYS = ('approx_ndcg_loss', 'neural_sort_ndcg_loss',
                 'gumbel_approx_ndcg_loss')
# The card's float32 loss and logit gradient against a float64 recompute
# on the CPU of the same logits. The value: float32 sums of up to 1024 x
# 200 x 200 terms (the Gumbel NeuralSort keys), 1e-4 of the float64 value.
# The gradient, as a share of its largest entry: exponents of up to
# L * |s| (NeuralSort's rank coefficients times the logits, ~1e3) carry
# float32 rounding of about 1e3 * 6e-8 into each softmax weight, so 1e-3;
# where a key is worse conditioned than that (NeuralSort over Gumbel
# log-probabilities), the gradient passes if it is no more than twice as
# far from float64 as the same float32 computation on the CPU.
ZOO_VALUE_TOL, ZOO_GRAD_TOL = 1e-4, 1e-3
# The one-logit keys that adding one number to every valid logit leaves
# unchanged (functions of logit differences, or of standardized logits),
# so that the output bias's gradient is zero in theory; checked in float64
# on the CPU (``ZOO_SHIFT_TOL``: the padding logit, log(1e-10), still
# enters a softmax's sum at ~1e-10 an item).
ZOO_SHIFT_INVARIANT = frozenset((
    'softmax_loss', 'yeti_logistic_loss', 'poly_one_softmax_loss',
    'unique_softmax_loss', 'list_mle_loss', 'approx_ndcg_loss',
    'approx_mrr_loss', 'gumbel_approx_ndcg_loss',
    'neural_sort_cross_entropy_loss', 'gumbel_neural_sort_cross_entropy_loss',
    'neural_sort_ndcg_loss', 'gumbel_neural_sort_ndcg_loss',
    'coupled_rankdistil_loss'))
ZOO_SHIFT_TOL = 1e-9
# Phase 21c and 21d's train files: half of phase 18's lists (the stream
# repeats over its 50 steps), which halves the time spent writing them.
ZOO_TRAIN_LISTS = PIPE_TRAIN_LISTS // 2
MT_TASKS = ('relevance', 'click')
MT_LOSSES = {'relevance': 'softmax_loss', 'click': 'sigmoid_cross_entropy_loss'}
MT_WEIGHTS = {'relevance': 1.0, 'click': 0.3}


def _zoo_batch(gen, binary=False):
  """A flat flagship batch; with ``binary`` its graded labels become clicks
  (label > 0)."""
  import torch
  from ranking_tpu_torch.data import dataset
  batch = _make_batch(gen, B)
  if binary:
    batch = batch.replace(labels=torch.where(
        batch.mask, (batch.labels > 0).to(torch.float32), -1.0))
  return dataset.flatten_examples(batch)


@contextlib.contextmanager
def _recording_tower(model):
  """Inside, a train step of ``model`` records what its backward started
  from: each hidden layer's ReLU gates (which units of its [N, F] output
  were open: ``y * s + t > 0``, the product and the sum each rounded to
  float32, as the kernels' ``scale_shift`` and the plain versions do) and
  the gradient of the loss with respect to ``model``'s output. Yields a
  dict that has 'gates' and 'dlogits' after the block. The wrappers'
  launch counts are as without it."""
  from ranking_tpu_torch.ops.cuda import fused_bn
  ys, folds, rec = [], [], {}
  layer_forward, bn_fold = fused_bn.layer_forward, fused_bn._bn_fold

  def record_layer(*args, **kwargs):
    out = layer_forward(*args, **kwargs)
    ys.append(out[0])
    return out

  def record_fold(*args, **kwargs):
    out = bn_fold(*args, **kwargs)
    folds.append(out)
    return out

  def record_output(module, inputs, output):
    output.register_hook(lambda g: rec.update(dlogits=g.detach().clone()))

  record_layer.launches = 0   # the wrapper counts on its module's name
  handle = model.register_forward_hook(record_output)
  try:
    with mock.patch.object(fused_bn, 'layer_forward', record_layer), \
        mock.patch.object(fused_bn, '_bn_fold', record_fold):
      yield rec
  finally:
    handle.remove()
    layer_forward.launches += record_layer.launches
  layers = len(model.scorer.tower.bn)
  if len(ys) != layers or len(folds) != layers or 'dlogits' not in rec:
    _fail(f'recording the tower: {len(ys)} layers, {len(folds)} folds '
          f'(not {layers}), output gradient {"dlogits" in rec}')
  rec['gates'] = [y.to(f[3].dtype) * f[3] + f[4] > 0
                  for y, f in zip(ys, folds)]


def _first_step_f64(model, batch, record):
  """The first train step's parameter gradients in float64 on the card,
  from a copy of the untrained flagship-shaped ``model``, given a float32
  step's ``record`` (``_recording_tower``): the log1p transform, the tower
  as ``fused_bn.reference_bn_mlp`` (masked batch moments over the valid
  rows, as the fused path) but with that step's ReLU gates, the output
  layer and the masked logits, whose backward starts from that step's
  gradient of the loss. So it is what that step's tower and output layer
  compute, in float64; the loss and its kernels are held on their own."""
  import copy
  import torch
  import torch.nn.functional as nnf
  from ranking_tpu_torch.models import layers
  from ranking_tpu_torch.train import steps
  model = copy.deepcopy(model).to('cuda', torch.float64)
  tower = model.scorer.tower
  b = steps.restore_flat_examples(batch.to('cuda'))
  # One float feature: the flagship batches' 'features', ranking_libsvm's
  # 'float_features'.
  (x,) = b.examples.values()
  x = x.to(torch.float64)
  h = (torch.sign(x) * torch.log1p(torch.abs(x))).reshape(-1, F)
  m = b.mask.reshape(-1, 1).to(torch.float64)
  n = m.sum().clamp(min=1.0)
  for dense, bn, gate in zip(tower.dense[:-1], tower.bn, record['gates']):
    y = h @ dense.weight.t() + dense.bias
    mu = (y * m).sum(0) / n
    var = torch.clamp((y * y * m).sum(0) / n - mu * mu, min=0.0)
    h = ((y - mu) * torch.rsqrt(var + bn.eps) * bn.weight + bn.bias) * gate
  out = nnf.linear(h, tower.dense[-1].weight, tower.dense[-1].bias)
  out = out.reshape(b.mask.shape + out.shape[-1:])
  if out.shape[-1] == 1:
    logits = torch.where(b.mask, out[..., 0], layers.PADDING_LOGIT)
  else:
    logits = torch.where(b.mask[:, :, None], out, layers.PADDING_LOGIT)
  logits.backward(record['dlogits'].to(torch.float64))
  return {k: p.grad for k, p in model.named_parameters()}


@contextlib.contextmanager
def _card_decisions(replay=None):
  """Inside, the two places where a loss of the zoo turns float32 rounding
  into a different answer give up what they computed: every
  ``list_ops.sort_by_scores`` call its order (``[B, topn]`` int64 positions,
  asked of the same call as one more float channel, so that a call the
  sort kernel takes still takes it) with its scores as float64, and every
  ``sorting.gumbel_sample_lists`` call its sampled logits. Yields
  ``{'sorts': [...], 'samples': [...]}``, in call order. With ``replay``
  (such a record of an earlier run of the same code) sort i reorders its
  features by that run's order i instead of sorting, and sample i takes
  that run's sampled logits as its value (the gradient stays this run's),
  while the record keeps this run's own scores and samples: a comparison
  then holds the arithmetic, not the rank decisions or the rounding of the
  samples, which are held on their own against this run's."""
  import torch
  from ranking_tpu_torch.ops import sorting
  from ranking_tpu_torch.utils import list_ops
  sort_by_scores = list_ops.sort_by_scores
  sample_lists = sorting.gumbel_sample_lists
  record = {'sorts': [], 'samples': []}

  def keys(scores, mask):
    """The scores as float64, masked items below every valid one (a sort
    puts them last)."""
    scores = scores.detach().double().cpu()
    if mask is None:
      return scores
    low = scores.min(dim=1, keepdim=True).values - 1.0
    return torch.where(mask.cpu().to(torch.bool), scores, low)

  def sorts(scores, features_list, topn=None, **kwargs):
    if replay is not None:
      order = replay['sorts'][len(record['sorts'])][0].to(scores.device)
      record['sorts'].append((order, keys(scores, kwargs.get('mask'))))
      return [list_ops.gather_per_row(f, order) for f in features_list]
    positions = torch.arange(scores.shape[1], dtype=torch.float32,
                             device=scores.device).expand(scores.shape)
    *out, order = sort_by_scores(scores, list(features_list) + [positions],
                                 topn=topn, **kwargs)
    record['sorts'].append((order.to(torch.int64),
                            keys(scores, kwargs.get('mask'))))
    return out

  def samples(*args, **kwargs):
    labels, logits, weights = sample_lists(*args, **kwargs)
    record['samples'].append(logits.detach())
    if replay is not None:
      card = replay['samples'][len(record['samples']) - 1]
      logits = logits + (card.to(logits.device, logits.dtype)
                         - logits).detach()
    return labels, logits, weights

  with mock.patch.object(list_ops, 'sort_by_scores', sorts), \
      mock.patch.object(sorting, 'gumbel_sample_lists', samples):
    yield record


# Two float32 sort keys computed from the same float64 value are ordered
# the other way round only where the float64 values lie within both
# computations' rounding of each other. A key that differs by rounding is a
# float32 result of a few operations each rounded to nearest (CRD's sampled
# teacher: a sum, a subtracted maximum, an exponential, a division by the
# row's sum, a log: five, each within u = 2^-24 of its result relative),
# and the log of the row's sum shifts every key of a row alike, which
# cannot swap two of them. So two keys swap only if their float64 gap is
# below 2 x 5u of the larger magnitude; rounded up to 2^-20 (16u).
ZOO_TIE_GAP = 2.0 ** -20
# A Gumbel-sampled logit s = log(softmax(z) + 1e-20), z = (x + g) / t, in
# float32 against float64, per entry: the sum z and the subtracted maximum
# (2u |z| each), the exponential, the division and the added 1e-20 (u
# each, relative), the row's sum of L exponentials (at most L u relative,
# any order) and the log (u |s| plus the relative error of its argument).
# With |z| <= 1 + |s| past the maximum: (L + 8) u (1 + |s|).
ZOO_SAMPLE_ROUNDINGS = 8


def _order_inversions(card_sorts, replayed_sorts):
  """How the orders a float32 run on the card chose (``card_sorts``) order
  the float64 scores that a run replaying them computed at the same calls
  (``replayed_sorts``): the lists where some later item has a larger
  float64 score than an earlier one, and the largest such inversion, as a
  share of the larger of the two scores and 1 (a magnitude below 1 rounds
  at the same absolute grain). Returns (lists inverted, lists sorted,
  largest inversion)."""
  import torch
  inverted = total = 0
  worst = 0.0
  for (card, _), (_, scores) in zip(card_sorts, replayed_sorts):
    s = torch.gather(scores, 1, card.cpu())
    gap = (s[:, 1:] - s[:, :-1]) / torch.maximum(
        torch.maximum(s[:, 1:].abs(), s[:, :-1].abs()),
        torch.ones_like(s[:, 1:]))
    total += card.shape[0]
    if gap.numel():
      inverted += int((gap > 0).any(dim=1).sum())
      worst = max(worst, float(gap.max().clamp(min=0.0)))
  return inverted, total, worst


def _sample_rounding(card_samples, own_samples, list_size):
  """The largest distance of the card's float32 Gumbel-sampled logits from
  the float64 run's, as a share of its bound (``ZOO_SAMPLE_ROUNDINGS``);
  0 where the loss samples none."""
  worst = 0.0
  u = 2.0 ** -24
  for card, own in zip(card_samples, own_samples):
    own = own.cpu()
    bound = (list_size + ZOO_SAMPLE_ROUNDINGS) * u * (1.0 + own.abs())
    worst = max(worst, float(((card.cpu().double() - own).abs()
                              / bound).max()))
  return worst


def _zoo_loss_check(key, loss_fn, model, batch):
  """The loss and its logit gradient on the card, at the logits of a
  train-mode forward of ``model`` (a copy: the forward moves the running
  statistics), against the same loss in float64 on the CPU of the same
  logits, which takes the card's own rank decisions and Gumbel-sampled
  logits (``_card_decisions``): where a loss sorts float32 scores that lie
  within rounding of each other (CRD's sampled teacher), the loss is
  discontinuous there and either order is right; and NeuralSort over
  sampled log-probabilities turns each ulp of a sample into a large change
  of the gradient, whatever computes it. Those inputs are held on their
  own against the float64 scores and samples of the same recompute: the
  card's orders may invert the float64 scores by ``ZOO_TIE_GAP`` only, and
  its samples must lie within their rounding bound of the float64 ones. The same code also runs in float64
  on the card, which shows whether the card computes what the CPU does.
  Returns the readings, as shares of the float64 value and largest
  gradient entry: value and gradient errors, the float32 CPU's gradient
  error where the card's is beyond ZOO_GRAD_TOL, the float64 card's, and
  the decisions'."""
  import torch
  from ranking_tpu_torch.train import steps
  model = model.to('cuda')
  b = steps.restore_flat_examples(batch.to('cuda'))
  logits = model(b.context, b.examples, b.mask, training=True).detach()
  card = logits.clone().requires_grad_()
  with _card_decisions() as decisions:
    value = loss_fn(b.labels, card)
  value.backward()
  cpu = logits.to('cpu', torch.float64).requires_grad_()
  with _card_decisions(replay=decisions) as replayed:
    want = loss_fn(b.labels.cpu(), cpu)
  want.backward()
  if want.dtype != torch.float64:
    _fail(f'zoo {key}: the CPU recompute ran in {want.dtype}')
  differ, lists, inversion = _order_inversions(decisions['sorts'],
                                               replayed['sorts'])
  sampled = _sample_rounding(decisions['samples'], replayed['samples'],
                             logits.shape[1])
  if inversion > ZOO_TIE_GAP:
    _fail(f'zoo {key}: the card sorted {differ} of {lists} lists against '
          f'the float64 scores, inverting scores {inversion:.3g} apart (more '
          f'than rounding, {ZOO_TIE_GAP:.3g})')
  if sampled > 1.0:
    _fail(f'zoo {key}: the card\'s Gumbel-sampled logits lie {sampled:.3g} '
          'times their rounding bound from float64')
  card64 = logits.double().requires_grad_()
  with _card_decisions(replay=decisions):
    value64 = loss_fn(b.labels, card64)
  value64.backward()
  if key in ZOO_SHIFT_INVARIANT:
    mask = b.mask.cpu()
    with _card_decisions(replay=decisions):
      shifted = loss_fn(b.labels.cpu(), torch.where(
          mask, cpu.detach() + 0.37, cpu.detach()))
    shift_err = abs(shifted.item() - want.item()) / abs(want.item())
    if not shift_err <= ZOO_SHIFT_TOL:
      _fail(f'zoo {key}: listed in ZOO_SHIFT_INVARIANT, but a shift of '
            f'every valid logit moves the float64 loss by {shift_err:.3g}')
  value_err = abs(value.item() - want.item()) / max(abs(want.item()), 1e-30)

  def grad_error(grad):
    return ((grad.cpu().double() - cpu.grad).abs().max()
            / cpu.grad.abs().max().clamp(min=1e-30)).item()

  grad_err, cpu32_err = grad_error(card.grad), None
  card64_err = grad_error(card64.grad)
  if not math.isfinite(value.item()) or not torch.isfinite(card.grad).all():
    _fail(f'zoo {key}: the loss or its gradient is not finite on the card')
  if grad_err > ZOO_GRAD_TOL:
    # The same float32 computation on the CPU: if it is as far from
    # float64, float32 and not the card makes the difference.
    cpu32 = logits.to('cpu', copy=True).requires_grad_()
    with _card_decisions(replay=decisions):
      loss_fn(b.labels.cpu(), cpu32).backward()
    cpu32_err = grad_error(cpu32.grad)
  readings = {'value_err': value_err, 'grad_err': grad_err,
              'grad_err_cpu_float32': cpu32_err,
              'grad_err_card_float64': card64_err,
              'lists_inverted': differ, 'lists_sorted': lists,
              'largest_inversion': inversion,
              'samples_over_rounding_bound': sampled}
  _log(f'zoo {key}: loss check {readings}')
  if value_err > ZOO_VALUE_TOL or (
      grad_err > ZOO_GRAD_TOL and grad_err > 2 * cpu32_err):
    _fail(f'zoo {key}: card vs float64 CPU: value {value.item()} vs '
          f'{want.item()} ({value_err:.3g}), gradient {grad_err:.3g} of its '
          f'largest entry (tolerances {ZOO_VALUE_TOL}, {ZOO_GRAD_TOL}, or '
          f'twice float32 on the CPU: {cpu32_err})')
  return readings


def _zoo_first_step(key, gen, batches, force_anchor=False):
  """Phase 21a's checks of one key's first step: the loss on the card
  against float64, then the flagship train step against the plain
  versions (rows 1-8 off). Returns (readings, step, state after the step,
  batch). ``force_anchor`` holds the kernels' and the plain versions'
  steps against float64 even where the step is within OP_TOL."""
  import copy
  from ranking_tpu_torch.ops import loss_registry
  from ranking_tpu_torch.train import state as state_lib
  from ranking_tpu_torch.train import steps
  units, params = ZOO_HEADS.get(key, (1, {}))
  batch = batches['binary' if key in ZOO_BINARY else 'graded']
  loss_fn = loss_registry.make_loss_fn(key, params=params)
  step = steps.make_train_step(loss_fn, device='cuda')
  model = _train_model(gen, output_units=units)
  twin, anchor_model = copy.deepcopy(model), copy.deepcopy(model)
  loss_check = _zoo_loss_check(key, loss_fn, copy.deepcopy(model), batch)
  state = state_lib.create_train_state(model, state_lib.adam(1e-3),
                                       device='cuda')
  with _recording_tower(state.model) as first_record:
    state, metrics = step(state, batch)
  first_loss = metrics['loss'].item()
  if not math.isfinite(first_loss):
    _fail(f'zoo {key}: first loss {first_loss}')
  first_grads, first_stats = _snapshot_first_step(state)

  hold = _hold_first_step(f'zoo {key}', step, twin, batch, first_loss,
                          first_grads, first_stats, plain_sort=True,
                          zero_names=_zero_in_theory(
                              twin, key in ZOO_SHIFT_INVARIANT),
                          zero_tol=_zero_tol(twin, loss_fn, batch),
                          anchor=lambda rec: _first_step_f64(anchor_model,
                                                             batch, rec),
                          first_record=first_record,
                          force_anchor=force_anchor)
  out = {'first_loss': first_loss, **loss_check, 'first_step': hold}
  return out, step, state, batch


def _anchor_sweep(seeds):
  """``--anchor-seeds``: ``_zoo_first_step`` of every key with
  ``force_anchor``, for the default run's generator (SEED + 40) and
  ``seeds`` - 1 others. A failed check is recorded and the sweep goes on.
  Returns ({key: [readings a seed]}, failures)."""
  import torch
  out, failures = {}, []
  for i in range(seeds):
    gen = torch.Generator().manual_seed(SEED + 40 + 1000 * i)
    batches = {'graded': _zoo_batch(gen), 'binary': _zoo_batch(gen, True)}
    for key in ('softmax_loss',) + ZOO_KEYS:
      try:
        readings, *_ = _zoo_first_step(key, gen, batches, force_anchor=True)
        out.setdefault(key, []).append(
            {k: v for k, v in readings.items() if k != 'first_loss'})
      except SystemExit as e:
        failures.append(f'seed {i}: {e}')
        out.setdefault(key, []).append({'failed': str(e)})
        _log(str(e))
      gc.collect()
      torch.cuda.empty_cache()
  return out, failures


def _zoo_key(key, gen, batches):
  """Phase 21a for one key: ``_zoo_first_step``, then K = 10 steps a
  dispatch as graph replays, timed by CUDA events; peak device memory;
  for ZOO_SORT_KEYS, row 1 on the card by torch.profiler against the
  wrapper's count in one eager step."""
  import torch
  from ranking_tpu_torch.ops.cuda import sort as cuda_sort
  from ranking_tpu_torch.train import steps
  out, step, state, batch = _zoo_first_step(key, gen, batches)
  value_err, grad_err = out['value_err'], out['grad_err']
  cpu32_err = out['grad_err_cpu_float32']
  if key in ZOO_SORT_KEYS:
    before = cuda_sort.sorted_values_and_ranks.launches
    card = _kernel_counts(lambda: step(state, batch)).get(
        'rank_sort_kernel', 0)
    wrapper = cuda_sort.sorted_values_and_ranks.launches - before
    if card != wrapper or card == 0:
      _fail(f'zoo {key}: rank_sort_kernel ran {card} times on the card in '
            f'one step; the wrapper counted {wrapper}')
    out['sort_launches_card'] = card
  stacked = steps.stack_batches([batch] * KSTEPS).to('cuda')
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  base = torch.cuda.memory_allocated()
  graphed = steps.make_multi_step(step, device='cuda')
  state, metrics = graphed(state, stacked, None)
  losses = metrics['loss'].tolist()
  if graphed.captures != 1 or not all(math.isfinite(v) for v in losses):
    _fail(f'zoo {key}: {graphed.captures} captures, losses {losses}')
  ms = _event_ms(lambda: graphed(state, stacked, None), 3, warmup=1) / KSTEPS
  peak = torch.cuda.max_memory_allocated()
  out.update(graph_ms_per_step=ms, peak_mib=peak / 2 ** 20,
             peak_over_state_mib=(peak - base) / 2 ** 20,
             launches_per_step=dict(graphed.captured_launches),
             losses_graph=losses)
  if key in ZOO_SORT_KEYS and (graphed.captured_launches.get(
      'sorted_values_and_ranks', 0) != out['sort_launches_card']):
    _fail(f'zoo {key}: the capture recorded '
          f'{graphed.captured_launches} launches; one eager step ran '
          f'{out["sort_launches_card"]} sorts on the card')
  _log(f'zoo {key}: card vs float64 value {value_err:.3g}, gradient '
       f'{grad_err:.3g}'
       + (f' (float32 on the CPU {cpu32_err:.3g})' if cpu32_err else '')
       + f'; {ms:.4f} ms a step (K = {KSTEPS} graph replays), peak '
       f'{out["peak_mib"]:.0f} MiB ({out["peak_over_state_mib"]:.0f} over '
       f'the state and batches), launches a step {out["launches_per_step"]}'
       + (f', rank_sort_kernel {out["sort_launches_card"]} a step on the card'
          if key in ZOO_SORT_KEYS else ''))
  del state, graphed, stacked
  gc.collect()   # a captured graph's memory goes with its last reference
  torch.cuda.empty_cache()
  return out


def _zoo_graph_vs_eager(gen):
  """Phase 21b: after a first dispatch (warm-up and capture), 10 replays on
  the state and 10 eager steps on a copy of it, on the same fresh
  batches, must be bitwise equal (every parameter, buffer, moment, step
  tensor, rate and count, and the per-step losses): Gumbel approx NDCG and
  ListMLE drawing from a CUDA generator (each eager copy from a copy of
  its state), approx NDCG with no generator (the kept draws)."""
  import copy
  import torch
  from ranking_tpu_torch.ops import loss_registry
  from ranking_tpu_torch.train import state as state_lib
  from ranking_tpu_torch.train import steps
  out = {}
  for key, random in (('gumbel_approx_ndcg_loss', True),
                      ('list_mle_loss', True), ('approx_ndcg_loss', False)):
    step = steps.make_train_step(loss_registry.make_loss_fn(key),
                                 device='cuda')
    warm = steps.stack_batches([_zoo_batch(gen) for _ in range(KSTEPS)]).to(
        'cuda')
    run = steps.stack_batches([_zoo_batch(gen) for _ in range(KSTEPS)]).to(
        'cuda')
    state = state_lib.create_train_state(_train_model(gen),
                                         state_lib.adam(1e-3), device='cuda')
    rng = (torch.Generator(device='cuda').manual_seed(SEED) if random
           else None)

    def rng_copy():
      if rng is None:
        return None
      twin_rng = torch.Generator(device='cuda')
      twin_rng.set_state(rng.get_state())
      return twin_rng

    graphed = steps.make_multi_step(step, device='cuda')
    eager = steps.make_multi_step(step, device='cuda', eager=True)
    state, _ = graphed(state, warm, rng)
    twin, twin_rng = copy.deepcopy(state), rng_copy()
    state, graph_metrics = graphed(state, run, rng)
    twin, eager_metrics = eager(twin, run, twin_rng)
    torch.cuda.synchronize()
    differ, worst = _state_diff(state, twin)
    if (graphed.captures != 1 or differ
        or not torch.equal(graph_metrics['loss'], eager_metrics['loss'])):
      _fail(f'zoo graph vs eager {key}: {graphed.captures} captures, '
            f'{len(differ)} tensors differ ({differ[:4]}, worst {worst:.3g}), '
            f'losses {graph_metrics["loss"].tolist()} vs '
            f'{eager_metrics["loss"].tolist()}')
    out[key] = {'generator': 'cuda' if random else None, 'bitwise': True,
                'replays': graphed.replays}
    _log(f'zoo graph vs eager {key} ('
         + ('CUDA generator' if random else 'no generator')
         + f'): {KSTEPS} replays == {KSTEPS} eager steps bitwise')
    del state, twin, graphed, eager, warm, run
    gc.collect()
    torch.cuda.empty_cache()
  return out


def _write_click_elwc(path, num_lists, seed):
  """ELWC lists in phase 18's shape (``proto.random_lists``) with an int64
  ``click`` a document: a relevant document is clicked with probability
  0.7, an irrelevant one never (examples/multitask_ranking.py:43-69)."""
  import numpy as np
  from ranking_tpu_torch.data import proto
  from ranking_tpu_torch.data import tfrecord
  x, labels, counts = proto.random_lists(num_lists, F, PIPE_MIN_DOCS, L, seed)
  clicks = ((labels > 0)
            & (np.random.RandomState(seed + 1000).rand(len(labels)) < 0.7)
            ).astype(np.int64)
  starts = np.concatenate([[0], np.cumsum(counts)])
  tfrecord.write_records(path, (proto.make_elwc({}, [
      {'float_features': x[d], 'relevance': labels[d:d + 1],
       'click': clicks[d:d + 1]} for d in range(starts[i], starts[i + 1])])
      for i in range(num_lists)))
  return int(clicks.sum()), int((labels > 0).sum())


def _hold_graphed_eval(what, pipe, builder, history):
  """The pipeline's own graphed eval (captured in its validation pass on the
  trained model) against the eager step it wraps, on the validation lists:
  its replays must equal the eager step bit for bit (metric states and
  logits, a dict of them for a multi-task model), and the history's
  val_loss and metrics must be the eager results. Returns the eager
  results."""
  import torch
  from ranking_tpu_torch.data import dataset
  from ranking_tpu_torch.train import steps
  trained = pipe.final_state.model
  graphed_eval = pipe._eval_step
  captures = graphed_eval.captures
  batches = list(dataset.prefetch_to_device(builder.valid_batches(), 'cuda',
                                            flat_examples=True))

  def eval_pass(step_fn):
    states = steps.init_metric_states(pipe.metric_fns, with_loss=True,
                                      device='cuda')
    logits = []
    for batch in batches:
      states, lg = step_fn(trained, batch, states,
                           num_valid_rows=batch.batch_size)
      logits.append(lg if isinstance(lg, dict) else {'': lg})
    return states, logits

  replays = graphed_eval.replays
  g_states, g_logits = eval_pass(graphed_eval)
  e_states, e_logits = eval_pass(graphed_eval.eval_step)
  torch.cuda.synchronize()
  equal = all(torch.equal(g_states[n].total, e_states[n].total)
              and torch.equal(g_states[n].count, e_states[n].count)
              for n in e_states) and all(
                  torch.equal(g[t], e[t]) for g, e in zip(g_logits, e_logits)
                  for t in e)
  if (not equal or captures != 1 or graphed_eval.captures != captures
      or graphed_eval.replays - replays != len(batches)):
    _fail(f'{what}: the pipeline\'s graphed eval != its eager step '
          f'({graphed_eval.captures - captures} new captures, '
          f'{graphed_eval.replays - replays} replays for {len(batches)} '
          'batches)')
  eager = {n: v.to(torch.float32).item()
           for n, v in steps.metric_results(e_states).items()}
  eager['val_loss'] = eager.pop('loss')
  differ = {k: (history[k], v) for k, v in eager.items() if history[k] != v}
  if differ:
    _fail(f'{what}: the history differs from the eager eval of the trained '
          f'model: {differ}')
  _log(f'{what}: graphed eval == eager bit for bit over {len(batches)} '
       'batches')
  return {n: st.result().item() for n, st in e_states.items()}


def _zoo_pipelines(gen):
  """Phase 21c and 21d over ELWC files in phase 18's shape (640 train
  lists in 4 files, 256 validation lists) that also carry a click a
  document. (c) ``SimplePipeline`` with ``loss='approx_ndcg_loss'`` (the
  scale-invariant recipe by default) over ``SimpleDatasetBuilder``, one
  epoch at K = 10: timed (lists/s of the replay-only window), then a second
  run under ``torch.profiler`` whose kernels on the card must equal the
  wrappers' eager calls plus captured launches x replays. (d)
  ``MultiTaskPipeline`` over ``MultiLabelDatasetBuilder``, the multi-task
  example's recipe at full width, one epoch at K = 10, then its graphed
  eval against the eager eval bit for bit. Returns (numbers, wrapper
  launches of (c)'s profiled run, its kernels on the card, wrapper
  launches of (d))."""
  import os
  import shutil
  import torch
  from ranking_tpu_torch.data import dataset
  from ranking_tpu_torch.data import parsers
  from ranking_tpu_torch.models import scorers
  from ranking_tpu_torch.pipeline import hparams as hparams_lib
  from ranking_tpu_torch.pipeline import pipeline as pipeline_lib
  from ranking_tpu_torch.train import steps
  root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      '.scratch', 'chip_smoke_zoo')
  shutil.rmtree(root, ignore_errors=True)
  os.makedirs(root)
  out = {}
  try:
    t0 = time.perf_counter()
    per_file = ZOO_TRAIN_LISTS // ELWC_TRAIN_FILES
    clicks = [_write_click_elwc(os.path.join(root, f'train-{i}.tfrecord'),
                                per_file, SEED + 20 + i)
              for i in range(ELWC_TRAIN_FILES)]
    _write_click_elwc(os.path.join(root, 'vali.tfrecord'), PIPE_VALID_LISTS,
                      SEED + 25)
    out['write_s'] = time.perf_counter() - t0
    out['clicks'], out['relevant'] = (sum(c[0] for c in clicks),
                                      sum(c[1] for c in clicks))
    _log(f'zoo: wrote {ZOO_TRAIN_LISTS} train lists in {ELWC_TRAIN_FILES} '
         f'files and {PIPE_VALID_LISTS} validation lists with clicks '
         f'({out["clicks"]} clicks on {out["relevant"]} relevant train '
         f'documents) in {out["write_s"]:.2f} s')
    example = {'float_features': parsers.FixedLenFeature((F,), 'float32',
                                                         0.0),
               'relevance': parsers.FixedLenFeature((), 'int64', 0)}
    data_hp = hparams_lib.DatasetHparams(
        train_input_pattern=os.path.join(root, 'train-*.tfrecord'),
        valid_input_pattern=os.path.join(root, 'vali.tfrecord'),
        train_batch_size=B, valid_batch_size=B, list_size=L,
        dataset_engine='native_loader')

    def hparams(model_dir, **kw):
      return hparams_lib.PipelineHparams(
          model_dir=os.path.join(root, model_dir), num_epochs=1,
          steps_per_epoch=PIPE_STEPS_PER_EPOCH, validation_steps=10 ** 6,
          learning_rate=1e-3, steps_per_execution=KSTEPS, **kw)

    # (c) The ELWC example's default loss.
    timed = []
    make_multi_step = steps.make_multi_step

    def make_timed(*args, **kwargs):
      timed.append(_TimedDispatches(make_multi_step(*args, **kwargs)))
      return timed[-1]

    pipe = pipeline_lib.SimplePipeline(
        _train_model(gen), pipeline_lib.SimpleDatasetBuilder(
            {}, example, data_hp, seed=SEED),
        hparams('approx_timed', loss='approx_ndcg_loss'), device='cuda')
    with mock.patch.object(steps, 'make_multi_step', make_timed):
      history = pipe.train_and_validate()
    run = pipe._multi_step
    if (run.captures != 1 or run.replays != PIPE_STEPS_PER_EPOCH - run.warmup
        or not all(math.isfinite(v) for v in history.values())):
      _fail(f'zoo approx pipeline: {run.captures} captures, {run.replays} '
            f'replays, history {history}')
    out['approx_pipeline'] = {
        'history': history,
        'steady': _steady_state(timed[-1].spans, PIPE_STEPS_PER_EPOCH),
        'examples_per_sec': history['examples_per_sec']}
    pipe = pipeline_lib.SimplePipeline(
        _train_model(gen), pipeline_lib.SimpleDatasetBuilder(
            {}, example, data_hp, seed=SEED),
        hparams('approx_profiled', loss='approx_ndcg_loss'), device='cuda')
    before = steps.kernel_launch_counts()
    result = {}
    device_counts = _kernel_counts(
        lambda: result.update(history=pipe.train_and_validate()))
    after = steps.kernel_launch_counts()
    approx_wrappers, approx_card = _card_launches(
        'zoo approx pipeline', before, before, after, pipe._multi_step,
        device_counts, pipe._eval_step)
    if (pipe._multi_step.captures != 1
        or not math.isfinite(result['history']['loss'])):
      _fail(f'zoo approx pipeline (profiled): {pipe._multi_step.captures} '
            f'captures, history {result["history"]}')
    for name in ('sorted_values_and_ranks', 'layer_forward', 'bwd_stats',
                 'bwd_mats'):
      if approx_card[name] == 0:
        _fail(f'zoo approx pipeline never launched {name}')
    steady = out['approx_pipeline']['steady']
    _log(f'zoo approx pipeline: loss {history["loss"]:.6f}, val ndcg@5 '
         f'{history["ndcg@5"]:.4f}; {steady["loop_lists_per_s"]:.0f} lists/s '
         f'over the replay-only window, dispatches '
         f'{steady["dispatch_lists_per_s"]:.0f}; whole run '
         f'{history["examples_per_sec"]:.0f}; profiled run: kernels on the '
         f'card == eager calls + captured x replays '
         f'({ {k: v for k, v in approx_card.items() if v} })')

    # (d) The multi-task example's recipe at full width.
    example_mt = dict(example, click=parsers.FixedLenFeature((), 'int64', 0))
    model = scorers.RankingModel(scorers.MultiTaskScorer(
        MT_TASKS, body=scorers.DNNScorer(
            HIDDEN, in_features=F, output_units=len(MT_TASKS), dropout=0.0,
            input_grad=False, generator=gen)), transform_name='log1p')
    builder = pipeline_lib.MultiLabelDatasetBuilder(
        {}, example_mt, {t: t for t in MT_TASKS}, data_hp, seed=SEED)
    before = steps.kernel_launch_counts()
    pipe = pipeline_lib.MultiTaskPipeline(
        model, builder, hparams('multitask', loss=MT_LOSSES,
                                loss_weights=MT_WEIGHTS), device='cuda')
    t0 = time.perf_counter()
    history = pipe.train_and_validate()
    run_s = time.perf_counter() - t0
    mt_wrappers = {n: v - before[n]
                   for n, v in steps.kernel_launch_counts().items()}
    names = sorted(f'{t}/ndcg{s}' for t in MT_TASKS
                   for s in ('@1', '@5', '@10', ''))
    if sorted(k for k in history if '/' in k) != names:
      _fail(f'zoo multitask: metrics {sorted(history)}, not {names}')
    if (pipe._multi_step.captures != 1
        or not all(math.isfinite(v) for v in history.values())):
      _fail(f'zoo multitask: {pipe._multi_step.captures} captures, history '
            f'{history}')
    results = _hold_graphed_eval('zoo multitask', pipe, builder, history)
    out['multitask'] = {'history': history, 'run_s': run_s,
                        'eval_graphed_equals_eager': True,
                        'eval_replays': pipe._eval_step.replays,
                        'eval': results}
    _log(f'zoo multitask: one capture, loss {history["loss"]:.6f}, val_loss '
         f'{history["val_loss"]:.6f}, '
         + ', '.join(f'{k} {history[k]:.4f}' for k in names)
         + f'; graphed eval == eager bit for bit; run {run_s:.1f} s')
    return out, approx_wrappers, approx_card, mt_wrappers
  finally:
    shutil.rmtree(root, ignore_errors=True)


def _zoo_phase():
  """Phase 21: every key of the loss zoo on the flagship step (a), graphed
  == eager for the random keys (b), and the two pipelines (c, d). Returns
  (numbers, per-key launches a step, (c)'s wrapper launches, (c)'s kernels
  on the card, (d)'s wrapper launches)."""
  import torch
  gen = torch.Generator().manual_seed(SEED + 40)
  batches = {'graded': _zoo_batch(gen), 'binary': _zoo_batch(gen, True)}
  keys = {}
  for key in ('softmax_loss',) + ZOO_KEYS:
    keys[key] = _zoo_key(key, gen, batches)
  softmax_ms = keys['softmax_loss']['graph_ms_per_step']
  perm_mib = B * 8 * L * L * 4 / 2 ** 20
  _log('zoo: ms a step at K = 10 beside softmax '
       f'({softmax_ms:.4f}): ' + ', '.join(
           f'{k} {v["graph_ms_per_step"]:.4f} ({v["peak_mib"]:.0f} MiB)'
           for k, v in keys.items() if k != 'softmax_loss')
       + f'; one [{B * 8}, {L}, {L}] float32 permutation tensor is '
       f'{perm_mib:.0f} MiB')
  graph = _zoo_graph_vs_eager(gen)
  pipes, approx_wrappers, approx_card, mt_wrappers = _zoo_pipelines(gen)
  numbers = {'keys': keys, 'softmax_ms_per_step': softmax_ms,
             'perm_tensor_mib': perm_mib, 'graph_vs_eager': graph, **pipes}
  per_step = {k: v['launches_per_step'] for k, v in keys.items()}
  return numbers, per_step, approx_wrappers, approx_card, mt_wrappers


# --- phase 22: the other scorers, Bilinear and the dense-gradient lazy path ---

# 22a: examples/ranking_libsvm.py --scorer gam: F one-column towers of
# 256-128-64 (:44, :57-72), dropout 0.5 (:45), pairwise_logistic_loss
# (:40), learning rate 0.01 (:39), B = 32 lists (:37) of L = 100 (:36). Its
# pipeline runs one epoch of GAM_STEPS steps over LIBSVM files in MSLR's
# shape (a cut of scale: 640 lists), and 64 validation lists.
GAM_B, GAM_L, GAM_HIDDEN, GAM_DROPOUT, GAM_LR = 32, 100, (256, 128, 64), 0.5, 0.01
GAM_STEPS, GAM_VALID_LISTS = 2 * KSTEPS, 64
# 22b: examples/ranking_libsvm.py --group_size 2 (:73-76) at the flagship's
# B128 x L200 x F136, under softmax.
GROUP_SIZE, GROUP_HIDDEN = 2, (256, 128, 64)
# 22c: examples/antique_din.py --dasalc (:51-52): 4 attention layers of 2
# heads x 100, hidden 512-256-128, dropout 0.5, approx_ndcg_loss (:32),
# learning rate 0.05 (:33); token tables embed_q and embed_d of 10,000 x 20
# (:26-27, :62-66) under optimizer='lazy_adam'; ELWC lists of up to L = 50
# documents (:25) with 10 query and 60 document tokens, B = 128. Two
# dispatches of K = 10 over 640 lists (the train stream repeats); two
# validation batches, so that the pipeline's eval captures its graph on
# the second.
DIN_B, DIN_L, DIN_TQ, DIN_TD = 128, 50, 10, 60
DIN_VOCAB, DIN_DIM, DIN_LR = 10_000, 20, 0.05
DIN_LAYERS, DIN_HEADS, DIN_HEAD_SIZE, DIN_HIDDEN = 4, 2, 100, (512, 256, 128)
DIN_STEPS, DIN_TRAIN_LISTS, DIN_VALID_LISTS = 2 * KSTEPS, 640, 2 * DIN_B
# 22d: phase 13's sparse workload through the dense-gradient lazy update.
# A bound above the rows one batch can touch (B*L*T + B*T = 52,224 a
# table), and one below the rows it does touch.
LAZY_MAX_ROWS = 65_536
# 22e: Bilinear at examples/unbiased_two_tower.py's shapes: B = 64 lists
# (:35) of L = 20 (:31), 16 features (:32) against a one-hot position of
# L + 2 (the position tower's input, :94).
BILINEAR_B, BILINEAR_L, BILINEAR_X, BILINEAR_Y = 64, 20, 16, 22
# Bilinear on the card against float64 on the CPU, as a share of the
# largest output: float32 sums of Dx * Dy = 352 products.
BILINEAR_TOL = 1e-5


def _gam_model(gen, dropout):
  """RankingModel(log1p) over a GAMScorer of F one-column towers: the packed
  [B, L, F] features split into F features, as examples/ranking_libsvm.py's
  SplitGAM does."""
  from torch import nn
  from ranking_tpu_torch.models import scorers

  class SplitGAM(nn.Module):

    def __init__(self):
      super().__init__()
      self.gam = scorers.GAMScorer(
          GAM_HIDDEN, {f'col_{i:03d}': 1 for i in range(F)},
          dropout=dropout, generator=gen)

    def forward(self, context, examples, mask, training=False,
                generator=None, intermediates=None):
      (x,) = examples.values()
      feats = {f'col_{i:03d}': x[..., i:i + 1] for i in range(x.shape[-1])}
      return self.gam(context, feats, mask, training=training,
                      generator=generator, intermediates=intermediates)

  return scorers.RankingModel(SplitGAM(), transform_name='log1p')


def _groupwise_model(gen, dropout):
  from ranking_tpu_torch.models import groupwise, scorers
  return scorers.RankingModel(groupwise.GroupwiseDNNScorer(
      GROUP_SIZE * F, group_size=GROUP_SIZE, hidden_layer_dims=GROUP_HIDDEN,
      dropout=dropout, generator=gen), transform_name='log1p')


def _din_model(gen, dropout):
  """examples/antique_din.py's model: token tables embed_q and embed_d,
  named after no batch feature, under a DINScorer."""
  from torch import nn
  from ranking_tpu_torch.models import embeddings, scorers

  class AntiqueDIN(nn.Module):

    def __init__(self):
      super().__init__()
      self.embed_q = embeddings.EmbeddingEncoder(DIN_VOCAB, DIN_DIM,
                                                 generator=gen)
      self.embed_d = embeddings.EmbeddingEncoder(DIN_VOCAB, DIN_DIM,
                                                 generator=gen)
      self.din = scorers.DINScorer(
          2 * DIN_DIM, num_heads=DIN_HEADS, head_size=DIN_HEAD_SIZE,
          num_attention_layers=DIN_LAYERS, hidden_layer_dims=DIN_HIDDEN,
          dropout=dropout, generator=gen)

    def forward(self, context, examples, mask, training=False,
                generator=None):
      return self.din({'q': self.embed_q(context['query_tokens'])},
                      {'d': self.embed_d(examples['document_tokens'])}, mask,
                      training=training, generator=generator)

  return scorers.RankingModel(AntiqueDIN())


def _zero_names(model, shift_invariant):
  """Parameters of phase 22's models whose gradient is zero in theory: in
  every tower the biases in front of a batch norm; the attention's key
  biases (a constant of every logit of a query row), and the last
  attention layer's value and output biases
  (attention weights sum to 1, so each adds one vector to every row on the
  residual path into the tower's first batch norm); and with
  ``shift_invariant`` every output bias whose change shifts every logit of
  a list alike (each GAM tower's, with no context weights; the groupwise
  and DIN tower's)."""
  from ranking_tpu_torch.models import layers
  names = set()
  towers = [(n, m) for n, m in model.named_modules()
            if isinstance(m, layers.Tower)]
  for prefix, tower in towers:
    if tower.bn:
      names |= {f'{prefix}.dense.{i}.bias' for i in range(len(tower.bn))}
    if shift_invariant and not prefix.split('.')[-1].startswith('context'):
      names.add(f'{prefix}.dense.{len(tower.dense) - 1}.bias')
  attentions = [(n, m) for n, m in model.named_modules()
                if isinstance(m, layers.MultiHeadAttention)]
  names |= {f'{n}.key.bias' for n, _ in attentions}
  if attentions:
    last = attentions[-1][0]
    names |= {f'{last}.value.bias', f'{last}.out.bias'}
  return names


def _seeded_step(step, seed):
  """``step`` with a new CUDA generator of ``seed`` each call, so that two
  first steps draw the same dropout masks and shuffles."""
  import torch

  def run(state, batch):
    return step(state, batch,
                torch.Generator(device='cuda').manual_seed(seed))

  return run


@contextlib.contextmanager
def _output_grad(model):
  """Inside, a forward of ``model`` records the gradient of the loss with
  respect to its output; yields a dict that has it as 'dlogits' after the
  backward."""
  rec = {}

  def hook(module, inputs, output):
    output.register_hook(lambda g: rec.update(dlogits=g.detach().clone()))

  handle = model.register_forward_hook(hook)
  try:
    yield rec
  finally:
    handle.remove()


def _hold_first_step_whole(what, step, twin, batch, first_loss, first_grads,
                           first_stats, first_dlogits):
  """The first step against the same step through the plain versions when
  only rows 7-8 run (GAM: its towers take 3-D inputs, which the fused tower
  does not, so both steps run the same tower code): the loss within 1e-5,
  the logit gradient that rows 7-8 produce within PAIR_TOL of its largest
  entry, every gradient through that one difference held in the norm over
  all parameters (OP_TOL_NORM: a parameter whose gradient cancels, as a
  one-input layer's in front of a batch norm, would magnify it alone), the
  running statistics within 1e-5."""
  with _output_grad(twin) as rec:
    twin_metrics, grads, stats, launched, _ = _plain_step(step, twin, batch,
                                                          False)
  loss_err = abs(twin_metrics['loss'].item() - first_loss)
  dlogit_err = _rel_err(first_dlogits, rec['dlogits'])[1]
  num = sum(float(((first_grads[k] - g) ** 2).sum()) for k, g in grads.items())
  den = sum(float((g ** 2).sum()) for g in grads.values())
  norm = math.sqrt(num / max(den, 1e-30))
  stat_err = max((_rel_err(first_stats[k], v)[1] for k, v in stats.items()),
                 default=0.0)
  if (loss_err > 1e-5 * abs(first_loss) or dlogit_err > PAIR_TOL
      or norm > OP_TOL_NORM or stat_err > 1e-5):
    _fail(f'{what}: first step vs plain versions: loss {loss_err:.3g}, logit '
          f'gradient {dlogit_err:.3g} (PAIR_TOL), gradients {norm:.3g} in '
          f'the norm over all parameters, running statistics {stat_err:.3g}')
  _log(f'{what}: first step vs plain versions on the card: loss within '
       f'{loss_err:.3g}, logit gradient within {dlogit_err:.3g}, gradients '
       f'within {norm:.3g} in the norm over all parameters, running '
       f'statistics within {stat_err:.3g}')
  return {'loss': loss_err, 'dlogits': dlogit_err, 'norm': norm,
          'stats': stat_err}


@contextlib.contextmanager
def _recording_fused_tower(tower):
  """Inside, a train step whose ``tower`` takes the fused path records what
  the tower's backward started from: its input, each hidden layer's ReLU
  gates (as ``_recording_tower`` reads them) and the gradient of the loss
  with respect to the tower's output; and what it gave back, the gradient
  with respect to its input. Yields a dict that has 'x', 'gates', 'dout'
  and 'dx' after the block."""
  from ranking_tpu_torch.ops.cuda import fused_bn
  ys, folds, rec = [], [], {}
  layer_forward, bn_fold = fused_bn.layer_forward, fused_bn._bn_fold

  def record_layer(*args, **kwargs):
    out = layer_forward(*args, **kwargs)
    ys.append(out[0])
    return out

  def record_fold(*args, **kwargs):
    out = bn_fold(*args, **kwargs)
    folds.append(out)
    return out

  def record_io(module, inputs, output):
    rec['x'] = inputs[0].detach().clone()
    if inputs[0].requires_grad:
      inputs[0].register_hook(lambda g: rec.update(dx=g.detach().clone()))
    output.register_hook(lambda g: rec.update(dout=g.detach().clone()))

  record_layer.launches = 0   # the wrapper counts on its module's name
  handle = tower.register_forward_hook(record_io)
  try:
    with mock.patch.object(fused_bn, 'layer_forward', record_layer), \
        mock.patch.object(fused_bn, '_bn_fold', record_fold):
      yield rec
  finally:
    handle.remove()
    layer_forward.launches += record_layer.launches
  if len(ys) != len(tower.bn) or 'dout' not in rec:
    _fail(f'recording the tower: {len(ys)} layers (not {len(tower.bn)}), '
          f'output gradient {"dout" in rec}')
  rec['gates'] = [y.to(f[3].dtype) * f[3] + f[4] > 0
                  for y, f in zip(ys, folds)]


def _tower_step_f64(tower, rec, prefix):
  """The gradients of ``tower``'s parameters (named with ``prefix``) in
  float64 on the card, from a step's record (``_recording_fused_tower``):
  its input, Dense -> batch norm over every row -> that step's ReLU gates,
  the output layer, and a backward from that step's output gradient."""
  import copy
  import torch
  import torch.nn.functional as nnf
  t = copy.deepcopy(tower).to('cuda', torch.float64)
  h = rec['x'].to(torch.float64)
  for dense, bn, gate in zip(t.dense[:-1], t.bn, rec['gates']):
    y = h @ dense.weight.t() + dense.bias
    mu = y.mean(0)
    var = torch.clamp((y * y).mean(0) - mu * mu, min=0.0)
    h = ((y - mu) * torch.rsqrt(var + bn.eps) * bn.weight + bn.bias) * gate
  out = nnf.linear(h, t.dense[-1].weight, t.dense[-1].bias)
  out.backward(rec['dout'].to(torch.float64))
  return {prefix + k: p.grad for k, p in t.named_parameters()}


def _upstream_step_f64(model, tower, batch, dx):
  """The gradients of ``model``'s parameters upstream of its tower (those
  not named with the prefix ``tower``) in float64 on the card, from a copy
  of ``model``: a train-mode forward up to the tower's input (the tower
  does not run), and a backward from ``dx``, a step's gradient with
  respect to that input."""
  import copy
  import torch
  from ranking_tpu_torch.train import steps
  m = copy.deepcopy(model).to('cuda', torch.float64)
  for module in m.modules():   # the compute dtype of towers and attention
    if isinstance(getattr(module, 'dtype', None), torch.dtype):
      module.dtype = torch.float64
  seen = {}

  class Reached(Exception):
    pass

  def stop(module, inputs):
    seen['x'] = inputs[0]
    raise Reached()

  handle = m.get_submodule(tower.rstrip('.')).register_forward_pre_hook(stop)
  b = steps.restore_flat_examples(batch.to('cuda'))
  try:
    m(b.context, b.examples, b.mask, training=True)
  except Reached:
    pass
  finally:
    handle.remove()
  names = [k for k, _ in m.named_parameters() if not k.startswith(tower)]
  params = [m.get_parameter(k) for k in names]
  # The attention hands the tower float32 (flax's cast); the backward of
  # that cast carries the gradient on in float64.
  grads = torch.autograd.grad(seen['x'], params,
                              grad_outputs=dx.to(seen['x'].dtype),
                              allow_unused=True)
  return {k: (torch.zeros_like(p) if g is None else g)
          for k, p, g in zip(names, params, grads)}


def _norm_diff(got, want, skip):
  """The distance of ``got`` from ``want`` in the norm over all their
  entries, but the names of ``skip``, as a share of ``want``'s norm."""
  num = den = 0.0
  for k, w in want.items():
    if k in skip:
      continue
    num += float(((got[k].double() - w.double()) ** 2).sum())
    den += float((w.double() ** 2).sum())
  return math.sqrt(num / max(den, 1e-30))


def _hold_first_step_upstream(what, step, twin, batch, first_loss,
                              first_grads, first_stats, first_record, tower,
                              anchor, anchor_model, zero_names, zero_tol,
                              plain_sort):
  """The first step against the same step through the plain versions when
  the fused tower's input needs a gradient (DIN; ``tower`` the prefix of
  its parameters' names). The tower's parameters as phase 7 holds them
  (``_grad_errors``: OP_TOL_NORM each in the norm, OP_TOL_MAX at the
  largest entry, the ones zero in theory within ``zero_tol``); where they
  are beyond OP_TOL_NORM, each float32 step's tower gradients are held to
  ANCHOR_TOL of the float64 step of its own input, ReLU gates and output
  gradient (the two forwards open a few gates on one side only, each
  moving a gradient by one row's whole term; ``_tower_step_f64`` of
  ``anchor``, a copy of the untrained tower).
  Everything upstream of the tower (attention, tables) receives the
  tower's input gradient (row 5) carried back through the attention
  layers, where such a gate moves one row of it and the cancelling sums
  carry that into single entries, so those are held together in the norm
  over all of them (OP_TOL_NORM), the zero-in-theory ones within
  ``zero_tol``; beyond OP_TOL_NORM, each float32 step's upstream gradients
  are held to ANCHOR_TOL (in that norm) of a float64 backward of the
  untrained ``anchor_model`` from that step's own input gradient
  (``_upstream_step_f64``). Loss and running statistics as phase 7."""
  module = twin.get_submodule(tower.rstrip('.'))
  with _recording_fused_tower(module) as plain_record:
    twin_metrics, grads, stats, _, _ = _plain_step(step, twin, batch,
                                                   plain_sort)
  loss_err = abs(twin_metrics['loss'].item() - first_loss)
  if loss_err > 1e-5 * abs(first_loss):
    _fail(f'{what}: first loss {first_loss} vs plain versions '
          f'{twin_metrics["loss"].item()}')
  inside = {k: v for k, v in grads.items() if k.startswith(tower)}
  norm, norm_name, worst, worst_name = _grad_errors(
      first_grads, inside, zero_names, zero_tol)
  out = {'loss': loss_err, 'norm': norm, 'norm_param': norm_name,
         'max': worst, 'max_param': worst_name}
  if worst == math.inf or worst > OP_TOL_MAX:
    _fail(f'{what}: the tower\'s gradient {worst_name} differs from the '
          f'plain versions by {worst:.3g} of its largest entry')
  if norm > OP_TOL_NORM:
    flips = sum(int((a != b).sum().item()) for a, b in zip(
        first_record['gates'], plain_record['gates']))
    kern = _grad_errors(first_grads, _tower_step_f64(anchor, first_record,
                                                     tower),
                        zero_names, zero_tol)
    plain = _grad_errors(grads, _tower_step_f64(anchor, plain_record, tower),
                         zero_names, zero_tol)
    out.update(gates_differ=flips, kernels_f64_norm=kern[0],
               kernels_f64_max=kern[2], plain_f64_norm=plain[0],
               plain_f64_max=plain[2])
    for side, e in (('kernels\'', kern), ('plain versions\'', plain)):
      if e[0] > ANCHOR_TOL or e[2] > ANCHOR_TOL:
        _fail(f'{what}: the tower\'s gradients differ from the plain '
              f'versions by {norm:.3g} in norm ({norm_name}); the {side} '
              f'step is off from the float64 step of its own gates by '
              f'{e[0]:.3g} in norm ({e[1]}), {e[2]:.3g} at most; the two '
              f'forwards differ in {flips} gates')
  outside = {k: g for k, g in grads.items() if k not in inside}
  for k in zero_names & set(outside):
    if max(outside[k].abs().max().item(),
           first_grads[k].abs().max().item()) > zero_tol:
      _fail(f'{what}: gradient {k} (zero in theory) off by more than '
            f'{zero_tol:.3g}')
  upstream = _norm_diff(first_grads, outside, zero_names)
  out['upstream_norm'] = upstream
  if upstream > OP_TOL_NORM:
    kern = _norm_diff(first_grads, _upstream_step_f64(
        anchor_model, tower, batch, first_record['dx']), zero_names)
    plain = _norm_diff(grads, _upstream_step_f64(
        anchor_model, tower, batch, plain_record['dx']), zero_names)
    out.update(upstream_kernels_f64_norm=kern, upstream_plain_f64_norm=plain)
    if kern > ANCHOR_TOL or plain > ANCHOR_TOL:
      _fail(f'{what}: the gradients upstream of the tower differ from the '
            f'plain versions by {upstream:.3g} in their norm; from the '
            f'float64 backward of their own input gradient by {kern:.3g} '
            f'(kernels) and {plain:.3g} (plain versions)')
  stat_err = max((_rel_err(first_stats[k], v)[1] for k, v in stats.items()),
                 default=0.0)
  if stat_err > 1e-5:
    _fail(f'{what}: running statistics differ from the plain versions by '
          f'{stat_err:.3g}')
  out['stats'] = stat_err
  _log(f'{what}: first step vs plain versions on the card: {out}')
  return out


def _first_step_22(what, model_fn, loss_fn, batch, shift_invariant,
                   sparse_tx=None, seed=None, plain_sort=False, whole=False,
                   tower=None):
  """A first train step of a fresh model on the card against the same step
  through the plain versions (``_hold_first_step`` at phase 7's
  tolerance; with ``whole`` ``_hold_first_step_whole``; with ``tower``,
  the prefix of a tower whose input needs a gradient,
  ``_hold_first_step_upstream``), and the wrappers' launches of one eager
  step. Returns (readings, launches of the step)."""
  import copy
  import torch
  from ranking_tpu_torch.train import state as state_lib
  from ranking_tpu_torch.train import steps
  model = model_fn()
  twin = copy.deepcopy(model)
  # The untrained tower, for the float64 steps: a step moves the weights.
  anchor = (None if tower is None
            else copy.deepcopy(model.get_submodule(tower.rstrip('.'))))
  anchor_model = None if tower is None else copy.deepcopy(model)
  step = steps.make_train_step(loss_fn, device='cuda')
  if seed is not None:
    step = _seeded_step(step, seed)
  state = state_lib.create_train_state(model, state_lib.adam(1e-3),
                                       device='cuda', sparse_tx=sparse_tx)
  before = steps.kernel_launch_counts()
  with contextlib.ExitStack() as stack:
    rec = stack.enter_context(_output_grad(state.model))
    if tower is not None:
      tower_rec = stack.enter_context(_recording_fused_tower(
          state.model.get_submodule(tower.rstrip('.'))))
    state, metrics = step(state, batch)
  after = steps.kernel_launch_counts()
  launches = {n: after[n] - before[n] for n in after if after[n] != before[n]}
  first_loss = metrics['loss'].item()
  if not math.isfinite(first_loss):
    _fail(f'{what}: first loss {first_loss}')
  first_grads, first_stats = _snapshot_first_step(state)
  if whole:
    hold = _hold_first_step_whole(what, step, twin, batch, first_loss,
                                  first_grads, first_stats, rec['dlogits'])
  elif tower is not None:
    hold = _hold_first_step_upstream(
        what, step, twin, batch, first_loss, first_grads, first_stats,
        tower_rec, tower, anchor, anchor_model,
        _zero_names(twin, shift_invariant),
        _zero_tol(twin, loss_fn, batch), plain_sort)
  else:
    hold = _hold_first_step(
        what, step, twin, batch, first_loss, first_grads, first_stats,
        plain_sort=plain_sort, zero_names=_zero_names(twin, shift_invariant),
        zero_tol=_zero_tol(twin, loss_fn, batch, None if seed is None else
                           torch.Generator(device='cuda').manual_seed(seed)))
  del state
  return dict(hold, first_loss=first_loss), launches


def _graph_vs_eager_22(what, make_state, step, batches, random, launches):
  """Phase 16's check for one of phase 22's steps: a first dispatch of K
  steps through ``make_multi_step`` (warm-up and capture; the capture must
  record ``launches``, the eager step's), then K replays on the state
  against K eager steps on a copy of it, bitwise (or within SPARSE_TOL
  where two eager runs already differ: atomics), with a CUDA generator
  for the dropout masks and shuffles where ``random``. Returns ms a step,
  graph and eager, by CUDA events around whole dispatches."""
  import copy
  import torch
  from ranking_tpu_torch.train import steps
  warm = steps.stack_batches(batches[:KSTEPS]).to('cuda')
  run = steps.stack_batches(batches[KSTEPS:]).to('cuda')
  state = make_state()
  rng = torch.Generator(device='cuda').manual_seed(SEED) if random else None

  def rng_copy():
    if rng is None:
      return None
    out = torch.Generator(device='cuda')
    out.set_state(rng.get_state())
    return out

  graphed = steps.make_multi_step(step, device='cuda')
  eager = steps.make_multi_step(step, device='cuda', eager=True)
  state, _ = graphed(state, warm, rng)
  if graphed.captures != 1 or graphed.replays != KSTEPS - graphed.warmup:
    _fail(f'{what}: {graphed.captures} captures and {graphed.replays} '
          'replays in the first dispatch')
  if graphed.captured_launches != launches:
    _fail(f'{what}: launches recorded at capture '
          f'{graphed.captured_launches} != one eager step\'s {launches}')
  twins = [copy.deepcopy(state), copy.deepcopy(state)]
  twin_rngs = [rng_copy(), rng_copy()]
  torch.cuda.synchronize()
  state, graph_metrics = graphed(state, run, rng)
  twins[0], eager_metrics = eager(twins[0], run, twin_rngs[0])
  twins[1], _ = eager(twins[1], run, twin_rngs[1])
  torch.cuda.synchronize()
  if graphed.captures != 1:
    _fail(f'{what}: the second dispatch captured again')
  repeats = not _state_diff(twins[0], twins[1])[0]
  differ, worst = _state_diff(state, twins[0])
  losses = graph_metrics['loss'].tolist()
  losses_equal = torch.equal(graph_metrics['loss'], eager_metrics['loss'])
  if (repeats and (differ or not losses_equal)) or worst > (
      0.0 if repeats else SPARSE_TOL) or not all(map(math.isfinite, losses)):
    _fail(f'{what}: {KSTEPS} replays vs {KSTEPS} eager steps: {len(differ)} '
          f'tensors differ ({differ[:4]}), worst {worst:.3g}, losses equal '
          f'{losses_equal} ({losses}); two eager runs repeat each other: '
          f'{repeats}')
  twins.pop()
  # The eager step is timed over one dispatch after the two above: GAM's
  # takes some 0.6 s a step.
  out = {'graph_ms_per_step': _event_ms(
             lambda: graphed(state, run, rng), 3, warmup=1) / KSTEPS,
         'eager_ms_per_step': _event_ms(
             lambda: eager(twins[0], run, twin_rngs[0]), 1,
             warmup=0) / KSTEPS,
         'bitwise': repeats, 'max_rel_diff': worst,
         'launches_per_step': dict(graphed.captured_launches),
         'losses': losses}
  _log(f'{what}: {KSTEPS} replays == {KSTEPS} eager steps '
       + ('bitwise' if repeats else f'within {worst:.3g} (two eager runs '
          'differ: atomics)')
       + f'; ms a step {out["graph_ms_per_step"]:.4f} graph, '
       f'{out["eager_ms_per_step"]:.4f} eager; launches a step '
       f'{out["launches_per_step"]}')
  del state, twins, graphed, eager, warm, run
  gc.collect()
  torch.cuda.empty_cache()
  return out


def _timed_pipeline(pipe):
  """Runs ``pipe.train_and_validate`` with CUDA events around its
  dispatches that only replay. Returns (history, run s, steady state)."""
  from ranking_tpu_torch.train import steps
  timed = []
  make_multi_step = steps.make_multi_step

  def make_timed(*args, **kwargs):
    timed.append(_TimedDispatches(make_multi_step(*args, **kwargs)))
    return timed[-1]

  t0 = time.perf_counter()
  with mock.patch.object(steps, 'make_multi_step', make_timed):
    history = pipe.train_and_validate()
  run_s = time.perf_counter() - t0
  if pipe._multi_step is not timed[0] or not timed[0].spans:
    _fail('the timed K-step dispatch did not run, or never only replayed')
  return history, run_s, _steady_state(timed[0].spans,
                                       pipe.hparams.steps_per_epoch)


def _gam_phase(gen, root):
  """Phase 22a: ``ranking_libsvm.py --scorer gam``. The sub-scores add up
  to the logits; the first step at dropout 0 against the plain versions
  (rows 7-8 off; the towers take 3-D inputs, so the fused tower never
  runs); K replays == K eager steps at dropout 0.5; the pipeline over
  LIBSVM files with one capture, timed."""
  import os
  import torch
  from ranking_tpu_torch.data import batch as batch_lib
  from ranking_tpu_torch.data import dataset
  from ranking_tpu_torch.data import libsvm
  from ranking_tpu_torch.ops import loss_registry
  from ranking_tpu_torch.pipeline import hparams as hparams_lib
  from ranking_tpu_torch.pipeline import pipeline as pipeline_lib
  from ranking_tpu_torch.train import state as state_lib
  from ranking_tpu_torch.train import steps
  out = {}
  loss_fn = loss_registry.make_loss_fn('pairwise_logistic_loss')
  batches = [dataset.flatten_examples(_make_batch(gen, GAM_B, l=GAM_L))
             for _ in range(2 * KSTEPS)]
  model = _gam_model(gen, GAM_DROPOUT).to('cuda')
  b = steps.restore_flat_examples(batches[0].to('cuda'))
  inter = {}
  with torch.no_grad():
    logits = model(b.context, b.examples, b.mask, intermediates=inter)
  sub = inter['gam_sub_scores']
  if sub.shape != (GAM_B, GAM_L, F) or not torch.equal(
      logits[b.mask], sub.sum(-1)[b.mask]):
    _fail(f'gam: sub-scores {tuple(sub.shape)} do not add up to the logits')
  out['first_step'], launches = _first_step_22(
      'gam first step (dropout 0)', lambda: _gam_model(gen, 0.0), loss_fn,
      batches[0], shift_invariant=True, whole=True)
  step = steps.make_train_step(loss_fn, device='cuda')
  out['graph'] = _graph_vs_eager_22(
      'gam', lambda: state_lib.create_train_state(
          _gam_model(gen, GAM_DROPOUT), state_lib.adam(GAM_LR),
          device='cuda'), step, batches, True, launches)
  paths = {}
  for split, lists, seed in (('train', GAM_B * GAM_STEPS, SEED + 50),
                             ('vali', GAM_VALID_LISTS, SEED + 51)):
    paths[split] = os.path.join(root, f'gam-{split}.txt')
    libsvm.write_random_lists(paths[split], lists, F, PIPE_MIN_DOCS, GAM_L,
                              seed=seed)
  pipe = pipeline_lib.SimplePipeline(
      _gam_model(gen, GAM_DROPOUT), pipeline_lib.LibSVMDatasetBuilder(
          paths['train'], paths['vali'], GAM_L, F, GAM_B, seed=SEED),
      hparams_lib.PipelineHparams(
          model_dir=os.path.join(root, 'gam'), num_epochs=1,
          steps_per_epoch=GAM_STEPS, validation_steps=10 ** 6,
          learning_rate=GAM_LR, loss='pairwise_logistic_loss',
          steps_per_execution=KSTEPS), device='cuda')
  history, run_s, steady = _timed_pipeline(pipe)
  if pipe._multi_step.captures != 1 or not all(
      math.isfinite(v) for v in history.values()):
    _fail(f'gam pipeline: {pipe._multi_step.captures} captures, history '
          f'{history}')
  out['pipeline'] = {'history': history, 'run_s': run_s, **steady}
  _log(f'gam: {F} one-column towers of {GAM_HIDDEN} at B={GAM_B}, '
       f'L={GAM_L}: sub-scores add up to the logits bitwise; pipeline one '
       f'capture, {steady["loop_lists_per_s"]:.0f} lists/s over the '
       f'replay-only window ({steady["dispatch_lists_per_s"]:.0f} over the '
       f'dispatches alone), run {run_s:.1f} s, loss {history["loss"]:.4f}, '
       f'ndcg {history["ndcg"]:.4f}')
  del pipe, model
  return out


def _groupwise_phase(gen):
  """Phase 22b: ``GroupwiseDNNScorer(g=2, 256-128-64)`` at the flagship's
  shape under softmax. At dropout 0 it takes the fused tower at an input
  of 272: its first step against the plain versions, with the same
  shuffles on both sides; K replays == K eager steps with a CUDA
  generator for the shuffles; one step at the example's dropout 0.5."""
  from ranking_tpu_torch.data import dataset
  from ranking_tpu_torch.ops import loss_registry
  from ranking_tpu_torch.train import state as state_lib
  from ranking_tpu_torch.train import steps
  out = {}
  loss_fn = loss_registry.make_loss_fn('softmax_loss')
  batches = [dataset.flatten_examples(_make_batch(gen, B))
             for _ in range(2 * KSTEPS)]
  out['first_step'], launches = _first_step_22(
      'groupwise first step (dropout 0)', lambda: _groupwise_model(gen, 0.0),
      loss_fn, batches[0], shift_invariant=True, seed=SEED + 52)
  if [launches.get(n, 0) for n in ('layer_forward', 'bwd_stats',
                                   'bwd_mats')] != [3, 1, 2]:
    _fail(f'groupwise: launches of one step {launches}, not 3 / 1 / 2 of '
          'rows 2-4')
  step = steps.make_train_step(loss_fn, device='cuda')
  out['graph'] = _graph_vs_eager_22(
      'groupwise', lambda: state_lib.create_train_state(
          _groupwise_model(gen, 0.0), state_lib.adam(1e-3), device='cuda'),
      step, batches, True, launches)
  state = state_lib.create_train_state(_groupwise_model(gen, 0.5),
                                       state_lib.adam(1e-3), device='cuda')
  _, metrics = _seeded_step(step, SEED + 53)(state, batches[0])
  loss = metrics['loss'].item()
  if not math.isfinite(loss):
    _fail(f'groupwise: a step at dropout 0.5 gave loss {loss}')
  out['dropout_step_loss'] = loss
  _log(f'groupwise: g={GROUP_SIZE} over B={B} x L={L} x F={F} (tower input '
       f'{GROUP_SIZE * F}), a step at dropout 0.5: loss {loss:.6f}')
  return out


def _din_records(seed, lists):
  """ELWC lists of 20 to DIN_L documents of DIN_TD string tokens, a query
  of DIN_TQ, labels 0-4 (tokens drawn from 10M words, hashed into the
  tables' rows by the loader)."""
  import numpy as np
  from ranking_tpu_torch.data import proto
  rng = np.random.RandomState(seed)
  out = []
  for _ in range(lists):
    n = rng.randint(SPARSE_MIN_LEN, DIN_L + 1)
    words = rng.randint(0, 10_000_000, size=(n + 1) * DIN_TD)
    out.append(proto.make_elwc(
        {'query_tokens': [f'w{w}' for w in words[:DIN_TQ]]},
        [{'document_tokens': [f'w{w}' for w in
                              words[(i + 1) * DIN_TD:(i + 2) * DIN_TD]],
          'relevance': [int(rng.randint(0, 5))]} for i in range(n)]))
  return out


def _din_phase(gen, root):
  """Phase 22c: ``antique_din.py --dasalc`` through ``SimplePipeline`` over
  ELWC token files, with tables that no batch feature names, so that the
  pipeline trains them by the dense-gradient lazy update: one capture, the
  graphed eval == eager, no row dropped. Its first step at dropout 0 (the
  fused tower at an input of 100, which needs a gradient) against the plain
  versions."""
  import os
  from ranking_tpu_torch.data import dataset
  from ranking_tpu_torch.data import parsers
  from ranking_tpu_torch.data import tfrecord
  from ranking_tpu_torch.ops import loss_registry
  from ranking_tpu_torch.pipeline import hparams as hparams_lib
  from ranking_tpu_torch.pipeline import pipeline as pipeline_lib
  from ranking_tpu_torch.train import sparse as sparse_lib
  from ranking_tpu_torch.train import steps
  out = {}
  specs = ({'query_tokens': parsers.VarLenFeature(
               'string', max_len=DIN_TQ, hash_buckets=DIN_VOCAB)},
           {'document_tokens': parsers.VarLenFeature(
               'string', max_len=DIN_TD, hash_buckets=DIN_VOCAB),
            'relevance': parsers.FixedLenFeature((), 'int64', 0)})
  t0 = time.perf_counter()
  for split, lists, seed in (('train', DIN_TRAIN_LISTS, SEED + 54),
                             ('vali', DIN_VALID_LISTS, SEED + 55)):
    tfrecord.write_records(os.path.join(root, f'din-{split}.tfrecord'),
                           _din_records(seed, lists))
  out['write_s'] = time.perf_counter() - t0
  builder = pipeline_lib.SimpleDatasetBuilder(
      *specs, hparams_lib.DatasetHparams(
          train_input_pattern=os.path.join(root, 'din-train.tfrecord'),
          valid_input_pattern=os.path.join(root, 'din-vali.tfrecord'),
          train_batch_size=DIN_B, valid_batch_size=DIN_B, list_size=DIN_L,
          dataset_engine='native_loader'), seed=SEED)
  first = dataset.flatten_examples(next(iter(builder.train_batches())))
  model = _din_model(gen, 0.5)
  if sparse_lib.derive_embed_features(
      sparse_lib.named_paths(model), first.context,
      steps.restore_flat_examples(first).examples):
    _fail('din: a batch feature names a table; the pipeline would take the '
          'sparse step')
  loss_fn = loss_registry.make_loss_fn('approx_ndcg_loss')
  out['first_step'], out['first_step_launches'] = _first_step_22(
      'din first step (dropout 0)', lambda: _din_model(gen, 0.0), loss_fn,
      first, shift_invariant=True, sparse_tx=sparse_lib.LazyAdam(DIN_LR),
      plain_sort=True, tower='scorer.din.tower.')
  pipe = pipeline_lib.SimplePipeline(
      model, builder, hparams_lib.PipelineHparams(
          model_dir=os.path.join(root, 'din'), num_epochs=1,
          steps_per_epoch=DIN_STEPS, validation_steps=10 ** 6,
          learning_rate=DIN_LR, loss='approx_ndcg_loss',
          optimizer='lazy_adam', steps_per_execution=KSTEPS), device='cuda')
  # lazy_adam's default bound, 8,192 rows a table and step, is below what
  # a batch of these lists touches in a 10,000-row table (36,160 rows
  # dropped over 20 steps on an H100); the run takes a bound that covers
  # the table, so that no row loses a step.
  with mock.patch.object(pipeline_lib, 'sparse_optimizer_from_hparams',
                         lambda hp: sparse_lib.LazyAdam(
                             hp.learning_rate, max_rows=DIN_VOCAB)):
    history, run_s, steady = _timed_pipeline(pipe)
  state = pipe.final_state
  if (pipe._multi_step.captures != 1 or state.step != DIN_STEPS
      or not all(math.isfinite(v) for v in history.values())):
    _fail(f'din pipeline: {pipe._multi_step.captures} captures, step '
          f'{state.step}, history {history}')
  dropped = int(state.sparse_opt_state['dropped'])
  count = int(state.sparse_opt_state['count'])
  if (dropped != 0 or count != DIN_STEPS
      or state.sparse_tx.max_rows != DIN_VOCAB):
    _fail(f'din pipeline: the lazy update dropped {dropped} rows, counted '
          f'{count} steps')
  out['eval'] = _hold_graphed_eval('din pipeline', pipe, builder, history)
  graph_ms = [ms / KSTEPS for ms in steady['dispatch_ms']]
  out['pipeline'] = {'history': history, 'run_s': run_s, 'dropped': dropped,
                     'launches_per_step': dict(
                         pipe._multi_step.captured_launches),
                     'graph_ms_per_step': graph_ms, **steady}
  _log(f'din: {DIN_LAYERS} layers x {DIN_HEADS} heads x {DIN_HEAD_SIZE}, '
       f'{DIN_HIDDEN}, tables {DIN_VOCAB} x {DIN_DIM} by the dense-gradient '
       f'lazy update (dropped 0), B={DIN_B} ELWC token lists of up to '
       f'{DIN_L}: one capture, {statistics.median(graph_ms):.4f} ms a step '
       f'(graph replays), {steady["loop_lists_per_s"]:.0f} lists/s over the '
       f'replay-only window, run {run_s:.1f} s, loss {history["loss"]:.4f}; '
       f'launches a step {out["pipeline"]["launches_per_step"]}')
  del pipe, model
  return out


def _lazy_dense_phase(gen, sparse_ms):
  """Phase 22d: the dense-gradient lazy update (``make_train_step`` on a
  state with a ``sparse_tx``) at phase 13's scale: its first step against
  ``make_sparse_train_step``'s on the same batch within SPARSE_TOL, rows
  no id touched keeping their bits; a step with ``max_rows`` below the
  rows touched, whose ``dropped`` must count the overflow exactly; K
  replays == K eager steps. ``sparse_ms`` is phase 16's sparse step, a
  yardstick."""
  import copy
  import torch
  from ranking_tpu_torch.ops import loss_registry
  from ranking_tpu_torch.train import sparse as sparse_lib
  from ranking_tpu_torch.train import state as state_lib
  from ranking_tpu_torch.train import steps
  out = {}
  loss_fn = loss_registry.make_loss_fn('softmax_loss')
  batches = [_sparse_batch(gen) for _ in range(2 * KSTEPS)]
  # One model drawn on the host; every other state starts from a copy of
  # it on the card (drawing 3M x 128 tables takes seconds).
  pristine = _sparse_model(gen).to('cuda')
  model, twin = copy.deepcopy(pristine), copy.deepcopy(pristine)
  batch = batches[0]
  dense_step = steps.make_train_step(loss_fn, device='cuda')
  state = state_lib.create_train_state(
      model, state_lib.adam(1e-3), device='cuda',
      sparse_tx=sparse_lib.LazyAdam(1e-3, max_rows=LAZY_MAX_ROWS))
  tables = sparse_lib.partition(sparse_lib.named_paths(state.model),
                                state.sparse_tx)[1]
  before = {p: t.detach().clone() for p, t in tables.items()}
  launched = steps.kernel_launch_counts()
  state, metrics = dense_step(state, batch)
  after = steps.kernel_launch_counts()
  if any(after[n] != launched[n] for n in after):
    _fail(f'lazy dense: the step launched a kernel wrapper: '
          f'{ {n: after[n] - launched[n] for n in after} }')
  touched = {p: int((t.grad.abs().sum(1) > 0).sum()) for p, t in
             tables.items()}
  efs = sparse_lib.derive_embed_features(
      sparse_lib.named_paths(twin), batch.context,
      steps.restore_flat_examples(batch).examples)
  sparse_state = state_lib.create_train_state(
      twin, state_lib.adam(1e-3), device='cuda',
      sparse_tx=sparse_lib.LazyAdam(1e-3))
  sparse_state, sparse_metrics = steps.make_sparse_train_step(
      loss_fn, efs, device='cuda')(sparse_state, batch)
  torch.cuda.synchronize()
  differ, worst = _state_diff(state, sparse_state)
  loss_err = abs(metrics['loss'].item() - sparse_metrics['loss'].item())
  if worst > SPARSE_TOL or loss_err > SPARSE_TOL * abs(
      sparse_metrics['loss'].item()):
    _fail(f'lazy dense: first step vs the sparse step: {len(differ)} tensors '
          f'differ, worst {worst:.3g} ({differ[:4]}), loss {loss_err:.3g}')
  kept = 0
  for p, t in tables.items():
    rows = t.grad.abs().sum(1) > 0
    same = torch.equal(t.detach()[~rows], before[p][~rows]) and all(
        torch.equal(v[~rows], torch.zeros_like(v[~rows]))
        for v in state.sparse_opt_state[p].values())
    if not same:
      _fail(f'lazy dense: rows of {p} that no id touched changed')
    kept += int((~rows).sum())
  if int(state.sparse_opt_state['dropped']) != 0:
    _fail('lazy dense: dropped rows under a bound above the batch')
  del sparse_state, twin, before
  gc.collect()
  torch.cuda.empty_cache()
  # Overflow: a bound at three quarters of the fewest rows touched.
  bound = min(touched.values()) * 3 // 4
  over = state_lib.create_train_state(
      copy.deepcopy(pristine), state_lib.adam(1e-3), device='cuda',
      sparse_tx=sparse_lib.LazyAdam(1e-3, max_rows=bound))
  over, _ = dense_step(over, batch)
  over_tables = sparse_lib.partition(sparse_lib.named_paths(over.model),
                                     over.sparse_tx)[1]
  want = sum(max(int((t.grad.abs().sum(1) > 0).sum()) - bound, 0)
             for t in over_tables.values())
  dropped = int(over.sparse_opt_state['dropped'])
  if dropped != want or want == 0:
    _fail(f'lazy dense: max_rows {bound}: dropped {dropped}, the overflow '
          f'is {want}')
  del over, over_tables
  gc.collect()
  torch.cuda.empty_cache()
  out.update(first_step_vs_sparse=worst, touched_rows=touched,
             untouched_rows_kept=kept, overflow_bound=bound,
             dropped=dropped)
  del state, model, tables
  gc.collect()
  torch.cuda.empty_cache()
  out['graph'] = _graph_vs_eager_22(
      'lazy dense', lambda: state_lib.create_train_state(
          pristine, state_lib.adam(1e-3), device='cuda',
          sparse_tx=sparse_lib.LazyAdam(1e-3, max_rows=LAZY_MAX_ROWS)),
      dense_step, batches, False, {})
  del pristine
  out['sparse_step_graph_ms'] = sparse_ms
  _log(f'lazy dense: two {SPARSE_VOCAB} x {SPARSE_DIM} tables, first step == '
       f'the sparse step within {worst:.3g}, {kept} untouched rows kept '
       f'their bits, rows touched {touched}; max_rows {bound}: dropped '
       f'{dropped} == the overflow; {out["graph"]["graph_ms_per_step"]:.4f} '
       f'ms a step graphed ({out["graph"]["eager_ms_per_step"]:.4f} eager)'
       + ('' if sparse_ms is None else f' beside the sparse step\'s '
          f'{sparse_ms:.4f} (phase 16, this run)'))
  return out


def _bilinear_phase(gen):
  """Phase 22e: ``Bilinear`` on the card against a float64 recompute on the
  CPU of its einsum, output and gradients, as a share of the largest
  value."""
  import torch
  from ranking_tpu_torch.models import layers
  layer = layers.Bilinear(BILINEAR_X, BILINEAR_Y, generator=gen)
  with torch.no_grad():
    layer.bias.fill_(0.3)
  x = torch.randn(BILINEAR_B, BILINEAR_L, BILINEAR_X, generator=gen)
  y = torch.nn.functional.one_hot(
      torch.randint(0, BILINEAR_Y, (BILINEAR_B, BILINEAR_L), generator=gen),
      BILINEAR_Y).float()
  w = torch.randn(BILINEAR_B, BILINEAR_L, 1, generator=gen)
  kernel = layer.bilinear_kernel.detach().double().requires_grad_()
  bias = layer.bias.detach().double()
  card = layer.to('cuda')
  xc = x.to('cuda', copy=True).requires_grad_()
  got = card(xc, y.to('cuda'))
  (got * w.to('cuda')).sum().backward()
  xr = x.double().requires_grad_()
  want = torch.einsum('...i,ioj,...j->...o', xr, kernel, y.double()) + bias
  (want * w.double()).sum().backward()
  errs = {'out': _rel_err(got.double().cpu(), want)[1],
          'x_grad': _rel_err(xc.grad.double().cpu(), xr.grad)[1],
          'kernel_grad': _rel_err(card.bilinear_kernel.grad.double().cpu(),
                                  kernel.grad)[1]}
  if max(errs.values()) > BILINEAR_TOL:
    _fail(f'bilinear: card vs float64 {errs} (allowed {BILINEAR_TOL})')
  _log(f'bilinear: [{BILINEAR_B}, {BILINEAR_L}, {BILINEAR_X}] x '
       f'[{BILINEAR_Y}] on the card == float64 on the CPU within {errs}')
  return errs


def _scorers_phase(sparse_ms):
  """Phase 22: the other scorers (GAM, groupwise, DIN), Bilinear and the
  dense-gradient lazy update at full width; also the fused rows at the
  groupwise and DIN towers' shapes, timed. Returns its numbers."""
  import os
  import shutil
  import torch
  gen = torch.Generator().manual_seed(SEED + 60)
  root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      '.scratch', 'chip_smoke_scorers')
  shutil.rmtree(root, ignore_errors=True)
  os.makedirs(root)
  try:
    t0 = time.perf_counter()
    out = {'gam': _gam_phase(gen, root)}
    out['groupwise'] = _groupwise_phase(gen)
    out['din'] = _din_phase(gen, root)
    out['lazy_dense'] = _lazy_dense_phase(gen, sparse_ms)
    out['bilinear'] = _bilinear_phase(gen)
    out['phase_s'] = time.perf_counter() - t0
    return out
  finally:
    shutil.rmtree(root, ignore_errors=True)


def _time_scorer_kernels():
  """Phase 22f: the fused rows at the groupwise tower's shapes (N = 25,600,
  272-256-128-64) and DIN's (N = 6,400, 100-512-256-128), and rows 7-8 at
  GAM's B32 x L100 without a lambda weight, timed as phases 9a and 12a."""
  import torch
  gen = torch.Generator().manual_seed(SEED + 61)
  return {'fused_groupwise': _time_fused(gen, N_ROWS,
                                         (GROUP_SIZE * F,) + GROUP_HIDDEN),
          'fused_din': _time_fused(gen, DIN_B * DIN_L,
                                   (DIN_HEAD_SIZE,) + DIN_HIDDEN),
          'pairwise_gam': _time_pairwise(gen, ((GAM_B, GAM_L),), ('none',))}



# --- phase 23: the transformer encoder family at BERT-base widths ------------

# The repo's BERT-base profile (benchmarks/encoder_profile.py:27-30):
# vocabulary 30,522, hidden 768, 4 layers (a cut of BERT-base's 12), 12
# heads, mlp 3,072, B = 8 lists x L = 8 documents x T = 128 tokens; BERT's
# 512 positions, 2 segment types and dropout 0.1; softmax loss, Adam 1e-3,
# float32 with TF32 off.
ENC_VOCAB, ENC_HIDDEN, ENC_LAYERS, ENC_HEADS = 30_522, 768, 4, 12
ENC_MLP, ENC_MAX_LEN, ENC_TYPES, ENC_DROPOUT = 3072, 512, 2, 0.1
ENC_B, ENC_L, ENC_T, ENC_LR = 8, 8, 128, 1e-3
# Lists hold 4 to 8 documents of 16 to 128 tokens ([CLS] query [SEP]
# document [SEP], the rest [PAD] under input_mask 0).
ENC_MIN_DOCS, ENC_MIN_TOKENS = 4, 16
# 23d: one epoch of 80 steps at K = 10 over 640 train lists (a cut of
# scale) and 128 validation lists, ELWC in TFRBertDataLoader's format.
ENC_TRAIN_LISTS, ENC_VALID_LISTS = 640, 128
ENC_STEPS = ENC_TRAIN_LISTS // ENC_B
ENC_TABLE = r'token_embed/embedding'


def _encoder_model(gen):
  from ranking_tpu_torch.models import encoder
  from ranking_tpu_torch.models import scorers
  return scorers.RankingModel(encoder.EncoderScorer(
      encoder.TransformerEncoder(
          ENC_VOCAB, ENC_HIDDEN, ENC_LAYERS, ENC_HEADS, ENC_MLP, ENC_MAX_LEN,
          type_vocab_size=ENC_TYPES, dropout=ENC_DROPOUT, generator=gen),
      dropout=ENC_DROPOUT, generator=gen))


def _encoder_copy(pristine, dropout=ENC_DROPOUT, remat=False,
                  dtype=None, device='cuda'):
  """A copy of ``pristine`` at another dropout rate, remat switch, or
  compute and parameter dtype (float64 for the recomputes)."""
  import copy
  model = copy.deepcopy(pristine)
  for module in model.modules():
    if isinstance(getattr(module, 'dropout', None), float):
      module.dropout = dropout
    if dtype is not None and hasattr(module, 'dtype'):
      module.dtype = dtype
  model.scorer.encoder.remat = remat
  if dtype is not None:
    model = model.to(dtype)
  return model.to(device)


def _encoder_arrays(rng, lists):
  """numpy ``input_ids``, ``input_mask``, ``segment_ids`` ``[lists, L, T]``
  int64 and labels ``[lists, L]`` (graded 0-4, -1 on padded documents)."""
  import numpy as np
  shape = (lists, ENC_L, ENC_T)
  ids, masks, segs = (np.zeros(shape, np.int64) for _ in range(3))
  labels = np.full((lists, ENC_L), -1.0, np.float32)
  for i in range(lists):
    docs = rng.randint(ENC_MIN_DOCS, ENC_L + 1)
    labels[i, :docs] = rng.choice(5, docs, p=[.5, .3, .15, .04, .01])
    query = rng.randint(3, 13)
    for j in range(docs):
      n = rng.randint(ENC_MIN_TOKENS, ENC_T + 1)
      # BERT's vocabulary: word pieces from id 999 on, [CLS] 101, [SEP] 102.
      ids[i, j, :n] = rng.randint(min(999, ENC_VOCAB // 2), ENC_VOCAB, n)
      ids[i, j, [0, query + 1, n - 1]] = (101, 102, 102)
      masks[i, j, :n] = 1
      segs[i, j, query + 2:n] = 1
  return ids, masks, segs, labels


def _encoder_batches(rng, count):
  """``count`` flat-fed batches of ENC_B lists."""
  from ranking_tpu_torch.data import batch as batch_lib
  from ranking_tpu_torch.data import dataset
  out = []
  for _ in range(count):
    ids, masks, segs, labels = _encoder_arrays(rng, ENC_B)
    out.append(dataset.flatten_examples(batch_lib.batch_from_labels(
        labels, examples={'input_ids': ids, 'input_mask': masks,
                          'segment_ids': segs})))
  return out


def _encoder_records(seed, lists):
  """ELWC records of ``_encoder_arrays`` lists in TFRBertDataLoader's
  format (examples/encoder_ranking.py:185-195)."""
  import numpy as np
  from ranking_tpu_torch.data import proto
  ids, masks, segs, labels = _encoder_arrays(np.random.RandomState(seed),
                                             lists)
  return [proto.make_elwc({}, [
      {'input_ids': ids[i, j], 'input_mask': masks[i, j],
       'segment_ids': segs[i, j], 'relevance': [int(labels[i, j])]}
      for j in range(ENC_L) if labels[i, j] >= 0]) for i in range(lists)]


def _encoder_spec():
  from ranking_tpu_torch.data import parsers
  spec = {name: parsers.FixedLenFeature((ENC_T,), 'int64', 0)
          for name in ('input_ids', 'input_mask', 'segment_ids')}
  spec['relevance'] = parsers.FixedLenFeature((), 'int64', 0)
  return spec


def _encoder_flops(tokens, sequences):
  """Operations of one train step (forward and backward, 3x the forward's
  products): the blocks' projections and MLP over every token, attention's
  two [T, T] products a head, the pooler and score over the [CLS] rows."""
  h, m = ENC_HIDDEN, ENC_MLP
  per_token = ENC_LAYERS * 2 * (4 * h * h + 2 * h * m)
  attention = ENC_LAYERS * sequences * 2 * 2 * ENC_T * ENC_T * h
  pooled = sequences * 2 * (h * h + h)
  return 3 * (tokens * per_token + attention + pooled)


def _zero_in_theory_encoder(name):
  """Gradients zero in theory: an attention's key bias (a constant of
  every logit of a query row, which the softmax removes) and the score's
  bias (softmax over a list is shift-invariant)."""
  return name.endswith('.key.bias') or name == 'scorer.score.bias'


def _encoder_first_step(pristine, batch):
  """23a: the eval forward on the card against float64 on the CPU, and the
  first train step at dropout 0 against the same step in float64 (the
  encoder has no gate: GELU, softmax, tanh and LayerNorm are smooth, so the
  float64 step is the step of its own gates): loss and every gradient."""
  import torch
  from ranking_tpu_torch.models import layers
  from ranking_tpu_torch.ops import loss_registry
  from ranking_tpu_torch.train import state as state_lib
  from ranking_tpu_torch.train import steps
  out = {}
  model = _encoder_copy(pristine)
  card = steps.restore_flat_examples(batch.to('cuda'))
  host = steps.restore_flat_examples(batch)
  t0 = time.perf_counter()
  with torch.no_grad():
    got = model(card.context, card.examples, card.mask).double().cpu()
    ref = _encoder_copy(pristine, dtype=torch.float64, device='cpu')
    want = ref(host.context, host.examples, host.mask)
  del ref
  mask = host.mask
  largest = want[mask].abs().max().item()
  err = (got - want)[mask].abs().max().item()
  padding = torch.tensor(layers.PADDING_LOGIT, dtype=torch.float32).item()
  if (not torch.allclose(got[mask], want[mask], rtol=1e-4,
                         atol=1e-4 * largest)
      or not bool((got[~mask] == padding).all())):
    _fail(f'encoder forward: max |diff| {err} vs float64 (largest score '
          f'{largest}), or a padded document not log(1e-10)')
  out['forward_err'], out['forward_f64_s'] = err, time.perf_counter() - t0
  loss_fn = loss_registry.make_loss_fn('softmax_loss')
  step = steps.make_train_step(loss_fn, device='cuda')
  grads, losses = {}, {}
  for dtype in (torch.float32, torch.float64):
    state = state_lib.create_train_state(
        _encoder_copy(pristine, dropout=0.0,
                      dtype=None if dtype == torch.float32 else dtype),
        state_lib.adam(ENC_LR), device='cuda')
    state, metrics = step(state, batch)
    losses[dtype] = metrics['loss'].item()
    grads[dtype] = {n: p.grad.detach().double().cpu()
                    for n, p in state.model.named_parameters()}
    del state
  top = max(g.abs().max().item() for g in grads[torch.float64].values())
  errs = {}
  for name, want_g in grads[torch.float64].items():
    got_g = grads[torch.float32][name]
    scale = (top if _zero_in_theory_encoder(name)
             else want_g.abs().max().item())
    errs[name] = (got_g - want_g).abs().max().item() / max(scale, 1e-30)
  loss_err = abs(losses[torch.float32] - losses[torch.float64]) / abs(
      losses[torch.float64])
  worst = max(errs, key=errs.get)
  if loss_err > ANCHOR_TOL or errs[worst] > ANCHOR_TOL:
    _fail(f'encoder first step (dropout 0) vs float64: loss {loss_err:.3g}, '
          f'worst gradient {worst} {errs[worst]:.3g} (allowed {ANCHOR_TOL})')
  out.update(first_step_loss_err=loss_err, first_step_grad_err=errs[worst],
             first_step_worst=worst)
  _log(f'encoder: forward of {ENC_B} x {ENC_L} lists == float64 on the CPU '
       f'within {err:.3g} (largest score {largest:.3g}); first step at dropout '
       f'0 vs float64: loss {loss_err:.3g}, gradients within '
       f'{errs[worst]:.3g} of their largest entries ({worst})')
  del model
  gc.collect()
  torch.cuda.empty_cache()
  return out


def _encoder_memory_step(pristine, batch, remat):
  """23b: two eager steps at dropout 0.1 from a copy of ``pristine`` (a
  CUDA generator seeded alike for both settings); the second step's peak
  device memory over what was allocated before it. Returns (state,
  peak bytes)."""
  import torch
  from ranking_tpu_torch.ops import loss_registry
  from ranking_tpu_torch.train import state as state_lib
  from ranking_tpu_torch.train import steps
  step = steps.make_train_step(loss_registry.make_loss_fn('softmax_loss'),
                               device='cuda')
  state = state_lib.create_train_state(
      _encoder_copy(pristine, remat=remat), state_lib.adam(ENC_LR),
      device='cuda')
  rng = torch.Generator(device='cuda').manual_seed(SEED + 71)
  state, _ = step(state, batch, rng)
  torch.cuda.synchronize()
  resident = torch.cuda.memory_allocated()
  torch.cuda.reset_peak_memory_stats()
  state, _ = step(state, batch, rng)
  torch.cuda.synchronize()
  return state, torch.cuda.max_memory_allocated() - resident


def _encoder_sparse(pristine, batches, loss_fn):
  """23c: the sparse token step against the dense-gradient lazy step
  (``make_train_step`` on the same LazyAdam), one step at dropout 0.1 with
  equal generators: loss, dense gradients, tables and moments within
  SPARSE_TOL; rows no id touched keep their bits; row 10 once a step, no
  other launch; then row 10 against its plain version bitwise on the
  step's own ids at [30522, 768], n = 3, and timed. Returns (numbers, the
  step's LazyAdam, the EmbedFeatures)."""
  import torch
  from ranking_tpu_torch.ops.cuda import rows
  from ranking_tpu_torch.train import sparse as sparse_lib
  from ranking_tpu_torch.train import state as state_lib
  from ranking_tpu_torch.train import steps
  out = {}
  batch = batches[0]

  def lazy():
    return sparse_lib.LazyAdam(ENC_LR, table_pattern=ENC_TABLE,
                               max_rows=ENC_B * ENC_L * ENC_T)

  def make_state():
    return state_lib.create_train_state(
        _encoder_copy(pristine), state_lib.adam(ENC_LR), device='cuda',
        sparse_tx=lazy())

  dense_state, sparse_state = make_state(), make_state()
  efs = sparse_lib.derive_embed_features(
      sparse_lib.named_paths(sparse_state.model), batch.context,
      steps.restore_flat_examples(batch).examples, table_pattern=ENC_TABLE)
  if [(ef.feature, ef.param_path) for ef in efs] != [
      ('input_ids', 'scorer/encoder/token_embed/embedding')]:
    _fail(f'encoder sparse: derive_embed_features gave {efs}')
  path = efs[0].param_path
  dense_step = steps.make_train_step(loss_fn, device='cuda')
  sparse_step = steps.make_sparse_train_step(loss_fn, efs, device='cuda')
  table = sparse_lib.named_paths(dense_state.model)[path]
  before = table.detach().clone()
  counts = [steps.kernel_launch_counts()]
  dense_state, dm = dense_step(
      dense_state, batch, torch.Generator(device='cuda').manual_seed(SEED))
  counts.append(steps.kernel_launch_counts())
  record = []
  with _recording_updates(sparse_lib.LazyAdam, record):
    sparse_state, sm = sparse_step(
        sparse_state, batch, torch.Generator(device='cuda').manual_seed(SEED))
  counts.append(steps.kernel_launch_counts())
  torch.cuda.synchronize()
  launched = [{n: b[n] - a[n] for n in a if b[n] != a[n]}
              for a, b in zip(counts, counts[1:])]
  if launched != [{}, {'scatter_rows_multi': 1}]:
    _fail(f'encoder sparse: launches of the dense lazy step and the sparse '
          f'step {launched}')
  loss_err = abs(dm['loss'].item() - sm['loss'].item()) / abs(
      dm['loss'].item())
  sparse_params = dict(sparse_state.model.named_parameters())
  grad_err = max(_rel_err(p.grad, sparse_params[n].grad)[1]
                 for n, p in dense_state.model.named_parameters()
                 if p.grad is not None and not n.endswith('token_embed.'
                                                          'embedding'))
  differ, worst = _state_diff(sparse_state, dense_state)
  if max(loss_err, grad_err, worst) > SPARSE_TOL:
    _fail(f'encoder sparse vs dense lazy step: loss {loss_err:.3g}, dense '
          f'gradients {grad_err:.3g}, state {worst:.3g} ({differ[:4]})')
  touched = table.grad.abs().sum(1) > 0
  for state in (dense_state, sparse_state):
    t = sparse_lib.named_paths(state.model)[path].detach()
    if not (torch.equal(t[~touched], before[~touched]) and all(
        torch.equal(v[~touched], torch.zeros_like(v[~touched]))
        for v in state.sparse_opt_state[path].values())):
      _fail('encoder sparse: rows that no id touched changed')
  out.update(first_step_loss_err=loss_err, first_step_grad_err=grad_err,
             first_step_state_err=worst, touched_rows=int(touched.sum()),
             untouched_rows_kept=int((~touched).sum()))
  _log(f'encoder sparse token step vs the dense lazy step: loss '
       f'{loss_err:.3g}, dense gradients {grad_err:.3g}, tables, moments '
       f'and parameters {worst:.3g}; {int(touched.sum())} rows touched, '
       f'{int((~touched).sum())} kept their bits; row 10 once, nothing else')
  del dense_state, sparse_state, before, table
  gc.collect()
  torch.cuda.empty_cache()
  # Row 10 at the table's shape and the step's own ids: the slots the step
  # deduplicated to (filled) and those whose rows it updated (touched).
  grads, _ = record[0]
  uids, g, filled = grads[path]
  valid = filled & (g.abs().sum(1) > 0)
  gen = torch.Generator(device='cuda').manual_seed(SEED + 72)
  tables = [torch.randn(ENC_VOCAB, ENC_HIDDEN, device='cuda', generator=gen)
            for _ in range(3)]
  updates = [torch.randn(uids.shape[0], ENC_HIDDEN, device='cuda',
                         generator=gen) for _ in range(3)]
  twins = [t.clone() for t in tables]
  before = rows.scatter_rows_multi.launches
  rows.scatter_rows_multi(tables, uids, valid, updates)
  rows.scatter_rows_multi_reference(twins, uids, valid, updates)
  torch.cuda.synchronize()
  for t, w in zip(tables, twins):
    if not torch.equal(t, w):
      _fail('encoder: row 10 != its plain version at the token table')
  if rows.scatter_rows_multi.launches != before + 1:
    _fail('encoder: row 10 did not launch')
  ids64 = uids[valid].long()
  picked = [u[valid] for u in updates]
  call = lambda: rows.scatter_rows_multi(tables, uids, valid, updates)  # noqa: E731

  def library():
    for t, u in zip(tables, picked):
      t.index_copy_(0, ids64, u)

  n_valid = int(valid.sum())
  ms = _graph_ms(call, calls=10, replays=10)
  with rows.plain_versions():
    plain_ms = _event_ms(call, 10, warmup=2)
  library_ms = _graph_ms(library, calls=10, replays=10)
  bound_ms, bound_by = _rows_bound(3, n_valid, ENC_HIDDEN, uids.shape[0])
  # The launches made here to compare and time row 10 are not the path's.
  rows.scatter_rows_multi.launches = before
  out['row10'] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                      bound_ms=bound_ms, bound_by=bound_by, slots=int(
                          uids.shape[0]), valid_rows=n_valid)
  _log(f'encoder: row 10 == its plain version bitwise at [{ENC_VOCAB}, '
       f'{ENC_HIDDEN}] x 3 on the step\'s {n_valid} touched rows of '
       f'{uids.shape[0]} slots; {ms:.5f} ms (bound {bound_ms:.5f}, '
       f'{bound_by}; plain {plain_ms:.4f}; index_copy_ {library_ms:.5f})')
  del tables, updates, twins, record
  gc.collect()
  torch.cuda.empty_cache()
  return out, lazy, efs


def _encoder_pipeline(gen, root):
  """23d and 23e: ``SimplePipeline.train_and_validate`` over ELWC files in
  TFRBertDataLoader's format, timed over its replay-only dispatches; its
  graphed eval against the eager step under ``torch.profiler``, whose row
  1 on the card must equal the wrapper's record; the trained model
  exported on the CPU, float32 and int8, and served on the card against
  the live ``Predictor.predict``."""
  import copy
  import os
  import numpy as np
  import torch
  from ranking_tpu_torch.data import tfrecord
  from ranking_tpu_torch.pipeline import export
  from ranking_tpu_torch.pipeline import hparams as hparams_lib
  from ranking_tpu_torch.pipeline import pipeline as pipeline_lib
  from ranking_tpu_torch.pipeline import serving
  from ranking_tpu_torch.train import steps
  out = {}
  t0 = time.perf_counter()
  for split, lists, seed in (('train', ENC_TRAIN_LISTS, SEED + 73),
                             ('vali', ENC_VALID_LISTS, SEED + 74)):
    tfrecord.write_records(os.path.join(root, f'bert-{split}.tfrecord'),
                           _encoder_records(seed, lists))
  out['write_s'] = time.perf_counter() - t0
  spec = _encoder_spec()

  def builder():
    return pipeline_lib.SimpleDatasetBuilder(
        {}, spec, hparams_lib.DatasetHparams(
            train_input_pattern=os.path.join(root, 'bert-train.tfrecord'),
            valid_input_pattern=os.path.join(root, 'bert-vali.tfrecord'),
            train_batch_size=ENC_B, valid_batch_size=ENC_B, list_size=ENC_L,
            dataset_engine='native_loader'), seed=SEED)

  pipe = pipeline_lib.SimplePipeline(
      _encoder_copy(_encoder_model(gen)), builder(),
      hparams_lib.PipelineHparams(
          model_dir=os.path.join(root, 'model'), num_epochs=1,
          steps_per_epoch=ENC_STEPS, validation_steps=10 ** 6,
          learning_rate=ENC_LR, loss='softmax_loss',
          steps_per_execution=KSTEPS), device='cuda')
  history, run_s, steady = _timed_pipeline(pipe)
  if (pipe._multi_step.captures != 1 or pipe.final_state.step != ENC_STEPS
      or not all(math.isfinite(v) for v in history.values())):
    _fail(f'encoder pipeline: {pipe._multi_step.captures} captures, step '
          f'{pipe.final_state.step}, history {history}')
  graph_ms = [ms / KSTEPS for ms in steady['dispatch_ms']]
  out['pipeline'] = {'history': history, 'run_s': run_s,
                     'graph_ms_per_step': graph_ms, **steady}
  _log(f'encoder pipeline: one capture, {ENC_STEPS} steps, '
       f'{statistics.median(graph_ms):.4f} ms a step (graph replays), '
       f'{steady["loop_lists_per_s"]:.1f} lists/s over the replay-only '
       f'window, run {run_s:.1f} s, loss {history["loss"]:.4f}, val '
       f'ndcg@5 {history["ndcg@5"]:.4f}')
  trained = pipe.final_state.model
  # The pipeline's graphed eval against the eager step it wraps, under
  # torch.profiler: row 1 (the eval's sort) on the card must equal the
  # wrapper's eager calls plus what the capture recorded times the replays.
  eval_step = pipe._eval_step
  calls, replays = steps.kernel_launch_counts(), eval_step.replays
  result = {}
  device_counts = _kernel_counts(lambda: result.update(
      metrics=_hold_graphed_eval('encoder pipeline', pipe, builder(),
                                 history)))
  wrapper = (steps.kernel_launch_counts()['sorted_values_and_ranks']
             - calls['sorted_values_and_ranks'])
  per_replay = eval_step.captured_launches().get('sorted_values_and_ranks', 0)
  expected = wrapper + per_replay * (eval_step.replays - replays)
  card = device_counts.get(_ENTRY_KERNEL['sorted_values_and_ranks'], 0)
  if card != expected or card == 0:
    _fail(f'encoder pipeline: row 1 ran {card} times on the card in the '
          f'eval passes; the wrapper recorded {wrapper} eager calls and '
          f'{per_replay} a replay over {eval_step.replays - replays} replays: '
          f'{expected}')
  out['eval_metrics'] = result['metrics']
  out['row1'] = {'wrapper': wrapper, 'per_replay': per_replay,
                 'replays': eval_step.replays - replays, 'card': card}
  _log(f'encoder pipeline: its graphed eval == the eager step bitwise; row '
       f'1 ran {card} times on the card (torch.profiler) in the two passes, '
       f'as the wrapper recorded: {wrapper} eager calls + {per_replay} a '
       f'replay x {eval_step.replays - replays} replays')
  # 23e: the artifact, exported on the CPU, served on the card.
  records = _encoder_records(SEED + 75, ENC_B * 4)
  live = serving.Predictor(trained, example_feature_spec=spec,
                           list_size=ENC_L, label_feature_name='relevance',
                           device='cuda').predict(records)
  host_model = copy.deepcopy(trained).cpu()
  sample = next(iter(builder().valid_batches()))
  scores = {}
  t0 = time.perf_counter()
  for quant in (None, 'int8'):
    path = os.path.join(root, f'export_{quant}')
    export.export_predictor(host_model, None, {}, spec, path, sample,
                            list_size_buckets=(ENC_L,),
                            label_feature_name='relevance', quantize=quant)
    scores[quant] = export.load_predictor(path, device='cuda').predict(
        records)
  out['export_s'] = time.perf_counter() - t0
  valid = live > np.float32(math.log(1e-10))
  scale = float(np.abs(live[valid]).max())
  f32_err = float(np.abs(scores[None] - live)[valid].max())
  int8_err = float(np.abs(scores['int8'] - live)[valid].max())
  if (not np.allclose(scores[None], live, rtol=1e-4, atol=1e-4 * scale)
      or not np.array_equal(scores[None][~valid], live[~valid])):
    _fail(f'encoder artifact: float32 scores off the live predictor by '
          f'{f32_err} (largest {scale})')
  if int8_err > INT8_TOL * scale:
    _fail(f'encoder artifact: int8 scores off by {int8_err} (allowed '
          f'{INT8_TOL} of {scale})')
  out['export'] = {'float32_err': f32_err, 'int8_err': int8_err,
                   'largest_score': scale}
  _log(f'encoder artifact: {len(records)} requests on the card, float32 == '
       f'live predict within {f32_err:.3g}, int8 within {int8_err:.3g} '
       f'(largest score {scale:.3g}); export and load '
       f'{out["export_s"]:.1f} s')
  del pipe, trained, host_model, eval_step
  return out


def _encoder_warm_start(pristine):
  """23f: ``warm_start_from`` of the encoder's flax-path parameters from a
  second seed (``convert.to_flax`` of its state): every encoder parameter
  overlaid bitwise, the score kept; ``strict=True`` raises on an entry
  that nothing takes."""
  import torch
  from ranking_tpu_torch import convert
  from ranking_tpu_torch.models import encoder
  other = _encoder_model(torch.Generator().manual_seed(SEED + 76))
  tree = convert.to_flax(other.state_dict())['params']['scorer']['encoder']
  flat = {}

  def walk(node, prefix):
    for k, v in node.items():
      if isinstance(v, dict):
        walk(v, f'{prefix}{k}/')
      else:
        flat[f'{prefix}{k}'] = v

  walk(tree, '')
  mine = pristine.state_dict()
  merged = encoder.warm_start_from(mine, flat)
  theirs = other.state_dict()
  moved = [n for n in mine if n.startswith('scorer.encoder.')]
  if len(moved) != len(flat) or not all(
      torch.equal(merged[n], theirs[n]) for n in moved) or not all(
          torch.equal(merged[n], mine[n]) for n in mine if n not in moved):
    _fail('encoder warm start: the overlaid parameters are not the second '
          'seed\'s, or others moved')
  try:
    encoder.warm_start_from(mine, {**flat, 'unused/kernel': flat[
        'pooler/kernel']}, strict=True)
  except ValueError:
    pass
  else:
    _fail('encoder warm start: strict=True took an unused entry')
  _log(f'encoder warm start: {len(moved)} parameters overlaid bitwise from '
       'a second seed by path suffix; strict=True refused an unused entry')
  return {'overlaid': len(moved)}


def _encoder_phase():
  """Phase 23: the transformer encoder family at BERT-base widths. Returns
  (numbers, launches a step of each graphed path)."""
  import os
  import shutil
  import numpy as np
  import torch
  from ranking_tpu_torch.ops import loss_registry
  from ranking_tpu_torch.train import state as state_lib
  from ranking_tpu_torch.train import steps
  t0 = time.perf_counter()
  gen = torch.Generator().manual_seed(SEED + 70)
  pristine = _encoder_model(gen)
  batches = _encoder_batches(np.random.RandomState(SEED + 70), 2 * KSTEPS)
  loss_fn = loss_registry.make_loss_fn('softmax_loss')
  tokens = int(batches[0].examples['input_mask'].sum())
  flops = _encoder_flops(ENC_B * ENC_L * ENC_T, ENC_B * ENC_L)
  out = {'tokens_unmasked': tokens, 'flops_per_step': flops}
  out.update(_encoder_first_step(pristine, batches[0]))
  # 23a: 10 replays == 10 eager steps at dropout 0.1, a CUDA generator.
  step = steps.make_train_step(loss_fn, device='cuda')
  out['graph'] = _graph_vs_eager_22(
      'encoder step', lambda: state_lib.create_train_state(
          _encoder_copy(pristine), state_lib.adam(ENC_LR), device='cuda'),
      step, batches, True, {})
  if not out['graph']['bitwise']:
    _fail('encoder step: two eager runs differ, so graph == eager is not '
          'bitwise')
  graph_ms = out['graph']['graph_ms_per_step']
  out['tflops'] = flops / graph_ms / 1e9
  # Where an eager step's device time goes, by kernel name (torch.profiler).
  state = state_lib.create_train_state(
      _encoder_copy(pristine), state_lib.adam(ENC_LR), device='cuda')
  rng = torch.Generator(device='cuda').manual_seed(SEED + 77)
  prof = _profile(lambda: step(state, batches[0], rng), calls=3)
  gemm = sum(ms for name, ms in prof['by_name_ms'].items()
             if re.search(r'gemm|xmma|cutlass|sm90', name))
  out['profile'] = {'device_ms': prof['device_ms'],
                    'device_ops': prof['device_ops'],
                    'gemm_ms': gemm,
                    'by_name_ms': dict(list(prof['by_name_ms'].items())[:10])}
  del state
  # 23b: remat == plain, bitwise, and the peak memory of each.
  plain, out['peak_bytes'] = _encoder_memory_step(pristine, batches[0], False)
  remat, out['peak_bytes_remat'] = _encoder_memory_step(pristine, batches[0],
                                                        True)
  differ, worst = _state_diff(remat, plain)
  if differ:
    _fail(f'encoder remat: {len(differ)} tensors differ from the plain '
          f'step ({differ[:4]}, worst {worst:.3g})')
  del plain, remat
  gc.collect()
  torch.cuda.empty_cache()
  _log(f'encoder: {graph_ms:.4f} ms a step graphed, '
       f'{out["graph"]["eager_ms_per_step"]:.4f} eager; '
       f'{flops / 1e12:.3f} TFLOP a step, {out["tflops"]:.1f} TFLOP/s beside '
       f'the float32 pipes\' {F32_OPS_PER_S / 1e12:.0f}; an eager step\'s '
       f'device time {prof["device_ms"]:.3f} ms over '
       f'{prof["device_ops"]:.0f} operations, matrix products {gemm:.3f} ms; '
       f'remat == plain '
       f'bitwise over two steps at dropout 0.1; a step\'s peak over the '
       f'resident state {out["peak_bytes"] / 2 ** 30:.3f} GiB, with remat '
       f'{out["peak_bytes_remat"] / 2 ** 30:.3f} GiB')
  # 23c: the sparse token step.
  out['sparse'], lazy, efs = _encoder_sparse(pristine, batches, loss_fn)
  out['sparse_graph'] = _graph_vs_eager_22(
      'encoder sparse token step', lambda: state_lib.create_train_state(
          _encoder_copy(pristine), state_lib.adam(ENC_LR), device='cuda',
          sparse_tx=lazy()),
      steps.make_sparse_train_step(loss_fn, efs, device='cuda'), batches,
      True, {'scatter_rows_multi': 1})
  out['warm_start'] = _encoder_warm_start(pristine)
  del pristine, batches
  gc.collect()
  torch.cuda.empty_cache()
  # 23d, 23e: the pipeline, export and serving.
  root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      '.scratch', 'chip_smoke_encoder')
  shutil.rmtree(root, ignore_errors=True)
  os.makedirs(root)
  try:
    out.update(_encoder_pipeline(gen, root))
  finally:
    shutil.rmtree(root, ignore_errors=True)
  gc.collect()
  torch.cuda.empty_cache()
  out['phase_s'] = time.perf_counter() - t0
  _log(f'encoder: phase 23 took {out["phase_s"]:.1f} s')
  per_step = {'encoder': out['graph']['launches_per_step'],
              'encoder_sparse': out['sparse_graph']['launches_per_step']}
  return out, per_step

# --- phase 24: distribution -----------------------------------------------

# Two ranks share the one card over gloo (NCCL refuses two ranks on one
# card): their collectives pass through host memory, so phase 24's times
# are those of a correctness run, not of the card's collectives. Where the
# machine shows two cards or more, 24b also runs over NCCL across two.
DIST_WORLD = 2
DIST_STEPS = 3                    # 24a, 24b: train steps held
# 24b's third batch: the first half's lists hold 150 to 200 documents, the
# second half's at most 40, so that the two ranks' valid counts differ.
DIST_LONG, DIST_SHORT = 150, 40
DIST_SPARSE_STEPS = 2             # 24c
LS_B, LS_L = 16, 4096             # 24d: one [B, L, L] float32 is 1 GiB
# 24d: the loss is a float32 sum of up to B * L^2 pair terms on each side,
# summed in another order (a tree on the card); its relative error is at
# most log2(B * L^2) roundings of 2^-24 a side: log2(B * L^2) * 2^-23.
LS_LOSS_TOL = math.log2(LS_B * LS_L * LS_L) * 2.0 ** -23
# 24f: the CLI at its own widths (examples/ranking_elwc_pipeline.py),
# 8-token fields, lists of up to 50 documents, LazyAdam on the tables.
DIST_CLI_TRAIN_LISTS, DIST_CLI_VALID_LISTS = 96, 24


def _dist_root():
  return os.path.join(os.path.dirname(os.path.abspath(__file__)), '.scratch',
                      'chip_smoke_dist')


def _dist_model():
  """The flagship train model (phase 7's recipe) from a seed of its own, so
  that every process builds the same weights."""
  import torch
  return _train_model(torch.Generator().manual_seed(SEED + 240))


def _dist_batches():
  """24a and 24b's DIST_STEPS global batches, flat-fed: two flagship
  batches, then one whose halves (the two ranks' rows) hold unequal
  counts of valid documents."""
  import torch
  from ranking_tpu_torch.data import batch as batch_lib
  from ranking_tpu_torch.data import dataset
  gen = torch.Generator().manual_seed(SEED + 241)
  out = [_make_batch(gen, B) for _ in range(DIST_STEPS - 1)]
  long, short = (_make_batch(gen, B // 2, min_len=DIST_LONG),
                 _make_batch(gen, B // 2, min_len=1))
  keep = torch.arange(L) < DIST_SHORT
  short_mask = short.mask & keep
  out.append(batch_lib.RankingBatch(
      context={}, examples={'features': torch.cat(
          [long.examples['features'], short.examples['features']])},
      labels=torch.cat([long.labels, torch.where(short_mask, short.labels,
                                                 -1.0)]),
      mask=torch.cat([long.mask, short_mask])))
  return [dataset.flatten_examples(b) for b in out]


def _dist_eval_batch():
  """A ragged eval batch of B - 1 lists, padded to B by the caller."""
  import torch
  return _make_batch(torch.Generator().manual_seed(SEED + 242), B - 1)


def _cpu_tree(tree):
  """A copy of a (nested) state dict with every tensor on the CPU."""
  import torch
  if torch.is_tensor(tree):
    return tree.detach().to('cpu', copy=True)
  if isinstance(tree, dict):
    return {k: _cpu_tree(v) for k, v in tree.items()}
  if isinstance(tree, list):
    return [_cpu_tree(v) for v in tree]
  return tree


def _dist_train(state, step, batches):
  """Steps ``batches``; a record a step on the CPU: the model's and the
  optimizer's state before it, its loss, its gradients, the model's state
  after it, and what its backward started from (``_recording_tower``:
  the ReLU gates of this process's rows and the gradient of its logits)."""
  records = []
  for batch in batches:
    rec = {'before': _cpu_tree(state.model.state_dict()),
           'optimizer': _cpu_tree(state.optimizer.state_dict())}
    with _recording_tower(state.model) as seen:
      state, metrics = step(state, batch)
    rec.update(gates=[g.cpu() for g in seen['gates']],
               dlogits=seen['dlogits'].cpu())
    rec.update(loss=metrics['loss'].item(),
               grads={k: p.grad.detach().cpu()
                      for k, p in state.model.named_parameters()},
               after=_cpu_tree(state.model.state_dict()))
    records.append(rec)
  return records


def _dist_eval(model, mesh):
  """Metric results of phase 4's suite and the validation loss over the
  padded eval batch (24b holds them on the untrained model, the same
  parameters on both sides)."""
  from ranking_tpu_torch.data import dataset
  from ranking_tpu_torch.ops import loss_registry
  from ranking_tpu_torch.train import steps
  fns = _metric_fns()
  step = steps.make_eval_step(fns, loss_fn=loss_registry.make_loss_fn(
      'softmax_loss'), device='cuda', mesh=mesh)
  batch = dataset.flatten_examples(_dist_eval_batch().pad_to(B))
  states, _ = step(model, batch, steps.init_metric_states(
      fns, with_loss=True, device='cuda'), num_valid_rows=B - 1)
  return {k: v.item() for k, v in steps.metric_results(states, mesh).items()}


def _world_of_one(root):
  """24a: a world of one over NCCL at the flagship. The distributed code
  path (a process group up, every collective called on it) against phase
  7's one-card step, bitwise over DIST_STEPS steps; then K = 10 steps a
  dispatch through the graph, whose capture holds the NCCL collectives,
  against 10 eager steps on a copy, bitwise; and the graphed eval step,
  whose capture holds the logits' gather, against the eager one. Returns (numbers, the
  one-card eval of the untrained model, for 24b)."""
  import copy
  import torch
  import torch.distributed as dist
  from ranking_tpu_torch import parallel
  from ranking_tpu_torch.data import dataset
  from ranking_tpu_torch.ops import loss_registry
  from ranking_tpu_torch.train import state as state_lib
  from ranking_tpu_torch.train import steps
  loss_fn = loss_registry.make_loss_fn('softmax_loss')
  batches = [b.to('cuda') for b in _dist_batches()]
  model = _dist_model()
  twin = copy.deepcopy(model)
  one = state_lib.create_train_state(model, state_lib.adam(1e-3),
                                     device='cuda')
  one_eval = _dist_eval(one.model, None)
  one_records = _dist_train(one, steps.make_train_step(loss_fn,
                                                       device='cuda'),
                            batches)
  dist.init_process_group('nccl', init_method='file://' + os.path.join(
      root, 'rendezvous_a'), world_size=1, rank=0,
                          device_id=torch.device('cuda', 0))
  try:
    # make_mesh gives a world of one with no groups (its collectives are the
    # identity); this mesh puts the data and model groups on the world's
    # one rank, so that every collective of the step is called.
    group = dist.new_group([0])
    mesh = parallel.Mesh(1, 1, 0, group, group, group,
                         backend=str(dist.get_backend()))
    if not mesh.distributed or mesh.backend != 'nccl':
      _fail(f'24a: the mesh {mesh} has no NCCL group')
    _reset_all_launches()
    state = state_lib.create_train_state(twin, state_lib.adam(1e-3),
                                         device='cuda')
    step = steps.make_train_step(loss_fn, device='cuda', mesh=mesh)
    records = _dist_train(state, step, batches)
    launches = steps.kernel_launch_counts()
    for name in ('layer_forward', 'bwd_stats', 'bwd_mats'):
      if launches[name] != {'layer_forward': 3, 'bwd_stats': 1,
                            'bwd_mats': 2}[name] * DIST_STEPS:
        _fail(f'24a: {name} launched {launches[name]} times in '
              f'{DIST_STEPS} steps')
    differ, worst = _state_diff(state, one)
    losses = [r['loss'] for r in records]
    one_losses = [r['loss'] for r in one_records]
    if losses != one_losses or differ or any(
        not torch.equal(r['grads'][k], o['grads'][k])
        for r, o in zip(records, one_records) for k in o['grads']):
      _fail(f'24a: the world of one over NCCL differs from the one-card '
            f'step: losses {losses} vs {one_losses}, {len(differ)} state '
            f'tensors differ ({differ[:4]}, worst {worst:.3g})')
    # K steps a dispatch: a first dispatch warms up and captures, then 10
    # replays against 10 eager steps on a copy.
    host = _dist_batches()
    stacked = [steps.stack_batches(
        [host[(i + j) % DIST_STEPS] for i in range(KSTEPS)]).to('cuda')
        for j in range(2)]
    graphed = steps.make_multi_step(step, device='cuda')
    eager = steps.make_multi_step(step, device='cuda', eager=True)
    state, _ = graphed(state, stacked[0])
    twin_state = copy.deepcopy(state)
    torch.cuda.synchronize()
    state, graph_metrics = graphed(state, stacked[1])
    twin_state, eager_metrics = eager(twin_state, stacked[1])
    torch.cuda.synchronize()
    differ, worst = _state_diff(state, twin_state)
    if (graphed.captures != 1 or differ
        or not torch.equal(graph_metrics['loss'], eager_metrics['loss'])):
      _fail(f'24a: {KSTEPS} replays (captures {graphed.captures}) vs '
            f'{KSTEPS} eager steps over NCCL: {len(differ)} tensors differ '
            f'({differ[:4]}), worst {worst:.3g}')
    captured = graphed.captured_launches
    # The eval step as a CUDA graph with its NCCL gather captured: an eager
    # call, a capture and a replay, equal bitwise.
    fns = _metric_fns()
    graphed_eval = steps.GraphedEvalStep(steps.make_eval_step(
        fns, loss_fn=loss_fn, device='cuda', mesh=mesh), 'cuda')
    eval_batch = dataset.flatten_examples(_dist_eval_batch().pad_to(B))
    evals = []
    for _ in range(3):
      states, _ = graphed_eval(state.model, eval_batch,
                               steps.init_metric_states(
                                   fns, with_loss=True, device='cuda'),
                               num_valid_rows=B - 1)
      evals.append(steps.metric_results(states, mesh))
    if (graphed_eval.captures != 1 or graphed_eval.replays != 2
        or any(not torch.equal(e[k], evals[0][k]) for e in evals[1:]
               for k in evals[0])):
      _fail(f'24a: the graphed eval step over NCCL ({graphed_eval.captures} '
            f'captures, {graphed_eval.replays} replays) != the eager step: '
            f'{evals}')
  finally:
    dist.destroy_process_group()
  _log(f'24a: a world of one over NCCL: {DIST_STEPS} steps of the '
       f'distributed code path == the one-card step bitwise (losses '
       f'{[round(v, 6) for v in losses]}); {KSTEPS} replays of the graph '
       f'with its captured NCCL collectives == {KSTEPS} eager steps '
       f'bitwise; launches recorded at capture {captured}; the graphed '
       f'eval step with its NCCL gather == the eager one bitwise')
  numbers = {'launches': {k: v for k, v in launches.items() if v},
             'captured_launches': captured, 'replays': graphed.replays}
  return numbers, one_eval


def _dist_sparse_model(mesh=None):
  """Phase 13's sparse model from a seed of its own; with ``mesh`` its
  tables are row-sharded (``ShardedEmbeddingEncoder``)."""
  import torch
  from ranking_tpu_torch.models import scorers
  return scorers.RankingModel(scorers.EmbeddingDNNScorer(
      SPARSE_HIDDEN, vocab_sizes={'query_tokens': SPARSE_VOCAB,
                                  'document_tokens': SPARSE_VOCAB},
      embedding_dim=SPARSE_DIM, dropout=0.0, use_batch_norm=False,
      generator=torch.Generator().manual_seed(SEED + 243), mesh=mesh))


def _dist_sparse_run(mesh=None):
  """DIST_SPARSE_STEPS sparse steps of recipe A (LazyAdam(1e-3), adam
  (1e-3)) on phase 13's batches from a seed of its own. Returns (losses,
  state, the tables before the first step, the ids the batches touch)."""
  import torch
  from ranking_tpu_torch.ops import loss_registry
  from ranking_tpu_torch.train import sparse
  from ranking_tpu_torch.train import state as state_lib
  from ranking_tpu_torch.train import steps
  gen = torch.Generator().manual_seed(SEED + 244)
  batches = [_sparse_batch(gen) for _ in range(DIST_SPARSE_STEPS)]
  state = state_lib.create_train_state(
      _dist_sparse_model(mesh), state_lib.adam(1e-3), device='cuda',
      sparse_tx=sparse.LazyAdam(1e-3))
  tables = sparse.partition(sparse.named_paths(state.model),
                            state.sparse_tx)[1]
  before = {p: t.detach().clone() for p, t in tables.items()}
  efs = sparse.derive_embed_features(
      sparse.named_paths(state.model), batches[0].context,
      steps.restore_flat_examples(batches[0]).examples)
  step = steps.make_sparse_train_step(
      loss_registry.make_loss_fn('softmax_loss'), efs, device='cuda',
      mesh=mesh)
  losses = []
  for batch in batches:
    state, metrics = step(state, batch)
    losses.append(metrics['loss'].item())
  ids = {}
  for ef in efs:
    src = 'context' if ef.source == 'context' else 'examples'
    flat = torch.cat([getattr(b, src)[ef.feature].reshape(-1)
                      for b in batches])
    ids[ef.param_path] = torch.unique(flat[flat >= 0]).long()
  return losses, state, before, ids


def _dist_sparse_rank(mesh):
  """24c on one rank: its shard's untouched rows keep their bits; its
  touched rows (global ids), their values and moments go to the host."""
  import torch
  from ranking_tpu_torch.ops.cuda import rows
  losses, state, before, ids = _dist_sparse_run(mesh)
  out = {'losses': losses, 'rows': {}}
  if rows.scatter_rows_multi.launches != 2 * DIST_SPARSE_STEPS:
    _fail(f'24c: row 10 launched {rows.scatter_rows_multi.launches} times '
          f'on rank {mesh.rank}, not once a table and step')
  for path, old in before.items():
    table = dict(state.model.named_parameters())[path.replace('/', '.')]
    moments = state.sparse_opt_state[path]
    n = table.shape[0]
    lo = mesh.model_index * n
    mine = ids[path][(ids[path] >= lo) & (ids[path] < lo + n)] - lo
    untouched = torch.ones(n, dtype=torch.bool, device='cuda')
    untouched[mine.to('cuda')] = False
    if (not torch.equal(table.detach()[untouched], old[untouched])
        or moments['m'][untouched].any() or moments['v'][untouched].any()):
      _fail(f'24c: rank {mesh.rank}: untouched rows of {path} moved')
    sel = mine.to('cuda')
    out['rows'][path] = {
        'ids': (mine + lo), 'table': table.detach()[sel].cpu(),
        'm': moments['m'][sel].cpu(), 'v': moments['v'][sel].cpu(),
        'local_rows': n}
  return out


def _ls_inputs():
  """24d's labels and logits ``[LS_B, LS_L]``: graded labels on ragged
  lists, and logits that no two items of a list share (a tie's gradient
  is the one place where the jnp formula, -1, and the kernel, -0.5,
  differ)."""
  import torch
  gen = torch.Generator().manual_seed(SEED + 245)
  labels, _ = _graded_labels(gen, LS_B, LS_L, LS_L // 2)
  logits = torch.stack([torch.randperm(LS_L, generator=gen)
                        for _ in range(LS_B)]).float()
  return labels, (logits - LS_L / 2) / 512.0


def _dist_list_rank(mesh):
  """24d on one rank: its [B, L/2] block of the list-sharded loss, its
  gradient and the rank's peak memory over what was resident before."""
  import torch
  from ranking_tpu_torch import parallel
  labels, logits = _ls_inputs()
  n = LS_L // mesh.model
  cols = slice(mesh.model_index * n, (mesh.model_index + 1) * n)
  torch.cuda.synchronize()
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  resident = torch.cuda.memory_allocated()
  x = logits[:, cols].to('cuda').requires_grad_()
  loss = parallel.sharded_pairwise_loss(labels[:, cols].to('cuda'), x, mesh,
                                        loss_kind='logistic')
  loss.backward()
  torch.cuda.synchronize()
  return {'loss': loss.item(), 'grad': x.grad.cpu(), 'col0': cols.start,
          'peak_mib': (torch.cuda.max_memory_allocated() - resident)
                      / 2 ** 20}


def _dist_encoder_step(mesh=None):
  """One train step of phase 23's profile at dropout 0.1 with a CUDA
  generator from a fixed seed; under ``mesh`` tensor-parallel
  (``ENCODER_TP_RULES``). Returns (loss, the whole gradients on the
  CPU, the names that are model-sharded)."""
  import numpy as np
  import torch
  from ranking_tpu_torch import parallel
  from ranking_tpu_torch.ops import loss_registry
  from ranking_tpu_torch.parallel import comm
  from ranking_tpu_torch.parallel import mesh as mesh_lib
  from ranking_tpu_torch.train import state as state_lib
  from ranking_tpu_torch.train import steps
  model = _encoder_model(torch.Generator().manual_seed(SEED + 246))
  if mesh is not None:
    parallel.shard_module(model, mesh, parallel.ENCODER_TP_RULES)
  state = state_lib.create_train_state(model, state_lib.adam(ENC_LR),
                                       device='cuda')
  batch = _encoder_batches(np.random.RandomState(SEED + 247), 1)[0]
  step = steps.make_train_step(loss_registry.make_loss_fn('softmax_loss'),
                               device='cuda', mesh=mesh)
  rng = torch.Generator(device='cuda').manual_seed(SEED + 248)
  state, metrics = step(state, batch, rng)
  dims = {} if mesh is None else mesh_lib.sharded_dims(state.model)
  grads = {}
  for k, p in state.model.named_parameters():
    g = p.grad
    if k in dims:
      g = comm.all_gather(g, mesh.model_group, dims[k])
    grads[k] = g.cpu()
  return metrics['loss'].item(), grads, sorted(dims)


def _dist_cli_args(root):
  return [f'--train_pattern={os.path.join(root, "cli_train.tfrecord")}',
          f'--valid_pattern={os.path.join(root, "cli_valid.tfrecord")}',
          f'--model_dir={os.path.join(root, "cli_run")}',
          f'--query_tokens={SPARSE_T}', f'--document_tokens={SPARSE_T}',
          f'--list_size={SPARSE_L}', '--num_epochs=2', '--steps_per_epoch=5',
          '--validation_steps=3', '--optimizer=lazy_adam', '--device=cuda',
          '--backend=gloo', f'--mesh_model={DIST_WORLD}']


def _dist_cli_rank(root):
  """24f on one rank: the CLI, then the live model's scores of the first
  validation batch."""
  import torch
  from ranking_tpu_torch.examples import ranking_elwc_pipeline as cli
  pipe, history = cli.main(_dist_cli_args(root))
  batch = next(iter(pipe.dataset_builder.valid_batches())).to('cuda')
  model = pipe.final_state.model.eval()
  with torch.no_grad():
    logits = model(batch.context, batch.examples, batch.mask)
  return {'history': history, 'logits': logits.cpu(),
          'batch': batch.to('cpu'),
          'mesh': (pipe.mesh.data, pipe.mesh.model)}


def _dist_rank(rank, world, root):
  """One rank of 24b-f: gloo over CUDA tensors on the one card (NCCL where
  ``DIST_NCCL`` is set in the environment, one card a rank); each
  sub-phase from wrapper counts of 0; results, or the failure, to
  ``<root>/rank<r>.pt``."""
  import traceback
  import torch
  import torch.distributed as dist
  os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                    WORLD_SIZE=str(world))
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  from ranking_tpu_torch import parallel
  from ranking_tpu_torch.ops import loss_registry
  from ranking_tpu_torch.train import state as state_lib
  from ranking_tpu_torch.train import steps
  nccl = bool(os.environ.get('DIST_NCCL'))
  parallel.init_distributed(
      'cuda', init_method='file://' + os.path.join(
          root, 'rendezvous_nccl' if nccl else 'rendezvous'),
      world_size=world, rank=rank, backend='nccl' if nccl else 'gloo')
  out = {}
  try:
    for name in ('b', 'c', 'd', 'e', 'f'):
      if nccl and name != 'b':
        continue
      _reset_all_launches()
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      if name == 'b':
        mesh = parallel.make_mesh(data=world)
        state = state_lib.create_train_state(_dist_model(),
                                             state_lib.adam(1e-3),
                                             device='cuda')
        step = steps.make_train_step(
            loss_registry.make_loss_fn('softmax_loss'), device='cuda',
            mesh=mesh)
        evaluated = _dist_eval(state.model, mesh)
        res = {'records': _dist_train(state, step, [
            b.to('cuda') for b in _dist_batches()]), 'eval': evaluated}
      elif name == 'c':
        res = _dist_sparse_rank(parallel.make_mesh(data=1, model=world))
      elif name == 'd':
        res = _dist_list_rank(parallel.make_mesh(data=1, model=world))
      elif name == 'e':
        mesh = parallel.make_mesh(data=1, model=world)
        loss, grads, sharded = _dist_encoder_step(mesh)
        res = {'loss': loss, 'sharded': sharded,
               'grads': grads if rank == 0 else None}
      else:
        res = _dist_cli_rank(root)
      torch.cuda.synchronize()
      res['s'] = time.perf_counter() - t0
      res['launches'] = steps.kernel_launch_counts()
      out[name] = res
  except (Exception, SystemExit):  # reported by the parent, which fails
    # the phase
    out['error'] = traceback.format_exc()
  finally:
    torch.save(out, os.path.join(root, f'rank{rank}{"_nccl" * nccl}.pt'))
    dist.destroy_process_group()


def _spawn_ranks(root, nccl=False):
  """DIST_WORLD processes of ``_dist_rank``; each rank's results."""
  import torch
  import torch.multiprocessing as mp
  env = dict(os.environ)
  try:
    if nccl:
      os.environ['DIST_NCCL'] = '1'
    mp.start_processes(_dist_rank, args=(DIST_WORLD, root),
                       nprocs=DIST_WORLD, join=True, start_method='spawn')
  finally:
    os.environ.clear()
    os.environ.update(env)
  out = [torch.load(os.path.join(root, f'rank{r}{"_nccl" * nccl}.pt'),
                    weights_only=False) for r in range(DIST_WORLD)]
  for r, res in enumerate(out):
    if 'error' in res:
      _fail(f'24: rank {r}{" (NCCL)" * nccl} failed:\n{res["error"]}')
  return out


def _hold_data_parallel(what, ranks, one_eval):
  """24b: each of a rank's DIST_STEPS steps against the one-card step from
  the rank's own state before it (model and optimizer), on the same
  global batch. Two runs of Adam from one start drift apart wherever a
  gradient lies within rounding of 0, whose first moves are a whole rate
  in the direction of its rounding noise; so each step is held from the
  state the rank had. The loss to 1e-5 and the running statistics after
  the step to 1e-5 of their largest value (phase 7's first-step bounds);
  the gradients as phase 7 holds the first step against the plain
  versions (``_grad_errors``: OP_TOL_NORM in the norm, OP_TOL_MAX at the
  largest entry; the biases in front of a BN and the output bias zero in
  theory, to their rounding bound N_ROWS * 2^-23 of the largest logit
  gradient): the moments are sums over the global batch in another
  order, so a ReLU gate within rounding of 0 may open on one side only.
  A step beyond OP_TOL_NORM is settled as ``_hold_first_step`` settles
  one: the ranks' gradients and the one card's must each be within
  ANCHOR_TOL (in the norm and at the largest entry) of the float64 step
  of their own ReLU gates and loss gradient (``_first_step_f64``; the
  ranks' gates and logit gradients gathered over their rows).
  The parameters after the step: Adam's first moves are a whole rate in
  the direction of each gradient entry, so an entry within rounding of 0
  moves either way; so the rank's parameters are held bitwise to the
  one-card optimizer applied to the rank's own gradients from the same
  state (the gradients themselves held above). Both ranks' records must
  be equal bitwise. The eval on the untrained model to 1e-6 (phase
  5's)."""
  import torch
  from ranking_tpu_torch.ops import loss_registry
  from ranking_tpu_torch.train import state as state_lib
  from ranking_tpu_torch.train import steps
  loss_fn = loss_registry.make_loss_fn('softmax_loss')
  step = steps.make_train_step(loss_fn, device='cuda')
  batches = [b.to('cuda') for b in _dist_batches()]
  zero = _zero_in_theory(_dist_model(), True)
  zero_tol = _zero_tol(_dist_model(), loss_fn, _dist_batches()[0])
  worst = {'loss': 0.0, 'grad_norm': 0.0, 'grad_max': 0.0, 'stats': 0.0,
           'eval': 0.0}
  records = ranks[0]['records']
  for r, res in enumerate(ranks[1:], start=1):
    for rec, other in zip(records, res['records']):
      if rec['loss'] != other['loss'] or any(
          not torch.equal(v, other['after'][k])
          for k, v in rec['after'].items()):
        _fail(f'{what}: ranks 0 and {r} hold different states')
  def restored(rec):
    model = _dist_model()
    model.load_state_dict(rec['before'])
    state = state_lib.create_train_state(model, state_lib.adam(1e-3),
                                         device='cuda')
    state.optimizer.load_state_dict(rec['optimizer'])
    return state

  for i, rec in enumerate(records):
    # The optimizer on the rank's own gradients: bitwise its parameters.
    state = restored(rec)
    for k, p in state.model.named_parameters():
      p.grad = rec['grads'][k].to('cuda')
    state.apply_gradients()
    for k, p in state.model.named_parameters():
      if not torch.equal(p.detach().cpu(), rec['after'][k]):
        _fail(f'{what}: step {i}: {k} is not the optimizer\'s update of '
              f'the rank\'s gradient')
    state = restored(rec)
    with _recording_tower(state.model) as one_record:
      state, metrics = step(state, batches[i])
    want = metrics['loss'].item()
    err = abs(rec['loss'] - want) / abs(want)
    worst['loss'] = max(worst['loss'], err)
    if err > 1e-5:
      _fail(f'{what}: step {i}: loss {rec["loss"]} vs one card {want}')
    one_grads = {k: p.grad for k, p in state.model.named_parameters()}
    rank_grads = {k: v.to('cuda') for k, v in rec['grads'].items()}
    norm, name, top, top_name = _grad_errors(rank_grads, one_grads, zero,
                                             zero_tol)
    worst['grad_norm'] = max(worst['grad_norm'], norm)
    worst['grad_max'] = max(worst['grad_max'], top)
    if top > OP_TOL_MAX:
      _fail(f'{what}: step {i}: gradients differ from the one card by '
            f'{top:.3g} at most ({top_name}; {norm:.3g} in norm)')
    if norm > OP_TOL_NORM:
      before = _dist_model()
      before.load_state_dict(rec['before'])
      rank_record = {
          'gates': [torch.cat([r['records'][i]['gates'][l] for r in ranks])
                    .to('cuda') for l in range(len(rec['gates']))],
          'dlogits': torch.cat([r['records'][i]['dlogits'] for r in ranks]
                               ).to('cuda')}
      flips = sum(int((g != o).sum().item()) for g, o in zip(
          rank_record['gates'], one_record['gates']))
      for side, grads, record in (('ranks\'', rank_grads, rank_record),
                                  ('one card\'s', one_grads, one_record)):
        e = _grad_errors(grads, _first_step_f64(before, batches[i], record),
                         zero, zero_tol)
        worst.setdefault('anchored', []).append(
            {'step': i, 'side': side, 'norm': e[0], 'max': e[2],
             'gates_differ': flips})
        if e[0] > ANCHOR_TOL or e[2] > ANCHOR_TOL:
          _fail(f'{what}: step {i}: gradients differ from the one card by '
                f'{norm:.3g} in norm ({name}); the {side} step is off from '
                f'the float64 step of its own ReLU gates and loss gradient '
                f'by {e[0]:.3g} in norm ({e[1]}), {e[2]:.3g} at most '
                f'({e[3]}); the two forwards differ in {flips} gates')
    after = _cpu_tree(state.model.state_dict())
    for k, want in after.items():
      got = rec['after'][k]
      if not want.is_floating_point():
        if not torch.equal(got, want):
          _fail(f'{what}: step {i}: {k} {got} vs {want}')
      elif 'running' in k:
        err = _rel_err(got, want)[1]
        worst['stats'] = max(worst['stats'], err)
        if err > 1e-5:
          _fail(f'{what}: step {i}: {k} off by {err:.3g} of its largest')
  for r, res in enumerate(ranks):
    for k, want in one_eval.items():
      err = abs(res['eval'][k] - want)
      worst['eval'] = max(worst['eval'], err)
      if err > 1e-6:
        _fail(f'{what}: rank {r}: eval {k} {res["eval"][k]} vs {want}')
    launches = res['launches']
    if (launches['layer_forward'] != 3 * DIST_STEPS
        or launches['bwd_stats'] != DIST_STEPS
        or launches['bwd_mats'] != 2 * DIST_STEPS
        or launches['sorted_values_and_ranks'] == 0):
      _fail(f'{what}: rank {r} launches {launches}')
  return worst


def _dist_phase():
  """Phase 24: distribution. Returns (numbers, each rank's wrapper
  launches by sub-phase)."""
  import shutil
  import torch
  from ranking_tpu_torch.data import tfrecord
  from ranking_tpu_torch.ops import loss_registry
  from ranking_tpu_torch.ops.cuda import pairwise
  from ranking_tpu_torch.train import checkpoint
  from ranking_tpu_torch.train import sparse
  from ranking_tpu_torch.train import state as state_lib
  root = _dist_root()
  shutil.rmtree(root, ignore_errors=True)
  os.makedirs(root)
  out = {'backend': 'gloo over CUDA tensors, two ranks on one card',
         'card': _card_line()}
  try:
    t0 = time.perf_counter()
    out['a'], one_eval = _world_of_one(root)
    out['a']['s'] = time.perf_counter() - t0
    tfrecord.write_records(os.path.join(root, 'cli_train.tfrecord'),
                           _token_records(SEED + 249, DIST_CLI_TRAIN_LISTS))
    tfrecord.write_records(os.path.join(root, 'cli_valid.tfrecord'),
                           _token_records(SEED + 250, DIST_CLI_VALID_LISTS))
    t0 = time.perf_counter()
    ranks = _spawn_ranks(root)
    out['spawn_s'] = time.perf_counter() - t0
    launches = {name: [r[name]['launches'] for r in ranks]
                for name in 'bcdef'}
    launches['a'] = out['a']['launches']
    out['s'] = {name: [r[name]['s'] for r in ranks] for name in 'bcdef'}

    # 24b: data=2 at the flagship, 64 + 64 rows.
    def check_b():
      out['b'] = _hold_data_parallel('24b', [r['b'] for r in ranks], one_eval)
      if torch.cuda.device_count() >= DIST_WORLD:
        nccl = _spawn_ranks(root, nccl=True)
        out['b_nccl'] = _hold_data_parallel('24b (NCCL)',
                                            [r['b'] for r in nccl], one_eval)
      else:
        out['b_nccl'] = 'not run: one card'
      _log(f'24b: data={DIST_WORLD} at the flagship over gloo: '
           f'{DIST_STEPS} steps (the third with {DIST_LONG}-200 and at most '
           f'{DIST_SHORT} valid documents a list on the two ranks) == the '
           f'one-card step from each step\'s state: {out["b"]}; NCCL across cards: '
           f'{out["b_nccl"] if isinstance(out["b_nccl"], str) else "held"}; '
           f'launches per rank {launches["b"]}')

    # 24c: the sparse step's tables over model=2 against the one card.
    def check_c():
      one_losses, one_state, _, _ = _dist_sparse_run()
      worst = 0.0
      for r, res in enumerate(ranks):
        res = res['c']
        for got, want in zip(res['losses'], one_losses):
          if abs(got - want) > SPARSE_TOL * abs(want):
            _fail(f'24c: rank {r} loss {got} vs one card {want}')
        for path, rows_ in res['rows'].items():
          if rows_['local_rows'] != SPARSE_VOCAB // DIST_WORLD:
            _fail(f'24c: rank {r} holds {rows_["local_rows"]} rows of {path}')
          ids = rows_['ids'].to('cuda')
          table = dict(one_state.model.named_parameters())[
              path.replace('/', '.')].detach()
          moments = one_state.sparse_opt_state[path]
          for name, want in (('table', table[ids]), ('m', moments['m'][ids]),
                             ('v', moments['v'][ids])):
            err = _rel_err(rows_[name].to('cuda'), want)[1]
            worst = max(worst, err)
            if err > SPARSE_TOL:
              _fail(f'24c: rank {r} {path} {name} of touched rows off by '
                    f'{err:.3g} of the largest value')
      touched = {p: sum(r['c']['rows'][p]['ids'].numel() for r in ranks)
                 for p in ranks[0]['c']['rows']}
      del one_state
      torch.cuda.empty_cache()
      out['c'] = {'worst_touched': worst, 'touched_rows': touched,
                  'row10_launches_per_rank': [
                      r['c']['launches']['scatter_rows_multi'] for r in ranks]}
      _log(f'24c: tables of {SPARSE_VOCAB} x {SPARSE_DIM} over model='
           f'{DIST_WORLD}: {DIST_SPARSE_STEPS} sparse steps == the one-card '
           f'steps (untouched rows bitwise on each rank, touched rows of '
           f'{touched} within {worst:.3g} of the largest value); row 10 on '
           f'each rank\'s shard {out["c"]["row10_launches_per_rank"]}')

    # 24d: the list-sharded pairwise loss against rows 7-8 on one card.
    def check_d():
      labels, logits = _ls_inputs()
      torch.cuda.synchronize()
      torch.cuda.empty_cache()
      torch.cuda.reset_peak_memory_stats()
      resident = torch.cuda.memory_allocated()
      before = [fn.launches for fn in pairwise.KERNEL_WRAPPERS]
      x = logits.to('cuda').requires_grad_()
      loss = loss_registry.make_loss_fn('pairwise_logistic_loss')(
          labels.to('cuda'), x)
      loss.backward()
      torch.cuda.synchronize()
      one_peak = (torch.cuda.max_memory_allocated() - resident) / 2 ** 20
      kernel_calls = [fn.launches - b for fn, b in zip(
          pairwise.KERNEL_WRAPPERS, before)]
      if kernel_calls != [1, 1]:
        _fail(f'24d: the one-card loss launched rows 7-8 {kernel_calls}')
      grad = torch.zeros_like(logits)
      loss_err = 0.0
      for r in ranks:
        res = r['d']
        loss_err = max(loss_err, abs(res['loss'] - loss.item())
                       / abs(loss.item()))
        grad[:, res['col0']:res['col0'] + res['grad'].shape[1]] = res['grad']
      grad_err = _rel_err(grad, x.grad.cpu())[1]
      if loss_err > LS_LOSS_TOL or grad_err > PAIR_TOL:
        _fail(f'24d: list-sharded loss off by {loss_err:.3g} (allowed '
              f'{LS_LOSS_TOL:.3g}), gradient by {grad_err:.3g} of the largest '
              f'(allowed {PAIR_TOL})')
      out['d'] = {'loss_err': loss_err, 'grad_err': grad_err,
                  'one_card_peak_mib': one_peak,
                  'rank_peak_mib': [r['d']['peak_mib'] for r in ranks]}
      del x, loss, grad
      _log(f'24d: the list-sharded pairwise loss at B{LS_B} x L{LS_L} over '
           f'model={DIST_WORLD} == rows 7-8 on one card (loss within '
           f'{loss_err:.3g}, gradient {grad_err:.3g} of the largest); peak '
           f'memory over the resident state a rank '
           f'{out["d"]["rank_peak_mib"]} MiB, one card (rows 7-8, no '
           f'[B, L, L] tensor) {one_peak:.1f} MiB')

    # 24e: the BERT-base profile over model=2 against the one card.
    def check_e():
      one_loss, one_grads, _ = _dist_encoder_step()
      sharded = ranks[0]['e']['sharded']
      scale = max(g.abs().max().item() for g in one_grads.values())
      worst = {'loss': 0.0, 'grad': 0.0}
      for r in ranks:
        err = abs(r['e']['loss'] - one_loss) / abs(one_loss)
        worst['loss'] = max(worst['loss'], err)
        if err > 1e-5:
          _fail(f'24e: TP loss {r["e"]["loss"]} vs one card {one_loss}')
      for k, want in one_grads.items():
        got = ranks[0]['e']['grads'][k]
        top = (scale if _zero_in_theory_encoder(k)
               else max(want.abs().max().item(), 1e-30))
        err = (got - want).abs().max().item() / top
        worst['grad'] = max(worst['grad'], err)
        if err > ANCHOR_TOL:
          _fail(f'24e: TP gradient {k} off by {err:.3g} of its largest entry '
                f'(allowed ANCHOR_TOL {ANCHOR_TOL})')
      if not any('query.kernel' in n for n in sharded):
        _fail(f'24e: no projection was split over the model axis: {sharded}')
      out['e'] = {**worst, 'sharded_params': len(sharded)}
      _log(f'24e: BERT-base profile over model={DIST_WORLD} '
           f'({len(sharded)} parameters split): one step == the one-card step '
           f'(loss within {worst["loss"]:.3g}, gradients within '
           f'{worst["grad"]:.3g} of their largest entries)')
      del one_grads

    # 24f: the CLI under two ranks with --mesh_model=2.
    def check_f():
      from ranking_tpu_torch.models import scorers
      run_dir = os.path.join(root, 'cli_run')
      res = [r['f'] for r in ranks]
      if [r['mesh'] for r in res] != [(1, DIST_WORLD)] * DIST_WORLD:
        _fail(f'24f: meshes {[r["mesh"] for r in res]}')
      export = checkpoint.load_params(os.path.join(run_dir, 'export',
                                                   'latest'))
      model = scorers.RankingModel(scorers.EmbeddingDNNScorer(
          (64, 32, 16), vocab_sizes={'query_tokens': 10000,
                                     'document_tokens': 10000},
          embedding_dim=20, dropout=0.5))
      one = state_lib.create_train_state(
          model, state_lib.adam(0.05), device='cuda',
          sparse_tx=sparse.LazyAdam(0.05))
      checkpoint.CheckpointManager(os.path.join(run_dir, 'checkpoints')
                                   ).restore(one)
      if one.step != 10 or any(not torch.equal(v.cpu(), export[k])
                               for k, v in one.model.state_dict().items()):
        _fail(f'24f: the checkpoint of step {one.step} does not restore the '
              'export on one card')
      one.model.eval()
      batch = res[0]['batch'].to('cuda')
      with torch.no_grad():
        served = one.model(batch.context, batch.examples, batch.mask).cpu()
      cli_err = max(_rel_err(served, r['logits'])[1] for r in res)
      if cli_err > SPARSE_TOL:
        _fail(f'24f: the export scores {cli_err:.3g} of the largest score '
              'away from the live model')
      with open(os.path.join(run_dir, 'metrics.jsonl')) as f:
        epochs = len(f.read().splitlines())
      if epochs != 2:
        _fail(f'24f: {epochs} lines in metrics.jsonl, one writer expected')
      for r, l in enumerate(launches['f']):
        if not (l['sorted_values_and_ranks'] and l['scatter_rows_multi']):
          _fail(f'24f: rank {r} launches {l}')
      out['f'] = {'export_vs_live': cli_err,
                  'history': {k: v for k, v in res[0]['history'].items()}}
      _log(f'24f: the ELWC CLI on {DIST_WORLD} ranks with --mesh_model='
           f'{DIST_WORLD}: {res[0]["history"]}; its checkpoint restores on one '
           f'card bitwise its export, which scores within {cli_err:.3g} of the '
           f'largest score of the live model')

    # Every sub-phase is held, and then every failure reported.
    failures = []
    for check in (check_b, check_c, check_d, check_e, check_f):
      try:
        check()
      except SystemExit as e:
        failures.append(str(e))
    if failures:
      _fail(' | '.join(failures))
  finally:
    shutil.rmtree(root, ignore_errors=True)
  return out, launches


# Phase 25: the example programs (ranking_tpu_torch/examples/) on the card,
# each through its main() as a user runs it. (a) ranking_libsvm at the
# flagship widths over phase 17's LIBSVM files: 20 LambdaRank steps and one
# evaluation, then 10 steps each at the CLI's defaults, with --scorer=gam
# and with --group_size=2.
EX_LIBSVM_STEPS, EX_DEFAULT_STEPS = 20, 10
# (g) unbiased_two_tower as the JAX package's test runs it
# (tests/test_examples.py:191-196): the two-tower model's true NDCG@5 must
# beat the naive click model's by this much.
EX_DEBIAS_MARGIN = 0.03


def _examples_root():
  return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      '.scratch', 'chip_smoke_examples')


def _examples_libsvm(root):
  """25a: ``ranking_libsvm`` at 136 -> 1024-512-256, B128 x L200, dropout 0,
  ``--lambda_ndcg``: 20 steps and one evaluation. Each step's launches
  (rows 2-4 3 / 1 / 2, rows 5-6 0, rows 7-8 1 / 1, row 1 the same each
  step) and the evaluation's (row 1 alone) by the wrappers, and the whole
  run's again by ``torch.profiler`` in a second run; the first step
  against the same step through the plain versions of rows 1-8
  (``_hold_first_step``); the export reloaded into a fresh model scores the
  validation lists as the live model, bitwise. Then 10 steps each at the
  CLI's defaults (dropout 0.5: the tower unfused), ``--scorer=gam`` and
  ``--group_size=2``."""
  import copy
  import torch
  from ranking_tpu_torch.data import dataset
  from ranking_tpu_torch.data import libsvm
  from ranking_tpu_torch.examples import ranking_libsvm as cli
  from ranking_tpu_torch.train import checkpoint
  from ranking_tpu_torch.train import steps
  out = {}
  paths = {}
  t0 = time.perf_counter()
  for split, lists, seed in (('train', PIPE_TRAIN_LISTS, SEED + 7),
                             ('vali', PIPE_VALID_LISTS, SEED + 8)):
    paths[split] = os.path.join(root, f'{split}.txt')
    libsvm.write_random_lists(paths[split], lists, F, PIPE_MIN_DOCS, L,
                              seed=seed)
  out['write_s'] = time.perf_counter() - t0
  base = [f'--train_path={paths["train"]}', f'--vali_path={paths["vali"]}',
          f'--num_features={F}']
  flagship = base + [
      f'--list_size={L}', f'--batch_size={B}',
      '--hidden_layer_dims=' + ','.join(map(str, HIDDEN)), '--dropout=0',
      '--lambda_ndcg', f'--num_train_steps={EX_LIBSVM_STEPS}',
      f'--eval_every={EX_LIBSVM_STEPS}']
  rec = {'per_step': [], 'events': [], 'evals': []}
  make_train_step, evaluate = steps.make_train_step, cli.evaluate

  def recording(loss_fn, **kwargs):
    step = make_train_step(loss_fn, **kwargs)

    def call(state, batch, generator=None):
      before = _all_launch_counts()
      if not rec['per_step']:
        rec.update(twin=copy.deepcopy(state.model),
                   anchor=copy.deepcopy(state.model), batch=batch,
                   step=step, loss_fn=loss_fn)
        with _recording_tower(state.model) as record:
          state, metrics = step(state, batch, generator)
        rec.update(record=record, loss=metrics['loss'].item())
        rec['grads'], rec['stats'] = _snapshot_first_step(state)
      else:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, batch, generator)
        end.record()
        rec['events'].append((start, end))
      rec['per_step'].append([a - b for a, b in
                              zip(_all_launch_counts(), before)])
      return state, metrics
    return call

  def recording_evaluate(*args):
    before = _all_launch_counts()
    result = evaluate(*args)
    rec['evals'].append([a - b for a, b in zip(_all_launch_counts(),
                                               before)])
    return result

  run_dir = os.path.join(root, 'libsvm')
  _reset_all_launches()
  t0 = time.perf_counter()
  with mock.patch.object(steps, 'make_train_step', recording), \
      mock.patch.object(cli, 'evaluate', recording_evaluate):
    result = cli.main(flagship + [f'--output_dir={run_dir}'])
  torch.cuda.synchronize()
  out['flagship_s'] = time.perf_counter() - t0
  wrappers = steps.kernel_launch_counts()
  per_step = rec['per_step']
  eval_batches = -(-PIPE_VALID_LISTS // B)
  sorts = per_step[0][0]
  if (len(per_step) != EX_LIBSVM_STEPS or sorts < 1
      or any(s != [sorts, 3, 1, 2, 0, 0, 1, 1] for s in per_step)):
    _fail(f'25a: launches per step (sort, rows 2-6, rows 7-8) {per_step}; '
          f'[{sorts} (the same each step), 3, 1, 2, 0, 0, 1, 1] expected')
  if (len(rec['evals']) != 1 or any(rec['evals'][0][1:])
      or rec['evals'][0][0] < eval_batches
      or rec['evals'][0][0] % eval_batches):
    _fail(f'25a: the evaluation of {eval_batches} batches launched '
          f'{rec["evals"]} (sort, rows 2-8)')
  ms = [s.elapsed_time(e) for s, e in rec['events']]
  losses = result['losses']
  vali = result['vali'][EX_LIBSVM_STEPS]
  if not all(math.isfinite(v) for v in losses + list(vali.values())):
    _fail(f'25a: losses {losses}, validation {vali}')
  out.update(
      steps=EX_LIBSVM_STEPS, first_loss=losses[0], last_loss=losses[-1],
      vali=vali, launches=wrappers,
      launches_per_step=dict(zip(
          ('sorted_values_and_ranks', 'layer_forward', 'bwd_stats',
           'bwd_mats', 'bwd_dx_only', 'bwd_dw_only', 'pairwise_sums_forward',
           'pairwise_sums_backward'), per_step[0])),
      sorts_per_eval_batch=rec['evals'][0][0] // eval_batches,
      ms_per_step=statistics.median(ms), ms_per_step_range=[min(ms), max(ms)],
      lists_per_s=B / statistics.median(ms) * 1e3)

  # The first step against rows 1-8 through their plain versions, each
  # step with the CLI's generator as it stands before every step.
  twin, batch = rec['twin'], rec['batch']

  def seeded_step(state, batch):
    return rec['step'](state, batch, torch.Generator('cuda').manual_seed(
        cli.STEP_SEED))

  out['first_step'] = _hold_first_step(
      '25a ranking_libsvm', seeded_step, twin, batch, rec['loss'],
      rec['grads'], rec['stats'], plain_sort=True,
      zero_names=_zero_in_theory(twin, True),
      zero_tol=_zero_tol(twin, rec['loss_fn'], batch),
      anchor=lambda r: _first_step_f64(rec['anchor'], batch, r),
      first_record=rec['record'])

  # The export, reloaded into a fresh model, scores as the live one.
  args = cli.parse_args(flagship + ['--output_dir=unused'])
  reloaded = cli.build_model(args)
  reloaded.load_state_dict(checkpoint.load_params(
      os.path.join(run_dir, 'export')), strict=True)
  reloaded.to('cuda')
  live = result['state'].model
  vali_x, vali_y, _ = libsvm.load_libsvm_lists(paths['vali'], L, F)
  with torch.no_grad():
    for vb in dataset.in_memory_batches(vali_x, vali_y, B, shuffle=False,
                                        drop_remainder=False):
      vb = vb.to('cuda')
      got = reloaded(vb.context, vb.examples, vb.mask, training=False)
      want = live(vb.context, vb.examples, vb.mask, training=False)
      if not torch.equal(got, want):
        _fail('25a: the reloaded export does not score as the live model')
  del rec['twin'], rec['anchor'], reloaded

  # The same run under torch.profiler: each wrapper's kernel on the card.
  _reset_all_launches()
  card = _kernel_counts(lambda: cli.main(
      flagship + [f'--output_dir={run_dir}_profiled']))
  profiled = steps.kernel_launch_counts()
  if profiled != wrappers:
    _fail(f'25a: the profiled run launched {profiled}, the first {wrappers}')
  for name, kernel in _ENTRY_KERNEL.items():
    if wrappers[name] and card.get(kernel, 0) != wrappers[name]:
      _fail(f'25a: {kernel} ran {card.get(kernel, 0)} times on the card; '
            f'its wrapper {name} launched {wrappers[name]}')
  out['launches_card'] = {n: card.get(k, 0) for n, k in _ENTRY_KERNEL.items()
                          if wrappers[n]}
  _log(f'25a ranking_libsvm: {EX_LIBSVM_STEPS} steps at B={B}, L={L}, '
       f'F={F}, {HIDDEN}, dropout 0, pairwise logistic + NDCG lambda weight: '
       f'loss {losses[0]:.4f} -> {losses[-1]:.4f}, vali {vali}; launches a '
       f'step {out["launches_per_step"]}, {out["sorts_per_eval_batch"]} '
       f'sorts an eval batch; card == wrappers {out["launches_card"]}; '
       f'{out["ms_per_step"]:.3f} ms a step (eager, CUDA events, median of '
       f'{len(ms)}), {out["lists_per_s"]:.0f} lists/s; export == live '
       f'bitwise; run {out["flagship_s"]:.1f} s')

  # At the CLI's defaults (dropout 0.5), then GAM, then groupwise.
  for name, extra in (('defaults', []), ('gam', ['--scorer=gam']),
                      ('groupwise', ['--group_size=2'])):
    _reset_all_launches()
    t0 = time.perf_counter()
    res = cli.main(base + [f'--num_train_steps={EX_DEFAULT_STEPS}',
                           f'--output_dir={root}/libsvm_{name}'] + extra)
    launched = steps.kernel_launch_counts()
    seconds = time.perf_counter() - t0
    if (len(res['losses']) != EX_DEFAULT_STEPS
        or not all(math.isfinite(v) for v in res['losses'])
        or launched['pairwise_sums_forward'] != EX_DEFAULT_STEPS
        or launched['pairwise_sums_backward'] != EX_DEFAULT_STEPS
        or not launched['sorted_values_and_ranks']):
      _fail(f'25a {name}: losses {res["losses"]}, launches {launched}')
    if any(launched[k] for k in (
        'layer_forward', 'bwd_stats', 'bwd_mats', 'bwd_dx_only',
        'bwd_dw_only')):
      _fail(f'25a {name}: the unfused tower launched {launched}')
    out[name] = {'s': seconds, 'steps': EX_DEFAULT_STEPS,
                 'losses': [res['losses'][0], res['losses'][-1]],
                 'vali': res['vali'][EX_DEFAULT_STEPS], 'launches': launched}
    _log(f'25a ranking_libsvm {name}: {EX_DEFAULT_STEPS} steps, loss '
         f'{res["losses"][0]:.4f} -> {res["losses"][-1]:.4f}, launches '
         f'{launched}, {seconds:.1f} s')
  return out


def _program(name, launches, run):
  """Runs one example program (``run`` calls its ``main``) with every
  launch count set to 0 just before it, and reads the wrappers' counts just
  after it, before any check or reference of the caller runs: the
  program's own launches go to ``launches[name]``. Returns (its result,
  its seconds)."""
  import torch
  from ranking_tpu_torch.train import steps
  _reset_all_launches()
  t0 = time.perf_counter()
  result = run()
  torch.cuda.synchronize()
  seconds = time.perf_counter() - t0
  launches[name] = steps.kernel_launch_counts()
  return result, seconds


def _examples_trec(root, launches):
  """25b: ``trec_eval`` over phase 19's TREC files (2,000 queries): its
  JSON equals ``trec.evaluate_run`` on the card, and row 1 ran."""
  import contextlib
  import io
  from ranking_tpu_torch.data import trec
  from ranking_tpu_torch.examples import trec_eval as cli
  qrels, run = _write_trec_files(root)
  want = trec.evaluate_run(qrels, run, TREC_SPEC, batch_size=B,
                           device='cuda')
  text = io.StringIO()
  with contextlib.redirect_stdout(text):
    got, seconds = _program('trec_eval', launches, lambda: cli.main([
        f'--qrels={qrels}', f'--run={run}', f'--metrics={TREC_SPEC}',
        f'--batch_size={B}']))
  sorts = launches['trec_eval']['sorted_values_and_ranks']
  printed = json.loads(text.getvalue().strip().splitlines()[-1])
  if printed != got or got != want or not sorts:
    _fail(f'25b trec_eval: printed {printed}, returned {got}, evaluate_run '
          f'{want}; sort launches {sorts}')
  _log(f'25b trec_eval: {TREC_QUERIES} queries, {len(got)} metrics == '
       f'evaluate_run; {sorts} sort launches; {seconds:.2f} s')
  return {'s': seconds, 'queries': TREC_QUERIES, 'metrics': len(got),
          'sort_launches': sorts}


def _examples_serve(root, launches):
  """25c: the ELWC CLI at its defaults over phase 18's token records, then
  ``serve_predict`` over its export with ``--artifact_path
  --quantize=int8``: the CSV's scores against ``Predictor.predict`` at
  phase 4's tolerance, the int8 artifact (``load_predictor`` on the card)
  within ``INT8_TOL`` of the largest float score."""
  import csv
  import numpy as np
  from ranking_tpu_torch.data import tfrecord
  from ranking_tpu_torch.examples import ranking_elwc_pipeline as elwc_cli
  from ranking_tpu_torch.examples import serve_predict as cli
  from ranking_tpu_torch.pipeline import export as export_lib
  from ranking_tpu_torch.pipeline import serving
  out = {}
  train = os.path.join(root, 'tokens-train.tfrecord')
  vali = os.path.join(root, 'tokens-vali.tfrecord')
  tfrecord.write_records(train, _token_records(SEED + 31, TOKEN_LISTS))
  tfrecord.write_records(vali, _token_records(SEED + 32, SPARSE_B))
  (pipe, history), out['elwc_s'] = _program(
      'elwc_pipeline', launches, lambda: elwc_cli.main([
          f'--train_pattern={train}', f'--valid_pattern={vali}',
          f'--model_dir={root}/elwc']))
  if pipe._multi_step.captures != 1 or not all(
      math.isfinite(v) for v in history.values()):
    _fail(f'25c ELWC CLI: {pipe._multi_step.captures} captures, {history}')
  export = os.path.join(root, 'elwc', 'export', 'latest')
  artifact = os.path.join(root, 'artifact_int8')
  scores_csv = os.path.join(root, 'scores.csv')
  predictor, out['serve_s'] = _program(
      'serve_predict', launches, lambda: cli.main([
          f'--export_path={export}', f'--input={vali}',
          f'--output={scores_csv}', f'--artifact_path={artifact}',
          '--quantize=int8']))
  records = tfrecord.read_all_records(vali)
  args = cli.parse_args([f'--export_path={export}', f'--input={vali}'])
  live = serving.Predictor.from_export(
      cli.build_model(args), export, predictor.context_feature_spec,
      predictor.example_feature_spec, list_size=args.list_size,
      device='cuda').predict(records)
  with open(scores_csv) as f:
    rows = list(csv.reader(f))[1:]
  got = np.array([float(r[3]) for r in rows])
  want = np.array([live[int(r[0]), int(r[1])] for r in rows])
  scale = float(np.abs(want).max())
  csv_err = float(np.abs(got - want).max())
  if len(rows) == 0 or not np.allclose(got, want, rtol=1e-4,
                                       atol=1e-4 * scale):
    _fail(f'25c serve_predict: the CSV scores differ from predict by '
          f'{csv_err} (largest score {scale})')
  quantized = export_lib.load_predictor(artifact, device='cuda').predict(
      records)
  int8 = np.array([quantized[int(r[0]), int(r[1])] for r in rows])
  int8_err = float(np.abs(int8 - want).max())
  if int8_err > INT8_TOL * scale:
    _fail(f'25c serve_predict: the int8 artifact is {int8_err} off, more '
          f'than {INT8_TOL} of the largest float score {scale}')
  out.update(rows=len(rows), csv_max_abs_diff=csv_err,
             int8_max_abs_diff=int8_err, largest_score=scale,
             elwc_history=history)
  _log(f'25c: the ELWC CLI at its defaults ({out["elwc_s"]:.1f} s), then '
       f'serve_predict of {len(records)} lists, {len(rows)} CSV rows within '
       f'{csv_err:.3g} of predict; int8 artifact within {int8_err:.3g} '
       f'(largest score {scale:.3g}); {out["serve_s"]:.1f} s')
  return out


def _examples_pipeline(what, pipe, history, seconds, one_capture=True):
  """Finite metrics, one capture a run (with ``one_capture``), the graphed
  eval == eager."""
  import itertools
  import types
  if (one_capture and pipe._multi_step.captures != 1) or not all(
      math.isfinite(v) for v in history.values()):
    _fail(f'{what}: {pipe._multi_step.captures} captures, {history}')
  # The validation pass reads the first validation_steps batches.
  builder = types.SimpleNamespace(valid_batches=lambda: itertools.islice(
      pipe.dataset_builder.valid_batches(), pipe.hparams.validation_steps))
  _hold_graphed_eval(what, pipe, builder, history)
  return {'s': seconds, 'steps': pipe.final_state.step,
          'captures': pipe._multi_step.captures, 'history': history,
          'launches_per_step': dict(pipe._multi_step.captured_launches)}


def _examples_elwc_clis(root, launches):
  """25d-f over phase 22's DIN records: ``antique_din`` at its defaults and
  with ``--dasalc``, ``multitask_ranking`` at its defaults, and
  ``encoder_ranking`` at phase 23's BERT-base profile with ``--remat``,
  then with ``--warm_start_dir`` of its own export (the warm-started model
  equals the export bitwise) and with ``--optimizer=lazy_adam`` (the
  dense-gradient lazy update, as in the JAX package: row 10 not
  launched)."""
  import torch
  from ranking_tpu_torch.data import tfrecord
  from ranking_tpu_torch.examples import antique_din
  from ranking_tpu_torch.examples import encoder_ranking
  from ranking_tpu_torch.examples import multitask_ranking
  from ranking_tpu_torch.train import checkpoint
  out = {}
  for split, lists, seed in (('train', DIN_TRAIN_LISTS, SEED + 54),
                             ('vali', DIN_VALID_LISTS, SEED + 55)):
    tfrecord.write_records(os.path.join(root, f'din-{split}.tfrecord'),
                           _din_records(seed, lists))
  data = [f'--train_pattern={root}/din-train.tfrecord',
          f'--valid_pattern={root}/din-vali.tfrecord']

  for name, cli, extra in (
      ('din', antique_din, []), ('dasalc', antique_din, ['--dasalc']),
      ('multitask', multitask_ranking, [])):
    (pipe, history), seconds = _program(name, launches, lambda: cli.main(
        data + [f'--model_dir={root}/{name}'] + extra))
    out[name] = _examples_pipeline(f'25 {name}', pipe, history, seconds)
    if name == 'multitask' and 'relevance/ndcg@5' not in history:
      _fail(f'25e multitask: no task/ndcg@k suite in {sorted(history)}')
    _log(f'25 {name}: {out[name]["steps"]} steps, one capture, graphed eval '
         f'== eager, {out[name]["s"]:.1f} s; {history}')
    del pipe

  bert = data + [f'--hidden_dim={ENC_HIDDEN}', f'--num_heads={ENC_HEADS}',
                 f'--num_layers={ENC_LAYERS}', f'--seq_len={ENC_T}']
  first_dir = os.path.join(root, 'encoder')
  (pipe, history), seconds = _program(
      'encoder', launches, lambda: encoder_ranking.main(
          bert + ['--remat', f'--model_dir={first_dir}']))
  out['encoder'] = _examples_pipeline('25f encoder --remat', pipe, history,
                                      seconds, one_capture=False)
  del pipe
  export_dir = os.path.join(first_dir, 'export', 'latest')
  warm = bert + [f'--warm_start_dir={export_dir}']
  started, _ = encoder_ranking.build_model(encoder_ranking.parse_args(warm))
  export = checkpoint.load_params(export_dir)
  if sorted(export) != sorted(started.state_dict()) or any(
      not torch.equal(v, export[k]) for k, v in started.state_dict().items()):
    _fail('25f: the warm-started model is not its export')
  del started
  (pipe, history), seconds = _program(
      'encoder_warm', launches, lambda: encoder_ranking.main(
          warm + [f'--model_dir={root}/warm']))
  out['encoder_warm'] = _examples_pipeline(
      '25f encoder --warm_start_dir', pipe, history, seconds,
      one_capture=False)
  del pipe
  (pipe, history), seconds = _program(
      'encoder_lazy_adam', launches, lambda: encoder_ranking.main(
          bert + ['--optimizer=lazy_adam', f'--model_dir={root}/lazy']))
  out['encoder_lazy_adam'] = _examples_pipeline(
      '25f encoder --optimizer=lazy_adam', pipe, history, seconds,
      one_capture=False)
  # The encoder's position table is a lazy table that no batch feature
  # names, so the pipeline, as the JAX package's
  # (ranking_tpu/pipeline/pipeline.py:335-345), takes the plain step with
  # the dense-gradient lazy update, whose row writes are plain index copies
  # (phase 22d): row 10 has no launch on this path.
  state = pipe.final_state
  lazy = out['encoder_lazy_adam']
  lazy['lazy_count'] = int(state.sparse_opt_state['count'])
  if (lazy['launches_per_step'].get('scatter_rows_multi', 0) != 0
      or launches['encoder_lazy_adam']['scatter_rows_multi'] != 0
      or lazy['lazy_count'] != state.step):
    _fail(f'25f lazy_adam: launches a step {lazy["launches_per_step"]}, '
          f'{lazy["lazy_count"]} lazy updates in {state.step} steps')
  del pipe, state
  _log(f'25f encoder_ranking at {ENC_LAYERS} x {ENC_HIDDEN}, {ENC_HEADS} '
       f'heads, T={ENC_T}: --remat {out["encoder"]["s"]:.1f} s, warm start '
       f'== export bitwise, {out["encoder_warm"]["s"]:.1f} s, lazy_adam '
       f'(the dense-gradient lazy update, {lazy["lazy_count"]} updates) '
       f'{out["encoder_lazy_adam"]["s"]:.1f} s')
  return out


def _examples_two_tower(launches):
  """25g: ``unbiased_two_tower`` as the JAX package's test runs it: the
  two-tower model debiases (true NDCG@5 above the naive click model's by
  ``EX_DEBIAS_MARGIN``)."""
  from ranking_tpu_torch.examples import unbiased_two_tower as cli
  (naive, debiased), seconds = _program(
      'unbiased_two_tower', launches, lambda: cli.main([
          '--queries=1500', '--steps=400', '--list_size=15', '--eta=1.5']))
  if not debiased > naive + EX_DEBIAS_MARGIN:
    _fail(f'25g unbiased_two_tower: debiased {debiased} vs naive {naive}')
  _log(f'25g unbiased_two_tower: true NDCG@5 naive {naive:.4f}, debiased '
       f'{debiased:.4f}; {seconds:.1f} s for 2 x 400 steps')
  return {'s': seconds, 'steps': 800, 'naive': naive, 'debiased': debiased}


# The kernels each program of 25b-g must launch in its own run (row 1: the
# sort of every metric), and serve_predict, whose path is the eval forward
# alone, none.
EX_PROGRAM_KERNELS = {
    'trec_eval': ('sorted_values_and_ranks',),
    'elwc_pipeline': ('sorted_values_and_ranks',),
    'serve_predict': (),
    'din': ('sorted_values_and_ranks',),
    'dasalc': ('sorted_values_and_ranks',),
    'multitask': ('sorted_values_and_ranks',),
    'encoder': ('sorted_values_and_ranks',),
    'encoder_warm': ('sorted_values_and_ranks',),
    'encoder_lazy_adam': ('sorted_values_and_ranks',),
    'unbiased_two_tower': ('sorted_values_and_ranks',),
}


def _examples_phase():
  """Phase 25: the example programs on the card. Returns (numbers, and the
  wrappers' launches of each program of 25b-g in its own run: program ->
  wrapper name -> count)."""
  import shutil
  root = _examples_root()
  shutil.rmtree(root, ignore_errors=True)
  os.makedirs(root)
  launches = {}
  t0 = time.perf_counter()
  try:
    out = {'libsvm': _examples_libsvm(root)}
    out['trec_eval'] = _examples_trec(root, launches)
    out['serve_predict'] = _examples_serve(root, launches)
    out.update(_examples_elwc_clis(root, launches))
    out['unbiased_two_tower'] = _examples_two_tower(launches)
  finally:
    shutil.rmtree(root, ignore_errors=True)
  out['phase_s'] = time.perf_counter() - t0
  out['card'] = _card_line()
  if sorted(launches) != sorted(EX_PROGRAM_KERNELS):
    _fail(f'phase 25: programs run {sorted(launches)}, expected '
          f'{sorted(EX_PROGRAM_KERNELS)}')
  for program, counts in launches.items():
    must = EX_PROGRAM_KERNELS[program]
    if any(counts[n] == 0 for n in must) or (
        not must and any(counts.values())):
      _fail(f'phase 25 {program}: launched {counts} in its own run; '
            f'expected {list(must) or "none"}')
  _log('phase 25: ' + f'{out["phase_s"]:.1f} s; launches of each program '
       'of 25b-g in its own run: ' + '; '.join(
           f'{p} ' + str({n: c for n, c in counts.items() if c})
           for p, counts in launches.items()))
  return out, launches


def main():
  import torch
  if not torch.cuda.is_available():
    print('chip_smoke: CUDA is not available; this script runs on the card',
          file=sys.stderr)
    return 1
  global _LOG_FILE
  os.makedirs('chiprun_out', exist_ok=True)
  _LOG_FILE = open(os.path.join('chiprun_out', 'chip_smoke.log'), 'w')
  from ranking_tpu_torch.data import dataset
  from ranking_tpu_torch.models import layers
  from ranking_tpu_torch.ops.cuda import build
  from ranking_tpu_torch.ops.cuda import fused_bn
  from ranking_tpu_torch.ops.cuda import pairwise
  from ranking_tpu_torch.ops.cuda import rows
  from ranking_tpu_torch.ops.cuda import sort as cuda_sort
  from ranking_tpu_torch.pipeline import serving
  from ranking_tpu_torch.train import steps
  from ranking_tpu_torch.utils import list_ops

  # Phase 1: device. Full float32 matmuls: the serve check is at 1e-4.
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device('cuda')
  card = _card_line()
  kind = torch.cuda.get_device_name(0)
  _log(f'device: {kind} ({torch.cuda.device_count()} visible), torch '
       f'{torch.__version__}, CUDA {torch.version.cuda}')

  # Phase 2: build, one nvcc per source, side by side.
  t0 = time.perf_counter()
  sources = ['sort', 'fused_bn_fwd', 'fused_bn_bwd', 'pairwise', 'rows']
  build.compile_libraries(sources)
  cuda_sort._kernel()
  fused_bn.build_kernels()
  pairwise.build_kernels()
  rows.build_kernels()
  build_s = time.perf_counter() - t0
  _log(f'build: {len(sources)} kernel sources in {build_s:.2f} s ('
       + ', '.join(f'{k} {v:.1f} s' for k, v in build.BUILD_SECONDS.items())
       + ')')
  # Proof that the fused tower's products run on the tensor cores: the
  # `wgmma` instructions (HGMMA in the machine code) of each library, and
  # its kernels' registers and spills from ptxas.
  hgmma = {}
  for source in ('fused_bn_fwd', 'fused_bn_bwd'):
    path = build.library_path(source)
    hgmma[source] = _sass_count(path, 'HGMMA')
    if hgmma[source] == 0:
      _fail(f'{source}: no HGMMA instruction in {path}')
    _log(f'{source}: {hgmma[source]} HGMMA instructions; ptxas: '
         + _ptxas_summary(path))

  if '--scorers-only' in sys.argv[1:]:
    _reset_all_launches()
    numbers = _scorers_phase(None)
    numbers['launches'] = steps.kernel_launch_counts()
    numbers['times'] = _time_scorer_kernels()
    line = json.dumps({'scorers': numbers, 'card': card})
    os.makedirs('chiprun_out', exist_ok=True)
    with open(os.path.join('chiprun_out', 'scorers.json'), 'w') as f:
      f.write(line + '\n')
    print(line)
    return 0

  if '--encoder-only' in sys.argv[1:]:
    _reset_all_launches()
    numbers, per_step = _encoder_phase()
    numbers['launches'] = steps.kernel_launch_counts()
    numbers['launches_per_step'] = per_step
    line = json.dumps({'encoder': numbers, 'card': card})
    os.makedirs('chiprun_out', exist_ok=True)
    with open(os.path.join('chiprun_out', 'encoder.json'), 'w') as f:
      f.write(line + '\n')
    print(line)
    return 0

  if '--dist-only' in sys.argv[1:]:
    numbers, launches = _dist_phase()
    line = json.dumps({'dist': numbers, 'launches': launches, 'card': card})
    os.makedirs('chiprun_out', exist_ok=True)
    with open(os.path.join('chiprun_out', 'dist.json'), 'w') as f:
      f.write(line + '\n')
    print(line)
    return 0

  if '--examples-only' in sys.argv[1:]:
    numbers, launches = _examples_phase()
    line = json.dumps({'examples': numbers, 'launches': launches,
                       'card': card})
    os.makedirs('chiprun_out', exist_ok=True)
    with open(os.path.join('chiprun_out', 'examples.json'), 'w') as f:
      f.write(line + '\n')
    print(line)
    return 0

  if '--anchor-seeds' in sys.argv[1:]:
    seeds = int(sys.argv[sys.argv.index('--anchor-seeds') + 1])
    sweep, failures = _anchor_sweep(seeds)
    line = json.dumps({'anchor_sweep': sweep, 'failures': failures,
                       'card': card})
    os.makedirs('chiprun_out', exist_ok=True)
    with open(os.path.join('chiprun_out', 'anchor_sweep.json'), 'w') as f:
      f.write(line + '\n')
    print(line)
    return 1 if failures else 0

  # Phase 3: kernel vs plain on the card, bitwise.
  gen = torch.Generator().manual_seed(SEED)
  cases = [(f'flagship_top{n}', B, L, 2, n, 'random') for n in (1, 5, 10, L)]
  cases += [('ties', B, L, 2, L, 'ties'),
            ('all_invalid_and_neg_inf', 4, L, 2, L, 'special'),
            ('list_size_37', 3, 37, 3, 10, 'random'),
            ('top_of_domain', 2, cuda_sort.MAX_LIST_SIZE, 2, 100, 'ties'),
            ('batch_1', 1, L, 2, L, 'random')]
  # The key layout's edges: a warp's width and one off it, a 4-key chunk
  # and its padding, each count of threads an item; topn 1 and L; the
  # single-channel and the unpaired (K != 2) scatter.
  # Drawn from a generator of their own, so that later phases keep their
  # inputs.
  cases += [(f'list_size_{l}_k{k}_top{n}', 5, l, k, n, 'edges')
            for l in (1, 31, 32, 33, 257) for k in (1, 3)
            for n in sorted({1, l})]
  # The ideal-DCG sort of a Gumbel loss (phase 21): B x 8 sampled lists of
  # tied graded labels, one channel.
  cases += [('gumbel_lists', B * 8, L, 1, L, 'gumbel')]
  edge_gen = torch.Generator().manual_seed(SEED + 1)
  case_gens = {'edges': edge_gen,
               'gumbel': torch.Generator().manual_seed(SEED + 30)}
  max_abs_err = 0.0
  for name, b, l, k, topn, data in cases:
    scores, mask, values = (t.to(dev) for t in _sort_case(
        case_gens.get(data, gen), b, l, k,
        'ties' if data == 'gumbel' else data))
    got_sorted, got_ranks = cuda_sort.sorted_values_and_ranks(
        scores, values, mask, topn)
    want_sorted, want_ranks = cuda_sort.sorted_values_and_ranks_reference(
        scores, values, mask, topn)
    torch.cuda.synchronize()
    for got, want in ((got_sorted, want_sorted), (got_ranks, want_ranks)):
      if got.shape != want.shape:
        _fail(f'sort case {name}: shape {tuple(got.shape)} != '
              f'{tuple(want.shape)}')
      err = (got - want).abs().nan_to_num(nan=math.inf).max().item()
      max_abs_err = max(max_abs_err, err)
      if not torch.equal(got, want):
        _fail(f'sort case {name}: kernel != plain version (max |diff| '
              f'{err})')
    _log(f'kernel vs plain: {name} (B={b}, L={l}, K={k}, topn={topn}) equal')

  # Phase 3b, 3c: the fused masked-BN functions and the whole op.
  fused_errs = _check_fused_kernels(gen)
  _check_fused_op(gen)

  # Phase 3d, 3e: the fused pairwise sums and the whole pairwise loss.
  pair_errs = _check_pairwise_kernels(gen)
  _check_pairwise_op(gen)

  # Phase 3f: the row scatter, bitwise.
  rows_cases, rows_phase_launches, rows_err = _check_rows_kernels()

  # Phase 4: the main path. Counts start at 0 here.
  model = _flagship_model(gen)
  requests = [_make_batch(gen, b, min_len=1) for b in (1, 7, B)]
  eval_batches = [dataset.flatten_examples(_make_batch(gen, B))
                  for _ in range(EVAL_BATCHES)]
  fns = _metric_fns()
  made = []

  class _Recorded(steps.GraphedEvalStep):
    def __init__(self, *args, **kwargs):
      super().__init__(*args, **kwargs)
      made.append(self)

  cuda_sort.sorted_values_and_ranks.launches = 0
  predictor = serving.Predictor(model, device='cuda')
  served = [predictor.score_batch(r) for r in requests]
  result = {}
  with mock.patch.object(steps, 'GraphedEvalStep', _Recorded):
    eval_device = _kernel_counts(lambda: result.update(
        metrics=serving.evaluate_dataset(predictor.model, None,
                                         eval_batches, metric_fns=fns,
                                         device='cuda')))
  results = result['metrics']
  launches = cuda_sort.sorted_values_and_ranks.launches
  if launches == 0:
    _fail('the eval path never launched the sort kernel')
  # The eval runs as one eager step, a capture and replays: the wrapper
  # counts the eager step and the capture; the card runs the eager step
  # and every replay, which torch.profiler's device events count.
  graphed = made[0]
  if graphed.captures != 1 or graphed.replays != EVAL_BATCHES - 1:
    _fail(f'evaluate_dataset: {graphed.captures} captures, '
          f'{graphed.replays} replays of its eval step')
  card_launches = eval_device.get('rank_sort_kernel', 0)
  expected = (launches + graphed.replayed_launches().get(
      'sorted_values_and_ranks', 0) - graphed.captured_launches().get(
          'sorted_values_and_ranks', 0))
  if card_launches != expected:
    _fail(f'evaluate_dataset: rank_sort_kernel ran {card_launches} times on '
          f'the card; the wrapper counted {launches} (the eager step and the '
          f'capture) and the graph replayed {graphed.replays} times: '
          f'{expected}')
  _log(f'main path: served {[r.batch_size for r in requests]} lists, '
       f'evaluated {EVAL_BATCHES} x {B} lists (1 eager step, 1 capture, '
       f'{graphed.replays} replays); sort kernel launches {launches} as the '
       f'wrapper counts them, {card_launches} on the card by torch.profiler '
       f'({card_launches / EVAL_BATCHES:g} per eval step), as the eager step '
       'plus the capture\'s launches times the replays')

  for req, got in zip(requests, served):
    got = torch.from_numpy(got)
    if got.shape != req.mask.shape or not torch.isfinite(got).all():
      _fail(f'serve B={req.batch_size}: bad scores shape/finiteness')
    if not torch.all(got[~req.mask] == torch.tensor(layers.PADDING_LOGIT)):
      _fail(f'serve B={req.batch_size}: padded slots != log(1e-10)')
    want = _scores_f64(model, req)
    scale = want[req.mask].abs().max().item()
    err = (got.double() - want)[req.mask].abs().max().item()
    if not torch.allclose(got.double(), want, rtol=1e-4, atol=1e-4 * scale):
      _fail(f'serve B={req.batch_size}: max |diff| {err} vs float64 '
            f'(largest score {scale})')
    _log(f'serve B={req.batch_size}: max |diff| vs float64 {err:.3g} '
         f'(largest score {scale:.3g})')

  # Phase 5: eval checks.
  for name, value in results.items():
    if not 0.0 <= value <= 1.0:
      _fail(f'eval {name} = {value} outside [0, 1]')
  with mock.patch.object(list_ops, '_kernel_sort_ok', return_value=False):
    before = cuda_sort.sorted_values_and_ranks.launches
    plain = serving.evaluate_dataset(predictor.model, None, eval_batches,
                                     metric_fns=fns, device='cuda')
    if cuda_sort.sorted_values_and_ranks.launches != before:
      _fail('the plain-sort evaluation launched the kernel')
  for name in results:
    if abs(results[name] - plain[name]) > 1e-6:
      _fail(f'eval {name}: kernel {results[name]} vs plain sort '
            f'{plain[name]}')
  _log('eval: ' + ', '.join(f'{k} {v:.6f}' for k, v in results.items())
       + ' (plain sort on the card agrees within 1e-6)')

  step = steps.make_eval_step(fns, device='cuda')
  tail = _make_batch(gen, 100)
  padded_states, _ = step(predictor.model,
                          dataset.flatten_examples(tail.pad_to(B)),
                          steps.init_metric_states(fns), num_valid_rows=100)
  tail_states, _ = step(predictor.model, tail, steps.init_metric_states(fns))
  for name in fns:
    a = padded_states[name].result().item()
    e = tail_states[name].result().item()
    if abs(a - e) > 1e-6:
      _fail(f'padded eval {name}: {a} vs unpadded {e}')
  _log('eval: 100 lists padded to 128 with num_valid_rows=100 == unpadded')

  # Phase 6: times at the flagship shape.
  scores, mask, values = (t.to(dev) for t in _sort_case(gen, B, L, 2,
                                                        'random'))
  idx_shape = (B, L, 2)

  def library_call():
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    return torch.gather(values, 1, order[:, :, None].expand(idx_shape))

  sort_calls = {
      'kernel': lambda: cuda_sort.sorted_values_and_ranks(scores, values,
                                                          mask, L),
      'plain': lambda: cuda_sort.sorted_values_and_ranks_reference(
          scores, values, mask, L),
      'library': library_call}
  # Device time from graph replays; eager time per call as the main path
  # pays it, host overhead included.
  sort_ms = {k: _graph_ms(fn) for k, fn in sort_calls.items()}
  sort_eager_ms = {k: _event_ms(fn, 100) for k, fn in sort_calls.items()}
  kernel_ms, plain_ms, library_ms = (sort_ms[k] for k in
                                     ('kernel', 'plain', 'library'))
  # Bound: each input read once, each output written once, over HBM; the
  # B*L*L pair comparisons over the float32 rate. Bytes win at this shape.
  sort_bytes = B * L * (4 + 1 + 2 * 4) + B * L * 4 + B * L * 2 * 4
  bytes_ms = sort_bytes / HBM_BYTES_PER_S * 1e3
  ops_ms = B * L * L / F32_OPS_PER_S * 1e3
  bound_ms, bound_by = max((bytes_ms, 'bytes'), (ops_ms, 'operations'))

  dev_batch = eval_batches[0].to(dev)
  states = steps.init_metric_states(fns)
  eval_step_ms = _host_ms(lambda: step(predictor.model, dev_batch, states),
                          50)
  restored = steps.restore_flat_examples(dev_batch)
  with torch.no_grad():
    forward_ms = _host_ms(lambda: predictor.model(
        restored.context, restored.examples, restored.mask), 50)
  serve_ms = _host_ms(lambda: predictor.score_batch(requests[-1]), 30)
  # Phases 7-9: training, the second path, and their times.
  train_counts, state, train_step, train_batch = _train_main_path(
      gen, eval_batches, fns)
  second_counts = _second_path(gen)
  fused_times = _time_fused(gen)
  train_times, train_fn = _time_train_step(state, train_step, train_batch,
                                           fused_bn)
  # Phases 10-12: the LambdaRank path, long lists, and their times.
  rank_counts, rank_state, rank_step, rank_batch = _lambdarank_main_path(
      gen, eval_batches, fns)
  long_list_memory = _long_list_step(gen)
  pair_times = _time_pairwise(gen)
  rank_times, rank_fn = _time_train_step(rank_state, rank_step, rank_batch,
                                         pairwise, prefix='lambdarank')
  # Phases 13-15: the sparse step, recipes A and B, and their times.
  sparse_counts, sparse_state, sparse_step, sparse_batch, sparse_a = (
      _sparse_path(gen, 'A'))
  adagrad_counts, adagrad_state, _, _, sparse_b = _sparse_path(gen, 'B')
  del adagrad_state
  torch.cuda.empty_cache()
  rows_times = _time_rows()
  sparse_times, sparse_fn = _time_train_step(
      sparse_state, sparse_step, sparse_batch, rows, prefix='sparse')
  compact_unique_ms = _time_compact_unique(sparse_batch)
  # Phase 16: K steps a dispatch, one captured step replayed.
  kstep = _kstep_phase(gen)
  # Phase 17: the pipeline end to end. Counts start at 0 here.
  _reset_all_launches()
  pipeline_numbers, pipeline_launches, pipeline_device = _pipeline_phase(gen)
  for name in ('sorted_values_and_ranks', 'layer_forward', 'bwd_stats',
               'bwd_mats'):
    if pipeline_launches[name] == 0 or pipeline_device[name] == 0:
      _fail(f'the pipeline never launched {name}')
  # Phase 18: the ELWC path; its flagship runs and its token run each start
  # from counts of 0.
  (elwc_numbers, elwc_launches, elwc_device, token_launches,
   token_device) = _elwc_phase(gen)
  for name in ('sorted_values_and_ranks', 'layer_forward', 'bwd_stats',
               'bwd_mats'):
    if elwc_launches[name] == 0 or elwc_device[name] == 0:
      _fail(f'the ELWC pipeline never launched {name}')
  if (token_launches['scatter_rows_multi'] == 0
      or token_device['scatter_rows_multi'] == 0):
    _fail('the ELWC token run never launched scatter_rows_multi')
  # Phase 19: evaluation and the serving artifact; the sort's launches by
  # the whole suite, eager and graphed, start from 0 here.
  cuda_sort.sorted_values_and_ranks.launches = 0
  eval_numbers = _eval_phase(gen, predictor.model, eval_batches)
  eval_launches = cuda_sort.sorted_values_and_ranks.launches
  if eval_launches == 0:
    _fail('the evaluation phase never launched the sort kernel')
  # Phase 21: the loss zoo and multi-task training; counts from 0 here.
  _reset_all_launches()
  (zoo_numbers, zoo_per_step, zoo_approx_wrappers, zoo_approx_card,
   zoo_mt_wrappers) = _zoo_phase()
  zoo_launches = steps.kernel_launch_counts()
  for name in ('sorted_values_and_ranks', 'layer_forward', 'bwd_stats',
               'bwd_mats', 'pairwise_sums_forward', 'pairwise_sums_backward'):
    if zoo_launches[name] == 0:
      _fail(f'the loss zoo phase never launched {name}')
  # Phase 22: the other scorers, Bilinear and the dense-gradient lazy
  # update; counts from 0 here, read before the timings of 22f.
  _reset_all_launches()
  scorer_numbers = _scorers_phase(kstep['sparse_a']['graph_ms_per_step'])
  scorer_launches = steps.kernel_launch_counts()
  for name in ('sorted_values_and_ranks', 'layer_forward', 'bwd_stats',
               'bwd_mats', 'bwd_dx_only', 'pairwise_sums_forward',
               'pairwise_sums_backward'):
    if scorer_launches[name] == 0:
      _fail(f'the scorers phase never launched {name}')
  scorer_numbers['times'] = _time_scorer_kernels()
  # Phase 23: the transformer encoder family; counts from 0 here.
  _reset_all_launches()
  encoder_numbers, encoder_per_step = _encoder_phase()
  encoder_launches = steps.kernel_launch_counts()
  for name in ('sorted_values_and_ranks', 'scatter_rows_multi'):
    if encoder_launches[name] == 0:
      _fail(f'the encoder phase never launched {name}')
  # Phase 24: distribution; each sub-phase and rank counts from 0.
  dist_numbers, dist_launches = _dist_phase()
  for name in ('layer_forward', 'bwd_stats', 'bwd_mats',
               'sorted_values_and_ranks'):
    if not all(r[name] for r in dist_launches['b']):
      _fail(f'phase 24b: a rank never launched {name}')
  if not all(r['scatter_rows_multi'] for r in dist_launches['c']):
    _fail('phase 24c: a rank never launched scatter_rows_multi')
  # Phase 25: the example programs; 25a's flagship run and each program
  # of 25b-g count from 0.
  examples_numbers, examples_launches = _examples_phase()
  examples_libsvm = examples_numbers['libsvm']
  for name in ('sorted_values_and_ranks', 'layer_forward', 'bwd_stats',
               'bwd_mats', 'pairwise_sums_forward', 'pairwise_sums_backward'):
    if examples_libsvm['launches'][name] == 0:
      _fail(f'phase 25a: ranking_libsvm never launched {name}')
  scorer_per_step = {
      'gam': scorer_numbers['gam']['graph']['launches_per_step'],
      'groupwise': scorer_numbers['groupwise']['graph']['launches_per_step'],
      'din_first_step': scorer_numbers['din']['first_step_launches'],
      'din_pipeline': scorer_numbers['din']['pipeline']['launches_per_step'],
      'lazy_dense': scorer_numbers['lazy_dense']['graph'][
          'launches_per_step']}
  timings = {
      'build_s': build_s, 'hgmma': hgmma,
      'fused': fused_times, **train_times,
      'pairwise': pair_times, **rank_times, **long_list_memory,
      'rows': rows_times, **sparse_times,
      'compact_unique_ms': compact_unique_ms,
      'sparse_recipe_a': sparse_a, 'sparse_recipe_b': sparse_b,
      'sort_kernel_ms': kernel_ms, 'sort_plain_ms': plain_ms,
      'sort_library_ms': library_ms, 'sort_bound_ms': bound_ms,
      'sort_eager_ms': sort_eager_ms,
      'sort_launches_per_eval_step': launches / EVAL_BATCHES,
      'eval_step_ms': eval_step_ms,
      'eval_lists_per_s': B / eval_step_ms * 1e3,
      'eval_forward_ms': forward_ms, 'serve_b128_ms': serve_ms,
      'kstep': kstep, 'pipeline': pipeline_numbers, 'elwc': elwc_numbers,
      'eval': eval_numbers, 'zoo': zoo_numbers, 'scorers': scorer_numbers,
      'encoder': encoder_numbers, 'dist': dist_numbers,
      'examples': examples_numbers, 'card': card}
  _log(json.dumps({'timings': timings}))

  if '--profile' in sys.argv[1:]:
    # Phase 20 (optional): the kernels' resources and where the device
    # time of an eval step, a serve request and the train steps goes.
    for source in sources:
      _log(f'ptxas {source}: {_ptxas_summary(build.library_path(source))}')
    for name, fn, host_ms in (
        ('eval_step', lambda: step(predictor.model, dev_batch, states),
         eval_step_ms),
        ('serve_b128', lambda: predictor.score_batch(requests[-1]),
         serve_ms),
        ('train_step', train_fn, train_times['train_step_fused_host_ms']),
        ('lambdarank_train_step', rank_fn,
         rank_times['lambdarank_step_fused_host_ms']),
        ('sparse_train_step', sparse_fn,
         sparse_times['sparse_step_fused_host_ms'])):
      prof = _profile(fn)
      prof['host_ms'] = host_ms
      prof['device_idle_share'] = 1.0 - prof['device_ms'] / host_ms
      # The 12 busiest kernels, and the port's own whatever their share.
      prof['by_name_ms'] = {
          k: v for i, (k, v) in enumerate(prof['by_name_ms'].items())
          if i < 12 or 'pairwise_' in k or 'rank_sort' in k
          or 'scatter_rows' in k}
      _log(json.dumps({'profile': name, **prof}))

  kernels = [{
      'name': 'sorted_values_and_ranks', 'route': 'cuda',
      'source': 'ranking_tpu_torch/ops/cuda/csrc/sort.cu',
      'replaces': 'ranking_tpu/ops/pallas/sort.py:115',
      'launches': launches, 'launches_card': card_launches,
      'launches_lambdarank_path': rank_counts[0],
      'launches_eval_phase': eval_launches,
      'eval_suite_sorts': {
          'kernel': eval_numbers['suite']['kernel_sorts'],
          'plain': eval_numbers['suite']['plain_sorts']},
      'max_abs_err': max_abs_err, 'check': 'bitwise',
      'ms': kernel_ms, 'eager_ms': sort_eager_ms['kernel'], 'plain_ms': plain_ms, 'bound_ms': bound_ms,
      'bound_by': bound_by, 'library_ms': library_ms}]
  # Rows 2-6. `ms`, `plain_ms` and `bound_ms` add up the calls that one
  # train step makes of the function (three layer shapes for the forward,
  # two for the backward products); `ms_by_shape` splits them. The bound
  # counts the products at the rate of float32-accurate work on the tensor
  # cores (`bound_ms_f32_pipe`: the float32 pipes' rate). No single PyTorch
  # call computes what one of these functions computes, so there is no
  # library time; `mm_ms_by_shape` times the bare products through
  # torch.mm, a yardstick of the engine and not the same function.
  replaces = {'layer_forward': 155, 'bwd_stats': 226, 'bwd_mats': 356,
              'bwd_dx_only': 433, 'bwd_dw_only': 489}
  launches_of = dict(zip(replaces, train_counts))
  launches_of.update(second_counts)
  for name, line in replaces.items():
    t = fused_times[name]
    kernels.append({
        'name': name, 'route': 'cuda',
        'source': 'ranking_tpu_torch/ops/cuda/csrc/fused_bn_'
                  + ('fwd.cu' if name == 'layer_forward' else 'bwd.cu'),
        'replaces': f'ranking_tpu/ops/pallas/fused_bn.py:{line}',
        'launches': launches_of[name],
        'launches_lambdarank_path': rank_counts[1 + list(replaces).index(name)],
        'max_abs_err': fused_errs[name]['float32'][0],
        'max_rel_err': fused_errs[name]['float32'][1],
        'max_rel_err_bf16': fused_errs[name]['bfloat16'][1],
        'check': 'share of the largest value, FUSED_TOL',
        'ms': t['ms'], 'plain_ms': t['plain_ms'], 'bound_ms': t['bound_ms'],
        'bound_by': t['bound_by'], 'library_ms': None,
        'ms_by_shape': t['ms_by_shape'],
        'bound_ms_by_shape': t['bound_ms_by_shape'],
        'bound_ms_f32_pipe': t['bound_ms_f32_pipe'],
        'bound_ms_f32_pipe_by_shape': t['bound_ms_f32_pipe_by_shape'],
        'mm_ms_by_shape': t['mm_ms_by_shape']})
  # Rows 7-8. `ms`, `plain_ms` and `bound_ms` are those of the call the
  # LambdaRank path makes (B128xL200, logistic, the NDCG weight);
  # `ms_by_case` has the other shapes and modes. No single PyTorch call
  # computes sums over all pairs of a list under a lambda weight, so there
  # is no library time.
  main_case = f'B{B}xL{L} logistic v1'
  for i, (name, line) in enumerate((('pairwise_sums_forward', 275),
                                    ('pairwise_sums_backward', 304))):
    t = pair_times[name][main_case]
    kernels.append({
        'name': name, 'route': 'cuda',
        'source': 'ranking_tpu_torch/ops/cuda/csrc/pairwise.cu',
        'replaces': f'ranking_tpu/ops/pallas/pairwise.py:{line}',
        'launches': rank_counts[6 + i],
        'max_abs_err': pair_errs[name][0], 'max_rel_err': pair_errs[name][1],
        'check': 'count exact; sums and dlogits as a share of the largest '
                 'value, PAIR_TOL',
        'ms': t['ms'], 'plain_ms': t['plain_ms'], 'bound_ms': t['bound_ms'],
        'bound_by': t['bound_by'], 'library_ms': None,
        'ms_by_case': {k: v['ms'] for k, v in pair_times[name].items()}})
  # Rows 9-10 at the flagship table, K=51200 rows, every slot valid. Row 9
  # (n=1) has no launch on the main path: LazyAdam and LazyAdagrad write
  # their n=3 and n=2 buffers through row 10; it is held and timed in its
  # own phase. Row 10's numbers are the main path's n=3; `ms_by_case` has
  # n=2, recipe B's.
  for name, line, case, main_launches, extra in (
      ('scatter_rows', 131, 'n=1', sparse_counts[0],
       {'launches_own_phase': rows_phase_launches[0],
        'parity_pairs': rows_times['n=1']['parity_pairs'],
        'parity_median_ratio': rows_times['n=1']['parity_median_ratio']}),
      ('scatter_rows_multi', 245, 'n=3', sparse_counts[1],
       {'launches_recipe_b': adagrad_counts[1],
        'launches_own_phase': rows_phase_launches[1],
        'ms_by_case': {k: rows_times[k]['ms'] for k in ('n=2', 'n=3')},
        'plain_ms_by_case': {k: rows_times[k]['plain_ms']
                             for k in ('n=2', 'n=3')},
        'library_ms_by_case': {k: rows_times[k]['library_ms']
                               for k in ('n=2', 'n=3')}})):
    t = rows_times[case]
    kernels.append({
        'name': name, 'route': 'cuda',
        'source': 'ranking_tpu_torch/ops/cuda/csrc/rows.cu',
        'replaces': f'ranking_tpu/ops/pallas/rows.py:{line}',
        'launches': main_launches, **extra,
        'max_abs_err': rows_err, 'check': 'bitwise', 'cases': rows_cases,
        'ms': t['ms'], 'plain_ms': t['plain_ms'], 'bound_ms': t['bound_ms'],
        'bound_by': t['bound_by'], 'library_ms': t['library_ms']})
  # Launches in phase 17: as the wrappers count them over both runs (eager
  # calls, and one a capture), and on the card in the resumed run (the
  # wrapper's own kernel among torch.profiler's device events); and per
  # replay of phase 16's graphs (what the capture recorded, which phase 16
  # holds against the profiler's count of one replay).
  per_replay = {**kstep['softmax']['launches_per_step'],
                **kstep['lambdarank']['launches_per_step'],
                **kstep['sparse_a']['launches_per_step']}
  for entry in kernels:
    entry['launches_pipeline_wrapper'] = pipeline_launches[entry['name']]
    entry['launches_pipeline_resumed_device'] = pipeline_device[entry['name']]
    entry['launches_per_replay'] = per_replay.get(entry['name'], 0)
    entry['launches_elwc_pipeline_wrapper'] = elwc_launches[entry['name']]
    entry['launches_elwc_resumed_device'] = elwc_device[entry['name']]
    entry['launches_elwc_tokens_wrapper'] = token_launches[entry['name']]
    entry['launches_elwc_tokens_device'] = token_device[entry['name']]
    # Phase 21: the wrappers' count over the whole phase, a step of each
    # key (what its capture recorded), the approx NDCG pipeline's profiled
    # run (wrapper and card) and the multi-task pipeline.
    entry['launches_zoo_phase'] = zoo_launches[entry['name']]
    entry['launches_zoo_per_step'] = {
        k: v[entry['name']] for k, v in zoo_per_step.items()
        if v.get(entry['name'])}
    entry['launches_zoo_approx_pipeline_wrapper'] = zoo_approx_wrappers[
        entry['name']]
    entry['launches_zoo_approx_pipeline_device'] = zoo_approx_card[
        entry['name']]
    entry['launches_zoo_multitask_wrapper'] = zoo_mt_wrappers[entry['name']]
    # Phase 22: the wrappers' count over the phase (eager steps and one a
    # capture), and a step of each path (what its capture recorded; DIN's
    # first step at dropout 0, eager).
    entry['launches_scorers_phase'] = scorer_launches[entry['name']]
    entry['launches_scorers_per_step'] = {
        k: v[entry['name']] for k, v in scorer_per_step.items()
        if v.get(entry['name'])}
    # Phase 23: the wrappers' count over the phase, and a step of each
    # graphed path (what its capture recorded).
    entry['launches_encoder_phase'] = encoder_launches[entry['name']]
    entry['launches_encoder_per_step'] = {
        k: v[entry['name']] for k, v in encoder_per_step.items()
        if v.get(entry['name'])}
    # Phase 24: the wrappers' count in 24a (the world of one) and on each
    # rank of 24b-f.
    entry['launches_dist'] = {
        k: ([r[entry['name']] for r in v] if isinstance(v, list)
            else v.get(entry['name'], 0))
        for k, v in dist_launches.items()}
    # Phase 25: the wrappers' count in 25a's flagship ranking_libsvm run
    # (20 steps and one evaluation), a step of it, and on the card by
    # torch.profiler in its second run; and each program of 25b-g in its
    # own run.
    entry['launches_examples_libsvm'] = examples_libsvm['launches'][
        entry['name']]
    entry['launches_examples_libsvm_per_step'] = examples_libsvm[
        'launches_per_step'].get(entry['name'], 0)
    entry['launches_examples_libsvm_card'] = examples_libsvm[
        'launches_card'].get(entry['name'], 0)
    entry['launches_examples_programs'] = {
        p: c[entry['name']] for p, c in examples_launches.items()}
  # Row 10 at the encoder's token table, [30522, 768] x 3, the sparse
  # step's own ids.
  kernels[-1].update({f'encoder_{k}': v for k, v in
                      encoder_numbers['sparse']['row10'].items()})
  # Row 1 in the encoder pipeline's profiled eval passes, on the card and
  # as the wrapper recorded.
  kernels[0]['launches_encoder_pipeline_eval'] = encoder_numbers['row1']
  kernels[0]['launches_zoo_card_per_step'] = {
      k: zoo_numbers['keys'][k]['sort_launches_card'] for k in ZOO_SORT_KEYS}
  _LOG_FILE.write(json.dumps({'kernels': kernels}) + '\n')
  _LOG_FILE.close()
  print(card)
  print(json.dumps({'kernels': kernels}))
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': kind, 'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
