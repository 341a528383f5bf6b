"""ranking_tpu_torch: the PyTorch and CUDA port of ranking_tpu for Hopper.

The port grows slice by slice beside the JAX package, which stays the
reference it is tested against. It imports ``torch`` and never JAX or
anything of ``ranking_tpu``. It holds these paths so far:

* serving and eval: ``pipeline.serving.Predictor.score_batch`` and
  ``evaluate_dataset`` over a ``DNNScorer`` ranking model, with NDCG and
  MRR read from one shared per-list sort, a CUDA C++ kernel
  (``ops/cuda/csrc/sort.cu``);
* training: ``train.steps.make_train_step`` over the same model with
  ``SoftmaxLoss`` and Adam, whose Dense -> masked BatchNorm -> ReLU tower
  runs as CUDA C++ kernels forward and backward
  (``ops/cuda/csrc/fused_bn_*.cu``); the pairwise losses' sums over all
  pairs of a list are CUDA C++ kernels too (``ops/cuda/csrc/pairwise.cu``);
* sparse embedding training: ``train.steps.make_sparse_train_step`` over an
  ``EmbeddingDNNScorer`` with ``LazyAdam`` or ``LazyAdagrad``, whose row
  writes into the tables and their moments are a CUDA C++ kernel
  (``ops/cuda/csrc/rows.cu``);
* the training pipeline over LIBSVM and ELWC files, K steps a dispatch as
  one CUDA graph, and ``Predictor.predict`` / ``regress`` on serialized
  requests;
* evaluation and serving artifacts: the reference's 13 metrics, the eval
  step as one CUDA graph a batch shape, query-id and TREC-run evaluation,
  and ``pipeline.export`` (``torch.export`` programs, int8 weights).

Entry points run on the CUDA device unless the caller passes
``device='cpu'``; without CUDA they raise rather than carry on on the CPU.
"""

__version__ = '0.1.0'
