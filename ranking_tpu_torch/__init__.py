"""ranking_tpu_torch: the PyTorch and CUDA port of ranking_tpu for Hopper.

The port grows slice by slice beside the JAX package, which stays the
reference it is tested against. It imports ``torch`` and never JAX or
anything of ``ranking_tpu``. This slice holds the serving and eval path:
``pipeline.serving.Predictor.score_batch`` and ``evaluate_dataset`` over a
``DNNScorer`` ranking model, with NDCG and MRR read from one shared
per-list sort, a CUDA C++ kernel (``ops/cuda/csrc/sort.cu``).

Entry points run on the CUDA device unless the caller passes
``device='cpu'``; without CUDA they raise rather than carry on on the CPU.
"""

__version__ = '0.1.0'
