"""Training pipelines, hparams, serving and serving artifacts.

The names of the JAX package's ``ranking_tpu.pipeline`` that the port has,
resolved at first use (PEP 562): importing one submodule, such as
``export`` in a process that serves an artifact, imports nothing else of
the package, and in particular not ``ranking_tpu_torch.models``.
"""

import importlib

_NAMES = {
    'export_lib': ('export', None),
    'hparams_lib': ('hparams', None),
    'pipeline_lib': ('pipeline', None),
    'serving': ('serving', None),
    'ExportedPredictor': ('export', 'ExportedPredictor'),
    'export_predictor': ('export', 'export_predictor'),
    'load_predictor': ('export', 'load_predictor'),
    'DatasetHparams': ('hparams', 'DatasetHparams'),
    'PipelineHparams': ('hparams', 'PipelineHparams'),
    'from_yaml': ('hparams', 'from_yaml'),
    'LibSVMDatasetBuilder': ('pipeline', 'LibSVMDatasetBuilder'),
    'MultiLabelDatasetBuilder': ('pipeline', 'MultiLabelDatasetBuilder'),
    'MultiTaskPipeline': ('pipeline', 'MultiTaskPipeline'),
    'RankingPipeline': ('pipeline', 'RankingPipeline'),
    'SimpleDatasetBuilder': ('pipeline', 'SimpleDatasetBuilder'),
    'SimplePipeline': ('pipeline', 'SimplePipeline'),
    'Predictor': ('serving', 'Predictor'),
    'evaluate_dataset': ('serving', 'evaluate_dataset'),
}

__all__ = sorted(_NAMES)


def __getattr__(name):
  if name not in _NAMES:
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
  module, attr = _NAMES[name]
  value = importlib.import_module(f'{__name__}.{module}')
  return value if attr is None else getattr(value, attr)
