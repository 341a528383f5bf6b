"""Serving and standalone evaluation.

The port's copy of ``ranking_tpu/pipeline/serving.py``, the analog of
``tfr.keras.saved_model.Signatures`` (keras/saved_model.py:24-175): a
``Predictor`` holds a model on the device and answers

* ``predict(serialized_elwcs)``: listwise, ELWC protos -> ``[B, L]``
  scores, padded slots at the model's sentinel ``log(1e-10)``;
* ``regress(serialized_examples)``: pointwise, each tf.Example a list of
  one document -> ``[B]`` scores;
* ``score_batch(batch)``: a pre-assembled ``RankingBatch``.

Requests parse on the host through ``parsers.parse`` (the native decoder
wherever it takes the specs). ``evaluate_dataset`` streams metrics over a
batch stream, optionally also aggregated by query id.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ranking_tpu_torch.data import parsers
from ranking_tpu_torch.data.batch import RankingBatch
from ranking_tpu_torch.ops import aggregated as agg_lib
from ranking_tpu_torch.ops import metric_registry
from ranking_tpu_torch.train import steps
from ranking_tpu_torch.utils.device import DeviceLike, resolve_device


def _place(model: nn.Module, state_dict: Optional[Mapping[str, Any]],
           device: torch.device) -> nn.Module:
  if state_dict is not None:
    model.load_state_dict(state_dict)
  return model.to(device)


class Predictor:
  """Inference wrapper: a model with its parameters on the device, and the
  feature specs of its requests.

  ``state_dict`` (e.g. from ``convert.from_flax``) is loaded into
  ``model``, which then moves to ``device``; None keeps the model's own
  parameters. ``label_feature_name`` is dropped from the example spec: a
  label is never a model input at serving time. ``list_size`` None pads
  each request to its longest list rounded up
  ``parsers.bucket_list_size``'s ladder.
  """

  def __init__(self, model: nn.Module,
               state_dict: Optional[Mapping[str, Any]] = None,
               context_feature_spec: Optional[
                   Mapping[str, parsers.FeatureSpec]] = None,
               example_feature_spec: Optional[
                   Mapping[str, parsers.FeatureSpec]] = None,
               list_size: Optional[int] = None,
               label_feature_name: Optional[str] = None,
               device: DeviceLike = 'cuda'):
    self.device = resolve_device(device)
    self.model = _place(model, state_dict, self.device)
    self.context_feature_spec = dict(context_feature_spec or {})
    self.example_feature_spec = {
        k: v for k, v in (example_feature_spec or {}).items()
        if k != label_feature_name}
    self.list_size = list_size

  @classmethod
  def from_export(cls, model: nn.Module, export_path: str,
                  context_feature_spec, example_feature_spec,
                  **kwargs) -> 'Predictor':
    """A Predictor over the parameters that ``checkpoint.export_params``
    wrote to ``export_path``."""
    from ranking_tpu_torch.train import checkpoint
    return cls(model, checkpoint.load_params(export_path),
               context_feature_spec, example_feature_spec, **kwargs)

  def _run(self, parsed: parsers.ParsedLists) -> np.ndarray:
    """Scores parsed arrays: on CUDA they go to the card from page-locked
    host memory."""
    pin = self.device.type == 'cuda'

    def put(a: np.ndarray) -> torch.Tensor:
      t = torch.from_numpy(np.ascontiguousarray(a))
      if pin:
        t = t.pin_memory()
      return t.to(self.device, non_blocking=True)

    with torch.no_grad():
      scores = self.model({k: put(v) for k, v in parsed.context.items()},
                          {k: put(v) for k, v in parsed.examples.items()},
                          put(parsed.mask), training=False)
    return scores.cpu().numpy()

  def predict(self, serialized_elwcs: Sequence[bytes]) -> np.ndarray:
    """``[B, list_size]`` scores of serialized ELWC protos; with
    ``list_size`` None the request's longest list sets the bucket (a walk
    of the records' top level, no full parse). Padded slots score
    ``log(1e-10)``."""
    if not serialized_elwcs:
      return np.zeros((0, self.list_size or 1), np.float32)
    list_size = self.list_size or parsers.bucket_list_size(
        parsers.elwc_list_sizes(serialized_elwcs).max())
    return self._run(parsers.parse(
        serialized_elwcs, self.context_feature_spec,
        self.example_feature_spec, list_size))

  def regress(self, serialized_examples: Sequence[bytes]) -> np.ndarray:
    """``[B]`` scores of serialized pointwise tf.Example protos."""
    if not serialized_examples:
      return np.zeros((0,), np.float32)
    return self._run(parsers.parse(
        serialized_examples, self.context_feature_spec,
        self.example_feature_spec, 1, data_format='tf_example'))[:, 0]

  def score_batch(self, batch: RankingBatch) -> np.ndarray:
    """``[B, L]`` scores of a pre-assembled batch; padded slots score
    ``log(1e-10)``."""
    batch = batch.to(self.device)
    with torch.no_grad():
      scores = self.model(batch.context, batch.examples, batch.mask,
                          training=False)
    return scores.cpu().numpy()


def evaluate_dataset(
    model: nn.Module,
    state_dict: Optional[Mapping[str, Any]],
    batches: Iterable[RankingBatch],
    metric_fns: Optional[Mapping[str, Any]] = None,
    query_id_feature: Optional[str] = None,
    aggregated_metrics: Optional[Mapping[str, tuple]] = None,
    predictions_csv: Optional[str] = None,
    device: DeviceLike = 'cuda',
):
  """Standalone evaluation over a ``RankingBatch`` stream.

  Streams weighted-mean metrics (the pipeline's eval loop, usable without
  a pipeline; the default suite is NDCG@5 and MRR), and, when
  ``query_id_feature`` names a context feature, cross-batch aggregated
  metrics grouped by query id (``aggregated_metrics``: display name ->
  (metric key, topn); default MRR and NDCG@5) and an optional predictions
  CSV: the TFR-BERT aggregated evaluation (tfrbert_task.py:238-344). The
  query id is taken out of the model's context: it is never a model
  input.

  On CUDA the batches run through ``steps.GraphedEvalStep``, one captured
  eval step a batch shape. Returns ``{name: float}``, the aggregated
  metrics prefixed ``'agg/'``.
  """
  device = resolve_device(device)
  model = _place(model, state_dict, device)
  if metric_fns is None:
    metric_fns = {
        'ndcg@5': metric_registry.make_ranking_metric_fn(
            metric_registry.RankingMetricKey.NDCG, topn=5),
        'mrr': metric_registry.make_ranking_metric_fn(
            metric_registry.RankingMetricKey.MRR),
    }
  eval_step = steps.GraphedEvalStep(
      steps.make_eval_step(metric_fns, device=device), device)
  states = steps.init_metric_states(metric_fns, device=device)
  acc = agg_lib.PredictionAccumulator() if query_id_feature else None
  for batch in batches:
    model_batch = batch
    if acc is not None:
      if query_id_feature not in batch.context:
        raise ValueError(
            f'query_id_feature {query_id_feature!r} not in batch context '
            f'(features: {sorted(batch.context)})')
      context = {k: v for k, v in batch.context.items()
                 if k != query_id_feature}
      model_batch = batch.replace(context=context)
    states, logits = eval_step(model, model_batch, states)
    if acc is not None:
      if isinstance(logits, dict):
        raise ValueError(
            'aggregated metrics need single-task logits; evaluate one '
            "task at a time (wrap the model to return that task's "
            f'logits): got tasks {sorted(logits)}')
      acc.add_batch(batch.context[query_id_feature].cpu().numpy().reshape(-1),
                    batch.labels.cpu().numpy(), logits.cpu().numpy(),
                    batch.mask.cpu().numpy())
  results = steps.metric_results(states)
  out = (dict(zip(results, torch.stack(list(results.values())).tolist()))
         if results else {})
  if acc is not None:
    specs = aggregated_metrics or {
        'mrr': (metric_registry.RankingMetricKey.MRR, None),
        'ndcg@5': (metric_registry.RankingMetricKey.NDCG, 5),
    }
    for name, value in acc.compute(specs, device=device).items():
      out[f'agg/{name}'] = value
    if predictions_csv:
      acc.dump_csv(predictions_csv)
  return out
