"""The DNN scorers and the top-level ranking model.

The port's copy of ``DNNScorer``, ``EmbeddingDNNScorer``,
``MultiTaskScorer`` and ``RankingModel`` from ``ranking_tpu/models/
scorers.py`` (the reference's tensorflow_ranking/python/keras/model.py), as
``nn.Module``s mapping ``(context, examples, mask) -> logits [B, L]`` (a
dict of them for ``MultiTaskScorer``), in eval and train mode.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from ranking_tpu_torch.models import embeddings as emb_lib
from ranking_tpu_torch.models import layers as layers_lib
from ranking_tpu_torch.utils import fns

Tensor = torch.Tensor
FeatureDict = Dict[str, Tensor]


class DNNScorer(nn.Module):
  """Univariate feed-forward scorer (keras/model.py:780-817).

  Each document is scored independently: features are concatenated
  (context broadcast over the list), flattened to ``[B*L, F]``, scored by
  a tower, and restored to masked ``[B, L]`` logits. ``in_features`` is
  the width of that concatenation.

  Train-mode batch statistics must not see padding. On the fused path the
  tower takes the row mask and computes exact masked moments; on the
  unfused one invalid slots are circularly padded with valid documents of
  the same list. In eval, batch norm reads its running statistics, which do
  not couple rows, so neither is needed. ``input_grad=False`` only when
  every feature is raw batch data.
  """

  def __init__(
      self,
      hidden_layer_dims: Sequence[int],
      in_features: int,
      output_units: int = 1,
      activation: str = 'relu',
      input_batch_norm: bool = False,
      use_batch_norm: bool = True,
      batch_norm_momentum: float = 0.999,
      dropout: float = 0.5,
      kernel_init: str = 'lecun_normal',
      generator: Optional[torch.Generator] = None,
      dtype: torch.dtype = torch.float32,
      input_grad: bool = True,
  ):
    super().__init__()
    self.output_units = output_units
    self.tower = layers_lib.Tower(
        in_features, hidden_layer_dims, output_units=output_units,
        activation=activation, input_batch_norm=input_batch_norm,
        use_batch_norm=use_batch_norm,
        batch_norm_momentum=batch_norm_momentum, dropout=dropout,
        kernel_init=kernel_init, generator=generator, dtype=dtype,
        input_grad=input_grad)

  def forward(self, context: FeatureDict, examples: FeatureDict,
              mask: Tensor, training: bool = False,
              generator: Optional[torch.Generator] = None) -> Tensor:
    batch, list_size = mask.shape
    concat = layers_lib.concat_features(context, examples, mask,
                                        circular_padding=False)
    flat = concat.reshape(batch * list_size, -1)
    row_mask = None
    tower = self.tower
    if tower.fused_ok(flat, training):
      row_mask = mask.reshape(-1)
    elif training and (tower.use_batch_norm or tower.input_bn is not None):
      concat = layers_lib.concat_features(context, examples, mask,
                                          circular_padding=True)
      flat = concat.reshape(batch * list_size, -1)
    scores = tower(flat, training=training, row_mask=row_mask,
                   generator=generator)
    if self.output_units == 1:
      return layers_lib.restore_list(scores, mask)
    logits = scores.reshape(batch, list_size, self.output_units)
    return torch.where(mask[:, :, None], logits, layers_lib.PADDING_LOGIT)


class EmbeddingDNNScorer(nn.Module):
  """DNN scorer over mixed dense and sparse token features
  (examples/tf_ranking_tfrecord.py:99-115, ``embedding_column``).

  Features named in ``vocab_sizes`` are integer token ids ``[..., T]``
  (padding < 0), embedded with a learned table and pooled; everything else
  passes through as dense. One encoder per vocabulary name, shared by
  context and examples, as the submodule ``embed_<name>``; the tower is the
  ``DNNScorer`` ``dnn``. The tower's input width is ``embedding_dim`` for
  each vocabulary name plus ``dense_width``, the width of the dense
  features. The row-sharded tables of the JAX package's ``mesh`` option are
  not ported yet.
  """

  def __init__(
      self,
      hidden_layer_dims: Sequence[int],
      vocab_sizes: Mapping[str, int],
      embedding_dim: int = 20,
      dense_width: int = 0,
      output_units: int = 1,
      combiner: str = 'mean',
      activation: str = 'relu',
      use_batch_norm: bool = True,
      batch_norm_momentum: float = 0.999,
      dropout: float = 0.5,
      generator: Optional[torch.Generator] = None,
      dtype: torch.dtype = torch.float32,
      mesh=None,
  ):
    super().__init__()
    if mesh is not None:
      raise NotImplementedError('EmbeddingDNNScorer(mesh=...): row-sharded '
                                'tables are not ported yet')
    self.output_units = output_units
    generator = torch.Generator() if generator is None else generator
    self.vocab_names = sorted(vocab_sizes)
    for name in self.vocab_names:
      self.add_module(f'embed_{name}', emb_lib.EmbeddingEncoder(
          vocab_sizes[name], embedding_dim, combiner=combiner,
          generator=generator))
    self.dnn = DNNScorer(
        hidden_layer_dims,
        in_features=embedding_dim * len(self.vocab_names) + dense_width,
        output_units=output_units, activation=activation,
        use_batch_norm=use_batch_norm,
        batch_norm_momentum=batch_norm_momentum, dropout=dropout,
        generator=generator, dtype=dtype)

  def forward(self, context: FeatureDict, examples: FeatureDict,
              mask: Tensor, training: bool = False,
              generator: Optional[torch.Generator] = None) -> Tensor:
    def embed(features):
      return {k: (self.get_submodule(f'embed_{k}')(v)
                  if k in self.vocab_names else v)
              for k, v in features.items()}
    return self.dnn(embed(context), embed(examples), mask, training=training,
                    generator=generator)


class MultiTaskScorer(nn.Module):
  """A shared-body scorer with one logit head a task (keras/model.py:726-777,
  the reference's multi-task ``UnivariateScorer`` dict output).

  The body is ``body`` when given (any scorer with ``len(task_names)``
  output units; a ``DNNScorer`` or an ``EmbeddingDNNScorer``), else a
  ``DNNScorer`` built here over ``in_features`` as the submodule
  ``shared``. The forward returns ``{task: [B, L] logits}``, head i being
  the body's output unit i.
  """

  def __init__(
      self,
      task_names: Sequence[str],
      hidden_layer_dims: Sequence[int] = (),
      in_features: Optional[int] = None,
      body: Optional[nn.Module] = None,
      activation: str = 'relu',
      use_batch_norm: bool = True,
      batch_norm_momentum: float = 0.999,
      dropout: float = 0.5,
      generator: Optional[torch.Generator] = None,
      dtype: torch.dtype = torch.float32,
  ):
    super().__init__()
    self.task_names = tuple(task_names)
    if body is not None:
      units = getattr(body, 'output_units', None)
      if units is not None and units != len(self.task_names):
        raise ValueError(
            f'body.output_units={units} != {len(self.task_names)} tasks')
      self.body = body
      self._body_name = 'body'
    else:
      if in_features is None:
        raise ValueError('MultiTaskScorer without a body needs in_features')
      self.shared = DNNScorer(
          hidden_layer_dims, in_features=in_features,
          output_units=len(self.task_names), activation=activation,
          use_batch_norm=use_batch_norm,
          batch_norm_momentum=batch_norm_momentum, dropout=dropout,
          generator=generator, dtype=dtype)
      self._body_name = 'shared'

  def forward(self, context: FeatureDict, examples: FeatureDict,
              mask: Tensor, training: bool = False,
              generator: Optional[torch.Generator] = None
              ) -> Dict[str, Tensor]:
    scorer = getattr(self, self._body_name)
    extra = {} if generator is None else {'generator': generator}
    logits = scorer(context, examples, mask, training=training, **extra)
    if logits.ndim == 2:  # a 1-unit body returns [B, L]
      logits = logits[..., None]
    return {name: logits[:, :, i] for i, name in enumerate(self.task_names)}


class RankingModel(nn.Module):
  """Top-level model: optional feature transform + scorer.

  ``transform_name='log1p'`` applies sign(x)·log1p(|x|) to floating
  features only (keras/model.py:552-665); integer ids pass untouched.
  """

  def __init__(self, scorer: nn.Module, transform_name: str = 'none'):
    super().__init__()
    if transform_name not in ('none', 'log1p'):
      raise ValueError(f"transform_name must be 'none' or 'log1p', got "
                       f'{transform_name!r}')
    self.scorer = scorer
    self.transform_name = transform_name

  def _transform(self, t: Tensor) -> Tensor:
    if self.transform_name == 'log1p' and t.is_floating_point():
      return fns.symmetric_log1p(t)
    return t

  def forward(self, context: FeatureDict, examples: FeatureDict,
              mask: Tensor, training: bool = False,
              generator: Optional[torch.Generator] = None) -> Tensor:
    context = {k: self._transform(v) for k, v in context.items()}
    examples = {k: self._transform(v) for k, v in examples.items()}
    if generator is None:
      return self.scorer(context, examples, mask, training=training)
    return self.scorer(context, examples, mask, training=training,
                       generator=generator)
