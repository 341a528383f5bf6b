"""The scorers and the top-level ranking model.

The port's copy of ``ranking_tpu/models/scorers.py`` (the reference's
tensorflow_ranking/python/keras/model.py): ``DNNScorer``, ``GAMScorer``,
``DINScorer``, ``EmbeddingDNNScorer``, ``MultiTaskScorer`` and
``RankingModel``, as ``nn.Module``s mapping ``(context, examples, mask) ->
logits [B, L]`` (a dict of them for ``MultiTaskScorer``), in eval and train
mode. The groupwise scorer is in ``models/groupwise.py``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from ranking_tpu_torch.models import embeddings as emb_lib
from ranking_tpu_torch.models import layers as layers_lib
from ranking_tpu_torch.parallel import comm
from ranking_tpu_torch.utils import fns
from ranking_tpu_torch.utils import list_ops

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


class GAMScorer(nn.Module):
  """Generalized additive scorer (keras/model.py:820-865): a ``GAMLayer``
  (``gam``, flax ``GAMLayer_0``) with one tower a feature, so that each
  document's score is a sum of per-feature sub-scores, weighed by
  softmax weights from the context features where there are any.

  ``example_widths`` and ``context_widths`` map each feature name to its
  width (the size of its trailing axes); towers follow the names' sorted
  order. Invalid slots are circularly padded with valid documents of the
  same list before the towers, so that their batch statistics see real
  feature vectors; context features broadcast over the list. Pass a dict
  as ``intermediates`` to receive the ``[B, L, F_e]`` sub-scores under
  ``'gam_sub_scores'`` (the JAX scorer's ``sow``): an argument that the
  forward fills, which a CUDA graph captures like any output.
  """

  def __init__(
      self,
      example_hidden_layer_dims: Sequence[int],
      example_widths: Mapping[str, int],
      context_widths: Optional[Mapping[str, int]] = None,
      context_hidden_layer_dims: Sequence[int] = (),
      activation: str = 'relu',
      use_batch_norm: bool = True,
      batch_norm_momentum: float = 0.999,
      dropout: float = 0.0,
      kernel_init: str = 'lecun_normal',
      generator: Optional[torch.Generator] = None,
      dtype: torch.dtype = torch.float32,
  ):
    super().__init__()
    context_widths = dict(context_widths or {})
    self.example_names = sorted(example_widths)
    self.context_names = sorted(context_widths)
    self.gam = layers_lib.GAMLayer(
        [example_widths[n] for n in self.example_names],
        example_hidden_layer_dims,
        context_widths=[context_widths[n] for n in self.context_names],
        context_hidden_layer_dims=context_hidden_layer_dims,
        activation=activation, use_batch_norm=use_batch_norm,
        batch_norm_momentum=batch_norm_momentum, dropout=dropout,
        kernel_init=kernel_init, generator=generator, dtype=dtype)

  def forward(self, context: FeatureDict, examples: FeatureDict,
              mask: Tensor, training: bool = False,
              generator: Optional[torch.Generator] = None,
              intermediates: Optional[Dict[str, Tensor]] = None) -> Tensor:
    if sorted(examples) != self.example_names or \
        sorted(context) != self.context_names:
      raise ValueError(
          f'GAMScorer over example features {self.example_names} and '
          f'context features {self.context_names}, given '
          f'{sorted(examples)} and {sorted(context)}')
    batch, list_size = mask.shape
    gather_idx, _ = list_ops.padded_gather_indices(mask)
    example_inputs = [
        list_ops.gather_per_row(
            examples[n].reshape(batch, list_size, -1).to(torch.float32),
            gather_idx)
        for n in self.example_names]
    context_inputs = []
    for n in self.context_names:
      t = context[n].reshape(batch, -1).to(torch.float32)
      context_inputs.append(t[:, None, :].expand(batch, list_size,
                                                 t.shape[-1]))
    scores, sub_scores = self.gam(example_inputs, context_inputs,
                                  training=training, generator=generator)
    if intermediates is not None:
      intermediates['gam_sub_scores'] = sub_scores
    return torch.where(mask, scores.squeeze(-1), layers_lib.PADDING_LOGIT)


def _normal(shape, generator: Optional[torch.Generator], device) -> Tensor:
  """Standard normal draws of ``shape`` on ``device`` from ``generator``."""
  if generator is None:
    raise ValueError('training with input noise needs a torch.Generator')
  return comm.draw_rows(lambda s: torch.randn(
      s, generator=generator, dtype=torch.float32,
      device=generator.device), shape).to(device)


class DINScorer(nn.Module):
  """Document Interaction Network scorer (keras/layers.py:420-587,
  examples/keras/antique_kpl_din.py): cross-document attention over the
  list (``attention``, flax ``DocumentInteractionAttention_0``), then a
  scoring tower (``tower``, flax ``Tower_0``) over each document's
  ``head_size`` attended features.

  ``in_features`` is the width of the concatenated features (context
  broadcast over the list); invalid slots are circularly padded with valid
  documents, and the attention masks them out as keys. The tower takes no
  row mask, as in the JAX package: its batch statistics include the padded
  slots. ``input_noise_stddev`` adds Gaussian noise of that scale to the
  features in training, drawn from the forward's generator.
  """

  def __init__(
      self,
      in_features: int,
      num_heads: int = 2,
      head_size: int = 100,
      num_attention_layers: int = 1,
      hidden_layer_dims: Sequence[int] = (256, 128),
      activation: str = 'relu',
      use_batch_norm: bool = True,
      batch_norm_momentum: float = 0.999,
      dropout: float = 0.5,
      input_noise_stddev: float = 0.0,
      generator: Optional[torch.Generator] = None,
      dtype: torch.dtype = torch.float32,
  ):
    super().__init__()
    generator = torch.Generator() if generator is None else generator
    self.input_noise_stddev = input_noise_stddev
    self.attention = layers_lib.DocumentInteractionAttention(
        in_features, num_heads=num_heads, head_size=head_size,
        num_layers=num_attention_layers, dropout=dropout,
        generator=generator, dtype=dtype)
    self.tower = layers_lib.Tower(
        head_size, hidden_layer_dims, output_units=1, activation=activation,
        use_batch_norm=use_batch_norm,
        batch_norm_momentum=batch_norm_momentum, dropout=dropout,
        generator=generator, dtype=dtype)

  def forward(self, context: FeatureDict, examples: FeatureDict,
              mask: Tensor, training: bool = False,
              generator: Optional[torch.Generator] = None) -> Tensor:
    batch, list_size = mask.shape
    concat = layers_lib.concat_features(context, examples, mask)
    if self.input_noise_stddev and training:
      concat = concat + self.input_noise_stddev * _normal(
          concat.shape, generator, concat.device)
    attended = self.attention(concat, mask, training=training,
                              generator=generator)
    flat = attended.reshape(batch * list_size, -1)
    scores = self.tower(flat, training=training, generator=generator)
    return layers_lib.restore_list(scores, mask)


class EmbeddingDNNScorer(nn.Module):
  """DNN scorer over mixed dense and sparse token features
  (examples/tf_ranking_tfrecord.py:99-115, ``embedding_column``).

  Features named in ``vocab_sizes`` are integer token ids ``[..., T]``
  (padding < 0), embedded with a learned table and pooled; everything else
  passes through as dense. One encoder per vocabulary name, shared by
  context and examples, as the submodule ``embed_<name>``; the tower is the
  ``DNNScorer`` ``dnn``. The tower's input width is ``embedding_dim`` for
  each vocabulary name plus ``dense_width``, the width of the dense
  features. With a ``mesh`` (``parallel.make_mesh``) each table is a
  ``parallel.ShardedEmbeddingEncoder``: row-sharded over the mesh's model
  group, with the explicit-collective lookup.
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
    self.output_units = output_units
    generator = torch.Generator() if generator is None else generator
    self.vocab_names = sorted(vocab_sizes)
    for name in self.vocab_names:
      if mesh is not None:
        from ranking_tpu_torch.parallel import embedding as sharded_emb
        encoder = sharded_emb.ShardedEmbeddingEncoder(
            vocab_sizes[name], embedding_dim, mesh, combiner=combiner,
            generator=generator)
      else:
        encoder = emb_lib.EmbeddingEncoder(
            vocab_sizes[name], embedding_dim, combiner=combiner,
            generator=generator)
      self.add_module(f'embed_{name}', encoder)
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
              generator: Optional[torch.Generator] = None,
              intermediates: Optional[Dict[str, Tensor]] = None) -> Tensor:
    """``intermediates``, a dict, goes to a scorer that fills one
    (``GAMScorer``)."""
    context = {k: self._transform(v) for k, v in context.items()}
    examples = {k: self._transform(v) for k, v in examples.items()}
    extra = {} if generator is None else {'generator': generator}
    if intermediates is not None:
      extra['intermediates'] = intermediates
    return self.scorer(context, examples, mask, training=training, **extra)
