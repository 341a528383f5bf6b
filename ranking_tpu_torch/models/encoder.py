"""Transformer encoder scorer: the TFR-BERT analog.

The port's copy of ``ranking_tpu/models/encoder.py`` (the reference's
TFRBertScorer, extension/premade/tfrbert_task.py:110-132: encoder pooled
output -> dropout -> Dense(1)):

* ``TransformerEncoder``: a BERT-style text encoder (token, position and
  optional segment embeddings, N post-LN self-attention blocks, CLS pooling
  with a tanh head) over flattened ``[B*L, T]`` ids;
* ``EncoderScorer``: scores each document's fused (query, document) token
  sequence; any encoder module with an ``(ids, attn_mask) -> pooled``
  forward can be swapped in;
* ``warm_start_from``: overlays a flat ``{path: array}`` dict (a converted
  pretrained checkpoint) onto parameters by path suffix.

Every module keeps flax's names and layouts: Dense ``kernel [in, out]``
(``layers.DenseGeneral``), LayerNorm ``scale``/``bias``, the attention's
``[F, heads, head_dim]`` kernels, so that a ``state_dict`` name with '.'
read as '/' is the flax parameter path (``convert.py`` maps the trees one
to one). ``dtype`` is
the compute precision (bfloat16 over float32 parameters, as flax's
``dtype``); statistics of the LayerNorms stay float32. In training every
dropout mask is drawn from the forward's ``torch.Generator``; a block's
masks are drawn before the block runs, so that ``remat=True``
(``torch.utils.checkpoint``, which restores only the default generators'
states) recomputes the block with the same masks.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint

from ranking_tpu_torch.models import embeddings as emb_lib
from ranking_tpu_torch.models import layers

Tensor = torch.Tensor


class LayerNorm(nn.Module):
  """flax's ``LayerNorm``: eps 1e-6, ``scale`` ones and ``bias`` zeros
  (``layers.layer_norm``'s arithmetic)."""

  def __init__(self, features: int, eps: float = 1e-6):
    super().__init__()
    self.eps = eps
    self.scale = nn.Parameter(torch.ones(features))
    self.bias = nn.Parameter(torch.zeros(features))

  def forward(self, x: Tensor) -> Tensor:
    return layers.layer_norm(x, self.scale, self.bias, self.eps)


class TransformerBlock(nn.Module):
  """Post-LN self-attention block: attention over the valid keys (dropout
  on its weights), residual, LayerNorm, Dense -> tanh GELU -> Dense,
  dropout, residual, LayerNorm."""

  def __init__(self, hidden_dim: int, num_heads: int, mlp_dim: int,
               dropout: float = 0.1,
               generator: Optional[torch.Generator] = None):
    super().__init__()
    generator = torch.Generator() if generator is None else generator
    self.dropout = dropout
    self.MultiHeadDotProductAttention_0 = layers.MultiHeadAttention(
        hidden_dim, num_heads, hidden_dim, hidden_dim, dropout, generator)
    self.LayerNorm_0 = LayerNorm(hidden_dim)
    self.Dense_0 = layers.DenseGeneral((hidden_dim,), (mlp_dim,), generator)
    self.Dense_1 = layers.DenseGeneral((mlp_dim,), (hidden_dim,), generator)
    self.LayerNorm_1 = LayerNorm(hidden_dim)

  def draw_masks(self, x: Tensor, generator: Optional[torch.Generator]
                 ) -> Optional[Tuple[Tensor, Tensor]]:
    """The block's dropout factors for input ``x`` ``[N, T, H]``: those of
    the attention weights ``[1, 1, T, T]`` (shared by rows and heads, flax's
    broadcast dropout), then those of the output ``[N, T, H]``; None at
    rate 0."""
    if not self.dropout:
      return None
    if generator is None:
      raise ValueError('training with dropout needs a torch.Generator')
    t = x.shape[1]
    return (layers.dropout_mask((1, 1, t, t), self.dropout, generator,
                                x.device, row_dim=None),
            layers.dropout_mask(x.shape, self.dropout, generator, x.device))

  def forward(self, x: Tensor, mask: Tensor,
              masks: Optional[Tuple[Tensor, Tensor]] = None) -> Tensor:
    """``x`` ``[N, T, H]``, ``mask`` ``[N, T]`` bool (keys only: a padded
    query row still attends to the valid keys); ``masks`` from
    ``draw_masks`` in training, None in eval."""
    y = self.MultiHeadDotProductAttention_0(
        x, mask[:, None, None, :], training=masks is not None,
        weights_dropout=None if masks is None else masks[0])
    x = self.LayerNorm_0(x + y)
    y = F.gelu(self.Dense_0(x), approximate='tanh')   # jax.nn.gelu default
    y = self.Dense_1(y)
    if masks is not None:
      y = y * masks[1].to(y.dtype)
    return self.LayerNorm_1(x + y)


class TransformerEncoder(nn.Module):
  """BERT-style encoder over token ids ``[N, T]``; ids < 0 are padding.

  With ``type_vocab_size > 0`` it adds segment (token-type) embeddings, the
  whole BERT embedding stack (``models.bert_ckpt`` builds that config). An
  explicit ``attn_mask`` (BERT's ``input_mask``, where PAD id 0 is a real
  vocabulary entry) overrides the ids < 0 rule. ``remat=True`` recomputes
  each block's activations on the backward pass (``torch.utils.checkpoint``)
  instead of keeping them. Returns the pooled ``[N, hidden_dim]``
  ``tanh(pooler(x[:, 0]))`` in ``dtype``.
  """

  def __init__(self, vocab_size: int, hidden_dim: int = 128,
               num_layers: int = 2, num_heads: int = 4, mlp_dim: int = 512,
               max_len: int = 512, type_vocab_size: int = 0,
               dropout: float = 0.1, remat: bool = False,
               generator: Optional[torch.Generator] = None,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    generator = torch.Generator() if generator is None else generator
    self.vocab_size = vocab_size
    self.hidden_dim = hidden_dim
    self.num_layers = num_layers
    self.num_heads = num_heads
    self.mlp_dim = mlp_dim
    self.max_len = max_len
    self.type_vocab_size = type_vocab_size
    self.dropout = dropout
    self.remat = remat
    self.dtype = dtype
    self.token_embed = emb_lib.Embed(vocab_size, hidden_dim, generator, dtype)
    self.pos_embed = emb_lib.Embed(max_len, hidden_dim, generator, dtype)
    if type_vocab_size:
      self.type_embed = emb_lib.Embed(type_vocab_size, hidden_dim, generator,
                                      dtype)
    self.LayerNorm_0 = LayerNorm(hidden_dim)
    for i in range(num_layers):
      self.add_module(f'block_{i}', TransformerBlock(
          hidden_dim, num_heads, mlp_dim, dropout, generator))
    self.pooler = layers.DenseGeneral((hidden_dim,), (hidden_dim,), generator)

  def forward(self, ids: Tensor, training: bool = False,
              segment_ids: Optional[Tensor] = None,
              attn_mask: Optional[Tensor] = None,
              generator: Optional[torch.Generator] = None) -> Tensor:
    if ids.shape[-1] > self.max_len:
      raise ValueError(
          f'sequence length {ids.shape[-1]} exceeds max_len '
          f'{self.max_len} (position table size); re-tokenize or raise '
          f'max_len')
    if segment_ids is not None and not self.type_vocab_size:
      raise ValueError(
          'segment_ids were provided but type_vocab_size is 0: the '
          'segment information would be silently dropped; set '
          'type_vocab_size (BERT uses 2) or remove the feature')
    drop = training and self.dropout > 0.0
    if drop and generator is None:
      raise ValueError('training with dropout needs a torch.Generator')
    mask = (ids >= 0) if attn_mask is None else (attn_mask > 0)
    safe = torch.where(mask & (ids >= 0), ids, 0)
    x = self.token_embed(safe)
    # Positions 0..T-1 are rows 0..T-1 (T <= max_len by the guard): a slice,
    # where flax looks up an arange.
    x = x + self.pos_embed.table()[:ids.shape[-1]].to(self.dtype)
    if self.type_vocab_size:
      if segment_ids is None:
        x = x + self.type_embed.table()[0].to(self.dtype)
      else:
        x = x + self.type_embed(torch.where(mask, segment_ids, 0))
    x = self.LayerNorm_0(x)
    if drop:
      x = x * layers.dropout_mask(x.shape, self.dropout, generator,
                                  x.device).to(x.dtype)
    x = x * mask[..., None].to(x.dtype)
    for i in range(self.num_layers):
      block = self.get_submodule(f'block_{i}')
      masks = block.draw_masks(x, generator) if training else None
      if self.remat and torch.is_grad_enabled():
        # The masks are arguments, so the recompute reuses them; no state
        # of a default generator is read (none is used, and reading one
        # fails under CUDA graph capture).
        x = checkpoint.checkpoint(block, x, mask, masks, use_reentrant=False,
                                  preserve_rng_state=False)
      else:
        x = block(x, mask, masks)
    return torch.tanh(self.pooler(x[:, 0, :]))


def _accepts(module: nn.Module, name: str) -> bool:
  params = inspect.signature(type(module).forward).parameters
  return name in params or any(
      p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())


class EncoderScorer(nn.Module):
  """Univariate scorer over a text encoder (TFRBertScorer analog).

  Expects the example feature ``input_ids`` ``[B, L, T]``, each document's
  fused query + document tokens, padding < 0 (``data/bert.py`` builds
  them); ``input_mask`` and ``segment_ids`` of the same shape, where
  present, go to an encoder whose forward takes ``attn_mask`` and
  ``segment_ids``, and ``generator`` to one that takes it. Context features
  are unused. The encoder's pooled output (``encoder.hidden_dim`` wide)
  goes through dropout and the ``score`` Dense (float32 over a bfloat16
  encoder); padded documents score log(1e-10).
  """

  def __init__(self, encoder: nn.Module, dropout: float = 0.1,
               ids_feature_name: str = 'input_ids',
               mask_feature_name: str = 'input_mask',
               segment_feature_name: str = 'segment_ids',
               generator: Optional[torch.Generator] = None):
    super().__init__()
    if not isinstance(getattr(encoder, 'hidden_dim', None), int):
      raise ValueError('EncoderScorer needs encoder.hidden_dim, the width '
                       'of its pooled output')
    self.encoder = encoder
    self.dropout = dropout
    self.ids_feature_name = ids_feature_name
    self.mask_feature_name = mask_feature_name
    self.segment_feature_name = segment_feature_name
    self.score = layers.DenseGeneral(
        (encoder.hidden_dim,), (1,),
        torch.Generator() if generator is None else generator)

  def forward(self, context: Dict[str, Tensor], examples: Dict[str, Tensor],
              mask: Tensor, training: bool = False,
              generator: Optional[torch.Generator] = None) -> Tensor:
    ids = examples[self.ids_feature_name]
    batch, list_size, seq_len = ids.shape
    flat = ids.reshape(batch * list_size, seq_len)
    kwargs = {}
    if (self.mask_feature_name in examples
        and _accepts(self.encoder, 'attn_mask')):
      kwargs['attn_mask'] = examples[self.mask_feature_name].reshape(
          batch * list_size, seq_len)
    if (self.segment_feature_name in examples
        and _accepts(self.encoder, 'segment_ids')):
      kwargs['segment_ids'] = examples[self.segment_feature_name].reshape(
          batch * list_size, seq_len)
    if generator is not None and _accepts(self.encoder, 'generator'):
      kwargs['generator'] = generator
    pooled = self.encoder(flat, training=training, **kwargs)
    if training and self.dropout:
      if generator is None:
        raise ValueError('training with dropout needs a torch.Generator')
      pooled = pooled * layers.dropout_mask(
          pooled.shape, self.dropout, generator, pooled.device).to(
              pooled.dtype)
    # flax's Dense with no dtype computes in its input's and parameters'
    # promoted type: float32 over a bfloat16 encoder.
    scores = self.score(pooled.to(torch.promote_types(
        pooled.dtype, self.score.kernel.dtype)))
    return layers.restore_list(scores, mask)


def warm_start_from(params: Mapping[str, Tensor],
                    pretrained: Mapping[str, Any],
                    verbose: bool = False,
                    strict: bool = False) -> Dict[str, Tensor]:
  """Overlays pretrained arrays onto parameters by '/'-joined path suffix.

  ``params`` is keyed by ``state_dict`` names (read with '/' for '.', the
  flax paths of this package's encoder); ``pretrained`` by flax paths, its
  values numpy arrays or tensors. Matches respect path boundaries and the
  LONGEST matching pretrained name wins; shapes must match, and unmatched
  parameters keep their values: TFR-BERT's partial-restore contract
  (tfrbert_task.py:346-361). ``strict=True`` raises if any pretrained entry
  went unused. Returns a new dict with ``params``' names, each overlaid
  value in its parameter's dtype and on its device (``load_state_dict`` it).
  """
  by_len = sorted(pretrained.items(), key=lambda kv: -len(kv[0]))
  out: Dict[str, Tensor] = {}
  used = set()
  for name, leaf in params.items():
    key = name.replace('.', '/')
    match = None
    for pname, value in by_len:
      boundary_ok = key == pname or key.endswith('/' + pname)
      if boundary_ok and tuple(value.shape) == tuple(leaf.shape):
        match = (pname, value)
        break
    if match:
      used.add(match[0])
      out[name] = torch.as_tensor(match[1]).to(
          device=leaf.device, dtype=leaf.dtype, copy=True)
      if verbose:
        print(f'warm-start: {key} <- {match[0]}')
    else:
      out[name] = leaf
  unused = set(pretrained) - used
  if unused:
    if strict:
      raise ValueError(f'unused pretrained entries: {sorted(unused)}')
    if verbose:
      print(f'warm-start: {len(unused)} pretrained entries unused: '
            f'{sorted(unused)[:5]}...')
  return out
