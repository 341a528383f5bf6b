"""BERT-style input assembly for encoder scorers.

The port's copy of ``ranking_tpu/data/bert.py``, host code in numpy: the
counterpart of TFRBertDataLoader's feature mapping (the reference's
extension/premade/tfrbert_task.py:50-97). Each (query, document) token-id
pair becomes one fused sequence ``[CLS] query [SEP] document [SEP]`` padded
to ``seq_len`` with -1 (the encoder masks ids < 0), shaped
``[B, L, seq_len]`` for ``models.encoder.EncoderScorer``; and
``WordPieceTokenizer`` makes the ids from text.
"""

from __future__ import annotations

import unicodedata

import numpy as np


def fuse_query_document_ids(
    query_ids: np.ndarray,
    document_ids: np.ndarray,
    seq_len: int,
    cls_id: int,
    sep_id: int,
    pad_id: int = -1,
) -> np.ndarray:
  """Builds ``[B, L, seq_len]`` fused BERT inputs.

  Args:
    query_ids: ``[B, Tq]`` int ids, padding < 0.
    document_ids: ``[B, L, Td]`` int ids, padding < 0.
    seq_len: fused sequence length (truncates document tail first).
    cls_id/sep_id: special token ids.
    pad_id: padding id (< 0 so encoders mask it).

  Returns:
    int32 ``[B, L, seq_len]``.
  """
  query_ids = np.asarray(query_ids)
  document_ids = np.asarray(document_ids)
  b, l, _ = document_ids.shape
  out = np.full((b, l, seq_len), pad_id, np.int32)
  for bi in range(b):
    q = [int(t) for t in query_ids[bi] if t >= 0]
    head = [cls_id] + q + [sep_id]
    head = head[:seq_len]
    for li in range(l):
      d = [int(t) for t in document_ids[bi, li] if t >= 0]
      seq = head + d
      seq = seq[:seq_len - 1] + [sep_id]
      out[bi, li, :len(seq)] = seq
  return out


class WordPieceTokenizer:
  """Greedy longest-match-first WordPiece with BERT's basic tokenization
  (lowercase, punctuation splitting) — the host-side analog of the
  tokenizer the reference pairs with its BERT checkpoints
  (tfrbert_task.py uses pre-tokenized ``input_ids``; this produces them).

  Vocab file: one token per line; continuation pieces prefixed '##'.
  """

  def __init__(self, vocab_path_or_tokens, lowercase: bool = True,
               unk_token: str = '[UNK]', max_chars_per_word: int = 100):
    if isinstance(vocab_path_or_tokens, (list, tuple)):
      tokens = list(vocab_path_or_tokens)
    else:
      with open(vocab_path_or_tokens) as f:
        # Strip \r too (CRLF files), and keep EVERY line — dropping blank
        # lines would shift every later token id off the checkpoint's
        # embedding rows (BERT's load_vocab indexes by line number).
        tokens = [line.rstrip('\r\n') for line in f]
      while tokens and not tokens[-1]:
        tokens.pop()  # trailing newline only
    self.vocab = {t: i for i, t in enumerate(tokens)}
    self.inv_vocab = tokens
    self.lowercase = lowercase
    self.unk_token = unk_token
    self.max_chars_per_word = max_chars_per_word
    for special in ('[CLS]', '[SEP]', '[PAD]', unk_token):
      if special not in self.vocab:
        raise ValueError(f'vocab is missing {special}')
    self.cls_id = self.vocab['[CLS]']
    self.sep_id = self.vocab['[SEP]']
    self.pad_id = self.vocab['[PAD]']
    self.unk_id = self.vocab[unk_token]

  @staticmethod
  def _is_cjk(ch: str) -> bool:
    # BERT's _is_chinese_char ranges (tokenization.py): CJK ideographs.
    cp = ord(ch)
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or
            0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2CEAF or
            0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)

  @staticmethod
  def _basic_split(text: str):
    # BERT basic tokenization: whitespace-split, punctuation split as
    # single tokens ('_' IS punctuation to BERT — \\p{P} covers it), CJK
    # ideographs split per character.
    out, word = [], []

    def flush():
      if word:
        out.append(''.join(word))
        word.clear()

    for ch in text:
      if ch.isspace():
        flush()
      elif WordPieceTokenizer._is_cjk(ch):
        flush()
        out.append(ch)
      elif not ch.isalnum():
        flush()
        out.append(ch)
      else:
        word.append(ch)
    flush()
    return out

  def _wordpiece(self, word: str):
    if len(word) > self.max_chars_per_word:
      return [self.unk_id]
    pieces, start = [], 0
    while start < len(word):
      end = len(word)
      piece_id = None
      while start < end:
        piece = word[start:end]
        if start > 0:
          piece = '##' + piece
        if piece in self.vocab:
          piece_id = self.vocab[piece]
          break
        end -= 1
      if piece_id is None:
        return [self.unk_id]
      pieces.append(piece_id)
      start = end
    return pieces

  def tokenize(self, text: str):
    """Text -> list of WordPiece ids (no special tokens)."""
    if self.lowercase:
      # BERT's do_lower_case also strips accents (NFD + drop Mn), so
      # 'café' matches the uncased checkpoint's 'cafe'.
      text = ''.join(c for c in unicodedata.normalize('NFD', text.lower())
                     if unicodedata.category(c) != 'Mn')
    ids = []
    for word in self._basic_split(text):
      ids.extend(self._wordpiece(word))
    return ids

  def encode_pair(self, text_a: str, text_b: str, seq_len: int):
    """BERT pair encoding: ``[CLS] A [SEP] B [SEP]`` padded with [PAD].

    Returns (input_ids, input_mask, segment_ids) int32 arrays of length
    ``seq_len``; B is truncated first, then A (longest-first), matching
    the BERT convention.
    """
    a = self.tokenize(text_a)
    b = self.tokenize(text_b)
    budget = seq_len - 3
    while len(a) + len(b) > budget:
      # BERT's _truncate_seq_pair pops B on ties (strict > for A).
      if len(a) > len(b) and len(a) > 1:
        a.pop()
      elif len(b) > 1:
        b.pop()
      else:
        a = a[:max(1, budget - len(b))]
        break
    ids = [self.cls_id] + a + [self.sep_id] + b + [self.sep_id]
    segs = [0] * (len(a) + 2) + [1] * (len(b) + 1)
    mask = [1] * len(ids)
    pad = seq_len - len(ids)
    ids, mask, segs = (ids + [self.pad_id] * pad, mask + [0] * pad,
                       segs + [0] * pad)
    return (np.asarray(ids[:seq_len], np.int32),
            np.asarray(mask[:seq_len], np.int32),
            np.asarray(segs[:seq_len], np.int32))


def encode_query_documents(
    tokenizer: 'WordPieceTokenizer',
    query: str,
    documents,
    seq_len: int,
):
  """[L, seq_len] x3 BERT inputs for one query's document list."""
  ids, masks, segs = [], [], []
  for doc in documents:
    i, m, s = tokenizer.encode_pair(query, doc, seq_len)
    ids.append(i)
    masks.append(m)
    segs.append(s)
  return (np.stack(ids), np.stack(masks), np.stack(segs))
