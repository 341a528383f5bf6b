"""The yardstick on the CPU: BENCHMARK.json and the files it names, the
traffic's determinism, the work counts against hand counts, the references
against plain math, the requests' bytes.

Run: ``python -m pytest cardbench/test_cardbench_yardstick.py``.
"""

import json
import math
import os
import re

import numpy as np
import pytest
import torch

from cardbench import elwc, harness, small, synth, work
from cardbench.kinds import serve
from cardbench.reference import dnn as ref_dnn
from cardbench.reference import encoder as ref_encoder
from cardbench.reference import ranking

BENCH = harness.benchmark()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def test_benchmark_json_keeps_to_the_contract():
  path = os.path.join(harness.ROOT, 'BENCHMARK.json')
  assert os.path.getsize(path) <= 64 * 1024
  assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                        'workloads', 'end_to_end', 'per_layer'}
  assert 1 <= BENCH['run_seconds'] <= 51
  names = ([c['name'] for c in BENCH['configs']]
           + [w['name'] for w in BENCH['workloads']]
           + [m['name'] for m in BENCH['end_to_end'] + BENCH['per_layer']])
  assert len(names) == len(set(names))
  assert all(NAME.match(n) for n in names)
  for m in BENCH['end_to_end'] + BENCH['per_layer']:
    assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
  for m in BENCH['end_to_end']:
    assert m['source'] in ('host_clock', 'device_trace')
    assert 0.01 <= m['bound'] <= 0.25
  texts = ([w['why'] for w in BENCH['workloads']]
           + [c['why'] for c in BENCH['configs']]
           + [m['layer'] for m in BENCH['per_layer']])
  assert all(0 < len(t) <= 200 and '\n' not in t and '\t' not in t
             for t in texts)
  for w in BENCH['workloads']:
    e2e = {m['name'] for m in harness.end_to_end_of(BENCH, w['name'])}
    assert 'setup_s' in e2e and len(e2e) >= 2
    assert harness.per_layer_of(BENCH, w['name'])


@pytest.mark.parametrize('cell', [w['name'] for w in BENCH['workloads']])
def test_each_cell_finds_its_files_by_name(cell):
  bench = BENCH
  w = harness.workload(bench, cell)
  entry = harness.config_entry(bench, w['config'])
  config = harness.load_json(os.path.join(harness.ROOT, entry['file']))
  assert config['name'] == w['config']
  assert sorted(config['reduced']) == sorted(entry['reduced'])
  ctx = harness.make_ctx(bench, cell, 1, 1.0, False, 'cpu')
  assert ctx.traffic['kind'] in ('train', 'serve')
  assert hasattr(harness.kind_of(ctx), 'Cell')
  limits = harness.limits_of(cell)
  assert limits and all(v > 0 for v in limits.values())


@pytest.mark.parametrize('metric', BENCH['per_layer'], ids=lambda m: m['name'])
def test_each_per_layer_metric_finds_its_reader_and_moves_a_cell_metric(
    metric):
  reader = harness.metric_reader(metric['name'])
  assert callable(reader.read)
  # What a metric is, BENCHMARK.json alone says.
  assert not {'SOURCE', 'LAYER', 'UNIT', 'MOVES'} & set(vars(reader))
  for cell in metric['workloads']:
    assert metric['moves'] in {
        m['name'] for m in harness.end_to_end_of(BENCH, cell)}


@pytest.mark.parametrize('cell', [w['name'] for w in BENCH['workloads']])
def test_traffic_is_the_same_for_a_seed_and_differs_between_seeds(cell):
  def lists(seed):
    _, ctx = small.ctx(cell, seed=seed)
    inputs = harness.kind_of(ctx).Cell(ctx)
    return inputs.examples, inputs.labels

  (ex_a, lab_a), (ex_b, lab_b) = lists(2**31 + 5), lists(2**31 + 5)
  (ex_c, lab_c) = lists(12)
  np.testing.assert_array_equal(lab_a, lab_b)
  for k in ex_a:
    np.testing.assert_array_equal(ex_a[k], ex_b[k])
  assert not all(np.array_equal(ex_a[k], ex_c[k]) for k in ex_a)
  # Every seed gets the same list lengths, in another order.
  np.testing.assert_array_equal(np.sort((lab_a >= 0).sum(1)),
                                np.sort((lab_c >= 0).sum(1)))


def test_doc_counts_cover_the_range_evenly():
  counts = synth.doc_counts(synth.rng(3), 30, 10, 19)
  np.testing.assert_array_equal(np.bincount(counts)[10:], [3] * 10)


def test_work_counts_match_hand_counts():
  # Dense layers 4 -> 5 -> 1 over 3 documents.
  assert work.dnn_forward_flops(3, [4, 5, 1]) == 2 * 3 * (20 + 5)
  # Forward, weight gradients, and the input gradient of the second layer.
  assert work.dnn_train_flops(3, [4, 5, 1]) == 2 * 3 * (25 + 25 + 5)
  flops, byte_count = work.tower_train_work(2, [3, 4])
  assert flops == 2 * 2 * (12 + 12)
  # rows in (2x3), top gradient in and output out (2x2x4), W/b/gamma/beta
  # in and their gradients out (2x(12+12)), moments out (2x4); float32.
  assert byte_count == 4 * (6 + 16 + 48 + 8)
  # One layer, hidden 2, MLP 3, a document of 2 tokens: per token the four
  # projections (4 x 2 x 2) and the MLP (2 x 2 x 3), two flops each, the
  # scores and weighted sum (2 x 2 x 2 x 2); then pooler and score.
  assert work.encoder_forward_flops(np.array([2]), 2, 3, 1) == (
      2 * 2 * (16 + 12) + 4 * 2 * 2 * 2 + 2 * 4 + 2 * 2)
  assert work.encoder_train_flops(np.array([2]), 2, 3, 1) == 3 * 156
  labels = np.array([[2.0, 0.0, 1.0, -1.0]])
  flops, sfu, byte_count = work.pairwise_work(labels, labels >= 0)
  # 3 valid documents: 9 comparisons; 3 preference pairs at 4 + 9 flops
  # and 2 special functions each; 4 words in a document, 1 out a list.
  assert (flops, sfu, byte_count) == (9 + 3 * 13, 3 * 2, 4 * (12 + 1))
  assert work.bound_seconds(495e12, 0.0) == pytest.approx(1.0)
  assert work.bound_seconds(0.0, 3.35e12) == pytest.approx(1.0)


def _brute_pairwise(labels, logits):
  """The NDCG-weighted pairwise logistic loss, pair by pair, in float64."""
  total, count = 0.0, 0
  for lab, s in zip(labels, logits):
    valid = [i for i in range(len(lab)) if lab[i] >= 0]
    order = sorted(valid, key=lambda i: (-s[i], i))
    rank = {i: r + 1 for r, i in enumerate(order)}
    disc = lambda r: math.log(2) / math.log1p(r)  # noqa: E731
    clean = sorted((max(lab[i], 0) for i in range(len(lab))), reverse=True)
    idcg = sum((2 ** l - 1) * disc(r + 1) for r, l in enumerate(clean))
    for i in valid:
      for j in valid:
        if lab[i] > lab[j]:
          k = abs(rank[i] - rank[j])
          gain = abs((2 ** lab[i] - 2 ** lab[j]) / idcg)
          w = len(lab) * gain * abs(disc(k) - disc(k + 1))
          total += w * math.log1p(math.exp(-(s[i] - s[j])))
          count += 1
  return total / count


def test_the_references_match_plain_math():
  gen = np.random.default_rng(0)
  labels = np.array([[2, 0, 1, -1, 3], [0, 1, 0, 1, -1]], np.float64)
  logits = gen.standard_normal(labels.shape)
  lab_t, log_t = torch.tensor(labels), torch.tensor(logits)
  assert float(ranking.pairwise_logistic_ndcg_loss(lab_t, log_t)) == (
      pytest.approx(_brute_pairwise(labels, logits), rel=1e-12))
  # Softmax cross entropy over each list's label distribution, weighted by
  # its label sum; an absent document's logit is log(1e-10).
  expect, weights = 0.0, 0.0
  for lab, s in zip(labels, logits):
    v = lab >= 0
    p = lab[v] / lab[v].sum()
    log_z = np.log(np.exp(s[v]).sum() + 1e-10 * (~v).sum())
    expect += -(p * (s[v] - log_z)).sum() * lab[v].sum()
    weights += 1
  assert float(ranking.softmax_loss(lab_t, log_t)) == pytest.approx(
      expect / weights, rel=1e-12)


def test_the_dnn_reference_is_dense_batch_norm_relu():
  gen = torch.Generator().manual_seed(0)
  x = torch.randn(2, 3, 4, generator=gen, dtype=torch.float64)
  valid = torch.tensor([[True, True, False], [True, False, False]])
  w = {'w0': torch.randn(5, 4, generator=gen, dtype=torch.float64),
       'b0': torch.randn(5, generator=gen, dtype=torch.float64),
       'gamma0': torch.rand(5, generator=gen, dtype=torch.float64),
       'beta0': torch.randn(5, generator=gen, dtype=torch.float64),
       'w_out': torch.randn(1, 5, generator=gen, dtype=torch.float64),
       'b_out': torch.randn(1, generator=gen, dtype=torch.float64)}
  out = ref_dnn.forward(w, x, valid, True)
  rows = [(b, i) for b in range(2) for i in range(3) if valid[b, i]]
  h = {r: w['w0'] @ (torch.sign(x[r]) * torch.log1p(x[r].abs())) + w['b0']
       for r in rows}
  mean = sum(h.values()) / len(rows)
  var = sum((v - mean) ** 2 for v in h.values()) / len(rows)
  for r in rows:
    y = torch.relu((h[r] - mean) / torch.sqrt(var + 1e-5) * w['gamma0']
                   + w['beta0'])
    assert float(out[r]) == pytest.approx(float(w['w_out'] @ y + w['b_out']),
                                          rel=1e-9)
  assert float(out[0, 2]) == pytest.approx(math.log(1e-10))


def test_the_encoder_reference_is_post_ln_bert():
  h, f, heads, t = 4, 6, 2, 3
  gen = torch.Generator().manual_seed(1)
  rnd = lambda *s: torch.randn(*s, generator=gen, dtype=torch.float64)  # noqa
  w = {'tok': rnd(10, h), 'pos': rnd(5, h), 'type': rnd(2, h),
       'ln_s': rnd(h), 'ln_b': rnd(h), 'pool': rnd(h, h), 'pool_b': rnd(h),
       'score': rnd(h, 1), 'score_b': rnd(1)}
  for n in ('q', 'k', 'v', 'o'):
    w[f'0.{n}'], w[f'0.{n}_b'] = rnd(h, h), rnd(h)
  for n in ('ln1', 'ln2'):
    w[f'0.{n}_s'], w[f'0.{n}_b'] = rnd(h), rnd(h)
  w['0.mlp0'], w['0.mlp0_b'], w['0.mlp1'], w['0.mlp1_b'] = (
      rnd(h, f), rnd(f), rnd(f, h), rnd(h))
  ids = torch.tensor([[3, 7, 0]])
  mask = torch.tensor([[1, 1, 0]])
  seg = torch.tensor([[0, 1, 0]])
  got = float(ref_encoder.scores(w, ids, mask, seg, 1, heads)[0])

  def ln(v, s, b):
    m = v.mean()
    return (v - m) / torch.sqrt(((v - m) ** 2).mean() + 1e-6) * s + b

  def gelu(v):
    return 0.5 * v * (1 + torch.tanh(math.sqrt(2 / math.pi)
                                     * (v + 0.044715 * v ** 3)))

  x = [ln(w['tok'][ids[0, i]] + w['pos'][i] + w['type'][seg[0, i]],
          w['ln_s'], w['ln_b']) * mask[0, i] for i in range(t)]
  d = h // heads
  out = []
  for i in range(t):
    parts = []
    for hd in range(heads):
      sl = slice(hd * d, (hd + 1) * d)
      q = (x[i] @ w['0.q'] + w['0.q_b'])[sl] / math.sqrt(d)
      logits = [float(q @ (x[j] @ w['0.k'] + w['0.k_b'])[sl])
                for j in range(t) if mask[0, j]]
      p = torch.softmax(torch.tensor(logits, dtype=torch.float64), 0)
      vals = [(x[j] @ w['0.v'] + w['0.v_b'])[sl] for j in range(t)
              if mask[0, j]]
      parts.append(sum(pj * vj for pj, vj in zip(p, vals)))
    y = torch.cat(parts) @ w['0.o'] + w['0.o_b']
    z = ln(x[i] + y, w['0.ln1_s'], w['0.ln1_b'])
    m = gelu(z @ w['0.mlp0'] + w['0.mlp0_b']) @ w['0.mlp1'] + w['0.mlp1_b']
    out.append(ln(z + m, w['0.ln2_s'], w['0.ln2_b']))
  pooled = torch.tanh(out[0] @ w['pool'] + w['pool_b'])
  assert got == pytest.approx(float(pooled @ w['score'] + w['score_b']),
                              rel=1e-9)


def test_the_requests_bytes_parse_back_to_the_arrays():
  from ranking_tpu_torch.data import parsers
  ids = np.array([[101, 5, 30000, 0], [101, 127, 128, 16384]], np.int64)
  mask = (ids > 0).astype(np.int64)
  docs = [{'input_ids': ids[d], 'input_mask': mask[d]} for d in range(2)]
  spec = {k: parsers.FixedLenFeature(shape=(4,), dtype='int64',
                                     default_value=0)
          for k in ('input_ids', 'input_mask')}
  parsed = parsers.parse([elwc.elwc(docs)], {}, spec, 3, use_native=False)
  np.testing.assert_array_equal(parsed.examples['input_ids'][0, :2], ids)
  np.testing.assert_array_equal(parsed.examples['input_mask'][0, :2], mask)
  np.testing.assert_array_equal(parsed.mask, [[True, True, False]])
  assert elwc.packed_varints(np.array([0, 127, 128, 300, 2**21])) == bytes(
      [0, 127, 0x80, 1, 0xAC, 2, 0x80, 0x80, 0x80, 1])


def test_the_percentile_is_nearest_rank():
  values = list(range(1, 101))
  assert serve.percentile(values, 95) == 95
  assert serve.percentile([3.0], 95) == 3.0
  assert serve.percentile(values[:20], 95) == 19


def test_config_files_keep_their_source_widths():
  bert = harness.load_json(os.path.join(harness.HERE, 'configs',
                                        'tfr_bert.json'))
  # uncased_L-12_H-768_A-12's bert_config.json.
  assert {k: bert[k] for k in (
      'hidden_size', 'intermediate_size', 'num_attention_heads',
      'num_hidden_layers', 'vocab_size', 'max_position_embeddings',
      'type_vocab_size')} == {
          'hidden_size': 768, 'intermediate_size': 3072,
          'num_attention_heads': 12, 'num_hidden_layers': 12,
          'vocab_size': 30522, 'max_position_embeddings': 512,
          'type_vocab_size': 2}
  assert json.dumps(sorted(bert['reduced'])) == json.dumps(
      ['attention_probs_dropout_prob', 'hidden_dropout_prob'])
  # tf_ranking_libsvm.py's --hidden_layer_dims; only its dropout changed.
  mslr = harness.load_json(os.path.join(harness.HERE, 'configs',
                                        'mslr_dnn.json'))
  assert (mslr['num_features'], mslr['hidden_layer_dims']) == (
      136, [256, 128, 64])
  assert mslr['reduced'] == ['dropout']
