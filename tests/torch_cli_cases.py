"""Helpers of the example-program tests (``tests/test_torch_examples_*.py``):
the JAX package's CLIs loaded as modules, and run with their pipelines
recorded instead of trained."""

import importlib.util
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_jax_cli(name):
  """The JAX package's ``examples/<name>.py`` as a module, loaded as
  ``tests/test_examples.py`` loads it."""
  path = os.path.join(REPO, 'examples', f'{name}.py')
  spec = importlib.util.spec_from_file_location(f'jax_cli_{name}', path)
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def run_jax_cli(monkeypatch, name, argv, module=None):
  """Runs ``main`` of the JAX CLI ``name`` (or of ``module``) with
  ``argv``; returns what it returns."""
  mod = module or load_jax_cli(name)
  monkeypatch.setattr(sys, 'argv', [f'{name}.py'] + list(argv))
  return mod.main()


def record_jax_pipelines(monkeypatch, cls_name='SimplePipeline'):
  """Stands in for ``ranking_tpu.pipeline.<cls_name>``: a subclass whose
  ``train_and_validate`` trains nothing and returns ``{}``. Returns the
  list of the pipelines made, each holding the model, dataset builder and
  hparams that the CLI gave it."""
  import ranking_tpu.pipeline as jax_pipeline
  made = []
  base = getattr(jax_pipeline, cls_name)

  class Recorded(base):

    def __init__(self, *args, **kwargs):
      super().__init__(*args, **kwargs)
      made.append(self)

    def train_and_validate(self, verbose=False):
      return {}

  monkeypatch.setattr(jax_pipeline, cls_name, Recorded)
  return made


def randomized(variables, seed=0):
  """The variables with random values; variances and scales positive."""
  import jax
  import numpy as np
  rng = np.random.RandomState(seed)

  def leaf(path, x):
    name = jax.tree_util.keystr(path)
    x = np.asarray(x)
    if 'var' in name:
      return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
    if 'scale' in name:
      return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
    return (rng.randn(*x.shape) * 0.5).astype(np.float32)
  return jax.tree_util.tree_map_with_path(leaf, variables)


def hold_eval_forward(jmodel, model, context, examples, mask, seed=0):
  """Initializes the JAX CLI's model ``jmodel`` on the batch, randomizes
  its variables, loads them strictly into the port CLI's ``model`` through
  ``convert.from_flax`` (``convert.to_flax`` gives them back bitwise) and
  holds the eval-mode forwards at rtol 1e-5, atol 1e-5 (each head of a
  multi-task model). Returns the variables."""
  import jax
  import numpy as np
  import torch
  from ranking_tpu_torch import convert
  # Jitted: flax's eager init and apply would compile each operation.
  variables = randomized(jax.jit(jmodel.init)(
      jax.random.PRNGKey(0), context, examples, mask), seed)
  model.load_state_dict(convert.from_flax(variables), strict=True)
  jax.tree_util.tree_map(np.testing.assert_array_equal,
                         convert.to_flax(model.state_dict()),
                         variables)
  want = jax.jit(lambda v, c, e, m: jmodel.apply(v, c, e, m, training=False))(
      variables, context, examples, mask)
  t = lambda tree: {k: torch.from_numpy(np.asarray(v))  # noqa: E731
                    for k, v in tree.items()}
  with torch.no_grad():
    got = model(t(context), t(examples), torch.from_numpy(mask),
                training=False)
  if not isinstance(want, dict):
    want, got = {'': want}, {'': got}
  assert sorted(got) == sorted(want)
  for k in want:
    np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                               rtol=1e-5, atol=1e-5, err_msg=k)
  return variables


def parsed_equal(jax_builder, port_builder, records, list_size):
  """The records parsed by the JAX CLI's specs (its parser) and by the port
  CLI's (the port's plain parser): every array equal, dtypes included.
  Returns the port's ``ParsedLists``."""
  import numpy as np
  from ranking_tpu.data import parsers as jax_parsers
  from ranking_tpu_torch.data import parsers
  want = jax_parsers.parse_example_list(
      records, jax_builder.context_feature_spec,
      jax_builder.example_feature_spec, list_size)
  got = parsers.parse_example_list(
      records, port_builder.context_feature_spec,
      port_builder.example_feature_spec, list_size)
  for part in ('context', 'examples'):
    a, b = getattr(got, part), getattr(want, part)
    assert sorted(a) == sorted(b), part
    for k in b:
      assert a[k].dtype == np.asarray(b[k]).dtype, k
      np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=k)
  np.testing.assert_array_equal(got.mask, np.asarray(want.mask))
  return got
