"""The pytest side of the port's distributed CPU tests: the rank layout of
a case and the comparisons (``tests/test_torch_distributed.py``,
``tests/test_torch_distributed_sharded.py``; the ranks run
``tests/torch_dist_cases.py``)."""

import numpy as np

WORLDS = (2, 4)


def grid(world, model_split):
  """(data, model) of a case: world 4 is 2 x 2 everywhere; world 2 splits
  the data for the data-parallel cases, the model for the sharded ones."""
  if world == 4:
    return (2, 2)
  return (1, 2) if model_split else (2, 1)


def randomized(variables, seed):
  import jax
  rng = np.random.RandomState(seed)

  def leaf(path, x):
    x = np.asarray(x)
    if 'var' in jax.tree_util.keystr(path):
      return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
    return (rng.randn(*x.shape) * 0.3).astype(np.float32)
  return jax.tree_util.tree_map_with_path(leaf, variables)


def case(world_runs, world, name):
  refs, runs, _ = world_runs
  for rank, r in enumerate(runs[world]):
    assert 'error' not in r[name], f'rank {rank}:\n{r[name].get("error")}'
  return refs[name], runs[world]


def close(got, want, rtol=1e-5, atol=1e-6, err_msg=''):
  np.testing.assert_allclose(np.asarray(got, np.float32),
                             np.asarray(want, np.float32), rtol=rtol,
                             atol=atol, err_msg=err_msg)


def assert_tree_close(got, want, atol, skip=()):
  import jax
  flat_want = jax.tree_util.tree_leaves_with_path(want)
  flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
  assert len(flat_want) == len(flat_got)
  for path, w in flat_want:
    name = jax.tree_util.keystr(path)
    if any(s in name for s in skip):
      continue
    close(flat_got[path], w, atol=atol, err_msg=name)
