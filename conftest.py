"""Rules that hold for every test of the repository.

* Tests that read the TF-Ranking checkout (``REFERENCE_ROOT``: its bundled
  example data, its BERT test data and its Python sources) get the
  ``reference_data`` marker at collection and skip where the checkout is
  absent. A test reads it when its function, a fixture it uses, or a
  module-level helper one of them calls names the path or a module constant
  that holds it, or when one of its parameters names a file under ``docs/``
  that names the path (the tutorials). Their bodies are the same either way.
* Each of a test's set-up, call and tear-down fails after
  ``TEST_TIME_LIMIT_S`` seconds (``time_limit``).
"""

import contextlib
import faulthandler
import os
import pathlib
import signal
import sys
import threading
import types

import pytest

REFERENCE_ROOT = '/root/reference/tensorflow_ranking'

# Seconds each of a test's set-up, call and tear-down may take: about 7x
# the slowest test of the suite.
TEST_TIME_LIMIT_S = 300

_DOCS = pathlib.Path(__file__).resolve().parent / 'docs'


def _names_reference(code, env, seen):
  """Whether ``code``, or a helper of its module it names, names the path."""
  for const in code.co_consts:
    if isinstance(const, str) and REFERENCE_ROOT in const:
      return True
    if isinstance(const, types.CodeType) and _names_reference(
        const, env, seen):
      return True
  for name in code.co_names:
    value = env.get(name)
    if isinstance(value, str) and REFERENCE_ROOT in value:
      return True
    if (isinstance(value, types.FunctionType) and value not in seen
        and value.__module__ == env.get('__name__')):
      seen.add(value)
      if _names_reference(value.__code__, value.__globals__, seen):
        return True
  return False


def _reads_reference(item, docs_naming_it):
  funcs = [item.function] + [
      d.func for defs in item._fixtureinfo.name2fixturedefs.values()
      for d in defs]
  seen = set()
  for func in funcs:
    if isinstance(func, types.FunctionType) and _names_reference(
        func.__code__, func.__globals__, seen):
      return True
  params = getattr(getattr(item, 'callspec', None), 'params', {})
  return any(isinstance(v, str) and v in docs_naming_it
             for v in params.values())


def pytest_collection_modifyitems(config, items):
  docs_naming_it = {
      p.name for p in _DOCS.rglob('*') if p.is_file()
      and REFERENCE_ROOT in p.read_text(errors='ignore')}
  absent = not os.path.isdir(REFERENCE_ROOT)
  skip = pytest.mark.skip(
      reason=f'reads the TF-Ranking checkout {REFERENCE_ROOT}, absent here')
  for item in items:
    if isinstance(item, pytest.Function) and _reads_reference(
        item, docs_naming_it):
      item.add_marker('reference_data')
      if absent:
        item.add_marker(skip)


@contextlib.contextmanager
def time_limit(seconds):
  """Fails the code it wraps once it has run ``seconds``.

  SIGALRM raises pytest's failure wherever the Python code is, so a hang
  there is reported as that test's failure, with its stack. A hang in C or
  C++ never returns to the interpreter for the signal: a minute later
  faulthandler writes every thread's stack and ends the process (xdist
  reports the test as crashed and goes on in a new worker). Off the main
  thread, where no signal arrives, it limits nothing. It does not nest: on
  leaving, no timer is armed and the previous SIGALRM handler is back.
  """
  if threading.current_thread() is not threading.main_thread():
    yield
    return

  def expire(signum, frame):
    pytest.fail(f'over the per-test time limit of {seconds} s')

  previous = signal.signal(signal.SIGALRM, expire)
  signal.setitimer(signal.ITIMER_REAL, seconds)
  faulthandler.dump_traceback_later(seconds + 60, exit=True,
                                    file=sys.__stderr__)
  try:
    yield
  finally:
    signal.setitimer(signal.ITIMER_REAL, 0)
    faulthandler.cancel_dump_traceback_later()
    signal.signal(signal.SIGALRM, previous)


@pytest.fixture(name='time_limit')
def _time_limit_fixture():
  """``time_limit`` itself, for the test of it."""
  return time_limit


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
  with time_limit(TEST_TIME_LIMIT_S):
    return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
  with time_limit(TEST_TIME_LIMIT_S):
    return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item):
  with time_limit(TEST_TIME_LIMIT_S):
    return (yield)
