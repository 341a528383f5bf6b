"""The per-test time limit of the root ``conftest.py``: a hang in Python
fails the test it is in, with its stack, and leaves no timer behind."""

import signal
import time

import pytest


def test_time_limit_fails_a_hang_and_clears_its_timer(time_limit):
  handler = signal.getsignal(signal.SIGALRM)
  start = time.monotonic()
  with pytest.raises(pytest.fail.Exception,
                     match='per-test time limit of 1 s'):
    with time_limit(1):
      time.sleep(5)
  assert time.monotonic() - start < 3
  assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)
  assert signal.getsignal(signal.SIGALRM) is handler
