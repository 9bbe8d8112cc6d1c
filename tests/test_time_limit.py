"""The root ``conftest.py``'s guards, run in a pytest subprocess whose
plugin cuts the time limit to 2 s (60 s for ``slow`` tests): a test that
sleeps past it ends its process with its stack printed, a ``slow`` one
within its own limit passes, and under ``--dist loadfile`` the run goes on
without the worker that died."""

import os
import subprocess
import sys
import textwrap
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLEEPER = textwrap.dedent("""\
    import time

    import pytest


    @pytest.mark.slow
    def test_slow_sleeps():
        time.sleep(3)


    def test_sleeps():
        time.sleep(60)


    def test_after():
        pass
    """)
SHORT_LIMIT = textwrap.dedent("""\
    import conftest

    conftest.TEST_TIME_LIMIT_S = 2
    conftest.SLOW_TEST_TIME_LIMIT_S = 60


    def pytest_configure(config):
        config.addinivalue_line("markers", "slow: long")
    """)
# The frame the dump must show: the sleep that outlasts the limit.
SLEEP_LINE = ('test_b.py", line '
              f'{SLEEPER.splitlines().index("    time.sleep(60)") + 1}'
              ' in test_sleeps')


def _session(tmp_path, *args):
    """pytest on ``tmp_path`` with the root conftest as a plugin and the
    limits cut by another."""
    (tmp_path / "shortlimit.py").write_text(SHORT_LIMIT)
    (tmp_path / "test_b.py").write_text(SLEEPER)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, str(tmp_path)]))
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "conftest",
         "-p", "shortlimit", "-p", "no:cacheprovider", "-p", "no:randomly",
         *args, str(tmp_path)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)


def test_time_limit_ends_a_sleeping_test(tmp_path):
    t0 = time.monotonic()
    proc = _session(tmp_path)
    assert time.monotonic() - t0 < 25
    assert proc.returncode != 0
    assert SLEEP_LINE in proc.stderr, proc.stderr


def test_loadfile_run_goes_on_after_a_worker_dies(tmp_path):
    """The worker the limit ends is reported by the test it died in, and
    the other tests, its own file's later one included, still run; the
    ``slow`` test passes within its own limit."""
    (tmp_path / "test_a.py").write_text(
        "def test_1():\n    pass\n\n\ndef test_2():\n    pass\n")
    proc = _session(tmp_path, "-p", "xdist", "-n", "2", "--dist", "loadfile")
    assert "crashed while running 'test_b.py::test_sleeps'" in proc.stdout, \
        proc.stdout
    assert "1 failed, 4 passed" in proc.stdout, proc.stdout
    assert SLEEP_LINE in proc.stderr, proc.stderr
