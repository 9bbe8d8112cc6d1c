"""Session-wide test guards, for every test under this directory.

Each test (setup, call and teardown together) has a time limit, a longer
one if it is marked ``slow``: past it, every thread's stack is printed and
the process exits.  Under xdist that worker is reported as crashed while
running the test, by name, and a fresh worker takes the rest of the queue.  ``--dist loadfile`` gets a scheduler
that goes on after such a crash."""

import faulthandler
import os
import sys
import warnings

import pytest

# More than 5x the slowest tier-1 test (~55 s on a CPU).
TEST_TIME_LIMIT_S = 300
# Tests marked ``slow``: more than 3x the slowest of them (~474 s on a
# CPU, four at a time).
SLOW_TEST_TIME_LIMIT_S = 1800

_stderr_fd = None


def pytest_configure(config):
    # A duplicate of the real stderr, as pytest's faulthandler plugin
    # takes: the fd capture would swallow a dump written to fd 2.
    global _stderr_fd
    _stderr_fd = os.dup(sys.__stderr__.fileno())


def pytest_unconfigure(config):
    os.close(_stderr_fd)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item, nextitem):
    slow = item.get_closest_marker("slow") is not None
    faulthandler.dump_traceback_later(
        SLOW_TEST_TIME_LIMIT_S if slow else TEST_TIME_LIMIT_S, exit=True,
        file=_stderr_fd)
    try:
        return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()


@pytest.hookimpl(tryfirst=True, optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    """``--dist loadfile`` that goes on after a worker crashes.

    xdist's own (3.8) puts every file the crashed worker was ever given
    back in the queue: a finished one goes to the next worker as an empty
    batch, after which no event comes and the run waits for ever; the
    test the worker died in would run again.  Here only the files with
    tests left go back, and the crashed test counts as done (xdist
    reports it as failed).  The subclass uses xdist 3.8's internals, so
    any other version gets xdist's own scheduler and a warning."""
    if config.getvalue("dist") != "loadfile":
        return None
    import xdist
    from xdist.scheduler import LoadFileScheduling

    if not xdist.__version__.startswith("3.8."):
        warnings.warn(
            f"conftest.py: the loadfile scheduler was written for xdist "
            f"3.8, not {xdist.__version__}; using xdist's own, which waits "
            f"for ever after a worker crashes", stacklevel=1)
        return None

    class Scheduling(LoadFileScheduling):
        def remove_node(self, node):
            workload = self.assigned_work.pop(node)
            left = [nodeid for unit in workload.values()
                    for nodeid, done in unit.items() if not done]
            if not left:
                return None
            crashitem = left[0]
            for scope, unit in workload.items():
                if crashitem in unit:
                    unit[crashitem] = True
                if not all(unit.values()):
                    self.workqueue[scope] = unit
            for other in self.assigned_work:
                self._reschedule(other)
            return crashitem

    return Scheduling(config, log)
