"""pytest hooks for the tier-1 suite under tests/: a time limit on every
test, and the reference drill that cannot finish on a CPU host marked
slow.  Tests elsewhere (gpubench/tests) are left as they are."""

import faulthandler
import signal
import sys

import pytest

# the limit on each phase of one test, well above any test's time; a
# test that needs another sets @pytest.mark.timeout(seconds)
DEFAULT_TEST_TIMEOUT_S = 300.0

# tests left out of the default run (-m 'not slow'), by node id
SLOW_TESTS = {
    "tests/test_autoscale.py::"
    "test_elastic_stub_drill_grows_shrinks_and_merges_identically": (
        "the reference's elastic runner reads a previous generation's "
        "heartbeat and cannot finish while its stubs take over ~1 s to "
        "start, as its JAX import does; fixed and pinned in the port "
        "(test_torch_stripes.py)"
    ),
}


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    """Mark SLOW_TESTS before -m deselects by mark."""
    for item in items:
        reason = SLOW_TESTS.get(item.nodeid)
        if reason is not None:
            item.add_marker(pytest.mark.slow(reason=reason))


def _time_limited(item, phase):
    """Fail a phase that outlives the test's limit, with every thread's
    stack on stderr, instead of letting one hang cut the whole run (and
    orphan the hung test's workers)."""
    if not item.nodeid.startswith("tests/"):
        # gpubench/tests, whose card runs take their own time, is not
        # the tier-1 suite
        yield
        return
    marker = item.get_closest_marker("timeout")
    limit = float(marker.args[0]) if marker else DEFAULT_TEST_TIMEOUT_S

    def expire(signum, frame):
        pytest.fail(
            f"timed out: the test's {phase} ran past its {limit:g} s limit"
        )

    previous = signal.signal(signal.SIGALRM, expire)
    faulthandler.dump_traceback_later(limit, file=sys.__stderr__)
    # the alarm a second after the dump, so that the dump shows the
    # stacks where the test hung and not the failure unwinding them
    signal.setitimer(signal.ITIMER_REAL, limit + 1.0)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_setup(item):
    yield from _time_limited(item, "setup")


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    yield from _time_limited(item, "call")


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_teardown(item):
    yield from _time_limited(item, "teardown")
