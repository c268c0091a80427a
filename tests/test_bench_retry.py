"""The bench driver hook's retry wrapper (bench._run_with_retries).

jax caches a failed backend initialization for the process lifetime, so
bench.py re-execs the measurement in fresh child processes (one at a
time; the parent never imports jax) and retries on failure. These tests
pin the wrapper's contract without touching a device: the child's stdout
is STREAMED (never buffered until exit), success passes through, failures
retry in NEW child invocations, a wedged child (TimeoutExpired on wait
after stdout closes) counts as a failure, a deterministic bug still exits
nonzero, and a slow-first-attempt bail (child exit 3 after printing a
fallback line) gets one fresh-process retry with the BEST candidate line
emitted exactly once.
"""

import importlib.util
import json
import pathlib
import subprocess

import pytest

_BENCH_PATH = pathlib.Path(__file__).resolve().parent.parent / "bench.py"


@pytest.fixture()
def bench_mod():
    spec = importlib.util.spec_from_file_location("_bench_under_test",
                                                  _BENCH_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _result(value=4.2):
    return json.dumps({"metric": "realtime_factor", "value": value,
                       "unit": "x_realtime", "vs_baseline": value * 10.67})


_RESULT = _result()

# sentinel outcome: a child that never prints and never exits (stuck D2H)
WEDGE = "wedge"


class _FakeProc:
    """One scripted child: a fixed stdout transcript + returncode.

    WEDGE models a child stuck inside the jax runtime: stdout yields
    nothing (the pipe stays open until kill) and wait() raises
    TimeoutExpired until the parent kills it.
    """

    def __init__(self, outcome):
        if outcome == WEDGE:
            lines, self.returncode, self._wedged = [], None, True
        else:
            if isinstance(outcome, tuple):
                ret, out = outcome
            else:  # plain int: 0 implies a healthy result line
                ret, out = outcome, (_RESULT + "\n" if outcome == 0 else "")
            lines, self.returncode, self._wedged = (
                out.splitlines(keepends=True), ret, False)
        self.stdout = iter(lines)
        self.killed = False

    def wait(self, timeout=None):
        if self._wedged and not self.killed:
            # the pre-kill wait must be bounded or a wedged child would
            # hang the parent past the driver budget
            assert timeout is not None, "parent must bound child wait"
            raise subprocess.TimeoutExpired("bench-child", timeout)
        if self.killed:
            self.returncode = -9
        return self.returncode

    def kill(self):
        self.killed = True


class _FakePopen:
    def __init__(self, outcomes):
        self.outcomes = list(outcomes)
        self.calls = []

    def __call__(self, argv, env=None, stdout=None, text=None, bufsize=None):
        self.calls.append(dict(argv=argv, env=env, stdout=stdout, text=text,
                               bufsize=bufsize))
        return _FakeProc(self.outcomes.pop(0))


def _patch(monkeypatch, bench_mod, outcomes):
    fake = _FakePopen(outcomes)
    monkeypatch.setattr(subprocess, "Popen", fake)
    # no real sleeps between retry attempts
    monkeypatch.setattr(bench_mod.time, "sleep", lambda s: None)
    return fake


def test_success_first_try(monkeypatch, bench_mod, capsys):
    fake = _patch(monkeypatch, bench_mod, [0])
    assert bench_mod._run_with_retries() == 0
    assert len(fake.calls) == 1
    # the child is marked so it runs the measurement instead of recursing,
    # and knows its attempt index (degraded-family bail is attempt-0-only)
    assert fake.calls[0]["env"]["_LIBZL_BENCH_CHILD"] == "1"
    assert fake.calls[0]["env"]["_LIBZL_BENCH_ATTEMPT"] == "0"
    # child stdout is piped line-buffered (streamed, never block-buffered)
    assert fake.calls[0]["stdout"] is subprocess.PIPE
    assert fake.calls[0]["bufsize"] == 1
    assert capsys.readouterr().out == _RESULT + "\n"


def test_teardown_crash_after_result_is_accepted(monkeypatch, bench_mod,
                                                 capsys):
    """A child that prints its result line and then exits nonzero (runtime
    threads dying at interpreter teardown) is accepted: one JSON line out,
    no retry."""
    fake = _patch(monkeypatch, bench_mod, [(1, _RESULT + "\n")])
    assert bench_mod._run_with_retries() == 0
    assert len(fake.calls) == 1
    assert capsys.readouterr().out == _RESULT + "\n"


def test_failed_child_stdout_never_reaches_stdout(monkeypatch, bench_mod,
                                                  capsys):
    """Partial/garbage stdout from a failed attempt must not pollute the
    driver's one-JSON-line channel."""
    fake = _patch(monkeypatch, bench_mod,
                  [(1, "half-printed garbage\n"), 0])
    assert bench_mod._run_with_retries() == 0
    assert len(fake.calls) == 2
    assert capsys.readouterr().out == _RESULT + "\n"


def test_retries_transient_failure(monkeypatch, bench_mod):
    fake = _patch(monkeypatch, bench_mod, [1, 0])
    assert bench_mod._run_with_retries() == 0
    assert len(fake.calls) == 2
    assert fake.calls[1]["env"]["_LIBZL_BENCH_ATTEMPT"] == "1"


def test_wedged_child_counts_as_failure(monkeypatch, bench_mod):
    """A child stuck past its own watchdog (stdout silent, wait times out)
    is killed and retried rather than outliving the driver budget."""
    fake = _patch(monkeypatch, bench_mod, [WEDGE, 0])
    assert bench_mod._run_with_retries() == 0
    assert len(fake.calls) == 2


def test_deterministic_failure_exits_nonzero(monkeypatch, bench_mod):
    fake = _patch(monkeypatch, bench_mod, [1, 1, 1])
    assert bench_mod._run_with_retries(attempts=3) == 1
    assert len(fake.calls) == 3


def test_degraded_family_retried_and_best_line_wins(monkeypatch, bench_mod,
                                                    capsys):
    """A child that bails with exit 3 (slow first attempt: fallback
    throughput-only line printed) gets ONE fresh-process retry; the parent
    emits the best candidate exactly once."""
    slow = json.dumps({"metric": "realtime_factor", "value": 2.4,
                       "unit": "x_realtime", "vs_baseline": 25.6,
                       "partial": True})
    fast = _result(6.1)
    fake = _patch(monkeypatch, bench_mod, [(3, slow + "\n"), (0, fast + "\n")])
    assert bench_mod._run_with_retries() == 0
    assert len(fake.calls) == 2
    assert capsys.readouterr().out == fast + "\n"


def test_empty_partial_is_retried_and_floor_kept(monkeypatch, bench_mod,
                                                 capsys):
    """A child whose fence ate the whole budget emits an all--1 partial
    (value -1, rc 0). The parent must hold it as a floor and try a fresh
    process, then emit the healthy line."""
    empty = json.dumps({"metric": "realtime_factor", "value": -1.0,
                        "unit": "x_realtime", "vs_baseline": -1.0,
                        "partial": True})
    fake = _patch(monkeypatch, bench_mod, [(0, empty + "\n"), 0])
    assert bench_mod._run_with_retries() == 0
    assert len(fake.calls) == 2
    assert capsys.readouterr().out == _RESULT + "\n"


def test_degraded_family_fallback_survives_failed_retry(monkeypatch,
                                                        bench_mod, capsys):
    """If the fresh-process retry after a degraded-family bail fails
    outright, the fallback line from the first attempt still reaches the
    driver (exit 0) — a bail must never end worse than not bailing."""
    slow = json.dumps({"metric": "realtime_factor", "value": 2.4,
                       "unit": "x_realtime", "vs_baseline": 25.6,
                       "partial": True})
    fake = _patch(monkeypatch, bench_mod,
                  [(3, slow + "\n"), 1, 1])
    assert bench_mod._run_with_retries(attempts=3) == 0
    assert len(fake.calls) == 3
    assert capsys.readouterr().out == slow + "\n"
