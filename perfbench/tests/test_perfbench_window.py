"""The window's closed loop keeps exactly ``inflight`` calls queued: driven
with a fake entry on the host's clock, the calls issued but not yet waited
for never number more than ``inflight`` and reach it, each call is waited
for once, in order, and every call gives one gap."""

import numpy as np
import pytest

from perfbench import cell
from perfbench.tests import small


class _CountingClock(cell._HostClock):
    """The host's clock, counting the calls marked but not yet waited for
    (the window's opening mark follows no call and is not one)."""

    def __init__(self):
        self.pending, self.most, self.waited, self.called = 0, 0, [], False

    def mark(self):
        if self.called:
            self.pending += 1
            self.most = max(self.most, self.pending)
            self.called = False
        return super().mark()

    def wait(self, ev):
        self.pending -= 1
        self.waited.append(ev)


class _FakeEntry:
    """Stands in for an entry: a call returns its own number; it records how
    many calls were pending when it was issued."""

    def __init__(self, clock):
        self.clock, self.pending_at_issue = clock, []

    def call(self, n):
        self.pending_at_issue.append(self.clock.pending)
        self.clock.called = True
        return n

    def bits(self, out):
        return 8

    def keep(self, out):
        return out


@pytest.mark.parametrize("inflight", [2, 4])
def test_window_keeps_inflight_calls_pending(inflight):
    clock, calls = _CountingClock(), 40
    entry = _FakeEntry(clock)
    win = cell._window(entry, small.frames(inflight=inflight), 1e9, clock, False,
                       np.random.default_rng(5), 0, calls)
    assert win["calls"] == calls and win["bits"] == 8 * calls
    assert clock.most == inflight
    # Call n goes out with the n calls before it still pending, up to the depth.
    assert entry.pending_at_issue == [min(n, inflight - 1) for n in range(calls)]
    assert clock.pending == 0 and len(clock.waited) == calls
    assert clock.waited == sorted(clock.waited)
    assert len(win["gaps_ms"]) == calls and len(win["issue_s"]) == calls
