"""Faults planted in the step under test, each of which must read as not
correct: ``fault(step, buf) -> step``, a broken step in place of the
program's over the same buffers. The harness's tests plant them on the CPU
and ``calibrate.py --fault`` on the card at a cell's own size; the
benchmark's runs never do."""

from __future__ import annotations


class _Broken:
    graph = None
    launches: dict = {}

    def __init__(self, step, buf, after):
        self.step, self.buf, self.after = step, buf, after

    def replay(self):
        before = [a.clone() for a in self.buf]
        out = self.step.replay()
        self.after(self.buf, before, out)
        return out


def still(step, buf):
    """A step that returns its state unchanged."""
    def after(buf, before, out):
        for a, s in zip(buf, before):
            a.copy_(s)
    return _Broken(step, buf, after)


def half(step, buf):
    """Half of the batch left out: the second half's rows keep their
    state."""
    def after(buf, before, out):
        h = buf.x.shape[0] // 2
        for a, s in zip(buf, before):
            a[h:] = s[h:]
    return _Broken(step, buf, after)


def _alter(out, rows):
    out.u0[rows] += 1e-3 * out.u0.abs().max()


def altered(step, buf):
    """An answer altered where it is produced: u0 off by a thousandth of
    its largest entry on every row."""
    return _Broken(step, buf, lambda buf, before, out: _alter(out, slice(None)))


def third(step, buf):
    """u0 altered as in :func:`altered` on the first third of the batch's
    rows only."""
    n = -(-buf.x.shape[0] // 3)
    return _Broken(step, buf, lambda buf, before, out: _alter(out, slice(0, n)))


def cold(step, buf):
    """u0 altered as in :func:`altered` at a chain's first tick only (a
    cold start: the mission time the buffers hold when the fault is
    planted)."""
    t0 = buf.t.clone()
    return _Broken(step, buf,
                   lambda buf, before, out: _alter(out, before[0] == t0))


FAULTS = {"still": still, "half": half, "altered": altered, "third": third,
          "cold": cold}
