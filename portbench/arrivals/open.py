"""Open loop: requests come due on a schedule, whatever the server does.

Mix keys: `rate_per_s`, the offered rate; or `rate_cycle`, a list of
[seconds, rate per second] pieces repeated over the window (bursts: a short
piece at a high rate, then a long one at a low rate or none). A run of S
seconds sends N = round(requests expected in S) requests. Their gaps, in
units of the expected time between two requests, are the N quantiles of the
unit exponential distribution in an order drawn from the seed; the rate
(or the cycle) turns them into due times. Every seed sends the same gaps and
the same experts, in another order.
"""
import numpy as np

from portbench.harness import traffic as T


def _pieces(mix):
    cycle = mix.get("rate_cycle")
    if cycle is None:
        return [(1.0, float(mix["rate_per_s"]))]
    pieces = [(float(d), float(r)) for d, r in cycle]
    if any(d <= 0 or r < 0 for d, r in pieces) or not any(r > 0 for _, r in pieces):
        raise ValueError(f"bad rate_cycle {cycle!r}")
    return pieces


def _segments(pieces, expected: float):
    """(start s, expected requests before it, rate) of every piece with a
    rate, over as many cycles as `expected` requests take."""
    starts, before, rates = [], [], []
    t = lam = 0.0
    while lam <= expected:
        for d, r in pieces:
            if r > 0:
                starts.append(t)
                before.append(lam)
                rates.append(r)
            t += d
            lam += d * r
    return np.asarray(starts), np.asarray(before), np.asarray(rates)


def expected_requests(pieces, seconds: float) -> float:
    lam, t = 0.0, 0.0
    while t < seconds:
        for d, r in pieces:
            lam += min(d, max(0.0, seconds - t)) * r
            t += d
    return lam


def schedule(mix, gen, seconds: float, weights) -> T.Schedule:
    pieces = _pieces(mix)
    constant = mix.get("rate_cycle") is None
    n = max(1, int(round(expected_requests(pieces, seconds))))
    experts = T.shuffled(np.repeat(np.arange(len(weights)), T.largest_remainder(n, weights)), gen)
    q = (np.arange(n) + 0.5) / n
    if constant:
        gaps = T.shuffled(-np.log1p(-q) / pieces[0][1], gen)
        return T.Schedule("open", experts, np.cumsum(gaps))
    u = np.cumsum(T.shuffled(-np.log1p(-q), gen))
    starts, before, rates = _segments(pieces, float(u[-1]))
    j = np.clip(np.searchsorted(before, u, side="right") - 1, 0, len(starts) - 1)
    return T.Schedule("open", experts, starts[j] + (u - before[j]) / rates[j])


class Sender:
    """Which requests of the schedule the driver sends, and when."""

    def __init__(self, sched: T.Schedule, seconds: float):
        self.sched, self.sent = sched, 0

    def send(self, t: float):
        """(request index, due time) of every request due by `t` not yet
        sent."""
        out = []
        while self.sent < len(self.sched) and self.sched.due_s[self.sent] <= t:
            out.append((self.sent, float(self.sched.due_s[self.sent])))
            self.sent += 1
        return out

    def next_due(self, t: float) -> float:
        return float(self.sched.due_s[self.sent]) if self.sent < len(self.sched) else t + 0.05

    def finished(self, t: float) -> bool:
        return self.sent >= len(self.sched)

    def answered(self, t: float) -> None:
        """A request's image came back at `t`: an open loop sends nothing
        for it."""
