"""Closed loop: `clients` callers, each sending its next request when its
image returns, until the window closes.

Mix key: `clients`. Each round of `clients` requests holds the experts'
largest-remainder counts, in an order drawn from the seed; there are enough
rounds for a request every 10 ms of the window.
"""
import math

import numpy as np

from portbench.harness import traffic as T


def schedule(mix, gen, seconds: float, weights) -> T.Schedule:
    c = int(mix["clients"])
    rounds = max(4, int(math.ceil(seconds * 100 / c)))
    one = np.repeat(np.arange(len(weights)), T.largest_remainder(c, weights))
    experts = np.concatenate([T.shuffled(one, gen) for _ in range(rounds)])
    return T.Schedule("closed", experts, np.zeros(0), c)


class Sender:
    """Which requests the driver sends, and when: each client's next one as
    soon as its last image returned, while the window is open."""

    def __init__(self, sched: T.Schedule, seconds: float):
        self.sched, self.seconds, self.sent = sched, seconds, 0
        self.due = [0.0] * sched.clients       # due times not yet sent

    def send(self, t: float):
        out, due, self.due = [], self.due, []
        for d in due:
            if d <= t and d < self.seconds and self.sent < len(self.sched):
                out.append((self.sent, d))
                self.sent += 1
            elif d > t:
                self.due.append(d)
        return out

    def next_due(self, t: float) -> float:
        return min(self.due, default=t + 0.05)

    def finished(self, t: float) -> bool:
        return t >= self.seconds and not self.due

    def answered(self, t: float) -> None:
        self.due.append(t)
