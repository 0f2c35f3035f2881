"""Share of the tier slots a throughput cell's flushes ran that held a real
request: requests flushed over `ServingQueue.last_slots_used`, summed over
the flushes (a program counter), in percent."""
from portbench.harness.readings import tier_fill as read  # noqa: F401
