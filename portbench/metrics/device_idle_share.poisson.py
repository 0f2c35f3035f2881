"""Share of the traced slice (whole flushes, torch.profiler recording the
device alone) of the open-loop cell in which no operation ran on the device,
in percent: the arrivals' gaps, the host's submits and what a flush leaves
idle."""
from portbench.harness.readings import idle_share as read  # noqa: F401
