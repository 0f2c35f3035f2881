"""Share of the traced slice (whole flushes, torch.profiler recording the
device alone) of a throughput cell in which no operation ran on the device,
in percent."""
from portbench.harness.readings import idle_share as read  # noqa: F401
