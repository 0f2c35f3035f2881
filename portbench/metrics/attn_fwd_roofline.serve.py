"""Share of its roofline the attention forward reaches in the traced slice
of a throughput cell (`readings.attention_forward_roofline`), in percent."""
from portbench.harness.readings import attention_forward_roofline as read  # noqa: F401
