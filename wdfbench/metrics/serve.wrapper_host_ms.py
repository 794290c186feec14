"""Host milliseconds of one serving call on an idle card."""

from wdfbench.readers import wrapper_host_ms as read  # noqa: F401
