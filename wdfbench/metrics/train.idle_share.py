"""The device's idle share of the traced window."""

from wdfbench.readers import idle_share as read  # noqa: F401
