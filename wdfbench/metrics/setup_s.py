"""The set-up seconds: from the process start to the window (imports, build,
weights and inputs, warm-up)."""

from wdfbench.readers import setup_seconds as read  # noqa: F401
