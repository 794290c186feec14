"""Samples completed over the whole window, in millions a second."""

from wdfbench.readers import msamples_per_s as read  # noqa: F401
