"""The program's kernels' share of their roofline in the traced window."""

from wdfbench.readers import kernel_roofline as read  # noqa: F401
