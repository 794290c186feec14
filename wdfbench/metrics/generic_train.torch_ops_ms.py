"""Device milliseconds a step in PyTorch's and its libraries' kernels."""

from wdfbench.readers import torch_ops_ms as read  # noqa: F401
