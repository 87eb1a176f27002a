"""Tensor operations of the port (counterpart of torchmdnet_tpu.ops)."""
