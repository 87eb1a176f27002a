"""Batched molecular data (counterpart of torchmdnet_tpu.data)."""
