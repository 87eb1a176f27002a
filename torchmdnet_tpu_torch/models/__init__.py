"""Models of the port (counterpart of torchmdnet_tpu.models)."""
