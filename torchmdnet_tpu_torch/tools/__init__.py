"""Tools of the port (counterpart of torchmdnet_tpu.tools)."""
