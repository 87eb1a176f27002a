"""et_edge_roofline.md: see nnpbench/readers.py, ``et_edge_roofline``."""

from nnpbench.readers import et_edge_roofline as read  # noqa: F401
