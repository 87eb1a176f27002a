"""device_idle_pct.md: see nnpbench/readers.py, ``device_idle_pct``."""

from nnpbench.readers import device_idle_pct as read  # noqa: F401
